"""Special functions of the excursion-set model, in torch.

The port of `victor_tpu/ops/special.py`: the Gauss hypergeometric
2F1(5/6, 3/2; 11/6; x) for x <= 0, which enters the closed-form LCDM linear
growth factor (victor/cosmology.py:234-242,
victor/excursion_set_profile.py:106-119). It is Euler's integral

    2F1(a,b;c;z) = G(c)/(G(b)G(c-b)) * int_0^1 t^(b-1) (1-t)^(c-b-1) (1-zt)^(-a) dt

under the substitution t = 1 - (1 - w^2)^3, which removes both endpoint
singularities and leaves an analytic integrand for fixed 64-node
Gauss-Legendre quadrature (~1e-13 against scipy over z in [-50, 0]).

`ipow` is the integer power of the JAX package: jnp's `x ** n` for a Python
int n is `lax.integer_pow`, a fixed product chain, where `torch.pow` may call
the libm `pow` (it does for n = 4) and round differently.

`clip` is `jnp.clip` with JAX's derivative: `jnp.clip(a, lo, hi)` is
`minimum(hi, maximum(lo, a))`, and JAX's max and min split the derivative
evenly between tied operands, so d clip / d a is 1 inside, 0.5 at either
bound and 0 outside, where `torch.clamp`'s is 1 at a bound.
"""

from __future__ import annotations

from math import gamma

import numpy as np
import torch


def _select(a, lo, hi):
    """The values of clip: selects, so a NaN `a` stays NaN (fmin/fmax would
    return the bound), as `_Clip.forward` computes them."""
    m = torch.where(a < lo, lo, a)
    return torch.where(m > hi, hi, m)


def _balanced(x, ans, other):
    """JAX's share of d max(x, y) / d x (and of min): 1 where x is the
    result, halved where the other operand ties it, 0 elsewhere."""
    return (x == ans).to(ans.dtype) / (1.0 + (other == ans).to(ans.dtype))


def _reduce_to(g, like):
    """Sum a gradient over the axes that `like` (a tensor) was broadcast
    along."""
    return g.sum_to_size(like.shape) if g.shape != like.shape else g


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, lo, hi):
        m = torch.where(a < lo, lo, a)               # maximum(lo, a)
        out = torch.where(m > hi, hi, m)             # minimum(hi, m)
        ctx.save_for_backward(a, lo, hi, m, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, lo, hi, m, out = ctx.saved_tensors
        g_m = g * _balanced(m, out, hi)              # through minimum(hi, m)
        grads = [g_m * _balanced(a, m, lo), None, None]
        if ctx.needs_input_grad[1]:                  # maximum(lo, a)
            grads[1] = _reduce_to(g_m * _balanced(lo, m, a), lo)
        if ctx.needs_input_grad[2]:
            grads[2] = _reduce_to(g * _balanced(hi, out, m), hi)
        return tuple(grads)


def clip(a: torch.Tensor, lo, hi) -> torch.Tensor:
    """`jnp.clip(a, lo, hi)`: the values of `torch.clamp` (NaN stays NaN),
    computed with selects, and JAX's derivative to a, lo and hi (module
    docstring). lo and hi are numbers or tensors that broadcast against a;
    the autograd Function runs only where a gradient is being recorded."""
    tensors = [t for t in (a, lo, hi) if isinstance(t, torch.Tensor)]
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return _select(a, lo, hi)
    lo, hi = (b if isinstance(b, torch.Tensor) else
              torch.tensor(b, dtype=a.dtype, device=a.device) for b in (lo, hi))
    return _Clip.apply(a, lo, hi)

_A, _B, _C = 5.0 / 6.0, 3.0 / 2.0, 11.0 / 6.0
_PREFAC = gamma(_C) / (gamma(_B) * gamma(_C - _B))
_NODES, _WEIGHTS = np.polynomial.legendre.leggauss(64)
_U = 0.5 * (_NODES + 1.0)          # map to [0, 1]
_W = 0.5 * _WEIGHTS


def ipow(x, n: int):
    """x ** n for an int n, as `lax.integer_pow` multiplies it: binary
    exponentiation, and 1 / x^|n| for n < 0."""
    if n == 0:
        return torch.ones_like(x)
    m, acc = abs(n), None
    while m > 0:
        if m & 1:
            acc = x if acc is None else acc * x
        m >>= 1
        if m > 0:
            x = x * x
    return 1.0 / acc if n < 0 else acc


def hyp2f1_growth(z: torch.Tensor) -> torch.Tensor:
    """2F1(5/6, 3/2; 11/6; z) for z <= 0, elementwise over any shape."""
    u = torch.as_tensor(_U, dtype=z.dtype, device=z.device)
    w = torch.as_tensor(_W, dtype=z.dtype, device=z.device)
    t = 1.0 - ipow(1.0 - ipow(u, 2), 3)            # (64,)
    jac = 6.0 * u                                  # dt/du absorbing (1-t)^(-2/3)
    integrand = jac * torch.sqrt(t) * (1.0 - z[..., None] * t) ** (-_A)
    return _PREFAC * torch.sum(w * integrand, dim=-1)


def growth_factor_lcdm(z, omega_m, omega_l):
    """Linear growth factor D(z) from the flat-LCDM hyp2f1 closed form
    (victor/cosmology.py:234-242). D(0) = sqrt(omega_m + omega_l), exactly 1
    only in the flat case, as in the reference. z is a tensor; omega_m and
    omega_l are tensors that broadcast against it, or numbers."""
    az = 1.0 / (1.0 + z)
    num = az ** 2.5 * torch.sqrt(omega_l + omega_m * az ** -3.0) * \
        hyp2f1_growth(-(omega_l * az ** 3.0) / omega_m)
    den = hyp2f1_growth(torch.as_tensor(-omega_l / omega_m, dtype=az.dtype,
                                        device=az.device))
    return num / den

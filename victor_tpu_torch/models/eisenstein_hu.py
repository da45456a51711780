"""Eisenstein & Hu (1998) transfer function and linear P(k, z=0) in torch.

The port of `victor_tpu/models/eisenstein_hu.py` (reference class:
victor/eisenstein_hu.py:5-122). The fitting coefficients are functions of
(B,) parameter tensors, so every batch row may carry its own cosmology.
Private scales are in 1/Mpc; `power_eh` takes k in h/Mpc and returns P in
(Mpc/h)^3, the reference conventions. Integer powers use `ops.special.ipow`,
the JAX package's product chain.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.special import ipow


@dataclasses.dataclass(frozen=True)
class EisensteinHuParams:
    """EH98 fit coefficients, each shaped like the parameters (B,); build
    with `eisenstein_hu_params`."""
    h: torch.Tensor
    omega_m: torch.Tensor
    omega_b: torch.Tensor
    ns: torch.Tensor
    As: torch.Tensor
    k_eq: torch.Tensor
    k_silk: torch.Tensor
    sound_horizon: torch.Tensor
    alpha_c: torch.Tensor
    beta_c: torch.Tensor
    alpha_b: torch.Tensor
    beta_b: torch.Tensor
    beta_node: torch.Tensor


def eisenstein_hu_params(h, omega_m, omega_b, ns, As=2e-9,
                         Tcmb=2.7255) -> EisensteinHuParams:
    """The EH98 fitting coefficients (eqs. 2-24 of astro-ph/9709112); h,
    omega_m, omega_b and ns are tensors of one shape."""
    omh2 = omega_m * ipow(h, 2)
    obh2 = omega_b * ipow(h, 2)
    theta = Tcmb / 2.7
    z_eq = 2.5e4 * omh2 * theta ** -4
    b1 = 0.313 * omh2 ** -0.419 * (1.0 + 0.607 * omh2 ** 0.674)
    b2 = 0.238 * omh2 ** 0.223
    z_drag = 1291.0 * omh2 ** 0.251 / (1.0 + 0.659 * omh2 ** 0.828) * \
        (1.0 + b1 * obh2 ** b2)
    k_eq = 7.46e-2 * omh2 * theta ** -2
    k_silk = 1.6 * obh2 ** 0.52 * omh2 ** 0.73 * (1.0 + (10.4 * omh2) ** -0.95)
    R_drag = 31.5 * obh2 * theta ** -4 * ipow(z_drag / 1e3, -1)
    R_eq = 31.5 * obh2 * theta ** -4 * ipow(z_eq / 1e3, -1)
    s = 2.0 / (3.0 * k_eq) * torch.sqrt(6.0 / R_eq) * torch.log(
        (torch.sqrt(1.0 + R_drag) + torch.sqrt(R_drag + R_eq))
        / (1.0 + torch.sqrt(R_eq)))
    a1 = (46.9 * omh2) ** 0.670 * (1.0 + (32.1 * omh2) ** -0.532)
    a2 = (12.0 * omh2) ** 0.424 * (1.0 + (45.0 * omh2) ** -0.582)
    frac_b = omega_b / omega_m
    alpha_c = a1 ** (-frac_b) * a2 ** (-ipow(frac_b, 3))
    bb1 = 0.944 / (1.0 + (458.0 * omh2) ** -0.708)
    bb2 = (0.395 * omh2) ** -0.0266
    frac_c = (omega_m - omega_b) / omega_m
    beta_c = 1.0 / (1.0 + bb1 * (frac_c ** bb2 - 1.0))
    yy = (1.0 + z_eq) / (1.0 + z_drag)
    G = yy * (-6.0 * torch.sqrt(1.0 + yy) + (2.0 + 3.0 * yy) * torch.log(
        (torch.sqrt(1.0 + yy) + 1.0) / (torch.sqrt(1.0 + yy) - 1.0)))
    alpha_b = 2.07 * k_eq * s * (1.0 + R_drag) ** -0.75 * G
    beta_b = 0.5 + frac_b + (3.0 - 2.0 * frac_b) * torch.sqrt(
        ipow(17.2 * omh2, 2) + 1.0)
    beta_node = 8.41 * omh2 ** 0.435
    return EisensteinHuParams(
        h=h, omega_m=omega_m, omega_b=omega_b, ns=ns,
        As=torch.full_like(h, As), k_eq=k_eq, k_silk=k_silk, sound_horizon=s,
        alpha_c=alpha_c, beta_c=beta_c, alpha_b=alpha_b, beta_b=beta_b,
        beta_node=beta_node)


def _T0(k, k_eq, alpha_c, beta_c):
    q = k / (13.41 * k_eq)
    C = 14.2 / alpha_c + 386.0 / (1.0 + 69.9 * q ** 1.08)
    lnterm = torch.log(math.e + 1.8 * beta_c * q)
    return lnterm / (lnterm + C * ipow(q, 2))


def _col(v):
    """A coefficient of the parameters' shape, broadcast over k's last axis."""
    return v[..., None]


def transfer(p: EisensteinHuParams, k):
    """Full EH98 transfer function; k in 1/Mpc, (nk,) or (B, nk), against
    (B,) coefficients -> (B, nk)."""
    k = k.expand(p.h.shape + k.shape[-1:])
    sh, k_eq, beta_c = _col(p.sound_horizon), _col(p.k_eq), _col(p.beta_c)
    ks = k * sh
    # baryon part
    s_tilde = sh / (1.0 + ipow(_col(p.beta_node) / ks, 3)) ** (1.0 / 3.0)
    T_b = (_T0(k, k_eq, 1.0, 1.0) / (1.0 + ipow(ks / 5.2, 2))
           + _col(p.alpha_b) / (1.0 + ipow(_col(p.beta_b) / ks, 3))
           * torch.exp(-(k / _col(p.k_silk)) ** 1.4)) * \
        torch.sinc(k * s_tilde / math.pi)
    # CDM part
    f = 1.0 / (1.0 + ipow(ks / 5.4, 4))
    T_c = f * _T0(k, k_eq, 1.0, beta_c) + \
        (1.0 - f) * _T0(k, k_eq, _col(p.alpha_c), beta_c)
    frac_b = _col(p.omega_b / p.omega_m)
    return frac_b * T_b + (1.0 - frac_b) * T_c


def power_eh(p: EisensteinHuParams, k):
    """P(k, z=0) in (Mpc/h)^3 for k in h/Mpc (victor/eisenstein_hu.py:73-89):
    k (nk,) or (B, nk) against (B,) coefficients -> (B, nk)."""
    h = _col(p.h)
    norm = 2.0 * math.pi ** 2 * _col(p.As) / h * 4.15e12
    return norm * (k * h / 0.05) ** _col(p.ns) * ipow(transfer(p, k * h), 2)


# fixed quadrature for sigma8: the integrand is smooth and damped by the
# top-hat window; 800 Gauss-Legendre nodes on [1e-5, 20] match scipy.quad
# (victor/eisenstein_hu.py:91-98) to ~1e-9 relative
_S8_NODES, _S8_WEIGHTS = np.polynomial.legendre.leggauss(800)
_S8_X = 0.5 * (20.0 - 1e-5) * (_S8_NODES + 1.0) + 1e-5
_S8_W = 0.5 * (20.0 - 1e-5) * _S8_WEIGHTS


def _tophat(x):
    return 3.0 * (torch.sin(x) - x * torch.cos(x)) / ipow(x, 3)


class _TophatWindow(torch.autograd.Function):
    """W(x) = 3 (sin x - x cos x) / x^3 whose derivative is the rule of
    `victor_tpu/models/eisenstein_hu.py:132-147`: W'(x) = 3 (sin x / x^2 -
    W / x) above x = 0.35 and the series -x/5 + x^3/70 - x^5/2520 below it,
    where the closed form cancels. Every order of differentiation then only
    meets x^-1 and x^-2 (the backward calls this Function again), which stays
    finite in f32 at the small x of the variance integrals."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _tophat(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        w = tophat_window(x)
        x2 = x * x
        dw_series = x * (-1.0 / 5.0 + x2 * (1.0 / 70.0 - x2 / 2520.0))
        dw_closed = 3.0 * (torch.sin(x) / ipow(x, 2) - w / x)
        return grad * torch.where(x < 0.35, dw_series, dw_closed)


def tophat_window(x: torch.Tensor) -> torch.Tensor:
    """Spherical top-hat window W(x) = 3 (sin x - x cos x) / x^3, with the
    AD-stable derivative of `_TophatWindow`."""
    return _TophatWindow.apply(x)


def sigma80(p: EisensteinHuParams):
    """sigma_8(z=0) of the (un-normalised) EH power spectrum, (B,)."""
    x = torch.as_tensor(_S8_X, dtype=p.h.dtype, device=p.h.device)
    w = torch.as_tensor(_S8_W, dtype=p.h.dtype, device=p.h.device)
    window = tophat_window(x)
    integrand = (power_eh(p, x / 8.0) * ipow(x / 8.0, 3) * ipow(window, 2) / x
                 / (2.0 * math.pi ** 2))
    return torch.sqrt(torch.sum(w * integrand, dim=-1))


class EisensteinHu:
    """Thin class wrapper with the reference's API (victor/eisenstein_hu.py:5):
    one cosmology, its coefficients as (1,) tensors on `device` (the card
    unless 'cpu' is asked for) in `dtype`. `power_EH` returns k's shape: a
    tensor for a tensor k, an ndarray otherwise."""

    def __init__(self, h, omega_m, omega_b, ns=0.965, As=2e-9, Tcmb=2.7255,
                 *, device='cuda', dtype=torch.float64):
        from ..io.tables import _target_device
        self.device, self.dtype = _target_device(device), dtype

        def one(v):
            return torch.tensor([float(v)], dtype=dtype, device=self.device)
        self.params = eisenstein_hu_params(one(h), one(omega_m), one(omega_b),
                                           one(ns), As, Tcmb)
        self.h, self.omega_m, self.omega_b, self.ns, self.As = \
            h, omega_m, omega_b, ns, As
        self.sound_horizon = float(self.params.sound_horizon[0])

    def power_EH(self, k):
        kt = torch.as_tensor(k, dtype=self.dtype, device=self.device)
        pk = power_eh(self.params, kt.reshape(-1))[0].reshape(kt.shape)
        return pk if isinstance(k, torch.Tensor) else pk.cpu().numpy()

    def compute_sigma80(self):
        return float(sigma80(self.params)[0])

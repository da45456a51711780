"""Adaptive random-walk Metropolis: the reference's own sampler, on the card.

The port of `victor_tpu/sampling/mh.py`. The reference samples with cobaya's
Metropolis-Hastings over MPI processes (victor/README.md:30;
config/boss_cobaya_config.yaml:44-48 — proposal widths per parameter,
covariance learned during burn-in). Here independent chains advance
together, one batched likelihood call per step over the chain axis, with a
Gaussian proposal adapted by the staged machinery of sampling/hmc.py —
Welford accumulation of the dense chain covariance (identity -> diagonal ->
dense, Haario-style) plus dual averaging of a global scale toward the
Roberts-Gelman-Gilks random-walk optimum of 0.234 acceptance.

MH is gradient-free, so the forward-only fast modes (`streaming_eval`,
`dispersion_final` 'fast') compose with it. State reuses HMCState with the
gradient slot pinned to zeros.

`_mh_step` takes its noise as arguments (the tests feed it victor_tpu's own
key splits); `run_segment` draws it from the state's generator, one draw
per step.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from .hmc import HMCState, _adapt_and_pack, staged_segment

# random-walk optimum (Roberts, Gelman & Gilks 1997); HMC's 0.8 would force
# vanishing steps
TARGET_ACCEPT = 0.234


def _default_eps0(ndim: int) -> float:
    """Optimal RWM scale 2.38/sqrt(d) once the proposal matches the posterior
    covariance — the dual-averaging anchor; adaptation refines from here."""
    return 2.38 / float(ndim) ** 0.5


def _mh_step(value_fn: Callable, state: HMCState, xi: torch.Tensor,
             u: torch.Tensor, adapt: bool,
             target_accept: float = TARGET_ACCEPT,
             mu_offset: float = 1.5) -> HMCState:
    """One step of every chain: xi (C, ndim) standard normal proposal noise,
    u (C,) uniform acceptance noise."""
    eps = torch.exp(state.log_eps)
    # symmetric Gaussian proposal with covariance eps^2 * (L L^T), L the
    # staged Welford Cholesky — cobaya's learned proposal covariance role
    step = torch.einsum('cij,cj->ci', state.chol_cov, xi)
    q1 = state.q + eps[:, None] * step
    lnp1, aux1 = value_fn(q1)
    log_accept = lnp1 - state.lnp
    log_accept = torch.where(torch.isnan(log_accept), -math.inf, log_accept)
    accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
    accept = torch.log(u) < log_accept

    q = torch.where(accept[:, None], q1, state.q)
    lnp = torch.where(accept, lnp1, state.lnp)
    aux = torch.where(accept[:, None], aux1, state.aux)
    return _adapt_and_pack(state, q, lnp, state.grad, aux, accept_prob,
                           accept, adapt, target_accept, mu_offset=mu_offset)


def init_chains(value_fn: Callable, y0: torch.Tensor,
                generator: torch.Generator, eps0: Optional[float] = None,
                chol0: Optional[torch.Tensor] = None) -> HMCState:
    """Initial state of a batch of chains at y0 (C, ndim), value only.

    `chol0`: optional initial proposal-covariance Cholesky, (ndim, ndim)
    shared or (C, ndim, ndim) per chain — the role of cobaya's per-parameter
    `proposal:` widths / input `covmat`. The Welford staging replaces it
    from the chain's own covariance at the first warmup reset."""
    lnp, aux = value_fn(y0)
    n_chains, ndim = y0.shape
    eps0 = _default_eps0(ndim) if eps0 is None else eps0
    like = dict(dtype=y0.dtype, device=y0.device)
    if chol0 is None:
        chol0 = torch.eye(ndim, **like)
    log_eps = torch.full((n_chains,), math.log(eps0), **like)
    return HMCState(
        q=y0, lnp=lnp, grad=torch.zeros_like(y0),
        aux=aux.reshape(n_chains, -1), generator=generator,
        log_eps=log_eps, log_eps_avg=log_eps.clone(),
        h_bar=torch.zeros(n_chains, **like),
        welford_mean=torch.zeros_like(y0),
        welford_m2=torch.zeros(n_chains, ndim, ndim, **like),
        welford_n=torch.zeros(n_chains, **like),
        chol_cov=torch.as_tensor(chol0, **like).expand(
            n_chains, ndim, ndim).clone(),
        n_accepted=torch.zeros(n_chains, **like))


def draw_noise(state: HMCState) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step's proposal and acceptance noise from the state's
    generator: (xi (C, ndim), u (C,))."""
    q = state.q
    xi = torch.randn(q.shape, generator=state.generator, dtype=q.dtype,
                     device=q.device)
    u = torch.rand(q.shape[:1], generator=state.generator, dtype=q.dtype,
                   device=q.device)
    return xi, u


def run_segment(value_fn: Callable, states: HMCState, i0: int, length: int,
                n_warmup: int, eps0: Optional[float] = None,
                target_accept: float = TARGET_ACCEPT):
    """Advance every chain `length` MH steps from global step `i0` (the
    staged warmup schedule of hmc.staged_segment, bit-identical when split
    into segments). value_fn(y (C, ndim)) -> (lnp (C,), aux (C, n_aux)) is
    only ever evaluated forward."""
    eps0 = _default_eps0(states.q.shape[1]) if eps0 is None else eps0
    return staged_segment(
        lambda st, adapt, mu: _mh_step(value_fn, st, *draw_noise(st), adapt,
                                       target_accept, mu_offset=mu),
        states, i0, length, n_warmup, eps0)

"""The chain state and staged warmup shared by the adaptive samplers.

The port of the part of `victor_tpu/sampling/hmc.py` that random-walk
Metropolis (sampling/mh.py) shares with HMC and NUTS: `HMCState`, the
post-transition adaptation `_adapt_and_pack` (dual averaging of the step
size, Welford accumulation of the dense chain covariance), the warmup
resets and the staged schedule of `staged_segment`. HMC's leapfrog and
NUTS need gradients of the likelihood, whose kernels are forward only in
the port; they come with a later slice.

Chains are independent and carry a leading chain axis (C, ...) in place of
`jax.vmap`. The stage transitions key on the global step index, a host
integer, so a run split into segments is bit-identical to one uninterrupted
run, and no step reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch


class HMCState(NamedTuple):
    q: torch.Tensor            # (C, ndim) position (unbounded space)
    lnp: torch.Tensor          # (C,) log posterior at q
    grad: torch.Tensor         # (C, ndim) gradient at q (zeros under MH)
    aux: torch.Tensor          # (C, n_aux) auxiliary outputs (e.g. chi2)
    generator: torch.Generator
    # adaptation state
    log_eps: torch.Tensor      # (C,) current log step size
    log_eps_avg: torch.Tensor  # (C,) dual-averaging iterate
    h_bar: torch.Tensor        # (C,) dual-averaging error accumulator
    welford_mean: torch.Tensor  # (C, ndim)
    welford_m2: torch.Tensor   # (C, ndim, ndim) full-covariance accumulator
    welford_n: torch.Tensor    # (C,)
    chol_cov: torch.Tensor     # (C, ndim, ndim) lower Cholesky of the
                               # position covariance estimate
    n_accepted: torch.Tensor   # (C,)


def _adapt_and_pack(state: HMCState, q, lnp, grad, aux, accept_stat,
                    accept, adapt: bool, target_accept: float,
                    t0: float = 10.0, gamma: float = 0.05,
                    kappa: float = 0.75, mu_offset: float = 1.5) -> HMCState:
    """Shared post-transition adaptation: dual averaging of log eps toward
    the target acceptance statistic (Hoffman & Gelman 2014 §3.2) + Welford
    accumulation of the full posterior covariance, both frozen outside
    warmup (`adapt` is the host's `step < n_warmup`)."""
    n_accepted = state.n_accepted + accept
    if not adapt:
        return state._replace(q=q, lnp=lnp, grad=grad, aux=aux,
                              n_accepted=n_accepted)
    n = state.welford_n + 1.0
    h_bar = (1.0 - 1.0 / (n + t0)) * state.h_bar \
        + (target_accept - accept_stat) / (n + t0)
    # mu_offset anchors the shrinkage point at log(10 * eps0)
    log_eps = mu_offset - torch.sqrt(n) / gamma * h_bar
    w = n ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg

    delta = q - state.welford_mean
    welford_mean = state.welford_mean + delta / n[:, None]
    welford_m2 = state.welford_m2 \
        + delta[:, :, None] * (q - welford_mean)[:, None, :]
    return state._replace(q=q, lnp=lnp, grad=grad, aux=aux,
                          log_eps=log_eps, log_eps_avg=log_eps_avg,
                          h_bar=h_bar, welford_mean=welford_mean,
                          welford_m2=welford_m2, welford_n=n,
                          n_accepted=n_accepted)


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of `a` (..., d, d), with NaN in
    its lower triangle where a matrix is not positive definite: what
    `jnp.linalg.cholesky` returns, where `torch.linalg.cholesky` would raise
    and `cholesky_ex` leaves a partial factor. Like `jnp.linalg.cholesky`,
    it factors (a + a^T) / 2 (a Welford accumulator is symmetric only up to
    rounding)."""
    chol, info = torch.linalg.cholesky_ex((a + a.mT) / 2)
    return torch.where((info == 0)[..., None, None], chol, math.nan).tril()


def _all_finite(a: torch.Tensor) -> torch.Tensor:
    """(C,) whether every entry of each (C, d, d) matrix is finite."""
    return torch.isfinite(a).flatten(1).all(dim=1)


def _reset_adaptation(st: HMCState, chol) -> HMCState:
    chol = torch.where(_all_finite(chol)[:, None, None], chol, st.chol_cov)
    return st._replace(chol_cov=chol,
                       h_bar=torch.zeros_like(st.h_bar),
                       welford_n=torch.zeros_like(st.welford_n),
                       welford_mean=torch.zeros_like(st.welford_mean),
                       welford_m2=torch.zeros_like(st.welford_m2))


def _diag_reset(st: HMCState) -> HMCState:
    denom = torch.clamp(st.welford_n - 1.0, min=1.0)[:, None]
    var = torch.diagonal(st.welford_m2, dim1=-2, dim2=-1) / denom
    var = torch.where(var > 0, var, 1.0)
    return _reset_adaptation(st, torch.diag_embed(torch.sqrt(var)))


def _dense_reset(st: HMCState) -> HMCState:
    ndim = st.q.shape[1]
    cov = st.welford_m2 / torch.clamp(st.welford_n - 1.0, min=1.0)[:, None,
                                                                     None]
    d = torch.diagonal(cov, dim1=-2, dim2=-1)
    diag = torch.diag_embed(torch.where(d > 0, d, 1.0))
    eye = torch.eye(ndim, dtype=cov.dtype, device=cov.device)
    cov = 0.8 * cov + 0.2 * diag + 1e-10 * eye
    return _reset_adaptation(st, cholesky_or_nan(cov))


def _freeze(st: HMCState) -> HMCState:
    return st._replace(log_eps=st.log_eps_avg,
                       n_accepted=torch.zeros_like(st.n_accepted))


def staged_segment(step_fn: Callable, state: HMCState, i0: int, length: int,
                   n_warmup: int, eps0: float
                   ) -> Tuple[HMCState, Tuple[torch.Tensor, ...]]:
    """Advance every chain `length` steps from global step index `i0`.

    `step_fn(st, adapt, mu_offset)` advances one step. The warmup staging
    (eps -> diagonal metric -> dense metric -> freeze) fires on the global
    step index, so segmented runs are bit-identical to one uninterrupted
    run. Returns (state, (q, lnp, aux)) recorded after every step, each
    with the chain axis first: (C, length, ...)."""
    mu_offset = math.log(10.0 * eps0)
    w1 = n_warmup // 3
    w2 = n_warmup // 3
    recs = []
    for i in range(i0, i0 + length):
        if i == w1:
            state = _diag_reset(state)
        if i == w1 + w2:
            state = _dense_reset(state)
        if i == n_warmup:
            state = _freeze(state)
        state = step_fn(state, i < n_warmup, mu_offset)
        recs.append((state.q, state.lnp, state.aux))
    return state, tuple(torch.stack(r, dim=1) for r in zip(*recs))

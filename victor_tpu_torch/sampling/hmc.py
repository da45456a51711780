"""Hamiltonian Monte Carlo, and the chain state and staged warmup that the
adaptive samplers share.

The port of `victor_tpu/sampling/hmc.py`: `HMCState`, the post-transition
adaptation `_adapt_and_pack` (dual averaging of the step size, Welford
accumulation of the dense chain covariance), the warmup resets and the
staged schedule of `staged_segment`, which random-walk Metropolis
(sampling/mh.py) and NUTS (sampling/nuts.py) share; and HMC itself: the
dense-mass leapfrog with jittered step sizes and trajectory lengths.

Chains are independent and carry a leading chain axis (C, ...) in place of
`jax.vmap`. The stage transitions key on the global step index, a host
integer, so a run split into segments is bit-identical to one uninterrupted
run. The gradient comes from autograd through the batched posterior
(`value_and_grad`): on CUDA tensors the spline lookups differentiate through
the hand-written backward kernel of `kernels/csrc/ppoly_eval.cu`.

`_hmc_step` takes its noise as arguments (the tests feed it victor_tpu's own
key splits); `run_segment` draws it from the state's generator, the same
draws per step whatever the trajectory, so segments and resumes are
bit-identical. Per-chain trajectory lengths reproduce `lax.fori_loop` under
`vmap`: every chain runs the longest one's leapfrogs, and a chain whose own
length is reached keeps its point. That needs the longest length on the
host: one read from the card per step.

Matrix-vector products are elementwise products and sums (`_mv`, `_mvt`),
so no matmul, and no TF32, touches the trajectory or the kinetic energy:
the counterpart of victor_tpu's `matmul_highest`.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

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


# ---------------------------------------------------------------------------
# HMC
# ---------------------------------------------------------------------------

def _mv(L: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """L @ v per chain, (C, d, d) x (C, d), as a product and a sum."""
    return (L * v[:, None, :]).sum(-1)


def _mvt(L: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """L^T @ v per chain."""
    return (L * v[:, :, None]).sum(-2)


def _kinetic(L: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """0.5 |L^T p|^2 per chain: the kinetic energy under the inverse mass
    L L^T."""
    return 0.5 * (_mvt(L, p) ** 2).sum(-1)


def value_and_grad(logpost_y: Callable) -> Callable:
    """vg(y (C, ndim)) -> (lnp (C,), aux (C, n_aux), grad (C, ndim)), the
    gradient of each row's lnp by one `torch.autograd.grad` of lnp.sum():
    right because rows are independent, each lnp a function of its own y
    only (as `jax.value_and_grad` under `vmap`)."""
    def vg(y):
        with torch.enable_grad():
            y = y.detach().requires_grad_()
            lnp, aux = logpost_y(y)
            (grad,) = torch.autograd.grad(lnp.sum(), y)
        return lnp.detach(), aux.detach().reshape(y.shape[0], -1), grad
    return vg


def _leapfrog(value_grad: Callable, q, p, grad, lnp, aux, eps, L,
              n_steps: torch.Tensor):
    """n_steps[c] leapfrog steps of chain c with the dense inverse mass
    L L^T; returns (q, p, grad, lnp, aux). Every chain runs max(n_steps)
    steps, one batched posterior and gradient each, and a chain whose own
    count is reached keeps its carry (`lax.fori_loop` under `vmap`)."""
    lo, hi = (int(v) for v in torch.stack(
        [n_steps.min(), n_steps.max()]).tolist())
    half = (0.5 * eps)[:, None]
    for i in range(hi):
        p1 = p + half * grad
        q1 = q + eps[:, None] * _mv(L, _mvt(L, p1))
        lnp1, aux1, grad1 = value_grad(q1)
        p1 = p1 + half * grad1
        if i < lo:
            q, p, grad, lnp, aux = q1, p1, grad1, lnp1, aux1
            continue
        live = i < n_steps
        q, p, grad, aux = (torch.where(live[:, None], new, old) for new, old
                           in ((q1, q), (p1, p), (grad1, grad), (aux1, aux)))
        lnp = torch.where(live, lnp1, lnp)
    return q, p, grad, lnp, aux


def _hmc_step(value_grad: Callable, state: HMCState, jitter: torch.Tensor,
              n_steps: torch.Tensor, xi: torch.Tensor, u: torch.Tensor,
              adapt: bool, target_accept: float = 0.8,
              mu_offset: float = 1.5) -> HMCState:
    """One HMC transition of every chain: jitter (C,) the step-size factor
    in [0.9, 1.1], n_steps (C,) the trajectory lengths, xi (C, ndim)
    standard normal momentum noise, u (C,) uniform acceptance noise."""
    eps = torch.exp(state.log_eps) * jitter
    L = state.chol_cov
    # momenta ~ N(0, M) with M = (L L^T)^-1: p = L^-T xi
    p0 = torch.linalg.solve_triangular(L.mT, xi[:, :, None], upper=True)[..., 0]
    ke0 = _kinetic(L, p0)
    q1, p1, grad1, lnp1, aux1 = _leapfrog(value_grad, state.q, p0, state.grad,
                                          state.lnp, state.aux, eps, L,
                                          n_steps)
    log_accept = (lnp1 - _kinetic(L, p1)) - (state.lnp - ke0)
    log_accept = torch.where(torch.isnan(log_accept), -math.inf, log_accept)
    accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
    accept = torch.log(u) < log_accept

    q = torch.where(accept[:, None], q1, state.q)
    lnp = torch.where(accept, lnp1, state.lnp)
    grad = torch.where(accept[:, None], grad1, state.grad)
    aux = torch.where(accept[:, None], aux1, state.aux)
    return _adapt_and_pack(state, q, lnp, grad, aux, accept_prob, accept,
                           adapt, target_accept, mu_offset=mu_offset)


def draw_noise(state: HMCState, n_leapfrog: int):
    """One HMC step's noise from the state's generator, in a fixed number
    of draws: (jitter (C,) in [0.9, 1.1), n_steps (C,) in
    [max(1, n_leapfrog // 2), n_leapfrog], xi (C, ndim), u (C,))."""
    q, gen = state.q, state.generator
    like = dict(dtype=q.dtype, device=q.device)
    C = q.shape[0]
    jitter = 0.9 + 0.2 * torch.rand(C, generator=gen, **like)
    n_steps = torch.randint(max(1, n_leapfrog // 2), n_leapfrog + 1, (C,),
                            generator=gen, device=q.device)
    xi = torch.randn(q.shape, generator=gen, **like)
    u = torch.rand(C, generator=gen, **like)
    return jitter, n_steps, xi, u


def init_chains(logpost_y: Callable, y0: torch.Tensor,
                generator: torch.Generator, eps0: float = 0.1,
                chol0: Optional[torch.Tensor] = None) -> HMCState:
    """Initial state of a batch of chains at y0 (C, ndim), with the
    posterior's gradient there. `chol0`: optional Cholesky factor of the
    inverse mass matrix (the position-covariance estimate), (ndim, ndim)
    shared or (C, ndim, ndim) per chain, as from a cobaya covmat; the staged
    warmup replaces it from the chain's own covariance at the first
    reset."""
    lnp, aux, grad = value_and_grad(logpost_y)(y0)
    n_chains, ndim = y0.shape
    like = dict(dtype=y0.dtype, device=y0.device)
    if chol0 is None:
        chol0 = torch.eye(ndim, **like)
    log_eps = torch.full((n_chains,), math.log(eps0), **like)
    return HMCState(
        q=y0, lnp=lnp, grad=grad, aux=aux, generator=generator,
        log_eps=log_eps, log_eps_avg=log_eps.clone(),
        h_bar=torch.zeros(n_chains, **like),
        welford_mean=torch.zeros_like(y0),
        welford_m2=torch.zeros(n_chains, ndim, ndim, **like),
        welford_n=torch.zeros(n_chains, **like),
        chol_cov=torch.as_tensor(chol0, **like).expand(
            n_chains, ndim, ndim).clone(),
        n_accepted=torch.zeros(n_chains, **like))


def run_segment(logpost_y: Callable, states: HMCState, i0: int, length: int,
                n_warmup: int, n_leapfrog: int = 16, eps0: float = 0.1,
                target_accept: float = 0.8):
    """Advance every chain `length` HMC steps from global step `i0` (the
    staged warmup of `staged_segment`, bit-identical when split into
    segments). logpost_y(y (C, ndim)) -> (lnp (C,), aux (C, n_aux)) is
    differentiated by autograd."""
    value_grad = value_and_grad(logpost_y)
    return staged_segment(
        lambda st, adapt, mu: _hmc_step(value_grad, st,
                                        *draw_noise(st, n_leapfrog), adapt,
                                        target_accept, mu_offset=mu),
        states, i0, length, n_warmup, eps0)


def run_hmc(logpost_y: Callable, y0: torch.Tensor,
            generator: torch.Generator, n_warmup: int = 300,
            n_samples: int = 700, n_leapfrog: int = 16, eps0: float = 0.1,
            target_accept: float = 0.8):
    """Independent HMC chains from y0 (C, ndim): staged warmup, then
    n_samples draws. Returns (state, (q, lnp, aux)) with the draws' arrays
    (C, n_samples, ...), positions in the unbounded space."""
    state = init_chains(logpost_y, y0, generator, eps0)
    state, recs = run_segment(logpost_y, state, 0, n_warmup + n_samples,
                              n_warmup, n_leapfrog, eps0, target_accept)
    return state, tuple(r[:, n_warmup:] for r in recs)

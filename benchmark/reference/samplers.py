"""One SMC stage and one HMC step in plain PyTorch and NumPy, replayed from
a sampler's recorded state.

The algorithms are those of the program's `sampling/smc.py` (adaptive
tempering by ESS bisection, systematic resampling, random-walk Metropolis
moves under the weighted particle covariance) and `sampling/hmc.py` (dense
inverse mass L L^T, jittered step sizes, per-chain trajectory lengths), and
the noise is drawn from a `torch.Generator` restored to the recorded state,
in the program's order of draws. The likelihood is the reference's own
(`loglike_y`, `logpost_and_grad`): a replay follows the program from its
state, and each of its likelihood values is the reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def ess_fraction(lnw: np.ndarray) -> float:
    w = np.exp(lnw - lnw.max())
    w /= w.sum()
    return 1.0 / (len(w) * float((w ** 2).sum()))


def choose_dbeta(lnl: np.ndarray, beta: float, ess_target: float) -> float:
    """The largest d-beta <= 1 - beta whose weights keep the ESS fraction
    at ess_target, by 60 bisections."""
    hi = 1.0 - beta
    if ess_fraction(hi * lnl) >= ess_target:
        return hi
    lo = 0.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if ess_fraction(mid * lnl) >= ess_target:
            lo = mid
        else:
            hi = mid
    return max(lo, 1e-8)


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    chol, info = torch.linalg.cholesky_ex((a + a.mT) / 2)
    return torch.where((info == 0)[..., None, None], chol, math.nan).tril()


def proposal_cholesky(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2.38 / sqrt(d) times the Cholesky factor of the w-weighted covariance
    of y (N, d), with a trace-scaled jitter and a diagonal fallback."""
    d = y.shape[1]
    mu = (w[:, None] * y).sum(0)
    yc = y - mu
    C = (w[:, None, None] * yc[:, :, None] * yc[:, None, :]).sum(0)
    C = C + torch.clamp(1e-6 * torch.trace(C) / d, min=1e-30) \
        * torch.eye(d, dtype=C.dtype, device=C.device)
    chol = _cholesky_or_nan(C)
    chol = torch.where(torch.isfinite(chol).all(), chol,
                       torch.diag(torch.sqrt(torch.diag(C))))
    return chol * (2.38 / math.sqrt(d))


def smc_stage(lnlike, lnprior, state: dict, n_moves: int,
              ess_target: float, device, dtype=torch.float64) -> dict:
    """The stage after `state` (a particle sampler's checkpoint: y, lnl,
    lnpri, aux, beta and the generator's state): its new temperature, the
    resample and `n_moves` Metropolis moves, computed in `dtype`, noise
    included. lnlike(y) -> (lnl, chi2) and lnprior(y) are the reference's.
    Returns the new y, lnl and chi2."""
    def t(key):
        return torch.as_tensor(state[key], device=device).to(dtype)
    y, lnl, lnpri, aux = t('y'), t('lnl'), t('lnpri'), t('aux').reshape(-1)
    n, ndim = y.shape
    lnl_h = lnl.cpu().numpy().astype(np.float64)
    lnl_h = np.where(np.isfinite(lnl_h), lnl_h, -1e30)
    beta = float(state['beta'])
    dbeta = choose_dbeta(lnl_h, beta, ess_target)
    beta_new = min(beta + dbeta, 1.0)
    lnw = dbeta * lnl_h
    w = np.exp(lnw - lnw.max())
    w = torch.as_tensor(w / w.sum(), dtype=y.dtype, device=device)

    gen = torch.Generator(device=device)
    gen.set_state(torch.as_tensor(state['generator'], dtype=torch.uint8))
    like = dict(generator=gen, dtype=y.dtype, device=device)
    u_res = torch.rand((), **like)
    eps = torch.randn((n_moves, n, ndim), **like)
    u_acc = torch.rand((n_moves, n), **like)

    chol = proposal_cholesky(w, y)
    pos = (u_res + torch.arange(n, dtype=y.dtype, device=device)) / n
    idx = torch.clamp(torch.searchsorted(torch.cumsum(w, 0), pos), 0, n - 1)
    y, lnl, lnpri, aux = y[idx], lnl[idx], lnpri[idx], aux[idx]
    for k in range(n_moves):
        y_p = y + (eps[k][:, None, :] * chol[None, :, :]).sum(-1)
        lnl_p, aux_p = lnlike(y_p)
        lnpri_p = lnprior(y_p)
        accept = torch.log(u_acc[k]) < \
            (beta_new * lnl_p + lnpri_p) - (beta_new * lnl + lnpri)
        y = torch.where(accept[:, None], y_p, y)
        lnl = torch.where(accept, lnl_p, lnl)
        lnpri = torch.where(accept, lnpri_p, lnpri)
        aux = torch.where(accept, aux_p, aux)
    return {'y': y, 'lnl': lnl, 'chi2': aux}


def _mv(L, v):
    return (L * v[:, None, :]).sum(-1)


def _mvt(L, v):
    return (L * v[:, :, None]).sum(-2)


def _kinetic(L, p):
    return 0.5 * (_mvt(L, p) ** 2).sum(-1)


def hmc_step(value_grad, q, lnp, grad, log_eps, chol, gen_state,
             n_leapfrog: int) -> torch.Tensor:
    """The positions after one HMC transition of every chain from q (C, d)
    with its log posterior, gradient, log step size and inverse-mass factor
    L, the noise drawn from a generator restored to `gen_state`.
    value_grad(y) -> (lnp, grad) is the reference's."""
    C = q.shape[0]
    gen = torch.Generator(device=q.device)
    gen.set_state(gen_state)
    like = dict(generator=gen, dtype=q.dtype, device=q.device)
    jitter = 0.9 + 0.2 * torch.rand(C, **like)
    n_steps = torch.randint(max(1, n_leapfrog // 2), n_leapfrog + 1, (C,),
                            generator=gen, device=q.device)
    xi = torch.randn(q.shape, **like)
    u = torch.rand(C, **like)

    eps = torch.exp(log_eps) * jitter
    p0 = torch.linalg.solve_triangular(chol.mT, xi[:, :, None],
                                       upper=True)[..., 0]
    ke0 = _kinetic(chol, p0)
    q1, p1, g1, lnp1 = q, p0, grad, lnp
    half = (0.5 * eps)[:, None]
    for i in range(int(n_steps.max())):
        p_half = p1 + half * g1
        q_new = q1 + eps[:, None] * _mv(chol, _mvt(chol, p_half))
        lnp_new, g_new = value_grad(q_new)
        p_new = p_half + half * g_new
        live = i < n_steps
        q1 = torch.where(live[:, None], q_new, q1)
        p1 = torch.where(live[:, None], p_new, p1)
        g1 = torch.where(live[:, None], g_new, g1)
        lnp1 = torch.where(live, lnp_new, lnp1)
    log_accept = (lnp1 - _kinetic(chol, p1)) - (lnp - ke0)
    log_accept = torch.where(torch.isnan(log_accept), -math.inf, log_accept)
    accept = torch.log(u) < log_accept
    return torch.where(accept[:, None], q1, q)

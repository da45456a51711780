"""Ensemble MCMC on the device: differential-evolution and stretch moves.

The port of `victor_tpu/sampling/ensemble.py`. Every walker's likelihood is
evaluated in one batched call per half-step. The state carries a
`torch.Generator` on the walkers' device in place of a JAX key; `step` draws
each half-update's noise from it and passes the noise to the half-update as
arguments, so a half-update is a pure function of its inputs (the tests feed
it victor_tpu's own draws). Draws are made per step, so a run split into
segments consumes the generator exactly as one uninterrupted run does.

Two complementary-ensemble moves (each updates one half against the other,
preserving detailed balance with respect to the complementary walkers):

  * 'de': differential evolution (ter Braak 2006) — proposal
    x + gamma (x_r1 - x_r2) with distinct partners from the other half,
    gamma jittered around the 2.38/sqrt(2 ndim) optimum and a 10% chance of
    gamma = 1 mode-hopping jumps; symmetric, so plain Metropolis acceptance.
    It needs at least two walkers in each half: `step` raises InputError for
    fewer than 4 walkers (victor_tpu draws r2 == r1 there and never moves).
  * 'stretch': Goodman & Weare affine-invariant stretch move.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from ..errors import InputError


class EnsembleState(NamedTuple):
    coords: torch.Tensor      # (n_walkers, ndim)
    log_prob: torch.Tensor    # (n_walkers,)
    aux: torch.Tensor         # (n_walkers, n_aux) auxiliary outputs (chi2)
    generator: torch.Generator
    n_accepted: torch.Tensor  # (n_walkers,) running acceptance counts
    n_steps: int              # sweeps taken


def init_state(logpost_fn: Callable, coords: torch.Tensor,
               generator: torch.Generator) -> EnsembleState:
    lnp, aux = logpost_fn(coords)
    if aux.ndim == 1:            # (W,) -> (W, 1); multi-aux (W, K) unchanged
        aux = aux[:, None]
    return EnsembleState(coords=coords, log_prob=lnp, aux=aux,
                         generator=generator,
                         n_accepted=torch.zeros_like(lnp), n_steps=0)


def _accept(proposal, lnp_new, aux_new, active, lnp_active, aux_active,
            log_accept, u_acc):
    accept = torch.log(u_acc) < log_accept
    coords = torch.where(accept[:, None], proposal, active)
    lnp = torch.where(accept, lnp_new, lnp_active)
    aux = torch.where(accept[:, None], aux_new, aux_active)
    return coords, lnp, aux, accept


def _half_update(logpost_fn, active, other, lnp_active, aux_active, a,
                 u_z, partners, u_acc):
    """Stretch-move update of one half of the ensemble against the other.
    Noise: u_z (n,) uniform for the stretch factor, partners (n,) indices
    into `other`, u_acc (n,) uniform for the acceptance test."""
    ndim = active.shape[1]
    z = ((a - 1.0) * u_z + 1.0) ** 2 / a
    x_p = other[partners]
    proposal = x_p + z[:, None] * (active - x_p)
    lnp_new, aux_new = logpost_fn(proposal)
    log_accept = (ndim - 1) * torch.log(z) + lnp_new - lnp_active
    return _accept(proposal, lnp_new, aux_new, active, lnp_active,
                   aux_active, log_accept, u_acc)


def _de_half_update(logpost_fn, active, other, lnp_active, aux_active,
                    r1, r2_offset, g_normal, u_jump, u_acc,
                    jump_prob: float = 0.1):
    """Differential-evolution update of one half against the other:
    proposal x + gamma (x_r1 - x_r2) with distinct partners r1 != r2 of the
    complementary half. Noise: r1 (n,) indices in [0, m), r2_offset (n,) in
    [1, m) (r2 = (r1 + offset) mod m cannot collide with r1), g_normal (n,)
    standard normal jitter of gamma, u_jump (n,) uniform for the gamma = 1
    jumps, u_acc (n,) uniform for the acceptance test."""
    ndim = active.shape[1]
    m = other.shape[0]
    r2 = (r1 + r2_offset) % m
    gamma0 = 2.38 / math.sqrt(2.0 * ndim)
    g = gamma0 * (1.0 + 1e-4 * g_normal)
    g = torch.where(u_jump < jump_prob, 1.0, g)
    proposal = active + g[:, None] * (other[r1] - other[r2])
    lnp_new, aux_new = logpost_fn(proposal)
    return _accept(proposal, lnp_new, aux_new, active, lnp_active,
                   aux_active, lnp_new - lnp_active, u_acc)


def _stretch_noise(gen, n, m, like):
    u_z = torch.rand(n, generator=gen, dtype=like.dtype, device=like.device)
    partners = torch.randint(0, m, (n,), generator=gen, device=like.device)
    u_acc = torch.rand(n, generator=gen, dtype=like.dtype, device=like.device)
    return u_z, partners, u_acc


def _de_noise(gen, n, m, like):
    r1 = torch.randint(0, m, (n,), generator=gen, device=like.device)
    r2_offset = torch.randint(1, m, (n,), generator=gen, device=like.device)
    g_normal = torch.randn(n, generator=gen, dtype=like.dtype,
                           device=like.device)
    u_jump = torch.rand(n, generator=gen, dtype=like.dtype, device=like.device)
    u_acc = torch.rand(n, generator=gen, dtype=like.dtype, device=like.device)
    return r1, r2_offset, g_normal, u_jump, u_acc


def step(logpost_fn: Callable, state: EnsembleState, a: float = 2.0,
         move: str = 'stretch') -> EnsembleState:
    """One full red-black sweep (both halves updated) with the given move."""
    x, lnp, aux = state.coords, state.log_prob, state.aux
    n = x.shape[0] // 2
    if move == 'de':
        if x.shape[0] < 4:
            raise InputError(
                "ensemble move 'de' needs at least 4 walkers (two distinct "
                f'partners in each half); got {x.shape[0]}')

        def half(act, oth, lp, ax):
            noise = _de_noise(state.generator, act.shape[0], oth.shape[0], x)
            return _de_half_update(logpost_fn, act, oth, lp, ax, *noise)
    elif move == 'stretch':
        def half(act, oth, lp, ax):
            noise = _stretch_noise(state.generator, act.shape[0],
                                   oth.shape[0], x)
            return _half_update(logpost_fn, act, oth, lp, ax, a, *noise)
    else:
        raise ValueError(f"ensemble move must be 'de' or 'stretch', "
                         f'got {move!r}')
    x0, lnp0, aux0, acc0 = half(x[:n], x[n:], lnp[:n], aux[:n])
    x1, lnp1, aux1, acc1 = half(x[n:], x0, lnp[n:], aux[n:])
    return EnsembleState(
        coords=torch.cat([x0, x1]),
        log_prob=torch.cat([lnp0, lnp1]),
        aux=torch.cat([aux0, aux1]),
        generator=state.generator,
        n_accepted=state.n_accepted + torch.cat([acc0, acc1]),
        n_steps=state.n_steps + 1,
    )


def run(logpost_fn: Callable, state: EnsembleState, n_steps: int,
        a: float = 2.0, thin: int = 1, move: str = 'stretch'
        ) -> Tuple[EnsembleState, Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]]:
    """Advance `n_steps` sweeps, recording every `thin`-th state.

    Returns (final_state, (coords, log_prob, aux)) with leading axis
    n_steps // thin (n_steps must be a multiple of thin: a silent
    remainder-drop, or a thin > n_steps run that never advanced the state,
    would hide misconfiguration). The loop never reads a value back to the
    host.
    """
    if thin < 1 or n_steps % thin != 0:
        raise ValueError(f'n_steps ({n_steps}) must be a positive multiple '
                         f'of thin ({thin})')
    recs = []
    for i in range(n_steps):
        state = step(logpost_fn, state, a, move)
        if (i + 1) % thin == 0:
            recs.append((state.coords, state.log_prob, state.aux))
    return state, tuple(torch.stack(r) for r in zip(*recs))


def make_logpost(log_prior_fn: Callable, batched_loglike: Callable):
    """Compose prior + batched likelihood into the (lnp, aux) posterior fn.

    Points outside the prior support short-circuit to -inf but are still
    evaluated (branchless batch); the NaN guard inside the likelihood keeps
    them finite-safe (victor/ccf_fit.py:477-481 semantics).
    """
    def logpost(coords):
        lp = log_prior_fn(coords)
        lnl, chisq = batched_loglike(coords)
        total = torch.where(torch.isfinite(lp), lp + lnl, -math.inf)
        return total, chisq[..., None]
    return logpost

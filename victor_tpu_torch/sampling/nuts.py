"""No-U-Turn Sampler: dynamic trajectory lengths on top of the HMC machinery.

The port of `victor_tpu/sampling/nuts.py`: each transition doubles a
leapfrog trajectory until the path starts to U-turn, and draws the next
state multinomially from the whole trajectory (Hoffman & Gelman 2014; the
multinomial, biased-progressive form of Betancourt 1701.02434). Warmup is
HMC's (the state is an `hmc.HMCState` and the stage transitions are
`hmc.staged_segment`), so `runner.run_hmc_mcmc(algorithm='nuts')` gets the
segments, checkpoints and exact resume of the other samplers.

The tree is built iteratively, as in victor_tpu: an outer loop over tree
depth, each doubling 2^depth leapfrog steps with one batched posterior and
gradient each, and the recursive algorithm's within-subtree U-turn checks
reproduced by an O(max_depth) checkpoint buffer (leaf m, m even, is written
to slot popcount(m); an odd leaf n is checked against slots popcount(n >> t)
.. popcount(n) - 1, t the number of trailing one-bits of n). The leaf index
is shared by every chain of a subtree, so that bookkeeping is host integer
arithmetic.

`lax.while_loop` under `vmap` runs while any chain's condition holds and
keeps the carry of the chains whose condition fails; here each loop runs
while any chain is active (one read from the card per doubling and per
leaf) and every update is masked by the chain's own activity.

`_nuts_step` takes its noise as arguments: the momentum noise and a
function of the depth that gives each doubling's direction, merge and leaf
uniforms (the tests replay victor_tpu's key splits through it).
`run_segment` draws them from the state's generator: per step the momentum,
per doubling that any chain performs a fixed block (direction and merge
(C,), 2^depth leaf uniforms), so the draws are a function of the state and
segments and resumes are bit-identical.

Each leapfrog step of the batch counts one `hmc.leapfrogs`
(`utils.profiling`), as HMC's position updates do.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from ..errors import InputError
from ..utils.profiling import count
from .hmc import (HMCState, _adapt_and_pack, _kinetic, _mv, _mvt,
                  init_chains, staged_segment, value_and_grad)

_DIVERGENCE = 1000.0     # Stan's Delta_max energy-error cutoff

#: what the transitions so far did, summed over chains: chain-steps, the
#: doublings the chains performed (mean tree depth = doublings / steps) and
#: the acceptance statistic that drives the step size (a device tensor once
#: a step has run). Set the entries to 0 before a run to read its own.
STATS = {'steps': 0, 'doublings': 0, 'accept_stat': 0.0}


def _is_turning(q_minus, v_minus, q_plus, v_plus) -> torch.Tensor:
    """Generalised U-turn criterion with velocities v = M^-1 p, per chain."""
    dq = q_plus - q_minus
    return ((dq * v_minus).sum(-1) < 0.0) | ((dq * v_plus).sum(-1) < 0.0)


def _leapfrog(value_grad: Callable, q, p, grad, eps, L):
    """One leapfrog step of every chain with the dense inverse mass L L^T;
    returns the new (q, p, grad, lnp, aux) and the velocity and kinetic
    energy at it."""
    half = (0.5 * eps)[:, None]
    p = p + half * grad
    q = q + eps[:, None] * _mv(L, _mvt(L, p))
    lnp, aux, grad = value_grad(q)
    p = p + half * grad
    count('hmc.leapfrogs', 1, q.device)
    return q, p, grad, lnp, aux, _mv(L, _mvt(L, p)), _kinetic(L, p)


def _popcount(n: int) -> int:
    return bin(n).count('1')


def _trailing_ones(n: int) -> int:
    return len(bin(n)) - len(bin(n).rstrip('1'))


def _where(mask, new, old):
    """torch.where with a (C,) mask over (C, ...) tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)),
                       new, old)


def _build_subtree(value_grad: Callable, ts: dict, depth: int, eps, L, H0,
                   u_leaf: torch.Tensor, active0: torch.Tensor,
                   max_depth: int) -> dict:
    """Up to 2^depth leapfrog steps from ts's (q, p, grad) of the chains in
    `active0`, accumulating the multinomial proposal (u_leaf (2^depth, C):
    each leaf's switch uniform) and the recursive algorithm's U-turn checks
    through the checkpoint buffers (module docstring). A chain stops at a
    U-turn or a divergence."""
    C, ndim = ts['q'].shape
    like = dict(dtype=ts['q'].dtype, device=ts['q'].device)
    q_ckpt = torch.zeros(C, max_depth, ndim, **like)
    v_ckpt = torch.zeros(C, max_depth, ndim, **like)
    for n in range(1 << depth):
        active = active0 & ~ts['turning'] & ~ts['diverging']
        if not bool(active.any()):
            break
        q, p, grad, lnp, aux, v, ke = _leapfrog(value_grad, ts['q'], ts['p'],
                                                ts['grad'], eps, L)
        H = -lnp + ke
        dH = H - H0
        dH = torch.where(torch.isnan(dH), math.inf, dH)
        diverging = dH > _DIVERGENCE
        log_w = -H
        # multinomial within-subtree proposal: switch with probability
        # exp(log_w - logaddexp(log_sum_w, log_w))
        log_total = torch.logaddexp(ts['log_sum_w'], log_w)
        take = (torch.log(u_leaf[n]) < (log_w - log_total)) & ~diverging
        new = dict(
            q=q, p=p, grad=grad, lnp=lnp, aux=aux,
            q_prop=_where(take, q, ts['q_prop']),
            lnp_prop=torch.where(take, lnp, ts['lnp_prop']),
            grad_prop=_where(take, grad, ts['grad_prop']),
            aux_prop=_where(take, aux, ts['aux_prop']),
            log_sum_w=torch.where(diverging, ts['log_sum_w'], log_total),
            sum_accept=ts['sum_accept'] + torch.clamp(torch.exp(-dH),
                                                      max=1.0),
            leaf=ts['leaf'] + 1, diverging=diverging)
        turning = ts['turning']
        if n % 2 == 0:
            slot = _popcount(n)
            q_ckpt[:, slot] = _where(active, q, q_ckpt[:, slot])
            v_ckpt[:, slot] = _where(active, v, v_ckpt[:, slot])
        else:
            for j in range(_popcount(n >> _trailing_ones(n)), _popcount(n)):
                turning = turning | _is_turning(q_ckpt[:, j], v_ckpt[:, j],
                                                q, v)
        new['turning'] = turning
        ts = {k: _where(active, v_new, ts[k]) for k, v_new in new.items()}
    return ts


def _nuts_step(value_grad: Callable, state: HMCState, xi: torch.Tensor,
               doubling_noise: Callable, max_depth: int, adapt: bool,
               target_accept: float = 0.8, mu_offset: float = 1.5
               ) -> HMCState:
    """One NUTS transition of every chain and the shared warmup adaptation.
    xi (C, ndim): standard normal momentum noise; doubling_noise(depth) ->
    (go_right (C,) bool, u_merge (C,), u_leaf (2^depth, C)) the draws of the
    doubling at that depth."""
    C = state.q.shape[0]
    like = dict(dtype=state.q.dtype, device=state.q.device)
    L = state.chol_cov
    eps = torch.exp(state.log_eps)
    p0 = torch.linalg.solve_triangular(L.mT, xi[:, :, None], upper=True)[..., 0]
    v0 = _mv(L, _mvt(L, p0))
    H0 = -state.lnp + _kinetic(L, p0)
    zeros = torch.zeros(C, **like)
    no = torch.zeros(C, dtype=torch.bool, device=state.q.device)

    # the global tree: endpoints with momenta pointing outward
    c = dict(q_l=state.q, p_l=-p0, grad_l=state.grad, v_l=-v0,
             q_r=state.q, p_r=p0, grad_r=state.grad, v_r=v0,
             q_prop=state.q, lnp_prop=state.lnp, grad_prop=state.grad,
             aux_prop=state.aux, log_sum_w=-H0, sum_accept=zeros,
             n_leaves=zeros, turning=no, diverging=no)
    for depth in range(max_depth):
        active = ~c['turning'] & ~c['diverging']
        n_active = int(active.sum())        # the loop's one read per doubling
        if not n_active:
            break
        STATS['doublings'] += n_active
        go_right, u_merge, u_leaf = doubling_noise(depth)
        q0 = _where(go_right, c['q_r'], c['q_l'])
        g0 = _where(go_right, c['grad_r'], c['grad_l'])
        ts = dict(q=q0, p=_where(go_right, c['p_r'], c['p_l']), grad=g0,
                  lnp=zeros, aux=c['aux_prop'], q_prop=q0,
                  lnp_prop=torch.full((C,), -math.inf, **like), grad_prop=g0,
                  aux_prop=c['aux_prop'],
                  log_sum_w=torch.full((C,), -math.inf, **like),
                  sum_accept=zeros, leaf=zeros, turning=no, diverging=no)
        ts = _build_subtree(value_grad, ts, depth, eps, L, H0, u_leaf, active,
                            max_depth)
        ok = ~ts['turning'] & ~ts['diverging']
        # biased progressive sampling: take the new subtree's proposal with
        # probability min(1, W_new / W_old)
        take = (torch.log(u_merge) < (ts['log_sum_w'] - c['log_sum_w'])) & ok
        v_new = _mv(L, _mvt(L, ts['p']))
        new = dict(
            q_prop=_where(take, ts['q_prop'], c['q_prop']),
            lnp_prop=torch.where(take, ts['lnp_prop'], c['lnp_prop']),
            grad_prop=_where(take, ts['grad_prop'], c['grad_prop']),
            aux_prop=_where(take, ts['aux_prop'], c['aux_prop']),
            log_sum_w=torch.where(ok, torch.logaddexp(c['log_sum_w'],
                                                      ts['log_sum_w']),
                                  c['log_sum_w']),
            sum_accept=c['sum_accept'] + ts['sum_accept'],
            n_leaves=c['n_leaves'] + ts['leaf'],
            # the moved endpoint; the outward momentum on the left is -p
            q_l=_where(go_right, c['q_l'], ts['q']),
            p_l=_where(go_right, c['p_l'], ts['p']),
            grad_l=_where(go_right, c['grad_l'], ts['grad']),
            v_l=_where(go_right, c['v_l'], v_new),
            q_r=_where(go_right, ts['q'], c['q_r']),
            p_r=_where(go_right, ts['p'], c['p_r']),
            grad_r=_where(go_right, ts['grad'], c['grad_r']),
            v_r=_where(go_right, v_new, c['v_r']),
            diverging=ts['diverging'])
        # the full tree's U-turn check (outward momenta: negate the left)
        new['turning'] = ts['turning'] | (ok & _is_turning(
            new['q_l'], -new['v_l'], new['q_r'], new['v_r']))
        c = {k: _where(active, v_new_, c[k]) for k, v_new_ in new.items()}

    moved = (c['q_prop'] != state.q).any(-1)
    accept_stat = c['sum_accept'] / torch.clamp(c['n_leaves'], min=1.0)
    STATS['steps'] += C
    STATS['accept_stat'] = STATS['accept_stat'] + accept_stat.sum()
    return _adapt_and_pack(state, c['q_prop'], c['lnp_prop'], c['grad_prop'],
                           c['aux_prop'], accept_stat, moved, adapt,
                           target_accept, mu_offset=mu_offset)


def draw_momentum(state: HMCState) -> torch.Tensor:
    return torch.randn(state.q.shape, generator=state.generator,
                       dtype=state.q.dtype, device=state.q.device)


def doubling_draws(state: HMCState) -> Callable:
    """doubling_noise for `_nuts_step` from the state's generator: at each
    doubling the direction and merge uniforms (C,) and 2^depth leaf
    uniforms (2^depth, C)."""
    q, gen = state.q, state.generator
    like = dict(dtype=q.dtype, device=q.device)
    C = q.shape[0]

    def draw(depth: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        go_right = torch.rand(C, generator=gen, **like) < 0.5
        u_merge = torch.rand(C, generator=gen, **like)
        return go_right, u_merge, torch.rand(1 << depth, C, generator=gen,
                                             **like)
    return draw


def run_segment(logpost_y: Callable, states: HMCState, i0: int, length: int,
                n_warmup: int, max_depth: int = 8, eps0: float = 0.1,
                target_accept: float = 0.8):
    """Advance every chain `length` NUTS steps from global step `i0`, with
    HMC's staged warmup and segment semantics."""
    if not 1 <= max_depth <= 16:
        # as victor_tpu: 2^16 leapfrogs per step is already far past any
        # sane trajectory
        raise InputError(f'NUTS max_depth must be in [1, 16], got {max_depth}')
    value_grad = value_and_grad(logpost_y)
    return staged_segment(
        lambda st, adapt, mu: _nuts_step(
            value_grad, st, draw_momentum(st), doubling_draws(st), max_depth,
            adapt, target_accept, mu_offset=mu),
        states, i0, length, n_warmup, eps0)


def run_nuts(logpost_y: Callable, y0: torch.Tensor,
             generator: torch.Generator, n_warmup: int = 300,
             n_samples: int = 700, max_depth: int = 8, eps0: float = 0.1,
             target_accept: float = 0.8):
    """Independent NUTS chains from y0 (C, ndim), as `hmc.run_hmc`: staged
    warmup, then n_samples draws. Returns (state, (q, lnp, aux)) with the
    draws' arrays (C, n_samples, ...)."""
    state = init_chains(logpost_y, y0, generator, eps0)
    state, recs = run_segment(logpost_y, state, 0, n_warmup + n_samples,
                              n_warmup, max_depth, eps0, target_accept)
    return state, tuple(r[:, n_warmup:] for r in recs)

"""Nested sampling: an independent evidence estimator and posterior sampler.

The port of `victor_tpu/sampling/nested.py`. Reference users reach for
external nested samplers (MultiNest / PolyChord / dynesty through cobaya)
when they want the Bayesian evidence; the port already computes Z by
tempered SMC (sampling/smc.py). This module adds the nested-sampling
estimate as a METHODOLOGICALLY INDEPENDENT cross-check: SMC integrates over
a temperature ladder, NS integrates over prior volume — the two share no
statistics, so agreement is a genuine validation of both
(tools/validate_posterior.py provides the third, sampler-free anchor).

Algorithm (batched Skilling nested sampling, MCMC constrained replacement —
the MultiNest-style kernel, vectorised over the batch axis):

  1. N live points drawn from the PRIOR, held in the unbounded
     reparameterisation y (ParamSpace.to_unbounded).
  2. Each iteration deletes the K lowest-likelihood live points. Deleting
     the j-th (j = 1..K, ascending L, no replacement in between) shrinks the
     prior volume by E[d ln X] = -1/(N - j + 1): the standard
     reduced-live-point shrinkage, exact for any K (Higson et al. 2019,
     "dynamic nested sampling" uses the same bookkeeping). Each dead point
     contributes L_j * (X_{j-1} - X_j) to Z.
  3. K replacements are drawn uniformly from the prior RESTRICTED to
     L > L*, where L* is the largest deleted likelihood: Metropolis chains
     started at K random survivors, proposal = scaled Cholesky of the
     survivor covariance, accepting moves with (log u < d ln prior) AND
     (L > L*). After the batch the live set is again N prior-uniform points
     in {L > L*}. The K chains advance together on the device (`_step`:
     n_steps sequential moves, each one K-point batched likelihood call).
  4. Terminate when the remaining live contribution max(L_live) * X could
     raise ln Z by less than `dlogz`; the live points then enter the sum
     with width X/N each.

`_step` takes its noise as arguments (the tests feed it victor_tpu's own key
splits); `run_nested` draws it from a `torch.Generator` on the device
(`draw_step_noise`), whose state the checkpoint stores. The host-side draws
(the start points, the final resample) are numpy's, as in victor_tpu, and the
evidence bookkeeping runs in host f64.

The error bar is the classical sqrt(H/N) (Skilling 2006) where H is the
information; like SMC's CLT bar it can be optimistic under correlated
replacement chains, so the BOSS seed study in BASELINE.md records the
measured seed-to-seed scatter next to it.

Plateau caveat: exactly tied likelihoods (e.g. many -inf guard failures
surviving into late iterations) bias the shrinkage estimate (Fowlie et al.
2021). With continuous likelihoods and sane priors, -inf points die in the
first few iterations; the implementation treats them as L = exp(-1e300).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from scipy.special import logsumexp

from ..io.tables import _target_device
from ..utils.logging import get_logger
from .priors import ParamSpace

log = get_logger('nested')

_NEG = -1e300        # host-side stand-in for lnL = -inf (keeps exp() exact 0)


@dataclasses.dataclass
class NestedResult:
    space: ParamSpace
    particles: np.ndarray       # (M, ndim) equal-weight posterior draws
    log_prob: np.ndarray        # (M,) lnL + ln prior at the particles
    aux: np.ndarray             # (M, n_aux) auxiliary outputs (chi2)
    logz: float                 # log evidence estimate
    logz_se: float              # classical sqrt(H / n_live) error estimate
    h: float                    # information (nats)
    n_live: int
    n_iter: int                 # batch iterations executed
    n_like: int                 # total likelihood evaluations dispatched
    ess: float                  # effective sample size of the NS weights
    points_logl: np.ndarray     # (n_dead + n_live,) raw NS sequence lnL
    points_logwt: np.ndarray    # (n_dead + n_live,) ln(L dX) (unnormalised)
    acceptance: np.ndarray      # replacement-chain acceptance per iteration
    elapsed_s: float

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {p.name: {'mean': float(self.particles[:, i].mean()),
                         'std': float(self.particles[:, i].std())}
                for i, p in enumerate(self.space.sampled)}


def draw_step_noise(generator: torch.Generator, n_batch: int, ndim: int,
                    n_steps: int, dtype=torch.float64):
    """One iteration's noise from `generator`: the proposal normals
    (n_steps, n_batch, ndim) and the acceptance uniforms (n_steps,
    n_batch), on the generator's device."""
    like = dict(generator=generator, dtype=dtype, device=generator.device)
    return (torch.randn((n_steps, n_batch, ndim), **like),
            torch.rand((n_steps, n_batch), **like))


def _step(lnlike, lnprior, y, lnl, lnpri, aux, w, start_idx, dead_idx,
          threshold, scale, noise):
    """One NS iteration on the device: the live points (y (N, ndim), lnl,
    lnpri, aux) lose the points at `dead_idx` (unique), replaced by
    Metropolis chains on the prior restricted to lnL > `threshold`, started
    at `start_idx`, one move per entry of the noise (`draw_step_noise`),
    with the proposal `scale` times the survivor covariance (w = 1/(N-K)
    on the survivors, 0 on the dead). Returns the new live set, the mean
    acceptance, the share of chains that moved (0-d tensors) and the dead
    points' y and aux, read before they are overwritten."""
    from .targets import guarded_cholesky

    eps, u = noise
    chol = guarded_cholesky(w, y, scale)
    y_dead, aux_dead = y[dead_idx], aux[dead_idx]
    yk, lnlk, lnprik, auxk = (y[start_idx], lnl[start_idx],
                              lnpri[start_idx], aux[start_idx])
    n_acc = torch.zeros((), dtype=y.dtype, device=y.device)
    moved = torch.zeros(lnlk.shape, dtype=torch.bool, device=y.device)
    for k in range(eps.shape[0]):
        y_p = yk + eps[k] @ chol.T
        lnl_p, aux_p = lnlike(y_p)
        lnpri_p = lnprior(y_p)
        # Metropolis on the prior restricted to {L > L*}
        accept = (torch.log(u[k]) < lnpri_p - lnprik) & (lnl_p > threshold)
        yk = torch.where(accept[:, None], y_p, yk)
        lnlk = torch.where(accept, lnl_p, lnlk)
        lnprik = torch.where(accept, lnpri_p, lnprik)
        auxk = torch.where(accept[:, None], aux_p, auxk)
        n_acc = n_acc + accept.to(y.dtype).mean()
        moved = moved | accept
    y, lnl, lnpri, aux = (t.index_copy(0, dead_idx, new) for t, new in (
        (y, yk), (lnl, lnlk), (lnpri, lnprik), (aux, auxk)))
    return (y, lnl, lnpri, aux, n_acc / eps.shape[0],
            moved.to(y.dtype).mean(), y_dead, aux_dead)


def run_nested(bundle, params_block: Dict, n_live: int = 1024,
               n_batch: Optional[int] = None, n_steps: int = 24,
               dlogz: float = 0.01, seed: int = 0,
               opts_kw: Optional[Dict] = None, fit_kw: Optional[Dict] = None,
               chunk: Optional[int] = 64, max_iter: int = 5000,
               checkpoint: Optional[str] = None, resume: bool = False,
               checkpoint_every: int = 1,
               output: Optional[str] = None,
               aux_names: Optional[list] = None, mesh=None, mesh_axis=None,
               device='cuda') -> NestedResult:
    """Estimate the evidence and sample the posterior by nested sampling.

    `bundle` is any target kind run_smc takes. `n_batch` dead points are
    replaced per iteration (default n_live // 4); `n_steps` Metropolis moves
    grow each replacement chain. `chunk` bounds peak memory exactly like
    likelihood/batched.py. The live points live on `device` (the card unless
    'cpu' is asked for), where the target's tables must be.

    `checkpoint`/`resume` mirror run_smc: the full sampler state (live
    points, dead-point records, volume, running evidence, the generator's
    state) is written each iteration and a resumed run is bit-identical to
    an uninterrupted one — the survivor ordering is deterministic in the
    restored likelihoods, and both the generator and the iteration counter
    (which seeds the host-side start-point draw) are part of the state.
    n_live, n_batch, n_steps and seed are stored in the checkpoint and
    override the arguments on resume (with a log message), so a resumed run
    can never splice a different shrinkage schedule onto the accumulated
    dead records. Each save rewrites the FULL accumulated dead-point history
    (O(n_iter**2) total I/O over a run); the default schedules finish in
    ~50-100 iterations where that is a few MB, but a long run with small
    n_batch should raise `checkpoint_every` (resume then replays at most
    that many iterations, still bit-identically).

    `mesh`: optional parallel.Mesh; every likelihood batch is split along
    `mesh_axis` (default: all mesh axes), each slice evaluated on its
    device against a replica of the tables in chunks of `chunk` (issued in
    turn across the devices) and gathered on `device`. The live points,
    the step and the generator stay on `device`, so the draws do not
    depend on the mesh.
    """
    from . import chains as chain_io
    from ..parallel.mesh import shard_map
    from .runner import _check_device
    from .smc import load_state
    from .targets import (is_callable_target, make_unbounded_wrappers,
                          resolve_target)

    device = _target_device(device)
    space = ParamSpace(params_block)
    # NS is gradient-free: 'auto' perf modes resolve to the validated
    # fast modes (config.resolve_perf_mode; explicit opts are the opt-out)
    tables_arg, loglike = resolve_target(bundle, opts_kw, fit_kw,
                                         gradient_free=True)
    _check_device(tables_arg, device, mesh)

    # The checkpoint is loaded BEFORE the n_batch default/validation so a
    # resumed run inherits the checkpoint's shrinkage schedule: n_live comes
    # from the stored live set, and n_batch/n_steps/seed are stored
    # explicitly — splicing a different n_batch onto the accumulated dead
    # records would change the shrinkage schedule mid-stream, and a
    # different seed/n_steps would break the bit-identical-resume guarantee.
    state = None
    if resume and checkpoint and os.path.isfile(checkpoint):
        state = load_state(checkpoint, device)
        if state['y'].shape[0] != n_live:
            log.info('resume: checkpoint has %d live points; overriding the '
                     'n_live=%d argument', state['y'].shape[0], n_live)
            n_live = int(state['y'].shape[0])
        for name, cur in (('n_batch', n_batch), ('n_steps', n_steps),
                          ('seed', seed)):
            if name in state:
                val = int(state[name])
                if cur is not None and val != int(cur):
                    log.info('resume: checkpoint has %s=%d; overriding the '
                             '%s=%s argument', name, val, name, cur)
                if name == 'n_batch':
                    n_batch = val
                elif name == 'n_steps':
                    n_steps = val
                else:
                    seed = val
        log.info('resumed nested sampling from %s at iteration %d '
                 '(ln X = %.2f)', checkpoint, int(state['it']),
                 float(state['lnx']))

    if n_batch is None:
        n_batch = max(1, n_live // 4)
    if not 1 <= n_batch <= n_live // 2:
        raise ValueError(f'n_batch={n_batch} must be in [1, n_live//2='
                         f'{n_live // 2}]: at least half the live points '
                         'must survive to define the constrained region')
    if n_steps < 1:
        raise ValueError('n_steps must be >= 1')
    if checkpoint_every < 1:
        raise ValueError('checkpoint_every must be >= 1')

    # shard_map chunks the batch (in turns across a mesh's devices)
    lnprior, batched_lnlike = make_unbounded_wrappers(space, loglike)
    lnlike = shard_map(batched_lnlike, tables_arg, mesh, mesh_axis, chunk)

    t0 = time.time()
    n_like = 0
    if state is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        y = space.to_unbounded(space.sample_prior(gen, n_live))
        lnl, aux = lnlike(y)
        lnpri = lnprior(y)
        n_like += n_live
        it = 0
        lnx = 0.0
        logz = -np.inf
        scale = 1.0
        dead_y: list = []
        dead_lnl: list = []
        dead_lnwt: list = []
        dead_aux: list = []
        acc_hist: list = []
        moved_hist: list = []
    else:
        y, lnl, lnpri, aux = (torch.as_tensor(state[k], device=device)
                              for k in ('y', 'lnl', 'lnpri', 'aux'))
        gen = state['generator']
        it = int(state['it'])
        lnx = float(state['lnx'])
        logz = float(state['logz'])
        scale = float(state['scale'])
        n_like = int(state['n_like'])
        dead_y = list(state['dead_y'])
        dead_lnl = list(state['dead_lnl'])
        dead_lnwt = list(state['dead_lnwt'])
        dead_aux = list(state['dead_aux'])
        acc_hist = list(state['acc_hist'])
        moved_hist = list(state['moved_hist'])

    def _save_checkpoint():
        if not checkpoint:
            return
        # atomic, like smc.py's (chains._write_npz)
        chain_io._write_npz(checkpoint, dict(
            y=chain_io._host(y), lnl=chain_io._host(lnl),
            lnpri=chain_io._host(lnpri), aux=chain_io._host(aux),
            generator=chain_io._host(gen.get_state()), it=it, lnx=lnx,
            logz=logz, scale=scale, n_like=n_like,
            n_batch=n_batch, n_steps=n_steps, seed=seed,
            dead_y=np.asarray(dead_y, dtype=np.float64),
            dead_lnl=np.asarray(dead_lnl, dtype=np.float64),
            dead_lnwt=np.asarray(dead_lnwt, dtype=np.float64),
            dead_aux=np.asarray(dead_aux, dtype=np.float64),
            acc_hist=np.asarray(acc_hist),
            moved_hist=np.asarray(moved_hist)))

    # shrinkage per deletion within a batch: live counts N, N-1, .., N-K+1
    divisors = n_live - np.arange(n_batch, dtype=np.float64)
    dln = 1.0 / divisors
    # width of dead point j (ascending L): X_{j-1} - X_j, in log form
    ln_shrink = np.log1p(-np.exp(-dln))

    while True:
        lnl_h = lnl.detach().cpu().numpy().astype(np.float64)
        lnl_h = np.where(np.isfinite(lnl_h), lnl_h, _NEG)
        logz_live = lnx + float(lnl_h.max())
        if np.logaddexp(logz, logz_live) - logz < dlogz:
            break
        if it >= max_iter:
            # the cadence may not have saved THIS iteration's state; write
            # it now so the error message below is true for any
            # checkpoint_every
            _save_checkpoint()
            raise RuntimeError(
                f'nested sampling did not terminate in {max_iter} iterations '
                '(state saved to the checkpoint if one was given; '
                'resume=True continues exactly)')

        order = np.argsort(lnl_h, kind='stable')
        dead_idx = order[:n_batch]
        survivors = order[n_batch:]
        threshold = lnl_h[dead_idx[-1]]

        # host-side start-point draw, stateless in (seed, it) so a resumed
        # run replays the identical choice; starts must lie strictly inside
        # {L > L*} (a tied/-inf survivor is not a valid constrained-region
        # seed — its chain could end recorded at L <= L*)
        valid = survivors[lnl_h[survivors] > threshold]
        if len(valid) == 0:
            # every survivor ties at L* (a likelihood plateau): chains must
            # start AT the threshold, and any that fail to move leave their
            # replacement recorded at L <= L* — exactly the tied-likelihood
            # shrinkage bias of the module docstring's plateau caveat
            log.warning('iteration %d: all %d survivors tie at the '
                        'threshold lnL=%.3g (likelihood plateau) — '
                        'replacement chains start AT L* and the shrinkage '
                        'estimate (hence logZ) is biased on plateaus',
                        it, len(survivors),
                        threshold if threshold > _NEG else float('-inf'))
            valid = survivors
        rng = np.random.default_rng((seed, 777, it))
        start_idx = valid[rng.integers(0, len(valid), n_batch)]

        w = np.zeros(n_live)
        w[survivors] = 1.0 / len(survivors)

        y, lnl, lnpri, aux, acc, moved, y_dead, aux_dead = _step(
            lnlike, lnprior, y, lnl, lnpri, aux,
            torch.as_tensor(w, dtype=y.dtype, device=device),
            torch.as_tensor(start_idx, device=device),
            torch.as_tensor(dead_idx, device=device), float(threshold), scale,
            draw_step_noise(gen, n_batch, space.ndim, n_steps, y.dtype))
        n_like += n_batch * n_steps

        # evidence bookkeeping (host f64): dead_idx is ascending in L
        lnx_prev = lnx + np.concatenate([[0.0], -np.cumsum(dln[:-1])])
        lnwt = lnl_h[dead_idx] + lnx_prev + ln_shrink
        logz = np.logaddexp(logz, float(logsumexp(lnwt)))
        lnx -= float(np.sum(dln))

        dead_y.extend(y_dead.detach().cpu().numpy().astype(np.float64))
        dead_lnl.extend(lnl_h[dead_idx])
        dead_lnwt.extend(lnwt)
        dead_aux.extend(aux_dead.detach().cpu().numpy().astype(np.float64))

        acc = float(acc)
        moved = float(moved)
        acc_hist.append(acc)
        moved_hist.append(moved)
        # host-side proposal-scale adaptation toward ~30% acceptance (the
        # constrained region keeps shrinking relative to the survivor
        # covariance, so a mild controller beats any fixed scale)
        scale = float(np.clip(scale * np.exp(0.5 * (acc - 0.3)), 0.05, 5.0))
        if moved < 0.9:
            log.warning('iteration %d: only %.0f%% of replacement chains '
                        'moved (acceptance %.2f) — duplicates degrade the '
                        'shrinkage statistics; raise n_steps', it,
                        100 * moved, acc)
        it += 1
        if it % checkpoint_every == 0:
            _save_checkpoint()
        if it % 10 == 0 or it == 1:
            log.info('NS iteration %d: ln X=%.2f threshold lnL=%.2f '
                     'acc=%.2f scale=%.2f logZ>=%.3f', it, lnx,
                     threshold if threshold > _NEG else float('-inf'),
                     acc, scale, logz)

    if it % checkpoint_every != 0:
        # termination between cadence points: persist the terminal state
        # (identical to what an every-iteration save would have written —
        # the loop breaks before any mutation) so a resume of a FINISHED
        # run replays it instead of restarting from a stale iteration
        _save_checkpoint()

    # live points enter with width X/N each (their lnl_h is current)
    lnwt_live = lnl_h + lnx - np.log(n_live)
    theta_live = space.to_bounded(y).detach().cpu().numpy().astype(
        np.float64)
    aux_live = aux.detach().cpu().numpy().astype(np.float64)
    logz = np.logaddexp(logz, float(logsumexp(lnwt_live)))

    all_y = (np.asarray(dead_y, dtype=np.float64).reshape(len(dead_y),
                                                          space.ndim)
             if dead_y else np.empty((0, space.ndim)))
    theta_dead = (space.to_bounded(torch.as_tensor(all_y)).numpy()
                  if len(dead_y) else all_y)
    pts_theta = np.concatenate([theta_dead, theta_live])
    pts_lnl = np.concatenate([np.asarray(dead_lnl, dtype=np.float64),
                              lnl_h])
    pts_lnwt = np.concatenate([np.asarray(dead_lnwt, dtype=np.float64),
                               lnwt_live])
    pts_aux = np.concatenate([
        np.asarray(dead_aux, dtype=np.float64).reshape(len(dead_aux), -1)
        if dead_aux else np.empty((0, aux_live.shape[-1])), aux_live])

    # information + classical error bar
    wn = np.exp(pts_lnwt - logz)
    finite = pts_lnl > _NEG
    h = float(np.sum(wn[finite] * pts_lnl[finite]) - logz)
    logz_se = float(np.sqrt(max(h, 0.0) / n_live))
    ess = float(1.0 / np.sum(wn ** 2)) if wn.sum() > 0 else 0.0

    # equal-weight posterior draws by systematic resampling (host, stateless)
    m = max(n_live, 1024)
    rng = np.random.default_rng((seed, 999))
    u = (rng.random() + np.arange(m)) / m
    idx = np.clip(np.searchsorted(np.cumsum(wn / wn.sum()), u), 0,
                  len(wn) - 1)
    particles = pts_theta[idx]
    lnp = pts_lnl[idx] + space.log_prior(torch.as_tensor(particles)).numpy()
    aux_out = pts_aux[idx]

    result = NestedResult(
        space=space, particles=particles, log_prob=lnp, aux=aux_out,
        logz=float(logz), logz_se=logz_se, h=h, n_live=n_live, n_iter=it,
        n_like=n_like, ess=ess, points_logl=pts_lnl, points_logwt=pts_lnwt,
        acceptance=np.asarray(acc_hist), elapsed_s=time.time() - t0)
    log.info('NS done: %d iterations, %d likelihood evals, '
             'logZ = %.3f +/- %.3f (H = %.2f nats, ESS = %.0f; %.1f s)',
             it, n_like, result.logz, result.logz_se, h, ess,
             result.elapsed_s)
    if output:
        if aux_names is None:
            aux_names = ['aux_0'] if is_callable_target(bundle) \
                else ['chi2_ccf_correct']
        chain_io.export_getdist(output, space, particles[:, None, :],
                                lnp[:, None], aux_out[:, None, :],
                                aux_names=aux_names, burn_in=0,
                                n_chain_files=1)
        log.info('posterior particles written to %s.*', output)
    return result

"""High-level MCMC driver: the `cobaya-run` equivalent on one card.

The port of `victor_tpu/sampling/runner.py`. Reference flow
(victor/likelihoods/CCFLikelihood.py + cobaya MH + MPI chains) becomes:
parse the same YAML params block -> ParamSpace; compose prior + batched
likelihood into one posterior on the device; advance the chains or the
walker ensemble in segments; check split-R-hat between segments (the cobaya
R-1 < 0.01 stop, config/boss_cobaya_config.yaml:46-47); checkpoint sampler
state every segment; export GetDist-format chains.

`run_hmc_mcmc` runs HMC (the default, sampling/hmc.py), NUTS
(sampling/nuts.py) or the gradient-free MH (sampling/mh.py). The chains live
on `device` (the card unless 'cpu' is asked for). With `mesh=` (a
parallel.Mesh), as in victor_tpu, the likelihood of the chains or walkers
is sharded over the mesh (parallel.mesh.shard_map): the tables are
replicated on its devices and each evaluates its slice, while the chain
state and the generator stay on `device`, so the draws do not depend on the
mesh.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..errors import InputError
from ..io.tables import _target_device
from ..utils.logging import get_logger
from . import chains as chain_io
from . import diagnostics, ensemble
from .priors import ParamSpace

log = get_logger('sampling')


@dataclasses.dataclass
class MCMCResult:
    space: ParamSpace
    chain: np.ndarray          # (n_recorded, n_walkers, ndim)
    log_prob: np.ndarray       # (n_recorded, n_walkers)
    aux: np.ndarray            # (n_recorded, n_walkers, n_aux)
    state: object              # EnsembleState or HMCState (on the device)
    rhat: np.ndarray
    acceptance: float
    n_steps: int
    elapsed_s: float

    def flat(self, burn_in: Optional[int] = None) -> np.ndarray:
        b = len(self.chain) // 3 if burn_in is None else burn_in
        return self.chain[b:].reshape(-1, self.chain.shape[-1])

    def summary(self, burn_in: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        flat = self.flat(burn_in)
        return {p.name: {'mean': float(flat[:, i].mean()),
                         'std': float(flat[:, i].std()),
                         'rhat': float(self.rhat[i])}
                for i, p in enumerate(self.space.sampled)}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _check_device(tables_arg, device: torch.device, mesh=None) -> None:
    """The target's tensors, and the mesh that shards it, must live on the
    sampler's device type: no silent copy between the card and the host.
    The tables are replicated across the mesh's devices by the sampler."""
    from ..likelihood.multiquantile import JointBundle
    if mesh is not None:
        kinds = {d.type for d in mesh.devices.flat}
        if kinds != {device.type}:
            raise InputError(
                f'the mesh spans {sorted(kinds)} devices but the sampler runs '
                f'on {device}; build the mesh on {device.type} devices')
    if isinstance(tables_arg, tuple):
        for t in tables_arg:
            _check_device(t, device)
        return
    if tables_arg is None:
        return
    ref = tables_arg.icov if isinstance(tables_arg, JointBundle) \
        else tables_arg.iaH
    if ref.device.type != device.type:
        raise InputError(
            f'the target lives on {ref.device} but the sampler runs on '
            f'{device}; build the tables with device={device.type!r} or '
            f'pass device={ref.device.type!r}')


def _posterior_parts(bundle, space: ParamSpace,
                     opts_kw: Optional[Dict] = None,
                     fit_kw: Optional[Dict] = None,
                     gradient_free: bool = True, mesh=None, mesh_axis=None):
    """(logpost(coords) -> (lnp, aux), tables_arg) through the shared
    targets.resolve_target dispatch; with a mesh, the likelihood's batch is
    sharded over it (parallel.mesh.shard_map)."""
    from ..parallel.mesh import shard_map
    from .targets import resolve_target

    # the ensemble moves are gradient-free, so 'auto' perf modes resolve
    # fast by default
    tables_arg, loglike = resolve_target(bundle, opts_kw, fit_kw,
                                         gradient_free)
    loglike_coords = shard_map(
        lambda tbl, coords: loglike(tbl, space.full_params(coords)),
        tables_arg, mesh, mesh_axis)
    logpost = ensemble.make_logpost(space.log_prior, loglike_coords)
    return logpost, tables_arg


def make_posterior(bundle, space: ParamSpace,
                   opts_kw: Optional[Dict] = None,
                   fit_kw: Optional[Dict] = None,
                   gradient_free: bool = True):
    """Batched (lnpost, aux) function over walker coordinate arrays (W, P).

    Accepts anything targets.resolve_target does (single-dataset
    CCFModelBundle, multi-quantile JointBundle, ProductTarget, callable).
    `gradient_free=True` (default) resolves 'auto' perf modes to the
    validated fast modes (config.resolve_perf_mode)."""
    return _posterior_parts(bundle, space, opts_kw, fit_kw, gradient_free)[0]


def _read_covmat(covmat, space: ParamSpace) -> np.ndarray:
    """A `.covmat` path or a theta-space array as the (ndim, ndim) seed
    covariance; absent parameters fall back to proposal^2 (cobaya's fill
    rule)."""
    if isinstance(covmat, str):
        # nan marks "absent AND no proposal" for the loud check below
        prop_var = np.array([(p.proposal ** 2) if p.proposal else np.nan
                             for p in space.sampled])
        covmat_arr = chain_io.read_covmat(covmat, space.names,
                                          fallback_var=prop_var)
    else:
        covmat_arr = np.asarray(covmat, dtype=float)
    if covmat_arr.shape != (space.ndim, space.ndim):
        raise InputError(
            f'covmat shape {covmat_arr.shape} does not match the '
            f'{space.ndim} sampled parameters {space.names}')
    if np.any(np.isnan(covmat_arr)):
        missing = [p.name for i, p in enumerate(space.sampled)
                   if np.isnan(covmat_arr[i, i])]
        raise InputError(
            f'covmat has no entry for {missing} and those parameters '
            'have no proposal: width to fall back on')
    try:
        np.linalg.cholesky(covmat_arr)
    except np.linalg.LinAlgError:
        raise InputError('covmat is not positive definite')
    return covmat_arr


def unbounded_logpost(space: ParamSpace, loglike, tables_arg):
    """The chains' target over the unbounded reparameterisation:
    y (C, ndim) -> (log posterior including the log-Jacobian (C,), chi2
    (C, 1)); non-finite values map to -inf."""
    def logpost_y(y):
        theta = space.to_bounded(y)
        lnl, chisq = loglike(tables_arg, space.full_params(theta))
        lp = space.log_prior(theta) + space.log_jacobian(y)
        total = lnl + lp
        total = torch.where(torch.isfinite(total), total, -math.inf)
        return total, chisq[:, None]
    return logpost_y


def initial_proposal_cholesky(space: ParamSpace, y: torch.Tensor,
                              covmat_arr: Optional[np.ndarray] = None):
    """Per-chain initial proposal Cholesky (C, ndim, ndim) at the chains'
    start points y (C, ndim), or None for the identity: from a theta-space
    covmat, else from the block's proposal: widths. Theta-space inputs map
    to the unbounded sampling space through the diagonal reparameterisation
    Jacobian at each chain's own start point; a covmat that is not positive
    definite there gives a NaN factor, as in victor_tpu."""
    from .hmc import cholesky_or_nan
    if covmat_arr is not None:
        cov_t = torch.as_tensor(covmat_arr, dtype=y.dtype, device=y.device)
        j = space.dtheta_dy_diag(y)
        return cholesky_or_nan(cov_t / (j[:, :, None] * j[:, None, :]))
    if any(p.proposal for p in space.sampled):
        return torch.diag_embed(space.proposal_scales_unbounded(y))
    return None


def run_hmc_mcmc(bundle, params_block: Dict,
                 n_chains: int = 8, n_warmup: int = 300, n_samples: int = 700,
                 n_leapfrog: int = 16, seed: int = 0,
                 opts_kw: Optional[Dict] = None, fit_kw: Optional[Dict] = None,
                 output: Optional[str] = None,
                 checkpoint: Optional[str] = None, resume: bool = False,
                 burn_in_fraction: float = 0.0, segment_steps: int = 100,
                 algorithm: str = 'hmc', max_depth: int = 8, covmat=None,
                 rhat_stop: Optional[float] = None,
                 mesh=None, mesh_axis=None, device='cuda') -> MCMCResult:
    """Adaptive-chain sampling: 'hmc' (the default; dense-mass HMC with
    jittered trajectories of about `n_leapfrog` steps, sampling/hmc.py),
    'nuts' (dynamic trajectories of up to 2^max_depth leapfrogs,
    sampling/nuts.py) or 'mh' (gradient-free adaptive random-walk
    Metropolis — the reference's cobaya sampler family, sampling/mh.py). All
    three share the state and the staged warmup. HMC and NUTS differentiate
    the posterior (autograd, and the spline lookups' backward kernel on the
    card), so 'auto' perf modes resolve for gradients
    (`gradient_free=False`, as victor_tpu does); MH resolves them
    gradient-free.

    Positions are sampled in the unbounded reparameterisation and returned
    in the physical space. Independent chains advance together, one batched
    likelihood call (and gradient) per step or leapfrog, in segments of
    `segment_steps` steps (bit-identical to one uninterrupted run); each
    segment boundary writes the checkpoint (exact resume) and the
    `<output>.progress` row.

    `covmat`: optional cobaya-format `.covmat` path (or a theta-space
    (ndim, ndim) array ordered like the sampled block) seeding the initial
    proposal covariance (MH) or inverse mass matrix (HMC, NUTS) — cobaya's
    `mcmc: {covmat: ...}`; parameters absent from the file fall back to
    their `proposal:` width squared. Without a covmat MH's proposal diagonal
    comes from the block's `proposal:` widths, and HMC and NUTS start from
    the identity. Every exported chain writes `<output>.covmat` back.

    `rhat_stop`: optional convergence stop — cobaya's `Rminus1_stop`: after
    each post-warmup segment with >= 50 recorded draws, stop once split
    max(R-1) < rhat_stop. n_samples is then the draw cap. Stopping only
    truncates the run: the draws are the prefix of a fixed-length run's.

    `mesh`: optional parallel.Mesh; the chains' likelihood (and, for HMC
    and NUTS, its gradient) is evaluated in slices along `mesh_axis`
    (default: all mesh axes), each on its device against a replica of the
    tables, and gathered on `device`, where the chain state and the
    generator stay — the replacement for the reference's `mpirun -n N
    cobaya-run` per-process chains (victor/README.md:30).
    """
    from ..parallel.mesh import shard_map
    from . import hmc as _hmc
    from . import mh as _mh
    from . import nuts as _nuts
    from .targets import resolve_target

    if algorithm not in ('hmc', 'nuts', 'mh'):
        raise ValueError(f"algorithm must be 'hmc', 'nuts' or 'mh', got "
                         f'{algorithm!r}')
    device = _target_device(device)
    space = ParamSpace(params_block)
    # HMC and NUTS differentiate through the likelihood: 'auto' perf modes
    # resolve per path, as in victor_tpu
    tables_arg, loglike = resolve_target(bundle, opts_kw, fit_kw,
                                         gradient_free=(algorithm == 'mh'))
    _check_device(tables_arg, device, mesh)
    covmat_arr = None if covmat is None else _read_covmat(covmat, space)
    logpost_y = shard_map(
        lambda tbl, y: unbounded_logpost(space, loglike, tbl)(y),
        tables_arg, mesh, mesh_axis)
    if algorithm == 'mh':
        def segment(st, i, length):
            return _mh.run_segment(logpost_y, st, i, length,
                                   n_warmup=n_warmup)
    elif algorithm == 'hmc':
        def segment(st, i, length):
            return _hmc.run_segment(logpost_y, st, i, length,
                                    n_warmup=n_warmup, n_leapfrog=n_leapfrog)
    else:
        def segment(st, i, length):
            return _nuts.run_segment(logpost_y, st, i, length,
                                     n_warmup=n_warmup, max_depth=max_depth)

    states = prev = i0 = None
    if resume and checkpoint:
        try:
            states, pc, pl, pa, i0 = chain_io.load_hmc_checkpoint(
                checkpoint, device)
            prev = (pc, pl, pa) if pc is not None else None
            log.info('resumed %s from %s at step %s', algorithm.upper(),
                     checkpoint, i0)
        except FileNotFoundError:
            pass
    if states is not None:
        # the checkpoint's chain count is authoritative
        n_chains = int(states.q.shape[0])

    t0 = time.time()
    n_total = n_warmup + n_samples
    # a fresh run truncates <output>.progress; a resumed one appends
    fresh_progress = states is None
    if states is not None and i0 is not None:
        i0 = int(i0)
        if i0 >= n_total:
            # resuming a completed run extends it by n_samples more draws
            # (adaptation stays frozen: all new indices are >= n_warmup)
            n_total = i0 + n_samples
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        y0 = space.to_unbounded(space.sample_ref(gen, n_chains))
        if algorithm == 'mh':
            states = _mh.init_chains(
                logpost_y, y0, gen,
                chol0=initial_proposal_cholesky(space, y0, covmat_arr))
        else:
            # the metric starts from a covmat only: proposal widths are MH's
            states = _hmc.init_chains(
                logpost_y, y0, gen, chol0=None if covmat_arr is None else
                initial_proposal_cholesky(space, y0, covmat_arr))
        i0 = 0
    recs = [prev] if prev is not None else []   # post-warmup (S,C,·) records
    while i0 < n_total:
        length = min(segment_steps, n_total - i0)
        states, (qs, lnps, auxs) = segment(states, i0, length)
        i0 += length
        keep = length - max(min(n_warmup - (i0 - length), length), 0)
        if keep > 0:
            q_keep = qs[:, length - keep:]
            # record the THETA-space log-posterior: the sampler's lnp target
            # includes the reparameterisation log-Jacobian (y-space), which
            # would skew GetDist's -lnpost column against the physical
            # coordinates
            lnp_keep = lnps[:, length - keep:] - space.log_jacobian(q_keep)
            recs.append((_host(space.to_bounded(q_keep)).transpose(1, 0, 2),
                         _host(lnp_keep).T,
                         _host(auxs[:, length - keep:]).transpose(1, 0, 2)))
        if checkpoint:
            chain_io.save_hmc_checkpoint(
                checkpoint, states,
                *((np.concatenate([r[j] for r in recs]) for j in range(3))
                  if recs else (None, None, None)),
                i0=i0)
        # diagnostics only when a consumer exists: the concatenation grows
        # with the run and split-R-hat is host work per segment
        need_diag = bool(output) or rhat_stop is not None
        sofar = np.concatenate([r[0] for r in recs]) \
            if recs and need_diag else None
        n_rec = 0 if sofar is None else len(sofar)
        rm1 = (float(np.max(diagnostics.split_rhat(sofar) - 1))
               if n_rec >= 4 else float('nan'))
        if output:
            # cobaya's <root>.progress monitoring file: one row per segment
            acc_now = float(np.mean(_host(states.n_accepted))
                            / max(n_rec if n_rec else i0, 1))
            chain_io.append_progress(output, n_rec, acc_now, rm1,
                                     reset=fresh_progress)
            fresh_progress = False
        if rhat_stop is not None and n_rec >= 50:
            log.info('step %d: max(R-1)=%.4f (stop at %.3g)',
                     i0, rm1, rhat_stop)
            if rm1 < rhat_stop:
                log.info('converged: R-1 < %.3g at %d draws '
                         '(cap was %d)', rhat_stop, n_rec,
                         n_total - n_warmup)
                break
    if recs:
        chain = np.concatenate([r[0] for r in recs])   # (S, C, P)
        lnp = np.concatenate([r[1] for r in recs])
        aux = np.concatenate([r[2] for r in recs])
    else:
        chain = np.empty((0, n_chains, space.ndim))
        lnp = np.empty((0, n_chains))
        aux = np.empty((0, n_chains, states.aux.shape[-1]))
    rhat = diagnostics.split_rhat(chain)
    n_recorded = max(len(chain), 1)
    acc = float(np.mean(_host(states.n_accepted)) / n_recorded)
    # split-R-hat needs >=4 samples per chain to be defined
    max_rm1 = float(np.max(rhat - 1)) if len(chain) >= 4 else None
    log.info('%s: %d chains x %d samples, acceptance=%.3f max(R-1)=%s',
             algorithm.upper(), n_chains, len(chain), acc,
             'n/a (<4 samples)' if max_rm1 is None else f'{max_rm1:.4f}')

    result = MCMCResult(
        space=space, chain=chain, log_prob=lnp, aux=aux, state=states,
        rhat=rhat, acceptance=acc, n_steps=len(chain),
        elapsed_s=time.time() - t0)
    if output:
        burn = int(len(chain) * burn_in_fraction)
        # one GetDist file per chain (cobaya/MPI's chains/test.<N>.txt layout)
        chain_io.export_getdist(output, space, chain, lnp, aux,
                                aux_names=['chi2_ccf_correct'], burn_in=burn,
                                n_chain_files=n_chains)
        log.info('chains written to %s.*', output)
    return result


def run_mcmc(bundle, params_block: Dict,
             n_walkers: int = 256, max_steps: int = 2000,
             rhat_stop: float = 0.01, check_every: int = 100,
             burn_in_fraction: float = 0.3, thin: int = 1,
             seed: int = 0,
             opts_kw: Optional[Dict] = None, fit_kw: Optional[Dict] = None,
             output: Optional[str] = None,
             checkpoint: Optional[str] = None,
             resume: bool = False, n_chain_files: int = 4,
             move: str = 'de', mesh=None, mesh_axis: str = 'walkers',
             device='cuda') -> MCMCResult:
    """Sample the posterior with the walker ensemble; returns chains +
    diagnostics.

    `mesh`: optional parallel.Mesh; each half-update's likelihood batch is
    sharded along `mesh_axis` (the walker state and the generator stay on
    `device`).

    `move`: 'de' (default — differential evolution, ter Braak 2006; needs
    at least 4 walkers) or 'stretch' (Goodman & Weare). As in victor_tpu,
    the checkpoint does not record the move: a resumed run continues with
    the `move` it is given.
    """
    device = _target_device(device)
    space = ParamSpace(params_block)
    logpost, tables = _posterior_parts(bundle, space, opts_kw, fit_kw,
                                       mesh=mesh, mesh_axis=mesh_axis)
    _check_device(tables, device, mesh)

    segments: list = []
    state = None
    if resume and checkpoint:
        try:
            state, prev_chain, prev_lnp, prev_aux = \
                chain_io.load_checkpoint(checkpoint, device)
            if prev_chain is not None:
                segments.append((prev_chain, prev_lnp, prev_aux))
            log.info('resumed from %s at step %d', checkpoint, state.n_steps)
        except FileNotFoundError:
            pass
    fresh_progress = state is None   # truncate <output>.progress on fresh runs
    if state is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        state = ensemble.init_state(logpost, space.sample_ref(gen, n_walkers),
                                    gen)

    t0 = time.time()
    total_recorded = sum(len(c[0]) for c in segments)
    while total_recorded * thin < max_steps:
        state, recs = ensemble.run(logpost, state, check_every, thin=thin,
                                   move=move)
        segments.append(tuple(_host(r) for r in recs))
        total_recorded += len(segments[-1][0])

        chain = np.concatenate([s[0] for s in segments])
        burn = int(len(chain) * burn_in_fraction)
        post = chain[burn:] if len(chain) - burn >= 4 else chain
        rhat = diagnostics.split_rhat(post)
        acc = diagnostics.acceptance_fraction(_host(state.n_accepted),
                                              state.n_steps)
        log.info('step %d: max(R-1)=%.4f acceptance=%.3f',
                 total_recorded * thin, float(np.max(rhat - 1)), acc)
        if checkpoint:
            chain_io.save_checkpoint(
                checkpoint, state, chain,
                np.concatenate([s[1] for s in segments]),
                np.concatenate([s[2] for s in segments]))
        if output:
            # cobaya's <root>.progress monitoring file: one row per segment
            chain_io.append_progress(output, total_recorded * thin, acc,
                                     float(np.max(rhat - 1)),
                                     reset=fresh_progress)
            fresh_progress = False
        if np.max(rhat - 1) < rhat_stop and total_recorded * thin >= 2 * check_every:
            break

    chain = np.concatenate([s[0] for s in segments])
    lnp = np.concatenate([s[1] for s in segments])
    aux = np.concatenate([s[2] for s in segments])
    # recompute R-hat from the final chain: a resumed checkpoint that already
    # satisfies max_steps never enters the loop
    burn = int(len(chain) * burn_in_fraction)
    post = chain[burn:] if len(chain) - burn >= 4 else chain
    rhat = diagnostics.split_rhat(post)
    result = MCMCResult(
        space=space, chain=chain, log_prob=lnp, aux=aux, state=state,
        rhat=rhat,
        acceptance=diagnostics.acceptance_fraction(_host(state.n_accepted),
                                                   state.n_steps),
        n_steps=state.n_steps, elapsed_s=time.time() - t0)

    if output:
        # walker groups -> GetDist chain files (cobaya/MPI layout)
        chain_io.export_getdist(output, space, chain, lnp, aux,
                                aux_names=['chi2_ccf_correct'], burn_in=burn,
                                n_chain_files=n_chain_files)
        log.info('chains written to %s.*', output)
    return result

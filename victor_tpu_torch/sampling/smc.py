"""Tempered sequential Monte Carlo with Bayesian-evidence estimation.

The port of `victor_tpu/sampling/smc.py`. Neither the reference nor cobaya's
default Metropolis provides the evidence Z = integral of L(theta) pi(theta)
d theta (cobaya users reach for external nested samplers). On the card an SMC
sampler is the natural fit: the whole particle population evaluates in one
batched likelihood call per move, the temperature ladder adapts itself, and
log Z falls out of the incremental importance weights for free.

Algorithm (adaptive-beta SMC, systematic resampling, random-walk Metropolis
mutations):

  1. N particles drawn from the PRIOR (ParamSpace.sample_prior — exact prior
     draws are what make the evidence estimate unbiased).
  2. At inverse temperature beta, choose the next step d-beta by bisection so
     the effective sample size of w_i = exp(d-beta * lnL_i) stays at
     `ess_target * N` (Beskos et al. 2016 adaptive tempering).
  3. log Z accumulates log mean_i exp(d-beta * lnL_i) per stage.
  4. Systematic resample by w, then `n_moves` random-walk Metropolis steps
     targeting pi(theta) L(theta)^beta in the unbounded reparameterisation,
     with proposal covariance 2.38^2/d times the weighted particle covariance
     (adapts to the tempered posterior's shape each stage).

A stage (`_stage`) is one function over tensors on the device: the weighted
Cholesky, the resample and the moves. It takes its noise as arguments (the
tests feed it victor_tpu's own key splits); `run_smc` draws the noise from a
`torch.Generator` on the device (`draw_stage_noise`), whose state the
checkpoint stores. Only the (N,) log-likelihood vector and the acceptance
return to the host each stage, for the d-beta bisection.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..errors import InputError
from ..io.tables import _target_device
from ..utils.logging import get_logger
from .priors import ParamSpace

log = get_logger('smc')

# The internal CLT standard error assumes independent importance weights;
# resampling/mutation correlations make it optimistic. Measured on the BOSS
# posterior (BASELINE.md seed study): seed-to-seed scatter 0.12 vs CLT se
# 0.038 — a factor ~3. The REPORTED logz_se is inflated by this factor so the
# quoted bar covers the observed scatter; the raw CLT value stays available
# as logz_se_clt.
LOGZ_SE_INFLATION = 3.0


@dataclasses.dataclass
class SMCResult:
    space: ParamSpace
    particles: np.ndarray       # (N, ndim) physical-space posterior draws
    log_prob: np.ndarray        # (N,) lnL + ln prior at the particles
    aux: np.ndarray             # (N, n_aux) auxiliary outputs (chi2)
    logz: float                 # log evidence estimate
    logz_se: float              # reported standard error of logz: the
                                # internal CLT se inflated by
                                # LOGZ_SE_INFLATION (measured resampling-
                                # correlation factor) so it covers the
                                # observed seed-to-seed scatter
    logz_se_clt: float          # raw independent-weights CLT se (optimistic)
    betas: np.ndarray           # temperature ladder actually used (incl. 0, 1)
    ess: np.ndarray             # pre-resampling ESS FRACTION (ESS/N, 0..1)
                                # per stage — not an absolute sample count
    acceptance: np.ndarray      # mutation acceptance per stage
    elapsed_s: float

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {p.name: {'mean': float(self.particles[:, i].mean()),
                         'std': float(self.particles[:, i].std())}
                for i, p in enumerate(self.space.sampled)}


def _systematic_resample(u: torch.Tensor, w: torch.Tensor, n: int):
    """Systematic resampling from one uniform draw u: indices i with
    multiplicity ~ n * w_i (the left-sided search of victor_tpu)."""
    pos = (u + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    cdf = torch.cumsum(w, 0)
    return torch.clamp(torch.searchsorted(cdf, pos, right=False), 0, n - 1)


def _ess_fraction(lnw):
    """ESS of normalised exp(lnw) as a fraction of the particle count."""
    lnw = lnw - lnw.max()
    w = np.exp(lnw)
    w /= w.sum()
    return 1.0 / (len(w) * float((w ** 2).sum()))


def _choose_dbeta(lnl, beta, ess_target):
    """Largest d-beta <= 1-beta with ESS(exp(d-beta*lnl)) >= ess_target*N."""
    hi = 1.0 - beta
    if _ess_fraction(hi * lnl) >= ess_target:
        return hi
    lo = 0.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _ess_fraction(mid * lnl) >= ess_target:
            lo = mid
        else:
            hi = mid
    return max(lo, 1e-8)


def draw_stage_noise(generator: torch.Generator, n: int, ndim: int,
                     n_moves: int, dtype=torch.float64):
    """One stage's noise from `generator`: the resample uniform (), the
    proposal normals (n_moves, n, ndim) and the acceptance uniforms
    (n_moves, n), on the generator's device."""
    like = dict(generator=generator, dtype=dtype, device=generator.device)
    return (torch.rand((), **like), torch.randn((n_moves, n, ndim), **like),
            torch.rand((n_moves, n), **like))


def _stage(lnlike, lnprior, y, lnl, lnpri, aux, w, beta_new, noise):
    """One SMC stage at the new inverse temperature `beta_new`: resample the
    particles (y (N, ndim), lnl, lnpri, aux) by the normalised weights w,
    then one random-walk Metropolis move per entry of the noise
    (`draw_stage_noise`). lnlike(y) -> (lnl, aux) and lnprior(y) are the
    batched wrappers of targets.make_unbounded_wrappers. Returns the new
    (y, lnl, lnpri, aux) and the mean acceptance (0-d tensor)."""
    from .targets import guarded_cholesky

    u_res, eps, u_acc = noise
    n = y.shape[0]
    # proposal from the PRE-resampling weighted covariance
    chol = guarded_cholesky(w, y)
    idx = _systematic_resample(u_res, w, n)
    y, lnl, lnpri, aux = y[idx], lnl[idx], lnpri[idx], aux[idx]
    n_acc = torch.zeros((), dtype=y.dtype, device=y.device)
    for k in range(eps.shape[0]):
        y_p = y + eps[k] @ chol.T
        lnl_p, aux_p = lnlike(y_p)
        lnpri_p = lnprior(y_p)
        ln_acc = (beta_new * lnl_p + lnpri_p) - (beta_new * lnl + lnpri)
        accept = torch.log(u_acc[k]) < ln_acc
        y = torch.where(accept[:, None], y_p, y)
        lnl = torch.where(accept, lnl_p, lnl)
        lnpri = torch.where(accept, lnpri_p, lnpri)
        aux = torch.where(accept[:, None], aux_p, aux)
        n_acc = n_acc + accept.to(y.dtype).mean()
    return y, lnl, lnpri, aux, n_acc / eps.shape[0]


def load_state(checkpoint: str, device) -> Dict:
    """A particle sampler's checkpoint (smc.py, nested.py) as a dict of
    arrays, its generator state restored into a `torch.Generator` on
    `device` under 'generator'. A victor_tpu checkpoint stores a JAX key
    instead of a generator state and cannot be resumed here."""
    from .chains import _generator
    with np.load(checkpoint, allow_pickle=False) as z:
        state = {k: z[k] for k in z.files}
    if 'generator' not in state:
        raise InputError(
            f'{checkpoint} holds no torch.Generator state (a victor_tpu '
            'checkpoint stores a JAX PRNG key): victor_tpu_torch cannot '
            'resume it; resume it with victor_tpu or start a fresh run')
    state['generator'] = _generator(state['generator'], device)
    return state


def run_smc(bundle, params_block: Dict, n_particles: int = 2048,
            ess_target: float = 0.5, n_moves: int = 5, seed: int = 0,
            opts_kw: Optional[Dict] = None, fit_kw: Optional[Dict] = None,
            chunk: Optional[int] = 64, max_stages: int = 200,
            checkpoint: Optional[str] = None, resume: bool = False,
            output: Optional[str] = None,
            aux_names: Optional[list] = None, mesh=None, mesh_axis=None,
            device='cuda') -> SMCResult:
    """Sample the posterior AND estimate the evidence by tempered SMC.

    `bundle` is a CCFModelBundle, a multi-quantile JointBundle, a
    ProductTarget or (for testing / custom targets) a callable params-dict of
    (N,) tensors -> (lnlike (N,), aux (N,)). `chunk` bounds peak memory
    exactly like likelihood/batched.py. The particles live on `device` (the
    card unless 'cpu' is asked for), where the target's tables must be.

    `checkpoint`: write the full sampler state (particles, temperatures,
    running log Z, the generator's state) at every stage boundary;
    `resume=True` continues an interrupted run exactly — the d-beta
    bisection is deterministic in the restored log-likelihoods and the
    generator is part of the state, so a resumed run is bit-identical to an
    uninterrupted one.

    `mesh`: optional parallel.Mesh; every likelihood batch is split along
    `mesh_axis` (default: all mesh axes), each slice evaluated on its
    device against a replica of the tables in chunks of `chunk` (issued in
    turn across the devices) and gathered on `device`. The particles, the
    resampling, the stage and the generator stay on `device`, so the draws
    do not depend on the mesh.
    """
    from . import chains as chain_io
    from ..parallel.mesh import shard_map
    from .runner import _check_device
    from .targets import (is_callable_target, make_unbounded_wrappers,
                          resolve_target)

    device = _target_device(device)
    space = ParamSpace(params_block)
    # SMC is gradient-free: 'auto' perf modes resolve to the validated
    # fast modes (config.resolve_perf_mode; explicit opts are the opt-out)
    tables_arg, loglike = resolve_target(bundle, opts_kw, fit_kw,
                                         gradient_free=True)
    _check_device(tables_arg, device, mesh)

    # load a checkpoint FIRST: its particle count overrides the n_particles
    # argument
    state = None
    if resume and checkpoint and os.path.isfile(checkpoint):
        state = load_state(checkpoint, device)
        if state['y'].shape[0] != n_particles:
            log.info('resume: checkpoint has %d particles; overriding the '
                     'n_particles=%d argument', state['y'].shape[0],
                     n_particles)
            n_particles = int(state['y'].shape[0])
        log.info('resumed SMC from %s at beta=%.4f (stage %d)',
                 checkpoint, float(state['beta']), len(state['betas']) - 1)

    # shard_map chunks the batch (in turns across a mesh's devices)
    lnprior, batched_lnlike = make_unbounded_wrappers(space, loglike)
    lnlike = shard_map(batched_lnlike, tables_arg, mesh, mesh_axis, chunk)

    t0 = time.time()
    if state is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        y = space.to_unbounded(space.sample_prior(gen, n_particles))
        lnl, aux = lnlike(y)
        lnpri = lnprior(y)
        beta = 0.0
        logz = 0.0
        var_sum = 0.0
        betas, ess_hist, acc_hist = [0.0], [], []
    else:
        y, lnl, lnpri, aux = (torch.as_tensor(state[k], device=device)
                              for k in ('y', 'lnl', 'lnpri', 'aux'))
        gen = state['generator']
        beta = float(state['beta'])
        logz = float(state['logz'])
        var_sum = float(state['var_sum'])
        betas = list(np.asarray(state['betas']))
        ess_hist = list(np.asarray(state['ess']))
        acc_hist = list(np.asarray(state['acc']))

    def _save_checkpoint():
        if not checkpoint:
            return
        # atomic write-then-rename (chains._write_npz): a kill mid-write
        # must not destroy the previous good checkpoint
        chain_io._write_npz(checkpoint, dict(
            y=chain_io._host(y), lnl=chain_io._host(lnl),
            lnpri=chain_io._host(lnpri), aux=chain_io._host(aux),
            generator=chain_io._host(gen.get_state()), beta=beta, logz=logz,
            var_sum=var_sum, betas=np.asarray(betas),
            ess=np.asarray(ess_hist), acc=np.asarray(acc_hist)))

    if beta >= 1.0 and state is not None:
        max_stages = 0       # resumed a finished run: fall through to result
    for _ in range(max_stages):
        lnl_h = lnl.detach().cpu().numpy().astype(np.float64)
        finite = np.isfinite(lnl_h)
        lnl_h = np.where(finite, lnl_h, -1e30)   # prior draws with L=0
        dbeta = _choose_dbeta(lnl_h, beta, ess_target)
        beta_new = min(beta + dbeta, 1.0)

        lnw = dbeta * lnl_h
        m = lnw.max()
        w = np.exp(lnw - m)
        logz += m + np.log(w.mean())
        w_norm = w / w.sum()
        ess = 1.0 / (n_particles * float((w_norm ** 2).sum()))
        var_sum += max(1.0 / ess - 1.0, 0.0) / n_particles
        ess_hist.append(ess)

        noise = draw_stage_noise(gen, n_particles, space.ndim, n_moves,
                                 y.dtype)
        y, lnl, lnpri, aux, acc = _stage(
            lnlike, lnprior, y, lnl, lnpri, aux,
            torch.as_tensor(w_norm, dtype=y.dtype, device=device), beta_new,
            noise)
        acc_hist.append(float(acc))
        betas.append(beta_new)
        beta = beta_new
        _save_checkpoint()
        log.info('SMC stage %d: beta=%.4f ESS/N=%.2f acc=%.2f logZ=%.3f',
                 len(betas) - 1, beta, ess, float(acc), logz)
        if beta >= 1.0:
            break
    if beta < 1.0:
        raise RuntimeError(f'SMC did not reach beta=1 in {max_stages} stages '
                           '(state saved to the checkpoint if one was given; '
                           'resume=True continues exactly)')

    theta = space.to_bounded(y).detach().cpu().numpy().astype(np.float64)
    lnl_h = lnl.detach().cpu().numpy().astype(np.float64)
    lnp = lnl_h + space.log_prior(torch.as_tensor(theta)).numpy()
    se_clt = float(np.sqrt(var_sum))
    result = SMCResult(
        space=space, particles=theta, log_prob=lnp,
        aux=aux.detach().cpu().numpy().astype(np.float64),
        logz=float(logz), logz_se=LOGZ_SE_INFLATION * se_clt,
        logz_se_clt=se_clt,
        betas=np.asarray(betas), ess=np.asarray(ess_hist),
        acceptance=np.asarray(acc_hist), elapsed_s=time.time() - t0)
    log.info('SMC done: %d stages, logZ = %.3f +/- %.3f '
             '(CLT se %.3f x %.0f correlation inflation; %.1f s)',
             len(betas) - 1, result.logz, result.logz_se, se_clt,
             LOGZ_SE_INFLATION, result.elapsed_s)
    if output:
        if aux_names is None:
            # the default aux for CCF bundle targets is the chi2 derived
            # column; callable targets return an arbitrary aux statistic and
            # must not inherit that label
            aux_names = ['aux_0'] if is_callable_target(bundle) \
                else ['chi2_ccf_correct']
        chain_io.export_getdist(output, space, theta[:, None, :],
                                lnp[:, None], result.aux[:, None, :],
                                aux_names=aux_names, burn_in=0,
                                n_chain_files=1)
        log.info('posterior particles written to %s.*', output)
    return result

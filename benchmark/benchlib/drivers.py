"""The samplers a traffic mix drives: set-up, the measured window, and the
comparison of what the window produced with the plain reference.

A traffic file names its sampler (`sampler: smc` or `sampler: hmc`) and
its parameters; `DRIVERS` maps the name to the class that drives it.
Everything the window records for the check stays on the device or in a
scratch directory until the window has closed.

SMC: `run_smc` is called once per stage (max_stages=1, with a checkpoint
under the scratch directory and resume=True), so the window can end at a
stage boundary; a resumed run is bit-identical to an uninterrupted one.
Each stage's checkpoint is kept. The check replays stages drawn from the
seed with the reference's SMC stage from the preceding checkpoint (its
particles, temperature and generator state) and compares the particles'
positions, then evaluates the reference at the program's particles and
compares their log-likelihoods.

HMC: `hmc.run_segment` one step at a time on the posterior that
`run_hmc_mcmc(algorithm='hmc')` builds (`resolve_target`,
`unbounded_logpost`, `shard_map`). The state and the generator's state
before each step are kept. The check evaluates the reference's log
posterior and gradient at the chains' positions before a step drawn from
the seed, and replays that step with the reference's leapfrog.
"""

from __future__ import annotations

import math
import shutil
import statistics
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

import reference
from reference import samplers as ref_samplers

#: a replayed position counts as moved apart when it differs from the
#: program's by more than this, relative to max(1, |y|): under float32's
#: rounding of a position (~6e-8), and over the gap that two float64
#: evaluations of the model leave after an HMC trajectory in most chains
#: (PERF.md section 4)
POSITION_TOL = 1e-8


def run_seeds(seed: int, n: int) -> List[int]:
    """n seeds for the window's runs and chains, derived from --seed."""
    seq = np.random.SeedSequence(seed % 2 ** 64)
    return [int(s) for s in seq.generate_state(n, np.uint64)]


def cards(chips: int, device: torch.device) -> List[torch.device]:
    if device.type != 'cuda':
        return [device] * chips
    return [torch.device('cuda', i) for i in range(chips)]


def synchronize(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == 'cuda':
            torch.cuda.synchronize(d)


def program_bundle(config: Dict, device, dtype=torch.float64):
    from victor_tpu_torch.io.tables import build_tables
    return build_tables(config['model'], config['data'],
                        n_mu=int(config['n_mu']), n_v=int(config['n_v']),
                        device=device, dtype=dtype)


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, with a value finite on one side only counted as inf and
    -inf on both sides as equal."""
    a, b = a.double().cpu(), b.double().cpu()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        return math.inf
    return float((a[fa] - b[fb]).abs().max()) if bool(fa.any()) else 0.0


def position_gaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row of a and b (N, d): the largest |a - b| relative to
    max(1, |b|), a non-finite difference as inf."""
    a, b = a.double().cpu(), b.double().cpu()
    gap = ((a - b).abs() / torch.clamp(b.abs(), min=1.0)).amax(dim=1)
    return torch.nan_to_num(gap, nan=math.inf)


def _moved_apart(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of rows of a and b (N, d) whose positions differ by more
    than POSITION_TOL relative to max(1, |b|)."""
    return float((~(position_gaps(a, b) <= POSITION_TOL)).double().mean())


class SMC:
    """Back-to-back tempered SMC runs, one `run_smc` call per stage."""

    def __init__(self, cell, seed: int, device: torch.device, scratch: Path,
                 bundle=None):
        self.cell, self.device, self.bundle = cell, device, bundle
        self.t = cell.traffic
        self.scratch = scratch
        self.seeds = run_seeds(seed, 4096)
        self.devices = cards(cell.chips, device)
        self.stages: List[Dict] = []

    def setup(self) -> None:
        from victor_tpu_torch.parallel import make_mesh
        if self.bundle is None:
            self.bundle = program_bundle(self.cell.config, self.device)
        self.mesh = None
        if self.cell.chips > 1:
            self.mesh = make_mesh((self.t.get('mesh_axis', 'particles'),),
                                  devices=self.devices)
        # warm-up: one stage of a run at the window's sizes, one move
        self._call(self.seeds[0], self.scratch / 'warm.npz', n_moves=1)
        synchronize(self.devices)

    def _call(self, seed: int, ckpt: Path, n_moves: int) -> bool:
        """One stage (and, for a new run, its initial evaluation); whether
        the run reached beta = 1."""
        from victor_tpu_torch.sampling.smc import run_smc
        try:
            run_smc(self.bundle, self.cell.config['params'],
                    n_particles=int(self.t['n_particles']),
                    ess_target=float(self.t['ess_target']), n_moves=n_moves,
                    seed=seed, opts_kw=self.cell.config['modes']['smc'],
                    chunk=int(self.t['chunk']), max_stages=1,
                    checkpoint=str(ckpt), resume=True, mesh=self.mesh,
                    device=self.device)
        except RuntimeError as e:
            if 'did not reach beta=1' not in str(e):
                raise
            return False
        return True

    def window(self, seconds: float, min_stages: int = 2) -> Dict:
        n, moves = int(self.t['n_particles']), int(self.t['n_moves'])
        ckpt = self.scratch / 'state.npz'
        run, evals = 1, 0
        t0 = time.perf_counter()
        while True:
            fresh = not ckpt.exists()
            done = self._call(self.seeds[run], ckpt, moves)
            evals += n * moves + (n if fresh else 0)
            kept = self.scratch / f'stage_{len(self.stages):05d}.npz'
            shutil.copyfile(ckpt, kept)
            self.stages.append({'file': kept, 'fresh': fresh})
            if done:
                ckpt.unlink()
                run += 1
            if time.perf_counter() - t0 >= seconds and \
                    len(self.stages) >= min_stages:
                break
        synchronize(self.devices)
        return {'units': evals, 'seconds': time.perf_counter() - t0,
                'evals': evals, 'grad_evals': 0}

    def free(self) -> None:
        del self.bundle, self.mesh

    def check(self, ref, cand=None) -> Dict[str, float]:
        """The compared numbers of stages drawn from the seed, each replayed
        from the checkpoint before it. With `cand` (the reference in
        a lower precision) the candidate is that reference, replayed and
        evaluated in the program's place: the control."""
        cfg = self.cell.config
        space = reference.UniformSpace(cfg['params'])
        eligible = [i for i, s in enumerate(self.stages) if not s['fresh']]
        rng = np.random.default_rng(self.seeds[-1])
        picks = rng.choice(eligible, size=min(len(eligible),
                                              int(self.t['check_stages'])),
                           replace=False)
        dev = torch.device(self.device)

        def stage_of(model, state):
            return ref_samplers.smc_stage(
                lambda y: reference.loglike_y(model, cfg, 'smc', space, y),
                space.log_prior_y, state, int(self.t['n_moves']),
                float(self.t['ess_target']), dev, model.dtype)

        lnl_gap, moved = 0.0, 0.0
        for i in sorted(int(p) for p in picks):
            with np.load(self.stages[i - 1]['file']) as z:
                prev = {k: z[k] for k in z.files}
            with np.load(self.stages[i]['file']) as z:
                cur = {k: z[k] for k in z.files}
            replay = stage_of(ref, prev)
            if cand is None:
                y = torch.as_tensor(cur['y'], device=dev)
                lnl = torch.as_tensor(cur['lnl'])
            else:
                y = stage_of(cand, prev)['y']
                lnl, _ = reference.loglike_y(cand, cfg, 'smc', space, y)
            moved = max(moved, _moved_apart(y, replay['y']))
            lnl_ref, _ = reference.loglike_y(ref, cfg, 'smc', space,
                                             y.to(dev, torch.float64))
            lnl_gap = max(lnl_gap, _gap(lnl, lnl_ref))
        self.checked = len(picks) * int(self.t['n_particles'])
        return {'lnl_gap': lnl_gap, 'moved_apart': moved}


class HMC:
    """Many-chain HMC, one step per `run_segment` call."""

    def __init__(self, cell, seed: int, device: torch.device, scratch: Path,
                 bundle=None):
        self.cell, self.device, self.bundle = cell, device, bundle
        self.t = cell.traffic
        self.seeds = run_seeds(seed, 2)
        self.devices = cards(cell.chips, device)
        self.rows = 0
        self.steps: List = []

    def _posterior(self):
        from victor_tpu_torch.parallel.mesh import shard_map
        from victor_tpu_torch.sampling.priors import ParamSpace
        from victor_tpu_torch.sampling.runner import unbounded_logpost
        from victor_tpu_torch.sampling.targets import resolve_target
        self.space = ParamSpace(self.cell.config['params'])
        tables_arg, loglike = resolve_target(
            self.bundle, self.cell.config['modes']['hmc'], None,
            gradient_free=False)
        logpost = shard_map(
            lambda tbl, y: unbounded_logpost(self.space, loglike, tbl)(y),
            tables_arg, None, None)

        def counted(y):
            self.rows += y.shape[0]
            return logpost(y)
        return counted

    def _segment(self, state, i: int):
        from victor_tpu_torch.sampling import hmc
        return hmc.run_segment(
            self.logpost, state, i, 1, n_warmup=int(self.t['n_warmup']),
            n_leapfrog=int(self.t['n_leapfrog']), eps0=float(self.t['eps0']),
            target_accept=float(self.t['target_accept']))[0]

    def setup(self) -> None:
        from victor_tpu_torch.sampling import hmc
        if self.bundle is None:
            self.bundle = program_bundle(self.cell.config, self.device)
        self.logpost = self._posterior()
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seeds[0])
        y0 = self.space.to_unbounded(
            self.space.sample_ref(self.gen, int(self.t['n_chains'])))
        state = hmc.init_chains(self.logpost, y0, self.gen,
                                eps0=float(self.t['eps0']))
        # warm-up: step 0, at the window's sizes
        self.state = self._segment(state, 0)
        synchronize(self.devices)

    def window(self, seconds: float) -> Dict:
        self.rows, i = 0, 1
        t0 = time.perf_counter()
        while True:
            self.steps.append((i, self.state, self.gen.get_state()))
            self.state = self._segment(self.state, i)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        synchronize(self.devices)
        self.steps.append((i, self.state, None))
        draws = int(self.t['n_chains']) * (len(self.steps) - 1)
        return {'units': draws, 'seconds': time.perf_counter() - t0,
                'evals': self.rows, 'grad_evals': self.rows}

    def free(self) -> None:
        del self.bundle, self.logpost

    def check(self, ref, cand=None) -> Dict[str, float]:
        """The compared numbers at steps drawn from the seed: the log
        posterior and gradient before the step, and the positions after
        it, replayed. With `cand` the candidate is the reference in
        that lower precision, in the program's place: the control."""
        cfg = self.cell.config
        space = reference.UniformSpace(cfg['params'])
        n_warmup = int(self.t['n_warmup'])
        # steps at which the staged warm-up resets the state first are not
        # a function of the recorded state alone
        resets = {n_warmup // 3, 2 * (n_warmup // 3), n_warmup}
        eligible = [k for k in range(len(self.steps) - 1)
                    if self.steps[k][0] not in resets]
        rng = np.random.default_rng(self.seeds[1])
        picks = rng.choice(eligible, size=min(len(eligible),
                                              int(self.t['check_steps'])),
                           replace=False)

        def value_grad_of(model):
            def vg(y):
                lnp, _, g = reference.logpost_and_grad(model, cfg, 'hmc',
                                                       space, y)
                return lnp, g
            return vg

        lnp_gap = grad_gap = moved = 0.0
        self.position_gaps = []
        for k in sorted(int(p) for p in picks):
            _, pre, gen_state = self.steps[k]
            post = self.steps[k + 1][1]
            q = pre.q.detach()
            lnp_r, _, g_r = reference.logpost_and_grad(ref, cfg, 'hmc',
                                                       space, q)
            step_ref = ref_samplers.hmc_step(
                value_grad_of(ref), q, lnp_r, g_r, pre.log_eps,
                pre.chol_cov, gen_state, int(self.t['n_leapfrog']))
            if cand is None:
                lnp, g, q_after = pre.lnp, pre.grad, post.q
            else:
                lnp, _, g = reference.logpost_and_grad(
                    cand, cfg, 'hmc', space, q.float())
                q_after = ref_samplers.hmc_step(
                    value_grad_of(cand), q.float(), lnp, g,
                    pre.log_eps.float(), pre.chol_cov.float(), gen_state,
                    int(self.t['n_leapfrog']))
            lnp_gap = max(lnp_gap, _gap(lnp, lnp_r))
            grad_gap = max(grad_gap, _grad_gap(g, g_r))
            self.position_gaps.append(position_gaps(q_after, step_ref))
            moved = max(moved, _moved_apart(q_after, step_ref))
        self.checked = len(picks) * int(self.t['n_chains'])
        return {'lnp_gap': lnp_gap, 'grad_gap': grad_gap,
                'moved_apart': moved}


def _grad_gap(g: torch.Tensor, g_ref: torch.Tensor) -> float:
    """The worst chain's max |g - g_ref| over its finite components,
    relative to the larger of that chain's max |g_ref| and the median
    chain's; inf where a component is finite on one side only. A chain
    that is not finite on both sides hides nothing of the others."""
    g, g_ref = g.double().cpu(), g_ref.double().cpu()
    fin = torch.isfinite(g_ref)
    if not torch.equal(torch.isfinite(g), fin):
        return math.inf
    rows = fin.any(dim=1)
    if not bool(rows.any()):
        return 0.0
    zero = torch.zeros((), dtype=g.dtype)
    gap = torch.where(fin, g - g_ref, zero).abs().amax(dim=1)[rows]
    scale = torch.where(fin, g_ref, zero).abs().amax(dim=1)[rows]
    scale = torch.clamp(scale, min=statistics.median(scale.tolist()))
    return float((gap / scale).max())


DRIVERS = {'smc': SMC, 'hmc': HMC}


def driver(cell, seed: int, device, scratch: Path, bundle=None):
    """The cell's sampler driver; `bundle`, the program's tables when one
    process runs many seeds (control.py), or None to build them in set-up."""
    return DRIVERS[cell.traffic['sampler']](cell, seed, torch.device(device),
                                            scratch, bundle)

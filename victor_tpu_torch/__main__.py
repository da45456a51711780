"""Command-line entry: the `cobaya-run` equivalent on one CUDA card.

    python -m victor_tpu_torch run <config.yaml>      # sample the posterior
    python -m victor_tpu_torch eval <config.yaml>     # one likelihood evaluation
    python -m victor_tpu_torch fit <config.yaml>      # MAP + Laplace errors
    python -m victor_tpu_torch scan <config.yaml> --param fsigma8
    python -m victor_tpu_torch analyze <config.yaml>  # MAP + SMC report, figures
    python -m victor_tpu_torch post <config.yaml> --chains <root> --set ...
    python -m victor_tpu_torch tension <a.yaml> <b.yaml>   # ln R + parameter shift
    python -m victor_tpu_torch compare <a.yaml> <b.yaml>   # Delta ln Z
    python -m victor_tpu_torch forecast <config.yaml> # Fisher forecast
    python -m victor_tpu_torch bench <config.yaml>    # batched throughput

The port of `victor_tpu/__main__.py`'s commands, with their defaults and
JSON output, plus `--device` (default `cuda`; `--device cpu` runs on the
host). The YAML layout extends the reference's cobaya config:
`model:`/`data:` blocks (reference schema), a `params:` block (cobaya
vocabulary, config/boss_cobaya_config.yaml:50-97), and an optional
`sampler:` block (kind — default mh, the cobaya algorithm class — hmc,
nuts, ensemble, smc or ns; n_chains, n_samples, n_warmup, n_leapfrog,
max_depth, rhat_stop, n_particles, n_moves, ess_target, n_live, n_batch,
n_steps, dlogz, seed, output, checkpoint, covmat; cobaya's own `mcmc:`
nesting maps to mh, its `polychord:` nesting to ns and its `minimize:`
nesting to `fit`). A top-level `quantiles:` list is a multi-quantile joint
fit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# (warmup, draws, segment length) of each chain sampler when the config and
# the command line give none: MH's draws are one likelihood call each but
# mix slowly; NUTS's draw count is a cap under its default rhat_stop
_CHAIN_DEFAULTS = {'mh': (2000, 8000, 2500), 'hmc': (300, 700, 100),
                   'nuts': (300, 4000, 100)}


def _load(config_path):
    import os

    import yaml
    if not os.path.isfile(config_path):
        sys.exit(f'config file not found: {config_path}')
    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        sys.exit('config must contain model: and data: blocks')
    if 'model' not in cfg and 'likelihood' in cfg:
        # reference cobaya-run layout (config/boss_cobaya_config.yaml):
        # model/data nested under likelihood.<LikelihoodName> (possibly via
        # config_file) — accept it verbatim so existing run configs work
        for like_cfg in (cfg.get('likelihood') or {}).values():
            if not isinstance(like_cfg, dict):
                continue
            if 'config_file' in like_cfg and like_cfg['config_file']:
                with open(like_cfg['config_file']) as f:
                    inner = yaml.safe_load(f)
                # only adopt keys that are actually present
                for key in ('model', 'data'):
                    if inner.get(key) is not None:
                        cfg.setdefault(key, inner[key])
            for key in ('model', 'data'):
                if like_cfg.get(key) is not None:
                    cfg.setdefault(key, like_cfg[key])
    if 'model' not in cfg and 'quantiles' not in cfg:
        sys.exit('config must contain a model: block (or a quantiles: list '
                 'for a multi-quantile joint fit)')
    return cfg


def _build_bundle(cfg, device):
    """Single-dataset CCFModelBundle, or a JointBundle when the config has a
    top-level `quantiles:` list (likelihood/multiquantile.py)."""
    if 'quantiles' in cfg:
        from .likelihood.multiquantile import build_joint_tables
        return build_joint_tables(cfg, device=device)
    from .io import build_tables
    return build_tables(cfg['model'], cfg.get('data'), device=device)


def _has_data(cfg):
    return 'data' in cfg or 'quantiles' in cfg


def _divisible_mesh(axis_name, count, device='cuda'):
    """A one-axis mesh over every CUDA device when there is more than one
    and `count` shards evenly over them; None otherwise, and the run stays
    on `device` alone (one card, the CPU, or a count that does not divide:
    the sampler's state always lives on `device`, and the mesh shards only
    its likelihood).

    Only the particle paths (smc, ns, analyze, tension, compare) ask for
    one. The chain samplers (hmc, nuts, mh, the ensemble) stay on one card:
    their step is host-bound, and a 60-step `run --sampler hmc` over four
    H100s took 3.5 times as long as on one; `mesh=` stays open to callers
    of run_hmc_mcmc and run_mcmc."""
    import torch

    from .parallel import make_mesh
    n_dev = torch.cuda.device_count()
    if torch.device(device).type == 'cuda' and n_dev > 1 \
            and count % n_dev == 0:
        return make_mesh((axis_name,))
    return None


def _checkpoint_count(ckpt, key, count):
    """The sample count a resumed run takes from its checkpoint (the rows of
    `key`), or `count`: a mesh must be sized for the count that runs."""
    import os

    import numpy as np
    if ckpt and os.path.isfile(ckpt):
        with np.load(ckpt, allow_pickle=False) as z:
            if key in z.files:
                return int(z[key].shape[0])
    return count


def _json_sanitize(obj):
    """Map non-finite floats to None: json.dumps emits bare NaN/Infinity
    (invalid strict JSON) for e.g. the undefined R-hat of a 2-draw run."""
    import math
    if isinstance(obj, dict):
        return {k: _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sanitize(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _apply_set(cfg, assignments):
    """Apply --set dotted.key=value overrides (YAML-parsed values) to a
    deep copy of the config dict. List nodes (e.g. a joint `quantiles:`
    block) are traversed by integer index: `quantiles.0.model.opt=1`."""
    import copy

    import yaml

    def _warn_new(path_so_far, kv):
        # auto-vivification is deliberate (new nested options can be set),
        # but a typo'd key would otherwise silently no-op the override
        print(f"--set '{kv}': note — '{path_so_far}' does not exist in the "
              'config and was created (check for a typo if an existing '
              'option was intended)', file=sys.stderr)

    def _index(node, k, kv):
        try:
            i = int(k)
        except ValueError:
            sys.exit(f"bad --set '{kv}': '{k}' must be an integer index "
                     f'into a list of {len(node)}')
        if not -len(node) <= i < len(node):
            sys.exit(f"bad --set '{kv}': index {i} out of range for a "
                     f'list of {len(node)}')
        return i

    cfg = copy.deepcopy(cfg)
    for kv in assignments or []:
        if '=' not in kv:
            sys.exit(f"bad --set '{kv}': expected dotted.key=value")
        path, val = kv.split('=', 1)
        keys = path.split('.')
        node = cfg
        for depth, k in enumerate(keys[:-1]):
            if isinstance(node, list):
                node = node[_index(node, k, kv)]
            elif isinstance(node, dict):
                if k not in node:
                    _warn_new('.'.join(keys[:depth + 1]), kv)
                    node[k] = {}
                elif not isinstance(node[k], (dict, list)):
                    # an existing scalar is never silently clobbered by a
                    # dict — that masks a typo'd path
                    sys.exit(f"bad --set '{kv}': '{k}' traverses a scalar "
                             'value')
                node = node[k]
            else:
                sys.exit(f"bad --set '{kv}': '{k}' traverses a scalar "
                         'value')
        if isinstance(node, list):
            node[_index(node, keys[-1], kv)] = yaml.safe_load(val)
        elif isinstance(node, dict):
            if keys[-1] not in node:
                _warn_new(path, kv)
            node[keys[-1]] = yaml.safe_load(val)
        else:
            sys.exit(f"bad --set '{kv}': '{keys[-1]}' traverses a scalar "
                     'value')
    return cfg


def cmd_run(args):
    import copy
    import os

    import numpy as np

    from .sampling import run_hmc_mcmc, run_mcmc

    cfg = _apply_set(_load(args.config), args.set)
    if not _has_data(cfg):
        sys.exit('run requires a data: block (data vector + covariance)')
    params_block = cfg.get('params')
    if not params_block:
        sys.exit('config must contain a params: block to sample')
    # snapshot before the sampler-block merges below mutate cfg in place:
    # <root>.input.yaml records what the user actually ran (cobaya's file)
    raw_cfg = copy.deepcopy(cfg)
    sampler = cfg.get('sampler', {}) or {}
    # precedence: explicit --seed > config sampler.seed > 0
    seed = args.seed if args.seed is not None else int(sampler.get('seed', 0))
    if isinstance(sampler.get('mcmc'), dict):    # cobaya-style nesting
        # cobaya's `mcmc` IS adaptive random-walk Metropolis, so the nesting
        # defaults kind to 'mh', its per-param `proposal:` widths seed the
        # proposal and its `covmat:` file (if any) is honored as in cobaya
        mc = sampler.pop('mcmc')
        sampler.setdefault('kind', 'mh')
        if 'max_samples' in mc:
            # cobaya's draw cap: mh reads n_samples (rhat_stop turns it into
            # a cap), the ensemble path reads max_steps — set both so the
            # cap survives a kind:/--sampler override
            sampler.setdefault('n_samples', mc['max_samples'])
            sampler.setdefault('max_steps', mc['max_samples'])
        sampler.setdefault('rhat_stop', mc.get('Rminus1_stop', 0.01))
        cm = mc.get('covmat')
        if cm and cm != 'auto':
            sampler.setdefault('covmat', cm)
    out_root = sampler.get('output', cfg.get('output', args.output))
    if out_root:
        # cobaya writes <root>.input.yaml next to the chains; keep that
        # reproducibility artifact (the config as given, incl. any --set
        # overrides, before the sampler-block normalisation above)
        import yaml
        parent = os.path.dirname(os.path.abspath(out_root))
        os.makedirs(parent, exist_ok=True)
        with open(out_root + '.input.yaml', 'w') as f:
            yaml.safe_dump(raw_cfg, f, sort_keys=False)
    if 'minimize' in sampler and args.sampler is None:
        # cobaya's `minimize` sampler is its MAP finder: a run config asking
        # for it dispatches to `fit` (multi-start Adam + Newton with Laplace
        # errors — sampling/optimize.find_map). An explicit --sampler flag
        # wins (same precedence as over kind:). An output root plumbs
        # through as the default covmat destination
        mn = sampler.pop('minimize')
        mn = mn if isinstance(mn, dict) else {}
        covmat_out = mn.get('covmat_out') or (
            out_root + '.covmat' if out_root else None)
        return cmd_fit(argparse.Namespace(
            config=args.config, set=args.set,
            starts=int(mn.get('n_starts', 32)),
            adam_steps=int(mn.get('adam_steps', 250)),
            seed=seed, covmat_out=covmat_out, bootstrap=0,
            device=args.device))
    if isinstance(sampler.get('polychord'), dict):
        # cobaya's PolyChord wrapper is its nested sampler: map the nesting
        # to `--sampler ns` (sampling/nested.py) with its vocabulary —
        # nlive -> n_live, precision_criterion -> dlogz (evidence
        # termination), num_repeats -> n_steps (chain steps per replacement)
        pc = sampler.pop('polychord')
        sampler.setdefault('kind', 'ns')
        for src, dst in (('nlive', 'n_live'), ('precision_criterion', 'dlogz'),
                         ('num_repeats', 'n_steps')):
            if src in pc:
                sampler.setdefault(dst, pc[src])
    # default sampler: adaptive random-walk Metropolis — the reference's own
    # algorithm class (cobaya mcmc, config/boss_cobaya_config.yaml:44)
    kind = args.sampler or sampler.get('kind')
    if kind is None:
        kind = 'mh'
        # an old config whose sampler block carries only ensemble tuning
        # and no kind: would silently dispatch MH, ignoring those keys
        ensemble_only = [k for k in ('n_walkers', 'max_steps', 'check_every')
                         if k in sampler]
        if ensemble_only:
            import logging
            logging.getLogger('victor_tpu_torch.cli').warning(
                'no sampler kind given: defaulting to mh (the calibrated '
                'random-walk Metropolis), but the sampler block carries '
                'ensemble-only keys (%s) that mh ignores — set '
                "sampler.kind: ensemble (or --sampler ensemble) to keep "
                'the old ensemble behavior, or retune with mh keys '
                '(n_chains/n_samples/n_warmup)', ', '.join(ensemble_only))
    bundle = _build_bundle(cfg, args.device)
    ckpt = sampler.get('checkpoint', args.checkpoint)

    if kind == 'smc':
        from .sampling import run_smc
        n_particles = int(sampler.get('n_particles', args.particles))
        if args.resume:
            # run_smc takes the checkpoint's particle count; the mesh must
            # be sized for THAT count
            n_particles = _checkpoint_count(ckpt, 'y', n_particles)
        result = run_smc(
            bundle, params_block,
            n_particles=n_particles,
            n_moves=int(sampler.get('n_moves', args.moves)),
            ess_target=float(sampler.get('ess_target', 0.5)),
            seed=seed, checkpoint=ckpt, resume=args.resume, output=out_root,
            mesh=_divisible_mesh('particles', n_particles, args.device),
            device=args.device)
        out = {'sampler': 'smc', 'n_particles': len(result.particles),
               'n_stages': len(result.betas) - 1,
               'log_evidence': round(result.logz, 3),
               # correlation-inflated se (covers the measured
               # seed-to-seed scatter); raw CLT se for reference
               'log_evidence_se': round(result.logz_se, 3),
               'log_evidence_se_clt': round(result.logz_se_clt, 3),
               'elapsed_s': round(result.elapsed_s, 2),
               'summary': result.summary()}
        _add_ppp(out, bundle, result)
        print(json.dumps(_json_sanitize(out), indent=2))
        return
    if kind == 'ns':
        from .sampling import run_nested
        n_batch = sampler.get('n_batch', args.ns_batch)
        n_live = int(sampler.get('n_live', args.live))
        if args.resume:
            # run_nested resumes the checkpoint's live-point count; the mesh
            # must be sized for THAT count (as on the smc path)
            n_live = _checkpoint_count(ckpt, 'y', n_live)
        result = run_nested(
            bundle, params_block,
            n_live=n_live,
            n_batch=None if n_batch is None else int(n_batch),
            n_steps=int(sampler.get('n_steps', args.ns_steps)),
            dlogz=float(sampler.get('dlogz', args.dlogz)),
            seed=seed, checkpoint=ckpt, resume=args.resume, output=out_root,
            mesh=_divisible_mesh('live', n_live, args.device),
            device=args.device)
        out = {'sampler': 'ns', 'n_live': result.n_live,
               'n_iterations': result.n_iter,
               'n_likelihood_evals': result.n_like,
               'log_evidence': round(result.logz, 3),
               'log_evidence_se': round(result.logz_se, 3),
               'information_nats': round(result.h, 3),
               'posterior_ess': round(result.ess, 1),
               'elapsed_s': round(result.elapsed_s, 2),
               'summary': result.summary()}
        _add_ppp(out, bundle, result)
        print(json.dumps(_json_sanitize(out), indent=2))
        return
    if kind in _CHAIN_DEFAULTS:
        n_chains = int(sampler.get('n_chains', args.chains))
        warmup, samples, segment = _CHAIN_DEFAULTS[kind]
        n_warmup = args.warmup if args.warmup is not None else \
            int(sampler.get('n_warmup', warmup))
        n_samples = args.samples if args.samples is not None else \
            int(sampler.get('n_samples', samples))
        if args.resume:
            # a resumed run keeps the checkpoint's chain count, and the
            # GetDist files are split by it
            n_chains = _checkpoint_count(ckpt, 'hmc_q', n_chains)
        result = run_hmc_mcmc(
            bundle, params_block,
            n_chains=n_chains,
            n_warmup=n_warmup,
            n_samples=n_samples,
            n_leapfrog=int(sampler.get('n_leapfrog', args.leapfrog)),
            segment_steps=int(sampler.get('segment_steps', segment)),
            seed=seed,
            algorithm=kind,
            # NUTS depth 6 by default, victor_tpu's measured speed and
            # robustness point with the dense-mass warmup; hmc and mh
            # ignore it
            max_depth=int(sampler.get(
                'max_depth', args.max_depth if args.max_depth is not None
                else (6 if kind == 'nuts' else 8))),
            covmat=sampler.get('covmat', args.covmat),
            # cobaya's Rminus1_stop semantics: n_samples becomes a cap and
            # the run stops once split-R-1 clears the threshold; NUTS stops
            # at 0.01 unless told otherwise
            rhat_stop=(float(sampler['rhat_stop'])
                       if 'rhat_stop' in sampler
                       else (0.01 if kind == 'nuts' else None)),
            output=out_root,
            checkpoint=ckpt,
            resume=args.resume,
            device=args.device)
        print(json.dumps(_json_sanitize(
            {'sampler': kind, 'n_samples': result.n_steps,
             'acceptance': round(result.acceptance, 3),
             'elapsed_s': round(result.elapsed_s, 2),
             'summary': result.summary(burn_in=0)}), indent=2))
        return
    result = run_mcmc(
        bundle, params_block,
        n_walkers=int(sampler.get('n_walkers', args.walkers)),
        max_steps=int(sampler.get('max_steps', args.max_steps)),
        rhat_stop=float(sampler.get('rhat_stop', 0.01)),
        check_every=int(sampler.get('check_every', 100)),
        seed=seed,
        move=str(sampler.get('move', 'de')),
        output=out_root,
        checkpoint=sampler.get('checkpoint', args.checkpoint),
        resume=args.resume,
        device=args.device)
    ens_rhat_stop = float(sampler.get('rhat_stop', 0.01))
    max_rm1 = (float(np.max(result.rhat - 1))
               if np.all(np.isfinite(result.rhat)) else float('inf'))
    print(json.dumps(_json_sanitize(
        {'sampler': 'ensemble',
         'n_steps': result.n_steps,
         'acceptance': round(result.acceptance, 3),
         'max_rminus1': round(max_rm1, 4) if np.isfinite(max_rm1) else None,
         'converged': bool(max_rm1 < ens_rhat_stop),
         'elapsed_s': round(result.elapsed_s, 2),
         'summary': result.summary()}), indent=2))
    if ens_rhat_stop > 0 and not max_rm1 < ens_rhat_stop:
        # an unconverged run must not exit 0 and look like a result; an
        # explicit rhat_stop <= 0 opts out (the "run exactly max_steps"
        # idiom)
        sys.exit(f'ensemble sampler did NOT converge (max R-1 = '
                 f'{max_rm1:.3g} >= {ens_rhat_stop:g} after '
                 f'{result.n_steps} steps). Raise sampler.max_steps / '
                 f'n_walkers, or use the default sampler mh.')


def _add_ppp(out, bundle, result):
    """The posterior-predictive p-value from the particles' recorded chi2
    column (sampling/gof.py), for bundle targets: a callable target's aux
    need not be a chi2."""
    if hasattr(bundle, 'fit_opts'):
        from .sampling.gof import posterior_predictive_pvalue
        out['posterior_predictive_p'] = round(posterior_predictive_pvalue(
            result.aux[:, 0], _ndata(bundle), bundle.fit_opts.form,
            bundle.fit_opts.nmocks), 4)


def _reference_point(space):
    """Fiducial point from a params block: fixed values plus each sampled
    parameter's ref location (falling back to the prior midpoint / mean)."""
    import math

    point = {k: float(v) for k, v in space.fixed.items()}
    for p in space.sampled:
        if p.ref_dist == 'norm':
            loc = p.ref_loc
        elif p.ref_dist == 'halfnorm':
            loc = p.ref_loc + p.ref_scale * math.sqrt(2.0 / math.pi)
        elif p.dist in ('uniform', 'loguniform'):
            loc = 0.5 * (p.lo + p.hi)
        elif p.dist == 'halfnorm':
            # the prior MEAN, not the support edge p.lo: a halfnorm sigma_v
            # with loc=0 would be evaluated at sigma_v=0, where the velocity
            # PDF gives lnlike=-inf
            loc = p.lo + p.hi * math.sqrt(2.0 / math.pi)
        else:
            loc = p.lo                               # norm: lo IS the mean
        point[p.name] = float(loc)
    return point


def _parse_param_overrides(pairs, space=None):
    """--param name=value pairs -> {name: float}.

    With a ParamSpace, overriding a DERIVED parameter is rejected: derived
    lambdas are recomputed from their inputs, so the override would be
    discarded. Names outside the params block are allowed (the theory layer
    takes an open parameter vocabulary) and echoed back in the output."""
    out = {}
    for kv in pairs or []:
        if '=' not in kv:
            sys.exit(f"bad --param '{kv}': expected name=value")
        k, v = kv.split('=', 1)
        if space is not None and any(d.name == k for d in space.derived):
            sys.exit(f"--param {k}: {k} is a derived parameter (value: "
                     "lambda in the params block); override its inputs "
                     "instead")
        try:
            out[k] = float(v)
        except ValueError:
            sys.exit(f"bad --param '{kv}': value must be numeric")
    return out


def cmd_eval(args):
    import torch

    from .likelihood.core import log_likelihood
    from .sampling.priors import ParamSpace

    cfg = _apply_set(_load(args.config), args.set)
    bundle = _build_bundle(cfg, args.device)
    space = ParamSpace(cfg.get('params') or {})

    def tensor(v):
        return torch.tensor([v], dtype=torch.float64, device=args.device)

    params = {k: tensor(v) for k, v in _reference_point(space).items()}
    # no `space` passed: eval honors an explicit derived-name override (the
    # derived loop below skips names already present)
    for k, v in _parse_param_overrides(args.param).items():
        params[k] = tensor(v)
    # cobaya-style derived lambdas (e.g. aperp/apar from alpha, epsilon)
    for d in space.derived:
        if d.name not in params and all(a in params for a in d.argnames):
            params[d.name] = d.fn(*[params[a] for a in d.argnames])
    t0 = time.time()
    if 'quantiles' in cfg:
        from .likelihood.multiquantile import joint_log_likelihood
        lnl, chisq = joint_log_likelihood(bundle, params)
        print(json.dumps({'log_likelihood': float(lnl[0]),
                          'chi2': float(chisq[0]),
                          'n_quantiles': len(bundle.bundles),
                          'wall_s': round(time.time() - t0, 3),
                          'params': {k: float(v[0])
                                     for k, v in params.items()}}))
        return
    if cfg.get('data'):
        lnl, chisq = log_likelihood(bundle.tables, bundle.spec,
                                    bundle.theory_opts, bundle.fit_opts,
                                    params)
        print(json.dumps({'log_likelihood': float(lnl[0]),
                          'chi2': float(chisq[0]),
                          'wall_s': round(time.time() - t0, 3),
                          'params': {k: float(v[0])
                                     for k, v in params.items()}}))
        return
    # model-only config (e.g. configs/example_model_input.yaml): no data
    # vector to fit, so evaluate the theory multipoles on the model's own r
    # grid
    from .models.ccf_theory import theory_multipoles_grid
    for k, v in (('fsigma8', 0.47), ('beta', 0.37), ('sigma_v', 380.0),
                 ('epsilon', 1.0)):
        params.setdefault(k, tensor(v))
    s = bundle.tables.r_v
    mult = theory_multipoles_grid(bundle.tables, bundle.spec,
                                  bundle.theory_opts, params, s=s)[0].cpu()
    print(json.dumps({
        'theory_multipoles': {str(ell): mult[i].numpy().round(6).tolist()
                              for i, ell in enumerate(bundle.spec.poles_s)},
        's': s.cpu().numpy().round(3).tolist(),
        'wall_s': round(time.time() - t0, 3),
        'params': {k: float(v[0]) for k, v in params.items()}}))


def _ndata(bundle):
    """Data-vector length from the tables' shapes."""
    return bundle.ndata if hasattr(bundle, 'ndata') else \
        int(bundle.tables.icov.shape[-1]) if bundle.spec.fixed_covmat else \
        int(bundle.tables.cov.shape[-1])


def _map_report_stats(bundle, mres):
    """(ndata, ndof, p_value, derived) for a MAP result. The PTE respects
    the likelihood form: Hotelling-F for the estimated-covariance forms
    (sampling/gof.py)."""
    import torch

    from .sampling.gof import chi2_tail_probability
    ndata = _ndata(bundle)
    ndof = ndata - mres.space.ndim
    p_val = chi2_tail_probability(mres.chi2, ndof, bundle.fit_opts.form,
                                  bundle.fit_opts.nmocks)
    derived = {k: float(v) for k, v in mres.space.derived_values(
        torch.as_tensor(mres.theta, dtype=torch.float64)).items()}
    return ndata, ndof, p_val, derived


def cmd_fit(args):
    from .sampling.optimize import find_map

    cfg = _apply_set(_load(args.config), args.set)
    if not _has_data(cfg):
        sys.exit('fit requires a data: block (data vector + covariance)')
    bundle = _build_bundle(cfg, args.device)
    params_block = cfg.get('params')
    if not params_block:
        sys.exit('config must contain a params: block to fit')
    t0 = time.time()
    result = find_map(bundle, params_block, n_starts=args.starts,
                      adam_steps=args.adam_steps, seed=args.seed,
                      device=args.device)
    _, ndof, p_val, derived = _map_report_stats(bundle, result)
    derived = {k: round(v, 6) for k, v in derived.items()}
    out = {
        'chi2': round(result.chi2, 4),
        # tail probability under the configured likelihood form (exact chi2
        # for gaussian; Hotelling-F finite-mock null for sellentin/hartlap/
        # percival — sampling/gof.py)
        'ndof': ndof,
        'p_value': round(p_val, 4),
        'log_likelihood': round(result.lnlike, 4),
        'log_posterior': round(result.lnpost, 4),
        'grad_norm': result.grad_norm,
        'best_fit': {k: round(v, 6) for k, v in result.params.items()},
        'std_laplace': {k: round(v, 6) for k, v in result.std.items()},
        'n_converged': result.n_converged,
        # Laplace (saddle-point) evidence from quantities the fit already
        # has (null when the Laplace covariance is not positive definite)
        'log_evidence_laplace': round(result.log_evidence_laplace, 3),
        'elapsed_s': round(time.time() - t0, 2)}
    if derived:
        out['derived'] = derived
    if args.bootstrap:
        # parametric-bootstrap debiasing + calibrated frequentist sigmas
        # (sampling/optimize.parametric_bootstrap)
        from .sampling.optimize import parametric_bootstrap
        bres = parametric_bootstrap(bundle, params_block, result,
                                    n_boot=args.bootstrap, seed=args.seed,
                                    device=args.device)
        out['bootstrap'] = {
            'n_boot': int(len(bres.theta_boot)),
            'best_fit_debiased': {k: round(v, 6)
                                  for k, v in bres.debiased.items()},
            'bias': {n: round(float(bres.bias[i]), 6)
                     for i, n in enumerate(bres.names)},
            'std_bootstrap': {k: round(v, 6) for k, v in bres.std.items()},
        }
        out['elapsed_s'] = round(time.time() - t0, 2)
    if args.covmat_out:
        # Laplace covariance in cobaya .covmat format: the fit->sample
        # workflow (seed `run --covmat <this file>`)
        from .sampling.chains import write_covmat
        write_covmat(args.covmat_out, result.space.names, result.cov)
        out['covmat_file'] = args.covmat_out
    print(json.dumps(_json_sanitize(out), indent=2))


def cmd_scan(args):
    import numpy as np

    from .sampling.optimize import profile_scan

    cfg = _apply_set(_load(args.config), args.set)
    if not _has_data(cfg):
        sys.exit('scan requires a data: block (data vector + covariance)')
    if not args.param:
        sys.exit('scan needs at least one --param to profile over')
    bundle = _build_bundle(cfg, args.device)
    params_block = cfg.get('params')
    if not params_block:
        sys.exit('config must contain a params: block')
    t0 = time.time()
    res = profile_scan(bundle, params_block, args.param, n_grid=args.ngrid,
                       n_sigma=args.nsigma, seed=args.seed,
                       device=args.device)
    out = {
        'scan': list(res.scan_names),
        'grid': np.round(res.grid, 6).tolist(),
        'chi2_profile': np.round(res.chi2, 4).tolist(),
        'delta_chi2': np.round(res.delta_chi2(), 4).tolist(),
        'best_fit': {k: round(v, 6) for k, v in res.map_result.params.items()},
        'elapsed_s': round(time.time() - t0, 2),
    }
    if len(res.scan_names) == 1:
        # one-sided limits leave a crossing at nan: map non-finite to null
        def _r(x):
            return round(x, 6) if np.isfinite(x) else None
        lo, hi = res.interval(1.0)
        out['interval_68'] = [_r(lo), _r(hi)]
        lo2, hi2 = res.interval(4.0)
        out['interval_95'] = [_r(lo2), _r(hi2)]
    print(json.dumps(out, indent=2))


def _plot_map_multipoles(cfg, bundle, mres, out_path):
    """Data-with-errors vs best-fit-model multipole panels at the MAP
    (api.CCFFit.plot_multipole_comparison per measured pole), the
    reference notebooks' model-vs-data figure, emitted by `analyze`.

    Adopts the already-built bundle (no second table ingestion) and labels
    with mres.chi2 directly (the chi2=True path would evaluate the
    likelihood again just for the legend)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    import torch

    from .api import CCFFit

    fit = CCFFit(cfg['model'], cfg['data'], _bundle=bundle)
    full = {k: float(v) for k, v in
            mres.space.full_params(torch.as_tensor(mres.theta)).items()}
    poles = fit.poles_s
    fig, axes = plt.subplots(1, len(poles), figsize=(4.8 * len(poles), 3.9),
                             squeeze=False)
    for ax, ell in zip(axes[0], poles):
        label = (f'best fit $\\chi^2={mres.chi2:.2f}$'
                 if ell == poles[0] else 'best fit')
        fit.plot_multipole_comparison({**full, 'label': label},
                                      ell=ell, ax=ax)
        ax.set_title(rf'$\ell = {ell}$')
        ax.legend(fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def cmd_analyze(args):
    """One-command full analysis: MAP + Laplace errors, then a tempered-SMC
    posterior (GetDist chains + log-evidence), written up as a report.

    The report quotes central 68% credible intervals as the headline
    numbers — the interval type whose coverage is measured to be nominal
    for every parameter including beta (tools/coverage_test.py --method
    smc/sbc; BASELINE.md round 3) — alongside the MAP and Laplace sigmas.
    """
    import os

    import numpy as np

    from .sampling import run_smc
    from .sampling.optimize import find_map

    cfg = _apply_set(_load(args.config), args.set)
    if not _has_data(cfg):
        sys.exit('analyze requires a data: block (data vector + covariance)')
    params_block = cfg.get('params')
    if not params_block:
        sys.exit('config must contain a params: block')
    bundle = _build_bundle(cfg, args.device)

    outdir = args.output or (
        os.path.splitext(os.path.basename(args.config))[0] + '_analysis')
    os.makedirs(outdir, exist_ok=True)
    # reproducibility snapshot: the config as analyzed (incl. --set
    # overrides) next to the report — cobaya's <root>.input.yaml role
    import yaml
    with open(os.path.join(outdir, 'input.yaml'), 'w') as f:
        yaml.safe_dump(cfg, f, sort_keys=False)

    t0 = time.time()
    mres = find_map(bundle, params_block, n_starts=args.starts,
                    adam_steps=args.adam_steps, seed=args.seed,
                    device=args.device)
    t_map = time.time() - t0

    t0 = time.time()
    sres = run_smc(bundle, params_block, n_particles=args.particles,
                   n_moves=args.moves, seed=args.seed,
                   output=os.path.join(outdir, 'chains'),
                   mesh=_divisible_mesh('particles', args.particles,
                                        args.device),
                   device=args.device)
    t_smc = time.time() - t0

    ndata, ndof, p_val, derived = _map_report_stats(bundle, mres)

    # Bayesian model adequacy from the SMC particles' recorded chi2 column
    # (sampling/gof.py; analytic replicated-T tail, no extra device work)
    from .sampling.gof import posterior_predictive_pvalue
    ppp = posterior_predictive_pvalue(sres.aux[:, 0], ndata,
                                      bundle.fit_opts.form,
                                      bundle.fit_opts.nmocks)

    names = [p.name for p in sres.space.sampled]
    part = sres.particles
    lo68, med, hi68 = np.quantile(part, [0.1585, 0.5, 0.8415], axis=0)
    mean, std = part.mean(axis=0), part.std(axis=0)

    figures = []
    if not args.no_plots:
        from .plottools import corner_plot
        corner_plot(part, names, os.path.join(outdir, 'corner.png'))
        figures.append(('corner.png',
                        'posterior corner plot (68/95% contours)'))
        if 'quantiles' not in cfg:
            # data-vs-MAP multipoles need the single-dataset CCFFit surface
            _plot_map_multipoles(cfg, bundle, mres,
                                 os.path.join(outdir, 'multipoles.png'))
            figures.append(('multipoles.png',
                            'data vs best-fit model multipoles'))

    lines = [
        f'# victor_tpu_torch analysis: {os.path.basename(args.config)}',
        '',
        f'Generated by `python -m victor_tpu_torch analyze` on '
        f'{time.strftime("%Y-%m-%d %H:%M:%S")}.',
        '',
        '## Best fit',
        '',
        f'- chi2 = {mres.chi2:.4f} with ndof = {ndof} '
        f'(p = {p_val:.4f}); |grad| = {mres.grad_norm:.2e}; '
        f'{mres.n_converged}/{mres.n_starts} starts converged '
        f'({t_map:.1f} s)',
        '',
        '## Goodness of fit',
        '',
        f'- best-fit tail probability p = {p_val:.4f} '
        f'(chi2 {mres.chi2:.2f} / ndof {ndof}, '
        f'{bundle.fit_opts.form} form)',
        f'- posterior-predictive p = {ppp:.4f} '
        '(Gelman-Meng-Stern; near 0 = model cannot reproduce the data, '
        'near 1 = overdispersed/overestimated covariance)',
        '',
        '## Posterior (tempered SMC, '
        f'{len(part)} particles, {len(sres.betas) - 1} stages, '
        f'{t_smc:.1f} s)',
        '',
        f'log-evidence: **log Z = {sres.logz:.3f} +/- {sres.logz_se:.3f}** '
        '(se covers the measured seed-to-seed scatter; CLT se '
        f'{sres.logz_se_clt:.3f}; Laplace cross-check at the MAP: '
        f'{mres.log_evidence_laplace:.3f})',
        '',
        '| parameter | MAP | sigma(Laplace) | posterior mean +/- std '
        '| median | central 68% |',
        '|---|---|---|---|---|---|',
    ]
    for i, n in enumerate(names):
        lines.append(
            f'| {n} | {mres.params[n]:.6g} | {mres.std[n]:.3g} '
            f'| {mean[i]:.6g} +/- {std[i]:.3g} | {med[i]:.6g} '
            f'| [{lo68[i]:.6g}, {hi68[i]:.6g}] |')
    if derived:
        lines += ['', '## Derived parameters (at the MAP)', '']
        lines += [f'- {k} = {v:.6g}' for k, v in derived.items()]
    if figures:
        lines += ['', '## Figures', '']
        lines += [f'![{caption}]({fname})' for fname, caption in figures]
    lines += [
        '',
        '## Notes',
        '',
        '- Quote the central 68% credible intervals: their coverage is '
        'measured nominal for every parameter, including beta, whose '
        'grid-scale likelihood structure breaks the quadratic Laplace '
        'sigma (BASELINE.md round 3, tools/coverage_test.py --method '
        'smc/sbc).',
        f'- GetDist chains: {outdir}/chains.*.txt '
        f'(quick look: python tools/plot_chains.py {outdir}/chains)',
    ]
    report = os.path.join(outdir, 'report.md')
    with open(report, 'w') as f:
        f.write('\n'.join(lines) + '\n')

    print(json.dumps(_json_sanitize({
        'report': report,
        'figures': [os.path.join(outdir, f) for f, _ in figures],
        'chi2': round(mres.chi2, 4), 'ndof': ndof, 'p_value': round(p_val, 4),
        'posterior_predictive_p': round(ppp, 4),
        'log_evidence': round(sres.logz, 3),
        'log_evidence_se': round(sres.logz_se, 3),
        'log_evidence_laplace': round(mres.log_evidence_laplace, 3),
        'posterior': {n: {'mean': round(float(mean[i]), 6),
                          'std': round(float(std[i]), 6),
                          'central_68': [round(float(lo68[i]), 6),
                                         round(float(hi68[i]), 6)]}
                      for i, n in enumerate(names)},
        'elapsed_s': {'map': round(t_map, 2), 'smc': round(t_smc, 2)},
    }), indent=2))


def cmd_post(args):
    """Importance-reweight stored chains under a modified config — the
    `cobaya post` role, at batched-likelihood throughput (sampling/post.py)."""
    import numpy as np

    from .sampling.chains import read_getdist
    from .sampling.post import _weighted_moments, reweight
    from .sampling.priors import ParamSpace

    cfg_old = _load(args.config)
    if not _has_data(cfg_old):
        sys.exit('post requires a data: block (data vector + covariance)')
    if not args.new and not args.set:
        sys.exit('post needs a modified target: --new <config.yaml> and/or '
                 '--set dotted.key=value')
    cfg_new = _apply_set(_load(args.new) if args.new else cfg_old, args.set)
    if not _has_data(cfg_new):
        sys.exit('the new config must keep a data: block')
    params_old = cfg_old.get('params')
    if not params_old:
        sys.exit('config must contain a params: block')

    space = ParamSpace(params_old)
    names, w, _mlnp, samples = read_getdist(args.chains)
    if names[:space.ndim] != space.names:
        sys.exit(f'chain parameters {names[:space.ndim]} do not match the '
                 f'config params block {space.names}')
    theta = samples[:, :space.ndim]

    t0 = time.time()
    res = reweight(_build_bundle(cfg_old, args.device),
                   _build_bundle(cfg_new, args.device),
                   params_old, theta, weights=w,
                   params_block_new=cfg_new.get('params'),
                   chunk=args.chunk, output=args.output, device=args.device)
    out = {
        'n_particles': res.n,
        'delta_logz': round(res.delta_logz, 4),
        'delta_logz_se': round(res.delta_logz_se, 4),
        'ess': round(res.ess, 1),
        'efficiency': round(res.efficiency, 4),
        'params_old': {k: {kk: round(vv, 6) for kk, vv in v.items()}
                       for k, v in _weighted_moments(theta, np.asarray(w),
                                                     space).items()},
        'params_new': {k: {kk: round(vv, 6) for kk, vv in v.items()}
                       for k, v in res.summary().items()},
        'elapsed_s': round(time.time() - t0, 2),
    }
    if args.output:
        out['output'] = args.output
    print(json.dumps(_json_sanitize(out), indent=2))


def cmd_tension(args):
    """Concordance/tension between two datasets: evidence ratio ln R (three
    tempered-SMC evidences: A, B, independent product AB at shared params)
    and the Gaussian parameter-shift n-sigma (sampling/tension.py)."""
    from .sampling.tension import run_tension

    cfg_a = _apply_set(_load(args.config), args.set)
    cfg_b = _apply_set(_load(args.config_b), args.set)
    for label, cfg in (('first', cfg_a), ('second', cfg_b)):
        if not _has_data(cfg):
            sys.exit(f'tension requires a data: block in the {label} config')
    params_block = cfg_a.get('params')
    if not params_block:
        sys.exit('the first config must contain a params: block '
                 '(the shared prior of all three evidences)')
    if cfg_b.get('params') not in (None, params_block):
        sys.exit('the two configs must share ONE params: block — the '
                 'evidence ratio is only meaningful under a common prior. '
                 'Drop params: from the second config or make them '
                 'identical.')

    res = run_tension(_build_bundle(cfg_a, args.device),
                      _build_bundle(cfg_b, args.device),
                      params_block, n_particles=args.particles,
                      n_moves=args.moves, seed=args.seed,
                      mesh=_divisible_mesh('particles', args.particles,
                                           args.device),
                      device=args.device)
    print(json.dumps(_json_sanitize({
        'log_evidence_ratio': round(res.logr, 3),
        'log_evidence_ratio_se': round(res.logr_se, 3),
        'verdict': 'concordance' if res.logr > 0 else 'tension',
        'log_evidence': {'a': round(res.logz_a, 3),
                         'b': round(res.logz_b, 3),
                         'joint': round(res.logz_ab, 3)},
        'parameter_shift': {'chi2': round(res.shift_chi2, 3),
                            'ndof': res.shift_ndof,
                            'p_value': round(res.shift_p, 5),
                            'n_sigma': round(res.shift_nsigma, 2)},
        'shared_params': res.names,
        'posterior_a': res.summary_a,
        'posterior_b': res.summary_b,
        'posterior_joint': res.summary_ab,
        'elapsed_s': round(res.elapsed_s, 2),
        'note': 'ln R is prior-volume dependent (quote the shared prior); '
                'the parameter shift assumes near-Gaussian posteriors',
    }), indent=2))


def cmd_compare(args):
    """Evidence-based model comparison on the SAME data: one tempered-SMC
    evidence per config, Delta ln Z with quadrature-summed errors and the
    Jeffreys-scale reading (the two configs should differ in the model:
    block / options; comparing different datasets is `tension`'s job).

    JSON keys the two runs 'a'/'b' (each with its config path and applied
    overrides): the headline usage passes the SAME path twice (`compare cfg
    cfg --set-b model.rsd_model=kaiser`), so path-keyed output would
    collapse the entries and 'favored' could not identify the winner."""
    import numpy as np

    from .sampling import run_smc

    results = []
    # --set applies to BOTH runs (shared analysis choices, matching
    # tension's semantics); --set-a/--set-b are per-run variants
    for i, (label, path, sets) in enumerate(
            (('a', args.config, args.set_a), ('b', args.config_b,
                                              args.set_b))):
        cfg = _apply_set(_apply_set(_load(path), args.set), sets)
        if not _has_data(cfg):
            sys.exit(f'compare requires a data: block in {path}')
        params_block = cfg.get('params')
        if not params_block:
            sys.exit(f'{path} must contain a params: block')
        res = run_smc(_build_bundle(cfg, args.device), params_block,
                      n_particles=args.particles, n_moves=args.moves,
                      seed=args.seed + i,
                      mesh=_divisible_mesh('particles', args.particles,
                                           args.device),
                      device=args.device)
        results.append((label, path, sets, res))

    (_, pa, sa, ra), (_, pb, sb, rb) = results
    dlnz = ra.logz - rb.logz
    se = float(np.sqrt(ra.logz_se ** 2 + rb.logz_se ** 2))
    a = abs(dlnz)
    scale = ('inconclusive (|Delta ln Z| < 1)' if a < 1 else
             'positive (1 <= |Delta ln Z| < 2.5)' if a < 2.5 else
             'strong (2.5 <= |Delta ln Z| < 5)' if a < 5 else
             'decisive (|Delta ln Z| >= 5)')
    print(json.dumps(_json_sanitize({
        'delta_log_evidence': round(dlnz, 3),
        'delta_log_evidence_se': round(se, 3),
        'favored': 'a' if dlnz > 0 else 'b',
        'jeffreys': scale,
        'a': {'config': pa, 'set': (args.set or []) + (sa or []),
              'log_evidence': round(ra.logz, 3), 'posterior': ra.summary()},
        'b': {'config': pb, 'set': (args.set or []) + (sb or []),
              'log_evidence': round(rb.logz, 3), 'posterior': rb.summary()},
        'elapsed_s': round(ra.elapsed_s + rb.elapsed_s, 2),
    }), indent=2))


def cmd_forecast(args):
    """Gaussian Fisher-matrix forecast of the expected parameter
    constraints at a fiducial point: sigmas and correlations from the exact
    residual Jacobian (sampling/optimize.fisher_forecast), no sampling. The
    fiducial defaults to the params block's ref locations (override with
    --param name=value)."""
    import numpy as np

    from .sampling.optimize import fisher_forecast
    from .sampling.priors import ParamSpace

    cfg = _apply_set(_load(args.config), args.set)
    if not _has_data(cfg):
        sys.exit('forecast requires a data: block (data vector + covariance)')
    params_block = cfg.get('params')
    if not params_block:
        sys.exit('config must contain a params: block')
    space = ParamSpace(params_block)
    if not space.ndim:
        sys.exit('forecast needs sampled parameters in the params: block')
    # parse/validate overrides BEFORE the expensive table build so a typo'd
    # or derived-name --param fails fast
    overrides = _parse_param_overrides(args.param, space=space)
    bundle = _build_bundle(cfg, args.device)
    fiducial = _reference_point(space)
    fiducial.update(overrides)
    t0 = time.time()
    res = fisher_forecast(bundle, fiducial, space.names,
                          derived=space.derived)
    names = list(res.names)
    corr = np.round(res.correlation, 4)
    print(json.dumps(_json_sanitize({
        'fiducial': {k: round(float(fiducial[k]), 6) for k in names},
        # every --param override echoed back, including names outside the
        # params block (where a typo'd name would otherwise vanish)
        **({'overrides': {k: round(v, 6) for k, v in overrides.items()}}
           if overrides else {}),
        'sigma_fisher': {k: round(v, 6) for k, v in res.std.items()},
        'correlation': {names[i]: {names[j]: float(corr[i, j])
                                   for j in range(len(names)) if j != i}
                        for i in range(len(names))},
        'elapsed_s': round(time.time() - t0, 2),
        'note': 'expected constraints from the local response at the '
                'fiducial (residual Jacobian + fiducial-beta precision); '
                'agrees with the Laplace errors in expectation for a '
                'Gaussian likelihood with parameter-independent covariance',
    }), indent=2))


def cmd_bench(args):
    import torch

    from .likelihood.batched import make_batched_loglike
    from .sampling.priors import ParamSpace

    cfg = _apply_set(_load(args.config), args.set)
    if not _has_data(cfg):
        sys.exit('bench requires a data: block (data vector + covariance)')
    bundle = _build_bundle(cfg, args.device)
    space = ParamSpace(cfg.get('params') or {})
    if not space.ndim:
        sys.exit('bench needs sampled parameters in the params: block')
    if 'quantiles' in cfg:
        from .likelihood.multiquantile import make_batched_joint_loglike
        batched = make_batched_joint_loglike(bundle, space.names,
                                             base_params=space.fixed,
                                             chunk=args.chunk)
    else:
        batched = make_batched_loglike(bundle, space.names,
                                       base_params=space.fixed,
                                       chunk=args.chunk)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    theta = space.sample_ref(gen, args.batch)
    # warm-up; float() of an output waits for the device, so no execution
    # tail leaks into the timed region
    float(batched(theta)[0][-1])
    t0 = time.time()
    for _ in range(args.reps):
        sink = float(batched(theta)[0][-1])
    dt = (time.time() - t0) / args.reps
    print(json.dumps({'evals_per_sec': round(args.batch / dt, 1),
                      'ms_per_batch': round(dt * 1e3, 2),
                      'batch': args.batch, 'lnlike_tail': sink}))


def _check_device(device: str) -> None:
    import torch
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'victor_tpu_torch: --device {device} asks for a CUDA card, but '
            'none is available; pass --device cpu to run on the CPU')


def main(argv=None):
    from ._version import __version__
    p = argparse.ArgumentParser(prog='victor_tpu_torch')
    p.add_argument('--version', action='version',
                   version=f'victor_tpu_torch {__version__}')
    sub = p.add_subparsers(dest='cmd', required=True)
    set_help = ('config override, e.g. --set model.rsd_model=dispersion '
                '(list nodes by index: quantiles.0...)')
    device_help = "torch device (default cuda; 'cpu' runs on the host)"

    pr = sub.add_parser('run', help='sample the posterior (cobaya-run equivalent)')
    pr.add_argument('config')
    pr.add_argument('--set', action='append', metavar='dotted.key=value',
                    help=set_help)
    pr.add_argument('--walkers', type=int, default=256)
    pr.add_argument('--max-steps', type=int, default=2000)
    pr.add_argument('--sampler',
                    choices=['ensemble', 'hmc', 'nuts', 'mh', 'smc', 'ns'],
                    default=None,
                    help='default mh (adaptive random-walk Metropolis — '
                         'the reference/cobaya algorithm class); hmc and '
                         'nuts (gradients through the likelihood); ensemble '
                         '(differential-evolution move) exits nonzero if '
                         'unconverged; smc (tempered SMC) and ns (nested '
                         'sampling) also estimate the evidence')
    pr.add_argument('--particles', type=int, default=2048,
                    help='SMC particle count (sampler=smc)')
    pr.add_argument('--moves', type=int, default=5,
                    help='SMC mutation steps per stage (sampler=smc)')
    pr.add_argument('--live', type=int, default=1024,
                    help='nested-sampling live points (sampler=ns)')
    pr.add_argument('--ns-steps', type=int, default=24,
                    help='replacement-chain Metropolis moves (sampler=ns)')
    pr.add_argument('--ns-batch', type=int, default=None,
                    help='dead points replaced per NS iteration '
                         '(default n_live // 4; sampler=ns)')
    pr.add_argument('--dlogz', type=float, default=0.01,
                    help='evidence termination tolerance (sampler=ns)')
    pr.add_argument('--max-depth', type=int, default=None,
                    help='NUTS maximum tree depth (sampler=nuts; default 6 '
                         '— the measured speed/robustness point with the '
                         'dense-mass warmup; raise for curved posteriors)')
    pr.add_argument('--chains', type=int, default=8,
                    help='chain count (sampler=mh, hmc, nuts)')
    pr.add_argument('--warmup', type=int, default=None,
                    help='warmup steps (default 300; 2000 for --sampler mh)')
    pr.add_argument('--samples', type=int, default=None,
                    help='posterior draws per chain (default 700; 8000 for '
                         '--sampler mh, 4000 for --sampler nuts; a cap '
                         'under rhat_stop)')
    pr.add_argument('--leapfrog', type=int, default=16,
                    help='HMC trajectory length, jittered per step over '
                         '[n/2, n] (sampler=hmc)')
    pr.add_argument('--covmat', default=None,
                    help='cobaya-format .covmat file seeding the proposal '
                         'covariance (mh) / mass matrix (hmc, nuts); every '
                         'run with --output writes <output>.covmat back')
    pr.add_argument('--seed', type=int, default=None,
                    help='generator seed (overrides the config sampler.seed)')
    pr.add_argument('--output', default=None)
    pr.add_argument('--checkpoint', default=None)
    pr.add_argument('--resume', action='store_true')
    pr.add_argument('--device', default='cuda', help=device_help)
    pr.set_defaults(fn=cmd_run)

    pe = sub.add_parser('eval', help='one likelihood evaluation')
    pe.add_argument('config')
    pe.add_argument('--set', action='append', metavar='dotted.key=value',
                    help=set_help)
    pe.add_argument('--param', action='append',
                    help='override, e.g. --param fsigma8=0.47')
    pe.add_argument('--device', default='cuda', help=device_help)
    pe.set_defaults(fn=cmd_eval)

    pf = sub.add_parser('fit', help='best fit (MAP) + Laplace errors')
    pf.add_argument('config')
    pf.add_argument('--set', action='append', metavar='dotted.key=value',
                    help=set_help)
    pf.add_argument('--starts', type=int, default=32,
                    help='multi-start count (one batched descent)')
    pf.add_argument('--adam-steps', type=int, default=250)
    pf.add_argument('--seed', type=int, default=0)
    pf.add_argument('--covmat-out', default=None, metavar='PATH',
                    help='write the Laplace covariance as a cobaya-format '
                         '.covmat (seeds `run --covmat` or cobaya itself)')
    pf.add_argument('--bootstrap', type=int, default=0, metavar='N',
                    help='parametric-bootstrap calibration: refit N '
                         'synthetic datasets drawn from the fitted model, '
                         'report debiased best-fit values and calibrated '
                         'frequentist sigmas beside the Laplace ones')
    pf.add_argument('--device', default='cuda', help=device_help)
    pf.set_defaults(fn=cmd_fit)

    ps = sub.add_parser('scan', help='profile-likelihood scan (1D or 2D)')
    ps.add_argument('config')
    ps.add_argument('--set', action='append', metavar='dotted.key=value',
                    help=set_help)
    ps.add_argument('--param', action='append',
                    help='parameter to scan (repeat for a 2D scan)')
    ps.add_argument('--ngrid', type=int, default=21)
    ps.add_argument('--nsigma', type=float, default=4.0,
                    help='grid half-width in Laplace sigmas around the MAP')
    ps.add_argument('--seed', type=int, default=0)
    ps.add_argument('--device', default='cuda', help=device_help)
    ps.set_defaults(fn=cmd_scan)

    pa = sub.add_parser('analyze', help='full analysis in one command: '
                        'MAP + Laplace, SMC posterior + evidence, report')
    pa.add_argument('config')
    pa.add_argument('--set', action='append', metavar='dotted.key=value',
                    help=set_help)
    pa.add_argument('--output', default=None,
                    help='output directory (default <config>_analysis/)')
    pa.add_argument('--starts', type=int, default=16,
                    help='MAP multi-start count')
    pa.add_argument('--adam-steps', type=int, default=250)
    pa.add_argument('--particles', type=int, default=4096,
                    help='SMC particle count')
    pa.add_argument('--moves', type=int, default=8,
                    help='SMC mutation moves per stage')
    pa.add_argument('--seed', type=int, default=0)
    pa.add_argument('--no-plots', action='store_true',
                    help='skip the corner / model-vs-data figures')
    pa.add_argument('--device', default='cuda', help=device_help)
    pa.set_defaults(fn=cmd_analyze)

    pp = sub.add_parser('post', help='importance-reweight stored chains '
                        'under a modified config (cobaya-post equivalent)')
    pp.add_argument('config', help='the config the chains were sampled with')
    pp.add_argument('--chains', required=True,
                    help='GetDist chain root written by run (e.g. chains/out)')
    pp.add_argument('--new', default=None,
                    help='replacement config for the new target')
    pp.add_argument('--set', action='append', metavar='dotted.key=value',
                    help='override applied on top of --new (or the original '
                         'config), e.g. --set data.likelihood.form=gaussian')
    pp.add_argument('--chunk', type=int, default=64)
    pp.add_argument('--output', default=None,
                    help='root for the reweighted GetDist chains '
                         '(fractional weight column)')
    pp.add_argument('--device', default='cuda', help=device_help)
    pp.set_defaults(fn=cmd_post)

    pt = sub.add_parser('tension', help='concordance/tension between two '
                        'datasets: evidence ratio ln R + parameter shift')
    pt.add_argument('config', help='first dataset (its params: block is '
                    'the shared prior)')
    pt.add_argument('config_b', help='second dataset')
    pt.add_argument('--set', action='append', metavar='dotted.key=value',
                    help='config override applied to BOTH configs (shared '
                         'analysis choices, e.g. data.likelihood.form)')
    pt.add_argument('--particles', type=int, default=4096,
                    help='SMC particle count per run')
    pt.add_argument('--moves', type=int, default=8,
                    help='SMC mutation moves per stage')
    pt.add_argument('--seed', type=int, default=0)
    pt.add_argument('--device', default='cuda', help=device_help)
    pt.set_defaults(fn=cmd_tension)

    pc = sub.add_parser('compare', help='evidence-based model comparison on '
                        'the same data: Delta ln Z between two configs')
    pc.add_argument('config', help='first model config')
    pc.add_argument('config_b', help='second model config (same data)')
    pc.add_argument('--set', action='append', metavar='dotted.key=value',
                    help='override applied to BOTH configs (shared analysis '
                         'choices — same semantics as tension --set)')
    pc.add_argument('--set-a', action='append', metavar='dotted.key=value',
                    help='override applied to the FIRST config only')
    pc.add_argument('--set-b', action='append', metavar='dotted.key=value',
                    help='override applied to the SECOND config only (so '
                         'one base config can be compared against a '
                         'variant: compare cfg.yaml cfg.yaml --set-b '
                         'model.rsd_model=kaiser)')
    pc.add_argument('--particles', type=int, default=4096,
                    help='SMC particle count per run')
    pc.add_argument('--moves', type=int, default=8,
                    help='SMC mutation moves per stage')
    pc.add_argument('--seed', type=int, default=0)
    pc.add_argument('--device', default='cuda', help=device_help)
    pc.set_defaults(fn=cmd_compare)

    pfc = sub.add_parser('forecast', help='Fisher forecast of expected '
                         'constraints at a fiducial point (no sampling)')
    pfc.add_argument('config')
    pfc.add_argument('--set', action='append', metavar='dotted.key=value',
                     help=set_help)
    pfc.add_argument('--param', action='append',
                     help='fiducial override, e.g. --param fsigma8=0.47 '
                          '(default: the params block ref locations)')
    pfc.add_argument('--device', default='cuda', help=device_help)
    pfc.set_defaults(fn=cmd_forecast)

    pb = sub.add_parser('bench', help='batched likelihood throughput')
    pb.add_argument('config')
    pb.add_argument('--set', action='append', metavar='dotted.key=value',
                    help=set_help)
    pb.add_argument('--batch', type=int, default=8192)
    pb.add_argument('--reps', type=int, default=5)
    pb.add_argument('--chunk', type=int, default=128)
    pb.add_argument('--device', default='cuda', help=device_help)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    _check_device(args.device)
    from .utils.profiling import enable_persistent_cache
    enable_persistent_cache()
    args.fn(args)


if __name__ == '__main__':
    main()

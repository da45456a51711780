"""Command-line entry: the `cobaya-run` equivalent on one CUDA card.

    python -m victor_tpu_torch run <config.yaml>     # sample the posterior
    python -m victor_tpu_torch eval <config.yaml>    # one likelihood evaluation
    python -m victor_tpu_torch bench <config.yaml>   # batched throughput

The port of `victor_tpu/__main__.py`'s `run`, `eval` and `bench`, with its
defaults and JSON output and the arguments of the samplers ported so far,
plus `--device` (default `cuda`; `--device cpu` runs on the host). The
YAML layout extends the reference's cobaya config: `model:`/`data:` blocks (reference schema), a `params:` block
(cobaya vocabulary, config/boss_cobaya_config.yaml:50-97), and an optional
`sampler:` block (kind — default mh, the cobaya algorithm class — hmc,
nuts or ensemble; n_chains, n_samples, n_warmup, n_leapfrog, max_depth,
rhat_stop, seed, output, checkpoint, covmat; cobaya's own `mcmc:` nesting
maps to mh). A top-level `quantiles:` list is a multi-quantile joint fit.
The samplers smc and ns, and cobaya's `minimize:` and `polychord:`
nestings, are not ported yet and exit with a message.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

_NOT_PORTED = ("is not ported yet: victor_tpu_torch runs the samplers mh "
               "(the default), hmc, nuts and ensemble; use victor_tpu for it")
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
        sys.exit(f"sampler 'minimize' (cobaya's MAP finder) {_NOT_PORTED}")
    if isinstance(sampler.get('polychord'), dict):
        sampler.pop('polychord')
        sampler.setdefault('kind', 'ns')
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
    if kind not in ('mh', 'hmc', 'nuts', 'ensemble'):
        sys.exit(f'sampler {kind!r} {_NOT_PORTED}')
    bundle = _build_bundle(cfg, args.device)

    if kind in _CHAIN_DEFAULTS:
        n_chains = int(sampler.get('n_chains', args.chains))
        warmup, samples, segment = _CHAIN_DEFAULTS[kind]
        n_warmup = args.warmup if args.warmup is not None else \
            int(sampler.get('n_warmup', warmup))
        n_samples = args.samples if args.samples is not None else \
            int(sampler.get('n_samples', samples))
        ckpt = sampler.get('checkpoint', args.checkpoint)
        if args.resume and ckpt and os.path.isfile(ckpt):
            # a resumed run keeps the checkpoint's chain count, and the
            # GetDist files are split by it
            with np.load(ckpt, allow_pickle=False) as z:
                if 'hmc_q' in z.files:
                    n_chains = int(z['hmc_q'].shape[0])
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
                         'unconverged; smc and ns are not ported yet')
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
    args.fn(args)


if __name__ == '__main__':
    main()

#!/usr/bin/env python
"""Posterior-level validation of the opt-in fast evaluation modes, through
the PyTorch port (victor_tpu_torch) on the card.

The counterpart of tools/validate_dispersion_fast.py. Two throughput modes
approximate exact spline passes with Chebyshev compressions:

  --model dispersion  (default) validates `dispersion_final='fast'`: the
      jacobian reuses the final Picard update's exact v_r and uses a
      degree-48 Chebyshev dv_r.
  --model streaming  validates `streaming_eval='fast'`: degree-48 Chebyshev
      compressions of v_r and the mu-independent sigma_v template inside
      the velocity-pdf convolution.
  --model esm  validates `streaming_eval='fast'` composed with the
      excursion-set matter model (the 9-parameter pipeline,
      configs/esm_sampling_config.yaml).

Pointwise bounds say the modes are accurate; the operative question for a
sampler-facing speed mode is whether the BOSS POSTERIOR moves. This runs the
port's tempered SMC (4096 particles x 8 moves) under exact and then fast
(same seeds) and compares the seed-averaged moments and logZ. The seeds
draw from the port's torch.Generator, so the runs are realisations of
their own, held by the same statistical rule as victor_tpu's.

Acceptance (unchanged): per-parameter |dmean| < 0.1 sigma,
|dsigma|/sigma < 10%, and |dlogZ| < 2 x the combined (inflated) se.
victor_tpu's recorded results (BASELINE.md): dispersion every |dmean| <=
0.047 sigma, |dsigma|/sigma <= 6.2%, dlogZ 0.11 < 2 x 0.162; streaming
<= 0.026 sigma, <= 4.3%, dlogZ 0.038; esm (3 seeds) <= 0.063 sigma, <=
3.9%, dlogZ 0.051 < 2 x 0.206.

Usage:  python tools/validate_dispersion_fast_torch.py [--model streaming]
            [--seeds 3] [--device cuda]
Prints one JSON line per run and a last JSON line with the verdict; exits 1
if the acceptance fails.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_common import REPO, load_config, require_device  # noqa: E402

sys.path.insert(0, REPO)
from victor_tpu_torch.io import build_tables  # noqa: E402
from victor_tpu_torch.sampling import run_smc  # noqa: E402

OPTS = {
    'dispersion': lambda mode: {'rsd_model': 'dispersion',
                                'dispersion_final': mode},
    'streaming': lambda mode: {'rsd_model': 'streaming',
                               'streaming_eval': mode},
    # streaming fast mode composed with the excursion-set matter model
    # (the 9-parameter ESM pipeline; v_r comes from the ESM profile instead
    # of the template, so the Chebyshev compression is re-validated on it)
    'esm': lambda mode: {'streaming_eval': mode},
}
# the SMC run of every seed and mode (tools/validate_dispersion_fast.py)
N_PARTICLES = 4096
N_MOVES = 8


def load_problem(model, device):
    """(bundle, params block) of `model`: the ESM config and its block, or
    configs/boss_config.yaml with the block of boss_sampling_config.yaml."""
    if model == 'esm':
        # the 9-parameter excursion-set pipeline carries its own config
        # (streaming RSD + excursion_set matter model) and params block
        cfg = load_config('esm_sampling_config.yaml')
        block = cfg['params']
    else:
        cfg = load_config('boss_config.yaml')
        block = load_config('boss_sampling_config.yaml')['params']
    return build_tables(cfg['model'], cfg['data'], device=device), block


def run_modes(bundle, block, model, seeds, device):
    """Tempered SMC for every seed under 'exact', then 'fast'; prints one
    JSON line per run. Returns {mode: {'summaries': [...], 'logz': [...],
    'logz_se': [...]}}, per seed."""
    runs = {}
    for mode in ('exact', 'fast'):
        runs[mode] = {'summaries': [], 'logz': [], 'logz_se': []}
        for seed in range(seeds):
            res = run_smc(bundle, block, n_particles=N_PARTICLES,
                          n_moves=N_MOVES, seed=seed,
                          opts_kw=OPTS[model](mode), device=device)
            runs[mode]['summaries'].append(res.summary())
            runs[mode]['logz'].append(res.logz)
            runs[mode]['logz_se'].append(res.logz_se)
            print(json.dumps({
                'model': model, 'mode': mode, 'seed': seed,
                'n_stages': len(res.betas) - 1,
                'logz': round(res.logz, 3), 'logz_se': round(res.logz_se, 3),
                'elapsed_s': round(res.elapsed_s, 1),
                'summary': {k: {'mean': round(v['mean'], 5),
                                'std': round(v['std'], 5)}
                            for k, v in res.summary().items()},
            }), flush=True)
    return runs


def compare_modes(runs, seeds):
    """The acceptance of tools/validate_dispersion_fast.py on per-seed runs
    (`run_modes`' result): seed-averaged moments and logZ, the se of the
    seed-averaged logZ the larger of the propagated per-run bar and the
    observed scatter; |dmean| < 0.1 sigma and |dsigma|/sigma < 0.1 for every
    parameter, |dlogZ| < 2 x the combined se. Returns (ok, shifts)."""
    avg = {}
    for mode, r in runs.items():
        avg[mode] = {'logz': float(np.mean(r['logz'])),
                     'logz_se': float(max(
                         np.hypot.reduce(r['logz_se']) / seeds,
                         (np.std(r['logz'], ddof=1) / np.sqrt(seeds))
                         if seeds > 1 else 0.0))}

    def seed_avg(mode):
        names = runs[mode]['summaries'][0].keys()
        return {n: {'mean': float(np.mean([s[n]['mean'] for s in
                                           runs[mode]['summaries']])),
                    'std': float(np.mean([s[n]['std'] for s in
                                          runs[mode]['summaries']]))}
                for n in names}

    ok = True
    report = {}
    se, sf = seed_avg('exact'), seed_avg('fast')
    for name in se:
        dm = abs(sf[name]['mean'] - se[name]['mean']) / se[name]['std']
        ds = abs(sf[name]['std'] - se[name]['std']) / se[name]['std']
        report[name] = {'dmean_over_sigma': round(dm, 4),
                        'dsigma_rel': round(ds, 4)}
        ok &= (dm < 0.1) and (ds < 0.1)
    dlz = abs(avg['fast']['logz'] - avg['exact']['logz'])
    selz = float(np.hypot(avg['fast']['logz_se'], avg['exact']['logz_se']))
    report['logZ'] = {'delta': round(dlz, 3), 'combined_se': round(selz, 3)}
    ok &= dlz < 2 * selz
    return bool(ok), report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model', default='dispersion', choices=sorted(OPTS))
    ap.add_argument('--seeds', type=int, default=1,
                    help='SMC seed replicates per mode; moments/logZ are '
                         'seed-averaged before comparison. 1 suffices for '
                         'the 4-param template posteriors; the 9-param ESM '
                         'posterior mixes slower (late-stage mutation '
                         'acceptance ~0.06), so single-seed moment noise is '
                         '~0.05 sigma and the 0.1-sigma acceptance needs '
                         '--seeds 3')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    require_device(args.device, 'validate_dispersion_fast_torch')

    bundle, block = load_problem(args.model, args.device)
    runs = run_modes(bundle, block, args.model, args.seeds, args.device)
    ok, report = compare_modes(runs, args.seeds)
    print(json.dumps({'check': f'{args.model}_fast_posterior_parity',
                      'ok': ok, 'seeds': args.seeds,
                      'shifts': report}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()

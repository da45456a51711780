#!/usr/bin/env python
"""Inference-tooling walkthrough through the PyTorch port: MAP -> Laplace ->
profile -> evidence.

The counterpart of examples/inference_demo.py: the point-estimation and
model-comparison layer built on the likelihood
(victor_tpu_torch.sampling.optimize / .smc) against the BOSS DR12 CMASS
likelihood the samplers use, on `--device` in f64 (the data's `.npz`
copies where h5py is absent).

Run from the repository root:
    python examples/inference_demo_torch.py [--smc] [--device cuda|cpu]
(--smc adds the tempered-SMC evidence run, 2048 particles x 8 moves.)
Without a card the default `--device cuda` exits 2: pass `--device cpu`.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tools'))
from _torch_common import load_config, require_device  # noqa: E402

from victor_tpu_torch.io import build_tables  # noqa: E402

PARAMS_BLOCK = {
    'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
             'ref': {'dist': 'norm', 'loc': 0.4, 'scale': 0.03}},
    'sigma_v': {'prior': {'dist': 'uniform', 'min': 100.0, 'max': 500.0},
                'ref': {'dist': 'norm', 'loc': 380.0, 'scale': 30.0}},
    'epsilon': {'prior': {'dist': 'uniform', 'min': 0.8, 'max': 1.2},
                'ref': {'dist': 'norm', 'loc': 1.0, 'scale': 0.02}},
}


def main(argv=None):
    """Print the walkthrough; returns {'map', 'corr', 'profile',
    'interval', 'fisher', 'lnz_laplace'} and with --smc 'smc'."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--smc', action='store_true',
                    help='also estimate the Bayesian evidence by tempered SMC')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    require_device(args.device, 'inference_demo_torch')
    device = args.device

    from victor_tpu_torch.sampling import (find_map, fisher_forecast,
                                           profile_scan, run_smc)
    from victor_tpu_torch.utils.profiling import enable_persistent_cache
    enable_persistent_cache()

    cfg = load_config('boss_config.yaml')
    bundle = build_tables(cfg['model'], cfg['data'], device=device)

    # 1. best fit: multi-start Adam + Newton polish, the starts batched
    print('== best fit (MAP) ==')
    m = find_map(bundle, PARAMS_BLOCK, n_starts=16, seed=0, device=device)
    for name, s in m.summary().items():
        print(f'  {name:8s} = {s["value"]:10.4f} +/- {s["std"]:.4f}  '
              '(Laplace)')
    print(f'  chi2 = {m.chi2:.4f}   |grad| = {m.grad_norm:.2e}')

    # 2. parameter degeneracies from the Laplace covariance
    corr = m.correlation
    names = [p.name for p in m.space.sampled]
    i, j = names.index('fsigma8'), names.index('sigma_v')
    print(f'  corr(fsigma8, sigma_v) = {corr[i, j]:+.3f}  '
          '(the template-normalisation degeneracy)')

    # 3. profile likelihood over fsigma8: the grid points minimise their
    #    nuisances together, in batches
    print('== profile likelihood over fsigma8 ==')
    prof = profile_scan(bundle, PARAMS_BLOCK, 'fsigma8', n_grid=13,
                        n_sigma=3.0, map_result=m, device=device)
    lo, hi = prof.interval(1.0)
    print(f'  delta-chi2 = 1 interval: [{lo:.4f}, {hi:.4f}] '
          f'(half-width {(hi - lo) / 2:.4f} vs Laplace sigma '
          f'{m.std["fsigma8"]:.4f})')

    # 4. Fisher forecast at the MAP: expected constraints from the local
    #    response, no sampling (the residual's exact Jacobian) — compare
    #    with the Laplace sigmas above (they agree in expectation for a
    #    Gaussian likelihood with parameter-independent covariance); the
    #    Laplace evidence is the free near-Gaussian cross-check of `run
    #    --sampler smc` / `ns` (prior-box truncated, NaN at non-PD optima)
    print('== Fisher forecast at the MAP ==')
    fr = fisher_forecast(bundle, m.params, names)
    for name in names:
        print(f'  sigma({name:8s}) = {fr.std[name]:.4f}  (Fisher)   '
              f'{m.std[name]:.4f}  (Laplace)')
    print(f'  lnZ (Laplace cross-check) = {m.log_evidence_laplace:.3f}')
    out = {'map': m, 'corr': float(corr[i, j]), 'profile': prof,
           'interval': (lo, hi), 'fisher': fr,
           'lnz_laplace': m.log_evidence_laplace}

    # 5. (optional) Bayesian evidence by tempered SMC
    if args.smc:
        print('== evidence (tempered SMC) ==')
        res = run_smc(bundle, PARAMS_BLOCK, n_particles=2048, n_moves=8,
                      seed=0, device=device)
        out['smc'] = res
        print(f'  logZ = {res.logz:.3f} +/- {res.logz_se:.3f} '
              f'({len(res.betas) - 1} stages, {res.elapsed_s:.1f} s)')
        for name, s in res.summary().items():
            print(f'  {name:8s} = {s["mean"]:10.4f} +/- {s["std"]:.4f}  '
                  '(posterior)')
    return out


if __name__ == '__main__':
    main()

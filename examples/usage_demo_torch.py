#!/usr/bin/env python
"""End-to-end usage walkthrough through the PyTorch port (victor_tpu_torch).

The counterpart of examples/usage_demo.py: builds a CCFFit from the shipped
BOSS DR12 CMASS config (its `.npz` copies where h5py is absent) on
`--device`, prints the likelihood checkpoints (notebook cell-22 values),
the theory multipoles and the 2D ccf, measures batched throughput, and with
`--sample` runs the walker ensemble over every visible card. f64
throughout.

Run from the repository root:
    python examples/usage_demo_torch.py [--sample] [--device cuda|cpu]
Without a card the default `--device cuda` exits 2: pass `--device cpu`.
"""

import argparse
import os
import sys

import numpy as np
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tools'))
from _torch_common import card_line, load_config, require_device  # noqa: E402

NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
N_POINTS = {'cuda': 1024, 'cpu': 128}     # the timed batch, by device type
CHECKPOINTS = [('streaming', {}), ('dispersion', {'rsd_model': 'dispersion'}),
               ('kaiser', {'rsd_model': 'kaiser'}),
               ('streaming anisotropic', {'assume_isotropic': False}),
               ('beta-interp at likelihood level',
                {'beta_interpolation': 'likelihood'})]


def throughput_points(n):
    """The (n, 4) parameter points whose batched evaluation is timed."""
    rng = np.random.default_rng(0)
    return np.column_stack([
        rng.uniform(0.3, 0.6, n), rng.uniform(0.25, 0.55, n),
        rng.uniform(250, 450, n), rng.uniform(0.9, 1.1, n)])


def sample(fit, device):
    """The walker ensemble of `--sample` on configs/boss_sampling_config.yaml's
    params block, its likelihood batches sharded over every visible card
    (the CPU's one-device mesh with --device cpu)."""
    from victor_tpu_torch.parallel import make_mesh
    from victor_tpu_torch.sampling import run_mcmc
    with open(os.path.join(REPO, 'configs',
                           'boss_sampling_config.yaml')) as f:
        block = yaml.safe_load(f)['params']
    mesh = make_mesh(('chains', 'walkers'),
                     devices=None if fit.device.type == 'cuda' else [device])
    return run_mcmc(fit.bundle, block, n_walkers=256, max_steps=1000,
                    check_every=250, rhat_stop=0.02, mesh=mesh, device=device)


def main(argv=None):
    """Print the walkthrough; returns its numbers: {'checkpoints': {label:
    (lnL, chi2)}, 'multipoles': {ell: array}, 'xi_5_5', 'evals_per_s',
    'n_points', and with --sample 'sample' (the MCMCResult)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--sample', action='store_true',
                    help='also run the ensemble sampler on the device')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    require_device(args.device, 'usage_demo_torch')

    import torch

    from victor_tpu_torch import CCFFit
    from victor_tpu_torch.likelihood.batched import make_batched_loglike
    from victor_tpu_torch.utils.profiling import (phase_times, throughput,
                                                  timed)

    cfg = load_config('boss_config.yaml')
    with timed('init'):
        fit = CCFFit(cfg['model'], cfg['data'], device=args.device)
    out = {'checkpoints': {}}

    params = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
    print('\n--- likelihood checkpoints (victor_usage_demo cell 22) ---')
    for label, kw in CHECKPOINTS:
        with timed(f'eval:{label}'):
            lnl, chi2 = fit.log_likelihood(params, **kw)
        out['checkpoints'][label] = (lnl, chi2)
        print(f'{label:36s} chi2 = {chi2:7.2f}   lnL = {lnl:7.2f}')

    print('\n--- theory multipoles + 2D ccf ---')
    mult = fit.theory_multipoles(fit.s, params, poles=[0, 2])
    out['multipoles'] = mult
    print('monopole at s =', np.round(fit.s[:3], 1), ':',
          np.round(mult['0'][:3], 4))
    xi2d = fit.theory_xi_2D(params, rmax=80)
    out['xi_5_5'] = float(xi2d(5.0, 5.0)[0, 0])
    print('xi(5, 5) =', out['xi_5_5'])

    print('\n--- batched throughput ---')
    batched = make_batched_loglike(fit.bundle, NAMES, chunk=128)
    n = N_POINTS[fit.device.type]
    theta = torch.as_tensor(throughput_points(n), dtype=torch.float64,
                            device=fit.device)
    _, calls_per_sec = throughput(batched, theta, reps=3)
    out['evals_per_s'], out['n_points'] = n * calls_per_sec, n
    print(f'{n * calls_per_sec:,.0f} likelihood evals/sec on '
          f'{card_line(args.device)} (f64, default modes, {n} points in '
          f'chunks of 128; reference victor: 11.8/sec on one CPU core)')

    if args.sample:
        print('\n--- posterior sampling (on device) ---')
        result = sample(fit, args.device)
        out['sample'] = result
        for name, stats in result.summary().items():
            print(f'{name:10s} = {stats["mean"]:.4f} +/- '
                  f'{stats["std"]:.4f} (R-hat {stats["rhat"]:.3f})')

    print('\nphase times:', {k: round(v['total_s'], 2)
                             for k, v in phase_times().items()})
    return out


if __name__ == '__main__':
    main()

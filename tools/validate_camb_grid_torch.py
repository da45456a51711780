#!/usr/bin/env python
"""Posterior-level validation of the varying-cosmology grid mode of P(k),
through the PyTorch port (victor_tpu_torch) on the card.

The counterpart of tools/validate_camb_grid.py. It extends the 9-param ESM
fit (configs/esm_sampling_config.yaml) with two sampled shape-cosmology
parameters (H0, ns) and runs the SAME 11-parameter tempered-SMC posterior
twice with the port's `sampling.run_smc` (its defaults otherwise):

  * EH mode   — P(k) from the Eisenstein-Hu formula evaluated on the device
                at every (H0, ns) the sampler visits;
  * grid mode — P(k) multilinearly interpolated from an EH-GENERATED grid
                over (H0, ns), written by `make_camb_table_torch.py --grid
                --generator eh` in a subprocess on the same device: the
                machinery a CAMB-generated grid would use in production.

Because the grid's generator IS the EH formula, any posterior difference is
interpolation error plus SMC sampler noise. The PASS criteria (unchanged
from the original) separate the two:

  * every marginal mean shift < 0.3 sigma and sd ratio in (0.75, 1.33);
  * MEDIAN |shift| over all marginals < 0.15 sigma (a systematic
    interpolation bias moves many marginals together; seed noise does
    not);
  * |Delta logZ| < 0.3 nats.

Usage:  python tools/validate_camb_grid_torch.py [--particles 4096]
            [--moves 6] [--seed 0] [--device cuda]
The grid goes to a temporary directory that is removed at the end. Prints
the card's name and power limit, each run's logZ, seconds, evaluations and
rate, the table and a PASS/FAIL verdict; exits 1 on FAIL.
"""

import argparse
import copy
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_common import REPO, card_line, load_config, require_device  # noqa: E402

sys.path.insert(0, REPO)
from victor_tpu_torch.io import build_tables  # noqa: E402
from victor_tpu_torch.sampling import run_smc  # noqa: E402

H0_GRID = '60,65,70,75'
NS_GRID = '0.90,0.95,1.00'

COSMO_PARAMS = {
    'H0': {'prior': {'dist': 'uniform', 'min': 62.0, 'max': 73.0},
           'ref': {'dist': 'norm', 'loc': 67.5, 'scale': 1.0}},
    'ns': {'prior': {'dist': 'uniform', 'min': 0.91, 'max': 0.99},
           'ref': {'dist': 'norm', 'loc': 0.96, 'scale': 0.01}},
}


def make_grid(z_eff, path, device):
    """The (H0, ns) grid of EH tables at `path`, written by
    make_camb_table_torch.py in a subprocess on `device`; returns its
    `wrote ...` line."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools',
                                      'make_camb_table_torch.py'),
         '--z', str(z_eff), '--generator', 'eh',
         '--grid', f'H0={H0_GRID}', '--grid', f'ns={NS_GRID}',
         '--npts', '400', '--out', path, '--device', device],
        capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        sys.exit(f'grid generation failed: {r.stderr}')
    return r.stdout.strip()


def mode_model(model, mode, grid_file):
    """A copy of the config's model block with P(k) in `mode`: 'eh' or
    'grid' (the table grid at `grid_file`)."""
    m = copy.deepcopy(model)
    if mode == 'eh':
        m['matter_ccf']['excursion_set_options'] = {
            'use_eisenstein_hu': True}
    else:
        m['matter_ccf']['excursion_set_options'] = {
            'use_eisenstein_hu': False, 'pk_grid_file': grid_file}
    return m


def smc_evaluations(res, n_moves):
    """Likelihood evaluations of an SMC run: the prior draw, then n_moves
    Metropolis moves of every particle per tempering stage."""
    return res.particles.shape[0] * (1 + n_moves * (len(res.betas) - 1))


def compare(results, names):
    """The original's verdict on {'eh': (mean, sd, logZ), 'grid': ...}:
    (ok, the table and verdict lines it prints)."""
    me, se, lze = results['eh']
    mg, sg, lzg = results['grid']
    lines = [f'\n{"param":10s} {"EH mean±sd":>22s} {"grid mean±sd":>22s} '
             f'{"shift/sigma":>12s} {"sd ratio":>9s}']
    ok = True
    shifts = []
    for i, n in enumerate(names):
        shift = abs(mg[i] - me[i]) / max(se[i], 1e-300)
        ratio = sg[i] / max(se[i], 1e-300)
        shifts.append(shift)
        flag = ''
        if shift > 0.3 or not 0.75 < ratio < 1.33:
            ok = False
            flag = '  <-- FAIL'
        lines.append(f'{n:10s} {me[i]:12.5g} ±{se[i]:8.3g} {mg[i]:12.5g} '
                     f'±{sg[i]:8.3g} {shift:12.3f} {ratio:9.3f}{flag}')
    med = float(np.median(shifts))
    dlz = abs(lzg - lze)
    if med > 0.15:
        ok = False
        lines.append(f'median |shift| {med:.3f} > 0.15 sigma  <-- FAIL '
                     '(systematic, not seed noise)')
    else:
        lines.append(f'median |shift| {med:.3f} sigma (systematic-bias '
                     'criterion < 0.15)')
    if dlz > 0.3:
        ok = False
    lines.append(f'logZ: EH {lze:.3f} vs grid {lzg:.3f} '
                 f'(delta {dlz:.3f}, criterion < 0.3)')
    lines.append('PASS: grid-mode posterior matches EH mode to '
                 'interpolation error' if ok else
                 'FAIL: grid-mode posterior deviates beyond the bound')
    return ok, lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    # 4096 default: at 2048 the SMC seed noise on the prior-dominated
    # marginals (~0.1-0.2 sigma) sits right at the systematic-bias
    # criterion (the original's measurement)
    ap.add_argument('--particles', type=int, default=4096)
    ap.add_argument('--moves', type=int, default=6)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    require_device(args.device, 'validate_camb_grid_torch.py')
    print(f'card: {card_line(args.device)}', flush=True)

    cfg = load_config('esm_sampling_config.yaml')
    z_eff = cfg['model'].get('z_eff', 0.57)
    block = dict(cfg['params'])
    block.update(copy.deepcopy(COSMO_PARAMS))

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        grid_file = os.path.join(tmp, 'esm_eh_grid_val.npz')
        print(make_grid(z_eff, grid_file, args.device), flush=True)
        for mode in ('eh', 'grid'):
            bundle = build_tables(mode_model(cfg['model'], mode, grid_file),
                                  cfg['data'], device=args.device)
            res = run_smc(bundle, block, n_particles=args.particles,
                          n_moves=args.moves, seed=args.seed,
                          device=args.device)
            # SMC particles are equal-weight posterior draws post-resampling
            mean = res.particles.mean(axis=0)
            sd = res.particles.std(axis=0)
            results[mode] = (mean, sd, res.logz)
            evals = smc_evaluations(res, args.moves)
            print(f'{mode}: logZ = {res.logz:.3f} ({res.elapsed_s:.1f} s)')
            print(f'  {len(res.betas) - 1} stages, {evals} likelihood '
                  f'evaluations, {evals / res.elapsed_s:.1f} evals/s',
                  flush=True)

    ok, lines = compare(results, list(block))
    print('\n'.join(lines), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()

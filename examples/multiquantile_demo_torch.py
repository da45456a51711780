#!/usr/bin/env python
"""Density-split multi-quantile joint fit walkthrough through the PyTorch
port (victor_tpu_torch).

The counterpart of examples/multiquantile_demo.py. Density-split analyses
fit several quantile-defined centre sets (DS1..DSn) simultaneously:
per-quantile model inputs and data vectors, one joint cross-covariance over
the stacked vector, and optional per-quantile parameter overrides
(`<name>__q<i>`). victor_tpu_torch's likelihood/multiquantile.py makes the
joint fit a target of every estimation entry point.

Since the repository ships only the single BOSS CMASS dataset, this demo
builds a stand-in: TWO "quantiles" that are both the BOSS dataset, with a
block-diagonal joint covariance assembled from the per-dataset covariance
at beta = 0.37. The joint chi2 is then ~2x the single-dataset 65.01, and
every Fisher sigma shrinks by ~1/sqrt(2). The joint covariance is written
as an `.npz` file (the port's loader reads it without h5py) into a
temporary directory; the BOSS files are read from their `.npz` copies where
h5py is absent. f64 on `--device`.

Run from the repository root:
    python examples/multiquantile_demo_torch.py [--device cuda|cpu]
Without a card the default `--device cuda` exits 2: pass `--device cpu`.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tools'))
from _torch_common import load_config, require_device  # noqa: E402

from victor_tpu_torch.io import build_tables  # noqa: E402

GOLDEN = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
BATCH = [[0.45, 0.36], [0.47, 0.37], [0.50, 0.39]]


def build_joint_config(tmpdir, device):
    """A 2-quantile joint config from the shipped BOSS files + a
    block-diagonal joint covariance written to `tmpdir`, and the single
    dataset's bundle on `device`."""
    import torch

    from victor_tpu_torch.likelihood import core as lk

    cfg = load_config('boss_config.yaml')
    single = build_tables(cfg['model'], cfg['data'], device=device)
    beta = torch.tensor([0.37], dtype=torch.float64,
                        device=single.tables.cov.device)
    cov1 = lk.interpolated_covariance(single.tables, single.spec,
                                      beta)[0].cpu().numpy()
    D = cov1.shape[0]
    joint_cov = np.zeros((2 * D, 2 * D))
    joint_cov[:D, :D] = cov1
    joint_cov[D:, D:] = cov1
    cov_fn = os.path.join(tmpdir, 'joint_cov.npz')
    np.savez(cov_fn, covmat=joint_cov)

    quantile = {
        'model': cfg['model'],
        'data': {'redshift_space_ccf': cfg['data']['redshift_space_ccf'],
                 'dir': REPO},
    }
    return {
        'quantiles': [quantile, quantile],
        'covariance_matrix': {'data_file': cov_fn, 'cov_key': 'covmat',
                              'fixed_beta': True},
        'likelihood': {'form': 'sellentin', 'nmocks': 1000, 'nparams': 4},
    }, single


def main(argv=None):
    """Print the walkthrough; returns {'lnl', 'chi2', 'chi2_q1', 'lnl_batch',
    'sigma_single', 'sigma_joint'}."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    require_device(args.device, 'multiquantile_demo_torch')
    device = args.device

    import torch

    from victor_tpu_torch.likelihood.multiquantile import (
        build_joint_tables, joint_log_likelihood, make_batched_joint_loglike)
    from victor_tpu_torch.sampling.optimize import fisher_forecast
    from victor_tpu_torch.utils.profiling import enable_persistent_cache
    enable_persistent_cache()

    def tensor(v):
        return torch.tensor(v, dtype=torch.float64, device=device)

    out = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        joint_cfg, single = build_joint_config(tmpdir, device)
        jb = build_joint_tables(joint_cfg, device=device)
    print(f'joint bundle: {len(jb.bundles)} quantiles, stacked data '
          f'vector length {jb.ndata}')

    # -- joint likelihood at the notebook golden point --------------------
    params = {k: tensor([v]) for k, v in GOLDEN.items()}
    lnl, chi2 = joint_log_likelihood(jb, params)
    out['lnl'], out['chi2'] = float(lnl[0]), float(chi2[0])
    print(f'joint lnL = {out["lnl"]:.2f}, chi2 = {out["chi2"]:.2f} '
          '(~2x the single-dataset 65.01: block-diagonal duplicate)')

    # -- per-quantile overrides: sigma_v for quantile 1 only --------------
    _, chi2_q = joint_log_likelihood(
        jb, {**params, 'sigma_v__q1': tensor([300.0])})
    out['chi2_q1'] = float(chi2_q[0])
    print(f'with sigma_v__q1=300 override: chi2 = {out["chi2_q1"]:.2f}')

    # -- batched joint evaluations (the sampler-facing form) --------------
    batched = make_batched_joint_loglike(
        jb, ['fsigma8', 'beta'],
        base_params={'sigma_v': 380.0, 'epsilon': 1.0}, chunk=16)
    lnl_b, _ = batched(tensor(BATCH))
    out['lnl_batch'] = lnl_b.cpu().numpy().tolist()
    print('batched joint lnL over 3 points:',
          np.round(np.asarray(out['lnl_batch']), 2).tolist())

    # -- Fisher forecast: joint vs single ----------------------------------
    names = ('fsigma8', 'epsilon')
    fj = fisher_forecast(jb, GOLDEN, names)
    fs = fisher_forecast(single, GOLDEN, names)
    out['sigma_joint'] = [fj.std[n] for n in names]
    out['sigma_single'] = [fs.std[n] for n in names]
    for n in names:
        print(f'sigma({n}): single {fs.std[n]:.4f} -> joint '
              f'{fj.std[n]:.4f} (expect /sqrt(2) = '
              f'{fs.std[n] / np.sqrt(2):.4f})')
    return out


if __name__ == '__main__':
    main()

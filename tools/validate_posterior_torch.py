#!/usr/bin/env python
"""Sampler-free posterior validation by direct grid quadrature, through the
PyTorch port (victor_tpu_torch) on the card.

The counterpart of tools/validate_posterior.py: evaluates the BOSS
likelihood on a dense 4D parameter grid with the port's batched evaluator
in the exact modes (`make_batched_loglike(..., chunk=128,
gradient_free=False)`) and computes posterior moments by numerical
marginalisation, plus the log-evidence under the config's uniform priors.
The grid points go in f64, the port's dtype (the JAX tool casts them to
f32).

victor_tpu's recorded result (BASELINE.md, its round 1), which the port's
f64 quadrature is held against:
    fsigma8  0.5725 +/- 0.0542
    beta     0.3669 +/- 0.0104
    sigma_v  417.97 +/- 44.30
    epsilon  1.0091 +/- 0.0106
    logZ = 278.967

Usage:  python tools/validate_posterior_torch.py [--ngrid 36] [--device cuda]
At --ngrid 36: 1,679,616 evaluations, 3 ppoly_eval launches per chunk of
128 (39,366 in all). Prints the evaluation count, time and rate, and the
card's name and power limit beside them.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_common import REPO, card_line, load_config, require_device  # noqa: E402

sys.path.insert(0, REPO)
from victor_tpu_torch.io import build_tables  # noqa: E402
from victor_tpu_torch.likelihood.batched import make_batched_loglike  # noqa: E402
from victor_tpu_torch.sampling.priors import ParamSpace  # noqa: E402
from victor_tpu_torch.utils.profiling import total  # noqa: E402

NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
CHUNK = 128


def quadrature_axes(n):
    """The grid's four axes, `n` points each (tools/validate_posterior.py)."""
    return [np.linspace(0.35, 0.85, n), np.linspace(0.32, 0.41, n),
            np.linspace(250.0, 500.0, n), np.linspace(0.96, 1.06, n)]


def quadrature_grid(axes):
    """(n**4, 4) grid points, the last axis fastest."""
    return np.stack(np.meshgrid(*axes, indexing='ij'), axis=-1).reshape(-1, 4)


def grid_loglike(bundle, device):
    """The exact-mode batched likelihood the quadrature integrates: grid
    points (N, 4) -> lnL (N,) in f64 numpy."""
    batched = make_batched_loglike(bundle, NAMES, chunk=CHUNK,
                                   gradient_free=False)

    def lnl_of(points):
        theta = torch.as_tensor(points, dtype=torch.float64, device=device)
        return batched(theta)[0].cpu().numpy().astype(np.float64)
    return lnl_of


def evaluate_grid(lnl_of, grid, n):
    """lnL at every grid point, in blocks of n * n * 8 points, f64."""
    lnl = np.empty(len(grid))
    block = n * n * 8
    for i in range(0, len(grid), block):
        lnl[i:i + block] = lnl_of(grid[i:i + block])
    return lnl


def grid_quadrature(lnl, axes, space):
    """(mean, std, edge, logz) of the posterior on the grid: normalised
    weights, the marginals' edge mass over their peak, and the log-evidence
    by trapezoid quadrature over the prior volume (None unless `space`
    samples exactly the grid's parameters under uniform priors)."""
    from scipy.special import logsumexp
    n = len(axes[0])
    grid = quadrature_grid(axes)
    w = np.exp(lnl - lnl.max())
    w /= w.sum()
    mean = (w[:, None] * grid).sum(0)
    std = np.sqrt((w[:, None] * (grid - mean) ** 2).sum(0))
    wg = w.reshape((n,) * 4)
    edge = np.empty(4)
    for k in range(4):
        marg = wg.sum(axis=tuple(j for j in range(4) if j != k))
        edge[k] = (marg[0] + marg[-1]) / marg.max()
    logz = None
    if space.ndim == len(axes) and \
            all(p.dist == 'uniform' for p in space.sampled):
        logw = np.zeros((n,) * 4)
        for k, ax in enumerate(axes):
            wk = np.gradient(ax)            # trapezoid weights, uniform grid
            wk[0] *= 0.5
            wk[-1] *= 0.5
            shape = [1] * 4
            shape[k] = n
            logw = logw + np.log(wk).reshape(shape)
        log_prior_vol = float(np.sum([np.log(p.hi - p.lo)
                                      for p in space.sampled]))
        logz = float(logsumexp(lnl + logw.reshape(-1)) - log_prior_vol)
    return mean, std, edge, logz


def report_lines(mean, std, edge, logz):
    """The lines tools/validate_posterior.py prints for its result."""
    lines = []
    for k, name in enumerate(NAMES):
        flag = '' if edge[k] < 0.05 else \
            '  [posterior touches grid/prior edge]'
        lines.append(f'{name:8s} = {mean[k]:.4f} +/- {std[k]:.4f}{flag}')
    if logz is not None:
        lines.append(f'log-evidence (grid quadrature, uniform priors): '
                     f'logZ = {logz:.3f}')
    return lines



def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--ngrid', type=int, default=36)
    ap.add_argument('--config', default=os.path.join(
        REPO, 'configs', 'boss_sampling_config.yaml'))
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    require_device(args.device, 'validate_posterior_torch')

    cfg = load_config(args.config)
    bundle = build_tables(cfg['model'], cfg['data'], device=args.device)
    axes = quadrature_axes(args.ngrid)
    grid = quadrature_grid(axes)
    lnl_of = grid_loglike(bundle, args.device)

    launches = total('ppoly.launches')
    t0 = time.time()
    lnl = evaluate_grid(lnl_of, grid, args.ngrid)
    dt = time.time() - t0
    launches = total('ppoly.launches') - launches
    print(f'{len(grid):,} likelihood evaluations in {dt:.1f}s '
          f'({len(grid) / dt:,.0f}/s)')
    print(f'on {card_line(args.device)} ({args.device}, f64, exact modes, '
          f'chunk {CHUNK}): {dt:.2f} s, {len(grid) / dt:,.1f} evals/s, '
          f'{launches:,} ppoly_eval kernel launches')
    mean, std, edge, logz = grid_quadrature(
        lnl, axes, ParamSpace(cfg.get('params') or {}))
    for line in report_lines(mean, std, edge, logz):
        print(line)


if __name__ == '__main__':
    main()

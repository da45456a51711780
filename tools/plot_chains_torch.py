#!/usr/bin/env python
"""Quick-look chain analysis without GetDist, through the PyTorch port
(victor_tpu_torch): corner plot + diagnostics.

The counterpart of tools/plot_chains.py. Reads GetDist-format chain files
written by the samplers (`<root>.<i>.txt` rows of [weight, -lnpost,
params..., derived...], plus `<root>.paramnames`) and

  * prints per-parameter mean/std and cross-chain R-hat (the same lines as
    tools/plot_chains.py),
  * saves a corner plot (1D marginals on the diagonal, 2D 68/95% contours
    below) as `<root>_corner.png`, drawn by
    victor_tpu_torch.plottools.corner_plot,
  * with --progress, plots `<root>.progress` (read by
    victor_tpu_torch.sampling.chains.read_progress) to
    `<root>_progress.png`.

The figures need matplotlib. Where it is not installed (the card's
machine), the statistics are printed and a line says that the figures were
skipped; no PNG is claimed. Everything runs on the host (numpy, f64, and
matplotlib), so the tool needs no card and runs anywhere, as
tools/plot_chains.py does.

Usage:  python tools/plot_chains_torch.py chains/boss [--burn 0.3]
            [--params a b] [--progress]
"""

import argparse
import glob
import importlib.util
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_common import REPO  # noqa: E402

sys.path.insert(0, REPO)


def have_matplotlib() -> bool:
    return importlib.util.find_spec('matplotlib') is not None


def _chain_index(path):
    """Chain-file index from `<root>.<i>.txt`, or None for non-chain files
    (a stray `chains/boss.info.txt` must be skipped, not crash int())."""
    tail = path.rsplit('.', 2)
    return int(tail[-2]) if len(tail) >= 3 and tail[-2].isdigit() else None


def load_chains(root, burn_fraction=0.0):
    """Returns (list of (n_i, ncol) arrays, param names incl. derived)."""
    files = sorted((f for f in glob.glob(f'{root}.*.txt')
                    if _chain_index(f) is not None), key=_chain_index)
    if not files:
        raise FileNotFoundError(f'no chain files matching {root}.<i>.txt')
    with open(f'{root}.paramnames') as f:
        # GetDist marks derived params with a trailing '*'; strip it so
        # --params can address them by their plain name
        names = [line.split()[0].rstrip('*') for line in f if line.strip()]
    chains = []
    for fn in files:
        arr = np.loadtxt(fn, ndmin=2)
        chains.append(arr[int(len(arr) * burn_fraction):])
    return chains, names


def cross_chain_rhat(chains, k):
    """Gelman-Rubin R-hat for column k across chain files.

    Computed unweighted: exact for this project's writers (weight = 1 per
    row); for externally-produced weighted chains treat it as approximate
    and use GetDist for the formal statistic. Deliberately local (this tool
    stays import-light); the package's formal statistic is the split-R-hat
    in victor_tpu_torch.sampling.diagnostics /
    parallel.mesh.cross_chain_rhat."""
    cols = [c[:, 2 + k] for c in chains]
    n = min(len(c) for c in cols)
    if n < 4 or len(cols) < 2:
        return np.nan
    cols = np.stack([c[:n] for c in cols])       # (m, n)
    within = cols.var(axis=1, ddof=1).mean()
    between = n * cols.mean(axis=1).var(ddof=1)
    if within == 0:
        return np.nan
    return np.sqrt(((n - 1) / n * within + between / n) / within)


def stats_lines(chains, names, burn):
    """The statistics lines tools/plot_chains.py prints."""
    stacked = np.concatenate(chains)
    w = stacked[:, 0]
    data = stacked[:, 2:]
    lines = [f'{len(chains)} chain file(s), {len(data)} samples '
             f'(burn {burn:.0%})']
    for k, name in enumerate(names):
        rhat = cross_chain_rhat(chains, k)
        rtxt = f'R-1 = {rhat - 1:.4f}' if np.isfinite(rhat) else ''
        mean = np.average(data[:, k], weights=w)
        std = np.sqrt(np.average((data[:, k] - mean) ** 2, weights=w))
        lines.append(f'  {name:20s} = {mean:12.5g} +/- {std:.5g}   {rtxt}')
    return lines


def corner_plot(chains, names, out_path, params=None, bins=40):
    """Weighted corner plot of the stacked chain files — delegates to the
    port's array-based victor_tpu_torch.plottools.corner_plot (the GetDist
    weight column carries cobaya MH accept multiplicities, our writers emit
    1s)."""
    from victor_tpu_torch.plottools import corner_plot as _corner

    stacked = np.concatenate(chains)
    return _corner(stacked[:, 2:], names, out_path, weights=stacked[:, 0],
                   params=params, bins=bins)


def progress_plot(root, out_path):
    """Convergence-monitoring plot from `<root>.progress` (the cobaya
    plot_progress role): max split-R-1 (log scale) and acceptance rate vs
    recorded draws, one panel each."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    from victor_tpu_torch.sampling.chains import read_progress

    prog = read_progress(root)
    fig, (ax1, ax2) = plt.subplots(2, 1, sharex=True, figsize=(6, 5))
    ok = np.isfinite(prog['rminus1'])
    ax1.plot(prog['n'][ok], prog['rminus1'][ok], 'o-')
    ax1.set_yscale('log')
    ax1.set_ylabel('max split-(R-1)')
    ax1.axhline(0.01, color='gray', ls='--', lw=0.8)
    ax2.plot(prog['n'], prog['acceptance'], 'o-')
    ax2.set_ylabel('acceptance rate')
    ax2.set_xlabel('recorded draws')
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('root', help='chain root (e.g. chains/boss)')
    ap.add_argument('--burn', type=float, default=0.0,
                    help='burn-in fraction per chain file')
    ap.add_argument('--params', nargs='*', default=None,
                    help='subset of parameters to plot (default: first 6)')
    ap.add_argument('--progress', action='store_true',
                    help='also plot <root>.progress (R-1 + acceptance vs '
                         'draws) to <root>_progress.png')
    args = ap.parse_args(argv)
    plots = have_matplotlib()
    skipped = 'skipped: matplotlib is not installed'

    if args.progress:
        if not os.path.isfile(args.root + '.progress'):
            print(f'no {args.root}.progress file', file=sys.stderr)
        elif plots:
            print('progress plot:',
                  progress_plot(args.root, f'{args.root}_progress.png'))
        else:
            print(f'progress plot: {skipped}')

    try:
        chains, names = load_chains(args.root, args.burn)
    except FileNotFoundError as e:
        # mid-run monitoring: the .progress file exists from the first
        # segment but chain .txt files only appear at run end — the
        # progress plot above is the deliverable, not a crash
        print(f'{e} (chain files are exported at run end; '
              'progress-only monitoring is fine mid-run)', file=sys.stderr)
        return
    for line in stats_lines(chains, names, args.burn):
        print(line)
    if plots:
        out = corner_plot(chains, names, f'{args.root}_corner.png',
                          args.params)
        print(f'corner plot: {out}')
    else:
        print(f'corner plot: {skipped}')


if __name__ == '__main__':
    main()

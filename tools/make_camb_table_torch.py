#!/usr/bin/env python
"""Generate linear P(k, z=0) tables for the excursion-set model, through the
PyTorch port (victor_tpu_torch).

The counterpart of tools/make_camb_table.py, with its flags, its `.npz`
schema and its output lines; `--device` names where the Eisenstein-Hu
generator computes (the card unless `--device cpu` is asked for). The tables
feed the ESM's two table modes of P(k):

* **Single table** (`matter_ccf.excursion_set_options.pk_table_file`) —
  P(k) at one fixed cosmology; only `sigma_8_0` can vary in a chain.
  Output: .npz with k [h/Mpc], pk0 [(Mpc/h)^3 at z=0], sigma8_0, sigma8_z
  and the cosmology it was made at.

* **Cosmology grid** (`--grid name=v1,v2,...`, `pk_grid_file`) — P(k) at
  every point of a small grid over named cosmology axes (H0 / Omega_m /
  Omega_b / ns, the names the sampler uses), interpolated multilinearly in
  log P(k) on the device per likelihood call
  (victor_tpu_torch/models/esm.py::_esm_grid_interp). Output: .npz with k,
  axis_names, grid_<name> per axis, logpk0 (*shape, nk), sigma8_0 (*shape),
  sigma8_z (*shape), z, mnu and generator.

`--generator eh` computes the tables from the Eisenstein-Hu fitting formula
with the port's own functions (models/eisenstein_hu.py and
ops/special.py::growth_factor_lcdm) in f64: the validation generator, whose
grid must reproduce the direct EH mode up to interpolation error
(tools/validate_camb_grid_torch.py). `--generator camb` runs CAMB on the
host and needs the `camb` package.

Usage:
    python tools/make_camb_table_torch.py --generator eh --z 0.57 \
        --npts 400 --out data/eh_pk_table.npz [--device cpu]
    python tools/make_camb_table_torch.py --generator eh --z 0.57 \
        --grid H0=60,65,70,75 --grid ns=0.90,0.95,1.00 --npts 400 \
        --out data/eh_pk_grid.npz
"""

import argparse
import functools
import itertools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_common import REPO, require_device  # noqa: E402

sys.path.insert(0, REPO)

AXIS_NAMES = ('H0', 'Omega_m', 'Omega_b', 'ns')


def _pk_camb(h, omega_m, omega_b, ns, mnu, z, kmax, npts, accuracy):
    import camb
    pars = camb.CAMBparams()
    pars.set_accuracy(AccuracyBoost=accuracy)
    omch2 = (omega_m - omega_b) * h ** 2
    ombh2 = omega_b * h ** 2
    pars.set_cosmology(H0=100 * h, ombh2=ombh2, omch2=omch2, mnu=mnu, omk=0)
    pars.InitPower.set_params(As=2e-9, ns=ns, r=0)
    redshifts = [z, 0.0] if z > 0 else [0.0]
    pars.set_matter_power(redshifts=redshifts, kmax=kmax)
    pars.NonLinear = camb.model.NonLinear_none
    results = camb.get_results(pars)
    if z > 0:
        sigma8_z, sigma8_0 = results.get_sigma8()
    else:
        sigma8_0 = results.get_sigma8()[0]
        sigma8_z = sigma8_0
    pk = camb.get_matter_power_interpolator(pars, nonlinear=False)
    k = np.logspace(-4, np.log10(kmax), npts)
    return k, pk.P(0.0, k), float(sigma8_0), float(sigma8_z)


def _pk_eh(h, omega_m, omega_b, ns, mnu, z, kmax, npts, accuracy,
           device='cuda'):
    """Eisenstein-Hu stand-in generator (the CAMB table contract), in f64
    on `device`: sigma8_z uses the closed-form LCDM growth, what EH mode
    computes per call, so an EH-generated grid reproduces EH mode at its
    nodes. Returns (k, pk0, sigma8_0, sigma8_z) as numpy and floats."""
    import torch

    from victor_tpu_torch.models.eisenstein_hu import (eisenstein_hu_params,
                                                       power_eh, sigma80)
    from victor_tpu_torch.ops.special import growth_factor_lcdm

    def one(v):
        return torch.tensor([float(v)], dtype=torch.float64, device=device)

    p = eisenstein_hu_params(one(h), one(omega_m), one(omega_b), one(ns),
                             As=2e-9)
    k = np.logspace(-4, np.log10(kmax), npts)
    pk0 = power_eh(p, torch.as_tensor(k, device=device))[0].cpu().numpy()
    s80 = float(sigma80(p)[0])
    s8z = s80 * float(growth_factor_lcdm(
        torch.tensor(float(z), dtype=torch.float64, device=device),
        omega_m, 1.0 - omega_m))
    return k, pk0, s80, s8z


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--h', type=float, default=0.675)
    p.add_argument('--omega-m', type=float, default=0.31)
    p.add_argument('--omega-b', type=float, default=0.048)
    p.add_argument('--z', type=float, default=0.0, help='redshift for sigma8_z')
    p.add_argument('--ns', type=float, default=0.96)
    p.add_argument('--mnu', type=float, default=0.06)
    p.add_argument('--accuracy', type=float, default=1.0)
    p.add_argument('--kmax', type=float, default=2.0)
    p.add_argument('--npts', type=int, default=200)
    p.add_argument('--grid', action='append', default=[],
                   metavar='name=v1,v2,...',
                   help=f'cosmology grid axis (one of {AXIS_NAMES}); repeat '
                        'per axis. With any --grid, writes the grid format '
                        '(pk_grid_file); axes not listed stay at their '
                        'scalar flag values')
    p.add_argument('--generator', choices=['camb', 'eh'], default='camb',
                   help='eh = Eisenstein-Hu stand-in (no camb dependency; '
                        'the validation generator — see module docstring)')
    p.add_argument('--out', required=True)
    p.add_argument('--device', default='cuda',
                   help="where the eh generator computes: 'cuda' (default) "
                        "or 'cpu'; camb runs on the host")
    args = p.parse_args(argv)

    if args.generator == 'camb':
        try:
            import camb                                        # noqa: F401
        except ImportError:
            sys.exit('camb is not installed; install it (pip install camb) '
                     'to generate tables, use --generator eh for the '
                     'validation stand-in, or use use_eisenstein_hu: True')
        gen = _pk_camb
    else:
        require_device(args.device, 'make_camb_table_torch.py')
        gen = functools.partial(_pk_eh, device=args.device)

    base = {'H0': 100 * args.h, 'Omega_m': args.omega_m,
            'Omega_b': args.omega_b, 'ns': args.ns}
    common = dict(mnu=args.mnu, z=args.z, kmax=args.kmax, npts=args.npts,
                  accuracy=args.accuracy)

    if not args.grid:
        k, pk0, s80, s8z = gen(args.h, args.omega_m, args.omega_b, args.ns,
                               **common)
        np.savez(args.out, k=k, pk0=pk0, sigma8_0=s80, sigma8_z=s8z,
                 h=args.h, omega_m=args.omega_m, omega_b=args.omega_b,
                 ns=args.ns, mnu=args.mnu, z=args.z)
        print(f'wrote {args.out}: sigma8(0)={s80:.5f} '
              f'sigma8(z={args.z})={s8z:.5f}')
        return

    names, axes = [], []
    for spec in args.grid:
        name, _, vals = spec.partition('=')
        if name not in AXIS_NAMES:
            sys.exit(f'--grid axis {name!r} must be one of {AXIS_NAMES} '
                     '(the sampler parameter names)')
        grid = np.asarray([float(v) for v in vals.split(',')])
        if len(grid) < 1 or (len(grid) > 1 and not np.all(np.diff(grid) > 0)):
            sys.exit(f'--grid {name}: values must be strictly increasing')
        names.append(name)
        axes.append(grid)
    shape = tuple(len(a) for a in axes)
    logpk = np.empty(shape + (args.npts,))
    s80g = np.empty(shape)
    s8zg = np.empty(shape)
    k = None
    for idx in itertools.product(*(range(n) for n in shape)):
        pt = dict(base)
        pt.update({n: axes[a][idx[a]] for a, n in enumerate(names)})
        k, pk0, s80, s8z = gen(pt['H0'] / 100.0, pt['Omega_m'],
                               pt['Omega_b'], pt['ns'], **common)
        logpk[idx] = np.log(pk0)
        s80g[idx] = s80
        s8zg[idx] = s8z
    out = {'k': k, 'axis_names': np.asarray(names), 'logpk0': logpk,
           'sigma8_0': s80g, 'sigma8_z': s8zg, 'z': args.z,
           'mnu': args.mnu, 'generator': args.generator}
    for n, a in zip(names, axes):
        out[f'grid_{n}'] = a
    np.savez(args.out, **out)
    print(f'wrote {args.out}: {len(names)}-axis grid {shape} '
          f'({int(np.prod(shape))} {args.generator} tables), '
          f'sigma8(0) range [{s80g.min():.5f}, {s80g.max():.5f}]')


if __name__ == '__main__':
    main()

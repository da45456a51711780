#!/usr/bin/env python
"""Injected-shift validation of the tension pipeline on the BOSS machinery,
through the PyTorch port (victor_tpu_torch) on the card.

The counterpart of tools/tension_injection_probe.py. Two noiseless datasets
are manufactured from the shipped BOSS tables:

  A: data vector = theory at the fiducial {fsigma8 .47, beta .37, sv 380,
     eps 1.0}
  B: the same with fsigma8 shifted by `--nsigma` posterior sigmas
     (sigma(fsigma8) = 0.054, grid-quadrature truth)

and the full three-evidence pipeline (run_tension) runs on each of
--nsigma 0 (control: must report concordance, ln R > 0, shift < 2 sigma)
and the injected value (must report ln R < 0 and a parameter shift within
1 of nsigma/sqrt(2): both clouds carry the same sigma, so the Gaussian
shift statistic sees Delta / sqrt(2) per direction).

ln R must first overcome the concordance prior-volume bonus, so it crosses
zero only near Delta ~ sqrt(2 ln R_control) ~ 4.2 sigma: hence the 6-sigma
default, where both statistics must read tension. victor_tpu's recorded
result (BASELINE.md): control ln R = +8.67 +/- 0.20, shift 0.0 sigma;
injected (N = 6) ln R = -8.93 +/- 0.20, shift 4.98 sigma.

Usage:  python tools/tension_injection_probe_torch.py [--nsigma 6]
            [--particles 4096] [--moves 8] [--device cuda]
Prints one JSON line per case; exits non-zero if the control fails to read
concordance or the injection fails to read tension.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_common import load_config, require_device  # noqa: E402
from coverage_test_torch import (PARAMS_BLOCK, _mock_setup,  # noqa: E402
                                 shift_datavector)

from victor_tpu_torch.io import build_tables  # noqa: E402
from victor_tpu_torch.models.ccf_theory import theory_vector  # noqa: E402
from victor_tpu_torch.sampling.tension import run_tension  # noqa: E402

SIGMA_FSIGMA8 = 0.054       # grid-quadrature posterior sigma (BASELINE.md)
FIDUCIAL = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}


def noiseless_bundles(bundle, ns):
    """(bundle A, bundle B, data vector A, data vector B): A's data vector
    is the theory at FIDUCIAL, B's the theory there with fsigma8 moved by
    `ns` x SIGMA_FSIGMA8; each is grafted in at the fiducial beta."""
    tvec, dvec, _ = _mock_setup(bundle, FIDUCIAL)
    bundle_a = shift_datavector(bundle, np.asarray(tvec - dvec))
    fid_b = dict(FIDUCIAL)
    fid_b['fsigma8'] = FIDUCIAL['fsigma8'] + ns * SIGMA_FSIGMA8
    ref = bundle.tables.iaH
    tvec_b = theory_vector(bundle.tables, bundle.spec, bundle.theory_opts,
                           {k: torch.tensor([float(v)], dtype=ref.dtype,
                                            device=ref.device)
                            for k, v in fid_b.items()})
    tvec_b = tvec_b[0].detach().cpu().numpy().astype(np.float64)
    bundle_b = shift_datavector(bundle, tvec_b - dvec)
    return bundle_a, bundle_b, tvec, tvec_b


def verdict(case, ns, res):
    """(ok, expectation) of a case: the control must read concordance and
    no shift, the injection tension and a shift near ns / sqrt(2)."""
    if case == 'control':
        return (res.logr > 0 and res.shift_nsigma < 2.0,
                'ln R > 0, shift < 2 sigma')
    # both posteriors carry ~the same sigma, so the Gaussian shift statistic
    # sees Delta/sqrt(2); allow generous SMC noise
    return (res.logr < 0 and abs(res.shift_nsigma - ns / np.sqrt(2.0)) < 1.0,
            f'ln R < 0, shift ~ {ns / np.sqrt(2.0):.2f} sigma')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--nsigma', type=float, default=6.0,
                    help='injected fsigma8 shift in posterior sigmas '
                         '(>~ 4.2 for ln R to cross zero — see docstring)')
    ap.add_argument('--particles', type=int, default=4096)
    ap.add_argument('--moves', type=int, default=8)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    require_device(args.device, 'tension_injection_probe_torch')

    cfg = load_config('boss_config.yaml')
    bundle = build_tables(cfg['model'], cfg['data'], device=args.device)

    failures = 0
    for case, ns in (('control', 0.0), ('injected', args.nsigma)):
        bundle_a, bundle_b, _, _ = noiseless_bundles(bundle, ns)
        res = run_tension(bundle_a, bundle_b, PARAMS_BLOCK,
                          n_particles=args.particles, n_moves=args.moves,
                          device=args.device)
        ok, expect = verdict(case, ns, res)
        failures += 0 if ok else 1
        print(json.dumps({
            'case': case, 'injected_nsigma': ns, 'ok': bool(ok),
            'expect': expect,
            'ln_R': round(res.logr, 3), 'ln_R_se': round(res.logr_se, 3),
            'verdict': 'concordance' if res.logr > 0 else 'tension',
            'shift_nsigma': round(res.shift_nsigma, 3),
            'shift_p': round(res.shift_p, 6),
            'logz': {'a': round(res.logz_a, 3), 'b': round(res.logz_b, 3),
                     'ab': round(res.logz_ab, 3)},
            'elapsed_s': round(res.elapsed_s, 1),
        }), flush=True)

    sys.exit(1 if failures else 0)


if __name__ == '__main__':
    main()

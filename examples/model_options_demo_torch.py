#!/usr/bin/env python
"""Tour of every model option through the PyTorch port (victor_tpu_torch).

The counterpart of examples/model_options_demo.py: evaluates the
likelihood under each RSD mapping, matter model, velocity-mean model, AP
handling mode and likelihood form, printing chi2 so the effect of each
switch is visible, on the shipped BOSS DR12 CMASS data (its `.npz` copies
where h5py is absent). Every `CCFFit` is built on `--device` in f64; one
call is one parameter point.

Run from the repository root:
    python examples/model_options_demo_torch.py [--device cuda|cpu]
Without a card the default `--device cuda` exits 2: pass `--device cpu`.
"""

import argparse
import copy
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tools'))
from _torch_common import load_config, require_device  # noqa: E402


def show(fit, label, params, **kw):
    """Print one option's chi2 and lnL; returns (label, lnL, chi2), or
    (label, None, None) after printing the error in brackets."""
    try:
        lnl, chi2 = fit.log_likelihood(params, **kw)
        print(f'  {label:52s} chi2 = {chi2:9.2f}  lnL = {lnl:8.2f}')
        return label, lnl, chi2
    except Exception as e:  # noqa: BLE001 - demo robustness
        print(f'  {label:52s} [{type(e).__name__}: {e}]')
        return label, None, None


def main(argv=None):
    """Print the tour; returns its (label, lnL, chi2) rows in order."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    require_device(args.device, 'model_options_demo_torch')

    from victor_tpu_torch import CCFFit

    cfg = load_config('boss_config.yaml')
    fit = CCFFit(cfg['model'], cfg['data'], device=args.device)
    p = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
    rows = []

    print('RSD models (victor/ccf_model.py:649-784):')
    rows.append(show(fit, 'streaming (Gaussian streaming model)', p))
    rows.append(show(fit, 'dispersion (change-of-variables streaming)', p,
                     rsd_model='dispersion'))
    rows.append(show(fit, 'kaiser', p, rsd_model='kaiser'))
    rows.append(show(fit, 'kaiser + approximation', p, rsd_model='kaiser',
                     kaiser_approximation=True))
    rows.append(show(fit, 'kaiser without coordinate shift (Hamaus-style)',
                     p, rsd_model='kaiser', kaiser_coord_shift=False))
    rows.append(show(fit, 'kaiser with M/Q nuisances',
                     {**p, 'M': 1.1, 'Q': 0.9}, rsd_model='kaiser'))
    rows.append(show(fit, 'euclid_special', p, rsd_model='euclid_special'))

    print('\nVelocity options (victor/ccf_model.py:385-492):')
    rows.append(show(fit, 'linear continuity equation', p))
    rows.append(show(fit, 'empirical correction (1 + A_v delta)',
                     {**p, 'Av': 0.5}, empirical_corr=True))
    rows.append(show(fit, 'anisotropic real-space input', p,
                     assume_isotropic=False))

    print('\nAP handling (victor/ccf_model.py:589-613):')
    rows.append(show(fit, 'epsilon (+alpha) parameterisation', p))
    rows.append(show(fit, '(aperp, apar) parameterisation',
                     {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0,
                      'aperp': 1.0, 'apar': 1.0}))
    rows.append(show(fit, 'AP-independent rescaling via astar',
                     {**p, 'astar': 1.0}, velocity_independent_of_AP=True))

    print('\nLikelihood forms (victor/ccf_fit.py:415-473):')
    for form in ['gaussian', 'hartlap', 'sellentin', 'percival']:
        rows.append(show(fit, form, p, form=form))
    rows.append(show(fit, 'likelihood-level beta interpolation', p,
                     beta_interpolation='likelihood'))

    print('\nExcursion-set matter model (victor/excursion_set_profile.py, '
          'Eisenstein-Hu mode):')
    esm_cfg = copy.deepcopy(cfg)
    esm_cfg['model']['matter_ccf'] = {
        'model': 'excursion_set',
        'excursion_set_options': {'use_eisenstein_hu': True}}
    esm_fit = CCFFit(esm_cfg['model'], esm_cfg['data'], device=args.device)
    esm_p = {'f': 0.778, 'sigma_8_0': 0.81, 'b10': -1.544, 'b01': -4.228,
             'Rp': 7.973, 'Rx': 0.467, 'beta': 0.37, 'sigma_v': 380.0,
             'epsilon': 1.0}
    rows.append(show(esm_fit, 'excursion_set matter + linear velocity',
                     esm_p))
    rows.append(show(esm_fit,
                     'excursion_set + nonlinear velocity (intended impl)',
                     esm_p, mean_model='nonlinear'))
    return rows


if __name__ == '__main__':
    main()

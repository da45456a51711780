#!/usr/bin/env python
"""Author (and optionally execute) the demo notebooks of the PyTorch port.

The counterpart of tools/make_notebooks.py: builds
`victor_tpu_torch_usage_demo.ipynb` and `model_options_demo_torch.ipynb`
programmatically (nbformat) with the same cells as the original's, every
call going through victor_tpu_torch on `DEVICE` (the `--device` given
here, default cuda), in f64, reading the BOSS data's `.npz` copies where
h5py is absent. Without `--no-execute` each notebook is executed in place
(nbclient) from the repository root, so that the written file holds the
outputs of a real run; that needs nbclient and matplotlib (and h5py for the
Hamaus et al. cell's example data) beside the card.

Usage:  python tools/make_notebooks_torch.py [--out notebooks/]
            [--no-execute] [--device cuda|cpu]
`--device` is only the `DEVICE` written into the cells: authoring with
`--no-execute` needs no card. Executing with the default `--device cuda`
exits 2 without a card: pass `--device cpu`.
"""

import argparse
import os
import sys

import nbformat as nbf

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_common import REPO, require_device  # noqa: E402

NOTEBOOKS = ('victor_tpu_torch_usage_demo', 'model_options_demo_torch')

PRELUDE = '''\
import os, sys, warnings
sys.path.insert(0, os.getcwd())          # repository root
sys.path.insert(0, os.path.join(os.getcwd(), 'tools'))
warnings.filterwarnings('ignore')
import numpy as np
import yaml
import matplotlib
import matplotlib.pyplot as plt
%matplotlib inline
import torch
from victor_tpu_torch.utils.profiling import enable_persistent_cache
enable_persistent_cache()
from _torch_common import load_config     # the .npz data where h5py is absent
DEVICE = {device!r}
print('device:', torch.cuda.get_device_name()
      if torch.device(DEVICE).type == 'cuda' else 'cpu')

cfg = load_config('boss_config.yaml')
'''


def usage_notebook(device):
    nb = nbf.v4.new_notebook()
    c = nb.cells
    md = lambda s: c.append(nbf.v4.new_markdown_cell(s))  # noqa: E731
    code = lambda s: c.append(nbf.v4.new_code_cell(s))    # noqa: E731

    md('# victor_tpu_torch usage demo\n\n'
       'End-to-end walkthrough of the void–galaxy cross-correlation '
       'framework on its PyTorch/CUDA port, mirroring the role of the '
       'reference package\'s `victor_usage_demo.ipynb`: build a `CCFFit` '
       'from the shipped BOSS DR12 CMASS data, evaluate the theory and '
       'likelihood under each RSD model (the notebook cell-22 '
       'checkpoints), plot the model against the data, measure batched '
       'throughput, and run a full posterior on the card.\n\n'
       'Every call below runs on `DEVICE` (an NVIDIA GPU by default) in '
       'float64; outputs are captured from a real run.')
    code(PRELUDE.format(device=device))

    md('## Build the fit\n\nThe constructor ingests the reference YAML '
       'schema unchanged, precomputes every table the likelihood needs on '
       'the host and moves them to `DEVICE` once.')
    code('''\
from victor_tpu_torch import CCFFit
import time
t0 = time.time()
fit = CCFFit(cfg['model'], cfg['data'], device=DEVICE)
print(f'CCFFit ready in {time.time() - t0:.1f} s '
      f'(s bins: {len(fit.s)}, multipoles: {fit.poles_s})')''')

    md('## Likelihood checkpoints\n\nThe five `victor_usage_demo.ipynb` '
       'cell-22 values. Expected: streaming 65.01/284.76, dispersion '
       '65.03/284.76, kaiser 103.90/266.81, anisotropic 64.39/285.06, '
       'likelihood-level β-interpolation 64.80/285.30.')
    code('''\
params = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
checks = [('streaming', {}),
          ('dispersion', {'rsd_model': 'dispersion'}),
          ('kaiser', {'rsd_model': 'kaiser'}),
          ('streaming anisotropic', {'assume_isotropic': False}),
          ('beta-interp at likelihood level',
           {'beta_interpolation': 'likelihood'})]
for label, kw in checks:
    lnl, chi2 = fit.log_likelihood(params, **kw)
    print(f'{label:34s} chi2 = {chi2:7.2f}   lnL = {lnl:7.2f}')''')

    md('## Theory vs data: multipoles\n\nBest-fit-ish model multipoles over '
       'the measured data points with diagonal errors.')
    code('''\
mult = fit.theory_multipoles(fit.s, params, poles=[0, 2])
data = fit.multipole_datavector(params['beta']).reshape(2, -1)
err = fit.diagonal_errors(params['beta'])
figure, ax = plt.subplots(figsize=(7, 4.5))
colors = {'0': '#2e6fb7', '2': '#d97a07'}
for i, ell in enumerate(['0', '2']):
    ax.errorbar(fit.s, data[i], yerr=err[i], fmt='o', ms=4, lw=1,
                color=colors[ell], alpha=0.75)
    ax.plot(fit.s, mult[ell], color=colors[ell],
            ls='-' if ell == '0' else '--',
            label=f'$\\\\ell={ell}$ (model)')
ax.axhline(0.0, color='0.8', lw=0.8, zorder=0)
ax.set_xlabel('$s$ [$h^{-1}$ Mpc]')
ax.set_ylabel(r'$\\xi_\\ell(s)$')
ax.legend(frameon=False)
ax.set_title('BOSS DR12 CMASS void-galaxy CCF: model vs data')
plt.tight_layout(); plt.show()''')

    md('## 2D cross-correlation\n\n`plot_2D_ccf` reproduces the reference '
       'plotting convention (mirrored quadrants, shifted diverging '
       'colormap centred on ξ=0).')
    code('''\
from victor_tpu_torch.plottools import plot_2D_ccf
xi2d = fit.theory_xi_2D(params, rmax=80)
plot_2D_ccf(xi2d, np.linspace(1, 79, 40), vmin=-0.85, vmax=0.25,
            contours=[-0.6, -0.3, -0.1, 0.0])
plt.show()''')

    md('## Batched throughput\n\nThe likelihood runs batched: every '
       'parameter point is a row of one batch, evaluated in chunks of 64, '
       'its spline lookups in the hand-written CUDA kernel. (The reference '
       'package evaluates ~11.8/s on one CPU core; every timed repetition '
       'below copies its result back to the host.)')
    code('''\
from victor_tpu_torch.likelihood.batched import make_batched_loglike
batched = make_batched_loglike(
    fit.bundle, ['fsigma8', 'beta', 'sigma_v', 'epsilon'], chunk=64)
n = 16384 if torch.device(DEVICE).type == 'cuda' else 256
rng = np.random.default_rng(0)
theta = torch.as_tensor(np.column_stack([
    rng.uniform(0.3, 0.6, n), rng.uniform(0.25, 0.55, n),
    rng.uniform(250, 450, n), rng.uniform(0.9, 1.1, n)]), device=DEVICE)
batched(theta)[0].cpu()                            # warm-up
t0 = time.perf_counter(); reps = 3
for _ in range(reps):
    batched(theta)[0].cpu()                        # copied back per rep
rate = reps * n / (time.perf_counter() - t0)
print(f'{rate:,.0f} likelihood evals/s  '
      f'(= {rate / 11.8:,.0f}x the reference CPU)')''')

    md('## Posterior sampling on the card\n\nDense-mass HMC over the four '
       'BOSS parameters — the `cobaya-run` equivalent. The same call '
       'accepts `mesh=` to shard its likelihood batches across the '
       'visible cards.')
    code('''\
from victor_tpu_torch.sampling import run_hmc_mcmc
block = yaml.safe_load(open('configs/boss_sampling_config.yaml'))['params']
res = run_hmc_mcmc(fit.bundle, block, n_chains=8, n_warmup=300,
                   n_samples=800, seed=0, device=DEVICE)
for name, st in res.summary().items():
    print(f'{name:10s} = {st["mean"]:.4f} +/- {st["std"]:.4f}   '
          f'(R-1 = {st["rhat"] - 1:.4f})')''')

    md('## Posterior corner\n\nMarginals and the fσ8–ε plane from the chain '
       '(validated elsewhere against a 1.7M-evaluation grid quadrature, '
       '`tools/validate_posterior_torch.py`).')
    code('''\
chain = res.chain.reshape(-1, res.chain.shape[-1])
names = [p.name for p in res.space.sampled]
i_f, i_e = names.index('fsigma8'), names.index('epsilon')
figure, axes = plt.subplots(1, 3, figsize=(11, 3.4))
axes[0].hist(chain[:, i_f], bins=40, color='#2e6fb7', alpha=0.85)
axes[0].set_xlabel(r'$f\\sigma_8$'); axes[0].set_yticks([])
axes[1].hist(chain[:, i_e], bins=40, color='#2e6fb7', alpha=0.85)
axes[1].set_xlabel(r'$\\epsilon$'); axes[1].set_yticks([])
axes[2].hexbin(chain[:, i_f], chain[:, i_e], gridsize=35, cmap='Blues')
axes[2].set_xlabel(r'$f\\sigma_8$'); axes[2].set_ylabel(r'$\\epsilon$')
plt.tight_layout(); plt.show()''')

    md('## Point estimation, forecasting, and evidence\n\n'
       'The estimation layer on top of the likelihood: multi-start MAP '
       'with Laplace errors (`find_map`), a Fisher forecast from the exact '
       'residual Jacobian (`fisher_forecast` — no sampling), the free '
       'prior-box-truncated Laplace evidence cross-check, and the tempered-'
       'SMC evidence (`run_smc`). CLI equivalents (`python -m '
       'victor_tpu_torch`): `fit`, `forecast`, `run --sampler smc`, and '
       '`analyze` for all of it in one command.')
    code('''\
from victor_tpu_torch.sampling import find_map, fisher_forecast, run_smc
m = find_map(fit.bundle, block, n_starts=16, seed=0, device=DEVICE)
fr = fisher_forecast(fit.bundle, m.params, [p.name for p in m.space.sampled])
print(f'MAP: chi2 = {m.chi2:.2f}  |grad| = {m.grad_norm:.1e}')
for name, st in m.summary().items():
    print(f'  {name:10s} = {st["value"]:9.4f} +/- {st["std"]:.4f} (Laplace)'
          f'   sigma_Fisher = {fr.std[name]:.4f}')
smc = run_smc(fit.bundle, block, n_particles=4096, n_moves=8, seed=1,
              device=DEVICE)
print(f'log-evidence: SMC {smc.logz:.3f} +/- {smc.logz_se:.3f}   '
      f'Laplace cross-check {m.log_evidence_laplace:.3f}   '
      f'(grid-quadrature truth 278.967)')''')

    md('The chain quantifies the BOSS DR12 CMASS void-galaxy RSD '
       'measurement: fσ8 ≈ 0.57 ± 0.05 and ε ≈ 1.009 ± 0.011 (cf. '
       'BASELINE.md for the cross-validated numbers). See '
       '`model_options_demo_torch.ipynb` for the full model-option tour '
       'and `examples/inference_demo_torch.py` for MAP/profile-likelihood/'
       'evidence workflows.')
    return nb


def options_notebook(device):
    nb = nbf.v4.new_notebook()
    c = nb.cells
    md = lambda s: c.append(nbf.v4.new_markdown_cell(s))  # noqa: E731
    code = lambda s: c.append(nbf.v4.new_code_cell(s))    # noqa: E731

    md('# victor_tpu_torch model options demo\n\n'
       'A tour of every model switch (the `model_options_demo.ipynb` '
       'equivalent) on the PyTorch/CUDA port: each RSD mapping, velocity '
       'option, AP handling mode, likelihood form, and the excursion-set '
       'matter model, with χ² printed so the effect of each option is '
       'visible on the shipped BOSS DR12 CMASS data.')
    code(PRELUDE.format(device=device))
    code('''\
from victor_tpu_torch import CCFFit
fit = CCFFit(cfg['model'], cfg['data'], device=DEVICE)
p = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}

def show(f, label, params, **kw):
    lnl, chi2 = f.log_likelihood(params, **kw)
    print(f'  {label:52s} chi2 = {chi2:9.2f}  lnL = {lnl:8.2f}')''')

    md('## RSD models\n\nThe four redshift-space mappings '
       '(victor/ccf_model.py:649-784), including the kaiser nuisance and '
       'approximation toggles.')
    code('''\
show(fit, 'streaming (Gaussian streaming model)', p)
show(fit, 'dispersion (change-of-variables streaming)', p,
     rsd_model='dispersion')
show(fit, 'dispersion, opt-in fast final stage', p,
     rsd_model='dispersion', dispersion_final='fast')
show(fit, 'kaiser', p, rsd_model='kaiser')
show(fit, 'kaiser + approximation', p, rsd_model='kaiser',
     kaiser_approximation=True)
show(fit, 'kaiser without coordinate shift (Hamaus-style)', p,
     rsd_model='kaiser', kaiser_coord_shift=False)
show(fit, 'kaiser with M/Q nuisances', {**p, 'M': 1.1, 'Q': 0.9},
     rsd_model='kaiser')
show(fit, 'euclid_special', p, rsd_model='euclid_special')''')

    md('## Velocity options')
    code('''\
show(fit, 'linear continuity equation', p)
show(fit, 'empirical correction (1 + A_v delta)', {**p, 'Av': 0.5},
     empirical_corr=True)
show(fit, 'anisotropic real-space input', p, assume_isotropic=False)''')

    md('## Alcock-Paczynski handling')
    code('''\
show(fit, 'epsilon (+alpha) parameterisation', p)
show(fit, '(aperp, apar) parameterisation',
     {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0,
      'aperp': 1.0, 'apar': 1.0})
show(fit, 'AP-independent rescaling via astar',
     {**p, 'astar': 1.0}, velocity_independent_of_AP=True)''')

    md('## Likelihood forms\n\nGaussian, Hartlap- and Percival-corrected, '
       'and the Sellentin-Heavens t-form (the BOSS default here), plus '
       'likelihood-level β interpolation.')
    code('''\
for form in ['gaussian', 'hartlap', 'sellentin', 'percival']:
    show(fit, form, p, form=form)
show(fit, 'likelihood-level beta interpolation', p,
     beta_interpolation='likelihood')''')

    md('## Excursion-set matter model\n\nThe differentiable excursion-set '
       'pipeline on the card (Eisenstein-Hu mode; a pregenerated CAMB '
       'table via `pk_table_file` is the alternative).')
    code('''\
import copy
esm_cfg = copy.deepcopy(cfg)
esm_cfg['model']['matter_ccf'] = {
    'model': 'excursion_set',
    'excursion_set_options': {'use_eisenstein_hu': True}}
esm_fit = CCFFit(esm_cfg['model'], esm_cfg['data'], device=DEVICE)
esm_p = {'f': 0.778, 'sigma_8_0': 0.81, 'b10': -1.544, 'b01': -4.228,
         'Rp': 7.973, 'Rx': 0.467, 'beta': 0.37, 'sigma_v': 380.0,
         'epsilon': 1.0}
show(esm_fit, 'excursion_set matter + linear velocity', esm_p)
show(esm_fit, 'excursion_set + nonlinear velocity (intended impl)',
     esm_p, mean_model='nonlinear')''')

    md('## Reproducing Hamaus et al. (2020) Figure 5\n\n'
       'The reference notebook (`model_options_demo.ipynb` cells 22-24) '
       'reproduces the "approximate Kaiser" curves of Figure 5 of '
       '[Hamaus et al. 2020](https://arxiv.org/abs/2007.07895) from the '
       'example void model (distances in units of the void radius $R_v$), '
       'using the reported best-fit values $\\beta=0.347$, '
       '$\\epsilon=1.0058$, $\\mathcal{M}=1.138$, $\\mathcal{Q}=1.22$ with '
       '`matter_model: linear_bias` — the only *external* cross-check in '
       'the reference.\n\n'
       'One reproduction note: the stored reference output predates the '
       'current reference code, under which this beta-only call raises '
       '`KeyError: fsigma8` (`velocity_terms` at ccf_model.py:432 divides '
       '`fsigma8` by `template_sigma8` whenever `from_data` is False). The '
       'equivalent computation passes `fsigma8 = beta * bias * '
       'template_sigma8`, which makes the growth term exactly '
       '$\\beta\\,b$ — the published parameterisation. The example model '
       'is read from `data/example_data/example_void_model.hdf5` (h5py).')
    code('''\
import copy
with open('configs/example_model_input.yaml') as f:
    ex_model = yaml.safe_load(f)['model']
ex_model['dir'] = os.getcwd()
ex_model['matter_ccf']['model'] = 'linear_bias'
bias, s8t = (ex_model['matter_ccf']['bias'],
             ex_model['matter_ccf']['template_sigma8'])

from victor_tpu_torch import CCFModel
ex = CCFModel(ex_model, device=DEVICE)
hamaus = {'beta': 0.347, 'epsilon': 1.0058, 'M': 1.138, 'Q': 1.22,
          'fsigma8': 0.347 * bias * s8t}   # growth term = beta * b exactly
variants = [
    ('full Kaiser', {}),
    ('approx Kaiser', {'kaiser_approximation': True}),
    ('approx Kaiser + approx coords',
     {'kaiser_approximation': True, 'kaiser_coord_shift': False}),
]
s = np.linspace(0.01, 3, 100)
fig, axes = plt.subplots(1, 3, figsize=(18, 5))
for label, opts in variants:
    m = ex.theory_multipoles(s, dict(hamaus), poles=(0, 2, 4),
                             rsd_model='kaiser', **opts)
    for ax, ell in zip(axes, ('0', '2', '4')):
        ax.plot(s, m[ell], label=label)
for ax, name in zip(axes, ['Monopole $\\\\xi^s_0$',
                           'Quadrupole $\\\\xi^s_2$',
                           'Hexadecapole $\\\\xi^s_4$']):
    ax.set_xlabel('$s/R_v$'); ax.set_ylabel(name); ax.grid()
axes[0].legend(loc='lower right'); axes[1].legend(loc='upper right')
axes[2].legend(loc='upper right')
plt.tight_layout(w_pad=3)
q05 = {label: float(np.interp(0.5, s,
           np.asarray(ex.theory_multipoles(s, dict(hamaus), poles=(2,),
                      rsd_model='kaiser', **opts)['2'])))
       for label, opts in variants}
print('quadrupole at s = 0.5 R_v:', {k: round(v, 4) for k, v in q05.items()})''')
    md('The discriminator is the quadrupole at $s\\sim0.5R_v$: only '
       '"approx Kaiser + approx coords" is **positive** there '
       '(+0.039, vs -0.009 approx / -0.026 full), matching the published '
       'Figure 5 — which is how the reference notebook concludes that '
       'Hamaus et al. did not apply the full coordinate shift (their '
       'Eq. 3.8 as written), and that the approximation itself is poor. '
       '`kaiser_coord_shift: False` exists precisely to match such '
       'previous-paper results.')

    md('Every option above is held against the reference implementation '
       'on the CPU in float64 by the port\'s test suite '
       '(`tests/test_torch_models.py`, `tests/test_torch_api.py`, '
       '`tests/test_torch_examples.py`), and on the card by '
       '`chip_smoke.py`.')
    return nb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default=os.path.join(REPO, 'notebooks'))
    ap.add_argument('--no-execute', action='store_true')
    ap.add_argument('--device', default='cuda',
                    help="the notebooks' DEVICE: 'cuda' (the default) or "
                         "'cpu'")
    args = ap.parse_args(argv)
    if not args.no_execute:
        require_device(args.device, 'make_notebooks_torch')
    os.makedirs(args.out, exist_ok=True)

    written = []
    for name, build in zip(NOTEBOOKS, (usage_notebook, options_notebook)):
        nb = build(args.device)
        path = os.path.join(args.out, f'{name}.ipynb')
        if not args.no_execute:
            from nbclient import NotebookClient
            print(f'executing {name} ...', flush=True)
            client = NotebookClient(nb, timeout=1800,
                                    resources={'metadata': {'path': REPO}})
            client.execute()
        nbf.write(nb, path)
        print(f'wrote {path}')
        written.append(path)
    return written


if __name__ == '__main__':
    main()

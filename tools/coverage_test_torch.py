#!/usr/bin/env python
"""Parameter-recovery (coverage) validation with synthetic data, through
the PyTorch port (victor_tpu_torch) on the card.

The counterpart of tools/coverage_test.py. Draws N mock data vectors
d_k = t(theta_fid) + L xi_k (L = Cholesky factor of the covariance at the
fiducial beta; xi_k from numpy's default_rng(--seed), exactly as the JAX
tool draws them, so both packages fit the very same mock vectors), refits
every mock and checks that the pulls (theta_hat - theta_fid)/sigma are
standard normal and that the nominal 68% intervals cover at the nominal
rate: an end-to-end statistical calibration of the likelihood, the
optimizer and the error bars together.

Methods: map (MAP + Laplace pulls; --beta-profile adds per-mock
delta-chi2=1 profile intervals for beta, --debias N the parametric-bootstrap
correction), smc, ns, mh and ensemble (per-mock posteriors, central 68%
credible intervals, posterior-mean pulls) and sbc (simulation-based
calibration: prior-drawn truths, rank uniformity). Models: template (the
4-param BOSS fit), dispersion, kaiser, euclid_special (sigma_v dropped:
those mappings never read it), esm (9 params) and joint (5-param
2-quantile fit with a correlated cross-covariance).

The port's samplers and find_map's starts draw from a torch.Generator, so
every run here is a realisation of its own; compare it with victor_tpu's
recorded calibration statistically. victor_tpu's results (BASELINE.md):
60 mocks, map, gaussian: fsigma8 / sigma_v / epsilon pull stds
1.03 / 1.04 / 0.94, overall 68.3% coverage 66.7 +/- 3.0%; beta's Laplace
pulls heavy-tailed BY CONSTRUCTION (the data template's beta-grid spacing
~0.01 is comparable to sigma(beta) ~0.007: pull std 2.86 at 200 mocks);
smc, 100 mocks: coverage fsigma8 70%, beta 65%, sigma_v 71%, epsilon 72%
(binomial sigma 4.7%).

Usage:  python tools/coverage_test_torch.py [--mocks 100] [--form gaussian]
            [--model template] [--method map] [--device cuda]
        python tools/coverage_test_torch.py --mocks 60
        python tools/coverage_test_torch.py --method smc --mocks 20
Prints the JAX tool's lines.
"""

import argparse
import copy
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_common import REPO, load_config, require_device  # noqa: E402

sys.path.insert(0, REPO)
from victor_tpu_torch.io import build_tables  # noqa: E402
from victor_tpu_torch.likelihood.multiquantile import (  # noqa: E402
    JointBundle, build_joint_tables)
# one implementation for every mock consumer (this tool AND the
# parametric-bootstrap debiasing): victor_tpu_torch.sampling.mocks
from victor_tpu_torch.sampling.mocks import mock_setup as _mock_setup  # noqa: E402
from victor_tpu_torch.sampling.mocks import shift_datavector  # noqa: E402

FIDUCIAL = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}

PARAMS_BLOCK = {
    'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
             'ref': {'dist': 'norm', 'loc': 0.37, 'scale': 0.03}},
    'sigma_v': {'prior': {'dist': 'uniform', 'min': 100.0, 'max': 500.0},
                'ref': {'dist': 'norm', 'loc': 380.0, 'scale': 30.0}},
    'epsilon': {'prior': {'dist': 'uniform', 'min': 0.8, 'max': 1.2},
                'ref': {'dist': 'norm', 'loc': 1.0, 'scale': 0.02}},
}


def mock_bundles(bundle, fiducial, n_mocks, seed):
    """(mock vector, bundle holding it) for each of `n_mocks` mocks: one
    mock_setup and one numpy stream default_rng(seed), shared by every
    method (the calibrations are only comparable if the mock draws are
    identical). The stored data vector is shifted so that AT the fiducial
    beta it equals the mock (the beta-dependence of the template is
    kept)."""
    tvec, dvec, L = _mock_setup(bundle, fiducial)
    rng = np.random.default_rng(seed)
    for _ in range(n_mocks):
        mock = tvec + L @ rng.standard_normal(len(tvec))
        yield mock, shift_datavector(bundle, mock - dvec)


def run_coverage(bundle, n_mocks=100, seed=0, form='gaussian',
                 fiducial=FIDUCIAL, params_block=PARAMS_BLOCK,
                 n_starts=4, adam_steps=120, newton_steps=6,
                 beta_profile=False, debias=0, device='cuda'):
    """Returns (pulls (n_mocks, ndim), hit68 fraction, names,
    beta_intervals): beta_intervals is an (n_mocks, 2) array of per-mock
    delta-chi2=1 profile intervals for beta when beta_profile=True, else
    None. `debias` > 0 applies the parametric-bootstrap correction
    (`debias` refits per mock): pulls use the debiased estimate over the
    bootstrap sigma."""
    from victor_tpu_torch.sampling.optimize import (find_map,
                                                    parametric_bootstrap,
                                                    profile_scan)

    fit_kw = {'form': form}
    names = [n for n in params_block]
    pulls = np.empty((n_mocks, len(names)))
    beta_iv = np.empty((n_mocks, 2)) if beta_profile else None
    for k, (_, mb) in enumerate(mock_bundles(bundle, fiducial, n_mocks,
                                             seed)):
        res = find_map(mb, params_block, n_starts=n_starts,
                       adam_steps=adam_steps, newton_steps=newton_steps,
                       seed=seed + k, fit_kw=fit_kw, device=device)
        if debias:
            bres = parametric_bootstrap(
                mb, params_block, res, n_boot=debias, n_starts=n_starts,
                adam_steps=adam_steps, newton_steps=newton_steps,
                seed=seed + 7919 * (k + 1), fit_kw=fit_kw, device=device)
            est, sd = bres.debiased, bres.std
        else:
            est, sd = res.params, res.std
        pulls[k] = [(est[n] - fiducial[n]) / max(sd[n], 1e-300)
                    for n in names]
        if beta_profile:
            # 25 points over +/-4 Laplace sigmas resolve the ~0.01 beta-grid
            # spacing ~4x; the delta-chi2=1 interval follows the per-mock
            # likelihood's wiggles that the Laplace sigma cannot
            prof = profile_scan(mb, params_block, 'beta', n_grid=25,
                                n_sigma=4.0, seed=seed + k, fit_kw=fit_kw,
                                map_result=res, device=device)
            lo, hi = prof.interval(1.0)
            # a nan crossing = delta-chi2 never reaches 1 on that side
            # within the scan window -> that side counts as covering, so the
            # printed profile coverage is an UPPER bound
            beta_iv[k] = [lo if np.isfinite(lo) else -np.inf,
                          hi if np.isfinite(hi) else np.inf]
    hit68 = float(np.mean(np.abs(pulls) < 1.0))
    return pulls, hit68, names, beta_iv


def _run_coverage_posterior(bundle, sample_fn, n_mocks, seed, fiducial,
                            params_block):
    """Shared posterior-coverage loop for the particle samplers:
    `sample_fn(mock_bundle, mock_seed)` returns any result with `.space` and
    equal-weight `.particles`; central 68% credible intervals are
    equal-weight particle quantiles, pulls are posterior-mean pulls in
    posterior-std units. Returns (pulls (n_mocks, ndim), cover68 (ndim,),
    names)."""
    names = [n for n in params_block]
    fid = np.array([fiducial[n] for n in names])
    pulls = np.empty((n_mocks, len(names)))
    hit = np.zeros((n_mocks, len(names)), dtype=bool)
    for k, (_, mb) in enumerate(mock_bundles(bundle, fiducial, n_mocks,
                                             seed)):
        res = sample_fn(mb, seed + k)
        order = [res.space.names.index(n) for n in names]
        p = res.particles[:, order]
        lo, hi = np.quantile(p, [0.1585, 0.8415], axis=0)
        hit[k] = (lo <= fid) & (fid <= hi)
        pulls[k] = (p.mean(axis=0) - fid) / p.std(axis=0)
    return pulls, hit.mean(axis=0), names


def run_coverage_smc(bundle, n_mocks=60, seed=0, form='gaussian',
                     fiducial=FIDUCIAL, params_block=PARAMS_BLOCK,
                     n_particles=2048, n_moves=6, chunk=64, device='cuda'):
    """Coverage of per-mock tempered-SMC posteriors (the recommended
    reporting path). Returns (pulls, cover68, names)."""
    from victor_tpu_torch.sampling.smc import run_smc

    def sample(mb, mock_seed):
        return run_smc(mb, params_block, n_particles=n_particles,
                       n_moves=n_moves, seed=mock_seed,
                       fit_kw={'form': form}, chunk=chunk, device=device)
    return _run_coverage_posterior(bundle, sample, n_mocks, seed,
                                   fiducial, params_block)


def run_coverage_ns(bundle, n_mocks=50, seed=0, form='gaussian',
                    fiducial=FIDUCIAL, params_block=PARAMS_BLOCK,
                    n_live=512, n_steps=24, chunk=64, dlogz=0.01,
                    n_batch=None, device='cuda'):
    """Coverage of the nested-sampling posterior path (run_nested).
    Returns (pulls, cover68, names)."""
    from victor_tpu_torch.sampling.nested import run_nested

    def sample(mb, mock_seed):
        return run_nested(mb, params_block, n_live=n_live, n_steps=n_steps,
                          seed=mock_seed, fit_kw={'form': form}, chunk=chunk,
                          dlogz=dlogz, n_batch=n_batch, device=device)
    return _run_coverage_posterior(bundle, sample, n_mocks, seed,
                                   fiducial, params_block)


class _Pooled:
    """An MCMCResult as the .space/.particles the shared loop consumes:
    the draws from `burn` on, chains pooled into equal-weight particles."""

    def __init__(self, res, burn=0):
        self.space = res.space
        self.particles = res.chain[burn:].reshape(-1, res.chain.shape[-1])


def run_coverage_mh(bundle, n_mocks=40, seed=0, form='gaussian',
                    fiducial=FIDUCIAL, params_block=PARAMS_BLOCK,
                    n_chains=8, n_warmup=500, n_samples=1500, device='cuda'):
    """Coverage of the random-walk-Metropolis posterior path
    (run_hmc_mcmc(algorithm='mh')): pooled post-warmup draws. Returns
    (pulls, cover68, names)."""
    from victor_tpu_torch.sampling import run_hmc_mcmc

    def sample(mb, mock_seed):
        return _Pooled(run_hmc_mcmc(
            mb, params_block, n_chains=n_chains, n_warmup=n_warmup,
            n_samples=n_samples, seed=mock_seed, algorithm='mh',
            segment_steps=n_warmup + n_samples, fit_kw={'form': form},
            device=device))
    return _run_coverage_posterior(bundle, sample, n_mocks, seed,
                                   fiducial, params_block)


def run_coverage_ensemble(bundle, n_mocks=40, seed=0, form='gaussian',
                          fiducial=FIDUCIAL, params_block=PARAMS_BLOCK,
                          n_walkers=64, max_steps=3000, burn_frac=0.4,
                          device='cuda'):
    """Coverage of the ensemble-sampler posterior path (run_mcmc, the
    differential-evolution move): pooled post-burn-in walker draws. Returns
    (pulls, cover68, names)."""
    from victor_tpu_torch.sampling import run_mcmc

    def sample(mb, mock_seed):
        res = run_mcmc(mb, params_block, n_walkers=n_walkers,
                       max_steps=max_steps, check_every=max_steps,
                       rhat_stop=0.0, seed=mock_seed, fit_kw={'form': form},
                       device=device)
        return _Pooled(res, int(len(res.chain) * burn_frac))
    return _run_coverage_posterior(bundle, sample, n_mocks, seed,
                                   fiducial, params_block)


# SBC parameter space: prior = generation distribution = the normals below
# (SBC requires them IDENTICAL), scaled to the posterior-typical region
SBC_BLOCK = {
    'fsigma8': {'prior': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'norm', 'loc': 0.37, 'scale': 0.03}},
    'sigma_v': {'prior': {'dist': 'norm', 'loc': 380.0, 'scale': 30.0}},
    'epsilon': {'prior': {'dist': 'norm', 'loc': 1.0, 'scale': 0.02}},
}


def run_sbc(bundle, n_mocks=100, seed=0, form='gaussian',
            params_block=None, n_particles=2048, n_moves=6, chunk=64,
            device='cuda'):
    """Simulation-based calibration (Talts et al. 2018, arXiv:1804.06788):
    per mock draw theta_k from the prior, simulate d_k ~ N(t(theta_k),
    C(beta_k)) (data vector AND covariance at the mock's own beta), sample
    the posterior with tempered SMC and record the fractional rank of
    theta_k in each marginal; uniform ranks = the prior, simulator,
    likelihood and sampler are self-consistent. Returns (ranks (n_mocks,
    ndim) in [0, 1], names)."""
    from victor_tpu_torch.sampling.smc import run_smc

    if form != 'gaussian':
        # the Gaussian simulator must equal the fitted likelihood for the
        # ranks to be uniform
        raise ValueError("run_sbc supports form='gaussian' only: the "
                         'Gaussian simulator must match the fitted '
                         'likelihood for ranks to be uniform')
    block = params_block or SBC_BLOCK
    names = list(block)
    for n in names:                      # SBC precondition, not a style check
        if block[n]['prior']['dist'] != 'norm':
            raise ValueError(
                'run_sbc draws generation parameters with numpy; priors '
                'must be norm so the draw matches ParamSpace.sample_prior '
                f"exactly (got {block[n]['prior']['dist']!r} for {n})")

    # beta draws must stay inside every beta grid the generative step
    # interpolates over (data, covariance and model-side grids); None for
    # beta-independent inputs
    if isinstance(bundle, JointBundle):
        tabs = [b.tables for b in bundle.bundles]
        extra = [] if bundle.beta_cov is None else [bundle.beta_cov]
    else:
        tabs, extra = [bundle.tables], []
    grids = extra + [g for t in tabs
                     for g in (getattr(t, 'beta_ccf', None),
                               getattr(t, 'beta_cov', None),
                               getattr(t, 'beta_grid', None))
                     if g is not None]
    blo = max((float(g[0]) for g in grids), default=-np.inf)
    bhi = min((float(g[-1]) for g in grids), default=np.inf)

    rng = np.random.default_rng(seed)
    ranks = np.empty((n_mocks, len(names)))
    for k in range(n_mocks):
        theta = {n: rng.normal(block[n]['prior']['loc'],
                               block[n]['prior']['scale']) for n in names}
        # fail loudly rather than clip (clipping breaks rank uniformity)
        if not blo < theta['beta'] < bhi:
            raise RuntimeError(
                f'mock {k}: beta draw {theta["beta"]:.4f} outside the '
                f'narrowest beta grid [{blo:.4f}, {bhi:.4f}]')
        tvec, dvec, L = _mock_setup(bundle, theta)
        mock = tvec + L @ rng.standard_normal(len(tvec))
        mb = shift_datavector(bundle, mock - dvec)
        res = run_smc(mb, block, n_particles=n_particles, n_moves=n_moves,
                      seed=seed + 1000 + k, fit_kw={'form': form},
                      chunk=chunk, device=device)
        order = [res.space.names.index(n) for n in names]
        p = res.particles[:, order]
        truth = np.array([theta[n] for n in names])
        ranks[k] = (p < truth[None, :]).mean(axis=0)
    return ranks, names


# Joint multi-quantile calibration space: cosmology/AP shared across the
# two quantiles, one dispersion amplitude per quantile (__q<i> overrides)
JOINT_FIDUCIAL = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v__q0': 380.0,
                  'sigma_v__q1': 380.0, 'epsilon': 1.0}

JOINT_PARAMS_BLOCK = {
    'fsigma8': PARAMS_BLOCK['fsigma8'],
    'beta': PARAMS_BLOCK['beta'],
    'sigma_v__q0': PARAMS_BLOCK['sigma_v'],
    'sigma_v__q1': PARAMS_BLOCK['sigma_v'],
    'epsilon': PARAMS_BLOCK['epsilon'],
}

SBC_BLOCK_JOINT = {
    'fsigma8': SBC_BLOCK['fsigma8'],
    'beta': SBC_BLOCK['beta'],
    'sigma_v__q0': SBC_BLOCK['sigma_v'],
    'sigma_v__q1': SBC_BLOCK['sigma_v'],
    'epsilon': SBC_BLOCK['epsilon'],
}


def build_joint_boss_bundle(rho=0.4, model_overrides=None, n_quantiles=2,
                            device='cuda'):
    """n-'quantile' JointBundle over the BOSS dataset with a beta-varying
    CORRELATED joint covariance kron(R, C(beta)), R the equicorrelated
    n x n correlation matrix (1-rho) I + rho 11^T (positive definite for
    -1/(n-1) < rho < 1). The cross-covariance is written as an `.npz` file
    (keys covmat and beta), which the port's loader reads without h5py, in
    a temporary directory removed once the tables are built.

    `model_overrides` (dict) is merged into every quantile's model block.
    For identical per-quantile residuals the joint chi2 is
    n * chi2_single / (1 + (n-1) rho)."""
    if not (-1.0 / (n_quantiles - 1) < rho < 1.0):
        raise ValueError(f'rho={rho} not PD for n_quantiles={n_quantiles}')
    cfg = load_config('boss_config.yaml')
    cfg['model'].update(model_overrides or {})
    single = build_tables(cfg['model'], cfg['data'], device='cpu')
    covs = single.tables.cov.numpy().astype(np.float64)     # (n_b, D, D)
    beta = single.tables.beta_cov.numpy().astype(np.float64)
    R = np.full((n_quantiles, n_quantiles), rho)
    np.fill_diagonal(R, 1.0)
    # kron over the quantile axis for every beta slice: (n_b, nD, nD)
    joint_cov = np.einsum('pq,bij->bpiqj', R, covs).reshape(
        len(beta), n_quantiles * covs.shape[1], n_quantiles * covs.shape[2])
    q = {'model': copy.deepcopy(cfg['model']),
         'data': {'redshift_space_ccf':
                  copy.deepcopy(cfg['data']['redshift_space_ccf']),
                  'dir': REPO}}
    with tempfile.TemporaryDirectory(prefix='victor_joint_cov_') as tmp:
        cov_fn = os.path.join(tmp, 'joint_cov.npz')
        np.savez(cov_fn, covmat=joint_cov, beta=beta)
        joint_cfg = {
            'quantiles': [copy.deepcopy(q) for _ in range(n_quantiles)],
            'covariance_matrix': {'data_file': cov_fn, 'cov_key': 'covmat',
                                  'fixed_beta': False, 'beta_key': 'beta'},
            'likelihood': {'form': 'gaussian', 'nmocks': 1000,
                           'nparams': 3 + n_quantiles},
        }
        return build_joint_tables(joint_cfg, device=device)


ESM_FIDUCIAL = {'f': 0.778, 'sigma_8_0': 0.81, 'b10': -1.544,
                'b01': -4.228, 'Rp': 7.973, 'Rx': 0.467, 'beta': 0.37,
                'sigma_v': 380.0, 'epsilon': 1.0}

# 9-dim SBC space for the excursion-set pipeline: normals around the ESM
# MAP neighbourhood, shape nuisances narrower than their degenerate
# likelihood widths (Rp/Rx positive at >9 sigma)
SBC_BLOCK_ESM = {
    'f': {'prior': {'dist': 'norm', 'loc': 0.778, 'scale': 0.05}},
    'sigma_8_0': {'prior': {'dist': 'norm', 'loc': 0.81, 'scale': 0.05}},
    'b10': {'prior': {'dist': 'norm', 'loc': -1.544, 'scale': 0.15}},
    'b01': {'prior': {'dist': 'norm', 'loc': -4.228, 'scale': 0.4}},
    'Rp': {'prior': {'dist': 'norm', 'loc': 7.973, 'scale': 0.3}},
    'Rx': {'prior': {'dist': 'norm', 'loc': 0.467, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'norm', 'loc': 0.37, 'scale': 0.03}},
    'sigma_v': {'prior': {'dist': 'norm', 'loc': 380.0, 'scale': 30.0}},
    'epsilon': {'prior': {'dist': 'norm', 'loc': 1.0, 'scale': 0.02}},
}


def load_model(model, device):
    """(bundle, params block, fiducial) of `--model`."""
    if model == 'esm':
        full = load_config('esm_sampling_config.yaml')
        bundle = build_tables(full['model'], full['data'], device=device)
        # the full cobaya-style block (latex keys are tolerated)
        return bundle, full['params'], ESM_FIDUCIAL
    if model == 'joint':
        return (build_joint_boss_bundle(device=device), JOINT_PARAMS_BLOCK,
                JOINT_FIDUCIAL)
    cfg = load_config('boss_config.yaml')
    if model != 'template':
        # same fit under another RSD mapping (dispersion runs the exact
        # final stage: the parity default, not the opt-in fast mode)
        cfg['model']['rsd_model'] = model
    bundle = build_tables(cfg['model'], cfg['data'], device=device)
    if model in ('kaiser', 'euclid_special'):
        # these mappings never read sigma_v: its "posterior" would be the
        # prior, so it is dropped from the calibration (3-parameter fit)
        return (bundle,
                {k: v for k, v in PARAMS_BLOCK.items() if k != 'sigma_v'},
                {k: v for k, v in FIDUCIAL.items() if k != 'sigma_v'})
    return bundle, PARAMS_BLOCK, FIDUCIAL


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--mocks', type=int, default=100)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--form', default='gaussian',
                    help='likelihood form for generation+fit (gaussian = '
                         'exactly calibrated; sellentin adds the t-tail)')
    ap.add_argument('--model', default='template',
                    choices=['template', 'dispersion', 'kaiser',
                             'euclid_special', 'esm', 'joint'],
                    help='template = 4-param BOSS fit (streaming RSD); '
                         'dispersion/kaiser/euclid_special = the same fit '
                         'under another RSD mapping; esm = 9-param '
                         'excursion-set pipeline; joint = 5-param 2-quantile '
                         'joint fit with a correlated cross-covariance and '
                         'per-quantile sigma_v__q<i> overrides')
    ap.add_argument('--beta-profile', action='store_true',
                    help='also measure beta coverage with per-mock '
                         'delta-chi2=1 profile intervals (the remedy for '
                         'the grid-structure-broken Laplace sigma)')
    ap.add_argument('--method', default='map',
                    choices=['map', 'smc', 'sbc', 'ns', 'mh', 'ensemble'],
                    help='map = MAP + Laplace pulls/intervals; smc = '
                         'per-mock tempered-SMC posteriors with central '
                         '68%% credible-interval coverage; sbc = '
                         'simulation-based calibration: prior-drawn truths, '
                         'posterior rank-uniformity (Talts et al. 2018); '
                         'ns = the smc calibration for the nested-sampling '
                         'posterior path (run_nested); mh = the same for '
                         'the random-walk-Metropolis chains '
                         '(run_hmc_mcmc(algorithm=mh))')
    ap.add_argument('--debias', type=int, default=0, metavar='N',
                    help='method=map only: apply the parametric-bootstrap '
                         'correction with N refits per mock (pulls use the '
                         'debiased estimate over the bootstrap sigma)')
    ap.add_argument('--particles', type=int, default=2048,
                    help='SMC particles per mock (method=smc)')
    ap.add_argument('--moves', type=int, default=6,
                    help='SMC mutation moves per stage (method=smc)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.beta_profile and args.method != 'map':
        ap.error('--beta-profile applies to --method map only (the smc/sbc '
                 'methods already characterise the beta marginal)')
    if args.debias and args.method != 'map':
        ap.error('--debias applies to --method map only (the posterior '
                 'methods are already calibrated without correction)')
    require_device(args.device, 'coverage_test_torch')

    bundle, block, fiducial = load_model(args.model, args.device)
    dev = {'device': args.device}

    if args.method == 'sbc':
        from scipy import stats
        sbc_block = {'esm': SBC_BLOCK_ESM,
                     'joint': SBC_BLOCK_JOINT}.get(args.model, SBC_BLOCK)
        if args.model in ('kaiser', 'euclid_special'):
            # sigma_v is not read by these mappings: a rank test on it
            # would be trivially uniform, not evidence
            sbc_block = {k: v for k, v in SBC_BLOCK.items()
                         if k != 'sigma_v'}
        ranks, names = run_sbc(
            bundle, n_mocks=args.mocks, seed=args.seed, form=args.form,
            params_block=sbc_block,
            n_particles=args.particles, n_moves=args.moves, **dev)
        print(f'{args.mocks} mocks, likelihood form = {args.form}, '
              f'method = sbc (fractional posterior ranks of prior-drawn '
              f'truths; uniform = self-consistent)')
        for i, n in enumerate(names):
            r = ranks[:, i]
            ks = stats.kstest(r, 'uniform')
            hist = np.histogram(r, bins=10, range=(0, 1))[0]
            print(f'  {n:8s} rank mean {r.mean():.3f} (U(0,1): 0.500 +/- '
                  f'{1 / np.sqrt(12 * len(r)):.3f})   '
                  f'KS p = {ks.pvalue:.3f}   10-bin: {hist.tolist()}')
        return

    if args.method in ('smc', 'ns', 'mh', 'ensemble'):
        kw = dict(n_mocks=args.mocks, seed=args.seed, form=args.form,
                  fiducial=fiducial, params_block=block, **dev)
        if args.method == 'ns':
            pulls, cover68, names = run_coverage_ns(bundle, **kw)
        elif args.method == 'mh':
            pulls, cover68, names = run_coverage_mh(bundle, **kw)
        elif args.method == 'ensemble':
            pulls, cover68, names = run_coverage_ensemble(bundle, **kw)
        else:
            pulls, cover68, names = run_coverage_smc(
                bundle, n_particles=args.particles, n_moves=args.moves, **kw)
        print(f'{args.mocks} mocks, likelihood form = {args.form}, '
              f'method = {args.method} (central 68% credible intervals)')
        bsig = 100 * np.sqrt(0.683 * 0.317 / len(pulls))
        for i, n in enumerate(names):
            p = pulls[:, i]
            print(f'  {n:8s} posterior-mean pull {p.mean():+6.3f} +/- '
                  f'{p.std() / np.sqrt(len(p)):.3f}   std {p.std():.3f}   '
                  f'central-68% coverage: {cover68[i] * 100:.0f}% '
                  f'(binomial sigma {bsig:.1f}%)')
        return

    pulls, hit68, names, beta_iv = run_coverage(
        bundle, n_mocks=args.mocks, seed=args.seed, form=args.form,
        fiducial=fiducial, params_block=block,
        beta_profile=args.beta_profile, debias=args.debias, **dev)
    print(f'{args.mocks} mocks, likelihood form = {args.form}'
          + (f', bootstrap-debiased (N={args.debias})' if args.debias
             else ''))
    for i, n in enumerate(names):
        p = pulls[:, i]
        print(f'  {n:8s} pull mean {p.mean():+6.3f} +/- '
              f'{p.std() / np.sqrt(len(p)):.3f}   std {p.std():.3f}   '
              f'|pull|<1: {np.mean(np.abs(p) < 1) * 100:.0f}%')
    # binomial sigma with n_mocks trials: the ndim pulls per mock share one
    # noise realization
    print(f'overall 68.3%-interval coverage: {hit68 * 100:.1f}% '
          f'(binomial sigma {100 * np.sqrt(0.683 * 0.317 / len(pulls)):.1f}%)')
    if beta_iv is not None:
        fb = fiducial['beta']
        cov_b = float(np.mean((beta_iv[:, 0] <= fb) & (fb <= beta_iv[:, 1])))
        widths = beta_iv[np.all(np.isfinite(beta_iv), axis=1)]
        half = (widths[:, 1] - widths[:, 0]) / 2 if len(widths) else [np.nan]
        trunc = float(np.mean(~np.isfinite(beta_iv).all(axis=1)))
        print(f'beta PROFILE-interval (delta-chi2=1) coverage: '
              f'{cov_b * 100:.1f}% '
              f'(binomial sigma {100 * np.sqrt(0.683 * 0.317 / len(beta_iv)):.1f}%); '
              f'median half-width {np.median(half):.4f}; '
              f'{trunc * 100:.0f}% of mocks truncated by the scan window '
              f'(those count as covering -> coverage is an upper bound)')


if __name__ == '__main__':
    main()

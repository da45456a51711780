"""The port's multi-quantile joint fit against victor_tpu's.

The fixtures of tests/test_multiquantile.py: two quantiles (both the BOSS
dataset) under a block-diagonal joint covariance, either the single
dataset's covariance at beta = 0.37 (fixed) or the block-diagonal stack of
its 31 x 60 x 60 beta-dependent covariance. Each package builds its own
JointBundle from the same config; the joint lnL and chi2 agree to 1e-9 at
the golden point and 20 seeded points, dense and factored, with per-quantile
overrides and with chunking.
"""

import copy

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victor_tpu.errors import InputError as JInputError
from victor_tpu.io import build_tables as jax_build_tables
from victor_tpu.likelihood import core as jlk
from victor_tpu.likelihood import multiquantile as jmq
from victor_tpu_torch.errors import InputError
from victor_tpu_torch.io.tables import build_tables
from victor_tpu_torch.likelihood import multiquantile as tmq
from victor_tpu_torch.likelihood.batched import make_batched_loglike

torch.set_num_threads(1)

NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon', 'sigma_v__q1']
GOLDEN = [0.47, 0.37, 380.0, 1.0, 380.0]
EXACT = {'streaming_eval': 'exact', 'beta_covariance': 'exact'}
FACTORED = {'streaming_eval': 'exact', 'beta_covariance': 'factored'}
SIGMA_300 = torch.tensor([300.0], dtype=torch.float64)


def golden_params():
    return {k: torch.tensor([v], dtype=torch.float64)
            for k, v in zip(NAMES[:4], GOLDEN)}


def points():
    rng = np.random.default_rng(17)
    n = 20
    seeded = np.column_stack([
        rng.uniform(0.3, 0.6, n), rng.uniform(0.25, 0.55, n),
        rng.uniform(250.0, 450.0, n), rng.uniform(0.9, 1.1, n),
        rng.uniform(250.0, 450.0, n)])
    return np.vstack([GOLDEN, seeded])


@pytest.fixture(scope='module')
def single(boss_config):
    return jax_build_tables(boss_config['model'], boss_config['data'])


@pytest.fixture(scope='module')
def joint_cfgs(boss_config, tmp_path_factory, single):
    """{'fixed': config, 'varying': config} as in test_multiquantile.py."""
    tmp = tmp_path_factory.mktemp('joint')
    cov1 = np.asarray(jlk.interpolated_covariance(
        single.tables, single.spec, jnp.asarray(0.37)))
    D = cov1.shape[0]
    fixed = np.zeros((2 * D, 2 * D))
    fixed[:D, :D] = fixed[D:, D:] = cov1
    covs = np.asarray(single.tables.cov)
    beta = np.asarray(single.tables.beta_cov)
    varying = np.zeros((len(beta), 2 * D, 2 * D))
    varying[:, :D, :D] = varying[:, D:, D:] = covs
    with h5py.File(tmp / 'fixed.hdf5', 'w') as f:
        f.create_dataset('covmat', data=fixed)
    with h5py.File(tmp / 'varying.hdf5', 'w') as f:
        f.create_dataset('covmat', data=varying)
        f.create_dataset('beta', data=beta)
    q = {'model': copy.deepcopy(boss_config['model']),
         'data': {'redshift_space_ccf':
                  copy.deepcopy(boss_config['data']['redshift_space_ccf']),
                  'dir': boss_config['data']['dir']}}
    base = {'quantiles': [copy.deepcopy(q), copy.deepcopy(q)],
            'likelihood': {'form': 'sellentin', 'nmocks': 1000,
                           'nparams': 4}}
    return {
        'fixed': {**base, 'covariance_matrix': {
            'data_file': str(tmp / 'fixed.hdf5'), 'cov_key': 'covmat',
            'fixed_beta': True}},
        'varying': {**base, 'covariance_matrix': {
            'data_file': str(tmp / 'varying.hdf5'), 'cov_key': 'covmat',
            'fixed_beta': False, 'beta_key': 'beta'}},
    }


@pytest.fixture(scope='module')
def bundles(joint_cfgs):
    return {k: (jmq.build_joint_tables(cfg),
                tmq.build_joint_tables(cfg, device='cpu'))
            for k, cfg in joint_cfgs.items()}


@pytest.mark.parametrize('cov,opts_kw', [('fixed', EXACT), ('varying', EXACT),
                                         ('varying', FACTORED)])
def test_joint_likelihood_matches_victor_tpu(bundles, cov, opts_kw):
    jb, tb = bundles[cov]
    theta = points()
    want = jmq.make_batched_joint_loglike(jb, NAMES, opts_kw=opts_kw,
                                          gradient_free=False)(
                                              jnp.asarray(theta))
    want = [np.asarray(w) for w in want]
    for chunk in (None, 8):
        got = tmq.make_batched_joint_loglike(tb, NAMES, opts_kw=opts_kw,
                                             chunk=chunk,
                                             gradient_free=False)(theta)
        for g, w in zip(got, want):
            assert g.shape == (len(theta),)
            assert np.isfinite(g.numpy()).all()
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-9)
    # the sigma_v__q1 override moves the value
    plain = tmq.joint_log_likelihood(tb, golden_params(), opts_kw)[1]
    over = tmq.joint_log_likelihood(
        tb, {**golden_params(), 'sigma_v__q1': SIGMA_300}, opts_kw)[1]
    assert abs(float(over) - float(plain)) > 1e-3


def test_joint_is_twice_the_single_dataset(bundles, boss_config):
    """Two copies of the data under a block-diagonal stack of the BOSS
    covariance: the joint chi2 is twice the single-dataset chi2, on the
    dense and on the factored path (the chip check of the same fact)."""
    tb = bundles['varying'][1]
    single = build_tables(boss_config['model'], boss_config['data'],
                          device='cpu')
    one = make_batched_loglike(single, NAMES[:4], opts_kw=EXACT,
                               gradient_free=False)([GOLDEN[:4]])[1]
    for kw in (EXACT, FACTORED):
        chi2 = tmq.make_batched_joint_loglike(tb, NAMES[:4], opts_kw=kw)(
            [GOLDEN[:4]])[1]
        np.testing.assert_allclose(float(chi2[0]), 2 * float(one[0]),
                                   rtol=1e-9)
    assert abs(float(one[0]) - 65.0118) < 1e-4


def test_default_modes_resolve_as_victor_tpu(bundles):
    """The default gradient-free maker resolves 'auto' to fast + factored:
    bit-identical to the explicit modes, and equal to victor_tpu's default
    to 1e-9."""
    jb, tb = bundles['varying']
    theta = points()[:4]
    got = tmq.make_batched_joint_loglike(tb, NAMES)(theta)[0]
    explicit = tmq.make_batched_joint_loglike(
        tb, NAMES, opts_kw={'streaming_eval': 'fast',
                            'dispersion_final': 'fast',
                            'beta_covariance': 'factored'})(theta)[0]
    assert torch.equal(got, explicit)
    want = np.asarray(jmq.make_batched_joint_loglike(jb, NAMES)(
        jnp.asarray(theta))[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)


def test_bad_quantile_index_raises(bundles):
    tb = bundles['fixed'][1]
    params = golden_params()
    for bad in ('sigma_v__q2', 'sigma_v__qx'):
        with pytest.raises(InputError, match='__q') as got:
            tmq.joint_chi_squared(tb, {**params, bad: SIGMA_300})
        with pytest.raises(JInputError) as want:
            jmq.joint_chi_squared(bundles['fixed'][0], {
                **{k: jnp.asarray(v) for k, v in zip(NAMES[:4], GOLDEN)},
                bad: jnp.asarray(300.0)})
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize('edit', ['no_data', 'likelihood_interp',
                                  'quantile_cov', 'no_cov', 'bad_shape'])
def test_build_errors_match(joint_cfgs, edit, tmp_path):
    cfg = copy.deepcopy(joint_cfgs['fixed'])
    if edit == 'no_data':
        del cfg['quantiles'][1]['data']
    elif edit == 'likelihood_interp':
        cfg['beta_interpolation'] = 'likelihood'
    elif edit == 'quantile_cov':
        cfg['quantiles'][0]['data']['covariance_matrix'] = \
            cfg['covariance_matrix']
    elif edit == 'no_cov':
        del cfg['covariance_matrix']
    else:
        with h5py.File(tmp_path / 'small.hdf5', 'w') as f:
            f.create_dataset('covmat', data=np.eye(60))
        cfg['covariance_matrix']['data_file'] = str(tmp_path / 'small.hdf5')
    with pytest.raises(JInputError) as want:
        jmq.build_joint_tables(cfg)
    with pytest.raises(InputError) as got:
        tmq.build_joint_tables(cfg, device='cpu')
    assert str(got.value) == str(want.value)


def test_likelihood_interpolation_refused_at_run_time(bundles):
    tb = bundles['fixed'][1]
    params = golden_params()
    with pytest.raises(InputError, match="'likelihood' is not supported"):
        tmq.joint_log_likelihood(tb, params,
                                 fit_kw={'beta_interpolation': 'likelihood'})

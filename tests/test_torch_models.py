"""The port's kaiser and euclid_special RSD models, the linear-bias matter
model, the template mean velocity, anisotropic real-space input and the
data-derived real-space mode against victor_tpu, plus the option axes of
tests/test_option_parity.py held against victor_tpu (not the upstream
reference). The excursion-set model is in test_torch_esm.py.

Both packages get identical tables (bundle_from_arrays of the JAX bundle's
leaves, on the CPU) and identical parameter points, in f64. Each
comparison runs the same algorithm on both sides, so only rounding differs:
1e-12 on xi(s, mu), 1e-9 on chi^2 and lnL.
"""

import ast
import copy
import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from victor_tpu.errors import InputError as JaxInputError
from victor_tpu.io import build_tables as jax_build_tables
from victor_tpu.likelihood import core as jlk
from victor_tpu.models import ccf_theory as jth
from victor_tpu_torch.errors import InputError
from victor_tpu_torch.io.tables import bundle_from_arrays, tables_to_arrays
from victor_tpu_torch.likelihood import core as tlk
from victor_tpu_torch.models import ccf_theory as tth
from victor_tpu_torch.ops import splines as tsp

from test_torch_kernels import _coeffs, _knots, _queries, _t

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
DISPLACED = {'fsigma8': 0.55, 'beta': 0.45, 'sigma_v': 320.0, 'epsilon': 1.05}
EXACT_DISP = {'rsd_model': 'dispersion', 'dispersion_interior': 'exact'}
XI_ATOL = 1e-12
LIKE_ATOL = 1e-9


def tp(*points):
    """Points (dicts) -> the port's params: a dict of (B,) tensors."""
    return {k: torch.tensor([p[k] for p in points], dtype=torch.float64)
            for k in points[0]}


def jp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def pair(model, data=None):
    """(victor_tpu bundle, the port's bundle of the same leaves on the CPU)."""
    jb = jax_build_tables(copy.deepcopy(model),
                          None if data is None else copy.deepcopy(data))
    tb = bundle_from_arrays(
        tables_to_arrays(jb.tables), dataclasses.asdict(jb.spec),
        dataclasses.asdict(jb.theory_opts),
        None if jb.fit_opts is None else dataclasses.asdict(jb.fit_opts),
        device='cpu')
    return jb, tb


def check_vs_jax(jb, tb, opts_kw, points, likelihood=True):
    """xi(s, mu) of a batch of points against one victor_tpu call per point
    (1e-12), and chi^2 / lnL likewise (1e-9)."""
    opts = tb.theory_opts.replace(**opts_kw)
    jopts = jb.theory_opts.replace(**opts_kw)
    # a model-only build has no data s bins: evaluate at the model's r
    s = None if tb.tables.s is not None else tb.tables.r
    got = tth.theory_xi_grid(tb.tables, tb.spec, opts, tp(*points), s=s)
    for i, p in enumerate(points):
        want = jth.theory_xi_grid(jb.tables, jb.spec, jopts, jp(p),
                                  s=None if s is None else jnp.asarray(s))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0,
                                   atol=XI_ATOL)
    if not likelihood:
        return got
    lnl, chi2 = tlk.log_likelihood(tb.tables, tb.spec, opts, tb.fit_opts,
                                   tp(*points))
    for i, p in enumerate(points):
        jl, jc = jlk.log_likelihood(jb.tables, jb.spec, jopts, jb.fit_opts,
                                    jp(p))
        assert abs(float(chi2[i]) - float(jc)) < LIKE_ATOL
        assert abs(float(lnl[i]) - float(jl)) < LIKE_ATOL
    return got


def _model_file(tmp_path, boss_config, extra=None, drop=()):
    """A copy of the BOSS model file, with `extra` datasets, minus `drop`."""
    src = os.path.join(REPO, boss_config['model']['input_model_data_file'])
    with h5py.File(src) as f:
        payload = {k: f[k][:] for k in f if k not in drop}
    fn = tmp_path / 'model.hdf5'
    with h5py.File(fn, 'w') as f:
        for k, v in {**payload, **(extra or {})}.items():
            f.create_dataset(k, data=v)
    return str(fn)


@pytest.fixture(scope='module')
def boss(boss_config):
    return pair(boss_config['model'], boss_config['data'])


@pytest.fixture(scope='module')
def linear_bias(boss_config):
    model = copy.deepcopy(boss_config['model'])
    model['matter_ccf'] = {'model': 'linear_bias', 'bias': 1.9,
                           'template_sigma8': 0.628}
    return pair(model, boss_config['data'])


@pytest.fixture(scope='module')
def from_data(boss_config):
    model = copy.deepcopy(boss_config['model'])
    model['realspace_ccf']['from_data'] = True
    model['matter_ccf'] = {'model': 'linear_bias', 'bias': 1.9}
    return pair(model, boss_config['data'])


def _template_mean_cfg(boss_config, tmp_path, z_sim):
    with h5py.File(os.path.join(REPO, boss_config['model']
                                ['input_model_data_file'])) as f:
        r = f['r'][:]
    vr = -120.0 * (r / 30.0) * np.exp(-r / 35.0)   # smooth outflow profile
    cfg = copy.deepcopy(boss_config)
    cfg['model']['input_model_data_file'] = _model_file(
        tmp_path, boss_config, {'rv': r, 'vr': vr})
    cfg['model']['dir'] = ''
    cfg['model']['velocity_pdf']['mean'] = {
        'model': 'template', 'template_fsigma8': 0.45, 'z_sim': z_sim,
        'template_hubble_ratio': 1.02, 'template_keys': ['rv', 'vr']}
    return cfg


@pytest.fixture(scope='module', params=[0.52, 0], ids=['z_sim', 'z_sim_zero'])
def template_mean(request, boss_config, tmp_path_factory):
    cfg = _template_mean_cfg(boss_config, tmp_path_factory.mktemp('vel'),
                             request.param)
    return pair(cfg['model'], cfg['data'])


# ---------------------------------------------------------------------------
# kaiser and euclid_special (victor/ccf_model.py:692-784)
# ---------------------------------------------------------------------------

MQ = {'M': 1.138, 'Q': 1.22}


@pytest.mark.parametrize('opts_kw,extra', [
    ({'rsd_model': 'kaiser'}, {}),
    ({'rsd_model': 'kaiser', 'kaiser_coord_shift': False}, {}),
    ({'rsd_model': 'kaiser', 'kaiser_approximation': True}, {}),
    ({'rsd_model': 'kaiser', 'kaiser_approximation': True,
      'kaiser_coord_shift': False}, MQ),
    ({'rsd_model': 'kaiser', 'niter': 2}, MQ),
    ({'rsd_model': 'kaiser', 'niter': 0, 'velocity_independent_of_AP': True},
     {**MQ, 'astar': 1.03}),
    ({'rsd_model': 'euclid_special'}, {}),
    ({'rsd_model': 'euclid_special', 'kaiser_coord_shift': False}, MQ),
], ids=['kaiser', 'no_shift', 'approx', 'approx_no_shift_MQ', 'niter2_MQ',
        'niter0_astar', 'euclid', 'euclid_no_shift_MQ'])
def test_kaiser_and_euclid_vs_jax(boss, opts_kw, extra):
    jb, tb = boss
    got = check_vs_jax(jb, tb, opts_kw,
                       [{**GOLDEN, **extra}, {**DISPLACED, **extra}])
    assert got.shape == (2, 100, 30)


def test_kaiser_nan_parameter_gives_sentinel(boss):
    _, tb = boss
    lnl, chisq = tlk.log_likelihood(
        tb.tables, tb.spec, tb.theory_opts.replace(rsd_model='kaiser'),
        tb.fit_opts, tp({**GOLDEN, 'epsilon': float('nan')}, GOLDEN))
    assert lnl[0] == -torch.inf and chisq[0] == torch.inf
    assert torch.isfinite(lnl[1])


# ---------------------------------------------------------------------------
# linear-bias matter model, template mean, data-derived real space
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('opts_kw', [{}, EXACT_DISP, {'rsd_model': 'kaiser'}],
                         ids=['streaming', 'dispersion', 'kaiser'])
def test_linear_bias_vs_jax(linear_bias, opts_kw):
    jb, tb = linear_bias
    extra = {'bias': 2.1}
    check_vs_jax(jb, tb, opts_kw, [{**GOLDEN, **extra},
                                   {**DISPLACED, **extra}])


def test_linear_bias_profiles_vs_jax(linear_bias):
    """The four linear-bias profiles of a batch, the bias default included
    (params without 'bias' take the config's 1.9)."""
    jb, tb = linear_bias
    points = [GOLDEN, DISPLACED]
    got = tth.delta_profiles(tb.tables, tb.spec, tb.theory_opts, tp(*points))
    for i, p in enumerate(points):
        want = jth.delta_profiles(jb.tables, jb.spec, jb.theory_opts, jp(p))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), rtol=0,
                                       atol=1e-13)


def test_linear_bias_without_beta_raises(linear_bias):
    """The reference raises when beta is missing for beta-interpolated
    multipoles (victor_tpu/models/ccf_theory.py:72-77): both packages do."""
    jb, tb = linear_bias
    no_beta = {k: v for k, v in GOLDEN.items() if k != 'beta'}
    with pytest.raises(InputError, match='valid value of beta'):
        tth.velocity_terms(tb.tables, tb.spec, tb.theory_opts, tp(no_beta))
    with pytest.raises(JaxInputError, match='valid value of beta'):
        jth.velocity_terms(jb.tables, jb.spec, jb.theory_opts, jp(no_beta))


@pytest.mark.parametrize('opts_kw', [{}, EXACT_DISP,
                                     {**EXACT_DISP,
                                      'dispersion_final': 'fused'}],
                         ids=['streaming', 'dispersion', 'dispersion_fused'])
def test_template_mean_vs_jax(template_mean, opts_kw):
    """velocity_pdf.mean.model='template' with the fsigma8 / H / z rescaling
    (victor/ccf_model.py:439-443,483-490), z_sim = 0 included. The fused
    final stage runs its plain version here and meets victor_tpu's exact
    one."""
    jb, tb = template_mean
    jax_kw = {**opts_kw, 'dispersion_final': 'exact'} \
        if opts_kw.get('dispersion_final') == 'fused' else opts_kw
    points = [GOLDEN, DISPLACED]
    got = tth.theory_xi_grid(tb.tables, tb.spec,
                             tb.theory_opts.replace(**opts_kw), tp(*points))
    for i, p in enumerate(points):
        want = jth.theory_xi_grid(jb.tables, jb.spec,
                                  jb.theory_opts.replace(**jax_kw), jp(p))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0,
                                   atol=XI_ATOL)
    if 'dispersion_final' not in opts_kw:
        check_vs_jax(jb, tb, opts_kw, points)


def test_template_mean_without_template_raises(boss):
    _, tb = boss
    with pytest.raises(InputError, match='no template has been supplied'):
        tth.velocity_terms(tb.tables, tb.spec,
                           tb.theory_opts.replace(mean_model='template'),
                           tp(GOLDEN))


@pytest.mark.parametrize('opts_kw', [{}, EXACT_DISP, {'rsd_model': 'kaiser'},
                                     {'assume_isotropic': False}],
                         ids=['streaming', 'dispersion', 'kaiser',
                              'anisotropic'])
def test_realspace_from_data_vs_jax(from_data, opts_kw):
    """The data-derived real-space CCF: the inverse-AP shift back to
    fiducial coordinates with unrescaled r (victor/ccf_model.py:673-679),
    growth term beta * bias."""
    jb, tb = from_data
    assert tb.theory_opts.realspace_ccf_from_data
    extra = {'bias': 1.9}
    check_vs_jax(jb, tb, opts_kw, [{**GOLDEN, **extra, 'epsilon': 1.03},
                                   {**DISPLACED, **extra}])


# ---------------------------------------------------------------------------
# anisotropic real-space input (one multi-channel lookup)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('opts_kw', [
    {'assume_isotropic': False},
    {'assume_isotropic': False, **EXACT_DISP},
    {'assume_isotropic': False, 'rsd_model': 'euclid_special'},
    {'assume_isotropic': False, 'streaming_eval': 'fast'},
], ids=['streaming', 'dispersion', 'euclid', 'streaming_fast'])
def test_anisotropic_two_poles_vs_jax(boss, opts_kw):
    jb, tb = boss
    check_vs_jax(jb, tb, opts_kw, [GOLDEN, DISPLACED])


@pytest.fixture(scope='module')
def three_poles(boss_config, tmp_path_factory):
    """The BOSS model with a small smooth hexadecapole (31, 30) added: a
    model-only build with real-space poles (0, 2, 4)."""
    with h5py.File(os.path.join(REPO, boss_config['model']
                                ['input_model_data_file'])) as f:
        r = f['r'][:]
    hexa = 0.02 * np.exp(-r / 50.0)[None, :] * np.linspace(0.8, 1.2, 31)[:, None]
    model = copy.deepcopy(boss_config['model'])
    model['input_model_data_file'] = _model_file(
        tmp_path_factory.mktemp('hexa'), boss_config, {'hexadecapole': hexa})
    model['dir'] = ''
    model['realspace_ccf']['ccf_keys'] = ['r', 'monopole', 'quadrupole',
                                          'hexadecapole']
    model['realspace_ccf']['assume_isotropic'] = False
    return pair(model)


@pytest.mark.parametrize('opts_kw', [{}, EXACT_DISP, {'rsd_model': 'kaiser'}],
                         ids=['streaming', 'dispersion', 'kaiser'])
def test_anisotropic_three_poles_vs_jax(three_poles, opts_kw):
    jb, tb = three_poles
    assert tb.spec.poles_r == (0, 2, 4) and not tb.theory_opts.assume_isotropic
    check_vs_jax(jb, tb, opts_kw, [GOLDEN, DISPLACED], likelihood=False)


@pytest.mark.parametrize('K', [2, 3, 4])
@pytest.mark.parametrize('shared', [False, True])
@pytest.mark.parametrize('clamp', [True, False])
def test_multi_channel_plain_equals_per_channel(K, shared, clamp):
    """ppoly_eval_multi on K tables equals K single-table ppoly_eval calls
    bit for bit, with per-row or shared tables, NaN and infinite queries."""
    rng = np.random.default_rng(40 + K)
    x = _knots(rng, 30)
    c = _coeffs(x, rng.standard_normal((K, 30) if shared else (3, K, 30)))
    q = _queries(rng, x, (3, 7, 40))
    got = tsp.ppoly_eval_multi(_t(x), _t(c), _t(q), clamp)
    assert got.shape == (3, K, 7, 40)
    for k in range(K):
        ck = c[k] if shared else c[:, k]
        want = tsp.ppoly_eval(_t(x), _t(ck), _t(q), clamp)
        if shared:     # a shared table: every row takes its own slice
            want = torch.stack([tsp.ppoly_eval(_t(x), _t(ck), _t(q[b]), clamp)
                                for b in range(3)])
        assert torch.equal(torch.isnan(got[:, k]), torch.isnan(want))
        fin = ~torch.isnan(want)
        assert torch.equal(got[:, k][fin], want[fin])


# ---------------------------------------------------------------------------
# the option axes of tests/test_option_parity.py, against victor_tpu
# ---------------------------------------------------------------------------

def _option_cfg(name, boss_config, tmp_path):
    """(model, data or None, params, opts_kw) for one option axis."""
    cfg = copy.deepcopy(boss_config)
    model, data = cfg['model'], cfg['data']
    params, opts_kw = dict(GOLDEN), {}
    src = os.path.join(REPO, model['input_model_data_file'])
    with h5py.File(src) as f:
        payload = {k: f[k][:] for k in f}
    if name == 'rmu_format':
        mu = np.linspace(0.0, 1.0, 64)
        ccf_rmu = payload['monopole'][15][:, None] + \
            payload['quadrupole'][15][:, None] * (1.5 * mu ** 2 - 0.5)[None, :]
        model['input_model_data_file'] = _model_file(
            tmp_path, boss_config, {'mu': mu, 'xi_rmu': ccf_rmu},
            drop=('monopole', 'quadrupole', 'beta'))
        model['dir'] = ''
        model['realspace_ccf'] = {'reconstruction': False, 'format': 'rmu',
                                  'ccf_keys': ['r', 'mu', 'xi_rmu'],
                                  'assume_isotropic': False}
        data['redshift_space_ccf']['beta_key'] = 'beta'
    elif name == 'npy_input':
        fn = tmp_path / 'model.npy'
        np.save(fn, payload)
        model['input_model_data_file'] = str(fn)
        model['dir'] = ''
    elif name == 'simulation_number':
        rng = np.random.default_rng(0)
        mono = np.stack([payload['monopole'][15] + rng.normal(0, 1e-3, 30),
                         payload['monopole'][15],
                         payload['monopole'][15] - rng.normal(0, 1e-3, 30)])
        quad = np.stack([payload['quadrupole'][15]] * 3)
        model['input_model_data_file'] = _model_file(
            tmp_path, boss_config, {'monopole': mono, 'quadrupole': quad},
            drop=('monopole', 'quadrupole', 'beta'))
        model['dir'] = ''
        model['realspace_ccf'] = {
            'reconstruction': False, 'format': 'multipoles',
            'ccf_keys': ['r', 'monopole', 'quadrupole'],
            'simulation_number': 1, 'assume_isotropic': False}
        data['redshift_space_ccf']['beta_key'] = 'beta'
    elif name == 'empirical_corr_dispersion':
        model['velocity_pdf']['mean']['empirical_corr'] = True
        params['Av'] = 0.5
        opts_kw = EXACT_DISP
    elif name == 'constant_dispersion':
        model['velocity_pdf']['dispersion'] = {'model': 'constant'}
    elif name == 'md_covariance':
        data['covariance_matrix']['data_file'] = (
            'data/BOSS_DR12_CMASS_data/CMASS_zobovVoids_reconRs10_0.43z0.7_'
            'medianRvcut_variable_isotropic_MD_covariance.hdf5')
    elif name == 'fixed_covariance':
        data['covariance_matrix'] = {
            'data_file': 'data/BOSS_DR12_CMASS_data/CMASS_zobovVoids_'
                         'reconRs10_0.43z0.7_medianRvcut_fixed_D_covariance.hdf5',
            'cov_key': 'covmat', 'fixed_beta': True}
    elif name == 'anisotropic_dispersion_template':
        mu_sv = np.linspace(0.0, 1.0, 21)
        sv2d = payload['sigmav'][:, None] * (1.0 + 0.25 * mu_sv[None, :] ** 2)
        model['input_model_data_file'] = _model_file(
            tmp_path, boss_config, {'musv': mu_sv, 'sigmav2d': sv2d})
        model['dir'] = ''
        model['velocity_pdf']['dispersion'] = {
            'model': 'template', 'template_keys': ['rsv', 'musv', 'sigmav2d']}
        opts_kw = {'assume_isotropic': False}
    elif name == 'hexadecapole_fit':
        rng = np.random.default_rng(7)
        r = payload['r']
        model['input_model_data_file'] = _model_file(
            tmp_path, boss_config,
            {'hexadecapole': 0.02 * np.exp(-r / 50.0)[None, :] * np.ones((31, 1))})
        model['dir'] = ''
        model['realspace_ccf']['ccf_keys'] = ['r', 'monopole', 'quadrupole',
                                              'hexadecapole']
        model['realspace_ccf']['assume_isotropic'] = False
        with h5py.File(os.path.join(REPO, data['redshift_space_ccf']
                                    ['data_file'])) as f:
            dpay = {k: f[k][:] for k in f}
        dpay['hexadecapole'] = 0.02 * np.exp(-dpay['s'] / 50.0)[None, :] * \
            np.ones((31, 1)) + rng.normal(0, 1e-3, (31, 30))
        A = rng.normal(0, 1e-2, (90, 120))
        for fn, content in (('data3.hdf5', dpay),
                            ('cov3.hdf5', {'covmat': A @ A.T
                                           + np.eye(90) * 1e-4})):
            with h5py.File(tmp_path / fn, 'w') as f:
                for k, v in content.items():
                    f.create_dataset(k, data=v)
        data['dir'] = ''
        data['redshift_space_ccf']['data_file'] = str(tmp_path / 'data3.hdf5')
        data['redshift_space_ccf']['ccf_keys'] = ['s', 'monopole', 'quadrupole',
                                                  'hexadecapole']
        data['covariance_matrix'] = {'data_file': str(tmp_path / 'cov3.hdf5'),
                                     'cov_key': 'covmat', 'fixed_beta': True}
    elif name == 'toy_example':
        model = {
            'input_model_data_file': 'data/example_data/example_void_model.hdf5',
            'dir': REPO, 'rsd_model': 'streaming', 'z_eff': 0.50,
            'cosmology': {'Omega_m': 0.31},
            'realspace_ccf': {'reconstruction': False, 'format': 'multipoles',
                              'ccf_keys': ['r', 'monopole']},
            'matter_ccf': {'model': 'template', 'integrated': False,
                           'template_keys': ['rdelta', 'delta'],
                           'template_sigma8': 0.628, 'bias': 1.9},
            'velocity_pdf': {'mean': {'model': 'linear'},
                             'dispersion': {'model': 'template',
                                            'template_keys': ['rsv', 'sigmav']}},
        }
        data = None
        params = {'fsigma8': 0.47, 'sigma_v': 380.0, 'epsilon': 1.0}
    return model, data, params, opts_kw


@pytest.mark.parametrize('name', [
    'rmu_format', 'npy_input', 'simulation_number',
    'empirical_corr_dispersion', 'constant_dispersion', 'md_covariance',
    'fixed_covariance', 'anisotropic_dispersion_template', 'hexadecapole_fit',
    'toy_example'])
def test_option_axis_vs_jax(name, boss_config, tmp_path):
    """Each loader and model path of test_option_parity.py through both
    packages at the golden point and a displaced one."""
    model, data, params, opts_kw = _option_cfg(name, boss_config, tmp_path)
    jb, tb = pair(model, data)
    displaced = {**params, 'epsilon': 1.05, 'sigma_v': 320.0}
    if 'beta' in params:
        displaced['beta'] = 0.45
    check_vs_jax(jb, tb, opts_kw, [params, displaced],
                 likelihood=data is not None)


@pytest.mark.parametrize('variant', [
    {}, {'kaiser_approximation': True},
    {'kaiser_approximation': True, 'kaiser_coord_shift': False}],
    ids=['full', 'approx', 'approx_nocoord'])
def test_hamaus_fig5_variants_vs_jax(variant):
    """The three approximate-Kaiser variants of the Hamaus et al. (2020)
    Fig. 5 reproduction (test_option_parity.py::test_hamaus_fig5_reproduction)
    on the example void model with the linear-bias matter model, at the
    paper's best fit, on s in [0.01, 3] R_v."""
    import yaml
    with open(os.path.join(REPO, 'configs', 'example_model_input.yaml')) as f:
        model = yaml.safe_load(f)['model']
    model['dir'] = REPO
    model['matter_ccf']['model'] = 'linear_bias'
    bias = model['matter_ccf']['bias']
    s8t = model['matter_ccf']['template_sigma8']
    hamaus = {'beta': 0.347, 'epsilon': 1.0058, 'M': 1.138, 'Q': 1.22,
              'fsigma8': 0.347 * bias * s8t}
    jb, tb = pair(model)
    opts_kw = {'rsd_model': 'kaiser', **variant}
    s = np.linspace(0.01, 3, 50)
    got = tth.theory_xi_grid(tb.tables, tb.spec,
                             tb.theory_opts.replace(**opts_kw), tp(hamaus),
                             s=_t(s))
    want = jth.theory_xi_grid(jb.tables, jb.spec,
                              jb.theory_opts.replace(**opts_kw), jp(hamaus),
                              s=jnp.asarray(s))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0,
                               atol=XI_ATOL)


# ---------------------------------------------------------------------------
# the goldens written into chip_smoke.py
# ---------------------------------------------------------------------------

def _chip_smoke_literals(*names):
    """The literal values assigned to `names` at the top level of
    chip_smoke.py (read with ast: importing the script would install its
    import hook that refuses jax)."""
    tree = ast.parse(open(os.path.join(REPO, 'chip_smoke.py')).read())
    found = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name) and t.id in names}
    return tuple(found[n] for n in names)


def _esm_config():
    import yaml
    with open(os.path.join(REPO, 'configs', 'esm_sampling_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    return cfg


def test_chip_smoke_goldens_match_victor_tpu(boss_config):
    """chip_smoke.py holds the card to chi^2 / lnL values of victor_tpu on
    the CPU (f64, exact modes). This test is how they were made: it
    recomputes each with victor_tpu and compares it with the literal in the
    script."""
    cases, goldens, golden, displaced, esm_ref, esm_goldens = \
        _chip_smoke_literals('OPTION_CASES', 'OPTION_GOLDENS', 'GOLDEN',
                             'DISPLACED', 'ESM_REF', 'ESM_GOLDENS')
    exact = {'streaming_eval': 'exact', 'beta_covariance': 'exact'}
    for name, (edits, opts_kw, extra) in cases.items():
        b = jax_build_tables({**copy.deepcopy(boss_config['model']), **edits},
                             copy.deepcopy(boss_config['data']))
        opts = b.theory_opts.replace(**exact, **opts_kw)
        for point, want in zip((golden, displaced), goldens[name]):
            lnl, chi2 = jlk.log_likelihood(
                b.tables, b.spec, opts, b.fit_opts,
                jp({**dict(zip(('fsigma8', 'beta', 'sigma_v', 'epsilon'),
                               point)), **extra}))
            assert abs(float(chi2) - want[0]) < 1e-9, (name, point)
            assert abs(float(lnl) - want[1]) < 1e-9, (name, point)
    cfg = _esm_config()
    b = jax_build_tables(cfg['model'], cfg['data'])
    for rsd, kw in (('streaming', {}),
                    ('dispersion', {'rsd_model': 'dispersion',
                                    'dispersion_interior': 'exact',
                                    'dispersion_final': 'exact'})):
        lnl, chi2 = jlk.log_likelihood(
            b.tables, b.spec, b.theory_opts.replace(**exact, **kw),
            b.fit_opts, jp(esm_ref))
        assert abs(float(chi2) - esm_goldens[rsd][0]) < 1e-9, rsd
        assert abs(float(lnl) - esm_goldens[rsd][1]) < 1e-9, rsd

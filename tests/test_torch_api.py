"""The port's class surface (`victor_tpu_torch.api`: CCFModel, CCFFit,
Interp2D) against victor_tpu's, method by method, on the BOSS config.

Both packages get identical tables (bundle_from_arrays of the JAX bundle's
leaves, on the CPU) through `CCFFit(..., _bundle=...)`, and the same
parameter dicts, in f64: 1e-12 on xi and the multipoles, 1e-9 on chi^2 and
lnL, 1e-12 on the matrices. Also recomputes the API_GOLDENS that
chip_smoke.py's phase 15 holds the card to.
"""

import ast
import copy
import dataclasses
import functools
import gc
import os
import weakref

import h5py
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from victor_tpu import api as japi  # noqa: E402
from victor_tpu.errors import InputError as JaxInputError  # noqa: E402
from victor_tpu.io import build_tables as jax_build_tables  # noqa: E402
from victor_tpu_torch import api as tapi  # noqa: E402
from victor_tpu_torch.errors import InputError  # noqa: E402
from victor_tpu_torch.io.tables import (bundle_from_arrays,  # noqa: E402
                                        tables_to_arrays)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
DISPLACED = {'fsigma8': 0.55, 'beta': 0.45, 'sigma_v': 320.0, 'epsilon': 1.05}
POINTS = {'golden': GOLDEN, 'displaced': DISPLACED}
XI_ATOL = 1e-12
LIKE_ATOL = 1e-9
MAT_RTOL = 1e-12


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


def fits(cfg):
    """(victor_tpu CCFFit, the port's CCFFit) on identical tables."""
    jb, tb = pair(cfg['model'], cfg['data'])
    return (japi.CCFFit(cfg['model'], cfg['data'], _bundle=jb),
            tapi.CCFFit(cfg['model'], cfg['data'], _bundle=tb))


def _esm_config():
    import yaml
    with open(os.path.join(REPO, 'configs', 'esm_sampling_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    return cfg


@pytest.fixture(scope='module')
def boss(boss_config):
    return fits(boss_config)


@pytest.fixture(scope='module')
def esm():
    return fits(_esm_config())


@pytest.fixture(scope='module')
def fixed_cov(boss_config, tmp_path_factory):
    """The BOSS data under one fixed covariance (the β = 0.37 blend of the
    stack): fixed_covmat with a β-dependent data vector."""
    from victor_tpu_torch.io.loaders import load_key_value_file
    cfg = copy.deepcopy(boss_config)
    block = cfg['data']['covariance_matrix']
    stack = load_key_value_file(os.path.join(REPO, block['data_file']))
    fn = tmp_path_factory.mktemp('cov') / 'fixed_cov.hdf5'
    with h5py.File(fn, 'w') as f:
        f.create_dataset('covmat', data=np.asarray(stack['covmat'])[15])
    cfg['data']['covariance_matrix'] = {'data_file': str(fn),
                                        'cov_key': 'covmat',
                                        'fixed_beta': True}
    return fits(cfg)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _mat_close(got, want):
    want = np.asarray(want)
    _close(got, want, MAT_RTOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# the likelihood surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('point', POINTS)
def test_log_likelihood_and_chi_squared_vs_jax(boss, point):
    jf, tf = boss
    p = {**POINTS[point], 'label': 'ignored', 'plot_kwargs': {'lw': 2},
         'options': {}}
    lnl, chi2 = tf.log_likelihood(p)
    jl, jc = jf.log_likelihood(p)
    assert isinstance(lnl, float) and isinstance(chi2, float)
    assert abs(lnl - jl) < LIKE_ATOL and abs(chi2 - jc) < LIKE_ATOL
    c2, cov = tf.chi_squared(p)
    jc2, jcov = jf.chi_squared(p)
    assert abs(c2 - jc2) < LIKE_ATOL and cov.shape == (60, 60)
    _mat_close(cov, jcov)
    if point == 'golden':
        assert round(chi2, 6) == 65.011778 and round(lnl, 6) == 284.764389


@pytest.mark.parametrize('kw', [
    {'rsd_model': 'kaiser'},
    {'rsd_model': 'dispersion', 'dispersion_interior': 'exact'},
    {'rsd_model': 'dispersion', 'dispersion_interior': 'exact',
     'dispersion_final': 'fused'},
    {'beta_covariance': 'factored'},
    {'streaming_eval': 'fast'},
    {'form': 'hartlap'},
    {'form': 'gaussian', 'beta_interpolation': 'likelihood'},
], ids=lambda kw: ','.join(f'{k}={v}' for k, v in kw.items()))
def test_option_overrides_vs_jax(boss, kw):
    jf, tf = boss
    for p in POINTS.values():
        lnl, chi2 = tf.log_likelihood(p, **kw)
        jl, jc = jf.log_likelihood(p, **kw)
        assert abs(lnl - jl) < LIKE_ATOL and abs(chi2 - jc) < LIKE_ATOL, p


def test_unknown_override_raises(boss):
    jf, tf = boss
    for fit, err in ((tf, InputError), (jf, JaxInputError)):
        with pytest.raises(err, match='not_an_option'):
            fit.log_likelihood(GOLDEN, not_an_option=True)
        with pytest.raises(err, match='not_an_option'):
            fit.theory_multipoles(fit.s, GOLDEN, not_an_option=1)
        with pytest.raises(err, match='not_an_option'):
            fit.chi_squared(GOLDEN, rsd_model='kaiser', not_an_option=1)
    # a fit option is accepted, and ignored, by a theory call
    assert abs(tf.theory_xi(20.0, 0.5, GOLDEN, form='gaussian') -
               jf.theory_xi(20.0, 0.5, GOLDEN, form='gaussian')) < XI_ATOL


def test_factored_override_rebuilds_the_covariance(boss, fixed_cov):
    """beta_covariance='factored' forms no blended covariance; chi_squared
    rebuilds it (the β-varying stack at params['beta'], the fixed matrix
    otherwise) and returns the factored chi^2."""
    for jf, tf in (boss, fixed_cov):
        for p in POINTS.values():
            c2, cov = tf.chi_squared(p, beta_covariance='factored')
            jc2, jcov = jf.chi_squared(p, beta_covariance='factored')
            assert abs(c2 - jc2) < LIKE_ATOL
            _mat_close(cov, jcov)
            _mat_close(cov, tf.get_interpolated_covariance(p['beta']))
            # the factored chi^2 is the dense one in exact arithmetic
            assert abs(c2 - tf.chi_squared(p)[0]) < 1e-9


# ---------------------------------------------------------------------------
# the theory surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('poles', [(0, 2), (1, 3), (0, 1, 2, 3), 2, (0, 2, 4)],
                         ids=str)
def test_theory_multipoles_vs_jax(boss, poles):
    jf, tf = boss
    s = tf.s if poles != 2 else np.linspace(5.0, 80.0, 7)
    for p in POINTS.values():
        got = tf.theory_multipoles(s, p, poles=poles)
        want = jf.theory_multipoles(s, p, poles=poles)
        assert list(got) == list(want)
        for k in want:
            _close(got[k], want[k], XI_ATOL)
        _close(tf.theory_multipole_vector(s, p, poles=poles),
               jf.theory_multipole_vector(s, p, poles=poles), XI_ATOL)


def test_odd_multipoles_use_full_mu_range(boss):
    """Any odd pole switches every requested pole to mu in [-1, 1] (npts
    200, even=False): a mu-even xi gives ~0 for the odd poles, and the even
    poles agree with the half-range projection up to quadrature resolution
    (tests/test_api.py's check of victor_tpu)."""
    _, tf = boss
    s = np.linspace(15.0, 55.0, 5)
    mixed = tf.theory_multipoles(s, GOLDEN, poles=(0, 1, 2, 3))
    assert np.max(np.abs(mixed['1'])) < 1e-10
    assert np.max(np.abs(mixed['3'])) < 1e-10
    even = tf.theory_multipoles(s, GOLDEN, poles=(0, 2))
    _close(mixed['0'], even['0'], 2e-4)
    _close(mixed['2'], even['2'], 2e-4)
    proj_odd, mu_odd = tf._proj_matrix((0, 1, 2, 3))
    assert float(mu_odd[0]) == -1.0 and proj_odd.dtype == torch.float64


@pytest.mark.parametrize('shape', ['scalar', 'grid', 'paired', 'mu-array'])
def test_theory_xi_vs_jax(boss, shape):
    """theory_xi broadcasts s against mu of any shape and returns a float
    only when both are scalars."""
    jf, tf = boss
    s_, mu_ = {'scalar': (30.0, 0.5),
               'grid': (np.array([10.0, 25.0, 40.0])[:, None],
                        np.linspace(0.0, 1.0, 5)[None, :]),
               'paired': (np.linspace(5.0, 90.0, 6), np.linspace(-1, 1, 6)),
               'mu-array': (20.0, np.linspace(0.0, 1.0, 4))}[shape]
    for p in POINTS.values():
        got, want = tf.theory_xi(s_, mu_, p), jf.theory_xi(s_, mu_, p)
        if shape == 'scalar':
            assert isinstance(got, float) and isinstance(want, float)
        else:
            assert got.shape == want.shape == np.broadcast(
                np.atleast_1d(s_), np.atleast_1d(mu_)).shape
        _close(got, want, XI_ATOL)


@pytest.mark.parametrize('method', ['theory_xi_2D', 'xi_2D_from_multipoles'])
def test_xi_2D_vs_jax(boss, method):
    """The interpolators' node values and off-node values (linear, as
    scipy.interp2d's default) against victor_tpu's."""
    jf, tf = boss
    got = getattr(tf, method)(GOLDEN, rmax=60)
    want = getattr(jf, method)(GOLDEN, rmax=60)
    nodes_x, nodes_y = np.linspace(0.01, 60)[::7], np.linspace(-60, 60)[::9]
    off_x, off_y = np.array([3.3, 17.1, 44.4]), np.array([-31.7, 0.2, 12.9])
    for x, y in ((nodes_x, nodes_y), (off_x, off_y)):
        g, w = got(x, y), want(x, y)
        assert g.shape == w.shape == (len(y), len(x))
        _close(g, w, XI_ATOL)


def test_interp2d_off_node_matches_jax():
    """Interp2D transposes its input into RectBivariateSpline and defaults
    to linear (scipy.interp2d's default); kind='cubic' is cubic."""
    rng = np.random.default_rng(0)
    x, y = np.linspace(0.0, 3.0, 7), np.linspace(-2.0, 2.0, 9)
    z = rng.standard_normal((9, 7))
    qx, qy = np.sort(rng.uniform(0, 3, 11)), np.sort(rng.uniform(-2, 2, 5))
    for kind in ('linear', 'cubic'):
        got = tapi.Interp2D(x, y, z, kind=kind)(qx, qy)
        want = japi.Interp2D(x, y, z, kind=kind)(qx, qy)
        assert got.shape == (5, 11)
        _close(got, want, 0.0)
    xx = np.array([0.0, 1.0, 2.0, 3.0])
    f = tapi.Interp2D(xx, xx, (xx ** 3)[None, :].repeat(4, 0))
    np.testing.assert_allclose(f(1.5, 1.0)[0][0], 4.5, rtol=1e-12)
    _close(f(xx, xx), (xx ** 3)[None, :].repeat(4, 0), 1e-12)


@pytest.mark.parametrize('beta', [0.37, 0.30, 0.45, 0.2])
def test_interpolated_arrays_vs_jax(boss, beta):
    jf, tf = boss
    for name in ('get_interpolated_real_multipoles',
                 'get_interpolated_redshift_multipoles',
                 'multipole_datavector', 'get_interpolated_covariance',
                 'get_interpolated_precision', 'correlation_matrix',
                 'diagonal_errors'):
        got, want = getattr(tf, name)(beta), getattr(jf, name)(beta)
        assert got.shape == want.shape, name
        _mat_close(got, want)
    assert tf.get_interpolated_redshift_multipoles(beta).shape == (2, 30)


def test_beta_none_parity(boss, fixed_cov):
    """beta=None raises InputError unless the matching fixed_* flag is set:
    the data side checks fixed_data, the covariance and precision check
    fixed_covmat (victor_tpu/api.py:313-342)."""
    for jf, tf in (boss, fixed_cov):
        fixed = tf.bundle.spec.fixed_covmat
        for name in ('get_interpolated_real_multipoles',
                     'get_interpolated_redshift_multipoles',
                     'multipole_datavector', 'get_interpolated_covariance',
                     'get_interpolated_precision', 'correlation_matrix',
                     'diagonal_errors'):
            covariance_side = name not in (
                'get_interpolated_real_multipoles',
                'get_interpolated_redshift_multipoles',
                'multipole_datavector')
            if covariance_side and fixed:
                _mat_close(getattr(tf, name)(None), getattr(jf, name)(None))
                continue
            with pytest.raises(InputError, match='beta'):
                getattr(tf, name)(None)
            with pytest.raises(JaxInputError, match='beta'):
                getattr(jf, name)(None)
    # a fixed covariance still needs beta for the chi^2's data vector
    _, tf = fixed_cov
    with pytest.raises(InputError, match='beta'):
        tf.chi_squared({k: v for k, v in GOLDEN.items() if k != 'beta'})


@pytest.mark.parametrize('which', ['template', 'esm'])
def test_delta_velocity_profiles_vs_jax(boss, esm, which):
    """At the r_v knots (exact) and off them (the ext=3 cubic spline), for
    the template's batch-free tables and the excursion-set model's per-row
    profiles."""
    jf, tf = boss if which == 'template' else esm
    p = GOLDEN if which == 'template' else ESM_REF
    r = np.concatenate([tf.bundle.tables.r_v.numpy(),
                        [0.5, 7.3, 33.3, 150.0]])
    for method in ('delta_profiles', 'velocity_terms'):
        got = getattr(tf, method)(r, p)
        want = getattr(jf, method)(r, p)
        for g, w in zip(got, want):
            assert g.shape == w.shape == r.shape
            _close(g, w, XI_ATOL * max(1.0, np.abs(w).max()))


ESM_REF = {'f': 0.78, 'sigma_8_0': 0.81, 'b10': -1.544, 'b01': -4.228,
           'Rp': 7.973, 'Rx': 0.467, 'beta': 0.4, 'sigma_v': 380.0,
           'epsilon': 1.0}


@pytest.mark.parametrize('kw', [{}, {'rsd_model': 'dispersion',
                                     'dispersion_interior': 'exact'}],
                         ids=['streaming', 'dispersion'])
def test_esm_config_through_ccffit_vs_jax(esm, kw):
    jf, tf = esm
    lnl, chi2 = tf.log_likelihood(ESM_REF, **kw)
    jl, jc = jf.log_likelihood(ESM_REF, **kw)
    assert abs(lnl - jl) < LIKE_ATOL and abs(chi2 - jc) < LIKE_ATOL
    got = tf.theory_multipoles(tf.s, ESM_REF, **kw)
    want = jf.theory_multipoles(jf.s, ESM_REF, **kw)
    for k in want:
        _close(got[k], want[k], XI_ATOL)


# ---------------------------------------------------------------------------
# the instance: memo, device
# ---------------------------------------------------------------------------

def test_memo_is_per_instance_and_a_dropped_fit_is_freed(boss, boss_config):
    """The projection memo lives on the instance (no class-level lru that
    would keep dropped instances and their device tables alive): a dropped
    CCFFit is collected."""
    _, tf = boss
    fit = tapi.CCFFit(boss_config['model'], boss_config['data'],
                      _bundle=tf.bundle)
    fit.theory_multipoles(fit.s, GOLDEN, poles=(0, 2))
    fit.theory_multipoles(fit.s, GOLDEN, poles=(1, 3))
    assert set(fit.__dict__['_proj']) == {(0, 2), (1, 3)}
    assert '_proj' not in tapi.CCFFit.__dict__
    assert not any(isinstance(v, functools._lru_cache_wrapper)
                   for cls in tapi.CCFFit.__mro__ for v in vars(cls).values())
    ref = weakref.ref(fit)
    del fit
    gc.collect()
    assert ref() is None


def test_the_card_is_the_default_and_there_is_no_fallback(boss_config):
    """CCFModel/CCFFit build on 'cuda' unless told otherwise, and without a
    card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default builds there')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.CCFFit(boss_config['model'], boss_config['data'])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.CCFModel(boss_config['model'])


def test_ccfmodel_model_only_and_f32(boss_config):
    """A model-only CCFModel on the CPU in f32: the attributes of victor_tpu's,
    xi within f32 rounding of the f64 port, the projection in f64."""
    jm = japi.CCFModel(boss_config['model'])
    tm = tapi.CCFModel(boss_config['model'], device='cpu',
                       dtype=torch.float32)
    assert tm.dtype == torch.float32 and tm.device.type == 'cpu'
    assert tm.poles_r == jm.poles_r and tm.z_eff == pytest.approx(jm.z_eff)
    np.testing.assert_allclose(tm.r, jm.r, rtol=1e-6)
    np.testing.assert_allclose(tm.iaH, jm.iaH, rtol=1e-6)
    got = tm.theory_multipoles(jm.r, GOLDEN)
    want = jm.theory_multipoles(jm.r, GOLDEN)
    for k in want:
        _close(got[k], want[k], 1e-5 * np.abs(want[k]).max())
        assert got[k].dtype == np.float64


# ---------------------------------------------------------------------------
# the plot methods
# ---------------------------------------------------------------------------

def _plot_data(ax):
    """Every line's (x, y, label) and every collection's segments."""
    lines = [(np.asarray(ln.get_xdata(), float),
              np.asarray(ln.get_ydata(), float), ln.get_label())
             for ln in ax.lines]
    segs = [np.asarray(s) for c in ax.collections for s in c.get_segments()]
    return lines, segs


PLOTS = {
    'comparison': ('plot_multipole_comparison', dict(ell=2), (
        {**GOLDEN, 'label': 'streaming'},
        {**DISPLACED, 'options': {'rsd_model': 'kaiser'}, 'label': 'kaiser',
         'plot_kwargs': {'ls': '--'}})),
    'comparison-diff': ('plot_multipole_comparison', dict(ell=0, diff=True),
                        ({**GOLDEN, 'label': 'a'}, {**GOLDEN, 'label': 'b'})),
    'comparison-chi2': ('plot_multipole_comparison', dict(ell=2, chi2=True),
                        ({**GOLDEN, 'label': 'streaming'}, {**DISPLACED})),
    'model': ('plot_model_multipoles', dict(ell=2),
              (GOLDEN, {**DISPLACED, 'label': 'displaced'})),
    'model-diff': ('plot_model_multipoles', dict(ell=0, diff=True),
                   ({**GOLDEN, 'options': {'rsd_model': 'kaiser'}},)),
    'realspace': ('plot_realspace_multipoles', dict(ell=2),
                  ({'beta': 0.37, 'label': 'x'}, {'beta': 0.45})),
}


@pytest.mark.parametrize('case', PLOTS)
def test_plot_methods_vs_jax(boss, case):
    """The three plot methods under Agg: every line's data and label and
    every errorbar segment equal victor_tpu's for the same call."""
    jf, tf = boss
    method, kw, params = PLOTS[case]
    out = []
    for fit in (tf, jf):
        fig, ax = plt.subplots()
        assert getattr(fit, method)(*params, ax=ax, **kw) is ax
        out.append(_plot_data(ax))
        plt.close(fig)
    (got_lines, got_segs), (want_lines, want_segs) = out
    assert len(got_lines) == len(want_lines) > 0
    for (gx, gy, gl), (wx, wy, wl) in zip(got_lines, want_lines):
        assert gl == wl
        _close(gx, wx, 0.0)
        _close(gy, wy, XI_ATOL)
    assert len(got_segs) == len(want_segs)
    for g, w in zip(got_segs, want_segs):
        _close(g, w, XI_ATOL)
    if case == 'comparison-chi2':
        assert got_lines[0][2].startswith('streaming $\\chi^2=')
    if case.startswith('comparison'):
        assert len(got_segs) > 0


# ---------------------------------------------------------------------------
# chip_smoke.py phase 15's goldens
# ---------------------------------------------------------------------------

def _literals(*names):
    """Top-level literals of chip_smoke.py (read with ast: importing it
    would install its hook that refuses jax)."""
    tree = ast.parse(open(os.path.join(REPO, 'chip_smoke.py')).read())
    found = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name) and t.id in names}
    return tuple(found[n] for n in names)


def api_values(fit, esm_fit, esp_cls, cosmo, s8z_fn, grad_fn, **kw):
    """Phase 15's quantities through one package's classes (victor_tpu's or
    the port's, with its construction keywords `kw`): the golden dict
    chip_smoke.py's API_GOLDENS holds."""
    (beta, S, MU, point, nodes, R, K, esp_args, profile, norms,
     z) = _literals('API_BETA', 'API_S', 'API_MU', 'API_XI_POINT',
                    'API_NODES', 'API_R', 'API_K', 'ESP_ARGS', 'ESP_PROFILE',
                    'ESP_NORMS', 'COSMO_Z')
    esm_ref, = _literals('ESM_REF')
    lst = np.ndarray.tolist
    out = {f'loglike_{k}': list(fit.log_likelihood(p))
           for k, p in POINTS.items()}
    _, cov = fit.chi_squared(GOLDEN)
    out['cov_diag'], out['cov_rowsum'] = lst(np.diag(cov)), lst(cov.sum(1))
    # the odd poles of (1, 3) are rounding noise around 0: the script holds
    # them under 1e-9 of these even poles' largest value
    m = fit.theory_multipoles(fit.s, GOLDEN, poles=(0, 2))
    out['mult'] = [lst(m['0']), lst(m['2'])]
    out['xi_point'] = fit.theory_xi(point[0], point[1], GOLDEN)
    out['xi_grid'] = lst(fit.theory_xi(np.array(S)[:, None],
                                       np.array(MU)[None, :], GOLDEN))
    sperp, spar = np.linspace(0.01, 85), np.linspace(-85, 85)
    for key in ('theory_xi_2D', 'xi_2D_from_multipoles'):
        f2 = getattr(fit, key)(GOLDEN)
        out[key] = [float(f2(sperp[i], spar[j])[0, 0]) for i, j in nodes]
    out['real_mult'] = lst(fit.get_interpolated_real_multipoles(beta))
    out['datavector'] = lst(fit.multipole_datavector(beta))
    # diagonal_errors(beta) is sqrt(cov_diag): beta is GOLDEN's
    out['corr_rowsum'] = lst(fit.correlation_matrix(beta).sum(1))
    out['delta'] = [lst(a) for a in fit.delta_profiles(R, GOLDEN)]
    out['velocity'] = [lst(a) for a in fit.velocity_terms(R, GOLDEN)]
    out['esm_loglike'] = list(esm_fit.log_likelihood(esm_ref))
    out['esm_fsigma8'] = esm_ref['f'] * s8z_fn(esm_fit, esm_ref)
    esp = esp_cls(**esp_args, **kw)
    lagrange = np.linspace(1.0, 120.0, 60)
    out['esp_fiducial'] = [esp.s80_fiducial, esp.s8z_fiducial]
    out['esp_power'] = lst(esp.power(np.array(K), profile[0]))
    out['esp_enclosed'] = lst(esp.model_enclosed_density_profile(
        lagrange, *profile)(np.array(R)))
    out['esp_local'] = lst(esp.model_density_profile(lagrange, *profile)(
        np.array(R)))
    out['esp_evolution'] = []
    for s8, zn in norms:
        esp.set_normalisation(s8, zn)
        for pairwise in (False, True):
            out['esp_evolution'].append(lst(esp.density_evolution(
                *profile, pairwise=pairwise)(np.array(R))))
    # growth_factor, sigma8z, fsigma8 and d growth_factor / dz at z
    out['cosmo'] = [cosmo.growth_factor(z), cosmo.sigma8z(z),
                    cosmo.fsigma8(z), grad_fn(cosmo, z)]
    return out


def _jax_values(boss, esm):
    import jax
    import jax.numpy as jnp
    from victor_tpu import BackgroundCosmology
    from victor_tpu.models.esm import ExcursionSetProfile, esm_s8z

    def s8z(fit, p):
        b = fit.bundle
        return float(esm_s8z(b.tables, b.spec,
                             {k: jnp.asarray(v) for k, v in p.items()}))
    return api_values(boss[0], esm[0], ExcursionSetProfile,
                      BackgroundCosmology({'Omega_m': 0.31}), s8z,
                      lambda c, z: float(jax.grad(c.growth_factor)(z)))


def _port_values(boss, esm):
    from victor_tpu_torch import BackgroundCosmology, ExcursionSetProfile
    from victor_tpu_torch.models.esm import esm_s8z

    def s8z(fit, p):
        b = fit.bundle
        return float(esm_s8z(b.tables, b.spec, fit._tp(p))[0])

    def grad(c, z):
        zt = torch.tensor(z, dtype=torch.float64, requires_grad=True)
        c.growth_factor(zt).backward()
        return float(zt.grad)
    return api_values(boss[1], esm[1], ExcursionSetProfile,
                      BackgroundCosmology({'Omega_m': 0.31}), s8z, grad,
                      device='cpu')


def _assert_goldens_close(got, want, rtol):
    """Every entry within rtol of the largest |value| of its group (a
    number, or a list of them)."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k], float), np.asarray(want[k], float)
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * np.abs(w).max(),
                                   err_msg=k)


def test_chip_smoke_api_goldens_match_victor_tpu(boss, esm):
    """chip_smoke.py phase 15 holds the card to victor_tpu's values on the
    CPU (f64). This test is how they were made: it recomputes each with
    victor_tpu and compares it with the literal in the script; then the
    port's values on the CPU meet the script's own gate (1e-9 of each
    group's largest value)."""
    goldens, = _literals('API_GOLDENS')
    _assert_goldens_close(_jax_values(boss, esm), goldens, 1e-12)
    _assert_goldens_close(_port_values(boss, esm), goldens, 1e-9)

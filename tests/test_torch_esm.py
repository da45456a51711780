"""The port's excursion-set model (ESM) against victor_tpu: the dynamic-knot
splines, the special functions, Eisenstein-Hu P(k) and sigma8, the top-hat
window and its derivative rule, every profile function, the ESM hooks of the
theory core, the ESM tables in all three P(k) modes, and the ESM likelihood
under both the streaming and the dispersion model.

Both packages get identical tables (bundle_from_arrays of the JAX bundle's
leaves, on the CPU) and identical parameter points, in f64. A batch of
points goes to the port at once, one point at a time to victor_tpu. The CAMB
table and grid modes run on synthetic .npz files written into tmp_path and
generated from the Eisenstein-Hu formula, as tests/test_esm_camb_table.py
and tests/test_esm_camb_grid.py make them (camb is not installed).
"""

import copy
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victor_tpu.errors import InputError as JaxInputError
from victor_tpu.io import build_tables as jax_build_tables
from victor_tpu.likelihood import core as jlk
from victor_tpu.models import ccf_theory as jth
from victor_tpu.models import eisenstein_hu as jeh
from victor_tpu.models import esm as jesm
from victor_tpu.ops import special as jspecial
from victor_tpu.ops import splines as jsp
from victor_tpu_torch.errors import InputError
from victor_tpu_torch.io.tables import (build_tables, bundle_from_arrays,
                                        tables_to_arrays)
from victor_tpu_torch.likelihood import core as tlk
from victor_tpu_torch.models import ccf_theory as tth
from victor_tpu_torch.models import eisenstein_hu as teh
from victor_tpu_torch.models import esm as tesm
from victor_tpu_torch.ops import special as tspecial
from victor_tpu_torch.ops import splines as tsp

torch.set_num_threads(1)

Z_EFF = 0.57
# CCFLikelihood.yaml defaults (victor/likelihoods/CCFLikelihood.yaml:20-27)
ESM_PARAMS = {
    'f': 0.778, 'sigma_8_0': 0.81, 'b10': -1.544, 'b01': -4.228,
    'Rp': 7.973, 'Rx': 0.467, 'Omega_m': 0.31, 'Omega_b': 0.048,
    'H0': 67.5, 'ns': 0.96, 'delta_c': 1.686,
    'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
}
ESM_DISPLACED = {**ESM_PARAMS, 'f': 0.72, 'sigma_8_0': 0.78, 'b10': -1.4,
                 'b01': -4.5, 'Rp': 8.5, 'Rx': 0.5, 'Omega_m': 0.30,
                 'H0': 69.0, 'ns': 0.97, 'beta': 0.42, 'sigma_v': 350.0,
                 'epsilon': 1.05}
POINTS = [ESM_PARAMS, ESM_DISPLACED]
EXACT = {'streaming_eval': 'exact', 'beta_covariance': 'exact'}
EXACT_DISP = {'rsd_model': 'dispersion', 'dispersion_interior': 'exact',
              'beta_covariance': 'exact'}
XI_ATOL = 1e-12
LIKE_ATOL = 1e-9
GRID_AXES = {
    'H0': np.array([65.0, 67.5, 70.0]),
    'Omega_m': np.array([0.29, 0.31, 0.33]),
    'Omega_b': np.array([0.048]),              # singleton axis path
    'ns': np.array([0.92, 0.96, 1.0]),
}


def tp(*points):
    return {k: torch.tensor([p[k] for p in points], dtype=torch.float64)
            for k in points[0]}


def jp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol=1e-13, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, equal_nan=True)


def pair(model, data):
    jb = jax_build_tables(copy.deepcopy(model), copy.deepcopy(data))
    tb = bundle_from_arrays(tables_to_arrays(jb.tables),
                            dataclasses.asdict(jb.spec),
                            dataclasses.asdict(jb.theory_opts),
                            dataclasses.asdict(jb.fit_opts), device='cpu')
    return jb, tb


def _esm_cfg(boss_config, **esm_opts):
    cfg = copy.deepcopy(boss_config)
    cfg['model']['matter_ccf'] = {'model': 'excursion_set',
                                  'excursion_set_options': esm_opts}
    return cfg


@pytest.fixture(scope='module')
def pk_table_path(tmp_path_factory):
    """A table in the tools/make_camb_table.py schema, on a denser k grid
    than the tables' own."""
    p = jeh.eisenstein_hu_params(0.675, 0.31, 0.048, ns=0.96, As=2e-9)
    k = np.logspace(-4, np.log10(2.0), 400)
    s80 = float(jeh.sigma80(p))
    Dz = float(jesm.esm_growth_factor(jnp.asarray(Z_EFF), 0.31, 0.69))
    path = tmp_path_factory.mktemp('camb') / 'pk_table.npz'
    np.savez(path, k=k, pk0=np.asarray(jeh.power_eh(p, jnp.asarray(k))),
             sigma8_0=s80, sigma8_z=s80 * Dz, h=0.675, omega_m=0.31,
             omega_b=0.048, ns=0.96, mnu=0.0, z=Z_EFF)
    return str(path)


@pytest.fixture(scope='module')
def pk_grid_path(tmp_path_factory):
    """A grid in the tools/make_camb_table.py --grid schema, 3 x 3 x 1 x 3
    cells of Eisenstein-Hu tables."""
    k = np.logspace(-4, np.log10(2.0), 400)
    names = list(GRID_AXES)
    shape = tuple(len(GRID_AXES[n]) for n in names)
    logpk, s80g, s8zg = np.empty(shape + (len(k),)), np.empty(shape), \
        np.empty(shape)
    for idx in itertools.product(*(range(n) for n in shape)):
        v = {n: GRID_AXES[n][idx[a]] for a, n in enumerate(names)}
        p = jeh.eisenstein_hu_params(v['H0'] / 100.0, v['Omega_m'],
                                     v['Omega_b'], ns=v['ns'], As=2e-9)
        logpk[idx] = np.log(np.asarray(jeh.power_eh(p, jnp.asarray(k))))
        s80g[idx] = float(jeh.sigma80(p))
        s8zg[idx] = s80g[idx] * float(jspecial.growth_factor_lcdm(
            Z_EFF, v['Omega_m'], 1.0 - v['Omega_m']))
    path = tmp_path_factory.mktemp('cambgrid') / 'pk_grid.npz'
    np.savez(path, k=k, axis_names=np.asarray(names), logpk0=logpk,
             sigma8_0=s80g, sigma8_z=s8zg, z=Z_EFF,
             **{f'grid_{n}': GRID_AXES[n] for n in names})
    return str(path)


@pytest.fixture(scope='module')
def configs(boss_config, pk_table_path, pk_grid_path):
    return {'eh': _esm_cfg(boss_config, use_eisenstein_hu=True),
            'table': _esm_cfg(boss_config, use_eisenstein_hu=False,
                              pk_table_file=pk_table_path),
            'grid': _esm_cfg(boss_config, use_eisenstein_hu=False,
                             pk_grid_file=pk_grid_path)}


@pytest.fixture(scope='module')
def bundles(configs):
    return {mode: pair(cfg['model'], cfg['data'])
            for mode, cfg in configs.items()}


# ---------------------------------------------------------------------------
# dynamic-knot splines, special functions, Eisenstein-Hu
# ---------------------------------------------------------------------------

def _dynamic_knots(rng, B, n):
    return np.sort(rng.uniform(1.0, 120.0, (B, n)), axis=1)


@pytest.mark.parametrize('clamp', [True, False])
def test_dynamic_spline_vs_jax(clamp):
    """cubic_coeffs_dynamic with per-row knots (one solve per row) and
    ppoly_eval_dynamic at queries beyond both ends and NaN, against
    victor_tpu row by row."""
    rng = np.random.default_rng(50)
    x = _dynamic_knots(rng, 3, 40)
    y = np.sin(x / 9.0) + rng.normal(0, 0.05, x.shape)
    q = rng.uniform(-5.0, 125.0, (3, 300))
    q[:, 0], q[:, 1:41] = np.nan, x
    c = tsp.cubic_coeffs_dynamic(_t(x), _t(y))
    got = tsp.ppoly_eval_dynamic(_t(x), c, _t(q), clamp=clamp)
    for b in range(3):
        jc = jsp.cubic_coeffs_dynamic(jnp.asarray(x[b]), jnp.asarray(y[b]))
        close(c[b], jc, rtol=1e-11, atol=1e-13)
        close(got[b], jsp.ppoly_eval_dynamic(jnp.asarray(x[b]), jc,
                                             jnp.asarray(q[b]), clamp=clamp),
              rtol=1e-12, atol=1e-13)
    assert torch.isnan(got[:, 0]).all() and torch.isfinite(got[:, 1:]).all()
    # on its knots the spline interpolates, and it matches scipy's
    from scipy.interpolate import CubicSpline
    close(got[0, 1:41], y[0], rtol=0, atol=1e-12)
    if not clamp:
        close(got[1, 41:], CubicSpline(x[1], y[1])(q[1, 41:]), rtol=1e-10,
              atol=1e-12)


def test_dynamic_coeffs_shared_knots_vs_jax():
    """Shared knots (n,) with batched values (B, n)."""
    rng = np.random.default_rng(51)
    x = np.sort(rng.uniform(1.0, 50.0, 25))
    y = rng.standard_normal((4, 25))
    got = tsp.cubic_coeffs_dynamic(_t(x), _t(y))
    close(got, jsp.cubic_coeffs_dynamic(jnp.asarray(x), jnp.asarray(y)),
          rtol=1e-11, atol=1e-13)


def test_gradient_nonuniform_vs_jax():
    rng = np.random.default_rng(52)
    x = _dynamic_knots(rng, 3, 30)
    y = rng.standard_normal((3, 30))
    got = tsp.gradient_nonuniform(_t(y), _t(x))
    for b in range(3):
        close(got[b], jsp.gradient_nonuniform(jnp.asarray(y[b]),
                                              jnp.asarray(x[b])))
        close(got[b], np.gradient(y[b], x[b]), rtol=1e-12)
    shared = tsp.gradient_nonuniform(_t(y), _t(x[0]))
    close(shared, jsp.gradient_nonuniform(jnp.asarray(y), jnp.asarray(x[0])))


def test_hyp2f1_and_growth_vs_jax():
    z = np.concatenate([-np.logspace(-4, np.log10(50.0), 40), [0.0]])
    close(tspecial.hyp2f1_growth(_t(z)), jspecial.hyp2f1_growth(z),
          rtol=1e-14)
    from scipy.special import hyp2f1
    close(tspecial.hyp2f1_growth(_t(z)), hyp2f1(5 / 6, 1.5, 11 / 6, z),
          rtol=1e-12)
    omm = _t([0.25, 0.31, 0.4])
    for zz in (0.0, 0.57, 1.2):
        got = tspecial.growth_factor_lcdm(_t(zz), omm, 1.0 - omm)
        want = [float(jspecial.growth_factor_lcdm(zz, o, 1.0 - o))
                for o in (0.25, 0.31, 0.4)]
        close(got, want, rtol=1e-14)


@pytest.mark.parametrize('n', [2, 3, 4, -1, -3])
def test_ipow_is_integer_pow(n):
    """ipow multiplies as lax.integer_pow does: bit-equal."""
    x = np.random.default_rng(53).uniform(0.1, 10.0, 1000)
    got = tspecial.ipow(_t(x), n).numpy()
    want = np.asarray(jax.lax.integer_pow(jnp.asarray(x), n))
    np.testing.assert_array_equal(got, want)


def test_power_eh_transfer_and_sigma80_vs_jax():
    """A batch of four cosmologies, one per row."""
    cosmo = np.array([[0.675, 0.31, 0.048, 0.96], [0.70, 0.29, 0.045, 0.92],
                      [0.65, 0.33, 0.05, 1.00], [0.69, 0.30, 0.048, 0.97]])
    tp_ = teh.eisenstein_hu_params(*(_t(c) for c in cosmo.T), As=2e-9)
    k = np.logspace(-4, np.log10(2.0), 200)
    pk = teh.power_eh(tp_, _t(k))
    tr = teh.transfer(tp_, _t(k))
    s80 = teh.sigma80(tp_)
    assert pk.shape == tr.shape == (4, 200) and s80.shape == (4,)
    for b, (h, omm, omb, ns) in enumerate(cosmo):
        jp_ = jeh.eisenstein_hu_params(h, omm, omb, ns=ns, As=2e-9)
        for f in dataclasses.fields(jp_):
            close(getattr(tp_, f.name)[b], getattr(jp_, f.name), rtol=1e-14)
        close(pk[b], jeh.power_eh(jp_, jnp.asarray(k)), rtol=1e-12)
        close(tr[b], jeh.transfer(jp_, jnp.asarray(k)), rtol=1e-12)
        close(s80[b], jeh.sigma80(jp_), rtol=1e-13)


def test_tophat_window_and_its_derivatives_vs_jax():
    """Forward values; the backward against jax.jvp of victor_tpu's
    custom_jvp rule on both sides of the x = 0.35 switch (series below,
    closed form above); and the second derivative through the backward
    (the rule applied to itself), against JAX's."""
    x = np.concatenate([np.logspace(-5, np.log10(0.349), 40), [0.35],
                        np.linspace(0.351, 25.0, 60)])
    xt = _t(x).requires_grad_()
    w = teh.tophat_window(xt)
    close(w.detach(), jeh.tophat_window(jnp.asarray(x)), rtol=1e-14)
    (dw,) = torch.autograd.grad(w.sum(), xt, create_graph=True)
    _, jdw = jax.jvp(jeh.tophat_window, (jnp.asarray(x),),
                     (jnp.ones_like(jnp.asarray(x)),))
    close(dw.detach(), jdw, rtol=1e-13, atol=1e-16)
    (d2w,) = torch.autograd.grad(dw.sum(), xt)
    jd2w = jax.vmap(jax.grad(jax.grad(jeh.tophat_window)))(jnp.asarray(x))
    close(d2w, jd2w, rtol=1e-12, atol=1e-15)
    # the series branch is what keeps small x accurate: against the exact
    # derivative -3 j2(x) / x
    from scipy.special import spherical_jn
    small = x < 0.35
    close(dw.detach()[small], -3.0 * spherical_jn(2, x[small]) / x[small],
          rtol=1e-7)


# ---------------------------------------------------------------------------
# ESM state and profile functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['eh', 'table', 'grid'])
def test_esm_state_vs_jax(bundles, mode):
    jb, tb = bundles[mode]
    st = tesm.esm_state(tb.tables, tb.spec, tp(*POINTS))
    for i, p in enumerate(POINTS):
        jst = jesm.esm_state(jb.tables, jb.spec, jp(p))
        for key in ('pk', 'Dz', 's8z', 'delta_c'):
            close(st[key][i], jst[key], rtol=1e-12)
    close(tesm.esm_s8z(tb.tables, tb.spec, tp(*POINTS)),
          [float(jesm.esm_s8z(jb.tables, jb.spec, jp(p))) for p in POINTS],
          rtol=1e-12)


def test_grid_interp_defaults_and_clamp_vs_jax(bundles):
    """Parameters absent (the EH defaults) and outside the grid hull."""
    jb, tb = bundles['grid']
    points = [{k: v for k, v in ESM_PARAMS.items() if k not in ('ns', 'H0')},
              {k: v for k, v in ESM_PARAMS.items() if k != 'ns'}]
    points[1]['H0'] = 60.0
    for p in points:
        got = tesm._esm_grid_interp(tb.tables, tb.spec, tp(p))
        want = jesm._esm_grid_interp(jb.tables, jb.spec, jp(p))
        for g, w in zip(got, want):
            close(g[0], w, rtol=1e-13)


@pytest.fixture(scope='module')
def w0_grid_path(tmp_path_factory):
    """A grid over H0 and 'w0', an axis that neither package gives a default
    value: w0 tilts log P(k) and scales both sigma8 tables, and the grid
    spans w0 = 0 between two of its nodes."""
    k = np.logspace(-4, np.log10(2.0), 400)
    axes = {'H0': np.array([65.0, 67.5, 70.0]),
            'w0': np.array([-0.4, 0.1, 0.6])}
    logpk = np.empty((3, 3, len(k)))
    s80g, s8zg = np.empty((3, 3)), np.empty((3, 3))
    for i, j in itertools.product(range(3), range(3)):
        p = jeh.eisenstein_hu_params(axes['H0'][i] / 100.0, 0.31, 0.048,
                                     ns=0.96, As=2e-9)
        w0 = axes['w0'][j]
        logpk[i, j] = np.log(np.asarray(jeh.power_eh(p, jnp.asarray(k)))) \
            + 0.2 * w0 * np.log(k / 0.1)
        s80g[i, j] = float(jeh.sigma80(p)) * (1.0 + 0.05 * w0)
        s8zg[i, j] = s80g[i, j] * float(jspecial.growth_factor_lcdm(
            Z_EFF, 0.31, 0.69))
    path = tmp_path_factory.mktemp('w0grid') / 'pk_grid_w0.npz'
    np.savez(path, k=k, axis_names=np.asarray(list(axes)), logpk0=logpk,
             sigma8_0=s80g, sigma8_z=s8zg, z=Z_EFF,
             **{f'grid_{n}': a for n, a in axes.items()})
    return str(path)


def test_grid_axis_without_default_reads_zero_like_jax(boss_config,
                                                       w0_grid_path):
    """The open decision on victor_tpu/models/esm.py:93 (ROADMAP Queue 3),
    mirrored: a grid axis that the parameters do not name and that has no
    default is read at 0.0, silently, by both packages. The P(k) of a point
    without w0 equals the one at w0 = 0 and victor_tpu's, and differs from
    one at another w0."""
    cfg = _esm_cfg(boss_config, use_eisenstein_hu=False,
                   pk_grid_file=w0_grid_path)
    jb, tb = pair(cfg['model'], cfg['data'])
    assert tb.spec.esm_grid_names == ('H0', 'w0')
    point = {k: v for k, v in ESM_PARAMS.items() if k != 'w0'}
    got = tesm.esm_state(tb.tables, tb.spec, tp(point))
    want = jesm.esm_state(jb.tables, jb.spec, jp(point))
    for key in ('pk', 's8z'):
        close(got[key][0], want[key], rtol=1e-12)
    at_zero = tesm.esm_state(tb.tables, tb.spec, tp({**point, 'w0': 0.0}))
    jax_zero = jesm.esm_state(jb.tables, jb.spec, jp({**point, 'w0': 0.0}))
    np.testing.assert_array_equal(got['pk'].numpy(), at_zero['pk'].numpy())
    close(want['pk'], jax_zero['pk'], rtol=0)
    other = tesm.esm_state(tb.tables, tb.spec, tp({**point, 'w0': -0.3}))
    assert not np.allclose(got['pk'].numpy(), other['pk'].numpy(), rtol=0.05)


@pytest.fixture(scope='module')
def states(bundles):
    """(port state of both points, victor_tpu state of each) in EH mode."""
    jb, tb = bundles['eh']
    return (tesm.esm_state(tb.tables, tb.spec, tp(*POINTS)),
            [jesm.esm_state(jb.tables, jb.spec, jp(p)) for p in POINTS])


def _per_point(name):
    return torch.tensor([p[name] for p in POINTS], dtype=torch.float64)


def test_variance_integrals_vs_jax(states):
    st, jsts = states
    Rq = np.linspace(5.0, 80.0, 12)
    Rp, Rx = _per_point('Rp'), _per_point('Rx')
    got_pq = {j: tesm._sj_pq(st, Rp, _t(Rq), Rx, j=j) for j in (0, 1)}
    got_pp = {j: tesm._sj_pp(st, Rp, Rx, j=j) for j in (0, 1)}
    got_d = tesm._s0_derivative_term(st, Rp, _t(Rq), Rx)
    for i, p in enumerate(POINTS):
        for j in (0, 1):
            close(got_pq[j][i], jesm._sj_pq(jsts[i], p['Rp'], jnp.asarray(Rq),
                                            p['Rx'], j=j), rtol=1e-12)
            close(got_pp[j][i], jesm._sj_pp(jsts[i], p['Rp'], p['Rx'], j=j),
                  rtol=1e-12)
        close(got_d[i], jesm._s0_derivative_term(jsts[i], p['Rp'],
                                                 jnp.asarray(Rq), p['Rx']),
              rtol=1e-10)


def test_lagrangian_and_eulerian_profiles_vs_jax(states, bundles):
    st, jsts = states
    jb, tb = bundles['eh']
    args = [_per_point(k) for k in ('b10', 'b01', 'Rp', 'Rx')]
    Rq = np.linspace(5.0, 100.0, 10)
    lag = tesm.lagrangian_profile(st, _t(Rq), *args)
    r_e, one_h = tesm.eulerian_1halo(st, tb.tables.r_v, *args)
    two_h = tesm.eulerian_2halo(st, r_e, args[2], args[3])
    enc = tesm.enclosed_profile_at(tb.tables, tb.spec, tp(*POINTS),
                                   tb.tables.r_v)
    q = np.linspace(0.5, 110.0, 37)
    evo = tesm.density_evolution_at(tb.tables, tb.spec, tp(*POINTS), _t(q))
    evo2 = tesm.density_evolution_at(tb.tables, tb.spec, tp(*POINTS), _t(q),
                                     pairwise=True)
    for i, p in enumerate(POINTS):
        ja = [p[k] for k in ('b10', 'b01', 'Rp', 'Rx')]
        close(lag[i], jesm.lagrangian_profile(jsts[i], jnp.asarray(Rq), *ja),
              rtol=1e-10)
        jr_e, jone = jesm.eulerian_1halo(jsts[i], jb.tables.r_v, *ja)
        close(r_e[i], jr_e, rtol=1e-12)
        close(one_h[i], jone, rtol=1e-10, atol=1e-14)
        close(two_h[i], jesm.eulerian_2halo(jsts[i], jr_e, ja[2], ja[3]),
              rtol=1e-12)
        close(enc[i], jesm.enclosed_profile_at(jb.tables, jb.spec, jp(p),
                                               jb.tables.r_v),
              rtol=1e-10, atol=1e-14)
        close(evo[i], jesm.density_evolution_at(jb.tables, jb.spec, jp(p),
                                                jnp.asarray(q)),
              rtol=1e-10, atol=1e-14)
        close(evo2[i], jesm.density_evolution_at(jb.tables, jb.spec, jp(p),
                                                 jnp.asarray(q),
                                                 pairwise=True),
              rtol=1e-10, atol=1e-14)


def test_masked_monotone_interp_shell_crossing_vs_jax():
    """The fixed-shape cleanup: a regular row, a row with a shell-crossed
    (non-monotone) radius and a NaN, and a row with a NaN value; the dropped
    points are re-sorted past the last kept radius."""
    rng = np.random.default_rng(54)
    r = np.sort(rng.uniform(1.0, 100.0, (3, 20)), axis=1)
    v = np.cos(r / 20.0)
    r[1, 5], r[1, 12] = r[1, 9] + 0.5, np.nan
    v[2, 3] = np.nan
    q = np.linspace(0.5, 105.0, 50)
    got = tesm._masked_monotone_interp(_t(r), _t(v), _t(q))
    for b in range(3):
        close(got[b], jesm._masked_monotone_interp(
            jnp.asarray(r[b]), jnp.asarray(v[b]), jnp.asarray(q)),
            rtol=1e-11, atol=1e-13)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize('mean_model,empirical', [
    ('linear', False), ('linear', True), ('nonlinear', False),
    ('nonlinear', True)])
def test_esm_profiles_and_velocity_terms_vs_jax(bundles, mean_model,
                                               empirical):
    jb, tb = bundles['eh']
    kw = {'mean_model': mean_model, 'empirical_corr': empirical}
    points = [{**p, 'Av': 0.4} for p in POINTS]
    got_d = tth.delta_profiles(tb.tables, tb.spec,
                               tb.theory_opts.replace(**kw), tp(*points))
    got_v = tth.velocity_terms(tb.tables, tb.spec,
                               tb.theory_opts.replace(**kw), tp(*points))
    for i, p in enumerate(points):
        want_d = jth.delta_profiles(jb.tables, jb.spec,
                                    jb.theory_opts.replace(**kw), jp(p))
        for g, w in zip(got_d, want_d):
            close(g[i], w, rtol=1e-10, atol=1e-13)
        want_v = jth.velocity_terms(jb.tables, jb.spec,
                                    jb.theory_opts.replace(**kw), jp(p))
        for g, w in zip(got_v, want_v):
            close(g[i], w, rtol=1e-10, atol=1e-11)


# ---------------------------------------------------------------------------
# tables and the ESM likelihood
# ---------------------------------------------------------------------------

def _leaves_equal(got, want):
    for key, w in want.items():
        g = got[key]
        assert (g is None) == (w is None), key
        if isinstance(w, tuple):
            assert len(g) == len(w), key
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=key)
        elif w is not None:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize('mode', ['eh', 'table', 'grid'])
def test_esm_tables_equal_jax(configs, bundles, mode):
    """The port's own build of each P(k) mode, leaf by leaf."""
    cfg = configs[mode]
    jb, _ = bundles[mode]
    tb = build_tables(copy.deepcopy(cfg['model']), copy.deepcopy(cfg['data']),
                      device='cpu')
    _leaves_equal(tables_to_arrays(tb.tables), tables_to_arrays(jb.tables))
    assert dataclasses.asdict(tb.spec) == dataclasses.asdict(jb.spec)
    assert tb.spec.esm_use_eh == (mode == 'eh')
    moved = tb.to('cpu', torch.float32).tables
    if mode == 'grid':
        assert moved.esm_grid_axes[0].dtype == torch.float32


@pytest.mark.parametrize('fault', ['shape', 'axis'])
def test_bad_pk_grid_raises_like_jax(boss_config, pk_grid_path, tmp_path,
                                     fault):
    g = dict(np.load(pk_grid_path, allow_pickle=False))
    if fault == 'shape':
        g['logpk0'] = g['logpk0'][:2]
    else:
        g['grid_H0'] = np.array([70.0, 67.5, 65.0])
    bad = tmp_path / 'bad.npz'
    np.savez(bad, **g)
    cfg = _esm_cfg(boss_config, use_eisenstein_hu=False, pk_grid_file=str(bad))
    match = 'does not match the axis' if fault == 'shape' \
        else 'strictly increasing'
    with pytest.raises(InputError, match=match):
        build_tables(cfg['model'], cfg['data'], device='cpu')
    with pytest.raises(JaxInputError, match=match):
        jax_build_tables(cfg['model'], cfg['data'])


@pytest.mark.parametrize('opts_kw', [
    EXACT,
    EXACT_DISP,
    {**EXACT_DISP, 'dispersion_final': 'fused'},
], ids=['streaming', 'dispersion', 'dispersion_fused'])
@pytest.mark.parametrize('mode', ['eh', 'table', 'grid'])
def test_esm_likelihood_vs_jax(bundles, mode, opts_kw):
    """xi(s, mu) at 1e-12 and chi^2 / lnL at 1e-9 under both RSD models.
    The BOSS config rescales its templates by the AP mu-integral, so resc
    differs from 1 while the ESM's resc_vel is 1: the two stay apart in both
    models. 'fused' runs the final stage's plain version on the CPU, held
    to victor_tpu's exact final stage."""
    jb, tb = bundles[mode]
    assert not tb.theory_opts.velocity_independent_of_AP
    jax_kw = {**opts_kw, 'dispersion_final': 'exact'} \
        if opts_kw.get('dispersion_final') == 'fused' else opts_kw
    opts = tb.theory_opts.replace(**opts_kw)
    jopts = jb.theory_opts.replace(**jax_kw)
    got = tth.theory_xi_grid(tb.tables, tb.spec, opts, tp(*POINTS))
    lnl, chi2 = tlk.log_likelihood(tb.tables, tb.spec, opts, tb.fit_opts,
                                   tp(*POINTS))
    for i, p in enumerate(POINTS):
        want = jth.theory_xi_grid(jb.tables, jb.spec, jopts, jp(p))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0,
                                   atol=XI_ATOL)
        jl, jc = jlk.log_likelihood(jb.tables, jb.spec, jopts, jb.fit_opts,
                                    jp(p))
        assert abs(float(chi2[i]) - float(jc)) < LIKE_ATOL
        assert abs(float(lnl[i]) - float(jl)) < LIKE_ATOL


@pytest.mark.parametrize('opts_kw', [
    {'mean_model': 'nonlinear'},
    {'mean_model': 'nonlinear', **EXACT_DISP},
    {'streaming_eval': 'fast'},
    {'rsd_model': 'kaiser'},
    {'velocity_independent_of_AP': True},
], ids=['nonlinear', 'nonlinear_dispersion', 'streaming_fast', 'kaiser',
        'astar'])
def test_esm_other_modes_vs_jax(bundles, opts_kw):
    jb, tb = bundles['eh']
    points = [{**p, 'astar': 1.02} for p in POINTS]
    opts = tb.theory_opts.replace(**opts_kw)
    jopts = jb.theory_opts.replace(**opts_kw)
    got = tth.theory_xi_grid(tb.tables, tb.spec, opts, tp(*points))
    for i, p in enumerate(points):
        want = jth.theory_xi_grid(jb.tables, jb.spec, jopts, jp(p))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0,
                                   atol=XI_ATOL)

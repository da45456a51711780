"""The port's optimizer layer (`sampling/optimize.py`, `mocks.py`,
`gof.py`) against victor_tpu's.

The steps are held with their starts injected: the hand-written Adam
against `optax.adam` and the damped Newton step against victor_tpu's, on a
Gaussian and a curved target, per step. Whole runs (find_map,
profile_scan, fisher_forecast, parametric_bootstrap) are held by what does
not depend on the starts: the optimum, its Laplace covariance, the profile
chi2 at each grid point, the Fisher matrix, the refits of the same mocks.
Both packages get the same tables (bundle_from_arrays of victor_tpu's) at
a narrow width (n_mu 20, n_v 10) for the whole runs; the goldens that
chip_smoke.py holds the card to are recomputed at full width. Everything
is float64 with one thread.
"""

import ast
import copy
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victor_tpu.io import build_tables as jax_build_tables
from victor_tpu.sampling import gof as jgof
from victor_tpu.sampling import mocks as jmocks
from victor_tpu.sampling import optimize as jopt
from victor_tpu.sampling.priors import ParamSpace as JParamSpace
from victor_tpu_torch.io.tables import bundle_from_arrays, tables_to_arrays
from victor_tpu_torch.sampling import gof as tgof
from victor_tpu_torch.sampling import mocks as tmocks
from victor_tpu_torch.sampling import optimize as topt
from victor_tpu_torch.sampling.priors import ParamSpace

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = {'n_mu': 20, 'n_v': 10}
# the fits' settings here: victor_tpu's parametric_bootstrap defaults, so
# that one compiled fit serves every whole-run test
FIT_KW = dict(n_starts=4, adam_steps=120, newton_steps=6)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _sampling_config():
    import yaml
    with open(os.path.join(REPO, 'configs',
                           'boss_sampling_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    return cfg


def _pair(cfg, **width):
    jb = jax_build_tables(copy.deepcopy(cfg['model']),
                          copy.deepcopy(cfg['data']), **width)
    tb = bundle_from_arrays(tables_to_arrays(jb.tables),
                            dataclasses.asdict(jb.spec),
                            dataclasses.asdict(jb.theory_opts),
                            dataclasses.asdict(jb.fit_opts), device='cpu')
    return jb, tb


def _chip_smoke_literals(*names):
    tree = ast.parse(open(os.path.join(REPO, 'chip_smoke.py')).read())
    found = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name) and t.id in names}
    return tuple(found[n] for n in names)


# ---------------------------------------------------------------------------
# targets for the step tests: a correlated Gaussian and a curved (banana)
# likelihood, as victor_tpu's per-point callables and the port's batched ones
# ---------------------------------------------------------------------------

MU = np.array([0.5, -0.3])
COV = np.array([[1.0, 0.6], [0.6, 0.8]])
ICOV = np.linalg.inv(COV)
BOX = {'x': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}},
       'y': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}}}


def _chi2(x, y, curved):
    if curved:      # a banana: y follows x^2 (Rosenbrock-like)
        return (x - 0.3) ** 2 / 0.04 + (y - x * x) ** 2 / 0.01
    dx, dy = x - MU[0], y - MU[1]
    return ICOV[0, 0] * dx * dx + 2.0 * ICOV[0, 1] * dx * dy + \
        ICOV[1, 1] * dy * dy


def _targets(curved):
    def jax_like(params):
        c = _chi2(params['x'], params['y'], curved)
        return -0.5 * c, c

    def torch_like(params):
        c = _chi2(params['x'], params['y'], curved)
        return -0.5 * c, c
    return jax_like, torch_like


def _jax_neg_y(target, block):
    space = JParamSpace(block)
    _, _, neg_y, _, _ = jopt._make_objectives(target, space, None, None)
    return space, lambda y: neg_y(None, y)


def _torch_neg_y(target, block):
    space = ParamSpace(block)
    _, _, neg_y, _ = topt._make_objectives(target, space, None, None)
    return space, neg_y


STARTS = np.array([[0.3, -0.2], [-2.5, 1.7], [1.9, 3.8], [-0.4, -4.1]])


@pytest.mark.parametrize('curved', [False, True])
def test_adam_steps_match_optax(curved):
    """The hand-written Adam on every start at once against optax.adam in
    victor_tpu's step (value_and_grad, non-finite gradients to 0,
    opt.update, apply_updates), starts injected, each of 60 steps within
    1e-10."""
    import optax
    jt, tt = _targets(curved)
    jspace, jneg = _jax_neg_y(jt, BOX)
    tspace, tneg = _torch_neg_y(tt, BOX)
    y0 = np.asarray(jspace.to_unbounded(jnp.asarray(STARTS)))
    opt = optax.adam(0.05)
    step = jax.jit(jax.vmap(lambda y, st: (lambda g: opt.update(
        jnp.where(jnp.isfinite(g), g, 0.0), st, y))(jax.grad(jneg)(y))))
    jy = jnp.asarray(y0)
    st = jax.vmap(opt.init)(jy)
    ty = _t(y0)
    mu, nu = torch.zeros_like(ty), torch.zeros_like(ty)
    for count in range(1, 61):
        upd, st = step(jy, st)
        jy = optax.apply_updates(jy, upd)
        _, g = topt._value_and_grad(tneg, ty)
        g = torch.where(torch.isfinite(g), g, 0.0)
        tupd, mu, nu = topt._adam_update(g, mu, nu, count, 0.05)
        ty = ty + tupd
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-10, err_msg=f'step {count}')
    # the descent helper takes the same steps
    ty2, vals = topt._adam_descent(tneg, _t(y0), 60, 0.05)
    np.testing.assert_array_equal(ty2.numpy(), ty.numpy())
    np.testing.assert_array_equal(vals.numpy(), tneg(ty).numpy())


@pytest.mark.parametrize('curved', [False, True])
def test_damped_newton_step_matches_victor_tpu(curved):
    """The damped Newton step of every row at once against victor_tpu's
    `_damped_newton_step` per point, from the starts and along a chain of
    5 steps each, within 1e-10; a non-improving step is rejected by both
    (the row stays), and a start at NaN stays NaN."""
    jt, tt = _targets(curved)
    jspace, jneg = _jax_neg_y(jt, BOX)
    _, tneg = _torch_neg_y(tt, BOX)
    y = np.asarray(jspace.to_unbounded(jnp.asarray(STARTS)))
    jstep = jax.jit(lambda yy: jopt._damped_newton_step(jneg, yy))
    ty = _t(y)
    for _ in range(5):
        want = np.stack([np.asarray(jstep(jnp.asarray(r))) for r in y])
        ty = topt._damped_newton_step(tneg, ty)
        np.testing.assert_allclose(ty.numpy(), want, rtol=0, atol=1e-10)
        y = want
    # near a corner of the box the full step does not improve: both reject
    # it and the row stays; a NaN start stays too
    far = np.asarray(jspace.to_unbounded(jnp.asarray([-4.5, 4.5])))
    bad = np.stack([far, [np.nan, 0.0]])
    got = topt._damped_newton_step(tneg, _t(bad)).numpy()
    np.testing.assert_array_equal(got[0], far)
    np.testing.assert_array_equal(np.asarray(jstep(jnp.asarray(far))), far)
    assert np.isnan(got[1, 0]) and got[1, 1] == 0.0


def test_value_grad_hessian_chunks_and_row_arguments(monkeypatch):
    """Replicated rows in chunks of any size give the same values,
    gradients and Hessians, and per-row arguments travel with their rows."""
    _, tt = _targets(True)
    _, tneg = _torch_neg_y(tt, BOX)
    y = _t(STARTS)
    shift = _t(np.arange(4.0)[:, None] * np.array([[0.1, -0.2]]))

    def fn(yy, s):
        return tneg(yy + s)
    full = topt.value_grad_hessian(fn, y, shift)
    for max_rows in (1, 2, 5, 7):
        monkeypatch.setattr(topt, 'MAX_ROWS', max_rows)
        part = topt.value_grad_hessian(fn, y, shift)
        for a, b in zip(part, full):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref = torch.autograd.functional.hessian(
        lambda v: fn(v[None], shift[2:3])[0], y[2])
    np.testing.assert_allclose(full[2][2].numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)
    monkeypatch.setattr(topt, 'MAX_ROWS', 2)
    J = topt.jacobian_rows(lambda th: torch.stack(
        [th[:, 0] ** 2, th[:, 0] * th[:, 1], torch.sin(th[:, 1])], -1),
        _t([0.7, -1.2]), 3)
    np.testing.assert_allclose(J.numpy(), [[1.4, 0.0], [-1.2, 0.7],
                                           [0.0, math.cos(-1.2)]],
                               rtol=1e-15)


# ---------------------------------------------------------------------------
# whole runs on the BOSS likelihood (narrow width)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def boss():
    cfg = _sampling_config()
    jb, tb = _pair(cfg, **REDUCED)
    return cfg, jb, tb


@pytest.fixture(scope='module')
def maps(boss):
    """find_map of both packages on the BOSS posterior: (victor_tpu's,
    the port's)."""
    cfg, jb, tb = boss
    return (jopt.find_map(jb, cfg['params'], seed=3, **FIT_KW),
            topt.find_map(tb, cfg['params'], seed=3, device='cpu', **FIT_KW))


def _check_map(got, want, theta_sigma=1e-4, chi2_tol=1e-6, std_rel=1e-6):
    sd = np.sqrt(np.diag(want.cov))
    assert np.all(np.abs(got.theta - want.theta) <= theta_sigma * sd), \
        (got.theta - want.theta) / sd
    assert abs(got.chi2 - want.chi2) <= chi2_tol
    np.testing.assert_allclose(np.sqrt(np.diag(got.cov)), sd, rtol=std_rel)
    assert got.hessian_pd and want.hessian_pd


def test_find_map_matches_victor_tpu(maps):
    """The MAP of the BOSS posterior (4 starts, 120 Adam steps, 6 Newton
    steps): theta within 1e-4 Laplace sigma, chi2 within 1e-6, each Laplace
    sigma within 1e-6 relative, lnpost/lnlike within 1e-6, the gradient
    stationary, the same number of finite starts, and the truncated Laplace
    evidence within the Genz integral's noise."""
    jres, tres = maps
    _check_map(tres, jres)
    assert tres.grad_norm < 1e-6
    assert abs(tres.lnpost - jres.lnpost) < 1e-6
    assert abs(tres.lnlike - jres.lnlike) < 1e-6
    assert tres.n_converged == jres.n_converged == FIT_KW['n_starts']
    np.testing.assert_allclose(tres.correlation, jres.correlation, rtol=0,
                               atol=1e-6)
    assert abs(tres.log_evidence_laplace - jres.log_evidence_laplace) < 1e-3
    assert tres.log_evidence_laplace == tres.log_evidence_laplace  # memoized
    assert tres.summary().keys() == jres.summary().keys()


def test_diverging_rows_leave_the_others_alone(boss):
    """Rows planted outside the posterior (a NaN start, and one at the
    prior's edge, beta = 0.6 and the others at their midpoints) do not
    reach the other rows: their values, gradients, Hessians and Adam
    descents equal those computed without the planted rows."""
    cfg, _, tb = boss
    space = ParamSpace(cfg['params'])
    _, _, neg_y, _ = topt._make_objectives(tb, space, None, None)
    good = space.to_unbounded(_t([[0.47, 0.37, 380.0, 1.0],
                                  [0.55, 0.39, 420.0, 1.02]]))
    planted = torch.cat([good[:1], _t([[math.nan] * 4]),
                         _t([[0.0, 1e3, 0.0, 0.0]]), good[1:]])
    alone = topt.value_grad_hessian(neg_y, good)
    mixed = topt.value_grad_hessian(neg_y, planted)
    for a, m in zip(alone, mixed):
        np.testing.assert_allclose(m[[0, 3]].numpy(), a.numpy(), rtol=1e-13,
                                   atol=0)
    assert not np.isfinite(mixed[0][1].numpy())
    ya, va = topt._adam_descent(neg_y, good, 5, 0.05)
    ym, vm = topt._adam_descent(neg_y, planted, 5, 0.05)
    np.testing.assert_allclose(ym[[0, 3]].numpy(), ya.numpy(), rtol=1e-13,
                               atol=0)
    np.testing.assert_allclose(vm[[0, 3]].numpy(), va.numpy(), rtol=1e-13)


def test_profile_scan_matches_victor_tpu(boss, maps):
    """A 1D profile of fsigma8 from each package's own MAP on one explicit
    grid of 5 points in chunks of 2 (one padded): the profile chi2 within
    1e-6 and the nuisance optima within 1e-4 of their Laplace sigma, row
    for row; then the default grid (MAP +/- 4 sigma) of the port's scan
    from its MAP."""
    cfg, jb, tb = boss
    jmap, tmap = maps
    sd = np.sqrt(jmap.cov[0, 0])
    grid = jmap.theta[0] + sd * np.array([-2.0, -1.0, 0.0, 1.5, 3.0])
    kw = dict(grid=grid, adam_steps=60, newton_steps=6, grid_chunk=2)
    jres = jopt.profile_scan(jb, cfg['params'], 'fsigma8', map_result=jmap,
                             **kw)
    tres = topt.profile_scan(tb, cfg['params'], 'fsigma8', map_result=tmap,
                             device='cpu', **kw)
    assert tres.free_names == jres.free_names == ('beta', 'sigma_v',
                                                  'epsilon')
    np.testing.assert_allclose(tres.chi2, jres.chi2, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tres.lnlike, jres.lnlike, rtol=0, atol=1e-6)
    free_sd = np.sqrt(np.diag(jmap.cov))[1:]
    assert np.all(np.abs(tres.free_optima - jres.free_optima)
                  <= 1e-4 * free_sd)
    # at the MAP's own fsigma8 the profile is the MAP
    assert abs(tres.chi2[2] - tmap.chi2) < 1e-6
    lo, hi = tres.interval(1.0)
    jlo, jhi = jres.interval(1.0)
    assert abs(lo - jlo) < 1e-6 and abs(hi - jhi) < 1e-6
    # the default grid construction, from the port's MAP
    res = topt.profile_scan(tb, cfg['params'], 'fsigma8', n_grid=3,
                            n_sigma=2.0, adam_steps=5, newton_steps=0,
                            map_result=tmap, device='cpu')
    sd_t = np.sqrt(tmap.cov[0, 0])
    np.testing.assert_allclose(res.grid[:, 0], tmap.theta[0] + sd_t *
                               np.array([-2.0, 0.0, 2.0]), rtol=1e-14)
    with pytest.raises(ValueError):
        topt.profile_scan(tb, cfg['params'], 'not_a_param',
                          map_result=tmap, device='cpu')


def test_fisher_forecast_matches_victor_tpu(boss):
    """The Fisher matrix at the ref point against victor_tpu's jacfwd one,
    within 1e-9 relative; and with a derived beta (beta from a lambda of
    bx, the forecast parameter), whose fiducial beta comes from the
    lambda."""
    cfg, jb, tb = boss
    names = ('fsigma8', 'beta', 'sigma_v', 'epsilon')
    fid = {'fsigma8': 0.47, 'beta': 0.4, 'sigma_v': 380.0, 'epsilon': 1.0}
    jres = jopt.fisher_forecast(jb, fid, names)
    tres = topt.fisher_forecast(tb, fid, names)
    np.testing.assert_allclose(tres.fisher, jres.fisher, rtol=1e-9,
                               atol=1e-9 * np.abs(jres.fisher).max())
    np.testing.assert_allclose(tres.cov, jres.cov, rtol=1e-8)
    assert tres.std.keys() == jres.std.keys()
    block = {'fsigma8': cfg['params']['fsigma8'],
             'bx': {'prior': {'dist': 'uniform', 'min': 0.1, 'max': 1.0},
                    'ref': 0.8},
             'beta': {'value': 'lambda bx: 0.5 * bx'},
             'sigma_v': cfg['params']['sigma_v'],
             'epsilon': cfg['params']['epsilon']}
    fid2 = {'fsigma8': 0.47, 'bx': 0.8, 'sigma_v': 380.0, 'epsilon': 1.0,
            'beta': 0.9}       # the explicit beta loses to the lambda's
    dnames = ('fsigma8', 'bx', 'sigma_v', 'epsilon')
    jres = jopt.fisher_forecast(jb, fid2, dnames,
                                derived=JParamSpace(block).derived)
    tres = topt.fisher_forecast(tb, fid2, dnames,
                                derived=ParamSpace(block).derived)
    np.testing.assert_allclose(tres.fisher, jres.fisher, rtol=1e-9,
                               atol=1e-9 * np.abs(jres.fisher).max())
    from victor_tpu_torch.errors import InputError
    with pytest.raises(InputError):
        topt.fisher_forecast(tb, {k: v for k, v in fid.items()
                                  if k != 'beta'}, ('fsigma8',))


def test_parametric_bootstrap_matches_victor_tpu(boss, maps):
    """Four refits of the same mocks (np.random.default_rng, as victor_tpu
    draws them) from each package's MAP: every refit within 1e-4 of its
    Laplace sigma of victor_tpu's, and so the bias and the bootstrap
    covariance."""
    cfg, jb, tb = boss
    jmap, tmap = maps
    jres = jopt.parametric_bootstrap(jb, cfg['params'], jmap, n_boot=4,
                                     seed=11)
    tres = topt.parametric_bootstrap(tb, cfg['params'], tmap, n_boot=4,
                                     seed=11, device='cpu')
    sd = np.sqrt(np.diag(jmap.cov))
    assert tres.n_failed == jres.n_failed == 0
    assert np.all(np.abs(tres.theta_boot - jres.theta_boot) <= 1e-4 * sd)
    assert np.all(np.abs(tres.bias - jres.bias) <= 1e-4 * sd)
    np.testing.assert_allclose(np.sqrt(np.diag(tres.cov)),
                               np.sqrt(np.diag(jres.cov)), rtol=1e-3)
    assert tres.debiased.keys() == jres.debiased.keys()


def test_mocks_match_victor_tpu(boss):
    """mock_setup (theory and data vectors at the fiducial and the Cholesky
    factor of the covariance there) and shift_datavector against
    victor_tpu's."""
    _, jb, tb = boss
    fid = {'fsigma8': 0.5, 'beta': 0.38, 'sigma_v': 400.0, 'epsilon': 1.01,
           'bias': 1.9}
    want = jmocks.mock_setup(jb, fid)
    got = tmocks.mock_setup(tb, fid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-14)
    delta = np.random.default_rng(2).standard_normal(len(want[0]))
    jshift = jmocks.shift_datavector(jb, delta)
    tshift = tmocks.shift_datavector(tb, delta)
    np.testing.assert_array_equal(
        tshift.tables.data_mult_pchip_c.numpy(),
        np.asarray(jshift.tables.data_mult_pchip_c))
    assert tb.tables.data_mult_pchip_c is not tshift.tables.data_mult_pchip_c


def test_gof_matches_victor_tpu():
    chi2 = np.array([40.0, 56.96, 70.0, 90.0])
    for form, nmocks in (('gaussian', None), ('sellentin', 1000),
                         ('Hartlap', 1000), ('percival', 50)):
        np.testing.assert_array_equal(
            tgof.chi2_tail_probability(chi2, 56, form, nmocks),
            jgof.chi2_tail_probability(chi2, 56, form, nmocks))
        assert tgof.chi2_tail_probability(56.96, 56, form, nmocks) == \
            jgof.chi2_tail_probability(56.96, 56, form, nmocks)
        assert tgof.posterior_predictive_pvalue(chi2, 60, form, nmocks) == \
            jgof.posterior_predictive_pvalue(chi2, 60, form, nmocks)


def test_laplace_evidence_of_a_gaussian_is_exact():
    """For a Gaussian likelihood under a wide uniform box the Laplace
    evidence is the evidence (tests/test_optimize.py's case), with the
    port's find_map end to end."""
    _, tt = _targets(False)
    block = {k: {'prior': {'dist': 'uniform', 'min': -20.0, 'max': 20.0}}
             for k in ('x', 'y')}
    m = topt.find_map(tt, block, n_starts=4, adam_steps=300, newton_steps=6,
                      seed=0, device='cpu')
    want = (-np.log(40.0 * 40.0) + np.log(2.0 * np.pi)
            + 0.5 * np.linalg.slogdet(COV)[1])
    assert abs(m.log_evidence_laplace - want) < 1e-3
    np.testing.assert_allclose(m.cov, COV, rtol=1e-8)


def test_fd_hessian_fallback_when_the_exact_one_is_not_finite(monkeypatch,
                                                              caplog):
    """When the exact Hessian comes out non-finite, find_map logs it and
    takes central differences of the gradient, as victor_tpu does."""
    _, tt = _targets(False)
    real = topt.value_grad_hessian

    def poisoned(fn, y, *rows, **kw):
        v, g, H = real(fn, y, *rows, **kw)
        return v, g, H * math.nan
    monkeypatch.setattr(topt, 'value_grad_hessian', poisoned)
    with caplog.at_level('INFO', logger='victor_tpu_torch'):
        m = topt.find_map(tt, BOX, n_starts=2, adam_steps=100,
                          newton_steps=0, seed=0, device='cpu')
    assert any('finite differences' in r.getMessage()
               for r in caplog.records)
    np.testing.assert_allclose(m.cov, COV, rtol=1e-3)


# ---------------------------------------------------------------------------
# the goldens of chip_smoke.py's phase 13, recomputed with victor_tpu at
# full width
# ---------------------------------------------------------------------------

def golden_fit(jb, cfg):
    """FIT_GOLDENS: victor_tpu's MAP of configs/boss_sampling_config.yaml
    (the optimum does not depend on the starts: 4 starts, 120 Adam steps, 8
    Newton steps), as {'theta', 'chi2', 'std'}."""
    res = jopt.find_map(jb, cfg['params'], n_starts=4, adam_steps=120,
                        newton_steps=8, seed=0)
    return res, {'theta': res.theta.tolist(), 'chi2': res.chi2,
                 'std': np.sqrt(np.diag(res.cov)).tolist()}


def golden_fisher(jb, cfg):
    """FISHER_GOLDENS: victor_tpu's Fisher sigmas at the config's ref point
    (the CLI's `forecast` fiducial)."""
    space = JParamSpace(cfg['params'])
    fid = {p.name: p.ref_loc for p in space.sampled}
    res = jopt.fisher_forecast(jb, fid, space.names, derived=space.derived)
    return [res.std[n] for n in space.names]


def golden_scan(jb, cfg, jmap):
    """SCAN_GOLDENS: victor_tpu's profile of fsigma8 on the CLI's default
    grid (9 points, 4 sigma), from its MAP: {'grid', 'chi2'}."""
    res = jopt.profile_scan(jb, cfg['params'], 'fsigma8', n_grid=9,
                            map_result=jmap)
    return {'grid': res.grid[:, 0].tolist(), 'chi2': res.chi2.tolist()}


def golden_bootstrap(jb, cfg, jmap):
    """BOOT_GOLDENS: victor_tpu's refits of `fit --bootstrap 4` (seed 0:
    the mocks of np.random.default_rng(0) at its MAP, its defaults), as
    (4, 4) in the params block's order."""
    import victor_tpu.sampling.optimize as jo
    refits, real = [], jo.find_map

    def recording(*args, **kw):
        res = real(*args, **kw)
        refits.append(res)
        return res
    jo.find_map = recording
    try:
        jopt.parametric_bootstrap(jb, cfg['params'], jmap, n_boot=4, seed=0)
    finally:
        jo.find_map = real
    names = list(cfg['params'])
    return [[r.params[n] for n in names] for r in refits]


@pytest.fixture(scope='module')
def full_width():
    cfg = _sampling_config()
    return cfg, jax_build_tables(copy.deepcopy(cfg['model']),
                                 copy.deepcopy(cfg['data']))


def test_chip_smoke_fisher_goldens(full_width):
    (want,) = _chip_smoke_literals('FISHER_GOLDENS')
    np.testing.assert_allclose(want, golden_fisher(*full_width[::-1]),
                               rtol=1e-10)


@pytest.mark.slow
def test_chip_smoke_fit_scan_and_bootstrap_goldens(full_width):
    """FIT_GOLDENS, SCAN_GOLDENS and BOOT_GOLDENS at full width
    (victor_tpu's fit, its 9-point scan and its four refits take minutes
    here)."""
    cfg, jb = full_width
    fit, scan, boot = _chip_smoke_literals('FIT_GOLDENS', 'SCAN_GOLDENS',
                                           'BOOT_GOLDENS')
    jmap, got = golden_fit(jb, cfg)
    sd = np.array(fit['std'])
    assert np.all(np.abs(np.array(got['theta']) - fit['theta']) <= 1e-6 * sd)
    assert abs(got['chi2'] - fit['chi2']) < 1e-8
    np.testing.assert_allclose(got['std'], sd, rtol=1e-8)
    got = golden_scan(jb, cfg, jmap)
    np.testing.assert_allclose(got['grid'], scan['grid'], rtol=1e-8)
    np.testing.assert_allclose(got['chi2'], scan['chi2'], rtol=0, atol=1e-6)
    got = np.array(golden_bootstrap(jb, cfg, jmap))
    assert np.all(np.abs(got - boot) <= 1e-6 * sd)

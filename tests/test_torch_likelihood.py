"""The port's streaming theory and likelihood, its perf modes and its
default batched entry point against victor_tpu and the reference fixtures
(tests/fixtures/reference_boss.npz). The dispersion model's own tests are in
test_torch_dispersion.py.

Both packages get identical tables: the port's bundle is made with
bundle_from_arrays from numpy copies of the JAX bundle's leaves. Parameter
points go to the port as (B,) tensors, and on the CPU every spline lookup
runs the kernel's plain version. Tolerances are those of
tests/test_golden.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from victor_tpu.io import build_tables as jax_build_tables
from victor_tpu.likelihood import core as jlk
from victor_tpu.likelihood.batched import \
    make_batched_loglike as jax_make_batched_loglike
from victor_tpu.models import ccf_theory as jth
from victor_tpu_torch.io.tables import bundle_from_arrays, tables_to_arrays
from victor_tpu_torch.likelihood import core as tlk
from victor_tpu_torch.likelihood.batched import (make_batched_loglike,
                                                 make_loglike, theta_to_params)
from victor_tpu_torch.models import ccf_theory as tth

torch.set_num_threads(1)

NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
GOLDEN = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
DISPLACED = {'fsigma8': 0.55, 'beta': 0.45, 'sigma_v': 320.0, 'epsilon': 1.05}
EXACT = {'streaming_eval': 'exact', 'beta_covariance': 'exact'}


def tp(*points):
    """Points (dicts) -> the port's params: a dict of (B,) tensors."""
    return {k: torch.tensor([p[k] for p in points], dtype=torch.float64)
            for k in points[0]}


def jp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.fixture(scope='module')
def jb(boss_config):
    return jax_build_tables(boss_config['model'], boss_config['data'])


@pytest.fixture(scope='module')
def tb(jb):
    return bundle_from_arrays(tables_to_arrays(jb.tables),
                              dataclasses.asdict(jb.spec),
                              dataclasses.asdict(jb.theory_opts),
                              dataclasses.asdict(jb.fit_opts),
                              device='cpu')


def _lnl(b, params, opts_kw=None, fit_kw=None):
    return tlk.log_likelihood(b.tables, b.spec,
                              b.theory_opts.replace(**(opts_kw or {})),
                              b.fit_opts.replace(**(fit_kw or {})), params)


class TestTheory:
    def test_xi_grid_golden_vs_jax_and_reference(self, jb, tb, ref_fixtures):
        got = tth.theory_xi_grid(tb.tables, tb.spec, tb.theory_opts, tp(GOLDEN))
        assert got.shape == (1, 100, 30)
        want = jth.theory_xi_grid(jb.tables, jb.spec, jb.theory_opts,
                                  jp(GOLDEN))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got[0].numpy(), ref_fixtures['xi_smu'],
                                   rtol=0, atol=1e-12)

    @pytest.mark.parametrize('opts_kw,extra', [
        ({}, {}),
        ({'velocity_independent_of_AP': True}, {'astar': 1.04}),
        ({'empirical_corr': True}, {'Av': 0.5}),
    ])
    def test_xi_grid_batch_vs_jax(self, jb, tb, opts_kw, extra):
        """A batch of two points, one per row, against two JAX calls."""
        points = [{**GOLDEN, **extra}, {**DISPLACED, **extra}]
        got = tth.theory_xi_grid(tb.tables, tb.spec,
                                 tb.theory_opts.replace(**opts_kw), tp(*points))
        for i, p in enumerate(points):
            want = jth.theory_xi_grid(jb.tables, jb.spec,
                                      jb.theory_opts.replace(**opts_kw), jp(p))
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       rtol=0, atol=1e-12)

    def test_stages_vs_reference(self, tb, ref_fixtures):
        vr, dvr = tth.velocity_terms(tb.tables, tb.spec, tb.theory_opts,
                                     tp(GOLDEN))
        np.testing.assert_allclose(vr[0].numpy(), ref_fixtures['vel_vr'],
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(dvr[0].numpy(), ref_fixtures['vel_dvr'],
                                   rtol=0, atol=1e-12)
        real = tth.real_multipoles(tb.tables, tb.spec,
                                   torch.tensor([0.37], dtype=torch.float64))
        np.testing.assert_allclose(real[0].numpy(),
                                   ref_fixtures['real_mult_interp'],
                                   rtol=0, atol=1e-13)

    def test_theory_vector_and_datavector(self, tb, ref_fixtures):
        tv = tth.theory_vector(tb.tables, tb.spec, tb.theory_opts, tp(GOLDEN))
        np.testing.assert_allclose(tv[0].numpy(), ref_fixtures['theory_vector'],
                                   rtol=0, atol=1e-12)
        mult = tth.theory_multipoles_grid(tb.tables, tb.spec, tb.theory_opts,
                                          tp(GOLDEN))
        np.testing.assert_allclose(mult[0, 1].numpy(),
                                   ref_fixtures['theory_mult_2'],
                                   rtol=0, atol=1e-12)
        dv = tlk.multipole_datavector(tb.tables, tb.spec,
                                      torch.tensor([0.37], dtype=torch.float64))
        np.testing.assert_allclose(dv[0].numpy(), ref_fixtures['data_vector'],
                                   rtol=0, atol=1e-13)


class TestCovariance:
    def test_interpolation_vs_reference(self, tb, ref_fixtures):
        beta = torch.tensor([0.37], dtype=torch.float64)
        cov = tlk.interpolated_covariance(tb.tables, tb.spec, beta)
        np.testing.assert_allclose(cov[0].numpy(), ref_fixtures['cov_interp'],
                                   rtol=0, atol=1e-15)
        icov = tlk.interpolated_precision(tb.tables, tb.spec, beta)
        np.testing.assert_allclose(icov[0].numpy(),
                                   ref_fixtures['icov_interp'],
                                   rtol=0, atol=1e-10)

    def test_endpoint_blend_vs_jax(self, jb, tb):
        """The `[0][-1]` blend, the on-grid shortcut and both clamps, on a
        stack of random matrices (cheap: no theory)."""
        rng = np.random.default_rng(0)
        grid = np.asarray(jb.tables.beta_cov)
        stack = rng.standard_normal((len(grid), 6, 6))
        betas = np.concatenate([grid[[0, 7, 30]], [grid[0] - 0.1,
                                                   grid[-1] + 0.1],
                                rng.uniform(grid[0], grid[-1], 8)])
        got = tlk._interp_matrix_stack(torch.tensor(grid), torch.tensor(stack),
                                       torch.tensor(betas)).numpy()
        for i, b in enumerate(betas):
            want = jlk._interp_matrix_stack(jnp.asarray(grid),
                                            jnp.asarray(stack), jnp.asarray(b))
            np.testing.assert_allclose(got[i], np.asarray(want), rtol=0,
                                       atol=1e-15)

    @pytest.mark.parametrize('form', ['gaussian', 'hartlap', 'sellentin',
                                      'percival'])
    def test_forms_vs_jax(self, jb, form):
        fit = jb.fit_opts.replace(form=form)
        chisq = np.array([0.0, 12.5, 65.01, 900.0])
        lf = np.array([280.0, 281.5, 283.0, 284.5])
        got = tlk._apply_form(torch.tensor(chisq), torch.tensor(lf), fit, 60)
        want = jlk._apply_form(jnp.asarray(chisq), jnp.asarray(lf), fit, 60)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)


class TestLikelihood:
    def test_golden_checkpoint(self, tb):
        lnl, chisq = _lnl(tb, tp(GOLDEN))
        assert abs(float(chisq[0]) - 65.01) < 0.01
        assert abs(float(lnl[0]) - 284.76) < 0.01

    @pytest.mark.parametrize('name,fit_kw', [
        ('streaming', {}),
        ('beta_interp_likelihood', {'beta_interpolation': 'likelihood'}),
    ])
    def test_cell22_matrix(self, tb, ref_fixtures, name, fit_kw):
        i = [str(x) for x in ref_fixtures['golden_names']].index(name)
        lnl, chisq = _lnl(tb, tp(GOLDEN), fit_kw=fit_kw)
        assert abs(float(chisq[0]) - ref_fixtures['golden_chi2'][i]) < 1e-8
        assert abs(float(lnl[0]) - ref_fixtures['golden_lnl'][i]) < 1e-8

    @pytest.mark.parametrize('key,opts_kw,fit_kw,extra', [
        ('golden_form_gaussian', {}, {'form': 'gaussian'}, {}),
        ('golden_form_hartlap', {}, {'form': 'hartlap'}, {}),
        ('golden_form_percival', {}, {'form': 'percival'}, {}),
        ('golden_empirical_corr', {'empirical_corr': True}, {}, {'Av': 0.5}),
    ])
    def test_extended_matrix(self, tb, ref_fixtures, key, opts_kw, fit_kw,
                             extra):
        chi2, lnl_want = ref_fixtures[key]
        lnl, chisq = _lnl(tb, tp({**GOLDEN, **extra}), opts_kw, fit_kw)
        assert abs(float(chisq[0]) - chi2) < 1e-8
        assert abs(float(lnl[0]) - lnl_want) < 1e-8

    def test_displaced_point_vs_jax(self, jb, tb):
        lnl, chisq = _lnl(tb, tp(DISPLACED))
        jl, jc = jlk.log_likelihood(jb.tables, jb.spec, jb.theory_opts,
                                    jb.fit_opts, jp(DISPLACED))
        assert abs(float(chisq[0]) - float(jc)) < 1e-9
        assert abs(float(lnl[0]) - float(jl)) < 1e-9

    def test_random_grid_50pts(self, tb, ref_fixtures):
        gp = ref_fixtures['grid_params']
        lnl, chisq = make_batched_loglike(tb, NAMES, opts_kw=EXACT,
                                          chunk=10)(gp)
        np.testing.assert_allclose(chisq.numpy(), ref_fixtures['grid_chi2'],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(lnl.numpy(), ref_fixtures['grid_lnl'],
                                   rtol=0, atol=1e-9)

    def test_batched_chunks_equal_per_point_calls(self, tb, ref_fixtures):
        gp = ref_fixtures['grid_params']
        lnl, chisq = make_batched_loglike(tb, NAMES, opts_kw=EXACT,
                                          chunk=16)(gp)
        assert lnl.shape == chisq.shape == (50,)
        single = make_loglike(tb, NAMES)
        want = np.array([[float(v) for v in single(row)] for row in gp])
        # the same arithmetic at batch 16 and batch 1; only the summation
        # order inside batched matmuls may differ
        np.testing.assert_allclose(lnl.numpy(), want[:, 0], rtol=0, atol=1e-10)
        np.testing.assert_allclose(chisq.numpy(), want[:, 1], rtol=0,
                                   atol=1e-10)

    def test_beta_outside_data_grid_likelihood_mode(self, tb):
        grid = tb.tables.beta_ccf.numpy()
        fit_kw = {'beta_interpolation': 'likelihood'}
        outside = [{**GOLDEN, 'beta': grid[-1] + 0.05},
                   {**GOLDEN, 'beta': grid[0] - 0.05}]
        lnl, chisq = _lnl(tb, tp(*outside), fit_kw=fit_kw)
        assert torch.all(lnl == -torch.inf) and torch.all(chisq == torch.inf)
        edges = [{**GOLDEN, 'beta': grid[0]}, {**GOLDEN, 'beta': grid[-1]},
                 {**GOLDEN, 'beta': grid[0] + 1e-4}]
        lnl_lk, chi_lk = _lnl(tb, tp(*edges), fit_kw=fit_kw)
        lnl_dv, chi_dv = _lnl(tb, tp(*edges))
        assert torch.isfinite(lnl_lk).all()
        np.testing.assert_allclose(lnl_lk[:2].numpy(), lnl_dv[:2].numpy(),
                                   rtol=0, atol=1e-8)

    def test_nan_parameter_gives_sentinel(self, tb):
        """A NaN parameter must reach the NaN guard through every spline
        lookup (the clamp keeps NaN), not turn into a finite chi^2."""
        lnl, chisq = _lnl(tb, tp({**GOLDEN, 'sigma_v': float('nan')},
                                 {**GOLDEN, 'epsilon': float('nan')}, GOLDEN))
        assert torch.all(lnl[:2] == -torch.inf)
        assert torch.all(chisq[:2] == torch.inf)
        assert torch.isfinite(lnl[2])

    def test_theta_to_params_base_values(self):
        theta = torch.tensor([[0.4, 0.3], [0.5, 0.35]], dtype=torch.float64)
        params = theta_to_params(theta, ['fsigma8', 'beta'],
                                 {'sigma_v': 380.0, 'beta': 9.0})
        assert params['sigma_v'].tolist() == [380.0, 380.0]
        assert params['beta'].tolist() == [0.3, 0.35]


def _beta_cases(grid):
    """One beta per interpolation branch: interior blends, an exact grid
    point, both edge grid points and both out-of-grid clamps (as
    tests/test_factored_covariance.py picks them)."""
    return [0.37, float(grid[0]), float(grid[-1]), float(grid[7]),
            float(0.5 * (grid[2] + grid[3])), float(grid[0]) - 0.02,
            float(grid[-1]) + 0.02]


class TestFactoredCovariance:
    @pytest.mark.parametrize('beta_interpolation', ['datavector',
                                                    'likelihood'])
    def test_matches_dense_every_branch(self, tb, beta_interpolation):
        grid = tb.tables.beta_cov.numpy()
        points = [{**GOLDEN, 'beta': b} for b in _beta_cases(grid)]
        fit_kw = {'beta_interpolation': beta_interpolation}
        le, ce = _lnl(tb, tp(*points), {'beta_covariance': 'exact'}, fit_kw)
        lf, cf = _lnl(tb, tp(*points), {'beta_covariance': 'factored'}, fit_kw)
        np.testing.assert_allclose(lf.numpy(), le.numpy(), rtol=1e-12)
        np.testing.assert_allclose(cf.numpy(), ce.numpy(), rtol=1e-12)

    def test_pencil_logdet_matches_dense_slogdet(self, tb):
        grid = tb.tables.beta_cov
        rng = np.random.default_rng(14)
        betas = torch.tensor(_beta_cases(grid.numpy())
                             + list(rng.uniform(float(grid[0]),
                                                float(grid[-1]), 8)),
                             dtype=torch.float64)
        got, ok = tlk._pencil_like_factor(grid, tb.tables.cov_logdet,
                                          tb.tables.cov_pencil, betas)
        want, ok_dense = tlk._like_factor(
            tlk.interpolated_covariance(tb.tables, tb.spec, betas))
        assert ok.all() and ok_dense.all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-11)

    def test_pencil_not_positive_definite_is_not_ok(self):
        """A blend that is not positive definite (some (1-t) + t lam_i <= 0)
        gives ok False off the grid and True at grid points and clamps."""
        grid = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)
        logdets = torch.zeros(3, dtype=torch.float64)
        lam = torch.tensor([[1.0, -5.0], [1.0, 1.0], [1.0, 1.0]],
                           dtype=torch.float64)
        betas = torch.tensor([0.15, 0.1, 0.25, 0.05, 0.35], dtype=torch.float64)
        _, ok = tlk._pencil_like_factor(grid, logdets, lam, betas)
        assert ok.tolist() == [False, True, True, True, True]

    def test_row_interpolation_vs_jax(self, jb):
        """_interp_rows on a (B, n) stack of scalars against victor_tpu's
        _interp_matrix_stack on each row's (n,) stack."""
        rng = np.random.default_rng(15)
        grid = np.asarray(jb.tables.beta_cov)
        betas = np.concatenate([_beta_cases(grid),
                                rng.uniform(grid[0], grid[-1], 5)])
        rows = rng.standard_normal((len(betas), len(grid)))
        got = tlk._interp_rows(torch.tensor(grid), torch.tensor(rows),
                               torch.tensor(betas)).numpy()
        for i, b in enumerate(betas):
            want = jlk._interp_matrix_stack(jnp.asarray(grid),
                                            jnp.asarray(rows[i]),
                                            jnp.asarray(b))
            np.testing.assert_allclose(got[i], float(want), rtol=0, atol=1e-15)


class TestStreamingFast:
    def test_xi_vs_jax_and_bound(self, jb, tb):
        points = [GOLDEN, DISPLACED]
        fast = {'streaming_eval': 'fast'}
        got = tth.theory_xi_grid(tb.tables, tb.spec,
                                 tb.theory_opts.replace(**fast), tp(*points))
        exact = tth.theory_xi_grid(tb.tables, tb.spec, tb.theory_opts,
                                   tp(*points))
        for i, p in enumerate(points):
            want = jth.theory_xi_grid(jb.tables, jb.spec,
                                      jb.theory_opts.replace(**fast), jp(p))
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       rtol=0, atol=1e-12)
        assert float((got - exact).abs().max()) < 3e-5
        lnl_f, chi_f = _lnl(tb, tp(*points), fast)
        lnl_e, chi_e = _lnl(tb, tp(*points))
        assert float((chi_f - chi_e).abs().max()) < 3e-2
        assert float((lnl_f - lnl_e).abs().max()) < 3e-2

    def test_mu_dependent_template_runs_exact_and_warns(self, tb, caplog):
        """Without a rank-1 y_const sigma_v surface the fast mode cannot
        compress it: it logs a warning and runs the exact evaluation."""
        surf = dataclasses.replace(tb.tables.sv_surf, y_const=False)
        tables = dataclasses.replace(tb.tables, sv_surf=surf)
        with caplog.at_level('WARNING', logger='victor_tpu_torch.theory'):
            fast = tth.theory_xi_grid(
                tables, tb.spec, tb.theory_opts.replace(streaming_eval='fast'),
                tp(GOLDEN))
        exact = tth.theory_xi_grid(tables, tb.spec, tb.theory_opts, tp(GOLDEN))
        assert torch.equal(fast, exact)
        assert "streaming_eval='fast' ignored" in caplog.text


@pytest.mark.parametrize('rsd_model', ['streaming', 'dispersion'])
def test_default_batched_loglike_vs_jax_default(jb, tb, ref_fixtures,
                                                rsd_model):
    """The default gradient-free entry point (streaming_eval and
    dispersion_final 'fast', beta_covariance 'factored') over the 50
    reference grid points, against victor_tpu's default."""
    gp = ref_fixtures['grid_params']
    kw = {'rsd_model': rsd_model}
    lnl, chisq = make_batched_loglike(tb, NAMES, opts_kw=kw, chunk=16)(gp)
    jl, jc = jax_make_batched_loglike(jb, NAMES, opts_kw=kw,
                                      chunk=16)(jnp.asarray(gp))
    np.testing.assert_allclose(chisq.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(lnl.numpy(), np.asarray(jl), rtol=0, atol=1e-9)


def test_default_batched_loglike_resolves_the_fast_modes(tb, monkeypatch):
    """gradient_free=True resolves 'auto' to the fast modes and keeps
    explicit values; gradient_free=False keeps the exact ones."""
    seen = []

    def spy(tables, spec, opts, fit, params):
        seen.append(opts)
        return params['beta'], params['beta']

    import victor_tpu_torch.likelihood.batched as tbatched
    monkeypatch.setattr(tbatched, 'log_likelihood', spy)
    theta = [[0.47, 0.37, 380.0, 1.0]]
    make_batched_loglike(tb, NAMES)(theta)
    make_batched_loglike(tb, NAMES, gradient_free=False)(theta)
    make_batched_loglike(tb, NAMES, opts_kw={'streaming_eval': 'exact'})(theta)
    modes = [(o.streaming_eval, o.dispersion_final, o.beta_covariance)
             for o in seen]
    assert modes == [('fast', 'fast', 'factored'), ('exact', 'fast', 'exact'),
                     ('exact', 'fast', 'factored')]


def test_unknown_rsd_model_is_an_input_error(tb):
    from victor_tpu_torch.errors import InputError
    bad = tb.theory_opts.replace(rsd_model='nonsense')
    with pytest.raises(InputError):
        tth.theory_xi_grid(tb.tables, tb.spec, bad, tp(GOLDEN))

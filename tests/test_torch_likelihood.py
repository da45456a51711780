"""The port's streaming theory and likelihood against victor_tpu and the
reference fixtures (tests/fixtures/reference_boss.npz).

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
                              dataclasses.asdict(jb.fit_opts))


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


@pytest.mark.parametrize('opts_kw,item', [
    ({'rsd_model': 'dispersion'}, 'Queue 1 item 6'),
    ({'rsd_model': 'kaiser'}, 'Queue 1 item 6'),
    ({'rsd_model': 'euclid_special'}, 'Queue 1 item 6'),
    ({'assume_isotropic': False}, 'Queue 1 item 6'),
    ({'realspace_ccf_from_data': True}, 'Queue 1 item 6'),
    ({'mean_model': 'template'}, 'Queue 1 item 6'),
    ({'matter_model': 'linear_bias'}, 'Queue 1 item 6'),
    ({'matter_model': 'excursion_set'}, 'Queue 1 item 7'),
    ({'streaming_eval': 'fast'}, 'Queue 1 item 5'),
    ({'beta_covariance': 'factored'}, 'Queue 1 item 5'),
    ({'dispersion_final': 'fused'}, 'Queue 2 item 2'),
])
def test_unported_options_raise(tb, opts_kw, item):
    with pytest.raises(NotImplementedError, match=item):
        _lnl(tb, tp(GOLDEN), opts_kw=opts_kw)


def test_default_batched_loglike_raises_until_fast_modes_land(tb):
    """gradient_free=True resolves 'auto' to streaming_eval='fast' and
    beta_covariance='factored', which the port does not have yet."""
    with pytest.raises(NotImplementedError, match='Queue 1 item 5'):
        make_batched_loglike(tb, NAMES)
    make_batched_loglike(tb, NAMES, gradient_free=False)


def test_unknown_rsd_model_is_an_input_error(tb):
    from victor_tpu_torch.errors import InputError
    bad = tb.theory_opts.replace(rsd_model='nonsense')
    with pytest.raises(InputError):
        tth.theory_xi_grid(tb.tables, tb.spec, bad, tp(GOLDEN))

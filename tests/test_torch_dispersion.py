"""The port's dispersion RSD model and its fused final stage against
victor_tpu and the reference fixtures (tests/fixtures/reference_boss.npz).

Both packages get identical tables (bundle_from_arrays of the JAX bundle's
leaves) and identical parameter points, in f64. On the CPU the fused final
stage runs its plain PyTorch version, which is held here against the Pallas
kernel `dispersion_final_fused` in interpret mode; the CUDA kernel's own
tests are in test_torch_kernels.py. Every port-vs-JAX comparison runs the
same algorithm on both sides, so only rounding differs: atol 1e-12 on xi.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from victor_tpu.io import build_tables as jax_build_tables
from victor_tpu.likelihood import core as jlk
from victor_tpu.models import ccf_theory as jth
from victor_tpu.ops.dispersion_pallas import dispersion_final_fused
from victor_tpu_torch.io.tables import bundle_from_arrays, tables_to_arrays
from victor_tpu_torch.kernels.dispersion import dispersion_final_plain
from victor_tpu_torch.likelihood import core as tlk
from victor_tpu_torch.models import ccf_theory as tth

from test_torch_kernels import _dispersion_inputs

torch.set_num_threads(1)

GOLDEN = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
DISPLACED = {'fsigma8': 0.55, 'beta': 0.45, 'sigma_v': 320.0, 'epsilon': 1.05}
DISP = {'rsd_model': 'dispersion'}
EXACT_INTERIOR = {**DISP, 'dispersion_interior': 'exact'}
ATOL = 1e-12


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


def _xi_vs_jax(jb, tb, opts_kw, points, jax_opts_kw=None):
    """The port's xi(s, mu) for a batch of points against one JAX call per
    point."""
    got = tth.theory_xi_grid(tb.tables, tb.spec,
                             tb.theory_opts.replace(**opts_kw), tp(*points))
    jopts = jb.theory_opts.replace(**(jax_opts_kw or opts_kw))
    for i, p in enumerate(points):
        want = jth.theory_xi_grid(jb.tables, jb.spec, jopts, jp(p))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    return got


@pytest.fixture(scope='module')
def final_stage_inputs():
    """Three rows at n = 31, n_v = 8, q = 256 (Pallas needs (8k, 128m))."""
    return _dispersion_inputs(np.random.default_rng(21), 3, 8, 256)


@pytest.mark.parametrize('row', [0, 1, 2])
def test_final_stage_plain_matches_pallas_interpret(final_stage_inputs, row):
    """dispersion_final_plain on the batch, row by row against the Pallas
    kernel (interpret mode) on that row."""
    x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel = final_stage_inputs
    got = dispersion_final_plain(*(torch.as_tensor(a) for a in
                                   final_stage_inputs))
    want = dispersion_final_fused(
        jnp.asarray(x), jnp.asarray(c_vr[row]), jnp.asarray(c_dvr[row]),
        jnp.asarray(r_par[row]), jnp.asarray(A[row]),
        jnp.asarray(s_perp[row]), float(iaH[row]), float(resc_vel[row]),
        interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isnan(w).sum() > 0
        np.testing.assert_allclose(g[row].numpy(), w, rtol=0, atol=ATOL,
                                   equal_nan=True)


class TestTheory:
    def test_exact_interior_vs_reference_and_jax(self, jb, tb, ref_fixtures):
        got = _xi_vs_jax(jb, tb, EXACT_INTERIOR, [GOLDEN])
        np.testing.assert_allclose(got[0].numpy(),
                                   ref_fixtures['xi_smu_dispersion'], rtol=0,
                                   atol=ATOL)

    @pytest.mark.parametrize('opts_kw', [
        {},                                       # Chebyshev interior
        {'dispersion_final': 'fast'},
        {'dispersion_final': 'exact', 'niter': 3},
        {'niter': 0},
        {'niter': 1},
        {'niter': 0, 'dispersion_interior': 'exact'},
        {'niter': 1, 'dispersion_interior': 'exact'},
        {'niter': 1, 'dispersion_final': 'fast'},
    ])
    def test_modes_vs_jax(self, jb, tb, opts_kw):
        _xi_vs_jax(jb, tb, {**DISP, **opts_kw}, [GOLDEN, DISPLACED])

    @pytest.mark.parametrize('interior', ['chebyshev', 'exact'])
    def test_fused_final_vs_jax_exact_final(self, jb, tb, interior):
        """'fused' is the exact final stage in one kernel; on the CPU its
        plain version. victor_tpu holds its own fused kernel to its exact
        path at 1e-12 (tests/test_golden.py); here the port's fused path
        meets victor_tpu's exact one at the same tolerance."""
        opts_kw = {**DISP, 'dispersion_interior': interior}
        _xi_vs_jax(jb, tb, {**opts_kw, 'dispersion_final': 'fused'},
                   [GOLDEN, DISPLACED],
                   jax_opts_kw={**opts_kw, 'dispersion_final': 'exact'})

    def test_chebyshev_interior_within_bound_of_exact(self, tb):
        p = tp(GOLDEN, DISPLACED)
        xi_c = tth.theory_xi_grid(tb.tables, tb.spec,
                                  tb.theory_opts.replace(**DISP), p)
        xi_e = tth.theory_xi_grid(tb.tables, tb.spec,
                                  tb.theory_opts.replace(**EXACT_INTERIOR), p)
        assert float((xi_c - xi_e).abs().max()) < 2e-5

    @pytest.mark.parametrize('ap_kw,extra', [
        ({'velocity_independent_of_AP': True}, {'astar': 1.04}),
        ({'velocity_independent_of_AP': False}, {}),
    ])
    def test_batch_in_both_ap_modes(self, jb, tb, ap_kw, extra):
        _xi_vs_jax(jb, tb, {**DISP, **ap_kw, 'dispersion_final': 'fused'},
                   [{**GOLDEN, **extra}, {**DISPLACED, **extra}],
                   jax_opts_kw={**DISP, **ap_kw, 'dispersion_final': 'exact'})


class TestLikelihood:
    @pytest.mark.parametrize('final', ['exact', 'fused'])
    def test_cell22_dispersion(self, tb, ref_fixtures, final):
        i = [str(x) for x in ref_fixtures['golden_names']].index('dispersion')
        opts = tb.theory_opts.replace(**EXACT_INTERIOR, dispersion_final=final)
        lnl, chisq = tlk.log_likelihood(tb.tables, tb.spec, opts, tb.fit_opts,
                                        tp(GOLDEN))
        assert abs(float(chisq[0]) - ref_fixtures['golden_chi2'][i]) < 1e-8
        assert abs(float(lnl[0]) - ref_fixtures['golden_lnl'][i]) < 1e-8

    def test_default_modes_vs_jax(self, jb, tb):
        """Chebyshev interior, fast final stage and the factored covariance
        (what the gradient-free path resolves to) at a displaced point."""
        kw = {**DISP, 'dispersion_final': 'fast', 'beta_covariance': 'factored'}
        lnl, chisq = tlk.log_likelihood(tb.tables, tb.spec,
                                        tb.theory_opts.replace(**kw),
                                        tb.fit_opts, tp(DISPLACED))
        jl, jc = jlk.log_likelihood(jb.tables, jb.spec,
                                    jb.theory_opts.replace(**kw), jb.fit_opts,
                                    jp(DISPLACED))
        assert abs(float(chisq[0]) - float(jc)) < 1e-9
        assert abs(float(lnl[0]) - float(jl)) < 1e-9

    @pytest.mark.parametrize('final', ['exact', 'fast', 'fused'])
    def test_nan_parameter_gives_sentinel(self, tb, final):
        opts = tb.theory_opts.replace(**DISP, dispersion_final=final)
        lnl, chisq = tlk.log_likelihood(
            tb.tables, tb.spec, opts, tb.fit_opts,
            tp({**GOLDEN, 'sigma_v': float('nan')},
               {**GOLDEN, 'epsilon': float('nan')}, GOLDEN))
        assert torch.all(lnl[:2] == -torch.inf)
        assert torch.all(chisq[:2] == torch.inf)
        assert torch.isfinite(lnl[2])

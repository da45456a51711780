"""The port's gradient-free samplers against victor_tpu: the MH step and the
staged warmup, the ensemble half-updates, the runners, checkpoints, chain
files and diagnostics.

victor_tpu draws its noise by splitting threefry keys inside each step; the
port draws from a torch.Generator. The step functions of the port take their
noise as arguments, so the parity tests replay victor_tpu's key splits and
feed the same draws to the port; everything is float64 on the CPU.
"""

import dataclasses
import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victor_tpu.sampling import chains as jchains
from victor_tpu.sampling import diagnostics as jdiag
from victor_tpu.sampling import ensemble as jens
from victor_tpu.sampling import mh as jmh
from victor_tpu.sampling import priors as jpriors
from victor_tpu.sampling import targets as jtargets
from victor_tpu_torch.errors import InputError
from victor_tpu_torch.sampling import chains as tchains
from victor_tpu_torch.sampling import diagnostics as tdiag
from victor_tpu_torch.sampling import ensemble as tens
from victor_tpu_torch.sampling import hmc as thmc
from victor_tpu_torch.sampling import mh as tmh
from victor_tpu_torch.sampling import priors as tpriors
from victor_tpu_torch.sampling import runner as trunner
from victor_tpu_torch.sampling import targets as ttargets

torch.set_num_threads(1)

MEAN4 = np.array([0.5, -1.0, 2.0, 0.0])
COV4 = np.array([[1.0, 0.6, 0.2, 0.0],
                 [0.6, 2.0, -0.3, 0.1],
                 [0.2, -0.3, 0.5, 0.05],
                 [0.0, 0.1, 0.05, 1.5]])
STATE_FIELDS = ('q', 'lnp', 'aux', 'log_eps', 'log_eps_avg', 'h_bar',
                'welford_mean', 'welford_m2', 'welford_n', 'chol_cov',
                'n_accepted')


def gaussian_pair(mean, cov):
    """The same Gaussian log density as victor_tpu's scalar per-chain
    function and the port's batched one."""
    ci = np.linalg.inv(cov)

    def jfn(y):
        d = y - jnp.asarray(mean)
        return -0.5 * d @ jnp.asarray(ci) @ d, jnp.zeros((1,))

    def tfn(y):
        d = y - torch.as_tensor(mean)
        lnp = -0.5 * torch.einsum('ci,ij,cj->c', d, torch.as_tensor(ci), d)
        return lnp, torch.zeros(y.shape[0], 1, dtype=y.dtype)

    return jfn, tfn


def replay_mh_noise(keys, n_steps, ndim):
    """victor_tpu's per-step draws of each chain (mh.py:52-62): xi
    (n_steps, C, ndim) and u (n_steps, C)."""
    def one(k):
        def body(k, _):
            k, k_prop, k_acc = jax.random.split(k, 3)
            return k, (jax.random.normal(k_prop, (ndim,)),
                       jax.random.uniform(k_acc, ()))
        return jax.lax.scan(body, k, None, length=n_steps)[1]
    xi, u = jax.vmap(one)(keys)
    return (torch.as_tensor(np.asarray(xi)).transpose(0, 1),
            torch.as_tensor(np.asarray(u)).T)


def run_port_with_noise(value_fn, states, noise, i0, length, n_warmup):
    """The port's staged segment with injected noise (xi, u) per step."""
    xi, u = noise

    def step_fn(st, adapt, mu):
        k = step_fn.i
        step_fn.i += 1
        return tmh._mh_step(value_fn, st, xi[k], u[k], adapt, mu_offset=mu)
    step_fn.i = i0
    return thmc.staged_segment(step_fn, states, i0, length, n_warmup,
                               tmh._default_eps0(states.q.shape[1]))


def accepted(ys):
    """(C, n) whether each step moved the chain."""
    return np.any(np.diff(ys, axis=1) != 0, axis=-1)


def assert_states_close(jst, tst, tol):
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)),
                                   rtol=tol, atol=tol, err_msg=f)


def port_state(jst):
    """victor_tpu's HMCState as the port's (its key has no counterpart)."""
    return thmc.HMCState(generator=torch.Generator(), grad=torch.as_tensor(
        np.asarray(jst.grad)), **{f: torch.as_tensor(np.array(getattr(jst, f)))
                                  for f in STATE_FIELDS})


class TestMHStep:
    @pytest.mark.parametrize('n_warmup', [0, 2, 150])
    def test_staged_warmup_matches_victor_tpu(self, n_warmup):
        """Four chains on a correlated 4-D Gaussian, 300 steps, victor_tpu's
        own draws.

        Step by step: the port's step (with the warmup resets and the freeze
        firing on the same indices) takes victor_tpu's state before each
        step to victor_tpu's state after it, every field at 1e-12.

        Free-running: the two runs take the same accept/reject decisions at
        every step and end within 1e-9. Not closer: XLA's f64 exp, log and
        sqrt differ from glibc's in the last bit for 0.5-15% of inputs, and
        the dual averaging (log eps = mu - sqrt(n)/0.05 * h_bar) amplifies
        those one-ulp differences to ~1e-10 over a 150-step warmup."""
        jfn, tfn = gaussian_pair(MEAN4, COV4)
        key = jax.random.PRNGKey(11)
        y0 = np.asarray(MEAN4 + 2.0 * jax.random.normal(key, (4, 4)))
        keys = jax.random.split(jax.random.PRNGKey(5), 4)
        n = 300
        noise = replay_mh_noise(keys, n, 4)
        jstep = jax.jit(lambda st, i: jmh.run_segment(jfn, st, i, 1,
                                                      n_warmup=n_warmup))
        jstates = [jmh.init_chains(jfn, jnp.asarray(y0), keys)]
        for i in range(n):
            jstates.append(jstep(jstates[-1], jnp.asarray(i, jnp.int32))[0])
        for i in range(n):
            tst, _ = run_port_with_noise(tfn, port_state(jstates[i]), noise,
                                         i, 1, n_warmup)
            assert_states_close(jstates[i + 1], tst, 1e-12)

        jst, (jys, jlnp, _) = jax.jit(lambda st: jmh.run_segment(
            jfn, st, jnp.zeros((), jnp.int32), n, n_warmup=n_warmup))(
                jstates[0])
        tst = tmh.init_chains(tfn, torch.as_tensor(y0), torch.Generator())
        assert_states_close(jstates[0], tst, 0.0)
        tst, (tys, tlnp, _) = run_port_with_noise(tfn, tst, noise, 0, n,
                                                  n_warmup)
        acc_t, acc_j = accepted(tys.numpy()), accepted(np.asarray(jys))
        np.testing.assert_array_equal(acc_t, acc_j)
        assert 0 < acc_t.mean() < 1
        assert_states_close(jst, tst, 1e-9)
        np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_array_equal(tst.grad.numpy(), 0.0)

    def test_boss_posterior_steps_match_victor_tpu(self, boss_config):
        """Six MH steps of two chains on the BOSS posterior in the default
        (gradient-free, fast) modes: the log posterior over the unbounded
        space agrees to 1e-9 along the same trajectory."""
        from victor_tpu.io import build_tables
        from victor_tpu_torch.io.tables import (bundle_from_arrays,
                                                tables_to_arrays)
        jb = build_tables(boss_config['model'], boss_config['data'])
        tb = bundle_from_arrays(tables_to_arrays(jb.tables),
                                dataclasses.asdict(jb.spec),
                                dataclasses.asdict(jb.theory_opts),
                                dataclasses.asdict(jb.fit_opts), device='cpu')
        block = {
            'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                        'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05}},
            'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
                     'ref': {'dist': 'norm', 'loc': 0.4, 'scale': 0.05}},
            'sigma_v': {'prior': {'dist': 'uniform', 'min': 100, 'max': 500},
                        'ref': {'dist': 'norm', 'loc': 380, 'scale': 20},
                        'proposal': 10.0},
            'epsilon': 1.0,
        }
        jspace, tspace = jpriors.ParamSpace(block), tpriors.ParamSpace(block)
        tbl, jloglike, _ = jtargets.resolve_target(jb, None, None,
                                                   gradient_free=True)

        def jlogpost_y(y):          # victor_tpu/sampling/runner.py:213-220
            theta = jspace.to_bounded(y)
            lnl, chisq = jloglike(tbl, jspace.full_params(theta))
            lp = jspace.log_prior(theta) + jspace.log_jacobian(y)
            total = lnl + lp
            return (jnp.where(jnp.isfinite(total), total, -jnp.inf),
                    jnp.stack([chisq]))

        _, tloglike = ttargets.resolve_target(tb, None, None,
                                              gradient_free=True)
        tlogpost_y = trunner.unbounded_logpost(tspace, tloglike, tb.tables)
        theta0 = np.array([[0.47, 0.38, 380.0], [0.52, 0.36, 420.0]])
        y0 = np.asarray(jspace.to_unbounded(jnp.asarray(theta0)))
        keys = jax.random.split(jax.random.PRNGKey(2), 2)
        chol0 = np.asarray(jax.vmap(jnp.diag)(
            jspace.proposal_scales_unbounded(jnp.asarray(y0))))
        jst = jmh.init_chains(jlogpost_y, jnp.asarray(y0), keys,
                              chol0=jnp.asarray(chol0))
        jst, (jys, jlnp, jaux) = jax.jit(lambda st: jmh.run_segment(
            jlogpost_y, st, jnp.zeros((), jnp.int32), 6, n_warmup=3))(jst)
        tst = tmh.init_chains(tlogpost_y, torch.as_tensor(y0),
                              torch.Generator(),
                              chol0=trunner.initial_proposal_cholesky(
                                  tspace, torch.as_tensor(y0)))
        tst, (tys, tlnp, taux) = run_port_with_noise(
            tlogpost_y, tst, replay_mh_noise(keys, 6, 3), 0, 6, 3)
        np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-9)
        np.testing.assert_allclose(tlnp.numpy(), np.asarray(jlnp), rtol=1e-9)
        np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-9)
        np.testing.assert_array_equal(accepted(tys.numpy()),
                                      accepted(np.asarray(jys)))
        assert np.isfinite(tlnp.numpy()).all()

    def test_segments_bitexact_vs_monolithic(self):
        """The generator is drawn once per step, so a run split into
        segments equals one uninterrupted run bit for bit."""
        _, tfn = gaussian_pair(MEAN4, COV4)
        y0 = torch.as_tensor(MEAN4 + np.random.default_rng(1).normal(
            size=(4, 4)))

        def fresh():
            gen = torch.Generator()
            gen.manual_seed(8)
            return tmh.init_chains(tfn, y0, gen)
        _, (ys_mono, lnp_mono, _) = tmh.run_segment(tfn, fresh(), 0, 35, 20)
        st, recs, i0 = fresh(), [], 0
        while i0 < 35:
            length = min(7, 35 - i0)
            st, (qs, lnps, _) = tmh.run_segment(tfn, st, i0, length, 20)
            recs.append((qs, lnps))
            i0 += length
        assert torch.equal(torch.cat([r[0] for r in recs], 1), ys_mono)
        assert torch.equal(torch.cat([r[1] for r in recs], 1), lnp_mono)

    def test_mh_recovers_correlated_gaussian(self):
        """The port's own draws: the staged dense-proposal adaptation
        recovers a rho=0.6 Gaussian near the 0.234 acceptance optimum
        (tests/test_sampling.py::test_mh_recovers_correlated_gaussian)."""
        mean = np.array([1.0, -2.0])
        cov = np.array([[1.0, 0.6 * np.sqrt(2.0)], [0.6 * np.sqrt(2.0), 2.0]])
        _, tfn = gaussian_pair(mean, cov)
        gen = torch.Generator()
        gen.manual_seed(7)
        y0 = torch.as_tensor(mean) + torch.randn(8, 2, generator=gen,
                                                 dtype=torch.float64)
        n_warmup, n_samples = 1000, 3000
        st = tmh.init_chains(tfn, y0, gen)
        st, (ys, lnps, _) = tmh.run_segment(tfn, st, 0, n_warmup + n_samples,
                                            n_warmup)
        chain = ys.numpy()[:, n_warmup:].transpose(1, 0, 2)
        assert np.all(np.isfinite(lnps.numpy()))
        acc = st.n_accepted.numpy() / n_samples
        assert np.all(acc > 0.1) and np.all(acc < 0.45), acc
        assert np.all(tdiag.split_rhat(chain) < 1.05)
        flat = chain.reshape(-1, 2)
        np.testing.assert_allclose(flat.mean(axis=0), mean, atol=0.15)
        np.testing.assert_allclose(np.cov(flat.T), cov, rtol=0.25, atol=0.2)
        assert np.all(tdiag.effective_sample_size(chain) > 500)


class TestAdaptation:
    def test_resets_keep_old_factor_on_failure(self):
        """_dense_reset of a non-finite Welford accumulator: victor_tpu's
        jnp.linalg.cholesky gives NaN and _reset_adaptation keeps the old
        factor; the port's cholesky_ex path must do the same, per chain."""
        jfn, tfn = gaussian_pair(MEAN4, COV4)
        y0 = MEAN4 + np.random.default_rng(3).normal(size=(2, 4))
        keys = jax.random.split(jax.random.PRNGKey(0), 2)
        jst = jmh.init_chains(jfn, jnp.asarray(y0), keys)
        tst = tmh.init_chains(tfn, torch.as_tensor(y0), torch.Generator())
        m2 = np.stack([np.diag([1.0, 2.0, 3.0, 4.0]) + 0.1,
                       np.diag([1.0, -5.0, 1.0, 1.0])])    # chain 1 not PD
        chol_old = np.stack([np.eye(4) * 0.5, np.eye(4) * 0.25])
        jst = jst._replace(welford_m2=jnp.asarray(m2),
                           welford_n=jnp.asarray([3.0, 3.0]),
                           chol_cov=jnp.asarray(chol_old))
        tst = tst._replace(welford_m2=torch.as_tensor(m2),
                           welford_n=torch.tensor([3.0, 3.0],
                                                  dtype=torch.float64),
                           chol_cov=torch.as_tensor(chol_old))
        from victor_tpu.sampling import hmc as jhmc
        jd = jax.vmap(jhmc._dense_reset)(jst)
        td = thmc._dense_reset(tst)
        np.testing.assert_allclose(td.chol_cov.numpy(),
                                   np.asarray(jd.chol_cov), rtol=1e-14,
                                   atol=1e-15)
        np.testing.assert_array_equal(td.chol_cov.numpy()[1], chol_old[1])
        jg = jax.vmap(jhmc._diag_reset)(jst)
        tg = thmc._diag_reset(tst)
        np.testing.assert_allclose(tg.chol_cov.numpy(),
                                   np.asarray(jg.chol_cov), rtol=1e-14)

    def test_initial_proposal_matches_victor_tpu_chol0(self):
        """The covmat and proposal-width seeds of run_hmc_mcmc
        (victor_tpu/sampling/runner.py:275-287) at fixed start points,
        including a covmat that is not positive definite at y (NaN in
        both)."""
        block = {
            'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 2.0},
                  'proposal': 0.05},
            'b': {'prior': {'dist': 'loguniform', 'min': 0.1, 'max': 10.0}},
            'c': {'prior': {'dist': 'halfnorm', 'loc': 0.0, 'scale': 2.0},
                  'proposal': 0.3},
        }
        js, ts = jpriors.ParamSpace(block), tpriors.ParamSpace(block)
        y = np.random.default_rng(6).normal(size=(5, 3))
        cov = np.array([[0.01, 0.002, 0.0], [0.002, 0.5, 0.01],
                        [0.0, 0.01, 0.2]])
        for covmat in (cov, np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0],
                                      [0.0, 0.0, 1.0]])):
            def one(yy):
                j = js.dtheta_dy_diag(yy)
                return jnp.linalg.cholesky(jnp.asarray(covmat)
                                           / jnp.outer(j, j))
            want = np.asarray(jax.vmap(one)(jnp.asarray(y)))
            got = trunner.initial_proposal_cholesky(
                ts, torch.as_tensor(y), covmat).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       equal_nan=True)
        want = np.asarray(jax.vmap(jnp.diag)(js.proposal_scales_unbounded(
            jnp.asarray(y))))
        got = trunner.initial_proposal_cholesky(ts, torch.as_tensor(y))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)
        assert trunner.initial_proposal_cholesky(
            tpriors.ParamSpace({'a': block['b']}),
            torch.as_tensor(y[:, :1])) is None


class TestTargets:
    BLOCK = {
        'a': {'prior': {'dist': 'uniform', 'min': -2.0, 'max': 3.0}},
        'b': {'prior': {'dist': 'halfnorm', 'loc': 0.1, 'scale': 2.0}},
        'c': 0.5,
        'd': {'value': 'lambda a, c: a * c'},
    }

    @staticmethod
    def loglikes():
        """The same likelihood for victor_tpu (scalar params) and the port
        (params of (B,) tensors); b = 0.1 + 1e-300 gives a non-finite lnL."""
        def jfn(p):
            chi2 = (p['a'] - p['d']) ** 2 + jnp.log(p['b'] - 0.1) ** 2
            return -0.5 * chi2, chi2

        def tfn(p):
            chi2 = (p['a'] - p['d']) ** 2 + torch.log(p['b'] - 0.1) ** 2
            return -0.5 * chi2, chi2
        return jfn, tfn

    @pytest.mark.parametrize('kind', ['callable', 'product'])
    def test_resolve_target_matches_victor_tpu(self, kind):
        """lnL and chi2 of a callable target and of a ProductTarget of two
        members (the sum of the members' values), through the full
        parameters of the block (derived lambda included), at seeded points
        and at b's support edge (non-finite lnL in both)."""
        jfn, tfn = self.loglikes()
        if kind == 'product':
            jfn = jtargets.ProductTarget((jfn, jfn))
            tfn = ttargets.ProductTarget((tfn, tfn))
        js, ts = jpriors.ParamSpace(self.BLOCK), tpriors.ParamSpace(self.BLOCK)
        jtbl, jll, _ = jtargets.resolve_target(jfn, None, None)
        ttbl, tll = ttargets.resolve_target(tfn, None, None)
        theta = np.random.default_rng(14).uniform([-2.0, 0.1], [3.0, 4.0],
                                                  size=(10, 2))
        theta[0, 1] = 0.1                        # b at its support edge
        want = jax.vmap(lambda t: jll(jtbl, js.full_params(t)))(
            jnp.asarray(theta))
        got = tll(ttbl, ts.full_params(torch.as_tensor(theta)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14)
        assert not np.isfinite(got[0].numpy()[0])

    def test_resolve_perf_kw_matches_victor_tpu(self):
        from victor_tpu.config import TheoryOptions as JOpts
        from victor_tpu_torch.config import TheoryOptions as TOpts
        cases = [({}, None), ({'streaming_eval': 'exact'}, None),
                 ({}, {'beta_covariance': 'exact'})]
        for fields, kw in cases:
            for gradient_free in (True, False):
                assert ttargets.resolve_perf_kw(
                    [TOpts(**fields), TOpts()], kw, gradient_free) == \
                    jtargets.resolve_perf_kw([JOpts(**fields), JOpts()], kw,
                                             gradient_free)


def replay_half_noise(key, move, n, m):
    """victor_tpu's draws inside one half-update (ensemble.py:55-95)."""
    if move == 'stretch':
        k_z, k_pair, k_acc = jax.random.split(key, 3)
        draws = (jax.random.uniform(k_z, (n,)),
                 jax.random.randint(k_pair, (n,), 0, m),
                 jax.random.uniform(k_acc, (n,)))
    else:
        k_r1, k_r2, k_g, k_jump, k_acc = jax.random.split(key, 5)
        draws = (jax.random.randint(k_r1, (n,), 0, m),
                 jax.random.randint(k_r2, (n,), 1, m),
                 jax.random.normal(k_g, (n,)),
                 jax.random.uniform(k_jump, (n,)),
                 jax.random.uniform(k_acc, (n,)))
    return [torch.as_tensor(np.asarray(d)) for d in draws]


def batched_gaussian_pair(mean, cov):
    ci = np.linalg.inv(cov)

    def jfn(x):
        d = x - jnp.asarray(mean)
        lnp = -0.5 * jnp.einsum('wi,ij,wj->w', d, jnp.asarray(ci), d)
        return lnp, jnp.stack([-2.0 * lnp], axis=-1)

    def tfn(x):
        d = x - torch.as_tensor(mean)
        lnp = -0.5 * torch.einsum('wi,ij,wj->w', d, torch.as_tensor(ci), d)
        return lnp, (-2.0 * lnp)[:, None]

    return jfn, tfn


class TestEnsemble:
    @pytest.mark.parametrize('move', ['stretch', 'de'])
    def test_half_update_matches_victor_tpu(self, move):
        jfn, tfn = batched_gaussian_pair(MEAN4, COV4)
        rng = np.random.default_rng(9)
        active = MEAN4 + rng.normal(size=(16, 4))
        other = MEAN4 + rng.normal(size=(16, 4))
        lnp, aux = (np.asarray(v) for v in jfn(jnp.asarray(active)))
        key = jax.random.PRNGKey(21)
        jargs = (jfn, key, jnp.asarray(active), jnp.asarray(other),
                 jnp.asarray(lnp), jnp.asarray(aux))
        targs = (tfn, torch.as_tensor(active), torch.as_tensor(other),
                 torch.as_tensor(lnp), torch.as_tensor(aux))
        noise = replay_half_noise(key, move, 16, 16)
        if move == 'stretch':
            want = jens._half_update(*jargs, 2.0)
            got = tens._half_update(*targs, 2.0, *noise)
        else:
            want = jens._de_half_update(*jargs)
            got = tens._de_half_update(*targs, *noise)
        for w, g in zip(want[:3], got[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14,
                                       atol=1e-14)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert 0 < got[3].float().mean() < 1

    def test_de_needs_four_walkers(self):
        _, tfn = batched_gaussian_pair(MEAN4[:2], COV4[:2, :2])
        gen = torch.Generator()
        for n_walkers, ok in ((3, False), (4, True)):
            st = tens.init_state(tfn, torch.zeros(n_walkers, 2,
                                                  dtype=torch.float64), gen)
            if ok:
                assert tens.step(tfn, st, move='de').n_steps == 1
            else:
                with pytest.raises(InputError, match='at least 4 walkers'):
                    tens.step(tfn, st, move='de')
        with pytest.raises(ValueError, match="'de' or 'stretch'"):
            tens.step(tfn, st, move='walk')

    def test_de_recovers_correlated_gaussian(self):
        """tests/test_sampling.py::test_de_move_samples_correct_gaussian on
        the port's own draws."""
        rho = 0.8
        _, tfn = batched_gaussian_pair(np.zeros(2),
                                       np.array([[1.0, rho], [rho, 1.0]]))
        gen = torch.Generator()
        gen.manual_seed(0)
        coords = 0.5 * torch.randn(64, 2, generator=gen, dtype=torch.float64)
        state = tens.init_state(tfn, coords, gen)
        state, (xs, _, _) = tens.run(tfn, state, 800, move='de')
        draws = xs[300:].reshape(-1, 2).numpy()
        assert np.abs(draws.mean(axis=0)).max() < 0.1
        np.testing.assert_allclose(np.corrcoef(draws.T)[0, 1], rho, atol=0.05)
        np.testing.assert_allclose(draws.std(axis=0), 1.0, atol=0.1)
        acc = tdiag.acceptance_fraction(state.n_accepted.numpy(),
                                        state.n_steps)
        assert 0.1 < acc < 0.9

    def test_thin_records_every_kth_state(self):
        _, tfn = batched_gaussian_pair(np.zeros(2), np.eye(2))

        def fresh():
            gen = torch.Generator()
            gen.manual_seed(7)
            return tens.init_state(tfn, torch.randn(
                16, 2, generator=gen, dtype=torch.float64), gen)
        _, (c1, _, _) = tens.run(tfn, fresh(), 20)
        _, (c2, _, _) = tens.run(tfn, fresh(), 20, thin=2)
        assert c2.shape[0] == 10
        assert torch.equal(c2, c1[1::2])
        with pytest.raises(ValueError):
            tens.run(tfn, fresh(), 5, thin=2)


GAUSS_BLOCK = {
    'a': {'prior': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0},
          'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.5}},
    'b': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0},
          'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.5},
          'proposal': 0.5},
    'c': 2.0,
    'ab': {'value': 'lambda a, b: np.sqrt(a**2 + b**2)'},
}


def gauss_loglike(params):
    chi2 = (params['a'] - 0.3) ** 2 + (params['b'] + 0.2) ** 2 / 0.5
    return -0.5 * chi2, chi2


class TestRunners:
    def test_mh_checkpoint_resume_bitexact(self, tmp_path):
        """A resumed MH run (generator state restored from the checkpoint)
        extends the first run's chain exactly as one uninterrupted run."""
        kw = dict(n_chains=4, n_warmup=4, seed=3, algorithm='mh',
                  segment_steps=4, device='cpu')
        full = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK,
                                    n_samples=8, **kw)
        ckpt = str(tmp_path / 'mh.npz')
        r1 = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, n_samples=4,
                                  checkpoint=ckpt, **kw)
        r2 = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, n_samples=4,
                                  checkpoint=ckpt, resume=True,
                                  **{**kw, 'seed': 99})
        np.testing.assert_array_equal(r1.chain, full.chain[:4])
        np.testing.assert_array_equal(r2.chain, full.chain)
        np.testing.assert_array_equal(r2.log_prob, full.log_prob)
        assert r2.chain.shape == (8, 4, 2)

    def test_ensemble_checkpoint_resume_bitexact(self, tmp_path):
        kw = dict(n_walkers=8, check_every=2, rhat_stop=0.0, seed=1,
                  burn_in_fraction=0.0, device='cpu')
        full = trunner.run_mcmc(gauss_loglike, GAUSS_BLOCK, max_steps=8, **kw)
        ckpt = str(tmp_path / 'ens.npz')
        trunner.run_mcmc(gauss_loglike, GAUSS_BLOCK, max_steps=4,
                         checkpoint=ckpt, **kw)
        r2 = trunner.run_mcmc(gauss_loglike, GAUSS_BLOCK, max_steps=8,
                              checkpoint=ckpt, resume=True, **kw)
        np.testing.assert_array_equal(r2.chain, full.chain)
        np.testing.assert_array_equal(r2.aux, full.aux)
        assert r2.n_steps == full.n_steps == 8

    def test_rhat_stop_truncates_bitexactly(self):
        """rhat_stop stops after a segment once split-R-1 clears it; the
        draws are the prefix of the fixed-length run's."""
        res = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, n_chains=8,
                                   n_warmup=100, n_samples=3000, seed=0,
                                   algorithm='mh', segment_steps=100,
                                   rhat_stop=0.2, device='cpu')
        assert 50 <= res.n_steps < 3000
        assert np.max(res.rhat - 1) < 0.2
        full = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, n_chains=8,
                                    n_warmup=100, n_samples=res.n_steps + 200,
                                    seed=0, algorithm='mh',
                                    segment_steps=100, device='cpu')
        np.testing.assert_array_equal(full.chain[:res.n_steps], res.chain)

    def test_covmat_round_trip_and_errors(self, tmp_path):
        """A run's <output>.covmat seeds the next run (cobaya's fill rule
        for absent parameters); malformed covmats raise as in
        victor_tpu."""
        kw = dict(n_chains=4, n_warmup=6, n_samples=6, seed=2,
                  algorithm='mh', segment_steps=6, device='cpu')
        root = str(tmp_path / 'run')
        trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, output=root, **kw)
        res = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK,
                                   covmat=root + '.covmat', **kw)
        assert np.isfinite(res.log_prob).all()
        tchains.write_covmat(str(tmp_path / 'a.covmat'), ['a'],
                             np.array([[0.3]]))
        res = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK,
                                   covmat=str(tmp_path / 'a.covmat'), **kw)
        assert np.isfinite(res.log_prob).all()     # b falls back to 0.5**2
        block = dict(GAUSS_BLOCK, b={'prior': {'dist': 'uniform',
                                               'min': -5.0, 'max': 5.0}})
        for covmat, match in (((str(tmp_path / 'a.covmat'), block),
                               'no proposal'),
                              ((np.array([[1.0, 2.0], [2.0, 1.0]]),
                                GAUSS_BLOCK), 'positive definite'),
                              ((np.eye(3), GAUSS_BLOCK), 'shape')):
            with pytest.raises(InputError, match=match):
                trunner.run_hmc_mcmc(gauss_loglike, covmat[1],
                                     covmat=covmat[0], **kw)

    def test_mh_is_the_default_algorithm(self):
        """With no `algorithm`, run_hmc_mcmc runs HMC, as victor_tpu does
        (MH was the port's default until its gradients came); MH is asked
        for by name and gives other draws."""
        kw = dict(n_chains=2, n_warmup=3, n_samples=3, seed=5,
                  segment_steps=6, device='cpu')
        res = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, **kw)
        hmc = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK,
                                   algorithm='hmc', **kw)
        mh = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK,
                                  algorithm='mh', **kw)
        np.testing.assert_array_equal(res.chain, hmc.chain)
        assert not np.array_equal(res.chain, mh.chain)
        assert res.chain.shape == (3, 2, 2)

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip('a CUDA device is present')
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, algorithm='mh')
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trunner.run_mcmc(gauss_loglike, GAUSS_BLOCK)


def _fixed_now(monkeypatch):
    class Fixed(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 1, 2, 3, 4, 5)
    monkeypatch.setattr(datetime, 'datetime', Fixed)


class TestChainFiles:
    @pytest.mark.parametrize('n_files,weights', [(None, False), (3, False),
                                                 (2, True)])
    def test_files_byte_identical(self, tmp_path, monkeypatch, n_files,
                                  weights):
        """GetDist chains, .paramnames, .ranges, .covmat and .progress as
        victor_tpu writes them for the same arrays, byte for byte."""
        _fixed_now(monkeypatch)
        block = dict(GAUSS_BLOCK, b={'prior': {'dist': 'uniform', 'min': -5.0,
                                               'max': 5.0}, 'latex': r'\beta'})
        rng = np.random.default_rng(12)
        chain = rng.normal(size=(30, 6, 2))
        lnp = rng.normal(size=(30, 6)) - 10.0
        aux = rng.normal(size=(30, 6, 1)) ** 2
        wts = rng.uniform(0.1, 2.0, size=(30, 6)) if weights else None
        roots = {}
        for name, chains, priors in (('j', jchains, jpriors),
                                     ('t', tchains, tpriors)):
            root = str(tmp_path / name / 'run')
            chains.export_getdist(root, priors.ParamSpace(block), chain, lnp,
                                  aux, aux_names=['chi2_ccf_correct'],
                                  burn_in=3, n_chain_files=n_files,
                                  weights=wts)
            chains.append_progress(root, 10, 0.25, 0.031, reset=True)
            chains.append_progress(root, 20, 0.2512345, float('nan'))
            chains.write_covmat(root + '.extra.covmat', ['a', 'b'],
                                np.array([[1.0, 0.1], [0.1, 2.0]]))
            roots[name] = root
        files = sorted(os.listdir(tmp_path / 'j'))
        assert files == sorted(os.listdir(tmp_path / 't'))
        assert {'run.1.txt', 'run.paramnames', 'run.ranges', 'run.covmat',
                'run.progress'} <= set(files)
        for fn in files:
            assert (tmp_path / 't' / fn).read_bytes() == \
                (tmp_path / 'j' / fn).read_bytes(), fn
        names, w, mlnp, samples = tchains.read_getdist(roots['t'])
        assert names == ['a', 'b', 'ab', 'chi2_ccf_correct']
        assert samples.shape[1] == 4
        want = jchains.read_progress(roots['j'])
        got = tchains.read_progress(roots['t'])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

    def test_read_covmat_fill_rule(self, tmp_path):
        path = str(tmp_path / 'x.covmat')
        tchains.write_covmat(path, ['b', 'z', 'a'],
                             np.array([[2.0, 0.1, 0.3], [0.1, 5.0, 0.0],
                                       [0.3, 0.0, 1.0]]))
        for names, fb in ((['a', 'b', 'c'], np.array([9.0, 9.0, 4.0])),
                          (['c', 'a'], None)):
            np.testing.assert_array_equal(
                tchains.read_covmat(path, names, fb),
                jchains.read_covmat(path, names, fb))
        with pytest.raises(InputError, match='shares no'):
            tchains.read_covmat(path, ['q'])


class TestDiagnostics:
    def test_match_victor_tpu(self):
        rng = np.random.default_rng(13)
        x = np.cumsum(rng.normal(size=(400, 6, 3)), axis=0) * 0.05 \
            + rng.normal(size=(400, 6, 3))
        for fn in ('split_rhat', 'autocorr_time', 'effective_sample_size'):
            np.testing.assert_allclose(getattr(tdiag, fn)(x),
                                       np.asarray(getattr(jdiag, fn)(x)),
                                       rtol=1e-12)
        const = np.ones((10, 4, 2))
        np.testing.assert_array_equal(tdiag.split_rhat(const),
                                      np.asarray(jdiag.split_rhat(const)))
        np.testing.assert_array_equal(tdiag.split_rhat(x[:3]),
                                      np.asarray(jdiag.split_rhat(x[:3])))
        assert tdiag.acceptance_fraction(np.array([3.0, 5.0]), 8) == \
            jdiag.acceptance_fraction(np.array([3.0, 5.0]), 8)

"""The port's gradient samplers against victor_tpu: the batched posterior's
value and gradient, the HMC and NUTS steps with the staged warmup, segments,
checkpoints, recovery of Gaussian targets, and the CLI's `--sampler
hmc|nuts`.

victor_tpu draws its noise by splitting threefry keys inside each step; the
port's steps take theirs as arguments. The parity tests replay victor_tpu's
key splits (HMC: `split(key, 5)` per step; NUTS: `split(key, 3)` per step,
`split(key, 4)` per doubling and `split(key)` per leaf) and feed the same
draws to the port. Everything is float64 on the CPU with one thread.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from victor_tpu.sampling import hmc as jhmc
from victor_tpu.sampling import nuts as jnuts
from victor_tpu.sampling import priors as jpriors
from victor_tpu.sampling import targets as jtargets
from victor_tpu_torch.errors import InputError
from victor_tpu_torch.sampling import diagnostics as tdiag
from victor_tpu_torch.sampling import hmc as thmc
from victor_tpu_torch.sampling import nuts as tnuts
from victor_tpu_torch.sampling import priors as tpriors
from victor_tpu_torch.sampling import runner as trunner
from victor_tpu_torch.sampling import targets as ttargets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN4 = np.array([0.5, -1.0, 2.0, 0.0])
COV4 = np.array([[1.0, 0.6, 0.2, 0.0],
                 [0.6, 2.0, -0.3, 0.1],
                 [0.2, -0.3, 0.5, 0.05],
                 [0.0, 0.1, 0.05, 1.5]])
STATE_FIELDS = ('q', 'lnp', 'grad', 'aux', 'log_eps', 'log_eps_avg', 'h_bar',
                'welford_mean', 'welford_m2', 'welford_n', 'chol_cov',
                'n_accepted')


def gaussian_pair(mean, cov):
    """The same Gaussian log density as victor_tpu's per-chain function and
    the port's batched one (aux: the log density again)."""
    ci = np.linalg.inv(cov)

    def jfn(y):
        d = y - jnp.asarray(mean)
        lnp = -0.5 * d @ jnp.asarray(ci) @ d
        return lnp, jnp.stack([lnp])

    def tfn(y):
        d = y - torch.as_tensor(mean)
        lnp = -0.5 * ((d @ torch.as_tensor(ci)) * d).sum(-1)
        return lnp, lnp[:, None]

    return jfn, tfn


def port_state(jst):
    """victor_tpu's HMCState as the port's (its key has no counterpart)."""
    return thmc.HMCState(generator=torch.Generator(), **{
        f: torch.as_tensor(np.array(getattr(jst, f))) for f in STATE_FIELDS})


def assert_states_close(jst, tst, tol):
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)),
                                   rtol=tol, atol=tol, err_msg=f)


def _torch(a):
    return torch.as_tensor(np.array(a))


def replay_hmc_noise(keys, n_steps, ndim, n_leapfrog):
    """victor_tpu's per-step HMC draws of each chain (hmc.py:81-101), step
    first: jitter (S, C), n_steps (S, C), xi (S, C, ndim), u (S, C)."""
    def one(k):
        def body(k, _):
            k, k_mom, k_acc, k_jit, k_len = jax.random.split(k, 5)
            return k, (jax.random.uniform(k_jit, (), minval=0.9, maxval=1.1),
                       jax.random.randint(k_len, (), max(1, n_leapfrog // 2),
                                          n_leapfrog + 1),
                       jax.random.normal(k_mom, (ndim,)),
                       jax.random.uniform(k_acc, ()))
        return jax.lax.scan(body, k, None, length=n_steps)[1]
    return tuple(_torch(a).transpose(0, 1) for a in jax.vmap(one)(keys))


def replay_nuts_noise(keys, n_steps, ndim, max_depth):
    """victor_tpu's per-step NUTS draws of each chain (nuts.py:167-191 and
    :122-124), step first: xi (S, C, ndim), go_right (S, D, C), u_merge
    (S, D, C), u_leaf (S, D, 2^(D-1), C)."""
    def one(k):
        def body(k, _):
            key, k_mom, k_tree = jax.random.split(k, 3)

            def doubling(kt, _):
                kt, k_dir, k_merge, k_sub = jax.random.split(kt, 4)

                def leaf(kl, _):
                    kl, k_sw = jax.random.split(kl)
                    return kl, jax.random.uniform(k_sw, ())
                leaves = jax.lax.scan(leaf, k_sub, None,
                                      length=1 << (max_depth - 1))[1]
                return kt, (jax.random.bernoulli(k_dir),
                            jax.random.uniform(k_merge, ()), leaves)
            draws = jax.lax.scan(doubling, k_tree, None, length=max_depth)[1]
            return key, (jax.random.normal(k_mom, (ndim,)),) + draws
        return jax.lax.scan(body, k, None, length=n_steps)[1]
    xi, go, um, ul = (_torch(a) for a in jax.vmap(one)(keys))
    return (xi.transpose(0, 1), go.permute(1, 2, 0), um.permute(1, 2, 0),
            ul.permute(1, 2, 3, 0))


def hmc_steps(value_grad, noise):
    jit, n_steps, xi, u = noise
    return lambda st, k, adapt, mu: thmc._hmc_step(
        value_grad, st, jit[k], n_steps[k], xi[k], u[k], adapt, mu_offset=mu)


def nuts_steps(value_grad, noise, max_depth):
    xi, go, um, ul = noise
    return lambda st, k, adapt, mu: tnuts._nuts_step(
        value_grad, st, xi[k], lambda d: (go[k, d], um[k, d],
                                          ul[k, d, :1 << d]),
        max_depth, adapt, mu_offset=mu)


def port_segment(step, states, i0, length, n_warmup, eps0=0.1):
    """The port's staged segment, step k taking the k-th injected draws."""
    def step_fn(st, adapt, mu):
        k = step_fn.i
        step_fn.i += 1
        return step(st, k, adapt, mu)
    step_fn.i = i0
    return thmc.staged_segment(step_fn, states, i0, length, n_warmup, eps0)


def moved(ys):
    return np.any(np.diff(ys, axis=1) != 0, axis=-1)


# ---------------------------------------------------------------------------
# the steps against victor_tpu on a Gaussian
# ---------------------------------------------------------------------------

SAMPLERS = {
    'hmc': (lambda vg, keys, n, nd: hmc_steps(
        vg, replay_hmc_noise(keys, n, nd, 8)),
        lambda jfn, n_warmup: lambda st, i: jhmc.run_segment(
            jfn, st, i, 1, n_warmup=n_warmup, n_leapfrog=8),
        lambda jfn, n, n_warmup: lambda st: jhmc.run_segment(
            jfn, st, jnp.zeros((), jnp.int32), n, n_warmup=n_warmup,
            n_leapfrog=8)),
    'nuts': (lambda vg, keys, n, nd: nuts_steps(
        vg, replay_nuts_noise(keys, n, nd, 5), 5),
        lambda jfn, n_warmup: lambda st, i: jnuts.run_segment(
            jfn, st, i, 1, n_warmup=n_warmup, max_depth=5),
        lambda jfn, n, n_warmup: lambda st: jnuts.run_segment(
            jfn, st, jnp.zeros((), jnp.int32), n, n_warmup=n_warmup,
            max_depth=5)),
}


@pytest.mark.parametrize('sampler', ['hmc', 'nuts'])
def test_gaussian_steps_match_victor_tpu(sampler):
    """Four chains on a correlated 4-D Gaussian, 45 steps (30 of staged
    warmup: both metric resets and the freeze), victor_tpu's own draws.

    Step by step: from victor_tpu's state before each step the port's step
    reaches victor_tpu's state after it, every field within 1e-12.
    Free-running: the same accept (or move) decisions at every step, and
    the runs end within 1e-5. Not closer: XLA's f64 exp and log differ from
    glibc's in the last bit for a few inputs, and the trajectories and the
    dual averaging amplify that one ulp about tenfold per step (to ~1e-10
    at the dense reset, ~1e-6 by the end of the warmup), as they amplify
    any rounding difference between two builds."""
    make_steps, jone, jall = SAMPLERS[sampler]
    jfn, tfn = gaussian_pair(MEAN4, COV4)
    y0 = np.asarray(MEAN4 + 1.5 * jax.random.normal(jax.random.PRNGKey(11),
                                                    (4, 4)))
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    n, n_warmup = 45, 30
    vg = thmc.value_and_grad(tfn)
    steps = make_steps(vg, keys, n, 4)
    jstep = jax.jit(jone(jfn, n_warmup))
    jstates = [jhmc.init_chains(jfn, jnp.asarray(y0), keys)]
    for i in range(n):
        jstates.append(jstep(jstates[-1], jnp.asarray(i, jnp.int32))[0])
    for i in range(n):
        tst, _ = port_segment(steps, port_state(jstates[i]), i, 1, n_warmup)
        assert_states_close(jstates[i + 1], tst, 1e-12)

    jst, (jys, _, _) = jax.jit(jall(jfn, n, n_warmup))(jstates[0])
    tst = thmc.init_chains(tfn, torch.as_tensor(y0), torch.Generator())
    assert_states_close(jstates[0], tst, 1e-14)
    tst, (tys, tlnp, _) = port_segment(steps, tst, 0, n, n_warmup)
    np.testing.assert_array_equal(moved(tys.numpy()), moved(np.asarray(jys)))
    assert 0 < moved(tys.numpy()).mean()
    assert_states_close(jst, tst, 1e-5)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-5,
                               atol=1e-5)


def test_hmc_chains_of_unequal_lengths_freeze_when_done():
    """Per-chain trajectory lengths: every chain runs the longest one's
    leapfrogs and a chain keeps its point once its own count is reached, so
    each chain equals a batch of one with its own length (to rounding: a
    batch of one takes other BLAS paths)."""
    _, tfn = gaussian_pair(MEAN4, COV4)
    vg = thmc.value_and_grad(tfn)
    y = torch.as_tensor(MEAN4 + np.random.default_rng(2).normal(size=(3, 4)))
    lnp, aux, grad = vg(y)
    p = torch.as_tensor(np.random.default_rng(3).normal(size=(3, 4)))
    L = torch.linalg.cholesky(torch.as_tensor(COV4)).expand(3, 4, 4)
    eps = torch.tensor([0.2, 0.3, 0.1], dtype=torch.float64)
    n_steps = torch.tensor([2, 7, 4])
    batch = thmc._leapfrog(vg, y, p, grad, lnp, aux, eps, L, n_steps)
    for c in range(3):
        one = thmc._leapfrog(vg, y[c:c + 1], p[c:c + 1], grad[c:c + 1],
                             lnp[c:c + 1], aux[c:c + 1], eps[c:c + 1],
                             L[c:c + 1], n_steps[c:c + 1])
        for a, b in zip(batch, one):
            np.testing.assert_allclose(a[c:c + 1].numpy(), b.numpy(),
                                       rtol=1e-13, atol=1e-13)


def test_nuts_checkpoint_scheme_covers_recursive_uturn_pairs():
    """The host-side U-turn bookkeeping of nuts._build_subtree (even leaf m
    at slot popcount(m); odd leaf n checked against slots popcount(n >> t)
    .. popcount(n) - 1) reproduces the (leftmost, rightmost) leaf pairs of
    every internal node of the recursive tree (tests/test_sampling.py)."""
    def recursive_pairs(lo, size):
        if size == 1:
            return set()
        half = size // 2
        return ({(lo, lo + size - 1)} | recursive_pairs(lo, half)
                | recursive_pairs(lo + half, half))

    for depth in range(1, 10):
        slots, checked = {}, set()
        for n in range(2 ** depth):
            if n % 2 == 0:
                slots[tnuts._popcount(n)] = n
            else:
                lo = tnuts._popcount(n >> tnuts._trailing_ones(n))
                for j in range(lo, tnuts._popcount(n)):
                    checked.add((slots[j], n))
        assert checked == recursive_pairs(0, 2 ** depth), depth


# ---------------------------------------------------------------------------
# the BOSS posterior
# ---------------------------------------------------------------------------

BOSS_BLOCK = {
    'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
             'ref': {'dist': 'norm', 'loc': 0.4, 'scale': 0.05}},
    'sigma_v': {'prior': {'dist': 'uniform', 'min': 100, 'max': 500},
                'ref': {'dist': 'norm', 'loc': 380, 'scale': 20}},
    'epsilon': 1.0,
}
THETA0 = np.array([[0.47, 0.38, 380.0], [0.52, 0.36, 420.0]])


@pytest.fixture(scope='module')
def boss_posterior(boss_config):
    """victor_tpu's per-chain posterior over the unbounded space
    (runner.py:213-220) and the port's batched one, AD-resolved modes."""
    from victor_tpu.io import build_tables
    from victor_tpu_torch.io.tables import bundle_from_arrays, tables_to_arrays
    jb = build_tables(boss_config['model'], boss_config['data'])
    tb = bundle_from_arrays(tables_to_arrays(jb.tables),
                            dataclasses.asdict(jb.spec),
                            dataclasses.asdict(jb.theory_opts),
                            dataclasses.asdict(jb.fit_opts), device='cpu')
    jspace, tspace = jpriors.ParamSpace(BOSS_BLOCK), \
        tpriors.ParamSpace(BOSS_BLOCK)
    tbl, jloglike, _ = jtargets.resolve_target(jb, None, None,
                                               gradient_free=False)

    def jlogpost_y(y):
        theta = jspace.to_bounded(y)
        lnl, chisq = jloglike(tbl, jspace.full_params(theta))
        total = lnl + jspace.log_prior(theta) + jspace.log_jacobian(y)
        return (jnp.where(jnp.isfinite(total), total, -jnp.inf),
                jnp.stack([chisq]))

    _, tloglike = ttargets.resolve_target(tb, None, None, gradient_free=False)
    tlogpost_y = trunner.unbounded_logpost(tspace, tloglike, tb.tables)
    y0 = np.asarray(jspace.to_unbounded(jnp.asarray(THETA0)))
    return jlogpost_y, tlogpost_y, y0


def test_value_and_grad_per_row_matches_jax(boss_posterior):
    """hmc.value_and_grad: one autograd.grad of the summed lnp gives each
    row's own gradient (rows are independent), as jax.value_and_grad per
    chain: lnp, aux and gradient within 1e-9 relative; a row at the edge of
    the prior box too."""
    jlogpost_y, tlogpost_y, y0 = boss_posterior
    y = np.concatenate([y0, [[4.5, -3.0, 2.0]]])
    (jl, ja), jg = jax.vmap(jax.value_and_grad(jlogpost_y, has_aux=True))(
        jnp.asarray(y))
    tl, ta, tg = thmc.value_and_grad(tlogpost_y)(torch.as_tensor(y))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-9)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-9 * float(np.abs(jg).max()))
    assert not tl.requires_grad and not tg.requires_grad


@pytest.mark.parametrize('sampler', ['hmc', 'nuts'])
def test_boss_steps_match_victor_tpu(boss_posterior, sampler):
    """Three steps of two chains on the BOSS posterior (HMC with at most 4
    leapfrogs, NUTS to depth 3), victor_tpu's draws: positions and log
    posterior along the way within 1e-9, the same decisions."""
    jlogpost_y, tlogpost_y, y0 = boss_posterior
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    n, n_warmup = 3, 2
    vg = thmc.value_and_grad(tlogpost_y)
    if sampler == 'hmc':
        steps = hmc_steps(vg, replay_hmc_noise(keys, n, 3, 4))
        jrun = jhmc.run_segment
        kw = dict(n_leapfrog=4)
    else:
        steps = nuts_steps(vg, replay_nuts_noise(keys, n, 3, 3), 3)
        jrun = jnuts.run_segment
        kw = dict(max_depth=3)
    jst = jhmc.init_chains(jlogpost_y, jnp.asarray(y0), keys)
    jst, (jys, jlnp, _) = jax.jit(lambda st: jrun(
        jlogpost_y, st, jnp.zeros((), jnp.int32), n, n_warmup=n_warmup,
        **kw))(jst)
    tst = thmc.init_chains(tlogpost_y, torch.as_tensor(y0), torch.Generator())
    tst, (tys, tlnp, _) = port_segment(steps, tst, 0, n, n_warmup)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-9)
    np.testing.assert_allclose(tlnp.numpy(), np.asarray(jlnp), rtol=1e-9)
    np.testing.assert_array_equal(moved(tys.numpy()), moved(np.asarray(jys)))
    np.testing.assert_allclose(tst.grad.numpy(), np.asarray(jst.grad),
                               rtol=1e-9, atol=1e-9)
    assert np.isfinite(tlnp.numpy()).all()


# ---------------------------------------------------------------------------
# segments, checkpoints, recovery
# ---------------------------------------------------------------------------

def _segmented(run_segment, tfn, y0, total, every, n_warmup, **kw):
    gen = torch.Generator()
    gen.manual_seed(8)
    st, recs, i0 = thmc.init_chains(tfn, y0, gen), [], 0
    while i0 < total:
        length = min(every, total - i0)
        st, (qs, lnps, _) = run_segment(tfn, st, i0, length, n_warmup, **kw)
        recs.append((qs, lnps))
        i0 += length
    return st, torch.cat([r[0] for r in recs], 1), \
        torch.cat([r[1] for r in recs], 1)


@pytest.mark.parametrize('sampler,kw', [('hmc', {'n_leapfrog': 6}),
                                        ('nuts', {'max_depth': 4})])
def test_segments_bitexact_vs_monolithic(sampler, kw):
    """The generator's draws per step are a function of the state alone, so
    a run split into segments equals one uninterrupted run bit for bit."""
    run_segment = thmc.run_segment if sampler == 'hmc' else tnuts.run_segment
    _, tfn = gaussian_pair(MEAN4, COV4)
    y0 = torch.as_tensor(MEAN4 + np.random.default_rng(1).normal(
        size=(4, 4)))
    st1, ys1, lnp1 = _segmented(run_segment, tfn, y0, 24, 24, 15, **kw)
    st2, ys2, lnp2 = _segmented(run_segment, tfn, y0, 24, 7, 15, **kw)
    assert torch.equal(ys1, ys2) and torch.equal(lnp1, lnp2)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(st1, f), getattr(st2, f)), f


GAUSS_BLOCK = {
    'a': {'prior': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0},
          'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.5}},
    'b': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0},
          'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.5}},
    'c': 2.0,
}


def gauss_loglike(params):
    chi2 = (params['a'] - 0.3) ** 2 + (params['b'] + 0.2) ** 2 / 0.5
    return -0.5 * chi2, chi2


@pytest.mark.parametrize('algorithm', ['hmc', 'nuts'])
def test_checkpoint_resume_bitexact(tmp_path, algorithm):
    """A resumed run (state, gradient and generator from the checkpoint)
    extends the first run's chain exactly as one uninterrupted run; the
    checkpoint holds the real gradient."""
    kw = dict(n_chains=4, n_warmup=6, seed=3, algorithm=algorithm,
              n_leapfrog=6, max_depth=4, segment_steps=5, device='cpu')
    full = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, n_samples=10,
                                **kw)
    ckpt = str(tmp_path / 'run.npz')
    r1 = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, n_samples=4,
                              checkpoint=ckpt, **kw)
    with np.load(ckpt) as z:
        assert np.abs(z['hmc_grad']).max() > 0
    r2 = trunner.run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, n_samples=10,
                              checkpoint=ckpt, resume=True,
                              **{**kw, 'seed': 99})
    np.testing.assert_array_equal(r1.chain, full.chain[:4])
    np.testing.assert_array_equal(r2.chain, full.chain)
    np.testing.assert_array_equal(r2.log_prob, full.log_prob)
    assert r2.chain.shape == (10, 4, 2)


def test_hmc_recovers_gaussian():
    """victor_tpu's test_hmc_recovers_gaussian (tests/test_sampling.py) with
    the port's own draws: mean, covariance, acceptance, R-hat and ESS."""
    mean = np.array([1.0, -2.0])
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    _, tfn = gaussian_pair(mean, cov)
    gen = torch.Generator()
    gen.manual_seed(0)
    y0 = torch.as_tensor(mean) + torch.randn(8, 2, generator=gen,
                                             dtype=torch.float64)
    st, (ys, lnps, _) = thmc.run_hmc(tfn, y0, gen, n_warmup=200,
                                     n_samples=500, n_leapfrog=8)
    chain = ys.numpy().transpose(1, 0, 2)
    flat = chain.reshape(-1, 2)
    assert np.isfinite(lnps.numpy()).all()
    np.testing.assert_allclose(flat.mean(axis=0), mean, atol=0.12)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.35)
    acc = float(st.n_accepted.mean()) / 500
    assert 0.6 < acc <= 1.0
    assert np.all(tdiag.split_rhat(chain) < 1.02)
    assert np.all(tdiag.effective_sample_size(chain) > 1000)


def test_nuts_recovers_correlated_gaussian():
    """victor_tpu's test_nuts_recovers_correlated_gaussian (rho = 0.95)
    with the port's own draws. Its 0.15 bound on the mean of the sigma-3
    axis is under two standard errors at this ESS (~1,200): seeds 0-4 read
    0.03, 0.22, 0.002, 0.05 and 0.19."""
    cov = np.array([[1.0, 0.95 * 3.0], [0.95 * 3.0, 9.0]])
    _, tfn = gaussian_pair(np.zeros(2), cov)
    gen = torch.Generator()
    gen.manual_seed(2)
    y0 = torch.randn(8, 2, generator=gen, dtype=torch.float64) * \
        torch.tensor([1.0, 3.0], dtype=torch.float64)
    _, (ys, lnps, _) = tnuts.run_nuts(tfn, y0, gen, n_warmup=300,
                                      n_samples=500, max_depth=8)
    chain = ys.numpy().transpose(1, 0, 2)
    assert np.isfinite(lnps.numpy()).all()
    assert np.all(tdiag.split_rhat(chain) < 1.02)
    flat = chain.reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), cov, rtol=0.2, atol=0.2)
    assert np.all(tdiag.effective_sample_size(chain) > 800)


def test_nuts_max_depth_is_checked():
    _, tfn = gaussian_pair(MEAN4, COV4)
    st = thmc.init_chains(tfn, torch.as_tensor(np.tile(MEAN4, (2, 1))),
                          torch.Generator())
    for depth in (0, 17):
        with pytest.raises(InputError, match='max_depth'):
            tnuts.run_segment(tfn, st, 0, 1, 0, max_depth=depth)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture()
def sampling_cfg(tmp_path):
    """configs/boss_sampling_config.yaml with absolute data paths and one
    sampled parameter."""
    with open(os.path.join(REPO, 'configs', 'boss_sampling_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    cfg['params'] = {
        'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                    'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02}},
        'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
    cfg['sampler'] = {'n_chains': 2}
    return cfg


def _write(tmp_path, cfg, name='cfg.yaml'):
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


class _Captured(Exception):
    pass


@pytest.mark.parametrize('argv,sampler', [
    (['--sampler', 'hmc'], {}), (['--sampler', 'nuts'], {}),
    (['--sampler', 'nuts', '--max-depth', '4', '--leapfrog', '10',
      '--warmup', '7', '--samples', '9'], {}),
    ([], {'kind': 'hmc', 'n_leapfrog': 12, 'segment_steps': 50}),
    ([], {'kind': 'nuts', 'max_depth': 5, 'rhat_stop': 0.05,
          'n_warmup': 20, 'n_samples': 30}),
    ([], {}), (['--sampler', 'mh'], {})])
def test_cli_sampler_defaults_match_victor_tpu(sampling_cfg, tmp_path,
                                               monkeypatch, argv, sampler):
    """What `run` passes to run_hmc_mcmc for each chain sampler, from the
    command line or the sampler block, equals what victor_tpu's CLI passes:
    hmc 300 warmup, 700 draws, segments of 100, 16 leapfrogs; nuts 300
    warmup, 4000 draws, max_depth 6 and rhat_stop 0.01; mh without a kind."""
    import victor_tpu.sampling as jsampling
    import victor_tpu_torch.sampling as tsampling
    from victor_tpu.__main__ import main as jmain
    from victor_tpu_torch.__main__ import main as tmain
    cfg = copy.deepcopy(sampling_cfg)
    cfg['sampler'].update(sampler)
    path = _write(tmp_path, cfg)
    keys = ('n_chains', 'n_warmup', 'n_samples', 'n_leapfrog',
            'segment_steps', 'seed', 'algorithm', 'max_depth', 'covmat',
            'rhat_stop', 'output', 'checkpoint', 'resume')
    seen = {}
    for name, module, main, extra in (
            ('j', jsampling, jmain, []),
            ('t', tsampling, tmain, ['--device', 'cpu'])):
        def capture(bundle, block, **kw):
            seen[name] = {k: kw.get(k) for k in keys}
            raise _Captured
        monkeypatch.setattr(module, 'run_hmc_mcmc', capture)
        with pytest.raises(_Captured):
            main(['run', path] + argv + extra)
    assert seen['t'] == seen['j']


@pytest.mark.parametrize('kind', ['hmc', 'nuts'])
def test_cli_runs_the_gradient_samplers(sampling_cfg, tmp_path, capsys,
                                        kind):
    """`run --sampler hmc|nuts --device cpu` samples the BOSS posterior and
    prints the JSON keys of victor_tpu's CLI (one code path for mh, hmc and
    nuts there) and writes the same files as MH."""
    path = _write(tmp_path, sampling_cfg)
    from victor_tpu_torch.__main__ import main as tmain
    tmain(['run', path, '--sampler', kind, '--warmup', '4', '--samples', '4',
           '--leapfrog', '4', '--max-depth', '3', '--seed', '3',
           '--output', str(tmp_path / kind / 'c'), '--device', 'cpu'])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {'sampler', 'n_samples', 'acceptance', 'elapsed_s',
                        'summary'}
    assert out['sampler'] == kind and out['n_samples'] == 4
    assert set(out['summary']) == {'fsigma8'}
    assert {'c.1.txt', 'c.2.txt', 'c.paramnames', 'c.ranges', 'c.covmat',
            'c.progress', 'c.input.yaml'} == set(os.listdir(tmp_path / kind))
    table = np.loadtxt(tmp_path / kind / 'c.1.txt')     # weight, -lnp, theta,
    assert table.shape == (4, 4) and np.isfinite(table).all()   # chi2

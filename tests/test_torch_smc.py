"""The port's tempered SMC (`sampling/smc.py`) and the particle samplers'
helpers (`targets.make_unbounded_wrappers`, `guarded_cholesky`) against
victor_tpu's.

victor_tpu splits threefry keys inside its jitted stage; the port draws from
a torch.Generator. The port's stage takes its noise as arguments, so the
parity tests replay victor_tpu's key splits (`key, k_res = split(key)`, then
`split(key, n_moves + 1)` and `k1, k2 = split(k)` per move) and feed the
same draws to the port. victor_tpu's own compiled stage is taken from its
function cache after a short run. The host bookkeeping (the d-beta
bisection, log Z, its se, the ladder) is held bit for bit by a whole run in
which the port's device steps are victor_tpu's. Both packages get the same
tables (bundle_from_arrays of victor_tpu's) at a narrow width (n_mu 20,
n_v 10); everything is float64 on the CPU with one thread.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victor_tpu.io import build_tables as jax_build_tables
from victor_tpu.sampling import smc as jsmc
from victor_tpu.sampling import targets as jtargets
from victor_tpu.sampling.priors import ParamSpace as JParamSpace
from victor_tpu_torch.errors import InputError
from victor_tpu_torch.io.tables import bundle_from_arrays, tables_to_arrays
from victor_tpu_torch.parallel.mesh import shard_map
from victor_tpu_torch.sampling import priors as tpriors
from victor_tpu_torch.sampling import smc as tsmc
from victor_tpu_torch.sampling import targets as ttargets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = {'n_mu': 20, 'n_v': 10}
MU = np.array([0.5, -0.3])
COV = np.array([[1.0, 0.6], [0.6, 0.8]])
ICOV = np.linalg.inv(COV)
LOGNORM = float(-np.log(2 * np.pi) - 0.5 * np.log(np.linalg.det(COV)))
BLOCK = {'x': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}},
         'y': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}}}
# the BOSS sampling config's priors (configs/boss_sampling_config.yaml)
BOSS_BLOCK = {
    'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5}},
    'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6}},
    'sigma_v': {'prior': {'dist': 'uniform', 'min': 100.0, 'max': 500.0}},
    'epsilon': {'prior': {'dist': 'uniform', 'min': 0.8, 'max': 1.2}},
}
TOL = 1e-12          # one stage or step, the noise injected
RUN_TOL = 1e-10      # a short run, the noise injected throughout


def gauss_jax(params):
    """victor_tpu's per-point callable: the correlated Gaussian of
    tests/test_smc.py, normalised, with chi2 as its aux."""
    d = jnp.stack([params['x'] - MU[0], params['y'] - MU[1]])
    chi2 = d @ jnp.asarray(ICOV) @ d
    return LOGNORM - 0.5 * chi2, chi2


def gauss_torch(params):
    """The same Gaussian over the port's batch axis."""
    d = torch.stack([params['x'] - MU[0], params['y'] - MU[1]], -1)
    chi2 = torch.einsum('bi,ij,bj->b', d, torch.as_tensor(ICOV), d)
    return LOGNORM - 0.5 * chi2, chi2


def boss_config():
    import yaml
    with open(os.path.join(REPO, 'configs', 'boss_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    return cfg


def boss_pair(cfg=None):
    """victor_tpu's BOSS bundle at the narrow width and the port's on the
    same tables."""
    cfg = cfg or boss_config()
    jb = jax_build_tables(copy.deepcopy(cfg['model']),
                          copy.deepcopy(cfg['data']), **REDUCED)
    tb = bundle_from_arrays(tables_to_arrays(jb.tables),
                            dataclasses.asdict(jb.spec),
                            dataclasses.asdict(jb.theory_opts),
                            dataclasses.asdict(jb.fit_opts), device='cpu')
    return jb, tb


@pytest.fixture(scope='module')
def boss():
    return boss_pair()


def targets(which, boss):
    """(victor_tpu target, port target, params block, chunk, particles)."""
    if which == 'gauss':
        return gauss_jax, gauss_torch, BLOCK, None, 64
    return boss[0], boss[1], BOSS_BLOCK, 16, 32


# the stages of the short runs: the Gaussian reaches beta = 1 at its third
SHORT_STAGES = {'gauss': 2, 'boss': 3}


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(t):
    return jnp.asarray(t.detach().numpy())


def prior_draw(block, seed, n):
    """victor_tpu's initial prior draw (`key, k0 = split(PRNGKey(seed))`)
    and the key that follows it."""
    key, k0 = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(JParamSpace(block).sample_prior(k0, n)), key


def replay_stage_noise(key, n, d, n_moves):
    """victor_tpu's draws of one stage from `key` (smc.py:170-200): the
    port's (u_res, eps (n_moves, n, d), u_acc (n_moves, n)) and the next
    key."""
    key, k_res = jax.random.split(key)
    u_res = jax.random.uniform(k_res, ())
    keys = jax.random.split(key, n_moves + 1)
    eps, u = [], []
    for k in keys[1:]:
        k1, k2 = jax.random.split(k)
        eps.append(jax.random.normal(k1, (n, d)))
        u.append(jax.random.uniform(k2, (n,)))
    return (_t(u_res), _t(np.stack(eps)), _t(np.stack(u))), keys[0]


def inject_prior(monkeypatch, theta0):
    """The port's ParamSpace.sample_prior returns victor_tpu's draw."""
    monkeypatch.setattr(tpriors.ParamSpace, 'sample_prior',
                        lambda self, gen, n: _t(theta0))


def last_cached(cache):
    """The functions of victor_tpu's most recent run (its LRU jit cache)."""
    return next(reversed(cache.values()))


def load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['spread', 'degenerate', 'nan'])
def test_guarded_cholesky_matches_victor_tpu(case):
    """The jittered, Haario-scaled proposal factor, with the diagonal
    fallback where the Cholesky fails (a NaN particle here; victor_tpu's
    jnp.linalg.cholesky gives NaN where torch's would raise)."""
    rng = np.random.default_rng(3)
    y = rng.standard_normal((40, 3)) * [1.0, 0.1, 5.0]
    if case == 'degenerate':
        y[:, 2] = 2.0 * y[:, 0]          # rank 2: only the jitter saves it
    if case == 'nan':
        y[5, 1] = np.nan
    w = rng.uniform(0.0, 1.0, 40)
    w /= w.sum()
    want = np.asarray(jtargets.guarded_cholesky(jnp.asarray(w),
                                                jnp.asarray(y), 0.7))
    got = ttargets.guarded_cholesky(_t(w), _t(y), 0.7).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                               equal_nan=True)
    assert np.isnan(got).any() == (case == 'nan')


@pytest.mark.parametrize('which', ['gauss', 'boss'])
def test_unbounded_wrappers_match_victor_tpu(which, boss):
    """lnL (non-finite -> -inf), aux and the prior with the Jacobian over
    the unbounded coordinates, at prior draws and points outside the box,
    through the chunked batch."""
    jt, tt, block, chunk, _ = targets(which, boss)
    theta, _ = prior_draw(block, 5, 37)
    jspace, tspace = JParamSpace(block), tpriors.ParamSpace(block)
    y = np.array(jspace.to_unbounded(jnp.asarray(theta)))
    y[3] = 40.0                 # saturates the logit at the prior's edge
    jtbl, jloglike, _ = jtargets.resolve_target(jt, None, None, True)
    ttbl, tloglike = ttargets.resolve_target(tt, None, None, True)
    _, jprior, jbatched = jtargets.make_unbounded_wrappers(jspace, jloglike,
                                                           chunk)
    tprior, tbatched = ttargets.make_unbounded_wrappers(tspace, tloglike)
    jl, ja = jbatched(jtbl, jnp.asarray(y))
    tl, ta = shard_map(tbatched, ttbl, None, None, chunk)(_t(y))
    assert ta.shape == (37, 1)
    for got, want in ((tl, jl), (ta, ja),
                      (tprior(_t(y)), jax.vmap(jprior)(jnp.asarray(y)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize('seed', range(4))
def test_systematic_resample_matches_victor_tpu(seed):
    """The same indices from the same uniform, the weights' cumulative sum
    searched from the left; a zero weight is never picked."""
    rng = np.random.default_rng(seed)
    w = rng.exponential(size=257) * (rng.uniform(size=257) > 0.3)
    w /= w.sum()
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jsmc._systematic_resample(key, jnp.asarray(w), 257))
    u = _t(jax.random.uniform(key, ()))
    got = tsmc._systematic_resample(u, _t(w), 257).numpy()
    np.testing.assert_array_equal(got, want)
    assert (w[got] > 0).all()


@pytest.mark.parametrize('beta', [0.0, 0.37, 0.999])
def test_choose_dbeta_bit_for_bit(beta):
    """The host bisection (copied numpy): the same d-beta and ESS fraction
    to the bit, including -1e30 stand-ins for L = 0."""
    rng = np.random.default_rng(int(beta * 1000))
    lnl = rng.normal(-200.0, 60.0, 512)
    lnl[::17] = -1e30
    for ess_target in (0.3, 0.5, 0.9):
        assert tsmc._choose_dbeta(lnl, beta, ess_target) == \
            jsmc._choose_dbeta(lnl, beta, ess_target)
    assert tsmc._ess_fraction(0.01 * lnl) == jsmc._ess_fraction(0.01 * lnl)
    assert tsmc.LOGZ_SE_INFLATION == jsmc.LOGZ_SE_INFLATION == 3.0


# ---------------------------------------------------------------------------
# a stage and a short run with the noise injected
# ---------------------------------------------------------------------------

N_MOVES = 2


@pytest.fixture(scope='module', params=['gauss', 'boss'])
def short_runs(request, boss, tmp_path_factory):
    """victor_tpu's and the port's first stages (SHORT_STAGES) from the same
    prior draw, the port given victor_tpu's noise (`max_stages` raises after
    the last stage's checkpoint). Returns the case, the two checkpoints and
    victor_tpu's compiled functions."""
    which = request.param
    jt, tt, block, chunk, n = targets(which, boss)
    tmp = tmp_path_factory.mktemp(f'smc_{which}')
    stages = SHORT_STAGES[which]
    kw = dict(n_particles=n, n_moves=N_MOVES, seed=11, chunk=chunk,
              max_stages=stages)
    with pytest.raises(RuntimeError, match='did not reach beta=1'):
        jsmc.run_smc(jt, block, checkpoint=str(tmp / 'j.npz'), **kw)
    jfns = last_cached(jsmc._SMC_CACHE)
    theta0, key = prior_draw(block, 11, n)
    noise = []
    for _ in range(stages):
        stage, key = replay_stage_noise(key, n, len(block), N_MOVES)
        noise.append(stage)
    with pytest.MonkeyPatch.context() as mp:
        inject_prior(mp, theta0)
        mp.setattr(tsmc, 'draw_stage_noise', lambda *a: noise.pop(0))
        with pytest.raises(RuntimeError, match='did not reach beta=1'):
            tsmc.run_smc(tt, block, checkpoint=str(tmp / 't.npz'),
                         device='cpu', **kw)
    assert not noise
    return which, load(tmp / 'j.npz'), load(tmp / 't.npz'), jfns


def test_short_run_matches_victor_tpu(short_runs):
    """Two or three stages: the ladder, log Z and its se, the ESS and
    acceptance, the particles, lnL, prior and aux within 1e-10."""
    which, jst, tst, _ = short_runs
    assert len(tst['betas']) == len(jst['betas']) == SHORT_STAGES[which] + 1
    for k in ('betas', 'logz', 'var_sum', 'ess', 'acc', 'y', 'lnl', 'lnpri',
              'aux'):
        np.testing.assert_allclose(tst[k], jst[k], rtol=RUN_TOL,
                                   atol=RUN_TOL, err_msg=k)
    assert 'generator' in tst and 'key' not in tst


def test_stage_matches_victor_tpu(short_runs, boss):
    """The next stage from victor_tpu's state after the short run: the port's
    `_stage` with victor_tpu's noise against victor_tpu's compiled stage —
    particles, lnL, prior and aux within 1e-12, the resample indices and
    the acceptance identical."""
    which, jst, _, jfns = short_runs
    jt, tt, block, chunk, n = targets(which, boss)
    lnl_h = np.where(np.isfinite(jst['lnl']), jst['lnl'], -1e30)
    beta = float(jst['beta'])
    dbeta = jsmc._choose_dbeta(lnl_h, beta, 0.5)
    beta_new = min(beta + dbeta, 1.0)
    w = np.exp(dbeta * lnl_h - (dbeta * lnl_h).max())
    w /= w.sum()
    jtbl = jtargets.resolve_target(jt, None, None, True)[0]
    key = jnp.asarray(jst['key'])
    want = jfns['stage'](jtbl, *(jnp.asarray(jst[k]) for k in
                                 ('y', 'lnl', 'lnpri', 'aux')),
                         key, jnp.asarray(w), jnp.asarray(beta_new))
    noise, _ = replay_stage_noise(key, n, len(block), N_MOVES)
    ttbl, loglike = ttargets.resolve_target(tt, None, None, True)
    lnprior, batched = ttargets.make_unbounded_wrappers(
        tpriors.ParamSpace(block), loglike)
    got = tsmc._stage(shard_map(batched, ttbl, None, None, chunk), lnprior,
                      *(_t(jst[k]) for k in ('y', 'lnl', 'lnpri', 'aux')),
                      _t(w), beta_new, noise)
    for name, g, wnt in zip(('y', 'lnl', 'lnpri', 'aux'), got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert float(got[4]) == float(want[5])
    _, k_res = jax.random.split(key)
    np.testing.assert_array_equal(
        tsmc._systematic_resample(noise[0], _t(w), n).numpy(),
        np.asarray(jsmc._systematic_resample(k_res, jnp.asarray(w), n)))


def test_host_bookkeeping_bit_for_bit(monkeypatch):
    """A whole run on the Gaussian with the port's device work replaced by
    victor_tpu's (its compiled likelihood, prior and stage, its key, its
    map to the unbounded coordinates): the
    port's host loop — the d-beta bisection, log Z and its se, the ESS and
    acceptance records, the ladder — gives victor_tpu's result bit for
    bit."""
    kw = dict(n_particles=128, n_moves=3, seed=7, chunk=None)
    want = jsmc.run_smc(gauss_jax, BLOCK, **kw)
    jfns = last_cached(jsmc._SMC_CACHE)
    theta0, key = prior_draw(BLOCK, 7, 128)
    state = {'key': key}

    def wrappers(space, loglike):
        def batched(tbl, y):
            lnl, aux = jfns['init'](jnp.zeros(()), _j(y))
            return _t(lnl), _t(aux)
        return (lambda y: _t(jfns['lnprior'](_j(y)))), batched

    def stage(lnlike, lnprior, y, lnl, lnpri, aux, w, beta_new, noise):
        out = jfns['stage'](jnp.zeros(()), *map(_j, (y, lnl, lnpri, aux)),
                            state['key'], _j(w), jnp.asarray(beta_new))
        state['key'] = out[4]
        return tuple(map(_t, out[:4])) + (_t(out[5]),)

    inject_prior(monkeypatch, theta0)
    jspace = JParamSpace(BLOCK)
    monkeypatch.setattr(tpriors.ParamSpace, 'to_unbounded',
                        lambda self, th: _t(jspace.to_unbounded(_j(th))))
    monkeypatch.setattr(ttargets, 'make_unbounded_wrappers', wrappers)
    monkeypatch.setattr(tsmc, '_stage', stage)
    got = tsmc.run_smc(gauss_torch, BLOCK, device='cpu', **kw)
    for k in ('betas', 'ess', 'acceptance'):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    assert (got.logz, got.logz_se, got.logz_se_clt) == \
        (want.logz, want.logz_se, want.logz_se_clt)
    np.testing.assert_array_equal(got.aux, want.aux)
    # the particles go back through the port's map to the bounded space
    # (torch's exp against XLA's: the last bit)
    np.testing.assert_allclose(got.particles, want.particles, rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(got.log_prob, want.log_prob, rtol=1e-14)


# ---------------------------------------------------------------------------
# whole runs of the port alone: the analytic Gaussian of tests/test_smc.py
# ---------------------------------------------------------------------------

class TestGaussianEvidence:
    @pytest.fixture(scope='class')
    def result(self):
        return tsmc.run_smc(gauss_torch, BLOCK, n_particles=512, n_moves=5,
                            seed=1, chunk=None, device='cpu')

    def test_evidence_matches_analytic(self, result):
        # the normalised Gaussian's mass outside the box is ~1e-5, so
        # Z = 1 / (10 * 10)
        logz_true = -np.log(100.0)
        assert abs(result.logz - logz_true) < max(3 * result.logz_se, 0.15)

    def test_posterior_moments(self, result):
        np.testing.assert_allclose(result.particles.mean(axis=0), MU,
                                   atol=0.15)
        np.testing.assert_allclose(result.particles.std(axis=0),
                                   np.sqrt(np.diag(COV)), rtol=0.2)
        corr = np.corrcoef(result.particles.T)[0, 1]
        assert abs(corr - COV[0, 1] / np.sqrt(COV[0, 0] * COV[1, 1])) < 0.15

    def test_ladder_and_diagnostics(self, result):
        assert result.betas[0] == 0.0 and result.betas[-1] == 1.0
        assert np.all(np.diff(result.betas) > 0)
        assert np.all(result.ess > 0.2)
        assert np.all(result.acceptance > 0.05)
        assert result.logz_se == 3.0 * result.logz_se_clt


class TestCheckpointResume:
    KW = dict(n_particles=128, n_moves=3, seed=7, chunk=None, device='cpu')

    def test_interrupted_run_resumes_bit_identically(self, tmp_path):
        """Stopped after 2 stages and resumed from the checkpoint: the
        particles, evidence and ladder equal an uninterrupted run's; a
        resume of the finished run returns the stored state."""
        ckpt = str(tmp_path / 'smc.npz')
        full = tsmc.run_smc(gauss_torch, BLOCK, **self.KW)
        with pytest.raises(RuntimeError):
            tsmc.run_smc(gauss_torch, BLOCK, max_stages=2, checkpoint=ckpt,
                         **self.KW)
        assert len(load(ckpt)['betas']) == 3
        for _ in range(2):
            resumed = tsmc.run_smc(gauss_torch, BLOCK, checkpoint=ckpt,
                                   resume=True, **self.KW)
            np.testing.assert_array_equal(resumed.particles, full.particles)
            np.testing.assert_array_equal(resumed.betas, full.betas)
            assert resumed.logz == full.logz
            assert not os.path.exists(ckpt + '.tmp.npz')

    def test_victor_tpu_checkpoint_is_refused(self, tmp_path):
        """victor_tpu's checkpoint stores a JAX key, not a generator
        state: resuming it raises InputError rather than reading the key."""
        ckpt = str(tmp_path / 'jax.npz')
        with pytest.raises(RuntimeError):
            jsmc.run_smc(gauss_jax, BLOCK, n_particles=32, n_moves=1,
                         seed=2, chunk=None, max_stages=1, checkpoint=ckpt)
        with pytest.raises(InputError, match='victor_tpu'):
            tsmc.run_smc(gauss_torch, BLOCK, checkpoint=ckpt, resume=True,
                         **self.KW)


@pytest.mark.parametrize('which', ['gauss', 'boss'])
def test_export_names_the_aux_by_target(which, boss, tmp_path):
    """The GetDist export names the aux column chi2_ccf_correct for a
    bundle target and aux_0 for a callable one (decided from the target's
    type: the port's resolve_target returns no cache id)."""
    from victor_tpu_torch.sampling.chains import read_getdist
    _, tt, block, chunk, _ = targets(which, boss)
    root = str(tmp_path / 'smc')
    res = tsmc.run_smc(tt, block, n_particles=16, n_moves=1, seed=3,
                       chunk=chunk, output=root, device='cpu')
    names, w, mlnp, samples = read_getdist(root)
    assert names == list(block) + [
        'aux_0' if which == 'gauss' else 'chi2_ccf_correct']
    np.testing.assert_allclose(samples[:, :len(block)], res.particles,
                               rtol=1e-7)
    np.testing.assert_allclose(-mlnp, res.log_prob, rtol=1e-7)


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsmc.run_smc(gauss_torch, BLOCK, n_particles=16)

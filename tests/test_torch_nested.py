"""The port's nested sampler (`sampling/nested.py`) against victor_tpu's.

As in test_torch_smc.py: the port's step takes its noise as arguments and is
fed victor_tpu's key splits (`split(key, n_steps + 1)`, then `k1, k2 =
split(k)` per move); victor_tpu's compiled step is taken from its function
cache after a short run. The host side (the stable argsort, the start-point
draws of np.random.default_rng((seed, 777, it)), the evidence bookkeeping in
f64, the final resample of np.random.default_rng((seed, 999))) is held bit
for bit by a whole run in which the port's device steps are victor_tpu's.
BOSS runs at a narrow width (n_mu 20, n_v 10); everything is float64 on the
CPU with one thread.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victor_tpu.sampling import nested as jnested
from victor_tpu.sampling import targets as jtargets
from victor_tpu.sampling.priors import ParamSpace as JParamSpace
from victor_tpu_torch.errors import InputError
from victor_tpu_torch.parallel.mesh import shard_map
from victor_tpu_torch.sampling import nested as tnested
from victor_tpu_torch.sampling import priors as tpriors
from victor_tpu_torch.sampling import targets as ttargets

from test_torch_smc import (BLOCK, COV, MU, RUN_TOL, TOL, _j, _t,  # noqa: F401
                            boss, gauss_jax, gauss_torch, inject_prior,
                            last_cached, load, prior_draw, targets)

torch.set_num_threads(1)

# (n_live, n_batch, n_steps) of the short runs
SHORT = {'gauss': (64, 16, 3), 'boss': (32, 8, 2)}


def replay_step_noise(key, n_batch, d, n_steps):
    """victor_tpu's draws of one iteration from `key` (nested.py:190-230):
    the port's (eps (n_steps, n_batch, d), u (n_steps, n_batch)) and the
    next key."""
    keys = jax.random.split(key, n_steps + 1)
    eps, u = [], []
    for k in keys[1:]:
        k1, k2 = jax.random.split(k)
        eps.append(jax.random.normal(k1, (n_batch, d)))
        u.append(jax.random.uniform(k2, (n_batch,)))
    return (_t(np.stack(eps)), _t(np.stack(u))), keys[0]


@pytest.fixture(scope='module', params=['gauss', 'boss'])
def short_runs(request, boss, tmp_path_factory):
    """victor_tpu's and the port's first three iterations from the same
    prior draw, the port given victor_tpu's noise (`max_iter=3` raises
    after saving the checkpoint). Returns the case, the two checkpoints and
    victor_tpu's compiled functions."""
    which = request.param
    jt, tt, block, chunk, _ = targets(which, boss)
    n_live, n_batch, n_steps = SHORT[which]
    tmp = tmp_path_factory.mktemp(f'ns_{which}')
    kw = dict(n_live=n_live, n_batch=n_batch, n_steps=n_steps, seed=5,
              chunk=chunk, max_iter=3)
    with pytest.raises(RuntimeError, match='did not terminate'):
        jnested.run_nested(jt, block, checkpoint=str(tmp / 'j.npz'), **kw)
    jfns = last_cached(jnested._NS_CACHE)
    theta0, key = prior_draw(block, 5, n_live)
    noise = []
    for _ in range(3):
        step, key = replay_step_noise(key, n_batch, len(block), n_steps)
        noise.append(step)
    with pytest.MonkeyPatch.context() as mp:
        inject_prior(mp, theta0)
        mp.setattr(tnested, 'draw_step_noise', lambda *a: noise.pop(0))
        with pytest.raises(RuntimeError, match='did not terminate'):
            tnested.run_nested(tt, block, checkpoint=str(tmp / 't.npz'),
                               device='cpu', **kw)
    assert not noise
    return which, load(tmp / 'j.npz'), load(tmp / 't.npz'), jfns


def test_short_run_matches_victor_tpu(short_runs):
    """Three iterations: the live points, the dead records, the volume, log
    Z, the proposal scale and the acceptance within 1e-10; the counters
    equal."""
    which, jst, tst, _ = short_runs
    for k in ('it', 'n_like', 'n_batch', 'n_steps', 'seed'):
        assert int(tst[k]) == int(jst[k]), k
    assert int(tst['it']) == 3
    for k in ('y', 'lnl', 'lnpri', 'aux', 'lnx', 'logz', 'scale', 'dead_y',
              'dead_lnl', 'dead_lnwt', 'dead_aux', 'acc_hist', 'moved_hist'):
        np.testing.assert_allclose(tst[k], jst[k], rtol=RUN_TOL,
                                   atol=RUN_TOL, err_msg=k)


def test_step_matches_victor_tpu(short_runs, boss):
    """The fourth iteration from victor_tpu's state after three: the port's
    `_step` with victor_tpu's noise against victor_tpu's compiled step —
    the live set within 1e-12, the dead records identical, the acceptance
    and moved share identical."""
    which, jst, _, jfns = short_runs
    jt, tt, block, chunk, _ = targets(which, boss)
    n_live, n_batch, n_steps = SHORT[which]
    lnl_h = np.where(np.isfinite(jst['lnl']), jst['lnl'], -1e300)
    order = np.argsort(lnl_h, kind='stable')
    dead_idx, survivors = order[:n_batch], order[n_batch:]
    threshold = lnl_h[dead_idx[-1]]
    valid = survivors[lnl_h[survivors] > threshold]
    start_idx = valid[np.random.default_rng((5, 777, 3)).integers(
        0, len(valid), n_batch)]
    w = np.zeros(n_live)
    w[survivors] = 1.0 / len(survivors)
    scale = float(jst['scale'])
    key = jnp.asarray(jst['key'])
    jtbl = jtargets.resolve_target(jt, None, None, True)[0]
    want = jfns['step'](jtbl, *(jnp.asarray(jst[k]) for k in
                                ('y', 'lnl', 'lnpri', 'aux')),
                        jnp.asarray(w), key,
                        jnp.asarray(start_idx, dtype=jnp.int32),
                        jnp.asarray(dead_idx, dtype=jnp.int32),
                        jnp.asarray(threshold), jnp.asarray(scale))
    noise, _ = replay_step_noise(key, n_batch, len(block), n_steps)
    ttbl, loglike = ttargets.resolve_target(tt, None, None, True)
    lnprior, batched = ttargets.make_unbounded_wrappers(
        tpriors.ParamSpace(block), loglike)
    got = tnested._step(shard_map(batched, ttbl, None, None, chunk), lnprior,
                        *(_t(jst[k]) for k in ('y', 'lnl', 'lnpri', 'aux')),
                        _t(w), _t(start_idx), _t(dead_idx), float(threshold),
                        scale, noise)
    for name, g, wnt in zip(('y', 'lnl', 'lnpri', 'aux'), got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert (float(got[4]), float(got[5])) == (float(want[5]), float(want[6]))
    for g, wnt in zip(got[6:], want[7:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_host_bookkeeping_bit_for_bit(monkeypatch):
    """A whole run on the Gaussian with the port's device work replaced by
    victor_tpu's (its compiled likelihood, prior and step, its key, its map
    to the unbounded coordinates): the port's host side — the argsort, the
    start draws, the evidence bookkeeping, the information and its error
    bar, the final resample — gives victor_tpu's result bit for bit."""
    kw = dict(n_live=128, n_batch=32, n_steps=6, seed=7, chunk=None)
    want = jnested.run_nested(gauss_jax, BLOCK, **kw)
    jfns = last_cached(jnested._NS_CACHE)
    theta0, key = prior_draw(BLOCK, 7, 128)
    state = {'key': key}

    def wrappers(space, loglike):
        def batched(tbl, y):
            lnl, aux = jfns['init'](jnp.zeros(()), _j(y))
            return _t(lnl), _t(aux)
        return (lambda y: _t(jfns['lnprior'](_j(y)))), batched

    def step(lnlike, lnprior, y, lnl, lnpri, aux, w, start_idx, dead_idx,
             threshold, scale, noise):
        out = jfns['step'](jnp.zeros(()), *map(_j, (y, lnl, lnpri, aux, w)),
                           state['key'], _j(start_idx).astype(jnp.int32),
                           _j(dead_idx).astype(jnp.int32),
                           jnp.asarray(threshold), jnp.asarray(scale))
        state['key'] = out[4]
        return tuple(map(_t, out[:4] + out[5:]))

    inject_prior(monkeypatch, theta0)
    jspace = JParamSpace(BLOCK)
    monkeypatch.setattr(tpriors.ParamSpace, 'to_unbounded',
                        lambda self, th: _t(jspace.to_unbounded(_j(th))))
    monkeypatch.setattr(ttargets, 'make_unbounded_wrappers', wrappers)
    monkeypatch.setattr(tnested, '_step', step)
    got = tnested.run_nested(gauss_torch, BLOCK, device='cpu', **kw)
    for k in ('logz', 'logz_se', 'h', 'n_live', 'n_iter', 'n_like', 'ess'):
        assert getattr(got, k) == getattr(want, k), k
    for k in ('points_logl', 'points_logwt', 'acceptance', 'aux'):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    # the particles go back through the port's map to the bounded space
    # (torch's exp against XLA's: the last bit)
    np.testing.assert_allclose(got.particles, want.particles, rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(got.log_prob, want.log_prob, rtol=1e-14)


# ---------------------------------------------------------------------------
# whole runs of the port alone: the analytic Gaussian of tests/test_nested.py
# ---------------------------------------------------------------------------

class TestGaussianEvidence:
    @pytest.fixture(scope='class')
    def result(self):
        return tnested.run_nested(gauss_torch, BLOCK, n_live=512,
                                  n_batch=128, n_steps=16, seed=1,
                                  chunk=None, device='cpu')

    def test_evidence_matches_analytic(self, result):
        logz_true = -np.log(100.0)
        assert abs(result.logz - logz_true) < max(3 * result.logz_se, 0.15)

    def test_posterior_moments(self, result):
        np.testing.assert_allclose(result.particles.mean(axis=0), MU,
                                   atol=0.15)
        np.testing.assert_allclose(result.particles.std(axis=0),
                                   np.sqrt(np.diag(COV)), rtol=0.2)
        corr = np.corrcoef(result.particles.T)[0, 1]
        assert abs(corr - COV[0, 1] / np.sqrt(COV[0, 0] * COV[1, 1])) < 0.15

    def test_run_diagnostics(self, result):
        assert result.n_iter > 0
        assert result.n_like == 512 + result.n_iter * 128 * 16
        wn = np.exp(result.points_logwt - result.logz)
        assert abs(wn.sum() - 1.0) < 1e-6
        assert result.ess > 100
        assert np.all(result.acceptance > 0.05)
        assert result.h > 0

    def test_information_matches_analytic(self, result):
        # H = E_post[ln L] - ln Z; E[ln L] = -ln(2 pi) - 0.5 ln|C| - 1
        h_true = (-np.log(2 * np.pi) - 0.5 * np.log(np.linalg.det(COV))
                  - 1.0) + np.log(100.0)
        assert abs(result.h - h_true) < 0.3


class TestValidation:
    def test_rejects_bad_batch_and_steps(self):
        with pytest.raises(ValueError, match='n_batch'):
            tnested.run_nested(gauss_torch, BLOCK, n_live=64, n_batch=40,
                               device='cpu')
        with pytest.raises(ValueError, match='n_steps'):
            tnested.run_nested(gauss_torch, BLOCK, n_live=64, n_batch=16,
                               n_steps=0, device='cpu')
        with pytest.raises(ValueError, match='checkpoint_every'):
            tnested.run_nested(gauss_torch, BLOCK, n_live=64, n_batch=16,
                               checkpoint_every=0, device='cpu')

    def test_max_iter_raises_after_saving(self, tmp_path):
        """max_iter raises, and the checkpoint holds the state it stopped
        at whatever the cadence."""
        ckpt = str(tmp_path / 'ns.npz')
        with pytest.raises(RuntimeError, match='did not terminate'):
            tnested.run_nested(gauss_torch, BLOCK, n_live=128, n_batch=32,
                               n_steps=4, seed=3, chunk=None, max_iter=2,
                               checkpoint=ckpt, checkpoint_every=5,
                               device='cpu')
        assert int(load(ckpt)['it']) == 2

    def test_plateau_warns(self, caplog):
        """A constant likelihood ties every survivor at the threshold: the
        plateau fallback (chains seeded AT L*) is loud, and Z = 1."""
        def flat(params):
            zero = torch.zeros_like(params['x'])
            return zero, zero

        with caplog.at_level(logging.WARNING, logger='victor_tpu_torch'):
            res = tnested.run_nested(flat, BLOCK, n_live=64, n_batch=16,
                                     n_steps=2, seed=0, chunk=None,
                                     dlogz=0.5, device='cpu')
        assert any('plateau' in r.getMessage() for r in caplog.records)
        assert abs(res.logz) < 0.2


class TestCheckpointResume:
    KW = dict(n_live=128, n_batch=32, n_steps=6, seed=7, chunk=None,
              device='cpu')

    @pytest.fixture(scope='class')
    def full(self):
        return tnested.run_nested(gauss_torch, BLOCK, **self.KW)

    @pytest.mark.parametrize('every', [1, 3])
    def test_interrupted_run_resumes_bit_identically(self, full, tmp_path,
                                                     every):
        """Stopped by max_iter=4 and resumed (checkpoint_every 1 and 3: the
        max_iter path saves whatever the cadence): the particles, evidence,
        weights and eval count equal an uninterrupted run's; a resume of the
        finished run replays it; a resume with other n_live, n_batch,
        n_steps and seed keeps the checkpoint's."""
        ckpt = str(tmp_path / 'ns.npz')
        with pytest.raises(RuntimeError):
            tnested.run_nested(gauss_torch, BLOCK, max_iter=4,
                               checkpoint=ckpt, checkpoint_every=every,
                               **self.KW)
        assert int(load(ckpt)['it']) == 4
        other = dict(self.KW, n_live=1024, n_batch=None, n_steps=24, seed=99)
        for kw in (self.KW, self.KW, other):
            res = tnested.run_nested(gauss_torch, BLOCK, checkpoint=ckpt,
                                     resume=True, checkpoint_every=every,
                                     **kw)
            np.testing.assert_array_equal(res.particles, full.particles)
            np.testing.assert_array_equal(res.points_logwt,
                                          full.points_logwt)
            assert (res.logz, res.n_like) == (full.logz, full.n_like)

    def test_victor_tpu_checkpoint_is_refused(self, tmp_path):
        ckpt = str(tmp_path / 'jax.npz')
        with pytest.raises(RuntimeError):
            jnested.run_nested(gauss_jax, BLOCK, n_live=64, n_batch=16,
                               n_steps=2, seed=2, chunk=None, max_iter=1,
                               checkpoint=ckpt)
        with pytest.raises(InputError, match='victor_tpu'):
            tnested.run_nested(gauss_torch, BLOCK, checkpoint=ckpt,
                               resume=True, **self.KW)


@pytest.mark.parametrize('which', ['gauss', 'boss'])
def test_export_names_the_aux_by_target(which, boss, tmp_path):
    """chi2_ccf_correct for a bundle target, aux_0 for a callable one."""
    from victor_tpu_torch.sampling.chains import read_getdist
    _, tt, block, chunk, _ = targets(which, boss)
    root = str(tmp_path / 'ns')
    res = tnested.run_nested(tt, block, n_live=16, n_batch=4, n_steps=1,
                             dlogz=0.5, seed=3, chunk=chunk, output=root,
                             device='cpu')
    names, w, mlnp, samples = read_getdist(root)
    assert names == list(block) + [
        'aux_0' if which == 'gauss' else 'chi2_ccf_correct']
    assert len(w) == 1024 and os.path.isfile(root + '.1.txt')
    np.testing.assert_allclose(samples[:, :len(block)], res.particles,
                               rtol=1e-7)


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnested.run_nested(gauss_torch, BLOCK, n_live=16)

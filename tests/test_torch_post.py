"""The port's importance reweighting (`sampling/post.py`) and tension
statistics (`sampling/tension.py`) against victor_tpu's.

`reweight` is deterministic given its draws, so it is held to victor_tpu's
on the same fixed theta set (BOSS at a narrow width, n_mu 20, n_v 10, a
change of the likelihood form), and on the analytic Gaussian cases of
tests/test_post.py. `parameter_shift` is copied host numpy; `run_tension`
is held to the closed-form two-Gaussian evidence ratio of
tests/test_tension.py. Also recomputes the per-point deltas that
chip_smoke.py holds the card's `reweight` to (POST_GOLDENS), at full width.
Everything is float64 on the CPU with one thread.
"""

import ast
import os

import numpy as np
import pytest
import torch

from victor_tpu.errors import InputError as JInputError
from victor_tpu.sampling import post as jpost
from victor_tpu.sampling import tension as jtension
from victor_tpu_torch.errors import InputError
from victor_tpu_torch.sampling import post as tpost
from victor_tpu_torch.sampling import tension as ttension

from test_torch_smc import BOSS_BLOCK, REPO, boss, boss_config  # noqa: F401

torch.set_num_threads(1)

MU = np.array([0.5, -0.3])
COV = np.array([[0.04, 0.012], [0.012, 0.09]])
BLOCK = {'x': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}},
         'y': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}}}


def gauss_target(mu, cov, offset=0.0):
    """A normalised Gaussian (+ offset) over the port's batch axis, with
    chi2 as its aux."""
    icov = torch.as_tensor(np.linalg.inv(cov))
    lognorm = float(-np.log(2 * np.pi) - 0.5 * np.log(np.linalg.det(cov))
                    + offset)

    def loglike(params):
        d = torch.stack([params['x'] - mu[0], params['y'] - mu[1]], -1)
        chi2 = torch.einsum('bi,ij,bj->b', d, icov, d)
        return lognorm - 0.5 * chi2, chi2
    return loglike


def draws(mu, cov, n, seed=0):
    return np.random.default_rng(seed).multivariate_normal(mu, cov, size=n)


def reweight(*args, **kw):
    return tpost.reweight(*args, device='cpu', **kw)


# ---------------------------------------------------------------------------
# against victor_tpu on BOSS
# ---------------------------------------------------------------------------

def boss_theta(n, seed, mean, std, block):
    """n points drawn uniformly from mean +- 3 std, cut to the block's
    prior box (NAMES order)."""
    names = list(block)
    lo = np.array([max(mean[k] - 3 * std[k], block[k]['prior']['min'])
                   for k in names])
    hi = np.array([min(mean[k] + 3 * std[k], block[k]['prior']['max'])
                   for k in names])
    return np.random.default_rng(seed).uniform(lo, hi, (n, len(names)))


QUAD_MEAN = {'fsigma8': 0.573, 'beta': 0.3667, 'sigma_v': 418.0,
             'epsilon': 1.0089}
QUAD_STD = {'fsigma8': 0.054, 'beta': 0.011, 'sigma_v': 44.0,
            'epsilon': 0.011}


@pytest.mark.parametrize('weighted', [False, True])
def test_reweight_matches_victor_tpu(boss, weighted, tmp_path):
    """A form change (sellentin -> gaussian) at 48 fixed points, one outside
    the prior (dropped), with and without input weights: the per-point
    log-likelihoods and log-weight deltas, the weights, Delta ln Z and its
    se, the ESS and the weighted moments within 1e-9 of victor_tpu's; the
    GetDist export carries the weights."""
    from victor_tpu_torch.sampling.chains import read_getdist
    theta = boss_theta(48, 4, QUAD_MEAN, QUAD_STD, BOSS_BLOCK)
    theta[7, 2] = 520.0
    w = np.random.default_rng(1).uniform(0.5, 2.0, 48) if weighted else None
    kw = dict(weights=w, fit_kw_new={'form': 'gaussian'}, chunk=16)
    want = jpost.reweight(boss[0], boss[0], BOSS_BLOCK, theta, **kw)
    root = str(tmp_path / 'post')
    got = reweight(boss[1], boss[1], BOSS_BLOCK, theta, output=root, **kw)
    for k in ('lnl_old', 'lnl_new', 'log_prob', 'aux', 'weights'):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-9, atol=1e-9, err_msg=k)
    # the log-weight deltas (one prior: lnL_new - lnL_old)
    np.testing.assert_allclose(got.lnl_new - got.lnl_old,
                               want.lnl_new - want.lnl_old, rtol=0, atol=1e-9)
    assert got.weights[7] == want.weights[7] == 0.0
    for k in ('delta_logz', 'delta_logz_se', 'ess', 'efficiency'):
        assert abs(getattr(got, k) - getattr(want, k)) < 1e-9, k
    gs, ws = got.summary(), want.summary()
    for name in BOSS_BLOCK:
        for m in ('mean', 'std'):
            assert abs(gs[name][m] - ws[name][m]) < 1e-9 * max(
                1.0, abs(ws[name][m])), (name, m)
    names, wts, _, samples = read_getdist(root)
    assert names == list(BOSS_BLOCK) + ['chi2_ccf_correct']
    np.testing.assert_allclose(wts, got.weights, rtol=1e-7, atol=1e-12)


def test_chip_smoke_post_goldens_match_victor_tpu():
    """chip_smoke.py holds the card's reweight of POST_N points (drawn as
    `boss_theta` draws them from QUAD_MEAN +- 3 QUAD_STD inside QUAD_BLOCK,
    seed POST_SEED) from the BOSS config's sellentin form to the gaussian
    one to victor_tpu's per-point deltas lnL_new - lnL_old at full width
    (POST_GOLDENS); this recomputes them and compares with the literals."""
    import copy

    from victor_tpu.io import build_tables
    tree = ast.parse(open(os.path.join(REPO, 'chip_smoke.py')).read())
    lit = {t.id: ast.literal_eval(node.value) for node in tree.body
           if isinstance(node, ast.Assign) for t in node.targets
           if isinstance(t, ast.Name) and t.id in (
               'POST_GOLDENS', 'POST_SEED', 'POST_N', 'QUAD_BLOCK',
               'QUAD_MEAN', 'QUAD_STD')}
    assert (lit['QUAD_MEAN'], lit['QUAD_STD']) == (QUAD_MEAN, QUAD_STD)
    cfg = boss_config()
    jb = build_tables(copy.deepcopy(cfg['model']), copy.deepcopy(cfg['data']))
    theta = boss_theta(lit['POST_N'], lit['POST_SEED'], QUAD_MEAN, QUAD_STD,
                       lit['QUAD_BLOCK'])
    res = jpost.reweight(jb, jb, lit['QUAD_BLOCK'], theta,
                         fit_kw_new={'form': 'gaussian'})
    assert np.isfinite(res.lnl_old).all() and res.efficiency > 0.5
    np.testing.assert_allclose(res.lnl_new - res.lnl_old,
                               lit['POST_GOLDENS'], rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the analytic cases of tests/test_post.py
# ---------------------------------------------------------------------------

class TestAnalytic:
    def test_constant_offset_is_exact(self):
        """new = old * e^c: weights unchanged, Delta lnZ = c, se = 0."""
        res = reweight(gauss_target(MU, COV),
                       gauss_target(MU, COV, offset=1.7), BLOCK,
                       draws(MU, COV, 512))
        assert abs(res.delta_logz - 1.7) < 1e-9
        assert res.delta_logz_se < 1e-9
        np.testing.assert_allclose(res.weights, 1.0, atol=1e-12)
        assert abs(res.ess - 512) < 1e-6
        assert res.efficiency == pytest.approx(1.0)

    def test_shifted_target_moments(self):
        mu2 = MU + np.array([0.2, 0.0])
        res = reweight(gauss_target(MU, COV), gauss_target(mu2, COV), BLOCK,
                       draws(MU, COV, 8192))
        m = res.summary()
        assert abs(m['x']['mean'] - mu2[0]) < 0.015
        assert abs(m['y']['mean'] - mu2[1]) < 0.02
        assert abs(m['x']['std'] - 0.2) < 0.015
        assert abs(res.delta_logz) < max(4 * res.delta_logz_se, 0.02)
        assert 0.2 * res.n < res.ess < 0.95 * res.n

    def test_prior_change_enters_weights(self):
        block_new = {k: {'prior': {'dist': 'uniform', 'min': -4.0,
                                   'max': 4.0}} for k in ('x', 'y')}
        target = gauss_target(MU, COV)
        res = reweight(target, target, BLOCK, draws(MU, COV, 512),
                       params_block_new=block_new)
        assert res.delta_logz == pytest.approx(np.log(100.0 / 64.0),
                                               abs=1e-9)
        assert res.delta_logz_se < 1e-9

    def test_zero_old_density_particle_dropped(self):
        theta = np.vstack([draws(MU, COV, 64), [[7.0, 0.0]]])
        res = reweight(gauss_target(MU, COV),
                       gauss_target(MU, COV, offset=0.3), BLOCK, theta)
        assert res.weights[-1] == 0.0
        assert res.delta_logz == pytest.approx(0.3, abs=1e-9)

    @pytest.mark.parametrize('case', ['names', 'disjoint', 'shape',
                                      'weights'])
    def test_bad_input_raises(self, case):
        """A changed sampled block, targets that do not overlap, a theta of
        the wrong shape and negative weights raise InputError, as in
        victor_tpu."""
        kw = {}
        theta = draws(MU, COV, 16)
        if case == 'names':
            kw['params_block_new'] = {'x': BLOCK['x'], 'z': BLOCK['y']}
        elif case == 'disjoint':
            kw['params_block_new'] = {k: {'prior': {
                'dist': 'uniform', 'min': 3.0, 'max': 5.0}} for k in 'xy'}
        elif case == 'shape':
            theta = theta[:, :1]
        else:
            kw['weights'] = -np.ones(16)
        jtarget = lambda p: (0.0 * p['x'], 0.0 * p['x'])   # noqa: E731
        with pytest.raises(JInputError):
            jpost.reweight(jtarget, jtarget, BLOCK, theta, **kw)
        target = gauss_target(MU, COV)
        with pytest.raises(InputError, match='reweight'):
            reweight(target, target, BLOCK, theta, **kw)


# ---------------------------------------------------------------------------
# tension
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['identity', 'correlated', 'single',
                                  'rank_deficient'])
def test_parameter_shift_matches_victor_tpu(case):
    """chi2, dof (the rank), p and n-sigma within 1e-12 of victor_tpu's,
    including a single shared parameter (np.cov's 0-d result) and a
    rank-deficient combined covariance."""
    rng = np.random.default_rng(2)
    if case == 'identity':
        args = ([0.2, 0.0], np.diag([0.04, 0.09]), [0.0, 0.0],
                np.diag([0.04, 0.09]))
    elif case == 'correlated':
        a, b = rng.standard_normal((300, 3)), rng.standard_normal((300, 3))
        a[:, 1] += 0.5 * a[:, 0]
        args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0) + 0.1,
                np.cov(b, rowvar=False))
    elif case == 'single':
        pa = rng.standard_normal((400, 1)) * 0.1
        pb = rng.standard_normal((400, 1)) * 0.1 + 0.3
        args = (pa.mean(0), np.cov(pa, rowvar=False), pb.mean(0),
                np.cov(pb, rowvar=False))
    else:
        c = np.array([[0.04, 0.04], [0.04, 0.04]])
        args = ([0.2, 0.2], c, [0.0, 0.0], c)
    got = ttension.parameter_shift(*args)
    want = jtension.parameter_shift(*args)
    assert got[1] == want[1] == {'identity': 2, 'correlated': 3, 'single': 1,
                                 'rank_deficient': 1}[case]
    np.testing.assert_allclose([got[0], got[2], got[3]],
                               [want[0], want[2], want[3]], rtol=1e-12)


SIG2 = 0.04
V = 100.0


def gauss_like(mu):
    def loglike(params):
        chi2 = ((params['x'] - mu[0]) ** 2 + (params['y'] - mu[1]) ** 2) / SIG2
        return -np.log(2 * np.pi * SIG2) - 0.5 * chi2, chi2
    return loglike


def analytic_logr(mu_a, mu_b):
    d = np.asarray(mu_a) - np.asarray(mu_b)
    csum = 2 * SIG2
    return np.log(V) - np.log(2 * np.pi * csum) - 0.5 * (d ** 2).sum() / csum


class TestAnalyticTension:
    def test_concordant_datasets(self):
        res = ttension.run_tension(gauss_like([0.5, -0.3]),
                                   gauss_like([0.5, -0.3]), BLOCK,
                                   n_particles=2048, n_moves=6, seed=0,
                                   chunk=None, device='cpu')
        truth = analytic_logr([0.5, -0.3], [0.5, -0.3])
        assert truth > 0 and res.logr > 0
        assert abs(res.logr - truth) < max(4 * res.logr_se, 0.5)
        assert res.shift_nsigma < 3.0 and res.shift_p > 0.01

    def test_shifted_datasets(self):
        mu_a, mu_b = [0.0, 0.0], [1.0, 0.0]
        res = ttension.run_tension(gauss_like(mu_a), gauss_like(mu_b), BLOCK,
                                   n_particles=2048, n_moves=6, seed=1,
                                   chunk=None, device='cpu')
        truth = analytic_logr(mu_a, mu_b)
        assert truth < 0
        assert abs(res.logr - truth) < max(4 * res.logr_se, 0.5)
        assert 2.5 < res.shift_nsigma < 4.5
        assert 0.3 < res.summary_ab['x']['mean'] < 0.7
        assert res.names == ['x', 'y']


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    target = gauss_target(MU, COV)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpost.reweight(target, target, BLOCK, draws(MU, COV, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttension.run_tension(target, target, BLOCK, n_particles=16)


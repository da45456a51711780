"""The port's ParamSpace against victor_tpu's: priors, the unbounded
reparameterisation, proposal widths, derived lambdas, draws and errors.

Both packages parse the same params blocks; seeded numpy points (inside the
support, outside it and on its edges) go through both, in float64 at 1e-14
with the -inf positions equal. Draws come from different generators (JAX
keys, a torch.Generator), so they are held by their moments and clipping.
"""

import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from victor_tpu.errors import InputError as JInputError
from victor_tpu.sampling.priors import ParamSpace as JSpace
from victor_tpu_torch.errors import InputError
from victor_tpu_torch.sampling.priors import ParamSpace as TSpace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def config_params(name):
    with open(f'{REPO}/configs/{name}') as f:
        return yaml.safe_load(f)['params']


BLOCK_4P = {   # tests/test_optimize.py:13-22
    'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
             'ref': {'dist': 'norm', 'loc': 0.4, 'scale': 0.03}},
    'sigma_v': {'prior': {'dist': 'uniform', 'min': 150.0, 'max': 700.0},
                'ref': {'dist': 'norm', 'loc': 380.0, 'scale': 30.0}},
    'epsilon': {'prior': {'dist': 'uniform', 'min': 0.8, 'max': 1.2},
                'ref': {'dist': 'norm', 'loc': 1.0, 'scale': 0.02}},
}
MIXED = {
    'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05},
                'proposal': 0.02, 'latex': r'f\sigma_8'},
    'amp': {'prior': {'dist': 'loguniform', 'min': 1e-3, 'max': 10.0},
            'ref': {'dist': 'loguniform', 'min': 0.1, 'max': 1.0},
            'proposal': 0.05},
    'sig': {'prior': {'dist': 'halfnorm', 'loc': 2.0, 'scale': 3.0},
            'ref': {'dist': 'halfnorm', 'loc': 2.0, 'scale': 0.5},
            'proposal': 0.4},
    'epsilon': {'prior': {'dist': 'norm', 'loc': 1.0, 'scale': 0.05},
                'ref': 1.0, 'proposal': 0.01},
    'b': 1.9,
    'alpha': 1,
    'scipy_lu': {'prior': {'dist': 'loguniform', 'a': 0.5, 'b': 2.0},
                 'ref': {'loc': 1.0, 'scale': 0.1}},
    'aperp': {'value': 'lambda alpha, epsilon: alpha * epsilon**(1/3)'},
    'mix': {'value': 'lambda fsigma8, amp, sig: np.sqrt(fsigma8) '
                     '+ jnp.log10(amp) * np.exp(-sig / 10) '
                     '+ np.minimum(amp, 1.0) + math.pi'},
    'fixed_v': {'value': 0.25},
    'chi2': {'derived': True},
}
BLOCKS = {
    'boss_sampling_config': config_params('boss_sampling_config.yaml'),
    'esm_sampling_config': config_params('esm_sampling_config.yaml'),
    'BLOCK_4P': BLOCK_4P,
    'mixed': MIXED,
}


def theta_points(space, n=64, seed=0):
    """Seeded points: inside the support, outside it, and on its edges."""
    rng = np.random.default_rng(seed)
    cols = []
    for p in space.sampled:
        if p.dist == 'uniform':
            w = p.hi - p.lo
            col = rng.uniform(p.lo - 0.1 * w, p.hi + 0.1 * w, n)
            col[:4] = [p.lo, p.hi, p.lo + 1e-13 * w, p.hi - 1e-13 * w]
        elif p.dist == 'loguniform':
            col = np.exp(rng.uniform(math.log(p.lo / 2), math.log(2 * p.hi),
                                     n))
            col[:4] = [p.lo, p.hi, p.lo * (1 + 1e-13), p.hi * (1 - 1e-13)]
        elif p.dist == 'halfnorm':
            col = p.lo + p.hi * rng.normal(size=n)
            col[:2] = [p.lo, p.lo + 1e-300]
        else:
            col = p.lo + 3 * p.hi * rng.normal(size=n)
        cols.append(col)
    return np.stack(cols, axis=-1)


def y_points(space, n=64, seed=1):
    y = np.random.default_rng(seed).normal(scale=3.0, size=(n, space.ndim))
    y[:3] = [[-30.0] * space.ndim, [30.0] * space.ndim, [0.0] * space.ndim]
    return y


def close(got, want, tol=1e-14):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize('name', list(BLOCKS))
class TestParity:
    def test_structure(self, name):
        js, ts = JSpace(BLOCKS[name]), TSpace(BLOCKS[name])
        assert [dataclasses.asdict(p) for p in ts.sampled] == \
            [dataclasses.asdict(p) for p in js.sampled]
        assert ts.fixed == js.fixed
        assert [(d.name, d.argnames, d.latex, d.src) for d in ts.derived] == \
            [(d.name, d.argnames, d.latex, d.src) for d in js.derived]
        for a, b in zip(ts.bounds(), js.bounds()):
            np.testing.assert_array_equal(a, b)

    def test_log_prior_and_transforms(self, name):
        js, ts = JSpace(BLOCKS[name]), TSpace(BLOCKS[name])
        theta = theta_points(js)
        lp = ts.log_prior(torch.as_tensor(theta))
        close(lp, js.log_prior(jnp.asarray(theta)))
        assert np.isneginf(lp.numpy()).any() == \
            any(p.dist != 'norm' for p in js.sampled)
        inside = np.isfinite(lp.numpy())
        close(ts.to_unbounded(torch.as_tensor(theta[inside])),
              js.to_unbounded(jnp.asarray(theta[inside])))
        y = y_points(js)
        for fn in ('to_bounded', 'log_jacobian', 'dtheta_dy_diag',
                   'proposal_scales_unbounded'):
            close(getattr(ts, fn)(torch.as_tensor(y)),
                  getattr(js, fn)(jnp.asarray(y)))
        # one point, no batch axis
        close(ts.log_prior(torch.as_tensor(theta[5])),
              js.log_prior(jnp.asarray(theta[5])))

    def test_full_params(self, name):
        js, ts = JSpace(BLOCKS[name]), TSpace(BLOCKS[name])
        theta = theta_points(js)
        theta = theta[np.isfinite(np.asarray(js.log_prior(
            jnp.asarray(theta))))]
        got = ts.full_params(torch.as_tensor(theta))
        want = js.full_params(jnp.asarray(theta))
        assert set(got) == set(want)
        for k in want:
            close(got[k], np.broadcast_to(np.asarray(want[k]), got[k].shape))
        got_d = ts.derived_values(torch.as_tensor(theta))
        assert set(got_d) == {d.name for d in js.derived}


def test_edges_finite_in_f32():
    """numpy's finfo.epsneg in f32 is 2**-24: a draw at the support edge
    maps to a finite y, as in victor_tpu's f32 path."""
    block = {'u': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 1.0}},
             'lg': {'prior': {'dist': 'loguniform', 'min': 1e-3, 'max': 10.0}},
             'hn': {'prior': {'dist': 'halfnorm', 'loc': 0.0, 'scale': 1.0}}}
    edges = np.array([[0.0, 1e-3, 0.0], [1.0, 10.0, 5.0]], dtype=np.float32)
    got = TSpace(block).to_unbounded(torch.as_tensor(edges))
    want = np.asarray(JSpace(block).to_unbounded(jnp.asarray(edges)))
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert torch.finfo(torch.float64).eps / 2 == np.finfo(np.float64).epsneg
    assert torch.finfo(torch.float32).eps / 2 == np.finfo(np.float32).epsneg


class TestDraws:
    N = 20000

    def gen(self, seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return g

    def test_sample_ref_moments_and_clipping(self):
        ts = TSpace(MIXED)
        draws = ts.sample_ref(self.gen(0), self.N).numpy()
        assert draws.shape == (self.N, ts.ndim) and draws.dtype == np.float64
        lo, hi = ts.bounds()
        for i, p in enumerate(ts.sampled):
            col = draws[:, i]
            if p.dist in ('uniform', 'loguniform'):
                w = p.hi - p.lo
                assert col.min() >= p.lo + 1e-6 * w - 1e-15
                assert col.max() <= p.hi - 1e-6 * w + 1e-15
            if p.ref_dist == 'norm':
                mean, std = p.ref_loc, p.ref_scale
            elif p.ref_dist == 'halfnorm':
                mean = p.ref_loc + p.ref_scale * math.sqrt(2 / math.pi)
                std = p.ref_scale * math.sqrt(1 - 2 / math.pi)
            elif p.ref_dist == 'loguniform':
                a, b = math.log(p.ref_lo), math.log(p.ref_hi)
                mean = (p.ref_hi - p.ref_lo) / (b - a)
                std = math.sqrt((p.ref_hi ** 2 - p.ref_lo ** 2) / (2 * (b - a))
                                - mean ** 2)
            m, s = col.mean(), col.std()
            assert abs(m - mean) < 5 * std / math.sqrt(self.N), p.name
            assert abs(s / std - 1) < 0.03, p.name
        # the scalar ref got the proposal width as its scatter (victor_tpu
        # parity of the parse) and the draws are spread
        assert ts.sampled[3].ref_scale == 0.01 and draws[:, 3].std() > 0

    def test_sample_ref_clips_into_support(self):
        block = {'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 1.0},
                       'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0}},
                 'h': {'prior': {'dist': 'halfnorm', 'loc': 1.0, 'scale': 2.0},
                       'ref': {'dist': 'norm', 'loc': 1.0, 'scale': 5.0}}}
        draws = TSpace(block).sample_ref(self.gen(1), 4000).numpy()
        assert draws[:, 0].min() == 1e-6 and draws[:, 0].max() == 1 - 1e-6
        assert draws[:, 1].min() == 1.0 + 2e-6
        assert (draws[:, 0] == 1e-6).mean() > 0.4

    def test_sample_prior_moments(self):
        ts = TSpace(MIXED)
        draws = ts.sample_prior(self.gen(2), self.N).numpy()
        for i, p in enumerate(ts.sampled):
            col = draws[:, i]
            if p.dist == 'uniform':
                mean, std = (p.lo + p.hi) / 2, (p.hi - p.lo) / math.sqrt(12)
                assert p.lo <= col.min() and col.max() <= p.hi
            elif p.dist == 'loguniform':
                a, b = math.log(p.lo), math.log(p.hi)
                mean = (p.hi - p.lo) / (b - a)
                std = math.sqrt((p.hi ** 2 - p.lo ** 2) / (2 * (b - a))
                                - mean ** 2)
            elif p.dist == 'halfnorm':
                mean = p.lo + p.hi * math.sqrt(2 / math.pi)
                std = p.hi * math.sqrt(1 - 2 / math.pi)
                assert col.min() >= p.lo
            else:
                mean, std = p.lo, p.hi
            assert abs(col.mean() - mean) < 5 * std / math.sqrt(self.N), p.name
            assert abs(col.std() / std - 1) < 0.05, p.name

    def test_draws_follow_the_generator(self):
        ts = TSpace(BLOCK_4P)
        a = ts.sample_ref(self.gen(5), 10)
        b = ts.sample_ref(self.gen(5), 10)
        assert torch.equal(a, b)
        assert not torch.equal(a, ts.sample_ref(self.gen(6), 10))


BAD_BLOCKS = [
    {'a': None},
    {'a': [1, 2]},
    {'a': {'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0}}},
    {'a': {'prior': {'dist': 'gamma', 'a': 2.0}}},
    {'a': {'prior': {'dist': 'loguniform', 'min': 0.0, 'max': 1.0}}},
    {'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 1.0},
           'ref': {'dist': 'beta', 'a': 2, 'b': 2}}},
    {'a': {'value': 'a * 2'}},
]


@pytest.mark.parametrize('block', BAD_BLOCKS)
def test_input_errors_match(block):
    with pytest.raises(JInputError) as want:
        JSpace(block)
    with pytest.raises(InputError) as got:
        TSpace(block)
    assert str(got.value) == str(want.value)


def test_lambda_outside_the_namespace_raises():
    """A derived lambda reaches np/jnp through a small namespace of torch
    functions; anything else raises InputError (victor_tpu reaches
    jnp.<name> and fails there or not at all)."""
    ts = TSpace({'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 1.0}},
                 'd': {'value': 'lambda a: np.linalg.norm(a)'}})
    with pytest.raises(InputError, match='np.linalg'):
        ts.full_params(torch.tensor([[0.5]], dtype=torch.float64))
    ts = TSpace({'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 1.0}},
                 'd': {'value': 'lambda a: np.where(a > 0.5, np.arctan2(a, '
                                '1.0), np.clip(a, 0.1, 0.2)) + np.e'}})
    js = JSpace({'a': {'prior': {'dist': 'uniform', 'min': 0.0, 'max': 1.0}},
                 'd': {'value': 'lambda a: np.where(a > 0.5, np.arctan2(a, '
                                '1.0), np.clip(a, 0.1, 0.2)) + np.e'}})
    theta = np.array([[0.05], [0.15], [0.7]])
    close(ts.full_params(torch.as_tensor(theta))['d'],
          js.full_params(jnp.asarray(theta))['d'])

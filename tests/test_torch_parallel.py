"""The port's scale-out layer against victor_tpu's: parallel/mesh.py, the
sharded likelihoods, `mesh=` through every sampler, the CLI's auto-mesh
and the two-process probe.

victor_tpu runs its sharded programs on conftest's 8 virtual CPU devices;
the port's counterpart is a mesh that names the CPU 8 times
(`make_mesh(devices=['cpu'] * 8)`), which runs the same split, replicate,
evaluate-per-shard and gather path. Everything is float64 on the CPU; the
BOSS tables are victor_tpu's (narrow width: n_mu 20, n_v 10) copied into
the port with bundle_from_arrays.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from victor_tpu.io import build_tables as jax_build_tables
from victor_tpu.likelihood.batched import \
    make_sharded_loglike as jax_make_sharded_loglike
from victor_tpu.parallel import cross_chain_rhat as jax_rhat
from victor_tpu.parallel import make_mesh as jax_make_mesh
from victor_tpu_torch import __main__ as cli
from victor_tpu_torch.errors import InputError
from victor_tpu_torch.io.tables import bundle_from_arrays, tables_to_arrays
from victor_tpu_torch.likelihood.batched import (make_batched_loglike,
                                                 make_sharded_loglike)
from victor_tpu_torch.parallel import (cross_chain_rhat, distributed_init,
                                       make_mesh, replicate, shard_along)
from victor_tpu_torch.parallel.mesh import shard_devices, shard_map
from victor_tpu_torch.sampling import (run_hmc_mcmc, run_mcmc, run_nested,
                                       run_smc, run_tension)
from victor_tpu_torch.sampling.diagnostics import _cross_chain_rhat

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
CPU8 = ['cpu'] * 8


def cpu_mesh(axis_names=('walkers',)):
    return make_mesh(axis_names, devices=CPU8)


def theta_points(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(0.3, 0.6, n), rng.uniform(0.25, 0.55, n),
        rng.uniform(250.0, 450.0, n), rng.uniform(0.9, 1.1, n)])


@pytest.fixture(scope='module')
def bundles(boss_config):
    """(victor_tpu's bundle, the port's copy of it), narrow width."""
    jb = jax_build_tables(boss_config['model'], boss_config['data'],
                          n_mu=20, n_v=10)
    tb = bundle_from_arrays(tables_to_arrays(jb.tables),
                            dataclasses.asdict(jb.spec),
                            dataclasses.asdict(jb.theory_opts),
                            dataclasses.asdict(jb.fit_opts), device='cpu')
    return jb, tb


class TestMesh:
    @pytest.mark.parametrize('axis_names,shape', [
        (('chains', 'walkers'), None), (('walkers',), None),
        (('a', 'b', 'c'), None), (('chains', 'walkers'), (4, 2))])
    def test_make_mesh_shapes_match_victor_tpu(self, axis_names, shape):
        assert len(jax.devices()) == 8
        want = jax_make_mesh(axis_names, shape=shape)
        got = make_mesh(axis_names, shape=shape, devices=CPU8)
        assert got.devices.shape == want.devices.shape
        assert got.shape == dict(want.shape)
        assert got.shape_tuple == want.shape_tuple
        assert got.size == want.size == 8
        assert got.axis_names == tuple(want.axis_names)
        assert all(d == torch.device('cpu') for d in got.devices.flat)

    def test_make_mesh_errors(self):
        with pytest.raises(ValueError):
            jax_make_mesh(('a', 'b'), shape=(3, 2))
        with pytest.raises(ValueError, match='does not cover'):
            make_mesh(('a', 'b'), shape=(3, 2), devices=CPU8)
        with pytest.raises(ValueError, match='one type'):
            make_mesh(('walkers',), devices=['cpu', 'meta'])

    def test_make_mesh_without_a_card_raises(self):
        """No CPU fallback: with no devices= the mesh spans the CUDA
        devices, and with none it raises."""
        if torch.cuda.is_available():
            pytest.skip('a CUDA device is present')
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make_mesh()
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make_mesh(('walkers',))

    def test_make_mesh_spans_every_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
        mesh = make_mesh(('chains', 'walkers'))
        assert mesh.devices.shape == (2, 2)
        assert list(mesh.devices.flat) == [torch.device('cuda', i)
                                           for i in range(4)]

    @pytest.mark.parametrize('axis_names,spec', [
        (('walkers',), ('walkers',)),
        (('chains', 'walkers'), ('walkers',)),
        (('chains', 'walkers'), (('chains', 'walkers'),)),
        (('chains', 'walkers'), ('chains', 'walkers')),
        (('chains', 'walkers'), (None, 'chains'))])
    def test_shard_along_places_what_victor_tpu_places(self, axis_names,
                                                      spec):
        x = np.arange(64.0).reshape(16, 4)
        jmesh = jax_make_mesh(axis_names)
        placed = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P(*spec)))
        by_device = {s.device: np.asarray(s.data)
                     for s in placed.addressable_shards}
        got = shard_along(torch.as_tensor(x), cpu_mesh(axis_names), spec)
        assert got.shape == jmesh.devices.shape
        for pos in np.ndindex(*got.shape):
            np.testing.assert_array_equal(got[pos].numpy(),
                                          by_device[jmesh.devices[pos]])
            assert got[pos].device == torch.device('cpu')
        with pytest.raises(ValueError, match='evenly'):
            shard_along(torch.zeros(6, 3), cpu_mesh(axis_names), spec)

    def test_shard_devices(self):
        mesh = make_mesh(('chains', 'walkers'),
                         devices=[f'cuda:{i}' for i in range(8)])
        want = [torch.device('cuda', i) for i in range(8)]
        assert shard_devices(mesh, None) == want
        assert shard_devices(mesh, ('chains', 'walkers')) == want
        assert shard_devices(mesh, 'walkers') == want[:4]
        assert shard_devices(mesh, 'chains') == [want[0], want[4]]
        assert shard_devices(mesh, ('walkers', 'chains')) == [
            want[i] for i in (0, 4, 1, 5, 2, 6, 3, 7)]
        with pytest.raises(ValueError, match='not among'):
            shard_devices(mesh, 'particles')

    def test_replicate_one_copy_per_distinct_device(self, bundles):
        _, tb = bundles
        x = torch.arange(4.0)
        assert list(replicate(x, cpu_mesh())) == [torch.device('cpu')]
        assert replicate(x, cpu_mesh())[torch.device('cpu')] is x
        assert replicate(tb, cpu_mesh())[torch.device('cpu')] is tb
        meta = make_mesh(('walkers',), devices=['meta', 'meta'])
        reps = replicate(tb, meta)
        assert list(reps) == [torch.device('meta')]
        moved = reps[torch.device('meta')]
        assert moved.tables.iaH.device.type == 'meta'
        assert moved.tables.cov.dtype == torch.float64
        assert moved.tables.cov.shape == tb.tables.cov.shape
        both = replicate((x, None, {'a': x}), meta)[torch.device('meta')]
        assert both[0].is_meta and both[1] is None and both[2]['a'].is_meta

    def test_distributed_init_single_process_contract(self):
        distributed_init()                      # one process: a no-op
        distributed_init(num_processes=1)
        with pytest.raises(ValueError, match='num_processes'):
            distributed_init(coordinator_address='host0:1234')

    @pytest.mark.parametrize('case', ['converged', 'separated', 'stuck',
                                      'short', 'odd'])
    def test_cross_chain_rhat_matches_victor_tpu(self, case):
        rng = np.random.default_rng(0)
        x = rng.normal(0, 1, (8, 400, 2))
        if case == 'separated':
            x = x + np.arange(8)[:, None, None]
        elif case == 'stuck':
            x = np.ones((4, 100, 2))
        elif case == 'short':
            x = x[:4, :1]
        elif case == 'odd':
            x = x[:3, :151]
        got = cross_chain_rhat(torch.as_tensor(x)).numpy()
        want = np.asarray(jax_rhat(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-14)
        np.testing.assert_allclose(got, _cross_chain_rhat(x), rtol=1e-14)
        assert {'converged': np.all(got < 1.03),
                'separated': np.all(got > 1.5),
                'stuck': np.all(np.isinf(got)),
                'short': np.all(np.isinf(got)),
                'odd': np.all(np.isfinite(got))}[case]


class TestShardedLikelihood:
    @pytest.mark.parametrize('gradient_free', [True, False])
    def test_matches_victor_tpu_and_the_batched_maker(self, bundles,
                                                      gradient_free):
        jb, tb = bundles
        theta = theta_points(16)
        jmesh = jax_make_mesh(('walkers',))
        want = jax_make_sharded_loglike(jb, NAMES, jmesh,
                                        gradient_free=gradient_free)(
                                            jnp.asarray(theta))
        batched = make_batched_loglike(tb, NAMES,
                                       gradient_free=gradient_free)(theta)
        for chunk in (None, 1):
            got = make_sharded_loglike(tb, NAMES, cpu_mesh(),
                                       gradient_free=gradient_free,
                                       chunk=chunk)(theta)
            for g, w, b in zip(got, want, batched):
                assert g.shape == (16,) and g.dtype == torch.float64
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-12)
                np.testing.assert_allclose(g.numpy(), b.numpy(), rtol=1e-12)

    def test_two_axis_mesh_and_fixed_parameters(self, bundles):
        """axis may name several mesh axes; base_params reach every
        shard."""
        _, tb = bundles
        theta = theta_points(8)[:, :3]
        mesh = cpu_mesh(('chains', 'walkers'))
        base = {'epsilon': 1.02}
        got = make_sharded_loglike(tb, NAMES[:3], mesh,
                                   axis=('chains', 'walkers'),
                                   base_params=base)(theta)
        want = make_batched_loglike(tb, NAMES[:3], base_params=base)(theta)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12)

    def test_gradients_flow_back_to_every_shard(self, bundles):
        _, tb = bundles
        theta = torch.tensor(theta_points(8), requires_grad=True)
        sharded = make_sharded_loglike(tb, NAMES, cpu_mesh(),
                                       gradient_free=False)
        batched = make_batched_loglike(tb, NAMES, gradient_free=False)
        g_sh, = torch.autograd.grad(sharded(theta)[0].sum(), theta)
        g_b, = torch.autograd.grad(batched(theta)[0].sum(), theta)
        assert torch.isfinite(g_sh).all() and (g_sh != 0).all(dim=0).all()
        np.testing.assert_allclose(g_sh.numpy(), g_b.numpy(), rtol=1e-10)

    def test_batch_must_divide(self, bundles):
        _, tb = bundles
        with pytest.raises(ValueError, match='evenly'):
            make_sharded_loglike(tb, NAMES, cpu_mesh())(theta_points(12))

    def test_device_type_mismatch_raises(self, bundles):
        """No silent copy between the host and a card: a bundle on the CPU
        with a mesh of other devices raises, and so does a batch."""
        _, tb = bundles
        meta = make_mesh(('walkers',), devices=['meta'] * 2)
        with pytest.raises(ValueError, match='tables lie on cpu'):
            make_sharded_loglike(tb, NAMES, meta)
        fn = shard_map(lambda tbl, x: x * 2, None, meta)
        with pytest.raises(ValueError, match='batch lies on cpu'):
            fn(torch.zeros(4))
        with pytest.raises(InputError, match='mesh spans'):
            run_hmc_mcmc(tb, {'fsigma8': {'prior': {'min': 0.1, 'max': 1}},
                              'beta': 0.37, 'sigma_v': 380.0,
                              'epsilon': 1.0}, n_chains=2, algorithm='mh',
                         mesh=make_mesh(('chains',),
                                        devices=['meta'] * 2), device='cpu')

    def test_shard_map_uneven_slices(self):
        """Inside the samplers a batch need not divide (an NS iteration's
        replacements): slices differ by one row, and empty ones are
        skipped."""
        calls = []

        def fn(tbl, x):
            calls.append(x.shape[0])
            return x * tbl, x ** 2 + x
        mesh = cpu_mesh()
        x = torch.arange(11.0)
        got = shard_map(fn, 3.0, mesh)(x)
        assert calls == [2, 2, 2, 1, 1, 1, 1, 1]
        assert torch.equal(got[0], x * 3.0)
        assert torch.equal(got[1], x ** 2 + x)
        calls.clear()
        shard_map(fn, 1.0, mesh)(x[:3])
        assert calls == [1, 1, 1]

    def test_shard_map_issues_chunks_in_turn(self):
        """Chunk k of every slice before chunk k + 1 of any (no device's
        launch queue holds the host while the others idle), the last chunk
        of each slice padded with the slice's first row, as `chunked` pads
        a batch; the result is the unsharded one."""
        order = []

        def fn(tbl, x):
            order.append(tuple(x.tolist()))
            return (x * tbl,)
        x = torch.arange(10.0)
        got = shard_map(fn, 2.0, cpu_mesh(('a', 'b')), axes='a', chunk=2)(x)
        assert order == [(0.0, 1.0), (5.0, 6.0), (2.0, 3.0), (7.0, 8.0),
                         (4.0, 0.0), (9.0, 5.0)]
        assert torch.equal(got[0], x * 2.0)
        order.clear()
        plain = shard_map(fn, 2.0, None, chunk=4)(x)
        assert order == [(0.0, 1.0, 2.0, 3.0), (4.0, 5.0, 6.0, 7.0),
                         (8.0, 9.0, 0.0, 0.0)]
        assert torch.equal(plain[0], x * 2.0)


@pytest.fixture(scope='module')
def joint_bundles(boss_config, tmp_path_factory):
    """Two BOSS quantiles under the block-diagonal stack of the BOSS
    beta-dependent covariance (test_torch_multiquantile.py's 'varying'
    case), built by both packages."""
    import copy

    import h5py

    from victor_tpu.likelihood import multiquantile as jmq
    from victor_tpu_torch.likelihood import multiquantile as tmq
    single = jax_build_tables(boss_config['model'], boss_config['data'])
    covs = np.asarray(single.tables.cov)
    beta = np.asarray(single.tables.beta_cov)
    D = covs.shape[1]
    varying = np.zeros((len(beta), 2 * D, 2 * D))
    varying[:, :D, :D] = varying[:, D:, D:] = covs
    path = tmp_path_factory.mktemp('joint') / 'varying.hdf5'
    with h5py.File(path, 'w') as f:
        f.create_dataset('covmat', data=varying)
        f.create_dataset('beta', data=beta)
    q = {'model': copy.deepcopy(boss_config['model']),
         'data': {'redshift_space_ccf':
                  copy.deepcopy(boss_config['data']['redshift_space_ccf']),
                  'dir': boss_config['data']['dir']}}
    cfg = {'quantiles': [copy.deepcopy(q), copy.deepcopy(q)],
           'likelihood': {'form': 'sellentin', 'nmocks': 1000, 'nparams': 4},
           'covariance_matrix': {'data_file': str(path), 'cov_key': 'covmat',
                                 'fixed_beta': False, 'beta_key': 'beta'}}
    return jmq.build_joint_tables(cfg), tmq.build_joint_tables(cfg,
                                                               device='cpu')


def test_sharded_joint_loglike_matches_victor_tpu(joint_bundles):
    from victor_tpu.likelihood import multiquantile as jmq
    from victor_tpu_torch.likelihood import multiquantile as tmq
    jb, tb = joint_bundles
    names = NAMES + ['sigma_v__q1']
    theta = np.column_stack([theta_points(8, seed=3),
                             np.linspace(300.0, 420.0, 8)])
    axis = ('chains', 'walkers')
    want = jmq.make_sharded_joint_loglike(
        jb, names, jax_make_mesh(axis), axis=axis)(jnp.asarray(theta))
    batched = tmq.make_batched_joint_loglike(tb, names)(theta)
    got = tmq.make_sharded_joint_loglike(tb, names, cpu_mesh(axis),
                                         axis=axis)(theta)
    for g, w, b in zip(got, want, batched):
        assert g.shape == (8,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), b.numpy(), rtol=1e-12)
    # the joint bundle replicates whole: every quantile and the stack
    moved = replicate(tb, make_mesh(('w',), devices=['meta']))
    jmeta = moved[torch.device('meta')]
    assert jmeta.icov.is_meta and jmeta.bundles[1].tables.iaH.is_meta
    assert jmeta.cov_pencil.shape == tb.cov_pencil.shape


# --- mesh= through the samplers ---------------------------------------------

GAUSS_BLOCK = {
    'a': {'prior': {'dist': 'norm', 'loc': 0.0, 'scale': 1.0},
          'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.5}},
    'b': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0},
          'ref': {'dist': 'norm', 'loc': 0.0, 'scale': 0.5},
          'proposal': 0.5},
    'c': 2.0,
}


def gauss_loglike(params):
    chi2 = (params['a'] - 0.3) ** 2 + (params['b'] + 0.2) ** 2 / 0.5 \
        + 0.0 * params['c']
    return -0.5 * chi2, chi2


def _equal_runs(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize('algorithm', ['hmc', 'nuts', 'mh'])
def test_run_hmc_mcmc_mesh_equals_no_mesh(algorithm):
    """Chains sharded over the 8-entry mesh (one chain per shard) give the
    unsharded run bit for bit: the state and the generator stay on the
    sampler's device."""
    kw = dict(n_chains=8, n_warmup=6, n_samples=6, n_leapfrog=3,
              max_depth=3, seed=4, algorithm=algorithm, segment_steps=5,
              device='cpu')
    plain = run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK, **kw)
    sharded = run_hmc_mcmc(gauss_loglike, GAUSS_BLOCK,
                           mesh=cpu_mesh(('chains',)), **kw)
    _equal_runs(sharded, plain, ('chain', 'log_prob', 'aux'))
    assert sharded.acceptance == plain.acceptance
    assert sharded.chain.shape == (6, 8, 2)


def test_run_mcmc_mesh_equals_no_mesh():
    kw = dict(n_walkers=16, max_steps=6, check_every=3, rhat_stop=0.0,
              seed=2, device='cpu')
    plain = run_mcmc(gauss_loglike, GAUSS_BLOCK, **kw)
    sharded = run_mcmc(gauss_loglike, GAUSS_BLOCK, mesh=cpu_mesh(), **kw)
    _equal_runs(sharded, plain, ('chain', 'log_prob', 'aux'))
    sharded = run_mcmc(gauss_loglike, GAUSS_BLOCK,
                       mesh=cpu_mesh(('chains', 'walkers')),
                       mesh_axis=('chains', 'walkers'), move='stretch', **kw)
    plain = run_mcmc(gauss_loglike, GAUSS_BLOCK, move='stretch', **kw)
    _equal_runs(sharded, plain, ('chain', 'log_prob', 'aux'))


def test_particle_samplers_mesh_equal_no_mesh():
    """SMC, NS (an iteration's 16 replacements over 8 shards; 40 live
    points) and tension on the 8-entry mesh equal their unsharded runs bit
    for bit."""
    kw = dict(n_particles=64, n_moves=2, seed=1, chunk=16, device='cpu')
    plain = run_smc(gauss_loglike, GAUSS_BLOCK, **kw)
    sharded = run_smc(gauss_loglike, GAUSS_BLOCK, mesh=cpu_mesh(), **kw)
    _equal_runs(sharded, plain, ('particles', 'log_prob', 'aux', 'betas'))
    assert sharded.logz == plain.logz
    kw = dict(n_live=40, n_batch=10, n_steps=3, dlogz=0.5, seed=3, chunk=None,
              device='cpu')
    plain = run_nested(gauss_loglike, GAUSS_BLOCK, **kw)
    sharded = run_nested(gauss_loglike, GAUSS_BLOCK, mesh=cpu_mesh(), **kw)
    _equal_runs(sharded, plain, ('particles', 'log_prob', 'points_logl',
                                 'points_logwt'))
    assert sharded.logz == plain.logz and sharded.n_iter == plain.n_iter
    kw = dict(n_particles=32, n_moves=1, seed=5, chunk=None, device='cpu')
    plain = run_tension(gauss_loglike, gauss_loglike, GAUSS_BLOCK, **kw)
    sharded = run_tension(gauss_loglike, gauss_loglike, GAUSS_BLOCK,
                          mesh=cpu_mesh(), **kw)
    assert (sharded.logr, sharded.logz_ab, sharded.shift_chi2) == \
        (plain.logr, plain.logz_ab, plain.shift_chi2)


@pytest.mark.parametrize('algorithm', ['hmc', 'mh'])
def test_boss_chains_on_a_mesh(bundles, algorithm):
    """The BOSS posterior with its tables replicated across the mesh and
    one chain per shard (HMC through the gradient): as victor_tpu holds its
    own (tests/test_sampling.py:643), within 5e-6 of the unsharded run —
    a shard of one row need not round as a batch of eight does."""
    _, tb = bundles
    block = {'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05,
                                   'max': 1.5},
                         'ref': {'dist': 'norm', 'loc': 0.47,
                                 'scale': 0.02}},
             'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
    kw = dict(n_chains=8, n_warmup=3, n_samples=3, n_leapfrog=2, seed=0,
              algorithm=algorithm, device='cpu')
    plain = run_hmc_mcmc(tb, block, **kw)
    sharded = run_hmc_mcmc(tb, block, mesh=cpu_mesh(('chains',)), **kw)
    assert sharded.chain.shape == (3, 8, 1)
    np.testing.assert_allclose(sharded.chain, plain.chain, rtol=5e-6)
    np.testing.assert_allclose(sharded.log_prob, plain.log_prob, rtol=5e-6)


class TestDivisibleMesh:
    def test_none_without_several_cards(self, monkeypatch):
        assert cli._divisible_mesh('chains', 8) is None
        assert cli._divisible_mesh('chains', 8, 'cpu') is None
        monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
        assert cli._divisible_mesh('chains', 8) is None

    @pytest.mark.parametrize('n_dev', [2, 4])
    def test_mesh_over_every_card_when_the_count_divides(self, monkeypatch,
                                                         n_dev):
        monkeypatch.setattr(torch.cuda, 'device_count', lambda: n_dev)
        mesh = cli._divisible_mesh('particles', 2048)
        assert mesh.axis_names == ('particles',)
        assert list(mesh.devices.flat) == [torch.device('cuda', i)
                                           for i in range(n_dev)]
        assert cli._divisible_mesh('particles', 2 * n_dev + 1) is None
        assert cli._divisible_mesh('particles', 2048, 'cpu') is None

    def test_checkpoint_count(self, tmp_path):
        ckpt = str(tmp_path / 'c.npz')
        assert cli._checkpoint_count(ckpt, 'y', 7) == 7
        np.savez(ckpt, y=np.zeros((12, 2)))
        assert cli._checkpoint_count(ckpt, 'y', 7) == 12
        assert cli._checkpoint_count(ckpt, 'hmc_q', 7) == 7


def test_two_process_probe():
    """distributed_init's multi-process branch: two gloo processes on a
    127.0.0.1 coordinator, each evaluating its half of the BOSS batch
    (narrow width) and the cross-process Gelman-Rubin reduction
    (parallel/probe.py)."""
    out = subprocess.run(
        [sys.executable, '-m', 'victor_tpu_torch.parallel.probe',
         '--device', 'cpu', '--n-mu', '20', '--n-v', '10', '--timeout',
         '100'],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary['ok'] and summary['n_processes'] == 2
    assert (summary['device'], summary['backend']) == ('cpu', 'gloo')
    children = [json.loads(ln) for ln in lines[:-1]]
    assert [c['child'] for c in children] == [0, 1]
    assert all(c['ok'] and c['world_size'] == 2 and
               c['rhat_cross_process_matches'] for c in children)
    assert children[0]['rhat_max'] == children[1]['rhat_max']

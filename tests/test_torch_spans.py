"""The port's spans and counters (`utils/profiling.py`): the spans that an
SMC stage, an HMC step and a `shard_map` call open, their nesting under
`torch.profiler` on the CPU, that nothing is emitted and nothing changes
without a profiler, the leapfrog counter, bytes counted only under a
profiler, and the counters' exactness under threads.

A correlated Gaussian stands in for the likelihood; everything is float64
on the CPU."""

import sys
import threading

import numpy as np
import pytest
import torch

from victor_tpu_torch.parallel.mesh import make_mesh, shard_map
from victor_tpu_torch.sampling import hmc, nuts
from victor_tpu_torch.sampling.smc import run_smc
from victor_tpu_torch.utils import profiling
from victor_tpu_torch.utils.profiling import (count, count_bytes, counters,
                                              reset_counters, span, timed,
                                              total)

torch.set_num_threads(1)

ICOV = torch.as_tensor(np.linalg.inv([[1.0, 0.6], [0.6, 0.8]]))
BLOCK = {'x': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}},
         'y': {'prior': {'dist': 'uniform', 'min': -5.0, 'max': 5.0}}}
N, MOVES, CHUNK = 64, 2, 16
#: the first words of the program's span names, and the timed test's
NAMED = ('smc.', 'hmc.', 'likelihood.', 'mesh.', 'unit-test')


def gauss(params):
    """A correlated Gaussian over the batch axis, chi2 as its aux."""
    d = torch.stack([params['x'] - 0.5, params['y'] + 0.3], -1)
    chi2 = torch.einsum('bi,ij,bj->b', d, ICOV, d)
    return -0.5 * chi2, chi2


def profiled(fn):
    """(fn's result, its spans as [(name, start ns, end ns)] in start order)
    under torch.profiler on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(NAMED):
            spans.append((e.name(), e.start_ns(),
                          e.start_ns() + e.duration_ns()))
    spans.sort(key=lambda s: (s[1], -s[2]))
    return out, spans


def parent_of(spans, i):
    """The name of the innermost span that holds span i, or None."""
    name, s, e = spans[i]
    best = None
    for j, (n, s2, e2) in enumerate(spans):
        if j != i and s2 <= s and e <= e2 and (best is None or
                                               s2 >= spans[best][1]):
            best = j
    return None if best is None else spans[best][0]


def nesting(spans):
    """{name: the set of names of its innermost holders}."""
    out = {}
    for i, (name, _, _) in enumerate(spans):
        out.setdefault(name, set()).add(parent_of(spans, i))
    return out


def names(spans):
    return [s[0] for s in spans]


def smc_stages(tmp_path, stages=1):
    """`stages` stages of a fresh SMC run (one run_smc call each, resumed
    from a checkpoint, as the benchmark calls it); the particles after."""
    ckpt = str(tmp_path / 'smc.npz')
    for _ in range(stages):
        try:
            run_smc(gauss, BLOCK, n_particles=N, n_moves=MOVES, seed=3,
                    chunk=CHUNK, max_stages=1, checkpoint=ckpt, resume=True,
                    device='cpu')
        except RuntimeError as e:
            assert 'did not reach beta=1' in str(e)
    with np.load(ckpt) as z:
        return z['y'].copy()


def test_smc_stage_spans_nest(tmp_path):
    _, spans = profiled(lambda: smc_stages(tmp_path))
    got = names(spans)
    assert got.count('smc.init') == 1 and got.count('smc.stage') == 1
    for name in ('smc.temper', 'smc.resample', 'smc.checkpoint'):
        assert got.count(name) == 1
    assert got.count('smc.move') == MOVES
    # the initial evaluation and each move: N / CHUNK chunks each
    assert got.count('likelihood.chunk#0') == (1 + MOVES) * N // CHUNK
    assert nesting(spans) == {
        'smc.init': {None}, 'smc.stage': {None},
        'smc.temper': {'smc.stage'}, 'smc.resample': {'smc.stage'},
        'smc.move': {'smc.stage'}, 'smc.checkpoint': {'smc.stage'},
        'likelihood.chunk#0': {'smc.init', 'smc.move'}}
    order = [n for n in got if n.startswith('smc.') and n != 'smc.init']
    assert order == ['smc.stage', 'smc.temper', 'smc.resample'] + \
        ['smc.move'] * MOVES + ['smc.checkpoint']


def _logpost():
    def lp(y):
        return -0.5 * torch.einsum('bi,ij,bj->b', y, ICOV, y), y[:, :1]
    return shard_map(lambda tbl, y: lp(y), None, None, None)


def hmc_steps(steps=2, n_warmup=3):
    """`steps` HMC steps of 8 chains from step 0, through a segment each;
    the state after."""
    gen = torch.Generator().manual_seed(5)
    y0 = torch.randn(8, 2, generator=gen, dtype=torch.float64)
    logpost = _logpost()
    state = hmc.init_chains(logpost, y0, gen, eps0=0.3)
    for i in range(steps):
        state = hmc.run_segment(logpost, state, i, 1, n_warmup=n_warmup,
                                n_leapfrog=4)[0]
    return state


def test_hmc_step_spans_nest():
    state, spans = profiled(lambda: hmc_steps(steps=2))
    got = names(spans)
    assert got.count('hmc.step') == 2
    # step 1 is the diagonal reset of a 3-step warm-up: two adapt spans
    assert got.count('hmc.adapt') == 3
    leapfrogs = got.count('hmc.leapfrog')
    assert 2 * 2 <= leapfrogs <= 2 * 4
    # the initial gradient, then one forward and backward per leapfrog
    assert got.count('likelihood.chunk#0') == leapfrogs + 1
    assert got.count('likelihood.backward') == leapfrogs + 1
    assert nesting(spans) == {
        'hmc.step': {None}, 'hmc.adapt': {'hmc.step'},
        'hmc.leapfrog': {'hmc.step'},
        'likelihood.chunk#0': {None, 'hmc.leapfrog'},
        'likelihood.backward': {None, 'hmc.leapfrog'}}


def test_shard_map_spans_over_a_two_device_mesh():
    mesh = make_mesh(('walkers',), devices=['cpu'] * 2)
    fn = shard_map(lambda tbl, x: (x * tbl, x.sum(1)), torch.tensor(2.0),
                   mesh, chunk=4)
    x = torch.arange(32.0).reshape(16, 2)
    (a, b), spans = profiled(lambda: fn(x))
    assert torch.equal(a, 2 * x) and torch.equal(b, x.sum(1))
    # two slices of 8 rows, two chunks each, issued in turns
    assert names(spans) == ['mesh.scatter'] + \
        ['likelihood.chunk#0'] * 4 + ['mesh.gather']
    assert all(v == {None} for v in nesting(spans).values())


def test_no_profiler_no_spans_and_the_same_bits(tmp_path, monkeypatch):
    """Profiled and unprofiled runs of one seed give the same bits; without
    a profiler no span reaches torch.profiler."""
    (tmp_path / 'a').mkdir()
    (tmp_path / 'b').mkdir()
    y_traced, _ = profiled(lambda: smc_stages(tmp_path / 'a', 2))
    st_traced, _ = profiled(lambda: hmc_steps(steps=2))

    def refuse(name):
        raise AssertionError(f'span {name} opened with no profiler')
    monkeypatch.setattr(torch._C._profiler, '_RecordFunctionFast', refuse)
    assert span('smc.stage') is span('hmc.step')
    y = smc_stages(tmp_path / 'b', 2)
    st = hmc_steps(steps=2)
    np.testing.assert_array_equal(y, y_traced)
    for k in ('q', 'lnp', 'grad', 'log_eps', 'welford_m2', 'chol_cov'):
        assert torch.equal(getattr(st, k), getattr(st_traced, k)), k


@pytest.mark.parametrize('sampler', ['hmc', 'nuts'])
def test_leapfrog_counter_counts_position_updates(sampler):
    """`hmc.leapfrogs` grows by one per gradient of the batch that a
    trajectory takes: every evaluation after the initial one."""
    calls = [0]
    inner = _logpost()

    def logpost(y):
        calls[0] += 1
        return inner(y)
    gen = torch.Generator().manual_seed(11)
    y0 = torch.randn(8, 2, generator=gen, dtype=torch.float64)
    state = hmc.init_chains(logpost, y0, gen, eps0=0.3)
    calls[0] = 0
    before = total('hmc.leapfrogs')
    if sampler == 'hmc':
        hmc.run_segment(logpost, state, 0, 3, n_warmup=3, n_leapfrog=4)
    else:
        nuts.run_segment(logpost, state, 0, 3, n_warmup=3, max_depth=3)
    assert calls[0] > 0
    assert total('hmc.leapfrogs') - before == calls[0]


def test_bytes_are_counted_only_under_a_profiler():
    """`count_bytes` adds the byte rule's count while a profiler runs and
    nothing otherwise."""
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.ones(3, dtype=torch.float64), torch.ones(2, 4)
    before = total('unit-test.bytes')
    count_bytes('unit-test.bytes', 0, a, None, b)
    assert total('unit-test.bytes') == before
    with profile(activities=[ProfilerActivity.CPU]):
        count_bytes('unit-test.bytes', 0, a, None, b)
    assert total('unit-test.bytes') == before + 3 * 8 + 8 * 4


def test_counters_exact_under_threads():
    """Threads counting on two devices lose no update."""
    reset_counters()
    threads, adds = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda k=k: [count('stress', 1, torch.device('cuda', k % 2))
                                for _ in range(adds)])
            for k in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert counters()['stress'] == {0: threads // 2 * adds,
                                    1: threads // 2 * adds}
    reset_counters()
    assert counters() == {}


def test_counters_are_copies_and_default_to_device_zero():
    reset_counters()
    count('a')
    count('a', 3, 'cpu')
    count('a', 2, 1)
    snap = counters()
    snap['a'][0] = 100
    assert counters() == {'a': {0: 4, 1: 2}}
    reset_counters()


def test_total_sums_the_devices_or_reads_one():
    reset_counters()
    assert total('a') == 0
    count('a', 3, torch.device('cuda', 1))
    count('a', 2)
    count('b', 5, 1)
    assert (total('a'), total('a', 1), total('a', 'cpu'),
            total('a', torch.device('cuda', 1)), total('b', 0)) == \
        (5, 3, 2, 3, 0)
    reset_counters()


def test_timed_opens_a_span_of_its_name():
    def work():
        with timed('unit-test-span') as watch:
            watch(torch.ones(3) * 2)
    _, spans = profiled(work)
    assert names(spans) == ['unit-test-span']
    assert profiling.phase_times()['unit-test-span']['count'] >= 1


def test_span_self_time_subtracts_children(monkeypatch):
    """Under a profiler a span's self time is its time less its child
    spans'; with none running the spans add nothing."""
    from torch.profiler import ProfilerActivity, profile
    reset_counters()
    with span('unit-test.outer'):
        pass
    assert profiling.span_self_s() == {}
    ticks = iter([0, 10, 30, 100])     # enter outer, enter inner, exits
    monkeypatch.setattr(profiling.time, 'perf_counter_ns',
                        lambda: next(ticks))
    with profile(activities=[ProfilerActivity.CPU]):
        with span('unit-test.outer'):
            with span('unit-test.inner'):
                pass
    monkeypatch.undo()
    assert profiling.span_self_s() == {'unit-test.outer': 80e-9,
                                       'unit-test.inner': 20e-9}
    reset_counters()
    assert profiling.span_self_s() == {}


def test_span_self_times_cover_an_smc_stage(tmp_path):
    """The self times under a profiled SMC run's first stage: every span
    name timed, none negative, and together the time of the outermost
    spans (`smc.init` and `smc.stage`), which hold all the others."""
    reset_counters()
    _, spans = profiled(lambda: smc_stages(tmp_path))
    own = profiling.span_self_s()
    assert set(own) == set(names(spans))
    assert min(own.values()) >= 0
    outer = sum(e - s for n, s, e in spans
                if n in ('smc.init', 'smc.stage')) / 1e9
    assert sum(own.values()) == pytest.approx(outer, rel=0.05, abs=1e-3)
    reset_counters()

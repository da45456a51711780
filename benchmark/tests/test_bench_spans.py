"""The program's spans and counters as the benchmark reads them: the idle
split on synthetic events (`benchlib.spans`), and the readers of the
program's span self times and byte counter."""

import types

import pytest

from benchlib import manifest, spans
from benchlib.roofline import HBM_BYTES_PER_S
from benchlib.trace import make_events, summarize

US = 1000   # ns


def _events(dev=None):
    """One card's operations over a window [0, 100) us: kernels [0, 10),
    [30, 40) and [60, 90); idle [10, 30), [40, 60) and [90, 100)."""
    dev = dev or [('k', 0, 'kernel', 0, 10 * US, 1),
                  ('k', 0, 'kernel', 30 * US, 40 * US, 2),
                  ('ppoly_tiles<double>', 0, 'kernel', 60 * US, 90 * US, 3)]
    return make_events(dev, [], [])


#: the host over the same window: a stage [5, 95) us holding a temper
#: [5, 20), then a move [20, 80) that issues a chunk to card 0 [25, 45)
#: and one to card 1 [45, 70); the host in no span before 5 and after 95
SPANS = [('smc.stage', 5 * US, 95 * US), ('smc.temper', 5 * US, 20 * US),
         ('smc.move', 20 * US, 80 * US),
         ('likelihood.chunk#0', 25 * US, 45 * US),
         ('likelihood.chunk#1', 45 * US, 70 * US)]


def _run(trace, program=None, cell='boss_smc'):
    return types.SimpleNamespace(
        cell=manifest.find_cell(cell), trace=trace, program=program,
        units=1, evals=1, grad_evals=1, window_s=1.0, setup_s=1.0,
        itemsize=8)


def test_timeline_covers_the_window_with_the_innermost_path():
    s, e, paths = spans.timeline(SPANS, 0, 100 * US)
    assert list(zip(s // US, e // US, paths)) == [
        (0, 5, 'outside_program'), (5, 20, 'smc.stage/smc.temper'),
        (20, 25, 'smc.stage/smc.move'),
        (25, 45, 'smc.stage/smc.move/likelihood.chunk#0'),
        (45, 70, 'smc.stage/smc.move/likelihood.chunk#1'),
        (70, 80, 'smc.stage/smc.move'), (80, 95, 'smc.stage'),
        (95, 100, 'outside_program')]


def test_self_time_subtracts_children():
    prog = spans.reduce(SPANS, _events(), 0, 100 * US, [0])
    assert prog.spans == 5 and prog.window_s == pytest.approx(1e-4)
    assert prog.self_s['smc.stage'] == pytest.approx(15e-6)      # 80..95
    assert prog.self_s['smc.temper'] == pytest.approx(15e-6)
    assert prog.self_s['smc.move'] == pytest.approx(15e-6)       # less 45
    assert prog.self_s['likelihood.chunk#0'] == pytest.approx(20e-6)


def test_sampler_host_pct_reads_the_programs_self_times(monkeypatch):
    """The `smc.*` and `hmc.*` self times the program summed, over the
    window; not the layers below."""
    from victor_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, 'span_self_s', lambda: {
        'smc.stage': 15e-6, 'smc.temper': 15e-6, 'smc.move': 15e-6,
        'likelihood.chunk#0': 20e-6, 'mesh.gather': 5e-6})
    run = _run(summarize(_events(), 0, 100 * US, [0]))
    assert manifest.metric_reader('sampler_host_pct.smc')(run) == \
        pytest.approx(45.0)
    monkeypatch.setattr(profiling, 'span_self_s', dict)
    assert manifest.metric_reader('sampler_host_pct.smc')(run) is None


def test_idle_split_sums_to_idle_pct():
    ev = _events()
    prog = spans.reduce(SPANS, ev, 0, 100 * US, [0])
    # idle [10, 30): temper 10, move 5, chunk#0 5; [40, 60): chunk#0 5,
    # chunk#1 15; [90, 100): the stage 5, outside 5
    assert prog.idle_s[0] == pytest.approx({
        'smc.stage/smc.temper': 10e-6, 'smc.stage/smc.move': 5e-6,
        'smc.stage/smc.move/likelihood.chunk#0': 10e-6,
        'smc.stage/smc.move/likelihood.chunk#1': 15e-6,
        'smc.stage': 5e-6, 'outside_program': 5e-6})
    run = _run(summarize(ev, 0, 100 * US, [0]), prog)
    read = manifest.metric_reader
    sampler = spans.idle_part_pct(run, 'sampler')
    dispatch = spans.idle_part_pct(run, 'dispatch')
    outside = spans.idle_part_pct(run, 'outside')
    mesh = spans.idle_part_pct(run, 'mesh')
    assert (sampler, dispatch, mesh, outside) == pytest.approx(
        (20.0, 10.0, 15.0, 5.0))
    assert sampler + dispatch + mesh + outside == \
        pytest.approx(read('idle_pct.smc')(run))
    assert spans.top_idle(prog, 2) == [
        ['card_0:smc.stage/smc.move/likelihood.chunk#1', pytest.approx(15e-6)],
        ['card_0:smc.stage/smc.temper', pytest.approx(10e-6)]]


def test_idle_mesh_sees_other_cards_chunks_and_the_gather():
    """Card 1 is the idlest: it waits while the host issues card 0's chunk
    and gathers; it does not count its own chunk there."""
    dev = [('k', 0, 'kernel', 0, 100 * US, 1),
           ('k', 1, 'kernel', 50 * US, 60 * US, 2)]
    host = [('smc.move', 0, 100 * US),
            ('mesh.scatter', 0, 10 * US),
            ('likelihood.chunk#0', 10 * US, 40 * US),
            ('likelihood.chunk#1', 40 * US, 60 * US),
            ('mesh.gather', 60 * US, 90 * US)]
    ev = _events(dev)
    trace = summarize(ev, 0, 100 * US, [0, 1])
    run = _run(trace, spans.reduce(host, ev, 0, 100 * US, [0, 1]),
               cell='boss_smc_4chip')
    mesh = spans.idle_part_pct(run, 'mesh')
    dispatch = spans.idle_part_pct(run, 'dispatch')
    sampler = spans.idle_part_pct(run, 'sampler')
    assert (mesh, dispatch, sampler) == pytest.approx((10 + 30 + 30, 10, 10))
    assert mesh + dispatch + sampler == pytest.approx(
        manifest.metric_reader('idle_pct_max.mesh')(run))
    assert spans.kind_of('likelihood.backward', 1) == 'dispatch'
    assert spans.kind_of('hmc.step/hmc.leapfrog', 0) == 'sampler'


def test_ppoly_bytes_roofline_follows_the_byte_rule():
    """The counted bytes over 3.35 TB/s over the ppoly kernels' time."""
    import torch
    from victor_tpu_torch.utils import profiling
    from victor_tpu_torch.utils.profiling import nbytes
    x, c = torch.zeros(31), torch.zeros(256, 30, 4)
    q = torch.zeros(256, 1000)
    fwd = nbytes(x, c, q, q)                          # out is q's shape
    bwd = nbytes(x, c, q, q) + nbytes(q, c)           # grad in; dq, dc out
    assert fwd == (31 + 256 * 120 + 2 * 256000) * 4
    profiling.reset_counters()
    profiling.count('ppoly.bytes', fwd, 0)
    profiling.count('ppoly.bytes', bwd, 1)
    profiling.count('ppoly.launches', 1, 0)
    trace = summarize(_events(), 0, 100 * US, [0])
    try:
        assert manifest.metric_reader('ppoly_bytes_roofline_pct.hmc')(
            _run(trace, cell='boss_hmc')) == \
            pytest.approx(100 * (fwd + bwd) / HBM_BYTES_PER_S / 30e-6)
    finally:
        profiling.reset_counters()


def test_no_program_spans_read_nothing(monkeypatch):
    """Under a program without spans or counters (the parent's) every new
    reader reads nothing, and the existing numbers are as before."""
    from victor_tpu_torch.utils import profiling
    ev = _events()
    assert spans.reduce([], ev, 0, 100 * US, [0]) is None
    assert spans.reduce([('smc.stage', 200 * US, 300 * US)], ev, 0,
                        100 * US, [0]) is None
    for name in ('span_self_s', 'count_bytes', 'total', 'count'):
        monkeypatch.delattr(profiling, name)
    trace = summarize(ev, 0, 100 * US, [0])
    read = manifest.metric_reader
    for cell, names in (
            ('boss_smc', ['sampler_host_pct.smc']),
            ('boss_hmc', ['sampler_host_pct.hmc',
                          'ppoly_bytes_roofline_pct.hmc']),
            ('boss_smc_4chip', ['sampler_host_pct.mesh'])):
        run = _run(trace, None, cell)
        for name in names:
            assert read(name)(run) is None, name
    run = _run(trace, None, 'boss_smc')
    assert spans.idle_part_pct(run, 'sampler') is None
    assert read('idle_pct.smc')(run) == pytest.approx(50.0)


def test_summarize_needs_the_window_mark():
    assert spans.summarize(None, _events(), 'bench_window', [0]) is None


class _Event:
    def __init__(self, name, start, dur, device='DeviceType.CPU', kind=None):
        self._name, self._start, self._dur = name, start, dur
        self._device = device
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._device


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_from_profiler_keeps_the_hosts_program_spans():
    """The host's program ranges, whether or not the event names its
    activity; not their images on a card, nor other host ranges."""
    got = spans.from_profiler(_prof([
        _Event('smc.stage', 10, 5, kind='cpu_op'),
        _Event('smc.stage', 11, 4, 'DeviceType.CUDA', 'gpu_user_annotation'),
        _Event('aten::mul', 12, 1, kind='cpu_op'),
        _Event('smc.move', 12, 2, kind='user_annotation'),
        _Event('bench_window', 0, 100, kind='user_annotation'),
        _Event('hmc.step', 20, 6),
        _Event('hmc.step', 21, 5, 'DeviceType.CUDA')]))
    assert got == [('smc.stage', 10, 15), ('smc.move', 12, 14),
                   ('hmc.step', 20, 26)]

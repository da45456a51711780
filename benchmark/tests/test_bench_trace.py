"""The metric arithmetic on synthetic profiler events."""

import types

import pytest

from benchlib import manifest, roofline
from benchlib.trace import idle_gaps, make_events, summarize, union_ns

import numpy as np

US = 1000   # ns


def _events():
    """Two cards over a window [0, 100) us. Card 0: kernels at [10, 30)
    and [20, 40) overlapping (busy 30 us), a copy at [60, 70), a kernel
    running past the window's end [95, 120); its idle gaps are [0, 10),
    [40, 60) and [70, 95). Card 1: one kernel [0, 50). The host launched
    card 0's copy from inside aten::copy_, itself inside aten::where."""
    dev = [
        ('elementwise_kernel_a', 0, 'kernel', 10 * US, 30 * US, 1),
        ('ppoly_tiles<double>', 0, 'kernel', 20 * US, 40 * US, 2),
        ('Memcpy DtoH', 0, 'gpu_memcpy', 60 * US, 70 * US, 3),
        ('elementwise_kernel_b', 0, 'kernel', 95 * US, 120 * US, 4),
        ('ppoly_bwd_chunks<double>', 1, 'kernel', 0, 50 * US, 5),
    ]
    launches = [(1, 5 * US), (2, 6 * US), (3, 55 * US), (4, 90 * US),
                (5, 0)]
    ops = [('aten::mul', 0, 8 * US), ('aten::where', 50 * US, 58 * US),
           ('aten::copy_', 54 * US, 56 * US), ('aten::sum', 88 * US, 92 * US)]
    return make_events(dev, launches, ops)


def test_union_counts_overlaps_once():
    s = np.array([10, 20, 60, 95]) * US
    e = np.array([30, 40, 70, 120]) * US
    assert union_ns(s, e, 0, 100 * US) == (30 + 10 + 5) * US
    assert union_ns(s[:0], e[:0], 0, 100) == 0


def test_idle_gaps():
    s = np.array([10, 20, 60, 95]) * US
    e = np.array([30, 40, 70, 120]) * US
    assert [(a // US, b // US) for a, b, _ in idle_gaps(s, e, 0, 100 * US)] \
        == [(0, 10), (40, 60), (70, 95)]


def test_summary_busy_kernels_and_gaps():
    sm = summarize(_events(), 0, 100 * US, [0, 1])
    assert sm.window_s == pytest.approx(1e-4)
    assert sm.busy_s[0] == pytest.approx(45e-6)
    assert sm.busy_s[1] == pytest.approx(50e-6)
    assert sm.kernels == 4                       # the copy is no launch
    assert sm.kernel_s == pytest.approx((20 + 20 + 5 + 50) * 1e-6)
    gaps = dict(sm.gaps)
    assert gaps['card_1:window_end'] == pytest.approx(50e-6)
    # the gap [70, 95) on card 0 ends with a kernel launched at 90 us,
    # inside aten::sum; [40, 60) with the copy launched inside the
    # innermost op running at 55 us, aten::copy_
    assert gaps['card_0:aten::sum'] == pytest.approx(25e-6)
    assert gaps['card_0:aten::copy_'] == pytest.approx(20e-6)
    assert gaps['card_0:aten::mul'] == pytest.approx(10e-6)


def _run(summary, **kw):
    cell = manifest.find_cell(kw.pop('cell'))
    base = dict(cell=cell, trace=summary, units=0, evals=0, grad_evals=0,
                window_s=1.0, setup_s=1.0, itemsize=8)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_launches_per_unit_and_max_idle_over_cards():
    sm = summarize(_events(), 0, 100 * US, [0, 1])
    run = _run(sm, cell='boss_smc_4chip', evals=8, units=8)
    read = manifest.metric_reader
    assert read('launches_per_eval.mesh')(run) == pytest.approx(4 / 8)
    assert read('device_us_per_eval.mesh')(run) == pytest.approx(95 / 8)
    assert read('idle_pct_max.mesh')(run) == pytest.approx(55.0)
    smc = _run(sm, cell='boss_smc', evals=8, units=8)
    assert read('elementwise_pct.smc')(smc) == pytest.approx(
        100 * 25 / 95)
    assert read('idle_pct.smc')(smc) == pytest.approx(100 - 47.5)


def test_ppoly_bytes_follow_the_byte_rule():
    lk = {'knots': 31, 'channels': 1, 'tables': 'per_point',
          'points': 150000, 'grad': 'dq_dcoeffs'}
    rows, q = 256, 256 * 150000
    table = 256 * 30 * 4 + 31
    fwd = q + table + q
    bwd = q + table + q + q + 256 * 30 * 4
    assert roofline.lookup_bytes(lk, rows, 8, gradient=False) == fwd * 8
    assert roofline.lookup_bytes(lk, rows, 8, gradient=True) == \
        (fwd + bwd) * 8
    shared = dict(lk, tables='shared', knots=25, grad='dq')
    t1 = 24 * 4 + 25
    assert roofline.lookup_bytes(shared, rows, 8, gradient=True) == \
        ((q + t1 + q) + (q + t1 + q + q)) * 8


def test_ppoly_roofline_reads_the_lookup_kernels_only():
    sm = summarize(_events(), 0, 100 * US, [0, 1])
    run = _run(sm, cell='boss_hmc', grad_evals=512, units=256)
    work = roofline.evaluation_bytes(run.cell.config['lookups'], 256, 8,
                                     True) * 2
    seconds = 20e-6 + 50e-6     # ppoly_tiles and ppoly_bwd_chunks
    assert manifest.metric_reader('ppoly_roofline_pct.hmc')(run) == \
        pytest.approx(100 * work / roofline.HBM_BYTES_PER_S / seconds)
    empty = summarize(make_events([], [], []), 0, 100 * US, [0])
    assert manifest.metric_reader('ppoly_roofline_pct.hmc')(
        _run(empty, cell='boss_hmc', grad_evals=512)) is None

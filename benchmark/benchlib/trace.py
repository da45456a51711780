"""The reduction of a `torch.profiler` trace to the benchmark's numbers.

`events_from_profiler` turns the profiler's raw events into plain arrays
(`Events`); `summarize` reduces them over the measured window: per card the
time in which a device operation ran (the union of the intervals of
kernels, copies and fills, so that overlapping operations count once), the
kernels' count and summed time by name, and the longest idle gaps, each
named by the host operation that issued the work ending it. Both are plain
Python and NumPy, so that tests can feed them a synthetic event list.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_KINDS = ('cuda_runtime', 'cuda_driver')


@dataclasses.dataclass
class Events:
    """Device operations (name, card, kind, start and end in ns, the
    correlation id of the call that launched them), the host's launch calls
    (correlation id -> start ns) and the host's operators (name, start and
    end in ns)."""
    dev_name: List[str]
    dev_card: np.ndarray
    dev_kind: List[str]
    dev_start: np.ndarray
    dev_end: np.ndarray
    dev_corr: np.ndarray
    launch_at: Dict[int, int]
    op_name: List[str]
    op_start: np.ndarray
    op_end: np.ndarray
    marks: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)


def _call(e, method: str, default=None):
    fn = getattr(e, method, None)
    return default if fn is None else fn()


def _span_ns(e) -> Tuple[int, int]:
    """(start, end) in ns of a raw profiler event."""
    start = _call(e, 'start_ns')
    if start is None:
        start = int(e.start_us() * 1000)
    dur = _call(e, 'duration_ns')
    if dur is None:
        dur = int(e.duration_us() * 1000)
    return int(start), int(start) + int(dur)


def _kind(e) -> str:
    """The event's activity: 'kernel', 'gpu_memcpy', 'gpu_memset' on a
    card; 'cuda_runtime' for the host's CUDA calls; else 'cpu_op'. Where
    the profiler does not say, the device and the name decide."""
    kind = _call(e, 'activity_type')
    if kind is not None:
        return str(kind)
    name = e.name()
    if str(e.device_type()).endswith('CUDA'):
        return 'gpu_memcpy' if name.startswith('Memcpy') else \
            'gpu_memset' if name.startswith('Memset') else 'kernel'
    return 'cuda_runtime' if name.startswith('cu') else 'cpu_op'


def make_events(device_ops, launches, host_ops) -> Events:
    """Events from tuples: device_ops (name, card, kind, start_ns, end_ns,
    corr), launches (corr, start_ns), host_ops (name, start_ns, end_ns)."""
    device_ops = list(device_ops)
    host_ops = sorted(host_ops, key=lambda o: o[1])
    return Events(
        dev_name=[d[0] for d in device_ops],
        dev_card=np.array([d[1] for d in device_ops], dtype=np.int64),
        dev_kind=[d[2] for d in device_ops],
        dev_start=np.array([d[3] for d in device_ops], dtype=np.int64),
        dev_end=np.array([d[4] for d in device_ops], dtype=np.int64),
        dev_corr=np.array([d[5] for d in device_ops], dtype=np.int64),
        launch_at=dict(launches),
        op_name=[o[0] for o in host_ops],
        op_start=np.array([o[1] for o in host_ops], dtype=np.int64),
        op_end=np.array([o[2] for o in host_ops], dtype=np.int64))


def events_from_profiler(prof, mark: str = '') -> Events:
    """The raw events of a finished `torch.profiler.profile`; the spans of
    the host annotations named `mark` (`torch.profiler.record_function`)
    go to `marks`, on the profiler's own clock."""
    dev, launches, ops, marks = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        start, end = _span_ns(e)
        if mark and e.name() == mark:
            marks[mark] = (start, end)
            continue
        kind = _kind(e)
        corr = int(_call(e, 'correlation_id', 0))
        if kind in DEVICE_KINDS:
            dev.append((e.name(), int(e.device_index()), kind, start, end,
                        corr))
        elif kind in LAUNCH_KINDS:
            launches.append((corr, start))
        elif kind == 'cpu_op':
            ops.append((e.name(), start, end))
    ev = make_events(dev, launches, ops)
    ev.marks.update(marks)
    return ev


def union_ns(starts: np.ndarray, ends: np.ndarray, lo: int, hi: int) -> int:
    """The length of the union of the intervals [starts, ends), clipped to
    [lo, hi)."""
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    if not len(s):
        return 0
    order = np.argsort(s, kind='stable')
    s, e = s[order], np.maximum.accumulate(e[order])
    # an interval opens a new run where it starts after every earlier end
    new = np.empty(len(s), dtype=bool)
    new[0] = True
    new[1:] = s[1:] > e[:-1]
    run_start = s[new]
    run_end = np.append(e[np.flatnonzero(new)[1:] - 1], e[-1])
    return int((run_end - run_start).sum())


def idle_gaps(starts: np.ndarray, ends: np.ndarray, lo: int, hi: int
              ) -> List[Tuple[int, int, Optional[int]]]:
    """The idle intervals of one card inside [lo, hi): (start, end, index of
    the device operation that ends the gap, or None at the window's end)."""
    order = np.argsort(starts, kind='stable')
    gaps, busy_until = [], lo
    for i in order:
        s, e = int(starts[i]), int(ends[i])
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > busy_until:
            gaps.append((busy_until, s, int(i)))
        busy_until = max(busy_until, e)
    if busy_until < hi:
        gaps.append((busy_until, hi, None))
    return gaps


def host_op_at(ev: Events, t: int) -> str:
    """The innermost host operator running at time t: the latest-starting
    one whose interval holds t."""
    k = int(np.searchsorted(ev.op_start, t, side='right'))
    best = None
    for i in range(k - 1, max(k - 4096, 0) - 1, -1):
        if ev.op_end[i] >= t:
            best = i
            break
    return ev.op_name[best] if best is not None else 'no_host_op'


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: Dict[int, float]              # card -> seconds busy
    kernels: int                          # kernel launches, all cards
    kernel_s: float                       # summed kernel time, all cards
    kernel_s_by_name: Dict[str, float]
    gaps: List[Tuple[str, float]]         # ('card_<i>:<host op>', seconds)


def summarize(ev: Events, lo: int, hi: int, cards: List[int],
              n_gaps: int = 10) -> Summary:
    """The trace's numbers over the window [lo, hi) ns on `cards`."""
    inside = (ev.dev_end > lo) & (ev.dev_start < hi)
    busy, gaps = {}, []
    for c in cards:
        sel = np.flatnonzero(inside & (ev.dev_card == c))
        st, en = ev.dev_start[sel], ev.dev_end[sel]
        busy[c] = union_ns(st, en, lo, hi) / 1e9
        for g0, g1, nxt in idle_gaps(st, en, lo, hi):
            gaps.append((g1 - g0, c, g0, None if nxt is None else sel[nxt]))
    gaps.sort(key=lambda g: -g[0])
    named = []
    for length, c, g0, nxt in gaps[:n_gaps]:
        if nxt is None:
            what = 'window_end'
        else:
            t = ev.launch_at.get(int(ev.dev_corr[nxt]), int(ev.dev_start[nxt]))
            what = host_op_at(ev, t)
        named.append((f'card_{c}:{what}', length / 1e9))
    by_name: Dict[str, float] = {}
    n_kernels = 0
    for i in np.flatnonzero(inside):
        if ev.dev_kind[i] != 'kernel' or ev.dev_card[i] not in cards:
            continue
        n_kernels += 1
        d = (min(int(ev.dev_end[i]), hi) - max(int(ev.dev_start[i]), lo)) / 1e9
        by_name[ev.dev_name[i]] = by_name.get(ev.dev_name[i], 0.0) + d
    return Summary(window_s=(hi - lo) / 1e9, busy_s=busy, kernels=n_kernels,
                   kernel_s=sum(by_name.values()), kernel_s_by_name=by_name,
                   gaps=named)

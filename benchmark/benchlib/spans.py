"""The program's spans, read beside the device's trace: the idle split.

The program opens named ranges at its layer boundaries
(`victor_tpu_torch.utils.profiling.span`: `smc.*`, `hmc.*`,
`likelihood.*`, `mesh.*`), which a running `torch.profiler` records as
host events (`cpu_op`) on the clock of the device's kernels. This module
reduces them over the measured window:

- a span's self time: its time in the window less what its child spans
  cover, by span name (the host's time in that layer's own code);
- each card's idle time split by the innermost program span the host was
  in while the card waited, by span path (`smc.stage/smc.move`), and
  `outside_program` for time in none (the harness's own loop); the parts
  sum to the card's idle time (`idle_part_pct` groups them by what the
  host was doing: sampler, dispatch, mesh or outside).

It needs the profiler's raw events, which `run.py` hands to
`benchlib.trace` alone and drops before the metric readers run; so no
run calls it yet. Wiring it takes, in `run.py::run_cell`, a
`spans.summarize(prof, events, WINDOW_MARK, cards)` before `del prof`,
its result passed to `Run` (as `program`, which `idle_part_pct` reads),
and `top_idle` of it as a `breakdown` key. A program without spans gives
no summary (None). The spans are taken as one host thread's, properly
nested; a span that outlasts its parent is cut at the parent's end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchlib.trace import Events, _span_ns, idle_gaps

#: the first word of every program span's name
PROGRAM = ('smc.', 'hmc.', 'likelihood.', 'mesh.')
#: spans of the sampler layer
SAMPLER = ('smc.', 'hmc.')
#: the part of a card's idle time in which the host was in no program span
OUTSIDE = 'outside_program'
#: the activities of a host range
HOST_KINDS = ('cpu_op', 'user_annotation')


@dataclasses.dataclass
class Program:
    window_s: float
    spans: int                              # program spans in the window
    self_s: Dict[str, float]                # span name -> self seconds
    idle_s: Dict[int, Dict[str, float]]     # card -> {span path: seconds}


def _on_host(e) -> bool:
    """Whether a profiler event named like a program span is the host's
    range, not an image of one on a card's timeline. Where the event does
    not say its activity (torch 2.11), the device decides."""
    kind = getattr(e, 'activity_type', None)
    if kind is not None:
        return str(kind()) in HOST_KINDS
    return not str(e.device_type()).endswith('CUDA')


def from_profiler(prof) -> List[Tuple[str, int, int]]:
    """The program's spans of a finished `torch.profiler.profile`:
    (name, start ns, end ns)."""
    return [(e.name(), *_span_ns(e))
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(PROGRAM) and _on_host(e)]


def timeline(spans, lo: int, hi: int):
    """The innermost span's path over [lo, hi), piecewise: (starts, ends,
    paths) of consecutive segments that cover the window, `OUTSIDE` where
    the host was in no span."""
    starts, ends, paths = [], [], []
    stack: List[Tuple[int, str]] = []          # (end, path), innermost last
    t = lo

    def emit(until):
        nonlocal t
        if until > t:
            starts.append(t)
            ends.append(until)
            paths.append(stack[-1][1] if stack else OUTSIDE)
            t = until

    for name, s, e in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        if stack:
            e = min(e, stack[-1][0])
            stack.append((e, f'{stack[-1][1]}/{name}'))
        else:
            stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(hi)
    return (np.array(starts, dtype=np.int64), np.array(ends, dtype=np.int64),
            paths)


def _idle_before(gaps, t: np.ndarray) -> np.ndarray:
    """The idle time in [lo, t) for each t: gaps (start, end) sorted and
    disjoint."""
    if not gaps:
        return np.zeros(len(t), dtype=np.int64)
    g0 = np.array([g[0] for g in gaps], dtype=np.int64)
    g1 = np.array([g[1] for g in gaps], dtype=np.int64)
    done = np.concatenate([[0], np.cumsum(g1 - g0)])
    k = np.searchsorted(g1, t, side='right')      # gaps ended by t
    part = np.where(k < len(g0),
                    np.clip(t - g0[np.minimum(k, len(g0) - 1)], 0, None), 0)
    return done[k] + part


def reduce(spans, ev: Events, lo: int, hi: int, cards: List[int]
           ) -> Optional[Program]:
    """The window's self time by span name and each card's idle time by
    span path, from the program's spans and the trace's device operations;
    None without a program span in the window."""
    spans = [sp for sp in spans if sp[2] > lo and sp[1] < hi]
    if not spans:
        return None
    seg_s, seg_e, paths = timeline(spans, lo, hi)
    self_s: Dict[str, float] = {}
    for path, d in zip(paths, (seg_e - seg_s) / 1e9):
        if path != OUTSIDE:
            leaf = path.rsplit('/', 1)[-1]
            self_s[leaf] = self_s.get(leaf, 0.0) + float(d)
    inside = (ev.dev_end > lo) & (ev.dev_start < hi)
    idle: Dict[int, Dict[str, float]] = {}
    for c in cards:
        sel = np.flatnonzero(inside & (ev.dev_card == c))
        gaps = [(g0, g1) for g0, g1, _ in
                idle_gaps(ev.dev_start[sel], ev.dev_end[sel], lo, hi)]
        part = (_idle_before(gaps, seg_e) - _idle_before(gaps, seg_s)) / 1e9
        by_path: Dict[str, float] = {}
        for path, d in zip(paths, part):
            if d > 0:
                by_path[path] = by_path.get(path, 0.0) + float(d)
        idle[c] = by_path
    return Program(window_s=(hi - lo) / 1e9, spans=len(spans), self_s=self_s,
                   idle_s=idle)


def summarize(prof, ev: Events, mark: str, cards: List[int]
              ) -> Optional[Program]:
    """`reduce` over the window that the host annotation `mark` spans."""
    if mark not in ev.marks:
        return None
    lo, hi = ev.marks[mark]
    return reduce(from_profiler(prof), ev, lo, hi, cards)


def top_idle(program: Program, n: int = 10) -> List[List]:
    """The n largest [`card_<i>:<span path>`, seconds] of the idle split."""
    rows = [(f'card_{c}:{path}', s) for c, by_path in program.idle_s.items()
            for path, s in by_path.items()]
    rows.sort(key=lambda r: -r[1])
    return [[name[:120], s] for name, s in rows[:n]]


def kind_of(path: str, card: int) -> str:
    """What the host was doing while `card` waited, by the innermost span's
    path: 'sampler' (a `smc.*` or `hmc.*` span's own code), 'dispatch' (a
    `likelihood.*` span for this card, or for no card in particular),
    'mesh' (`mesh.*`, or another card's `likelihood.chunk`) or 'outside'."""
    if path == OUTSIDE:
        return 'outside'
    leaf = path.rsplit('/', 1)[-1]
    if leaf.startswith(SAMPLER):
        return 'sampler'
    if leaf.startswith('mesh.'):
        return 'mesh'
    if '#' in leaf:
        return 'dispatch' if leaf.rsplit('#', 1)[1] == str(card) else 'mesh'
    return 'dispatch'


def idle_part_pct(run, kind: str) -> Optional[float]:
    """The share of the window, in percent, in which the idlest card (the
    one card of a one-card cell) waited while the host was doing `kind`
    (`kind_of`); None without program spans."""
    program = getattr(run, 'program', None)
    if run.trace is None or program is None or not run.trace.busy_s:
        return None
    card = min(run.trace.busy_s, key=run.trace.busy_s.get)
    seconds = sum(s for path, s in program.idle_s.get(card, {}).items()
                  if kind_of(path, card) == kind)
    return 100.0 * seconds / program.window_s

"""Peaks of the card and the bytes a kernel's work needs.

The rule and the peak are those of the program's `chip_smoke.py`
(`nbytes`, and the bound at `HBM_BYTES_PER_S`): each input byte read once
and each output byte written once, over the published device-memory
bandwidth of one H100 SXM. The shares they give are stated against the
published peak, with the card's power limit recorded beside them.
"""

from __future__ import annotations

from typing import Dict, List

#: H100 SXM device memory bandwidth, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12


def lookup_bytes(lookup: Dict, rows: int, itemsize: int,
                 gradient: bool) -> int:
    """The bytes one batched call of a spline lookup needs for `rows`
    parameter points: the forward reads the queries, the knots and the
    tables once and writes the values once; the backward reads the queries,
    the knots, the tables and the incoming gradient once and writes the
    queries' gradient (and, for tables that depend on the point, the
    tables' gradient) once.

    lookup: {'knots': n, 'channels': K, 'tables': 'shared' | 'per_point',
    'points': queries per parameter point, 'grad': 'dq' | 'dq_dcoeffs'}."""
    n, k, m = int(lookup['knots']), int(lookup['channels']), \
        int(lookup['points'])
    table_rows = rows if lookup['tables'] == 'per_point' else 1
    queries = rows * m
    table = table_rows * k * (n - 1) * 4 + n
    fwd = queries + table + queries * k
    if not gradient:
        return fwd * itemsize
    bwd = queries + table + queries * k + queries
    if lookup['grad'] == 'dq_dcoeffs':
        bwd += table_rows * k * (n - 1) * 4
    return (fwd + bwd) * itemsize


def evaluation_bytes(lookups: List[Dict], rows: int, itemsize: int,
                     gradient: bool) -> int:
    """The bytes of every lookup of one batched evaluation of `rows`
    points."""
    return sum(lookup_bytes(lk, rows, itemsize, gradient) for lk in lookups)

#!/usr/bin/env python3
"""Run one cell of victor_tpu_torch's benchmark, once, on the card(s).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (`workloads` in BENCHMARK.json) names
a configuration and a traffic mix, whose files, limits and metric readers
`benchlib.manifest` finds by name. The run builds the tables, warms the
cell's own shapes, measures for --seconds (ending at the first stage or
step boundary after them), then checks what the window produced against
the plain reference (benchmark/reference/) and prints one JSON line:
`correct`, `attempted` (answers compared), `failed` (compared numbers over
their limits), `metrics` (the cell's end-to-end metrics, or with --trace 1
its per-layer metrics from a torch.profiler trace of the window),
`device`, with --trace 1 `breakdown`, and last `checks`: each compared
number beside its limit. It exits with another code than 0, printing no
result, without enough CUDA devices, when the program cannot be imported,
or when JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'victor_tpu')
THREADS = '4'
#: the host annotation that spans the window in a trace
WINDOW_MARK = 'bench_window'

for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ[var] = THREADS
# kernel caches at fixed paths inside the checkout (the program builds its
# own CUDA kernels under build/victor_tpu_torch/)
os.environ['TRITON_CACHE_DIR'] = str(ROOT / 'build' / 'bench_cache' / 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = str(ROOT / 'build' / 'bench_cache' /
                                         'torch_extensions')
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def forbidden_modules():
    """Loaded modules whose top-level name is forbidden, whole-name."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a metric reader reads: the window's counts and times, and the
    trace's summary (None without --trace 1)."""

    def __init__(self, cell, window, setup_s, trace, itemsize):
        self.cell = cell
        self.units = window['units']
        self.evals = window['evals']
        self.grad_evals = window['grad_evals']
        self.window_s = window['seconds']
        self.setup_s = setup_s
        self.trace = trace
        self.itemsize = itemsize


def _power_limit():
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader,nounits'],
                             capture_output=True, text=True, timeout=20)
        return [float(v) for v in out.stdout.split()]
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool, device='cuda',
             t_start=None):
    """One run of `cell`: set-up, window, metrics and check. Returns the
    result's dict (with `checks` last)."""
    import torch

    from benchlib import drivers, manifest
    from benchlib.trace import events_from_profiler, summarize
    import reference

    t_start = time.time() if t_start is None else t_start
    device = torch.device(device)
    devices = list(dict.fromkeys(drivers.cards(cell.chips, device)))
    on_card = device.type == 'cuda'
    torch.set_num_threads(int(THREADS))
    with tempfile.TemporaryDirectory(prefix='bench_') as scratch:
        drv = drivers.driver(cell, seed, device, Path(scratch))
        if on_card:
            for d in devices:
                torch.empty(0, device=d)        # the card's context first
                torch.cuda.reset_peak_memory_stats(d)
        drv.setup()
        setup_s = time.time() - t_start
        summary = None
        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if on_card else [])
            with profile(activities=acts) as prof:
                with record_function(WINDOW_MARK):
                    window = drv.window(seconds)
            events = events_from_profiler(prof, WINDOW_MARK)
            del prof
            lo, hi = events.marks[WINDOW_MARK]
            summary = summarize(events, lo, hi,
                                [d.index or 0 for d in devices])
            del events
        else:
            window = drv.window(seconds)
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in devices) if on_card else 0
        run = Run(cell, window, setup_s, summary,
                  8 if cell.config.get('dtype', 'float64') == 'float64'
                  else 4)
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = manifest.metric_reader(m['name'])(run)
            if value is not None:
                metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
        drv.free()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        numbers = drv.check(reference.build(cell.config, device))
    checks = {k: {'value': v, 'limit': float(cell.limits[k])}
              for k, v in numbers.items()}
    failed = sum(1 for c in checks.values() if not c['value'] <= c['limit'])
    dev = {'platform': 'gpu' if on_card else 'cpu',
           'kind': torch.cuda.get_device_name(0) if on_card else 'cpu',
           'count': cell.chips, 'memory_peak_bytes': int(peak)}
    result = {'correct': failed == 0, 'attempted': int(drv.checked),
              'failed': failed, 'metrics': metrics, 'device': dev}
    if summary is not None:
        dev['busy_s'] = sum(summary.busy_s.values()) / len(summary.busy_s)
        dev['window_s'] = summary.window_s
        if on_card:
            dev['power_limit_w'] = _power_limit()
        top = sorted(summary.kernel_s_by_name.items(), key=lambda kv: -kv[1])
        result['breakdown'] = {
            'device_ops': [[n[:120], s] for n, s in top[:10]],
            'idle_gaps': [[n[:120], s] for n, s in summary.gaps[:10]]}
    result['checks'] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchlib.manifest import find_cell
    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'{args.workload} needs {cell.chips} CUDA device(s); this '
              f'machine has {n}', file=sys.stderr)
        return 2
    try:
        import victor_tpu_torch
    except ImportError as e:
        print(f'the program is not in this checkout: {e}', file=sys.stderr)
        return 2
    if ROOT not in Path(victor_tpu_torch.__file__).resolve().parents:
        print(f'victor_tpu_torch was loaded from {victor_tpu_torch.__file__}'
              f', not from the checkout at {ROOT}', file=sys.stderr)
        return 2

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      'cuda', T_START)
    found = forbidden_modules()
    if found:
        print(f'forbidden modules were loaded: {found}', file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Tracing and profiling hooks: the port of `victor_tpu/utils/profiling.py`.

- `timed(name)`: an accumulating wall-clock phase timer; register device
  outputs through the yielded handle to wait for them; results accumulate
  in `phase_times()` and log at DEBUG.
- `trace(logdir)`: `torch.profiler` over the block (CPU and, with a card,
  CUDA activity), written to `logdir` as a Chrome/TensorBoard trace.
- `throughput(fn, *args, reps, warmup)`: calls per second after warm-up,
  each rep ending on a device-to-host copy of every output tensor.
- `debug_nans(enable)`: raise `FloatingPointError` at the first op whose
  output holds a NaN, as `jax_debug_nans` does.
- `enable_persistent_cache(...)`: victor_tpu's signature; the port compiles
  nothing at run time but its CUDA kernels, which kernels/_build.py caches
  by source hash under build/.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

from .logging import get_logger

log = get_logger('profiling')
_PHASES: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)
_NAN_MODE = []


def _tensors(out):
    """Every tensor in `out` (a tensor, or nested tuples, lists and dicts of
    them)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)


def _force_host_transfer(out):
    """Copy every tensor of `out` to the host: the completion barrier of a
    timed rep. Every tensor is copied, not just the first, since an output
    assembled from several devices' work needs each synchronised."""
    for t in _tensors(out):
        t.detach().cpu()


@contextlib.contextmanager
def timed(name: str):
    """Accumulating wall-clock timer.

    Host-synchronous work needs only the block. For device work, register
    the outputs so that the timer waits for them (a device-to-host copy of
    each) before it stops the clock::

        with timed('eval') as watch:
            out = fn(theta)
            watch(out)
    """
    outs = []
    t0 = time.perf_counter()
    try:
        yield outs.append
    finally:
        for o in outs:
            _force_host_transfer(o)
        dt = time.perf_counter() - t0
        _PHASES[name] += dt
        _COUNTS[name] += 1
        log.debug('phase %s: %.3fs (total %.3fs over %d)', name, dt,
                  _PHASES[name], _COUNTS[name])


def phase_times() -> Dict[str, Dict[str, float]]:
    return {k: {'total_s': _PHASES[k], 'count': _COUNTS[k]}
            for k in sorted(_PHASES)}


def reset_phase_times() -> None:
    _PHASES.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (CPU activity, and CUDA
    activity when a card is present) and write the trace into `logdir`
    (`<host>_<pid>.<time>.pt.trace.json`, which TensorBoard's profiler
    plugin, Perfetto and chrome://tracing open). Yields the profiler, whose
    `key_averages()` sums the block by op and kernel."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
    log.info('profiler trace written to %s', logdir)


def throughput(fn, *args, reps: int = 5, warmup: int = 1):
    """(result, calls per second): runs `fn(*args)` `warmup` times, then
    times `reps` calls, each rep ended by a device-to-host copy of every
    output tensor (`_force_host_transfer`)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _force_host_transfer(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        _force_host_transfer(out)
    dt = (time.perf_counter() - t0) / reps
    return out, 1.0 / dt


class _DebugNans(torch.overrides.TorchFunctionMode):
    """Raises FloatingPointError when an op returns a floating tensor that
    holds a NaN (each check reads the device: a debugging aid, not for
    timed runs)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f'NaN in the output of {getattr(func, "__name__", func)}')
        return out


def debug_nans(enable: bool = True) -> None:
    """Turn on (or off) the NaN check on every torch op of this thread, as
    `jax_debug_nans` does. The check sees what goes through torch's Python
    function dispatch: outputs that the ctypes kernels under kernels/ write
    bypass it (a NaN they produce is caught at the next torch op that
    reads it)."""
    if enable and not _NAN_MODE:
        mode = _DebugNans()
        mode.__enter__()
        _NAN_MODE.append(mode)
    elif not enable and _NAN_MODE:
        _NAN_MODE.pop().__exit__(None, None, None)


def enable_persistent_cache(path: str | None = None,
                            min_compile_secs: float = 1.0,
                            force: bool = False) -> None:
    """victor_tpu's entry for its on-disk compilation cache, kept by name.

    The port compiles nothing at run time but its CUDA kernels, which
    kernels/_build.py already caches, by a hash of source and flags, under
    build/victor_tpu_torch/ (the first call on a fresh checkout builds
    them); there is nothing further to enable, and `path` and
    `min_compile_secs` are unused. Without a card (unless force=True) the
    call is a no-op, as victor_tpu's is on a CPU backend."""
    if not force and not torch.cuda.is_available():
        log.info('persistent compilation cache skipped (cpu backend)')
        return
    from ..kernels._build import BUILD_DIR
    log.info('CUDA kernels are cached by source hash in %s', BUILD_DIR)

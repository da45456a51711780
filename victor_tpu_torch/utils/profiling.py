"""Tracing and profiling hooks: the port of `victor_tpu/utils/profiling.py`.

- `span(name)`: a named range on the profiler's clock. Under a running
  `torch.profiler` it is recorded as a host operator of that name, in the
  same trace and on the same clock as the device's kernels, and its self
  time (less its child spans') adds up in `span_self_s()`; with no
  profiler running it is a shared null context (one attribute check). The
  program opens its spans at each layer boundary (the vocabulary below).
- `count(name, n, device)`, `counters()`, `total(name, device)`,
  `reset_counters()`: counts per name and per device index, under one
  lock, so that a thread per card can share them. The kernel wrappers
  count their launches here, and their bytes (`count_bytes`) while a
  profiler runs.
- `timed(name)`: an accumulating wall-clock phase timer that also opens a
  `span` of its name; register device outputs through the yielded handle
  to wait for them; results accumulate in `phase_times()` and log at DEBUG.
- `trace(logdir)`: `torch.profiler` over the block (CPU and, with a card,
  CUDA activity), written to `logdir` as a Chrome/TensorBoard trace.
- `throughput(fn, *args, reps, warmup)`: calls per second after warm-up,
  each rep ending on a device-to-host copy of every output tensor.
- `debug_nans(enable)`: raise `FloatingPointError` at the first op whose
  output holds a NaN, as `jax_debug_nans` does.
- `enable_persistent_cache(...)`: victor_tpu's signature; the port compiles
  nothing at run time but its CUDA kernels, which kernels/_build.py caches
  by source hash under build/.

To see where a run spends its time, wrap it in `trace(logdir)`::

    with profiling.trace('runs/trace'):
        run_smc(bundle, params, ...)

and open the `.pt.trace.json` written there in Perfetto (ui.perfetto.dev)
or chrome://tracing: the spans sit on the host thread's row over the
ATen operators they issued, and the kernels on each card's stream row
below, on one clock, so a gap in a card's row lines up with the span the
host was in while the card waited.

Spans (a `/` nests; `<i>` is a card's device index):

    smc.init                  a fresh SMC run's first evaluation
    smc.stage                 one tempering stage of `sampling.smc.run_smc`
      smc.temper              the lnL read, the d-beta bisection, the
                              weights and log Z
      smc.resample            the weighted Cholesky and the systematic
                              resample
      smc.move                one random-walk Metropolis move
      smc.checkpoint          the checkpoint write
    hmc.step                  one step of `sampling.hmc.staged_segment`
      hmc.leapfrog            one position update and its gradient
      hmc.adapt               acceptance, dual averaging, Welford, resets
    likelihood.chunk#<i>      the forward pass of one chunk, issued to card
                              i (`parallel.mesh.chunked`, `shard_map`)
    likelihood.backward       the `autograd.grad` of one batch
                              (`sampling.hmc.value_and_grad`)
    mesh.scatter              a batch's slices copied to their cards
    mesh.gather               the slices' results copied back and joined

While a profiler runs, each span's self time (its time less its child
spans') adds up by name in `span_self_s()`; the benchmark's
`sampler_host_pct` reads the `smc.*` and `hmc.*` ones.

Counters (per device index), and what reads them:

    hmc.leapfrogs             position updates of a batch of chains, in
                              HMC's and NUTS's trajectories (chip_smoke.py's
                              leapfrog rates)
    ppoly.launches            `ppoly_eval_cuda` launches
    ppoly.launches_multi      of those, with more than one channel
    ppoly.bwd_launches        `ppoly_eval_backward_cuda` launches
    ppoly.second_order_launches   the fused second-order kernel's launches
                              (two with d/dcoeffs), and the forward and
                              backward launches of the composed path
    dispersion.launches       `dispersion_final_cuda` launches
                              (the launch counts: chip_smoke.py, the
                              tests, `parallel.probe` and
                              tools/validate_posterior_torch.py)
    chebyshev.launches        `chebyshev_eval_cuda` launches (the Clenshaw
                              kernel: one per chunk of the fast streaming
                              mode, forward and in its gradient)
    chebyshev.transpose_launches
                              `chebyshev_transpose_cuda` launches (the
                              coefficients' gradient)
    chebyshev.plain_cuda      CUDA calls of the plain recurrence
                              (`chebyshev_eval_plain`,
                              `chebyshev_transpose_plain`), which the port
                              makes on CPU tensors only: 0 on the card's
                              paths (chip_smoke.py and the tests)
    ppoly.bytes               bytes of every `ppoly_*` launch made while a
                              profiler runs: each input tensor read once,
                              each output written once (the benchmark's
                              `ppoly_bytes_roofline_pct`)

No span and no counter reads the device or waits for it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from .logging import get_logger

log = get_logger('profiling')
_PHASES: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)
_NAN_MODE = []
#: what `span` returns while no profiler runs: one object, reused
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks the block as the range `name` in a running
    `torch.profiler` trace, on the clock of the device's kernels, and adds
    its self time to `span_self_s()`; with no profiler running, a shared
    null context. It reads nothing from the device and waits for nothing.

    The range is a function-scope record (a `cpu_op` event, as an ATen
    operator's), not a user-scope `record_function` range: the profiler
    mirrors a user-scope range onto each card's timeline over the kernels
    issued inside it, and a trace reader that cannot see an event's
    activity type (torch 2.11's) would count that image as device work."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


class _Span:
    """A span under a running profiler: the profiler's range, and the
    span's time on the host's clock less its child spans' (its self time),
    added to `span_self_s()` when it closes."""

    __slots__ = ('name', 'record', 't0', 'inner')

    def __init__(self, name: str):
        self.name = name
        self.record = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        stack = _open_spans()
        stack.append(self)
        self.inner = 0
        self.record.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.record.__exit__(*exc)
        stack = _open_spans()
        stack.pop()
        if stack:
            stack[-1].inner += dt
        _SELF_NS.add(self.name, dt - self.inner, 0)
        return False


def _open_spans() -> list:
    """This thread's open spans, innermost last."""
    stack = getattr(_LOCAL, 'spans', None)
    if stack is None:
        stack = _LOCAL.spans = []
    return stack


class Counters:
    """Counts by name and device index, under one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, int], int] = {}

    def add(self, name: str, n: int, index: int) -> None:
        key = (name, index)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def snapshot(self) -> Dict[str, Dict[int, int]]:
        with self._lock:
            items = list(self._counts.items())
        out: Dict[str, Dict[int, int]] = {}
        for (name, index), n in items:
            out.setdefault(name, {})[index] = n
        return out

    def total(self, name: str, index: Optional[int] = None) -> int:
        with self._lock:
            return sum(n for (k, i), n in self._counts.items()
                       if k == name and (index is None or i == index))

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()


_COUNTERS = Counters()
#: spans' self time in ns, by name (under device index 0)
_SELF_NS = Counters()
_LOCAL = threading.local()


def device_index(device) -> int:
    """The index a device counts under: a CUDA device's index, 0 for the
    host's device (and for None)."""
    if type(device) is int:
        return device
    return 0 if device is None else torch.device(device).index or 0


def count(name: str, n: int = 1, device=None) -> None:
    """Add n to the counter `name` of `device` (a `torch.device`, a device
    string or index; None counts under 0, as the host's device does)."""
    _COUNTERS.add(name, n, device if type(device) is int
                  else device_index(device))


def counters() -> Dict[str, Dict[int, int]]:
    """A copy of every counter: {name: {device index: count}}."""
    return _COUNTERS.snapshot()


def total(name: str, device=None) -> int:
    """The counter `name` summed over the devices, or of `device` alone
    (as `count` takes it) when one is given; 0 if nothing counted it."""
    return _COUNTERS.total(name, None if device is None
                           else device_index(device))


def span_self_s() -> Dict[str, float]:
    """Seconds by span name that the host spent in each span's own code
    (its time less its child spans') while a profiler ran: the spans are
    timed only then."""
    return {name: per[0] / 1e9 for name, per in _SELF_NS.snapshot().items()}


def reset_counters() -> None:
    """Clear the counters and the spans' self times."""
    _COUNTERS.clear()
    _SELF_NS.clear()


def nbytes(*tensors: Optional[torch.Tensor]) -> int:
    """The bytes of `tensors` (None counts 0): the byte rule's count of the
    inputs a kernel reads once and the outputs it writes once."""
    return sum(t.nbytes for t in tensors if t is not None)


def count_bytes(name: str, device, *tensors: Optional[torch.Tensor]) -> None:
    """Add `nbytes(*tensors)` to the counter `name` of `device` while a
    `torch.profiler` runs; otherwise nothing (one attribute check). Bytes
    are read only over a traced window, so an untraced launch does not
    pay for summing them."""
    if _autograd_profiler._is_profiler_enabled:
        count(name, nbytes(*tensors), device)


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
    """Accumulating wall-clock timer, and a `span` of the same name.

    Host-synchronous work needs only the block. For device work, register
    the outputs so that the timer waits for them (a device-to-host copy of
    each) before it stops the clock::

        with timed('eval') as watch:
            out = fn(theta)
            watch(out)
    """
    outs = []
    t0 = time.perf_counter()
    with span(name):
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

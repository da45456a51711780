"""The port's utils/profiling.py and utils/watchdog.py against
victor_tpu's (tests/test_utils_parallel.py's profiling tests and
tests/test_watchdog.py): the phase timer, throughput, the NaN check, the
trace, the persistent-cache entry, and the stall watchdog with its
heartbeat, its give-up and its transient-error classification."""

import json
import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from victor_tpu_torch import utils
from victor_tpu_torch.utils import (debug_nans, phase_times,
                                    reset_phase_times, throughput, timed,
                                    trace)
from victor_tpu_torch.utils.profiling import enable_persistent_cache

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestProfiling:
    def test_exports_match_victor_tpu(self):
        import victor_tpu.utils as jutils
        assert set(utils.__all__) == set(jutils.__all__)

    def test_timed_and_phase_times(self):
        reset_phase_times()
        with timed('unit-test-phase') as watch:
            watch((torch.arange(10.0).sum(), [torch.ones(3)]))
        with timed('unit-test-phase'):
            pass
        pt = phase_times()
        assert pt['unit-test-phase']['count'] == 2
        assert pt['unit-test-phase']['total_s'] >= 0
        reset_phase_times()
        assert phase_times() == {}

    def test_throughput(self):
        calls = []

        def f(x):
            calls.append(1)
            return (x * 2).sum(), {'y': x}
        out, calls_per_sec = throughput(f, torch.arange(100.0), reps=3,
                                        warmup=2)
        assert float(out[0]) == float(torch.arange(100.0).sum() * 2)
        assert calls_per_sec > 0 and len(calls) == 5

    def test_debug_nans_toggle(self):
        x = torch.tensor(0.0)
        try:
            debug_nans(True)
            debug_nans(True)              # idempotent, as the JAX flag is
            with pytest.raises(FloatingPointError, match='NaN'):
                x / 0.0 * 0.0
            assert float(torch.tensor(1.0) / 0.0) == float('inf')
            assert not torch.isnan(torch.ones(2)).any()
        finally:
            debug_nans(False)
        assert bool(torch.isnan(x / 0.0 * 0.0))
        debug_nans(False)                 # off twice is a no-op

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with trace(str(tmp_path)) as prof:
            torch.linalg.inv(torch.eye(3) * 2.0)
        files = [f for f in os.listdir(tmp_path) if f.endswith('.json')]
        assert len(files) == 1
        with open(tmp_path / files[0]) as f:
            events = json.load(f)['traceEvents']
        assert any('linalg_inv' in e.get('name', '') for e in events)
        assert any('linalg_inv' in e.key for e in prof.key_averages())

    def test_enable_persistent_cache(self, caplog):
        if torch.cuda.is_available():
            pytest.skip('a CUDA device is present')
        with caplog.at_level(logging.INFO, logger='victor_tpu_torch'):
            enable_persistent_cache()
        assert 'persistent compilation cache skipped (cpu backend)' \
            in caplog.text
        with caplog.at_level(logging.INFO, logger='victor_tpu_torch'):
            enable_persistent_cache('/nonexistent', 0.5, force=True)
        assert 'cached by source hash' in caplog.text
        assert not os.path.exists('/nonexistent')


class TestTransientClassification:
    def test_status_code_required_whatever_the_type(self):
        from victor_tpu.utils.watchdog import \
            is_transient_backend_error as jax_is_transient
        from victor_tpu_torch.utils.watchdog import \
            is_transient_backend_error

        class XlaRuntimeError(Exception):
            pass
        cases = [XlaRuntimeError('INVALID_ARGUMENT: shapes (3,) and (4,)'),
                 XlaRuntimeError('FAILED_PRECONDITION: device busy'),
                 RuntimeError('UNAVAILABLE: tunnel reset'),
                 RuntimeError('CUDA error: an illegal memory access'),
                 ValueError('bad config'),
                 RuntimeError('DEADLINE_EXCEEDED'), RuntimeError('ABORTED'),
                 RuntimeError('RESOURCE_EXHAUSTED: out of memory')]
        got = [is_transient_backend_error(e) for e in cases]
        assert got == [jax_is_transient(e) for e in cases]
        assert got == [False, True, True, False, False, True, True, True]


def _run(script, env_extra, timeout=60):
    env = dict(os.environ, **env_extra)
    env.pop('VICTOR_BENCH_ATTEMPT', None)
    return subprocess.run([sys.executable, '-c', script], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO)


class TestStallWatchdog:
    def test_heartbeat_rearms_past_the_window(self):
        """Run time 3x the window, each heartbeat inside it: the run
        completes."""
        script = textwrap.dedent("""
            import sys, time
            sys.path.insert(0, '.')
            from victor_tpu_torch.utils.watchdog import run_with_retry

            def main(heartbeat):
                for _ in range(6):
                    time.sleep(0.5)
                    heartbeat()
                print('COMPLETED', flush=True)

            run_with_retry(main, 'test')
        """)
        r = _run(script, {'VICTOR_BENCH_WATCHDOG': '1',
                          'VICTOR_BENCH_ATTEMPTS': '1'})
        assert r.returncode == 0, r.stderr
        assert 'COMPLETED' in r.stdout
        assert 'watchdog fired' not in r.stderr

    def test_stall_without_heartbeat_gives_up(self):
        """No heartbeat inside the window on the last attempt: on_giveup
        runs and the process exits 3."""
        script = textwrap.dedent("""
            import sys, time
            sys.path.insert(0, '.')
            from victor_tpu_torch.utils.watchdog import run_with_retry

            def main(heartbeat):
                time.sleep(30)

            run_with_retry(main, 'test',
                           on_giveup=lambda r: print('GIVEUP:' + r,
                                                     flush=True))
        """)
        r = _run(script, {'VICTOR_BENCH_WATCHDOG': '1',
                          'VICTOR_BENCH_ATTEMPTS': '1'})
        assert r.returncode == 3
        assert 'GIVEUP:' in r.stdout
        assert 'watchdog fired' in r.stderr

    def test_stall_reexecs_a_fresh_process(self, tmp_path):
        """A stall before the last attempt re-executes the process (its
        script and arguments) with the attempt counter raised; the fresh
        process completes."""
        script = tmp_path / 'stalls_once.py'
        script.write_text(textwrap.dedent(f"""
            import os, sys, time
            sys.path.insert(0, {REPO!r})
            from victor_tpu_torch.utils.watchdog import run_with_retry

            def main(heartbeat):
                if os.environ.get('VICTOR_BENCH_ATTEMPT', '1') == '1':
                    time.sleep(30)
                print('COMPLETED attempt',
                      os.environ['VICTOR_BENCH_ATTEMPT'], flush=True)

            run_with_retry(main, 'test')
        """))
        env = dict(os.environ, VICTOR_BENCH_WATCHDOG='1',
                   VICTOR_BENCH_ATTEMPTS='2')
        env.pop('VICTOR_BENCH_ATTEMPT', None)
        r = subprocess.run([sys.executable, str(script)], env=env,
                           capture_output=True, text=True, timeout=60,
                           cwd=REPO)
        assert r.returncode == 0, r.stderr
        assert 'COMPLETED attempt 2' in r.stdout
        assert 're-executing in a fresh process' in r.stderr

    def test_zero_arg_main_still_supported(self):
        script = textwrap.dedent("""
            import sys
            sys.path.insert(0, '.')
            from victor_tpu_torch.utils.watchdog import run_with_retry

            def main():
                print('COMPLETED', flush=True)

            run_with_retry(main, 'test')
        """)
        r = _run(script, {'VICTOR_BENCH_WATCHDOG': '5'})
        assert r.returncode == 0, r.stderr
        assert 'COMPLETED' in r.stdout

    def test_deterministic_error_is_not_retried(self):
        script = textwrap.dedent("""
            import sys
            sys.path.insert(0, '.')
            from victor_tpu_torch.utils.watchdog import run_with_retry

            def main():
                raise ValueError('INVALID_ARGUMENT: a deterministic fault')

            run_with_retry(main, 'test')
        """)
        r = _run(script, {'VICTOR_BENCH_WATCHDOG': '5',
                          'VICTOR_BENCH_ATTEMPTS': '3'})
        assert r.returncode == 1
        assert 'retrying' not in r.stderr
        assert 'deterministic fault' in r.stderr


def test_nan_mode_leaves_results_unchanged():
    """The mode only observes: a NaN-free computation gives the same bits
    with it on."""
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 5)))
    want = torch.linalg.solve(x @ x.T + torch.eye(4), x).sum(0)
    try:
        debug_nans(True)
        got = torch.linalg.solve(x @ x.T + torch.eye(4), x).sum(0)
    finally:
        debug_nans(False)
    assert torch.equal(got, want)

"""Silent-stall watchdog and fresh-process retry for long card runs: the
port of `victor_tpu/utils/watchdog.py`.

A process can stop making progress inside a native call that Python cannot
interrupt (a hung collective, a wedged device context), and a backend
failure on first touch can leave process-wide state behind; the only clean
retry is a fresh process. `run_with_retry` runs an entry point under a
watchdog thread that re-executes the process when no progress is reported
within its window.

Env knobs (victor_tpu's names, so one launch script sets both):
  VICTOR_BENCH_WATCHDOG  seconds without progress before the watchdog fires
                         (900)
  VICTOR_BENCH_ATTEMPTS  total fresh-process attempts (3)
  VICTOR_BENCH_ATTEMPT   internal: current attempt number
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional


def is_transient_backend_error(e: Exception) -> bool:
    """Only backend failures that carry a transient status code warrant a
    fresh-process retry. Deterministic failures (check failures, import
    errors, bad configs, shape errors whatever their exception type) must
    surface at once: retrying them multiplies the time to failure."""
    msg = str(e)
    return any(code in msg for code in
               ('FAILED_PRECONDITION', 'UNAVAILABLE', 'DEADLINE_EXCEEDED',
                'ABORTED', 'RESOURCE_EXHAUSTED'))


def run_with_retry(main: Callable[..., None], name: str,
                   on_giveup: Optional[Callable[[str], None]] = None) -> None:
    """Run `main()` under a stall watchdog with fresh-process retries.

    A watchdog THREAD, not SIGALRM: a Python signal handler runs only
    between bytecodes, so it cannot act while the main thread is blocked in
    a native call; a daemon thread can. On a stall it re-executes the
    process (sys.argv kept) until VICTOR_BENCH_ATTEMPTS is used up, then
    calls `on_giveup(reason)` (a machine-readable record of why there is no
    result) and exits 3.

    The watchdog measures STALL, not total run time: if `main` takes an
    argument it is called with a zero-argument `heartbeat`, and each
    heartbeat() re-arms the window. A caller should also heartbeat where it
    prints its result. `done` is checked again just before a re-exec or a
    give-up, so a result printed while the watchdog was deciding is not
    followed by a re-exec (victor_tpu checks it only before deciding).
    """
    done = threading.Event()
    seconds = int(os.environ.get('VICTOR_BENCH_WATCHDOG', 900))
    argv = [sys.executable] + [os.path.abspath(sys.argv[0])] + sys.argv[1:]
    last_progress = [time.monotonic()]

    def heartbeat() -> None:
        last_progress[0] = time.monotonic()

    def _giveup(reason: str) -> None:
        if on_giveup is not None:
            on_giveup(reason)
        os._exit(3)

    def _on_stall():
        attempt = int(os.environ.get('VICTOR_BENCH_ATTEMPT', 1))
        max_attempts = int(os.environ.get('VICTOR_BENCH_ATTEMPTS', 3))
        sys.stderr.write(f'{name}: watchdog fired after {seconds}s with '
                         f'no progress (attempt {attempt}/{max_attempts}); ')
        sys.stderr.flush()
        if attempt >= max_attempts:
            sys.stderr.write('giving up\n')
            sys.stderr.flush()
            if not done.is_set():
                _giveup(f'stall: no progress in {max_attempts} attempts '
                        '(watchdog)')
            return
        sys.stderr.write('re-executing in a fresh process\n')
        sys.stderr.flush()
        os.environ['VICTOR_BENCH_ATTEMPT'] = str(attempt + 1)
        if not done.is_set():
            os.execv(sys.executable, argv)

    def _watch():
        while True:
            stall = time.monotonic() - last_progress[0]
            if done.is_set():
                # main() completed: never re-exec (or exit) after the
                # result was printed
                return
            if stall >= seconds:
                _on_stall()
                return
            # short poll so that a heartbeat-re-armed deadline is honoured
            time.sleep(min(10.0, seconds - stall))

    dog = threading.Thread(target=_watch, daemon=True)
    dog.start()
    try:
        try:
            import inspect
            takes_heartbeat = len(
                inspect.signature(main).parameters) >= 1
        except (TypeError, ValueError):
            takes_heartbeat = False
        main(heartbeat) if takes_heartbeat else main()
        done.set()
    except Exception as e:                      # noqa: BLE001
        done.set()      # a late fire mid-retry would skip the clean path
        attempt = int(os.environ.get('VICTOR_BENCH_ATTEMPT', 1))
        if attempt >= int(os.environ.get('VICTOR_BENCH_ATTEMPTS', 3)) or \
                not is_transient_backend_error(e):
            raise
        sys.stderr.write(f'{name}: attempt {attempt} failed ({e!r}); '
                         'retrying in a fresh process\n')
        os.environ['VICTOR_BENCH_ATTEMPT'] = str(attempt + 1)
        time.sleep(10)
        os.execv(sys.executable, argv)

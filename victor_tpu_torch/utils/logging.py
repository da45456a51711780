"""Structured logging for the framework.

The reference's observability is bare `print()` statements
(victor/ccf_fit.py:402,408,449,478-479 etc.). Here every subsystem logs
through a namespaced stdlib logger (`victor_tpu_torch.<name>`) with a
single shared console handler, so verbosity is controllable
(VICTOR_TPU_TORCH_LOG=DEBUG|INFO|WARNING) and output is timestamped —
including sampling progress (acceptance, R-hat) streamed during runs.

Records also propagate to the root logger, so an application's or a test
harness's own logging setup sees every logger of the package; the console
handler then stays silent, so no line is printed twice.
"""

from __future__ import annotations

import logging
import os

_FORMAT = '%(asctime)s %(name)s %(levelname)s: %(message)s'
_configured = False


class _ConsoleHandler(logging.StreamHandler):
    """Prints a record only while the root logger has no handlers: when it
    has some, the record reaches them by propagation."""

    def emit(self, record):
        if not logging.getLogger().handlers:
            super().emit(record)


def _configure_root():
    global _configured
    if _configured:
        return
    root = logging.getLogger('victor_tpu_torch')
    if not root.handlers:
        handler = _ConsoleHandler()
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt='%H:%M:%S'))
        root.addHandler(handler)
    level = os.environ.get('VICTOR_TPU_TORCH_LOG', 'INFO').upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    return logging.getLogger(f'victor_tpu_torch.{name}')

"""Signal handlers printing a stack trace.

Reference: ``base/src/amg_signal.cu:28-120`` + ``stacktrace.h`` — hooks
SIGSEGV/SIGFPE/SIGINT/… to print a backtrace before dying
(``AMGX_install_signal_handler``, amgx_c.h:208).
"""
from __future__ import annotations

import signal
import sys
import traceback

from .logging import error_output

_HOOKED = (signal.SIGSEGV, signal.SIGFPE, signal.SIGABRT, signal.SIGINT,
           signal.SIGTERM)
_old_handlers = {}


def _handler(signum, frame):
    name = signal.Signals(signum).name
    error_output(f"Caught signal {signum} - {name}\n")
    error_output("".join(traceback.format_stack(frame)))
    # restore + re-raise so default semantics apply (amg_signal.cu behaviour)
    reset_signal_handlers()
    signal.raise_signal(signum)


def install_signal_handlers():
    for sig in _HOOKED:
        try:
            _old_handlers[sig] = signal.signal(sig, _handler)
        except (ValueError, OSError):
            pass  # non-main thread or unsupported signal


def reset_signal_handlers():
    for sig, old in list(_old_handlers.items()):
        try:
            signal.signal(sig, old)
        except (ValueError, OSError):
            pass
        _old_handlers.pop(sig, None)

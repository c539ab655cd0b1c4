"""Atomic file writes shared by the warm-start persistence layers.

Both the AOT executable store (``serve/aot.py``) and the runstate
counter file (``telemetry/runstate.py``) must never expose a torn file
to a concurrent reader — entries are written to a temp file in the
destination directory and moved into place with ``os.replace``.
"""
from __future__ import annotations

import os
import tempfile


def atomic_write(path: str, data: bytes):
    """Write ``data`` to ``path`` atomically (tmp + rename in the same
    directory).  Raises ``OSError`` on failure after removing the temp
    file — callers decide whether a failed write is fatal."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise

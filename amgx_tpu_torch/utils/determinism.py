"""Determinism constants (port of ``SESSION_SEED`` of
``amgx_tpu/utils/determinism.py``)."""
from __future__ import annotations

#: Tie-break seed used when ``determinism_flag`` is off: one fixed
#: per-process seed rather than the global numpy RNG state, so results
#: never depend on what else the process computed.
SESSION_SEED = 0x5EED

"""Cross-process cumulative cache-efficacy counters.

The in-process caches that make warm starts cheap — the
:class:`~amgx_tpu_torch.amg.device_setup.DeviceSetupEngine` plan cache
the kernel build directory (``native.py``: one ``.so`` per kernel
source and flag digest, under ``compile_cache_dir`` when set), the
warm-start store of setup plans (``serve/aot.py``) and the serving
layer's setup cache — keep their hit/miss
counters in process memory, so every restart reported a
fresh-looking cache even when the warm-start layer did its job.  This
module folds those counters into a small JSON state file
(``amgx_runstate.json`` next to the warm-start artifacts) and exposes
the CUMULATIVE view, which the telemetry meta header embeds (``cum``)
so ``bench_trend.py`` (and any trace reader) can show cache efficacy
across rounds, not just within one process.

Folding is delta-based: each :func:`fold` adds only the growth since
the previous fold of THIS process, so repeated flushes never
double-count.  The read-modify-write is best-effort across concurrent
processes (the state is observability, not correctness); writes are
atomic (tmp + rename) so readers never see a torn file.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from ..utils import fsio

STATE_BASENAME = "amgx_runstate.json"

_lock = threading.Lock()
_path: Optional[str] = None
#: counter values already folded into the file by this process
_folded: Dict[str, float] = {}


def configure(path: Optional[str]):
    """Point the state file at ``path`` (None disables)."""
    global _path
    with _lock:
        _path = os.path.abspath(path) if path else None


def configure_default(dirpath: str):
    """Adopt ``dirpath/amgx_runstate.json`` unless explicitly
    configured already — the warm-start knobs (``aot_store_dir`` /
    ``compile_cache_dir``) call this so the state rides next to the
    artifacts whose efficacy it records."""
    global _path
    if not dirpath:
        return
    with _lock:
        if _path is None:
            _path = os.path.join(os.path.abspath(dirpath),
                                 STATE_BASENAME)


def state_path() -> Optional[str]:
    return _path


def reset():
    """Forget the configured path and fold history (test isolation;
    the file on disk is untouched)."""
    global _path
    with _lock:
        _path = None
        _folded.clear()


def _live_counters() -> Dict[str, float]:
    """Current process totals of every tracked cache, gathered from the
    live objects (NOT the telemetry registry — these sources count even
    with telemetry off)."""
    out: Dict[str, float] = {}
    try:
        # the kernel build directory: a load that found its library
        # built is a hit, one that ran nvcc a miss (native.py)
        from .. import native
        cc = native.build_stats()
        out["compile_cache_hits"] = cc["hits"]
        out["compile_cache_misses"] = cc["misses"]
    except Exception:
        pass
    try:
        from ..serve import aot
        st = aot.store_stats()
        if st:
            out["aot_loads"] = st["loads"]
            out["aot_saves"] = st["saves"]
            out["aot_misses"] = st["misses"]
            out["aot_fallbacks"] = st["fallbacks"]
    except Exception:
        pass
    try:
        from ..amg.device_setup import engine_stats
        st = engine_stats()
        if st:
            out["device_plan_hits"] = st["hits"]
            out["device_plan_misses"] = st["misses"]
            out["device_plan_fallbacks"] = st["fallbacks"]
    except Exception:
        pass
    try:
        from ..serve.cache import cache_totals
        st = cache_totals()
        out["serve_cache_hits"] = st["hits"]
        out["serve_cache_misses"] = st["misses"]
        out["serve_cache_evictions"] = st["evictions"]
    except Exception:
        pass
    return out


def fold() -> Optional[dict]:
    """Fold this process's counter growth into the state file and
    return the cumulative state (``{"counters": {...}, "updated": t,
    "folds": n}``), or None when unconfigured.  Never raises."""
    with _lock:
        path = _path
        if path is None:
            return None
        live = _live_counters()
        delta = {k: v - _folded.get(k, 0) for k, v in live.items()
                 if v - _folded.get(k, 0)}
        try:
            state = _read(path)
            if delta:
                c = state.setdefault("counters", {})
                for k, v in delta.items():
                    c[k] = c.get(k, 0) + v
                state["updated"] = time.time()
                state["folds"] = int(state.get("folds", 0)) + 1
                _write(path, state)
            _folded.update(live)
            return state
        except Exception:
            return None


def cumulative() -> Optional[dict]:
    """The state file's current content without folding (readers)."""
    with _lock:
        if _path is None:
            return None
        try:
            return _read(_path)
        except Exception:
            return None


def _read(path: str) -> dict:
    try:
        with open(path) as f:
            state = json.load(f)
        if not isinstance(state, dict):
            state = {}
    except (OSError, ValueError):
        state = {}
    state.setdefault("counters", {})
    return state


def _write(path: str, state: dict):
    """Raises ``OSError`` on failure so :func:`fold` does NOT mark the
    delta as persisted — it retries the same growth next fold."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fsio.atomic_write(path,
                      json.dumps(state, sort_keys=True).encode("utf-8"))

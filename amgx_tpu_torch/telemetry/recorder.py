"""Event/span recorder: the telemetry ring buffer.

The reference ships operational visibility as a CPU profiler tree
(``amgx_timer.h`` ``Profiler_tree``) plus free-form prints; here the
same markers additionally produce *typed records* — spans, events and
metric samples — appended to a bounded in-memory ring buffer that the
exporters (:mod:`amgx_tpu_torch.telemetry.export`) serialise as JSONL or a
Prometheus snapshot.

Design constraints:

* **zero overhead when off** — every instrument's first action is a
  single attribute check (``_STATE.enabled``); nothing allocates,
  locks, or formats unless telemetry was enabled;
* **thread-safe** — hierarchy setup runs smoother setups on worker
  threads (utils/thread_manager.py), so appends take a lock and span
  nesting is tracked per thread;
* **bounded** — the ring drops the oldest records past
  ``telemetry_ring_size``; the global sequence number keeps growing so
  incremental flushes (:func:`amgx_tpu_torch.telemetry.export.flush_jsonl`)
  stay consistent across wraps.

Record schema (version :data:`SCHEMA_VERSION`, validated by
``export.validate_record`` and ``scripts/telemetry_check.py``): every
record carries ``seq`` (monotonic int), ``t`` (``time.perf_counter``
seconds), ``tid`` (thread id), ``kind`` and ``name``.  Span records add
``sid``/``parent`` nesting ids (``span_end`` adds ``dur``); events add
``attrs``; metric samples add ``labels`` and ``value``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

#: JSONL schema version — bump when record fields change shape.
SCHEMA_VERSION = 1

DEFAULT_RING_SIZE = 65536


class _State:
    __slots__ = ("enabled", "ring", "ring_size", "lock", "seq", "dropped")

    def __init__(self):
        self.enabled = False
        self.ring_size = DEFAULT_RING_SIZE
        self.ring = collections.deque(maxlen=self.ring_size)
        self.lock = threading.Lock()
        self.seq = 0
        #: records evicted by ring overflow (cumulative) — a truncated
        #: trace is detectable instead of silently undercounting
        self.dropped = 0


_STATE = _State()
_sid_counter = itertools.count(1)
_tls = threading.local()


def _span_stack() -> list:
    stk = getattr(_tls, "stack", None)
    if stk is None:
        stk = _tls.stack = []
    return stk


def is_enabled() -> bool:
    return _STATE.enabled


def enable(ring_size: Optional[int] = None):
    """Turn recording on (idempotent); optionally resize the ring.

    The port's counterparts of the JAX package's recompile counters need
    no hook: kernel builds (``native.build_all``) count
    ``amgx_jit_compile_total`` and CUDA graph captures
    (``utils/cuda_graph.py``) ``amgx_jit_trace_total`` where they
    happen, once recording is on.
    """
    if ring_size is not None and int(ring_size) > 0 and \
            int(ring_size) != _STATE.ring_size:
        with _STATE.lock:
            old = list(_STATE.ring)
            _STATE.ring_size = int(ring_size)
            _STATE.ring = collections.deque(old, maxlen=_STATE.ring_size)
    _STATE.enabled = True


def disable():
    _STATE.enabled = False


def records() -> List[dict]:
    """Snapshot of the ring buffer contents (oldest first)."""
    with _STATE.lock:
        return list(_STATE.ring)


def clear():
    """Drop buffered records.  The sequence number keeps growing so
    incremental flush bookkeeping stays monotonic."""
    with _STATE.lock:
        _STATE.ring.clear()


def dropped_count() -> int:
    """Records evicted by ring overflow since process start (or the last
    :func:`reset_dropped`).  Exporters surface this so a truncated trace
    is detectable — the deque otherwise drops the oldest silently."""
    return _STATE.dropped


def reset_dropped():
    """Zero the overflow counter (test/bench isolation, via
    ``telemetry.reset``)."""
    with _STATE.lock:
        _STATE.dropped = 0


def _jsonable(v: Any):
    """Coerce a value into something ``json.dumps`` accepts: numpy
    scalars → python numbers, sequences element-wise, everything
    unknown → ``str``."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:
        import numpy as np
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        if isinstance(v, np.ndarray):
            return [_jsonable(x) for x in v.tolist()]
    except Exception:
        pass
    return str(v)


def _append(rec: dict):
    with _STATE.lock:
        _STATE.seq += 1
        rec["seq"] = _STATE.seq
        if len(_STATE.ring) == _STATE.ring.maxlen:
            _STATE.dropped += 1       # the deque evicts its oldest record
        _STATE.ring.append(rec)


# ------------------------------------------------------------------- spans
def span_begin(name: str, attrs: Optional[dict] = None) -> Optional[int]:
    """Open a span; returns its id, or None when recording is off (the
    matching :func:`span_end` then no-ops).  Called by
    ``utils.profiler.ProfilerTree.scope`` so every existing
    ``cpu_profiler`` marker doubles as a telemetry span."""
    if not _STATE.enabled:
        return None
    sid = next(_sid_counter)
    stk = _span_stack()
    parent = stk[-1][0] if stk else None
    t = time.perf_counter()
    stk.append((sid, t))
    _append({"kind": "span_begin", "name": str(name), "sid": sid,
             "parent": parent, "t": t, "tid": threading.get_ident(),
             "attrs": _jsonable(attrs or {})})
    return sid


def span_end(sid: Optional[int], name: str):
    if sid is None:
        return
    stk = _span_stack()
    t1 = time.perf_counter()
    t0 = None
    # pop to the matching id — robust against a begin/end imbalance from
    # an instrument raising mid-span
    while stk:
        s, t = stk.pop()
        if s == sid:
            t0 = t
            break
    if not _STATE.enabled:
        return
    parent = stk[-1][0] if stk else None
    _append({"kind": "span_end", "name": str(name), "sid": sid,
             "parent": parent, "t": t1,
             "dur": (t1 - t0) if t0 is not None else 0.0,
             "tid": threading.get_ident()})


_profiler_scope = None


@contextlib.contextmanager
def span(name: str, **attrs):
    """Phase marker: context manager that aggregates into the CPU
    profiler tree (``utils/profiler.py`` — including the optional
    ``torch.profiler.record_function`` / NVTX forwarding) AND, when telemetry is
    enabled, records ``span_begin``/``span_end`` ring records with
    ``attrs``."""
    global _profiler_scope
    if _profiler_scope is None:
        # bound lazily: utils.profiler imports this module at load time
        from ..utils.profiler import profiler_tree
        _profiler_scope = profiler_tree
    with _profiler_scope().scope(str(name), _attrs=attrs or None) as entry:
        yield entry


# ------------------------------------------------------------------ events
def event(name: str, **attrs):
    """Point-in-time record (divergence, per-iteration residual, ...)."""
    if not _STATE.enabled:
        return
    stk = _span_stack()
    _append({"kind": "event", "name": str(name),
             "sid": stk[-1][0] if stk else None,
             "t": time.perf_counter(), "tid": threading.get_ident(),
             "attrs": _jsonable(attrs)})


def metric_sample(kind: str, name: str, value, labels: Dict[str, Any]):
    """Ring record of one metric instrument firing (kept alongside the
    aggregated registry so JSONL traces carry the raw samples)."""
    if not _STATE.enabled:
        return
    _append({"kind": kind, "name": str(name),
             "t": time.perf_counter(), "tid": threading.get_ident(),
             "labels": {str(k): _jsonable(v) for k, v in labels.items()},
             "value": _jsonable(value)})


# ----------------------------------------------------------------- capture
class Capture:
    """Scoped collector handed out by :func:`capture`: the records
    appended while the scope was active, plus small query helpers so
    tests and bench can assert on them."""

    def __init__(self):
        self.records: List[dict] = []
        #: True when the scope produced more records than the ring
        #: holds — the oldest were evicted and aggregates undercount
        self.truncated = False
        #: ring-overflow evictions that happened during the scope
        self.dropped = 0

    def kind(self, kind: str) -> List[dict]:
        return [r for r in self.records if r["kind"] == kind]

    def spans(self, name: Optional[str] = None) -> List[dict]:
        """Completed spans (``span_end`` records carry ``dur``)."""
        return [r for r in self.records if r["kind"] == "span_end"
                and (name is None or r["name"] == name)]

    def events(self, name: Optional[str] = None) -> List[dict]:
        return [r for r in self.records if r["kind"] == "event"
                and (name is None or r["name"] == name)]

    def metric_records(self, name: Optional[str] = None,
                       kind: Optional[str] = None) -> List[dict]:
        return [r for r in self.records
                if r["kind"] in ("counter", "gauge", "hist")
                and (kind is None or r["kind"] == kind)
                and (name is None or r["name"] == name)]

    def counter_totals(self, name: str,
                       label: Optional[str] = None) -> dict:
        """Summed counter increments, keyed by one label's value (or by
        the full sorted label tuple when ``label`` is None)."""
        out: Dict[Any, float] = {}
        for r in self.metric_records(name, kind="counter"):
            key = (r["labels"].get(label) if label is not None
                   else tuple(sorted(r["labels"].items())))
            out[key] = out.get(key, 0) + r["value"]
        return out

    def counter_total(self, name: str, **labels) -> float:
        tot = 0.0
        for r in self.metric_records(name, kind="counter"):
            if all(r["labels"].get(k) == _jsonable(v)
                   for k, v in labels.items()):
                tot += r["value"]
        return tot

    def gauge_last(self, name: str, **labels):
        val = None
        for r in self.metric_records(name, kind="gauge"):
            if all(r["labels"].get(k) == _jsonable(v)
                   for k, v in labels.items()):
                val = r["value"]
        return val

    def summary(self) -> dict:
        """Generic aggregate of the captured records — span totals,
        counter sums and last gauge values — for quick inspection
        (consumers wanting a bespoke shape, like bench's per-case
        packs/phases block, build it from the query helpers above)."""
        spans: Dict[str, dict] = {}
        for r in self.spans():
            s = spans.setdefault(r["name"], {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] = round(s["total_s"] + r["dur"], 6)
        counters: Dict[str, float] = {}
        gauges: Dict[str, Any] = {}
        for r in self.metric_records():
            key = r["name"]
            if r["labels"]:
                key += "{" + ",".join(f"{k}={v}" for k, v in
                                      sorted(r["labels"].items())) + "}"
            if r["kind"] == "counter":
                counters[key] = counters.get(key, 0) + r["value"]
            elif r["kind"] == "gauge":
                gauges[key] = r["value"]
        return {"spans": spans, "counters": counters, "gauges": gauges}


@contextlib.contextmanager
def capture(ring_size: Optional[int] = None):
    """Scoped collection: enables telemetry for the duration (restoring
    the previous state on exit) and yields a :class:`Capture` whose
    ``records`` are those appended inside the scope.  A scope that
    outgrows the ring loses its OLDEST records to eviction — the
    collector then sets ``truncated`` so consumers know the aggregates
    undercount (size the ring via the argument when capturing large
    runs).  A ring resize requested here is scoped: the previous size
    is restored on exit."""
    prev = _STATE.enabled
    prev_size = _STATE.ring_size
    enable(ring_size)
    with _STATE.lock:
        seq0 = _STATE.seq
        dropped0 = _STATE.dropped
    cap = Capture()
    try:
        yield cap
    finally:
        with _STATE.lock:
            cap.records = [r for r in _STATE.ring if r["seq"] > seq0]
            produced = _STATE.seq - seq0
            cap.dropped = _STATE.dropped - dropped0
            if _STATE.ring_size != prev_size:
                _STATE.ring_size = prev_size
                _STATE.ring = collections.deque(_STATE.ring,
                                                maxlen=prev_size)
        cap.truncated = len(cap.records) < produced
        if not prev:
            _STATE.enabled = False

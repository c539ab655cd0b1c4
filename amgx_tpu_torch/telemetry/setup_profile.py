"""Setup profiler: attribute AMG setup wall time to hardware terms
(port of ``amgx_tpu/telemetry/setup_profile.py``).

The ``cpu_profiler`` markers only say which coarse phase the wall
clock sat in — not whether that time was a kernel **build**, device
**execute**, host↔device **transfer**, or host-side SciPy work.  This
module turns the same markers into a per-level × per-component phase
tree with an execute/compile/transfer/host split per phase.

How attribution works:

* **phases** — :func:`phase` context managers at the setup marker sites
  (strength / selector / interpolation / rap / upload / smoother_setup
  / coarse_solver / resetup_plan, plus the device-setup phases), under
  the JAX package's names.  Nesting is tracked per thread; each
  finished phase emits a ``setup_phase`` ring event carrying wall and
  **self** (exclusive) seconds;
* **compile** — what a backend compile and a jaxpr trace are to the JAX
  package, a kernel build (``nvcc``, ``native.py``) and a CUDA graph
  capture (``utils/cuda_graph.py``) are to the port
  (:func:`note_duration`): each
  lands on the innermost open phase of the thread that ran it, as
  ``compile_s`` and ``trace_s``;
* **transfer** — :func:`transfer` wraps the blocking upload/download
  sites with byte and call counts per phase;
* **memory** — the allocator's bytes in use on the card
  (``torch.cuda.memory_allocated``) are sampled at phase boundaries, so
  every profiled setup on the card reports its high-water mark as
  ``amgx_setup_mem_watermark_bytes`` (not sampled on the CPU).

The remainder of a phase's self time after compile/trace/transfer is
**execute** for device-sync phases (``kind="device"``) and **host** for
host-algorithm phases.

Gating contract: off by default; every instrument's first action is one
attribute check (:func:`phase` returns a shared no-op context manager
when disabled), and with the ``setup_profile`` knob off the setup path
runs exactly as without it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional

from . import metrics, recorder

#: the canonical per-level setup components (host classical/aggregation
#: algorithms); call sites may add others (device_fine, dia_derive, ...)
COMPONENTS = ("strength", "selector", "interpolation", "rap", "upload",
              "smoother_setup", "coarse_solver", "resetup_plan")

#: phases of the device setup engine (amg/device_setup/): ``spgemm`` is
#: the host symbolic plan build (cache-miss only), ``device_rap`` the
#: jitted numeric Galerkin pass — both nest inside the level's ``rap``
#: phase, so a dominant host-side rap reads "fell back", not "missing"
DEVICE_SETUP_COMPONENTS = ("spgemm", "device_rap")

#: compile share of setup past which the doctor recommends the
#: persistent compilation cache / AOT lowering
COMPILE_HINT = 0.4
#: transfer share of setup past which the doctor calls setup wire-bound
TRANSFER_HINT = 0.3
#: self-share of one phase past which it is called dominant
DOMINANT_HINT = 0.25
#: blocking uploads per setup past which batching earns a hint
UPLOAD_DRAIN_HINT = 8


class _State:
    __slots__ = ("enabled", "lock", "profile")

    def __init__(self):
        self.enabled = False
        self.lock = threading.Lock()
        #: the active profiled setup (one at a time; nested/concurrent
        #: profile_setup calls no-op and their phases fold into it)
        self.profile: Optional[dict] = None


_STATE = _State()
_tls = threading.local()


def _stack() -> list:
    stk = getattr(_tls, "stack", None)
    if stk is None:
        stk = _tls.stack = []
    return stk


def is_enabled() -> bool:
    return _STATE.enabled


def enable():
    """Turn the setup profiler on (idempotent).  Also enables the
    telemetry recorder — phase records live in the same ring the JSONL
    exporters flush."""
    if _STATE.enabled:
        return
    recorder.enable()
    _STATE.enabled = True


def disable():
    _STATE.enabled = False


def reset():
    """Drop the active profile and this thread's phase stack (test
    isolation)."""
    with _STATE.lock:
        _STATE.profile = None
    _tls.stack = []


def _device_bytes() -> Optional[int]:
    """The card's allocated bytes right now; None on a process that has
    not initialised CUDA (a CPU setup)."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return int(torch.cuda.memory_allocated())


class _NullPhase:
    """Shared no-op context manager: the entire disabled-path cost of a
    :func:`phase`/:func:`transfer` call site."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullPhase()


def null() -> _NullPhase:
    """The shared no-op context manager (for call sites that gate on
    their own condition, e.g. a non-toplevel setup)."""
    return _NULL


class _Phase:
    __slots__ = ("component", "level", "kind", "depth", "parent",
                 "t0", "child_wall", "compile_s", "trace_s",
                 "n_compiles", "transfer_s", "transfer_bytes",
                 "transfers")

    def __init__(self, component: str, level, kind: str):
        self.component = str(component)
        self.level = None if level is None else int(level)
        self.kind = kind
        self.child_wall = 0.0
        self.compile_s = 0.0
        self.trace_s = 0.0
        self.n_compiles = 0
        self.transfer_s = 0.0
        self.transfer_bytes = 0
        self.transfers = 0

    def __enter__(self):
        stk = _stack()
        self.depth = len(stk)
        self.parent = stk[-1].name() if stk else None
        stk.append(self)
        self.t0 = time.perf_counter()
        return self

    def name(self) -> str:
        return self.component if self.level is None \
            else f"{self.component}@L{self.level}"

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t0
        stk = _stack()
        # pop to self — robust against an instrument raising mid-phase
        while stk:
            if stk.pop() is self:
                break
        if stk:
            stk[-1].child_wall += wall
        self_s = max(wall - self.child_wall, 0.0)
        # compile/trace/transfer land on the INNERMOST phase, so the
        # per-phase overheads are disjoint; the rest of the exclusive
        # time is device execute or host work by the phase's kind
        own = self.compile_s + self.trace_s + self.transfer_s
        rest = max(self_s - own, 0.0)
        rec = {
            "component": self.component, "level": self.level,
            "kind": self.kind, "depth": self.depth,
            "parent": self.parent, "wall_s": round(wall, 6),
            "self_s": round(self_s, 6),
            "compile_s": round(self.compile_s, 6),
            "trace_s": round(self.trace_s, 6),
            "n_compiles": self.n_compiles,
            "transfer_s": round(self.transfer_s, 6),
            "transfer_bytes": int(self.transfer_bytes),
            "transfers": int(self.transfers),
            ("execute_s" if self.kind == "device" else "host_s"):
                round(rest, 6),
        }
        prof = _STATE.profile
        if prof is not None:
            mem = _device_bytes()
            if mem is not None:
                rec["mem_bytes"] = mem
                with _STATE.lock:
                    if _STATE.profile is prof:
                        prof["mem_max"] = max(prof["mem_max"], mem)
            with _STATE.lock:
                if _STATE.profile is prof:
                    prof["frames"].append(
                        dict(rec, tid=threading.get_ident()))
        recorder.event("setup_phase", **rec)
        # HBM-ledger phase boundary (rate-limited by memledger_sample_s;
        # one attribute check when the ledger is off)
        from . import memledger
        memledger.maybe_sample(phase=self.component)
        return False


def phase(component: str, level=None, kind: str = "host"):
    """Setup phase marker.  ``kind="device"`` declares the phase a
    device-sync point (its unattributed remainder is execute time, not
    host time).  One attribute check when the profiler is off."""
    if not _STATE.enabled:
        return _NULL
    return _Phase(component, level, kind)


class _Transfer:
    __slots__ = ("nbytes", "count", "tkind", "t0")

    def __init__(self, nbytes: int, count: int, tkind: str):
        self.nbytes = int(nbytes)
        self.count = int(count)
        self.tkind = tkind

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            return False
        note_transfer(self.nbytes, time.perf_counter() - self.t0,
                      count=self.count, kind=self.tkind)
        return False


def transfer(nbytes: int, count: int = 1, kind: str = "upload"):
    """Wrap one blocking host↔device transfer (``device_put`` batch,
    tail download): bytes, call count and elapsed seconds accrue to the
    innermost open phase and the setup totals."""
    if not _STATE.enabled:
        return _NULL
    return _Transfer(nbytes, count, kind)


def note_transfer(nbytes: int, seconds: float, count: int = 1,
                  kind: str = "upload"):
    if not _STATE.enabled:
        return
    stk = _stack()
    if stk:
        f = stk[-1]
        f.transfer_s += seconds
        f.transfer_bytes += int(nbytes)
        f.transfers += int(count)
    prof = _STATE.profile
    if prof is not None:
        with _STATE.lock:
            if _STATE.profile is prof:
                prof["transfer_s"] += seconds
                prof["transfer_bytes"] += int(nbytes)
                prof[kind + "s"] = prof.get(kind + "s", 0) + int(count)
    metrics.counter_inc("amgx_setup_transfer_bytes_total", int(nbytes),
                        kind=kind)
    metrics.counter_inc("amgx_setup_transfers_total", int(count),
                        kind=kind)


def note_duration(is_compile: bool, seconds: float):
    """One kernel-build (``is_compile``) or graph-capture duration,
    attributed to the innermost open phase of the thread that ran it —
    both run synchronously on that thread, so the attribution is
    exact."""
    if not _STATE.enabled:
        return
    stk = _stack()
    if stk:
        f = stk[-1]
        if is_compile:
            f.compile_s += seconds
            f.n_compiles += 1
        else:
            f.trace_s += seconds
        return
    prof = _STATE.profile
    if prof is not None:
        with _STATE.lock:
            if _STATE.profile is prof:
                key = "unattributed_compile_s" if is_compile \
                    else "unattributed_trace_s"
                prof[key] = prof.get(key, 0.0) + seconds


# --------------------------------------------------------- setup scope
class _ProfileScope:
    __slots__ = ("solver", "prof")

    def __init__(self, solver: str):
        self.solver = solver

    def __enter__(self):
        # sample memory BEFORE starting the clock: the walk is cheap
        # but not free, and it belongs to the profiler, not the setup
        mem0 = _device_bytes() or 0
        prof = {"solver": self.solver, "t0": time.perf_counter(),
                "owner_tid": threading.get_ident(), "frames": [],
                "transfer_s": 0.0, "transfer_bytes": 0,
                "mem_max": mem0}
        with _STATE.lock:
            if _STATE.profile is None:
                _STATE.profile = self.prof = prof
            else:
                self.prof = None     # a profile is already running
        return self

    def __exit__(self, *exc):
        prof = self.prof
        if prof is None:
            return False
        wall = time.perf_counter() - prof["t0"]
        with _STATE.lock:
            if _STATE.profile is prof:
                _STATE.profile = None
        mem = _device_bytes()
        if mem is not None:
            prof["mem_max"] = max(prof["mem_max"], mem)
        if exc and exc[0] is not None:
            return False      # a failed setup emits no summary
        self._emit(prof, wall)
        return False

    def _emit(self, prof: dict, wall: float):
        frames = prof["frames"]
        owner = prof["owner_tid"]
        # coverage: owner-thread depth-0 phases tile the setup wall;
        # worker-thread phases (streamed uploads, smoother tasks)
        # OVERLAP it and must not count, or coverage could exceed 1
        covered = sum(f["wall_s"] for f in frames
                      if f["depth"] == 0 and f["tid"] == owner)
        own = [f for f in frames if f["tid"] == owner]
        # the wall-clock split counts the OWNER thread only, so
        # compile + transfer + execute + host ≤ wall; worker-thread
        # time (streamed uploads, smoother-setup tasks) overlaps the
        # owner's wait phases and is reported separately
        compile_s = sum(f["compile_s"] for f in own) \
            + prof.get("unattributed_compile_s", 0.0)
        trace_s = sum(f["trace_s"] for f in own) \
            + prof.get("unattributed_trace_s", 0.0)
        worker_compile_s = sum(f["compile_s"] for f in frames
                               if f["tid"] != owner)
        # same owner-only rule for transfer: a streamed worker upload
        # overlaps the owner's drain wait (already execute time there)
        # — the global prof counter would double-count it in the split
        transfer_s = sum(f["transfer_s"] for f in own)
        worker_transfer_s = max(prof["transfer_s"] - transfer_s, 0.0)
        execute_s = sum(f.get("execute_s", 0.0) for f in own)
        host_s = sum(f.get("host_s", 0.0) for f in own)
        summary = {
            "solver": prof["solver"], "wall_s": round(wall, 6),
            "coverage": round(min(covered / wall, 1.0), 4)
            if wall > 0 else 0.0,
            "compile_s": round(compile_s, 6),
            "trace_s": round(trace_s, 6),
            "transfer_s": round(transfer_s, 6),
            "transfer_bytes": int(prof["transfer_bytes"]),
            "uploads": int(prof.get("uploads", 0)),
            "downloads": int(prof.get("downloads", 0)),
            "execute_s": round(execute_s, 6),
            "host_s": round(host_s, 6),
            "worker_compile_s": round(worker_compile_s, 6),
            "worker_transfer_s": round(worker_transfer_s, 6),
            "unattributed_compile_s": round(
                prof.get("unattributed_compile_s", 0.0), 6),
            "mem_watermark_bytes": int(prof["mem_max"]),
            "n_phases": len(frames), "owner_tid": owner,
        }
        recorder.event("setup_profile", **summary)
        metrics.gauge_set("amgx_setup_compile_seconds", compile_s)
        metrics.gauge_set("amgx_setup_trace_seconds", trace_s)
        metrics.gauge_set("amgx_setup_transfer_seconds", transfer_s)
        metrics.gauge_set("amgx_setup_mem_watermark_bytes",
                          prof["mem_max"])
        # per-component exclusive-seconds gauges: cleared first so a
        # shallower re-setup can't leave stale components behind
        metrics.registry().gauge_clear("amgx_setup_phase_seconds")
        by_comp: Dict[str, float] = {}
        for f in frames:
            by_comp[f["component"]] = by_comp.get(f["component"], 0.0) \
                + f["self_s"]
        for comp, s in by_comp.items():
            metrics.gauge_set("amgx_setup_phase_seconds", s,
                              component=comp)


def profile_setup(solver: str = "?"):
    """Scope one top-level solver setup: frames collected inside become
    the ``setup_profile`` summary event + the ``amgx_setup_*`` gauges.
    No-op (shared null context) when the profiler is off; re-entrant
    calls fold into the outer profile."""
    if not _STATE.enabled:
        return _NULL
    return _ProfileScope(solver)


# ------------------------------------------------------------ analysis
def analyze(records: Iterable[dict]) -> Optional[dict]:
    """Reduce ``setup_phase``/``setup_profile`` ring records (or JSONL
    lines read back) to the doctor/bench view: the summary of the LAST
    profiled setup plus its ranked phase list.  None when the trace
    carries no setup-profile data."""
    pending: List[dict] = []
    phases: List[dict] = []
    summary = None
    for r in records:
        if r.get("kind") != "event":
            continue
        if r["name"] == "setup_phase":
            pending.append(dict(r["attrs"], tid=r.get("tid")))
        elif r["name"] == "setup_profile":
            # a summary closes the setup whose phases PRECEDE it — keep
            # the newest completed setup; phases after the last summary
            # belong to an unfinished one and are dropped
            summary = dict(r["attrs"])
            phases, pending = pending, []
    if summary is None:
        phases = pending
    if summary is None and not phases:
        return None
    owner = (summary or {}).get("owner_tid")
    for p in phases:
        p["name"] = p["component"] if p.get("level") is None \
            else f"{p['component']}@L{p['level']}"
        # ANY frame off the owner thread overlaps the owner's wall —
        # including nested ones (a worker smoother-setup's inner pack)
        p["overlapped"] = owner is not None and p.get("tid") is not None \
            and p["tid"] != owner
    total = (summary or {}).get("wall_s") or \
        sum(p["wall_s"] for p in phases if p.get("depth") == 0) or 0.0
    ranked = sorted(phases, key=lambda p: -p["self_s"])
    for p in ranked:
        p["share"] = round(p["self_s"] / total, 4) if total else 0.0
    by_comp: Dict[str, dict] = {}
    for p in phases:
        d = by_comp.setdefault(p["component"],
                               {"self_s": 0.0, "compile_s": 0.0,
                                "transfer_bytes": 0, "count": 0})
        d["self_s"] = round(d["self_s"] + p["self_s"], 6)
        d["compile_s"] = round(d["compile_s"] + p["compile_s"], 6)
        d["transfer_bytes"] += p.get("transfer_bytes", 0)
        d["count"] += 1
    return {"summary": summary, "phases": ranked,
            "components": by_comp, "total_s": total}


def summarize(analysis: Optional[dict], top: int = 4) -> Optional[dict]:
    """Compact embedding for bench JSON / trend tables: totals, the
    compile share, and the top-``top`` phases by exclusive time."""
    if not analysis:
        return None
    s = analysis.get("summary") or {}
    total = analysis["total_s"]
    out = {
        "total_s": round(total, 4),
        "compile_s": round(s.get("compile_s", 0.0), 4),
        "transfer_s": round(s.get("transfer_s", 0.0), 4),
        "transfer_bytes": int(s.get("transfer_bytes", 0)),
        "execute_s": round(s.get("execute_s", 0.0), 4),
        "host_s": round(s.get("host_s", 0.0), 4),
        "coverage": s.get("coverage"),
        "mem_watermark_bytes": s.get("mem_watermark_bytes"),
        # compile work a persistent cache would remove: owner-thread
        # compile plus the worker-thread compiles it waits on, capped
        "compile_share": round(min(
            (s.get("compile_s", 0.0) + s.get("worker_compile_s", 0.0))
            / total, 1.0), 4) if total else None,
        # filter overlapped BEFORE slicing: worker frames can out-rank
        # every owner phase and would otherwise empty the list
        "top": [{"name": p["name"], "self_s": round(p["self_s"], 4),
                 "share": p["share"]}
                for p in [q for q in analysis["phases"]
                          if not q.get("overlapped")][:top]],
    }
    return out

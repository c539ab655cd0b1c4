"""Measured (not modelled) interior-vs-halo overlap from profiler traces
(port of ``amgx_tpu/telemetry/overlap.py``).

:func:`costmodel.dist_overlap` predicts how much of a level's halo
exchange the interior SpMV can hide from shape arithmetic alone.  This
module replaces that prediction with TRUTH when a ``torch.profiler``
capture (``export_chrome_trace``, read through :mod:`.proftrace`) of a
run with communication is available: it classifies device ops into
communication (NCCL all-reduce / all-gather / reduce-scatter / send-recv
kernels, and the collective names of other traces) vs compute, and
measures the fraction of communication wall time that ran
CONCURRENTLY with compute on the same device — the achieved overlap.

Events refined through :func:`measured_event` carry ``measured=True``
so every downstream consumer (doctor, perf gate, dashboards) can tell
an honest measurement from a model (the ``dist_overlap`` schema's
``measured`` bool).

Host-side file parsing only — safe without any profiler plugin
installed; every entry point degrades to ``None`` when the trace has
no communication ops (the port's one-card shard exchange is gather
kernels inside one process, so a one-card run keeps the modelled
numbers).
"""
from __future__ import annotations

import re
from typing import Iterable, List, Optional

from . import proftrace

#: device-op names that are communication: collective names and NCCL's
#: kernels (``ncclDevKernel_AllReduce_…``, ``ncclKernel_SendRecv…``)
COMM_RE = re.compile(
    r"all[-_]?reduce|all[-_]?gather|reduce[-_]?scatter|"
    r"collective[-_]?permute|all[-_]?to[-_]?all|ppermute|psum|"
    r"nccl|sendrecv", re.IGNORECASE)

# the discovery/parsing mechanics live in the shared proftrace module
# (deviceprof consumes the same plumbing)
_COMM_RE = COMM_RE
_SKIP_PH = proftrace.SKIP_PH
_load_json = proftrace.load_json
find_trace_file = proftrace.find_trace_file
_merge_intervals = proftrace.merge_intervals
_overlap_len = proftrace.overlap_len


def measure(trace: "str | dict | Iterable[dict]") -> Optional[dict]:
    """Measured overlap numbers from a profiler capture.

    ``trace``: a path (file or profiler logdir), a loaded chrome-trace
    dict, or an iterable of trace events.  Returns ``None`` when no
    communication ops appear (nothing to measure — keep the model);
    otherwise a dict with ``overlap_fraction`` (fraction of comm wall
    time concurrent with same-device compute), ``comm_s`` /
    ``compute_s`` totals, ``n_comm_events`` and ``n_devices``.
    """
    events = proftrace.trace_events(trace)

    comm: dict = {}      # pid -> [(start, end)]
    compute: dict = {}   # pid -> [(start, end)]
    for ev in proftrace.complete_slices(events):
        ts, dur = ev["ts"], ev["dur"]
        pid = ev.get("pid", 0)
        name = str(ev.get("name", ""))
        bucket = comm if _COMM_RE.search(name) else compute
        bucket.setdefault(pid, []).append((float(ts), float(ts) + float(dur)))
    if not comm:
        return None

    comm_us = 0.0
    hidden_us = 0.0
    compute_us = 0.0
    for pid, spans in comm.items():
        merged = _merge_intervals(compute.get(pid, []))
        compute_us += sum(e - s for s, e in merged)
        for s, e in spans:
            comm_us += e - s
            hidden_us += _overlap_len(s, e, merged)
    # devices that only computed still count toward the device tally
    n_devices = len(set(comm) | set(compute))
    frac = hidden_us / comm_us if comm_us > 0 else 1.0
    return {
        "overlap_fraction": round(min(frac, 1.0), 4),
        "comm_s": round(comm_us * 1e-6, 9),
        "compute_s": round(compute_us * 1e-6, 9),
        "n_comm_events": sum(len(v) for v in comm.values()),
        "n_devices": n_devices,
    }


def measured_event(base: dict, measured: dict) -> dict:
    """A ``dist_overlap`` event payload with the modelled overlap numbers
    replaced by profiler truth (``measured=True``).

    ``base`` is a modelled event dict (:func:`costmodel.dist_overlap`
    output — its structural fields n_parts/rows/bytes stay authoritative);
    ``measured`` is a :func:`measure` result.
    """
    out = dict(base)
    est_halo_s = measured["comm_s"]
    est_interior_s = measured["compute_s"]
    out.update(
        overlap_fraction=measured["overlap_fraction"],
        est_interior_s=round(est_interior_s, 9),
        est_halo_s=round(est_halo_s, 9),
        halo_bound=bool(est_halo_s * (1.0 - measured["overlap_fraction"])
                        > est_interior_s),
        measured=True,
    )
    return out


def refine_captured(dist_events: List[dict], trace) -> List[dict]:
    """Refine captured modelled ``dist_overlap`` event payloads with one
    trace's measured overlap; returns the refined payloads (empty when the
    trace yields nothing — callers then keep the modelled events)."""
    m = measure(trace)
    if m is None:
        return []
    return [measured_event(ev, m) for ev in dist_events]

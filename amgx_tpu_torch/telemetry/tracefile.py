"""Chrome-trace export: view an amgx solve in Perfetto.

Converts the span/event/metric ring (or a JSONL trace file, including
multi-process ones) into Trace Event Format JSON — the format
``chrome://tracing`` and https://ui.perfetto.dev load directly:

* every writing session becomes one *process* track (``pid`` from the
  session's meta header, falling back to a synthetic index), with its
  recording threads as thread tracks — a multi-process mesh run shows
  one lane per rank;
* ``span_begin``/``span_end`` pairs become complete (``"X"``) slices
  with the begin record's ``attrs`` as slice args;
* ``event`` records become instants (``"i"``);
* counter samples become counter (``"C"``) tracks with the RUNNING SUM
  (the trace format draws absolute values), gauges track their last
  written value;
* serving observability: threads that executed ``serve_batch`` spans
  are named ``serve-worker-N`` tracks (``"M"`` thread_name metadata),
  and every ``request_trace`` event becomes an async ``"b"``/``"e"``
  pair spanning the request's whole lifetime, keyed by its trace id —
  overlapping requests stack instead of mis-nesting, and the batch
  slice that served a request carries its trace id in ``trace_ids``.

Timestamps: record ``t`` is ``perf_counter`` seconds, whose epoch is
per-process.  Session meta headers carry a paired
(``t_perf``, ``t_unix``) clock sample, so sessions are aligned onto one
wall-clock timeline; a headerless record list falls back to t − min(t).
"""
from __future__ import annotations

import json
from typing import IO, List, Optional, Union

from . import recorder
from .export import _sanitize, read_sessions

#: trace-event phases this exporter emits (telemetry_check validates);
#: "b"/"e" are the async request-lifecycle slices, "s"/"f" the
#: rendezvous flow arrows of a multi-rank mesh trace (early arrival →
#: last arrival of one reconstructed collective)
PHASES = ("X", "i", "C", "M", "b", "e", "s", "f")


def _args(d: dict) -> dict:
    return {str(k): v for k, v in _sanitize(d or {}).items()}


def _session_events(records: List[dict], pid: int, offset_s: float,
                    label: str) -> List[dict]:
    """Trace events of one session; ``offset_s`` maps the session's
    perf_counter timeline onto the merged timeline."""
    out: List[dict] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": label},
    }]

    def ts(t):
        # microseconds, clamped — a tiny negative from clock-sample
        # skew would make Perfetto drop the whole track
        return max((t + offset_s) * 1e6, 0.0)

    begins = {}             # sid -> span_begin record
    counters = {}           # (name, labels) -> running sum
    worker_tids = set()     # threads that executed serve_batch spans
    for r in records:
        kind = r["kind"]
        if kind == "span_begin":
            begins[r["sid"]] = r
        elif kind == "span_end":
            b = begins.pop(r["sid"], None)
            t1 = r["t"]
            dur = r.get("dur", 0.0) or 0.0
            if r["name"] == "serve_batch":
                worker_tids.add(r["tid"])
            out.append({
                "ph": "X", "name": r["name"], "pid": pid,
                "tid": r["tid"], "ts": ts(t1 - dur),
                "dur": max(dur * 1e6, 0.0),
                "args": _args(b["attrs"] if b else {}),
            })
        elif kind == "event" and r["name"] == "request_trace":
            # one async b/e pair per request, spanning submit →
            # terminal (the event fires at completion and carries the
            # total latency); the trace id keys the pair AND appears
            # in the serving batch slice's trace_ids args — the link
            # between a request's lifetime and the batch that ran it
            a = r.get("attrs", {})
            lat = a.get("latency_s")
            lat = float(lat) if isinstance(lat, (int, float)) else 0.0
            rid = str(a.get("trace_id", "?"))
            name = f"request:{a.get('outcome', '?')}"
            out.append({
                "ph": "b", "cat": "request", "id": rid, "name": name,
                "pid": pid, "tid": r["tid"],
                "ts": ts(r["t"] - lat), "args": _args(a),
            })
            out.append({
                "ph": "e", "cat": "request", "id": rid, "name": name,
                "pid": pid, "tid": r["tid"], "ts": ts(r["t"]),
            })
        elif kind == "event":
            out.append({
                "ph": "i", "name": r["name"], "pid": pid,
                "tid": r["tid"], "ts": ts(r["t"]), "s": "t",
                "args": _args(r.get("attrs", {})),
            })
            if r["name"] == "hbm_snapshot":
                # the HBM ledger sample additionally draws one counter
                # track per device (bytes_in_use) so memory pressure is
                # plottable next to the phase spans that caused it
                devs = (r.get("attrs") or {}).get("devices")
                if isinstance(devs, dict):
                    for dev, d in sorted(devs.items()):
                        v = d.get("bytes_in_use") \
                            if isinstance(d, dict) else None
                        if isinstance(v, (int, float)) \
                                and not isinstance(v, bool):
                            out.append({
                                "ph": "C",
                                "name": f"hbm {dev}",
                                "pid": pid, "tid": 0,
                                "ts": ts(r["t"]),
                                "args": {"value": v},
                            })
            if r["name"] == "device_anatomy":
                # the device-time anatomy additionally draws one counter
                # track per attributed scope (seconds of measured device
                # time) so the split is plottable next to the host spans
                sc = (r.get("attrs") or {}).get("scopes")
                if isinstance(sc, dict):
                    for sname, sec in sorted(sc.items()):
                        if isinstance(sec, (int, float)) \
                                and not isinstance(sec, bool):
                            out.append({
                                "ph": "C",
                                "name": f"device_s {sname}",
                                "pid": pid, "tid": 0,
                                "ts": ts(r["t"]),
                                "args": {"value": sec},
                            })
        elif kind in ("counter", "gauge", "hist"):
            v = r["value"]
            if isinstance(v, str):      # "Infinity" tokens: not plottable
                continue
            lbl = r["name"]
            if r["labels"]:
                lbl += "{" + ",".join(
                    f"{k}={v2}" for k, v2 in
                    sorted(r["labels"].items())) + "}"
            if kind == "counter":
                counters[lbl] = counters.get(lbl, 0) + v
                v = counters[lbl]
            elif kind == "hist":
                continue                # durations already shown as spans
            out.append({
                "ph": "C", "name": lbl, "pid": pid, "tid": 0,
                "ts": ts(r["t"]), "args": {"value": v},
            })
    # unmatched begins (an open span at flush time): emit as instants so
    # the work is visible rather than silently dropped
    for b in begins.values():
        out.append({"ph": "i", "name": b["name"] + " (open)", "pid": pid,
                    "tid": b["tid"], "ts": ts(b["t"]), "s": "t",
                    "args": _args(b["attrs"])})
    # name the serving worker tracks — a mesh of anonymous tids is
    # unreadable the moment two workers interleave batches
    for i, t in enumerate(sorted(worker_tids)):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": t, "args": {"name": f"serve-worker-{i}"}})
    return out


def chrome_trace(source: Union[None, str, List[str], List[dict]] = None
                 ) -> dict:
    """Build the Trace Event Format dict.

    ``source``: None → the current ring contents (one synthetic
    session); a path or list of paths → JSONL trace file(s), one process
    track per session; a list of ring records → one synthetic session.
    """
    if source is None:
        sessions = [{"meta": None, "records": recorder.records()}]
    elif isinstance(source, str):
        sessions = read_sessions(source)
    elif source and isinstance(source[0], str):
        sessions = []
        for p in source:
            sessions.extend(read_sessions(p))
    else:
        sessions = [{"meta": None, "records": list(source or [])}]

    # wall-clock alignment: offset each session so its records land at
    # (t_unix of session start) + (t − t_perf); relative to the earliest
    # session so timestamps stay small
    t0s = []
    for s in sessions:
        m = s["meta"] or {}
        if "t_perf" in m and "t_unix" in m:
            t0s.append(m["t_unix"] - m["t_perf"])
    base = min(t0s) if t0s else None
    events: List[dict] = []
    offsets: List[float] = []
    pids: List[int] = []
    for i, s in enumerate(sessions):
        m = s["meta"] or {}
        pid = int(m.get("pid", i + 1))
        label = f"amgx pid {pid}"
        if m.get("session"):
            label += f" [{m['session']}]"
        if m.get("host"):
            label += f" @{m['host']}"
        if base is not None and "t_perf" in m:
            offset = (m["t_unix"] - m["t_perf"]) - base
        else:
            ts_all = [r["t"] for r in s["records"]]
            offset = -min(ts_all) if ts_all else 0.0
        offsets.append(offset)
        pids.append(pid)
        events.extend(_session_events(s["records"], pid, offset, label))
    events.extend(_rendezvous_flows(sessions, pids, offsets))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _rendezvous_flows(sessions: List[dict], pids: List[int],
                      offsets: List[float]) -> List[dict]:
    """Flow arrows of a multi-rank trace: for every reconstructed
    collective rendezvous (meshtrace join), one ``s`` → ``f`` arrow
    from each early rank's arrival to the last rank's — Perfetto draws
    who the mesh waited on.  Empty on single-session traces."""
    if len(sessions) < 2:
        return []
    from . import meshtrace
    out: List[dict] = []
    for n, rv in enumerate(meshtrace.rendezvous_from_sessions(sessions)):
        arr = sorted(rv["arrivals"],
                     key=lambda a: a["t"] + offsets[a["session"]])
        last = arr[-1]
        t_last = max((last["t"] + offsets[last["session"]]) * 1e6, 0.0)
        name = f"rendezvous:{rv['op']}:{rv['group']}"
        for a in arr[:-1]:
            fid = f"rv{n}-r{a['rank']}"
            out.append({
                "ph": "s", "cat": "rendezvous", "id": fid,
                "name": name, "pid": pids[a["session"]],
                "tid": a["tid"],
                "ts": max((a["t"] + offsets[a["session"]]) * 1e6, 0.0),
            })
            out.append({
                "ph": "f", "cat": "rendezvous", "id": fid, "bp": "e",
                "name": name, "pid": pids[last["session"]],
                "tid": last["tid"], "ts": t_last,
            })
    return out


def write_chrome_trace(path_or_file: Union[str, IO],
                       source: Union[None, str, List] = None) -> int:
    """Write the trace-event JSON; returns the event count.  The output
    loads in Perfetto / ``chrome://tracing`` as-is."""
    trace = chrome_trace(source)

    def write(f):
        json.dump(trace, f, allow_nan=False)

    if isinstance(path_or_file, str):
        with open(path_or_file, "w") as f:
            write(f)
    else:
        write(path_or_file)
    return len(trace["traceEvents"])


def validate_chrome_trace(trace: dict) -> int:
    """Structural validation against the trace-event schema subset this
    exporter emits (``scripts/telemetry_check.py`` calls this); returns
    the event count, raises ``ValueError`` on drift."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"chrome trace schema: {msg}")

    need(isinstance(trace, dict), "not an object")
    evs = trace.get("traceEvents")
    need(isinstance(evs, list), "missing traceEvents list")
    for e in evs:
        need(isinstance(e, dict), f"event is not an object: {e!r}")
        need(e.get("ph") in PHASES, f"unknown phase {e.get('ph')!r}")
        need(isinstance(e.get("name"), str) and e["name"],
             f"missing name: {e!r}")
        need(isinstance(e.get("pid"), int), f"missing pid: {e!r}")
        need(isinstance(e.get("tid"), int), f"missing tid: {e!r}")
        if e["ph"] != "M":
            need(isinstance(e.get("ts"), (int, float)) and e["ts"] >= 0,
                 f"bad ts: {e!r}")
        if e["ph"] == "X":
            need(isinstance(e.get("dur"), (int, float))
                 and e["dur"] >= 0, f"bad dur: {e!r}")
        if e["ph"] in ("b", "e", "s", "f"):
            # async pairs and flow arrows match on (cat, id) — either
            # missing breaks the slice/arrow silently in Perfetto
            need(isinstance(e.get("id"), str) and e["id"],
                 f"async/flow event missing id: {e!r}")
            need(isinstance(e.get("cat"), str) and e["cat"],
                 f"async/flow event missing cat: {e!r}")
        if e["ph"] == "f":
            # binding point "e" attaches the arrow head to the
            # ENCLOSING slice at ts — without it Perfetto binds to the
            # next slice and the arrow points at the wrong span
            need(e.get("bp") == "e", f"flow finish missing bp: {e!r}")
        if "args" in e:
            need(isinstance(e["args"], dict), f"bad args: {e!r}")
    # the whole thing must be strict JSON (Perfetto rejects bare NaN)
    json.dumps(trace, allow_nan=False)
    return len(evs)

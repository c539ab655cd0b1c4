"""Telemetry exporters: JSONL traces and Prometheus text snapshots.

JSONL: one JSON object per line.  Every writing session starts with a
``meta`` record declaring the schema version (a file appended by two
processes holds one ``meta`` per session, and ``seq`` restarts after
each); every other line is a ring record (see
:mod:`amgx_tpu_torch.telemetry.recorder` for the field contract).  Non-finite
numbers are encoded as the strings ``"NaN"``/``"Infinity"``/
``"-Infinity"`` so every line is strict JSON (``json.dumps`` would
otherwise emit bare ``NaN`` tokens that jq/JS/Go reject — divergence
events carry exactly such norms).  :func:`validate_record` is the
single schema authority — tests and ``scripts/telemetry_check.py``
both call it, so a drifting field shows up as a failing check, not a
silently unreadable trace.

Prometheus: the standard text exposition format (``# TYPE`` /
``# HELP`` headers from the versioned :data:`~.metrics.METRICS` list,
``_bucket``/``_sum``/``_count`` series for histograms), suitable for a
node-exporter-style textfile collector or a scrape handler.
"""
from __future__ import annotations

import json
import math
import os
import socket
import threading
import time
import uuid
from typing import IO, Iterable, List, Optional, Union

from . import metrics, recorder

_KINDS = ("meta", "span_begin", "span_end", "event", "counter", "gauge",
          "hist")

_flush_lock = threading.Lock()
#: per-path high-water sequence number for incremental flushes
_flushed_seq = {}
#: per-path ring-overflow count at the last flush (drop detection)
_flushed_dropped = {}
#: per-path perf_counter of the last clock (re-)sample; the meta header
#: pairs the clocks once at session start, which bakes any later drift
#: into the whole trace — flush_jsonl re-pairs them at most every
#: CLOCK_RESAMPLE_S so meshtrace can fit a per-session offset+slope
_clock_sampled = {}
CLOCK_RESAMPLE_S = 60.0

#: one id per writing process — the session identity the aggregator and
#: the Chrome-trace exporter key on (a telemetry_path appended by every
#: rank of a multi-process mesh holds one meta per session)
_SESSION_ID = uuid.uuid4().hex[:12]


def _meta_record() -> dict:
    """Session header.  ``pid``/``session`` identify the writing process
    (what :func:`aggregate_sessions` merges on); ``t_perf``/``t_unix``
    sample both clocks at write time so sessions from different
    processes — whose ``perf_counter`` epochs are unrelated — can be
    aligned onto one wall-clock timeline; ``dropped`` is the cumulative
    ring-overflow count so a truncated trace is detectable."""
    rec = {"kind": "meta", "name": "amgx-telemetry",
           "schema": recorder.SCHEMA_VERSION,
           "pid": os.getpid(), "session": _SESSION_ID,
           "host": socket.gethostname(),
           "t_perf": time.perf_counter(), "t_unix": time.time(),
           "dropped": recorder.dropped_count()}
    # cumulative cache-efficacy counters (telemetry/runstate.py):
    # in-process cache stats die with the process, so the meta header
    # carries the CROSS-RESTART totals — what lets bench_trend.py (and
    # any trace reader) judge warm-start efficacy across rounds.
    # Folding here also keeps the state file fresh without a separate
    # write path.  Absent when no warm-start dir is configured.
    try:
        from . import runstate
        cum = runstate.fold()
        if cum and cum.get("counters"):
            rec["cum"] = dict(cum["counters"])
    except Exception:
        pass        # observability must never break a flush
    return rec


_NONFINITE = {"NaN": math.nan, "Infinity": math.inf,
              "-Infinity": -math.inf}


def _sanitize(v):
    """Strict-JSON encoding of non-finite floats as string tokens."""
    if isinstance(v, float) and not math.isfinite(v):
        if math.isnan(v):
            return "NaN"
        return "Infinity" if v > 0 else "-Infinity"
    if isinstance(v, dict):
        return {k: _sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_sanitize(x) for x in v]
    return v


def _json_line(rec: dict) -> str:
    return json.dumps(_sanitize(rec), allow_nan=False)


def validate_record(rec: dict):
    """Raise ``ValueError`` when ``rec`` does not conform to the
    documented schema (version ``recorder.SCHEMA_VERSION``)."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"telemetry record schema: {msg}: {rec!r}")

    need(isinstance(rec, dict), "record is not an object")
    kind = rec.get("kind")
    need(kind in _KINDS, f"unknown kind {kind!r}")
    need(isinstance(rec.get("name"), str) and rec["name"],
         "missing/empty name")
    if kind == "meta":
        need(rec.get("schema") == recorder.SCHEMA_VERSION,
             f"schema version {rec.get('schema')!r} != "
             f"{recorder.SCHEMA_VERSION}")
        return
    need(isinstance(rec.get("seq"), int) and rec["seq"] > 0,
         "missing seq")
    need(isinstance(rec.get("t"), (int, float)), "missing t")
    need(isinstance(rec.get("tid"), int), "missing tid")
    if kind in ("span_begin", "span_end"):
        need(isinstance(rec.get("sid"), int), "span missing sid")
        need(rec.get("parent") is None or isinstance(rec["parent"], int),
             "bad span parent")
        if kind == "span_begin":
            need(isinstance(rec.get("attrs"), dict), "span missing attrs")
        else:
            need(isinstance(rec.get("dur"), (int, float))
                 and rec["dur"] >= 0.0, "span_end missing dur")
    elif kind == "event":
        need(isinstance(rec.get("attrs"), dict), "event missing attrs")
        need(rec.get("sid") is None or isinstance(rec["sid"], int),
             "bad event sid")
        if rec["name"] in ("cycle_level", "cycle_coarse",
                           "forensics_probe"):
            # forensics events are an analysis input contract
            # (telemetry/forensics.py keys its anatomy on the level):
            # a level that stopped being an int mis-buckets silently
            need(isinstance(rec["attrs"].get("level"), int),
                 "forensics event missing integer level")
        if rec["name"] == "setup_phase":
            # setup-profiler phase records are the analysis input of
            # setup_profile.analyze / the doctor "setup" section
            a = rec["attrs"]
            need(isinstance(a.get("component"), str) and a["component"],
                 "setup_phase event missing component")
            need(isinstance(a.get("wall_s"), (int, float)) and
                 isinstance(a.get("self_s"), (int, float)),
                 "setup_phase event missing wall_s/self_s")
            need(a.get("level") is None or isinstance(a["level"], int),
                 "setup_phase event has non-integer level")
        if rec["name"] == "setup_profile":
            need(isinstance(rec["attrs"].get("wall_s"), (int, float)),
                 "setup_profile summary missing wall_s")
        if rec["name"] == "compile_cache_fallback":
            # warm-start fallbacks are the doctor's "why did this
            # process compile anyway" input (serve/aot.py)
            need(isinstance(rec["attrs"].get("reason"), str)
                 and rec["attrs"]["reason"],
                 "compile_cache_fallback event missing reason")
        if rec["name"] == "request_trace":
            # request-lifecycle traces are the analysis input of the
            # doctor's SLO section and the Chrome-trace request slices
            # (serve/service.py emits one per terminal request)
            a = rec["attrs"]
            need(isinstance(a.get("trace_id"), str) and a["trace_id"],
                 "request_trace event missing trace_id")
            need(a.get("outcome") in ("ok", "failed", "rejected",
                                      "expired", "error"),
                 f"request_trace event has unknown outcome "
                 f"{a.get('outcome')!r}")
            need(isinstance(a.get("latency_s"), (int, float))
                 and a["latency_s"] >= 0.0,
                 "request_trace event missing latency_s")
            # "phases": durations in the documented phase vocabulary;
            # "marks": raw monotone mark offsets from `submitted`
            for key in ("phases", "marks"):
                d = a.get(key)
                need(isinstance(d, dict) and all(
                    isinstance(v, (int, float)) and v >= 0.0
                    for v in d.values()),
                     f"request_trace event missing {key} dict")
        if rec["name"] == "slo_window":
            # SLO snapshots are what bench_trend and the doctor read
            # for attainment/burn-rate trends
            a = rec["attrs"]
            need(isinstance(a.get("window_s"), (int, float)),
                 "slo_window event missing window_s")
            need(isinstance(a.get("requests"), int),
                 "slo_window event missing requests")
            for k in ("attainment", "burn_rate"):
                need(a.get(k) is None
                     or isinstance(a[k], (int, float)),
                     f"slo_window event has non-numeric {k}")
        if rec["name"] in ("level_cost", "op_cost", "operator_cost"):
            # cost-model descriptors are the doctor's roofline input;
            # the dtype field is the mixed-precision contract — a level
            # whose precision stopped being reported would silently
            # break the bf16-vs-f32 bandwidth accounting
            a = rec["attrs"]
            need(isinstance(a.get("pack"), str) and a["pack"],
                 f"{rec['name']} event missing pack")
            need(isinstance(a.get("dtype"), str) and a["dtype"],
                 f"{rec['name']} event missing dtype")
            need(isinstance(a.get("itemsize"), int),
                 f"{rec['name']} event missing itemsize")
            if rec["name"] == "level_cost":
                need(isinstance(a.get("level"), int),
                     "level_cost event missing integer level")
        if rec["name"] == "dist_overlap":
            # the distributed-level overlap audit is the doctor's
            # "distributed levels" input (costmodel.dist_overlap)
            a = rec["attrs"]
            need(isinstance(a.get("level"), int),
                 "dist_overlap event missing integer level")
            need(isinstance(a.get("n_parts"), int) and a["n_parts"] >= 1,
                 "dist_overlap event missing n_parts")
            need(isinstance(a.get("submesh_parts"), int),
                 "dist_overlap event missing submesh_parts")
            for k in ("est_interior_s", "est_halo_s",
                      "overlap_fraction"):
                need(isinstance(a.get(k), (int, float)),
                     f"dist_overlap event missing numeric {k}")
            need(isinstance(a.get("halo_bound"), bool),
                 "dist_overlap event missing halo_bound bool")
            # modelled vs profiler-measured provenance: every
            # overlap number must say which it is
            need(isinstance(a.get("measured"), bool),
                 "dist_overlap event missing measured bool")
        if rec["name"] == "device_anatomy":
            # the device-time cycle anatomy (telemetry/deviceprof.py):
            # every scope key must honour the naming contract, and the
            # event must say whether it is profiler truth or a stub
            a = rec["attrs"]
            need(isinstance(a.get("measured"), bool),
                 "device_anatomy event missing measured bool")
            need(isinstance(a.get("scope_version"), int)
                 and a["scope_version"] >= 1,
                 "device_anatomy event missing scope_version")
            for k in ("total_device_s", "attributed_s",
                      "unattributed_s"):
                need(isinstance(a.get(k), (int, float))
                     and not isinstance(a.get(k), bool)
                     and a[k] >= 0,
                     f"device_anatomy event missing numeric {k}")
            sc = a.get("scopes")
            need(isinstance(sc, dict),
                 "device_anatomy event missing scopes dict")
            if isinstance(sc, dict):
                from . import scopes as _scopes
                for name, sec in sc.items():
                    need(_scopes.validate(name),
                         f"device_anatomy scope {name!r} violates the "
                         f"amgx/<area>/<name> contract")
                    need(isinstance(sec, (int, float))
                         and not isinstance(sec, bool) and sec >= 0,
                         f"device_anatomy scope {name!r} has "
                         f"non-numeric seconds")
            for k in ("levels", "spmv"):
                need(isinstance(a.get(k), dict),
                     f"device_anatomy event missing {k} dict")
        if rec["name"] == "dist_agglomerate":
            # agglomeration decisions (distributed/agglomerate.py):
            # the doctor's sub-mesh lifecycle input
            a = rec["attrs"]
            for k in ("from_parts", "to_parts", "rows"):
                need(isinstance(a.get(k), int),
                     f"dist_agglomerate event missing integer {k}")
            need(a["to_parts"] >= 1
                 and a["to_parts"] <= a["from_parts"],
                 "dist_agglomerate event has non-shrinking parts")
        if rec["name"] == "recovery_attempt":
            # recovery-ladder audit records (solvers/recovery.py) are
            # the doctor's "failures & recovery" input — a drifting
            # kind/action/outcome vocabulary would silently un-count
            # recoveries
            a = rec["attrs"]
            from ..errors import FailureKind
            kinds = frozenset(k.value for k in FailureKind)
            need(a.get("kind") in kinds,
                 f"recovery_attempt event has unknown kind "
                 f"{a.get('kind')!r}")
            need(a.get("action") in ("krylov_classic", "restart",
                                     "promote", "conservative",
                                     "resetup", "ladder"),
                 f"recovery_attempt event has unknown action "
                 f"{a.get('action')!r}")
            need(isinstance(a.get("attempt"), int) and a["attempt"] >= 0,
                 "recovery_attempt event missing attempt")
            need(a.get("outcome") in ("recovered", "failed", "error",
                                      "skipped", "exhausted"),
                 f"recovery_attempt event has unknown outcome "
                 f"{a.get('outcome')!r}")
        if rec["name"] == "krylov_comm":
            # communication-avoiding Krylov accounting: the
            # per-iteration reduction profile the perf gate's
            # collectives_per_iter ceiling and the doctor's "Krylov
            # communication" section read
            a = rec["attrs"]
            need(isinstance(a.get("solver"), str) and a["solver"],
                 "krylov_comm event missing solver")
            need(a.get("mode") in ("CLASSIC", "CA", "PIPELINED"),
                 f"krylov_comm event has unknown mode {a.get('mode')!r}")
            need(isinstance(a.get("iterations"), int)
                 and a["iterations"] >= 0,
                 "krylov_comm event missing iterations")
            per = a.get("per_iter")
            need(isinstance(per, dict) and all(
                isinstance(k, str) and isinstance(v, int)
                for k, v in per.items()),
                 "krylov_comm event missing per_iter op->count dict")
            need(isinstance(a.get("collectives_per_iter"), int)
                 and a["collectives_per_iter"] >= 0,
                 "krylov_comm event missing collectives_per_iter")
            need(isinstance(a.get("fused"), bool),
                 "krylov_comm event missing fused bool")
            need(isinstance(a.get("n_parts"), int) and a["n_parts"] >= 1,
                 "krylov_comm event missing n_parts")
        if rec["name"] == "clock_sample":
            # rate-limited clock re-pairing (flush_jsonl): the input of
            # meshtrace's per-session offset+slope fit — a sample
            # missing either clock would silently skew the whole mesh
            # timeline
            a = rec["attrs"]
            for k in ("t_perf", "t_unix"):
                need(isinstance(a.get(k), (int, float))
                     and not isinstance(a.get(k), bool),
                     f"clock_sample event missing numeric {k}")
        if rec["name"] == "mesh_truncated_tail":
            # a rank killed mid-write left a partial trailing line;
            # read_sessions skips it and says so IN the trace
            a = rec["attrs"]
            need(isinstance(a.get("line"), int) and a["line"] >= 1,
                 "mesh_truncated_tail event missing line number")
            need(isinstance(a.get("bytes"), int) and a["bytes"] >= 0,
                 "mesh_truncated_tail event missing byte count")
        if rec["name"] == "mesh_rendezvous":
            # one reconstructed cross-rank collective (meshtrace.py):
            # arrival spread + induced wait, per (op, group, sequence)
            a = rec["attrs"]
            need(a.get("op") in ("halo", "krylov", "agglomerate"),
                 f"mesh_rendezvous event has unknown op {a.get('op')!r}")
            need(isinstance(a.get("group"), str) and a["group"],
                 "mesh_rendezvous event missing group")
            need(isinstance(a.get("seq"), int) and a["seq"] >= 0,
                 "mesh_rendezvous event missing seq")
            need(isinstance(a.get("n_ranks"), int) and a["n_ranks"] >= 2,
                 "mesh_rendezvous event has fewer than 2 ranks")
            need(isinstance(a.get("last_rank"), int)
                 and a["last_rank"] >= 0,
                 "mesh_rendezvous event missing last_rank")
            for k in ("spread_s", "wait_total_s"):
                need(isinstance(a.get(k), (int, float))
                     and not isinstance(a.get(k), bool) and a[k] >= 0,
                     f"mesh_rendezvous event missing numeric {k}")
            need(isinstance(a.get("measured"), bool),
                 "mesh_rendezvous event missing measured bool")
        if rec["name"] == "mesh_health":
            # per-rank mesh accounting (meshtrace.py): the honesty
            # invariant compute + wait + unattributed ≡ wall is
            # enforced HERE, so a trace can never carry wait the rank
            # did not observably spend
            a = rec["attrs"]
            need(isinstance(a.get("measured"), bool),
                 "mesh_health event missing measured bool")
            need(isinstance(a.get("mesh_version"), int)
                 and a["mesh_version"] >= 1,
                 "mesh_health event missing mesh_version")
            need(isinstance(a.get("rank"), int) and a["rank"] >= 0,
                 "mesh_health event missing rank")
            for k in ("wall_s", "compute_s", "wait_s",
                      "unattributed_s"):
                need(isinstance(a.get(k), (int, float))
                     and not isinstance(a.get(k), bool) and a[k] >= 0,
                     f"mesh_health event missing numeric {k}")
            need(abs(a["compute_s"] + a["wait_s"] + a["unattributed_s"]
                     - a["wall_s"])
                 <= 1e-6 * max(1.0, abs(a["wall_s"])),
                 "mesh_health event violates the honesty invariant "
                 "compute + wait + unattributed == wall")
            need(isinstance(a.get("straggler_score"), (int, float))
                 and not isinstance(a.get("straggler_score"), bool)
                 and 0.0 <= a["straggler_score"] <= 1.0,
                 "mesh_health event missing straggler_score in [0,1]")
            for k in ("arrived_last", "collectives", "halo_bytes"):
                need(isinstance(a.get(k), int) and a[k] >= 0,
                     f"mesh_health event missing integer {k}")
        if rec["name"] == "fault_injected":
            # chaos-run provenance: every synthetic failure in a trace
            # must name its injection point
            need(isinstance(rec["attrs"].get("point"), str)
                 and rec["attrs"]["point"],
                 "fault_injected event missing point")
        if rec["name"] == "history_truncated":
            # forensics contract: a truncated iteration record says
            # where truncation began and how much is gone
            a = rec["attrs"]
            need(isinstance(a.get("first_bad_iteration"), int)
                 and a["first_bad_iteration"] >= 0,
                 "history_truncated event missing first_bad_iteration")
            need(isinstance(a.get("dropped"), int) and a["dropped"] >= 1,
                 "history_truncated event missing dropped count")
        if rec["name"] == "device_setup_fallback":
            # fallback events are the doctor's per-level "why did rap
            # run host-side" input (amg/device_setup/)
            a = rec["attrs"]
            need(isinstance(a.get("reason"), str) and a["reason"],
                 "device_setup_fallback event missing reason")
            need(isinstance(a.get("component"), str) and a["component"],
                 "device_setup_fallback event missing component")
            need(a.get("level") is None or isinstance(a["level"], int),
                 "device_setup_fallback event has non-integer level")

        def _check_ledger_snapshot(s, what):
            # shared shape of the HBM ledger snapshot (memledger.py):
            # the honesty invariant is validated per device, so a trace
            # can never carry an unbalanced ledger
            from . import memledger as _ml
            need(isinstance(s.get("measured"), bool),
                 f"{what} missing measured bool")
            need(isinstance(s.get("ledger_version"), int)
                 and s["ledger_version"] >= 1,
                 f"{what} missing ledger_version")
            devs = s.get("devices")
            need(isinstance(devs, dict), f"{what} missing devices dict")
            for dev, d in devs.items():
                need(isinstance(d, dict),
                     f"{what} device {dev!r} is not an object")
                for k in ("bytes_in_use", "accounted_bytes",
                          "unaccounted_bytes", "census_bytes",
                          "peak_bytes", "bytes_limit",
                          "headroom_bytes"):
                    need(isinstance(d.get(k), int) and d[k] >= 0,
                         f"{what} device {dev!r} missing integer {k}")
                need(d["accounted_bytes"] + d["unaccounted_bytes"]
                     == d["bytes_in_use"],
                     f"{what} device {dev!r} violates the honesty "
                     f"invariant accounted + unaccounted == "
                     f"bytes_in_use")
                ow = d.get("owners")
                need(isinstance(ow, dict),
                     f"{what} device {dev!r} missing owners dict")
                for name, nb in ow.items():
                    need(_ml.validate(name),
                         f"{what} owner {name!r} violates the "
                         f"amgx/<owner>/<name> contract")
                    need(isinstance(nb, int) and nb >= 0,
                         f"{what} owner {name!r} has non-integer "
                         f"bytes")
            need(isinstance(s.get("owners"), dict),
                 f"{what} missing owners dict")

        if rec["name"] == "hbm_snapshot":
            # the HBM ledger sample (telemetry/memledger.py): the
            # doctor's "Device memory" input and the chrome-trace
            # `hbm <device>` counter track
            _check_ledger_snapshot(rec["attrs"], "hbm_snapshot event")
        if rec["name"] == "oom_postmortem":
            # the OOM post-mortem bundle: a RESOURCE_EXHAUSTED without
            # one of these is an unexplained death
            a = rec["attrs"]
            need(isinstance(a.get("where"), str) and a["where"],
                 "oom_postmortem event missing where")
            need(isinstance(a.get("error"), str),
                 "oom_postmortem event missing error")
            for k in ("injected", "in_recovery", "measured"):
                need(isinstance(a.get(k), bool),
                     f"oom_postmortem event missing {k} bool")
            need(isinstance(a.get("snapshot"), dict),
                 "oom_postmortem event missing snapshot")
            _check_ledger_snapshot(a["snapshot"],
                                   "oom_postmortem snapshot")
            to = a.get("top_owners")
            need(isinstance(to, list) and all(
                isinstance(p, list) and len(p) == 2
                and isinstance(p[0], str)
                and isinstance(p[1], int) and p[1] >= 0
                for p in to),
                 "oom_postmortem event missing top_owners pairs")
            need(isinstance(a.get("headroom_history"), list),
                 "oom_postmortem event missing headroom_history")
            sg = a.get("suggestions")
            need(isinstance(sg, list) and sg and all(
                isinstance(s, dict) and isinstance(s.get("knob"), str)
                and isinstance(s.get("hint"), str) for s in sg),
                 "oom_postmortem event missing suggestions")
    else:   # counter / gauge / hist
        need(isinstance(rec.get("labels"), dict), "metric missing labels")
        v = rec.get("value")
        need((isinstance(v, (int, float)) and not isinstance(v, bool))
             or v in _NONFINITE,
             "metric missing numeric value")


def _iter_validated(lines: Iterable[str]):
    """Parse-and-validate generator over JSONL lines (each line parsed
    exactly once — ring-sized traces dominate the aggregator's cost).
    The first non-empty line must be the meta header; ``seq`` must be
    strictly increasing within a session (each appending session
    restates the meta header, after which ``seq`` may restart)."""
    last_seq = 0
    first = True
    for line in lines:
        line = line.strip()
        if not line:
            continue
        def _bare(tok):
            # the whole point of the string encoding is that strict
            # consumers (jq/JS/Go) can parse every line — a bare token
            # is exactly the drift this validator exists to catch
            raise ValueError(
                f"bare {tok} token is not strict JSON; non-finite "
                "values must be string-encoded")
        rec = json.loads(line, parse_constant=_bare)
        validate_record(rec)
        if first:
            if rec.get("kind") != "meta":
                raise ValueError("first JSONL record must be the meta "
                                 "header")
            first = False
        elif rec["kind"] == "meta":
            last_seq = 0    # a new writing session starts here
        else:
            if rec["seq"] <= last_seq:
                raise ValueError(
                    f"seq not increasing: {rec['seq']} after {last_seq}")
            last_seq = rec["seq"]
        yield rec
    if first:
        raise ValueError("empty trace: no records")


def validate_jsonl(lines: Iterable[str]) -> int:
    """Validate an iterable of JSONL lines; returns the record count."""
    return sum(1 for _ in _iter_validated(lines))


def dump_jsonl(path_or_file: Union[str, IO],
               records: Optional[List[dict]] = None) -> int:
    """Write ``records`` (default: the current ring contents) with a
    meta header; returns the number of records written."""
    recs = recorder.records() if records is None else list(records)

    def write(f):
        f.write(_json_line(_meta_record()) + "\n")
        for r in recs:
            f.write(_json_line(r) + "\n")

    if isinstance(path_or_file, str):
        with open(path_or_file, "w") as f:
            write(f)
    else:
        write(path_or_file)
    return len(recs)


def flush_jsonl(path: str) -> int:
    """Append the records produced since the last flush to ``path``;
    returns the number of records appended.  Solvers call this after
    setup/solve when ``telemetry_path`` is configured, so a
    long-running process streams its trace instead of holding it all
    in the ring.  The meta header is written on this process's FIRST
    flush to ``path`` — even when the file already has content from an
    earlier process — because ``seq`` restarts with the process and the
    header is what marks the session boundary for the validator."""
    with _flush_lock:
        first_flush = path not in _flushed_seq
        last = _flushed_seq.get(path, 0)
        # ring overflow since the last flush to this path: the evicted
        # records are gone, so say so IN the trace (the doctor reports
        # it) rather than leaving a silently truncated file
        dropped = recorder.dropped_count()
        last_dropped = _flushed_dropped.get(path, 0)
        if dropped < last_dropped:
            # recorder.reset_dropped() (telemetry.reset) zeroed the
            # counter since the last flush — restart the high-water or
            # every later overflow would hide below the stale mark
            last_dropped = 0
        if dropped > last_dropped:
            recorder.event("ring_overflow",
                           dropped=dropped - last_dropped,
                           dropped_total=dropped,
                           ring_size=recorder._STATE.ring_size)
        _flushed_dropped[path] = dropped
        # rate-limited clock re-pairing: the meta header samples
        # (t_perf, t_unix) once at session start, which bakes clock
        # drift into long traces — re-sample at most every
        # CLOCK_RESAMPLE_S so meshtrace can fit offset+slope per
        # session instead of a single offset
        now = time.perf_counter()
        if first_flush:
            _clock_sampled[path] = now      # the meta IS the first pair
        elif now - _clock_sampled.get(path, 0.0) >= CLOCK_RESAMPLE_S:
            _clock_sampled[path] = now
            recorder.event("clock_sample", t_perf=now,
                           t_unix=time.time())
        recs = [r for r in recorder.records() if r["seq"] > last]
        if first_flush or recs:
            with open(path, "a") as f:
                if first_flush:
                    f.write(_json_line(_meta_record()) + "\n")
                for r in recs:
                    f.write(_json_line(r) + "\n")
        _flushed_seq[path] = recs[-1]["seq"] if recs else last
        return len(recs)


# ------------------------------------------------------- session merging
def _restore_nonfinite(v):
    """Inverse of :func:`_sanitize` for VALUE fields read back from a
    trace: the string tokens become floats again so aggregation and the
    doctor's math see real non-finite numbers."""
    if isinstance(v, str) and v in _NONFINITE:
        return _NONFINITE[v]
    return v


def read_sessions(source: Union[str, Iterable[str]]) -> List[dict]:
    """Parse one JSONL trace into its writing sessions.

    ``source``: a path or an iterable of lines.  Returns one dict per
    session — ``{"meta": <meta record>, "records": [...]}`` — split at
    the meta headers (each appending process restates one; the
    validator's contract).  The lines are validated on the way in, so a
    drifted trace fails loudly here rather than mis-merging.

    One tolerated defect: a TRAILING line that is not parseable JSON —
    a rank killed mid-write leaves exactly that, and crash postmortems
    are the mesh flight recorder's whole point — is skipped with a
    synthetic ``mesh_truncated_tail`` warning event appended to the
    last session instead of raising.  A malformed line anywhere else
    is still schema drift and still raises."""
    if isinstance(source, str):
        with open(source) as f:
            lines = f.readlines()
    else:
        lines = list(source)
    truncated = None
    for i in range(len(lines) - 1, -1, -1):
        line = lines[i].strip()
        if not line:
            continue
        try:
            json.loads(line)
        except ValueError:
            truncated = {"line": i + 1, "bytes": len(lines[i])}
            lines = lines[:i]
        break
    sessions: List[dict] = []
    for rec in _iter_validated(lines):
        if rec["kind"] == "meta":
            sessions.append({"meta": rec, "records": []})
        else:
            if "value" in rec:
                rec["value"] = _restore_nonfinite(rec["value"])
            sessions[-1]["records"].append(rec)
    if truncated is not None and sessions:
        last = sessions[-1]["records"]
        rec = {"kind": "event", "name": "mesh_truncated_tail",
               "seq": (last[-1]["seq"] + 1 if last else 1),
               "t": (last[-1]["t"] if last
                     else sessions[-1]["meta"].get("t_perf", 0.0)),
               "tid": 0, "sid": None, "attrs": truncated}
        validate_record(rec)    # the synthetic warning obeys the schema
        last.append(rec)
    return sessions


def aggregate_sessions(paths: Union[str, Iterable[str]]) -> dict:
    """Merge multi-process JSONL traces into one mesh-wide view.

    ``paths``: one path, or an iterable of paths (one per process/rank —
    or a single file every rank appended to; both layouts hold one meta
    header per session).  Returns::

        {"sessions":  [{"meta": ..., "records": [...]}, ...],
         "n_sessions": int, "n_records": int,
         "dropped_records": int,          # ring-overflow total
         "counters": {(name, labelitems): sum},   # mesh-wide sums
         "gauges":   {(name, labelitems): last},  # last write wins
         "spans":    {name: {"count": n, "total_s": s}},
         "events":   {name: count}}

    Counter samples are summed across sessions — that is what makes the
    per-rank halo byte counters a single mesh-wide total; spans keep
    per-name totals (wall-clock overlap across processes is the Chrome
    trace's job, :mod:`amgx_tpu_torch.telemetry.tracefile`)."""
    if isinstance(paths, str):
        paths = [paths]
    sessions: List[dict] = []
    for p in paths:
        sessions.extend(read_sessions(p))
    counters: dict = {}
    gauges: dict = {}
    spans: dict = {}
    events: dict = {}
    # meta.dropped and the ring_overflow events' dropped_total are
    # CUMULATIVE per-process counters — merge with max within one
    # process identity (bench appends one session per case from the
    # same process; summing their metas would overcount), sum across
    # distinct processes
    dropped_by_proc: dict = {}
    for i, s in enumerate(sessions):
        proc = (s["meta"].get("pid"), s["meta"].get("session")) \
            if s["meta"].get("session") else ("?", i)
        s_dropped = int(s["meta"].get("dropped", 0) or 0)
        for r in s["records"]:
            kind = r["kind"]
            if kind == "counter":
                key = (r["name"], tuple(sorted(r["labels"].items())))
                counters[key] = counters.get(key, 0) + r["value"]
            elif kind == "gauge":
                key = (r["name"], tuple(sorted(r["labels"].items())))
                gauges[key] = r["value"]
            elif kind == "span_end":
                d = spans.setdefault(r["name"],
                                     {"count": 0, "total_s": 0.0})
                d["count"] += 1
                d["total_s"] += r["dur"]
            elif kind == "event":
                events[r["name"]] = events.get(r["name"], 0) + 1
                if r["name"] == "ring_overflow":
                    s_dropped = max(s_dropped, int(
                        r["attrs"].get("dropped_total", 0) or 0))
        dropped_by_proc[proc] = max(dropped_by_proc.get(proc, 0),
                                    s_dropped)
    dropped = sum(dropped_by_proc.values())
    return {"sessions": sessions, "n_sessions": len(sessions),
            "n_records": sum(len(s["records"]) for s in sessions),
            "dropped_records": dropped,
            "counters": counters, "gauges": gauges,
            "spans": spans, "events": events}


def _prom_num(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _prom_escape(v: str) -> str:
    """Label-value escaping per the text exposition format: backslash,
    double-quote and newline must be escaped or the series line is
    unparseable (a pack name or file path label can carry any of them)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _prom_labels(lk) -> str:
    if not lk:
        return ""
    return "{" + ",".join(f'{k}="{_prom_escape(v)}"' for k, v in lk) + "}"


def prometheus_text() -> str:
    """Registry snapshot in the Prometheus text exposition format."""
    counters, gauges, hists = metrics.registry().items()
    out: List[str] = []
    seen = set()

    def header(name, mtype):
        if name in seen:
            return
        seen.add(name)
        t, h = metrics.METRICS.get(name, (mtype, ""))
        if h:
            out.append(f"# HELP {name} {h}")
        out.append(f"# TYPE {name} {t}")

    for (name, lk), v in sorted(counters.items()):
        header(name, "counter")
        out.append(f"{name}{_prom_labels(lk)} {_prom_num(v)}")
    for (name, lk), v in sorted(gauges.items()):
        header(name, "gauge")
        out.append(f"{name}{_prom_labels(lk)} {_prom_num(v)}")
    for (name, lk), (bounds, counts, total, count) in sorted(
            hists.items()):
        header(name, "histogram")

        def bucket_labels(le):
            return _prom_labels(sorted(dict(lk, le=le).items()))

        cum = 0
        for b, c in zip(bounds, counts):
            cum += c
            out.append(f"{name}_bucket"
                       f"{bucket_labels(_prom_num(float(b)))} {cum}")
        out.append(f"{name}_bucket{bucket_labels('+Inf')} {count}")
        out.append(f"{name}_sum{_prom_labels(lk)} {_prom_num(total)}")
        out.append(f"{name}_count{_prom_labels(lk)} {count}")
    return "\n".join(out) + "\n"

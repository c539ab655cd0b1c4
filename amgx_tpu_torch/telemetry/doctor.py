"""Solve doctor: turn a JSONL telemetry trace into a diagnosis.

``python -m amgx_tpu_torch.telemetry.doctor trace.jsonl [more.jsonl ...]``
reads one or more trace files (multi-process sessions merge into one
mesh-wide view via :func:`amgx_tpu_torch.telemetry.export.aggregate_sessions`)
and prints what a performance engineer would ask the trace first:

* where the wall time went (phase histograms + the span table),
* what SpMV packs were chosen and what fell back, with the cost-model
  view (bytes/flops per level, padding waste),
* the distributed picture: halo wire bytes vs local work, boundary
  fractions, ring hops,
* the convergence trajectory: iterations, final residual, and
  plateau/stall detection over the per-iteration residual events,
* convergence forensics, when the trace carries ``forensics=1`` events
  (:mod:`amgx_tpu_torch.telemetry.forensics`): the per-level per-component
  reduction-factor table (pre-smooth / coarse correction /
  post-smooth), hierarchy quality probes, and the weakest
  level/component named explicitly,
* concrete hints ("level 3 fell back to segment-sum: over padding
  budget by 2.1×", "level 2 post-smooth reduction 0.97 → raise
  postsweeps or switch smoother", ...).

``--diff other.jsonl`` compares two traces level by level — the
pipeline-on/off or 64³-vs-128³ A/B view: iteration counts, asymptotic
rates, per-level component factors side by side with the drifts
called out.  ``--json`` prints the machine-readable diagnosis
instead.  Everything is host-side file parsing — no device work, no
compiles.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

from .export import aggregate_sessions
from .forensics import COMPONENTS

#: trailing per-iteration reduction factor above which the residual is
#: considered plateaued (a healthy AMG-preconditioned solve reduces
#: ~10× per iteration; 0.97 ≈ 3%/iter is going nowhere)
PLATEAU_FACTOR = 0.97
PLATEAU_MIN_ITERS = 5
#: padding-waste ratio past which a level pack earns a hint
WASTE_HINT = 2.0
#: levels smaller than this never earn a padding hint (tiny coarse
#: grids pad by construction and cost microseconds)
WASTE_MIN_ROWS = 4096
#: halo-vs-local byte ratio past which the solve reads comms-bound
HALO_HINT = 0.5
#: fraction of a multi-lane service's resident sessions on ONE lane
#: past which the doctor flags lane imbalance (affinity concentrates
#: sessions by design; hoarding means replication never triggered)
LANE_IMBALANCE_SHARE = 0.6
#: per-component geometric-mean reduction factor past which a cycle
#: component earns a "weakest link" hint (a healthy V-cycle smoothing
#: component reduces the residual well below this; 0.85+ means the
#: component barely helps and ~1.0 means it does nothing)
WEAK_COMPONENT = 0.85
#: coarse-correction factor past which the correction is flagged as
#: amplifying.  NOT 1.0: a healthy coarse correction routinely grows
#: the RESIDUAL norm transiently (the prolongated correction injects
#: high-frequency residual the post-smoother then removes) — only
#: sustained growth past this is pathological
AMPLIFY_HINT = 1.5
#: sampled Galerkin relative error past which the stored coarse
#: operator no longer matches R·A·P (value drift, stale resetup)
GALERKIN_ERR_HINT = 1e-6
#: near-nullspace metric past which a level lost the constant vector
NULLSPACE_HINT = 0.9
#: absolute component-factor drift that earns a diff-mode callout
DIFF_DRIFT = 0.1
#: share of a rendezvous group's collectives in which ONE rank arrives
#: last past which the doctor names it a straggler (a balanced mesh
#: rotates the last arrival; a fixed last rank is a partition problem)
MESH_STRAGGLER_SHARE = 0.6
#: rendezvous count below which a group earns no straggler hint (a
#: handful of collectives can all land on one rank by chance)
MESH_MIN_COLLECTIVES = 4
#: fraction of total mesh wait inside fused Krylov reductions past
#: which the doctor points at compute skew instead of the collective
MESH_KRYLOV_WAIT_SHARE = 0.5


def _label_get(labels: Tuple, key: str):
    for k, v in labels:
        if k == key:
            return v
    return None


def _fmt_bytes(b) -> str:
    if b is None:
        return "?"
    for unit in ("B", "KB", "MB", "GB"):
        if abs(b) < 1024.0:
            return f"{b:.1f} {unit}" if unit != "B" else f"{int(b)} B"
        b /= 1024.0
    return f"{b:.1f} TB"


def _residual_trails(agg) -> List[List[Tuple[int, float]]]:
    """Per-solve residual trajectories: the residual events of each
    session, split into trails wherever iteration restarts at 0."""
    trails: List[List[Tuple[int, float]]] = []
    for s in agg["sessions"]:
        cur: List[Tuple[int, float]] = []
        for r in s["records"]:
            if r["kind"] != "event" or r["name"] != "residual":
                continue
            it = r["attrs"].get("iteration")
            nrm = r["attrs"].get("norm")
            if not isinstance(it, int):
                continue
            if isinstance(nrm, str):      # "Infinity"/"NaN" tokens
                nrm = float(nrm.replace("Infinity", "inf")
                            .replace("NaN", "nan"))
            if it == 0 and cur:
                trails.append(cur)
                cur = []
            cur.append((it, float(nrm)))
        if cur:
            trails.append(cur)
    return trails


def _plateau(trail: List[Tuple[int, float]]) -> Optional[dict]:
    """Longest trailing run of per-iteration reduction factors above
    PLATEAU_FACTOR (stall = factor ≥ 1).  None when converging fine."""
    if len(trail) < PLATEAU_MIN_ITERS + 1:
        return None
    norms = [n for _, n in trail]
    run = 0
    stalled = 0
    for a, b in zip(norms[-2::-1], norms[:0:-1]):   # backwards pairs
        if a <= 0:
            break
        f = b / a
        if f > PLATEAU_FACTOR:
            run += 1
            if f >= 1.0:
                stalled += 1
        else:
            break
    if run >= PLATEAU_MIN_ITERS:
        return {"iterations": run, "from_iteration": trail[-1 - run][0],
                "stalled": stalled, "norm": norms[-1]}
    return None


def diagnose(paths: List[str]) -> dict:
    """Machine-readable diagnosis of one or more JSONL traces."""
    agg = aggregate_sessions(paths)
    counters, gauges = agg["counters"], agg["gauges"]

    def csum(name, **match):
        tot = 0.0
        by = {}
        for (n, lk), v in counters.items():
            if n != name:
                continue
            if any(_label_get(lk, k) != str(mv)
                   for k, mv in match.items()):
                continue
            tot += v
            by[",".join(f"{k}={v2}" for k, v2 in lk) or "_"] = v
        return tot, by

    def glast(name):
        out = {}
        for (n, lk), v in gauges.items():
            if n == name:
                out[lk] = v
        return out

    # ---- phases (top-level only: the hist samples) ------------------
    phases = {}
    for s in agg["sessions"]:
        for r in s["records"]:
            if r["kind"] != "hist" or not r["name"].startswith("amgx_") \
                    or not r["name"].endswith("_seconds"):
                continue
            if r["name"].startswith("amgx_serve_"):
                # request latency is not a wall phase (overlapping
                # requests sum past wall time); the serving section
                # reports it as percentiles instead
                continue
            key = r["name"][len("amgx_"):-len("_seconds")]
            d = phases.setdefault(key, {"count": 0, "total_s": 0.0})
            d["count"] += 1
            d["total_s"] = round(d["total_s"] + float(r["value"]), 6)

    # ---- packs + fallbacks ------------------------------------------
    _, packs = csum("amgx_spmv_dispatch_total")
    _, fallbacks = csum("amgx_spmv_fallback_total")

    # ---- hierarchy + cost model -------------------------------------
    levels = {}
    for lk, v in glast("amgx_level_rows").items():
        levels.setdefault(str(_label_get(lk, "level")), {})["rows"] = v
    for lk, v in glast("amgx_level_nnz").items():
        levels.setdefault(str(_label_get(lk, "level")), {})["nnz"] = v
    for s in agg["sessions"]:
        for r in s["records"]:
            if r["kind"] == "event" and r["name"] == "level_cost":
                lvl = str(r["attrs"].get("level"))
                levels.setdefault(lvl, {}).update(
                    {k: v for k, v in r["attrs"].items()
                     if k != "level"})
    op_cost = None
    op_costs = {}              # pack -> last dispatched cost descriptor
    rejected = []
    for s in agg["sessions"]:
        for r in s["records"]:
            if r["kind"] != "event":
                continue
            if r["name"] == "operator_cost":
                op_cost = r["attrs"]
            elif r["name"] == "op_cost":
                # keep the LARGEST operator per pack — a hierarchy
                # dispatches many dia levels and the fine one is the
                # number worth showing next to the dispatch count
                pk = str(r["attrs"].get("pack", "?"))
                prev = op_costs.get(pk)
                if prev is None or (r["attrs"].get("bytes_per_apply")
                                    or 0) > (prev.get("bytes_per_apply")
                                             or 0):
                    op_costs[pk] = r["attrs"]
            elif r["name"] == "binned_plan_rejected":
                rejected.append(r["attrs"])

    # ---- distributed ------------------------------------------------
    halo_bytes, halo_by = csum("amgx_halo_bytes_total")
    halo_entries, _ = csum("amgx_halo_entries_total")
    exchanges, _ = csum("amgx_halo_exchange_total")
    bnd = {str(_label_get(lk, "device")): v
           for lk, v in glast("amgx_dist_boundary_fraction").items()}
    # per-level overlap audit + agglomeration lifecycle
    # (costmodel.dist_overlap events + distributed/agglomerate.py)
    dist_levels: Dict[str, dict] = {}
    agglomerations: List[dict] = []
    krylov_events: List[dict] = []
    device_anatomy: Optional[dict] = None
    hbm_snapshot: Optional[dict] = None
    oom_postmortems: List[dict] = []
    for s in agg["sessions"]:
        for r in s["records"]:
            if r["kind"] != "event":
                continue
            if r["name"] == "dist_overlap":
                dist_levels[str(r["attrs"].get("level"))] = \
                    dict(r["attrs"])
            elif r["name"] == "dist_agglomerate":
                agglomerations.append(dict(r["attrs"]))
            elif r["name"] == "krylov_comm":
                krylov_events.append(dict(r["attrs"]))
            elif r["name"] == "device_anatomy":
                # last anatomy wins — one capture per profiled solve
                device_anatomy = dict(r["attrs"])
            elif r["name"] == "hbm_snapshot":
                # last ledger snapshot wins — what is resident NOW
                hbm_snapshot = dict(r["attrs"])
            elif r["name"] == "oom_postmortem":
                oom_postmortems.append(dict(r["attrs"]))
    local_bytes = sum(float(d.get("bytes_per_apply") or 0)
                      for d in levels.values())
    if not local_bytes and op_cost:
        local_bytes = float(op_cost.get("bytes_per_apply") or 0)
    halo_per_apply = None
    if op_cost and op_cost.get("halo_bytes_per_apply"):
        halo_per_apply = float(op_cost["halo_bytes_per_apply"])
    halo_local_ratio = None
    if halo_per_apply and local_bytes:
        halo_local_ratio = round(halo_per_apply / local_bytes, 4)

    # ---- communication-avoiding Krylov (krylov_comm events) --
    # keys on SHARDED solves only — single-device reductions are
    # register traffic and a collectives table there is noise
    krylov = None
    sharded_kc = [e for e in krylov_events
                  if int(e.get("n_parts") or 1) > 1]
    if sharded_kc:
        by_mode: Dict[str, dict] = {}
        for e in sharded_kc:       # last event per (solver, mode) wins
            by_mode[f"{e.get('solver')}/{e.get('mode')}"] = e
        krylov = {
            "solves": by_mode,
            # profiler-measured overlap fractions (telemetry/overlap.py)
            # vs the modelled ones still in the distributed table
            "measured_overlap": {
                lvl: d.get("overlap_fraction")
                for lvl, d in dist_levels.items() if d.get("measured")},
        }

    # ---- serving (amgx_tpu/serve/) ----------------------------------
    req_total, req_by = csum("amgx_serve_requests_total")
    rej_total, rej_by = csum("amgx_serve_rejected_total")
    setups_total, setups_by = csum("amgx_serve_setup_total")
    cache_hits, _ = csum("amgx_serve_cache_hits_total")
    cache_misses, _ = csum("amgx_serve_cache_misses_total")
    cache_evict, _ = csum("amgx_serve_cache_evictions_total")
    batch_sizes, req_lat = [], []
    for s in agg["sessions"]:
        for r in s["records"]:
            if r["kind"] != "hist":
                continue
            if r["name"] == "amgx_serve_batch_size":
                batch_sizes.append(float(r["value"]))
            elif r["name"] == "amgx_serve_request_seconds":
                req_lat.append(float(r["value"]))
    serving = None
    if req_total or batch_sizes or cache_hits or cache_misses:
        req_lat.sort()

        def _pct(p):
            if not req_lat:
                return None
            return req_lat[min(len(req_lat) - 1,
                               int(round(p * (len(req_lat) - 1))))]

        serving = {
            "requests": {k: int(v) for k, v in sorted(req_by.items())},
            "rejections": {k: int(v) for k, v in sorted(rej_by.items())},
            "setup_kinds": {k: int(v)
                            for k, v in sorted(setups_by.items())},
            "cache": {"hits": int(cache_hits),
                      "misses": int(cache_misses),
                      "evictions": int(cache_evict)},
            "batches": {
                "count": len(batch_sizes),
                "mean_size": (round(sum(batch_sizes) / len(batch_sizes),
                                    2) if batch_sizes else None),
                "max_size": (int(max(batch_sizes))
                             if batch_sizes else None),
            },
            "latency_s": {"p50": _pct(0.50), "p95": _pct(0.95),
                          "p99": _pct(0.99)},
        }

    # ---- serving lanes (serve/router.py: multi-device scale-out) ----
    # per-lane executor state from the lane-labeled gauges + the
    # router's steal/replication counters; request_trace events carry
    # the per-request lane + routing decision
    lane_map: Dict[str, dict] = {}
    for gname, key in (("amgx_serve_lane_sessions", "sessions"),
                       ("amgx_serve_lane_queue_depth", "queue_depth"),
                       ("amgx_serve_lane_inflight", "inflight"),
                       ("amgx_serve_lane_attainment", "attainment")):
        for lk, v in glast(gname).items():
            ln = str(_label_get(lk, "lane"))
            lane_map.setdefault(ln, {})[key] = v
    steals_total, steals_by = csum("amgx_serve_steals_total")
    reps_total, reps_by = csum("amgx_serve_replications_total")
    route_counts: Dict[str, int] = {}
    lane_req_counts: Dict[str, int] = {}
    for s in agg["sessions"]:
        for r in s["records"]:
            if r["kind"] == "event" and r["name"] == "request_trace":
                rt = r["attrs"].get("route")
                if rt:
                    route_counts[str(rt)] = \
                        route_counts.get(str(rt), 0) + 1
                ln = r["attrs"].get("lane")
                if ln is not None:
                    lane_req_counts[str(ln)] = \
                        lane_req_counts.get(str(ln), 0) + 1
    for ln, n in lane_req_counts.items():
        lane_map.setdefault(ln, {})["requests"] = n
    lanes_diag = None
    if len(lane_map) > 1 or steals_total or reps_total:
        total_sessions = sum(int(d.get("sessions") or 0)
                             for d in lane_map.values())
        lanes_diag = {
            "lanes": {k: lane_map[k]
                      for k in sorted(lane_map, key=str)},
            "total_sessions": int(total_sessions),
            "steals": int(steals_total),
            "steals_by_lane": {k: int(v)
                               for k, v in sorted(steals_by.items())},
            "replications": int(reps_total),
            "replications_by_lane": {
                k: int(v) for k, v in sorted(reps_by.items())},
            "routes": dict(sorted(route_counts.items())),
        }

    # ---- SLO (telemetry/slo.py + request-lifecycle tracing) ---------
    slo_snap = None
    outcome_counts: Dict[str, int] = {}
    phase_tot: Dict[str, list] = {}
    for s in agg["sessions"]:
        for r in s["records"]:
            if r["kind"] == "event" and r["name"] == "slo_window":
                slo_snap = dict(r["attrs"])     # last snapshot wins
            elif r["kind"] == "event" and r["name"] == "request_trace":
                oc = str(r["attrs"].get("outcome", "?"))
                outcome_counts[oc] = outcome_counts.get(oc, 0) + 1
            elif r["kind"] == "hist" and \
                    r["name"] == "amgx_serve_phase_seconds":
                ph = str(r["labels"].get("phase", "?"))
                d = phase_tot.setdefault(ph, [0, 0.0])
                d[0] += 1
                d[1] += float(r["value"])
    slo = None
    if slo_snap or outcome_counts:
        slo = {
            "window": slo_snap,
            "outcomes": dict(sorted(outcome_counts.items())),
            "phase_split": {ph: {"count": int(n),
                                 "mean_s": round(t / n, 6) if n else None}
                            for ph, (n, t)
                            in sorted(phase_tot.items())},
        }

    # ---- convergence ------------------------------------------------
    conv = {}
    for name, key in (("amgx_solve_iterations", "iterations"),
                      ("amgx_solve_final_relres", "final_relres"),
                      ("amgx_solve_convergence_rate", "rate")):
        g = glast(name)
        if g:
            conv[key] = list(g.values())[-1]
    trails = _residual_trails(agg)
    plateau = _plateau(trails[-1]) if trails else None
    divergences = agg["events"].get("divergence", 0)
    g = glast("amgx_forensics_asymptotic_rate")
    if g:
        conv["asymptotic_rate"] = list(g.values())[-1]

    # ---- convergence forensics (telemetry/forensics.py) -------------
    from . import forensics as _forensics
    fr = _forensics.analyze(r for s in agg["sessions"]
                            for r in s["records"])

    # ---- setup attribution (telemetry/setup_profile.py) -------------
    from . import setup_profile as _setup_profile
    setup = _setup_profile.analyze(r for s in agg["sessions"]
                                   for r in s["records"])

    # ---- device setup engine fallbacks (amg/device_setup/) ----------
    setup_fallbacks = [dict(r["attrs"]) for s in agg["sessions"]
                       for r in s["records"]
                       if r["kind"] == "event"
                       and r["name"] == "device_setup_fallback"]

    # ---- warm-start layer (compile cache + AOT store) ---------------
    cc_hits, cc_hits_by = csum("amgx_compile_cache_hits_total")
    cc_miss, cc_miss_by = csum("amgx_compile_cache_misses_total")
    cc_fb, cc_fb_by = csum("amgx_compile_cache_fallbacks_total")
    compile_cache = None
    if cc_hits or cc_miss or cc_fb:
        lookups = cc_hits + cc_miss
        # the compile-share hint reasons about XLA compiles, so its
        # rate must be the XLA layer's own — a warm AOT store next to
        # a cold XLA cache would otherwise read as "loads dominate"
        xla_hits, _ = csum("amgx_compile_cache_hits_total", layer="xla")
        xla_miss, _ = csum("amgx_compile_cache_misses_total",
                           layer="xla")
        xla_lk = xla_hits + xla_miss
        compile_cache = {
            "hits": int(cc_hits), "misses": int(cc_miss),
            "fallbacks": int(cc_fb),
            "hit_rate": round(cc_hits / lookups, 4) if lookups else None,
            "xla_hit_rate": (round(xla_hits / xla_lk, 4)
                             if xla_lk else None),
            "hits_by_layer": {k: int(v)
                              for k, v in sorted(cc_hits_by.items())},
            "misses_by_layer": {k: int(v)
                                for k, v in sorted(cc_miss_by.items())},
            "fallbacks_by_reason": {k: int(v)
                                    for k, v in sorted(cc_fb_by.items())},
        }

    # ---- failures & recovery (errors.FailureKind +
    # ---- solvers/recovery.py + utils/faultinject.py) ----------------
    recov_total, recov_by = csum("amgx_recovery_total")
    fi_total, fi_by = csum("amgx_fault_injected_total")
    trunc_total, _ = csum("amgx_history_truncated_total")
    fail_total, fail_by = csum("amgx_solve_failures_total")
    q_total, _ = csum("amgx_serve_quarantined_total")
    serve_retries, _ = csum("amgx_serve_retries_total")
    breaker_trips, _ = csum("amgx_serve_breaker_trips_total")
    recovery_events: List[dict] = []
    breakdown_events: List[dict] = []
    quarantine_events: List[dict] = []
    for s in agg["sessions"]:
        for r in s["records"]:
            if r["kind"] != "event":
                continue
            if r["name"] == "recovery_attempt":
                recovery_events.append(dict(r["attrs"]))
            elif r["name"] == "breakdown":
                breakdown_events.append(dict(r["attrs"]))
            elif r["name"] == "pattern_quarantined":
                quarantine_events.append(dict(r["attrs"]))
    failures = None
    if recov_total or recovery_events or fi_total or trunc_total \
            or fail_total or q_total or serve_retries or breaker_trips:
        recovered = sum(
            v for k, v in recov_by.items() if "outcome=recovered" in k)
        exhausted = sum(
            v for k, v in recov_by.items() if "outcome=exhausted" in k)
        # EXECUTED attempts only: the terminal action=ladder sample and
        # skipped (inapplicable, zero-budget) rungs are audit records,
        # not attempts — counting them would inflate the attempt total
        # and mis-fire the repeated-engagement hint
        att_counter = sum(
            v for k, v in recov_by.items()
            if "action=ladder" not in k and "outcome=skipped" not in k)
        att_events = sum(
            1 for e in recovery_events
            if e.get("action") != "ladder"
            and e.get("outcome") != "skipped")
        failures = {
            "solve_failures_by_kind": {
                k: int(v) for k, v in sorted(fail_by.items())},
            "breakdowns": breakdown_events[-8:],
            "recovery_attempts": int(max(att_counter, att_events)),
            "recovery_by": {k: int(v)
                            for k, v in sorted(recov_by.items())},
            "recovered": int(recovered),
            "exhausted": int(exhausted),
            "recovery_events": recovery_events[-16:],
            "fault_injected": {k: int(v)
                               for k, v in sorted(fi_by.items())},
            "history_truncated": int(trunc_total),
            "quarantined": int(q_total),
            "quarantine_events": quarantine_events[-8:],
            "serve_retries": int(serve_retries),
            "breaker_trips": int(breaker_trips),
        }

    # ---- hints ------------------------------------------------------
    hints: List[str] = []
    if agg["dropped_records"]:
        hints.append(
            f"trace truncated: {int(agg['dropped_records'])} records "
            "dropped by ring overflow — raise telemetry_ring_size (or "
            "flush more often via telemetry_path)")
    for lbl, cnt in sorted(fallbacks.items()):
        hints.append(f"SpMV fallback {lbl}: {int(cnt)}× — a packed "
                     "kernel layout took a generic path")
    for rej in rejected:
        over = rej.get("over_budget")
        lvl = rej.get("level")
        where = f"level {lvl}" if lvl is not None else \
            f"a {rej.get('rows', '?')}-row operator"
        if isinstance(over, (int, float)):
            hints.append(f"{where} fell back to segment-sum: over "
                         f"padding budget by {over:.1f}×")
        elif rej.get("reason") == "index_space":
            hints.append(f"{where} fell back to segment-sum: the "
                         "binned plan exceeds the int32 index space")
        else:
            hints.append(f"{where} fell back to segment-sum (binned "
                         "plan rejected)")
    for lvl, d in sorted(levels.items(), key=lambda kv: str(kv[0])):
        w = d.get("padding_waste")
        rows = d.get("rows") or 0
        # tiny coarse levels waste bandwidth by construction and cost
        # nothing — only flag levels big enough to matter
        if isinstance(w, (int, float)) and w > WASTE_HINT \
                and rows >= WASTE_MIN_ROWS:
            hints.append(
                f"level {lvl} pack {d.get('pack', '?')} wastes "
                f"{w:.2f}× bandwidth on padding slots")
    # mixed precision (core/precision.py): a multi-level f32 hierarchy
    # whose SpMV is bandwidth-class (dia/shift/window/binned — the
    # memory-bound packs) leaves the single biggest single-chip lever
    # unpulled: bf16 storage halves every level's value bytes while
    # arithmetic stays f32
    lvl_dts = {str(d.get("dtype")) for d in levels.values()
               if d.get("dtype")}
    bw_packs = ("dia", "dia3", "ell/shift", "ell/window", "ell/binned",
                "csr/binned")
    if len(levels) >= 2 and lvl_dts and lvl_dts <= {"float32"} and \
            any(str(d.get("pack", "")).startswith(bw_packs)
                for d in levels.values()):
        hints.append(
            "bandwidth-bound f32 hierarchy: every level stores float32"
            " — try mixed precision (hierarchy_dtype=bfloat16) to "
            "halve per-cycle HBM bytes; arithmetic accumulates in f32 "
            "and tolerances below the f32 floor still converge via "
            "the promotion ladder (krylov_dtype stays float32)")
    if halo_local_ratio is not None and halo_local_ratio > HALO_HINT:
        hints.append(
            f"halo exchange moves {halo_local_ratio:.2f}× the local "
            "SpMV bytes — the solve is communication-bound; consider "
            "fewer, fatter shards or overlapping more work")
    halo_bound = [d for d in dist_levels.values()
                  if d.get("halo_bound")]
    if halo_bound:
        worst = max(int(d.get("rows_per_part") or 0)
                    for d in halo_bound)
        if agglomerations:
            hints.append(
                f"{len(halo_bound)} distributed level(s) remain "
                "halo-bound after agglomeration — raise "
                f"dist_agglomerate_min_rows above {worst} rows/device "
                "so they land on a smaller sub-mesh")
        else:
            hints.append(
                f"{len(halo_bound)} distributed level(s) are "
                "halo-bound (halo time exceeds the interior "
                "SpMV even with perfect overlap) — set "
                f"dist_agglomerate_min_rows above {worst} rows/device "
                "to agglomerate those levels onto a shrinking "
                "sub-mesh")
    if krylov:
        for _key, e in sorted(krylov["solves"].items()):
            if e.get("mode") == "CLASSIC" and e.get("reduction_bound"):
                hints.append(
                    f"dot-product reductions dominate the sharded "
                    f"{e.get('solver')} solve (modelled "
                    f"{float(e.get('est_reduction_s') or 0)*1e6:.1f} us"
                    f"/iter across {int(e.get('collectives_per_iter') or 0)}"
                    " collectives vs "
                    f"{float(e.get('est_spmv_s') or 0)*1e6:.1f} us "
                    "interior SpMV) — try krylov_comm=PIPELINED to fuse "
                    "them into one collective overlapped with the SpMV")
                break
    if plateau:
        hints.append(
            f"residual plateaued for {plateau['iterations']} iterations "
            f"(from iteration {plateau['from_iteration']}, "
            f"norm ~{plateau['norm']:.3e})"
            + (" and STALLED outright" if plateau["stalled"] else "")
            + " — consider a stronger smoother/preconditioner or check "
              "the operator's conditioning")
    if divergences:
        hints.append(f"{int(divergences)} divergence event(s): a "
                     "residual went non-finite")
    if failures:
        # the recovery ladder saving a solve ONCE is working as
        # designed; repeated engagement means the underlying breakdown
        # keeps happening — a masked root cause burning 2-5× solve cost
        n_rec = failures["recovery_attempts"]
        if n_rec >= 2:
            kinds = sorted({str(e.get("kind")) for e
                            in failures["recovery_events"]}
                           or set(failures["solve_failures_by_kind"]))
            hints.append(
                f"recovery ladder engaged {n_rec}× "
                f"({failures['recovered']} recovered, "
                f"{failures['exhausted']} exhausted"
                + (f"; kinds: {', '.join(k for k in kinds if k)}"
                   if kinds else "")
                + ") — recovered solves pay 2-5× wall cost; find the "
                  "root cause in the breakdown kinds instead of "
                  "relying on the ladder")
        if failures["exhausted"]:
            hints.append(
                f"{failures['exhausted']} solve(s) exhausted the "
                "recovery ladder unrecovered — the failure survives "
                "restart, promotion, a conservative smoother AND a "
                "full re-setup: suspect the operator/rhs themselves")
        if failures["fault_injected"]:
            pts = ", ".join(f"{k}: {v}" for k, v
                            in failures["fault_injected"].items())
            hints.append(
                f"fault injection was ACTIVE in this trace ({pts}) — "
                "failures here include synthetic chaos faults, not "
                "production signal")
        if failures["history_truncated"]:
            hints.append(
                f"{failures['history_truncated']} residual history "
                "slab(s) carried non-finite rows (history_truncated "
                "events name the first bad iteration) — the iteration "
                "record around a breakdown is partial")
        if failures["quarantined"]:
            hints.append(
                f"{failures['quarantined']} pattern(s) quarantined "
                "after repeated setup/solve errors — clients of those "
                "patterns are being rejected at admission; fix the "
                "operator and lift via SolveService.unquarantine()")
    hints.extend(_forensics_hints(fr))
    hints.extend(_setup_hints(setup, setup_fallbacks, compile_cache))
    if compile_cache and compile_cache["fallbacks"]:
        reasons = ", ".join(
            f"{k}: {v}" for k, v
            in compile_cache["fallbacks_by_reason"].items())
        hints.append(
            f"{compile_cache['fallbacks']} AOT-store fallback(s) "
            f"({reasons}) — version-mismatched entries recompile "
            "cleanly; re-warm the store after jaxlib upgrades, delete "
            "it if corruption repeats")
    jit, _ = csum("amgx_jit_compile_total")
    if jit:
        hints.append(f"{int(jit)} kernel build(s) in-trace — if these "
                     "landed inside a timed region, build first")
    if serving:
        if rej_total:
            hints.append(
                f"serving shed {int(rej_total)} request(s) "
                f"({', '.join(f'{k}: {int(v)}' for k, v in sorted(rej_by.items()))})"
                " — raise serve_queue_depth, add serve_workers, or relax "
                "deadlines")
        full = sum(v for k, v in setups_by.items() if "kind=full" in k)
        completed = sum(v for k, v in req_by.items()
                        if "status=SUCCESS" in k or "status=FAILED" in k)
        if completed and full >= completed:
            hints.append(
                "no setup reuse: every served request paid a full setup "
                "— requests never shared a (config, pattern) session")
        fails, _ = csum("amgx_worker_task_failures_total")
        if fails:
            hints.append(f"{int(fails)} worker task(s) raised — the pool "
                         "survived, but check the service error log")
    if lanes_diag and len(lanes_diag["lanes"]) > 1:
        # lane imbalance: affinity routing concentrates sessions by
        # design, but one lane hoarding most of them means replication
        # never triggered — the hot patterns' home lane saturates while
        # the rest of the mesh idles.  Balanced fleets stay silent.
        tot = lanes_diag["total_sessions"]
        if tot >= 4:
            top_ln, top_d = max(
                lanes_diag["lanes"].items(),
                key=lambda kv: int(kv[1].get("sessions") or 0))
            share = int(top_d.get("sessions") or 0) / tot
            if share >= LANE_IMBALANCE_SHARE:
                hints.append(
                    f"lane imbalance: lane {top_ln} holds "
                    f"{share:.0%} of {tot} resident sessions — the "
                    "replication threshold is too high for this "
                    "traffic: lower serve_replicate_frac (replicate "
                    "hot patterns earlier) or serve_steal_frac (steal "
                    "cold patterns off busy lanes sooner), or warm "
                    "the expected pattern set so homes pre-distribute")
    if slo:
        w = slo.get("window") or {}
        burn = w.get("burn_rate")
        if isinstance(burn, (int, float)) and burn > 1.0:
            att = w.get("attainment")
            hints.append(
                f"SLO error budget burning at {burn:.1f}× "
                + (f"(attainment {att:.1%} vs target "
                   f"{w.get('target', 0):.1%})"
                   if isinstance(att, (int, float)) else "")
                + " — shed load earlier, add capacity, or relax the "
                  "objective")
        if w.get("overloaded"):
            hints.append(
                "overload trip wire is ON (windowed shed rate or queue "
                "depth past threshold) — the service is past its "
                "capacity; scale out or lower the offered rate")
        ps = slo.get("phase_split", {})
        qw = (ps.get("queue_wait") or {}).get("mean_s")
        sv = (ps.get("solve") or {}).get("mean_s")
        if isinstance(qw, (int, float)) and isinstance(sv, (int, float)) \
                and sv > 0 and qw > sv:
            hints.append(
                f"queue_wait ({qw * 1e3:.1f} ms mean) exceeds solve "
                f"({sv * 1e3:.1f} ms mean) per request — latency is "
                "congestion, not compute: add serve_workers, shorten "
                "serve_batch_window_ms, or shed earlier")

    # ---- device anatomy (telemetry/deviceprof.py) ------------
    # host-vs-device skew: the solve span measures host DISPATCH under
    # JAX's async execution, the anatomy measures the device — a large
    # ratio either way is a diagnosis in itself
    if device_anatomy and device_anatomy.get("measured"):
        host_solve = (agg["spans"].get("solve") or {}).get("total_s")
        dev_total = device_anatomy.get("total_device_s")
        if isinstance(host_solve, (int, float)) \
                and isinstance(dev_total, (int, float)) \
                and host_solve > 0 and dev_total > 0:
            skew = host_solve / dev_total
            if skew > 3.0:
                hints.append(
                    f"host-vs-device skew: the solve span measured "
                    f"{host_solve:.3f}s on the host but the profiler "
                    f"saw only {dev_total:.3f}s of device time "
                    f"({skew:.1f}×) — the solve is host/dispatch-bound "
                    "(python overhead, retraces, blocking transfers), "
                    "not device-bound; check amgx_jit_trace_total "
                    "before tuning kernels")
            elif skew < 1.0 / 3.0:
                hints.append(
                    f"host-vs-device skew: {dev_total:.3f}s of device "
                    f"time behind a {host_solve:.3f}s host solve span "
                    f"({1 / skew:.1f}×) — async dispatch returned "
                    "before the device finished; host spans understate "
                    "the real cost, trust the device anatomy")
        un = device_anatomy.get("unattributed_s")
        tot = device_anatomy.get("total_device_s")
        if isinstance(un, (int, float)) and isinstance(tot, (int, float)) \
                and tot > 0 and un / tot > 0.5:
            hints.append(
                f"device anatomy: {un / tot:.0%} of device time is "
                "outside every amgx/* scope — work is running that the "
                "taxonomy does not name (transfers, setup leftovers, "
                "or an uninstrumented kernel; scripts/telemetry_check "
                "lints registered kernels)")

    # ---- device memory (telemetry/memledger.py) --------------
    memory = None
    if hbm_snapshot is not None or oom_postmortems:
        memory = {"snapshot": hbm_snapshot,
                  "oom_postmortems": oom_postmortems}
        if hbm_snapshot and hbm_snapshot.get("measured"):
            for dev, d in (hbm_snapshot.get("devices") or {}).items():
                limit = d.get("bytes_limit") or 0
                head = d.get("headroom_bytes") or 0
                if limit > 0 and head / limit < 0.10:
                    top = sorted(
                        ((d.get("owners") or {})).items(),
                        key=lambda kv: -kv[1])[:1]
                    who = f" (largest owner {top[0][0]}, " \
                          f"{_fmt_bytes(top[0][1])})" if top else ""
                    hints.append(
                        f"device memory: {dev} is near its ceiling — "
                        f"{_fmt_bytes(head)} headroom of "
                        f"{_fmt_bytes(limit)}{who}; shrink "
                        "serve_cache_bytes, store hierarchies in "
                        "bfloat16 (hierarchy_dtype), or evict sessions "
                        "before the next setup OOMs")
        for pm in oom_postmortems:
            top = pm.get("top_owners") or []
            who = f"; top owner {top[0][0]} " \
                  f"({_fmt_bytes(top[0][1])})" if top else ""
            hints.append(
                f"device OOM in {pm.get('where')}"
                f"{' (injected)' if pm.get('injected') else ''}{who} — "
                "see the oom_postmortem event for the full ledger "
                "snapshot and eviction suggestions")

    # ---- mesh flight recorder (telemetry/meshtrace.py) -------
    # cross-rank rendezvous join; single-rank traces stay silent (the
    # per-rank sections above already cover them)
    mesh = None
    if agg["n_sessions"] >= 2:
        from . import meshtrace
        m = meshtrace.analyze_sessions(agg["sessions"])
        if m["n_ranks"] >= 2:
            mesh = m
    if mesh and mesh.get("measured"):
        _mesh_noun = {"halo": "halo exchanges",
                      "krylov": "Krylov reductions",
                      "agglomerate": "agglomerations"}
        for g in (mesh.get("groups") or {}).values():
            share = g.get("last_share")
            lr = g.get("last_rank_mode")
            if g["collectives"] >= MESH_MIN_COLLECTIVES \
                    and isinstance(share, (int, float)) \
                    and share >= MESH_STRAGGLER_SHARE \
                    and g["wait_s"] > 0:
                ind = (mesh["ranks"].get(lr) or {}).get(
                    "induced_wait_s") or 0.0
                hints.append(
                    f"mesh straggler: rank {lr} arrives last in "
                    f"{share:.0%} of {g['group']} "
                    f"{_mesh_noun.get(g['op'], g['op'])} (induced "
                    f"{ind:.3f}s of peer wait) → partition imbalance "
                    "— check amgx_dist_boundary_fraction and the "
                    "per-part row split before tuning the collective")
        total_wait = mesh.get("total_wait_s") or 0.0
        kry_wait = (mesh.get("wait_by_op") or {}).get("krylov", 0.0)
        if total_wait > 0 and kry_wait / total_wait \
                > MESH_KRYLOV_WAIT_SHARE \
                and any(rv.get("fused")
                        for rv in mesh.get("rendezvous") or []):
            hints.append(
                f"mesh wait is {kry_wait / total_wait:.0%} fused "
                "Krylov reductions — the solver is already at one "
                "collective per iteration, so the reduction itself is "
                "not the lever: the ranks reach it at different "
                "times; look at compute skew (arrival spread) and "
                "rebalance the partition")
        _miss: Dict = {}
        for e in mesh.get("desync") or []:
            if e["kind"] == "silent":
                hints.append(
                    f"mesh desync: rank {e['rank']}'s trace goes "
                    f"silent {e['gap_s']:.3f}s "
                    f"({e['gap_fraction']:.0%} of the mesh span) "
                    "before its peers stop — a crashed rank or a "
                    "stalled flush; check its tail for "
                    "mesh_truncated_tail / oom_postmortem events")
            elif e["kind"] == "missing_collectives":
                _miss.setdefault(e["rank"], []).append(e)
        for rnk, es in sorted(_miss.items()):
            e = es[0]
            more = f" (+{len(es) - 1} more group(s))" if len(es) > 1 \
                else ""
            hints.append(
                f"mesh desync: rank {rnk} ran {e['ran']} "
                f"{e['group']} {e['op']} collective(s) vs peers' "
                f"{e['peers_ran']}{more} — divergent control flow or "
                "an early exit; on real hardware the mesh deadlocks "
                "at the first collective this rank skips")

    return {
        "files": list(paths),
        "sessions": agg["n_sessions"], "records": agg["n_records"],
        "dropped_records": agg["dropped_records"],
        "phases": phases,
        "spans": {k: dict(v, total_s=round(v["total_s"], 6))
                  for k, v in agg["spans"].items()},
        "packs": {k: int(v) for k, v in sorted(packs.items())},
        "fallbacks": {k: int(v) for k, v in sorted(fallbacks.items())},
        "levels": levels,
        "operator_cost": op_cost,
        "op_costs": op_costs,
        "distributed": {
            "halo_exchanges": int(exchanges),
            "halo_wire_bytes": int(halo_bytes),
            "halo_entries": int(halo_entries),
            "halo_bytes_by_label": {k: int(v)
                                    for k, v in sorted(halo_by.items())},
            "boundary_fraction": bnd,
            "halo_local_ratio": halo_local_ratio,
            "levels": dist_levels,
            "agglomerations": agglomerations,
        },
        "krylov": krylov,
        "device": device_anatomy,
        "memory": memory,
        "mesh": mesh,
        "serving": serving,
        "serving_lanes": lanes_diag,
        "slo": slo,
        "failures": failures,
        "convergence": dict(conv, trails=len(trails),
                            plateau=plateau, divergences=int(divergences)),
        "forensics": fr,
        "setup": setup,
        "setup_fallbacks": setup_fallbacks,
        "compile_cache": compile_cache,
        "hints": hints,
    }


#: component → actionable knob, the concrete advice a weak component
#: earns ("which config line do I change")
_COMPONENT_ADVICE = {
    "pre_smooth": "raise presweeps or switch smoother",
    "post_smooth": "raise postsweeps or switch smoother",
    "coarse_corr": "inspect interpolation/strength (check the "
                   "amgx_forensics_galerkin_err and nullspace probes)",
    "coarse_solve": "raise coarsest_sweeps or use a direct coarse "
                    "solver (DENSE_LU_SOLVER)",
}

_COMPONENT_LABEL = {
    "pre_smooth": "pre-smooth", "post_smooth": "post-smooth",
    "coarse_corr": "coarse correction", "coarse_solve": "coarse solve",
}

#: the cycle components, in cut-point order — one authority
#: (forensics.COMPONENTS) so a new component shows up everywhere
COMP_ORDER = COMPONENTS


def _forensics_hints(fr: Optional[dict]) -> List[str]:
    """Actionable convergence hints from the forensics analysis: name
    dead smoothing components, stagnating levels, amplifying coarse
    corrections, weak coarse solves and failed quality probes.  Tuned
    to stay silent on a healthy trace: smoothing factors ~0.6 and a
    mildly-over-1 coarse-correction residual factor are normal."""
    if not fr:
        return []
    hints: List[str] = []
    levels = fr.get("levels", {})
    for lvl, d in sorted(levels.items()):
        for comp in ("pre_smooth", "post_smooth"):
            f = d.get(comp)
            if f is not None and f >= WEAK_COMPONENT:
                knob = "presweeps" if comp == "pre_smooth" \
                    else "postsweeps"
                verb = "does nothing" if f >= 0.98 else "barely reduces"
                hints.append(
                    f"level {lvl} {_COMPONENT_LABEL[comp]} {verb} "
                    f"(reduction {f:.2f}) → raise {knob} or switch "
                    "smoother")
        f = d.get("coarse_corr")
        if f is not None and f >= AMPLIFY_HINT:
            hints.append(
                f"coarse correction amplifying at level {lvl} "
                f"(factor {f:.2f}) → inspect interpolation")
        t = d.get("total")
        if t is not None and t >= WEAK_COMPONENT:
            # dominant component by baseline-NORMALISED severity
            # (forensics.component_score): a raw max would let a
            # healthy transiently-amplifying coarse correction
            # out-rank a dead smoother and misdirect the advice
            from .forensics import component_score
            worst = max(
                ((component_score(c, d[c]), d[c], c)
                 for c in COMP_ORDER if d.get(c) is not None),
                default=(None, None, None))
            if worst[0] is not None:
                hints.append(
                    f"level {lvl} cycle barely reduces the residual "
                    f"(total {t:.2f}); dominant component: "
                    f"{_COMPONENT_LABEL[worst[2]]} ({worst[1]:.2f}) → "
                    f"{_COMPONENT_ADVICE[worst[2]]}")
    c = fr.get("coarse")
    if c and c.get("factor") is not None and \
            c["factor"] >= WEAK_COMPONENT:
        hints.append(
            f"coarsest-grid solve at level {c['level']} barely reduces "
            f"(factor {c['factor']:.2f}) → "
            f"{_COMPONENT_ADVICE['coarse_solve']}")
    for lvl, p in sorted(fr.get("probes", {}).items()):
        ge = p.get("galerkin_err")
        if isinstance(ge, (int, float)) and ge > GALERKIN_ERR_HINT:
            hints.append(
                f"level {lvl}: stored coarse operator drifts from "
                f"R·A·P by {ge:.1e} (sampled) — a stale value refresh "
                "or a broken transfer")
        ns = p.get("nullspace")
        if isinstance(ns, (int, float)) and ns > NULLSPACE_HINT:
            hints.append(
                f"level {lvl}: operator no longer annihilates the "
                f"constant vector (|A·1|/|A| = {ns:.2f}) — the "
                "near-nullspace was lost in coarsening")
    return hints


#: setup components whose dominance reads "the algorithm runs host-side"
_HOST_SETUP_COMPONENTS = ("strength", "selector", "interpolation", "rap")

#: phases the device setup engine emits (amg/device_setup/, single
#: source: setup_profile.DEVICE_SETUP_COMPONENTS): their presence means
#: the Galerkin RAP already runs on device, so a dominant "rap" reads
#: "a level FELL BACK", not "build the engine"
from .setup_profile import \
    DEVICE_SETUP_COMPONENTS as _DEVICE_SETUP_COMPONENTS

#: fallback reasons that are by-design (tiny levels are host-faster) —
#: reported in the table but not hinted as problems
_BENIGN_FALLBACKS = ("small", "disabled")


def _setup_hints(setup: Optional[dict],
                 setup_fallbacks: Optional[List[dict]] = None,
                 compile_cache: Optional[dict] = None) -> List[str]:
    """Actionable setup-attribution hints (telemetry/setup_profile.py):
    compile-bound setups earn warm-start advice REFINED by the
    compile-cache hit rate when the trace carries it (``warmup`` is
    only suggested when misses dominate — a hitting cache with a high
    compile share is a different problem), host-dominated classical
    components point at the device-side setup engine
    (amg/device_setup/) — or, when its ``device_rap``/``spgemm`` phases
    are present, at the specific levels that FELL BACK to the host path
    (with the recorded reason); chatty transfers point at batching."""
    if not setup:
        return []
    from .setup_profile import (COMPILE_HINT, DOMINANT_HINT,
                                TRANSFER_HINT, UPLOAD_DRAIN_HINT)
    hints: List[str] = []
    s = setup.get("summary") or {}
    total = setup.get("total_s") or 0.0
    if total:
        # worker-thread compile (smoother-setup tasks) overlaps the
        # owner's wait phases but is still compile work a persistent
        # cache would remove — count it toward the hint, capped at 1
        cshare = min(((s.get("compile_s") or 0.0)
                      + (s.get("worker_compile_s") or 0.0)) / total, 1.0)
        if cshare >= COMPILE_HINT:
            # the port's compile bucket is kernel builds (nvcc, kept in
            # the build directory for the next process) and graph
            # captures (at an application's first call; a graph cannot
            # be stored, SolveService.warmup captures it off the request
            # path)
            hints.append(
                f"compile is {cshare:.0%} of setup → point "
                "compile_cache_dir at a shared directory (kernel builds "
                "run once per source and flag set) + aot_store_dir (the "
                "setup plans), then warm up (SolveService.warmup) so the "
                "graph captures leave the request path")
        tshare = (s.get("transfer_s") or 0.0) / total
        if tshare >= TRANSFER_HINT:
            hints.append(
                f"host↔device transfers are {tshare:.0%} of setup "
                f"({_fmt_bytes(s.get('transfer_bytes'))}) — keep the "
                "hierarchy on device / batch the uploads")
    device_setup_active = any(
        p.get("component") in _DEVICE_SETUP_COMPONENTS
        for p in setup.get("phases", []))
    # group fallbacks by (component, level, reason): a resetup-heavy or
    # multi-session trace repeats the same event hundreds of times and
    # must not flood the hints list
    fb_groups: Dict[tuple, int] = {}
    for fb in setup_fallbacks or []:
        k = (fb.get("component", "rap"), fb.get("level"),
             fb.get("reason", "?"))
        fb_groups[k] = fb_groups.get(k, 0) + 1
    n_fb_hints = 0
    for (comp, lvl, reason), cnt in sorted(fb_groups.items(),
                                           key=lambda kv: -kv[1]):
        if reason.split(":")[0] in _BENIGN_FALLBACKS:
            continue
        if n_fb_hints >= 6:
            hints.append(f"… and {len(fb_groups) - 6} more distinct "
                         "device-setup fallback groups (see the "
                         "fallback section)")
            break
        where = f" at level {lvl}" if lvl is not None else ""
        times = f" ({cnt}×)" if cnt > 1 else ""
        hints.append(
            f"{comp}{where} fell back to the host path (reason: "
            f"{reason}){times} → "
            + ("raise device_setup_cache_mb or split the level"
               if reason == "budget" else
               "check the device_setup gates (amg/device_setup/)"))
        n_fb_hints += 1
    for p in setup.get("phases", [])[:3]:
        if p.get("overlapped"):
            continue
        if p.get("share", 0.0) >= DOMINANT_HINT and \
                p["component"] in _HOST_SETUP_COMPONENTS and \
                p.get("host_s", 0.0) > p.get("compile_s", 0.0):
            where = f" at level {p['level']}" \
                if p.get("level") is not None else ""
            if p["component"] == "rap" and device_setup_active:
                # the engine IS running — a dominant host rap means
                # specific levels declined it; only the non-benign
                # groups were hinted above, so say so when the
                # recorded fallbacks don't explain the dominance
                if n_fb_hints:
                    break
                if fb_groups:       # all-benign ('small') fallbacks
                    hints.append(
                        f"rap{where} runs host-side and is "
                        f"{p['share']:.0%} of setup — every recorded "
                        "fallback is benign ('small'): lower "
                        "device_setup_min_rows if these levels matter")
                else:
                    hints.append(
                        f"rap{where} runs host-side and is "
                        f"{p['share']:.0%} of setup despite the device "
                        "setup engine — enable telemetry during setup "
                        "to record the fallback reasons")
                break
            hints.append(
                f"{p['component']}{where} runs host-side and is "
                f"{p['share']:.0%} of setup → device-side setup "
                "engine (device_setup=1, amg/device_setup/; "
                "ROADMAP item 1)")
            break
    uploads = int(s.get("uploads") or 0)
    if uploads > UPLOAD_DRAIN_HINT:
        hints.append(
            f"upload drained {uploads} times during setup — arena-batch "
            "the hierarchy transfer (one device_put round trip)")
    cov = s.get("coverage")
    if isinstance(cov, (int, float)) and cov < 0.9:
        hints.append(
            f"setup attribution covers only {cov:.0%} of the wall — "
            "un-instrumented phases; extend the setup_profile markers")
    return hints


def render(d: dict) -> str:
    """Human-readable report of a :func:`diagnose` result."""
    L: List[str] = []
    L.append("amgx solve doctor")
    L.append("=" * 60)
    L.append(f"trace: {', '.join(d['files'])}")
    L.append(f"sessions: {d['sessions']}   records: {d['records']}"
             + (f"   DROPPED: {d['dropped_records']}"
                if d["dropped_records"] else ""))

    if d["phases"]:
        L.append("")
        L.append("phase breakdown (top-level)")
        L.append("-" * 40)
        for k, v in sorted(d["phases"].items(),
                           key=lambda kv: -kv[1]["total_s"]):
            L.append(f"  {k:<10} {v['total_s']:>10.4f} s"
                     f"  ({v['count']}×)")
    if d["spans"]:
        L.append("")
        L.append("span totals (nested; top 12 by time)")
        L.append("-" * 40)
        top = sorted(d["spans"].items(),
                     key=lambda kv: -kv[1]["total_s"])[:12]
        for k, v in top:
            L.append(f"  {k:<28} {v['total_s']:>10.4f} s"
                     f"  ({v['count']}×)")

    if d["packs"]:
        L.append("")
        L.append("SpMV pack choices")
        L.append("-" * 40)
        for k, v in d["packs"].items():
            # per-pack cost from the dispatch-time op_cost events —
            # covers operators no hierarchy level describes (raw spmv,
            # non-AMG solvers)
            # dispatch labels refine the pack_kind names ("dia/slices"
            # vs the descriptor's "dia") — fall back to the base kind
            pack_name = k.split("pack=", 1)[-1]
            c = d.get("op_costs", {}).get(pack_name) or \
                d.get("op_costs", {}).get(pack_name.split("/")[0])
            extra = ""
            if c and c.get("bytes_per_apply"):
                extra = (f"   {_fmt_bytes(c['bytes_per_apply'])}/apply"
                         f", waste {c.get('padding_waste', '?')}")
            L.append(f"  {k:<28} {v}{extra}")
        for k, v in d["fallbacks"].items():
            L.append(f"  FALLBACK {k:<19} {v}")

    if d["levels"]:
        L.append("")
        L.append("hierarchy cost model (per level)")
        L.append("-" * 40)
        L.append(f"  {'lvl':<4}{'rows':>10}{'nnz':>12}{'pack':>14}"
                 f"{'dtype':>10}{'bytes/apply':>14}{'waste':>8}")
        for lvl, x in sorted(d["levels"].items(),
                             key=lambda kv: int(kv[0])
                             if str(kv[0]).isdigit() else 99):
            L.append(
                f"  {lvl:<4}"
                f"{int(x.get('rows', 0)):>10}"
                f"{int(x.get('nnz', 0)):>12}"
                f"{str(x.get('pack', '?')):>14}"
                f"{str(x.get('dtype', '?')):>10}"
                f"{_fmt_bytes(x.get('bytes_per_apply')):>14}"
                + (f"{x['padding_waste']:>8.2f}"
                   if isinstance(x.get("padding_waste"), (int, float))
                   else f"{'?':>8}"))

    dist = d["distributed"]
    if dist["halo_exchanges"]:
        L.append("")
        L.append("distributed / halo exchange")
        L.append("-" * 40)
        L.append(f"  exchanges traced:   {dist['halo_exchanges']}")
        L.append(f"  wire bytes (padded): "
                 f"{_fmt_bytes(dist['halo_wire_bytes'])}")
        L.append(f"  useful halo entries: {dist['halo_entries']}")
        if dist["halo_local_ratio"] is not None:
            L.append(f"  halo/local bytes:    "
                     f"{dist['halo_local_ratio']:.3f}")
        for dev, f in sorted(dist["boundary_fraction"].items()):
            L.append(f"  boundary fraction [device {dev}]: {f:.3f}")

    if dist.get("levels"):
        L.append("")
        L.append("distributed levels (sub-mesh + overlap audit)")
        L.append("-" * 40)
        L.append(f"  {'lvl':<4}{'parts':>6}{'rows/part':>11}"
                 f"{'halo:local':>11}{'overlap':>9}  flag")
        for lvl, x in sorted(dist["levels"].items(),
                             key=lambda kv: int(kv[0])
                             if str(kv[0]).isdigit() else 99):
            ratio = x.get("halo_local_ratio")
            L.append(
                f"  {lvl:<4}"
                f"{int(x.get('submesh_parts') or 0):>6}"
                f"{int(x.get('rows_per_part') or 0):>11}"
                + (f"{ratio:>11.3f}" if isinstance(ratio, (int, float))
                   else f"{'?':>11}")
                + f"{x.get('overlap_fraction', 0):>9.2f}"
                + ("  HALO-BOUND" if x.get("halo_bound") else ""))
        for a in dist.get("agglomerations", []):
            L.append(
                f"  agglomerated level {a.get('level')}: "
                f"{a.get('from_parts')} -> {a.get('to_parts')} rank(s)"
                f" ({a.get('rows')} rows"
                + (", replicated" if a.get("replicated") else "")
                + (", pack reused" if a.get("reused") else "") + ")")

    kry = d.get("krylov")
    if kry:
        L.append("")
        L.append("Krylov communication (sharded solves)")
        L.append("-" * 40)
        L.append(f"  {'solver':<10}{'mode':<11}{'coll/iter':>10}"
                 f"{'fused':>7}{'iters':>7}  per-iter profile")
        for _key, e in sorted(kry["solves"].items()):
            prof = ", ".join(f"{k}: {v}" for k, v
                             in sorted((e.get("per_iter") or {}).items()))
            L.append(
                f"  {str(e.get('solver', '?')):<10}"
                f"{str(e.get('mode', '?')):<11}"
                f"{int(e.get('collectives_per_iter') or 0):>10}"
                + f"{'yes' if e.get('fused') else 'no':>7}"
                + f"{int(e.get('iterations') or 0):>7}"
                + f"  {prof}")
        if kry.get("measured_overlap"):
            for lvl, f in sorted(kry["measured_overlap"].items(),
                                 key=lambda kv: str(kv[0])):
                L.append(f"  measured overlap [level {lvl}]: "
                         f"{float(f or 0):.2f} (profiler trace)")
        else:
            L.append("  overlap fractions above are MODELLED — supply "
                     "a torch.profiler trace (telemetry/overlap.py) for "
                     "measured ones")

    dev = d.get("device")
    if dev:
        L.append("")
        L.append("Device anatomy (profiler-measured device time)")
        L.append("-" * 40)
        if not dev.get("measured"):
            L.append("  measured: NO — the trace carried no amgx/* "
                     "scoped device ops (CPU backend or no profiler "
                     "capture); numbers below are a stub")
        tot = float(dev.get("total_device_s") or 0)
        att = float(dev.get("attributed_s") or 0)
        pct = f"{att / tot:.0%}" if tot > 0 else "-"
        L.append(f"  device total {tot * 1e3:.3f} ms   attributed "
                 f"{att * 1e3:.3f} ms ({pct})   unattributed "
                 f"{float(dev.get('unattributed_s') or 0) * 1e3:.3f} ms"
                 f"   [{int(dev.get('n_devices') or 0)} device(s), "
                 f"scope contract v{dev.get('scope_version', '?')}]")
        lv = dev.get("levels") or {}
        if lv:
            L.append(f"  {'level':<7}{'pre':>9}{'restrict':>10}"
                     f"{'prolong':>9}{'post':>9}{'total':>9}  (ms)")

            def _ms(row, key):
                v = row.get(key)
                return f"{float(v) * 1e3:>{10 if key == 'restrict' else 9}.3f}" \
                    if isinstance(v, (int, float)) else \
                    f"{'-':>{10 if key == 'restrict' else 9}}"

            for lvl in sorted(lv, key=lambda k: int(k)):
                row = lv[lvl]
                L.append(f"  {lvl:<7}" + _ms(row, "pre_smooth")
                         + _ms(row, "restrict") + _ms(row, "prolong")
                         + _ms(row, "post_smooth") + _ms(row, "total_s"))
        if dev.get("coarse_s"):
            L.append(f"  coarse solve: "
                     f"{float(dev['coarse_s']) * 1e3:.3f} ms")
        sp = dev.get("spmv") or {}
        if sp:
            L.append(f"  {'spmv pack':<22}{'device ms':>11}"
                     f"{'GB/s':>9}{'roofline':>10}")
            for pack in sorted(sp):
                e = sp[pack]
                gbs = e.get("measured_gbs")
                rf = e.get("roofline_fraction")
                L.append(
                    f"  {pack:<22}"
                    f"{float(e.get('device_s') or 0) * 1e3:>11.3f}"
                    + (f"{gbs:>9.1f}" if isinstance(gbs, (int, float))
                       else f"{'-':>9}")
                    + (f"{rf:>10.1%}" if isinstance(rf, (int, float))
                       else f"{'-':>10}"))
        for section, label in (("smoothers", "smoother"),
                               ("krylov", "krylov stage"),
                               ("dist", "dist")):
            rows = dev.get(section) or {}
            for name in sorted(rows):
                L.append(f"  {label} {name}: "
                         f"{float(rows[name]) * 1e3:.3f} ms")

    mem = d.get("memory")
    if mem:
        L.append("")
        L.append("Device memory (HBM ledger)")
        L.append("-" * 40)
        snap = mem.get("snapshot")
        if snap:
            if not snap.get("measured"):
                L.append("  measured: NO — no device exposed "
                         "memory_stats() (CPU backend); bytes_in_use "
                         "below is the live-array census total")
            for dname in sorted(snap.get("devices") or {}):
                dd = snap["devices"][dname]
                line = (f"  {dname}: in use "
                        f"{_fmt_bytes(dd.get('bytes_in_use'))}   "
                        f"accounted "
                        f"{_fmt_bytes(dd.get('accounted_bytes'))}   "
                        f"unaccounted "
                        f"{_fmt_bytes(dd.get('unaccounted_bytes'))}")
                if snap.get("measured"):
                    line += (f"   headroom "
                             f"{_fmt_bytes(dd.get('headroom_bytes'))}"
                             f"   peak "
                             f"{_fmt_bytes(dd.get('peak_bytes'))}")
                L.append(line)
            owners = snap.get("owners") or {}
            for name, nb in sorted(owners.items(),
                                   key=lambda kv: -kv[1])[:8]:
                L.append(f"    {name:<34} {_fmt_bytes(nb):>10}")
            for name, nb in sorted((snap.get("host_owners")
                                    or {}).items()):
                L.append(f"    {name:<34} {_fmt_bytes(nb):>10} (host)")
            L.append(f"  live arrays {snap.get('n_live_arrays', 0)} "
                     f"(owned {snap.get('n_owned_arrays', 0)}), "
                     f"registered entries "
                     f"{snap.get('registered_entries', 0)} "
                     f"[ledger contract "
                     f"v{snap.get('ledger_version', '?')}]")
        for pm in mem.get("oom_postmortems") or []:
            inj = " (injected)" if pm.get("injected") else ""
            L.append(f"  OOM in {pm.get('where')}{inj}: "
                     f"{str(pm.get('error'))[:80]}")
            for name, nb in (pm.get("top_owners") or [])[:3]:
                L.append(f"    held by {name:<28} {_fmt_bytes(nb):>10}")
            for s in pm.get("suggestions") or []:
                L.append(f"    try: {s.get('knob')} — {s.get('hint')}")

    mesh = d.get("mesh")
    if mesh:
        L.append("")
        L.append("Mesh health (cross-rank flight recorder)")
        L.append("-" * 40)
        if not mesh.get("measured"):
            L.append("  measured: NO — "
                     + ("; ".join(mesh.get("notes") or [])
                        or "no cross-rank rendezvous reconstructed"))
        colls = ", ".join(f"{k}: {v}" for k, v
                          in sorted((mesh.get("collectives")
                                     or {}).items()))
        L.append(f"  ranks: {mesh['n_ranks']}   rendezvous: "
                 f"{len(mesh.get('rendezvous') or [])}"
                 + (f" ({colls})" if colls else "")
                 + f"   total wait: "
                 f"{float(mesh.get('total_wait_s') or 0):.4f} s")
        ranks = mesh.get("ranks") or {}
        if ranks:
            L.append(f"  {'rank':<6}{'compute_s':>11}{'wait_s':>9}"
                     f"{'straggler':>11}{'last':>6}{'halo':>10}"
                     f"{'skew_ms':>9}")
            for rank_id in sorted(ranks, key=lambda k: int(k)):
                r = ranks[rank_id]
                L.append(
                    f"  {str(rank_id):<6}"
                    f"{float(r['compute_s']):>11.4f}"
                    f"{float(r['wait_s']):>9.4f}"
                    f"{float(r['straggler_score']):>11.2f}"
                    f"{int(r['arrived_last']):>6}"
                    f"{_fmt_bytes(r['halo_bytes']):>10}"
                    f"{float(r['clock_skew_s']) * 1e3:>9.3f}")
        for gkey, g in sorted((mesh.get("groups") or {}).items()):
            share = g.get("last_share")
            L.append(
                f"  {gkey}: {int(g['collectives'])} rendezvous, "
                f"wait {float(g['wait_s']):.4f} s, mean spread "
                f"{float(g.get('mean_spread_s') or 0) * 1e3:.3f} ms"
                + (f", rank {g['last_rank_mode']} last {share:.0%}"
                   if isinstance(share, (int, float)) else ""))
        for e in mesh.get("desync") or []:
            if e["kind"] == "silent":
                L.append(f"  DESYNC rank {e['rank']}: silent for "
                         f"{float(e['gap_s']):.3f} s "
                         f"({float(e['gap_fraction']):.0%} of span)")
            else:
                L.append(f"  DESYNC rank {e['rank']}: {e['ran']} vs "
                         f"{e['peers_ran']} {e['group']} {e['op']} "
                         "collective(s)")
        if mesh.get("truncated_tails"):
            L.append(f"  truncated trailing line(s) skipped: "
                     f"{mesh['truncated_tails']}")

    srv = d.get("serving")
    if srv:
        L.append("")
        L.append("serving")
        L.append("-" * 40)
        for k, v in srv["requests"].items():
            L.append(f"  requests {k:<20} {v}")
        for k, v in srv["rejections"].items():
            L.append(f"  REJECTED {k:<20} {v}")
        for k, v in srv["setup_kinds"].items():
            L.append(f"  setup {k:<23} {v}")
        c = srv["cache"]
        L.append(f"  cache hits/misses/evictions: {c['hits']}/"
                 f"{c['misses']}/{c['evictions']}")
        b = srv["batches"]
        if b["count"]:
            L.append(f"  batches: {b['count']} (mean {b['mean_size']}, "
                     f"max {b['max_size']} RHS)")
        lat = srv["latency_s"]
        if lat["p50"] is not None:
            L.append(f"  latency p50/p95/p99: {lat['p50']*1e3:.1f}/"
                     f"{lat['p95']*1e3:.1f}/{lat['p99']*1e3:.1f} ms")

    lanes = d.get("serving_lanes")
    if lanes:
        L.append("")
        L.append("serving lanes (multi-device scale-out)")
        L.append("-" * 40)
        L.append(f"  {'lane':<6}{'sessions':>9}{'queue':>7}"
                 f"{'inflight':>9}{'requests':>9}{'attain':>8}")
        for ln, v in lanes["lanes"].items():
            att = v.get("attainment")
            L.append(
                f"  {ln:<6}{int(v.get('sessions') or 0):>9}"
                f"{int(v.get('queue_depth') or 0):>7}"
                f"{int(v.get('inflight') or 0):>9}"
                f"{int(v.get('requests') or 0):>9}"
                + (f"{att:>8.1%}" if isinstance(att, (int, float))
                   else f"{'-':>8}"))
        L.append(f"  steals: {lanes['steals']}   replications: "
                 f"{lanes['replications']}   sessions total: "
                 f"{lanes['total_sessions']}")
        if lanes.get("routes"):
            L.append("  routes: " + "  ".join(
                f"{k}={v}" for k, v in lanes["routes"].items()))

    slo = d.get("slo")
    if slo:
        L.append("")
        L.append("SLO (windowed attainment + request lifecycle)")
        L.append("-" * 40)
        w = slo.get("window") or {}
        att, burn = w.get("attainment"), w.get("burn_rate")
        if isinstance(att, (int, float)):
            L.append(
                f"  attainment: {att:.2%} of {int(w.get('requests', 0))}"
                f" windowed requests (target "
                f"{w.get('target', 0):.1%}"
                + (f", latency obj {w.get('latency_ms_objective'):.0f}"
                   " ms" if w.get("latency_ms_objective") else "")
                + ")")
        if isinstance(burn, (int, float)):
            L.append(f"  error-budget burn rate: {burn:.2f}×"
                     + ("  OVERLOADED" if w.get("overloaded") else ""))
        for oc, n in (slo.get("outcomes") or {}).items():
            L.append(f"  outcome {oc:<22} {n}")
        ps = slo.get("phase_split") or {}
        if ps:
            L.append(f"  {'phase':<12}{'count':>8}{'mean_ms':>10}")
            for ph, v in ps.items():
                m = v.get("mean_s")
                L.append(f"  {ph:<12}{v['count']:>8}"
                         + (f"{m * 1e3:>10.2f}"
                            if isinstance(m, (int, float))
                            else f"{'?':>10}"))

    fl = d.get("failures")
    if fl:
        L.append("")
        L.append("failures & recovery")
        L.append("-" * 40)
        for k, v in fl.get("solve_failures_by_kind", {}).items():
            L.append(f"  failed solves {k:<24} {v}")
        for e in fl.get("breakdowns", []):
            it = e.get("iteration")
            L.append(f"  breakdown {str(e.get('kind')):<20}"
                     + (f" at iteration {it}" if it is not None else ""))
        if fl.get("recovery_attempts"):
            L.append(f"  recovery attempts: {fl['recovery_attempts']}"
                     f"  (recovered {fl.get('recovered', 0)}, "
                     f"exhausted {fl.get('exhausted', 0)})")
            for e in fl.get("recovery_events", []):
                L.append(f"    {str(e.get('kind')):<20}"
                         f"{str(e.get('action')):<14}"
                         f"-> {e.get('outcome')}")
        for k, v in fl.get("fault_injected", {}).items():
            L.append(f"  INJECTED {k:<24} {v}")
        if fl.get("history_truncated"):
            L.append(f"  history truncations: "
                     f"{fl['history_truncated']}")
        if fl.get("quarantined"):
            L.append(f"  quarantined patterns: {fl['quarantined']}")
            for e in fl.get("quarantine_events", []):
                L.append(f"    {e.get('pattern')} after "
                         f"{e.get('failures')} failures")
        if fl.get("serve_retries"):
            L.append(f"  serve request retries: {fl['serve_retries']}")
        if fl.get("breaker_trips"):
            L.append(f"  lane breaker trips: {fl['breaker_trips']}")

    setup = d.get("setup")
    if setup:
        L.extend(_render_setup(setup))
    cc = d.get("compile_cache")
    if cc:
        L.append("")
        L.append("warm start (compile cache + AOT store)")
        L.append("-" * 40)
        rate = cc.get("hit_rate")
        L.append(f"  lookups: {cc['hits'] + cc['misses']}  hits: "
                 f"{cc['hits']}  misses: {cc['misses']}"
                 + (f"  (hit rate {rate:.0%})"
                    if isinstance(rate, (int, float)) else ""))
        for k, v in cc.get("hits_by_layer", {}).items():
            L.append(f"  hits {k:<28} {v}")
        for k, v in cc.get("fallbacks_by_reason", {}).items():
            L.append(f"  FALLBACK {k:<24} {v}")
    fbs = d.get("setup_fallbacks")
    if fbs:
        L.append("")
        L.append("device setup fallbacks")
        L.append("-" * 40)
        groups: dict = {}
        for fb in fbs:
            k = (fb.get("level"), fb.get("component", "rap"),
                 fb.get("reason", "?"))
            groups[k] = groups.get(k, 0) + 1
        for (lvl, comp, reason), cnt in sorted(
                groups.items(), key=lambda kv: (str(kv[0][0]),
                                                kv[0][1])):
            where = f"level {lvl}" if lvl is not None else "toplevel"
            times = f"  ({cnt}×)" if cnt > 1 else ""
            L.append(f"  {where:<10} {comp:<9} reason: "
                     f"{reason}{times}")

    conv = d["convergence"]
    if conv:
        L.append("")
        L.append("convergence")
        L.append("-" * 40)
        if "iterations" in conv:
            L.append(f"  iterations:   {int(conv['iterations'])}")
        if "final_relres" in conv:
            L.append(f"  final relres: {conv['final_relres']:.3e}")
        if "rate" in conv and isinstance(conv.get("rate"), (int, float)):
            L.append(f"  reduction/iter: {conv['rate']:.3f}")
        if isinstance(conv.get("asymptotic_rate"), (int, float)):
            L.append(f"  asymptotic rate: {conv['asymptotic_rate']:.3f}")
        if conv.get("divergences"):
            L.append(f"  DIVERGENCES:  {conv['divergences']}")

    fr = d.get("forensics")
    if fr:
        L.extend(_render_forensics(fr))

    L.append("")
    if d["hints"]:
        L.append("hints")
        L.append("-" * 40)
        for h in d["hints"]:
            L.append(f"  * {h}")
    else:
        L.append("hints: none — the trace looks healthy")
    return "\n".join(L) + "\n"


def _render_setup(setup: dict) -> List[str]:
    """The setup-attribution report block: totals with the
    execute/compile/transfer/host split, coverage + HBM watermark, and
    the ranked phase table (telemetry/setup_profile.py)."""
    L: List[str] = []
    L.append("")
    L.append("setup attribution (per phase)")
    L.append("-" * 40)
    s = setup.get("summary") or {}
    total = setup.get("total_s") or 0.0

    def pct(v):
        return f"{(v or 0.0) / total:.0%}" if total else "?"

    if s:
        L.append(f"  setup {total:.3f} s = "
                 f"compile {s.get('compile_s', 0.0):.3f} s ({pct(s.get('compile_s'))})"
                 f" + transfer {s.get('transfer_s', 0.0):.3f} s ({pct(s.get('transfer_s'))})"
                 f" + execute {s.get('execute_s', 0.0):.3f} s ({pct(s.get('execute_s'))})"
                 f" + host {s.get('host_s', 0.0):.3f} s ({pct(s.get('host_s'))})")
        wc = s.get("worker_compile_s") or 0.0
        wt = s.get("worker_transfer_s") or 0.0
        if wc or wt:
            parts = []
            if wc:
                parts.append(f"{wc:.3f} s compile")
            if wt:
                parts.append(f"{wt:.3f} s transfer")
            L.append(f"  (+{' + '.join(parts)} on worker threads, "
                     "overlapped with the owner's wait phases)")
        cov = s.get("coverage")
        wm = s.get("mem_watermark_bytes")
        L.append("  coverage: "
                 + (f"{cov:.0%} of setup wall attributed"
                    if isinstance(cov, (int, float)) else "?")
                 + (f"   HBM watermark: {_fmt_bytes(wm)}"
                    if wm else "")
                 + (f"   uploads/downloads: {int(s.get('uploads', 0))}"
                    f"/{int(s.get('downloads', 0))}"
                    if s.get("uploads") or s.get("downloads") else ""))
    L.append(f"  {'phase':<22}{'self_s':>9}{'share':>7}{'compile':>9}"
             f"{'transfer':>10}{'rest':>9}  kind")
    shown = 0
    for p in setup.get("phases", []):
        if shown >= 12:
            break
        shown += 1
        rest = p.get("execute_s", p.get("host_s", 0.0))
        L.append(
            f"  {p['name']:<22}{p['self_s']:>9.3f}"
            f"{p.get('share', 0.0):>7.1%}{p['compile_s']:>9.3f}"
            f"{p.get('transfer_s', 0.0):>10.3f}{rest:>9.3f}  "
            f"{p.get('kind', '?')}"
            + ("  (overlapped)" if p.get("overlapped") else ""))
    return L


def _fmt_factor(f) -> str:
    return f"{f:7.3f}" if isinstance(f, (int, float)) else f"{'-':>7}"


def _render_forensics(fr: dict) -> List[str]:
    """The convergence-forensics report block: per-level per-component
    reduction factors, the coarse-solve factor, the weakest link, and
    the hierarchy quality probes."""
    L: List[str] = []
    if fr.get("levels"):
        L.append("")
        L.append("convergence forensics (per-level cycle anatomy)")
        L.append("-" * 40)
        L.append(f"  {'lvl':<4}{'cycles':>7}{'pre':>8}{'coarse':>8}"
                 f"{'post':>8}{'total':>8}")
        for lvl, x in sorted(fr["levels"].items(),
                             key=lambda kv: int(kv[0])):
            L.append(f"  {lvl:<4}{int(x.get('cycles', 0)):>7}"
                     + _fmt_factor(x.get("pre_smooth")).rjust(8)
                     + _fmt_factor(x.get("coarse_corr")).rjust(8)
                     + _fmt_factor(x.get("post_smooth")).rjust(8)
                     + _fmt_factor(x.get("total")).rjust(8))
        c = fr.get("coarse")
        if c and isinstance(c.get("factor"), (int, float)):
            L.append(f"  coarse solve @{c['level']}: factor "
                     f"{c['factor']:.3f} ({c['cycles']}×)")
        w = fr.get("weakest")
        if w:
            L.append(f"  weakest component: level {w['level']} "
                     f"{_COMPONENT_LABEL[w['component']]} "
                     f"(factor {w['factor']:.3f})")
    if fr.get("probes"):
        L.append("")
        L.append("hierarchy quality probes")
        L.append("-" * 40)
        L.append(f"  {'lvl':<4}{'rows':>10}{'cf':>7}{'nullsp':>8}"
                 f"{'galerkin':>10}{'strong':>8}")
        for lvl, p in sorted(fr["probes"].items(),
                             key=lambda kv: int(kv[0])):
            ge = p.get("galerkin_err")
            L.append(f"  {lvl:<4}{int(p.get('rows', 0)):>10}"
                     + _fmt_factor(p.get("cf_ratio")).rjust(7)
                     + _fmt_factor(p.get("nullspace")).rjust(8)
                     + (f"{ge:>10.1e}" if isinstance(ge, (int, float))
                        else f"{'-':>10}")
                     + _fmt_factor(p.get("strong_frac")).rjust(8))
    return L


# ---------------------------------------------------------------- diff
def diff(da: dict, db: dict) -> dict:
    """Two-trace A/B comparison (pipeline-on/off, 64³-vs-128³): the
    level-by-level convergence picture of ``da`` vs ``db`` with drifts
    past :data:`DIFF_DRIFT` called out."""
    conv_a, conv_b = da["convergence"], db["convergence"]

    def pair(key):
        return {"a": conv_a.get(key), "b": conv_b.get(key)}

    fra = da.get("forensics") or {}
    frb = db.get("forensics") or {}
    la, lb = fra.get("levels", {}), frb.get("levels", {})
    levels = {}
    for lvl in sorted(set(la) | set(lb), key=int):
        row = {}
        for comp in COMPONENTS + ("total",):
            row[comp] = {
                "a": (la.get(lvl) or {}).get(comp),
                "b": (lb.get(lvl) or {}).get(comp)}
        levels[lvl] = row
    rows = {}
    for lvl in sorted(set(da["levels"]) | set(db["levels"]),
                      key=lambda v: int(v) if str(v).isdigit() else 99):
        rows[lvl] = {"a": (da["levels"].get(lvl) or {}).get("rows"),
                     "b": (db["levels"].get(lvl) or {}).get("rows")}
    phases = {}
    for k in sorted(set(da["phases"]) | set(db["phases"])):
        phases[k] = {
            "a": (da["phases"].get(k) or {}).get("total_s"),
            "b": (db["phases"].get(k) or {}).get("total_s")}
    drifts: List[str] = []
    for lvl, row in levels.items():
        for comp, v in row.items():
            if comp == "total":
                continue
            a, b = v["a"], v["b"]
            if isinstance(a, (int, float)) and \
                    isinstance(b, (int, float)) and \
                    abs(b - a) >= DIFF_DRIFT:
                word = "worsened" if b > a else "improved"
                drifts.append(
                    f"level {lvl} {_COMPONENT_LABEL[comp]} {word} "
                    f"{a:.2f} → {b:.2f}")
    wa, wb = fra.get("weakest"), frb.get("weakest")
    if wa and wb and (wa["level"], wa["component"]) != \
            (wb["level"], wb["component"]):
        drifts.append(
            f"weakest component moved: level {wa['level']} "
            f"{_COMPONENT_LABEL[wa['component']]} → level "
            f"{wb['level']} {_COMPONENT_LABEL[wb['component']]}")
    # device anatomy A/B: per-scope measured device seconds side by
    # side (only when BOTH traces carry a measured anatomy — comparing
    # a measurement against a stub would read as a regression)
    device = None
    deva, devb = da.get("device") or {}, db.get("device") or {}
    if deva.get("measured") and devb.get("measured"):
        sa, sb = deva.get("scopes") or {}, devb.get("scopes") or {}
        device = {
            "total_device_s": {"a": deva.get("total_device_s"),
                               "b": devb.get("total_device_s")},
            "scopes": {s: {"a": sa.get(s), "b": sb.get(s)}
                       for s in sorted(set(sa) | set(sb))},
        }
        for s, v in device["scopes"].items():
            a, b = v["a"], v["b"]
            if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                    and a > 0 and (b / a >= 1.5 or b / a <= 1 / 1.5) \
                    and max(a, b) * 1e3 >= 1.0:    # ignore sub-ms noise
                word = "worsened" if b > a else "improved"
                drifts.append(f"device time {s} {word} "
                              f"{a * 1e3:.2f} → {b * 1e3:.2f} ms")
    # HBM ledger A/B: per-owner resident bytes side by side.  Same
    # both-measured rule as the anatomy for the backend-truth fields;
    # the owner table diffs in stub mode too (census bytes are real
    # either way)
    memory = None
    mema = (da.get("memory") or {}).get("snapshot") or {}
    memb = (db.get("memory") or {}).get("snapshot") or {}
    if mema and memb:
        oa, ob = mema.get("owners") or {}, memb.get("owners") or {}
        memory = {
            "measured": {"a": mema.get("measured"),
                         "b": memb.get("measured")},
            "owners": {o: {"a": oa.get(o), "b": ob.get(o)}
                       for o in sorted(set(oa) | set(ob))},
        }
        if mema.get("measured") and memb.get("measured"):
            pa = {dev: d.get("peak_bytes")
                  for dev, d in (mema.get("devices") or {}).items()}
            pb = {dev: d.get("peak_bytes")
                  for dev, d in (memb.get("devices") or {}).items()}
            memory["peak_bytes"] = {
                dev: {"a": pa.get(dev), "b": pb.get(dev)}
                for dev in sorted(set(pa) | set(pb))}
        for o, v in memory["owners"].items():
            a, b = v["a"], v["b"]
            if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                    and a > 0 and (b / a >= 1.5 or b / a <= 1 / 1.5) \
                    and max(a, b) >= 1 << 20:     # ignore sub-MiB noise
                word = "grew" if b > a else "shrank"
                drifts.append(f"HBM owner {o} {word} "
                              f"{_fmt_bytes(a)} → {_fmt_bytes(b)}")
    # mesh A/B: per-rank wait side by side.  Same both-measured rule
    # as the anatomy — a single-rank trace has no rendezvous, and
    # comparing one against a mesh would read as a regression
    mesh = None
    ma, mb = da.get("mesh") or {}, db.get("mesh") or {}
    if ma.get("measured") and mb.get("measured"):
        ra, rb = ma.get("ranks") or {}, mb.get("ranks") or {}
        mesh = {
            "total_wait_s": {"a": ma.get("total_wait_s"),
                             "b": mb.get("total_wait_s")},
            "ranks": {r: {"a": (ra.get(r) or {}).get("wait_s"),
                          "b": (rb.get(r) or {}).get("wait_s")}
                      for r in sorted(set(ra) | set(rb),
                                      key=lambda k: int(k))},
        }
        for r, v in mesh["ranks"].items():
            a, b = v["a"], v["b"]
            if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                    and a > 0 and (b / a >= 1.5 or b / a <= 1 / 1.5) \
                    and max(a, b) >= 0.01:        # ignore sub-10ms noise
                word = "worsened" if b > a else "improved"
                drifts.append(f"mesh wait rank {r} {word} "
                              f"{a * 1e3:.1f} → {b * 1e3:.1f} ms")
    return {"a": da["files"], "b": db["files"],
            "convergence": {k: pair(k) for k in
                            ("iterations", "final_relres", "rate",
                             "asymptotic_rate")},
            "rows": rows, "phases": phases, "levels": levels,
            "device": device,
            "memory": memory,
            "mesh": mesh,
            "drifts": drifts}


def _fmt_num(v, spec=".3f") -> str:
    if isinstance(v, (int, float)):
        return format(v, spec)
    return "-"


def render_diff(dd: dict) -> str:
    """Human-readable report of a :func:`diff` result."""
    L: List[str] = []
    L.append("amgx convergence diff")
    L.append("=" * 60)
    L.append(f"A: {', '.join(dd['a'])}")
    L.append(f"B: {', '.join(dd['b'])}")
    L.append("")
    L.append("convergence (A vs B)")
    L.append("-" * 40)
    c = dd["convergence"]
    it = c["iterations"]
    if it["a"] is not None or it["b"] is not None:
        L.append(f"  iterations:      "
                 f"{_fmt_num(it['a'], '.0f')} vs "
                 f"{_fmt_num(it['b'], '.0f')}")
    rr = c["final_relres"]
    if rr["a"] is not None or rr["b"] is not None:
        L.append(f"  final relres:    "
                 f"{_fmt_num(rr['a'], '.3e')} vs "
                 f"{_fmt_num(rr['b'], '.3e')}")
    for key, label in (("rate", "reduction/iter: "),
                       ("asymptotic_rate", "asymptotic rate:")):
        v = c[key]
        if v["a"] is not None or v["b"] is not None:
            L.append(f"  {label} {_fmt_num(v['a'])} vs "
                     f"{_fmt_num(v['b'])}")
    if dd["rows"]:
        L.append("")
        L.append("hierarchy (rows, A vs B)")
        L.append("-" * 40)
        for lvl, v in dd["rows"].items():
            L.append(f"  level {lvl:<4} {_fmt_num(v['a'], '.0f'):>10}"
                     f" vs {_fmt_num(v['b'], '.0f'):>10}")
    if dd["levels"]:
        L.append("")
        L.append("cycle anatomy (A | B per component)")
        L.append("-" * 40)
        L.append(f"  {'lvl':<4}{'pre A|B':>16}{'coarse A|B':>18}"
                 f"{'post A|B':>16}")
        for lvl, row in dd["levels"].items():
            def ab(comp, row=row):
                v = row[comp]
                return (f"{_fmt_num(v['a'])}|{_fmt_num(v['b'])}")
            L.append(f"  {lvl:<4}{ab('pre_smooth'):>16}"
                     f"{ab('coarse_corr'):>18}{ab('post_smooth'):>16}")
    if dd["phases"]:
        L.append("")
        L.append("phase totals (A vs B, seconds)")
        L.append("-" * 40)
        for k, v in dd["phases"].items():
            L.append(f"  {k:<10} {_fmt_num(v['a'], '.4f'):>10} vs "
                     f"{_fmt_num(v['b'], '.4f'):>10}")
    if dd.get("device"):
        L.append("")
        L.append("device anatomy (A vs B, measured device ms)")
        L.append("-" * 40)
        t = dd["device"]["total_device_s"]
        L.append(f"  {'total':<34}"
                 f"{_fmt_num((t['a'] or 0) * 1e3):>10} vs "
                 f"{_fmt_num((t['b'] or 0) * 1e3):>10}")
        for s, v in dd["device"]["scopes"].items():
            a = (v["a"] or 0) * 1e3 if v["a"] is not None else None
            b = (v["b"] or 0) * 1e3 if v["b"] is not None else None
            L.append(f"  {s:<34}{_fmt_num(a):>10} vs "
                     f"{_fmt_num(b):>10}")
    if dd.get("memory"):
        L.append("")
        L.append("device memory (A vs B, resident bytes per owner)")
        L.append("-" * 40)
        for o, v in dd["memory"]["owners"].items():
            fa = _fmt_bytes(v["a"]) if v["a"] is not None else "-"
            fb = _fmt_bytes(v["b"]) if v["b"] is not None else "-"
            L.append(f"  {o:<34}{fa:>10} vs {fb:>10}")
        for dev, v in (dd["memory"].get("peak_bytes") or {}).items():
            fa = _fmt_bytes(v["a"]) if v["a"] is not None else "-"
            fb = _fmt_bytes(v["b"]) if v["b"] is not None else "-"
            L.append(f"  peak {dev:<29}{fa:>10} vs {fb:>10}")
    if dd.get("mesh"):
        L.append("")
        L.append("mesh wait (A vs B, seconds per rank)")
        L.append("-" * 40)
        t = dd["mesh"]["total_wait_s"]
        L.append(f"  {'total':<10}{_fmt_num(t['a'], '.4f'):>10} vs "
                 f"{_fmt_num(t['b'], '.4f'):>10}")
        for r, v in dd["mesh"]["ranks"].items():
            L.append(f"  rank {str(r):<5}{_fmt_num(v['a'], '.4f'):>10}"
                     f" vs {_fmt_num(v['b'], '.4f'):>10}")
    L.append("")
    if dd["drifts"]:
        L.append("drifts")
        L.append("-" * 40)
        for h in dd["drifts"]:
            L.append(f"  * {h}")
    else:
        L.append("drifts: none past the threshold")
    return "\n".join(L) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    diff_paths: List[str] = []
    if "--diff" in argv:
        i = argv.index("--diff")
        diff_paths = argv[i + 1:]
        argv = argv[:i]
        if not diff_paths:
            print("doctor: --diff requires a second trace",
                  file=sys.stderr)
            return 2
    paths = argv
    if not paths:
        print("usage: python -m amgx_tpu_torch.telemetry.doctor "
              "<trace.jsonl> [more.jsonl ...] "
              "[--diff other.jsonl ...] [--json]",
              file=sys.stderr)
        return 2
    # a diverged solve restores "Infinity" gauge tokens to real floats
    # for the math above — re-sanitize so --json output stays strict
    # JSON (jq-parseable), like every other exporter here
    from .export import _sanitize
    try:
        d = diagnose(paths)
        dd = diff(d, diagnose(diff_paths)) if diff_paths else None
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"doctor: cannot read trace: {e}", file=sys.stderr)
        return 1
    if dd is not None:
        if as_json:
            print(json.dumps(_sanitize(dd), indent=2, default=str,
                             allow_nan=False))
        else:
            print(render_diff(dd), end="")
        return 0
    if as_json:
        print(json.dumps(_sanitize(d), indent=2, default=str,
                         allow_nan=False))
    else:
        print(render(d), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())

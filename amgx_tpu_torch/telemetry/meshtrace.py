"""Mesh flight recorder: clock-aligned cross-rank rendezvous analysis.

Every other telemetry layer is per-rank: :func:`~.export.aggregate_sessions`
concatenates per-process JSONL sessions without ever reconstructing the
mesh-wide picture, so a slow collective is indistinguishable from a slow
rank everyone waited on.  This module answers the cross-rank question —
*who arrived last, who made the mesh wait, and by how much*:

* **rank join**: each distinct ``(pid, session)`` identity in a trace is
  one rank (a process that appended several sessions to the same path —
  bench's per-case flushes — stays ONE rank, because its
  ``perf_counter`` epoch is shared);
* **clock alignment**: per-rank offset+slope fit over the paired
  (``t_perf``, ``t_unix``) samples — the session meta header plus the
  rate-limited ``clock_sample`` re-samples :func:`~.export.flush_jsonl`
  emits — so drift over long runs is bounded instead of baked into a
  single session-start offset;
* **collective rendezvous**: per-rank intervals of each halo-exchange
  hop (``exchange_halo`` / ``dist_spmv`` spans — the latter is the
  solve path's fused exchange+SpMV hop), fused Krylov reduction
  (``krylov_comm`` events) and agglomeration redistribution
  (``dist_agglomerate`` events) are matched across ranks by
  (op, group, sequence); arrival
  spread and per-rank wait (``wait = last_arrival − my_arrival``) fall
  out of the aligned timelines;
* **honesty invariant**: per rank, ``compute + wait + unattributed ≡
  wall`` — schema-enforced on every ``mesh_health`` event
  (:func:`~.export.validate_record`), with a ``measured`` provenance
  bool like deviceprof/memledger: a single-rank trace, or one without
  the needed spans, degrades to an honest ``measured=False`` stub;
* on top of the join: a per-rank **straggler score** (share of
  mesh-wide induced wait caused by arriving last), a per-group
  compute-vs-wait **skew decomposition**, and a **silent-rank/desync
  detector** (a rank whose events stop mid-solve while peers continue,
  or that missed collectives its peers ran).

Surfacing: ``amgx_mesh_*`` metrics via :func:`emit`, the doctor's
"Mesh health" section, rendezvous flow arrows in the Chrome trace
(:mod:`.tracefile`), ``/debug/mesh`` on the httpd, and the bench
distributed child's ``mesh`` block.  Everything is host-side file
parsing — no device work.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

from . import metrics, recorder
from .export import read_sessions

#: version of the mesh-analysis contract carried by every mesh_health
#: event (bump on semantic changes to wait attribution)
MESH_VERSION = 1

#: a rank whose trace ends this fraction of the mesh span before the
#: last rank's final record — while peers kept emitting — reads silent
SILENT_FRACTION = 0.25
#: absolute floor under which an early trace end is never flagged
#: (sub-millisecond tails are flush jitter, not a dead rank)
SILENT_MIN_S = 1e-3

#: ops a rendezvous can belong to (the event-schema vocabulary)
OPS = ("halo", "krylov", "agglomerate")


# ------------------------------------------------------ clock alignment
def _clock_points(sessions: List[dict]) -> List[Tuple[float, float]]:
    """(t_perf, t_unix) pairs of one rank: every session meta header
    plus every rate-limited ``clock_sample`` re-sample event."""
    pts: List[Tuple[float, float]] = []
    for s in sessions:
        m = s.get("meta") or {}
        if isinstance(m.get("t_perf"), (int, float)) and \
                isinstance(m.get("t_unix"), (int, float)):
            pts.append((float(m["t_perf"]), float(m["t_unix"])))
        for r in s["records"]:
            if r["kind"] == "event" and r["name"] == "clock_sample":
                a = r.get("attrs") or {}
                if isinstance(a.get("t_perf"), (int, float)) and \
                        isinstance(a.get("t_unix"), (int, float)):
                    pts.append((float(a["t_perf"]), float(a["t_unix"])))
    return sorted(set(pts))


def fit_clock(points: List[Tuple[float, float]]
              ) -> Tuple[float, float, int]:
    """Least-squares (offset_s, drift, n_samples) fit of one rank's
    wall clock against its perf_counter: ``wall = t·(1 + drift) +
    offset``.  One sample (the meta-only case) pins ``drift = 0`` —
    exactly the old single-offset alignment; more samples bound drift
    over long runs."""
    if not points:
        return 0.0, 0.0, 0
    if len(points) == 1:
        tp, tu = points[0]
        return tu - tp, 0.0, 1
    n = len(points)
    mx = sum(p for p, _ in points) / n
    # fit the RESIDUAL y = t_unix − t_perf, so drift is the slope on
    # top of the ideal 1:1 rate and precision survives large epochs
    my = sum(u - p for p, u in points) / n
    sxx = sum((p - mx) ** 2 for p, _ in points)
    if sxx <= 0.0:
        return my, 0.0, n
    sxy = sum((p - mx) * ((u - p) - my) for p, u in points)
    drift = sxy / sxx
    return my - drift * mx, drift, n


# -------------------------------------------------- rendezvous matching
def _rank_collectives(records: List[dict]) -> List[dict]:
    """One rank's collective arrivals, in record order::

        {"op", "group", "seq", "t_arrive", "t_done", "tid"}

    ``t_*`` are raw per-rank perf_counter seconds (callers align).
    ``seq`` counts occurrences per (op, group) — the cross-rank match
    key: an SPMD program runs the same collective sequence on every
    rank, so the k-th ring-1 exchange on rank 0 IS the k-th ring-1
    exchange on rank 3.  Arrival is the span BEGIN (the rank reaching
    the collective); events arrive at their instant."""
    out: List[dict] = []
    begins: Dict[int, dict] = {}
    counts: Dict[Tuple[str, str], int] = {}

    def nxt(op, group):
        key = (op, group)
        counts[key] = counts.get(key, 0) + 1
        return counts[key] - 1

    # dist_spmv IS the solve path's halo hop (exchange fused with the
    # interior/boundary SpMV for overlap); exchange_halo is the bare
    # hop setup/tests call directly — both rendezvous
    halo_spans = ("exchange_halo", "dist_spmv")
    for r in records:
        kind = r["kind"]
        if kind == "span_begin" and r["name"] in halo_spans:
            begins[r["sid"]] = r
        elif kind == "span_end" and r["name"] in halo_spans:
            b = begins.pop(r["sid"], None)
            if r["name"] == "dist_spmv":
                group = "spmv"
            else:
                ring = (b.get("attrs") or {}).get("ring") if b else None
                group = f"ring-{ring}" if isinstance(ring, int) \
                    else "ring-?"
            dur = float(r.get("dur") or 0.0)
            out.append({"op": "halo", "group": group,
                        "seq": nxt("halo", group),
                        "t_arrive": float(r["t"]) - dur,
                        "t_done": float(r["t"]), "tid": r["tid"]})
        elif kind == "event" and r["name"] == "krylov_comm":
            a = r.get("attrs") or {}
            group = str(a.get("solver") or "?")
            out.append({"op": "krylov", "group": group,
                        "seq": nxt("krylov", group),
                        "t_arrive": float(r["t"]),
                        "t_done": float(r["t"]), "tid": r["tid"],
                        "fused": bool(a.get("fused"))})
        elif kind == "event" and r["name"] == "dist_agglomerate":
            a = r.get("attrs") or {}
            group = f"level-{a.get('level')}"
            out.append({"op": "agglomerate", "group": group,
                        "seq": nxt("agglomerate", group),
                        "t_arrive": float(r["t"]),
                        "t_done": float(r["t"]), "tid": r["tid"]})
    return out


def rendezvous_from_sessions(sessions: List[dict]) -> List[dict]:
    """Raw rendezvous join over pre-read sessions (the Chrome-trace
    exporter's entry point — it applies its own per-session offsets)::

        {"op", "group", "seq",
         "arrivals": [{"session", "rank", "tid", "t", "t_done"}, ...]}

    ``session`` indexes ``sessions``; ``rank`` is the joined rank id
    (sessions from one ``(pid, session)`` identity share it).  Only
    keys at least two DISTINCT ranks reached are rendezvous; ``t`` is
    each rank's raw (unaligned) perf_counter arrival."""
    ranks = _join_ranks(sessions)
    by_key: Dict[Tuple[str, str, int], List[dict]] = {}
    for rank_id, rk in enumerate(ranks):
        for c in _rank_collectives(rk["records"]):
            by_key.setdefault((c["op"], c["group"], c["seq"]), []).append(
                {"session": rk["session_indices"][0], "rank": rank_id,
                 "tid": c["tid"], "t": c["t_arrive"],
                 "t_done": c["t_done"],
                 "fused": c.get("fused", False)})
    out = []
    for (op, group, seq), arr in sorted(by_key.items()):
        if len({a["rank"] for a in arr}) < 2:
            continue
        out.append({"op": op, "group": group, "seq": seq,
                    "arrivals": arr})
    return out


def _join_ranks(sessions: List[dict]) -> List[dict]:
    """Group sessions into ranks by ``(pid, session)`` process identity
    (first-appearance order).  Each rank keeps its merged record list,
    its clock points, and the indices of its sessions."""
    ranks: List[dict] = []
    index: Dict[Tuple, int] = {}
    for i, s in enumerate(sessions):
        m = s.get("meta") or {}
        key = (m.get("pid"), m.get("session")) if m.get("session") \
            else ("anon", i)
        if key not in index:
            index[key] = len(ranks)
            ranks.append({"key": key, "meta": m, "records": [],
                          "session_indices": []})
        rk = ranks[index[key]]
        rk["records"].extend(s["records"])
        rk["session_indices"].append(i)
    for rk in ranks:
        rk["clock"] = _clock_points(
            [sessions[i] for i in rk["session_indices"]])
    return ranks


# ------------------------------------------------------------- analysis
def analyze_sessions(sessions: List[dict]) -> dict:
    """Mesh diagnosis of pre-read sessions (see :func:`analyze`)."""
    ranks = _join_ranks(sessions)
    n_ranks = len(ranks)
    notes: List[str] = []
    truncated = sum(
        1 for s in sessions for r in s["records"]
        if r["kind"] == "event" and r["name"] == "mesh_truncated_tail")

    # per-rank clock fit + aligned record times
    fits = []
    for rk in ranks:
        offset, drift, n = fit_clock(rk["clock"])
        fits.append((offset, drift, n))
    base_off = fits[0][0] if fits else 0.0

    def wall(rank_id: int, t: float) -> float:
        off, drift, _ = fits[rank_id]
        return t * (1.0 + drift) + off

    # collective join (reuse the raw join, then align)
    rvs = rendezvous_from_sessions(sessions)
    rendezvous: List[dict] = []
    wait_by_rank: Dict[int, float] = {r: 0.0 for r in range(n_ranks)}
    wait_by_op: Dict[str, float] = {}
    induced: Dict[int, float] = {r: 0.0 for r in range(n_ranks)}
    last_counts: Dict[int, int] = {r: 0 for r in range(n_ranks)}
    part_counts: Dict[int, int] = {r: 0 for r in range(n_ranks)}
    groups: Dict[str, dict] = {}
    for rv in rvs:
        arr = sorted(((wall(a["rank"], a["t"]), a) for a in rv["arrivals"]),
                     key=lambda p: p[0])
        t_first, t_last = arr[0][0], arr[-1][0]
        last_rank = arr[-1][1]["rank"]
        spread = max(t_last - t_first, 0.0)
        waits: Dict[int, float] = {}
        total_wait = 0.0
        for t_a, a in arr:
            w = max(t_last - t_a, 0.0)
            # a rank cannot have waited longer than it was inside the
            # collective — clock skew past the span length is clamped
            dur = max(wall(a["rank"], a["t_done"]) - t_a, 0.0)
            if dur > 0.0:
                w = min(w, dur)
            waits[a["rank"]] = w
            total_wait += w
            wait_by_rank[a["rank"]] += w
            part_counts[a["rank"]] += 1
        induced[last_rank] += total_wait
        last_counts[last_rank] += 1
        wait_by_op[rv["op"]] = wait_by_op.get(rv["op"], 0.0) + total_wait
        gkey = f"{rv['op']} {rv['group']}"
        g = groups.setdefault(gkey, {
            "op": rv["op"], "group": rv["group"], "collectives": 0,
            "wait_s": 0.0, "spread_s": 0.0, "last_by_rank": {}})
        g["collectives"] += 1
        g["wait_s"] += total_wait
        g["spread_s"] += spread
        g["last_by_rank"][last_rank] = \
            g["last_by_rank"].get(last_rank, 0) + 1
        rendezvous.append({
            "op": rv["op"], "group": rv["group"], "seq": rv["seq"],
            "n_ranks": len(arr), "t_first_s": round(t_first, 9),
            "spread_s": round(spread, 9), "last_rank": last_rank,
            "wait_total_s": round(total_wait, 9),
            "waits": {r: round(w, 9) for r, w in sorted(waits.items())},
            "fused": any(a.get("fused") for _, a in arr),
        })

    # per-group skew decomposition: between two consecutive rendezvous
    # of one group every rank ran the same program, so the arrival
    # SPREAD is the compute skew accumulated since the last sync
    for g in groups.values():
        n = g["collectives"]
        g["mean_spread_s"] = round(g["spread_s"] / n, 9) if n else 0.0
        g["wait_s"] = round(g["wait_s"], 9)
        g.pop("spread_s", None)
        if g["last_by_rank"]:
            lr, cnt = max(g["last_by_rank"].items(),
                          key=lambda kv: (kv[1], -kv[0]))
            g["last_rank_mode"] = lr
            g["last_share"] = round(cnt / n, 4)

    total_induced = sum(induced.values())
    measured = n_ranks >= 2 and bool(rendezvous)
    if n_ranks < 2:
        notes.append("single-rank trace: no cross-rank rendezvous to "
                     "reconstruct")
    elif not rendezvous:
        notes.append("no matchable collective spans/events "
                     "(exchange_halo / krylov_comm / dist_agglomerate) "
                     "appear on 2+ ranks")
    if truncated:
        notes.append(f"{truncated} truncated trailing line(s) skipped "
                     "(rank killed mid-write)")

    # per-rank health under the honesty invariant
    rank_out: Dict[int, dict] = {}
    ends = []
    for rank_id, rk in enumerate(ranks):
        ts = [wall(rank_id, r["t"]) for r in rk["records"]]
        t_first = min(ts) if ts else 0.0
        t_last = max(ts) if ts else 0.0
        ends.append(t_last)
        w = round(max(t_last - t_first, 0.0), 9)
        wait = round(min(wait_by_rank.get(rank_id, 0.0), w), 9)
        # compute = top-level span time net of the waits those spans
        # contain; clamped so the invariant closes exactly
        begins = {r["sid"]: r for r in rk["records"]
                  if r["kind"] == "span_begin"}
        comp_raw = 0.0
        for r in rk["records"]:
            if r["kind"] != "span_end":
                continue
            b = begins.get(r["sid"])
            if b is None or b.get("parent") is None:
                comp_raw += float(r.get("dur") or 0.0)
        compute = round(min(max(comp_raw - wait, 0.0),
                            max(w - wait, 0.0)), 9)
        unatt = round(w - wait - compute, 9)
        if unatt < 0.0:
            unatt = 0.0
            compute = round(max(w - wait, 0.0), 9)
        halo_bytes = sum(
            int(r["value"]) for r in rk["records"]
            if r["kind"] == "counter"
            and r["name"] == "amgx_halo_bytes_total"
            and isinstance(r["value"], (int, float)))
        off, drift, n_clk = fits[rank_id]
        rank_out[rank_id] = {
            "pid": rk["meta"].get("pid"),
            "session": rk["meta"].get("session"),
            "host": rk["meta"].get("host"),
            "wall_s": w, "compute_s": compute, "wait_s": wait,
            "unattributed_s": unatt,
            "straggler_score": round(
                induced[rank_id] / total_induced, 4)
            if total_induced > 0 else 0.0,
            "arrived_last": last_counts[rank_id],
            "collectives": part_counts[rank_id],
            "induced_wait_s": round(induced[rank_id], 9),
            "halo_bytes": halo_bytes,
            "clock_skew_s": round(off - base_off, 9),
            "clock_drift_ppm": round(drift * 1e6, 3),
            "clock_samples": n_clk,
            "first_t_s": round(t_first, 9),
            "last_t_s": round(t_last, 9),
        }

    # silent-rank / desync detection
    desync: List[dict] = []
    if n_ranks >= 2 and ends:
        mesh_end = max(ends)
        starts = [rank_out[r]["first_t_s"] for r in rank_out]
        span = max(mesh_end - min(starts), 0.0)
        for rank_id in rank_out:
            gap = mesh_end - ends[rank_id]
            if span > 0 and gap > max(SILENT_FRACTION * span,
                                      SILENT_MIN_S):
                desync.append({
                    "kind": "silent", "rank": rank_id,
                    "gap_s": round(gap, 9),
                    "gap_fraction": round(gap / span, 4),
                    "last_t_s": rank_out[rank_id]["last_t_s"]})
        # a rank that ran FEWER collectives of a key than its peers
        # desynced mid-program (crash, divergent control flow)
        key_counts: Dict[Tuple[str, str], Dict[int, int]] = {}
        for rank_id, rk in enumerate(ranks):
            for c in _rank_collectives(rk["records"]):
                d = key_counts.setdefault((c["op"], c["group"]), {})
                d[rank_id] = d.get(rank_id, 0) + 1
        for (op, group), d in sorted(key_counts.items()):
            mx = max(d.values())
            for rank_id in rank_out:
                n = d.get(rank_id, 0)
                if n < mx:
                    desync.append({
                        "kind": "missing_collectives", "rank": rank_id,
                        "op": op, "group": group,
                        "ran": n, "peers_ran": mx})

    return {
        "measured": measured,
        "mesh_version": MESH_VERSION,
        "n_ranks": n_ranks,
        "n_sessions": len(sessions),
        "ranks": rank_out,
        "rendezvous": rendezvous,
        "groups": {k: groups[k] for k in sorted(groups)},
        "collectives": {
            op: sum(1 for rv in rendezvous if rv["op"] == op)
            for op in OPS if any(rv["op"] == op for rv in rendezvous)},
        "wait_by_op": {k: round(v, 9)
                       for k, v in sorted(wait_by_op.items())},
        "total_wait_s": round(sum(wait_by_rank.values()), 9),
        "desync": desync,
        "truncated_tails": truncated,
        "notes": notes,
    }


def analyze(source: Union[str, List[str], Iterable[str]]) -> dict:
    """Mesh diagnosis of one or more JSONL traces.

    ``source``: a path, a list of paths (one per rank — or one file
    every rank appended to), or an iterable of JSONL lines.  Returns
    the mesh dict (see :func:`analyze_sessions`); a single-rank trace
    degrades to an honest ``measured=False`` stub."""
    if isinstance(source, str):
        sessions = read_sessions(source)
    else:
        src = list(source)
        if src and isinstance(src[0], str) and "\n" not in src[0] \
                and not src[0].lstrip().startswith("{"):
            sessions = []
            for p in src:
                sessions.extend(read_sessions(p))
        else:
            sessions = read_sessions(src)
    return analyze_sessions(sessions)


# ------------------------------------------------------------- emission
def emit(mesh: dict):
    """Record the mesh analysis into the ring + registry: one
    ``mesh_health`` event per rank (schema-enforced honesty invariant),
    one ``mesh_rendezvous`` event per reconstructed collective, and the
    ``amgx_mesh_*`` metric family.  No-op when telemetry is off."""
    if not recorder.is_enabled():
        return
    measured = bool(mesh.get("measured"))
    for rank_id, r in sorted((mesh.get("ranks") or {}).items()):
        recorder.event(
            "mesh_health", rank=int(rank_id), measured=measured,
            mesh_version=int(mesh.get("mesh_version", MESH_VERSION)),
            wall_s=r["wall_s"], compute_s=r["compute_s"],
            wait_s=r["wait_s"], unattributed_s=r["unattributed_s"],
            straggler_score=r["straggler_score"],
            arrived_last=int(r["arrived_last"]),
            collectives=int(r["collectives"]),
            halo_bytes=int(r["halo_bytes"]),
            clock_skew_s=r["clock_skew_s"])
        if r["wait_s"] > 0:
            metrics.counter_inc("amgx_mesh_wait_seconds_total",
                                r["wait_s"], rank=int(rank_id))
        metrics.gauge_set("amgx_mesh_straggler_score",
                          r["straggler_score"], rank=int(rank_id))
        metrics.gauge_set("amgx_mesh_clock_skew_seconds",
                          r["clock_skew_s"], rank=int(rank_id))
    for rv in mesh.get("rendezvous") or []:
        recorder.event(
            "mesh_rendezvous", op=rv["op"], group=str(rv["group"]),
            seq=int(rv["seq"]), n_ranks=int(rv["n_ranks"]),
            spread_s=rv["spread_s"], last_rank=int(rv["last_rank"]),
            wait_total_s=rv["wait_total_s"], measured=measured)

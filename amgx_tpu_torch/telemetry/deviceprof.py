"""Device-time attribution: the profiler-trace → scope correlator (port
of ``amgx_tpu/telemetry/deviceprof.py``).

Host spans measure when work was queued; this module answers where the
card actually spends a solve.  It parses a ``torch.profiler`` chrome
trace (``prof.export_chrome_trace``; plumbing in :mod:`.proftrace`),
joins each kernel, copy and set back to the ``amgx/<area>/<name>``
ranges that launched it (:mod:`.scopes`) — through the capture-time
scope map for the kernels of a CUDA graph replay — and produces a
**device-time cycle anatomy**: per-level pre/post-smooth +
restrict/prolong seconds, the coarse solve, per-pack SpMV device time
with measured bandwidth next to the yardstick, per-smoother and
per-Krylov-stage splits, and the halo-exchange share.

The anatomy is emitted as a schema-validated ``device_anatomy`` event
(the JAX package's fields, so either doctor reads it) and as
``amgx_device_time_seconds_total{scope}`` counters.  Every entry point
degrades to a ``measured=False`` stub when the trace carries no scoped
device activity (a CPU run).  A trace in the JAX package's form (slices
that carry their scopes in names or ``args``) is read as it is.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

from . import proftrace, scopes

_LEVEL_RE = re.compile(r"\Aamgx/cycle/level(\d+)/([a-z0-9_]+)\Z")
_KCYCLE_RE = re.compile(r"\Aamgx/cycle/kcycle(\d+)\Z")

#: anatomy sections keyed by scope-name prefix
_AREA_PREFIX = {a: f"amgx/{a}/" for a in scopes.AREAS}


def _round_s(us: float) -> float:
    return round(us * 1e-6, 9)


def graph_maps() -> dict:
    """The live CUDA graphs' scope maps, keyed (graph number, segment)
    as their replay ranges name them (``utils/cuda_graph.py``)."""
    from ..utils import cuda_graph
    out = {}
    for n, g in list(cuda_graph.GRAPHS.items()):
        for k, nodes in enumerate(g.scope_maps or ()):
            out[(n, k)] = nodes
    return out


def measure_anatomy(trace: "str | dict | Iterable[dict]",
                    pack_bytes: Optional[Dict[str, int]] = None,
                    pack_dispatches: Optional[Dict[str, int]] = None,
                    peak_gbs: Optional[float] = None,
                    maps: Optional[dict] = None,
                    pack_bytes_total: Optional[Dict[str, int]] = None
                    ) -> dict:
    """The device-time cycle anatomy of one profiler capture.

    ``trace``: a path (file or directory), a loaded chrome-trace dict,
    or an iterable of trace events.  ``pack_bytes`` /
    ``pack_dispatches`` (optional, from :func:`pack_stats`) map SpMV
    pack names to modelled bytes-per-apply and dispatch counts;
    ``pack_bytes_total`` (from ``ops/spmv.py::MODEL_BYTES``) maps a
    dispatch label to the modelled bytes of all its applies and wins
    where given; the anatomy then adds measured GB/s and the fraction
    of ``peak_gbs`` next to the label's device seconds.  ``peak_gbs``
    defaults to the card's measured copy rate
    (:func:`~.costmodel.measured_peak_gbs`) when CUDA is up; on the CPU
    it must be given, else no fraction is computed.  ``maps``: the
    CUDA graphs' scope maps (default: the live graphs',
    :func:`graph_maps`).

    ALWAYS returns a dict; ``measured`` is True only when at least one
    device slice carried a contract scope.  Per-scope seconds are the
    per-device **union** of that scope's slice intervals (overlapping
    levels / parallel tids do not double count), summed across devices;
    ``total_device_s`` is the union of every slice the same way, so
    attributed + unattributed ≡ total.
    """
    if peak_gbs is None:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            from .costmodel import measured_peak_gbs
            peak_gbs = measured_peak_gbs()
    events = proftrace.trace_events(trace)
    gstats = {}
    if proftrace.is_device_trace(events):
        events, gstats = proftrace.scoped_device_slices(
            events, graph_maps() if maps is None else maps)

    all_iv: Dict[object, List[tuple]] = {}        # pid -> intervals
    scoped_iv: Dict[object, List[tuple]] = {}     # pid -> intervals
    by_scope: Dict[Tuple[object, str], List[tuple]] = {}
    #: (pid, level) -> slices whose innermost cycle scope is kcycle<N>
    kcycle_iv: Dict[Tuple[object, str], List[tuple]] = {}
    n_slices = 0
    n_scoped = 0
    for ev in proftrace.complete_slices(events):
        n_slices += 1
        pid = ev.get("pid", 0)
        iv = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        all_iv.setdefault(pid, []).append(iv)
        found = scopes.scopes_in_event(ev)
        if not found:
            continue
        n_scoped += 1
        scoped_iv.setdefault(pid, []).append(iv)
        for s in found:
            by_scope.setdefault((pid, s), []).append(iv)
        cyc = [s for s in found if s.startswith("amgx/cycle/")]
        k = _KCYCLE_RE.match(cyc[-1]) if cyc else None
        if k:
            kcycle_iv.setdefault((pid, k.group(1)), []).append(iv)

    total_us = sum(proftrace.union_len(iv) for iv in all_iv.values())
    attrib_us = sum(proftrace.union_len(iv) for iv in scoped_iv.values())
    scope_us: Dict[str, float] = {}
    for (_pid, s), iv in by_scope.items():
        scope_us[s] = scope_us.get(s, 0.0) + proftrace.union_len(iv)

    # ---- per-level cycle anatomy (union across a level's components,
    # ---- so a level's total is honest even if components overlap) ----
    # a level's total also holds its K-cycle's own work (the slices whose
    # innermost cycle scope is kcycle<N>: level N's Krylov acceleration,
    # on the card some dozen small kernels a visit), as ``kcycle_s``
    levels: Dict[str, dict] = {}
    level_iv: Dict[Tuple[object, str], List[tuple]] = {}
    for (pid, s), iv in by_scope.items():
        m = _LEVEL_RE.match(s)
        if m:
            level_iv.setdefault((pid, m.group(1)), []).extend(iv)
    for (pid, lvl), iv in kcycle_iv.items():
        level_iv.setdefault((pid, lvl), []).extend(iv)
        d = levels.setdefault(lvl, {})
        d["kcycle_s"] = round(d.get("kcycle_s", 0.0)
                              + _round_s(proftrace.union_len(iv)), 9)
    for s, us in scope_us.items():
        m = _LEVEL_RE.match(s)
        if m:
            levels.setdefault(m.group(1), {})[m.group(2)] = _round_s(us)
    for (_pid, lvl), iv in level_iv.items():
        d = levels.setdefault(lvl, {})
        d["total_s"] = round(d.get("total_s", 0.0)
                             + _round_s(proftrace.union_len(iv)), 9)
    coarse_s = _round_s(scope_us.get("amgx/cycle/coarse_solve", 0.0))

    # ---- per-pack SpMV device time + measured bandwidth -------------
    pb = {scopes.sanitize(k): v for k, v in (pack_bytes or {}).items()
          if v}
    pt = {scopes.sanitize(k): v
          for k, v in (pack_bytes_total or {}).items() if v}
    pd = {scopes.sanitize(k): v
          for k, v in (pack_dispatches or {}).items() if v}
    spmv: Dict[str, dict] = {}
    for s, us in scope_us.items():
        if not s.startswith(_AREA_PREFIX["spmv"]):
            continue
        pack = s[len(_AREA_PREFIX["spmv"]):]
        d: dict = {"device_s": _round_s(us)}
        # op_cost events label the base pack kind ("dia", "dia/block"),
        # dispatch counters the refined label ("dia/slices",
        # "dia/block_kernel") — join on the longest base-kind key that
        # prefixes the dispatch label at a segment boundary
        byt = pb.get(pack)
        if not byt:
            for k in sorted(pb, key=len, reverse=True):
                if pack.startswith(k) and (len(pack) == len(k)
                                           or pack[len(k)] in "/_"):
                    byt = pb[k]
                    break
        n = pd.get(pack)
        total = pt.get(pack)
        if total is None and byt and n:
            d["bytes_per_apply"] = int(byt)
            d["dispatches"] = int(n)
            total = float(byt) * float(n)
        if total and us > 0:
            d["modelled_bytes"] = int(total)
            gbs = float(total) / (us * 1e-6) / 1e9
            d["measured_gbs"] = round(gbs, 2)
            if peak_gbs:
                d["roofline_fraction"] = round(gbs / peak_gbs, 6)
        spmv[pack] = d

    def _area(area: str) -> Dict[str, float]:
        pre = _AREA_PREFIX[area]
        return {s[len(pre):]: _round_s(us)
                for s, us in scope_us.items() if s.startswith(pre)}

    return {
        "measured": n_scoped > 0,
        "scope_version": scopes.SCOPE_VERSION,
        "total_device_s": _round_s(total_us),
        "attributed_s": _round_s(attrib_us),
        "unattributed_s": _round_s(max(total_us - attrib_us, 0.0)),
        "n_devices": len(all_iv),
        "n_slices": n_slices,
        "n_scoped_slices": n_scoped,
        "scopes": {s: _round_s(us)
                   for s, us in sorted(scope_us.items())},
        "levels": {k: levels[k] for k in sorted(levels, key=int)},
        "coarse_s": coarse_s,
        "spmv": {k: spmv[k] for k in sorted(spmv)},
        "smoothers": _area("smoother"),
        "krylov": _area("krylov"),
        "dist": _area("dist"),
        "hbm_peak_gbs": None if peak_gbs is None else float(peak_gbs),
        "graphs": gstats,
    }


def pack_stats(records: Iterable[dict]) -> Tuple[Dict[str, int],
                                                 Dict[str, int]]:
    """(pack → modelled bytes/apply, pack → dispatch count) from
    recorder ring records: the ``op_cost`` events' cost descriptors and
    the ``amgx_spmv_dispatch_total`` counter samples.  The biggest
    descriptor per pack kind wins (the fine operator dominates the
    bandwidth story)."""
    pack_bytes: Dict[str, int] = {}
    pack_disp: Dict[str, int] = {}
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "op_cost":
            a = r.get("attrs") or {}
            pack, byt = a.get("pack"), a.get("bytes_per_apply")
            if pack and isinstance(byt, (int, float)) and byt > 0:
                pack_bytes[str(pack)] = max(
                    pack_bytes.get(str(pack), 0), int(byt))
        elif r.get("kind") == "counter" and \
                r.get("name") == "amgx_spmv_dispatch_total":
            pack = (r.get("labels") or {}).get("pack")
            if pack:
                pack_disp[str(pack)] = pack_disp.get(str(pack), 0) \
                    + int(r.get("value") or 0)
    return pack_bytes, pack_disp


def capture_anatomy(trace, records: Optional[Iterable[dict]] = None
                    ) -> dict:
    """:func:`measure_anatomy` fed with pack bytes/dispatch counts from
    a recorder ring snapshot (default: the live ring)."""
    if records is None:
        from . import recorder
        records = recorder.records()
    pb, pd = pack_stats(records)
    return measure_anatomy(trace, pack_bytes=pb, pack_dispatches=pd)


def emit(anatomy: dict):
    """Record the anatomy: one schema-validated ``device_anatomy``
    event plus ``amgx_device_time_seconds_total{scope}`` counter
    increments (one per attributed scope).  No-op when telemetry is
    off."""
    from . import metrics, recorder
    if not recorder.is_enabled():
        return
    for s, sec in (anatomy.get("scopes") or {}).items():
        if sec:
            metrics.counter_inc("amgx_device_time_seconds_total",
                                float(sec), scope=s)
    recorder.event("device_anatomy", **anatomy)


def top_scopes(anatomy: dict, n: int = 2) -> List[Tuple[str, float]]:
    """The ``n`` largest (scope, seconds) pairs."""
    sc = anatomy.get("scopes") or {}
    return sorted(((k, float(v)) for k, v in sc.items()),
                  key=lambda kv: -kv[1])[:n]

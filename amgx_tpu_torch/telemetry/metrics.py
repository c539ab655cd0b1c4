"""Metrics registry: counters, gauges and wall-clock histograms.

The aggregated twin of the ring buffer: instruments update both — the
ring keeps raw samples for the JSONL trace, the registry keeps the
aggregate state the Prometheus snapshot renders.

Metric names are a **stable, versioned contract** (see :data:`METRICS`
and the README "Observability" section); renames are schema changes.
Instruments are cheap no-ops unless telemetry is enabled
(``recorder.is_enabled()``), so hot paths — every SpMV dispatch of the
eager loops — pay a single attribute check when it is off.

The names are the JAX package's, so either package's exporters and
doctor read the other's traces.  A few name a JAX mechanism; in the
port they count its counterpart on the card:

* ``amgx_jit_trace_total`` — CUDA graph captures (a capture re-runs the
  Python of an application, as a retrace re-runs it under ``jax.jit``;
  ``utils/cuda_graph.py``);
* ``amgx_jit_compile_total`` / ``amgx_jit_compile_seconds`` — kernel
  builds, one ``nvcc`` per ``csrc/*.cu`` source (``native.py``);
* ``amgx_setup_compile_seconds`` — kernel-build seconds inside the last
  profiled setup, ``amgx_setup_trace_seconds`` its graph-capture
  seconds (:mod:`.setup_profile`);
* ``amgx_spmv_dispatch_total`` — counts applies, not traces: the JAX
  package counts a dispatch once per traced program, the port once per
  apply, a graph replay crediting the applies its capture recorded
  (``cuda_graph.credit``);
* the zero cold-start block: ``amgx_compile_cache_*{layer="aot"}`` and
  ``amgx_aot_store_*`` count the warm-start store's setup plans
  (``serve/aot.py``; a CUDA graph is not stored, and a kernel build
  counts in ``amgx_jit_compile_total``); ``amgx_serve_warmup_seconds``
  includes the warmup solve that captures the graphs;
* ``amgx_serve_*`` / ``amgx_slo_*`` are the serving layer's
  (``serve/``, :mod:`.slo`): a request's ``solve`` phase is its share of
  a micro-batch that runs its right-hand sides one after another, and
  on the card every session's device work holds the card's lock, so
  ``queue_wait`` includes waiting for another session's solve;
* ``amgx_mesh_*`` (:mod:`.meshtrace`) read a multi-session trace; the
  port's shards live on one card in one process, so a one-card trace is
  one rank; ``amgx_halo_bytes_total`` counts device bytes moved by the
  one-card exchange (there is no interconnect wire).
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Optional, Tuple

from . import recorder

#: v1 metric-name registry: name -> (type, help).  ``{label}`` names in
#: the help string document the label keys each metric carries.
METRICS: Dict[str, Tuple[str, str]] = {
    "amgx_spmv_dispatch_total":
        ("counter", "SpMV dispatch decisions by chosen pack {pack}"),
    "amgx_spmv_fallback_total":
        ("counter", "SpMV calls where a packed kernel layout fell back "
                    "to a generic path {pack,reason}"),
    "amgx_jit_trace_total":
        ("counter", "CUDA graph captures of an application "
                    "(utils/cuda_graph.py), process-wide"),
    "amgx_device_time_seconds_total":
        ("counter", "profiler-measured device seconds attributed to a "
                    "named-scope contract scope (telemetry/deviceprof.py) "
                    "{scope}"),
    "amgx_jit_compile_total":
        ("counter", "kernel builds, one nvcc per csrc source "
                    "(native.py), process-wide"),
    "amgx_solves_total":
        ("counter", "completed solves by final status {status}"),
    "amgx_solve_diverged_total":
        ("counter", "solves that ended with a non-finite residual"),
    "amgx_hierarchy_levels":
        ("gauge", "levels in the last AMG hierarchy setup"),
    "amgx_level_rows":
        ("gauge", "rows of one hierarchy level {level}"),
    "amgx_level_nnz":
        ("gauge", "stored nonzeros of one hierarchy level {level}"),
    "amgx_operator_complexity":
        ("gauge", "sum(level nnz) / fine nnz of the last hierarchy"),
    "amgx_grid_complexity":
        ("gauge", "sum(level rows) / fine rows of the last hierarchy"),
    "amgx_solve_iterations":
        ("gauge", "iterations of the last solve"),
    "amgx_solve_final_relres":
        ("gauge", "final true relative residual of the last solve"),
    "amgx_solve_convergence_rate":
        ("gauge", "geometric-mean per-iteration residual reduction of "
                  "the last solve"),
    "amgx_last_setup_seconds":
        ("gauge", "wall seconds of the last solver setup"),
    "amgx_last_solve_seconds":
        ("gauge", "wall seconds of the last solve"),
    # ---- distributed / halo-exchange instrumentation --------
    "amgx_halo_exchange_total":
        ("counter", "halo exchanges instrumented (traced) "
                    "{ring,op,path}"),
    "amgx_halo_bytes_total":
        ("counter", "bytes one instrumented halo exchange moves, "
                    "mesh-wide, padded send buffers {ring,op}"),
    "amgx_halo_entries_total":
        ("counter", "useful (unpadded) halo values gathered per "
                    "instrumented exchange, mesh-wide {ring,op}"),
    "amgx_dist_boundary_fraction":
        ("gauge", "boundary rows / local rows of one shard {device}"),
    "amgx_dist_halo_entries":
        ("gauge", "ring-1 halo width of one shard {device}"),
    "amgx_dist_ring_hops":
        ("gauge", "collectives one halo exchange executes: ppermute "
                  "hops of the ring schedule, or 1 on the all_gather "
                  "fallback {ring}"),
    # ---- pod-scale distributed AMG (distributed/agglomerate.py +
    # costmodel.dist_overlap) ----------------------------------------
    "amgx_dist_agglomerate_total":
        ("counter", "coarse-level agglomerations planned onto a "
                    "shrinking sub-mesh {reused=0|1}"),
    "amgx_dist_submesh_parts":
        ("gauge", "active ranks of the sub-mesh one distributed "
                  "hierarchy level lives on {level}"),
    "amgx_dist_overlap_fraction":
        ("gauge", "fraction of one level's halo exchange hideable "
                  "under its interior SpMV (1 = fully hidden); "
                  "modelled, or profiler-measured when a trace was "
                  "supplied (telemetry/overlap.py) {level}"),
    # ---- communication-avoiding Krylov (ops/blas.py fused
    # reductions + solvers/krylov.py CA/PIPELINED variants) ---------
    "amgx_krylov_collectives_total":
        ("counter", "reduction collectives executed by Krylov solve "
                    "loops: trace-time per-iteration profile x executed "
                    "iterations {op=dot|norm|gram|fused|replace}"),
    # ---- mesh flight recorder (telemetry/meshtrace.py):
    # cross-rank rendezvous reconstruction over clock-aligned
    # per-rank traces ------------------------------------------------
    "amgx_mesh_wait_seconds_total":
        ("counter", "per-rank wall seconds spent waiting for the last "
                    "arrival at reconstructed collective rendezvous "
                    "(halo exchanges, fused Krylov reductions, "
                    "agglomerations) {rank}"),
    "amgx_mesh_straggler_score":
        ("gauge", "share of mesh-wide induced wait caused by one rank "
                  "arriving last at collectives (0 = never last, "
                  "1 = every second of wait) {rank}"),
    "amgx_mesh_clock_skew_seconds":
        ("gauge", "fitted wall-clock offset of one rank's trace "
                  "relative to rank 0 (per-session offset+slope fit "
                  "over meta + clock_sample pairs) {rank}"),
    # ---- convergence forensics (telemetry/forensics.py) ------------
    "amgx_forensics_nullspace":
        ("gauge", "near-nullspace preservation |A*1|inf/|A|inf of one "
                  "hierarchy level {level}"),
    "amgx_forensics_galerkin_err":
        ("gauge", "sampled relative error of R*A*P vs the stored "
                  "coarse operator below one level {level}"),
    "amgx_forensics_cf_ratio":
        ("gauge", "coarse rows / fine rows across one coarsening "
                  "{level}"),
    "amgx_forensics_strong_frac":
        ("gauge", "fraction of sampled off-diagonal couplings that are "
                  "strong (AHAT theta=0.25) on one level {level}"),
    "amgx_forensics_asymptotic_rate":
        ("gauge", "asymptotic per-iteration residual reduction of the "
                  "last solve (trailing-half estimate)"),
    # ---- static cost model (telemetry/costmodel.py); the dtype label
    # is the level's STORAGE precision (mixed precision: bf16 levels
    # stream half the value bytes of f32 ones) ---------------------
    "amgx_level_spmv_bytes":
        ("gauge", "modelled HBM bytes of one SpMV on one hierarchy "
                  "level {level,dtype}"),
    "amgx_level_spmv_flops":
        ("gauge", "useful flops (2*nnz) of one SpMV on one hierarchy "
                  "level {level,dtype}"),
    "amgx_level_padding_waste":
        ("gauge", "stored slots / nnz of one level's device pack "
                  "{level,dtype}"),
    # ---- setup profiler (telemetry/setup_profile.py) ----------------
    "amgx_setup_phase_seconds":
        ("gauge", "exclusive wall seconds of one setup phase component "
                  "of the last profiled setup {component}"),
    "amgx_setup_compile_seconds":
        ("gauge", "kernel-build (nvcc) seconds attributed to the last "
                  "profiled setup"),
    "amgx_setup_trace_seconds":
        ("gauge", "CUDA-graph-capture seconds attributed to the last "
                  "profiled setup"),
    "amgx_setup_transfer_seconds":
        ("gauge", "blocking host<->device transfer seconds of the last "
                  "profiled setup"),
    "amgx_setup_mem_watermark_bytes":
        ("gauge", "device-memory high-water mark sampled at phase "
                  "boundaries of the last profiled setup"),
    "amgx_setup_transfer_bytes_total":
        ("counter", "host<->device bytes moved by instrumented setup "
                    "transfers {kind=upload|download}"),
    "amgx_setup_transfers_total":
        ("counter", "blocking transfer calls instrumented during setup "
                    "{kind=upload|download}"),
    # ---- device setup engine (amg/device_setup/ + ops/spgemm.py) ----
    "amgx_spgemm_total":
        ("counter", "device SpGEMM numeric passes by operation "
                    "{op=rap|agg|spgemm}"),
    "amgx_device_rap_total":
        ("counter", "Galerkin RAP products by executing path "
                    "{path=device|host}"),
    "amgx_device_setup_fallback_total":
        ("counter", "device setup gates that fell back to the host "
                    "path {reason}"),
    "amgx_spgemm_plan_cache":
        ("gauge", "setup plans held in the pattern-keyed plan cache"),
    "amgx_spgemm_plan_bytes":
        ("gauge", "schedule bytes held in the pattern-keyed plan "
                  "cache"),
    "amgx_setup_seconds":
        ("histogram", "solver setup wall seconds"),
    "amgx_resetup_seconds":
        ("histogram", "solver numeric-resetup wall seconds"),
    "amgx_solve_seconds":
        ("histogram", "solve wall seconds"),
    "amgx_jit_compile_seconds":
        ("histogram", "kernel build (nvcc) wall seconds"),
    # ---- serving subsystem (serve/) -----------------------------------
    "amgx_serve_requests_total":
        ("counter", "serving requests completed by outcome {status}"),
    "amgx_serve_rejected_total":
        ("counter", "serving admission rejections {reason}"),
    "amgx_serve_queue_depth":
        ("gauge", "requests waiting in the serving admission queue"),
    "amgx_serve_batch_size":
        ("histogram", "RHS count of one executed micro-batch"),
    "amgx_serve_request_seconds":
        ("histogram", "request latency, submit to completed result"),
    "amgx_serve_cache_hits_total":
        ("counter", "setup-cache lookups that found a session"),
    "amgx_serve_cache_misses_total":
        ("counter", "setup-cache lookups that created a session"),
    "amgx_serve_cache_evictions_total":
        ("counter", "sessions evicted by the cache byte budget"),
    "amgx_serve_cache_bytes":
        ("gauge", "resident device bytes of cached sessions"),
    "amgx_serve_setup_total":
        ("counter", "session preparations by kind "
                    "{kind=full|resetup|reuse}"),
    "amgx_worker_task_failures_total":
        ("counter", "worker-pool tasks that raised (pool survives)"),
    # ---- zero cold-start (serve/aot.py, native.py) -------------------
    "amgx_compile_cache_hits_total":
        ("counter", "setup plans loaded from the warm-start store "
                    "instead of built {layer=aot}"),
    "amgx_compile_cache_misses_total":
        ("counter", "setup-plan lookups the store could not serve "
                    "{layer=aot}"),
    "amgx_compile_cache_fallbacks_total":
        ("counter", "store entries unusable at load (version "
                    "mismatch, corruption, serialize failure) {reason}"),
    "amgx_aot_store_bytes":
        ("gauge", "bytes of the stored setup plans in the store "
                  "directory"),
    "amgx_aot_store_entries":
        ("gauge", "setup plans in the store directory"),
    "amgx_serve_warmup_seconds":
        ("histogram", "wall seconds of one SolveService.warmup "
                      "(setups and the graph-capturing solve)"),
    # ---- live serving observability (telemetry/slo.py + httpd.py +
    # ---- request-lifecycle tracing in serve/) -----------------------
    "amgx_serve_phase_seconds":
        ("histogram", "per-request lifecycle phase duration "
                      "{phase=admit|queue_wait|prepare|solve|finalize"
                      "|errored}"),
    "amgx_serve_inflight":
        ("gauge", "requests drained from the queue whose batch has not "
                  "finished"),
    "amgx_serve_overload":
        ("gauge", "SLO overload trip wire (1 = windowed shed rate or "
                  "queue depth past threshold)"),
    "amgx_slo_attainment":
        ("gauge", "fraction of windowed requests that completed OK "
                  "within deadline and latency objective"),
    "amgx_slo_burn_rate":
        ("gauge", "error-budget burn rate (1-attainment)/(1-target) "
                  "over the SLO window"),
    "amgx_slo_window_requests":
        ("gauge", "request outcomes currently held in the SLO window"),
    "amgx_serve_profile_total":
        ("counter", "served batches sampled by the solve-path profiler "
                    "(serve_profile_every)"),
    "amgx_serve_achieved_gbs":
        ("gauge", "measured device bandwidth of the last profiled "
                  "batch of one pattern {pattern}"),
    # ---- multi-device scale-out (serve/router.py): per-lane executor
    # ---- state + the router's replication/steal decisions -----------
    "amgx_serve_lane_queue_depth":
        ("gauge", "requests waiting in one executor lane's admission "
                  "queue {lane}"),
    "amgx_serve_lane_inflight":
        ("gauge", "requests drained from one lane's queue whose batch "
                  "has not finished {lane}"),
    "amgx_serve_lane_attainment":
        ("gauge", "SLO attainment over one lane's request window "
                  "{lane}"),
    "amgx_serve_lane_sessions":
        ("gauge", "sessions resident in one lane's setup-cache slice "
                  "{lane}"),
    "amgx_serve_steals_total":
        ("counter", "cold-pattern requests work-stolen to the "
                    "least-loaded lane instead of their hash-home "
                    "{lane=receiving lane}"),
    "amgx_serve_replications_total":
        ("counter", "hot patterns replicated onto an idle lane "
                    "{lane=replica lane}"),
    # ---- breakdown-aware solving (errors.FailureKind +
    # ---- solvers/recovery.py + utils/faultinject.py) ------
    "amgx_solve_failures_total":
        ("counter", "monitored solves that terminated in failure, by "
                    "taxonomy kind {kind}"),
    "amgx_history_truncated_total":
        ("counter", "residual-history slabs whose non-finite rows were "
                    "filtered (each emits a history_truncated event "
                    "with the first bad iteration)"),
    "amgx_recovery_total":
        ("counter", "recovery-ladder attempts {kind,action,outcome}"),
    "amgx_fault_injected_total":
        ("counter", "fault-injection firings by point {point}"),
    "amgx_retries_total":
        ("counter", "bounded transient-failure retries "
                    "(utils/retry.py) {label}"),
    "amgx_worker_respawns_total":
        ("counter", "worker pools re-created after out-of-band "
                    "death/shutdown was detected"),
    "amgx_serve_retries_total":
        ("counter", "serve requests re-queued by the per-request "
                    "execution retry budget (serve_retry_max)"),
    "amgx_serve_quarantined_total":
        ("counter", "patterns quarantined after consecutive error "
                    "outcomes (serve_quarantine_threshold)"),
    "amgx_serve_quarantined_patterns":
        ("gauge", "patterns currently rejected at admission by the "
                  "quarantine"),
    "amgx_serve_breaker_trips_total":
        ("counter", "executor-lane circuit-breaker trips {lane}"),
    # ---- HBM ledger (telemetry/memledger.py) --------------
    "amgx_hbm_bytes":
        ("gauge", "owner-attributed device bytes of the last ledger "
                  "sample {device,owner}"),
    "amgx_hbm_headroom_bytes":
        ("gauge", "bytes_limit - bytes_in_use of one device at the "
                  "last ledger sample (measured platforms only) "
                  "{device}"),
    "amgx_hbm_peak_bytes":
        ("gauge", "allocator peak_bytes_in_use of one device at the "
                  "last ledger sample (measured platforms only) "
                  "{device}"),
}

#: wall-clock histogram bucket upper bounds (seconds)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   60.0)
#: count-valued histogram buckets (micro-batch sizes)
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
#: histograms whose unit is a count, not seconds
_COUNT_HISTS = frozenset({"amgx_serve_batch_size"})

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(recorder._jsonable(v)))
                        for k, v in labels.items()))


class _Hist:
    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # +1: +Inf bucket
        self.total = 0.0
        self.count = 0

    def observe(self, v: float):
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1


class MetricsRegistry:
    """Thread-safe aggregate store keyed by (name, sorted labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], float] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], float] = {}
        self._hists: Dict[Tuple[str, _LabelKey], _Hist] = {}

    # ------------------------------------------------------------- update
    def counter_inc(self, name: str, value: float = 1.0, **labels):
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge_set(self, name: str, value: float, **labels):
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = value

    def gauge_clear(self, name: str):
        """Drop every labeled series of one gauge — used before
        re-emitting a label family whose cardinality may shrink (a
        shallower hierarchy must not leave stale deep-level gauges in
        the Prometheus snapshot)."""
        with self._lock:
            for key in [k for k in self._gauges if k[0] == name]:
                del self._gauges[key]

    def hist_observe(self, name: str, value: float, **labels):
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                bounds = COUNT_BUCKETS if name in _COUNT_HISTS \
                    else DEFAULT_BUCKETS
                h = self._hists[key] = _Hist(bounds)
            h.observe(value)

    # -------------------------------------------------------------- query
    def get_counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0.0)

    def get_gauge(self, name: str, default=None, **labels):
        with self._lock:
            return self._gauges.get((name, _label_key(labels)), default)

    def snapshot(self) -> dict:
        """Plain-python copy: {"counters": {...}, "gauges": {...},
        "histograms": {...}} with ``name{k=v,...}`` string keys."""
        def fmt(name, lk):
            if not lk:
                return name
            return name + "{" + ",".join(f"{k}={v}" for k, v in lk) + "}"
        with self._lock:
            return {
                "counters": {fmt(n, lk): v for (n, lk), v
                             in sorted(self._counters.items())},
                "gauges": {fmt(n, lk): v for (n, lk), v
                           in sorted(self._gauges.items())},
                "histograms": {fmt(n, lk): {"count": h.count,
                                            "sum": h.total}
                               for (n, lk), h
                               in sorted(self._hists.items())},
            }

    def items(self):
        """Locked copy of the raw stores (used by the Prometheus
        renderer): (counters, gauges, hists)."""
        with self._lock:
            return (dict(self._counters), dict(self._gauges),
                    {k: (h.bounds, tuple(h.counts), h.total, h.count)
                     for k, h in self._hists.items()})

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


# ------------------------------------------------- gated module instruments
def counter_inc(name: str, value: float = 1.0, **labels):
    if not recorder.is_enabled():
        return
    _registry.counter_inc(name, value, **labels)
    recorder.metric_sample("counter", name, value, labels)


def gauge_set(name: str, value, **labels):
    if not recorder.is_enabled():
        return
    value = float(value)
    _registry.gauge_set(name, value, **labels)
    recorder.metric_sample("gauge", name, value, labels)


def hist_observe(name: str, value: float, **labels):
    if not recorder.is_enabled():
        return
    value = float(value)
    _registry.hist_observe(name, value, **labels)
    recorder.metric_sample("hist", name, value, labels)

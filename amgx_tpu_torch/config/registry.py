"""Typed parameter registry.

Mirrors the reference's static registry ``AMG_Config::param_desc``
(``base/include/amg_config.h:49-190``) populated by ``registerParameters()``
(``core/src/core.cu:331-560``).  Every parameter has a name, python type,
default value, description and optional allowed values/range.  Lookup is
*scoped*: nested solvers read their own sub-config scope, falling back to the
"default" scope (``amg_config.h:197-198``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from ..errors import BadConfigurationError

_BOOL = (0, 1)
_NORMS = ("L1", "L2", "LMAX", "L1_SCALED")
_VIEWS = ("INTERIOR", "OWNED", "FULL", "ALL")
_ALGOS = ("CLASSICAL", "AGGREGATION", "ENERGYMIN")
_COLORING = ("FIRST", "SYNC_COLORS", "LAST")
_BLOCK_FORMATS = ("ROW_MAJOR", "COL_MAJOR")


@dataclasses.dataclass
class ParameterDescription:
    name: str
    type: type
    default: Any
    description: str = ""
    allowed: Optional[Sequence[Any]] = None     # enumerated values
    range: Optional[Tuple[Any, Any]] = None     # inclusive numeric range


_registry: Dict[str, ParameterDescription] = {}


def register_parameter(name, type_, default, description="", allowed=None,
                       range_=None, overwrite=False):
    if name in _registry and not overwrite:
        return
    _registry[name] = ParameterDescription(name, type_, default, description,
                                           allowed, range_)


def get_description(name: str) -> Optional[ParameterDescription]:
    return _registry.get(name)


def all_parameters() -> Dict[str, ParameterDescription]:
    return dict(_registry)


def coerce(name: str, value: Any) -> Any:
    """Coerce a parsed value to the registered type, validating allowed values.

    Mirrors ``AMG_Config::setNamedParameter`` overloads
    (``amg_config.cu:439-517``): int<->double cross-assignment is allowed,
    strings parse to numbers for numeric params.
    """
    desc = _registry.get(name)
    if desc is None:
        # Unknown parameter: keep as-is (reference raises; we store and let the
        # consuming factory complain — but validate obvious typos at get()).
        return value
    t = desc.type
    try:
        if t is int:
            if isinstance(value, str):
                value = int(float(value))
            elif isinstance(value, float):
                value = int(value)
            else:
                value = int(value)
        elif t is float:
            value = float(value)
        elif t is str:
            value = str(value)
    except (TypeError, ValueError):
        raise BadConfigurationError(
            f"parameter {name!r}: cannot convert {value!r} to {t.__name__}")
    if desc.allowed is not None and value not in desc.allowed:
        raise BadConfigurationError(
            f"parameter {name!r}: value {value!r} not in allowed set "
            f"{tuple(desc.allowed)}")
    if desc.range is not None:
        lo, hi = desc.range
        if not (lo <= value <= hi):
            raise BadConfigurationError(
                f"parameter {name!r}: value {value!r} outside [{lo}, {hi}]")
    return value


_SOLVER_VALUES = (
    "AMG", "CG", "PCG", "PCGF", "BICGSTAB", "PBICGSTAB", "GMRES", "FGMRES",
    "IDR", "IDRMSYNC", "JACOBI_L1", "BLOCK_JACOBI", "CF_JACOBI", "GS",
    "MULTICOLOR_GS", "FIXCOLOR_GS", "MULTICOLOR_ILU", "MULTICOLOR_DILU",
    "KACZMARZ", "CHEBYSHEV", "CHEBYSHEV_POLY", "POLYNOMIAL", "KPZ_POLYNOMIAL",
    "DENSE_LU_SOLVER", "NOSOLVER", "PCG_CA", "PCG_PIPE",
)

_KRYLOV_COMM = ("CLASSIC", "CA", "PIPELINED")


def register_default_parameters():
    """Register the reference's parameter set (``core/src/core.cu:331-560``)."""
    R = register_parameter
    # --- global/debug flags (core.cu:337-381)
    R("determinism_flag", int, 0, "force deterministic aggregation/coloring", _BOOL)
    R("exception_handling", int, 0, "internal exception processing", _BOOL)
    R("fine_level_consolidation", int, 0, "consolidate fine level", _BOOL)
    R("use_cuda_ipc_consolidation", int, 0, "(GPU legacy) IPC consolidation", _BOOL)
    R("amg_consolidation_flag", int, 0, "use amg level consolidation")
    R("matrix_consolidation_lower_threshold", int, 0,
      "avg rows at which partitions must be merged")
    R("matrix_consolidation_upper_threshold", int, 1000,
      "avg rows merged partitions should have")
    R("device_mem_pool_size", int, 256 * 1024 * 1024, "device pool bytes")
    R("device_consolidation_pool_size", int, 256 * 1024 * 1024)
    R("device_mem_pool_max_alloc_size", int, 20 * 1024 * 1024)
    R("device_alloc_scaling_factor", int, 10)
    R("device_alloc_scaling_threshold", int, 16 * 1024)
    R("device_mem_pool_size_limit", int, 0)
    R("num_streams", int, 0, "extra async streams")
    R("serialize_threads", int, 0, "serialize setup threads", _BOOL)
    R("high_priority_stream", int, 0, "", _BOOL)
    R("communicator", str, "MPI", "<MPI|MPI_DIRECT> (TPU: ICI collectives)")
    R("separation_interior", str, "INTERIOR", "latency-hiding split", _VIEWS)
    R("separation_exterior", str, "OWNED", "smoothing extent", _VIEWS)
    R("min_rows_latency_hiding", int, -1, "rows to disable latency hiding")
    R("matrix_halo_exchange", int, 0, "0 none, 1 diag, 2 full")
    R("boundary_coloring", str, "SYNC_COLORS", "", _COLORING)
    R("halo_coloring", str, "LAST", "", _COLORING)
    R("use_sum_stopping_criteria", int, 0)
    R("rhs_from_a", int, 0, "generate missing RHS from A")
    R("complex_conversion", int, 0)
    R("matrix_writer", str, "matrixmarket", "", ("matrixmarket", "binary"))
    R("block_format", str, "ROW_MAJOR", "", _BLOCK_FORMATS)
    R("block_convert", int, 0)
    # --- solver selection (core.cu:404-411)
    R("solver", str, "AMG", "solving algorithm", _SOLVER_VALUES)
    R("preconditioner", str, "AMG", "preconditioner algorithm", _SOLVER_VALUES)
    R("coarse_solver", str, "DENSE_LU_SOLVER", "", _SOLVER_VALUES)
    R("smoother", str, "BLOCK_JACOBI", "", _SOLVER_VALUES)
    R("fine_smoother", str, "BLOCK_JACOBI", "", _SOLVER_VALUES)
    R("coarse_smoother", str, "BLOCK_JACOBI", "", _SOLVER_VALUES)
    # --- Krylov params (core.cu:413-416)
    R("gmres_n_restart", int, 20, "Krylov vectors in (F)GMRES")
    R("gmres_krylov_dim", int, 0, "max Krylov dim (0: = restart)")
    R("subspace_dim_s", int, 8, "IDR subspace dim")
    R("krylov_comm", str, "CLASSIC",
      "Krylov communication mode: CLASSIC (two blocking reductions per CG "
      "iter), CA (Chronopoulos-Gear single-reduction), PIPELINED "
      "(Ghysels-Vanroose, reduction overlapped with SpMV+precond)",
      _KRYLOV_COMM)
    R("ca_residual_replace", int, 10,
      "iterations between true-residual replacement in CA/pipelined CG "
      "(0 disables; drift must never fake convergence — pipelined "
      "recurrence drift on jumpy-coefficient operators exceeds 1e-4 "
      "within ~15 iters, so the default must fire inside a typical "
      "AMG-preconditioned solve)", None, (0, 1 << 30))
    # --- direct/smoother params (core.cu:418-439)
    R("dense_lu_num_rows", int, 128)
    R("dense_lu_max_rows", int, 0)
    R("relaxation_factor", float, 0.9, "", None, (0.0, 2.0))
    R("ilu_sparsity_level", int, 0, "0:ILU0, 1:ILU1, ...")
    R("symmetric_GS", int, 0, "", _BOOL)
    R("jacobi_iters", int, 5)
    R("GS_L1_variant", int, 0, "", _BOOL)
    R("kpz_mu", int, 4)
    R("kpz_order", int, 3)
    R("chebyshev_polynomial_order", int, 5)
    R("chebyshev_lambda_estimate_mode", int, 0, "", None, (0, 3))
    R("cheby_max_lambda", float, 1.0, "", None, (0.0, 1.0e20))
    R("cheby_min_lambda", float, 0.125, "", None, (0.0, 1.0e20))
    R("kaczmarz_coloring_needed", int, 1)
    R("cf_smoothing_mode", int, 0)
    # --- AMG hierarchy (core.cu:445-467)
    R("algorithm", str, "CLASSICAL", "AMG algorithm", _ALGOS)
    R("amg_host_levels_rows", int, -1)
    R("cycle", str, "V", "", ("V", "W", "F", "CG", "CGF"))
    R("max_levels", int, 100)
    R("min_fine_rows", int, 1)
    R("min_coarse_rows", int, 2)
    R("max_coarse_iters", int, 100)
    R("coarsen_threshold", float, 1.0)
    R("presweeps", int, 1)
    R("postsweeps", int, 1)
    R("finest_sweeps", int, -1)
    R("coarsest_sweeps", int, 2)
    R("cycle_iters", int, 2, "CG/CGF cycle inner iters")
    R("structure_reuse_levels", int, 0)
    # allowed values as the reference registers them (core.cu:461-464);
    # the Vanek modes 4/5 are not registered there either
    R("error_scaling", int, 0, "", (0, 2, 3))
    R("reuse_scale", int, 0)
    R("scaling_smoother_steps", int, 2)
    R("intensive_smoothing", int, 0)
    # --- aggregation (core.cu:471-502)
    R("coarseAgenerator", str, "LOW_DEG", "", ("LOW_DEG", "THRUST", "HYBRID"))
    R("coarseAgenerator_coarse", str, "LOW_DEG", "",
      ("LOW_DEG", "THRUST", "HYBRID"))
    R("interpolator", str, "D1", "", ("D1", "D2", "MULTIPASS", "EM"))
    R("energymin_interpolator", str, "EM")
    R("energymin_selector", str, "CR")
    R("selector", str, "PMIS")
    R("aggressive_levels", int, 0)
    R("aggressive_selector", str, "DEFAULT")
    R("aggressive_interpolator", str, "MULTIPASS")
    R("handshaking_phases", int, 1, "", (1, 2))
    R("aggregation_edge_weight_component", int, 0)
    R("max_matching_iterations", int, 15)
    R("max_unassigned_percentage", float, 0.05)
    R("weight_formula", int, 0)
    R("aggregation_passes", int, 3)
    R("filter_weights", int, 0)
    R("filter_weights_alpha", float, 0.5, "", None, (0.0, 1.0))
    R("full_ghost_level", int, 0)
    R("notay_weights", int, 0)
    R("ghost_offdiag_limit", int, 0)
    R("merge_singletons", int, 1)
    R("serial_matching", int, 0)
    R("modified_handshake", int, 0)
    R("aggregate_size", int, 2)
    # --- classical strength/interp (core.cu:504-510)
    R("strength", str, "AHAT", "", ("AHAT", "ALL", "AFFINITY"))
    R("strength_threshold", float, 0.25)
    R("max_row_sum", float, 1.1)
    R("interp_truncation_factor", float, 1.1)
    R("interp_max_elements", int, -1)
    R("affinity_iterations", int, 4)
    R("affinity_vectors", int, 4)
    # --- coloring (core.cu:512-527)
    R("coloring_level", int, 1)
    R("reorder_cols_by_color", int, 0)
    R("insert_diag_while_reordering", int, 0)
    R("matrix_coloring_scheme", str, "MIN_MAX")
    R("max_num_hash", int, 7)
    R("num_colors", int, 10)
    R("max_uncolored_percentage", float, 0.15, "", None, (0.0, 1.0))
    R("initial_color", int, 0)
    R("use_bsrxmv", int, 0)
    R("fine_levels", int, -1)
    R("coloring_try_remove_last_colors", int, 0)
    R("coloring_custom_arg", str, "")
    R("print_coloring_info", int, 0)
    R("weakness_bound", int, 2**31 - 1)
    R("late_rejection", int, 0)
    R("geometric_dim", int, 2)
    # --- deprecated spmm knobs kept for config compat (core.cu:529-532)
    R("spmm_gmem_size", int, 1024)
    R("spmm_no_sort", int, 1)
    R("spmm_verbose", int, 0)
    R("spmm_max_attempts", int, 6)
    # --- outer solve control (core.cu:534-555)
    R("max_iters", int, 100)
    R("monitor_residual", int, 0, "", _BOOL)
    R("convergence", str, "ABSOLUTE",
      "<ABSOLUTE|RELATIVE_MAX|RELATIVE_INI|RELATIVE_INI_CORE|RELATIVE_MAX_CORE"
      "|COMBINED_REL_INI_ABS>")
    R("norm", str, "L2", "", _NORMS)
    R("use_scalar_norm", int, 0, "", _BOOL)
    R("tolerance", float, 1e-12)
    R("alt_rel_tolerance", float, 1e-12)
    R("verbosity_level", int, 3)
    R("solver_verbose", int, 0)
    R("print_config", int, 0)
    R("print_solve_stats", int, 0)
    R("print_grid_stats", int, 0)
    R("print_vis_data", int, 0)
    R("print_aggregation_info", int, 0)
    R("obtain_timings", int, 0)
    R("store_res_history", int, 0)
    R("convergence_analysis", int, 0)
    R("scaling", str, "NONE", "",
      ("NONE", "BINORMALIZATION", "NBINORMALIZATION", "DIAGONAL_SYMMETRIC"))
    # setup-time bandwidth-reduction reordering (reference analog: the
    # setup renumbering of matrix.cu:760-813): AUTO rescues matrices
    # that would otherwise fall off the windowed-kernel budget onto the
    # TPU gather cliff; RCM forces it; NONE disables
    R("matrix_reorder", str, "AUTO", "", ("NONE", "RCM", "AUTO"))
    # --- eigensolver params (eigensolvers/src/eigensolvers.cu:44-54)
    R("eig_solver", str, "POWER_ITERATION")
    R("eig_max_iters", int, 100)
    R("eig_tolerance", float, 1e-6)
    R("eig_shift", float, 0.0)
    R("eig_damping_factor", float, 0.85, "PageRank damping")
    R("eig_which", str, "largest", "", ("largest", "smallest", "pagerank"))
    R("eig_eigenvector", int, 0, "number of eigenvectors to extract")
    R("eig_wanted_count", int, 1)
    R("eig_eigenvector_solver", str, "default")
    # --- TPU-build extensions (no reference equivalent)
    R("tpu_matrix_dtype", str, "default",
      "override device matrix dtype <default|float64|float32|bfloat16>",
      ("default", "float64", "float32", "bfloat16"))
    # mixed precision (core/precision.py — the dDFI mixed-mode analog,
    # amgx_config.h:114-123): the AMG hierarchy's level operators,
    # smoother data and transfer packs are STORED in hierarchy_dtype
    # (arithmetic accumulates in f32); Krylov vectors, dot products and
    # residual monitoring run in krylov_dtype; tolerances below the
    # active precision's floor promote through the defect-correction
    # ladder (bf16 preconditioner -> f32 Krylov -> f64 refinement)
    R("hierarchy_dtype", str, "default",
      "storage dtype of AMG hierarchy levels from "
      "mixed_precision_from_level down (bf16 halves per-cycle HBM "
      "bytes; RAP/setup still compute in f32+)",
      ("default", "float64", "float32", "bfloat16"))
    R("krylov_dtype", str, "default",
      "device dtype of the outer Krylov loop (vectors, dots, residual "
      "monitoring); applied by the top-level solver only",
      ("default", "float64", "float32", "bfloat16"))
    R("mixed_precision_from_level", int, 0,
      "first hierarchy level stored in hierarchy_dtype (0 = the whole "
      "hierarchy incl. the fine-level smoothing pack)")
    R("tpu_ell_max_width", int, 2048,
      "max padded row width before SpMV falls back to CSR segment-sum")
    # structured telemetry (amgx_tpu/telemetry/): process-global
    # recording enabled from any solver whose config sets telemetry=1;
    # enabling also keeps the residual history so per-iteration
    # residual records can be emitted
    R("telemetry", int, 0,
      "enable structured telemetry (spans/events/metrics)", _BOOL)
    R("telemetry_path", str, "",
      "JSONL trace file; appended incrementally after setup/solve")
    R("telemetry_ring_size", int, 65536,
      "max telemetry records held in the in-memory ring buffer")
    # convergence forensics (telemetry/forensics.py): per-level cycle
    # anatomy (residual norms at the four cut points of every cycle),
    # hierarchy quality probes at setup, and the asymptotic
    # convergence-factor gauge.  Off by default: the traced cycle is
    # bit-identical to the uninstrumented one when 0 (no extra jit
    # traces); 1 adds three residual-norm SpMVs per level per cycle
    R("forensics", int, 0,
      "enable convergence forensics (cycle anatomy + hierarchy probes)",
      _BOOL)
    # setup profiler (telemetry/setup_profile.py): per-level ×
    # per-component setup phase tree with compile/transfer/memory
    # attribution.  Off by default: the setup hot path then pays one
    # attribute check per marker and is otherwise byte-identical
    R("setup_profile", int, 0,
      "enable setup attribution (phase tree, compile/transfer split, "
      "HBM watermarks)", _BOOL)
    # HBM ledger (telemetry/memledger.py): device-memory ownership
    # attribution (registry + live-array census + backend memory_stats)
    # with hbm_snapshot sampling and oom_postmortem bundles.  Off by
    # default: registration sites then pay one attribute check and
    # solve traces are byte-identical (zero-overhead contract)
    R("memledger", int, 0,
      "enable the HBM ledger (device-memory ownership attribution, "
      "hbm_snapshot sampling, OOM post-mortems)", _BOOL)
    R("memledger_sample_s", float, 0.5,
      "min seconds between hbm_snapshot samples at phase boundaries "
      "(0 = sample at every boundary)")
    # device-side setup engine (amg/device_setup/ + ops/spgemm.py):
    # pattern-keyed Galerkin RAP executables — host-symbolic once,
    # device-numeric under jit with zero recompiles on resetup.  Host
    # scipy remains the fallback for every gated case (the engine emits
    # device_setup_fallback events with the reason)
    R("device_setup", int, 1,
      "route classical/aggregation Galerkin RAP through the device "
      "SpGEMM engine (0 = host scipy only)", _BOOL)
    R("device_setup_min_rows", int, 4096,
      "fine rows below which the host Galerkin is kept (tiny levels "
      "finish faster on host than a device dispatch)")
    R("device_setup_cache_mb", int, 256,
      "schedule-byte budget of the pattern-keyed setup-plan cache "
      "(LRU evicts past it; an over-budget single plan falls back)")
    # pod-scale distributed AMG (distributed/agglomerate.py): coarse
    # levels below the per-rank row threshold agglomerate onto a
    # shrinking sub-mesh (P -> P/factor -> ... -> 1) instead of paying
    # P-way collectives on a few hundred rows per chip — AmgX's
    # shrinking-communicator consolidation (amg.cu:328-390, glue.h)
    R("dist_agglomerate_min_rows", int, 0,
      "rows per ACTIVE rank below which a distributed coarse level "
      "agglomerates onto a smaller sub-mesh (0 disables; redistribution "
      "packs are cached and replayed across resetups)")
    R("dist_agglomerate_factor", int, 2,
      "sub-mesh shrink factor per agglomeration step "
      "(P -> P/factor -> ... -> 1)", None, (2, 1 << 16))
    # serving subsystem (amgx_tpu/serve/): request-level concurrency —
    # sessions with a pattern-keyed setup cache, micro-batched multi-RHS
    # solves, bounded-queue admission control
    R("serve_workers", int, 2,
      "solve worker threads of the serving pool")
    R("serve_queue_depth", int, 64,
      "admission queue capacity; a full queue rejects with RC.REJECTED")
    R("serve_batch_window_ms", float, 2.0,
      "micro-batch aggregation window (milliseconds)")
    R("serve_max_batch", int, 16,
      "max RHS stacked into one multi-RHS solve executable")
    R("serve_cache_bytes", int, 1 << 30,
      "setup-cache byte budget bounding resident hierarchies")
    R("serve_deadline_ms", float, 0.0,
      "default per-request deadline in ms; 0 disables deadlines")
    # multi-device scale-out (serve/router.py): per-device executor
    # lanes with pattern-affinity routing, hot-pattern replication and
    # cold-pattern work stealing.  serve_lanes=1 keeps the single-lane
    # service; queue_depth/workers knobs above apply PER LANE, the
    # cache byte budget is sliced evenly across lanes
    R("serve_lanes", int, 1,
      "executor lanes (one bounded queue + dispatcher + worker pool + "
      "setup-cache slice per lane, lane i pinned to visible device i); "
      "0 = one lane per visible device")
    R("serve_replicate_frac", float, 0.75,
      "home-lane queue fraction at which a hot pattern replicates onto "
      "an idle lane (its session is rebuilt there; the shared AOT/"
      "compile caches keep the replica's compile cost at zero)")
    R("serve_steal_frac", float, 0.5,
      "queue fraction under which a lane counts as idle (replication "
      "target) and over which a cold pattern's hash-home is skipped "
      "for the least-loaded lane (the work steal)")
    # zero cold-start (utils/jaxcompat.py + serve/aot.py): persistent
    # XLA compile cache + AOT executable store, so a fresh process
    # serves its first request without paying compilation.  Both knobs
    # are directories; empty keeps the import-time env defaults
    # (AMGX_TPU_COMPILE_CACHE / AMGX_TPU_AOT_STORE)
    R("compile_cache_dir", str, "",
      "persistent XLA compilation cache directory (disk-backs every "
      "jit; an explicit value overrides the env default)")
    R("aot_store_dir", str, "",
      "AOT executable store directory: solve bodies, multi-RHS batch "
      "buckets and spgemm setup plans are serialized/loaded here")
    R("serve_warmup_max_batch", int, 0,
      "warmup() prefetches batch buckets 1,2,4,.. up to this width "
      "(0: up to serve_max_batch)")
    # live serving observability (telemetry/httpd.py + telemetry/slo.py
    # + request-lifecycle tracing in serve/): everything off by default
    # and one attribute check when disabled
    R("metrics_port", int, 0,
      "serve /metrics /healthz /statusz /debug/* on 127.0.0.1:port "
      "while the service runs (0 disables; port 0 is rejected — use "
      "SolveService.start_endpoint(0) for an ephemeral port)")
    R("slo_window_s", float, 300.0,
      "sliding window (seconds) of the SLO request-outcome reservoir")
    R("slo_latency_ms", float, 0.0,
      "per-request latency objective in ms; 0 means attainment counts "
      "OK completion + deadline only")
    R("slo_target", float, 0.99,
      "SLO attainment objective; error budget = 1 - target, burn rate "
      "= (1 - attainment) / (1 - target)")
    R("serve_profile_every", int, 0,
      "fence + profile every Nth served batch, feeding measured device "
      "seconds into the cost model (achieved-vs-roofline per pattern; "
      "0 disables)")
    # breakdown-aware solving (errors.FailureKind + solvers/recovery.py
    # + utils/faultinject.py): early in-loop breakdown detection is
    # always on; the RECOVERY ladder and fault injection are opt-in
    R("recovery_policy", str, "NONE",
      "automatic recovery ladder for failed solves: AUTO walks "
      "restart -> promote precision -> conservative smoother -> full "
      "re-setup, each attempt telemetry-audited; NONE returns the "
      "failure to the caller", ("NONE", "AUTO"))
    R("recovery_max_attempts", int, 4,
      "ladder attempt budget per failed solve (executed rungs only; "
      "inapplicable rungs are audited as skipped and burn nothing)",
      None, (0, 16))
    R("fault_inject", str, "",
      "fault-injection plan (utils/faultinject.py): "
      "'point[:key:val]*' entries separated by spaces (e.g. "
      "'values_nan:iter:3:count:1 worker_death:count:2') over the "
      "named injection points (values_nan, krylov_zero, setup_error, "
      "upload_error, oom, worker_death, aot_corrupt, halo_exchange) "
      "with count/prob/seed/iter triggers; empty (default) disarms — "
      "zero overhead and a byte-identical solve trace")
    # serve hardening: per-request execution retries, the
    # poison-pill pattern quarantine, and the per-lane circuit breaker
    R("serve_retry_max", int, 0,
      "per-request execution retry budget: a batch whose prepare/solve "
      "RAISED re-queues its requests up to this many times each, "
      "deadline permitting (0 disables; convergence failures are "
      "deterministic and never retried)")
    R("serve_quarantine_threshold", int, 3,
      "consecutive error-outcome requests of one pattern after which "
      "the pattern is quarantined — rejected at admission with "
      "RC.REJECTED instead of re-running its failing setup forever "
      "(0 disables; SolveService.unquarantine() lifts it)")
    R("serve_breaker_threshold", int, 0,
      "consecutive failed batches after which one executor lane's "
      "circuit breaker opens and the router routes around it "
      "(0 disables)")
    R("serve_breaker_cooldown_s", float, 5.0,
      "seconds a tripped lane breaker stays open before traffic is "
      "routed back (half-open probe)")


register_default_parameters()

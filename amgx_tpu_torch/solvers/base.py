"""Solver framework (port of ``amgx_tpu/solvers/base.py``; reference
``base/include/solvers/solver.h:44-325``, ``solver.cu:380-970``).

* :class:`Solver` — parameters, convergence monitoring and the generic
  ``setup()`` / ``solve()`` / ``apply()`` entry points.
* :class:`SolverFactory` — the named registry; nested solvers are
  allocated from a config scope.

Execution model: the JAX package traces the whole solve into one
``lax.while_loop``; here the solve is an eager Python loop over device
tensors.  It synchronises with the host once per iteration, for the
convergence check (the solver's residual estimate is fetched as one
small array); everything between two checks is queued on the device
without a sync.  A solve whose tolerance lies below the device dtype's
floor runs the f32 → f64 defect-correction loop (:meth:`_solve_refined`).

The solve boundary of the top-level solver (``_toplevel``, set by
``create_solver``): the precision knobs ``krylov_dtype`` /
``tpu_matrix_dtype`` choose its pack dtype (:meth:`_apply_precision_knobs`),
equation ``scaling`` runs the solve on a scaled copy
(:mod:`.scalers`), ``matrix_reorder=RCM`` in permuted space
(:meth:`_maybe_reorder`).  ``fault_inject`` arms named failure points
(:mod:`..utils.faultinject`), and ``recovery_policy=AUTO`` walks the
recovery ladder (:mod:`.recovery`) after a failed solve.

A distributed matrix (``Matrix.set_distribution``) packs a sharded ELL
pack (:mod:`..distributed`): the solve shards b and the guess at its
entry and unshards x at its exit; the precision knobs, ``scaling`` and
``matrix_reorder`` are skipped there, as upstream, with a warning; and
the pack is structurally unrefinable.  Every solver name sets up on it
as in the JAX package (MULTICOLOR_ILU refuses it, as upstream).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Type

import numpy as np
import torch

from ..config import AMGConfig
from ..core.matrix import (DeviceMatrix, Matrix, binned_planes,
                           dia_arrays_block, ell_host_arrays, ell_layout)
from ..core import precision
from ..core.precision import (is_floating, promotion_target,
                              tolerance_floor)
from ..device import numpy_dtype, storage_dtype, torch_dtype
from ..errors import (BREAKDOWN_DIVERGENCE, BREAKDOWN_KRYLOV,
                      BREAKDOWN_NAN, RC, AMGXError, BadConfigurationError,
                      BadParametersError, FailureInfo, FailureKind,
                      NotImplementedError_, SolveStatus, breakdown_kind)
from ..ops import blas
from ..ops.binned_spmv import bn_block_dim, compact_pack
from ..ops.ell_spmv import ell_row_len
from ..ops.shift_spmv import shift_compact, shift_planes_like
from ..ops.spmv import spmv
from .. import telemetry
from ..utils import faultinject
from ..utils.logging import amgx_output, set_verbosity
from ..utils.profiler import cpu_profiler


def check_convergence(criterion: str, nrm, nrm_ini, nrm_max, tolerance,
                      alt_rel_tolerance) -> bool:
    """Has the solve converged?  Host numpy comparison, per component,
    in the dtype of the norms (the tolerances are cast to it)."""
    tol = nrm.dtype.type(tolerance)
    if criterion == "ABSOLUTE":
        ok = nrm <= tol
    elif criterion in ("RELATIVE_INI", "RELATIVE_INI_CORE"):
        ok = nrm <= tol * nrm_ini
    elif criterion in ("RELATIVE_MAX", "RELATIVE_MAX_CORE"):
        ok = nrm <= tol * nrm_max
    elif criterion == "COMBINED_REL_INI_ABS":
        ok = (nrm <= tol) | \
            (nrm <= nrm.dtype.type(alt_rel_tolerance) * nrm_ini)
    else:
        raise BadConfigurationError(f"unknown convergence {criterion!r}")
    return bool(np.all(ok))


def host_norm(v) -> np.ndarray:
    """A norm (0-d device tensor, or host value) as a 1-d numpy array in
    its own real dtype (a bf16 norm as f32, which numpy has) — the one
    device→host fetch of a check."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.is_complex():
            v = v.real
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.reshape(-1).cpu().numpy()
    return np.atleast_1d(np.asarray(v))


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    status: SolveStatus
    residual_norm: Optional[np.ndarray]
    residual_history: Optional[np.ndarray]
    setup_time: float = 0.0
    solve_time: float = 0.0
    failure: Optional[FailureInfo] = None
    #: the recovery ladder's audit (:mod:`.recovery`) when the solve was
    #: retried: {"kind", "action", "attempts", "outcome"} (each attempt
    #: in the solver's ``recovery_log``); None when no recovery ran
    recovery: Optional[dict] = None


# --------------------------------------------------------------------------
# Factory registry (reference SolverFactory, solver.h:287-325)
# --------------------------------------------------------------------------
_solver_registry: Dict[str, Type["Solver"]] = {}


def register_solver(name: str):
    def deco(cls):
        _solver_registry[name] = cls
        cls.config_name = name
        return cls
    return deco


class SolverFactory:
    @staticmethod
    def allocate(cfg: AMGConfig, scope: str, param_name: str) -> "Solver":
        """Allocate the solver named by ``param_name`` in ``scope``; it
        reads its own parameters from its new scope."""
        value, new_scope = cfg.get_scoped(param_name, scope)
        return SolverFactory.create(str(value), cfg, new_scope)

    @staticmethod
    def create(name: str, cfg: Optional[AMGConfig] = None,
               scope: str = "default") -> "Solver":
        if name not in _solver_registry:
            raise NotImplementedError_(
                f"solver {name!r} is not ported yet; ported: "
                f"{sorted(_solver_registry)}")
        return _solver_registry[name](cfg or AMGConfig(), scope)

    @staticmethod
    def registered() -> Dict[str, Type["Solver"]]:
        return dict(_solver_registry)


class Solver:
    """Base solver: parameters, the generic solve loop, and the
    preconditioner protocol (:meth:`apply`)."""

    config_name = "?"
    #: True for relaxation methods whose one iteration is one sweep
    is_smoother = False
    #: where the JAX package's setup or first application raises on a
    #: complex operator (the line that raises there): the port refuses
    #: the same name at setup, before any work
    complex_refused: Optional[str] = None

    def __init__(self, cfg: AMGConfig, scope: str = "default"):
        self.cfg = cfg
        self.scope = scope
        g = lambda name: cfg.get(name, scope)
        # the warm start (serve/aot.py): compile_cache_dir is where the
        # kernels build and are found (native.py), aot_store_dir keeps
        # the device setup engine's plans across processes; the
        # cumulative cache counters ride next to them
        cache_dir = str(g("compile_cache_dir"))
        if cache_dir:
            from .. import native
            native.set_build_dir(cache_dir)
        aot_dir = str(g("aot_store_dir"))
        if aot_dir:
            from ..serve import aot as _aot
            _aot.configure(aot_dir)
        if cache_dir or aot_dir:
            telemetry.runstate.configure_default(aot_dir or cache_dir)
        for name in ("krylov_dtype", "tpu_matrix_dtype"):
            precision.resolve_dtype(str(g(name)))   # a typo raises
        self.max_iters = int(g("max_iters"))
        self.tolerance = float(g("tolerance"))
        self.alt_rel_tolerance = float(g("alt_rel_tolerance"))
        self.convergence = str(g("convergence"))
        self.norm_type = str(g("norm"))
        self.use_scalar_norm = bool(g("use_scalar_norm"))
        self.monitor_residual = bool(g("monitor_residual"))
        self.store_res_history = bool(g("store_res_history"))
        self.print_solve_stats = bool(g("print_solve_stats"))
        self.obtain_timings = bool(g("obtain_timings"))
        self.relaxation_factor = float(g("relaxation_factor"))
        #: the reduction layout of CG/PCG and (F)GMRES: CLASSIC, CA or
        #: PIPELINED (``solvers/krylov.py``)
        self.krylov_comm = str(g("krylov_comm"))
        self.ca_residual_replace = int(g("ca_residual_replace"))
        # the reductions one iteration issues (the krylov_comm event)
        self._collective_ledger = blas.CollectiveLedger()
        # structured telemetry (amgx_tpu_torch/telemetry/): the knob
        # enables the process-wide recorder; keeping the residual
        # history is what gives the per-iteration residual records
        self.telemetry_path = str(g("telemetry_path"))
        if int(g("telemetry")):
            telemetry.enable(int(g("telemetry_ring_size")))
            self.store_res_history = True
        # convergence forensics (telemetry/forensics.py): the hierarchy
        # reads the same knob for the cycle anatomy; here it keeps the
        # history for the asymptotic-rate estimate
        self.forensics = bool(int(g("forensics")))
        if self.forensics:
            self.store_res_history = True
        # per-phase setup attribution (telemetry/setup_profile.py)
        if int(g("setup_profile")):
            telemetry.setup_profile.enable()
        # device-memory ownership and OOM post-mortems
        # (telemetry/memledger.py)
        if int(g("memledger")):
            telemetry.memledger.enable(
                sample_s=float(g("memledger_sample_s")))
        # the recovery ladder (recovery_policy=AUTO) and the
        # fault-injection plan (a non-empty spec arms it, once per spec)
        self.recovery_policy = str(g("recovery_policy"))
        self.recovery_max_attempts = int(g("recovery_max_attempts"))
        fi_spec = str(g("fault_inject"))
        if fi_spec:
            faultinject.configure_knob(fi_spec)
        # an EXPLICIT verbosity_level drives the level-gated output; the
        # registry default leaves a verbosity the application set alone
        if cfg.has("verbosity_level", scope):
            set_verbosity(int(g("verbosity_level")))
        self.A: Optional[Matrix] = None
        self.Ad: Optional[DeviceMatrix] = None
        self.scaler = None
        self._reorder = None
        self.setup_time = 0.0

    # ------------------------------------------------------------ lifecycle
    def setup(self, A: "Matrix | DeviceMatrix"):
        """Setup (reference ``Solver::setup``, solver.cu:380-556): a full
        rebuild, unless :meth:`resetup` called it.  A top-level solver
        first applies the precision knobs, the equation scaling (a scaled
        copy; the reference scales in place and unscales) and RCM.

        Telemetry: a ``setup``/``resetup`` span (nested solvers' spans
        nest in it), the top-level setup's profile scope
        (``setup_profile``), a device-memory post-mortem on an
        out-of-memory failure, and for the top-level setup its seconds,
        the operator's cost descriptor and the setup engine's stats."""
        phase = "resetup" if getattr(self, "_numeric_resetup", False) \
            else "setup"
        toplevel = bool(getattr(self, "_toplevel", False))
        t0 = time.perf_counter()
        _sp = telemetry.setup_profile
        prof = _sp.profile_setup(self.config_name) if toplevel \
            else _sp.null()
        try:
            with telemetry.span(phase, solver=self.config_name,
                                scope=self.scope, toplevel=toplevel), \
                    prof:
                self._setup_impl(A)
        except Exception as e:
            if telemetry.memledger.is_oom_error(e):
                telemetry.memledger.emit_postmortem(
                    e, "setup", in_recovery=bool(
                        getattr(self, "_in_recovery", False)))
            raise
        self.setup_time = time.perf_counter() - t0
        if toplevel:
            telemetry.memledger.maybe_sample(phase=phase)
        if toplevel and telemetry.is_enabled():
            self._emit_setup_telemetry(phase)
        return self

    def _emit_setup_telemetry(self, phase: str):
        telemetry.hist_observe(f"amgx_{phase}_seconds", self.setup_time)
        telemetry.gauge_set("amgx_last_setup_seconds", self.setup_time)
        if self.Ad is not None:
            telemetry.event(
                "operator_cost", solver=self.config_name,
                **telemetry.costmodel.spmv_cost(
                    self.Ad, nnz=self.A.nnz if self.A is not None
                    else None))
        from ..amg.device_setup import engine_stats
        st = engine_stats()
        if st is not None:
            telemetry.event("device_setup_cache", **st)
        if self.telemetry_path:
            telemetry.flush_jsonl(self.telemetry_path)

    def _setup_impl(self, A: "Matrix | DeviceMatrix"):
        # the matrix as the caller passed it: the ladder's rebuild rungs
        # set up from it (a scaled copy would be scaled twice)
        if self.recovery_policy not in ("", "NONE"):
            self._setup_input = A
        faultinject.maybe_raise(
            "setup_error", AMGXError("injected setup failure", RC.CORE))
        self.scaler = None
        self._reorder = None
        scaling = str(self.cfg.get("scaling", self.scope))
        if isinstance(A, Matrix) and A.dist is not None:
            # the solve boundary's knobs skip a distributed matrix
            # (``base.py:415-417`` and ``:528`` upstream)
            self._warn_skipped_on_distributed(scaling)
            scaling = "NONE"
        if isinstance(A, Matrix):
            top = getattr(self, "_toplevel", False) and A.dist is None
            if top:
                A = self._apply_precision_knobs(A)
            if scaling != "NONE" and A.block_dim == 1:
                from .scalers import create_scaler
                with cpu_profiler("setup_scaling"), \
                        telemetry.setup_profile.phase("scaling"):
                    self.scaler = create_scaler(scaling, self.cfg,
                                                self.scope)
                    csr = A.scalar_csr()
                    self.scaler.setup(csr)
                    dd = A.device_dtype
                    A = Matrix(self.scaler.scale_matrix(csr),
                               device=A.placement)
                    # the scaled copy keeps the precision knobs' pack
                    # dtype
                    A.device_dtype = dd
            if getattr(self, "_toplevel", False):
                # only the outermost solver has the permute boundary
                with telemetry.setup_profile.phase("reorder"):
                    if top:
                        A = self._maybe_reorder(A) or A
            self.A = A
            faultinject.maybe_raise(
                "upload_error", AMGXError("injected transfer/upload failure",
                                          RC.CUDA_FAILURE))
            faultinject.maybe_raise(
                "oom", AMGXError("injected device out-of-memory",
                                 RC.NO_MEMORY))
            with cpu_profiler("matrix_pack_device"), \
                    telemetry.setup_profile.phase("pack", kind="device"):
                self.Ad = A.device()
        else:
            self.A = None
            self.Ad = A
        ml = telemetry.memledger
        if ml.is_enabled() and getattr(self, "_toplevel", False) \
                and self.Ad is not None:
            # the top-level operator pack; the hierarchy's packs claim
            # their storages ahead of this owner
            ml.release(getattr(self, "_ml_matrix_tok", None))
            self._ml_matrix_tok = ml.register(
                ml.owner_name("matrix", self.config_name), self.Ad)
        if self.Ad.dtype.is_complex:
            self._check_complex()
        with cpu_profiler(f"setup:{self.config_name}"):
            self.solver_setup()
        # a bf16 view's wide pack served this setup; drop it
        precision.release_setup_wide(self.A)
        # new matrix values, also on a resetup (a new rounding residue):
        # a later refined solve rebuilds its operator
        self.__dict__.pop("_wide", None)
        if self.Ad.device.type == "cuda":
            torch.cuda.synchronize(self.Ad.device)

    def release_memledger(self):
        """Drop this solver's device-memory ledger registrations: the
        operator pack and, down the preconditioner chain, each AMG
        hierarchy's entries."""
        ml = telemetry.memledger
        for name in ("_ml_matrix_tok", "_ml_wide_tok"):
            ml.release(getattr(self, name, None))
            setattr(self, name, None)
        obj, seen = self, set()
        while obj is not None and id(obj) not in seen:
            seen.add(id(obj))
            h = getattr(obj, "hierarchy", None)
            if h is not None and hasattr(h, "release_memledger"):
                h.release_memledger()
            for tok in getattr(obj, "_ml_graph_toks", ()):
                ml.release(tok)
            obj._ml_graph_toks = []
            obj = getattr(obj, "preconditioner", None)

    def _warn_skipped_on_distributed(self, scaling: str) -> None:
        """Name the solve-boundary knobs a distributed matrix skips."""
        g = lambda name: str(self.cfg.get(name, self.scope))
        skipped = [f"scaling={scaling}"] if scaling != "NONE" else []
        if getattr(self, "_toplevel", False):
            skipped += [f"{k}={g(k)}" for k in ("krylov_dtype",
                                                "tpu_matrix_dtype")
                        if precision.resolve_dtype(g(k)) is not None]
            if g("matrix_reorder") == "RCM":
                skipped.append("matrix_reorder=RCM")
        if skipped:
            amgx_output("WARNING: " + ", ".join(skipped) + " skipped on a "
                        "distributed matrix.\n")

    def _apply_precision_knobs(self, A: Matrix) -> Matrix:
        """``krylov_dtype`` (else ``tpu_matrix_dtype``): the top-level
        solver's pack dtype, which is the Krylov loop's vector, dot and
        monitoring precision (``amgx_tpu/solvers/base.py:359-398``).
        Nested solvers take theirs from the hierarchy policy.  Returns a
        shallow view when the knob applies (the caller's matrix is never
        changed): a narrowing casts an existing pack on the device
        (:func:`~..core.precision.precision_view`, no bytes over the
        wire), a widening rebuilds from the wide host values."""
        kd = precision.resolve_dtype(
            str(self.cfg.get("krylov_dtype", self.scope)))
        if kd is None:
            kd = precision.resolve_dtype(
                str(self.cfg.get("tpu_matrix_dtype", self.scope)))
        if kd is None:
            return A
        cur = storage_dtype(A.device_dtype or A.dtype)
        if cur == kd:
            return A
        dev = A._device
        if dev is not None and kd.itemsize > dev.dtype.itemsize:
            # an on-device upcast would keep the narrow digits
            import copy
            m = copy.copy(A)
            m.device_dtype = kd
            m._device = None
            m._device_dtype = None
            m._dinv_dev = None
            return m
        return precision.precision_view(A, kd)

    def _maybe_reorder(self, A: Matrix) -> Optional[Matrix]:
        """``matrix_reorder=RCM``: reverse Cuthill–McKee once at setup;
        the solve then runs in permuted space and the rhs, guess and
        solution are permuted at the boundary (``_maybe_reorder``
        upstream, ``amgx_tpu/solvers/base.py:511-561``).  Returns the
        permuted matrix, or None to keep ``A``."""
        mode = str(self.cfg.get("matrix_reorder", self.scope))
        if mode != "RCM":
            # AUTO reorders only on a TPU or under the JAX package's
            # Pallas interpreter, to bring a scattered matrix inside its
            # windowed kernel's budget; on the card kernels B3/B4 gather
            # x directly, so AUTO stays a no-op here, as it is in the JAX
            # package on a CPU or GPU
            return None
        if A.block_dim != 1 or A.shape[0] != A.shape[1] or \
                (A._host is None and A._dia is None
                 and A._dia_thunk is None):
            return None
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        csr = A.scalar_csr()
        perm = np.asarray(reverse_cuthill_mckee(csr, symmetric_mode=False),
                          dtype=np.int64)
        Ap = Matrix(csr[perm][:, perm].tocsr(), device=A.placement)
        Ap.device_dtype = A.device_dtype
        self._reorder = (perm, np.argsort(perm))
        return Ap

    def resetup(self, A: "Matrix | DeviceMatrix"):
        """Numeric refresh after ``Matrix.replace_coefficients``: the same
        structure, new values (``AMGX_solver_resetup``).  Nested
        preconditioner instances, the AMG hierarchy's coarsening
        structure (with ``structure_reuse_levels`` ≠ 0) and the AMG's
        CUDA graphs (where every tensor they read keeps its shape, dtype
        and device, :mod:`._bind`) survive; :meth:`setup` stays a full
        rebuild.  A distributed matrix's resetup is a fresh setup (as
        upstream: no structure reuse there), its graphs captured anew."""
        self._numeric_resetup = True
        try:
            return self.setup(A)
        finally:
            self._numeric_resetup = False

    def solver_setup(self):
        """Override: build device-side data (diag inverse, hierarchy, ...)."""

    def _check_complex(self):
        """Refuse a complex operator where the JAX package does
        (:attr:`complex_refused`); every other name runs on it."""
        if self.complex_refused is not None:
            raise NotImplementedError_(
                f"{self.config_name} on a complex operator: the reference "
                f"JAX package does not run it ({self.complex_refused})")

    # -------------------------------------------------------- the protocol
    def solve_init(self, b: torch.Tensor, x: torch.Tensor):
        """Return the solver-specific iteration state."""
        return ()

    def solve_iteration(self, b: torch.Tensor, x: torch.Tensor, state,
                        iter_idx: int):
        """One iteration: return (x_new, state_new).  ``iter_idx`` is the
        host iteration counter."""
        raise NotImplementedError

    def residual_norm_estimate(self, b, x, state):
        """Solvers with an implicit residual estimate (FGMRES
        quasi-residual) override this to save an SpMV per iteration."""
        return None

    def solve_finalize(self, b, x, state):
        return x

    def apply(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
              n_iters: Optional[int] = None) -> torch.Tensor:
        """Application as a preconditioner/smoother: a fixed number of
        iterations, no monitoring, no host sync."""
        n = self.max_iters if n_iters is None else n_iters
        x = torch.zeros_like(b) if x0 is None else x0
        # a smoother's application carries the amgx/smoother/<name>
        # scope (telemetry/scopes.py; a no-op context with telemetry off)
        with telemetry.scopes.scope("smoother", self.config_name) \
                if self.is_smoother else telemetry.scopes._NULL:
            state = self.solve_init(b, x)
            for i in range(n):
                x, state = self.solve_iteration(b, x, state, i)
        return x

    def norm(self, v):
        """The configured convergence norm of ``v``: per block component
        for a block operator unless ``use_scalar_norm`` is set."""
        return blas.norm(v, self.norm_type, self.Ad.block_dim,
                         self.use_scalar_norm)

    def compute_residual_norm(self, b, x):
        return self.norm(b - spmv(self.Ad, x))

    def breakdown_code(self, state) -> Optional[torch.Tensor]:
        """The int32 breakdown code (``errors.BREAKDOWN_*``, 0 = healthy)
        a solver's iteration state carries, or None for solvers without
        in-loop guards."""
        return getattr(state, "brk", None)

    # ------------------------------------------------ tolerance and ladder
    def _promotion_plan(self):
        """(refine_active, wide_dtype, structural_block) for the current
        tolerance (``base.py:645-701`` upstream).  The recovery ladder's
        ``promote`` rung forces a promotion (``_force_promotion``) even
        above the floor; a scaled solve is structurally unrefinable."""
        dtype = self.Ad.dtype
        forced = bool(getattr(self, "_force_promotion", False))
        if not (self.monitor_residual
                and (forced or self.tolerance < tolerance_floor(dtype))):
            return False, None, False
        if self.tolerance <= 0 or self.scaler is not None or \
                self.Ad.fmt == "sharded-ell" or \
                self.A is None or not is_floating(dtype):
            return False, None, True
        host_dt = np.dtype(self.A.dtype)
        if host_dt.itemsize <= dtype.itemsize:
            return False, None, False
        wide = promotion_target(dtype, host_dt, self.tolerance)
        if wide is None and forced:
            # the tolerance asked for no rung: take the next one up,
            # within the host dtype and one residue plane
            for rung in precision.LADDER:
                if dtype.itemsize < rung.itemsize <= host_dt.itemsize \
                        and rung.itemsize <= 2 * dtype.itemsize:
                    wide = rung
                    break
        if wide is None:
            return False, None, False
        return True, np.dtype(wide), False

    def _check_tolerance_floor(self, refine: bool, structural: bool):
        """A below-floor tolerance without a promotion rung is a
        configuration error (``base.py:703-731`` upstream); structurally
        unrefinable solves warn and run."""
        dtype = self.Ad.dtype
        floor = tolerance_floor(dtype)
        if refine or not self.monitor_residual or self.tolerance >= floor:
            return
        if structural:
            name = str(dtype).replace("torch.", "")
            amgx_output(
                f"WARNING: tolerance {self.tolerance:g} is below the "
                f"{name} precision floor (~{floor:.1g});"
                " convergence to it cannot be honestly declared.\n")
            return
        raise BadParametersError(
            f"tolerance {self.tolerance:g} is below the {dtype} precision "
            f"floor (~{floor:.1g}) and no promotion rung is available: "
            "upload the matrix at a wider dtype (f64 host + narrow device "
            "pack enables the defect-correction ladder) or raise the "
            "tolerance")

    # ------------------------------------------------------------- solve API
    def solve(self, b, x0=None, zero_initial_guess: bool = False
              ) -> SolveResult:
        """Full solve with convergence monitoring; the reported norm is a
        freshly computed true residual (of the scaled system when
        ``scaling`` is set, as upstream)."""
        if self.Ad is None:
            raise BadConfigurationError("solve() before setup()")
        dtype, dev = self.Ad.dtype, self.Ad.device
        # the caller's own rhs and guess: the recovery ladder re-enters
        # solve() with them
        b_caller, x0_caller = b, x0
        fault = faultinject.trace_mode()
        if self.scaler is not None:
            # the rhs at the pack dtype, times the f64 factors (the JAX
            # package's host order: cast, then scale)
            b = self.scaler.scale_rhs(_as_device(b, dtype, dev))
            if x0 is not None and not zero_initial_guess:
                x0 = self.scaler.scale_initial_guess(
                    _as_device(x0, dtype, dev))
        if self._reorder is not None:
            # the pack lives in RCM space: permute after scaling on the
            # way in, un-permute before unscaling on the way out; norms
            # do not see the permutation
            b = _permuted(b, self._reorder[0], dev)
            if x0 is not None and not zero_initial_guess:
                x0 = _permuted(x0, self._reorder[0], dev)
        refine, wide, structural = self._promotion_plan()
        self._check_tolerance_floor(refine, structural)
        x0 = None if zero_initial_guess else x0
        dist = self.Ad.fmt == "sharded-ell"
        if dist:
            # padded, rank-major, on the pack's device (the
            # ``halo_exchange`` fault seam)
            from ..distributed.matrix import shard_vector
            b = shard_vector(self.Ad, b)
            if x0 is not None:
                x0 = shard_vector(self.Ad, x0)
        t0 = time.perf_counter()
        try:
            with telemetry.span("solve", solver=self.config_name,
                                scope=self.scope, refined=bool(refine)), \
                    cpu_profiler(f"solve:{self.config_name}"):
                if refine:
                    x, iters, nrm, nrm_ini, history, fail = \
                        self._solve_refined(b, x0, wide, fault)
                else:
                    b = _as_device(b, dtype, dev)
                    x0 = torch.zeros_like(b) if x0 is None \
                        else _as_device(x0, dtype, dev)
                    x, iters, nrm, nrm_ini, history, fail = \
                        self._solve_loop(b, x0, self.tolerance,
                                         self.max_iters, fault=fault)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                if telemetry.is_enabled():
                    # the cycle anatomy the graphs wrote on the device,
                    # read once (telemetry/forensics.py Tape)
                    _emit_forensics(self)
        except Exception as e:
            # a device OOM mid-solve: the ledger post-mortem is the only
            # record of what was resident when the allocator gave up
            if telemetry.memledger.is_oom_error(e):
                telemetry.memledger.emit_postmortem(
                    e, "solve", in_recovery=bool(
                        getattr(self, "_in_recovery", False)))
            raise
        brk_code, first_bad = fail
        solve_time = time.perf_counter() - t0
        telemetry.memledger.maybe_sample(phase="solve")
        # an injection is recorded only when it provoked something
        if fault is not None and (bool(brk_code) if self.monitor_residual
                                  else iters > fault[1]):
            faultinject.fired(fault[0], iteration=fault[1])
        if dist:
            from ..distributed.matrix import unshard_vector
            x = unshard_vector(self.Ad, x)
        if self._reorder is not None:
            x = _permuted(x, self._reorder[1], dev)
        if self.scaler is not None:
            x = self.scaler.unscale_solution(x)

        nrm = np.atleast_1d(np.asarray(nrm, dtype=np.float64))
        nrm_ini = np.atleast_1d(np.asarray(nrm_ini, dtype=np.float64))
        failure = None
        if self.monitor_residual:
            nrm_max = nrm_ini
            if self.convergence in ("RELATIVE_MAX", "RELATIVE_MAX_CORE") \
                    and history is not None:
                h = np.atleast_2d(history)[:iters + 1]
                h = self._finite_history(h, context="nrm_max")
                if h.size:
                    nrm_max = np.maximum(nrm_ini, h.max(axis=0))
            conv = check_convergence(self.convergence, nrm, nrm_ini, nrm_max,
                                     self.tolerance, self.alt_rel_tolerance)
            diverged = bool(np.any(~np.isfinite(nrm)))
            # a breakdown code with a finite residual reports FAILED: the
            # guard, not the iteration budget, cut the loop
            status = (SolveStatus.SUCCESS if conv else
                      (SolveStatus.DIVERGED if diverged else
                       (SolveStatus.FAILED if brk_code
                        else SolveStatus.NOT_CONVERGED)))
            failure = _classify_failure(conv, diverged, brk_code,
                                        first_bad, nrm, iters)
        else:
            status = SolveStatus.SUCCESS
        keep = self.store_res_history or self.print_solve_stats
        history = history[:iters + 1] if keep else None
        if self.print_solve_stats:
            _print_solve_stats(history, iters)
        if self.obtain_timings:
            # host-clock seconds, each phase ended by a device sync
            amgx_output(f"Total Time: {self.setup_time + solve_time:10.6f}\n"
                        f"    setup: {self.setup_time:10.6f} s\n"
                        f"    solve: {solve_time:10.6f} s\n"
                        f"    solve(per iteration): "
                        f"{solve_time / max(iters, 1):10.6f} s\n")
        if telemetry.is_enabled():
            self._emit_solve_telemetry(iters, nrm, nrm_ini, status,
                                       history, solve_time,
                                       failure=failure)
        res = SolveResult(x=x, iterations=iters, status=status,
                          residual_norm=nrm, residual_history=history,
                          setup_time=self.setup_time,
                          solve_time=solve_time, failure=failure)
        if status != SolveStatus.SUCCESS \
                and self.recovery_policy not in ("", "NONE") \
                and self.monitor_residual \
                and not getattr(self, "_in_recovery", False) \
                and not getattr(self, "_suppress_recovery", False):
            # bounded escalation; the ladder re-enters solve() with
            # _in_recovery set, so it never recurses into itself
            from .recovery import maybe_recover
            res = maybe_recover(self, b_caller, x0_caller,
                                zero_initial_guess, res)
        return res

    def solve_multi(self, B, X0=None, zero_initial_guess: bool = False,
                    pad_to_bucket: bool = False) -> "list[SolveResult]":
        """k right-hand sides against one operator (``solve_multi``
        upstream, ``amgx_tpu/solvers/base.py:1174-1425``): ``B`` is (k, n)
        or a sequence of k vectors, ``X0`` likewise (or None); returns one
        :class:`SolveResult` per right-hand side, each with its own count,
        status and true final residual.

        Every batch runs its lanes in order through :meth:`solve`, the
        branch the JAX package takes for the f32 → f64 refinement rung
        (this port's main configuration), so each lane's ``x`` is the
        bits of a single solve of its right-hand side.  The recovery
        ladder is off for the batch, as upstream's sequential branch has
        it.  ``pad_to_bucket`` (the serving micro-batcher's power-of-two
        padding) adds only zero lanes, which converge at iteration 0 and
        are never returned: the sequential batch runs none of them."""
        if self.Ad is None:
            raise BadConfigurationError("solve_multi() before setup()")
        if (torch.is_tensor(B) or isinstance(B, np.ndarray)) and B.ndim == 2:
            B = [B[i] for i in range(B.shape[0])]
        else:
            B = list(B)
        suppress = not getattr(self, "_suppress_recovery", False)
        if suppress:
            self._suppress_recovery = True
        try:
            with telemetry.span("solve_multi", solver=self.config_name,
                                scope=self.scope, k=len(B)), \
                    cpu_profiler(f"solve_multi:{self.config_name}"):
                return [self.solve(bj, x0=None if X0 is None else X0[j],
                                   zero_initial_guess=zero_initial_guess)
                        for j, bj in enumerate(B)]
        finally:
            if suppress:
                self._suppress_recovery = False

    def _finite_history(self, h: np.ndarray,
                        context: str = "") -> np.ndarray:
        """The finite rows of a residual-history slab; a dropped row is
        said (``history_truncated``), not silently filtered."""
        if h.size == 0:
            return h
        mask = np.isfinite(h).all(axis=1)
        if mask.all():
            return h
        if telemetry.is_enabled():
            telemetry.counter_inc("amgx_history_truncated_total")
            telemetry.event("history_truncated",
                            first_bad_iteration=int(np.argmin(mask)),
                            dropped=int((~mask).sum()), context=context,
                            solver=self.config_name)
        return h[mask]

    def _emit_solve_telemetry(self, iters, nrm, nrm_ini, status,
                              history, solve_time, failure=None):
        """Per-solve telemetry (``_emit_solve_telemetry`` upstream):
        duration, iteration count, final relative residual,
        convergence-rate estimate, divergence and breakdown events and
        the per-iteration residual trajectory (iteration 0 = the initial
        residual)."""
        telemetry.hist_observe("amgx_solve_seconds", solve_time)
        telemetry.gauge_set("amgx_last_solve_seconds", solve_time)
        telemetry.gauge_set("amgx_solve_iterations", iters)
        diverged = bool(np.any(~np.isfinite(np.asarray(nrm))))
        label = ("SUCCESS" if status == SolveStatus.SUCCESS else
                 ("DIVERGED" if diverged else "NOT_CONVERGED"))
        telemetry.counter_inc("amgx_solves_total", status=label)
        if self.monitor_residual:
            nrm_m = float(np.max(nrm))
            ini_m = float(np.max(nrm_ini))
            relres = nrm_m / ini_m if ini_m > 0 else nrm_m
            telemetry.gauge_set("amgx_solve_final_relres", relres)
            if iters > 0 and np.isfinite(relres) and relres > 0:
                telemetry.gauge_set("amgx_solve_convergence_rate",
                                    relres ** (1.0 / iters))
            if self.forensics and history is not None:
                rate = telemetry.forensics.asymptotic_rate(
                    [float(np.max(row))
                     for row in np.atleast_2d(history)])
                if rate is not None:
                    telemetry.gauge_set(
                        "amgx_forensics_asymptotic_rate", rate)
                    telemetry.event("solve_forensics",
                                    solver=self.config_name,
                                    iterations=iters,
                                    asymptotic_rate=rate)
            if diverged:
                telemetry.counter_inc("amgx_solve_diverged_total")
                telemetry.event("divergence", solver=self.config_name,
                                iteration=iters, norm=nrm_m)
            if failure is not None:
                telemetry.counter_inc("amgx_solve_failures_total",
                                      kind=failure.kind.value)
                telemetry.event("breakdown", solver=self.config_name,
                                kind=failure.kind.value,
                                iteration=failure.iteration)
            if history is not None:
                for i, row in enumerate(np.atleast_2d(history)):
                    telemetry.event("residual", iteration=i,
                                    norm=float(np.max(row)))
        self._emit_krylov_comm_telemetry(iters)
        if self.telemetry_path:
            telemetry.flush_jsonl(self.telemetry_path)

    def _emit_krylov_comm_telemetry(self, iters: int):
        """The reductions of one iteration (counted while the first ran,
        :class:`~..ops.blas.CollectiveLedger`) times the iterations run;
        silent when no iteration was counted."""
        led = self._collective_ledger
        if not led.counts:
            return
        prof = {op: int(c) for op, c in led.counts.items()}
        iters = max(int(iters), 0)
        if iters > 0:
            for op, c in prof.items():
                telemetry.counter_inc("amgx_krylov_collectives_total",
                                      float(c * iters), op=op)
        mode = (self._comm_mode() if hasattr(self, "_comm_mode")
                else "CLASSIC")
        # one card: a sharded pack's reductions are no collectives, so
        # no reduction latency is modelled beside the counts
        telemetry.event("krylov_comm", solver=self.config_name, mode=mode,
                        iterations=iters, per_iter=prof,
                        collectives_per_iter=int(sum(prof.values())),
                        fused=bool("fused" in prof),
                        n_parts=int(getattr(self.Ad, "n_parts", 1) or 1))

    def _solve_loop(self, b, x0, tolerance, it_limit,
                    final_residual: bool = True, fault=None):
        """The monitored iteration loop (``_build_solve_fn`` upstream):
        returns ``(x, iterations, nrm, nrm_ini, history, fail)``: norms
        are host numpy arrays in the solve dtype (one entry, or one per
        block component), ``history`` stacks the monitored norms, ``fail``
        is ``(breakdown code, first bad iteration)`` — ``(0, -1)`` for a
        healthy loop.  A solver's breakdown code is fetched with the
        norm, in the iteration's one host sync.  ``fault`` — an armed
        ``(mode, iteration)`` of :func:`~..utils.faultinject.trace_mode` —
        poisons the Krylov state right after that iteration
        (:func:`_inject_fault`)."""
        monitor = self.monitor_residual
        crit, alt = self.convergence, self.alt_rel_tolerance
        nrm_ini = host_norm(self.norm(b - spmv(self.Ad, x0)))
        state = self.solve_init(b, x0)
        hist = [nrm_ini]
        nrm = nmax = nrm_ini
        done = monitor and check_convergence(crit, nrm_ini, nrm_ini,
                                             nrm_ini, tolerance, alt)
        x, it, brk, bad_it = x0, 0, 0, -1
        limit = min(int(it_limit), self.max_iters)
        ledger = self._collective_ledger if (
            it == 0 and telemetry.is_enabled()) else None
        while not done and it < limit:
            if ledger is not None:
                # the first iteration's reductions: the per-iteration
                # profile of the krylov_comm event
                ledger.reset()
                with blas.count_collectives(ledger):
                    x, state = self.solve_iteration(b, x, state, it)
            else:
                x, state = self.solve_iteration(b, x, state, it)
            if fault is not None and it == fault[1]:
                x, state = _inject_fault(fault[0], x, state)
            if monitor:
                with blas.count_collectives(ledger) \
                        if ledger is not None else telemetry.scopes._NULL:
                    est = self.residual_norm_estimate(b, x, state)
                    if est is None:
                        est = self.compute_residual_norm(b, x)
                ledger = None
                code_t = self.breakdown_code(state)
                if code_t is None:
                    nrm, code = host_norm(est), 0
                else:
                    est = torch.as_tensor(est, device=code_t.device)
                    got = host_norm(torch.cat([
                        est.reshape(-1).to(torch.float64),
                        code_t.reshape(1).to(torch.float64)]))
                    nrm = got[:-1].astype(hist[0].dtype)
                    code = int(got[-1])
                # a Krylov breakdown is provisional: it sticks only while
                # the monitored residual is alive
                if code == BREAKDOWN_KRYLOV and not np.any(nrm > 0):
                    code = 0
                if brk == 0 and code != 0:
                    brk, bad_it = code, it + 1
                nmax = np.maximum(nmax, nrm)
                done = check_convergence(crit, nrm, nrm_ini, nmax,
                                         tolerance, alt)
                if brk == 0 and not np.all(np.isfinite(nrm)):
                    brk = BREAKDOWN_NAN if np.any(np.isnan(nrm)) \
                        else BREAKDOWN_DIVERGENCE
                    bad_it = it + 1
                done = done or brk != 0
            hist.append(nrm)
            it += 1
        x = self.solve_finalize(b, x, state)
        if monitor and final_residual:
            nrm = host_norm(self.compute_residual_norm(b, x))
        return x, it, nrm, nrm_ini, np.stack(hist), (brk, bad_it)

    # -------------------------------------------------- defect correction
    def _wide_pack(self, wide) -> DeviceMatrix:
        """The wide device pack of the exact host operator
        (``base.py:1617-1710`` upstream), built at the first refined
        solve after a setup and kept until the next.  Values exactly
        representable in the pack dtype widen on the device.  Otherwise
        a binned pack takes planes packed from the host values in
        ``wide`` (its lanes depend on the pattern alone), a shift pack
        the host values placed on its own class slots
        (:func:`~..ops.shift_spmv.shift_planes_like`, which raises if a
        value the narrow pack dropped as 0 has no slot) and the compact
        pack of those planes, and the other
        packs take their ``vals`` rebuilt on the host in ``wide``
        (:meth:`_host_pack_vals64`).  A binned or shift
        pack keeps only its planes: the wide SpMV runs B4/B5 or B2 on
        them and never reads the gather-form arrays.  No host copy
        outlives the upload."""
        cached = self.__dict__.get("_wide")
        if cached is not None and cached[0] == wide:
            return cached[1]
        wdt = torch_dtype(wide)
        Ad = self.Ad
        pdt = storage_dtype(Ad.dtype)
        binned = Ad.bn_codes is not None
        shift = Ad.sh_vals is not None
        if binned or shift:
            Ad = dataclasses.replace(Ad, vals=None, cols=None,
                                     row_ids=None, row_len=None)
        if pdt == np.float32 and getattr(self.A, "_vals_f32_exact", False):
            exact = True
        else:
            if shift:
                cols, host, _ = ell_host_arrays(self.A.host, np.float64)
            else:
                host = np.asarray(self.A.host.data) if binned \
                    else self._host_pack_vals64()
            # a pack cast from a wider pack holds dtype(via(v))
            exact = _representable(host, pdt,
                                   getattr(self.A, "_pack_cast_via", None))
        if exact:
            Ad64 = Ad.astype(wdt)
        elif shift:
            planes = torch.from_numpy(shift_planes_like(
                cols, host, Ad.sh_dims, Ad.sh_diffs.cpu().numpy())).to(
                    Ad.device)
            Ad64 = dataclasses.replace(
                dataclasses.replace(Ad, sh_vals=None,
                                    sh_compact=None).astype(wdt),
                sh_vals=planes,
                sh_compact=shift_compact(planes, Ad.sh_dims))
        elif binned:
            native = bn_block_dim(Ad.bn_dims) > 1
            arrays, dims = binned_planes(self.A.host, Ad.block_dim, wide,
                                         native)
            assert tuple(dims) == tuple(Ad.bn_dims)
            bn_vals = torch.from_numpy(arrays["bn_vals"]).to(Ad.device)
            Ad64 = dataclasses.replace(
                dataclasses.replace(Ad, bn_vals=None,
                                    bn_compact=None).astype(wdt),
                bn_vals=bn_vals, bn_compact=compact_pack(
                    Ad.bn_codes, bn_vals, Ad.bn_meta, Ad.bn_dims))
        else:
            # the narrow pack's strides: block-DIA keeps each component
            # plane contiguous
            vals64 = torch.empty_strided(
                Ad.vals.shape, Ad.vals.stride(), dtype=wdt,
                device=Ad.device).copy_(torch.from_numpy(host))
            Ad64 = dataclasses.replace(
                dataclasses.replace(Ad, vals=None).astype(wdt),
                vals=vals64, row_len=None if Ad.row_len is None
                else ell_row_len(vals64))
        self._wide = (wide, Ad64)
        ml = telemetry.memledger
        if ml.is_enabled():
            # the refinement's wide operator, beside the narrow pack
            ml.release(getattr(self, "_ml_wide_tok", None))
            self._ml_wide_tok = ml.register(ml.owner_name(
                "matrix", f"{self.config_name}_wide"), Ad64)
        return Ad64

    def _host_pack_vals64(self) -> np.ndarray:
        """The device pack's ``vals`` layout rebuilt on the host in f64
        (mirrors :func:`~amgx_tpu_torch.core.matrix.pack_host_arrays`)."""
        Ad = self.Ad
        if Ad.fmt == "dia" and Ad.block_dim > 1:
            offs, vals = dia_arrays_block(self.A.host)
            assert tuple(offs) == tuple(Ad.dia_offsets)
            return vals.astype(np.float64, copy=False)
        if Ad.fmt == "dia":
            offs, vals = self.A.dia_cache()
            assert tuple(offs) == tuple(Ad.dia_offsets)
            return vals.astype(np.float64, copy=False)
        if Ad.block_dim == 1 and Ad.fmt == "ell":
            return ell_host_arrays(self.A.host, np.float64)[1]
        host = self.A.host
        if Ad.fmt == "dense":
            return host.toarray().astype(np.float64)
        if Ad.fmt == "csr":
            return np.asarray(host.data, dtype=np.float64)
        for_rows, pos, k = ell_layout(host.indptr, host.indices)
        b = Ad.block_dim
        out = np.zeros((Ad.n_rows, k, b, b), dtype=np.float64)
        out[for_rows, pos] = host.data
        return out

    def _solve_refined(self, b, x0, wide, fault=None):
        """Mixed-precision iterative refinement (``base.py:1755-1899``
        upstream): inner solves at the pack dtype to
        ``max(tol, 2·floor)``, true residuals recomputed at ``wide``; one
        host check per outer pass.  ``b``/``x0`` arrive in the caller's
        precision and are split into pack-dtype hi + residue lo."""
        Ad, dtype, dev = self.Ad, self.Ad.dtype, self.Ad.device
        wdt = torch_dtype(wide)
        lo_dt = torch.float32 if dtype.itemsize < 4 else dtype

        def split(v):
            if isinstance(v, torch.Tensor) and v.dtype == dtype:
                return v.to(dev), None
            # on the pack's device: a vector already there never goes
            # through the host (the C API keeps its vectors on the card)
            v64 = v.detach().to(dev, torch.float64).reshape(-1) \
                if isinstance(v, torch.Tensor) else torch.from_numpy(
                    np.ascontiguousarray(np.asarray(v).astype(np.float64)
                                         .ravel())).to(dev)
            hi = v64.to(dtype)
            lo = v64 - hi.double()
            return hi, lo.to(lo_dt) if bool(torch.any(lo != 0)) else None

        def widen(hi, lo):
            w = hi.to(wdt)
            return w if lo is None else w + lo.to(wdt)

        crit, alt = self.convergence, self.alt_rel_tolerance
        inner_tol = max(self.tolerance, 2.0 * tolerance_floor(dtype))
        if 0.0 < inner_tol < 1.0:
            need = math.log(max(self.tolerance, 1e-300)) / math.log(inner_tol)
            max_outer = int(min(64, max(8, math.ceil(need) + 4)))
        else:
            max_outer = 8
        tiny = float(torch.finfo(wdt).tiny)
        keep_history = self.store_res_history or self.print_solve_stats
        hist_dt = numpy_dtype(lo_dt)

        Ad64 = self._wide_pack(wide)
        b64 = widen(*split(b))
        x64 = torch.zeros_like(b64) if x0 is None else widen(*split(x0))
        r64 = b64 - spmv(Ad64, x64)
        nrm_ini = host_norm(self.norm(r64))
        m = nrm_ini.shape[0]
        hist = np.zeros((self.max_iters + 1, m), hist_dt)
        hist[0] = nrm_ini.astype(hist_dt)
        nrm = nrm_ini
        done = check_convergence(crit, nrm_ini, nrm_ini, nrm_ini,
                                 self.tolerance, alt)
        it_tot, k, fail = 0, 0, (0, -1)
        while not done and it_tot < self.max_iters and k < max_outer:
            scale = torch.clamp(torch.max(torch.abs(r64)), min=tiny)
            rb = (r64 / scale).to(dtype)
            dx, it, _, _, h_in, f_in = self._solve_loop(
                rb, torch.zeros_like(rb), inner_tol,
                self.max_iters - it_tot, final_residual=False, fault=fault)
            # the first inner breakdown wins, re-based onto the global
            # iteration count
            if fail[0] == 0 and f_in[0] != 0:
                fail = (f_in[0], it_tot + f_in[1])
            x64 = x64 + scale * dx.to(wdt)
            r64 = b64 - spmv(Ad64, x64)
            nrm_t = self.norm(r64)
            if keep_history:
                fetched = host_norm(torch.cat([nrm_t.reshape(-1),
                                               scale.reshape(1)]))
                nrm = fetched[:-1]
                rows = h_in[1:it + 1].astype(hist_dt) * hist_dt.type(
                    fetched[-1])
                hist[it_tot + 1:it_tot + it + 1] = rows.reshape(-1, m)
            else:
                nrm = host_norm(nrm_t)
            done = check_convergence(crit, nrm, nrm_ini, nrm_ini,
                                     self.tolerance, alt) \
                or not np.all(np.isfinite(nrm)) or fail[0] != 0
            it_tot += it
            k += 1
        return x64, it_tot, nrm, nrm_ini, hist, fail


def _emit_forensics(solver) -> None:
    """Emit the cycle anatomy of every AMG application of the solve (the
    tapes of the AMG solvers down the preconditioner chain)."""
    obj, seen = solver, set()
    while obj is not None and id(obj) not in seen:
        seen.add(id(obj))
        h = getattr(obj, "hierarchy", None)
        tape = getattr(h, "tape", None)
        if tape is not None:
            tape.emit()
        obj = getattr(obj, "preconditioner", None)


def _representable(vals64: np.ndarray, pdt, via=None) -> bool:
    """Every value of ``vals64`` survives the round trip through ``pdt``
    (through ``via`` first, when the pack was cast from a wider one),
    chunked, stopping at the first chunk that does not."""
    flat = vals64.reshape(-1)
    step = 1 << 22
    chain = [torch_dtype(d) for d in (via, pdt) if d is not None]

    def trip(c):
        t = torch.from_numpy(np.ascontiguousarray(c))
        w = t
        for d in chain:
            w = w.to(d)
        return torch.equal(w.to(t.dtype), t)

    return all(trip(flat[s:s + step]) for s in range(0, flat.size, step))


def _permuted(v, idx: np.ndarray, dev: torch.device):
    """``v[idx]``: a tensor on its own device, host data as a numpy
    array."""
    if isinstance(v, torch.Tensor):
        return v[torch.from_numpy(idx).to(v.device)]
    return np.asarray(v)[idx]


def _inject_fault(mode: str, x, state):
    """A solve-loop fault-injection point (``_inject_fault`` upstream)
    applied to the iteration state: ``values_nan`` NaN-poisons x and
    every floating array of the Krylov state (device tensors and the
    host Hessenberg data alike); ``krylov_zero`` zeroes the 0-d Krylov
    scalars (CG's ρ) and leaves the vectors healthy."""
    def poison(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            if mode == "values_nan":
                return v * float("nan")
            return torch.zeros_like(v) if v.dim() == 0 else v
        if isinstance(v, np.ndarray) and np.issubdtype(v.dtype,
                                                       np.inexact):
            if mode == "values_nan":
                return v * np.nan
            return np.zeros_like(v) if v.ndim == 0 else v
        return v

    if dataclasses.is_dataclass(state):
        state = dataclasses.replace(state, **{
            f.name: poison(getattr(state, f.name))
            for f in dataclasses.fields(state)})
    elif isinstance(state, tuple):
        state = tuple(poison(v) for v in state)
    if mode == "values_nan":
        x = poison(x)
    return x, state


def _print_solve_stats(history, iters: int) -> None:
    """The per-iteration residual table (``_print_solve_stats``
    upstream), through the level-gated output."""
    if history is None:
        return
    lines = ["           iter      Mem Usage (GB)       residual      "
             "rate\n",
             "         --------------------------------------------------"
             "------------\n"]
    prev = None
    for i, h in enumerate(history):
        hval = float(np.max(h))
        rate = "" if prev in (None, 0.0) else f"{hval / prev:9.4f}"
        label = "Ini" if i == 0 else f"{i - 1:4d}"
        lines.append(f"        {label}              -         "
                     f"{hval:15.6e}  {rate}\n")
        prev = hval
    lines.append("         ----------------------------------------------"
                 "----------------\n")
    lines.append(f"        Total Iterations: {iters}\n")
    amgx_output("".join(lines))


def _as_device(v, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)


def _classify_failure(conv: bool, diverged: bool, brk_code: int,
                      first_bad: int, nrm, iters: int
                      ) -> Optional[FailureInfo]:
    """The terminal :class:`FailureInfo` of a monitored solve: the
    in-loop guard's code wins (with its first bad iteration); a
    non-finite final norm without one classifies by NaN against inf;
    anything else that burned the budget is stagnation."""
    if conv:
        return None
    if brk_code:
        kind = breakdown_kind(brk_code)
        if kind is not None:
            return FailureInfo(kind=kind, iteration=first_bad
                               if first_bad >= 0 else None)
    if diverged:
        nan = bool(np.any(np.isnan(nrm)))
        return FailureInfo(kind=(FailureKind.NAN_POISON if nan
                                 else FailureKind.DIVERGENCE),
                           iteration=iters)
    return FailureInfo(kind=FailureKind.STAGNATION, iteration=iters)

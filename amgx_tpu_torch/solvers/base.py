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
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Dict, Optional, Type

import numpy as np
import torch

from ..config import AMGConfig
from ..core.matrix import DeviceMatrix, Matrix
from ..core.precision import (is_floating, promotion_target,
                              tolerance_floor)
from ..device import numpy_dtype, torch_dtype
from ..errors import (BadConfigurationError, BadParametersError,
                      FailureInfo, FailureKind, NotImplementedError_,
                      SolveStatus)
from ..ops import blas
from ..ops.spmv import spmv


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
    its own real dtype — the one device→host fetch of a check."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.is_complex():
            v = v.real
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


#: knobs whose non-default values select a feature of a later slice of
#: the port — they raise rather than silently taking another path
_LATER_SLICE = (
    ("scaling", "NONE"), ("krylov_dtype", "default"),
    ("tpu_matrix_dtype", "default"), ("hierarchy_dtype", "default"),
    ("recovery_policy", "NONE"), ("fault_inject", ""), ("telemetry", 0),
    ("forensics", 0), ("setup_profile", 0), ("memledger", 0),
)


class Solver:
    """Base solver: parameters, the generic solve loop, and the
    preconditioner protocol (:meth:`apply`)."""

    config_name = "?"
    #: True for relaxation methods whose one iteration is one sweep
    is_smoother = False

    def __init__(self, cfg: AMGConfig, scope: str = "default"):
        self.cfg = cfg
        self.scope = scope
        g = lambda name: cfg.get(name, scope)
        for name, default in _LATER_SLICE:
            if g(name) != default:
                raise NotImplementedError_(
                    f"{name}={g(name)!r} is a later slice of the port")
        if str(g("matrix_reorder")) == "RCM":
            raise NotImplementedError_(
                "matrix_reorder=RCM is a later slice of the port")
        self.max_iters = int(g("max_iters"))
        self.tolerance = float(g("tolerance"))
        self.alt_rel_tolerance = float(g("alt_rel_tolerance"))
        self.convergence = str(g("convergence"))
        self.norm_type = str(g("norm"))
        self.monitor_residual = bool(g("monitor_residual"))
        self.store_res_history = bool(g("store_res_history"))
        self.print_solve_stats = bool(g("print_solve_stats"))
        self.relaxation_factor = float(g("relaxation_factor"))
        self.A: Optional[Matrix] = None
        self.Ad: Optional[DeviceMatrix] = None
        self.setup_time = 0.0

    # ------------------------------------------------------------ lifecycle
    def setup(self, A: "Matrix | DeviceMatrix"):
        """Setup (reference ``Solver::setup``, solver.cu:380-556)."""
        t0 = time.perf_counter()
        if isinstance(A, Matrix):
            self.A = A
            self.Ad = A.device()
        else:
            self.A = None
            self.Ad = A
        self.solver_setup()
        # new matrix values: a later refined solve rebuilds the residue
        self.__dict__.pop("_refine_lo", None)
        if self.Ad.device.type == "cuda":
            torch.cuda.synchronize(self.Ad.device)
        self.setup_time = time.perf_counter() - t0
        return self

    def solver_setup(self):
        """Override: build device-side data (diag inverse, hierarchy, ...)."""

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
        state = self.solve_init(b, x)
        for i in range(n):
            x, state = self.solve_iteration(b, x, state, i)
        return x

    def compute_residual_norm(self, b, x):
        return blas.norm(b - spmv(self.Ad, x), self.norm_type)

    # ------------------------------------------------ tolerance and ladder
    def _promotion_plan(self):
        """(refine_active, wide_dtype, structural_block) for the current
        tolerance (``base.py:645-701`` upstream)."""
        dtype = self.Ad.dtype
        if not (self.monitor_residual
                and self.tolerance < tolerance_floor(dtype)):
            return False, None, False
        if self.tolerance <= 0 or self.A is None or not is_floating(dtype):
            return False, None, True
        host_dt = np.dtype(self.A.dtype)
        if host_dt.itemsize <= dtype.itemsize:
            return False, None, False
        wide = promotion_target(dtype, host_dt, self.tolerance)
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
            warnings.warn(
                f"tolerance {self.tolerance:g} is below the {dtype} "
                f"precision floor (~{floor:.1g}); convergence to it "
                "cannot be honestly declared")
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
        freshly computed true residual."""
        if self.Ad is None:
            raise BadConfigurationError("solve() before setup()")
        dtype, dev = self.Ad.dtype, self.Ad.device
        refine, wide, structural = self._promotion_plan()
        self._check_tolerance_floor(refine, structural)
        x0 = None if zero_initial_guess else x0
        t0 = time.perf_counter()
        if refine:
            self._ensure_refine_data()
            x, iters, nrm, nrm_ini, history = \
                self._solve_refined(b, x0, wide)
        else:
            b = _as_device(b, dtype, dev)
            x0 = torch.zeros_like(b) if x0 is None \
                else _as_device(x0, dtype, dev)
            x, iters, nrm, nrm_ini, history, _ = \
                self._solve_loop(b, x0, self.tolerance, self.max_iters)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        solve_time = time.perf_counter() - t0

        nrm = np.atleast_1d(np.asarray(nrm, dtype=np.float64))
        nrm_ini = np.atleast_1d(np.asarray(nrm_ini, dtype=np.float64))
        failure = None
        if self.monitor_residual:
            nrm_max = nrm_ini
            if self.convergence in ("RELATIVE_MAX", "RELATIVE_MAX_CORE") \
                    and history is not None:
                h = np.atleast_2d(history)[:iters + 1]
                h = h[np.isfinite(h).all(axis=1)]
                if h.size:
                    nrm_max = np.maximum(nrm_ini, h.max(axis=0))
            conv = check_convergence(self.convergence, nrm, nrm_ini, nrm_max,
                                     self.tolerance, self.alt_rel_tolerance)
            diverged = bool(np.any(~np.isfinite(nrm)))
            status = (SolveStatus.SUCCESS if conv else
                      (SolveStatus.DIVERGED if diverged
                       else SolveStatus.NOT_CONVERGED))
            failure = _classify_failure(conv, diverged, nrm, iters)
        else:
            status = SolveStatus.SUCCESS
        keep = self.store_res_history or self.print_solve_stats
        history = history[:iters + 1] if keep else None
        if self.print_solve_stats and history is not None:
            print("\n".join(f"  {i:4d}  {float(np.max(h)):15.6e}"
                            for i, h in enumerate(history)))
            print(f"  Total Iterations: {iters}")
        return SolveResult(x=x, iterations=iters, status=status,
                           residual_norm=nrm, residual_history=history,
                           setup_time=self.setup_time,
                           solve_time=solve_time, failure=failure)

    def _solve_loop(self, b, x0, tolerance, it_limit,
                    final_residual: bool = True):
        """The monitored iteration loop (``_build_solve_fn`` upstream):
        returns ``(x, iterations, nrm, nrm_ini, history, bad_it)``:
        norms are host numpy arrays in the solve dtype, ``history``
        stacks the monitored norms, ``bad_it`` is the first iteration
        whose norm was not finite (-1 if none)."""
        monitor = self.monitor_residual
        crit, alt = self.convergence, self.alt_rel_tolerance
        nrm_ini = host_norm(blas.norm(b - spmv(self.Ad, x0),
                                      self.norm_type))
        state = self.solve_init(b, x0)
        hist = [nrm_ini]
        nrm = nmax = nrm_ini
        done = monitor and check_convergence(crit, nrm_ini, nrm_ini,
                                             nrm_ini, tolerance, alt)
        x, it, bad_it = x0, 0, -1
        limit = min(int(it_limit), self.max_iters)
        while not done and it < limit:
            x, state = self.solve_iteration(b, x, state, it)
            if monitor:
                est = self.residual_norm_estimate(b, x, state)
                if est is None:
                    est = self.compute_residual_norm(b, x)
                nrm = host_norm(est)
                nmax = np.maximum(nmax, nrm)
                done = check_convergence(crit, nrm, nrm_ini, nmax,
                                         tolerance, alt)
                if not np.all(np.isfinite(nrm)):
                    bad_it = it + 1
                    done = True
            hist.append(nrm)
            it += 1
        x = self.solve_finalize(b, x, state)
        if monitor and final_residual:
            nrm = host_norm(self.compute_residual_norm(b, x))
        return x, it, nrm, nrm_ini, np.stack(hist), bad_it

    # -------------------------------------------------- defect correction
    def _ensure_refine_data(self):
        """The rounding residue ``lo = vals64 − vals64(pack)`` that makes
        the wide operator exact (``base.py:1617-1665`` upstream); None for
        operators exactly representable in the pack dtype."""
        if hasattr(self, "_refine_lo"):
            return
        pdt = numpy_dtype(self.Ad.dtype)
        if pdt == np.float32 and getattr(self.A, "_vals_f32_exact", False):
            self._refine_lo = None
            return
        offs, vals = self.A.dia_cache()
        assert tuple(offs) == tuple(self.Ad.dia_offsets)
        vals64 = vals.astype(np.float64, copy=False)
        lo = (vals64 - vals64.astype(pdt).astype(np.float64)) \
            .astype(np.float32)
        self._refine_lo = torch.from_numpy(lo).to(self.Ad.device) \
            if np.any(lo) else None

    def _wide_pack(self, wide) -> DeviceMatrix:
        """The wide device pack of the exact host operator."""
        wdt = torch_dtype(wide)
        Ad64 = self.Ad.astype(wdt)
        if self._refine_lo is not None:
            Ad64 = dataclasses.replace(
                Ad64, vals=Ad64.vals + self._refine_lo.to(wdt))
        return Ad64

    def _solve_refined(self, b, x0, wide):
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
            v64 = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v)).astype(np.float64).ravel()
            hi = v64.astype(numpy_dtype(dtype))
            lo = v64 - hi.astype(np.float64)
            return (torch.from_numpy(hi).to(dev),
                    torch.from_numpy(lo).to(dev, lo_dt) if np.any(lo)
                    else None)

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
        nrm_ini = host_norm(blas.norm(r64, self.norm_type))
        hist = np.zeros((self.max_iters + 1, 1), hist_dt)
        hist[0] = nrm_ini.astype(hist_dt)
        nrm = nrm_ini
        done = check_convergence(crit, nrm_ini, nrm_ini, nrm_ini,
                                 self.tolerance, alt)
        it_tot, k, bad = 0, 0, False
        while not done and it_tot < self.max_iters and k < max_outer:
            scale = torch.clamp(torch.max(torch.abs(r64)), min=tiny)
            rb = (r64 / scale).to(dtype)
            dx, it, _, _, h_in, bad_it = self._solve_loop(
                rb, torch.zeros_like(rb), inner_tol,
                self.max_iters - it_tot, final_residual=False)
            bad = bad or bad_it >= 0
            x64 = x64 + scale * dx.to(wdt)
            r64 = b64 - spmv(Ad64, x64)
            nrm_t = blas.norm(r64, self.norm_type)
            if keep_history:
                fetched = host_norm(torch.stack([nrm_t, scale]))
                nrm = fetched[:1]
                rows = h_in[1:it + 1].astype(hist_dt) * hist_dt.type(
                    fetched[1])
                hist[it_tot + 1:it_tot + it + 1] = rows
            else:
                nrm = host_norm(nrm_t)
            done = check_convergence(crit, nrm, nrm_ini, nrm_ini,
                                     self.tolerance, alt) \
                or not np.all(np.isfinite(nrm)) or bad
            it_tot += it
            k += 1
        return x64, it_tot, nrm, nrm_ini, hist


def _as_device(v, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)


def _classify_failure(conv: bool, diverged: bool, nrm,
                      iters: int) -> Optional[FailureInfo]:
    """The terminal :class:`FailureInfo` of a monitored solve."""
    if conv:
        return None
    if diverged:
        nan = bool(np.any(np.isnan(nrm)))
        return FailureInfo(kind=(FailureKind.NAN_POISON if nan
                                 else FailureKind.DIVERGENCE),
                           iteration=iters)
    return FailureInfo(kind=FailureKind.STAGNATION, iteration=iters)

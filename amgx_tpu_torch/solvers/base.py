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
from ..core.matrix import (DeviceMatrix, Matrix, binned_planes,
                           dia_arrays_block, ell_host_arrays, ell_layout)
from ..core.precision import (is_floating, promotion_target,
                              tolerance_floor)
from ..device import numpy_dtype, torch_dtype
from ..errors import (BREAKDOWN_DIVERGENCE, BREAKDOWN_KRYLOV,
                      BREAKDOWN_NAN, BadConfigurationError,
                      BadParametersError, FailureInfo, FailureKind,
                      NotImplementedError_, SolveStatus, breakdown_kind)
from ..ops import blas
from ..ops.binned_spmv import bn_block_dim, compact_pack
from ..ops.ell_spmv import ell_row_len
from ..ops.shift_spmv import shift_compact, shift_planes_like
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
        self.use_scalar_norm = bool(g("use_scalar_norm"))
        self.monitor_residual = bool(g("monitor_residual"))
        self.store_res_history = bool(g("store_res_history"))
        self.print_solve_stats = bool(g("print_solve_stats"))
        self.relaxation_factor = float(g("relaxation_factor"))
        #: the reduction layout of CG/PCG and (F)GMRES: CLASSIC, CA or
        #: PIPELINED (``solvers/krylov.py``)
        self.krylov_comm = str(g("krylov_comm"))
        self.ca_residual_replace = int(g("ca_residual_replace"))
        self.A: Optional[Matrix] = None
        self.Ad: Optional[DeviceMatrix] = None
        self.setup_time = 0.0

    # ------------------------------------------------------------ lifecycle
    def setup(self, A: "Matrix | DeviceMatrix"):
        """Setup (reference ``Solver::setup``, solver.cu:380-556): a full
        rebuild, unless :meth:`resetup` called it."""
        t0 = time.perf_counter()
        if isinstance(A, Matrix):
            self.A = A
            self.Ad = A.device()
        else:
            self.A = None
            self.Ad = A
        self.solver_setup()
        # new matrix values, also on a resetup (a new rounding residue):
        # a later refined solve rebuilds its operator
        self.__dict__.pop("_wide", None)
        if self.Ad.device.type == "cuda":
            torch.cuda.synchronize(self.Ad.device)
        self.setup_time = time.perf_counter() - t0
        return self

    def resetup(self, A: "Matrix | DeviceMatrix"):
        """Numeric refresh after ``Matrix.replace_coefficients``: the same
        structure, new values (``AMGX_solver_resetup``).  Nested
        preconditioner instances, the AMG hierarchy's coarsening
        structure (with ``structure_reuse_levels`` ≠ 0) and the AMG's
        CUDA graphs (where every tensor they read keeps its shape, dtype
        and device, :mod:`._bind`) survive; :meth:`setup` stays a full
        rebuild."""
        self._numeric_resetup = True
        try:
            return self.setup(A)
        finally:
            self._numeric_resetup = False

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
            x, iters, nrm, nrm_ini, history, fail = \
                self._solve_refined(b, x0, wide)
        else:
            b = _as_device(b, dtype, dev)
            x0 = torch.zeros_like(b) if x0 is None \
                else _as_device(x0, dtype, dev)
            x, iters, nrm, nrm_ini, history, fail = \
                self._solve_loop(b, x0, self.tolerance, self.max_iters)
        brk_code, first_bad = fail
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
        returns ``(x, iterations, nrm, nrm_ini, history, fail)``: norms
        are host numpy arrays in the solve dtype (one entry, or one per
        block component), ``history`` stacks the monitored norms, ``fail``
        is ``(breakdown code, first bad iteration)`` — ``(0, -1)`` for a
        healthy loop.  A solver's breakdown code is fetched with the
        norm, in the iteration's one host sync."""
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
        while not done and it < limit:
            x, state = self.solve_iteration(b, x, state, it)
            if monitor:
                est = self.residual_norm_estimate(b, x, state)
                if est is None:
                    est = self.compute_residual_norm(b, x)
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
        pdt = numpy_dtype(Ad.dtype)
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
            exact = _representable(host, pdt)
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
        if Ad.fmt == "csr":
            return np.asarray(host.data, dtype=np.float64)
        for_rows, pos, k = ell_layout(host.indptr, host.indices)
        b = Ad.block_dim
        out = np.zeros((Ad.n_rows, k, b, b), dtype=np.float64)
        out[for_rows, pos] = host.data
        return out

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
                self.max_iters - it_tot, final_residual=False)
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


def _representable(vals64: np.ndarray, pdt) -> bool:
    """Every value of ``vals64`` survives the round trip through ``pdt``
    (chunked, stopping at the first chunk that does not)."""
    flat = vals64.reshape(-1)
    step = 1 << 22
    return all(np.array_equal(c.astype(pdt).astype(c.dtype), c)
               for c in (flat[s:s + step]
                         for s in range(0, flat.size, step)))


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

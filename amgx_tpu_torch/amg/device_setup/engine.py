"""Pattern-keyed device setup engine: cached Galerkin plans (port of
``amgx_tpu/amg/device_setup/engine.py``).

The engine owns a process-wide LRU of symbolic plans keyed by (A
pattern fingerprint, P pattern fingerprint or aggregate digest, dtype).
The symbolic pass (``ops/spgemm.py``) runs in torch on the level's
device.  A cache hit skips it: a structure-reusing resetup runs only the
numeric pass, two ordered segment sums a classical level
(:func:`~...ops.spgemm.galerkin_numeric`) and one an aggregation level,
on the level's device (the JAX package jits them; here they run
eagerly, in the JAX package's order of each sum).

The gate declines (below ``min_rows``, an empty operand, a plan past the
byte budget, a dtype other than f32/f64) return None and are counted by
reason in :meth:`DeviceSetupEngine.stats`.  The byte budget is the
call's own (``device_setup_cache_mb``): it bounds the plan that call may
build and the cache bytes its insertion leaves, and changes no other
call's.  The JAX package also turns
any exception of a numeric pass into a silent host fallback; the port
does not: an error on a device tensor raises to the caller.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ... import telemetry
from ...core.matrix import csr_structure_fingerprint
from ...ops import spgemm
from ...telemetry import setup_profile

#: default schedule-byte budget of the plan cache (LRU evicts past it);
#: a call's ``budget_bytes`` (the ``device_setup_cache_mb`` knob) takes
#: its place for that call
DEFAULT_BUDGET_BYTES = 256 << 20

#: numeric dtypes of a device Galerkin pass
_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))


def _canon(M) -> sp.csr_matrix:
    """Canonical CSR view (sorted indices): plan schedules and numeric
    data order must agree.  Sorts in place when needed."""
    M = M if isinstance(M, sp.csr_matrix) else sp.csr_matrix(M)
    if not M.has_sorted_indices:
        M.sort_indices()
    return M


class DeviceSetupEngine:
    """LRU cache of :class:`~...ops.spgemm.GalerkinPlan` and aggregation
    plans, and the numeric passes around them."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES):
        self.budget_bytes = int(budget_bytes)
        self._plans: "OrderedDict[tuple, object]" = OrderedDict()
        #: patterns whose plan exceeded a budget, with a lower bound of
        #: its bytes: the verdict is kept so a resetup under the same
        #: budget does not rebuild (and discard) the plan each time
        self._rejected: "OrderedDict[tuple, int]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.evictions = 0
        self.numeric_runs = 0
        #: numeric passes of the distributed shard-local form
        self.dist_runs = 0
        self.declines: dict = {}

    def _budget(self, budget_bytes) -> int:
        """The budget of one call: its own, else the engine's default.
        It bounds the plan the call may build and the cache bytes its
        insertion leaves; no call changes another's."""
        return self.budget_bytes if budget_bytes is None \
            else int(budget_bytes)

    def _budget_rejected(self, key, budget: int) -> bool:
        with self._lock:
            need = self._rejected.get(key)
            if need is not None and need > budget:
                self._rejected.move_to_end(key)
                return True
            return False

    def _reject(self, key, need: int):
        with self._lock:
            self._rejected[key] = max(int(need),
                                      self._rejected.get(key, 0))
            while len(self._rejected) > 256:
                self._rejected.popitem(last=False)

    # ------------------------------------------------------------ cache
    def _get(self, key):
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.hits += 1
            return plan

    def _put(self, key, plan, budget: int):
        with self._lock:
            if key in self._plans:
                return self._plans[key]
            self.misses += 1
            self._plans[key] = plan
            self._bytes += plan.nbytes
            while self._bytes > budget and len(self._plans) > 1:
                _, old = self._plans.popitem(last=False)
                self._bytes -= old.nbytes
                self.evictions += 1
            return plan

    def _plan(self, key, build, budget: int, min_bytes: int = 0,
              device="cpu"):
        """The cached plan of ``key``, or one from the warm-start store
        (``serve/aot.py``, when ``aot_store_dir`` configured one), or a
        new one from ``build()``; None (a "budget" decline) when it does
        not fit ``budget`` — known before the build when ``min_bytes``
        already exceeds it, during it when ``build()`` returns None."""
        if self._budget_rejected(key, budget):
            return self._decline("budget")
        plan = self._get(key)
        if plan is None:
            if min_bytes > budget:
                self._reject(key, min_bytes)
                return self._decline("budget")
            from ...serve import aot

            def counted_build():
                with setup_profile.phase("spgemm"):
                    out = build()
                with self._lock:
                    self.builds += 1
                return out

            plan = aot.stored_plan(key[0], key[1:], counted_build, device)
            if plan is None or plan.nbytes > budget:
                self._reject(key, budget + 1 if plan is None
                             else plan.nbytes)
                return self._decline("budget")
            plan = self._put(key, plan, budget)
            if telemetry.is_enabled():
                telemetry.gauge_set("amgx_spgemm_plan_cache",
                                    len(self._plans))
                telemetry.gauge_set("amgx_spgemm_plan_bytes", self._bytes)
        return plan

    def stats(self) -> dict:
        with self._lock:
            return {"plans": len(self._plans),
                    "plan_bytes": int(self._bytes),
                    "hits": int(self.hits),
                    "misses": int(self.misses),
                    "builds": int(self.builds),
                    "evictions": int(self.evictions),
                    "fallbacks": int(sum(self.declines.values())),
                    "declines": dict(self.declines),
                    "numeric_runs": int(self.numeric_runs),
                    "dist_runs": int(self.dist_runs)}

    # -------------------------------------------------------- declines
    def _decline(self, reason: str):
        """Count one gate decline; returns None (the caller runs the
        host product)."""
        with self._lock:
            self.declines[reason] = self.declines.get(reason, 0) + 1
        if telemetry.is_enabled():
            telemetry.event("device_setup_fallback", component="rap",
                            reason=reason, level=None)
            telemetry.counter_inc("amgx_device_setup_fallback_total",
                                  reason=reason)
            telemetry.counter_inc("amgx_device_rap_total", path="host")
        return None

    @staticmethod
    def _ran(op: str):
        """Telemetry of one numeric pass that ran on the device path."""
        if telemetry.is_enabled():
            telemetry.counter_inc("amgx_device_rap_total",
                                  path="dist" if op == "rap_dist"
                                  else "device")
            telemetry.counter_inc("amgx_spgemm_total", op=op)

    @staticmethod
    def _dtype_gate(dtype) -> Optional[str]:
        dt = np.dtype(dtype)
        return None if dt in _DTYPES else f"dtype:{dt.name}"

    def _gates(self, n_rows: int, empty: bool, dtype, min_rows: int):
        """The shared declines; a reason string, or None to proceed."""
        if n_rows < int(min_rows):
            return "small"
        if empty:
            return "empty"
        return self._dtype_gate(dtype)

    # ------------------------------------------------------ Galerkin RAP
    def galerkin_csr(self, A, P, *, dtype, device="cpu",
                     keep_pattern: bool = False, min_rows: int = 0,
                     budget_bytes: Optional[int] = None
                     ) -> Optional[sp.csr_matrix]:
        """Galerkin product ``Pᵀ·A·P`` of host CSR operands, its numeric
        pass on ``device``.  Returns the coarse CSR (host; values
        computed on the device) or None after a gate decline.  The
        pattern is the full symbolic one with ``keep_pattern`` (the
        frozen structure a values-only resetup refreshes) and
        zero-pruned otherwise (scipy's pattern)."""
        budget = self._budget(budget_bytes)
        dtype = np.dtype(dtype)
        A = _canon(A)
        P = _canon(P)
        reason = self._gates(A.shape[0], A.nnz == 0 or P.nnz == 0, dtype,
                             min_rows)
        if reason:
            return self._decline(reason)
        key = ("rap", csr_structure_fingerprint(A),
               csr_structure_fingerprint(P), dtype.str)
        # the A·P terms alone (two int32 indices each) bound the plan's
        # bytes from below: past the budget, decline before building it;
        # the build stops before its second product past the budget too
        n_ap = int(np.diff(P.indptr)[A.indices].sum())
        plan = self._plan(
            key, lambda: spgemm.build_galerkin_plan(
                A, P, device=device, max_bytes=budget),
            budget, min_bytes=8 * n_ap, device=device)
        if plan is None:
            return None
        tdt = getattr(torch, dtype.name)
        with setup_profile.phase("device_rap", kind="device"):
            vA = torch.from_numpy(A.data).to(device=device, dtype=tdt)
            vP = torch.from_numpy(P.data).to(device=device, dtype=tdt)
            data = spgemm.galerkin_numeric(plan, vA, vP).cpu().numpy()
        with self._lock:
            self.numeric_runs += 1
        self._ran("rap")
        Ac = sp.csr_matrix((data.astype(dtype), plan.Ac_indices.copy(),
                            plan.Ac_indptr.copy()), shape=plan.Ac_shape)
        if not keep_pattern:
            # scipy's product prunes exact cancellations; so does this
            Ac.eliminate_zeros()
        return Ac

    def galerkin_dist(self, A_loc, P_ext, P_loc, *, dtype, device="cpu",
                      min_rows: int = 0,
                      budget_bytes: Optional[int] = None
                      ) -> Optional[sp.csr_matrix]:
        """The shard-local distributed Galerkin partial
        ``P_locᵀ·(A_loc·P_ext)`` (``galerkin_dist`` upstream,
        ``engine.py:221-290``; the reference's ``RAP_ext``,
        ``csr_multiply.h:100-126``): ``A_loc`` is one rank's row block
        over its [local | ring-1] column space, ``P_ext`` its local P rows
        stacked with the halo'd P rows, ``P_loc`` the local rows alone.
        The symbolic pass runs on ``device`` (cached by the three
        patterns and the dtype), the numeric pass there too.  Returns the
        rank's (nc, nc) coarse partial on its full symbolic pattern, exact
        zeros included, or None after a gate decline (the caller runs
        the scipy product)."""
        budget = self._budget(budget_bytes)
        dtype = np.dtype(dtype)
        A_loc = _canon(A_loc)
        P_ext = _canon(P_ext)
        P_loc = _canon(P_loc)
        reason = self._gates(A_loc.shape[0], A_loc.nnz == 0 or
                             P_ext.nnz == 0 or P_loc.nnz == 0, dtype,
                             min_rows)
        if reason:
            return self._decline(reason)
        key = ("rapd", csr_structure_fingerprint(A_loc),
               csr_structure_fingerprint(P_ext),
               csr_structure_fingerprint(P_loc), dtype.str)
        n_ap = int(np.diff(P_ext.indptr)[A_loc.indices].sum())
        plan = self._plan(
            key, lambda: spgemm.build_galerkin_plan(
                A_loc, P_ext, device=device, max_bytes=budget,
                P_left=P_loc), budget, min_bytes=8 * n_ap, device=device)
        if plan is None:
            return None
        tdt = getattr(torch, dtype.name)
        with setup_profile.phase("device_rap", kind="device"):
            vA = torch.from_numpy(A_loc.data).to(device=device, dtype=tdt)
            vP = torch.from_numpy(P_ext.data).to(device=device, dtype=tdt)
            data = spgemm.galerkin_numeric(plan, vA, vP).cpu().numpy()
        with self._lock:
            self.numeric_runs += 1
            self.dist_runs += 1
        self._ran("rap_dist")
        Ac = sp.csr_matrix((data.astype(dtype), plan.Ac_indices.copy(),
                            plan.Ac_indptr.copy()), shape=plan.Ac_shape)
        # the full symbolic pattern: pruning would make the coarse
        # pattern depend on the values, as upstream
        Ac.sort_indices()
        return Ac

    def cached_galerkin_plan(self, A, P, dtype):
        """The cached plan of ``Pᵀ·A·P`` for these patterns and dtype,
        or None (counted as a hit when found): the classical resetup
        plans take their schedules from it instead of a second symbolic
        pass."""
        key = ("rap", csr_structure_fingerprint(_canon(A)),
               csr_structure_fingerprint(_canon(P)), np.dtype(dtype).str)
        return self._get(key)

    # ------------------------------------------------ aggregation RAP
    def galerkin_agg(self, A_host, agg: np.ndarray, block_dim: int = 1,
                     *, dtype, device="cpu", min_rows: int = 0,
                     budget_bytes: Optional[int] = None,
                     agg_cols: Optional[np.ndarray] = None,
                     shape: Optional[tuple] = None):
        """Galerkin product of unsmoothed aggregation (R = Sᵀ, P = S):
        one ordered segment sum over the (agg[row], agg[col]) pairs of a
        scalar CSR or a b×b BSR.  Returns CSR/BSR (host; values computed
        on ``device``) or None after a gate decline.

        ``agg_cols``/``shape``: the rectangular shard-local form of a
        distributed level (one rank's row block: its local coarse rows
        from ``agg``, the global coarse columns of every column, halo
        columns included, from ``agg_cols``; ``shape`` = (local coarse
        rows, global coarse columns)).  Its result keeps every slot of
        the pattern, exact zeros included, as upstream
        (``engine.py:295-352``); a block matrix declines it
        (``"block-dist"``)."""
        budget = self._budget(budget_bytes)
        dtype = np.dtype(dtype)
        b = int(block_dim)
        if b == 1:
            M = _canon(A_host)
        else:
            M = A_host if isinstance(A_host, sp.bsr_matrix) else \
                sp.bsr_matrix(A_host, blocksize=(b, b))
            M.sort_indices()
        n = M.shape[0] // b
        agg = np.asarray(agg)
        reason = self._gates(n, M.nnz == 0 or len(agg) == 0, dtype,
                             min_rows)
        rect = agg_cols is not None
        if not reason and rect and b != 1:
            reason = "block-dist"
        if reason:
            return self._decline(reason)
        if rect:
            agg_cols = np.asarray(agg_cols)
            nc, nc_cols = int(shape[0]), int(shape[1])
        else:
            nc = nc_cols = int(agg.max()) + 1
        ah = hashlib.blake2b(np.ascontiguousarray(agg).tobytes(),
                             digest_size=16)
        if rect:
            ah.update(np.ascontiguousarray(agg_cols).tobytes())
            ah.update(repr((nc, nc_cols)).encode())
        key = ("agg", csr_structure_fingerprint(M), ah.hexdigest(), b,
               dtype.str)
        plan = self._plan(
            key, lambda: _build_agg_plan(M, agg, nc, b, device,
                                         agg_cols=agg_cols,
                                         nc_cols=nc_cols), budget,
            device=device)
        if plan is None:
            return None
        tdt = getattr(torch, dtype.name)
        vals = M.data if b == 1 else M.data.reshape(-1, b, b)
        with setup_profile.phase("device_rap", kind="device"):
            out = spgemm.run_schedule(
                plan.sched, plan._device_arrays(device),
                torch.from_numpy(np.ascontiguousarray(vals)).to(
                    device=device, dtype=tdt))
            data = out.cpu().numpy().astype(dtype)
        with self._lock:
            self.numeric_runs += 1
        self._ran("agg")
        if b == 1:
            Ac = sp.csr_matrix((data, plan.C_indices.copy(),
                                plan.C_indptr.copy()), shape=(nc, nc_cols))
            if not rect:
                Ac.eliminate_zeros()
            Ac.sort_indices()
            return Ac
        return sp.bsr_matrix((data, plan.C_indices.copy(),
                              plan.C_indptr.copy()), shape=(nc * b, nc * b))


@dataclasses.dataclass
class _AggPlan(spgemm._DevicePlan):
    """Aggregation Galerkin plan: ``Ac.data[s] = Σ A.data[t]`` over the
    entries t whose ``agg[row]·nc + agg[col]`` is coarse slot s — the
    LOW_DEG generator's segment semantics as one ordered segment sum."""
    sched: spgemm.Schedule
    C_indptr: np.ndarray
    C_indices: np.ndarray
    _dev: Optional[tuple] = None

    @property
    def nbytes(self) -> int:
        return self.sched.nbytes + int(self.C_indices.nbytes) + \
            int(self.C_indptr.nbytes)

    def _upload(self, device) -> dict:
        return self.sched.device_arrays(device)


def _build_agg_plan(M, agg: np.ndarray, nc: int, block_dim: int,
                    device="cpu", agg_cols: Optional[np.ndarray] = None,
                    nc_cols: Optional[int] = None) -> _AggPlan:
    """Symbolic pass of the aggregation Galerkin product on ``device``:
    the coarse pattern and the entries sorted by coarse slot (stably),
    from the structure and the aggregates alone.  ``agg_cols``/
    ``nc_cols`` split the row and column aggregate maps (the rectangular
    shard-local form); square when omitted."""
    dev = torch.device(device)
    n = M.shape[0] // block_dim
    ncc = nc if nc_cols is None else int(nc_cols)
    indptr = spgemm.as_index(M.indptr, dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   indptr[1:] - indptr[:-1])
    agg_t = spgemm.as_index(agg, dev)
    agg_c = agg_t if agg_cols is None else spgemm.as_index(agg_cols, dev)
    key = agg_t[rows] * ncc + agg_c[spgemm.as_index(M.indices, dev)]
    order, t_out, C_indptr, C_indices = spgemm.sort_terms(key, nc, ncc)
    return _AggPlan(sched=spgemm.ordered_schedule(order, None, t_out,
                                                  len(C_indices)),
                    C_indptr=C_indptr.cpu().numpy(),
                    C_indices=C_indices.cpu().numpy())


# -------------------------------------------------------- module state
_ENGINE: Optional[DeviceSetupEngine] = None
_ENGINE_LOCK = threading.Lock()


def engine() -> DeviceSetupEngine:
    """The process-wide engine (plans shared across solvers and
    resetups)."""
    global _ENGINE
    if _ENGINE is None:
        with _ENGINE_LOCK:
            if _ENGINE is None:
                _ENGINE = DeviceSetupEngine()
    return _ENGINE


def engine_stats() -> Optional[dict]:
    """Stats of the live engine, or None when nothing instantiated it."""
    return _ENGINE.stats() if _ENGINE is not None else None


def reset_engine():
    """Drop the engine and its plan cache (test isolation)."""
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = None

"""AMG hierarchy: the setup loop (port of the structured/GEO, the serial
scalar aggregation and the serial classical parts of
``amgx_tpu/amg/hierarchy.py``; reference ``AMG_Setup::setup``,
``amg.cu:177-450``).

* GEO aggregation on a stencil: every coarsening decision is planned
  from the fine offsets and grid dims
  (:func:`~.dia_device.plan_dia_hierarchy`), then all coarse levels'
  values, diagonals and inverted diagonals are derived on the fine
  operator's device in one pass.
* Classical AMG: the fully-device pipeline coarsens a large stencil fine
  level by shift algebra into an embedded level 1 (applied as the
  composition R·(A·(P·x))) and the compact ELL levels below it on the
  device (:mod:`.classical.device_pipeline`,
  :mod:`.classical.device_coarse`), until a tail of at most
  ``AMGX_PIPELINE_TAIL_ROWS`` (default 4096) logical rows goes to the
  host loop: strength → PMIS → D1/D2 on the host (a small DIA fine level
  runs them on the device, :mod:`.classical.device_fine`) and the scipy
  Galerkin triple product.  ``AMGX_NO_DEVICE_PIPELINE=1`` sends the
  whole setup down the host loop.

* Aggregation beyond the GEO plan (an operator of more than 48
  diagonals, a block system, or the SIZE_2/4/8, MULTI_PAIRWISE,
  PARALLEL_GREEDY and DUMMY selectors): the host loop runs the selector
  on the host CSR — on a b×b block system, on its Frobenius-condensed
  scalar graph — (:mod:`.aggregation.selectors`, bit-equal to the JAX
  package's), the Galerkin product Sᵀ·A·S through the device setup
  engine, and an :class:`~.level.AggregationLevel` per level.  A DIA
  level past the GEO plan's diagonal budget coarsens on the host,
  structured 2×2×2 or pairwise (:mod:`.structured`, :mod:`.pairwise`);
  GEO on a level without a DIA decomposition reads the attached
  coordinates (``Matrix.geometry``; coarse levels take the aggregate
  centroids), and without coordinates becomes SIZE_2, as upstream.
* The Galerkin products of the host levels go through the device setup
  engine (:mod:`.device_setup`; ``device_setup=1``, the default): a
  pattern-keyed plan cache whose numeric pass runs on the level's
  device as ordered segment sums.  Levels below
  ``device_setup_min_rows`` (and the other gate declines) take the
  scipy product.
* ``algorithm=ENERGYMIN`` runs the classical host loop with
  ``energymin_selector``/``energymin_interpolator`` (CR + EM), and the
  first ``aggressive_levels`` classical levels take
  ``aggressive_selector``/``aggressive_interpolator``; the device
  classical paths read these effective names.

* A distributed matrix (``Matrix.set_distribution``, a sharded pack)
  coarsens per rank (``_coarsen_aggregation_dist`` upstream): each rank
  aggregates its own diagonal block, coarse ids are rank-contiguous,
  and each rank's coarse rows come from its own row block through the
  engine's rectangular Galerkin form (halo columns resolve through the
  global aggregate ids), so no step assembles a global matrix.  A coarse
  grid too small per rank consolidates onto a sub-mesh, or off the mesh
  onto one replicated level: the legacy
  ``matrix_consolidation_lower/upper_threshold`` or the
  ``dist_agglomerate_min_rows`` planner (:mod:`..distributed.agglomerate`).
  Classical AMG on a distributed matrix coarsens per rank too
  (``_coarsen_classical_dist`` upstream, :mod:`.classical.distributed`):
  strength and PMIS on each rank's extended rows with exchanged halo C/F
  states, D1/D2 interpolation through the ring-2 extended blocks, the
  per-rank Galerkin partials through the engine's shard-local form
  (``galerkin_dist``) summed by their owners, and sharded rectangular
  P/R packs.  Other selectors (HMIS, RS, the CR of ENERGYMIN…), other
  interpolators and a strength that is not row-local take the JAX
  package's global fallback: P and R embedded into the padded spaces.
  A resetup of a distributed matrix is a fresh setup, as upstream.

Values-only resetup (``structure_reuse_levels`` ≠ 0; reference
``amg.cu:260-290``): each level records its coarsening decision in
``_structure`` — ``("structured", (dims,))``, ``("pairwise", (n,))``,
``("aggregation", (aggregates, nc))`` or ``("classical", (P,))`` — and a
later setup of the same hierarchy object keeps them and refreshes the
values: the DIA plan re-derived on the device (``"dia_device"``), the
classical Galerkin products refreshed on the device from schedules built
at setup (:mod:`.classical.resetup_device`, ``"classical_device"``), or
each level's Galerkin product replayed (``"host_replay"``: the engine's
cached plans, the host structured/pairwise step of a DIA level the
device refresh does not derive);
``last_resetup`` names the path taken (``"fresh"`` for a full setup).
A reuse-configured classical setup runs the host loop: the device
pipeline builds levels no plan could refresh.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import AMGConfig
from ..core.matrix import ComposedDIA, Matrix, dia_device_matrix
from ..core import precision
from ..core.precision import compute_dtype, resolve_dtype
from ..device import host_scalar, storage_dtype
from ..errors import BadConfigurationError
from ..ops.spgemm import pad_to_symbolic
from ..solvers.base import SolverFactory
from .. import telemetry
from ..telemetry import setup_profile
from ..utils.logging import amgx_output
from ..utils.profiler import cpu_profiler
from .aggregation.galerkin import galerkin_coarse
from .dia_device import derive_hierarchy_device, plan_dia_hierarchy
from .level import (AggregationLevel, AMGLevel, ClassicalLevel,
                    PairwiseLevel, StructuredLevel)
from .pairwise import pairwise_galerkin_dia
from .structured import (coarse_dims, decompose_offsets, infer_grid_dims,
                         stencil_values_consistent, structured_galerkin)

#: the structured/pairwise path declined (too many diagonals): the
#: caller retries with a graph-matching selector
_PAIRWISE_FALLBACK = object()


#: THE PMIS tie-break seed of the device classical paths
#: (``_tiebreak_seed`` upstream): always 7, whatever ``determinism_flag``
#: says, so pipeline-on/off runs select the same coarse grids (the host
#: PMIS selector keeps its own rule: 7 with ``determinism_flag``, else
#: its session seed)
_TIEBREAK_SEED = 7


def _rebucket_blocks(blocks, new_offsets):
    """Re-split per-rank row blocks at new offsets (consolidation only:
    the migrated data is small by construction)."""
    from ..distributed.partition import split_row_blocks
    return split_row_blocks(sp.vstack(blocks), new_offsets)


def _child_matrix(parent: Matrix, a, block_dim: int = 1) -> Matrix:
    """A host-built hierarchy child inheriting the parent's device and
    device dtype."""
    m = Matrix(a, block_dim=block_dim, device=parent.placement)
    m.device_dtype = parent.device_dtype
    return m


def _child_matrix_dia(parent: Matrix, offsets, vals) -> Matrix:
    """A host-derived DIA child (the host structured/pairwise step): the
    coarse operator stays in diagonal form, its CSR view assembles only
    when a consumer asks."""
    m = Matrix.from_dia(offsets, vals, device=parent.placement)
    m.device_dtype = parent.device_dtype
    return m


def _narrow_dia(cur: Matrix, arrs):
    """The host Galerkin of a DIA level runs in the level's device dtype,
    floored at f32 (``compute_dtype``), as the JAX package's does."""
    dd = compute_dtype(np.dtype(cur.device_dtype)) \
        if cur.device_dtype is not None else None
    if dd is not None and dd.itemsize < arrs[1].dtype.itemsize:
        return (arrs[0], arrs[1].astype(dd))
    return arrs


def _require_dia(cur: Matrix):
    """The kept (offsets, host vals) of a DIA level a structure-reuse
    refresh derives on the host; raises when the refreshed matrix has no
    diagonal decomposition."""
    arrs = cur.dia_cache() if cur.block_dim == 1 else None
    if arrs is None:
        raise _no_dia_structure()
    offs, vals, _ = _drop_zero_diagonals(*arrs)
    return offs, vals


def _block_condensed(m: Matrix) -> sp.csr_matrix:
    """A b×b block matrix condensed to the scalar weight graph the
    aggregation selectors read: the Frobenius norm of each block (the
    reference reads one component per block,
    ``aggregation_edge_weight_component``)."""
    bsr = m.host if isinstance(m.host, sp.bsr_matrix) else sp.bsr_matrix(
        m.host, blocksize=(m.block_dim, m.block_dim))
    bsr.sort_indices()
    n = bsr.shape[0] // m.block_dim
    vals = np.sqrt((bsr.data ** 2).sum(axis=(1, 2)))
    return sp.csr_matrix((vals, bsr.indices, bsr.indptr), shape=(n, n))


def _drop_zero_diagonals(offs, vals: np.ndarray):
    """Drop stored all-zero diagonals (the main diagonal always stays);
    returns ``(offs, vals, keep)`` with ``keep`` None when nothing was
    dropped, else the kept row indices."""
    offs = list(offs)
    nonzero = (vals != 0).any(axis=1) | (np.asarray(offs) == 0)
    if nonzero.all():
        return offs, vals, None
    keep = np.flatnonzero(nonzero)
    return [offs[int(k)] for k in keep], vals[keep], keep


def _no_dia_structure():
    """The error of a structure-reuse refresh whose matrix no longer has
    the recorded DIA structure (a block or rectangular matrix handed to
    resetup)."""
    return BadConfigurationError(
        "resetup: recorded hierarchy structure is DIA-based but the "
        "refreshed matrix has no diagonal decomposition — call setup() "
        "for a structural rebuild")


def _on_device(v, dev: torch.device):
    """``v`` (a tensor, a device pack or ``Matrix``, or anything else,
    returned as is) on ``dev``: a ``Matrix`` becomes a shallow copy that
    shares its host data, with its cached packs, inverted diagonal and
    mesh copied over; a pack dataclass (a sharded pack and its mesh
    included) is rebuilt field by field."""
    import copy
    import dataclasses
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    if isinstance(v, torch.device):
        # a distributed level's mesh moves with its shards
        return dev
    if isinstance(v, Matrix):
        m = copy.copy(v)
        m.placement = dev
        if v.dist is not None:
            m.dist = (_on_device(v.dist[0], dev),) + tuple(v.dist[1:])
        for k in ("_device", "_setup_wide"):
            if getattr(v, k, None) is not None:
                setattr(m, k, _on_device(getattr(v, k), dev))
        if v._dinv_dev is not None:
            m._dinv_dev = (v._dinv_dev[0], v._dinv_dev[1].to(dev))
        return m
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.replace(v, **{
            f.name: _on_device(getattr(v, f.name), dev)
            for f in dataclasses.fields(v) if f.init})
    return v


def _kept_rows(vals: torch.Tensor, keep) -> torch.Tensor:
    """The rows ``keep`` of a device DIA ``vals`` (all when None)."""
    if keep is None:
        return vals
    return vals[torch.as_tensor(keep, dtype=torch.int64, device=vals.device)]


class AMGHierarchy:
    def __init__(self, cfg: AMGConfig, scope: str):
        self.cfg = cfg
        self.scope = scope
        g = lambda name: cfg.get(name, scope)
        self.algorithm = str(g("algorithm"))
        self.selector = str(g("selector"))
        self.max_levels = int(g("max_levels"))
        self.min_coarse_rows = int(g("min_coarse_rows"))
        self.coarsen_threshold = float(g("coarsen_threshold"))
        self.cycle_type = str(g("cycle"))
        self.presweeps = int(g("presweeps"))
        self.postsweeps = int(g("postsweeps"))
        self.finest_sweeps = int(g("finest_sweeps"))
        self.coarsest_sweeps = int(g("coarsest_sweeps"))
        self.cycle_iters = int(g("cycle_iters"))
        self.aggressive_levels = int(g("aggressive_levels"))
        self.structure_reuse_levels = int(g("structure_reuse_levels"))
        #: the scaled coarse correction of non-classical levels (2: the
        #: λ minimising the residual 2-norm, 3: the error A-norm)
        self.error_scaling = int(g("error_scaling"))
        self.scaling_smoother_steps = int(g("scaling_smoother_steps"))
        #: the device setup engine (amg/device_setup/) for the host
        #: levels' Galerkin products
        self.device_setup = int(g("device_setup"))
        self.device_setup_min_rows = int(g("device_setup_min_rows"))
        self.device_setup_cache_mb = int(g("device_setup_cache_mb"))
        #: distributed coarse levels: below this many rows per active
        #: rank a coarse level agglomerates onto a P/factor sub-mesh
        #: (0 disables; :mod:`..distributed.agglomerate`)
        self.dist_agglomerate_min_rows = int(g("dist_agglomerate_min_rows"))
        self.dist_agglomerate_factor = int(g("dist_agglomerate_factor"))
        #: mixed precision (core/precision.py): the storage dtype of the
        #: level operators, smoother data and transfer packs from
        #: ``mixed_precision_from_level`` down; None inherits (a bf16
        #: fine-matrix device dtype implies the policy).  Setup math runs
        #: at f32 or wider; values narrow by a device cast or at upload
        self.hierarchy_dtype = resolve_dtype(str(g("hierarchy_dtype")))
        #: levels with at most this many rows (the first such level and
        #: every coarser one) compute on the CPU (reference
        #: amg_host_levels_rows, amg.h:169-173); -1 keeps all on the
        #: device.  ``host_from`` is the first host level's index
        #: (``num_levels()`` when there is none)
        self.host_levels_rows = int(g("amg_host_levels_rows"))
        self.host_from = 0
        self.mixed_from_level = int(g("mixed_precision_from_level"))
        self.print_grid_stats = bool(g("print_grid_stats"))
        #: convergence forensics (telemetry/forensics.py): the cycle
        #: writes its cut-point norms to this device tape
        self.forensics = int(g("forensics"))
        self.tape = None
        if self.forensics:
            from ..telemetry.forensics import Tape
            self.tape = Tape()
        self.levels: List[AMGLevel] = []
        self.coarsest: Optional[Matrix] = None
        self.coarse_solver = None
        self.coarse_solver_is_smoother = False
        #: the coarsening decisions of the levels, for structure reuse
        self._structure: Optional[list] = None
        #: the device refresh schedules of a classical hierarchy
        self._cla_plans: Optional[dict] = None
        #: how the last setup built the levels: "fresh", "dia_device",
        #: "classical_device" or "host_replay"
        self.last_resetup: Optional[str] = None
        #: host seconds of the per-rank distributed classical setup's
        #: steps (extend, strength, pmis, interpolation, rap, pack),
        #: summed over the levels of the last setup
        self.dist_timings: dict = {}

    # ------------------------------------------------------------------ setup
    def setup(self, A: Matrix):
        """A full setup; on a hierarchy already set up and configured with
        ``structure_reuse_levels`` ≠ 0, a values-only refresh of the
        recorded structure (``amg.cu:260-290``)."""
        t0 = time.perf_counter()
        reuse = self._structure is not None and \
            self.structure_reuse_levels != 0 and A.dist is None
        try:
            with cpu_profiler("amg_setup_reuse" if reuse
                              else "amg_setup"):
                if reuse:
                    self._setup_reuse(A)
                else:
                    self._setup_fresh(A)
        except BaseException:
            # a partial structure must never feed a later reuse pass
            self._structure = None
            self._cla_plans = None
            self.levels = []
            raise
        self.setup_time = time.perf_counter() - t0
        self._register_memledger()
        if telemetry.is_enabled():
            self._emit_telemetry()
            if self.forensics:
                # hierarchy quality probes (telemetry/forensics.py)
                with cpu_profiler("forensics_probes"), \
                        setup_profile.phase("probes"):
                    telemetry.forensics.probe_hierarchy(self)
        if self.print_grid_stats:
            # an informational table: verbosity level 2, as upstream
            amgx_output(self.grid_stats(), level=2)
        return self

    def _check_distributed(self, A: Matrix):
        """The precision policy skips the sharded levels of a distributed
        hierarchy, as upstream, with a warning."""
        if self.hierarchy_dtype is not None:
            amgx_output(f"WARNING: hierarchy_dtype={self.hierarchy_dtype} "
                        "skips the sharded levels of a distributed "
                        "matrix.\n")

    def _setup_fresh(self, A: Matrix):
        if A.dist is not None:
            self._check_distributed(A)
        self.dist_timings = {}
        self.levels = []
        self._structure = []
        self._cla_plans = None
        cur = self._build_levels(A)
        self._setup_smoothers_and_coarse(cur)
        if self.structure_reuse_levels != 0:
            with cpu_profiler("classical_resetup_plans"), \
                    setup_profile.phase("resetup_plan"):
                self._build_classical_plans(A, cur)
        self.last_resetup = "fresh"

    def _build_levels(self, cur: Matrix) -> Matrix:
        """The coarsening loop from ``cur``; returns the coarsest matrix
        (reference hot setup loop, ``amg.cu:177-450``)."""
        cur = self._build_dia_device(cur)
        if self.algorithm == "CLASSICAL":
            nxt = self._build_classical_device_pipeline(cur)
            if nxt is not None:
                cur = nxt
        while True:
            n = cur.n_block_rows
            if len(self.levels) + 1 >= self.max_levels or \
                    n <= self.min_coarse_rows:
                break
            with cpu_profiler(f"coarsen_level_{len(self.levels)}"), \
                    setup_profile.phase("coarsen", level=len(self.levels)):
                level, Ac, struct = self._coarsen_once(cur,
                                                       len(self.levels))
            if level is None:
                break
            nc = Ac.n_block_rows
            # coarsening-rate guard (amg.cu:394): stop when the grid
            # stops shrinking
            if nc >= self.coarsen_threshold * n or nc >= n or nc == 0:
                break
            self.levels.append(level)
            self._structure.append(struct)
            cur = Ac
        return cur

    def _dia_plan_inputs(self, cur: Matrix, max_diags: int = 48):
        """(offsets, host vals or None, dims or None, keep) of a
        DIA-eligible matrix — the structured-vs-pairwise gate; None when
        ``cur`` has no DIA decomposition."""
        if cur.block_dim != 1 or cur.n_block_rows < 2:
            return None
        n = cur.n_block_rows
        hint = getattr(cur, "_dia_offsets_hint", None)
        if hint is not None and getattr(cur, "_stencil_consistent", False):
            # device-generated stencils declare offsets and consistency
            # analytically: the plan never materialises host values
            offs = [int(o) for o in hint]
            if len(offs) > max_diags:
                return None
            dims = cur.grid_dims
            if dims is not None and int(np.prod(dims)) != n:
                dims = None
            if dims is None:
                dims = infer_grid_dims(offs, n)
            if dims is not None and max(dims) > 1 and \
                    decompose_offsets(offs, dims) is None:
                dims = None
            return offs, None, dims, None
        arrs = cur.dia_cache(max_diags)
        if arrs is None:
            return None
        offs, vals, keep = _drop_zero_diagonals(*arrs)
        dims = cur.grid_dims
        if dims is not None and int(np.prod(dims)) != n:
            dims = None
        if dims is None:
            dims = infer_grid_dims(offs, n)
        if dims is not None and max(dims) > 1:
            offs3 = decompose_offsets(offs, dims)
            if offs3 is None or \
                    not stencil_values_consistent(offs3, vals, dims):
                dims = None      # periodic/wrap stencil: decode is a lie
        return offs, vals, dims, keep

    def _build_dia_device(self, cur: Matrix) -> Matrix:
        """Plan every coarsening decision from the stencil structure,
        derive all coarse levels on the device, and append them; returns
        the coarsest planned matrix (``cur`` when nothing was planned)."""
        if self.algorithm != "AGGREGATION" or \
                self.selector not in ("GEO", "PAIRWISE") or \
                cur.dist is not None:
            return cur
        inputs = self._dia_plan_inputs(cur)
        if inputs is None:
            return cur
        offs, _, dims, keep = inputs
        steps, _ = plan_dia_hierarchy(
            offs, cur.n_block_rows, dims, self.max_levels,
            self.min_coarse_rows, self.coarsen_threshold,
            existing_levels=len(self.levels))
        if not steps:
            return cur
        with cpu_profiler("dia_device_derive"), \
                setup_profile.phase("dia_derive", kind="device"):
            outs = derive_hierarchy_device(
                steps, offs, _kept_rows(cur.device().vals, keep))
        return self._append_dia_levels(cur, steps, outs)

    def _append_dia_levels(self, cur: Matrix, steps, outs) -> Matrix:
        """Materialise planned levels around the derived (vals, diag,
        dinv); returns the coarsest matrix."""
        cur._dinv_dev = (cur.device().dtype, outs[0][1])
        for st, (vals_c, diag_c, dinv_c) in zip(steps, outs[1:]):
            idx = len(self.levels)
            if st.kind == "structured":
                level = StructuredLevel(cur, idx, st.dims, st.cdims)
                struct = ("structured", (st.dims,))
            else:
                level = PairwiseLevel(cur, idx, st.n)
                struct = ("pairwise", (st.n,))
            Ac = Matrix.from_dia_device(st.c_offsets, vals_c, diag_c, dinv_c)
            if st.kind == "structured":
                Ac.grid_dims = st.cdims
            self.levels.append(level)
            self._structure.append(struct)
            cur = Ac
        return cur

    # ------------------------------------------------- structure reuse
    def _setup_reuse(self, A: Matrix):
        """Keep the recorded coarsening structure and refresh the values
        (``structure_reuse_levels`` levels reuse it; the rest of the
        hierarchy is coarsened fresh from the last reused level,
        ``amg.cu:260-290``)."""
        cur = A
        old = list(zip(self.levels, self._structure))
        self.levels = []
        self._structure = []
        if self._reuse_classical_device(cur, old):
            self.last_resetup = "classical_device"
            return
        consumed, cur = self._reuse_dia_device(cur, old)
        replayed = False
        for i, (level, struct) in enumerate(old):
            if i < consumed:
                continue
            if 0 < self.structure_reuse_levels <= i:
                break
            kind, data = struct
            if kind == "aggregation":
                agg, nc = data
                # the engine's cached plan: a numeric pass only
                Ac_host = self._galerkin_agg(cur, agg)
                lvl = AggregationLevel(cur, i, agg, nc)
                nxt = _child_matrix(cur, Ac_host, block_dim=cur.block_dim)
            elif kind == "classical":
                P_host, = data
                R_host = sp.csr_matrix(P_host.T)
                Asc = cur.scalar_csr()
                # classical keeps the full symbolic pattern, so recorded
                # device plans stay applicable
                Ac_host = self._galerkin_classical(
                    cur, Asc, R_host, P_host,
                    keep_pattern=self.algorithm == "CLASSICAL")
                lvl = ClassicalLevel(cur, i, _child_matrix(cur, P_host),
                                     _child_matrix(cur, R_host),
                                     getattr(level, "cf_map", None))
                nxt = _child_matrix(cur, Ac_host)
            elif kind == "pairwise":
                # a level the device refresh did not derive: the host
                # pairwise step on the refreshed diagonals
                offs_c, vals_c = self._pairwise_numeric(
                    _narrow_dia(cur, _require_dia(cur)))
                lvl = PairwiseLevel(cur, i, data[0])
                nxt = _child_matrix_dia(cur, offs_c, vals_c)
            else:
                dims = tuple(data[0])
                offs, vals = _narrow_dia(cur, _require_dia(cur))
                offs3 = decompose_offsets(offs, dims)
                if offs3 is None or \
                        not stencil_values_consistent(offs3, vals, dims):
                    # a value-only refresh can light up a diagonal that
                    # was all-zero at setup, which the recorded decode
                    # never saw
                    raise BadConfigurationError(
                        "resetup: refreshed values no longer admit the "
                        "recorded structured stencil (a diagonal that was "
                        "all-zero at setup became coupled) — call setup() "
                        "for a structural rebuild")
                flat, vals_c, cdims = self._structured_numeric(
                    offs3, vals, dims)
                lvl = StructuredLevel(cur, i, dims, cdims)
                nxt = _child_matrix_dia(cur, flat, vals_c)
                nxt.grid_dims = cdims
            replayed = True
            self.levels.append(lvl)
            self._structure.append(struct)
            cur = nxt
        # the levels past the reused prefix are coarsened fresh
        cur = self._build_levels(cur)
        self._setup_smoothers_and_coarse(cur)
        plans = self._cla_plans
        if plans is not None and (
                len(self._structure) != len(plans["levels"])
                or any(s[0] != "classical" for s in self._structure)):
            self._cla_plans = None
        self.last_resetup = "host_replay" if replayed else \
            "dia_device" if consumed else "fresh"

    def _reuse_dia_device(self, cur: Matrix, old) -> tuple:
        """Refresh a reused structured/pairwise prefix on the device: the
        plan is made again from the refreshed fine values, and the
        longest prefix that matches the recorded structure is derived in
        one pass (:func:`~.dia_device.derive_hierarchy_device`).  Returns
        (levels consumed, coarsest matrix); (0, cur) leaves every level
        to the per-level replay."""
        prefix = []
        for i, (_, struct) in enumerate(old):
            if 0 < self.structure_reuse_levels <= i or \
                    struct[0] not in ("structured", "pairwise"):
                break
            prefix.append(struct)
        if not prefix or self.algorithm != "AGGREGATION" or \
                self.selector not in ("GEO", "PAIRWISE"):
            return 0, cur
        inputs = self._dia_plan_inputs(cur)
        if inputs is None:
            return 0, cur
        offs, _, dims, keep = inputs
        steps, _ = plan_dia_hierarchy(
            offs, cur.n_block_rows, dims, self.max_levels,
            self.min_coarse_rows, self.coarsen_threshold)
        matched = 0
        for st, (kind, data) in zip(steps, prefix):
            if st.kind != kind or \
                    (kind == "structured" and st.dims != tuple(data[0])) \
                    or (kind == "pairwise" and st.n != data[0]):
                break
            matched += 1
        curd = cur.device()
        if matched == 0 or curd.fmt != "dia":
            return 0, cur
        steps = steps[:matched]
        outs = derive_hierarchy_device(steps, offs,
                                       _kept_rows(curd.vals, keep))
        return matched, self._append_dia_levels(cur, steps, outs)

    def _build_classical_plans(self, A: Matrix, coarsest: Matrix):
        """The device refresh schedules of a classical hierarchy
        (:mod:`.classical.resetup_device`), built only when structure
        reuse is configured, so a later resetup refreshes every Galerkin
        product on the device (``csr_multiply.h:100-126``)."""
        if not self.levels or \
                not all(s[0] == "classical" for s in self._structure):
            return
        if 0 < self.structure_reuse_levels < len(self.levels):
            # partial reuse coarsens a suffix fresh: no plan would serve
            return
        Ad = A.device()
        if Ad.fmt != "dia" or Ad.block_dim != 1:
            return
        from .classical.resetup_device import (build_level_plan,
                                               fine_dia_to_csr_map)
        fine_csr = A.scalar_csr()
        try:
            fine_map = fine_dia_to_csr_map(fine_csr, Ad.dia_offsets)
        except ValueError:
            return
        plans = []
        cur_csr = fine_csr
        for i, (_, (P_host,)) in enumerate(self._structure):
            nxt = self.levels[i + 1].A if i + 1 < len(self.levels) \
                else coarsest
            Ac_csr = sp.csr_matrix(nxt.host)
            # the engine's plan of this product, when it cached one,
            # serves without a second symbolic pass
            plan = build_level_plan(cur_csr, P_host, Ac_csr,
                                    template=nxt.device(),
                                    plan=self._cached_galerkin_plan(
                                        cur_csr, P_host))
            if plan is None:
                return
            plans.append(plan)
            cur_csr = Ac_csr
        # the DIA slots the recorded CSR pattern maps: a resetup value
        # outside them takes the host replay (no schedule carries it)
        mask = np.zeros(len(Ad.dia_offsets) * A.n_block_rows, dtype=bool)
        mask[fine_map] = True
        self._cla_plans = dict(levels=plans,
                               fine_offsets=tuple(Ad.dia_offsets),
                               fine_n=A.n_block_rows, fine_map=fine_map,
                               fine_map_dev=None, fine_mask=mask)

    def _reuse_classical_device(self, cur: Matrix, old) -> bool:
        """Values-only refresh of a fully reused classical hierarchy on
        the device: two ordered segment sums per level, no host Galerkin
        product.  False sends the resetup down the host replay (partial
        reuse, other offsets or size, a value outside the recorded
        pattern, no plans)."""
        plans = self._cla_plans
        if not plans or len(plans["levels"]) != len(old):
            return False
        if 0 < self.structure_reuse_levels < len(old) or \
                any(struct[0] != "classical" for _, struct in old):
            return False
        curd = cur.device()
        if curd.fmt != "dia" or curd.block_dim != 1 or \
                tuple(curd.dia_offsets) != plans["fine_offsets"] or \
                cur.n_block_rows != plans["fine_n"]:
            return False
        arrs = cur.dia_cache()
        if arrs is None or tuple(arrs[0]) != plans["fine_offsets"] or \
                np.any(arrs[1].reshape(-1)[~plans["fine_mask"]]):
            # a value lit up a slot the recorded pattern never mapped:
            # the host replay recomputes the patterns
            return False
        from .classical.resetup_device import (assemble_refreshed_matrix,
                                               refresh_level)
        if plans["fine_map_dev"] is None or \
                plans["fine_map_dev"].device != curd.vals.device:
            plans["fine_map_dev"] = torch.from_numpy(
                plans["fine_map"]).to(curd.vals.device)
        vA = curd.vals.reshape(-1)[plans["fine_map_dev"]]
        for i, (level, struct) in enumerate(old):
            plan = plans["levels"][i]
            vAc, fields = refresh_level(plan, vA)
            nxt = assemble_refreshed_matrix(plan, vAc, fields)
            self.levels.append(ClassicalLevel(cur, i, level._P, level._R,
                                              level.cf_map))
            self._structure.append(struct)
            cur, vA = nxt, vAc
        self._setup_smoothers_and_coarse(cur)
        return True

    # ------------------------------------------ classical: device pipeline
    _PIPELINE_TAIL_ROWS = 4096

    def _pipeline_tail_rows(self) -> int:
        v = os.environ.get("AMGX_PIPELINE_TAIL_ROWS")
        return int(v) if v else self._PIPELINE_TAIL_ROWS

    def _param(self, name):
        return self.cfg.get(name, self.scope)

    def _classical_params(self, sname: str = None,
                          interp: str = None) -> dict:
        """The device classical paths' parameters; ``sname``/``interp``
        are the effective strength and interpolator names (default: the
        configured ones)."""
        sname = sname or str(self._param("strength"))
        interp = interp or str(self._param("interpolator"))
        return dict(
            theta=float(self._param("strength_threshold")),
            max_row_sum=float(self._param("max_row_sum")),
            strength_all=sname == "ALL", interp_d2=interp == "D2",
            trunc_factor=float(self._param("interp_truncation_factor")),
            max_elements=int(self._param("interp_max_elements")))

    def _device_classical_inputs(self, cur: Matrix, sel_name: str,
                                 interp_name: str, sname: str):
        """Static gates shared by both device classical paths (the
        pipeline and the device fine level), on the effective names a
        level coarsens with: PMIS, D1/D2, AHAT/ALL strength, a DIA pack
        of at most 16 two-sided diagonals and, for D2, an A-hat plan of
        at most 48 offsets.  Returns ``(offsets, dvals)`` — the device
        values of the kept diagonals — or None (host path)."""
        if sel_name != "PMIS" or interp_name not in ("D1", "D2") or \
                sname not in ("AHAT", "ALL"):
            return None
        inputs = self._dia_plan_inputs(cur, max_diags=16)
        if inputs is None:
            return None
        offs, _, _, keep = inputs
        if any(-o not in offs for o in offs):
            # the device PMIS symmetrises the strength graph through the
            # opposite-offset rows: a one-sided stencil takes the host path
            return None
        from .classical.device_fine import ahat_plan
        if interp_name == "D2" and len(ahat_plan(offs)[0]) > 48:
            return None
        curd = cur.device()
        if curd.fmt != "dia":
            return None
        return offs, _kept_rows(curd.vals, keep)

    def _classical_pipeline_eligible(self, cur: Matrix):
        """Gates of the fully-device classical pipeline; returns the
        ``(offsets, dvals)`` inputs or None (host path)."""
        if os.environ.get("AMGX_NO_DEVICE_PIPELINE") == "1":
            return None
        if cur.dist is not None or cur.block_dim != 1:
            return None
        if self.structure_reuse_levels != 0 or self.aggressive_levels:
            # a reuse-configured setup takes the host loop, whose levels
            # the resetup plans can refresh
            return None
        if self.error_scaling in (2, 3):
            return None
        if len(self.levels) + 1 >= self.max_levels or \
                cur.n_block_rows <= max(self.min_coarse_rows,
                                        self._pipeline_tail_rows()):
            return None
        # smoothers that set up from the device pack alone
        if str(self._param("smoother")) not in ("JACOBI_L1", "BLOCK_JACOBI",
                                                "JACOBI"):
            return None
        if self.cycle_type not in ("V", "W", "F"):
            return None
        return self._device_classical_inputs(
            cur, str(self._param("selector")),
            str(self._param("interpolator")), str(self._param("strength")))

    def _build_classical_device_pipeline(self, cur: Matrix):
        """Fully-device classical setup: the fine level coarsens by shift
        algebra into an embedded level 1 (applied as ``ComposedDIA``),
        deeper levels by the compact sort-algebra pipeline, until the
        tail is handed to the host loop.  Returns the tail matrix, or
        None when a gate sends the whole setup down the host loop."""
        elig = self._classical_pipeline_eligible(cur)
        if elig is None:
            return None
        offs, dvals = elig
        curd = cur.device()
        params = self._classical_params()
        # memory guard: the embedded RAP materialises (candidate Δ, n) —
        # about 2.9 GB at 128³ in f32; past 8 GB the host loop takes over
        from .classical.device_fine import ahat_plan
        from ..ops.spgemm import rap_candidate_offsets
        p_offs = ahat_plan(offs)[0] if params["interp_d2"] else offs
        n_cand = len(rap_candidate_offsets(offs, p_offs))
        itemsize = compute_dtype(
            np.dtype(cur.device_dtype or cur.dtype)).itemsize
        if n_cand * cur.n_block_rows * itemsize > (8 << 30):
            return None
        from ..ops.device_pack import device_ell_matrix
        from .classical.device_coarse import coarsen_compact
        from .classical.device_pipeline import coarsen_fine_embedded
        n = cur.n_block_rows
        res = coarsen_fine_embedded(offs, dvals, n, seed=_TIEBREAK_SEED,
                                    **params)
        if res is None or res.nc >= self.coarsen_threshold * n or \
                res.nc <= max(self.min_coarse_rows,
                              self._pipeline_tail_rows()):
            return None
        # ---- level 0: P/R as embedded DIA packs
        h0 = res.p_offs.index(0)
        P0 = dia_device_matrix(res.p_offs, res.P_rows, res.P_rows[h0],
                               n_cols=n)
        r_offs = tuple(-o for o in res.p_offs[::-1])
        R0 = dia_device_matrix(r_offs, torch.flip(res.R_rows, [0]),
                               res.P_rows[h0], n_cols=n)
        lvl0 = ClassicalLevel(cur, len(self.levels), P0, R0, None)
        self._structure.append(("classical-device", ()))
        nnz1 = int(host_scalar(torch.count_nonzero(res.A_vals)))
        # the solve applies level 1 as the Galerkin composition
        # R·(A·(P·x)): three DIA streams instead of one low-fill embedded
        # matrix of ~200 offsets
        A1m = Matrix.from_device_pack(ComposedDIA(
            P=P0, A=curd, R=R0, diag=res.diag, l1row=res.l1row, n_rows=n,
            n_cols=n), nnz_hint=nnz1, logical_rows=res.nc)
        A1m._dinv_dev = (res.dinv.dtype, res.dinv)
        res.A_vals = None
        self.levels.append(lvl0)
        # ---- compact continuation
        cur_m, cols, vals, n_log = A1m, res.cols, res.vals, res.nc
        foc = res.foc            # embedded ↔ compact map of level 1
        while True:
            if len(self.levels) + 1 >= self.max_levels or \
                    n_log <= max(self.min_coarse_rows,
                                 self._pipeline_tail_rows()):
                break
            out = coarsen_compact(cols, vals, n_log, seed=_TIEBREAK_SEED,
                                  **params)
            if out is None or out.nc >= self.coarsen_threshold * n_log \
                    or out.nc >= n_log:
                break
            nb, Kpx = out.P_cols.shape
            if foc is not None:
                # embedded boundary: P rows live at the C points' fine
                # indices; R columns address the embedded vector (pad
                # foc entries, == n, are dropped)
                ok = foc < n
                rows = foc[ok].long()
                pce = torch.zeros((n, Kpx), dtype=torch.int32,
                                  device=cols.device)
                pve = torch.zeros((n, Kpx), dtype=vals.dtype,
                                  device=vals.device)
                pce[rows] = out.P_cols[ok]
                pve[rows] = out.P_vals[ok]
                rc_src = torch.where(
                    out.R_cols >= 0,
                    foc[torch.clamp(out.R_cols, min=0).long()], -1)
                p_rows_space = n
            else:
                pce, pve = out.P_cols, out.P_vals
                rc_src = out.R_cols
                p_rows_space = nb
            Pd = device_ell_matrix(pce, pve, p_rows_space, out.ncb2,
                                   square_diag=False)
            Rd = device_ell_matrix(rc_src, out.R_vals, out.ncb2,
                                   p_rows_space, square_diag=False)
            lvl = ClassicalLevel(cur_m, len(self.levels), Pd, Rd, None)
            self._structure.append(("classical-device", ()))
            Acd = device_ell_matrix(out.Ac_cols, out.Ac_vals, out.ncb2,
                                    out.ncb2)
            nxt = Matrix.from_device_pack(
                Acd, nnz_hint=int(host_scalar(
                    torch.count_nonzero(out.Ac_vals))),
                logical_rows=out.nc)
            self.levels.append(lvl)
            cur_m, cols, vals, n_log = nxt, out.Ac_cols, out.Ac_vals, \
                out.nc
            foc = None
        if cur_m is A1m:
            # no compact level (degenerate coarsening right below the
            # fine level): a host continuation would need the embedded
            # matrix — unwind and let the host loop redo the setup
            self.levels.pop()
            self._structure.pop()
            return None
        # ---- tail: the small padded matrix goes to the host loop
        cur_m._host = self._compact_to_host(cols, vals)
        cur_m.dtype = np.dtype(np.float64)
        return cur_m

    @staticmethod
    def _compact_to_host(cols, vals) -> sp.csr_matrix:
        """Download a compact device ELL level into a host CSR (f64: the
        host tail and the dense coarse factorisation run at setup
        precision, as for an uploaded matrix)."""
        from ..device import to_host
        cc, cv = to_host(cols, vals)
        cv = cv.astype(np.float64)
        nb, K = cc.shape
        rows = np.repeat(np.arange(nb), K)
        flat_c = cc.reshape(-1)
        flat_v = cv.reshape(-1)
        keepm = (flat_v != 0) | (flat_c == rows)
        M = sp.csr_matrix((flat_v[keepm], (rows[keepm], flat_c[keepm])),
                          shape=(nb, nb))
        M.sum_duplicates()
        M.sort_indices()
        return M

    # ------------------------------------------------ classical: host loop
    def _coarsen_classical_device_fine(self, cur: Matrix, idx: int,
                                       sname: str, sel_name: str,
                                       interp_name: str):
        """Device classical coarsening of a DIA-eligible level
        (:mod:`.classical.device_fine`) with the Galerkin product of the
        host loop; None when a gate fails (the host path is the
        fallback)."""
        inputs = self._device_classical_inputs(cur, sel_name, interp_name,
                                               sname)
        if inputs is None:
            return None
        offs, dvals = inputs
        from .classical.device_fine import classical_fine_device
        p = self._classical_params(sname, interp_name)
        cf_map, P_host = classical_fine_device(
            offs, dvals, cur.n_block_rows, p["theta"], p["max_row_sum"],
            p["strength_all"], p["interp_d2"], p["trunc_factor"],
            p["max_elements"], _TIEBREAK_SEED)
        nc = int(cf_map.sum())
        if nc == 0 or nc >= cur.n_block_rows:
            return None, None, None
        Asc = cur.scalar_csr()
        P_host = P_host.astype(Asc.dtype)
        R_host = sp.csr_matrix(P_host.T)
        Ac_host = self._galerkin_classical(
            cur, Asc, R_host, P_host,
            keep_pattern=self.structure_reuse_levels != 0)
        level = ClassicalLevel(cur, idx, _child_matrix(cur, P_host),
                               _child_matrix(cur, R_host), cf_map)
        return level, _child_matrix(cur, Ac_host), ("classical", (P_host,))

    # ---------------------------------------------- aggregation: host loop
    def _coarsen_aggregation(self, cur: Matrix, idx: int):
        """One aggregation step of the host loop (``_coarsen_once``
        upstream, single device): the host structured/pairwise step for
        a DIA level under GEO, else the selector on the host CSR (on a
        block system its condensed graph), the Galerkin product through
        the engine, an :class:`AggregationLevel`."""
        from .aggregation.selectors import create_selector
        name = self.selector
        if name == "PAIRWISE":       # alias of the structured GEO path
            name = "GEO"
        if cur.dist is not None:
            # per rank; GEO keeps its name (no structured step on a
            # sharded level), as upstream (``hierarchy.py:989-997``)
            return self._coarsen_aggregation_dist(
                cur, idx, create_selector(name, self.cfg, self.scope))
        if name == "GEO" and cur.block_dim == 1:
            out = self._coarsen_pairwise(cur, idx)
            if out is not _PAIRWISE_FALLBACK:
                return out
            if cur.geometry is None:
                name = "SIZE_2"      # irregular and no coordinates
        selector = create_selector(name, self.cfg, self.scope)
        Asc = cur.scalar_csr() if cur.block_dim == 1 else \
            _block_condensed(cur)
        geom = cur.geometry
        if geom is not None:
            # attached per-row coordinates feed the GEO selector
            # (AMGX_matrix_attach_geometry → geo_selector.cu)
            Asc._amgx_geometry = geom
        with setup_profile.phase("selector", level=idx):
            agg = selector.select(Asc)
        nc = int(agg.max()) + 1 if len(agg) else 0
        if nc == 0:
            return None, None, None
        with setup_profile.phase("rap", level=idx):
            Ac_host = self._galerkin_agg(cur, agg)
        level = AggregationLevel(cur, idx, agg, nc)
        Ac = _child_matrix(cur, Ac_host, block_dim=cur.block_dim)
        if geom is not None:
            # coarse coordinates: the aggregate centroids, so GEO keeps
            # aggregating geometrically below the fine level
            cnt = np.bincount(agg, minlength=nc).astype(np.float64)
            Ac.geometry = tuple(
                np.bincount(agg, weights=np.asarray(c, np.float64),
                            minlength=nc) / np.maximum(cnt, 1)
                for c in geom)
        return level, Ac, ("aggregation", (agg, nc))

    def _coarsen_aggregation_dist(self, cur: Matrix, idx: int, selector):
        """Distributed aggregation coarsening, per rank end to end
        (``_coarsen_aggregation_dist`` upstream, ``hierarchy.py:
        1344-1490``): each rank aggregates its own diagonal block, coarse
        ids are rank-contiguous, and rank p's coarse rows come from its
        row block, its halo columns resolved through the global
        aggregate ids (the engine's rectangular form, the host COO remap
        after a decline).  A coarse grid too small per rank consolidates:
        onto a sub-mesh of the first ranks, or off the mesh onto one
        replicated level (``trash_segment``).  The coarse level is again
        a block-distributed :class:`Matrix`."""
        from ..distributed.agglomerate import (active_parts, plan_for,
                                               redistribute_blocks)
        mesh, axis, _, _ = cur.dist
        curd = cur.device()
        offsets = np.asarray(curd.offsets)
        n_parts = curd.n_parts
        n = int(offsets[-1])
        blocks = cur.rank_blocks()
        agg_real = np.empty(n, dtype=np.int64)
        counts = []
        base = 0
        for p in range(n_parts):
            lo, hi = offsets[p], offsets[p + 1]
            if hi == lo:
                counts.append(0)
                continue
            agg_p = selector.select(sp.csr_matrix(blocks[p][:, lo:hi]))
            agg_real[lo:hi] = agg_p + base
            cnt = int(agg_p.max()) + 1 if len(agg_p) else 0
            counts.append(cnt)
            base += cnt
        nc = base
        if nc == 0 or nc >= n:
            return None, None, None
        coarse_offsets = np.concatenate([[0], np.cumsum(counts)])
        eng = self._engine()

        def coarse_block(p):
            lo, hi = offsets[p], offsets[p + 1]
            if eng is not None and hi > lo and blocks[p].nnz:
                C = eng.galerkin_agg(
                    blocks[p], agg_real[lo:hi] - coarse_offsets[p],
                    dtype=blocks[p].dtype, agg_cols=agg_real,
                    shape=(counts[p], nc), **self._engine_args(cur))
                if C is not None:
                    return sp.csr_matrix(C.astype(blocks[p].dtype))
            coo = blocks[p].tocoo()
            C = sp.csr_matrix(
                (coo.data, (agg_real[coo.row + lo] - coarse_offsets[p],
                            agg_real[coo.col])), shape=(counts[p], nc))
            C.sum_duplicates()
            C.sort_indices()
            return C

        c_blocks = [coarse_block(p) for p in range(n_parts)]

        # consolidation (the reference's "glue", distributed/glue.h and
        # amg.cu:328-390): the legacy thresholds, else the planner
        lower = int(self.cfg.get("matrix_consolidation_lower_threshold"))
        agg_min = self.dist_agglomerate_min_rows
        n_loc_f = curd.n_loc
        p_active = plan = None
        if lower > 0 and nc // n_parts < lower:
            upper = max(int(self.cfg.get(
                "matrix_consolidation_upper_threshold")), 1)
            p_active = min(n_parts, max(1, -(-nc // upper)))
        elif agg_min > 0 and nc // max(n_parts, 1) < agg_min:
            plan = plan_for(coarse_offsets, agg_min,
                            self.dist_agglomerate_factor, level=idx)
            if plan is not None:
                p_active = plan.p_active
        if p_active is not None:
            if p_active <= 1:
                # fully consolidated: one replicated coarse level; the
                # fine padding rows go to the dropped segment nc
                Ac = _child_matrix(cur, sp.csr_matrix(sp.vstack(c_blocks)))
                agg_pad = np.full(n_parts * n_loc_f, nc, dtype=np.int64)
                for p in range(n_parts):
                    lo, hi = offsets[p], offsets[p + 1]
                    agg_pad[p * n_loc_f:p * n_loc_f + (hi - lo)] = \
                        agg_real[lo:hi]
                level = AggregationLevel(cur, idx, agg_pad, n_coarse=nc,
                                         trash_segment=True,
                                         real=agg_pad < nc)
                level.submesh_parts = 1
                return level, Ac, ("aggregation-consolidated",
                                   (agg_real, nc))
            # a sub-mesh: the coarse rows re-bucketed onto the first
            # p_active ranks; the others hold only padding
            if plan is not None:
                coarse_offsets = np.asarray(plan.dst_offsets)
                c_blocks = redistribute_blocks(c_blocks, plan)
            else:
                nc_act = -(-nc // p_active)
                coarse_offsets = np.concatenate([
                    np.minimum(np.arange(p_active + 1) * nc_act, nc),
                    np.full(n_parts - p_active, nc, dtype=np.int64)])
                c_blocks = _rebucket_blocks(c_blocks, coarse_offsets)

        nc_loc = int(np.max(np.diff(coarse_offsets))) + 1  # ≥ 1 pad slot
        Ac = Matrix(device=cur.placement)
        Ac.set_distributed_blocks(c_blocks, coarse_offsets, mesh, axis=axis)
        Ac.set_distribution(mesh, axis, coarse_offsets, n_loc=nc_loc)
        Ac.device_dtype = cur.device_dtype
        # aggregates in padded coordinates: a fine padding row maps to
        # its rank's coarse padding slot
        own = np.searchsorted(coarse_offsets, np.arange(nc),
                              side="right") - 1
        pad_of = own * nc_loc + (np.arange(nc) - coarse_offsets[own])
        agg_pad = np.empty(n_parts * n_loc_f, dtype=np.int64)
        real = np.zeros(n_parts * n_loc_f, dtype=bool)
        for p in range(n_parts):
            lo, hi = offsets[p], offsets[p + 1]
            row = np.full(n_loc_f, p * nc_loc + nc_loc - 1, dtype=np.int64)
            row[:hi - lo] = pad_of[agg_real[lo:hi]]
            agg_pad[p * n_loc_f:(p + 1) * n_loc_f] = row
            real[p * n_loc_f:p * n_loc_f + (hi - lo)] = True
        level = AggregationLevel(cur, idx, agg_pad,
                                 n_coarse=n_parts * nc_loc, real=real)
        level.submesh_parts = active_parts(coarse_offsets)
        return level, Ac, ("aggregation-dist", (agg_real, nc))

    def _coarsen_pairwise(self, cur: Matrix, idx: int,
                          max_diags: int = 48):
        """The host structured/pairwise step (GEO on a DIA level the
        device plan did not take): DIA in, DIA out, reshape transfers;
        ``_PAIRWISE_FALLBACK`` when the level has no DIA decomposition
        within ``max_diags`` (the caller retries with a matching
        selector)."""
        if cur.n_block_rows < 2:
            return None, None, None
        inputs = self._dia_plan_inputs(cur, max_diags)
        if inputs is None:
            return _PAIRWISE_FALLBACK
        offs_raw, vals_raw, dims, _ = inputs
        if vals_raw is None:        # hint-gated plan: the host needs values
            vals_raw = cur.dia_cache(max_diags)[1]
        arrs = _narrow_dia(cur, (offs_raw, vals_raw))
        offs, vals = arrs
        if dims is not None and max(dims) > 1:
            offs3 = decompose_offsets(offs, dims)
            if offs3 is not None:
                out = self._structured_numeric(offs3, vals, dims)
                if out is not None:
                    flat, vals_c, cdims = out
                    level = StructuredLevel(cur, idx, dims, cdims)
                    Ac = _child_matrix_dia(cur, flat, vals_c)
                    Ac.grid_dims = cdims
                    return level, Ac, ("structured", (dims,))
        offs_c, vals_c = self._pairwise_numeric(arrs)
        level = PairwiseLevel(cur, idx, cur.n_block_rows)
        return level, _child_matrix_dia(cur, offs_c, vals_c), \
            ("pairwise", (cur.n_block_rows,))

    @staticmethod
    def _structured_numeric(offs3, vals, dims):
        """The host structured Galerkin product; None when the coarse
        grid would not shrink.  Returns (flat offsets, vals, cdims)."""
        cdims = coarse_dims(dims)
        if int(np.prod(cdims)) >= int(np.prod(dims)):
            return None
        return structured_galerkin(offs3, vals, dims)

    @staticmethod
    def _pairwise_numeric(arrs):
        """The host pairwise Galerkin product, DIA in and DIA out (fresh
        setup and structure reuse)."""
        offs, vals = arrs
        return pairwise_galerkin_dia(offs, vals)

    def _coarsen_once(self, cur: Matrix, idx: int):
        """One host-loop coarsening step: ``(level, coarse matrix, its
        structure record)``, or ``(None, None, None)`` when the coarse
        grid degenerates."""
        if self.algorithm == "AGGREGATION":
            return self._coarsen_aggregation(cur, idx)
        if self.algorithm not in ("CLASSICAL", "ENERGYMIN"):
            raise BadConfigurationError(
                f"unknown AMG algorithm {self.algorithm!r}")
        if cur.block_dim != 1:
            raise BadConfigurationError(
                "classical AMG requires block_dim=1 (use AGGREGATION for "
                "block systems), as in the reference defaults")
        from .classical.interpolators import create_interpolator
        from .classical.selectors import create_cf_selector
        from .classical.strength import create_strength
        sname = str(self._param("strength"))
        strength = create_strength(sname, self.cfg, self.scope)
        sel_name = str(self._param("selector"))
        interp_name = str(self._param("interpolator"))
        if self.algorithm == "ENERGYMIN":
            sel_name = str(self._param("energymin_selector"))
            interp_name = str(self._param("energymin_interpolator"))
        if idx < self.aggressive_levels:
            # aggressive coarsening on the first levels switches the
            # selector and interpolator (classical_amg_level.cu:155-201)
            asel = str(self._param("aggressive_selector"))
            if asel == "DEFAULT":
                asel = sel_name if sel_name.startswith("AGGRESSIVE") \
                    else "AGGRESSIVE_" + sel_name
            sel_name = asel
            interp_name = str(self._param("aggressive_interpolator"))
        if cur.dist is not None:
            # per-rank distributed classical setup: no global matrix
            # (classical_amg_level.cu:240-340)
            out = self._coarsen_classical_dist(cur, idx, strength,
                                               sel_name, interp_name)
            if out is not None:
                return out
        elif self.algorithm == "CLASSICAL":
            # a DIA level runs strength, PMIS and interpolation on the
            # device when its effective names allow it
            out = self._coarsen_classical_device_fine(
                cur, idx, sname, sel_name, interp_name)
            if out is not None:
                return out
        Asc = cur.scalar_csr()
        with setup_profile.phase("strength", level=idx):
            S = strength.compute(Asc)
        with setup_profile.phase("selector", level=idx):
            cf_map = create_cf_selector(sel_name, self.cfg, self.scope) \
                .select(S)
        nc = int(cf_map.sum())
        if nc == 0 or nc >= Asc.shape[0]:
            return None, None, None
        interp = create_interpolator(interp_name, self.cfg, self.scope)
        with setup_profile.phase("interpolation", level=idx):
            P_host = interp.compute(Asc, S, cf_map).astype(Asc.dtype)
        R_host = sp.csr_matrix(P_host.T)
        if cur.dist is not None:
            return self._classical_dist_fallback(cur, idx, Asc, P_host,
                                                 R_host)
        with setup_profile.phase("rap", level=idx):
            Ac_host = self._galerkin_classical(
                cur, Asc, R_host, P_host,
                keep_pattern=self.algorithm == "CLASSICAL"
                and self.structure_reuse_levels != 0)
        level = ClassicalLevel(cur, idx, _child_matrix(cur, P_host),
                               _child_matrix(cur, R_host), cf_map)
        return level, _child_matrix(cur, Ac_host), ("classical", (P_host,))

    def _classical_dist_fallback(self, cur: Matrix, idx: int, Asc, P_host,
                                 R_host):
        """The JAX package's global fallback of a distributed classical
        level (a selector other than PMIS, an interpolator other than
        D1/D2, a strength that is not row-local; ``hierarchy.py:
        1086-1110`` upstream): the scipy triple product, the coarse
        matrix distributed over equal row blocks, P and R embedded into
        the padded vector spaces (:func:`~..distributed.matrix.
        embed_padded`) as one-device packs."""
        from ..distributed.matrix import embed_padded
        mesh, axis, _, _ = cur.dist
        Ac_host = sp.csr_matrix(R_host @ Asc @ P_host).astype(Asc.dtype)
        Ac_host.sum_duplicates()
        Ac_host.sort_indices()
        curd = cur.device()
        f_off = np.asarray(curd.offsets)
        nc = P_host.shape[1]
        n_parts = curd.n_parts
        c_nloc = -(-nc // n_parts)
        c_off = np.minimum(np.arange(n_parts + 1) * c_nloc, nc)
        P_pad = embed_padded(P_host, f_off, curd.n_loc, c_off, c_nloc)
        R_pad = sp.csr_matrix(P_pad.T)
        Ac = _child_matrix(cur, Ac_host)
        Ac.set_distribution(mesh, axis, c_off, n_loc=c_nloc)
        level = ClassicalLevel(cur, idx, _child_matrix(cur, P_pad).device(),
                               _child_matrix(cur, R_pad).device(), None)
        return level, Ac, ("classical", (P_host,))

    def _coarsen_classical_dist(self, cur: Matrix, idx: int, strength,
                                sel_name: str, interp_name: str):
        """Per-rank distributed classical coarsening
        (``_coarsen_classical_dist`` upstream, ``hierarchy.py:1119-1212``;
        :mod:`.classical.distributed`): per-rank strength and PMIS with
        exchanged halo C/F states (the device pipeline's tie-break seed),
        per-rank P rows through the ring-2 extended blocks, per-rank RAP
        partials summed by their owners, the agglomeration planner, and
        sharded rectangular P/R packs.  None when the configuration needs
        the global fallback (a strength that is not row-local, a selector
        other than PMIS, an interpolator other than D1/D2).  The host
        seconds of each step accumulate in ``dist_timings``."""
        if sel_name != "PMIS" or interp_name not in ("D1", "D2"):
            return None
        if getattr(type(strength), "config_name", "") not in ("AHAT",
                                                              "ALL"):
            return None
        from ..distributed.agglomerate import (active_parts, plan_for,
                                               redistribute_blocks)
        from ..distributed.matrix import shard_matrix_from_blocks
        from ..distributed.partition import build_partition_from_blocks
        from .classical.distributed import (RankExtended,
                                            coarse_numbering_distributed,
                                            interpolate_distributed,
                                            pmis_distributed,
                                            rap_distributed,
                                            strength_distributed)
        from .classical.interpolators import create_interpolator
        tm = self.dist_timings
        t0 = time.perf_counter()
        mesh, axis, _, _ = cur.dist
        curd = cur.device()
        offsets = np.asarray(curd.offsets)
        n_parts = curd.n_parts
        n = int(offsets[-1])
        blocks = cur.rank_blocks()
        part = build_partition_from_blocks(blocks, offsets, n_rings=2)
        exts = [RankExtended(p, blocks, part) for p in range(n_parts)]
        t1 = time.perf_counter()
        S_U = strength_distributed(exts, [strength] * n_parts)
        t2 = time.perf_counter()
        cf_loc, ex = pmis_distributed(exts, S_U, n, _TIEBREAK_SEED)
        t3 = time.perf_counter()
        tm["extend"] = tm.get("extend", 0.0) + t1 - t0
        tm["strength"] = tm.get("strength", 0.0) + t2 - t1
        tm["pmis"] = tm.get("pmis", 0.0) + t3 - t2
        nc = int(sum(int(c.sum()) for c in cf_loc))
        if nc == 0 or nc >= n:
            return None, None, None
        c_off, cf_U, cnum_U = coarse_numbering_distributed(exts, cf_loc,
                                                           n, ex)
        interp = create_interpolator(interp_name, self.cfg, self.scope)
        P_blocks = interpolate_distributed(exts, interp, cf_U, cnum_U,
                                           S_U, nc)
        dtype = np.dtype(blocks[0].dtype)
        P_blocks = [sp.csr_matrix(Pb.astype(dtype)) for Pb in P_blocks]
        t4 = time.perf_counter()
        tm["interpolation"] = tm.get("interpolation", 0.0) + t4 - t3
        args = self._engine_args(cur)
        c_blocks, r_blocks = rap_distributed(
            blocks, P_blocks, part, c_off, engine=self._engine(),
            dtype=dtype, device=args["device"], min_rows=args["min_rows"],
            budget_bytes=args["budget_bytes"])
        c_blocks = [sp.csr_matrix(cb.astype(dtype)) for cb in c_blocks]
        t5 = time.perf_counter()
        tm["rap"] = tm.get("rap", 0.0) + t5 - t4
        # coarse-level agglomeration: below dist_agglomerate_min_rows
        # rows per active rank the coarse level moves onto a sub-mesh
        submesh = None
        if self.dist_agglomerate_min_rows > 0:
            plan = plan_for(c_off, self.dist_agglomerate_min_rows,
                            self.dist_agglomerate_factor, level=idx)
            if plan is not None:
                c_blocks = redistribute_blocks(c_blocks, plan)
                r_blocks = redistribute_blocks(r_blocks, plan)
                c_off = np.asarray(plan.dst_offsets)
                submesh = plan.p_active
        nc_loc = max(int(np.max(np.diff(c_off))), 1)
        Ac = Matrix(device=cur.placement)
        Ac.set_distributed_blocks(c_blocks, c_off, mesh, axis=axis)
        Ac.set_distribution(mesh, axis, c_off, n_loc=nc_loc)
        Ac.device_dtype = cur.device_dtype
        ddtype = np.dtype(cur.device_dtype or cur.dtype)
        Pd = shard_matrix_from_blocks(
            P_blocks, offsets, mesh, axis=axis, dtype=ddtype,
            n_loc=curd.n_loc, col_offsets=c_off, n_loc_cols=nc_loc)
        Rd = shard_matrix_from_blocks(
            r_blocks, c_off, mesh, axis=axis, dtype=ddtype,
            n_loc=nc_loc, col_offsets=offsets, n_loc_cols=curd.n_loc)
        tm["pack"] = tm.get("pack", 0.0) + time.perf_counter() - t5
        level = ClassicalLevel(cur, idx, Pd, Rd, None)
        level.submesh_parts = submesh if submesh is not None else \
            active_parts(c_off)
        return level, Ac, ("classical-dist", (nc,))

    # ------------------------------------------------ device setup engine
    def _engine(self):
        """The process-wide device setup engine, or None when
        ``device_setup=0`` (the host products then run without
        consulting it)."""
        if not self.device_setup:
            return None
        from .device_setup import engine
        return engine()

    def _engine_args(self, cur: Matrix) -> dict:
        return dict(device=cur.placement,
                    min_rows=self.device_setup_min_rows,
                    budget_bytes=self.device_setup_cache_mb << 20)

    def _cached_galerkin_plan(self, A_csr, P_host):
        eng = self._engine()
        return None if eng is None else \
            eng.cached_galerkin_plan(A_csr, P_host, A_csr.dtype)

    def _galerkin_classical(self, cur: Matrix, Asc, R_host, P_host,
                            keep_pattern: bool) -> sp.csr_matrix:
        """Galerkin RAP of one host classical level: the engine's plan
        and numeric pass on the level's device, the scipy triple product
        after a gate decline (or with ``device_setup=0``).
        ``keep_pattern`` returns it on its full symbolic pattern (the
        frozen structure a values-only resetup refreshes)."""
        eng = self._engine()
        Ac = None
        if eng is not None:
            Ac = eng.galerkin_csr(Asc, P_host, dtype=Asc.dtype,
                                  keep_pattern=keep_pattern,
                                  **self._engine_args(cur))
        if Ac is None:
            Ac = sp.csr_matrix(R_host @ Asc @ P_host)
            if keep_pattern:
                Ac = pad_to_symbolic(Ac, Asc, P_host)
        Ac = Ac.astype(Asc.dtype)
        Ac.sum_duplicates()
        Ac.sort_indices()
        return Ac

    def _galerkin_agg(self, cur: Matrix, agg: np.ndarray):
        """Galerkin product of one aggregation level (scalar CSR or b×b
        BSR): the engine's ordered segment sum on the level's device,
        the host sort-based generator after a gate decline."""
        eng = self._engine()
        host = cur.host
        if eng is not None:
            out = eng.galerkin_agg(host, agg, cur.block_dim,
                                   dtype=host.dtype,
                                   **self._engine_args(cur))
            if out is not None:
                return out.astype(host.dtype)
        return galerkin_coarse(host, agg, cur.block_dim)

    def _effective_hierarchy_dtype(self):
        """The storage dtype the precision policy applies, or None: an
        explicit ``hierarchy_dtype``, else a bf16 fine-matrix device
        dtype (``tpu_matrix_dtype=bfloat16``)."""
        if self.hierarchy_dtype is not None:
            return self.hierarchy_dtype
        if not self.levels:
            return None
        dd = getattr(self.levels[0].A, "device_dtype", None)
        if dd is not None and precision.is_sub_f32(dd):
            return dd
        return None

    def _apply_precision_policy(self):
        """Narrow the stored hierarchy from ``mixed_precision_from_level``
        down (``_apply_precision_policy`` upstream): each covered level's
        operator and host-built transfers become precision views
        (:func:`~..core.precision.precision_view`: a device cast of an
        existing pack, else a narrow upload), device-born transfers are
        cast when their pack may narrow.  The caller's matrix and the
        coarsest level (the dense coarse solve) keep their dtype, and so
        does every pack whose kernel has no bf16 pair (scalar binned
        planes, shift packs)."""
        hd = self._effective_hierarchy_dtype()
        if hd is None:
            return
        for i, lvl in enumerate(self.levels):
            if i < max(self.mixed_from_level, 0):
                continue
            A = lvl.A
            if A.dist is not None:
                # sharded levels keep their dtype, as upstream
                continue
            if hd.itemsize < storage_dtype(A.device_dtype
                                           or A.dtype).itemsize:
                lvl.A = precision.precision_view(A, hd)
            for slot in ("_P", "_R"):
                T = getattr(lvl, slot, None)
                if isinstance(T, Matrix):
                    if hd.itemsize < storage_dtype(T.device_dtype
                                                   or T.dtype).itemsize:
                        setattr(lvl, slot, precision.precision_view(T, hd))
                elif T is not None and precision.narrowable_pack(T) and \
                        T.dtype.itemsize > hd.itemsize:
                    setattr(lvl, slot, T.astype(hd))

    def _place_host_tail(self, coarsest: Matrix) -> Matrix:
        """Find the host tail (``amgx_tpu/amg/cycles.py:44-66``: the first
        level at or below ``amg_host_levels_rows`` and every coarser
        one) and, on a CUDA hierarchy, move its levels — packs, transfer
        data, inverted diagonals — and the coarsest matrix to the CPU, so
        their smoothers and the coarse solver set up there; returns the
        coarsest matrix where it now lives."""
        sizes = [lvl.Ad.n_rows for lvl in self.levels] + \
            [coarsest.n_block_rows]
        self.host_from = len(sizes)
        if self.host_levels_rows > 0:
            self.host_from = next((i for i, n in enumerate(sizes)
                                   if n <= self.host_levels_rows),
                                  len(sizes))
        if self.host_from == len(sizes) or \
                coarsest.placement.type != "cuda":
            return coarsest
        host = torch.device("cpu")
        for lvl in self.levels[self.host_from:]:
            for k, v in list(vars(lvl).items()):
                setattr(lvl, k, _on_device(v, host))
        return _on_device(coarsest, host)

    def _setup_smoothers_and_coarse(self, coarsest: Matrix):
        # the levels' packs were made on the device as they were built;
        # what stays of the JAX package's batched upload is their
        # placement: the precision policy's casts and the host tail
        with cpu_profiler("hierarchy_upload"), \
                setup_profile.phase("upload", kind="device"):
            self._apply_precision_policy()
            coarsest = self._place_host_tail(coarsest)
        with cpu_profiler("setup_smoothers"), \
                setup_profile.phase("smoother_setup"):
            for lvl in self.levels:
                with setup_profile.phase("smoother_setup",
                                         level=lvl.level_index):
                    lvl.smoother = SolverFactory.allocate(
                        self.cfg, self.scope, "smoother")
                    lvl.smoother.setup(lvl.A)
        self.coarsest = coarsest
        with cpu_profiler("setup_coarse_solver"), \
                setup_profile.phase("coarse_solver"):
            self.coarse_solver = SolverFactory.allocate(
                self.cfg, self.scope, "coarse_solver")
            self.coarse_solver.setup(coarsest)
        self.coarse_solver_is_smoother = self.coarse_solver.is_smoother

    # ------------------------------------------------------------------ info
    def num_levels(self):
        return len(self.levels) + 1

    def level_sizes(self) -> List[tuple]:
        """(rows, nnz) per level, fine to coarsest."""
        sizes = [lvl.level_stats() for lvl in self.levels]
        sizes.append((self.coarsest.n_block_rows, self.coarsest.nnz))
        return sizes

    def _emit_telemetry(self):
        """Hierarchy gauges (per-level rows/nnz, operator and grid
        complexity), the per-level cost descriptors and the distributed
        levels' overlap audit — the structured twin of the grid-stats
        table (``_emit_telemetry`` upstream)."""
        sizes = self.level_sizes()
        tot_rows = sum(n for n, _ in sizes)
        tot_nnz = sum(z for _, z in sizes)
        op_cmpl = tot_nnz / max(sizes[0][1], 1)
        grid_cmpl = tot_rows / max(sizes[0][0], 1)
        telemetry.gauge_set("amgx_hierarchy_levels", len(sizes))
        reg = telemetry.registry()
        for name in ("amgx_level_rows", "amgx_level_nnz",
                     "amgx_level_spmv_bytes", "amgx_level_spmv_flops",
                     "amgx_level_padding_waste",
                     "amgx_dist_overlap_fraction",
                     "amgx_dist_submesh_parts"):
            reg.gauge_clear(name)
        for i, (n, nnz) in enumerate(sizes):
            telemetry.gauge_set("amgx_level_rows", n, level=i)
            telemetry.gauge_set("amgx_level_nnz", nnz, level=i)
        telemetry.gauge_set("amgx_operator_complexity", op_cmpl)
        telemetry.gauge_set("amgx_grid_complexity", grid_cmpl)
        packs = self._materialized_packs()
        for i, Ad in enumerate(packs):
            if Ad is None or getattr(Ad, "fmt", "") != "sharded-ell":
                continue
            d = telemetry.costmodel.dist_overlap(Ad, nnz=sizes[i][1],
                                                 level=i)
            d["submesh_parts"] = d["active_parts"]
            telemetry.gauge_set("amgx_dist_overlap_fraction",
                                d["overlap_fraction"], level=i)
            telemetry.gauge_set("amgx_dist_submesh_parts",
                                d["submesh_parts"], level=i)
            telemetry.event("dist_overlap", **d)
        for i, Ad in enumerate(packs):
            if Ad is None:
                continue
            cost = telemetry.costmodel.spmv_cost(Ad, nnz=sizes[i][1])
            if cost.get("bytes_per_apply") is not None:
                dt = str(cost.get("dtype", "?"))
                telemetry.gauge_set("amgx_level_spmv_bytes",
                                    cost["bytes_per_apply"], level=i,
                                    dtype=dt)
                telemetry.gauge_set("amgx_level_spmv_flops",
                                    cost["flops_per_apply"], level=i,
                                    dtype=dt)
                telemetry.gauge_set("amgx_level_padding_waste",
                                    cost["padding_waste"], level=i,
                                    dtype=dt)
            telemetry.event("level_cost", level=i, **cost)
        telemetry.event("hierarchy", levels=len(sizes),
                        operator_complexity=round(op_cmpl, 6),
                        grid_complexity=round(grid_cmpl, 6),
                        setup_s=round(self.setup_time, 6))

    def _materialized_packs(self) -> list:
        """Per-level device packs where they already exist (never an
        upload as a side effect), fine to coarsest."""
        packs = [getattr(lvl.A, "_device", None) for lvl in self.levels]
        packs.append(getattr(self.coarsest, "_device", None)
                     if self.coarsest is not None else None)
        return packs

    def _register_memledger(self):
        """Device-memory ledger ownership (telemetry/memledger.py): each
        level's pack (``amgx/hierarchy/level<N>``, the coarsest
        ``amgx/hierarchy/coarse``), its P/R transfer data
        (``amgx/transfer/level<N>``), its smoother's device state
        (``amgx/smoother/level<N>``) and the coarse solver's
        (``amgx/coarse/solver``).  A new setup releases the previous
        tokens first, so registrations balance across setup, resetup
        and teardown.  One attribute check when the ledger is off."""
        ml = telemetry.memledger
        if not ml.is_enabled():
            return
        self.release_memledger()
        toks = self._ml_tokens = []

        def reg(owner, name, tree):
            if tree is not None:
                toks.append(ml.register(ml.owner_name(owner, name), tree))

        packs = self._materialized_packs()
        for i, Ad in enumerate(packs[:-1]):
            reg("hierarchy", f"level{i}", Ad)
        reg("hierarchy", "coarse", packs[-1])
        for i, lvl in enumerate(self.levels):
            tr = {k: v for k, v in vars(lvl).items()
                  if k not in ("A", "smoother") and k != "_ml_tokens"}
            reg("transfer", f"level{i}", tr)
            reg("smoother", f"level{i}", lvl.smoother)
        reg("coarse", "solver", self.coarse_solver)

    def release_memledger(self):
        """Drop this hierarchy's ledger registrations (teardown)."""
        for tok in getattr(self, "_ml_tokens", ()):
            telemetry.memledger.release(tok)
        self._ml_tokens = []

    def grid_stats(self) -> str:
        """The grid-stats table of the reference README sample output
        (``grid_stats`` upstream)."""
        rows = []
        tot_rows = tot_nnz = 0
        all_levels = self.level_sizes()
        for i, (n, nnz) in enumerate(all_levels):
            sprs = nnz / max(n * n, 1)
            rows.append(f"         {i}(D)  {n:12d}  {nnz:12d} "
                        f" {sprs:9.3g}\n")
            tot_rows += n
            tot_nnz += nnz
        op_cmpl = tot_nnz / max(all_levels[0][1], 1)
        grid_cmpl = tot_rows / max(all_levels[0][0], 1)
        return ("        Number of Levels: "
                f"{self.num_levels()}\n"
                "            LVL         ROWS           NNZ    SPRSTY\n"
                "         ------------------------------------------\n"
                + "".join(rows) +
                "         ------------------------------------------\n"
                f"         Grid Complexity: {grid_cmpl:.5g}\n"
                f"         Operator Complexity: {op_cmpl:.5g}\n")

"""Coarse-level agglomeration onto shrinking sub-meshes (port of
``amgx_tpu/distributed/agglomerate.py``; host code, copied).

AmgX never lets a coarse grid strand the full communicator: below a
per-rank row threshold it consolidates shrinking levels onto fewer
ranks (``amg.cu:328-390`` + ``distributed/glue.h:73-263``).  This module
is the planner:

* :func:`plan_submesh` — the active sub-mesh size (P → P/factor → … → 1)
  of a coarse level's row count under ``dist_agglomerate_min_rows``;
* :func:`plan_for` — build (or reuse) an :class:`AgglomPlan`: the
  agglomerated row offsets plus explicit redistribution packs (per
  destination rank, the ordered ``(src rank, lo, hi)`` local row ranges
  it receives).  Plans are cached by ``(src offsets, threshold,
  factor)``;
* :func:`redistribute_blocks` — apply a plan's packs to per-rank row
  blocks (host CSR; on one device the "send" is an array slice).

The hierarchy records the resulting sub-mesh in ``AMGLevel.
submesh_parts``.  The JAX package's ``dist_agglomerate`` telemetry
events belong to the telemetry slice (ROADMAP item 9) and are not
emitted here.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class RedistPack:
    """One destination rank's receive schedule: ordered local row
    ranges of the source ranks that land on ``dst`` (rank-major, so the
    concatenation is exactly the destination's new row block)."""
    dst: int
    srcs: Tuple[Tuple[int, int, int], ...]   # (src rank, local lo, hi)


@dataclasses.dataclass(frozen=True)
class AgglomPlan:
    """A frozen agglomeration decision for one coarse level layout."""
    n_parts: int
    p_active: int                  # active ranks after agglomeration
    src_offsets: Tuple[int, ...]   # balanced per-rank row offsets (P+1)
    dst_offsets: Tuple[int, ...]   # agglomerated offsets (P+1; tail flat)
    packs: Tuple[RedistPack, ...]  # one per destination rank

    @property
    def n_rows(self) -> int:
        return int(self.src_offsets[-1])

    @property
    def replicated(self) -> bool:
        """Fully agglomerated: the level lives on one rank, so the
        coarse solve stops being a P-way broadcast."""
        return self.p_active == 1


def active_parts(offsets) -> int:
    """Ranks that actually own rows under ``offsets`` (agglomerated
    levels keep the P+1 offset vector but flatten its tail)."""
    return int(np.sum(np.diff(np.asarray(offsets)) > 0))


def plan_submesh(n_rows: int, n_parts: int, min_rows: int,
                 factor: int = 2) -> int:
    """Active sub-mesh size for ``n_rows`` total rows: shrink the P
    active ranks by ``factor`` until every active rank holds at least
    ``min_rows`` rows (or one rank remains)."""
    p = max(int(n_parts), 1)
    factor = max(int(factor), 2)
    min_rows = max(int(min_rows), 1)
    while p > 1 and n_rows // p < min_rows:
        p = max(1, p // factor)
    return p


def _build_packs(src_offsets: np.ndarray,
                 dst_offsets: np.ndarray) -> Tuple[RedistPack, ...]:
    """Per-destination receive schedules mapping the global row range
    [dst[q], dst[q+1]) onto (src rank, local lo, hi) slices."""
    n_parts = len(src_offsets) - 1
    packs = []
    for q in range(n_parts):
        lo, hi = int(dst_offsets[q]), int(dst_offsets[q + 1])
        srcs: List[Tuple[int, int, int]] = []
        if hi > lo:
            for s in range(n_parts):
                slo, shi = int(src_offsets[s]), int(src_offsets[s + 1])
                a, b = max(lo, slo), min(hi, shi)
                if b > a:
                    srcs.append((s, a - slo, b - slo))
        packs.append(RedistPack(dst=q, srcs=tuple(srcs)))
    return tuple(packs)


def build_agglomeration(src_offsets, min_rows: int, factor: int = 2
                        ) -> Optional[AgglomPlan]:
    """Plan the agglomeration of a level laid out by ``src_offsets``;
    None when the level already satisfies the threshold (or cannot
    shrink further)."""
    src = np.asarray(src_offsets, dtype=np.int64)
    n_parts = len(src) - 1
    n_rows = int(src[-1])
    act = active_parts(src)
    if n_rows <= 0 or act <= 1 or min_rows <= 0:
        return None
    p_active = plan_submesh(n_rows, act, min_rows, factor)
    if p_active >= act:
        return None
    per = -(-n_rows // p_active)
    dst = np.concatenate([
        np.minimum(np.arange(p_active + 1, dtype=np.int64) * per, n_rows),
        np.full(n_parts - p_active, n_rows, dtype=np.int64)])
    return AgglomPlan(
        n_parts=n_parts, p_active=p_active,
        src_offsets=tuple(int(o) for o in src),
        dst_offsets=tuple(int(o) for o in dst),
        packs=_build_packs(src, dst))


def redistribute_blocks(blocks, plan: AgglomPlan) -> list:
    """Apply the plan's redistribution packs to per-rank row blocks
    (CSR, any column space).  Each destination rank's new block is the
    rank-major concatenation of its pack's source slices — the
    in-process form of the neighbour-wise migration messages."""
    n_cols = None
    for b in blocks:
        if b is not None:
            n_cols = b.shape[1]
            break
    out = []
    for pack in plan.packs:
        pieces = [sp.csr_matrix(blocks[s][lo:hi])
                  for (s, lo, hi) in pack.srcs]
        if pieces:
            out.append(sp.csr_matrix(sp.vstack(pieces)))
        else:
            out.append(sp.csr_matrix((0, n_cols or 0)))
    return out


# ----------------------------------------------------------- plan cache
#: (src_offsets, min_rows, factor) → AgglomPlan | None; a values-only
#: resetup re-plans the SAME level layouts, so the cache turns the
#: replay into pure lookups (packs reused, zero re-planning)
_PLANS: dict = {}
_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0}


def plan_for(src_offsets, min_rows: int, factor: int = 2,
             level=None) -> Optional[AgglomPlan]:
    """Cached :func:`build_agglomeration`: the single entry point the
    hierarchy paths use (``level`` names the level for the telemetry
    slice; unused here)."""
    key = (tuple(int(o) for o in src_offsets), int(min_rows),
           int(factor))
    with _LOCK:
        if key in _PLANS:
            _STATS["hits"] += 1
            plan, reused = _PLANS[key], True
        else:
            plan, reused = None, False
    if not reused:
        plan = build_agglomeration(src_offsets, min_rows, factor)
        with _LOCK:
            _STATS["misses"] += 1
            _PLANS[key] = plan
            while len(_PLANS) > 512:
                _PLANS.pop(next(iter(_PLANS)))
    return plan


def agglomeration_stats() -> dict:
    with _LOCK:
        return {"plans": len(_PLANS), "hits": int(_STATS["hits"]),
                "misses": int(_STATS["misses"])}


def reset_plans() -> None:
    """Drop the plan cache (test isolation)."""
    with _LOCK:
        _PLANS.clear()
        _STATS["hits"] = _STATS["misses"] = 0

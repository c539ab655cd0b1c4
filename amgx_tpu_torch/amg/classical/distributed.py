"""Per-rank distributed classical AMG setup (port of
``amgx_tpu/amg/classical/distributed.py``, copied host code).

Reference: the distributed classical pipeline of
``core/src/classical/classical_amg_level.cu:240-340`` +
``base/src/distributed/distributed_arranger.h:223-231`` — per-rank
strength/selection with halo C/F states, P rows exchanged for the halo
(``exchange_halo_rows_P``), distributed Galerkin with ``RAP_ext``
sparse-add, and a renumbered rank-contiguous coarse space.

Every step consumes one rank's row block plus its ring-1 / ring-2 halo
ROWS (the ring-2 maps of ``build_partition_from_blocks`` are the consumer
of distance-2 interpolation, which reaches ring-2 columns).  On one
device the "exchange" of halo rows and states is a read of the
neighbour's arrays (the :class:`HaloExchange` schedule lists the
messages a multi-card run would send).  No step assembles a global
matrix.

Numerical parity: each rank's extended system reproduces the exact rows
the serial algorithms would see, and coarse points are numbered
rank-contiguously — which IS ascending global row order — so P, R, and
the Galerkin product equal the single-device results entry for entry
(up to fp summation order in RAP partials).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ...distributed.partition import Partition
from .selectors import COARSE, FINE, UNDECIDED, tie_break_for


class RankExtended:
    """One rank's extended view: local rows + ring-1 halo rows, columns
    re-indexed into the compact universe [local | ring1 | ring2]."""

    def __init__(self, p: int, blocks, part: Partition):
        offsets = np.asarray(part.offsets)
        lo, hi = offsets[p], offsets[p + 1]
        self.p = p
        self.lo, self.hi = int(lo), int(hi)
        self.n_local = int(hi - lo)
        ring1 = part.rings[0].halo_global[p]
        ring2 = part.rings[1].halo_global[p] if len(part.rings) > 1 \
            else np.zeros(0, dtype=np.int64)
        #: universe: global ids of [local | ring1 | ring2]
        self.universe = np.concatenate(
            [np.arange(lo, hi, dtype=np.int64), ring1, ring2])
        self.nU = len(self.universe)
        # global id -> universe slot (sparse dict-free: sorted halo lookup)
        self._ring1 = ring1
        self._ring2 = ring2

        # extended rows: local + ring-1 halo rows (from the owners'
        # blocks — the multi-host analog is the neighbour-wise halo-row
        # exchange, distributed_arranger.h:223-231)
        owner = np.searchsorted(offsets, ring1, side="right") - 1
        rows_parts = [blocks[p]]
        self._ext_row_gids = [np.arange(lo, hi, dtype=np.int64)]
        for q in np.unique(owner) if len(ring1) else []:
            rq = ring1[owner == q] - offsets[q]
            rows_parts.append(sp.csr_matrix(blocks[q][rq]))
            self._ext_row_gids.append(ring1[owner == q] + 0)
        A_rows = sp.vstack(rows_parts).tocsr()
        row_gids = np.concatenate(self._ext_row_gids)

        # re-index columns into the universe (entries outside the
        # universe can only appear in ring-1 rows reaching ring-3 — drop
        # them: they never feed a LOCAL row's interpolation stencil)
        coo = A_rows.tocoo()
        ucols = self.to_universe(coo.col)
        keep = ucols >= 0
        urows = self.to_universe(row_gids)[coo.row]
        self.A_U = sp.csr_matrix(
            (coo.data[keep], (urows[keep], ucols[keep])),
            shape=(self.nU, self.nU))
        self.A_U.sum_duplicates()
        self.A_U.sort_indices()

    def to_universe(self, gids: np.ndarray) -> np.ndarray:
        """Global ids → universe slots (−1 when outside)."""
        gids = np.asarray(gids, dtype=np.int64)
        out = np.full(len(gids), -1, dtype=np.int64)
        local = (gids >= self.lo) & (gids < self.hi)
        out[local] = gids[local] - self.lo
        base = self.n_local
        for ring in (self._ring1, self._ring2):
            if len(ring):
                pos_c, in_ring = sorted_lookup(ring, gids)
                hit = (~local) & (out < 0) & in_ring
                out[hit] = base + pos_c[hit]
            base += len(ring)
        return out


def strength_distributed(exts: List[RankExtended], strength_objs
                         ) -> List[sp.csr_matrix]:
    """Per-rank strength on the extended systems — row-local formulas
    make local + ring-1 rows exact.  Computed ONCE per level and shared
    by selection and interpolation.  Agglomerated levels leave trailing
    ranks empty — their strength is the trivial empty graph."""
    return [strength_objs[p].compute(exts[p].A_U) if exts[p].nU
            else sp.csr_matrix((0, 0))
            for p in range(len(exts))]


class HaloExchange:
    """The halo message schedule: per rank, per NEIGHBOR, which of the
    neighbour's local entries land in which of this rank's halo slots.

    In-process, :meth:`refresh` delivers the messages as array reads of
    the owner's rank-local buffer; multi-host, each ``(q, slots, idx)``
    triple IS one point-to-point message (``distributed_arranger``'s
    state/row exchanges).  No participant ever touches an array of
    global length."""

    def __init__(self, exts: List[RankExtended], offsets: np.ndarray):
        offsets = np.asarray(offsets)
        self.plan = []
        for e in exts:
            halo = e.universe[e.n_local:]
            slots = np.arange(e.n_local, e.nU)
            per = []
            if len(halo):
                owner = np.searchsorted(offsets, halo,
                                        side="right") - 1
                for q in np.unique(owner):
                    m = owner == q
                    per.append((int(q), slots[m],
                                halo[m] - offsets[q]))
            self.plan.append(per)

    def refresh(self, locals_: List[np.ndarray],
                out_U: List[np.ndarray]) -> None:
        """out_U[p][slot] ← locals_[q][idx] for every scheduled halo
        slot (one neighbour-wise exchange round)."""
        for p, per in enumerate(self.plan):
            for q, slots, idx in per:
                out_U[p][slots] = locals_[q][idx]


def _rank_offsets(exts: List[RankExtended], n: int) -> np.ndarray:
    return np.asarray([e.lo for e in exts] + [n], dtype=np.int64)


def sorted_lookup(keys_sorted: np.ndarray, queries: np.ndarray):
    """(positions, hit mask) of ``queries`` in a sorted key array —
    the clamped-searchsorted membership idiom shared by
    ``RankExtended.to_universe`` and the RAP column remap."""
    pos = np.searchsorted(keys_sorted, queries)
    pos = np.minimum(pos, max(len(keys_sorted) - 1, 0))
    hit = (keys_sorted[pos] == queries) if len(keys_sorted) else \
        np.zeros(len(queries), dtype=bool)
    return pos, hit


def pmis_distributed(exts: List[RankExtended], S_U: List[sp.csr_matrix],
                     n: int, seed: int = 7
                     ) -> Tuple[List[np.ndarray], "HaloExchange"]:
    """PMIS over per-rank extended blocks, bit-identical to the serial
    ``selectors._pmis``: the same synchronous two-phase rounds, with
    RANK-LOCAL MEMORY ONLY — every array is sized by the rank's
    [local | ring1 | ring2] universe, and each phase ends with one
    neighbour-wise halo-state exchange (in-process: an array read of the
    owner's buffer; multi-host: the ``HaloExchange`` message schedule).

    Returns ``(per-rank LOCAL cf maps (1 = coarse), HaloExchange)`` —
    the schedule is reused by ``coarse_numbering_distributed``.
    """
    P = len(exts)
    offs = _rank_offsets(exts, n)
    ex = HaloExchange(exts, offs)
    G_U = []
    for p in range(P):
        G = (S_U[p] + S_U[p].T).tocsr()
        G.eliminate_zeros()
        G_U.append(G)

    # weights: lam_i = #rows strongly depending on i — all such rows sit
    # within local ∪ ring1, so each owner computes its own lam exactly;
    # the tie-break fraction is computable per node from (n, seed, gid)
    # alone, so halo WEIGHTS need one exchange and no global array
    w_loc, st_loc, edges = [], [], []
    for p, e in enumerate(exts):
        ST = sp.csr_matrix(S_U[p].T)
        cnt = np.diff(ST.indptr)[:e.n_local].astype(np.float64)
        gids = np.arange(e.lo, e.hi, dtype=np.int64)
        w_loc.append(cnt + tie_break_for(n, seed, gids))
        gdeg = np.diff(G_U[p].indptr)[:e.n_local]
        s0 = np.full(e.n_local, UNDECIDED, dtype=np.int8)
        s0[gdeg == 0] = FINE
        st_loc.append(s0)
        G = G_U[p]
        rows = np.repeat(np.arange(e.nU), np.diff(G.indptr))
        m = rows < e.n_local
        edges.append((rows[m], G.indices[m]))

    w_U = [np.zeros(e.nU) for e in exts]
    st_U = [np.full(e.nU, UNDECIDED, dtype=np.int8) for e in exts]
    for p, e in enumerate(exts):
        w_U[p][:e.n_local] = w_loc[p]
        st_U[p][:e.n_local] = st_loc[p]
    ex.refresh(w_loc, w_U)
    ex.refresh(st_loc, st_U)

    while True:
        n_und = sum(int((s == UNDECIDED).sum()) for s in st_loc)
        if n_und == 0:
            break
        # phase 1: C marking — every rank reads the synced pre-round
        # states; only LOCAL rows are decided
        become = []
        for p, e in enumerate(exts):
            rows, cols = edges[p]
            nl = e.n_local
            und_row = st_U[p][rows] == UNDECIDED
            und_col = st_U[p][cols] == UNDECIDED
            both = und_row & und_col
            max_nb = np.zeros(nl)
            np.maximum.at(max_nb, rows[both], w_U[p][cols[both]])
            has_nb = np.zeros(nl, dtype=bool)
            has_nb[rows[both]] = True
            und_l = st_U[p][:nl] == UNDECIDED
            become_c = und_l & ((~has_nb) | (w_loc[p] > max_nb))
            become.append(become_c)
        prev_halo = [st_U[p][exts[p].n_local:].copy() for p in range(P)]
        for p, e in enumerate(exts):
            st_loc[p][become[p]] = COARSE
            st_U[p][:e.n_local] = st_loc[p]
        ex.refresh(st_loc, st_U)          # halo-state exchange #1
        # phase 2: F marking — "became C this round" halos are the diff
        # against the pre-exchange halo snapshot (no extra message kind)
        for p, e in enumerate(exts):
            nl = e.n_local
            jc = np.zeros(e.nU, dtype=bool)
            jc[:nl] = become[p]
            halo_now = st_U[p][nl:]
            jc[nl:] = (halo_now == COARSE) & (prev_halo[p] != COARSE)
            rows, cols = edges[p]
            f_hit = jc[cols] & (st_U[p][rows] == UNDECIDED)
            f_nodes = np.unique(rows[f_hit])
            st_loc[p][f_nodes] = FINE
            st_U[p][:nl] = st_loc[p]
        ex.refresh(st_loc, st_U)          # halo-state exchange #2
        if sum(int((s == UNDECIDED).sum()) for s in st_loc) == n_und:
            raise RuntimeError(
                "distributed PMIS made no progress in a round — "
                "tie-break weights are not distinct")
    return [(s == COARSE).astype(np.int8) for s in st_loc], ex


def coarse_numbering_distributed(exts: List[RankExtended],
                                 cf_loc: List[np.ndarray], n: int,
                                 ex: Optional[HaloExchange] = None):
    """Rank-contiguous coarse ids from per-rank cf maps: returns
    (coarse offsets, per-rank cf over the universe, per-rank coarse ids
    over the universe).  The only global quantity is the P+1 offset
    vector (an allgather of P scalars)."""
    counts = [int(c.sum()) for c in cf_loc]
    c_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cnum_loc = []
    for p, e in enumerate(exts):
        cn = np.where(cf_loc[p] > 0,
                      c_off[p] + np.cumsum(cf_loc[p]) - 1, -1)
        cnum_loc.append(cn.astype(np.int64))
    if ex is None:
        ex = HaloExchange(exts, _rank_offsets(exts, n))
    cf_U = [np.zeros(e.nU, dtype=np.int8) for e in exts]
    cnum_U = [np.full(e.nU, -1, dtype=np.int64) for e in exts]
    for p, e in enumerate(exts):
        cf_U[p][:e.n_local] = cf_loc[p]
        cnum_U[p][:e.n_local] = cnum_loc[p]
    ex.refresh(cf_loc, cf_U)
    ex.refresh(cnum_loc, cnum_U)
    return c_off, cf_U, cnum_U


def interpolate_distributed(exts: List[RankExtended], interp,
                            cf_U: List[np.ndarray],
                            cnum_U: List[np.ndarray],
                            S_U: List[sp.csr_matrix], nc: int
                            ) -> List[sp.csr_matrix]:
    """Per-rank P row blocks (global coarse columns): run the serial
    interpolator on each extended system and keep the LOCAL rows — the
    extended block contains exactly the rows a local row's distance-≤2
    stencil reads (ring-2 columns are the D2 consumer).  All inputs are
    rank-local universe arrays (``coarse_numbering_distributed``)."""
    P_blocks = []
    for p, e in enumerate(exts):
        if e.n_local == 0:     # agglomerated-away rank: empty P block
            P_blocks.append(sp.csr_matrix((0, nc)))
            continue
        P_U = interp.compute(e.A_U, S_U[p], cf_U[p])
        # universe coarse order -> global coarse ids
        c_slots = np.flatnonzero(cf_U[p])
        gc = cnum_U[p][c_slots]
        Pl = sp.csr_matrix(P_U[:e.n_local])
        P_blocks.append(sp.csr_matrix(
            (Pl.data, gc[Pl.indices], Pl.indptr),
            shape=(e.n_local, nc)))
    return P_blocks


def rap_distributed(blocks, P_blocks: List[sp.csr_matrix],
                    part: Partition, coarse_offsets: np.ndarray,
                    engine=None, dtype=None, device="cpu",
                    min_rows: int = 0, budget_bytes=None
                    ) -> Tuple[List[sp.csr_matrix], List[sp.csr_matrix]]:
    """Distributed Galerkin: per-rank ``Ac`` row blocks and ``R`` row
    blocks from the per-rank ``A`` and ``P`` blocks.

    Per rank p: ``AP_p = A_p · P`` needs P rows for A_p's halo columns —
    the P-halo-row exchange (``exchange_halo_rows_P`` analog); the
    partial ``P_pᵀ·AP_p`` then lands on coarse rows owned by p and its
    neighbours, and owners sum the incoming partials — the reference's
    ``csr_RAP_sparse_add`` (``csr_multiply.h:100-126``).  R rows (= Pᵀ
    columns) are collected the same neighbour-wise way.

    ``engine``: the device setup engine (:mod:`..device_setup`) — each
    rank's partial then runs shard-local on ``device``
    (``engine.galerkin_dist``: a pattern-keyed symbolic plan once, the
    ordered numeric pass on every call); the host scipy product serves
    every gate decline.
    """
    offsets = np.asarray(part.offsets)
    n_parts = part.n_parts
    nc = int(coarse_offsets[-1])

    def p_rows_for(gids: np.ndarray) -> sp.csr_matrix:
        """P rows of arbitrary global fine rows (neighbour reads)."""
        if not len(gids):
            return sp.csr_matrix((0, nc))
        owner = np.searchsorted(offsets, gids, side="right") - 1
        parts = []
        for q in np.unique(owner):
            rq = gids[owner == q] - offsets[q]
            parts.append(sp.csr_matrix(P_blocks[q][rq]))
        return sp.vstack(parts).tocsr()

    # per-rank partial contributions Pᵀ(A_p P), coarse-global coo triplets
    partial_by_owner = [[] for _ in range(n_parts)]
    for p in range(n_parts):
        lo, hi = offsets[p], offsets[p + 1]
        ring1 = part.rings[0].halo_global[p]
        # P restricted to [local rows | ring1 rows] in A_p's column
        # space; the global-id → kept-position map is a sorted lookup
        # over the O(local+halo) kept set — never a global-length array
        keep_cols = np.concatenate(
            [np.arange(lo, hi, dtype=np.int64), ring1])
        order = np.argsort(keep_cols, kind="stable")
        keep_sorted = keep_cols[order]
        Ap = blocks[p].tocoo()
        pos_c, sel = sorted_lookup(keep_sorted, Ap.col)
        A_loc = sp.csr_matrix(
            (Ap.data[sel], (Ap.row[sel], order[pos_c[sel]])),
            shape=(hi - lo, len(keep_cols)))
        P_rows = sp.vstack([sp.csr_matrix(P_blocks[p]),
                            p_rows_for(ring1)]).tocsr()
        part_contrib = None
        if engine is not None and A_loc.nnz and P_blocks[p].nnz:
            # shard-local device Galerkin: P_rows = [P_loc | halo'd P
            # rows] satisfies the data-prefix contract of the ext plan
            part_contrib = engine.galerkin_dist(
                A_loc, P_rows, P_blocks[p],
                dtype=np.dtype(dtype or A_loc.dtype), device=device,
                min_rows=min_rows, budget_bytes=budget_bytes)
            if part_contrib is not None:
                part_contrib = sp.csr_matrix(
                    part_contrib.astype(A_loc.dtype))
        if part_contrib is None:
            AP = sp.csr_matrix(A_loc @ P_rows)       # (n_local_p, nc)
            part_contrib = sp.csr_matrix(P_blocks[p].T @ AP)  # (nc, nc)
        part_contrib.sum_duplicates()
        coo = part_contrib.tocoo()
        crow_owner = np.searchsorted(coarse_offsets, coo.row,
                                     side="right") - 1
        for q in np.unique(crow_owner) if len(coo.row) else []:
            m = crow_owner == q
            partial_by_owner[q].append(sp.csr_matrix(
                (coo.data[m],
                 (coo.row[m] - coarse_offsets[q], coo.col[m])),
                shape=(coarse_offsets[q + 1] - coarse_offsets[q], nc)))

    c_blocks = []
    for q in range(n_parts):
        nq = int(coarse_offsets[q + 1] - coarse_offsets[q])
        if partial_by_owner[q]:
            C = partial_by_owner[q][0]
            for extra in partial_by_owner[q][1:]:
                C = C + extra                    # RAP_ext sparse add
            C = sp.csr_matrix(C)
        else:
            C = sp.csr_matrix((nq, nc))
        C.sum_duplicates()
        C.sort_indices()
        c_blocks.append(C)

    # R row blocks: rank q's R rows are its coarse points; entries come
    # from P rows of fine points that interpolate to them.  SEND-side
    # logic: each rank routes its P triplets to the coarse owners (the
    # Pᵀ halo collection of exchange_halo_rows_P — neighbour-wise, since
    # a P column can only be a coarse point within the row's stencil)
    n_fine = int(offsets[-1])
    tri = [([], [], []) for _ in range(n_parts)]
    for p in range(n_parts):
        coo = P_blocks[p].tocoo()
        cown = np.searchsorted(coarse_offsets, coo.col, side="right") - 1
        for q in np.unique(cown) if len(coo.col) else []:
            m = cown == q
            tri[q][0].append(coo.col[m] - coarse_offsets[q])
            tri[q][1].append(coo.row[m] + offsets[p])
            tri[q][2].append(coo.data[m])
    r_blocks = []
    for q in range(n_parts):
        clo, chi = coarse_offsets[q], coarse_offsets[q + 1]
        rr, cc, vv = tri[q]
        R = sp.csr_matrix(
            (np.concatenate(vv) if vv else [],
             (np.concatenate(rr) if rr else [],
              np.concatenate(cc) if cc else [])),
            shape=(int(chi - clo), n_fine))
        R.sum_duplicates()
        R.sort_indices()
        r_blocks.append(R)
    return c_blocks, r_blocks

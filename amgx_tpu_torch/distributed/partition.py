"""Row partitioning and halo-map construction (port of
``amgx_tpu/distributed/partition.py``; host numpy code, copied so the
port never imports the JAX package).

The reference keeps per-matrix partition state in its
``DistributedManager`` (``base/src/distributed/distributed_manager.cu``):
neighbour lists, B2L (boundary→local) send maps, halo offsets, and per
ring maps (``distributed_manager.h:284-305``, rings default 2).
:func:`build_partition` builds the same state on the host: rows are
split into P contiguous shards, padded with identity rows to ``n_loc``
each; ``send_idx`` (the B2L map) gathers each rank's boundary values
into a fixed-size send buffer.

The exchange layout is distance-wise: the union of neighbour links is a
small set of rank distances d = (owner − p) mod P; an exchange moves the
send buffers once per distance, and ``halo_src`` addresses the received
buffers as d_slot·B + position (``comms_mpi_hostbuffer_stream.cu:
354-523``).  ``bnd_rows`` lists each rank's boundary rows (rows with any
halo column) for the SpMV's boundary correction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..errors import BadParametersError


@dataclasses.dataclass
class Ring:
    """One halo ring's maps (B2L send side + receive addressing)."""

    dists: Tuple[int, ...]      # rank distances (owner − p) mod P, sorted
    send_idx: np.ndarray        # (P, B) local row ids to send (B2L map)
    send_count: np.ndarray      # (P,)
    halo_src: np.ndarray        # (P, H) d_slot·B + pos into recv buffers
    halo_count: np.ndarray      # (P,)
    halo_global: List[np.ndarray]   # per-rank global col/row ids of slots

    @property
    def B(self):
        return self.send_idx.shape[1]

    @property
    def H(self):
        return self.halo_src.shape[1]


@dataclasses.dataclass
class Partition:
    """Host-side partition descriptor (the DistributedManager analog)."""

    n_global: int               # unpadded global rows
    n_parts: int
    n_loc: int                  # padded rows per shard
    offsets: np.ndarray         # (P+1,) original row offsets per rank
    rings: List[Ring]           # ring 1 (+ ring 2 when requested)
    neighbors: List[np.ndarray]     # per-rank neighbour rank lists
    bnd_rows: np.ndarray        # (P, Bd) boundary row ids (pad → n_loc)
    bnd_count: np.ndarray       # (P,)

    # ring-1 shorthands (the SpMV pack consumes these)
    @property
    def send_idx(self):
        return self.rings[0].send_idx

    @property
    def halo_src(self):
        return self.rings[0].halo_src

    @property
    def halo_global(self):
        return self.rings[0].halo_global

    @property
    def dists(self):
        return self.rings[0].dists

    @property
    def B(self):
        return self.rings[0].B

    @property
    def H(self):
        return self.rings[0].H

    @property
    def halo_count(self):
        return self.rings[0].halo_count

    @property
    def send_count(self):
        return self.rings[0].send_count

    @property
    def ring_neighbors_only(self) -> bool:
        """Every neighbour link is rank±1 (a 1D stencil partition)."""
        return set(self.dists) <= {1, self.n_parts - 1}


def split_row_blocks(A: sp.spmatrix, offsets: np.ndarray
                     ) -> List[sp.csr_matrix]:
    """Split a global matrix into per-rank row blocks (global col ids)."""
    A = sp.csr_matrix(A)
    offsets = np.asarray(offsets)
    return [sp.csr_matrix(A[offsets[p]:offsets[p + 1]])
            for p in range(len(offsets) - 1)]


def partition_offsets_from_vector(partition_vector: np.ndarray,
                                  n_parts: int) -> np.ndarray:
    """Partition vector (rank id per row, rank-contiguous) → offsets.

    Reference: partition vectors in ``AMGX_matrix_upload_distributed``;
    rows must already be rank-contiguous (the renumbered layout)."""
    pv = np.asarray(partition_vector)
    counts = np.bincount(pv, minlength=n_parts)
    # verify contiguity
    expect = np.repeat(np.arange(n_parts), counts)
    if not np.array_equal(np.sort(pv), pv) or not np.array_equal(pv, expect):
        raise BadParametersError(
            "partition vector must be rank-contiguous (renumber rows "
            "first, as AMGX_matrix_upload_distributed requires)")
    return np.concatenate([[0], np.cumsum(counts)])


def _build_ring(targets: List[np.ndarray], owner: np.ndarray,
                offsets: np.ndarray, n_parts: int) -> Ring:
    """Build one ring's maps from each rank's needed-global-ids lists."""
    # send lists: union of what every rank needs from q, sorted —
    # deterministic layout both sides can compute
    need = [[None] * n_parts for _ in range(n_parts)]
    for p, ext in enumerate(targets):
        own = owner[ext] if len(ext) else np.zeros(0, dtype=np.int32)
        for q in np.unique(own):
            need[q][p] = ext[own == q]
    send_lists: List[np.ndarray] = []
    for q in range(n_parts):
        allneed = [need[q][p] for p in range(n_parts)
                   if need[q][p] is not None]
        s = (np.unique(np.concatenate(allneed)) if allneed
             else np.zeros(0, dtype=np.int64))
        send_lists.append(s)

    B = max(max((len(s) for s in send_lists), default=0), 1)
    H = max(max((len(h) for h in targets), default=0), 1)

    send_idx = np.zeros((n_parts, B), dtype=np.int32)
    send_count = np.zeros(n_parts, dtype=np.int32)
    for q, s in enumerate(send_lists):
        send_idx[q, :len(s)] = s - offsets[q]  # local row ids
        send_count[q] = len(s)

    dset = set()
    for p, ext in enumerate(targets):
        if len(ext):
            dset.update(int(d) for d in
                        np.unique((owner[ext] - p) % n_parts))
    dists = tuple(sorted(dset)) or (1,)
    dslot = {d: i for i, d in enumerate(dists)}

    halo_src = np.zeros((n_parts, H), dtype=np.int32)
    halo_count = np.zeros(n_parts, dtype=np.int32)
    for p, ext in enumerate(targets):
        if not len(ext):
            continue
        own = owner[ext]
        pos = np.empty(len(ext), dtype=np.int64)
        slot = np.empty(len(ext), dtype=np.int64)
        for q in np.unique(own):
            mask = own == q
            pos[mask] = np.searchsorted(send_lists[q], ext[mask])
            slot[mask] = dslot[int((q - p) % n_parts)]
        halo_src[p, :len(ext)] = slot * B + pos
        halo_count[p] = len(ext)

    return Ring(dists=dists, send_idx=send_idx, send_count=send_count,
                halo_src=halo_src, halo_count=halo_count,
                halo_global=targets)


def build_partition(A: sp.csr_matrix, n_parts: int,
                    offsets: Optional[np.ndarray] = None,
                    n_rings: int = 2) -> Partition:
    """Analyse a *global* matrix and build all halo maps (convenience
    wrapper over :func:`build_partition_from_blocks`)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    if offsets is None:
        n_loc = -(-n // n_parts)
        offsets = np.minimum(np.arange(n_parts + 1) * n_loc, n)
    else:
        offsets = np.asarray(offsets)
    return build_partition_from_blocks(split_row_blocks(A, offsets),
                                       offsets, n_rings=n_rings)


def build_partition_from_blocks(blocks: List[sp.csr_matrix],
                                offsets: np.ndarray,
                                n_rings: int = 2,
                                col_offsets: Optional[np.ndarray] = None
                                ) -> Partition:
    """Build all halo maps from per-rank row blocks (global column ids) —
    the scalable setup contract: no step touches more than one rank's
    block plus its halo rows.

    Equivalent of ``DistributedArranger::create_B2L``
    (``distributed_arranger.h:85-140`` builds B2L from per-rank data) with
    the ring-2 extension; rows keep their order — padding replaces
    interior-first renumbering because SPMD shards must be equal-sized,
    and the boundary set is carried as an explicit row list instead.

    ``col_offsets``: the COLUMN-space partition when it differs from the
    row partition — rectangular operators (classical AMG P/R transfers)
    exchange halos in their column space (reference: the distributed
    P/restriction views, ``classical_amg_level.cu:240-340``).  Ring 2 is
    row-space machinery and requires a square partition.
    """
    offsets = np.asarray(offsets)
    n_parts = len(blocks)
    rect = col_offsets is not None
    col_offsets = offsets if col_offsets is None else \
        np.asarray(col_offsets)
    n = int(col_offsets[-1])          # column-space extent (halo space)
    n_loc = int(np.max(np.diff(offsets)))
    if rect and n_rings >= 2:
        raise BadParametersError(
            "ring-2 maps are defined for square partitions only")

    # which rank owns each global COLUMN
    owner = np.zeros(n, dtype=np.int32)
    for p in range(n_parts):
        owner[col_offsets[p]:col_offsets[p + 1]] = p

    halo1: List[np.ndarray] = []
    neighbors: List[np.ndarray] = []
    bnd_lists: List[np.ndarray] = []
    for p in range(n_parts):
        lo, hi = col_offsets[p], col_offsets[p + 1]
        nrows = offsets[p + 1] - offsets[p]
        sub = blocks[p]
        cols = sub.indices
        ext_mask = (cols < lo) | (cols >= hi)
        ext = np.unique(cols[ext_mask])
        halo1.append(ext)
        neighbors.append(np.unique(owner[ext]))
        rows = np.repeat(np.arange(nrows), np.diff(sub.indptr))
        bnd_lists.append(np.unique(rows[ext_mask]))

    Bd = max(max((len(b) for b in bnd_lists), default=0), 1)
    bnd_rows = np.full((n_parts, Bd), n_loc, dtype=np.int32)  # pad→trash
    bnd_count = np.zeros(n_parts, dtype=np.int32)
    for p, bl in enumerate(bnd_lists):
        bnd_rows[p, :len(bl)] = bl
        bnd_count[p] = len(bl)

    rings = [_build_ring(halo1, owner, col_offsets, n_parts)]
    if n_rings >= 2:
        halo2: List[np.ndarray] = []
        for p in range(n_parts):
            lo, hi = offsets[p], offsets[p + 1]
            ring1 = halo1[p]
            if len(ring1):
                # ring-1 halo rows live in the owners' blocks (the
                # multi-host analog exchanges those rows neighbour-wise)
                cols2 = np.unique(np.concatenate([
                    blocks[q].indices[
                        blocks[q].indptr[r0]:blocks[q].indptr[r1]]
                    for q, r0, r1 in _owner_row_runs(ring1, owner, offsets)
                ]))
                known = np.concatenate(
                    [ring1, np.arange(lo, hi, dtype=np.int64)])
                ext2 = np.setdiff1d(cols2, known)
            else:
                ext2 = np.zeros(0, dtype=np.int64)
            halo2.append(ext2)
        rings.append(_build_ring(halo2, owner, offsets, n_parts))

    return Partition(
        n_global=int(offsets[-1]), n_parts=n_parts, n_loc=n_loc,
        offsets=offsets, rings=rings, neighbors=neighbors,
        bnd_rows=bnd_rows, bnd_count=bnd_count)


def _owner_row_runs(rows: np.ndarray, owner: np.ndarray,
                    offsets: np.ndarray):
    """Split a sorted global-row list into (owner, local_lo, local_hi+1)
    runs of CONSECUTIVE local rows so indptr slicing stays vectorised."""
    out = []
    for q in np.unique(owner[rows]):
        rq = rows[owner[rows] == q] - offsets[q]
        # split into consecutive runs
        breaks = np.where(np.diff(rq) != 1)[0] + 1
        for run in np.split(rq, breaks):
            out.append((int(q), int(run[0]), int(run[-1]) + 1))
    return out

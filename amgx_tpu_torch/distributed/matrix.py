"""Sharded ELL packs and the distributed SpMV on one device (port of
``amgx_tpu/distributed/matrix.py``; reference ``multiply.cu:75-196``,
SURVEY §3.4):

    exchange_halo → SpMV on the interior → boundary correction

The JAX package drives distribution from one process: a sharded vector
is one global array of length P·n_loc, rank-major and padded with
identity rows; ``shard_map`` runs the SpMV's per-shard body and the
exchange is a mesh collective.  The port keeps that single-controller
model with every shard on one device (:func:`make_mesh`): a sharded
vector is the flat padded (P·n_loc,) tensor on the mesh's device, so the
Krylov loops, the cycles and the CUDA graph capture take it unchanged,
and its dots and norms are the port's ordered flat ones.

* :func:`exchange_halo` moves real data on the JAX package's
  distance-wise schedule: the B2L gather ``x[send_idx]`` builds a (P, B)
  send buffer; for each rank distance d rank p receives rank
  (p + d) mod P's buffer (a roll of the shard axis by −d); the
  ``halo_src`` gather builds the (P, H) halo.  Past the
  :func:`uses_all_gather` threshold one gather of every buffer takes the
  place of the per-distance rolls.
* :func:`dist_spmv` runs every shard's interior in one launch of kernel
  B3 (:func:`~..ops.ell_spmv.ell_spmv`, called directly, never through
  the ELL dispatch of :mod:`..ops.spmv`) over one stacked (P·n_loc, K)
  pack whose local columns are rebased to p·n_loc + c and whose halo
  columns are −1: B3 skips a column outside ``[0, len(x))``, which adds
  the same bits as the JAX package's product with a zero halo slot for
  finite x.  The boundary rows then get their halo terms, a gather and a
  sum in one order (:func:`~..ops.ordered.sum_along`) written back
  row by row — each boundary row appears once, so no atomic scatter and
  no trash slot.

A b×b block pack (:func:`shard_block_matrix`, b ∈ {2..5} on the card)
keeps the JAX package's arrays — ``cols`` (P·n_loc, K) over the
[local | halo] block space, ``vals`` (P·n_loc, K, b, b), ``diag``
(P·n_loc, b, b) — and its interior runs as kernel B5 in one launch over
a stacked (P·n_loc)-block-row compact pack of every shard's local blocks
(:class:`BlockInterior`; halo blocks are left out of it).  The pack's
plan sees shard p's local block column c at p·stride + c, ``stride`` =
n_loc rounded up to the plan's 1024-column segment, so every row is cut
into the chunks its shard's own pack would give it and sums in the same
order; the codes the kernel gathers by are then rebased to p·n_loc + c.
The boundary rows' halo blocks are added after it in slot order, as in
the scalar pack.

Padding invariant (as upstream): shards are equal-sized; padding rows
are identity rows whose right-hand side and solution entries stay
exactly zero through every cycle operation.

A complex pack (b = 1 or b×b) exchanges its halo as a real one does and
applies its interior on the plain path on every device (kernels B3 and
B5 refuse complex values, as the JAX package's window kernel does); a
b×b complex pack carries no B5 interior.  A bf16 pack is the f32 pack
cast on the device (``Matrix.device``); its SpMV takes an f32 x into B3
or B5 in their (bf16, f32) pairs, accumulates in f32 and rounds once at
the end.  Shards on several cards are ROADMAP item 8c of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device, torch_dtype
from ..errors import BadParametersError, NotImplementedError_
from ..ops import binned_spmv
from ..ops.ell_spmv import ell_row_len, ell_spmv, ell_spmv_reference
from ..ops.ordered import mul, sum_along
from .partition import Partition, build_partition_from_blocks, \
    split_row_blocks


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh of ``n_parts`` shards on one torch device (the port's
    counterpart of ``jax.make_mesh((P,), ("p",))``)."""

    n_parts: int
    device: torch.device
    axis: str = "p"


def make_mesh(n_parts: int, device=None, axis: str = "p") -> DeviceMesh:
    """A mesh of ``n_parts`` shards on one device: the card by default,
    the CPU when ``device="cpu"``.  A sequence of several devices (one
    shard per card) is ROADMAP item 8c of the port and raises."""
    if isinstance(device, (list, tuple)):
        if len({str(torch.device(d)) for d in device}) > 1:
            raise NotImplementedError_(
                f"a mesh over {len(device)} devices (shards on several "
                "cards) is ROADMAP item 8c of the port")
        device = device[0] if device else None
    n_parts = int(n_parts)
    if n_parts < 1:
        raise BadParametersError(f"a mesh needs at least one shard, got "
                                 f"{n_parts}")
    return DeviceMesh(n_parts=n_parts,
                      device=resolve_device("cuda" if device is None
                                            else device),
                      axis=str(axis))


def check_mesh(mesh, axis: str = "p") -> DeviceMesh:
    """``mesh`` as a :class:`DeviceMesh` over axis ``axis``; anything
    else raises."""
    if not isinstance(mesh, DeviceMesh):
        raise BadParametersError(
            f"expected a mesh from amgx_tpu_torch.distributed.make_mesh, "
            f"got {type(mesh).__name__}")
    if axis != mesh.axis:
        raise BadParametersError(f"mesh axis {mesh.axis!r}, asked for "
                                 f"{axis!r}")
    return mesh


@dataclasses.dataclass(frozen=True)
class ShardedMatrix:
    """Frozen sharded ELL pack on one device.

    ``cols``/``vals`` are the stacked interior pack (P·n_loc, K): row
    p·n_loc + l is shard p's local row l, its local columns rebased to
    p·n_loc_cols + c, its halo columns −1 (kernel B3 skips them).  The
    halo maps are flat: ``send_idx`` (P, B) the columns of x each rank
    sends (the B2L map, rebased), ``halo_src`` (P, H) the d_slot·B +
    position of each halo slot in the received buffers; ring 2 likewise
    (square packs only).  ``bnd_rows`` (Nb,) are the flat boundary rows
    of every shard, ``bnd_vals``/``bnd_hidx`` (Nb, Kb) their halo
    entries in slot order and each entry's index into the flat (P·H)
    halo (a zero slot at P·H pads short rows).  A b×b pack
    (``block_dim`` > 1) holds ``vals`` (P·n_loc, K, b, b), ``diag``
    (P·n_loc, b, b), ``bnd_vals`` (Nb, Kb, b, b), no ``row_len``, and
    its interior as the compact pack of kernel B5 (``interior``).
    ``host_cols`` keeps the host (P, n_loc, K) [local | halo] columns
    (the colored smoothers' per-shard slabs read them)."""

    cols: torch.Tensor
    vals: torch.Tensor
    row_len: Optional[torch.Tensor]
    diag: torch.Tensor
    send_idx: torch.Tensor
    halo_src: torch.Tensor
    send_idx2: Optional[torch.Tensor]
    halo_src2: Optional[torch.Tensor]
    bnd_rows: torch.Tensor
    bnd_vals: torch.Tensor
    bnd_hidx: torch.Tensor
    #: (n_global,) padded slot of each real row (:func:`pad_map`)
    pad_idx: torch.Tensor
    #: (P, D) source rank of each received buffer, for the rings past
    #: :func:`uses_all_gather` (None on the per-distance schedule)
    gather_order: Optional[torch.Tensor]
    gather_order2: Optional[torch.Tensor]
    n_global: int
    n_parts: int
    n_loc: int
    ell_width: int
    axis: str
    dists: tuple
    dists2: tuple
    offsets: tuple
    mesh: DeviceMesh
    n_loc_cols: Optional[int] = None
    col_offsets: Optional[tuple] = None
    send_counts: tuple = ()
    halo_counts: tuple = ()
    halo_counts2: tuple = ()
    bnd_counts: tuple = ()
    block_dim: int = 1
    interior: Optional["BlockInterior"] = None
    host_cols: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)

    fmt = "sharded-ell"

    @property
    def n(self) -> int:
        """Padded global scalar size (P·n_loc·b): the vector length."""
        return self.n_parts * self.n_loc * self.block_dim

    @property
    def n_rows(self) -> int:
        return self.n_parts * self.n_loc

    @property
    def n_cols(self) -> int:
        """Padded global column size."""
        return self.n_parts * (self.n_loc_cols if self.n_loc_cols
                               is not None else self.n_loc)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def halo_entries(self) -> int:
        """Ring-1 halo values one SpMV moves (the partition's unpadded
        halo sizes, summed over the ranks)."""
        return int(sum(self.halo_counts))

    def astype(self, dtype) -> "ShardedMatrix":
        dt = torch_dtype(dtype)
        return dataclasses.replace(
            self, vals=self.vals.to(dt), diag=self.diag.to(dt),
            bnd_vals=self.bnd_vals.to(dt),
            interior=None if self.interior is None
            else self.interior.astype(dt))


@dataclasses.dataclass(frozen=True)
class BlockInterior:
    """The stacked block interior of a b×b sharded pack, as kernel B5
    reads it: the compact pack (:class:`~..ops.binned_spmv.CompactPack`)
    of the binned plan of every shard's local blocks, its bin
    permutation (``pos``, None for the identity), the kernel's inverse
    of it (``row_of_pos``) and the plan's dims (``dims[8]`` the P·n_loc
    block columns the codes index)."""

    compact: binned_spmv.CompactPack
    pos: Optional[torch.Tensor]
    row_of_pos: Optional[torch.Tensor]
    dims: tuple

    def astype(self, dtype) -> "BlockInterior":
        return dataclasses.replace(self, compact=self.compact.astype(dtype))


def pad_map(offsets: np.ndarray, n_loc: int) -> np.ndarray:
    """real global row id → padded id (rank p, local l → p·n_loc + l)."""
    offsets = np.asarray(offsets)
    n_parts = len(offsets) - 1
    out = np.empty(int(offsets[-1]), dtype=np.int64)
    for p in range(n_parts):
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        out[lo:hi] = p * n_loc + np.arange(hi - lo)
    return out


def embed_padded(M: sp.csr_matrix, row_offsets, row_nloc,
                 col_offsets, col_nloc) -> sp.csr_matrix:
    """Re-index a real-sized sparse matrix into padded coordinates (pad
    rows and columns stay empty)."""
    M = sp.coo_matrix(M)
    rmap = pad_map(np.asarray(row_offsets), row_nloc)
    cmap = pad_map(np.asarray(col_offsets), col_nloc)
    n_parts = len(row_offsets) - 1
    shape = (n_parts * row_nloc, (len(col_offsets) - 1) * col_nloc)
    return sp.csr_matrix((M.data, (rmap[M.row], cmap[M.col])), shape=shape)


def shard_arrays(blocks, part: Partition, dtype, rect: bool = False,
                 col_offsets=None, n_loc_cols: Optional[int] = None):
    """The JAX package's per-shard ELL arrays ``(cols, vals, diag)`` of
    shape (P, n_loc, K) / (P, n_loc), on the host: columns index the
    shard's extended vector ``[x_local (n_loc_cols) | halo (H)]``,
    padding rows are identity rows (zero rows in a rectangular pack)."""
    n_parts, n_loc = part.n_parts, part.n_loc
    col_offsets = part.offsets if col_offsets is None else \
        np.asarray(col_offsets)
    nlc = n_loc if n_loc_cols is None else int(n_loc_cols)
    K = max((int(np.diff(b.indptr).max()) if b.nnz else 1
             for b in blocks), default=1)
    cols = np.zeros((n_parts, n_loc, K), dtype=np.int32)
    vals = np.zeros((n_parts, n_loc, K), dtype=dtype)
    diag = np.zeros((n_parts, n_loc), dtype=dtype)
    for p in range(n_parts):
        lo, hi = part.offsets[p], part.offsets[p + 1]
        clo, chi = col_offsets[p], col_offsets[p + 1]
        nl = hi - lo
        sub = blocks[p]
        sub.sort_indices()
        ext = part.halo_global[p]
        gcols = sub.indices.astype(np.int64)
        local = (gcols >= clo) & (gcols < chi)
        lcols = np.where(local, gcols - clo, 0)
        if len(ext):
            halo_slot = np.minimum(np.searchsorted(ext, gcols),
                                   len(ext) - 1)
            lcols = np.where(local, lcols, nlc + halo_slot)
        deg = np.diff(sub.indptr)
        rr = np.repeat(np.arange(nl), deg)
        pos = np.arange(len(gcols)) - np.repeat(sub.indptr[:-1], deg)
        cols[p, rr, pos] = lcols
        vals[p, rr, pos] = sub.data
        if not rect:
            on_diag = gcols == rr + lo
            # duplicate diagonal entries are legal CSR input: added
            w = sub.data[on_diag]
            d = np.bincount(rr[on_diag], weights=w.real, minlength=n_loc)
            if np.iscomplexobj(w):
                d = d + 1j * np.bincount(rr[on_diag], weights=w.imag,
                                         minlength=n_loc)
            diag[p] += d.astype(dtype)
            r = np.arange(nl, n_loc)
            cols[p, r, 0] = r
            vals[p, r, 0] = 1.0
            diag[p, r] = 1.0
    return cols, vals, diag


def stacked_interior(cols: np.ndarray, nlc: int) -> np.ndarray:
    """The (P·n_loc, K) column table of one B3 launch over every shard:
    shard p's local column c becomes p·nlc + c, a halo column −1."""
    n_parts = cols.shape[0]
    if n_parts * nlc >= 2**31:
        raise BadParametersError(
            f"{n_parts}·{nlc} columns exceed the kernel's int32 columns")
    base = (np.arange(n_parts, dtype=np.int32) * np.int32(nlc))[:, None,
                                                                None]
    out = np.where(cols < nlc, cols + base, np.int32(-1))
    return out.reshape(-1, cols.shape[2])


def _boundary_terms(cols: np.ndarray, vals: np.ndarray, part: Partition,
                    nlc: int):
    """The boundary correction's tables: flat boundary rows (Nb,), their
    halo entries' values (Nb, Kb[, b, b]) and flat halo indices (Nb, Kb),
    in slot order (a short row pads with value 0 at the zero slot
    P·H)."""
    n_parts, n_loc, _ = cols.shape
    H = part.H
    rows, vs, hs = [], [], []
    for p in range(n_parts):
        cnt = int(part.bnd_count[p])
        if not cnt:
            continue
        br = part.bnd_rows[p, :cnt].astype(np.int64)
        c = cols[p, br]
        is_h = c >= nlc
        rows.append(p * n_loc + br)
        vs.append((vals[p, br], is_h))
        hs.append(np.where(is_h, p * H + (c.astype(np.int64) - nlc), -1))
    trail = vals.shape[3:]
    if not rows:
        return (np.zeros(0, np.int64), np.zeros((0, 1) + trail, vals.dtype),
                np.zeros((0, 1), np.int64))
    bnd = np.concatenate(rows)
    kb = max(int(m.sum(axis=1).max()) for _, m in vs)
    bv = np.zeros((len(bnd), kb) + trail, dtype=vals.dtype)
    bh = np.full((len(bnd), kb), n_parts * H, dtype=np.int64)
    at = 0
    for (v, m), h in zip(vs, hs):
        nb = v.shape[0]
        # each row's halo entries moved to the front, in slot order
        pos = np.cumsum(m, axis=1) - 1
        r, k = np.nonzero(m)
        bv[at + r, pos[r, k]] = v[r, k]
        bh[at + r, pos[r, k]] = h[r, k]
        at += nb
    return bnd, bv, bh


def shard_matrix(A: sp.csr_matrix, mesh: DeviceMesh, axis: str = "p",
                 dtype=None, offsets=None, n_loc: Optional[int] = None,
                 partition: Optional[Partition] = None) -> ShardedMatrix:
    """Pack a global CSR matrix into a :class:`ShardedMatrix` over
    ``mesh`` (splits it into per-rank row blocks first; equal row blocks
    unless ``offsets`` or ``partition`` give them)."""
    A = sp.csr_matrix(A)
    mesh = check_mesh(mesh, axis)
    if partition is not None:
        offsets = np.asarray(partition.offsets)
    elif offsets is None:
        n = A.shape[0]
        nl = -(-n // mesh.n_parts)
        offsets = np.minimum(np.arange(mesh.n_parts + 1) * nl, n)
    else:
        offsets = np.asarray(offsets)
    return shard_matrix_from_blocks(split_row_blocks(A, offsets), offsets,
                                    mesh, axis=axis, dtype=dtype,
                                    n_loc=n_loc, partition=partition)


def shard_matrix_from_blocks(blocks, offsets, mesh: DeviceMesh,
                             axis: str = "p", dtype=None,
                             n_loc: Optional[int] = None,
                             partition: Optional[Partition] = None,
                             col_offsets=None,
                             n_loc_cols: Optional[int] = None
                             ) -> ShardedMatrix:
    """Pack per-rank row blocks (global column ids) into a
    :class:`ShardedMatrix` (``AMGX_matrix_upload_distributed``
    semantics: no step assembles a global matrix; the halo maps come
    from :func:`~.partition.build_partition_from_blocks`).
    ``col_offsets``/``n_loc_cols``: a rectangular operator whose column
    space is partitioned otherwise (its halo lives in the column space,
    its padding rows are zero rows and it carries no ring 2)."""
    blocks = [sp.csr_matrix(b) for b in blocks]
    offsets = np.asarray(offsets)
    mesh = check_mesh(mesh, axis)
    rect = col_offsets is not None
    dtype = np.dtype(dtype or blocks[0].dtype)
    _check_pack_dtype(dtype)
    n_parts = mesh.n_parts
    if len(blocks) != n_parts:
        raise BadParametersError(
            f"{len(blocks)} row blocks for a {n_parts}-way mesh axis")
    part = partition or build_partition_from_blocks(
        blocks, offsets, n_rings=1 if rect else 2, col_offsets=col_offsets)
    if n_loc is not None and n_loc > part.n_loc:
        part = dataclasses.replace(part, n_loc=int(n_loc))
    n_loc = part.n_loc
    if rect:
        col_offsets = np.asarray(col_offsets)
        nlc = int(n_loc_cols or np.max(np.diff(col_offsets)))
    else:
        col_offsets = part.offsets
        nlc = n_loc
    cols, vals, diag = shard_arrays(blocks, part, dtype, rect=rect,
                                    col_offsets=col_offsets, n_loc_cols=nlc)
    bnd, bv, bh = _boundary_terms(cols, vals, part, nlc)
    dev = mesh.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    flat_vals = up(vals.reshape(-1, vals.shape[2]))
    r1 = part.rings[0]
    base = np.arange(n_parts, dtype=np.int64)[:, None] * nlc
    r2 = part.rings[1] if len(part.rings) > 1 else None
    order1 = _gather_order(part.dists, n_parts)
    order2 = None if r2 is None else _gather_order(r2.dists, n_parts)
    return ShardedMatrix(
        cols=up(stacked_interior(cols, nlc)), vals=flat_vals,
        row_len=ell_row_len(flat_vals), diag=up(diag.reshape(-1)),
        send_idx=up(r1.send_idx.astype(np.int64) + base),
        halo_src=up(r1.halo_src.astype(np.int64)),
        send_idx2=None if r2 is None else
        up(r2.send_idx.astype(np.int64) + base),
        halo_src2=None if r2 is None else up(r2.halo_src.astype(np.int64)),
        bnd_rows=up(bnd), bnd_vals=up(bv), bnd_hidx=up(bh),
        pad_idx=up(pad_map(part.offsets, n_loc)),
        gather_order=None if order1 is None else up(order1),
        gather_order2=None if order2 is None else up(order2),
        n_global=part.n_global, n_parts=n_parts, n_loc=n_loc,
        ell_width=int(cols.shape[2]), axis=axis, dists=part.dists,
        dists2=(1,) if r2 is None else r2.dists,
        offsets=tuple(int(o) for o in part.offsets), mesh=mesh,
        n_loc_cols=nlc if rect else None,
        col_offsets=tuple(int(o) for o in col_offsets) if rect else None,
        send_counts=tuple(int(c) for c in part.send_count),
        halo_counts=tuple(int(c) for c in part.halo_count),
        halo_counts2=() if r2 is None else
        tuple(int(c) for c in r2.halo_count),
        bnd_counts=tuple(int(c) for c in part.bnd_count),
        host_cols=cols)


def _check_pack_dtype(dtype) -> None:
    """A sharded pack holds f32/f64 or c64/c128 values (a bf16 pack is
    the f32 pack cast on the device, ``Matrix.device``)."""
    if not (np.issubdtype(dtype, np.floating)
            or np.issubdtype(dtype, np.complexfloating)):
        raise BadParametersError(f"a sharded pack holds floating or "
                                 f"complex values, not {dtype}")


def split_bsr_rows(bsr: sp.bsr_matrix, offsets) -> list:
    """Per-rank BSR row blocks of a b×b matrix (block-row ``offsets``;
    global block columns kept)."""
    b = bsr.blocksize[0]
    out = []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        s0, s1 = bsr.indptr[lo], bsr.indptr[hi]
        out.append(sp.bsr_matrix(
            (bsr.data[s0:s1], bsr.indices[s0:s1],
             bsr.indptr[lo:hi + 1] - s0),
            shape=((hi - lo) * b, bsr.shape[1]), blocksize=(b, b)))
    return out


def _index_blocks(bsr_blocks, nb_cols: int) -> list:
    """The block graph of each rank's BSR row block as an index CSR
    whose entry (I, J) holds its block's position + 1 (the halo
    machinery then runs on the block graph, as upstream)."""
    out = []
    for blk in bsr_blocks:
        out.append(sp.csr_matrix(
            (np.arange(len(blk.indices), dtype=np.int64) + 1, blk.indices,
             blk.indptr), shape=(len(blk.indptr) - 1, nb_cols)))
    return out


def shard_block_arrays(bsr_blocks, ind_blocks, part: Partition, dtype):
    """The JAX package's block arrays ``(cols, vals, diag)`` of shape
    (P, n_loc, K), (P, n_loc, K, b, b) and (P, n_loc, b, b), on the host:
    block columns index the shard's extended block vector
    ``[x_local (n_loc) | halo (H)]``; padding rows are identity rows
    (``shard_block_matrix`` upstream, ``matrix.py:368-430``)."""
    n_parts, n_loc = part.n_parts, part.n_loc
    b = bsr_blocks[0].blocksize[0]
    K = max((int(np.diff(blk.indptr).max()) if blk.nnz else 1
             for blk in ind_blocks), default=1)
    cols = np.zeros((n_parts, n_loc, K), dtype=np.int32)
    vals = np.zeros((n_parts, n_loc, K, b, b), dtype=dtype)
    diag = np.zeros((n_parts, n_loc, b, b), dtype=dtype)
    eye = np.eye(b, dtype=dtype)
    for p in range(n_parts):
        lo, hi = part.offsets[p], part.offsets[p + 1]
        nl = hi - lo
        sub = ind_blocks[p]
        sub.sort_indices()
        data = bsr_blocks[p].data
        ext = part.halo_global[p]
        gcols = sub.indices.astype(np.int64)
        local = (gcols >= lo) & (gcols < hi)
        lcols = np.where(local, gcols - lo, 0)
        if len(ext):
            halo_slot = np.minimum(np.searchsorted(ext, gcols),
                                   len(ext) - 1)
            lcols = np.where(local, lcols, n_loc + halo_slot)
        deg = np.diff(sub.indptr)
        rr = np.repeat(np.arange(nl), deg)
        pos = np.arange(len(gcols)) - np.repeat(sub.indptr[:-1], deg)
        cols[p, rr, pos] = lcols
        vals[p, rr, pos] = data[sub.data - 1]
        on_diag = gcols == rr + lo
        np.add.at(diag[p], rr[on_diag], data[sub.data[on_diag] - 1])
        r = np.arange(nl, n_loc)
        cols[p, r, 0] = r
        vals[p, r, 0] = eye
        diag[p, r] = eye
    return cols, vals, diag


#: the column segment of the binned plan (``_SB``·``_T`` columns)
_SEGMENT = binned_spmv._SB * binned_spmv._T


def local_block_csr(bsr_blocks, part: Partition, dtype, p: int
                    ) -> sp.bsr_matrix:
    """Shard ``p``'s local (n_loc × n_loc) block matrix in local block
    columns, identity blocks on its padding rows: the rows kernel B5
    runs for the shard in the stacked interior."""
    b = bsr_blocks[0].blocksize[0]
    n_loc = part.n_loc
    lo, hi = int(part.offsets[p]), int(part.offsets[p + 1])
    blk = bsr_blocks[p]
    deg = np.diff(blk.indptr)
    rows = np.repeat(np.arange(hi - lo), deg)
    keep = (blk.indices >= lo) & (blk.indices < hi)
    pad = np.arange(hi - lo, n_loc)
    rows = np.concatenate([rows[keep], pad])
    cols = np.concatenate([blk.indices[keep] - lo, pad])
    data = np.concatenate([blk.data[keep].astype(dtype),
                           np.broadcast_to(np.eye(b, dtype=dtype),
                                           (len(pad), b, b))])
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=n_loc))]).astype(np.int64)
    return sp.bsr_matrix((data[order], cols[order], indptr),
                         shape=(n_loc * b, n_loc * b), blocksize=(b, b))


def binned_interior(bsr: sp.bsr_matrix, n_cols: int, dtype, device,
                    remap=None) -> BlockInterior:
    """The compact B5 pack of a block matrix (``n_cols`` block columns of
    the plan), derived on ``device``; ``remap`` rebases the plan's
    column codes to the columns the kernel gathers by (their count
    replaces ``dims[8]``)."""
    b = bsr.blocksize[0]
    out = binned_spmv.csr_binned_pack(bsr.indptr, bsr.indices, bsr.data,
                                      n_cols, dtype, block_dim=b)
    if out is None:
        raise BadParametersError(
            "a sharded b×b interior outside the binned pack's padding "
            "budget")
    arrays, dims = out
    codes = arrays["bn_codes"]
    if remap is not None:
        codes, n_x = remap(codes)
        dims = dims[:8] + (int(n_x),) + dims[9:]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    pos = arrays.get("bn_pos")
    pos_t = None if pos is None else up(pos)
    cp = binned_spmv.compact_pack(up(codes), up(arrays["bn_vals"]),
                                  up(arrays["bn_meta"]), dims)
    return BlockInterior(compact=cp, pos=pos_t,
                         row_of_pos=binned_spmv.kernel_aux(pos_t, dims),
                         dims=dims)


def stacked_block_interior(bsr_blocks, part: Partition, dtype, device
                           ) -> BlockInterior:
    """One B5 pack over every shard's local blocks: shard p's block row l
    is row p·n_loc + l; its plan column p·stride + c (``stride`` = n_loc
    rounded up to a 1024-column segment, so each row is chunked as in
    its shard's own pack), its gather column p·n_loc + c."""
    n_parts, n_loc = part.n_parts, part.n_loc
    b = bsr_blocks[0].blocksize[0]
    stride = -(-n_loc // _SEGMENT) * _SEGMENT
    if n_parts * stride >= 2**31:
        raise BadParametersError(
            f"{n_parts}·{stride} block columns exceed the kernel's int32 "
            "codes")
    locs = [local_block_csr(bsr_blocks, part, dtype, p)
            for p in range(n_parts)]
    start = np.cumsum([0] + [loc.indptr[-1] for loc in locs])
    indptr = np.concatenate(
        [[0]] + [loc.indptr[1:] + start[p] for p, loc in enumerate(locs)]
    ).astype(np.int64)
    indices = np.concatenate([loc.indices.astype(np.int64) + p * stride
                              for p, loc in enumerate(locs)])
    data = np.concatenate([loc.data for loc in locs])
    stacked = sp.bsr_matrix((data, indices, indptr),
                            shape=(n_parts * n_loc * b, n_parts * stride * b),
                            blocksize=(b, b))

    def remap(codes):
        c = codes.astype(np.int64)
        return ((c // stride) * n_loc + c % stride).astype(np.int32), \
            n_parts * n_loc

    return binned_interior(stacked, n_parts * stride, dtype, device,
                           remap=remap)


def shard_block_matrix(host, block_dim: int, mesh: DeviceMesh,
                       axis: str = "p", dtype=None, offsets=None,
                       n_loc: Optional[int] = None) -> ShardedMatrix:
    """Pack a b×b block matrix (a BSR, or anything scipy converts) into a
    :class:`ShardedMatrix` over ``mesh``: block-row partition (equal
    unless ``offsets`` gives it), flat (P·n_loc·b) vectors — the
    reference's uniform block-CSR distribution (``matrix.h:87-220``)."""
    b = int(block_dim)
    bsr = host if isinstance(host, sp.bsr_matrix) and \
        host.blocksize == (b, b) else sp.bsr_matrix(host, blocksize=(b, b))
    bsr.sort_indices()
    mesh = check_mesh(mesh, axis)
    nb = bsr.shape[0] // b
    if offsets is None:
        nl = -(-nb // mesh.n_parts)
        offsets = np.minimum(np.arange(mesh.n_parts + 1) * nl, nb)
    offsets = np.asarray(offsets)
    return shard_block_matrix_from_blocks(
        split_bsr_rows(bsr, offsets), offsets, mesh, axis=axis,
        dtype=dtype, n_loc=n_loc)


def shard_block_matrix_from_blocks(bsr_blocks, offsets, mesh: DeviceMesh,
                                   axis: str = "p", dtype=None,
                                   n_loc: Optional[int] = None
                                   ) -> ShardedMatrix:
    """Pack per-rank b×b row blocks (BSR, global block columns) into a
    :class:`ShardedMatrix`: the halo maps of the block graph, the JAX
    package's arrays (:func:`shard_block_arrays`), the stacked interior
    of kernel B5 (:func:`stacked_block_interior`) and the boundary
    tables of the halo blocks."""
    offsets = np.asarray(offsets)
    mesh = check_mesh(mesh, axis)
    b = int(bsr_blocks[0].blocksize[0])
    for blk in bsr_blocks:
        blk.sort_indices()
    dtype = np.dtype(dtype or bsr_blocks[0].dtype)
    _check_pack_dtype(dtype)
    n_parts = mesh.n_parts
    if len(bsr_blocks) != n_parts:
        raise BadParametersError(
            f"{len(bsr_blocks)} row blocks for a {n_parts}-way mesh axis")
    nb_cols = bsr_blocks[0].shape[1] // b
    ind_blocks = _index_blocks(bsr_blocks, nb_cols)
    part = build_partition_from_blocks(ind_blocks, offsets, n_rings=2)
    if n_loc is not None and n_loc > part.n_loc:
        part = dataclasses.replace(part, n_loc=int(n_loc))
    n_loc = part.n_loc
    cols, vals, diag = shard_block_arrays(bsr_blocks, ind_blocks, part,
                                          dtype)
    bnd, bv, bh = _boundary_terms(cols, vals, part, n_loc)
    dev = mesh.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    r1, r2 = part.rings[0], part.rings[1]
    base = np.arange(n_parts, dtype=np.int64)[:, None] * n_loc
    order1 = _gather_order(part.dists, n_parts)
    order2 = _gather_order(r2.dists, n_parts)
    pm = pad_map(part.offsets, n_loc)
    return ShardedMatrix(
        cols=up(stacked_interior(cols, n_loc)),
        vals=up(vals.reshape((-1,) + vals.shape[2:])), row_len=None,
        diag=up(diag.reshape(-1, b, b)),
        send_idx=up(r1.send_idx.astype(np.int64) + base),
        halo_src=up(r1.halo_src.astype(np.int64)),
        send_idx2=up(r2.send_idx.astype(np.int64) + base),
        halo_src2=up(r2.halo_src.astype(np.int64)),
        bnd_rows=up(bnd), bnd_vals=up(bv), bnd_hidx=up(bh),
        pad_idx=up((pm[:, None] * b + np.arange(b)).reshape(-1)),
        gather_order=None if order1 is None else up(order1),
        gather_order2=None if order2 is None else up(order2),
        n_global=part.n_global, n_parts=n_parts, n_loc=n_loc,
        ell_width=int(cols.shape[2]), axis=axis, dists=part.dists,
        dists2=r2.dists, offsets=tuple(int(o) for o in part.offsets),
        mesh=mesh, send_counts=tuple(int(c) for c in part.send_count),
        halo_counts=tuple(int(c) for c in part.halo_count),
        halo_counts2=tuple(int(c) for c in r2.halo_count),
        bnd_counts=tuple(int(c) for c in part.bnd_count), block_dim=b,
        interior=None if np.issubdtype(dtype, np.complexfloating)
        else stacked_block_interior(bsr_blocks, part, dtype, dev),
        host_cols=cols)


# --------------------------------------------------------------------------
# the halo exchange and the distributed SpMV
# --------------------------------------------------------------------------
def uses_all_gather(dists: tuple, n_parts: int) -> bool:
    """The exchange-path predicate: a dense link set takes one gather of
    every buffer in place of the per-distance schedule."""
    return n_parts > 1 and len(dists) >= n_parts - 1


def _gather_order(dists: tuple, n_parts: int) -> Optional[np.ndarray]:
    """(P, D) source rank (p + d) mod P of each buffer rank p receives,
    when ``dists`` takes the gather of every buffer; else None."""
    if not uses_all_gather(dists, n_parts):
        return None
    return (np.arange(n_parts)[:, None] + np.asarray(dists)[None]) \
        % n_parts


def _exchange(buf: torch.Tensor, dists: tuple, n_parts: int,
              order: Optional[torch.Tensor]) -> torch.Tensor:
    """Distance-wise neighbour exchange of the (P, B) send buffers: row p
    of the result holds, for each d in ``dists`` in turn, rank
    (p + d) mod P's buffer — one roll of the shard axis by −d each (the
    JAX package's ``ppermute`` per distance), or past
    :func:`uses_all_gather` one gather of every rank's buffers in the
    same order."""
    if n_parts == 1:
        return buf
    if order is not None:
        # b×b packs send (B, b) buffers: keep the trailing components
        return buf[order].reshape((n_parts, -1) + buf.shape[2:])
    return torch.cat([torch.roll(buf, -d, 0) for d in dists], dim=1)


def _tel_exchange(A: ShardedMatrix, ring: int, op: str) -> None:
    """Halo-exchange telemetry (``_tel_exchange`` upstream; one attribute
    check when off): the exchange, its bytes (the padded send buffers,
    once per rank distance or P − 1 times on the gather of every
    buffer) and its useful entries, counted per call — a graph's capture
    counts its exchanges once."""
    from ..telemetry import costmodel, metrics, recorder
    if not recorder.is_enabled():
        return
    dists = A.dists if ring == 1 else A.dists2
    path = "all_gather" if uses_all_gather(dists, A.n_parts) \
        else "ppermute"
    wire = costmodel.halo_wire_bytes(A, ring)
    entries = costmodel.halo_entries(A, ring)
    send_idx = A.send_idx if ring == 1 else A.send_idx2
    n_coll = 1 if path == "all_gather" else len(dists)
    metrics.counter_inc("amgx_halo_exchange_total", ring=ring, op=op,
                        path=path)
    metrics.counter_inc("amgx_halo_bytes_total", wire, ring=ring, op=op)
    metrics.counter_inc("amgx_halo_entries_total", entries, ring=ring,
                        op=op)
    metrics.gauge_set("amgx_dist_ring_hops", n_coll, ring=ring)
    counts = A.halo_counts if ring == 1 else A.halo_counts2
    recorder.event(
        "halo_exchange", op=op, ring=ring, path=path, n_parts=A.n_parts,
        hops=n_coll, send_buf=int(send_idx.shape[1]),
        wire_bytes=int(wire), entries=int(entries),
        per_rank_entries=list(counts) if counts else None)


def exchange_halo(A: ShardedMatrix, x: torch.Tensor, ring: int = 1,
                  op: str = "exchange_halo") -> torch.Tensor:
    """The ring-``ring`` halo values of the sharded ``x``: a (P, H_ring)
    tensor — (P, H_ring, b) for a b×b pack — whose row p holds the
    values of ``partition.rings[ring-1].halo_global[p]``.  Its device
    work runs in the ``amgx/dist/halo_exchange`` scope."""
    if ring not in (1, 2):
        raise BadParametersError(f"halo ring must be 1 or 2, got {ring}")
    if ring == 2 and A.send_idx2 is None:
        raise BadParametersError("a rectangular pack carries no ring 2")
    from ..telemetry import recorder
    from ..telemetry.scopes import scope
    _tel_exchange(A, ring, op)
    sid = recorder.span_begin("exchange_halo",
                              {"ring": ring, "n_parts": A.n_parts})
    try:
        with scope("dist", "halo_exchange"):
            return _exchange_halo(A, x, ring)
    finally:
        recorder.span_end(sid, "exchange_halo")


def _exchange_halo(A: ShardedMatrix, x: torch.Tensor, ring: int
                   ) -> torch.Tensor:
    send_idx = A.send_idx if ring == 1 else A.send_idx2
    halo_src = A.halo_src if ring == 1 else A.halo_src2
    dists = A.dists if ring == 1 else A.dists2
    order = A.gather_order if ring == 1 else A.gather_order2
    b = A.block_dim
    if b == 1:
        got = _exchange(x[send_idx], dists, A.n_parts, order)
        return torch.gather(got, 1, halo_src)
    got = _exchange(x.reshape(-1, b)[send_idx], dists, A.n_parts, order)
    rank = torch.arange(A.n_parts, device=got.device)[:, None]
    return got[rank, halo_src]


def _pair_ok(A: ShardedMatrix, x: torch.Tensor) -> bool:
    """x in the pack's dtype, or f32 through a bf16 pack."""
    return x.dtype == A.dtype or (A.dtype == torch.bfloat16
                                  and x.dtype == torch.float32)


def dist_spmv(A: ShardedMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for the flat sharded ``x`` of length P·n_loc_cols: the
    halo exchange, every shard's interior in one call of kernel B3 (its
    plain version on a CPU tensor or a complex pack), then the boundary
    rows' halo terms summed in slot order and added row by row.  A bf16
    pack takes an f32 x (``ops.spmv`` widens a bf16 one) and returns y
    in f32: B3's (bf16, f32) pair, the boundary products in f32."""
    if not _pair_ok(A, x):
        raise BadParametersError(
            f"dist_spmv: a {A.dtype} pack takes a {A.dtype} vector, got "
            f"{x.dtype}")
    if A.block_dim > 1:
        return _dist_spmv_block(A, x)
    halo = exchange_halo(A, x, 1, op="dist_spmv")
    if A.dtype.is_complex:
        y = ell_spmv_reference(A.cols, A.vals, x)
    else:
        y = ell_spmv(A.cols, A.vals, x, A.row_len)
    if A.bnd_rows.numel():
        hz = torch.cat([halo.reshape(-1), halo.new_zeros(1)])
        corr = sum_along(mul(A.bnd_vals, hz[A.bnd_hidx]), 1)
        y[A.bnd_rows] = y[A.bnd_rows] + corr
    return y


def _block_slots(vals: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(N, b): per slot the b×b block of ``vals`` (N, K, b, b) times its
    gathered x block ``g`` (N, K, b), component c added in order, then
    the slots added in slot order."""
    return sum_along(sum_along(mul(vals, g[:, :, None, :]), 3), 1)


def _block_interior_plain(A: ShardedMatrix, x: torch.Tensor
                          ) -> torch.Tensor:
    """The stacked block interior of a complex b×b pack on the plain
    path (:func:`_block_slots`); halo slots (−1) add nothing."""
    b = A.block_dim
    xb = torch.cat([x.reshape(-1, b), x.new_zeros((1, b))])
    cols = torch.where(A.cols < 0, xb.shape[0] - 1, A.cols).long()
    return _block_slots(A.vals, xb[cols]).reshape(-1)


def _dist_spmv_block(A: ShardedMatrix, x: torch.Tensor) -> torch.Tensor:
    """The b×b distributed SpMV (``_dist_spmv_block`` upstream): the halo
    exchange of (B, b) block values, every shard's interior in one call
    of kernel B5 over the stacked compact pack (its plain version on a
    CPU tensor; :func:`_block_interior_plain` for a complex pack), then
    each boundary row's halo blocks — per slot the b×b block times its
    halo block, component c added in order, then the slots in slot
    order — added row by row."""
    b = A.block_dim
    halo = exchange_halo(A, x, 1, op="dist_spmv")
    I = A.interior
    if I is None:
        y = _block_interior_plain(A, x)
    else:
        y = binned_spmv.compact_spmv(I.compact, I.pos, I.row_of_pos,
                                     I.dims, x)
    if A.bnd_rows.numel():
        hz = torch.cat([halo.reshape(-1, b), halo.new_zeros((1, b))])
        corr = _block_slots(A.bnd_vals, hz[A.bnd_hidx])   # (Nb, b)
        yb = y.reshape(-1, b)
        yb[A.bnd_rows] = yb[A.bnd_rows] + corr
    return y


def shard_vector(A: ShardedMatrix, v) -> torch.Tensor:
    """A real-sized global vector padded to P·n_loc·b on the pack's device
    in its dtype (rank p's rows at [p·n_loc, p·n_loc + count_p), ×b
    scalar entries each); a
    vector already of the padded length is taken as is.  The
    ``halo_exchange`` fault point fails here, at the distributed solve's
    host seam, with the device-error code."""
    from ..utils import faultinject
    if faultinject.active():
        from ..errors import RC, AMGXError
        faultinject.maybe_raise(
            "halo_exchange",
            AMGXError("injected halo-exchange failure", RC.CUDA_FAILURE))
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
    v = v.to(device=A.device, dtype=A.dtype)
    if v.shape[0] == A.n:
        return v.contiguous()
    out = torch.zeros(A.n, dtype=A.dtype, device=A.device)
    out[A.pad_idx] = v
    return out


def unshard_vector(A: ShardedMatrix, v: torch.Tensor) -> torch.Tensor:
    """The padded sharded ``v`` back in real global order (on its
    device)."""
    return v[A.pad_idx]


"""Sparse matrix containers (port of the DIA, ELL, CSR and block parts
of ``amgx_tpu/core/matrix.py``).

* :class:`Matrix` — the host handle: a scipy CSR (scalar) or BSR
  (``block_dim`` b > 1) and/or the canonical row-aligned diagonal arrays,
  plus a cached device pack.
* :class:`DeviceMatrix` — the frozen device pack, in one of three
  formats:

  - ``fmt == "dia"``: ``vals`` (nd, n) with ``A[i, i+off_k] =
    vals[k, i]`` and the static offset tuple ``dia_offsets``; block-DIA
    packs hold (nd, n, b, b) planes (a view of (b, b, nd, n) component
    planes, so each component is one contiguous DIA) and an (n, b, b)
    diagonal;
  - ``fmt == "ell"``: ``cols`` (n, K) int32 and ``vals`` (n, K[, b, b]),
    padded with value 0 (host packs pad with column 0); rectangular
    allowed.  A scalar ELL pack carries ``row_len`` (n,) int32, one past
    each row's last nonzero slot (:func:`~..ops.ell_spmv.ell_row_len`,
    computed on its device at assembly), where kernel B3 stops the row.
    A square scalar ELL of at most 256 entries a row whose
    every 8192-row tile holds at most 32 distinct column differences
    carries the tile-DIA shift planes (``sh_*``,
    :mod:`..ops.shift_spmv`, kernel B2) in place of ``cols``/``vals``
    (a *lean* pack, as the JAX package uploads its coarse levels):
    :meth:`DeviceMatrix.ell_cols_view` and
    :meth:`DeviceMatrix.ell_vals_view` serve them from the planes;
  - ``fmt == "csr"``: ``cols``/``vals``/``row_ids`` flat over the stored
    (block) entries — the pack of a scalar matrix with a row wider than
    the ELL budget (2048), or of a block matrix past it.

  ELL and CSR packs of block matrices, and CSR packs of scalar ones,
  carry the binned sliced-ELL planes (``bn_*``, :mod:`..ops.binned_spmv`)
  when the plan fits the padding budget: block-native planes by default,
  the scalar expansion's with ``block_native=False`` or
  ``AMGX_BLOCK_NATIVE=0``.  Unlike the JAX package, which attaches the
  binned and shift planes only on a TPU or under its interpreter (and
  the shift planes only in f32), the port attaches them on every device
  and in f64 too: the card runs kernels B2/B4/B5 on them, the CPU their
  plain versions.
* :class:`ComposedDIA` — fmt ``dia3``: a coarse operator applied as the
  Galerkin composition R·(A·(P·x)) of three DIA packs.

A square scalar matrix with at most 48 distinct diagonals packs as DIA,
a square block matrix with at most 48 distinct block diagonals as
block-DIA.  The TPU window and dense attachments of the JAX package are
not carried over: on the card the ELL kernel gathers x directly.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..device import numpy_dtype, resolve_device, storage_dtype, torch_dtype
from ..errors import BadParametersError
from ..ops import binned_spmv, ell_spmv, shift_spmv

#: the DIA diagonal budget (``pack_device(dia_max_diags=48)`` upstream)
DIA_MAX_DIAGS = 48
#: the ELL width budget (``Matrix.device(ell_max_width=2048)`` upstream)
ELL_MAX_WIDTH = 2048
#: the largest side of an fmt ``dense`` pack (``_DENSE_MAX`` upstream)
DENSE_MAX = 3072
#: widest ELL pack the shift planes are tried on (``k <= 256`` upstream)
SHIFT_MAX_WIDTH = 256


@dataclasses.dataclass(frozen=True)
class DeviceMatrix:
    """Frozen device-side matrix (fmt ``dia``, ``ell`` or ``csr``)."""

    vals: Optional[torch.Tensor]   # dia: (nd, n[, b, b]); ell: (n, K[, b, b])
    diag: torch.Tensor             # (n,[ b, b]) main (block) diagonal
    n_rows: int
    n_cols: int
    dia_offsets: tuple = ()
    fmt: str = "dia"
    cols: Optional[torch.Tensor] = None   # ell: (n, K); csr: (nnz,) int32
    ell_width: int = 0
    block_dim: int = 1
    row_ids: Optional[torch.Tensor] = None   # csr: (nnz,) int32
    #: scalar ell: (n,) int32, one past each row's last nonzero slot
    row_len: Optional[torch.Tensor] = None
    #: binned sliced-ELL planes (ops/binned_spmv.py) and static dims
    bn_codes: Optional[torch.Tensor] = None
    bn_vals: Optional[torch.Tensor] = None
    bn_meta: Optional[torch.Tensor] = None
    bn_pos: Optional[torch.Tensor] = None
    bn_dims: tuple = ()
    #: derived once at upload for the card's kernels
    #: (:func:`~amgx_tpu_torch.ops.binned_spmv.kernel_aux`)
    bn_row_of_pos: Optional[torch.Tensor] = None
    #: kernels B4's and B5's compact pack, derived from the planes at
    #: upload (:func:`~amgx_tpu_torch.ops.binned_spmv.compact_pack`)
    bn_compact: Optional[binned_spmv.CompactPack] = None
    #: tile-DIA shift planes (ops/shift_spmv.py) and static dims
    sh_vals: Optional[torch.Tensor] = None
    sh_meta: Optional[torch.Tensor] = None
    sh_dims: tuple = ()
    #: (n_tiles, Dpad) class differences, derived once at upload for the
    #: card's kernel (:func:`~amgx_tpu_torch.ops.shift_spmv.class_diffs`)
    sh_diffs: Optional[torch.Tensor] = None
    #: kernel B2's slice-masked compact pack, derived from the planes at
    #: upload (:func:`~amgx_tpu_torch.ops.shift_spmv.shift_compact`)
    sh_compact: Optional[shift_spmv.ShiftCompact] = None

    @property
    def n(self) -> int:
        """Scalar dimension (rows × block_dim)."""
        return self.n_rows * self.block_dim

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def astype(self, dtype) -> "DeviceMatrix":
        dt = torch_dtype(dtype)
        return dataclasses.replace(
            self, vals=None if self.vals is None else self.vals.to(dt),
            diag=self.diag.to(dt),
            bn_vals=None if self.bn_vals is None else self.bn_vals.to(dt),
            bn_compact=None if self.bn_compact is None
            else self.bn_compact.astype(dt),
            sh_vals=None if self.sh_vals is None else self.sh_vals.to(dt),
            sh_compact=None if self.sh_compact is None
            else self.sh_compact.astype(dt))

    def ell_vals_view(self) -> torch.Tensor:
        """Row-major (n, K) ELL values: ``vals``, or on a shift pack the
        class planes transposed (Dpad wide: class slots act as ELL
        slots, unused slots carry zeros)."""
        if self.vals is not None:
            return self.vals
        T, n_tiles, Dpad = (int(v) for v in self.sh_dims[:3])
        v = self.sh_vals.reshape(n_tiles, Dpad, T)
        return v.transpose(1, 2).reshape(-1, Dpad)[:self.n_rows]

    def ell_cols_view(self) -> torch.Tensor:
        """Row-major (n, K) int32 ELL columns: ``cols``, or on a shift
        pack each row plus its tile's class differences, clipped
        to ``[0, n_cols)`` (the clipped slots carry zero values)."""
        if self.cols is not None:
            return self.cols
        T, n_tiles, Dpad = (int(v) for v in self.sh_dims[:3])
        rows = torch.arange(n_tiles * T, dtype=torch.int64,
                            device=self.sh_diffs.device)
        d = self.sh_diffs.long().repeat_interleave(T, dim=0)
        cols = torch.clamp(rows[:, None] + d, 0, self.n_cols - 1)
        return cols[:self.n_rows].to(torch.int32)


@dataclasses.dataclass(frozen=True)
class ComposedDIA:
    """A coarse operator applied as its Galerkin composition
    ``y = R·(A·(P·x))`` from three DIA packs (the device classical
    pipeline's level 1, ``amg/classical/device_pipeline.py``).  The
    embedded coarse matrix itself has some 200 realized offsets at low
    fill; the factors stream far fewer bytes per apply for the same
    operator.  ``diag``/``l1row`` come from the embedded form at setup,
    so the Jacobi smoothers need no host work."""

    P: DeviceMatrix
    A: DeviceMatrix
    R: DeviceMatrix
    diag: torch.Tensor
    l1row: torch.Tensor
    n_rows: int
    n_cols: int

    fmt = "dia3"

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def astype(self, dtype) -> "ComposedDIA":
        return dataclasses.replace(
            self, P=self.P.astype(dtype), A=self.A.astype(dtype),
            R=self.R.astype(dtype), diag=self.diag.to(torch_dtype(dtype)),
            l1row=self.l1row.to(torch_dtype(dtype)))


def ell_layout(indptr: np.ndarray, indices: np.ndarray):
    """Shared ELL scatter layout: ``(for_rows, pos_in_row, width)`` such
    that the padded arrays are filled by ``out[for_rows, pos_in_row] =
    data``."""
    deg = np.diff(indptr)
    k = max(int(deg.max()) if len(deg) else 1, 1)
    for_rows = np.repeat(np.arange(len(deg), dtype=np.int64), deg)
    pos = np.arange(len(indices), dtype=np.int64) - np.repeat(
        indptr[:-1].astype(np.int64), deg)
    return for_rows, pos, k


def ell_host_arrays(host: sp.spmatrix, dtype):
    """The ELL pack of a scalar CSR on the host (the ELL branch of
    ``pack_host_arrays`` upstream): ``(cols (n, K) int32, vals (n, K),
    diag (n,))``, padded with column 0 and value 0."""
    csr = sp.csr_matrix(host)
    csr.sort_indices()
    for_rows, pos, k = ell_layout(csr.indptr, csr.indices)
    n = csr.shape[0]
    cols = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=dtype)
    cols[for_rows, pos] = csr.indices
    vals[for_rows, pos] = csr.data
    diag = np.zeros(n, dtype=dtype)
    on_diag = csr.indices == for_rows
    diag[for_rows[on_diag]] = csr.data[on_diag]
    return cols, vals, diag


def ell_device_matrix(cols: torch.Tensor, vals: torch.Tensor,
                      diag: torch.Tensor, n_cols: int) -> DeviceMatrix:
    """The scalar ELL DeviceMatrix around device arrays, with its
    ``row_len``."""
    return DeviceMatrix(vals=vals, diag=diag, n_rows=int(vals.shape[0]),
                        n_cols=int(n_cols), fmt="ell", cols=cols,
                        ell_width=int(vals.shape[1]),
                        row_len=ell_spmv.ell_row_len(vals))


def dia_arrays(csr: sp.csr_matrix, max_diags: Optional[int] = None):
    """Row-aligned diagonal arrays of a CSR matrix: (offsets list, vals
    (nd, n)) with ``A[i, i+d_k] = vals[k, i]``, or None when the matrix
    has more than ``max_diags`` distinct diagonals."""
    n, m = csr.shape
    idx_t = np.int32 if (n + m - 1) < 2**31 else np.int64
    rows = np.repeat(np.arange(n, dtype=idx_t), np.diff(csr.indptr))
    shifted = csr.indices.astype(idx_t, copy=False) - rows + idx_t(n - 1)
    counts = np.bincount(shifted, minlength=n + m - 1)
    offsets = np.flatnonzero(counts)
    if max_diags is not None and len(offsets) > max_diags:
        return None
    lut = np.empty(n + m - 1, dtype=idx_t)
    lut[offsets] = np.arange(len(offsets), dtype=idx_t)
    vals = np.zeros((len(offsets), n), dtype=csr.data.dtype)
    vals[lut[shifted], rows] = csr.data
    return [int(o) - (n - 1) for o in offsets], vals


def _dia_attach_matches(csr, dia) -> bool:
    """Full check of a generator-attached DIA decomposition against the
    CSR values (the caller may have mutated ``a.data`` since)."""
    if not isinstance(csr, sp.csr_matrix) or csr.nnz == 0:
        return True
    offsets, vals = dia
    n, m = csr.shape
    if vals.shape[1] != n:
        return False
    idx_t = np.int32 if (n + m - 1) < 2**31 else np.int64
    rows = np.repeat(np.arange(n, dtype=idx_t), np.diff(csr.indptr))
    shifted = csr.indices.astype(idx_t, copy=False) - rows + idx_t(n - 1)
    lut = np.full(n + m - 1, -1, dtype=np.int64)
    offs = np.asarray(offsets, dtype=np.int64) + (n - 1)
    if np.any(offs < 0) or np.any(offs >= n + m - 1):
        return False
    lut[offs] = np.arange(len(offsets))
    k = lut[shifted]
    if np.any(k < 0):
        return False
    if not np.array_equal(vals[k, rows], csr.data):
        return False
    return int(np.count_nonzero(vals)) == int(np.count_nonzero(csr.data))


def dia_device_matrix(offsets, dvals: torch.Tensor,
                      ddiag: Optional[torch.Tensor] = None,
                      n_cols: Optional[int] = None) -> DeviceMatrix:
    """The DIA DeviceMatrix around device arrays; the main diagonal is a
    view of ``dvals`` (zeros when offset 0 is absent)."""
    offsets = tuple(int(o) for o in offsets)
    if ddiag is None:
        ddiag = dvals[offsets.index(0)] if 0 in offsets else \
            torch.zeros(dvals.shape[1], dtype=dvals.dtype,
                        device=dvals.device)
    return DeviceMatrix(vals=dvals, diag=ddiag, n_rows=int(dvals.shape[1]),
                        n_cols=int(n_cols if n_cols is not None
                                   else dvals.shape[1]),
                        dia_offsets=offsets)


def pack_kind(Ad) -> str:
    """Human-readable pack/kernel selection of a device matrix, under the
    JAX package's labels (``core/matrix.py::pack_kind`` upstream).  A
    scalar ELL pack with shift planes is ``ell/shift`` (kernel B2); any
    other scalar ELL pack is ``ell/window``: the port serves every one
    with kernel B3 (the JAX package's ``ell/window`` kernel, which it
    also labels ``ell/gather`` where its TPU window did not fit)."""
    fmt = getattr(Ad, "fmt", "?")
    binned = getattr(Ad, "bn_codes", None) is not None
    suffix = "-block" if binned and \
        binned_spmv.bn_block_dim(Ad.bn_dims) > 1 else ""
    if fmt == "dia" and getattr(Ad, "block_dim", 1) > 1:
        return "dia/block"
    if fmt == "ell":
        if getattr(Ad, "sh_vals", None) is not None:
            return "ell/shift"
        if binned:
            return "ell/binned" + suffix
        return "ell/window" if Ad.block_dim == 1 else "ell/gather"
    if fmt == "csr":
        return "csr/binned" + suffix if binned else "csr/segsum"
    return fmt


def dia_arrays_block(bsr: sp.bsr_matrix, max_diags: Optional[int] = None):
    """Block row-aligned diagonals of a square BSR matrix: (offsets list,
    vals (nd, n, b, b)) with block ``A[i, i+d_k] = vals[k, i]``, or None
    when the block pattern has more than ``max_diags`` distinct block
    diagonals."""
    b = bsr.blocksize[0]
    n, m = bsr.shape[0] // b, bsr.shape[1] // b
    if bsr.nnz == 0:
        return None
    idx_t = np.int32 if (n + m - 1) < 2**31 else np.int64
    rows = np.repeat(np.arange(n, dtype=idx_t), np.diff(bsr.indptr))
    shifted = bsr.indices.astype(idx_t, copy=False) - rows + idx_t(n - 1)
    counts = np.bincount(shifted, minlength=n + m - 1)
    offsets = np.flatnonzero(counts)
    if max_diags is not None and len(offsets) > max_diags:
        return None
    lut = np.empty(n + m - 1, dtype=idx_t)
    lut[offsets] = np.arange(len(offsets), dtype=idx_t)
    vals = np.zeros((len(offsets), n, b, b), dtype=bsr.data.dtype)
    vals[lut[shifted], rows] = bsr.data
    return [int(o) - (n - 1) for o in offsets], vals


def _block_native_on(block_native: Optional[bool] = None) -> bool:
    """The block-native layout knob: b×b systems pack block-DIA planes or
    block-native binned planes by default; ``AMGX_BLOCK_NATIVE=0`` (or an
    explicit ``block_native=False``) keeps the scalar expansion."""
    if block_native is not None:
        return bool(block_native)
    return os.environ.get("AMGX_BLOCK_NATIVE", "1") != "0"


def _bsr_from_any(a, block_dim: int):
    if block_dim == 1:
        return sp.csr_matrix(a)
    return sp.bsr_matrix(a, blocksize=(block_dim, block_dim))


def binned_planes(host, block_dim: int, dtype, native: bool):
    """The binned sliced-ELL planes ``(arrays, bn_dims)`` of a host
    matrix in ``dtype`` (:func:`~..ops.binned_spmv.csr_binned_pack`):
    the block-native planes of its b×b blocks when ``native`` and b > 1,
    else the planes of its scalar CSR (a block matrix's scalar
    expansion).  None over the padding budget.  The layout depends on the
    pattern alone, so two dtypes give the same lanes."""
    b = int(block_dim)
    if native and b > 1:
        bsr = host if isinstance(host, sp.bsr_matrix) else \
            sp.bsr_matrix(host, blocksize=(b, b))
        bsr.sort_indices()
        return binned_spmv.csr_binned_pack(
            bsr.indptr, bsr.indices, bsr.data.astype(dtype, copy=False),
            bsr.shape[1] // b, dtype, block_dim=b)
    csr = sp.csr_matrix(host)
    csr.sort_indices()
    return binned_spmv.csr_binned_pack(
        csr.indptr, csr.indices, csr.data.astype(dtype, copy=False),
        csr.shape[1], dtype)


def _try_binned(host, block_dim: int, dtype, arrays, meta,
                native: bool) -> bool:
    """Attach the binned planes (:func:`binned_planes`) when the plan
    fits the padding budget (``_try_binned`` upstream, on every device
    and in f32 or f64).  Returns True when attached."""
    if not np.issubdtype(np.dtype(dtype), np.floating):
        return False
    out = binned_planes(host, block_dim, dtype, native)
    if out is None:
        return False
    arrays.update(out[0])
    meta.update(bn_dims=out[1])
    return True


def _try_binned_block(bsr: sp.bsr_matrix, dtype, arrays, meta) -> bool:
    """Block-native binned pack (kernel B5): one column code per b×b
    block and (b², L) component planes; falls back to the
    scalar-expansion planes (kernel B4) when the block plan exceeds the
    padding budget."""
    return _try_binned(bsr, bsr.blocksize[0], dtype, arrays, meta, True) \
        or _try_binned(bsr, 1, dtype, arrays, meta, False)


def _try_shift(arrays, meta) -> None:
    """Replace a scalar ELL pack of at most ``SHIFT_MAX_WIDTH`` entries a
    row by the tile-DIA shift planes (:func:`~..ops.shift_spmv.
    shift_pack`) when the pack takes them (square, at most 32 classes a
    tile, within the plane budget) — the shift branch of
    ``pack_host_arrays`` upstream, on every device and in f32 or f64.
    The planes carry the columns and the values: the ELL ``cols`` and
    ``vals`` go (the JAX package's lean pack)."""
    vals = arrays["vals"]
    if not np.issubdtype(vals.dtype, np.floating) or \
            meta["ell_width"] > SHIFT_MAX_WIDTH:
        return
    sh = shift_spmv.shift_pack(arrays["cols"], vals, n_cols=meta["n_cols"])
    if sh is None:
        return
    arrays.update(sh_vals=sh["sh_vals"], sh_meta=sh["sh_meta"])
    meta.update(sh_dims=sh["_meta"])
    del arrays["cols"], arrays["vals"]


def dense_pack_enabled() -> bool:
    """The JAX package builds fmt ``dense`` packs only on a TPU, or with
    ``AMGX_DENSE_PACK=1`` (``amgx_tpu/core/matrix.py:1048-1056``); the
    port reads the same switch."""
    return os.environ.get("AMGX_DENSE_PACK") == "1"


def pack_host_arrays(host, block_dim: int, dtype,
                     ell_max_width: int = ELL_MAX_WIDTH,
                     dia_max_diags: int = DIA_MAX_DIAGS,
                     block_native: Optional[bool] = None):
    """The device pack computed on the host: ``(arrays, meta)`` with no
    transfer (``pack_host_arrays`` upstream, without the TPU window and
    dense attachments).

    Scalar: DIA when square with at most ``dia_max_diags`` diagonals, ELL
    up to ``ell_max_width`` entries a row (the shift planes where they
    fit, :func:`_try_shift`), else CSR with the binned planes.  Block (b > 1): block-DIA first
    (square, block-native on, at most ``dia_max_diags`` block diagonals),
    then a block ELL (or CSR) pack with the block-native binned planes,
    or the scalar expansion's with ``block_native=False`` /
    ``AMGX_BLOCK_NATIVE=0``."""
    b = int(block_dim)
    if b == 1 and host.shape[0] == host.shape[1]:
        csr = sp.csr_matrix(host)
        if csr.shape[0] and csr.nnz:
            arrs = dia_arrays(csr, max_diags=dia_max_diags)
            if arrs is not None:
                offsets, vals = arrs
                return ({"vals": vals.astype(dtype, copy=False)},
                        dict(fmt="dia", offsets=offsets,
                             n_cols=csr.shape[1]))
    if b > 1 and host.shape[0] == host.shape[1] and dia_max_diags and \
            _block_native_on(block_native):
        bsr0 = host if isinstance(host, sp.bsr_matrix) else \
            sp.bsr_matrix(host, blocksize=(b, b))
        if bsr0.shape[0] and bsr0.nnz:
            bsr0.sort_indices()
            arrs = dia_arrays_block(bsr0, max_diags=dia_max_diags)
            if arrs is not None:
                offsets, bvals = arrs
                n_b = bsr0.shape[0] // b
                diag = np.zeros((n_b, b, b), dtype=dtype)
                if 0 in offsets:
                    diag[:] = bvals[offsets.index(0)]
                return ({"vals": bvals.astype(dtype, copy=False),
                         "diag": diag},
                        dict(fmt="dia", offsets=offsets, block_dim=b,
                             n_cols=bsr0.shape[1] // b))
    if b == 1:
        csr = sp.csr_matrix(host)
        csr.sort_indices()
        indptr, indices, vals = csr.indptr, csr.indices, csr.data
        n_rows, n_cols = csr.shape
        block_shape = ()
    else:
        bsr = host if isinstance(host, sp.bsr_matrix) else sp.bsr_matrix(
            host, blocksize=(b, b))
        bsr.sort_indices()
        indptr, indices, vals = bsr.indptr, bsr.indices, bsr.data
        n_rows, n_cols = bsr.shape[0] // b, bsr.shape[1] // b
        block_shape = (b, b)
    for_rows, pos_in_row, k = ell_layout(indptr, indices)
    diag = np.zeros((n_rows,) + block_shape, dtype=dtype)
    on_diag = indices == for_rows
    diag[for_rows[on_diag]] = vals[on_diag]
    meta = dict(n_rows=n_rows, n_cols=n_cols, block_dim=b)
    if k <= ell_max_width:
        cols = np.zeros((n_rows, k), dtype=np.int32)
        ell_vals = np.zeros((n_rows, k) + block_shape, dtype=dtype)
        cols[for_rows, pos_in_row] = indices
        ell_vals[for_rows, pos_in_row] = vals
        arrays = {"cols": cols, "vals": ell_vals, "diag": diag}
        meta.update(fmt="ell", ell_width=k)
    else:
        arrays = {"cols": indices.astype(np.int32),
                  "vals": vals.astype(dtype), "diag": diag,
                  "row_ids": for_rows.astype(np.int32)}
        meta.update(fmt="csr", ell_width=0)
    if b == 1:
        if meta["fmt"] == "ell":
            _try_shift(arrays, meta)
        if n_rows <= DENSE_MAX and n_cols <= DENSE_MAX and \
                "sh_vals" not in arrays and dense_pack_enabled():
            # a small scattered operator that no structured kernel
            # carries: one dense matrix, applied as a dense product
            # (``pack_host_arrays:1186-1215`` upstream)
            dense = np.zeros((n_rows, n_cols), dtype=dtype)
            dense[for_rows, indices] = vals
            return ({"vals": dense, "diag": diag},
                    dict(meta, fmt="dense", ell_width=0))
        if meta["fmt"] == "csr":
            # the scalar ELL pack is kernel B2's (shift planes) or B3's;
            # only a row past the ELL budget takes the binned planes
            # (kernel B4)
            _try_binned(csr, 1, dtype, arrays, meta, False)
    elif _block_native_on(block_native):
        _try_binned_block(bsr, dtype, arrays, meta)
    else:
        # the scalar expansion's planes (kernel B4)
        _try_binned(bsr, b, dtype, arrays, meta, False)
    return arrays, meta


def assemble_device_matrix(arrays, meta, device) -> DeviceMatrix:
    """Upload host ``(arrays, meta)`` (:func:`pack_host_arrays`) onto
    ``device`` as a :class:`DeviceMatrix`; the binned and shift kernels'
    auxiliary arrays are derived there.  The upload's bytes and seconds
    go to the setup profile's innermost phase (``setup_profile.transfer``,
    one attribute check when it is off)."""
    from ..telemetry import setup_profile
    nb = sum(int(a.nbytes) for a in arrays.values()
             if isinstance(a, np.ndarray))
    with setup_profile.transfer(nb, len(arrays), "upload"):
        return _assemble(arrays, meta, device)


def _assemble(arrays, meta, device) -> DeviceMatrix:
    dev = resolve_device(device)

    def up(key):
        a = arrays.get(key)
        return None if a is None else \
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if meta["fmt"] == "dia":
        b = int(meta.get("block_dim", 1))
        if b > 1:
            # (nd, n, b, b) as a view of contiguous (b, b, nd, n)
            # component planes: each component is one contiguous DIA
            planes = torch.from_numpy(np.ascontiguousarray(
                np.transpose(arrays["vals"], (2, 3, 0, 1)))).to(dev)
            dvals = planes.permute(2, 3, 0, 1)
            return DeviceMatrix(
                vals=dvals, diag=up("diag"), n_rows=int(dvals.shape[1]),
                n_cols=int(meta["n_cols"]),
                dia_offsets=tuple(int(o) for o in meta["offsets"]),
                fmt="dia", ell_width=len(meta["offsets"]), block_dim=b)
        return dia_device_matrix(meta["offsets"], up("vals"), None,
                                 meta["n_cols"])
    extra = {}
    if "bn_dims" in meta:
        bn_meta, bn_pos = up("bn_meta"), up("bn_pos")
        dims = tuple(meta["bn_dims"])
        extra = dict(bn_codes=up("bn_codes"), bn_vals=up("bn_vals"),
                     bn_meta=bn_meta, bn_pos=bn_pos, bn_dims=dims,
                     bn_row_of_pos=binned_spmv.kernel_aux(bn_pos, dims))
        extra.update(bn_compact=binned_spmv.compact_pack(
            extra["bn_codes"], extra["bn_vals"], bn_meta, dims))
    if "sh_dims" in meta:
        sh_meta = up("sh_meta")
        dims = tuple(int(v) for v in meta["sh_dims"])
        sh_vals = up("sh_vals")
        extra.update(sh_vals=sh_vals, sh_meta=sh_meta, sh_dims=dims,
                     sh_diffs=shift_spmv.class_diffs(sh_meta, dims),
                     sh_compact=shift_spmv.shift_compact(sh_vals, dims))
    vals = up("vals")
    if meta["fmt"] == "ell" and int(meta["block_dim"]) == 1 and \
            vals is not None:
        extra.update(row_len=ell_spmv.ell_row_len(vals))
    return DeviceMatrix(
        vals=vals, diag=up("diag"), n_rows=int(meta["n_rows"]),
        n_cols=int(meta["n_cols"]), fmt=meta["fmt"], cols=up("cols"),
        ell_width=int(meta["ell_width"]),
        block_dim=int(meta["block_dim"]), row_ids=up("row_ids"), **extra)


def pack_device(host, block_dim: int, dtype,
                ell_max_width: int = ELL_MAX_WIDTH,
                dia_max_diags: int = DIA_MAX_DIAGS, device="cuda",
                block_native: Optional[bool] = None) -> DeviceMatrix:
    """Host pack (:func:`pack_host_arrays`) + upload onto ``device``."""
    arrays, meta = pack_host_arrays(host, block_dim, dtype, ell_max_width,
                                    dia_max_diags,
                                    block_native=block_native)
    return assemble_device_matrix(arrays, meta, device)


#: process-unique identity tokens of matrices with no host bytes to
#: fingerprint (never reused, unlike ``id()``)
_FP_TOKENS = itertools.count(1)


def csr_structure_fingerprint(M) -> str:
    """Stable hex digest of a scipy CSR/BSR sparsity structure (shape,
    indptr and indices, never values) — the pattern key of the device
    setup engine's plan cache (``amg/device_setup/``): equal
    fingerprints, one symbolic plan."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(tuple(M.shape)).encode())
    h.update(np.ascontiguousarray(M.indptr).tobytes())
    h.update(np.ascontiguousarray(M.indices).tobytes())
    return h.hexdigest()


class Matrix:
    """Host-side matrix handle wrapping a scipy CSR (or, for
    ``block_dim`` b > 1, BSR) and/or DIA arrays plus a cached device pack
    on ``device`` (default ``"cuda"``; raises when no card is present and
    ``device="cpu"`` was not asked for)."""

    def __init__(self, a=None, block_dim: int = 1, dtype=np.float64,
                 device="cuda"):
        self.placement = resolve_device(device)
        self.dtype = np.dtype(dtype)
        self.block_dim = 1
        self._host: Optional[sp.spmatrix] = None
        self._device: Optional[DeviceMatrix] = None
        self._device_dtype = None
        self.device_dtype = None
        #: cached (offsets, vals) diagonal decomposition
        self._dia = None
        self._dia_checked_max = 0
        #: lazy producer of analytic host diagonals (device generators)
        self._dia_thunk = None
        #: (dtype, dinv) derived on the device with the hierarchy
        self._dinv_dev = None
        self.grid_dims = None
        #: per-row coordinates, a tuple of 2 or 3 arrays (the target of
        #: ``AMGX_matrix_attach_geometry``): the GEO selector aggregates
        #: by them, and coarse levels carry the aggregate centroids
        self.geometry = None
        #: the distribution (mesh, axis, offsets, n_loc), or None
        self.dist = None
        #: per-rank row blocks (global column ids) of a matrix uploaded
        #: block by block (:meth:`set_distributed_blocks`), and their
        #: row offsets
        self.blocks = None
        self.block_offsets = None
        #: the serving keys (:meth:`pattern_fingerprint`,
        #: :meth:`values_fingerprint`), computed once
        self._pattern_fp = None
        self._values_fp = None
        if a is not None:
            self.set(a, block_dim=block_dim)

    @property
    def device_dtype(self):
        return self._device_dtype_pref

    @device_dtype.setter
    def device_dtype(self, v):
        # torch.bfloat16 for a bf16 pack (numpy has no such type), else a
        # numpy dtype
        self._device_dtype_pref = storage_dtype(v)

    def set_distribution(self, mesh, axis: str = "p", offsets=None,
                         n_loc=None):
        """Declare this matrix row-distributed over ``mesh`` (a
        :class:`~..distributed.matrix.DeviceMesh`; the
        ``AMGX_matrix_upload_distributed`` analog): the partition comes
        from explicit row ``offsets`` or an equal split, ``n_loc`` pads
        every shard to at least that many rows.  The pack then lives on
        the mesh's device."""
        from ..distributed.matrix import check_mesh
        mesh = check_mesh(mesh, axis)
        self.dist = (mesh, axis, None if offsets is None
                     else np.asarray(offsets), n_loc)
        self.placement = mesh.device
        self._device = None
        self._device_dtype = None
        return self

    def set_distributed_blocks(self, blocks, offsets, mesh,
                               axis: str = "p", block_dim: int = 1):
        """Upload per-rank row blocks (global column ids): the global
        matrix is never assembled, and the setup (the partition maps, the
        per-rank coarsening and Galerkin products) reads the blocks
        (``distributed_arranger.h:85-231``).  With ``block_dim`` b > 1
        the blocks are b×b (BSR) row blocks and ``offsets`` count block
        rows."""
        bd = int(block_dim)
        blocks = [sp.csr_matrix(b) if bd == 1 else _bsr_from_any(b, bd)
                  for b in blocks]
        offsets = np.asarray(offsets)
        if len(blocks) != len(offsets) - 1:
            raise BadParametersError("one row block per partition required")
        for p, b in enumerate(blocks):
            if b.shape[0] != (offsets[p + 1] - offsets[p]) * bd:
                raise BadParametersError(
                    f"block {p} has {b.shape[0]} rows, offsets say "
                    f"{(offsets[p + 1] - offsets[p]) * bd}")
        self.block_dim = bd
        self.dtype = np.dtype(blocks[0].dtype)
        self._host = None
        self._dia = None
        self._dia_checked_max = 0
        self._dinv_dev = None
        self._drop_generator_state()
        self.blocks = blocks
        self.block_offsets = offsets
        self._pattern_fp = None
        self._values_fp = None
        self.set_distribution(mesh, axis, offsets)
        return self

    def assemble_global(self) -> sp.csr_matrix:
        """The global matrix of a block-distributed upload (small
        consolidated grids and test oracles only; the setup never calls
        it on a fine level)."""
        if self._host is not None:
            return sp.csr_matrix(self._host)
        return sp.csr_matrix(sp.vstack([sp.csr_matrix(b)
                                        for b in self.blocks]))

    def set(self, a, block_dim: int = 1):
        """Upload a scipy/dense matrix: a CSR for ``block_dim`` 1, else a
        BSR of b×b blocks (the scalar size must divide by b)."""
        b = int(block_dim)
        if b < 1 or any(d % b for d in np.shape(a)):
            raise BadParametersError(
                f"block_dim {b} does not divide the shape {np.shape(a)}")
        self.block_dim = b
        self.blocks = None
        self.block_offsets = None
        self._host = _bsr_from_any(a, b)
        self._host.sort_indices()
        self.dtype = np.dtype(self._host.dtype)
        self._device = None
        self._dia = None
        self._dia_checked_max = 0
        self._dinv_dev = None
        self._pattern_fp = None      # new structure, new fingerprints
        self._values_fp = None
        self._drop_generator_state()
        dia = getattr(a, "_amgx_dia", None)
        if dia is not None and b == 1 and \
                _dia_attach_matches(self._host, dia):
            self._dia = dia
            self._dia_checked_max = 10**9
        gd = getattr(a, "_amgx_grid_dims", None)
        if gd is not None:
            self.grid_dims = tuple(gd)
        return self

    @classmethod
    def from_dia(cls, offsets, vals: np.ndarray, n_cols: Optional[int]
                 = None, dtype=None, device="cuda") -> "Matrix":
        """Build from host row-aligned DIA arrays (scipy view lazy)."""
        m = cls(device=device)
        m.dtype = np.dtype(dtype or vals.dtype)
        m._dia = ([int(o) for o in offsets], vals)
        m._dia_checked_max = 10**9
        m._n_dia = (vals.shape[1], int(n_cols or vals.shape[1]))
        return m

    @classmethod
    def from_dia_device(cls, offsets, dvals: torch.Tensor, ddiag=None,
                        dinv=None, n_cols: Optional[int] = None) -> "Matrix":
        """Build around device-resident DIA arrays (the hierarchy's
        coarse levels); the host view downloads lazily."""
        m = cls(device=dvals.device)
        dt = numpy_dtype(dvals.dtype)
        m.dtype = dt
        m.device_dtype = dt
        m._device = dia_device_matrix(offsets, dvals, ddiag, n_cols)
        m._device_dtype = dt
        m._n_dia = (int(dvals.shape[1]), int(n_cols or dvals.shape[1]))
        if dinv is not None:
            m._dinv_dev = (dvals.dtype, dinv)
        return m

    @classmethod
    def from_device_pack(cls, dm, nnz_hint: Optional[int] = None,
                         logical_rows: Optional[int] = None) -> "Matrix":
        """Wrap an already-built device pack (a device-born coarse level
        of the classical pipeline): no host data, no transfer.
        ``nnz_hint``/``logical_rows`` serve the level sizes without a
        download; pad rows of a device-born level are not logical
        rows."""
        m = cls(device=dm.device)
        dt = numpy_dtype(dm.dtype)
        m.dtype = dt
        m.device_dtype = dt
        m._device = dm
        m._device_dtype = dt
        m._n_dia = (int(dm.n_rows), int(dm.n_cols))
        if nnz_hint is not None:
            m._nnz_hint = int(nnz_hint)
        if logical_rows is not None:
            m.logical_rows = int(logical_rows)
        return m

    @classmethod
    def from_csr(cls, indptr, indices, data, n_cols=None, block_dim=1,
                 device="cuda") -> "Matrix":
        """AMGX-style upload of block-CSR arrays
        (``AMGX_matrix_upload_all``): ``data`` is (nnz,), (nnz, b*b) or
        (nnz, b, b).  The arrays are copied (the caller keeps its own,
        ``amgx_c.h:288-296``)."""
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        data = np.asarray(data)
        n_rows = len(indptr) - 1
        b = int(block_dim)
        if n_cols is None:
            n_cols = n_rows
        m = cls(device=device)
        m.block_dim = b
        m.dtype = np.dtype(data.dtype)
        if b == 1:
            m._host = sp.csr_matrix(
                (data.ravel().copy(), indices.copy(), indptr.copy()),
                shape=(n_rows, n_cols))
        else:
            blocks = data.reshape(-1, b, b).copy()
            m._host = sp.bsr_matrix((blocks, indices.copy(), indptr.copy()),
                                    shape=(n_rows * b, n_cols * b))
        m._host.sort_indices()
        return m

    # -------------------------------------------------------- fingerprints
    def pattern_fingerprint(self) -> str:
        """Stable hex digest of the sparsity structure — shape, block
        dim, device pack dtype, indptr/indices (never values); the
        setup-cache key of the serving layer (``serve/session.py``), and
        the JAX package's digest of the same matrix
        (``amgx_tpu/core/matrix.py:721``).  ``replace_coefficients``
        keeps it; ``set`` resets it.  A matrix with no host-side
        structure (a device-born pack) fingerprints by a process-unique
        token: never falsely shared, at worst set up again."""
        fp = self._pattern_fp
        if fp is not None:
            return fp
        import hashlib
        h = hashlib.blake2b(digest_size=16)
        # the pack dtype is part of the identity (a bf16 and an f32 pack
        # cannot share a hierarchy); spelt as numpy spells it
        dd = self.device_dtype
        name = "" if dd is None else (
            "bfloat16" if dd == torch.bfloat16 else np.dtype(dd).name)
        shape = (int(self.block_offsets[-1]), self.blocks[0].shape[1]) \
            if self._host is None and self.blocks is not None \
            else tuple(self.shape)
        h.update(repr((tuple(shape), self.block_dim, name)).encode())
        if self._host is not None:
            h.update(b"csr")
            # the device setup engine's plan key too
            h.update(csr_structure_fingerprint(self._host).encode())
        elif self.blocks is not None:
            h.update(b"blocks")
            for blk in self.blocks:
                h.update(np.ascontiguousarray(blk.indptr).tobytes())
                h.update(np.ascontiguousarray(blk.indices).tobytes())
        elif self._dia is not None or self._dia_thunk is not None or \
                (self._device is not None and self._device.fmt == "dia"
                 and self._device.block_dim == 1):
            offs, _ = self.dia_cache()
            h.update(b"dia")
            h.update(repr(tuple(int(o) for o in offs)).encode())
        else:
            h.update(b"obj")
            h.update(str(self._fp_token()).encode())
        fp = h.hexdigest()
        self._pattern_fp = fp
        return fp

    def _fp_token(self) -> int:
        tok = getattr(self, "_fp_token_v", None)
        if tok is None:
            tok = self._fp_token_v = next(_FP_TOKENS)
        return tok

    def values_fingerprint(self) -> str:
        """Digest of the stored values (structure excluded): with
        :meth:`pattern_fingerprint` it decides between reusing a prepared
        solver (equal), a values-only ``resetup`` (pattern equal) and a
        full setup.  Cached; ``set`` and ``replace_coefficients``
        invalidate it.  Device-only values fingerprint by a token (a new
        handle counts as new values: an extra resetup, never a stale
        hierarchy)."""
        fp = self._values_fp
        if fp is not None:
            return fp
        import hashlib
        h = hashlib.blake2b(digest_size=16)
        if self._host is not None:
            h.update(np.ascontiguousarray(self._host.data).tobytes())
        elif self.blocks is not None:
            for blk in self.blocks:
                h.update(np.ascontiguousarray(blk.data).tobytes())
        elif self._dia is not None:
            h.update(np.ascontiguousarray(self._dia[1]).tobytes())
        else:
            h.update(str(self._fp_token()).encode())
        fp = h.hexdigest()
        self._values_fp = fp
        return fp

    def replace_coefficients(self, data) -> "Matrix":
        """Keep the structure, replace the values
        (``AMGX_matrix_replace_coefficients``, ``amgx_c.h:304-309``):
        ``data`` in the host matrix's entry order (flat, or (nnzb, b, b)
        for b×b blocks).  The host matrix is rebuilt around a fresh
        array: ``Matrix(a)`` shares scipy's buffers with the caller's
        matrix, which an in-place write would change (the upload
        contract is copy semantics).  The device pack, the diagonal
        decomposition and the inverted diagonal go with the old
        values."""
        data = np.asarray(data)
        b = self.block_dim
        host = self.host
        new_data = (data.ravel() if b == 1 else
                    data.reshape(-1, b, b)).astype(host.data.dtype)
        self._host = type(host)((new_data, host.indices, host.indptr),
                                shape=host.shape)
        self._device = None
        self._dia = None
        self._dia_checked_max = 0
        self._dinv_dev = None
        self._values_fp = None       # new values; the pattern stays
        self._drop_generator_state()
        return self

    def _drop_generator_state(self):
        """New values void what a device generator declared
        analytically: the lazy host diagonals (they would serve the old
        operator), the offsets hint and the consistency and
        f32-exactness claims; and a refreshed level's device CSR
        values."""
        self._dia_thunk = None
        for attr in ("_dia_offsets_hint", "_stencil_consistent",
                     "_vals_f32_exact", "_csr_pattern", "_csr_vals_dev"):
            self.__dict__.pop(attr, None)

    def _download_dia(self):
        d = self._device
        self._dia = (list(d.dia_offsets), d.vals.cpu().numpy())
        self._dia_checked_max = 10**9
        return self._dia

    def dia_cache(self, max_diags: Optional[int] = None):
        """The (offsets, vals) diagonal decomposition, computed at most
        once; None when it has more than ``max_diags`` diagonals."""
        if self._dia is None and self._dia_thunk is not None:
            self._dia = self._dia_thunk()
            self._dia_thunk = None
            self._dia_checked_max = 10**9
        if self._dia is None and self._host is None and \
                self._device is not None and self._device.fmt == "dia":
            self._download_dia()
        if self._dia is not None:
            offs, _ = self._dia
            if max_diags is not None and len(offs) > max_diags:
                return None
            return self._dia
        if self._host is None or \
                self._host.shape[0] != self._host.shape[1]:
            return None
        budget = max_diags if max_diags is not None else 10**9
        if budget <= self._dia_checked_max:
            return None
        arrs = dia_arrays(self._host, max_diags=budget)
        if arrs is None:
            self._dia_checked_max = max(self._dia_checked_max, budget)
            return None
        self._dia = arrs
        self._dia_checked_max = 10**9
        return arrs

    def host_diag(self) -> np.ndarray:
        """Main diagonal from host data."""
        arrs = self.dia_cache()
        if arrs is not None:
            offs, vals = arrs
            if 0 in offs:
                return vals[offs.index(0)]
            return np.zeros(vals.shape[1], dtype=vals.dtype)
        return self.scalar_csr().diagonal()

    @property
    def host(self) -> sp.spmatrix:
        """The host matrix: scipy CSR, or BSR for a block matrix (none
        for a block-distributed upload, :meth:`scalar_csr`)."""
        if self._host is None and self.blocks is not None:
            return self.scalar_csr()
        if self._host is None and \
                getattr(self, "_csr_pattern", None) is not None:
            # a level refreshed on the device: its CSR values download
            # into the recorded pattern
            from ..device import to_host
            indptr, indices, shape = self._csr_pattern
            self._host = sp.csr_matrix(
                (to_host(self._csr_vals_dev), indices, indptr), shape=shape)
        if self._host is None:
            from ..amg.pairwise import dia_to_scipy
            offs, vals = self.dia_cache()
            n, m = self._n_dia
            self._host = dia_to_scipy(offs, vals, n, n_cols=m)
        return self._host

    def scalar_csr(self) -> sp.csr_matrix:
        """The matrix as a scalar CSR; raises for a block-distributed
        upload, whose setup reads ``blocks`` per rank
        (:meth:`assemble_global` serves small grids)."""
        if self._host is None and self.blocks is not None:
            raise BadParametersError(
                "global view of a block-distributed matrix requested — "
                "setup algorithms must use .blocks (scalable contract); "
                "assemble_global() exists for small consolidated grids")
        return sp.csr_matrix(self.host)

    @property
    def n_block_rows(self) -> int:
        if self._host is None and self.blocks is not None:
            return int(self.block_offsets[-1])
        if self._host is None and hasattr(self, "_n_dia"):
            return self._n_dia[0]
        if self._host is None and self._dia is not None:
            return self._dia[1].shape[1]
        return self._host.shape[0] // self.block_dim

    @property
    def n_block_cols(self) -> int:
        if self._host is None and self.blocks is not None:
            return int(self.blocks[0].shape[1]) // self.block_dim
        if self._host is None and hasattr(self, "_n_dia"):
            return self._n_dia[1]
        if self._host is None and self._dia is not None:
            return self._dia[1].shape[1]
        return self._host.shape[1] // self.block_dim

    @property
    def shape(self):
        """The scalar shape (rows × block_dim, cols × block_dim)."""
        if self._host is not None:
            return self._host.shape
        return (self.n_block_rows * self.block_dim,
                self.n_block_cols * self.block_dim)

    def rank_blocks(self):
        """Per-rank row blocks of a distributed matrix: the uploaded
        blocks, or the host matrix split at the distribution's offsets
        (b×b BSR row blocks for a block matrix)."""
        if self._host is None and self.blocks is not None:
            return self.blocks
        offsets = np.asarray(self.device().offsets)
        if self.block_dim > 1:
            from ..distributed.matrix import split_bsr_rows
            return split_bsr_rows(_bsr_from_any(self.host, self.block_dim),
                                  offsets)
        from ..distributed.partition import split_row_blocks
        return split_row_blocks(self.scalar_csr(), offsets)

    @property
    def nnz(self) -> int:
        if self._host is None and getattr(self, "_nnz_hint", None) \
                is not None:
            return self._nnz_hint
        if self._host is None and self.blocks is not None:
            return int(sum(b.nnz for b in self.blocks))
        if self._host is None:
            arrs = self.dia_cache()
            return int(np.count_nonzero(arrs[1]))
        return self._host.nnz       # a BSR counts scalars: blocks × b²

    def device(self, dtype=None,
               ell_max_width: int = ELL_MAX_WIDTH) -> DeviceMatrix:
        """The device pack in ``dtype`` (default: ``device_dtype``, else
        the host dtype), built once and cached.  A bf16 pack is the f32
        pack cast on the device (where its kind may narrow,
        :func:`~.precision.device_cast`; else it stays f32), so its
        values hold bf16(f32(v)), as ``_pack_cast_via`` records.
        ``ell_max_width`` bounds the row width of a scalar ELL pack
        (wider matrices pack as CSR)."""
        dtype = storage_dtype(dtype or self.device_dtype or self.dtype)
        if self._device is not None and self._device_dtype == dtype:
            return self._device
        if self.dist is not None:
            self._device = self._build_sharded(dtype)
            self._device_dtype = dtype
            return self._device
        if dtype == torch.bfloat16:
            from .precision import device_cast
            wide = self._build_pack(np.dtype(np.float32), ell_max_width)
            self._device = device_cast(wide, dtype)
            self._device_dtype = dtype
            self._pack_cast_via = np.dtype(np.float32)
            if self._device is not wide:
                # the smoother's setup reads the wide values, then drops
                # them (precision.release_setup_wide)
                self._setup_wide = wide
            return self._device
        self._device = self._build_pack(dtype, ell_max_width)
        self._device_dtype = dtype
        return self._device

    def _build_sharded(self, dtype):
        """The sharded pack of a distributed matrix (the ``self.dist``
        branch of ``Matrix.device`` upstream): from the uploaded row
        blocks, else from the host matrix split at the distribution's
        offsets; a b×b matrix packs its blocks
        (:func:`~..distributed.matrix.shard_block_matrix`).  A complex
        matrix packs complex; a bf16 pack is the f32 pack cast on the
        device (bf16(f32(v)), as a single-device bf16 pack)."""
        from ..distributed.matrix import (shard_block_matrix,
                                          shard_block_matrix_from_blocks,
                                          shard_matrix,
                                          shard_matrix_from_blocks)
        if dtype == torch.bfloat16:
            self._pack_cast_via = np.dtype(np.float32)
            return self._build_sharded(np.dtype(np.float32)).astype(dtype)
        mesh, axis, offsets, n_loc = self.dist
        b = self.block_dim
        if self._host is None and self.blocks is not None:
            if b > 1:
                return shard_block_matrix_from_blocks(
                    self.blocks, self.block_offsets, mesh, axis=axis,
                    dtype=dtype, n_loc=n_loc)
            return shard_matrix_from_blocks(
                self.blocks, self.block_offsets, mesh, axis=axis,
                dtype=dtype, n_loc=n_loc)
        if b > 1:
            return shard_block_matrix(self.host, b, mesh, axis=axis,
                                      dtype=dtype, offsets=offsets,
                                      n_loc=n_loc)
        return shard_matrix(self.scalar_csr(), mesh, axis=axis,
                            dtype=dtype, offsets=offsets, n_loc=n_loc)

    def _build_pack(self, dtype: np.dtype,
                    ell_max_width: int = ELL_MAX_WIDTH) -> DeviceMatrix:
        """A fresh device pack of the host values in ``dtype``."""
        dia = self.dia_cache(DIA_MAX_DIAGS) if self.block_dim == 1 \
            else None
        if dia is not None and (len(dia[0]) == 0 or
                                self.n_block_rows != self.n_block_cols):
            dia = None          # empty or rectangular: ELL/CSR pack
        if dia is not None:
            offs, vals = dia
            dvals = torch.from_numpy(
                np.ascontiguousarray(vals.astype(dtype, copy=False))
            ).to(self.placement)
            return dia_device_matrix(offs, dvals, None, self.n_block_cols)
        # the scalar cache above already proved the matrix non-DIA;
        # block matrices try block-DIA in the pack
        arrays, meta = pack_host_arrays(
            self.host, self.block_dim, dtype, ell_max_width,
            dia_max_diags=0 if self.block_dim == 1 else DIA_MAX_DIAGS)
        return assemble_device_matrix(arrays, meta, self.placement)

"""Sparse matrix containers (port of the DIA half of
``amgx_tpu/core/matrix.py``).

* :class:`Matrix` — the host handle: a scipy CSR and/or the canonical
  row-aligned diagonal arrays, plus a cached device pack.
* :class:`DeviceMatrix` — the frozen device pack.  This slice carries
  ``fmt == "dia"`` only: ``vals`` (nd, n) with ``A[i, i+off_k] =
  vals[k, i]`` and the static offset tuple ``dia_offsets``.  A matrix
  with more than 48 distinct diagonals (the ELL/CSR packs) raises
  :class:`~amgx_tpu_torch.errors.NotImplementedError_`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..device import numpy_dtype, resolve_device, torch_dtype
from ..errors import NotImplementedError_

#: the DIA diagonal budget (``pack_device(dia_max_diags=48)`` upstream)
DIA_MAX_DIAGS = 48


@dataclasses.dataclass(frozen=True)
class DeviceMatrix:
    """Frozen device-side DIA matrix."""

    vals: torch.Tensor       # (nd, n) row-aligned diagonals
    diag: torch.Tensor       # (n,) main diagonal
    n_rows: int
    n_cols: int
    dia_offsets: tuple
    fmt: str = "dia"

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def astype(self, dtype) -> "DeviceMatrix":
        dt = torch_dtype(dtype)
        return dataclasses.replace(self, vals=self.vals.to(dt),
                                   diag=self.diag.to(dt))


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


class Matrix:
    """Host-side matrix handle wrapping a scipy CSR and/or DIA arrays plus
    a cached device pack on ``device`` (default ``"cuda"``; raises when
    no card is present and ``device="cpu"`` was not asked for)."""

    def __init__(self, a=None, block_dim: int = 1, dtype=np.float64,
                 device="cuda"):
        self.placement = resolve_device(device)
        self.dtype = np.dtype(dtype)
        self._host: Optional[sp.csr_matrix] = None
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
        if a is not None:
            self.set(a, block_dim=block_dim)

    @property
    def device_dtype(self):
        return self._device_dtype_pref

    @device_dtype.setter
    def device_dtype(self, v):
        self._device_dtype_pref = None if v is None else numpy_dtype(v)

    def set(self, a, block_dim: int = 1):
        if int(block_dim) != 1:
            raise NotImplementedError_(
                "block matrices are a later slice of the port")
        self._host = sp.csr_matrix(a)
        self._host.sort_indices()
        self.dtype = np.dtype(self._host.dtype)
        self._device = None
        self._dia = None
        self._dia_checked_max = 0
        self._dinv_dev = None
        self._dia_thunk = None
        for attr in ("_dia_offsets_hint", "_stencil_consistent",
                     "_vals_f32_exact"):
            self.__dict__.pop(attr, None)
        dia = getattr(a, "_amgx_dia", None)
        if dia is not None and _dia_attach_matches(self._host, dia):
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
                self._device is not None:
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
    def host(self) -> sp.csr_matrix:
        if self._host is None:
            from ..amg.pairwise import dia_to_scipy
            offs, vals = self.dia_cache()
            n, m = self._n_dia
            self._host = dia_to_scipy(offs, vals, n, n_cols=m)
        return self._host

    def scalar_csr(self) -> sp.csr_matrix:
        return sp.csr_matrix(self.host)

    @property
    def n_block_rows(self) -> int:
        if self._host is None and hasattr(self, "_n_dia"):
            return self._n_dia[0]
        if self._host is None and self._dia is not None:
            return self._dia[1].shape[1]
        return self._host.shape[0]

    @property
    def n_block_cols(self) -> int:
        if self._host is None and hasattr(self, "_n_dia"):
            return self._n_dia[1]
        if self._host is None and self._dia is not None:
            return self._dia[1].shape[1]
        return self._host.shape[1]

    @property
    def shape(self):
        return (self.n_block_rows, self.n_block_cols)

    @property
    def nnz(self) -> int:
        if self._host is None:
            arrs = self.dia_cache()
            return int(np.count_nonzero(arrs[1]))
        return self._host.nnz

    def device(self, dtype=None) -> DeviceMatrix:
        """The device pack in ``dtype`` (default: ``device_dtype``, else
        the host dtype), built once and cached."""
        dtype = np.dtype(dtype or self.device_dtype or self.dtype)
        if self._device is not None and self._device_dtype == dtype:
            return self._device
        dia = self.dia_cache(DIA_MAX_DIAGS)
        if dia is None or len(dia[0]) == 0 or \
                self.n_block_rows != self.n_block_cols:
            raise NotImplementedError_(
                "only square DIA operators with at most "
                f"{DIA_MAX_DIAGS} diagonals are ported; ELL/CSR packs are "
                "a later slice")
        offs, vals = dia
        dvals = torch.from_numpy(
            np.ascontiguousarray(vals.astype(dtype, copy=False))
        ).to(self.placement)
        self._device = dia_device_matrix(offs, dvals, None,
                                         self.n_block_cols)
        self._device_dtype = dtype
        return self._device

"""Sparse matrix–vector products (port of the DIA, ``dia3``, ELL, CSR and
block dispatch of ``amgx_tpu/ops/spmv.py``; reference dispatch
``multiply.cu:75-196``).

``DISPATCH`` counts which path served each apply, under the JAX
package's labels:

* ``dia/kernel`` — the hand-written DIA kernel B1 (every scalar DIA
  apply on a CUDA tensor), ``dia/slices`` its plain shifted-slices
  version (CPU tensors only);
* ``dia/block-kernel`` — a block-DIA apply as b² component dispatches of
  B1 (CUDA tensors), ``dia/block-slices`` its plain version (CPU);
* ``ell/shift`` — a scalar ELL pack with tile-DIA shift planes: the
  hand-written kernel B2 on a CUDA tensor, its plain version on a CPU
  tensor;
* ``ell/window`` — the hand-written ELL kernel B3 (every other scalar
  ELL apply on a CUDA tensor), ``ell/gather`` its plain gather version
  (CPU tensors only);
* ``ell/binned``, ``ell/binned-block``, ``csr/binned``,
  ``csr/binned-block`` — the binned kernels B4 (scalar and
  scalar-expansion planes) and B5 (block-native planes) on a CUDA tensor,
  their plain version on a CPU tensor;
* the JAX package's declines, for a block ELL or a CSR pack without
  binned planes (over the padding budget): ``ell/block-gather``,
  ``csr/segsum``, ``csr/segsum-lean`` and ``csr/block-segsum``.  They
  are plain PyTorch on any device, as upstream they are plain XLA.

A ``dia3`` apply is its three DIA applies, each counted.
"""
from __future__ import annotations

import torch

from .binned_spmv import (binned_abs_rowsum, binned_entries_view,
                          binned_spmv, binned_supported, bn_block_dim)
from .dia_spmv import dia_spmv
from .ell_spmv import ell_spmv
from .shift_spmv import shift_spmv, shift_supported

DISPATCH = {k: 0 for k in (
    "dia/kernel", "dia/slices", "dia/block-kernel", "dia/block-slices",
    "ell/shift", "ell/window", "ell/gather", "ell/binned", "ell/binned-block",
    "csr/binned", "csr/binned-block", "ell/block-gather", "csr/segsum",
    "csr/segsum-lean", "csr/block-segsum")}
#: the labels of the JAX package's declines (plain paths a kernel pack
#: falls to when its planes are missing)
DECLINES = ("ell/block-gather", "csr/segsum", "csr/segsum-lean",
            "csr/block-segsum")


def reset_dispatch() -> None:
    for k in DISPATCH:
        DISPATCH[k] = 0


def _acc(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f32 for a sub-f32 storage dtype."""
    return torch.float32 if dt in (torch.bfloat16, torch.float16) else dt


def _out_dtype(A, x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(A.dtype, x.dtype)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a :class:`~amgx_tpu_torch.core.DeviceMatrix` or a
    :class:`~amgx_tpu_torch.core.ComposedDIA`; ``x`` is the flat
    (n_cols·b,) vector and the result has dtype ``promote(A.dtype,
    x.dtype)``."""
    if A.fmt == "dia3":
        # Galerkin composition R·(A·(P·x)) — three DIA streams instead of
        # one low-fill embedded matrix
        return spmv(A.R, spmv(A.A, spmv(A.P, x)))
    if A.fmt == "dia":
        if A.block_dim > 1:
            return _bdia_spmv(A, x)
        DISPATCH["dia/kernel" if x.is_cuda else "dia/slices"] += 1
        return dia_spmv(A.vals, x, A.dia_offsets)
    b = A.block_dim
    if A.fmt == "ell" and shift_supported(A):
        DISPATCH["ell/shift"] += 1
        return shift_spmv(A, x)
    if binned_supported(A):
        native = bn_block_dim(A.bn_dims) > 1
        DISPATCH[f"{A.fmt}/binned" + ("-block" if native else "")] += 1
        return binned_spmv(A, x).to(_out_dtype(A, x))
    if A.fmt == "ell":
        if b == 1:
            DISPATCH["ell/window" if x.is_cuda else "ell/gather"] += 1
            return ell_spmv(A.cols, A.vals, x)
        DISPATCH["ell/block-gather"] += 1
        return _block_gather_spmv(A, x)
    if b == 1:
        pet = torch.promote_types(_acc(A.dtype), x.dtype)
        if A.vals is None:
            # lean binned pack whose planes the gate refused
            DISPATCH["csr/segsum-lean"] += 1
            rows, cols, vals = binned_entries_view(A)
        else:
            DISPATCH["csr/segsum"] += 1
            rows, cols, vals = A.row_ids, A.cols, A.vals
        y = torch.zeros(A.n_rows, dtype=pet, device=x.device)
        y.index_add_(0, rows.long(), vals.to(pet) * x.to(pet)[cols.long()])
        return y.to(_out_dtype(A, x))
    DISPATCH["csr/block-segsum"] += 1
    pet = torch.promote_types(_acc(A.dtype), x.dtype)
    xg = x.to(pet).reshape(A.n_cols, b)[A.cols.long()]
    prod = torch.einsum("eab,eb->ea", A.vals.to(pet), xg)
    y = torch.zeros((A.n_rows, b), dtype=pet, device=x.device)
    y.index_add_(0, A.row_ids.long(), prod)
    return y.reshape(-1).to(_out_dtype(A, x))


#: element budget of one materialised (n, Kc, b) x-gather in the block
#: ELL decline (``_BLOCK_GATHER_ELEMS`` upstream)
_BLOCK_GATHER_ELEMS = 1 << 24


def _block_gather_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """Block ELL gather (the JAX package's decline,
    ``spmv.py::_block_gather_spmv``), contracted per K-chunk so the
    (n, Kc, b) gather stays within an element budget."""
    b, n = A.block_dim, A.n_rows
    K = A.cols.shape[1]
    pet = torch.promote_types(_acc(A.dtype), x.dtype)
    xb = x.to(pet).reshape(A.n_cols, b)
    kc = max(1, min(K, _BLOCK_GATHER_ELEMS // max(n * b, 1)))
    y = torch.zeros((n, b), dtype=pet, device=x.device)
    for k0 in range(0, K, kc):
        k1 = min(k0 + kc, K)
        y = y + torch.einsum("nkab,nkb->na", A.vals[:, k0:k1].to(pet),
                             xb[A.cols[:, k0:k1].long()])
    return y.reshape(-1).to(_out_dtype(A, x))


def _bdia_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """Block-DIA apply (``spmv.py::_bdia_spmv`` upstream): every block
    diagonal carries an (n, b, b) value plane, no index data.

    Each in-block component (a, c) is exactly a scalar DIA over x's c-th
    component with the same block offsets, so the planes run as b²
    component dispatches of :func:`dia_spmv` (the pack keeps each
    component contiguous), added over c in order: kernel B1 on a CUDA
    tensor (``dia/block-kernel``), its plain version on a CPU tensor
    (``dia/block-slices``).  Both devices then add the same products in
    the same order, and round alike."""
    b = A.block_dim
    pet = torch.promote_types(_acc(A.dtype), x.dtype)
    DISPATCH["dia/block-kernel" if x.is_cuda else "dia/block-slices"] += 1
    xt = x.to(pet).reshape(A.n_cols, b).T.contiguous()     # (b, n_cols)
    cols = []
    for a in range(b):
        acc = None
        for c in range(b):
            ya = dia_spmv(A.vals[:, :, a, c], xt[c], A.dia_offsets)
            acc = ya if acc is None else acc + ya
        cols.append(acc)
    return torch.stack(cols, dim=1).reshape(-1).to(_out_dtype(A, x))


def residual(A, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """r = b − A·x (reference ``axmb``, fixed_cycle.cu:151)."""
    return b - spmv(A, x)


def abs_rowsum(A) -> torch.Tensor:
    """Σ_j |A[i, j]| per scalar row from the pack (pad and explicit zeros
    add 0): the L1-Jacobi diagonal without host work.  A ``dia3``
    operator carries the row sums of its embedded form."""
    if A.fmt == "dia3":
        return A.l1row
    if A.fmt == "csr" and A.vals is None:
        return binned_abs_rowsum(A)
    v = (A.ell_vals_view() if A.fmt == "ell" else A.vals).abs()
    if A.fmt == "dia":
        if A.block_dim > 1:
            # (nd, n, b, b): per scalar row (i, a), over every diagonal's
            # block row a
            return v.sum(dim=(0, 3)).reshape(-1)
        return v.sum(dim=0)
    if A.fmt == "ell":
        if A.block_dim > 1:
            return v.sum(dim=(1, 3)).reshape(-1)
        return v.sum(dim=1)
    if A.block_dim > 1:
        per = v.sum(dim=2)
        out = torch.zeros((A.n_rows, A.block_dim), dtype=per.dtype,
                          device=per.device)
        out.index_add_(0, A.row_ids.long(), per)
        return out.reshape(-1)
    out = torch.zeros(A.n_rows, dtype=v.dtype, device=v.device)
    out.index_add_(0, A.row_ids.long(), v)
    return out

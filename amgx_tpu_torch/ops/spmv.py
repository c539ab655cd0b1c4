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

Complex packs (the ``Z``/``C`` modes) take the plain paths under the JAX
package's gates, which admit real f32/bf16 only
(``amgx_tpu/ops/pallas_spmv.py:57-62``, ``pallas_ell.py:127-129``,
``pallas_shift.py:134-136``; the packer builds no shift or binned planes
of complex values): a scalar DIA pack takes ``dia/slices``, a scalar ELL
pack ``ell/gather``, a block-DIA pack ``dia/block-slices``, a b×b ELL
pack ``ell/block-gather``, a sharded pack ``sharded/gather`` or
``sharded/block-plain``, and the dense coarse product ``dense/lanes``
(:func:`~.ordered.dense_matvec`), on any device, their c64 products
rounded part by part (:func:`~.ordered.mul`) so that a c64 apply gives
the card the CPU's bits.  On a CUDA tensor each such apply is a decline
and is also counted in ``ON_CUDA`` (:func:`declines` reads both).  The
kernel wrappers themselves keep refusing a complex tensor.  An f64
vector through an f32 or bf16 level of ``hierarchy_dtype`` launches B1
or B3 in their (f32, f64) / (bf16, f64) pairs (the JAX package's gates
decline such a pair to its plain paths); a real pair that neither
kernel takes takes ``dia/slices`` or ``ell/gather`` in the promoted
dtype.

``sharded/window`` counts the applies of a sharded ELL pack
(:mod:`amgx_tpu_torch.distributed`) on a CUDA tensor: its halo exchange,
every shard's interior in one launch of kernel B3, and the boundary
correction (:func:`~amgx_tpu_torch.distributed.matrix.dist_spmv`);
``sharded/gather`` the same apply on a CPU tensor, the interior through
B3's plain version.  A b×b sharded pack counts ``sharded/block-binned``
on a CUDA tensor (its interior one launch of kernel B5 over the stacked
compact pack) and ``sharded/block-plain`` on a CPU tensor (B5's plain
version).  A bf16 sharded pack (``Matrix.device(dtype=torch.bfloat16)``)
takes an f32 x into B3 or B5 in their (bf16, f32) pairs and rounds y to
bf16 once, at the end.

``dense`` counts the applies of an fmt ``dense`` pack (built with
``AMGX_DENSE_PACK=1``): kernel B3 over dense rows on a CUDA tensor, its
plain version on a CPU tensor; ``op`` the applies of an implicit
operator (:mod:`amgx_tpu_torch.operators`), whose base pack's apply is
counted under its own label.

Telemetry (one attribute check when off): every apply runs inside its
label's ``amgx/spmv/<label>`` scope (``telemetry/scopes.py``; a ``dia3``
apply inside ``amgx/spmv/dia3`` too) and adds one to
``amgx_spmv_dispatch_total{pack=label}`` — per apply, where the JAX
package counts once per traced program; a CUDA graph replay adds the
applies its capture recorded (``utils/cuda_graph.py::credit``).  The
first apply of each operator emits its ``op_cost`` descriptor
(``telemetry/costmodel.py``), and ``MODEL_BYTES[label]`` sums the
modelled bytes of the label's applies (credited under replay as the
launch counters are), which the device-time anatomy divides by the
label's measured seconds.
"""
from __future__ import annotations

import inspect
import sys
import types
import weakref

import torch

from ..telemetry import recorder as _trecorder
from ..telemetry.scopes import _NULL as _NO_SCOPE
from .binned_spmv import (binned_abs_rowsum, binned_entries_view,
                          binned_spmv, binned_supported, bn_block_dim)
from .dia_spmv import SUPPORTED as DIA_PAIRS
from .dia_spmv import dia_spmv, dia_spmv_reference
from .ell_spmv import SUPPORTED as ELL_PAIRS
from .ell_spmv import ell_spmv, ell_spmv_reference
from .shift_spmv import shift_spmv, shift_supported

DISPATCH = {k: 0 for k in (
    "dia/kernel", "dia/slices", "dia/block-kernel", "dia/block-slices",
    "ell/shift", "ell/window", "ell/gather", "ell/binned", "ell/binned-block",
    "csr/binned", "csr/binned-block", "ell/block-gather", "csr/segsum",
    "csr/segsum-lean", "csr/block-segsum", "dense", "dense/lanes", "op",
    "sharded/window", "sharded/gather", "sharded/block-binned",
    "sharded/block-plain")}
#: plain-path labels that are a decline only on a CUDA tensor (complex
#: packs): their CUDA applies, counted apart from the CPU's
ON_CUDA = {k: 0 for k in ("dia/slices", "ell/gather", "dense/lanes",
                           "dia/block-slices", "sharded/gather",
                           "sharded/block-plain")}
#: the labels of the JAX package's declines (plain paths a kernel pack
#: falls to when its planes are missing, or its dtype gate refuses)
DECLINES = ("ell/block-gather", "csr/segsum", "csr/segsum-lean",
            "csr/block-segsum", "dia/slices", "ell/gather", "dense/lanes",
            "dia/block-slices", "sharded/gather", "sharded/block-plain")


#: modelled bytes of each label's applies while telemetry was on
MODEL_BYTES = {k: 0 for k in DISPATCH}
#: id(operator) → (weak reference, its cost descriptor), computed at its
#: first apply under telemetry (when its ``op_cost`` event is emitted);
#: a dead operator's entry goes with it
_COSTS: dict = {}


def _cost_of(A):
    got = _COSTS.get(id(A))
    return got[1] if got is not None and got[0]() is A else None


def reset_dispatch() -> None:
    for k in DISPATCH:
        DISPATCH[k] = 0
        MODEL_BYTES[k] = 0
    for k in ON_CUDA:
        ON_CUDA[k] = 0


def _tel(label: str, A=None):
    """The apply's telemetry: its scope, its dispatch count and, for an
    operator ``A``, its cost (see the module docstring)."""
    if not _trecorder._STATE.enabled:
        return _NO_SCOPE
    from ..telemetry import metrics, scopes
    from ..utils import cuda_graph
    capturing = cuda_graph._segments is not None
    if not capturing:
        # a capture's applies are counted by each replay instead
        metrics.counter_inc("amgx_spmv_dispatch_total", pack=label)
    if A is not None and label in MODEL_BYTES:
        cost = _cost_of(A)
        if cost is None and not capturing:
            # computed outside any capture (it may read the pack on
            # the host); the first, eager application comes first
            from ..telemetry import costmodel
            cost = costmodel.spmv_cost(A)
            key = id(A)
            _COSTS[key] = (weakref.ref(A, lambda _r: _COSTS.pop(key, None)),
                           cost)
            _trecorder.event("op_cost", **cost)
        if cost is not None and cost.get("bytes_per_apply"):
            MODEL_BYTES[label] += int(cost["bytes_per_apply"])
    return scopes.scope("spmv", label)


def declines() -> dict:
    """Applies per decline label since the last reset: the plain labels
    of ``ON_CUDA`` count their CUDA applies only."""
    return {k: ON_CUDA[k] if k in ON_CUDA else DISPATCH[k]
            for k in DECLINES}


def count_plain(label: str, x: torch.Tensor) -> None:
    """Count one apply of a plain-path label (a decline on a CUDA
    tensor)."""
    DISPATCH[label] += 1
    if x.is_cuda:
        ON_CUDA[label] += 1


def _complex(A, x: torch.Tensor) -> bool:
    return A.dtype.is_complex or x.is_complex()


def _acc(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f32 for a sub-f32 storage dtype."""
    return torch.float32 if dt in (torch.bfloat16, torch.float16) else dt


def _out_dtype(A, x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(A.dtype, x.dtype)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a :class:`~amgx_tpu_torch.core.DeviceMatrix` or a
    :class:`~amgx_tpu_torch.core.ComposedDIA`; ``x`` is the flat
    (n_cols·b,) vector and the result has dtype ``promote(A.dtype,
    x.dtype)``.  A bf16 pack accumulates in f32 on every path (kernels
    B1, B3 and B5 widen each value in registers), so an f32 vector
    through a bf16 hierarchy stays f32."""
    if A.fmt == "dia3":
        # Galerkin composition R·(A·(P·x)) — three DIA streams instead of
        # one low-fill embedded matrix
        with _tel("dia3"):
            return spmv(A.R, spmv(A.A, spmv(A.P, x)))
    if A.fmt == "op":
        # an implicit operator (operators.ImplicitOperator, the
        # reference's Operator::apply); its base pack dispatches as any
        DISPATCH["op"] += 1
        with _tel("op"):
            return A.apply(x)
    if x.dtype == torch.bfloat16:
        # an all-bf16 apply (a bf16 Krylov pack, a bf16 sharded pack):
        # the kernels take an f32 x, accumulate in f32, and the result
        # rounds once at the end
        return spmv(A, x.float()).to(_out_dtype(A, x))
    if A.fmt == "sharded-ell":
        # the halo exchange, the shards' interior in one B3 call and the
        # boundary correction (``spmv.py:107-110`` upstream)
        from ..distributed.matrix import dist_spmv
        plain = not x.is_cuda or _complex(A, x)
        if A.block_dim > 1:
            label = "sharded/block-plain" if plain \
                else "sharded/block-binned"
        else:
            label = "sharded/gather" if plain else "sharded/window"
        if plain:
            # a complex pack's interior is plain on every device (a
            # decline on the card)
            count_plain(label, x)
        else:
            DISPATCH[label] += 1
        with _tel(label, A):
            return dist_spmv(A, x)
    cplx = _complex(A, x)
    if A.fmt == "dia":
        if A.block_dim > 1:
            return _bdia_spmv(A, x)
        if cplx or (A.vals.dtype, x.dtype) not in DIA_PAIRS:
            # a complex pack, or a real pair B1 has no kernel for: the
            # plain slices in the promoted dtype, as the JAX package
            # declines
            count_plain("dia/slices", x)
            with _tel("dia/slices", A):
                return dia_spmv_reference(A.vals, x, A.dia_offsets)
        label = "dia/kernel" if x.is_cuda else "dia/slices"
        DISPATCH[label] += 1
        with _tel(label, A):
            return dia_spmv(A.vals, x, A.dia_offsets)
    if A.fmt == "dense":
        # one dense matrix-vector product (``spmv.py:150-156`` upstream):
        # B3 over dense rows, in its lane order (ordered.dense_matvec)
        from .ordered import dense_matvec
        pet = torch.promote_types(_acc(A.dtype), x.dtype)
        if not cplx:
            DISPATCH["dense"] += 1
        keep = A.vals.dtype == pet or (A.vals.dtype == torch.bfloat16
                                       and pet == torch.float32)
        with _tel("dense" if not cplx else "dense/lanes", A):
            M = A.vals if keep else A.vals.to(pet)
            return dense_matvec(M, x.to(pet).contiguous()).to(
                _out_dtype(A, x))
    b = A.block_dim
    if A.fmt == "ell" and shift_supported(A):
        DISPATCH["ell/shift"] += 1
        with _tel("ell/shift", A):
            return shift_spmv(A, x)
    if binned_supported(A):
        native = bn_block_dim(A.bn_dims) > 1
        label = f"{A.fmt}/binned" + ("-block" if native else "")
        DISPATCH[label] += 1
        with _tel(label, A):
            return binned_spmv(A, x).to(_out_dtype(A, x))
    if A.fmt == "ell":
        if b == 1 and (A.vals.dtype, x.dtype) not in ELL_PAIRS:
            # a complex pack, or a real pair B3 has no kernel for: the
            # JAX package's gather decline, in the promoted dtype
            count_plain("ell/gather", x)
            with _tel("ell/gather", A):
                return ell_spmv_reference(A.cols, A.vals, x)
        if b == 1:
            label = "ell/window" if x.is_cuda else "ell/gather"
            DISPATCH[label] += 1
            with _tel(label, A):
                return ell_spmv(A.cols, A.vals, x, A.row_len)
        DISPATCH["ell/block-gather"] += 1
        with _tel("ell/block-gather", A):
            return _block_gather_spmv(A, x)
    if b == 1:
        pet = torch.promote_types(_acc(A.dtype), x.dtype)
        label = "csr/segsum-lean" if A.vals is None else "csr/segsum"
        DISPATCH[label] += 1
        with _tel(label, A):
            if A.vals is None:
                # lean binned pack whose planes the gate refused
                rows, cols, vals = binned_entries_view(A)
            else:
                rows, cols, vals = A.row_ids, A.cols, A.vals
            y = torch.zeros(A.n_rows, dtype=pet, device=x.device)
            y.index_add_(0, rows.long(),
                         vals.to(pet) * x.to(pet)[cols.long()])
            return y.to(_out_dtype(A, x))
    DISPATCH["csr/block-segsum"] += 1
    with _tel("csr/block-segsum", A):
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
    cplx = _complex(A, x)
    # a complex pack takes the plain slices on every device (a decline
    # on the card, as B1 refuses complex values)
    label = "dia/block-kernel" if x.is_cuda and not cplx \
        else "dia/block-slices"
    apply = dia_spmv_reference if cplx else dia_spmv
    if cplx:
        count_plain(label, x)
    else:
        DISPATCH[label] += 1
    with _tel(label, A):
        xt = x.to(pet).reshape(A.n_cols, b).T.contiguous()  # (b, n_cols)
        cols = []
        for a in range(b):
            acc = None
            for c in range(b):
                ya = apply(A.vals[:, :, a, c], xt[c], A.dia_offsets)
                acc = ya if acc is None else acc + ya
            cols.append(acc)
        return torch.stack(cols, dim=1).reshape(-1).to(_out_dtype(A, x))


def spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a block of vectors X (n, m), one :func:`spmv` per
    column (``spmm`` upstream unrolls it so: a kernel launch per
    column); the eigensolvers' blocked product."""
    return torch.stack([spmv(A, X[:, j].contiguous())
                        for j in range(X.shape[1])], dim=1)


def residual(A, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """r = b − A·x (reference ``axmb``, fixed_cycle.cu:151)."""
    return b - spmv(A, x)


def abs_rowsum(A) -> torch.Tensor:
    """Σ_j |A[i, j]| per scalar row from the pack (pad and explicit zeros
    add 0): the L1-Jacobi diagonal without host work.  A ``dia3``
    operator carries the row sums of its embedded form.  Every row adds
    its terms in one fixed order on every device
    (:func:`~.ordered.sum_along` over the diagonals or slots, the block
    columns of each in turn; :func:`~.ordered.segment_sum` over a CSR
    pack's entries)."""
    from .ordered import segment_sum, sum_along
    if A.fmt == "dia3":
        return A.l1row
    if A.fmt == "sharded-ell":
        # halo entries belong to their row; padding rows sum to 1
        if A.block_dim > 1:
            # (N, K, b, b) -> (K·b, N, b): slot k's columns c in turn
            v = A.vals.abs()
            return sum_along(v.permute(1, 3, 0, 2).reshape(
                -1, v.shape[0], A.block_dim)).reshape(-1)
        return sum_along(A.vals.abs(), 1)
    if A.fmt == "dense":
        v = A.vals.abs()
        return sum_along(v.float() if v.dtype == torch.bfloat16 else v, 1)
    if A.fmt == "csr" and A.vals is None:
        return binned_abs_rowsum(A)
    v = (A.ell_vals_view() if A.fmt == "ell" else A.vals).abs()
    if v.dtype in (torch.bfloat16, torch.float16):
        v = v.float()
    b = A.block_dim
    if A.fmt == "dia":
        if b > 1:
            # (nd, n, b, b): per scalar row (i, a), over every diagonal's
            # block row a, its columns c in turn
            return sum_along(v.permute(0, 3, 1, 2).reshape(-1, A.n_rows, b)
                             ).reshape(-1)
        return sum_along(v, 0)
    if A.fmt == "ell":
        if b > 1:
            # (n, K, b, b) -> (K·b, n, b): slot k's columns c in turn
            return sum_along(v.permute(1, 3, 0, 2).reshape(-1, A.n_rows, b)
                             ).reshape(-1)
        return sum_along(v, 1)
    if b > 1:
        per = sum_along(v, 2)                       # (nnz, b)
        return segment_sum(per.T, A.row_ids, A.n_rows).T.reshape(-1)
    return segment_sum(v, A.row_ids, A.n_rows)


class _CallableModule(types.ModuleType):
    """This module, callable as its :func:`spmv`: the JAX package's
    ``ops`` namespace exports the function under the module's name
    (``amgx_tpu.ops.spmv(A, x)``), and the port's code and tests read
    the module's counters through the same name."""

    def __call__(self, A, x: torch.Tensor) -> torch.Tensor:
        return spmv(A, x)


__signature__ = inspect.signature(spmv)
sys.modules[__name__].__class__ = _CallableModule

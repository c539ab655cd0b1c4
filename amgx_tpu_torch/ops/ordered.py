"""Sums in one order on every device.

The card and the CPU order the partial sums of a library reduction or
matrix-vector product differently, and in f32 an iteration count can
follow the last bit of such a sum.  The solvers whose counts must agree
on both devices (FGMRES, the K-cycle, BiCGStab, CG/PCG, and the dense
coarse solve below them) take the forms of this module:

* an f32 inner product summed in f64 and rounded once: the products of
  two f32 values are exact in f64, and the devices' different f64
  summation orders move the rounded f32 result only when the sum lies
  within a few f64 units in the last place of an f32 rounding boundary:
  :func:`wdot`, :func:`wnrm2`, :func:`wgram_dots` and the fused
  Arnoldi pass :func:`wgram_dots_with_norm` (the CA and pipelined CG
  steps widen their operands before ``blas.fused_reduce``);
* a linear combination added left to right, one elementwise op at a
  time: :func:`lincomb`;
* a sum along one axis added left to right, one elementwise op at a
  time (:func:`sum_along`), and a sum over segments of a flat entry
  list — a stable sort by segment, then a segmented log-step scan
  (:func:`segment_sum`): the L1 row sums of every pack
  (``ops/spmv.py::abs_rowsum``, ``ops/binned_spmv.py::binned_abs_rowsum``
  and the classical pipeline's level 1), in place of the library
  reductions and the card's atomic ``index_add_``;
* a dense matrix-vector product through kernel B3 over dense rows, which
  rounds each product and sum on its own in its plain version's order
  (a complex one through that plain version, a counted decline):
  :func:`dense_matvec`;
* the guarded inverse of b×b blocks (block Jacobi's D⁻¹, DILU's E⁻¹) by
  an elementwise Gauss–Jordan elimination: :func:`guarded_block_inv`;
* c64 products and quotients as real elementwise ops, each rounded on
  its own (:func:`mul`, :func:`div`): the card's complex kernels fuse a
  product into the following sum (``a·c − b·d`` as one FMA), the CPU's
  do not, and a c64 solve's count then follows the device.  A c64 inner
  product widens to c128 as an f32 one widens to f64.  c128 keeps the
  library's complex ops (its card = CPU agreement is to a tolerance, as
  for f64).

The kernels (B1–B5) keep the same rule in their own sources: each is
bit-equal to its plain version.
"""
from __future__ import annotations

import torch

from .blas import dot, gram_dots, gram_dots_with_norm, record
from .ell_spmv import ell_spmv, ell_spmv_reference

__all__ = ["widen", "wdot", "wnrm2", "wgram_dots", "wgram_dots_with_norm",
           "lincomb", "sum_along", "segment_sum", "dense_matvec",
           "guarded_block_inv", "mul", "div", "recip"]


def widen(v):
    """An f32 (or bf16) vector in f64, a c64 one in c128; any other
    unchanged."""
    if v.dtype in (torch.float32, torch.bfloat16):
        return v.double()
    if v.dtype == torch.complex64:
        return v.to(torch.complex128)
    return v


def _parts(v):
    return (v.real, v.imag) if v.is_complex() else (v, None)


def _c64(a, b) -> bool:
    return any(torch.is_tensor(v) and v.dtype == torch.complex64
               for v in (a, b))


def mul(a, b):
    """a·b elementwise (broadcasting).  A c64 product is computed as
    ``(ar·br − ai·bi) + i(ar·bi + ai·br)`` with each product and sum its
    own op, so every part rounds alike on the card and the CPU; a real
    operand scales the other's parts.  Other operands take ``a * b``."""
    if not _c64(a, b):
        return a * b
    if not (torch.is_tensor(a) and a.is_complex()):
        a, b = b, a
    ar, ai = _parts(a)
    if not (torch.is_tensor(b) and b.is_complex()):
        return torch.complex(ar * b, ai * b)
    br, bi = _parts(b)
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)


def div(a, b):
    """a / b elementwise: a c64 quotient as ``a·conj(b) / |b|²`` in real
    elementwise ops (:func:`mul`); a real divisor divides each part.
    Other operands take ``a / b``."""
    if not _c64(a, b):
        return a / b
    b_c = torch.is_tensor(b) and b.is_complex()
    if not b_c:
        if torch.is_tensor(a) and a.is_complex():
            return torch.complex(a.real / b, a.imag / b)
        return a / b
    br, bi = b.real, b.imag
    den = br * br + bi * bi
    num = mul(a, b.conj().resolve_conj())
    return torch.complex(num.real / den, num.imag / den)


def recip(d):
    """1/d elementwise (:func:`div` for c64 d)."""
    if d.dtype == torch.complex64:
        return div(torch.ones_like(d), d)
    return 1.0 / d


def wdot(x, y):
    """x·y, an f32 pair summed in f64 and rounded once."""
    record("dot")
    return dot(widen(x), widen(y)).to(x.dtype)


def wnrm2(x):
    """‖x‖₂, an f32 vector's squares summed in f64 and rounded once."""
    record("norm")
    w = widen(x)
    return torch.sqrt(dot(w, w).real).to(x.real.dtype)


def wgram_dots(V, w):
    """Gram–Schmidt projections ``V @ w`` onto the rows of V, an f32 basis
    summed in f64 and rounded once."""
    record("gram")
    return gram_dots(widen(V), widen(w)).to(V.dtype)


def wgram_dots_with_norm(V, w):
    """:func:`~.blas.gram_dots_with_norm` of an f32 basis summed in f64
    and rounded once."""
    record("fused")
    h, ww = gram_dots_with_norm(widen(V), widen(w))
    return h.to(V.dtype), ww.to(w.real.dtype)


def lincomb(V, c):
    """Σ_k c[k]·V[k] over the rows of V, added left to right one
    elementwise op at a time (``c`` stays on the device; complex
    products by :func:`mul`)."""
    acc = mul(c[0], V[0])
    for k in range(1, V.shape[0]):
        acc = acc + mul(c[k], V[k])
    return acc


def sum_along(v: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Σ over axis ``dim`` of ``v``, its slices added left to right one
    elementwise op at a time (an empty axis sums to 0)."""
    v = v.movedim(dim, 0)
    if v.shape[0] == 0:
        return v.new_zeros(v.shape[1:])
    acc = v[0]
    for k in range(1, v.shape[0]):
        acc = acc + v[k]
    return acc


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Σ of ``vals`` over each segment id of ``seg`` in [0, n) along the
    last axis of ``vals`` (leading axes are batch): the entries sorted
    stably by segment (each segment keeps its entries' order), then a
    segmented log-step scan (:func:`~.spgemm.seg_sum_scan`) whose every
    step is one elementwise op.  Segments without entries sum to 0."""
    from .spgemm import seg_sum_scan
    out = vals.new_zeros(vals.shape[:-1] + (n,))
    m = seg.shape[0]
    if m == 0:
        return out
    s, order = torch.sort(seg.long(), stable=True)
    v = vals[..., order]
    new = torch.ones(m, dtype=torch.bool, device=seg.device)
    new[1:] = s[1:] != s[:-1]
    run = seg_sum_scan(v, new.expand(v.shape))
    last = torch.ones(m, dtype=torch.bool, device=seg.device)
    last[:-1] = new[1:]
    out[..., s[last]] = run[..., last]
    return out


def guarded_block_inv(E: torch.Tensor) -> torch.Tensor:
    """The inverse of (m, b, b) blocks under the singular-block rule of
    the JAX package (``amgx_tpu/solvers/jacobi.py::_invert_block_diag``,
    ``amgx_tpu/solvers/dilu.py::_guarded_batch_inv``): each block
    normalised by its largest entry and inverted by Gauss–Jordan
    elimination with partial pivoting (the first largest pivot candidate
    wins), as elementwise ops; blocks with zero scale or ``|det| < b·eps``
    take E⁻¹ = I."""
    m, bd = E.shape[0], E.shape[-1]
    eps = float(torch.finfo(E.dtype).eps)
    eye = torch.eye(bd, dtype=E.dtype, device=E.device)
    scale = torch.amax(torch.abs(E), dim=(-2, -1))
    nz = scale > 0
    sc = torch.where(nz, scale, torch.ones_like(scale))[:, None, None]
    M = torch.where(nz[:, None, None], E / sc, eye)
    inv = eye.expand(m, bd, bd).clone()
    det = torch.ones(m, dtype=E.dtype, device=E.device)
    ar = torch.arange(m, device=E.device)
    for c in range(bd):
        piv = c + torch.argmax(torch.abs(M[:, c:, c]), dim=1)
        swap = piv != c
        det = torch.where(swap, -det, det)
        for T in (M, inv):
            top, other = T[:, c].clone(), T[ar, piv].clone()
            T[ar, piv] = top
            T[:, c] = other
        p = M[:, c, c].clone()
        det = det * p
        safe = torch.where(p != 0, p, torch.ones_like(p))[:, None]
        M[:, c] = M[:, c] / safe
        inv[:, c] = inv[:, c] / safe
        for r in range(bd):
            if r != c:
                f = M[:, r, c].clone()[:, None]
                M[:, r] = M[:, r] - f * M[:, c]
                inv[:, r] = inv[:, r] - f * inv[:, c]
    bad = ~nz | (torch.abs(det) < bd * eps)
    return torch.where(bad[:, None, None], eye, inv / sc)


def dense_matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = M·x for a dense (n, len(x)) row-major M: kernel B3 over dense
    rows (no column table), summed in its lane order.  B3 takes no
    complex pair (nor does the JAX package's window kernel): a complex
    product takes B3's plain version on any device
    (:func:`~.ell_spmv.ell_spmv_reference`), counted as the decline
    ``dense/lanes``."""
    if M.is_complex() or x.is_complex():
        from .spmv import count_plain
        count_plain("dense/lanes", x)
        return ell_spmv_reference(None, M, x)
    return ell_spmv(None, M, x)

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
* a dense matrix-vector product through kernel B3 over dense rows, which
  rounds each product and sum on its own in its plain version's order:
  :func:`dense_matvec`;
* the guarded inverse of b×b blocks (block Jacobi's D⁻¹, DILU's E⁻¹) by
  an elementwise Gauss–Jordan elimination: :func:`guarded_block_inv`.

The kernels (B1–B5) keep the same rule in their own sources: each is
bit-equal to its plain version.
"""
from __future__ import annotations

import torch

from .blas import dot, gram_dots, gram_dots_with_norm
from .ell_spmv import dense_matvec

__all__ = ["widen", "wdot", "wnrm2", "wgram_dots", "wgram_dots_with_norm",
           "lincomb", "dense_matvec", "guarded_block_inv"]


def widen(v):
    """An f32 vector in f64; any other unchanged."""
    return v.double() if v.dtype == torch.float32 else v


def wdot(x, y):
    """x·y, an f32 pair summed in f64 and rounded once."""
    return dot(widen(x), widen(y)).to(x.dtype)


def wnrm2(x):
    """‖x‖₂, an f32 vector's squares summed in f64 and rounded once."""
    w = widen(x)
    return torch.sqrt(dot(w, w).real).to(x.real.dtype)


def wgram_dots(V, w):
    """Gram–Schmidt projections ``V @ w`` onto the rows of V, an f32 basis
    summed in f64 and rounded once."""
    return gram_dots(widen(V), widen(w)).to(V.dtype)


def wgram_dots_with_norm(V, w):
    """:func:`~.blas.gram_dots_with_norm` of an f32 basis summed in f64
    and rounded once."""
    h, ww = gram_dots_with_norm(widen(V), widen(w))
    return h.to(V.dtype), ww.to(w.real.dtype)


def lincomb(V, c):
    """Σ_k c[k]·V[k] over the rows of V, added left to right one
    elementwise op at a time (``c`` stays on the device)."""
    acc = c[0] * V[0]
    for k in range(1, V.shape[0]):
        acc = acc + c[k] * V[k]
    return acc


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

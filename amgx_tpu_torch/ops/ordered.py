"""Sums in one order on every device.

The card and the CPU order the partial sums of a library reduction or
matrix-vector product differently, and in f32 an iteration count can
follow the last bit of such a sum.  The solvers whose counts must agree
on both devices (FGMRES, the K-cycle, BiCGStab, and the dense coarse
solve below them) take the forms of this module:

* an f32 inner product summed in f64 and rounded once: the products of
  two f32 values are exact in f64, and the devices' different f64
  summation orders move the rounded f32 result only when the sum lies
  within a few f64 units in the last place of an f32 rounding boundary:
  :func:`wdot`, :func:`wnrm2`, :func:`wgram_dots`;
* a linear combination added left to right, one elementwise op at a
  time: :func:`lincomb`;
* a dense matrix-vector product through kernel B3 over dense rows, which
  rounds each product and sum on its own in its plain version's order:
  :func:`dense_matvec`.

The kernels (B1–B5) keep the same rule in their own sources: each is
bit-equal to its plain version.
"""
from __future__ import annotations

import torch

from .blas import dot, gram_dots
from .ell_spmv import dense_matvec

__all__ = ["widen", "wdot", "wnrm2", "wgram_dots", "lincomb",
           "dense_matvec"]


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


def lincomb(V, c):
    """Σ_k c[k]·V[k] over the rows of V, added left to right one
    elementwise op at a time (``c`` stays on the device)."""
    acc = c[0] * V[0]
    for k in range(1, V.shape[0]):
        acc = acc + c[k] * V[k]
    return acc

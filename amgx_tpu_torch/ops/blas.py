"""BLAS-1 vector operations and norms (port of the CLASSIC-mode half of
``amgx_tpu/ops/blas.py``; reference ``base/include/blas.h:40-104``,
``base/src/norm.cu``).  Results of reductions stay 0-d device tensors:
nothing here synchronises with the host.
"""
from __future__ import annotations

import torch

NORM_L1 = "L1"
NORM_L2 = "L2"
NORM_LMAX = "LMAX"
NORM_L1_SCALED = "L1_SCALED"


def axpy(y, x, alpha):
    """y + alpha·x"""
    return y + alpha * x


def axpby(x, y, alpha, beta):
    """alpha·x + beta·y"""
    return alpha * x + beta * y


def dot(x, y):
    """Conjugated dot product (reference ``dotc``)."""
    if x.is_complex():
        return torch.vdot(x, y)
    return torch.dot(x, y)


def nrm2(x):
    return torch.sqrt(dot(x, x).real)


def nrm1(x):
    return torch.sum(torch.abs(x))


def nrmmax(x):
    return torch.max(torch.abs(x))


def norm(v, norm_type: str = NORM_L2, block_dim: int = 1,
         use_scalar_norm: bool = True):
    """Convergence norm of a vector: a 0-d tensor with ``use_scalar_norm``
    (or block_dim 1), else the per-block-component norms, shape
    (block_dim,), as the reference's block norms (``norm.cu``;
    ``use_scalar_norm``, core.cu:542)."""
    if use_scalar_norm or block_dim == 1:
        if norm_type in (NORM_L1, NORM_L1_SCALED):
            r = nrm1(v)
            return r / v.shape[0] if norm_type == NORM_L1_SCALED else r
        if norm_type == NORM_LMAX:
            return nrmmax(v)
        return nrm2(v)
    vb = v.reshape(-1, block_dim)
    if norm_type in (NORM_L1, NORM_L1_SCALED):
        r = torch.sum(torch.abs(vb), dim=0)
        return r / vb.shape[0] if norm_type == NORM_L1_SCALED else r
    if norm_type == NORM_LMAX:
        return torch.amax(torch.abs(vb), dim=0)
    return torch.sqrt(torch.sum(torch.abs(vb) ** 2, dim=0))


def gram_dots(V, w):
    """Gram–Schmidt projections ``conj(V) @ w`` onto the rows of V:
    one matrix-vector product."""
    return torch.mv(V.conj() if V.is_complex() else V, w)

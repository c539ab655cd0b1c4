"""Strength of connection for classical AMG (port of the AHAT, ALL and
AFFINITY measures of ``amgx_tpu/amg/classical/strength.py``; reference
``core/src/classical/strength/``).  Host numpy/scipy setup code.

Parameters ``strength_threshold`` and ``max_row_sum`` (core.cu:504-506):
rows whose row sum exceeds ``max_row_sum·|a_ii|`` lose their strong
dependencies.  AFFINITY (test-vector strength) seeds its vectors with
``default_rng(42)``, as the JAX package does.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp

from ...errors import BadConfigurationError

_strength_registry: Dict[str, type] = {}


def register_strength(name):
    def deco(cls):
        _strength_registry[name] = cls
        cls.config_name = name
        return cls
    return deco


def create_strength(name, cfg, scope):
    if name not in _strength_registry:
        raise BadConfigurationError(f"unknown strength {name!r}")
    return _strength_registry[name](cfg, scope)


class _StrengthBase:
    def __init__(self, cfg, scope):
        self.cfg = cfg
        self.scope = scope
        self.theta = float(cfg.get("strength_threshold", scope))
        self.max_row_sum = float(cfg.get("max_row_sum", scope))

    def compute(self, A: sp.csr_matrix) -> sp.csr_matrix:
        """Return boolean strength matrix S (S[i,j]=1 ⇔ i strongly depends
        on j), diagonal excluded."""
        raise NotImplementedError


@register_strength("AHAT")
class AhatStrength(_StrengthBase):
    """Classic RS strength: i depends strongly on j iff
    −a_ij ≥ θ·max_k(−a_ik)  (positive-offdiag entries use |a_ij| when the
    row has no negative entries).  Reference ``strength/ahat.cu``."""

    def compute(self, A):
        A = sp.csr_matrix(A)
        n = A.shape[0]
        indptr, indices, data = A.indptr, A.indices, A.data
        rows = np.repeat(np.arange(n), np.diff(indptr))
        off = indices != rows
        diag = A.diagonal()
        # measure: -a_ij for sign-flipped connections (M-matrix
        # convention); |a_ij| for rows without a negative connection
        sgn = np.sign(diag)[rows]
        meas = np.where(off, -data * np.where(sgn == 0, 1.0, sgn), -np.inf)
        meas_abs = np.where(off, np.abs(data), -np.inf)
        rowmax = np.full(n, -np.inf)
        np.maximum.at(rowmax, rows, meas)
        no_neg = ~(rowmax > 0)
        use_abs = no_neg[rows]
        meas_f = np.where(use_abs, meas_abs, meas)
        rowmax = np.where(no_neg, -np.inf, rowmax)
        np.maximum.at(rowmax, rows[use_abs], meas_abs[use_abs])

        strong = off & (meas_f >= self.theta * rowmax[rows]) & (meas_f > 0)

        # max_row_sum weakening (core.cu:506): if |Σ_j a_ij| / |a_ii| >
        # max_row_sum the row's dependencies are dropped
        if self.max_row_sum < 1.0 + 1e-12:
            rs = np.asarray(A.sum(axis=1)).ravel()
            dsafe = np.where(diag == 0, 1.0, diag)
            weak_row = np.abs(rs / dsafe) > self.max_row_sum
            strong &= ~weak_row[rows]

        S = sp.csr_matrix((strong.astype(np.int8), indices.copy(),
                           indptr.copy()), shape=A.shape)
        S.eliminate_zeros()
        # the mask aligned with A's stored entries, keyed on the shared
        # index buffers (util.entry_mask_in looks it up)
        S._amgx_mask_src = (A.indices, A.indptr, strong)
        return S


@register_strength("ALL")
class AllStrength(_StrengthBase):
    """Every off-diagonal connection is strong (``strength/all.cu``)."""

    def compute(self, A):
        A = sp.csr_matrix(A)
        S = sp.csr_matrix(
            (np.ones(len(A.data), dtype=np.int8), A.indices.copy(),
             A.indptr.copy()), shape=A.shape)
        S.setdiag(0)
        S.eliminate_zeros()
        rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
        S._amgx_mask_src = (A.indices, A.indptr, A.indices != rows)
        return S


@register_strength("AFFINITY")
class AffinityStrength(_StrengthBase):
    """Affinity (test-vector) strength (``strength/affinity.cu``): relax
    random vectors with Jacobi and connect nodes whose test-vector values
    correlate."""

    def compute(self, A):
        A = sp.csr_matrix(A)
        n = A.shape[0]
        k = int(self.cfg.get("affinity_vectors", self.scope))
        iters = int(self.cfg.get("affinity_iterations", self.scope))
        rng = np.random.default_rng(42)
        X = rng.standard_normal((n, k))
        d = A.diagonal()
        dinv = 1.0 / np.where(d == 0, 1.0, d)
        for _ in range(iters):
            X = X - 0.6 * (dinv[:, None] * (A @ X))
        # affinity c_ij = (x_i·x_j)^2 / (|x_i|^2 |x_j|^2) over the sparsity
        indptr, indices = A.indptr, A.indices
        rows = np.repeat(np.arange(n), np.diff(indptr))
        num = np.einsum("ek,ek->e", X[rows], X[indices]) ** 2
        den = (np.einsum("ek,ek->e", X[rows], X[rows]) *
               np.einsum("ek,ek->e", X[indices], X[indices]))
        aff = num / np.where(den == 0, 1.0, den)
        off = indices != rows
        aff = np.where(off, aff, -np.inf)
        rowmax = np.full(n, -np.inf)
        np.maximum.at(rowmax, rows, aff)
        strong = off & (aff >= self.theta * rowmax[rows])
        S = sp.csr_matrix((strong.astype(np.int8), indices.copy(),
                           indptr.copy()), shape=A.shape)
        S.eliminate_zeros()
        S._amgx_mask_src = (A.indices, A.indptr, strong)
        return S

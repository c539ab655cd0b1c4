"""Implicit linear operators for Krylov-on-operator solves (port of
``amgx_tpu/operators.py``).

Reference: ``base/include/operators/operator.h:37-80`` (the abstract
``Operator::apply`` the solver framework accepts instead of a concrete
matrix) and its flavours in ``core/src/operators/``:
``shifted_operator.cu`` (A − σI), ``deflated_multiply_operator.cu``
(A·v − λ (v·x₀) x₀ for locked eigenpairs), ``pagerank_operator.cu``
(damped column-stochastic web operator), ``solve_operator.cu`` /
``solver_operator.cu`` (a nested solver as an operator).

An operator has ``fmt == "op"``: :func:`amgx_tpu_torch.ops.spmv.spmv`
dispatches it to :meth:`ImplicitOperator.apply` (counted ``op``), whose
base pack's SpMV is that pack's kernel (B1 for DIA; B3 or B4 for the
PageRank link pack, whichever the packer chose).  ``Solver.setup``
accepts an operator wherever it accepts a matrix; a solver that needs
the host matrix (AMG) refuses it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .ops.spmv import spmv

__all__ = ["ImplicitOperator", "ShiftedOperator", "DeflatedOperator",
           "PageRankOperator", "SolverOperator", "as_operator"]


@dataclasses.dataclass(frozen=True)
class ImplicitOperator:
    """A linear operator defined by composition over a base pack.

    ``base``: the underlying DeviceMatrix (or another operator); ``aux``:
    kind-specific tensors (shift scalar, deflation basis and values,
    damping and dangling mask); ``diag``: the operator's diagonal, which
    the Jacobi-family smoothers read (reference
    ``Matrix::computeDiagonal``)."""

    base: Any
    diag: torch.Tensor
    aux: Any
    n_rows: int
    n_cols: int
    kind: str

    fmt = "op"
    block_dim = 1
    ell_width = 0

    @property
    def n(self) -> int:
        return self.n_rows

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "shifted":
            # (A − σI)·x  (shifted_operator.cu's apply)
            return spmv(self.base, x) - self.aux * x
        if self.kind == "deflated":
            # A·x − Σ_k λ_k (x·v_k) v_k  (deflated_multiply_operator.cu)
            V, lam = self.aux
            coef = lam * torch.mv(V.T, x)
            return spmv(self.base, x) - torch.mv(V, coef)
        if self.kind == "pagerank":
            # α·Aᵀ_stoch·x + teleport (pagerank_operator.cu): base is the
            # pre-normalised column-stochastic pack; aux = (alpha,
            # dangling mask)
            alpha, dangle = self.aux
            y = spmv(self.base, x)
            leaked = torch.sum(torch.where(dangle, x, torch.zeros_like(x)))
            nr = self.n_rows
            return alpha * (y + leaked / nr) + \
                (1.0 - alpha) * torch.sum(x) / nr
        raise ValueError(f"unknown operator kind {self.kind!r}")


def _matrix_pack(A):
    """The device pack of a Matrix/DeviceMatrix/operator argument."""
    return A.device() if callable(getattr(A, "device", None)) else A


def ShiftedOperator(A, sigma: float) -> ImplicitOperator:
    """``(A − σI)`` without materialising the shift
    (``shifted_operator.cu``)."""
    Ad = _matrix_pack(A)
    sig = torch.tensor(sigma, dtype=Ad.dtype, device=Ad.device)
    return ImplicitOperator(base=Ad, diag=Ad.diag - sig, aux=sig,
                            n_rows=Ad.n_rows, n_cols=Ad.n_cols,
                            kind="shifted")


def DeflatedOperator(A, vectors, values) -> ImplicitOperator:
    """``A·v − Σ λ_k (v·x_k) x_k`` for locked eigenpairs
    (``deflated_multiply_operator.cu``)."""
    Ad = _matrix_pack(A)
    V = torch.as_tensor(np.asarray(vectors) if not torch.is_tensor(vectors)
                        else vectors, dtype=Ad.dtype, device=Ad.device)
    if V.dim() == 1:
        V = V[:, None]
    lam = torch.atleast_1d(torch.as_tensor(
        np.asarray(values) if not torch.is_tensor(values) else values,
        dtype=Ad.dtype, device=Ad.device))
    diag = Ad.diag - torch.sum(lam[None, :] * V * V, dim=1)
    return ImplicitOperator(base=Ad, diag=diag, aux=(V.contiguous(), lam),
                            n_rows=Ad.n_rows, n_cols=Ad.n_cols,
                            kind="deflated")


def PageRankOperator(W, alpha: float = 0.85,
                     device=None) -> ImplicitOperator:
    """The damped PageRank iteration operator over a link matrix ``W``
    (rows = source pages), matching ``pagerank_operator.cu``'s
    normalise-then-damp apply.  ``W`` is a :class:`~.core.Matrix` (its
    placement and device dtype apply) or a scipy matrix packed on
    ``device`` (default ``"cuda"``) in f32."""
    import scipy.sparse as sp

    from .core.matrix import Matrix, pack_device
    is_m = isinstance(W, Matrix)
    Wc = sp.csr_matrix(W.host if is_m else W)
    out_deg = np.asarray(Wc.sum(axis=1)).ravel()
    dangle = out_deg == 0
    inv = np.where(dangle, 0.0, 1.0 / np.where(dangle, 1.0, out_deg))
    # column-stochastic transpose pack: y = Wᵀ D⁻¹ x
    S = sp.csr_matrix(Wc.T @ sp.diags(inv))
    dtype = np.dtype((W.device_dtype if is_m else None) or np.float32)
    dev = W.placement if is_m else (device or "cuda")
    Sd = pack_device(S, 1, dtype, device=dev)
    return ImplicitOperator(
        base=Sd, diag=Sd.diag * alpha,
        aux=(torch.tensor(alpha, dtype=Sd.dtype, device=Sd.device),
             torch.from_numpy(dangle).to(Sd.device)),
        n_rows=Sd.n_rows, n_cols=Sd.n_cols, kind="pagerank")


class SolverOperator:
    """A configured solver as a linear operator v ↦ solve(A, v)
    (``solve_operator.cu`` / ``solver_operator.cu``): host-driven
    composition, each apply one monitored solve of the inner solver."""

    def __init__(self, solver):
        self.solver = solver

    def apply(self, v):
        return self.solver.solve(v).x


def as_operator(obj) -> Optional[ImplicitOperator]:
    return obj if isinstance(obj, ImplicitOperator) else None

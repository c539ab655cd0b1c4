"""Matrix scalers: equation scaling pre/post solve (port of
``amgx_tpu/solvers/scalers.py``: host scipy at setup; the solve
boundary scales torch tensors on their own device, numpy arrays on the
host, with the same f64 factors).

Reference: ``core/src/scalers/`` (1538 LoC; registered core.cu:703-705;
workaround flow documented ``solver.cu:441-455``): BINORMALIZATION
(Sinkhorn-style row/column 2-norm equilibration), NBINORMALIZATION,
DIAGONAL_SYMMETRIC (D^{-1/2}·A·D^{-1/2}).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp
import torch

from ..errors import BadConfigurationError

_scaler_registry: Dict[str, type] = {}


def register_scaler(name):
    def deco(cls):
        _scaler_registry[name] = cls
        cls.config_name = name
        return cls
    return deco


def create_scaler(name, cfg, scope):
    if name not in _scaler_registry:
        raise BadConfigurationError(f"unknown scaler {name!r}")
    return _scaler_registry[name](cfg, scope)


class Scaler:
    """left/right diagonal scaling: A' = Dl·A·Dr, b' = Dl·b, x = Dr·x'."""

    def __init__(self, cfg, scope):
        self.cfg = cfg
        self.scope = scope
        self.dl = None
        self.dr = None

    def setup(self, A: sp.csr_matrix):
        raise NotImplementedError

    def scale_matrix(self, A: sp.csr_matrix) -> sp.csr_matrix:
        return sp.csr_matrix(
            sp.diags(self.dl) @ A @ sp.diags(self.dr))

    def _factor(self, name: str, like):
        """The f64 factor ``dl``/``dr`` as ``like``'s kind: a numpy array,
        or a tensor on ``like``'s device (copied there once)."""
        v = getattr(self, name)
        if not isinstance(like, torch.Tensor):
            return v
        cache = self.__dict__.setdefault("_on_device", {})
        key = (name, like.device)
        if key not in cache:
            cache[key] = torch.from_numpy(np.ascontiguousarray(v)).to(
                like.device)
        return cache[key]

    def scale_rhs(self, b):
        return self._factor("dl", b) * b

    def unscale_solution(self, x):
        return self._factor("dr", x) * x

    def scale_initial_guess(self, x0):
        dr = self._factor("dr", x0)
        if isinstance(dr, torch.Tensor):
            return x0 / torch.where(dr == 0, 1.0, dr)
        return x0 / np.where(dr == 0, 1.0, dr)


@register_scaler("DIAGONAL_SYMMETRIC")
class DiagonalSymmetricScaler(Scaler):
    def setup(self, A):
        d = np.abs(A.diagonal())
        d[d == 0] = 1.0
        s = 1.0 / np.sqrt(d)
        self.dl = s
        self.dr = s
        return self


@register_scaler("BINORMALIZATION")
class BinormalizationScaler(Scaler):
    """Iterative row/col 2-norm equilibration (``binormalization.cu``)."""

    n_iters = 10

    def setup(self, A):
        A2 = sp.csr_matrix(A).copy()
        A2.data = A2.data ** 2
        n, m = A.shape
        dl = np.ones(n)
        dr = np.ones(m)
        for _ in range(self.n_iters):
            rs = A2 @ (dr ** 2)          # row 2-norms² of Dl·A·Dr
            rs[rs == 0] = 1.0
            dl = 1.0 / np.sqrt(rs)
            cs = A2.T @ (dl ** 2)
            cs[cs == 0] = 1.0
            dr = 1.0 / np.sqrt(cs)
        # symmetric matrices keep a symmetric scaling (PCG requires the
        # scaled operator to stay SPD) — use the geometric mean of the two
        # one-sided equilibrations
        diffnorm = sp.linalg.norm(A - A.T) if n == m else np.inf
        if diffnorm <= 1e-12 * sp.linalg.norm(A):
            d = np.sqrt(np.abs(dl * dr))
            dl = dr = d
        self.dl, self.dr = dl, dr
        return self


@register_scaler("NBINORMALIZATION")
class NBinormalizationScaler(Scaler):
    """NORMALISED binormalization (``nbinormalization.cu:440-540``) —
    algorithmically distinct from BINORMALIZATION (round-4 advisor):
    Sinkhorn on B = A∘A with row-sum target ``cols`` and col-sum target
    ``rows`` via EXACT alternating updates x = cols/(B·y),
    y = rows/(Bᵀ·x), a measured std-deviation stopping test
    (tol 1e-10, ≤50 sweeps), and the final scaling
    F = √|x|, G = √|y| — so ‖F·A·G‖²_F ≈ rows·cols with every row and
    column of the squared matrix equilibrated to its target."""

    max_iters = 50
    tolerance = 1e-10

    def setup(self, A):
        B = sp.csr_matrix(A).copy()
        B.data = B.data ** 2
        n, m = B.shape
        x = np.ones(n)
        y = np.ones(m)
        sum1, sum2 = float(m), float(n)
        beta = B @ y
        gamma = B.T @ x

        def dev(v, s, target):
            return np.sqrt(np.mean((v * s - target) ** 2)) / target

        std = np.hypot(dev(x, beta, sum1), dev(y, gamma, sum2))
        for _ in range(self.max_iters):
            if std < self.tolerance:
                break
            x = np.where(np.abs(beta) > 1e-300, sum1 /
                         np.where(beta == 0, 1.0, beta), 1.0)
            gamma = B.T @ x
            y = np.where(np.abs(gamma) > 1e-300, sum2 /
                         np.where(gamma == 0, 1.0, gamma), 1.0)
            beta = B @ y
            std = dev(x, beta, sum1)
        dl = np.sqrt(np.abs(x))
        dr = np.sqrt(np.abs(y))
        # keep SPD operators SPD for PCG (the same symmetrisation the
        # BINORMALIZATION port applies; x ≈ y for symmetric A anyway)
        diffnorm = sp.linalg.norm(A - A.T) if n == m else np.inf
        if diffnorm <= 1e-12 * sp.linalg.norm(A):
            d = np.sqrt(np.abs(dl * dr))
            dl = dr = d
        self.dl, self.dr = dl, dr
        return self

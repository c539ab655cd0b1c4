"""Eigensolver framework (port of ``amgx_tpu/eigen/base.py``).

Reference: ``base/include/eigensolvers/eigensolver.h:48-179`` (EigenSolver
base: setup/solve contract, shift, which=largest/smallest, eigenvector
extraction) and the factory registry
(``eigensolvers/src/eigensolvers.cu:60-70``); parameters ``eig_*``
(``:44-54``).

The iterations run eagerly on the pack's device; each one fetches its
convergence test to the host.  The small dense problems (Rayleigh–Ritz
``eigh``, ``qr``) are ``torch.linalg`` calls on the same device, as the
JAX package computes them outside any kernel.  Results come back as
numpy arrays.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Type

import numpy as np
import torch

from ..config import AMGConfig
from ..core.matrix import Matrix
from ..errors import (BadConfigurationError, NotImplementedError_,
                      SolveStatus)
from ..ops.spmv import spmv

_eigensolver_registry: Dict[str, Type["EigenSolver"]] = {}


def register_eigensolver(name: str):
    def deco(cls):
        _eigensolver_registry[name] = cls
        cls.config_name = name
        return cls
    return deco


class EigenSolverFactory:
    @staticmethod
    def allocate(cfg: AMGConfig, scope: str = "default") -> "EigenSolver":
        value, new_scope = cfg.get_scoped("eig_solver", scope)
        name = str(value)
        if name not in _eigensolver_registry:
            raise BadConfigurationError(
                f"unknown eigensolver {name!r}; known: "
                f"{sorted(_eigensolver_registry)}")
        return _eigensolver_registry[name](cfg, new_scope)

    @staticmethod
    def registered():
        return dict(_eigensolver_registry)


@dataclasses.dataclass
class EigenResult:
    eigenvalues: np.ndarray
    eigenvectors: Optional[np.ndarray]   # (n, k) or None
    iterations: int
    status: SolveStatus
    residuals: Optional[np.ndarray] = None
    solve_time: float = 0.0


class EigenSolver:
    """Base: setup/solve contract (``eigensolver.h:102-133``)."""

    config_name = "?"
    #: where the JAX package raises on a complex operator; the port
    #: refuses the same name at setup
    complex_refused: Optional[str] = None

    def __init__(self, cfg: AMGConfig, scope: str = "default"):
        self.cfg = cfg
        self.scope = scope
        g = lambda name: cfg.get(name, scope)
        self.max_iters = int(g("eig_max_iters"))
        self.tolerance = float(g("eig_tolerance"))
        self.shift = float(g("eig_shift"))
        self.which = str(g("eig_which"))
        self.wanted_count = int(g("eig_wanted_count"))
        self.damping = float(g("eig_damping_factor"))
        self.A: Optional[Matrix] = None
        self.Ad = None

    def setup(self, A):
        """Set up on a :class:`~..core.Matrix` (its device pack) or a
        device pack / operator."""
        self.A = A if isinstance(A, Matrix) else None
        self.Ad = A.device() if isinstance(A, Matrix) else A
        if self.Ad.dtype.is_complex and self.complex_refused is not None:
            raise NotImplementedError_(
                f"{self.config_name} on a complex operator: the reference "
                f"JAX package does not run it ({self.complex_refused})")
        self.solver_setup()
        return self

    def solver_setup(self):
        pass

    def pagerank_setup(self, ranks=None):
        """Reference AMGX_eigensolver_pagerank_setup."""
        return self

    def _op(self, x):
        """Shifted operator application (A − σI)x."""
        y = spmv(self.Ad, x)
        if self.shift != 0.0:
            y = y - self.shift * x
        return y

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.Ad.dtype,
                               device=self.Ad.device)

    def solve(self, x0=None) -> EigenResult:
        t0 = time.perf_counter()
        n = self.Ad.n
        if x0 is None:
            x0 = np.random.default_rng(0).standard_normal(n)
        x0 = self._to_device(x0.cpu().numpy() if torch.is_tensor(x0)
                             else x0)
        res = self._solve_impl(x0)
        res.solve_time = time.perf_counter() - t0
        return res

    def _solve_impl(self, x0) -> EigenResult:
        raise NotImplementedError

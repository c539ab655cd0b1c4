"""The real-matrix gauntlet: block-structured benchmark systems (a copy
of ``amgx_tpu/io/gauntlet.py``: numpy and scipy only).

The headline benchmarks are scalar Poisson — exactly the matrices the
structured DIA path eats.  AmgX's performance claims come from block
CSR on the workloads the paper targets (PAPER.md L4/L7): elasticity and
CFD systems with b = 3–5 coupled unknowns per mesh point, nonsymmetric
convection, anisotropy, and jumping coefficients.  This module builds
SuiteSparse-STYLE synthetic systems of each class — deterministic,
size-parameterised, and small enough to regenerate per run — and
``bench.py`` / ``scripts/prim_bench.py block`` route every one through
the MatrixMarket writer + the ``block_dim`` re-blocking reader
(io/matrix_market.py), so the measured operator took the full upload
path a user's matrix takes.

Every case records a solver config matched to its structure (SPD cases
ride PCG + aggregation AMG, nonsymmetric ones BiCGStab + multicolor
DILU — the BASELINE config-4 class), so bench's gauntlet block reports
a CONVERGENCE number (iterations) next to the throughput numbers
(achieved GB/s, GFLOP/s) for each block case, not just scalar Poisson.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import scipy.sparse as sp

from .poisson import poisson5pt, poisson7pt


def _conv_diff_2d(n: int, cx: float = 0.6, cy: float = 0.3
                  ) -> sp.csr_matrix:
    """2D convection–diffusion, first-order upwind convection: the
    standard nonsymmetric test operator (diagonally dominant, so the
    block couplings below cannot break solvability)."""
    L = poisson5pt(n, n)
    e = np.ones(n)
    d1 = sp.diags([e, -e], [0, -1], shape=(n, n))
    conv = (cx * sp.kron(sp.identity(n), d1)
            + cy * sp.kron(d1, sp.identity(n)))
    return sp.csr_matrix(L + conv)


def _aniso_2d(n: int, eps: float = 1e-2) -> sp.csr_matrix:
    """Anisotropic 2D Laplacian: strong x-coupling, eps-weak y."""
    Ix, Iy = sp.identity(n), sp.identity(n)
    d = sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, -1, 1])
    return sp.csr_matrix(sp.kron(Iy, d) + eps * sp.kron(d, Ix))


def _jump_2d(n: int, jump: float = 1e3) -> sp.csr_matrix:
    """2D diffusion with a coefficient jump: k = 1 except ``jump`` in
    the lower-left quadrant, assembled as Gᵀ·diag(k_edge)·G with
    harmonic-mean edge coefficients (SPD by construction) plus a small
    mass shift so quadrant-boundary rows stay nonsingular."""
    k = np.ones((n, n))
    k[: n // 2, : n // 2] = jump
    kf = k.ravel()

    def grad_1d(m):
        return sp.diags([-np.ones(m - 1), np.ones(m - 1)], [0, 1],
                        shape=(m - 1, m))

    Gx = sp.kron(sp.identity(n), grad_1d(n))   # x-edges
    Gy = sp.kron(grad_1d(n), sp.identity(n))   # y-edges
    idx = np.arange(n * n).reshape(n, n)
    ex = 2.0 / (1.0 / kf[idx[:, :-1].ravel()]
                + 1.0 / kf[idx[:, 1:].ravel()])
    ey = 2.0 / (1.0 / kf[idx[:-1, :].ravel()]
                + 1.0 / kf[idx[1:, :].ravel()])
    A = (Gx.T @ sp.diags(ex) @ Gx) + (Gy.T @ sp.diags(ey) @ Gy)
    return sp.csr_matrix(A + 1e-3 * sp.identity(n * n))


def scattered_block_operator(nb: int = 12288, b: int = 4,
                             density: float = 0.0008,
                             seed: int = 15) -> sp.bsr_matrix:
    """THE block SpMV A/B operator: a diagonally-shifted scattered
    b×b block matrix past every structured gate, shared by
    ``bench.py``'s ``block_kernels`` block and ``scripts/prim_bench.py
    block`` so the perf_gate-pinned ``block_spmv_speedup`` contract is
    measured on exactly the operator developers tune against."""
    rng = np.random.default_rng(seed)
    base = (sp.random(nb, nb, density=density, random_state=seed,
                      format="csr")
            + sp.diags(rng.uniform(3.0, 4.0, nb))).tocsr()
    data = rng.standard_normal((base.nnz, b, b))
    return sp.bsr_matrix((data, base.indices, base.indptr),
                         shape=(nb * b, nb * b))


def _spd_block(b: int, coupling: float = 0.3) -> np.ndarray:
    """A fixed SPD b×b stiffness block: I + coupling·(rank-one)."""
    v = np.linspace(1.0, 2.0, b)
    return np.eye(b) * (1.0 + np.arange(b) * 0.25) \
        + coupling * np.outer(v, v) / b


def _nonsym_block(b: int, g: float = 0.15) -> np.ndarray:
    """A fixed nonsymmetric b×b coupling block (velocity–pressure-ish
    off-diagonal skew), small enough to keep diagonal dominance."""
    B = np.zeros((b, b))
    B[:-1, -1] = g
    B[-1, :-1] = -g
    B[-1, -1] = 2 * g
    return B


def elasticity3(n_side: int = 12) -> Tuple[sp.bsr_matrix, int]:
    """b=3 elasticity-like system: 3D 7-pt Laplacian ⊗ SPD 3×3
    stiffness (the vector-Laplacian skeleton of linear elasticity on a
    structured mesh).  SPD."""
    L = poisson7pt(n_side, n_side, n_side)
    A = sp.kron(L, _spd_block(3), format="bsr")
    return sp.bsr_matrix(A, blocksize=(3, 3)), 3


def cfd4(n_side: int = 24) -> Tuple[sp.bsr_matrix, int]:
    """b=4 CFD-like system: nonsymmetric convection–diffusion ⊗ I₄
    plus a per-point nonsymmetric 4×4 coupling (3 velocity components
    + pressure)."""
    D = _conv_diff_2d(n_side)
    n = D.shape[0]
    A = sp.kron(D, sp.identity(4)) \
        + sp.kron(sp.identity(n), _nonsym_block(4))
    return sp.bsr_matrix(A, blocksize=(4, 4)), 4


def species5(n_side: int = 20) -> Tuple[sp.bsr_matrix, int]:
    """b=5 reaction–diffusion system: 2D Laplacian ⊗ diag diffusivities
    plus a nonsymmetric reaction coupling block per point."""
    L = poisson5pt(n_side, n_side)
    n = L.shape[0]
    diff = np.diag(np.linspace(1.0, 3.0, 5))
    R = _nonsym_block(5, g=0.2) + 0.1 * np.eye(5)
    A = sp.kron(L, diff) + sp.kron(sp.identity(n), R + R.T * 0.25)
    return sp.bsr_matrix(A, blocksize=(5, 5)), 5


def aniso3(n_side: int = 24, eps: float = 1e-2
           ) -> Tuple[sp.bsr_matrix, int]:
    """b=3 anisotropic vector system: eps-anisotropic 2D operator ⊗
    SPD 3×3 block.  SPD, and the anisotropy is exactly what smoother /
    coarsening quality regressions show up on."""
    A = sp.kron(_aniso_2d(n_side, eps), _spd_block(3, 0.2))
    return sp.bsr_matrix(A, blocksize=(3, 3)), 3


def jump2(n_side: int = 32, jump: float = 1e3
          ) -> Tuple[sp.bsr_matrix, int]:
    """b=2 coefficient-jump system: quadrant-jump diffusion ⊗ SPD 2×2
    block — the 6-orders-of-magnitude-coefficient class AmgX's strength
    thresholds exist for."""
    A = sp.kron(_jump_2d(n_side, jump), _spd_block(2, 0.25))
    return sp.bsr_matrix(A, blocksize=(2, 2)), 2


#: solver configs per structure class
_CFG_SPD = (
    "config_version=2, solver(out)=PCG, out:max_iters=400, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
    "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, amg:max_iters=1, "
    "amg:max_levels=10, amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=24, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
_CFG_NONSYM = (
    "config_version=2, solver(out)=PBICGSTAB, out:max_iters=400, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, "
    "out:preconditioner(pre)=MULTICOLOR_DILU, pre:max_iters=1")


@dataclasses.dataclass(frozen=True)
class GauntletCase:
    """One gauntlet entry: a builder returning (BSR matrix, b) plus the
    solver config its structure class calls for."""

    name: str
    build: Callable[[], Tuple[sp.bsr_matrix, int]]
    block_dim: int
    cfg: str
    symmetric: bool


def gauntlet_cases(scale: float = 1.0):
    """The gauntlet roster at a size scale (1.0 = bench defaults; tests
    use ~0.5 to stay fast).  Every case is a true b×b block system with
    b ∈ {2, 3, 4, 5}."""
    s = max(scale, 0.25)

    def sz(n):
        return max(int(n * s), 4)

    return [
        GauntletCase("elast3", lambda: elasticity3(sz(12)), 3,
                     _CFG_SPD, True),
        GauntletCase("cfd4", lambda: cfd4(sz(24)), 4, _CFG_NONSYM,
                     False),
        GauntletCase("species5", lambda: species5(sz(20)), 5,
                     _CFG_NONSYM, False),
        GauntletCase("aniso3", lambda: aniso3(sz(24)), 3, _CFG_SPD,
                     True),
        GauntletCase("jump2", lambda: jump2(sz(32)), 2, _CFG_SPD,
                     True),
    ]


def load_via_matrix_market(case: GauntletCase, tmpdir: str):
    """Round-trip one case through the extended MatrixMarket IO: write
    the assembled system SCALAR-wise, read it back with the explicit
    ``block_dim`` re-blocking — the exact upload path a user's .mtx
    takes (and the satellite's divisibility validation, exercised on
    every bench run)."""
    import os

    from .matrix_market import read_matrix_market, write_matrix_market
    A, b = case.build()
    path = os.path.join(tmpdir, f"gauntlet_{case.name}.mtx")
    write_matrix_market(path, sp.csr_matrix(A))
    sysd = read_matrix_market(path, block_dim=b)
    return sysd, path


#: the SPE Comparative Solution Project 10, model 2 reservoir grid
SPE10_GRID = (60, 220, 85)


def spe10_block_system(nx: int = 60, ny: int = 220, nz: int = 85,
                       seed: int = 0, inactive: float = 0.05
                       ) -> sp.bsr_matrix:
    """BASELINE config 4's 4×4 block system on a reservoir grid (SPE10
    model 2 by default: 60 × 220 × 85 cells): the 7-point Laplacian of the
    grid with a fraction ``inactive`` of its cells removed (drawn from
    ``default_rng(seed)``, as reservoir models deactivate cells),
    ⊗ I₄, plus the per-cell nonsymmetric 4×4 coupling of :func:`cfd4`.
    Returned as a BSR of 4×4 blocks (upload with ``block_dim=4``)."""
    L = poisson7pt(nx, ny, nz)
    keep = np.random.default_rng(seed).random(L.shape[0]) >= inactive
    Lk = sp.csr_matrix(L[keep][:, keep])
    n = Lk.shape[0]
    A = sp.kron(Lk, sp.identity(4), format="bsr") \
        + sp.kron(sp.identity(n), _nonsym_block(4), format="bsr")
    return sp.bsr_matrix(A, blocksize=(4, 4))

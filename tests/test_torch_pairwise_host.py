"""The host structured/pairwise step of a GEO hierarchy and the GEO
selector's attached coordinates, on the CPU against the JAX package,
f64:

* ``structured_galerkin`` and ``pairwise_galerkin_dia`` equal to the JAX
  package's on the grids of tests/test_structured.py:40, and the
  structured product equal to the explicit piecewise-constant PᵀAP;
* a DIA operator whose pairwise coarsening would exceed the device
  plan's 48-diagonal budget: the host loop coarsens it pairwise on the
  host (then SIZE_2 past the DIA budget, then pairwise again), levels
  and count equal to the JAX package's; then a structure-reuse resetup
  with drifted values, which refreshes the host-derived levels (A6),
  counts equal to the JAX package's resetup;
* a GEO setup of a permuted 7-point grid with attached coordinates
  (``Matrix.geometry``; tests/test_amg.py:323): every level's aggregates
  equal to the JAX package's with the same ``.geometry``, the coarse
  levels aggregating by the centroids."""
import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu
from amgx_tpu.amg import pairwise as jpw
from amgx_tpu.amg import structured as jst
from amgx_tpu.io import poisson5pt, poisson7pt

import amgx_tpu_torch as amgx
from amgx_tpu_torch.amg import pairwise as ppw
from amgx_tpu_torch.amg import structured as pst
from amgx_tpu_torch.core.matrix import dia_arrays
from amgx_tpu_torch.errors import SolveStatus

#: f64 solutions of the two packages
X_RTOL = 1e-10

GEO = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:gmres_n_restart=10, "
       "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
       "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
       "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
       "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=16, "
       "amg:coarse_solver=DENSE_LU_SOLVER")


def _grid_operator(dims, seed=0):
    nz, ny, nx = dims
    if nz == 1 and ny == 1:
        A = sp.diags([np.full(nx - 1, -1.0), np.full(nx, 2.0),
                      np.full(nx - 1, -1.0)], [-1, 0, 1]).tocsr()
    elif nz == 1:
        A = poisson5pt(nx, ny)
    else:
        A = poisson7pt(nx, ny, nz)
    A = sp.csr_matrix(A)
    rng = np.random.default_rng(seed)
    A.data = A.data * (1.0 + 0.3 * rng.standard_normal(len(A.data)))
    return A


@pytest.mark.parametrize("dims", [(6, 6, 6), (5, 6, 7), (1, 8, 8),
                                  (2, 6, 6), (1, 1, 16), (4, 4, 4)])
def test_host_galerkin_steps_match_jax(dims):
    A = _grid_operator(dims)
    offs, vals = dia_arrays(A)
    offs3 = pst.decompose_offsets(offs, dims)
    assert offs3 == jst.decompose_offsets(offs, dims)
    got = pst.structured_galerkin(offs3, vals, dims)
    want = jst.structured_galerkin(offs3, vals, dims)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    # against the explicit piecewise-constant product
    nz, ny, nx = dims
    cz, cy, cx = pst.coarse_dims(dims)
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    agg = (((z // 2 if nz > 1 else z) * cy + (y // 2 if ny > 1 else y))
           * cx + (x // 2 if nx > 1 else x)).reshape(-1)
    P = sp.csr_matrix((np.ones(A.shape[0]), (np.arange(A.shape[0]), agg)),
                      shape=(A.shape[0], cz * cy * cx))
    ref = sp.csr_matrix(P.T @ A @ P)
    assert abs(ppw.dia_to_scipy(got[0], got[1], cz * cy * cx)
               - ref).max() < 1e-12
    pg = ppw.pairwise_galerkin_dia(offs, vals)
    pj = jpw.pairwise_galerkin_dia(offs, vals)
    assert list(pg[0]) == list(pj[0])
    np.testing.assert_array_equal(pg[1], pj[1])


def wide_dia(n=6000, seed=0):
    """An SPD operator of 45 diagonals whose odd, spread offsets split
    in two under pairing: its pairwise coarse operator has more than 48
    diagonals, so the device plan stops at the fine level."""
    rng = np.random.default_rng(seed)
    M = sp.csr_matrix((n, n))
    for o in [1] + [(7 * k + 3) * 2 + 1 for k in range(1, 23)]:
        M = M + sp.diags([rng.uniform(0.5, 1.0, n - o)], [o],
                         shape=(n, n))
    M = M + M.T
    d = np.asarray(abs(M).sum(axis=1)).ravel() + 1.0
    A = sp.csr_matrix(sp.diags(d) - M)
    A.sort_indices()
    return A


def _solve_both(ref, slv, n):
    b = np.ones(n)
    want, got = ref.solve(b), slv.solve(b)
    assert got.status == SolveStatus.SUCCESS
    assert got.iterations == want.iterations
    w = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), w, rtol=X_RTOL,
                               atol=X_RTOL * np.abs(w).max())


def _kinds(h):
    return [s[0] for s in h._structure]


def test_dia_level_past_the_plan_and_its_resetup():
    A = wide_dia()
    cfg = GEO + ", amg:structure_reuse_levels=-1"
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    jm = amgx_tpu.Matrix(A)
    ref.setup(jm)
    slv = amgx.create_solver(cfg)
    pm = amgx.Matrix(A, device="cpu")
    slv.setup(pm)
    hj = ref.preconditioner.hierarchy
    hp = slv.preconditioner.hierarchy
    kinds = _kinds(hp)
    assert kinds == _kinds(hj)
    assert kinds[0] == "pairwise" and "aggregation" in kinds
    assert hp.level_sizes() == hj.level_sizes()
    assert len(hp.levels[1].A.dia_cache()[0]) > 48
    _solve_both(ref, slv, A.shape[0])
    u = np.random.default_rng(3).uniform(size=A.shape[0])
    for k in (1, 2):
        d = sp.diags(1.0 + 0.1 * u * k)
        Ak = sp.csr_matrix(d @ A @ d)
        Ak.sort_indices()
        jm.replace_coefficients(Ak.data)
        pm.replace_coefficients(Ak.data)
        ref.resetup(jm)
        slv.resetup(pm)
        assert slv.preconditioner.hierarchy is hp
        assert hp.last_resetup == "host_replay"
        assert _kinds(hp) == kinds
        for lp, lj in zip(hp.levels[1:], hj.levels[1:]):
            np.testing.assert_allclose(lp.A.host.toarray(),
                                       lj.A.host.toarray(), rtol=0,
                                       atol=1e-12 * abs(Ak).max())
        _solve_both(ref, slv, A.shape[0])


def test_geo_reads_attached_coordinates():
    nx = 16
    A = sp.csr_matrix(poisson7pt(nx, nx, nx))
    perm = np.random.default_rng(2).permutation(A.shape[0])
    Ap = sp.csr_matrix(A[perm][:, perm])
    Ap.sort_indices()
    z, y, x = np.unravel_index(perm, (nx, nx, nx))
    geom = tuple(c.astype(np.float64) for c in (x, y, z))
    cfg = GEO.replace("solver(out)=FGMRES", "solver(out)=PCG") \
        + ", determinism_flag=1"
    jm = amgx_tpu.Matrix(Ap)
    jm.geometry = geom
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    ref.setup(jm)
    pm = amgx.Matrix(Ap, device="cpu")
    pm.geometry = geom
    slv = amgx.create_solver(cfg)
    slv.setup(pm)
    hj = ref.preconditioner.hierarchy
    hp = slv.preconditioner.hierarchy
    assert _kinds(hp) == _kinds(hj)
    assert _kinds(hp)[0] == "aggregation"
    agg0 = hp.levels[0].aggregates.numpy()
    # geometric cells of ~8 points, not the SIZE_2 pairs
    assert np.bincount(agg0).mean() > 6
    for lp, lj in zip(hp.levels, hj.levels):
        if lp.kind == "aggregation":
            np.testing.assert_array_equal(lp.aggregates.numpy(),
                                          np.asarray(lj.aggregates))
    c1 = hp.levels[1].A.geometry
    assert c1 is not None and len(c1[0]) == hp.levels[1].A.n_block_rows
    _solve_both(ref, slv, A.shape[0])

"""Aggregation AMG on b×b block systems (the gauntlet's SPD config: PCG +
SIZE_2 aggregation + BLOCK_JACOBI 2+2 + DENSE_LU) on the CPU against
the JAX package, f64, on the SPD gauntlet cases ``elast3`` (b = 3),
``aniso3`` (b = 3) and ``jump2`` (b = 2) of ``io/gauntlet.py``:

* the aggregates of every level bit-equal (the selector reads the
  Frobenius-condensed graph of the blocks);
* every level's coarse BSR within 1e-12 (relative) and on the same
  block pattern, through the host generator (levels below
  ``device_setup_min_rows``) and through the device setup engine
  (``device_setup_min_rows=0``, both packages);
* the iteration count equal and x within 1e-10;
* the values-only resetup of a block hierarchy (``structure_reuse_levels``;
  the frozen aggregates replayed through the engine's cached block plan)
  on ``jump2`` with drifted values: counts equal to the JAX package's
  resetup."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu

import amgx_tpu_torch as amgx
from amgx_tpu_torch.amg.device_setup import engine_stats, reset_engine
from amgx_tpu_torch.amg.level import AggregationLevel
from amgx_tpu_torch.errors import SolveStatus
from amgx_tpu_torch.io.gauntlet import _CFG_SPD, aniso3, elasticity3, jump2

#: f64 coarse operators (the same sums in another order)
RTOL = 1e-12
#: f64 solutions of the two packages
X_RTOL = 1e-10

CASES = {"elast3": lambda: elasticity3(8), "aniso3": lambda: aniso3(16),
         "jump2": lambda: jump2(24)}


@pytest.fixture(autouse=True)
def fresh_engine():
    reset_engine()
    yield
    reset_engine()


def _pair(A, b, cfg):
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    ref.setup(amgx_tpu.Matrix(A, block_dim=b))
    slv = amgx.create_solver(cfg)
    m = amgx.Matrix(A, block_dim=b, device="cpu")
    slv.setup(m)
    return ref, slv, m


def _rel(X, Y):
    X, Y = sp.csr_matrix(X), sp.csr_matrix(Y)
    return abs(X - Y).max() / max(abs(Y).max(), 1e-300)


def _solve_both(ref, slv, n):
    rhs = np.ones(n)
    want, got = ref.solve(rhs), slv.solve(rhs)
    assert got.status == SolveStatus.SUCCESS
    assert got.iterations == want.iterations
    w = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), w, rtol=X_RTOL,
                               atol=X_RTOL * np.abs(w).max())
    return got


def _compare_levels(hj, hp, b):
    assert len(hp.levels) == len(hj.levels) >= 2
    for lp, lj in zip(hp.levels, hj.levels):
        assert isinstance(lp, AggregationLevel) and lp.block_dim == b
        np.testing.assert_array_equal(lp.aggregates.numpy(),
                                      np.asarray(lj.aggregates))
    for lp, lj in zip(hp.levels[1:] + [None], hj.levels[1:] + [None]):
        mp = lp.A if lp is not None else hp.coarsest
        mj = lj.A if lj is not None else hj.coarsest
        assert mp.block_dim == b
        bp = sp.bsr_matrix(mp.host, blocksize=(b, b))
        bj = sp.bsr_matrix(mj.host, blocksize=(b, b))
        np.testing.assert_array_equal(bp.indptr, bj.indptr)
        np.testing.assert_array_equal(bp.indices, bj.indices)
        assert _rel(mp.host, mj.host) <= RTOL


@pytest.mark.parametrize("engine_rows", ["default", "all"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_block_aggregation_matches_jax(case, engine_rows):
    A, b = CASES[case]()
    cfg = _CFG_SPD + (", device_setup_min_rows=0"
                      if engine_rows == "all" else "")
    ref, slv, _ = _pair(A, b, cfg)
    hp = slv.preconditioner.hierarchy
    _compare_levels(ref.preconditioner.hierarchy, hp, b)
    st = engine_stats()
    if engine_rows == "all":
        assert st["numeric_runs"] == len(hp.levels)
        assert st["declines"] == {}
    else:
        assert st["numeric_runs"] == 0
        assert st["declines"] == {"small": len(hp.levels)}
    _solve_both(ref, slv, A.shape[0])


def _drift(A, b, k, seed=3):
    """A_k = D_k·A·D_k with D_k = diag(1 + 0.1·u·k) over the scalar
    unknowns (values only: the block pattern stays)."""
    u = np.random.default_rng(seed).uniform(size=A.shape[0])
    d = sp.diags(1.0 + 0.1 * u * k)
    out = sp.bsr_matrix(d @ sp.csr_matrix(A) @ d, blocksize=(b, b))
    out.sort_indices()
    return out


@pytest.mark.parametrize("engine_rows", ["default", "all"])
def test_block_resetup_matches_jax(engine_rows):
    """A5: two drifts of ``jump2`` through a values-only resetup of the
    block hierarchy, the frozen aggregates replayed (``host_replay``);
    with the engine on every level a resetup adds no symbolic pass."""
    A, b = CASES["jump2"]()
    A = sp.bsr_matrix(A, blocksize=(b, b))
    A.sort_indices()
    cfg = _CFG_SPD + ", amg:structure_reuse_levels=-1" + (
        ", device_setup_min_rows=0" if engine_rows == "all" else "")
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    jm = amgx_tpu.Matrix(A, block_dim=b)
    ref.setup(jm)
    slv = amgx.create_solver(cfg)
    pm = amgx.Matrix(A, block_dim=b, device="cpu")
    slv.setup(pm)
    hp = slv.preconditioner.hierarchy
    aggs = [lvl.aggregates.clone() for lvl in hp.levels]
    builds = engine_stats()["builds"]
    for k in (1, 2):
        Ak = _drift(A, b, k)
        jm.replace_coefficients(Ak.data)
        pm.replace_coefficients(Ak.data)
        ref.resetup(jm)
        slv.resetup(pm)
        assert slv.preconditioner.hierarchy is hp
        assert hp.last_resetup == "host_replay"
        for lvl, agg in zip(hp.levels, aggs):
            assert torch.equal(lvl.aggregates, agg)
        _compare_levels(ref.preconditioner.hierarchy, hp, b)
        _solve_both(ref, slv, A.shape[0])
    assert engine_stats()["builds"] == builds


def test_block_transfers_are_ordered_sums():
    """Restriction of a block level adds each aggregate's block rows in
    increasing fine index (the JAX package's segment sum), prolongation
    copies the coarse block back: checked against a dense Sᵀ / S."""
    A, b = jump2(8)
    m = amgx.Matrix(A, block_dim=b, device="cpu")
    n = A.shape[0] // b
    agg = np.random.default_rng(0).integers(0, 7, size=n)
    agg = np.unique(agg, return_inverse=True)[1]
    nc = int(agg.max()) + 1
    lvl = AggregationLevel(m, 0, agg, nc)
    S = np.kron(np.eye(nc)[agg], np.eye(b))
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(n * b))
    np.testing.assert_allclose(lvl.restrict_residual(r).numpy(),
                               S.T @ r.numpy(), rtol=1e-14)
    e = torch.from_numpy(np.random.default_rng(2).standard_normal(nc * b))
    x = torch.zeros(n * b, dtype=torch.float64)
    np.testing.assert_array_equal(
        lvl.prolongate_and_correct(x, e).numpy(), S @ e.numpy())

"""Complex and bf16 sharded packs against the JAX package on the CPU
(ROADMAP item 7c): the JAX package on conftest's 8 virtual devices, the
port on ``make_mesh(8, device="cpu")``.

* Complex sharded solves (the 8³ Helmholtz in 8 shards): FGMRES +
  per-rank SIZE_2 aggregation with the sharded smoothers — the JAX
  package's count and residual history (``HIST_RTOL`` 1e-8 plus
  ``HIST_ATOL``·‖r₀‖, ``tests/torch_complex_parity.py``).  The interior
  applies on the plain path (``sharded/gather``; B3 refuses complex).
* A complex 2×2 block system in 8 block-row shards under BLOCK_JACOBI
  and MULTICOLOR_GS: the count and history of the JAX package's
  single-device solve, which the port's sharded solve also gives.  The
  JAX package's sharded b×b pack inverts its diagonal blocks entry by
  entry (``amgx_tpu/solvers/jacobi.py:84-86``), so its own sharded solve
  is not the oracle (ROADMAP C, "Not faults").
* bf16 sharded SpMV, b = 1 and b = 2 (``Matrix.device(dtype=
  torch.bfloat16)`` on a distributed matrix): y agrees with the JAX
  package's within bf16 rounding — 1e-2 of ‖y‖, the JAX package
  accumulating its block interior in bf16 — and is bit-equal to the
  same SpMV of the pack's values widened to f32 (the bf16 rule: an f32
  x, f32 sums, one rounding at the end)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
from amgx_tpu.distributed import agglomerate as jagg
from amgx_tpu.distributed import matrix as jdm
from amgx_tpu.ops.spmv import spmv as jspmv

import amgx_tpu_torch as amgx
from amgx_tpu_torch.distributed import agglomerate as tagg
from amgx_tpu_torch.distributed import matrix as tdm
from amgx_tpu_torch.io import poisson7pt
from amgx_tpu_torch.ops import spmv as smod

from torch_complex_parity import (amg_cfg, assert_same, block_system, crhs,
                                  krylov_cfg, operator, relres, solve_jax,
                                  solve_port)


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((8,), ("p",))


@pytest.fixture(scope="module")
def tmesh():
    return tdm.make_mesh(8, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_plans():
    jagg.reset_plans()
    tagg.reset_plans()
    smod.reset_dispatch()
    yield


#: the smoothers of the per-rank aggregation AMG on the shards
SHARDED_SMOOTHERS = ("BLOCK_JACOBI", "JACOBI_L1", "MULTICOLOR_GS",
                     "MULTICOLOR_DILU")


@pytest.mark.parametrize("sm", SHARDED_SMOOTHERS)
def test_complex_sharded_aggregation_matches_jax(sm, jmesh, tmesh):
    A, b = operator("Z")
    cfg = amg_cfg(sm=sm)
    rj = solve_jax(cfg, A, b, mesh=jmesh)
    rp, s = solve_port(cfg, A, b, mesh=tmesh)
    assert s.Ad.fmt == "sharded-ell" and s.Ad.dtype == torch.complex128
    assert_same(rj, rp)
    assert rp.status == 0 and relres(A, rp.x, b) < 1e-7
    # the complex interior took the plain path, counted as such
    assert smod.DISPATCH["sharded/gather"] > 0
    assert smod.DISPATCH["sharded/window"] == 0


def test_complex_sharded_kaczmarz_matches_jax(jmesh, tmesh):
    """KACZMARZ on the shards (its masks and the true transpose pack),
    one sweep as FGMRES's preconditioner, the first 30 iterations."""
    A, b = operator("Z")
    cfg = krylov_cfg("FGMRES", pre="KACZMARZ", it=30)
    rj = solve_jax(cfg, A, b, mesh=jmesh)
    rp, s = solve_port(cfg, A, b, mesh=tmesh)
    assert s.Ad.dtype == torch.complex128
    assert_same(rj, rp)


@pytest.mark.parametrize("pre", ["BLOCK_JACOBI", "MULTICOLOR_GS"])
def test_complex_block_sharded_matches_single_device(pre, jmesh, tmesh):
    A = block_system()
    b = crhs(A.shape[0], 4)
    cfg = krylov_cfg("FGMRES", pre=pre)
    rj = solve_jax(cfg, A, b, block_dim=2)
    rp, s = solve_port(cfg, A, b, block_dim=2, mesh=tmesh)
    assert s.Ad.fmt == "sharded-ell" and s.Ad.block_dim == 2
    assert s.Ad.interior is None
    assert smod.DISPATCH["sharded/block-plain"] > 0
    assert_same(rj, rp)
    rs, _ = solve_port(cfg, A, b, block_dim=2)
    assert rs.iterations == rp.iterations
    if pre == "BLOCK_JACOBI":
        # why the JAX package's sharded solve is not the oracle: its
        # sharded D⁻¹ is the entrywise reciprocal of each diagonal block
        mj = jx.Matrix(A, block_dim=2)
        mj.set_distribution(jmesh)
        sj = jx.create_solver(jx.AMGConfig(cfg))
        sj.setup(mj)
        d = np.asarray(mj.device().diag)
        np.testing.assert_allclose(np.asarray(sj.preconditioner.dinv),
                                   np.where(d != 0, 1 / np.where(
                                       d == 0, 1, d), 0), rtol=1e-15)


def _spmv_both(M, bd, jmesh, tmesh):
    x = np.random.default_rng(1).standard_normal(M.shape[0])
    mj = jx.Matrix(M, block_dim=bd)
    mj.set_distribution(jmesh)
    Dj = mj.device(dtype=jnp.bfloat16)
    yj = np.asarray(jdm.unshard_vector(
        Dj, jspmv(Dj, jdm.shard_vector(Dj, x)))).astype(np.float64)
    mp = amgx.Matrix(M, block_dim=bd, device="cpu")
    mp.set_distribution(tmesh)
    Dp = mp.device(dtype=torch.bfloat16)
    xs = tdm.shard_vector(Dp, x)
    return Dp, xs, yj


@pytest.mark.parametrize("bd", [1, 2])
def test_bf16_sharded_spmv(bd, jmesh, tmesh):
    A = sp.csr_matrix(poisson7pt(8, 8, 8))
    M = A if bd == 1 else sp.bsr_matrix(
        sp.kron(A, np.array([[2.0, -0.3], [0.2, 1.5]])).tocsr(),
        blocksize=(2, 2))
    Dp, xs, yj = _spmv_both(M, bd, jmesh, tmesh)
    assert Dp.dtype == torch.bfloat16 and xs.dtype == torch.bfloat16
    y = smod.spmv(Dp, xs)
    assert y.dtype == torch.bfloat16
    label = "sharded/gather" if bd == 1 else "sharded/block-plain"
    assert smod.DISPATCH[label] == 1
    yp = tdm.unshard_vector(Dp, y).double().numpy()
    assert np.linalg.norm(yp - yj) <= 1e-2 * np.linalg.norm(yj)
    yx = M @ tdm.unshard_vector(Dp, xs).double().numpy()
    assert np.linalg.norm(yp - yx) <= 1e-2 * np.linalg.norm(yx)
    # the bf16 rule: the f32 SpMV of the same (widened) values, rounded
    # once
    wide = smod.spmv(Dp.astype(torch.float32), xs.float())
    assert torch.equal(y, wide.to(torch.bfloat16))

"""Setup parity with the JAX package: the on-device 7-point generator,
the static DIA coarsening plan, and every derived level's values,
diagonal and inverted diagonal."""
import dataclasses
import itertools

import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu
from amgx_tpu.amg import dia_device as jdd
from amgx_tpu.io import poisson7pt_device as jax_poisson7pt_device

import amgx_tpu_torch
from amgx_tpu_torch.amg import dia_device as tdd
from amgx_tpu_torch.io import poisson7pt_device

#: coarse levels are sums of fine values in another order than the JAX
#: convolution; f32 rounding of those sums is the only difference
RTOL = 1e-6

CFG = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
       "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
       "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
       "amg:cycle=CG, amg:cycle_iters=2, "
       "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
       "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
       "amg:coarse_solver=DENSE_LU_SOLVER")


@pytest.mark.parametrize("dims", [(16, 16, 16), (12, 10, 9), (5, 1, 3),
                                  (1, 7, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_poisson7pt_device_planes_bit_equal(dims, dtype):
    ref = jax_poisson7pt_device(*dims, device_dtype=dtype)
    got = poisson7pt_device(*dims, device_dtype=dtype, device="cpu")
    rd, gd = ref.device(), got.device()
    assert tuple(gd.dia_offsets) == tuple(rd.dia_offsets)
    assert gd.vals.numpy().dtype == np.dtype(dtype)
    assert np.array_equal(gd.vals.numpy(), np.asarray(rd.vals))
    assert np.array_equal(gd.diag.numpy(), np.asarray(rd.diag))
    ro, rv = ref.dia_cache()
    go, gv = got.dia_cache()
    assert list(go) == list(ro) and np.array_equal(gv, rv)
    assert got.grid_dims == ref.grid_dims


def _steps(steps):
    return [(s.kind, dataclasses.asdict(s)) for s in steps]


def _offsets27(n):
    return sorted({(dz * n + dy) * n + dx for dz, dy, dx in
                   itertools.product((-1, 0, 1), repeat=3)})


@pytest.mark.parametrize("offsets,n,dims,max_levels", [
    ((-256, -16, -1, 0, 1, 16, 256), 4096, (16, 16, 16), 20),
    ((-90, -9, -1, 0, 1, 9, 90), 1080, (12, 10, 9), 20),
    ((-3, -1, 0, 1, 3), 15, (5, 1, 3), 20),
    ((-16, -1, 0, 1, 16), 256, (1, 16, 16), 20),
    (tuple(_offsets27(8)), 512, (8, 8, 8), 20),
    ((-256, -16, -1, 0, 1, 16, 256), 4096, (16, 16, 16), 3),
    ((-3, 0, 3), 300, None, 20),
])
def test_plan_steps_identical(offsets, n, dims, max_levels):
    ref = jdd.plan_dia_hierarchy(offsets, n, dims, max_levels, 32, 1.0)
    got = tdd.plan_dia_hierarchy(offsets, n, dims, max_levels, 32, 1.0)
    assert got[1] == ref[1]
    assert _steps(got[0]) == _steps(ref[0])


def _close(got, want):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=0)


def _compare_hierarchies(h_ref, h_got):
    assert len(h_got.levels) == len(h_ref.levels)
    for lr, lg in zip(h_ref.levels, h_got.levels):
        assert lg.kind == lr.kind
        if lr.kind == "structured":
            assert (lg.dims, lg.cdims) == (lr.dims, lr.cdims)
        else:
            assert lg.n_fine == lr.n_fine
        rd, gd = lr.A.device(), lg.Ad
        assert tuple(gd.dia_offsets) == tuple(rd.dia_offsets)
        _close(gd.vals, rd.vals)
        _close(gd.diag, rd.diag)
        _close(lg.smoother.dinv, lr.smoother.dinv)
    rc, gc = h_ref.coarsest.device(), h_got.coarsest.device()
    assert tuple(gc.dia_offsets) == tuple(rc.dia_offsets)
    _close(gc.vals, rc.vals)


def _setup_both(jax_matrix, torch_matrix):
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(CFG))
    ref.setup(jax_matrix)
    got = amgx_tpu_torch.create_solver(CFG)
    got.setup(torch_matrix)
    return ref.preconditioner.hierarchy, got.preconditioner.hierarchy


@pytest.mark.parametrize("dims,n_levels", [((16, 16, 16), 3),
                                           ((32, 32, 32), 4),
                                           ((12, 10, 9), 2)])
def test_structured_levels_match(dims, n_levels):
    h_ref, h_got = _setup_both(
        jax_poisson7pt_device(*dims, device_dtype=np.float32),
        poisson7pt_device(*dims, device_dtype=np.float32, device="cpu"))
    assert len(h_got.levels) == n_levels
    _compare_hierarchies(h_ref, h_got)


def test_pairwise_levels_match():
    # offsets (-3, 0, 3) infer no grid: the plan pairs rows {2I, 2I+1}
    n = 300
    rng = np.random.default_rng(5)
    A = sp.diags([-1.0 - rng.random(n - 3), 4.0 + rng.random(n),
                  -1.0 - rng.random(n - 3)], [-3, 0, 3],
                 shape=(n, n), format="csr")
    h_ref, h_got = _setup_both(amgx_tpu.Matrix(A),
                               amgx_tpu_torch.Matrix(A, device="cpu"))
    assert [lv.kind for lv in h_got.levels] == ["pairwise"] * 4
    _compare_hierarchies(h_ref, h_got)

"""End-to-end parity of the headline stack (FGMRES restart 6 +
GEO-aggregation AMG, K-cycle, block Jacobi 2+2, dense LU) between the
port on the CPU and the JAX package: iteration counts, residual
histories, true residuals, and one preconditioner application on a
hierarchy carried across with ``interop``."""
import numpy as np
import pytest
import torch

import amgx_tpu
from amgx_tpu.io import poisson7pt as jax_poisson7pt
from amgx_tpu.io import poisson7pt_device as jax_poisson7pt_device

import amgx_tpu_torch
from amgx_tpu_torch import interop
from amgx_tpu_torch.errors import SolveStatus
from amgx_tpu_torch.io import poisson7pt, poisson7pt_device
from amgx_tpu_torch.ops.spmv import DISPATCH

#: f64 residual histories: the same arithmetic in another summation
#: order (BLAS dots, Gram–Schmidt products) — rounding at 1e-16 grows
#: through the AMG cycles to far below this
HIST_RTOL = 1e-6
#: one AMG cycle in f64 on identical hierarchy arrays
APPLY_RTOL = 1e-10

CFG = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
       "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
       "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
       "amg:cycle=CG, amg:cycle_iters=2, "
       "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
       "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
       "amg:coarse_solver=DENSE_LU_SOLVER, out:store_res_history=1")


def _true_relres(dims, x):
    A = jax_poisson7pt(*dims)
    b = np.ones(A.shape[0])
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return np.linalg.norm(b - A @ x.astype(np.float64)) / np.linalg.norm(b)


@pytest.mark.parametrize("dims,dtype,iters", [
    ((16, 16, 16), np.float64, 11),
    ((32, 32, 32), np.float64, 12),
    ((16, 16, 16), np.float32, 14),      # f32 pack + f64 refinement
    ((32, 32, 32), np.float32, 16),
    ((12, 10, 9), np.float64, 9),
])
def test_headline_matches_jax(dims, dtype, iters):
    n = int(np.prod(dims))
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(CFG))
    ref.setup(jax_poisson7pt_device(*dims, device_dtype=dtype))
    r_ref = ref.solve(np.ones(n))
    slv = amgx_tpu_torch.create_solver(CFG)
    slv.setup(poisson7pt_device(*dims, device_dtype=dtype, device="cpu"))
    before = DISPATCH["dia/slices"]
    r = slv.solve(np.ones(n))
    assert DISPATCH["dia/slices"] > before and DISPATCH["dia/kernel"] == 0
    assert r_ref.iterations == iters
    assert r.iterations == r_ref.iterations
    assert r.status == SolveStatus.SUCCESS
    assert _true_relres(dims, r.x) <= 1e-8
    if dtype == np.float64:
        np.testing.assert_allclose(r.residual_history,
                                   np.asarray(r_ref.residual_history),
                                   rtol=HIST_RTOL)
        np.testing.assert_allclose(r.residual_norm,
                                   np.asarray(r_ref.residual_norm),
                                   rtol=HIST_RTOL)


@pytest.mark.parametrize("dtype,iters", [(np.float64, 11),
                                         (np.float32, 14)])
def test_host_matrix_path_matches(dtype, iters):
    """Matrix(poisson7pt(n)) takes the host-arrays route through the same
    plan and derive, in both packages."""
    jm = amgx_tpu.Matrix(jax_poisson7pt(16, 16, 16))
    jm.device_dtype = dtype
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(CFG))
    ref.setup(jm)
    r_ref = ref.solve(np.ones(16 ** 3))
    m = amgx_tpu_torch.Matrix(poisson7pt(16, 16, 16), device="cpu")
    m.device_dtype = dtype
    slv = amgx_tpu_torch.create_solver(CFG)
    slv.setup(m)
    r = slv.solve(np.ones(16 ** 3))
    assert r.iterations == r_ref.iterations == iters
    assert _true_relres((16, 16, 16), r.x) <= 1e-8
    if dtype == np.float64:
        np.testing.assert_allclose(r.residual_history,
                                   np.asarray(r_ref.residual_history),
                                   rtol=HIST_RTOL)


def _level_arrays(h):
    levels = []
    for lv in h.levels:
        Ad = lv.A.device()
        d = dict(kind=lv.kind, offsets=list(Ad.dia_offsets),
                 vals=np.asarray(Ad.vals), diag=np.asarray(Ad.diag),
                 dinv=np.asarray(lv.smoother.dinv))
        if lv.kind == "structured":
            d.update(dims=lv.dims, cdims=lv.cdims)
        else:
            d.update(n=lv.n_fine)
        levels.append(d)
    c = h.coarsest.device()
    return levels, dict(offsets=list(c.dia_offsets), vals=np.asarray(c.vals))


@pytest.mark.parametrize("cycle", ["CG", "V", "W", "F", "CGF"])
def test_preconditioner_apply_on_carried_hierarchy(cycle):
    """One AMG application of every cycle flavour on the JAX package's
    hierarchy arrays, carried across with ``interop``."""
    import jax.numpy as jnp
    dims = (16, 16, 16)
    text = CFG.replace("amg:cycle=CG", f"amg:cycle={cycle}")
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(text))
    ref.setup(jax_poisson7pt_device(*dims, device_dtype=np.float64))
    levels, coarsest = _level_arrays(ref.preconditioner.hierarchy)
    cfg = amgx_tpu_torch.AMGConfig(text)
    h = interop.hierarchy_from_numpy(cfg, "amg", levels, coarsest,
                                     device="cpu")
    amg = amgx_tpu_torch.SolverFactory.create("AMG", cfg, "amg")
    amg.hierarchy = h
    from amgx_tpu_torch.amg.cycles import build_cycle
    amg._cycle = build_cycle(h)
    b = np.random.default_rng(7).standard_normal(int(np.prod(dims)))
    want = np.asarray(ref.preconditioner.apply(jnp.asarray(b)))
    got = amg.apply(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=APPLY_RTOL,
                               atol=APPLY_RTOL * np.max(np.abs(want)))


def test_interop_matrix_solves():
    offs, vals = amgx_tpu_torch.io.poisson7pt_dia(12, 10, 9)
    m = interop.matrix_from_numpy(offs, vals, grid_dims=(9, 10, 12),
                                  device_dtype=np.float32, device="cpu")
    slv = amgx_tpu_torch.create_solver(CFG)
    slv.setup(m)
    r = slv.solve(np.ones(1080))
    assert r.status == SolveStatus.SUCCESS
    assert _true_relres((12, 10, 9), r.x) <= 1e-8


@pytest.mark.parametrize("cfg", [
    CFG + ", out:krylov_comm=CA",
    CFG + ", telemetry=1",
    CFG + ", out:scaling=DIAGONAL_SYMMETRIC",
    CFG + ", amg:structure_reuse_levels=1",
    CFG.replace("amg:algorithm=AGGREGATION", "amg:algorithm=CLASSICAL"),
    CFG.replace("solver(out)=FGMRES", "solver(out)=PCG"),
])
def test_later_slice_features_raise(cfg):
    """Features of later slices raise instead of silently taking another
    path."""
    with pytest.raises(NotImplementedError):
        slv = amgx_tpu_torch.create_solver(cfg)
        slv.setup(poisson7pt_device(8, 8, 8, device_dtype=np.float64,
                                    device="cpu"))


def test_operator_past_dia_budget_raises():
    import scipy.sparse as sp
    A = sp.random(200, 200, density=0.3, random_state=1, format="csr") \
        + sp.identity(200)
    m = amgx_tpu_torch.Matrix(A, device="cpu")
    with pytest.raises(NotImplementedError):
        m.device()

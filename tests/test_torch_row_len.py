"""Kernel B3's ``row_len`` (``DeviceMatrix.row_len``, one past each row's
last nonzero slot, where the kernel stops the row): every scalar ELL
pack carries it, from every producer — the host upload, the classical
device pipeline's coarse levels and P/R, the aggregation hierarchy's
coarse levels and the refinement's wide pack — and every slot at or past
it holds the value 0.  No JAX here."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu_torch as amgx
from amgx_tpu_torch.core.matrix import ell_device_matrix, pack_device
from amgx_tpu_torch.io import dfg_cylinder_pressure, poisson7pt
from amgx_tpu_torch.ops import ell_spmv as emod
from amgx_tpu_torch.ops.device_pack import device_ell_matrix
from amgx_tpu_torch.errors import BadParametersError


def assert_row_len(M):
    """``M.row_len`` is exactly one past each row's last nonzero slot."""
    assert M.fmt == "ell" and M.block_dim == 1 and M.cols is not None
    rl = M.row_len
    assert rl is not None and rl.dtype == torch.int32
    assert rl.shape == (M.n_rows,)
    v = M.vals.detach().cpu().numpy()
    rl = rl.cpu().numpy()
    K = v.shape[1]
    slot = np.arange(K)[None, :]
    assert (rl >= 0).all() and (rl <= K).all()
    assert not np.any(np.where(slot >= rl[:, None], v, 0))
    last = np.where(rl > 0, rl - 1, 0)
    has = rl > 0
    assert (v[np.arange(len(rl))[has], last[has]] != 0).all()


def _ragged(n=500, seed=3):
    """Rows of 1…40 entries with explicit zeros inside and at the end:
    an ELL pack whose rows stop well before K."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.03, random_state=seed, format="lil")
    A[7, :] = 0
    A[11, ::5] = rng.standard_normal(len(range(0, n, 5)))
    A = sp.csr_matrix(A)
    A.data[::9] = 0.0                   # stored zeros, not dropped
    return A


def test_host_upload_carries_row_len():
    A = _ragged()
    M = pack_device(A, 1, np.float64, dia_max_diags=0, device="cpu")
    assert amgx.pack_kind(M) == "ell/window"
    assert_row_len(M)
    assert int(M.row_len[7]) == 0 and int(M.row_len.min()) < M.ell_width
    # astype keeps a valid row_len (zeros stay zeros)
    assert_row_len(M.astype(torch.float32))


def test_device_ell_matrix_carries_row_len():
    g = torch.Generator().manual_seed(1)
    cols = torch.randint(-1, 60, (80, 12), dtype=torch.int64, generator=g)
    vals = torch.randn((80, 12), dtype=torch.float64, generator=g)
    vals[:, 9:] = 0
    vals[5] = 0
    M = device_ell_matrix(cols, vals, 80, 60, square_diag=False)
    assert_row_len(M)
    assert int(M.row_len[5]) == 0 and int(M.row_len.max()) <= 9
    M2 = ell_device_matrix(M.cols, M.vals, M.diag, 60)
    assert torch.equal(M2.row_len, M.row_len)


def test_classical_device_levels_carry_row_len(monkeypatch):
    """The device pipeline's ELL coarse operators, P and R (10³ with a
    100-row host tail, as tests/test_torch_classical.py runs it)."""
    monkeypatch.setenv("AMGX_PIPELINE_TAIL_ROWS", "100")
    cfg = ("config_version=2, solver(out)=PCG, out:max_iters=100, "
           "out:monitor_residual=1, out:tolerance=1e-8, "
           "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
           "amg:algorithm=CLASSICAL, amg:selector=PMIS, "
           "amg:interpolator=D2, amg:max_iters=1, "
           "amg:interp_max_elements=4, amg:max_row_sum=0.9, "
           "amg:max_levels=16, amg:smoother(sm)=JACOBI_L1, "
           "sm:max_iters=1, amg:presweeps=2, amg:postsweeps=2, "
           "amg:min_coarse_rows=32, amg:coarse_solver=DENSE_LU_SOLVER")
    slv = amgx.create_solver(cfg)
    slv.setup(amgx.Matrix(poisson7pt(10, 10, 10), device="cpu"))
    h = slv.preconditioner.hierarchy
    seen = 0
    for lv in h.levels:
        for M in (lv.Ad, lv.P, lv.R):
            if getattr(M, "fmt", None) == "ell":
                assert_row_len(M)
                seen += 1
    assert seen >= 3


def test_aggregation_levels_carry_row_len():
    """The DFG operator's SIZE_2 hierarchy: every coarse ELL level."""
    cfg = ("config_version=2, solver(out)=FGMRES, out:max_iters=5, "
           "out:gmres_n_restart=6, out:preconditioner(amg)=AMG, "
           "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, "
           "amg:max_iters=1, amg:cycle=CG, amg:smoother(sm)=BLOCK_JACOBI, "
           "sm:max_iters=1, amg:min_coarse_rows=32, "
           "amg:coarse_solver=DENSE_LU_SOLVER")
    slv = amgx.create_solver(cfg)
    slv.setup(amgx.Matrix(dfg_cylinder_pressure(32), device="cpu"))
    h = slv.preconditioner.hierarchy
    ell = [lv.Ad for lv in h.levels if lv.Ad.fmt == "ell"
           and lv.Ad.cols is not None]
    assert ell
    for M in ell:
        assert_row_len(M)


def test_wide_pack_recomputes_row_len():
    """A value that rounds to 0 in the f32 pack is nonzero in the
    refinement's f64 pack: its row_len covers it."""
    A = sp.lil_matrix(_ragged())
    A[3, 499] = 1e-50
    A = sp.csr_matrix(A)
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = np.float32
    slv = amgx.SolverFactory.create("CG")
    slv.setup(m)
    assert amgx.pack_kind(m.device()) == "ell/window"
    W = slv._wide_pack(np.dtype(np.float64))
    assert_row_len(W)
    assert int(W.row_len[3]) > int(m.device().row_len[3])


def test_row_len_is_checked():
    cols = torch.zeros((4, 3), dtype=torch.int32)
    vals = torch.ones((4, 3))
    x = torch.ones(4)
    rl = torch.full((4,), 2, dtype=torch.int32)
    # the plain version ignores row_len (the skipped slots hold zeros)
    v = vals.clone()
    v[:, 2] = 0
    assert torch.equal(emod.ell_spmv(cols, v, x, rl),
                       emod.ell_spmv(cols, v, x))
    for bad in (rl.long(), rl[:3], rl.reshape(2, 2)):
        with pytest.raises(BadParametersError):
            emod.ell_spmv(cols, vals, x, bad)
    with pytest.raises(BadParametersError):
        emod.ell_spmv(None, torch.ones((4, 4)), x, rl)

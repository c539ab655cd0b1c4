"""ROADMAP C13: ``hierarchy_dtype=float32`` or ``bfloat16`` under an f64
outer solver on a real operator whose coarse levels pack ELL.  The
cycle's f64 vectors meet f32 / bf16 level packs; the port raised there,
having no (f32, f64) or (bf16, f64) pair of B3 nor a (bf16, f64) one of
B1, where the JAX package declines to its plain paths.  Such an apply
now launches B1 / B3 in those pairs on the card (each value widened
exactly to f64) and runs their plain versions on the CPU, and the solve
takes the JAX package's count — its history to 1e-8 with f32 levels;
with bf16 levels within the bf16 band of
``tests/test_torch_precision.py`` (the port inverts each level's
diagonal from the wide values)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx

import amgx_tpu_torch as amgx
from amgx_tpu_torch.io import poisson7pt
from amgx_tpu_torch.ops import spmv as smod

CFG = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:store_res_history=1, out:convergence=RELATIVE_INI, "
       "out:gmres_n_restart=6, out:preconditioner(amg)=AMG, "
       "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, amg:max_iters=1, "
       "amg:max_levels=20, amg:cycle=V, amg:smoother(sm)=BLOCK_JACOBI, "
       "sm:max_iters=1, amg:presweeps=1, amg:postsweeps=1, "
       "amg:min_coarse_rows=16, amg:coarse_solver=DENSE_LU_SOLVER, "
       "hierarchy_dtype={hd}")


@pytest.mark.parametrize("hd", ["float32", "bfloat16"])
def test_narrow_levels_under_f64_vectors_match_jax(hd):
    A = sp.csr_matrix(poisson7pt(8, 8, 8)) \
        - 0.4 * sp.identity(512, format="csr")
    b = np.random.default_rng(2).standard_normal(512)
    cfg = CFG.format(hd=hd)
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(jx.Matrix(A))
    rj = sj.solve(b)
    s = amgx.create_solver(cfg)
    s.setup(amgx.Matrix(A, device="cpu"))
    smod.reset_dispatch()
    r = s.solve(b)
    h = s.preconditioner.hierarchy
    want = torch.float32 if hd == "float32" else torch.bfloat16
    assert all(lv.Ad.dtype == want for lv in h.levels)
    assert any(lv.Ad.fmt == "ell" for lv in h.levels)
    # the ELL levels' applies in f64 (B3's path; its CPU label)
    assert smod.DISPATCH["ell/gather"] > 0
    assert r.x.dtype == torch.float64 and r.status == 0
    assert r.iterations == rj.iterations
    rtol = 1e-8 if hd == "float32" else 1e-2
    hj = np.asarray(rj.residual_history, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(r.residual_history), hj,
                               rtol=rtol, atol=1e-12 * float(np.max(hj[0])))

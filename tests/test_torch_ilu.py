"""Multicolor ILU(k) in the port against the JAX package on the CPU in
f64: the factors' per-color L and U slabs and 1/diag (ILU(0) and
ILU(1)) to 1e-10, one application to ``SWEEP_RTOL``, and whole solves —
PBICGSTAB + MULTICOLOR_ILU(0) and (1) on the DFG cylinder operator
(ny = 16) and ILU as a classical AMG's smoother — with equal counts and
histories to ``HIST_RTOL``/``HIST_ATOL`` (``torch_solver_parity``).

At ny = 32 BiCGStab + ILU(0) runs chaotically in the JAX package itself
(64 against 67 iterations after a perturbation of 1e-15 in b), so no
other summation order can follow its history there."""
import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu as jx

import amgx_tpu_torch as amgx
from amgx_tpu_torch.errors import BadConfigurationError, SolveStatus
from amgx_tpu_torch.io import dfg_cylinder_pressure, poisson5pt, poisson7pt
from amgx_tpu_torch.solvers import ilu
from torch_solver_parity import (SWEEP_RTOL, apply_both, assert_same_solve,
                                 matrices, relres, solve_both)

SETUP_RTOL = 1e-10


def _nonsym():
    A = sp.csr_matrix(poisson5pt(9, 9))
    rng = np.random.default_rng(4)
    m = A.shape[0]
    return (A + sp.random(m, m, density=0.01, random_state=4) * 0.2
            + sp.diags(rng.uniform(0.0, 0.5, m))).tocsr()


OPS = {"poisson7": lambda: sp.csr_matrix(poisson7pt(5, 5, 5)),
       "nonsym": _nonsym,
       "dfg16": lambda: dfg_cylinder_pressure(16)}


def _cfg(level):
    return ("config_version=2, solver(s)=MULTICOLOR_ILU, s:max_iters=1, "
            f"s:ilu_sparsity_level={level}")


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("op", sorted(OPS))
def test_factors_and_one_sweep_match_jax(op, level):
    A = OPS[op]()
    xj, xp, sj, sp_ = apply_both(A, _cfg(level))
    np.testing.assert_allclose(xp, xj, rtol=SWEEP_RTOL,
                               atol=SWEEP_RTOL * np.max(np.abs(xj)))
    assert sp_.num_colors == sj.num_colors
    for slabs_p, slabs_j in ((sp_.L_slabs, sj.L_slabs),
                             (sp_.U_slabs, sj.U_slabs)):
        assert len(slabs_p) == len(slabs_j)
        for p, j in zip(slabs_p, slabs_j):
            np.testing.assert_array_equal(p.rows.numpy(), np.asarray(j.rows))
            np.testing.assert_array_equal(p.cols.numpy(), np.asarray(j.cols))
            np.testing.assert_allclose(p.vals.numpy(), np.asarray(j.vals),
                                       rtol=SETUP_RTOL, atol=0)
    np.testing.assert_allclose(sp_.dinv_f.numpy(), np.asarray(sj.dinv_f),
                               rtol=SETUP_RTOL)


def test_ilu1_fills_more_than_ilu0():
    A = _nonsym()
    nnz = []
    for level in (0, 1):
        s = amgx.create_solver(_cfg(level))
        s.setup(amgx.Matrix(A, device="cpu"))
        nnz.append(sum(int((sl.vals != 0).sum()) for sl in
                       s.L_slabs + s.U_slabs))
    assert nnz[1] > nnz[0]
    pat = ilu._symbolic_fill(A, 1)
    assert pat.nnz > A.nnz


def test_setup_without_host_matrix_raises():
    m = amgx.Matrix(sp.csr_matrix(poisson7pt(4, 4, 4)), device="cpu")
    s = amgx.create_solver(_cfg(0))
    with pytest.raises(BadConfigurationError):
        s.setup(m.device())


PBICG = ("config_version=2, solver(out)=PBICGSTAB, out:max_iters=200, "
         "out:monitor_residual=1, out:tolerance=1e-8, "
         "out:convergence=RELATIVE_INI, out:store_res_history=1, "
         "out:preconditioner(pre)=MULTICOLOR_ILU, pre:max_iters=1, "
         "pre:ilu_sparsity_level={level}")


@pytest.mark.parametrize("level", [0, 1])
def test_dfg_pbicgstab_ilu_matches_jax(level):
    A = dfg_cylinder_pressure(16)
    rj, rp, _ = solve_both(A, PBICG.format(level=level))
    assert_same_solve(rj, rp)
    assert rp.status == SolveStatus.SUCCESS
    assert relres(A, rp.x, np.ones(A.shape[0])) <= 1.01e-8


def test_classical_amg_ilu_smoother_matches_jax():
    # the ILU sweep is not its own adjoint, so the cycle is not
    # symmetric: FGMRES around it
    cfg = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
           "out:gmres_n_restart=20, "
           "out:monitor_residual=1, out:tolerance=1e-8, "
           "out:convergence=RELATIVE_INI, out:store_res_history=1, "
           "out:preconditioner(amg)=AMG, amg:algorithm=CLASSICAL, "
           "amg:strength_threshold=0.2401, amg:max_iters=1, "
           "amg:smoother(sm)=MULTICOLOR_ILU, sm:max_iters=1, "
           "amg:min_coarse_rows=16, amg:coarse_solver=DENSE_LU_SOLVER")
    rj, rp, _ = solve_both(sp.csr_matrix(poisson7pt(10, 10, 10)), cfg)
    assert_same_solve(rj, rp)
    assert rp.status == SolveStatus.SUCCESS

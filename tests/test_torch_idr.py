"""IDR(s) and IDRMSYNC in the port against the JAX package on the CPU in
f64: the shadow space, then whole solves — standalone, around config 4's
DILU (the ``IDR_DILU`` shape) and around an AMG preconditioner — with
equal counts and histories to ``HIST_RTOL``/``HIST_ATOL``
(``torch_solver_parity``).

The systems converge in few cycles on purpose: IDR(s) amplifies
rounding, and on a hard nonsymmetric system the JAX package's own
history parts by O(1) from a perturbation of 1e-15 in b within ten
cycles, so no other summation order can follow it further."""
import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu as jx
from amgx_tpu.ops import pallas_csr
from amgx_tpu.solvers.idr import IDRMSyncSolver as JaxMSync

from amgx_tpu_torch.errors import SolveStatus
from amgx_tpu_torch.io import poisson5pt, poisson7pt, spe10_block_system
from amgx_tpu_torch.solvers.idr import IDRMSyncSolver, IDRSolver
from torch_solver_parity import (assert_same_solve, matrices, relres,
                                 solve_both)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_csr, "_INTERPRET", True)


OUT = ("config_version=2, solver(out)={name}, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:store_res_history=1, "
       "out:subspace_dim_s={s}, ")


def _nonsym(n=16, seed=2):
    """A nonsymmetric perturbation of the 2-D Laplacian."""
    A = sp.csr_matrix(poisson5pt(n, n))
    rng = np.random.default_rng(seed)
    m = A.shape[0]
    return (A + sp.random(m, m, density=0.005, random_state=seed) * 0.1
            + sp.diags(rng.uniform(0.0, 0.5, m))).tocsr()


def test_msync_is_its_own_iteration():
    assert IDRMSyncSolver.solve_iteration is not IDRSolver.solve_iteration
    assert JaxMSync.solve_iteration is not IDRSolver.solve_iteration


@pytest.mark.parametrize("s", [2, 8])
def test_shadow_space_matches_jax(s):
    A = _nonsym()
    cfg = OUT.format(name="IDR", s=s) + "out:preconditioner(p)=NOSOLVER"
    mj, mp = matrices(A)
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(mj)
    import amgx_tpu_torch as amgx
    sp_ = amgx.create_solver(cfg)
    sp_.setup(mp)
    np.testing.assert_array_equal(sp_.P.numpy(), np.asarray(sj.P))
    np.testing.assert_allclose(sp_.P.numpy() @ sp_.P.numpy().T, np.eye(s),
                               atol=1e-12)


CASES = {
    "nonsym-dilu-s4": (_nonsym, 1, "4",
                           "out:preconditioner(p)=MULTICOLOR_DILU, "
                           "p:max_iters=1"),
    "nonsym-noprec-s4": (lambda: _nonsym(16), 1, "4", ""),
    "spe10-dilu-s8": (lambda: spe10_block_system(8, 8, 8), 4, "8",
                      "out:preconditioner(p)=MULTICOLOR_DILU, "
                      "p:max_iters=1"),
    "poisson-amg-s4": (lambda: sp.csr_matrix(poisson7pt(10, 10, 10)), 1,
                       "4", "out:preconditioner(amg)=AMG, "
                       "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, "
                       "amg:max_iters=1, amg:smoother(sm)=BLOCK_JACOBI, "
                       "sm:max_iters=1, amg:min_coarse_rows=16, "
                       "amg:coarse_solver=DENSE_LU_SOLVER"),
}


@pytest.mark.parametrize("name", ["IDR", "IDRMSYNC"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_jax(case, name):
    build, b, s, pre = CASES[case]
    A = build()
    rj, rp, _ = solve_both(A, OUT.format(name=name, s=s) + pre, b=b)
    assert_same_solve(rj, rp)
    assert rp.status == SolveStatus.SUCCESS
    assert relres(A, rp.x, np.ones(A.shape[0])) <= 1.01e-8

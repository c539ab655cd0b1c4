"""The Krylov family the port took from the JAX package in this slice —
GMRES, PCGF, PCG_CA, PCG_PIPE, CG/PCG with ``krylov_comm`` CA and
PIPELINED, the fused Arnoldi pass of (F)GMRES — and the fused
reductions of ``ops/blas.py``, against the JAX package on the CPU in
f64: equal iteration counts and residual histories to
``HIST_RTOL``/``HIST_ATOL`` (``torch_solver_parity``), standalone and
around an AMG preconditioner.  The registry test holds the port to the
JAX package's 27 solver names."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu.solvers as jsolvers
import jax.numpy as jnp
from amgx_tpu.ops import blas as jblas

import amgx_tpu_torch.solvers as psolvers
from amgx_tpu_torch.errors import SolveStatus
from amgx_tpu_torch.io import poisson5pt, poisson7pt
from amgx_tpu_torch.ops import blas, ordered
from torch_solver_parity import assert_same_solve, relres, solve_both

OUT = ("config_version=2, solver(out)={name}, out:max_iters=200, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:store_res_history=1, ")
JAC = "out:preconditioner(p)=BLOCK_JACOBI, p:max_iters=1"
AMG_CLA = ("out:preconditioner(amg)=AMG, amg:algorithm=CLASSICAL, "
           "amg:max_iters=1, amg:smoother(sm)=JACOBI_L1, sm:max_iters=1, "
           "amg:min_coarse_rows=16, amg:coarse_solver=DENSE_LU_SOLVER")
AMG_AGG = ("out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
           "amg:selector=SIZE_2, amg:max_iters=1, "
           "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
           "amg:min_coarse_rows=16, amg:coarse_solver=DENSE_LU_SOLVER")


def test_registry_holds_the_jax_packages_names():
    got = set(psolvers.SolverFactory.registered())
    want = set(jsolvers.SolverFactory.registered())
    assert len(want) == 27
    assert got == want


def _vectors(n=257, k=5, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n) for _ in range(k)]


def test_fused_reduce_matches_jax():
    vs = _vectors()
    terms = [vs[0] * vs[1], vs[2] * vs[3], vs[4] ** 2]
    want = np.asarray(jblas.fused_reduce([jnp.asarray(t) for t in terms]))
    got = blas.fused_reduce([torch.from_numpy(t) for t in terms]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13)
    # f32 terms from widened operands: summed in f64, rounded once, as
    # the CA and pipelined steps form them
    t32 = [torch.from_numpy(v.astype(np.float32)) for v in vs]
    w = [ordered.widen(t) for t in t32]
    got32 = blas.fused_reduce([w[0] * w[1]]).to(torch.float32)
    assert got32[0] == ordered.wdot(t32[0], t32[1])


@pytest.mark.parametrize("norm", ["L1", "L2", "L1_SCALED"])
@pytest.mark.parametrize("block", [(1, True), (3, False), (3, True)])
def test_norm_terms_and_finish_match_jax(norm, block):
    bd, scalar = block
    v = _vectors(n=3 * 41, k=1)[0]
    tj = jblas.norm_terms(jnp.asarray(v), norm, bd, scalar)
    tp = blas.norm_terms(torch.from_numpy(v), norm, bd, scalar)
    assert len(tp) == len(tj)
    accj = jblas.fused_reduce(tj)
    accp = blas.fused_reduce(tp)
    want = np.asarray(jblas.finish_norm(accj, norm, v.size, bd, scalar))
    got = blas.finish_norm(accp, norm, v.size, bd, scalar).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13)
    np.testing.assert_allclose(
        got, blas.norm(torch.from_numpy(v), norm, bd, scalar).numpy(),
        rtol=1e-13)
    assert blas.norm_terms(torch.from_numpy(v), "LMAX", bd, scalar) is None


def test_gram_dots_with_norm_matches_jax():
    vs = _vectors(k=4)
    V = np.stack(vs[:3])
    w = vs[3]
    hj, wwj = jblas.gram_dots_with_norm(jnp.asarray(V), jnp.asarray(w),
                                        jnp.ones(3))
    hp, wwp = blas.gram_dots_with_norm(torch.from_numpy(V),
                                       torch.from_numpy(w))
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), rtol=1e-13)
    np.testing.assert_allclose(float(wwp), float(wwj), rtol=1e-13)
    h32, ww32 = ordered.wgram_dots_with_norm(
        torch.from_numpy(V.astype(np.float32)),
        torch.from_numpy(w.astype(np.float32)))
    assert h32.dtype == ww32.dtype == torch.float32


def _nonsym(n=20, seed=2):
    """A nonsymmetric perturbation of the 2-D Laplacian."""
    A = sp.csr_matrix(poisson5pt(n, n))
    rng = np.random.default_rng(seed)
    m = A.shape[0]
    return (A + sp.random(m, m, density=0.005, random_state=seed) * 0.1
            + sp.diags(rng.uniform(0.0, 0.5, m))).tocsr()


SPD = sp.csr_matrix(poisson7pt(10, 10, 10))

#: (solver, extra knobs, operator, preconditioner)
CASES = {
    "PCG_CA-jacobi": ("PCG_CA", "", SPD, JAC),
    "PCG_PIPE-jacobi": ("PCG_PIPE", "", SPD, JAC),
    "CG-CA": ("CG", "out:krylov_comm=CA, ", SPD, ""),
    "CG-PIPELINED": ("CG", "out:krylov_comm=PIPELINED, ", SPD, ""),
    "PCG-CA-replace3": ("PCG", "out:krylov_comm=CA, "
                        "out:ca_residual_replace=3, ", SPD, JAC),
    "PCG-PIPELINED-replace4": ("PCG", "out:krylov_comm=PIPELINED, "
                               "out:ca_residual_replace=4, ", SPD, JAC),
    "PCG_CA-l1norm": ("PCG_CA", "out:norm=L1, ", SPD, JAC),
    "PCG_PIPE-lmax-classic": ("PCG_PIPE", "out:norm=LMAX, ", SPD, JAC),
    "PCGF-jacobi": ("PCGF", "", SPD, JAC),
    "GMRES-jacobi": ("GMRES", "out:gmres_n_restart=8, ", _nonsym(),
                     JAC),
    "GMRES-noprec": ("GMRES", "out:gmres_n_restart=10, ", _nonsym(),
                     ""),
    "GMRES-CA": ("GMRES", "out:krylov_comm=CA, out:gmres_n_restart=8, ",
                 _nonsym(), JAC),
    "FGMRES-PIPELINED": ("FGMRES", "out:krylov_comm=PIPELINED, "
                         "out:gmres_n_restart=8, ", _nonsym(), JAC),
    "PCG_CA-amg": ("PCG_CA", "", SPD, AMG_CLA),
    "PCG_PIPE-amg": ("PCG_PIPE", "", SPD, AMG_CLA),
    "PCGF-amg": ("PCGF", "", SPD, AMG_CLA),
    "GMRES-amg-classical": ("GMRES", "out:gmres_n_restart=5, ", SPD,
                            AMG_CLA),
    "GMRES-amg-aggregation": ("GMRES", "out:gmres_n_restart=6, ", SPD,
                              AMG_AGG),
    "FGMRES-CA-amg": ("FGMRES", "out:krylov_comm=CA, "
                      "out:gmres_n_restart=6, ", SPD, AMG_AGG),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_matches_jax(case):
    name, extra, A, pre = CASES[case]
    cfg = OUT.format(name=name) + extra + pre
    rj, rp, _ = solve_both(A, cfg)
    assert_same_solve(rj, rp)
    assert rp.status == SolveStatus.SUCCESS
    assert relres(A, rp.x, np.ones(A.shape[0])) <= 1e-8 * 1.01


def test_ca_modes_take_classic_counts():
    """CA and pipelined CG are the classic recurrence rearranged: on an
    SPD system they take the classic loop's iterations (within one) in
    the port as in the JAX package."""
    its = {}
    for mode in ("CLASSIC", "CA", "PIPELINED"):
        cfg = OUT.format(name="PCG") + f"out:krylov_comm={mode}, " + AMG_CLA
        rj, rp, _ = solve_both(SPD, cfg)
        assert rp.iterations == rj.iterations
        its[mode] = rp.iterations
    assert abs(its["CA"] - its["CLASSIC"]) <= 1
    assert abs(its["PIPELINED"] - its["CLASSIC"]) <= 1


def test_gmres_keeps_no_preconditioned_basis():
    _, rp, slv = solve_both(_nonsym(), OUT.format(name="GMRES")
                            + "out:gmres_n_restart=8, " + JAC)
    assert not slv.flexible
    b = torch.ones(_nonsym().shape[0], dtype=torch.float64)
    assert slv.solve_init(b, torch.zeros_like(b)).Z is None


def test_pcgf_flags_an_indefinite_preconditioner():
    """PCGF's breakdown guard: a negated Jacobi preconditioner makes
    pAp > 0 but ⟨r, z⟩ < 0, and an indefinite operator pAp < 0; the JAX
    package and the port stop alike."""
    A = SPD.copy()
    A = -A
    cfg = OUT.format(name="PCGF") + JAC
    rj, rp, _ = solve_both(A, cfg)
    assert rp.iterations == rj.iterations
    assert rp.status == SolveStatus.FAILED
    assert rp.failure.kind.value == rj.failure.kind.value \
        == "indefinite_operator"


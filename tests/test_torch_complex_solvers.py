"""Complex operators on the rest of the Krylov set and the eigensolvers,
against the JAX package on the CPU (ROADMAP item 7c).

Every name the JAX package runs on a complex operator runs in the port
with the JAX package's count and residual history (``HIST_RTOL`` 1e-8
plus ``HIST_ATOL``·‖r₀‖, ``tests/torch_complex_parity.py``) or, for an
eigensolver, its eigenvalue to 1e-10 relative; every name it refuses
(its setup or first solve raises) the port refuses at setup.  The
MULTICOLOR_DILU setup keeps the JAX package's real-part E and CHEBYSHEV
its real Lanczos tridiagonal: both are held to the JAX package's
values."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
from amgx_tpu.eigen import EigenSolverFactory as JEigen

import amgx_tpu_torch as amgx
from amgx_tpu_torch.eigen import EigenSolverFactory
from amgx_tpu_torch.errors import NotImplementedError_

from torch_complex_parity import (amg_cfg, assert_same, both, hermitian,
                                  krylov_cfg, operator, relres)

KRYLOV_CASES = {
    # the CG family on the Hermitian operator (on the shifted Helmholtz
    # the JAX package's CG diverges too)
    "PCGF": ("H", krylov_cfg("PCGF")),
    "PCG_CA": ("H", krylov_cfg("PCG_CA")),
    "PCG_PIPE": ("H", krylov_cfg("PCG_PIPE")),
    "PCG_comm_CA": ("H", krylov_cfg("PCG", extra=", out:krylov_comm=CA")),
    "PCG_comm_PIPELINED": ("H", krylov_cfg(
        "PCG", extra=", out:krylov_comm=PIPELINED")),
    "GMRES_comm_CA": ("Z", krylov_cfg("GMRES",
                                      extra=", out:krylov_comm=CA")),
    "GMRES_comm_PIPELINED": ("Z", krylov_cfg(
        "GMRES", extra=", out:krylov_comm=PIPELINED")),
    "FGMRES_comm_CA": ("Z", krylov_cfg("FGMRES",
                                       extra=", out:krylov_comm=CA")),
    "FGMRES_comm_PIPELINED": ("Z", krylov_cfg(
        "FGMRES", extra=", out:krylov_comm=PIPELINED")),
    "IDR": ("Z", krylov_cfg("IDR")),
    "IDRMSYNC": ("Z", krylov_cfg("IDRMSYNC")),
}


@pytest.mark.parametrize("case", sorted(KRYLOV_CASES))
def test_krylov_name_matches_jax(case):
    op, cfg = KRYLOV_CASES[case]
    A, b = operator(op)
    rj, rp, _ = both(cfg, A, b)
    assert_same(rj, rp)
    assert rp.status == 0 and relres(A, rp.x, b) < 1e-7


#: names the JAX package refuses on a complex operator, with the solver
#: tree that reaches them: (config, where the port's refusal names)
REFUSED = {
    "CHEBYSHEV_POLY": (krylov_cfg("FGMRES", pre="CHEBYSHEV_POLY"),
                       "CHEBYSHEV_POLY"),
    "KPZ_POLYNOMIAL": (krylov_cfg("FGMRES", pre="KPZ_POLYNOMIAL"),
                       "KPZ_POLYNOMIAL"),
    "CLASSICAL": (amg_cfg(alg="CLASSICAL", sel="PMIS"), "CLASSICAL"),
    # CF_JACOBI's C/F split exists only on a classical level
    "CF_JACOBI_in_CLASSICAL": (amg_cfg(alg="CLASSICAL", sel="PMIS",
                                       sm="CF_JACOBI"), "CLASSICAL"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_names_refuse_in_both(case):
    cfg, names = REFUSED[case]
    A, b = operator("Z")
    with pytest.raises(TypeError):
        s = jx.create_solver(jx.AMGConfig(cfg))
        s.setup(jx.Matrix(A))
        s.solve(b)
    s = amgx.create_solver(cfg)
    m = amgx.Matrix(A, device="cpu")
    with pytest.raises(NotImplementedError_, match="does not run it") as e:
        s.setup(m)
    assert names in str(e.value) and "7c" not in str(e.value)
    # refused before any work: no hierarchy, no smoother data
    pre = getattr(s, "preconditioner", None)
    assert getattr(pre, "hierarchy", None) is None or \
        not pre.hierarchy.levels


def test_cf_jacobi_alone_runs_as_in_jax():
    """Without a classical level CF_JACOBI marks no point C: both packages
    run it on a complex operator as Jacobi."""
    A, b = operator("Z")
    rj, rp, _ = both(krylov_cfg("FGMRES", pre="CF_JACOBI"), A, b)
    assert_same(rj, rp)


EIG = ("config_version=2, eig_solver={name}, eig_max_iters=60, "
       "eig_tolerance=1e-8, eig_which=largest{extra}")
#: the inner solver of INVERSE_ITERATION, LOBPCG's preconditioner
INNER = (", solver=PCG, max_iters=50, tolerance=1e-10, "
         "preconditioner=NOSOLVER")
EIG_RUNS = {"POWER_ITERATION": "", "INVERSE_ITERATION": INNER,
            "LANCZOS": "", "ARNOLDI": "", "JACOBI_DAVIDSON": "",
            "LOBPCG": INNER}


def _eig_jax(cfg, A):
    es = JEigen.allocate(jx.AMGConfig(cfg))
    es.setup(jx.Matrix(A))
    return es.solve()


def _eig_port(cfg, A):
    es = EigenSolverFactory.allocate(amgx.AMGConfig(cfg))
    es.setup(amgx.Matrix(A, device="cpu"))
    return es, es.solve()


@pytest.mark.parametrize("name", sorted(EIG_RUNS))
def test_eigensolver_matches_jax(name):
    """On the Hermitian operator.  LANCZOS, ARNOLDI and JACOBI_DAVIDSON
    keep the JAX package's host recurrences in f64, which take the real
    parts of each complex product (numpy's cast); LOBPCG's Rayleigh–Ritz
    symmetrises as ``jnp.linalg.eigh`` does."""
    cfg = EIG.format(name=name, extra=EIG_RUNS[name])
    A = hermitian()
    rj = _eig_jax(cfg, A)
    _, rp = _eig_port(cfg, A)
    assert rp.iterations == rj.iterations
    lj = np.asarray(rj.eigenvalues)[:1]
    lp = np.asarray(rp.eigenvalues)[:1]
    np.testing.assert_allclose(lp, lj, rtol=1e-10)


EIG_REFUSED = {"SUBSPACE_ITERATION": "", "PAGERANK": "", "LOBPCG": "",
               "INVERSE_ITERATION": ", solver=AMG, algorithm=CLASSICAL"}


@pytest.mark.parametrize("name", sorted(EIG_REFUSED))
def test_refused_eigensolvers_refuse_in_both(name):
    """SUBSPACE_ITERATION, PAGERANK and the unpreconditioned (fused)
    LOBPCG raise in the JAX package on a complex operator (their loop
    carries turn real); INVERSE_ITERATION raises where its inner solver
    does (here classical AMG).  The port refuses each at setup."""
    cfg = EIG.format(name=name, extra=EIG_REFUSED[name])
    A = hermitian()
    with pytest.raises(TypeError):
        _eig_jax(cfg, A)
    with pytest.raises(NotImplementedError_, match="does not run it"):
        _eig_port(cfg, A)


def test_dilu_e_is_the_jax_real_part_e():
    """MULTICOLOR_DILU's E on a complex operator: the JAX package builds
    it in f64 from the real parts (``diag.astype(np.float64)``, and an
    f64 ``contrib`` into which ``np.add.at`` drops each complex product's
    imaginary part, ``amgx_tpu/solvers/dilu.py:50, 58``).  The port's
    E⁻¹ equals it entry for entry, its imaginary parts are zero, and it
    differs from the E of complex arithmetic (on a complex-symmetric
    operator, whose products a_ij·a_ji are complex)."""
    Z, _ = operator("Z")
    off = sp.csr_matrix(Z - sp.diags(Z.diagonal()))
    A = sp.csr_matrix(Z + 0.2j * off)
    cfg = krylov_cfg("FGMRES", pre="MULTICOLOR_DILU")
    sj = jx.create_solver(jx.AMGConfig(cfg))
    mj = jx.Matrix(A)
    sj.setup(mj)
    sp_ = amgx.create_solver(cfg)
    mp = amgx.Matrix(A, device="cpu")
    sp_.setup(mp)
    np.testing.assert_array_equal(mp.coloring.colors, mj.coloring.colors)
    ej = np.asarray(sj.preconditioner.Einv)
    ep = sp_.preconditioner.Einv.numpy()
    np.testing.assert_array_equal(ep, ej)
    assert not np.any(ep.imag)
    # the E of complex arithmetic, in the same color order
    colors = mp.coloring.colors
    csr = A.tocsr()
    E = np.array(csr.diagonal())
    Ec = E.copy()
    for c in range(int(colors.max()) + 1):
        for i in np.where(colors == c)[0]:
            acc = 0
            for k in range(csr.indptr[i], csr.indptr[i + 1]):
                j = csr.indices[k]
                if colors[j] < c:
                    acc += csr.data[k] * csr[j, i] / Ec[j]
            Ec[i] = E[i] - acc
    assert np.max(np.abs(1 / Ec - ep)) > 1e-6


def test_chebyshev_bounds_are_the_jax_bounds():
    """CHEBYSHEV's Lanczos estimate on a complex operator takes the JAX
    package's recurrence (α = Re(v̄·w), the unconjugated
    reorthogonalisation) and the tridiagonal's real parts
    (``amgx_tpu/solvers/chebyshev.py:51-70``): the same λmin, λmax."""
    A = hermitian()
    cfg = krylov_cfg("FGMRES", pre="CHEBYSHEV")
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(jx.Matrix(A))
    sp_ = amgx.create_solver(cfg)
    sp_.setup(amgx.Matrix(A, device="cpu"))
    pj, pp = sj.preconditioner, sp_.preconditioner
    np.testing.assert_allclose([pp.lmin, pp.lmax], [pj.lmin, pj.lmax],
                               rtol=1e-12)


def test_complex_smoother_products_keep_their_dtype():
    """A c64 sweep keeps c64 (the products part by part,
    ``ops.ordered.mul``), and its x is the c128 sweep's to c64
    rounding."""
    A, _ = operator("H")
    rng = np.random.default_rng(4)
    b = torch.from_numpy(rng.standard_normal(512)
                         + 1j * rng.standard_normal(512))
    out = {}
    for dt in (np.complex64, np.complex128):
        s = amgx.create_solver(krylov_cfg("FGMRES", pre="MULTICOLOR_GS"))
        s.setup(amgx.Matrix(A.astype(dt), device="cpu"))
        out[dt] = s.preconditioner.apply(b.to(torch.from_numpy(
            np.zeros(1, dt)).dtype))
    assert out[np.complex64].dtype == torch.complex64
    np.testing.assert_allclose(out[np.complex64].numpy(),
                               out[np.complex128].numpy(), rtol=1e-5,
                               atol=1e-5)

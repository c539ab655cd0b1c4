"""The eight eigensolvers of the port (``amgx_tpu_torch.eigen``) on the
systems and knobs of ``tests/test_eigen.py``, each against the JAX
package's eigenvalues and the dense reference, with that file's
tolerances."""
import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu
from amgx_tpu.eigen import EigenSolverFactory as JaxFactory

import amgx_tpu_torch as tam
from amgx_tpu_torch.eigen import EigenSolverFactory
from amgx_tpu_torch.errors import (BadConfigurationError,
                                   NotImplementedError_, SolveStatus)
from amgx_tpu_torch.io import poisson5pt


def _cfg(name, extra):
    return (f"config_version=2, eig_solver(e)={name}, e:eig_max_iters=300, "
            f"e:eig_tolerance=1e-9{extra}")


def _run(name, A, extra=""):
    es = EigenSolverFactory.allocate(tam.AMGConfig(_cfg(name, extra)))
    es.setup(tam.Matrix(A, device="cpu"))
    return es.solve()


def _run_jax(name, A, extra=""):
    es = JaxFactory.allocate(amgx_tpu.AMGConfig(_cfg(name, extra)))
    es.setup(amgx_tpu.Matrix(A))
    return es.solve()


@pytest.fixture(scope="module")
def system():
    A = poisson5pt(12, 12)
    return A, np.linalg.eigvalsh(A.toarray())


def test_registry_names():
    assert sorted(EigenSolverFactory.registered()) == \
        sorted(JaxFactory.registered())


# (name, matrix, knobs, reference check); the JAX package's eigenvalues
# are held to the same tolerance as the reference
CASES = {
    "POWER_ITERATION": ("sym", "", lambda lam, w: abs(lam[0] - w[-1])
                        < 1e-5 * abs(w[-1])),
    "INVERSE_ITERATION": ("sym", ", e:solver(il)=PCG, il:max_iters=50, "
                          "il:monitor_residual=0",
                          lambda lam, w: abs(lam[0] - w[0])
                          < 1e-4 * abs(w[-1])),
    "SUBSPACE_ITERATION": ("sym", ", e:eig_wanted_count=3", lambda lam, w:
                           np.allclose(np.sort(np.abs(lam))[::-1],
                                       np.sort(np.abs(w))[::-1][:3],
                                       rtol=1e-4)),
    "LANCZOS": ("rect", ", e:eig_wanted_count=3", lambda lam, w:
                np.allclose(np.sort(np.abs(lam))[::-1],
                            np.sort(np.abs(w))[::-1][:3], rtol=1e-6)),
    "LOBPCG": ("sym", ", e:eig_wanted_count=2, e:eig_which=smallest",
               lambda lam, w: np.allclose(np.sort(lam), w[:2], rtol=1e-4)),
    "JACOBI_DAVIDSON": ("sym", "", lambda lam, w: abs(lam[0] - w[-1])
                        < 1e-5 * abs(w[-1])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_symmetric_eigensolvers(name, system):
    kind, extra, ok = CASES[name]
    A, w = system
    if kind == "rect":
        # no degenerate eigenvalues (single-vector Lanczos cannot see
        # multiplicities)
        A = poisson5pt(12, 11)
        w = np.linalg.eigvalsh(A.toarray())
    res, jres = _run(name, A, extra), _run_jax(name, A, extra)
    assert ok(res.eigenvalues, w), (res.eigenvalues, w)
    assert ok(np.asarray(jres.eigenvalues), w)
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(np.asarray(jres.eigenvalues)),
                               rtol=1e-4)
    assert res.eigenvectors.shape[0] == A.shape[0]


def test_lobpcg_preconditioned_raises_on_a_failed_setup(system):
    """The preconditioned (host) variant converges like the JAX package's;
    a preconditioner that fails to set up raises (the JAX package drops
    it and runs unpreconditioned)."""
    A, w = system
    extra = (", e:eig_wanted_count=2, e:eig_which=smallest, "
             "e:preconditioner(p)=BLOCK_JACOBI, p:max_iters=1")
    res = _run("LOBPCG", A, extra)
    np.testing.assert_allclose(np.sort(res.eigenvalues), w[:2], rtol=1e-4)
    assert res.status == SolveStatus.SUCCESS
    # AMG refuses a bare device pack (it needs the host matrix)
    bad = ", e:preconditioner(p)=AMG, p:algorithm=CLASSICAL"
    es = EigenSolverFactory.allocate(tam.AMGConfig(_cfg("LOBPCG", bad)))
    with pytest.raises(BadConfigurationError):
        es.setup(tam.Matrix(A, device="cpu").device())


def test_arnoldi_nonsymmetric():
    A = poisson5pt(10, 10).tolil()
    for i in range(99):
        A[i, i + 1] -= 0.3
    A = sp.csr_matrix(A)
    wref = np.linalg.eigvals(A.toarray())
    top = wref[np.argmax(np.abs(wref))]
    res = _run("ARNOLDI", A, ", e:eig_wanted_count=1")
    jres = _run_jax("ARNOLDI", A, ", e:eig_wanted_count=1")
    assert abs(abs(res.eigenvalues[0]) - abs(top)) < 1e-4 * abs(top)
    assert abs(abs(res.eigenvalues[0]) - abs(jres.eigenvalues[0])) \
        < 1e-6 * abs(top)


def test_pagerank():
    n = 60
    A = sp.random(n, n, density=0.1, random_state=np.random.RandomState(4),
                  format="csr")
    A.setdiag(1.0)
    A = sp.csr_matrix(A)
    extra = ", e:eig_damping_factor=0.85"
    res, jres = _run("PAGERANK", A, extra), _run_jax("PAGERANK", A, extra)
    x = res.eigenvectors[:, 0]
    assert abs(x.sum() - 1.0) < 1e-8 and (x >= 0).all()
    csr = sp.csr_matrix(abs(A))
    deg = np.asarray(csr.sum(axis=1)).ravel()
    dangling = deg == 0
    deg[dangling] = 1.0
    P = sp.csr_matrix(sp.diags(1.0 / deg) @ csr)
    y = 0.85 * (P.T @ x) + 0.85 * np.sum(x[dangling]) / n + 0.15 / n
    np.testing.assert_allclose(y / y.sum(), x, atol=1e-6)
    np.testing.assert_allclose(x, np.asarray(jres.eigenvectors)[:, 0],
                               atol=1e-9)
    assert res.iterations == jres.iterations


def test_complex_is_item_7c():
    """ROADMAP item 7c: the unpreconditioned (fused) LOBPCG, whose loop
    carry turns real in the JAX package, is refused on a complex
    operator at setup; POWER_ITERATION runs on it."""
    A = sp.csr_matrix(poisson5pt(4, 4), dtype=np.complex128)
    es = EigenSolverFactory.allocate(tam.AMGConfig(_cfg("LOBPCG", "")))
    with pytest.raises(NotImplementedError_, match="does not run it"):
        es.setup(tam.Matrix(A, device="cpu"))
    es = EigenSolverFactory.allocate(
        tam.AMGConfig(_cfg("POWER_ITERATION", "")))
    es.setup(tam.Matrix(A, device="cpu"))
    assert es.solve().eigenvalues.shape == (1,)

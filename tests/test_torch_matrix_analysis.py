"""``amgx_tpu_torch.utils.matrix_analysis`` against the JAX package's:
``analyze_matrix`` and ``estimate_spectral_bounds`` give equal dicts on
the same scipy matrices, and read a port ``Matrix`` through its host
CSR."""
import numpy as np
import pytest
import scipy.sparse as sp

from amgx_tpu.utils import matrix_analysis as jma
from amgx_tpu_torch import Matrix
from amgx_tpu_torch.io import poisson5pt, poisson7pt
from amgx_tpu_torch.utils import (analyze_matrix, estimate_spectral_bounds,
                                  matrix_analysis as tma)


def _cases():
    rng = np.random.default_rng(11)
    R = sp.random(40, 40, density=0.1, random_state=rng, format="csr")
    wide = sp.random(30, 45, density=0.2, random_state=rng, format="csr")
    holes = sp.csr_matrix(poisson5pt(6, 6))
    holes.data[holes.indices == 5] = 0.0       # explicit zeros stay
    return {"poisson7pt_6": poisson7pt(6, 6, 6),
            "poisson5pt_9x7": poisson5pt(9, 7),
            "random_nonsym": R + sp.identity(40),
            "rectangular": wide,
            "explicit_zeros": holes,
            "empty_rows": sp.csr_matrix((5, 5)),
            "dense_block": sp.csr_matrix(np.arange(16.0).reshape(4, 4))}


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_analyze_matrix_equals_jax(name):
    A = CASES[name]
    assert tma.analyze_matrix(A) == jma.analyze_matrix(A)


@pytest.mark.parametrize("name", sorted(n for n, A in CASES.items()
                                        if A.shape[0] == A.shape[1]))
def test_spectral_bounds_equal_jax(name):
    A = CASES[name]
    assert tma.estimate_spectral_bounds(A) == \
        jma.estimate_spectral_bounds(A)
    assert tma.estimate_spectral_bounds(A, n_iters=5) == \
        jma.estimate_spectral_bounds(A, n_iters=5)


def test_port_matrix_reads_its_host_csr():
    A = poisson7pt(5, 4, 3)
    m = Matrix(A, device="cpu")
    assert analyze_matrix(m) == jma.analyze_matrix(A)
    assert estimate_spectral_bounds(m) == jma.estimate_spectral_bounds(A)
    b = Matrix(sp.kron(poisson5pt(4, 4), np.ones((2, 2))).tocsr(),
               block_dim=2, device="cpu")
    assert analyze_matrix(b) == jma.analyze_matrix(b.scalar_csr())

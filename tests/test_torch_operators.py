"""Implicit operators (``amgx_tpu_torch.operators``) against
``amgx_tpu.operators`` on the same inputs: PCG on the shifted operator,
the deflated apply and the PageRank apply (``tests/test_solvers.py::
test_krylov_on_implicit_operators``)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu
import jax.numpy as jnp
from amgx_tpu import operators as jops
from amgx_tpu.ops.spmv import spmv as jspmv

import amgx_tpu_torch as tam
from amgx_tpu_torch import operators as ops
from amgx_tpu_torch.errors import BadConfigurationError, DeviceError
from amgx_tpu_torch.io import poisson5pt
from amgx_tpu_torch.ops.spmv import DISPATCH, reset_dispatch, spmv

PCG = ("config_version=2, solver(out)=PCG, out:max_iters=400, "
       "out:monitor_residual=1, out:tolerance=1e-10, "
       "out:store_res_history=1, out:convergence=RELATIVE_INI")


@pytest.fixture(scope="module")
def A():
    return sp.csr_matrix(poisson5pt(24, 24)).astype(np.float64)


def test_shifted_operator_pcg(A):
    n, sigma = A.shape[0], -0.7
    op = ops.ShiftedOperator(tam.Matrix(A, device="cpu"), sigma)
    assert op.fmt == "op" and ops.as_operator(op) is op
    slv = tam.create_solver(tam.AMGConfig(PCG))
    slv.setup(op)
    b = np.ones(n)
    reset_dispatch()
    res = slv.solve(b)
    x = res.x.numpy()
    Ashift = (A - sigma * sp.identity(n)).tocsr()
    assert res.status == 0
    assert np.linalg.norm(b - Ashift @ x) / np.linalg.norm(b) < 1e-8
    assert DISPATCH["op"] > 0 and DISPATCH["op"] == DISPATCH["dia/slices"]
    js = amgx_tpu.create_solver(amgx_tpu.AMGConfig(PCG))
    js.setup(jops.ShiftedOperator(amgx_tpu.Matrix(A), sigma))
    rj = js.solve(b)
    assert res.iterations == rj.iterations
    np.testing.assert_allclose(
        np.asarray(res.residual_history).ravel(),
        np.asarray(rj.residual_history).ravel(), rtol=1e-10, atol=1e-12)
    # AMG needs the host matrix: an operator is refused
    amg = tam.create_solver(tam.AMGConfig(
        "config_version=2, solver(a)=AMG, a:algorithm=AGGREGATION"))
    with pytest.raises(BadConfigurationError):
        amg.setup(op)


def test_deflated_apply(A):
    n = A.shape[0]
    rng = np.random.default_rng(0)
    V = np.linalg.qr(rng.standard_normal((n, 2)))[0]
    lam = np.array([3.0, 0.5])
    v = rng.standard_normal(n)
    op = ops.DeflatedOperator(tam.Matrix(A, device="cpu"), V, lam)
    got = spmv(op, torch.from_numpy(v)).numpy()
    want = A @ v - V @ (lam * (V.T @ v))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    jop = jops.DeflatedOperator(amgx_tpu.Matrix(A), V, lam)
    np.testing.assert_allclose(got, np.array(jspmv(jop, jnp.asarray(v))),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(op.diag.numpy(), np.array(jop.diag),
                               rtol=1e-14)


def test_pagerank_apply():
    n = 300
    W = sp.random(n, n, density=0.03, random_state=np.random.RandomState(4),
                  format="csr")
    W = W.tolil()
    W[7, :] = 0                       # a dangling page
    W = sp.csr_matrix(W)
    op = ops.PageRankOperator(W, 0.85, device="cpu")
    jop = jops.PageRankOperator(W, 0.85)
    x = np.random.default_rng(1).random(n).astype(np.float32)
    x /= x.sum()
    got = spmv(op, torch.from_numpy(x)).numpy()
    want = np.array(jspmv(jop, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-9)
    assert got.dtype == np.float32
    assert abs(float(got.sum()) - 1.0) < 1e-5
    # (1 − α)/n teleport + α(Sᵀx + dangling/n): the f64 formula
    deg = np.asarray(W.sum(axis=1)).ravel()
    P = sp.diags(np.where(deg > 0, 1 / np.where(deg > 0, deg, 1), 0)) @ W
    x64 = x.astype(np.float64)
    ref = 0.85 * (P.T @ x64 + x64[deg == 0].sum() / n) + 0.15 * x64.sum() / n
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            ops.PageRankOperator(W, 0.85)      # the card by default


def test_solver_operator(A):
    slv = tam.create_solver(tam.AMGConfig(PCG))
    slv.setup(tam.Matrix(A, device="cpu"))
    b = torch.ones(A.shape[0], dtype=torch.float64)
    sop = ops.SolverOperator(slv)
    np.testing.assert_array_equal(sop.apply(b).numpy(),
                                  slv.solve(b).x.numpy())

"""One fixed order for every L1 row sum (``ops/ordered.py::sum_along`` and
``segment_sum``): the L1-Jacobi diagonal of every pack kind and the
classical setup's row sums run as ordered elementwise adds on any
device, never a library reduction or an atomic ``index_add_`` (whose
order on the card differs from the CPU's).  Held here against the JAX
package's ``abs_rowsum`` and L1-Jacobi on the CPU (f64 to 1e-14), and
the classical setup and its counts against the JAX package.  The card
side (x bit-equal to the CPU's) is ``chip_smoke.py`` phases 11, 28 and
31."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
from amgx_tpu.io import poisson7pt as jax_poisson7pt

import amgx_tpu_torch as amgx
from amgx_tpu_torch.core.matrix import pack_device, pack_kind
from amgx_tpu_torch.io import poisson7pt
from amgx_tpu_torch.ops.ordered import segment_sum, sum_along
from amgx_tpu_torch.ops.spmv import abs_rowsum

#: f64 row sums of the same terms in another order
SUM_RTOL = 1e-14

CLA = ("config_version=2, solver(out)=PCG, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
       "amg:algorithm=CLASSICAL, amg:selector=PMIS, "
       "amg:interpolator=D2, amg:max_iters=1, "
       "amg:interp_max_elements=4, amg:max_row_sum=0.9, "
       "amg:max_levels=16, amg:smoother(sm)=JACOBI_L1, "
       "sm:max_iters=1, amg:presweeps=2, amg:postsweeps=2, "
       "amg:min_coarse_rows=32, amg:coarse_solver=DENSE_LU_SOLVER, "
       "amg:strength_threshold=0.2401")


def test_sum_along_adds_left_to_right():
    """Each slice added in turn: the same bits as a Python loop."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (9, 50)).astype(np.float32))
    want = v[0].clone()
    for k in range(1, 9):
        want = want + v[k]
    assert torch.equal(sum_along(v, 0), want)
    assert torch.equal(sum_along(v.T.contiguous(), 1), want)
    assert sum_along(torch.zeros((0, 4))).shape == (4,)


def test_segment_sum_matches_scatter_and_is_order_stable():
    rng = np.random.default_rng(1)
    seg = torch.from_numpy(rng.integers(0, 40, 500))
    vals = torch.from_numpy(rng.standard_normal(500))
    got = segment_sum(vals, seg, 45)
    want = torch.zeros(45, dtype=torch.float64).index_add_(0, seg, vals)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SUM_RTOL,
                               atol=1e-15)
    assert not got[40:].any()
    # a batch of rows sums each row alike
    both = segment_sum(torch.stack([vals, 2 * vals]), seg, 45)
    assert torch.equal(both[0], got) and torch.equal(both[1], 2 * got)


def _packs():
    """(label, port pack, host scalar CSR) per pack kind."""
    rng = np.random.default_rng(2)
    A = sp.random(1500, 1500, density=0.01, random_state=3, format="csr")
    A = sp.csr_matrix(A + A.T + 8.0 * sp.identity(1500))
    wide = A.tolil()
    wide[17] = rng.standard_normal(1500) * (rng.random(1500) < 0.3)
    wide = sp.csr_matrix(wide)
    B = sp.random(300, 300, density=0.02, random_state=4, format="csr")
    B = sp.csr_matrix(B + sp.identity(300))
    Bb = sp.bsr_matrix(sp.kron(B, np.ones((3, 3))
                               + np.eye(3)).tocsr(), blocksize=(3, 3))
    P = sp.csr_matrix(poisson7pt(8, 8, 8))
    P2 = sp.kron(P, np.ones((2, 2)) + np.eye(2)).tocsr()
    cpu = dict(device="cpu")
    return [
        ("dia", pack_device(P, 1, np.float64, **cpu), P),
        ("ell", pack_device(A, 1, np.float64, dia_max_diags=0, **cpu), A),
        ("csr", pack_device(wide, 1, np.float64, dia_max_diags=0,
                            ell_max_width=64, **cpu), wide),
        ("block", pack_device(Bb, 3, np.float64, dia_max_diags=0, **cpu),
         sp.csr_matrix(Bb)),
        ("block-dia", pack_device(sp.bsr_matrix(P2, blocksize=(2, 2)), 2,
                                  np.float64, **cpu), P2),
    ]


@pytest.mark.parametrize("case", range(5))
def test_abs_rowsum_every_pack_without_scatter(case, monkeypatch):
    """The L1 row sums of each pack kind equal the host's Σ_j |a_ij|,
    with ``index_add_`` and the float reductions forbidden."""
    label, Ad, host = _packs()[case]
    want = np.asarray(abs(host).sum(axis=1)).ravel()

    def boom(*a, **k):
        raise AssertionError("an unordered reduction in abs_rowsum")

    real_sum = torch.Tensor.sum

    def float_sum(self, *a, **k):
        if self.is_floating_point():
            boom()
        return real_sum(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "index_add_", boom)
    monkeypatch.setattr(torch.Tensor, "sum", float_sum)
    monkeypatch.setattr(torch, "sum", lambda *a, **k: boom())
    got = abs_rowsum(Ad).numpy()
    monkeypatch.undo()
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, err_msg=(
        label, pack_kind(Ad)))


def test_l1_jacobi_and_counts_match_jax(monkeypatch):
    """The classical hierarchy's JACOBI_L1 diagonals on every level
    (device pipeline, ``dia3`` level, compact ELL levels, host tail)
    against the JAX package's at 16³ in f64 (rtol 1e-12; the pipeline's
    tail cut at 300 rows in both packages, so a small grid takes every
    path), and the same iteration count (the CPU parity counts did not
    move: the f32 counts are held in tests/test_torch_classical.py)."""
    monkeypatch.setenv("AMGX_PIPELINE_TAIL_ROWS", "300")
    mj = jx.Matrix(jax_poisson7pt(16, 16, 16))
    sj = jx.create_solver(jx.AMGConfig(CLA))
    sj.setup(mj)
    rj = sj.solve(np.ones(16 ** 3))
    mp = amgx.Matrix(poisson7pt(16, 16, 16), device="cpu")
    sp_ = amgx.create_solver(CLA)
    sp_.setup(mp)
    rp = sp_.solve(np.ones(16 ** 3))
    assert rp.iterations == rj.iterations
    lj = sj.preconditioner.hierarchy.levels
    lp = sp_.preconditioner.hierarchy.levels
    assert [lv.Ad.fmt for lv in lp] == [lv.Ad.fmt for lv in lj]
    assert [lv.Ad.fmt for lv in lp][:3] == ["dia", "dia3", "ell"]
    for a, b in zip(lj, lp):
        dj = np.asarray(a.smoother.dinv)
        dp = b.smoother.dinv.numpy()
        n = min(dj.shape[0], dp.shape[0])
        np.testing.assert_allclose(dp[:n], dj[:n], rtol=1e-12)


def test_classical_setup_runs_no_unordered_float_reduction(monkeypatch):
    """The device classical setup (pipeline level 1, compact levels) and
    the smoothers' setup sum their rows with ordered adds: a float
    ``Tensor.sum``/``torch.sum``, or an ``index_add_`` that adds two
    nonzero float terms into one target, raises here."""
    real_sum, real_add = torch.Tensor.sum, torch.Tensor.index_add_

    def float_sum(self, *a, **k):
        assert not self.is_floating_point(), "float Tensor.sum in setup"
        return real_sum(self, *a, **k)

    def torch_sum(x, *a, **k):
        assert not x.is_floating_point(), "float torch.sum in setup"
        return real_sum(x, *a, **k)

    def index_add(self, dim, index, source, *a, **k):
        # exact in any order: integer-valued counts, or at most one
        # nonzero term a target (a scatter into a table)
        if source.is_floating_point() and not bool(
                torch.all(source == torch.round(source))):
            hit = index[source != 0]
            assert hit.unique().numel() == hit.numel(), "float index_add_"
        return real_add(self, dim, index, source, *a, **k)

    monkeypatch.setenv("AMGX_PIPELINE_TAIL_ROWS", "300")
    m = amgx.Matrix(poisson7pt(16, 16, 16), device="cpu")
    m.device_dtype = np.float32
    s = amgx.create_solver(CLA)
    monkeypatch.setattr(torch.Tensor, "sum", float_sum)
    monkeypatch.setattr(torch, "sum", torch_sum)
    monkeypatch.setattr(torch.Tensor, "index_add_", index_add)
    s.setup(m)
    monkeypatch.undo()
    fmts = [lv.Ad.fmt for lv in s.preconditioner.hierarchy.levels]
    assert fmts[:3] == ["dia", "dia3", "ell"], fmts

"""The classical AMG setup algorithms of the port on the CPU against the
JAX package, f64, on the 7-point Poisson 10³ (the cases of
tests/test_amg.py:115-123, and the rest of the JAX package's names):

* the selectors HMIS, RS, AGGRESSIVE_PMIS, AGGRESSIVE_HMIS, DUMMY and CR,
  the MULTIPASS and EM interpolators, AFFINITY strength,
  ``algorithm=ENERGYMIN`` (CR + EM) and ``aggressive_levels=1`` with
  ``aggressive_selector=DEFAULT`` (AGGRESSIVE_PMIS + MULTIPASS on level
  0, which the device classical paths must not take): every level's
  ``cf_map`` bit-equal, P within 1e-12, the count equal, x within 1e-8;
* the EM interpolator's chunking invariance (tests/test_amg.py:449);
* ``error_scaling`` 2 and 3 (tests/test_amg.py:256): equal counts, the
  scaling λ a 0-d tensor and an application free of host syncs (what a
  CUDA graph capture needs; the replay itself is checked on the card,
  tests/test_torch_cuda.py);
* the registries name for name equal to the JAX package's."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu
from amgx_tpu.io import poisson5pt, poisson7pt

import amgx_tpu_torch as amgx
from amgx_tpu_torch.errors import SolveStatus

#: interpolation weights of the same formulas in other summation orders
P_RTOL = 1e-12
#: f64 solutions of the two packages
X_RTOL = 1e-8

BASE = ("config_version=2, solver(out)=PCG, out:max_iters=60, "
        "out:monitor_residual=1, out:tolerance=1e-8, "
        "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
        "amg:algorithm={alg}, amg:selector={sel}, amg:max_iters=1, "
        "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, amg:presweeps=2, "
        "amg:postsweeps=2, amg:min_coarse_rows=16, amg:max_levels=20, "
        "amg:coarse_solver=DENSE_LU_SOLVER")

CASES = {
    # tests/test_amg.py:115-123
    "SIZE_2": ("AGGREGATION", "SIZE_2", ""),
    "SIZE_4": ("AGGREGATION", "SIZE_4", ""),
    "MULTI_PAIRWISE": ("AGGREGATION", "MULTI_PAIRWISE", ""),
    "PMIS-D1": ("CLASSICAL", "PMIS", ", amg:interpolator=D1"),
    "PMIS-D2": ("CLASSICAL", "PMIS", ", amg:interpolator=D2"),
    "HMIS-D1": ("CLASSICAL", "HMIS", ", amg:interpolator=D1"),
    "AGGRESSIVE_PMIS-MULTIPASS": ("CLASSICAL", "AGGRESSIVE_PMIS",
                                  ", amg:interpolator=MULTIPASS"),
    # the other names
    "RS-D1": ("CLASSICAL", "RS", ", amg:interpolator=D1"),
    "AGGRESSIVE_HMIS-MULTIPASS": ("CLASSICAL", "AGGRESSIVE_HMIS",
                                  ", amg:interpolator=MULTIPASS"),
    "DUMMY-D1": ("CLASSICAL", "DUMMY", ", amg:interpolator=D1"),
    "CR-D2": ("CLASSICAL", "CR", ", amg:interpolator=D2"),
    "PMIS-EM": ("CLASSICAL", "PMIS", ", amg:interpolator=EM"),
    "AFFINITY": ("CLASSICAL", "PMIS",
                 ", amg:interpolator=D1, amg:strength=AFFINITY"),
    "ENERGYMIN": ("ENERGYMIN", "PMIS", ", determinism_flag=1"),
    "aggressive_levels": ("CLASSICAL", "PMIS",
                          ", amg:interpolator=D2, amg:aggressive_levels=1, "
                          "amg:aggressive_selector=DEFAULT"),
}


def _pair(cfg, A):
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    ref.setup(amgx_tpu.Matrix(A))
    slv = amgx.create_solver(cfg)
    slv.setup(amgx.Matrix(A, device="cpu"))
    return ref, slv


def _rel(X, Y):
    X, Y = sp.csr_matrix(X), sp.csr_matrix(Y)
    return abs(X - Y).max() / max(abs(Y).max(), 1e-300)


@pytest.mark.parametrize("case", sorted(CASES))
def test_setup_algorithm_matches_jax(case):
    alg, sel, extra = CASES[case]
    A = sp.csr_matrix(poisson7pt(10, 10, 10))
    ref, slv = _pair(BASE.format(alg=alg, sel=sel) + extra, A)
    hj = ref.preconditioner.hierarchy
    hp = slv.preconditioner.hierarchy
    assert len(hp.levels) == len(hj.levels) >= 2
    for lp, lj in zip(hp.levels, hj.levels):
        assert lp.kind == lj.kind
        if lp.kind == "classical":
            np.testing.assert_array_equal(lp.cf_map, lj.A.cf_map)
            Pp, Pj = lp._P.host, lj._Pm.host
            assert _rel(Pp, Pj) <= P_RTOL
        else:
            np.testing.assert_array_equal(lp.aggregates.numpy(),
                                          np.asarray(lj.aggregates))
    b = np.ones(A.shape[0])
    want, got = ref.solve(b), slv.solve(b)
    assert got.status == SolveStatus.SUCCESS
    assert got.iterations == want.iterations
    w = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), w, rtol=X_RTOL,
                               atol=X_RTOL * np.abs(w).max())


def test_aggressive_level_leaves_the_device_path(monkeypatch):
    """``aggressive_levels=1`` on a DIA fine level: level 0 coarsens by
    AGGRESSIVE_PMIS + MULTIPASS on the host (the device classical gates
    read the effective names), the levels below by PMIS + D2."""
    from amgx_tpu_torch.amg import hierarchy as H
    calls = []
    real = H.AMGHierarchy._coarsen_classical_device_fine

    def spy(self, cur, idx, sname, sel, interp):
        out = real(self, cur, idx, sname, sel, interp)
        calls.append((idx, sel, interp, out is not None))
        return out
    monkeypatch.setattr(H.AMGHierarchy, "_coarsen_classical_device_fine",
                        spy)
    alg, sel, extra = CASES["aggressive_levels"]
    slv = amgx.create_solver(BASE.format(alg=alg, sel=sel) + extra)
    slv.setup(amgx.Matrix(poisson7pt(10, 10, 10), device="cpu"))
    assert calls[0] == (0, "AGGRESSIVE_PMIS", "MULTIPASS", False)
    assert all(c[1:3] == ("PMIS", "D2") for c in calls[1:])


def test_energymin_chunking_invariance():
    """EM processes F rows in chunks; each row's local solve is
    independent, so P is identical for any chunk size."""
    from amgx_tpu_torch.amg.classical.interpolators import \
        create_interpolator
    from amgx_tpu_torch.amg.classical.selectors import _pmis
    from amgx_tpu_torch.amg.classical.strength import create_strength
    from amgx_tpu_torch.amg.energymin.interpolator import \
        EnergyMinInterpolator
    from amgx_tpu_torch.config import AMGConfig
    A = sp.csr_matrix(poisson5pt(14, 11)).astype(np.float64)
    cfg = AMGConfig()
    S = create_strength("AHAT", cfg, "default").compute(A)
    cf = _pmis(S, seed=3)

    def run(chunk):
        interp = create_interpolator("EM", cfg, "default")
        assert isinstance(interp, EnergyMinInterpolator)
        interp.f_chunk = chunk
        return interp.compute(A, S, cf).tocsr()

    P_big = run(1 << 20)
    for chunk in (1, 7, 64):
        P_c = run(chunk)
        assert np.array_equal(P_big.indptr, P_c.indptr)
        assert np.array_equal(P_big.indices, P_c.indices)
        assert np.array_equal(P_big.data, P_c.data)


ES = ("config_version=2, solver(out)=FGMRES, out:max_iters=60, "
      "out:monitor_residual=1, out:tolerance=1e-8, "
      "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
      "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, amg:max_iters=1, "
      "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, amg:presweeps=1, "
      "amg:postsweeps=1, amg:min_coarse_rows=32, "
      "amg:coarse_solver=DENSE_LU_SOLVER, amg:error_scaling={mode}")


@pytest.mark.parametrize("mode", [2, 3])
def test_error_scaling_matches_jax(mode):
    """tests/test_amg.py:256: the λ-scaled coarse correction, equal
    counts and x; an application makes no host sync and applies twice
    to the same bits."""
    from amgx_tpu_torch import device
    from amgx_tpu_torch.amg.cycles import _scaling_lambda
    A = sp.csr_matrix(poisson7pt(10, 10, 10))
    ref, slv = _pair(ES.format(mode=mode), A)
    b = np.ones(A.shape[0])
    want, got = ref.solve(b), slv.solve(b)
    assert got.status == SolveStatus.SUCCESS
    assert got.iterations == want.iterations
    w = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), w, rtol=X_RTOL,
                               atol=X_RTOL * np.abs(w).max())
    pre = slv.preconditioner
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.shape[0]))
    syncs = dict(device.HOST_SYNCS)
    z1, z2 = pre.apply(r), pre.apply(r)
    assert dict(device.HOST_SYNCS) == syncs
    assert torch.equal(z1, z2)
    e = torch.ones(4, dtype=torch.float64)
    lam = _scaling_lambda(e, e, 2 * e, mode)
    assert lam.dim() == 0 and float(lam) == 0.5
    assert float(_scaling_lambda(e, e, 100 * e, mode)) == 0.3
    assert float(_scaling_lambda(e, 0 * e, 0 * e, mode)) == 1.0


def test_registries_equal_jax():
    from amgx_tpu.amg.classical import interpolators as ji
    from amgx_tpu.amg.classical import selectors as js
    from amgx_tpu.amg.classical import strength as jst

    from amgx_tpu_torch.amg.classical import interpolators as pi
    from amgx_tpu_torch.amg.classical import selectors as ps
    from amgx_tpu_torch.amg.classical import strength as pst
    assert sorted(ps._selector_registry) == sorted(js._selector_registry) \
        == sorted(["PMIS", "HMIS", "RS", "AGGRESSIVE_PMIS",
                   "AGGRESSIVE_HMIS", "DUMMY", "CR"])
    assert sorted(pi._interp_registry) == sorted(ji._interp_registry) \
        == ["D1", "D2", "EM", "MULTIPASS"]
    assert sorted(pst._strength_registry) == \
        sorted(jst._strength_registry) == ["AFFINITY", "AHAT", "ALL"]
    from amgx_tpu.config import registry as jreg

    from amgx_tpu_torch.config import registry as preg
    assert sorted(preg._ALGOS) == sorted(jreg._ALGOS) == \
        ["AGGREGATION", "CLASSICAL", "ENERGYMIN"]

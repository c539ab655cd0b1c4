"""Colored smoothers and DILU on sharded packs (``amgx_tpu_torch.solvers.
gs``, ``dilu``, ``ilu``) held against the JAX package on the CPU: DILU,
the GS family and Kaczmarz as smoothers of sharded aggregation AMG, the
sweeps' halo exchanges (none a DILU apply, one a GS sweep), Kaczmarz's
true transpose on an unsymmetric matrix, block DILU under PBICGSTAB on
4×4 blocks, setup from per-rank blocks alone, and MULTICOLOR_ILU's
refusal.  The JAX side runs on the 8-device virtual CPU mesh of
``tests/conftest.py``; sizes stay at 12³ or less."""
import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
from amgx_tpu.io import poisson5pt, poisson7pt

import amgx_tpu_torch as amgx
from amgx_tpu_torch.distributed import matrix as tdm
from amgx_tpu_torch.errors import BadConfigurationError
from amgx_tpu.errors import BadConfigurationError as JBadConfigurationError

#: tests/test_distributed.py:345-370
AGG_SMOOTHER = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
    "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, amg:max_iters=1, "
    "amg:smoother(sm)={sm}, sm:max_iters=1, amg:presweeps=1, "
    "amg:postsweeps=1, amg:min_coarse_rows=16, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
#: tests/test_distributed.py:663-700
CFG4 = ("config_version=2, solver(out)=PBICGSTAB, out:max_iters=200, "
        "out:monitor_residual=1, out:tolerance=1e-8, "
        "out:convergence=RELATIVE_INI, "
        "out:preconditioner(pre)=MULTICOLOR_DILU, pre:max_iters=1")
#: x tolerance of the solves: relative to x's largest entry
X_TOL = 1e-10


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((8,), ("p",))


@pytest.fixture(scope="module")
def tmesh():
    return tdm.make_mesh(8, device="cpu")


def _both(cfg, A, jmesh, tmesh, block_dim=1, blocks=None):
    b = np.ones(A.shape[0])
    out = []
    for mod, mesh, kw in ((jx, jmesh, {}), (amgx, tmesh, {"device": "cpu"})):
        if blocks is not None:
            m = mod.Matrix(**kw)
            m.set_distributed_blocks(blocks[0], blocks[1], mesh)
        else:
            m = mod.Matrix(A, block_dim=block_dim, **kw)
            m.set_distribution(mesh)
        s = mod.create_solver(cfg if mod is amgx else mod.AMGConfig(cfg))
        s.setup(m)
        out.append((s, s.solve(b)))
    (sj, rj), (st, rt) = out
    assert rt.iterations == int(rj.iterations)
    assert int(rt.status) == int(rj.status)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=X_TOL * np.abs(xj).max())
    return st, rt


@pytest.mark.parametrize("sm", ["MULTICOLOR_DILU", "MULTICOLOR_GS"])
def test_colored_smoothers_in_sharded_amg_match_jax(sm, jmesh, tmesh):
    """Sharded aggregation AMG with a colored smoother at 8³ on 8
    shards (``tests/test_distributed.py:345-370``): the JAX package's
    count and x; every level's smoother reads the sharded pack (GS its
    per-shard slabs of the extended vector; GS, FIXCOLOR_GS and
    KACZMARZ are held as preconditioners in
    ``tests/test_torch_distributed.py``)."""
    st, rt = _both(AGG_SMOOTHER.format(sm=sm), poisson7pt(8, 8, 8),
                   jmesh, tmesh)
    assert int(rt.status) == 0
    sm0 = st.preconditioner.hierarchy.levels[0].smoother
    if sm == "MULTICOLOR_GS":
        assert sm0.dist_slabs is not None
    else:
        assert sm0.L_slabs and sm0.Ad.fmt == "sharded-ell"


def test_gs_l1_variant_on_sharded_pack_matches_jax(jmesh, tmesh):
    """MULTICOLOR_GS with ``GS_L1_variant`` and ``symmetric_GS`` as a
    PCGF preconditioner on a sharded pack: the JAX package's count and
    x."""
    cfg = ("config_version=2, solver(s)=PCGF, s:max_iters=100, "
           "s:monitor_residual=1, s:tolerance=1e-8, "
           "s:convergence=RELATIVE_INI, s:preconditioner(p)=MULTICOLOR_GS, "
           "p:max_iters=2, p:GS_L1_variant=1, p:symmetric_GS=1")
    _both(cfg, poisson7pt(8, 8, 8), jmesh, tmesh)


def _count_exchanges(monkeypatch):
    calls = []
    orig = tdm._exchange

    def counted(*a):
        calls.append(1)
        return orig(*a)

    monkeypatch.setattr(tdm, "_exchange", counted)
    return calls


def test_dilu_sweeps_make_no_exchange_gs_one(tmesh, monkeypatch):
    """A DILU apply on a sharded pack makes no halo exchange (each rank's
    local factorisation, the slabs of the flat vector); a GS sweep makes
    exactly one, whatever its color count (``tests/test_distributed.py:
    583-623``)."""
    A = poisson7pt(8, 8, 8)
    out = {}
    for name in ("MULTICOLOR_DILU", "MULTICOLOR_GS"):
        m = amgx.Matrix(A, device="cpu")
        m.set_distribution(tmesh)
        s = amgx.create_solver(f"config_version=2, solver(out)={name}, "
                               "out:max_iters=2, out:monitor_residual=1")
        s.setup(m)
        assert s.num_colors > 1
        out[name] = s
    r = tdm.shard_vector(out["MULTICOLOR_DILU"].Ad, np.ones(A.shape[0]))
    calls = _count_exchanges(monkeypatch)
    out["MULTICOLOR_DILU"]._apply_dilu(r)
    assert calls == []
    gs = out["MULTICOLOR_GS"]
    gs._color_sweep(r, r, range(gs.num_colors))
    assert len(calls) == 1
    # the slabs hold each rank-local off-diagonal entry once
    # (O(nnz_shard), not a masked full-width sweep)
    dl = out["MULTICOLOR_DILU"]
    offs = dl.Ad.offsets
    local = sum(sp.csr_matrix(blk)[:, offs[p]:offs[p + 1]].nnz
                for p, blk in enumerate(dl.A.rank_blocks()))
    stored = sum(int((s.vals != 0).sum()) for s in dl.L_slabs + dl.U_slabs)
    assert stored == local - A.shape[0]


def test_kaczmarz_true_transpose_unsymmetric(jmesh, tmesh):
    """Distributed KACZMARZ builds the true per-rank transpose pack: on a
    structurally unsymmetric matrix its projections match the JAX
    package's and the single-device solver's (``tests/test_distributed.
    py:530-556``)."""
    A = sp.csr_matrix(poisson5pt(8, 8)).tolil()
    A[0, 5] = 0.3
    A[5, 0] = 0.0
    A = sp.csr_matrix(A)
    b = np.sin(np.arange(A.shape[0]))
    cfg = ("config_version=2, solver(out)=KACZMARZ, out:max_iters=8, "
           "out:monitor_residual=1")
    s1 = amgx.create_solver(cfg)
    s1.setup(amgx.Matrix(A, device="cpu"))
    x1 = s1.solve(b).x.numpy()
    mj = jx.Matrix(A)
    mj.set_distribution(jmesh)
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(mj)
    xj = np.asarray(sj.solve(b).x)
    mt = amgx.Matrix(A, device="cpu")
    mt.set_distribution(tmesh)
    st = amgx.create_solver(cfg)
    st.setup(mt)
    assert st.AdT is not st.Ad and st.AdT.fmt == "sharded-ell"
    xt = st.solve(b).x.numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(xt, x1, rtol=1e-8, atol=1e-10)


def test_block_kaczmarz_warns_without_structural_symmetry(tmesh, capsys):
    """A b×b sharded Kaczmarz stands A in for Aᵀ, as upstream, and says
    so when the pattern is not symmetric."""
    A = sp.csr_matrix(poisson5pt(6, 6)).tolil()
    A[0, 5] = 0.3
    A = sp.kron(sp.csr_matrix(A), np.eye(2)).tocsr()
    m = amgx.Matrix(A, block_dim=2, device="cpu")
    m.set_distribution(tmesh)
    s = amgx.create_solver("config_version=2, solver(out)=KACZMARZ, "
                           "out:max_iters=2")
    s.setup(m)
    assert s.AdT is s.Ad
    assert "NOT structurally symmetric" in capsys.readouterr().out


def test_block_dilu_pbicgstab_matches_jax(jmesh, tmesh):
    """BASELINE config 4 on the mesh: kron(poisson7pt(10,10,10), I₄)
    under PBICGSTAB + MULTICOLOR_DILU in 8 shards (per-rank local-block
    factorisation, zero-exchange block slabs): the JAX package's count
    and x."""
    A4 = sp.kron(poisson7pt(10, 10, 10), sp.identity(4)).tocsr()
    st, rt = _both(CFG4, A4, jmesh, tmesh, block_dim=4)
    assert int(rt.status) == 0
    assert st.Ad.block_dim == 4 and st.preconditioner.block


@pytest.mark.parametrize("sm", ["MULTICOLOR_DILU", "MULTICOLOR_GS"])
def test_smoother_setup_from_blocks_only(sm, tmesh, monkeypatch):
    """From per-rank blocks (``set_distributed_blocks``) the colorings
    (each rank's own), factorisations and slabs read no global matrix,
    and the solve converges (``tests/test_distributed.py:626-660``)."""
    A = sp.csr_matrix(poisson7pt(8, 8, 8))
    n = A.shape[0]
    offs = np.minimum(np.arange(9) * (-(-n // 8)), n)
    bl = [sp.csr_matrix(A[offs[p]:offs[p + 1]]) for p in range(8)]
    assembled = []
    orig = amgx.Matrix.assemble_global

    def spy(self):
        assembled.append(self.shape[0])
        return orig(self)

    monkeypatch.setattr(amgx.Matrix, "assemble_global", spy)
    m = amgx.Matrix(device="cpu")
    m.set_distributed_blocks(bl, offs, tmesh)
    s = amgx.create_solver(AGG_SMOOTHER.format(sm=sm))
    s.setup(m)
    r = s.solve(np.ones(n))
    relres = np.linalg.norm(1 - A @ r.x.numpy()) / np.sqrt(n)
    assert int(r.status) == 0 and relres < 1e-7, (relres, r.iterations)
    assert not assembled or max(assembled) <= n // 4, assembled


def test_multicolor_ilu_refuses_sharded_pack_as_jax(jmesh, tmesh):
    """MULTICOLOR_ILU on a sharded pack raises the JAX package's error
    class with its code (``ilu.py:117-120``)."""
    A = poisson7pt(6, 6, 6)
    cfg = ("config_version=2, solver(s)=PCGF, s:max_iters=10, "
           "s:preconditioner(p)=MULTICOLOR_ILU")
    mj = jx.Matrix(A)
    mj.set_distribution(jmesh)
    with pytest.raises(JBadConfigurationError) as ej:
        jx.create_solver(jx.AMGConfig(cfg)).setup(mj)
    mt = amgx.Matrix(A, device="cpu")
    mt.set_distribution(tmesh)
    with pytest.raises(BadConfigurationError) as et:
        amgx.create_solver(cfg).setup(mt)
    assert int(et.value.rc) == int(ej.value.rc)
    assert str(et.value) == str(ej.value)
    assert torch.is_tensor(mt.device().vals)

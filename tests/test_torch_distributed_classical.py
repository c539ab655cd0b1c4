"""Per-rank distributed classical AMG (``amgx_tpu_torch.amg.classical.
distributed``, ``hierarchy._coarsen_classical_dist``, the engine's
``galerkin_dist``) held against the JAX package on the CPU: each piece
on the same rank blocks (the extended blocks, strength, PMIS, coarse
numbering, D1/D2 interpolation, RAP), the ``_CLA_DIST_CFG`` stack of
``tests/test_distributed.py:372-380`` with every level's coarse offsets
and operators, the global fallback (HMIS, MULTIPASS, ENERGYMIN), a
resetup and ``amg_host_levels_rows`` on a distributed hierarchy, and
the never-assembles-global contract.  The JAX side runs on the 8-device
virtual CPU mesh of ``tests/conftest.py``; sizes stay at 12³ or less."""
import importlib

import jax
import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu as jx
from amgx_tpu.amg.classical import distributed as jcd
from amgx_tpu.amg.classical.interpolators import \
    create_interpolator as jinterp
from amgx_tpu.amg.classical.strength import create_strength as jstrength
from amgx_tpu.distributed import partition as jpart
from amgx_tpu.io import poisson7pt

import amgx_tpu_torch as amgx
from amgx_tpu_torch.amg.classical import distributed as tcd
from amgx_tpu_torch.amg.classical.interpolators import \
    create_interpolator as tinterp
from amgx_tpu_torch.amg.classical.strength import \
    create_strength as tstrength
from amgx_tpu_torch.amg.device_setup import engine as tengine
from amgx_tpu_torch.amg.device_setup import reset_engine
from amgx_tpu_torch.config import AMGConfig
from amgx_tpu_torch.distributed import matrix as tdm
from amgx_tpu_torch.distributed import partition as tpart

#: the JAX package's engine module (its package exports a function of
#: the module's name)
jengine = importlib.import_module("amgx_tpu.amg.device_setup.engine")

#: tests/test_distributed.py:372-380 word for word
CLA_DIST_CFG = (
    "config_version=2, solver(out)=PCG, out:max_iters=60, "
    "out:monitor_residual=1, out:tolerance=1e-10, "
    "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
    "amg:algorithm=CLASSICAL, amg:selector=PMIS, amg:interpolator={interp}, "
    "amg:max_iters=1, amg:interp_max_elements=4, amg:max_row_sum=0.9, "
    "amg:max_levels=6, amg:smoother(sm)=JACOBI_L1, sm:max_iters=1, "
    "amg:presweeps=1, amg:postsweeps=1, amg:min_coarse_rows=8, "
    "amg:coarse_solver=DENSE_LU_SOLVER, determinism_flag=1")
#: x tolerance of the solves: relative to x's largest entry (the two
#: packages sum the Krylov dots and the RAP partials in other orders)
X_TOL = 1e-10


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((8,), ("p",))


@pytest.fixture(scope="module")
def tmesh():
    return tdm.make_mesh(8, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_engine():
    reset_engine()
    yield
    reset_engine()


def _blocks(side=10, n_parts=8):
    A = sp.csr_matrix(poisson7pt(side, side, side))
    offsets = np.linspace(0, A.shape[0], n_parts + 1).astype(np.int64)
    blocks = tpart.split_row_blocks(A, offsets)
    part = tpart.build_partition_from_blocks(blocks, offsets, n_rings=2)
    return A, offsets, blocks, part


def _eq_csr(a, b, tol=0.0):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    d = abs(a - b)
    assert (d.max() if d.nnz else 0.0) <= tol * max(abs(b).max(), 1e-300)


@pytest.mark.parametrize("interp", ["D1", "D2"])
def test_classical_pieces_match_jax(interp):
    """Each per-rank step against its JAX function on the same rank
    blocks: the extended universe and rows, strength, PMIS's C/F maps,
    the coarse offsets and numbering, the P blocks and the RAP's coarse
    and R blocks (host products, and the engine's shard-local form)."""
    A, offsets, blocks, part = _blocks()
    jp = jpart.build_partition_from_blocks(blocks, offsets, n_rings=2)
    n = A.shape[0]
    jcfg, tcfg = jx.AMGConfig(CLA_DIST_CFG.format(interp=interp)), \
        AMGConfig(CLA_DIST_CFG.format(interp=interp))
    jex = [jcd.RankExtended(p, blocks, jp) for p in range(8)]
    tex = [tcd.RankExtended(p, blocks, part) for p in range(8)]
    for je, te in zip(jex, tex):
        np.testing.assert_array_equal(te.universe, je.universe)
        _eq_csr(te.A_U, je.A_U)
    jS = jcd.strength_distributed(jex, [jstrength("AHAT", jcfg, "amg")] * 8)
    tS = tcd.strength_distributed(tex, [tstrength("AHAT", tcfg, "amg")] * 8)
    for a, b in zip(tS, jS):
        _eq_csr(a, b)
    jcf, jx_ex = jcd.pmis_distributed(jex, jS, n, 7)
    tcf, tx_ex = tcd.pmis_distributed(tex, tS, n, 7)
    for a, b in zip(tcf, jcf):
        np.testing.assert_array_equal(a, b)
    nc = int(sum(c.sum() for c in tcf))
    jc = jcd.coarse_numbering_distributed(jex, jcf, n, jx_ex)
    tc = tcd.coarse_numbering_distributed(tex, tcf, n, tx_ex)
    np.testing.assert_array_equal(tc[0], jc[0])
    for k in (1, 2):
        for a, b in zip(tc[k], jc[k]):
            np.testing.assert_array_equal(a, b)
    jP = jcd.interpolate_distributed(jex, jinterp(interp, jcfg, "amg"),
                                     jc[1], jc[2], jS, nc)
    tP = tcd.interpolate_distributed(tex, tinterp(interp, tcfg, "amg"),
                                     tc[1], tc[2], tS, nc)
    for a, b in zip(tP, jP):
        _eq_csr(a, b, 1e-15)
    jC, jR = jcd.rap_distributed(blocks, jP, jp, jc[0])
    for engine in (None, tengine()):
        tC, tR = tcd.rap_distributed(blocks, tP, part, tc[0], engine=engine)
        for a, b in zip(tC, jC):
            _eq_csr(a, b, 1e-14)
        for a, b in zip(tR, jR):
            _eq_csr(a, b)
    assert tengine().stats()["dist_runs"] == 8


def test_galerkin_dist_matches_jax_engine():
    """The engine's shard-local ``P_locᵀ·(A_loc·P_ext)`` against the JAX
    engine's and scipy's, on its full symbolic pattern; a second call
    hits the cached plan; a small rank declines ("small")."""
    A, offsets, blocks, part = _blocks()
    rng = np.random.default_rng(3)
    p = 3
    lo, hi = offsets[p], offsets[p + 1]
    ring1 = part.rings[0].halo_global[p]
    keep = np.concatenate([np.arange(lo, hi), ring1])
    A_loc = sp.csr_matrix(blocks[p][:, keep])
    nc = 40
    P_ext = sp.random(len(keep), nc, density=0.2, random_state=rng,
                      format="csr")
    P_loc = sp.csr_matrix(P_ext[:hi - lo])
    want = (P_loc.T @ (A_loc @ P_ext)).toarray()
    je = jengine.DeviceSetupEngine()
    got_j = je.galerkin_dist(A_loc, P_ext, P_loc, dtype=np.float64)
    eng = tengine()
    got = eng.galerkin_dist(A_loc, P_ext, P_loc, dtype=np.float64)
    assert got is not None and got_j is not None
    np.testing.assert_allclose(got.toarray(), want, rtol=0,
                               atol=1e-14 * np.abs(want).max())
    np.testing.assert_allclose(got.toarray(), got_j.toarray(), rtol=0,
                               atol=1e-14 * np.abs(want).max())
    np.testing.assert_array_equal(got.indptr, got_j.indptr)
    np.testing.assert_array_equal(got.indices, got_j.indices)
    again = eng.galerkin_dist(A_loc, P_ext, P_loc, dtype=np.float64)
    assert eng.stats()["hits"] == 1
    np.testing.assert_array_equal(again.data, got.data)
    assert eng.galerkin_dist(A_loc, P_ext, P_loc, dtype=np.float64,
                             min_rows=10**6) is None
    assert eng.stats()["declines"] == {"small": 1}


def _solve(mod, mesh, cfg, A, blocks=None, post=None, **kw):
    if blocks is not None:
        m = mod.Matrix(**kw)
        m.set_distributed_blocks(blocks[0], blocks[1], mesh)
    else:
        m = mod.Matrix(A, **kw)
        m.set_distribution(mesh)
    s = mod.create_solver(cfg if mod is amgx else mod.AMGConfig(cfg))
    s.setup(m)
    if post is not None:
        post(s, m)
    return s, s.solve(np.ones(A.shape[0]))


def _same(rj, rt):
    assert rt.iterations == int(rj.iterations)
    assert int(rt.status) == int(rj.status) == 0
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=X_TOL * np.abs(xj).max())


@pytest.fixture(scope="module")
def jax_stacks(jmesh):
    """The JAX package's ``_CLA_DIST_CFG`` solves at 12³ on 8 shards (D1
    and D2), shared by the tests below."""
    A = poisson7pt(12, 12, 12)
    return A, {interp: _solve(jx, jmesh, CLA_DIST_CFG.format(
        interp=interp), A) for interp in ("D1", "D2")}


def _level_matrix(M):
    return M.assemble_global() if M.dist is not None else \
        sp.csr_matrix(M.host)


def _same_levels(sj, st, kind):
    hj, ht = sj.preconditioner.hierarchy, st.preconditioner.hierarchy
    assert [s[0] for s in ht._structure] == [s[0] for s in hj._structure]
    assert all(s[0] == kind for s in ht._structure)
    assert len(ht.levels) == len(hj.levels)
    for lj, lt in zip(hj.levels, ht.levels):
        assert lt.Ad.fmt == lj.Ad.fmt
        assert tuple(lt.Ad.offsets) == tuple(lj.Ad.offsets)
        assert lt.Ad.n_loc == lj.Ad.n_loc
        assert lt.submesh_parts == lj.submesh_parts
    mats_j = [lv.A for lv in hj.levels[1:]] + [hj.coarsest]
    mats_t = [lv.A for lv in ht.levels[1:]] + [ht.coarsest]
    for mj, mt in zip(mats_j, mats_t):
        _eq_csr(_level_matrix(mt), _level_matrix(mj), 1e-13)


@pytest.mark.parametrize("interp", ["D1", "D2"])
def test_classical_dist_stack_matches_jax(interp, jax_stacks, tmesh):
    """``_CLA_DIST_CFG`` at 12³ on 8 shards: every level
    ``classical-dist`` with the JAX package's coarse offsets, n_loc and
    operators (to 1e-13), the same count, x to 1e-10."""
    A, jref = jax_stacks
    sj, rj = jref[interp]
    st, rt = _solve(amgx, tmesh, CLA_DIST_CFG.format(interp=interp), A,
                    device="cpu")
    _same(rj, rt)
    _same_levels(sj, st, "classical-dist")
    ht = st.preconditioner.hierarchy
    assert ht.levels[0].P.fmt == "sharded-ell"
    assert set(ht.dist_timings) == {"extend", "strength", "pmis",
                                    "interpolation", "rap", "pack"}


@pytest.mark.parametrize("case", ["HMIS", "MULTIPASS"])
def test_classical_dist_fallback_matches_jax(case, jmesh, tmesh):
    """The global fallback (a selector other than PMIS, an interpolator
    other than D1/D2; ENERGYMIN's CR + EM take it too and are held in
    ``tests/test_torch_distributed.py``): P and R embedded into the
    padded spaces, the coarse level on equal row blocks, as in the JAX
    package — count, x and every level, at 8³."""
    cfg = CLA_DIST_CFG.format(interp="D2")
    if case == "HMIS":
        cfg = cfg.replace("amg:selector=PMIS", "amg:selector=HMIS")
    else:
        cfg = cfg.replace("amg:interpolator=D2", "amg:interpolator=MULTIPASS")
    A = poisson7pt(8, 8, 8)
    sj, rj = _solve(jx, jmesh, cfg, A)
    st, rt = _solve(amgx, tmesh, cfg, A, device="cpu")
    _same(rj, rt)
    _same_levels(sj, st, "classical")


@pytest.mark.parametrize("case", ["resetup", "host_levels"])
def test_classical_dist_resetup_and_host_levels_match_jax(case, jax_stacks,
                                                          tmesh):
    """A resetup of a distributed matrix is a fresh setup (the JAX
    package turns structure reuse off there): the count and x after it
    are the JAX package's solve's; ``amg_host_levels_rows`` on a
    distributed hierarchy too (a placement knob: on the CPU its tail is
    where it already is)."""
    A, jref = jax_stacks
    sj, rj = jref["D2"]
    cfg = CLA_DIST_CFG.format(interp="D2")
    post = None
    if case == "resetup":
        cfg += ", amg:structure_reuse_levels=-1"

        def post(s, m):
            s.resetup(m)
    else:
        cfg += ", amg:amg_host_levels_rows=200"
    st, rt = _solve(amgx, tmesh, cfg, A, post=post, device="cpu")
    _same(rj, rt)
    h = st.preconditioner.hierarchy
    if case == "resetup":
        assert h.last_resetup == "fresh"
    else:
        assert h.host_from < h.num_levels()
    _same_levels(sj, st, "classical-dist")


def test_classical_dist_never_assembles_global(jax_stacks, tmesh,
                                               monkeypatch):
    """From per-rank blocks (``set_distributed_blocks``, equal row
    blocks) the setup reads no global matrix: only the coarsest level's
    dense LU may assemble, at no more than n/4 rows
    (``tests/test_distributed.py:411-438``); the solve is the JAX
    package's on the same partition."""
    A, jref = jax_stacks
    A = sp.csr_matrix(A)
    n = A.shape[0]
    nl = -(-n // 8)
    offs = np.minimum(np.arange(9) * nl, n)
    bl = [sp.csr_matrix(A[offs[p]:offs[p + 1]]) for p in range(8)]
    assembled = []
    orig = amgx.Matrix.assemble_global

    def spy(self):
        assembled.append(self.shape[0])
        return orig(self)

    monkeypatch.setattr(amgx.Matrix, "assemble_global", spy)
    st, rt = _solve(amgx, tmesh, CLA_DIST_CFG.format(interp="D2"), A,
                    blocks=(bl, offs), device="cpu")
    _same(jref["D2"][1], rt)
    assert not assembled or max(assembled) <= n // 4, assembled
    kinds = [s[0] for s in st.preconditioner.hierarchy._structure]
    assert kinds and all(k == "classical-dist" for k in kinds)

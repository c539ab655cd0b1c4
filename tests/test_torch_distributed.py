"""Distribution on one device (``amgx_tpu_torch.distributed``) held
against the JAX package on the CPU: the partition maps, the halo
exchange and the distributed SpMV, the agglomeration planner, and the
distributed solves (PCG + BLOCK_JACOBI, FGMRES + SIZE_2 aggregation,
consolidation onto sub-meshes) — counts, x and every level's coarse
offsets and operators.  The JAX side runs on the 8-device virtual CPU
mesh of ``tests/conftest.py``; the port's mesh holds its 8 shards on the
CPU.  Sizes stay at 12³ or less."""
import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
from amgx_tpu.distributed import agglomerate as jagg
from amgx_tpu.distributed import matrix as jdm
from amgx_tpu.distributed import partition as jpart
from amgx_tpu.io import generate_distributed_poisson_7pt as jgen
from amgx_tpu.utils import faultinject as jfaultinject

import amgx_tpu_torch as amgx
from amgx_tpu_torch.distributed import agglomerate as tagg
from amgx_tpu_torch.distributed import matrix as tdm
from amgx_tpu_torch.distributed import partition as tpart
from amgx_tpu_torch.errors import RC, NotImplementedError_
from amgx_tpu_torch.io import (generate_distributed_poisson_7pt,
                               poisson5pt, poisson7pt)
from amgx_tpu_torch.ops import ell_spmv as emod
from amgx_tpu_torch.ops import spmv as smod
from amgx_tpu_torch.utils import faultinject

#: tests/test_distributed.py:140-148: the distributed headline stack
FGMRES_AGG = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=20, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector={sel}, amg:max_iters=1, amg:max_levels=12, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, amg:presweeps=1, "
    "amg:postsweeps=2, amg:min_coarse_rows=16, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
PCG_BJ = ("config_version=2, solver(s)=PCG, s:preconditioner(p)="
          "BLOCK_JACOBI, p:max_iters=3, s:max_iters=300, "
          "s:monitor_residual=1, s:tolerance=1e-8, "
          "s:convergence=RELATIVE_INI")
#: tests/test_distributed.py:180-196 and :314-330
CONSOLIDATION = (
    "config_version=2, {knobs}, solver(out)=PCG, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
    "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, amg:max_iters=1, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, amg:presweeps={pre}, "
    "amg:postsweeps=2, amg:min_coarse_rows={mcr}, "
    "amg:coarse_solver=DENSE_LU_SOLVER")


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((8,), ("p",))


@pytest.fixture(scope="module")
def tmesh():
    return tdm.make_mesh(8, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_plans():
    jagg.reset_plans()
    tagg.reset_plans()
    yield
    faultinject.reset()


def _random_graph():
    A = sp.random(96, 96, density=0.05,
                  random_state=np.random.RandomState(3), format="csr")
    return sp.csr_matrix(A + sp.identity(96) * 5)


def _far_coupled():
    """Long-range couplings: more than one distance, fewer than the
    all-gather (tests/test_distributed.py:228-242)."""
    n = 512
    A = sp.diags([np.full(n, 8.0)], [0]) + \
        sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1]) + \
        sp.diags([np.ones(n - 192), np.ones(n - 192)], [-192, 192])
    return sp.csr_matrix(A)


# ------------------------------------------------------------- partition
@pytest.mark.parametrize("case", ["poisson5pt_4", "random_graph_8"])
def test_partition_maps_match_jax(case):
    A, P = ((sp.csr_matrix(poisson5pt(8, 8)), 4) if case == "poisson5pt_4"
            else (_random_graph(), 8))
    pj = jpart.build_partition(A, P, n_rings=2)
    pt = tpart.build_partition(A, P, n_rings=2)
    assert (pt.n_global, pt.n_parts, pt.n_loc) == \
        (pj.n_global, pj.n_parts, pj.n_loc)
    np.testing.assert_array_equal(pt.offsets, pj.offsets)
    np.testing.assert_array_equal(pt.bnd_rows, pj.bnd_rows)
    np.testing.assert_array_equal(pt.bnd_count, pj.bnd_count)
    for a, b in zip(pt.neighbors, pj.neighbors):
        np.testing.assert_array_equal(a, b)
    assert len(pt.rings) == len(pj.rings) == 2
    for rt, rj in zip(pt.rings, pj.rings):
        assert rt.dists == rj.dists
        for f in ("send_idx", "send_count", "halo_src", "halo_count"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f))
        for a, b in zip(rt.halo_global, rj.halo_global):
            np.testing.assert_array_equal(a, b)
    assert pt.ring_neighbors_only == pj.ring_neighbors_only


def test_partition_vector_offsets_match_jax():
    A, pv = generate_distributed_poisson_7pt(3, 3, 3, 2, 2, 2)
    Aj, pvj = jgen(3, 3, 3, 2, 2, 2)
    assert abs(A - Aj).max() == 0
    np.testing.assert_array_equal(pv, pvj)
    np.testing.assert_array_equal(
        tpart.partition_offsets_from_vector(pv, 8),
        jpart.partition_offsets_from_vector(pvj, 8))
    with pytest.raises(Exception):
        tpart.partition_offsets_from_vector(np.array([1, 0, 1]), 2)


def test_embed_padded_and_pad_map_match_jax():
    M = sp.random(10, 6, density=0.4, random_state=np.random.RandomState(5),
                  format="csr")
    r_off, c_off = np.array([0, 3, 7, 10]), np.array([0, 2, 4, 6])
    np.testing.assert_array_equal(tdm.pad_map(r_off, 5),
                                  jdm.pad_map(r_off, 5))
    assert abs(tdm.embed_padded(M, r_off, 5, c_off, 3)
               - jdm.embed_padded(M, r_off, 5, c_off, 3)).max() == 0


# ------------------------------------------------- exchange and the SpMV
SPMV_CASES = {
    "uniform": (lambda: sp.csr_matrix(poisson7pt(8, 8, 8)), None),
    "nonuniform": (lambda: sp.csr_matrix(poisson5pt(10, 10)),
                   np.array([0, 13, 26, 39, 52, 65, 78, 91, 100])),
    "all_gather": (_random_graph, None),
    "multi_distance": (_far_coupled, None),
}


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_dist_spmv_matches_jax_and_scipy(case, jmesh, tmesh):
    make, offsets = SPMV_CASES[case]
    A = make()
    x = np.random.default_rng(7).standard_normal(A.shape[0])
    smj = jdm.shard_matrix(A, jmesh, offsets=offsets)
    smt = tdm.shard_matrix(A, tmesh, offsets=offsets)
    assert smt.dists == smj.dists and smt.n_loc == smj.n_loc
    assert smt.fmt == "sharded-ell"
    if case == "all_gather":
        assert tdm.uses_all_gather(smt.dists, 8)
    if case == "multi_distance":
        assert 1 < len(smt.dists) < 7
    yj = jdm.unshard_vector(smj, jax.jit(lambda v: jdm.dist_spmv(smj, v))(
        jdm.shard_vector(smj, x)))
    smod.reset_dispatch()
    yt = smod.spmv(smt, tdm.shard_vector(smt, x))
    assert smod.DISPATCH["sharded/gather"] == 1
    assert smod.DISPATCH["sharded/window"] == 0
    yt = tdm.unshard_vector(smt, yt).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(yt, A @ x, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("ring", [1, 2])
def test_exchange_halo_matches_jax(ring, jmesh, tmesh):
    A = sp.csr_matrix(poisson7pt(8, 8, 8))
    x = np.random.default_rng(ring).standard_normal(512)
    smj, smt = jdm.shard_matrix(A, jmesh), tdm.shard_matrix(A, tmesh)
    hj = np.asarray(jax.jit(lambda v: jdm.exchange_halo(smj, v, ring))(
        jdm.shard_vector(smj, x)))
    ht = tdm.exchange_halo(smt, tdm.shard_vector(smt, x), ring).numpy()
    part = tpart.build_partition(A, 8, n_rings=2)
    counts = part.rings[ring - 1].halo_count
    assert ht.shape == hj.shape
    for p in range(8):
        c = int(counts[p])
        np.testing.assert_array_equal(ht[p, :c], hj[p, :c])
        np.testing.assert_array_equal(
            ht[p, :c], x[part.rings[ring - 1].halo_global[p]])


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_stacked_interior_bits_equal_per_shard_plain_b3(dt, tmesh):
    """One B3 call over the stacked pack (halo columns −1, skipped) gives
    every shard's interior bit for bit as B3's plain version on the
    shard's own pack over [x_local | zero halo]."""
    A, pv = generate_distributed_poisson_7pt(4, 4, 4, 2, 2, 2)
    offsets = tpart.partition_offsets_from_vector(pv, 8)
    blocks = tpart.split_row_blocks(A, offsets)
    part = tpart.build_partition_from_blocks(blocks, offsets)
    npdt = np.float32 if dt == torch.float32 else np.float64
    cols, vals, _ = tdm.shard_arrays(blocks, part, npdt)
    sm = tdm.shard_matrix(A, tmesh, dtype=npdt, offsets=offsets)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(sm.n)
                         .astype(npdt))
    stacked = emod.ell_spmv(sm.cols, sm.vals, x, sm.row_len)
    n_loc, H = part.n_loc, part.H
    for p in range(8):
        xp = torch.cat([x[p * n_loc:(p + 1) * n_loc],
                        torch.zeros(H, dtype=dt)])
        want = emod.ell_spmv_reference(torch.from_numpy(cols[p]),
                                       torch.from_numpy(vals[p]), xp)
        assert torch.equal(stacked[p * n_loc:(p + 1) * n_loc], want), p


# ------------------------------------------------------------ the planner
@pytest.mark.parametrize("args", [(1000, 8, 64), (400, 8, 64), (100, 8, 64),
                                  (100, 8, 64, 4), (500, 8, 64, 4),
                                  (7, 8, 64)])
def test_plan_submesh_matches_jax(args):
    assert tagg.plan_submesh(*args) == jagg.plan_submesh(*args)


@pytest.mark.parametrize("src,min_rows,factor", [
    ([0, 25, 50, 75, 100, 100, 100, 100, 100], 60, 2),
    ([0, 100, 200, 300, 400, 500, 600, 700, 800], 150, 2),
    ([0, 30, 61, 90, 120, 150, 181, 210, 240], 50, 4),
    ([0, 500, 1000], 100, 2)])
def test_plan_for_and_redistribute_match_jax(src, min_rows, factor):
    pt = tagg.plan_for(src, min_rows, factor)
    pj = jagg.plan_for(src, min_rows, factor)
    assert (pt is None) == (pj is None)
    if pt is None:
        return
    assert (pt.p_active, pt.src_offsets, pt.dst_offsets) == \
        (pj.p_active, pj.src_offsets, pj.dst_offsets)
    assert [(k.dst, k.srcs) for k in pt.packs] == \
        [(k.dst, k.srcs) for k in pj.packs]
    assert tagg.plan_for(src, min_rows, factor) is pt        # cached
    assert tagg.agglomeration_stats()["hits"] == 1
    blocks = [sp.random(b - a, 40, density=0.2, format="csr",
                        random_state=np.random.RandomState(int(a) + 1))
              for a, b in zip(src[:-1], src[1:])]
    for bt, bj in zip(tagg.redistribute_blocks(blocks, pt),
                      jagg.redistribute_blocks(blocks, pj)):
        assert bt.shape == bj.shape
        np.testing.assert_array_equal(bt.toarray(), bj.toarray())


# ------------------------------------------------------------ the solves
def _jax_matrix(A, mesh, offsets=None):
    m = jx.Matrix(A)
    m.set_distribution(mesh, offsets=offsets)
    return m


def _port_matrix(A, mesh, offsets=None):
    m = amgx.Matrix(A, device="cpu")
    m.set_distribution(mesh, offsets=offsets)
    return m


def _both(cfg, A, jmesh, tmesh, offsets=None, b=None):
    b = np.ones(A.shape[0]) if b is None else b
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(_jax_matrix(A, jmesh, offsets))
    st = amgx.create_solver(cfg)
    st.setup(_port_matrix(A, tmesh, offsets))
    return sj, sj.solve(b), st, st.solve(b)


def _same(rj, rt, A, x_tol=1e-10):
    assert rt.iterations == rj.iterations, (rt.iterations, rj.iterations)
    assert int(rt.status) == int(rj.status) == 0
    xt, xj = rt.x.numpy(), np.asarray(rj.x)
    assert xt.shape == (A.shape[0],)
    np.testing.assert_allclose(xt, xj, rtol=0,
                               atol=x_tol * np.abs(xj).max())


def test_distributed_pcg_block_jacobi_matches_jax(jmesh, tmesh):
    A = poisson7pt(12, 12, 12)
    sj, rj, st, rt = _both(PCG_BJ, A, jmesh, tmesh)
    _same(rj, rt, A)
    assert st.Ad.fmt == "sharded-ell"


def _level_operator(lvl_A):
    return lvl_A.assemble_global() if lvl_A.dist is not None else \
        sp.csr_matrix(lvl_A.host)


@pytest.mark.parametrize("sel", ["SIZE_2", "GEO"])
def test_distributed_fgmres_aggregation_matches_jax(sel, jmesh, tmesh):
    """The headline distributed stack: equal counts, x to 1e-10, and
    every level's coarse offsets and operators equal."""
    A, pv = generate_distributed_poisson_7pt(6, 6, 6, 2, 2, 2)
    offsets = tpart.partition_offsets_from_vector(pv, 8)
    smod.reset_dispatch()
    sj, rj, st, rt = _both(FGMRES_AGG.format(sel=sel), A, jmesh, tmesh,
                           offsets)
    _same(rj, rt, A)
    assert smod.DISPATCH["sharded/gather"] > 0
    hj = sj.preconditioner.hierarchy
    ht = st.preconditioner.hierarchy
    assert len(ht.levels) == len(hj.levels)
    assert ht.levels[0].Ad.fmt == "sharded-ell"
    mats_j = [lv.A for lv in hj.levels[1:]] + [hj.coarsest]
    mats_t = [lv.A for lv in ht.levels[1:]] + [ht.coarsest]
    for lj, lt in zip(hj.levels, ht.levels):
        assert lt.Ad.fmt == lj.Ad.fmt
        assert tuple(lt.Ad.offsets) == tuple(lj.Ad.offsets)
        assert lt.Ad.n_loc == lj.Ad.n_loc
        assert lt.submesh_parts == lj.submesh_parts
        np.testing.assert_array_equal(lt.aggregates.numpy(),
                                      np.asarray(lj.aggregates))
    for mj, mt in zip(mats_j, mats_t):
        Cj, Ct = _level_operator(mj), _level_operator(mt)
        assert Ct.shape == Cj.shape
        np.testing.assert_allclose(Ct.toarray(), Cj.toarray(), rtol=0,
                                   atol=1e-13 * abs(Cj).max())


@pytest.mark.parametrize("case", ["threshold", "submesh", "planner"])
def test_consolidation_matches_jax(case, jmesh, tmesh):
    """``test_consolidation_threshold`` and ``test_submesh_consolidation``
    of tests/test_distributed.py mirrored, and the agglomeration
    planner: the same formats, active ranks and offsets per level, equal
    counts and x."""
    if case == "threshold":
        A = poisson7pt(8, 8, 8)
        cfg = CONSOLIDATION.format(
            knobs="matrix_consolidation_lower_threshold=16", pre=2, mcr=8)
        blocks = None
    elif case == "submesh":
        A = poisson7pt(12, 12, 12)
        cfg = CONSOLIDATION.format(
            knobs="matrix_consolidation_lower_threshold=200, "
                  "matrix_consolidation_upper_threshold=300", pre=1, mcr=16)
        blocks = True
    else:
        A = poisson7pt(8, 8, 8)
        cfg = CONSOLIDATION.format(knobs="dist_agglomerate_min_rows=40",
                                   pre=2, mcr=8)
        blocks = None
    A = sp.csr_matrix(A)
    b = np.ones(A.shape[0])
    if blocks:
        n = A.shape[0]
        nl = -(-n // 8)
        offs = np.minimum(np.arange(9) * nl, n)
        bl = [sp.csr_matrix(A[offs[p]:offs[p + 1]]) for p in range(8)]
        mj = jx.Matrix()
        mj.set_distributed_blocks(bl, offs, jmesh)
        mt = amgx.Matrix(device="cpu")
        mt.set_distributed_blocks(bl, offs, tmesh)
    else:
        mj, mt = _jax_matrix(A, jmesh), _port_matrix(A, tmesh)
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(mj)
    st = amgx.create_solver(cfg)
    st.setup(mt)
    rj, rt = sj.solve(b), st.solve(b)
    _same(rj, rt, A)
    lj = sj.preconditioner.hierarchy.levels
    lt = st.preconditioner.hierarchy.levels
    assert [lv.Ad.fmt for lv in lt] == [lv.Ad.fmt for lv in lj]
    assert [lv.submesh_parts for lv in lt] == [lv.submesh_parts for lv in lj]
    assert [tuple(getattr(lv.Ad, "offsets", ())) for lv in lt] == \
        [tuple(getattr(lv.Ad, "offsets", ())) for lv in lj]
    fmts = [lv.Ad.fmt for lv in lt]
    assert fmts[0] == "sharded-ell"
    assert any(f != "sharded-ell" for f in fmts[1:]), fmts
    subs = [lv.submesh_parts for lv in lt]
    if case != "threshold":
        assert any(s is not None and 1 < s < 8 for s in subs), subs


def test_sharded_solve_matches_one_device(tmesh):
    """8 shards against the same PCG on one unsharded device
    (tests/test_distributed.py:114-129)."""
    A = poisson5pt(16, 16)
    b = np.sin(np.arange(A.shape[0]))
    cfg = ("config_version=2, solver(s)=PCG, s:max_iters=50, "
           "s:monitor_residual=1, s:tolerance=1e-10, "
           "s:convergence=RELATIVE_INI")
    s1 = amgx.create_solver(cfg)
    s1.setup(amgx.Matrix(A, device="cpu"))
    s8 = amgx.create_solver(cfg)
    s8.setup(_port_matrix(A, tmesh))
    x1, x8 = s1.solve(b).x.numpy(), s8.solve(b).x.numpy()
    np.testing.assert_allclose(x8, x1, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name", ["CG", "GMRES", "BICGSTAB", "PBICGSTAB",
                                  "JACOBI_L1"])
def test_krylov_names_on_sharded_pack_match_jax(name, jmesh, tmesh):
    A = poisson7pt(8, 8, 8)
    if name == "JACOBI_L1":
        cfg = PCG_BJ.replace("BLOCK_JACOBI", "JACOBI_L1")
    elif name in ("CG", "BICGSTAB"):
        cfg = ("config_version=2, solver(s)=" + name + ", s:max_iters=300, "
               "s:monitor_residual=1, s:tolerance=1e-8, "
               "s:convergence=RELATIVE_INI")
    else:
        cfg = PCG_BJ.replace("solver(s)=PCG", f"solver(s)={name}")
    sj, rj, st, rt = _both(cfg, A, jmesh, tmesh)
    _same(rj, rt, A)


def test_block_upload_matches_global_upload(tmesh):
    A = sp.csr_matrix(poisson7pt(8, 8, 8))
    n = A.shape[0]
    offs = np.minimum(np.arange(9) * 64, n)
    bl = [sp.csr_matrix(A[offs[p]:offs[p + 1]]) for p in range(8)]
    mb = amgx.Matrix(device="cpu")
    mb.set_distributed_blocks(bl, offs, tmesh)
    with pytest.raises(Exception, match="block-distributed"):
        mb.scalar_csr()
    assert abs(mb.assemble_global() - A).max() == 0
    cfg = FGMRES_AGG.format(sel="SIZE_2")
    x = []
    for m in (mb, _port_matrix(A, tmesh, offs)):
        s = amgx.create_solver(cfg)
        s.setup(m)
        x.append(s.solve(np.ones(n)).x)
    assert torch.equal(x[0], x[1])


# ------------------------------------------------------------ faults, raises
def test_halo_exchange_fault_gives_jax_rc(jmesh, tmesh):
    """The armed ``halo_exchange`` point fails a distributed solve at
    its shard seam with the JAX package's message and RC."""
    A = poisson7pt(6, 6, 6)
    sj = jx.create_solver(jx.AMGConfig(PCG_BJ))
    sj.setup(_jax_matrix(A, jmesh))
    st = amgx.create_solver(PCG_BJ)
    st.setup(_port_matrix(A, tmesh))
    rcs = []
    for slv, fi in ((sj, jfaultinject), (st, faultinject)):
        fi.configure("halo_exchange:count=1")
        try:
            with pytest.raises(Exception) as ei:
                slv.solve(np.ones(A.shape[0]))
        finally:
            fi.reset()
        assert "injected halo-exchange failure" in str(ei.value)
        rcs.append(int(ei.value.rc))
    assert rcs[0] == rcs[1] == int(RC.CUDA_FAILURE)


#: the solver names and algorithms that joined the sharded pack in ROADMAP
#: item 8b (they raised until then), each held against the JAX package:
#: the same count and x (or, for MULTICOLOR_ILU, the JAX package's
#: refusal with its error class and code)
LATER = {
    "classical": ("AMG_CLA", "8b"), "energymin": ("AMG_EM", "8b"),
    "MULTICOLOR_DILU": ("MULTICOLOR_DILU", "8b"),
    "MULTICOLOR_GS": ("MULTICOLOR_GS", "8b"), "GS": ("GS", "8b"),
    "FIXCOLOR_GS": ("FIXCOLOR_GS", "8b"), "KACZMARZ": ("KACZMARZ", "8b"),
    "MULTICOLOR_ILU": ("MULTICOLOR_ILU", "8b"),
    "PCG_CA": ("PCG_CA", "8b"), "IDR": ("IDR", "8b"),
    "CHEBYSHEV": ("CHEBYSHEV", "8b"),
}


@pytest.mark.parametrize("case", sorted(LATER))
def test_later_item_solvers_raise(case, jmesh, tmesh):
    """Each name of ROADMAP item 8b on a sharded pack at 6³ against the
    JAX package: PCG (PCGF for the nonsymmetric sweeps) preconditioned by
    it (FGMRES for KACZMARZ), or the name as the outer solver — equal
    counts and x to 1e-10 of its largest entry; MULTICOLOR_ILU refuses
    the pack as upstream, with the JAX package's error class, message
    and code."""
    name, _item = LATER[case]
    tail = (", s:max_iters=60, s:monitor_residual=1, s:tolerance=1e-8, "
            "s:convergence=RELATIVE_INI")
    if name in ("AMG_CLA", "AMG_EM"):
        alg = "CLASSICAL" if name == "AMG_CLA" else "ENERGYMIN"
        cfg = ("config_version=2, solver(s)=PCG" + tail +
               ", s:preconditioner(amg)=AMG, amg:algorithm=" + alg +
               ", amg:max_iters=1, amg:min_coarse_rows=8, "
               "amg:coarse_solver=DENSE_LU_SOLVER, determinism_flag=1")
    elif name in ("PCG_CA", "IDR"):
        cfg = f"config_version=2, solver(s)={name}" + tail
    else:
        outer = {"CHEBYSHEV": "PCG", "KACZMARZ": "FGMRES"}.get(name, "PCGF")
        cfg = (f"config_version=2, solver(s)={outer}" + tail +
               f", s:preconditioner(p)={name}, p:max_iters=2")
    # Kaczmarz colors A·Aᵀ: the JAX package compiles one program per
    # color, fewer on a 2-D stencil
    A = poisson5pt(8, 8) if name == "KACZMARZ" else poisson7pt(6, 6, 6)
    if name == "MULTICOLOR_ILU":
        from amgx_tpu.errors import AMGXError as JAMGXError
        from amgx_tpu_torch.errors import AMGXError
        with pytest.raises(JAMGXError) as ej:
            jx.create_solver(jx.AMGConfig(cfg)).setup(_jax_matrix(A, jmesh))
        with pytest.raises(AMGXError) as et:
            amgx.create_solver(cfg).setup(_port_matrix(A, tmesh))
        assert type(et.value).__name__ == type(ej.value).__name__
        assert str(et.value) == str(ej.value)
        assert int(et.value.rc) == int(ej.value.rc)
        return
    sj, rj, st, rt = _both(cfg, A, jmesh, tmesh)
    _same(rj, rt, A)
    assert st.Ad.fmt == "sharded-ell"


def test_later_item_paths_raise(tmesh):
    """What stays for a later item raises naming it: a mesh over several
    cards (8c).  The paths of items 8b and 7c now run: a b×b sharded
    pack, complex and bf16 sharded packs, a resetup of a distributed
    matrix (a fresh setup, as upstream) and ``amg_host_levels_rows`` on
    a distributed hierarchy."""
    A = poisson7pt(6, 6, 6)
    with pytest.raises(NotImplementedError_, match="item 8c"):
        tdm.make_mesh(8, device=["cuda:0", "cuda:1"])
    assert tdm.shard_block_matrix(sp.kron(A, np.eye(2)).tocsr(), 2,
                                  tmesh).block_dim == 2
    mb = amgx.Matrix(sp.kron(A, np.eye(2)).tocsr(), block_dim=2,
                     device="cpu")
    mb.set_distribution(tmesh)
    assert mb.device().fmt == "sharded-ell"
    mc = amgx.Matrix(A.astype(np.complex128), device="cpu")
    mc.set_distribution(tmesh)
    assert mc.device().fmt == "sharded-ell"
    assert mc.device().dtype == torch.complex128
    mh = _port_matrix(A, tmesh)
    mh.device_dtype = torch.bfloat16
    assert mh.device().dtype == torch.bfloat16
    m = _port_matrix(A, tmesh)
    cfg = FGMRES_AGG.format(sel="SIZE_2")
    s = amgx.create_solver(cfg)
    s.setup(m)
    x0 = s.solve(np.ones(A.shape[0])).x
    s.resetup(m)
    assert s.preconditioner.hierarchy.last_resetup == "fresh"
    assert torch.equal(s.solve(np.ones(A.shape[0])).x, x0)
    host = amgx.create_solver(cfg + ", amg:amg_host_levels_rows=64")
    host.setup(_port_matrix(A, tmesh))
    assert torch.equal(host.solve(np.ones(A.shape[0])).x, x0)


#: the other names that joined the sharded pack in ROADMAP item 8b: the
#: outer solver (or its reduction layout), or PCG's preconditioner
NAMES_8B = {
    "PCGF": ("PCGF", ""), "PCG_PIPE": ("PCG_PIPE", ""),
    "IDRMSYNC": ("IDRMSYNC", ""),
    "krylov_comm_CA": ("PCG", ", s:krylov_comm=CA"),
    "krylov_comm_PIPELINED": ("PCG", ", s:krylov_comm=PIPELINED"),
    "NOSOLVER": ("NOSOLVER", ""),
}
for _p in ("CHEBYSHEV_POLY", "POLYNOMIAL", "KPZ_POLYNOMIAL", "CF_JACOBI",
           "NOSOLVER"):
    NAMES_8B[f"pre_{_p}"] = (
        "PCG", f", s:preconditioner(p)={_p}, p:max_iters=2")


@pytest.mark.parametrize("case", sorted(NAMES_8B))
def test_item8b_names_on_sharded_pack_match_jax(case, jmesh, tmesh):
    """PCGF, PCG_PIPE, IDRMSYNC, ``krylov_comm`` CA and PIPELINED,
    NOSOLVER, and the polynomial smoothers and CF_JACOBI as PCG's
    preconditioner, on a sharded pack at 6³: the JAX package's count,
    status and x (to 1e-10 of its largest entry; NOSOLVER runs its
    budget out on both)."""
    solver, extra = NAMES_8B[case]
    cfg = (f"config_version=2, solver(s)={solver}, s:max_iters=60, "
           "s:monitor_residual=1, s:tolerance=1e-8, "
           "s:convergence=RELATIVE_INI" + extra)
    A = poisson7pt(6, 6, 6)
    sj, rj, st, rt = _both(cfg, A, jmesh, tmesh)
    assert rt.iterations == rj.iterations
    assert int(rt.status) == int(rj.status)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())

"""The port's scalar aggregation AMG against the JAX package: the
selectors' aggregates are bit-equal (SIZE_2/4/8, MULTI_PAIRWISE,
PARALLEL_GREEDY, DUMMY and GEO with coordinates) on the DFG cylinder
operator at ny = 64, a randomly permuted 2-D Poisson and the anisotropic
2-D Laplacian; the host Galerkin products equal the JAX package's to
1e-12; restriction and prolongation are bit-equal; GEO without a DIA
plan falls back to SIZE_2 in both; and one preconditioner application on
the JAX package's hierarchy, carried across with ``interop``, matches
the JAX package's."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
import amgx_tpu
from amgx_tpu.amg.aggregation.selectors import create_selector as jax_sel
from amgx_tpu.io.gauntlet import _aniso_2d

import amgx_tpu_torch as amgx
from amgx_tpu_torch import interop
from amgx_tpu_torch.amg.aggregation.selectors import create_selector
from amgx_tpu_torch.amg.level import AggregationLevel, member_table
from amgx_tpu_torch.io import dfg_cylinder_pressure, poisson5pt

#: one AMG application in f64 on identical hierarchy arrays
APPLY_RTOL = 1e-10
#: host Galerkin (scipy) against the JAX package's (its device engine
#: above 4096 rows): the same terms summed in another order
AC_RTOL = 1e-12

SELECTORS = ("SIZE_2", "SIZE_4", "SIZE_8", "MULTI_PAIRWISE",
             "PARALLEL_GREEDY", "DUMMY")

CFG = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
       "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
       "amg:selector=SIZE_2, amg:max_iters=1, amg:max_levels=20, "
       "amg:cycle=CG, amg:cycle_iters=2, "
       "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
       "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
       "amg:coarse_solver=DENSE_LU_SOLVER")


def _permuted_poisson(nx=40, ny=36, seed=3):
    """A 2-D Poisson under a random symmetric permutation (no DIA
    structure left), with the grid coordinates of every row."""
    A = sp.csr_matrix(poisson5pt(nx, ny))
    perm = np.random.default_rng(seed).permutation(A.shape[0])
    P = sp.csr_matrix(A[perm][:, perm])
    P.sort_indices()
    ix = np.arange(A.shape[0]) % nx
    iy = np.arange(A.shape[0]) // nx
    return P, (ix[perm].astype(float), iy[perm].astype(float))


MATRICES = {
    "dfg_64": lambda: dfg_cylinder_pressure(64),
    "permuted_poisson": lambda: _permuted_poisson()[0],
    "aniso_2d": lambda: sp.csr_matrix(_aniso_2d(48)),
}


@pytest.mark.parametrize("mat", sorted(MATRICES))
@pytest.mark.parametrize("name", SELECTORS)
def test_aggregates_bit_equal(name, mat):
    A = MATRICES[mat]()
    cfg_p = amgx.AMGConfig(CFG)
    cfg_j = amgx_tpu.AMGConfig(CFG)
    ours = create_selector(name, cfg_p, "amg").select(A)
    theirs = jax_sel(name, cfg_j, "amg").select(A)
    assert ours.dtype == theirs.dtype
    assert np.array_equal(ours, theirs)


def test_geo_with_coordinates_bit_equal():
    """The GEO selector bins attached coordinates, as upstream."""
    A, coords = _permuted_poisson()
    A._amgx_geometry = coords
    ours = create_selector("GEO", amgx.AMGConfig(CFG), "amg").select(A)
    theirs = jax_sel("GEO", amgx_tpu.AMGConfig(CFG), "amg").select(A)
    assert np.array_equal(ours, theirs)
    assert len(np.unique(ours)) < A.shape[0] // 2


def _setups(A, cfg=CFG, dtype=np.float64):
    jm = amgx_tpu.Matrix(A)
    jm.device_dtype = dtype
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    ref.setup(jm)
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = dtype
    slv = amgx.create_solver(cfg)
    slv.setup(m)
    return ref.preconditioner.hierarchy, slv.preconditioner.hierarchy


def test_hierarchy_matches_jax():
    """SIZE_2 on the DFG operator at ny = 64: the same levels and
    aggregates, coarse operators equal to 1e-12, pack kinds alike under
    the stated mapping (the JAX package's scalar ``ell/gather`` and
    ``ell/window`` are the port's ``ell/window``, kernel B3)."""
    from amgx_tpu.core.matrix import pack_kind as jax_kind
    jh, ph = _setups(dfg_cylinder_pressure(64))
    assert len(ph.levels) == len(jh.levels) == 9
    kinds = {"ell/gather": "ell/window", "ell/window": "ell/window",
             "dia": "dia", "ell/shift": "ell/shift"}
    for lp, lj in zip(ph.levels, jh.levels):
        assert lp.kind == "aggregation"
        assert lp.level_stats() == lj.level_stats()
        assert np.array_equal(lp.aggregates.numpy(),
                              np.asarray(lj.aggregates))
        assert amgx.pack_kind(lp.Ad) == kinds[jax_kind(lj.A.device())]
        Hp, Hj = lp.A.host, lj.A.host
        assert Hp.shape == Hj.shape
        scale = abs(Hj).max()
        assert abs(Hp - Hj).max() <= AC_RTOL * scale
    assert ph.coarsest.n_block_rows == jh.coarsest.n_block_rows
    assert abs(ph.coarsest.host - jh.coarsest.host).max() <= \
        AC_RTOL * abs(jh.coarsest.host).max()
    assert ph.level_sizes() == jh.level_sizes()
    assert ph.grid_stats() == jh.grid_stats()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_transfers_bit_equal(dtype):
    """Restriction adds each aggregate's rows in increasing order (the
    JAX package's segment sum, bit for bit); prolongation is a gather."""
    import jax
    A = dfg_cylinder_pressure(64)
    agg = create_selector("SIZE_4", amgx.AMGConfig(CFG), "amg").select(A)
    nc = int(agg.max()) + 1
    lv = AggregationLevel(amgx.Matrix(A, device="cpu"), 0, agg, nc)
    assert lv.members.shape[1] == nc
    rng = np.random.default_rng(8)
    r = rng.standard_normal(A.shape[0]).astype(dtype)
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(r), jnp.asarray(agg.astype(np.int32)),
        num_segments=nc))
    assert np.array_equal(lv.restrict_residual(torch.from_numpy(r))
                          .numpy(), want)
    e = rng.standard_normal(nc).astype(dtype)
    x = rng.standard_normal(A.shape[0]).astype(dtype)
    got = lv.prolongate_and_correct(torch.from_numpy(x),
                                    torch.from_numpy(e)).numpy()
    assert np.array_equal(got, x + e[agg])


def test_member_table_orders_rows():
    agg = np.array([2, 0, 2, 1, 0, 2])
    t = member_table(agg, 3)
    assert t.tolist() == [[1, 3, 0], [4, 6, 2], [6, 6, 5]]


def test_geo_falls_back_to_size2():
    """A permuted Poisson has no DIA plan and no coordinates: GEO
    aggregates by SIZE_2 matching in both packages."""
    A, _ = _permuted_poisson()
    cfg = CFG.replace("amg:selector=SIZE_2", "amg:selector=GEO")
    jh, ph = _setups(A, cfg)
    want = create_selector("SIZE_2", amgx.AMGConfig(CFG), "amg").select(A)
    assert ph.levels[0].kind == "aggregation"
    assert type(jh.levels[0]).__name__ == "AggregationLevel"
    assert np.array_equal(ph.levels[0].aggregates.numpy(), want)
    assert np.array_equal(np.asarray(jh.levels[0].aggregates), want)
    assert [lv.level_stats() for lv in ph.levels] == \
        [lv.level_stats() for lv in jh.levels]


@pytest.mark.parametrize("cycle", ["V", "CG"])
def test_apply_on_carried_hierarchy(cycle):
    """One AMG application on the JAX package's hierarchy (its f64
    packs, aggregates and coarsest operator), carried across with
    ``interop``, against the JAX package's own application."""
    from amgx_tpu_torch.amg.cycles import build_cycle
    text = CFG.replace("amg:cycle=CG", f"amg:cycle={cycle}")
    A = dfg_cylinder_pressure(32)
    jm = amgx_tpu.Matrix(A)
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(text))
    ref.setup(jm)
    jh = ref.preconditioner.hierarchy
    levels = [dict(A=lv.A.device(), aggregates=np.asarray(lv.aggregates),
                   n_coarse=lv.n_coarse) for lv in jh.levels]
    cfg = amgx.AMGConfig(text)
    h = interop.aggregation_hierarchy_from_packs(
        cfg, "amg", levels, jh.coarsest.device(), device="cpu")
    assert [lv.kind for lv in h.levels] == ["aggregation"] * len(levels)
    amg = amgx.SolverFactory.create("AMG", cfg, "amg")
    amg.hierarchy = h
    amg._cycle = build_cycle(h)
    b = np.random.default_rng(7).standard_normal(A.shape[0])
    want = np.asarray(ref.preconditioner.apply(jnp.asarray(b)))
    got = amg.apply(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=APPLY_RTOL,
                               atol=APPLY_RTOL * np.max(np.abs(want)))

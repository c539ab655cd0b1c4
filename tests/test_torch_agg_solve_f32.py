"""The headline stack with SIZE_2 on the DFG cylinder operator with the
f32 pack + f64 refinement, the port on the CPU against the JAX package
(ny = 32; tests/test_torch_agg_solve.py says why not 64): the same
iteration count, each solve's true relres within the tolerance, x within
f32 rounding of the JAX package's, and the same per-level pack kinds.

The port sums the K-cycle's and FGMRES's f32 inner products in f64,
adds ELL rows in its kernel's lane order and applies the coarse inverse
as an ordered product (so that the card and the CPU round alike); the
JAX package sums each in XLA's order.  The f32 count may therefore part
from the JAX package's by the rounding of those sums: at ny = 64 it is
26 against 27, and 27 with the JAX package's f32 sums substituted
(``tests/torch_agg_parity.py``)."""
import numpy as np

from amgx_tpu.core.matrix import pack_kind as jax_pack_kind

import amgx_tpu_torch as amgx
from amgx_tpu_torch.errors import SolveStatus

from test_torch_agg_solve import (HEADLINE_SIZE2, one_thread,  # noqa: F401
                                  relres, solve_both)

#: x of the two f32 solves: both reach 1e-8 from the same hierarchy, but
#: their f32 inner iterates differ in the last bits
X_RTOL = 1e-7


def test_headline_size2_f32_refined_matches_jax():
    rj, rp, A = solve_both(HEADLINE_SIZE2, np.float32, ny=32)
    assert rj.iterations == rp.iterations == 23
    assert rp.status == SolveStatus.SUCCESS
    xp, xj = rp.x.numpy(), np.asarray(rj.x)
    assert xp.dtype == np.float64
    assert relres(A, xp) <= 1e-8 and relres(A, xj) <= 1e-8
    assert np.linalg.norm(xp - xj) <= X_RTOL * np.linalg.norm(xj)


def test_f32_hierarchy_packs_match_jax():
    """The f32 hierarchy: every level's pack kind under the stated
    mapping (the JAX package's scalar ``ell/gather`` and ``ell/window``
    are the port's ``ell/window``, kernel B3)."""
    import amgx_tpu
    from amgx_tpu_torch.io import dfg_cylinder_pressure
    A = dfg_cylinder_pressure(32)
    jm = amgx_tpu.Matrix(A)
    jm.device_dtype = np.float32
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(HEADLINE_SIZE2))
    ref.setup(jm)
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = np.float32
    slv = amgx.create_solver(HEADLINE_SIZE2)
    slv.setup(m)
    mapping = {"ell/gather": "ell/window", "ell/window": "ell/window",
               "dia": "dia", "ell/shift": "ell/shift"}
    jh, ph = ref.preconditioner.hierarchy, slv.preconditioner.hierarchy
    assert [amgx.pack_kind(lv.Ad) for lv in ph.levels] == \
        [mapping[jax_pack_kind(lv.A.device())] for lv in jh.levels]
    assert all(lv.Ad.dtype.itemsize == 4 for lv in ph.levels)

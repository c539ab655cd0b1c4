"""Complex b×b block packs, bf16 and f32 levels of a complex operator,
and a values-only resetup under ``structure_reuse_levels``, against the
JAX package on the CPU (ROADMAP item 7c; the scalar AMG configurations
are in ``test_torch_complex_amg.py``).

The JAX package's count and residual history (``HIST_RTOL`` 1e-8 plus
``HIST_ATOL``·‖r₀‖, ``tests/torch_complex_parity.py``)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx

import amgx_tpu_torch as amgx

from torch_complex_parity import (amg_cfg, assert_same, block_system, both,
                                  crhs, krylov_cfg, operator, relres)


def test_hierarchy_float32_levels_keep_real_parts():
    """``hierarchy_dtype=float32`` narrows each complex level to f32 real
    values, as the JAX package's cast does; the smoother's inverted
    diagonal is 1/Re(d), as the JAX package inverts the narrowed
    diagonal."""
    A, _ = operator("Z")
    cfg = amg_cfg(extra=", hierarchy_dtype=float32")
    s = amgx.create_solver(cfg)
    s.setup(amgx.Matrix(A, device="cpu"))
    h = s.preconditioner.hierarchy
    assert all(lv.Ad.dtype == torch.float32 for lv in h.levels)
    d0 = h.levels[0].smoother.dinv
    want = torch.from_numpy(1.0 / A.diagonal().real).float()
    assert torch.equal(d0, want)


def test_hierarchy_bfloat16_count_and_band():
    """``hierarchy_dtype=bfloat16``: bf16 real levels in both packages,
    the JAX package's count; the histories part within the bf16 rounding
    of the levels' inverted diagonals (the port computes them from the
    wide values and stores them bf16, ``core/precision.py``, where the
    JAX package keeps the coarse levels' in f64)."""
    A, b = operator("Z")
    cfg = amg_cfg(extra=", hierarchy_dtype=bfloat16")
    rj, rp, sp_ = both(cfg, A, b)
    assert all(lv.Ad.dtype == torch.bfloat16
               for lv in sp_.preconditioner.hierarchy.levels)
    assert rp.iterations == rj.iterations
    np.testing.assert_allclose(np.asarray(rp.residual_history),
                               np.asarray(rj.residual_history), rtol=1e-2)


def test_structure_reuse_resetup_matches_jax():
    """``structure_reuse_levels=1``: a setup, then a values-only resetup
    on coefficients scaled by (1 + 0.1i) — the same count and history
    in both packages after each."""
    A, b = operator("Z")
    cfg = amg_cfg(extra=", amg:structure_reuse_levels=1")
    mj, mp = jx.Matrix(A), amgx.Matrix(A, device="cpu")
    sj, sp_ = jx.create_solver(jx.AMGConfig(cfg)), amgx.create_solver(cfg)
    sj.setup(mj)
    sp_.setup(mp)
    assert_same(sj.solve(b), sp_.solve(b))
    new = A.data * (1 + 0.1j)
    mj.replace_coefficients(new)
    mp.replace_coefficients(new)
    sj.resetup(mj)
    sp_.resetup(mp)
    rj, rp = sj.solve(b), sp_.solve(b)
    assert_same(rj, rp)
    A2 = sp.csr_matrix((new, A.indices, A.indptr), shape=A.shape)
    assert relres(A2, rp.x, b) < 1e-7


BLOCK_CASES = {
    "BLOCK_JACOBI": krylov_cfg("FGMRES"),
    "MULTICOLOR_GS": krylov_cfg("FGMRES", pre="MULTICOLOR_GS"),
    "MULTICOLOR_DILU": krylov_cfg("FGMRES", pre="MULTICOLOR_DILU"),
    "AMG_SIZE_2": amg_cfg(),
    "AMG_SIZE_2_MULTICOLOR_GS": amg_cfg(sm="MULTICOLOR_GS"),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_complex_block_pack_matches_jax(case):
    """A complex 2×2 block system (6³ blocks): its pack applies on the
    plain paths (``dia/block-slices`` or ``ell/block-gather``: B1 and B5
    refuse complex values), BLOCK_JACOBI inverts each complex block."""
    A = block_system()
    b = crhs(A.shape[0], 4)
    rj, rp, sp_ = both(BLOCK_CASES[case], A, b, block_dim=2)
    assert sp_.Ad.block_dim == 2 and sp_.Ad.dtype == torch.complex128
    assert_same(rj, rp)
    assert rp.status == 0

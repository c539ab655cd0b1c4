"""The f32 iteration count of the headline stack with SIZE_2 on the DFG
cylinder operator, the port on the CPU against the JAX package — too slow
for the test tier at ny = 64 (the JAX package compiles the K-cycle
unrolled: 2⁸ cycle bodies there), so it runs by hand:

    JAX_PLATFORMS=cpu python3 tests/torch_agg_parity.py --ny 64

It prints one JSON line: the JAX package's count, the port's, and the
port's with the JAX package's f32 arithmetic substituted where the two
differ (ELL rows summed left to right, XLA's dots, matrix-vector
products and norms, its LU factor and solve).  Equal hierarchies
(tests/test_torch_aggregation.py) and an equal substituted count mean the
gap is the rounding of those f32 sums.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402
import jax.scipy.linalg as jsl  # noqa: E402

import amgx_tpu  # noqa: E402
import amgx_tpu_torch as amgx  # noqa: E402
import amgx_tpu_torch.amg.cycles as cycles  # noqa: E402
import amgx_tpu_torch.solvers.dense_lu as dense_lu  # noqa: E402
from amgx_tpu_torch.io import dfg_cylinder_pressure  # noqa: E402
from amgx_tpu_torch.ops import blas, ell_spmv  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_agg_solve import HEADLINE_SIZE2  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def substitute_jax_arithmetic():
    """Route the port's f32 sums through the JAX package's order."""

    def ell_rows(cols, vals, x):
        ok = (cols >= 0) & (cols < x.shape[0])
        p = torch.where(ok, vals * x[torch.where(ok, cols, 0).long()], 0)
        acc = p[:, 0]
        for k in range(1, p.shape[1]):
            acc = acc + p[:, k]
        return acc

    def dot(x, y):
        return _t(jnp.dot(x.numpy(), y.numpy()))

    def lu_setup(self):
        self._jlu = jsl.lu_factor(jnp.asarray(
            dense_lu.densify(self.Ad).astype(np.float32)))

    ell_spmv.ell_spmv_reference = ell_rows
    blas.wdot = cycles.wdot = dot
    blas.wgram_dots = lambda V, w: _t(jnp.asarray(V.numpy())
                                      @ jnp.asarray(w.numpy()))
    blas.lincomb = lambda V, c: _t(jnp.asarray(V.numpy()).T
                                   @ jnp.asarray(c.numpy()))
    blas.wnrm2 = lambda x: _t(jnp.linalg.norm(x.numpy()))
    dense_lu.DenseLUSolver.solver_setup = lu_setup
    dense_lu.DenseLUSolver._lu_apply = lambda self, b: _t(jsl.lu_solve(
        self._jlu, jnp.asarray(b.numpy())))


def port_count(A) -> int:
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = np.float32
    slv = amgx.create_solver(HEADLINE_SIZE2)
    slv.setup(m)
    return slv.solve(np.ones(A.shape[0])).iterations


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ny", type=int, default=64)
    args = ap.parse_args()
    A = dfg_cylinder_pressure(args.ny)
    jm = amgx_tpu.Matrix(A)
    jm.device_dtype = np.float32
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(HEADLINE_SIZE2))
    ref.setup(jm)
    jax_iters = ref.solve(np.ones(A.shape[0])).iterations
    port = port_count(A)
    substitute_jax_arithmetic()
    print(json.dumps({"ny": args.ny, "rows": A.shape[0],
                      "jax_f32_iterations": jax_iters,
                      "port_f32_iterations": port,
                      "port_with_jax_f32_sums": port_count(A)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

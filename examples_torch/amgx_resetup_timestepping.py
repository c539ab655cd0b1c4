#!/usr/bin/env python
"""Time-stepping with structure reuse on the port — the
reservoir-simulation loop.

Mirror of the reference's resetup workflow (``AMGX_solver_resetup``,
``amgx_c.h:359-366``; the reservoir workloads in BASELINE.md re-factor
the same sparsity every Newton/time step): build the hierarchy ONCE,
then per step replace the coefficients and refresh numerically
(``Matrix.replace_coefficients`` then ``Solver.resetup``: the kept
classical structure and, on the card, the AMG's CUDA graphs survive).

Usage: amgx_resetup_timestepping.py [-n 24] [-steps 5] [-mode dDDI]
"""
import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np
import scipy.sparse as sp

import amgx_tpu_torch as amgx
from amgx_tpu_torch.io import poisson7pt

CFG = (
    "config_version=2, solver(out)=PCG, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
    "amg:algorithm=CLASSICAL, amg:selector=PMIS, amg:interpolator=D2, "
    "amg:max_iters=1, amg:interp_max_elements=4, amg:max_row_sum=0.9, "
    "amg:max_levels=16, amg:smoother(sm)=JACOBI_L1, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
    "amg:structure_reuse_levels=-1, "      # keep structure across steps
    "amg:coarse_solver=DENSE_LU_SOLVER")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=24)
    ap.add_argument("-steps", type=int, default=5)
    ap.add_argument("-mode", "--mode", default="dDDI")
    args = ap.parse_args()
    mode = amgx.parse_mode(args.mode)

    A0 = poisson7pt(args.n, args.n, args.n)   # carries its DIA attach
    n = A0.shape[0]
    rng = np.random.default_rng(0)
    b = np.ones(n)

    m = amgx.Matrix(A0.astype(mode.mat_dtype),
                    device=mode.placement_device())
    m.device_dtype = mode.effective_mat_dtype()
    slv = amgx.create_solver(amgx.AMGConfig(CFG), mode=mode)
    t0 = time.perf_counter()
    slv.setup(m)
    print(f"initial setup: {time.perf_counter() - t0:.2f} s")

    for step in range(args.steps):
        # value-only coefficient drift (same sparsity): the
        # time-dependent mobility of a reservoir step
        d = sp.diags(1.0 + 0.1 * rng.uniform(size=n) * (step + 1))
        A = sp.csr_matrix(d @ A0 @ d)
        A.sort_indices()
        t0 = time.perf_counter()
        m.replace_coefficients(A.data)
        slv.resetup(m)
        t_re = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = slv.solve(b)
        t_sol = time.perf_counter() - t0
        x = res.x.cpu().numpy()
        rr = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
        print(f"step {step}: resetup {t_re:.3f} s, solve {t_sol:.3f} s, "
              f"{res.iterations} iters, relres {rr:.2e}")
        assert rr < 1e-7, "time step failed to converge"
    print("timestepping done")
    return 0


if __name__ == "__main__":
    sys.exit(main())

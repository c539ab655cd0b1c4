#!/usr/bin/env python
"""Distributed classical-AMG driver of the port — mirror of
``examples/amgx_mpi_capi_cla.c``: partition read + PCG with classical
(PMIS/D1) AMG, the partitions as shards of one mesh on the mode's
device.

Usage: amgx_mpi_capi_cla.py -m matrix.mtx [-p 4] [-mode dDDI]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from amgx_tpu_torch import capi as amgx

CONFIG = ("config_version=2, solver(out)=PCG, out:max_iters=100, "
          "out:monitor_residual=1, out:tolerance=1e-8, "
          "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
          "amg:algorithm=CLASSICAL, amg:selector=PMIS, "
          "amg:interpolator=D1, amg:max_iters=1, "
          "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
          "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=16, "
          "amg:coarse_solver=DENSE_LU_SOLVER")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--matrix", required=True)
    ap.add_argument("-p", "--partitions", type=int, default=4)
    ap.add_argument("-mode", "--mode", default="dDDI")
    args = ap.parse_args()

    assert amgx.AMGX_initialize() == 0
    rc, cfg = amgx.AMGX_config_create(CONFIG)
    assert rc == 0, rc
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, args.mode)
    rc, b = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, x = amgx.AMGX_vector_create(rsrc, args.mode)

    rc = amgx.AMGX_read_system_distributed(
        A, b, x, args.matrix, 1, args.partitions, None, None)
    assert rc == 0, rc
    rc, n, bx, by = amgx.AMGX_matrix_get_size(A)
    print(f"Matrix: {n} rows across {args.partitions} partitions")
    amgx.AMGX_vector_bind(b, A)
    amgx.AMGX_vector_bind(x, A)

    rc, solver = amgx.AMGX_solver_create(rsrc, args.mode, cfg)
    assert amgx.AMGX_solver_setup(solver, A) == 0
    assert amgx.AMGX_solver_solve_with_0_initial_guess(solver, b, x) == 0
    rc, status = amgx.AMGX_solver_get_status(solver)
    rc, iters = amgx.AMGX_solver_get_iterations_number(solver)
    rc, nrm = amgx.AMGX_solver_calculate_residual_norm(solver, A, b, x)
    print(f"status={status} iterations={iters} residual={nrm:.3e}")
    amgx.AMGX_finalize()
    return 0 if status == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

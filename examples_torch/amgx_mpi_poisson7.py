#!/usr/bin/env python
"""Distributed Poisson benchmark driver of the port — mirror of
``examples/amgx_mpi_poisson7.c`` (partitioning flags ``-p nx ny nz px py
pz``, reference :72-80): ``AMGX_generate_distributed_poisson_7pt``
builds the px·py·pz rank bricks, each one shard of a mesh on the mode's
device.

Usage: amgx_mpi_poisson7.py -c config.json [-p nx ny nz px py pz]
                            [-mode dDDI]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from amgx_tpu_torch import capi as amgx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-p", nargs=6, type=int, metavar=("nx", "ny", "nz",
                                                      "px", "py", "pz"),
                    default=[16, 16, 16, 2, 2, 2])
    ap.add_argument("-mode", "--mode", default="dDDI")
    args = ap.parse_args()
    nx, ny, nz, px, py, pz = args.p

    amgx.AMGX_initialize()
    rc, cfg = amgx.AMGX_config_create_from_file(args.config)
    assert rc == 0, rc
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, args.mode)
    rc, b = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, x = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, _, _ = amgx.AMGX_generate_distributed_poisson_7pt(
        A, b, x, nx, ny, nz, px, py, pz)
    assert rc == 0, rc
    amgx.AMGX_vector_bind(b, A)
    amgx.AMGX_vector_bind(x, A)
    n = nx * ny * nz * px * py * pz
    print(f"Poisson7 {nx*px}x{ny*py}x{nz*pz} over {px}x{py}x{pz} "
          f"partitions ({n} rows)")

    rc, solver = amgx.AMGX_solver_create(rsrc, args.mode, cfg)
    rc = amgx.AMGX_solver_setup(solver, A)
    assert rc == 0, rc
    rc = amgx.AMGX_solver_solve_with_0_initial_guess(solver, b, x)
    assert rc == 0, rc
    rc, status = amgx.AMGX_solver_get_status(solver)
    rc, iters = amgx.AMGX_solver_get_iterations_number(solver)
    rc, nrm = amgx.AMGX_solver_calculate_residual_norm(solver, A, b, x)
    print(f"status={status} iterations={iters} residual={nrm:.3e}")
    amgx.AMGX_finalize()
    return 0 if status == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

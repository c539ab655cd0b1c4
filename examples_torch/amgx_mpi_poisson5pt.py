#!/usr/bin/env python
"""Distributed 2D Poisson driver of the port — mirror of
``examples/amgx_mpi_poisson5pt.c``: generated 5-point Laplacian,
uploaded rank by rank (equal row blocks, the shards of one mesh on the
mode's device), PCG + AMG.

Usage: amgx_mpi_poisson5pt.py [-p nx ny px py] [-mode dDDI]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np
import scipy.sparse as sp

from amgx_tpu_torch import capi as amgx
from amgx_tpu_torch.io import poisson5pt

CONFIG = ("config_version=2, solver(out)=PCG, out:max_iters=200, "
          "out:monitor_residual=1, out:tolerance=1e-8, "
          "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
          "amg:algorithm=AGGREGATION, amg:selector=GEO, amg:max_iters=1, "
          "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
          "amg:presweeps=1, amg:postsweeps=2, amg:min_coarse_rows=16, "
          "amg:coarse_solver=DENSE_LU_SOLVER")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-p", nargs=4, type=int,
                    metavar=("nx", "ny", "px", "py"),
                    default=[64, 64, 2, 2])
    ap.add_argument("-mode", "--mode", default="dDDI")
    args = ap.parse_args()
    nx, ny, px, py = args.p
    n_parts = px * py

    amgx.AMGX_initialize()
    rc, cfg = amgx.AMGX_config_create(CONFIG)
    assert rc == 0, rc
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, args.mode)
    rc, b = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, x = amgx.AMGX_vector_create(rsrc, args.mode)

    M = sp.csr_matrix(poisson5pt(nx, ny))
    n = M.shape[0]
    # per-rank upload of equal row blocks (the MPI-rank analog)
    rc, dist = amgx.AMGX_distribution_create(cfg)
    nl = -(-n // n_parts)
    offsets = np.minimum(np.arange(n_parts + 1) * nl, n)
    amgx.AMGX_distribution_set_partition_data(dist, 0, offsets)
    for p in range(n_parts):
        blk = sp.csr_matrix(M[offsets[p]:offsets[p + 1]])
        rc = amgx.AMGX_matrix_upload_distributed(
            A, n, blk.shape[0], blk.nnz, 1, 1, blk.indptr, blk.indices,
            blk.data, None, dist)
        assert rc == 0, (p, rc)

    rhs = np.ones(n)
    amgx.AMGX_vector_upload(b, n, 1, rhs)
    amgx.AMGX_vector_set_zero(x, n, 1)
    rc, solver = amgx.AMGX_solver_create(rsrc, args.mode, cfg)
    assert amgx.AMGX_solver_setup(solver, A) == 0
    assert amgx.AMGX_solver_solve(solver, b, x) == 0
    rc, status = amgx.AMGX_solver_get_status(solver)
    rc, iters = amgx.AMGX_solver_get_iterations_number(solver)
    rc, nrm = amgx.AMGX_solver_calculate_residual_norm(solver, A, b, x)
    print(f"status={status} iterations={iters} residual={nrm:.3e}")
    amgx.AMGX_finalize()
    return 0 if status == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

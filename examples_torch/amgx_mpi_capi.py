#!/usr/bin/env python
"""Distributed global-upload driver of the port — mirror of
``examples/amgx_mpi_capi.c``: read the full system once, partition rows
equally, upload through ``AMGX_matrix_upload_all_global`` with a
partition vector, solve, report.

The reference runs one MPI process per rank with every rank passing the
global matrix; the port performs the identical upload in one process
and keeps every rank's rows as one shard of a mesh on the mode's
device (the halo exchange runs between the shards).

Usage: amgx_mpi_capi.py -m matrix.mtx [-p 4] [-mode dDDI] [-c cfg.json]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np
import scipy.sparse as sp

from amgx_tpu_torch import capi as amgx
from amgx_tpu_torch.io import read_system_auto

CONFIG = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
          "out:monitor_residual=1, out:tolerance=1e-8, "
          "out:convergence=RELATIVE_INI, out:gmres_n_restart=20, "
          "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
          "amg:selector=SIZE_2, amg:max_iters=1, "
          "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
          "amg:presweeps=1, amg:postsweeps=2, amg:min_coarse_rows=16, "
          "amg:coarse_solver=DENSE_LU_SOLVER")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--matrix", required=True)
    ap.add_argument("-p", "--partitions", type=int, default=4)
    ap.add_argument("-mode", "--mode", default="dDDI")
    ap.add_argument("-c", "--config", default=None)
    args = ap.parse_args()

    assert amgx.AMGX_initialize() == 0
    if args.config:
        rc, cfg = amgx.AMGX_config_create_from_file(args.config)
    else:
        rc, cfg = amgx.AMGX_config_create(CONFIG)
    assert rc == 0, rc
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, args.mode)
    rc, b = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, x = amgx.AMGX_vector_create(rsrc, args.mode)

    # every "rank" holds the global system (amgx_mpi_capi.c flow); a
    # partition vector assigns rows in contiguous blocks to P ranks
    system = read_system_auto(args.matrix)
    M, rhs = sp.csr_matrix(system.A), system.rhs
    n = M.shape[0]
    P = args.partitions
    partition = np.repeat(np.arange(P), -(-n // P))[:n]

    rc = amgx.AMGX_matrix_upload_all_global(
        A, n, n, M.nnz, 1, 1, M.indptr, M.indices.astype(np.int64),
        M.data, None, 1, 1, partition)
    assert rc == 0, rc
    if rhs is None:
        rhs = np.ones(n)
    amgx.AMGX_vector_bind(b, A)
    amgx.AMGX_vector_bind(x, A)
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

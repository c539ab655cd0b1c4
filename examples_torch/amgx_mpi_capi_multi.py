#!/usr/bin/env python
"""Multi-rank-per-device driver of the port — mirror of
``examples/amgx_mpi_capi_multi.c``: MORE MPI ranks than devices, each
rank selecting device ``rank % device_count`` (the reference's
``lrank = rank %% gpu_count`` + ``cudaSetDevice(lrank)``), with the row
partition given by an explicit partition VECTOR (``-partvec``).

The port holds a mesh's shards on one device, which is what several
ranks sharing one card are: every rank selects device 0 (the mode's
card, or the CPU for an ``h…`` mode), rows are renumbered
rank-contiguously, and each rank's rows become one shard, uploaded
through ``AMGX_matrix_upload_distributed``.

Usage: amgx_mpi_capi_multi.py -m matrix.mtx [-p 8] [-partvec file]
                              [-mode dDDI] [-c cfg.json]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from amgx_tpu_torch import capi as amgx
from amgx_tpu_torch.io import read_system_auto

CONFIG = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
          "out:monitor_residual=1, out:tolerance=1e-8, "
          "out:convergence=RELATIVE_INI, out:gmres_n_restart=20, "
          "out:store_res_history=1, "
          "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
          "amg:selector=SIZE_2, amg:max_iters=1, "
          "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
          "amg:presweeps=1, amg:postsweeps=2, amg:min_coarse_rows=16, "
          "amg:coarse_solver=DENSE_LU_SOLVER")

#: the devices the ranks fold onto: the port's mesh lives on one
N_DEVICES = 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--matrix", required=True)
    ap.add_argument("-p", "--ranks", type=int, default=8,
                    help="number of simulated MPI ranks (> devices)")
    ap.add_argument("-partvec", "--partvec", default=None,
                    help="binary int32 partition vector file (one rank "
                         "id per row), as the reference -partvec")
    ap.add_argument("-mode", "--mode", default="dDDI")
    ap.add_argument("-c", "--config", default=None)
    args = ap.parse_args()

    assert amgx.AMGX_initialize() == 0
    rc, cfg = (amgx.AMGX_config_create_from_file(args.config)
               if args.config else amgx.AMGX_config_create(CONFIG))
    assert rc == 0
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)

    # host-side read to size the partition vector (the reference reads
    # the system with AMGX_read_system inside the library too)
    sysdata = read_system_auto(args.matrix)
    A, b_in = sysdata.A.tocsr(), sysdata.rhs
    n = A.shape[0]
    if args.partvec:
        pv = np.fromfile(args.partvec, dtype=np.int32)
        if len(pv) != n:
            print(f"partition vector has {len(pv)} entries for {n} rows",
                  file=sys.stderr)
            return 1
        n_ranks = int(pv.max()) + 1
    else:
        n_ranks = args.ranks
        pv = (np.arange(n) * n_ranks // max(n, 1)).astype(np.int32)

    # rank → device folding (lrank = rank % device_count); the rows are
    # renumbered rank-contiguously, each rank one shard of the mesh
    dev_of_rank = np.arange(n_ranks, dtype=np.int32) % N_DEVICES
    order = np.argsort(pv, kind="stable")
    A = A[order][:, order].tocsr()
    b_vec = b_in[order] if b_in is not None else np.ones(n)
    counts = np.bincount(pv, minlength=n_ranks)
    for r in range(n_ranks):
        print(f"Process {r} selecting device {int(dev_of_rank[r])} "
              f"({int(counts[r])} rows)")

    rc, A_h = amgx.AMGX_matrix_create(rsrc, args.mode)
    rc, b_h = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, x_h = amgx.AMGX_vector_create(rsrc, args.mode)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    rc = amgx.AMGX_matrix_upload_distributed(
        A_h, n, n, A.nnz, 1, 1, A.indptr, A.indices, A.data, None,
        {"partition_offsets": offsets, "num_partitions": n_ranks})
    assert rc == 0, rc
    amgx.AMGX_vector_upload(b_h, n, 1, b_vec)
    amgx.AMGX_vector_set_zero(x_h, n, 1)

    rc, solver = amgx.AMGX_solver_create(rsrc, args.mode, cfg)
    amgx.AMGX_solver_setup(solver, A_h)
    amgx.AMGX_solver_solve(solver, b_h, x_h)
    rc, status = amgx.AMGX_solver_get_status(solver)
    rc, iters = amgx.AMGX_solver_get_iterations_number(solver)
    rc, resid = amgx.AMGX_solver_get_iteration_residual(solver, iters, 0)
    resid_s = f"{resid:.3e}" if resid is not None else "n/a"
    print(f"status={int(status)} iterations={iters} residual={resid_s}")

    amgx.AMGX_solver_destroy(solver)
    amgx.AMGX_matrix_destroy(A_h)
    amgx.AMGX_vector_destroy(b_h)
    amgx.AMGX_vector_destroy(x_h)
    amgx.AMGX_resources_destroy(rsrc)
    amgx.AMGX_config_destroy(cfg)
    amgx.AMGX_finalize()
    return 0 if int(status) == 0 else 2


if __name__ == "__main__":
    sys.exit(main())

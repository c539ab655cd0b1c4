#!/usr/bin/env python
"""Distributed aggregation-AMG driver of the port — mirror of
``examples/amgx_mpi_capi_agg.c``: per-rank one-ring system read →
per-rank upload with user comm maps → FGMRES + aggregation AMG solve.

The reference runs one MPI process per rank; the port loops the ranks
in one process (the maps/upload flow per rank is identical), and each
rank's rows become one shard of a mesh on the mode's device.

Usage: amgx_mpi_capi_agg.py -m matrix.mtx [-p 4] [-mode dDDI]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from amgx_tpu_torch import capi as amgx

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
    args = ap.parse_args()

    assert amgx.AMGX_initialize() == 0
    rc, cfg = amgx.AMGX_config_create(CONFIG)
    assert rc == 0, rc
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, args.mode)
    rc, b = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, x = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, dist = amgx.AMGX_distribution_create(cfg)

    # ---- per-rank one-ring reads (amgx_mpi_capi_agg.c flow) ----
    P = args.partitions
    rings, offsets = [], [0]
    for r in range(P):
        rc, ring = amgx.AMGX_read_system_maps_one_ring(
            rsrc, args.mode, args.matrix, 1, P, rank=r)
        assert rc == 0, rc
        rings.append(ring)
        offsets.append(offsets[-1] + ring.n)
    n_glob = offsets[-1]
    amgx.AMGX_distribution_set_partition_data(dist, 0, np.asarray(offsets))

    # per-rank upload + comm maps: halo slots resolve to global ids
    # through the neighbours' send maps — exactly what the maps protocol
    # carries between ranks
    for r, ring in enumerate(rings):
        H = int(max(ring.col_indices.max() + 1 - ring.n, 0)) \
            if ring.nnz else 0
        ext_global = np.zeros(max(H, 1), dtype=np.int64)
        for qi, q in enumerate(ring.neighbors):
            rq = rings[q]
            ri = int(np.flatnonzero(rq.neighbors == r)[0])
            slots = ring.recv_maps[qi] - ring.n
            ext_global[slots] = rq.send_maps[ri].astype(np.int64) + \
                offsets[q]
        gcols = ring.col_indices.astype(np.int64)
        gcols = np.where(gcols < ring.n, gcols + offsets[r],
                         ext_global[np.clip(gcols - ring.n, 0,
                                            max(H - 1, 0))])
        rc = amgx.AMGX_matrix_upload_distributed(
            A, n_glob, ring.n, ring.nnz, 1, 1, ring.row_ptrs, gcols,
            ring.data, None, dist)
        assert rc == 0, (r, rc)
        rc = amgx.AMGX_matrix_comm_from_maps_one_ring(
            A, 1, ring.num_neighbors, ring.neighbors, ring.send_sizes,
            ring.send_maps, ring.recv_sizes, ring.recv_maps)
        assert rc == 0, (r, rc)

    rhs = np.concatenate([ring.rhs for ring in rings])
    amgx.AMGX_vector_upload(b, n_glob, 1, rhs)
    amgx.AMGX_vector_set_zero(x, n_glob, 1)

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

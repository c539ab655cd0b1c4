#!/usr/bin/env python
"""Distributed eigensolver driver of the port — mirror of
``eigen_examples/eigensolver_mpi.c``: the matrix is read with a row
partition (the shards of one mesh on the mode's device) before running
the configured eigensolver.

Usage: eigensolver_mpi.py -m matrix.mtx [-p 4] [--solver LANCZOS]
                          [-mode dDDI]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from amgx_tpu_torch import capi as amgx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--matrix", required=True)
    ap.add_argument("-p", "--partitions", type=int, default=4)
    ap.add_argument("--solver", default="LANCZOS")
    ap.add_argument("-mode", "--mode", default="dDDI")
    args = ap.parse_args()

    cfg_str = (f"config_version=2, eig_solver(e)={args.solver}, "
               "e:eig_max_iters=200, e:eig_tolerance=1e-8, "
               "e:eig_wanted_count=1")
    amgx.AMGX_initialize()
    rc, cfg = amgx.AMGX_config_create(cfg_str)
    assert rc == 0, rc
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, args.mode)
    # distributed read: equal row split (the reference reads per rank
    # with a partition vector)
    rc = amgx.AMGX_read_system_distributed(
        A, None, None, args.matrix, 1, args.partitions, None, None)
    assert rc == 0, rc
    rc, n, bx, by = amgx.AMGX_matrix_get_size(A)
    print(f"Matrix: {n} rows across {args.partitions} partitions")

    rc, es = amgx.AMGX_eigensolver_create(rsrc, args.mode, cfg)
    assert rc == 0, rc
    assert amgx.AMGX_eigensolver_setup(es, A) == 0
    rc, x = amgx.AMGX_vector_create(rsrc, args.mode)
    assert amgx.AMGX_eigensolver_solve(es, x) == 0
    print("eigenvalues:", np.asarray(es.last_result.eigenvalues))
    amgx.AMGX_finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())

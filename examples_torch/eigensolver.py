#!/usr/bin/env python
"""Eigensolver CLI of the port — mirror of
``eigen_examples/eigensolver.c``: read a matrix, run the configured
eigensolver, print the eigenvalue(s).

Usage: eigensolver.py -m matrix.mtx -c "eig_solver(e)=LANCZOS, ..."
       eigensolver.py -m matrix.mtx --solver POWER_ITERATION [-mode dDDI]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from amgx_tpu_torch import capi as amgx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--matrix", required=True)
    ap.add_argument("-c", "--config", default=None,
                    help="config string (eig_* params)")
    ap.add_argument("--solver", default="LANCZOS",
                    help="eigensolver name when -c not given")
    ap.add_argument("-mode", "--mode", default="dDDI")
    args = ap.parse_args()

    cfg_str = args.config or (
        f"config_version=2, eig_solver(e)={args.solver}, "
        "e:eig_max_iters=200, e:eig_tolerance=1e-8, e:eig_wanted_count=1")

    assert amgx.AMGX_initialize() == 0
    rc, cfg = amgx.AMGX_config_create(cfg_str)
    assert rc == 0, rc
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, args.mode)
    rc = amgx.AMGX_read_system(A, None, None, args.matrix)
    assert rc == 0, rc
    rc, n, bx, by = amgx.AMGX_matrix_get_size(A)
    print(f"Matrix: {n} rows")

    rc, es = amgx.AMGX_eigensolver_create(rsrc, args.mode, cfg)
    assert rc == 0, rc
    assert amgx.AMGX_eigensolver_setup(es, A) == 0
    rc, x = amgx.AMGX_vector_create(rsrc, args.mode)
    assert amgx.AMGX_eigensolver_solve(es, x) == 0
    res = es.last_result
    print("eigenvalues:", np.asarray(res.eigenvalues))
    amgx.AMGX_finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())

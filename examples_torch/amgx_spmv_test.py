#!/usr/bin/env python
"""SpMV benchmark of the port — mirror of ``examples/amgx_spmv_test.c``:
upload a matrix, time y = A·x through ``AMGX_matrix_vector_multiply``
(on the card the pack's hand kernel), report GFLOPS and the pack format.

Usage: amgx_spmv_test.py -m matrix.mtx [-r 50] [-mode dDDI]
       amgx_spmv_test.py --poisson 64 [-r 50] [-mode dDDI]
"""
import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from amgx_tpu_torch import capi as amgx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--matrix")
    ap.add_argument("--poisson", type=int, default=0,
                    help="generate a 3D n^3 Poisson instead of reading")
    ap.add_argument("-r", "--reps", type=int, default=50)
    ap.add_argument("-mode", "--mode", default="dDDI")
    args = ap.parse_args()

    assert amgx.AMGX_initialize() == 0
    rc, cfg = amgx.AMGX_config_create("config_version=2, solver(s)=PCG")
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, args.mode)
    rc, x = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, y = amgx.AMGX_vector_create(rsrc, args.mode)

    if args.poisson:
        rc, _, _ = amgx.AMGX_generate_distributed_poisson_7pt(
            A, x, y, args.poisson, args.poisson, args.poisson)
        assert rc == 0, rc
    else:
        assert args.matrix, "need -m or --poisson"
        rc = amgx.AMGX_read_system(A, None, None, args.matrix)
        assert rc == 0, rc

    rc, n, bx, by = amgx.AMGX_matrix_get_size(A)
    rc, nnz = amgx.AMGX_matrix_get_nnz(A)
    v = np.random.default_rng(0).standard_normal(n * bx)
    amgx.AMGX_vector_upload(x, n, bx, v)

    # warm (builds the pack, and on the card loads the kernel)
    assert amgx.AMGX_matrix_vector_multiply(A, x, y) == 0
    rc, _ = amgx.AMGX_vector_download(y)     # sync
    t0 = time.perf_counter()
    for _ in range(args.reps):
        amgx.AMGX_matrix_vector_multiply(A, x, y)
    rc, out = amgx.AMGX_vector_download(y)   # sync
    dt = (time.perf_counter() - t0) / args.reps
    fmt = A.matrix.device(dtype=A.mode.mat_dtype).fmt
    print(f"n={n} nnz={nnz} fmt={fmt}: {dt*1e6:.1f} us/spmv  "
          f"{2.0*nnz*bx*by/dt/1e9:.2f} GFLOPS")
    amgx.AMGX_finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Single-device C-API example of the port — mirror of
``examples/amgx_capi.c`` (reference :373-440): read system → setup →
solve → download.  ``-mode dDDI`` (the default) runs on the card,
``hDDI`` on the CPU.

Usage: amgx_capi.py -m matrix.mtx -c config.json [-mode dDDI]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from amgx_tpu_torch import capi as amgx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--matrix", required=True)
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-mode", "--mode", default="dDDI")
    args = ap.parse_args()

    rc = amgx.AMGX_initialize()
    assert rc == 0
    rc, cfg = amgx.AMGX_config_create_from_file(args.config)
    assert rc == 0, rc
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, args.mode)
    rc, b = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, x = amgx.AMGX_vector_create(rsrc, args.mode)
    rc = amgx.AMGX_read_system(A, b, x, args.matrix)
    assert rc == 0, rc
    rc, n, bx, by = amgx.AMGX_matrix_get_size(A)
    print(f"Matrix: {n} block rows ({bx}x{by} blocks)")

    rc, solver = amgx.AMGX_solver_create(rsrc, args.mode, cfg)
    assert rc == 0, rc
    rc = amgx.AMGX_solver_setup(solver, A)
    assert rc == 0, rc
    rc = amgx.AMGX_solver_solve(solver, b, x)
    assert rc == 0, rc
    rc, status = amgx.AMGX_solver_get_status(solver)
    rc, iters = amgx.AMGX_solver_get_iterations_number(solver)
    rc, nrm = amgx.AMGX_solver_calculate_residual_norm(solver, A, b, x)
    print(f"status={status} iterations={iters} residual={nrm:.3e}")

    for h, d in ((solver, amgx.AMGX_solver_destroy),
                 (A, amgx.AMGX_matrix_destroy),
                 (b, amgx.AMGX_vector_destroy),
                 (x, amgx.AMGX_vector_destroy),
                 (rsrc, amgx.AMGX_resources_destroy),
                 (cfg, amgx.AMGX_config_destroy)):
        d(h)
    amgx.AMGX_finalize()
    return 0 if status == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Multi-instance driver of the port — mirror of
``examples/amgx_capi_multi.c``: several independent solver instances
running concurrently from worker threads, each with its own
config/resources/matrix handles (on the card their setups and solves
take turns through the card's lock).

Usage: amgx_capi_multi.py -m matrix.mtx [-t 4] [-mode dDDI]
"""
import argparse
import sys
import threading

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from amgx_tpu_torch import capi as amgx

CONFIG = ("config_version=2, solver(s)=PCG, "
          "s:preconditioner(p)=BLOCK_JACOBI, p:max_iters=3, "
          "s:max_iters=200, s:monitor_residual=1, s:tolerance=1e-8, "
          "s:convergence=RELATIVE_INI")


def worker(tid, path, mode, results):
    try:
        _worker(tid, path, mode, results)
    except Exception as e:          # report, don't die silently
        results[tid] = (f"exception: {e!r}", -1)


def _worker(tid, path, mode, results):
    rc, cfg = amgx.AMGX_config_create(CONFIG)
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, mode)
    rc, b = amgx.AMGX_vector_create(rsrc, mode)
    rc, x = amgx.AMGX_vector_create(rsrc, mode)
    rc = amgx.AMGX_read_system(A, b, x, path)
    if rc != 0:
        results[tid] = ("read failed", rc)
        return
    rc, n, _, _ = amgx.AMGX_matrix_get_size(A)
    amgx.AMGX_vector_set_zero(x, n, 1)
    rc, solver = amgx.AMGX_solver_create(rsrc, mode, cfg)
    amgx.AMGX_solver_setup(solver, A)
    amgx.AMGX_solver_solve(solver, b, x)
    rc, status = amgx.AMGX_solver_get_status(solver)
    rc, iters = amgx.AMGX_solver_get_iterations_number(solver)
    results[tid] = (status, iters)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--matrix", required=True)
    ap.add_argument("-t", "--threads", type=int, default=4)
    ap.add_argument("-mode", "--mode", default="dDDI")
    args = ap.parse_args()

    assert amgx.AMGX_initialize() == 0
    results = {}
    threads = [threading.Thread(target=worker,
                                args=(i, args.matrix, args.mode, results))
               for i in range(args.threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ok = len(results) == args.threads
    for tid in sorted(results):
        status, iters = results[tid]
        print(f"thread {tid}: status={status} iterations={iters}")
        ok = ok and status == 0
    amgx.AMGX_finalize()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

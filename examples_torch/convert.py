#!/usr/bin/env python
"""Matrix file converter of the port — mirror of ``examples/convert.c``:
read a system in any supported format (MatrixMarket / NVAMGBinary, auto
detected) with ``AMGX_read_system`` and write it with
``AMGX_write_system`` in the format the config's ``matrix_writer``
names.

Usage: convert.py input.mtx output.bin [--format binary|matrixmarket]
                  [-mode dDDI]
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from amgx_tpu_torch import capi as amgx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--format", choices=("binary", "matrixmarket"),
                    default=None, help="default: by output extension")
    ap.add_argument("-mode", "--mode", default="dDDI")
    args = ap.parse_args()

    fmt = args.format or ("binary" if args.output.endswith(".bin")
                          else "matrixmarket")
    assert amgx.AMGX_initialize() == 0
    rc, cfg = amgx.AMGX_config_create(
        f"config_version=2, matrix_writer={fmt}")
    assert rc == 0, rc
    rc, rsrc = amgx.AMGX_resources_create_simple(cfg)
    rc, A = amgx.AMGX_matrix_create(rsrc, args.mode)
    rc, b = amgx.AMGX_vector_create(rsrc, args.mode)
    rc, x = amgx.AMGX_vector_create(rsrc, args.mode)
    rc = amgx.AMGX_read_system(A, b, x, args.input)
    assert rc == 0, rc
    rc = amgx.AMGX_write_system(A, b, x, args.output)
    assert rc == 0, rc
    rc, n, bx, by = amgx.AMGX_matrix_get_size(A)
    rc, nnz = amgx.AMGX_matrix_get_nnz(A)
    print(f"wrote {args.output} ({fmt}): {n * bx} rows, {nnz * bx * by} "
          "nnz")
    amgx.AMGX_finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())

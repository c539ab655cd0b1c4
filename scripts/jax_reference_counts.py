#!/usr/bin/env python3
"""Iteration counts of the JAX package (the port's reference) on the
CPU, for the stacks of ``chip_smoke.py`` whose full-size counts the card
reports:

* ``dist``: phase 40a's stack (``chip_smoke.DIST_CFG``) on
  ``generate_distributed_poisson_7pt(B, B, B, 2, 2, 2)`` in 8 shards on
  8 virtual CPU devices, for each brick side B of ``--bricks``;
* ``dzzi``: phase 36's headline stack on the shifted Helmholtz operator
  at 24³ (``chip_smoke.helmholtz``), on phase 36's right-hand side
  (``chip_smoke.complex_rhs``) and on b = 1.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_counts.py
        [--cases dist dzzi] [--bricks 6 8 16]

Prints one JSON line per case.  It runs the JAX package, never the port,
and never on a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=["dist", "dzzi"],
                    choices=["dist", "dzzi"])
    ap.add_argument("--bricks", nargs="+", type=int, default=[6, 8, 16])
    a = ap.parse_args()
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import numpy as np
    import jax
    import amgx_tpu as jx
    from amgx_tpu.distributed.partition import \
        partition_offsets_from_vector
    from amgx_tpu.io import generate_distributed_poisson_7pt
    import chip_smoke as cs
    if "dist" in a.cases:
        mesh = jax.make_mesh((8,), ("p",))
        for brick in a.bricks:
            t0 = time.perf_counter()
            A, pv = generate_distributed_poisson_7pt(brick, brick, brick,
                                                     2, 2, 2)
            m = jx.Matrix(A)
            m.set_distribution(mesh,
                               offsets=partition_offsets_from_vector(pv, 8))
            slv = jx.create_solver(jx.AMGConfig(cs.DIST_CFG))
            slv.setup(m)
            b = np.ones(A.shape[0])
            res = slv.solve(b)
            x = np.asarray(res.x)
            print(json.dumps(dict(
                case="dist", brick=brick, n=A.shape[0],
                iterations=int(res.iterations), status=int(res.status),
                relres=float(np.linalg.norm(b - A @ x)
                             / np.linalg.norm(b)),
                levels=len(slv.preconditioner.hierarchy.levels) + 1,
                seconds=time.perf_counter() - t0)), flush=True)
    if "dzzi" in a.cases:
        A = cs.helmholtz(24)
        for label, b in (("phase36_rhs", cs.complex_rhs(A.shape[0],
                                                        np.complex128)),
                         ("ones", np.ones(A.shape[0], np.complex128))):
            slv = jx.create_solver(jx.AMGConfig(cs.COMPLEX_CFG))
            slv.setup(jx.Matrix(A))
            res = slv.solve(b)
            x = np.asarray(res.x)
            print(json.dumps(dict(
                case="dzzi", side=24, rhs=label,
                iterations=int(res.iterations), status=int(res.status),
                relres=float(np.linalg.norm(b - A @ x)
                             / np.linalg.norm(b)))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

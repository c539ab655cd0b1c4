"""PCG_PIPE or PCG_CA on the classical stack (``chip_smoke.CFG_CLA``)
with an f32 pack and the f64 refinement, the port on the CPU against the
JAX package — too slow for the test tier at the sizes where it matters,
so it runs by hand:

    JAX_PLATFORMS=cpu python3 tests/torch_pipe_parity.py --side 48
    JAX_PLATFORMS=cpu python3 tests/torch_pipe_parity.py \
        --solver PCG_CA --side 80

It prints one JSON line per package: iterations, status, the failure
kind and its first iteration.  In f32 the single-reduction recurrences
lose A-conjugacy after a true-residual replacement and the breakdown
guard reports pAp < 0: PCG_PIPE at 48³ (iteration 11), PCG_CA at 80³
with ``--theta 0.2401`` (iteration 21), in both packages alike; with an
f64 pack they converge.  At the default θ = 0.25 the 7-point strength
test ties, the two packages' hierarchies may differ, and so may the
outcome (PCG_CA at 80³: the JAX package converges in 37 iterations, the
port stops at 21).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import amgx_tpu as jx  # noqa: E402
import amgx_tpu_torch as amgx  # noqa: E402
from amgx_tpu_torch.io import poisson7pt  # noqa: E402
from chip_smoke import CFG_CLA  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=48)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--solver", default="PCG_PIPE",
                    choices=("PCG_PIPE", "PCG_CA"))
    ap.add_argument("--theta", type=float, default=None,
                    help="amg:strength_threshold (0.2401 avoids the "
                    "7-point strength ties of the default 0.25)")
    args = ap.parse_args()
    A = poisson7pt(args.side, args.side, args.side)
    cfg = CFG_CLA.replace("solver(out)=PCG", f"solver(out)={args.solver}")
    if args.theta is not None:
        cfg += f", amg:strength_threshold={args.theta}"
    for name, pkg, mk in (
            ("jax", jx, lambda: jx.Matrix(A)),
            ("port", amgx, lambda: amgx.Matrix(A, device="cpu"))):
        m = mk()
        m.device_dtype = np.dtype(args.dtype)
        slv = pkg.create_solver(jx.AMGConfig(cfg) if name == "jax"
                                else cfg)
        slv.setup(m)
        res = slv.solve(np.ones(A.shape[0]))
        fail = res.failure
        print(json.dumps(dict(
            package=name, solver=args.solver, side=args.side,
            pack=args.dtype, theta=args.theta,
            iterations=int(res.iterations), status=int(res.status),
            failure=None if fail is None else fail.kind.value,
            first_bad_iteration=None if fail is None else fail.iteration)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

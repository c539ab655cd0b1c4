#!/usr/bin/env python3
"""Which value drift the DFG path of ``chip_smoke.py`` phase 29 can
solve: a fresh setup and solve of b = 1 (the headline config cut at
``DFG_LEVELS``, as phase 19) on the DFG pressure Poisson after one step
of each drift, on one card.

    python3 scripts/torch_dfg_drift.py [--ny 320 512] [--max-iters N]

The drifts (``chip_smoke.drift_values`` and
``chip_smoke.coupling_drift_values``, k = 1):

* ``DAD``: A₁ = D₁·A₀·D₁, D₁ = diag(1 + 0.1·u) — the rows and columns
  scaled, so the operator's near-null vector becomes D₁⁻¹·1, which the
  piecewise-constant aggregates no longer hold;
* ``coupling``: each coupling scaled by 1 + 0.1·(u_i + u_j)/2 with the
  row sums kept — a variable-coefficient change that keeps the constant
  vector's energy.

For each ny, drift and pack dtype (f32 with the f64 refinement, and
f64): iterations, status and the true relres in f64 on the host, one
JSON line each, with the card's ``nvidia-smi`` name and power limit.
Without a CUDA device the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_dfg_drift: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import amgx_tpu_torch as amgx
    import chip_smoke as cs
    from amgx_tpu_torch.io import dfg_cylinder_pressure
    ap = argparse.ArgumentParser()
    ap.add_argument("--ny", type=int, nargs="+", default=[320, 512])
    ap.add_argument("--max-iters", type=int, default=100)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = cs.DFG_CFG.replace("out:max_iters=100",
                             f"out:max_iters={args.max_iters}")
    drifts = {"DAD": cs.drift_values, "coupling": cs.coupling_drift_values}
    for ny in args.ny:
        A0 = dfg_cylinder_pressure(ny)
        for name, drift in drifts.items():
            A1 = A0.copy()
            A1.data = drift(A0, 1)
            for pdt in (np.float32, np.float64):
                m = amgx.Matrix(A1, device="cuda")
                m.device_dtype = pdt
                t0 = time.perf_counter()
                slv = amgx.create_solver(cfg)
                slv.setup(m)
                res = slv.solve(torch.ones(A1.shape[0], dtype=torch.float64,
                                           device="cuda"))
                torch.cuda.synchronize()
                print(json.dumps(dict(
                    ny=ny, rows=A1.shape[0], drift=name,
                    pack=np.dtype(pdt).name, iterations=res.iterations,
                    status=res.status.name,
                    relres_f64=cs.host_relres(A1)(res.x),
                    seconds=time.perf_counter() - t0, card=smi)),
                    flush=True)
                del slv, m, res
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

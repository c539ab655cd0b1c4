#!/usr/bin/env python3
"""The DFG cylinder path of the port (``chip_smoke.py`` phase 19: the
headline config on the ny = 512 DFG pressure Poisson, f32 pack) at the
headline config's own depth (``amg:max_levels=20``) and at the smoke's
cut (``DFG_LEVELS``), on one card: levels and their rows, setup time,
and the time and SpMV launches of one application of the AMG
preconditioner (one CG K-cycle, which visits level i 2^i times).

    python3 scripts/torch_dfg_depth.py [--ny 512]

Each depth sets up once, then applies the preconditioner to a vector of
ones twice: the first application warms up, the second is timed (host
clock around it, ending in ``torch.cuda.synchronize``) with every launch
count set to 0 just before and read just after.  One JSON line per depth,
with the card's ``nvidia-smi`` name and power limit.  Without a CUDA
device the script exits non-zero.
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ny", type=int, default=512)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_dfg_depth: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import dfg_cylinder_pressure
    from chip_smoke import (DFG_CFG, DFG_LEVELS, HEADLINE_CFG, read_counts,
                            reset_counts)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    A = dfg_cylinder_pressure(args.ny)
    n = A.shape[0]
    for label, cfg in (("max_levels=20", HEADLINE_CFG),
                       (f"max_levels={DFG_LEVELS}", DFG_CFG)):
        m = amgx.Matrix(A, device="cuda")
        m.device_dtype = np.float32
        slv = amgx.create_solver(cfg)
        t0 = time.perf_counter()
        slv.setup(m)
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        h = slv.preconditioner.hierarchy
        r = torch.ones(n, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        slv.preconditioner.apply(r)
        torch.cuda.synchronize(dev)
        first_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        z = slv.preconditioner.apply(r)
        torch.cuda.synchronize(dev)
        apply_s = time.perf_counter() - t0
        counts = read_counts()
        assert torch.isfinite(z).all().item()
        print(json.dumps(dict(
            depth=label, ny=args.ny, rows=n,
            levels=[lv.level_stats()[0] for lv in h.levels]
            + [h.coarsest.n_block_rows],
            setup_s=setup_s, first_apply_s=first_s, apply_s=apply_s,
            spmv_launches_per_apply=dict(B2=counts["B2"], B3=counts["B3"]),
            dispatch_per_apply=counts["dispatch"], card=smi)), flush=True)
        del slv, m, h, r, z
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 41 alone on one card, without the phases
before it: BASELINE config 4 on the SPE10 grid in 8 shards (41a), B5 on
its stacked block interior (41d), BASELINE config 2 — classical AMG per
rank — on the 128³ grid in 8 shards with B3 on the stacked interior
(41b), card against CPU at small size (41c).  ``--grid`` shrinks 41a's
SPE10 grid (default: its own 60 × 220 × 85) and ``--brick`` 41b's
per-rank brick (64: the 128³ grid) for a quick check; ``--single`` also
runs config 4 on one unsharded card for the count 41a is printed beside
(in the smoke, phase 13's).  Run from another tree's ``scripts/`` it
checks that tree.

    python3 scripts/torch_item8b_phases.py [--phases 41a 41b 41c]
        [--grid NX NY NZ] [--brick 64] [--single]

Prints the phases' JSON lines, then one line of the launches by path.
Without a CUDA device the script exits non-zero.
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
    ap.add_argument("--phases", nargs="+", default=["41a", "41b", "41c"],
                    choices=["41a", "41b", "41c"])
    ap.add_argument("--grid", type=int, nargs=3, default=None)
    ap.add_argument("--brick", type=int, default=None)
    ap.add_argument("--single", action="store_true")
    a = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_item8b_phases: no CUDA device available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch import native
    from amgx_tpu_torch.io import spe10_block_system
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    if a.brick:
        cs.DIST_CLA_BRICK = a.brick
    t0 = time.perf_counter()
    native.build_all(("dia_spmv", "ell_spmv", "binned_spmv", "shift_spmv"))
    cs.emit("build", seconds=time.perf_counter() - t0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    paths = {}
    for p in a.phases:
        t = time.perf_counter()
        if p == "41a":
            A = spe10_block_system(*a.grid) if a.grid else \
                spe10_block_system()
            single = None
            if a.single:
                m1 = amgx.Matrix(A, block_dim=4, device="cuda")
                m1.device_dtype = np.float32
                s1 = amgx.create_solver(cs.CFG4)
                s1.setup(m1)
                single = s1.solve(np.ones(A.shape[0])).iterations
                del s1, m1
            head = cs.dist_config4_phase(amgx, dev, smi, gen, A, single,
                                         grid=a.grid or (60, 220, 85))
            cs.stacked_b5_kernel(dev, gen, smi, head["Ad"])
            paths["dist_config4"] = head["counts"]
            del head
            torch.cuda.empty_cache()
        elif p == "41b":
            paths["dist_classical"] = cs.dist_classical_phase(
                amgx, dev, smi, gen)["counts"]
        else:
            paths.update(cs.dist_item8b_card_cpu_phase(amgx, dev, smi))
        cs.emit(f"phase_{p}_seconds", seconds=time.perf_counter() - t)
    print(json.dumps({"launches_by_path": {
        p: {k: c[k] for k in ("B1", "B2", "B3", "B4", "B5", "B5s")}
        for p, c in paths.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

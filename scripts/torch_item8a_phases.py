#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 40 alone on one card, without the phases
before it: the distributed headline in 8 shards with B3 on the stacked
interior (40a), consolidation onto sub-meshes (40b), card against CPU
(40c).  ``--brick`` shrinks 40a's per-rank brick (64: the 128³ grid) for
a quick check.  Run from another tree's ``scripts/`` it checks that
tree.

    python3 scripts/torch_item8a_phases.py [--phases 40a 40b 40c]
        [--brick 64]

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
    ap.add_argument("--phases", nargs="+", default=["40a", "40b", "40c"],
                    choices=["40a", "40b", "40c"])
    ap.add_argument("--brick", type=int, default=None)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_item8a_phases: no CUDA device available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch import native
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    if a.brick:
        cs.DIST_BRICK = a.brick
    t0 = time.perf_counter()
    native.build_all(("dia_spmv", "ell_spmv", "binned_spmv", "shift_spmv"))
    cs.emit("build", seconds=time.perf_counter() - t0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    paths = {}
    for p in a.phases:
        t = time.perf_counter()
        if p == "40a":
            paths["dist_headline"] = cs.dist_headline_phase(
                amgx, dev, smi, gen)["counts"]
        elif p == "40b":
            paths.update(cs.dist_consolidation_phase(amgx, dev, smi))
        else:
            paths.update(cs.dist_card_cpu_phase(amgx, dev, smi))
        cs.emit(f"phase_{p}_seconds", seconds=time.perf_counter() - t)
    print(json.dumps({"launches_by_path": {
        p: {k: c[k] for k in ("B1", "B2", "B3", "B4", "B5")}
        for p, c in paths.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

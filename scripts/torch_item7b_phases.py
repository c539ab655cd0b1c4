#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 36-39 alone on one card, without the phases
before them: the 12 modes and the complex headline solve (36), the
shifted and deflated operators and ``solve_multi`` (37), the eigensolvers
(38), NVAMGBinary IO and fmt ``dense`` (39).  ``--side`` and ``--pages``
shrink the full-width grids and the PageRank graph for a quick check.
Run from another tree's ``scripts/`` it checks that tree.

    python3 scripts/torch_item7b_phases.py [--phases 36 37 38 39]
        [--side 128] [--pages 1048576]

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
    ap.add_argument("--phases", nargs="+", type=int,
                    default=[36, 37, 38, 39])
    ap.add_argument("--side", type=int, default=None)
    ap.add_argument("--pages", type=int, default=None)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_item7b_phases: no CUDA device available",
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
    if a.side:
        cs.ITEM7B_SIDE = a.side
    if a.pages:
        cs.PR_PAGES = a.pages
    t0 = time.perf_counter()
    native.build_all(("dia_spmv", "ell_spmv", "binned_spmv", "shift_spmv"))
    cs.emit("build", seconds=time.perf_counter() - t0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    phases = {36: cs.modes_complex_phase, 37: cs.operators_multi_phase,
              38: cs.eigen_phase, 39: cs.binary_dense_phase}
    paths = {}
    for p in a.phases:
        t = time.perf_counter()
        paths.update(phases[p](amgx, dev, smi, gen))
        cs.emit(f"phase_{p}_seconds", seconds=time.perf_counter() - t)
    print(json.dumps({"launches_by_path": {
        p: {k: c[k] for k in ("B1", "B2", "B3", "B4", "B5")}
        for p, c in paths.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

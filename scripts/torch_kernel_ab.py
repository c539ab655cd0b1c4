#!/usr/bin/env python3
"""Kernel times of B1 (DIA) and B4 (scalar binned) for two source trees,
alternated on one card, so that a kernel's redesign can be told apart
from the spread between machines.

    python3 scripts/torch_kernel_ab.py --trees _parent . --rounds 1

Each run is a fresh process that imports ``amgx_tpu_torch`` from its
tree (the tree's kernels build into that tree's ``_build/``) and times
each kernel two ways with CUDA events: ``ms``, the median of 30 single
launches after 5 warm-up calls (as ``chip_smoke.py`` does; the card
idles between launches), and under the key's ``.stream`` twin 200
launches back to back after 0.3 s of them, over 200 (as in a graph
replay, where launches follow one another; :func:`stream_ms`):

* B1 on the 128³ 7-point operator (nd = 7) in (f32, f32) and (f64, f64);
* B1 on the three DIA streams of the classical path's ``dia3`` level
  (P₀, A, R₀ of the 128³ ``CFG_CLA`` hierarchy, f32 pack) in (f32, f32);
* B4 on the config-4 system's scalar expansion (SPE10 grid, 60 × 220 ×
  85 cells, ``block_native=False``) in (f32, f32) and (f64, f64).

The runs go A B B A (``--rounds`` times).  One JSON line per run, then
one summary line with the card and each tree's median per timing over
its runs.  Without a CUDA device the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stream_ms(fn, warm_s=0.3, reps=200) -> float:
    """Milliseconds a launch of ``fn()`` over ``reps`` back-to-back
    launches, after ``warm_s`` seconds of them."""
    import torch
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def one(tree: str) -> dict:
    """Every timing of the module docstring with the package in ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.core.matrix import pack_device
    from amgx_tpu_torch.io import (poisson7pt, poisson7pt_device,
                                   spe10_block_system)
    from amgx_tpu_torch.ops import binned_spmv as bmod
    from amgx_tpu_torch.ops import dia_spmv as dmod
    assert os.path.dirname(os.path.dirname(amgx.__file__)) == tree, \
        amgx.__file__
    sys.path.insert(1, ROOT)
    from chip_smoke import CFG_CLA, time_ms
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}

    def both(key, fn):
        out[key] = time_ms(fn, dev)
        out[key + ".stream"] = stream_ms(fn)

    A = poisson7pt_device(128, 128, 128, device_dtype=np.float64,
                          device=dev).device()
    for dt in (torch.float32, torch.float64):
        vals = A.vals.to(dt).contiguous()
        x = torch.randn(A.n_cols, dtype=dt, device=dev, generator=gen)
        both(f"B1.128^3.{dt}",
             lambda: dmod.dia_spmv(vals, x, A.dia_offsets))
    del A, vals
    m = amgx.Matrix(poisson7pt(128, 128, 128), device="cuda")
    m.device_dtype = np.float32
    slv = amgx.create_solver(CFG_CLA)
    slv.setup(m)
    lv = next(lv for lv in slv.preconditioner.hierarchy.levels
              if lv.Ad.fmt == "dia3")
    for name in ("P", "A", "R"):
        M = getattr(lv.Ad, name)
        vals = M.vals.to(torch.float32).contiguous()
        x = torch.randn(M.n_cols, dtype=torch.float32, device=dev,
                        generator=gen)
        both(f"B1.dia3.{name}.nd{vals.shape[0]}.f32",
             lambda: dmod.dia_spmv(vals, x, M.dia_offsets))
    del slv, m, lv, M, vals
    torch.cuda.empty_cache()
    Ad = pack_device(spe10_block_system(), 4, np.float32, dia_max_diags=0,
                     device=dev, block_native=False)
    for dt in (torch.float32, torch.float64):
        M = Ad.astype(dt)
        x = torch.randn(int(Ad.bn_dims[8]), dtype=dt, device=dev,
                        generator=gen)
        both(f"B4.expansion.{dt}", lambda: bmod.binned_spmv(M, x))
        del M
    return dict(tree=tree, ms=out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
        return 0
    if not args.trees:
        ap.error("--trees A B is required")
    a, b = args.trees
    runs = {a: [], b: []}
    for _ in range(args.rounds):
        for tree in (a, b, b, a):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree],
                capture_output=True, text=True, check=True).stdout
            rec = json.loads(out.strip().splitlines()[-1])
            rec["tree_arg"] = tree
            print(json.dumps(rec), flush=True)
            runs[tree].append(rec)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "summary": {
        t: {k: statistics.median(x["ms"][k] for x in r) for k in r[0]["ms"]}
        for t, r in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

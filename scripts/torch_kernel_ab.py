#!/usr/bin/env python3
"""Kernel times of B1 (DIA), B2 (shift) and B4 (scalar binned) for two
source trees, alternated on one card, so that a kernel's redesign can be
told apart from the spread between machines.

    python3 scripts/torch_kernel_ab.py --trees _parent . --rounds 1 \
        [--kernels B1,B2,B4]

Each run is a fresh process that imports ``amgx_tpu_torch`` from its
tree (the tree's kernels build into that tree's ``_build/``) and times
each kernel two ways with CUDA events: ``ms``, ``chip_smoke.time_ms``,
the median of 30 single launches after 5 warm-up calls (the card idles
between launches, so the interval also holds the wrapper's host time),
and under the key's ``.stream`` twin 100 launches captured in one CUDA
graph and replayed back to back, over 100 (as the AMG's graph replays
them, with no host time between launches; :func:`stream_ms`).

The timings:

* B1 on the 128³ 7-point operator (nd = 7) in (f32, f32) and (f64, f64);
* B1 on the three DIA streams of the classical path's ``dia3`` level
  (P₀, A, R₀ of the 128³ ``CFG_CLA`` hierarchy, f32 pack) in (f32, f32);
* B4 on the config-4 system's scalar expansion (SPE10 grid, 60 × 220 ×
  85 cells, ``block_native=False``) in (f32, f32) and (f64, f64);
* B2 on the DFG cylinder operator's fine level at ny = 512 (1,394,214
  rows, its f32 shift pack, widened for f64) in (f32, f32) and (f64,
  f64).

``--kernels`` keeps the listed ones (default all three).  The runs go
A B B A (``--rounds`` times).  One JSON line per run, then
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    """This tree's ``chip_smoke`` module (its timing helpers), loaded by
    path: the other tree's ``chip_smoke.py`` stands first on
    ``sys.path`` in its runs."""
    import importlib.util
    mod = sys.modules.get("ab_chip_smoke")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "ab_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["ab_chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return mod


def stream_ms(fn, dev, reps=100) -> float:
    """Milliseconds a launch of ``fn()`` over ``reps`` launches captured
    in one CUDA graph and replayed back to back, the median of 5 replays
    after 2."""
    import torch
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    times = []
    for i in range(7):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        e1.synchronize()
        if i >= 2:
            times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2] / reps


def one(tree: str, kernels) -> dict:
    """The timings of the module docstring of the ``kernels`` (names
    ``B1``, ``B2``, ``B4``) with the package in ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.core.matrix import pack_device
    from amgx_tpu_torch.io import (dfg_cylinder_pressure, poisson7pt,
                                   poisson7pt_device, spe10_block_system)
    from amgx_tpu_torch.ops import binned_spmv as bmod
    from amgx_tpu_torch.ops import dia_spmv as dmod
    from amgx_tpu_torch.ops import shift_spmv as smod
    assert os.path.dirname(os.path.dirname(amgx.__file__)) == tree, \
        amgx.__file__
    CFG_CLA, time_ms = smoke().CFG_CLA, smoke().time_ms
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}

    def both(key, fn):
        out[key] = time_ms(fn, dev)
        out[key + ".stream"] = stream_ms(fn, dev)

    if "B1" in kernels:
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
    if "B4" in kernels:
        Ad = pack_device(spe10_block_system(), 4, np.float32,
                         dia_max_diags=0, device=dev, block_native=False)
        for dt in (torch.float32, torch.float64):
            M = Ad.astype(dt)
            x = torch.randn(int(Ad.bn_dims[8]), dtype=dt, device=dev,
                            generator=gen)
            both(f"B4.expansion.{dt}", lambda: bmod.binned_spmv(M, x))
            del M
        del Ad
        torch.cuda.empty_cache()
    if "B2" in kernels:
        Ad = pack_device(dfg_cylinder_pressure(512), 1, np.float32,
                         device=dev)
        assert Ad.sh_vals is not None and Ad.block_dim == 1
        for dt in (torch.float32, torch.float64):
            M = Ad.astype(dt)
            x = torch.randn(M.n_cols, dtype=dt, device=dev, generator=gen)
            both(f"B2.dfg512.{dt}", lambda: smod.shift_spmv(M, x))
            del M
    return dict(tree=tree, ms=out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--kernels", default="B1,B2,B4",
                    help="comma-separated subset of B1,B2,B4")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(args.one, args.kernels.split(","))),
              flush=True)
        return 0
    if not args.trees:
        ap.error("--trees A B is required")
    a, b = args.trees
    runs = {a: [], b: []}
    for _ in range(args.rounds):
        for tree in (a, b, b, a):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--kernels", args.kernels],
                capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-8000:])
                return proc.returncode
            out = proc.stdout
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

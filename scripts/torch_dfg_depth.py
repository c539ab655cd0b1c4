#!/usr/bin/env python3
"""The DFG cylinder path of the port (``chip_smoke.py`` phase 19: the
headline config on the ny = 512 DFG pressure Poisson, f32 pack) at the
headline config's own depth (``amg:max_levels=20``) and at the smoke's
cut (``DFG_LEVELS``), on one card: levels and their rows, setup time,
and the time and SpMV launches of one application of the AMG
preconditioner (one CG K-cycle, which visits level i 2^i times), eager
and as a replay of its CUDA graph.

    python3 scripts/torch_dfg_depth.py [--ny 512] [--solve]

Each depth sets up once, then applies the preconditioner to a vector of
ones: the first application runs eagerly and captures the graph (its
warm-up, capture and instantiation seconds, node count and pool bytes
are printed), the second is a replay, the third an eager application
(``_apply_eager``); each is timed on the host clock, ending in
``torch.cuda.synchronize``, with every launch count set to 0 just before
and read just after (a replay credits the counts its capture recorded).
With ``--solve`` each depth then runs a first and a warm solve of
``b = 1`` (iterations, seconds, true relres in f64 on the host).  One
JSON line per depth, with the card's ``nvidia-smi`` name and power
limit.  Without a CUDA device the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(fn, dev):
    """(result, seconds, counts) of ``fn()`` with every count set to 0
    just before and read just after."""
    import torch
    from chip_smoke import read_counts, reset_counts
    torch.cuda.synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0, read_counts()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ny", type=int, default=512)
    ap.add_argument("--solve", action="store_true",
                    help="also time a first and a warm solve per depth")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_dfg_depth: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import dfg_cylinder_pressure
    from chip_smoke import DFG_CFG, DFG_LEVELS, HEADLINE_CFG
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
        pre = slv.preconditioner
        h = pre.hierarchy
        r = torch.ones(n, dtype=torch.float32, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        z0, first_s, _ = timed(lambda: pre.apply(r), dev)
        graph = next(iter(pre.graphs.values()))
        z1, replay_s, replay_counts = timed(lambda: pre.apply(r), dev)
        z2, eager_s, eager_counts = timed(lambda: pre._apply_eager(r), dev)
        assert torch.isfinite(z1).all().item()
        rec = dict(
            depth=label, ny=args.ny, rows=n,
            levels=[lv.level_stats()[0] for lv in h.levels]
            + [h.coarsest.n_block_rows],
            setup_s=setup_s, first_apply_s=first_s, graph=graph.stats,
            apply_s=replay_s, eager_apply_s=eager_s,
            replay_bit_equal_to_eager=bool(torch.equal(z1, z2)
                                           and torch.equal(z0, z2)),
            replay_counts_equal_eager=replay_counts == eager_counts,
            spmv_launches_per_apply=dict(B2=replay_counts["B2"],
                                         B3=replay_counts["B3"]),
            dispatch_per_apply=replay_counts["dispatch"],
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
            card=smi)
        if args.solve:
            b = torch.ones(n, dtype=torch.float64, device=dev)
            for key in ("first", "warm"):
                res = slv.solve(b)
                assert res.status == amgx.SolveStatus.SUCCESS, res.status
                x = res.x.cpu().numpy()
                rec[f"{key}_solve"] = dict(
                    iterations=res.iterations, solve_s=res.solve_time,
                    relres_f64=float(np.linalg.norm(1.0 - A @ x)
                                     / np.sqrt(n)))
        print(json.dumps(rec), flush=True)
        del slv, m, h, pre, graph, r, z0, z1, z2
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

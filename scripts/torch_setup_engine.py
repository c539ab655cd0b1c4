#!/usr/bin/env python3
"""Setup times of the PyTorch port on one card with the device setup
engine (``device_setup=1``, the default) and without it
(``device_setup=0``), on the paths of ``chip_smoke.py``:

    python3 scripts/torch_setup_engine.py                  # every path
    python3 scripts/torch_setup_engine.py --paths dfg      # some paths
    python3 scripts/torch_setup_engine.py --phases 30 31   # smoke phases
    python3 scripts/torch_setup_engine.py --phases 30 --block-side 96

Paths (``--paths``; f32 packs unless stated):

* ``dfg``: the DFG cylinder pressure operator at ny = 512 under the
  headline config cut at 10 levels (``chip_smoke.DFG_CFG``, SIZE_2
  aggregation on the host loop), with ``structure_reuse_levels=-1``:
  setup, then one values-only resetup (the couplings drift,
  ``chip_smoke.coupling_drift_values``);
* ``classical_reuse``: phase 29's classical 128³ (``CFG_CLA``,
  θ = 0.2401, ``structure_reuse_levels=-1``, f64 pack: the host classical
  loop and the resetup plans), the engine at its default plan budget
  (256 MB), at ``device_setup_cache_mb=8192`` and off;
* ``classical``: ``CFG_CLA`` at 128³ (the device pipeline; the engine
  serves only the host tail);
* ``config4``: BASELINE config 4 (no AMG: the engine is never
  consulted; its setup time for the record).

Each setup line gives the seconds, the time inside the hierarchy's
Galerkin products and the engine's counts (plans, hits, builds,
declines by reason).  ``--phases 30 31`` runs ``chip_smoke.py``'s phases
30 and 31 alone, after building the kernels, each with a setup
without the engine before its own (the smoke runs only the engine's).
``--block-side`` sets phase 30's ``elasticity3`` side, the smoke's 96
by default.  Output: one JSON line each, and the card's ``nvidia-smi``
name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}), flush=True)


def timed_setup(amgx, make, cfg, label, **extra):
    """One setup of ``cfg`` on ``make()``: seconds, Galerkin seconds and
    the engine's counts.  Returns (solver, matrix)."""
    import torch
    import chip_smoke as cs
    from amgx_tpu_torch.amg.device_setup import engine_stats, reset_engine
    reset_engine()
    m = make()
    torch.cuda.synchronize()
    with cs.GalerkinTimer() as gt:
        t0 = time.perf_counter()
        slv = amgx.create_solver(cfg)
        slv.setup(m)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    emit("setup", path=label, setup_s=setup_s, galerkin_s=gt.seconds,
         engine=engine_stats(), **extra)
    return slv, m


def run_paths(amgx, paths):
    import torch
    import chip_smoke as cs
    from amgx_tpu_torch.amg.device_setup import engine_stats
    from amgx_tpu_torch.io import (dfg_cylinder_pressure, poisson7pt,
                                   spe10_block_system)
    reuse = ", amg:structure_reuse_levels=-1"
    if "dfg" in paths:
        A = dfg_cylinder_pressure(cs.DFG_NY)

        def make():
            m = amgx.Matrix(A, device="cuda")
            m.device_dtype = np.float32
            return m
        for ds in (1, 0):
            slv, m = timed_setup(amgx, make, cs.DFG_CFG + reuse +
                                 f", device_setup={ds}", "dfg",
                                 device_setup=ds)
            host0 = m.host.copy()
            before = engine_stats()
            with cs.GalerkinTimer() as gt:
                t0 = time.perf_counter()
                m.replace_coefficients(cs.coupling_drift_values(host0, 1))
                slv.resetup(m)
                torch.cuda.synchronize()
                resetup_s = time.perf_counter() - t0
            emit("resetup", path="dfg", device_setup=ds,
                 resetup_s=resetup_s, galerkin_s=gt.seconds,
                 last_resetup=slv.preconditioner.hierarchy.last_resetup,
                 engine_before=before, engine_after=engine_stats())
            del slv, m
            torch.cuda.empty_cache()
    if "classical_reuse" in paths or "classical" in paths:
        A = poisson7pt(128, 128, 128)
    if "classical_reuse" in paths:
        from amgx_tpu_torch.amg import hierarchy as H

        def make():
            m = amgx.Matrix(A, device="cuda")
            m.device_dtype = np.float64
            return m
        cfg = cs.CFG_CLA + ", amg:strength_threshold=0.2401" + reuse
        real = H.AMGHierarchy._build_classical_plans
        plans_s = [0.0]

        def timed_plans(hier, *a, **k):
            t0 = time.perf_counter()
            real(hier, *a, **k)
            plans_s[0] += time.perf_counter() - t0
        H.AMGHierarchy._build_classical_plans = timed_plans
        try:
            for extra in (", device_setup=1",
                          ", device_setup=1, device_setup_cache_mb=8192",
                          ", device_setup=0"):
                plans_s[0] = 0.0
                slv, m = timed_setup(amgx, make, cfg + extra,
                                     "classical_reuse", knobs=extra)
                emit("resetup_plans", path="classical_reuse", knobs=extra,
                     plans_s=plans_s[0],
                     plans=slv.preconditioner.hierarchy._cla_plans
                     is not None)
                del slv, m
                torch.cuda.empty_cache()
        finally:
            H.AMGHierarchy._build_classical_plans = real
    if "classical" in paths:
        def make():
            m = amgx.Matrix(A, device="cuda")
            m.device_dtype = np.float32
            return m
        for ds in (1, 0):
            slv, m = timed_setup(amgx, make, cs.CFG_CLA +
                                 f", device_setup={ds}", "classical",
                                 device_setup=ds)
            del slv, m
            torch.cuda.empty_cache()
    if "config4" in paths:
        A4 = spe10_block_system(*cs.FAMILY_C4_GRID)

        def make():
            m = amgx.Matrix(A4, block_dim=4, device="cuda")
            m.device_dtype = np.float32
            return m
        for ds in (1, 0):
            slv, m = timed_setup(amgx, make, cs.CFG4 +
                                 f", device_setup={ds}", "config4",
                                 device_setup=ds)
            del slv, m
            torch.cuda.empty_cache()


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", nargs="*", default=None,
                    help="default: every path, none with --phases")
    ap.add_argument("--phases", nargs="*", default=[])
    ap.add_argument("--block-side", type=int, default=None,
                    help="phase 30's elasticity3 side (default: the "
                    "smoke's BLOCK_SIDE)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_setup_engine: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import amgx_tpu_torch as amgx
    import chip_smoke as cs
    from amgx_tpu_torch import native
    native.build_all(("dia_spmv", "ell_spmv", "binned_spmv",
                      "shift_spmv"))
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)          # the CUDA context, for the counters
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    if args.block_side:
        cs.BLOCK_SIDE = args.block_side
    if "30" in args.phases:
        cs.block_aggregation_phase(amgx, dev, smi, gen, engine_off=True)
    if "31" in args.phases:
        cs.classical_algorithm_phase(amgx, dev, smi, gen, engine_off=True)
    paths = args.paths
    if paths is None:
        paths = [] if args.phases else ["dfg", "classical_reuse",
                                        "classical", "config4"]
    run_paths(amgx, set(paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())

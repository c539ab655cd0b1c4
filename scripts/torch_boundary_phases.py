#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 32-35 (the solve boundary's knobs) alone on
one card, without the phases before them: the bf16 precision paths
(32; its config-4 part on the full SPE10 system, uploaded and packed in
f32 here as phase 13 does), scaling and RCM (33), faults and the
recovery ladder (34) and the host tail of ``amg_host_levels_rows`` (35).
``--phases 28`` runs phase 28's small stacks, card against CPU (each
classical case asserted bit-equal: the check that every setup row sum
adds in one order; ``scripts/torch_setup_engine.py --phases 31`` runs
phase 31's).  Run from another tree's ``scripts/`` it checks that tree.

    python3 scripts/torch_boundary_phases.py [--phases 28 32 33 34 35]

Prints the phases' JSON lines, then the kernels line of the bf16 pairs
the chosen phases launched (launches, errors and times as in the
smoke).  Without a CUDA device the script exits non-zero.
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
                    default=[32, 33, 34, 35])
    a = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_boundary_phases: no CUDA device available",
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
    t0 = time.perf_counter()
    native.build_all(("dia_spmv", "ell_spmv", "binned_spmv", "shift_spmv"))
    cs.emit("build", seconds=time.perf_counter() - t0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    b1_errs, b3_errs, b5_errs = {}, {}, {}
    paths, timing = {}, {}
    if 28 in a.phases:
        cs.family_small_checks(amgx)
    if 32 in a.phases:
        prec = cs.precision_phase(amgx, dev, smi, gen, b1_errs, b3_errs)
        paths.update(prec["launches"])
        timing.update(prec["timing"])
        A = spe10_block_system()
        m = amgx.Matrix(A, block_dim=4, device="cuda")
        m.device_dtype = np.float32
        m.device()
        c4 = cs.config4_bf16_phase(amgx, A, m, dev, smi, gen, b5_errs)
        paths["precision_config4"] = c4["counts"]
        timing["B5"] = c4["timing"]
        del m, A
        torch.cuda.empty_cache()
    if 33 in a.phases:
        paths.update(cs.boundary_phase(amgx, dev, smi, gen))
    if 34 in a.phases:
        paths.update(cs.fault_phase(amgx, dev, smi, gen))
    if 35 in a.phases:
        paths.update(cs.host_levels_phase(amgx, dev, smi, gen))
    kernels = []
    for name, kern, errs, key in (
            ("dia_spmv<bf16,f32>", "B1", b1_errs, "bf16.f32"),
            ("ell_spmv<bf16,f32>", "B3", b3_errs, "bf16.f32"),
            ("binned_spmv_B5<bf16,f32,b=4>", "B5", b5_errs,
             "B5.bf16.f32")):
        if kern not in timing:
            continue
        by_path = {p: c[kern].get("bf16.f32", 0) for p, c in paths.items()}
        kernels.append(dict(name=name, launches=sum(by_path.values()),
                            launches_by_path=by_path,
                            max_abs_err=errs[key]["abs"],
                            max_row_rel_err=errs[key]["rel"],
                            **timing[kern]))
    print(json.dumps({"kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 45 alone on one card, without the phases
before it: ROADMAP item 7c — complex systems on the rest of the solver
set (the 128³ screened complex Helmholtz under FGMRES + SIZE_4
aggregation with the F cycle and MULTICOLOR_DILU, the 128³ Hermitian under PCG_PIPE +
SIZE_2 aggregation with JACOBI_L1, LANCZOS against eigsh, every name
that joined card against CPU at 24³), bf16 sharded SpMV (B3 and B5 in
their (bf16, f32) pairs on the stacked interiors), complex sharded
solves and levels narrowed by ``hierarchy_dtype`` under an f64 outer
solver (B1 and B3 in their (f32, f64) / (bf16, f64) pairs).  ``--side``
shrinks the two full-width solves for a quick check.  Run from another
tree's ``scripts/`` it checks that tree.

    python3 scripts/torch_item7c_phase.py [--side 128] [--parts abcdefg]

Prints the phase's JSON lines, then one line of the new pairs'
timings.  Without a CUDA device the script exits non-zero.
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
    ap.add_argument("--side", type=int, default=None)
    ap.add_argument("--parts", default="abcdefg",
                    help="which of (a)-(g) to run, e.g. cdefg")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_item7c_phase: no CUDA device available",
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
        cs.ITEM7C_SIDE = a.side
    t0 = time.perf_counter()
    native.build_all(("dia_spmv", "ell_spmv", "binned_spmv", "shift_spmv"))
    cs.emit("build", seconds=time.perf_counter() - t0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    t = time.perf_counter()
    out = cs.item7c_phase(amgx, dev, smi, gen, parts=a.parts)
    cs.emit("phase_45_seconds", seconds=time.perf_counter() - t)
    print(json.dumps({"bf16_sharded": {
        k: dict(out[k]["timing"], launches=out[k]["launches"])
        for k in ("b3", "b5") if k in out},
        "narrow_f64": out["narrow"]["timing"] if "narrow" in out else None}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

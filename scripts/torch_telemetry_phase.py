#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 42 alone on one card: the headline stack at
128³ with ``telemetry``, ``setup_profile`` and ``memledger`` on against
the same solve with them off, the device anatomy of a graphed warm
solve under ``torch.profiler``, the memory ledger, the setup profile,
the exporters and the doctor, ``forensics`` at 64³ and the
``dist/halo_exchange`` scope of phase 40c's sharded stack.  Run from
another tree's ``scripts/`` it checks that tree.

    python3 scripts/torch_telemetry_phase.py [--iters 16]

``--iters`` is the headline's count the phase holds the telemetry-on
solve to (phase 5's in the smoke).  Prints the phase's JSON lines, then
one line of the launches by path.  Without a CUDA device the script
exits non-zero.
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
    ap.add_argument("--iters", type=int, default=16)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_telemetry_phase: no CUDA device available",
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
    t0 = time.perf_counter()
    native.build_all(("dia_spmv", "ell_spmv", "binned_spmv", "shift_spmv"))
    cs.emit("build", seconds=time.perf_counter() - t0)
    paths = cs.telemetry_phase(amgx, dev, smi, a.iters)
    print(json.dumps({"paths": paths}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

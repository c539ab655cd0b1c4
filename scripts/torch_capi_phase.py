#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 44 alone on one card: the AMGX C API
(``amgx_tpu_torch.capi``) in dDDI at 128³ against the direct path, the
C driver ``capi_headline.c`` through ``libamgx_torch_c.so`` in a child
process, ``native/test_capi.c`` against that library, the distributed
C API (48³ in 8 shards) and the C API on the card against the CPU at
16³.  Run from another tree's ``scripts/`` it checks that tree.

    python3 scripts/torch_capi_phase.py

Prints what the shim embeds (``sysconfig``), the phase's JSON lines,
then one line of the launches by path.  Without a CUDA device the
script exits non-zero.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_capi_phase: no CUDA device available", file=sys.stderr)
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
    cs.emit("capi_python", **cs.capi_python_probe())
    t0 = time.perf_counter()
    shim = cs.ShimBuild()
    native.build_all(("dia_spmv", "ell_spmv", "binned_spmv", "shift_spmv"))
    cs.emit("build", seconds=time.perf_counter() - t0)
    paths = cs.capi_phase(amgx, dev, smi, shim)
    print(json.dumps({"paths": paths}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

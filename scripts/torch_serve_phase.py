#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 43 alone on one card: a ``SolveService``
serving the headline stack (warmup, 22 requests from 4 client threads,
the endpoint, the load generator, ``serve_workers=2`` against 1, every
answer against a direct solve, the session's device bytes) and the warm
start across three child processes.  Run from another tree's
``scripts/`` it checks that tree.

    python3 scripts/torch_serve_phase.py [--stacks-after 600]

Prints the phase's JSON lines, then one line of the launches by path.
Without a CUDA device the script exits non-zero.
"""
from __future__ import annotations

import faulthandler
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stacks-after", type=float, default=600.0,
                    help="seconds after which every thread's stack is "
                    "printed and the process exits")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_phase: no CUDA device available",
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
    # every thread's stack on stderr if the phase has not ended by then
    faulthandler.dump_traceback_later(a.stacks_after, exit=True)
    paths = cs.serve_phase(amgx, dev, smi)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"paths": paths}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

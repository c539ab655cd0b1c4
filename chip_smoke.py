#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``amgx_tpu_torch``) on one NVIDIA
H100.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line to stdout; any failure raises, which
exits non-zero (no phase is caught):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the DIA SpMV kernel (``amgx_tpu_torch/csrc/dia_spmv.cu``) with
   nvcc for sm_90a;
3. the kernel against its plain PyTorch version on the card, in all four
   (vals, x) type pairs, at the 128³ and 256³ 7-point operators, random
   DIAs at n = 16384 and a 64-row coarse level;
4. times with CUDA events (median of 30 after warm-up) at 128³, f32 and
   f64: kernel, plain version, one cuSPARSE CSR SpMV as a yardstick, and
   the bound (bytes over 3.35 TB/s vs operations over the peak rate);
5. the main path: the 128³ headline solve (FGMRES + GEO-aggregation AMG,
   f32 pack, f64 refinement) driven through the public API with every
   launch count set to 0 just before and read just after; the true
   relative residual is recomputed in f64 through the kernel, and a 16³
   solve on the card is held against the same solve on the CPU;
6. setup parity: every derived coarse level on the card vs the same
   derivation on CPU tensors;
7. where a warm solve's time goes: device time by kernel from
   ``torch.profiler``, and the device's busy share of the unprofiled
   solve's wall time.

Then one JSON line of the path's kernels and, last, the contract line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

#: H100 SXM datasheet: HBM3 bandwidth and vector (non-tensor) peaks
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}

HEADLINE_CFG = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
    "amg:cycle=CG, amg:cycle_iters=2, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
#: the headline at 16³ with the f32 pack takes 14 iterations in the JAX
#: package on the CPU (f32 inner solves + f64 refinement)
SMALL_ITERS = 14
SEED = 20261016


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def short(dt) -> str:
    import torch
    return {torch.float32: "f32", torch.float64: "f64",
            torch.bfloat16: "bf16"}[dt]


def check_kernel(dev, gen, name, vals64, offsets, pairs, errs):
    """Kernel vs plain version for every (vals, x) pair on ``vals64``."""
    import torch
    from amgx_tpu_torch.ops import dia_spmv as dmod
    n = vals64.shape[1]
    for vdt, xdt in pairs:
        vals = vals64.to(vdt).contiguous()
        x = torch.randn(n, dtype=torch.float64, device=dev,
                        generator=gen).to(xdt)
        before = dmod.launch_count()
        y = dmod.dia_spmv(vals, x, offsets)
        torch.cuda.synchronize(dev)
        assert dmod.launch_count() == before + 1, "launch not counted"
        ref = dmod.dia_spmv_reference(vals, x, offsets)
        assert y.dtype == ref.dtype == xdt and y.shape == (n,)
        diff = (y.double() - ref.double()).abs().max().item()
        scale = max(ref.double().abs().max().item(), 1e-300)
        tol = 1e-12 if xdt == torch.float64 else 1e-5
        assert torch.isfinite(y).all().item(), (name, vdt, xdt)
        assert diff / scale < tol, (name, short(vdt), short(xdt), diff,
                                    scale)
        key = f"{short(vdt)}.{short(xdt)}"
        errs[key] = max(errs.get(key, 0.0), diff)
        emit("kernel_check", case=name, n=n, nd=len(offsets),
             vals=short(vdt), x=short(xdt), max_abs_err=diff,
             rel_err=diff / scale, tol=tol)


def time_ms(fn, dev, reps=30, warm=5):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed
    calls after ``warm`` untimed ones."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def csr_of_dia(vals, offsets):
    """The same operator as a torch sparse CSR (cuSPARSE yardstick)."""
    import torch
    nd, n = vals.shape
    i = torch.arange(n, dtype=torch.int64, device=vals.device)
    rows, cols, data, keys = [], [], [], []
    for k, o in enumerate(offsets):
        j = i + o
        keep = (j >= 0) & (j < n) & (vals[k] != 0)
        rows.append(i[keep])
        cols.append(j[keep])
        data.append(vals[k][keep])
        keys.append(i[keep] * nd + k)
    order = torch.argsort(torch.cat(keys))
    rows = torch.cat(rows)[order]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, torch.cat(cols)[order],
                                   torch.cat(data)[order], size=(n, n))


def bound(nd, n, vdt, xdt):
    """(bound_ms, bound_by) of one SpMV: bytes each input read once and
    the output written once, vs 2·nd·n operations at the peak rate."""
    nbytes = nd * n * vdt.itemsize + 2 * n * xdt.itemsize
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * nd * n / PEAK_FLOPS[short(xdt)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch import native
    from amgx_tpu_torch.amg.dia_device import (derive_hierarchy_device,
                                               plan_dia_hierarchy)
    from amgx_tpu_torch.io import poisson7pt_device
    from amgx_tpu_torch.ops import dia_spmv as dmod
    from amgx_tpu_torch.ops import spmv as smod

    # float32 products and convolutions in full precision (the port runs
    # none of cuDNN's TF32 convolutions, and says so here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=smi, torch_name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    native.build_all(["dia_spmv"])
    build_s = time.perf_counter() - t0
    log = native.BUILD_LOG.get("dia_spmv", {}).get("log", "")
    emit("build", source="amgx_tpu_torch/csrc/dia_spmv.cu",
         seconds=build_s, ptxas=[ln.strip() for ln in log.splitlines()
                                 if "registers" in ln or "spill" in ln])

    # ---- 3. kernel vs plain, every type pair
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    pairs = dmod.SUPPORTED
    errs = {}
    for side in (128, 256):
        A = poisson7pt_device(side, side, side, device_dtype=np.float64,
                              device=dev)
        Ad = A.device()
        check_kernel(dev, gen, f"poisson7pt_{side}^3", Ad.vals,
                     Ad.dia_offsets, pairs, errs)
        del A, Ad
    for offsets in ((-1, 0, 1), (-5184, -72, -1, 0, 1, 72, 5184),
                    (-129, -128, -127, -1, 0, 1, 127, 128, 129)):
        vals = torch.randn((len(offsets), 16384), dtype=torch.float64,
                           device=dev, generator=gen)
        check_kernel(dev, gen, f"random_dia_nd{len(offsets)}", vals,
                     offsets, pairs, errs)
    vals = torch.randn((7, 64), dtype=torch.float64, device=dev,
                       generator=gen)
    check_kernel(dev, gen, "coarse_level_4^3", vals,
                 (-16, -4, -1, 0, 1, 4, 16), pairs, errs)
    torch.cuda.empty_cache()

    # ---- 4. times at 128³
    side = 128
    n = side ** 3
    timing = {}
    A = poisson7pt_device(side, side, side, device_dtype=np.float64,
                          device=dev)
    vals64, offsets = A.device().vals, A.device().dia_offsets
    for dt in (torch.float32, torch.float64):
        vals = vals64.to(dt).contiguous()
        x = torch.randn(n, dtype=dt, device=dev, generator=gen)
        csr = csr_of_dia(vals, offsets)
        ms = time_ms(lambda: dmod.dia_spmv(vals, x, offsets), dev)
        plain_ms = time_ms(lambda: dmod.dia_spmv_reference(vals, x,
                                                           offsets), dev)
        library_ms = time_ms(lambda: csr @ x, dev)
        bound_ms, bound_by = bound(len(offsets), n, dt, dt)
        key = f"{short(dt)}.{short(dt)}"
        timing[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        emit("timing", n=n, nd=len(offsets), vals=short(dt), x=short(dt),
             card=smi, **timing[key],
             achieved_gbs=(len(offsets) * n * dt.itemsize
                           + 2 * n * dt.itemsize) / (ms * 1e-3) / 1e9)
        del csr
    del A, vals64
    torch.cuda.empty_cache()

    # ---- 5. the main path: 128³ headline solve
    dmod.reset_launches()
    smod.reset_dispatch()
    t0 = time.perf_counter()
    A = poisson7pt_device(side, side, side, device_dtype=np.float32,
                          device="cuda")
    slv = amgx.create_solver(HEADLINE_CFG)
    slv.setup(A)
    setup_s = time.perf_counter() - t0
    b = torch.ones(n, dtype=torch.float64, device=dev)
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    launches = dict(dmod.LAUNCHES)
    dispatch = dict(smod.DISPATCH)
    # a second, warm solve for the steady-state time (not counted)
    res2 = slv.solve(b)
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    assert dispatch["dia/kernel"] > 0 and dispatch["dia/slices"] == 0, \
        dispatch
    assert all(launches[k] > 0 for k in ("f32.f32", "f64.f64")), launches
    x = res.x
    assert x.dtype == torch.float64 and x.shape == (n,) and x.is_cuda
    assert torch.isfinite(x).all().item()
    Ad64 = A.device().astype(torch.float64)
    r = b - dmod.dia_spmv(Ad64.vals, x, Ad64.dia_offsets)
    relres = (torch.linalg.vector_norm(r)
              / torch.linalg.vector_norm(b)).item()
    assert relres <= 1e-8, relres
    h = slv.preconditioner.hierarchy
    emit("main_path", n=n, iterations=res.iterations, relres=relres,
         setup_s=setup_s, solve_s=res.solve_time,
         solve_warm_s=res2.solve_time,
         levels=[lv.Ad.n_rows for lv in h.levels]
         + [h.coarsest.n_block_rows],
         launches_per_solve=sum(launches.values()),
         launches_by_type=launches, dispatch=dispatch, card=smi)

    # the same stack at 16³, on the card and on the CPU (plain versions)
    small = {}
    for where in ("cuda", "cpu"):
        As = poisson7pt_device(16, 16, 16, device_dtype=np.float32,
                               device=where)
        s = amgx.create_solver(HEADLINE_CFG)
        s.setup(As)
        small[where] = s.solve(np.ones(16 ** 3))
    xg = small["cuda"].x.cpu()
    xc = small["cpu"].x
    agree = ((xg - xc).norm() / xc.norm()).item()
    assert small["cuda"].iterations == small["cpu"].iterations \
        == SMALL_ITERS, (small["cuda"].iterations, small["cpu"].iterations)
    assert agree < 1e-6, agree
    emit("small_reference", n=16 ** 3, iterations=SMALL_ITERS,
         x_rel_diff_card_vs_cpu=agree)

    # ---- 6. setup parity: derivation on the card vs on CPU tensors
    fine = A.device()
    steps, _ = plan_dia_hierarchy(fine.dia_offsets, n, A.grid_dims, 20, 32,
                                  1.0)
    outs_card = derive_hierarchy_device(steps, fine.dia_offsets, fine.vals)
    outs_cpu = derive_hierarchy_device(steps, fine.dia_offsets,
                                       fine.vals.cpu())
    worst = 0.0
    for got, want in zip(outs_card, outs_cpu):
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=0)
            worst = max(worst, (g.cpu() - w).abs().max().item())
    emit("setup_parity", levels=len(steps), max_abs_diff=worst)

    # ---- 7. where a warm solve's time goes (torch.profiler)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slv.solve(b)
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    device_s = sum(r[1] for r in rows) / 1e6
    emit("profile", profiled_wall_s=wall, unprofiled_wall_s=res2.solve_time,
         device_time_measured=bool(rows), device_busy_s=device_s,
         device_kernels=sum(r[2] for r in rows),
         busy_share_of_unprofiled=device_s / res2.solve_time,
         top=[dict(name=k[:90], device_ms=t / 1e3, calls=c)
              for k, t, c in sorted(rows, key=lambda r: -r[1])[:8]],
         card=smi)

    # ---- the kernels of the main path
    kernels = []
    for key in ("f32.f32", "f64.f64"):
        v, xx = key.split(".")
        kernels.append(dict(
            name=f"dia_spmv<{v},{xx}>", route="cuda",
            source="amgx_tpu_torch/csrc/dia_spmv.cu",
            replaces="amgx_tpu/ops/pallas_spmv.py:101",
            launches=launches[key], max_abs_err=errs[key],
            ms=timing[key]["ms"], plain_ms=timing[key]["plain_ms"],
            bound_ms=timing[key]["bound_ms"],
            bound_by=timing[key]["bound_by"],
            library_ms=timing[key]["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

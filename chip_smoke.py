#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``amgx_tpu_torch``) on one NVIDIA
H100.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line to stdout; any failure raises, which
exits non-zero (no phase is caught):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the DIA (B1) and ELL (B3) SpMV kernels
   (``amgx_tpu_torch/csrc/{dia,ell}_spmv.cu``) with nvcc for sm_90a, one
   nvcc per source, started together;
3. B1 against its plain PyTorch version on the card, bit for bit, in all
   four (vals, x) type pairs, at the 128³ and 256³ 7-point operators,
   random DIAs at n = 16384 and a 64-row coarse level;
4. times with CUDA events (median of 30 after warm-up) at 128³, f32 and
   f64: kernel, plain version, one cuSPARSE CSR SpMV as a yardstick, and
   the bound (bytes over 3.35 TB/s vs operations over the peak rate);
5. the main path: the 128³ headline solve (FGMRES + GEO-aggregation AMG,
   f32 pack, f64 refinement) driven through the public API with every
   launch count set to 0 just before and read just after; each AMG
   application is a replay of one CUDA graph, captured at the first
   (:func:`graph_check`: capture seconds, graph nodes, the launches a
   replay credits, equal to an eager application's, and a replay
   bit-equal to an eager application); the true relative residual is
   recomputed in f64 through the kernel, and a 16³ solve on the card is
   held against the same solve on the CPU (equal counts, x bit-equal);
5b. an AMG nested in the graphed AMG: the headline stack at 16³ cut at
   two levels with an AMG as its coarse solver (``NESTED_CFG``), its
   counts set to 0 just before the solve and read just after; the outer
   graph (:func:`graph_check`) holds the inner cycle as plain nodes (no
   inner graph is built), and the card takes the CPU's count with x
   bit-equal;
6. setup parity: every derived coarse level on the card vs the same
   derivation on CPU tensors;
7. where a warm solve's time goes: device time by kernel from
   ``torch.profiler``, and the device's busy share of the unprofiled
   solve's wall time (with the graph);
8. the classical path: the 128³ ``CFG_CLA`` solve (PCG + classical AMG,
   PMIS/D2, JACOBI_L1, host CSR uploaded with an f32 pack, f64
   refinement) with every count set to 0 just before and read just
   after; per-level formats and rows, dispatch counts, launches by
   kernel and type pair, host syncs of the setup, the AMG graph
   (:func:`graph_check`);
9. the kernels against their plain versions on that hierarchy's own
   packs: B1 in (f32, f32) and (f64, f64) on every DIA pack (the fine A,
   the embedded 25-diagonal P₀ and R₀, which are also the three ``dia3``
   streams of level 1, and a DIA coarsest); B3 in both its pairs on
   every ELL operator, P and R (each with its ``row_len``), on random
   ELLs (K = 4, 27, 256, n_cols ≠ n) full and cut short at random row
   lengths, on a level of fewer than 128 rows and, over dense rows, on
   the dense coarse inverses of this hierarchy and of the headline's.
   Every check holds each row to a relative limit, the row's error over
   its Σ_j |a_ij·x_j|, and B1 and B3 to their plain versions bit for
   bit; B1 is timed on the three ``dia3`` streams (P₀, A, R₀) against
   its bound and cuSPARSE CSR, with the launches a solve makes on each;
10. B3 times on the largest ELL operator of the hierarchy (by bytes):
    kernel (with ``row_len``, and without it for comparison), plain
    version, cuSPARSE CSR, the bound over the nonzeros and over the
    padded pack;
11. the classical stack at 24³ (θ = 0.2401) on the card against the
    same on the CPU: equal per-level rows and iteration counts, final x
    within ``SMALL_X_RTOL``;
12. where a classical setup and a warm classical solve spend their time
    (``torch.profiler``; the solve with the graph);
13. the config-4 path: BASELINE config 4 (PBICGSTAB + MULTICOLOR_DILU)
    on the SPE10-grid 4×4 block system (60 × 220 × 85 cells, 5 % inactive,
    f32 pack, f64 refinement) driven through the public API with every
    count set to 0 just before and read just after: iterations, the true
    relative residual in f64, setup / first / warm solve, colors, peak
    memory, dispatch (every SpMV ``ell/binned-block``, kernel B5; no
    decline), launches by kernel and type pair, the device's busy share
    of a warm solve (``torch.profiler``);
13b. PBICGSTAB + BLOCK_JACOBI (``CFG_BJ``, the guarded block inverse)
    on phase 13's uploaded system: iterations, the true relres in f64,
    setup, first and warm solve, launches by kernel; then the same stack
    on the ``MID_GRID`` system on the card against the CPU (equal
    iterations, x within ``SMALL_X_RTOL``);
14. the same solve with ``AMGX_BLOCK_NATIVE=0``: the scalar-expansion
    planes, every SpMV ``ell/binned`` (kernel B4), iterations within
    ``EXPANSION_COUNT_SLACK`` of phase 13's;
15. B4 and B5 (both over their compact pack) against the planes' plain
    version on the card in every type pair, each row to its own relative
    limit and bit for bit, and against the compact plain version: the
    path's own packs, b = 2, 3 and 5 packs of the gauntlet builders,
    ``scattered_block_operator``, a pack with empty tiles and a scalar
    CSR pack with a row wider than 2048;
16. B5 and B4 times at full width (CUDA events, median of 30): kernel,
    plain version, one cuSPARSE SpMV of the same matrix, the bound over
    the stored entries, over the padded planes and over the compact
    pack;
17. the bench's 16³ config-4 case (``kron(poisson7pt, I₄)``, block-DIA,
    B1 as 16 component dispatches) on the card against the CPU (equal
    iterations, x within ``SMALL_X_RTOL``), and B1 against its plain
    version on each of that pack's 16 component planes as the path
    passes them, in (f32, f32) and (f64, f64);
18. the 30 × 110 × 43 masked system on the card against the CPU (equal
    iterations, x within ``SMALL_X_RTOL``);
19. the fourth path, aggregation AMG on an uploaded operator: the DFG
    cylinder pressure Poisson at ny = 512 (1,394,214 rows, 153
    diagonals, a host CSR uploaded through ``Matrix``) under the
    headline config (GEO falls back to SIZE_2), f32 pack, f64
    refinement, with every count set to 0 just before the first solve
    and read just after: setup, first and warm solve (equal counts),
    iterations, the true relres in f64 on the host, per-level rows and
    pack kinds, dispatch (every fine-level SpMV ``ell/shift``, kernel
    B2; the coarse ELL levels on B3; no decline), peak memory, the AMG
    graph (:func:`graph_check`), and the device time and busy share of a
    warm solve (``torch.profiler``).  The hierarchy is cut at
    ``DFG_LEVELS`` levels; phase 22 runs the config's own depth;
20. B2 against its plain versions on the card, every row to its own
    limit and bit for bit against the planes' and the compact pack's
    plain version, in (f32, f32) and (f64, f64): that fine pack, the
    refinement's wide pack of it, the ny = 320 fine pack, the cases of
    tests/test_pallas_shift.py packed without DIA, the 9-diagonal
    40,000-row matrix of tests/test_tpu.py and a tile of exactly 32
    classes; B3 against its plain version
    in both pairs on every coarse level's A of that hierarchy and, over
    dense rows, on its dense coarse inverse, bit for bit;
21. B2 times on the fine pack (CUDA events, median of 30): kernel,
    its plain version (over the compact pack), one cuSPARSE CSR SpMV, the bounds over the
    stored entries, the compact pack and the class planes, the compact
    pack's resident bytes and the peak memory since phase 19;
22. the DFG operator at ny = 512 under the headline config at its own
    depth (``amg:max_levels=20``, 15 levels down to a 28-row coarse
    solve): setup; a first solve capped at ``DFG_REPLAY_ITERS``
    iterations (it captures the graph) and a warm one capped the same
    way (it replays it): equal iterations and launches; the full solve,
    iterations, the true relres in f64, the AMG graph
    (:func:`graph_check`), B3 bit for bit on the ELL levels from phase
    19's dense coarsest level down;
23. the same stack as phase 19 at ny = 320 (544,649 rows, 67 shift
    tiles) on the card against the CPU, f32 pack and f64 pack: equal
    iterations, x bit-equal with the f32 pack.  The CPU solves run in
    two child processes (one per pack dtype) started at phase 22, after
    the last kernel timing, so phase 22 (whose replays keep the device
    busy) runs beside them and no kernel timing does.

24. the solver family on the classical 128³ stack (``CFG_CLA``, f32
    pack, f64 refinement): the outer solver replaced by GMRES, PCGF,
    PCG_PIPE and PCG_CA (these two on an f64 pack, ``FAMILY_PACK``,
    their f32 runs printed beside), then PCG with the smoother
    CF_JACOBI (the C/F split of the classical levels); each through the
    public API with
    every count set to 0 just before the first solve and read just
    after: iterations, the true relres in f64, setup, first and warm
    solve, launches by kernel, the AMG graph (:func:`graph_check`) and
    the device's busy share of a warm solve;
25. the headline 128³ with CHEBYSHEV_POLY as its smoother (the power
    iteration at setup through B1, the graph replaying the smoother),
    and CHEBYSHEV without a preconditioner at 128³ for ``CHEB_ITERS``
    iterations, with the relres it reaches;
26. config 4's full SPE10 system, uploaded once: IDR + MULTICOLOR_DILU
    and PBICGSTAB + MULTICOLOR_GS (4×4 block slabs), both on B5;
27. PBICGSTAB + MULTICOLOR_ILU(0) on the DFG operator at ``ILU_NY``;
28. the card against the CPU for every solver name of this slice (and
    PCG with ``krylov_comm`` CA and PIPELINED) on small systems: equal
    iterations, x within ``SMALL_X_RTOL`` (whether x is bit-equal is
    printed);
29. values-only resetup (``Matrix.replace_coefficients`` then
    ``Solver.resetup`` then a solve, ``RESETUP_STEPS`` steps of the
    drift A_k = D_k·A₀·D_k, D_k = diag(1 + 0.1·u·k)) on three paths at
    full size, each with ``amg:structure_reuse_levels=-1`` and its
    counts set to 0 just before its first solve and read just after its
    last: the headline 128³ (host-built ``poisson7pt`` with its DIA
    attach, f32 pack; the refresh re-derived on the card,
    ``"dia_device"``; iterations and x bit-equal to a fresh setup and
    solve of each A_k), the classical stack at ``RESETUP_CLA_SIDE``³
    (96³, cut from 128³ for time; ``CFG_CLA``, θ = 0.2401, f64
    pack — its level 1 held to the host Galerkin product with the frozen
    P at ``RAP_RTOL``; the reuse gate sends the setup down the host
    classical loop; ``"classical_device"``) and the DFG at
    ``RESETUP_DFG_NY`` (320, cut from 512 for time) cut at
    ``DFG_LEVELS`` (``"host_replay"``).  Each step: resetup seconds
    against the fresh setup's (the DFG's couplings drift instead:
    :func:`coupling_drift_values`), the first solve after the resetup against
    a warm one, iterations, the true relres (≤ 1e-8), graphs kept and
    dropped, captures (none after step 0: the graphs are kept), peak
    memory, and a replay bit-equal to an eager application on the
    refreshed hierarchy (:func:`graph_check`).  Then at small size: the
    card against the CPU before and after each of two resetups
    (headline 16³ and config 4 at 12³, equal counts, x bit-equal in
    f32), and a block matrix handed to a DIA hierarchy's resetup
    raises;
30. block aggregation: the gauntlet's SPD stack (``BLOCK_CFG``: PCG +
    SIZE_2 aggregation on 3×3 blocks + BLOCK_JACOBI 2+2 + DENSE_LU) on
    ``elasticity3(BLOCK_SIDE)`` (96: 884,736 block rows, 2,654,208
    unknowns; f32 pack, f64 refinement): setup with the device setup
    engine (the setup without it is ``scripts/torch_setup_engine.py
    --phases 30``'s, moved out for time), the engine's plans, hits and
    declines (only
    "small"), a first and a warm solve with every count set to 0 just
    before the first and read just after, the true relres in f64, the
    levels and their dispatch labels (the fine level block-DIA, B1 as
    b² dispatches; the coarse levels ``ell/binned-block``, B5, or, where
    the block plan passes the binned padding budget, the scalar
    expansion's ``ell/binned``, B4; no decline), the AMG graph
    (:func:`graph_check`), peak memory; a
    values-only resetup (the frozen aggregates replayed through the
    engine's cached plans, ``"host_replay"``, graphs kept) and its
    solve; the card against the CPU at 12³ with the engine on every
    level (equal counts, x bit-equal);
31. the classical setup algorithms: the classical 128³ stack with
    ``aggressive_levels=1`` (AGGRESSIVE_PMIS + MULTIPASS on level 0,
    PMIS + D2 below, every level on the host loop): setup with the
    engine and the Galerkin products' share of it (engine off:
    ``scripts/torch_setup_engine.py --phases 31``, moved out for time),
    iterations, the true relres, a first and a warm solve, B1/B3
    launches, the AMG graph, and an engine product of level 1 in f64 on
    the card against scipy's (≤ 1e-12); then the card against the CPU
    at 24³ (θ = 0.2401) for HMIS, AGGRESSIVE_HMIS, DUMMY, CR, MULTIPASS,
    AFFINITY, ENERGYMIN and ``aggressive_levels``, and
    ``error_scaling=2`` on the headline at 16³ (equal counts; its graph
    replay bit-equal to an eager application).

Then one JSON line of the four paths' kernels and, last, the contract line
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

import numpy as np

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
#: BASELINE config 2 (bench.py:72-81): PCG + classical AMG
CFG_CLA = (
    "config_version=2, solver(out)=PCG, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
    "amg:algorithm=CLASSICAL, amg:selector=PMIS, "
    "amg:interpolator=D2, amg:max_iters=1, "
    "amg:interp_max_elements=4, amg:max_row_sum=0.9, "
    "amg:max_levels=16, amg:smoother(sm)=JACOBI_L1, "
    "sm:max_iters=1, amg:presweeps=2, amg:postsweeps=2, "
    "amg:min_coarse_rows=32, amg:coarse_solver=DENSE_LU_SOLVER")
#: BASELINE config 4 (bench.py:1586-1590): PBICGSTAB + MULTICOLOR_DILU
CFG4 = (
    "config_version=2, solver(out)=PBICGSTAB, out:max_iters=200, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, "
    "out:preconditioner(pre)=MULTICOLOR_DILU, pre:max_iters=1")
#: PBICGSTAB preconditioned by one sweep of block Jacobi on the 4×4
#: diagonal blocks (the config-4 system under BLOCK_JACOBI)
CFG_BJ = CFG4.replace("out:max_iters=200", "out:max_iters=400") \
    .replace("MULTICOLOR_DILU", "BLOCK_JACOBI")
#: the headline stack cut at two levels with an AMG (two V-cycles) as
#: its coarse solver: an AMG nested in the graphed AMG
NESTED_CFG = HEADLINE_CFG.replace(
    "amg:max_levels=20", "amg:max_levels=2").replace(
    "amg:coarse_solver=DENSE_LU_SOLVER",
    "amg:coarse_solver(inner)=AMG, inner:algorithm=AGGREGATION, "
    "inner:selector=GEO, inner:max_iters=2, inner:cycle=V, "
    "inner:smoother(ism)=BLOCK_JACOBI, ism:max_iters=1, "
    "inner:min_coarse_rows=32, inner:coarse_solver=DENSE_LU_SOLVER")
#: its iterations at 16³ with the f32 pack, in the JAX package on the CPU
#: (tests/test_torch_nested_amg.py)
NESTED_ITERS = 16
#: the mid-size masked grid of the card-against-CPU check (the JAX
#: package takes 26 iterations on it on the CPU)
MID_GRID = (30, 110, 43)
#: config 4 on the block-native planes against the scalar expansion:
#: each scalar row sums its products in another order (per scalar entry,
#: not per 4×4 block), so the f32 SpMVs differ in the last bits and
#: BiCGStab's f32 recurrences may move the count by one
EXPANSION_COUNT_SLACK = 1
#: per-row limits of the binned kernels against their plain versions
BINNED_TOL = {"f32": 1e-5, "bf16": 1e-5, "f64": 1e-12}
SEED = 20261016
#: the 24³ classical solve on the card against the CPU: final x within
#: this relative 2-norm (the CPU parity tests hold the port to the JAX
#: package at the same limit)
SMALL_X_RTOL = 1e-6
#: the fourth path: the headline stack on the DFG cylinder operator,
#: its hierarchy cut at DFG_LEVELS levels (phase 22 runs the config's own
#: depth).  The CG K-cycle (cycle_iters 2) visits level i 2^i times per
#: application, each visit a few dozen kernels, replayed from one CUDA
#: graph: at ny = 512 the config's own 14 levels make 2^13 = 8,192
#: coarse solves per application; 10 levels make 256, on a 1,498-row
#: dense coarse operator
DFG_LEVELS = 10
DFG_CFG = HEADLINE_CFG.replace("amg:max_levels=20",
                               f"amg:max_levels={DFG_LEVELS}")
DFG_NY, DFG_SMALL_NY = 512, 320
#: FGMRES iterations of the profiled window of a warm DFG solve
DFG_WINDOW_ITERS = 2
#: phase 22: iterations of the capped capturing and replaying solves at
#: the DFG's own depth (a replay there takes some 1.7 s)
DFG_REPLAY_ITERS = 3
#: per-row limits of B2 against its plain version (it is bit-equal by
#: construction; the limits are those of the other kernels)
SHIFT_TOL = {"f32": 1e-5, "f64": 1e-12}
#: phases 24-25: the classical and headline 128³ systems, phase 26:
#: config 4's full SPE10 grid
FAMILY_SIDE = 128
FAMILY_C4_GRID = (60, 220, 85)
#: phase 24: the classical stack's outer solver replaced (the
#: GMRES_AMG_D2 / PCGF_CLASSICAL_V_JACOBI shapes), then its smoother
FAMILY_KRYLOV = ("GMRES", "PCGF", "PCG_PIPE", "PCG_CA")
#: pack dtypes of phase 24 other than f32: in f32 the single-reduction
#: recurrences of PCG_CA and PCG_PIPE lose A-conjugacy and the guard
#: reports pAp < 0 (the JAX package's too: tests/torch_pipe_parity.py),
#: so at full width they converge on an f64 pack; their f32 runs are
#: printed beside (phase 28 compares the f32 runs on the card and the
#: CPU at 24³)
FAMILY_PACK = {"PCG_PIPE": np.float64, "PCG_CA": np.float64}
#: phase 25: CHEBYSHEV without a preconditioner (the CHEB_SOLVER_NOPREC
#: shape) for a fixed budget of iterations
CHEB_NOPREC_CFG = (
    "config_version=2, solver(out)=CHEBYSHEV, out:max_iters={it}, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI")
CHEB_ITERS = 100
#: phase 26: config 4's outer solver and preconditioner replaced
IDR_DILU_CFG = CFG4.replace("solver(out)=PBICGSTAB", "solver(out)=IDR")
MCGS_CFG = CFG4.replace("MULTICOLOR_DILU", "MULTICOLOR_GS")
#: phase 27: PBICGSTAB + MULTICOLOR_ILU(0) on the DFG operator at
#: ILU_NY (87,172 rows), cut from the path's ny = 512 because the ILU
#: factorisation is a host loop over rows (solvers/ilu.py)
ILU_NY = 128
ILU_CFG = CFG4.replace("out:max_iters=200", "out:max_iters=2000") \
    .replace("MULTICOLOR_DILU", "MULTICOLOR_ILU")
#: phase 28: the card against the CPU for each name of this slice, on
#: the classical stack at FAMILY_CLA_SIDE³ (θ = 0.2401), the headline at
#: FAMILY_AGG_SIDE³ and config 4's system on FAMILY_BLOCK_GRID
FAMILY_CLA_SIDE = 24
FAMILY_AGG_SIDE = 16
FAMILY_BLOCK_GRID = (12, 12, 12)
#: phase 29: steps of the resetup loop (step 0 is the fresh setup)
RESETUP_STEPS = 3
#: phase 29: the classical path's side, cut from 128 for time (at 128³
#: the path took 61 s of the smoke, its reuse-configured setup 41 s on
#: the host classical loop: PERF.md §7)
RESETUP_CLA_SIDE = 96
#: phase 29: the DFG path's ny, cut from 512 for time (the smallest ny
#: whose fine level packs as ``ell/shift``, kernel B2, is 320)
RESETUP_DFG_NY = 320
#: phase 29: the classical level 1 refreshed on the card against the
#: host Galerkin product with the frozen P, in f64 (the JAX package's
#: bound, tests/test_classical_device.py:190-211)
RAP_RTOL = 1e-10
#: phase 30: block aggregation — the gauntlet's SPD stack
#: (``io/gauntlet.py`` ``_CFG_SPD``: PCG + SIZE_2 aggregation on b×b
#: blocks + BLOCK_JACOBI 2+2 + DENSE_LU) on ``elasticity3(BLOCK_SIDE)``,
#: b = 3; the card against the CPU at BLOCK_SMALL_SIDE
BLOCK_CFG = (
    "config_version=2, solver(out)=PCG, out:max_iters=400, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
    "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, amg:max_iters=1, "
    "amg:max_levels=10, amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=24, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
BLOCK_SIDE, BLOCK_SMALL_SIDE = 96, 12
#: phase 31: the classical 128³ stack with aggressive coarsening on its
#: first level (AGGRESSIVE_PMIS + MULTIPASS there, PMIS + D2 below)
CLA_AGGR_CFG = CFG_CLA + ", amg:aggressive_levels=1"
#: phase 31: the card against the CPU at FAMILY_CLA_SIDE³ (θ = 0.2401)
#: for each setup algorithm of this slice
CLA_NAMES = {
    "HMIS": ("amg:selector=PMIS", "amg:selector=HMIS"),
    "AGGRESSIVE_HMIS": ("amg:selector=PMIS, amg:interpolator=D2",
                        "amg:selector=AGGRESSIVE_HMIS, "
                        "amg:interpolator=MULTIPASS"),
    "DUMMY": ("amg:selector=PMIS", "amg:selector=DUMMY"),
    "CR": ("amg:selector=PMIS", "amg:selector=CR"),
    "MULTIPASS": ("amg:selector=PMIS, amg:interpolator=D2",
                  "amg:selector=AGGRESSIVE_PMIS, "
                  "amg:interpolator=MULTIPASS"),
    "AFFINITY": ("amg:max_row_sum=0.9", "amg:max_row_sum=0.9, "
                 "amg:strength=AFFINITY"),
    "ENERGYMIN": ("amg:algorithm=CLASSICAL", "amg:algorithm=ENERGYMIN"),
    "aggressive_levels": ("amg:max_row_sum=0.9", "amg:max_row_sum=0.9, "
                          "amg:aggressive_levels=1"),
}


#: the script's start, for the elapsed seconds on every phase line
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def short(dt) -> str:
    import torch
    return {torch.float32: "f32", torch.float64: "f64",
            torch.bfloat16: "bf16"}[dt]


def row_errors(y, ref, scale):
    """(largest |y − ref|, largest per-row relative error): each row's
    difference over that row's Σ_j |a_ij·x_j| (``scale``), so rows of
    every size are held to the same relative limit."""
    import torch
    diff = (y.double() - ref.double()).abs()
    ok = scale > 0
    rel = torch.where(ok, diff / torch.where(ok, scale, 1.0),
                      torch.where(diff > 0, float("inf"), 0.0))
    return diff.max().item(), rel.max().item()


def record(errs, key, abs_err, rel_err):
    e = errs.setdefault(key, {"abs": 0.0, "rel": 0.0})
    e["abs"] = max(e["abs"], abs_err)
    e["rel"] = max(e["rel"], rel_err)


def check_kernel(dev, gen, name, vals64, offsets, pairs, errs):
    """Kernel vs plain version for every (vals, x) pair on ``vals64``,
    per row to a relative 1e-5 (f32 x) or 1e-12 (f64 x)."""
    import torch
    n = vals64.shape[1]
    for vdt, xdt in pairs:
        x = torch.randn(n, dtype=torch.float64, device=dev,
                        generator=gen).to(xdt)
        check_dia_once(name, vals64.to(vdt).contiguous(), x, offsets, errs)


def check_dia_once(name, vals, x, offsets, errs, **extra):
    """One B1 launch on ``vals``/``x`` as given (storage offsets
    included) against the plain version: bit for bit, and per row to a
    relative 1e-5 (f32 x) or 1e-12 (f64 x)."""
    import torch
    from amgx_tpu_torch.ops import dia_spmv as dmod
    n, vdt, xdt = vals.shape[1], vals.dtype, x.dtype
    before = dmod.launch_count()
    y = dmod.dia_spmv(vals, x, offsets)
    torch.cuda.synchronize(x.device)
    assert dmod.launch_count() == before + 1, "launch not counted"
    ref = dmod.dia_spmv_reference(vals, x, offsets)
    assert y.dtype == ref.dtype == xdt and y.shape == (n,)
    scale = dmod.dia_spmv_reference(vals.double().abs(),
                                    x.double().abs(), offsets)
    diff, rel = row_errors(y, ref, scale)
    tol = 1e-12 if xdt == torch.float64 else 1e-5
    assert torch.isfinite(y).all().item(), (name, vdt, xdt)
    assert rel < tol, (name, short(vdt), short(xdt), diff, rel)
    assert torch.equal(y, ref), (name, short(vdt), short(xdt), diff)
    record(errs, f"{short(vdt)}.{short(xdt)}", diff, rel)
    emit("kernel_check", case=name, n=n, n_cols=x.shape[0], nd=len(offsets),
         max_offset=max(abs(o) for o in offsets),
         vals_absmax=vals.abs().max().item(), vals=short(vdt),
         x=short(xdt), bit_equal=True, max_abs_err=diff,
         max_row_rel_err=rel, tol=tol, **extra)


def check_block_dia(dev, gen, name, P, errs):
    """B1 on every b² component plane of a block-DIA pack, passed as
    ``_bdia_spmv`` passes them: the plane ``vals[:, :, a, c]`` (a
    contiguous slice at its own storage offset) against row c of the
    (b, n) transposed x."""
    import torch
    b, n = P.block_dim, P.n_rows
    nd = len(P.dia_offsets)
    x = torch.randn(n * b, dtype=torch.float64, device=dev,
                    generator=gen).to(P.dtype)
    xt = x.reshape(n, b).T.contiguous()
    for a in range(b):
        for c in range(b):
            plane = P.vals[:, :, a, c]
            assert plane.is_contiguous() and \
                plane.storage_offset() == (a * b + c) * nd * n, (a, c)
            check_dia_once(name, plane, xt[c], P.dia_offsets, errs,
                           component=[a, c],
                           storage_offset=plane.storage_offset())


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


def csr_of_dia(vals, offsets, n_cols=None):
    """The same operator as a torch sparse CSR (cuSPARSE yardstick)."""
    import torch
    nd, n = vals.shape
    n_cols = n if n_cols is None else n_cols
    i = torch.arange(n, dtype=torch.int64, device=vals.device)
    rows, cols, data, keys = [], [], [], []
    for k, o in enumerate(offsets):
        j = i + o
        keep = (j >= 0) & (j < n_cols) & (vals[k] != 0)
        rows.append(i[keep])
        cols.append(j[keep])
        data.append(vals[k][keep])
        keys.append(i[keep] * nd + k)
    order = torch.argsort(torch.cat(keys))
    rows = torch.cat(rows)[order]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, torch.cat(cols)[order],
                                   torch.cat(data)[order],
                                   size=(n, n_cols))


def bound(nd, n, vdt, xdt, n_cols=None):
    """(bound_ms, bound_by) of one SpMV: bytes each input read once and
    the output written once, vs 2·nd·n operations at the peak rate."""
    n_cols = n if n_cols is None else n_cols
    nbytes = nd * n * vdt.itemsize + (n + n_cols) * xdt.itemsize
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * nd * n / PEAK_FLOPS[short(xdt)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_ell(dev, gen, name, cols, vals64, n_cols, errs, row_len=None):
    """B3 vs its plain version in both type pairs on one ELL pack (values
    given in f64, cast to each pair's type; ``cols=None`` for dense
    rows; ``row_len`` as the path passes it), per row to a relative 1e-5
    (f32) or 1e-12 (f64), and bit for bit."""
    import torch
    from amgx_tpu_torch.ops import ell_spmv as emod
    n, K = vals64.shape
    absmax = vals64.abs().max().item()
    for dt in (torch.float32, torch.float64):
        vals = vals64.to(dt).contiguous()
        x = torch.randn(n_cols, dtype=torch.float64, device=dev,
                        generator=gen).to(dt)
        before = emod.launch_count()
        y = emod.ell_spmv(cols, vals, x, row_len)
        torch.cuda.synchronize(dev)
        assert emod.launch_count() == before + 1, "launch not counted"
        ref = emod.ell_spmv_reference(cols, vals, x)
        assert y.dtype == ref.dtype == dt and y.shape == (n,)
        assert torch.isfinite(y).all().item(), (name, dt)
        scale = emod.ell_spmv_reference(cols, vals.double().abs(),
                                        x.double().abs())
        diff, rel = row_errors(y, ref, scale)
        tol = 1e-12 if dt == torch.float64 else 1e-5
        assert rel < tol, (name, short(dt), diff, rel)
        assert torch.equal(y, ref), (name, short(dt), diff)
        record(errs, f"{short(dt)}.{short(dt)}", diff, rel)
        emit("ell_check", case=name, n=n, K=K, n_cols=n_cols,
             dense_rows=cols is None, vals_absmax=absmax, type=short(dt),
             row_len=None if row_len is None else dict(
                 mean=row_len.double().mean().item(),
                 max=int(row_len.max().item())),
             bit_equal=True, max_abs_err=diff, max_row_rel_err=rel,
             tol=tol)


def check_coarse_inverse(dev, gen, name, h, errs):
    """B3 over dense rows vs its plain version on the dense coarse
    inverse of hierarchy ``h``, as the coarse solve passes it."""
    inv = h.coarse_solver.inverse
    check_ell(dev, gen, name, None, inv.double(), inv.shape[1], errs)


def csr_of_ell(cols, vals, n_cols):
    """The same operator as a torch sparse CSR (cuSPARSE yardstick)."""
    import torch
    n, K = cols.shape
    keep = (vals != 0).reshape(-1)
    rows = torch.arange(n, device=cols.device).repeat_interleave(K)[keep]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=cols.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, cols.reshape(-1)[keep].long(),
                                   vals.reshape(-1)[keep],
                                   size=(n, n_cols))


def ell_bound(entries, n, n_cols, dt):
    """(bound_ms, bound_by) of one ELL SpMV over ``entries`` stored
    entries: their column and value read once, x read once, y written
    once, vs 2·entries operations at the peak rate."""
    nbytes = entries * (4 + dt.itemsize) + (n_cols + n) * dt.itemsize
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * entries / PEAK_FLOPS[short(dt)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def level_table(h):
    """(fmt, logical rows, stored rows) per level, then the coarsest."""
    out = [(lv.Ad.fmt, lv.level_stats()[0], lv.Ad.n_rows)
           for lv in h.levels]
    c = h.coarsest
    return out + [(c.device().fmt, c.n_block_rows, c.n_block_rows)]


def profile_window(fn):
    """Device time by kernel of ``fn()`` under ``torch.profiler``:
    (wall_s, device_s, device kernels, top rows)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    top = [dict(name=k[:90], device_ms=t / 1e3, calls=c)
           for k, t, c in sorted(rows, key=lambda r: -r[1])[:8]]
    return (wall, sum(r[1] for r in rows) / 1e6, sum(r[2] for r in rows),
            top)


def reset_counts() -> None:
    """Every launch and dispatch count to 0."""
    from amgx_tpu_torch.ops import binned_spmv as bmod
    from amgx_tpu_torch.ops import dia_spmv as dmod
    from amgx_tpu_torch.ops import ell_spmv as emod
    from amgx_tpu_torch.ops import shift_spmv as shmod
    from amgx_tpu_torch.ops import spmv as smod
    dmod.reset_launches()
    emod.reset_launches()
    bmod.reset_launches()
    shmod.reset_launches()
    smod.reset_dispatch()


def read_counts() -> dict:
    from amgx_tpu_torch.ops import binned_spmv as bmod
    from amgx_tpu_torch.ops import dia_spmv as dmod
    from amgx_tpu_torch.ops import ell_spmv as emod
    from amgx_tpu_torch.ops import shift_spmv as shmod
    from amgx_tpu_torch.ops import spmv as smod
    return dict(dispatch={k: v for k, v in smod.DISPATCH.items() if v},
                declines={k: smod.DISPATCH[k] for k in smod.DECLINES},
                B1=dict(dmod.LAUNCHES), B2=dict(shmod.LAUNCHES),
                B3=dict(emod.LAUNCHES), B4=dict(bmod.LAUNCHES["B4"]),
                B5=dict(bmod.LAUNCHES["B5"]))


def graph_check(pre, dev, gen, eager=True) -> dict:
    """The AMG preconditioner's CUDA graph after a solve: its capture
    (warm-up, capture and instantiation seconds, nodes, pool bytes), the
    launches and dispatches one replay credits and the time of a replay;
    with ``eager``, the time of an eager application, whose counts must
    equal the replay's and whose result must equal the replay's bit for
    bit on the same vector."""
    import torch
    assert len(pre.graphs) == 1, list(pre.graphs)
    (key, g), = pre.graphs.items()
    r = torch.randn(key[0], dtype=torch.float64, device=dev,
                    generator=gen).to(key[1])
    torch.cuda.synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    z_graph = pre.apply(r)
    torch.cuda.synchronize(dev)
    replay_s = time.perf_counter() - t0
    replay_counts = read_counts()
    assert not any(replay_counts["declines"].values()), replay_counts
    assert len(pre.graphs) == 1
    facts = dict(key=[key[0], short(key[1]), key[2], key[3]], **g.stats,
                 replay_s=replay_s, credited_per_replay=replay_counts)
    if not eager:
        return facts
    reset_counts()
    t0 = time.perf_counter()
    z_eager = pre._apply_eager(r)
    torch.cuda.synchronize(dev)
    eager_s = time.perf_counter() - t0
    eager_counts = read_counts()
    assert replay_counts == eager_counts, (replay_counts, eager_counts)
    bit_equal = bool(torch.equal(z_graph, z_eager))
    assert bit_equal, "graph replay differs from the eager application"
    return dict(facts, eager_apply_s=eager_s,
                replay_bit_equal_to_eager=bit_equal)


def binned_bound(entries, b, n, n_cols, vdt, xdt):
    """(bound_ms, bound_by) of one binned SpMV over ``entries`` lanes (or
    stored blocks): a code and b² values read once per entry, x read
    once, y written once, vs 2·b²·entries operations at the peak rate."""
    nbytes = entries * (4 + b * b * vdt.itemsize) \
        + (n_cols + n) * b * xdt.itemsize
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * b * b * entries / PEAK_FLOPS[short(xdt)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_binned(dev, gen, name, Ad, vdt, errs):
    """B4/B5 vs the plain version of the planes on one pack, cast to
    ``vdt`` (x in f64 for f64 planes, else f32), every row to its own
    relative limit: the row's error over its Σ_j |a_ij·x_j|.  Both run
    over the compact pack and must equal the planes' plain version (and
    the compact one) bit for bit."""
    import torch
    from amgx_tpu_torch.ops import binned_spmv as bmod
    b = bmod.bn_block_dim(Ad.bn_dims)
    M = Ad.astype(vdt)
    xdt = torch.float64 if vdt == torch.float64 else torch.float32
    m = int(Ad.bn_dims[8]) * b
    x = torch.randn(m, dtype=torch.float64, device=dev,
                    generator=gen).to(xdt)
    kern = "B4" if b == 1 else "B5"
    before = bmod.launch_count(kern)
    y = bmod.binned_spmv(M, x)
    torch.cuda.synchronize(dev)
    assert bmod.launch_count(kern) == before + 1, "launch not counted"
    ref = bmod.binned_spmv_reference(M.bn_codes, M.bn_vals, M.bn_meta,
                                     M.bn_pos, M.bn_dims, x)
    assert y.dtype == ref.dtype == xdt and y.shape == ref.shape
    assert torch.isfinite(y).all().item(), (name, vdt)
    scale = bmod.binned_spmv_reference(
        M.bn_codes, M.bn_vals.double().abs(), M.bn_meta, M.bn_pos,
        M.bn_dims, x.double().abs())
    diff, rel = row_errors(y, ref, scale)
    tol = BINNED_TOL[short(vdt)]
    assert rel < tol, (name, short(vdt), diff, rel)
    bit_equal = bool(torch.equal(y, ref))
    assert bit_equal, (name, short(vdt), diff)
    own = bmod.binned_compact_reference(M.bn_compact, M.bn_pos, M.bn_dims,
                                        x)
    assert torch.equal(y, own), (name, short(vdt))
    extra = dict(compact_slots=int(M.bn_compact.codes.numel()),
                 stored_entries=int((M.bn_compact.codes != -1).sum()
                                    .item()))
    key = f"{kern}.{short(vdt)}.{short(xdt)}"
    record(errs, key, diff, rel)
    emit("binned_check", case=name, kernel=kern, b=b, rows=int(
        Ad.bn_dims[7]), lanes=int(Ad.bn_codes.numel()),
         chunks_on_zero_block=zero_block_chunks(Ad),
         vals=short(vdt), x=short(xdt), bit_equal=bit_equal,
         max_abs_err=diff, max_row_rel_err=rel, tol=tol, **extra)


def zero_block_chunks(Ad) -> int:
    """Chunks of the pack that read an all-zero plane block: the dummy
    chunks of tiles with no entry (a real chunk holds a nonzero)."""
    C = int(Ad.bn_dims[0])
    nblk = Ad.bn_codes.numel() // 1024
    zero = (Ad.bn_vals.reshape(-1, nblk, 1024) == 0).all(-1).all(0)
    return int(zero[Ad.bn_meta[C:2 * C].long()].sum().item())


def bsr_of_pack(bsr_host, dt, dev):
    """The same operator for the library yardstick: a torch BSR
    (cuSPARSE bsrmv) of the host BSR."""
    import torch
    return torch.sparse_bsr_tensor(
        torch.from_numpy(bsr_host.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(bsr_host.indices.astype(np.int64)).to(dev),
        torch.from_numpy(bsr_host.data).to(dev, dt),
        size=bsr_host.shape)


def csr_of_host(csr_host, dt, dev):
    import torch
    return torch.sparse_csr_tensor(
        torch.from_numpy(csr_host.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(csr_host.indices.astype(np.int64)).to(dev),
        torch.from_numpy(csr_host.data).to(dev, dt), size=csr_host.shape)


def library_of(bsr_host, csr_host, dt, dev):
    """The library yardstick of a block SpMV: ``("cusparse-bsr", BSR
    tensor)`` when this PyTorch multiplies a CUDA BSR tensor by a vector,
    else ``("cusparse-csr", CSR tensor of the scalar expansion)``."""
    import torch
    lib = bsr_of_pack(bsr_host, dt, dev)
    x = torch.ones(bsr_host.shape[1], dtype=dt, device=dev)
    try:
        y = lib @ x
        torch.cuda.synchronize(dev)
    except (RuntimeError, NotImplementedError) as e:
        emit("library_choice", bsr_refused=str(e)[:200])
        return "cusparse-csr", csr_of_host(csr_host, dt, dev)
    assert y.shape == (bsr_host.shape[0],)
    return "cusparse-bsr", lib


def time_binned(dev, gen, label, Ad, lib, nnz_stored, dt, smi,
                stored=None):
    """Kernel, plain version and library times of one binned pack in
    ``dt``, with the bound over the ``nnz_stored`` entries (blocks) the
    product needs (the bound of the work), over the padded planes, over
    the compact pack the kernel reads and, where the host matrix stores
    explicit zeros, over its ``stored`` entries with them."""
    import torch
    from amgx_tpu_torch.ops import binned_spmv as bmod
    b = bmod.bn_block_dim(Ad.bn_dims)
    M = Ad.astype(dt)
    n, m = int(Ad.bn_dims[7]) * b, int(Ad.bn_dims[8]) * b
    x = torch.randn(m, dtype=dt, device=dev, generator=gen)
    ms = time_ms(lambda: bmod.binned_spmv(M, x), dev)
    if b > 1:
        plain_ms = time_ms(lambda: bmod.binned_compact_reference(
            M.bn_compact, M.bn_pos, M.bn_dims, x), dev)
    else:
        plain_ms = time_ms(lambda: bmod.binned_spmv_reference(
            M.bn_codes, M.bn_vals, M.bn_meta, M.bn_pos, M.bn_dims, x), dev)
    library, lib = lib
    library_ms = time_ms(lambda: lib @ x, dev)
    L = int(Ad.bn_codes.numel())
    pad_ms, _ = binned_bound(L, b, n // b, m // b, dt, dt)
    bound_ms, bound_by = binned_bound(nnz_stored, b, n // b, m // b, dt,
                                      dt)
    slots = int(M.bn_compact.codes.numel())
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, compact_slots=slots,
               compact_bound_ms=binned_bound(slots, b, n // b, m // b, dt,
                                             dt)[0],
               padded_bound_ms=pad_ms)
    if stored is not None:
        out.update(stored_with_zeros=stored, stored_with_zeros_bound_ms=(
            binned_bound(stored, b, n // b, m // b, dt, dt)[0]))
    emit("binned_timing", pack=label, b=b, lanes=L, stored=nnz_stored,
         type=short(dt), card=smi, library=library,
         stored_gbs=(nnz_stored * (4 + b * b * dt.itemsize)
                     + 2 * n * dt.itemsize) / (ms * 1e-3) / 1e9, **out)
    return out


def config4_solve(amgx, A_host, dev, block_native, smi, label,
                  profile=False):
    """One config-4 solve through the public API with every count set to
    0 just before and read just after: (result, counts, facts)."""
    import torch
    b = torch.ones(A_host.shape[0], dtype=torch.float64, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    m = amgx.Matrix(A_host, block_dim=4, device="cuda")
    m.device_dtype = np.float32
    # the JAX package's knob for the scalar-expansion planes, read when
    # setup packs the matrix
    os.environ["AMGX_BLOCK_NATIVE"] = "1" if block_native else "0"
    slv = amgx.create_solver(CFG4)
    slv.setup(m)
    del os.environ["AMGX_BLOCK_NATIVE"]
    setup_s = time.perf_counter() - t0
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    res2 = slv.solve(b)
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    x = res.x
    assert x.dtype == torch.float64 and x.shape == (A_host.shape[0],)
    assert x.device == dev and torch.isfinite(x).all().item()
    xh = x.cpu().numpy()
    relres = float(np.linalg.norm(1.0 - A_host @ xh)
                   / np.sqrt(A_host.shape[0]))
    assert relres <= 1e-8, relres
    Ad = m.device()
    from amgx_tpu_torch.core.matrix import pack_kind
    facts = dict(pack=pack_kind(Ad), iterations=res.iterations,
                 relres_f64=relres, setup_s=setup_s,
                 solve_s=res.solve_time, solve_warm_s=res2.solve_time,
                 colors=slv.preconditioner.num_colors,
                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                 block_rows=m.n_block_rows, stored_blocks=A_host.nnz // 16,
                 lanes=int(Ad.bn_codes.numel()))
    if profile:
        wall, dev_s, kern, top = profile_window(lambda: slv.solve(b))
        facts.update(profiled_wall_s=wall, device_busy_s=dev_s,
                     device_kernels=kern, device_time_measured=kern > 0,
                     busy_share_of_unprofiled=dev_s / res2.solve_time,
                     top=top)
    emit(label, **facts, counts=counts, card=smi)
    return slv, m, res, counts, facts


def card_vs_cpu(amgx, A_host, name):
    """Config 4 on the card and on the CPU (plain versions), with the f32
    pack (+ f64 refinement) and with an f64 pack: equal iteration
    counts, each solve's true relres within the tolerance, and x within
    SMALL_X_RTOL.  Returns the card's counts of the f32 solve."""
    import torch
    rhs = np.ones(A_host.shape[0])
    out = {}
    for pdt in (np.float32, np.float64):
        for where in ("cuda", "cpu"):
            m = amgx.Matrix(A_host, block_dim=4, device=where)
            m.device_dtype = pdt
            s_ = amgx.create_solver(CFG4)
            s_.setup(m)
            if where == "cuda":
                reset_counts()
            rr = s_.solve(rhs)
            if where == "cuda":
                torch.cuda.synchronize()
                counts = read_counts() if pdt == np.float32 else counts
            assert rr.status == amgx.SolveStatus.SUCCESS, (name, where)
            x = rr.x.cpu().double().numpy()
            relres = float(np.linalg.norm(rhs - A_host @ x)
                           / np.linalg.norm(rhs))
            assert relres <= 1e-8, (name, where, relres)
            out[pdt, where] = (rr.iterations, rr.x.cpu().double(), relres)
        (ig, xg, rg), (ic, xc, rc) = out[pdt, "cuda"], out[pdt, "cpu"]
        x_diff = ((xg - xc).norm() / xc.norm()).item()
        emit("config4_card_vs_cpu", case=name, pack=np.dtype(pdt).name,
             block_rows=A_host.shape[0] // 4, iterations_card=ig,
             iterations_cpu=ic, relres_card=rg, relres_cpu=rc,
             x_rel_diff_card_vs_cpu=x_diff, limit=SMALL_X_RTOL)
        assert ig == ic, (name, np.dtype(pdt).name, ig, ic)
        assert x_diff < SMALL_X_RTOL, (name, np.dtype(pdt).name, x_diff)
    emit("config4_card_counts", case=name, dispatch=counts["dispatch"],
         B1=counts["B1"], B5=counts["B5"])
    return counts


def block_jacobi_phase(amgx, A, m, dev, smi) -> dict:
    """Phase 13b: PBICGSTAB + BLOCK_JACOBI (``CFG_BJ``: the guarded
    inverse of each 4×4 diagonal block, one sweep) on phase 13's uploaded
    config-4 system (its f32 pack, f64 refinement): setup, a first and a
    warm solve with every count set to 0 just before the first and read
    just after, iterations, the true relres in f64 on the host; then the
    same stack on the ``MID_GRID`` system on the card and on the CPU:
    equal iterations, x within ``SMALL_X_RTOL``."""
    import torch
    from amgx_tpu_torch.io import spe10_block_system
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    slv = amgx.create_solver(CFG_BJ)
    slv.setup(m)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    assert slv.preconditioner.dinv.shape[1:] == (4, 4)
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    res2 = slv.solve(b)
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    assert counts["dispatch"].get("ell/binned-block", 0) > 0, counts
    assert not any(counts["declines"].values()), counts
    assert all(counts["B5"][k] > 0 for k in ("f32.f32", "f64.f64")), counts
    xh = res.x.cpu().numpy()
    relres = float(np.linalg.norm(1.0 - A @ xh) / np.sqrt(A.shape[0]))
    assert relres <= 1e-8, relres
    emit("block_jacobi_path", iterations=res.iterations, relres_f64=relres,
         setup_s=setup_s, solve_s=res.solve_time,
         solve_warm_s=res2.solve_time, counts=counts,
         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=smi)
    del slv, res, res2
    Am = spe10_block_system(*MID_GRID)
    rhs = np.ones(Am.shape[0])
    out = {}
    for where in ("cuda", "cpu"):
        mm = amgx.Matrix(Am, block_dim=4, device=where)
        mm.device_dtype = np.float32
        s_ = amgx.create_solver(CFG_BJ)
        s_.setup(mm)
        rr = s_.solve(rhs)
        assert rr.status == amgx.SolveStatus.SUCCESS, where
        out[where] = (rr.iterations, rr.x.cpu().double())
    (ig, xg), (ic, xc) = out["cuda"], out["cpu"]
    x_diff = ((xg - xc).norm() / xc.norm()).item()
    emit("block_jacobi_card_vs_cpu", grid=list(MID_GRID), pack="float32",
         iterations_card=ig, iterations_cpu=ic,
         x_rel_diff_card_vs_cpu=x_diff, limit=SMALL_X_RTOL)
    assert ig == ic, (ig, ic)
    assert x_diff < SMALL_X_RTOL, x_diff
    return counts


def config4_phases(amgx, dev, smi, gen, b1_errs) -> dict:
    """Phases 13-18: the config-4 path and kernels B4/B5 (B1's checks on
    the block-DIA planes go into ``b1_errs``)."""
    import scipy.sparse as sp
    import torch
    from amgx_tpu_torch.core.matrix import pack_device
    from amgx_tpu_torch.io import (poisson7pt, scattered_block_operator,
                                   spe10_block_system)
    from amgx_tpu_torch.io.gauntlet import elasticity3, jump2, species5

    # ---- 13. the full-width config-4 solve (block-native, B5)
    t0 = time.perf_counter()
    A = spe10_block_system()
    build_s = time.perf_counter() - t0
    emit("config4_system", grid=[60, 220, 85], cells=A.shape[0] // 4,
         unknowns=A.shape[0], stored_blocks=A.nnz // 16,
         host_build_s=build_s)
    slv, m, res, counts, facts = config4_solve(
        amgx, A, dev, True, smi, "config4_path", profile=True)
    assert facts["pack"] == "ell/binned-block", facts["pack"]
    assert counts["dispatch"].get("ell/binned-block", 0) > 0, counts
    assert not any(counts["declines"].values()), counts
    assert all(counts["B5"][k] > 0 for k in ("f32.f32", "f64.f64")), counts
    Ad5 = m.device()
    del slv, res

    # ---- 13b. BLOCK_JACOBI on the same uploaded system
    block_jacobi_phase(amgx, A, m, dev, smi)

    # ---- 14. the same solve on the scalar-expansion planes (B4)
    slv4, m4, res4, counts4, facts4 = config4_solve(
        amgx, A, dev, False, smi, "config4_expansion_path")
    assert facts4["pack"] == "ell/binned", facts4["pack"]
    assert counts4["dispatch"].get("ell/binned", 0) > 0, counts4
    assert not any(counts4["declines"].values()), counts4
    assert all(counts4["B4"][k] > 0 for k in ("f32.f32", "f64.f64"))
    emit("config4_native_vs_expansion", iterations_native=facts[
        "iterations"], iterations_expansion=facts4["iterations"],
         difference=facts4["iterations"] - facts["iterations"],
         slack=EXPANSION_COUNT_SLACK)
    assert abs(facts4["iterations"] - facts["iterations"]) \
        <= EXPANSION_COUNT_SLACK, (facts["iterations"],
                                   facts4["iterations"])
    Ad4 = m4.device()
    del slv4, res4

    # ---- 15. B4 and B5 against their plain versions, every type pair
    errs = {}
    for vdt in (torch.float32, torch.bfloat16, torch.float64):
        check_binned(dev, gen, "config4_block_native", Ad5, vdt, errs)
    for vdt in (torch.float32, torch.float64):
        check_binned(dev, gen, "config4_expansion", Ad4, vdt, errs)
    extra = [("elasticity3_b3", elasticity3(20)[0], 3),
             ("jump2_b2", jump2(48)[0], 2), ("species5_b5",
                                            species5(32)[0], 5),
             ("scattered_block_operator", scattered_block_operator(
                 12288, 4), 4)]
    rng = np.random.default_rng(SEED)
    base = sp.random(3000, 3000, density=0.004, random_state=SEED,
                     format="lil")
    base[:300] = 0                       # rows 0..299 empty: the first
    base = sp.csr_matrix(base)           # two tiles hold no entry
    data = rng.standard_normal((base.nnz, 3, 3))
    extra.append(("empty_tiles", sp.bsr_matrix(
        (data, base.indices, base.indptr), shape=(9000, 9000)), 3))
    # built as CSR (its LIL build took most of this phase's time in an
    # H100 run), row 17 replaced by a wide row
    wide = sp.random(20000, 20000, density=0.002, random_state=SEED,
                     format="csr")
    row17 = rng.standard_normal(20000) * (rng.random(20000) < 0.15)
    wide = sp.csr_matrix(sp.vstack([wide[:17], sp.csr_matrix(row17),
                                    wide[18:]]))
    assert np.diff(wide.indptr).max() > 2048
    for name, M, b in extra:
        P = pack_device(M, b, np.float64, dia_max_diags=0, device=dev)
        assert P.bn_codes is not None, name
        pairs = (torch.float32, torch.bfloat16, torch.float64)
        for vdt in pairs:
            check_binned(dev, gen, name, P, vdt, errs)
    P = amgx.Matrix(wide, device="cuda").device(np.float64)
    from amgx_tpu_torch.core.matrix import pack_kind
    assert pack_kind(P) == "csr/binned", pack_kind(P)
    for vdt in (torch.float32, torch.float64):
        check_binned(dev, gen, "scalar_csr_wide_row", P, vdt, errs)
    del P

    # ---- 16. times at full width
    timing = {}
    bsr = sp.bsr_matrix(A, blocksize=(4, 4))
    scsr = sp.csr_matrix(A)
    # the expansion's product needs its nonzero entries only: 12 of each
    # off-diagonal 4×4 block's 16 are explicit zeros (kron(L, I₄)), which
    # the compact pack drops; the library yardstick gets the same CSR
    # without them
    snz = scsr.copy()
    snz.eliminate_zeros()
    for dt in (torch.float32, torch.float64):
        lib = library_of(bsr, scsr, dt, dev)
        timing[f"B5.{short(dt)}"] = time_binned(
            dev, gen, "config4_block_native", Ad5, lib, A.nnz // 16, dt,
            smi)
        del lib
        lib = ("cusparse-csr", csr_of_host(snz, dt, dev))
        timing[f"B4.{short(dt)}"] = time_binned(
            dev, gen, "config4_expansion", Ad4, lib, snz.nnz, dt, smi,
            stored=scsr.nnz)
        del lib
        torch.cuda.empty_cache()
    del Ad5, Ad4, m, m4, bsr, scsr, snz
    torch.cuda.empty_cache()

    # ---- 17. the bench's 16³ case: block-DIA, B1 as 16 components
    A16 = sp.kron(poisson7pt(16, 16, 16), sp.identity(4)).tocsr()
    c16 = card_vs_cpu(amgx, A16, "bench_16^3_block_dia")
    assert c16["dispatch"].get("dia/block-kernel", 0) > 0, c16
    # B1 on the card's own 16³ pack, every component plane, in the two
    # pairs the path runs: (f32, f32) in BiCGStab, (f64, f64) in the
    # refinement's residuals (the f32 pack widened, strides kept)
    m16 = amgx.Matrix(A16, block_dim=4, device="cuda")
    m16.device_dtype = np.float32
    P16 = m16.device()
    assert P16.fmt == "dia" and P16.block_dim == 4, P16.fmt
    bdia_errs = {}
    for P in (P16, P16.astype(torch.float64)):
        check_block_dia(dev, gen, "bench_16^3_block_dia", P, bdia_errs)
    for key, e in bdia_errs.items():
        record(b1_errs, key, e["abs"], e["rel"])
    del m16, P16

    # ---- 18. the 30 × 110 × 43 masked system
    cmid = card_vs_cpu(amgx, spe10_block_system(*MID_GRID),
                       "masked_30x110x43")
    assert cmid["dispatch"].get("ell/binned-block", 0) > 0, cmid

    kernels = []
    for kern, src_line, cnt in (("B5", 497, counts["B5"]),
                                ("B4", 384, counts4["B4"])):
        for dt in ("f32", "f64"):
            key = f"{kern}.{dt}.{dt}"
            t = timing[f"{kern}.{dt}"]
            kernels.append(dict(
                name=f"binned_spmv_{kern}<{dt},{dt}"
                + (",b=4>" if kern == "B5" else ",b=1>"),
                route="cuda", source="amgx_tpu_torch/csrc/binned_spmv.cu",
                replaces=f"amgx_tpu/ops/pallas_csr.py:{src_line}",
                launches=cnt[f"{dt}.{dt}"],
                launches_by_path=dict(config4_native=counts[kern][
                    f"{dt}.{dt}"], config4_expansion=counts4[kern][
                    f"{dt}.{dt}"]),
                max_abs_err=errs[key]["abs"],
                max_row_rel_err=errs[key]["rel"], **t))
    return dict(kernels=kernels, b1_launches=c16["B1"],
                b1_block_dia_errs=bdia_errs)


def check_shift(dev, gen, name, Ad, errs):
    """B2 vs its plain versions on one shift pack in (f32, f32) and (f64,
    f64): every row to its own relative limit (its error over the row's
    Σ_j |a_ij·x_j|) against the planes' plain version, and bit for bit
    against both that and the compact pack's plain version (the kernel
    reads the compact pack; for finite x the two plain versions agree
    to the bit)."""
    import torch
    from amgx_tpu_torch.ops import shift_spmv as shmod
    for dt in (torch.float32, torch.float64):
        M = Ad.astype(dt)
        x = torch.randn(M.n_cols, dtype=torch.float64, device=dev,
                        generator=gen).to(dt)
        before = shmod.launch_count()
        y = shmod.shift_spmv(M, x)
        torch.cuda.synchronize(dev)
        assert shmod.launch_count() == before + 1, "launch not counted"
        ref = shmod.shift_spmv_reference(M.sh_vals, M.sh_diffs, M.sh_dims,
                                         x, M.n_rows)
        own = shmod.shift_compact_reference(M.sh_compact, M.sh_diffs,
                                            M.sh_dims, x, M.n_rows)
        assert y.dtype == ref.dtype == dt and y.shape == (M.n_rows,)
        assert torch.isfinite(y).all().item(), (name, dt)
        scale = shmod.shift_spmv_reference(
            M.sh_vals.double().abs(), M.sh_diffs, M.sh_dims,
            x.double().abs(), M.n_rows)
        diff, rel = row_errors(y, ref, scale)
        tol = SHIFT_TOL[short(dt)]
        assert rel < tol, (name, short(dt), diff, rel)
        eq_planes = bool(torch.equal(y, ref))
        eq_compact = bool(torch.equal(y, own))
        assert eq_planes and eq_compact, (name, short(dt), diff)
        record(errs, f"{short(dt)}.{short(dt)}", diff, rel)
        S, n_slices, slots, widest = M.sh_compact.dims
        emit("shift_check", case=name, n=M.n_rows,
             tiles=int(M.sh_dims[1]), dpad=int(M.sh_dims[2]),
             slices=n_slices, compact_slots=slots, widest_slice=widest,
             type=short(dt), bit_equal=eq_planes and eq_compact,
             bit_equal_planes_plain=eq_planes,
             bit_equal_compact_plain=eq_compact,
             max_abs_err=diff, max_row_rel_err=rel, tol=tol)


def shift_bounds(Ad, nnz, dt):
    """Bounds of one B2 SpMV, each the larger of its bytes over the
    card's memory rate and 2·nnz operations over the peak rate:
    ``bound_ms`` over the stored values, x and y (what the product
    needs); ``compact_bound_ms`` over the compact pack the kernel reads
    (its slots, mask and pointer words, the diff table, x and y);
    ``planes_bound_ms`` over the class planes (planes, diff table, x,
    y), which the planes' plain version reads; and each layout's
    bytes."""
    T, n_tiles, Dpad = (int(v) for v in Ad.sh_dims[:3])
    S, n_slices, slots, _ = Ad.sh_compact.dims
    n = Ad.n_rows
    xy = 2 * n * dt.itemsize
    t_ops = 2 * nnz / PEAK_FLOPS[short(dt)]
    nnz_bytes = nnz * dt.itemsize + xy
    compact_bytes = slots * S * dt.itemsize + 4 * (2 * n_slices + 1) \
        + 4 * n_tiles * Dpad + xy
    planes_bytes = n_tiles * Dpad * (T * dt.itemsize + 4) + xy
    t_nnz = nnz_bytes / PEAK_BYTES_PER_S
    return dict(
        bound_ms=max(t_nnz, t_ops) * 1e3,
        bound_by="bytes" if t_nnz >= t_ops else "operations",
        compact_bound_ms=max(compact_bytes / PEAK_BYTES_PER_S, t_ops) * 1e3,
        planes_bound_ms=max(planes_bytes / PEAK_BYTES_PER_S, t_ops) * 1e3,
        nnz_bytes=nnz_bytes, compact_bytes=compact_bytes,
        planes_bytes=planes_bytes)


def dfg_solve(amgx, A, where, pdt):
    """One DFG solve of ``b = 1`` under ``DFG_CFG`` on ``where`` with a
    ``pdt`` pack: (iterations, x on the host, true relres in f64)."""
    m = amgx.Matrix(A, device=where)
    m.device_dtype = pdt
    slv = amgx.create_solver(DFG_CFG)
    slv.setup(m)
    res = slv.solve(np.ones(A.shape[0]))
    assert res.status == amgx.SolveStatus.SUCCESS, (where, pdt)
    x = res.x.cpu().double().numpy()
    relres = float(np.linalg.norm(1.0 - A @ x) / np.sqrt(A.shape[0]))
    assert relres <= 1e-8, (where, pdt, relres)
    return res.iterations, x, relres


#: phase 23's pack dtypes, one CPU child each
DFG_CPU_DTYPES = ("float32", "float64")


class CpuReference:
    """Phase 23's CPU solves: one child process per pack dtype
    (``python3 chip_smoke.py --cpu-reference DIR DTYPE``, no card), both
    started together at phase 22, after the last kernel timing.
    ``result()`` waits
    for them and returns per pack dtype (iterations, x, true relres,
    seconds); ``stop()`` ends any that still runs."""

    def __init__(self):
        here = os.path.dirname(os.path.abspath(__file__))
        self.dir = os.path.join(here, "amgx_tpu_torch", "_build",
                                f"dfg_cpu_{os.getpid()}")
        self.procs = {}

    def start(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        for name in DFG_CPU_DTYPES:
            self.procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--cpu-reference", self.dir, name],
                cwd=os.path.dirname(self.dir), env=env)

    def result(self) -> dict:
        out = {}
        for name, proc in self.procs.items():
            rc = proc.wait()
            assert rc == 0, f"CPU reference ({name}) exited {rc}"
            with open(os.path.join(self.dir, f"{name}.json")) as f:
                m = json.load(f)
            x = np.load(os.path.join(self.dir, f"x_{name}.npy"))
            out[name] = (m["iterations"], x, m["relres"], m["seconds"])
        return out

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)


def cpu_reference(out_dir: str, name: str) -> int:
    """A child of :class:`CpuReference`: the ny = 320 DFG solve on the
    CPU (plain versions) with a ``name`` pack, x saved as .npy."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import dfg_cylinder_pressure
    assert not torch.cuda.is_available()
    # the cores, shared by the children; one left to the card process
    torch.set_num_threads(max(1, ((os.cpu_count() or 2) - 1)
                              // len(DFG_CPU_DTYPES)))
    A3 = dfg_cylinder_pressure(DFG_SMALL_NY)
    t0 = time.perf_counter()
    it, x, relres = dfg_solve(amgx, A3, "cpu", np.dtype(name).type)
    np.save(os.path.join(out_dir, f"x_{name}.npy"), x)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(dict(iterations=it, relres=relres,
                       seconds=time.perf_counter() - t0), f)
    return 0


def dfg_phases(amgx, dev, smi, gen, cpu_ref, ell_errs) -> dict:
    """Phases 19-23: the DFG cylinder path (aggregation AMG on an
    uploaded operator) and kernel B2; ``cpu_ref`` is the
    :class:`CpuReference` it starts at phase 23, ``ell_errs`` B3's
    errors, which its checks here join."""
    import scipy.sparse as sp
    import torch
    from amgx_tpu_torch.core.matrix import pack_device, pack_kind
    from amgx_tpu_torch.io import (dfg_cylinder_pressure, poisson5pt,
                                   poisson7pt)
    from amgx_tpu_torch.ops import shift_spmv as shmod

    # ---- 19. the slice's solve at ny = 512
    t0 = time.perf_counter()
    A = dfg_cylinder_pressure(DFG_NY)
    build_s = time.perf_counter() - t0
    n = A.shape[0]
    emit("dfg_system", ny=DFG_NY, rows=n, nnz=A.nnz, host_build_s=build_s,
         levels_cut_at=DFG_LEVELS)
    b = torch.ones(n, dtype=torch.float64, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    m = amgx.Matrix(A, device="cuda")
    m.device_dtype = np.float32
    slv = amgx.create_solver(DFG_CFG)
    slv.setup(m)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    Ad = m.device()
    assert pack_kind(Ad) == "ell/shift", pack_kind(Ad)
    h = slv.preconditioner.hierarchy
    kinds = [pack_kind(lv.Ad) for lv in h.levels]
    assert kinds[0] == "ell/shift" and kinds[1:] and \
        set(kinds[1:]) == {"ell/window"}, kinds
    d = counts["dispatch"]
    # every shift apply is a fine-level apply (the only shift pack) and
    # ran on B2; the coarse ELL levels ran on B3; nothing declined
    assert d.get("ell/shift", 0) == sum(counts["B2"].values()) > 0, counts
    assert all(counts["B2"][k] > 0 for k in ("f32.f32", "f64.f64")), counts
    assert d.get("ell/window", 0) > 0 and counts["B3"]["f32.f32"] > 0
    assert not any(counts["declines"].values()), counts
    assert not any(d.get(k, 0) for k in ("ell/gather", "dia/slices",
                                         "dia/kernel")), counts
    x = res.x
    assert x.dtype == torch.float64 and x.shape == (n,) and x.is_cuda
    assert torch.isfinite(x).all().item()
    xh = x.cpu().numpy()
    relres = float(np.linalg.norm(1.0 - A @ xh) / np.sqrt(n))
    assert relres <= 1e-8, relres
    reset_counts()
    res2 = slv.solve(b)
    torch.cuda.synchronize(dev)
    warm = read_counts()
    assert res2.iterations == res.iterations
    assert warm == counts, (warm, counts)
    assert warm["dispatch"].get("ell/shift", 0) == \
        sum(warm["B2"].values()) > 0, warm
    assert not any(warm["declines"].values()), warm
    dfg_graph = graph_check(slv.preconditioner, dev, gen)
    # the device's busy share over a steady window of the warm solve
    # (DFG_WINDOW_ITERS FGMRES iterations: the profiler's own processing
    # of a whole solve's 1.5 M kernels would outlast the solve many times)
    full_iters, slv.max_iters = slv.max_iters, DFG_WINDOW_ITERS
    t0 = time.perf_counter()
    slv.solve(b)
    torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    wall, dev_s, kern, top = profile_window(lambda: slv.solve(b))
    slv.max_iters = full_iters
    emit("dfg_path", ny=DFG_NY, rows=n, iterations=res.iterations,
         relres_f64=relres, setup_s=setup_s, solve_s=res.solve_time,
         solve_warm_s=res2.solve_time,
         levels=[dict(rows=lv.level_stats()[0], pack=k_)
                 for lv, k_ in zip(h.levels, kinds)]
         + [dict(rows=h.coarsest.n_block_rows, pack="dense-lu")],
         shift_dims=list(Ad.sh_dims),
         grid_stats=h.grid_stats().splitlines()[-2:],
         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
         counts=counts, warm_dispatch=warm["dispatch"],
         amg_graph=dfg_graph,
         window_iterations=DFG_WINDOW_ITERS, window_s=window_s,
         profiled_wall_s=wall, device_busy_s=dev_s, device_kernels=kern,
         device_time_measured=kern > 0,
         busy_share_of_unprofiled=dev_s / window_s, top=top, card=smi)

    # ---- 20. B2 vs plain: the fine pack, the Pallas test cases, the
    # 9-diagonal matrix of tests/test_tpu.py
    errs = {}
    check_shift(dev, gen, f"dfg_{DFG_NY}_fine", Ad, errs)
    check_shift(dev, gen, f"dfg_{DFG_NY}_fine_wide",
                slv._wide_pack(np.dtype(np.float64)), errs)
    # B3 at the shapes this path gives it: every coarse level's A (the
    # fine level is the shift pack) and the dense coarse inverse
    for i, lv in enumerate(h.levels[1:], 1):
        check_ell(dev, gen, f"dfg_{DFG_NY}.level{i}.A",
                  lv.Ad.ell_cols_view(), lv.Ad.ell_vals_view().double(),
                  lv.Ad.n_cols, ell_errs, row_len=lv.Ad.row_len)
    check_coarse_inverse(dev, gen, f"dfg_{DFG_NY}.coarse_inverse", h,
                         ell_errs)
    rng = np.random.default_rng(SEED)

    def randomized(M):
        M = sp.csr_matrix(M)
        M.data = rng.standard_normal(M.nnz)
        return M

    n4 = 4000
    wrap = sp.diags([2.0] * n4).tolil()
    for i in range(n4):
        wrap[i, (i + 1) % n4] = -1.0
        wrap[i, (i - 1) % n4] = -1.0
    n9 = 40000
    r9 = np.random.default_rng(11)
    diag9 = sp.diags(r9.standard_normal((9, n9)),
                     [-160, -41, -7, -1, 0, 1, 7, 41, 160],
                     shape=(n9, n9)).tocsr()
    cases = [("poisson7_12x12x6", randomized(poisson7pt(12, 12, 6))),
             ("poisson7_24^3", randomized(poisson7pt(24, 24, 24))),
             ("poisson5_90x70", randomized(poisson5pt(90, 70))),
             ("periodic_4000", sp.csr_matrix(wrap)),
             ("ragged_tail_37x11", randomized(poisson5pt(37, 11))),
             ("nine_diagonals_40000", diag9),
             ("band_32_classes_2048", sp.diags(
                 r9.standard_normal((32, 2048)), list(range(-16, 16)),
                 shape=(2048, 2048)).tocsr()),
             (f"dfg_{DFG_SMALL_NY}_fine",
              dfg_cylinder_pressure(DFG_SMALL_NY))]
    for name, M in cases:
        P = pack_device(M, 1, np.float64, dia_max_diags=0, device=dev)
        assert pack_kind(P) == "ell/shift", (name, pack_kind(P))
        check_shift(dev, gen, name, P, errs)

    # ---- 21. B2 times on the fine pack
    timing = {}
    for dt in (torch.float32, torch.float64):
        M = Ad.astype(dt)
        xv = torch.randn(n, dtype=dt, device=dev, generator=gen)
        lib = csr_of_host(A, dt, dev)
        ms = time_ms(lambda: shmod.shift_spmv(M, xv), dev)
        plain_ms = time_ms(lambda: shmod.shift_compact_reference(
            M.sh_compact, M.sh_diffs, M.sh_dims, xv, n), dev)
        library_ms = time_ms(lambda: lib @ xv, dev)
        bounds = shift_bounds(M, A.nnz, dt)
        timing[short(dt)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            **{k: bounds[k] for k in ("bound_ms", "bound_by",
                                      "compact_bound_ms")})
        cp = M.sh_compact
        emit("shift_timing", ny=DFG_NY, rows=n, nnz=A.nnz,
             planes_slots=int(M.sh_vals.numel()),
             compact_slots=int(cp.vals.numel()),
             compact_resident_mb=sum(
                 t.numel() * t.element_size()
                 for t in (cp.vals, cp.mask, cp.ptr)) / 1e6,
             type=short(dt), card=smi, library="cusparse-csr",
             plain="shift_compact_reference",
             peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
             **{**bounds, **timing[short(dt)]})
        del lib
    del slv, res, res2, x, m, Ad, h
    torch.cuda.empty_cache()

    # ---- 22. the config's own depth, through the graph, beside the CPU
    # half of phase 23 (two child processes from here on: no kernel
    # timing is left to run beside them)
    cpu_ref.start()
    full = dfg_full_depth(amgx, dev, smi, gen, A, ell_errs)

    # ---- 23. card against CPU at ny = 320
    A3 = dfg_cylinder_pressure(DFG_SMALL_NY)
    card = {}
    for name in DFG_CPU_DTYPES:
        t0 = time.perf_counter()
        card[name] = dfg_solve(amgx, A3, "cuda", np.dtype(name).type)
        card[name] += (time.perf_counter() - t0,)
    cpu = cpu_ref.result()
    for name in DFG_CPU_DTYPES:
        ig, xg, rg, card_s = card[name]
        ic, xc, rc, cpu_s = cpu[name]
        x_diff = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
        emit("dfg_card_vs_cpu", ny=DFG_SMALL_NY, rows=A3.shape[0],
             pack=name, iterations_card=ig,
             iterations_cpu=ic, relres_card=rg, relres_cpu=rc,
             x_rel_diff_card_vs_cpu=x_diff,
             x_bit_equal=bool(np.array_equal(xg, xc)),
             card_setup_and_solve_s=card_s, cpu_setup_and_solve_s=cpu_s)
        assert ig == ic, (name, ig, ic)
        assert x_diff < SMALL_X_RTOL, (name, x_diff)
        if name == "float32":
            assert np.array_equal(xg, xc), "ny = 320 f32: x not bit-equal"

    kernels = []
    for dt in ("f32", "f64"):
        key = f"{dt}.{dt}"
        kernels.append(dict(
            name=f"shift_spmv<{dt},{dt}>", route="cuda",
            source="amgx_tpu_torch/csrc/shift_spmv.cu",
            replaces="amgx_tpu/ops/pallas_shift.py:187",
            launches=counts["B2"][key],
            launches_by_path=dict(dfg=counts["B2"][key]),
            max_abs_err=errs[key]["abs"],
            max_row_rel_err=errs[key]["rel"], **timing[dt]))
    return dict(kernels=kernels, b3_launches=counts["B3"],
                b3_launches_full_depth=full["B3"])


def dfg_full_depth(amgx, dev, smi, gen, A, ell_errs) -> dict:
    """Phase 22: the DFG operator under the headline config at its own
    depth (``amg:max_levels=20``: SIZE_2 down to a 28-row dense coarse
    solve), f32 pack, f64 refinement: setup; a first solve capped at
    ``DFG_REPLAY_ITERS`` iterations (it captures the preconditioner's
    graph: one eager application, the capture and the instantiation)
    and a warm solve capped the same way, which replays it: equal
    iterations and equal launches; then the full solve (replays), its
    iterations and the true relres in f64 on the host, the graph's facts
    (:func:`graph_check`, without an eager application: one takes some
    30 s at this depth), its launches (returned); B3 against its plain
    version on the ELL levels from phase 19's dense coarsest level down.
    It runs beside phase 23's CPU children.  ``scripts/torch_dfg_depth.py
    --solve`` times a full warm solve at this depth."""
    import torch
    n = A.shape[0]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    m = amgx.Matrix(A, device="cuda")
    m.device_dtype = np.float32
    slv = amgx.create_solver(HEADLINE_CFG)
    slv.setup(m)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    h = slv.preconditioner.hierarchy
    b = torch.ones(n, dtype=torch.float64, device=dev)
    # the capturing solve against a replaying one, both capped
    max_iters, slv.max_iters = slv.max_iters, DFG_REPLAY_ITERS
    capped = []
    for _ in range(2):
        reset_counts()
        res_c = slv.solve(b)
        torch.cuda.synchronize(dev)
        capped.append((res_c.iterations, read_counts(), res_c.solve_time))
    (it_first, counts_first, first_s), (it_warm, counts_warm, warm_s) = \
        capped
    assert it_first == it_warm == DFG_REPLAY_ITERS, capped
    # the first solve's first application ran eagerly, the warm solve's
    # all replay: equal counts
    assert counts_warm == counts_first, (counts_first, counts_warm)
    slv.max_iters = max_iters
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert not any(counts["declines"].values()), counts
    xh = res.x.cpu().numpy()
    relres = float(np.linalg.norm(1.0 - A @ xh) / np.sqrt(n))
    assert relres <= 1e-8, relres
    graph = graph_check(slv.preconditioner, dev, gen, eager=False)
    for i, lv in enumerate(h.levels[DFG_LEVELS - 1:], DFG_LEVELS - 1):
        check_ell(dev, gen, f"dfg_{DFG_NY}_full.level{i}.A",
                  lv.Ad.ell_cols_view(), lv.Ad.ell_vals_view().double(),
                  lv.Ad.n_cols, ell_errs, row_len=lv.Ad.row_len)
    emit("dfg_full_depth", ny=DFG_NY, rows=n, config="amg:max_levels=20",
         levels=[lv.level_stats()[0] for lv in h.levels]
         + [h.coarsest.n_block_rows],
         iterations=res.iterations, relres_f64=relres, setup_s=setup_s,
         solve_s=res.solve_time, capped_iterations=DFG_REPLAY_ITERS,
         capped_first_solve_s=first_s, capped_warm_solve_s=warm_s,
         amg_graph=graph, counts=counts,
         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=smi)
    del slv, m, h, res, res_c
    torch.cuda.empty_cache()
    return counts


def dia3_streams(slv, dev, gen, smi, b) -> dict:
    """Phase 9c: B1 on the three DIA streams of the classical path's
    ``dia3`` level (R₀·(A·(P₀·x)), 2,097,152 rows), in (f32, f32) as the
    cycle runs them: kernel, plain version and one cuSPARSE CSR SpMV
    (CUDA events, median of 30), the bound, and the launches a solve
    makes on each pack: the launches on it in one eager application
    times the applications of a solve (P₀ and R₀ also serve level 0 as
    its P and R, A is level 0's operator)."""
    import torch
    from amgx_tpu_torch.ops import dia_spmv as dmod
    from amgx_tpu_torch.ops import spmv as smod
    pre = slv.preconditioner
    lv = next(lv for lv in pre.hierarchy.levels if lv.Ad.fmt == "dia3")
    streams = {"P0": lv.Ad.P, "A": lv.Ad.A, "R0": lv.Ad.R}
    (key, _g), = pre.graphs.items()
    per_app = {}
    real = smod.dia_spmv

    def spy(vals, x, offsets):
        per_app[vals.data_ptr()] = per_app.get(vals.data_ptr(), 0) + 1
        return real(vals, x, offsets)

    r = torch.randn(key[0], dtype=torch.float64, device=dev,
                    generator=gen).to(key[1])
    smod.dia_spmv = spy
    try:
        pre._apply_eager(r)
    finally:
        smod.dia_spmv = real
    apps = [0]

    def counting(*args, **kw):
        apps[0] += 1
        return type(pre).apply(pre, *args, **kw)

    pre.apply = counting
    try:
        slv.solve(b)
    finally:
        del pre.apply
    out = {}
    for name, M in streams.items():
        vals = M.vals.to(torch.float32).contiguous()
        x = torch.randn(M.n_cols, dtype=torch.float32, device=dev,
                        generator=gen)
        nd, n = vals.shape
        csr = csr_of_dia(vals, M.dia_offsets, M.n_cols)
        ms = time_ms(lambda: dmod.dia_spmv(vals, x, M.dia_offsets), dev)
        plain_ms = time_ms(lambda: dmod.dia_spmv_reference(
            vals, x, M.dia_offsets), dev)
        library_ms = time_ms(lambda: csr @ x, dev)
        bound_ms, bound_by = bound(nd, n, vals.dtype, x.dtype, M.n_cols)
        out[name] = dict(n=n, n_cols=M.n_cols, nd=nd,
                         nonzeros=int((vals != 0).sum().item()), ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         launches_per_solve=per_app.get(
                             M.vals.data_ptr(), 0) * apps[0])
        del csr
    emit("dia3_stream_timing", type="f32.f32", card=smi,
         applications_per_solve=apps[0], streams=out)
    return out


def nested_phase(amgx, dev, gen, smi) -> dict:
    """Phase 5b: the headline stack at 16³ cut at two levels, whose coarse
    solver is a second AMG (``NESTED_CFG``), f32 pack: a solve on the card
    with every count set to 0 just before and read just after, the outer
    graph (:func:`graph_check`: a replay bit-equal to an eager
    application, equal credited counts), with no inner graph built
    beside it by the solve, and the same solve on the CPU: equal
    iterations, x bit-equal."""
    import torch
    from amgx_tpu_torch.io import poisson7pt_device
    from amgx_tpu_torch.solvers.amg_solver import AMGSolver
    out = {}
    for where in ("cuda", "cpu"):
        A = poisson7pt_device(16, 16, 16, device_dtype=np.float32,
                              device=where)
        slv = amgx.create_solver(NESTED_CFG)
        slv.setup(A)
        reset_counts()
        res = slv.solve(np.ones(16 ** 3))
        if where == "cuda":
            torch.cuda.synchronize(dev)
            counts = read_counts()
        assert res.status == amgx.SolveStatus.SUCCESS, (where, res.status)
        out[where] = (res.iterations, res.x.cpu(), slv)
    it_g, xg, slv = out["cuda"]
    it_c, xc, _ = out["cpu"]
    assert counts["B1"]["f32.f32"] > 0 and counts["B3"]["f32.f32"] > 0
    assert not any(counts["declines"].values()), counts
    pre = slv.preconditioner
    inner = pre.hierarchy.coarse_solver
    assert isinstance(inner, AMGSolver) and inner.graphs == {}
    graph = graph_check(pre, dev, gen)
    assert it_g == it_c == NESTED_ITERS, (it_g, it_c)
    assert torch.equal(xg, xc), "nested AMG: card x differs from CPU x"
    emit("nested_amg", n=16 ** 3, levels=[lv.Ad.n_rows for lv in
                                         pre.hierarchy.levels],
         inner_levels=[lv.Ad.n_rows for lv in inner.hierarchy.levels]
         + [inner.hierarchy.coarsest.n_block_rows],
         iterations_card=it_g, iterations_cpu=it_c, x_bit_equal=True,
         counts=counts, amg_graph=graph,
         card=smi)
    return counts


def amg_of(slv):
    """The AMG preconditioner of a solver, or None."""
    from amgx_tpu_torch.solvers.amg_solver import AMGSolver
    pre = getattr(slv, "preconditioner", None)
    return pre if isinstance(pre, AMGSolver) else None


def family_solve(amgx, dev, smi, gen, label, cfg, matrix, relres_of,
                 converge=True, window=None, **extra) -> dict:
    """One stack of the solver family on the card through the public
    API: setup, then a first solve with every count set to 0 just before
    and read just after, a warm solve (equal iterations), the true relres
    in f64 (``relres_of(x)``, limit 1e-8 where ``converge``), the AMG
    graph (:func:`graph_check`: a replay bit-equal to an eager
    application) and the busy share of a profiled warm solve — of its
    first ``window`` iterations only where given (a profiled solve of
    hundreds of iterations takes a minute).  Emits the phase line and
    returns its counts."""
    import torch
    t0 = time.perf_counter()
    slv = amgx.create_solver(cfg)
    slv.setup(matrix)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    b = torch.ones(matrix.shape[0], dtype=torch.float64, device=dev)
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    res2 = slv.solve(b)
    assert res2.iterations == res.iterations, (label, res.iterations,
                                               res2.iterations)
    assert not any(counts["declines"].values()), (label, counts)
    x = res.x
    assert x.dtype == torch.float64 and x.device == dev
    assert torch.isfinite(x).all().item(), label
    relres = relres_of(x)
    if converge:
        assert res.status == amgx.SolveStatus.SUCCESS, (label, res.status)
        assert relres <= 1e-8, (label, relres)
    pre = amg_of(slv)
    graph = graph_check(pre, dev, gen) if pre is not None else None
    busy_wall = res2.solve_time
    if window is not None:
        slv.max_iters = window
        busy_wall = slv.solve(b).solve_time
    wall, dev_s, kern, top = profile_window(lambda: slv.solve(b))
    emit(label, iterations=res.iterations, relres_f64=relres,
         converged=res.status == amgx.SolveStatus.SUCCESS,
         failure=None if res.failure is None else
         [res.failure.kind.value, res.failure.iteration],
         setup_s=setup_s, solve_s=res.solve_time,
         solve_warm_s=res2.solve_time, counts=counts, amg_graph=graph,
         device_busy_s=dev_s, device_kernels=kern,
         busy_share_of_unprofiled=dev_s / busy_wall, top=top[:4],
         profiled_iterations=window or res.iterations, card=smi, **extra)
    del slv, res, res2
    torch.cuda.empty_cache()
    return counts


def host_relres(A_host):
    """relres_of for a host operator: ‖b − A·x‖/‖b‖ for b = 1, in f64 on
    the host."""
    def f(x):
        xh = x.cpu().numpy()
        return float(np.linalg.norm(1.0 - A_host @ xh)
                     / np.sqrt(A_host.shape[0]))
    return f


def pack_relres(m):
    """relres_of for a device-generated operator: the residual through
    its pack widened to f64 (kernel B1), on the card."""
    import torch
    from amgx_tpu_torch.ops.spmv import spmv

    def f(x):
        Ad64 = m.device().astype(torch.float64)
        b = torch.ones_like(x)
        return (torch.linalg.vector_norm(b - spmv(Ad64, x))
                / torch.linalg.vector_norm(b)).item()
    return f


def merge_counts(total: dict, counts: dict) -> None:
    """Add one run's launches by kernel and type pair into ``total``."""
    for k in ("B1", "B2", "B3", "B4", "B5"):
        for pair, n in counts[k].items():
            total.setdefault(k, {}).setdefault(pair, 0)
            total[k][pair] += n


def small_card_vs_cpu(amgx, label, cfg, make, rhs_n, block_dim=1):
    """One small stack on the card and on the CPU (plain versions): equal
    iterations and x within SMALL_X_RTOL.  ``make(where)`` returns the
    uploaded matrix on ``where``."""
    out = {}
    for where in ("cuda", "cpu"):
        m = make(where)
        s_ = amgx.create_solver(cfg)
        s_.setup(m)
        rr = s_.solve(np.ones(rhs_n))
        out[where] = (rr.iterations, rr.x.cpu().double(), rr.status)
    (ig, xg, sg), (ic, xc, sc) = out["cuda"], out["cpu"]
    x_diff = ((xg - xc).norm() / xc.norm()).item()
    facts = dict(case=label, iterations_card=ig, iterations_cpu=ic,
                 status_card=int(sg), status_cpu=int(sc),
                 x_rel_diff_card_vs_cpu=x_diff,
                 x_bit_equal=bool(np.array_equal(xg.numpy(), xc.numpy())),
                 limit=SMALL_X_RTOL)
    emit("family_card_vs_cpu", **facts)
    assert ig == ic, facts
    assert x_diff < SMALL_X_RTOL, facts
    return facts


def family_phases(amgx, dev, smi, gen) -> dict:
    """Phases 24-28: the solver names of this slice on the card.  Returns
    the kernels' launches summed over the full-width stacks of each phase
    (``{phase: {kernel: {pair: n}}}``)."""
    import torch
    from amgx_tpu_torch.io import (dfg_cylinder_pressure, poisson7pt,
                                   poisson7pt_device, spe10_block_system)
    launches = {}

    # ---- 24. the Krylov family and CF_JACOBI on the classical 128³
    t_phase = time.perf_counter()
    side = FAMILY_SIDE
    Ahost = poisson7pt(side, side, side)
    total = launches.setdefault("classical_family", {})
    stacks = [(f"family_classical_{name}",
               CFG_CLA.replace("solver(out)=PCG", f"solver(out)={name}"),
               FAMILY_PACK.get(name, np.float32))
              for name in FAMILY_KRYLOV]
    stacks.append(("family_classical_CF_JACOBI",
                   CFG_CLA.replace("JACOBI_L1", "CF_JACOBI"), np.float32))
    stacks += [(f"family_classical_{name}_f32",
                CFG_CLA.replace("solver(out)=PCG", f"solver(out)={name}"),
                np.float32) for name in FAMILY_PACK]
    for label, cfg, pdt in stacks:
        m = amgx.Matrix(Ahost, device="cuda")
        m.device_dtype = pdt
        counts = family_solve(amgx, dev, smi, gen, label, cfg, m,
                              host_relres(Ahost),
                              converge=not label.endswith("_f32"),
                              n=side ** 3, pack=np.dtype(pdt).name)
        merge_counts(total, counts)
        assert sum(counts["B1"].values()) > 0 and \
            sum(counts["B3"].values()) > 0, (label, counts)
        del m
    del Ahost
    emit("family_classical_phase", elapsed_phase_s=time.perf_counter()
         - t_phase)

    # ---- 25. Chebyshev on the headline 128³
    t_phase = time.perf_counter()
    total = launches.setdefault("chebyshev", {})
    A = poisson7pt_device(side, side, side, device_dtype=np.float32,
                          device="cuda")
    counts = family_solve(
        amgx, dev, smi, gen, "family_headline_CHEBYSHEV_POLY",
        HEADLINE_CFG.replace("BLOCK_JACOBI", "CHEBYSHEV_POLY"), A,
        pack_relres(A), n=side ** 3)
    merge_counts(total, counts)
    assert counts["B1"]["f32.f32"] > 0, counts
    counts = family_solve(
        amgx, dev, smi, gen, "family_CHEBYSHEV_noprec",
        CHEB_NOPREC_CFG.format(it=CHEB_ITERS), A, pack_relres(A),
        converge=False, n=side ** 3, budget=CHEB_ITERS)
    merge_counts(total, counts)
    del A
    emit("family_chebyshev_phase", elapsed_phase_s=time.perf_counter()
         - t_phase)

    # ---- 26. config 4's full SPE10 system, uploaded once
    t_phase = time.perf_counter()
    total = launches.setdefault("config4_family", {})
    A4 = spe10_block_system(*FAMILY_C4_GRID)
    m = amgx.Matrix(A4, block_dim=4, device="cuda")
    m.device_dtype = np.float32
    for label, cfg in (("family_config4_IDR_DILU", IDR_DILU_CFG),
                       ("family_config4_PBICGSTAB_MCGS", MCGS_CFG)):
        counts = family_solve(amgx, dev, smi, gen, label, cfg, m,
                              host_relres(A4), n=A4.shape[0])
        merge_counts(total, counts)
        assert counts["dispatch"].get("ell/binned-block", 0) > 0, counts
        assert counts["B5"]["f32.f32"] > 0, (label, counts)
    del m, A4
    torch.cuda.empty_cache()
    emit("family_config4_phase", elapsed_phase_s=time.perf_counter()
         - t_phase)

    # ---- 27. MULTICOLOR_ILU on the DFG operator at ILU_NY (reduced)
    t_phase = time.perf_counter()
    total = launches.setdefault("dfg_ilu", {})
    Ad = dfg_cylinder_pressure(ILU_NY)
    m = amgx.Matrix(Ad, device="cuda")
    m.device_dtype = np.float32
    counts = family_solve(
        amgx, dev, smi, gen, "family_dfg_PBICGSTAB_ILU0", ILU_CFG, m,
        host_relres(Ad), window=50, ny=ILU_NY, rows=Ad.shape[0],
        reduced="ny = 128, not 512: the ILU factorisation is the JAX "
        "package's host loop over rows, minutes at 1.39 M rows")
    merge_counts(total, counts)
    del m
    emit("family_ilu_phase", elapsed_phase_s=time.perf_counter() - t_phase)

    # ---- 28. the card against the CPU, every name of this slice
    family_small_checks(amgx)
    return launches


def family_small_checks(amgx) -> None:
    """Phase 28: each solver name of this slice on a small system on the
    card against the same stack on the CPU (:func:`small_card_vs_cpu`)."""
    from amgx_tpu_torch.io import (dfg_cylinder_pressure, poisson7pt,
                                   poisson7pt_device, spe10_block_system)
    t_phase = time.perf_counter()
    cla = FAMILY_CLA_SIDE
    A_cla = poisson7pt(cla, cla, cla)

    def host_matrix(A_host, b=1):
        def make(where):
            m_ = amgx.Matrix(A_host, block_dim=b, device=where)
            m_.device_dtype = np.float32
            return m_
        return make

    def gen_matrix(where):
        return poisson7pt_device(FAMILY_AGG_SIDE, FAMILY_AGG_SIDE,
                                 FAMILY_AGG_SIDE, device_dtype=np.float32,
                                 device=where)

    cla_cfg = CFG_CLA + ", amg:strength_threshold=0.2401"
    checks = [(f"classical_{name}",
               cla_cfg.replace("solver(out)=PCG", f"solver(out)={name}"))
              for name in FAMILY_KRYLOV]
    checks += [("classical_PCG_krylov_comm_CA",
                cla_cfg + ", out:krylov_comm=CA"),
               ("classical_PCG_krylov_comm_PIPELINED",
                cla_cfg + ", out:krylov_comm=PIPELINED"),
               ("classical_CF_JACOBI",
                cla_cfg.replace("JACOBI_L1", "CF_JACOBI")),
               ("PCGF_NOSOLVER",
                CFG_CLA.split(", out:preconditioner")[0].replace(
                    "out:max_iters=100", "out:max_iters=200").replace(
                    "solver(out)=PCG", "solver(out)=PCGF")
                + ", out:preconditioner(p)=NOSOLVER")]
    small = []
    for label, cfg in checks:
        small.append(small_card_vs_cpu(amgx, label, cfg,
                                       host_matrix(A_cla), cla ** 3))
    n_agg = FAMILY_AGG_SIDE ** 3
    for sm in ("CHEBYSHEV_POLY", "POLYNOMIAL", "KPZ_POLYNOMIAL",
               "CHEBYSHEV", "MULTICOLOR_GS", "GS", "FIXCOLOR_GS",
               "KACZMARZ", "MULTICOLOR_ILU"):
        small.append(small_card_vs_cpu(
            amgx, f"headline_{sm}", HEADLINE_CFG.replace("BLOCK_JACOBI",
                                                          sm),
            gen_matrix, n_agg))
    small.append(small_card_vs_cpu(
        amgx, "CHEBYSHEV_noprec", CHEB_NOPREC_CFG.format(it=60),
        gen_matrix, n_agg))
    A_blk = spe10_block_system(*FAMILY_BLOCK_GRID)
    for label, cfg in (
            ("config4_IDR_DILU", IDR_DILU_CFG),
            ("config4_IDRMSYNC_DILU", IDR_DILU_CFG.replace(
                "solver(out)=IDR", "solver(out)=IDRMSYNC")),
            ("config4_PBICGSTAB_MCGS", MCGS_CFG),
            ("config4_PBICGSTAB_KACZMARZ", CFG4.replace(
                "MULTICOLOR_DILU", "KACZMARZ"))):
        small.append(small_card_vs_cpu(amgx, label, cfg,
                                       host_matrix(A_blk, 4),
                                       A_blk.shape[0]))
    A_ilu = dfg_cylinder_pressure(32)
    small.append(small_card_vs_cpu(amgx, "dfg32_PBICGSTAB_ILU0", ILU_CFG,
                                   host_matrix(A_ilu), A_ilu.shape[0]))
    emit("family_card_vs_cpu_phase", checks=len(small),
         x_bit_equal=sum(f["x_bit_equal"] for f in small),
         elapsed_phase_s=time.perf_counter() - t_phase)


def drift_values(host, k: int, seed: int = SEED):
    """The values of A_k = D_k·A·D_k, D_k = diag(1 + 0.1·u·k), u from
    ``default_rng(seed)``, in the entry order of the host matrix
    ``host`` (a CSR, or a BSR of b×b blocks): the loop of
    examples/amgx_resetup_timestepping.py."""
    u = np.random.default_rng(seed).uniform(size=host.shape[0])
    d = 1.0 + 0.1 * u * k
    b = host.blocksize[0] if hasattr(host, "blocksize") else 1
    rows = np.repeat(np.arange(host.indptr.size - 1), np.diff(host.indptr))
    if b == 1:
        return host.data * d[rows] * d[host.indices]
    db = d.reshape(-1, b)
    return db[rows][:, :, None] * host.data * db[host.indices][:, None, :]


def coupling_drift_values(host, k: int, seed: int = SEED):
    """The values of a symmetric operator whose couplings drift:
    a_ij ← a_ij·(1 + 0.1·k·(u_i + u_j)/2) off the diagonal, the diagonal
    moved by the same change of its row's couplings (each row sum kept),
    in the entry order of the host CSR ``host``.  A variable-coefficient
    change of a diffusion operator: the constant vector keeps its
    energy, which D·A·D does not (:func:`drift_values`)."""
    u = np.random.default_rng(seed).uniform(size=host.shape[0])
    rows = np.repeat(np.arange(host.shape[0]), np.diff(host.indptr))
    off = rows != host.indices
    w = 1.0 + 0.1 * k * (u[rows] + u[host.indices]) / 2
    data = np.where(off, host.data * w, host.data)
    moved = np.bincount(rows[off], weights=(data - host.data)[off],
                        minlength=host.shape[0])
    return np.where(off, data, data - moved[rows])


def resetup_path(amgx, dev, smi, gen, label, cfg, A0, pdt, expect,
                 check_step=None, fresh_of=None,
                 drift=drift_values) -> dict:
    """One path of phase 29: setup on ``A0`` (step 0), then
    ``RESETUP_STEPS - 1`` steps of ``replace_coefficients`` (A_k of
    ``drift``),
    ``resetup`` (which must take the ``expect`` path and keep the
    graphs) and a first and a warm solve; every count set to 0 just
    before each first solve and summed, no capture after step 0.
    ``check_step(slv, Ak, k)`` adds facts of its own to a step's line;
    ``fresh_of(Ak)`` is a fresh setup and solve of the same A_k, its
    iterations and x held bit-equal.  Returns the launches by kernel."""
    import torch
    from amgx_tpu_torch.utils import cuda_graph as cg
    torch.cuda.reset_peak_memory_stats(dev)
    m = amgx.Matrix(A0, device="cuda")
    m.device_dtype = pdt
    t0 = time.perf_counter()
    slv = amgx.create_solver(cfg)
    slv.setup(m)
    torch.cuda.synchronize(dev)
    fresh_setup_s = time.perf_counter() - t0
    pre = amg_of(slv)
    h = pre.hierarchy
    assert h.last_resetup == "fresh", h.last_resetup
    host0 = m.host.copy()
    b = torch.ones(A0.shape[0], dtype=torch.float64, device=dev)
    total = {}
    for k in range(RESETUP_STEPS):
        Ak = A0
        resetup_s = None
        if k:
            Ak = host0.copy()
            Ak.data = drift(host0, k)
            t0 = time.perf_counter()
            m.replace_coefficients(Ak.data)
            slv.resetup(m)
            torch.cuda.synchronize(dev)
            resetup_s = time.perf_counter() - t0
            assert h.last_resetup == expect, (label, h.last_resetup)
            assert pre.rebind["graphs_dropped"] == 0, (label, pre.rebind)
        caps = cg.CAPTURES["count"]
        reset_counts()
        res = slv.solve(b)
        torch.cuda.synchronize(dev)
        counts = read_counts()
        merge_counts(total, counts)
        captures = cg.CAPTURES["count"] - caps
        assert captures == (0 if k else 1), (label, k, captures)
        assert not any(counts["declines"].values()), (label, counts)
        res2 = slv.solve(b)
        assert res2.iterations == res.iterations
        assert res.status == amgx.SolveStatus.SUCCESS, (label, k)
        x = res.x
        assert x.dtype == torch.float64 and torch.isfinite(x).all().item()
        relres = host_relres(Ak)(x)
        assert relres <= 1e-8, (label, k, relres)
        extra = {}
        if fresh_of is not None:
            t0 = time.perf_counter()
            f_res, f_setup_s = fresh_of(Ak)
            extra.update(fresh_iterations=f_res.iterations,
                         fresh_step_setup_s=f_setup_s,
                         fresh_x_bit_equal=bool(torch.equal(f_res.x, x)))
            assert f_res.iterations == res.iterations, (label, k)
            assert extra["fresh_x_bit_equal"], (label, k)
            del f_res
        if check_step is not None and k:
            extra.update(check_step(slv, Ak, k))
        graph = graph_check(pre, dev, gen)
        rb = pre.rebind["last"]
        emit(label, step=k, path=h.last_resetup if k else "fresh",
             resetup_s=resetup_s, fresh_setup_s=fresh_setup_s,
             first_solve_s=res.solve_time, warm_solve_s=res2.solve_time,
             iterations=res.iterations, relres_f64=relres,
             graphs_kept=pre.rebind["graphs_kept"],
             graphs_dropped=pre.rebind["graphs_dropped"],
             tensors_paired=None if rb is None else rb.tensors,
             tensors_copied=None if rb is None else rb.copied,
             copied_bytes=None if rb is None else rb.bytes,
             captures=captures, amg_graph=graph,
             peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
             counts=counts, card=smi, **extra)
    del slv, pre, h, m
    torch.cuda.empty_cache()
    return total


def resetup_phases(amgx, dev, smi, gen) -> dict:
    """Phase 29: values-only resetup on the headline, classical and DFG
    paths at full size, then the small card-against-CPU checks.  Returns
    the kernels' launches by path (``{"resetup_<path>": {kernel:
    {pair: n}}}``)."""
    import scipy.sparse as sp
    import torch
    from amgx_tpu_torch.errors import BadConfigurationError
    from amgx_tpu_torch.io import (dfg_cylinder_pressure, poisson7pt,
                                   spe10_block_system)
    reuse = ", amg:structure_reuse_levels=-1"
    out = {}

    # ---- the headline 128³: the DIA plan re-derived on the card
    t_phase = time.perf_counter()
    side = FAMILY_SIDE
    A0 = poisson7pt(side, side, side)
    cfg = HEADLINE_CFG + reuse

    def fresh_of(Ak):
        m = amgx.Matrix(Ak, device="cuda")
        m.device_dtype = np.float32
        m.grid_dims = (side, side, side)
        t0 = time.perf_counter()
        s_ = amgx.create_solver(cfg)
        s_.setup(m)
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        return s_.solve(torch.ones(Ak.shape[0], dtype=torch.float64,
                                   device=dev)), setup_s

    out["resetup_headline"] = resetup_path(
        amgx, dev, smi, gen, "resetup_headline", cfg, A0, np.float32,
        "dia_device", fresh_of=fresh_of)
    assert out["resetup_headline"]["B1"]["f32.f32"] > 0
    emit("resetup_headline_phase",
         elapsed_phase_s=time.perf_counter() - t_phase)

    # ---- the classical stack (96³): the Galerkin products refreshed on
    # the card
    t_phase = time.perf_counter()

    def level1_vs_rap(slv, Ak, k):
        h = slv.preconditioner.hierarchy
        P0 = h._structure[0][1][0]
        ref = sp.csr_matrix(sp.csr_matrix(P0.T) @ Ak @ P0)
        got = sp.csr_matrix(h.levels[1].A.host)
        err = abs(got - ref).max() / abs(ref).max()
        assert err <= RAP_RTOL, (k, err)
        return dict(level1_rows=got.shape[0], level1_nnz=got.nnz,
                    level1_rel_err_vs_host_rap=err, limit=RAP_RTOL)

    cs = RESETUP_CLA_SIDE
    out["resetup_classical"] = resetup_path(
        amgx, dev, smi, gen, "resetup_classical",
        CFG_CLA + ", amg:strength_threshold=0.2401" + reuse,
        poisson7pt(cs, cs, cs), np.float64, "classical_device",
        check_step=level1_vs_rap)
    assert out["resetup_classical"]["B3"]["f64.f64"] > 0
    del A0
    emit("resetup_classical_phase",
         elapsed_phase_s=time.perf_counter() - t_phase)

    # ---- the DFG (ny = 320): aggregation replayed through the engine's
    # cached plans.  Its couplings drift: under D·A·D the
    # piecewise-constant aggregates no longer hold the operator's
    # near-null vector D⁻¹·1, and a fresh setup of D₁·A₀·D₁ stagnates
    # (relres 0.98 at ny = 512; PERF.md)
    t_phase = time.perf_counter()
    out["resetup_dfg"] = resetup_path(
        amgx, dev, smi, gen, "resetup_dfg", DFG_CFG + reuse,
        dfg_cylinder_pressure(RESETUP_DFG_NY), np.float32, "host_replay",
        drift=coupling_drift_values)
    assert out["resetup_dfg"]["B2"]["f32.f32"] > 0
    emit("resetup_dfg_phase", elapsed_phase_s=time.perf_counter() - t_phase)

    # ---- small: the card against the CPU after two resetups
    t_phase = time.perf_counter()
    for case in ("headline16", "config4"):
        got = {}
        for where in ("cuda", "cpu"):
            if case == "headline16":
                A = poisson7pt(16, 16, 16)
                m = amgx.Matrix(A, device=where)
                cfg = HEADLINE_CFG + reuse
            else:
                A = spe10_block_system(12, 12, 12)
                m = amgx.Matrix(A, block_dim=4, device=where)
                cfg = CFG4
            m.device_dtype = np.float32
            s_ = amgx.create_solver(cfg)
            s_.setup(m)
            host0 = m.host.copy()
            steps = []
            for k in range(RESETUP_STEPS):
                if k:
                    m.replace_coefficients(drift_values(host0, k))
                    s_.resetup(m)
                r = s_.solve(np.ones(A.shape[0]))
                assert r.status == amgx.SolveStatus.SUCCESS, (case, where)
                steps.append((r.iterations, r.x.cpu()))
            got[where] = steps
        iters = [(g[0], c[0]) for g, c in zip(got["cuda"], got["cpu"])]
        bit_equal = all(torch.equal(g[1], c[1])
                        for g, c in zip(got["cuda"], got["cpu"]))
        emit("resetup_card_vs_cpu", case=case, iterations=iters,
             x_bit_equal=bit_equal)
        assert all(a == b_ for a, b_ in iters), (case, iters)
        assert bit_equal, case

    # a structural change: a block matrix handed to a DIA hierarchy
    m = amgx.Matrix(poisson7pt(10, 10, 10), device="cuda")
    s_ = amgx.create_solver(HEADLINE_CFG + reuse)
    s_.setup(m)
    B = sp.kron(poisson7pt(5, 5, 5), sp.identity(2)).tocsr()
    try:
        s_.resetup(amgx.Matrix(B, block_dim=2, device="cuda"))
        raised = None
    except BadConfigurationError as e:
        raised = str(e)
    assert raised is not None, "a block matrix resetup did not raise"
    emit("resetup_structural_change", raised=raised,
         elapsed_phase_s=time.perf_counter() - t_phase)
    return out


class GalerkinTimer:
    """The seconds spent in the hierarchy's Galerkin products (classical
    and aggregation, engine or scipy) while it is entered."""

    def __enter__(self):
        from amgx_tpu_torch.amg import hierarchy as H
        self.H = H
        self.seconds = 0.0
        self.real = {}
        for name in ("_galerkin_classical", "_galerkin_agg"):
            real = getattr(H.AMGHierarchy, name)
            self.real[name] = real

            def timed(hier, *a, _real=real, **k):
                t0 = time.perf_counter()
                out = _real(hier, *a, **k)
                self.seconds += time.perf_counter() - t0
                return out
            setattr(H.AMGHierarchy, name, timed)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.H.AMGHierarchy, name, real)


def block_aggregation_phase(amgx, dev, smi, gen,
                            engine_off: bool = False) -> dict:
    """Phase 30: block aggregation (``BLOCK_CFG`` on
    ``elasticity3(BLOCK_SIDE)``, f32 pack, f64 refinement): setup with
    the device setup engine (``device_setup=1``; with ``engine_off``,
    which ``scripts/torch_setup_engine.py`` sets, a setup without it
    first), the engine's plans, hits and declines (only "small"
    allowed), a first and a warm solve with every count set to 0 just
    before the first and read just after, iterations, the true relres in f64 on the host, the
    levels and their dispatch labels (no decline), the AMG graph
    (:func:`graph_check`), peak memory; then a values-only resetup (A5:
    the frozen aggregates replayed through the engine's cached block
    plans, the graphs kept) and a solve; then the card against the CPU
    at ``BLOCK_SMALL_SIDE`` with the engine on every level (equal
    counts, x bit-equal).  Returns the launches by kernel."""
    import torch
    from amgx_tpu_torch.amg.device_setup import engine_stats, reset_engine
    from amgx_tpu_torch.core.matrix import pack_kind
    from amgx_tpu_torch.io.gauntlet import elasticity3
    from amgx_tpu_torch.utils import cuda_graph as cg
    t_phase = time.perf_counter()
    A, b = elasticity3(BLOCK_SIDE)
    n = A.shape[0]
    cfg = BLOCK_CFG + ", amg:structure_reuse_levels=-1"
    setup_s, galerkin_s = {}, {}
    for ds in ((0, 1) if engine_off else (1,)):
        reset_engine()
        torch.cuda.reset_peak_memory_stats(dev)
        m = amgx.Matrix(A, block_dim=b, device="cuda")
        m.device_dtype = np.float32
        torch.cuda.synchronize(dev)
        with GalerkinTimer() as gt:
            t0 = time.perf_counter()
            slv = amgx.create_solver(cfg + f", device_setup={ds}")
            slv.setup(m)
            torch.cuda.synchronize(dev)
            setup_s[ds] = time.perf_counter() - t0
        galerkin_s[ds] = gt.seconds
        if ds == 0:
            assert engine_stats() is None
            del slv, m
            torch.cuda.empty_cache()
    stats = engine_stats()
    assert set(stats["declines"]) <= {"small"}, stats
    assert stats["numeric_runs"] >= 1, stats
    pre = amg_of(slv)
    h = pre.hierarchy
    rhs = torch.ones(n, dtype=torch.float64, device=dev)
    reset_counts()
    res = slv.solve(rhs)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    total = {}
    merge_counts(total, counts)
    res2 = slv.solve(rhs)
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    assert not any(counts["declines"].values()), counts
    relres = host_relres(A)(res.x)
    assert relres <= 1e-8, relres
    levels = [dict(block_rows=lv.level_stats()[0], kind=pack_kind(lv.Ad))
              for lv in h.levels]
    levels.append(dict(block_rows=h.coarsest.n_block_rows,
                       kind=pack_kind(h.coarsest.device()),
                       solver="DENSE_LU_SOLVER"))
    # a coarse level whose block plan passes the binned padding budget
    # packs as the scalar expansion's planes (B4), the JAX package's rule
    assert levels[0]["kind"] == "dia/block", levels
    assert all(lv["kind"] in ("dia/block", "ell/binned-block",
                              "ell/binned") for lv in levels[:-1]), levels
    assert counts["B5"].get("f32.f32", 0) > 0, counts
    graph = graph_check(pre, dev, gen)
    emit("block_aggregation", side=BLOCK_SIDE, block_dim=b,
         block_rows=n // b, unknowns=n, stored_blocks=int(A.nnz // b // b),
         setup_s_engine=setup_s[1], setup_s_no_engine=setup_s.get(0),
         galerkin_s_engine=galerkin_s[1],
         galerkin_s_no_engine=galerkin_s.get(0),
         engine=stats, iterations=res.iterations, relres_f64=relres,
         solve_s=res.solve_time, solve_warm_s=res2.solve_time,
         levels=levels, counts=counts, amg_graph=graph,
         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=smi)

    # ---- A5: a values-only resetup, the graphs kept
    host0 = m.host.copy()
    Ak = host0.copy()
    Ak.data = drift_values(host0, 1)
    with GalerkinTimer() as gt:
        t0 = time.perf_counter()
        m.replace_coefficients(Ak.data)
        slv.resetup(m)
        torch.cuda.synchronize(dev)
        resetup_s = time.perf_counter() - t0
    assert h.last_resetup == "host_replay", h.last_resetup
    assert pre.rebind["graphs_dropped"] == 0, pre.rebind
    st1 = engine_stats()
    assert st1["builds"] == stats["builds"], (stats, st1)
    caps = cg.CAPTURES["count"]
    reset_counts()
    res3 = slv.solve(rhs)
    torch.cuda.synchronize(dev)
    counts3 = read_counts()
    merge_counts(total, counts3)
    assert cg.CAPTURES["count"] == caps
    assert res3.status == amgx.SolveStatus.SUCCESS, res3.status
    relres3 = host_relres(Ak)(res3.x)
    assert relres3 <= 1e-8, relres3
    graph3 = graph_check(pre, dev, gen)
    emit("block_aggregation_resetup", path=h.last_resetup,
         resetup_s=resetup_s, galerkin_s=gt.seconds,
         setup_s_engine=setup_s[1],
         engine_hits=st1["hits"] - stats["hits"],
         engine_builds=st1["builds"] - stats["builds"],
         graphs_kept=pre.rebind["graphs_kept"],
         graphs_dropped=pre.rebind["graphs_dropped"],
         first_solve_s=res3.solve_time, iterations=res3.iterations,
         relres_f64=relres3, counts=counts3, amg_graph=graph3, card=smi)
    del slv, pre, h, m, res, res2, res3, A, Ak, host0
    torch.cuda.empty_cache()

    # ---- the card against the CPU, the engine on every level
    As, _ = elasticity3(BLOCK_SMALL_SIDE)

    def make(where):
        ms = amgx.Matrix(As, block_dim=b, device=where)
        ms.device_dtype = np.float32
        return ms

    facts = small_card_vs_cpu(amgx, f"elasticity3_{BLOCK_SMALL_SIDE}",
                              BLOCK_CFG + ", device_setup_min_rows=0",
                              make, As.shape[0])
    assert facts["x_bit_equal"], facts
    emit("block_aggregation_phase",
         elapsed_phase_s=time.perf_counter() - t_phase)
    return total


def classical_algorithm_phase(amgx, dev, smi, gen,
                              engine_off: bool = False) -> dict:
    """Phase 31: the classical setup algorithms of this slice.  At full
    width the classical 128³ stack with ``aggressive_levels=1``
    (``CLA_AGGR_CFG``, f32 pack, f64 refinement; the device pipeline
    declines, so every level runs the host loop: AGGRESSIVE_PMIS +
    MULTIPASS on level 0, PMIS + D2 below): setup with the engine on and
    (with ``engine_off``, as in :func:`block_aggregation_phase`) off,
    with the Galerkin products' share of each, the engine's counts,
    a first and a warm solve with every count set to 0 just before the
    first and read just after, iterations, the true relres in f64 on the
    host, B1/B3 launches, the AMG graph (:func:`graph_check`), and one
    engine product of level 1 in f64 on the card against scipy's.  Then
    the card against the CPU at ``FAMILY_CLA_SIDE``³ (θ = 0.2401) for
    each name of ``CLA_NAMES``, and ``error_scaling=2`` on the headline
    at 16³ with its graph replay bit-equal to an eager application.
    Returns the launches by kernel."""
    import scipy.sparse as sp
    import torch
    from amgx_tpu_torch.amg.device_setup import (DeviceSetupEngine,
                                                 engine_stats, reset_engine)
    from amgx_tpu_torch.io import poisson7pt, poisson7pt_device
    t_phase = time.perf_counter()
    side = FAMILY_SIDE
    A = poisson7pt(side, side, side)
    setup_s, share = {}, {}
    for ds in ((0, 1) if engine_off else (1,)):
        reset_engine()
        m = amgx.Matrix(A, device="cuda")
        m.device_dtype = np.float32
        torch.cuda.synchronize(dev)
        with GalerkinTimer() as gt:
            t0 = time.perf_counter()
            slv = amgx.create_solver(CLA_AGGR_CFG + f", device_setup={ds}")
            slv.setup(m)
            torch.cuda.synchronize(dev)
            setup_s[ds] = time.perf_counter() - t0
        share[ds] = dict(galerkin_s=gt.seconds,
                         share=gt.seconds / setup_s[ds])
        if ds == 0:
            del slv, m
            torch.cuda.empty_cache()
    stats = engine_stats()
    h = amg_of(slv).hierarchy
    kinds = [s_[0] for s_ in h._structure]
    assert kinds and all(k == "classical" for k in kinds), kinds
    rhs = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    reset_counts()
    res = slv.solve(rhs)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    total = {}
    merge_counts(total, counts)
    res2 = slv.solve(rhs)
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    assert not any(counts["declines"].values()), counts
    relres = host_relres(A)(res.x)
    assert relres <= 1e-8, relres
    assert counts["B1"]["f32.f32"] > 0 and counts["B3"]["f32.f32"] > 0, \
        counts
    graph = graph_check(amg_of(slv), dev, gen)
    # one engine product of level 1 on the card, f64, against scipy
    A1 = sp.csr_matrix(h.levels[1].A.host).astype(np.float64)
    P1 = sp.csr_matrix(h._structure[1][1][0]).astype(np.float64)
    t0 = time.perf_counter()
    got = DeviceSetupEngine().galerkin_csr(A1, P1, dtype=np.float64,
                                           device=dev)
    engine_l1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = sp.csr_matrix(sp.csr_matrix(P1.T) @ A1 @ P1)
    scipy_l1_s = time.perf_counter() - t0
    l1_err = abs(got - ref).max() / abs(ref).max()
    assert l1_err <= 1e-12, l1_err
    emit("classical_aggressive", n=A.shape[0], config="aggressive_levels=1",
         setup_s_engine=setup_s[1], setup_s_no_engine=setup_s.get(0),
         galerkin_engine=share[1], galerkin_no_engine=share.get(0),
         engine=stats, levels=level_table(h), iterations=res.iterations,
         relres_f64=relres, solve_s=res.solve_time,
         solve_warm_s=res2.solve_time, counts=counts, amg_graph=graph,
         level1=dict(rows=A1.shape[0], nnz=A1.nnz, P_nnz=P1.nnz,
                     Ac_nnz=ref.nnz, engine_s=engine_l1_s,
                     scipy_s=scipy_l1_s, rel_err_vs_scipy=l1_err,
                     limit=1e-12), card=smi)
    del slv, h, m, res, res2, A, A1, P1, got, ref
    torch.cuda.empty_cache()

    # ---- the card against the CPU for each name
    small = FAMILY_CLA_SIDE
    As = poisson7pt(small, small, small)
    base = CFG_CLA + ", amg:strength_threshold=0.2401"

    def make(where):
        ms = amgx.Matrix(As, device=where)
        ms.device_dtype = np.float32
        return ms

    names = {}
    for name, (old, new) in CLA_NAMES.items():
        assert old in base, name
        facts = small_card_vs_cpu(amgx, f"classical_{name}",
                                  base.replace(old, new), make,
                                  As.shape[0])
        names[name] = [facts["iterations_card"], facts["x_bit_equal"]]
    # error_scaling=2 on the headline at 16³: counts and the graph
    cfg = HEADLINE_CFG + ", amg:error_scaling=2"
    out = {}
    for where in ("cuda", "cpu"):
        As16 = poisson7pt_device(16, 16, 16, device_dtype=np.float32,
                                 device=where)
        s_ = amgx.create_solver(cfg)
        s_.setup(As16)
        rr = s_.solve(np.ones(16 ** 3))
        assert rr.status == amgx.SolveStatus.SUCCESS, where
        out[where] = (rr.iterations, rr.x.cpu())
        if where == "cuda":
            scaled_graph = graph_check(amg_of(s_), dev, gen)
    assert out["cuda"][0] == out["cpu"][0], out
    emit("classical_algorithms_card_vs_cpu", side=small, names=names,
         error_scaling_16=dict(iterations=out["cuda"][0],
                               x_bit_equal=bool(torch.equal(
                                   out["cuda"][1], out["cpu"][1])),
                               amg_graph=scaled_graph),
         elapsed_phase_s=time.perf_counter() - t_phase)
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import amgx_tpu_torch as amgx

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

    # the CPU half of phase 23 (started there; stopped here on any exit)
    cpu_ref = CpuReference()
    try:
        return run_phases(amgx, dev, smi, kind, cpu_ref)
    finally:
        cpu_ref.stop()


def run_phases(amgx, dev, smi, kind, cpu_ref) -> int:
    import numpy as np
    import torch
    from amgx_tpu_torch import native
    from amgx_tpu_torch.amg.dia_device import (derive_hierarchy_device,
                                               plan_dia_hierarchy)
    from amgx_tpu_torch.io import poisson7pt_device
    from amgx_tpu_torch import device as dvmod
    from amgx_tpu_torch.io import poisson7pt
    from amgx_tpu_torch.ops import dia_spmv as dmod
    from amgx_tpu_torch.ops import ell_spmv as emod
    from amgx_tpu_torch.ops import spmv as smod

    # ---- 2. build the four kernel sources, one nvcc each, started
    # together
    t0 = time.perf_counter()
    sources = ("dia_spmv", "ell_spmv", "binned_spmv", "shift_spmv")
    native.build_all(sources)
    build_s = time.perf_counter() - t0
    for name in sources:
        log = native.BUILD_LOG.get(name, {}).get("log", "")
        emit("build", source=f"amgx_tpu_torch/csrc/{name}.cu",
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
    ell_errs = {}
    dmod.reset_launches()
    emod.reset_launches()
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
    # no ELL operator on this path: B3 serves only the dense coarse
    # solve (one ordered product with the coarse inverse)
    assert dispatch["ell/window"] == 0 and dispatch["ell/shift"] == 0
    head_b3 = dict(emod.LAUNCHES)
    # a second, warm solve for the steady-state time (not counted)
    res2 = slv.solve(b)
    head_graph = graph_check(slv.preconditioner, dev, gen)
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
    check_coarse_inverse(dev, gen, "headline.coarse_inverse", h, ell_errs)
    emit("main_path", n=n, iterations=res.iterations, relres=relres,
         setup_s=setup_s, solve_s=res.solve_time,
         solve_warm_s=res2.solve_time,
         levels=[lv.Ad.n_rows for lv in h.levels]
         + [h.coarsest.n_block_rows],
         launches_per_solve=sum(launches.values()),
         launches_by_type=launches, dispatch=dispatch,
         amg_graph=head_graph, card=smi)

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
    # the card's preconditioner ran as graph replays, the CPU's eagerly
    assert torch.equal(xg, xc), "16³ headline: card x differs from CPU x"
    emit("small_reference", n=16 ** 3, iterations=SMALL_ITERS,
         x_rel_diff_card_vs_cpu=agree, x_bit_equal=True)

    # ---- 5b. an AMG nested in the graphed AMG (its coarse solver)
    nested = nested_phase(amgx, dev, gen, smi)

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
    wall, device_s, kern, top = profile_window(lambda: slv.solve(b))
    emit("profile", profiled_wall_s=wall, unprofiled_wall_s=res2.solve_time,
         device_time_measured=kern > 0, device_busy_s=device_s,
         device_kernels=kern,
         busy_share_of_unprofiled=device_s / res2.solve_time, top=top,
         card=smi)

    del slv, res, res2, x, r, A, Ad64, outs_card, outs_cpu, fine
    torch.cuda.empty_cache()

    # ---- 8. the classical path: 128³ CFG_CLA solve
    Ahost = poisson7pt(side, side, side)
    dmod.reset_launches()
    emod.reset_launches()
    smod.reset_dispatch()
    dvmod.HOST_SYNCS["count"] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    Ac = amgx.Matrix(Ahost, device="cuda")
    Ac.device_dtype = np.float32
    cslv = amgx.create_solver(CFG_CLA)
    cslv.setup(Ac)
    cla_setup_s = time.perf_counter() - t0
    setup_syncs = dvmod.HOST_SYNCS["count"]
    cres = cslv.solve(b)
    torch.cuda.synchronize(dev)
    c_launches = {"dia_spmv": dict(dmod.LAUNCHES),
                  "ell_spmv": dict(emod.LAUNCHES)}
    c_dispatch = dict(smod.DISPATCH)
    cres2 = cslv.solve(b)
    cla_graph = graph_check(cslv.preconditioner, dev, gen)
    assert cres.status == amgx.SolveStatus.SUCCESS, cres.status
    assert cres2.iterations == cres.iterations
    assert c_dispatch["ell/window"] > 0 and c_dispatch["ell/gather"] == 0 \
        and c_dispatch["dia/kernel"] > 0 and c_dispatch["dia/slices"] == 0, \
        c_dispatch
    assert c_launches["ell_spmv"]["f32.f32"] > 0, c_launches
    assert all(c_launches["dia_spmv"][k] > 0 for k in ("f32.f32",
                                                       "f64.f64"))
    cx = cres.x
    assert cx.dtype == torch.float64 and cx.shape == (n,) and cx.is_cuda
    assert torch.isfinite(cx).all().item()
    Ad64 = Ac.device().astype(torch.float64)
    r = b - dmod.dia_spmv(Ad64.vals, cx, Ad64.dia_offsets)
    c_relres = (torch.linalg.vector_norm(r)
                / torch.linalg.vector_norm(b)).item()
    assert c_relres <= 1e-8, c_relres
    ch = cslv.preconditioner.hierarchy
    cd = ch.coarsest.device()
    table = level_table(ch)
    assert [f for f, _, _ in table[:3]] == ["dia", "dia3", "ell"], table
    emit("classical_path", n=n, iterations=cres.iterations,
         relres=c_relres, setup_s=cla_setup_s, solve_s=cres.solve_time,
         solve_warm_s=cres2.solve_time,
         levels=[dict(fmt=f, rows=r_, stored_rows=s_)
                 for f, r_, s_ in table],
         dispatch=c_dispatch, launches_per_solve=c_launches,
         amg_graph=cla_graph, host_syncs_in_setup=setup_syncs,
         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=smi)

    # ---- 9. B1 vs plain on every DIA pack of that hierarchy (the fine
    # A, the embedded P₀/R₀ — which are also the dia3 streams of level
    # 1 — and a DIA coarsest), in the pairs the path runs: (f32, f32) in
    # the cycle, (f64, f64) in the refinement's residuals
    dia_packs = {}
    for i, lv in enumerate(ch.levels):
        roles = [("A", lv.Ad), ("P", lv.P), ("R", lv.R)]
        if lv.Ad.fmt == "dia3":
            roles = [(f"A.dia3.{r}", getattr(lv.Ad, r)) for r in "PAR"] \
                + roles[1:]
        for role, M in roles:
            if M.fmt == "dia":
                dia_packs.setdefault(id(M), (M, []))[1].append(
                    f"level{i}.{role}")
    if cd.fmt == "dia":
        dia_packs.setdefault(id(cd), (cd, []))[1].append("coarsest")
    for M, names in dia_packs.values():
        check_kernel(dev, gen, "=".join(names), M.vals.double(),
                     M.dia_offsets, ((torch.float32, torch.float32),
                                     (torch.float64, torch.float64)), errs)

    # ---- 9c. B1 times on the dia3 level's three streams
    dia3_timing = dia3_streams(cslv, dev, gen, smi, b)

    # ---- 9b. B3 vs plain on every ELL pack of that hierarchy and its
    # dense coarse inverse, both pairs
    check_coarse_inverse(dev, gen, "classical.coarse_inverse", ch, ell_errs)
    packs = []
    for i, lv in enumerate(ch.levels):
        for role, M in (("A", lv.Ad), ("P", lv.P), ("R", lv.R)):
            if M.fmt == "ell":
                packs.append((f"level{i}.{role}", M))
    if cd.fmt == "ell":
        packs.append(("coarsest", cd))
    assert packs
    for name, M in packs:
        check_ell(dev, gen, name, M.cols, M.vals.double(), M.n_cols,
                  ell_errs, row_len=M.row_len)
    for K, n_r, n_c in ((4, 50000, 70001), (27, 30000, 20000),
                        (256, 4096, 9000)):
        cols = torch.randint(-2, n_c + 2, (n_r, K), dtype=torch.int32,
                             device=dev, generator=gen)
        vals = torch.randn((n_r, K), dtype=torch.float64, device=dev,
                           generator=gen)
        check_ell(dev, gen, f"random_K{K}", cols, vals, n_c, ell_errs)
        # the same rows cut short at random lengths (zeros inside
        # too): B3 stops each row at its row_len
        keep = torch.randint(0, K + 1, (n_r, 1), device=dev, generator=gen)
        ragged = torch.where(torch.arange(K, device=dev) < keep, vals, 0)
        ragged[::7, 0] = 0
        check_ell(dev, gen, f"random_K{K}_ragged", cols, ragged, n_c,
                  ell_errs, row_len=emod.ell_row_len(ragged))
    if not any(M.n_rows < 128 for _, M in packs):
        cols = torch.randint(0, 100, (100, 9), dtype=torch.int32,
                             device=dev, generator=gen)
        vals = torch.randn((100, 9), dtype=torch.float64, device=dev,
                           generator=gen)
        check_ell(dev, gen, "small_level_100", cols, vals, 100, ell_errs,
                  row_len=emod.ell_row_len(vals))

    # ---- 10. B3 times on the largest ELL operator of the hierarchy
    big_name, big = max(((nm, M) for nm, M in packs
                         if nm.endswith(".A") or nm == "coarsest"),
                        key=lambda p: p[1].cols.numel())
    ell_timing = {}
    nb_, K_ = big.cols.shape
    for dt in (torch.float32, torch.float64):
        vals = big.vals.to(dt).contiguous()
        x = torch.randn(big.n_cols, dtype=dt, device=dev, generator=gen)
        csr = csr_of_ell(big.cols, vals, big.n_cols)
        ms = time_ms(lambda: emod.ell_spmv(big.cols, vals, x, big.row_len),
                     dev)
        # the same kernel without row_len: every row read to K
        full_ms = time_ms(lambda: emod.ell_spmv(big.cols, vals, x), dev)
        plain_ms = time_ms(lambda: emod.ell_spmv_reference(big.cols, vals,
                                                           x), dev)
        library_ms = time_ms(lambda: csr @ x, dev)
        # the sparse product needs only the nonzero entries: the bound
        # counts those; the padded pack's own bytes are reported beside
        nnz = int((vals != 0).sum().item())
        bound_ms, bound_by = ell_bound(nnz, nb_, big.n_cols, dt)
        pack_bound_ms, _ = ell_bound(nb_ * K_, nb_, big.n_cols, dt)
        key = f"{short(dt)}.{short(dt)}"
        ell_timing[key] = dict(ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
        emit("ell_timing", operator=big_name, n=nb_, K=K_,
             n_cols=big.n_cols, type=short(dt), card=smi, nnz=nnz,
             row_len_mean=big.row_len.double().mean().item(),
             full_rows_ms=full_ms, pack_bound_ms=pack_bound_ms,
             **ell_timing[key],
             pack_gbs=(nb_ * K_ * (4 + dt.itemsize)
                       + (big.n_cols + nb_) * dt.itemsize)
             / (ms * 1e-3) / 1e9)
        del csr

    # ---- 11. 24³ at θ = 0.2401: the card against the CPU
    cfg_tf = CFG_CLA + ", amg:strength_threshold=0.2401"
    small_c = {}
    for where in ("cuda", "cpu"):
        m = amgx.Matrix(poisson7pt(24, 24, 24), device=where)
        m.device_dtype = np.float32
        s_ = amgx.create_solver(cfg_tf)
        s_.setup(m)
        rr = s_.solve(np.ones(24 ** 3))
        small_c[where] = (level_table(s_.preconditioner.hierarchy),
                          rr.iterations, rr.x.cpu())
    tg, tc = small_c["cuda"][0], small_c["cpu"][0]
    assert tg == tc, (tg, tc)
    assert small_c["cuda"][1] == small_c["cpu"][1], \
        (small_c["cuda"][1], small_c["cpu"][1])
    xg, xc = small_c["cuda"][2], small_c["cpu"][2]
    x_diff = ((xg - xc).norm() / xc.norm()).item()
    assert x_diff < SMALL_X_RTOL, x_diff
    emit("classical_small_reference", n=24 ** 3, levels=tg,
         iterations=small_c["cuda"][1], x_rel_diff_card_vs_cpu=x_diff,
         limit=SMALL_X_RTOL)

    # ---- 12. where a classical setup and a warm classical solve go
    def resetup():
        m = amgx.Matrix(Ahost, device="cuda")
        m.device_dtype = np.float32
        amgx.create_solver(CFG_CLA).setup(m)
        torch.cuda.synchronize(dev)

    wall, dev_s, kern, top = profile_window(resetup)
    emit("classical_setup_profile", profiled_wall_s=wall,
         device_busy_s=dev_s, device_kernels=kern, top=top, card=smi)
    wall, dev_s, kern, top = profile_window(lambda: cslv.solve(b))
    emit("classical_solve_profile", profiled_wall_s=wall,
         unprofiled_wall_s=cres2.solve_time, device_busy_s=dev_s,
         device_kernels=kern,
         busy_share_of_unprofiled=dev_s / cres2.solve_time, top=top,
         card=smi)

    del cslv, cres, cres2, cx, Ac, Ahost, ch, cd, packs, big
    torch.cuda.empty_cache()

    # ---- 13.-18. the config-4 path
    c4 = config4_phases(amgx, dev, smi, gen, errs)

    # ---- 19.-23. the DFG cylinder path (aggregation AMG, B2)
    dfg = dfg_phases(amgx, dev, smi, gen, cpu_ref, ell_errs)

    # ---- 24.-28. the solver names of this slice
    fam = family_phases(amgx, dev, smi, gen)

    # ---- 29. values-only resetup on the three AMG paths
    fam.update(resetup_phases(amgx, dev, smi, gen))

    # ---- 30. block aggregation; 31. the classical setup
    # algorithms
    setup_paths = {
        "block_aggregation": block_aggregation_phase(amgx, dev, smi, gen),
        "classical_aggressive": classical_algorithm_phase(amgx, dev, smi,
                                                          gen)}

    # ---- the kernels of the paths
    kernels = []
    for key in ("f32.f32", "f64.f64"):
        v, xx = key.split(".")
        kernels.append(dict(
            name=f"dia_spmv<{v},{xx}>", route="cuda",
            source="amgx_tpu_torch/csrc/dia_spmv.cu",
            replaces="amgx_tpu/ops/pallas_spmv.py:101",
            launches=launches[key] + c_launches["dia_spmv"][key]
            + c4["b1_launches"][key] + nested["B1"][key],
            launches_by_path=dict(headline=launches[key],
                                  classical=c_launches["dia_spmv"][key],
                                  config4_16=c4["b1_launches"][key],
                                  nested_amg_16=nested["B1"][key]),
            max_abs_err=errs[key]["abs"], max_row_rel_err=errs[key]["rel"],
            block_dia_16=c4["b1_block_dia_errs"][key],
            dia3_streams_f32=dia3_timing if key == "f32.f32" else None,
            ms=timing[key]["ms"], plain_ms=timing[key]["plain_ms"],
            bound_ms=timing[key]["bound_ms"],
            bound_by=timing[key]["bound_by"],
            library_ms=timing[key]["library_ms"]))
    # B3 in f64: the classical resetup path runs an f64 pack (phase 29)
    for key in ("f32.f32", "f64.f64"):
        v, xx = key.split(".")
        kernels.append(dict(
            name=f"ell_spmv<{v},{xx}>", route="cuda",
            source="amgx_tpu_torch/csrc/ell_spmv.cu",
            replaces="amgx_tpu/ops/pallas_ell.py:209",
            launches=head_b3[key] + c_launches["ell_spmv"][key]
            + dfg["b3_launches"][key] + dfg["b3_launches_full_depth"][key]
            + nested["B3"][key],
            launches_by_path=dict(
                headline=head_b3[key],
                classical=c_launches["ell_spmv"][key],
                nested_amg_16=nested["B3"][key],
                dfg=dfg["b3_launches"][key],
                dfg_full_depth=dfg["b3_launches_full_depth"][key]),
            max_abs_err=ell_errs[key]["abs"],
            max_row_rel_err=ell_errs[key]["rel"], ms=ell_timing[key]["ms"],
            plain_ms=ell_timing[key]["plain_ms"],
            bound_ms=ell_timing[key]["bound_ms"],
            bound_by=ell_timing[key]["bound_by"],
            library_ms=ell_timing[key]["library_ms"]))
    kernels.extend(c4["kernels"])
    kernels.extend(dfg["kernels"])
    # the launches of phases 24-27's and 29-31's full-width stacks, by
    # kernel
    paths = {(p if p.startswith("resetup_") else f"family_{p}"): t
             for p, t in fam.items()}
    paths.update(setup_paths)
    for entry in kernels:
        kern = {"dia_spmv": "B1", "ell_spmv": "B3", "shift_spmv": "B2",
                "binned_spmv_B5": "B5", "binned_spmv_B4": "B4"}[
                    entry["name"].split("<")[0]]
        pair = ".".join(entry["name"].split("<")[1].rstrip(">")
                        .split(",")[:2])
        for path, tot in paths.items():
            n_ = tot.get(kern, {}).get(pair, 0)
            entry["launches_by_path"][path] = n_
            entry["launches"] += n_
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--cpu-reference":
        sys.exit(cpu_reference(sys.argv[2], sys.argv[3]))
    sys.exit(main())

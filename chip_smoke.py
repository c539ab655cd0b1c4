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
    within ``SMALL_X_RTOL`` and bit-equal (every sum of the stack, its
    setup's row sums included, runs in one order on both devices);
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
    ``DFG_LEVELS`` levels; phase 22 runs it deeper;
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
22. the DFG operator at ny = 512 under the headline config at
    ``DFG_DEEP_LEVELS`` (13) of its own 15 levels (cut for time; the
    config's own depth, down to a 28-row coarse solve, is
    ``scripts/torch_dfg_depth.py``'s): setup; the full solve (its first application captures the
    graph, the others replay it), iterations, the true relres in f64,
    the AMG graph (:func:`graph_check`), B3 bit for bit on the ELL
    levels from phase 19's dense coarsest level down;
23. the same stack at ny = 320 (544,649 rows, 67 shift tiles), cut at
    ``DFG_SMALL_LEVELS`` (9) levels, on the card against the CPU, f32
    pack and f64 pack: equal
    iterations, x bit-equal with the f32 pack.  The CPU solves run in
    two child processes (one per pack dtype, the f64 one given the odd
    core) started at phase 22, after the last kernel timing but phase
    40's and 41d's, so phase 22 (whose replays keep the device busy)
    runs beside them and no kernel timing does; phase 44 runs beside
    them too, after phase 23's card solves, where the card process would
    otherwise wait for them.

24. the solver family on the classical 128³ stack (``CFG_CLA``, f32
    pack, f64 refinement): the outer solver replaced by GMRES, PCGF,
    PCG_PIPE and PCG_CA (these two on an f64 pack, ``FAMILY_PACK``,
    their f32 runs printed beside), then PCG with the smoother
    CF_JACOBI (the C/F split of the classical levels) at 96³
    (``CF_JACOBI_SIDE``: its setup runs the host loop); each through the
    public API with
    every count set to 0 just before the first solve and read just
    after: iterations, the true relres in f64, setup, first and warm
    solve, launches by kernel, the AMG graph (:func:`graph_check`) and
    the device's busy share of a warm solve;
25. the headline 128³ with CHEBYSHEV_POLY as its smoother (the power
    iteration at setup through B1, the graph replaying the smoother),
    and CHEBYSHEV without a preconditioner at 128³ for ``CHEB_ITERS``
    iterations, with the relres it reaches;
26. config 4's SPE10 system cut to ``FAMILY_C4_GRID`` (30 × 110 × 43,
    for time), uploaded once: IDR + MULTICOLOR_DILU and PBICGSTAB +
    MULTICOLOR_GS (4×4 block slabs), both on B5;
27. PBICGSTAB + MULTICOLOR_ILU(0) on the DFG operator at ``ILU_NY``;
28. the card against the CPU for every solver name of this slice (and
    PCG with ``krylov_comm`` CA and PIPELINED) on small systems: equal
    iterations, x within ``SMALL_X_RTOL`` and bit-equal;
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
    ``elasticity3(BLOCK_SIDE)`` (80: 512,000 block rows, 1,536,000
    unknowns, cut from 96 for time; f32 pack, f64 refinement): setup
    with the device setup
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
    replay bit-equal to an eager application);
32. the precision paths: the headline 128³ and the classical
    ``PREC_CLA_SIDE``³ (64³) with ``hierarchy_dtype=bfloat16`` (every
    level but the coarsest narrowed; f32 Krylov pack, f64 refinement to
    1e-8): counts set to 0 just before the first solve and read just
    after (B1's and B3's (bf16, f32) pairs launched), the true relres,
    the AMG graph, each bf16 pack's kernel against its plain version bit
    for bit, the pairs' single-launch times; the headline at 24³ card
    against CPU; and, inside the config-4 phases, ``tpu_matrix_dtype=
    bfloat16`` on phase 13's uploaded matrix (a precision view, the
    pack cast on the card; B5's (bf16, f32) pair; the bf16 → f32 rung
    to ``C4_BF16_TOL``, as far as a bf16 pack's ladder reaches);
33. equation scaling (NBINORMALIZATION, DIAGONAL_SYMMETRIC) on the
    classical 64³ (f64 pack) and ``matrix_reorder=RCM`` on a 64³
    Poisson permuted at random: iterations, the caller's true relres,
    counts; each at 24³ card against CPU (equal counts, x bit-equal);
34. faults and recovery: ``values_nan`` once on the headline 128³ with
    ``recovery_policy=AUTO`` (``nan_poison``, the ``restart`` rung
    recovers, the AMG graph replayed, not captured again);
    ``krylov_zero`` on the classical 64³ (``krylov_breakdown``);
    ``setup_error``, ``upload_error`` and ``oom`` raise with the JAX
    package's codes; a fault on every solve stops the ladder at
    ``recovery_max_attempts``;
35. host levels: the headline 128³ with ``amg_host_levels_rows=4096``
    (levels of 4096, 512, 64 and 8 rows on the CPU, the graph cut into
    segments around each entry into them) against the all-card run:
    equal iterations, x bit-equal, segment, host-step and node counts,
    warm solves.

36.-39. the modes and complex solves, the implicit operators and
    ``solve_multi``, the eigensolvers, binary IO and fmt ``dense``
    (each function's docstring says what it checks);
40. distribution on one card: (40a) the 96³ Poisson of
    ``generate_distributed_poisson_7pt(48, 48, 48, 2, 2, 2)`` (cut from
    128³ for time) in 8
    shards on the card, f64 pack, under ``DIST_CFG`` (FGMRES(20) +
    SIZE_2 aggregation, BLOCK_JACOBI 1+2, DENSE_LU) to 1e-8, its counts
    set to 0 just before the first solve and read just after: every
    SpMV of a sharded level ``sharded/window`` (the halo exchange and
    one B3 launch over the stacked interior), none ``sharded/gather``;
    setup, first and warm solve, the busy share of a warm solve, the
    levels with their active ranks, level 0's halo entries a SpMV, the
    AMG graph (:func:`graph_check`); B3 on the stacked 96³ interior bit
    for bit against its plain version in f32 and f64 and timed, with a
    copy-rate bound beside the datasheet one; (40b) the same stack at
    64³ under the legacy consolidation thresholds and under the
    agglomeration planner (sub-meshes, then a replicated level); (40c)
    16³ card against CPU (f32: equal counts, x bit-equal; f64: x to
    1e-9) and sharded PCG against one unsharded card (x to 1e-8);
41. item 8b: (41a) BASELINE config 4 on phase 13's SPE10-grid system
    (reused) in 8 equal block-row shards, an f64 pack of 4×4 blocks,
    ``CFG4`` to 1e-8, counts set to 0 just before the first solve and
    read just after: every SpMV ``sharded/block-binned`` (the halo
    exchange of block values, one B5 launch over the stacked block
    interior, the boundary blocks), no DILU apply making a halo
    exchange, iterations beside phase 13's, setup, first and warm
    solve, busy share, peak memory, halo blocks a SpMV; (41d) B5 over
    that stacked interior bit for bit against
    ``binned_compact_reference`` in f32 and f64 and timed against its
    bound, the copy-rate bound and cuSPARSE BSR of the same blocks;
    (41b) BASELINE config 2 (``CFG_CLA``) on the 96³ Poisson in 8
    shards, f64 pack: every level ``classical-dist`` (per-rank
    strength, PMIS, D2, RAP through the engine's shard-local form), no
    global assembly above n/4 rows, the setup's split, the AMG graph,
    B3 launches; (41c) card against CPU at small size in 8 shards:
    classical-dist D1 and D2 at 16³ (f32 x bit-equal, f64 to 1e-9),
    config 4 on a 12³ SPE10 grid (and within 8 iterations of one
    unsharded pack), MULTICOLOR_GS, GS, FIXCOLOR_GS, KACZMARZ and
    MULTICOLOR_DILU in sharded aggregation AMG, every solver name new
    on a sharded pack, a resetup (a fresh setup, graphs captured anew)
    and ``amg_host_levels_rows`` on a distributed classical hierarchy.
42. telemetry on the card: the headline 128³ with ``telemetry``,
    ``setup_profile`` and ``memledger`` on (``telemetry_path`` a
    temporary file) against the same solve with them off — phase 5's
    count, x bit-equal, the graph's node count unchanged, both warm
    solve times; the device anatomy of a graphed warm solve under
    ``torch.profiler`` (``telemetry/deviceprof.py``: attributed +
    unattributed ≡ total, ≥ 90 % attributed to ``amgx/`` scopes, the
    levels plus the coarse solve within 10 % of the AMG application's
    device time, B1's time under ``amgx/spmv/dia/kernel`` within 5 % of
    its kernel sum, the top scopes with their measured GB/s); the
    memory ledger's invariant at setup and after the solve with its top
    owners; the setup profile by level; the JSONL validated, its Chrome
    trace validated, the doctor run on it; ``forensics=1`` at 64³ (one
    ``cycle_level`` event per level visit of every application, x
    bit-equal to forensics off); the ``dist/halo_exchange`` scope's
    device time on 40c's 16³ stack in 8 shards.
43. serving on the card: a ``SolveService`` (two workers, ``metrics_port``
    on a free port, telemetry on) serving the headline 128³: ``warmup``,
    then 22 requests from 4 client threads (16 right-hand sides of the
    matrix, 4 of its drifted values, 2 of a 64³ pattern) with every
    count set to 0 just before and read just after; each answer's count
    and x equal to a direct solve's (bit-equal), the same wave under one
    worker bit-equal, the cache's decisions, no capture for the warmed
    pattern, the endpoint (``/debug/profile`` finds B1's kernels), an
    SLO window and a load-generator report, the session's bytes against
    its setup's allocation; then the warm start across three child
    processes (``--serve-child``): no kernel build and no plan build in
    the warm one, the same count and x, a corrupt entry's fallback.
44. the AMGX C API on the card (:func:`capi_phase`): the headline 128³
    through ``amgx_tpu_torch.capi`` in dDDI (count and x bit-equal to
    the direct path on the same uploaded matrix, relres ≤ 1e-8, B1 and
    no plain label, ``AMGX_matrix_vector_multiply`` bit-equal to
    ``ops.spmv``), the same through ``capi_headline.c`` linked against
    ``libamgx_torch_c.so`` in a child process (equal count, x's bytes
    and FNV-1a hash), ``native/test_capi.c`` unchanged against that
    library, the distributed C API (48³ in 8 shards, B3 on the stacked
    interior, count and x equal to the direct distributed path's) and
    the C API on the card against the CPU at 16³ (x bit-equal).  The
    shim and drivers build with the host compiler beside the kernels'
    nvcc (``amgx_tpu_torch/capi_native/build.py``, no cmake); the phase
    runs beside phase 23's CPU children (its child processes with
    ``OMP_NUM_THREADS=1``).

Phases 11, 28, 30, 31, 33, 40, 41 and 44 hold the card's x bit-equal to the
CPU's (IDR and IDRMSYNC excepted: their s × s solves are library
calls).

Then one JSON line of the paths' kernels and, last, the contract line
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

#: H100 SXM datasheet: vector (non-tensor) peaks; the memory rate is
#: the port's cost model's (``telemetry/costmodel.py``:
#: ``PUBLISHED_PEAK_BYTES_PER_S``, 3.35 TB/s), the one yardstick of the
#: bounds here and of the telemetry's
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}


def peak_bytes_per_s() -> float:
    from amgx_tpu_torch.telemetry import costmodel
    return costmodel.PUBLISHED_PEAK_BYTES_PER_S


def bound_of(nbytes, ops, dt) -> tuple:
    """(bound_ms, bound_by) of ``nbytes`` moved and ``ops`` operations in
    ``dt`` arithmetic (:func:`~amgx_tpu_torch.telemetry.costmodel.bound`
    at the datasheet rates)."""
    from amgx_tpu_torch.telemetry import costmodel
    t, by = costmodel.bound(nbytes, ops, peak_bytes_per_s(),
                            PEAK_FLOPS[dt])
    return t * 1e3, by

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
#: the mid-size masked grid of the card-against-CPU checks of phases 13b
#: and 18 (cut for time from 30 × 110 × 43, on which the JAX package
#: takes 26 iterations on the CPU: the CPU solves were most of these two
#: phases)
MID_GRID = (20, 70, 30)
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
#: its hierarchy cut at DFG_LEVELS levels (phase 22 runs it deeper).  The CG K-cycle (cycle_iters 2) visits level i 2^i times per
#: application, each visit a few dozen kernels, replayed from one CUDA
#: graph: at ny = 512 the config's own 14 levels make 2^13 = 8,192
#: coarse solves per application; 10 levels make 256, on a 1,498-row
#: dense coarse operator
DFG_LEVELS = 10
DFG_CFG = HEADLINE_CFG.replace("amg:max_levels=20",
                               f"amg:max_levels={DFG_LEVELS}")
#: phase 22's depth: 13 of the config's own 15 levels (cut for time:
#: the K-cycle visits level i 2^i times, so the two deepest levels held
#: three quarters of its graph; ``scripts/torch_dfg_depth.py`` runs all
#: 15)
DFG_DEEP_LEVELS = 13
DFG_DEEP_CFG = HEADLINE_CFG.replace("amg:max_levels=20",
                                    f"amg:max_levels={DFG_DEEP_LEVELS}")
#: phase 23's depth at ny = 320 on the card and in the CPU children
#: (short of DFG_LEVELS for time: the children are the smoke's critical
#: path; on the CPU 9 levels solve faster than 8, whose 2,743-row dense
#: coarse solve costs more than the deeper level's visits)
DFG_SMALL_LEVELS = 9
DFG_SMALL_CFG = HEADLINE_CFG.replace("amg:max_levels=20",
                                     f"amg:max_levels={DFG_SMALL_LEVELS}")
DFG_NY, DFG_SMALL_NY = 512, 320
#: FGMRES iterations of the profiled window of a warm DFG solve
DFG_WINDOW_ITERS = 2
#: per-row limits of B2 against its plain version (it is bit-equal by
#: construction; the limits are those of the other kernels)
SHIFT_TOL = {"f32": 1e-5, "f64": 1e-12}
#: phases 24-25: the classical and headline 128³ systems
FAMILY_SIDE = 128
#: phase 24's CF_JACOBI stack (its classical setup runs the host loop:
#: 21.5 s at 128³ in the first full run, so cut to 96³ for time)
CF_JACOBI_SIDE = 96
#: phase 26: config 4's SPE10 grid cut to an eighth (30 × 110 × 43, the
#: masked system of phase 18) for time: on the full grid its DILU setup
#: took 19.5 s and the phase 44 s (H100 80GB HBM3, 700 W)
FAMILY_C4_GRID = (30, 110, 43)
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
BLOCK_SIDE, BLOCK_SMALL_SIDE = 80, 12
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

#: phase 32: the bf16 hierarchy paths (``hierarchy_dtype=bfloat16``,
#: every level but the coarsest narrowed; f32 Krylov pack, f64
#: refinement) and the classical side at PREC_CLA_SIDE³
BF16_HIER = ", amg:hierarchy_dtype=bfloat16"
PREC_CLA_SIDE = 64
#: phase 32: config 4 on a bf16 pack (``tpu_matrix_dtype=bfloat16``): a
#: bf16 pack's ladder has one rung, to f32 (a bf16 pack cannot claim f64
#: residuals, ``promotion_target``; the JAX package refuses 1e-8 there),
#: so the solve runs to a tolerance that rung reaches
C4_BF16_TOL = 1e-5
#: phase 33: the scaled classical stacks run on an f64 pack (a scaled
#: solve is structurally unrefinable, as upstream: in f32 it would stall
#: above 1e-8), and RCM on a randomly permuted Poisson
SCALE_SIDE, RCM_SIDE, SMALL_BOUNDARY_SIDE = 64, 64, 24
#: phase 35: the headline with its levels of at most this many rows on
#: the CPU (4096, 512, 64 and 8 at 128³)
HOST_LEVELS_ROWS = 4096


#: the script's start, for the elapsed seconds on every phase line
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def short(dt) -> str:
    import torch
    return {torch.float32: "f32", torch.float64: "f64",
            torch.bfloat16: "bf16", torch.complex64: "c64",
            torch.complex128: "c128"}[dt]


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
    from amgx_tpu_torch.telemetry import costmodel
    n_cols = n if n_cols is None else n_cols
    nbytes = costmodel.dia_bytes(nd, n, n_cols, vdt.itemsize, xdt.itemsize)
    return bound_of(nbytes, 2 * nd * n, short(xdt))


def check_ell(dev, gen, name, cols, vals64, n_cols, errs, row_len=None,
              pairs=None):
    """B3 vs its plain version in each (vals, x) type pair (default the
    two same-type pairs) on one ELL pack (values given in f64, cast to
    each pair's type; ``cols=None`` for dense rows; ``row_len`` as the
    path passes it), per row to a relative 1e-5 (f32 x) or 1e-12 (f64
    x), and bit for bit."""
    import torch
    from amgx_tpu_torch.ops import ell_spmv as emod
    n, K = vals64.shape
    absmax = vals64.abs().max().item()
    if pairs is None:
        pairs = ((torch.float32, torch.float32),
                 (torch.float64, torch.float64))
    for vdt, dt in pairs:
        vals = vals64.to(vdt).contiguous()
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
        record(errs, f"{short(vdt)}.{short(dt)}", diff, rel)
        emit("ell_check", case=name, n=n, K=K, n_cols=n_cols,
             dense_rows=cols is None, vals_absmax=absmax, type=short(dt),
             vals=short(vdt),
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
    from amgx_tpu_torch.telemetry import costmodel
    nbytes = costmodel.ell_bytes(entries, n, n_cols, dt.itemsize,
                                 dt.itemsize)
    return bound_of(nbytes, 2 * entries, short(dt))


def level_table(h):
    """(fmt, logical rows, stored rows) per level, then the coarsest."""
    out = [(lv.Ad.fmt, lv.level_stats()[0], lv.Ad.n_rows)
           for lv in h.levels]
    c = h.coarsest
    return out + [(c.device().fmt, c.n_block_rows, c.n_block_rows)]


def profile_window(fn, trace_path=None, by_name=None):
    """Device time by kernel of ``fn()`` under ``torch.profiler``:
    (wall_s, device_s, device kernels, top rows).  The device events are
    summed straight from the trace: ``key_averages()`` gives the same
    sums but first builds an event object for every kernel and op, which
    takes some ten times as long.  ``trace_path`` also writes the
    profile's chrome trace there; a dict ``by_name`` receives the
    per-kernel (device ns, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    by_name = {} if by_name is None else by_name
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ns, calls = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), calls + 1)
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    top = [dict(name=k[:90], device_ms=ns / 1e6, calls=c)
           for k, (ns, c) in sorted(by_name.items(),
                                    key=lambda r: -r[1][0])[:8]]
    return (wall, sum(ns for ns, _ in by_name.values()) / 1e9,
            sum(c for _, c in by_name.values()), top)


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
                declines=smod.declines(),
                B1=dict(dmod.LAUNCHES), B2=dict(shmod.LAUNCHES),
                B3=dict(emod.LAUNCHES), B4=dict(bmod.LAUNCHES["B4"]),
                B5=dict(bmod.LAUNCHES["B5"]),
                B5s=dict(bmod.LAUNCHES["B5-stacked"]))


def graph_check(pre, dev, gen, eager=True, declines=False) -> dict:
    """The AMG preconditioner's CUDA graph after a solve: its capture
    (warm-up, capture and instantiation seconds, nodes, pool bytes), the
    launches and dispatches one replay credits and the time of a replay;
    with ``eager``, the time of an eager application, whose counts must
    equal the replay's and whose result must equal the replay's bit for
    bit on the same vector.  A replay credits no decline unless
    ``declines`` (a complex hierarchy's plain SpMVs)."""
    import torch
    assert len(pre.graphs) == 1, list(pre.graphs)
    (key, g), = pre.graphs.items()
    r = torch.randn(key[0], dtype=torch.float64, device=dev,
                    generator=gen)
    if key[1].is_complex:
        r = torch.complex(r, torch.randn(key[0], dtype=torch.float64,
                                         device=dev, generator=gen))
    r = r.to(key[1])
    torch.cuda.synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    z_graph = pre.apply(r)
    torch.cuda.synchronize(dev)
    replay_s = time.perf_counter() - t0
    replay_counts = read_counts()
    assert declines or not any(replay_counts["declines"].values()), \
        replay_counts
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
    from amgx_tpu_torch.telemetry import costmodel
    nbytes = costmodel.binned_bytes(entries, b, n, n_cols, vdt.itemsize,
                                    xdt.itemsize)
    return bound_of(nbytes, 2 * b * b * entries, short(xdt))


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
    # a Generator draws the pattern without a permutation of all n²
    # positions (a RandomState seed made this draw 31 s of the phase)
    wide = sp.random(20000, 20000, density=0.002,
                     random_state=np.random.default_rng(SEED), format="csr")
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

    # ---- 32 (config 4): a bf16 precision view of phase 13's matrix
    bf16 = config4_bf16_phase(amgx, A, m, dev, smi, gen, errs)

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
    t = bf16["timing"]
    kernels.append(dict(
        name="binned_spmv_B5<bf16,f32,b=4>", route="cuda",
        source="amgx_tpu_torch/csrc/binned_spmv.cu",
        replaces="amgx_tpu/ops/pallas_csr.py:497", launches=0,
        launches_by_path={}, max_abs_err=errs["B5.bf16.f32"]["abs"],
        max_row_rel_err=errs["B5.bf16.f32"]["rel"],
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}))
    return dict(kernels=kernels, b1_launches=c16["B1"],
                b1_block_dia_errs=bdia_errs,
                bf16_launches=bf16["counts"], system=A,
                iterations=facts["iterations"])


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
    from amgx_tpu_torch.telemetry import costmodel
    T, n_tiles, Dpad = (int(v) for v in Ad.sh_dims[:3])
    S, n_slices, slots, _ = Ad.sh_compact.dims
    n = Ad.n_rows
    xy = 2 * n * dt.itemsize
    ops = 2 * nnz
    nnz_bytes = nnz * dt.itemsize + xy
    compact_bytes = costmodel.shift_compact_bytes(
        int(slots), int(S), int(n_slices), n_tiles, Dpad, n, dt.itemsize)
    planes_bytes = n_tiles * Dpad * (T * dt.itemsize + 4) + xy
    bound_ms, bound_by = bound_of(nnz_bytes, ops, short(dt))
    return dict(
        bound_ms=bound_ms, bound_by=bound_by,
        compact_bound_ms=bound_of(compact_bytes, ops, short(dt))[0],
        planes_bound_ms=bound_of(planes_bytes, ops, short(dt))[0],
        nnz_bytes=nnz_bytes, compact_bytes=compact_bytes,
        planes_bytes=planes_bytes)


def dfg_solve(amgx, A, where, pdt):
    """One phase-23 DFG solve of ``b = 1`` under ``DFG_SMALL_CFG`` on
    ``where`` with a ``pdt`` pack: (iterations, x on the host, true
    relres in f64)."""
    m = amgx.Matrix(A, device=where)
    m.device_dtype = pdt
    slv = amgx.create_solver(DFG_SMALL_CFG)
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
    # the cores, shared by the children (the f64 solve, the longer, takes
    # the odd one); one left to the card process
    cores = (os.cpu_count() or 2) - 1
    n_ch = len(DFG_CPU_DTYPES)
    torch.set_num_threads(max(1, cores // n_ch + (
        name == DFG_CPU_DTYPES[-1] and cores % n_ch > 0)))
    A3 = dfg_cylinder_pressure(DFG_SMALL_NY)
    t0 = time.perf_counter()
    it, x, relres = dfg_solve(amgx, A3, "cpu", np.dtype(name).type)
    np.save(os.path.join(out_dir, f"x_{name}.npy"), x)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(dict(iterations=it, relres=relres,
                       seconds=time.perf_counter() - t0), f)
    return 0


def dfg_phases(amgx, dev, smi, gen, cpu_ref, ell_errs,
               beside=None) -> dict:
    """Phases 19-23: the DFG cylinder path (aggregation AMG on an
    uploaded operator) and kernel B2; ``cpu_ref`` is the
    :class:`CpuReference` it starts at phase 22, ``ell_errs`` B3's
    errors, which its checks here join.  ``beside()``, when given, runs
    after phase 23's card solves while the CPU children still run (its
    result is returned as ``beside``)."""
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
    # phase 42 holds its telemetry-on solve to this x
    head_x = x
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

    # ---- 22. a deeper hierarchy, through the graph, beside the CPU
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
    beside_out = beside() if beside is not None else None
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
                b3_launches_full_depth=full["B3"], beside=beside_out)


def dfg_full_depth(amgx, dev, smi, gen, A, ell_errs) -> dict:
    """Phase 22: the DFG operator under the headline config cut at
    ``DFG_DEEP_LEVELS`` of its own 15 levels (SIZE_2; the config's own
    depth ends at a 28-row dense coarse solve), f32 pack, f64
    refinement: setup; the full solve (its first
    application runs eagerly and captures the preconditioner's graph,
    the others replay it), its iterations and the true relres in f64 on
    the host, the graph's facts (:func:`graph_check`, without an eager
    application: one takes some 30 s at this depth), its launches
    (returned); B3 against its plain version on the ELL levels from
    phase 19's dense coarsest level down.  It runs beside phase 23's CPU
    children.  ``scripts/torch_dfg_depth.py --solve`` times a warm solve
    at this depth."""
    import torch
    n = A.shape[0]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    m = amgx.Matrix(A, device="cuda")
    m.device_dtype = np.float32
    slv = amgx.create_solver(DFG_DEEP_CFG)
    slv.setup(m)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    h = slv.preconditioner.hierarchy
    assert len(h.levels) + 1 == DFG_DEEP_LEVELS, len(h.levels)
    b = torch.ones(n, dtype=torch.float64, device=dev)
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
    emit("dfg_full_depth", ny=DFG_NY, rows=n,
         config=f"amg:max_levels={DFG_DEEP_LEVELS}",
         levels=[lv.level_stats()[0] for lv in h.levels]
         + [h.coarsest.n_block_rows],
         iterations=res.iterations, relres_f64=relres, setup_s=setup_s,
         solve_s=res.solve_time, amg_graph=graph, counts=counts,
         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=smi)
    del slv, m, h, res
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


def small_card_vs_cpu(amgx, label, cfg, make, rhs_n, block_dim=1,
                      bit_equal=True):
    """One small stack on the card and on the CPU (plain versions): equal
    iterations, x within SMALL_X_RTOL and, with ``bit_equal``, x equal
    bit for bit (every sum of the stack runs in one order on both
    devices).  ``make(where)`` returns the uploaded matrix on
    ``where``."""
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
    assert facts["x_bit_equal"] or not bit_equal, facts
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
    stacks += [(f"family_classical_{name}_f32",
                CFG_CLA.replace("solver(out)=PCG", f"solver(out)={name}"),
                np.float32) for name in FAMILY_PACK]
    # CF_JACOBI leaves the device pipeline for the host loop: its stack
    # runs CF_JACOBI_SIDE³ (cut from 128³ for time)
    stacks.append(("family_classical_CF_JACOBI",
                   CFG_CLA.replace("JACOBI_L1", "CF_JACOBI"), np.float32))
    for label, cfg, pdt in stacks:
        side_, A_ = side, Ahost
        if label == "family_classical_CF_JACOBI":
            side_ = CF_JACOBI_SIDE
            A_ = poisson7pt(side_, side_, side_)
        m = amgx.Matrix(A_, device="cuda")
        m.device_dtype = pdt
        counts = family_solve(amgx, dev, smi, gen, label, cfg, m,
                              host_relres(A_),
                              converge=not label.endswith("_f32"),
                              n=side_ ** 3, pack=np.dtype(pdt).name)
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

    # ---- 26. config 4's SPE10 system (cut to FAMILY_C4_GRID), uploaded
    # once
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
        # IDRMSYNC's s × s solves are library calls (solvers/idr.py),
        # whose order differs by device: its x is not held bit for bit
        small.append(small_card_vs_cpu(
            amgx, label, cfg, host_matrix(A_blk, 4), A_blk.shape[0],
            bit_equal="IDRMSYNC" not in label))
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


# --------------------------------------------------------------------------
# phases 32-35: the solve boundary's knobs
# --------------------------------------------------------------------------
def bf16_packs(h):
    """(name, pack) of every bf16 DIA, ``dia3`` stream and ELL pack of a
    hierarchy's levels and transfers (the coarsest is never narrowed)."""
    import torch
    out, seen = [], set()
    for i, lv in enumerate(h.levels):
        roles = [("A", lv.Ad)]
        if lv.Ad.fmt == "dia3":
            roles = [(f"A.dia3.{r}", getattr(lv.Ad, r)) for r in "PAR"]
        if lv.kind == "classical":
            roles += [("P", lv.P), ("R", lv.R)]
        for role, M in roles:
            if id(M) in seen or M.dtype != torch.bfloat16 or \
                    M.fmt not in ("dia", "ell") or M.block_dim != 1:
                continue
            seen.add(id(M))
            out.append((f"level{i}.{role}", M))
    return out


def check_bf16_packs(dev, gen, label, h, b1_errs, b3_errs) -> dict:
    """B1 and B3 in their (bf16, f32) pairs against their plain versions,
    bit for bit, on every bf16 pack of ``h``; returns the pack kinds
    checked."""
    import torch
    kinds = {}
    for name, M in bf16_packs(h):
        x = torch.randn(M.n_cols, dtype=torch.float64, device=dev,
                        generator=gen).float()
        if M.fmt == "dia":
            check_dia_once(f"{label}.{name}", M.vals, x, M.dia_offsets,
                           b1_errs)
        else:
            check_ell(dev, gen, f"{label}.{name}", M.cols, M.vals.double(),
                      M.n_cols, b3_errs, row_len=M.row_len,
                      pairs=((torch.bfloat16, torch.float32),))
        kinds[M.fmt] = kinds.get(M.fmt, 0) + 1
    return kinds


def library_ms_of(csr, x, dev):
    """The time of one cuSPARSE product of ``csr`` (a torch sparse CSR of
    the pack's values) by ``x``, or None when this PyTorch refuses the
    type pair."""
    import torch
    try:
        csr @ x
        torch.cuda.synchronize(dev)
    except (RuntimeError, NotImplementedError) as e:
        emit("library_choice", refused=str(e)[:200])
        return None
    return time_ms(lambda: csr @ x, dev)


def precision_phase(amgx, dev, smi, gen, b1_errs, b3_errs) -> dict:
    """Phase 32 (less config 4, which runs in :func:`config4_phases` on
    its uploaded system): the headline 128³ and the classical
    ``PREC_CLA_SIDE``³ with ``hierarchy_dtype=bfloat16`` (every level
    but the coarsest narrowed; f32 Krylov pack, f64 refinement to 1e-8),
    each with its counts set to 0 just before its first solve and read
    just after, the true relres in f64, the AMG graph, B1/B3 in their
    bf16 pairs against their plain versions on every narrowed pack, and
    single-launch times of those pairs; the headline at 24³ on the card
    against the port on the CPU.  Returns the launches and the kernels'
    timings."""
    import torch
    from amgx_tpu_torch.io import poisson7pt, poisson7pt_device
    from amgx_tpu_torch.ops import dia_spmv as dmod
    from amgx_tpu_torch.ops import ell_spmv as emod
    t_phase = time.perf_counter()
    launches, timing = {}, {}

    # ---- the headline at full width, bf16 hierarchy
    side = 128
    n = side ** 3
    t0 = time.perf_counter()
    A = poisson7pt_device(side, side, side, device_dtype=np.float32,
                          device="cuda")
    slv = amgx.create_solver(HEADLINE_CFG + BF16_HIER)
    slv.setup(A)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    b = torch.ones(n, dtype=torch.float64, device=dev)
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    res2 = slv.solve(b)
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    assert counts["B1"]["bf16.f32"] > 0, counts
    assert not any(counts["declines"].values()), counts
    relres = pack_relres(A)(res.x)
    assert relres <= 1e-8, relres
    h = slv.preconditioner.hierarchy
    dtypes = [short(lv.Ad.dtype) for lv in h.levels]
    assert set(dtypes) == {"bf16"}, dtypes
    assert h.coarsest.device().dtype == torch.float32
    graph = graph_check(slv.preconditioner, dev, gen)
    kinds = check_bf16_packs(dev, gen, "headline_bf16", h, b1_errs,
                             b3_errs)
    # B1 (bf16, f32) single launches on the fine level's narrow pack
    P0 = h.levels[0].Ad
    x = torch.randn(n, dtype=torch.float32, device=dev, generator=gen)
    csr = csr_of_dia(P0.vals, P0.dia_offsets)
    ms = time_ms(lambda: dmod.dia_spmv(P0.vals, x, P0.dia_offsets), dev)
    plain_ms = time_ms(lambda: dmod.dia_spmv_reference(
        P0.vals, x, P0.dia_offsets), dev)
    # the library product of a bf16 matrix takes a bf16 vector
    library_ms = library_ms_of(csr, x.to(torch.bfloat16), dev)
    bound_ms, bound_by = bound(len(P0.dia_offsets), n, torch.bfloat16,
                               torch.float32)
    timing["B1"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        operator="headline 128³ level 0 (bf16)")
    del csr
    emit("precision_headline", n=n, config="hierarchy_dtype=bfloat16",
         iterations=res.iterations, relres_f64=relres, setup_s=setup_s,
         solve_s=res.solve_time, solve_warm_s=res2.solve_time,
         level_dtypes=dtypes, coarsest_dtype="f32", counts=counts,
         amg_graph=graph, packs_checked=kinds, b1_bf16_timing=timing["B1"],
         card=smi)
    launches["precision_headline"] = counts
    del slv, res, res2, A, h, P0
    torch.cuda.empty_cache()

    # the same at 24³: the card against the port on the CPU
    out = {}
    for where in ("cuda", "cpu"):
        As = poisson7pt_device(24, 24, 24, device_dtype=np.float32,
                               device=where)
        s_ = amgx.create_solver(HEADLINE_CFG + BF16_HIER)
        s_.setup(As)
        rr = s_.solve(np.ones(24 ** 3))
        assert rr.status == amgx.SolveStatus.SUCCESS, where
        out[where] = (rr.iterations, rr.x.cpu())
    (ig, xg), (ic, xc) = out["cuda"], out["cpu"]
    facts = dict(n=24 ** 3, iterations_card=ig, iterations_cpu=ic,
                 x_bit_equal=bool(torch.equal(xg, xc)),
                 x_rel_diff=((xg - xc).norm() / xc.norm()).item())
    emit("precision_headline_card_vs_cpu", **facts)
    # every sum of the bf16 stack runs in one order on both devices
    assert ig == ic and facts["x_bit_equal"], facts

    # ---- classical at PREC_CLA_SIDE³, bf16 hierarchy
    side = PREC_CLA_SIDE
    Ah = poisson7pt(side, side, side)
    m = amgx.Matrix(Ah, device="cuda")
    m.device_dtype = np.float32
    t0 = time.perf_counter()
    slv = amgx.create_solver(CFG_CLA + BF16_HIER)
    slv.setup(m)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    b = torch.ones(Ah.shape[0], dtype=torch.float64, device=dev)
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    res2 = slv.solve(b)
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    relres = host_relres(Ah)(res.x)
    assert relres <= 1e-8, relres
    h = slv.preconditioner.hierarchy
    table = [(lv.Ad.fmt, short(lv.Ad.dtype)) for lv in h.levels]
    ell_narrow = any(f == "ell" and d == "bf16" for f, d in table)
    assert counts["B1"]["bf16.f32"] > 0, counts
    if ell_narrow:
        assert counts["B3"]["bf16.f32"] > 0, counts
    graph = graph_check(slv.preconditioner, dev, gen)
    kinds = check_bf16_packs(dev, gen, "classical_bf16", h, b1_errs,
                             b3_errs)
    ell = [(nm, M) for nm, M in bf16_packs(h) if M.fmt == "ell"]
    if ell:
        name, M = max(ell, key=lambda p: p[1].cols.numel())
        x = torch.randn(M.n_cols, dtype=torch.float32, device=dev,
                        generator=gen)
        ms = time_ms(lambda: emod.ell_spmv(M.cols, M.vals, x, M.row_len),
                     dev)
        plain_ms = time_ms(lambda: emod.ell_spmv_reference(
            M.cols, M.vals, x), dev)
        csr = csr_of_ell(M.cols, M.vals, M.n_cols)
        library_ms = library_ms_of(csr, x.to(torch.bfloat16), dev)
        nnz = int((M.vals != 0).sum().item())
        nb, K = M.cols.shape
        from amgx_tpu_torch.telemetry import costmodel
        nbytes = costmodel.ell_bytes(nnz, nb, M.n_cols, 2, 4)
        bound_ms, bound_by = bound_of(nbytes, 2 * nnz, "f32")
        timing["B3"] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            operator=f"classical {side}³ {name} ({nb} × {K}, {nnz} "
            "nonzeros, bf16)")
        del csr
    emit("precision_classical", n=Ah.shape[0],
         config="hierarchy_dtype=bfloat16", iterations=res.iterations,
         relres_f64=relres, setup_s=setup_s, solve_s=res.solve_time,
         solve_warm_s=res2.solve_time, levels=table,
         ell_level_narrowed=ell_narrow, counts=counts, amg_graph=graph,
         packs_checked=kinds, b3_bf16_timing=timing.get("B3"), card=smi)
    launches["precision_classical"] = counts
    del slv, res, res2, m, h, ell
    torch.cuda.empty_cache()
    emit("precision_phase", elapsed_phase_s=time.perf_counter() - t_phase)
    return dict(launches=launches, timing=timing)


def config4_bf16_phase(amgx, A, m, dev, smi, gen, errs) -> dict:
    """Phase 32, config 4: ``tpu_matrix_dtype=bfloat16`` on the matrix
    phase 13 uploaded — a precision view whose pack is the f32 pack cast
    on the card (no bytes over the wire), so BiCGStab and the DILU run on
    bf16 values (B5's (bf16, f32) pair) with the refinement's residuals
    in f32 to ``C4_BF16_TOL``; counts set to 0 just before the first
    solve and read just after; B5 (bf16, f32) against its plain version
    on the view's pack and its single-launch time."""
    import scipy.sparse as sp
    import torch
    from amgx_tpu_torch.ops import binned_spmv as bmod
    t_phase = time.perf_counter()
    f32_pack = m.device()
    cfg = CFG4.replace("out:tolerance=1e-8",
                       f"out:tolerance={C4_BF16_TOL}") \
        + ", tpu_matrix_dtype=bfloat16"
    t0 = time.perf_counter()
    slv = amgx.create_solver(cfg)
    slv.setup(m)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    view = slv.A
    assert view is not m and m.device() is f32_pack
    assert slv.Ad.dtype == torch.bfloat16, slv.Ad.dtype
    assert view._pack_cast_via == np.float32
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    res2 = slv.solve(b)
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    assert counts["B5"]["bf16.f32"] > 0, counts
    assert not any(counts["declines"].values()), counts
    relres = host_relres(A)(res.x)
    assert relres <= 2 * C4_BF16_TOL, relres
    Ad = slv.Ad
    check_binned(dev, gen, "config4_bf16_view", Ad, torch.bfloat16, errs)
    x = torch.randn(A.shape[0], dtype=torch.float32, device=dev,
                    generator=gen)
    ms = time_ms(lambda: bmod.binned_spmv(Ad, x), dev)
    plain_ms = time_ms(lambda: bmod.binned_compact_reference(
        Ad.bn_compact, Ad.bn_pos, Ad.bn_dims, x), dev)
    bsr = sp.bsr_matrix(A, blocksize=(4, 4))
    lib = bsr_of_pack(bsr, torch.bfloat16, dev)
    library_ms = library_ms_of(lib, x.to(torch.bfloat16), dev)
    nblk = A.nnz // 16
    bound_ms, bound_by = binned_bound(nblk, 4, A.shape[0] // 4,
                                      A.shape[0] // 4, torch.bfloat16,
                                      torch.float32)
    timing = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by=bound_by,
                  operator="config-4 pack cast to bf16")
    emit("precision_config4", config=f"tpu_matrix_dtype=bfloat16, "
         f"tolerance={C4_BF16_TOL}", cast_on_device=True,
         pack=amgx.pack_kind(Ad), iterations=res.iterations,
         relres_f64=relres, setup_s=setup_s, solve_s=res.solve_time,
         solve_warm_s=res2.solve_time, counts=counts,
         b5_bf16_timing=timing, card=smi,
         elapsed_phase_s=time.perf_counter() - t_phase)
    del slv, res, res2, view, Ad, lib
    torch.cuda.empty_cache()
    return dict(counts=counts, timing=timing)


def boundary_phase(amgx, dev, smi, gen) -> dict:
    """Phase 33: equation scaling (NBINORMALIZATION and
    DIAGONAL_SYMMETRIC, the outer solver's scope) on the classical
    ``SCALE_SIDE``³ stack with an f64 pack, and ``matrix_reorder=RCM`` on
    a ``RCM_SIDE``³ Poisson whose rows and columns are permuted at
    random from ``SEED`` (f32 pack, f64 refinement): iterations, the
    true relres of the caller's system in f64, counts; each also at
    ``SMALL_BOUNDARY_SIDE``³ on the card against the CPU (equal counts,
    x bit-equal; the scaled stacks there on an f32 pack to 1e-4, where
    every sum is ordered).  Returns the launches."""
    import scipy.sparse as sp
    import torch
    from amgx_tpu_torch.io import poisson7pt
    t_phase = time.perf_counter()
    launches = {}

    def permuted(side):
        A0 = sp.csr_matrix(poisson7pt(side, side, side))
        p = np.random.default_rng(SEED).permutation(A0.shape[0])
        return sp.csr_matrix(A0[p][:, p])

    # (label, config, matrix, pack dtype, side; the small check's config
    # and pack dtype): the scaled stacks are held card against CPU on an
    # f32 pack at a tolerance f32 reaches (f64 dots are library sums)
    cases = [(f"scaling_{k}", CFG_CLA + f", out:scaling={k}",
              lambda s_: poisson7pt(s_, s_, s_), np.float64, SCALE_SIDE,
              CFG_CLA.replace("out:tolerance=1e-8", "out:tolerance=1e-4")
              + f", out:scaling={k}", np.float32)
             for k in ("NBINORMALIZATION", "DIAGONAL_SYMMETRIC")]
    cfg = CFG_CLA + ", out:matrix_reorder=RCM"
    cases.append(("matrix_reorder_RCM", cfg, permuted, np.float32,
                  RCM_SIDE, cfg, np.float32))
    for label, cfg, make, pdt, side, small_cfg, small_pdt in cases:
        Ah = make(side)
        m = amgx.Matrix(Ah, device="cuda")
        m.device_dtype = pdt
        t0 = time.perf_counter()
        slv = amgx.create_solver(cfg)
        slv.setup(m)
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        b = torch.ones(Ah.shape[0], dtype=torch.float64, device=dev)
        reset_counts()
        res = slv.solve(b)
        torch.cuda.synchronize(dev)
        counts = read_counts()
        res2 = slv.solve(b)
        assert res.status == amgx.SolveStatus.SUCCESS, (label, res.status)
        assert res2.iterations == res.iterations
        relres = host_relres(Ah)(res.x)
        # a scaled solve monitors the scaled residual (as upstream): the
        # caller's system is held to a tenth of a digit less
        assert relres <= (1e-7 if label.startswith("scaling") else 1e-8), \
            (label, relres)
        facts = dict(n=Ah.shape[0], pack=np.dtype(pdt).name,
                     iterations=res.iterations, relres_f64=relres,
                     setup_s=setup_s, solve_s=res.solve_time,
                     solve_warm_s=res2.solve_time, counts=counts,
                     reordered=slv._reorder is not None,
                     scaled=slv.scaler is not None)
        launches[label] = counts
        del slv, res, res2, m
        torch.cuda.empty_cache()
        small = small_card_vs_cpu(
            amgx, f"{label}_{SMALL_BOUNDARY_SIDE}", small_cfg,
            _uploader(amgx, make(SMALL_BOUNDARY_SIDE), small_pdt),
            SMALL_BOUNDARY_SIDE ** 3)
        emit(label, **facts, card_vs_cpu=small, card=smi)
    emit("boundary_phase", elapsed_phase_s=time.perf_counter() - t_phase)
    return launches


def _uploader(amgx, A_host, pdt):
    def make(where):
        m_ = amgx.Matrix(A_host, device=where)
        m_.device_dtype = pdt
        return m_
    return make


def fault_phase(amgx, dev, smi, gen) -> dict:
    """Phase 34: fault injection and the recovery ladder on the card.
    The headline 128³ with ``values_nan`` at iteration 3 (once) and
    ``recovery_policy=AUTO``: the first attempt reports ``nan_poison``,
    the ``restart`` rung recovers, and the AMG graph captured by the
    first solve is replayed (no capture after it); ``krylov_zero`` on PCG
    over the classical ``PREC_CLA_SIDE``³ reports ``krylov_breakdown``;
    ``setup_error``, ``upload_error`` and ``oom`` raise with the JAX
    package's return codes; a fault that survives every rung stops the
    ladder at ``recovery_max_attempts``.  Returns the launches."""
    import torch
    from amgx_tpu_torch.errors import RC, AMGXError, FailureKind
    from amgx_tpu_torch.io import poisson7pt, poisson7pt_device
    from amgx_tpu_torch.utils import cuda_graph, faultinject
    t_phase = time.perf_counter()
    launches = {}
    faultinject.reset()
    side = 128
    n = side ** 3
    A = poisson7pt_device(side, side, side, device_dtype=np.float32,
                          device="cuda")
    slv = amgx.create_solver(HEADLINE_CFG + ", recovery_policy=AUTO, "
                             "fault_inject=values_nan:iter:3:count:1")
    slv.setup(A)
    b = torch.ones(n, dtype=torch.float64, device=dev)
    captures0 = cuda_graph.CAPTURES["count"]
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    captures = cuda_graph.CAPTURES["count"] - captures0
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res.recovery == {"kind": "nan_poison", "action": "restart",
                            "attempts": 1, "outcome": "recovered"}, \
        res.recovery
    # the first attempt captured the AMG's graph; the restart replayed it
    assert captures == 1, captures
    relres = pack_relres(A)(res.x)
    assert relres <= 1e-8, relres
    assert faultinject.stats()["values_nan"]["fired"] == 1
    emit("fault_headline_restart", n=n, iterations=res.iterations,
         relres_f64=relres, recovery=res.recovery,
         attempts=slv.recovery_log, graphs_captured=captures,
         solve_s=res.solve_time, counts=counts, card=smi)
    launches["fault_headline"] = counts
    faultinject.reset()
    del slv, res, A
    torch.cuda.empty_cache()

    # krylov_zero on PCG over the classical stack
    side = PREC_CLA_SIDE
    Ah = poisson7pt(side, side, side)
    m = amgx.Matrix(Ah, device="cuda")
    m.device_dtype = np.float32
    slv = amgx.create_solver(CFG_CLA + ", fault_inject=krylov_zero:iter:3:"
                             "count:1")
    slv.setup(m)
    res = slv.solve(torch.ones(Ah.shape[0], dtype=torch.float64,
                               device=dev))
    assert res.status == amgx.SolveStatus.FAILED, res.status
    assert res.failure.kind == FailureKind.KRYLOV_BREAKDOWN, res.failure
    emit("fault_krylov_zero", n=Ah.shape[0], iterations=res.iterations,
         failure=[res.failure.kind.value, res.failure.iteration])
    faultinject.reset()
    del slv, res, m

    # the seam points: each raises with the JAX package's code, once
    As = poisson7pt(16, 16, 16)
    rcs = {}
    for point, rc in (("setup_error", RC.CORE),
                      ("upload_error", RC.CUDA_FAILURE),
                      ("oom", RC.NO_MEMORY)):
        faultinject.configure(f"{point}:count=1")
        s_ = amgx.create_solver(CFG_CLA)
        try:
            s_.setup(amgx.Matrix(As, device="cuda"))
            raise AssertionError(f"{point} did not raise")
        except AMGXError as e:
            assert e.rc == rc, (point, e.rc)
            rcs[point] = int(e.rc)
        s_.setup(amgx.Matrix(As, device="cuda"))     # one-shot
        faultinject.reset()

    # a fault on every solve: the ladder stops at its budget
    A16 = poisson7pt_device(16, 16, 16, device_dtype=np.float32,
                            device="cuda")
    s_ = amgx.create_solver(HEADLINE_CFG + ", recovery_policy=AUTO, "
                            "recovery_max_attempts=1, "
                            "fault_inject=values_nan:iter:1")
    s_.setup(A16)
    res = s_.solve(np.ones(16 ** 3))
    assert res.status != amgx.SolveStatus.SUCCESS
    assert res.recovery["outcome"] == "exhausted", res.recovery
    assert res.recovery["attempts"] == 1, res.recovery
    faultinject.reset()
    emit("fault_seams_and_budget", return_codes=rcs,
         exhausted=res.recovery, attempts=s_.recovery_log,
         elapsed_phase_s=time.perf_counter() - t_phase)
    return launches


def host_levels_phase(amgx, dev, smi, gen) -> dict:
    """Phase 35: the headline 128³ with ``amg_host_levels_rows`` =
    ``HOST_LEVELS_ROWS``: the levels of 4096, 512, 64 and 8 rows set up
    and run on the CPU, the application captured as graph segments cut
    at each entry into that tail (the K-cycle enters it once per visit
    of the level above).  Against the all-card headline on the same
    operator: equal iterations and x bit-equal; counts set to 0 just
    before the first solve and read just after; the graph's segment,
    host-step and node counts; a replay bit-equal to an eager
    application; warm solve against the all-card one.  Returns the
    launches."""
    import torch
    from amgx_tpu_torch.io import poisson7pt_device
    t_phase = time.perf_counter()
    side = 128
    n = side ** 3
    A = poisson7pt_device(side, side, side, device_dtype=np.float32,
                          device="cuda")
    b = torch.ones(n, dtype=torch.float64, device=dev)
    runs = {}
    for label, knob in (("all_card", ""), ("host_tail", ", amg_host_"
                                          f"levels_rows={HOST_LEVELS_ROWS}")):
        t0 = time.perf_counter()
        slv = amgx.create_solver(HEADLINE_CFG + knob)
        slv.setup(A)
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        reset_counts()
        res = slv.solve(b)
        torch.cuda.synchronize(dev)
        counts = read_counts()
        res2 = slv.solve(b)
        assert res.status == amgx.SolveStatus.SUCCESS, (label, res.status)
        assert res2.iterations == res.iterations
        h = slv.preconditioner.hierarchy
        runs[label] = dict(iterations=res.iterations, x=res.x,
                           setup_s=setup_s, solve_s=res.solve_time,
                           solve_warm_s=res2.solve_time, counts=counts,
                           host_from=h.host_from,
                           places=[lv.Ad.device.type for lv in h.levels]
                           + [h.coarsest.device().device.type],
                           rows=[lv.Ad.n_rows for lv in h.levels]
                           + [h.coarsest.n_block_rows],
                           graph=graph_check(slv.preconditioner, dev, gen))
        del slv, res, res2, h
    card, tail = runs["all_card"], runs["host_tail"]
    assert tail["places"][tail["host_from"]:] == \
        ["cpu"] * (len(tail["places"]) - tail["host_from"]), tail["places"]
    assert all(r <= HOST_LEVELS_ROWS
               for r in tail["rows"][tail["host_from"]:]), tail["rows"]
    assert tail["graph"]["segments"] > 1, tail["graph"]
    assert tail["iterations"] == card["iterations"], \
        (tail["iterations"], card["iterations"])
    bit_equal = bool(torch.equal(tail["x"], card["x"]))
    assert bit_equal, ((tail["x"] - card["x"]).norm()
                       / card["x"].norm()).item()
    for r in runs.values():
        del r["x"]
    emit("host_levels", n=n, host_levels_rows=HOST_LEVELS_ROWS,
         x_bit_equal=bit_equal, all_card=card, host_tail=tail,
         card=smi,
         elapsed_phase_s=time.perf_counter() - t_phase)
    del A, b
    torch.cuda.empty_cache()
    return {"host_levels": tail["counts"], "host_levels_all_card":
            card["counts"]}


#: the shifted Helmholtz operator L − k²I + iεI of
#: tests/test_complex.py:40-47 (k² = 0.4, ε = 0.35)
HELM_SHIFT = -0.4 + 0.35j
#: the headline stack with the iteration budget of a complex solve
COMPLEX_CFG = HEADLINE_CFG.replace("out:max_iters=100", "out:max_iters=400")
#: profiled iterations of the 128³ complex solve's busy share
COMPLEX_WINDOW = 10
#: the side of the full-width grids of phases 36-38 (the headline's)
ITEM7B_SIDE = 128


def helmholtz(side: int, dtype=np.complex128):
    """The shifted Helmholtz operator on a side³ grid, host CSR."""
    import scipy.sparse as sp
    from amgx_tpu_torch.io import poisson7pt
    L = poisson7pt(side, side, side).astype(np.complex128)
    A = sp.csr_matrix(L + HELM_SHIFT * sp.identity(L.shape[0]))
    return A.astype(dtype)


def complex_rhs(n: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(dtype)


def mode_solve(amgx, mode_name, A_host, cfg):
    """One solve in a mode: the matrix placed and packed by the mode."""
    mode = amgx.parse_mode(mode_name)
    m = amgx.Matrix(A_host.astype(mode.mat_dtype),
                    device=mode.placement_device())
    m.device_dtype = mode.effective_mat_dtype()
    slv = amgx.create_solver(cfg)
    slv.setup(m)
    b = complex_rhs(A_host.shape[0], mode.vec_dtype) if mode.is_complex \
        else np.ones(A_host.shape[0], dtype=mode.vec_dtype)
    res = slv.solve(b)
    x = res.x.cpu().numpy()
    relres = float(np.linalg.norm(b - A_host @ x) / np.linalg.norm(b))
    return res, x, relres


def modes_complex_phase(amgx, dev, smi, gen) -> dict:
    """Phase 36: the 12 modes (parse, placement, pack dtype); dZZI at full
    width — the headline stack on the 128³ shifted Helmholtz in c128,
    uploaded from the host matrix, its levels built on the card, every
    SpMV a counted decline to the plain slices (``dia/slices``: the JAX
    package's DIA kernel takes real f32/bf16 only), counts set to 0 just
    before the solve and read just after; the reported relres against
    the true one in f64 on the host; the graph of the complex AMG
    application; the busy share of the first ``COMPLEX_WINDOW``
    iterations.  Then at 24³, card against CPU: dZZI (equal counts, x
    to 1e-9), dCCI at 1e-5 (x bit-equal) and hDDI on the CPU by its
    mode.  Returns the launches (none: the complex path runs no
    kernel)."""
    import torch
    from amgx_tpu_torch.io import poisson7pt
    t_phase = time.perf_counter()
    table = {}
    for name in amgx.PUBLIC_MODES:
        m = amgx.parse_mode(name)
        place = m.placement_device()
        assert place.type == ("cpu" if name[0] == "h" else "cuda"), name
        assert amgx.parse_mode(amgx.MODE_IDS[name]) == m
        assert m.is_complex == (name[1] in "ZC")
        table[name] = dict(id=amgx.MODE_IDS[name], device=str(place),
                           vec=m.vec_dtype.name,
                           pack=m.effective_mat_dtype().name)
    emit("modes", modes=table)

    mode = amgx.parse_mode("dZZI")
    side = ITEM7B_SIDE
    n = side ** 3
    t0 = time.perf_counter()
    A = helmholtz(side)
    host_s = time.perf_counter() - t0
    m = amgx.Matrix(A, device=mode.placement_device())
    m.device_dtype = mode.effective_mat_dtype()
    slv = amgx.create_solver(COMPLEX_CFG)
    slv.setup(m)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    h = slv.preconditioner.hierarchy
    levels = [[lv.kind, lv.Ad.fmt, lv.Ad.n_rows, short(lv.Ad.dtype),
               lv.Ad.device.type] for lv in h.levels]
    assert all(f == "dia" and d == "cuda" for _, f, _, _, d in levels), \
        levels
    bh = complex_rhs(n, np.complex128)
    b = torch.from_numpy(bh).to(dev)
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    x = res.x
    assert x.dtype == torch.complex128 and x.shape == (n,) and x.is_cuda
    assert torch.isfinite(torch.view_as_real(x)).all().item()
    relres = float(np.linalg.norm(bh - A @ x.cpu().numpy())
                   / np.linalg.norm(bh))
    reported = float(res.residual_norm[0] / np.linalg.norm(bh))
    assert abs(reported - relres) <= 1e-6 * relres, (reported, relres)
    d = counts["dispatch"]
    assert d.get("dia/slices", 0) > 0 and "dia/kernel" not in d, d
    assert set(d) <= {"dia/slices", "dense/lanes"}, d
    assert counts["declines"]["dia/slices"] == d["dia/slices"], counts
    assert counts["declines"]["dense/lanes"] == d.get("dense/lanes", 0)
    assert not any(v for k in ("B1", "B2", "B3", "B4", "B5")
                   for v in counts[k].values()), counts
    graph = graph_check(slv.preconditioner, dev, gen, declines=True)
    slv.max_iters = COMPLEX_WINDOW
    window_s = slv.solve(b).solve_time
    wall, dev_s, kern, top = profile_window(lambda: slv.solve(b))
    emit("complex_dZZI_128", n=n, mode="dZZI", pack="complex128",
         pack_mb=h.levels[0].Ad.vals.numel() * 16 / 1e6, levels=levels,
         coarsest_rows=h.coarsest.n_block_rows,
         iterations=res.iterations, status=int(res.status),
         relres_f64=relres, relres_reported=reported,
         host_matrix_s=host_s, setup_s=setup_s, solve_s=res.solve_time,
         counts=counts, amg_graph=graph,
         profiled_iterations=COMPLEX_WINDOW, window_solve_s=window_s,
         device_busy_s=dev_s, device_kernels=kern,
         busy_share_of_unprofiled=dev_s / window_s, top=top[:4],
         card=smi, elapsed_phase_s=time.perf_counter() - t_phase)
    del slv, res, x, b, m, h
    torch.cuda.empty_cache()

    # card against CPU at 24³, each mode and its host twin
    A24 = helmholtz(24)
    runs = {}
    for name, cfg in (("dZZI", COMPLEX_CFG), ("hZZI", COMPLEX_CFG),
                      ("dCCI", COMPLEX_CFG.replace(
                          "out:tolerance=1e-8", "out:tolerance=1e-5")),
                      ("hCCI", COMPLEX_CFG.replace(
                          "out:tolerance=1e-8", "out:tolerance=1e-5")),
                      ("hDDI", HEADLINE_CFG)):
        Am = A24 if name[1] in "ZC" else poisson7pt(24, 24, 24)
        t0 = time.perf_counter()
        res, x, rr = mode_solve(amgx, name, Am, cfg)
        assert res.status == amgx.SolveStatus.SUCCESS, (name, res.status)
        assert res.x.device.type == ("cpu" if name[0] == "h" else "cuda")
        runs[name] = dict(iterations=res.iterations, relres_f64=rr, x=x,
                          dtype=str(res.x.dtype),
                          seconds=time.perf_counter() - t0)
    zz = float(np.linalg.norm(runs["dZZI"]["x"] - runs["hZZI"]["x"])
               / np.linalg.norm(runs["hZZI"]["x"]))
    assert runs["dZZI"]["iterations"] == runs["hZZI"]["iterations"], runs
    assert zz <= 1e-9, zz
    cc_equal = bool(np.array_equal(runs["dCCI"]["x"], runs["hCCI"]["x"]))
    assert runs["dCCI"]["iterations"] == runs["hCCI"]["iterations"]
    assert cc_equal, "dCCI: card x differs from CPU x"
    assert runs["hDDI"]["dtype"] == "torch.float64"
    for r in runs.values():
        del r["x"]
    emit("complex_card_vs_cpu", n=24 ** 3, runs=runs,
         zzi_x_rel_diff=zz, cci_x_bit_equal=cc_equal, card=smi,
         elapsed_phase_s=time.perf_counter() - t_phase)
    return {"complex_dZZI_128": counts}


#: the shift of phase 37's operator (tests/test_solvers.py:262-290)
SHIFT_SIGMA = -0.7
SHIFT_PCG_CFG = (
    "config_version=2, solver(out)=PCG, out:max_iters=400, "
    "out:monitor_residual=1, out:tolerance=1e-10, "
    "out:convergence=RELATIVE_INI")
#: phase 37's batch sizes
MULTI_K, MULTI_PAD_K = 8, 5


def operators_multi_phase(amgx, dev, smi, gen) -> dict:
    """Phase 37 on the headline 128³ Poisson: PCG on
    ``ShiftedOperator(A, −0.7)`` to 1e-10 over an f64 pack (B1 f64 under
    the ``op`` dispatch), its relres through the shifted pack; the
    ``DeflatedOperator`` apply against its formula; ``solve_multi`` of
    ``MULTI_K`` seed-made right-hand sides on the f32 headline stack,
    each lane's x bit-equal to its own ``solve``, then ``MULTI_PAD_K``
    with ``pad_to_bucket``.  Counts set to 0 just before each solve and
    read just after.  Returns the launches."""
    import torch
    from amgx_tpu_torch import operators
    from amgx_tpu_torch.io import poisson7pt_device
    from amgx_tpu_torch.ops.spmv import spmv
    t_phase = time.perf_counter()
    side = ITEM7B_SIDE
    n = side ** 3
    A64 = poisson7pt_device(side, side, side, device_dtype=np.float64,
                            device="cuda")
    op = operators.ShiftedOperator(A64, SHIFT_SIGMA)
    slv = amgx.create_solver(SHIFT_PCG_CFG)
    t0 = time.perf_counter()
    slv.setup(op)
    setup_s = time.perf_counter() - t0
    b = torch.ones(n, dtype=torch.float64, device=dev)
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    shift_counts = read_counts()
    res2 = slv.solve(b)
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    d = shift_counts["dispatch"]
    assert d["op"] > 0 and d["op"] == d["dia/kernel"], d
    assert shift_counts["B1"]["f64.f64"] == d["dia/kernel"], shift_counts
    Ad = A64.device()
    r = b - (spmv(Ad, res.x) - SHIFT_SIGMA * res.x)
    relres = (torch.linalg.vector_norm(r)
              / torch.linalg.vector_norm(b)).item()
    assert relres <= 1e-9, relres
    # the deflated apply against its formula
    V = torch.linalg.qr(torch.randn((n, 2), dtype=torch.float64,
                                    device=dev, generator=gen))[0]
    lam = torch.tensor([3.0, 0.5], dtype=torch.float64, device=dev)
    dop = operators.DeflatedOperator(A64, V, lam)
    v = torch.randn(n, dtype=torch.float64, device=dev, generator=gen)
    want = spmv(Ad, v) - V @ (lam * (V.T @ v))
    defl_err = (spmv(dop, v) - want).abs().max().item() \
        / want.abs().max().item()
    assert defl_err <= 1e-14, defl_err
    emit("shifted_operator_128", n=n, sigma=SHIFT_SIGMA,
         iterations=res.iterations, relres_f64=relres, setup_s=setup_s,
         solve_s=res.solve_time, solve_warm_s=res2.solve_time,
         counts=shift_counts, deflated_rel_err=defl_err, card=smi)
    del slv, res, res2, op, dop, V, A64, Ad
    torch.cuda.empty_cache()

    A = poisson7pt_device(side, side, side, device_dtype=np.float32,
                          device="cuda")
    slv = amgx.create_solver(HEADLINE_CFG)
    slv.setup(A)
    B = torch.randn((MULTI_K, n), dtype=torch.float64, device=dev,
                    generator=gen)
    slv.solve(B[0])                     # the graph's capture
    reset_counts()
    t0 = time.perf_counter()
    out = slv.solve_multi(B)
    torch.cuda.synchronize(dev)
    multi_s = time.perf_counter() - t0
    multi_counts = read_counts()
    assert len(out) == MULTI_K
    lanes = []
    for j, rj in enumerate(out):
        single = slv.solve(B[j])
        assert rj.status == amgx.SolveStatus.SUCCESS, (j, rj.status)
        assert rj.iterations == single.iterations, j
        assert torch.equal(rj.x, single.x), f"lane {j} differs from solve"
        lanes.append(rj.iterations)
    padded = slv.solve_multi(B[:MULTI_PAD_K], pad_to_bucket=True)
    assert len(padded) == MULTI_PAD_K
    assert all(torch.equal(p.x, o.x) for p, o in zip(padded, out))
    emit("solve_multi_128", n=n, k=MULTI_K, iterations=lanes,
         lanes_bit_equal_to_solve=True, warm_s_per_rhs=multi_s / MULTI_K,
         pad_to_bucket_k=MULTI_PAD_K, pad_results=len(padded),
         counts=multi_counts, card=smi,
         elapsed_phase_s=time.perf_counter() - t_phase)
    del slv, out, padded, A, B
    torch.cuda.empty_cache()
    return {"shifted_operator_128": shift_counts,
            "solve_multi_128": multi_counts}


def dirichlet_eigs(dims) -> np.ndarray:
    """Every eigenvalue of the 7-point Dirichlet Laplacian on an
    nx × ny × nz grid, ascending: Σ_d (2 − 2cos(π k_d/(n_d + 1)))."""
    parts = [2 - 2 * np.cos(np.pi * np.arange(1, d + 1) / (d + 1))
             for d in dims]
    return np.sort((parts[0][:, None, None] + parts[1][None, :, None]
                    + parts[2][None, None, :]).ravel())


#: LOBPCG at 128³, preconditioned by the headline's aggregation AMG
LOBPCG_CFG = (
    "config_version=2, eig_solver(e)=LOBPCG, e:eig_max_iters=200, "
    "e:eig_tolerance=1e-7, e:eig_which=smallest, e:eig_wanted_count=4, "
    "e:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
    "amg:cycle=CG, amg:cycle_iters=2, amg:smoother(sm)=BLOCK_JACOBI, "
    "sm:max_iters=1, amg:presweeps=2, amg:postsweeps=2, "
    "amg:min_coarse_rows=32, amg:coarse_solver=DENSE_LU_SOLVER")
#: the link graph of PAGERANK: pages, out-degrees, dangling share
PR_PAGES, PR_MAX_DEG, PR_DANGLING = 1 << 20, 32, 0.05
PR_CFG = ("config_version=2, eig_solver(e)=PAGERANK, e:eig_max_iters=300, "
          "e:eig_tolerance=1e-6, e:eig_damping_factor=0.85")
#: the other six at 32 × 31 × 30 (distinct sides: no eigenvalue repeats,
#: which single-vector Lanczos could not see), the JAX tests' knobs with
#: the iteration budgets this size needs
EIG_DIMS = (32, 31, 30)
EIG_CASES = (
    ("POWER_ITERATION", ", e:eig_max_iters=20000, e:eig_tolerance=1e-10",
     "largest", 1e-5),
    ("INVERSE_ITERATION", ", e:eig_max_iters=300, e:eig_tolerance=1e-9, "
     "e:solver(il)=PCG, il:max_iters=100, il:monitor_residual=0",
     "smallest", 1e-4),
    ("SUBSPACE_ITERATION", ", e:eig_max_iters=3000, e:eig_tolerance=1e-9, "
     "e:eig_wanted_count=3", "largest3", 1e-4),
    ("LANCZOS", ", e:eig_max_iters=300, e:eig_wanted_count=3", "largest3",
     1e-6),
    ("ARNOLDI", ", e:eig_max_iters=300, e:eig_wanted_count=1", "largest",
     1e-4),
    ("JACOBI_DAVIDSON", ", e:eig_max_iters=3000, e:eig_tolerance=1e-9",
     "largest", 1e-5),
)


def link_graph(n: int):
    """A seed-made web graph: out-degrees 1..PR_MAX_DEG, PR_DANGLING of
    the pages without links, targets uniform (rows = source pages)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(SEED)
    deg = rng.integers(1, PR_MAX_DEG + 1, size=n)
    deg[rng.random(n) < PR_DANGLING] = 0
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.size)
    W = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                      shape=(n, n))
    W.sum_duplicates()
    return W


def pagerank_reference(W, d: float, tol: float):
    """PageRank by power iteration in f64 on the CPU (scipy), the
    JAX package's formula: x ← d·Pᵀx + d·Σ x[dangling]/n + (1 − d)/n."""
    import scipy.sparse as sp
    n = W.shape[0]
    deg = np.asarray(W.sum(axis=1), dtype=np.float64).ravel()
    dangling = deg == 0
    PT = sp.csr_matrix((sp.diags(1.0 / np.where(dangling, 1.0, deg))
                        @ W.astype(np.float64)).T)

    def step(x):
        y = d * (PT @ x) + d * x[dangling].sum() / n + (1 - d) / n
        return y / y.sum()

    x = np.full(n, 1.0 / n)
    for _ in range(1000):
        y = step(x)
        if np.abs(y - x).sum() <= tol:
            return y, step
        x = y
    return x, step


def eigen_phase(amgx, dev, smi, gen) -> dict:
    """Phase 38: LOBPCG at 128³ on an f64 pack, preconditioned by the
    headline's aggregation AMG, held to the closed-form four smallest
    eigenvalues of the 7-point Dirichlet Laplacian (the stencil checked
    first against a dense eigendecomposition at 6 × 5 × 4); PAGERANK and
    the ``PageRankOperator`` on a seed-made link graph of ``PR_PAGES``
    pages, held to a scipy power iteration on the CPU; the other six
    eigensolvers at ``EIG_DIMS`` against the closed-form spectrum, which
    ``scipy.sparse.linalg.eigsh`` confirms at its low end.
    Counts set to 0 just before each solve and read just after.  Returns
    the launches."""
    import scipy.sparse.linalg as sla
    import torch
    from amgx_tpu_torch import operators
    from amgx_tpu_torch.eigen import EigenSolverFactory
    from amgx_tpu_torch.io import poisson7pt, poisson7pt_device
    from amgx_tpu_torch.ops.spmv import spmv
    t_phase = time.perf_counter()
    small = poisson7pt(6, 5, 4).toarray()
    np.testing.assert_allclose(np.linalg.eigvalsh(small),
                               dirichlet_eigs((6, 5, 4)), atol=1e-12)
    side = ITEM7B_SIDE
    A = poisson7pt_device(side, side, side, device_dtype=np.float64,
                          device="cuda")
    t0 = time.perf_counter()
    es = EigenSolverFactory.allocate(amgx.AMGConfig(LOBPCG_CFG))
    es.setup(A)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    reset_counts()
    res = es.solve()
    torch.cuda.synchronize(dev)
    lob_counts = read_counts()
    want = dirichlet_eigs((side,) * 3)[:4]
    got = np.sort(np.asarray(res.eigenvalues))
    lob_err = float(np.max(np.abs(got - want) / want))
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert lob_err <= 1e-6, (got, want)
    assert lob_counts["B1"]["f64.f64"] > 0, lob_counts
    emit("lobpcg_128", n=side ** 3, eigenvalues=got.tolist(),
         closed_form=want.tolist(), max_rel_err=lob_err,
         iterations=res.iterations, setup_s=setup_s,
         solve_s=res.solve_time, counts=lob_counts, card=smi)
    del es, res, A
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    W = link_graph(PR_PAGES)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pr = EigenSolverFactory.allocate(amgx.AMGConfig(PR_CFG))
    pr.setup(amgx.Matrix(W, device="cuda"))
    torch.cuda.synchronize(dev)
    pr_setup_s = time.perf_counter() - t0
    reset_counts()
    pres = pr.solve()
    torch.cuda.synchronize(dev)
    pr_counts = read_counts()
    ranks = pres.eigenvectors[:, 0].astype(np.float64)
    ref, step = pagerank_reference(W, 0.85, 1e-10)
    tol = pr.tolerance
    assert pres.status == amgx.SolveStatus.SUCCESS, pres.status
    assert abs(ranks.sum() - 1.0) <= 1e-5 and (ranks >= 0).all()
    stat = float(np.abs(step(ranks) - ranks).sum())
    vs_ref = float(np.abs(ranks - ref).sum())
    assert stat <= 2 * tol and vs_ref <= 20 * tol, (stat, vs_ref)
    label = amgx.pack_kind(pr.PT)
    assert label in ("ell/window", "ell/binned", "csr/binned"), label
    kern = "B3" if label == "ell/window" else "B4"
    assert pr_counts[kern]["f32.f32"] > 0, pr_counts
    # the operator form: one apply of the ranks returns them
    t0 = time.perf_counter()
    op = operators.PageRankOperator(W, 0.85)
    op_setup_s = time.perf_counter() - t0
    xr = torch.from_numpy(pres.eigenvectors[:, 0].copy()).to(dev)
    reset_counts()
    y = spmv(op, xr)
    torch.cuda.synchronize(dev)
    op_counts = read_counts()
    op_stat = float((y - xr).abs().sum().item())
    assert op_stat <= 2 * tol, op_stat
    assert amgx.pack_kind(op.base) == label
    assert op_counts[kern]["f32.f32"] == 1, op_counts
    emit("pagerank", pages=PR_PAGES, links=int(W.nnz),
         dangling=int((np.diff(W.indptr) == 0).sum()), pack=label,
         kernel=kern, iterations=pres.iterations, graph_s=graph_s,
         setup_s=pr_setup_s, solve_s=pres.solve_time,
         stationarity_l1=stat, vs_scipy_l1=vs_ref, tolerance=tol,
         operator_setup_s=op_setup_s, operator_stationarity_l1=op_stat,
         counts=pr_counts, operator_counts=op_counts, card=smi)
    del pr, op, W, xr, y
    torch.cuda.empty_cache()

    Ah = poisson7pt(*EIG_DIMS)
    spectrum = dirichlet_eigs(EIG_DIMS)
    w_top, w_low = spectrum[-3:], spectrum[:1]
    # scipy's Lanczos on the CPU agrees with the closed form
    w_sa = sla.eigsh(Ah, k=1, which="SA", tol=1e-10)[0]
    assert abs(w_sa[0] - w_low[0]) <= 1e-9 * w_low[0], (w_sa, w_low)
    m = amgx.Matrix(Ah, device="cuda")
    eig_counts, rows = {}, []
    for name, extra, which, rtol in EIG_CASES:
        es = EigenSolverFactory.allocate(amgx.AMGConfig(
            f"config_version=2, eig_solver(e)={name}{extra}"))
        es.setup(m)
        reset_counts()
        r = es.solve()
        torch.cuda.synchronize(dev)
        c = read_counts()
        merge_counts(eig_counts, c)
        lam = np.sort(np.abs(np.asarray(r.eigenvalues)))[::-1]
        ref = {"largest": w_top[-1:], "largest3": w_top[::-1],
               "smallest": w_low}[which]
        err = float(np.max(np.abs(lam[:len(ref)] - np.sort(ref)[::-1])
                           / np.abs(ref).max()))
        rows.append(dict(name=name, eigenvalues=lam.tolist(),
                         iterations=r.iterations, status=int(r.status),
                         max_rel_err=err, limit=rtol,
                         solve_s=r.solve_time,
                         B1=sum(c["B1"].values())))
        assert err <= rtol, rows[-1]
        assert sum(c["B1"].values()) > 0, (name, c)
    emit("eigensolvers_32", dims=list(EIG_DIMS), rows=rows,
         closed_form_top=w_top.tolist(), closed_form_low=w_low.tolist(),
         eigsh_low=w_sa.tolist(), card=smi,
         elapsed_phase_s=time.perf_counter() - t_phase)
    return {"lobpcg_128": lob_counts, "pagerank": pr_counts,
            "eigen_32": eig_counts}


#: phase 39's SIZE_2 hierarchy cut at 5 levels: the K-cycle visits
#: level i 2^i times, and at the aggregation's own 9 levels its CPU twin
#: alone takes half a minute
DENSE_MAX_LEVELS = 5


def binary_dense_phase(amgx, dev, smi, gen) -> dict:
    """Phase 39: the classical 24³ system written with ``write_binary``,
    read back with ``read_system_auto`` and solved on the card, bit-equal
    to the solve of the original matrix; the headline stack with SIZE_2
    aggregation at 24³ (cut at ``DENSE_MAX_LEVELS``) under
    ``AMGX_DENSE_PACK=1`` (set for this phase only): its coarse levels
    pack ``dense`` (B3 over dense rows), its count against the CPU
    port's.  GEO keeps every 24³ level DIA, so the phase names SIZE_2,
    whose coarse levels are scattered.  Returns the launches."""
    import tempfile

    import torch
    from amgx_tpu_torch.io import poisson7pt, read_system_auto, write_binary
    t_phase = time.perf_counter()
    A = poisson7pt(24, 24, 24)
    cfg = CFG_CLA + ", amg:strength_threshold=0.2401"
    rhs = np.random.default_rng(SEED).standard_normal(A.shape[0])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "classical24.bin")
        write_binary(path, A, rhs=rhs)
        data = read_system_auto(path)
    assert abs(data.A - A).max() == 0 and np.array_equal(data.rhs, rhs)
    xs = {}
    for label, M in (("original", A), ("read_back", data.A)):
        m = amgx.Matrix(M, device="cuda")
        m.device_dtype = np.float32
        s_ = amgx.create_solver(cfg)
        s_.setup(m)
        r = s_.solve(data.rhs)
        assert r.status == amgx.SolveStatus.SUCCESS, (label, r.status)
        xs[label] = (r.iterations, r.x)
    bin_equal = bool(torch.equal(xs["original"][1], xs["read_back"][1]))
    assert xs["original"][0] == xs["read_back"][0] and bin_equal

    dense_cfg = HEADLINE_CFG.replace(
        "amg:selector=GEO", "amg:selector=SIZE_2").replace(
        "amg:max_levels=20", f"amg:max_levels={DENSE_MAX_LEVELS}")
    old = os.environ.get("AMGX_DENSE_PACK")
    os.environ["AMGX_DENSE_PACK"] = "1"
    try:
        runs = {}
        for where in ("cuda", "cpu"):
            m = amgx.Matrix(A, device=where)
            m.device_dtype = np.float32
            s_ = amgx.create_solver(dense_cfg)
            s_.setup(m)
            if where == "cuda":
                reset_counts()
            r = s_.solve(np.ones(A.shape[0]))
            if where == "cuda":
                torch.cuda.synchronize(dev)
                dense_counts = read_counts()
            assert r.status == amgx.SolveStatus.SUCCESS, (where, r.status)
            runs[where] = dict(
                iterations=r.iterations, x=r.x.cpu(),
                fmts=[lv.Ad.fmt for lv in s_.preconditioner.hierarchy
                      .levels])
    finally:
        if old is None:
            del os.environ["AMGX_DENSE_PACK"]
        else:
            os.environ["AMGX_DENSE_PACK"] = old
    g, c = runs["cuda"], runs["cpu"]
    assert g["fmts"] == c["fmts"] and "dense" in g["fmts"], g["fmts"]
    assert g["iterations"] == c["iterations"], (g["iterations"],
                                                c["iterations"])
    assert dense_counts["dispatch"].get("dense", 0) > 0, dense_counts
    assert dense_counts["B3"]["f32.f32"] >= \
        dense_counts["dispatch"]["dense"], dense_counts
    dense_equal = bool(torch.equal(g["x"], c["x"]))
    emit("binary_dense", n=A.shape[0], binary_iterations=xs["original"][0],
         binary_x_bit_equal=bin_equal, dense_levels=g["fmts"],
         dense_iterations_card=g["iterations"],
         dense_iterations_cpu=c["iterations"],
         dense_x_bit_equal=dense_equal, counts=dense_counts, card=smi,
         elapsed_phase_s=time.perf_counter() - t_phase)
    return {"dense_pack_24": dense_counts}


def item7b_phases(amgx, dev, smi, gen) -> dict:
    """Phases 36-39 (modes and complex, operators and ``solve_multi``,
    the eigensolvers, binary IO and fmt ``dense``); returns their
    launches by path."""
    paths = modes_complex_phase(amgx, dev, smi, gen)
    paths.update(operators_multi_phase(amgx, dev, smi, gen))
    paths.update(eigen_phase(amgx, dev, smi, gen))
    paths.update(binary_dense_phase(amgx, dev, smi, gen))
    return paths


# --------------------------------------------------------------------------
# phase 40: distribution on one card (ROADMAP item 8a)
# --------------------------------------------------------------------------
#: tests/test_distributed.py:140-148 word for word: FGMRES(20) + SIZE_2
#: aggregation, 12 levels, BLOCK_JACOBI 1+2, DENSE_LU
DIST_CFG = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=20, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=SIZE_2, amg:max_iters=1, amg:max_levels=12, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, amg:presweeps=1, "
    "amg:postsweeps=2, amg:min_coarse_rows=16, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
#: PCG + BLOCK_JACOBI of tests/test_distributed.py:114-129
DIST_PCG_CFG = (
    "config_version=2, solver(s)=PCG, s:max_iters=300, "
    "s:monitor_residual=1, s:tolerance=1e-10, s:convergence=RELATIVE_INI, "
    "s:preconditioner(p)=BLOCK_JACOBI, p:max_iters=3")
#: shards of every distributed run (a 2×2×2 processor grid)
DIST_PARTS = 8
#: the brick a rank owns: 48³ gives 40a's 96³ grid (cut from 128³ for
#: time), 32³ the 64³ consolidation runs (40b), 8³ the 16³
#: card-against-CPU runs
DIST_BRICK = 48
DIST_CONS_BRICK = 32
DIST_SMALL_BRICK = 8
#: 40b's two consolidation triggers.  The legacy pair: with an upper
#: threshold of 8·lower or more every level under ``lower`` rows a rank
#: goes straight to one rank (⌈nc/upper⌉ = 1 for nc < 8·lower), so the
#: upper threshold is 2·lower to show a sub-mesh before the replicated
#: level
DIST_LEGACY = ("matrix_consolidation_lower_threshold=2048, "
               "matrix_consolidation_upper_threshold=4096")
DIST_PLANNER = "dist_agglomerate_min_rows=4096"


def dist_system(brick: int):
    """The distributed 7-point Poisson over a 2×2×2 grid of ``brick``³
    bricks and its rank offsets (host CSR, rank-contiguous rows)."""
    from amgx_tpu_torch.distributed import partition_offsets_from_vector
    from amgx_tpu_torch.io import generate_distributed_poisson_7pt
    A, pv = generate_distributed_poisson_7pt(brick, brick, brick, 2, 2, 2)
    return A, partition_offsets_from_vector(pv, DIST_PARTS)


def dist_matrix(amgx, A, offsets, where, pdt):
    """``A`` uploaded on ``where`` and distributed over 8 shards there."""
    from amgx_tpu_torch.distributed import make_mesh
    m = amgx.Matrix(A, device=where)
    m.device_dtype = pdt
    m.set_distribution(make_mesh(DIST_PARTS, device=where), offsets=offsets)
    return m


def dist_levels(h) -> list:
    """Per level, then the coarsest: the pack format, real and stored
    rows, the active ranks of its shards and of its coarse grid's
    sub-mesh (``submesh_parts``)."""
    from amgx_tpu_torch.distributed.agglomerate import active_parts

    def entry(A, Ad, coarse):
        return dict(fmt=Ad.fmt, rows=A.n_block_rows, stored=Ad.n_rows,
                    active=active_parts(Ad.offsets)
                    if Ad.fmt == "sharded-ell" else 1,
                    coarse_active=coarse)

    return [entry(lv.A, lv.Ad, lv.submesh_parts) for lv in h.levels] + \
        [entry(h.coarsest, h.coarsest.device(), None)]


def dist_solve(amgx, dev, A, offsets, where, pdt, cfg, warm=True):
    """Setup and solve (b = 1) of the distributed ``A``: the solver, the
    first result, the counts of that first solve (card only), a warm
    result, setup seconds and the true relres in f64 on the host."""
    import torch
    t0 = time.perf_counter()
    m = dist_matrix(amgx, A, offsets, where, pdt)
    slv = amgx.create_solver(cfg)
    slv.setup(m)
    setup_s = time.perf_counter() - t0
    b = np.ones(A.shape[0])
    if where == "cuda":
        torch.cuda.synchronize(dev)
        reset_counts()
    res = slv.solve(b)
    counts = None
    if where == "cuda":
        torch.cuda.synchronize(dev)
        counts = read_counts()
    res2 = slv.solve(b) if warm else None
    x = res.x.cpu().numpy()
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    return dict(slv=slv, res=res, res2=res2, counts=counts,
                setup_s=setup_s, relres=relres, x=res.x.cpu())


def sharded_interior_csr(Ad, vals):
    """The interior entries of a stacked sharded pack (halo slots, −1,
    and zeros dropped) as a torch sparse CSR (the cuSPARSE yardstick)."""
    import torch
    cols = Ad.cols
    n, K = cols.shape
    keep = ((vals != 0) & (cols >= 0)).reshape(-1)
    rows = torch.arange(n, device=cols.device).repeat_interleave(K)[keep]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=cols.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, cols.reshape(-1)[keep].long(),
                                   vals.reshape(-1)[keep],
                                   size=(n, Ad.n_cols)), int(keep.sum())


def copy_gbs(dev) -> float:
    """Device-to-device copy rate of 1 GiB (read + write bytes over the
    median time of ``time_ms``)."""
    import torch
    src = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), dev, reps=10, warm=2)
    del src, dst
    return 2 * (1 << 30) / (ms * 1e-3) / 1e9


def sharded_interior_kernel(dev, gen, smi, Ad, errs) -> dict:
    """B3 on the stacked sharded interior of 40a's level 0: held bit
    for bit against ``ell_spmv_reference`` in f32 and f64
    (:func:`check_ell`), then timed: kernel, plain version, cuSPARSE
    CSR of the interior entries, the bound over the pack's slots
    (n·K column and value reads, x read, y written) at the datasheet
    rate and at the copy rate measured in this run."""
    import torch
    from amgx_tpu_torch.ops import ell_spmv as emod
    check_ell(dev, gen, "sharded_interior_level0", Ad.cols,
              Ad.vals.double(), Ad.n_cols, errs, row_len=Ad.row_len)
    gbs = copy_gbs(dev)
    n, K = Ad.cols.shape
    out = {}
    for dt in (torch.float32, torch.float64):
        vals = Ad.vals.to(dt).contiguous()
        x = torch.randn(Ad.n_cols, dtype=dt, device=dev, generator=gen)
        csr, nnz = sharded_interior_csr(Ad, vals)
        ms = time_ms(lambda: emod.ell_spmv(Ad.cols, vals, x, Ad.row_len),
                     dev)
        plain_ms = time_ms(lambda: emod.ell_spmv_reference(Ad.cols, vals,
                                                           x), dev)
        library_ms = time_ms(lambda: csr @ x, dev)
        bound_ms, bound_by = ell_bound(n * K, n, Ad.n_cols, dt)
        nbytes = n * K * (4 + dt.itemsize) + (Ad.n_cols + n) * dt.itemsize
        key = f"{short(dt)}.{short(dt)}"
        out[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        bound_copy_ms=nbytes / (gbs * 1e9) * 1e3)
        emit("sharded_interior_timing", n=n, K=K, n_cols=Ad.n_cols,
             interior_nnz=nnz, type=short(dt), least_bytes=nbytes,
             copy_gbs=gbs, card=smi, **out[key])
        del csr
    return out


def dist_headline_phase(amgx, dev, smi, gen) -> dict:
    """40a: the distributed headline — the 96³ Poisson
    (``generate_distributed_poisson_7pt(48, 48, 48, 2, 2, 2)``,
    ``DIST_BRICK``; cut from 128³ for time) in 8 shards on the card, f64
    pack, ``DIST_CFG`` to 1e-8, its counts set to 0 just before the
    first solve and read just after; B3 on the stacked interior bit for
    bit and timed."""
    import torch
    t_phase = time.perf_counter()
    A, offsets = dist_system(DIST_BRICK)
    torch.empty(1, device=dev)      # the allocator is up before a reset
    torch.cuda.reset_peak_memory_stats(dev)
    r = dist_solve(amgx, dev, A, offsets, "cuda", np.float64, DIST_CFG)
    slv, res, res2, counts = r["slv"], r["res"], r["res2"], r["counts"]
    h = slv.preconditioner.hierarchy
    Ad0 = h.levels[0].Ad
    graph = graph_check(slv.preconditioner, dev, gen)
    wall, dev_s, kern, top = profile_window(lambda: slv.solve(
        np.ones(A.shape[0])))
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    assert r["relres"] <= 1e-8, r["relres"]
    assert Ad0.fmt == "sharded-ell", Ad0.fmt
    disp = counts["dispatch"]
    assert disp.get("sharded/window", 0) > 0 and \
        disp.get("sharded/gather", 0) == 0, disp
    assert counts["B3"]["f64.f64"] >= disp["sharded/window"], counts
    assert not any(counts["declines"].values()), counts
    errs = {}
    timing = sharded_interior_kernel(dev, gen, smi, Ad0, errs)
    emit("dist_headline", n=A.shape[0], shards=DIST_PARTS,
         iterations=res.iterations, status=int(res.status),
         relres=r["relres"], setup_s=r["setup_s"],
         solve_s=res.solve_time, solve_warm_s=res2.solve_time,
         busy_share_of_unprofiled=dev_s / res2.solve_time,
         device_busy_s=dev_s, profiled_wall_s=wall, device_kernels=kern,
         top=top, levels=dist_levels(h),
         halo_entries_level0=Ad0.halo_entries,
         halo_dists_level0=list(Ad0.dists), send_buffer_level0=int(
             Ad0.send_idx.shape[1]),
         boundary_rows_level0=int(Ad0.bnd_rows.numel()),
         counts=counts, amg_graph=graph,
         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=smi,
         elapsed_phase_s=time.perf_counter() - t_phase)
    launches = counts["dispatch"]["sharded/window"]
    del slv, r, h, Ad0
    torch.cuda.empty_cache()
    return dict(counts=counts, timing=timing, errs=errs,
                interior_launches=launches)


def dist_consolidation_phase(amgx, dev, smi) -> dict:
    """40b: the 40a stack at 64³ under the legacy consolidation
    thresholds (``DIST_LEGACY``: a sub-mesh level, then a replicated
    one) and under the agglomeration planner (``DIST_PLANNER``: its
    sub-meshes), each to 1e-8 on the card."""
    import torch
    A, offsets = dist_system(DIST_CONS_BRICK)
    out = {}
    for label, extra in (("legacy", DIST_LEGACY), ("planner", DIST_PLANNER)):
        t_phase = time.perf_counter()
        cfg = DIST_CFG.replace("config_version=2, ",
                               f"config_version=2, {extra}, ")
        r = dist_solve(amgx, dev, A, offsets, "cuda", np.float64, cfg)
        res = r["res"]
        levels = dist_levels(r["slv"].preconditioner.hierarchy)
        sub = [lv["coarse_active"] for lv in levels[:-1]]
        assert res.status == amgx.SolveStatus.SUCCESS, (label, res.status)
        assert r["relres"] <= 1e-8, (label, r["relres"])
        assert any(s is not None and 1 < s < DIST_PARTS for s in sub), \
            (label, sub)
        if label == "legacy":
            assert 1 in sub and any(lv["fmt"] != "sharded-ell"
                                    for lv in levels), (label, levels)
        disp = r["counts"]["dispatch"]
        assert disp.get("sharded/window", 0) > 0 and \
            disp.get("sharded/gather", 0) == 0, disp
        emit("dist_consolidation", trigger=label, config=extra,
             n=A.shape[0], iterations=res.iterations,
             status=int(res.status), relres=r["relres"],
             setup_s=r["setup_s"], solve_s=res.solve_time,
             solve_warm_s=r["res2"].solve_time, levels=levels,
             counts=r["counts"], card=smi,
             elapsed_phase_s=time.perf_counter() - t_phase)
        out[f"dist_consolidation_{label}"] = r["counts"]
        del r
    torch.cuda.empty_cache()
    return out


def dist_card_cpu_phase(amgx, dev, smi) -> dict:
    """40c: card against CPU at 16³ in 8 shards — the 40a stack on an
    f32 pack to 1e-5 (equal counts, x bit-equal) and on an f64 pack to
    1e-8 (equal counts, x to 1e-9); PCG + BLOCK_JACOBI on 8 shards
    against the same on one unsharded card (x to 1e-8 relative,
    ``tests/test_distributed.py:114-129``)."""
    import torch
    t_phase = time.perf_counter()
    A, offsets = dist_system(DIST_SMALL_BRICK)
    cases = {}
    out = {}
    for label, pdt, tol in (("f32", np.float32, "1e-5"),
                            ("f64", np.float64, "1e-8")):
        cfg = DIST_CFG.replace("out:tolerance=1e-8",
                               f"out:tolerance={tol}")
        runs = {w: dist_solve(amgx, dev, A, offsets, w, pdt, cfg,
                              warm=False) for w in ("cuda", "cpu")}
        g, c = runs["cuda"], runs["cpu"]
        assert g["res"].iterations == c["res"].iterations, \
            (label, g["res"].iterations, c["res"].iterations)
        # the f32 solve stops on FGMRES's estimate; its true f32 residual
        # sits at the tolerance (the same status on both devices)
        assert g["res"].status == c["res"].status, label
        assert label == "f32" or \
            g["res"].status == amgx.SolveStatus.SUCCESS, label
        diff = ((g["x"] - c["x"]).norm() / c["x"].norm()).item()
        bit_equal = bool(torch.equal(g["x"], c["x"]))
        if label == "f32":
            assert bit_equal, (label, diff)
        else:
            assert diff <= 1e-9, (label, diff)
        assert [lv["rows"] for lv in dist_levels(
            g["slv"].preconditioner.hierarchy)] == \
            [lv["rows"] for lv in dist_levels(
                c["slv"].preconditioner.hierarchy)]
        cases[label] = dict(iterations=g["res"].iterations,
                            status=int(g["res"].status),
                            relres=g["relres"], x_rel_diff=diff,
                            x_bit_equal=bit_equal, setup_s=g["setup_s"],
                            solve_s=g["res"].solve_time,
                            levels=dist_levels(
                                g["slv"].preconditioner.hierarchy),
                            counts=g["counts"])
        out[f"dist_16_{label}"] = g["counts"]
    # 8 shards against one unsharded card
    dist = dist_solve(amgx, dev, A, offsets, "cuda", np.float64,
                      DIST_PCG_CFG, warm=False)
    m1 = amgx.Matrix(A, device="cuda")
    s1 = amgx.create_solver(DIST_PCG_CFG)
    s1.setup(m1)
    one = s1.solve(np.ones(A.shape[0]))
    x1 = one.x.cpu()
    diff = ((dist["x"] - x1).norm() / x1.norm()).item()
    assert diff <= 1e-8, diff
    assert dist["res"].status == amgx.SolveStatus.SUCCESS
    assert dist["counts"]["dispatch"].get("sharded/window", 0) > 0
    emit("dist_card_vs_cpu", n=A.shape[0], shards=DIST_PARTS, **cases,
         pcg_sharded_vs_one_card=dict(
             iterations_sharded=dist["res"].iterations,
             iterations_one=one.iterations, x_rel_diff=diff,
             relres=dist["relres"], counts=dist["counts"]),
         card=smi, elapsed_phase_s=time.perf_counter() - t_phase)
    out["dist_16_pcg"] = dist["counts"]
    return out


def item8a_phases(amgx, dev, smi, gen) -> dict:
    """Phase 40 (40a, 40b, 40c); returns the launches by path and the
    sharded interior's kernel facts."""
    head = dist_headline_phase(amgx, dev, smi, gen)
    paths = {"dist_headline": head["counts"]}
    paths.update(dist_consolidation_phase(amgx, dev, smi))
    paths.update(dist_card_cpu_phase(amgx, dev, smi))
    return dict(paths=paths, head=head)


# --------------------------------------------------------------------------
# phase 41: distributed classical AMG, colored smoothers and b×b sharded
# packs (ROADMAP item 8b)
# --------------------------------------------------------------------------
#: BASELINE config 4 on the mesh: the SPE10-grid system in 8 shards
#: (equal block-row offsets, the JAX package's default)
DIST4_PARTS = 8
#: 41b's per-rank brick: 48, the 96³ grid (its per-rank host setup at
#: 128³, 61 s on the card's host, would push the smoke past its budget)
DIST_CLA_BRICK = 48
#: the JAX package's distributed classical stack
#: (tests/test_distributed.py:372-380)
CLA_DIST_CFG = (
    "config_version=2, solver(out)=PCG, out:max_iters=60, "
    "out:monitor_residual=1, out:tolerance=1e-10, "
    "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
    "amg:algorithm=CLASSICAL, amg:selector=PMIS, "
    "amg:interpolator={interp}, "
    "amg:max_iters=1, amg:interp_max_elements=4, amg:max_row_sum=0.9, "
    "amg:max_levels=6, amg:smoother(sm)=JACOBI_L1, sm:max_iters=1, "
    "amg:presweeps=1, amg:postsweeps=1, amg:min_coarse_rows=8, "
    "amg:coarse_solver=DENSE_LU_SOLVER, determinism_flag=1")
#: 41c's sharded aggregation AMG with a colored smoother
#: (tests/test_distributed.py:345-370)
DIST_SMOOTHER_CFG = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-5, "
    "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
    "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, amg:max_iters=1, "
    "amg:smoother(sm)={sm}, sm:max_iters=1, amg:presweeps=1, "
    "amg:postsweeps=1, amg:min_coarse_rows=16, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
#: 41c's solver names on a sharded pack: PCG + a smoother, or the name
#: as the outer solver (tolerance 1e-5: the f32 pack is unrefinable)
DIST_NAME_BASE = ("config_version=2, solver(s)={s}, s:max_iters=100, "
                  "s:monitor_residual=1, s:tolerance=1e-5, "
                  "s:convergence=RELATIVE_INI{extra}")
DIST_NAMES = {
    "PCGF": ("PCGF", ""), "PCG_CA": ("PCG_CA", ""),
    "PCG_PIPE": ("PCG_PIPE", ""), "IDR": ("IDR", ""),
    "IDRMSYNC": ("IDRMSYNC", ""), "NOSOLVER": ("NOSOLVER", ""),
    "krylov_comm_CA": ("PCG", ", s:krylov_comm=CA"),
    "krylov_comm_PIPELINED": ("PCG", ", s:krylov_comm=PIPELINED"),
}
for _p in ("CHEBYSHEV", "CHEBYSHEV_POLY", "POLYNOMIAL", "KPZ_POLYNOMIAL",
           "CF_JACOBI", "NOSOLVER"):
    DIST_NAMES[f"pre_{_p}"] = (
        "PCG", f", s:preconditioner(p)={_p}, p:max_iters=2")
#: the IDR solves' s × s systems are library calls: they run on an f64
#: pack, counts equal and x to 1e-9, not bit-equal (in f32 IDRMSYNC's
#: 16³ solve stops on a breakdown with x parted by 5e-4)
DIST_NOT_BITWISE = ("IDR", "IDRMSYNC")


def dist4_matrix(amgx, A, where, pdt):
    """The config-4 system uploaded on ``where`` as 4×4 blocks and
    distributed over ``DIST4_PARTS`` equal block-row shards there."""
    from amgx_tpu_torch.distributed import make_mesh
    m = amgx.Matrix(A, block_dim=4, device=where)
    m.device_dtype = pdt
    m.set_distribution(make_mesh(DIST4_PARTS, device=where))
    return m


def count_exchanges(fn) -> int:
    """Calls of the halo exchange (``distributed.matrix._exchange``)
    that ``fn()`` makes."""
    from amgx_tpu_torch.distributed import matrix as tdm
    orig = tdm._exchange
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    tdm._exchange = counted
    try:
        fn()
    finally:
        tdm._exchange = orig
    return calls[0]


def dist_config4_phase(amgx, dev, smi, gen, A, single_iters,
                       grid=(60, 220, 85)) -> dict:
    """41a: BASELINE config 4 on the mesh at full size — phase 13's
    SPE10-grid system (reused) in 8 shards, an f64 sharded pack of 4×4
    blocks (unrefinable), ``CFG4`` to 1e-8: every SpMV
    ``sharded/block-binned`` (the halo exchange, one B5 launch over the
    stacked block interior, the boundary blocks), the DILU applies with
    no halo exchange; counts set to 0 just before the first solve and
    read just after."""
    import torch
    t_phase = time.perf_counter()
    torch.empty(1, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    m = dist4_matrix(amgx, A, "cuda", np.float64)
    Ad = m.device()
    pack_s = time.perf_counter() - t0
    slv = amgx.create_solver(CFG4)
    slv.setup(m)
    setup_s = time.perf_counter() - t0
    b = np.ones(A.shape[0])
    torch.cuda.synchronize(dev)
    reset_counts()
    res = slv.solve(b)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    res2 = slv.solve(b)
    x = res.x.cpu().numpy()
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    assert relres <= 1e-8, relres
    assert Ad.fmt == "sharded-ell" and Ad.block_dim == 4
    disp = counts["dispatch"]
    assert disp.get("sharded/block-binned", 0) > 0 and \
        disp.get("sharded/block-plain", 0) == 0, disp
    assert counts["B5s"]["f64.f64"] == disp["sharded/block-binned"], counts
    assert not any(counts["declines"].values()), counts
    pre = slv.preconditioner
    r = torch.randn(Ad.n, dtype=torch.float64, device=dev, generator=gen)
    exchanges = count_exchanges(lambda: pre._apply_dilu(r))
    assert exchanges == 0, exchanges
    from amgx_tpu_torch.ops.spmv import spmv
    spmv_exchanges = count_exchanges(lambda: spmv(Ad, r))
    assert spmv_exchanges == 1, spmv_exchanges
    wall, dev_s, kern, top = profile_window(lambda: slv.solve(b))
    emit("dist_config4", grid=list(grid), unknowns=A.shape[0],
         block_rows=A.shape[0] // 4, stored_blocks=A.nnz // 16,
         shards=DIST4_PARTS, n_loc=Ad.n_loc, iterations=res.iterations,
         single_card_iterations_phase13=single_iters,
         status=int(res.status), relres_f64=relres, pack_s=pack_s,
         setup_s=setup_s, solve_s=res.solve_time,
         solve_warm_s=res2.solve_time, colors=pre.num_colors,
         busy_share_of_unprofiled=dev_s / res2.solve_time,
         device_busy_s=dev_s, profiled_wall_s=wall, device_kernels=kern,
         top=top, halo_block_entries=Ad.halo_entries,
         halo_dists=list(Ad.dists), boundary_rows=int(Ad.bnd_rows.numel()),
         b5_launches_stacked=counts["B5s"], b5_launches_single_pack=counts[
             "B5"], exchanges_per_dilu_apply=exchanges,
         exchanges_per_spmv=spmv_exchanges, amg_graphs=0, counts=counts,
         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=smi,
         elapsed_phase_s=time.perf_counter() - t_phase)
    iterations = res.iterations
    del slv, res, res2, pre
    return dict(counts=counts, Ad=Ad, m=m, iterations=iterations)


def stacked_interior_bsr(Ad):
    """The stacked block interior's blocks (halo blocks and zero blocks
    dropped) as a host BSR over the flat P·n_loc block columns — the
    cuSPARSE yardstick's operand — and its stored block count."""
    import scipy.sparse as sp
    cols = Ad.cols.cpu().numpy()
    vals = Ad.vals.double().cpu().numpy()
    n, K = cols.shape
    keep = (cols >= 0) & (np.abs(vals).reshape(n, K, -1).max(axis=2) != 0)
    rows = np.repeat(np.arange(n), K).reshape(n, K)[keep]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                        minlength=n))])
    b = Ad.block_dim
    return sp.bsr_matrix((vals[keep], cols[keep], indptr),
                         shape=(n * b, n * b)), int(keep.sum())


def stacked_b5_kernel(dev, gen, smi, Ad) -> dict:
    """41d: B5 over 41a's stacked level-0 interior held bit for bit
    against ``binned_compact_reference`` in f32 and f64, then timed
    (median of 30): kernel, plain version, cuSPARSE BSR of the same
    interior blocks, the bound over the interior's stored blocks at the
    datasheet rate and at the copy rate measured in this run."""
    import torch
    from amgx_tpu_torch.ops import binned_spmv as bmod
    I = Ad.interior
    bsr, nnzb = stacked_interior_bsr(Ad)
    b = Ad.block_dim
    n = Ad.n_rows
    gbs = copy_gbs(dev)
    out, errs = {}, {}
    for dt in (torch.float32, torch.float64):
        cp = I.compact.astype(dt)
        x = torch.randn(n * b, dtype=dt, device=dev, generator=gen)
        before = bmod.launch_count("B5-stacked")
        y = bmod.compact_spmv(cp, I.pos, I.row_of_pos, I.dims, x)
        torch.cuda.synchronize(dev)
        assert bmod.launch_count("B5-stacked") == before + 1
        ref = bmod.binned_compact_reference(cp, I.pos, I.dims, x)
        assert torch.isfinite(y).all().item()
        bit_equal = bool(torch.equal(y, ref))
        assert bit_equal, short(dt)
        diff = (y - ref).abs().max().item()
        record(errs, f"{short(dt)}.{short(dt)}", diff, 0.0)
        lib = bsr_of_pack(bsr, dt, dev)
        ms = time_ms(lambda: bmod.compact_spmv(cp, I.pos, I.row_of_pos,
                                               I.dims, x), dev)
        plain_ms = time_ms(lambda: bmod.binned_compact_reference(
            cp, I.pos, I.dims, x), dev)
        try:
            library_ms = time_ms(lambda: lib @ x, dev)
        except (RuntimeError, NotImplementedError):
            library_ms = None
        bound_ms, bound_by = binned_bound(nnzb, b, n, n, dt, dt)
        nbytes = nnzb * (4 + b * b * dt.itemsize) + 2 * n * b * dt.itemsize
        key = f"{short(dt)}.{short(dt)}"
        out[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        bound_copy_ms=nbytes / (gbs * 1e9) * 1e3)
        emit("stacked_b5_timing", block_rows=n, stored_blocks=nnzb,
             compact_slots=int(cp.codes.numel()), type=short(dt),
             bit_equal=bit_equal, least_bytes=nbytes, copy_gbs=gbs,
             card=smi, **out[key])
        del lib, cp
    return dict(timing=out, errs=errs)


def dist_classical_phase(amgx, dev, smi, gen) -> dict:
    """41b: BASELINE config 2 on the mesh — the 96³ Poisson of
    ``generate_distributed_poisson_7pt(48, 48, 48, 2, 2, 2)`` in 8 shards
    (``DIST_CLA_BRICK``, cut from 128³ for time),
    f64 pack, ``CFG_CLA`` word for word: every level ``classical-dist``
    (per-rank strength, PMIS, D2 and RAP), no global assembly above n/4
    rows (``Matrix.assemble_global`` spied), counts set to 0 just before
    the first solve and read just after."""
    import torch
    from amgx_tpu_torch.amg.device_setup import engine_stats, reset_engine
    t_phase = time.perf_counter()
    A, offsets = dist_system(DIST_CLA_BRICK)
    n = A.shape[0]
    assembled = []
    orig = amgx.Matrix.assemble_global

    def spy(self):
        assembled.append(self.shape[0])
        return orig(self)

    amgx.Matrix.assemble_global = spy
    try:
        reset_engine()
        torch.cuda.reset_peak_memory_stats(dev)
        r = dist_solve(amgx, dev, A, offsets, "cuda", np.float64, CFG_CLA)
    finally:
        amgx.Matrix.assemble_global = orig
    slv, res, res2, counts = r["slv"], r["res"], r["res2"], r["counts"]
    h = slv.preconditioner.hierarchy
    kinds = [s_[0] for s_ in h._structure]
    assert kinds and all(k == "classical-dist" for k in kinds), kinds
    assert not assembled or max(assembled) <= n // 4, assembled
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    assert r["relres"] <= 1e-8, r["relres"]
    disp = counts["dispatch"]
    assert disp.get("sharded/window", 0) > 0 and \
        disp.get("sharded/gather", 0) == 0, disp
    assert not any(counts["declines"].values()), counts
    graph = graph_check(slv.preconditioner, dev, gen)
    wall, dev_s, kern, top = profile_window(lambda: slv.solve(np.ones(n)))
    eng = engine_stats() or {}
    Ad0 = h.levels[0].Ad
    emit("dist_classical", n=n, shards=DIST_PARTS, config="CFG_CLA",
         iterations=res.iterations, status=int(res.status),
         relres=r["relres"], setup_s=r["setup_s"],
         setup_split_s=dict(h.dist_timings),
         engine=dict(dist_runs=eng.get("dist_runs"), hits=eng.get("hits"),
                     builds=eng.get("builds"),
                     declines=eng.get("declines")),
         solve_s=res.solve_time, solve_warm_s=res2.solve_time,
         busy_share_of_unprofiled=dev_s / res2.solve_time,
         device_busy_s=dev_s, profiled_wall_s=wall, device_kernels=kern,
         top=top, levels=dist_levels(h), structure=kinds,
         assembled_rows=assembled, b3_launches=counts["B3"],
         counts=counts, amg_graph=graph,
         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=smi,
         elapsed_phase_s=time.perf_counter() - t_phase)
    del slv, r, h, Ad0
    torch.cuda.empty_cache()
    return dict(counts=counts)


def dist_item8b_card_cpu_phase(amgx, dev, smi) -> dict:
    """41c: card against CPU at small size, 8 shards: classical-dist D1
    and D2 at 16³ (f32: equal counts, x bit-equal; f64: x to 1e-9);
    config 4 on a 12×12×12 SPE10 grid (f32 and f64, and against one
    unsharded pack in f64: counts within 8, as the JAX package's test
    allows); the colored smoothers and Kaczmarz in sharded aggregation
    AMG at 16³; every newly distributed solver name at 16³; a resetup
    and ``amg_host_levels_rows`` on a distributed classical hierarchy."""
    import torch
    from amgx_tpu_torch.io import spe10_block_system
    t_phase = time.perf_counter()
    A, offsets = dist_system(DIST_SMALL_BRICK)
    n = A.shape[0]
    out, facts = {}, {}

    def pair(label, cfg, pdt, bitwise, make=None, rhs=n, post=None):
        runs = {}
        for w in ("cuda", "cpu"):
            m = make(w) if make else dist_matrix(amgx, A, offsets, w, pdt)
            s_ = amgx.create_solver(cfg)
            s_.setup(m)
            if post is not None:
                post(s_, m)
            if w == "cuda":
                torch.cuda.synchronize(dev)
                reset_counts()
            rr = s_.solve(np.ones(rhs))
            if w == "cuda":
                torch.cuda.synchronize(dev)
                out[label] = read_counts()
            runs[w] = (rr, s_)
        (g, sg), (c, sc) = runs["cuda"], runs["cpu"]
        xg, xc = g.x.cpu().double(), c.x.double()
        diff = ((xg - xc).norm() / xc.norm()).item()
        be = bool(torch.equal(g.x.cpu(), c.x))
        f = dict(iterations_card=g.iterations, iterations_cpu=c.iterations,
                 status=int(g.status), x_rel_diff=diff, x_bit_equal=be)
        facts[label] = f
        assert g.iterations == c.iterations, (label, f)
        assert g.status == c.status, (label, f)
        if bitwise:
            assert be, (label, f)
        else:
            assert diff <= (1e-9 if pdt == np.float64 else SMALL_X_RTOL), \
                (label, f)
        return sg, sc

    for interp in ("D1", "D2"):
        cfg = CLA_DIST_CFG.format(interp=interp)
        for label, pdt, tol in (("f32", np.float32, "1e-5"),
                                ("f64", np.float64, "1e-10")):
            sg, _ = pair(f"classical_dist_{interp}_{label}",
                         cfg.replace("out:tolerance=1e-10",
                                     f"out:tolerance={tol}"),
                         pdt, label == "f32")
            kinds = [k[0] for k in sg.preconditioner.hierarchy._structure]
            assert all(k == "classical-dist" for k in kinds), kinds
    # config 4 on a 12×12×12 SPE10 grid in 8 shards
    A4 = spe10_block_system(12, 12, 12)
    for label, pdt, tol in (("f32", np.float32, "1e-5"),
                            ("f64", np.float64, "1e-8")):
        pair(f"config4_12_{label}", CFG4.replace(
            "out:tolerance=1e-8", f"out:tolerance={tol}"), pdt,
            label == "f32",
            make=lambda w, pdt=pdt: dist4_matrix(amgx, A4, w, pdt),
            rhs=A4.shape[0])
    one = amgx.Matrix(A4, block_dim=4, device="cuda")
    one.device_dtype = np.float64
    s1 = amgx.create_solver(CFG4)
    s1.setup(one)
    it1 = s1.solve(np.ones(A4.shape[0])).iterations
    itd = facts["config4_12_f64"]["iterations_card"]
    facts["config4_12_one_pack_f64"] = dict(iterations=it1,
                                            sharded_iterations=itd)
    assert itd <= it1 + 8, (itd, it1)
    # the colored smoothers in sharded aggregation AMG
    for sm in ("MULTICOLOR_GS", "GS", "FIXCOLOR_GS", "KACZMARZ",
               "MULTICOLOR_DILU"):
        pair(f"smoother_{sm}", DIST_SMOOTHER_CFG.format(sm=sm), np.float32,
             True)
    # every newly distributed solver name
    for label, (solver, extra) in DIST_NAMES.items():
        bitwise = label not in DIST_NOT_BITWISE
        pair(f"name_{label}", DIST_NAME_BASE.format(s=solver, extra=extra),
             np.float32 if bitwise else np.float64, bitwise)
    # a resetup (a fresh setup; the graphs captured anew) and host levels
    cla = CLA_DIST_CFG.format(interp="D2").replace(
        "out:tolerance=1e-10", "out:tolerance=1e-5")

    def resetup(s_, m):
        s_.solve(np.ones(n))
        s_.resetup(m)
        assert s_.preconditioner.hierarchy.last_resetup == "fresh"

    sg, _ = pair("resetup_classical_dist", cla, np.float32, True,
                 post=resetup)
    facts["resetup_classical_dist"]["rebind"] = dict(
        kept=sg.preconditioner.rebind["graphs_kept"],
        dropped=sg.preconditioner.rebind["graphs_dropped"])
    assert sg.preconditioner.rebind["graphs_dropped"] >= 1
    sg, _ = pair("host_levels_classical_dist",
                 cla + ", amg:amg_host_levels_rows=256", np.float32, True)
    h = sg.preconditioner.hierarchy
    facts["host_levels_classical_dist"]["host_from"] = h.host_from
    assert h.host_from < h.num_levels(), h.host_from
    emit("dist_item8b_card_vs_cpu", n=n, shards=DIST_PARTS, cases=facts,
         card=smi, elapsed_phase_s=time.perf_counter() - t_phase)
    return out


def item8b_phases(amgx, dev, smi, gen, A4, single_iters) -> dict:
    """Phase 41 (41a, 41d, 41b, 41c); returns the launches by path and
    the stacked B5 kernel's facts."""
    import torch
    head = dist_config4_phase(amgx, dev, smi, gen, A4, single_iters)
    b5 = stacked_b5_kernel(dev, gen, smi, head.pop("Ad"))
    del head["m"]
    torch.cuda.empty_cache()
    paths = {"dist_config4": head["counts"]}
    cla = dist_classical_phase(amgx, dev, smi, gen)
    paths["dist_classical"] = cla["counts"]
    paths.update(dist_item8b_card_cpu_phase(amgx, dev, smi))
    return dict(paths=paths, b5=b5)


# --------------------------------------------------------------------------
# phase 42: telemetry on the card
#: the knobs phase 42 turns on (unscoped: every solver of the stack reads
#: them); ``telemetry_path`` is added per run
TELEMETRY_KNOBS = ", telemetry=1, setup_profile=1, memledger=1, " \
    "memledger_sample_s=0"
#: the side of phase 42's forensics run (the headline stack)
FORENSICS_SIDE = 64
#: warm solves with the recorder off and on, alternated, in phase 42
TELEMETRY_AB_ROUNDS = 5


def graph_of(slv):
    """The preconditioner's one CUDA graph."""
    (g,), = [list(slv.preconditioner.graphs.values())]
    return g


def telemetry_headline(amgx, dev, smi, side, extra):
    """The headline stack at ``side``³ (f32 pack, f64 refinement) with
    the config suffix ``extra``: the solver, the first solve's result
    (its first application captures the graph) and a warm solve's."""
    import torch
    from amgx_tpu_torch.io import poisson7pt_device
    A = poisson7pt_device(side, side, side, device_dtype=np.float32,
                          device="cuda")
    t0 = time.perf_counter()
    slv = amgx.create_solver(HEADLINE_CFG + extra)
    slv.setup(A)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    b = torch.ones(side ** 3, dtype=torch.float64, device=dev)
    res = slv.solve(b)
    warm = slv.solve(b)
    return dict(slv=slv, A=A, b=b, res=res, warm=warm, setup_s=setup_s)


def kcycle_visits(h) -> int:
    """Level visits of one application of the CG K-cycle: level 0 once,
    level i ≥ 1 cycle_iters^i times."""
    return sum(max(h.cycle_iters, 1) ** i for i in range(len(h.levels)))


def telemetry_phase(amgx, dev, smi, head_iters, head_x=None,
                    head_nodes=None) -> dict:
    """Phase 42: the headline 128³ with ``telemetry``, ``setup_profile``
    and ``memledger`` on against the same solve with them off (equal
    counts, x bit-equal, the graph's node count unchanged); the device
    anatomy of a graphed warm solve (identity, ≥ 90 % attributed, the
    levels' sum against the AMG application's time, B1 under
    ``spmv/dia_kernel`` against its kernel sum); the memory ledger's
    invariant; the setup profile by level; the JSONL, Chrome trace and
    doctor; ``forensics`` at 64³; ``dist/halo_exchange`` on 40c's
    sharded stack.  ``head_x`` / ``head_nodes``: phase 5's x and graph
    node count (the same solve with telemetry off); without them the
    phase runs that solve itself.  Returns the launches of its
    solves."""
    import tempfile
    import torch
    from amgx_tpu_torch import telemetry
    from amgx_tpu_torch.ops import spmv as smod
    from amgx_tpu_torch.telemetry import (costmodel, deviceprof,
                                          memledger, setup_profile)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="amgx_tel_")
    out = {}

    # ---- telemetry off: the reference solve (phase 5's in the smoke)
    if head_x is None:
        off = telemetry_headline(amgx, dev, smi, 128, "")
        head_nodes = graph_of(off["slv"]).stats["nodes"]
        head_x = off["res"].x.clone()
        del off
        torch.cuda.empty_cache()
    nodes_off, x_off = head_nodes, head_x

    # ---- telemetry on
    telemetry.reset()
    path = os.path.join(tmp, "headline.jsonl")
    reset_counts()
    on = telemetry_headline(amgx, dev, smi, 128, TELEMETRY_KNOBS
                            + f", telemetry_path={path}")
    out["telemetry_headline"] = read_counts()
    slv, res = on["slv"], on["res"]
    assert res.iterations == head_iters, (res.iterations, head_iters)
    assert torch.equal(res.x, x_off), "telemetry changed x"
    nodes_on = graph_of(slv).stats["nodes"]
    assert nodes_on == nodes_off, (nodes_on, nodes_off)
    recs = telemetry.records()
    # the setup profile: phases by level against the setup's wall time
    prof = telemetry.setup_profile.analyze(recs)
    by_level = {}
    for ph in prof["phases"]:
        key = f"L{ph['level']}" if ph["level"] is not None else "-"
        by_level.setdefault(key, {})[ph["component"]] = ph["self_s"]
    ledger_setup = [r["attrs"] for r in recs if r["kind"] == "event"
                    and r["name"] == "hbm_snapshot"
                    and r["attrs"]["phase"] == "setup"][-1]

    # ---- the anatomy of one graphed warm solve
    trace = os.path.join(tmp, "warm_solve.trace.json")
    names = {}
    bytes0 = dict(smod.MODEL_BYTES)
    wall, busy_s, n_kern, top = profile_window(
        lambda: slv.solve(on["b"]), trace_path=trace, by_name=names)
    model_bytes = {k: v - bytes0.get(k, 0)
                   for k, v in smod.MODEL_BYTES.items() if v != bytes0[k]}
    peak = costmodel.measured_peak_gbs(dev)
    an = deviceprof.measure_anatomy(trace, pack_bytes_total=model_bytes,
                                    peak_gbs=peak)
    deviceprof.emit(an)
    emit("telemetry_anatomy_graphs", graphs=an["graphs"])
    total, attr = an["total_device_s"], an["attributed_s"]
    assert abs(attr + an["unattributed_s"] - total) <= 1e-6 * max(total,
                                                                  1e-9)
    # every graph launch maps onto its capture's nodes (one the profile
    # caught mid-launch, on the nodes its recorded kernels match)
    assert an["graphs"]["graph_launches"] > 0 and \
        an["graphs"]["graph_launches_mapped"] == \
        an["graphs"]["graph_launches"], an["graphs"]
    assert attr >= 0.9 * total, (attr, total)
    precond = an["scopes"].get("amgx/krylov/precond", 0.0)
    level_sum = sum(lv.get("total_s", 0.0) for lv in an["levels"].values()) \
        + an["coarse_s"]
    assert abs(level_sum - precond) <= 0.10 * precond, (level_sum, precond)
    b1_sum = sum(ns for k, (ns, _) in names.items() if "dia_spmv" in k) / 1e9
    b1_scoped = an["spmv"].get("dia/kernel", {}).get("device_s", 0.0)
    assert abs(b1_scoped - b1_sum) <= 0.05 * b1_sum, (b1_scoped, b1_sum)
    top_scopes = []
    for s_, sec in deviceprof.top_scopes(an, 8):
        row = dict(scope=s_, device_s=sec)
        if s_.startswith("amgx/spmv/"):
            d = an["spmv"][s_[len("amgx/spmv/"):]]
            row.update({k: d[k] for k in ("modelled_bytes", "measured_gbs",
                                          "roofline_fraction") if k in d})
            if "modelled_bytes" in d:
                row["published_fraction"] = d["measured_gbs"] * 1e9 \
                    / peak_bytes_per_s()
        top_scopes.append(row)
    # telemetry's cost: warm solves of this solver (its graph captured
    # under telemetry) with the recorder off and on, alternated
    warm = {"off": [], "on": []}
    for _ in range(TELEMETRY_AB_ROUNDS):
        for state in ("off", "on"):
            (telemetry.disable if state == "off" else telemetry.enable)()
            warm[state].append(slv.solve(on["b"]).solve_time)
    med = {k: sorted(v)[len(v) // 2] for k, v in warm.items()}

    # ---- the memory ledger after the solve
    snap = memledger.snapshot()
    for snp in (ledger_setup, snap):
        for dname, d in snp["devices"].items():
            assert d["accounted_bytes"] + d["unaccounted_bytes"] \
                == d["bytes_in_use"], (dname, d)
    assert snap["measured"] and snap["devices"]["cuda:0"]["accounted_bytes"] \
        > 0, snap["devices"]
    telemetry.flush_jsonl(path)

    # ---- the exporters and the doctor
    with open(path) as f:
        n_jsonl = telemetry.validate_jsonl(f)
    ctrace = os.path.join(tmp, "headline.chrome.json")
    n_ev = telemetry.write_chrome_trace(ctrace, path)
    with open(ctrace) as f:
        telemetry.validate_chrome_trace(json.load(f))
    import contextlib
    import io
    from amgx_tpu_torch.telemetry import doctor
    doc_out = io.StringIO()
    with contextlib.redirect_stdout(doc_out):
        doc_rc = doctor.main([path])
    assert doc_rc == 0, doc_rc
    emit("telemetry_headline", n=128 ** 3, iterations=res.iterations,
         x_bit_equal_off=True, graph_nodes=nodes_on,
         graph_nodes_off=nodes_off, setup_s=on["setup_s"],
         warm_solve_s_off=med["off"], warm_solve_s_on=med["on"],
         telemetry_cost_s=med["on"] - med["off"], warm_rounds=warm,
         anatomy=dict(total_device_s=total, attributed_s=attr,
                      attributed_share=attr / total,
                      precond_s=precond, levels_plus_coarse_s=level_sum,
                      levels={k: v.get("total_s") for k, v in
                              an["levels"].items()},
                      coarse_s=an["coarse_s"], b1_scoped_s=b1_scoped,
                      b1_kernel_sum_s=b1_sum, graphs=an["graphs"],
                      krylov=an["krylov"], smoothers=an["smoothers"],
                      copy_peak_gbs=peak),
         top_scopes=top_scopes, profiled_wall_s=wall, device_busy_s=busy_s,
         device_kernels=n_kern,
         ledger=dict(setup=ledger_setup["devices"],
                     solve={k: {kk: vv for kk, vv in v.items()
                                if kk != "owners"}
                            for k, v in snap["devices"].items()},
                     top_owners=memledger.top_owners(snap, 6),
                     max_memory_allocated=torch.cuda.max_memory_allocated(
                         dev)),
         setup_profile=dict(wall_s=prof["total_s"], by_level=by_level,
                            summary=prof["summary"]),
         jsonl_records=n_jsonl, chrome_events=n_ev,
         doctor_lines=len(doc_out.getvalue().splitlines()), card=smi)
    del on, slv, res
    torch.cuda.empty_cache()
    telemetry.reset()

    # ---- forensics at 64³: off, then on (x bit-equal)
    side = FORENSICS_SIDE
    f_off = telemetry_headline(amgx, dev, smi, side, "")
    telemetry.reset()
    reset_counts()
    with telemetry.capture(ring_size=1 << 20) as cap:
        f_on = telemetry_headline(amgx, dev, smi, side,
                                  ", telemetry=1, forensics=1")
    out["telemetry_forensics"] = read_counts()
    assert f_on["res"].iterations == f_off["res"].iterations
    assert torch.equal(f_on["res"].x, f_off["res"].x), \
        "forensics changed x"
    h = f_on["slv"].preconditioner.hierarchy
    n_apps = f_on["res"].iterations + f_on["warm"].iterations
    per_app = kcycle_visits(h)
    n_level = len(cap.events("cycle_level"))
    assert n_level == n_apps * per_app, (n_level, n_apps, per_app)
    anat = telemetry.forensics.cycle_anatomy(cap.records)
    emit("telemetry_forensics", n=side ** 3,
         iterations=f_on["res"].iterations, cycle_level_events=n_level,
         applications=n_apps, visits_per_application=per_app,
         cycle_coarse_events=len(cap.events("cycle_coarse")),
         x_bit_equal_off=True, reduction_factors=anat,
         graph_nodes_off=graph_of(f_off["slv"]).stats["nodes"],
         graph_nodes_on=graph_of(f_on["slv"]).stats["nodes"], card=smi)
    del f_on, f_off, h
    telemetry.disable()
    torch.cuda.empty_cache()

    # ---- dist/halo_exchange on 40c's sharded stack (16³, 8 shards)
    A, offsets = dist_system(DIST_SMALL_BRICK)
    telemetry.reset()
    cfg = DIST_CFG.replace("out:tolerance=1e-8", "out:tolerance=1e-5") \
        + ", telemetry=1"
    d = dist_solve(amgx, dev, A, offsets, "cuda", np.float32, cfg,
                   warm=False)
    trace2 = os.path.join(tmp, "dist.trace.json")
    profile_window(lambda: d["slv"].solve(np.ones(A.shape[0])),
                   trace_path=trace2)
    an2 = deviceprof.measure_anatomy(trace2, peak_gbs=peak)
    halo_s = an2["dist"].get("halo_exchange", 0.0)
    assert halo_s > 0, an2["dist"]
    out["telemetry_dist_16"] = d["counts"]
    emit("telemetry_dist", n=A.shape[0], shards=DIST_PARTS,
         iterations=d["res"].iterations, halo_exchange_s=halo_s,
         total_device_s=an2["total_device_s"],
         attributed_share=an2["attributed_s"]
         / max(an2["total_device_s"], 1e-12), card=smi)
    del d
    telemetry.disable()
    setup_profile.disable()
    memledger.disable()
    telemetry.reset()
    torch.cuda.empty_cache()
    emit("telemetry_phase", elapsed_phase_s=time.perf_counter() - t_phase,
         card=smi)
    return out


# phase 43: serving on the card
#: the service's knobs on top of the headline stack (metrics_port is
#: added per run: a free port)
SERVE_KNOBS = (", telemetry=1, serve_batch_window_ms=20, "
               "serve_max_batch=16, serve_queue_depth=64")
#: the served wave: right-hand sides of the 128³ headline matrix, of
#: its drifted values (one drift, ``drift_values`` k = 1) and of a second
#: pattern (64³), submitted from ``SERVE_CLIENTS`` threads
SERVE_SAME, SERVE_DRIFT, SERVE_OTHER = 16, 4, 2
SERVE_CLIENTS = 4
SERVE_SIDE, SERVE_OTHER_SIDE = 128, 64
#: the warm-start children: the DFG at this ny under the headline
#: config with SIZE_2 named (its 3 levels of 4096 rows and more take the
#: setup engine's aggregation plans; GEO takes no engine plan on it), cut
#: at 5 levels (a K-cycle of 16 deepest visits: a short capture)
SERVE_STORE_NY = 64
SERVE_STORE_CFG = HEADLINE_CFG.replace(
    "amg:selector=GEO", "amg:selector=SIZE_2").replace(
    "amg:max_levels=20", "amg:max_levels=5")
SERVE_WAIT_S = 120.0


def serve_child(cache_dir: str, store_dir: str, fault: str,
                out_path: str) -> int:
    """One warm-start child (``python3 chip_smoke.py --serve-child CACHE
    STORE FAULT OUT``): the DFG at ``SERVE_STORE_NY`` (``SERVE_STORE_CFG``,
    f32 pack) set up and solved
    on the card with ``compile_cache_dir`` / ``aot_store_dir`` (and the
    fault plan ``fault``, or ``-``), telemetry on; writes its kernel
    builds, store traffic, fallbacks, setup seconds, count and x."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch import native, telemetry
    from amgx_tpu_torch.amg.device_setup import engine_stats
    from amgx_tpu_torch.serve import aot
    t_start = time.perf_counter()
    A = amgx.io.dfg_cylinder_pressure(SERVE_STORE_NY)
    knobs = f", compile_cache_dir={cache_dir}, aot_store_dir={store_dir}"
    if fault != "-":
        knobs += f", fault_inject={fault}"
    telemetry.reset()
    with telemetry.capture(ring_size=1 << 20) as cap:
        m = amgx.Matrix(A, device="cuda")
        m.device_dtype = np.float32
        t0 = time.perf_counter()
        slv = amgx.create_solver(SERVE_STORE_CFG + knobs)
        slv.setup(m)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        res = slv.solve(np.ones(A.shape[0]))
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    np.save(out_path + ".npy", res.x.cpu().numpy())
    with open(out_path, "w") as f:
        json.dump(dict(
            builds=native.build_stats(), store=aot.store_stats(),
            engine=engine_stats(), setup_s=setup_s,
            process_s=time.perf_counter() - t_start,
            iterations=res.iterations,
            aot_misses=telemetry.registry().get_counter(
                "amgx_compile_cache_misses_total", layer="aot"),
            aot_hits=telemetry.registry().get_counter(
                "amgx_compile_cache_hits_total", layer="aot"),
            fallbacks=[e["attrs"]["reason"] for e in
                       cap.events("compile_cache_fallback")]), f)
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, timeout: float = 60.0):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serve_hosts():
    """The served wave's host systems: the headline 128³ CSR with its
    DIA attach, its drifted values (``drift_values`` k = 1, the same
    pattern) and the 64³ second pattern."""
    from amgx_tpu_torch.io import poisson7pt
    host = poisson7pt(SERVE_SIDE, SERVE_SIDE, SERVE_SIDE)
    return host, drift_values(host, 1), poisson7pt(
        SERVE_OTHER_SIDE, SERVE_OTHER_SIDE, SERVE_OTHER_SIDE)


def serve_matrices(amgx, hosts):
    """Fresh matrix handles (f32 packs on the card) of ``serve_hosts``:
    the headline, its drifted values, the second pattern."""
    host, drift, other = hosts
    m = amgx.Matrix(host, device="cuda")
    md = amgx.Matrix(host, device="cuda")
    md.replace_coefficients(drift)
    mo = amgx.Matrix(other, device="cuda")
    for x in (m, md, mo):
        x.device_dtype = np.float32
    return m, md, mo


class ServeChildren:
    """The warm-start children (``--serve-child``) on empty
    ``compile_cache_dir`` / ``aot_store_dir`` directories under
    ``_build/``: ``cold`` (started beside the parent's direct solves: it
    builds the kernels and stores the plans), then ``warm`` and
    ``corrupt`` (``aot_corrupt`` armed) side by side."""

    RUNS = (("cold", "-"), ("warm", "-"), ("corrupt", "aot_corrupt:count:1"))

    def __init__(self):
        self.here = os.path.dirname(os.path.abspath(__file__))
        self.work = os.path.join(self.here, "amgx_tpu_torch", "_build",
                                 f"serve_{os.getpid()}")
        self.dirs = [os.path.join(self.work, d) for d in ("cache", "store")]
        for d in self.dirs:
            os.makedirs(d, exist_ok=True)
        self.procs = {}
        self.out = {}

    def start(self, name: str) -> None:
        fault = dict(self.RUNS)[name]
        path = os.path.join(self.work, f"{name}.json")
        self.procs[name] = (time.perf_counter(), path, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-child",
             *self.dirs, fault, path], cwd=self.here))

    def finish(self, name: str) -> dict:
        t0, path, proc = self.procs.pop(name)
        rc = proc.wait(timeout=SERVE_WAIT_S)
        assert rc == 0, f"serve child {name} exited {rc}"
        with open(path) as f:
            res = json.load(f)
        res["wall_s"] = time.perf_counter() - t0
        res["x"] = np.load(path + ".npy")
        self.out[name] = res
        return res

    def stop(self) -> None:
        for _, _, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        import shutil
        shutil.rmtree(self.work, ignore_errors=True)


def serve_jobs():
    """(matrix index, right-hand side) of every request of the wave, in
    submission order (the clients take every SERVE_CLIENTS-th)."""
    rng = np.random.default_rng(SEED)
    n, no = SERVE_SIDE ** 3, SERVE_OTHER_SIDE ** 3
    jobs = [(0, rng.standard_normal(n)) for _ in range(SERVE_SAME)]
    jobs += [(1, rng.standard_normal(n)) for _ in range(SERVE_DRIFT)]
    jobs += [(2, rng.standard_normal(no)) for _ in range(SERVE_OTHER)]
    order = np.random.default_rng(SEED + 1).permutation(len(jobs))
    return [jobs[i] for i in order]


def serve_wave(amgx, svc, mats, jobs):
    """Submit ``jobs`` from SERVE_CLIENTS threads and wait: the results
    in job order."""
    import threading
    out = [None] * len(jobs)
    errors = []

    def client(c):
        try:
            for k in range(c, len(jobs), SERVE_CLIENTS):
                mi, b = jobs[k]
                out[k] = svc.solve(mats[mi], b, timeout=SERVE_WAIT_S)
        except Exception as e:   # the phase fails on it below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_WAIT_S)
    assert not errors and all(r is not None for r in out), errors
    return out


def serve_phase(amgx, dev, smi) -> dict:
    """Phase 43: a ``SolveService`` on the card serving the headline
    stack (``serve_workers=2``, ``metrics_port`` on a free port,
    ``telemetry=1``): ``warmup`` on the 128³ pattern, then 22 requests
    from 4 client threads (16 right-hand sides of the matrix, 4 of its
    drifted values, 2 of a 64³ second pattern), every launch count set
    to 0 just before the wave and read just after.  Checks: each
    answer's count and x equal a direct ``Solver.solve`` of the same
    system (x bit-equal: f32 packs); the cache's decisions (one full
    setup per pattern, resetups for the drift, no setup for a repeated
    pattern) and no graph captured for the warmed pattern after warmup;
    the same wave under ``serve_workers=1`` gives the same bits; the
    endpoint's routes (``/debug/profile`` finds B1's kernel in its
    trace); an SLO window event and a load-generator report; the
    session's ``device_bytes`` within 10 % of the ``memory_allocated``
    its setup added.  Then the warm start: three child processes
    (``--serve-child``, :class:`ServeChildren`) on empty
    ``compile_cache_dir`` / ``aot_store_dir`` directories: the second
    builds no kernel and no plan, with the first's count and x; the
    third reads a corrupt entry (``aot_corrupt``), records the fallback
    and solves.  Returns the launches of the served wave."""
    from amgx_tpu_torch import telemetry
    t_phase = time.perf_counter()
    out = {}
    telemetry.reset()
    port = _free_port()
    cfg = HEADLINE_CFG + SERVE_KNOBS + f", metrics_port={port}"
    jobs = serve_jobs()
    hosts = serve_hosts()
    children = ServeChildren()
    try:
        _serve_in_process(amgx, dev, smi, cfg, port, jobs, hosts,
                          children, out)
        warm_start(children, smi)
    finally:
        children.stop()
    emit("serve_phase", elapsed_phase_s=time.perf_counter() - t_phase,
         card=smi)
    return out


def _serve_in_process(amgx, dev, smi, cfg, port, jobs, hosts, children,
                      out):
    """Phase 43's service, endpoint, load and direct solves (the cold
    warm-start child runs beside the direct solves)."""
    import torch
    from amgx_tpu_torch import telemetry
    from amgx_tpu_torch.serve import SolveService, loadgen, session_key
    from amgx_tpu_torch.telemetry import proftrace
    from amgx_tpu_torch.utils import cuda_graph

    # ---- serve_workers=2: warmup, the wave, the endpoint, the load
    mats = serve_matrices(amgx, hosts)
    torch.cuda.synchronize(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    svc = SolveService(amgx.AMGConfig(cfg + ", serve_workers=2"))
    try:
        assert svc.endpoint == f"http://127.0.0.1:{port}", svc.endpoint
        # the session's setup alone, for its bytes against what the
        # setup allocated; warmup then reuses it and captures
        t0 = time.perf_counter()
        sess, _ = svc.cache.get_or_create(svc.cfg, mats[0])
        assert sess.prepare(mats[0]) == "full"
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        mem_delta = torch.cuda.memory_allocated(dev) - mem0
        sess_bytes = sess.device_bytes()
        emit("serve_setup", setup_s=setup_s, session_bytes=sess_bytes,
             memory_allocated_delta=mem_delta)
        t0 = time.perf_counter()
        warm = svc.warmup(mats[0])
        torch.cuda.synchronize(dev)
        warmup_s = time.perf_counter() - t0
        assert sess is svc.cache.get(session_key(svc.cfg, mats[0]))
        mem_warm = torch.cuda.memory_allocated(dev) - mem0
        bytes_warm = sess.device_bytes()
        emit("serve_warmup", warmup_s=warmup_s)
        graphs0 = {k: g.number for k, g in
                   sess.solver.preconditioner.graphs.items()}
        captures0 = cuda_graph.CAPTURES["count"]
        svc.reset_latency_stats()
        reset_counts()
        t0 = time.perf_counter()
        served = serve_wave(amgx, svc, mats, jobs)
        torch.cuda.synchronize(dev)
        wave_s = time.perf_counter() - t0
        out["serve_headline"] = read_counts()
        captures = cuda_graph.CAPTURES["count"] - captures0
        graphs1 = {k: g.number for k, g in
                   sess.solver.preconditioner.graphs.items()}
        st = svc.stats()
        phases = svc.phase_split()
        lat = st["latency_s"]
        # the endpoint, with a client solving one request after another
        # through the profile's 0.2 s window (the profiler starts and
        # stops between two of them)
        import threading
        stop = threading.Event()

        def busy():
            while not stop.is_set():
                svc.solve(mats[0], jobs[0][1], timeout=SERVE_WAIT_S)

        bt = threading.Thread(target=busy, daemon=True)
        bt.start()
        time.sleep(0.1)
        try:
            code, body = _http(svc.endpoint
                               + "/debug/profile?seconds=0.2")
        finally:
            stop.set()
            bt.join(SERVE_WAIT_S)
        assert code == 200, body[:300]
        reply = json.loads(body)
        kernels = [e for e in proftrace.trace_events(reply["trace"])
                   if e.get("cat") == "kernel"]
        b1 = [e for e in kernels if "dia_spmv" in e.get("name", "")]
        assert b1, sorted({e.get("name") for e in kernels})[:20]
        routes = {}
        for route in ("/metrics", "/healthz", "/statusz",
                      "/debug/memory"):
            code, body = _http(svc.endpoint + route)
            assert code == 200, (route, code, body[:200])
            routes[route] = len(body)
        assert b"amgx_serve_requests_total" in _http(
            svc.endpoint + "/metrics")[1]
        with telemetry.capture() as cap:
            load = loadgen.run_load(svc, [mats[0]], rps=4.0,
                                    duration_s=1.5, multi_rhs_frac=0.25,
                                    max_rhs=3, seed=SEED,
                                    wait_timeout_s=SERVE_WAIT_S)
            svc.stats()
        slo_events = cap.events("slo_window")
        assert slo_events and load["failed"] == 0, load
    finally:
        assert svc.shutdown(SERVE_WAIT_S)
    emit("serve_wave", workers=2, requests=len(jobs),
         clients=SERVE_CLIENTS, setup_s=setup_s, warmup_s=warmup_s,
         warmup_buckets=warm["buckets"], wave_s=wave_s,
         latency_s=lat, phase_split=phases,
         queue_share_of_latency=(phases["queue_wait"]["mean_s"]
                                 / sum(v["mean_s"] for v in
                                       phases.values())),
         cache=st["cache"], captures_in_wave=captures,
         endpoint_routes=routes,
         profile_kernels=len(kernels), profile_b1_kernels=len(b1),
         loadgen={k: load[k] for k in ("offered", "completed",
                                       "rejected", "p50_ms", "p95_ms",
                                       "p99_ms", "attainment",
                                       "achieved_rps")},
         slo_window=slo_events[-1]["attrs"], card=smi)
    # one full setup per pattern; the drifted values ride resetups; no
    # setup for a repeated pattern; no capture for the warmed pattern
    by = {s["pattern"]: s for s in st["cache"]["by_session"]}
    assert st["cache"]["misses"] == 2 and len(by) == 2, st["cache"]
    head = by[mats[0].pattern_fingerprint()]
    other = by[mats[2].pattern_fingerprint()]
    assert head["full_setups"] == 1 and other["full_setups"] == 1, by
    assert head["resetups"] >= 1, head
    assert graphs1 == graphs0, (graphs0, graphs1)
    assert captures <= 1, captures          # the 64³ session's one graph
    # the session's bytes against what its setup allocated (the
    # matrices' host data is not on the card); after the capturing
    # warmup solve, printed beside
    mem_ratio = sess_bytes / max(mem_delta, 1)
    emit("serve_memory", session_bytes=sess_bytes,
         memory_allocated_delta=mem_delta, ratio=mem_ratio,
         after_warmup=dict(session_bytes=bytes_warm,
                           memory_allocated_delta=mem_warm,
                           ratio=bytes_warm / max(mem_warm, 1)),
         card=smi)
    assert abs(mem_ratio - 1.0) <= 0.10, (sess_bytes, mem_delta)
    del svc, sess

    # ---- the same wave under serve_workers=1: the same bits (the cold
    # warm-start child builds its kernels and plans meanwhile)
    children.start("cold")
    svc1 = SolveService(amgx.AMGConfig(
        HEADLINE_CFG + SERVE_KNOBS + ", serve_workers=1"))
    try:
        served1 = serve_wave(amgx, svc1, serve_matrices(amgx, hosts),
                             jobs)
    finally:
        assert svc1.shutdown(SERVE_WAIT_S)
    for a, b_ in zip(served, served1):
        assert a.iterations == b_.iterations
        assert torch.equal(a.x, b_.x), "serve_workers=2 x != workers=1 x"
    del svc1, served1
    torch.cuda.empty_cache()

    # ---- each answer against a direct solve of the same system
    direct_iters = {}
    for mi in range(3):
        fresh = serve_matrices(amgx, hosts)[mi]
        slv = amgx.create_solver(HEADLINE_CFG + SERVE_KNOBS)
        slv.setup(fresh)
        for k, (mj, b) in enumerate(jobs):
            if mj != mi:
                continue
            r = slv.solve(b)
            assert r.iterations == served[k].iterations, \
                (k, r.iterations, served[k].iterations)
            assert torch.equal(r.x, served[k].x), f"request {k}: x"
            direct_iters.setdefault(mi, set()).add(r.iterations)
        del slv, fresh
        torch.cuda.empty_cache()
    emit("serve_direct", requests=len(jobs), bit_equal=True,
         workers_2_equal_workers_1=True,
         iterations={str(k): sorted(v) for k, v in direct_iters.items()})
    del served, mats
    telemetry.disable()
    telemetry.reset()
    torch.cuda.empty_cache()


def warm_start(children, smi):
    """Phase 43's warm start across processes: the cold child's builds
    and stored plans, then the warm child (no kernel build, no plan
    built, no store miss; the cold child's count and x) and the corrupt
    child (one ``corrupt:injected`` fallback, the same answer)."""
    children.finish("cold")
    for name in ("warm", "corrupt"):
        children.start(name)
    for name in ("warm", "corrupt"):
        children.finish(name)
    children = children.out
    cold, warm_c, bad = children["cold"], children["warm"], \
        children["corrupt"]
    assert cold["builds"]["misses"] >= 1, cold["builds"]
    assert cold["store"]["saves"] > 0, cold["store"]
    assert warm_c["builds"]["misses"] == 0, warm_c["builds"]
    assert warm_c["builds"]["hits"] >= cold["builds"]["misses"], warm_c
    assert warm_c["aot_misses"] == 0 and warm_c["store"]["misses"] == 0, \
        warm_c
    assert warm_c["store"]["loads"] == cold["store"]["saves"], warm_c
    assert warm_c["engine"]["builds"] == 0, warm_c["engine"]
    assert bad["fallbacks"] == ["corrupt:injected"], bad["fallbacks"]
    for c in (warm_c, bad):
        assert c["iterations"] == cold["iterations"]
        assert np.array_equal(c["x"], cold["x"])
    emit("serve_warm_start", ny=SERVE_STORE_NY,
         **{name: dict(setup_s=c["setup_s"], process_s=c["process_s"],
                       wall_s=c["wall_s"], builds=c["builds"],
                       plans_built=c["engine"]["builds"],
                       store={k: c["store"][k] for k in
                              ("loads", "saves", "misses", "fallbacks",
                               "entries", "bytes")},
                       aot_hits=c["aot_hits"], aot_misses=c["aot_misses"],
                       fallbacks=c["fallbacks"],
                       iterations=c["iterations"])
            for name, c in children.items()},
         x_bit_equal=True, card=smi)


# --------------------------------------------------------------------------
# phase 44: the AMGX C API on the card (ROADMAP item 9c)
# --------------------------------------------------------------------------
#: the headline grid of phase 44 (a) and (b): 2,097,152 rows
CAPI_SIDE = 128
#: (d)'s rank brick: generate_distributed_poisson_7pt(24, 24, 24, 2, 2, 2)
#: gives the 48³ Poisson in 8 shards
CAPI_DIST_BRICK = 24
#: (e)'s card-against-CPU grid
CAPI_SMALL_SIDE = 16
#: the grid of the copy count's child (vector copies are 8·n bytes, the
#: refinement's norm fetches 8 to 16)
CAPI_COPIES_SIDE = 32
#: rounds of (direct, C API, C API, direct) setups and warm solves
CAPI_AB_ROUNDS = 3
#: labels of plain versions: none may serve a C-API SpMV on the card
PLAIN_LABELS = ("dia/slices", "dia/block-slices", "ell/gather",
                "sharded/gather", "sharded/block-plain", "dense/lanes")
CAPI_CHILD_TIMEOUT_S = 300


def capi_python_probe() -> dict:
    """What the port's C shim embeds on this machine: ``sysconfig``'s
    include dir, shared flag and library, and whether Python.h and a
    shared libpython are present."""
    from amgx_tpu_torch.capi_native import build
    info = build.python_build_info()
    try:
        lib = str(build.find_libpython(info))
    except build.ShimBuildError as e:
        lib = f"none: {e}"
    return dict(INCLUDEPY=info["INCLUDEPY"],
                Py_ENABLE_SHARED=info["Py_ENABLE_SHARED"],
                LDLIBRARY=info["LDLIBRARY"], LIBDIR=info["LIBDIR"],
                python_h=os.path.isfile(os.path.join(info["INCLUDEPY"],
                                                     "Python.h")),
                libpython=lib, executable=info["executable"],
                version=info["version"])


class ShimBuild:
    """The port's C shim and its two C drivers, built in a thread beside
    the kernels' nvcc (``capi_native/build.py``); :meth:`result` joins
    and re-raises a failed build."""

    def __init__(self):
        import threading
        self.out, self.err = {}, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.t0 = time.perf_counter()
        self.thread.start()

    def _run(self):
        from amgx_tpu_torch.capi_native import build
        here = os.path.dirname(os.path.abspath(__file__))
        try:
            self.out["lib"] = build.build_shim()
            self.out["headline"] = build.build_driver(os.path.join(
                here, "amgx_tpu_torch", "capi_native", "capi_headline.c"))
            self.out["test_capi"] = build.build_driver(os.path.join(
                here, "native", "test_capi.c"))
            self.out["seconds"] = time.perf_counter() - self.t0
        except Exception as e:       # re-raised by result()
            self.err = e

    def result(self) -> dict:
        self.thread.join()
        if self.err is not None:
            raise self.err
        return self.out


def capi_poisson(side: int):
    """The 7-point Poisson CSR of a ``side``³ grid and its per-row
    coordinates (x fastest), as ``capi_headline.c`` assembles them."""
    from amgx_tpu_torch.io import poisson7pt
    import scipy.sparse as sp
    A = sp.csr_matrix(poisson7pt(side, side, side))
    A.sort_indices()
    z, y, x = np.meshgrid(*(np.arange(side, dtype=np.float64),) * 3,
                          indexing="ij")
    return A, (x.ravel(), y.ravel(), z.ravel())


def capi_headline(capi, mode, A, geo, cfg_str, counts=False):
    """Upload ``A`` with its geometry through the C API in ``mode``,
    set up and solve (b = 1, x0 = 0), then a warm solve from x0 = 0.
    Returns the handles, the wall seconds of upload, setup, first and
    warm solve, the API's own setup and solve seconds, the first
    solve's iterations and status, x (downloaded) and, with ``counts``,
    the launch counts of the first solve (set to 0 just before it)."""
    import torch
    n = A.shape[0]
    rc, cfg = capi.AMGX_config_create(cfg_str)
    assert rc == 0, rc
    rc, rsrc = capi.AMGX_resources_create_simple(cfg)
    rc, M = capi.AMGX_matrix_create(rsrc, mode)
    rc, b = capi.AMGX_vector_create(rsrc, mode)
    rc, x = capi.AMGX_vector_create(rsrc, mode)
    t0 = time.perf_counter()
    assert capi.AMGX_matrix_upload_all(M, n, A.nnz, 1, 1, A.indptr,
                                       A.indices, A.data) == 0
    assert capi.AMGX_matrix_attach_geometry(M, *geo) == 0
    assert capi.AMGX_vector_upload(b, n, 1, np.ones(n)) == 0
    assert capi.AMGX_vector_set_zero(x, n, 1) == 0
    upload_s = time.perf_counter() - t0
    rc, slv = capi.AMGX_solver_create(rsrc, mode, cfg)
    assert rc == 0, rc
    t0 = time.perf_counter()
    assert capi.AMGX_solver_setup(slv, M) == 0
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if counts:
        reset_counts()
    t0 = time.perf_counter()
    assert capi.AMGX_solver_solve(slv, b, x) == 0
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = read_counts() if counts else None
    rc, iters = capi.AMGX_solver_get_iterations_number(slv)
    rc, status = capi.AMGX_solver_get_status(slv)
    rc, api_setup_s = capi.AMGX_solver_get_setup_time(slv)
    rc, api_first_s = capi.AMGX_solver_get_solve_time(slv)
    t0 = time.perf_counter()
    rc, xs = capi.AMGX_vector_download(x)
    download_s = time.perf_counter() - t0
    assert rc == 0
    # a warm solve: the graph replays (x0 = 0 again)
    assert capi.AMGX_vector_set_zero(x, n, 1) == 0
    t0 = time.perf_counter()
    assert capi.AMGX_solver_solve(slv, b, x) == 0
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rc, api_warm_s = capi.AMGX_solver_get_solve_time(slv)
    assert capi.AMGX_solver_get_iterations_number(slv)[1] == iters
    return dict(M=M, b=b, x=x, slv=slv, rsrc=rsrc, cfg=cfg,
                iterations=iters, status=int(status), x_host=xs,
                counts=got, upload_s=upload_s, setup_s=setup_s,
                first_solve_s=first_s, warm_solve_s=warm_s,
                download_s=download_s, api_setup_s=api_setup_s,
                api_first_solve_s=api_first_s, api_warm_solve_s=api_warm_s)


def capi_direct(amgx, dev, A, geo) -> dict:
    """The work of :func:`capi_headline` in dDDI through the port's
    direct API: ``Matrix.from_csr`` on the card with an f32 pack, the
    grid the C API would derive, ``create_solver``, a first and a warm
    solve from x0 = 0 (and one with ``x0=None``), each timed."""
    import torch
    from amgx_tpu_torch.capi import _regular_grid_dims
    n = A.shape[0]
    t0 = time.perf_counter()
    m = amgx.Matrix.from_csr(A.indptr, A.indices, A.data, device=dev)
    m.device_dtype = np.float32
    m.geometry = geo
    m.grid_dims = _regular_grid_dims(geo)
    b = torch.ones(n, dtype=torch.float64, device=dev)
    x0 = torch.zeros(n, dtype=torch.float64, device=dev)
    upload_s = time.perf_counter() - t0
    slv = amgx.create_solver(HEADLINE_CFG)
    times = {}
    for name, fn in (("setup_s", lambda: slv.setup(m)),
                     ("first_solve_s", lambda: slv.solve(b, x0=x0)),
                     ("warm_solve_s", lambda: slv.solve(b, x0=x0)),
                     ("warm_solve_x0_none_s", lambda: slv.solve(b))):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize(dev)
        times[name] = time.perf_counter() - t0
        if name == "first_solve_s":
            res = got
    return dict(times, upload_s=upload_s, iterations=res.iterations,
                x=res.x.cpu().numpy(), slv=slv, M=m, b=b)


def capi_overhead(capi, dev, a, d, rounds=CAPI_AB_ROUNDS) -> dict:
    """The C API's setup and warm solve against the direct path's on
    the same card in turns (direct, C API, C API, direct), ``rounds``
    times each: the medians in seconds.  Setups rebuild the hierarchy
    from each matrix's cached pack; the warm solves start from x0 = 0
    (after one solve each that captures the graph anew)."""
    import torch
    n = d["b"].numel()

    def api_setup():
        assert capi.AMGX_solver_setup(a["slv"], a["M"]) == 0

    def api_solve():
        assert capi.AMGX_vector_set_zero(a["x"], n, 1) == 0
        assert capi.AMGX_solver_solve(a["slv"], a["b"], a["x"]) == 0

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def solve_direct():
        d["slv"].solve(d["b"], x0=torch.zeros_like(d["b"]))

    out = {}
    for name, fns in (("setup_s", (lambda: d["slv"].setup(d["M"]),
                                   api_setup)),
                      ("warm_solve_s", (solve_direct, api_solve))):
        if name == "warm_solve_s":
            fns[0]()
            fns[1]()
        ts = {"direct": [], "capi": []}
        for _ in range(rounds):
            for who in ("direct", "capi", "capi", "direct"):
                ts[who].append(timed(fns[who == "capi"]))
        out[name] = {k: float(np.median(v)) for k, v in ts.items()}
        out[name]["overhead"] = out[name]["capi"] - out[name]["direct"]
    return out


def capi_copies(capi, a, n, trace_path) -> dict:
    """Vector-sized copies (4·n bytes or more) between host and card of
    one upload → solve → download through the C API on its set-up
    solver, by direction, read from ``torch.profiler``'s Chrome trace:
    the C API keeps its vectors on the card, so one each way."""
    def run():
        assert capi.AMGX_vector_upload(a["b"], n, 1, np.ones(n)) == 0
        assert capi.AMGX_vector_set_zero(a["x"], n, 1) == 0
        assert capi.AMGX_solver_solve(a["slv"], a["b"], a["x"]) == 0
        assert capi.AMGX_vector_download(a["x"])[0] == 0

    profile_window(run, trace_path=trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {"HtoD": 0, "DtoH": 0, "memcpy_events": 0}
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        out["memcpy_events"] += 1
        if e.get("args", {}).get("bytes", 0) >= 4 * n:
            for k in ("HtoD", "DtoH"):
                out[k] += k in e.get("name", "")
    return out


def capi_copies_child(side: str, out_path: str) -> int:
    """``--capi-copies``: the C API's dDDI headline at ``side``³ set up
    in this fresh process, then :func:`capi_copies` of one upload →
    solve → download, written to ``out_path`` as JSON.  A fresh process:
    once phases 42–43 have traced in the smoke's process, its tracer
    has been seen to drop the first activities of a new window."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from amgx_tpu_torch import capi
    A, geo = capi_poisson(int(side))
    a = capi_headline(capi, "dDDI", A, geo, HEADLINE_CFG)
    copies = capi_copies(capi, a, A.shape[0], out_path + ".trace.json")
    os.unlink(out_path + ".trace.json")
    with open(out_path, "w") as f:
        json.dump(copies, f)
    return 0


def capi_child(exe, args):
    """Start a child of phase 44 (a C driver's embedded interpreter finds
    the port through the path its library was built with); one host
    thread for its CPU ops, beside phase 23's CPU children."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return time.perf_counter(), subprocess.Popen(
        [str(exe), *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def capi_child_wait(child, what):
    t0, proc = child
    try:
        out, err = proc.communicate(timeout=CAPI_CHILD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, (what, proc.returncode, out[-3000:],
                                  err[-3000:])
    return out, err, wall


def capi_phase(amgx, dev, smi, shim) -> dict:
    """Phase 44: the AMGX C API on the card.  (a) The in-process C API
    (``amgx_tpu_torch.capi``) in ``dDDI`` at 128³: the 7-point CSR
    uploaded with ``AMGX_matrix_upload_all``, its grid attached
    (``AMGX_matrix_attach_geometry``), the headline config through
    ``AMGX_solver_*`` with every count set to 0 just before the first
    solve and read just after (B1 launched, no plain label); its count
    and x bit-equal to the port's direct ``create_solver`` path on the
    same uploaded ``Matrix``; the true relres in f64 ≤ 1e-8; setup and
    warm solve against the direct path's in turns; one vector-sized
    copy each way an upload → solve → download (the profiler's trace,
    in a fresh process: ``--capi-copies``);
    ``AMGX_matrix_vector_multiply`` bit-equal to ``ops.spmv`` on the
    same pack.  (b) ``capi_headline.c`` at 128³ in a child process
    linked against ``libamgx_torch_c.so``: its count and x (FNV-1a hash
    and dumped bytes) equal (a)'s, its relres ≤ 1e-8, its wall and
    import seconds.  (c) ``native/test_capi.c`` unchanged against the
    port's library (hDDI: the CPU, the ABI).  (d) The distributed C API:
    ``AMGX_generate_distributed_poisson_7pt(24, 24, 24, 2, 2, 2)`` under
    ``DIST_CFG`` in ``dDDI`` (8 shards of an f32 pack), counts set to 0
    just before the solve and read just after (B3 on the stacked
    interior, ``sharded/window``, no plain label), count and x equal to
    the direct distributed path's.  (e) The C API in ``dDDI`` on the
    card at 16³ against the port's direct solve with ``device="cpu"``
    (f32 pack, refinement): equal counts, x bit-equal.  Returns the
    launches of (a)'s and (d)'s solves."""
    import shutil
    t_phase = time.perf_counter()
    built = shim.result()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "amgx_tpu_torch", "_build", f"capi_{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    children = []
    try:
        return _capi_phase(amgx, dev, smi, built, work, children)
    finally:
        for _, proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
        emit("capi_phase", elapsed_phase_s=time.perf_counter() - t_phase,
             card=smi)


def _capi_phase(amgx, dev, smi, built, work, children) -> dict:
    """Phase 44's steps (:func:`capi_phase`); every child process it
    starts is put in ``children``."""
    import torch
    from amgx_tpu_torch import capi
    from amgx_tpu_torch.capi_native import build
    from amgx_tpu_torch.ops import spmv as smod
    out = {}
    # (c) the ABI driver on the CPU, beside (a)
    abi = capi_child(built["test_capi"], ())
    children.append(abi)
    # the vector-sized copies of an upload → solve → download through the
    # C API, counted in a fresh process beside (a) (a size-independent
    # count: at 32³ its card work is a few milliseconds)
    copies_path = os.path.join(work, "copies.json")
    counter = capi_child(sys.executable, (
        os.path.abspath(__file__), "--capi-copies", CAPI_COPIES_SIDE,
        copies_path))
    children.append(counter)

    # ---- (a) the in-process C API at 128³, after the same work on the
    # direct path (its own upload of the same CSR and grid: the API's
    # overhead is the difference)
    A, geo = capi_poisson(CAPI_SIDE)
    n = A.shape[0]
    d = capi_direct(amgx, dev, A, geo)
    a = capi_headline(capi, "dDDI", A, geo, HEADLINE_CFG, counts=True)
    m = a["M"].matrix
    assert m.placement.type == "cuda" and a["b"].data.is_cuda
    assert np.dtype(m.device_dtype) == np.float32 and \
        np.dtype(m.dtype) == np.float64
    assert m.grid_dims == (CAPI_SIDE,) * 3, m.grid_dims
    assert a["status"] == 0, a["status"]
    c = a["counts"]
    assert c["dispatch"].get("dia/kernel", 0) > 0, c["dispatch"]
    assert not any(c["dispatch"].get(k, 0) for k in PLAIN_LABELS), \
        c["dispatch"]
    assert not any(c["declines"].values()), c["declines"]
    b1 = sum(c["B1"].values())
    assert b1 > 0, c["B1"]
    x_a = a["x_host"]
    assert x_a.dtype == np.float64 and x_a.shape == (n,)
    assert np.isfinite(x_a).all()
    relres = float(np.linalg.norm(1.0 - A @ x_a) / np.sqrt(n))
    assert relres <= 1e-8, relres
    assert d["iterations"] == a["iterations"], (d["iterations"],
                                                a["iterations"])
    assert np.array_equal(d["x"], x_a), \
        "C API x differs from the direct path's"
    turns = capi_overhead(capi, dev, a, d)
    direct = {k: d[k] for k in ("upload_s", "setup_s", "first_solve_s",
                                "warm_solve_s", "warm_solve_x0_none_s")}
    first_diff = {k: a[k] - d[k] for k in ("upload_s", "setup_s",
                                           "first_solve_s", "warm_solve_s")}
    # and the direct path on the very Matrix the C API uploaded
    dslv = amgx.create_solver(HEADLINE_CFG)
    dslv.setup(m)
    dres = dslv.solve(torch.ones(n, dtype=torch.float64, device=dev))
    assert dres.iterations == a["iterations"], dres.iterations
    assert np.array_equal(dres.x.cpu().numpy(), x_a), \
        "C API x differs from the direct path's on its own Matrix"
    del dslv, dres, d
    # AMGX_matrix_vector_multiply: the mode's f64 pack through B1
    rc, v = capi.AMGX_vector_create(a["rsrc"], "dDDI")
    rc, y = capi.AMGX_vector_create(a["rsrc"], "dDDI")
    capi.AMGX_vector_upload(v, n, 1, np.random.default_rng(SEED)
                            .standard_normal(n))
    reset_counts()
    assert capi.AMGX_matrix_vector_multiply(a["M"], v, y) == 0
    torch.cuda.synchronize(dev)
    mv = read_counts()
    assert mv["B1"]["f64.f64"] == 1 and \
        mv["dispatch"] == {"dia/kernel": 1}, mv
    pack = m.device(dtype=np.float64)
    assert torch.equal(y.data, smod.spmv(pack, v.data)), \
        "AMGX_matrix_vector_multiply differs from ops.spmv"
    x_hash = build.fnv1a64(x_a)
    emit("capi_inprocess", n=n, nnz=int(A.nnz), mode="dDDI",
         iterations=a["iterations"], relres=relres,
         upload_s=a["upload_s"], setup_s=a["setup_s"],
         first_solve_s=a["first_solve_s"], warm_solve_s=a["warm_solve_s"],
         download_s=a["download_s"],
         api_setup_time=a["api_setup_s"],
         api_solve_time_first=a["api_first_solve_s"],
         api_solve_time_warm=a["api_warm_solve_s"],
         direct=direct, first_run_difference_s=first_diff,
         in_turns=turns,
         b1_launches_per_solve=b1, launches_by_type=c["B1"],
         dispatch=c["dispatch"], x_bit_equal_direct=True,
         spmv_bit_equal=True, x_fnv1a64=f"{x_hash:016x}", card=smi)
    out["capi_headline"] = c
    a_iters = a["iterations"]
    for h, fn in ((a["slv"], capi.AMGX_solver_destroy),
                  (a["M"], capi.AMGX_matrix_destroy)):
        assert fn(h) == 0
    del a, m, pack, v, y
    torch.cuda.empty_cache()

    # ---- (b) the C driver at 128³ in a child process
    dump = os.path.join(work, "x_headline.bin")
    child = capi_child(built["headline"], ("dDDI", CAPI_SIDE, dump))
    children.append(child)
    cout, cerr, wall = capi_child_wait(child, "capi_headline")
    line = [ln for ln in cout.splitlines()
            if ln.startswith("CAPI_HEADLINE ")][-1]
    got = json.loads(line.split(" ", 1)[1])
    x_c = np.fromfile(dump, dtype=np.float64)
    assert got["iterations"] == a_iters and got["status"] == 0, \
        (got, a_iters)
    assert got["n"] == n and got["nnz"] == A.nnz, got
    assert got["relres"] <= 1e-8, got
    assert int(got["x_fnv1a64"], 16) == x_hash, (got, f"{x_hash:016x}")
    assert np.array_equal(x_c, x_a), "C driver x differs from (a)'s"
    emit("capi_c_driver", source="amgx_tpu_torch/capi_native/"
         "capi_headline.c", library=str(built["lib"]),
         build_s=built["seconds"], child_wall_s=wall,
         **{k: got[k] for k in ("iterations", "status", "relres",
                                "import_s", "setup_s", "solve_s",
                                "wall_s", "x_fnv1a64")},
         x_bit_equal_inprocess=True, card=smi)

    # ---- (c) native/test_capi.c against the port's library
    aout, aerr, awall = capi_child_wait(abi, "test_capi")
    assert "NATIVE CAPI TEST PASSED" in aout, (aout, aerr)
    emit("capi_abi", driver="native/test_capi.c", mode="hDDI",
         wall_s=awall, result=aout.strip().splitlines()[-2:])

    # ---- (d) the distributed C API: 48³ in 8 shards, dDDI
    k = CAPI_DIST_BRICK
    rc, cfg = capi.AMGX_config_create(DIST_CFG)
    rc, rsrc = capi.AMGX_resources_create_simple(cfg)
    rc, M = capi.AMGX_matrix_create(rsrc, "dDDI")
    rc, b = capi.AMGX_vector_create(rsrc, "dDDI")
    rc, x = capi.AMGX_vector_create(rsrc, "dDDI")
    t0 = time.perf_counter()
    rc, Ad, pv = capi.AMGX_generate_distributed_poisson_7pt(
        M, b, x, k, k, k, 2, 2, 2)
    assert rc == 0, rc
    capi.AMGX_vector_bind(b, M)
    capi.AMGX_vector_bind(x, M)
    rc, slv = capi.AMGX_solver_create(rsrc, "dDDI", cfg)
    assert capi.AMGX_solver_setup(slv, M) == 0
    torch.cuda.synchronize(dev)
    dist_setup_s = time.perf_counter() - t0
    assert M.matrix.dist[0].n_parts == DIST_PARTS and \
        M.matrix.device().fmt == "sharded-ell"
    reset_counts()
    t0 = time.perf_counter()
    assert capi.AMGX_solver_solve_with_0_initial_guess(slv, b, x) == 0
    torch.cuda.synchronize(dev)
    dist_solve_s = time.perf_counter() - t0
    dc = read_counts()
    rc, d_iters = capi.AMGX_solver_get_iterations_number(slv)
    rc, d_status = capi.AMGX_solver_get_status(slv)
    rc, xd = capi.AMGX_vector_download(x)
    assert dc["dispatch"].get("sharded/window", 0) > 0, dc["dispatch"]
    assert not any(dc["dispatch"].get(k_, 0) for k_ in PLAIN_LABELS), \
        dc["dispatch"]
    assert sum(dc["B3"].values()) > 0, dc["B3"]
    from amgx_tpu_torch.distributed import partition_offsets_from_vector
    direct = dist_solve(amgx, dev, Ad,
                        partition_offsets_from_vector(pv, DIST_PARTS),
                        "cuda", np.float32, DIST_CFG, warm=False)
    assert direct["res"].iterations == d_iters, \
        (direct["res"].iterations, d_iters)
    d_equal = bool(np.array_equal(direct["x"].numpy(), xd))
    assert d_equal, "distributed C API x differs from the direct path's"
    d_relres = float(np.linalg.norm(1.0 - Ad @ xd) / np.sqrt(Ad.shape[0]))
    emit("capi_distributed", n=int(Ad.shape[0]), shards=DIST_PARTS,
         mode="dDDI", pack="f32 (sharded packs are unrefinable)",
         iterations=d_iters, status=int(d_status), relres=d_relres,
         setup_s=dist_setup_s, solve_s=dist_solve_s,
         direct_iterations=direct["res"].iterations,
         direct_status=int(direct["res"].status), x_bit_equal_direct=True,
         dispatch=dc["dispatch"], b3_launches_per_solve=dc["B3"],
         card=smi)
    out["capi_dist"] = dc
    del direct, M, slv
    torch.cuda.empty_cache()

    # ---- (e) card = CPU at 16³: the C API on the card against the
    # direct solve on the CPU (f32 pack, f64 refinement)
    As, geos = capi_poisson(CAPI_SMALL_SIDE)
    e = capi_headline(capi, "dDDI", As, geos, HEADLINE_CFG)
    from amgx_tpu_torch.capi import _regular_grid_dims
    mc = amgx.Matrix.from_csr(As.indptr, As.indices, As.data, device="cpu")
    mc.device_dtype = np.float32
    mc.geometry = geos
    mc.grid_dims = _regular_grid_dims(geos)
    cslv = amgx.create_solver(HEADLINE_CFG)
    cslv.setup(mc)
    cres = cslv.solve(np.ones(As.shape[0]))
    assert cres.iterations == e["iterations"], \
        (cres.iterations, e["iterations"])
    assert np.array_equal(cres.x.numpy(), e["x_host"]), \
        "16³ C API on the card differs from the CPU's x"
    emit("capi_card_vs_cpu", n=int(As.shape[0]), mode="dDDI",
         iterations=e["iterations"], x_bit_equal=True)
    _, _, cwall = capi_child_wait(counter, "capi_copies")
    with open(copies_path) as f:
        copies = json.load(f)
    assert (copies["HtoD"], copies["DtoH"]) == (1, 1), copies
    emit("capi_copies", n=CAPI_COPIES_SIDE ** 3, mode="dDDI",
         child_wall_s=cwall, **copies)
    return out


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
    # what the C shim of phase 44 embeds (built beside the kernels)
    emit("capi_python", **capi_python_probe())

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
    # phase 44's C shim and drivers build on the host compiler meanwhile
    shim = ShimBuild()
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
    head_iters = res.iterations
    assert res.status == amgx.SolveStatus.SUCCESS, res.status
    assert res2.iterations == res.iterations
    assert dispatch["dia/kernel"] > 0 and dispatch["dia/slices"] == 0, \
        dispatch
    assert all(launches[k] > 0 for k in ("f32.f32", "f64.f64")), launches
    x = res.x
    # phase 42 holds its telemetry-on solve to this x
    head_x = x
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
    # every sum of the classical stack, its setup's row sums included,
    # runs in one order on both devices
    assert torch.equal(xg, xc), x_diff
    emit("classical_small_reference", n=24 ** 3, levels=tg,
         iterations=small_c["cuda"][1], x_rel_diff_card_vs_cpu=x_diff,
         limit=SMALL_X_RTOL, x_bit_equal=True)

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
    # ---- 44. the AMGX C API on the card (in process, through the C shim
    # from a C driver, the ABI driver, distributed, card = CPU), run
    # beside phase 23's CPU children, where the card process waits
    dfg = dfg_phases(amgx, dev, smi, gen, cpu_ref, ell_errs,
                     beside=lambda: capi_phase(amgx, dev, smi, shim))

    # ---- 24.-28. the solver names of this slice; phase 23's comparison
    # after 27, once the CPU children, running beside 22-27, are done
    fam = family_phases(amgx, dev, smi, gen)

    # ---- 29. values-only resetup on the three AMG paths
    fam.update(resetup_phases(amgx, dev, smi, gen))

    # ---- 30. block aggregation; 31. the classical setup
    # algorithms
    setup_paths = {
        "block_aggregation": block_aggregation_phase(amgx, dev, smi, gen),
        "classical_aggressive": classical_algorithm_phase(amgx, dev, smi,
                                                          gen)}

    # ---- 32. the precision paths (config 4's ran in its phases);
    # 33. scaling and RCM; 34. faults and recovery; 35. host levels
    prec = precision_phase(amgx, dev, smi, gen, errs, ell_errs)
    setup_paths.update(prec["launches"])
    setup_paths["precision_config4"] = c4["bf16_launches"]
    setup_paths.update(boundary_phase(amgx, dev, smi, gen))
    setup_paths.update(fault_phase(amgx, dev, smi, gen))
    setup_paths.update(host_levels_phase(amgx, dev, smi, gen))

    # ---- 36.-39. modes and complex, operators and solve_multi, the
    # eigensolvers, binary IO and fmt dense
    setup_paths.update(item7b_phases(amgx, dev, smi, gen))

    # ---- 40. distribution on one card: the 96³ headline in 8 shards,
    # consolidation, card against CPU
    dist = item8a_phases(amgx, dev, smi, gen)
    setup_paths.update(dist["paths"])

    # ---- 41. item 8b: config 4 on phase 13's system in 8 shards of 4×4
    # blocks (B5 on the stacked block interior), the distributed
    # classical stack, card against CPU
    d8b = item8b_phases(amgx, dev, smi, gen, c4.pop("system"),
                        c4["iterations"])
    setup_paths.update(d8b["paths"])

    # ---- 42. telemetry on the card: the headline with the knobs on,
    # the device anatomy through the graph, the ledger, forensics
    setup_paths.update(telemetry_phase(amgx, dev, smi, head_iters, head_x,
                                       head_graph["nodes"]))

    # ---- 43. serving on the card: the service, its endpoint, the warm
    # start across processes
    setup_paths.update(serve_phase(amgx, dev, smi))
    # phase 44's launches (it ran beside phase 23's CPU children)
    setup_paths.update(dfg["beside"])

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
    # the bf16 pairs of phase 32 (their launches come from the paths
    # below)
    bf16_entries = [("dia_spmv<bf16,f32>", "dia_spmv.cu",
                     "amgx_tpu/ops/pallas_spmv.py:101", errs, "B1")]
    if "B3" in prec["timing"]:
        bf16_entries.append(("ell_spmv<bf16,f32>", "ell_spmv.cu",
                             "amgx_tpu/ops/pallas_ell.py:209", ell_errs,
                             "B3"))
    for name, src, replaces, e, kern in bf16_entries:
        t = prec["timing"][kern]
        kernels.append(dict(
            name=name, route="cuda", source=f"amgx_tpu_torch/csrc/{src}",
            replaces=replaces, launches=0, launches_by_path={},
            max_abs_err=e["bf16.f32"]["abs"],
            max_row_rel_err=e["bf16.f32"]["rel"],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}))
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
    # B3 on the stacked sharded interior of phase 40 (its launches: the
    # distributed SpMVs of 40a in f64, of 40c's f32 run in f32)
    for key in ("f32.f32", "f64.f64"):
        v, xx = key.split(".")
        t = dist["head"]["timing"][key]
        path = "dist_16_f32" if key == "f32.f32" else "dist_headline"
        n_ = dist["paths"][path]["dispatch"].get("sharded/window", 0)
        kernels.append(dict(
            name=f"ell_spmv<{v},{xx},sharded_interior>", route="cuda",
            source="amgx_tpu_torch/csrc/ell_spmv.cu",
            replaces="amgx_tpu/ops/pallas_ell.py:209", launches=n_,
            launches_by_path={path: n_},
            max_abs_err=dist["head"]["errs"][key]["abs"],
            max_row_rel_err=dist["head"]["errs"][key]["rel"],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "bound_copy_ms")}))
    # B5 on the stacked block interior of phase 41 (its launches: 41a's
    # config-4 solve in f64, 41c's 12³ f32 one in f32)
    for key in ("f32.f32", "f64.f64"):
        v, xx = key.split(".")
        t = d8b["b5"]["timing"][key]
        path = "config4_12_f32" if key == "f32.f32" else "dist_config4"
        n_ = d8b["paths"][path]["B5s"][key]
        kernels.append(dict(
            name=f"binned_spmv_B5<{v},{xx},b=4,stacked_interior>",
            route="cuda", source="amgx_tpu_torch/csrc/binned_spmv.cu",
            replaces="amgx_tpu/ops/pallas_csr.py:497", launches=n_,
            launches_by_path={path: n_},
            max_abs_err=d8b["b5"]["errs"][key]["abs"],
            max_row_rel_err=d8b["b5"]["errs"][key]["rel"],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "bound_copy_ms")}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--capi-copies":
        sys.exit(capi_copies_child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--cpu-reference":
        sys.exit(cpu_reference(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 6 and sys.argv[1] == "--serve-child":
        sys.exit(serve_child(*sys.argv[2:]))
    sys.exit(main())

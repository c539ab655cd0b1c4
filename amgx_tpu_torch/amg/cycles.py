"""Multigrid cycles: V, W, F, CG (K-cycle), CGF (port of
``amgx_tpu/amg/cycles.py``; reference ``core/src/cycles/``,
``fixed_cycle.cu:48-255``).

The recursion runs eagerly over the level list.  The K-cycle's α and β
stay 0-d device tensors (guarded divisions via ``torch.where``), so a
cycle queues its work on the device without a single host sync; its f32
inner products are summed in f64 and rounded once
(:func:`~..ops.ordered.wdot`), so the card and the CPU take the same steps.

``error_scaling`` 2/3 scales the coarse correction of a non-classical
level by the λ minimising the residual 2-norm (2) or the error A-norm
(3), clamped to [0.3, 10] in magnitude (reference
``aggregation_amg_level.cu:740-860``); λ is a 0-d device tensor too.

A hierarchy with a host tail (``amg_host_levels_rows``, ``host_from``:
the first level that computes on the CPU) enters it through
:func:`~..utils.cuda_graph.host_step`: the restricted residual and the
zero guess go down to the CPU, the tail's cycle (or K-cycle) runs there
on the tail's CPU tensors, and the correction comes back up.  The
recursion reads the hierarchy's levels at each call, so a cycle built
before a values-only resetup serves the refreshed levels.

Telemetry: each component of a level runs inside its scope
(``amgx/cycle/level<N>/{pre_smooth,restrict,prolong,post_smooth}``,
``amgx/cycle/coarse_solve``, ``amgx/cycle/kcycle<N>``;
``telemetry/scopes.py``), which a CUDA graph's capture records for its
replays.  With ``forensics`` the hierarchy carries a tape
(``telemetry/forensics.py::Tape``): every visit of a device level
computes the residual norm at the four cut points (entry, after
pre-smooth, after the coarse-grid correction, after post-smooth) and
writes them to its slot — device work only, so the graph holds it —
and the coarsest solve its entry and exit norms.  The extra products
only read the cycle's vectors: x is the same with the tape and without.
"""
from __future__ import annotations

import torch

from ..ops.ordered import div, mul, wdot, wnrm2
from ..ops.spmv import spmv
from ..telemetry.scopes import scope
from ..utils.cuda_graph import host_step


def _guarded_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, or 0 where den == 0 — without a host sync."""
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den != 0, div(num, safe), torch.zeros_like(num))


def _scaling_lambda(r, e, Ae, mode: int) -> torch.Tensor:
    """λ of the scaled correction: ⟨r, Ae⟩/⟨Ae, Ae⟩ (mode 2) or
    ⟨r, e⟩/⟨e, Ae⟩ (mode 3); 1 when the denominator is 0; its magnitude
    clamped to [0.3, 10]."""
    if mode == 2:
        num, den = wdot(r, Ae), wdot(Ae, Ae)
    else:
        num, den = wdot(r, e), wdot(e, Ae)
    one = torch.ones_like(den)
    lam = torch.where(den == 0, one, div(num, torch.where(den == 0, one,
                                                          den)))
    mag = torch.clamp(torch.abs(lam), 0.3, 10.0)
    if lam.is_complex():
        # the complex sign λ/|λ| (0 at 0), as ``jnp.sign``
        return mul(_guarded_div(lam, torch.abs(lam)), mag)
    return torch.sign(lam) * mag


def build_cycle(hierarchy, cycle_type: str = None):
    """Return ``cycle_fn(b, x) -> x`` for the hierarchy."""
    ct = cycle_type or hierarchy.cycle_type
    h = hierarchy

    def enters_host(i, b):
        return i == h.host_from and b.device.type != "cpu"

    def smooth(lvl, b, x, sweeps):
        if sweeps <= 0:
            return x
        return lvl.smoother.apply(b, x0=x, n_iters=sweeps)

    def coarse_solve(b, x):
        cs = h.coarse_solver
        if h.coarse_solver_is_smoother:
            return cs.apply(b, x0=x, n_iters=h.coarsest_sweeps)
        return cs.apply(b, x0=x)

    def taped(i, b):
        # the host tail's levels stay uninstrumented, as upstream
        return h.tape is not None and i < h.host_from

    def coarse_visit(b, x):
        with scope("cycle", "coarse_solve"):
            Adc = getattr(h.coarse_solver, "Ad", None)
            if not taped(len(h.levels), b) or Adc is None:
                return coarse_solve(b, x)
            n_in = wnrm2(b - spmv(Adc, x))
            x = coarse_solve(b, x)
            h.tape.record_coarse(len(h.levels), n_in,
                                 wnrm2(b - spmv(Adc, x)))
            return x

    def presweeps_at(i):
        if i == 0 and h.finest_sweeps >= 0:
            return h.finest_sweeps
        return h.presweeps

    def postsweeps_at(i):
        if i == 0 and h.finest_sweeps >= 0:
            return h.finest_sweeps
        return h.postsweeps

    def cycle(i, b, x, flavor):
        """One multigrid cycle starting at level i."""
        if enters_host(i, b):
            return host_step(lambda b_, x_: cycle(i, b_, x_, flavor), b, x)
        levels = h.levels
        if i == len(levels):
            return coarse_visit(b, x)
        lvl = levels[i]
        inst = taped(i, b)
        if inst:
            n_entry = wnrm2(b - spmv(lvl.Ad, x))
        with scope("cycle", f"level{i}/pre_smooth"):
            x = smooth(lvl, b, x, presweeps_at(i))
        with scope("cycle", f"level{i}/restrict"):
            r = b - spmv(lvl.Ad, x)
            if inst:
                n_pre = wnrm2(r)
            bc = lvl.restrict_residual(r)
        xc = torch.zeros_like(bc)
        if flavor == "V":
            xc = cycle(i + 1, bc, xc, "V")
        elif flavor == "W":
            xc = cycle(i + 1, bc, xc, "W")
            if i + 1 < len(levels):
                xc = cycle(i + 1, bc, xc, "W")
        elif flavor == "F":
            xc = cycle(i + 1, bc, xc, "F")
            if i + 1 < len(levels):
                xc = cycle(i + 1, bc, xc, "V")
        elif flavor in ("CG", "CGF"):
            xc = kcycle(i + 1, bc, xc, flavor)
        else:
            raise ValueError(f"unknown cycle {flavor!r}")
        with scope("cycle", f"level{i}/prolong"):
            if h.error_scaling in (2, 3) and lvl.kind != "classical":
                # the prolongated (optionally smoothed) error, applied
                # with the λ of the configured norm
                e = lvl.prolongate_and_correct(torch.zeros_like(x), xc)
                e = smooth(lvl, r, e, h.scaling_smoother_steps)
                lam = _scaling_lambda(r, e, spmv(lvl.Ad, e),
                                      h.error_scaling)
                x = x + mul(lam, e)
            else:
                x = lvl.prolongate_and_correct(x, xc)
            if inst:
                n_coarse = wnrm2(b - spmv(lvl.Ad, x))
        with scope("cycle", f"level{i}/post_smooth"):
            x = smooth(lvl, b, x, postsweeps_at(i))
        if inst:
            h.tape.record_level(i, flavor, (n_entry, n_pre, n_coarse,
                                            wnrm2(b - spmv(lvl.Ad, x))))
        return x

    def kcycle(i, b, x, flavor):
        """K-cycle: accelerate the level-i solve with ``cycle_iters``
        iterations of flexible CG preconditioned by the next cycle
        (reference CG_Flex_Cycle, cycles/cg_flex_cycle.cu)."""
        if enters_host(i, b):
            return host_step(lambda b_, x_: kcycle(i, b_, x_, flavor), b, x)
        levels = h.levels
        if i == len(levels):
            return coarse_visit(b, x)
        inner_flavor = "V" if flavor == "CGF" else flavor
        Ad = levels[i].Ad
        with scope("cycle", f"kcycle{i}"):
            r = b - spmv(Ad, x)
            p = z_prev = r_prev = None
            for _ in range(max(h.cycle_iters, 1)):
                z = cycle(i, r, torch.zeros_like(r), inner_flavor)
                if p is None:
                    p = z
                else:
                    # flexible (Notay) beta
                    beta = _guarded_div(wdot(r, z) - wdot(r_prev, z),
                                        wdot(r_prev, z_prev))
                    p = z + mul(beta, p)
                q = spmv(Ad, p)
                alpha = _guarded_div(wdot(r, z), wdot(p, q))
                x = x + mul(alpha, p)
                r_prev, z_prev = r, z
                r = r - mul(alpha, q)
            return x

    def cycle_fn(b, x):
        return cycle(0, b, x, ct)

    return cycle_fn

"""Device classical coarsening of COMPACT (coarse-local ELL) levels —
the general-sparsity continuation of the embedded fine level (port of
``amgx_tpu/amg/classical/device_coarse.py``; reference
``classical_amg_level.cu:240-340`` and the SpGEMM of
``base/src/csr_multiply.cu:739``).

Strength and PMIS are the host algorithms rowwise over the (nb, K) ELL
arrays (the λ count and the reverse-edge maxima are scatters:
``index_add_`` of integer-valued f64 and ``scatter_reduce_("amax")``,
both exact in any order).  D2 interpolation expands Â = A − A_Fs +
A_Fs·W by row gathers of the compacted W rows and dedups with a per-row
sort plus a segmented scan (:func:`~amgx_tpu_torch.ops.spgemm.dedup_rows`).
The Galerkin product is two ELL·ELL products and one transpose
(:mod:`amgx_tpu_torch.ops.spgemm`).

Every rowwise step runs over row chunks whose expanded blocks stay
within an element budget (the JAX package maps over row chunks for the
same reason); chunking rows changes no result.  Shapes are bucketed as
in the JAX package, so the levels compare 1:1.

ELL conventions: pad ENTRIES point at their own row with value 0; pad
ROWS carry a bare unit diagonal (isolated F points); stored entries are
"present" iff value ≠ 0; columns ascend within each row.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...device import to_host
from ...ops.ordered import sum_along
from ...ops.spgemm import (dedup_rows, ell_spgemm_fn, ell_transpose_fn,
                           row_chunks, row_ids, top_k)
from .device_fine import pmis_multiplier
from .device_pipeline import bucket, width_bucket


# ------------------------------------------------------ strength + PMIS
def strength_pmis(cols: torch.Tensor, vals: torch.Tensor, n_log: int,
                  a_mult: int, theta: float, max_row_sum: float,
                  strength_all: bool, seed: int):
    """(cf bool (nb,), S (nb, K) bool, stats int [nc, k_c, k_fs]) —
    ``_strength_pmis_fn`` upstream: ``strength/ahat.cu`` as the host
    ``AhatStrength``, PMIS as the host ``selectors._pmis`` with the same
    tie-break weights (from the LOGICAL row count)."""
    n = cols.shape[0]
    dev = cols.device
    f64 = torch.float64
    rown = row_ids(cols)
    off = cols != rown
    present = (vals != 0) & off
    diag = sum_along(torch.where(cols == rown, vals, 0.0), 1)
    if strength_all:
        S = present
    else:
        sgn = torch.sign(diag)
        sgn = torch.where(sgn == 0, 1.0, sgn)
        meas = torch.where(present, -vals * sgn[:, None], -np.inf)
        meas_abs = torch.where(present, torch.abs(vals), -np.inf)
        rowmax = meas.max(1).values
        no_neg = ~(rowmax > 0)
        rowmax_f = torch.where(no_neg, meas_abs.max(1).values, rowmax)
        meas_f = torch.where(no_neg[:, None], meas_abs, meas)
        S = present & (meas_f >= theta * rowmax_f[:, None]) & (meas_f > 0)
        if max_row_sum < 1.0 + 1e-12:
            rs = sum_along(vals, 1)
            dsafe = torch.where(diag == 0, 1.0, diag)
            weak = torch.abs(rs / dsafe) > max_row_sum
            S = S & ~weak[:, None]

    # weak entries scatter into column 0 with the neutral value (0, or
    # −inf for the maxima)
    ccol = torch.where(S, cols, 0).long().reshape(-1)
    Sf = S.reshape(-1)
    # in-degree: integer-valued f64 sums, exact in any order
    lam = torch.zeros(n, dtype=f64, device=dev).index_add_(0, ccol,
                                                          Sf.to(f64))
    i64 = torch.arange(n, dtype=torch.int64, device=dev)
    nl = max(int(n_log), 1)
    perm = (i64 * int(a_mult) + (int(seed) % nl)) % nl
    frac = (perm.to(f64) + 1.0) / (float(n_log) + 2.0)
    w = lam + frac
    has_out = S.any(1)
    has_in = torch.zeros(n, dtype=torch.int32, device=dev).scatter_reduce_(
        0, ccol, Sf.to(torch.int32), "amax") > 0
    state = torch.where(has_out | has_in, -1, 0).to(torch.int32)
    colsl = cols.long()
    while bool(to_host((state == -1).any())):
        und = state == -1
        wu = torch.where(und, w, -np.inf)
        out_max = torch.where(S, wu[colsl], -np.inf).max(1).values
        in_max = torch.full((n,), -np.inf, dtype=f64,
                            device=dev).scatter_reduce_(
            0, ccol, torch.where(S & und[:, None], wu[:, None],
                                 -np.inf).reshape(-1), "amax")
        max_nb = torch.maximum(out_max, in_max)
        become_c = und & ((max_nb == -np.inf) | (w > max_nb))
        state = torch.where(become_c, 1, state).to(torch.int32)
        near_out = (S & become_c[colsl]).any(1)
        near_in = torch.zeros(n, dtype=torch.int32,
                              device=dev).scatter_reduce_(
            0, ccol, (S & become_c[:, None]).reshape(-1).to(torch.int32),
            "amax") > 0
        state = torch.where((state == -1) & (near_out | near_in), 0,
                            state).to(torch.int32)
    cf = state == 1
    # (nc, max strong-C count, max strong-F count) of a row
    cfc = cf[colsl]
    stats = torch.stack([cf.to(torch.int64).sum(),
                         (S & cfc).to(torch.int64).sum(1).max(),
                         (S & ~cfc).to(torch.int64).sum(1).max()])
    return cf, S, stats


# ------------------------------------------------------- interpolation
def _compact_by(cols, vals, mask, width: int):
    """Keep ``mask`` entries (≤ width per row), cols ascending."""
    K = cols.shape[1]
    pos = torch.arange(K, dtype=torch.int32, device=cols.device)
    kkey = torch.where(mask, 4 * K, 0) - pos
    k = min(width, K)
    _, topi = top_k(kkey, k)
    oc = torch.gather(cols, 1, topi)
    ov = torch.gather(vals, 1, topi)
    om = torch.gather(mask, 1, topi)
    if width > k:
        pad = (0, width - k)
        oc = torch.nn.functional.pad(oc, pad, value=-1)
        ov = torch.nn.functional.pad(ov, pad)
        om = torch.nn.functional.pad(om, pad)
    return torch.where(om, oc, -1), torch.where(om, ov, 0.0), om


def _d1_on(c_vals, c_live, diag, row_neg, row_pos, cf):
    """Direct interpolation given the C-candidate entries and the full
    signed row sums (distance1.cu formula)."""
    neg = c_live & (c_vals < 0)
    pos = c_live & (c_vals > 0)
    s_c_neg = sum_along(torch.where(neg, c_vals, 0.0), 1)
    s_c_pos = sum_along(torch.where(pos, c_vals, 0.0), 1)
    alpha = torch.where(s_c_neg != 0,
                        row_neg / torch.where(s_c_neg == 0, 1.0, s_c_neg),
                        0.0)
    beta = torch.where(s_c_pos != 0,
                       row_pos / torch.where(s_c_pos == 0, 1.0, s_c_pos),
                       0.0)
    dsafe = torch.where(diag == 0, 1.0, diag)
    coef = torch.where(c_vals < 0, alpha[:, None], beta[:, None])
    w = -coef * c_vals / dsafe[:, None]
    return torch.where(c_live & ~cf[:, None], w, 0.0)


def _truncate(pc, pv, trunc_factor: float, max_elements: int, Kp: int):
    """truncate_and_scale parity (truncate.cu:625): factor filter, the
    top ``max_elements`` by |w| (ties to the lower column — slot order
    is column order), rescale to preserve row sums."""
    absw = torch.abs(pv)
    old = sum_along(pv, 1)
    keep = pv != 0
    if trunc_factor < 1.0:
        rmax = absw.max(1).values
        keep = keep & (absw >= trunc_factor * rmax[:, None])
    if max_elements > 0:
        topv, topi = top_k(torch.where(keep, absw, -1.0),
                           min(Kp, pv.shape[1]))
        kc = torch.gather(pc, 1, topi)
        kv = torch.gather(pv, 1, topi)
        kv = torch.where(topv > 0, kv, 0.0)
    else:
        kc, kv = pc, torch.where(keep, pv, 0.0)
    new = sum_along(kv, 1)
    scale = torch.where(new != 0, old / torch.where(new == 0, 1.0, new),
                        1.0)
    return kc, kv * scale[:, None]


def interpolate(cols, vals, S, cf, Kc: int, Kfs: int, Kp: int,
                interp_d2: bool, trunc_factor: float, max_elements: int):
    """(P_cols (nb, Kp) int32 coarse-local, P_vals, cnum (nb,) int32) —
    ``_interp_fn`` upstream.

    D1: the host ``D1Interpolator`` rowwise, C_i strength-filtered.  D2:
    Â expanded via row gathers of the compacted W rows, deduped with
    sort + scan (the is-C-column flag rides the scan as a summed lane),
    then D1 with ALL strength on Â — the host ``D2Interpolator``."""
    n, K = cols.shape
    dt = vals.dtype
    colsl = cols.long()
    rown = row_ids(cols)
    diag = sum_along(torch.where(cols == rown, vals, 0.0), 1)
    cnum = (torch.cumsum(cf.to(torch.int32), 0) - 1).to(torch.int32)
    cfc = cf[colsl]
    off = cols != rown
    present = (vals != 0) & off
    if not interp_d2:
        in_ci = S & cfc          # strength-filtered (distance1.cu)
        row_neg = sum_along(torch.where(present & (vals < 0), vals, 0.0), 1)
        row_pos = sum_along(torch.where(present & (vals > 0), vals, 0.0), 1)
        w = _d1_on(torch.where(in_ci, vals, 0.0), in_ci, diag, row_neg,
                   row_pos, cf)
        pc, pv = _truncate(torch.where(in_ci, cols, -1), w, trunc_factor,
                           max_elements, Kp)
    else:
        sc_mask = S & cfc
        fs_mask = S & ~cfc
        sum_ck = sum_along(torch.where(sc_mask, vals, 0.0), 1)
        wrow = torch.where(
            sc_mask, vals / torch.where(sum_ck == 0, 1.0, sum_ck)[:, None],
            0.0)
        wc, wv, _ = _compact_by(cols, wrow, sc_mask, Kc)
        fc, fv, fl = _compact_by(cols, vals, fs_mask, Kfs)
        fcc = torch.where(fl, fc, 0).long()
        # direct part of Â: A − A_Fs (diagonal kept; its column is the
        # own row, excluded from the C candidates below)
        dir_keep = present & ~fs_mask
        dir_c = torch.where(dir_keep, cols, -1)
        dir_v = torch.where(dir_keep, vals, 0.0)
        dir_isc = torch.where(dir_keep, cfc.to(dt), 0.0)
        W2 = K + Kfs * Kc
        pcs, pvs = [], []
        # several (rows, W2) blocks live at once through the sort, the
        # scans and the gathers: budget rows for four
        for r0, r1 in row_chunks(n, 4 * W2):
            m = r1 - r0
            gw_c = wc[fcc[r0:r1]]                 # (m, Kfs, Kc)
            gw_v = wv[fcc[r0:r1]]
            fl_c = fl[r0:r1, :, None]
            path_c = torch.where(fl_c, gw_c, -1)
            path_v = torch.where(fl_c & (gw_c >= 0),
                                 fv[r0:r1, :, None] * gw_v, 0.0)
            path_isc = torch.where(fl_c & (gw_c >= 0) & (gw_v != 0), 1.0,
                                   0.0).to(dt)
            ac = torch.cat([dir_c[r0:r1], path_c.reshape(m, Kfs * Kc)], 1)
            av = torch.cat([dir_v[r0:r1], path_v.reshape(m, Kfs * Kc)], 1)
            aisc = torch.cat([dir_isc[r0:r1],
                              path_isc.reshape(m, Kfs * Kc)], 1)
            hc, (hv, hisc), hl = dedup_rows(ac, [av, aisc], W2)
            hpresent = hl & (hv != 0)
            hoff = hpresent & (hc != row_ids(hc, r0))
            row_neg = sum_along(torch.where(hoff & (hv < 0), hv, 0.0), 1)
            row_pos = sum_along(torch.where(hoff & (hv > 0), hv, 0.0), 1)
            in_ci = hoff & (hisc > 0)
            # Â diag == A diag (distribution paths land on C columns;
            # weights only matter for F rows)
            w = _d1_on(torch.where(in_ci, hv, 0.0), in_ci, diag[r0:r1],
                       row_neg, row_pos, cf[r0:r1])
            pc, pv = _truncate(torch.where(in_ci, hc, -1), w,
                               trunc_factor, max_elements, Kp)
            pcs.append(pc)
            pvs.append(pv)
        pc, pv = torch.cat(pcs), torch.cat(pvs)
    live = pv != 0
    pcc = torch.where(live, cnum[torch.clamp(pc, min=0).long()], -1)
    return pcc.to(torch.int32), torch.where(live, pv, 0.0), cnum


# ------------------------------------------------------------- driver
class CompactCoarsenResult(NamedTuple):
    cf: torch.Tensor          # (nb,) bool
    cnum: torch.Tensor        # (nb,) int32
    P_cols: torch.Tensor      # (nb, Kpx) int32 coarse-local; slot 0 = id
    P_vals: torch.Tensor
    R_cols: torch.Tensor      # (ncb2, Kr) int32 fine-source ids (-1 dead)
    R_vals: torch.Tensor
    Ac_cols: torch.Tensor     # (ncb2, Kc2) int32 (self-padded)
    Ac_vals: torch.Tensor
    nc: int
    ncb2: int
    Kc2: int


def coarsen_compact(cols: torch.Tensor, vals: torch.Tensor, n_logical: int,
                    *, theta: float, max_row_sum: float, strength_all: bool,
                    interp_d2: bool, trunc_factor: float, max_elements: int,
                    seed: int, compact_step: int = 2048):
    """One classical coarsening step on a compact device ELL level.

    Returns None when the coarse grid degenerates.  Host syncs: one per
    PMIS round, the stats, and one per width probe of the transpose and
    the two products."""
    nb, K = cols.shape
    dt = vals.dtype
    cf, S, stats = strength_pmis(
        cols, vals, n_logical, pmis_multiplier(max(n_logical, 1)),
        float(theta), float(max_row_sum), bool(strength_all), int(seed))
    nc, k_c, k_fs = (int(x) for x in to_host(stats))
    if nc == 0 or nc >= n_logical:
        return None
    Kc = width_bucket(max(k_c, 1))
    Kfs = width_bucket(max(k_fs, 1))
    Kp = max_elements if max_elements > 0 else K
    pc, pv, cnum = interpolate(cols, vals, S, cf, Kc, Kfs, int(Kp),
                               bool(interp_d2), float(trunc_factor),
                               int(max_elements))

    # P with the identity column of C rows folded in — the RAP operand
    ident_c = torch.where(cf, cnum, -1).to(torch.int32)[:, None]
    ident_v = torch.where(cf, 1.0, 0.0).to(dt)[:, None]
    pfull_c = torch.cat([ident_c, pc], 1)
    pfull_v = torch.cat([ident_v, pv], 1)
    Kpx = pfull_c.shape[1]

    ncb2 = bucket(nc, compact_step)
    Kr = width_bucket(max(8, 2 * Kpx))
    while True:
        rc, rv, maxdeg = ell_transpose_fn(nb, Kpx, ncb2, Kr)(pfull_c,
                                                             pfull_v)
        maxdeg = int(to_host(maxdeg))
        if maxdeg <= Kr:
            break
        Kr = width_bucket(maxdeg)
    Kap = width_bucket(min(K * Kpx, 4 * K))
    while True:
        apc, apv, apk = ell_spgemm_fn(nb, K, Kpx, Kap)(cols, vals, pfull_c,
                                                       pfull_v)
        apk = int(to_host(apk))
        if apk < Kap or Kap >= K * Kpx:
            break
        Kap = width_bucket(min(K * Kpx, 2 * Kap + 1))
    Kc2 = width_bucket(min(Kr * Kap, max(2 * K, 16)))
    while True:
        acc, acv, ack = ell_spgemm_fn(ncb2, Kr, Kap, Kc2,
                                      self_pad=True)(rc, rv, apc, apv)
        ack = int(to_host(ack))
        if ack < Kc2 or Kc2 >= Kr * Kap:
            break
        Kc2 = width_bucket(min(Kr * Kap, 2 * Kc2 + 1))
    return CompactCoarsenResult(
        cf=cf, cnum=cnum, P_cols=pfull_c, P_vals=pfull_v,
        R_cols=rc, R_vals=rv, Ac_cols=acc, Ac_vals=acv, nc=nc,
        ncb2=ncb2, Kc2=int(Kc2))

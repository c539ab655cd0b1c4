"""Device classical AMG setup for DIA (stencil) fine levels (port of
``amgx_tpu/amg/classical/device_fine.py``; reference
``core/src/classical/classical_amg_level.cu:240-340``).

On a stencil operator in row-aligned DIA form every neighbour access of
the classical algorithms is a statically shifted slice:

* AHAT/ALL strength: row-local max/compare over the (nd, n) value rows
  (``strength/ahat.cu``, including the max_row_sum weakening);
* PMIS: the synchronous two-phase rounds of the host ``selectors._pmis``
  with the same strictly-distinct tie-break weights, neighbour maxima
  over the symmetrised strength graph as nd shifted slices;
* D2: Â = A − A_Fs + A_Fs·W as a DIA×DIA product (offsets are pairwise
  sums of stencil offsets);
* D1 on Â + truncate_and_scale: row-local sums by sign, then a stable
  sort over the ≤ nd̂ coarse candidates per row (ties to the lower
  index = ascending offset, the host's stable order).

The JAX package jits these as one program; here they run eagerly on the
tensors' device with the same operations in the same order.  Entries are
"present" iff their stored DIA value is nonzero.  Every dtype is given
explicitly (the JAX package runs with 64-bit defaults).
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ...device import host_scalar, to_host
from ...ops.ordered import sum_along
from ...ops.spgemm import shift as _shift
from ...ops.spgemm import top_k


def ahat_plan(offs: Sequence[int]) -> Tuple[Tuple[int, ...], list]:
    """Static Â structure: output offsets (union of stencil offsets and
    pairwise off-diagonal sums) and, per output offset, the (k1, k2)
    index pairs with offs[k1] + offs[k2] == e."""
    offs = [int(o) for o in offs]
    offd = [k for k, o in enumerate(offs) if o != 0]
    sums = {}
    for k1 in offd:
        for k2 in offd:
            sums.setdefault(offs[k1] + offs[k2], []).append((k1, k2))
    out = sorted(set(offs) | set(sums))
    return tuple(out), [sums.get(e, []) for e in out]


def pmis_multiplier(n: int) -> int:
    """The affine-bijection multiplier of ``selectors.pmis_tie_breaker``
    (coprime to n), shared so device runs reproduce the host weights."""
    a_mult = 2654435761
    while np.gcd(a_mult, n) != 1:
        a_mult += 1
    return a_mult


def dia_strength(vals: torch.Tensor, offs: Sequence[int], n: int, dt,
                 theta: float, max_row_sum: float,
                 strength_all: bool) -> List[torch.Tensor]:
    """AHAT/ALL strength rows over a DIA stencil (strength/ahat.cu
    formula); one bool row per diagonal, the diagonal's slot all-False."""
    offs = [int(o) for o in offs]
    nd = len(offs)
    k0 = offs.index(0)
    offd = [k for k in range(nd) if k != k0]
    diag = vals[k0]
    present = [vals[k] != 0 for k in range(nd)]
    if strength_all:
        return [present[k] if k != k0 else torch.zeros_like(present[k])
                for k in range(nd)]
    sgn = torch.sign(diag)
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    ninf = torch.tensor(-np.inf, dtype=dt, device=vals.device)
    meas = [torch.where(present[k], -vals[k] * sgn, ninf) for k in offd]
    meas_abs = [torch.where(present[k], torch.abs(vals[k]), ninf)
                for k in offd]
    rowmax = functools.reduce(torch.maximum, meas)
    no_neg = ~(rowmax > 0)
    rowmax_abs = functools.reduce(torch.maximum, meas_abs)
    rowmax_f = torch.where(no_neg, rowmax_abs, rowmax)
    strong = {}
    for j, k in enumerate(offd):
        mf = torch.where(no_neg, meas_abs[j], meas[j])
        strong[k] = (mf >= theta * rowmax_f) & (mf > 0)
    if max_row_sum < 1.0 + 1e-12:
        rs = functools.reduce(torch.add, [vals[k] for k in range(nd)])
        dsafe = torch.where(diag == 0, torch.ones_like(diag), diag)
        weak = torch.abs(rs / dsafe) > max_row_sum
        strong = {k: s & ~weak for k, s in strong.items()}
    none = torch.zeros(n, dtype=torch.bool, device=vals.device)
    return [strong.get(k, none) for k in range(nd)]


def dia_pmis(S: List[torch.Tensor], offs: Sequence[int], n: int, seed: int,
             tie_idx=None, n_log=None, a_mult=None) -> torch.Tensor:
    """PMIS C/F split over the symmetrised DIA strength graph — the same
    synchronous two-phase rounds and tie-break weights as the host
    ``selectors._pmis``.  Returns cf (n,) bool.

    ``tie_idx``/``n_log``/``a_mult``: for an embedded coarse level the
    tie-break weights are the host weights of the logical indices.  Each
    round ends with one host sync (is any row still undecided?)."""
    offs = [int(o) for o in offs]
    nd = len(offs)
    k0 = offs.index(0)
    offd = [k for k in range(nd) if k != k0]
    kneg = {o: k for k, o in enumerate(offs)}
    dev = S[0].device
    f64 = torch.float64
    # tie-break permutation on the device, int64 exact for a·i < 2^63
    if tie_idx is None:
        a_mult = pmis_multiplier(n)
        i64 = torch.arange(n, dtype=torch.int64, device=dev)
        perm = (i64 * a_mult + (seed % n)) % n
        frac = (perm.to(f64) + 1.0) / float(n + 2)
    else:
        i64 = tie_idx.to(torch.int64)
        nl = max(int(n_log), 1)
        perm = (i64 * int(a_mult) + (int(seed) % nl)) % nl
        frac = (perm.to(f64) + 1.0) / (float(nl) + 2.0)
    # symmetrised graph row masks: G_d = S_d | shift(S_{-d}, d)
    G = []
    for k in range(nd):
        if k == k0:
            G.append(torch.zeros(n, dtype=torch.bool, device=dev))
            continue
        g = S[k]
        ko = kneg.get(-offs[k])
        if ko is not None:
            g = g | _shift(S[ko], offs[k], False)
        G.append(g)
    # lam[j] = #rows strongly depending on j = Σ_k shift(S_k, -off_k)
    lam = functools.reduce(torch.add, [_shift(S[k].to(f64), -offs[k])
                                       for k in offd])
    w = lam + frac                      # strictly distinct (f64)
    deg = functools.reduce(torch.add, [G[k].to(torch.int32) for k in offd])
    state = torch.where(deg == 0, 0, -1).to(torch.int32)
    ninf = torch.tensor(-np.inf, dtype=f64, device=dev)
    while host_scalar((state == -1).any()):
        und = state == -1
        max_nb = functools.reduce(torch.maximum, [
            torch.where(und & G[k] & _shift(und, offs[k], False),
                        _shift(w, offs[k], -np.inf), ninf)
            for k in offd])
        become_c = und & ((max_nb == -np.inf) | (w > max_nb))
        state = torch.where(become_c, 1, state).to(torch.int32)
        near_c = functools.reduce(torch.logical_or, [
            G[k] & _shift(become_c, offs[k], False) for k in offd])
        state = torch.where((state == -1) & near_c, 0, state) \
            .to(torch.int32)
    return state == 1


def dia_ahat(vals: torch.Tensor, S, cf: torch.Tensor, offs: Sequence[int],
             hat_offs: Tuple[int, ...], hat_pairs, interp_d2: bool, n: int,
             dt):
    """Â rows (nh, n): A − A_Fs + A_Fs·W (D2) or A itself (D1); plus the
    per-hat-offset shifted cf masks."""
    offs = [int(o) for o in offs]
    nd = len(offs)
    k0 = offs.index(0)
    offd = [k for k in range(nd) if k != k0]
    kneg = {o: k for k, o in enumerate(offs)}
    nh = len(hat_offs)
    cf_sh = {k: _shift(cf, offs[k], False) for k in range(nd)}
    if not interp_d2:
        return [vals[k] for k in range(nd)], cf_sh
    zero = torch.zeros(n, dtype=dt, device=vals.device)
    A_fs = {k: torch.where(S[k] & ~cf_sh[k], vals[k], zero) for k in offd}
    in_ck = {k: S[k] & cf_sh[k] for k in offd}
    sum_ck = functools.reduce(torch.add, [torch.where(in_ck[k], vals[k],
                                                      zero) for k in offd])
    cksafe = torch.where(sum_ck == 0, torch.ones_like(sum_ck), sum_ck)
    W = {k: torch.where(in_ck[k], vals[k] / cksafe, zero) for k in offd}
    rows = []
    for e_i, e in enumerate(hat_offs):
        acc = zero
        if e in kneg:
            k = kneg[e]
            acc = vals[k] - (A_fs[k] if k in A_fs else zero)
        for (k1, k2) in hat_pairs[e_i]:
            acc = acc + A_fs[k1] * _shift(W[k2], offs[k1])
        rows.append(acc)
    cf_hat = {e_i: _shift(cf, hat_offs[e_i], False) for e_i in range(nh)}
    return rows, cf_hat


def dia_d1_weights(hat, cf_sh, cf, hat_offs: Tuple[int, ...], n: int, dt,
                   strength_rows=None):
    """Direct interpolation on Â.

    D2 path: Â already collapsed the strong F couplings and the host uses
    ALL strength, so ``strength_rows`` is None and C_i = {nonzero Â
    entries at C columns}.  D1 path (Â = A): C_i is strength-filtered
    (``distance1.cu``); callers pass the strength rows aligned with
    ``hat_offs``."""
    h0 = hat_offs.index(0)
    nh = len(hat_offs)
    zero = torch.zeros(n, dtype=dt, device=cf.device)
    diag = hat[h0]
    dsafe = torch.where(diag == 0, torch.ones_like(diag), diag)
    ho = [e_i for e_i in range(nh) if e_i != h0]
    neg = {e_i: hat[e_i] < 0 for e_i in ho}
    pos = {e_i: hat[e_i] > 0 for e_i in ho}
    if strength_rows is None:
        in_ci = {e_i: (hat[e_i] != 0) & cf_sh[e_i] for e_i in ho}
    else:
        in_ci = {e_i: strength_rows[e_i] & cf_sh[e_i] for e_i in ho}

    def ssum(mask):
        return functools.reduce(torch.add, [
            torch.where(mask[e], hat[e], zero) for e in ho])

    s_all_neg = ssum(neg)
    s_all_pos = ssum(pos)
    s_c_neg = ssum({e: in_ci[e] & neg[e] for e in ho})
    s_c_pos = ssum({e: in_ci[e] & pos[e] for e in ho})
    one = torch.ones_like(zero)
    alpha = torch.where(s_c_neg != 0,
                        s_all_neg / torch.where(s_c_neg == 0, one, s_c_neg),
                        zero)
    beta = torch.where(s_c_pos != 0,
                       s_all_pos / torch.where(s_c_pos == 0, one, s_c_pos),
                       zero)
    f_row = ~cf
    ws = []
    for e_i in ho:
        coef = torch.where(neg[e_i], alpha, beta)
        w = -coef * hat[e_i] / dsafe
        ws.append(torch.where(in_ci[e_i] & f_row, w, zero))
    return ws, ho


def dia_truncate(ws, trunc_factor: float, max_elements: int, Kp: int):
    """truncate_and_scale parity: drop small entries, keep the
    ``max_elements`` largest per row, rescale to preserve row sums.
    Returns (kv (n, Kp), topi (n, Kp) slot indices into ws)."""
    W = torch.stack(ws, dim=1)                     # (n, nh-1)
    absw = torch.abs(W)
    old_sum = sum_along(W, 1)
    keep = W != 0
    if trunc_factor < 1.0:
        rowmax = torch.max(absw, dim=1).values
        keep &= absw >= trunc_factor * rowmax[:, None]
    if max_elements > 0:
        # rank by |w| descending, ties to the lower index (= ascending
        # offset, the host's stable order)
        topv, topi = top_k(torch.where(keep, absw, -1.0),
                           min(Kp, W.shape[1]))
        kv = torch.gather(W, 1, topi)
        kv = torch.where(topv > 0, kv, 0.0)
    else:
        kv = torch.where(keep, W, 0.0)
        topi = torch.arange(W.shape[1], device=W.device).expand(W.shape)
    new_sum = sum_along(kv, 1)
    scale = torch.where(new_sum != 0,
                        old_sum / torch.where(new_sum == 0, 1.0, new_sum),
                        1.0)
    return kv * scale[:, None], topi


def fine_program(vals: torch.Tensor, offs: Sequence[int], n: int,
                 theta: float, max_row_sum: float, strength_all: bool,
                 interp_d2: bool, trunc_factor: float, max_elements: int,
                 seed: int):
    """The fine-level classical setup (``_fine_fn`` upstream): strength →
    PMIS → Â → D1 weights → truncation.  Returns (cf bool, pv (n, Kp),
    pi (n, Kp) slot indices, hat_offs)."""
    offs = [int(o) for o in offs]
    nd = len(offs)
    k0 = offs.index(0)
    dt = vals.dtype
    hat_offs, hat_pairs = ahat_plan(offs) if interp_d2 \
        else (tuple(offs), [[] for _ in offs])
    nh = len(hat_offs)
    Kp = max_elements if max_elements > 0 else nh - 1
    S = dia_strength(vals, offs, n, dt, theta, max_row_sum, strength_all)
    cf = dia_pmis(S, offs, n, seed)
    hat, cf_sh = dia_ahat(vals, S, cf, offs, hat_offs, hat_pairs,
                          interp_d2, n, dt)
    # D1 path: C_i restricted to strength-filtered entries (hat offsets
    # == stencil offsets there, so slots align 1:1)
    srows = None if interp_d2 else {k: S[k] for k in range(nd) if k != k0}
    ws, _ = dia_d1_weights(hat, cf_sh, cf, hat_offs, n, dt,
                           strength_rows=srows)
    pv, pi = dia_truncate(ws, trunc_factor, max_elements, Kp)
    return cf, pv, pi, hat_offs


def classical_fine_device(offs: Sequence[int], dvals: torch.Tensor, n: int,
                          theta: float, max_row_sum: float,
                          strength_all: bool, interp_d2: bool,
                          trunc_factor: float, max_elements: int,
                          seed: int = 7):
    """Run the device fine-level classical setup; returns host-side
    ``(cf_map int8 (n,), P scipy csr)``."""
    cf_d, pv_d, pi_d, hat_offs = fine_program(
        dvals, offs, n, float(theta), float(max_row_sum),
        bool(strength_all), bool(interp_d2), float(trunc_factor),
        int(max_elements), int(seed))
    cf, pv, pi = to_host(cf_d.to(torch.int8), pv_d, pi_d.to(torch.int8))
    cnum = np.cumsum(cf) - 1
    nc = int(cf.sum())
    ho = [e_i for e_i in range(len(hat_offs)) if hat_offs[e_i] != 0]
    off_of_slot = np.asarray([hat_offs[e] for e in ho], dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), pv.shape[1])
    dest = rows + off_of_slot[pi.reshape(-1)]
    vals = pv.reshape(-1)
    live = vals != 0
    rows, dest, vals = rows[live], dest[live], vals[live]
    Pi = np.concatenate([rows, np.flatnonzero(cf)])
    Pj = np.concatenate([cnum[dest], cnum[np.flatnonzero(cf)]])
    Pv = np.concatenate([vals.astype(np.float64), np.ones(nc)])
    P = sp.csr_matrix((Pv, (Pi, Pj)), shape=(n, nc))
    P.sum_duplicates()
    P.sort_indices()
    return cf, P

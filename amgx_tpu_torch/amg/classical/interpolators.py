"""Interpolation for classical AMG: D1, D2 and MULTIPASS (port of
``amgx_tpu/amg/classical/interpolators.py``; reference
``core/src/classical/interpolators/``).  Host numpy/scipy setup code.

Truncation follows ``interp_truncation_factor`` / ``interp_max_elements``
(``base/src/truncate.cu:625`` truncateAndScale; core.cu:507-508).
EM, the energy-minimising interpolator, registers from
:mod:`..energymin.interpolator`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp

from ...errors import BadConfigurationError
from .util import entry_mask_in


def _rowsum(n, rows, data, mask):
    """Masked per-row sum via bincount."""
    return np.bincount(rows[mask], weights=data[mask], minlength=n)


_interp_registry: Dict[str, type] = {}


def register_interpolator(name):
    def deco(cls):
        _interp_registry[name] = cls
        cls.config_name = name
        return cls
    return deco


def create_interpolator(name, cfg, scope):
    if name not in _interp_registry:
        raise BadConfigurationError(f"unknown interpolator {name!r}")
    return _interp_registry[name](cfg, scope)


def truncate_and_scale(P: sp.csr_matrix, trunc_factor: float,
                       max_elements: int) -> sp.csr_matrix:
    """Drop small P entries and rescale rows to preserve row sums
    (reference ``truncateAndScale``, truncate.cu:625).

    When both criteria are configured, the top-``max_elements`` pass
    ranks only the entries that survived the factor filter; ties keep
    the lower column (the device programs share this order)."""
    if trunc_factor >= 1.0 and max_elements <= 0:
        return P
    P = sp.csr_matrix(P).copy()
    n = P.shape[0]
    rows = np.repeat(np.arange(n), np.diff(P.indptr))
    absd = np.abs(P.data)
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, rows, absd)
    keep = np.ones(len(P.data), dtype=bool)
    if trunc_factor < 1.0:
        keep &= absd >= trunc_factor * rowmax[rows]
    if max_elements > 0:
        # max_elements passes of row-max + mask, each retiring the first
        # occurrence of every row's current max
        remaining = keep.copy()
        topk = np.zeros(len(P.data), dtype=bool)
        starts = P.indptr[:-1]
        nonempty = np.diff(P.indptr) > 0
        for _ in range(max_elements):
            if not remaining.any():
                break
            masked = np.where(remaining, absd, -1.0)
            rowmax_r = np.full(n, -1.0)
            if nonempty.any():
                red = np.maximum.reduceat(masked, starts[nonempty])
                rowmax_r[nonempty] = red
            is_max = remaining & (absd == rowmax_r[rows]) & \
                (rowmax_r[rows] >= 0)
            if is_max.any():
                idx = np.flatnonzero(is_max)
                first = np.ones(len(idx), dtype=bool)
                first[1:] = rows[idx[1:]] != rows[idx[:-1]]
                sel = idx[first]
                topk[sel] = True
                remaining[sel] = False
        keep &= topk
    old_sum = np.bincount(rows, weights=P.data, minlength=n)
    P.data = np.where(keep, P.data, 0.0)
    new_sum = np.bincount(rows, weights=P.data, minlength=n)
    scale = np.where(new_sum != 0, old_sum / np.where(new_sum == 0, 1.0,
                                                      new_sum), 1.0)
    P.data = P.data * scale[rows]
    P.eliminate_zeros()
    return P


class _InterpolatorBase:
    def __init__(self, cfg, scope):
        self.cfg = cfg
        self.scope = scope
        self.trunc_factor = float(cfg.get("interp_truncation_factor", scope))
        self.max_elements = int(cfg.get("interp_max_elements", scope))

    def compute(self, A: sp.csr_matrix, S: sp.csr_matrix,
                cf_map: np.ndarray) -> sp.csr_matrix:
        """Return P: (n_fine, n_coarse)."""
        raise NotImplementedError

    def _finish(self, P):
        return truncate_and_scale(P, self.trunc_factor, self.max_elements)


def _coarse_numbering(cf_map: np.ndarray) -> np.ndarray:
    cnum = np.cumsum(cf_map) - 1
    return np.where(cf_map > 0, cnum, -1)


@register_interpolator("D1")
class D1Interpolator(_InterpolatorBase):
    """Distance-1 direct interpolation (reference
    ``interpolators/distance1.cu``): for an F point i with strong C
    neighbours C_i, w_ij = −α_i·a_ij/a_ii with
    α_i = (Σ_{k∈N_i} a_ik)/(Σ_{k∈C_i} a_ik), separately for positive and
    negative couplings."""

    def compute(self, A, S, cf_map):
        A = sp.csr_matrix(A)
        n = A.shape[0]
        cnum = _coarse_numbering(cf_map)
        nc = int(cf_map.sum())
        indptr, indices, data = A.indptr, A.indices, A.data
        rows = np.repeat(np.arange(n), np.diff(indptr))
        diag = A.diagonal()

        strong_mask = entry_mask_in(A, S)
        off = indices != rows
        is_c_col = cf_map[indices] > 0
        in_Ci = off & strong_mask & is_c_col

        neg = data < 0
        pos = data > 0
        sum_all_neg = _rowsum(n, rows, data, off & neg)
        sum_all_pos = _rowsum(n, rows, data, off & pos)
        sum_c_neg = _rowsum(n, rows, data, in_Ci & neg)
        sum_c_pos = _rowsum(n, rows, data, in_Ci & pos)

        alpha = np.where(sum_c_neg != 0, sum_all_neg /
                         np.where(sum_c_neg == 0, 1.0, sum_c_neg), 0.0)
        beta = np.where(sum_c_pos != 0, sum_all_pos /
                        np.where(sum_c_pos == 0, 1.0, sum_c_pos), 0.0)
        dsafe = np.where(diag == 0, 1.0, diag)
        coef = np.where(data < 0, alpha[rows], beta[rows])
        w = -coef * data / dsafe[rows]

        f_entry = in_Ci & (cf_map[rows] == 0)
        Pi = rows[f_entry]
        Pj = cnum[indices[f_entry]]
        Pv = w[f_entry]
        # C points interpolate injectively
        c_rows = np.flatnonzero(cf_map > 0)
        Pi = np.concatenate([Pi, c_rows])
        Pj = np.concatenate([Pj, cnum[c_rows]])
        Pv = np.concatenate([Pv, np.ones(len(c_rows))])
        P = sp.csr_matrix((Pv, (Pi, Pj)), shape=(n, nc))
        P.sum_duplicates()
        return self._finish(P)


@register_interpolator("D2")
class D2Interpolator(_InterpolatorBase):
    """Distance-2 "standard" interpolation (reference
    ``interpolators/distance2.cu``): strong F-F connections are
    distributed through the common C neighbours before the direct
    formula, i.e. D1 with ALL strength on Â = A − A_Fs + A_Fs·W."""

    def compute(self, A, S, cf_map):
        A = sp.csr_matrix(A)
        if A.dtype != np.float64:
            A = A.astype(np.float64)
        n = A.shape[0]
        indptr, indices, data = A.indptr, A.indices, A.data
        rows = np.repeat(np.arange(n), np.diff(indptr))
        strong = entry_mask_in(A, S)
        off = indices != rows
        is_f_col = cf_map[indices] == 0
        fs_entry = off & strong & is_f_col

        # A_Fs: strong F-F part
        A_fs = sp.csr_matrix(
            (np.where(fs_entry, data, 0.0), indices.copy(), indptr.copy()),
            shape=A.shape)
        A_fs.eliminate_zeros()
        # distribution operator: row k of W = a_kj/Σ_{j∈C_k^s} a_kj
        in_Ck = off & strong & (cf_map[indices] > 0)
        sum_ck = _rowsum(n, rows, data, in_Ck)
        wk = np.where(in_Ck, data / np.where(sum_ck[rows] == 0, 1.0,
                                             sum_ck[rows]), 0.0)
        W = sp.csr_matrix((wk, indices.copy(), indptr.copy()), shape=A.shape)
        W.eliminate_zeros()
        A_hat = A - A_fs + sp.csr_matrix(A_fs @ W)
        A_hat = sp.csr_matrix(A_hat)
        A_hat.sum_duplicates()
        d1 = D1Interpolator(self.cfg, self.scope)
        d1.trunc_factor, d1.max_elements = self.trunc_factor, self.max_elements
        from .strength import AllStrength
        S_all = AllStrength(self.cfg, self.scope).compute(A_hat)
        return d1.compute(A_hat, S_all, cf_map)


@register_interpolator("MULTIPASS")
class MultipassInterpolator(_InterpolatorBase):
    """Multipass interpolation for aggressive coarsening (reference
    ``interpolators/multipass.cu``): C points inject; F points with strong C
    neighbours interpolate directly (pass 1); remaining F points
    interpolate through already-interpolated neighbours (passes 2..)."""

    def compute(self, A, S, cf_map):
        A = sp.csr_matrix(A)
        if A.dtype != np.float64:
            A = A.astype(np.float64)   # copies — mask attach won't hit
        n = A.shape[0]
        cnum = _coarse_numbering(cf_map)
        nc = int(cf_map.sum())
        indptr, indices, data = A.indptr, A.indices, A.data
        rows = np.repeat(np.arange(n), np.diff(indptr))
        strong = entry_mask_in(A, S)
        diag = A.diagonal()
        dsafe = np.where(diag == 0, 1.0, diag)

        # P rows as growing COO; interpolated = has a P row already
        P_rows = [np.flatnonzero(cf_map > 0)]
        P_cols = [cnum[P_rows[0]]]
        P_vals = [np.ones(len(P_rows[0]))]
        done = cf_map > 0

        max_passes = 10
        for _ in range(max_passes):
            if done.all():
                break
            P_cur = sp.csr_matrix(
                (np.concatenate(P_vals),
                 (np.concatenate(P_rows), np.concatenate(P_cols))),
                shape=(n, nc))
            # candidates: not-done rows with ≥1 strong done neighbour
            cand_entry = strong & done[indices] & ~done[rows]
            cand_rows = np.unique(rows[cand_entry])
            if len(cand_rows) == 0:
                # disconnected leftovers: zero rows (won't converge through
                # them, but keeps shapes valid)
                left = np.flatnonzero(~done)
                done[left] = True
                break
            # distribute: row i of P = -(1/a_ii) Σ_{k strong,done} a_ik P_k
            sel = cand_entry
            M = sp.csr_matrix(
                (np.where(sel, data, 0.0), indices.copy(), indptr.copy()),
                shape=(n, n))
            M.eliminate_zeros()
            P_new = sp.csr_matrix(M @ P_cur)
            P_new = sp.csr_matrix(sp.diags(-1.0 / dsafe) @ P_new)
            # row-normalise so each new row sums to 1 (piecewise-constant
            # consistency), only for candidate rows
            rs = np.asarray(P_new.sum(axis=1)).ravel()
            scale = np.where(np.abs(rs) > 1e-14, 1.0 / np.where(
                rs == 0, 1.0, rs), 0.0)
            P_new = sp.csr_matrix(sp.diags(scale) @ P_new)
            coo = P_new.tocoo()
            m = np.isin(coo.row, cand_rows)
            P_rows.append(coo.row[m])
            P_cols.append(coo.col[m])
            P_vals.append(coo.data[m])
            done[cand_rows] = True

        P = sp.csr_matrix(
            (np.concatenate(P_vals),
             (np.concatenate(P_rows), np.concatenate(P_cols))),
            shape=(n, nc))
        P.sum_duplicates()
        return self._finish(P)

"""Energy-minimisation interpolation (EM).

Reference: ``core/src/energymin/`` (~1.7k LoC) —
``Energymin_AMG_Level_Base`` + ``interpolators/em.cu``: P's F rows come
from LOCAL energy minimisation — em.cu extracts each F row's dense
neighbourhood submatrix ``Aij``, factorises it (cusolver getrf/getrs,
``em.cu:847-882``), and solves the constrained minimisation (the
``Ma x = e`` system, ``em.cu:972-1010``) so each F row's weights
minimise the A-energy of interpolation over its neighbourhood subject
to constant preservation.

Here (host setup, batched numpy; copied from
``amgx_tpu/amg/energymin/interpolator.py``):

* localized IDEAL interpolation: for F row ``i`` with local strong-F
  set ``F_i = {i} ∪ sF(i)`` (capped, strongest couplings first) and
  extended coarse set ``C_i = sC(F_i)``, solve the dense local system

      A[F_i, F_i] · X = −A[F_i, C_i],     w_i = X[row of i]

  — the energy-minimal extension of the coarse basis over the
  neighbourhood (the same dense per-neighbourhood solves em.cu batches
  through cusolver, here one ``np.linalg.solve`` over the whole padded
  batch);
* constant preservation: F rows rescale to unit row sum (em.cu's
  ``Ma``-system enforces the same constraint globally; for the locally
  solvable case the rescale is its closed form);
* the usual ``truncate_and_scale`` finishes (truncate.cu:625).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..classical.interpolators import (_InterpolatorBase,
                                       register_interpolator,
                                       truncate_and_scale)
from ..classical.util import entry_mask_in

#: neighbourhood caps: local F set (incl. the row itself) and extended
#: coarse set — strongest couplings kept (em.cu sizes its dense Aij the
#: same way, by the row's strong neighbourhood)
_MF = 8
_MC = 16


@register_interpolator("EM")
class EnergyMinInterpolator(_InterpolatorBase):

    #: F rows per batch of dense local solves.  The match tensors are
    #: (chunk, mF, K, mF+mC) — at 10⁶ F rows unchunked they cost
    #: several GB; a fixed chunk bounds them to tens of MB while the
    #: per-row solves are unchanged (each row's system is independent,
    #: so the result is chunking-invariant).  None = adaptive from
    #: ``_CHUNK_BUDGET`` elements.
    f_chunk = None
    _CHUNK_BUDGET = 1 << 26

    def compute(self, A, S, cf_map):
        A = sp.csr_matrix(A)
        if A.dtype != np.float64:
            A = A.astype(np.float64)
        n = A.shape[0]
        cf = np.asarray(cf_map).astype(np.int8)
        nc = int((cf > 0).sum())
        cnum = np.cumsum(cf > 0) - 1
        indptr, indices, data = A.indptr, A.indices, A.data
        rows = np.repeat(np.arange(n), np.diff(indptr))
        strong = entry_mask_in(A, S)
        off = indices != rows

        # padded ELL view of A (vectorized; K = max row length)
        K = int(np.diff(indptr).max()) if n else 0
        pos = np.arange(len(indices)) - indptr[rows]
        ecols = np.full((n, K), -1, dtype=np.int64)
        evals = np.zeros((n, K))
        estrong = np.zeros((n, K), dtype=bool)
        ecols[rows, pos] = indices
        evals[rows, pos] = data
        estrong[rows, pos] = strong & off

        isC = np.zeros(n, dtype=bool)
        isC[cf > 0] = True
        ecolC = np.where(ecols >= 0, isC[np.maximum(ecols, 0)], False)

        f_rows = np.flatnonzero(cf == 0)
        nF = len(f_rows)
        if nF == 0 or nc == 0:
            c_rows = np.flatnonzero(cf > 0)
            P = sp.csr_matrix(
                (np.ones(len(c_rows)), (c_rows, cnum[c_rows])),
                shape=(n, nc))
            return P

        def topk(mask, keys, m):
            """per-row indices of the m strongest masked entries."""
            score = np.where(mask, np.abs(keys), -1.0)
            idx = np.argsort(-score, axis=1, kind="stable")[:, :m]
            ok = np.take_along_axis(score, idx, axis=1) > 0
            return idx, ok

        # F rows process in fixed-size CHUNKS: every tensor below is
        # per-F-row independent, so chunking only bounds the (chunk,
        # mF, K, mF+mC) match-tensor footprint — results are identical
        # for any chunk size (tests assert the invariance)
        chunk = self.f_chunk or max(
            256, int(self._CHUNK_BUDGET
                     // max(_MF * max(K, 1) * (_MF + _MC), 1)))
        Pi_parts, Pj_parts, Pv_parts = [], [], []
        for lo in range(0, nF, chunk):
            f_c = f_rows[lo:lo + chunk]
            Pi_c, Pj_c, Pv_c = self._f_rows_weights(
                f_c, ecols, evals, estrong, ecolC, topk, cnum)
            Pi_parts.append(Pi_c)
            Pj_parts.append(Pj_c)
            Pv_parts.append(Pv_c)
        c_rows = np.flatnonzero(cf > 0)
        Pi = np.concatenate(Pi_parts + [c_rows])
        Pj = np.concatenate(Pj_parts + [cnum[c_rows]])
        Pv = np.concatenate(Pv_parts + [np.ones(len(c_rows))])
        P = sp.csr_matrix((Pv, (Pi, Pj)), shape=(n, nc))
        P.sum_duplicates()
        return truncate_and_scale(P, self.trunc_factor,
                                  self.max_elements)

    @staticmethod
    def _f_rows_weights(f_rows, ecols, evals, estrong, ecolC,
                        topk, cnum):
        """Energy-minimal weights of ONE chunk of F rows — the dense
        local solves of the original unchunked path, verbatim, over a
        row slice.  Returns the chunk's (Pi, Pj, Pv) triplets."""
        nF = len(f_rows)

        # local F set: the row + its strongest strong-F couplings
        fmask = estrong[f_rows] & ~ecolC[f_rows]
        fidx, fok = topk(fmask, evals[f_rows], _MF - 1)
        Fset = np.concatenate(
            [f_rows[:, None],
             np.where(fok, np.take_along_axis(ecols[f_rows], fidx,
                                              axis=1), -1)], axis=1)
        Fok = np.concatenate([np.ones((nF, 1), bool), fok], axis=1)
        mF = Fset.shape[1]

        # extended coarse set: strong C neighbours of every F_i member,
        # strongest first, deduped per row
        Fg = np.maximum(Fset, 0)
        candC = np.where(Fok[:, :, None] & estrong[Fg] & ecolC[Fg],
                         ecols[Fg], -1).reshape(nF, -1)
        candV = np.where(candC >= 0, evals[Fg].reshape(nF, -1), 0.0)
        # dedup: sort by column, keep first occurrence (sum |couplings|
        # as the strength score would need a segment sum — first
        # occurrence of each column with max |v| is enough here)
        order = np.argsort(
            candC + 0 * candV, axis=1, kind="stable")
        sc = np.take_along_axis(candC, order, axis=1)
        sv = np.take_along_axis(candV, order, axis=1)
        first = np.ones_like(sc, dtype=bool)
        first[:, 1:] = sc[:, 1:] != sc[:, :-1]
        live = first & (sc >= 0)
        cidx, cok = topk(live, sv, _MC)
        Cset = np.where(cok, np.take_along_axis(sc, cidx, axis=1), -1)
        mC = Cset.shape[1]

        # dense local blocks via the ELL join: K[r, a, b] = A[Fa, Fb],
        # B[r, a, c] = A[Fa, Cc] (match each A entry of row Fa against
        # the local index lists)
        rowsE = ecols[Fg]                         # (nF, mF, K)
        valsE = evals[Fg]
        okE = Fok[:, :, None] & (rowsE >= 0)
        matchF = (rowsE[:, :, :, None] == Fset[:, None, None, :]) & \
            okE[:, :, :, None] & Fok[:, None, None, :]
        Kloc = np.einsum("rak,rakb->rab", valsE, matchF)
        matchC = (rowsE[:, :, :, None] == Cset[:, None, None, :]) & \
            okE[:, :, :, None] & cok[:, None, None, :]
        Bloc = np.einsum("rak,rakc->rac", valsE, matchC)
        # pad rows/cols of K for dead F slots: unit diagonal keeps the
        # batched solve well-posed without affecting live rows
        dead = ~Fok
        Kloc[dead[:, :, None] & (np.eye(mF, dtype=bool)[None])] = 1.0
        # guard singular local blocks: add a tiny Tikhonov shift scaled
        # to the row diagonals (em.cu relies on getrf pivoting; the
        # batched solve wants a uniform guard)
        dscale = np.abs(Kloc[:, np.arange(mF), np.arange(mF)]).max(
            axis=1)
        Kloc += (1e-12 * np.maximum(dscale, 1.0))[:, None, None] * \
            np.eye(mF)[None]
        try:
            X = np.linalg.solve(Kloc, -Bloc)      # (nF, mF, mC)
        except np.linalg.LinAlgError:
            X = np.linalg.lstsq(
                Kloc.reshape(-1, mF),
                -Bloc.reshape(-1, mC), rcond=None)[0].reshape(
                    nF, mF, mC)
        w = X[:, 0, :]                            # the row of i itself
        w = np.where(cok, w, 0.0)
        # constant preservation: unit row sums where a nonzero sum
        # exists (the Ma-constraint's closed local form)
        rs = w.sum(axis=1)
        w = np.where(np.abs(rs[:, None]) > 1e-12,
                     w / np.where(rs == 0, 1.0, rs)[:, None], w)

        Pi = np.repeat(f_rows, mC)
        Pj = cnum[np.maximum(Cset, 0)].reshape(-1)
        Pv = w.reshape(-1)
        livee = (Cset >= 0).reshape(-1) & (Pv != 0)
        return Pi[livee], Pj[livee], Pv[livee]

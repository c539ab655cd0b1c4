"""Device SpGEMM primitives of the classical setup (port of the device
half of ``amgx_tpu/ops/spgemm.py``; reference ``csr_multiply.cu``).

* the DIA neighbour read :func:`shift`;
* the ELL sort algebra — :func:`seg_sum_scan`, :func:`dedup_rows`,
  :func:`ell_spgemm_fn` (expand by ROW gathers, dedup by a per-row sort
  plus a segmented scan) and :func:`ell_transpose_fn` — used by the
  compact classical levels (``amg/classical/device_coarse.py``);
* the DIA shift algebra — :func:`compose_sum`, :func:`compose_diff`,
  :func:`rap_candidate_offsets` and :func:`dia_galerkin_fn` — the
  stencil fine-level Galerkin product in which offsets compose by
  integer addition and every term is one shifted multiply-add.

The JAX package jits each ``*_fn``; here they return plain callables that
run eagerly (the names and signatures stay, so each module compares 1:1
with its counterpart).  ``jax.lax.top_k`` returns the lower index first
on ties and ``jnp.argsort`` is stable; :func:`top_k` and every sort here
use ``torch.sort(stable=True)`` to keep both promises, because host CSR
order and the truncation tie-break depend on them.

ELL conventions: dead entries carry value 0 (columns −1 or self-pads),
columns ascend within a row, pad rows are unit-diagonal.  The host
symbolic planner (``GalerkinPlan``/``SpGEMMPlan``) is a later slice.

The host symbolic half that a values-only resetup needs is numpy, copied
from the JAX package: :func:`spgemm_symbolic` (a product's triple
schedule), :func:`galerkin_pattern`, :func:`fill_pattern` and
:func:`pad_to_symbolic` (a Galerkin product kept on its full symbolic
pattern, so a later refresh finds every slot).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

#: element budget of one row chunk of an expanded product block; every
#: ELL primitive here is row-wise, so chunking rows bounds the transient
#: memory without changing a single result
_CHUNK_ELEMS = 1 << 27


def shift(x: torch.Tensor, d: int, fill=0) -> torch.Tensor:
    """y[i] = x[i+d] with ``fill`` outside — the DIA neighbour read.
    |d| ≥ n (tiny grids meeting a composed offset) is all-fill."""
    if d == 0:
        return x
    n = x.shape[0]
    if abs(d) >= n:
        return torch.full((n,), fill, dtype=x.dtype, device=x.device)
    f = torch.full((abs(d),), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[d:], f]) if d > 0 else torch.cat([f, x[:d]])


def top_k(keys: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest keys along the last axis,
    ties to the lower index (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(keys, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def row_chunks(n: int, width: int):
    """Row ranges whose (rows, width) blocks stay within the chunk
    budget."""
    step = max(1, _CHUNK_ELEMS // max(int(width), 1))
    return [(r0, min(n, r0 + step)) for r0 in range(0, n, step)]


def row_ids(x: torch.Tensor, r0: int = 0) -> torch.Tensor:
    """(rows, 1) int32 row numbers of a row block starting at ``r0``."""
    return torch.arange(r0, r0 + x.shape[0], dtype=torch.int32,
                        device=x.device)[:, None]


def seg_sum_scan(vals: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive sum along the LAST axis: runs delimited by
    ``new`` flags; at a run's last position this is the run total.

    A log-step (Hillis–Steele) scan of the associative segmented-sum
    operator, as ``jax.lax.associative_scan`` computes it upstream (a
    cumsum-and-subtract would lose precision); the partial sums are
    grouped differently from XLA's, so results agree to rounding."""
    v, f = vals, new
    W = v.shape[-1]
    step = 1
    while step < W:
        vb, fb = v[..., step:], f[..., step:]
        nv = torch.where(fb, vb, v[..., :-step] + vb)
        nf = f[..., :-step] | fb
        v = torch.cat([v[..., :step], nv], dim=-1)
        f = torch.cat([f[..., :step], nf], dim=-1)
        step *= 2
    return v


def dedup_rows(cols: torch.Tensor, val_list, out_width: int):
    """Per-row (col → Σ vals) dedup of an expanded product block.

    ``cols`` (n, W) int32 with dead entries = -1; ``val_list`` is a list
    of (n, W) arrays, each summed over duplicate columns.  Returns
    (cols (n, K), [vals (n, K)...], live (n, K)) with columns ascending
    and dead entries (-1, 0) packed to the right."""
    n, W = cols.shape
    sc, order = torch.sort(cols, dim=1, stable=True)   # dead (-1) first
    new = torch.ones((n, W), dtype=torch.bool, device=cols.device)
    new[:, 1:] = sc[:, 1:] != sc[:, :-1]
    runs = [seg_sum_scan(torch.gather(v, 1, order), new) for v in val_list]
    last = torch.ones((n, W), dtype=torch.bool, device=cols.device)
    last[:, :-1] = new[:, 1:]
    live = last & (sc >= 0)
    # keep ≤out_width live entries in ascending-column (== ascending
    # position) order: key = live·BIG − position (all keys distinct)
    pos = torch.arange(W, dtype=torch.int32, device=cols.device)
    kkey = torch.where(live, 4 * W, 0) - pos
    k = min(out_width, W)
    _, topi = top_k(kkey, k)
    oc = torch.gather(sc, 1, topi)
    ovs = [torch.gather(r, 1, topi) for r in runs]
    ol = torch.gather(live, 1, topi)
    if out_width > k:
        pad = out_width - k
        oc = torch.nn.functional.pad(oc, (0, pad), value=-1)
        ovs = [torch.nn.functional.pad(v, (0, pad)) for v in ovs]
        ol = torch.nn.functional.pad(ol, (0, pad))
    oc = torch.where(ol, oc, -1)
    ovs = [torch.where(ol, v, 0) for v in ovs]
    return oc, ovs, ol


def ell_spgemm_fn(nb: int, Ka: int, Kb: int, Kout: int,
                  self_pad: bool = False):
    """One ELL·ELL product C = A·B — ``run(a_cols (nb, Ka), a_vals,
    b_cols (nB, Kb), b_vals) → (c_cols (nb, Kout), c_vals, kmax)``.

    Expand via ROW gathers of B's rows, dedup via sort+scan.  A's dead
    entries are value-0 or column-(−1); ``self_pad=True`` emits the
    coarse-operator conventions (self-pad entries, unit-diagonal pad
    rows) — the RAP epilogue; ``False`` leaves dead columns −1 (the
    intermediate-product form).  ``kmax`` stays a 0-d device tensor."""

    def block(ac, av, bc, bv, r0):
        n = ac.shape[0]
        live = (av != 0) & (ac >= 0)
        acc = torch.where(live, ac, 0).long()
        g_c = bc[acc]                         # (n, Ka, Kb)
        g_v = bv[acc]
        keep = live[:, :, None] & (g_c >= 0) & (g_v != 0)
        ec = torch.where(keep, g_c, -1).reshape(n, Ka * Kb)
        ev = torch.where(keep, av[:, :, None] * g_v, 0).reshape(n, Ka * Kb)
        oc, (ov,), ol = dedup_rows(ec, [ev], Kout)
        kmax = ol.int().sum(1).max()
        if self_pad:
            rown = row_ids(oc, r0)
            oc = torch.where(ol, oc, rown)
            empty = ~ol.any(1)
            first = torch.arange(oc.shape[1], device=oc.device) == 0
            ov = torch.where(empty[:, None] & first, 1.0, ov)
        return oc, ov, kmax

    def run(ac, av, bc, bv):
        parts = [block(ac[r0:r1], av[r0:r1], bc, bv, r0)
                 for r0, r1 in row_chunks(ac.shape[0], Ka * Kb)]
        if len(parts) == 1:
            return parts[0]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]),
                torch.stack([p[2] for p in parts]).max())

    return run


def ell_transpose_fn(nb: int, Kpx: int, ncb: int, Kr: int):
    """``run(P_cols (nb, Kpx) coarse-local, P_vals) → (R_cols (ncb, Kr)
    int32 = fine-source ids, R_vals, maxdeg)``.

    Transpose via ONE flat stable sort of (col, row) keys + rank-in-run
    via a segmented scan; one scatter builds the (ncb, Kr) table.  Its
    targets are unique, so the scatter-add is exact in any order."""

    def run(pc, pv):
        n = pc.shape[0]
        dev = pc.device
        rows = torch.arange(n, dtype=torch.int64, device=dev)[:, None] \
            .expand(pc.shape).reshape(-1)
        cols = pc.reshape(-1).long()
        vals = pv.reshape(-1)
        live = (vals != 0) & (cols >= 0)
        key = torch.where(live, cols * n + rows, ncb * n + rows)
        sk, order = torch.sort(key, stable=True)
        sv = torch.where(live, vals, 0)[order]
        scol = (sk // n).int()
        srow = (sk % n).int()
        new = torch.ones(sk.shape, dtype=torch.bool, device=dev)
        new[1:] = scol[1:] != scol[:-1]
        rank = (seg_sum_scan(torch.ones_like(sv), new) - 1.0).int()
        ok = (scol < ncb) & (rank < Kr)
        flat = torch.where(ok, scol * Kr + rank, 0).long()
        rv = torch.zeros(ncb * Kr, dtype=sv.dtype, device=dev).index_add_(
            0, flat, torch.where(ok, sv, 0))
        rc = torch.full((ncb * Kr,), -1, dtype=torch.int32,
                        device=dev).scatter_reduce_(
            0, flat, torch.where(ok, srow, -1), "amax")
        maxdeg = torch.where(scol < ncb, rank, -1).max() + 1
        return rc.reshape(ncb, Kr), rv.reshape(ncb, Kr), maxdeg

    return run


# ------------------------------------------------- DIA shift algebra
def compose_sum(a_offs: Sequence[int], b_offs: Sequence[int]):
    """G = sorted {a+b} with, per g, the (a_idx, b_idx) pair list."""
    pairs = {}
    for ai, a in enumerate(a_offs):
        for bi, b in enumerate(b_offs):
            pairs.setdefault(int(a) + int(b), []).append((ai, bi))
    G = tuple(sorted(pairs))
    return G, [pairs[g] for g in G]


def compose_diff(p_offs: Sequence[int], g_offs: Sequence[int]):
    """Δ = sorted {g−o} with, per δ, the (p_idx, g_idx) pair list."""
    pairs = {}
    for pi, o in enumerate(p_offs):
        for gi, g in enumerate(g_offs):
            pairs.setdefault(int(g) - int(o), []).append((pi, gi))
    D = tuple(sorted(pairs))
    return D, [pairs[d] for d in D]


def rap_candidate_offsets(a_offs: Sequence[int],
                          p_offs: Sequence[int]) -> Tuple[int, ...]:
    G, _ = compose_sum(a_offs, p_offs)
    D, _ = compose_diff(p_offs, G)
    return D


def dia_galerkin_fn(a_offs: Tuple[int, ...], p_offs: Tuple[int, ...],
                    n: int, dtype: torch.dtype):
    """``run(avals (nd, n), P_rows (np, n), cf) → (Ac (nΔ, n), realized
    (nΔ,) bool, nc, kmax)`` and the candidate offsets Δ — the embedded
    fine-level Galerkin product where every factor is a diagonal-offset
    matrix and offsets compose statically (no gather, sort or scatter).
    ``realized`` lets the caller prune all-zero diagonals."""
    G, ap_pairs = compose_sum(a_offs, p_offs)
    D, ac_pairs = compose_diff(p_offs, G)

    def run(avals, P_rows, cf):
        dev = avals.device
        AP = []
        for gi in range(len(G)):
            acc = torch.zeros(n, dtype=dtype, device=dev)
            for (ai, pi) in ap_pairs[gi]:
                acc = acc + avals[ai] * shift(P_rows[pi], int(a_offs[ai]))
            AP.append(acc)
        Ac = torch.empty((len(D), n), dtype=dtype, device=dev)
        for di in range(len(D)):
            acc = torch.zeros(n, dtype=dtype, device=dev)
            for (pi, gi) in ac_pairs[di]:
                acc = acc + shift(P_rows[pi] * AP[gi], -int(p_offs[pi]))
            Ac[di] = acc
        del AP
        nzc = Ac != 0
        realized = nzc.any(1)
        nc = cf.int().sum()
        kmax = nzc.int().sum(0).max()
        return Ac, realized, nc, kmax

    return run, D


# ------------------------------------------------------ host symbolic
def _range_concat(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """[starts[0]..+counts[0], starts[1]..+counts[1], ...] flattened."""
    csum = np.concatenate([[0], np.cumsum(counts)])
    return (np.arange(csum[-1], dtype=np.int64)
            - np.repeat(csum[:-1], counts)
            + np.repeat(starts.astype(np.int64), counts))


def spgemm_symbolic(Aptr, Aind, Bptr, Bind, n_rows: int, n_cols_B: int,
                    device="cpu"):
    """Symbolic product C = A·B as a triple schedule: returns
    ``(tA, tB, t_out, C_indptr, C_indices)`` with
    ``C.data[t_out[q]] += A.data[tA[q]] * B.data[tB[q]]``.  The triples
    come sorted by output slot, stably (each slot's terms in A's entry
    order, B's row order within): one stable sort of the (row, column)
    keys gives both the pattern and that order, on ``device`` (a card
    sorts 10⁸ keys in a fraction of a second; a stable sort's result is
    the same on every device)."""
    rowlenB = np.diff(Bptr)
    cnt = rowlenB[Aind]
    tA = np.repeat(np.arange(len(Aind), dtype=np.int64), cnt)
    tB = _range_concat(Bptr[Aind], cnt)
    i_of = np.repeat(
        np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(Aptr)), cnt)
    key = i_of * n_cols_B + Bind[tB].astype(np.int64)
    del i_of
    _, order = torch.sort(torch.from_numpy(key).to(device), stable=True)
    order = order.cpu().numpy()
    ks = key[order]
    new = np.ones(len(ks), dtype=bool)
    new[1:] = ks[1:] != ks[:-1]
    t_out = np.cumsum(new) - 1
    ukey = ks[new]
    C_rows = ukey // n_cols_B
    C_indices = (ukey % n_cols_B).astype(np.int32)
    C_indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(C_rows, minlength=n_rows))]
    ).astype(np.int64)
    return tA[order], tB[order], t_out, C_indptr, C_indices


def galerkin_pattern(A: sp.csr_matrix, P: sp.csr_matrix) -> sp.csr_matrix:
    """Full symbolic pattern of Pᵀ·A·P (unit values): every structural
    slot, those where the current values cancel exactly included."""
    def ones(M):
        M = sp.csr_matrix(M)
        return sp.csr_matrix((np.ones(M.nnz), M.indices, M.indptr),
                             shape=M.shape)

    Pb = ones(P)
    patt = sp.csr_matrix(Pb.T @ ones(A) @ Pb)
    patt.sum_duplicates()
    patt.sort_indices()
    return patt


def fill_pattern(patt: sp.csr_matrix, M: sp.csr_matrix) -> sp.csr_matrix:
    """The values of ``M`` placed into the (superset) pattern ``patt``:
    slots absent from ``M`` become explicit zeros (scipy's sparse "+"
    prunes zeros, so a zero-pad add would lose exactly those slots)."""
    M = sp.csr_matrix(M)
    M.sum_duplicates()
    M.sort_indices()
    nc = patt.shape[1]
    rows_p = np.repeat(np.arange(patt.shape[0], dtype=np.int64),
                       np.diff(patt.indptr))
    rows_m = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                       np.diff(M.indptr))
    key_p = rows_p * nc + patt.indices
    key_m = rows_m * nc + M.indices
    pos = np.searchsorted(key_p, key_m)
    data = np.zeros(patt.nnz, dtype=M.data.dtype)
    data[pos] = M.data
    return sp.csr_matrix((data, patt.indices.copy(),
                          patt.indptr.copy()), shape=M.shape)


def pad_to_symbolic(Ac: sp.csr_matrix, A: sp.csr_matrix,
                    P: sp.csr_matrix) -> sp.csr_matrix:
    """A numeric Galerkin product expanded to its full symbolic pattern
    (a values-only refresh keeps the structure frozen, so the slots must
    exist where the current values cancel)."""
    return fill_pattern(galerkin_pattern(A, P), Ac)

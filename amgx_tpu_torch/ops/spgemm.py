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
columns ascend within a row, pad rows are unit-diagonal.

The symbolic half (copied from the JAX package's host numpy and adapted
to run in torch on the plan's device): :func:`spgemm_symbolic` (a
product's triple schedule),
:func:`transpose_perm`, :func:`galerkin_pattern`, :func:`fill_pattern`
and :func:`pad_to_symbolic` (a Galerkin product kept on its full
symbolic pattern, so a later refresh finds every slot), and the
reusable plans :class:`GalerkinPlan` (``R·(A·P)``, R = Pᵀ) and
:class:`SpGEMMPlan` (``A·B``) of the device setup engine
(``amg/device_setup/``).  A plan is built once per sparsity pattern; its
numeric pass (:func:`galerkin_numeric`, :func:`spgemm_numeric`) runs on
the operands' device as ordered segment sums (:class:`Schedule`,
:func:`run_schedule`): the triples sorted by output slot once, then the
k-th term of every slot added in one elementwise step.  No atomic
scatter and no ``index_add_``, so every sum runs in one order on every
device — the order of ``jax.ops.segment_sum`` on the JAX package's CPU,
each slot's terms in schedule order.  The JAX package pads its schedules
to a ``size_bucket`` ladder only so that XLA does not retrace; eager
torch needs no padding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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


# ------------------------------------------------------------ symbolic
def as_index(a, device) -> torch.Tensor:
    """An index array (numpy or tensor) as int64 on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=torch.int64)


def spgemm_symbolic(Aptr, Aind, Bptr, Bind, n_rows: int, n_cols_B: int,
                    device="cpu"):
    """Symbolic product C = A·B as a triple schedule, computed on
    ``device``: returns int64 tensors there, ``(tA, tB, t_out,
    C_indptr, C_indices)`` with ``C.data[t_out[q]] += A.data[tA[q]] *
    B.data[tB[q]]``.  The triples come sorted by output slot, stably
    (each slot's terms in A's entry order, B's row order within): one
    stable sort of the (row, column) keys gives both the pattern and
    that order.  Every step is integer work whose result does not depend
    on the device (a card expands and sorts 10⁸ terms in a fraction of a
    second)."""
    dev = torch.device(device)
    Aptr, Aind = as_index(Aptr, dev), as_index(Aind, dev)
    Bptr, Bind = as_index(Bptr, dev), as_index(Bind, dev)
    cnt = (Bptr[1:] - Bptr[:-1])[Aind]
    tA = torch.repeat_interleave(torch.arange(len(Aind), device=dev), cnt)
    # term q of A entry e reads B entry Bptr[Aind[e]] + (q - first[e])
    shift_of = Bptr[:-1][Aind] - (torch.cumsum(cnt, 0) - cnt)
    tB = torch.arange(len(tA), device=dev) + shift_of[tA]
    del shift_of, cnt
    row_of = torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                     Aptr[1:] - Aptr[:-1])
    key = row_of[tA] * n_cols_B + Bind[tB]
    del row_of
    order, t_out, C_indptr, C_indices = sort_terms(key, n_rows, n_cols_B)
    return tA[order], tB[order], t_out, C_indptr, C_indices


def sort_terms(key: torch.Tensor, n_rows: int, n_cols: int):
    """The terms of a product keyed by their output slot ``row·n_cols +
    col`` (an int64 tensor), sorted stably on its device: ``(order,
    t_out, C_indptr, C_indices)`` — the permutation, each sorted term's
    slot, and the output's CSR pattern (tensors on that device)."""
    ks, order = torch.sort(key, stable=True)
    new = torch.ones(len(ks), dtype=torch.bool, device=ks.device)
    new[1:] = ks[1:] != ks[:-1]
    t_out = torch.cumsum(new, 0) - 1
    ukey = ks[new]
    C_indices = (ukey % n_cols).to(torch.int32)
    C_indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=ks.device)
    C_indptr[1:] = torch.cumsum(
        torch.bincount(ukey // n_cols, minlength=n_rows), 0)
    return order, t_out, C_indptr, C_indices


# ------------------------------------------------------ host patterns
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


# ------------------------------------------------- ordered segment sums
def _small(t: torch.Tensor) -> torch.Tensor:
    """int32 where the index space allows (halves a schedule's bytes)."""
    return t.to(torch.int32) \
        if t.numel() == 0 or int(t.max()) < 2 ** 31 else t


@dataclasses.dataclass
class Schedule:
    """``out[s] = Σ a[t_a]·b[t_b]`` (or ``Σ a[t_a]`` when ``t_b`` is None)
    over the terms of slot s, the terms sorted by slot.  ``start`` holds
    each slot's first term, slots ordered by decreasing term count;
    ``steps[k]`` is how many slots have more than k terms; ``rank[s]`` is
    slot s's place in that order.  The index tensors stay on the device
    that built them."""
    t_a: torch.Tensor
    t_b: Optional[torch.Tensor]
    start: torch.Tensor
    steps: Tuple[int, ...]
    rank: torch.Tensor
    n_out: int

    @property
    def nbytes(self) -> int:
        arrs = (self.t_a, self.t_b, self.start, self.rank)
        return int(sum(a.numel() * a.element_size()
                       for a in arrs if a is not None))

    def device_arrays(self, device) -> dict:
        def up(a):
            return a.to(device)
        return {"t_a": up(self.t_a),
                "t_b": None if self.t_b is None else up(self.t_b),
                "start": up(self.start), "rank": up(self.rank)}


def ordered_schedule(t_a, t_b, t_out, n_out: int) -> Schedule:
    """The :class:`Schedule` of a term list sorted by output slot
    (:func:`spgemm_symbolic`; tensors on one device), every slot with a
    term."""
    dev = t_out.device
    cnt = torch.bincount(t_out, minlength=n_out)
    if n_out and int(cnt.min()) == 0 or \
            bool((t_out[1:] < t_out[:-1]).any()):
        raise ValueError("triples not sorted by slot, or a slot without "
                         "a term")
    first = torch.cumsum(cnt, 0) - cnt
    by_cnt = torch.sort(-cnt, stable=True).indices
    rank = torch.empty_like(by_cnt)
    rank[by_cnt] = torch.arange(n_out, device=dev)
    # steps[k-1]: the slots with at least k terms, k = 1 .. max count
    hist = torch.bincount(cnt)[1:] if n_out else cnt
    steps = tuple(int(v) for v in torch.flip(
        torch.cumsum(torch.flip(hist, (0,)), 0), (0,)).tolist())
    return Schedule(t_a=_small(t_a),
                    t_b=None if t_b is None else _small(t_b),
                    start=_small(first[by_cnt]), steps=steps,
                    rank=_small(rank), n_out=int(n_out))


def run_schedule(sch: Schedule, dev: dict, a: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The slot sums of ``sch`` on ``a``'s device (``dev`` holds the
    schedule's device index arrays): the terms in slot order, then the
    k-th term of every slot that has one added in one step.  ``a`` may
    carry trailing dimensions (b×b blocks) when ``b`` is None."""
    prod = a[dev["t_a"]] if b is None else a[dev["t_a"]] * b[dev["t_b"]]
    start = dev["start"]
    acc = prod[start]
    for k, m in enumerate(sch.steps[1:], 1):
        acc[:m] += prod[start[:m] + k]
    return acc[dev["rank"]]


def transpose_perm(P: sp.csr_matrix) -> Tuple[np.ndarray, sp.csr_matrix]:
    """R = Pᵀ with the data permutation recorded:
    ``R.data = P.data[perm]``.  Returns (perm, R with probe data)."""
    probe = sp.csr_matrix((np.arange(P.nnz, dtype=np.float64), P.indices,
                           P.indptr), shape=P.shape)
    R = sp.csr_matrix(probe.T)
    R.sort_indices()
    return np.rint(R.data).astype(np.int64), R


class _DevicePlan:
    """Per-device copies of a plan's index arrays, uploaded at the first
    numeric pass on a device."""

    def _device_arrays(self, device) -> dict:
        device = torch.device(device)
        if self._dev is None or self._dev[0] != device:
            self._dev = (device, self._upload(device))
        return self._dev[1]


@dataclasses.dataclass
class GalerkinPlan(_DevicePlan):
    """One pattern's reusable Galerkin product: the ordered schedules of
    ``AP = A·P`` and ``Ac = R·AP`` (R = Pᵀ through a recorded data
    permutation) and the coarse CSR pattern.  Built once per (A pattern,
    P pattern); the numeric pass is device work only."""
    nnz_A: int
    nnz_P: int
    nnz_AP: int
    nnz_Ac: int
    perm_RP: np.ndarray
    ap: Schedule
    ac: Schedule
    Ac_indptr: np.ndarray
    Ac_indices: np.ndarray
    Ac_shape: tuple
    _dev: Optional[tuple] = None

    @property
    def nbytes(self) -> int:
        """Index bytes of the plan — the plan cache's accounting
        unit."""
        return int(self.perm_RP.nbytes) + self.ap.nbytes + \
            self.ac.nbytes + int(self.Ac_indices.nbytes) + \
            int(self.Ac_indptr.nbytes)

    def _upload(self, device) -> dict:
        return {"perm": torch.from_numpy(self.perm_RP).to(device),
                "ap": self.ap.device_arrays(device),
                "ac": self.ac.device_arrays(device)}


def build_galerkin_plan(A: sp.csr_matrix, P: sp.csr_matrix,
                        device="cpu", max_bytes: Optional[int] = None,
                        P_left: Optional[sp.csr_matrix] = None
                        ) -> Optional[GalerkinPlan]:
    """Symbolic pass of the product ``R·(A·P)`` on ``device``.  ``A`` and
    ``P`` must have sorted indices; only the patterns are read.  None,
    before the second product's symbolic pass, when the two schedules'
    index pairs alone would pass ``max_bytes``.

    ``P_left``: the left factor when it differs from ``P`` (R =
    P_leftᵀ) — the distributed shard-local partial
    ``P_locᵀ·(A_loc·P_ext)``, ``P_ext`` = [P_loc | halo'd P rows]; its
    rows must be the leading rows of ``P``, so ``P_left.data`` is a
    prefix of ``P.data`` and the recorded permutation indexes P's
    values (``build_galerkin_plan`` upstream)."""
    n_out = A.shape[0]
    nc = P.shape[1]
    tA, tP, to1, APptr, APind = spgemm_symbolic(
        A.indptr, A.indices, P.indptr, P.indices, n_out, nc, device)
    perm_RP, R = transpose_perm(P if P_left is None else P_left)
    Rind = as_index(R.indices, APptr.device)
    if max_bytes is not None and 8 * (len(tA) + int(
            (APptr[1:] - APptr[:-1])[Rind].sum())) > max_bytes:
        return None
    ap = ordered_schedule(tA, tP, to1, len(APind))
    del tA, tP, to1
    tR, tAP, to2, Acptr, Acind = spgemm_symbolic(
        R.indptr, Rind, APptr, APind, nc, nc, device)
    return GalerkinPlan(
        nnz_A=A.nnz, nnz_P=P.nnz, nnz_AP=len(APind), nnz_Ac=len(Acind),
        perm_RP=perm_RP.astype(np.int32) if P.nnz < 2 ** 31 else perm_RP,
        ap=ap, ac=ordered_schedule(tR, tAP, to2, len(Acind)),
        Ac_indptr=Acptr.cpu().numpy(), Ac_indices=Acind.cpu().numpy(),
        Ac_shape=(nc, nc))


def galerkin_numeric(plan: GalerkinPlan, vA: torch.Tensor,
                     vP: torch.Tensor) -> torch.Tensor:
    """Numeric pass on ``vA``'s device: (A values, P values) in CSR data
    order → the (nnz_Ac,) coarse values."""
    d = plan._device_arrays(vA.device)
    vAP = run_schedule(plan.ap, d["ap"], vA, vP)
    return run_schedule(plan.ac, d["ac"], vP[d["perm"]], vAP)


@dataclasses.dataclass
class SpGEMMPlan(_DevicePlan):
    """One pattern pair's ``C = A·B`` schedule (both passes on the
    operands' device) — the single-product sibling of
    :class:`GalerkinPlan`."""
    nnz_A: int
    nnz_B: int
    nnz_C: int
    sched: Schedule
    C_indptr: np.ndarray
    C_indices: np.ndarray
    C_shape: tuple
    _dev: Optional[tuple] = None

    @property
    def nbytes(self) -> int:
        return self.sched.nbytes + int(self.C_indices.nbytes) + \
            int(self.C_indptr.nbytes)

    def _upload(self, device) -> dict:
        return self.sched.device_arrays(device)


def build_spgemm_plan(A: sp.csr_matrix, B: sp.csr_matrix,
                      device="cpu") -> SpGEMMPlan:
    tA, tB, to, Cptr, Cind = spgemm_symbolic(
        A.indptr, A.indices, B.indptr, B.indices, A.shape[0],
        B.shape[1], device)
    return SpGEMMPlan(nnz_A=A.nnz, nnz_B=B.nnz, nnz_C=len(Cind),
                      sched=ordered_schedule(tA, tB, to, len(Cind)),
                      C_indptr=Cptr.cpu().numpy(),
                      C_indices=Cind.cpu().numpy(),
                      C_shape=(A.shape[0], B.shape[1]))


def spgemm_numeric(plan: SpGEMMPlan, vA: torch.Tensor,
                   vB: torch.Tensor) -> torch.Tensor:
    """Numeric pass of ``C = A·B`` on ``vA``'s device; the (nnz_C,)
    values of C in its CSR order."""
    return run_schedule(plan.sched, plan._device_arrays(vA.device), vA, vB)

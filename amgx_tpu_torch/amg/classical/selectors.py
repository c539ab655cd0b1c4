"""C/F splitting selectors for classical AMG (port of
``amgx_tpu/amg/classical/selectors.py``, copied; reference
``core/src/classical/selectors/`` — PMIS, HMIS, RS, CR,
AGGRESSIVE_PMIS/AGGRESSIVE_HMIS and DUMMY, registered core.cu:662-667).
Host numpy/scipy setup code.

The tie-break seeds are the JAX package's: 7 (PMIS, HMIS), 11 (the
second pass of the aggressive selectors) and 13 (CR) with
``determinism_flag``, else the process's ``SESSION_SEED``.  RS is a
serial Python heap: a small-size selector.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp

from ...errors import BadConfigurationError

_selector_registry: Dict[str, type] = {}

COARSE, FINE, UNDECIDED = 1, 0, -1

#: tie-break seed when ``determinism_flag`` is off: one fixed seed per
#: process rather than global RNG state, so results never depend on what
#: else the process computed (``utils/determinism.py:SESSION_SEED`` of
#: the JAX package, copied)
SESSION_SEED = 0x5EED


def pmis_tie_breaker(n: int, seed: int) -> np.ndarray:
    """Strictly distinct fractional tie-break weights in (0, 1):
    ``frac_i = (perm(i) + 1) / (n + 2)`` with ``perm(i) = (a·i + seed) mod
    n`` an affine bijection of ``[0, n)`` (``a`` coprime to ``n``), so no
    two nodes share a weight and the two-phase rounds cannot deadlock."""
    return tie_break_for(n, seed, np.arange(n, dtype=np.int64))


def tie_break_for(n: int, seed: int, gids: np.ndarray) -> np.ndarray:
    """The tie-break fractions of arbitrary ids — a pure function of
    ``(n, seed, gid)``."""
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    a = 2654435761  # Knuth multiplier; < 2^32 so a*i fits uint64 exactly
    while np.gcd(a, n) != 1:
        a += 1
    perm = (gids.astype(np.uint64) * np.uint64(a)
            + np.uint64(seed % n)) % np.uint64(n)
    return (perm.astype(np.float64) + 1.0) / float(n + 2)


def register_cf_selector(name):
    def deco(cls):
        _selector_registry[name] = cls
        cls.config_name = name
        return cls
    return deco


def create_cf_selector(name, cfg, scope):
    if name not in _selector_registry:
        raise BadConfigurationError(f"unknown classical selector {name!r}")
    return _selector_registry[name](cfg, scope)


class _CFSelectorBase:
    def __init__(self, cfg, scope):
        self.cfg = cfg
        self.scope = scope
        self.deterministic = bool(cfg.get("determinism_flag"))

    def select(self, S: sp.csr_matrix) -> np.ndarray:
        """Given the strength matrix S (i strongly depends on j), return
        cf_map: (n,) with COARSE=1 / FINE=0."""
        raise NotImplementedError


def _pmis(S: sp.csr_matrix, seed: int = 7) -> np.ndarray:
    """Parallel modified independent set over the symmetrised strength
    graph (Luby-style, as in the reference's PMIS)."""
    n = S.shape[0]
    G = (S + S.T).tocsr()  # undirected influence graph
    G.eliminate_zeros()
    indptr, indices = G.indptr, G.indices
    deg = np.diff(indptr)
    # weight = #nodes i influences + a distinct tie-break in (0, 1)
    ST = sp.csr_matrix(S.T)
    lam = np.diff(ST.indptr).astype(np.float64)
    w = lam + pmis_tie_breaker(n, seed)

    state = np.full(n, UNDECIDED, dtype=np.int8)
    state[deg == 0] = FINE  # isolated nodes: fine (nothing to interpolate)
    while np.any(state == UNDECIDED):
        und = state == UNDECIDED
        n_und_before = int(und.sum())
        # i becomes C iff w_i > w_j for all undecided neighbours j
        rows = np.repeat(np.arange(n), deg)
        nb_und = und[rows] & und[indices]
        max_nb_w = np.zeros(n)
        np.maximum.at(max_nb_w, rows[nb_und], w[indices[nb_und]])
        has_nb = np.zeros(n, dtype=bool)
        has_nb[rows[nb_und]] = True
        become_c = und & ((~has_nb) | (w > max_nb_w))
        state[become_c] = COARSE
        # undecided neighbours of new C points become F
        new_c_entries = become_c[indices] & (state[rows] == UNDECIDED)
        f_nodes = np.unique(rows[new_c_entries])
        state[f_nodes] = FINE
        if int((state == UNDECIDED).sum()) == n_und_before:
            raise RuntimeError(
                "PMIS made no progress in a round — tie-break weights "
                "are not distinct (internal invariant violated)")
    return (state == COARSE).astype(np.int8)


@register_cf_selector("PMIS")
class PMISSelector(_CFSelectorBase):
    """Parallel Modified Independent Set (``selectors/pmis.cu``)."""

    def select(self, S):
        seed = 7 if self.deterministic else SESSION_SEED
        return _pmis(S, seed)


@register_cf_selector("HMIS")
class HMISSelector(_CFSelectorBase):
    """HMIS (``selectors/hmis.cu``): PMIS on the distance-2 strength graph
    (S·Sᵀ sparsity), giving the sparser coarse grids of Hybrid-MIS."""

    def select(self, S):
        S2 = sp.csr_matrix(S.astype(np.float64) @ S.T.astype(np.float64))
        S2.setdiag(0)
        S2.eliminate_zeros()
        S2.data[:] = 1
        seed = 7 if self.deterministic else SESSION_SEED
        return _pmis(sp.csr_matrix(S2.astype(np.int8)), seed)


@register_cf_selector("RS")
class RSSelector(_CFSelectorBase):
    """Sequential Ruge-Stüben first pass (``selectors/rs.cu``): greedy
    max-λ selection with neighbour updates (host-side; setup only)."""

    def select(self, S):
        n = S.shape[0]
        lam = np.diff(sp.csr_matrix(S.T).indptr).astype(np.int64)
        state = np.full(n, UNDECIDED, dtype=np.int8)
        Su = sp.csr_matrix(S)
        STu = sp.csr_matrix(S.T)
        import heapq
        heap = [(-lam[i], i) for i in range(n)]
        heapq.heapify(heap)
        while heap:
            nl, i = heapq.heappop(heap)
            if state[i] != UNDECIDED or -nl != lam[i]:
                continue
            state[i] = COARSE
            # dependents of i become F; their influences gain weight
            deps = STu.indices[STu.indptr[i]:STu.indptr[i + 1]]
            for j in deps:
                if state[j] == UNDECIDED:
                    state[j] = FINE
                    infl = Su.indices[Su.indptr[j]:Su.indptr[j + 1]]
                    for k in infl:
                        if state[k] == UNDECIDED:
                            lam[k] += 1
                            heapq.heappush(heap, (-lam[k], k))
        state[state == UNDECIDED] = FINE
        return (state == COARSE).astype(np.int8)


@register_cf_selector("AGGRESSIVE_PMIS")
class AggressivePMISSelector(PMISSelector):
    """Aggressive coarsening: PMIS, then a second PMIS among the C points
    over the distance-2 graph (``classical_amg_level.cu:155-201``)."""

    def select(self, S):
        cf = super().select(S)
        c_idx = np.flatnonzero(cf)
        if len(c_idx) < 2:
            return cf
        # strength graph among C points at distance ≤ 2
        Sf = sp.csr_matrix(S.astype(np.float64))
        S2 = sp.csr_matrix(Sf @ Sf + Sf)
        Scc = S2[c_idx][:, c_idx]
        Scc = sp.csr_matrix(Scc)
        Scc.setdiag(0)
        Scc.eliminate_zeros()
        Scc.data[:] = 1
        seed = 11 if self.deterministic else SESSION_SEED
        cf_c = _pmis(sp.csr_matrix(Scc.astype(np.int8)), seed)
        out = np.zeros_like(cf)
        out[c_idx[cf_c.astype(bool)]] = 1
        return out


@register_cf_selector("AGGRESSIVE_HMIS")
class AggressiveHMISSelector(HMISSelector):
    def select(self, S):
        cf = super().select(S)
        c_idx = np.flatnonzero(cf)
        if len(c_idx) < 2:
            return cf
        Sf = sp.csr_matrix(S.astype(np.float64))
        S2 = sp.csr_matrix(Sf @ Sf + Sf)
        Scc = sp.csr_matrix(S2[c_idx][:, c_idx])
        Scc.setdiag(0)
        Scc.eliminate_zeros()
        if Scc.nnz:
            Scc.data[:] = 1
        seed = 11 if self.deterministic else SESSION_SEED
        cf_c = _pmis(sp.csr_matrix(Scc.astype(np.int8)), seed)
        out = np.zeros_like(cf)
        out[c_idx[cf_c.astype(bool)]] = 1
        return out


@register_cf_selector("DUMMY")
class DummyCFSelector(_CFSelectorBase):
    """Every other point coarse (``selectors/dummy.cu`` parity)."""

    def select(self, S):
        n = S.shape[0]
        cf = np.zeros(n, dtype=np.int8)
        cf[::2] = 1
        return cf


@register_cf_selector("CR")
class CRSelector(_CFSelectorBase):
    """Compatible-relaxation selector (used by energymin; reference
    ``selectors/cr.cu``): start from PMIS and promote slow-to-relax points."""

    def select(self, S):
        return _pmis(S, 13)

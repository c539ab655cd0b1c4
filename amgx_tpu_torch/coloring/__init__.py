"""Graph coloring for color-parallel smoothers (a copy of
``amgx_tpu/coloring/__init__.py``: numpy only; the colors equal the JAX
package's).

Reference: ``core/src/matrix_coloring/`` (~6.7k LoC, 11 algorithms,
registered ``core.cu:685-694``).  Colors expose row-parallelism inside
GS/ILU/DILU sweeps: rows of one color have no mutual edges, so a whole
color updates as one vector op.

Host-side numpy implementations (setup phase).  ``coloring_level=2`` colors
the distance-2 graph (``core.cu:512``).  The ``determinism_flag`` seeds the
hashes (SURVEY §5.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import scipy.sparse as sp

from ..errors import BadConfigurationError
from ..utils.determinism import SESSION_SEED

_coloring_registry: Dict[str, type] = {}


def register_coloring(name):
    def deco(cls):
        _coloring_registry[name] = cls
        cls.config_name = name
        return cls
    return deco


def create_coloring(name, cfg, scope):
    if name not in _coloring_registry:
        raise BadConfigurationError(
            f"unknown coloring scheme {name!r}; known: "
            f"{sorted(_coloring_registry)}")
    return _coloring_registry[name](cfg, scope)


@dataclasses.dataclass
class MatrixColoring:
    """Attached to a matrix after coloring (reference ``MatrixColoring``,
    matrix.h:108)."""

    colors: np.ndarray      # (n,) int32 color per row
    num_colors: int

    def rows_of(self, c):
        return np.flatnonzero(self.colors == c)


def _adjacency(A: sp.csr_matrix, level: int) -> sp.csr_matrix:
    """Symmetric adjacency of the (distance-``level``) graph."""
    G = sp.csr_matrix(A)
    G = (abs(G) + abs(G).T).tocsr()
    if level >= 2:
        G2 = G
        for _ in range(level - 1):
            G2 = sp.csr_matrix(G2 @ G)
        G = G2.tocsr()
    G.setdiag(0)
    G.eliminate_zeros()
    return G


def check_coloring(A: sp.csr_matrix, coloring: MatrixColoring,
                   level: int = 1) -> float:
    """Fraction of edges whose endpoints share a color (0.0 = perfect);
    the reference tolerates ``max_uncolored_percentage`` imperfection."""
    G = _adjacency(A, level)
    rows = np.repeat(np.arange(G.shape[0]), np.diff(G.indptr))
    bad = coloring.colors[rows] == coloring.colors[G.indices]
    return float(bad.sum()) / max(G.nnz, 1)


class _ColoringBase:
    def __init__(self, cfg, scope):
        self.cfg = cfg
        self.scope = scope
        self.level = int(cfg.get("coloring_level", scope))
        self.deterministic = bool(cfg.get("determinism_flag"))
        self.max_uncolored = float(cfg.get("max_uncolored_percentage", scope))

    def color(self, A: sp.csr_matrix) -> MatrixColoring:
        raise NotImplementedError


def _exact_color_leftovers(indptr, indices, colors: np.ndarray) -> None:
    """Sequential exact first-fit for the nodes the vectorized 63-bit
    used-color masks could not place: on graphs needing more than 63
    colors the mask saturates (``free == 0``), and lumping the leftovers
    into one shared color would be an IMPROPER coloring.  Per node the
    smallest color absent from its neighbourhood is exact for any color
    count; the leftover set is tiny (the saturated tail), so the python
    loop is negligible."""
    for v in np.flatnonzero(colors < 0):
        nb = colors[indices[indptr[v]:indptr[v + 1]]]
        used = set(int(c) for c in nb[nb >= 0])
        c = 0
        while c in used:
            c += 1
        colors[v] = c


def _jones_plassmann(G: sp.csr_matrix, seed: int, max_hash_rounds: int = 64
                     ) -> MatrixColoring:
    """Jones-Plassmann with hashed weights: a node takes the smallest color
    not used by any neighbour that beat it; local maxima color themselves
    each round.  This is the MIN_MAX family's strategy
    (``min_max.cu``/``min_max_2ring.cu``)."""
    n = G.shape[0]
    indptr, indices = G.indptr, G.indices
    rows = np.repeat(np.arange(n), np.diff(indptr))
    h = ((np.arange(n, dtype=np.uint64) * np.uint64(2654435761) +
          np.uint64(seed)) % np.uint64(1 << 30)).astype(np.int64)
    colors = np.full(n, -1, dtype=np.int64)
    deferred = np.zeros(n, dtype=bool)
    for _ in range(max_hash_rounds):
        un = (colors < 0) & ~deferred
        if not un.any():
            break
        both = un[rows] & un[indices]
        # local max among uncolored neighbours → gets colored this round
        nb_max = np.full(n, -1, dtype=np.int64)
        np.maximum.at(nb_max, rows[both], h[indices[both]])
        winners = un & (h > nb_max)
        if not winners.any():
            # tie pathologies: bump hashes and retry
            h = (h * 31 + 7) % (1 << 30)
            continue
        # smallest color unused by already-colored neighbours, vectorised
        # via a 63-bit used-color mask per row
        nb_colored = colors[indices] >= 0
        bits = np.zeros(n, dtype=np.int64)
        e = nb_colored & winners[rows]
        np.bitwise_or.at(bits, rows[e],
                         np.int64(1) << np.minimum(colors[indices[e]], 62))
        free = (~bits) & ~(~np.int64(0) << 63)
        # index of lowest set bit of `free`; a SATURATED mask (free==0,
        # >63 neighbour colors) must not color via log2(0) — DEFER the
        # node to the exact pass and drop it from the competition, or a
        # saturated hub that keeps the max hash would stall its whole
        # uncolored neighbourhood until the round cap (guard analog of
        # _recolor_compact's lowbit>0 check)
        lowbit = free & -free
        ok = winners & (lowbit > 0)
        colors[ok] = np.round(np.log2(lowbit[ok].astype(
            np.float64))).astype(np.int64)
        deferred |= winners & (lowbit == 0)
    _exact_color_leftovers(indptr, indices, colors)
    return MatrixColoring(colors=colors.astype(np.int32),
                          num_colors=int(colors.max()) + 1)


@register_coloring("MIN_MAX")
class MinMaxColoring(_ColoringBase):
    """Hash-based parallel coloring (reference ``min_max.cu``)."""

    def color(self, A):
        G = _adjacency(A, self.level)
        return _jones_plassmann(G, 7 if self.deterministic else SESSION_SEED)


@register_coloring("MIN_MAX_2RING")
class MinMax2RingColoring(_ColoringBase):
    """Distance-2 min-max coloring (``min_max_2ring.cu``)."""

    def color(self, A):
        G = _adjacency(A, max(self.level, 2))
        # determinism is free on this backend: the non-deterministic mode
        # still uses a fixed seed so results never depend on global RNG
        # state (utils.determinism.SESSION_SEED)
        return _jones_plassmann(G, 7 if self.deterministic else SESSION_SEED)


def _priority_greedy_color(G: sp.csr_matrix, prio: np.ndarray,
                           seed: int, max_rounds: int = 64
                           ) -> MatrixColoring:
    """First-fit greedy coloring as VECTORIZED fixed-point rounds: each
    round the uncolored nodes that beat every uncolored neighbour's
    priority take the smallest color unused by their colored neighbours
    (63-bit used-color masks — no python per-node loop).

    With a strictly-distinct priority this reproduces the sequential
    first-fit greedy in descending-priority order exactly; past
    ``max_rounds`` (adversarial orders: a path walked end-to-end) the
    remaining nodes finish with hash priorities — still a proper
    coloring, same color-count class.  This is the same round structure
    as the reference's parallel greedy kernels
    (``parallel_greedy.cu``)."""
    n = G.shape[0]
    indptr, indices = G.indptr, G.indices
    rows = np.repeat(np.arange(n), np.diff(indptr))
    # strictly-distinct composite priority; ties break by a BIJECTIVE
    # pseudorandom permutation, not by index — an index tiebreak builds
    # monotone chains (one winner per mesh line per round: measured
    # 15 s at 10⁶ rows) while a scrambled tiebreak converges in O(log n)
    # rounds like Jones-Plassmann
    from ..amg.classical.device_fine import pmis_multiplier
    a = np.uint64(pmis_multiplier(max(n, 1)))
    perm = ((np.arange(n, dtype=np.uint64) * a + np.uint64(seed)) %
            np.uint64(max(n, 1))).astype(np.int64)
    p = prio.astype(np.int64) * np.int64(n) + perm
    colors = np.full(n, -1, dtype=np.int64)
    deferred = np.zeros(n, dtype=bool)
    h = ((np.arange(n, dtype=np.uint64) * np.uint64(2654435761) +
          np.uint64(seed)) % np.uint64(1 << 30)).astype(np.int64)
    for rnd in range(2 * max_rounds):
        un = (colors < 0) & ~deferred
        if not un.any():
            break
        if rnd == max_rounds:
            # order-faithful rounds stalled (long monotone chains):
            # finish with hash priorities, which converge in O(log n)
            p = h * np.int64(n) + np.arange(n, dtype=np.int64)
        both = un[rows] & un[indices]
        nb_max = np.full(n, np.iinfo(np.int64).min, dtype=np.int64)
        np.maximum.at(nb_max, rows[both], p[indices[both]])
        winners = un & (p > nb_max)
        nb_colored = colors[indices] >= 0
        bits = np.zeros(n, dtype=np.int64)
        e = nb_colored & winners[rows]
        np.bitwise_or.at(bits, rows[e],
                         np.int64(1) << np.minimum(colors[indices[e]],
                                                   62))
        free = (~bits) & ~(~np.int64(0) << 63)
        # saturated 63-bit masks (>63-color graphs, e.g. large cliques)
        # yield free==0: log2(0) would leave those nodes "uncolorable"
        # and the old leftover-lumping gave them ONE shared color — a
        # silently improper coloring.  Guard like _recolor_compact,
        # DEFER the saturated winners out of the competition (a
        # saturated high-priority hub must not stall its neighbourhood
        # until the round cap), and place them in the exact pass.
        lowbit = free & -free
        ok = winners & (lowbit > 0)
        colors[ok] = np.round(np.log2(lowbit[ok].astype(
            np.float64))).astype(np.int64)
        deferred |= winners & (lowbit == 0)
    _exact_color_leftovers(indptr, indices, colors)
    return MatrixColoring(colors=colors.astype(np.int32),
                          num_colors=int(colors.max()) + 1)


def _recolor_compact(G: sp.csr_matrix, col: MatrixColoring,
                     max_passes: int = 8) -> MatrixColoring:
    """Greedy RECOLOR pass (``greedy_recolor.cu``): nodes of the
    top (largest-index) color class move to the smallest free smaller
    color.  A color class is an independent set, so every move in one
    pass is simultaneously safe — fully vectorized.  When the whole top
    class empties, the color count drops; passes repeat until a class
    resists."""
    n = G.shape[0]
    indptr, indices = G.indptr, G.indices
    rows = np.repeat(np.arange(n), np.diff(indptr))
    colors = col.colors.astype(np.int64).copy()
    k = col.num_colors
    for _ in range(max_passes):
        if k <= 1:
            break
        top = k - 1
        movers = colors == top
        if not movers.any():
            k -= 1
            continue
        bits = np.zeros(n, dtype=np.int64)
        e = movers[rows] & (colors[indices] >= 0) & \
            (colors[indices] < top)
        np.bitwise_or.at(bits, rows[e],
                         np.int64(1) << np.minimum(colors[indices[e]],
                                                   62))
        free = (~bits) & ~(~np.int64(0) << 63) & \
            ((np.int64(1) << np.int64(min(top, 62))) - 1)
        lowbit = free & -free
        can = movers & (lowbit > 0)
        colors[can] = np.round(np.log2(lowbit[can].astype(
            np.float64))).astype(np.int64)
        if not (movers & ~can).any():
            k -= 1               # class emptied: fewer colors
        else:
            break                # a stuck node keeps the class alive
    return MatrixColoring(colors=colors.astype(np.int32),
                          num_colors=int(colors.max()) + 1)


@register_coloring("GREEDY_MIN_MAX_2RING")
class GreedyMinMax2RingColoring(MinMax2RingColoring):
    """``greedy_min_max_2ring.cu``: min-max (Jones-Plassmann) coloring
    of the DISTANCE-2 graph followed by the greedy recolor refinement on
    the same 2-ring — typically one or two fewer colors than plain
    MIN_MAX_2RING (= fewer masked sweeps per DILU/GS application)."""

    def color(self, A):
        G = _adjacency(A, max(self.level, 2))
        base = _jones_plassmann(G, 7 if self.deterministic
                                else SESSION_SEED)
        return _recolor_compact(G, base)


@register_coloring("PARALLEL_GREEDY")
class ParallelGreedyColoring(_ColoringBase):
    """``parallel_greedy.cu``: first-fit greedy with highest-degree
    priority, run as vectorized conflict-free rounds
    (:func:`_priority_greedy_color`)."""

    def color(self, A):
        G = _adjacency(A, self.level)
        deg = np.diff(G.indptr).astype(np.int64)
        return _priority_greedy_color(
            G, deg, 7 if self.deterministic else SESSION_SEED)


@register_coloring("SERIAL_GREEDY_BFS")
class SerialGreedyBFSColoring(ParallelGreedyColoring):
    """``serial_greedy_bfs.cu`` parity — first-fit greedy in BFS order,
    vectorized: BFS ranks (scipy csgraph, C speed) become the round
    priority, so mesh-like graphs reproduce the serial result in a few
    fronts' worth of rounds."""

    def color(self, A):
        G = _adjacency(A, self.level)
        n = G.shape[0]
        order = sp.csgraph.breadth_first_order(
            G, 0, return_predecessors=False) if n else np.arange(0)
        seen = np.zeros(n, dtype=bool)
        seen[order] = True
        order = np.concatenate([order, np.flatnonzero(~seen)])
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.arange(n, dtype=np.int64)
        # rank order is inherently chain-like (each BFS front is an
        # ordered line): cap the order-faithful rounds early and let the
        # hash rounds finish — same color-count class, bounded time
        return _priority_greedy_color(
            G, -rank, 7 if self.deterministic else SESSION_SEED,
            max_rounds=16)


@register_coloring("ROUND_ROBIN")
class RoundRobinColoring(_ColoringBase):
    """``round_robin.cu``: color = row mod num_colors — cheap, imperfect
    (allowed by ``max_uncolored_percentage``)."""

    def color(self, A):
        k = int(self.cfg.get("num_colors", self.scope))
        n = A.shape[0]
        colors = (np.arange(n) % max(k, 1)).astype(np.int32)
        return MatrixColoring(colors=colors, num_colors=max(k, 1))


@register_coloring("UNIFORM")
class UniformColoring(_ColoringBase):
    """``uniform.cu``: geometric striping — valid for banded/stencil
    matrices when the stripe period exceeds the bandwidth."""

    def color(self, A):
        G = _adjacency(A, self.level)
        # period = max |i-j| over edges + 1 capped to a sane stripe count
        rows = np.repeat(np.arange(G.shape[0]), np.diff(G.indptr))
        bw = int(np.abs(rows - G.indices).max()) + 1 if G.nnz else 1
        k = min(bw, 32)
        colors = (np.arange(A.shape[0]) % k).astype(np.int32)
        return MatrixColoring(colors=colors, num_colors=k)


@register_coloring("MULTI_HASH")
class MultiHashColoring(_ColoringBase):
    """``multi_hash.cu``: several INDEPENDENT hashed colorings, keep the
    one with the fewest colors (the reference tries multiple hashes per
    node per round toward the same goal — fewer colors = fewer masked
    sweeps per DILU/GS application)."""

    #: independent hash attempts (reference default num_hash ~ 7-8)
    attempts = 8

    def color(self, A):
        G = _adjacency(A, self.level)
        base = 7 if self.deterministic else SESSION_SEED
        best = None
        for k in range(self.attempts):
            c = _jones_plassmann(G, base + 1009 * k)
            if best is None or c.num_colors < best.num_colors:
                best = c
            if best.num_colors <= 2:
                break                      # bipartite: can't do better
        return best


@register_coloring("GREEDY_RECOLOR")
class GreedyRecolorColoring(ParallelGreedyColoring):
    """``greedy_recolor.cu``: greedy coloring, then RECOLOR passes that
    empty the largest-index color classes into smaller free colors
    (every class is an independent set, so one pass's moves are
    simultaneously safe) — measurably fewer colors than the plain
    greedy on irregular graphs."""

    def color(self, A):
        G = _adjacency(A, self.level)
        deg = np.diff(G.indptr).astype(np.int64)
        seed = 7 if self.deterministic else SESSION_SEED
        base = _priority_greedy_color(G, deg, seed)
        # recolor pass 1: a SECOND first-fit greedy in descending-color
        # order (high-color nodes go first, so the classes that forced
        # the extra colors get first pick) — the classic
        # interchange-free recolor heuristic of greedy_recolor.cu
        rec = _priority_greedy_color(
            G, base.colors.astype(np.int64), seed + 1)
        if rec.num_colors > base.num_colors:
            rec = base
        # recolor pass 2: empty the top classes where safely possible
        return _recolor_compact(G, rec)


@register_coloring("LOCALLY_DOWNWIND")
class LocallyDownwindColoring(_ColoringBase):
    """``locally_downwind.cu``: color ORDER follows the advective flow.

    For convection-dominated operators a forward multicolor DILU/GS
    sweep is most effective when upstream rows update before the rows
    they feed (in the limit of pure advection the matrix is triangular
    in flow order and one sweep solves it).  Direction is read off the
    matrix asymmetry — ``|A[v,u]| > |A[u,v]|`` marks ``u`` upstream of
    ``v`` (upwind discretisations put the flow coupling on the upstream
    side) — then:

    * downwind LEVELS via a monotone fixed point
      ``lvl[v] = max(lvl[u]+1)`` over upstream edges (cycles saturate at
      the round cap),
    * each level is properly colored by Jones-Plassmann on its own
      subgraph, and global colors concatenate level by level — a PROPER
    coloring whose class order is the downwind order.
    """

    #: level-propagation cap (cycles in the flow graph saturate here)
    max_depth = 64

    def color(self, A):
        A = sp.csr_matrix(A)
        n = A.shape[0]
        coo = A.tocoo()
        off = coo.row != coo.col
        r, c, v = coo.row[off], coo.col[off], coo.data[off]
        Aabs = sp.csr_matrix((np.abs(v), (r, c)), shape=A.shape)
        diff = (Aabs - sp.csr_matrix(Aabs.T)).tocoo()
        m = diff.data > 0          # entry (v, u): u strictly upstream
        up_u, dn_v = diff.col[m], diff.row[m]
        lvl = np.zeros(n, dtype=np.int64)
        for _ in range(self.max_depth):
            new = np.zeros(n, dtype=np.int64)
            if len(dn_v):
                np.maximum.at(new, dn_v, lvl[up_u] + 1)
            new = np.maximum(new, lvl)
            if np.array_equal(new, lvl):
                break
            lvl = new
        G = _adjacency(A, self.level)
        colors = np.full(n, -1, dtype=np.int64)
        seed = 7 if self.deterministic else SESSION_SEED
        next_color = 0
        for L in np.unique(lvl):
            idx = np.flatnonzero(lvl == L)
            sub = sp.csr_matrix(G[idx][:, idx])
            cp = _jones_plassmann(sub, seed)
            colors[idx] = next_color + cp.colors
            next_color += cp.num_colors
        return MatrixColoring(colors=colors.astype(np.int32),
                              num_colors=int(next_color))


def color_matrix(matrix, cfg, scope) -> MatrixColoring:
    """Color a Matrix and cache the result on it (reference
    ``Matrix::colorMatrix`` / setupMatrix, matrix.cu:760-813)."""
    cached = getattr(matrix, "coloring", None)
    if cached is not None:
        return cached
    scheme = str(cfg.get("matrix_coloring_scheme", scope))
    algo = create_coloring(scheme, cfg, scope)
    if getattr(matrix, "blocks", None) is not None \
            and getattr(matrix, "_host", 1) is None:
        # block-distributed matrix: color each rank's diagonal block
        # independently (the reference also colors per-rank; cross-rank
        # edges are relaxed Jacobi-style by the masked sharded sweep); a
        # b×b upload colors its block graph
        offs = matrix.block_offsets
        parts = []
        num = 1
        for p, blk in enumerate(matrix.blocks):
            lo, hi = offs[p], offs[p + 1]
            if matrix.block_dim > 1:
                blk = sp.csr_matrix(
                    (np.ones(len(blk.indices)), blk.indices, blk.indptr),
                    shape=(len(blk.indptr) - 1,
                           blk.shape[1] // matrix.block_dim))
            sub = sp.csr_matrix(blk[:, lo:hi])
            cp = algo.color(sub)
            parts.append(cp.colors)
            num = max(num, cp.num_colors)
        coloring = MatrixColoring(np.concatenate(parts)
                                  if parts else np.zeros(0, np.int64), num)
        matrix.coloring = coloring
        return coloring
    if hasattr(matrix, "block_dim") and matrix.block_dim > 1:
        # color the block graph: one color per block row (matrix.h:108)
        bd = matrix.block_dim
        bsr = matrix.host if isinstance(matrix.host, sp.bsr_matrix) else \
            sp.bsr_matrix(matrix.host, blocksize=(bd, bd))
        nb = bsr.shape[0] // bd
        G = sp.csr_matrix(
            (np.ones(len(bsr.indices)), bsr.indices.copy(),
             bsr.indptr.copy()), shape=(nb, nb))
        coloring = algo.color(G)
    elif hasattr(matrix, "scalar_csr"):
        coloring = algo.color(matrix.scalar_csr())
    else:
        coloring = algo.color(sp.csr_matrix(matrix))
    if hasattr(matrix, "__dict__"):
        matrix.coloring = coloring
    return coloring

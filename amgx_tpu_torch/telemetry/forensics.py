"""Convergence forensics: where does the *error reduction* go?

The spans/cost-model layer (PRs 2-3) answers "where does the time go";
this module answers the numerical twin — which level or cycle component
stopped pulling its weight.  The reference ships the same visibility as
its grid/solve statistics machinery (``obtain_norm`` + the ``print_*``
knobs); here it is structured telemetry, gated by the ``forensics``
config knob (off by default; the traced cycle is unchanged when off).

Three pieces:

* **cycle anatomy** — :mod:`amgx_tpu_torch.amg.cycles` records, per
  level and per cycle, the residual norm at the four cut points (cycle
  entry, after pre-smooth, after the coarse-grid correction, after
  post-smooth) as ``cycle_level`` events (plus ``cycle_coarse`` for the
  coarsest-grid solve).  A graph cannot call the host, so each visit
  writes its norms into a slot of a device buffer (:class:`Tape`); the
  AMG solver keeps a copy of the buffer after every application and the
  solve emits the events once, after its last iteration, in the order
  the JAX package emits them.  :func:`cycle_anatomy` turns those into
  per-level/per-component reduction factors (geometric means) and
  :func:`weakest_component` names the bottleneck.
* **hierarchy quality probes** — :func:`probe_hierarchy` runs cheap
  algebraic health metrics per level at setup time: near-nullspace
  preservation ``‖A·1‖∞/‖A‖∞``, a sampled Galerkin consistency check
  (``R·A·P`` vs the stored coarse operator), CF-splitting/coarsening
  ratios and a strength-graph sample — exported as the
  ``amgx_forensics_*`` gauges and ``forensics_probe`` events.
* **per-solve estimate** — :func:`asymptotic_rate` estimates the
  asymptotic convergence factor from the trailing residual history
  (the early iterations of a Krylov-accelerated solve are not
  representative; the tail is what predicts iteration growth).

Everything here but :class:`Tape` is host-side (numpy/scipy).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import numpy as np

from . import recorder
from .metrics import gauge_set, registry

#: cut-point component names, in cycle order
COMPONENTS = ("pre_smooth", "coarse_corr", "post_smooth")

#: per-level probes never assemble a host CSR beyond this many rows —
#: forensics is opt-in, but a 128³ fine level is still ~2M rows and the
#: fine operator's health is visible from the sampled rows alone
PROBE_MAX_ROWS = 1 << 21

#: rows sampled for the strength-graph statistic
_STRENGTH_SAMPLE = 256
#: coarse rows sampled for the Galerkin consistency spot-check
_GALERKIN_SAMPLE = 64
#: the AHAT-style strength threshold used by the probe (a fixed probe
#: constant, not the configured one — the probe is a health indicator,
#: not a re-run of the setup)
_STRENGTH_THETA = 0.25

#: every gauge family this module owns (cleared before re-emission so a
#: shallower rebuild leaves no stale deep-level series)
FORENSICS_GAUGES = (
    "amgx_forensics_nullspace",
    "amgx_forensics_galerkin_err",
    "amgx_forensics_cf_ratio",
    "amgx_forensics_strong_frac",
)


# ------------------------------------------------------------- emission
def _scalar(v) -> float:
    """A recorded norm → float (the max over lanes, the solver's
    max-norm convention for telemetry, should one carry several)."""
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    return float(np.max(a)) if a.size else float("nan")


def emit_cycle_level(level: int, flavor: str, entry, pre, coarse, post):
    """Host-side sink of the cut-point norms of one level of one cycle
    (:meth:`Tape.emit` calls it)."""
    if not recorder.is_enabled():
        return
    recorder.event("cycle_level", level=int(level), flavor=str(flavor),
                   entry=_scalar(entry), pre=_scalar(pre),
                   coarse=_scalar(coarse), post=_scalar(post))


def emit_cycle_coarse(level: int, entry, exit_):
    """Coarsest-grid solve norms (two cut points: entry/exit)."""
    if not recorder.is_enabled():
        return
    recorder.event("cycle_coarse", level=int(level),
                   entry=_scalar(entry), exit=_scalar(exit_))


# ------------------------------------------------------------- analysis
def _gmean(factors: List[float]) -> Optional[float]:
    logs = [math.log(f) for f in factors
            if isinstance(f, (int, float)) and math.isfinite(f) and f > 0]
    if not logs:
        return None
    return float(math.exp(sum(logs) / len(logs)))


def _factor(num, den) -> Optional[float]:
    if not (isinstance(num, (int, float)) and isinstance(den, (int, float))):
        return None
    if not (math.isfinite(num) and math.isfinite(den)) or den <= 0:
        return None
    return num / den


def cycle_anatomy(records: Iterable[dict]) -> Dict:
    """Per-level/per-component reduction factors from ``cycle_level`` /
    ``cycle_coarse`` telemetry events.

    Returns ``{"levels": {lvl: {"cycles": n, "pre_smooth": f,
    "coarse_corr": f, "post_smooth": f, "total": f}}, "coarse":
    {"level": L, "cycles": n, "factor": f} | None}`` where each ``f`` is
    the geometric-mean per-cycle reduction factor of that component
    (None when no finite sample survived)."""
    per: Dict[int, Dict[str, List[float]]] = {}
    coarse: Dict[int, List[float]] = {}
    for r in records:
        if r.get("kind") != "event":
            continue
        a = r.get("attrs", {})
        if r.get("name") == "cycle_level":
            lvl = int(a.get("level", -1))
            d = per.setdefault(lvl, {c: [] for c in
                                     COMPONENTS + ("total",)})
            for comp, num, den in (("pre_smooth", a.get("pre"),
                                    a.get("entry")),
                                   ("coarse_corr", a.get("coarse"),
                                    a.get("pre")),
                                   ("post_smooth", a.get("post"),
                                    a.get("coarse")),
                                   ("total", a.get("post"),
                                    a.get("entry"))):
                f = _factor(num, den)
                if f is not None:
                    d[comp].append(f)
        elif r.get("name") == "cycle_coarse":
            f = _factor(a.get("exit"), a.get("entry"))
            if f is not None:
                coarse.setdefault(int(a.get("level", -1)), []).append(f)
    levels = {}
    for lvl, d in sorted(per.items()):
        levels[lvl] = {"cycles": max(len(v) for v in d.values())}
        for comp in COMPONENTS + ("total",):
            levels[lvl][comp] = _gmean(d[comp])
    coarse_out = None
    if coarse:
        lvl = max(coarse)
        coarse_out = {"level": lvl, "cycles": len(coarse[lvl]),
                      "factor": _gmean(coarse[lvl])}
    return {"levels": levels, "coarse": coarse_out}


#: per-component factor at which the component counts as outright
#: failing — the normalization that lets components compete on one
#: axis.  Coarse correction's bar is higher on purpose: its RESIDUAL
#: factor routinely exceeds 1 transiently on healthy cycles (the
#: prolongated correction injects high-frequency residual the
#: post-smoother removes), so ranking it raw against smoothing
#: factors would misattribute a dead smoother's bottleneck to a
#: healthy coarse correction.
_COMPONENT_BASELINE = {"pre_smooth": 1.0, "post_smooth": 1.0,
                       "coarse_corr": 1.5, "coarse_solve": 1.0}


def component_score(component: str, factor: float) -> float:
    """Cross-component severity: the factor normalised by the
    component's own failure baseline (1.0 ≈ 'does nothing at all' for
    a smoother, 'pathologically amplifying' for coarse correction)."""
    return factor / _COMPONENT_BASELINE.get(component, 1.0)


def weakest_component(anatomy: Dict) -> Optional[Dict]:
    """The level/component with the worst baseline-normalised
    reduction factor — the convergence bottleneck the doctor names.
    The coarsest-grid solve competes as component ``coarse_solve``.
    ``factor`` is the raw geometric-mean factor; ``score`` the
    normalised severity the ranking used."""
    worst = None
    candidates = [(int(lvl), comp, d.get(comp))
                  for lvl, d in anatomy.get("levels", {}).items()
                  for comp in COMPONENTS]
    c = anatomy.get("coarse")
    if c and c.get("factor") is not None:
        candidates.append((int(c["level"]), "coarse_solve",
                           c["factor"]))
    for lvl, comp, f in candidates:
        if f is None:
            continue
        score = component_score(comp, f)
        if worst is None or score > worst["score"]:
            worst = {"level": lvl, "component": comp, "factor": f,
                     "score": score}
    return worst


def asymptotic_rate(norms: List[float]) -> Optional[float]:
    """Asymptotic convergence-factor estimate from a residual history:
    the geometric-mean per-iteration reduction over the trailing half
    of the trajectory (min 2 steps).  The early iterations of a
    Krylov-accelerated solve over-perform; the tail is what predicts
    how iteration counts scale with problem size."""
    ns = [float(n) for n in norms
          if isinstance(n, (int, float)) and math.isfinite(n) and n > 0]
    if len(ns) < 3:
        return None
    m = max(2, (len(ns) - 1) // 2)
    a, b = ns[-1 - m], ns[-1]
    if a <= 0 or b <= 0:
        return None
    return float((b / a) ** (1.0 / m))


def analyze(records: Iterable[dict]) -> Optional[Dict]:
    """One-stop analysis of a record stream (a :class:`Capture`'s
    records, the ring, or a parsed trace): cycle anatomy + probes +
    the weakest component.  None when the stream carries no forensics
    events at all (forensics was off)."""
    records = list(records)
    anatomy = cycle_anatomy(records)
    probes: Dict[int, dict] = {}
    rate = None
    for r in records:
        if r.get("kind") != "event":
            continue
        if r.get("name") == "forensics_probe":
            a = dict(r.get("attrs", {}))
            probes[int(a.pop("level", -1))] = a
        elif r.get("name") == "solve_forensics":
            rate = r.get("attrs", {}).get("asymptotic_rate", rate)
    if not anatomy["levels"] and not probes and rate is None:
        return None
    return {"levels": anatomy["levels"], "coarse": anatomy["coarse"],
            "probes": probes, "weakest": weakest_component(anatomy),
            "asymptotic_rate": rate}


# -------------------------------------------------------------- probes
def _csr(m):
    """Best-effort scalar CSR of a Matrix handle; None when the level
    is device-only or too large to assemble for a probe."""
    try:
        if m is None or m.n_block_rows > PROBE_MAX_ROWS:
            return None
        return m.scalar_csr()
    except Exception:
        return None


def _nullspace_metric(A) -> Optional[float]:
    """Near-nullspace preservation ``‖A·1‖∞ / ‖A‖∞``: a Poisson-class
    operator annihilates the constant vector away from boundaries, and
    a Galerkin coarse operator must inherit that — a level where this
    jumps toward 1 lost the near-nullspace (bad interpolation)."""
    try:
        rowsum = np.abs(np.asarray(A @ np.ones(A.shape[1]))).ravel()
        absrow = np.asarray(abs(A).sum(axis=1)).ravel()
        den = float(absrow.max()) if absrow.size else 0.0
        if den <= 0:
            return None
        return float(rowsum.max() / den)
    except Exception:
        return None


def _strength_metric(A, rng) -> Optional[float]:
    """Strength-graph sample: the fraction of off-diagonal couplings
    that are strong under the AHAT-style criterion
    ``|a_ij| ≥ θ·max_k|a_ik|`` over up to 256 sampled rows."""
    try:
        n = A.shape[0]
        rows = rng.choice(n, size=min(_STRENGTH_SAMPLE, n),
                          replace=False)
        strong = total = 0
        indptr, indices, data = A.indptr, A.indices, A.data
        for i in rows:
            lo, hi = indptr[i], indptr[i + 1]
            off = np.abs(data[lo:hi][indices[lo:hi] != i])
            if off.size == 0:
                continue
            total += off.size
            strong += int((off >= _STRENGTH_THETA * off.max()).sum())
        if total == 0:
            return None
        return float(strong / total)
    except Exception:
        return None


def _galerkin_metric(A, handles, Ac, rng) -> Optional[float]:
    """Sampled Galerkin consistency: ``(R·A·P)`` on up to 64 coarse
    rows vs the STORED coarse operator (relative Frobenius error).
    Catches value drift between the recorded hierarchy and what the
    transfers actually compose to (e.g. a resetup refresh gone
    stale)."""
    try:
        P = _csr(handles.get("P"))
        R = _csr(handles.get("R"))
        if P is None or R is None or Ac is None:
            return None
        nc = Ac.shape[0]
        rows = rng.choice(nc, size=min(_GALERKIN_SAMPLE, nc),
                          replace=False)
        lhs = (R[rows] @ A) @ P
        rhs = Ac[rows]
        dden = float(np.sqrt((rhs.power(2)).sum()))
        derr = float(np.sqrt(((lhs - rhs).power(2)).sum()))
        return derr / max(dden, 1e-300)
    except Exception:
        return None


def probe_hierarchy(h) -> List[dict]:
    """Run the per-level quality probes over a built ``AMGHierarchy``,
    emit the ``amgx_forensics_*`` gauges + one ``forensics_probe``
    event per level, and return the per-level probe dicts (fine to
    coarsest-but-one; the coarsest grid has no transfers to probe).

    Cheap by construction: inf-norms and one matvec per level, sampled
    strength rows, a ≤64-row Galerkin product — and never a host CSR
    past :data:`PROBE_MAX_ROWS` rows."""
    reg = registry()
    for name in FORENSICS_GAUGES:
        reg.gauge_clear(name)
    sizes = h.level_sizes()
    rng = np.random.default_rng(12345)
    out: List[dict] = []
    for i, lvl in enumerate(h.levels):
        handles = lvl.probe_handles()
        A = _csr(handles.get("A"))
        nxt = h.levels[i + 1].A if i + 1 < len(h.levels) else h.coarsest
        probe = {"level": i, "kind": getattr(lvl, "kind", "?"),
                 "rows": int(sizes[i][0]),
                 "cf_ratio": (sizes[i + 1][0] / sizes[i][0]
                              if sizes[i][0] else None)}
        if A is not None:
            probe["nullspace"] = _nullspace_metric(A)
            probe["strong_frac"] = _strength_metric(A, rng)
            probe["galerkin_err"] = _galerkin_metric(A, handles,
                                                     _csr(nxt), rng)
        cf_map = handles.get("cf_map")
        if cf_map is not None:
            # the realised C/F split of a classical level (coarse
            # fraction of the FINE rows — the PMIS outcome itself)
            probe["cf_coarse_frac"] = float(np.mean(
                np.asarray(cf_map, dtype=np.float64)))
        for key, gname in (("nullspace", "amgx_forensics_nullspace"),
                           ("galerkin_err", "amgx_forensics_galerkin_err"),
                           ("cf_ratio", "amgx_forensics_cf_ratio"),
                           ("strong_frac", "amgx_forensics_strong_frac")):
            v = probe.get(key)
            if isinstance(v, (int, float)) and math.isfinite(v):
                gauge_set(gname, v, level=i)
        recorder.event("forensics_probe",
                       **{k: v for k, v in probe.items()})
        out.append(probe)
    return out


# ------------------------------------------------------------ the tape
class Tape:
    """The cut-point norms of one AMG application, held on the device.

    Each visit of a level (or of the coarsest solve) takes the next slot
    of a (slots, 4) buffer as it finishes — post-order, the order in
    which the JAX package's callbacks fire — and writes its norms there
    with device ops only, so a CUDA graph captures the writes and every
    replay rewrites the buffer.  :meth:`snap` keeps a copy after each
    application (an eager device copy, no host sync); :meth:`emit` reads
    all copies once and emits one ``cycle_level`` / ``cycle_coarse``
    event per visit, application by application.  The tape only reads
    the cycle's vectors: x and the counts do not change with it."""

    def __init__(self):
        self.buf = None
        #: per slot: ("level", level, flavor) or ("coarse", level)
        self.slots: list = []
        self.next = 0
        self.snaps: list = []

    def begin(self):
        """A new application: slots are taken from the first again."""
        self.next = 0

    def _slot(self, desc, ref):
        import torch
        k = self.next
        self.next += 1
        if k == len(self.slots):
            self.slots.append(desc)
            # the buffer grows only while the first application runs
            # (eagerly, before any capture): later ones reuse its slots
            nb = torch.zeros((k + 1, 4), dtype=torch.float64,
                             device=ref.device)
            if self.buf is not None:
                nb[:k] = self.buf
            self.buf = nb
        return k

    def record_level(self, level: int, flavor: str, norms):
        import torch
        k = self._slot(("level", int(level), str(flavor)), norms[0])
        self.buf[k].copy_(torch.stack([n.to(torch.float64)
                                       for n in norms]))

    def record_coarse(self, level: int, entry, exit_):
        import torch
        k = self._slot(("coarse", int(level)), entry)
        z = torch.zeros((), dtype=torch.float64, device=entry.device)
        self.buf[k].copy_(torch.stack([entry.to(torch.float64),
                                       exit_.to(torch.float64), z, z]))

    def snap(self):
        """Keep this application's norms (a device copy)."""
        if self.buf is not None and self.next:
            self.snaps.append(self.buf[:self.next].clone())

    def emit(self):
        """Emit every kept application's events (one host read) and
        forget them."""
        snaps, self.snaps = self.snaps, []
        if not snaps or not recorder.is_enabled():
            return
        import torch
        rows = torch.cat(snaps).cpu().numpy()
        r = 0
        for s in snaps:
            for k in range(s.shape[0]):
                desc, v = self.slots[k], rows[r]
                r += 1
                if desc[0] == "level":
                    emit_cycle_level(desc[1], desc[2], *v)
                else:
                    emit_cycle_coarse(desc[1], v[0], v[1])

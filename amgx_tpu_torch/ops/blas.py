"""BLAS-1 vector operations, norms and the fused reductions (port of
``amgx_tpu/ops/blas.py``;
reference ``base/include/blas.h:40-104``, ``base/src/norm.cu``).
Results of reductions stay device tensors: nothing here synchronises
with the host.

:func:`fused_reduce` stacks several term vectors into one (k, n) → (k,)
sum, the single reduction of a communication-avoiding Krylov step
(``krylov_comm`` CA/PIPELINED); :func:`norm_terms` and
:func:`finish_norm` let the monitor norm ride it, and
:func:`gram_dots_with_norm` folds ‖w‖² into a Gram–Schmidt pass.  The
solvers call their widened forms (``ops/ordered.py``), which sum an f32
operand in f64 and round once.
"""
from __future__ import annotations

import contextlib

import torch

NORM_L1 = "L1"
NORM_L2 = "L2"
NORM_LMAX = "LMAX"
NORM_L1_SCALED = "L1_SCALED"


class CollectiveLedger:
    """Counts the reductions issued while a :func:`count_collectives`
    scope is active, by op label ("dot", "norm", "fused", "gram"); the
    ``replace`` bucket holds those of a residual replacement.  The JAX
    package counts while it traces one iteration body; the port counts
    while it runs one (the solve loop's first iteration, with telemetry
    on): the per-iteration profile of the ``krylov_comm`` event.  The
    reductions of a preconditioner application are not counted
    (:func:`uncounted`)."""

    def __init__(self):
        self.counts: dict = {}
        self.replace: dict = {}

    def reset(self):
        self.counts.clear()
        self.replace.clear()

    def total(self) -> int:
        return int(sum(self.counts.values()))


_LEDGER = None
_BUCKET = "counts"


def record(op: str) -> None:
    """Count one reduction of kind ``op`` (one check when no ledger)."""
    if _LEDGER is not None:
        d = getattr(_LEDGER, _BUCKET)
        d[op] = d.get(op, 0) + 1


@contextlib.contextmanager
def count_collectives(ledger: CollectiveLedger):
    """Route reduction records into ``ledger`` for the duration."""
    global _LEDGER, _BUCKET
    prev, prev_bucket = _LEDGER, _BUCKET
    _LEDGER, _BUCKET = ledger, "counts"
    try:
        yield ledger
    finally:
        _LEDGER, _BUCKET = prev, prev_bucket


@contextlib.contextmanager
def uncounted():
    """Suppress ledger recording (a preconditioner application)."""
    global _LEDGER
    prev = _LEDGER
    _LEDGER = None
    try:
        yield
    finally:
        _LEDGER = prev


def axpy(y, x, alpha):
    """y + alpha·x"""
    return y + alpha * x


def axpby(x, y, alpha, beta):
    """alpha·x + beta·y"""
    return alpha * x + beta * y


def dot(x, y):
    """Conjugated dot product (reference ``dotc``)."""
    if x.is_complex():
        return torch.vdot(x, y)
    return torch.dot(x, y)


def nrm2(x):
    """‖x‖₂ (a c64 vector's squares summed in c128 and rounded once, as
    every complex inner product of the solvers is)."""
    if x.dtype == torch.complex64:
        w = x.to(torch.complex128)
        return torch.sqrt(dot(w, w).real).float()
    return torch.sqrt(dot(x, x).real)


def nrm1(x):
    return torch.sum(torch.abs(x))


def nrmmax(x):
    return torch.max(torch.abs(x))


def norm(v, norm_type: str = NORM_L2, block_dim: int = 1,
         use_scalar_norm: bool = True):
    """Convergence norm of a vector: a 0-d tensor with ``use_scalar_norm``
    (or block_dim 1), else the per-block-component norms, shape
    (block_dim,), as the reference's block norms (``norm.cu``;
    ``use_scalar_norm``, core.cu:542)."""
    record("norm")
    if use_scalar_norm or block_dim == 1:
        if norm_type in (NORM_L1, NORM_L1_SCALED):
            r = nrm1(v)
            return r / v.shape[0] if norm_type == NORM_L1_SCALED else r
        if norm_type == NORM_LMAX:
            return nrmmax(v)
        return nrm2(v)
    vb = v.reshape(-1, block_dim)
    if norm_type in (NORM_L1, NORM_L1_SCALED):
        r = torch.sum(torch.abs(vb), dim=0)
        return r / vb.shape[0] if norm_type == NORM_L1_SCALED else r
    if norm_type == NORM_LMAX:
        return torch.amax(torch.abs(vb), dim=0)
    return torch.sqrt(torch.sum(torch.abs(vb) ** 2, dim=0))


def gram_dots(V, w):
    """Gram–Schmidt projections ``conj(V) @ w`` onto the rows of V:
    one matrix-vector product."""
    return torch.mv(V.conj() if V.is_complex() else V, w)


def fused_reduce(terms):
    """The sums of several same-length term vectors (e.g. ``conj(r)*u``)
    in one stacked (k, n) → (k,) reduction."""
    record("fused")
    return torch.sum(torch.stack(list(terms)), dim=-1)


def norm_terms(v, norm_type: str = NORM_L2, block_dim: int = 1,
               use_scalar_norm: bool = True):
    """Elementwise accumulator vectors of :func:`norm` for
    :func:`fused_reduce`: one term for a scalar norm, ``block_dim``
    masked terms (component c's magnitudes, zero elsewhere) for a block
    norm; None for LMAX, a max that cannot ride a sum."""
    if norm_type == NORM_LMAX:
        return None
    base = torch.abs(v) ** 2 if norm_type == NORM_L2 else torch.abs(v)
    if use_scalar_norm or block_dim == 1:
        return [base]
    comp = torch.arange(v.shape[0], device=v.device) % block_dim
    zero = torch.zeros((), dtype=base.dtype, device=base.device)
    return [torch.where(comp == c, base, zero) for c in range(block_dim)]


def finish_norm(acc, norm_type: str, n_rows: int, block_dim: int = 1,
                use_scalar_norm: bool = True):
    """The value :func:`norm` returns, from the reduced
    :func:`norm_terms` accumulators ``acc`` ((1,) or (block_dim,));
    ``n_rows`` is the vector length."""
    acc = acc.real
    scalar = use_scalar_norm or block_dim == 1
    r = acc[0] if scalar else acc
    if norm_type == NORM_L2:
        return torch.sqrt(r)
    if norm_type == NORM_L1_SCALED:
        return r / (n_rows if scalar else n_rows // block_dim)
    return r


def gram_dots_with_norm(V, w):
    """``(conj(V) @ w, ‖w‖²)`` from one stacked matrix-vector product:
    ``conj(w)`` rides as an extra row of V (the fused Arnoldi pass)."""
    Vc = V.conj() if V.is_complex() else V
    wc = w.conj() if w.is_complex() else w
    out = torch.mv(torch.cat([Vc, wc[None, :]]), w)
    return out[:-1], out[-1].real

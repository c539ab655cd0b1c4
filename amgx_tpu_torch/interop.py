"""Build the port's objects from numpy arrays, so that state computed
elsewhere (another package, a file) can be carried into a solve.

Only numpy crosses this boundary: the arrays are copied onto ``device``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from .amg.hierarchy import AMGHierarchy
from .amg.level import (AggregationLevel, ClassicalLevel, PairwiseLevel,
                        StructuredLevel)
from .config import AMGConfig
from .core.matrix import (ComposedDIA, DeviceMatrix, Matrix,
                          assemble_device_matrix, dia_device_matrix,
                          ell_device_matrix)
from .device import resolve_device
from .solvers.dilu import MulticolorDILUSolver
from .solvers.gs import ColorSlab


def matrix_from_numpy(offsets: Sequence[int], vals: np.ndarray,
                      grid_dims=None, host_dtype=np.float64,
                      device_dtype=None, device="cuda") -> Matrix:
    """A :class:`Matrix` from host row-aligned DIA arrays
    (``A[i, i+offsets[k]] = vals[k, i]``) held in ``host_dtype``, whose
    device pack will be built in ``device_dtype`` (default: the host
    dtype) on ``device``."""
    m = Matrix.from_dia(offsets, np.asarray(vals, dtype=host_dtype),
                        device=device)
    if grid_dims is not None:
        m.grid_dims = tuple(int(d) for d in grid_dims)
    m.device_dtype = device_dtype
    return m


def _dev_matrix(offsets, vals, diag=None, dinv=None, dtype=None,
                device: Optional[torch.device] = None) -> Matrix:
    def t(a):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)
    return Matrix.from_dia_device(
        offsets, t(vals), None if diag is None else t(diag),
        None if dinv is None else t(dinv))


def structure_from_numpy(structure) -> list:
    """The port's structure records (``AMGHierarchy._structure``) from
    another package's: ``("structured", (dims,))``, ``("pairwise",
    (n,))``, ``("aggregation", (aggregates, nc))`` or ``("classical",
    (P,))``, the arrays read through numpy and P as a scipy CSR."""
    out = []
    for kind, data in structure:
        if kind == "structured":
            data = (tuple(int(d) for d in data[0]),)
        elif kind == "pairwise":
            data = (int(data[0]),)
        elif kind == "aggregation":
            data = (np.asarray(data[0], dtype=np.int64), int(data[1]))
        elif kind == "classical":
            data = (sp.csr_matrix(data[0]),)
        else:
            raise ValueError(f"unknown structure record {kind!r}")
        out.append((kind, data))
    return out


def _with_structure(h: AMGHierarchy, structure) -> AMGHierarchy:
    """``h`` carrying ``structure`` (None: none), so that a resetup of the
    carried hierarchy keeps it (``structure_reuse_levels`` ≠ 0)."""
    if structure is not None:
        h._structure = structure_from_numpy(structure)
    return h


def hierarchy_from_numpy(cfg: AMGConfig, scope: str, levels, coarsest,
                         dtype=None, device="cuda",
                         structure=None) -> AMGHierarchy:
    """An :class:`AMGHierarchy` (smoothers and coarse solver set up per
    ``cfg``/``scope``) from numpy arrays instead of a setup pass.

    ``levels`` lists, fine to coarse, dicts with ``kind``
    (``"structured"`` with ``dims``/``cdims``, or ``"pairwise"`` with
    ``n``), ``offsets``, ``vals``, ``diag`` and ``dinv``; ``coarsest`` is a
    dict with ``offsets`` and ``vals``.  Arrays are cast to ``dtype`` when
    it is given.  ``structure`` — the other package's recorded structure
    (:func:`structure_from_numpy`) — lets a resetup of the hierarchy
    keep it."""
    dev = resolve_device(device)
    h = AMGHierarchy(cfg, scope)
    for idx, lv in enumerate(levels):
        A = _dev_matrix(lv["offsets"], lv["vals"], lv["diag"], lv["dinv"],
                        dtype, dev)
        if lv["kind"] == "structured":
            level = StructuredLevel(A, idx, lv["dims"], lv["cdims"])
            A.grid_dims = tuple(lv["dims"])
        else:
            level = PairwiseLevel(A, idx, lv["n"])
        h.levels.append(level)
    h._setup_smoothers_and_coarse(_dev_matrix(
        coarsest["offsets"], coarsest["vals"], dtype=dtype, device=dev))
    return _with_structure(h, structure)


def device_pack_from_numpy(spec: dict, dtype=None,
                           device="cuda") -> "DeviceMatrix | ComposedDIA":
    """A device pack from numpy arrays, by ``spec["fmt"]``:

    * ``"dia"``: ``offsets``, ``vals`` (nd, n), optional ``n_cols``;
    * ``"ell"``: ``cols`` (n, K), ``vals`` (n, K), ``n_cols``, optional
      ``diag`` (zeros when absent, as for P/R);
    * ``"dia3"``: ``P``, ``A``, ``R`` (``dia`` specs), ``diag`` and
      ``l1row`` — the composition R·(A·(P·x)).

    Values are cast to ``dtype`` when it is given."""
    dev = resolve_device(device)

    def t(a, dt=dtype):
        return torch.from_numpy(np.array(a, dtype=dt)).to(dev)

    fmt = spec["fmt"]
    if fmt == "dia":
        vals = t(spec["vals"])
        return dia_device_matrix(spec["offsets"], vals, None,
                                 spec.get("n_cols", vals.shape[1]))
    if fmt == "ell":
        vals = t(spec["vals"])
        diag = t(spec["diag"]) if spec.get("diag") is not None else \
            torch.zeros(vals.shape[0], dtype=vals.dtype, device=dev)
        return ell_device_matrix(t(spec["cols"], np.int32), vals, diag,
                                 int(spec["n_cols"]))
    if fmt == "dia3":
        P, A, R = (device_pack_from_numpy(spec[k], dtype, dev)
                   for k in ("P", "A", "R"))
        diag = t(spec["diag"])
        return ComposedDIA(P=P, A=A, R=R, diag=diag, l1row=t(spec["l1row"]),
                           n_rows=int(diag.shape[0]),
                           n_cols=int(diag.shape[0]))
    raise ValueError(f"unknown pack format {fmt!r}")


def classical_hierarchy_from_numpy(cfg: AMGConfig, scope: str, levels,
                                   coarsest: dict, dtype=None,
                                   device="cuda",
                                   structure=None) -> AMGHierarchy:
    """A classical :class:`AMGHierarchy` (smoothers and coarse solver set
    up per ``cfg``/``scope``) from numpy arrays instead of a setup pass.

    ``levels`` lists, fine to coarse, dicts with the pack specs ``A``,
    ``P`` and ``R`` (see :func:`device_pack_from_numpy`) and optionally
    ``logical_rows``; ``coarsest`` is the pack spec of the coarsest
    operator.  ``structure``: as for :func:`hierarchy_from_numpy` (a
    resetup replays the Galerkin products of its frozen P on the
    host)."""
    dev = resolve_device(device)
    h = AMGHierarchy(cfg, scope)
    for idx, lv in enumerate(levels):
        A = Matrix.from_device_pack(
            device_pack_from_numpy(lv["A"], dtype, dev),
            logical_rows=lv.get("logical_rows"))
        h.levels.append(ClassicalLevel(
            A, idx, device_pack_from_numpy(lv["P"], dtype, dev),
            device_pack_from_numpy(lv["R"], dtype, dev)))
    h._setup_smoothers_and_coarse(Matrix.from_device_pack(
        device_pack_from_numpy(coarsest, dtype, dev)))
    return _with_structure(h, structure)


#: array fields of a pack (``pack_host_arrays`` names)
_PACK_ARRAYS = ("vals", "diag", "cols", "row_ids", "bn_codes", "bn_vals",
                "bn_meta", "bn_pos", "sh_vals", "sh_meta")


def dilu_from_numpy(cfg: AMGConfig, scope: str, Ad: DeviceMatrix,
                    Einv: np.ndarray, L_slabs, U_slabs,
                    dtype=None) -> MulticolorDILUSolver:
    """A set-up :class:`~amgx_tpu_torch.solvers.dilu.MulticolorDILUSolver`
    from numpy state instead of a setup pass: ``Einv`` ((n,) or
    (n, b, b)) and, per color, ``(rows, cols, vals)`` of the lower and
    upper slabs; ``Ad`` is the operator its sweeps' residuals use.  Values
    are cast to ``dtype`` (default: the pack's)."""
    dev = Ad.device
    tdt = Ad.dtype if dtype is None else dtype

    def t(a, floating=True):
        out = torch.from_numpy(np.array(a)).to(dev)
        return out.to(tdt) if floating else out

    slv = MulticolorDILUSolver(cfg, scope)
    slv.A, slv.Ad = None, Ad
    slv.set_state(t(Einv),
                  [ColorSlab(t(r, False), t(c, False), t(v))
                   for r, c, v in L_slabs],
                  [ColorSlab(t(r, False), t(c, False), t(v))
                   for r, c, v in U_slabs])
    return slv


def device_matrix_from_fields(other, dtype=None,
                              device="cuda") -> DeviceMatrix:
    """The port's pack of another package's device matrix: any object
    with the JAX package's ``DeviceMatrix`` fields (``fmt``, ``n_rows``,
    ``n_cols``, ``block_dim``, ``ell_width``, ``dia_offsets``,
    ``bn_dims``, ``sh_dims`` and the arrays ``vals``, ``diag``, ``cols``,
    ``row_ids``, ``bn_codes``, ``bn_vals``, ``bn_meta``, ``bn_pos``,
    ``sh_vals``, ``sh_meta``), each array read through ``np.asarray`` —
    scalar or block DIA, ELL or CSR, with or without binned or shift
    planes (a lean shift pack, without ``cols``/``vals``, included).
    Value arrays are cast to ``dtype`` when it is given; a scalar pack
    carrying the JAX package's window attachments keeps only its
    ``cols`` and ``vals``."""
    arrays = {}
    for k in _PACK_ARRAYS:
        a = getattr(other, k, None)
        if a is None:
            continue
        a = np.array(a)
        if dtype is not None and np.issubdtype(a.dtype, np.floating):
            a = a.astype(dtype)
        arrays[k] = a
    meta = dict(fmt=other.fmt, n_rows=int(other.n_rows),
                n_cols=int(other.n_cols), block_dim=int(other.block_dim),
                ell_width=int(other.ell_width),
                offsets=tuple(other.dia_offsets))
    for dims in ("bn_dims", "sh_dims"):
        if getattr(other, dims, ()):
            meta[dims] = tuple(int(v) for v in getattr(other, dims))
    return assemble_device_matrix(arrays, meta, device)


def aggregation_hierarchy_from_packs(cfg: AMGConfig, scope: str, levels,
                                     coarsest, dtype=None, device="cuda",
                                     structure=None) -> AMGHierarchy:
    """A scalar aggregation :class:`AMGHierarchy` (smoothers and coarse
    solver set up per ``cfg``/``scope``) from another package's setup
    instead of a setup pass.

    ``levels`` lists, fine to coarse, dicts with ``A`` (an object with
    the JAX package's ``DeviceMatrix`` fields, read by
    :func:`device_matrix_from_fields`: DIA, ELL, shift or CSR packs),
    ``aggregates`` (the fine rows' aggregate ids) and ``n_coarse``;
    ``coarsest`` is the coarsest operator's fields object.  Values are
    cast to ``dtype`` when it is given.  ``structure``: as for
    :func:`hierarchy_from_numpy`."""
    dev = resolve_device(device)
    h = AMGHierarchy(cfg, scope)
    for idx, lv in enumerate(levels):
        A = Matrix.from_device_pack(device_matrix_from_fields(
            lv["A"], dtype, dev))
        h.levels.append(AggregationLevel(
            A, idx, np.asarray(lv["aggregates"]), int(lv["n_coarse"])))
    h._setup_smoothers_and_coarse(Matrix.from_device_pack(
        device_matrix_from_fields(coarsest, dtype, dev)))
    return _with_structure(h, structure)

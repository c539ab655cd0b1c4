"""Build the port's objects from numpy arrays, so that state computed
elsewhere (another package, a file) can be carried into a solve.

Only numpy crosses this boundary: the arrays are copied onto ``device``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .amg.hierarchy import AMGHierarchy
from .amg.level import PairwiseLevel, StructuredLevel
from .config import AMGConfig
from .core.matrix import Matrix
from .device import resolve_device


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


def hierarchy_from_numpy(cfg: AMGConfig, scope: str, levels, coarsest,
                         dtype=None, device="cuda") -> AMGHierarchy:
    """An :class:`AMGHierarchy` (smoothers and coarse solver set up per
    ``cfg``/``scope``) from numpy arrays instead of a setup pass.

    ``levels`` lists, fine to coarse, dicts with ``kind``
    (``"structured"`` with ``dims``/``cdims``, or ``"pairwise"`` with
    ``n``), ``offsets``, ``vals``, ``diag`` and ``dinv``; ``coarsest`` is a
    dict with ``offsets`` and ``vals``.  Arrays are cast to ``dtype`` when
    it is given."""
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
    return h

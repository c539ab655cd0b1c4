"""On-device 7-point Poisson generation (port of
``amgx_tpu/io/device_gen.py``; reference
``AMGX_generate_distributed_poisson_7pt``, ``amgx_c.h:515-526``).

The DIA planes are built on the device from boundary masks and
constants, so the operator never crosses the host↔device link.  The
returned :class:`Matrix` also carries the analytic host diagonals
(lazily) for consumers that need host values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.matrix import Matrix, dia_device_matrix
from ..device import resolve_device, torch_dtype
from .poisson import poisson7pt_dia, poisson7pt_offsets


def _gen7pt(nx: int, ny: int, nz: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """The kept 7-pt diagonal rows, in ``poisson7pt_offsets`` order."""
    n = nx * ny * nz
    i = torch.arange(n, dtype=torch.int64, device=device)
    x = i % nx
    r = i // nx
    y = r % ny
    z = r // ny
    neg = torch.tensor(-1.0, dtype=dtype, device=device)
    zero = torch.tensor(0.0, dtype=dtype, device=device)
    rows = [
        torch.where(z > 0, neg, zero),
        torch.where(y > 0, neg, zero),
        torch.where(x > 0, neg, zero),
        torch.full((n,), 6.0, dtype=dtype, device=device),
        torch.where(x < nx - 1, neg, zero),
        torch.where(y < ny - 1, neg, zero),
        torch.where(z < nz - 1, neg, zero),
    ]
    spec = poisson7pt_offsets(nx, ny, nz)
    return torch.stack([row for row, (_, kept) in zip(rows, spec) if kept])


def poisson7pt_device(nx: int, ny: int, nz: int, device_dtype=np.float32,
                      device="cuda") -> Matrix:
    """7-point Poisson generated on ``device``: equivalent to
    ``Matrix(poisson7pt(nx, ny, nz))`` with ``device_dtype`` set, except
    the device values never cross the link."""
    dev = resolve_device(device)
    n = nx * ny * nz
    offsets = [o for o, kept in poisson7pt_offsets(nx, ny, nz) if kept]
    m = Matrix(device=dev)
    m.dtype = np.dtype(np.float64)   # host analytic arrays are f64
    m._n_dia = (n, n)
    m._dia_thunk = lambda: poisson7pt_dia(nx, ny, nz)
    m._dia_offsets_hint = offsets
    m._stencil_consistent = True     # boundary-masked, no wrap couplings
    m._vals_f32_exact = True         # values are -1 and 6: exact in f32
    m.grid_dims = (nz, ny, nx)
    dt = np.dtype(device_dtype)
    m.device_dtype = dt
    dvals = _gen7pt(nx, ny, nz, torch_dtype(dt), dev)
    m._device = dia_device_matrix(offsets, dvals, None, n)
    m._device_dtype = dt
    return m

"""Device ELL packs for device-born coarse operators (port of
``device_ell_matrix`` of ``amgx_tpu/ops/device_pack.py``).

The classical pipeline builds its coarse levels on the device; this
wraps their ELL arrays as a :class:`~amgx_tpu_torch.core.DeviceMatrix`
without a download.  Only the sanitize step and the diagonal are kept:
the windowed layout of the JAX package (block ids, window codes and its
scalar fetch) exists because a TPU has no gather, and the Hopper ELL
kernel (``csrc/ell_spmv.cu``) reads ``cols``/``vals`` directly.
"""
from __future__ import annotations

import torch

from ..core.matrix import DeviceMatrix, ell_device_matrix
from .ordered import sum_along


def device_ell_matrix(cols: torch.Tensor, vals: torch.Tensor, n_rows: int,
                      n_cols: int, square_diag: bool = True) -> DeviceMatrix:
    """DeviceMatrix (fmt ``ell``) around device-resident ELL arrays.

    Dead (−1), out-of-range or zero-valued entries become column 0 with
    value 0; the main diagonal is summed, slot by slot in order, from the
    entries whose column is their own row (zeros when ``square_diag`` is
    False, as for P/R)."""
    n, K = cols.shape
    assert n == n_rows, (n, n_rows)
    ok = (cols >= 0) & (cols < n_cols) & (vals != 0)
    cols = torch.where(ok, cols, 0).to(torch.int32).contiguous()
    vals = torch.where(ok, vals, 0).contiguous()
    if square_diag:
        rown = torch.arange(n, dtype=torch.int32, device=cols.device)[:, None]
        diag = sum_along(torch.where(cols == rown, vals, 0), 1)
    else:
        diag = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return ell_device_matrix(cols, vals, diag, n_cols)

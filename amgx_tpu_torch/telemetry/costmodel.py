"""Static per-op cost descriptors: bytes moved and operations per apply
(port of ``amgx_tpu/telemetry/costmodel.py`` to the port's packs).

Every SpMV pack the port's dispatcher serves
(:func:`amgx_tpu_torch.core.matrix.pack_kind`) gets a hardware-terms
descriptor in the kernel's own layout:

* ``dia`` — kernel B1: nd value planes (b² per block diagonal), x read
  once, y written once, no index bytes;
* ``dia3`` — three B1 streams R·(A·(P·x)), each factor's planes and
  its own x and y;
* ``ell/shift`` — kernel B2 over the slice-masked compact pack (the
  used slots' values, one mask and one pointer word per 32-row slice,
  the class-difference table), x and y;
* ``ell/window`` — kernel B3, which stops each row at ``row_len``: the
  entries the rows hold (a column id and a value each), x and y;
* ``ell/binned`` / ``ell/binned-block`` / ``csr/binned*`` — kernels B4
  and B5 over their compact pack (a code and a b×b value block per
  slot), x and y;
* ``sharded-ell`` — the stacked interior (B3 with ``row_len``, or B5's
  stacked compact pack for b×b), the boundary rows' halo entries, and
  the halo exchange's bytes (padded send buffers, every distance);
* ``dense`` — B3 over dense rows; ``csr/segsum`` the plain decline.

``bytes_per_apply`` counts each input read once and each output written
once; ``flops_per_apply`` is ``2·nnz·b²``-style useful work (pad slots
multiply zeros: bandwidth waste, not compute); ``padding_waste`` is
stored slots ÷ nnz.

The yardstick: :data:`PUBLISHED_PEAK_BYTES_PER_S` is the H100 SXM data
sheet's memory rate (at its 700 W power limit), the rate kernel bounds
are stated against; :func:`measured_peak_gbs` is this card's
device-to-device copy rate, measured once per process, which the
device-time anatomy (:mod:`.deviceprof`) reports bandwidth fractions
against.  On the CPU every rate is an explicit argument.

Host-side shape arithmetic (one host read of ``row_len`` sums per
operator, at first use), safe at setup time under telemetry.
"""
from __future__ import annotations

from typing import Optional, Tuple

#: NVIDIA's data sheet for the H100 SXM part: 80 GB of HBM3 at 3.35 TB/s
#: (at the full 700 W power limit)
PUBLISHED_PEAK_BYTES_PER_S = 3.35e12

_INDEX_BYTES = 4          # int32 column ids, codes, mask and ptr words

#: per device: the measured copy rate in GB/s (:func:`measured_peak_gbs`)
_MEASURED = {}


def _itemsize(dt) -> int:
    import torch
    return torch.empty((), dtype=dt).element_size()


# ------------------------------------------------- bytes of one layout
def dia_bytes(nd: int, n: int, n_cols: int, vitem: int, xitem: int,
              b: int = 1) -> int:
    """B1: nd (n, b, b) value planes, x read once, y written once."""
    return nd * n * b * b * vitem + (n + n_cols) * b * xitem


def ell_bytes(entries: int, n: int, n_cols: int, vitem: int,
              xitem: int) -> int:
    """B3 over ``entries`` stored entries: a column id and a value each,
    x read once, y written once."""
    return entries * (_INDEX_BYTES + vitem) + (n_cols + n) * xitem


def binned_bytes(entries: int, b: int, n: int, n_cols: int, vitem: int,
                 xitem: int) -> int:
    """B4/B5 over ``entries`` lanes (or blocks): a code and b² values
    each, x read once, y written once (block rows n, block columns
    n_cols)."""
    return entries * (_INDEX_BYTES + b * b * vitem) \
        + (n_cols + n) * b * xitem


def shift_compact_bytes(slots: int, S: int, n_slices: int, n_tiles: int,
                        Dpad: int, n: int, item: int) -> int:
    """B2's compact pack: the used slots' values, a mask and a pointer
    word per slice, the (n_tiles, Dpad) difference table, x and y."""
    return slots * S * item + _INDEX_BYTES * (2 * n_slices + 1) \
        + _INDEX_BYTES * n_tiles * Dpad + 2 * n * item


def bound(nbytes: float, ops: float, peak_bytes_per_s: float,
          peak_ops_per_s: float) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time of the work,
    the larger of its bytes over the memory rate and its operations
    over the operation rate."""
    t_bytes = nbytes / peak_bytes_per_s
    t_ops = ops / peak_ops_per_s
    return max(t_bytes, t_ops), \
        ("bytes" if t_bytes >= t_ops else "operations")


# -------------------------------------------------- per-pack descriptor
def _row_len_entries(Ad) -> Optional[int]:
    rl = getattr(Ad, "row_len", None)
    if rl is None:
        return None
    return int(rl.long().sum().item())


def padded_entries(Ad) -> Optional[int]:
    """Stored SLOTS of the layout the kernel reads (padding included);
    None for an implicit operator."""
    fmt = getattr(Ad, "fmt", "?")
    b = int(getattr(Ad, "block_dim", 1) or 1)
    if fmt == "dia":
        return len(Ad.dia_offsets) * Ad.n_rows * b * b
    if fmt == "dia3":
        return sum(len(F.dia_offsets) * F.n_rows
                   for F in (Ad.P, Ad.A, Ad.R))
    if fmt == "dense":
        return Ad.n_rows * Ad.n_cols
    if fmt == "sharded-ell":
        return Ad.n_parts * Ad.n_loc * Ad.ell_width * b * b
    if fmt in ("ell", "csr"):
        if getattr(Ad, "sh_compact", None) is not None:
            S, _n_slices, slots, _w = Ad.sh_compact.dims
            return int(slots) * int(S)
        if getattr(Ad, "bn_compact", None) is not None:
            S, _n_slices, slots, _w, bb = Ad.bn_compact.dims
            return int(slots) * int(S) * int(bb) ** 2
        if fmt == "ell":
            return Ad.n_rows * Ad.ell_width * b * b
        return int(Ad.vals.numel()) if Ad.vals is not None else None
    return None


def spmv_cost(Ad, nnz: Optional[int] = None) -> dict:
    """Cost descriptor of one ``y = A·x`` on the port's device pack
    ``Ad``.  ``nnz``: the true stored-nonzero count when the caller knows
    it; else the stored entries the kernel reads stand in for it
    (``estimated=True``)."""
    from ..core.matrix import pack_kind
    fmt = getattr(Ad, "fmt", "?")
    pack = pack_kind(Ad) if fmt != "sharded-ell" else "sharded"
    item = _itemsize(Ad.dtype)
    slots = padded_entries(Ad)
    bdim = int(getattr(Ad, "block_dim", 1) or 1)
    estimated = nnz is None
    if nnz is None:
        nnz = slots
    out = {"pack": pack, "fmt": fmt, "dtype": str(Ad.dtype).replace(
        "torch.", ""), "itemsize": item, "estimated": estimated,
        "block_dim": bdim,
        "nnz": None if nnz is None else int(nnz),
        "padded_entries": None if slots is None else int(slots)}
    if fmt == "op" or slots is None:
        out.update(bytes_per_apply=None, flops_per_apply=None,
                   padding_waste=None)
        return out
    out["flops_per_apply"] = 2 * int(nnz)
    out["padding_waste"] = round(slots / max(int(nnz), 1), 4)
    if fmt == "dia":
        byt = dia_bytes(len(Ad.dia_offsets), Ad.n_rows, Ad.n_cols, item,
                        item, bdim)
    elif fmt == "dia3":
        byt = sum(dia_bytes(len(F.dia_offsets), F.n_rows, F.n_cols, item,
                            item) for F in (Ad.P, Ad.A, Ad.R))
    elif fmt == "dense":
        byt = Ad.n_rows * Ad.n_cols * item + (Ad.n_rows + Ad.n_cols) * item
    elif fmt == "sharded-ell":
        return _sharded_cost(Ad, out, item)
    elif getattr(Ad, "sh_compact", None) is not None:
        S, n_slices, slots_c, _w = Ad.sh_compact.dims
        T, n_tiles, Dpad = (int(v) for v in Ad.sh_dims[:3])
        byt = shift_compact_bytes(int(slots_c), int(S), int(n_slices),
                                  n_tiles, Dpad, Ad.n_rows, item)
    elif getattr(Ad, "bn_compact", None) is not None:
        S, _n_slices, slots_c, _w, bb = Ad.bn_compact.dims
        byt = binned_bytes(int(slots_c) * int(S), int(bb),
                           Ad.n // int(bb), Ad.n_cols * bdim // int(bb),
                           item, item)
    elif fmt == "ell" and bdim == 1:
        entries = _row_len_entries(Ad)
        if entries is None:
            entries = Ad.n_rows * Ad.ell_width
        byt = ell_bytes(entries, Ad.n_rows, Ad.n_cols, item, item)
    elif fmt == "ell":
        byt = slots * item + Ad.n_rows * Ad.ell_width * _INDEX_BYTES \
            + (Ad.n + Ad.n_cols * bdim) * item
    else:
        # CSR segment sum (the decline): values, int32 columns and row
        # ids, x and y
        byt = slots * item \
            + (slots // max(bdim ** 2, 1)) * 2 * _INDEX_BYTES \
            + (Ad.n + Ad.n_cols * bdim) * item
    out["bytes_per_apply"] = int(byt)
    return out


def _sharded_cost(A, out: dict, item: int) -> dict:
    """Sharded descriptor: the stacked interior (B3 to ``row_len``, or
    B5's stacked compact pack), the boundary rows' halo entries, x and y
    once, plus the exchange's bytes."""
    b = int(A.block_dim)
    if b == 1:
        entries = _row_len_entries(A)
        if entries is None:
            entries = A.n_rows * A.ell_width
        byt = ell_bytes(entries, A.n_rows, A.n_cols, item, item)
    elif A.interior is None:
        # a complex pack: its interior applies over the block ELL slots
        byt = binned_bytes(A.n_rows * A.ell_width, b, A.n_rows, A.n_cols,
                           item, item)
    else:
        S, _n_slices, slots_c, _w, _bb = A.interior.compact.dims
        byt = binned_bytes(int(slots_c) * int(S), b, A.n_rows, A.n_cols,
                           item, item)
    nb = int(A.bnd_vals.shape[0] * A.bnd_vals.shape[1])
    byt += nb * (_INDEX_BYTES + b * b * item)
    out["bytes_per_apply"] = int(byt)
    out["halo_bytes_per_apply"] = int(halo_wire_bytes(A, ring=1))
    out["halo_entries_per_apply"] = int(halo_entries(A, ring=1))
    out["n_parts"] = int(A.n_parts)
    return out


# ----------------------------------------------------------- halo costs
def _ring_arrays(A, ring: int):
    if ring == 1:
        return A.send_idx, A.halo_src, A.dists
    return A.send_idx2, A.halo_src2, A.dists2


def halo_wire_bytes(A, ring: int = 1) -> int:
    """Bytes one ring-``ring`` exchange moves, mesh-wide: every shard's
    full padded (B,) send buffer once per rank distance (or P − 1 times
    on the gather of every buffer).  On one card they are device-memory
    copies, not interconnect traffic."""
    send_idx, _, dists = _ring_arrays(A, ring)
    P = A.n_parts
    if P == 1 or send_idx is None:
        return 0
    from ..distributed.matrix import uses_all_gather
    B = send_idx.shape[1]
    item = _itemsize(A.dtype) * max(A.block_dim, 1)
    hops = (P - 1) if uses_all_gather(dists, P) else len(dists)
    return P * hops * B * item


def halo_entries(A, ring: int = 1) -> int:
    """Useful (unpadded) halo values gathered per exchange, mesh-wide."""
    counts = A.halo_counts if ring == 1 else A.halo_counts2
    if counts:
        return int(sum(counts))
    _, halo_src, _ = _ring_arrays(A, ring)
    return 0 if halo_src is None else A.n_parts * halo_src.shape[1]


# ------------------------------------------------- distributed overlap
def dist_overlap(Ad, nnz: Optional[int] = None,
                 level: Optional[int] = None,
                 peak_bytes_per_s: float = PUBLISHED_PEAK_BYTES_PER_S
                 ) -> Optional[dict]:
    """Static interior-vs-halo audit of one sharded level (the
    ``dist_overlap`` event): interior seconds (its bytes over the memory
    rate) against halo seconds (the exchange's bytes over the same rate:
    on one card both are memory traffic).  ``overlap_fraction`` is the
    share of the exchange an interior apply could hide; None for a pack
    that is not sharded."""
    if getattr(Ad, "fmt", "") != "sharded-ell":
        return None
    from ..distributed.agglomerate import active_parts
    import numpy as np
    c = spmv_cost(Ad, nnz=nnz)
    P = int(Ad.n_parts)
    offs = np.asarray(Ad.offsets) if Ad.offsets is not None else None
    active = max(active_parts(offs) if offs is not None else P, 1)
    rows = int(offs[-1]) if offs is not None else P * Ad.n_loc
    local_bytes = int(c.get("bytes_per_apply") or 0)
    wire = int(c.get("halo_bytes_per_apply") or 0)
    est_interior_s = local_bytes / P / peak_bytes_per_s
    est_halo_s = wire / P / peak_bytes_per_s
    overlap = 1.0 if est_halo_s <= 0 else \
        min(est_interior_s / est_halo_s, 1.0)
    out = {
        "n_parts": P, "active_parts": active,
        "rows": rows, "rows_per_part": rows // active,
        "interior_bytes": local_bytes, "halo_wire_bytes": wire,
        "halo_local_ratio": (round(wire / local_bytes, 4)
                             if local_bytes else None),
        "est_interior_s": round(est_interior_s, 9),
        "est_halo_s": round(est_halo_s, 9),
        "overlap_fraction": round(overlap, 4),
        "halo_bound": bool(est_halo_s > est_interior_s),
        "measured": False,
    }
    if level is not None:
        out["level"] = int(level)
    return out


# ------------------------------------------------------------- rollups
def hierarchy_cost(levels_costs) -> dict:
    """Per-level descriptors (fine → coarse) rolled into hierarchy
    totals: one V-cycle visits every level's operator."""
    byt = [c.get("bytes_per_apply") for c in levels_costs]
    flp = [c.get("flops_per_apply") for c in levels_costs]
    nnz = [c.get("nnz") for c in levels_costs]
    slots = [c.get("padded_entries") for c in levels_costs]
    tot_nnz = sum(z for z in nnz if z)
    tot_slots = sum(s for s in slots if s)
    return {
        "levels": list(levels_costs),
        "total_bytes_per_cycle": sum(b for b in byt if b),
        "total_flops_per_cycle": sum(f for f in flp if f),
        "padding_waste": round(tot_slots / max(tot_nnz, 1), 4),
        "halo_bytes_per_cycle": sum(
            c.get("halo_bytes_per_apply", 0) or 0 for c in levels_costs),
    }


# ---------------------------------------------------- achieved vs peak
def achieved_gbs(bytes_moved: float, duration_s: float) -> float:
    """Achieved bandwidth of ``bytes_moved`` in ``duration_s``."""
    if not duration_s or duration_s <= 0:
        return 0.0
    return bytes_moved / duration_s / 1e9


def roofline_fraction(gbs: float, peak_gbs: float) -> float:
    """Fraction of a bandwidth roofline actually achieved."""
    return gbs / peak_gbs if peak_gbs > 0 else 0.0


def measured_peak_gbs(device=None) -> float:
    """This card's device-to-device copy rate in GB/s (read + write bytes
    of a 1 GiB copy over its median CUDA-event time of 10), measured once
    per process and device.  Raises on a CPU device: there the peak is
    an explicit argument."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError("measured_peak_gbs needs a CUDA device; pass the "
                         "peak explicitly on the CPU")
    key = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if key in _MEASURED:
        return _MEASURED[key]
    src = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    for _ in range(2):
        dst.copy_(src)
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(10):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        dst.copy_(src)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    del src, dst
    times.sort()
    gbs = 2 * (1 << 30) / (times[len(times) // 2] * 1e-3) / 1e9
    _MEASURED[key] = gbs
    return gbs

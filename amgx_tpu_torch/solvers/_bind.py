"""Keep the AMG's CUDA graphs across a values-only resetup (the torch
counterpart of ``DeviceBindings._discover`` in
``amgx_tpu/solvers/_bind.py``).

The JAX package keeps its compiled executables across a resetup because
the jit cache hits when every argument keeps its shape and dtype.  A
CUDA graph has no arguments: it reads fixed addresses.  So the walk
here pairs every tensor slot of the solver tree as the graphs read it
(:func:`collect`, taken right after each capture) with the same slot of
the tree the resetup built, and when every pair agrees in shape, dtype
and device it copies each new tensor into the old storage and points the
new tree at that storage (:func:`rebind`): the graphs then replay on the
new values.  Otherwise the graphs go, as a setup drops them — the
counterpart of a pytree change forcing a retrace.

A slot is a path from the root (``hierarchy.levels[2].A._device.vals``).
The walk descends into the port's objects (solvers, the hierarchy, its
levels, ``Matrix`` handles, device packs and their compact packs) and
into dicts, lists and tuples; it skips host data (numpy, scipy) and
callables, which no graph reads.  What it holds against the new tree:

* every old slot has a counterpart: a missing one (a lazy cache the
  old tree made at its first use, which the new tree lacks) names the
  slot in the drop reason — except a ``Matrix``'s device pack, which the
  walk builds on the new tree in the old pack's dtype, as a first use
  would (a slot that was still None at the capture no graph reads);
* a Python number, string, dtype or device (a value a graph may have
  taken by value at capture) is equal;
* two slots that share one object share one in the new tree too, and
  two old tensors that share storage (a DIA pack's ``diag`` is a view of
  its ``vals``) have new counterparts that share storage at the same
  offsets — else one copy would overwrite the other's values.

The copies run on the current stream, the one the graphs replay on, so
no replay reads a half-written level.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np
import torch

#: bookkeeping no graph reads: skipped wherever it appears
_SKIP = frozenset({
    "graphs", "_cycle", "cfg", "setup_time", "last_resetup", "rebind",
    "_bound", "_numeric_resetup", "_structure", "_cla_plans", "_wide"})
#: host-side state of a ``Matrix`` (its device pack is what graphs read)
_SKIP_MATRIX = frozenset({
    "dtype", "_device_dtype_pref", "_host", "_dia", "_dia_checked_max",
    "blocks", "block_offsets",
    "_dia_thunk",
    "_nnz_hint", "_csr_pattern", "_csr_vals_dev", "cf_map", "grid_dims",
    "_dia_offsets_hint", "_stencil_consistent", "_vals_f32_exact",
    "_pattern_fp", "_values_fp", "_fp_token_v"})
_SCALARS = (type(None), bool, int, float, complex, str, torch.dtype,
            torch.device, np.dtype, np.generic, enum.Enum)


class _Attr:
    __slots__ = ("obj", "name")

    def __init__(self, obj, name):
        self.obj, self.name = obj, name

    def get(self):
        return vars(self.obj)[self.name]

    def set(self, v):
        # frozen dataclasses (device packs) are updated in place too, so
        # every holder of the pack object sees the kept storage
        object.__setattr__(self.obj, self.name, v)


class _Item:
    __slots__ = ("c", "k")

    def __init__(self, c, k):
        self.c, self.k = c, k

    def get(self):
        return self.c[self.k]

    def set(self, v):
        self.c[self.k] = v


class _TupleItem:
    __slots__ = ("parent", "i")

    def __init__(self, parent, i):
        self.parent, self.i = parent, i

    def get(self):
        return self.parent.get()[self.i]

    def set(self, v):
        t = self.parent.get()
        self.parent.set(t[:self.i] + (v,) + t[self.i + 1:])


@dataclasses.dataclass
class Slot:
    """One leaf of the walk: ``kind`` "t" (a tensor), "v" (a value),
    "o" (an object or container of the given class) or "r" (a second
    path to what ``value`` — the first path — holds)."""
    path: str
    kind: str
    value: object
    ref: object = None
    tensor_ref: bool = False
    obj: object = None


@dataclasses.dataclass
class BindResult:
    """What :func:`rebind` did: ``kept`` with ``tensors`` slots paired
    and ``copied`` of them (``bytes``) copied into the old storage, or
    the ``reason`` the graphs go."""
    kept: bool
    reason: Optional[str] = None
    tensors: int = 0
    copied: int = 0
    bytes: int = 0


def _is_port_object(x) -> bool:
    return type(x).__module__.startswith("amgx_tpu_torch.") and \
        hasattr(x, "__dict__")


def _materialise(obj, path: str, hints) -> None:
    """Build on the new tree the lazy caches the old tree had made by
    its first use: a ``Matrix``'s device pack (a host-built P or R is
    packed at the first restriction)."""
    from ..core.matrix import Matrix
    if not isinstance(obj, Matrix) or hints is None or \
            obj._device is not None:
        return
    old = hints.get(path + "._device_dtype")
    if old is not None and old.kind == "v" and old.value is not None:
        obj.device(old.value)


def collect(root, hints: Optional[Dict[str, Slot]] = None) -> List[Slot]:
    """The slots of ``root``'s tree in a fixed order (object attributes
    and dict keys sorted).  ``hints`` — the old tree's slots by path —
    lets the walk build the lazy caches the old tree had."""
    out: List[Slot] = []
    seen: Dict[int, tuple] = {}

    def visit(x, path, ref):
        if isinstance(x, torch.Tensor):
            if id(x) in seen:
                out.append(Slot(path, "r", seen[id(x)][0], ref, True))
                return
            seen[id(x)] = (path, x)
            out.append(Slot(path, "t", x, ref))
            return
        if isinstance(x, _SCALARS):
            out.append(Slot(path, "v", x, ref))
            return
        if isinstance(x, tuple):
            out.append(Slot(path, "o", f"tuple/{len(x)}", ref))
            for i, v in enumerate(x):
                visit(v, f"{path}[{i}]", _TupleItem(ref, i))
            return
        if isinstance(x, (list, dict)) or _is_port_object(x):
            if id(x) in seen:
                out.append(Slot(path, "r", seen[id(x)][0], ref))
                return
            seen[id(x)] = (path, x)
            if isinstance(x, list):
                out.append(Slot(path, "o", f"list/{len(x)}", ref))
                for i, v in enumerate(x):
                    visit(v, f"{path}[{i}]", _Item(x, i))
                return
            if isinstance(x, dict):
                out.append(Slot(path, "o", "dict", ref))
                for k, v in sorted(x.items(), key=lambda kv: repr(kv[0])):
                    visit(v, f"{path}[{k!r}]", _Item(x, k))
                return
            _materialise(x, path, hints)
            out.append(Slot(path, "o", type(x).__qualname__, ref, obj=x))
            skip = _SKIP_MATRIX if type(x).__name__ == "Matrix" else ()
            for k in sorted(vars(x)):
                if k in _SKIP or k in skip:
                    continue
                visit(vars(x)[k], f"{path}.{k}", _Attr(x, k))
        # anything else (host arrays, scipy, callables) no graph reads

    for k in sorted(vars(root)):
        if k not in _SKIP:
            visit(vars(root)[k], k, _Attr(root, k))
    return out


def normalize_placement(root, mesh) -> None:
    """A distributed solve's placement seam (``DeviceBindings.
    normalize_placement`` upstream, which re-places a level held on a
    subset of the mesh's devices across the mesh): a mesh of the port
    holds every shard on one device, so there is nothing to move; the
    walk checks that every tensor of the solver tree is on that device,
    or on the CPU for the levels of a host tail (``amg_host_levels_rows``).
    One shard per card is ROADMAP item 8c of the port."""
    from ..errors import BadParametersError
    allowed = {mesh.device}
    h = getattr(root, "hierarchy", None)
    if h is not None and h.host_from < h.num_levels():
        allowed.add(torch.device("cpu"))
    for slot in collect(root):
        if slot.kind == "t" and slot.value.device not in allowed:
            raise BadParametersError(
                f"{slot.path} lives on {slot.value.device}, the mesh on "
                f"{mesh.device}")


def _same_value(a, b) -> bool:
    return type(a) is type(b) and bool(a == b)


def _describe(t: torch.Tensor) -> str:
    return f"{tuple(t.shape)} {t.dtype} {t.device}"


def pair(old: List[Slot], new: List[Slot]):
    """``(pairs, None)`` — the (old tensor, new slot) pairs — when every
    old slot has a matching counterpart, else ``(None, reason)``."""
    by_path = {s.path: s for s in new}
    pairs = []
    for o in old:
        n = by_path.get(o.path)
        if n is None:
            return None, f"{o.path}: no counterpart in the new tree"
        if o.kind == "v" and o.value is None and n.kind != "v":
            # made after the capture (a lazy cache): no graph reads it
            continue
        if o.kind != n.kind or o.tensor_ref != n.tensor_ref:
            return None, f"{o.path}: {o.kind} slot became {n.kind}"
        if o.kind == "t":
            a, b = o.value, n.value
            if a.shape != b.shape or a.dtype != b.dtype or \
                    a.device != b.device:
                return None, (f"{o.path}: {_describe(a)} became "
                              f"{_describe(b)}")
            pairs.append((a, n))
        elif o.kind == "r":
            if o.value != n.value:
                return None, (f"{o.path}: shares {o.value} in the old tree, "
                              f"{n.value} in the new")
        elif not _same_value(o.value, n.value):
            return None, (f"{o.path}: {o.value!r} became {n.value!r} (a "
                          "value a graph may hold)")
    # storage shared between two old tensors must be shared alike anew
    groups: Dict[int, list] = {}
    for a, n in pairs:
        if a.numel():
            groups.setdefault(a.untyped_storage().data_ptr(), []).append(
                (a, n))
    for members in groups.values():
        a0, n0 = members[0]
        for a, n in members[1:]:
            b0, b = n0.value, n.value
            if b.untyped_storage().data_ptr() != \
                    b0.untyped_storage().data_ptr() or \
                    b.storage_offset() - b0.storage_offset() != \
                    a.storage_offset() - a0.storage_offset() or \
                    b.stride() != a.stride():
                return None, (f"{n.path}: shares storage with {n0.path} in "
                              "the old tree, not alike in the new")
    return pairs, None


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == \
        b.untyped_storage().data_ptr() and \
        a.storage_offset() == b.storage_offset() and a.stride() == b.stride()


def rebind(old: List[Slot], new: List[Slot]) -> BindResult:
    """Pair ``old`` (the slots the graphs read) with ``new`` (the resetup
    tree's, from :func:`collect` with the old slots as hints); when they
    pair, copy every new tensor into its old storage on the current
    stream and point the new tree at the old tensors."""
    pairs, reason = pair(old, new)
    if pairs is None:
        return BindResult(kept=False, reason=reason)
    copied = nbytes = 0
    final = {}
    with torch.no_grad():
        for a, n in pairs:
            b = n.value
            if b is not a:
                if not _same_view(a, b):
                    a.copy_(b)
                    copied += 1
                    nbytes += a.numel() * a.element_size()
                n.ref.set(a)
            final[n.path] = a
        for n in new:
            if n.kind == "r" and n.tensor_ref and n.value in final:
                n.ref.set(final[n.value])
    return BindResult(kept=True, tensors=len(pairs), copied=copied,
                      bytes=nbytes)


def release_stale_packs(old: List[Slot], new: List[Slot]) -> None:
    """A ``Matrix`` of the old tree that the new tree no longer holds
    (the caller handed the resetup another handle) may still cache a
    pack whose storage now carries the new values: drop its device
    caches, which it rebuilds from its host data at its next use."""
    from ..core.matrix import Matrix

    def matrices(slots):
        return {id(s.obj): s.obj for s in slots
                if s.kind == "o" and isinstance(s.obj, Matrix)}

    live = matrices(new)
    for k, m in matrices(old).items():
        if k not in live:
            m._device = None
            m._dinv_dev = None

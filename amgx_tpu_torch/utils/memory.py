"""Memory observability (port of ``amgx_tpu/utils/memory.py``).

Reference: ``base/include/memory_info.h`` — ``MemoryInfo`` max-usage
tracking reported in the grid-stats table (used at ``amg.cu:1138``).
Here: the caching allocator's live bytes on the card
(``torch.cuda.memory_stats()``) and the per-session accounting of the
serving setup cache (:func:`device_tree_bytes`).
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, Optional

import torch


def _cuda() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class MemoryInfo:
    def __init__(self):
        self.max_bytes = 0

    def current_device_bytes(self) -> int:
        """Bytes the caching allocator holds in live tensors on the
        current card (0 without a card)."""
        if not _cuda():
            return 0
        return int(torch.cuda.memory_stats().get(
            "allocated_bytes.all.current", 0))

    def update_max_memory_usage(self) -> int:
        """Reference ``MemoryInfo::updateMaxMemoryUsage``."""
        cur = self.current_device_bytes()
        self.max_bytes = max(self.max_bytes, cur)
        return self.max_bytes

    def backend_stats(self) -> Dict:
        """The allocator's statistics of the current card ({} without
        one)."""
        if not _cuda():
            return {}
        try:
            return dict(torch.cuda.memory_stats())
        except Exception:
            return {}

    def report(self) -> str:
        self.update_max_memory_usage()
        gb = self.max_bytes / (1 << 30)
        return f"Maximum Memory Usage: {gb:8.3g} GB"


_info = MemoryInfo()


def memory_info() -> MemoryInfo:
    return _info


def _walk(x, seen: set, out: list):
    """Collect the tensors reachable from ``x``: through dicts, lists,
    tuples, sets, dataclasses, the port's objects (their attributes) and
    function closures; each container visited once."""
    stack = [x]
    while stack:
        x = stack.pop()
        if x is None or isinstance(x, (str, bytes, int, float, bool,
                                       complex, type)):
            continue
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple, set, frozenset)):
            stack.extend(x)
        elif isinstance(x, types.FunctionType):
            stack.extend(c.cell_contents for c in (x.__closure__ or ())
                         if _has_contents(c))
        elif isinstance(x, types.MethodType):
            stack.append(x.__self__)
        elif dataclasses.is_dataclass(x) or \
                type(x).__module__.startswith("amgx_tpu_torch."):
            d = getattr(x, "__dict__", None)
            if d is not None:
                stack.extend(d.values())
            for name in getattr(type(x), "__slots__", ()):
                stack.append(getattr(x, name, None))


def _has_contents(cell) -> bool:
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


def device_tree_bytes(tree, device: Optional[torch.device] = None) -> int:
    """Bytes of the storages behind the tensors reachable from ``tree``
    — the per-session accounting unit of the serving setup cache
    (``serve/cache.py``): one prepared solver's tree is its resident
    hierarchy, smoother data, packs and graph buffers.

    Each storage counts once, whole: a hierarchy's level 0 shares the
    matrix's pack, a DIA pack's diagonal is a view of its values, and a
    bf16 level keeps its wide pack until the smoother drops it — a
    double count here makes cache budgets over-evict.  ``device``
    restricts the count to tensors on that device (a session on the card
    does not count the CPU tensors of a host tail)."""
    tensors: list = []
    _walk(tree, set(), tensors)
    if device is not None:
        device = torch.device(device)
    total = 0
    seen = set()
    for t in tensors:
        if device is not None and (t.device.type != device.type or (
                device.index is not None and t.device.index is not None
                and t.device.index != device.index)):
            continue
        try:
            st = t.untyped_storage()
            key = (str(t.device), int(st.data_ptr()))
            nb = int(st.nbytes())
        except Exception:
            continue
        if key in seen or nb == 0:
            continue
        seen.add(key)
        total += nb
    return total

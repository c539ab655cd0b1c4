"""Mode system: (memory space, vector precision, matrix precision, index
precision) — port of ``amgx_tpu/modes.py`` (reference ``TemplateConfig``
/ ``AMGX_Mode``, ``base/include/basic_types.h:76-125``,
``base/include/amgx_config.h:102-147``).

A mode is a small runtime policy: where the data lives (``h…``: the CPU,
``d…``: the current CUDA device) and the dtypes of vectors, matrix values
and indices.  Mode strings follow the reference naming: ``dDDI`` = device
memory, double vectors, double matrix, int indices; the complex modes
(``dZZI`` …) map to ``complex128``/``complex64``.  The card has complex
arithmetic, so a complex device mode keeps its data on the card (the JAX
package moves it to the host only on a TPU, whose runtime has none).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .errors import BadModeError

__all__ = ["Mode", "parse_mode", "default_mode", "PUBLIC_MODES", "MODE_IDS"]

_MEM = {"h": "host", "d": "device"}
_PREC = {
    "D": np.float64,
    "F": np.float32,
    "Z": np.complex128,
    "C": np.complex64,
    "I": np.int32,
}

#: The 12 public modes of the reference (amgx_config.h:125-147).
PUBLIC_MODES = (
    "hDDI", "hDFI", "hFFI",
    "dDDI", "dDFI", "dFFI",
    "hZZI", "hZCI", "hCCI",
    "dZZI", "dZCI", "dCCI",
)

#: Numeric mode ids matching AMGX_Mode enum ordering (amgx_config.h:125-147).
MODE_IDS = {name: i for i, name in enumerate(PUBLIC_MODES)}

_fp64_warned: set = set()


def _warn_fp64_downgrade(mode_name: str):
    """One-time visible notice that a device-mode fp64 matrix is packed in
    fp32 on the card, so a tolerance below ~1e-7 is reached by the
    refinement ladder over the fp64 host matrix."""
    if mode_name in _fp64_warned:
        return
    _fp64_warned.add(mode_name)
    from .utils.logging import amgx_output

    amgx_output(
        f"NOTE: mode {mode_name}: the device pack runs in fp32 on this "
        "accelerator; the host matrix stays fp64 and mixed-precision "
        "refinement recovers full-precision residuals for tight "
        "tolerances.\n")


@dataclasses.dataclass(frozen=True)
class Mode:
    """Runtime policy: where data lives and which dtypes are used."""

    name: str
    mem_space: str        # "host" | "device"
    vec_dtype: np.dtype
    mat_dtype: np.dtype
    ind_dtype: np.dtype

    @property
    def is_complex(self) -> bool:
        return np.issubdtype(self.vec_dtype, np.complexfloating)

    @property
    def is_device(self) -> bool:
        return self.mem_space == "device"

    def placement_device(self) -> torch.device:
        """The torch device the data lives on: the CPU for host modes, the
        current CUDA device for device modes (a ``DeviceError`` without a
        card)."""
        from .device import resolve_device

        return resolve_device("cpu" if self.mem_space == "host" else "cuda")

    def effective_mat_dtype(self) -> np.dtype:
        """The device pack's value dtype: a device-mode fp64 matrix packs
        in fp32 (the JAX package's rule for any accelerator backend,
        ``amgx_tpu/modes.py:118-137``; the f32 → f64 refinement ladder
        recovers tight tolerances); complex keeps its dtype on the card;
        host modes keep theirs."""
        if self.mem_space == "device" and \
                self.mat_dtype == np.dtype(np.float64):
            _warn_fp64_downgrade(self.name)
            return np.dtype(np.float32)
        return self.mat_dtype


def parse_mode(mode: "str | int | Mode") -> Mode:
    """Parse a mode string like ``dDDI`` (or AMGX_Mode integer) into a Mode."""
    if isinstance(mode, Mode):
        return mode
    if isinstance(mode, int):
        if not 0 <= mode < len(PUBLIC_MODES):
            raise BadModeError(f"unknown mode id {mode}")
        mode = PUBLIC_MODES[mode]
    if not (isinstance(mode, str) and len(mode) == 4):
        raise BadModeError(f"bad mode {mode!r}")
    mem, vp, mp, ip = mode[0], mode[1], mode[2], mode[3]
    if mem not in _MEM or vp not in _PREC or mp not in _PREC or ip != "I":
        raise BadModeError(f"unknown mode {mode!r}")
    return Mode(
        name=mode,
        mem_space=_MEM[mem],
        vec_dtype=np.dtype(_PREC[vp]),
        mat_dtype=np.dtype(_PREC[mp]),
        ind_dtype=np.dtype(np.int32),
    )


def default_mode() -> Mode:
    return parse_mode("dDDI")

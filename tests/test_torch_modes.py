"""The 12 AMGX modes of the port (``amgx_tpu_torch.modes``) against the
JAX package's ``amgx_tpu.modes``: fields, ids, errors, placement."""
import numpy as np
import pytest
import torch

from amgx_tpu import modes as jmodes

import amgx_tpu_torch
from amgx_tpu_torch import modes
from amgx_tpu_torch.errors import BadModeError, DeviceError


@pytest.mark.parametrize("name", jmodes.PUBLIC_MODES)
def test_mode_fields_match_jax(name):
    m, j = modes.parse_mode(name), jmodes.parse_mode(name)
    assert (m.name, m.mem_space, m.vec_dtype, m.mat_dtype, m.ind_dtype,
            m.is_complex, m.is_device) == \
        (j.name, j.mem_space, j.vec_dtype, j.mat_dtype, j.ind_dtype,
         j.is_complex, j.is_device)
    assert modes.parse_mode(modes.MODE_IDS[name]) == m
    assert modes.MODE_IDS[name] == jmodes.MODE_IDS[name]


def test_public_api_and_errors():
    assert modes.PUBLIC_MODES == jmodes.PUBLIC_MODES
    assert amgx_tpu_torch.parse_mode is modes.parse_mode
    assert amgx_tpu_torch.default_mode().name == "dDDI"
    for bad in ("dDDX", "xDDI", "dQQI", "dDD", 12, -1, 3.0):
        with pytest.raises(BadModeError):
            modes.parse_mode(bad)
        with pytest.raises(jmodes.BadModeError):
            jmodes.parse_mode(bad)


def test_placement_and_pack_dtypes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in modes.PUBLIC_MODES:
        m = modes.parse_mode(name)
        if name[0] == "h":
            assert m.placement_device() == torch.device("cpu")
            assert m.effective_mat_dtype() == m.mat_dtype
        else:
            with pytest.raises(DeviceError):
                m.placement_device()
            # the JAX package's rule off the CPU: f64 packs narrow to f32,
            # complex keeps its dtype on a card (only a TPU narrows it)
            want = np.dtype(np.float32) if name[2] == "D" else m.mat_dtype
            assert m.effective_mat_dtype() == want

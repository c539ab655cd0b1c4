"""The port stands alone: it imports neither JAX nor the JAX package, and
its data entry points refuse to run on the CPU unless asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import amgx_tpu_torch
from amgx_tpu_torch.errors import DeviceError
from amgx_tpu_torch.io import poisson7pt, poisson7pt_device

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "amgx_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_headline_ab.py",
     ROOT / "scripts" / "torch_dfg_depth.py",
     ROOT / "scripts" / "torch_kernel_ab.py",
     ROOT / "scripts" / "torch_setup_engine.py",
     ROOT / "scripts" / "torch_boundary_phases.py",
     ROOT / "scripts" / "torch_item7b_phases.py",
     ROOT / "scripts" / "torch_item8a_phases.py",
     ROOT / "scripts" / "torch_item8b_phases.py",
     ROOT / "scripts" / "torch_telemetry_phase.py",
     ROOT / "scripts" / "torch_serve_phase.py"]


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, amgx_tpu_torch, amgx_tpu_torch.interop, "
            "amgx_tpu_torch.eigen, amgx_tpu_torch.operators, "
            "amgx_tpu_torch.modes, amgx_tpu_torch.telemetry, "
            "amgx_tpu_torch.telemetry.doctor, "
            "amgx_tpu_torch.utils.profiler, amgx_tpu_torch.serve, "
            "amgx_tpu_torch.serve.loadgen, amgx_tpu_torch.telemetry.slo, "
            "amgx_tpu_torch.telemetry.httpd, "
            "amgx_tpu_torch.telemetry.meshtrace, "
            "amgx_tpu_torch.telemetry.overlap, "
            "amgx_tpu_torch.utils.memory, amgx_tpu_torch.utils.retry, "
            "amgx_tpu_torch.utils.signals, "
            "amgx_tpu_torch.utils.thread_manager\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'amgx_tpu' or "
            "m.startswith('amgx_tpu.')]\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_file_imports_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "amgx_tpu"), (path, name)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_gen_without_card_raises(no_cuda):
    with pytest.raises(DeviceError):
        poisson7pt_device(4, 4, 4)
    m = poisson7pt_device(4, 4, 4, device="cpu")
    assert m.device().vals.device.type == "cpu"


def test_matrix_without_card_raises(no_cuda):
    with pytest.raises(DeviceError):
        amgx_tpu_torch.Matrix(poisson7pt(4, 4, 4))
    m = amgx_tpu_torch.Matrix(poisson7pt(4, 4, 4), device="cpu")
    assert m.device(np.float32).vals.dtype == torch.float32

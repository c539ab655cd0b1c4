"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<digest>.so`` at first
use (the digest covers the source and the flags, so an edited source is
rebuilt), then loaded with :mod:`ctypes`.  Nothing is built when the
package is imported: the CPU path never needs ``nvcc``.  A missing
``nvcc`` or a failed build raises.

The build directory is the port's persistent compile cache: the
``compile_cache_dir`` knob points it elsewhere (:func:`set_build_dir`),
and a later process that finds a source's library there builds nothing.
Builds are safe across threads (one lock around lookup, build and load)
and across processes (each ``nvcc`` writes a name of its own, renamed
into place once complete).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from .errors import DeviceError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: per kernel source: {"seconds": build wall time, "log": nvcc output}
BUILD_LOG: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: library lookups that found the source built (hits) or ran nvcc
#: (misses): the kernel build directory's cache counters
_BUILDS = {"hits": 0, "misses": 0}
#: serialises lookups, builds and loads between threads (two lanes that
#: first touch one kernel build it once)
_LOCK = threading.RLock()
_DEFAULT_BUILD_DIR = BUILD_DIR


def set_build_dir(path) -> Path:
    """Build and find the kernels under ``path`` (the
    ``compile_cache_dir`` knob; empty restores ``_build/``).  Libraries
    already loaded stay loaded."""
    global BUILD_DIR
    with _LOCK:
        BUILD_DIR = Path(path).resolve() if path else _DEFAULT_BUILD_DIR
        return BUILD_DIR


def build_stats() -> Dict[str, int]:
    """Hits and misses of the kernel build directory in this process."""
    return dict(_BUILDS)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise DeviceError("nvcc not found: the CUDA kernels cannot be built "
                      "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Build every named source that is not built yet, one ``nvcc`` per
    source, all started together; returns the library paths."""
    with _LOCK:
        return _build_all(list(names))


def _build_all(names) -> Dict[str, Path]:
    outs = {n: _target(n) for n in names}
    todo = [n for n in names if not outs[n].exists()]
    _BUILDS["hits"] += len(names) - len(todo)
    _BUILDS["misses"] += len(todo)
    if not todo:
        return outs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = outs[n].with_name(
            f"{outs[n].stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, outs[n])
    if failed:
        raise DeviceError("CUDA kernel build failed:\n" + "\n".join(failed))
    # a kernel build is what a backend compile is to the JAX package:
    # amgx_jit_compile_total and the setup profile's compile bucket
    from .telemetry import metrics, setup_profile
    dt = time.perf_counter() - t0
    metrics.counter_inc("amgx_jit_compile_total", float(len(todo)))
    metrics.hist_observe("amgx_jit_compile_seconds", dt)
    setup_profile.note_duration(True, dt)
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build_all([name])[name]))
                _LIBS[name] = lib
    return lib

"""Build the port's native C API without cmake.

:func:`build_shim` compiles ``amgx_c_shim.cpp`` with the host C++
compiler (the one ``nvcc`` drives on the card's machine) into
``libamgx_torch_c.so``; :func:`build_driver` compiles a C driver written
against ``native/amgx_tpu_c.h`` and links it to that library.  Include
and library flags come from ``sysconfig`` (``INCLUDEPY``, ``LIBDIR``,
``LDLIBRARY``) and ``numpy.get_include()``; the interpreter that runs
the build is the one the library embeds.  Outputs go under the kernel
build directory (``native.BUILD_DIR``, ``amgx_tpu_torch/_build/`` unless
``compile_cache_dir`` moved it), in a folder named by a digest of the
sources, this build script and the Python build, so an edited source is rebuilt
and a built one is reused.  A failed compile raises
:class:`ShimBuildError` with the compiler's output.

    python3 -m amgx_tpu_torch.capi_native.build [driver.c ...]

builds the library (and the named drivers) and prints their paths.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent
PACKAGE_ROOT = HERE.parent.parent
#: the AmgX C ABI the drivers include (shared with the JAX package's shim)
ABI_HEADER_DIR = PACKAGE_ROOT / "native"
SHIM = HERE / "amgx_c_shim.cpp"
EXT_HEADER = HERE / "amgx_torch_c_ext.h"
LIB_NAME = "amgx_torch_c"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-Wall")
C_FLAGS = ("-O2", "-std=c11", "-Wall")

_LOCK = threading.RLock()
_FNV = {}


class ShimBuildError(RuntimeError):
    """The compiler refused the shim or a driver, or the Python build
    cannot be embedded (no Python.h, no shared libpython)."""


def python_build_info() -> Dict[str, str]:
    """What the build reads from this interpreter: ``sysconfig``'s
    include dir, library dir, library name and shared flag, numpy's
    include dir and the interpreter path the shim embeds."""
    cv = sysconfig.get_config_var
    return {
        "INCLUDEPY": str(cv("INCLUDEPY") or ""),
        "LIBDIR": str(cv("LIBDIR") or ""),
        "LDLIBRARY": str(cv("LDLIBRARY") or ""),
        "LDVERSION": str(cv("LDVERSION") or cv("VERSION") or ""),
        "Py_ENABLE_SHARED": str(cv("Py_ENABLE_SHARED")),
        "numpy_include": np.get_include(),
        "executable": sys.executable,
        "version": sys.version.split()[0],
    }


def find_compiler(lang: str) -> str:
    """The host compiler for ``lang`` ("c" or "c++"): ``$CC``/``$CXX``,
    then ``sysconfig``'s, then the usual names on ``PATH``."""
    env, cfg, names = (("CXX", "CXX", ("g++", "c++", "clang++"))
                       if lang == "c++" else
                       ("CC", "CC", ("gcc", "cc", "clang")))
    for cand in (os.environ.get(env), sysconfig.get_config_var(cfg)):
        if cand:
            exe = shutil.which(shlex.split(cand)[0])
            if exe:
                return exe
    for name in names:
        exe = shutil.which(name)
        if exe:
            return exe
    raise ShimBuildError(f"no {lang} compiler found (set ${env})")


def _python_flags(info: Dict[str, str]) -> List[str]:
    """Compile and link flags of the embedded interpreter; raises where
    this Python cannot be embedded in a shared library."""
    inc = Path(info["INCLUDEPY"])
    if not (inc / "Python.h").is_file():
        raise ShimBuildError(f"Python.h not found under {inc} (INCLUDEPY): "
                             "this Python has no development headers")
    shared = find_libpython(info)
    return [f"-I{inc}", f"-I{info['numpy_include']}", str(shared),
            f"-Wl,-rpath,{shared.parent}"]


def find_libpython(info: Dict[str, str]) -> Path:
    """The shared libpython of this interpreter (``LDLIBRARY`` in
    ``LIBDIR`` or ``LIBPL``, or its versioned name); raises where the
    build has none."""
    names = [info["LDLIBRARY"], f"libpython{info['LDVERSION']}.so",
             f"libpython{info['LDVERSION']}.so.1.0"]
    dirs = [info["LIBDIR"], str(sysconfig.get_config_var("LIBPL") or "")]
    for d in dirs:
        for name in names:
            if d and name.endswith((".so", ".so.1.0")) and \
                    (Path(d) / name).exists():
                return Path(d) / name
    raise ShimBuildError(
        f"no shared libpython in {dirs} (LDLIBRARY={info['LDLIBRARY']}, "
        f"Py_ENABLE_SHARED={info['Py_ENABLE_SHARED']}): the interpreter "
        "cannot be embedded in libamgx_torch_c.so")


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else repr(p).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """The folder of this source and Python build's library and
    drivers."""
    from .. import native
    info = python_build_info()
    # this file holds every flag and command line: it is keyed too
    key = _digest(SHIM.read_bytes(), EXT_HEADER.read_bytes(),
                  (ABI_HEADER_DIR / "amgx_tpu_c.h").read_bytes(),
                  Path(__file__).read_bytes(), sorted(info.items()),
                  str(PACKAGE_ROOT))
    return native.BUILD_DIR / f"capi-{key}"


def _compile(cmd: List[str], out: Path) -> None:
    """Run one compiler command writing ``out`` through a temporary
    name (renamed into place once complete)."""
    tmp = out.with_name(f".{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    cmd = [str(tmp) if c == "@OUT" else c for c in cmd]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise ShimBuildError(
            f"compile failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def build_shim() -> Path:
    """``libamgx_torch_c.so``, built on first use; returns its path."""
    with _LOCK:
        out_dir = build_dir()
        lib = out_dir / f"lib{LIB_NAME}.so"
        if lib.exists():
            return lib
        info = python_build_info()
        out_dir.mkdir(parents=True, exist_ok=True)
        cmd = [find_compiler("c++"), *CXX_FLAGS,
               f"-DAMGX_TORCH_PYTHON=\"{info['executable']}\"",
               f"-DAMGX_TORCH_ROOT=\"{PACKAGE_ROOT}\"",
               f"-I{ABI_HEADER_DIR}", f"-I{HERE}", str(SHIM),
               "-o", "@OUT", *_python_flags(info), "-lpthread", "-ldl",
               "-lm"]
        _compile(cmd, lib)
        return lib


def build_driver(source, name: str = None) -> Path:
    """A C driver (``native/amgx_tpu_c.h`` and, where it needs them, the
    port's extension entry points) linked against the port's library;
    built on first use, returns the executable's path."""
    source = Path(source).resolve()
    with _LOCK:
        lib = build_shim()
        exe = lib.parent / f"{name or source.stem}-" \
            f"{_digest(source.read_bytes())}"
        if exe.exists():
            return exe
        cmd = [find_compiler("c"), *C_FLAGS, f"-I{ABI_HEADER_DIR}",
               f"-I{HERE}", str(source), "-o", "@OUT",
               f"-L{lib.parent}", f"-l{LIB_NAME}",
               f"-Wl,-rpath,{lib.parent}", "-lpthread", "-lm"]
        _compile(cmd, exe)
        return exe


def fnv1a64(data) -> int:
    """64-bit FNV-1a of an array's bytes, by the library's own
    ``amgx_torch_fnv1a64`` (the function the C drivers print)."""
    arr = np.ascontiguousarray(data)
    fn = _FNV.get("fn")
    if fn is None:
        fn = ctypes.CDLL(str(build_shim())).amgx_torch_fnv1a64
        fn.restype = ctypes.c_ulonglong
        fn.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
        _FNV["fn"] = fn
    return int(fn(arr.ctypes.data, arr.nbytes))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    print(build_shim())
    for src in argv:
        print(build_driver(src))
    return 0


if __name__ == "__main__":
    sys.exit(main())

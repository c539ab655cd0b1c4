"""AMGX-compatible C API surface of the port (a port of
``amgx_tpu/capi.py``).

Python realisation of the ``base/include/amgx_c.h`` + ``amgx_eig_c.h``
contract: opaque handles + ``AMGX_*`` functions returning
:class:`~amgx_tpu_torch.errors.RC` codes, with exceptions caught at the
boundary like the reference's ``AMGX_CATCHES`` (``amgx_c.cu:89-91``).
The native shared library (``capi_native/amgx_c_shim.cpp``, built by
``capi_native/build.py`` without cmake) exports the same symbols as real
C functions by embedding this module, so drivers written against
``native/amgx_tpu_c.h`` link and run unchanged.

A handle's mode places its data: ``h…`` modes on the CPU, ``d…`` modes
on the card (a ``DeviceError``, RC ``CUDA_FAILURE``, where there is
none; nothing runs on the CPU instead).  A device-mode f64 matrix keeps
its f64 host matrix and packs in f32 on the card (the refinement ladder
recovers f64 residuals, :meth:`Mode.effective_mat_dtype`).  Vector data
is a tensor on its mode's device, so upload → solve → download copies
host → device once and device → host once.

Conventions: functions that have C out-params return ``(rc, value…)``
tuples; all others return the RC alone.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
from contextlib import nullcontext
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from . import io as _io
from .config import AMGConfig
from .core.matrix import Matrix
from .device import device_lock, torch_dtype
from .eigen import EigenSolverFactory
from .errors import (AMGXError, BadParametersError, RC, SolveStatus,
                     exception_rc)
from .modes import parse_mode
from .solvers import SolverFactory
from .utils import register_print_callback as _register_cb


def _catches(n_outputs: int = 0):
    """Translate exceptions into RC codes (AMGX_CATCHES analog): an
    :class:`AMGXError` returns its own code (a ``DeviceError`` its
    ``CUDA_FAILURE``), the card's out-of-memory error ``NO_MEMORY``,
    anything else ``UNKNOWN``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            try:
                out = fn(*args, **kwargs)
            except Exception as e:
                if not isinstance(e, AMGXError) and \
                        os.environ.get("AMGX_TPU_DEBUG"):
                    import traceback
                    traceback.print_exc()
                rc = exception_rc(e)
                return (rc,) + (None,) * n_outputs if n_outputs else rc
            if n_outputs == 0:
                return RC.OK if out is None else out
            if not isinstance(out, tuple):
                out = (out,)
            return (RC.OK,) + out
        return wrapper
    return deco


# ------------------------------------------------------------------ handles
class ConfigHandle:
    def __init__(self, cfg: AMGConfig):
        self.cfg = cfg


class ResourcesHandle:
    """Reference ``Resources`` (resources.h:44-82): devices + config."""

    def __init__(self, cfg: ConfigHandle, comm=None, device_num=0,
                 devices=None):
        self.cfg = cfg
        self.comm = comm
        self.devices = list(devices) if devices else [int(device_num)]
        # the warm-start knobs ride Resources creation, the first object
        # every C driver builds: where the kernels build and are found,
        # and the setup engine's plan store (solver construction applies
        # the same knobs again for Python drivers)
        try:
            cache_dir = str(cfg.cfg.get("compile_cache_dir"))
            aot_dir = str(cfg.cfg.get("aot_store_dir"))
            if cache_dir:
                from . import native
                native.set_build_dir(cache_dir)
            if aot_dir:
                from .serve import aot as _aot
                _aot.configure(aot_dir)
            if cache_dir or aot_dir:
                from .telemetry import runstate
                runstate.configure_default(aot_dir or cache_dir)
        except Exception as e:
            # the wiring never fails create, but says so when it is lost
            from .utils.logging import error_output
            error_output("AMGX warning: warm-start wiring failed "
                         f"(kernel cache / AOT store disabled): {e!r}\n")


class MatrixHandle:
    def __init__(self, rsrc: ResourcesHandle, mode):
        self.rsrc = rsrc
        self.mode = parse_mode(mode)
        self.matrix: Optional[Matrix] = None
        self.bound_vectors = []


class VectorHandle:
    def __init__(self, rsrc: ResourcesHandle, mode):
        self.rsrc = rsrc
        self.mode = parse_mode(mode)
        #: a tensor on the mode's device (None until uploaded)
        self.data: Optional[torch.Tensor] = None
        self.block_dim = 1
        self.bound_matrix: Optional[MatrixHandle] = None


class SolverHandle:
    def __init__(self, rsrc: ResourcesHandle, mode, cfg: ConfigHandle):
        self.rsrc = rsrc
        self.mode = parse_mode(mode)
        self.cfg = cfg.cfg
        self.solver = SolverFactory.allocate(self.cfg, "default", "solver")
        self.solver._toplevel = True    # owns solve-boundary transforms
        self.last_result = None


class EigenSolverHandle:
    def __init__(self, rsrc: ResourcesHandle, mode, cfg: ConfigHandle):
        self.rsrc = rsrc
        self.mode = parse_mode(mode)
        self.cfg = cfg.cfg
        self.solver = EigenSolverFactory.allocate(self.cfg)
        self.last_result = None


def _card_lock(handle):
    """The card's lock for a device-mode handle's work (a CUDA graph's
    capture is invalidated by another thread's launch), else nothing."""
    if handle.mode.is_device:
        return device_lock(handle.mode.placement_device())
    return nullcontext()


def _to_vector(vec: VectorHandle, data) -> torch.Tensor:
    """``data`` (an array or a caller's buffer view) as a tensor of the
    vector's dtype on its mode's device: one host → device copy on the
    card, a private copy on the CPU (the caller keeps its buffer,
    ``amgx_c.h`` upload semantics)."""
    dev = vec.mode.placement_device()
    arr = np.ascontiguousarray(
        np.asarray(data, dtype=vec.mode.vec_dtype).reshape(-1))
    return torch.from_numpy(arr).to(dev, copy=True)


# ---------------------------------------------------------------- lifecycle
@_catches()
def AMGX_initialize():
    from . import initialize
    initialize()


@_catches()
def AMGX_initialize_plugins():
    pass  # eigensolvers are built in


@_catches()
def AMGX_finalize():
    from . import finalize
    finalize()


@_catches()
def AMGX_finalize_plugins():
    pass


@_catches(2)
def AMGX_get_api_version():
    return 2, 0


@_catches(3)
def AMGX_get_build_info_strings():
    from . import __reference_version__, __version__
    return (f"amgx_tpu_torch {__version__}", f"API {__reference_version__}",
            f"cuda/torch backend (torch {torch.__version__}, "
            f"CUDA {torch.version.cuda})")


@_catches()
def AMGX_register_print_callback(fn):
    _register_cb(fn)


@_catches()
def AMGX_install_signal_handler():
    from .utils.signals import install_signal_handlers
    install_signal_handlers()


@_catches()
def AMGX_reset_signal_handler():
    from .utils.signals import reset_signal_handlers
    reset_signal_handlers()


@_catches()
def AMGX_pin_memory(arr):
    pass  # uploads copy through pageable memory


@_catches()
def AMGX_unpin_memory(arr):
    pass


# ------------------------------------------------------------------- config
@_catches(1)
def AMGX_config_create(options: str):
    return ConfigHandle(AMGConfig(options if options else
                                  "config_version=2"))


@_catches(1)
def AMGX_config_create_from_file(path: str):
    return ConfigHandle(AMGConfig.from_file(path))


@_catches(1)
def AMGX_config_create_from_file_and_string(path: str, options: str):
    cfg = AMGConfig.from_file(path)
    if options:
        cfg.parse(options)
    return ConfigHandle(cfg)


@_catches()
def AMGX_config_add_parameters(cfg: ConfigHandle, options: str):
    cfg.cfg.parse(options)


@_catches(1)
def AMGX_config_get_default_number_of_rings(cfg: ConfigHandle):
    # reference: 1 ring unless aggregation-style solvers require 2
    # (amgx_c.cu default ring logic)
    solver = str(cfg.cfg.get("solver"))
    algo = str(cfg.cfg.get("algorithm"))
    return 2 if (solver == "AMG" and algo == "AGGREGATION") else 1


@_catches()
def AMGX_config_destroy(cfg: ConfigHandle):
    pass


@_catches(1)
def AMGX_write_parameters_description(path_or_none=None):
    text = AMGConfig().write_parameters_description()
    if path_or_none:
        with open(path_or_none, "w") as f:
            f.write(text)
    return text


# ---------------------------------------------------------------- resources
@_catches(1)
def AMGX_resources_create(cfg: ConfigHandle, comm=None, device_num=0,
                          devices=None):
    return ResourcesHandle(cfg, comm, device_num, devices)


@_catches(1)
def AMGX_resources_create_simple(cfg: ConfigHandle):
    return ResourcesHandle(cfg)


@_catches()
def AMGX_resources_destroy(rsrc: ResourcesHandle):
    pass


# ------------------------------------------------------------------- matrix
def _apply_mode_policy(mtx: MatrixHandle):
    """Place the pack on the mode's device and apply the precision
    policy (host modes keep their dtype; a device-mode f64 matrix packs
    in f32 on the card over its f64 host matrix, see
    ``Mode.effective_mat_dtype``)."""
    m = mtx.matrix
    if m is None:
        return
    if m.dist is None:
        m.placement = mtx.mode.placement_device()
    eff = mtx.mode.effective_mat_dtype()
    if np.dtype(m.dtype) != eff:
        if np.dtype(eff).itemsize < np.dtype(m.dtype).itemsize:
            # narrower pack than the uploaded data (dDDI on the card):
            # KEEP the wide host matrix and narrow only the device pack,
            # so the refinement ladder reaches f64 residuals
            m.device_dtype = np.dtype(eff)
            m._device = None
        elif m.blocks is not None:
            m.blocks = [b.astype(eff) for b in m.blocks]
            m.dtype = np.dtype(eff)
            m._device = None
        else:
            m.set(m.host.astype(eff), block_dim=m.block_dim)


def _mesh(mtx: MatrixHandle, n_parts: int):
    """A mesh of ``n_parts`` shards on the mode's device: every shard
    on one card (or the CPU).  Resources over several cards ask for a
    mesh across devices, ROADMAP item 8c of the port, which raises
    (``NOT_IMPLEMENTED``) rather than running on one."""
    from .distributed import make_mesh
    devices = list(getattr(mtx.rsrc, "devices", None) or [0])
    if mtx.mode.is_device and len(set(devices)) > 1:
        return make_mesh(n_parts, device=[f"cuda:{int(d)}"
                                          for d in devices])
    return make_mesh(n_parts, device=mtx.mode.placement_device())


def _maybe_distribute(mtx: MatrixHandle, n_parts, offsets=None):
    """Distribute the handle's matrix over ``n_parts`` shards (all on
    the mode's one device; a single part stays undistributed)."""
    if n_parts is None or int(n_parts) <= 1:
        return
    mtx.matrix.set_distribution(_mesh(mtx, int(n_parts)), offsets=offsets)


@_catches(1)
def AMGX_matrix_create(rsrc: ResourcesHandle, mode):
    return MatrixHandle(rsrc, mode)


@_catches()
def AMGX_matrix_destroy(mtx: MatrixHandle):
    mtx.matrix = None


def _upload_all(mtx: MatrixHandle, n, nnz, block_dimx, block_dimy,
                row_ptrs, col_indices, data, diag_data=None):
    """``amgx_c.h:288-296``: block-CSR upload with an optional external
    diagonal, built on the mode's device (checked first: a device mode
    without a card raises before anything is built)."""
    dev = mtx.mode.placement_device()
    if block_dimx != block_dimy:
        raise AMGXError("non-square blocks are not supported",
                        RC.NOT_SUPPORTED_BLOCKSIZE)
    data = np.asarray(data, dtype=mtx.mode.mat_dtype)
    m = Matrix.from_csr(np.asarray(row_ptrs), np.asarray(col_indices),
                        data, block_dim=int(block_dimx), device=dev)
    if diag_data is not None:
        # external diagonal (DIAG property): add to the assembled matrix
        b = int(block_dimx)
        dd = np.asarray(diag_data, dtype=mtx.mode.mat_dtype)
        if b == 1:
            D = sp.diags(dd.ravel())
        else:
            D = sp.block_diag([blk for blk in dd.reshape(-1, b, b)],
                              format="csr")
        m.set(sp.csr_matrix(m.host + D), block_dim=b)
    mtx.matrix = m
    _apply_mode_policy(mtx)


@_catches()
def AMGX_matrix_upload_all(mtx: MatrixHandle, n, nnz, block_dimx,
                           block_dimy, row_ptrs, col_indices, data,
                           diag_data=None):
    _upload_all(mtx, n, nnz, block_dimx, block_dimy, row_ptrs,
                col_indices, data, diag_data)


@_catches()
def AMGX_matrix_replace_coefficients(mtx: MatrixHandle, n, nnz, data,
                                     diag_data=None):
    mtx.matrix.replace_coefficients(
        np.asarray(data, dtype=mtx.mode.mat_dtype))


@_catches(3)
def AMGX_matrix_get_size(mtx: MatrixHandle):
    m = mtx.matrix
    return m.n_block_rows, m.block_dim, m.block_dim


@_catches(1)
def AMGX_matrix_get_nnz(mtx: MatrixHandle):
    return mtx.matrix.nnz // (mtx.matrix.block_dim ** 2)


@_catches(3)
def AMGX_matrix_download_all(mtx: MatrixHandle):
    b = mtx.matrix.block_dim
    if b == 1:
        csr = mtx.matrix.scalar_csr()
        return csr.indptr.copy(), csr.indices.copy(), csr.data.copy()
    bsr = mtx.matrix.host if isinstance(mtx.matrix.host, sp.bsr_matrix) \
        else sp.bsr_matrix(mtx.matrix.host, blocksize=(b, b))
    return bsr.indptr.copy(), bsr.indices.copy(), bsr.data.copy()


@_catches()
def AMGX_matrix_vector_multiply(mtx: MatrixHandle, x: "VectorHandle",
                                y: "VectorHandle"):
    """y = A·x through the port's ``ops.spmv`` on a pack of the mode's
    matrix dtype (on the card: the pack's hand kernel, B1 on a banded
    upload)."""
    from .ops.spmv import spmv
    with _card_lock(mtx):
        d = mtx.matrix.device(dtype=mtx.mode.mat_dtype)
        xin = x.data.to(device=d.device, dtype=d.dtype)
        y.data = spmv(d, xin)


@_catches()
def AMGX_matrix_set_boundary_separation(mtx: MatrixHandle, flag: int):
    mtx.boundary_separation = int(flag)


@_catches()
def AMGX_matrix_attach_coloring(mtx: MatrixHandle, row_coloring,
                                num_rows, num_colors):
    from .coloring import MatrixColoring
    mtx.matrix.coloring = MatrixColoring(
        colors=np.asarray(row_coloring, dtype=np.int32).copy(),
        num_colors=int(num_colors))


@_catches()
def AMGX_matrix_attach_geometry(mtx: MatrixHandle, geox, geoy, geoz=None):
    """``amgx_c.h:541-546`` — per-row coordinates.  When they form a
    regular lexicographic grid, grid dims are derived and feed the GEO
    selector's structured path (amg/structured.py)."""
    coords = tuple(np.array(g, dtype=np.float64) for g in
                   (geox, geoy, geoz) if g is not None)
    mtx.matrix.geometry = coords
    dims = _regular_grid_dims(coords)
    if dims is not None:
        mtx.matrix.grid_dims = dims


def _regular_grid_dims(coords):
    """(nz, ny, nx) when the coordinate arrays describe a full regular
    grid in lexicographic (x fastest, then y, then z) order; None
    otherwise.  The FULL layout is verified — every axis must equal the
    exact tile/repeat pattern of its sorted unique values, so serpentine
    orderings or swapped axis nesting are rejected rather than producing
    misordered dims."""
    if not coords:
        return None
    n = len(coords[0])
    uniques, sizes = [], []
    for axis in coords:
        u = np.unique(axis)                 # sorted
        if len(u) == 0 or n % len(u) != 0:
            return None
        uniques.append(u)
        sizes.append(len(u))
    if int(np.prod(sizes)) != n:
        return None
    inner = 1
    for axis, u, s in zip(coords, uniques, sizes):
        expect = np.tile(np.repeat(u, inner), n // (inner * s))
        if not np.array_equal(axis, expect):
            return None
        inner *= s
    dims3 = ([1] * (3 - len(sizes)) + list(reversed(sizes)))
    return tuple(int(d) for d in dims3)


# ------------------------------------------------------------------- vector
@_catches(1)
def AMGX_vector_create(rsrc: ResourcesHandle, mode):
    return VectorHandle(rsrc, mode)


@_catches()
def AMGX_vector_destroy(vec: VectorHandle):
    vec.data = None


@_catches()
def AMGX_vector_upload(vec: VectorHandle, n, block_dim, data):
    vec.data = _to_vector(vec, data)
    vec.block_dim = int(block_dim)


@_catches()
def AMGX_vector_set_zero(vec: VectorHandle, n, block_dim):
    vec.data = torch.zeros(int(n) * int(block_dim),
                           dtype=torch_dtype(vec.mode.vec_dtype),
                           device=vec.mode.placement_device())
    vec.block_dim = int(block_dim)


@_catches()
def AMGX_vector_set_random(vec: VectorHandle, n):
    vec.data = _to_vector(vec, np.random.default_rng().standard_normal(
        int(n)))


@_catches(1)
def AMGX_vector_download(vec: VectorHandle, out=None):
    """The vector's values as a host array of the mode's vector dtype:
    one device → host copy.  With ``out`` (a caller's buffer, as the
    native shim passes it) the copy lands there and ``out`` returns."""
    if vec.data is None:
        raise BadParametersError("vector has no data (upload first)")
    t = vec.data.detach().to(torch_dtype(vec.mode.vec_dtype))
    if out is not None:
        dst = np.asarray(out).reshape(-1)
        if dst.dtype != vec.mode.vec_dtype or dst.size != t.numel():
            raise BadParametersError(
                f"download buffer holds {dst.size} {dst.dtype}, the "
                f"vector {t.numel()} {vec.mode.vec_dtype}")
        torch.from_numpy(dst).copy_(t)
        return out
    return t.to("cpu", copy=True).numpy()


@_catches(2)
def AMGX_vector_get_size(vec: VectorHandle):
    if vec.data is None:
        return 0, vec.block_dim
    return vec.data.numel() // vec.block_dim, vec.block_dim


@_catches()
def AMGX_vector_bind(vec: VectorHandle, mtx: MatrixHandle):
    """Attach the vector to the matrix's distribution
    (``amgx_c.h:391-393``): the solve shards and unshards the global
    vector itself, so the binding is a record."""
    vec.bound_matrix = mtx
    mtx.bound_vectors.append(vec)


# ------------------------------------------------------------------- solver
@_catches(1)
def AMGX_solver_create(rsrc: ResourcesHandle, mode, cfg: ConfigHandle):
    return SolverHandle(rsrc, mode, cfg)


@_catches()
def AMGX_solver_destroy(slv: SolverHandle):
    slv.solver = None


@_catches()
def AMGX_solver_setup(slv: SolverHandle, mtx: MatrixHandle):
    with _card_lock(mtx):
        slv.solver.setup(mtx.matrix)
    slv.matrix = mtx


@_catches()
def AMGX_solver_resetup(slv: SolverHandle, mtx: MatrixHandle):
    """Values-only refresh after ``AMGX_matrix_replace_coefficients``
    (``Solver.resetup``: nested solvers, the kept hierarchy structure
    and the AMG's CUDA graphs survive)."""
    with _card_lock(mtx):
        if hasattr(slv.solver, "resetup"):
            slv.solver.resetup(mtx.matrix)
        else:
            slv.solver.setup(mtx.matrix)
    slv.matrix = mtx


def _solve(slv: SolverHandle, rhs: VectorHandle, sol: VectorHandle,
           zero: bool):
    if rhs.data is None:
        raise BadParametersError("right-hand side has no data")
    with _card_lock(slv):
        res = slv.solver.solve(rhs.data, x0=None if zero else sol.data,
                               zero_initial_guess=zero)
    slv.last_result = res
    sol.data = res.x


@_catches()
def AMGX_solver_solve(slv: SolverHandle, rhs: VectorHandle,
                      sol: VectorHandle):
    _solve(slv, rhs, sol, zero=False)


@_catches()
def AMGX_solver_solve_with_0_initial_guess(slv: SolverHandle,
                                           rhs: VectorHandle,
                                           sol: VectorHandle):
    _solve(slv, rhs, sol, zero=True)


@_catches(1)
def AMGX_solver_get_iterations_number(slv: SolverHandle):
    return 0 if slv.last_result is None else slv.last_result.iterations


@_catches(1)
def AMGX_solver_get_iteration_residual(slv: SolverHandle, iteration,
                                       idx=0):
    h = slv.last_result.residual_history
    if h is None:
        raise AMGXError("residual history not stored "
                        "(set store_res_history=1)", RC.BAD_PARAMETERS)
    # reference Solver::get_residual(it) indexes m_res_history[it] directly
    # (index 0 = initial residual, i+1 = after iteration i)
    return float(np.atleast_2d(h)[iteration].ravel()[idx])


@_catches(1)
def AMGX_solver_get_status(slv: SolverHandle):
    return (SolveStatus.SUCCESS if slv.last_result is None
            else slv.last_result.status)


@_catches(1)
def AMGX_solver_calculate_residual_norm(slv: SolverHandle,
                                        mtx: MatrixHandle,
                                        rhs: VectorHandle,
                                        sol: VectorHandle):
    """‖b − A·x‖₂ with A·x through the port's SpMV on the matrix's
    pack, the difference and its norm in the vectors' dtype."""
    from .ops.spmv import spmv
    with _card_lock(mtx):
        d = mtx.matrix.device()
        y = spmv(d, sol.data.to(device=d.device, dtype=d.dtype))
        r = rhs.data.to(d.device) - y.to(rhs.data.dtype)
        return float(torch.linalg.vector_norm(r).item())


@_catches(1)
def AMGX_solver_get_setup_time(slv: SolverHandle):
    """Wall seconds of the last ``AMGX_solver_setup``/``_resetup`` —
    the same value the telemetry registry records as
    ``amgx_last_setup_seconds``."""
    return float(getattr(slv.solver, "setup_time", 0.0))


@_catches(1)
def AMGX_solver_get_solve_time(slv: SolverHandle):
    """Wall seconds of the last ``AMGX_solver_solve`` (telemetry gauge
    ``amgx_last_solve_seconds``)."""
    return (0.0 if slv.last_result is None
            else float(slv.last_result.solve_time))


@_catches(1)
def AMGX_solver_get_telemetry_snapshot(slv: SolverHandle):
    """Prometheus text-format snapshot of the telemetry registry (empty
    until a config with ``telemetry=1`` enabled recording)."""
    from . import telemetry
    return telemetry.prometheus_text()


# ----------------------------------------------------------------------- io
def _resolve_rhs(sysdata, mtx: MatrixHandle):
    if sysdata.rhs is not None:
        return sysdata.rhs
    cfg = mtx.rsrc.cfg.cfg
    if int(cfg.get("rhs_from_a")):
        e = np.ones(sysdata.A.shape[0])
        return np.asarray(sysdata.A @ e).ravel()
    return np.ones(sysdata.A.shape[0])


def _host(vec: Optional[VectorHandle]):
    """A vector handle's values as a host array (None without data)."""
    if vec is None or vec.data is None:
        return None
    return vec.data.detach().cpu().numpy()


def _set_system_vectors(rhs, sol, b, x, n, block_dim=1):
    if rhs is not None:
        rhs.data = _to_vector(rhs, b)
        rhs.block_dim = block_dim
    if sol is not None:
        sol.data = _to_vector(sol, x if x is not None else np.zeros(n))
        sol.block_dim = block_dim


def _read_system(mtx: MatrixHandle, rhs: VectorHandle, sol: VectorHandle,
                 path: str):
    dev = mtx.mode.placement_device()
    sysdata = _io.read_system_auto(path)
    mtx.matrix = Matrix(sysdata.A.astype(mtx.mode.mat_dtype),
                        block_dim=sysdata.block_dimx, device=dev)
    _apply_mode_policy(mtx)
    _set_system_vectors(rhs, sol, _resolve_rhs(sysdata, mtx),
                        sysdata.solution, sysdata.A.shape[0],
                        sysdata.block_dimx)


@_catches()
def AMGX_read_system(mtx: MatrixHandle, rhs: VectorHandle,
                     sol: VectorHandle, path: str):
    """``amgx_c.h:441-449``: read A (+rhs/solution when present)."""
    _read_system(mtx, rhs, sol, path)


def _writer(mtx: MatrixHandle):
    writer = str(mtx.rsrc.cfg.cfg.get("matrix_writer"))
    return _io.write_binary if writer == "binary" \
        else _io.write_matrix_market


@_catches()
def AMGX_write_system(mtx: MatrixHandle, rhs: VectorHandle,
                      sol: VectorHandle, path: str):
    _writer(mtx)(path, mtx.matrix.host, rhs=_host(rhs),
                 solution=_host(sol), block_dim=mtx.matrix.block_dim)


@_catches()
def AMGX_read_system_global(mtx: MatrixHandle, rhs: VectorHandle,
                            sol: VectorHandle, path: str,
                            n_parts: int = None, part_offsets=None):
    """Distributed read (``read_system_global``): every rank gets the
    global system; here it is read once and distributed over the
    mode's device."""
    _read_system(mtx, rhs, sol, path)
    _maybe_distribute(mtx, n_parts, part_offsets)


@_catches()
def AMGX_read_system_distributed(mtx: MatrixHandle, rhs: VectorHandle,
                                 sol: VectorHandle, path: str,
                                 allocated_halo_depth=1, num_partitions=1,
                                 partition_sizes=None,
                                 partition_vector=None):
    """``amgx_c.h:464`` / ``distributed_io.cu:182-278``:
    partition-vector-driven read.

    The partition vector assigns each GLOBAL row to a rank (rows need
    not be contiguous); like the reference's
    ``DistributedRead``/renumbering, rows are permuted rank-major
    (stable, preserving in-rank order), each rank receives ITS row block
    (``set_distributed_blocks`` — the global matrix is never the setup
    representation), and the permutation is recorded on the handle so
    ``AMGX_write_system_distributed`` round-trips to the ORIGINAL
    numbering."""
    dev = mtx.mode.placement_device()
    sysdata = _io.read_system_auto(path)
    A = sysdata.A.astype(mtx.mode.mat_dtype)
    b = _resolve_rhs(sysdata, mtx)
    x = sysdata.solution
    mtx._dist_perm = None
    if partition_vector is None and partition_sizes is not None \
            and num_partitions > 1:
        # contiguous-size partitioning (the reference's
        # partition_sizes-without-vector form): synthesize the
        # rank-major partition vector — rows are already contiguous, so
        # the stable renumbering below is the identity
        sizes = np.asarray(partition_sizes, dtype=np.int64)
        if len(sizes) != num_partitions or int(sizes.sum()) != \
                A.shape[0]:
            raise BadParametersError(
                "partition_sizes must list num_partitions row counts "
                "summing to the global row count")
        partition_vector = np.repeat(
            np.arange(num_partitions, dtype=np.int64), sizes)
    if num_partitions > 1 and partition_vector is not None:
        from .distributed.partition import split_row_blocks
        pv = np.asarray(partition_vector)
        order = np.argsort(pv, kind="stable")   # rank-major renumbering
        A = sp.csr_matrix(A)[order][:, order].tocsr()
        b = np.asarray(b)[order]
        if x is not None:
            x = np.asarray(x)[order]
        counts = np.bincount(pv, minlength=num_partitions)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        mtx._dist_perm = order
        m = Matrix(device=dev)
        m.set_distributed_blocks(split_row_blocks(A, offsets), offsets,
                                 _mesh(mtx, num_partitions))
        mtx.matrix = m
    else:
        mtx.matrix = Matrix(A, device=dev)
        _maybe_distribute(mtx, num_partitions, None)
    _apply_mode_policy(mtx)
    _set_system_vectors(rhs, sol, b, x, A.shape[0])


@_catches()
def AMGX_write_system_distributed(mtx: MatrixHandle, rhs: VectorHandle,
                                  sol: VectorHandle, path: str,
                                  allocated_halo_depth=1,
                                  num_partitions=1, partition_sizes=None,
                                  partition_vector_size=0,
                                  partition_vector=None):
    """``amgx_c.h:447`` / ``distributed_io.cu``: gather the per-rank row
    blocks (consolidation — the write-side halo exchange) and write ONE
    system file in the ORIGINAL global numbering: the renumbering
    recorded by the distributed read (or given here as a partition
    vector) is inverted so read→write round-trips byte-for-value."""
    m = mtx.matrix
    A = m.assemble_global() if m.blocks is not None else m.scalar_csr()
    b = _host(rhs)
    x = _host(sol)
    perm = getattr(mtx, "_dist_perm", None)
    if perm is None and partition_vector is not None:
        perm = np.argsort(np.asarray(partition_vector), kind="stable")
    if perm is not None:
        inv = np.argsort(perm)
        A = sp.csr_matrix(A)[inv][:, inv].tocsr()
        if b is not None and len(b) == A.shape[0]:
            b = b[inv]
        if x is not None and len(x) == A.shape[0]:
            x = x[inv]
    _writer(mtx)(path, A, rhs=b, solution=x, block_dim=m.block_dim)


# -------------------------------------------------------------- distributed
@_catches()
def AMGX_matrix_upload_all_global(mtx: MatrixHandle, n_global, n, nnz,
                                  block_dimx, block_dimy, row_ptrs,
                                  col_indices_global, data, diag_data=None,
                                  allocated_halo_depth=1, num_import_rings=1,
                                  partition_vector=None):
    """``amgx_c.h:568-590``: global-index upload + partition vector.

    The reference renumbers and builds B2L maps here
    (``loadDistributedMatrix``); the shard pack does the same at
    ``Matrix.device()`` time.
    """
    _upload_all(mtx, n, nnz, block_dimx, block_dimy, row_ptrs,
                col_indices_global, data, diag_data)
    if partition_vector is not None:
        from .distributed import partition_offsets_from_vector
        pv = np.asarray(partition_vector)
        n_parts = int(pv.max()) + 1
        _maybe_distribute(mtx, n_parts,
                          partition_offsets_from_vector(pv, n_parts))


@_catches()
def AMGX_matrix_upload_distributed(mtx: MatrixHandle, n_global, n, nnz,
                                   block_dimx, block_dimy, row_ptrs,
                                   col_indices_global, data, diag_data,
                                   distribution):
    """``amgx_c.h:592-609`` with an AMGX_distribution handle.

    The reference contract is per-rank: each MPI rank passes its LOCAL
    rows (``n < n_global``) with global column indices.  This embedding
    is single-process, so successive calls with local blocks accumulate
    on the handle until all partitions are uploaded (the global CSR is
    never assembled; the blocks become the shards of one mesh on the
    mode's device); a call with ``n == n_global`` is the whole matrix at
    once.
    """
    n_global = int(n_global)
    n = int(n)
    offsets = None
    if distribution is not None:
        offsets = distribution.get("partition_offsets")
    if n == n_global or offsets is None:
        mtx._pending_blocks = None    # abandon any partial block sequence
        _upload_all(mtx, n, nnz, block_dimx, block_dimy, row_ptrs,
                    col_indices_global, data, diag_data)
        if distribution is not None:
            n_parts = (len(offsets) - 1 if offsets is not None
                       else distribution.get("num_partitions", 1))
            _maybe_distribute(mtx, n_parts, offsets)
        return
    # per-rank block accumulation (AMGX per-rank upload semantics):
    # blocks arrive in rank order, validated against the offsets
    dev = mtx.mode.placement_device()
    if int(block_dimx) != 1 or int(block_dimy) != 1:
        raise BadParametersError(
            "distributed upload currently requires 1x1 blocks")
    offsets = np.asarray(offsets)
    pending = getattr(mtx, "_pending_blocks", None) or []
    rank = len(pending)
    expect = int(offsets[rank + 1] - offsets[rank]) \
        if rank + 1 < len(offsets) else -1
    if n != expect:
        mtx._pending_blocks = None
        raise BadParametersError(
            f"distributed upload out of order: rank {rank} owns {expect} "
            f"rows per the partition offsets, got {n}")
    dtype = mtx.mode.mat_dtype
    block = sp.csr_matrix(
        (np.asarray(data, dtype=dtype).ravel().copy(),
         np.asarray(col_indices_global).copy(),
         np.asarray(row_ptrs).copy()), shape=(n, n_global))
    if diag_data is not None:
        # external-diagonal property: fold the separate diagonal in
        # (upload_all does the same for the global path)
        rows = np.arange(n)
        block = sp.csr_matrix(block + sp.csr_matrix(
            (np.asarray(diag_data, dtype=dtype).ravel(),
             (rows, rows + int(offsets[rank]))), shape=(n, n_global)))
    pending.append(block)
    mtx._pending_blocks = pending
    if len(pending) < len(offsets) - 1:
        return                     # more ranks to come
    n_parts = len(offsets) - 1
    m = Matrix(device=dev)
    if n_parts > 1:
        m.set_distributed_blocks(pending, offsets, _mesh(mtx, n_parts))
    else:
        m.set(sp.vstack(pending).tocsr())
    mtx.matrix = m
    mtx._pending_blocks = None
    _apply_mode_policy(mtx)
    _try_validate_comm_maps(mtx)   # maps may have arrived before upload


@_catches()
def AMGX_matrix_upload_all_global_32(mtx: MatrixHandle, n_global, n, nnz,
                                     block_dimx, block_dimy, row_ptrs,
                                     col_indices_global, data,
                                     diag_data=None,
                                     allocated_halo_depth=1,
                                     num_import_rings=1,
                                     partition_vector=None):
    """``amgx_c.h:568-590`` (32-bit variant): identical contract with
    int32 global column indices — the native width of every device pack
    here, so this simply delegates (the 64-bit entry point accepts any
    integer dtype)."""
    return AMGX_matrix_upload_all_global.__wrapped__(
        mtx, n_global, n, nnz, block_dimx, block_dimy, row_ptrs,
        np.asarray(col_indices_global, dtype=np.int32), data, diag_data,
        allocated_halo_depth, num_import_rings, partition_vector)


@_catches(1)
def AMGX_distribution_create(cfg: ConfigHandle = None):
    return {"partition_offsets": None, "num_partitions": 1,
            "colindices_32bit": False}


@_catches()
def AMGX_distribution_set_partition_data(dist, kind, data):
    dist["partition_offsets"] = np.array(data)
    dist["num_partitions"] = len(data) - 1


@_catches()
def AMGX_distribution_set_32bit_colindices(dist, on):
    """``amgx_c.h:438``: declare 32-bit column indices for the coming
    upload.  Informational here — device packs always use int32 columns
    (``DeviceMatrix`` layout), and the upload path accepts either
    width."""
    dist["colindices_32bit"] = bool(on)


@_catches()
def AMGX_distribution_destroy(dist):
    pass


@_catches()
def AMGX_solver_register_print_callback(fn):
    """``amgx_c.h:396``: solver print-callback registration — the
    reference routes it to the same global print stream as
    ``AMGX_register_print_callback``; so does the port."""
    _register_cb(fn)


@_catches(2)
def AMGX_generate_distributed_poisson_7pt(mtx: MatrixHandle,
                                          rhs: VectorHandle,
                                          sol: VectorHandle,
                                          nx, ny, nz, px=1, py=1, pz=1):
    """``amgx_c.h:515-526`` — built-in distributed Poisson assembly: the
    (px·nx)×(py·ny)×(pz·nz) grid numbered rank by rank, in px·py·pz
    shards on the mode's device."""
    dev = mtx.mode.placement_device()
    A, pv = _io.generate_distributed_poisson_7pt(nx, ny, nz, px, py, pz)
    mtx.matrix = Matrix(A.astype(mtx.mode.mat_dtype), device=dev)
    _apply_mode_policy(mtx)
    n_parts = px * py * pz
    if n_parts > 1:
        from .distributed import partition_offsets_from_vector
        _maybe_distribute(mtx, n_parts,
                          partition_offsets_from_vector(pv, n_parts))
    n = A.shape[0]
    _set_system_vectors(rhs, sol, np.ones(n), None, n)
    return A, pv


# ------------------------------------------------------------------ serving
class ServiceHandle:
    """Opaque handle over a :class:`amgx_tpu_torch.serve.SolveService`
    (an extension of the reference, which has no request-level serving
    layer; its building blocks, ``thread_manager.h`` AsyncTasks and the
    replace-coefficients resetup path, are what the service composes)."""

    def __init__(self, rsrc: ResourcesHandle, mode, cfg: ConfigHandle):
        from .serve import SolveService
        self.rsrc = rsrc
        self.mode = parse_mode(mode)
        self.service = SolveService(cfg.cfg)
        self._tickets = {}
        self._next_ticket = 1
        #: concurrent driver threads submit/wait through one handle —
        #: ticket allocation must not race
        self._lock = threading.Lock()


@_catches(1)
def AMGX_serve_create(rsrc: ResourcesHandle, mode, cfg: ConfigHandle):
    """Start a solve service configured by ``cfg`` (``serve_*`` knobs:
    workers, queue depth, batch window, cache budget, deadlines)."""
    return ServiceHandle(rsrc, mode, cfg)


@_catches(1)
def AMGX_serve_submit(srv: ServiceHandle, mtx: MatrixHandle,
                      rhs: VectorHandle):
    """Queue one solve of ``mtx``'s matrix against ``rhs``; returns an
    integer ticket for :func:`AMGX_serve_wait`.  Over capacity the call
    returns ``RC.REJECTED`` and no ticket — the documented backpressure
    signal (queue bounded by ``serve_queue_depth``)."""
    pending = srv.service.submit(mtx.matrix, rhs.data)
    if pending.rc != RC.OK:
        raise AMGXError(pending.error or "admission rejected", pending.rc)
    with srv._lock:
        ticket = srv._next_ticket
        srv._next_ticket += 1
        srv._tickets[ticket] = pending
    return ticket


@_catches(2)
def AMGX_serve_wait(srv: ServiceHandle, ticket: int,
                    sol: VectorHandle = None, timeout: float = None):
    """Block for a submitted ticket; fills ``sol`` and returns
    ``(rc, status, iterations)``.  A timed-out wait KEEPS the ticket —
    the request is still running and a later wait can still collect
    it (popping here would make a slow solve unrecoverable)."""
    with srv._lock:
        pending = srv._tickets.get(int(ticket))
    if pending is None:
        raise BadParametersError(f"unknown serve ticket {ticket}")
    if not pending.wait_done(timeout):
        raise AMGXError("serve wait timed out; ticket still pending",
                        RC.UNKNOWN)
    with srv._lock:
        srv._tickets.pop(int(ticket), None)
    res = pending.result
    if pending.rc != RC.OK or res is None:
        raise AMGXError(pending.error or "request failed",
                        pending.rc if pending.rc != RC.OK else RC.UNKNOWN)
    if sol is not None:
        sol.data = res.x
    return res.status, res.iterations


@_catches(1)
def AMGX_serve_warmup(srv: ServiceHandle, mtxs):
    """Set up and capture for the given uploaded matrices' patterns off
    the request path (:meth:`SolveService.warmup`), persisted through
    the kernel cache / AOT knobs so the NEXT process starts warm.
    ``mtxs`` is one :class:`MatrixHandle` or a sequence; returns the
    warmup summary dict."""
    handles = mtxs if isinstance(mtxs, (list, tuple)) else [mtxs]
    mats = []
    for h in handles:
        if h.matrix is None:
            raise BadParametersError("warmup matrix not uploaded")
        mats.append(h.matrix)
    return srv.service.warmup(mats)


@_catches(1)
def AMGX_serve_stats(srv: ServiceHandle):
    """Operational snapshot: queue depth, completion/rejection counts,
    latency percentiles, SLO attainment/burn rate, per-phase split,
    cache hit/miss/eviction and per-session setup-reuse counts."""
    return srv.service.stats()


@_catches(1)
def AMGX_serve_endpoint(srv: ServiceHandle, port: int = None):
    """Base URL of the service's observability endpoint
    (``/metrics`` ``/healthz`` ``/statusz`` ``/debug/trace``
    ``/debug/profile`` — telemetry/httpd.py).  Already running when the
    config set ``metrics_port``; passing ``port`` here starts it on
    demand (0 binds an ephemeral port).  Returns None when it is not
    running and no port was given."""
    if port is not None:
        return srv.service.start_endpoint(int(port))
    return srv.service.endpoint


@_catches(1)
def AMGX_serve_health(srv: ServiceHandle):
    """The lane-aware liveness snapshot ``/healthz`` serves: aggregate
    queue/SLO state, ``overloaded`` (true only when EVERY executor
    lane is saturated), and per-lane health entries naming the
    saturated subset."""
    return srv.service.health()


@_catches()
def AMGX_serve_drain(srv: ServiceHandle, timeout: float = None):
    """Stop admission and flush every queued request on every lane
    CONCURRENTLY (new submissions reject with ``RC.REJECTED`` until
    re-created).  On timeout the error message names the wedged
    lane(s); the per-lane report stays readable via
    ``AMGX_serve_stats()['last_drain']``."""
    if not srv.service.drain(timeout):
        stuck = [str(r["lane"]) for r
                 in (srv.service.last_drain or {}).get("lanes", [])
                 if not r.get("ok")]
        raise AMGXError("serve drain timed out on lane(s) "
                        + (",".join(stuck) or "?"), RC.UNKNOWN)


@_catches(1)
def AMGX_serve_drain_lane(srv: ServiceHandle, lane: int,
                          timeout: float = None):
    """Drain ONE executor lane while the service keeps serving (the
    card-eviction path: the router re-routes the lane's patterns).
    Returns the lane's drain report; ``AMGX_serve_resume_lane``
    reopens it."""
    return srv.service.drain_lane(int(lane), timeout)


@_catches()
def AMGX_serve_resume_lane(srv: ServiceHandle, lane: int):
    """Reopen a drained executor lane for admission."""
    srv.service.resume_lane(int(lane))


@_catches()
def AMGX_serve_destroy(srv: ServiceHandle):
    srv.service.shutdown()
    srv._tickets.clear()


# -------------------------------------------------------------- eigensolver
@_catches(1)
def AMGX_eigensolver_create(rsrc: ResourcesHandle, mode,
                            cfg: ConfigHandle):
    return EigenSolverHandle(rsrc, mode, cfg)


@_catches()
def AMGX_eigensolver_setup(es: EigenSolverHandle, mtx: MatrixHandle):
    with _card_lock(mtx):
        es.solver.setup(mtx.matrix)


@_catches()
def AMGX_eigensolver_pagerank_setup(es: EigenSolverHandle,
                                    vec: VectorHandle = None):
    es.solver.pagerank_setup(None if vec is None else _host(vec))


@_catches()
def AMGX_eigensolver_solve(es: EigenSolverHandle, x: VectorHandle):
    with _card_lock(es):
        res = es.solver.solve(x.data if x is not None and x.data is not None
                              else None)
    es.last_result = res
    if x is not None and res.eigenvectors is not None:
        x.data = _to_vector(x, np.asarray(res.eigenvectors)[:, 0])


@_catches()
def AMGX_eigensolver_destroy(es: EigenSolverHandle):
    es.solver = None


# ------------------------------------------------------- error/abort tail
_RC_STRINGS = {
    RC.OK: "No error.",
    RC.BAD_PARAMETERS: "Incorrect parameters to AMGX call.",
    RC.UNKNOWN: "Unknown error.",
    RC.NOT_SUPPORTED_TARGET: "Unsupported target.",
    RC.NOT_SUPPORTED_BLOCKSIZE: "Unsupported block size.",
    RC.CUDA_FAILURE: "Device failure.",
    RC.THRUST_FAILURE: "Device library failure.",
    RC.NO_MEMORY: "Insufficient memory.",
    RC.IO_ERROR: "I/O error.",
    RC.BAD_MODE: "Invalid mode.",
    RC.CORE: "Error initializing amgx core.",
    RC.PLUGIN: "Error initializing plugins.",
    RC.BAD_CONFIGURATION: "Invalid configuration.",
    RC.NOT_IMPLEMENTED: "Not implemented.",
    RC.LICENSE_NOT_FOUND: "License not found.",
    RC.INTERNAL: "Internal error.",
    RC.REJECTED: "Request rejected by serving admission control.",
}


@_catches(1)
def AMGX_get_error_string(err):
    """``amgx_c.h:182-186`` — human-readable RC description."""
    try:
        rc = RC(int(err))
    except ValueError:
        return f"Unknown error code {int(err)}."
    return _RC_STRINGS.get(rc, rc.name.replace("_", " ").capitalize())


def AMGX_abort(rsrc, err):
    """``amgx_c.h:196`` — report and terminate the process (the reference
    aborts the communicator; never returns)."""
    from .utils.logging import amgx_output
    try:
        rc_txt = AMGX_get_error_string(err)
        msg = rc_txt[1] if isinstance(rc_txt, tuple) else str(err)
        amgx_output(f"AMGX_abort: error {int(err)} ({msg})\n")
    finally:
        os._exit(int(err) if err else 1)


# ------------------------------------------- user-supplied halo comm maps
def _record_comm_maps(mtx: MatrixHandle, entry: dict):
    """Accumulate per-rank comm maps (one call per rank, like the per-rank
    upload path) and validate against the matrix's own partition analysis
    once all ranks have reported.

    In this single-process embedding the halo maps are derivable from the
    uploaded blocks, so user maps serve as a cross-check (and let
    reference drivers that supply their own maps run unchanged):
    inconsistent neighbor lists are rejected with BAD_PARAMETERS.
    """
    pend = getattr(mtx, "_pending_comm", None) or []
    pend.append(entry)
    mtx._pending_comm = pend
    _try_validate_comm_maps(mtx)


def _try_validate_comm_maps(mtx: MatrixHandle):
    """Validate accumulated comm maps once both the matrix and a full set
    of per-rank maps exist — re-invoked from the upload completion path
    so maps-before-upload call orders (the reference driver order) also
    validate.  Entries are taken in rank order, matching the per-rank
    upload's enforced ordering."""
    pend = getattr(mtx, "_pending_comm", None)
    m = mtx.matrix
    if not pend or m is None or m.dist is None or m.dist[2] is None:
        return
    n_parts = len(np.asarray(m.dist[2])) - 1
    if len(pend) < n_parts:
        return
    from .distributed.partition import (build_partition,
                                        build_partition_from_blocks)
    if m.blocks is not None:
        part = build_partition_from_blocks(m.blocks, m.block_offsets)
    else:
        part = build_partition(m.scalar_csr(), n_parts,
                               np.asarray(m.dist[2]))
    for p, e in enumerate(pend[-n_parts:]):
        want = set(int(q) for q in part.neighbors[p])
        got = set(int(q) for q in e["neighbors"])
        if not want <= got:
            mtx._pending_comm = None
            raise BadParametersError(
                f"comm maps for rank {p} miss neighbors "
                f"{sorted(want - got)} required by the matrix structure")
    mtx.comm_maps = pend[-n_parts:]
    mtx._pending_comm = None


@_catches()
def AMGX_matrix_comm_from_maps(mtx: MatrixHandle, allocated_halo_depth,
                               num_import_rings, max_num_neighbors,
                               neighbors, send_ptrs, send_maps,
                               recv_ptrs, recv_maps):
    """``amgx_c.h:337-346`` — supply multi-ring halo maps (CSR-style
    per-neighbor pointer arrays)."""
    rings = int(num_import_rings)
    if rings not in (1, 2):
        raise BadParametersError("num_import_rings must be 1 or 2")
    nb = np.asarray(neighbors)[:int(max_num_neighbors)].astype(np.int64)
    sp_ = np.asarray(send_ptrs)
    rp_ = np.asarray(recv_ptrs)
    entry = {
        "rings": rings,
        "neighbors": nb.copy(),
        "send": [np.asarray(send_maps)[sp_[i]:sp_[i + 1]].copy()
                 for i in range(len(nb))],
        "recv": [np.asarray(recv_maps)[rp_[i]:rp_[i + 1]].copy()
                 for i in range(len(nb))],
    }
    _record_comm_maps(mtx, entry)


@_catches()
def AMGX_matrix_comm_from_maps_one_ring(mtx: MatrixHandle,
                                        allocated_halo_depth,
                                        num_neighbors, neighbors,
                                        send_sizes, send_maps,
                                        recv_sizes, recv_maps):
    """``amgx_c.h:348-356`` — one-ring maps with per-neighbor arrays."""
    nn = int(num_neighbors)
    nb = np.asarray(neighbors)[:nn].astype(np.int64)
    entry = {
        "rings": 1,
        "neighbors": nb.copy(),
        "send": [np.asarray(send_maps[i])[:int(send_sizes[i])].copy()
                 for i in range(nn)],
        "recv": [np.asarray(recv_maps[i])[:int(recv_sizes[i])].copy()
                 for i in range(nn)],
    }
    _record_comm_maps(mtx, entry)


@dataclasses.dataclass
class OneRingSystem:
    """One rank's local system + one-ring maps (a plain object, NOT a
    tuple: ``_catches(1)`` splices tuples into the rc return)."""

    n: int
    nnz: int
    block_dimx: int
    block_dimy: int
    row_ptrs: np.ndarray
    col_indices: np.ndarray
    data: np.ndarray
    diag_data: Optional[np.ndarray]
    rhs: np.ndarray
    sol: np.ndarray
    num_neighbors: int
    neighbors: np.ndarray
    send_sizes: np.ndarray
    send_maps: list
    recv_sizes: np.ndarray
    recv_maps: list


@_catches(1)
def AMGX_read_system_maps_one_ring(rsrc: ResourcesHandle, mode, filename,
                                   allocated_halo_depth=1,
                                   num_partitions=1, partition_sizes=None,
                                   partition_vector=None, rank=0):
    """``amgx_c.h:475-499`` — read a system, partition it, and return one
    rank's LOCAL matrix (columns renumbered to [local | halo]) plus its
    one-ring communication maps (host arrays, as the reference returns
    them to the caller).

    The reference infers ``rank`` from the resources' communicator; this
    single-process embedding takes it as an argument (default 0) so a
    driver can loop over ranks.
    """
    mode = parse_mode(mode)
    sysdata = _io.read_system_auto(filename)
    A = sysdata.A.tocsr()
    n_glob = A.shape[0]
    num_partitions = int(num_partitions)
    if partition_vector is not None:
        from .distributed import partition_offsets_from_vector
        offsets = partition_offsets_from_vector(
            np.asarray(partition_vector), num_partitions)
    elif partition_sizes is not None:
        offsets = np.concatenate(
            [[0], np.cumsum(np.asarray(partition_sizes))])
    else:
        nl = -(-n_glob // num_partitions)
        offsets = np.minimum(np.arange(num_partitions + 1) * nl, n_glob)
    from .distributed.partition import build_partition
    part = build_partition(A, num_partitions, offsets)
    r = int(rank)
    lo, hi = int(part.offsets[r]), int(part.offsets[r + 1])
    nl = hi - lo
    sub = sp.csr_matrix(A[lo:hi])
    sub.sort_indices()
    ext = part.halo_global[r]          # sorted global ids of halo rows
    gcols = sub.indices.astype(np.int64)
    local = (gcols >= lo) & (gcols < hi)
    lcols = np.where(local, gcols - lo, 0)
    if len(ext):
        slot = np.minimum(np.searchsorted(ext, gcols), len(ext) - 1)
        lcols = np.where(local, lcols, nl + slot)
    owner = np.zeros(n_glob, dtype=np.int64)
    for p in range(num_partitions):
        owner[part.offsets[p]:part.offsets[p + 1]] = p
    nb = part.neighbors[r]
    send_maps, recv_maps = [], []
    for q in nb:
        # rows of r that q needs (→ q's halo), as r-local ids
        ext_q = part.halo_global[q]
        send = ext_q[owner[ext_q] == r] - lo
        send_maps.append(send.astype(np.int32))
        # r's halo slots owned by q, in r-local [nl..nl+H) numbering
        recv = nl + np.flatnonzero(owner[ext] == q)
        recv_maps.append(recv.astype(np.int32))
    dt = mode.mat_dtype
    rhs_g = (np.asarray(sysdata.rhs) if sysdata.rhs is not None
             else np.ones(n_glob))
    sol_g = (np.asarray(sysdata.solution)
             if sysdata.solution is not None else np.zeros(n_glob))
    return OneRingSystem(
        n=nl, nnz=sub.nnz, block_dimx=1, block_dimy=1,
        row_ptrs=sub.indptr.copy(),
        col_indices=lcols.astype(np.int32), data=sub.data.astype(dt),
        diag_data=None, rhs=rhs_g[lo:hi].astype(mode.vec_dtype),
        sol=sol_g[lo:hi].astype(mode.vec_dtype),
        num_neighbors=len(nb), neighbors=nb.astype(np.int32),
        send_sizes=np.asarray([len(s) for s in send_maps], np.int32),
        send_maps=send_maps,
        recv_sizes=np.asarray([len(s) for s in recv_maps], np.int32),
        recv_maps=recv_maps)


@_catches()
def AMGX_free_system_maps_one_ring(*args, **kwargs):
    """``amgx_c.h:501-513`` — buffers are GC-managed here; no-op."""


__all__ = [n for n in dict(globals()) if n.startswith("AMGX_")]

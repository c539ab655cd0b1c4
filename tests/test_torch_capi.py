"""The port's C API (``amgx_tpu_torch/capi.py``) against the JAX
package's (``amgx_tpu/capi.py``): each flow of tests/test_capi.py runs
through both in host modes on the same inputs, and the RCs, statuses,
iteration counts and error strings must be equal, x and the downloads
within a relative 1e-9 in hDDI and 1e-4 in hDFI/hFFI.  Then the port's
own rules: every ``AMGX_*`` name exported, a device mode without a card
returns the device RC and builds nothing, a mesh over several cards
returns ``NOT_IMPLEMENTED`` (ROADMAP item 8c).  Systems are 16³ or
smaller."""
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from amgx_tpu import capi as jcapi
from amgx_tpu_torch import capi as tcapi
from amgx_tpu_torch.errors import RC, SolveStatus
from amgx_tpu_torch.io import poisson5pt, poisson7pt, write_matrix_market

APIS = {"jax": jcapi, "torch": tcapi}
#: x and download tolerance by mode (relative to the largest entry)
RTOL = {"hDDI": 1e-9, "hDFI": 1e-4, "hFFI": 1e-4}

CONFIG = ("config_version=2, solver(s)=PCG, s:preconditioner(p)=BLOCK_JACOBI,"
          " p:max_iters=3, s:max_iters=200, s:monitor_residual=1, "
          "s:tolerance={tol}, s:convergence=RELATIVE_INI, "
          "s:store_res_history=1")
#: an f32 pack cannot honestly reach 1e-9 without a wider host matrix
TOL = {"hDDI": "1e-9", "hDFI": "1e-5", "hFFI": "1e-5"}

AGG_CFG = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
           "out:monitor_residual=1, out:tolerance=1e-8, "
           "out:convergence=RELATIVE_INI, "
           "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
           "amg:selector=SIZE_2, amg:max_iters=1, "
           "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
           "amg:presweeps=1, amg:postsweeps=2, amg:min_coarse_rows=16, "
           "amg:coarse_solver=DENSE_LU_SOLVER")

PCG_CFG = ("config_version=2, solver(s)=PCG, s:max_iters=200, "
           "s:monitor_residual=1, s:tolerance=1e-8, "
           "s:convergence=RELATIVE_INI")


def _handles(api, config, mode):
    rc, cfg = api.AMGX_config_create(config)
    assert rc == RC.OK
    rc, rsrc = api.AMGX_resources_create_simple(cfg)
    rc, A = api.AMGX_matrix_create(rsrc, mode)
    rc, b = api.AMGX_vector_create(rsrc, mode)
    rc, x = api.AMGX_vector_create(rsrc, mode)
    return cfg, rsrc, A, b, x


def _upload(api, A, M):
    M = sp.csr_matrix(M)
    return int(api.AMGX_matrix_upload_all(A, M.shape[0], M.nnz, 1, 1,
                                          M.indptr, M.indices, M.data))


def _download(api, v):
    rc, out = api.AMGX_vector_download(v)
    assert rc == RC.OK
    return np.asarray(out)


def _same(got: dict, want: dict, rtol: float):
    """Equal keys; arrays within ``rtol`` of the largest entry (in f64:
    the JAX package hands an f32 pack's x back in the pack's dtype, the
    port in the mode's vector dtype, as the native shim does for both),
    every other value equal."""
    assert got.keys() == want.keys(), (got.keys(), want.keys())
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape, (k, g, w)
            g, w = g.astype(np.float64), w.astype(np.float64)
            scale = max(float(np.abs(w).max()), 1e-300)
            assert float(np.abs(g - w).max()) <= rtol * scale, \
                (k, float(np.abs(g - w).max()) / scale)
        elif isinstance(w, float):
            assert g == pytest.approx(w, rel=rtol, abs=1e-300), (k, g, w)
        else:
            assert g == w, (k, g, w)


def _both(flow, *args, rtol=1e-9):
    out = {name: flow(api, *args) for name, api in APIS.items()}
    _same(out["torch"], out["jax"], rtol)
    return out


# ------------------------------------------------------------------ flows
def _full_flow(api, mode):
    r = {"init": int(api.AMGX_initialize())}
    cfg, rsrc, A, b, x = _handles(api, CONFIG.format(tol=TOL[mode]), mode)
    M = sp.csr_matrix(poisson5pt(10, 10))
    r["upload"] = _upload(api, A, M)
    rc, n, bx, by = api.AMGX_matrix_get_size(A)
    r["size"] = (int(rc), n, bx, by)
    rc, nnz = api.AMGX_matrix_get_nnz(A)
    r["nnz"] = (int(rc), nnz)
    r["vec"] = int(api.AMGX_vector_upload(b, 100, 1, np.ones(100)))
    r["zero"] = int(api.AMGX_vector_set_zero(x, 100, 1))
    rc, vn, vb = api.AMGX_vector_get_size(x)
    r["vsize"] = (int(rc), vn, vb)
    rc, solver = api.AMGX_solver_create(rsrc, mode, cfg)
    r["create"] = int(rc)
    r["setup"] = int(api.AMGX_solver_setup(solver, A))
    r["solve"] = int(api.AMGX_solver_solve(solver, b, x))
    rc, status = api.AMGX_solver_get_status(solver)
    r["status"] = (int(rc), int(status))
    rc, iters = api.AMGX_solver_get_iterations_number(solver)
    r["iters"] = (int(rc), iters)
    rc, r0 = api.AMGX_solver_get_iteration_residual(solver, 0)
    r["r0"] = float(r0)
    r["x"] = _download(api, x)
    rc, nrm = api.AMGX_solver_calculate_residual_norm(solver, A, b, x)
    r["nrm_rc"] = int(rc)
    true = np.linalg.norm(np.ones(100) - M @ r["x"].astype(np.float64))
    # the norm through each package's own SpMV, against the f64 host
    # residual of its own x (the pack's rounding for f32 packs)
    assert abs(nrm - true) <= (1e-10 if mode == "hDDI" else 1e-4)
    rc, setup_s = api.AMGX_solver_get_setup_time(solver)
    rc2, solve_s = api.AMGX_solver_get_solve_time(solver)
    r["times"] = (int(rc), int(rc2), setup_s > 0, solve_s > 0)
    for h, d in ((solver, api.AMGX_solver_destroy),
                 (A, api.AMGX_matrix_destroy),
                 (b, api.AMGX_vector_destroy),
                 (x, api.AMGX_vector_destroy),
                 (rsrc, api.AMGX_resources_destroy),
                 (cfg, api.AMGX_config_destroy)):
        r.setdefault("destroy", []).append(int(d(h)))
    r["finalize"] = int(api.AMGX_finalize())
    return r


@pytest.mark.parametrize("mode", ["hDDI", "hDFI", "hFFI"])
def test_full_capi_flow(mode):
    out = _both(_full_flow, mode, rtol=RTOL[mode])
    assert out["torch"]["status"] == (RC.OK, SolveStatus.SUCCESS)
    assert out["torch"]["x"].dtype == np.dtype(
        np.float32 if mode == "hFFI" else np.float64)


def _spmv_flow(api, mode):
    cfg, rsrc, A, b, x = _handles(api, CONFIG.format(tol="1e-9"), mode)
    M = sp.csr_matrix(poisson5pt(6, 6))
    r = {"upload": _upload(api, A, M)}
    v = np.random.default_rng(7).standard_normal(36)
    r["vec"] = int(api.AMGX_vector_upload(b, 36, 1, v))
    r["mv"] = int(api.AMGX_matrix_vector_multiply(A, b, x))
    r["y"] = _download(api, x)
    rc, indptr, indices, data = api.AMGX_matrix_download_all(A)
    r["download"] = (int(rc), indptr.tolist(), indices.tolist())
    r["data"] = np.asarray(data)
    return r


@pytest.mark.parametrize("mode", ["hDDI", "hFFI"])
def test_matrix_vector_multiply_and_download(mode):
    out = _both(_spmv_flow, mode, rtol=RTOL[mode])
    M = sp.csr_matrix(poisson5pt(6, 6))
    v = np.random.default_rng(7).standard_normal(36)
    np.testing.assert_allclose(out["torch"]["y"], M @ v, rtol=RTOL[mode])


def _resetup_flow(api, mode):
    cfg, rsrc, A, b, x = _handles(api, CONFIG.format(tol="1e-9"), mode)
    M = sp.csr_matrix(poisson5pt(9, 9))
    n = M.shape[0]
    r = {"upload": _upload(api, A, M)}
    rc, solver = api.AMGX_solver_create(rsrc, mode, cfg)
    r["setup"] = int(api.AMGX_solver_setup(solver, A))
    api.AMGX_vector_upload(b, n, 1, np.ones(n))
    api.AMGX_vector_set_zero(x, n, 1)
    r["solve0"] = int(api.AMGX_solver_solve(solver, b, x))
    r["replace"] = int(api.AMGX_matrix_replace_coefficients(
        A, n, M.nnz, M.data * 1.7))
    r["resetup"] = int(api.AMGX_solver_resetup(solver, A))
    api.AMGX_vector_set_zero(x, n, 1)
    r["solve"] = int(api.AMGX_solver_solve(solver, b, x))
    r["iters"] = api.AMGX_solver_get_iterations_number(solver)[1]
    r["x"] = _download(api, x)
    # oracle: a fresh solver set up on the new coefficients
    cfg2, rsrc2, A2, b2, x2 = _handles(api, CONFIG.format(tol="1e-9"), mode)
    _upload(api, A2, sp.csr_matrix((M.data * 1.7, M.indices, M.indptr),
                                   shape=M.shape))
    rc, s2 = api.AMGX_solver_create(rsrc2, mode, cfg2)
    api.AMGX_solver_setup(s2, A2)
    api.AMGX_vector_upload(b2, n, 1, np.ones(n))
    api.AMGX_vector_set_zero(x2, n, 1)
    api.AMGX_solver_solve(s2, b2, x2)
    r["fresh_iters"] = api.AMGX_solver_get_iterations_number(s2)[1]
    r["x_fresh"] = _download(api, x2)
    return r


def test_replace_coefficients_and_resetup():
    out = _both(_resetup_flow, "hDDI")["torch"]
    assert out["iters"] == out["fresh_iters"]
    np.testing.assert_allclose(out["x"], out["x_fresh"], rtol=1e-12)
    M = sp.csr_matrix(poisson5pt(9, 9)) * 1.7
    assert np.linalg.norm(np.ones(81) - M @ out["x"]) < 1e-7


def _read_write_flow(api, mode, tmp_path, writer):
    path = str(tmp_path / "sys.mtx")
    M = sp.csr_matrix(poisson5pt(5, 5))
    bb = np.random.default_rng(3).standard_normal(25)
    write_matrix_market(path, M, rhs=bb)
    cfg, rsrc, A, b, x = _handles(
        api, "config_version=2, solver(s)=PCG, "
             f"matrix_writer={writer}", mode)
    r = {"read": int(api.AMGX_read_system(A, b, x, path))}
    r["b"] = _download(api, b)
    r["x0"] = _download(api, x)
    out = str(tmp_path / f"out_{writer}")
    r["write"] = int(api.AMGX_write_system(A, b, x, out))
    cfg2, rsrc2, A2, b2, x2 = _handles(api, "config_version=2", mode)
    r["reread"] = int(api.AMGX_read_system(A2, b2, x2, out))
    r["A"] = np.asarray(A2.matrix.host.toarray())
    r["b2"] = _download(api, b2)
    return r


@pytest.mark.parametrize("writer", ["matrixmarket", "binary"])
def test_read_write_system(tmp_path, writer):
    out = {name: _read_write_flow(api, "hDDI", tmp_path / name, writer)
           for name, api in APIS.items() if
           (tmp_path / name).mkdir() is None}
    _same(out["torch"], out["jax"], 1e-12)
    M = sp.csr_matrix(poisson5pt(5, 5))
    np.testing.assert_allclose(out["torch"]["A"], M.toarray(), atol=1e-14)


def _failures_flow(api):
    r = {}
    rc, cfg = api.AMGX_config_create("config_version=2, cycle=Q")
    r["bad_cfg"] = int(rc)
    rc, cfg = api.AMGX_config_create(CONFIG.format(tol="1e-9"))
    rc, rsrc = api.AMGX_resources_create_simple(cfg)
    rc, A = api.AMGX_matrix_create(rsrc, "dQQQ")
    r["bad_mode"] = int(rc)
    rc, A = api.AMGX_matrix_create(rsrc, "hDDI")
    rc, bad = api.AMGX_matrix_create(None, "hDDI")   # rsrc unused
    r["none_rsrc"] = int(rc)
    r["missing"] = int(api.AMGX_read_system(A, None, None,
                                            "/nonexistent/file.mtx"))
    r["no_history"] = int(api.AMGX_config_create("config_version=2")[0])
    rc, cfg2 = api.AMGX_config_create("config_version=2, solver(s)=PCG")
    rc, s = api.AMGX_solver_create(rsrc, "hDDI", cfg2)
    M = sp.csr_matrix(poisson5pt(4, 4))
    _upload(api, A, M)
    r["block_mismatch"] = int(api.AMGX_matrix_upload_all(
        A, 16, M.nnz, 1, 2, M.indptr, M.indices, M.data))
    r["solve_before_setup"] = int(api.AMGX_solver_solve(s, A, A))
    rc, v = api.AMGX_vector_create(rsrc, "hDDI")
    api.AMGX_vector_upload(v, 16, 1, np.ones(16))
    api.AMGX_solver_setup(s, A)
    api.AMGX_solver_solve(s, v, v)
    rc, h = api.AMGX_solver_get_iteration_residual(s, 0)
    r["history"] = (int(rc), h)
    r["strings"] = [api.AMGX_get_error_string(c) for c in range(18)]
    return r


def test_graceful_failures():
    out = _both(_failures_flow)["torch"]
    assert out["bad_cfg"] == RC.BAD_CONFIGURATION
    assert out["bad_mode"] == RC.BAD_MODE
    assert out["missing"] != RC.OK
    assert out["block_mismatch"] == RC.NOT_SUPPORTED_BLOCKSIZE
    assert out["history"] == (RC.BAD_PARAMETERS, None)


def test_build_info_and_params_description(tmp_path):
    got = {}
    for name, api in APIS.items():
        rc, v1, v2, v3 = api.AMGX_get_build_info_strings()
        assert rc == RC.OK and v1.startswith("amgx_tpu")
        p = str(tmp_path / f"{name}.json")
        rc, text = api.AMGX_write_parameters_description(p)
        assert rc == RC.OK
        got[name] = (api.AMGX_get_api_version(), v2, json.load(open(p)))
    assert "amgx_tpu_torch" in tcapi.AMGX_get_build_info_strings()[1]
    assert got["torch"][:2] == got["jax"][:2]
    # the port's registry carries every parameter the JAX package has
    assert set(got["jax"][2]) <= set(got["torch"][2])
    assert "tolerance" in got["torch"][2]


def _poisson_flow(api, mode):
    cfg, rsrc, A, b, x = _handles(api, AGG_CFG, mode)
    rc, Am, pv = api.AMGX_generate_distributed_poisson_7pt(
        A, b, x, 4, 4, 4, 2, 2, 2)
    r = {"gen": int(rc), "A": Am.toarray(), "pv": pv.tolist()}
    r["bind"] = (int(api.AMGX_vector_bind(b, A)),
                 int(api.AMGX_vector_bind(x, A)))
    r["b"] = _download(api, b)
    rc, solver = api.AMGX_solver_create(rsrc, mode, cfg)
    r["setup"] = int(api.AMGX_solver_setup(solver, A))
    r["solve"] = int(api.AMGX_solver_solve_with_0_initial_guess(
        solver, b, x))
    r["status"] = int(api.AMGX_solver_get_status(solver)[1])
    r["iters"] = api.AMGX_solver_get_iterations_number(solver)[1]
    r["x"] = _download(api, x)
    rc, nrm = api.AMGX_solver_calculate_residual_norm(solver, A, b, x)
    r["nrm"] = (int(rc), nrm < 1e-5)
    return r


def test_generate_poisson_and_distributed_solve():
    out = _both(_poisson_flow, "hDDI")["torch"]
    assert out["status"] == SolveStatus.SUCCESS and out["nrm"][1]


def test_generated_poisson_is_sharded():
    """The port keeps the 8 rank bricks as 8 shards of one mesh on the
    mode's device: its pack is the sharded ELL (kernel B3's interior on
    the card)."""
    cfg, rsrc, A, b, x = _handles(tcapi, AGG_CFG, "hDDI")
    rc, _, _ = tcapi.AMGX_generate_distributed_poisson_7pt(
        A, b, x, 4, 4, 4, 2, 2, 2)
    assert rc == RC.OK
    mesh = A.matrix.dist[0]
    assert mesh.n_parts == 8 and mesh.device.type == "cpu"
    assert A.matrix.device().fmt == "sharded-ell"
    assert b.data.device.type == "cpu" and b.data.dtype == torch.float64


def _eigen_flow(api, mode):
    rc, cfg = api.AMGX_config_create(
        "config_version=2, eig_solver(e)=LANCZOS, e:eig_max_iters=100, "
        "e:eig_tolerance=1e-8, e:eig_wanted_count=1")
    r = {"cfg": int(rc)}
    rc, rsrc = api.AMGX_resources_create_simple(cfg)
    rc, A = api.AMGX_matrix_create(rsrc, mode)
    r["upload"] = _upload(api, A, poisson5pt(8, 7))
    rc, es = api.AMGX_eigensolver_create(rsrc, mode, cfg)
    r["create"] = int(rc)
    r["setup"] = int(api.AMGX_eigensolver_setup(es, A))
    rc, xv = api.AMGX_vector_create(rsrc, mode)
    r["solve"] = int(api.AMGX_eigensolver_solve(es, xv))
    r["lam"] = np.asarray(es.last_result.eigenvalues, dtype=np.float64)
    r["destroy"] = int(api.AMGX_eigensolver_destroy(es))
    return r


def test_eigensolver_capi():
    out = _both(_eigen_flow, "hDDI")["torch"]
    wref = np.linalg.eigvalsh(poisson5pt(8, 7).toarray()).max()
    assert abs(out["lam"][0] - wref) < 1e-5 * wref


def _per_rank_flow(api, mode, n_parts, diag):
    A = sp.csr_matrix(poisson7pt(8, 8, 8) if n_parts == 8
                      else poisson5pt(8, 8))
    n = A.shape[0]
    offsets = np.arange(n_parts + 1) * (n // n_parts)
    rc, cfg = api.AMGX_config_create(PCG_CFG)
    rc, rsrc = api.AMGX_resources_create_simple(cfg)
    rc, mtx = api.AMGX_matrix_create(rsrc, mode)
    rc, dist = api.AMGX_distribution_create(cfg)
    r = {"part": int(api.AMGX_distribution_set_partition_data(
        dist, 0, offsets))}
    src = sp.csr_matrix(A - sp.diags(A.diagonal())) if diag else A
    rcs = []
    for p in range(n_parts):
        blk = sp.csr_matrix(src[offsets[p]:offsets[p + 1]])
        dd = A.diagonal()[offsets[p]:offsets[p + 1]] if diag else None
        rcs.append(int(api.AMGX_matrix_upload_distributed(
            mtx, n, blk.shape[0], blk.nnz, 1, 1, blk.indptr, blk.indices,
            blk.data, dd, dist)))
    r["uploads"] = rcs
    rc, vb = api.AMGX_vector_create(rsrc, mode)
    rc, vx = api.AMGX_vector_create(rsrc, mode)
    api.AMGX_vector_upload(vb, n, 1, np.ones(n))
    api.AMGX_vector_set_zero(vx, n, 1)
    rc, slv = api.AMGX_solver_create(rsrc, mode, cfg)
    r["setup"] = int(api.AMGX_solver_setup(slv, mtx))
    r["solve"] = int(api.AMGX_solver_solve(slv, vb, vx))
    r["iters"] = api.AMGX_solver_get_iterations_number(slv)[1]
    r["x"] = _download(api, vx)
    r["relres_ok"] = bool(np.linalg.norm(np.ones(n) - A @ r["x"])
                          / np.sqrt(n) < 1e-7)
    return r


@pytest.mark.parametrize("n_parts,diag", [(8, False), (4, True)],
                         ids=["blocks_8", "external_diag_4"])
def test_upload_distributed_per_rank_blocks(n_parts, diag):
    out = _both(_per_rank_flow, "hDDI", n_parts, diag)["torch"]
    assert out["uploads"] == [0] * n_parts and out["relres_ok"]


def _out_of_order_flow(api, mode):
    A = sp.csr_matrix(poisson5pt(8, 8))
    rc, cfg = api.AMGX_config_create("config_version=2, solver(s)=PCG")
    rc, rsrc = api.AMGX_resources_create_simple(cfg)
    rc, mtx = api.AMGX_matrix_create(rsrc, mode)
    rc, dist = api.AMGX_distribution_create(cfg)
    api.AMGX_distribution_set_partition_data(
        dist, 0, np.array([0, 16, 32, 48, 64]))
    blk = sp.csr_matrix(A[0:10])
    return {"rc": int(api.AMGX_matrix_upload_distributed(
        mtx, 64, 10, blk.nnz, 1, 1, blk.indptr, blk.indices, blk.data,
        None, dist)), "pending": getattr(mtx, "_pending_blocks", 0)}


def test_upload_distributed_rejects_out_of_order():
    assert _both(_out_of_order_flow, "hDDI")["torch"] == {
        "rc": RC.BAD_PARAMETERS, "pending": None}


def _geometry_flow(api, mode):
    nx, ny, nz = 6, 5, 4
    A = sp.csr_matrix(poisson7pt(nx, ny, nz))
    rc, cfg = api.AMGX_config_create("config_version=2, solver(s)=PCG")
    rc, rsrc = api.AMGX_resources_create_simple(cfg)
    rc, mtx = api.AMGX_matrix_create(rsrc, mode)
    r = {"upload": _upload(api, mtx, A)}
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    r["attach"] = int(api.AMGX_matrix_attach_geometry(
        mtx, x.ravel().astype(float), y.ravel().astype(float),
        z.ravel().astype(float)))
    r["dims"] = mtx.matrix.grid_dims
    # a serpentine order is no regular grid: the dims stay unset
    rc, m2 = api.AMGX_matrix_create(rsrc, mode)
    _upload(api, m2, A)
    xs = x.copy()
    xs[:, 1::2, :] = xs[:, 1::2, ::-1]
    api.AMGX_matrix_attach_geometry(m2, xs.ravel().astype(float),
                                    y.ravel().astype(float),
                                    z.ravel().astype(float))
    r["serpentine_dims"] = getattr(m2.matrix, "grid_dims", None)
    return r


def test_attach_geometry_enables_geo_fast_path():
    out = _both(_geometry_flow, "hDDI")["torch"]
    assert out["dims"] == (4, 5, 6) and out["serpentine_dims"] is None


@pytest.mark.serve
def test_serve_capi_flow():
    def flow(api, mode):
        rc, cfg = api.AMGX_config_create(
            CONFIG.format(tol="1e-9") + ", serve_workers=1, "
            "serve_queue_depth=2, serve_batch_window_ms=1")
        rc, rsrc = api.AMGX_resources_create_simple(cfg)
        rc, A = api.AMGX_matrix_create(rsrc, mode)
        M = sp.csr_matrix(poisson5pt(8, 8))
        n = M.shape[0]
        _upload(api, A, M)
        rc, b = api.AMGX_vector_create(rsrc, mode)
        rc, x = api.AMGX_vector_create(rsrc, mode)
        api.AMGX_vector_upload(b, n, 1, np.ones(n))
        api.AMGX_vector_set_zero(x, n, 1)
        rc, srv = api.AMGX_serve_create(rsrc, mode, cfg)
        r = {"create": int(rc)}
        try:
            rc, ticket = api.AMGX_serve_submit(srv, A, b)
            r["submit"] = (int(rc), ticket)
            rc, status, iters = api.AMGX_serve_wait(srv, ticket, x, 120.0)
            r["wait"] = (int(rc), int(status), iters)
            r["x"] = _download(api, x)
            rc, health = api.AMGX_serve_health(srv)
            r["health"] = int(rc)
            r["unknown"] = int(api.AMGX_serve_wait(srv, 999, x, 1.0)[0])
            r["drain"] = int(api.AMGX_serve_drain(srv, 60.0))
            # after the drain: the JAX package's router counts a batch's
            # completions after its waiters wake
            rc, stats = api.AMGX_serve_stats(srv)
            r["stats"] = (int(rc), stats["completed"],
                          stats["cache"]["misses"])
            rc, t2 = api.AMGX_serve_submit(srv, A, b)
            r["after_drain"] = (int(rc), t2)
        finally:
            r["destroy"] = int(api.AMGX_serve_destroy(srv))
        return r

    out = _both(flow, "hDDI")["torch"]
    assert out["wait"][0] == RC.OK and out["wait"][1] == 0
    assert out["stats"] == (RC.OK, 1, 1)
    assert out["after_drain"] == (RC.REJECTED, None)
    rc, msg = tcapi.AMGX_get_error_string(int(RC.REJECTED))
    assert "rejected" in msg.lower()


@pytest.mark.serve
def test_serve_counts_a_request_before_its_waiter_wakes(monkeypatch):
    """``AMGX_serve_stats`` right after ``AMGX_serve_wait`` counts the
    request: the service counts each answer as it completes, before its
    waiter wakes, not after the router's whole batch (ROADMAP C12; the
    batch's end is held back here to open that window)."""
    import time
    from amgx_tpu_torch.serve import router
    run = router.execute_batch

    def slow_end(*args, **kwargs):
        out = run(*args, **kwargs)
        time.sleep(1.0)
        return out

    monkeypatch.setattr(router, "execute_batch", slow_end)
    cfg, rsrc, A, b, x = _handles(
        tcapi, CONFIG.format(tol="1e-9") + ", serve_workers=1", "hDDI")
    M = sp.csr_matrix(poisson5pt(6, 6))
    _upload(tcapi, A, M)
    tcapi.AMGX_vector_upload(b, 36, 1, np.ones(36))
    rc, srv = tcapi.AMGX_serve_create(rsrc, "hDDI", cfg)
    try:
        rc, ticket = tcapi.AMGX_serve_submit(srv, A, b)
        assert tcapi.AMGX_serve_wait(srv, ticket, x, 60.0)[0] == RC.OK
        rc, stats = tcapi.AMGX_serve_stats(srv)
        assert (rc, stats["completed"]) == (RC.OK, 1), stats["completed"]
    finally:
        assert tcapi.AMGX_serve_destroy(srv) == RC.OK


def _tail_flow(api, mode):
    A = sp.csr_matrix(poisson5pt(8, 8))
    n = A.shape[0]
    rc, cfg = api.AMGX_config_create(
        "config_version=2, solver(out)=PCG, out:max_iters=100, "
        "out:monitor_residual=1, out:tolerance=1e-8, "
        "out:convergence=RELATIVE_INI, "
        "out:preconditioner(pre)=BLOCK_JACOBI, pre:max_iters=1")
    rc, rsrc = api.AMGX_resources_create_simple(cfg)
    rc, mtx = api.AMGX_matrix_create(rsrc, mode)
    r = {"g32": int(api.AMGX_matrix_upload_all_global_32(
        mtx, n, n, A.nnz, 1, 1, A.indptr, A.indices.astype(np.int32),
        A.data)), "shape": tuple(mtx.matrix.shape)}
    rc, dist = api.AMGX_distribution_create(cfg)
    r["dist"] = (int(rc),
                 int(api.AMGX_distribution_set_32bit_colindices(dist, True)),
                 dist["colindices_32bit"],
                 int(api.AMGX_distribution_destroy(dist)))
    rc, rings = api.AMGX_config_get_default_number_of_rings(cfg)
    r["rings"] = (int(rc), rings)
    lines = []
    r["cb"] = int(api.AMGX_solver_register_print_callback(lines.append))
    pkg = __import__(api.__name__.split(".")[0])
    pkg.amgx_output("print-callback probe\n")
    pkg.register_print_callback(None)
    r["printed"] = any("print-callback probe" in ln for ln in lines)
    # user comm maps of a 4-rank global upload: a full neighbour set
    # validates, a missing neighbour is refused
    rc, m4 = api.AMGX_matrix_create(rsrc, mode)
    pv = np.repeat(np.arange(4), 16)
    api.AMGX_matrix_upload_all_global(m4, n, n, A.nnz, 1, 1, A.indptr,
                                      A.indices, A.data, None, 1, 1, pv)
    maps = []
    for p in range(4):
        nb = [q for q in (p - 1, p + 1) if 0 <= q < 4]
        maps.append(int(api.AMGX_matrix_comm_from_maps_one_ring(
            m4, 1, len(nb), np.asarray(nb, np.int32),
            np.zeros(len(nb), np.int32), [np.zeros(0, np.int32)] * len(nb),
            np.zeros(len(nb), np.int32),
            [np.zeros(0, np.int32)] * len(nb))))
    r["maps"] = maps
    r["validated"] = len(getattr(m4, "comm_maps", []))
    bad = []
    for p in range(4):
        bad.append(int(api.AMGX_matrix_comm_from_maps(
            m4, 1, 1, 0, np.zeros(0, np.int32), np.zeros(1, np.int32),
            np.zeros(0, np.int32), np.zeros(1, np.int32),
            np.zeros(0, np.int32))))
    r["bad_maps"] = bad
    r["rings_bad"] = int(api.AMGX_matrix_comm_from_maps(
        m4, 1, 3, 0, np.zeros(0, np.int32), np.zeros(1, np.int32),
        np.zeros(0, np.int32), np.zeros(1, np.int32),
        np.zeros(0, np.int32)))
    r["free"] = int(api.AMGX_free_system_maps_one_ring())
    r["pin"] = (int(api.AMGX_pin_memory(np.zeros(4))),
                int(api.AMGX_unpin_memory(np.zeros(4))))
    r["signals"] = (int(api.AMGX_install_signal_handler()),
                    int(api.AMGX_reset_signal_handler()))
    return r


def test_capi_tail_functions():
    out = _both(_tail_flow, "hDDI")["torch"]
    assert out["g32"] == RC.OK and out["shape"] == (64, 64)
    assert out["printed"] and out["validated"] == 4
    assert out["bad_maps"][-1] == RC.BAD_PARAMETERS


def _one_ring_flow(api, mode, path):
    out = {}
    for r_ in range(3):
        rc, ring = api.AMGX_read_system_maps_one_ring(
            None, mode, path, 1, 3, rank=r_)
        out[r_] = (int(rc), ring.n, ring.nnz, ring.neighbors.tolist(),
                   [s.tolist() for s in ring.send_maps],
                   [s.tolist() for s in ring.recv_maps],
                   ring.col_indices.tolist())
    return out


def test_read_system_maps_one_ring(tmp_path):
    path = str(tmp_path / "p.mtx")
    write_matrix_market(path, poisson5pt(6, 5), rhs=np.ones(30))
    _both(_one_ring_flow, "hDDI", path)


def _dist_read_write_flow(api, mode, tmp_path):
    path = str(tmp_path / "in.mtx")
    M = sp.csr_matrix(poisson5pt(6, 6))
    write_matrix_market(path, M, rhs=np.arange(36.0))
    rc, cfg = api.AMGX_config_create(PCG_CFG)
    rc, rsrc = api.AMGX_resources_create_simple(cfg)
    rc, A = api.AMGX_matrix_create(rsrc, mode)
    rc, b = api.AMGX_vector_create(rsrc, mode)
    rc, x = api.AMGX_vector_create(rsrc, mode)
    pv = np.arange(36) % 4
    r = {"read": int(api.AMGX_read_system_distributed(
        A, b, x, path, 1, 4, None, pv))}
    rc, solver = api.AMGX_solver_create(rsrc, mode, cfg)
    r["setup"] = int(api.AMGX_solver_setup(solver, A))
    r["solve"] = int(api.AMGX_solver_solve(solver, b, x))
    r["iters"] = api.AMGX_solver_get_iterations_number(solver)[1]
    out = str(tmp_path / "out.mtx")
    r["write"] = int(api.AMGX_write_system_distributed(A, b, x, out))
    rc, A2 = api.AMGX_matrix_create(rsrc, mode)
    rc, b2 = api.AMGX_vector_create(rsrc, mode)
    api.AMGX_read_system(A2, b2, None, out)
    r["A"] = np.asarray(A2.matrix.host.toarray())
    r["b"] = _download(api, b2)
    rc, A3 = api.AMGX_matrix_create(rsrc, mode)
    r["global"] = int(api.AMGX_read_system_global(A3, None, None, path, 4))
    return r


def test_read_write_system_distributed(tmp_path):
    out = {name: _dist_read_write_flow(api, "hDDI", tmp_path / name)
           for name, api in APIS.items() if
           (tmp_path / name).mkdir() is None}
    _same(out["torch"], out["jax"], 1e-9)
    # the round trip restores the original numbering
    M = sp.csr_matrix(poisson5pt(6, 6))
    np.testing.assert_allclose(out["torch"]["A"], M.toarray())
    np.testing.assert_allclose(out["torch"]["b"], np.arange(36.0))


# ------------------------------------------------------ the port's own rules
def test_exports_every_amgx_name():
    jnames = {n for n in dir(jcapi) if n.startswith("AMGX_")}
    tnames = {n for n in dir(tcapi) if n.startswith("AMGX_")}
    assert jnames == tnames
    assert set(jcapi.__all__) == set(tcapi.__all__) == tnames


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_mode_without_card_returns_device_rc(no_card, tmp_path):
    """A ``d…`` mode with no card returns ``CUDA_FAILURE`` and builds
    nothing on the CPU instead."""
    M = sp.csr_matrix(poisson5pt(4, 4))
    cfg, rsrc, A, b, x = _handles(tcapi, CONFIG.format(tol="1e-9"), "dDDI")
    assert _upload(tcapi, A, M) == RC.CUDA_FAILURE
    assert A.matrix is None
    assert tcapi.AMGX_vector_upload(b, 16, 1, np.ones(16)) == \
        RC.CUDA_FAILURE
    assert tcapi.AMGX_vector_set_zero(x, 16, 1) == RC.CUDA_FAILURE
    assert b.data is None and x.data is None
    rc, _, _ = tcapi.AMGX_generate_distributed_poisson_7pt(
        A, b, x, 2, 2, 2, 2, 1, 1)
    assert rc == RC.CUDA_FAILURE and A.matrix is None
    path = str(tmp_path / "s.mtx")
    write_matrix_market(path, M, rhs=np.ones(16))
    assert tcapi.AMGX_read_system(A, b, x, path) == RC.CUDA_FAILURE
    assert A.matrix is None and b.data is None
    rc, msg = tcapi.AMGX_get_error_string(int(RC.CUDA_FAILURE))
    assert msg == "Device failure."


def test_mesh_over_several_cards_is_item_8c(monkeypatch):
    """Resources over two cards ask for a mesh across devices: the
    distributed upload returns ``NOT_IMPLEMENTED`` instead of running
    every shard on one device."""
    from amgx_tpu_torch.modes import Mode
    monkeypatch.setattr(Mode, "placement_device",
                        lambda self: torch.device("cpu"))
    rc, cfg = tcapi.AMGX_config_create(PCG_CFG)
    rc, rsrc = tcapi.AMGX_resources_create(cfg, None, 0, [0, 1])
    assert rc == RC.OK and rsrc.devices == [0, 1]
    rc, A = tcapi.AMGX_matrix_create(rsrc, "dDDI")
    rc, _, _ = tcapi.AMGX_generate_distributed_poisson_7pt(
        A, None, None, 2, 2, 2, 2, 1, 1)
    assert rc == RC.NOT_IMPLEMENTED


def test_device_error_keeps_its_rc():
    from amgx_tpu_torch.errors import DeviceError

    @tcapi._catches(1)
    def boom():
        raise DeviceError("no card")

    @tcapi._catches()
    def other():
        raise ValueError("x")

    assert boom() == (RC.CUDA_FAILURE, None)
    assert other() == RC.UNKNOWN


def test_vector_download_into_caller_buffer():
    """The native shim's download path: the vector lands in the caller's
    buffer; a buffer of the wrong size or dtype is refused."""
    cfg, rsrc, A, b, x = _handles(tcapi, "config_version=2", "hDDI")
    v = np.random.default_rng(1).standard_normal(10)
    tcapi.AMGX_vector_upload(b, 10, 1, v)
    v[:] = 0                      # the upload copied the caller's data
    buf = np.full(10, -1.0)
    rc, out = tcapi.AMGX_vector_download(b, buf)
    assert rc == RC.OK and out is buf
    np.testing.assert_array_equal(
        buf, np.random.default_rng(1).standard_normal(10))
    assert tcapi.AMGX_vector_download(b, np.zeros(9))[0] == \
        RC.BAD_PARAMETERS
    assert tcapi.AMGX_vector_download(
        b, np.zeros(10, np.float32))[0] == RC.BAD_PARAMETERS


def test_refined_solve_keeps_tensor_vectors_on_their_device(monkeypatch):
    """The f32 → f64 refinement (dDDI's pack under an f64 host matrix)
    splits b and x0 into a pack-dtype part and a residue on the pack's
    device: a tensor right-hand side or guess never becomes a numpy
    array (the C API keeps its vectors on the card, so upload → solve →
    download copies once each way; ROADMAP C11).  The bits are those of
    the same solve from numpy arrays."""
    import amgx_tpu_torch as amgx
    A = poisson7pt(8, 8, 8)
    n = A.shape[0]
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = np.float32
    slv = amgx.create_solver(CONFIG.format(tol="1e-9"))
    slv.setup(m)
    b = np.random.default_rng(5).standard_normal(n)
    x0 = np.full(n, 0.25)
    ref = slv.solve(b, x0=x0)
    seen = []
    numpy = torch.Tensor.numpy

    def spy(self, *args, **kwargs):
        seen.append(self.numel())
        return numpy(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "numpy", spy)
    res = slv.solve(torch.from_numpy(b), x0=torch.from_numpy(x0))
    monkeypatch.undo()
    assert not [k for k in seen if k >= n], seen
    assert res.iterations == ref.iterations > 0
    assert torch.equal(res.x, ref.x)


def _extras_flow(api, mode, tmp_path):
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        f.write('{"config_version": 2, "solver": {"solver": "AMG", '
                '"algorithm": "AGGREGATION", "max_iters": 7}}')
    rc, cfg = api.AMGX_config_create_from_file_and_string(
        path, "tolerance=1e-6")
    r = {"from_file": int(rc),
         "rings": tuple(api.AMGX_config_get_default_number_of_rings(cfg))}
    r["add"] = int(api.AMGX_config_add_parameters(cfg, "max_iters=9"))
    r["bad_add"] = int(api.AMGX_config_add_parameters(cfg, "cycle=Q"))
    r["file_only"] = int(api.AMGX_config_create_from_file(path)[0])
    r["missing_file"] = int(api.AMGX_config_create_from_file(
        str(tmp_path / "none.json"))[0])
    rc, rsrc = api.AMGX_resources_create(cfg, None, 0, None)
    rc, M = api.AMGX_matrix_create(rsrc, mode)
    _upload(api, M, poisson5pt(4, 4))
    colors = np.arange(16, dtype=np.int32) % 2
    r["coloring"] = int(api.AMGX_matrix_attach_coloring(M, colors, 16, 2))
    r["colors"] = (M.matrix.coloring.num_colors,
                   np.asarray(M.matrix.coloring.colors).tolist())
    r["separation"] = int(api.AMGX_matrix_set_boundary_separation(M, 1))
    rc, v = api.AMGX_vector_create(rsrc, mode)
    r["random"] = int(api.AMGX_vector_set_random(v, 16))
    r["size"] = tuple(int(k) for k in api.AMGX_vector_get_size(v))
    r["unset_size"] = tuple(int(k) for k in api.AMGX_vector_get_size(
        api.AMGX_vector_create(rsrc, mode)[1]))
    rc, s = api.AMGX_solver_create(rsrc, mode, cfg)
    rc, snap = api.AMGX_solver_get_telemetry_snapshot(s)
    r["snapshot"] = (int(rc), isinstance(snap, str))
    r["fresh"] = (tuple(int(k) for k in api.AMGX_solver_get_status(s)),
                  tuple(api.AMGX_solver_get_iterations_number(s)),
                  tuple(api.AMGX_solver_get_solve_time(s)))
    r["lifecycle"] = [int(f()) for f in (
        api.AMGX_initialize_plugins, api.AMGX_finalize_plugins)]
    return r


def test_config_coloring_and_vector_extras(tmp_path):
    out = {name: _extras_flow(api, "hDDI", tmp_path / name)
           for name, api in APIS.items() if
           (tmp_path / name).mkdir() is None}
    _same(out["torch"], out["jax"], 0.0)
    assert out["torch"]["size"] == (RC.OK, 16, 1)

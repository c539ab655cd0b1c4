/* amgx_c_shim.cpp — the port's native implementation of the AMGX C ABI.
 *
 * Exports real C symbols (AMGX_initialize, AMGX_solver_solve, ...) from
 * libamgx_torch_c.so by embedding the CPython interpreter and delegating
 * to amgx_tpu_torch.capi, which runs on the CUDA card for d… modes and
 * on the CPU for h… modes.  Drivers written against native/amgx_tpu_c.h
 * link against this library unchanged.  Built without cmake by
 * build.py, which passes:
 *   AMGX_TORCH_PYTHON — the interpreter the library was built for (its
 *                       prefix and site-packages become the embedded
 *                       interpreter's; env AMGX_TORCH_PYTHON overrides);
 *   AMGX_TORCH_ROOT   — the checkout holding amgx_tpu_torch, put first on
 *                       sys.path (env AMGX_TORCH_ROOT overrides).
 *
 * Array arguments cross the boundary as numpy views of the caller's
 * buffers (the Python side copies on upload, preserving AMGX's
 * caller-owns-memory contract; a download copies the device vector
 * straight into the caller's buffer).  The interpreter releases the GIL
 * once started, so driver threads may call in concurrently; every call
 * takes the GIL for its duration.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

#include "amgx_tpu_c.h"
#include "amgx_torch_c_ext.h"

#ifndef AMGX_TORCH_PYTHON
#define AMGX_TORCH_PYTHON "python3"
#endif
#ifndef AMGX_TORCH_ROOT
#define AMGX_TORCH_ROOT ""
#endif

namespace {

std::mutex g_init_mutex;
PyObject *g_capi = nullptr;        /* amgx_tpu_torch.capi module */
AMGX_RC g_init_rc = AMGX_RC_OK;    /* a failed start is not retried */
bool g_init_tried = false;
AMGX_print_callback g_print_cb = nullptr;

struct Handle {
    PyObject *obj;
};

struct Gil {
    PyGILState_STATE st;
    Gil() { st = PyGILState_Ensure(); }
    ~Gil() { PyGILState_Release(st); }
};

const char *mode_name(AMGX_Mode m) {
    static const char *names[] = {"hDDI", "hDFI", "hFFI", "dDDI", "dDFI",
                                  "dFFI", "hZZI", "hZCI", "hCCI", "dZZI",
                                  "dZCI", "dCCI"};
    if (m < 0 || m > 11) return "dDDI";
    return names[m];
}

const char *env_or(const char *name, const char *fallback) {
    const char *v = std::getenv(name);
    return (v && *v) ? v : fallback;
}

/* start the interpreter (when the process has none), put the checkout
 * on sys.path, import numpy's C API and amgx_tpu_torch.capi; the GIL is
 * released afterwards when this library started the interpreter */
AMGX_RC start() {
    bool started_here = false;
    if (!Py_IsInitialized()) {
        PyConfig config;
        PyConfig_InitPythonConfig(&config);
        config.install_signal_handlers = 0;
        PyStatus st = PyConfig_SetBytesString(
            &config, &config.program_name,
            env_or("AMGX_TORCH_PYTHON", AMGX_TORCH_PYTHON));
        if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
        PyConfig_Clear(&config);
        if (PyStatus_Exception(st)) {
            std::fprintf(stderr, "amgx_torch_c: cannot start Python: %s\n",
                         st.err_msg ? st.err_msg : "?");
            return AMGX_RC_CORE;
        }
        started_here = true;
    }
    AMGX_RC rc = AMGX_RC_OK;
    {
        Gil gil;
        const char *root = env_or("AMGX_TORCH_ROOT", AMGX_TORCH_ROOT);
        PyObject *path = PySys_GetObject("path");          /* borrowed */
        if (*root && path) {
            PyObject *r = PyUnicode_DecodeFSDefault(root);
            if (r && PySequence_Contains(path, r) == 0)
                PyList_Insert(path, 0, r);
            Py_XDECREF(r);
        }
        if (_import_array() < 0) {
            PyErr_Print();
            rc = AMGX_RC_INTERNAL;
        } else {
            PyObject *mod = PyImport_ImportModule("amgx_tpu_torch.capi");
            if (!mod) {
                PyErr_Print();
                rc = AMGX_RC_PLUGIN;
            } else {
                g_capi = mod;
            }
        }
    }
    if (started_here) PyEval_SaveThread();
    return rc;
}

AMGX_RC ensure_init() {
    std::lock_guard<std::mutex> lk(g_init_mutex);
    if (!g_init_tried) {
        g_init_tried = true;
        g_init_rc = start();
    }
    return g_init_rc;
}

/* call capi.<name>(*args); steals ``args``; returns a new ref or null */
PyObject *call(const char *name, PyObject *args) {
    if (!args) {
        PyErr_Print();
        return nullptr;
    }
    PyObject *fn = PyObject_GetAttrString(g_capi, name);
    if (!fn) {
        PyErr_Print();
        Py_DECREF(args);
        return nullptr;
    }
    PyObject *out = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    Py_DECREF(args);
    if (!out) PyErr_Print();
    return out;
}

/* result is either an int RC, or a tuple (rc, out0, out1, ...); the
 * outputs come back as new references */
AMGX_RC unpack_rc(PyObject *out, std::vector<PyObject *> *outputs = nullptr) {
    if (!out) return AMGX_RC_UNKNOWN;
    AMGX_RC rc = AMGX_RC_UNKNOWN;
    if (PyTuple_Check(out)) {
        rc = (AMGX_RC)PyLong_AsLong(PyTuple_GetItem(out, 0));
        if (outputs) {
            for (Py_ssize_t i = 1; i < PyTuple_Size(out); ++i) {
                PyObject *o = PyTuple_GetItem(out, i);
                Py_INCREF(o);
                outputs->push_back(o);
            }
        }
    } else if (PyLong_Check(out)) {
        rc = (AMGX_RC)PyLong_AsLong(out);
    }
    Py_DECREF(out);
    return rc;
}

void release(std::vector<PyObject *> &outs) {
    for (auto *o : outs) Py_DECREF(o);
    outs.clear();
}

/* a handle's object as a borrowed reference (None for a null handle) */
PyObject *B(void *handle) {
    return handle ? static_cast<Handle *>(handle)->obj : Py_None;
}

/* call, and on success store the first output as a new handle */
AMGX_RC create(void **out_handle, const char *name, PyObject *args) {
    std::vector<PyObject *> outs;
    AMGX_RC rc = unpack_rc(call(name, args), &outs);
    if (rc == AMGX_RC_OK && !outs.empty() && out_handle) {
        *out_handle = new Handle{outs[0]};
        outs.erase(outs.begin());
    }
    release(outs);
    return rc;
}

void drop(void *handle) {
    if (!handle) return;
    Handle *h = static_cast<Handle *>(handle);
    {
        Gil gil;
        Py_XDECREF(h->obj);
    }
    delete h;
}

/* a 1-d numpy view of a caller's buffer (None for a null pointer) */
PyObject *np_view(const void *data, npy_intp n, int typenum) {
    if (!data) Py_RETURN_NONE;
    return PyArray_SimpleNewFromData(1, &n, typenum,
                                     const_cast<void *>(data));
}

/* numpy typenum of a dtype attribute of the handle's mode: the byte
 * width of caller buffers depends on it */
int handle_mode_typenum(void *handle, const char *dtype_attr) {
    PyObject *mode_obj = PyObject_GetAttrString(B(handle), "mode");
    PyObject *vd =
        mode_obj ? PyObject_GetAttrString(mode_obj, dtype_attr) : nullptr;
    int tn = NPY_FLOAT64;
    if (vd) {
        PyArray_Descr *descr = nullptr;
        if (PyArray_DescrConverter(vd, &descr) && descr) {
            tn = descr->type_num;
            Py_DECREF(descr);
        }
        Py_DECREF(vd);
    }
    Py_XDECREF(mode_obj);
    PyErr_Clear();
    return tn;
}

long output_long(PyObject *o) { return o ? PyLong_AsLong(o) : 0; }

/* the C print callback, seen from Python as fn(msg) */
PyObject *print_trampoline(PyObject *, PyObject *args) {
    const char *s = nullptr;
    Py_ssize_t len = 0;
    if (!PyArg_ParseTuple(args, "s#", &s, &len)) return nullptr;
    AMGX_print_callback cb = g_print_cb;
    if (cb) {
        Py_BEGIN_ALLOW_THREADS
        cb(s, (int)len);
        Py_END_ALLOW_THREADS
    }
    Py_RETURN_NONE;
}

PyMethodDef g_print_def = {"amgx_print_callback", print_trampoline,
                           METH_VARARGS, nullptr};

#define INIT_OR_RETURN()                                                  \
    do {                                                                  \
        AMGX_RC irc_ = ensure_init();                                     \
        if (irc_ != AMGX_RC_OK) return irc_;                              \
    } while (0)

/* the single-output getters: fn(handle) -> (rc, value) */
template <typename T, typename F>
AMGX_RC get_one(const char *name, void *handle, T *dst, F convert) {
    INIT_OR_RETURN();
    Gil gil;
    std::vector<PyObject *> outs;
    AMGX_RC rc = unpack_rc(call(name, Py_BuildValue("(O)", B(handle))),
                           &outs);
    if (rc == AMGX_RC_OK && !outs.empty() && dst) *dst = convert(outs[0]);
    release(outs);
    return rc;
}

AMGX_RC simple(const char *name, PyObject *args) {
    return unpack_rc(call(name, args));
}

}  // namespace

extern "C" {

unsigned long long amgx_torch_fnv1a64(const void *data, size_t n) {
    const unsigned char *p = static_cast<const unsigned char *>(data);
    unsigned long long h = 14695981039346656037ULL;
    for (size_t i = 0; i < n; ++i) {
        h ^= p[i];
        h *= 1099511628211ULL;
    }
    return h;
}

AMGX_RC AMGX_initialize(void) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_initialize", PyTuple_New(0));
}

AMGX_RC AMGX_initialize_plugins(void) { return AMGX_RC_OK; }
AMGX_RC AMGX_finalize_plugins(void) { return AMGX_RC_OK; }

AMGX_RC AMGX_finalize(void) {
    if (!g_capi) return AMGX_RC_OK;
    Gil gil;
    return simple("AMGX_finalize", PyTuple_New(0));
}

AMGX_RC AMGX_get_error_string(AMGX_RC err, char *buf, int buf_len) {
    /* pure-C table: usable before initialization, as the reference's
       AMGX_SAFE_CALL error macro requires (amgx_c.h:160-165) */
    const char *msg;
    switch ((int)err) {
        case AMGX_RC_OK: msg = "No error."; break;
        case AMGX_RC_BAD_PARAMETERS:
            msg = "Incorrect parameters to AMGX call."; break;
        case AMGX_RC_UNKNOWN: msg = "Unknown error."; break;
        case AMGX_RC_NOT_SUPPORTED_TARGET:
            msg = "Unsupported target."; break;
        case AMGX_RC_NOT_SUPPORTED_BLOCKSIZE:
            msg = "Unsupported block size."; break;
        case AMGX_RC_CUDA_FAILURE: msg = "Device failure."; break;
        case AMGX_RC_THRUST_FAILURE:
            msg = "Device library failure."; break;
        case AMGX_RC_NO_MEMORY: msg = "Insufficient memory."; break;
        case AMGX_RC_IO_ERROR: msg = "I/O error."; break;
        case AMGX_RC_BAD_MODE: msg = "Invalid mode."; break;
        case AMGX_RC_CORE: msg = "Error initializing amgx core."; break;
        case AMGX_RC_PLUGIN: msg = "Error initializing plugins."; break;
        case AMGX_RC_BAD_CONFIGURATION:
            msg = "Invalid configuration."; break;
        case AMGX_RC_NOT_IMPLEMENTED: msg = "Not implemented."; break;
        case AMGX_RC_LICENSE_NOT_FOUND: msg = "License not found."; break;
        case AMGX_RC_INTERNAL: msg = "Internal error."; break;
        case 16: msg = "Request rejected by serving admission control.";
            break;
        default: msg = "Unknown error code."; break;
    }
    if (!buf || buf_len <= 0) return AMGX_RC_BAD_PARAMETERS;
    std::snprintf(buf, (size_t)buf_len, "%s", msg);
    return AMGX_RC_OK;
}

void AMGX_abort(AMGX_resources_handle, int err) {
    std::fprintf(stderr, "AMGX_abort: error %d\n", err);
    std::fflush(stderr);
    std::exit(err ? err : 1);
}

AMGX_RC AMGX_get_api_version(int *major, int *minor) {
    if (major) *major = 2;
    if (minor) *minor = 0;
    return AMGX_RC_OK;
}

AMGX_RC AMGX_pin_memory(void *, unsigned int) { return AMGX_RC_OK; }
AMGX_RC AMGX_unpin_memory(void *) { return AMGX_RC_OK; }

AMGX_RC AMGX_install_signal_handler(void) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_install_signal_handler", PyTuple_New(0));
}

AMGX_RC AMGX_reset_signal_handler(void) {
    if (!g_capi) return AMGX_RC_OK;
    Gil gil;
    return simple("AMGX_reset_signal_handler", PyTuple_New(0));
}

AMGX_RC AMGX_register_print_callback(AMGX_print_callback callback) {
    INIT_OR_RETURN();
    Gil gil;
    g_print_cb = callback;
    PyObject *fn = callback ? PyCFunction_New(&g_print_def, nullptr)
                            : (Py_INCREF(Py_None), Py_None);
    if (!fn) {
        PyErr_Print();
        return AMGX_RC_INTERNAL;
    }
    AMGX_RC rc = simple("AMGX_register_print_callback",
                        Py_BuildValue("(O)", fn));
    Py_DECREF(fn);
    return rc;
}

AMGX_RC AMGX_solver_register_print_callback(AMGX_print_callback callback) {
    /* amgx_c.h:396: the reference routes solver prints to the same
       global stream as AMGX_register_print_callback */
    return AMGX_register_print_callback(callback);
}

/* ------------------------------------------------------------- config */
AMGX_RC AMGX_config_create(AMGX_config_handle *cfg, const char *options) {
    INIT_OR_RETURN();
    Gil gil;
    return create(cfg, "AMGX_config_create",
                  Py_BuildValue("(s)", options ? options : ""));
}

AMGX_RC AMGX_config_create_from_file(AMGX_config_handle *cfg,
                                     const char *param_file) {
    INIT_OR_RETURN();
    Gil gil;
    return create(cfg, "AMGX_config_create_from_file",
                  Py_BuildValue("(s)", param_file));
}

AMGX_RC AMGX_config_create_from_file_and_string(AMGX_config_handle *cfg,
                                                const char *param_file,
                                                const char *options) {
    INIT_OR_RETURN();
    Gil gil;
    return create(cfg, "AMGX_config_create_from_file_and_string",
                  Py_BuildValue("(ss)", param_file,
                                options ? options : ""));
}

AMGX_RC AMGX_config_add_parameters(AMGX_config_handle *cfg,
                                   const char *options) {
    INIT_OR_RETURN();
    if (!cfg) return AMGX_RC_BAD_PARAMETERS;
    Gil gil;
    return simple("AMGX_config_add_parameters",
                  Py_BuildValue("(Os)", B(*cfg), options ? options : ""));
}

AMGX_RC AMGX_config_get_default_number_of_rings(AMGX_config_handle cfg,
                                                int *num_rings) {
    return get_one("AMGX_config_get_default_number_of_rings", cfg,
                   num_rings, [](PyObject *o) { return (int)output_long(o); });
}

AMGX_RC AMGX_config_destroy(AMGX_config_handle cfg) {
    drop(cfg);
    return AMGX_RC_OK;
}

AMGX_RC AMGX_write_parameters_description(char *filename) {
    INIT_OR_RETURN();
    Gil gil;
    std::vector<PyObject *> outs;
    AMGX_RC rc = unpack_rc(
        call("AMGX_write_parameters_description",
             filename ? Py_BuildValue("(s)", filename)
                      : Py_BuildValue("(O)", Py_None)), &outs);
    release(outs);
    return rc;
}

/* ---------------------------------------------------------- resources */
AMGX_RC AMGX_resources_create(AMGX_resources_handle *rsc,
                              AMGX_config_handle cfg, void *,
                              int device_num, const int *devices) {
    INIT_OR_RETURN();
    Gil gil;
    /* the reference's (device_num, devices) is a count and a list of
       device ids; without a list device_num names the one device */
    PyObject *devs;
    if (devices && device_num > 0) {
        devs = PyList_New(device_num);
        for (int i = 0; i < device_num; ++i)
            PyList_SetItem(devs, i, PyLong_FromLong(devices[i]));
    } else {
        Py_INCREF(Py_None);
        devs = Py_None;
    }
    AMGX_RC rc = create(rsc, "AMGX_resources_create",
                        Py_BuildValue("(OOiO)", B(cfg), Py_None,
                                      devices ? 0 : device_num, devs));
    Py_DECREF(devs);
    return rc;
}

AMGX_RC AMGX_resources_create_simple(AMGX_resources_handle *rsc,
                                     AMGX_config_handle cfg) {
    INIT_OR_RETURN();
    Gil gil;
    return create(rsc, "AMGX_resources_create_simple",
                  Py_BuildValue("(O)", B(cfg)));
}

AMGX_RC AMGX_resources_destroy(AMGX_resources_handle rsc) {
    drop(rsc);
    return AMGX_RC_OK;
}

/* ------------------------------------------------------------- matrix */
AMGX_RC AMGX_matrix_create(AMGX_matrix_handle *mtx,
                           AMGX_resources_handle rsc, AMGX_Mode mode) {
    INIT_OR_RETURN();
    Gil gil;
    return create(mtx, "AMGX_matrix_create",
                  Py_BuildValue("(Os)", B(rsc), mode_name(mode)));
}

AMGX_RC AMGX_matrix_destroy(AMGX_matrix_handle mtx) {
    drop(mtx);
    return AMGX_RC_OK;
}

AMGX_RC AMGX_matrix_upload_all(AMGX_matrix_handle mtx, int n, int nnz,
                               int block_dimx, int block_dimy,
                               const int *row_ptrs, const int *col_indices,
                               const void *data, const void *diag_data) {
    INIT_OR_RETURN();
    Gil gil;
    int tn = handle_mode_typenum(mtx, "mat_dtype");
    npy_intp nvals = (npy_intp)nnz * block_dimx * block_dimy;
    PyObject *rp = np_view(row_ptrs, (npy_intp)n + 1, NPY_INT32);
    PyObject *ci = np_view(col_indices, nnz, NPY_INT32);
    PyObject *dv = np_view(data, nvals, tn);
    PyObject *dd = np_view(diag_data,
                           (npy_intp)n * block_dimx * block_dimy, tn);
    PyObject *args = Py_BuildValue("(OiiiiOOOO)", B(mtx), n, nnz,
                                   block_dimx, block_dimy, rp, ci, dv, dd);
    Py_XDECREF(rp);
    Py_XDECREF(ci);
    Py_XDECREF(dv);
    Py_XDECREF(dd);
    return simple("AMGX_matrix_upload_all", args);
}

AMGX_RC AMGX_matrix_replace_coefficients(AMGX_matrix_handle mtx, int n,
                                         int nnz, const void *data,
                                         const void *diag_data) {
    INIT_OR_RETURN();
    Gil gil;
    PyObject *m = PyObject_GetAttrString(B(mtx), "matrix");
    PyObject *bdim =
        (m && m != Py_None) ? PyObject_GetAttrString(m, "block_dim")
                            : nullptr;
    long b = bdim ? PyLong_AsLong(bdim) : 1;
    Py_XDECREF(bdim);
    Py_XDECREF(m);
    PyErr_Clear();
    int tn = handle_mode_typenum(mtx, "mat_dtype");
    PyObject *dv = np_view(data, (npy_intp)nnz * b * b, tn);
    PyObject *dd = np_view(diag_data, (npy_intp)n * b * b, tn);
    PyObject *args = Py_BuildValue("(OiiOO)", B(mtx), n, nnz, dv, dd);
    Py_XDECREF(dv);
    Py_XDECREF(dd);
    return simple("AMGX_matrix_replace_coefficients", args);
}

AMGX_RC AMGX_matrix_get_size(AMGX_matrix_handle mtx, int *n,
                             int *block_dimx, int *block_dimy) {
    INIT_OR_RETURN();
    Gil gil;
    std::vector<PyObject *> outs;
    AMGX_RC rc = unpack_rc(
        call("AMGX_matrix_get_size", Py_BuildValue("(O)", B(mtx))), &outs);
    if (rc == AMGX_RC_OK && outs.size() >= 3) {
        if (n) *n = (int)output_long(outs[0]);
        if (block_dimx) *block_dimx = (int)output_long(outs[1]);
        if (block_dimy) *block_dimy = (int)output_long(outs[2]);
    }
    release(outs);
    return rc;
}

AMGX_RC AMGX_matrix_get_nnz(AMGX_matrix_handle mtx, int *nnz) {
    return get_one("AMGX_matrix_get_nnz", mtx, nnz,
                   [](PyObject *o) { return (int)output_long(o); });
}

static void copy_out(PyObject *src, int typenum, void *dst) {
    if (!dst) return;
    PyArrayObject *a = (PyArrayObject *)PyArray_FROM_OTF(
        src, typenum, NPY_ARRAY_C_CONTIGUOUS);
    if (a) {
        std::memcpy(dst, PyArray_DATA(a), PyArray_NBYTES(a));
        Py_DECREF(a);
    } else {
        PyErr_Print();
    }
}

AMGX_RC AMGX_matrix_download_all(AMGX_matrix_handle mtx, int *row_ptrs,
                                 int *col_indices, void *data, void **) {
    INIT_OR_RETURN();
    Gil gil;
    std::vector<PyObject *> outs;
    AMGX_RC rc = unpack_rc(
        call("AMGX_matrix_download_all", Py_BuildValue("(O)", B(mtx))),
        &outs);
    if (rc == AMGX_RC_OK && outs.size() >= 3) {
        copy_out(outs[0], NPY_INT32, row_ptrs);
        copy_out(outs[1], NPY_INT32, col_indices);
        copy_out(outs[2], handle_mode_typenum(mtx, "mat_dtype"), data);
    }
    release(outs);
    return rc;
}

AMGX_RC AMGX_matrix_vector_multiply(AMGX_matrix_handle mtx,
                                    AMGX_vector_handle x,
                                    AMGX_vector_handle y) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_matrix_vector_multiply",
                  Py_BuildValue("(OOO)", B(mtx), B(x), B(y)));
}

AMGX_RC AMGX_matrix_attach_geometry(AMGX_matrix_handle mtx,
                                    const double *geox, const double *geoy,
                                    const double *geoz, int n) {
    INIT_OR_RETURN();
    Gil gil;
    PyObject *gx = np_view(geox, n, NPY_FLOAT64);
    PyObject *gy = np_view(geoy, n, NPY_FLOAT64);
    PyObject *gz = np_view(geoz, n, NPY_FLOAT64);
    PyObject *args = Py_BuildValue("(OOOO)", B(mtx), gx, gy, gz);
    Py_XDECREF(gx);
    Py_XDECREF(gy);
    Py_XDECREF(gz);
    return simple("AMGX_matrix_attach_geometry", args);
}

AMGX_RC AMGX_matrix_comm_from_maps(AMGX_matrix_handle mtx,
                                   int allocated_halo_depth,
                                   int num_import_rings,
                                   int max_num_neighbors,
                                   const int *neighbors,
                                   const int *send_ptrs,
                                   const int *send_maps,
                                   const int *recv_ptrs,
                                   const int *recv_maps) {
    INIT_OR_RETURN();
    Gil gil;
    int nn = max_num_neighbors;
    PyObject *nb = np_view(neighbors, nn, NPY_INT32);
    PyObject *sp = np_view(send_ptrs, nn + 1, NPY_INT32);
    PyObject *sm = np_view(send_maps, nn ? send_ptrs[nn] : 0, NPY_INT32);
    PyObject *rp = np_view(recv_ptrs, nn + 1, NPY_INT32);
    PyObject *rm = np_view(recv_maps, nn ? recv_ptrs[nn] : 0, NPY_INT32);
    PyObject *args = Py_BuildValue("(OiiiOOOOO)", B(mtx),
                                   allocated_halo_depth, num_import_rings,
                                   nn, nb, sp, sm, rp, rm);
    Py_XDECREF(nb); Py_XDECREF(sp); Py_XDECREF(sm);
    Py_XDECREF(rp); Py_XDECREF(rm);
    return simple("AMGX_matrix_comm_from_maps", args);
}

AMGX_RC AMGX_matrix_comm_from_maps_one_ring(AMGX_matrix_handle mtx,
                                            int allocated_halo_depth,
                                            int num_neighbors,
                                            const int *neighbors,
                                            const int *send_sizes,
                                            const int **send_maps,
                                            const int *recv_sizes,
                                            const int **recv_maps) {
    INIT_OR_RETURN();
    Gil gil;
    int nn = num_neighbors;
    PyObject *nb = np_view(neighbors, nn, NPY_INT32);
    PyObject *ss = np_view(send_sizes, nn, NPY_INT32);
    PyObject *rs = np_view(recv_sizes, nn, NPY_INT32);
    PyObject *sml = PyList_New(nn);
    PyObject *rml = PyList_New(nn);
    for (int i = 0; i < nn; ++i) {
        PyList_SetItem(sml, i,
                       np_view(send_maps[i], send_sizes[i], NPY_INT32));
        PyList_SetItem(rml, i,
                       np_view(recv_maps[i], recv_sizes[i], NPY_INT32));
    }
    PyObject *args = Py_BuildValue("(OiiOOOOO)", B(mtx),
                                   allocated_halo_depth, nn, nb, ss, sml,
                                   rs, rml);
    Py_XDECREF(nb); Py_XDECREF(ss); Py_XDECREF(rs);
    Py_XDECREF(sml); Py_XDECREF(rml);
    return simple("AMGX_matrix_comm_from_maps_one_ring", args);
}

/* ------------------------------------------------------------- vector */
AMGX_RC AMGX_vector_create(AMGX_vector_handle *vec,
                           AMGX_resources_handle rsc, AMGX_Mode mode) {
    INIT_OR_RETURN();
    Gil gil;
    return create(vec, "AMGX_vector_create",
                  Py_BuildValue("(Os)", B(rsc), mode_name(mode)));
}

AMGX_RC AMGX_vector_destroy(AMGX_vector_handle vec) {
    drop(vec);
    return AMGX_RC_OK;
}

AMGX_RC AMGX_vector_upload(AMGX_vector_handle vec, int n, int block_dim,
                           const void *data) {
    INIT_OR_RETURN();
    Gil gil;
    int tn = handle_mode_typenum(vec, "vec_dtype");
    PyObject *arr = np_view(data, (npy_intp)n * block_dim, tn);
    PyObject *args = Py_BuildValue("(OiiO)", B(vec), n, block_dim, arr);
    Py_XDECREF(arr);
    return simple("AMGX_vector_upload", args);
}

AMGX_RC AMGX_vector_set_zero(AMGX_vector_handle vec, int n,
                             int block_dim) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_vector_set_zero",
                  Py_BuildValue("(Oii)", B(vec), n, block_dim));
}

AMGX_RC AMGX_vector_get_size(AMGX_vector_handle vec, int *n,
                             int *block_dim) {
    INIT_OR_RETURN();
    Gil gil;
    std::vector<PyObject *> outs;
    AMGX_RC rc = unpack_rc(
        call("AMGX_vector_get_size", Py_BuildValue("(O)", B(vec))), &outs);
    if (rc == AMGX_RC_OK && outs.size() >= 2) {
        if (n) *n = (int)output_long(outs[0]);
        if (block_dim) *block_dim = (int)output_long(outs[1]);
    }
    release(outs);
    return rc;
}

AMGX_RC AMGX_vector_download(AMGX_vector_handle vec, void *data) {
    INIT_OR_RETURN();
    if (!data) return AMGX_RC_BAD_PARAMETERS;
    int n = 0, bd = 1;
    AMGX_RC rc = AMGX_vector_get_size(vec, &n, &bd);
    if (rc != AMGX_RC_OK) return rc;
    Gil gil;
    /* the device vector is copied straight into the caller's buffer */
    PyObject *out = np_view(data, (npy_intp)n * bd,
                            handle_mode_typenum(vec, "vec_dtype"));
    std::vector<PyObject *> outs;
    rc = unpack_rc(call("AMGX_vector_download",
                        Py_BuildValue("(OO)", B(vec), out)), &outs);
    Py_XDECREF(out);
    release(outs);
    return rc;
}

AMGX_RC AMGX_vector_bind(AMGX_vector_handle vec, AMGX_matrix_handle mtx) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_vector_bind",
                  Py_BuildValue("(OO)", B(vec), B(mtx)));
}

/* ------------------------------------------------------------- solver */
AMGX_RC AMGX_solver_create(AMGX_solver_handle *slv,
                           AMGX_resources_handle rsc, AMGX_Mode mode,
                           AMGX_config_handle cfg) {
    INIT_OR_RETURN();
    Gil gil;
    return create(slv, "AMGX_solver_create",
                  Py_BuildValue("(OsO)", B(rsc), mode_name(mode), B(cfg)));
}

AMGX_RC AMGX_solver_destroy(AMGX_solver_handle slv) {
    drop(slv);
    return AMGX_RC_OK;
}

AMGX_RC AMGX_solver_setup(AMGX_solver_handle slv, AMGX_matrix_handle mtx) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_solver_setup",
                  Py_BuildValue("(OO)", B(slv), B(mtx)));
}

AMGX_RC AMGX_solver_resetup(AMGX_solver_handle slv,
                            AMGX_matrix_handle mtx) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_solver_resetup",
                  Py_BuildValue("(OO)", B(slv), B(mtx)));
}

AMGX_RC AMGX_solver_solve(AMGX_solver_handle slv, AMGX_vector_handle rhs,
                          AMGX_vector_handle sol) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_solver_solve",
                  Py_BuildValue("(OOO)", B(slv), B(rhs), B(sol)));
}

AMGX_RC AMGX_solver_solve_with_0_initial_guess(AMGX_solver_handle slv,
                                               AMGX_vector_handle rhs,
                                               AMGX_vector_handle sol) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_solver_solve_with_0_initial_guess",
                  Py_BuildValue("(OOO)", B(slv), B(rhs), B(sol)));
}

AMGX_RC AMGX_solver_get_iterations_number(AMGX_solver_handle slv, int *n) {
    return get_one("AMGX_solver_get_iterations_number", slv, n,
                   [](PyObject *o) { return (int)output_long(o); });
}

AMGX_RC AMGX_solver_get_iteration_residual(AMGX_solver_handle slv, int it,
                                           int idx, double *res) {
    INIT_OR_RETURN();
    Gil gil;
    std::vector<PyObject *> outs;
    AMGX_RC rc = unpack_rc(
        call("AMGX_solver_get_iteration_residual",
             Py_BuildValue("(Oii)", B(slv), it, idx)), &outs);
    if (rc == AMGX_RC_OK && !outs.empty() && res)
        *res = PyFloat_AsDouble(outs[0]);
    release(outs);
    return rc;
}

AMGX_RC AMGX_solver_get_status(AMGX_solver_handle slv,
                               AMGX_SOLVE_STATUS *st) {
    return get_one("AMGX_solver_get_status", slv, st, [](PyObject *o) {
        return (AMGX_SOLVE_STATUS)output_long(o);
    });
}

AMGX_RC AMGX_solver_get_setup_time(AMGX_solver_handle slv, double *t) {
    return get_one("AMGX_solver_get_setup_time", slv, t,
                   [](PyObject *o) { return PyFloat_AsDouble(o); });
}

AMGX_RC AMGX_solver_get_solve_time(AMGX_solver_handle slv, double *t) {
    return get_one("AMGX_solver_get_solve_time", slv, t,
                   [](PyObject *o) { return PyFloat_AsDouble(o); });
}

/* ----------------------------------------------------------------- io */
AMGX_RC AMGX_read_system(AMGX_matrix_handle mtx, AMGX_vector_handle rhs,
                         AMGX_vector_handle sol, const char *filename) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_read_system",
                  Py_BuildValue("(OOOs)", B(mtx), B(rhs), B(sol),
                                filename));
}

AMGX_RC AMGX_write_system(AMGX_matrix_handle mtx, AMGX_vector_handle rhs,
                          AMGX_vector_handle sol, const char *filename) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_write_system",
                  Py_BuildValue("(OOOs)", B(mtx), B(rhs), B(sol),
                                filename));
}

/* -------------------------------------------------------- eigensolver */
AMGX_RC AMGX_eigensolver_create(AMGX_eigensolver_handle *es,
                                AMGX_resources_handle rsc, AMGX_Mode mode,
                                AMGX_config_handle cfg) {
    INIT_OR_RETURN();
    Gil gil;
    return create(es, "AMGX_eigensolver_create",
                  Py_BuildValue("(OsO)", B(rsc), mode_name(mode), B(cfg)));
}

AMGX_RC AMGX_eigensolver_setup(AMGX_eigensolver_handle es,
                               AMGX_matrix_handle mtx) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_eigensolver_setup",
                  Py_BuildValue("(OO)", B(es), B(mtx)));
}

AMGX_RC AMGX_eigensolver_solve(AMGX_eigensolver_handle es,
                               AMGX_vector_handle x) {
    INIT_OR_RETURN();
    Gil gil;
    return simple("AMGX_eigensolver_solve",
                  Py_BuildValue("(OO)", B(es), B(x)));
}

AMGX_RC AMGX_eigensolver_destroy(AMGX_eigensolver_handle es) {
    drop(es);
    return AMGX_RC_OK;
}

}  /* extern "C" */

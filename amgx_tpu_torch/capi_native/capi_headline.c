/* capi_headline.c — the headline solve through the AMGX C API: the 3-D
 * 7-point Poisson CSR assembled here, its grid attached as geometry, and
 * FGMRES + GEO-aggregation AMG (the config string of bench.py:1458-1466)
 * run by libamgx_torch_c.so.
 *
 *   capi_headline [mode] [side] [x_dump]
 *
 * mode is an AMGX mode name (dDDI, the default, runs on the card; hDDI
 * on the CPU), side the grid edge (default 128: 2,097,152 rows), x_dump
 * an optional file that receives the downloaded x's raw bytes.  Prints
 * one line "CAPI_HEADLINE {json}": the iteration count and status, the
 * API's own setup and solve seconds, the seconds AMGX_initialize took
 * (starting the interpreter and importing the port), the process's wall
 * seconds so far, the true relative residual ||b - A x|| / ||b|| in f64
 * computed here, and the 64-bit FNV-1a hash of x's bytes.  Exits 0 when
 * the solve reports success, 1 when a call fails, 2 otherwise.
 */
#define _POSIX_C_SOURCE 200809L
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "amgx_tpu_c.h"
#include "amgx_torch_c_ext.h"

#define CHECK(call)                                                    \
    do {                                                               \
        AMGX_RC rc_ = (call);                                          \
        if (rc_ != AMGX_RC_OK) {                                       \
            char msg_[128];                                            \
            AMGX_get_error_string(rc_, msg_, (int)sizeof msg_);        \
            fprintf(stderr, "FAILED %s -> %d (%s)\n", #call, (int)rc_, \
                    msg_);                                             \
            return 1;                                                  \
        }                                                              \
    } while (0)

static const char *HEADLINE_CFG =
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
    "amg:cycle=CG, amg:cycle_iters=2, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
    "amg:coarse_solver=DENSE_LU_SOLVER";

static double now_s(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

static int parse_mode(const char *s, AMGX_Mode *mode) {
    static const char *names[] = {"hDDI", "hDFI", "hFFI", "dDDI", "dDFI",
                                  "dFFI", "hZZI", "hZCI", "hCCI", "dZZI",
                                  "dZCI", "dCCI"};
    for (int i = 0; i < 12; ++i)
        if (strcmp(s, names[i]) == 0) {
            *mode = (AMGX_Mode)i;
            return 0;
        }
    return 1;
}

int main(int argc, char **argv) {
    double t_start = now_s();
    const char *mode_s = argc > 1 ? argv[1] : "dDDI";
    int side = argc > 2 ? atoi(argv[2]) : 128;
    const char *dump = argc > 3 ? argv[3] : NULL;
    AMGX_Mode mode;
    if (parse_mode(mode_s, &mode) || mode_s[1] != 'D' || side < 2) {
        fprintf(stderr, "usage: %s [hDDI|dDDI|...D?I] [side] [x_dump]\n",
                argv[0]);
        return 1;
    }
    int nx = side, ny = side, nz = side;
    int n = nx * ny * nz;

    /* 7-point Laplacian, lexicographic (x fastest), columns ascending */
    int *row_ptrs = malloc((size_t)(n + 1) * sizeof(int));
    int *cols = malloc((size_t)7 * n * sizeof(int));
    double *vals = malloc((size_t)7 * n * sizeof(double));
    double *gx = malloc((size_t)n * sizeof(double));
    double *gy = malloc((size_t)n * sizeof(double));
    double *gz = malloc((size_t)n * sizeof(double));
    double *b = malloc((size_t)n * sizeof(double));
    double *x = malloc((size_t)n * sizeof(double));
    if (!row_ptrs || !cols || !vals || !gx || !gy || !gz || !b || !x) {
        fprintf(stderr, "out of host memory\n");
        return 1;
    }
    int nnz = 0;
    for (int k = 0; k < nz; ++k)
        for (int j = 0; j < ny; ++j)
            for (int i = 0; i < nx; ++i) {
                int r = (k * ny + j) * nx + i;
                row_ptrs[r] = nnz;
                if (k > 0) { cols[nnz] = r - nx * ny; vals[nnz++] = -1.0; }
                if (j > 0) { cols[nnz] = r - nx; vals[nnz++] = -1.0; }
                if (i > 0) { cols[nnz] = r - 1; vals[nnz++] = -1.0; }
                cols[nnz] = r; vals[nnz++] = 6.0;
                if (i < nx - 1) { cols[nnz] = r + 1; vals[nnz++] = -1.0; }
                if (j < ny - 1) { cols[nnz] = r + nx; vals[nnz++] = -1.0; }
                if (k < nz - 1) {
                    cols[nnz] = r + nx * ny;
                    vals[nnz++] = -1.0;
                }
                gx[r] = i;
                gy[r] = j;
                gz[r] = k;
                b[r] = 1.0;
            }
    row_ptrs[n] = nnz;

    double t0 = now_s();
    CHECK(AMGX_initialize());
    double import_s = now_s() - t0;
    AMGX_config_handle cfg;
    CHECK(AMGX_config_create(&cfg, HEADLINE_CFG));
    AMGX_resources_handle rsc;
    CHECK(AMGX_resources_create_simple(&rsc, cfg));
    AMGX_matrix_handle A;
    AMGX_vector_handle vb, vx;
    CHECK(AMGX_matrix_create(&A, rsc, mode));
    CHECK(AMGX_vector_create(&vb, rsc, mode));
    CHECK(AMGX_vector_create(&vx, rsc, mode));
    CHECK(AMGX_matrix_upload_all(A, n, nnz, 1, 1, row_ptrs, cols, vals,
                                 NULL));
    CHECK(AMGX_matrix_attach_geometry(A, gx, gy, gz, n));
    CHECK(AMGX_vector_upload(vb, n, 1, b));
    CHECK(AMGX_vector_set_zero(vx, n, 1));

    AMGX_solver_handle slv;
    CHECK(AMGX_solver_create(&slv, rsc, mode, cfg));
    CHECK(AMGX_solver_setup(slv, A));
    CHECK(AMGX_solver_solve(slv, vb, vx));
    AMGX_SOLVE_STATUS st;
    int iters;
    double setup_s, solve_s;
    CHECK(AMGX_solver_get_status(slv, &st));
    CHECK(AMGX_solver_get_iterations_number(slv, &iters));
    CHECK(AMGX_solver_get_setup_time(slv, &setup_s));
    CHECK(AMGX_solver_get_solve_time(slv, &solve_s));
    CHECK(AMGX_vector_download(vx, x));

    /* the true relative residual in f64 */
    double rr = 0.0, bb = 0.0;
    for (int r = 0; r < n; ++r) {
        double ax = 0.0;
        for (int p = row_ptrs[r]; p < row_ptrs[r + 1]; ++p)
            ax += vals[p] * x[cols[p]];
        double d = b[r] - ax;
        rr += d * d;
        bb += b[r] * b[r];
    }
    double relres = sqrt(rr) / sqrt(bb);
    unsigned long long h = amgx_torch_fnv1a64(x, (size_t)n * sizeof(double));
    if (dump) {
        FILE *f = fopen(dump, "wb");
        if (!f || fwrite(x, sizeof(double), (size_t)n, f) != (size_t)n) {
            fprintf(stderr, "cannot write %s\n", dump);
            return 1;
        }
        fclose(f);
    }

    CHECK(AMGX_solver_destroy(slv));
    CHECK(AMGX_matrix_destroy(A));
    CHECK(AMGX_vector_destroy(vb));
    CHECK(AMGX_vector_destroy(vx));
    CHECK(AMGX_resources_destroy(rsc));
    CHECK(AMGX_config_destroy(cfg));
    CHECK(AMGX_finalize());
    printf("CAPI_HEADLINE {\"mode\": \"%s\", \"side\": %d, \"n\": %d, "
           "\"nnz\": %d, \"iterations\": %d, \"status\": %d, "
           "\"setup_s\": %.17g, \"solve_s\": %.17g, \"import_s\": %.17g, "
           "\"wall_s\": %.17g, \"relres\": %.17g, "
           "\"x_fnv1a64\": \"%016llx\"}\n",
           mode_s, side, n, nnz, iters, (int)st, setup_s, solve_s,
           import_s, now_s() - t_start, relres, h);
    fflush(stdout);
    free(row_ptrs); free(cols); free(vals);
    free(gx); free(gy); free(gz); free(b); free(x);
    return st == AMGX_SOLVE_SUCCESS ? 0 : 2;
}

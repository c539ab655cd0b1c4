/* capi_threads.c — several threads drive independent solves through
 * libamgx_torch_c.so at once (the amgx_capi_multi.c pattern): each
 * thread builds its own config, resources, matrix and vectors, solves a
 * 2-D Poisson (its size set by the thread index) with PCG + Jacobi and
 * checks the residual in C.
 *
 *   capi_threads [mode] [threads]
 *
 * Prints "CAPI_THREADS PASSED" when every thread's solve succeeded.
 */
#define _POSIX_C_SOURCE 200809L
#include <math.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "amgx_tpu_c.h"

#define MAX_THREADS 16
#define CHECK(call)                                                    \
    do {                                                               \
        AMGX_RC rc_ = (call);                                          \
        if (rc_ != AMGX_RC_OK) {                                       \
            fprintf(stderr, "thread %d: FAILED %s -> %d\n", job->id,   \
                    #call, (int)rc_);                                  \
            return NULL;                                               \
        }                                                              \
    } while (0)

typedef struct {
    int id;
    AMGX_Mode mode;
    int iterations;
    double max_residual;
    int ok;
} Job;

static void *solve(void *arg) {
    Job *job = (Job *)arg;
    int nx = 12 + 2 * job->id, n = nx * nx, nnz = 0;
    int *rp = malloc((size_t)(n + 1) * sizeof(int));
    int *cols = malloc((size_t)5 * n * sizeof(int));
    double *vals = malloc((size_t)5 * n * sizeof(double));
    double *ones = malloc((size_t)n * sizeof(double));
    double *sol = malloc((size_t)n * sizeof(double));
    for (int i = 0; i < n; ++i) {
        int x = i % nx, y = i / nx;
        rp[i] = nnz;
        if (y > 0) { cols[nnz] = i - nx; vals[nnz++] = -1.0; }
        if (x > 0) { cols[nnz] = i - 1; vals[nnz++] = -1.0; }
        cols[nnz] = i; vals[nnz++] = 4.0;
        if (x < nx - 1) { cols[nnz] = i + 1; vals[nnz++] = -1.0; }
        if (y < nx - 1) { cols[nnz] = i + nx; vals[nnz++] = -1.0; }
        ones[i] = 1.0;
    }
    rp[n] = nnz;
    AMGX_config_handle cfg;
    CHECK(AMGX_config_create(&cfg,
        "config_version=2, solver(s)=PCG, "
        "s:preconditioner(p)=BLOCK_JACOBI, p:max_iters=3, "
        "s:max_iters=300, s:monitor_residual=1, s:tolerance=1e-9, "
        "s:convergence=RELATIVE_INI"));
    AMGX_resources_handle rsc;
    CHECK(AMGX_resources_create_simple(&rsc, cfg));
    AMGX_matrix_handle A;
    AMGX_vector_handle b, x;
    CHECK(AMGX_matrix_create(&A, rsc, job->mode));
    CHECK(AMGX_vector_create(&b, rsc, job->mode));
    CHECK(AMGX_vector_create(&x, rsc, job->mode));
    CHECK(AMGX_matrix_upload_all(A, n, nnz, 1, 1, rp, cols, vals, NULL));
    CHECK(AMGX_vector_upload(b, n, 1, ones));
    CHECK(AMGX_vector_set_zero(x, n, 1));
    AMGX_solver_handle slv;
    CHECK(AMGX_solver_create(&slv, rsc, job->mode, cfg));
    CHECK(AMGX_solver_setup(slv, A));
    CHECK(AMGX_solver_solve(slv, b, x));
    AMGX_SOLVE_STATUS st;
    CHECK(AMGX_solver_get_status(slv, &st));
    CHECK(AMGX_solver_get_iterations_number(slv, &job->iterations));
    CHECK(AMGX_vector_download(x, sol));
    double rmax = 0.0;
    for (int i = 0; i < n; ++i) {
        double ax = 0.0;
        for (int k = rp[i]; k < rp[i + 1]; ++k) ax += vals[k] * sol[cols[k]];
        if (fabs(1.0 - ax) > rmax) rmax = fabs(1.0 - ax);
    }
    job->max_residual = rmax;
    CHECK(AMGX_solver_destroy(slv));
    CHECK(AMGX_matrix_destroy(A));
    CHECK(AMGX_vector_destroy(b));
    CHECK(AMGX_vector_destroy(x));
    CHECK(AMGX_resources_destroy(rsc));
    CHECK(AMGX_config_destroy(cfg));
    job->ok = st == AMGX_SOLVE_SUCCESS && rmax < 1e-6;
    free(rp); free(cols); free(vals); free(ones); free(sol);
    return NULL;
}

int main(int argc, char **argv) {
    const char *mode_s = argc > 1 ? argv[1] : "dDDI";
    int nt = argc > 2 ? atoi(argv[2]) : 4;
    AMGX_Mode mode = strcmp(mode_s, "hDDI") == 0 ? AMGX_mode_hDDI
                                                 : AMGX_mode_dDDI;
    if (nt < 1 || nt > MAX_THREADS) return 1;
    if (AMGX_initialize() != AMGX_RC_OK) return 1;
    pthread_t th[MAX_THREADS];
    Job jobs[MAX_THREADS];
    for (int t = 0; t < nt; ++t) {
        jobs[t] = (Job){t, mode, 0, 0.0, 0};
        pthread_create(&th[t], NULL, solve, &jobs[t]);
    }
    int ok = 1;
    for (int t = 0; t < nt; ++t) {
        pthread_join(th[t], NULL);
        printf("thread %d: iterations=%d max_residual=%.3e ok=%d\n", t,
               jobs[t].iterations, jobs[t].max_residual, jobs[t].ok);
        ok = ok && jobs[t].ok;
    }
    AMGX_finalize();
    if (!ok) return 2;
    printf("CAPI_THREADS PASSED\n");
    return 0;
}

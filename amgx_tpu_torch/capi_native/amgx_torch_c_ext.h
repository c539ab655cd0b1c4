/* amgx_torch_c_ext.h — entry points of libamgx_torch_c.so beyond
 * native/amgx_tpu_c.h (which stays the ABI every driver links against).
 */
#ifndef AMGX_TORCH_C_EXT_H
#define AMGX_TORCH_C_EXT_H

#include <stddef.h>

#include "amgx_tpu_c.h"

#ifdef __cplusplus
extern "C" {
#endif

/* amgx_c.h:541-546 — per-row coordinates (geoz NULL in 2-D); a regular
 * lexicographic grid gives the GEO selector its grid dimensions */
AMGX_RC AMGX_matrix_attach_geometry(AMGX_matrix_handle mtx,
                                    const double *geox, const double *geoy,
                                    const double *geoz, int n);

/* 64-bit FNV-1a hash of n bytes (the drivers' fingerprint of a
 * downloaded vector; the Python side reads the same function) */
unsigned long long amgx_torch_fnv1a64(const void *data, size_t n);

#ifdef __cplusplus
}
#endif
#endif /* AMGX_TORCH_C_EXT_H */

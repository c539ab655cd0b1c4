// ELL SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel amgx_tpu/ops/pallas_ell.py::_ell_window_call
// (pallas_call at :209): y[r] = sum_k vals[r, k] * x[cols[r, k]] over an
// (n, K) row-major ELL pack, rectangular allowed, columns outside
// [0, n_cols) skipped (device-born packs pad with self-columns or column
// 0 and value 0; host packs pad with column 0 and value 0).  A null cols
// pointer means dense rows: column k of every row is k (K == n_cols), so
// a dense matrix-vector product reads no column table.
//
// Bound on this card: memory.  One SpMV must read cols and vals once,
// x once and write y once:
//   bytes = n * K * (4 + sizeof(T)) + (n_cols + n) * sizeof(T)
// against 2 * n * K flops: below 0.25 flop/byte, far under the card's
// ridge point.  The gather of x is data-dependent; for the banded
// coarse operators of a classical hierarchy L2 serves most of it.
//
// Design: the TPU kernel's column windows, window codes and lane
// one-hot MXU picks exist because a TPU has no gather; Hopper has one,
// so this kernel reads cols/vals straight from the row-major pack.  A
// group of L lanes (L in {1, 2, 4, 8, 16, 32}, the smallest power of two
// >= K, at most 32) serves one row: lane l sums k = l, l + L, ..., so a
// warp reads 32/L consecutive rows' entries as one contiguous span, then
// the group reduces with __shfl_down_sync (lane l adds lane l + off for
// off = L/2, ..., 1).  It accumulates in x's type, rounding each product
// and each sum on its own (no fused multiply-add), so its plain version
// reproduces it bit for bit in the same order; it launches on the
// caller's stream, allocates nothing, and the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// type codes shared with the Python wrapper (ops/ell_spmv.py)
enum TypeCode { kF32 = 0, kF64 = 1 };

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    ell_spmv_kernel(const int32_t* __restrict__ cols,
                    const T* __restrict__ vals, const T* __restrict__ x,
                    T* __restrict__ y, int64_t n, int64_t K,
                    int64_t n_cols) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = t / L;
  const int lane = static_cast<int>(t % L);
  T acc = T(0);
  if (row < n) {
    const T* v = vals + row * K;
    if (cols == nullptr) {
      for (int64_t k = lane; k < K; k += L)
        acc = add(acc, mul(v[k], __ldg(x + k)));
    } else {
      const int32_t* c = cols + row * K;
      for (int64_t k = lane; k < K; k += L) {
        const int64_t j = c[k];
        if (j >= 0 && j < n_cols) acc = add(acc, mul(v[k], __ldg(x + j)));
      }
    }
  }
  // every lane of the warp takes part (rows past n carry 0), so the
  // full mask is valid; width L keeps each shuffle inside its group
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc = add(acc, __shfl_down_sync(0xffffffffu, acc, off, L));
  if (row < n && lane == 0) y[row] = acc;
}

template <typename T, int L>
int launch_l(const int32_t* cols, const void* vals, const void* x, void* y,
             int64_t n, int64_t K, int64_t n_cols, cudaStream_t stream) {
  const int64_t blocks = (n * L + kThreads - 1) / kThreads;
  ell_spmv_kernel<T, L><<<static_cast<unsigned int>(blocks), kThreads, 0,
                          stream>>>(cols, static_cast<const T*>(vals),
                                    static_cast<const T*>(x),
                                    static_cast<T*>(y), n, K, n_cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const int32_t* cols, const void* vals, const void* x, void* y,
           int64_t n, int64_t K, int64_t n_cols, cudaStream_t s) {
  if (K <= 1) return launch_l<T, 1>(cols, vals, x, y, n, K, n_cols, s);
  if (K <= 2) return launch_l<T, 2>(cols, vals, x, y, n, K, n_cols, s);
  if (K <= 4) return launch_l<T, 4>(cols, vals, x, y, n, K, n_cols, s);
  if (K <= 8) return launch_l<T, 8>(cols, vals, x, y, n, K, n_cols, s);
  if (K <= 16) return launch_l<T, 16>(cols, vals, x, y, n, K, n_cols, s);
  return launch_l<T, 32>(cols, vals, x, y, n, K, n_cols, s);
}

}  // namespace

// Plain C interface, loaded through ctypes.  Returns 0 on success, a
// cudaError_t code when the launch was refused, or -1 for arguments the
// kernel does not take (negative sizes, dense rows with K != n_cols, an
// unsupported type pair).
extern "C" int amgx_ell_spmv(int vals_type, int x_type, const void* cols,
                             const void* vals, const void* x, void* y,
                             int64_t n, int64_t K, int64_t n_cols,
                             void* stream) {
  if (n < 0 || K < 0 || n_cols < 0) return -1;
  if (cols == nullptr && K != n_cols) return -1;
  if (n == 0) return 0;
  const int32_t* c = static_cast<const int32_t*>(cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_type == kF32 && x_type == kF32)
    return launch<float>(c, vals, x, y, n, K, n_cols, s);
  if (vals_type == kF64 && x_type == kF64)
    return launch<double>(c, vals, x, y, n, K, n_cols, s);
  return -1;
}

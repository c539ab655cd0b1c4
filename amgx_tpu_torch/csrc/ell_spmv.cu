// ELL SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel amgx_tpu/ops/pallas_ell.py::_ell_window_call
// (pallas_call at :209): y[r] = sum_k vals[r, k] * x[cols[r, k]] over an
// (n, K) row-major ELL pack, rectangular allowed, columns outside
// [0, n_cols) skipped (device-born packs pad with self-columns or column
// 0 and value 0; host packs pad with column 0 and value 0).  A null cols
// pointer means dense rows: column k of every row is k (K == n_cols), so
// a dense matrix-vector product reads no column table.  row_len (or
// null) holds, per row, one past its last slot with a nonzero value:
// every slot at or past it holds 0.
//
// Bound on this card: memory.  One SpMV must read each stored entry's
// column and value once, x once and write y once:
//   bytes = nnz * (4 + sizeof(V)) + (n_cols + n) * sizeof(T)
// for values of type V and vectors of type T.
// against 2 * nnz flops: below 0.25 flop/byte, far under the card's
// ridge point.  The gather of x is data-dependent; for the banded
// coarse operators of a classical hierarchy L2 serves most of it.  A
// pack padded to K slots a row holds n * K entries; the padding is the
// part of the stream the product does not need.
//
// Design: the TPU kernel's column windows, window codes and lane
// one-hot MXU picks exist because a TPU has no gather; Hopper has one,
// so this kernel reads cols/vals straight from the row-major pack.  A
// group of L lanes (L in {1, 2, 4, 8, 16, 32}, the smallest power of two
// >= K, at most 32) serves one row: lane l sums k = l, l + L, ..., so a
// warp reads 32/L consecutive rows' entries as one contiguous span, then
// the group reduces with __shfl_down_sync (lane l adds lane l + off for
// off = L/2, ..., 1).  With row_len, every lane of row r stops at
// row_len[r] instead of K: a row holding 71 entries of a 256-slot pack
// reads 71 slots' columns and values (rounded up to whole 32-byte
// sectors), not 256.  The terms skipped are exact zeros (for finite x)
// that would be added to a lane sum which starts at +0 and so is never
// -0: dropping them changes no bit.  It accumulates in x's type, rounding each product
// and each sum on its own (no fused multiply-add), so its plain version
// reproduces it bit for bit in the same order; it launches on the
// caller's stream, allocates nothing, and the launcher returns
// cudaGetLastError().
//
// Type pairs (vals, x): (f32, f32), (f64, f64) and (bf16, f32), the last
// for a level of a bf16 hierarchy (hierarchy_dtype=bfloat16): each bf16
// value widens to f32 in registers (exact) before its product, so the
// sums run in f32 in the same order as the (f32, f32) pair, and the value
// stream is half as many bytes.  (f32, f64) and (bf16, f64) serve a level
// narrowed by hierarchy_dtype under an f64 outer solver: each value
// widens to f64 (exact) and the sums run in f64, in the same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// type codes shared with the Python wrapper (ops/ell_spmv.py)
enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2 };

// a stored value in the accumulation type: the identity, or a bf16
// value widened to f32 (exact)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

template <typename V, typename T, int L>
__global__ void __launch_bounds__(kThreads)
    ell_spmv_kernel(const int32_t* __restrict__ cols,
                    const int32_t* __restrict__ row_len,
                    const V* __restrict__ vals, const T* __restrict__ x,
                    T* __restrict__ y, int64_t n, int64_t K,
                    int64_t n_cols) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = t / L;
  const int lane = static_cast<int>(t % L);
  T acc = T(0);
  if (row < n) {
    const V* v = vals + row * K;
    if (cols == nullptr) {
      for (int64_t k = lane; k < K; k += L)
        acc = add(acc, mul(static_cast<T>(widen(v[k])), __ldg(x + k)));
    } else {
      const int32_t* c = cols + row * K;
      int64_t end = K;
      if (row_len != nullptr) {
        const int64_t r = __ldg(row_len + row);
        end = r < K ? r : K;
      }
      for (int64_t k = lane; k < end; k += L) {
        const int64_t j = c[k];
        if (j >= 0 && j < n_cols)
          acc = add(acc, mul(static_cast<T>(widen(v[k])), __ldg(x + j)));
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

template <typename V, typename T, int L>
int launch_l(const int32_t* cols, const int32_t* row_len, const void* vals,
             const void* x, void* y, int64_t n, int64_t K, int64_t n_cols,
             cudaStream_t stream) {
  const int64_t blocks = (n * L + kThreads - 1) / kThreads;
  ell_spmv_kernel<V, T, L><<<static_cast<unsigned int>(blocks), kThreads,
                             0, stream>>>(cols, row_len,
                                    static_cast<const V*>(vals),
                                    static_cast<const T*>(x),
                                    static_cast<T*>(y), n, K, n_cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename T>
int launch(const int32_t* cols, const int32_t* rl, const void* vals,
           const void* x, void* y, int64_t n, int64_t K, int64_t n_cols,
           cudaStream_t s) {
  if (K <= 1)
    return launch_l<V, T, 1>(cols, rl, vals, x, y, n, K, n_cols, s);
  if (K <= 2)
    return launch_l<V, T, 2>(cols, rl, vals, x, y, n, K, n_cols, s);
  if (K <= 4)
    return launch_l<V, T, 4>(cols, rl, vals, x, y, n, K, n_cols, s);
  if (K <= 8)
    return launch_l<V, T, 8>(cols, rl, vals, x, y, n, K, n_cols, s);
  if (K <= 16)
    return launch_l<V, T, 16>(cols, rl, vals, x, y, n, K, n_cols, s);
  return launch_l<V, T, 32>(cols, rl, vals, x, y, n, K, n_cols, s);
}

}  // namespace

// Plain C interface, loaded through ctypes.  Returns 0 on success, a
// cudaError_t code when the launch was refused, or -1 for arguments the
// kernel does not take (negative sizes, dense rows with K != n_cols or
// with row_len, an unsupported type pair).
extern "C" int amgx_ell_spmv(int vals_type, int x_type, const void* cols,
                             const void* row_len, const void* vals,
                             const void* x, void* y, int64_t n, int64_t K,
                             int64_t n_cols, void* stream) {
  if (n < 0 || K < 0 || n_cols < 0) return -1;
  if (cols == nullptr && (K != n_cols || row_len != nullptr)) return -1;
  if (n == 0) return 0;
  const int32_t* c = static_cast<const int32_t*>(cols);
  const int32_t* rl = static_cast<const int32_t*>(row_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_type == kF32 && x_type == kF32)
    return launch<float, float>(c, rl, vals, x, y, n, K, n_cols, s);
  if (vals_type == kF64 && x_type == kF64)
    return launch<double, double>(c, rl, vals, x, y, n, K, n_cols, s);
  if (vals_type == kBF16 && x_type == kF32)
    return launch<__nv_bfloat16, float>(c, rl, vals, x, y, n, K, n_cols, s);
  if (vals_type == kF32 && x_type == kF64)
    return launch<float, double>(c, rl, vals, x, y, n, K, n_cols, s);
  if (vals_type == kBF16 && x_type == kF64)
    return launch<__nv_bfloat16, double>(c, rl, vals, x, y, n, K, n_cols,
                                         s);
  return -1;
}

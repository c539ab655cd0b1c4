// DIA (row-aligned diagonal) SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel amgx_tpu/ops/pallas_spmv.py::_dia_spmv_call
// (pallas_call at :101): y[i] = sum_k vals[k, i] * x[i + off_k] over
// nd <= 48 static diagonals, x read as zero outside [0, n_cols).
//
// Bound on this card: memory.  One SpMV must read vals once and x once
// and write y once:
//   bytes = nd * n * sizeof(V) + (n_cols + n) * sizeof(X)
// against 2 * nd * n flops, so at any nd the arithmetic intensity is
// below 0.25 flop/byte, far under the card's ridge point.  At 128^3 with
// f32 and nd = 7 that is 75.5 MB, about 22.5 us at 3.35 TB/s (H100 SXM
// datasheet); in f64 151 MB, about 45 us.  These are reckoned figures.
//
// Design: one streaming pass.  One thread per row, 256 threads a block;
// the reads of each vals[k, :] row and of x[i + off_k] are coalesced
// across a warp, and L1/L2 serve the reuse of x across diagonals.  The
// offsets travel by value in the kernel-parameter struct.  The kernel
// checks the column bounds itself (it does not rely on vals being zero
// outside the matrix), accumulates in x's type, launches on the caller's
// stream, allocates nothing, and the launcher returns cudaGetLastError().
// The TPU kernel's (rows, 128) x view, VMEM windows and lane concat are
// TPU layout rules and are not carried over; nor is its n % 128 == 0,
// n >= 16384 gate: this kernel serves every scalar DIA level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 48;
constexpr int kThreads = 256;

struct DiaOffsets {
  int nd;
  int off[kMaxDiags];
};

// type codes shared with the Python wrapper (ops/dia_spmv.py)
enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2 };

template <typename X, typename V>
__device__ __forceinline__ X widen(V v) {
  return static_cast<X>(v);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename V, typename X>
__global__ void __launch_bounds__(kThreads)
    dia_spmv_kernel(const V* __restrict__ vals, const X* __restrict__ x,
                    X* __restrict__ y, int64_t n, int64_t n_cols,
                    DiaOffsets offs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  X acc = X(0);
#pragma unroll 8
  for (int k = 0; k < offs.nd; ++k) {
    const int64_t j = i + offs.off[k];
    if (j >= 0 && j < n_cols) {
      acc += widen<X>(vals[static_cast<int64_t>(k) * n + i]) * x[j];
    }
  }
  y[i] = acc;
}

template <typename V, typename X>
int launch(const void* vals, const void* x, void* y, int64_t n,
           int64_t n_cols, const DiaOffsets& offs, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  dia_spmv_kernel<V, X><<<static_cast<unsigned int>(blocks), kThreads, 0,
                          stream>>>(static_cast<const V*>(vals),
                                    static_cast<const X*>(x),
                                    static_cast<X*>(y), n, n_cols, offs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded through ctypes.  Returns 0 on success, a
// cudaError_t code when the launch was refused, or -1 for arguments the
// kernel does not take (nd outside [1, 48], an unsupported type pair).
extern "C" int amgx_dia_spmv(int vals_type, int x_type, const void* vals,
                             const void* x, void* y, int64_t n,
                             int64_t n_cols, int nd, const int* offsets,
                             void* stream) {
  if (nd < 1 || nd > kMaxDiags || n < 0 || n_cols < 0) return -1;
  if (n == 0) return 0;
  DiaOffsets offs;
  offs.nd = nd;
  for (int k = 0; k < kMaxDiags; ++k) offs.off[k] = k < nd ? offsets[k] : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_type == kBF16 && x_type == kF32)
    return launch<__nv_bfloat16, float>(vals, x, y, n, n_cols, offs, s);
  if (vals_type == kF32 && x_type == kF32)
    return launch<float, float>(vals, x, y, n, n_cols, offs, s);
  if (vals_type == kF32 && x_type == kF64)
    return launch<float, double>(vals, x, y, n, n_cols, offs, s);
  if (vals_type == kF64 && x_type == kF64)
    return launch<double, double>(vals, x, y, n, n_cols, offs, s);
  return -1;
}

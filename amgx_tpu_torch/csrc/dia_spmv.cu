// DIA (row-aligned diagonal) SpMV for Hopper (sm_90a): kernel B1.
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
// What held the first design (one thread a row, a loop over a run-time nd
// in which one bounds test guarded both loads) back was latency, not
// bytes: the compiler could not issue a row's loads ahead of its adds,
// so each thread kept one or two loads in flight and every diagonal
// waited a memory latency (1.1 TB/s at 128^3, nd = 7).  This design:
//
// * R rows a thread (4 for f32 and bf16 values, 2 for f64 and for
//   nd = 25), 256 threads a CTA.  Thread t of CTA c makes rows c * 256R + tR .. + R - 1, so a
//   warp's load of diagonal k is one contiguous span of vals; when n % R
//   is 0 and the pointers allow, it is one 16-byte (bf16: 8-byte) load a
//   thread, and y is stored the same way.
// * A CTA whose every row i has 0 <= i + off_k < n_cols for all k (one
//   test a CTA, from the offsets' min and max) takes a branch-free path:
//   the loads of a group of kGroup diagonals (vals and the R x values of
//   each) are all issued before the group's first add.  nd = 7 (the
//   7-point levels) and nd = 25 (the classical P0 / R0 streams) are
//   compiled with nd known, so every group is unrolled; any other nd
//   takes the same path with a run-time count.  The CTAs at the ends of
//   the matrix keep the per-term column test.
// * x is read through the read-only cache (__ldg): neighbouring threads'
//   rows and the +-1, +-nx diagonals reuse its lines in L1/L2.
//
// Every path keeps one sum per row: acc = +0, then k = 0 .. nd - 1 in
// order, each product and each sum rounded on its own (no fused
// multiply-add).  A term whose column is out of range is skipped, which
// gives the same bits as adding its exact zero, because acc is never -0.
// So the kernel reproduces its plain version (ops/dia_spmv.py::
// dia_spmv_reference) bit for bit.  It accumulates in x's type, launches
// on the caller's stream, allocates nothing, and the launcher returns
// cudaGetLastError().  Type pairs (vals, x): (bf16, f32), (f32, f32),
// (f32, f64), (bf16, f64) and (f64, f64); each value widens exactly to
// x's type before its product.  The TPU kernel's (rows, 128) x view,
// VMEM windows and lane concat are TPU layout rules and are not carried
// over; nor is its n % 128 == 0, n >= 16384 gate: this kernel serves
// every scalar DIA level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 48;
constexpr int kThreads = 256;
constexpr int kGroup = 8;  // diagonals whose loads are issued together

struct DiaOffsets {
  int nd;
  int lo;  // min off_k
  int hi;  // max off_k
  int off[kMaxDiags];
};

// type codes shared with the Python wrapper (ops/dia_spmv.py)
enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2 };

// Rows a thread: 2 for f64 values and for nd = 25, whose 25 value and
// x loads a row already keep enough bytes in flight, else 4.
template <typename V, int ND>
__host__ __device__ constexpr int rows_per_thread() {
  return sizeof(V) == 8 || ND == 25 ? 2 : 4;
}

// CTAs an SM must hold: nd = 25 asks for three, which caps the registers
// the compiler may spend hoisting loads across groups.
template <int ND>
__host__ __device__ constexpr int min_ctas() {
  return ND == 25 ? 3 : 1;
}

template <typename X, typename V>
__device__ __forceinline__ X widen(V v) {
  return static_cast<X>(v);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <>
__device__ __forceinline__ double widen<double, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
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

// R consecutive values at p (aligned to their total size when VEC) as
// one vector load where the width allows, else R scalar loads.
template <typename V, int R, bool VEC>
struct Load {
  static __device__ __forceinline__ void run(const V* __restrict__ p,
                                             V (&v)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = __ldg(p + r);
  }
};

template <>
struct Load<float, 4, true> {
  static __device__ __forceinline__ void run(const float* __restrict__ p,
                                             float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

template <>
struct Load<double, 2, true> {
  static __device__ __forceinline__ void run(const double* __restrict__ p,
                                             double (&v)[2]) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
};

template <>
struct Load<__nv_bfloat16, 4, true> {
  static __device__ __forceinline__ void run(
      const __nv_bfloat16* __restrict__ p, __nv_bfloat16 (&v)[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
};

// R consecutive results to p, as 16-byte stores when VEC and the width
// allows.
template <typename X, int R, bool VEC>
__device__ __forceinline__ void store(X* __restrict__ p, const X (&a)[R]) {
  if constexpr (VEC && sizeof(X) * R % 16 == 0 && sizeof(X) == 4) {
#pragma unroll
    for (int r = 0; r < R; r += 4)
      *reinterpret_cast<float4*>(p + r) =
          make_float4(a[r], a[r + 1], a[r + 2], a[r + 3]);
  } else if constexpr (VEC && sizeof(X) * R % 16 == 0 && sizeof(X) == 8) {
#pragma unroll
    for (int r = 0; r < R; r += 2)
      *reinterpret_cast<double2*>(p + r) = make_double2(a[r], a[r + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = a[r];
  }
}

// One group of up to kGroup diagonals, k0 .. k0 + kGroup - 1 (those below
// nd), of the interior path: every load first, then the adds in order.
template <typename V, typename X, int R, bool VEC>
__device__ __forceinline__ void interior_group(
    const V* __restrict__ vals, const X* __restrict__ x, int64_t n,
    int64_t i0, const DiaOffsets& offs, int k0, int nd, X (&acc)[R]) {
  V v[kGroup][R];
  X xv[kGroup][R];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (k0 + u < nd) {
      Load<V, R, VEC>::run(vals + static_cast<int64_t>(k0 + u) * n + i0,
                           v[u]);
      const X* xp = x + i0 + offs.off[k0 + u];
#pragma unroll
      for (int r = 0; r < R; ++r) xv[u][r] = __ldg(xp + r);
    }
  }
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (k0 + u < nd) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = add(acc[r], mul(widen<X>(v[u][r]), xv[u][r]));
    }
  }
}

// ND > 0: nd is ND, known at compile time; ND == 0: offs.nd.
template <typename V, typename X, int ND, bool VEC>
__global__ void __launch_bounds__(kThreads, min_ctas<ND>())
    dia_spmv_kernel(const V* __restrict__ vals, const X* __restrict__ x,
                    X* __restrict__ y, int64_t n, int64_t n_cols,
                    DiaOffsets offs) {
  constexpr int R = rows_per_thread<V, ND>();
  const int64_t cta0 = static_cast<int64_t>(blockIdx.x) * kThreads * R;
  const int64_t cta1 = cta0 + kThreads * R;  // one past the CTA's rows
  const int64_t i0 = cta0 + static_cast<int64_t>(threadIdx.x) * R;
  const int nd = ND > 0 ? ND : offs.nd;
  X acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = X(0);
  if (cta1 <= n && cta0 + offs.lo >= 0 && cta1 - 1 + offs.hi < n_cols) {
    if constexpr (ND > 0) {
#pragma unroll
      for (int k0 = 0; k0 < ND; k0 += kGroup)
        interior_group<V, X, R, VEC>(vals, x, n, i0, offs, k0, ND, acc);
    } else {
      for (int k0 = 0; k0 < nd; k0 += kGroup)
        interior_group<V, X, R, VEC>(vals, x, n, i0, offs, k0, nd, acc);
    }
    store<X, R, VEC>(y + i0, acc);
    return;
  }
  // an edge CTA: the per-term column test, one row at a time
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = i0 + r;
    if (i >= n) return;
    for (int k = 0; k < nd; ++k) {
      const int64_t j = i + offs.off[k];
      if (j >= 0 && j < n_cols)
        acc[r] = add(acc[r],
                     mul(widen<X>(vals[static_cast<int64_t>(k) * n + i]),
                         x[j]));
    }
    y[i] = acc[r];
  }
}

template <typename V, typename X, int ND>
int launch_nd(const void* vals, const void* x, void* y, int64_t n,
              int64_t n_cols, const DiaOffsets& offs, cudaStream_t stream) {
  constexpr int R = rows_per_thread<V, ND>();
  const int64_t blocks = (n + kThreads * R - 1) / (kThreads * R);
  // vector loads and stores need every row group aligned to its width
  const bool vec = n % R == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % (sizeof(V) * R) == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const auto grid = static_cast<unsigned int>(blocks);
  if (vec)
    dia_spmv_kernel<V, X, ND, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const V*>(vals), static_cast<const X*>(x),
        static_cast<X*>(y), n, n_cols, offs);
  else
    dia_spmv_kernel<V, X, ND, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const V*>(vals), static_cast<const X*>(x),
        static_cast<X*>(y), n, n_cols, offs);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X>
int launch(const void* vals, const void* x, void* y, int64_t n,
           int64_t n_cols, const DiaOffsets& offs, cudaStream_t stream) {
  if (offs.nd == 7)
    return launch_nd<V, X, 7>(vals, x, y, n, n_cols, offs, stream);
  if (offs.nd == 25)
    return launch_nd<V, X, 25>(vals, x, y, n, n_cols, offs, stream);
  return launch_nd<V, X, 0>(vals, x, y, n, n_cols, offs, stream);
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
  offs.lo = offsets[0];
  offs.hi = offsets[0];
  for (int k = 0; k < kMaxDiags; ++k) {
    offs.off[k] = k < nd ? offsets[k] : 0;
    if (k < nd) {
      offs.lo = offsets[k] < offs.lo ? offsets[k] : offs.lo;
      offs.hi = offsets[k] > offs.hi ? offsets[k] : offs.hi;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_type == kBF16 && x_type == kF32)
    return launch<__nv_bfloat16, float>(vals, x, y, n, n_cols, offs, s);
  if (vals_type == kF32 && x_type == kF32)
    return launch<float, float>(vals, x, y, n, n_cols, offs, s);
  if (vals_type == kF32 && x_type == kF64)
    return launch<float, double>(vals, x, y, n, n_cols, offs, s);
  if (vals_type == kF64 && x_type == kF64)
    return launch<double, double>(vals, x, y, n, n_cols, offs, s);
  if (vals_type == kBF16 && x_type == kF64)
    return launch<__nv_bfloat16, double>(vals, x, y, n, n_cols, offs, s);
  return -1;
}

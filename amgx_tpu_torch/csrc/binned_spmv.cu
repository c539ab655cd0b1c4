// Binned sliced-ELL SpMV for Hopper (sm_90a): kernel B4 (scalar packs,
// b = 1) and kernel B5 (block-native packs, b in {2, 3, 4, 5}).
//
// Replaces the TPU kernels amgx_tpu/ops/pallas_csr.py::_binned_call
// (pallas_call at :384) and ::_binned_block_call (pallas_call at :497).
// The pack (ops/binned_spmv.py::csr_binned_pack, bit-equal to the JAX
// package's) permutes rows into power-of-two degree bins, cuts them into
// tiles of 128 rows, and lays each tile's entries out in chunks of
// 8 slots x 128 lanes: lane = block * 1024 + slot * 128 + row % 128.
// codes[lane] is the entry's global (block) column, vals its value; a
// block pack holds b*b component planes, plane a*b + c at vals[(a*b + c)
// * L + lane].  Padding lanes carry code 0 and value 0.
//
//   y[row(p)*b + a] = sum over the chunks of p's tile, in chunk order, of
//                     sum over slots k = 0..7, in slot order, of
//                     sum_c vals[a*b + c][lane] * x[codes[lane]*b + c]
//
// with p the padded position tile * 128 + t and row(p) its original row.
//
// Bound on this card: memory.  One SpMV must read each stored (block)
// entry's code and b*b values once, x once, and write y once:
//   bytes = nnz_blocks * (4 + b*b*sizeof(V)) + (n_cols + n) * b * sizeof(X)
// against 2 * b*b * nnz_blocks flops (1 - 2 flop/byte): far under the
// ridge point.  Every padding lane a kernel streams is on top of that.
//
// Neither kernel reads a lane of the planes.  The planes' (tile, 1024-
// column segment) groups pad every row to the group's widest row in
// steps of 8 slots: 4.38x the stored blocks on the SPE10 block stencil,
// whose rows hold one or two blocks per segment, and 1.74x the stored
// entries on its scalar expansion.  Hopper gathers x directly and needs
// no segments (the TPU kernels' one-hot MXU picks, bf16x3 splits and VMEM
// staging exist because a TPU has no gather), so both kernels read a
// compact pack derived at upload (ops/binned_spmv.py::compact_pack):
// padded positions in the bin order cut into slices of S = 32 / b rows,
// each slice padded only to its own longest row.  One warp serves one
// slice.
//
// B4 (b = 1): one thread a row.  For one slot k the warp's 32 codes and
// 32 values are one 128-byte span each (f32), so every load coalesces.
// A row's entry takes three loads, of which the x gather waits on the
// code, and a row holds some 27 entries on the config-4 expansion: one
// slot at a time, each thread would keep one or two loads in flight and
// wait a memory latency per slot.  So the thread loads the codes of
// kBatch slots, then their values and x gathers, all before the first
// add, and sums them in slot order afterwards.
//
// B5 (b >= 2): b threads a block row: thread (r, a) makes output
// component a of row r.  For one slot k the warp's S codes are one
// 4*S-byte span and its S*b*b values one contiguous span (thread (r, a)
// reads the b values of block row a of its block: one 16-byte load for
// b = 4 in f32), so every load coalesces.
//
// In both, x is gathered (x stays in the 50 MB L2 at the sizes the solve
// runs), and a code with its sign bit set opens a new chunk: the thread
// sums a chunk's products into a partial and adds the partial to the row
// at the chunk's end, in the planes' (chunk, slot) order, so the result
// equals the planes' plain version bit for bit (the dropped lanes'
// products are exact zeros for finite x, added to a row sum that is never
// -0).  A code of -1 is slice padding (it trails the row's entries).
//
// Both accumulate in x's type (bf16 value planes widen to f32), round
// each product and sum on their own (no fused multiply-add), write each
// row through the inverse of the bin permutation, row_of_pos (or p itself
// when the permutation is the identity), with no atomics; they launch on
// the caller's stream, allocate nothing, and the launchers return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kCompactWarps = 4;  // compact slices (warps) per CTA
constexpr int kBatch = 8;         // B4: slots loaded ahead of their adds

// type codes shared with the Python wrapper (ops/binned_spmv.py)
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

// Products and sums rounded one at a time (no fused multiply-add): the
// kernels then reproduce their plain versions bit for bit, whose torch
// multiply and add round separately.
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

// ---------------------------------------------------------------- B5

// The B values of one block row, p 16-byte aligned for B = 4 in f32 and
// B = 2 or 4 in f64, 8-byte aligned for B = 2 in f32 and B = 4 in bf16:
// one (or two) vector loads where the width allows, else B scalar loads.
template <typename V, int B>
struct RowLoad {
  static __device__ __forceinline__ void run(const V* __restrict__ p,
                                             V (&v)[B]) {
#pragma unroll
    for (int c = 0; c < B; ++c) v[c] = __ldg(p + c);
  }
};

template <>
struct RowLoad<float, 4> {
  static __device__ __forceinline__ void run(const float* __restrict__ p,
                                             float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

template <>
struct RowLoad<float, 2> {
  static __device__ __forceinline__ void run(const float* __restrict__ p,
                                             float (&v)[2]) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
};

template <>
struct RowLoad<double, 2> {
  static __device__ __forceinline__ void run(const double* __restrict__ p,
                                             double (&v)[2]) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
};

template <>
struct RowLoad<double, 4> {
  static __device__ __forceinline__ void run(const double* __restrict__ p,
                                             double (&v)[4]) {
    const double2 q0 = __ldg(reinterpret_cast<const double2*>(p));
    const double2 q1 = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
  }
};

template <>
struct RowLoad<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void run(
      const __nv_bfloat16* __restrict__ p, __nv_bfloat16 (&v)[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
};

template <typename V, typename X, int B>
__global__ void __launch_bounds__(kCompactWarps * kWarp)
    binned_compact_kernel(const int32_t* __restrict__ codes,
                          const V* __restrict__ vals,
                          const int32_t* __restrict__ slice_ptr,
                          const int32_t* __restrict__ row_of_pos,
                          int64_t n_rows, int64_t n_pos, int64_t n_slices,
                          const X* __restrict__ x, X* __restrict__ y) {
  constexpr int S = kWarp / B;
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * kCompactWarps + threadIdx.x / kWarp;
  const int l = threadIdx.x % kWarp;
  const int r = l / B;
  const int a = l % B;
  if (slice >= n_slices || r >= S) return;
  const int64_t p = slice * S + r;
  if (p >= n_pos) return;
  const int64_t row =
      row_of_pos != nullptr ? row_of_pos[p] : (p < n_rows ? p : -1);
  if (row < 0) return;  // padding position: no entry, nothing to write
  const int64_t k_end = slice_ptr[slice + 1];
  X acc = X(0);
  X part = X(0);
  bool open = false;
#pragma unroll 4
  for (int64_t k = slice_ptr[slice]; k < k_end; ++k) {
    const int64_t e = k * S + r;
    const int32_t raw = __ldg(codes + e);
    if (raw != -1) {
      const int64_t col = raw & 0x7fffffff;
      V v[B];
      RowLoad<V, B>::run(vals + e * (B * B) + a * B, v);
      X pa = mul(widen<X>(v[0]), __ldg(x + col * B));
#pragma unroll
      for (int c = 1; c < B; ++c)
        pa = add(pa, mul(widen<X>(v[c]), __ldg(x + col * B + c)));
      if (raw < 0) {
        if (open) acc = add(acc, part);
        part = pa;
        open = true;
      } else {
        part = add(part, pa);
      }
    }
  }
  if (open) acc = add(acc, part);
  y[row * B + a] = acc;
}

template <typename V, typename X, int B>
int launch_b5(const void* codes, const void* vals, const void* slice_ptr,
              const void* row_of_pos, int64_t n_rows, int64_t n_pos,
              int64_t n_slices, const void* x, void* y, cudaStream_t stream) {
  const int64_t blocks = (n_slices + kCompactWarps - 1) / kCompactWarps;
  binned_compact_kernel<V, X, B><<<static_cast<unsigned int>(blocks),
                                   kCompactWarps * kWarp, 0, stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const V*>(vals),
      static_cast<const int32_t*>(slice_ptr),
      static_cast<const int32_t*>(row_of_pos), n_rows, n_pos, n_slices,
      static_cast<const X*>(x), static_cast<X*>(y));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- B4

template <typename T>
__global__ void __launch_bounds__(kCompactWarps * kWarp)
    binned_compact_scalar_kernel(const int32_t* __restrict__ codes,
                                 const T* __restrict__ vals,
                                 const int32_t* __restrict__ slice_ptr,
                                 const int32_t* __restrict__ row_of_pos,
                                 int64_t n_rows, int64_t n_pos,
                                 int64_t n_slices, const T* __restrict__ x,
                                 T* __restrict__ y) {
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * kCompactWarps + threadIdx.x / kWarp;
  const int r = threadIdx.x % kWarp;
  if (slice >= n_slices) return;
  const int64_t p = slice * kWarp + r;
  if (p >= n_pos) return;
  const int64_t row =
      row_of_pos != nullptr ? row_of_pos[p] : (p < n_rows ? p : -1);
  if (row < 0) return;  // padding position: no entry, nothing to write
  const int64_t k_end = slice_ptr[slice + 1];
  T acc = T(0);
  T part = T(0);
  bool open = false;
  for (int64_t k = slice_ptr[slice]; k < k_end; k += kBatch) {
    int32_t raw[kBatch];
    T v[kBatch];
    T xv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      raw[u] = k + u < k_end ? __ldg(codes + (k + u) * kWarp + r) : -1;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      v[u] = T(0);
      xv[u] = T(0);
      if (raw[u] != -1) {
        v[u] = __ldg(vals + (k + u) * kWarp + r);
        xv[u] = __ldg(x + (raw[u] & 0x7fffffff));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (raw[u] == -1) continue;
      const T pk = mul(v[u], xv[u]);
      if (raw[u] < 0) {
        if (open) acc = add(acc, part);
        part = pk;
        open = true;
      } else {
        part = add(part, pk);
      }
    }
  }
  if (open) acc = add(acc, part);
  y[row] = acc;
}

template <typename T>
int launch_b4(const void* codes, const void* vals, const void* slice_ptr,
              const void* row_of_pos, int64_t n_rows, int64_t n_pos,
              int64_t n_slices, const void* x, void* y, cudaStream_t stream) {
  const int64_t blocks = (n_slices + kCompactWarps - 1) / kCompactWarps;
  binned_compact_scalar_kernel<T><<<static_cast<unsigned int>(blocks),
                                    kCompactWarps * kWarp, 0, stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const T*>(vals),
      static_cast<const int32_t*>(slice_ptr),
      static_cast<const int32_t*>(row_of_pos), n_rows, n_pos, n_slices,
      static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X>
int launch_compact(int b, const void* codes, const void* vals,
                   const void* slice_ptr, const void* row_of_pos,
                   int64_t n_rows, int64_t n_pos, int64_t n_slices,
                   const void* x, void* y, cudaStream_t s) {
  switch (b) {
    case 2:
      return launch_b5<V, X, 2>(codes, vals, slice_ptr, row_of_pos, n_rows,
                                n_pos, n_slices, x, y, s);
    case 3:
      return launch_b5<V, X, 3>(codes, vals, slice_ptr, row_of_pos, n_rows,
                                n_pos, n_slices, x, y, s);
    case 4:
      return launch_b5<V, X, 4>(codes, vals, slice_ptr, row_of_pos, n_rows,
                                n_pos, n_slices, x, y, s);
    case 5:
      return launch_b5<V, X, 5>(codes, vals, slice_ptr, row_of_pos, n_rows,
                                n_pos, n_slices, x, y, s);
    default:
      return -1;
  }
}

}  // namespace

// Plain C interface, loaded through ctypes.  Returns 0 on success, a
// cudaError_t code when the launch was refused, or -1 for arguments the
// kernel does not take.
//
// b = 1 (B4) in (f32, f32) and (f64, f64); b in 2..5 (B5) in (f32, f32),
// (bf16, f32) and (f64, f64); over the compact pack (codes, vals,
// slice_ptr of n_slices + 1 entries).  n_pos is the count of padded
// positions (n_tiles * 128), row_of_pos the original row of every padded
// position (-1 for padding) or null for an identity permutation.
extern "C" int amgx_binned_compact_spmv(int vals_type, int x_type, int b,
                                        const void* codes, const void* vals,
                                        const void* slice_ptr,
                                        const void* row_of_pos,
                                        int64_t n_rows, int64_t n_pos,
                                        int64_t n_slices, const void* x,
                                        void* y, void* stream) {
  if (b < 1 || b > 5 || n_rows < 0 || n_pos < 0 || n_slices < 0 ||
      (n_slices + kCompactWarps - 1) / kCompactWarps >= (1LL << 31))
    return -1;
  if (n_slices == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 1) {
    if (vals_type == kF32 && x_type == kF32)
      return launch_b4<float>(codes, vals, slice_ptr, row_of_pos, n_rows,
                              n_pos, n_slices, x, y, s);
    if (vals_type == kF64 && x_type == kF64)
      return launch_b4<double>(codes, vals, slice_ptr, row_of_pos, n_rows,
                               n_pos, n_slices, x, y, s);
    return -1;
  }
  if (vals_type == kF32 && x_type == kF32)
    return launch_compact<float, float>(b, codes, vals, slice_ptr,
                                        row_of_pos, n_rows, n_pos, n_slices,
                                        x, y, s);
  if (vals_type == kBF16 && x_type == kF32)
    return launch_compact<__nv_bfloat16, float>(b, codes, vals, slice_ptr,
                                                row_of_pos, n_rows, n_pos,
                                                n_slices, x, y, s);
  if (vals_type == kF64 && x_type == kF64)
    return launch_compact<double, double>(b, codes, vals, slice_ptr,
                                          row_of_pos, n_rows, n_pos,
                                          n_slices, x, y, s);
  return -1;
}

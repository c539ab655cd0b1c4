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
// Bound on this card: memory.  One SpMV must read the planes (codes once,
// b*b value planes) and x once and write y once:
//   bytes = L * (4 + b*b*sizeof(V)) + (n_cols + n) * b * sizeof(X)
// against 2 * b*b * L flops (1 - 2 flop/byte): far under the ridge point.
// Over the stored blocks alone (the bound a sparse product must pay
// whatever its layout) the bytes are nnz_blocks * (4 + b*b*sizeof(V));
// the ratio of the two is the pack's padding factor.
//
// Design: the TPU kernels' one-hot MXU picks, bf16x3 splits, (SB*128)-
// column x segments and VMEM staging exist because a TPU has no gather;
// Hopper has one.  One CTA of 128 threads serves one 128-row output
// tile, one thread one row.  The chunk list is tile-sorted, so a tile's
// chunks are one contiguous range, tile_ptr[tile] .. tile_ptr[tile+1]
// (derived once at upload).  Thread t reads codes/vals at lane =
// block * 1024 + slot * 128 + t: consecutive threads read consecutive
// lanes, so every plane load coalesces.  It gathers x[code*b + c]
// (x is small enough to stay in the 50 MB L2 at the sizes the solve
// runs), accumulates the b outputs in registers in x's type (bf16 value
// planes widen to f32), and writes its row through the inverse of the
// bin permutation, row_of_pos (or p itself when the permutation is the
// identity): no atomics, so the summation order is fixed and the result
// does not depend on scheduling; with no fused multiply-add it equals the
// plain version's bit for bit.  The slot loop is unrolled, so a
// thread has its 8 lanes' loads in flight together.  The kernel
// launches on the caller's stream, allocates nothing, and the launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;   // rows per tile = threads per CTA
constexpr int kSlots = 8;    // slot columns per chunk
constexpr int kChunk = kSlots * kTile;

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
// kernel then reproduces its plain version bit for bit, whose torch
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

template <typename V, typename X, int B>
__global__ void __launch_bounds__(kTile)
    binned_spmv_kernel(const int32_t* __restrict__ codes,
                       const V* __restrict__ vals, int64_t L,
                       const int32_t* __restrict__ chunk_blk,
                       const int32_t* __restrict__ tile_ptr,
                       const int32_t* __restrict__ row_of_pos,
                       int64_t n_rows, const X* __restrict__ x,
                       X* __restrict__ y) {
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t p = static_cast<int64_t>(tile) * kTile + t;
  const int64_t row =
      row_of_pos != nullptr ? row_of_pos[p] : (p < n_rows ? p : -1);
  if (row < 0) return;  // padding row: nothing to write, no sync follows
  X acc[B];
#pragma unroll
  for (int a = 0; a < B; ++a) acc[a] = X(0);
  const int c_end = tile_ptr[tile + 1];
  for (int c = tile_ptr[tile]; c < c_end; ++c) {
    const int64_t base = static_cast<int64_t>(chunk_blk[c]) * kChunk + t;
    X part[B];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int64_t lane = base + k * kTile;
      const int64_t col = __ldg(codes + lane);
      X xv[B];
#pragma unroll
      for (int cc = 0; cc < B; ++cc) xv[cc] = __ldg(x + col * B + cc);
#pragma unroll
      for (int a = 0; a < B; ++a) {
        X pa = mul(widen<X>(__ldg(vals + (a * B) * L + lane)), xv[0]);
#pragma unroll
        for (int cc = 1; cc < B; ++cc)
          pa = add(pa, mul(widen<X>(__ldg(vals + (a * B + cc) * L + lane)),
                           xv[cc]));
        part[a] = k == 0 ? pa : add(part[a], pa);
      }
    }
#pragma unroll
    for (int a = 0; a < B; ++a) acc[a] = add(acc[a], part[a]);
  }
#pragma unroll
  for (int a = 0; a < B; ++a) y[row * B + a] = acc[a];
}

template <typename V, typename X, int B>
int launch_b(const void* codes, const void* vals, int64_t L,
             const void* chunk_blk, const void* tile_ptr,
             const void* row_of_pos, int64_t n_rows, int64_t n_tiles,
             const void* x, void* y, cudaStream_t stream) {
  binned_spmv_kernel<V, X, B><<<static_cast<unsigned int>(n_tiles), kTile,
                                0, stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const V*>(vals), L,
      static_cast<const int32_t*>(chunk_blk),
      static_cast<const int32_t*>(tile_ptr),
      static_cast<const int32_t*>(row_of_pos), n_rows,
      static_cast<const X*>(x), static_cast<X*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X>
int launch(int b, const void* codes, const void* vals, int64_t L,
           const void* chunk_blk, const void* tile_ptr,
           const void* row_of_pos, int64_t n_rows, int64_t n_tiles,
           const void* x, void* y, cudaStream_t s) {
  switch (b) {
    case 2:
      return launch_b<V, X, 2>(codes, vals, L, chunk_blk, tile_ptr,
                               row_of_pos, n_rows, n_tiles, x, y, s);
    case 3:
      return launch_b<V, X, 3>(codes, vals, L, chunk_blk, tile_ptr,
                               row_of_pos, n_rows, n_tiles, x, y, s);
    case 4:
      return launch_b<V, X, 4>(codes, vals, L, chunk_blk, tile_ptr,
                               row_of_pos, n_rows, n_tiles, x, y, s);
    case 5:
      return launch_b<V, X, 5>(codes, vals, L, chunk_blk, tile_ptr,
                               row_of_pos, n_rows, n_tiles, x, y, s);
    default:
      return -1;
  }
}

}  // namespace

// Plain C interface, loaded through ctypes.  b = 1 runs B4 in (f32, f32)
// and (f64, f64); b in 2..5 runs B5 in (f32, f32), (bf16, f32) and
// (f64, f64).  chunk_blk is the plane block of every chunk (bn_meta[C:2C]),
// tile_ptr the tile's chunk range (n_tiles + 1 entries), row_of_pos the
// original row of every padded position (-1 for padding) or null for an
// identity permutation.  Returns 0 on success, a cudaError_t code when the
// launch was refused, or -1 for arguments the kernel does not take.
extern "C" int amgx_binned_spmv(int vals_type, int x_type, int b,
                                const void* codes, const void* vals,
                                int64_t L, const void* chunk_blk,
                                const void* tile_ptr,
                                const void* row_of_pos, int64_t n_rows,
                                int64_t n_tiles, const void* x, void* y,
                                void* stream) {
  if (L < 0 || n_rows < 0 || n_tiles < 0 || n_tiles >= (1LL << 31))
    return -1;
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 1) {
    if (vals_type == kF32 && x_type == kF32)
      return launch_b<float, float, 1>(codes, vals, L, chunk_blk, tile_ptr,
                                       row_of_pos, n_rows, n_tiles, x, y,
                                       s);
    if (vals_type == kF64 && x_type == kF64)
      return launch_b<double, double, 1>(codes, vals, L, chunk_blk,
                                         tile_ptr, row_of_pos, n_rows,
                                         n_tiles, x, y, s);
    return -1;
  }
  if (vals_type == kF32 && x_type == kF32)
    return launch<float, float>(b, codes, vals, L, chunk_blk, tile_ptr,
                                row_of_pos, n_rows, n_tiles, x, y, s);
  if (vals_type == kBF16 && x_type == kF32)
    return launch<__nv_bfloat16, float>(b, codes, vals, L, chunk_blk,
                                        tile_ptr, row_of_pos, n_rows,
                                        n_tiles, x, y, s);
  if (vals_type == kF64 && x_type == kF64)
    return launch<double, double>(b, codes, vals, L, chunk_blk, tile_ptr,
                                  row_of_pos, n_rows, n_tiles, x, y, s);
  return -1;
}

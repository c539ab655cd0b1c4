// Tile-DIA (shift) SpMV for Hopper (sm_90a): kernel B2 over the
// slice-masked compact pack.
//
// Replaces the TPU kernel amgx_tpu/ops/pallas_shift.py::_shift_call
// (pallas_call at :187): rows are cut into tiles of T rows; within tile
// t the entries fall into Dpad class slots of one column difference
// d[t, j] each, and
//   y[r] = sum_j vals[t, j, r mod T] * x[r + d[t, j]],  t = r / T,
// summed over the slots in slot order, a slot contributing 0 where
// r + d lies outside [0, n_cols).
//
// The kernel reads no class plane.  The compact pack
// (ops/shift_spmv.py::shift_compact, derived from the planes at upload)
// cuts each tile into slices of 32 rows (T is a multiple of 128, so no
// slice straddles a tile).  mask[s] has bit j set when a row of slice s
// holds a nonzero value in slot j; ptr[s] counts the set bits of the
// slices before s; the slice's 32 values of its k-th set bit, in
// ascending slot order, sit at vals[(ptr[s] + k) * 32 + lane].  Every
// dropped slot's products are exact zeros, and adding one changes no row
// sum (it starts at +0 and is never -0), so for finite x the result is
// the planes' plain version bit for bit.
//
// Bound on this card: memory.  One SpMV must read the compact values,
// the mask and pointer words, the diff table, x once and write y once:
//   bytes = slots * 32 * sizeof(T) + 8 * n_slices + 4 * n_tiles * Dpad
//           + (n_cols + n) * sizeof(T)
// against 2 * slots * 32 flops, far under the ridge point.  The planes
// held Dpad slots a row (16 on the DFG cylinder operator) where a 32-row
// slice of it uses about 5, as many as its rows store entries: the
// compact bound is within 1 % of the stored entries' bound there.
//
// Design.  One warp a slice, 4 warps a CTA.  Lane j loads the diff of
// slot j of its tile into a register (one 128-byte read a warp; the
// whole table is at most 32 words, so no shared memory and no barrier
// are needed, and a CTA may span two tiles), the mask and the pointer
// are one broadcast load each, and for each set bit the warp shuffles
// the slot's diff from its lane.  The 32 values of a set bit are one
// coalesced span (128 bytes in f32) and the x gather x[r + d] is
// contiguous across the warp.  One set bit at a time a lane would wait
// a memory latency per bit, so it issues the value and x loads of up to
// kBatch set bits before its first add, then sums them in slot order.
// kBatch = 4 (two batches for the DFG slices' 5 bits) keeps a thread
// under 40 registers, so an SM holds more warps than at 8, which
// measured faster in both types; so did 4 warps a CTA against 8 (the
// last wave is finer).  Staging a CTA's values in shared memory with
// asynchronous copies, walking slices in a persistent grid with the next
// header prefetched, several slices a warp, and every slice's first
// batch in flight before any add all measured slower (PERF.md).
//
// The TPU kernel DMAs a 128-lane-aligned x window per class and
// stitches the unaligned view with two lane rolls and a lane mask
// (pallas_shift.py:12-21), because Mosaic refuses unaligned dynamic
// slices, and it streams whole (T/128, 128) planes because its vector
// unit has no gather.  Hopper loads x at any address and a warp's 32
// rows at any slot, so none of that has a counterpart here.
//
// The kernel checks the column range per lane (it never reads x out of
// bounds, whatever the pack holds), rounds each product and each sum on
// its own (no fused multiply-add, no atomics), writes the rows below n
// only, launches on the caller's stream, allocates nothing, and the
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
// warps (slices) a CTA, and set bits whose loads a lane issues before
// its first add
constexpr int kWarps = 4;
constexpr int kBatch = 4;
// the pack never gives more than 32 classes a tile (Dpad <= 32)
constexpr int kMaxSlots = 32;
constexpr unsigned kFull = 0xffffffffu;

// type codes shared with the Python wrapper (ops/shift_spmv.py)
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

template <typename T>
__global__ void __launch_bounds__(kWarps * kWarp)
    shift_compact_kernel(const T* __restrict__ vals,
                         const uint32_t* __restrict__ mask,
                         const int32_t* __restrict__ ptr,
                         const int32_t* __restrict__ diffs,
                         const T* __restrict__ x, T* __restrict__ y,
                         int64_t n, int64_t n_cols, int64_t n_slices,
                         int slices_per_tile, int dpad) {
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  if (slice >= n_slices) return;  // the whole warp: shuffles stay full
  const int lane = static_cast<int>(threadIdx.x % kWarp);
  const int64_t row = slice * kWarp + lane;
  const bool live_row = row < n;
  const int64_t tile = slice / slices_per_tile;
  // three independent loads: the tile's diffs one a lane, the slice's
  // mask and pointer words broadcast
  const int32_t my_diff = lane < dpad ? __ldg(diffs + tile * dpad + lane) : 0;
  uint32_t m = __ldg(mask + slice);  // the same on every lane
  const T* v = vals + static_cast<int64_t>(__ldg(ptr + slice)) * kWarp + lane;
  T acc = T(0);
  while (m != 0) {
    // up to kBatch set bits, lowest first: every value and x load in
    // flight before the first add
    T a[kBatch];
    T b[kBatch];
    bool on[kBatch];
    bool in[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      on[u] = m != 0;
      const int j = on[u] ? __ffs(static_cast<int>(m)) - 1 : 0;
      m &= m - 1;
      const int64_t c = row + __shfl_sync(kFull, my_diff, j);
      in[u] = on[u] && live_row && c >= 0 && c < n_cols;
      a[u] = T(0);
      b[u] = T(0);
      if (in[u]) {
        a[u] = __ldg(v + u * kWarp);
        b[u] = __ldg(x + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (on[u]) acc = add(acc, in[u] ? mul(a[u], b[u]) : T(0));
    v += kBatch * kWarp;
  }
  if (live_row) y[row] = acc;
}

template <typename T>
int launch(const void* vals, const void* mask, const void* ptr,
           const int32_t* diffs, const void* x, void* y, int64_t n,
           int64_t n_cols, int tile_rows, int n_tiles, int dpad,
           cudaStream_t stream) {
  const int64_t n_slices = static_cast<int64_t>(n_tiles) * (tile_rows / kWarp);
  const int64_t blocks = (n_slices + kWarps - 1) / kWarps;
  shift_compact_kernel<T><<<static_cast<unsigned int>(blocks),
                            kWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const uint32_t*>(mask),
      static_cast<const int32_t*>(ptr), diffs, static_cast<const T*>(x),
      static_cast<T*>(y), n, n_cols, n_slices, tile_rows / kWarp, dpad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded through ctypes.  Returns 0 on success, a
// cudaError_t code when the launch was refused, or -1 for arguments the
// kernel does not take (sizes out of range, a tile that is not a whole
// number of 32-row slices, more than 32 slots, an unsupported type
// pair).  vals, mask (int32 words read unsigned) and ptr are the compact
// pack of n_tiles * tile_rows / 32 slices; diffs the (n_tiles, dpad)
// int32 class differences.
extern "C" int amgx_shift_spmv(int vals_type, int x_type, const void* vals,
                               const void* mask, const void* ptr,
                               const void* diffs, const void* x, void* y,
                               int64_t n, int64_t n_cols, int tile_rows,
                               int n_tiles, int dpad, void* stream) {
  if (n < 0 || n_cols < 0 || tile_rows <= 0 || tile_rows % kWarp != 0 ||
      n_tiles < 0 || dpad < 0 || dpad > kMaxSlots ||
      static_cast<int64_t>(tile_rows) * n_tiles < n ||
      static_cast<int64_t>(n_tiles) * (tile_rows / kWarp) / kWarps >=
          (1LL << 31))
    return -1;
  if (n == 0) return 0;
  const int32_t* d = static_cast<const int32_t*>(diffs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_type == kF32 && x_type == kF32)
    return launch<float>(vals, mask, ptr, d, x, y, n, n_cols, tile_rows,
                         n_tiles, dpad, s);
  if (vals_type == kF64 && x_type == kF64)
    return launch<double>(vals, mask, ptr, d, x, y, n, n_cols, tile_rows,
                          n_tiles, dpad, s);
  return -1;
}

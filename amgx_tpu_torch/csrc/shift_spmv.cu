// Tile-DIA (shift) SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel amgx_tpu/ops/pallas_shift.py::_shift_call
// (pallas_call at :187): rows are cut into tiles of T rows; within tile
// t the entries fall into Dpad class slots of one column difference
// d[t, j] each, and
//   y[r] = sum_j vals[t, j, r mod T] * x[r + d[t, j]],  t = r / T,
// summed over the slots in slot order, a slot contributing 0 where
// r + d lies outside [0, n_cols).  Unused slots carry value 0 and a
// difference that puts every row of the tile left of column 0.
//
// Bound on this card: memory.  One SpMV must read the class planes once,
// the diff table once, x once and write y once:
//   bytes = n_tiles * Dpad * T * sizeof(T) + 4 * n_tiles * Dpad
//           + (n_cols + n) * sizeof(T)
// against 2 * n_tiles * Dpad * T flops: 0.25 flop/byte in f32, far under
// the card's ridge point.  The planes hold Dpad slots a row where the
// matrix stores a few entries (16 against about 5 for a 2-D 5-point
// operator), so the bound over the stored entries alone is tighter; both
// are reported beside the kernel's time.
//
// Design: the TPU kernel DMAs a 128-lane-aligned x window per class and
// stitches the unaligned view with two lane rolls and a lane mask,
// because Mosaic refuses unaligned dynamic slices.  Hopper reads x at any
// address, so none of that is carried over: one thread per row, CTAs of
// 256 rows inside a tile (T / 256 CTAs a tile, so a 1.4 M-row operator
// gives thousands of CTAs for 132 SMs).  A CTA stages its tile's Dpad
// differences in shared memory, then loops over the slots: the slot's
// values of 256 consecutive rows are one contiguous, coalesced read, and
// x[r + d] for those rows is contiguous too.  The kernel checks the
// column range itself (it never reads x out of bounds, whatever the
// padding holds), rounds each product and each sum on its own (no fused
// multiply-add), so it reproduces its plain version bit for bit,
// launches on the caller's stream, allocates nothing, and the launcher
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// the pack never gives more than 32 classes a tile (Dpad <= 32)
constexpr int kMaxSlots = 32;

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
__global__ void __launch_bounds__(kThreads)
    shift_spmv_kernel(const T* __restrict__ vals,
                      const int32_t* __restrict__ diffs,
                      const T* __restrict__ x, T* __restrict__ y,
                      int64_t n, int64_t n_cols, int tile_rows,
                      int blocks_per_tile, int dpad) {
  __shared__ int32_t sdiff[kMaxSlots];
  const int tile = blockIdx.x / blocks_per_tile;
  const int local =
      (blockIdx.x % blocks_per_tile) * kThreads + static_cast<int>(threadIdx.x);
  if (static_cast<int>(threadIdx.x) < dpad)
    sdiff[threadIdx.x] =
        diffs[static_cast<int64_t>(tile) * dpad + threadIdx.x];
  __syncthreads();
  const int64_t row = static_cast<int64_t>(tile) * tile_rows + local;
  if (local >= tile_rows || row >= n) return;
  const T* v = vals + static_cast<int64_t>(tile) * dpad * tile_rows + local;
  T acc = T(0);
  for (int j = 0; j < dpad; ++j) {
    const int64_t c = row + sdiff[j];
    const T p = (c >= 0 && c < n_cols)
                    ? mul(v[static_cast<int64_t>(j) * tile_rows], __ldg(x + c))
                    : T(0);
    acc = add(acc, p);
  }
  y[row] = acc;
}

template <typename T>
int launch(const void* vals, const int32_t* diffs, const void* x, void* y,
           int64_t n, int64_t n_cols, int tile_rows, int n_tiles, int dpad,
           cudaStream_t stream) {
  const int per_tile = (tile_rows + kThreads - 1) / kThreads;
  const int64_t blocks = static_cast<int64_t>(per_tile) * n_tiles;
  shift_spmv_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                         stream>>>(
      static_cast<const T*>(vals), diffs, static_cast<const T*>(x),
      static_cast<T*>(y), n, n_cols, tile_rows, per_tile, dpad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded through ctypes.  Returns 0 on success, a
// cudaError_t code when the launch was refused, or -1 for arguments the
// kernel does not take (sizes out of range, more than 32 slots, an
// unsupported type pair).
extern "C" int amgx_shift_spmv(int vals_type, int x_type, const void* vals,
                               const void* diffs, const void* x, void* y,
                               int64_t n, int64_t n_cols, int tile_rows,
                               int n_tiles, int dpad, void* stream) {
  if (n < 0 || n_cols < 0 || tile_rows <= 0 || n_tiles < 0 || dpad < 0 ||
      dpad > kMaxSlots || static_cast<int64_t>(tile_rows) * n_tiles < n)
    return -1;
  if (n == 0) return 0;
  const int32_t* d = static_cast<const int32_t*>(diffs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_type == kF32 && x_type == kF32)
    return launch<float>(vals, d, x, y, n, n_cols, tile_rows, n_tiles, dpad,
                         s);
  if (vals_type == kF64 && x_type == kF64)
    return launch<double>(vals, d, x, y, n, n_cols, tile_rows, n_tiles, dpad,
                          s);
  return -1;
}

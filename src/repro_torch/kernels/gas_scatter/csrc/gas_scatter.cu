// FAST-GAS scatter-reduce kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gas_scatter/kernel.py:
//   * gas_scatter_banded  (kernel.py:211; bodies _sched_add_kernel,
//     _sched_addw_kernel, _sched_cmp_kernel, _sched_live, _add_round,
//     _cmp_round) -> banded_kernel below, the scheduled walk;
//   * gas_scatter_pallas  (kernel.py:266; bodies _gas_add_kernel,
//     _gas_addw_kernel, _gas_cmp_kernel) -> dense_kernel below, the dense grid
//     gated by the occupancy bitmap.
//
// Both compute out[r, f] = reduce_{e : dst[e] == r} w[e] * values[e, f] for
// op = add (w = 1 without weights), or the max / min of values[e, f] over the
// same edges; rows with no edge hold the identity (0, -inf, +inf). Dead edges
// carry dst = n_rows (the padded row count) and so match no row. A NaN value
// on a matched edge makes its row's max / min NaN, as jnp.maximum / minimum
// and scatter_reduce's amax / amin do (fmaxf / fminf would drop it).
//
// What bounds it: memory. One pass moves the value stream E*F*4 bytes, the
// ids and weights E*8 bytes, and writes n_rows*F*4 bytes; at 3.35 TB/s that
// is the floor. The arithmetic is one FMA (or one compare) per value.
//
// Design. The TPU kernel keeps a 128-row output block resident in VMEM while
// edge tiles stream past it, contracting one-hot CAM match lines on the MXU.
// Here one CTA owns one (128-row block x 32-feature block) tile of the
// output, kept as a float accumulator in shared memory, and loops over the
// edge tiles of its run inside the CTA, so no atomics and no second pass
// are needed. Per 128-edge tile the CTA stages the tile's relative dst ids
// and weights in shared memory, then the (128 x 32) value block of the
// edges that match one of its rows: every load of the block is issued
// before any is consumed, one 128-byte coalesced segment per warp and row,
// so the tile costs one memory latency rather than one per edge. Warp k of
// 8 then applies the edges whose row r has r % 8 == k, its 32 lanes
// spanning the feature block; each (row, feature) cell has exactly one
// writer: no races, and every row sums its edges in stream order. The
// match is a plain compare, not a one-hot product: no tensor cores and no
// TF32, so integer-valued data stays exact.
//
// The banded walk: the work list (W, 4 [+ F/32]) int32 holds rows
// [row_block, tile, live, init, feature-block live...] ordered by row
// block, and each row block's rows form one contiguous run that starts at
// its init row. The CTA of row block rb finds its run by binary search on
// column 0, starts from the identity (the init row), and visits the live
// rows; for add, a zero feature-block liveness flag skips the round, which
// is exact since zero is add's identity.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRowBlock = 128;
constexpr int kEdgeTile = 128;
constexpr int kFeatBlock = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

enum Op { kAdd = 0, kMax = 1, kMin = 2 };

__device__ __forceinline__ float identity(int op) {
  return op == kAdd ? 0.0f : (op == kMax ? -CUDART_INF_F : CUDART_INF_F);
}

struct Tile {
  float acc[kRowBlock * kFeatBlock];  // [row][feature] of the output tile
  float val[kEdgeTile * kFeatBlock];  // [edge][feature] of the value block
  int rel[kEdgeTile];                 // the edge tile's dst - row0
  float w[kEdgeTile];                 // its edge weights (1 without weights)
};

__device__ __forceinline__ void fill_identity(Tile& s, int op) {
  const float v = identity(op);
  for (int i = threadIdx.x; i < kRowBlock * kFeatBlock; i += kThreads) s.acc[i] = v;
}

// One (row block x edge tile) round; f0 is the CTA's first feature.
__device__ __forceinline__ void tile_round(Tile& s, int op, const int* dst,
                                           const float* weights,
                                           const float* values, long long F,
                                           int f0, long long tile, int row0) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // the previous round has finished with s.rel / s.val
  if (threadIdx.x < kEdgeTile) {
    const long long e = tile * kEdgeTile + threadIdx.x;
    s.rel[threadIdx.x] = dst[e] - row0;
    s.w[threadIdx.x] = weights ? weights[e] : 1.0f;
  }
  __syncthreads();
  // all of this warp's loads in flight before the first is stored
  const float* vt = values + tile * kEdgeTile * F + f0 + lane;
  float v[kEdgeTile / kWarps];
#pragma unroll
  for (int i = 0; i < kEdgeTile / kWarps; ++i) {
    const int j = warp + i * kWarps;
    const int r = s.rel[j];
    v[i] = (r >= 0 && r < kRowBlock) ? vt[j * F] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kEdgeTile / kWarps; ++i) {
    s.val[(warp + i * kWarps) * kFeatBlock + lane] = v[i];
  }
  __syncthreads();
  for (int j = 0; j < kEdgeTile; ++j) {
    const int r = s.rel[j];                      // the same for the whole warp
    if (r < 0 || r >= kRowBlock || (r % kWarps) != warp) continue;
    const float v = s.val[j * kFeatBlock + lane];
    float& a = s.acc[r * kFeatBlock + lane];
    if (op == kAdd) {
      a = fmaf(s.w[j], v, a);
    } else if (op == kMax) {
      a = (v > a || v != v) ? v : a;  // a NaN value wins, as in jnp.maximum
    } else {
      a = (v < a || v != v) ? v : a;
    }
  }
}

__device__ __forceinline__ void store_tile(const Tile& s, float* out,
                                           long long F, int f0, int row0) {
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kRowBlock; r += kWarps) {
    out[(long long)(row0 + r) * F + f0 + lane] = s.acc[r * kFeatBlock + lane];
  }
}

// First work row whose row block is >= rb (column 0 ascends).
__device__ __forceinline__ int lower_bound_rows(const int* work, int W,
                                                int ncols, int rb) {
  int lo = 0, hi = W;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (work[(long long)mid * ncols] < rb) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
banded_kernel(const int* __restrict__ work, int W, int ncols,
              const int* __restrict__ dst, const float* __restrict__ weights,
              const float* __restrict__ values, float* __restrict__ out,
              long long F, int op) {
  __shared__ Tile s;
  const int rb = blockIdx.x;
  const int fb = blockIdx.y;
  const int f0 = fb * kFeatBlock;
  const int row0 = rb * kRowBlock;
  const bool feat_skip = ncols > 4;
  const int lo = lower_bound_rows(work, W, ncols, rb);
  const int hi = lower_bound_rows(work, W, ncols, rb + 1);
  fill_identity(s, op);
  for (int i = lo; i < hi; ++i) {
    const int* row = work + (long long)i * ncols;
    if (row[2] != 1) continue;
    if (feat_skip && row[4 + fb] != 1) continue;
    tile_round(s, op, dst, weights, values, F, f0, row[1], row0);
  }
  store_tile(s, out, F, f0, row0);
}

__global__ void __launch_bounds__(kThreads)
dense_kernel(const int* __restrict__ occ, int T, const int* __restrict__ dst,
             const float* __restrict__ weights,
             const float* __restrict__ values, float* __restrict__ out,
             long long F, int op) {
  __shared__ Tile s;
  const int rb = blockIdx.x;
  const int f0 = blockIdx.y * kFeatBlock;
  const int row0 = rb * kRowBlock;
  fill_identity(s, op);
  for (int t = 0; t < T; ++t) {
    if (occ[(long long)rb * T + t] > 0) {
      tile_round(s, op, dst, weights, values, F, f0, t, row0);
    }
  }
  store_tile(s, out, F, f0, row0);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Shapes: dst (E,), weights (E,)
// or null, values (E, F), out (n_rows, F); E % 128 == 0, F % 32 == 0,
// n_rows % 128 == 0. Each returns cudaGetLastError() after its launch.
extern "C" int gas_scatter_banded_f32(const int* work, int W, int ncols,
                                      const int* dst, const float* weights,
                                      const float* values, float* out,
                                      int n_rows, int F, int op,
                                      void* stream) {
  const dim3 grid(n_rows / kRowBlock, F / kFeatBlock);
  banded_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      work, W, ncols, dst, weights, values, out, F, op);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gas_scatter_dense_f32(const int* occ, int T, const int* dst,
                                     const float* weights, const float* values,
                                     float* out, int n_rows, int F, int op,
                                     void* stream) {
  const dim3 grid(n_rows / kRowBlock, F / kFeatBlock);
  dense_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      occ, T, dst, weights, values, out, F, op);
  return static_cast<int>(cudaGetLastError());
}

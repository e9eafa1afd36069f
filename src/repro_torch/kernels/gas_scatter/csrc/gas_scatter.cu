// FAST-GAS scatter-reduce kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gas_scatter/kernel.py:
//   * gas_scatter_banded  (kernel.py:211; bodies _sched_add_kernel,
//     _sched_addw_kernel, _sched_cmp_kernel, _sched_live, _add_round,
//     _cmp_round) -> banded_cluster_kernel below, the scheduled walk;
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
// is the floor. The arithmetic is one FMA (or one compare) per value. At the
// sizes the serving and inference paths launch (one 128-row block, 2-7 edge
// tiles) the floor is under a microsecond, so what sets the time is how
// many SMs work at once and how many memory latencies lie end to end.
//
// The TPU kernel keeps a 128-row output block resident in VMEM while edge
// tiles stream past it, contracting one-hot CAM match lines on the MXU. The
// match here is a plain compare, not a one-hot product: no tensor cores and
// no TF32, so integer-valued data stays exact.
//
// banded_cluster_kernel. The work list (W, 4 [+ F/32]) int32 holds rows
// [row_block, tile, live, init, feature-block live...] ordered by row
// block; each row block's rows form one contiguous run, found by binary
// search on column 0. A thread-block cluster of C CTAs (C <= 8, the
// portable limit, chosen by the wrapper from W and n_rows) owns one
// (128-row block x 32-feature block) output tile, so one 128-row block
// spreads over C x F/32 CTAs instead of F/32. CTA rank r takes the r-th of
// C contiguous shares of the run and reduces it into its own partial tile
// in shared memory, starting from the identity:
//   * each window of up to 256 work rows is compacted, in order, into the
//     list of its live rounds (live, and for add with liveness columns, a
//     live feature block: zero is add's identity, so the skip is exact)
//     with one __ballot_sync per warp and a prefix over 8 warp counts;
//   * a live round's 128 ids, weights and (128 x 32) value block arrive by
//     cp.async into one of two buffers while the previous round is applied,
//     with one block-wide barrier per round;
//   * warp k owns the rows r with r % 8 == k, its 32 lanes spanning the
//     feature block, so every (row, feature) cell has one writer and no
//     atomics. It finds its own edges of each 32-edge chunk with one ballot
//     and visits only those, in stream order; a run of equal rows (the
//     sorted sampled stream gives long ones) is reduced in a register and
//     flushed to the partial once.
// After cluster.sync() rank r combines rows [128r/C, 128(r+1)/C) of the C
// partials through distributed shared memory in rank order, which is the
// stream order, and writes them out; a second cluster.sync() keeps every
// partial alive until it has been read. No floating atomics anywhere: two
// launches on the same inputs give the same bits, and integer-valued data
// is exact whatever the grouping.
//
// dense_kernel: one CTA per (128-row block x 32-feature block) output tile,
// accumulator in shared memory, looping over every edge tile whose
// occupancy bit is set. Per tile it stages the relative dst ids and weights
// in shared memory, then the (128 x 32) value block of the matching edges
// with every load of a warp in flight before any is stored; warp k of 8
// then applies the edges whose row r has r % 8 == k, scanning all 128 ids.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

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

__device__ __forceinline__ void fill_identity(float* acc, int op) {
  const float v = identity(op);
  for (int i = threadIdx.x; i < kRowBlock * kFeatBlock; i += kThreads) acc[i] = v;
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

// First work row in [a, b) whose row block is >= rb (column 0 ascends); b if
// there is none.
__device__ __forceinline__ int lower_bound_rows(const int* work, int a, int b,
                                                int ncols, int rb) {
  while (a < b) {
    const int mid = (a + b) / 2;
    if (work[(long long)mid * ncols] < rb) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a;
}

__device__ __forceinline__ float combine(int op, float a, float v) {
  if (op == kAdd) return a + v;
  if (op == kMax) return (v > a || v != v) ? v : a;  // a NaN value wins
  return (v < a || v != v) ? v : a;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int kWindow = kThreads;  // work rows compacted per pass
constexpr int kMaxCluster = 8;

struct Banded {
  float acc[kRowBlock * kFeatBlock];     // this CTA's partial [row][feature]
  float val[2][kEdgeTile * kFeatBlock];  // value blocks, double-buffered
  int ids[2][kEdgeTile];                 // their tiles' dst
  float w[2][kEdgeTile];                 // and weights
  int tiles[kWindow];                    // live rounds of the current window
  int count[kWarps];                     // per-warp counts: rows, then rounds
  int count_hi[kWarps];
};

// Row q of the kThreads probes of column 0 that find a run.
__device__ __forceinline__ int probe_row(int q, int W) {
  return static_cast<int>(static_cast<long long>(q) * W / kThreads);
}

__global__ void __launch_bounds__(kThreads)
banded_cluster_kernel(const int* __restrict__ work, int W, int ncols,
                      const int* __restrict__ dst, const float* __restrict__ weights,
                      const float* __restrict__ values, float* __restrict__ out,
                      long long F, int op, int C) {
  extern __shared__ float4 dyn[];
  Banded& s = *reinterpret_cast<Banded*>(dyn);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rb = blockIdx.x / C;
  const int fb = blockIdx.y;
  const int f0 = fb * kFeatBlock;
  const int row0 = rb * kRowBlock;
  const bool feat_skip = ncols > 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // The run [lo, hi) of row block rb, found by one round of kThreads
  // parallel probes of column 0: n probes lie below rb, so the run starts
  // after probe n - 1 and at or before probe n. With W <= kThreads the
  // probes are the rows themselves, and each thread keeps its row's tile
  // and liveness for the compaction below: all of the CTA's metadata costs
  // one memory latency. A longer list ends with a binary search between two
  // probes.
  const bool small = W <= kThreads;
  const int probe = small ? tid : probe_row(tid, W);
  int blk = INT_MAX, tile = 0;
  bool row_live = false;
  if (probe < W) {
    const int* row = work + static_cast<long long>(probe) * ncols;
    blk = row[0];
    if (small) {
      tile = row[1];
      row_live = row[2] == 1 && (!feat_skip || row[4 + fb] == 1);
    }
  }
  const unsigned below_lo = __ballot_sync(0xffffffffu, blk < rb);
  const unsigned below_hi = __ballot_sync(0xffffffffu, blk < rb + 1);
  if (lane == 0) {
    s.count[warp] = __popc(below_lo);
    s.count_hi[warp] = __popc(below_hi);
  }
  fill_identity(s.acc, op);
  __syncthreads();
  int lo = 0, hi = 0;
  for (int k = 0; k < kWarps; ++k) {
    lo += s.count[k];
    hi += s.count_hi[k];
  }
  if (!small) {
    lo = lower_bound_rows(work, lo ? probe_row(lo - 1, W) + 1 : 0,
                          lo < kThreads ? probe_row(lo, W) : W, ncols, rb);
    hi = lower_bound_rows(work, hi ? probe_row(hi - 1, W) + 1 : 0,
                          hi < kThreads ? probe_row(hi, W) : W, ncols, rb + 1);
  }
  // this rank's contiguous share [s0, s1) of the run
  const long long n = hi - lo;
  const int s0 = lo + static_cast<int>(n * rank / C);
  const int s1 = lo + static_cast<int>(n * (rank + 1) / C);

  // cp.async one round's ids, weights and value block into buffer buf
  auto stage = [&](int round_tile, int buf) {
    const long long e0 = static_cast<long long>(round_tile) * kEdgeTile;
    if (tid < kEdgeTile) {
      cp_async4(&s.ids[buf][tid], dst + e0 + tid);
    } else if (weights) {
      cp_async4(&s.w[buf][tid - kEdgeTile], weights + e0 + tid - kEdgeTile);
    }
    const float* src = values + e0 * F + f0;
    constexpr int kParts = kFeatBlock / 4;  // 16-byte pieces per value row
    for (int q = tid; q < kEdgeTile * kParts; q += kThreads) {
      const int e = q / kParts, part = (q % kParts) * 4;
      cp_async16(&s.val[buf][e * kFeatBlock + part], src + e * F + part);
    }
    cp_async_commit();
  };

  // warp `warp` applies its own edges of the round in buffer buf, four at
  // a time: the four edges' loads are in flight before the first is used
  auto apply = [&](int buf) {
    const int* ids = s.ids[buf];
    const float* wt = s.w[buf];
    const float* val = s.val[buf];
    int cur = -1;
    float reg = 0.0f;
    for (int c = 0; c < kEdgeTile; c += 32) {
      const int r = ids[c + lane] - row0;
      unsigned mine = __ballot_sync(0xffffffffu,
                                    r >= 0 && r < kRowBlock && (r % kWarps) == warp);
      while (mine) {
        int e[4], re[4];
        float v[4], w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          e[j] = mine ? c + __ffs(mine) - 1 : -1;
          mine &= mine - 1;
          if (e[j] >= 0) {
            re[j] = ids[e[j]] - row0;
            v[j] = val[e[j] * kFeatBlock + lane];
            w[j] = weights ? wt[e[j]] : 1.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (e[j] < 0) break;
          if (re[j] != cur) {
            if (cur >= 0) s.acc[cur * kFeatBlock + lane] = reg;
            cur = re[j];
            reg = s.acc[cur * kFeatBlock + lane];
          }
          reg = op == kAdd ? fmaf(w[j], v[j], reg) : combine(op, reg, v[j]);
        }
      }
    }
    if (cur >= 0) s.acc[cur * kFeatBlock + lane] = reg;
  };

  // each window of kWindow work rows: compact its live rounds in order,
  // then walk them, the next round loading while this one is applied
  const int windows = small ? 1 : (s1 - s0 + kWindow - 1) / kWindow;
  for (int wi = 0; wi < windows; ++wi) {
    const int i = (small ? 0 : s0 + wi * kWindow) + tid;
    if (!small) {
      tile = 0;
      row_live = false;
      if (i < s1) {
        const int* row = work + static_cast<long long>(i) * ncols;
        tile = row[1];
        row_live = row[2] == 1 && (!feat_skip || row[4 + fb] == 1);
      }
    }
    const bool live = row_live && i >= s0 && i < s1;
    __syncthreads();  // s.count and s.tiles are read; the last window is applied
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s.count[warp] = __popc(m);
    __syncthreads();
    int off = 0, total = 0;
    for (int k = 0; k < kWarps; ++k) {
      off += k < warp ? s.count[k] : 0;
      total += s.count[k];
    }
    if (live) s.tiles[off + __popc(m & ((1u << lane) - 1u))] = tile;
    __syncthreads();
    if (total > 0) stage(s.tiles[0], 0);
    for (int t = 0; t < total; ++t) {
      cp_async_wait_all();
      __syncthreads();  // round t has landed; round t - 1's buffer is free
      if (t + 1 < total) stage(s.tiles[t + 1], (t + 1) & 1);
      apply(t & 1);
    }
  }

  cluster.sync();  // every partial of the cluster is complete
  const int r_lo = kRowBlock * rank / C, r_hi = kRowBlock * (rank + 1) / C;
  for (int i = r_lo * kFeatBlock + tid; i < r_hi * kFeatBlock; i += kThreads) {
    float v[kMaxCluster];  // every remote read in flight before the first use
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < C) v[k] = cluster.map_shared_rank(&s.acc[0], k)[i];
    }
    float a = v[0];
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k) {
      if (k < C) a = combine(op, a, v[k]);
    }
    out[static_cast<long long>(row0 + i / kFeatBlock) * F + f0 + i % kFeatBlock] = a;
  }
  cluster.sync();  // no CTA leaves while another still reads its partial
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
  fill_identity(s.acc, op);
  for (int t = 0; t < T; ++t) {
    if (occ[(long long)rb * T + t] > 0) {
      tile_round(s, op, dst, weights, values, F, f0, t, row0);
    }
  }
  store_tile(s, out, F, f0, row0);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Shapes: dst (E,), weights (E,)
// or null, values (E, F) 16-byte aligned, out (n_rows, F); E % 128 == 0,
// F % 32 == 0, n_rows % 128 == 0. The banded entry takes the wrapper's
// cluster size and shared-memory bytes and refuses a plan it does not
// build. Each returns the launch's cudaError_t.
extern "C" int gas_scatter_banded_f32(const int* work, int W, int ncols,
                                      const int* dst, const float* weights,
                                      const float* values, float* out,
                                      int n_rows, int F, int op, int cluster,
                                      int smem, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || smem != static_cast<int>(sizeof(Banded))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      banded_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Banded)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_rows / kRowBlock * cluster, F / kFeatBlock, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(Banded);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, banded_cluster_kernel, work, W, ncols, dst,
                                             weights, values, out,
                                             static_cast<long long>(F), op, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
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

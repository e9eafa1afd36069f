// FAST-GAS scatter-reduce kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gas_scatter/kernel.py:
//   * gas_scatter_banded  (kernel.py:211; bodies _sched_add_kernel,
//     _sched_addw_kernel, _sched_cmp_kernel, _sched_live, _add_round,
//     _cmp_round) -> banded_cluster_kernel below, the scheduled walk;
//   * gas_scatter_pallas  (kernel.py:266; bodies _gas_add_kernel,
//     _gas_addw_kernel, _gas_cmp_kernel) -> dense_cluster_kernel below, the
//     dense grid gated by the occupancy bitmap.
//
// Both compute out[r, f] = reduce_{e : dst[e] == r} w[e] * values[e, f] for
// op = add (w = 1 without weights), or the max / min of values[e, f] over the
// same edges; rows with no edge hold the identity (0, -inf, +inf). Dead edges
// carry dst = n_rows (the padded row count) and so match no row. A NaN value
// on a matched edge makes its row's max / min NaN, as jnp.maximum / minimum
// and scatter_reduce's amax / amin do (fmaxf / fminf would drop it).
//
// What bounds it: memory. One pass moves the value stream E*F*s bytes (s the
// value type's size), the ids and weights E*8 bytes, and writes n_rows*F*s
// bytes; at 3.35 TB/s that is the floor. The arithmetic is one FMA (or one
// compare) per value. At the sizes the serving and inference paths launch
// (one 128-row block, 2-7 edge tiles) the floor is under a microsecond, so
// what sets the time is how many SMs work at once and how many memory
// latencies lie end to end.
//
// The TPU kernel keeps a 128-row output block resident in VMEM while edge
// tiles stream past it, contracting one-hot CAM match lines on the MXU. The
// match here is a plain compare, not a one-hot product: no tensor cores and
// no TF32, so integer-valued data stays exact.
//
// Both kernels share one walk. A thread-block cluster of C CTAs (C <= 8,
// the portable limit, chosen by the wrapper from shapes alone) owns one
// (128-row block x 32-feature block) output tile, so one 128-row block
// spreads over C x F/32 CTAs instead of F/32. CTA rank r takes the r-th of
// C contiguous shares of its row block's rounds, in stream order, and
// reduces them into its own partial tile in shared memory, starting from
// the identity:
//   * the rounds are compacted on the device, a window of 256 candidates at
//     a time, into a list of edge tiles (for the dense grid with their
//     first and end 32-edge chunk) with one __ballot_sync per warp and a
//     prefix over the 8 warp counts; the host reads nothing and the launch
//     depends on shapes alone;
//   * a round's ids, weights and value rows (its 32-edge chunks of one
//     128-edge tile, 32 features wide) arrive by cp.async into one of two
//     buffers while the previous round is applied, one barrier per round;
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
// Value types. Each kernel is a template over the value type: float,
// __nv_bfloat16 and __half, exported as gas_scatter_{banded,dense}_{f32,
// bf16,f16}; the output has the values' type, as the TPU kernel's does
// (out_shape = values.dtype). Values are loaded in their own width (one
// 16-byte cp.async carries 4 floats or 8 bf16 / f16, so a 32-feature row is
// 8 or 4 copies); partials are held in f32 in shared memory. The float
// instantiation is the f32 kernel unchanged. For bf16 and f16 the
// reference's rounding points are kept (kernel.py _add_round: out_ref +=
// dot(match, values, preferred_element_type=out.dtype), the weights cast to
// the value type first):
//   * an edge weight is rounded to the value type before its product;
//   * a round's products (each exact in f32: 8- or 11-bit significands) are
//     summed in f32, in stream order, into a round-sum tile that shares the
//     second value buffer's bytes (the two narrow value buffers fit in the
//     first), so Walk keeps its size;
//   * after the round, each owner warp rounds its cells' sums once to the
//     value type, adds them to the partial in f32 and rounds the result to
//     the value type (f32's 24-bit significand is at least 2p + 2 bits for
//     bf16's p = 8 and f16's p = 11, so rounding through it is the value
//     type's own correctly rounded add).
// Max and min compare the values exactly (every bf16 and f16 value is a
// float), with NaN as in f32. The cluster split regroups add's rounded
// accumulation: each CTA accumulates its share of rounds from 0 with the
// rounding above, and the C partials are combined in rank order with one
// rounding per add; in the dense grid a tile whose chunks straddle two
// shares is summed and rounded as two pieces. So a cell of a sub-f32 add
// is rounded at most twice per piece of the stream it sums (a whole tile in
// the banded walk, a run of 32-edge chunks in the dense grid) where the
// reference rounds twice per tile; integer data whose partial sums stay
// within the type's exact integers (|x| <= 256 for bf16, 2048 for f16) is
// exact either way, and max and min are exact on any data.
//
// Only the source of the rounds differs:
//   * banded_cluster_kernel: the work list (W, 4) int32 holds rows
//     [row_block, tile, live, init] ordered by row block; each row block's
//     rows form one contiguous run, found by counting probes of column 0.
//     Rank r takes the r-th share of the run's rows, and a live row is one
//     round of all four chunks of its tile. An add round whose 128 x 32
//     value rows are all zero is skipped (zero is add's identity, so the
//     skip is exact; it also keeps an all-zero block finite under a
//     non-finite weight). The CTA decides it from the rows it has staged
//     for the round: after cp.async.wait_group 0 each thread tests the
//     16-byte pieces its own copies wrote, a value being zero exactly where
//     v != 0 is false (its bits other than the sign are 0: -0.0 is zero,
//     NaN is not), and the round's barrier is __syncthreads_or of the
//     threads' answers. No byte is read for it beyond the staged rows,
//     and no barrier is added. A skipped round's apply matches no edge
//     (the answer joins the owner warps' ballot): on an H100, where no
//     block was all zero, a branch around the apply cost ~10 % of the
//     kernel and the predicate nothing measurable. Max and min never skip.
//   * dense_cluster_kernel: the row block's row of the (R/128, T) occupancy
//     map. Its occupied tiles hold 4 * n 32-edge chunks in stream order;
//     rank r takes the r-th share of those chunks, so a row block with two
//     occupied tiles (one 3-seed serving segment) still spreads over 8 CTAs.
//     A sampled segment's live edges all land on its first few rows, so a
//     split by rows would leave all but one CTA idle; a split by chunks
//     does not.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowBlock = 128;
constexpr int kEdgeTile = 128;
constexpr int kFeatBlock = 32;
constexpr int kChunk = 32;                      // edges per owner-warp ballot
constexpr int kChunks = kEdgeTile / kChunk;     // chunks per edge tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWindow = kThreads;  // round candidates compacted per pass
constexpr int kMaxCluster = 8;
constexpr int kTileBits = 24;      // a round packs its tile below bit 24
constexpr int kWorkCols = 4;       // [row_block, tile, live, init]

enum Op { kAdd = 0, kMax = 1, kMin = 2 };

__device__ __forceinline__ float identity(int op) {
  return op == kAdd ? 0.0f : (op == kMax ? -CUDART_INF_F : CUDART_INF_F);
}

__device__ __forceinline__ float combine(int op, float a, float v) {
  if (op == kAdd) return a + v;
  if (op == kMax) return (v > a || v != v) ? v : a;  // a NaN value wins
  return (v < a || v != v) ? v : a;
}

// The value types: loaded into f32, rounded and stored back.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

// x rounded to the nearest value of T (round half to even), as a float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// A value type narrower than float rounds each add round (see the note).
template <typename T>
constexpr bool kNarrow = !std::is_same<T, float>::value;

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

// A dense round: edge tile `tile`, chunks [lo, hi) of it. A banded round is
// its tile alone (kWhole below).
__device__ __forceinline__ int pack_round(int tile, int lo, int hi) {
  return tile | (lo << kTileBits) | (hi << (kTileBits + 3));
}
__device__ __forceinline__ int round_tile(int r) { return r & ((1 << kTileBits) - 1); }
__device__ __forceinline__ int round_lo(int r) { return (r >> kTileBits) & 7; }
__device__ __forceinline__ int round_hi(int r) { return (r >> (kTileBits + 3)) & 7; }

// One CTA's shared memory (dynamic, above the 48 KB static limit), the same
// bytes for every value type.
struct Walk {
  float acc[kRowBlock * kFeatBlock];     // this CTA's partial [row][feature]
  float val[2][kEdgeTile * kFeatBlock];  // value rows, double-buffered
                                         // (value_rows, round_sums)
  int ids[2][kEdgeTile];                 // their dst
  float w[2][kEdgeTile];                 // and weights
  int rounds[kWindow];                   // the current window's rounds
  int count[kWarps];                     // per-warp counts
  int count_hi[kWarps];
};

// Buffer buf's value rows in the value type: val[buf] for float; for a
// narrower type both buffers fit in val[0].
template <typename T>
__device__ __forceinline__ T* value_rows(Walk& s, int buf) {
  return reinterpret_cast<T*>(&s.val[0][0]) + buf * kEdgeTile * kFeatBlock;
}

// A narrow type's add: the current round's f32 sums [row][feature], in the
// bytes of val[1] that its value rows leave free.
template <typename T>
__device__ __forceinline__ float* round_sums(Walk& s) {
  static_assert(2 * sizeof(T) <= sizeof(float), "the value rows fill val[0]");
  return s.val[1];
}

// What every round of one launch reads.
template <typename T>
struct Stream {
  const int* dst;
  const float* weights;  // null: unit weights
  const T* values;
  long long F;
  int f0;    // the CTA's first feature
  int row0;  // its row block's first row
  int op;
};

template <typename T>
__device__ __forceinline__ void fill_identity(Walk& s, int op) {
  const float v = identity(op);
  for (int i = threadIdx.x; i < kRowBlock * kFeatBlock; i += kThreads) s.acc[i] = v;
  if constexpr (kNarrow<T>) {
    if (op == kAdd) {
      float* sum = round_sums<T>(s);
      for (int i = threadIdx.x; i < kRowBlock * kFeatBlock; i += kThreads) sum[i] = 0.0f;
    }
  }
}

// Exclusive prefix of `flag` over the block's threads in thread order, and
// the block's total. One barrier; s.count must be free on entry.
__device__ __forceinline__ int block_prefix(Walk& s, bool flag, int& total) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s.count[warp] = __popc(m);
  __syncthreads();
  int off = 0;
  total = 0;
  for (int k = 0; k < kWarps; ++k) {
    off += k < warp ? s.count[k] : 0;
    total += s.count[k];
  }
  return off + __popc(m & ((1u << lane) - 1u));
}

// A round's first and end edge; kWhole: every round is a whole tile, and
// the bounds are constants.
template <bool kWhole>
__device__ __forceinline__ int round_first(int round) {
  return kWhole ? 0 : round_lo(round) * kChunk;
}
template <bool kWhole>
__device__ __forceinline__ int round_end(int round) {
  return kWhole ? kEdgeTile : round_hi(round) * kChunk;
}

// cp.async one round's ids, weights and value rows into buffer buf.
template <bool kWhole, typename T>
__device__ __forceinline__ void stage(Walk& s, const Stream<T>& in, int round, int buf) {
  const int tid = threadIdx.x;
  const int lo = round_first<kWhole>(round), hi = round_end<kWhole>(round);
  const long long e0 = static_cast<long long>(round_tile(round)) * kEdgeTile;
  if (tid < kEdgeTile) {
    if (tid >= lo && tid < hi) cp_async4(&s.ids[buf][tid], in.dst + e0 + tid);
  } else if (in.weights) {
    const int e = tid - kEdgeTile;
    if (e >= lo && e < hi) cp_async4(&s.w[buf][e], in.weights + e0 + e);
  }
  const T* src = in.values + e0 * in.F + in.f0;
  T* rows = value_rows<T>(s, buf);
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values per copy
  constexpr int kParts = kFeatBlock / kPer;  // 16-byte pieces per value row
  for (int q = lo * kParts + tid; q < hi * kParts; q += kThreads) {
    const int e = q / kParts, part = (q % kParts) * kPer;
    cp_async16(&rows[e * kFeatBlock + part], src + e * in.F + part);
  }
  cp_async_commit();
}

// Warp `warp` applies its own edges of the round in buffer buf, four at a
// time: the four edges' loads are in flight before the first is used. A
// narrow type's add sums into the round's sums, every other into the
// partial. A round that is not `live` finds no edge of its own, so it
// changes nothing.
template <bool kWhole, typename T>
__device__ __forceinline__ void apply(Walk& s, const Stream<T>& in, int round, int buf,
                                      bool live) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* ids = s.ids[buf];
  const float* wt = s.w[buf];
  const T* val = value_rows<T>(s, buf);
  float* acc = s.acc;
  if constexpr (kNarrow<T>) {
    if (in.op == kAdd) acc = round_sums<T>(s);
  }
  int cur = -1;
  float reg = 0.0f;
  for (int c = round_first<kWhole>(round); c < round_end<kWhole>(round); c += kChunk) {
    const int r = ids[c + lane] - in.row0;
    unsigned mine = __ballot_sync(0xffffffffu,
                                  live && r >= 0 && r < kRowBlock && (r % kWarps) == warp);
    while (mine) {
      int e[4], re[4];
      float v[4], w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[j] = mine ? c + __ffs(mine) - 1 : -1;
        mine &= mine - 1;
        if (e[j] >= 0) {
          re[j] = ids[e[j]] - in.row0;
          v[j] = to_float(val[e[j] * kFeatBlock + lane]);
          w[j] = in.weights ? round_to<T>(wt[e[j]]) : 1.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e[j] < 0) break;
        if (re[j] != cur) {
          if (cur >= 0) acc[cur * kFeatBlock + lane] = reg;
          cur = re[j];
          reg = acc[cur * kFeatBlock + lane];
        }
        reg = in.op == kAdd ? fmaf(w[j], v[j], reg) : combine(in.op, reg, v[j]);
      }
    }
  }
  if (cur >= 0) acc[cur * kFeatBlock + lane] = reg;
}

// A narrow type's add, after each round: every owner warp folds its cells'
// round sums into the partial, partial = T(partial + T(sum)), and clears
// them. The lane that summed a cell folds it, so no barrier is needed.
template <typename T>
__device__ __forceinline__ void fold_round(Walk& s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sum = round_sums<T>(s);
  for (int r = warp; r < kRowBlock; r += kWarps) {
    const int i = r * kFeatBlock + lane;
    s.acc[i] = round_to<T>(s.acc[i] + round_to<T>(sum[i]));
    sum[i] = 0.0f;
  }
}

// Whether a value this thread staged into buffer buf for a whole tile is
// nonzero (v != 0: any bit but the sign set). stage writes the buffer's
// 16-byte piece q from thread q % kThreads, so the thread reads only its
// own copies, which cp.async.wait_group 0 has made visible to it.
template <typename T>
__device__ __forceinline__ bool staged_nonzero(Walk& s, int buf) {
  const uint4* pieces = reinterpret_cast<const uint4*>(value_rows<T>(s, buf));
  constexpr unsigned kMagnitude = sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu;
  constexpr int kPieces = kEdgeTile * kFeatBlock * static_cast<int>(sizeof(T)) / 16;
  static_assert(kPieces % kThreads == 0, "every thread copies as many pieces");
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kPieces / kThreads; ++k) {
    const uint4 p = pieces[threadIdx.x + k * kThreads];
    bits |= p.x | p.y | p.z | p.w;
  }
  return (bits & kMagnitude) != 0;
}

// Apply the window's `total` rounds of s.rounds in order, the next one
// loading while this one is applied. The caller's barrier after the
// compaction makes s.rounds visible and the previous window's buffers free.
// A banded add skips a round whose staged value rows are all zero.
template <bool kWhole, typename T>
__device__ __forceinline__ void walk(Walk& s, const Stream<T>& in, int total) {
  if (total > 0) stage<kWhole>(s, in, s.rounds[0], 0);
  for (int t = 0; t < total; ++t) {
    cp_async_wait_all();
    // round t has landed; round t - 1's buffer is free
    bool live = true;
    if (kWhole && in.op == kAdd) {
      live = __syncthreads_or(staged_nonzero<T>(s, t & 1));
    } else {
      __syncthreads();
    }
    if (t + 1 < total) stage<kWhole>(s, in, s.rounds[t + 1], (t + 1) & 1);
    apply<kWhole>(s, in, s.rounds[t], t & 1, live);
    if constexpr (kNarrow<T>) {
      if (in.op == kAdd && live) fold_round<T>(s);
    }
  }
}

// Combine the cluster's C partials in rank order and write the tile (a
// narrow type's add rounds each sum to the type).
template <typename T>
__device__ __forceinline__ void combine_store(cg::cluster_group& cluster, Walk& s,
                                              const Stream<T>& in, T* out, int C) {
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();  // every partial of the cluster is complete
  const int r_lo = kRowBlock * rank / C, r_hi = kRowBlock * (rank + 1) / C;
  for (int i = r_lo * kFeatBlock + threadIdx.x; i < r_hi * kFeatBlock; i += kThreads) {
    float v[kMaxCluster];  // every remote read in flight before the first use
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < C) v[k] = cluster.map_shared_rank(&s.acc[0], k)[i];
    }
    float a = v[0];
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k) {
      if (k < C) {
        a = kNarrow<T> && in.op == kAdd ? round_to<T>(a + v[k]) : combine(in.op, a, v[k]);
      }
    }
    out[static_cast<long long>(in.row0 + i / kFeatBlock) * in.F + in.f0 + i % kFeatBlock] =
        from_float<T>(a);
  }
  cluster.sync();  // no CTA leaves while another still reads its partial
}

// First work row in [a, b) whose row block is >= rb (column 0 ascends); b if
// there is none.
__device__ __forceinline__ int lower_bound_rows(const int* work, int a, int b, int rb) {
  while (a < b) {
    const int mid = (a + b) / 2;
    if (work[(long long)mid * kWorkCols] < rb) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a;
}

// Row q of the kThreads probes of column 0 that find a run.
__device__ __forceinline__ int probe_row(int q, int W) {
  return static_cast<int>(static_cast<long long>(q) * W / kThreads);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_cluster_kernel(const int* __restrict__ work, int W,
                      const int* __restrict__ dst, const float* __restrict__ weights,
                      const T* __restrict__ values, T* __restrict__ out,
                      long long F, int op, int C) {
  extern __shared__ float4 dyn[];
  Walk& s = *reinterpret_cast<Walk*>(dyn);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rb = blockIdx.x / C;
  const int fb = blockIdx.y;
  const Stream<T> in{dst, weights, values, F, fb * kFeatBlock, rb * kRowBlock, op};
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // The run [lo, hi) of row block rb, found by one round of kThreads
  // parallel probes of column 0: n probes lie below rb, so the run starts
  // after probe n - 1 and at or before probe n. With W <= kThreads the
  // probes are the rows themselves, and each thread keeps its row's tile
  // and live flag for the compaction below: all of the CTA's metadata costs
  // one memory latency. A longer list ends with a binary search between two
  // probes.
  const bool small = W <= kThreads;
  const int probe = small ? tid : probe_row(tid, W);
  int blk = INT_MAX, tile = 0;
  bool row_live = false;
  if (probe < W) {
    const int* row = work + static_cast<long long>(probe) * kWorkCols;
    blk = row[0];
    if (small) {
      tile = row[1];
      row_live = row[2] == 1;
    }
  }
  const unsigned below_lo = __ballot_sync(0xffffffffu, blk < rb);
  const unsigned below_hi = __ballot_sync(0xffffffffu, blk < rb + 1);
  if (lane == 0) {
    s.count[warp] = __popc(below_lo);
    s.count_hi[warp] = __popc(below_hi);
  }
  fill_identity<T>(s, op);
  __syncthreads();
  int lo = 0, hi = 0;
  for (int k = 0; k < kWarps; ++k) {
    lo += s.count[k];
    hi += s.count_hi[k];
  }
  if (!small) {
    lo = lower_bound_rows(work, lo ? probe_row(lo - 1, W) + 1 : 0,
                          lo < kThreads ? probe_row(lo, W) : W, rb);
    hi = lower_bound_rows(work, hi ? probe_row(hi - 1, W) + 1 : 0,
                          hi < kThreads ? probe_row(hi, W) : W, rb + 1);
  }
  // this rank's contiguous share [s0, s1) of the run
  const long long n = hi - lo;
  const int s0 = lo + static_cast<int>(n * rank / C);
  const int s1 = lo + static_cast<int>(n * (rank + 1) / C);

  // each window of kWindow work rows: compact its live rounds in order,
  // then walk them
  const int windows = small ? 1 : (s1 - s0 + kWindow - 1) / kWindow;
  for (int wi = 0; wi < windows; ++wi) {
    const int i = (small ? 0 : s0 + wi * kWindow) + tid;
    if (!small) {
      tile = 0;
      row_live = false;
      if (i < s1) {
        const int* row = work + static_cast<long long>(i) * kWorkCols;
        tile = row[1];
        row_live = row[2] == 1;
      }
    }
    const bool live = row_live && i >= s0 && i < s1;
    __syncthreads();  // s.count and s.rounds are read; the last window is applied
    int total;
    const int pos = block_prefix(s, live, total);
    if (live) s.rounds[pos] = tile;  // a whole tile: no chunk bounds
    __syncthreads();
    walk<true>(s, in, total);
  }
  combine_store(cluster, s, in, out, C);
}

// (Val is the value type here: T is the tile count, as in the wrapper.)
template <typename Val>
__global__ void __launch_bounds__(kThreads)
dense_cluster_kernel(const int* __restrict__ occ, int T,
                     const int* __restrict__ dst, const float* __restrict__ weights,
                     const Val* __restrict__ values, Val* __restrict__ out,
                     long long F, int op, int C) {
  extern __shared__ float4 dyn[];
  Walk& s = *reinterpret_cast<Walk*>(dyn);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rb = blockIdx.x / C;
  const Stream<Val> in{dst, weights, values, F, static_cast<int>(blockIdx.y) * kFeatBlock,
                       rb * kRowBlock, op};
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* row = occ + static_cast<long long>(rb) * T;

  // Count the row block's occupied tiles. Every thread reads its tile of
  // each window at once (all of them in one memory latency when T <= 256)
  // and keeps the first window's bit for the compaction.
  const bool first = tid < T && row[tid] > 0;
  int mine = first;
  for (int t = tid + kWindow; t < T; t += kWindow) mine += row[t] > 0;
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) s.count[warp] = mine;
  fill_identity<Val>(s, op);
  __syncthreads();
  int n_occ = 0;
  for (int k = 0; k < kWarps; ++k) n_occ += s.count[k];

  // this rank's chunks [c0, c1) of the 4 * n_occ in stream order: the
  // occupied tiles [k0, k1), the first and last perhaps in part
  const long long n = static_cast<long long>(kChunks) * n_occ;
  const long long c0 = n * rank / C, c1 = n * (rank + 1) / C;
  const int k0 = static_cast<int>(c0 / kChunks);
  const int k1 = c1 > c0 ? static_cast<int>((c1 + kChunks - 1) / kChunks) : k0;

  // each window of kWindow tiles: compact its occupied tiles of the share
  // in order, then walk them; base counts the occupied tiles before it
  int base = 0;
  for (int t0 = 0; t0 < T && base < k1; t0 += kWindow) {
    const int t = t0 + tid;
    const bool o = t0 == 0 ? first : (t < T && row[t] > 0);
    __syncthreads();  // s.count and s.rounds are read; the last window is applied
    int cnt;
    const int k = base + block_prefix(s, o, cnt);
    if (o && k >= k0 && k < k1) {
      const long long c = static_cast<long long>(kChunks) * k;
      const int lo = static_cast<int>(c0 > c ? c0 - c : 0);
      const int hi = static_cast<int>(c1 < c + kChunks ? c1 - c : kChunks);
      s.rounds[k - max(k0, base)] = pack_round(t, lo, hi);
    }
    const int total = min(base + cnt, k1) - max(base, k0);
    base += cnt;
    __syncthreads();
    walk<false>(s, in, max(total, 0));
  }
  combine_store(cluster, s, in, out, C);
}

// dense_plan's cluster size (kernel.py): the chunks of a row block's mean
// share of the tiles, between 1 and kMaxCluster.
int dense_cluster(int T, int n_blocks) {
  if (n_blocks <= 0) return 1;
  const long long chunks = static_cast<long long>(kChunks) * ((T + n_blocks - 1) / n_blocks);
  return static_cast<int>(chunks < 1 ? 1 : (chunks > kMaxCluster ? kMaxCluster : chunks));
}

// Opt in to sizeof(Walk) bytes of dynamic shared memory, once per kernel.
template <typename Kernel>
cudaError_t allow_walk_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(Walk)));
}

// Launch one cluster of `cluster` CTAs per (row block x feature block).
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int cluster, int n_rows, int F, void* stream,
                   Args... args) {
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_rows / kRowBlock * cluster, F / kFeatBlock, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(Walk);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch descriptor the wrappers build once per call signature (shapes,
// dtypes, op) and pass by address: n_meta is W for the banded walk and T
// for the dense grid.
struct GasLaunch {
  int n_meta, n_rows, F, op, cluster, smem;
};

namespace {

template <typename T>
int banded_entry(const GasLaunch* p, const int* work, const int* dst, const float* weights,
                 const T* values, T* out, void* stream) {
  if (p->cluster < 1 || p->cluster > kMaxCluster || p->smem != static_cast<int>(sizeof(Walk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = allow_walk_smem(banded_cluster_kernel<T>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_cluster(banded_cluster_kernel<T>, p->cluster, p->n_rows, p->F, stream, work,
                        p->n_meta, dst, weights, values, out,
                        static_cast<long long>(p->F), p->op, p->cluster);
}

template <typename T>
int dense_entry(const GasLaunch* p, const int* occ, const int* dst, const float* weights,
                const T* values, T* out, void* stream) {
  if (p->n_meta >= (1 << kTileBits) ||
      p->cluster != dense_cluster(p->n_meta, p->n_rows / kRowBlock) ||
      p->smem != static_cast<int>(sizeof(Walk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = allow_walk_smem(dense_cluster_kernel<T>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_cluster(dense_cluster_kernel<T>, p->cluster, p->n_rows, p->F, stream, occ,
                        p->n_meta, dst, weights, values, out, static_cast<long long>(p->F),
                        p->op, p->cluster);
}

}  // namespace

// Plain C entry points, loaded with ctypes, one pair per value type (f32,
// bf16, f16). Shapes: meta is the work list (W, 4) or the occupancy map
// (n_rows / 128, T); dst (E,), weights (E,) f32 or null, values (E, F) of
// the value type, 16-byte aligned, out (n_rows, F) of the value type;
// E % 128 == 0, F % 32 == 0, n_rows % 128 == 0, E < 2^31. Each refuses a
// plan it does not build (cluster size, shared bytes) and returns the
// launch's cudaError_t.
#define GAS_SCATTER_ENTRIES(SUFFIX, T)                                                       \
  extern "C" int gas_scatter_banded_##SUFFIX(const GasLaunch* p, const int* work,           \
                                             const int* dst, const float* weights,          \
                                             const T* values, T* out, void* stream) {       \
    return banded_entry<T>(p, work, dst, weights, values, out, stream);                     \
  }                                                                                         \
  extern "C" int gas_scatter_dense_##SUFFIX(const GasLaunch* p, const int* occ,             \
                                            const int* dst, const float* weights,           \
                                            const T* values, T* out, void* stream) {        \
    return dense_entry<T>(p, occ, dst, weights, values, out, stream);                       \
  }

GAS_SCATTER_ENTRIES(f32, float)
GAS_SCATTER_ENTRIES(bf16, __nv_bfloat16)
GAS_SCATTER_ENTRIES(f16, __half)

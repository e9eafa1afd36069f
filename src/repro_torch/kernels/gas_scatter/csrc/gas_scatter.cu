// FAST-GAS scatter-reduce kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gas_scatter/kernel.py:
//   * gas_scatter_banded  (kernel.py:211; bodies _sched_add_kernel,
//     _sched_addw_kernel, _sched_cmp_kernel, _sched_live, _add_round,
//     _cmp_round) -> banded_cluster_kernel below, the scheduled walk;
//   * gas_scatter_pallas  (kernel.py:266; bodies _gas_add_kernel,
//     _gas_addw_kernel, _gas_cmp_kernel) -> dense_cluster_kernel below, the
//     dense grid over a row-sorted index of the edges (where the TPU
//     kernel is gated by an occupancy bitmap).
//
// Both compute out[r, f] = reduce_{e : dst[e] == r} w[e] * values[e, f] for
// op = add (w = 1 without weights), or the max / min of values[e, f] over the
// same edges; rows with no edge hold the identity (0, -inf, +inf). Dead edges
// carry dst = n_rows (the padded row count) and so match no row. A NaN value
// on a matched edge makes its row's max / min NaN, as jnp.maximum / minimum
// and scatter_reduce's amax / amin do (fmaxf / fminf would drop it).
//
// The banded walk has two row sources, one template parameter apart:
//   * the values walk reads row e of a value stream (E, F) its caller
//     built, as the TPU kernel does (the sampled and serving paths' gathered
//     candidate rows, max / min, bf16 / f16);
//   * the gathered walk reads row src[e] of the feature table (V, F) itself,
//     f32 only: the full-graph add, whose caller would otherwise write an
//     E x F copy of the table's rows and a padded copy of that for the
//     kernel to read back (at Reddit's layer 0, 20.2 GB and the pad's
//     40.6 GB moved, for a 0.63 GB table). Every
//     byte it stages equals the values walk's over the stream table[src]
//     padded with zero rows, so its skips and its output bits are the same.
//
// What bounds it: memory. One pass moves the value rows E*F*s bytes (s the
// value type's size; the gathered walk reads each edge's 128-byte row
// segment at random, so a table row is read once per edge that reaches it,
// not once), the ids and weights E*8 bytes (the dense grid's sorted ids and
// order E*8 bytes more, the gathered walk's src E*4), and writes n_rows*F*s
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
// the identity. The host reads nothing and the launch depends on shapes
// alone:
//   * a round's ids, weights and value rows (up to 128 edges, 32 features
//     wide) arrive by cp.async into one of two buffers while the previous
//     round is applied, one barrier per round;
//   * each (row, feature) cell has one writer at a time, so no atomics: a
//     warp's 32 lanes span the feature block, and in the banded walk warp k
//     owns the rows r with r % 8 == k. It finds its own edges of each
//     32-edge chunk with one ballot and visits only those, in stream order;
//     a run of equal rows (the sorted sampled stream gives long ones) is
//     reduced in a register and flushed to the partial once. The dense
//     grid splits a round by positions instead (below).
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
//     summed in f32, in stream order: the banded walk's into a round-sum
//     tile that shares the second value buffer's bytes (the two narrow value
//     buffers fit in the first), so Walk keeps its size; the dense grid's in
//     the owner lane's register, one run per row and source tile;
//   * after the round (at the run's end in the dense grid), each owner warp
//     rounds its cells' sums once to the value type, adds them to the
//     partial in f32 and rounds the result to the value type (f32's 24-bit
//     significand is at least 2p + 2 bits for bf16's p = 8 and f16's p =
//     11, so rounding through it is the value type's own correctly rounded
//     add).
// Max and min compare the values exactly (every bf16 and f16 value is a
// float), with NaN as in f32. The cluster split regroups add's rounded
// accumulation: each CTA accumulates its share of rounds from 0 with the
// rounding above, and the C partials are combined in rank order with one
// rounding per add; in the dense grid a row's edges of one tile that
// straddle two shares are summed and rounded as two pieces. So a cell of a
// sub-f32 add is rounded at most twice per piece of the stream it sums (a
// whole tile in the banded walk, a row's edges of one tile within a share
// in the dense grid) where the reference rounds twice per tile; integer
// data whose partial sums stay within the type's exact integers (|x| <= 256
// for bf16, 2048 for f16) is exact either way, and max and min are exact on
// any data.
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
//     The rounds are compacted on the device, a window of 256 work rows at
//     a time, with one __ballot_sync per warp and a prefix over the 8 warp
//     counts. The gathered walk loads each thread's src entries of the
//     round after next into registers while a round is applied, as the
//     dense grid loads order, so the indirection adds no latency of its
//     own, and stages zeros for a tile-padding edge (src outside the table).
//   * dense_cluster_kernel: the row-sorted index the wrapper builds on the
//     device (ops.fused_call): ids (E,) the routed rows sorted by a stable
//     sort, so each row keeps its edges in stream order and dead edges sort
//     last; order (E,) the edge at each sorted position; starts (R/128 + 1,)
//     each row block's run [starts[rb], starts[rb+1]) of positions. Rank r
//     takes the r-th share of the run's 32-edge chunks, so a row block with
//     a few edges (one 3-seed serving segment) still spreads over 8 CTAs,
//     and walks it in rounds of 128 positions: the ids arrive as they are,
//     each edge's weight and 32-feature value row (one aligned 128-byte
//     segment in f32) by cp.async through order. The order entries of the
//     round after next are loaded into registers while a round is applied,
//     so the indirection costs no latency of its own. What bounds it is the
//     E*F*s value bytes, each read once, and E*8 index bytes: the occupancy
//     grid it replaces staged each 128-edge tile again for every row block
//     the tile touched (a shuffled stream touches ~124 of 2048 row blocks
//     per tile, ~1 TB at 2^23 x 256 f32 values). Sorted, a row's edges are
//     one run, and a skewed graph's runs are long (R-MAT's row 0 holds 0.7 %
//     of the edges), so owner warps would leave all but one warp idle: warp
//     w takes positions [16w, 16w + 16) of the round, reduces each run of
//     its slice in a register, and the pieces of a run that crosses slices
//     are folded in warp order, which is stream order (apply_sliced). A
//     narrow add keeps owner warps, its run carried from round to round and
//     cut at each source tile, so it rounds where the reference does
//     (apply_narrow_add). The feature blocks of a row block are launched side
//     by side: they read the same index entries and value rows. On an H100
//     at 2^23 x 256 f32 values: 4.40 ms with slices, 13.24 ms with owner
//     warps, 289.7 ms for the occupancy grid; 3.92 ms with no apply at all.

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
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWindow = kThreads;  // round candidates compacted per pass
constexpr int kMaxCluster = 8;
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

// One CTA's shared memory (dynamic, above the 48 KB static limit), the same
// bytes for every value type.
struct Walk {
  float acc[kRowBlock * kFeatBlock];     // this CTA's partial [row][feature]
  float val[2][kEdgeTile * kFeatBlock];  // value rows, double-buffered
                                         // (value_rows, round_sums)
  int ids[2][kEdgeTile];                 // their dst
  float w[2][kEdgeTile];                 // and weights
  union {
    int rounds[kWindow];             // banded: the current window's rounds
    int tiles[2][kEdgeTile];         // dense, narrow add: each staged edge's source tile
    float lead[kWarps][kFeatBlock];  // dense, other ops: each slice's leading piece
  };
  int count[kWarps];                     // per-warp counts
  int count_hi[kWarps];
};
static_assert(kWindow == 2 * kEdgeTile && kWindow == kWarps * kFeatBlock,
              "the dense walk's tiles and pieces fill the round list");

// Buffer buf's value rows in the value type: val[buf] for float; for a
// narrower type both buffers fit in val[0].
template <typename T>
__device__ __forceinline__ T* value_rows(Walk& s, int buf) {
  return reinterpret_cast<T*>(&s.val[0][0]) + buf * kEdgeTile * kFeatBlock;
}

// A round's value rows arrive in 16-byte copies: kPer values each, kParts
// to a 32-feature row, kCopies per thread for a round of kEdgeTile rows.
template <typename T>
constexpr int kPer = 16 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kParts = kFeatBlock / kPer<T>;
template <typename T>
constexpr int kCopies = kEdgeTile * kParts<T> / kThreads;

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
  const T* values;       // the value stream (E, F), or the gathered walk's table (V, F)
  long long F;
  int f0;    // the CTA's first feature
  int row0;  // its row block's first row
  int op;
  const int* src;  // the gathered walk's source rows (E,); null in the values walk
  int n_src;       // the table's rows V
};

// The partial at the identity; `sums`: a narrow type's add clears its round
// sums too (the banded walk's).
template <typename T>
__device__ __forceinline__ void fill_identity(Walk& s, int op, bool sums) {
  const float v = identity(op);
  for (int i = threadIdx.x; i < kRowBlock * kFeatBlock; i += kThreads) s.acc[i] = v;
  if constexpr (kNarrow<T>) {
    if (op == kAdd && sums) {
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

// The gathered walk's source rows for the value pieces one thread copies
// in a banded round (stage's pieces q = tid + k * kThreads): -1 where the
// edge's src lies outside the table (the tile padding's), staged as zeros.
template <typename T>
struct Sources {
  int row[kCopies<T>];
};

// Load them for the round of edge tile `tile`. Plain loads: their latency
// passes while the round before is applied, and stage waits for them only
// when it issues the copies.
template <typename T>
__device__ __forceinline__ Sources<T> fetch_sources(const Stream<T>& in, int tile) {
  Sources<T> f;
  const long long e0 = static_cast<long long>(tile) * kEdgeTile;
#pragma unroll
  for (int k = 0; k < kCopies<T>; ++k) {
    const int r = in.src[e0 + (threadIdx.x + k * kThreads) / kParts<T>];
    f.row[k] = r >= 0 && r < in.n_src ? r : -1;
  }
  return f;
}

// cp.async one banded round's ids, weights and value rows (its whole edge
// tile) into buffer buf: the values walk copies rows e0 + e of the value
// stream; the gathered walk copies rows f.row of the table, and writes
// zeros for a piece without one, as the zero-padded stream held.
template <typename T, bool kGathered>
__device__ __forceinline__ void stage(Walk& s, const Stream<T>& in, int tile, int buf,
                                      const Sources<T>& f) {
  const int tid = threadIdx.x;
  const long long e0 = static_cast<long long>(tile) * kEdgeTile;
  if (tid < kEdgeTile) {
    cp_async4(&s.ids[buf][tid], in.dst + e0 + tid);
  } else if (in.weights) {
    const int e = tid - kEdgeTile;
    cp_async4(&s.w[buf][e], in.weights + e0 + e);
  }
  T* rows = value_rows<T>(s, buf);
  if constexpr (kGathered) {
#pragma unroll
    for (int k = 0; k < kCopies<T>; ++k) {
      const int q = tid + k * kThreads;
      const int e = q / kParts<T>, part = (q % kParts<T>) * kPer<T>;
      T* piece = &rows[e * kFeatBlock + part];
      if (f.row[k] >= 0) {
        cp_async16(piece, in.values + static_cast<long long>(f.row[k]) * in.F + in.f0 + part);
      } else {
        *reinterpret_cast<uint4*>(piece) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    const T* src = in.values + e0 * in.F + in.f0;
    for (int q = tid; q < kEdgeTile * kParts<T>; q += kThreads) {
      const int e = q / kParts<T>, part = (q % kParts<T>) * kPer<T>;
      cp_async16(&rows[e * kFeatBlock + part], src + e * in.F + part);
    }
  }
  cp_async_commit();
}

// Warp `warp` applies its own edges of the banded round in buffer buf, four at a
// time: the four edges' loads are in flight before the first is used. A
// narrow type's add sums into the round's sums, every other into the
// partial. A round that is not `live` finds no edge of its own, so it
// changes nothing.
template <typename T>
__device__ __forceinline__ void apply(Walk& s, const Stream<T>& in, int buf, bool live) {
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
  for (int c = 0; c < kEdgeTile; c += kChunk) {
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
// loading while this one is applied; the gathered walk holds the source
// rows of the round after that in registers. The caller's barrier after the
// compaction makes s.rounds visible and the previous window's buffers free.
// An add skips a round whose staged value rows are all zero.
template <typename T, bool kGathered>
__device__ __forceinline__ void walk(Walk& s, const Stream<T>& in, int total) {
  Sources<T> next;
  if constexpr (kGathered) {
    if (total > 0) next = fetch_sources(in, s.rounds[0]);
  }
  if (total > 0) stage<T, kGathered>(s, in, s.rounds[0], 0, next);
  if constexpr (kGathered) {
    if (total > 1) next = fetch_sources(in, s.rounds[1]);
  }
  for (int t = 0; t < total; ++t) {
    cp_async_wait_all();
    // round t has landed; round t - 1's buffer is free
    bool live = true;
    if (in.op == kAdd) {
      live = __syncthreads_or(staged_nonzero<T>(s, t & 1));
    } else {
      __syncthreads();
    }
    if (t + 1 < total) stage<T, kGathered>(s, in, s.rounds[t + 1], (t + 1) & 1, next);
    if constexpr (kGathered) {
      if (t + 2 < total) next = fetch_sources(in, s.rounds[t + 2]);
    }
    apply(s, in, t & 1, live);
    if constexpr (kNarrow<T>) {
      if (in.op == kAdd && live) fold_round<T>(s);
    }
  }
}

// The dense walk. Its rounds are up to kEdgeTile consecutive positions of
// the row-sorted stream: ids[p] ascending, order[p] the edge at position p,
// whose weight and value row are read through it.

// The order entries one thread needs for one round (-1 past its end): those
// of the value rows it copies and of its edge slot tid % kEdgeTile (the
// weight's, and a narrow add's source tile).
template <typename T>
struct Fetched {
  int row[kCopies<T>];
  int edge;
};

// Load the order entries of the round at positions [p, min(p + kEdgeTile,
// end)). Plain loads: their latency passes while the round before is
// applied, and stage waits for them only when it issues the copies.
template <typename T>
__device__ __forceinline__ Fetched<T> fetch(const int* order, int p, int end) {
  Fetched<T> f;
#pragma unroll
  for (int k = 0; k < kCopies<T>; ++k) {
    const int q = p + (threadIdx.x + k * kThreads) / kParts<T>;
    f.row[k] = q < end ? order[q] : -1;
  }
  const int q = p + threadIdx.x % kEdgeTile;
  f.edge = q < end ? order[q] : -1;
  return f;
}

// cp.async the round at positions [p, p + n) into buffer buf: its sorted ids
// (a slot past n gets -1, which matches no row), and through `f` its weights
// and value rows; a narrow add also keeps each edge's source tile.
template <typename T>
__device__ __forceinline__ void stage_sorted(Walk& s, const Stream<T>& in, int p, int n,
                                             const Fetched<T>& f, int buf) {
  const int tid = threadIdx.x;
  if (tid < kEdgeTile) {
    if (tid < n) {
      cp_async4(&s.ids[buf][tid], in.dst + p + tid);
    } else {
      s.ids[buf][tid] = -1;
    }
    if (kNarrow<T> && in.op == kAdd) s.tiles[buf][tid] = f.edge / kEdgeTile;
  } else if (in.weights && f.edge >= 0) {
    cp_async4(&s.w[buf][tid - kEdgeTile], in.weights + f.edge);
  }
  T* rows = value_rows<T>(s, buf);
#pragma unroll
  for (int k = 0; k < kCopies<T>; ++k) {
    const int q = tid + k * kThreads;
    const int e = q / kParts<T>, part = (q % kParts<T>) * kPer<T>;
    if (f.row[k] >= 0) {
      cp_async16(&rows[e * kFeatBlock + part],
                 in.values + static_cast<long long>(f.row[k]) * in.F + in.f0 + part);
    }
  }
  cp_async_commit();
}

// A narrow add's run in an owner lane: one row and one source tile, carried
// from round to round (row -1: none), its products summed in f32.
struct Run {
  int row, tile;
  float sum;
};

// Add the run into the partial, rounded as the reference rounds a round:
// partial = T(partial + T(sum)).
template <typename T>
__device__ __forceinline__ void fold_run(Walk& s, const Run& run, int lane) {
  if (run.row < 0) return;
  float* cell = &s.acc[run.row * kFeatBlock + lane];
  *cell = round_to<T>(*cell + round_to<T>(run.sum));
}

// A narrow add's n-edge round in buffer buf: warp `warp` applies its own
// rows' edges four at a time, as the banded apply does, and a run ends where
// its row or its source tile changes, so each cell rounds once per tile, as
// the reference does.
template <typename T>
__device__ __forceinline__ void apply_narrow_add(Walk& s, const Stream<T>& in, int n, int buf,
                                                 Run& run) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* ids = s.ids[buf];
  const float* wt = s.w[buf];
  const int* tiles = s.tiles[buf];
  const T* val = value_rows<T>(s, buf);
  for (int c = 0; c < n; c += kChunk) {
    const int r = ids[c + lane] - in.row0;
    unsigned mine = __ballot_sync(0xffffffffu, r >= 0 && r < kRowBlock && (r % kWarps) == warp);
    while (mine) {
      int e[4], re[4], te[4];
      float v[4], w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[j] = mine ? c + __ffs(mine) - 1 : -1;
        mine &= mine - 1;
        if (e[j] >= 0) {
          re[j] = ids[e[j]] - in.row0;
          te[j] = tiles[e[j]];
          v[j] = to_float(val[e[j] * kFeatBlock + lane]);
          w[j] = in.weights ? round_to<T>(wt[e[j]]) : 1.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e[j] < 0) break;
        if (re[j] != run.row || te[j] != run.tile) {
          fold_run<T>(s, run, lane);
          run = {re[j], te[j], 0.0f};
        }
        run.sum = fmaf(w[j], v[j], run.sum);
      }
    }
  }
}

// The n-edge round in buffer buf, for every op but a narrow add: warp w
// reduces its slice of kSlice consecutive positions, so a long run of one
// row spreads over the CTA's warps. Each run of the slice is reduced in a
// register, its 32 lanes spanning the feature block. A run that starts and
// ends inside the slice goes into the partial at once. A slice's first run
// that continues the slice before (same row) is its leading piece, left in
// s.lead; after a barrier, the warp that holds the row's first piece
// folds the leading pieces that continue it, in warp order, which is
// stream order, and writes the row once. A row that continues into the
// next round is written at this round's end and continued from the partial.
constexpr int kSlice = kEdgeTile / kWarps;

template <typename T>
__device__ __forceinline__ void apply_sliced(Walk& s, const Stream<T>& in, int n, int buf) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* ids = s.ids[buf];
  const float* wt = s.w[buf];
  const T* val = value_rows<T>(s, buf);
  const int a = warp * kSlice, b = min(a + kSlice, n);
  bool leading = a > 0 && a < b && ids[a] == ids[a - 1];
  int row = -1;  // the current run's row
  float reg = 0.0f;
  for (int e0 = a; e0 < b; e0 += 4) {
    int re[4];
    float v[4], w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // the four edges' loads in flight at once
      if (e0 + j < b) {
        re[j] = ids[e0 + j];
        v[j] = to_float(val[(e0 + j) * kFeatBlock + lane]);
        w[j] = in.weights ? round_to<T>(wt[e0 + j]) : 1.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e0 + j >= b) break;
      if (re[j] != row) {
        if (row >= 0 && leading) {
          s.lead[warp][lane] = reg;
          leading = false;
        } else if (row >= 0) {
          float* cell = &s.acc[(row - in.row0) * kFeatBlock + lane];
          *cell = combine(in.op, *cell, reg);
        }
        row = re[j];
        reg = identity(in.op);
      }
      reg = in.op == kAdd ? fmaf(w[j], v[j], reg) : combine(in.op, reg, v[j]);
    }
  }
  if (leading) {  // the whole slice continues the slice before
    s.lead[warp][lane] = reg;
    row = -1;
  }
  __syncthreads();
  if (row >= 0) {
    for (int u = warp + 1; u < kWarps && u * kSlice < n && ids[u * kSlice] == row; ++u) {
      reg = combine(in.op, reg, s.lead[u][lane]);
      if (ids[min(u * kSlice + kSlice, n) - 1] != row) break;
    }
    float* cell = &s.acc[(row - in.row0) * kFeatBlock + lane];
    *cell = combine(in.op, *cell, reg);
  }
}

// Apply the sorted positions [p0, p1) in rounds of kEdgeTile, the next
// round's copies in flight while this one is applied and the order entries
// of the one after in registers; a narrow add then folds its last run.
template <typename T>
__device__ __forceinline__ void walk_sorted(Walk& s, const Stream<T>& in, const int* order,
                                            int p0, int p1) {
  const int rounds = (p1 - p0 + kEdgeTile - 1) / kEdgeTile;
  Run run{-1, 0, 0.0f};
  Fetched<T> next = fetch<T>(order, p0, p1);
  if (rounds > 0) stage_sorted(s, in, p0, min(kEdgeTile, p1 - p0), next, 0);
  if (rounds > 1) next = fetch<T>(order, p0 + kEdgeTile, p1);
  for (int t = 0; t < rounds; ++t) {
    cp_async_wait_all();
    __syncthreads();  // round t has landed; round t - 1's buffer is free
    const int p = p0 + t * kEdgeTile;
    if (t + 1 < rounds) {
      stage_sorted(s, in, p + kEdgeTile, min(kEdgeTile, p1 - p - kEdgeTile), next, (t + 1) & 1);
    }
    if (t + 2 < rounds) next = fetch<T>(order, p + 2 * kEdgeTile, p1);
    const int n = min(kEdgeTile, p1 - p);
    if constexpr (kNarrow<T>) {
      if (in.op == kAdd) {
        apply_narrow_add(s, in, n, t & 1, run);
        continue;
      }
    }
    apply_sliced(s, in, n, t & 1);
  }
  if constexpr (kNarrow<T>) fold_run<T>(s, run, threadIdx.x % 32);
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

// kGathered selects the row source: false, the value stream `values` (E,
// F); true, the table `values` (n_src, F) through `src` (E,).
template <typename T, bool kGathered>
__global__ void __launch_bounds__(kThreads)
banded_cluster_kernel(const int* __restrict__ work, int W,
                      const int* __restrict__ dst, const float* __restrict__ weights,
                      const T* __restrict__ values, T* __restrict__ out,
                      long long F, int op, int C,
                      const int* __restrict__ src, int n_src) {
  extern __shared__ float4 dyn[];
  Walk& s = *reinterpret_cast<Walk*>(dyn);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rb = blockIdx.x / C;
  const int fb = blockIdx.y;
  const Stream<T> in{dst, weights, values, F, fb * kFeatBlock, rb * kRowBlock, op, src, n_src};
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
  fill_identity<T>(s, op, true);
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
    walk<T, kGathered>(s, in, total);
  }
  combine_store(cluster, s, in, out, C);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_cluster_kernel(const int* __restrict__ ids, const int* __restrict__ order,
                     const int* __restrict__ starts, const float* __restrict__ weights,
                     const T* __restrict__ values, T* __restrict__ out,
                     long long F, int op, int C) {
  extern __shared__ float4 dyn[];
  Walk& s = *reinterpret_cast<Walk*>(dyn);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // the grid is one-dimensional, feature blocks inside row blocks (see
  // dense_entry)
  const int n_fb = static_cast<int>(F / kFeatBlock);
  const int rb = blockIdx.x / (C * n_fb), fb = (blockIdx.x / C) % n_fb;
  const Stream<T> in{ids, weights, values, F, fb * kFeatBlock, rb * kRowBlock, op, nullptr, 0};
  // the row block's run [lo, hi) of the sorted stream, and this rank's
  // share of its 32-edge chunks, as positions [p0, p1)
  const int lo = starts[rb], hi = starts[rb + 1];
  fill_identity<T>(s, op, false);
  const long long n = (hi - lo + kChunk - 1) / kChunk;
  const int p0 = lo + kChunk * static_cast<int>(n * rank / C);
  const int p1 = min(hi, lo + kChunk * static_cast<int>(n * (rank + 1) / C));
  walk_sorted(s, in, order, p0, p1);
  combine_store(cluster, s, in, out, C);
}

// dense_plan's cluster size (kernel.py): a row block's mean count of 32-edge
// chunks, ceil(E / (32 * n_blocks)), between 1 and kMaxCluster.
int dense_cluster(int E, int n_blocks) {
  if (n_blocks <= 0) return 1;
  const long long per = kChunk * static_cast<long long>(n_blocks);
  const long long chunks = (E + per - 1) / per;
  return static_cast<int>(chunks < 1 ? 1 : (chunks > kMaxCluster ? kMaxCluster : chunks));
}

// Opt in to sizeof(Walk) bytes of dynamic shared memory, once per kernel.
template <typename Kernel>
cudaError_t allow_walk_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(Walk)));
}

// Launch `grid` in clusters of `cluster` CTAs along x.
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int cluster, dim3 grid, void* stream, Args... args) {
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
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
// dtypes, op) and pass by address: n_meta is W for the banded walk and E
// for the dense grid; n_src the gathered walk's table rows (0 elsewhere).
struct GasLaunch {
  int n_meta, n_rows, F, op, cluster, smem, n_src;
};

namespace {

template <typename T, bool kGathered>
int banded_entry(const GasLaunch* p, const int* work, const int* dst, const int* src,
                 const float* weights, const T* values, T* out, void* stream) {
  if (p->cluster < 1 || p->cluster > kMaxCluster || p->smem != static_cast<int>(sizeof(Walk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = allow_walk_smem(banded_cluster_kernel<T, kGathered>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // one cluster per (row block x feature block)
  const dim3 grid(p->n_rows / kRowBlock * p->cluster, p->F / kFeatBlock, 1);
  return launch_cluster(banded_cluster_kernel<T, kGathered>, p->cluster, grid, stream, work,
                        p->n_meta, dst, weights, values, out,
                        static_cast<long long>(p->F), p->op, p->cluster, src, p->n_src);
}

template <typename T>
int dense_entry(const GasLaunch* p, const int* ids, const int* order, const int* starts,
                const float* weights, const T* values, T* out, void* stream) {
  if (p->cluster != dense_cluster(p->n_meta, p->n_rows / kRowBlock) ||
      p->smem != static_cast<int>(sizeof(Walk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = allow_walk_smem(dense_cluster_kernel<T>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // one cluster per (row block x feature block), the feature blocks of a
  // row block launched together: they read the same edges' index entries
  // and the same value rows, 128 bytes apart (on an H100, 4.40 against
  // 4.68 ms for the row blocks inside the feature blocks, at 2^23 x 256
  // f32 values)
  const dim3 grid((p->n_rows / kRowBlock) * (p->F / kFeatBlock) * p->cluster, 1, 1);
  return launch_cluster(dense_cluster_kernel<T>, p->cluster, grid, stream, ids,
                        order, starts, weights, values, out, static_cast<long long>(p->F),
                        p->op, p->cluster);
}

}  // namespace

// Plain C entry points, loaded with ctypes, one pair per value type (f32,
// bf16, f16), and the gathered walk in f32. Shapes: the banded walk's work
// list (W, 4) and dst (E,); the dense grid's row-sorted ids (E,), order
// (E,) and starts (n_rows / 128 + 1,); weights (E,) f32 or null, values
// (E, F) of the value type, 16-byte aligned, out (n_rows, F) of the value
// type; E % 128 == 0, F % 32 == 0, n_rows % 128 == 0, E < 2^31. The
// gathered walk takes src (E,) and the table (n_src, F) in place of the
// values. Each refuses a plan it does not build (cluster size, shared
// bytes) and returns the launch's cudaError_t.
#define GAS_SCATTER_ENTRIES(SUFFIX, T)                                                       \
  extern "C" int gas_scatter_banded_##SUFFIX(const GasLaunch* p, const int* work,           \
                                             const int* dst, const float* weights,          \
                                             const T* values, T* out, void* stream) {       \
    return banded_entry<T, false>(p, work, dst, nullptr, weights, values, out, stream);    \
  }                                                                                         \
  extern "C" int gas_scatter_dense_##SUFFIX(const GasLaunch* p, const int* ids,             \
                                            const int* order, const int* starts,            \
                                            const float* weights, const T* values, T* out,  \
                                            void* stream) {                                 \
    return dense_entry<T>(p, ids, order, starts, weights, values, out, stream);             \
  }

GAS_SCATTER_ENTRIES(f32, float)
GAS_SCATTER_ENTRIES(bf16, __nv_bfloat16)
GAS_SCATTER_ENTRIES(f16, __half)

extern "C" int gas_scatter_banded_gathered_f32(const GasLaunch* p, const int* work,
                                               const int* dst, const int* src,
                                               const float* weights, const float* table,
                                               float* out, void* stream) {
  return banded_entry<float, true>(p, work, dst, src, weights, table, out, stream);
}

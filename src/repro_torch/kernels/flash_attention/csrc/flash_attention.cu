// Blocked flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention/kernel.py:84 (body _attn_kernel, :28).
// For each query row it computes softmax(s) v over the keys it may see,
// with s = q k^T in float32 (q pre-scaled), an optional logit softcap
// c * tanh(s / c), and three masks: padded keys (kpos < kv_len), causal
// (qpos >= kpos) and local window (qpos - kpos < window). Masked logits
// take the finite value NEG_INF = -2.3819763e38, as on the TPU, so a row
// that sees no key in one tile gets p = exp(0) = 1 there and a later real
// key wipes that with alpha = exp(NEG_INF - m) = 0 (with -INFINITY the same
// step would give NaN). GQA: query head h of batch row b reads kv head
// b * Hkv + h / (H / Hkv). The output is acc / max(l, 1e-30) in q's dtype;
// p is rounded to v's dtype before the PV product, as p.astype(v.dtype)
// does there, and both products accumulate in float32.
//
// What bounds it: at the shapes it serves (whisper-base's encoder: 32 heads
// x 1536 x 1536, hd 64) the work is 4 * hd operations per visible (query,
// key) pair against 4 * S * hd bytes of q, k, v and out, so the operations
// bound it: the bf16 tensor cores for bf16 inputs.
//
// Two routes, chosen by dtype (the wrapper's FlashPlan):
//
// * bfloat16 -> flash_mma_kernel, on the tensor cores. One CTA of 4 warps
//   owns a (bh, 64-row query tile); warp w owns query rows 16w..16w+15.
//   QK^T and PV are mma.sync.m16n8k16 bf16 products with f32 accumulators.
//   Operands come from shared memory through ldmatrix (V with .trans); each
//   shared row is padded by 16 bytes, so the 8 rows an ldmatrix phase reads
//   fall on 8 distinct groups of 4 banks. S, the running max m and sum l
//   and the 16 x hd output accumulator stay in registers in f32; a row's
//   statistics reduce over the quad of lanes that share it. P is rounded to
//   bf16 in registers and fed to the PV mma as its A operand directly: the
//   accumulator layout of two adjacent 8-key n-tiles is the A layout of one
//   16-key k-step, so P never goes through shared memory. K and V sub-tiles
//   (64 keys; 32 at hd 256, where the output accumulator alone takes 128
//   registers a thread) arrive through a two-stage cp.async ring, one
//   block-wide barrier per sub-tile: the next sub-tile loads while this one
//   is multiplied. The query fragments stay in registers up to hd 128 and
//   are re-read from shared memory per k-step at hd 256. Head dims pad to
//   16, 32, 64, 128 or 256 with zero columns (hd 8 to the mma's k of 16).
//   Masks run only on sub-tiles that straddle kv_len, the diagonal or the
//   window edge; softcap (tanhf) runs before them. exp is ex2.approx of
//   (s - m) * log2(e): the difference comes first, so NEG_INF - NEG_INF is 0
//   and a masked key's 2^(-huge) is 0.
// * float32 -> flash_fwd_kernel, FFMA on the CUDA cores: full f32 products
//   keep the 1e-5 agreement with the plain version (tensor cores would
//   round the inputs to TF32). Laid out below, before the kernel.
//
// Both routes: blocks on Hopper run in no order, so where the TPU kernel
// walks a sequential (bh, q block, kv block) grid with m, l and acc in
// VMEM, one CTA loops over the key sub-tiles of its band itself. A sub-tile
// outside the causal or window band, or past kv_len, is not visited: every
// block the TPU skips is skipped here, and the extra skips drop only keys
// that would be masked, which changes nothing for a row that sees any key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -2.3819763e38f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, hd, H, Hkv, causal, window, kv_len;
  float softcap;
};

// ---------------------------------------------------------------------------
// bfloat16 route: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

namespace mma {

constexpr int kBQ = 64;       // query rows per CTA: 4 warps x 16
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;    // cp.async ring depth of the K / V sub-tiles
constexpr int kPad = 8;       // bf16 elements of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

template <int HDP> constexpr int block_k() { return HDP >= 256 ? 32 : 64; }

template <int HDP> constexpr size_t smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(kBQ + 2 * kStages * block_k<HDP>()) *
         (HDP + kPad);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; 2^-inf = +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&t);
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): the f32
// accumulator of an n-tile holds (row g, cols 2t, 2t+1) in c[0..1] and
// (row g+8, the same cols) in c[2..3]; the A operand holds (row g, k 2t..)
// in a[0], (row g+8, k 2t..) in a[1], (row g, k 8+2t..) in a[2] and
// (row g+8, k 8+2t..) in a[3]. ldmatrix.x4 returns matrix i (rows given by
// lanes 8i..8i+7) in r[i], lane l holding row l / 4, cols 2(l % 4)..+1.
// Up to head pad 64 the kernel fits 128 registers, so four CTAs share an SM.
template <int HDP, int BK>
__global__ void __launch_bounds__(kThreads, HDP <= 64 ? 4 : 1) flash_mma_kernel(Args a) {
  constexpr int LD = HDP + kPad;  // shared row stride in bf16 elements
  constexpr bool kQInRegs = HDP <= 128;
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);  // [kBQ][LD]
  bf16* ks = qs + kBQ * LD;                     // [kStages][BK][LD]
  bf16* vs = ks + kStages * BK * LD;            // [kStages][BK][LD]

  const int hd = a.hd;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int h = bh % a.H;
  const int kvh = (bh / a.H) * a.Hkv + h / (a.H / a.Hkv);
  const bf16* q = static_cast<const bf16*>(a.q) + (static_cast<long long>(bh) * a.S + q0) * hd;
  const bf16* k = static_cast<const bf16*>(a.k) + static_cast<long long>(kvh) * a.T * hd;
  const bf16* v = static_cast<const bf16*>(a.v) + static_cast<long long>(kvh) * a.T * hd;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int chunks = hd / 8;  // 16-byte chunks per row

  // zero the head-dim padding [hd, HDP) of every shared row once: cp.async
  // writes only [0, hd), so it stays zero and adds nothing to either product
  if (hd < HDP) {
    const int pc = (HDP - hd) / 8;
    for (int i = tid; i < (kBQ + 2 * kStages * BK) * pc; i += kThreads) {
      *reinterpret_cast<uint4*>(qs + (i / pc) * LD + hd + (i % pc) * 8) = make_uint4(0, 0, 0, 0);
    }
  }

  // the band: key sub-tiles [kb_lo, kb_hi)
  int kb_hi = (a.kv_len + BK - 1) / BK;
  if (a.causal) kb_hi = min(kb_hi, (q0 + kBQ - 1) / BK + 1);
  int kb_lo = 0;
  if (a.window) {
    const int x = q0 - a.window - BK + 1;  // sub-tiles with kb * BK <= x are left of it
    if (x >= 0) kb_lo = x / BK + 1;
  }

  auto load_kv = [&](int kb, int stage) {
    const long long base = static_cast<long long>(kb) * BK * hd;
    bf16* kd = ks + stage * BK * LD;
    bf16* vd = vs + stage * BK * LD;
    for (int i = tid; i < BK * chunks; i += kThreads) {
      const int r = i / chunks, c = (i % chunks) * 8;
      cp_async16(kd + r * LD + c, k + base + static_cast<long long>(r) * hd + c);
      cp_async16(vd + r * LD + c, v + base + static_cast<long long>(r) * hd + c);
    }
  };

  for (int i = tid; i < kBQ * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    cp_async16(qs + r * LD + c, q + static_cast<long long>(r) * hd + c);
  }
  cp_async_commit();
  if (kb_lo < kb_hi) load_kv(kb_lo, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the query tile has landed
  __syncthreads();

  // lane l addresses row l % 16, column block l / 16 of a 16 x 16 A tile
  const bf16* qa = qs + (warp * 16 + (lane & 15)) * LD + ((lane >> 4) << 3);
  uint32_t qf[kQInRegs ? HDP / 16 : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
  }
  // K (non-trans) and V (trans) ldmatrix.x4 lane offsets within a sub-tile
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);

  float o[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf;  // rows g and g + 8 of the warp's 16
  float l_lo = 0.0f, l_hi = 0.0f;        // this lane's share of their sums
  const int qpos_lo = q0 + warp * 16 + g;

  for (int kb = kb_lo, it = 0; kb < kb_hi; ++kb, ++it) {
    cp_async_wait<0>();
    __syncthreads();  // sub-tile kb landed; every warp is done with kb - 1's stage
    if (kb + 1 < kb_hi) load_kv(kb + 1, (it + 1) & 1);
    cp_async_commit();
    const bf16* kt = ks + (it & 1) * BK * LD;
    const bf16* vt = vs + (it & 1) * BK * LD;
    const int k0 = kb * BK;

    // S = Q K^T: BK / 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t af[4];
      if constexpr (kQInRegs) {
        af[0] = qf[kk][0]; af[1] = qf[kk][1]; af[2] = qf[kk][2]; af[3] = qf[kk][3];
      } else {
        ldmatrix_x4(af, qa + kk * 16);
      }
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + nj * 16 * LD + kk * 16 + k_off);
        mma_bf16(s[2 * nj], af, b[0], b[1]);
        mma_bf16(s[2 * nj + 1], af, b[2], b[3]);
      }
    }

    // softcap, then the masks where the sub-tile straddles an edge
    const bool edge = k0 + BK > a.kv_len || (a.causal && k0 + BK - 1 > q0) ||
                      (a.window && q0 + kBQ - 1 - k0 >= a.window);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (a.softcap != 0.0f) x = a.softcap * tanhf(x / a.softcap);
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qpos = qpos_lo + (e >> 1) * 8;
          bool ok = kpos < a.kv_len;
          if (a.causal) ok = ok && qpos >= kpos;
          if (a.window) ok = ok && qpos - kpos < a.window;
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = ex2((m_lo - mn_lo) * kLog2e);
    const float al_hi = ex2((m_hi - mn_hi) * kLog2e);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float rs_lo = 0.0f, rs_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = ex2((s[j][0] - mn_lo) * kLog2e);
      s[j][1] = ex2((s[j][1] - mn_lo) * kLog2e);
      s[j][2] = ex2((s[j][2] - mn_hi) * kLog2e);
      s[j][3] = ex2((s[j][3] - mn_hi) * kLog2e);
      rs_lo += s[j][0] + s[j][1];
      rs_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * al_lo + rs_lo;
    l_hi = l_hi * al_hi + rs_hi;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      o[n][0] *= al_lo;
      o[n][1] *= al_lo;
      o[n][2] *= al_hi;
      o[n][3] *= al_hi;
    }

    // O += P V: P rounded to bf16 in registers, n-tiles 2kk and 2kk + 1 of
    // S forming the A operand of k-step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < HDP / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + kk * 16 * LD + dn * 16 + v_off);
        mma_bf16(o[2 * dn], pa, b[0], b[1]);
        mma_bf16(o[2 * dn + 1], pa, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
  bf16* out = static_cast<bf16*>(a.o) + (static_cast<long long>(bh) * a.S + q0 + warp * 16) * hd;
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (col < hd) {  // hd is a multiple of 8, so col + 1 < hd too
      *reinterpret_cast<uint32_t*>(out + g * hd + col) = pack_bf16(o[n][0] / d_lo, o[n][1] / d_lo);
      *reinterpret_cast<uint32_t*>(out + (g + 8) * hd + col) =
          pack_bf16(o[n][2] / d_hi, o[n][3] / d_hi);
    }
  }
}

template <int HDP>
int launch(const Args& a, int BH, int bk, int smem, cudaStream_t stream) {
  constexpr int BK = block_k<HDP>();
  constexpr size_t bytes = smem_bytes<HDP>();
  if (bk != BK || static_cast<size_t>(smem) != bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the opt-in above 48 KB, once per template instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_mma_kernel<HDP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.S / kBQ, BH);
  flash_mma_kernel<HDP, BK><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

// ---------------------------------------------------------------------------
// float32 route: flash_fwd_kernel, FFMA on the CUDA cores
// ---------------------------------------------------------------------------
//
// What bounds it: 2 * hd FFMA per visible (query, key) pair on the CUDA
// cores (67 TFLOP/s of f32 on an H100 SXM), so the kernel is built to keep
// the FMA pipes fed: every other instruction (shared loads, softmax,
// barriers) takes an issue slot from them, and every dependent chain that
// no other warp covers idles them.
//
// Layout. One CTA of kWarps warps owns a (bh, 64-row query tile); a warp owns
// R of its rows end to end (R = 16, 8 at head pad 256), in registers: its S
// tile, its rows' m and l, and its rows' output accumulator. The query tile
// and a two-stage cp.async ring of K and V sub-tiles (BK keys) sit row-major
// in shared memory, each row padded by 4 floats: a row stride of HDP + 4
// floats is an odd number of 16-byte groups, so the 8 rows that one phase of
// an LDS.128 reads lie in 8 distinct groups of 4 banks. One block barrier
// per sub-tile; the next sub-tile loads while this one is multiplied. Up to
// head pad 64 two CTAs (8 warps) share an SM; the query tiles run last
// first, so that under a causal mask the heaviest start first.
//
// Lanes split an 8-row group's work two ways. With RG = R / 8 row groups,
// a lane's rows are rg + RG * i (i < 8), interleaved so that the row groups'
// q loads fall in different banks.
// * S = Q K^T: lane (rg, ds, kg) holds an 8-row x 4-key micro-tile, keys
//   kg + KG * j. Each 16-byte step along hd is 8 q and 4 k LDS.128 for 128
//   FFMA. Where a warp has fewer key groups than lanes (BK = 32, or R = 8),
//   DS lanes share a micro-tile, each summing every DS-th 4-wide chunk of
//   hd, and add their partial sums with shuffles.
// * O += P V: lane (rg, ks, cg) holds an 8-row x 8-column accumulator
//   (NC = 2 float4 columns, cg*4 and cg*4 + 4*CG), over the keys ks + KS * t.
//   Per key: 2 LDS.128 of p and 2 of v for 64 FFMA. Where a warp has fewer
//   column groups than lanes (head pad 16, 32 and 64), KS lanes split the
//   keys and add their accumulators once, at the end: the rescaling by
//   alpha is per row, so it commutes with that sum.
// P passes between the two layouts through the warp's own slice of shared
// memory, [key][row] with a row stride of R + 4 floats, after __syncwarp():
// no block barrier. A row's max reduces over its key-group lanes with
// shuffles; its sum stays a per-lane partial until the end.
//
// Softmax. Masks run only on sub-tiles that straddle kv_len, the diagonal
// or the window edge; softcap (c * tanhf(s / c), the division as a product
// with 1 / c) runs before them. Each step of the softmax runs over all 8
// rows before the next, with no branch inside, so the rows' shuffle and
// exp chains overlap: a branch inside a loop over rows splits it into
// basic blocks and exposes one row's chain of dependent shuffles at a time. exp
// is ex2.approx of (s - m) * log2(e), as on the bf16 route: the difference
// comes first, so NEG_INF - NEG_INF is 0 and a masked key's 2^(-huge) is 0;
// its relative error (about 2^-22) stays far inside the route's 1e-5.

namespace f32 {

constexpr int kBQ = 64;      // query rows per CTA
constexpr int kStages = 2;   // cp.async ring depth of the K / V sub-tiles
constexpr int kPad = 4;      // floats of padding per shared row

// The launch shape of one head pad: rows per warp, warps, keys per sub-tile
// and the two lane layouts derived from them (see above).
template <int HDP> struct Cfg {
  static constexpr int R = HDP >= 256 ? 8 : 16;
  static constexpr int kWarps = kBQ / R;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BK = HDP >= 128 ? 32 : 64;
  static constexpr int RG = R / 8;
  static constexpr int KG = BK / 4;
  static constexpr int DS = 32 / (RG * KG);
  static constexpr int NC = 2;
  static constexpr int CG = HDP / (4 * NC);
  static constexpr int KS = 32 / (RG * CG);
  static constexpr int LD = HDP + kPad;  // q, k, v row stride in floats
  static constexpr int PLD = R + kPad;   // p row (one key) stride in floats
  static constexpr size_t smem = sizeof(float) * (static_cast<size_t>(kBQ + 2 * kStages * BK) * LD +
                                                  static_cast<size_t>(kWarps) * BK * PLD);
  static_assert(RG * KG * DS == 32 && RG * CG * KS == 32 && CG * 4 * NC == HDP, "lane layout");
  static_assert(4 % DS == 0 && (HDP / 4) % DS == 0 && BK % KS == 0, "lane splits");
};

template <int HDP>
__global__ void __launch_bounds__(Cfg<HDP>::kThreads, HDP <= 64 ? 2 : 1)
    flash_fwd_kernel(Args a) {
  using C = Cfg<HDP>;
  constexpr int R = C::R, BK = C::BK, RG = C::RG, KG = C::KG, DS = C::DS;
  constexpr int NC = C::NC, CG = C::CG, KS = C::KS, LD = C::LD, PLD = C::PLD;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // [kBQ][LD]
  float* ks = qs + kBQ * LD;                      // [kStages][BK][LD]
  float* vs = ks + kStages * BK * LD;             // [kStages][BK][LD]
  float* ps = vs + kStages * BK * LD;             // [kWarps][BK][PLD]

  const int hd = a.hd;
  const int bh = blockIdx.y;
  // the last query tiles first: under a causal mask they see the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = bh % a.H;
  const int kvh = (bh / a.H) * a.Hkv + h / (a.H / a.Hkv);
  const float* q = static_cast<const float*>(a.q) + (static_cast<long long>(bh) * a.S + q0) * hd;
  const float* k = static_cast<const float*>(a.k) + static_cast<long long>(kvh) * a.T * hd;
  const float* v = static_cast<const float*>(a.v) + static_cast<long long>(kvh) * a.T * hd;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / (32 / RG);
  const int ds = (lane / KG) % DS, kg = lane % KG;  // S = Q K^T
  const int kq = (lane / CG) % KS, cg = lane % CG;  // O += P V

  // zero the head-dim padding [hd, HDP) of every q, k and v row once:
  // cp.async writes only [0, hd), so it stays zero and adds nothing
  if (hd < HDP) {
    const int pc = (HDP - hd) / 4;
    for (int i = tid; i < (kBQ + 2 * kStages * BK) * pc; i += C::kThreads) {
      *reinterpret_cast<float4*>(qs + (i / pc) * LD + hd + (i % pc) * 4) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // the band: key sub-tiles [kb_lo, kb_hi)
  int kb_hi = (a.kv_len + BK - 1) / BK;
  if (a.causal) kb_hi = min(kb_hi, (q0 + kBQ - 1) / BK + 1);
  int kb_lo = 0;
  if (a.window) {
    const int x = q0 - a.window - BK + 1;  // sub-tiles with kb * BK <= x are left of it
    if (x >= 0) kb_lo = x / BK + 1;
  }

  // 16-byte chunks in steps of the CTA: the chunk count per row is the
  // compile-time HDP / 4, so a thread's column is fixed and its row steps
  // by a constant; columns at hd and past it are padding and are skipped
  constexpr int kChunks = HDP / 4;
  constexpr int kRowStep = C::kThreads / kChunks;
  static_assert(C::kThreads % kChunks == 0 && BK % kRowStep == 0, "copy layout");
  const int c_col = (tid % kChunks) * 4, c_row = tid / kChunks;
  const bool c_live = c_col < hd;
  auto load_kv = [&](int kb, int stage) {
    if (!c_live) return;
    const float* ksrc = k + (static_cast<long long>(kb) * BK + c_row) * hd + c_col;
    const float* vsrc = v + (static_cast<long long>(kb) * BK + c_row) * hd + c_col;
    float* kd = ks + stage * BK * LD + c_row * LD + c_col;
    float* vd = vs + stage * BK * LD + c_row * LD + c_col;
#pragma unroll
    for (int r = 0; r < BK; r += kRowStep) {
      mma::cp_async16(kd + r * LD, ksrc + static_cast<long long>(r) * hd);
      mma::cp_async16(vd + r * LD, vsrc + static_cast<long long>(r) * hd);
    }
  };

  if (c_live) {
#pragma unroll
    for (int r = 0; r < kBQ; r += kRowStep) {
      mma::cp_async16(qs + (c_row + r) * LD + c_col, q + static_cast<long long>(c_row + r) * hd + c_col);
    }
  }
  mma::cp_async_commit();
  if (kb_lo < kb_hi) load_kv(kb_lo, 0);
  mma::cp_async_commit();

  const int row0 = warp * R + rg;                  // the lane's row i is row0 + RG * i
  const float* qa = qs + row0 * LD + ds * 4;       // S layout: its q rows and d chunks
  float* pw = ps + warp * BK * PLD;                // the warp's p slice, [key][slot]
  const float* pr_base = pw + rg * 8;              // P V layout: its 8 rows' p
  float acc[8][NC][4];
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;  // this lane's share of the row's sum
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.0f;
  }

  for (int kb = kb_lo, it = 0; kb < kb_hi; ++kb, ++it) {
    mma::cp_async_wait<0>();
    __syncthreads();  // sub-tile kb (and the q tile) landed; every warp is done with kb - 1
    if (kb + 1 < kb_hi) load_kv(kb + 1, (it + 1) & 1);
    mma::cp_async_commit();
    const float* kt = ks + (it & 1) * BK * LD;
    const float* vt = vs + (it & 1) * BK * LD;
    const int k0 = kb * BK;

    // S = Q K^T: 8 rows x 4 keys, every DS-th 16-byte chunk of hd
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    const float* kr = kt + kg * LD + ds * 4;
#pragma unroll
    for (int u = 0; u < HDP / 4 / DS; ++u) {
      const int d = u * DS * 4;
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(kr + j * KG * LD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qa + i * RG * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    if constexpr (DS > 1) {
#pragma unroll
      for (int off = KG; off < KG * DS; off <<= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], off);
    }

    // softcap, the masks where the sub-tile straddles an edge, online
    // softmax. Each step runs over all 8 rows before the next, with no
    // branch inside, so the rows' shuffle and exp chains overlap.
    if (a.softcap != 0.0f) {
      const float inv = 1.0f / a.softcap;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = a.softcap * tanhf(s[i][j] * inv);
    }
    if (k0 + BK > a.kv_len || (a.causal && k0 + BK - 1 > q0) ||
        (a.window && q0 + kBQ - 1 - k0 >= a.window)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qpos = q0 + row0 + RG * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + kg + KG * j;
          bool ok = kpos < a.kv_len;
          if (a.causal) ok = ok && qpos >= kpos;
          if (a.window) ok = ok && qpos - kpos < a.window;
          s[i][j] = ok ? s[i][j] : kNegInf;
        }
      }
    }
    float mx[8], alpha[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) mx[i] = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
    for (int off = 1; off < KG; off <<= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = mma::ex2((m[i] - mn) * mma::kLog2e);
      m[i] = mn;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mma::ex2((s[i][j] - mn) * mma::kLog2e);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha[i] + rs;
    }

    // p into the warp's slice: key kg + KG * j, slots rg * 8 .. rg * 8 + 7;
    // the DS lanes of a micro-tile hold the same p and store a key each
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j % DS != ds) continue;
      float* dst = pw + (kg + KG * j) * PLD + rg * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= alpha[i];
    __syncwarp();

    // O += P V: 8 rows x 4 * NC columns over the keys kq + KS * t
    const float* vc = vt + cg * 4;
#pragma unroll
    for (int t = 0; t < BK / KS; ++t) {
      const int c = t * KS + kq;
      const float4 p0 = *reinterpret_cast<const float4*>(pr_base + c * PLD);
      const float4 p1 = *reinterpret_cast<const float4*>(pr_base + c * PLD + 4);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 x = *reinterpret_cast<const float4*>(vc + c * LD + n * 4 * CG);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][n][0] = fmaf(p[i], x.x, acc[i][n][0]);
          acc[i][n][1] = fmaf(p[i], x.y, acc[i][n][1]);
          acc[i][n][2] = fmaf(p[i], x.z, acc[i][n][2]);
          acc[i][n][3] = fmaf(p[i], x.w, acc[i][n][3]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();

  // the row sums over the key-group lanes, the accumulators over the key splits
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int off = 1; off < KG; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  if constexpr (KS > 1) {
#pragma unroll
    for (int off = CG; off < CG * KS; off <<= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] += __shfl_xor_sync(0xffffffffu, acc[i][n][e], off);
  }

  float* out = static_cast<float*>(a.o) + (static_cast<long long>(bh) * a.S + q0 + row0) * hd;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i % KS != kq) continue;  // the KS lanes that share a row write a share each
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = cg * 4 + n * 4 * CG;
      if (col < hd) {  // hd is a multiple of 8, so the 4 columns are all < hd
        *reinterpret_cast<float4*>(out + RG * i * hd + col) =
            make_float4(acc[i][n][0] / li, acc[i][n][1] / li, acc[i][n][2] / li, acc[i][n][3] / li);
      }
    }
  }
}

template <int HDP>
int launch(const Args& a, int BH, int bk, int smem, cudaStream_t stream) {
  using C = Cfg<HDP>;
  if (bk != C::BK || static_cast<size_t>(smem) != C::smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the opt-in above 48 KB, once per template instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.S / kBQ, BH);
  flash_fwd_kernel<HDP><<<grid, C::kThreads, C::smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// dtype: 0 float32 (flash_fwd_kernel), 1 bfloat16 (flash_mma_kernel).
// q (BH, S, hd), k and v (BH / H * Hkv, T, hd), out like q; S and T
// multiples of 128, hd a multiple of 8 up to 256 (the wrapper checks).
// hdp, block_k and smem are the wrapper's plan (padded head dim, keys per
// sub-tile, dynamic shared bytes); a plan this file does not build is
// refused with cudaErrorInvalidValue. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* out, int BH, int S, int T, int hd, int H, int Hkv,
                                   int causal, int window, float softcap, int kv_len, int hdp,
                                   int block_k, int smem, void* stream) {
  const Args a{q, k, v, out, S, T, hd, H, Hkv, causal, window, kv_len, softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd > hdp) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    switch (hdp) {
      case 16: return mma::launch<16>(a, BH, block_k, smem, st);
      case 32: return mma::launch<32>(a, BH, block_k, smem, st);
      case 64: return mma::launch<64>(a, BH, block_k, smem, st);
      case 128: return mma::launch<128>(a, BH, block_k, smem, st);
      case 256: return mma::launch<256>(a, BH, block_k, smem, st);
    }
  } else if (dtype == 0) {
    switch (hdp) {
      case 16: return f32::launch<16>(a, BH, block_k, smem, st);
      case 32: return f32::launch<32>(a, BH, block_k, smem, st);
      case 64: return f32::launch<64>(a, BH, block_k, smem, st);
      case 128: return f32::launch<128>(a, BH, block_k, smem, st);
      case 256: return f32::launch<256>(a, BH, block_k, smem, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

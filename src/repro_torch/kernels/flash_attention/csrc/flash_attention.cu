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
// bound it. This first kernel runs them as float32 FMAs on the CUDA cores,
// not on the tensor cores (wgmma, TMA and pipelining are later work).
//
// Design. The TPU kernel walks a sequential grid (bh, q block, kv block)
// and keeps m, l and acc in VMEM from one kv step to the next. Blocks on
// Hopper run in no order, so one CTA owns one (bh, 64-row query tile) and
// loops over the key sub-tiles of its band itself, holding m, l and the
// (64 x hd) accumulator in registers. The query tile and each 64-key
// sub-tile of k sit transposed in shared memory ([d][row], float32) so that
// a thread reads 4 query rows and 4 keys as two float4 loads per d; v sits
// row-major. 256 threads: thread (ty, tx) = (tid / 16, tid % 16) owns query
// rows 4ty..4ty+3, the score columns 4tx..4tx+3 of each sub-tile and the
// output columns tx + 16j. A row's max and sum reduce over the 16 lanes of
// its half-warp with shuffles. Sub-tiles are 64 x 64 where the TPU used
// 128 x 128 (at hd = 256 the float32 tiles then take 217 KB of shared
// memory), and a sub-tile is skipped when it lies outside the causal or
// window band, or past kv_len: every block the TPU skips is skipped here,
// and the extra skips drop only keys that would be masked, which changes
// nothing for a row that sees any key. expf and tanhf, no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per shared-memory sub-tile
constexpr int kThreads = 256;
constexpr int kLd = kBQ + 4;   // row stride of the transposed tiles (kBK == kBQ)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, hd, H, Hkv, causal, window, kv_len;
  float softcap;
};

size_t smem_bytes(int hd, int hdp) {
  return sizeof(float) * (2 * static_cast<size_t>(hd) * kLd + kBK * hdp + kBK * kLd);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [hd][kLd]  query tile, transposed
  float* kt = qt + a.hd * kLd;                  // [hd][kLd]  key sub-tile, transposed
  float* vs = kt + a.hd * kLd;                  // [kBK][HDP] value sub-tile
  float* pt = vs + kBK * HDP;                   // [kBK][kLd] probabilities, transposed
  constexpr int kCols = HDP / 16;

  const int hd = a.hd;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int h = bh % a.H;
  const int kvh = (bh / a.H) * a.Hkv + h / (a.H / a.Hkv);
  const T* q = static_cast<const T*>(a.q) + (static_cast<long long>(bh) * a.S + q0) * hd;
  const T* k = static_cast<const T*>(a.k) + static_cast<long long>(kvh) * a.T * hd;
  const T* v = static_cast<const T*>(a.v) + static_cast<long long>(kvh) * a.T * hd;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < kBQ * hd; i += kThreads) qt[(i % hd) * kLd + i / hd] = to_f32(q[i]);
  for (int i = tid; i < kBK * HDP; i += kThreads) vs[i] = 0.0f;  // columns >= hd stay 0

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  const int n_kv = (a.kv_len + kBK - 1) / kBK;
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * kBK;
    if (a.causal && k0 > q0 + kBQ - 1) break;             // right of the band
    if (a.window && k0 + kBK - 1 <= q0 - a.window) continue;  // left of the band
    __syncthreads();  // the previous sub-tile's readers are done
    const T* kk = k + static_cast<long long>(k0) * hd;
    const T* vv = v + static_cast<long long>(k0) * hd;
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int c = i / hd, d = i % hd;
      kt[d * kLd + c] = to_f32(kk[i]);
      vs[c * HDP + d] = to_f32(vv[i]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = s[i][j];
        if (a.softcap != 0.0f) x = a.softcap * tanhf(x / a.softcap);
        bool ok = kpos < a.kv_len;
        if (a.causal) ok = ok && qpos >= kpos;
        if (a.window) ok = ok && qpos - kpos < a.window;
        s[i][j] = ok ? x : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    // p, rounded to v's dtype, into pt[key][row]: one float4 of 4 rows per key
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 pr;
      pr.x = to_f32(from_f32<T>(s[0][j]));
      pr.y = to_f32(from_f32<T>(s[1][j]));
      pr.z = to_f32(from_f32<T>(s[2][j]));
      pr.w = to_f32(from_f32<T>(s[3][j]));
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLd + ty * 4) = pr;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * kLd + ty * 4);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float x = vs[c * HDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], x, acc[i][j]);
      }
    }
  }

  T* o = static_cast<T*>(a.o) + (static_cast<long long>(bh) * a.S + q0) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) o[(ty * 4 + i) * hd + col] = from_f32<T>(acc[i][j] / li);
    }
  }
}

template <typename T, int HDP>
int launch(const Args& a, int BH, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.hd, HDP);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.S / kBQ, BH);
  flash_fwd_kernel<T, HDP><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int BH, cudaStream_t stream) {
  if (a.hd <= 16) return launch<T, 16>(a, BH, stream);
  if (a.hd <= 32) return launch<T, 32>(a, BH, stream);
  if (a.hd <= 64) return launch<T, 64>(a, BH, stream);
  if (a.hd <= 128) return launch<T, 128>(a, BH, stream);
  return launch<T, 256>(a, BH, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q (BH, S, hd), k and v (BH / H * Hkv, T, hd),
// out like q; S and T multiples of 128, hd a multiple of 8 up to 256 (the
// wrapper checks). Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* out, int BH, int S, int T, int hd, int H, int Hkv,
                                   int causal, int window, float softcap, int kv_len,
                                   void* stream) {
  const Args a{q, k, v, out, S, T, hd, H, Hkv, causal, window, kv_len, softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(a, BH, st) : dispatch<float>(a, BH, st);
}

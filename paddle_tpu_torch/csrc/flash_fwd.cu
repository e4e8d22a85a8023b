// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/attention.py `_fwd_kernel` (launched by
// `_flash_fwd_pallas`), the FlashAttention-2 forward that every Llama
// prefill and prefix-cache suffix prefill runs.
//
// Computes, per (batch, query head) and query row q:
//   s[k]   = (q . k[k]) * scale + mask[b, h, q, k]          (f32)
//   s[k]   = -1e30 where k >= Sk, causal and k > q, or k >= kv_lens[b]
//   out[q] = sum_k softmax(s)[k] * v[k];   lse[q] = m + log(l)
// with the mask broadcast over batch / head / query axes through zero
// strides, grouped-query attention by mapping query head h onto KV head
// h / (H / Hkv) (K/V are never repeated), and Sq != Sk allowed.
// P is rounded to the input dtype before the P.V product, like the
// reference (`p_acc.astype(v.dtype)`); the normalizer uses unrounded P.
//
// Attention dropout (`dscale` > 0): the reference's counter hash
// (`_fmix32` / `dropout_keep_mask`, attention.py:87-139). Element
// (b, h, q, k) is kept iff
//   fmix32(fmix32(fmix32((b*H + h) ^ seed0) ^ q) ^ k ^ seed1) >= thresh
// in uint32, with absolute q and k, so the backward kernels regenerate
// the same bits whatever their tiling. A kept P is multiplied by
// dscale = 1 / (1 - p) before rounding; a dropped one is 0. The
// normalizer and lse keep the P before dropout. The first hash is taken
// once per block, the second once per (row, tile), the third per element.
//
// Bound on the H100: at prefill sizes (S in the hundreds, D = 128) the
// work is ~S operations per byte, so it is compute-bound; the card's
// ceiling is the bf16 tensor-core rate. This first version runs on the
// FMA units (no mma/wgmma yet, which is later work): one block of 256
// threads per (batch*head, 64-row query tile) keeps the Q tile, one K
// and one V tile (64 rows, f32) and the 64x64 score tile in shared
// memory; each thread owns a 4x4 score micro-tile and a 4 x D/16 slice
// of the f32 output accumulator in registers. The loop over KV tiles
// inside the block replaces the TPU's sequential third grid axis and
// carries the online-softmax max / sum per row in shared memory. Under
// `causal`, KV tiles past the tile's last query row are skipped. Scores
// never leave the chip: device memory sees Q, K, V and the mask read
// once per query tile and the output written once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// murmur3 finalizer (the reference's `_fmix32`): unsigned arithmetic, so
// products wrap mod 2^32 and shifts are logical
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  return kBQ * (D + 1)      // Q tile
         + kBK * (D + 1)    // K tile
         + kBK * D          // V tile
         + kBQ * (kBK + 1)  // scores / probabilities
         + 3 * kBQ;         // running max, sum, rescale factor
}

// DROP = false compiles the dropout away
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ mask,
    const int* __restrict__ kv_lens, T* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
    long long msb, long long msh, long long msq, long long msk,
    float scale, int causal, uint32_t seed0, uint32_t seed1, uint32_t thresh,
    float dscale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* Ss = Vs + kBK * D;
  float* m_s = Ss + kBQ * (kBK + 1);
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;

  const long long q_stride = (long long)H * D;     // between query rows
  const long long kv_stride = (long long)Hkv * D;  // between key rows
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Sk * Hkv + hk) * D;
  const T* vb = v + ((long long)b * Sk * Hkv + hk) * D;
  const float* mb = mask ? mask + b * msb + h * msh : nullptr;
  const int len = kv_lens ? kv_lens[b] : Sk;
  const uint32_t row_key = fmix32((uint32_t)bh ^ seed0);  // dropout row

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * (D + 1) + c] = s < Sq ? to_f(qb[s * q_stride + c]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  constexpr int NC = D / 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  // causal tile skip: KV tiles starting past the last query row of this
  // tile are fully masked for every row in it
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, s = k0 + r;
      float kv = 0.f, vv = 0.f;  // tail rows are zero, never garbage
      if (s < Sk) {
        kv = to_f(kb[s * kv_stride + c]);
        vv = to_f(vb[s * kv_stride + c]);
      }
      Ks[r * (D + 1) + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, ki = k0 + c;
        float s = sc[i][j] * scale;
        bool keep = ki < Sk;
        if (mb && keep && qi < Sq) s += mb[qi * msq + ki * msk];
        if (causal) keep = keep && qi >= ki;
        keep = keep && ki < len;
        Ss[r * (kBK + 1) + c] = keep ? s : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, two columns per lane
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float* row = Ss + r * (kBK + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      if constexpr (DROP) {  // dropout after the normalizer's sum
        const uint32_t xq = fmix32(row_key ^ (uint32_t)(q0 + r));
        const uint32_t k_lo = (uint32_t)(k0 + lane);
        p0 = fmix32(xq ^ k_lo ^ seed1) >= thresh ? p0 * dscale : 0.f;
        p1 = fmix32(xq ^ (k_lo + 32u) ^ seed1) >= thresh ? p1 * dscale : 0.f;
      }
      row[lane] = to_f(from_f<T>(p0));
      row[lane + 32] = to_f(from_f<T>(p1));
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * Sq * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = l_s[r];
    const float safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[qi * q_stride + tx + 16 * j] = from_f<T>(acc[i][j] / safe);
    if (tx == 0) lse[(long long)bh * Sq + qi] = m_s[r] + logf(safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const int* kv_lens, void* out, float* lse, int B, int Sq, int Sk,
           int H, int Hkv, long long msb, long long msh, long long msq,
           long long msk, float scale, int causal, int seed0, int seed1,
           unsigned thresh, float dscale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = dscale > 0.f ? flash_fwd_kernel<T, D, true>
                           : flash_fwd_kernel<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, kv_lens, static_cast<T*>(out), lse,
      Sq, Sk, H, Hkv, msb, msh, msq, msk, scale, causal, (uint32_t)seed0,
      (uint32_t)seed1, (uint32_t)thresh, dscale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Layouts: q/out [B, Sq, H, D],
// k/v [B, Sk, Hkv, D], lse [B, H, Sq], all contiguous; mask (may be
// null) is f32 addressed as mask[b*msb + h*msh + q*msq + k*msk];
// kv_lens (may be null) is int32 [B]. Dropout: dscale = 1 / (1 - p) as
// f32, 0 for none; thresh = min(2^32 - 1, round(p * 2^32)); seed0 and
// seed1 the call's two int32 seeds. Returns cudaGetLastError().
extern "C" int flash_fwd(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, const float* mask,
                         const int* kv_lens, void* out, float* lse, int B,
                         int Sq, int Sk, int H, int Hkv, long long msb,
                         long long msh, long long msq, long long msk,
                         float scale, int causal, int seed0, int seed1,
                         unsigned thresh, float dscale, cudaStream_t stream) {
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || B <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
#define FLASH_CASE(T, D)                                                  \
  return launch<T, D>(q, k, v, mask, kv_lens, out, lse, B, Sq, Sk, H, Hkv, \
                      msb, msh, msq, msk, scale, causal, seed0, seed1,  \
                      thresh, dscale, stream)
  if (dtype == 0 && head_dim == 64) FLASH_CASE(float, 64);
  if (dtype == 0 && head_dim == 128) FLASH_CASE(float, 128);
  if (dtype == 1 && head_dim == 64) FLASH_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) FLASH_CASE(__nv_bfloat16, 128);
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

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
// Bound on the H100: at prefill and training sizes (S in the hundreds to
// thousands, D = 128) the work is ~S operations per byte, so it is
// compute-bound; the card's ceiling is the bf16 tensor-core rate (at
// q[2, 2048, 32, 128] causal: 6.9e10 operations, 0.0695 ms at 989
// TFLOP/s). Scores never leave the chip: device memory sees Q, K, V and
// the mask read once per query tile and the output written once.
//
// bf16 (dtype 1): `tc::flash_fwd_wgmma`, FlashAttention-3's forward in
// its simplest form. A CTA of one warpgroup (128 threads, kFwdWG) owns 64
// query rows of one (batch, query head); the query tiles with the longest
// causal rows are launched first, two CTAs per SM (81,920 bytes of shared
// memory at D = 128, 99,328 with a staged mask). The Q tile sits in shared
// memory in the
// 128-byte-swizzled layout that wgmma's descriptors read; K and V tiles of
// 64 keys (kFwdBN) stream through 2-stage cp.async rings, so the next
// tile's copies overlap the current tile's products (rows past kv_lens or
// Sk are zero-filled, never read). Per tile: S = Q K^T is `wgmma`
// m64n64k16 with both operands in shared memory, during which the tile's
// mask is copied by cp.async into a padded shared tile (or, where its
// rows are broadcast or not 16-byte aligned, read from L2 in the
// accumulator layout); then, in the accumulator registers, the scale,
// the additive mask, the keep test
// (bounds, causality, kv_lens; only on edge and diagonal tiles), the
// online max (shuffles within each quad of the layout) and P = ex2 of a
// prescaled fma (with a mask: of (s - m) * log2(e), so a row the mask
// sets wholly to -1e30 gets P = 1 and lse = -1e30 exactly, as the
// backward kernels expect). P is already wgmma's A-fragment layout: O +=
// P V is `wgmma` with A from registers and the key-major V tile read
// transposed, into f32 accumulators. P enters as bf16 hi + lo parts (hi =
// bf16(P), lo = bf16(P - hi): 16 significant bits; kFwdSplitP), so each P
// V runs twice on the same B: the reference and the plain version round
// the normalised P to one bf16, while this kernel can only round the
// unnormalised exp(s - m) of the running max; one bf16 each, the two
// roundings put an element of a short causal row at the training shape
// outside the card tolerance (chip_smoke.py); with hi + lo the kernel
// keeps P to 16 bits and only the plain version's rounding remains. Key
// tiles wholly past the causal edge or kv_lens are never loaded. Each
// thread keeps its rows' running max and a partial sum, reduced over the
// quad once at the end. One owner CTA per output tile and no atomics, so
// two launches agree bit for bit.
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_variants.py): two
// warpgroups per CTA, 128-key tiles, a 3-stage ring and the mask read
// from L2 where it could be staged were each slower.
// FlashAttention-3's intra-warpgroup order (tile i + 1's S started with
// tile i's P V, its softmax run while P V finishes) was slower too: ptxas
// serialized its products (C7514, C7520). Registers (ptxas -v, CUDA
// 12.8): 230 at D = 128 (243 with dropout, 254 with dropout and a staged
// mask), 180 at D = 64 (at most 222), no spills.
//
// f16 (dtype 2): the same kernel with f16 operands (`wgmma` m64nNk16
// .f32.f16.f16) and P as ONE f16 (kFwdSplitPF16 off). One f16 rounds the
// unnormalised exp(s - m) where the plain version rounds the normalised
// P, as one bf16 does, but each rounding is 2^-11 relative, so the two
// together stay within an f16 ulp of a row's output, inside TOL[float16];
// measured on an H100 80GB HBM3 at 700 W (tools/kernel_variants.py
// --dtype float16): one f16 P and hi + lo parts both gave a largest error
// of 1.95e-3 (one f16 ulp of outputs in [2, 4)) and no element outside
// the tolerance at the prefill shape and over four training-shape draws,
// and one P was 5 % (prefill) to 13 % (training shape) faster. P below
// f16's smallest subnormal (2^-24) is 0 in both versions, a weight below
// 2^-24 of the row's largest.
//
// Mixed dtypes (q of one of f32 / bf16 / f16, K and V of another: a
// prefix-cache suffix prefill whose cached pages have the KV pool's dtype
// and whose new keys the model's, concatenated, promoted as torch.cat
// promotes): the FMA kernel below with q read as TQ and K/V as TKV, each
// converted to f32 on load, P rounded to TKV before P.V as the plain
// version rounds it, the output in TQ; no dropout (inference only).
//
// f32 (dtype 0): the FMA-unit kernel below (TF32 is off in the port):
// one block of 256 threads per (batch*head, 64-row query tile) keeps the
// Q tile, one K and one V tile (64 rows, f32) and the 64x64 score tile
// in shared memory; each thread owns a 4x4 score micro-tile and a
// 4 x D/16 slice of the f32 output accumulator in registers. The loop
// over KV tiles inside the block replaces the TPU's sequential third
// grid axis and carries the online-softmax max / sum per row in shared
// memory. Under `causal`, KV tiles past the tile's last query row are
// skipped.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
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

// TQ is q's and the output's element type, TKV K's and V's (P is rounded
// to TKV before P.V); DROP = false compiles the dropout away
template <typename TQ, typename TKV, int D, bool DROP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ mask,
    const int* __restrict__ kv_lens, TQ* __restrict__ out,
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
  const TQ* qb = q + ((long long)b * Sq * H + h) * D;
  const TKV* kb = k + ((long long)b * Sk * Hkv + hk) * D;
  const TKV* vb = v + ((long long)b * Sk * Hkv + hk) * D;
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
      row[lane] = to_f(from_f<TKV>(p0));
      row[lane + 32] = to_f(from_f<TKV>(p1));
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

  TQ* ob = out + ((long long)b * Sq * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = l_s[r];
    const float safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[qi * q_stride + tx + 16 * j] = from_f<TQ>(acc[i][j] / safe);
    if (tx == 0) lse[(long long)bh * Sq + qi] = m_s[r] + logf(safe);
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const int* kv_lens, void* out, float* lse, int B, int Sq, int Sk,
           int H, int Hkv, long long msb, long long msh, long long msq,
           long long msk, float scale, int causal, int seed0, int seed1,
           unsigned thresh, float dscale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  constexpr bool ONE = std::is_same<TQ, TKV>::value;
  // mixed dtypes serve inference only: no dropout instance
  if (!ONE && dscale > 0.f) return (int)cudaErrorInvalidValue;
  auto kern = ONE && dscale > 0.f ? flash_fwd_kernel<TQ, TKV, D, ONE>
                                  : flash_fwd_kernel<TQ, TKV, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), mask, kv_lens, static_cast<TQ*>(out), lse,
      Sq, Sk, H, Hkv, msb, msh, msq, msk, scale, causal, (uint32_t)seed0,
      (uint32_t)seed1, (uint32_t)thresh, dscale);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma, sm_90a). See the note at the top.

namespace tc {

constexpr int kFwdWG = 1;       // warpgroups (64 query rows each) per CTA
constexpr int kFwdBN = 64;      // keys per K/V tile
constexpr int kFwdStages = 2;   // depth of the K and V cp.async rings
constexpr bool kFwdSplitP = true;  // P as bf16 hi + lo parts, not one bf16
constexpr bool kFwdSplitPF16 = false;  // the f16 instance: one f16 P

// P of one tile in place: s holds the thread's S = Q K^T entries (rows qr
// and qr + 8 of its warpgroup, columns 8 j + kc + {0, 1}), mv the mask's
// at the same places; m and l are the rows' running max (natural log
// domain) and partial sums, alpha the factor the output rows are rescaled
// by. MASK adds the additive mask, INTERIOR skips the keep test (a tile
// no bound, causal edge or kv_lens end crosses); DROP applies the dropout
// pattern after the sums.
template <int NS, bool MASK, bool INTERIOR, bool DROP>
__device__ __forceinline__ void tile_probs(
    float (&s)[NS], const float (&mv)[NS], float (&m)[2], float (&l)[2],
    float (&alpha)[2], int q_row0, int k_col0, int Sq, int kend, int causal,
    float scale, const uint32_t (&xq)[2], uint32_t seed1, uint32_t thresh,
    float dscale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ki = k_col0 + 8 * j + e;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qi = q_row0 + 8 * rr;
        const bool keep = INTERIOR || ((qi < Sq) & (ki < kend) &
                                       (!causal | (qi >= ki)));
        float& x = s[4 * j + 2 * rr + e];
        if constexpr (MASK) {
          x = keep ? x * scale + mv[4 * j + 2 * rr + e] : -INFINITY;
        } else if constexpr (!INTERIOR) {
          x = keep ? x : -INFINITY;
        }
        mx[rr] = fmaxf(mx[rr], x);
      }
    }
  float nm2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    // without a mask s is still unscaled: scale > 0 keeps the argmax
    const float m_new = fmaxf(m[rr], MASK ? mx[rr] : mx[rr] * scale);
    alpha[rr] = ex2((m[rr] - m_new) * kLog2e);
    m[rr] = m_new;
    nm2[rr] = -m_new * kLog2e;
    l[rr] *= alpha[rr];
  }
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float& x = s[4 * j + 2 * rr + e];
        // with a mask, (s - m) first: a row the mask sets wholly to -1e30
        // has s == m there and P = 1, exactly as the plain version
        const float p = MASK ? ex2((x - m[rr]) * kLog2e)
                             : ex2(fmaf(x, sl2, nm2[rr]));
        l[rr] += p;
        if constexpr (DROP) {
          const uint32_t ki = (uint32_t)(k_col0 + 8 * j + e);
          x = fmix32(xq[rr] ^ ki ^ seed1) >= thresh ? p * dscale : 0.f;
        } else {
          x = p;
        }
      }
}

// One CTA of NWG warpgroups per (batch x query head, 64 NWG query rows),
// the longest causal rows first; Q stays in shared memory, K and V tiles
// of BN keys stream through rings of kFwdStages stages each. STAGE copies
// each tile's mask into shared memory (one warpgroup only: it adds a CTA
// sync); otherwise a mask is read from L2.
template <class E, int D, int BN, int NWG, bool DROP, bool STAGE>
__global__ void __launch_bounds__(128 * NWG, 1) flash_fwd_wgmma(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ mask,
    const int* __restrict__ kv_lens, E* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, long long msb,
    long long msh, long long msq, long long msk, float scale, int causal,
    uint32_t seed0, uint32_t seed1, uint32_t thresh, float dscale) {
  constexpr int BM = 64 * NWG, NT = 128 * NWG, NS = kFwdStages;
  constexpr bool SPLIT =
      std::is_same<E, f16>::value ? kFwdSplitPF16 : kFwdSplitP;
  static_assert(!STAGE || NWG == 1, "a staged mask needs one warpgroup");
  constexpr uint32_t Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + Q_BYTES, sV = sK + NS * KV_BYTES;  // the rings
  const uint32_t sM = sV + NS * KV_BYTES;  // the staged mask tile
  const float* mtile =
      reinterpret_cast<const float*>(smem_raw + (sM - smem_addr(smem_raw)));

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = ((Sq + BM - 1) / BM - 1 - (int)blockIdx.y) * BM;
  const int qw = q0 + 64 * wg;  // the warpgroup's first row
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const long long q_off = ((long long)b * Sq * H + h) * D;
  const long long kv_off = ((long long)b * Sk * Hkv + hk) * D;
  const int kend = kv_lens ? max(0, min(Sk, kv_lens[b])) : Sk;
  // the CTA's key tiles, up to the causal end and the kv_lens end, and
  // the warpgroup's (a prefix: uniform over the warpgroup)
  const int n_it = ((causal ? min(kend, q0 + BM) : kend) + BN - 1) / BN;
  const int n_w = qw >= Sq ? 0
                  : causal ? min(n_it, (qw + 63 + BN) / BN) : n_it;
  const float* mb = mask ? mask + b * msb + h * msh : nullptr;

  // the thread's query rows (qr, qr + 8) and key columns (8 j + kc +
  // {0, 1}) in the accumulator layout, with their dropout row hashes
  const int qr = 16 * warp + (lane >> 2), kc = 2 * (lane & 3);
  const uint32_t row_key = fmix32((uint32_t)blockIdx.x ^ seed0);  // b*H + h
  uint32_t xq[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    xq[rr] = DROP ? fmix32(row_key ^ (uint32_t)(qw + qr + 8 * rr)) : 0u;

  // tile i's K or V rows into its ring stage; rows past kend zero-filled
  auto load_k = [&](int i) {
    if (i < n_it)
      load_tile<BN, D, NT>(sK + (i % NS) * KV_BYTES, k + kv_off, kv_stride,
                           i * BN, kend, tid);
  };
  auto load_v = [&](int i) {
    if (i < n_it)
      load_tile<BN, D, NT>(sV + (i % NS) * KV_BYTES, v + kv_off, kv_stride,
                           i * BN, kend, tid);
  };

  float acc[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BN / 2], mv[BN / 2], alpha[2];
  uint32_t pf[BN / 16][4], pl[BN / 16][4];  // P's hi and lo parts (E)

  // S = Q K^T of tile i (queries x keys), A and B from shared memory
  auto start_s = [&](int i) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E>(s, kmajor_desc<BM>(sQ, 64 * wg, kk),
                  kmajor_desc<BN>(sK + (i % NS) * KV_BYTES, 0, kk), kk);
    wgmma_commit();
  };
  // tile i's mask rows into the padded shared tile (BN + 4 floats a row,
  // so the accumulator-layout reads hit distinct banks), 16 bytes a copy;
  // keys past kend and rows past Sq zero-filled, never read
  auto stage_mask = [&](int i) {
    for (int c = tid; c < BM * (BN / 4); c += NT) {
      const int r = c / (BN / 4), col = (c % (BN / 4)) * 4;
      const int qi = q0 + r, ki = i * BN + col;
      const int n = qi < Sq ? max(0, min(4, kend - ki)) : 0;
      cp_async16(sM + (r * (BN + 4) + col) * 4, mb + (n ? qi * msq + ki : 0),
                 n * 4);
    }
  };
  // tile i's mask entries in the accumulator layout: from the staged tile,
  // or read from L2 while the S product runs (at a safe index outside Sq x
  // kend, where the keep test drops them)
  auto load_mask = [&](int i) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int qi = qw + qr + 8 * rr, ki = i * BN + 8 * j + kc + e;
          mv[4 * j + 2 * rr + e] =
              STAGE ? mtile[(qr + 8 * rr) * (BN + 4) + 8 * j + kc + e]
                    : mb[(qi < Sq) & (ki < kend) ? qi * msq + ki * msk : 0];
        }
  };
  // tile i's P in s, with the rows' max, sums and rescale factor
  auto probs = [&](int i) {
    const int k0 = i * BN;
    const bool interior = qw + 64 <= Sq && k0 + BN <= kend &&
                          (!causal || k0 + BN - 1 <= qw);
    auto run = [&](auto masked, auto inner) {
      tile_probs<BN / 2, decltype(masked)::value, decltype(inner)::value,
                 DROP>(s, mv, m, l, alpha, qw + qr, k0 + kc, Sq, kend, causal,
                       scale, xq, seed1, thresh, dscale);
    };
    if (mb && interior)
      run(std::true_type{}, std::true_type{});
    else if (mb)
      run(std::true_type{}, std::false_type{});
    else if (interior)
      run(std::false_type{}, std::true_type{});
    else
      run(std::false_type{}, std::false_type{});
  };
  // O = alpha O, then P as A fragments of E (the accumulator layout is
  // the A layout): hi = E(P) and, with SPLIT, lo = E(P - hi)
  auto rescale_pack = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = s[8 * kk + 2 * i], c = s[8 * kk + 2 * i + 1];
        pf[kk][i] = pack2<E>(a, c);
        if constexpr (SPLIT) {
          const float2 hf = unpack2<E>(pf[kk][i]);
          pl[kk][i] = pack2<E>(a - hf.x, c - hf.y);
        }
      }
  };
  // O += P V of tile i (hi, then lo), the key-major V tile read
  // transposed
  auto start_pv = [&](int i) {
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t vd = mnmajor_desc<BN>(sV + (i % NS) * KV_BYTES, kk);
      wgmma_rs_tb<E>(acc, pf[kk], vd);
      if constexpr (SPLIT) wgmma_rs_tb<E>(acc, pl[kk], vd);
    }
    wgmma_commit();
  };

  // groups: {Q, K 0, V 0}, then pairs {mask}, {K, V}: the prologue's
  // masks are empty, tile it's mask is copied during its S product while
  // K and V run NS - 1 tiles ahead
  if (n_it > 0) load_tile<BM, D, NT>(sQ, q + q_off, q_stride, q0, Sq, tid);
#pragma unroll
  for (int it = 0; it < NS - 1; ++it) {
    if (it > 0) cp_async_commit();
    load_k(it);
    load_v(it);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<2 * (NS - 2)>();
    __syncthreads();  // tile it landed; everyone is done with tile it - 1
    if constexpr (STAGE) stage_mask(it);
    cp_async_commit();
    load_k(it + NS - 1);
    load_v(it + NS - 1);
    cp_async_commit();
    if (it >= n_w) continue;
    start_s(it);
    if constexpr (STAGE) {
      cp_async_wait<1>();
      __syncthreads();  // the mask tile landed
    }
    if (mb) load_mask(it);
    wgmma_wait<0>();
    fence_regs(s);
    probs(it);
    rescale_pack();
    start_pv(it);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pf);
    if constexpr (SPLIT) fence_regs(pl);
  }

  if (qw >= Sq) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int qi = qw + qr + 8 * rr;
    if (qi >= Sq) continue;
    const float safe = l[rr] == 0.f ? 1.f : l[rr];
    E* orow = out + q_off + qi * q_stride + kc;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack2<E>(acc[i] / safe, acc[i + 1] / safe);
    }
    if ((lane & 3) == 0)
      lse[(long long)blockIdx.x * Sq + qi] = m[rr] + logf(safe);
  }
}

template <class E, int D>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const float* mask, const int* kv_lens, void* out, float* lse,
                 int B, int Sq, int Sk, int H, int Hkv, long long msb,
                 long long msh, long long msq, long long msk, float scale,
                 int causal, int seed0, int seed1, unsigned thresh,
                 float dscale, cudaStream_t stream) {
  constexpr int BM = 64 * kFwdWG;
  constexpr int smem = 1024 + BM * D * 2 + kFwdStages * 2 * kFwdBN * D * 2;
  constexpr int mask_smem = BM * (kFwdBN + 4) * 4;
  // the mask tile is staged when its rows are distinct (msq != 0), keys
  // contiguous and every row 16-byte aligned; otherwise it is read from L2
  const int stage = kFwdWG == 1 && mask && msk == 1 && msq != 0 &&
                    msq % 4 == 0 && msb % 4 == 0 && msh % 4 == 0 &&
                    ((uintptr_t)mask & 15) == 0;
  constexpr bool ONE = kFwdWG == 1;
  auto kern =
      dscale > 0.f
          ? (stage ? flash_fwd_wgmma<E, D, kFwdBN, kFwdWG, true, ONE>
                   : flash_fwd_wgmma<E, D, kFwdBN, kFwdWG, true, false>)
          : (stage ? flash_fwd_wgmma<E, D, kFwdBN, kFwdWG, false, ONE>
                   : flash_fwd_wgmma<E, D, kFwdBN, kFwdWG, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem + mask_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + BM - 1) / BM);
  kern<<<grid, 128 * kFwdWG, smem + (stage ? mask_smem : 0), stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), mask, kv_lens, static_cast<E*>(out),
      lse, Sq, Sk, H, Hkv, msb, msh, msq, msk, scale, causal, (uint32_t)seed0,
      (uint32_t)seed1, (uint32_t)thresh, dscale);
  return (int)cudaGetLastError();
}

}  // namespace tc

namespace {

// the 16-bit kernels copy 16 bytes at a time and store element pairs
bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// dtype: q's and the output's element type, kv_dtype: K's and V's (0 =
// float32, 1 = bfloat16, 2 = float16). One 16-bit dtype throughout runs the
// wgmma kernel; float32, or q of one dtype with K/V of another, the FMA
// kernel (mixed dtypes without dropout). Layouts: q/out [B, Sq, H, D],
// k/v [B, Sk, Hkv, D], lse [B, H, Sq], all contiguous; mask (may be
// null) is f32 addressed as mask[b*msb + h*msh + q*msq + k*msk];
// kv_lens (may be null) is int32 [B]. Dropout: dscale = 1 / (1 - p) as
// f32, 0 for none; thresh = min(2^32 - 1, round(p * 2^32)); seed0 and
// seed1 the call's two int32 seeds. Returns cudaGetLastError().
extern "C" int flash_fwd(int dtype, int kv_dtype, int head_dim,
                         const void* q, const void* k, const void* v,
                         const float* mask, const int* kv_lens, void* out,
                         float* lse, int B, int Sq, int Sk, int H, int Hkv,
                         long long msb, long long msh, long long msq,
                         long long msk, float scale, int causal, int seed0,
                         int seed1, unsigned thresh, float dscale,
                         cudaStream_t stream) {
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || B <= 0 || Sq <= 0 || Sk <= 0 ||
      (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  return tc::with_dtype(dtype, [&](auto tq) {
    return tc::with_dtype(kv_dtype, [&](auto tkv) {
      using TQ = typename decltype(tq)::type;
      using TKV = typename decltype(tkv)::type;
      if constexpr (std::is_same<TQ, TKV>::value &&
                    !std::is_same<TQ, float>::value) {
        if (!aligned16(q) || !aligned16(k) || !aligned16(v) ||
            !aligned16(out))
          return (int)cudaErrorMisalignedAddress;
        auto run = head_dim == 64 ? tc::launch_wgmma<TQ, 64>
                                  : tc::launch_wgmma<TQ, 128>;
        return run(q, k, v, mask, kv_lens, out, lse, B, Sq, Sk, H, Hkv, msb,
                   msh, msq, msk, scale, causal, seed0, seed1, thresh,
                   dscale, stream);
      } else {
        auto run = head_dim == 64 ? launch<TQ, TKV, 64>
                                  : launch<TQ, TKV, 128>;
        return run(q, k, v, mask, kv_lens, out, lse, B, Sq, Sk, H, Hkv, msb,
                   msh, msq, msk, scale, causal, seed0, seed1, thresh,
                   dscale, stream);
      }
    });
  });
}

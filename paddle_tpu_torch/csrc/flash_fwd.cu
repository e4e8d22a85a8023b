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
// the same bits whatever their tiling. The two seeds are read from a
// device int32 slot (`seeds`), never passed by value, so a captured CUDA
// graph takes the words its caller writes there before each replay; the
// row's second hash absorbs seed1 (xq = fmix32(row ^ q) ^ seed1: XOR
// commutes), so the per-element hash is fmix32(xq ^ k). A kept P is
// multiplied by dscale = 1 / (1 - p) before rounding; a dropped one is 0. The
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
// One query row (bf16 or f16, Sq = 1, no dropout; `decode_route`): the
// decode walk of decode_split.cuh over the contiguous cache
// (`dec::DenseKeys`). Every decode step of generate()'s static route
// launches this shape, q[B, 1, H, D] against k, v[B, Sk, Hkv, D] under
// the bool padding mask of the static cache. It is bound by the bytes of
// K and V at the kept keys (a few operations a byte), not by the tensor
// cores: the `wgmma` kernel above ran it as a 64-row tile with one live
// row, one CTA per (sequence, query head) walking all Sk keys in series,
// the masked tail included: 0.0365 ms at GPT-2 XL's beam shape
// q[16, 1, 25, 64], 332 keys (7.4x its bytes bound, 1.24x SDPA's 0.0294)
// and 0.0390 ms at Llama-2-7B's q[8, 1, 32, 128], 544 keys (6.9x; H100
// 80GB HBM3, 700 W). The route serves a KV head's whole query-head group
// with one walk (K/V read once per KV head), walks only the window of
// keys that some head of the group keeps (found from the mask, kv_lens
// and causality at the start of the walk), splits it over a cluster of
// up to 4 CTAs and combines the ranks in a fixed order; P stays f32
// (the plain version rounds the normalised P to V's dtype: the two
// differ by that one rounding, inside the card tolerance). lse is
// m + log(l) of the combined state; a row whose group keeps no key gets
// lse -1e30 exactly and a zero output. Measured (H100 80GB HBM3, 700 W;
// tools/kernel_variants.py): 0.0198 ms at both decode shapes above, below
// SDPA (0.0422 and 0.0303), 3.5x and 4x their bounds; the variants that
// lost are listed in decode_split.cuh.
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
// A bf16 or f16 q over f32 K/V at Sq > 1 without dropout (`tc::f32_kv`, route
// "wgmma_f32kv": the prefix cache's suffix prefill over an f32 KV pool, whose
// cached f32 pages and the suffix's 16-bit K/V concatenate to f32 as torch.cat
// promotes): the wgmma kernel with K and V entering the products as bf16 hi +
// lo parts (wgmma.cuh's note): S = Q K_hi^T + Q K_lo^T (+ Q_lo K_hi^T for an
// f16 q), O += P_hi V_hi + P_hi V_lo + P_lo V_hi, P kept to 16 bits (the plain
// version's P is unrounded f32: V is f32). Each 64-key tile's f32 rows come by
// cp.async into a 2-stage f32 ring and are split in shared memory into hi and
// lo tiles, K before the S product and V while it runs; one CTA an SM (209 KiB
// with a bf16 q, 226 with its staged mask; an f16 q's lo tile leaves no room,
// so its mask is read from L2). Bound on the H100: the bytes (f32 K/V);
// operations count at the 16-bit tensor-core peak (the split reaches f32
// accuracy there). Measured on an H100 80GB HBM3 at 700 W
// (tools/kernel_variants.py --only flash_f32kv --parent: the previous FMA
// kernel in the same process) at q[1, 128, 32, 128] against 384 f32 keys under
// the suffix's mask: bf16 q 0.0342 ms (FMA 0.0993; bytes bound 0.0044), f16 q
// 0.0382 (FMA 0.0991); with 4 KV heads 0.0339 / 0.0376. The grid is 64 CTAs of
// six key tiles each, so what holds it is the chain per tile: without the
// split it takes 0.0279, without the f32 copies 0.0352 (diagnostic variants).
// 32-key tiles with 3 or 2 stages lost (0.0362). A split of the key walk over
// a 2-CTA cluster, combined through distributed shared memory as paged_varq.cu
// does, took 0.0396 against 0.0350 unsplit (tools/kernel_variants.py on a
// build that had it) and is not shipped. At Sq = 1, and for the other pairs of
// dtypes (f32 q over 16-bit K/V, bf16 with f16): the FMA kernel below with q
// read as TQ and K/V as TKV, each converted to f32 on load, P rounded to TKV
// before P.V as the plain version rounds it, the output in TQ; no dropout with
// two dtypes (inference only).
//
// f32 q over f32 K/V at Sq > 1 (route "wgmma_f32": the BERT-base / ERNIE
// fine-tune's forward, with or without its attention dropout, and every f32
// prefill): the same wgmma kernel with every operand in THREE bf16 parts,
// hi + mid + lo (24 significant bits; `split3_bf16` in wgmma.cuh, whose note
// gives the bounds). S and P V each keep the six terms of order 2^-16 and
// above: S = Q_h K_h^T + Q_h K_m^T + Q_m K_h^T + Q_h K_l^T + Q_l K_h^T +
// Q_m K_m^T, and so O += P V with P, unrounded f32 in the plain version,
// split in registers. Two parts (16 bits, as flash_bwd.cu's S^T and the
// 16-bit-q instance above use) left the output and lse ~1e-5 of their size
// from the f32 version, and the 2-layer f32 training gate of chip_smoke.py
// (Adam's 1 / eps slope at near-zero gradients turns that into
// weight-change differences) failed at 1.34e-2 of its 1e-2 limit; with
// three parts it passes at 7.6e-3 (H100 80GB HBM3, 700 W; the errors
// against the plain version are ~4e-6). Q's f32 rows arrive once by
// cp.async, staged in the space of the K and V part tiles while key tile
// 0's rows land in the ring, and are split into Q's resident part tiles. The ring of f32 K/V
// rows has one stage (kFwdStagesF32Q): a tile's K rows are split before
// its S product and its V rows while that product runs, after which the
// next tile's copies start and overlap the softmax and the P V products.
// Shared memory: 107,520 bytes at D = 64, two CTAs an SM, where the mask
// is read from L2 (a key mask, as BERT's: one row broadcast over the
// queries) and 124,928 where it is staged (one CTA); 231,424 at D = 128
// with a staged mask. Registers (ptxas -v, CUDA 12.8): D = 64 203 (207
// with dropout) with the mask from L2, D = 128 254-255 (12-20 bytes
// spilled with the staged mask). Dropout is the 16-bit instance's: the same keep test
// and 1 / (1 - p) on P after the sums. The output is written as f32 pairs,
// lse as in every dtype. Bound on the H100: the bytes of f32 Q, K, V, O,
// the mask and lse (BERT-base's q[16, 128, 12, 64] with its key mask:
// 0.0075 ms); the operations, twelve 16-bit products a (query, key) pair
// at the 16-bit peak, would take 0.0043 there. Measured on an H100 80GB HBM3 at 700 W
// (tools/kernel_variants.py --only flash_f32 --parent: the previous FMA
// kernel in the same process): 0.0313 ms at that shape (FMA 0.0549, f32
// SDPA 0.0420), 0.0339 with dropout 0.1 (FMA 0.0576), 0.2565 at q[4, 512,
// 32, 128] causal + mask (FMA 0.7102, SDPA 0.4662); 4.2x and 6.2x the
// bytes bound. The grid at BERT's shape is 384 CTAs of two key tiles each,
// so the chain of copy, split and products per CTA sets the time: without
// the K and V splits (a diagnostic variant) it took 0.0330; a staged mask
// read from L2 instead cost 10 % at D = 128.
//
// f32 at Sq = 1 (dtype 0): the FMA-unit kernel below (TF32 is off in the
// port): one block of 256 threads per (batch*head, 64-row query tile) keeps
// the Q tile, one K and one V tile (64 rows, f32) and the 64x64 score tile
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

#include "decode_split.cuh"
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
    float scale, int causal, const int* __restrict__ seeds, uint32_t thresh,
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
  // dropout: the row's first hash and seed1, from the call's slot
  uint32_t row_key = 0u, seed1 = 0u;
  if constexpr (DROP) {
    row_key = fmix32((uint32_t)bh ^ (uint32_t)seeds[0]);
    seed1 = (uint32_t)seeds[1];
  }

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
        const uint32_t xq = fmix32(row_key ^ (uint32_t)(q0 + r)) ^ seed1;
        const uint32_t k_lo = (uint32_t)(k0 + lane);
        p0 = fmix32(xq ^ k_lo) >= thresh ? p0 * dscale : 0.f;
        p1 = fmix32(xq ^ (k_lo + 32u)) >= thresh ? p1 * dscale : 0.f;
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
           long long msk, float scale, int causal, const int* seeds,
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
      Sq, Sk, H, Hkv, msb, msh, msq, msk, scale, causal, seeds,
      (uint32_t)thresh, dscale);
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
// a 16-bit q over f32 K/V (one warpgroup a CTA): keys per tile and depth
// of the f32 staging ring (64 keys at head_dim 128 fill 224 KiB with two
// stages, so the mask is read from L2 there)
constexpr int kFwdBNF32 = 64;
constexpr int kFwdStagesF32 = 2;
// an f32 q over f32 K/V: one stage of f32 rows, split as its tile starts
// into three bf16 parts (hi, mid, lo)
constexpr int kFwdStagesF32Q = 1;

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
    float scale, const uint32_t (&xq)[2], uint32_t thresh,
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
          x = fmix32(xq[rr] ^ ki) >= thresh ? p * dscale : 0.f;
        } else {
          x = p;
        }
      }
}

// Shared memory of flash_fwd_wgmma<E, TKV, D, BN, NWG, ..>, in bytes from
// its 1024-aligned base: the Q tile (and, for an f16 q over f32 K/V, its
// lo part; for an f32 q its mid and lo parts); then either the K and V
// rings of 16-bit tiles, or (f32 K/V) the K and V part tiles (hi and lo;
// hi, mid and lo for an f32 q) and the ring of f32 staging tiles; then
// the staged mask tile (MASK bytes, where the launcher stages one).
template <class E, class TKV, int D, int BN, int NWG>
struct FwdSmem {
  static constexpr bool F32 = std::is_same<TKV, float>::value;
  static constexpr bool FQ = F32 && std::is_same<E, float>::value;
  static constexpr bool QLO = F32 && !std::is_same<E, bf16>::value;
  static constexpr int BM = 64 * NWG;
  static constexpr int NS =
      FQ ? kFwdStagesF32Q : F32 ? kFwdStagesF32 : kFwdStages;
  // bf16 parts of Q and of each f32 K and V tile
  static constexpr int QP = FQ ? 3 : QLO ? 2 : 1;
  static constexpr int KP = FQ ? 3 : 2;
  static constexpr uint32_t Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  static constexpr uint32_t F_BYTES = BN * D * 4;  // one f32 staging tile
  static constexpr uint32_t K = Q_BYTES * QP;
  static constexpr uint32_t V = F32 ? K + KP * KV_BYTES : K + NS * KV_BYTES;
  static constexpr uint32_t RING = F32 ? K + 2 * KP * KV_BYTES : K;
  static constexpr uint32_t M = RING + NS * 2 * (F32 ? F_BYTES : KV_BYTES);
  static constexpr uint32_t MASK = BM * (BN + 4) * 4;
};

// One CTA of NWG warpgroups per (batch x query head, 64 NWG query rows),
// the longest causal rows first; Q stays in shared memory, K and V tiles
// of BN keys stream through rings of kFwdStages stages each (f32 K/V:
// kFwdStagesF32 stages of f32 rows, each tile split into bf16 hi and lo
// tiles before its products; one warpgroup; an f32 q: its rows split once
// into resident hi and lo tiles, kFwdStagesF32Q stages). STAGE copies each
// tile's mask into shared memory (one warpgroup only: it adds a CTA sync);
// otherwise a mask is read from L2.
template <class E, class TKV, int D, int BN, int NWG, bool DROP, bool STAGE>
__global__ void __launch_bounds__(128 * NWG, 1) flash_fwd_wgmma(
    const E* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ mask,
    const int* __restrict__ kv_lens, E* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, long long msb,
    long long msh, long long msq, long long msk, float scale, int causal,
    const int* __restrict__ seeds, uint32_t thresh, float dscale) {
  using L = FwdSmem<E, TKV, D, BN, NWG>;
  constexpr bool F32 = L::F32, FQ = L::FQ, QLO = L::QLO;
  // the products' operand type: bf16 parts over f32 K/V, else E
  using PE = typename std::conditional<F32, bf16, E>::type;
  constexpr int BM = L::BM, NT = 128 * NWG, NS = L::NS;
  constexpr bool SPLIT =
      F32 || (std::is_same<E, f16>::value ? kFwdSplitPF16 : kFwdSplitP);
  static_assert(!STAGE || NWG == 1, "a staged mask needs one warpgroup");
  static_assert(!F32 || (NWG == 1 && (FQ || !DROP)),
                "f32 K/V: one warpgroup; dropout with an f32 q only");
  static_assert(!FQ || L::RING - L::K >= (uint32_t)BM * D * 4,
                "an f32 q's rows are staged in the K and V part tiles");
  constexpr uint32_t KV_BYTES = L::KV_BYTES, F_BYTES = L::F_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  // Q's second and (f32 q) third parts
  const uint32_t sQl = sQ + L::Q_BYTES, sQ2 = sQ + 2 * L::Q_BYTES;
  // 16-bit K/V: the rings; f32 K/V: the hi tiles, each followed by its lo
  // tile (f32 q: its mid tile, then its lo tile), and the f32 ring (K then
  // V a stage)
  const uint32_t sK = sQ + L::K, sV = sQ + L::V, sF = sQ + L::RING;
  const uint32_t sKl = sK + KV_BYTES, sVl = sV + KV_BYTES;
  const uint32_t sK2 = sK + 2 * KV_BYTES, sV2 = sV + 2 * KV_BYTES;
  const uint32_t sM = sQ + L::M;  // the staged mask tile
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
  // (seed1 folded in)
  const int qr = 16 * warp + (lane >> 2), kc = 2 * (lane & 3);
  uint32_t xq[2] = {0u, 0u};
  if constexpr (DROP) {
    const uint32_t row_key =
        fmix32((uint32_t)blockIdx.x ^ (uint32_t)seeds[0]);  // b*H + h
    const uint32_t seed1 = (uint32_t)seeds[1];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      xq[rr] = fmix32(row_key ^ (uint32_t)(qw + qr + 8 * rr)) ^ seed1;
  }

  // tile i's K and V rows into its ring stage (f32 K/V: the f32 ring);
  // rows past kend zero-filled
  auto load_kv = [&](int i) {
    if (i >= n_it) return;
    if constexpr (F32) {
      const uint32_t f = sF + (i % NS) * 2 * F_BYTES;
      stage_rows<BN, D, NT>(
          f, k + kv_off,
          [&](int r) -> long long {
            const int key = i * BN + r;
            return key < kend ? (long long)key * kv_stride : -1;
          },
          tid, f + F_BYTES, v + kv_off);
    } else {
      load_tile<BN, D, NT>(sK + (i % NS) * KV_BYTES, k + kv_off, kv_stride,
                           i * BN, kend, tid);
      load_tile<BN, D, NT>(sV + (i % NS) * KV_BYTES, v + kv_off, kv_stride,
                           i * BN, kend, tid);
    }
  };

  float acc[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BN / 2], mv[BN / 2], alpha[2];
  // P's hi and lo parts (PE); an f32 q: hi, mid (pl) and lo (p2)
  uint32_t pf[BN / 16][4], pl[BN / 16][4], p2[FQ ? BN / 16 : 1][4];

  // S = Q K^T of tile i (queries x keys), A and B from shared memory; over
  // f32 K/V Q K_hi^T + Q K_lo^T (+ Q_lo K_hi^T for an f16 q); an f32 q in
  // three parts: the six terms of order 2^-16 and above (wgmma.cuh)
  auto start_s = [&](int i) {
    const uint32_t kt = F32 ? sK : sK + (i % NS) * KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t qd = kmajor_desc<BM>(sQ, 64 * wg, kk);
      const uint64_t kd = kmajor_desc<BN>(kt, 0, kk);
      wgmma_ss<PE>(s, qd, kd, kk);
      if constexpr (F32) wgmma_ss<PE>(s, qd, kmajor_desc<BN>(sKl, 0, kk), 1);
      if constexpr (QLO)
        wgmma_ss<PE>(s, kmajor_desc<BM>(sQl, 64 * wg, kk), kd, 1);
      if constexpr (FQ) {
        wgmma_ss<PE>(s, qd, kmajor_desc<BN>(sK2, 0, kk), 1);
        wgmma_ss<PE>(s, kmajor_desc<BM>(sQ2, 64 * wg, kk), kd, 1);
        wgmma_ss<PE>(s, kmajor_desc<BM>(sQl, 64 * wg, kk),
                     kmajor_desc<BN>(sKl, 0, kk), 1);
      }
    }
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
                       scale, xq, thresh, dscale);
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
  // O = alpha O, then P as A fragments of PE (the accumulator layout is
  // the A layout): hi = PE(P) and, with SPLIT, lo = PE(P - hi); an f32 q:
  // hi, mid and lo (split3_bf16)
  auto rescale_pack = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = s[8 * kk + 2 * i], c = s[8 * kk + 2 * i + 1];
        if constexpr (FQ) {
          split3_bf16(a, c, pf[kk][i], pl[kk][i], p2[kk][i]);
        } else {
          pf[kk][i] = pack2<PE>(a, c);
          if constexpr (SPLIT) {
            const float2 hf = unpack2<PE>(pf[kk][i]);
            pl[kk][i] = pack2<PE>(a - hf.x, c - hf.y);
          }
        }
      }
  };
  // O += P V of tile i (hi, then lo; over f32 K/V also P_hi V_lo; an f32
  // q the six terms of three parts), the key-major V tile read transposed
  auto start_pv = [&](int i) {
    const uint32_t vt = F32 ? sV : sV + (i % NS) * KV_BYTES;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t vd = mnmajor_desc<BN>(vt, kk);
      wgmma_rs_tb<PE>(acc, pf[kk], vd);
      if constexpr (SPLIT) wgmma_rs_tb<PE>(acc, pl[kk], vd);
      if constexpr (F32)
        wgmma_rs_tb<PE>(acc, pf[kk], mnmajor_desc<BN>(sVl, kk));
      if constexpr (FQ) {
        wgmma_rs_tb<PE>(acc, pf[kk], mnmajor_desc<BN>(sV2, kk));
        wgmma_rs_tb<PE>(acc, p2[kk], vd);
        wgmma_rs_tb<PE>(acc, pl[kk], mnmajor_desc<BN>(sVl, kk));
      }
    }
    wgmma_commit();
  };

  // groups: {Q, K 0, V 0}, then pairs {mask}, {K, V}: the prologue's
  // masks are empty, tile it's mask is copied during its S product while
  // K and V run NS - 1 tiles ahead. An f16 q over f32 K/V is split into
  // bf16 hi and lo tiles here, synchronously. An f32 q: {Q's f32 rows},
  // {K 0, V 0}, then pairs {mask}, {K, V} of the next tile, issued once
  // this tile's rows are split.
  if (n_it > 0) {
    if constexpr (FQ) {
      // Q's f32 rows staged in the K (and V) part tiles while tile 0's
      // rows land in the ring, then split into Q's resident hi, mid and lo
      // tiles (the loop's first barrier orders the reads before K's split)
      stage_rows<BM, D, NT>(
          sK, q + q_off,
          [&](int r) -> long long {
            return q0 + r < Sq ? (long long)(q0 + r) * q_stride : -1;
          },
          tid);
      cp_async_commit();
      load_kv(0);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      split_tile<BM, D, NT, L::QP>(sQ, sQl, sK, tid, sQ2);
      fence_async_smem();
    } else if constexpr (QLO) {
      split_rows<BM, D, NT>(
          sQ, sQl, q + q_off,
          [&](int r) -> long long {
            return q0 + r < Sq ? (long long)(q0 + r) * q_stride : -1;
          },
          tid);
      fence_async_smem();
    } else {
      load_tile<BM, D, NT>(sQ, q + q_off, q_stride, q0, Sq, tid);
    }
  }
#pragma unroll
  for (int it = 0; it < NS - 1; ++it) {
    if (it > 0) cp_async_commit();
    load_kv(it);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<FQ ? 0 : 2 * (NS - 2)>();
    __syncthreads();  // tile it landed; everyone is done with tile it - 1
    if constexpr (STAGE) stage_mask(it);
    cp_async_commit();
    if constexpr (!FQ) {
      load_kv(it + NS - 1);
      cp_async_commit();
    }
    if (it >= n_w) continue;
    const uint32_t f = sF + (it % NS) * 2 * F_BYTES;  // f32 K/V's stage
    if constexpr (F32) {
      // K's f32 rows into its hi and lo tiles before the S product
      split_tile<BN, D, NT, L::KP>(sK, sKl, f, tid, sK2);
      fence_async_smem();
      __syncthreads();
    }
    start_s(it);
    if constexpr (F32) {
      // V's f32 rows into its hi and lo tiles while the S product runs
      split_tile<BN, D, NT, L::KP>(sV, sVl, f + F_BYTES, tid, sV2);
      fence_async_smem();
    }
    if constexpr (FQ) {
      // the mask tile landed (the only group in flight), every thread's V
      // parts are stored and the staged rows read: the next tile's rows
      // come into the stage while this tile's softmax and P V run
      if constexpr (STAGE) cp_async_wait<0>();
      __syncthreads();
      load_kv(it + 1);
      cp_async_commit();
    } else if constexpr (STAGE) {
      cp_async_wait<1>();
      __syncthreads();  // the mask tile landed
    }
    if (mb) load_mask(it);
    wgmma_wait<0>();
    fence_regs(s);
    probs(it);
    rescale_pack();
    if constexpr (F32 && !FQ) __syncthreads();  // every thread's V parts stored
    start_pv(it);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pf);
    if constexpr (SPLIT) fence_regs(pl);
    if constexpr (FQ) fence_regs(p2);
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
      if constexpr (FQ)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[i] / safe, acc[i + 1] / safe);
      else
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack2<E>(acc[i] / safe, acc[i + 1] / safe);
    }
    if ((lane & 3) == 0)
      lse[(long long)blockIdx.x * Sq + qi] = m[rr] + logf(safe);
  }
}

template <class E, class TKV, int D>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const float* mask, const int* kv_lens, void* out, float* lse,
                 int B, int Sq, int Sk, int H, int Hkv, long long msb,
                 long long msh, long long msq, long long msk, float scale,
                 int causal, const int* seeds, unsigned thresh,
                 float dscale, cudaStream_t stream) {
  // f32 K/V: one warpgroup, kFwdBNF32 keys a tile, dropout with an f32 q
  // only (DR)
  constexpr bool F32 = std::is_same<TKV, float>::value;
  constexpr bool DR = !F32 || std::is_same<E, float>::value;
  constexpr int WG = F32 ? 1 : kFwdWG, BN = F32 ? kFwdBNF32 : kFwdBN;
  using L = FwdSmem<E, TKV, D, BN, WG>;
  constexpr int smem = 1024 + (int)L::M;
  constexpr int mask_smem = (int)L::MASK;
  // the mask tile is staged when its rows are distinct (msq != 0), keys
  // contiguous and every row 16-byte aligned, and it fits beside the
  // rings; otherwise it is read from L2
  constexpr bool FITS = smem + mask_smem <= 232448;
  const int stage = kFwdWG == 1 && mask && msk == 1 && msq != 0 &&
                    msq % 4 == 0 && msb % 4 == 0 && msh % 4 == 0 &&
                    ((uintptr_t)mask & 15) == 0 && FITS;
  constexpr bool ONE = WG == 1 && FITS;
  if (!DR && dscale > 0.f) return (int)cudaErrorInvalidValue;
  auto kern =
      dscale > 0.f && DR
          ? (stage ? flash_fwd_wgmma<E, TKV, D, BN, WG, DR, ONE>
                   : flash_fwd_wgmma<E, TKV, D, BN, WG, DR, false>)
          : (stage ? flash_fwd_wgmma<E, TKV, D, BN, WG, false, ONE>
                   : flash_fwd_wgmma<E, TKV, D, BN, WG, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem + (ONE ? mask_smem : 0));
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + L::BM - 1) / L::BM);
  kern<<<grid, 128 * WG, smem + (stage ? mask_smem : 0), stream>>>(
      static_cast<const E*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), mask, kv_lens, static_cast<E*>(out),
      lse, Sq, Sk, H, Hkv, msb, msh, msq, msk, scale, causal, seeds,
      (uint32_t)thresh, dscale);
  return (int)cudaGetLastError();
}

}  // namespace tc

namespace {

// the 16-bit kernels copy 16 bytes at a time and store element pairs
bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// the largest query-head group of the one-row decode route (its shared
// memory holds the group's queries and accumulators)
constexpr int kDecodeMaxGroup = 64;

// the launches the one-row decode route takes (kernels/attention.py
// `fwd_route` mirrors this): q, k and v of one 16-bit dtype, one query
// row, no dropout, a query-head group of at most kDecodeMaxGroup
bool decode_route(int dtype, int kv_dtype, int Sq, int H, int Hkv,
                  float dscale) {
  return dtype == kv_dtype && dtype != 0 && Sq == 1 && !(dscale > 0.f) &&
         H / Hkv <= kDecodeMaxGroup;
}

}  // namespace

// dtype: q's and the output's element type, kv_dtype: K's and V's (0 =
// float32, 1 = bfloat16, 2 = float16). One 16-bit dtype throughout runs the
// one-row decode route where `decode_route` says so (Sq = 1, no dropout)
// and the wgmma kernel otherwise; f32 throughout at Sq > 1, with or
// without dropout, the wgmma kernel with every operand in bf16 hi + lo
// parts; a 16-bit q over f32 K/V (`tc::f32_kv`) at Sq > 1 without dropout
// the wgmma kernel with K and V in bf16 hi + lo parts; float32 at Sq = 1,
// other pairs of dtypes, or a 16-bit q over f32 K/V at Sq = 1, the FMA
// kernel (no dropout with two dtypes). Layouts: q/out
// [B, Sq, H, D], k/v [B, Sk, Hkv, D], lse [B, H, Sq], all contiguous;
// mask (may be null) is f32 addressed as mask[b*msb + h*msh + q*msq +
// k*msk];
// kv_lens (may be null) is int32 [B]. Dropout: dscale = 1 / (1 - p) as
// f32, 0 for none; thresh = min(2^32 - 1, round(p * 2^32)); seeds (may
// be null without dropout) a device int32 [2] slot holding the call's two
// seeds, read by the kernel. Returns cudaGetLastError().
extern "C" int flash_fwd(int dtype, int kv_dtype, int head_dim,
                         const void* q, const void* k, const void* v,
                         const float* mask, const int* kv_lens, void* out,
                         float* lse, int B, int Sq, int Sk, int H, int Hkv,
                         long long msb, long long msh, long long msq,
                         long long msk, float scale, int causal,
                         const int* seeds, unsigned thresh, float dscale,
                         cudaStream_t stream) {
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || B <= 0 || Sq <= 0 || Sk <= 0 ||
      (head_dim != 64 && head_dim != 128) || (dscale > 0.f && !seeds))
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
        if (decode_route(dtype, kv_dtype, Sq, H, Hkv, dscale)) {
          auto dec_run = head_dim == 64
                             ? dec::launch_split<TQ, TQ, 64, dec::DenseKeys>
                             : dec::launch_split<TQ, TQ, 128, dec::DenseKeys>;
          dec::DenseKeys keys = {};
          keys.mask = mask;
          keys.msb = msb;
          keys.msh = msh;
          keys.msk = msk;
          keys.Sk = Sk;
          keys.causal = causal;
          keys.lse = lse;
          keys.H = H;
          return dec_run(q, k, v, keys, kv_lens, out, B, H, Hkv,
                         dec::split_ranks(Sk, (long long)B * Hkv), scale,
                         stream);
        }
        auto run = head_dim == 64 ? tc::launch_wgmma<TQ, TQ, 64>
                                  : tc::launch_wgmma<TQ, TQ, 128>;
        return run(q, k, v, mask, kv_lens, out, lse, B, Sq, Sk, H, Hkv, msb,
                   msh, msq, msk, scale, causal, seeds, thresh,
                   dscale, stream);
      } else {
        constexpr bool F32 =
            std::is_same<TQ, float>::value && std::is_same<TKV, float>::value;
        if constexpr (F32 || tc::f32_kv<TQ, TKV>()) {
          if (Sq > 1 && (F32 || !(dscale > 0.f))) {
            if (!aligned16(q) || !aligned16(k) || !aligned16(v) ||
                !aligned16(out))
              return (int)cudaErrorMisalignedAddress;
            auto run = head_dim == 64 ? tc::launch_wgmma<TQ, TKV, 64>
                                      : tc::launch_wgmma<TQ, TKV, 128>;
            return run(q, k, v, mask, kv_lens, out, lse, B, Sq, Sk, H, Hkv,
                       msb, msh, msq, msk, scale, causal, seeds,
                       thresh, dscale, stream);
          }
        }
        auto run = head_dim == 64 ? launch<TQ, TKV, 64>
                                  : launch<TQ, TKV, 128>;
        return run(q, k, v, mask, kv_lens, out, lse, B, Sq, Sk, H, Hkv, msb,
                   msh, msq, msk, scale, causal, seeds, thresh,
                   dscale, stream);
      }
    });
  });
}

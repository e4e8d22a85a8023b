// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/attention.py `_bwd_dkdv_kernel` and
// `_bwd_dq_kernel` (both launched by `_flash_bwd_pallas`), the
// FlashAttention-2 backward that every Llama training step runs once per
// layer.
//
// Both kernels recompute the probabilities from the forward's saved
// log-sum-exp instead of reading an Sq x Sk matrix, per (batch, query
// head h, query row q, key row k):
//   s     = (q . k) * scale + mask[b, h, q, k]                    (f32)
//   keep  = q < Sq, k < Sk, k < kv_lens[b], and q >= k when causal
//   P     = keep ? exp(s - lse[q]) : 0
//   dP    = dO[q] . v[k]
//   dS    = keep ? P * (dP - delta[q]) : 0,   delta = rowsum(dO * O)
//   dV[k] += P * dO[q]          dK[k] += dS * q[q] * scale
//   dQ[q] += dS * k[k] * scale
// With attention dropout (`dscale` > 0), D = keep / (1 - p) is the
// forward's pattern, regenerated from the same counter hash
// (`_fmix32` / `dropout_keep_mask`, attention.py:87-139) over the
// row b*H + h of the QUERY head (also in dK/dV, which walks a KV head's
// query-head group) and the absolute q and k:
//   dV[k] += P * D * dO[q],   dS = P * (dP * D - delta)
// (delta = rowsum(dO * O) still equals rowsum(P * D * dP)).
// Entries that are masked or out of range contribute exactly zero (the
// reference's `jnp.where(keep, ds, 0)`); a row with no valid key stays
// finite. Causality is top-left (q >= k) also when Sq != Sk, as in the
// forward kernel. Grouped-query attention maps query head h onto KV head
// h / (H / Hkv); K and V are never repeated.
//
// `flash_bwd_dkdv`: one block per (batch x KV head, key tile). It holds
// its K and V tiles in shared memory and walks every query head of its
// group and, for causal, only the query tiles at or past the key tile's
// first row, so dK and dV of the whole group accumulate in registers and
// are written once as [B, Sk, Hkv, D] (no per-query-head buffer and no
// group sum afterwards, unlike the reference). `flash_bwd_dq`: one block
// per (batch x query head, 64-row query tile) walking the KV tiles up to
// the causal end and the kv_lens end.
//
// Bound on the H100: at training sizes (S = 2048, D = 128) dK/dV does 4
// matrix products (Q K^T, P^T dO, dO V^T, dS^T Q) and dQ 3 (Q K^T, dO V^T,
// dS K) per (query, key) pair, ~S/2 operations per byte: compute-bound on
// the bf16 tensor cores, 989 TFLOP/s dense (dK/dV at q[2, 2048, 32, 128]
// causal: 1.37e11 operations, 0.139 ms; dQ 1.03e11, 0.104 ms).
//
// bf16 (dtype 1): tensor-core kernels, `tc::flash_bwd_dkdv_wgmma` and
// `tc::flash_bwd_dq_wgmma`. Every product is a `wgmma.mma_async` (sm_90a)
// m64nNk16 in bf16 with f32 accumulators; none uses mma.sync. They follow
// FlashAttention-3's register arrangement:
// - dK/dV: a CTA of one warpgroup (128 threads) per (batch x KV head,
//   64-key tile). Per (query head, 64-row query tile) it computes S^T =
//   K Q^T and dP^T = V dO^T (keys as M, both operands from shared memory,
//   m64n64k16); the f32 accumulators already sit in the A-operand register
//   layout, so P*D and dS are formed there and fed as A from registers to
//   dV += (P*D)^T dO and dK += dS^T Q (m64nDk16, B = the query-major dO /
//   Q tiles read transposed). P and dS never touch shared memory. Shared:
//   K + V 2 x 64 x D bf16 and a 2-stage ring of Q + dO (2 x 64 x D bf16)
//   + lse and delta (2 x 64 f32): 100,352 bytes at D = 128, 2 CTAs per SM.
//   `kDkdvWG` = 2 (two warpgroups sharing each Q / dO tile) halves the
//   ring's traffic but runs the two in lockstep, one SM's only CTA: 0.4690
//   against 0.4466 ms at q[2, 2048, 32, 128] causal on an H100 80GB HBM3
//   at 700 W (tools/flash_bwd_variants.py).
// - dQ: a CTA of one warpgroup per (batch x query head, 64-row query
//   tile), the tiles with the longest causal rows first. Q and dO stay in
//   shared memory; 64-key K and V tiles stream through a 2-stage ring:
//   99,328 bytes at D = 128, 2 CTAs per SM. S = Q K^T and dP = dO V^T from
//   shared memory, dS formed in registers, dQ += dS K with A from
//   registers and the key-major K tile read transposed.
// Precision: one bf16 keeps 8 significant bits of P and dS, where the
// reference and the f32 kernels keep 24; at the bf16 card tolerance
// (atol 5e-3, rtol 2e-2) that failed on outputs near 0 whose terms are
// large (a causal row's first keys, rows with no valid key). So each A
// operand is split into bf16 hi + lo parts (hi = bf16(x), lo = bf16(x -
// hi): 16 bits) and every accumulating product runs twice, on the same B:
// dK/dV does 6 m64-products per tile pair instead of 4, dQ 4 instead of 3.
// Tiles are copied with 16-byte cp.async into the 128-byte-swizzled layout
// that wgmma's descriptors read (rows past the ragged edge zero-filled, as
// TMA would); the next tile's copies start before the current tile's
// products, so the load overlaps them. The per-element keep test (bounds,
// kv_lens, causality) runs only on edge and diagonal tiles, and the
// exponent is one fma and one ex2 without a branch; a warpgroup whose keys
// a whole query tile masks skips it. Registers (ptxas -v, CUDA 12.8, 255
// at most): dK/dV D = 128 255 with 76 bytes spilled (36 with dropout), D =
// 64 254; dQ D = 128 255 with 4 bytes spilled, D = 64 206 (210); the
// accumulators take D/2 + D/2 (dK/dV) or D/2 (dQ) f32, S and dP 32 + 32,
// the hi/lo fragments 64 (dK/dV) or 32 (dQ).
//
// f32 (dtype 0): the FMA-unit kernels below (TF32 is off in the port, so
// the tensor cores do not apply): 256 threads per block, each owning a
// 4x4 micro-tile of the 64x64 score tile (for S and dP at once) and a
// 4 x D/16 slice of its accumulators; tiles are f32 in shared memory with
// one column of padding so the strided reads stay free of bank conflicts.
//
// No atomics in either dtype: every output tile has one owner CTA that
// writes it once, the dK/dV CTA walking its KV head's whole query-head
// group, so a launch repeated on the same inputs gives the same bits (the
// resume check of chip_smoke.py relies on that). Scores never leave the
// chip: device memory sees each input tile read once per tile pair and
// each output written once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

// the call's dropout: dscale = 1 / (1 - p), 0 when off. The row's first
// hash, fmix32((b*H + h) ^ seed0) of the query head being processed, is
// passed beside it as `row_key`
struct Dropout {
  uint32_t seed1, thresh;
  float dscale;
};

// rows [r0, r0 + 64) of a [.., n, heads, D] tensor (row stride `stride`
// elements, `src` at the head's first element) into an f32 [64][D + 1]
// shared tile; rows at or past n are zero, never garbage
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0, int n,
                                          int tid) {
  for (int i = tid; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D, s = r0 + r;
    dst[r * (D + 1) + c] = s < n ? to_f(src[(long long)s * stride + c]) : 0.f;
  }
}

// the thread's 4x4 entries (rows ty + 16 i, columns tx + 16 j) of
// S = Q K^T and dP = dO V^T for one (query tile, key tile) pair
template <int D>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int tx, int ty, float s[4][4],
                                            float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], ka[4], va[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[(ty + 16 * i) * (D + 1) + d];
      oa[i] = dOs[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ka[j] = Ks[(tx + 16 * j) * (D + 1) + d];
      va[j] = Vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
      }
  }
}

// turns the thread's S into P * D (P without dropout) and dP into dS in
// place (see the header); DROP = false compiles the dropout away
template <bool DROP>
__device__ __forceinline__ void probs(float s[4][4], float dp[4][4], int q0,
                                      int k0, int Sq, int Sk, int len,
                                      int causal, const float* mb,
                                      long long msq, long long msk,
                                      float scale, const float* lse_s,
                                      const float* dl_s, int tx, int ty,
                                      const Dropout& drop, uint32_t row_key) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    const float lse = lse_s[r], dl = dl_s[r];
    uint32_t xq = 0u;
    if constexpr (DROP) xq = fmix32(row_key ^ (uint32_t)qi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ki = k0 + tx + 16 * j;
      const bool keep = qi < Sq && ki < Sk && ki < len && (!causal || qi >= ki);
      float p = 0.f, ds = 0.f;
      if (keep) {
        float x = s[i][j] * scale;
        if (mb) x += mb[qi * msq + ki * msk];
        p = expf(x - lse);
        float dm = 1.f;
        if constexpr (DROP)
          dm = fmix32(xq ^ (uint32_t)ki ^ drop.seed1) >= drop.thresh
                   ? drop.dscale : 0.f;
        ds = p * (dp[i][j] * dm - dl);
        p *= dm;
      }
      s[i][j] = p;
      dp[i][j] = ds;
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_floats() {
  return 2 * kBK * (D + 1)      // K, V tiles
         + 2 * kBQ * (D + 1)    // Q, dO tiles
         + 2 * kBQ * (kBK + 1)  // P, dS
         + 2 * kBQ;             // lse, delta of the query tile
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * kBQ * (D + 1)      // Q, dO tiles
         + 2 * kBK * (D + 1)    // K, V tiles
         + kBQ * (kBK + 1)      // dS
         + 2 * kBQ;             // lse, delta
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, const int* __restrict__ kv_lens,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
    long long msb, long long msh, long long msq, long long msk, float scale,
    int causal, uint32_t seed0, Dropout drop) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * (D + 1);
  float* Qs = Vs + kBK * (D + 1);
  float* dOs = Qs + kBQ * (D + 1);
  float* Ps = dOs + kBQ * (D + 1);
  float* dSs = Ps + kBQ * (kBK + 1);
  float* lse_s = dSs + kBQ * (kBK + 1);
  float* dl_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * kBK;

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hkv * D;
  const long long kv_off = ((long long)b * Sk * Hkv + hk) * D;
  const int len = kv_lens ? kv_lens[b] : Sk;

  constexpr int NC = D / 16;
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // query tiles whose last row reaches this key tile's first row (all of
  // them unless causal); none when every key of the tile is past kv_lens
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int i_first = causal ? k0 / kBQ : 0;
  if (k0 < len && i_first < nq) {  // uniform over the block
    load_tile<T, D>(Ks, k + kv_off, kv_stride, k0, Sk, tid);
    load_tile<T, D>(Vs, v + kv_off, kv_stride, k0, Sk, tid);
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      const long long q_off = ((long long)b * Sq * H + h) * D;
      const float* lb = lse + ((long long)b * H + h) * Sq;
      const float* db = delta + ((long long)b * H + h) * Sq;
      const float* mb = mask ? mask + b * msb + h * msh : nullptr;
      // dropout hashes the query head's row, not the KV head's
      const uint32_t row_key = fmix32((uint32_t)(b * H + h) ^ seed0);
      for (int it = i_first; it < nq; ++it) {
        const int q0 = it * kBQ;
        __syncthreads();  // the previous tile's readers are done
        load_tile<T, D>(Qs, q + q_off, q_stride, q0, Sq, tid);
        load_tile<T, D>(dOs, dout + q_off, q_stride, q0, Sq, tid);
        for (int r = tid; r < kBQ; r += kThreads) {
          const bool in = q0 + r < Sq;
          lse_s[r] = in ? lb[q0 + r] : 0.f;
          dl_s[r] = in ? db[q0 + r] : 0.f;
        }
        __syncthreads();

        float s[4][4], dp[4][4];
        score_tiles<D>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
        probs<DROP>(s, dp, q0, k0, Sq, Sk, len, causal, mb, msq, msk, scale,
                    lse_s, dl_s, tx, ty, drop, row_key);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int idx = (ty + 16 * i) * (kBK + 1) + tx + 16 * j;
            Ps[idx] = s[i][j];
            dSs[idx] = dp[i][j];
          }
        __syncthreads();

        // dV[key] += (P D)[q, key] dO[q];  dK[key] += dS[q, key] Q[q]; the
        // thread owns keys ty + 16 i and features tx + 16 j
        const int rows = min(kBQ, Sq - q0);
        for (int qq = 0; qq < rows; ++qq) {
          float pa[4], da[4], oa[NC], xa[NC];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pa[i] = Ps[qq * (kBK + 1) + ty + 16 * i];
            da[i] = dSs[qq * (kBK + 1) + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            oa[j] = dOs[qq * (D + 1) + tx + 16 * j];
            xa[j] = Qs[qq * (D + 1) + tx + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NC; ++j) {
              dv_acc[i][j] = fmaf(pa[i], oa[j], dv_acc[i][j]);
              dk_acc[i][j] = fmaf(da[i], xa[j], dk_acc[i][j]);
            }
        }
      }
    }
  }

  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const long long o = ki * kv_stride + tx + 16 * j;
      dkb[o] = from_f<T>(dk_acc[i][j] * scale);
      dvb[o] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, const int* __restrict__ kv_lens,
    T* __restrict__ dq, int Sq, int Sk, int H, int Hkv, long long msb,
    long long msh, long long msq, long long msk, float scale, int causal,
    uint32_t seed0, Dropout drop) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * (D + 1);
  float* Ks = dOs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* dSs = Vs + kBK * (D + 1);
  float* lse_s = dSs + kBQ * (kBK + 1);
  float* dl_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Hkv * D;
  const long long q_off = ((long long)b * Sq * H + h) * D;
  const long long kv_off = ((long long)b * Sk * Hkv + hk) * D;
  const float* lb = lse + (long long)blockIdx.y * Sq;
  const float* db = delta + (long long)blockIdx.y * Sq;
  const float* mb = mask ? mask + b * msb + h * msh : nullptr;
  const int len = kv_lens ? kv_lens[b] : Sk;
  const uint32_t row_key = fmix32((uint32_t)blockIdx.y ^ seed0);  // b*H + h

  load_tile<T, D>(Qs, q + q_off, q_stride, q0, Sq, tid);
  load_tile<T, D>(dOs, dout + q_off, q_stride, q0, Sq, tid);
  for (int r = tid; r < kBQ; r += kThreads) {
    const bool in = q0 + r < Sq;
    lse_s[r] = in ? lb[q0 + r] : 0.f;
    dl_s[r] = in ? db[q0 + r] : 0.f;
  }

  constexpr int NC = D / 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  // key tiles past the tile's last query row (causal) or past kv_lens
  // hold no kept entry
  int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  k_end = min(k_end, len);

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q/dO loaded; the previous tile's readers are done
    load_tile<T, D>(Ks, k + kv_off, kv_stride, k0, Sk, tid);
    load_tile<T, D>(Vs, v + kv_off, kv_stride, k0, Sk, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<D>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
    probs<DROP>(s, dp, q0, k0, Sq, Sk, len, causal, mb, msq, msk, scale,
                lse_s, dl_s, tx, ty, drop, row_key);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ[q] += dS[q, key] K[key]; the thread owns rows ty + 16 i and
    // features tx + 16 j
    const int cols = min(kBK, Sk - k0);
    for (int kk = 0; kk < cols; ++kk) {
      float da[4], ka[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = dSs[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) ka[j] = Ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(da[i], ka[j], acc[i][j]);
    }
  }

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dqb[qi * q_stride + tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

}  // namespace

// ------------------------------------------------------------------------
// bf16: the tensor-core kernels (wgmma, sm_90a). See the note at the top.

namespace tc {

constexpr int kBM = 64;       // query rows per tile
constexpr int kStages = 2;    // depth of the cp.async ring
// warpgroups of 64 keys in a dK/dV CTA: 1 runs two independent CTAs per
// SM, whose elementwise phases overlap each other's products
constexpr int kDkdvWG = 1;

// A fragments of the 4 k-steps of a 64 x 64 f32 accumulator (its columns
// become wgmma's K; the m64nNk16 accumulator layout already is the A
// layout), each value x split in two bf16, hi = bf16(x) and lo = bf16(x -
// hi): hi + lo keeps 16 significant bits of x where one bf16 keeps 8
__device__ __forceinline__ void to_a_frags(const float (&x)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = x[8 * s + 2 * i], b = x[8 * s + 2 * i + 1];
      __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
      hi[s][i] = *reinterpret_cast<uint32_t*>(&h);
      lo[s][i] = *reinterpret_cast<uint32_t*>(&l);
    }
}

// P = exp(s * scale + mask - lse) where kept, else exactly 0, on one
// element of an S (or S^T) accumulator, without a branch: a dropped
// entry's exponent is computed and discarded, its mask entry read at a
// safe index. With a mask, s * scale + mask is summed first, as in the
// plain version, so a row whose keys the mask all sets to -1e30 (lse
// -1e30 too) gets P = 1 as there; without one the exponent is one fma in
// base 2 (nlse2 = -lse * log2(e), sl2 = scale * log2(e)).
template <bool MASK>
__device__ __forceinline__ float prob(float s, bool keep, const float* mb,
                                      long long mi, float scale, float lse,
                                      float nlse2, float sl2) {
  float x;
  if constexpr (MASK)
    x = (s * scale + mb[keep ? mi : 0] - lse) * kLog2e;
  else
    x = fmaf(s, sl2, nlse2);
  const float p = ex2(x);
  return keep ? p : 0.f;
}

// dK/dV: one CTA of kDkdvWG warpgroups per (batch x KV head, 64 kDkdvWG
// keys); warpgroup w owns keys [k0 + 64 w, k0 + 64 w + 64). K and V stay
// in shared memory; Q, dO, lse and delta of the (query head, query tile)
// pairs stream through a 2-stage cp.async ring.
template <int D, bool DROP>
__global__ void __launch_bounds__(128 * kDkdvWG, 2 / kDkdvWG)
    flash_bwd_dkdv_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, const int* __restrict__ kv_lens,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
    int Hkv, long long msb, long long msh, long long msq, long long msk,
    float scale, int causal, uint32_t seed0, Dropout drop) {
  constexpr int BN = 64 * kDkdvWG, NT = 128 * kDkdvWG;
  constexpr uint32_t KV_BYTES = BN * D * 2, Q_BYTES = kBM * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u, sV = sK + KV_BYTES;
  const uint32_t sQ = sV + KV_BYTES, sO = sQ + kStages * Q_BYTES;
  const uint32_t sRows = sO + kStages * Q_BYTES;  // [stage][lse | delta]
  const float* rows = reinterpret_cast<const float*>(smem_raw + (sRows - raw));

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, group = H / Hkv;
  const int k0 = blockIdx.y * BN, kw = k0 + 64 * wg;
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const long long kv_off = ((long long)b * Sk * Hkv + hk) * D;
  const int kend = kv_lens ? min(Sk, kv_lens[b]) : Sk;
  // the query tiles whose last row reaches the key tile's first row, for
  // every query head of the group; none when the tile is past kv_lens
  const int nq = (Sq + kBM - 1) / kBM;
  const int i_first = causal ? k0 / kBM : 0;
  const int per_g = k0 < kend && i_first < nq ? nq - i_first : 0;
  const int n_it = group * per_g;

  auto load_stage = [&](int it, int st) {
    const int h = hk * group + it / per_g;
    const int q0 = (i_first + it % per_g) * kBM;
    const long long q_off = ((long long)b * Sq * H + h) * D;
    load_tile<kBM, D, NT>(sQ + st * Q_BYTES, q + q_off, q_stride, q0, Sq, tid);
    load_tile<kBM, D, NT>(sO + st * Q_BYTES, dout + q_off, q_stride, q0, Sq,
                          tid);
    if (tid < 2 * kBM) {
      const int r = tid % kBM;
      const bool in = q0 + r < Sq;
      const float* src = (tid < kBM ? lse : delta) +
                         ((long long)b * H + h) * Sq + (in ? q0 + r : 0);
      cp_async4(sRows + (st * 2 * kBM + tid) * 4, src, in ? 4 : 0);
    }
  };

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n_it > 0) {
    load_tile<BN, D, NT>(sK, k + kv_off, kv_stride, k0, Sk, tid);
    load_tile<BN, D, NT>(sV, v + kv_off, kv_stride, k0, Sk, tid);
    load_stage(0, 0);
  }
  cp_async_commit();

  // the thread's key rows (kr, kr + 8 of its warpgroup's 64) and query
  // columns (8 j + qc + {0, 1}) in the S^T accumulator layout
  const int kr = 16 * warp + (lane >> 2), qc = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    cp_async_wait_all();
    __syncthreads();  // stage st landed; everyone is done with stage st ^ 1
    if (it + 1 < n_it) load_stage(it + 1, st ^ 1);
    cp_async_commit();

    const int h = hk * group + it / per_g;
    const int q0 = (i_first + it % per_g) * kBM;
    // uniform over the warpgroup: none of its keys is kept by this tile
    if (kw >= kend || (causal && q0 + kBM - 1 < kw)) continue;
    const bool full = q0 + kBM <= Sq && kw + 64 <= kend &&
                      (!causal || q0 >= kw + 63);
    const uint32_t qs = sQ + st * Q_BYTES, os = sO + st * Q_BYTES;
    const float* lse_t = rows + st * 2 * kBM;
    const float* dl_t = lse_t + kBM;
    const float* mb = mask ? mask + b * msb + h * msh : nullptr;

    // S^T = K Q^T and dP^T = V dO^T (keys x queries), A and B from shared
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, kmajor_desc<BN>(sK, 64 * wg, kk),
               kmajor_desc<kBM>(qs, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, kmajor_desc<BN>(sV, 64 * wg, kk),
               kmajor_desc<kBM>(os, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    auto to_probs = [&](auto masked, auto interior) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + qc + e, qi = q0 + c;
          const float l = lse_t[c];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int ki = kw + kr + 8 * rr;
            const bool keep = decltype(interior)::value ||
                              ((qi < Sq) & (ki < kend) &
                               (!causal | (qi >= ki)));
            float& x = s[4 * j + 2 * rr + e];
            x = prob<decltype(masked)::value>(x, keep, mb,
                                              qi * msq + ki * msk, scale, l,
                                              -l * kLog2e, sl2);
          }
        }
    };
    if (mb)
      to_probs(std::true_type{}, std::false_type{});
    else if (full)
      to_probs(std::false_type{}, std::true_type{});
    else
      to_probs(std::false_type{}, std::false_type{});
    wgmma_wait<0>();
    fence_regs(dp);
    const uint32_t row_key = fmix32((uint32_t)(b * H + h) ^ seed0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + qc + e;
        const float dl = dl_t[c];
        uint32_t xq = 0u;
        if constexpr (DROP) xq = fmix32(row_key ^ (uint32_t)(q0 + c));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr + e;
          if constexpr (DROP) {
            const uint32_t ki = (uint32_t)(kw + kr + 8 * rr);
            const float dm =
                fmix32(xq ^ ki ^ drop.seed1) >= drop.thresh ? drop.dscale
                                                            : 0.f;
            dp[i] = s[i] * (dp[i] * dm - dl);
            s[i] *= dm;
          } else {
            dp[i] = s[i] * (dp[i] - dl);
          }
        }
      }
    // dV += (P D)^T dO and dK += dS^T Q, each as the hi and the lo part:
    // A from registers, B the query-major dO / Q tiles read transposed
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
    to_a_frags(s, ph, pl);
    to_a_frags(dp, sh, sl);
    wgmma_fence();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // two independent chains, interleaved
      wgmma_rs_tb(dv_acc, ph[kk], mnmajor_desc<kBM>(os, kk));
      wgmma_rs_tb(dk_acc, sh[kk], mnmajor_desc<kBM>(qs, kk));
      wgmma_rs_tb(dv_acc, pl[kk], mnmajor_desc<kBM>(os, kk));
      wgmma_rs_tb(dk_acc, sl[kk], mnmajor_desc<kBM>(qs, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(sh);
    fence_regs(sl);
  }

  bf16* dkb = dk + kv_off;
  bf16* dvb = dv + kv_off;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int ki = kw + kr + 8 * rr;
    if (ki >= Sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long o = ki * kv_stride + 8 * j + qc;
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(dkb + o) =
          __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + o) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// dQ: one CTA of one warpgroup per (batch x query head, 64-row query
// tile), launched longest causal row first. Q and dO stay in shared
// memory; K and V tiles of 64 keys stream through a 2-stage ring.
template <int D, bool DROP>
__global__ void __launch_bounds__(128, 2) flash_bwd_dq_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, const int* __restrict__ kv_lens,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int Hkv, long long msb,
    long long msh, long long msq, long long msk, float scale, int causal,
    uint32_t seed0, Dropout drop) {
  constexpr int BN = 64, NT = 128;
  constexpr uint32_t T_BYTES = 64 * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sO = sQ + T_BYTES, sKV = sO + T_BYTES;  // [stage][K | V]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = ((Sq + kBM - 1) / kBM - 1 - (int)blockIdx.y) * kBM;
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const long long q_off = ((long long)b * Sq * H + h) * D;
  const long long kv_off = ((long long)b * Sk * Hkv + hk) * D;
  const int kend = kv_lens ? min(Sk, kv_lens[b]) : Sk;
  // key tiles up to the causal end and the kv_lens end
  const int k_stop = causal ? min(kend, q0 + kBM) : kend;
  const int n_it = k_stop > 0 ? (k_stop + BN - 1) / BN : 0;
  const float* mb = mask ? mask + b * msb + h * msh : nullptr;

  // the thread's query rows (qr, qr + 8) and key columns (8 j + kc +
  // {0, 1}) in the S accumulator layout, with their lse, delta and hash
  const int qr = 16 * warp + (lane >> 2), kc = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;
  const float* lb = lse + (long long)blockIdx.x * Sq;
  const float* db = delta + (long long)blockIdx.x * Sq;
  float l[2], nl2[2], dl[2];
  uint32_t xq[2];
  const uint32_t row_key = fmix32((uint32_t)blockIdx.x ^ seed0);  // b*H + h
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + qr + 8 * rr;
    l[rr] = qi < Sq ? lb[qi] : 0.f;
    dl[rr] = qi < Sq ? db[qi] : 0.f;
    nl2[rr] = -l[rr] * kLog2e;
    xq[rr] = DROP ? fmix32(row_key ^ (uint32_t)qi) : 0u;
  }

  auto load_stage = [&](int it, int st) {
    const uint32_t kv = sKV + st * 2 * T_BYTES;
    load_tile<BN, D, NT>(kv, k + kv_off, kv_stride, it * BN, Sk, tid);
    load_tile<BN, D, NT>(kv + T_BYTES, v + kv_off, kv_stride, it * BN, Sk,
                         tid);
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (n_it > 0) {
    load_tile<kBM, D, NT>(sQ, q + q_off, q_stride, q0, Sq, tid);
    load_tile<kBM, D, NT>(sO, dout + q_off, q_stride, q0, Sq, tid);
    load_stage(0, 0);
  }
  cp_async_commit();

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages, k0 = it * BN;
    cp_async_wait_all();
    __syncthreads();  // stage st landed; everyone is done with stage st ^ 1
    if (it + 1 < n_it) load_stage(it + 1, st ^ 1);
    cp_async_commit();
    const uint32_t ks = sKV + st * 2 * T_BYTES, vs = ks + T_BYTES;
    const bool full = q0 + kBM <= Sq && k0 + BN <= kend &&
                      (!causal || k0 + BN - 1 <= q0);

    // S = Q K^T and dP = dO V^T (queries x keys), A and B from shared
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, kmajor_desc<kBM>(sQ, 0, kk), kmajor_desc<BN>(ks, 0, kk),
               kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, kmajor_desc<kBM>(sO, 0, kk), kmajor_desc<BN>(vs, 0, kk),
               kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    auto to_probs = [&](auto masked, auto interior) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ki = k0 + 8 * j + kc + e;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int qi = q0 + qr + 8 * rr;
            const bool keep = decltype(interior)::value ||
                              ((qi < Sq) & (ki < kend) &
                               (!causal | (qi >= ki)));
            float& x = s[4 * j + 2 * rr + e];
            x = prob<decltype(masked)::value>(x, keep, mb,
                                              qi * msq + ki * msk, scale,
                                              l[rr], nl2[rr], sl2);
          }
        }
    };
    if (mb)
      to_probs(std::true_type{}, std::false_type{});
    else if (full)
      to_probs(std::false_type{}, std::true_type{});
    else
      to_probs(std::false_type{}, std::false_type{});
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr + e;
          float dm = 1.f;
          if constexpr (DROP)
            dm = fmix32(xq[rr] ^ (uint32_t)(k0 + 8 * j + kc + e) ^
                        drop.seed1) >= drop.thresh
                     ? drop.dscale
                     : 0.f;
          dp[i] = s[i] * (dp[i] * dm - dl[rr]);
        }
    // dQ += dS K as the hi and the lo part: A from registers, B the
    // key-major K tile read transposed
    uint32_t sh[4][4], sl[4][4];
    to_a_frags(dp, sh, sl);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tb(acc, sh[kk], mnmajor_desc<BN>(ks, kk));
      wgmma_rs_tb(acc, sl[kk], mnmajor_desc<BN>(ks, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(sh);
    fence_regs(sl);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + qr + 8 * rr;
    if (qi >= Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(dq + q_off + qi * q_stride + 8 * j +
                                         kc) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

template <int D>
constexpr int dkdv_smem_bytes() {
  return 1024 + 2 * 64 * kDkdvWG * D * 2 +
         kStages * (2 * kBM * D * 2 + 2 * kBM * 4);
}
template <int D>
constexpr int dq_smem_bytes() {
  return 1024 + 2 * kBM * D * 2 + kStages * 2 * 64 * D * 2;
}

}  // namespace tc

namespace {

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *mask;
  const int* kv_lens;
  int B, Sq, Sk, H, Hkv;
  long long msb, msh, msq, msk;
  float scale;
  int causal;
  uint32_t seed0;
  Dropout drop;
};

template <typename T, int D>
int launch_dkdv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  const size_t smem = dkdv_smem_floats<D>() * sizeof(float);
  auto kern = a.drop.dscale > 0.f ? flash_bwd_dkdv_kernel<T, D, true>
                                  : flash_bwd_dkdv_kernel<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + kBK - 1) / kBK, a.B * a.Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.mask, a.kv_lens, static_cast<T*>(dk), static_cast<T*>(dv),
      a.Sq, a.Sk, a.H, a.Hkv, a.msb, a.msh, a.msq, a.msk, a.scale, a.causal,
      a.seed0, a.drop);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kern = a.drop.dscale > 0.f ? flash_bwd_dq_kernel<T, D, true>
                                  : flash_bwd_dq_kernel<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.mask, a.kv_lens, static_cast<T*>(dq), a.Sq, a.Sk, a.H,
      a.Hkv, a.msb, a.msh, a.msq, a.msk, a.scale, a.causal, a.seed0, a.drop);
  return (int)cudaGetLastError();
}

// the bf16 kernels copy 16 bytes at a time and store bf16 pairs
bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }
bool aligned16(const Args& a) {
  return aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.dout);
}

template <int D>
int launch_dkdv_wgmma(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  constexpr int smem = tc::dkdv_smem_bytes<D>();
  auto kern = a.drop.dscale > 0.f ? tc::flash_bwd_dkdv_wgmma<D, true>
                                  : tc::flash_bwd_dkdv_wgmma<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // key tile 0 has the most query tiles under causality: blockIdx.y = 0
  // (every batch x KV head of it) is scheduled first
  constexpr int BN = 64 * tc::kDkdvWG;
  dim3 grid(a.B * a.Hkv, (a.Sk + BN - 1) / BN);
  kern<<<grid, 128 * tc::kDkdvWG, smem, stream>>>(
      static_cast<const tc::bf16*>(a.q), static_cast<const tc::bf16*>(a.k),
      static_cast<const tc::bf16*>(a.v), static_cast<const tc::bf16*>(a.dout),
      a.lse, a.delta, a.mask, a.kv_lens, static_cast<tc::bf16*>(dk),
      static_cast<tc::bf16*>(dv), a.Sq, a.Sk, a.H, a.Hkv, a.msb, a.msh, a.msq,
      a.msk, a.scale, a.causal, a.seed0, a.drop);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const Args& a, void* dq, cudaStream_t stream) {
  constexpr int smem = tc::dq_smem_bytes<D>();
  auto kern = a.drop.dscale > 0.f ? tc::flash_bwd_dq_wgmma<D, true>
                                  : tc::flash_bwd_dq_wgmma<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.H, (a.Sq + tc::kBM - 1) / tc::kBM);
  kern<<<grid, 128, smem, stream>>>(
      static_cast<const tc::bf16*>(a.q), static_cast<const tc::bf16*>(a.k),
      static_cast<const tc::bf16*>(a.v), static_cast<const tc::bf16*>(a.dout),
      a.lse, a.delta, a.mask, a.kv_lens, static_cast<tc::bf16*>(dq), a.Sq,
      a.Sk, a.H, a.Hkv, a.msb, a.msh, a.msq, a.msk, a.scale, a.causal,
      a.seed0, a.drop);
  return (int)cudaGetLastError();
}

bool valid(const Args& a) {
  return a.H > 0 && a.Hkv > 0 && a.H % a.Hkv == 0 && a.B > 0 && a.Sq > 0 &&
         a.Sk > 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Layouts: q/dout/dq [B, Sq, H, D],
// k/v/dk/dv [B, Sk, Hkv, D], lse/delta [B, H, Sq] f32, all contiguous;
// mask (may be null) is f32 addressed as mask[b*msb + h*msh + q*msq +
// k*msk]; kv_lens (may be null) is int32 [B]. Dropout: dscale = 1 / (1 - p)
// as f32, 0 for none; thresh = min(2^32 - 1, round(p * 2^32)); seed0 and
// seed1 the forward call's two int32 seeds. Each returns
// cudaGetLastError().
#define FLASH_BWD_ARGS                                                        \
  int dtype, int head_dim, const void *q, const void *k, const void *v,       \
      const void *dout, const float *lse, const float *delta,                 \
      const float *mask, const int *kv_lens
#define FLASH_BWD_DIMS                                                        \
  int B, int Sq, int Sk, int H, int Hkv, long long msb, long long msh,        \
      long long msq, long long msk, float scale, int causal, int seed0,       \
      int seed1, unsigned thresh, float dscale, cudaStream_t stream
#define FLASH_BWD_PACK                                                        \
  const Args a{q,     k,     v,      dout,   lse, delta, mask,              \
               kv_lens, B,   Sq,     Sk,     H,   Hkv,   msb,               \
               msh,   msq,   msk,    scale,  causal, (uint32_t)seed0,        \
               Dropout{(uint32_t)seed1, (uint32_t)thresh, dscale}};          \
  if (!valid(a)) return (int)cudaErrorInvalidValue

extern "C" int flash_bwd_dkdv(FLASH_BWD_ARGS, void* dk, void* dv,
                              FLASH_BWD_DIMS) {
  FLASH_BWD_PACK;
  if (dtype == 0 && head_dim == 64) return launch_dkdv<float, 64>(a, dk, dv, stream);
  if (dtype == 0 && head_dim == 128) return launch_dkdv<float, 128>(a, dk, dv, stream);
  if (dtype == 1 && (head_dim == 64 || head_dim == 128)) {
    if (!aligned16(a) || !aligned16(dk) || !aligned16(dv))
      return (int)cudaErrorMisalignedAddress;
    return head_dim == 64 ? launch_dkdv_wgmma<64>(a, dk, dv, stream)
                          : launch_dkdv_wgmma<128>(a, dk, dv, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dq(FLASH_BWD_ARGS, void* dq, FLASH_BWD_DIMS) {
  FLASH_BWD_PACK;
  if (dtype == 0 && head_dim == 64) return launch_dq<float, 64>(a, dq, stream);
  if (dtype == 0 && head_dim == 128) return launch_dq<float, 128>(a, dq, stream);
  if (dtype == 1 && (head_dim == 64 || head_dim == 128)) {
    if (!aligned16(a) || !aligned16(dq)) return (int)cudaErrorMisalignedAddress;
    return head_dim == 64 ? launch_dq_wgmma<64>(a, dq, stream)
                          : launch_dq_wgmma<128>(a, dq, stream);
  }
  return (int)cudaErrorInvalidValue;
}

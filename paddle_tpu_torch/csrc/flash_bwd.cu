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
// `flash_bwd_dkdv`: one block per (batch x KV head, 64-key tile). It holds
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
// the bf16 tensor cores. This first version runs on the FMA units in f32
// (mma/wgmma and TMA are later work): 256 threads per block, each owning
// a 4x4 micro-tile of the 64x64 score tile (for S and dP at once) and a
// 4 x D/16 slice of its accumulators; tiles are f32 in shared memory with
// one column of padding so the strided reads stay free of bank conflicts.
// Scores never leave the chip: device memory sees each input tile read
// once per tile pair and each output written once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
  if (dtype == 1 && head_dim == 64)
    return launch_dkdv<__nv_bfloat16, 64>(a, dk, dv, stream);
  if (dtype == 1 && head_dim == 128)
    return launch_dkdv<__nv_bfloat16, 128>(a, dk, dv, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dq(FLASH_BWD_ARGS, void* dq, FLASH_BWD_DIMS) {
  FLASH_BWD_PACK;
  if (dtype == 0 && head_dim == 64) return launch_dq<float, 64>(a, dq, stream);
  if (dtype == 0 && head_dim == 128) return launch_dq<float, 128>(a, dq, stream);
  if (dtype == 1 && head_dim == 64)
    return launch_dq<__nv_bfloat16, 64>(a, dq, stream);
  if (dtype == 1 && head_dim == 128)
    return launch_dq<__nv_bfloat16, 128>(a, dq, stream);
  return (int)cudaErrorInvalidValue;
}

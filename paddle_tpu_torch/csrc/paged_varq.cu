// Variable-query paged attention for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/paged_attention.py `_ragged_varq_kernel`
// (launched by `_paged_attention_ragged_varq_pallas` from
// `paged_attention_ragged_varq`), the attention of the serving loop's
// MIXED prefill+decode step and of speculative verify: every slot b
// carries a span of q_lens[b] queries (a prefill chunk, drafted tokens,
// or one decode token) whose K/V is already written to its pages.
//
// Computes, for slot b, span row i < q_lens[b] and query head h (KV head
// h / (H / Hkv)), with qpos = kv_lens[b] - q_lens[b] + i:
//   out[b, i, h] = sum over keys t <= qpos, t < kv_lens[b] of
//                  softmax_t(q[b, i, h] . K[t] * scale) V[t]
// where key t lives in the slot's page list at t / page, row t % page.
// The page list is the slot's block-table row (`tables` [B, pps]: the
// reference's mixed step without ragged meta) or its entries in the
// ragged meta (`meta` [6, G], rows seq, page, ordinal, first, last,
// valid: a slot's valid entries are contiguous and in ordinal order, the
// layout RaggedMetaBuilder and build_ragged_meta produce); keys stop
// where the list stops. Padding rows (i >= q_lens[b]) and slots with
// kv_lens == 0 are written as zeros by this kernel.
//
// Scores are f32. The f32 kernel keeps P in f32, as the Pallas kernel;
// the bf16 kernel keeps it to 16 bits (bf16 hi + lo), the f16 kernel to 11
// (one f16). The XLA reference
// (`_paged_attention_varq_xla`) rounds P to the value dtype before P.V,
// so in bf16 the two differ by that rounding (within the bf16
// tolerance). The f32 kernel's masked scores are exactly -1e30, never
// -inf, so its online-softmax rescale exp(m_prev - m_new) stays finite;
// the bf16 kernel's are -inf against a running max that starts at -1e30.
//
// Bound on the H100: a prefill chunk of Qs rows reuses each K/V byte for
// ~Qs operations per head, so long chunks are compute-bound (tensor-core
// peak) and decode and verify rows memory-bound. Each K/V byte is read
// once per query tile: a tile's 64 rows are up to 64 / G span rows times
// the G query heads of one KV head (GQA reads each K/V tile once for the
// whole group). Row r of the tile is span row i0 + r / G, query head
// hk * G + r % G, at position kv_lens - q_lens + i0 + r / G.
//
// bf16 (dtype 1): `tc::paged_varq_wgmma`, flash_fwd.cu's tensor-core
// forward over the slot's pages. A CTA of one warpgroup (128 threads)
// owns one (64-row query tile, KV head, slot). The Q tile is copied, 16
// bytes at a time, into the 128-byte-swizzled layout that wgmma's
// descriptors read; 64-key K and V tiles stream through 2-stage cp.async
// rings, gathered row by row from the slot's pages (wgmma.cuh's
// `load_rows`: 4 pages a tile at page 16), keys past the walk's end
// zero-filled, never read. Key tiles wholly past the causal edge of the
// tile's last real row or past kv_lens are never loaded. Per tile: S = Q
// K^T is `wgmma` m64n64k16 with both operands in shared memory; then, in
// the accumulator registers, the keep test (key < kv_lens, key <= the
// row's position; only on edge tiles), the online max and sum with quad
// shuffles and P = ex2 of a prescaled fma; O += P V is `wgmma` with P
// from registers and the key-major V tile read transposed, P entering as
// bf16 hi + lo parts (kVarqSplitP, as flash_fwd.cu: one bf16 P rounds
// the unnormalised exp(s - m) of the running max where the plain version
// rounds the normalised P, and a span's first rows rest on few keys).
// Padding span rows are written as zeros; tiles of padding rows only
// write their zeros and exit. A slot whose span fits one query tile
// (verify spans of 1 + drafts rows, single decode rows) walks its whole
// context in one CTA; there each walk is split over a thread-block
// cluster of up to kVarqMaxCluster CTAs (one per kVarqMinShare keys the
// page source can name: pps * page, or G * page, known without a sync),
// rank r taking the r-th contiguous share of the key tiles, and the
// ranks' (max, sum, accumulator) combine through distributed shared
// memory in a fixed rank order, as decode_split.cuh's decode walk. One
// owner per output element and no atomics: two launches agree bit for
// bit. Measured on an H100 80GB HBM3 at 700 W (tools/kernel_variants.py,
// at q[4, 256, 32, 128] mixed spans and q[4, 5, 32, 128] verify spans):
// the 2-CTA split takes the verify shape from ~0.031 to ~0.029 ms, 4
// CTAs (~0.039) lose to the unsplit walk; a 3-stage ring is slower at
// both shapes (one CTA per SM); one bf16 P is ~6 % faster and passed the
// card tolerance there, but is not shipped: flash_fwd.cu's one bf16 P
// failed it on rare few-key rows (1 element in 67 M).
//
// f16 (dtype 2): the same wgmma kernel with f16 operands and P as one f16
// (kVarqSplitPF16 off, as flash_fwd.cu decides for f16: at both shapes one
// f16 P and hi + lo parts gave the same largest error, 1.95e-3, none
// outside TOL[float16], and one P was 3-5 % faster; H100 80GB HBM3, 700
// W, tools/kernel_variants.py --dtype float16).
//
// q and pages of different dtypes (q in the model's dtype, pages in the
// KV pool's `kv_dtype`; each of f32 / bf16 / f16): the FMA kernel below
// with q read as TQ and pages as TKV, converted to f32 on load and the
// output in TQ. With 16-bit pages the walk runs twice, as paged_decode.cu's
// FMA kernel: the rows' max and sum first, then P = TKV(exp(s - m) / l)
// times V, so that P is rounded where the plain version rounds it (after
// normalising); f32 pages take one online pass.
//
// f32 (dtype 0): the FMA-unit kernel below (TF32 is off in the port):
// one block of 256 threads per (64-row query tile, KV head, slot) walks
// the slot's pages in order in 64-key tiles, up to min(kv_lens, last
// query position of the tile + 1) (the causal skip), with the online
// softmax per row in shared memory and a 4 x D/16 slice of the f32
// accumulator per thread in registers. Tiles past q_lens only write
// zeros. K/V rows are fetched with 16-byte loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

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

// 16-byte vector loads: VecIO<T>::N elements of T, unpacked to f32
template <typename T> struct VecIO {  // bf16 or f16: 8 values
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = tc::unpack2<T>(w[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};
template <> struct VecIO<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

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

// TQ is q's and the output's element type, TKV the pages' (with 16-bit
// pages two passes: P normalised, then rounded to TKV before P.V)
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) paged_varq_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ meta, const int* __restrict__ kv_lens,
    const int* __restrict__ q_lens, TQ* __restrict__ out, int Qb, int H,
    int Hkv, int page, int pps, int num_pages, int G, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* Ss = Vs + kBK * D;
  float* m_s = Ss + kBQ * (kBK + 1);
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  __shared__ int s_lo, s_n;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int Gq = H / Hkv;
  const int SR = kBQ / Gq;          // span rows per tile
  const int nrows = SR * Gq;        // tile rows in use
  const int i0 = blockIdx.x * SR;
  const int ql = min(max(q_lens[b], 0), Qb);
  const int kl = kv_lens[b];
  const long long q_stride = (long long)H * D;     // between span rows
  const long long kv_stride = (long long)Hkv * D;  // between key rows
  const TQ* qb = q + (long long)b * Qb * q_stride + (long long)hk * Gq * D;
  TQ* ob = out + (long long)b * Qb * q_stride + (long long)hk * Gq * D;

  if (i0 >= ql || kl <= 0) {
    // padding span rows only: zeros
    for (int e = tid; e < nrows * D; e += kThreads) {
      const int r = e / D, c = e % D, i = i0 + r / Gq;
      if (i < Qb) ob[i * q_stride + (r % Gq) * D + c] = from_f<TQ>(0.f);
    }
    return;
  }

  // the slot's page list: its block-table row, or its meta entries
  const int* plist;
  int npages;
  if (meta != nullptr) {
    const int* seq_a = meta;
    const int* valid_a = meta + 5 * G;
    if (tid == 0) {
      s_lo = G;
      s_n = 0;
    }
    __syncthreads();
    int n = 0, lo = G;
    for (int g = tid; g < G; g += kThreads) {
      if (valid_a[g] != 0 && seq_a[g] == b) {
        ++n;
        lo = min(lo, g);
      }
    }
    if (n) {
      atomicAdd(&s_n, n);
      atomicMin(&s_lo, lo);
    }
    __syncthreads();
    plist = meta + G + s_lo;
    npages = s_n;
  } else {
    plist = tables + (long long)b * pps;
    npages = pps;
  }
  const int kbound = min(kl, npages * page);
  const int i_last = min(i0 + SR, ql) - 1;
  const int k_end = min(kbound, kl - ql + i_last + 1);

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, i = i0 + r / Gq;
    float x = 0.f;
    if (r < nrows && i < ql) x = to_f(qb[i * q_stride + (r % Gq) * D + c]);
    Qs[r * (D + 1) + c] = x;
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
  // each thread's four rows: their span positions (padding rows get a
  // position before every key, so they are all -1e30 and later zeroed)
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, si = i0 + r / Gq;
    qpos[i] = (r < nrows && si < ql) ? kl - ql + si : -1;
  }
  __syncthreads();

  constexpr int VN = VecIO<TKV>::N;
  constexpr int VPR = D / VN;
  constexpr bool NORM = !std::is_same<TKV, float>::value;
  // pass 0 (NORM only): the rows' max and sum; pass 1: P.V
  for (int pass = NORM ? 0 : 1; pass < 2; ++pass)
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    for (int e = tid; e < kBK * VPR; e += kThreads) {
      const int t = e / VPR, c = (e % VPR) * VN, pos = k0 + t;
      uint4 ku = make_uint4(0u, 0u, 0u, 0u), vu = ku;
      if (pos < k_end) {
        const int pid = min(max(plist[pos / page], 0), num_pages - 1);
        const long long off =
            ((long long)pid * page + pos % page) * kv_stride +
            (long long)hk * D + c;
        ku = *reinterpret_cast<const uint4*>(k_pages + off);
        vu = *reinterpret_cast<const uint4*>(v_pages + off);
      }
      float kf[VN], vf[VN];
      VecIO<TKV>::unpack(ku, kf);
      VecIO<TKV>::unpack(vu, vf);
#pragma unroll
      for (int x = 0; x < VN; ++x) {
        Ks[t * (D + 1) + c + x] = kf[x];
        Vs[t * D + c + x] = vf[x];
      }
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
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, ki = k0 + c;
        const bool keep = ki < k_end && ki <= qpos[i];
        Ss[r * (kBK + 1) + c] = keep ? sc[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, two columns per lane; P stays f32
    // (f32 pages), or is normalised and rounded to TKV in pass 1
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float* row = Ss + r * (kBK + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
      if (NORM && pass == 1) {
        const float m = m_s[r], l = l_s[r];
        const float inv = 1.f / (l == 0.f ? 1.f : l);
        row[lane] = to_f(from_f<TKV>(expf(s0 - m) * inv));
        row[lane + 32] = to_f(from_f<TKV>(expf(s1 - m) * inv));
        if (lane == 0) a_s[r] = 1.f;
        continue;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    if (pass == 0) continue;

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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, si = i0 + r / Gq;
    if (r >= nrows || si >= Qb) continue;
    const float l = NORM ? 1.f : l_s[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    TQ* orow = ob + si * q_stride + (r % Gq) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      orow[tx + 16 * j] = from_f<TQ>(si < ql ? acc[i][j] * inv : 0.f);
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* meta, const int* kv_lens,
           const int* q_lens, void* out, int B, int Qb, int H, int Hkv,
           int page, int pps, int num_pages, int G, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = paged_varq_kernel<TQ, TKV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = kBQ / (H / Hkv);
  dim3 grid((Qb + rows - 1) / rows, Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), tables, meta, kv_lens, q_lens,
      static_cast<TQ*>(out), Qb, H, Hkv, page, pps, num_pages, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma, sm_90a). See the note at the top.

namespace tc {

constexpr int kVarqBN = 64;            // keys per K/V tile
constexpr int kVarqStages = 2;         // depth of the K/V cp.async ring
constexpr bool kVarqSplitP = true;     // P as bf16 hi + lo parts, not one bf16
constexpr bool kVarqSplitPF16 = false;  // the f16 instance: one f16 P
constexpr int kVarqMaxCluster = 2;     // CTAs per one-tile span walk, at most
constexpr int kVarqMinShare = 128;     // keys per rank that warrant one more

// P of one key tile in place: s holds the thread's S = Q K^T entries
// (rows qr and qr + 8 of the tile, columns 8 j + kc + {0, 1}), unscaled;
// qpos the two rows' query positions (-1 on padding rows); m and l the
// rows' running max (natural-log domain) and partial sums, alpha the
// factor the output rows are rescaled by. EDGE applies the keep test
// (key < kend and key <= the row's position).
template <bool EDGE>
__device__ __forceinline__ void varq_probs(float (&s)[kVarqBN / 2],
                                           float (&m)[2], float (&l)[2],
                                           float (&alpha)[2],
                                           const int (&qpos)[2], int k_col0,
                                           int kend, float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kVarqBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ki = k_col0 + 8 * j + e;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float& x = s[4 * j + 2 * rr + e];
        if constexpr (EDGE)
          x = (ki < kend) & (ki <= qpos[rr]) ? x : -INFINITY;
        mx[rr] = fmaxf(mx[rr], x);
      }
    }
  float nm2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    // s is still unscaled: scale > 0 keeps the argmax
    const float m_new = fmaxf(m[rr], mx[rr] * scale);
    alpha[rr] = ex2((m[rr] - m_new) * kLog2e);
    m[rr] = m_new;
    nm2[rr] = -m_new * kLog2e;
    l[rr] *= alpha[rr];
  }
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int j = 0; j < kVarqBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float& x = s[4 * j + 2 * rr + e];
        x = ex2(fmaf(x, sl2, nm2[rr]));
        l[rr] += x;
      }
}

// One cluster of CTAs, each one warpgroup, per (query tile, KV head hk,
// slot b): grid (tiles * cluster, Hkv, B), every tensor of the 16-bit
// element type E. See the note at the top.
template <class E, int D>
__global__ void __launch_bounds__(128, 1) paged_varq_wgmma(
    const E* __restrict__ q, const E* __restrict__ k_pages,
    const E* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ meta, const int* __restrict__ kv_lens,
    const int* __restrict__ q_lens, E* __restrict__ out, int Qb, int H,
    int Hkv, int page, int pps, int num_pages, int G, float scale) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  constexpr int BN = kVarqBN, NT = 128, NS = kVarqStages;
  constexpr bool SPLIT =
      std::is_same<E, f16>::value ? kVarqSplitPF16 : kVarqSplitP;
  constexpr uint32_t Q_BYTES = 64 * D * 2, KV_BYTES = BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t sQ = (base + 1023) & ~1023u;
  const uint32_t sK = sQ + Q_BYTES, sV = sK + NS * KV_BYTES;  // the rings
  __shared__ int s_lo, s_n;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int Gq = H / Hkv;
  const int TQ = 64 / Gq;            // span rows per tile
  const int nrows = TQ * Gq;         // tile rows in use
  const int i0 = (int)(blockIdx.x / n_ranks) * TQ;
  const int ql = min(max(q_lens[b], 0), Qb);
  const int kl = kv_lens[b];
  const long long q_stride = (long long)H * D;     // between span rows
  const long long kv_stride = (long long)Hkv * D;  // between pool rows
  // span row 0 of slot b at the KV head's first query head
  const long long qo = (long long)b * Qb * q_stride + (long long)hk * Gq * D;
  E* ob = out + qo;

  if (i0 >= ql || kl <= 0) {
    // padding span rows only: zeros (written by rank 0)
    if (rank == 0)
      for (int e = tid; e < nrows * D; e += NT) {
        const int r = e / D, i = i0 + r / Gq;
        if (i < Qb)
          ob[i * q_stride + (r % Gq) * D + e % D] = from_f<E>(0.f);
      }
    return;
  }

  // the slot's page list: its block-table row, or its meta entries
  const int* plist;
  int npages;
  if (meta != nullptr) {
    const int* seq_a = meta;
    const int* valid_a = meta + 5 * G;
    if (tid == 0) {
      s_lo = G;
      s_n = 0;
    }
    __syncthreads();
    int n = 0, lo = G;
    for (int g = tid; g < G; g += NT) {
      if (valid_a[g] != 0 && seq_a[g] == b) {
        ++n;
        lo = min(lo, g);
      }
    }
    // one shared atomic per warp
    n = __reduce_add_sync(0xffffffffu, n);
    lo = __reduce_min_sync(0xffffffffu, lo);
    if (lane == 0 && n) {
      atomicAdd(&s_n, n);
      atomicMin(&s_lo, lo);
    }
    __syncthreads();
    plist = meta + G + s_lo;
    npages = s_n;
  } else {
    plist = tables + (long long)b * pps;
    npages = pps;
  }
  const int kbound = min(kl, npages * page);
  const int i_last = min(i0 + TQ, ql) - 1;
  const int k_end = min(kbound, kl - ql + i_last + 1);
  // the walk's key tiles and the rank's contiguous share of them
  const int n_all = k_end > 0 ? (k_end + BN - 1) / BN : 0;
  const int share = (n_all + n_ranks - 1) / n_ranks;
  const int it0 = min(n_all, rank * share);
  const int n_it = min(n_all, it0 + share) - it0;

  // the thread's rows (qr, qr + 8) and key columns (8 j + kc + {0, 1}) in
  // the accumulator layout, with the rows' query positions; a tile whose
  // keys all lie before kend and before the first span row's position
  // needs no keep test
  const int qr = 16 * warp + (lane >> 2), kc = 2 * (lane & 3);
  int qpos[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = qr + 8 * rr, si = i0 + r / Gq;
    qpos[rr] = r < nrows && si < ql ? kl - ql + si : -1;
  }
  const int qpos0 = kl - ql + i0;

  // the rank's key tile i into ring stage i % NS, row by row from the
  // pages
  auto load_kv = [&](int i) {
    if (i >= n_it) return;
    const int k0 = (it0 + i) * BN;
    load_rows<BN, D, NT>(
        sK + (i % NS) * KV_BYTES, k_pages,
        [&](int r) -> long long {
          const int pos = k0 + r;
          if (pos >= k_end) return -1;
          const int pid = min(max(plist[pos / page], 0), num_pages - 1);
          return ((long long)pid * page + pos % page) * kv_stride +
                 (long long)hk * D;
        },
        tid, sV + (i % NS) * KV_BYTES, v_pages);
  };

  float acc[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BN / 2], alpha[2];
  uint32_t pf[BN / 16][4], pl[BN / 16][4];  // P's hi and lo parts (E)

  // groups: {Q, K 0, V 0}, {K 1, V 1}, .. up to tile NS - 2, then one
  // {K, V} per tile, NS - 1 tiles ahead; the next tile's gathers are
  // issued while the S product runs
  if (n_it > 0)
    load_rows<64, D, NT>(
        sQ, q,
        [&](int r) -> long long {
          const int si = i0 + r / Gq;
          return r < nrows && si < ql
                     ? qo + si * q_stride + (long long)(r % Gq) * D
                     : -1;
        },
        tid);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    load_kv(i);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile it landed; everyone is done with tile it - 1
    const uint32_t st = (it % NS) * KV_BYTES;

    // S = Q K^T (queries x keys), A and B from shared memory
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E>(s, kmajor_desc<64>(sQ, 0, kk),
                  kmajor_desc<BN>(sK + st, 0, kk), kk);
    wgmma_commit();
    load_kv(it + NS - 1);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const int k0 = (it0 + it) * BN;
    if (k0 + BN <= k_end && k0 + BN - 1 <= qpos0)
      varq_probs<false>(s, m, l, alpha, qpos, k0 + kc, k_end, scale);
    else
      varq_probs<true>(s, m, l, alpha, qpos, k0 + kc, k_end, scale);

    // O = alpha O, then P as A fragments of E (the accumulator layout is
    // the A layout): hi = E(P) and, with SPLIT, lo = E(P - hi)
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

    // O += P V (hi, then lo), the key-major V tile read transposed
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t vd = mnmajor_desc<BN>(sV + st, kk);
      wgmma_rs_tb<E>(acc, pf[kk], vd);
      if constexpr (SPLIT) wgmma_rs_tb<E>(acc, pl[kk], vd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pf);
    if constexpr (SPLIT) fence_regs(pl);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  if (n_ranks == 1) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = qr + 8 * rr, si = i0 + r / Gq;
      if (r >= nrows || si >= Qb) continue;
      const bool real = si < ql;
      const float safe = l[rr] == 0.f ? 1.f : l[rr];
      E* orow = ob + si * q_stride + (long long)(r % Gq) * D + kc;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            real ? pack2<E>(acc[i] / safe, acc[i + 1] / safe)
                 : pack2<E>(0.f, 0.f);
      }
    }
    return;
  }

  // combine the ranks' (max, sum, accumulator), staged in each rank's now
  // idle K/V rings: rank r writes elements [128 r, 128 r + 128) + 128
  // n_ranks i of the tile's rows
  cp_async_wait<0>();
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem_raw + (sK - base));  // [64][D]
  float* m_s = acc_s + 64 * D;
  float* l_s = m_s + 64;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = qr + 8 * rr;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(acc_s + r * D + 8 * j + kc) =
          make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
    if ((lane & 3) == 0) {
      m_s[r] = m[rr];
      l_s[r] = l[rr];
    }
  }
  cluster.sync();
  for (int e = rank * NT + tid; e < nrows * D; e += n_ranks * NT) {
    const int r = e / D, si = i0 + r / Gq;
    if (si >= Qb) continue;
    float o = 0.f;
    if (si < ql) {
      float m_all = kNegInf;
      for (int k = 0; k < n_ranks; ++k)
        m_all = fmaxf(m_all, cluster.map_shared_rank(m_s, k)[r]);
      float l_all = 0.f;
      for (int k = 0; k < n_ranks; ++k) {
        const float w =
            ex2((cluster.map_shared_rank(m_s, k)[r] - m_all) * kLog2e);
        l_all = fmaf(cluster.map_shared_rank(l_s, k)[r], w, l_all);
        o = fmaf(cluster.map_shared_rank(acc_s, k)[e], w, o);
      }
      o /= l_all == 0.f ? 1.f : l_all;
    }
    ob[si * q_stride + (long long)(r % Gq) * D + e % D] = from_f<E>(o);
  }
  cluster.sync();
}

template <class E, int D>
int launch_wgmma(const void* q, const void* k_pages, const void* v_pages,
                 const int* tables, const int* meta, const int* kv_lens,
                 const int* q_lens, void* out, int B, int Qb, int H, int Hkv,
                 int page, int pps, int num_pages, int G, float scale,
                 cudaStream_t stream) {
  constexpr int smem = 1024 + 64 * D * 2 + kVarqStages * 2 * kVarqBN * D * 2;
  static_assert(64 * D * 4 + 2 * 64 * 4 <= kVarqStages * 2 * kVarqBN * D * 2,
                "the combine's staging must fit the rings");
  auto kern = paged_varq_wgmma<E, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 64 / (H / Hkv), tiles = (Qb + rows - 1) / rows;
  // a one-tile span walks the whole context: split it where it is long
  const long long most = tables ? (long long)pps * page : (long long)G * page;
  const int n_ranks =
      tiles > 1 ? 1
                : (int)std::min<long long>(
                      kVarqMaxCluster,
                      std::max<long long>(
                          1, (most + kVarqMinShare - 1) / kVarqMinShare));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * n_ranks, Hkv, B);
  cfg.blockDim = dim3(128, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const E*>(q),
      static_cast<const E*>(k_pages), static_cast<const E*>(v_pages),
      tables, meta, kv_lens, q_lens, static_cast<E*>(out), Qb, H, Hkv,
      page, pps, num_pages, G, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tc

namespace {

// the 16-bit kernels copy 16 bytes at a time and store element pairs
bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// dtype: q's and the output's element type, kv_dtype: the pages' (0 =
// float32, 1 = bfloat16, 2 = float16). One 16-bit dtype runs the wgmma
// kernel; float32, or q and pages of different dtypes, the FMA kernel.
// Layouts (contiguous): q/out [B, Qb, H, D], k_pages/v_pages [num_pages,
// page, Hkv, D] (16-byte aligned), kv_lens/q_lens int32 [B], and exactly
// one page source: tables int32 [B, pps] (meta null) or meta int32 [6, G]
// (tables null). H / Hkv <= 64. Returns cudaGetLastError().
extern "C" int paged_varq(int dtype, int kv_dtype, int head_dim,
                          const void* q, const void* k_pages,
                          const void* v_pages, const int* tables,
                          const int* meta, const int* kv_lens,
                          const int* q_lens, void* out, int B, int Qb, int H,
                          int Hkv, int page, int pps, int num_pages, int G,
                          float scale, cudaStream_t stream) {
  if (B <= 0 || Qb <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kBQ || page <= 0 || num_pages <= 0 ||
      (tables == nullptr) == (meta == nullptr) ||
      (tables != nullptr && pps <= 0) || (meta != nullptr && G <= 0) ||
      (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  return tc::with_dtype(dtype, [&](auto tq) {
    return tc::with_dtype(kv_dtype, [&](auto tkv) {
      using TQ = typename decltype(tq)::type;
      using TKV = typename decltype(tkv)::type;
      if constexpr (std::is_same<TQ, TKV>::value &&
                    !std::is_same<TQ, float>::value) {
        if (!aligned16(q) || !aligned16(k_pages) || !aligned16(v_pages) ||
            !aligned16(out))
          return (int)cudaErrorMisalignedAddress;
        auto run = head_dim == 64 ? tc::launch_wgmma<TQ, 64>
                                  : tc::launch_wgmma<TQ, 128>;
        return run(q, k_pages, v_pages, tables, meta, kv_lens, q_lens, out, B,
                   Qb, H, Hkv, page, pps, num_pages, G, scale, stream);
      } else {
        auto run = head_dim == 64 ? launch<TQ, TKV, 64> : launch<TQ, TKV, 128>;
        return run(q, k_pages, v_pages, tables, meta, kv_lens, q_lens, out, B,
                   Qb, H, Hkv, page, pps, num_pages, G, scale, stream);
      }
    });
  });
}

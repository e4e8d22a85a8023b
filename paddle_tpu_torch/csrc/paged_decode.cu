// Paged-KV decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/paged_attention.py `_paged_kernel`
// (launched by `_paged_attention_pallas` from `paged_attention`), the
// one-token-per-sequence attention of every serving decode step.
//
// Computes, for sequence b and query head h (KV head h / (H / Hkv)):
//   out[b, h] = sum_{t < ctx[b]} softmax_t(q[b, h] . K[t] * scale) V[t]
// where token t lives in page block_tables[b, t / page] at row
// t % page, and rows with context_lens == 0 are zero (as the Pallas
// kernel writes them). Scores, softmax and the accumulator are f32.
// Page ids are clamped into [0, num_pages), as JAX's gather clamps, and
// the context into [0, pps * page], the keys the block table can name
// (the reference attends no further either).
//
// Bound on the H100: memory. Each cached K/V byte is used for ~2
// operations per query head in the group, far below the ~295 operations
// per byte the card needs before compute limits it. So both kernels read
// every valid K/V row exactly once: a (sequence, KV head) walk serves
// that KV head's whole query-head group (GQA natively, no repeated K/V)
// and reads block_tables itself; tokens past context_lens are never read.
//
// bf16 (dtype 1): `paged_decode_split`, one launch in which each
// (sequence, KV head) walk is split over a thread-block cluster of up to
// kMaxCluster CTAs. At the serving shape one block per (sequence, KV
// head) is about one block per SM, so the longest sequence walked its
// chunks in series while the SMs of short ones idled. Cluster rank r
// takes the r-th contiguous share of the sequence's context (shares of
// ceil(ctx / cluster) tokens rounded up to 16; a rank whose share is empty
// still joins the syncs). The cluster's size comes from pps * page, the
// most the context is clamped to, because the host cannot read
// context_lens without a sync. Each rank walks its share in 32-token
// chunks: K and V stay bf16 in shared memory, copied with 16-byte
// cp.async into a 2-stage ring, so the next chunk's copies are in flight
// while the current one is used; a score is a dot product split over 8
// lanes and reduced with shuffles; the softmax runs one warp per query
// head, a lane per token; the f32 accumulator rescales in shared
// memory. After `cluster.sync()` the ranks combine the cluster's (max,
// sum, accumulator) through distributed shared memory, each rank a slice
// of the output, every element over the ranks in the fixed order 0, 1,
// ...: no workspace, no second launch, and two launches agree bit for
// bit. A second `cluster.sync()` keeps every rank's shared memory alive
// until the combine has read it. Measured on an H100 80GB HBM3 at 700 W
// (tools/kernel_variants.py): clusters of 8 and 64-token chunks were
// slower than 4 and 32; a cluster of 1 is the walk unsplit.
//
// f32 (dtype 0): `paged_decode_kernel`, one block per (KV head,
// sequence) walking the sequence in 64-token chunks with an online
// softmax; each chunk is fetched with 16-byte loads, all of a thread's
// loads issued before any is used; query, probabilities and the f32
// accumulator live in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunk = 64;
constexpr int kThreads = 128;

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

// 16-byte vector loads: VecIO<T>::N elements of T, unpacked to f32
template <typename T> struct VecIO;
template <> struct VecIO<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct VecIO<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
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
size_t smem_floats(int G) {
  return (size_t)G * D            // query group
         + kChunk * (D + 1)       // K chunk
         + kChunk * D             // V chunk
         + (size_t)G * kChunk     // scores / probabilities
         + (size_t)G * D          // accumulator
         + 3 * (size_t)G;         // running max, sum, rescale factor
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lens, T* __restrict__ out, int H, int Hkv,
    int page, int pps, int num_pages, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  float* qs = smem;
  float* ks = qs + G * D;
  float* vs = ks + kChunk * (D + 1);
  float* ps = vs + kChunk * D;
  float* acc = ps + G * kChunk;
  float* m_s = acc + G * D;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int ctx = min(max(lens[b], 0), pps * page);
  const T* qb = q + ((long long)b * H + (long long)hk * G) * D;
  const int* tb = tables + (long long)b * pps;
  const long long row_stride = (long long)Hkv * D;  // between tokens

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  constexpr int VN = VecIO<T>::N;    // elements per 16-byte vector
  constexpr int VPR = D / VN;         // vectors per token row
  static_assert((kChunk * VPR) % kThreads == 0, "chunk must split evenly");
  for (int c0 = 0; c0 < ctx; c0 += kChunk) {
    // unrolled, so every thread has all its (independent) table lookups
    // and 16-byte K/V loads in flight at once
#pragma unroll
    for (int it = 0; it < kChunk * VPR / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int t = i / VPR, c = (i % VPR) * VN, pos = c0 + t;
      uint4 ku = make_uint4(0u, 0u, 0u, 0u), vu = ku;
      if (pos < ctx) {
        int pid = tb[pos / page];
        pid = min(max(pid, 0), num_pages - 1);
        const long long off =
            ((long long)pid * page + pos % page) * row_stride +
            (long long)hk * D + c;
        ku = *reinterpret_cast<const uint4*>(k_pages + off);
        vu = *reinterpret_cast<const uint4*>(v_pages + off);
      }
      float kf[VN], vf[VN];
      VecIO<T>::unpack(ku, kf);
      VecIO<T>::unpack(vu, vf);
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[t * (D + 1) + c + e] = kf[e];
        vs[t * D + c + e] = vf[e];
      }
    }
    __syncthreads();

    for (int pr = tid; pr < G * kChunk; pr += kThreads) {
      const int g = pr / kChunk, t = pr % kChunk;
      const float* qg = qs + g * D;
      const float* kt = ks + t * (D + 1);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kt[d], s);
      ps[pr] = (c0 + t < ctx) ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = ps + g * kChunk;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D, d = e % D;
      const float* pg = ps + g * kChunk;
      float a = acc[e] * a_s[g];
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) a = fmaf(pg[t], vs[t * D + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * H + (long long)hk * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    const float l = l_s[e / D];
    ob[e] = from_f<T>(acc[e] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* lens, void* out, int B, int H,
           int Hkv, int page, int pps, int num_pages, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>(H / Hkv) * sizeof(float);
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, lens, static_cast<T*>(out), H,
      Hkv, page, pps, num_pages, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// bf16: the cluster-split kernel. See the note at the top.

constexpr int kMaxCluster = 4;   // CTAs per walk, at most
constexpr int kMinShare = 64;    // tokens per rank that warrant one more rank
constexpr int kSplitChunk = 32;  // tokens per ring stage

using bf16 = __nv_bfloat16;

template <int D>
size_t split_smem_bytes(int G) {
  return 2 * 2 * kSplitChunk * D * sizeof(bf16)  // K | V ring, 2 stages
         + ((size_t)2 * G                        // running max, sum
            + 2 * (size_t)G * D                  // accumulator, query
            + (size_t)G * kSplitChunk            // scores / probabilities
            + G)                                 // rescale factor
               * sizeof(float);
}

// One cluster of CTAs per (sequence b, KV head hk): grid (cluster, Hkv, B),
// 128 threads per CTA.
template <int D>
__global__ void __launch_bounds__(kThreads) paged_decode_split(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lens, bf16* __restrict__ out, int H, int Hkv,
    int page, int pps, int num_pages, float scale) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int G = H / Hkv;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [stage][K | V][token][D]
  float* m_s = reinterpret_cast<float*>(ring + 2 * 2 * kSplitChunk * D);
  float* l_s = m_s + G;
  float* acc = l_s + G;       // [G][D]
  float* qs = acc + G * D;    // [G][D]
  float* ps = qs + G * D;     // [G][kSplitChunk]
  float* a_s = ps + G * kSplitChunk;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int ctx = min(max(lens[b], 0), pps * page);
  const int share = ((ctx + n_ranks - 1) / n_ranks + 15) & ~15;
  const int t0 = min(ctx, rank * share), t1 = min(ctx, t0 + share);
  const int n_chunks = (t1 - t0 + kSplitChunk - 1) / kSplitChunk;
  const bf16* qb = q + ((long long)b * H + (long long)hk * G) * D;
  const int* tb = tables + (long long)b * pps;
  const long long row_stride = (long long)Hkv * D;  // between tokens

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // the chunk's K and V rows into ring stage st; rows past the share are
  // zero-filled, never read
  constexpr int CPR = D / 8;  // 16-byte copies per row
  static_assert((kSplitChunk * CPR) % kThreads == 0, "chunk must split");
  auto load_chunk = [&](int c, int st) {
    const uint32_t ks = tc::smem_addr(ring + st * 2 * kSplitChunk * D);
    const uint32_t vs = ks + kSplitChunk * D * sizeof(bf16);
#pragma unroll
    for (int j = 0; j < kSplitChunk * CPR / kThreads; ++j) {
      const int i = tid + j * kThreads, t = i / CPR, cc = i % CPR;
      const int pos = t0 + c * kSplitChunk + t;
      const bool in = pos < t1;
      long long off = 0;
      if (in) {
        const int pid = min(max(tb[pos / page], 0), num_pages - 1);
        off = ((long long)pid * page + pos % page) * row_stride +
              (long long)hk * D + cc * 8;
      }
      const uint32_t dst = (t * D + cc * 8) * sizeof(bf16);
      tc::cp_async16(ks + dst, k_pages + off, in ? 16 : 0);
      tc::cp_async16(vs + dst, v_pages + off, in ? 16 : 0);
    }
  };
  if (n_chunks > 0) load_chunk(0, 0);
  tc::cp_async_commit();

  const int grp = tid / 8, l8 = tid % 8;  // 16 groups of 8 lanes
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1, n_in = t1 - t0 - c * kSplitChunk;
    tc::cp_async_wait_all();
    __syncthreads();  // chunk c landed; everyone is done with chunk c - 1
    if (c + 1 < n_chunks) load_chunk(c + 1, st ^ 1);
    tc::cp_async_commit();
    const bf16* ks = ring + st * 2 * kSplitChunk * D;
    const bf16* vs = ks + kSplitChunk * D;

    // scores: a group of 8 lanes per token, each lane D / 8 features
    // (64-feature halves of a row read as 8 contiguous 16-byte pieces)
    for (int t = grp; t < kSplitChunk; t += kThreads / 8) {
      float kf[D / 8];
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        VecIO<bf16>::unpack(
            *reinterpret_cast<const uint4*>(ks + t * D + 64 * p + 8 * l8),
            kf + 8 * p);
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * D + 8 * l8;
        float dot = 0.f;
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dot = fmaf(qg[64 * p + e], kf[8 * p + e], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        if (l8 == 0)
          ps[g * kSplitChunk + t] = t < n_in ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, TPL tokens per lane
    constexpr int TPL = kSplitChunk / 32;
    static_assert(kSplitChunk % 32 == 0, "whole tokens per lane");
    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = ps + g * kSplitChunk;
      float s[TPL], mx = kNegInf, psum = 0.f;
#pragma unroll
      for (int i = 0; i < TPL; ++i) {
        s[i] = row[lane + 32 * i];
        mx = fmaxf(mx, s[i]);
      }
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
#pragma unroll
      for (int i = 0; i < TPL; ++i) {
        const float p = expf(s[i] - m_new);
        row[lane + 32 * i] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha acc + P V, two features per thread and pass
    for (int e = tid; e < G * D / 2; e += kThreads) {
      const int g = e / (D / 2), d = 2 * (e % (D / 2));
      const float* pg = ps + g * kSplitChunk;
      float2 a = *reinterpret_cast<const float2*>(acc + g * D + d);
      a.x *= a_s[g];
      a.y *= a_s[g];
#pragma unroll 8
      for (int t = 0; t < kSplitChunk; ++t) {
        const float2 vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vs + t * D + d));
        a.x = fmaf(pg[t], vv.x, a.x);
        a.y = fmaf(pg[t], vv.y, a.y);
      }
      *reinterpret_cast<float2*>(acc + g * D + d) = a;
    }
  }

  // combine the ranks' (max, sum, accumulator): rank r writes elements
  // [128 r, 128 r + 128) + 128 n_ranks i of the group's G x D outputs
  cluster.sync();
  bf16* ob = out + ((long long)b * H + (long long)hk * G) * D;
  for (int e = rank * kThreads + tid; e < G * D; e += n_ranks * kThreads) {
    const int g = e / D;
    float m_all = kNegInf;
    for (int r = 0; r < n_ranks; ++r)
      m_all = fmaxf(m_all, cluster.map_shared_rank(m_s, r)[g]);
    float l_all = 0.f, o = 0.f;
    for (int r = 0; r < n_ranks; ++r) {
      const float w = expf(cluster.map_shared_rank(m_s, r)[g] - m_all);
      l_all = fmaf(cluster.map_shared_rank(l_s, r)[g], w, l_all);
      o = fmaf(cluster.map_shared_rank(acc, r)[e], w, o);
    }
    ob[e] = from_f<bf16>(o / (l_all == 0.f ? 1.f : l_all));
  }
  cluster.sync();
}

template <int D>
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const int* tables, const int* lens, void* out, int B, int H,
                 int Hkv, int page, int pps, int num_pages, float scale,
                 cudaStream_t stream) {
  const size_t smem = split_smem_bytes<D>(H / Hkv);
  auto kern = paged_decode_split<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long most = (long long)pps * page;
  const int n_ranks =
      (int)std::min<long long>(kMaxCluster, std::max<long long>(
                                   1, (most + kMinShare - 1) / kMinShare));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ranks, Hkv, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
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
      &cfg, kern, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k_pages), static_cast<const bf16*>(v_pages),
      tables, lens, static_cast<bf16*>(out), H, Hkv, page, pps, num_pages,
      scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Layouts (contiguous): q/out
// [B, H, D], k_pages/v_pages [num_pages, page, Hkv, D] (16-byte
// aligned), tables int32 [B, pps], lens int32 [B]. Returns
// cudaGetLastError().
extern "C" int paged_decode(int dtype, int head_dim, const void* q,
                            const void* k_pages, const void* v_pages,
                            const int* tables, const int* lens, void* out,
                            int B, int H, int Hkv, int page, int pps,
                            int num_pages, float scale,
                            cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 ||
      pps <= 0 || num_pages <= 0)
    return (int)cudaErrorInvalidValue;
#define PAGED_CASE(T, D)                                                 \
  return launch<T, D>(q, k_pages, v_pages, tables, lens, out, B, H, Hkv, \
                      page, pps, num_pages, scale, stream)
  if (dtype == 0 && head_dim == 64) PAGED_CASE(float, 64);
  if (dtype == 0 && head_dim == 128) PAGED_CASE(float, 128);
#undef PAGED_CASE
#define PAGED_SPLIT(D)                                                 \
  return launch_split<D>(q, k_pages, v_pages, tables, lens, out, B, H, \
                         Hkv, page, pps, num_pages, scale, stream)
  if (dtype == 1 && head_dim == 64) PAGED_SPLIT(64);
  if (dtype == 1 && head_dim == 128) PAGED_SPLIT(128);
#undef PAGED_SPLIT
  return (int)cudaErrorInvalidValue;
}

// The 16-bit (bf16 or f16) decode walk split over a thread-block cluster,
// shared by paged_decode.cu (pages from a block-table row) and
// ragged_decode.cu (pages from ragged meta entries), with the small
// helpers both sources' FMA kernels use (f32, and q and pages of
// different dtypes).
//
// `paged_decode_split`: one launch in which each (sequence, KV head) walk
// is split over a thread-block cluster of up to kMaxCluster CTAs. At the
// serving shape one block per (sequence, KV head) is about one block per
// SM, so the longest sequence walked its keys in series while the SMs of
// short ones idled. The walk is a run of n keys that the page source
// names (its begin() gives n, its key() each key's row in the pool);
// cluster rank r takes the r-th contiguous share of it (shares of
// ceil(n / cluster) keys rounded up to 16; a rank whose share is empty
// still joins the syncs). The cluster's size comes from the most keys a
// walk can have, which the host knows without a sync (pps * page for a
// block table, G * page for a meta); the shares come from the lengths,
// in the kernel. Each rank walks its share in 32-key chunks: K and V
// stay 16-bit in shared memory, copied with 16-byte cp.async into a
// 2-stage ring, so the next chunk's copies are in flight while the
// current one is used; a score is a dot product split over 8 lanes and
// reduced with shuffles; the softmax runs one warp per query head, a
// lane per key; the f32 accumulator rescales in shared memory. After
// `cluster.sync()` the ranks combine the cluster's (max, sum,
// accumulator) through distributed shared memory, each rank a slice of
// the output, every element over the ranks in the fixed order 0, 1,
// ...: no workspace, no second launch, and two launches agree bit for
// bit. A second `cluster.sync()` keeps every rank's shared memory alive
// until the combine has read it. Measured on an H100 80GB HBM3 at 700 W
// (tools/kernel_variants.py): clusters of 8 and 64-key chunks were
// slower than 4 and 32; a cluster of 1 is the walk unsplit (over the
// meta at q[4, 32, 128], ctx 557 / 300 / 97 / 1: 0.051 ms unsplit, 0.033
// over 2 CTAs, 0.026 over 4).
//
// A key of the walk is kept (scored), masked (loaded and scored -1e30,
// as the plain ragged version scores a key of a walked page at or past
// the context) or absent (not loaded, scored -inf: it adds nothing
// whatever the running max, where a -1e30 score adds e^0 = 1 to a sum
// whose max is still -1e30).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"

namespace dec {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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
template <class E> struct VecIO16 {  // 8 bf16 or f16 values
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = tc::unpack2<E>(w[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};
template <> struct VecIO<__nv_bfloat16> : VecIO16<__nv_bfloat16> {};
template <> struct VecIO<__half> : VecIO16<__half> {};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int kMaxCluster = 4;   // CTAs per walk, at most
constexpr int kMinShare = 64;    // keys per rank that warrant one more rank
constexpr int kSplitChunk = 32;  // keys per ring stage

enum : int { kKept = 0, kMasked = 1, kAbsent = 2 };

// CTAs per walk of at most `most` keys: one per kMinShare, at most
// kMaxCluster
inline int split_ranks(long long most) {
  return (int)std::min<long long>(
      kMaxCluster, std::max<long long>(1, (most + kMinShare - 1) / kMinShare));
}

// Page sources. begin(b, ctx) runs once in every thread of a CTA and
// returns the length of sequence b's walk; key(pos, &row) gives key pos's
// state and, unless it is absent, its row in the pool (page id * page +
// row in the page).

// a block-table row: key pos is token pos, on page tb[pos / page]; the
// context is clamped into [0, pps * page], the keys the table can name
struct TablePages {
  const int* tables;
  int pps, page, num_pages;
  const int* tb;
  __device__ int begin(int b, int ctx) {
    tb = tables + (long long)b * pps;
    return min(max(ctx, 0), pps * page);
  }
  __device__ int key(int pos, long long* row) const {
    const int pid = min(max(tb[pos / page], 0), num_pages - 1);
    *row = (long long)pid * page + pos % page;
    return kKept;
  }
};

// ragged meta entries (int32 [6, G], rows seq, page, ordinal, first, last,
// valid): the walk covers the entries from the first to the last valid
// one naming sequence b, `page` keys each, so key pos is row pos % page
// of entry lo + pos / page, token ordinal * page + pos % page. Keys of
// invalid entries and of other sequences' entries are absent. Keys at or
// past the context are masked, or absent where some key of the sequence
// lies before its context: then the plain version gives them weight
// exactly 0 (the last entry's are not walked at all). A sequence with
// context_lens <= 0 or no valid entry walks nothing: zeros.
struct MetaPages {
  const int* meta;
  int G, page, num_pages;
  int b, lo, ctx, drop_past;
  __device__ int begin(int b_, int ctx_) {
    __shared__ int s_lo, s_hi, s_kept;
    const int* seq = meta;
    const int* ord = meta + 2 * G;
    const int* valid = meta + 5 * G;
    if (threadIdx.x == 0) {
      s_lo = G;
      s_hi = -1;
      s_kept = 0;
    }
    __syncthreads();
    int l = G, h = -1, kept = 0;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      if (valid[g] != 0 && seq[g] == b_) {
        l = min(l, g);
        h = max(h, g);
        kept |= (long long)ord[g] * page < ctx_;
      }
    }
    // one shared atomic per warp
    l = __reduce_min_sync(0xffffffffu, l);
    h = __reduce_max_sync(0xffffffffu, h);
    kept = __reduce_or_sync(0xffffffffu, (unsigned)kept);
    if (threadIdx.x % 32 == 0 && h >= 0) {
      atomicMin(&s_lo, l);
      atomicMax(&s_hi, h);
      if (kept) atomicOr(&s_kept, 1);
    }
    __syncthreads();
    b = b_;
    lo = s_lo;
    ctx = ctx_;
    drop_past = s_kept;
    const int hi = s_hi;
    if (ctx <= 0 || hi < 0) return 0;
    long long tail = page;  // the last entry's keys before the context
    if (drop_past) {
      tail = (long long)ctx - (long long)ord[hi] * page;
      tail = tail < 0 ? 0 : tail > page ? page : tail;
    }
    return (int)((long long)(hi - lo) * page + tail);
  }
  __device__ int key(int pos, long long* row) const {
    const int g = lo + pos / page, i = pos % page;
    if (meta[5 * G + g] == 0 || meta[g] != b) return kAbsent;
    const long long tok = (long long)meta[2 * G + g] * page + i;
    if (tok >= ctx && drop_past) return kAbsent;
    *row = (long long)min(max(meta[G + g], 0), num_pages - 1) * page + i;
    return tok < ctx ? kKept : kMasked;
  }
};

template <int D>
size_t split_smem_bytes(int G) {
  return 2 * 2 * kSplitChunk * D * 2             // K | V ring, 2 stages
         + ((size_t)2 * G                        // running max, sum
            + 2 * (size_t)G * D                  // accumulator, query
            + (size_t)G * kSplitChunk            // scores / probabilities
            + G)                                 // rescale factor
               * sizeof(float)
         + 2 * kSplitChunk * sizeof(int);        // key states, 2 stages
}

// One cluster of CTAs per (sequence b, KV head hk): grid (cluster, Hkv, B),
// 128 threads per CTA; q/out [B, H, D], pages [num_pages, page, Hkv, D],
// all of the 16-bit element type E.
template <class E, int D, class Pages>
__global__ void __launch_bounds__(kThreads) paged_decode_split(
    const E* __restrict__ q, const E* __restrict__ k_pages,
    const E* __restrict__ v_pages, const Pages pages,
    const int* __restrict__ lens, E* __restrict__ out, int H, int Hkv,
    float scale) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int G = H / Hkv;
  E* ring = reinterpret_cast<E*>(smem_raw);  // [stage][K | V][key][D]
  float* m_s = reinterpret_cast<float*>(ring + 2 * 2 * kSplitChunk * D);
  float* l_s = m_s + G;
  float* acc = l_s + G;       // [G][D]
  float* qs = acc + G * D;    // [G][D]
  float* ps = qs + G * D;     // [G][kSplitChunk]
  float* a_s = ps + G * kSplitChunk;
  int* kst = reinterpret_cast<int*>(a_s + G);  // [stage][key] states

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.y, b = blockIdx.z;
  Pages src = pages;
  const int n = src.begin(b, lens[b]);
  const int share = ((n + n_ranks - 1) / n_ranks + 15) & ~15;
  const int t0 = min(n, rank * share), t1 = min(n, t0 + share);
  const int n_chunks = (t1 - t0 + kSplitChunk - 1) / kSplitChunk;
  const E* qb = q + ((long long)b * H + (long long)hk * G) * D;
  const long long row_stride = (long long)Hkv * D;  // between pool rows

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // the chunk's K and V rows into ring stage st, with their key states;
  // absent keys (and keys past the share) are zero-filled, never read
  constexpr int CPR = D / 8;  // 16-byte copies per row
  static_assert((kSplitChunk * CPR) % kThreads == 0, "chunk must split");
  auto load_chunk = [&](int c, int st) {
    const uint32_t ks = tc::smem_addr(ring + st * 2 * kSplitChunk * D);
    const uint32_t vs = ks + kSplitChunk * D * sizeof(E);
#pragma unroll
    for (int j = 0; j < kSplitChunk * CPR / kThreads; ++j) {
      const int i = tid + j * kThreads, t = i / CPR, cc = i % CPR;
      const int pos = t0 + c * kSplitChunk + t;
      long long row = 0;
      const int state = pos < t1 ? src.key(pos, &row) : kAbsent;
      const bool in = state != kAbsent;
      const long long off = in ? row * row_stride + (long long)hk * D + cc * 8
                               : 0;
      const uint32_t dst = (t * D + cc * 8) * sizeof(E);
      tc::cp_async16(ks + dst, k_pages + off, in ? 16 : 0);
      tc::cp_async16(vs + dst, v_pages + off, in ? 16 : 0);
      if (cc == 0) kst[st * kSplitChunk + t] = state;
    }
  };
  if (n_chunks > 0) load_chunk(0, 0);
  tc::cp_async_commit();

  const int grp = tid / 8, l8 = tid % 8;  // 16 groups of 8 lanes
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    tc::cp_async_wait_all();
    __syncthreads();  // chunk c landed; everyone is done with chunk c - 1
    if (c + 1 < n_chunks) load_chunk(c + 1, st ^ 1);
    tc::cp_async_commit();
    const E* ks = ring + st * 2 * kSplitChunk * D;
    const E* vs = ks + kSplitChunk * D;
    const int* kstate = kst + st * kSplitChunk;

    // scores: a group of 8 lanes per key, each lane D / 8 features
    // (64-feature halves of a row read as 8 contiguous 16-byte pieces)
    for (int t = grp; t < kSplitChunk; t += kThreads / 8) {
      float kf[D / 8];
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        VecIO<E>::unpack(
            *reinterpret_cast<const uint4*>(ks + t * D + 64 * p + 8 * l8),
            kf + 8 * p);
      const int state = kstate[t];
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
          ps[g * kSplitChunk + t] = state == kKept     ? dot * scale
                                    : state == kMasked ? kNegInf
                                                       : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, TPL keys per lane
    constexpr int TPL = kSplitChunk / 32;
    static_assert(kSplitChunk % 32 == 0, "whole keys per lane");
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
        const float2 vv =
            tc::unpack2<E>(*reinterpret_cast<const uint32_t*>(vs + t * D + d));
        a.x = fmaf(pg[t], vv.x, a.x);
        a.y = fmaf(pg[t], vv.y, a.y);
      }
      *reinterpret_cast<float2*>(acc + g * D + d) = a;
    }
  }

  // combine the ranks' (max, sum, accumulator): rank r writes elements
  // [128 r, 128 r + 128) + 128 n_ranks i of the group's G x D outputs
  cluster.sync();
  E* ob = out + ((long long)b * H + (long long)hk * G) * D;
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
    ob[e] = from_f<E>(o / (l_all == 0.f ? 1.f : l_all));
  }
  cluster.sync();
}

// launches paged_decode_split over B sequences in clusters of n_ranks
template <class E, int D, class Pages>
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const Pages& pages, const int* lens, void* out, int B, int H,
                 int Hkv, int n_ranks, float scale, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<D>(H / Hkv);
  auto kern = paged_decode_split<E, D, Pages>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
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
      &cfg, kern, static_cast<const E*>(q),
      static_cast<const E*>(k_pages), static_cast<const E*>(v_pages),
      pages, lens, static_cast<E*>(out), H, Hkv, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dec

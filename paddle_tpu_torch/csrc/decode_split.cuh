// The decode walk split over a thread-block cluster: one query row per
// sequence against its keys, shared by paged_decode.cu (pages from a
// block-table row), ragged_decode.cu (pages from ragged meta entries)
// and flash_fwd.cu's one-row decode route (a contiguous [B, Sk, Hkv, D]
// cache under an additive mask), with the small helpers the FMA
// kernels of paged_decode.cu and ragged_decode.cu use.
//
// Replaces: paddle_tpu/kernels/paged_attention.py `_paged_kernel` and
// `_ragged_kernel` (through paged_decode.cu and ragged_decode.cu), and
// paddle_tpu/kernels/attention.py `_fwd_kernel` at Sq = 1 (through
// flash_fwd.cu), whose one-row case the reference runs with a one-row
// block (`block_q = min(block_q, sq)`).
//
// Bound on the H100: memory. A key's K and V rows are used for ~4
// operations per byte and query head, far below the ~295 the card needs
// before compute limits it, so the walk reads each K/V row it needs once
// and serves the KV head's whole query-head group with it (GQA without
// repeated K/V).
//
// `paged_decode_split<EQ, EKV, D, Pages>`: q and the output of EQ (bf16
// or f16), the pages (or the cache) of EKV: EQ itself, or f32 (a 16-bit
// model over an f32 KV pool: f32 V needs no rounding of P, so one online
// pass gives the plain version's arithmetic up to summation order). One
// launch in which each (sequence, KV head) walk is split over a
// thread-block cluster of up to kMaxCluster CTAs. At the serving shape
// one block per (sequence, KV head) is about one block per SM, so the
// longest sequence walked its keys in series while the SMs of short ones
// idled. The walk is a run of n keys that the page source names (its
// begin() gives n, its key() each key's row in the pool); cluster rank r
// takes the r-th contiguous share of it (shares of ceil(n / cluster)
// keys rounded up to 16; a rank whose share is empty still joins the
// syncs). The cluster's size comes from the most keys a walk can have,
// which the host knows without a sync (pps * page for a block table,
// G * page for a meta, Sk for a cache), capped so that the launch's
// walks x ranks stay within kSplitSlots CTAs (about 8 an SM: past that
// the ranks only add waves); the shares come from the lengths, in the
// kernel. Each rank walks its share in chunks of Ring::kChunk keys: K
// and V stay in their own dtype in shared memory, copied with 16-byte
// cp.async into a ring of Ring::kStages stages, so the next chunks'
// copies are in flight while the current one is used; a score is a dot product split over 8 lanes (each lane
// reads 16-byte pieces, the group 128 contiguous bytes a piece) and
// reduced with shuffles; the softmax runs one warp per query head, a
// lane per key; P and the accumulator stay f32 (the accumulator
// rescales in shared memory). After `cluster.sync()` the ranks combine
// the cluster's (max, sum, accumulator) through distributed shared
// memory, each rank a slice of the output, every element over the ranks
// in the fixed order 0, 1, ...: no workspace, no second launch, and two
// launches agree bit for bit. A second `cluster.sync()` keeps every
// rank's shared memory alive until the combine has read it. Measured on
// an H100 80GB HBM3 at 700 W (tools/kernel_variants.py): clusters
// of 8 and 64-key chunks were slower than 4 and 32; a cluster of 1 is
// the walk unsplit (over the meta at q[4, 32, 128], ctx 557 / 300 / 97 /
// 1: 0.051 ms unsplit, 0.033 over 2 CTAs, 0.026 over 4).
//
// The f32-page instance: before, a 16-bit q over f32 pages ran
// paged_decode.cu's unsplit FMA kernel, one block per (KV head,
// sequence), 11.5x its bytes bound. An f32 row is twice the bytes of a
// 16-bit one, so the ring holds 16 keys a stage (8 KiB of K rows at
// head_dim 128, as the 16-bit ring's 32) in 3 stages: 50 KiB a CTA at
// head_dim 128, 4 CTAs an SM, the whole serving launch resident at once.
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_variants.py --kv
// float32; bf16 q[4, 32, 128], ctx 557 / 300 / 97 / 1 | 1024 / 1000 /
// 700 / 333): paged decode 0.0243 | 0.0445 ms (the FMA kernel 0.1088 |
// 0.1967; bytes bound 0.0094 at the first), ragged decode 0.0318 |
// 0.0511 (its two f32 passes 0.0440 | 0.0926); 32-key stages 0.0264 |
// 0.0539, 2 stages 0.0250 | 0.0456, 4 stages 0.0241 | 0.0529, clusters
// of 2 and 8 0.0337 | 0.0564 and 0.0256 | 0.0494.
//
// The dense source (`DenseKeys`) is flash_fwd's one-query-row
// route: q[B, 1, H, D] against k, v[B, Sk, Hkv, D] of q's dtype under an
// additive f32 mask broadcast through strides, kv_lens and causality
// (top-left aligned, as the plain version: the one row keeps key 0
// only); it also writes lse. Before, that shape ran the 64-row `wgmma`
// tile with one live row: one CTA per (sequence, query head) walking
// all Sk keys, the masked tail of the static cache included. Here each
// CTA first finds the window of keys from the first to the last that
// some head of its group keeps (the mask's entries above -1e30, below
// kv_lens and the causal edge); only that window is walked, so the
// static route's left padding and unwritten slots are never read. Inside
// the window every head adds its own mask entry to its score (a masked
// entry scores -1e30 and weighs 0 beside a kept key, exactly as in the
// plain version). A row whose heads keep no key walks nothing: lse is
// -1e30 exactly and the output 0 (finite, as the backward kernels and
// the tests expect); a head whose group keeps keys but it none scores
// them all -1e30: lse -1e30 + log(n) = -1e30 in f32, the output their
// mean. Its ring holds 4 KiB of K rows a stage (16 keys at head_dim 128,
// 32 at 64) in 2 stages, so at the static route's shapes the whole
// launch is resident at once. Measured on an H100 80GB HBM3 at 700 W
// (tools/kernel_variants.py --only flash_decode; bf16, the route's
// padding mask; Llama-2-7B q[8, 1, 32, 128] / 544 keys | GPT-2 XL beam
// q[16, 1, 25, 64] / 332 | greedy q[4, 1, 25, 64] / 332): 0.0198 |
// 0.0198 | 0.0140 ms, against the 64-row `wgmma` tile's 0.0393 | 0.0372
// | 0.0180 and SDPA's 0.0422 | 0.0303 | 0.0185 (bytes bounds 0.0057 |
// 0.0050 | 0.0012). Every key below kv_lens walked instead of the kept
// window: 0.0428 | 0.0238 | 0.0142; clusters of 1 / 2 / 8: 0.0311 /
// 0.0222 / 0.0198 | 0.0244 / 0.0197 / 0.0197 | 0.0232 / 0.0167 /
// 0.0135; 2 and 8 KiB stages: 0.0221 and 0.0221 | 0.0211 and 0.0206 |
// 0.0145 and 0.0147; 3 and 4 stages: 0.0201 and 0.0221 | 0.0198 and
// 0.0204 | 0.0139 and 0.0140; the launch capped at 512 or 2048 CTAs
// instead of 1024: 0.0222 or 0.0198 | 0.0244 or 0.0225 | 0.0140 or
// 0.0141. f16 times within 2 % of these.
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
#include <type_traits>

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
constexpr int kSplitSlots = 1024;  // CTAs the ranks fill at most, ~8 a SM
constexpr int kSplitChunk = 32;  // keys per ring stage, 16-bit pages
constexpr int kSplitStages = 2;  // ring stages, 16-bit pages
constexpr int kSplitChunkF32 = 16;  // keys per ring stage, f32 pages
constexpr int kSplitStagesF32 = 3;  // ring stages, f32 pages
constexpr int kDenseStageBytes = 4096;  // K bytes per ring stage, DenseKeys
constexpr int kDenseStages = 2;  // ring stages, DenseKeys
constexpr bool kDenseWindow = true;  // DenseKeys walks the kept window only

// the ring's shape for rows of D elements of EKV from the source Pages
template <class EKV, int D, class Pages> struct Ring {
  static constexpr bool kF32 = std::is_same<EKV, float>::value;
  static constexpr int kChunk =
      Pages::kDense ? kDenseStageBytes / (D * (int)sizeof(EKV))
      : kF32        ? kSplitChunkF32
                    : kSplitChunk;
  static constexpr int kStages = Pages::kDense ? kDenseStages
                                 : kF32        ? kSplitStagesF32
                                               : kSplitStages;
};

enum : int { kKept = 0, kMasked = 1, kAbsent = 2 };

// the (q, pages) element types the split walk takes: a 16-bit q over
// pages of its own type or of f32 (the other pairs, and f32 q, keep the
// FMA kernels; kernels/paged_attention.py `decode_route` mirrors this)
template <class TQ, class TKV>
constexpr bool splits() {
  return !std::is_same<TQ, float>::value &&
         (std::is_same<TQ, TKV>::value || std::is_same<TKV, float>::value);
}

// CTAs per walk, for `walks` walks of at most `most` keys: one per
// kMinShare keys, at most kMaxCluster, and no more than keep the launch
// within kSplitSlots CTAs (past that the ranks only add waves)
inline int split_ranks(long long most, long long walks) {
  const long long by_keys = std::min<long long>(
      kMaxCluster, std::max<long long>(1, (most + kMinShare - 1) / kMinShare));
  return (int)std::max<long long>(
      1, std::min<long long>(by_keys,
                             kSplitSlots / std::max<long long>(1, walks)));
}

// two consecutive values of a row in shared memory, as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <class E>
__device__ __forceinline__ float2 load2(const E* p) {
  return tc::unpack2<E>(*reinterpret_cast<const uint32_t*>(p));
}

// Page sources. begin(b, hk, G, lens) runs once in every thread of a CTA
// and returns the length of sequence b's walk for KV head hk (G query
// heads a KV head); key(pos, &row) gives key pos's state and, unless it
// is absent, its row in the pool (page id * page + row in the page).
// kDense: the source is a contiguous cache under an additive mask: it
// adds a per-(head, key) bias to the scores, staged into shared memory
// chunk by chunk beside K and V (stage_bias, bias), takes each query
// head's log-sum-exp (put_lse) and sizes its ring by bytes (Ring).

// a block-table row: key pos is token pos, on page tb[pos / page]; the
// context is clamped into [0, pps * page], the keys the table can name
struct TablePages {
  static constexpr bool kDense = false;
  const int* tables;
  int pps, page, num_pages;
  const int* tb;
  __device__ int begin(int b, int, int, const int* lens) {
    tb = tables + (long long)b * pps;
    return min(max(lens[b], 0), pps * page);
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
  static constexpr bool kDense = false;
  const int* meta;
  int G, page, num_pages;
  int b, lo, ctx, drop_past;
  __device__ int begin(int b_, int, int, const int* lens) {
    __shared__ int s_lo, s_hi, s_kept;
    const int ctx_ = lens[b_];
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

// a contiguous cache k, v [B, Sk, Hkv, D] for flash_fwd's one query row:
// the additive f32 mask mask[b msb + h msh + t msk] (null for none; msh
// 0 when one row serves every head), kv_lens (lens, null for none) and
// causality (key 0 only). The walk is the window from the first to the
// last key below kv_lens and the causal edge whose mask entry some head
// of the group keeps (above -1e30); key pos is cache row b Sk + lo + pos.
struct DenseKeys {
  static constexpr bool kDense = true;
  const float* mask;
  long long msb, msh, msk;
  int Sk, causal;
  float* lse;    // [B, H] (Sq = 1)
  int H;
  const float* mb;  // set by begin: the group's first mask row
  long long row0;   // b Sk + lo
  int G, lo;
  __device__ int begin(int b, int hk, int G_, const int* lens) {
    __shared__ int s_lo, s_hi;
    G = G_;
    int kend = Sk;
    if (lens != nullptr) kend = min(kend, max(lens[b], 0));
    if (causal) kend = min(kend, 1);
    lo = 0;
    int n = kend;
    mb = mask == nullptr ? nullptr
                         : mask + b * msb + (long long)hk * G * msh;
    if (mb != nullptr && kDenseWindow) {
      if (threadIdx.x == 0) {
        s_lo = kend;
        s_hi = -1;
      }
      __syncthreads();
      int l = kend, h = -1;
      const int rows = msh != 0 ? G : 1;
      for (int r = 0; r < rows; ++r)
        for (int t = threadIdx.x; t < kend; t += blockDim.x)
          if (!(mb[r * msh + t * msk] <= kNegInf)) {  // NaN is kept
            l = min(l, t);
            h = max(h, t);
          }
      l = __reduce_min_sync(0xffffffffu, l);
      h = __reduce_max_sync(0xffffffffu, h);
      if (threadIdx.x % 32 == 0 && h >= 0) {
        atomicMin(&s_lo, l);
        atomicMax(&s_hi, h);
      }
      __syncthreads();
      lo = s_hi >= 0 ? s_lo : 0;
      n = s_hi >= 0 ? s_hi - s_lo + 1 : 0;
    }
    row0 = (long long)b * Sk + lo;
    return n;
  }
  __device__ int key(int pos, long long* row) const {
    *row = row0 + pos;
    return kKept;
  }
  // the mask entries of keys [p0, p0 + CH) (those at or past p1 are
  // absent: zero-filled) into rows x CH floats at dst, one row per head
  // (one for a head-broadcast mask)
  template <int CH>
  __device__ void stage_bias(uint32_t dst, int p0, int p1, int tid) const {
    if (mask == nullptr) return;
    const int rows = msh != 0 ? G : 1;
    for (int i = tid; i < rows * CH; i += kThreads) {
      const int pos = p0 + i % CH;
      const bool in = pos < p1;
      tc::cp_async4(dst + 4 * i,
                    in ? mb + (i / CH) * msh + (lo + pos) * msk : mb,
                    in ? 4 : 0);
    }
  }
  template <int CH>
  __device__ float bias(const float* st, int g, int t) const {
    return mask == nullptr ? 0.f : st[(msh != 0 ? g : 0) * CH + t];
  }
  __device__ void put_lse(int b, int h, float v) const {
    lse[(long long)b * H + h] = v;
  }
};

template <class EKV, int D, class Pages>
size_t split_smem_bytes(int G) {
  constexpr int CH = Ring<EKV, D, Pages>::kChunk;
  constexpr int NS = Ring<EKV, D, Pages>::kStages;
  return (size_t)NS * 2 * CH * D * sizeof(EKV)  // K | V ring
         + ((size_t)2 * G                        // running max, sum
            + 2 * (size_t)G * D                  // accumulator, query
            + (size_t)G * CH                     // scores / probabilities
            + G)                                 // rescale factor
               * sizeof(float)
         + (size_t)NS * CH * sizeof(int)         // key states
         + (Pages::kDense ? (size_t)NS * G * CH * sizeof(float) : 0);
}

// One cluster of CTAs per (sequence b, KV head hk): grid (cluster, Hkv, B),
// 128 threads per CTA; q/out [B, H, D] of EQ (16-bit), pages [num_pages,
// page, Hkv, D] (or the cache [B, Sk, Hkv, D]) of EKV (EQ or f32).
template <class EQ, class EKV, int D, class Pages>
__global__ void __launch_bounds__(kThreads) paged_decode_split(
    const EQ* __restrict__ q, const EKV* __restrict__ k_pages,
    const EKV* __restrict__ v_pages, const Pages pages,
    const int* __restrict__ lens, EQ* __restrict__ out, int H, int Hkv,
    float scale) {
  constexpr int CH = Ring<EKV, D, Pages>::kChunk;
  constexpr int NS = Ring<EKV, D, Pages>::kStages;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int G = H / Hkv;
  EKV* ring = reinterpret_cast<EKV*>(smem_raw);  // [stage][K | V][key][D]
  float* m_s = reinterpret_cast<float*>(ring + NS * 2 * CH * D);
  float* l_s = m_s + G;
  float* acc = l_s + G;       // [G][D]
  float* qs = acc + G * D;    // [G][D]
  float* ps = qs + G * D;     // [G][CH]
  float* a_s = ps + G * CH;
  int* kst = reinterpret_cast<int*>(a_s + G);  // [stage][key] states
  float* bias = reinterpret_cast<float*>(kst + NS * CH);  // [stage][G][CH]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.y, b = blockIdx.z;
  Pages src = pages;
  const int n = src.begin(b, hk, G, lens);
  const int share = ((n + n_ranks - 1) / n_ranks + 15) & ~15;
  const int t0 = min(n, rank * share), t1 = min(n, t0 + share);
  const int n_chunks = (t1 - t0 + CH - 1) / CH;
  const EQ* qb = q + ((long long)b * H + (long long)hk * G) * D;
  const long long row_stride = (long long)Hkv * D;  // between pool rows

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // the chunk's K and V rows into ring stage st, with their key states
  // (and the source's bias); absent keys (and keys past the share) are
  // zero-filled, never read
  constexpr int VN = VecIO<EKV>::N;  // elements per 16-byte copy
  constexpr int CPR = D / VN;        // 16-byte copies per row
  static_assert((CH * CPR) % kThreads == 0, "chunk must split");
  auto load_chunk = [&](int c, int st) {
    const uint32_t ks = tc::smem_addr(ring + st * 2 * CH * D);
    const uint32_t vs = ks + CH * D * sizeof(EKV);
#pragma unroll
    for (int j = 0; j < CH * CPR / kThreads; ++j) {
      const int i = tid + j * kThreads, t = i / CPR, cc = i % CPR;
      const int pos = t0 + c * CH + t;
      long long row = 0;
      const int state = pos < t1 ? src.key(pos, &row) : kAbsent;
      const bool in = state != kAbsent;
      const long long off =
          in ? row * row_stride + (long long)hk * D + cc * VN : 0;
      const uint32_t dst = (t * D + cc * VN) * sizeof(EKV);
      tc::cp_async16(ks + dst, k_pages + off, in ? 16 : 0);
      tc::cp_async16(vs + dst, v_pages + off, in ? 16 : 0);
      if (cc == 0) kst[st * CH + t] = state;
    }
    if constexpr (Pages::kDense)
      src.template stage_bias<CH>(tc::smem_addr(bias + st * G * CH),
                                  t0 + c * CH, t1, tid);
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    tc::cp_async_commit();
  }

  const int grp = tid / 8, l8 = tid % 8;  // 16 groups of 8 lanes
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % NS;
    tc::cp_async_wait<NS - 2>();
    __syncthreads();  // chunk c landed; everyone is done with chunk c - 1
    if (c + NS - 1 < n_chunks) load_chunk(c + NS - 1, (c + NS - 1) % NS);
    tc::cp_async_commit();
    const EKV* ks = ring + st * 2 * CH * D;
    const EKV* vs = ks + CH * D;
    const int* kstate = kst + st * CH;
    const float* bst = bias + st * G * CH;

    // scores: a group of 8 lanes per key, each lane D / 8 features in
    // pieces of VN; feature j of lane l8 is (j / VN) 8 VN + l8 VN + j % VN,
    // so a piece of the group is 128 contiguous bytes of the row
    constexpr int NP = D / (8 * VN);  // pieces per lane
    for (int t = grp; t < CH; t += kThreads / 8) {
      float kf[D / 8];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        VecIO<EKV>::unpack(*reinterpret_cast<const uint4*>(
                               ks + t * D + 8 * VN * p + VN * l8),
                           kf + VN * p);
      const int state = kstate[t];
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * D + VN * l8;
        float dot = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int e = 0; e < VN; ++e)
            dot = fmaf(qg[8 * VN * p + e], kf[VN * p + e], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        if (l8 == 0) {
          float s = state == kKept     ? dot * scale
                    : state == kMasked ? kNegInf
                                       : -INFINITY;
          if constexpr (Pages::kDense)
            if (state == kKept) s += src.template bias<CH>(bst, g, t);
          ps[g * CH + t] = s;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, TPL keys per lane
    constexpr int TPL = (CH + 31) / 32;
    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = ps + g * CH;
      float s[TPL], mx = kNegInf, psum = 0.f;
#pragma unroll
      for (int i = 0; i < TPL; ++i) {
        s[i] = lane + 32 * i < CH ? row[lane + 32 * i] : -INFINITY;
        mx = fmaxf(mx, s[i]);
      }
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
#pragma unroll
      for (int i = 0; i < TPL; ++i) {
        const float p = expf(s[i] - m_new);
        if (lane + 32 * i < CH) row[lane + 32 * i] = p;
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
      const float* pg = ps + g * CH;
      float2 a = *reinterpret_cast<const float2*>(acc + g * D + d);
      a.x *= a_s[g];
      a.y *= a_s[g];
#pragma unroll 8
      for (int t = 0; t < CH; ++t) {
        const float2 vv = load2(vs + t * D + d);
        a.x = fmaf(pg[t], vv.x, a.x);
        a.y = fmaf(pg[t], vv.y, a.y);
      }
      *reinterpret_cast<float2*>(acc + g * D + d) = a;
    }
  }

  // combine the ranks' (max, sum, accumulator): rank r writes elements
  // [128 r, 128 r + 128) + 128 n_ranks i of the group's G x D outputs
  cluster.sync();
  EQ* ob = out + ((long long)b * H + (long long)hk * G) * D;
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
    const float safe = l_all == 0.f ? 1.f : l_all;
    ob[e] = from_f<EQ>(o / safe);
    if constexpr (Pages::kDense)
      if (e % D == 0) src.put_lse(b, hk * G + g, m_all + logf(safe));
  }
  cluster.sync();
}

// launches paged_decode_split over B sequences in clusters of n_ranks
template <class EQ, class EKV, int D, class Pages>
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const Pages& pages, const int* lens, void* out, int B, int H,
                 int Hkv, int n_ranks, float scale, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<EKV, D, Pages>(H / Hkv);
  auto kern = paged_decode_split<EQ, EKV, D, Pages>;
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
      &cfg, kern, static_cast<const EQ*>(q),
      static_cast<const EKV*>(k_pages), static_cast<const EKV*>(v_pages),
      pages, lens, static_cast<EQ*>(out), H, Hkv, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dec

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
// bf16 (dtype 1): `dec::paged_decode_split` (decode_split.cuh), one
// launch in which each (sequence, KV head) walk is split over a
// thread-block cluster of up to 4 CTAs and combined through distributed
// shared memory, with the block-table row as its page source
// (`dec::TablePages`); ragged_decode.cu runs the same walk over meta
// entries.
//
// f16 (dtype 2): the same split walk with f16 pages and queries.
//
// q and pages of different dtypes (q in the model's dtype, pages in the
// KV pool's `kv_dtype`; each of f32 / bf16 / f16): `paged_decode_kernel`
// below with q read as TQ and pages as TKV, converted to f32 on load and
// the output in TQ. The plain version rounds the NORMALISED P to V's dtype
// before P.V; an online softmax could only round exp(s - m) of the
// running max, a different rounding (2^-9 relative in bf16) that moves a
// greedy token where two logits are close. So with 16-bit pages the walk
// runs twice: the first pass takes each query head's max and sum, the
// second recomputes the scores and accumulates P = TKV(exp(s - m) / l)
// times V, the plain version's arithmetic (f32 pages need no rounding:
// one online pass).
//
// f32 (dtype 0): `paged_decode_kernel`, one block per (KV head,
// sequence) walking the sequence in 64-token chunks with an online
// softmax; each chunk is fetched with 16-byte loads, all of a thread's
// loads issued before any is used; query, probabilities and the f32
// accumulator live in shared memory.

#include "decode_split.cuh"

namespace {

using namespace dec;

constexpr int kChunk = 64;

template <int D>
size_t smem_floats(int G) {
  return (size_t)G * D            // query group
         + kChunk * (D + 1)       // K chunk
         + kChunk * D             // V chunk
         + (size_t)G * kChunk     // scores / probabilities
         + (size_t)G * D          // accumulator
         + 3 * (size_t)G;         // running max, sum, rescale factor
}

// TQ is q's and the output's element type, TKV the pages' (with 16-bit
// pages two passes: P normalised, then rounded to TKV before P.V)
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lens, TQ* __restrict__ out, int H, int Hkv,
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
  const TQ* qb = q + ((long long)b * H + (long long)hk * G) * D;
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

  constexpr int VN = VecIO<TKV>::N;  // elements per 16-byte vector
  constexpr int VPR = D / VN;         // vectors per token row
  static_assert((kChunk * VPR) % kThreads == 0, "chunk must split evenly");
  constexpr bool NORM = !std::is_same<TKV, float>::value;
  // pass 0 (NORM only): the rows' max and sum; pass 1: P.V
  for (int pass = NORM ? 0 : 1; pass < 2; ++pass)
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
      VecIO<TKV>::unpack(ku, kf);
      VecIO<TKV>::unpack(vu, vf);
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
      if (NORM && pass == 1) {  // the final max and sum: normalised P
        const float m = m_s[g], inv = 1.f / l_s[g];
        row[lane] = to_f(from_f<TKV>(expf(s0 - m) * inv));
        row[lane + 32] = to_f(from_f<TKV>(expf(s1 - m) * inv));
        if (lane == 0) a_s[g] = 1.f;
        continue;
      }
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
    if (pass == 0) continue;

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

  TQ* ob = out + ((long long)b * H + (long long)hk * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    const float l = NORM ? 1.f : l_s[e / D];
    ob[e] = from_f<TQ>(acc[e] / (l == 0.f ? 1.f : l));
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* lens, void* out, int B, int H,
           int Hkv, int page, int pps, int num_pages, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>(H / Hkv) * sizeof(float);
  auto kern = paged_decode_kernel<TQ, TKV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), tables, lens, static_cast<TQ*>(out), H,
      Hkv, page, pps, num_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: q's and the output's element type, kv_dtype: the pages' (0 =
// float32, 1 = bfloat16, 2 = float16). One 16-bit dtype runs the
// cluster-split walk; float32, or q and pages of different dtypes, the
// FMA kernel. Layouts (contiguous): q/out [B, H, D], k_pages/v_pages
// [num_pages, page, Hkv, D] (16-byte aligned), tables int32 [B, pps], lens
// int32 [B]. Returns cudaGetLastError().
extern "C" int paged_decode(int dtype, int kv_dtype, int head_dim,
                            const void* q, const void* k_pages,
                            const void* v_pages, const int* tables,
                            const int* lens, void* out, int B, int H,
                            int Hkv, int page, int pps, int num_pages,
                            float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 ||
      pps <= 0 || num_pages <= 0 || (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  return tc::with_dtype(dtype, [&](auto tq) {
    return tc::with_dtype(kv_dtype, [&](auto tkv) {
      using TQ = typename decltype(tq)::type;
      using TKV = typename decltype(tkv)::type;
      if constexpr (std::is_same<TQ, TKV>::value &&
                    !std::is_same<TQ, float>::value) {
        auto run = head_dim == 64 ? dec::launch_split<TQ, 64, dec::TablePages>
                                  : dec::launch_split<TQ, 128, dec::TablePages>;
        return run(q, k_pages, v_pages,
                   dec::TablePages{tables, pps, page, num_pages, nullptr},
                   lens, out, B, H, Hkv,
                   dec::split_ranks((long long)pps * page), scale, stream);
      } else {
        auto run = head_dim == 64 ? launch<TQ, TKV, 64> : launch<TQ, TKV, 128>;
        return run(q, k_pages, v_pages, tables, lens, out, B, H, Hkv, page,
                   pps, num_pages, scale, stream);
      }
    });
  });
}

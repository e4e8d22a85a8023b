// Ragged paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/paged_attention.py `_ragged_kernel`
// (launched by `paged_attention_ragged`), the decode attention of every
// serving step with `use_ragged`: the grid runs over a work list of
// (sequence, page) entries instead of a [B, pages_per_seq] table.
//
// Computes, for sequence b and query head h (KV head h / (H / Hkv)):
//   out[b, h] = sum over the valid entries g of b and rows i of page[g]
//               with key t = ordinal[g] * page + i < ctx[b] of
//               softmax_t(q[b, h] . K[t] * scale) V[t]
// with `meta` the int32 [6, G] rows seq, page, ordinal, first, last,
// valid (RaggedMetaBuilder / build_ragged_meta). Entries with valid == 0
// contribute nothing; rows with context_lens == 0 (or no valid entry)
// are zero. Scores, softmax and every sum are f32; the final sum divides
// by 1 where it is 0, as the Pallas kernel's safe divisor.
//
// Bound on the H100: memory. Each cached K/V byte is used for ~2
// operations per query head of its group, far below the ~295 operations
// per byte the card needs before compute limits it, so every valid K/V
// row is read once. The TPU kernel carries its online softmax across the
// sequential grid; blocks on Hopper run in no order.
//
// bf16 (dtype 1): `dec::paged_decode_split` (decode_split.cuh), the walk
// that paged_decode.cu runs over a block-table row, here over the meta
// entries (`dec::MetaPages`): one launch, one cluster of up to 4 CTAs per
// (sequence, KV head) serving the KV head's whole query-head group (GQA
// without repeated K/V). Each cluster finds its sequence's valid entries
// in the meta (first to last) and its ranks walk contiguous shares of
// their keys, skipping the entries of other sequences and padding
// entries that lie between; the ranks' partial softmax states combine
// through distributed shared memory in a fixed order. No workspace, and
// two launches agree bit for bit. The cluster is sized from G * page,
// which the host knows without a sync. Before this, bf16 ran the two f32
// passes below: one block per (entry, KV head), 8192 blocks at the
// serving shape of which 6208 only returned, then a combine launch
// (0.0443 ms against the split walk's 0.0210 on paged_decode's inputs,
// H100 80GB HBM3, 700 W).
//
// f16 (dtype 2): the same split walk with f16 pages and queries.
//
// q and pages of different dtypes (q in the model's dtype, pages in the
// KV pool's `kv_dtype`): the two passes below with q read as TQ and pages
// as TKV, converted to f32 on load, P kept in f32 (as the plain version
// keeps it) and the output in TQ; they take the f32 workspace.
//
// f32 (dtype 0): flash-decoding over the work list in two passes:
//   1. one block per (entry g, KV head): the page's keys against the
//      KV head's whole query-head group, the partial max m, sum l and
//      unnormalised P.V of each head into an f32 workspace
//      ws = [m: G*H | l: G*H | acc: G*H*D];
//   2. one block per (sequence, head): finds the sequence's entries
//      (first to last) in the meta and combines them,
//      out = sum_g e^{m_g - M} acc_g / sum_g e^{m_g - M} l_g.
// Each page is fetched with 16-byte loads, all issued before use.

#include "decode_split.cuh"

namespace {

using namespace dec;

template <int D>
size_t partial_smem_floats(int Gq, int page) {
  return (size_t)Gq * D            // query group
         + (size_t)page * (D + 1)  // K page
         + (size_t)page * D        // V page
         + (size_t)Gq * page;      // scores / probabilities
}

// pass 1: one block per (entry g, KV head hk); q of TQ, pages of TKV
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) ragged_partial_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ meta,
    const int* __restrict__ lens, float* __restrict__ ws, int B, int H,
    int Hkv, int page, int num_pages, int G, float scale) {
  const int g = blockIdx.x, hk = blockIdx.y;
  const int* seq_a = meta;
  const int* page_a = meta + G;
  const int* ord_a = meta + 2 * G;
  const int* valid_a = meta + 5 * G;
  const int b = seq_a[g];
  if (valid_a[g] == 0 || b < 0 || b >= B) return;

  extern __shared__ float smem[];
  const int Gq = H / Hkv;
  float* qs = smem;
  float* ks = qs + Gq * D;
  float* vs = ks + page * (D + 1);
  float* ps = vs + page * D;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pid = min(max(page_a[g], 0), num_pages - 1);
  const int ctx = lens[b];
  const int tok0 = ord_a[g] * page;
  const TQ* qb = q + ((long long)b * H + (long long)hk * Gq) * D;
  const long long row_stride = (long long)Hkv * D;  // between tokens
  const long long base = (long long)pid * page * row_stride + (long long)hk * D;

  for (int i = tid; i < Gq * D; i += kThreads) qs[i] = to_f(qb[i]);
  constexpr int VN = VecIO<TKV>::N;  // elements per 16-byte vector
  constexpr int VPR = D / VN;         // vectors per token row
  for (int i = tid; i < page * VPR; i += kThreads) {
    const int t = i / VPR, c = (i % VPR) * VN;
    const long long off = base + t * row_stride + c;
    const uint4 ku = *reinterpret_cast<const uint4*>(k_pages + off);
    const uint4 vu = *reinterpret_cast<const uint4*>(v_pages + off);
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

  for (int pr = tid; pr < Gq * page; pr += kThreads) {
    const int gg = pr / page, t = pr % page;
    const float* qg = qs + gg * D;
    const float* kt = ks + t * (D + 1);
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(qg[d], kt[d], s);
    ps[pr] = (tok0 + t < ctx) ? s * scale : kNegInf;
  }
  __syncthreads();

  float* ws_m = ws;
  float* ws_l = ws + (long long)G * H;
  float* ws_acc = ws + 2LL * G * H;
  for (int gg = warp; gg < Gq; gg += kThreads / 32) {
    float* row = ps + gg * page;
    float mx = kNegInf;
    for (int t = lane; t < page; t += 32) mx = fmaxf(mx, row[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < page; t += 32) {
      const float p = expf(row[t] - mx);
      row[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const long long o = (long long)g * H + hk * Gq + gg;
      ws_m[o] = mx;
      ws_l[o] = sum;
    }
  }
  __syncthreads();

  for (int e = tid; e < Gq * D; e += kThreads) {
    const int gg = e / D, d = e % D;
    const float* pg = ps + gg * page;
    float a = 0.f;
    for (int t = 0; t < page; ++t) a = fmaf(pg[t], vs[t * D + d], a);
    ws_acc[((long long)g * H + hk * Gq + gg) * D + d] = a;
  }
}

// pass 2: one block per (head h, sequence b)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) ragged_combine_kernel(
    const int* __restrict__ meta, const int* __restrict__ lens,
    const float* __restrict__ ws, T* __restrict__ out, int H, int G) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int* seq_a = meta;
  const int* valid_a = meta + 5 * G;
  __shared__ int s_lo, s_hi;
  if (tid == 0) {
    s_lo = G;
    s_hi = -1;
  }
  __syncthreads();
  // the sequence's entries: first to last valid entry naming it
  for (int g = tid; g < G; g += kThreads) {
    if (valid_a[g] != 0 && seq_a[g] == b) {
      atomicMin(&s_lo, g);
      atomicMax(&s_hi, g);
    }
  }
  __syncthreads();
  const int lo = s_lo, hi = s_hi;
  T* o = out + ((long long)b * H + h) * D;
  if (lens[b] <= 0 || hi < 0) {
    for (int d = tid; d < D; d += kThreads) o[d] = from_f<T>(0.f);
    return;
  }
  const float* ws_m = ws;
  const float* ws_l = ws + (long long)G * H;
  const float* ws_acc = ws + 2LL * G * H;
  float mx = kNegInf;
  for (int g = lo; g <= hi; ++g)
    if (valid_a[g] != 0 && seq_a[g] == b)
      mx = fmaxf(mx, ws_m[(long long)g * H + h]);
  for (int d = tid; d < D; d += kThreads) {
    float l = 0.f, a = 0.f;
    for (int g = lo; g <= hi; ++g) {
      if (valid_a[g] == 0 || seq_a[g] != b) continue;
      const long long e = (long long)g * H + h;
      const float w = expf(ws_m[e] - mx);
      l = fmaf(ws_l[e], w, l);
      a = fmaf(ws_acc[e * D + d], w, a);
    }
    o[d] = from_f<T>(a / (l == 0.f ? 1.f : l));
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* meta, const int* lens, void* out, float* ws, int B,
           int H, int Hkv, int page, int num_pages, int G, float scale,
           cudaStream_t stream) {
  const size_t smem = partial_smem_floats<D>(H / Hkv, page) * sizeof(float);
  auto partial = ragged_partial_kernel<TQ, TKV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  partial<<<dim3(G, Hkv), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), meta, lens, ws, B, H, Hkv, page,
      num_pages, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ragged_combine_kernel<TQ, D><<<dim3(H, B), kThreads, 0, stream>>>(
      meta, lens, ws, static_cast<TQ*>(out), H, G);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: q's and the output's element type, kv_dtype: the pages' (0 =
// float32, 1 = bfloat16, 2 = float16). One 16-bit dtype runs the
// cluster-split walk (ws may be null); float32, or q and pages of
// different dtypes, the two passes, which need ws. Layouts (contiguous):
// q/out [B, H, D], k_pages/v_pages [num_pages, page, Hkv, D] (16-byte
// aligned), meta int32 [6, G], lens int32 [B] (post-write context
// lengths), ws f32 [G * H * (D + 2)] scratch. Returns cudaGetLastError().
extern "C" int ragged_decode(int dtype, int kv_dtype, int head_dim,
                             const void* q, const void* k_pages,
                             const void* v_pages, const int* meta,
                             const int* lens, void* out, float* ws, int B,
                             int H, int Hkv, int page, int num_pages, int G,
                             float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 ||
      num_pages <= 0 || G <= 0 || (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  return tc::with_dtype(dtype, [&](auto tq) {
    return tc::with_dtype(kv_dtype, [&](auto tkv) {
      using TQ = typename decltype(tq)::type;
      using TKV = typename decltype(tkv)::type;
      if constexpr (std::is_same<TQ, TKV>::value &&
                    !std::is_same<TQ, float>::value) {
        auto run = head_dim == 64 ? dec::launch_split<TQ, 64, dec::MetaPages>
                                  : dec::launch_split<TQ, 128, dec::MetaPages>;
        return run(q, k_pages, v_pages,
                   dec::MetaPages{meta, G, page, num_pages, 0, 0, 0, 0}, lens,
                   out, B, H, Hkv, dec::split_ranks((long long)G * page),
                   scale, stream);
      } else {
        if (ws == nullptr) return (int)cudaErrorInvalidValue;
        auto run = head_dim == 64 ? launch<TQ, TKV, 64> : launch<TQ, TKV, 128>;
        return run(q, k_pages, v_pages, meta, lens, out, ws, B, H, Hkv, page,
                   num_pages, G, scale, stream);
      }
    });
  });
}

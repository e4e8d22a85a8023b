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
// Scores and P stay f32, as in the Pallas kernel; the XLA reference
// (`_paged_attention_varq_xla`) rounds P to the value dtype before P.V,
// so in bf16 the two differ by that rounding (within the bf16
// tolerance). Masked scores are exactly -1e30, never -inf, so the
// online-softmax rescale exp(m_prev - m_new) stays finite.
//
// Bound on the H100: a prefill chunk of Qs rows reuses each K/V byte for
// ~Qs operations per head, so long chunks are compute-bound (tensor-core
// peak) and decode rows memory-bound. This first version runs on the FMA
// units like flash_fwd.cu: one block of 256 threads per (64-row query
// tile, KV head, slot), where the tile's rows are up to 64 / G span rows
// times the G query heads of the KV head (GQA reads each K/V tile once
// for the whole group). The block walks the slot's pages in order in
// 64-key tiles, up to min(kv_lens, last query position of the tile + 1)
// (the causal skip), with the online softmax per row in shared memory
// and a 4 x D/16 slice of the f32 accumulator per thread in registers.
// Tiles past q_lens only write zeros. K/V rows are fetched with 16-byte
// loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
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
constexpr size_t smem_floats() {
  return kBQ * (D + 1)      // Q tile
         + kBK * (D + 1)    // K tile
         + kBK * D          // V tile
         + kBQ * (kBK + 1)  // scores / probabilities
         + 3 * kBQ;         // running max, sum, rescale factor
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_varq_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ meta, const int* __restrict__ kv_lens,
    const int* __restrict__ q_lens, T* __restrict__ out, int Qb, int H,
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
  const int TQ = kBQ / Gq;          // span rows per tile
  const int nrows = TQ * Gq;        // tile rows in use
  const int i0 = blockIdx.x * TQ;
  const int ql = min(max(q_lens[b], 0), Qb);
  const int kl = kv_lens[b];
  const long long q_stride = (long long)H * D;     // between span rows
  const long long kv_stride = (long long)Hkv * D;  // between key rows
  const T* qb = q + (long long)b * Qb * q_stride + (long long)hk * Gq * D;
  T* ob = out + (long long)b * Qb * q_stride + (long long)hk * Gq * D;

  if (i0 >= ql || kl <= 0) {
    // padding span rows only: zeros
    for (int e = tid; e < nrows * D; e += kThreads) {
      const int r = e / D, c = e % D, i = i0 + r / Gq;
      if (i < Qb) ob[i * q_stride + (r % Gq) * D + c] = from_f<T>(0.f);
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
  const int i_last = min(i0 + TQ, ql) - 1;
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

  constexpr int VN = VecIO<T>::N;
  constexpr int VPR = D / VN;
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
      VecIO<T>::unpack(ku, kf);
      VecIO<T>::unpack(vu, vf);
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
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float* row = Ss + r * (kBK + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
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
    const float l = l_s[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* orow = ob + si * q_stride + (r % Gq) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      orow[tx + 16 * j] = from_f<T>(si < ql ? acc[i][j] * inv : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* meta, const int* kv_lens,
           const int* q_lens, void* out, int B, int Qb, int H, int Hkv,
           int page, int pps, int num_pages, int G, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = paged_varq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = kBQ / (H / Hkv);
  dim3 grid((Qb + rows - 1) / rows, Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, meta, kv_lens, q_lens,
      static_cast<T*>(out), Qb, H, Hkv, page, pps, num_pages, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Layouts (contiguous): q/out
// [B, Qb, H, D], k_pages/v_pages [num_pages, page, Hkv, D] (16-byte
// aligned), kv_lens/q_lens int32 [B], and exactly one page source:
// tables int32 [B, pps] (meta null) or meta int32 [6, G] (tables null).
// H / Hkv <= 64. Returns cudaGetLastError().
extern "C" int paged_varq(int dtype, int head_dim, const void* q,
                          const void* k_pages, const void* v_pages,
                          const int* tables, const int* meta,
                          const int* kv_lens, const int* q_lens, void* out,
                          int B, int Qb, int H, int Hkv, int page, int pps,
                          int num_pages, int G, float scale,
                          cudaStream_t stream) {
  if (B <= 0 || Qb <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kBQ || page <= 0 || num_pages <= 0 ||
      (tables == nullptr) == (meta == nullptr) ||
      (tables != nullptr && pps <= 0) || (meta != nullptr && G <= 0))
    return (int)cudaErrorInvalidValue;
#define VARQ_CASE(T, D)                                                      \
  return launch<T, D>(q, k_pages, v_pages, tables, meta, kv_lens, q_lens,   \
                      out, B, Qb, H, Hkv, page, pps, num_pages, G, scale,   \
                      stream)
  if (dtype == 0 && head_dim == 64) VARQ_CASE(float, 64);
  if (dtype == 0 && head_dim == 128) VARQ_CASE(float, 128);
  if (dtype == 1 && head_dim == 64) VARQ_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) VARQ_CASE(__nv_bfloat16, 128);
#undef VARQ_CASE
  return (int)cudaErrorInvalidValue;
}

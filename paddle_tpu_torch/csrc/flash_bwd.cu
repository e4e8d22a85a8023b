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
// bf16 and f16 (dtypes 1, 2): tensor-core kernels, `tc::flash_bwd_dkdv_wgmma`
// and `tc::flash_bwd_dq_wgmma`, templates on the element type. Every
// product is a `wgmma.mma_async` (sm_90a) m64nNk16 with f32 accumulators;
// none uses mma.sync. They follow FlashAttention-3's register arrangement:
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
// f16 (dtype 2): the same kernels on f16 operands (m64nNk16 f32.f16.f16),
// as the reference computes in f32 from f16 inputs. f16 has 3 more bits
// than bf16 but 2^-24 .. 65504 for range, and under loss scaling (dO
// multiplied by up to 2^15 or more) dS = P * (dP - delta) passes 65504
// while the f32 sums, dK and dQ stay finite: a hi + lo split of such a dS
// overflows to inf, and the scaler would skip steps that the reference
// takes. So the dS operand of each row (a key row of dS^T for dK, a query
// row of dS for dQ) is scaled by an exact power of two 2^-e chosen from
// the tile's largest |dS| of that row (a quad shuffle), which puts it in
// [2^14, 2^15); e only grows along the walk, and when it does the row of
// the f32 accumulator is scaled down by the same exact power of two, so
// the accumulator always holds the sum in units of 2^e and the store
// multiplies by 2^e (`rescale_rows`). P (in [0, 1]) and P * D (at most 1
// / (1 - p)) need no scaling. Every product stays a hi + lo pair: 22
// significant bits; a lo part below f16's smallest normal (6.1e-5) keeps
// an absolute error of at most 2^-25 in the scaled units, which is 2^-39
// of the row's largest |dS| (or, for P, 2^-25 absolute). The rescale adds
// a row maximum and D/2 multiplies per thread and tile to dK and dQ; the
// bf16 instance compiles without it (bf16 has f32's range).
//
// f32 (dtype 0): the same kernels, a third instance (E = float), with
// every f32 operand entering the products as bf16 parts (TF32 is off in
// the port; wgmma.cuh's note gives the split): hi = bf16(x), mid = bf16(x
// - hi), lo = bf16(x - hi - mid). S^T = K Q^T (dK/dV) and S = Q K^T (dQ)
// take two parts of each operand, hi.hi + hi.mid + mid.hi; dP^T = V dO^T
// and dP = dO V^T take three, the six terms whose part indices sum to
// less than 3 (hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi). dV adds the
// third product of P * D (hi + lo, split in registers as above), its hi
// part on dO's mid tile; dK and dQ add dS's hi part on Q's (K's) mid and
// lo tiles and its lo part on the mid tile, read transposed, which wgmma
// allows for 16-bit operands only (TF32 parts would need transposed
// copies). That is 17 m64 products per tile pair in dK/dV (16-bit: 6) and
// 14 in dQ (4). Why three parts in dP, dK and dQ: on a row whose keys the
// mask all drops, P = exp(s - lse) = 1 on every key (as in the plain
// version), so dS is as large as dP and the 2^-16 error of two-part
// products passes into dK and dQ undamped; with two parts everywhere
// test_torch_flash_bwd.py's `no_valid_key` case sat at 0.8-1.0 of the f32
// card tolerance, and failed once the forward's out / lse came from
// flash_fwd.cu's f32 instance (dK 1.47e-4 against atol 1e-4; 6.5e-5 with
// three parts). The resident operands (K, V in dK/dV; Q, dO in dQ) arrive
// once as f32 rows staged by cp.async in the space the streamed tiles use
// later and are split into their part tiles while the first streamed
// tile's copies are in flight.
// The streamed operands share one f32 staging tile: the first of a tile's
// pair (Q; K) is copied in during the previous tile's products and split
// before the S product, the second (dO; V) is copied in while S and P
// are formed and split before the dP product, after which the next
// tile's first copies start. Shared memory: K (dK/dV) or Q (dQ) in two
// part tiles, the other three operands in three, one f32 staging tile:
// 108,544 bytes (dK/dV) and 107,520 (dQ) at D = 64, two CTAs an SM as in
// 16 bits; 215,040 and 214,016 at D = 128, one. Registers (ptxas -v, CUDA
// 12.8): dK/dV D = 64 254 (241 with dropout), D = 128 255 with 28 bytes
// spilled (none with dropout); dQ D = 64 194 (228), D = 128 254.
// Precision: against the plain f32 backward the outputs differ by about
// 5e-6 of their size (largest absolute error 2.6e-5 at BERT-base's q[16,
// 128, 12, 64] with its key mask, 1.0e-4 at q[2, 2048, 32, 128] causal,
// in dV, whose products keep two parts; 6.5e-5 on the `no_valid_key`
// case), within the f32 card tolerance (atol = rtol = 1e-4) with a
// margin `chip_smoke.py` logs per case. Bound at BERT-base's fine-tune
// shape: the bytes (0.0113 ms dK/dV, 0.0095 dQ on an H100; the
// operations, at the 16-bit peak, take under half that). Measured on an
// H100 80GB HBM3 at 700 W (tools/flash_bwd_variants.py --parent, one
// process) at that shape: dK/dV 0.0384 ms, dQ 0.0339 (with two parts in
// every product 0.0366 / 0.0285; the FMA kernels before those 0.0940 /
// 0.0803; f32 SDPA's backward, the pair together, 0.1256); with
// dropout 0.1 0.0411 / 0.0358. The grid is 384 CTAs of two query (or
// key) tiles each, 1.45 waves of two CTAs an SM, and each CTA's chain of
// copy, split and products sets the time, 3.4x / 3.6x the bytes. Two
// parts, measured so before: without the streamed tiles' split
// (a diagnostic variant, wrong by design) 0.0331 / 0.0278; one CTA of
// two warpgroups per (batch, head) walking all 128 keys lost (dK/dV
// 0.0398); one bf16 part of P and dS saved 7 % and failed the tolerance
// (errors 3e-3).
//
// No atomics in any dtype: every output tile has one owner CTA that
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

// the call's dropout: dscale = 1 / (1 - p), 0 when off; its two seeds
// live in a device int32 slot (`seeds`), read by the kernels (a captured
// graph takes the words written there before each replay). The row's
// second hash absorbs seed1, xq = fmix32(fmix32((b*H + h) ^ seed0) ^ q) ^
// seed1, so an element's hash is fmix32(xq ^ k)
struct Dropout {
  uint32_t thresh;
  float dscale;
};

// one seed word from the slot, loaded where it is used: a volatile load
// is never hoisted out of the query-tile loop into a register live across
// the products
__device__ __forceinline__ uint32_t load_seed(const int* p) {
  uint32_t x;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(x) : "l"(p));
  return x;
}

}  // namespace

// ------------------------------------------------------------------------
// The tensor-core kernels (wgmma, sm_90a) of every dtype. See the note at
// the top.

namespace tc {

constexpr int kBM = 64;       // query rows per tile
constexpr int kStages = 2;    // depth of the cp.async ring
// warpgroups of 64 keys in a dK/dV CTA: 1 runs two independent CTAs per
// SM, whose elementwise phases overlap each other's products
constexpr int kDkdvWG = 1;

// the A fragment of one k-step (four E pairs in registers), typed by its
// element type so that the products below take E from their operand
template <class E>
struct AFrag {
  uint32_t r[4];
};
template <class E, int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N], const AFrag<E>& a,
                                            uint64_t b) {
  wgmma_rs_tb<E>(d, a.r, b);
}
template <class E>
__device__ __forceinline__ void fence_regs(AFrag<E> (&f)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i].r[j])::"memory");
}

// A fragments of the 4 k-steps of a 64 x 64 f32 accumulator (its columns
// become wgmma's K; the m64nNk16 accumulator layout already is the A
// layout), each value x split in two E, hi = E(x) and lo = E(x - hi): hi +
// lo keeps 16 significant bits of x where one bf16 keeps 8 (22 where one
// f16 keeps 11)
template <class E>
__device__ __forceinline__ void to_a_frags(const float (&x)[32],
                                           AFrag<E> (&hi)[4],
                                           AFrag<E> (&lo)[4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = x[8 * s + 2 * i], b = x[8 * s + 2 * i + 1];
      hi[s].r[i] = pack2<E>(a, b);
      const float2 hf = unpack2<E>(hi[s].r[i]);
      lo[s].r[i] = pack2<E>(a - hf.x, b - hf.y);
    }
}

// f16 only: 2^e as an f32 for e in [-126, 127], 0 below
__device__ __forceinline__ float pow2i(int e) {
  return e < -126 ? 0.f : __int_as_float((e + 127) << 23);
}

// f16 only: keeps the A operand dS of the thread's accumulator rows rr = 0,
// 1 (16 values each, 4 threads a row) inside f16's range. The row's
// exponent ex[rr] only grows: when the tile's largest |dS| of a row needs
// a larger one, the row of `acc` (the dK or dQ sum, in units of 2^ex) is
// scaled down by the exact power of two; then the row's dS is multiplied
// by 2^-ex, which puts its largest value of the tile below 2^15. The
// caller multiplies the sum by 2^ex at the end. Exponents stay in
// [-100, 114], so every factor is a power of two that f32 holds (a factor
// below 2^-126 drops a sum smaller than 2^-126 of the new row maximum).
template <int N>
__device__ __forceinline__ void rescale_rows(float (&ds)[32], float (&acc)[N],
                                             int (&ex)[2]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m = fmaxf(m, fmaxf(fabsf(ds[4 * j + 2 * rr]),
                         fabsf(ds[4 * j + 2 * rr + 1])));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    // m in [2^x, 2^(x + 1)): times 2^(14 - x) it lies in [2^14, 2^15)
    const int x = ((__float_as_int(m) >> 23) & 0xff) - 127;
    const int e = max(ex[rr], max(x - 14, -100));
    const float down = pow2i(ex[rr] - e), inv = pow2i(-e);
    ex[rr] = e;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      acc[4 * j + 2 * rr] *= down;
      acc[4 * j + 2 * rr + 1] *= down;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ds[4 * j + 2 * rr] *= inv;
      ds[4 * j + 2 * rr + 1] *= inv;
    }
  }
}

// two adjacent outputs: one pair of E, or two f32 values
template <class E>
__device__ __forceinline__ void store2(E* p, float a, float b) {
  if constexpr (std::is_same<E, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(p) = pack2<E>(a, b);
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

// Shared memory of the dK/dV kernel, byte offsets from its 1024-aligned
// base. 16-bit: the K and V tiles, a kStages ring of Q and dO tiles, and
// kStages slots of a query tile's lse | delta rows. f32: K as bf16 hi and
// lo tiles, V, Q and dO as hi, mid and lo tiles (each tile followed by
// its next part; one Q and one dO tile, split anew from f32 rows for each
// query tile), one f32 staging tile that takes Q's rows and then dO's,
// and the same row slots
template <class E, int D>
struct DkdvSmem {
  static constexpr bool F32 = std::is_same<E, float>::value;
  static constexpr int BN = 64 * kDkdvWG;
  static constexpr uint32_t KV = BN * D * 2;   // one 16-bit K or V tile
  static constexpr uint32_t QT = kBM * D * 2;  // one 16-bit Q or dO tile
  static constexpr uint32_t F = kBM * D * 4;   // one f32 Q or dO tile
  static constexpr uint32_t NQ = F32 ? 3 : kStages;  // tiles per Q or dO
  static constexpr uint32_t V = F32 ? 2 * KV : KV;
  static constexpr uint32_t Q = V + (F32 ? 3 : 1) * KV;
  static constexpr uint32_t O = Q + NQ * QT;
  static constexpr uint32_t STAGE = O + NQ * QT;
  static constexpr uint32_t ROWS = STAGE + (F32 ? F : 0);
  static constexpr uint32_t BYTES = ROWS + kStages * 2 * kBM * 4;
};

// dK/dV: one CTA of kDkdvWG warpgroups per (batch x KV head, 64 kDkdvWG
// keys); warpgroup w owns keys [k0 + 64 w, k0 + 64 w + 64). K and V stay
// in shared memory; Q, dO, lse and delta of the (query head, query tile)
// pairs stream through a 2-stage cp.async ring (f32: one f32 staging
// tile, Q's rows split into Q's parts as their tile starts, then dO's
// rows copied in while S^T is formed and split before dP^T; the next
// tile's Q rows start once dO's split has read the tile).
template <class E, int D, bool DROP>
__global__ void __launch_bounds__(128 * kDkdvWG, 2 / kDkdvWG)
    flash_bwd_dkdv_wgmma(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const E* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, const int* __restrict__ kv_lens,
    E* __restrict__ dk, E* __restrict__ dv, int Sq, int Sk, int H,
    int Hkv, long long msb, long long msh, long long msq, long long msk,
    float scale, int causal, const int* __restrict__ seeds, Dropout drop) {
  using L = DkdvSmem<E, D>;
  constexpr bool F32 = L::F32, F16 = std::is_same<E, f16>::value;
  // the products' operand type: bf16 hi + lo parts of f32 operands, else E
  using PE = typename std::conditional<F32, bf16, E>::type;
  constexpr int BN = L::BN, NT = 128 * kDkdvWG;
  constexpr uint32_t KV_BYTES = L::KV, Q_BYTES = L::QT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + L::V;
  const uint32_t sQ = base + L::Q, sO = base + L::O;
  const uint32_t sF = base + L::STAGE;    // f32: Q's, then dO's rows
  const uint32_t sRows = base + L::ROWS;  // [stage][lse | delta]
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

  // f32: the rows of query tile `it` of Q (with its lse | delta rows) or,
  // with `dO`, of dO into the staging tile
  auto stage_q = [&](int it, auto src) {
    const int h = hk * group + it / per_g;
    const int q0 = (i_first + it % per_g) * kBM;
    stage_rows<kBM, D, NT>(
        sF, src + ((long long)b * Sq * H + h) * D,
        [&](int r) -> long long {
          return q0 + r < Sq ? (long long)(q0 + r) * q_stride : -1;
        },
        tid);
  };
  auto load_stage = [&](int it, int st) {
    const int h = hk * group + it / per_g;
    const int q0 = (i_first + it % per_g) * kBM;
    const long long q_off = ((long long)b * Sq * H + h) * D;
    if constexpr (F32) {
      stage_q(it, q);
    } else {
      load_tile<kBM, D, NT>(sQ + st * Q_BYTES, q + q_off, q_stride, q0, Sq,
                            tid);
      load_tile<kBM, D, NT>(sO + st * Q_BYTES, dout + q_off, q_stride, q0,
                            Sq, tid);
    }
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
  int ex[2] = {-100, -100};  // f16: dk_acc's row exponents (rescale_rows)

  if (n_it > 0) {
    if constexpr (F32) {
      // K's and V's f32 rows staged where the Q and dO tiles go (into the
      // staging tile too when 128 keys leave no room beside it), with
      // query tile 0's Q rows in flight beside them where they fit; then
      // split into the resident part tiles
      constexpr uint32_t KF = BN * D * 4;  // one f32 K or V tile
      constexpr bool BESIDE = 2 * KF <= L::STAGE - L::Q;
      static_assert(2 * KF <= L::ROWS - L::Q, "K's and V's rows fit");
      const uint32_t kf = sQ, vf = sQ + KF;
      stage_rows<BN, D, NT>(
          kf, k + kv_off,
          [&](int r) -> long long {
            return k0 + r < Sk ? (long long)(k0 + r) * kv_stride : -1;
          },
          tid, vf, v + kv_off);
      cp_async_commit();
      if (BESIDE) load_stage(0, 0);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      split_tile<BN, D, NT>(sK, sK + KV_BYTES, kf, tid);
      split_tile<BN, D, NT, 3>(sV, sV + KV_BYTES, vf, tid,
                               sV + 2 * KV_BYTES);
      __syncthreads();  // the staged rows are read
      if (!BESIDE) load_stage(0, 0);
    } else {
      load_tile<BN, D, NT>(sK, k + kv_off, kv_stride, k0, Sk, tid);
      load_tile<BN, D, NT>(sV, v + kv_off, kv_stride, k0, Sk, tid);
      load_stage(0, 0);
    }
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
                      // (f32: with the previous tile's part tiles)
    if constexpr (!F32) {
      if (it + 1 < n_it) load_stage(it + 1, st ^ 1);
      cp_async_commit();
    }

    const int h = hk * group + it / per_g;
    const int q0 = (i_first + it % per_g) * kBM;
    // uniform over the warpgroup: none of its keys is kept by this tile
    const bool skip = kw >= kend || (causal && q0 + kBM - 1 < kw);
    if (!F32 && skip) continue;
    const bool full = q0 + kBM <= Sq && kw + 64 <= kend &&
                      (!causal || q0 >= kw + 63);
    const uint32_t qs = F32 ? sQ : sQ + st * Q_BYTES;
    const uint32_t os = F32 ? sO : sO + st * Q_BYTES;
    const float* lse_t = rows + st * 2 * kBM;
    const float* dl_t = lse_t + kBM;
    const float* mb = mask ? mask + b * msb + h * msh : nullptr;

    // S^T = K Q^T and dP^T = V dO^T (keys x queries), A and B from shared.
    // Over f32 operands, with N parts of each (hi, mid, lo), the terms
    // whose part indices sum to less than N: S^T in two (K_h Q_h^T + K_h
    // Q_m^T + K_m Q_h^T), dP^T in three (V_h dO_h^T + V_h dO_m^T + V_m
    // dO_h^T + V_h dO_l^T + V_m dO_m^T + V_l dO_h^T)
    float s[32], dp[32];
    auto product = [&](float (&d)[32], uint32_t a, uint32_t bt, auto parts) {
      constexpr int N = decltype(parts)::value;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int j = 0; i + j < N; ++j)
            wgmma_ss<PE>(d, kmajor_desc<BN>(a + i * KV_BYTES, 64 * wg, kk),
                         kmajor_desc<kBM>(bt + j * Q_BYTES, 0, kk),
                         kk + i + j);
      wgmma_commit();
    };
    auto probs = [&]() {
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
                                                qi * msq + ki * msk, scale,
                                                l, -l * kLog2e, sl2);
            }
          }
      };
      if (mb)
        to_probs(std::true_type{}, std::false_type{});
      else if (full)
        to_probs(std::false_type{}, std::true_type{});
      else
        to_probs(std::false_type{}, std::false_type{});
    };
    using Two = std::integral_constant<int, 2>;
    using Three = std::integral_constant<int, 3>;
    if constexpr (F32) {
      // Q's f32 rows into its part tiles before the S^T product; dO's rows
      // copied into the staging tile while S^T and P are formed, then split
      // before the dP^T product, after which the next tile's Q rows start
      // (every warpgroup splits and waits, also one that skips)
      split_tile<kBM, D, NT, 3>(qs, qs + Q_BYTES, sF, tid, qs + 2 * Q_BYTES);
      fence_async_smem();
      __syncthreads();  // Q's parts stored; the staging tile is read
      stage_q(it, dout);
      cp_async_commit();
      if (!skip) {
        wgmma_fence();
        product(s, sK, qs, Two{});
        wgmma_wait<0>();
        fence_regs(s);
        probs();
      }
      cp_async_wait_all();
      __syncthreads();  // dO's rows landed
      split_tile<kBM, D, NT, 3>(os, os + Q_BYTES, sF, tid, os + 2 * Q_BYTES);
      fence_async_smem();
      __syncthreads();  // dO's parts stored; the staging tile is read
      if (it + 1 < n_it) load_stage(it + 1, st ^ 1);
      cp_async_commit();
      if (skip) continue;
      wgmma_fence();
      product(dp, sV, os, Three{});
    } else {
      wgmma_fence();
      product(s, sK, qs, std::integral_constant<int, 1>{});
      product(dp, sV, os, std::integral_constant<int, 1>{});
      wgmma_wait<1>();
      fence_regs(s);
      probs();
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t row_key = 0u, seed1 = 0u;
    if constexpr (DROP) {
      row_key = fmix32((uint32_t)(b * H + h) ^ load_seed(seeds));
      seed1 = load_seed(seeds + 1);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + qc + e;
        const float dl = dl_t[c];
        uint32_t xq = 0u;
        if constexpr (DROP)
          xq = fmix32(row_key ^ (uint32_t)(q0 + c)) ^ seed1;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr + e;
          // a masked entry (P = 0) gives exactly 0, also where dP or delta
          // is not finite, as the plain version's select does
          if constexpr (DROP) {
            const uint32_t ki = (uint32_t)(kw + kr + 8 * rr);
            const float dm =
                fmix32(xq ^ ki) >= drop.thresh ? drop.dscale : 0.f;
            dp[i] = s[i] != 0.f ? s[i] * (dp[i] * dm - dl) : 0.f;
            s[i] *= dm;
          } else {
            dp[i] = s[i] != 0.f ? s[i] * (dp[i] - dl) : 0.f;
          }
        }
      }
    // dV += (P D)^T dO and dK += dS^T Q, each as the hi and the lo part:
    // A from registers, B the query-major dO / Q tiles read transposed
    // (f16: dS^T rescaled per key row first; P * D is at most 1 / (1 - p));
    // over f32 operands also P's hi part on dO's mid tile, and dS's hi part
    // on Q's mid and lo tiles and its lo part on Q's mid tile
    if constexpr (F16) rescale_rows(dp, dk_acc, ex);
    AFrag<PE> ph[4], pl[4], sh[4], sl[4];
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
      if constexpr (F32) {
        wgmma_rs_tb(dv_acc, ph[kk], mnmajor_desc<kBM>(os + Q_BYTES, kk));
        wgmma_rs_tb(dk_acc, sh[kk], mnmajor_desc<kBM>(qs + Q_BYTES, kk));
        wgmma_rs_tb(dk_acc, sl[kk], mnmajor_desc<kBM>(qs + Q_BYTES, kk));
        wgmma_rs_tb(dk_acc, sh[kk], mnmajor_desc<kBM>(qs + 2 * Q_BYTES, kk));
      }
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

  E* dkb = dk + kv_off;
  E* dvb = dv + kv_off;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int ki = kw + kr + 8 * rr;
    if (ki >= Sk) continue;
    const float f = F16 ? scale * pow2i(ex[rr]) : scale;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long o = ki * kv_stride + 8 * j + qc;
      const int i = 4 * j + 2 * rr;
      store2(dkb + o, dk_acc[i] * f, dk_acc[i + 1] * f);
      store2(dvb + o, dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// Shared memory of the dQ kernel, byte offsets from its 1024-aligned base.
// 16-bit: the Q and dO tiles and a kStages ring of K | V tile pairs. f32:
// Q as bf16 hi and lo tiles, dO, K and V as hi, mid and lo tiles (each
// tile followed by its next part; one K and one V tile, split anew from
// f32 rows for each key tile) and one f32 staging tile that takes K's
// rows and then V's
template <class E, int D>
struct DqSmem {
  static constexpr bool F32 = std::is_same<E, float>::value;
  static constexpr uint32_t T = 64 * D * 2;  // one 16-bit 64-row tile
  static constexpr uint32_t F = 64 * D * 4;  // one f32 64-row tile
  static constexpr uint32_t O = F32 ? 2 * T : T;
  static constexpr uint32_t KV = O + (F32 ? 3 : 1) * T;
  static constexpr uint32_t V = KV + 3 * T;  // f32: V's part tiles
  static constexpr uint32_t STAGE = V + 3 * T;
  static constexpr uint32_t BYTES = F32 ? STAGE + F : KV + kStages * 2 * T;
};

// dQ: one CTA of one warpgroup per (batch x query head, 64-row query
// tile), launched longest causal row first. Q and dO stay in shared
// memory; K and V tiles of 64 keys stream through a 2-stage ring (f32:
// one f32 staging tile, K's rows split into K's parts as their tile
// starts, then V's rows copied in while S is formed and split before dP;
// the next tile's K rows start once V's split has read the tile).
template <class E, int D, bool DROP>
__global__ void __launch_bounds__(128, 2) flash_bwd_dq_wgmma(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const E* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, const int* __restrict__ kv_lens,
    E* __restrict__ dq, int Sq, int Sk, int H, int Hkv, long long msb,
    long long msh, long long msq, long long msk, float scale, int causal,
    const int* __restrict__ seeds, Dropout drop) {
  using L = DqSmem<E, D>;
  constexpr bool F32 = L::F32, F16 = std::is_same<E, f16>::value;
  // the products' operand type: bf16 hi + lo parts of f32 operands, else E
  using PE = typename std::conditional<F32, bf16, E>::type;
  constexpr int BN = 64, NT = 128;
  constexpr uint32_t T_BYTES = L::T;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sO = sQ + L::O;
  const uint32_t sKV = sQ + L::KV;     // 16-bit: [stage][K | V]
  const uint32_t sF = sQ + L::STAGE;   // f32: K's, then V's rows

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
  uint32_t xq[2], row_key = 0u, seed1 = 0u;
  if constexpr (DROP) {
    row_key = fmix32((uint32_t)blockIdx.x ^ (uint32_t)seeds[0]);  // b*H + h
    seed1 = (uint32_t)seeds[1];
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + qr + 8 * rr;
    l[rr] = qi < Sq ? lb[qi] : 0.f;
    dl[rr] = qi < Sq ? db[qi] : 0.f;
    nl2[rr] = -l[rr] * kLog2e;
    xq[rr] = DROP ? fmix32(row_key ^ (uint32_t)qi) ^ seed1 : 0u;
  }

  // f32: the rows of key tile `it` of K, or with `v`, of V into the
  // staging tile
  auto stage_kv = [&](int it, auto src) {
    stage_rows<BN, D, NT>(
        sF, src + kv_off,
        [&](int r) -> long long {
          const int key = it * BN + r;
          return key < Sk ? (long long)key * kv_stride : -1;
        },
        tid);
  };
  auto load_stage = [&](int it, int st) {
    if constexpr (F32) {
      stage_kv(it, k);
    } else {
      const uint32_t kv = sKV + st * 2 * T_BYTES;
      load_tile<BN, D, NT>(kv, k + kv_off, kv_stride, it * BN, Sk, tid);
      load_tile<BN, D, NT>(kv + T_BYTES, v + kv_off, kv_stride, it * BN, Sk,
                           tid);
    }
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int ex[2] = {-100, -100};  // f16: acc's row exponents (rescale_rows)

  if (n_it > 0) {
    if constexpr (F32) {
      // Q's and dO's f32 rows staged where the K and V tiles go, key tile
      // 0's K rows in flight beside them; then split into the resident
      // part tiles
      static_assert(L::V - L::KV >= L::F, "Q's rows fit in K's tiles");
      stage_rows<kBM, D, NT>(
          sKV, q + q_off,
          [&](int r) -> long long {
            return q0 + r < Sq ? (long long)(q0 + r) * q_stride : -1;
          },
          tid, sQ + L::V, dout + q_off);
      cp_async_commit();
      load_stage(0, 0);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      split_tile<kBM, D, NT>(sQ, sQ + T_BYTES, sKV, tid);
      split_tile<kBM, D, NT, 3>(sO, sO + T_BYTES, sQ + L::V, tid,
                                sO + 2 * T_BYTES);
      __syncthreads();  // the staged rows are read
    } else {
      load_tile<kBM, D, NT>(sQ, q + q_off, q_stride, q0, Sq, tid);
      load_tile<kBM, D, NT>(sO, dout + q_off, q_stride, q0, Sq, tid);
      load_stage(0, 0);
    }
  }
  cp_async_commit();

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages, k0 = it * BN;
    cp_async_wait_all();
    __syncthreads();  // stage st landed; everyone is done with stage st ^ 1
                      // (f32: with the previous tile's part tiles)
    if constexpr (!F32) {
      if (it + 1 < n_it) load_stage(it + 1, st ^ 1);
      cp_async_commit();
    }
    const uint32_t ks = F32 ? sKV : sKV + st * 2 * T_BYTES;
    const uint32_t vs = F32 ? sQ + L::V : ks + T_BYTES;
    const bool full = q0 + kBM <= Sq && k0 + BN <= kend &&
                      (!causal || k0 + BN - 1 <= q0);

    // S = Q K^T and dP = dO V^T (queries x keys), A and B from shared.
    // Over f32 operands, with N parts of each (hi, mid, lo), the terms
    // whose part indices sum to less than N: S in two (Q_h K_h^T + Q_h
    // K_m^T + Q_m K_h^T), dP in three (dO_h V_h^T + dO_h V_m^T + dO_m V_h^T
    // + dO_h V_l^T + dO_m V_m^T + dO_l V_h^T)
    float s[32], dp[32];
    auto product = [&](float (&d)[32], uint32_t a, uint32_t bt, auto parts) {
      constexpr int N = decltype(parts)::value;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int j = 0; i + j < N; ++j)
            wgmma_ss<PE>(d, kmajor_desc<kBM>(a + i * T_BYTES, 0, kk),
                         kmajor_desc<BN>(bt + j * T_BYTES, 0, kk),
                         kk + i + j);
      wgmma_commit();
    };
    auto probs = [&]() {
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
    };
    if constexpr (F32) {
      // K's f32 rows into its part tiles before the S product; V's rows
      // copied into the staging tile while S and P are formed, then split
      // before the dP product, after which the next tile's K rows start
      split_tile<BN, D, NT, 3>(ks, ks + T_BYTES, sF, tid, ks + 2 * T_BYTES);
      fence_async_smem();
      __syncthreads();  // K's parts stored; the staging tile is read
      stage_kv(it, v);
      cp_async_commit();
      wgmma_fence();
      product(s, sQ, ks, std::integral_constant<int, 2>{});
      wgmma_wait<0>();
      fence_regs(s);
      probs();
      cp_async_wait_all();
      __syncthreads();  // V's rows landed
      split_tile<BN, D, NT, 3>(vs, vs + T_BYTES, sF, tid, vs + 2 * T_BYTES);
      fence_async_smem();
      __syncthreads();  // V's parts stored; the staging tile is read
      if (it + 1 < n_it) load_stage(it + 1, st ^ 1);
      cp_async_commit();
      wgmma_fence();
      product(dp, sO, vs, std::integral_constant<int, 3>{});
    } else {
      wgmma_fence();
      product(s, sQ, ks, std::integral_constant<int, 1>{});
      product(dp, sO, vs, std::integral_constant<int, 1>{});
      wgmma_wait<1>();
      fence_regs(s);
      probs();
    }
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
            dm = fmix32(xq[rr] ^ (uint32_t)(k0 + 8 * j + kc + e)) >=
                         drop.thresh
                     ? drop.dscale
                     : 0.f;
          dp[i] = s[i] != 0.f ? s[i] * (dp[i] * dm - dl[rr]) : 0.f;
        }
    // dQ += dS K as the hi and the lo part: A from registers, B the
    // key-major K tile read transposed (f16: dS rescaled per query row);
    // over f32 operands also the hi part on K's mid and lo tiles and the
    // lo part on K's mid tile
    if constexpr (F16) rescale_rows(dp, acc, ex);
    AFrag<PE> sh[4], sl[4];
    to_a_frags(dp, sh, sl);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tb(acc, sh[kk], mnmajor_desc<BN>(ks, kk));
      wgmma_rs_tb(acc, sl[kk], mnmajor_desc<BN>(ks, kk));
      if constexpr (F32) {
        wgmma_rs_tb(acc, sh[kk], mnmajor_desc<BN>(ks + T_BYTES, kk));
        wgmma_rs_tb(acc, sl[kk], mnmajor_desc<BN>(ks + T_BYTES, kk));
        wgmma_rs_tb(acc, sh[kk], mnmajor_desc<BN>(ks + 2 * T_BYTES, kk));
      }
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
    const float f = F16 ? scale * pow2i(ex[rr]) : scale;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * rr;
      store2(dq + q_off + qi * q_stride + 8 * j + kc, acc[i] * f,
             acc[i + 1] * f);
    }
  }
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
  const int* seeds;
  Dropout drop;
};

// the kernels copy 16 bytes at a time and store pairs
bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }
bool aligned16(const Args& a) {
  return aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.dout);
}

template <class E, int D>
int launch_dkdv_wgmma(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  constexpr int smem = 1024 + (int)tc::DkdvSmem<E, D>::BYTES;
  auto kern = a.drop.dscale > 0.f ? tc::flash_bwd_dkdv_wgmma<E, D, true>
                                  : tc::flash_bwd_dkdv_wgmma<E, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // key tile 0 has the most query tiles under causality: blockIdx.y = 0
  // (every batch x KV head of it) is scheduled first
  constexpr int BN = 64 * tc::kDkdvWG;
  dim3 grid(a.B * a.Hkv, (a.Sk + BN - 1) / BN);
  kern<<<grid, 128 * tc::kDkdvWG, smem, stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k),
      static_cast<const E*>(a.v), static_cast<const E*>(a.dout),
      a.lse, a.delta, a.mask, a.kv_lens, static_cast<E*>(dk),
      static_cast<E*>(dv), a.Sq, a.Sk, a.H, a.Hkv, a.msb, a.msh, a.msq,
      a.msk, a.scale, a.causal, a.seeds, a.drop);
  return (int)cudaGetLastError();
}

template <class E, int D>
int launch_dq_wgmma(const Args& a, void* dq, cudaStream_t stream) {
  constexpr int smem = 1024 + (int)tc::DqSmem<E, D>::BYTES;
  auto kern = a.drop.dscale > 0.f ? tc::flash_bwd_dq_wgmma<E, D, true>
                                  : tc::flash_bwd_dq_wgmma<E, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.H, (a.Sq + tc::kBM - 1) / tc::kBM);
  kern<<<grid, 128, smem, stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k),
      static_cast<const E*>(a.v), static_cast<const E*>(a.dout),
      a.lse, a.delta, a.mask, a.kv_lens, static_cast<E*>(dq), a.Sq,
      a.Sk, a.H, a.Hkv, a.msb, a.msh, a.msq, a.msk, a.scale, a.causal,
      a.seeds, a.drop);
  return (int)cudaGetLastError();
}

bool valid(const Args& a) {
  return a.H > 0 && a.Hkv > 0 && a.H % a.Hkv == 0 && a.B > 0 && a.Sq > 0 &&
         a.Sk > 0 && !(a.drop.dscale > 0.f && !a.seeds);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Layouts: q/dout/dq [B, Sq, H, D],
// k/v/dk/dv [B, Sk, Hkv, D], lse/delta [B, H, Sq] f32, all contiguous;
// mask (may be null) is f32 addressed as mask[b*msb + h*msh + q*msq +
// k*msk]; kv_lens (may be null) is int32 [B]. Dropout: dscale = 1 / (1 - p)
// as f32, 0 for none; thresh = min(2^32 - 1, round(p * 2^32)); seeds (may
// be null without dropout) the forward call's device int32 [2] slot of
// its two seeds. Every dtype and head_dim (64,
// 128) runs the tensor-core kernels, f32 on bf16 hi + lo parts
// (kernels/attention.py `bwd_route` mirrors this); the tensors must be
// 16-byte aligned. Each returns cudaGetLastError().
#define FLASH_BWD_ARGS                                                        \
  int dtype, int head_dim, const void *q, const void *k, const void *v,       \
      const void *dout, const float *lse, const float *delta,                 \
      const float *mask, const int *kv_lens
#define FLASH_BWD_DIMS                                                        \
  int B, int Sq, int Sk, int H, int Hkv, long long msb, long long msh,        \
      long long msq, long long msk, float scale, int causal,                  \
      const int *seeds, unsigned thresh, float dscale, cudaStream_t stream
#define FLASH_BWD_PACK                                                        \
  const Args a{q,     k,     v,      dout,   lse, delta, mask,              \
               kv_lens, B,   Sq,     Sk,     H,   Hkv,   msb,               \
               msh,   msq,   msk,    scale,  causal, seeds,                  \
               Dropout{(uint32_t)thresh, dscale}};                           \
  if (!valid(a)) return (int)cudaErrorInvalidValue

extern "C" int flash_bwd_dkdv(FLASH_BWD_ARGS, void* dk, void* dv,
                              FLASH_BWD_DIMS) {
  FLASH_BWD_PACK;
  if (head_dim != 64 && head_dim != 128) return (int)cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorMisalignedAddress;
  return tc::with_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return head_dim == 64 ? launch_dkdv_wgmma<E, 64>(a, dk, dv, stream)
                          : launch_dkdv_wgmma<E, 128>(a, dk, dv, stream);
  });
}

extern "C" int flash_bwd_dq(FLASH_BWD_ARGS, void* dq, FLASH_BWD_DIMS) {
  FLASH_BWD_PACK;
  if (head_dim != 64 && head_dim != 128) return (int)cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(dq)) return (int)cudaErrorMisalignedAddress;
  return tc::with_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return head_dim == 64 ? launch_dq_wgmma<E, 64>(a, dq, stream)
                          : launch_dq_wgmma<E, 128>(a, dq, stream);
  });
}

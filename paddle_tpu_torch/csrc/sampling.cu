// Counter-based sampling draws for Hopper (sm_90a).
//
// Replaces the draws the reference hands to XLA inside its sampled decode
// and verify programs: jax.random.fold_in / categorical / uniform in
// sample_tokens and verify_spans (paddle_tpu/generation/sampling.py:175,
// :199). There is no Pallas kernel for them.
//
//   categorical_rows  one token per row of f32 logits [N, V]: the row's key
//                     fold_in(fold_in(key(seed), counter), offset) (no
//                     second fold without offsets), jax's threefry bits of
//                     each column, the f32 Gumbel noise
//                     -log(-log(uniform(tiny, 1))), and the argmax of
//                     logits + noise, ties to the lowest column.
//   uniform64_rows    one f64 uniform in [0, 1) per row under the same key:
//                     element 0 of jax's 64-bit bits, the top 52 bits under
//                     the exponent of 1.0, minus 1 (verify_spans draws its
//                     acceptance uniforms in f64: the reference enables x64).
//
// The stream is jax 0.9.0's with jax_threefry_partitionable: element i of
// a draw over a [V] row is threefry2x32(key, (i >> 32, i & 0xffffffff)),
// 32 bits as x0 ^ x1, 64 bits as (x0 << 32) | x1. The reference vmaps every
// draw per row, so i is the column within the row, never a flat index over
// [N, V]. The plain version (paddle_tpu_torch/kernels/sampling.py) computes
// the same words with int64 tensor ops.
//
// Bound: threefry is ~80 32-bit integer operations per element and the two
// logs ~40 more, against 4 bytes of logits read: operations bound it at
// the run's shapes ([4, 32000] a decode step, [20, 32000] a verify family),
// and at those sizes the launch itself costs more than either.
//
// Design: a cluster of kSplit CTAs per row, each walking a contiguous share
// of the columns (neighbouring threads on neighbouring columns), so a
// 4-row decode step still spreads over 32 SMs. Each thread keeps its best
// (value, column); warps reduce by shuffles, the CTA through shared memory,
// and rank 0 of the cluster reads the other ranks' results through
// distributed shared memory and writes the token. The comparison is a
// total order (NaN largest, as jnp.argmax and torch.argmax take it; equal
// values to the lower column), so the result does not depend on the order
// of the reduction.
//
// Rounding: built without --use_fast_math; logf (not __logf) and __f*_rn
// arithmetic (no contraction into FMAs), so the noise equals the plain
// version's torch ops on the card bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 8;                        // CTAs of a row's cluster
constexpr float kTiny = 1.17549435082228750797e-38f;   // FLT_MIN
constexpr int kMaxRows = 65535;                  // gridDim.y

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R);
  x1 ^= x0;
}

// Threefry-2x32, 20 rounds, on the pair (x0, x1) under the key (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
}

// fold_in(fold_in(key(seed), counter), offset): key(seed) is (0, seed),
// fold_in(k, c) is threefry2x32(k, (0, c)).
__device__ __forceinline__ void row_key(const int* seed, const int* counter,
                                        const int* offset, int row,
                                        uint32_t& k0, uint32_t& k1) {
  uint32_t x0 = 0u, x1 = (uint32_t)counter[row];
  threefry(0u, (uint32_t)seed[row], x0, x1);
  if (offset != nullptr) {
    uint32_t y0 = 0u, y1 = (uint32_t)offset[row];
    threefry(x0, x1, y0, y1);
    x0 = y0;
    x1 = y1;
  }
  k0 = x0;
  k1 = x1;
}

// jax.random.gumbel (mode "low") from one 32-bit word.
__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(kTiny, __fadd_rn(__fmul_rn(f, __fsub_rn(1.0f, kTiny)),
                                         kTiny));
  return -logf(-logf(u));
}

// (a, ia) before (b, ib) in argmax order: NaN largest, ties to the lower
// column.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, d);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, d);
    if (better(v2, i2, v, i)) {
      v = v2;
      i = i2;
    }
  }
}

// grid (kSplit, N): cluster rank r of row n takes columns
// [r * share, (r + 1) * share) of it.
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
categorical_kernel(const float* __restrict__ logits,
                   const int* __restrict__ seed,
                   const int* __restrict__ counter,
                   const int* __restrict__ offset, int* __restrict__ out,
                   int vocab) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.y;
  uint32_t k0, k1;
  row_key(seed, counter, offset, row, k0, k1);

  const int share = (vocab + kSplit - 1) / kSplit;
  const int lo = rank * share;
  const int hi = min(vocab, lo + share);
  const float* lrow = logits + (size_t)row * vocab;
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int j = lo + (int)threadIdx.x; j < hi; j += kThreads) {
    uint32_t x0 = 0u, x1 = (uint32_t)j;      // (hi, lo) words of column j
    threefry(k0, k1, x0, x1);
    const float v = __fadd_rn(lrow[j], gumbel(x0 ^ x1));
    if (better(v, j, best, best_i)) {
      best = v;
      best_i = j;
    }
  }
  warp_best(best, best_i);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? s_val[lane] : -INFINITY;
    best_i = lane < kWarps ? s_idx[lane] : 0x7fffffff;
    warp_best(best, best_i);
    if (lane == 0) {
      s_val[0] = best;
      s_idx[0] = best_i;
    }
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    best = s_val[0];
    best_i = s_idx[0];
    for (int r = 1; r < kSplit; ++r) {
      const float v = cluster.map_shared_rank(s_val, r)[0];
      const int i = cluster.map_shared_rank(s_idx, r)[0];
      if (better(v, i, best, best_i)) {
        best = v;
        best_i = i;
      }
    }
    out[row] = best_i;
  }
  cluster.sync();     // every rank's shared memory lives until rank 0 read it
}

__global__ void uniform64_kernel(const int* __restrict__ seed,
                                 const int* __restrict__ counter,
                                 const int* __restrict__ offset,
                                 double* __restrict__ out, int n) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  uint32_t k0, k1;
  row_key(seed, counter, offset, row, k0, k1);
  uint32_t x0 = 0u, x1 = 0u;                 // element 0 of a () draw
  threefry(k0, k1, x0, x1);
  const unsigned long long b = ((unsigned long long)x0 << 32) | x1;
  const double f = __longlong_as_double(
      (long long)((b >> 12) | 0x3FF0000000000000ull));
  // uniform's scale to [0, 1) and floor at 0 leave f as it is
  out[row] = __dsub_rn(f, 1.0);
}

}  // namespace

extern "C" {

// logits f32 [rows, vocab] contiguous; seed, counter, offset (may be
// null) int32 [rows] holding uint32 words; out int32 [rows].
int categorical_rows(const float* logits, const int* seed, const int* counter,
                     const int* offset, int* out, int rows, int vocab,
                     void* stream) {
  if (rows < 1 || rows > kMaxRows || vocab < 1)
    return (int)cudaErrorInvalidValue;
  categorical_kernel<<<dim3(kSplit, rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      logits, seed, counter, offset, out, vocab);
  return (int)cudaGetLastError();
}

// seed, counter, offset (may be null) int32 [rows]; out f64 [rows].
int uniform64_rows(const int* seed, const int* counter, const int* offset,
                   double* out, int rows, void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  uniform64_kernel<<<(rows + 127) / 128, 128, 0,
                     static_cast<cudaStream_t>(stream)>>>(seed, counter,
                                                          offset, out, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"

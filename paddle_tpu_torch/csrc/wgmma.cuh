// Building blocks of the 16-bit tensor-core (wgmma, sm_90a) kernels,
// shared by flash_fwd.cu, flash_bwd.cu and paged_varq.cu (decode_split.cuh
// uses the cp.async copies): 16-byte cp.async copies into the
// 128-byte-swizzled shared layout that wgmma's descriptors read (whole
// tiles of a dense tensor, or rows gathered from a paged pool), the
// descriptors themselves, and the m64nNk16 products of bf16 or f16
// operands (the element type E, bf16 by default) with f32 accumulators (A
// and B from shared memory, or A from registers and B read transposed),
// with the pair conversions between f32 and E that build A fragments and
// store outputs. Thread (warp w,
// lane l) of a warpgroup holds rows 16 w + l / 4 and 16 w + l / 4 + 8 of
// an m64nN accumulator, columns 8 j + 2 (l % 4) + {0, 1}, as elements
// 4 j + {0, 1} and 4 j + {2, 3}.
//
// f32 operands on the 16-bit tensor cores: K and V under a 16-bit q
// (`f32_kv`: flash_fwd.cu's and paged_varq.cu's instances for a bf16 / f16
// model over an f32 KV pool), every operand of flash_bwd.cu's f32
// instance (the BERT-base / ERNIE fine-tune's backward) and of
// flash_fwd.cu's f32 instance (its forward; three parts, below). They
// replace FMA-unit kernels of paddle_tpu/kernels/attention.py `_fwd_kernel`,
// `_bwd_dkdv_kernel`, `_bwd_dq_kernel` and paged_attention.py
// `_ragged_varq_kernel` for these dtypes (TF32 is off in the port). The
// f32 operand keeps its bits as two bf16 parts, hi = bf16(x) and lo =
// bf16(x - hi) (`split_bf16`; x - hi is exact in f32): hi + lo is x to
// within 2^-16 |x| (at least 16 significant bits) over f32's whole
// exponent range (bf16 has f32's exponents; f16 parts would overflow past
// 65504 and lose bits below 2^-14). A product with one split operand runs
// once per part (S = Q K_hi^T + Q K_lo^T); one of two split operands runs
// hi.hi + hi.lo + lo.hi (O += P_hi V_hi + P_hi V_lo + P_lo V_hi; the
// backward's S and dV), dropping lo.lo, below 2^-16 of the term: about
// 1e-5 of each output's size against f32 arithmetic, inside the f32 card
// tolerance (1e-4) where no sum amplifies it (three parts, below). A bf16 q is exact in bf16; an f16 q (11
// significant bits) is split too, exactly (`split_rows`: lo holds the 3
// bits bf16 cannot), and S gains Q_lo K_hi^T. The f32 rows arrive by
// cp.async in a dense staging tile (`stage_rows`) and are converted in
// shared memory into the swizzled hi and lo tiles (`split_tile`), whose
// generic stores are made visible to wgmma by `fence_async_smem` and a
// barrier; parts serve both operand majors (wgmma reads 16-bit operands
// transposed, .tf32 ones K-major only). Bound: the bytes of the f32
// operands; the operations count at the 16-bit tensor-core peak. Measured
// on an H100 80GB HBM3 at 700 W (tools/kernel_variants.py,
// tools/flash_bwd_variants.py), the split costs each kernel a tenth to a
// fifth of its time (flash_fwd's suffix prefill 0.0342 -> 0.0279 ms
// without it, paged_varq's mixed shape 0.0696 -> 0.0565, the backward's
// dK/dV at BERT-base's shape 0.0368 -> 0.0331, dQ 0.0287 -> 0.0278);
// TF32 parts (K-major only: transposed copies of V, dO, Q, K; at half the
// 16-bit rate) and f32 rows converted through registers (a 64-row tile is
// 128 registers a thread) were not built. The variants measured are in the
// kernels' notes.
//
// Three parts (`split3_bf16`, `split_tile<.., 3>`): hi, mid = bf16(x -
// hi), lo = bf16(x - hi - mid), 24 significant bits, x to within 2^-24 |x|;
// a product of two such operands keeps the six terms of order 2^-16 and
// above (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid), which is f32's
// accuracy at twice the products of two parts. flash_fwd.cu's f32
// instance runs S and P V so: with two parts its output and lse differ
// from the f32 version's by ~1e-5 of their size, and the 2-layer f32
// training gate of chip_smoke.py (Adam's 1 / eps slope at gradients near
// zero amplifies that) failed; three parts keep it where the FMA kernel
// kept it. flash_bwd.cu's f32 instances run dP in three parts, and dK and
// dQ on three parts of Q or K (dS, in registers, in two): with two parts
// their outputs sat at the f32 card tolerance on rows whose keys are all
// masked (P = 1 on every key, so dS is as large as dP).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

using bf16 = __nv_bfloat16;
using f16 = __half;

// the element type of a dtype code (0 = float32, 1 = bfloat16, 2 =
// float16): calls f(TypeTag<T>{}) and returns its result, or
// cudaErrorInvalidValue for another code
template <class T>
struct TypeTag {
  using type = T;
};
template <class F>
inline int with_dtype(int code, F&& f) {
  if (code == 0) return f(TypeTag<float>{});
  if (code == 1) return f(TypeTag<bf16>{});
  if (code == 2) return f(TypeTag<f16>{});
  return (int)cudaErrorInvalidValue;
}

// two f32 values as one 32-bit pair of E (round to nearest even), and back
template <class E>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (std::is_same<E, f16>::value) {
    __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}
template <class E>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (std::is_same<E, f16>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous global -> shared copies; `bytes` 0 writes zeros instead
// (rows past the ragged edge), reading nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// generic-proxy writes to shared memory (stores, cp.async), made visible
// to wgmma, which reads through the async proxy; a barrier follows before
// the product
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// waits until at most N of this thread's newest copy groups are pending
// and makes the others visible to wgmma; a __syncthreads follows
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  fence_async_smem();
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers that an asynchronous wgmma reads or writes: the compiler
// may not move their other uses across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared tiles: R rows x D bf16 as D/64 panels of R rows x 128 bytes, the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8) (the 128-byte
// swizzle, as TMA's SWIZZLE_128B writes it), each panel 1024-byte aligned.
// A wgmma descriptor: start address, leading and stride byte offsets in
// 16-byte units, layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (rows x features, features contiguous), k-step kk of 16
// features, from row `row0` of an R-row tile: 8-row groups 1024 bytes apart
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0,
                                                int kk) {
  return sw128_desc(tile + (kk / 4) * (R * 128) + row0 * 128 + (kk % 4) * 32,
                    16, 1024);
}
// MN-major (transposed) B operand: the k-step of rows [16 kk, 16 kk + 16)
// of an R-row tile as K and all D features as N; 64-feature panels R * 128
// bytes apart (leading), 8-row groups 1024 bytes apart (stride)
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, R * 128, 1024);
}

// byte offset of 16-byte chunk c of row r in an R-row swizzled tile
template <int R>
__device__ __forceinline__ uint32_t sw_chunk(int r, int c) {
  return (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t a,
                                             uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a),
               "r"(b)
               : "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr,
                                             const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}
__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// q (and the output) of a 16-bit type over f32 K/V: the tensor-core
// kernels with the f32 operand in bf16 hi + lo parts (paged_varq.cu's
// dispatch and flash_fwd.cu's at Sq > 1; kernels/paged_attention.py
// `varq_route` and kernels/attention.py `fwd_route` mirror it)
template <class TQ, class TKV>
constexpr bool f32_kv() {
  return !std::is_same<TQ, float>::value && std::is_same<TKV, float>::value;
}

// two f32 values as packed bf16 hi and lo pairs: hi = bf16(x), lo =
// bf16(x - hi) (x - hi is exact in f32), so hi + lo = x to 2^-16 |x|
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack2<bf16>(a, b);
  const float2 h = unpack2<bf16>(hi);
  lo = pack2<bf16>(a - h.x, b - h.y);
}

// two f32 values as packed bf16 hi, mid and lo pairs: hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid) (each difference exact in f32)
__device__ __forceinline__ void split3_bf16(float a, float b, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  hi = pack2<bf16>(a, b);
  const float2 h = unpack2<bf16>(hi);
  const float ra = a - h.x, rb = b - h.y;
  mid = pack2<bf16>(ra, rb);
  const float2 m = unpack2<bf16>(mid);
  lo = pack2<bf16>(ra - m.x, rb - m.y);
}

// rows [0, R) of D f32 values into a dense staging tile (row r at byte
// r * D * 4 of `dst`), row r from element offset row_off(r) of `src` (a
// negative offset zero-fills the row and reads nothing), 16 bytes (4
// values) per cp.async; with `src2`, the same rows of a second tensor
// into `dst2` (K and V rows of one position: each offset computed once)
template <int R, int D, int NT, class RowOff>
__device__ __forceinline__ void stage_rows(uint32_t dst, const float* src,
                                           RowOff row_off, int tid,
                                           uint32_t dst2 = 0,
                                           const float* src2 = nullptr) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
  static_assert((R * CPR) % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int j = 0; j < R * CPR / NT; ++j) {
    const int i = tid + j * NT, r = i / CPR, c = i % CPR;
    const long long off = row_off(r);
    const bool in = off >= 0;
    const uint32_t at = (uint32_t)(r * D + c * 4) * 4;
    const long long g = (in ? off : 0) + c * 4;
    cp_async16(dst + at, src + g, in ? 16 : 0);
    if (src2 != nullptr) cp_async16(dst2 + at, src2 + g, in ? 16 : 0);
  }
}

// a dense staging tile of R rows x D f32 values (`stage_rows`) as bf16 hi
// and lo tiles (PARTS 3: hi, mid at `lo` and lo at `lo2`) in the swizzled
// layout, 4 values (half a chunk) per step: a warp reads 512 contiguous
// bytes and writes whole 128-byte panel rows, so neither side has bank
// conflicts. Generic stores: fence_async_smem and a barrier before a
// wgmma reads the tiles
template <int R, int D, int NT, int PARTS = 2>
__device__ __forceinline__ void split_tile(uint32_t hi, uint32_t lo,
                                           uint32_t stage, int tid,
                                           uint32_t lo2 = 0) {
  constexpr int QPR = D / 4;  // 4-value pieces per row
  static_assert((R * QPR) % NT == 0, "tile pieces must split evenly");
  static_assert(PARTS == 2 || PARTS == 3, "two or three parts");
#pragma unroll 4
  for (int j = 0; j < R * QPR / NT; ++j) {
    const int i = tid + j * NT, r = i / QPR, p = i % QPR;
    const float4 x = ld_shared_f4(stage + (uint32_t)(r * D + 4 * p) * 4);
    const uint32_t at = sw_chunk<R>(r, p / 2) + (p % 2) * 8;
    uint32_t h0, h1, l0, l1;
    if constexpr (PARTS == 3) {
      uint32_t t0, t1;
      split3_bf16(x.x, x.y, h0, l0, t0);
      split3_bf16(x.z, x.w, h1, l1, t1);
      st_shared_v2(lo2 + at, t0, t1);
    } else {
      split_bf16(x.x, x.y, h0, l0);
      split_bf16(x.z, x.w, h1, l1);
    }
    st_shared_v2(hi + at, h0, h1);
    st_shared_v2(lo + at, l0, l1);
  }
}

// rows [0, R) of a tensor of 16-bit elements T as bf16 hi and lo tiles in
// the swizzled layout (exact for f16: hi keeps 8 of its 11 significant
// bits, lo the other 3), row r from element offset row_off(r) of `src` (a
// negative offset gives zeros), 16 bytes per load. Plain loads and
// generic stores: fence_async_smem and a barrier before a wgmma reads them
template <int R, int D, int NT, class RowOff, class T>
__device__ __forceinline__ void split_rows(uint32_t hi, uint32_t lo,
                                           const T* src, RowOff row_off,
                                           int tid) {
  static_assert(sizeof(T) == 2, "16-bit elements");
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert((R * CPR) % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int j = 0; j < R * CPR / NT; ++j) {
    const int i = tid + j * NT, r = i / CPR, c = i % CPR;
    const long long off = row_off(r);
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (off >= 0) u = *reinterpret_cast<const uint4*>(src + off + c * 8);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack2<T>(w[e]);
      split_bf16(f.x, f.y, h[e], l[e]);
    }
    st_shared_v4(hi + sw_chunk<R>(r, c), h);
    st_shared_v4(lo + sw_chunk<R>(r, c), l);
  }
}

// rows [0, R) of a swizzled tile of 16-bit elements E, row r from element
// offset row_off(r) of `src` (a negative offset zero-fills the row and
// reads nothing), 16 bytes per copy: rows may lie anywhere, as the rows of
// a paged KV pool do. With `src2`, the same rows of a second tensor into
// the tile at `dst2` (K and V rows of one pool position: each offset is
// computed once)
template <int R, int D, int NT, class RowOff, class E>
__device__ __forceinline__ void load_rows(uint32_t dst, const E* src,
                                          RowOff row_off, int tid,
                                          uint32_t dst2 = 0,
                                          const E* src2 = nullptr) {
  static_assert(sizeof(E) == 2, "16-bit elements");
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert((R * CPR) % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int j = 0; j < R * CPR / NT; ++j) {
    const int i = tid + j * NT, r = i / CPR, c = i % CPR;
    const long long off = row_off(r);
    const bool in = off >= 0;
    const uint32_t sw =
        (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
    const long long at = (in ? off : 0) + c * 8;
    cp_async16(dst + sw, src + at, in ? 16 : 0);
    if (src2 != nullptr) cp_async16(dst2 + sw, src2 + at, in ? 16 : 0);
  }
}

// rows [r0, r0 + R) of a [.., n, heads, D] tensor of 16-bit elements
// (row stride `stride` elements, `src` at the head's first element) into
// a swizzled tile, 16 bytes per copy; rows at or past n are zero-filled.
// (Not written over load_rows: routed through it, the flash kernels,
// which use every register, ran 3-6 % slower on an H100.)
template <int R, int D, int NT, class E>
__device__ __forceinline__ void load_tile(uint32_t dst, const E* src,
                                          long long stride, int r0, int n,
                                          int tid) {
  static_assert(sizeof(E) == 2, "16-bit elements");
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert((R * CPR) % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int j = 0; j < R * CPR / NT; ++j) {
    const int i = tid + j * NT, r = i / CPR, c = i % CPR, s = r0 + r;
    const bool in = s < n;
    const E* g = src + (in ? (long long)s * stride : 0) + c * 8;
    cp_async16(dst + (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               g, in ? 16 : 0);
  }
}

// the products' inline assembly for operands of type TY ("bf16" or
// "f16"), f32 accumulators
#define TC_WGMMA_SS_N32(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "  \
      "%8, %9, %10, %11, %12, %13, %14, %15"  \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])  \
      : "l"(a), "l"(b), "r"(accumulate))

#define TC_WGMMA_SS_N64(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, "  \
      "%24, %25, %26, %27, %28, %29, %30, %31"  \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])  \
      : "l"(a), "l"(b), "r"(accumulate))

#define TC_WGMMA_SS_N128(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, "  \
      "%24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, "  \
      "%40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, "  \
      "%56, %57, %58, %59, %60, %61, %62, %63"  \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "l"(a), "l"(b), "r"(accumulate))

#define TC_WGMMA_RS_N64(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, "  \
      "%24, %25, %26, %27, %28, %29, %30, %31"  \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

#define TC_WGMMA_RS_N128(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, "  \
      "%24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, "  \
      "%40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, "  \
      "%56, %57, %58, %59, %60, %61, %62, %63"  \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B (E) K-major in shared memory
template <class E = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (std::is_same<E, f16>::value)
    TC_WGMMA_SS_N32("f16");
  else
    TC_WGMMA_SS_N32("bf16");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B (E) K-major in shared memory
template <class E = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (std::is_same<E, f16>::value)
    TC_WGMMA_SS_N64("f16");
  else
    TC_WGMMA_SS_N64("bf16");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B (E) K-major in shared
// memory
template <class E = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (std::is_same<E, f16>::value)
    TC_WGMMA_SS_N128("f16");
  else
    TC_WGMMA_SS_N128("bf16");
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A (E pairs) in registers, B MN-major
// (transposed) in shared memory
template <class E = bf16>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (std::is_same<E, f16>::value)
    TC_WGMMA_RS_N64("f16");
  else
    TC_WGMMA_RS_N64("bf16");
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A (E pairs) in registers, B MN-major
// (transposed) in shared memory
template <class E = bf16>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (std::is_same<E, f16>::value)
    TC_WGMMA_RS_N128("f16");
  else
    TC_WGMMA_RS_N128("bf16");
}

#undef TC_WGMMA_SS_N32
#undef TC_WGMMA_SS_N64
#undef TC_WGMMA_SS_N128
#undef TC_WGMMA_RS_N64
#undef TC_WGMMA_RS_N128

// 2^x (ex2.approx: 2 ulp, subnormals flushed)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace tc

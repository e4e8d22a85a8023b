// Fused multi-tensor optimizer update for Hopper (sm_90a).
//
// Replaces the work the reference hands to XLA inside one program per
// step: FusedPlan._apply / fused_bucket_update
// (paddle_tpu/optimizer/fused.py:181, :369) and, inside TrainStep, the
// norm of _clip_grads_functional (paddle_tpu/jit/bridge.py:92). There is
// no Pallas kernel for it.
//
//   fused_update  one launch walks every tensor of a plan and applies
//                 _sgd_math, _momentum_math or _adam_math to each element,
//                 with the gradient clip, the coupled L2 / L1 penalty,
//                 AdamW's decoupled decay and the per-tensor lr scale; a
//                 one-block launch behind it adds 1 to each Adam step
//                 counter.
//   grad_sq_norm  per-chunk f32 sums of squares of the gradients in one
//                 launch, then a one-block launch that sums each tensor's
//                 chunks and the tensors in a fixed order (no atomics:
//                 two calls agree bit for bit) and writes the clip scale
//                 of each tensor (global norm, or its own norm).
//
// Bound: bytes. Adam with f32 master weights reads the gradient, the
// master and both moments and writes those three and the parameter (28
// bytes per bf16 parameter, 28 per f32 one); ~25 f32 operations per
// element are far below the card's rate.
//
// Design:
// - The table. Each tensor has a static Entry (the addresses of its
//   parameter, master weight, moments and step counter, its element
//   count and its coefficients), packed once per plan into device memory.
//   The gradients move every step (backward allocates new ones), so their
//   addresses go by value as a kernel parameter (__grid_constant__, up to
//   kMaxTensors per launch; CUDA 12.1+ takes parameters above 4 KB).
// - Work is balanced by chunks of kChunk elements, one block per chunk; a
//   block finds its tensor by binary search over the entries' first chunk.
// - Each tensor is walked in 16-byte loads and stores (8 elements a thread:
//   one uint4 of bf16, two float4 of f32) from the first element at which
//   every one of its arrays is 16-byte aligned, with scalar code for the
//   head before it and the tail after the last whole vector (a tensor with
//   no such element walks in scalars).
// - The step counter: every block reads t before any block could change
//   it, because the increment is a second launch on the same stream.
// - Rounding follows the port's per-parameter path op by op: __f*_rn
//   intrinsics (no contraction into FMAs), IEEE division and square root,
//   the result of each op rounded to the compute type (f32 with master
//   weights, else the parameter's type), the clip in the gradient's type,
//   the parameter written from the new master with round-to-nearest-even.
// - The guard: a device flag that, when set, makes both launches return
//   before writing anything. The host never reads it.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                  // elements a thread per pass
constexpr long long kChunk = 16384;      // elements a block
constexpr int kMaxTensors = 1024;        // gradient addresses a launch takes
constexpr int kFinishThreads = 1024;

enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum : int { kSGD = 0, kMomentum = 1, kAdam = 2 };
enum : int { kClipNone = 0, kClipScale = 1, kClipValue = 2 };

// Mirrored by _ENTRY in paddle_tpu_torch/kernels/fused_optimizer.py.
struct Entry {
  void* p;          // parameter, type pdt
  float* master;    // f32 master weight, or null (then p is updated)
  void* m;          // velocity / moment1, compute type, or null
  void* v;          // moment2, compute type, or null
  int* step;        // int32 step counter, or null
  long long n;      // elements
  float wd;         // AdamW's decoupled decay coefficient
  float lr_scale;   // AdamW's lr_ratio
  float l2, l1;     // coupled penalties folded into the gradient
  int chunk0;       // the tensor's first chunk within this launch
  uint8_t pdt, gdt, cdt, pad;  // parameter, gradient and compute types
};
static_assert(sizeof(Entry) == 72, "Entry layout changed");

struct Grads {
  const void* g[kMaxTensors];
};

struct Hyper {
  int nesterov, clip;
  float b1, omb1, b2, omb2, eps, mu, lo, hi;
};

__device__ __forceinline__ int elem_size(int dt) { return dt == kF32 ? 4 : 2; }

__device__ __forceinline__ float half_bits(unsigned int b, int dt) {
  return dt == kBF16 ? __uint_as_float(b << 16)
                     : __half2float(__ushort_as_half((unsigned short)b));
}

__device__ __forceinline__ unsigned int to_half_bits(float x, int dt) {
  return dt == kBF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(x))
                     : __half_as_ushort(__float2half_rn(x));
}

// x rounded to type dt (round to nearest even) and back.
__device__ __forceinline__ float rnd(float x, int dt) {
  return dt == kF32 ? x : half_bits(to_half_bits(x, dt), dt);
}

__device__ __forceinline__ float ld1(const void* b, int dt, long long i) {
  if (dt == kF32) return static_cast<const float*>(b)[i];
  return half_bits(static_cast<const unsigned short*>(b)[i], dt);
}

__device__ __forceinline__ void st1(void* b, int dt, long long i, float x) {
  if (dt == kF32)
    static_cast<float*>(b)[i] = x;
  else
    static_cast<unsigned short*>(b)[i] = (unsigned short)to_half_bits(x, dt);
}

__device__ __forceinline__ void ld8(const void* b, int dt, long long i,
                                    float (&x)[kVec]) {
  if (dt == kF32) {
    const float4* q = reinterpret_cast<const float4*>(
        static_cast<const float*>(b) + i);
    const float4 a = q[0], c = q[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
  } else {
    const uint4 r = *reinterpret_cast<const uint4*>(
        static_cast<const unsigned short*>(b) + i);
    const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = half_bits(w[k] & 0xffffu, dt);
      x[2 * k + 1] = half_bits(w[k] >> 16, dt);
    }
  }
}

__device__ __forceinline__ void st8(void* b, int dt, long long i,
                                    const float (&x)[kVec]) {
  if (dt == kF32) {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(b) + i);
    q[0] = make_float4(x[0], x[1], x[2], x[3]);
    q[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    unsigned int w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = to_half_bits(x[2 * k], dt) | (to_half_bits(x[2 * k + 1], dt) << 16);
    *reinterpret_cast<uint4*>(static_cast<unsigned short*>(b) + i) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The last entry whose first chunk is at or before chunk c.
__device__ __forceinline__ int find_tensor(const Entry* tab, int n, int c) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned_at(const void* ptr, int size,
                                           long long k) {
  return ptr == nullptr ||
         ((reinterpret_cast<uintptr_t>(ptr) + (uintptr_t)(k * size)) & 15) == 0;
}

// The first j in [0, kVec) at which every array is 16-byte aligned at
// element base + j, or kVec when there is none. base is a multiple of kVec,
// so the answer is the same for every chunk of a tensor.
__device__ __forceinline__ int vector_phase(const void* const (&ptrs)[5],
                                            const int (&sizes)[5],
                                            long long base) {
  for (int j = 0; j < kVec; ++j) {
    bool ok = true;
#pragma unroll
    for (int a = 0; a < 5; ++a) ok = ok && aligned_at(ptrs[a], sizes[a], base + j);
    if (ok) return j;
  }
  return kVec;
}

// Per-tensor constants of one step.
struct Scalars {
  float lr;      // lr * lr_scale in the compute type
  float lrwd;    // (lr * lr_scale) * wd in the compute type
  float bc1, bc2;  // 1 - beta^t
  float gscale;  // the clip scale in the gradient's type
  float l2, l1;
  bool wd;
};

// One element: the port's per-parameter path (nn/clip.py, then
// Optimizer._decayed_grad and _sgd_math / _momentum_math / _adam_math),
// each op's result rounded to the compute type when it is bf16 / f16
// (LOWP; an f32 compute type needs no rounding). p is the compute copy
// (master or parameter); m and v are the state (velocity in m).
template <int KIND, bool LOWP>
__device__ __forceinline__ void update(const Hyper& h, const Scalars& s,
                                       int gdt, int cdt, float g, float& p,
                                       float& m, float& v) {
  auto R = [cdt](float x) { return LOWP ? rnd(x, cdt) : x; };
  if (h.clip == kClipScale)
    g = rnd(__fmul_rn(g, s.gscale), gdt);
  else if (h.clip == kClipValue)
    g = rnd(fminf(fmaxf(g, h.lo), h.hi), gdt);
  g = R(g);
  if (s.l2 != 0.f) g = R(__fadd_rn(g, R(__fmul_rn(s.l2, p))));
  if (s.l1 != 0.f) {
    const float sg = p > 0.f ? 1.f : (p < 0.f ? -1.f : p);  // sign(p)
    g = R(__fadd_rn(g, R(__fmul_rn(s.l1, sg))));
  }
  if constexpr (KIND == kSGD) {
    p = R(__fsub_rn(p, R(__fmul_rn(s.lr, g))));
  } else if constexpr (KIND == kMomentum) {
    m = R(__fadd_rn(R(__fmul_rn(h.mu, m)), g));
    const float d = h.nesterov ? R(__fadd_rn(g, R(__fmul_rn(h.mu, m)))) : m;
    p = R(__fsub_rn(p, R(__fmul_rn(s.lr, d))));
  } else {
    m = R(__fadd_rn(R(__fmul_rn(h.b1, m)), R(__fmul_rn(h.omb1, g))));
    v = R(__fadd_rn(R(__fmul_rn(h.b2, v)),
                    R(__fmul_rn(h.omb2, R(__fmul_rn(g, g))))));
    const float mhat = R(__fdiv_rn(m, s.bc1));
    const float vhat = R(__fdiv_rn(v, s.bc2));
    float upd = R(__fdiv_rn(R(__fmul_rn(s.lr, mhat)),
                            R(__fadd_rn(R(__fsqrt_rn(vhat)), h.eps))));
    if (s.wd) upd = R(__fadd_rn(upd, R(__fmul_rn(s.lrwd, p))));
    p = R(__fsub_rn(p, upd));
  }
}

// One chunk [base, end) of tensor e: scalar head and tail, 16-byte body.
template <int KIND, bool LOWP>
__device__ __forceinline__ void walk(const Entry& e, const void* g,
                                     const Hyper& h, const Scalars& s,
                                     long long base, long long end) {
  constexpr bool kM = KIND != kSGD, kV = KIND == kAdam;
  const int pdt = e.pdt, gdt = e.gdt, cdt = e.cdt;
  // the compute copy: the master weight, else the parameter itself
  void* pc = e.master != nullptr ? static_cast<void*>(e.master) : e.p;
  const int pcdt = e.master != nullptr ? kF32 : pdt;
  const void* const ptrs[5] = {g, e.p, e.master, e.m, e.v};
  const int sizes[5] = {elem_size(gdt), elem_size(pdt), 4, elem_size(cdt),
                        elem_size(cdt)};
  const int phase = vector_phase(ptrs, sizes, base);
  const long long body_lo = phase == kVec ? end : min(base + phase, end);
  const long long body_hi = body_lo + (end - body_lo) / kVec * kVec;

  auto scalar = [&](long long k) {
    float p = ld1(pc, pcdt, k);
    float m = kM ? ld1(e.m, cdt, k) : 0.f;
    float v = kV ? ld1(e.v, cdt, k) : 0.f;
    update<KIND, LOWP>(h, s, gdt, cdt, ld1(g, gdt, k), p, m, v);
    if (e.master != nullptr) e.master[k] = p;
    st1(e.p, pdt, k, p);
    if (kM) st1(e.m, cdt, k, m);
    if (kV) st1(e.v, cdt, k, v);
  };
  for (long long k = base + threadIdx.x; k < body_lo; k += kThreads) scalar(k);
  for (long long k = body_hi + threadIdx.x; k < end; k += kThreads) scalar(k);

  for (long long k = body_lo + (long long)threadIdx.x * kVec; k < body_hi;
       k += (long long)kThreads * kVec) {
    float gv[kVec], p[kVec], m[kVec] = {}, v[kVec] = {};
    ld8(g, gdt, k, gv);
    ld8(pc, pcdt, k, p);
    if (kM) ld8(e.m, cdt, k, m);
    if (kV) ld8(e.v, cdt, k, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      update<KIND, LOWP>(h, s, gdt, cdt, gv[j], p[j], m[j], v[j]);
    if (e.master != nullptr) st8(e.master, kF32, k, p);
    st8(e.p, pdt, k, p);
    if (kM) st8(e.m, cdt, k, m);
    if (kV) st8(e.v, cdt, k, v);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const Entry* __restrict__ tab, int n_tensors,
                    const __grid_constant__ Grads grads, const Hyper h,
                    const float* __restrict__ lr_ptr,
                    const float* __restrict__ scales,
                    const unsigned char* __restrict__ bad) {
  if (bad != nullptr && *bad) return;
  const int c = blockIdx.x;
  const int i = find_tensor(tab, n_tensors, c);
  const Entry e = tab[i];
  const int gdt = e.gdt, cdt = e.cdt;

  Scalars s;
  const float lr = e.lr_scale == 1.f ? *lr_ptr : __fmul_rn(*lr_ptr, e.lr_scale);
  s.lr = rnd(lr, cdt);
  s.wd = e.wd != 0.f;
  s.lrwd = rnd(__fmul_rn(lr, e.wd), cdt);
  s.l2 = e.l2;
  s.l1 = e.l1;
  s.gscale = h.clip == kClipScale ? rnd(scales[i], gdt) : 1.f;
  s.bc1 = s.bc2 = 1.f;
  if (KIND == kAdam) {
    const float tf = rnd(__int2float_rn(*e.step + 1), cdt);
    s.bc1 = rnd(__fsub_rn(1.f, rnd(powf(rnd(h.b1, cdt), tf), cdt)), cdt);
    s.bc2 = rnd(__fsub_rn(1.f, rnd(powf(rnd(h.b2, cdt), tf), cdt)), cdt);
  }
  const long long base = (long long)(c - e.chunk0) * kChunk;
  const long long end = min(base + kChunk, e.n);
  if (cdt == kF32)
    walk<KIND, false>(e, grads.g[i], h, s, base, end);
  else
    walk<KIND, true>(e, grads.g[i], h, s, base, end);
}

__global__ void bump_steps(const Entry* __restrict__ tab, int n_tensors,
                           const unsigned char* __restrict__ bad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tensors || (bad != nullptr && *bad)) return;
  if (tab[i].step != nullptr) tab[i].step[0] += 1;
}

// Sum of squares of one chunk of one gradient: f32 squares of the f32
// values for the global norm; for a tensor's own norm (ClipGradByNorm),
// each square rounded to the gradient's type first, as g * g is.
__global__ void __launch_bounds__(kThreads)
grad_sq_partial(const Entry* __restrict__ tab, int n_tensors,
                const __grid_constant__ Grads grads, int per_tensor,
                float* __restrict__ partial) {
  const int c = blockIdx.x;
  const int i = find_tensor(tab, n_tensors, c);
  const long long n = tab[i].n;
  const int gdt = tab[i].gdt;
  const void* g = grads.g[i];
  const long long base = (long long)(c - tab[i].chunk0) * kChunk;
  const long long end = min(base + kChunk, n);
  const void* const ptrs[5] = {g, nullptr, nullptr, nullptr, nullptr};
  const int sizes[5] = {elem_size(gdt), 0, 0, 0, 0};
  const int phase = vector_phase(ptrs, sizes, base);
  const long long body_lo = phase == kVec ? end : min(base + phase, end);
  const long long body_hi = body_lo + (end - body_lo) / kVec * kVec;

  float acc = 0.f;
  auto add = [&](float x) {
    acc = __fadd_rn(acc, per_tensor ? rnd(__fmul_rn(x, x), gdt) : __fmul_rn(x, x));
  };
  for (long long k = base + threadIdx.x; k < body_lo; k += kThreads) add(ld1(g, gdt, k));
  for (long long k = body_hi + threadIdx.x; k < end; k += kThreads) add(ld1(g, gdt, k));
  for (long long k = body_lo + (long long)threadIdx.x * kVec; k < body_hi;
       k += (long long)kThreads * kVec) {
    float x[kVec];
    ld8(g, gdt, k, x);
#pragma unroll
    for (int j = 0; j < kVec; ++j) add(x[j]);
  }
  // fixed-order block sum
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ float warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sum[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) partial[c] = acc;
  }
}

// One block: each tensor's sum of squares from its chunks (a warp per
// tensor), then the clip scale of each tensor.
__global__ void __launch_bounds__(kFinishThreads)
grad_sq_finish(const int* __restrict__ chunk_starts,
               const unsigned char* __restrict__ gdts, int n_tensors,
               int per_tensor, float clip_norm,
               const float* __restrict__ partial, float* __restrict__ sq,
               float* __restrict__ scales) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n_tensors; i += kFinishThreads / 32) {
    float a = 0.f;
    for (int c = chunk_starts[i] + lane; c < chunk_starts[i + 1]; c += 32)
      a += partial[c];
    for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
    if (lane == 0) sq[i] = per_tensor ? rnd(a, gdts[i]) : a;
  }
  __syncthreads();
  __shared__ float global_scale;
  if (!per_tensor && warp == 0) {
    float a = 0.f;
    for (int i = lane; i < n_tensors; i += 32) a += sq[i];
    for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
    if (lane == 0) {
      const float gn = __fsqrt_rn(a);
      global_scale = gn > clip_norm ? __fdiv_rn(clip_norm, fmaxf(gn, 1e-12f)) : 1.f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tensors; i += kFinishThreads) {
    if (per_tensor) {
      const float nrm = rnd(__fsqrt_rn(sq[i]), gdts[i]);
      scales[i] = nrm > clip_norm ? rnd(__fdiv_rn(clip_norm, nrm), gdts[i]) : 1.f;
    } else {
      scales[i] = global_scale;
    }
  }
}

Grads grads_of(const unsigned long long* grad_ptrs, int n) {
  Grads g;
  for (int i = 0; i < n; ++i) g.g[i] = reinterpret_cast<const void*>(grad_ptrs[i]);
  return g;
}

}  // namespace

extern "C" {

// One group of at most kMaxTensors tensors: `tab` its Entry table on the
// device, `grad_ptrs` its gradients' addresses (host array), `n_chunks`
// the group's chunks. lr, scales (one per tensor of the group, read only
// with clip == kClipScale) and bad (may be null) are device pointers.
int fused_update(const void* tab, int n_tensors, int n_chunks,
                 const unsigned long long* grad_ptrs, int kind, int nesterov,
                 int clip, float b1, float omb1, float b2, float omb2,
                 float eps, float mu, float lo, float hi, const float* lr,
                 const float* scales, const unsigned char* bad, void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors) return (int)cudaErrorInvalidValue;
  const Entry* t = static_cast<const Entry*>(tab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{nesterov, clip, b1, omb1, b2, omb2, eps, mu, lo, hi};
  if (n_chunks > 0) {
    const Grads g = grads_of(grad_ptrs, n_tensors);
    if (kind == kSGD)
      fused_update_kernel<kSGD><<<n_chunks, kThreads, 0, st>>>(
          t, n_tensors, g, h, lr, scales, bad);
    else if (kind == kMomentum)
      fused_update_kernel<kMomentum><<<n_chunks, kThreads, 0, st>>>(
          t, n_tensors, g, h, lr, scales, bad);
    else
      fused_update_kernel<kAdam><<<n_chunks, kThreads, 0, st>>>(
          t, n_tensors, g, h, lr, scales, bad);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || kind != kAdam) return (int)err;
  bump_steps<<<(n_tensors + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      t, n_tensors, bad);
  return (int)cudaGetLastError();
}

// The per-chunk sums of one group into partial[0 : n_chunks].
int grad_sq_partial_sums(const void* tab, int n_tensors, int n_chunks,
                         const unsigned long long* grad_ptrs, int per_tensor,
                         float* partial, void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0)
    grad_sq_partial<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Entry*>(tab), n_tensors, grads_of(grad_ptrs, n_tensors),
        per_tensor, partial);
  return (int)cudaGetLastError();
}

// Every tensor of the plan: chunk_starts [n_tensors + 1] over partial,
// gdts [n_tensors]; writes sq and scales [n_tensors].
int grad_sq_norm_finish(const int* chunk_starts, const unsigned char* gdts,
                        int n_tensors, int per_tensor, float clip_norm,
                        const float* partial, float* sq, float* scales,
                        void* stream) {
  grad_sq_finish<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      chunk_starts, gdts, n_tensors, per_tensor, clip_norm, partial, sq, scales);
  return (int)cudaGetLastError();
}

}  // extern "C"

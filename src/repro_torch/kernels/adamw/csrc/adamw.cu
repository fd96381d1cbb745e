// Multi-tensor AdamW step for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves AdamW to XLA, which
// fuses repro/optim/optimizers.py's update into one pass.  The port's plain
// version (../ref.py) runs it as PyTorch's eager ops, 23 elementwise kernels
// a leaf, each reading and writing whole f32 temporaries: ~192 B an element,
// ~8.6x the bytes the update needs.  This kernel is that update in one pass
// over every leaf of the step.
//
// What it computes, per element, with the scalars rounded to f32 as PyTorch
// rounds a Python number and each product and sum rounded on its own, as the
// plain version's kernels round them:
//   g  = f32(grad)
//   m  = b1 * m + (1 - b1) * g
//   v  = b2 * v + (1 - b2) * (g * g)
//   u  = (m * inv_bc1) / (sqrt(v * inv_bc2) + eps) + wd * f32(p)
//   p  = cast_p(f32(p) - lr * u)
// inv_bc = f32(1 / f32(bc)): PyTorch's CUDA division by a Python scalar
// multiplies by the f32 reciprocal (BinaryDivTrueKernel.cu), and this kernel
// does the same.  The intrinsics __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn are never contracted into a fused multiply-add, and
// the build does not pass --use_fast_math, so the result is the plain
// version's to the bit.
//
// Bound: device memory (3.35 TB/s on an H100 SXM).  An element reads its
// parameter and gradient as stored and its f32 m and v, and writes the
// parameter, m and v: 22.3 B an element at StarCoder2-3B's mix of bf16 leaves
// and its f32 table, 67.56 GB or 20.17 ms a step.  Each of those bytes moves
// exactly once.  The arithmetic, IEEE divide and square-root sequences among
// it, stays under the memory's time: taken out, the kernel runs no faster.
//
// Design.  One launch takes up to kMaxLeaves leaves, their table passed by
// value in the kernel's parameters (32 KB allowed since CUDA 12.1, read
// through __grid_constant__ without a copy), so a step uploads nothing, waits
// for nothing and allocates nothing.  The work is cut into fixed chunks of
// kChunk elements across all the launch's leaves: each leaf owns
// ceil(n / kChunk) consecutive chunks from its row's chunk0, one block a
// chunk, and a block finds its leaf by binary search over chunk0.  A 151 M
// element table and a 3,072 element norm vector share a launch without either
// holding the card.  Inside a chunk, 4 elements a thread move as one vector
// access each (16 bytes of f32, 8 of bf16), so that a warp's access to every
// buffer is one contiguous run, from the first element where all four of the
// leaf's buffers are aligned to their vector width together, with a scalar
// head before it and a scalar tail after the last whole vector; a leaf whose
// buffers never align together runs scalar throughout.  (8 elements a thread,
// 16-byte bf16 accesses and two 16-byte f32 accesses 32 bytes apart, ran at
// 54% of the bound at StarCoder2-3B's leaves where 4 a thread run at 87%;
// with the arithmetic taken out the two layouts ran at 47% and 87%: the
// access pattern, not the arithmetic, set the rate.)
//
// Table rows are 7 int64 words:
//   [param ptr, grad ptr, m ptr, v ptr, elements, first chunk, flags]
// flags bit 0: the parameter is bf16 (else f32); bit 1: the gradient is bf16.
// chunk0 does not decrease from row to row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int64_t kChunk = int64_t(kThreads) * kVec * 16;  // elements a block
constexpr int kMaxLeaves = 512;
constexpr int kCols = 7;
constexpr int kParamBF16 = 1;
constexpr int kGradBF16 = 2;

struct Leaf {
  void* p;
  const void* g;
  float* m;
  float* v;
  int64_t n;
  int32_t chunk0;
  int32_t flags;
};

struct Scalars {
  float lr, b1, omb1, b2, omb2, eps, wd, inv_bc1, inv_bc2;
};

struct Args {
  Scalars s;
  int n_leaves;
  Leaf leaves[kMaxLeaves];
};
static_assert(sizeof(Args) <= 32764, "a kernel's parameters hold at most 32,764 bytes");

__device__ __forceinline__ float load1(const void* p, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store1(void* p, int64_t i, float x, bool bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else static_cast<float*>(p)[i] = x;
}

union BF16x4 {
  uint2 u;
  __nv_bfloat16 h[4];
};

// 4 elements starting at p[i]; &p[i] is aligned to 4 elements.
__device__ __forceinline__ void load4(const void* p, int64_t i, bool bf16, float (&x)[4]) {
  if (bf16) {
    BF16x4 v;
    v.u = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = __bfloat162float(v.h[k]);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
}

__device__ __forceinline__ void store4(void* p, int64_t i, const float (&x)[4], bool bf16) {
  if (bf16) {
    BF16x4 v;
#pragma unroll
    for (int k = 0; k < 4; ++k) v.h[k] = __float2bfloat16_rn(x[k]);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = v.u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// One element's update, in ../ref.py's order of operations.
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Scalars& s) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps);
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(m, s.inv_bc1), den), __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, u));
}

__device__ __forceinline__ void update1(const Leaf& L, int64_t j, bool pbf, bool gbf,
                                        const Scalars& s) {
  float p = load1(L.p, j, pbf), m = L.m[j], v = L.v[j];
  update(p, load1(L.g, j, gbf), m, v, s);
  store1(L.p, j, p, pbf);
  L.m[j] = m;
  L.v[j] = v;
}

// The first element (0..3) from which all four buffers are aligned to their
// vector width (4 elements) together, or -1 when they never are.
__device__ __forceinline__ int vector_head(const Leaf& L, bool pbf, bool gbf) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(L.p), g = reinterpret_cast<uintptr_t>(L.g);
  const uintptr_t m = reinterpret_cast<uintptr_t>(L.m), v = reinterpret_cast<uintptr_t>(L.v);
  const uintptr_t ps = pbf ? 2 : 4, gs = gbf ? 2 : 4;
  for (int j = 0; j < kVec; ++j)
    if ((p + j * ps) % (kVec * ps) == 0 && (g + j * gs) % (kVec * gs) == 0 &&
        (m + 4 * j) % 16 == 0 && (v + 4 * j) % 16 == 0)
      return j;
  return -1;
}

__global__ void __launch_bounds__(kThreads) adamw_kernel(const __grid_constant__ Args a) {
  const int b = blockIdx.x;
  int lo = 0, hi = a.n_leaves - 1;  // the last row whose chunk0 <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.leaves[mid].chunk0 <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = a.leaves[lo];
  const Scalars s = a.s;
  const bool pbf = L.flags & kParamBF16, gbf = L.flags & kGradBF16;
  const int64_t c0 = int64_t(b - L.chunk0) * kChunk;
  const int64_t c1 = c0 + kChunk < L.n ? c0 + kChunk : L.n;
  const int head = vector_head(L, pbf, gbf);
  // vector body [v0, v1); c0 is a multiple of 4, so the chunk's body starts at c0 + head
  const int64_t v0 = head < 0 || c0 + head > c1 ? c1 : c0 + head;
  const int64_t v1 = v0 + (c1 - v0) / kVec * kVec;
  for (int64_t j = c0 + threadIdx.x; j < v0; j += kThreads) update1(L, j, pbf, gbf, s);
  for (int64_t j = v0 + int64_t(threadIdx.x) * kVec; j < v1; j += int64_t(kThreads) * kVec) {
    float p[4], g[4], m[4], v[4];
    load4(L.p, j, pbf, p);
    load4(L.g, j, gbf, g);
    load4(L.m, j, false, m);
    load4(L.v, j, false, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) update(p[k], g[k], m[k], v[k], s);
    store4(L.p, j, p, pbf);
    store4(L.m, j, m, false);
    store4(L.v, j, v, false);
  }
  for (int64_t j = v1 + threadIdx.x; j < c1; j += kThreads) update1(L, j, pbf, gbf, s);
}

}  // namespace

extern "C" int adamw_max_leaves() { return kMaxLeaves; }

extern "C" long long adamw_chunk() { return kChunk; }

// One launch over ``n_leaves`` table rows covering ``n_chunks`` chunks.  The
// scalars come as the Python floats the plain version uses; each is rounded
// to f32 here as PyTorch rounds a Python number, and the bias corrections'
// reciprocals are taken in f32 as PyTorch's division by a scalar takes them.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int adamw_launch(const int64_t* rows, int n_leaves, int n_chunks, double lr, double b1,
                            double b2, double eps, double weight_decay, double bc1, double bc2,
                            void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_chunks <= 0) return int(cudaErrorInvalidValue);
  Args a;
  memset(&a, 0, sizeof(a));
  a.s.lr = float(lr);
  a.s.b1 = float(b1);
  a.s.omb1 = float(1.0 - b1);
  a.s.b2 = float(b2);
  a.s.omb2 = float(1.0 - b2);
  a.s.eps = float(eps);
  a.s.wd = float(weight_decay);
  a.s.inv_bc1 = 1.0f / float(bc1);
  a.s.inv_bc2 = 1.0f / float(bc2);
  a.n_leaves = n_leaves;
  for (int i = 0; i < n_leaves; ++i) {
    const int64_t* r = rows + int64_t(i) * kCols;
    Leaf& L = a.leaves[i];
    L.p = reinterpret_cast<void*>(r[0]);
    L.g = reinterpret_cast<const void*>(r[1]);
    L.m = reinterpret_cast<float*>(r[2]);
    L.v = reinterpret_cast<float*>(r[3]);
    L.n = r[4];
    L.chunk0 = int32_t(r[5]);
    L.flags = int32_t(r[6]);
  }
  adamw_kernel<<<unsigned(n_chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

// Gradient-arena pack/unpack kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/comm_pack/kernel.py:
//   comm_pack_pack   <- _pack_kernel / pack_arena_pallas     (kernel.py:49, :159)
//   comm_pack_unpack <- _unpack_kernel / unpack_arena_pallas (kernel.py:194, :246)
//
// What it computes (the plain versions are in ../ref.py):
//   pack    arena[off_i + j] = cast_wire(x),   x = f32(part_i[j]) (+ r_i[j] under EF)
//           and under EF     r_i[j]          = x - f32(cast_wire(x))
//   unpack  part_i[j]        = cast_dst(f32(arena[off_i + j]) * scale)
//
// Bound: both directions move bytes and do ~1 flop per element, so they are
// bound by device memory (3.35 TB/s on an H100 SXM).  Each gradient, residual
// and arena element is read or written exactly once: the cast to the wire
// dtype and the error-feedback update ride along with the one copy the
// merged all-reduce needs anyway.
//
// Design.  The TPU kernel streams one part at a time through a
// double-buffered VMEM staging slot in a sequential grid.  Here blocks run in
// parallel in no order, so the work is cut the other way: blocks tile the
// *arena* (kTile elements each), and a block finds the part(s) its tile
// overlaps by binary search in a small device table (one row per part, built
// once per group on the host and cached by the wrapper).  Offsets are
// element-exact, so a part may start anywhere in the arena: when the part's
// arena offset is a multiple of 8 and its buffers are 16-byte aligned, the
// bulk of the span moves as 8-element vectors (16-byte bf16 / two 16-byte
// f32 accesses per thread) with a scalar head and tail; otherwise the whole
// span takes the scalar path.  The arithmetic uses the explicitly rounded
// intrinsics (__fadd_rn, __fsub_rn, __fmul_rn, __float2bfloat16_rn), which
// the compiler never contracts into a fused multiply-add, and the build
// does not pass --use_fast_math, so subnormals are kept as the plain
// version keeps them.
//
// Table rows are 6 int64 words:
//   pack:   [src ptr, residual-in ptr, residual-out ptr, arena offset, size, flags]
//   unpack: [dst ptr, 0,               0,                arena offset, size, flags]
// flags bit 0: the part (src or dst) is bf16 (else f32); bit 1: vector path allowed.
// Rows are sorted by offset and tile the arena without gaps (exact packing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int64_t kTile = int64_t(kThreads) * kVec * 4;  // arena elements per block
constexpr int kCols = 6;
constexpr int64_t kFlagBF16 = 1;
constexpr int64_t kFlagVec = 2;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ int first_entry(const int64_t* table, int n, int64_t pos) {
  // First row whose span ends after ``pos``.
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    const int64_t* e = table + int64_t(mid) * kCols;
    if (e[3] + e[4] > pos) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__device__ __forceinline__ float load1(const void* p, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store1(void* p, int64_t i, float x, bool bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else static_cast<float*>(p)[i] = x;
}

union BF16x8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

// 8 elements starting at p[i]; i is a multiple of 8 and p 16-byte aligned.
__device__ __forceinline__ void load8(const void* p, int64_t i, bool bf16, float (&x)[8]) {
  if (bf16) {
    BF16x8 v;
    v.u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + i);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = __bfloat162float(v.h[k]);
  } else {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    float4 a = q[0], b = q[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

__device__ __forceinline__ void store8(void* p, int64_t i, const float (&x)[8], bool bf16) {
  if (bf16) {
    BF16x8 v;
#pragma unroll
    for (int k = 0; k < 8; ++k) v.h[k] = __float2bfloat16_rn(x[k]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p) + i) = v.u;
  } else {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(p) + i);
    q[0] = make_float4(x[0], x[1], x[2], x[3]);
    q[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// One element: x = f32(g) (+ r); w = cast_wire(x); r' = x - f32(w).
// Returns f32(w); writes r' under EF.
__device__ __forceinline__ float pack_value(float g, bool ef, const float* rin, float* rout,
                                            int64_t j, bool wire_bf16) {
  float x = ef ? __fadd_rn(g, rin[j]) : g;
  float w = wire_bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
  if (ef) rout[j] = __fsub_rn(x, w);
  return w;
}

// Pack part coordinates [j0, j1) of one table row.
__device__ void pack_span(const int64_t* e, void* arena, bool wire_bf16, bool ef,
                          int64_t j0, int64_t j1) {
  const void* src = reinterpret_cast<const void*>(e[0]);
  const float* rin = reinterpret_cast<const float*>(e[1]);
  float* rout = reinterpret_cast<float*>(e[2]);
  const int64_t off = e[3];
  const bool src_bf16 = e[5] & kFlagBF16;
  int64_t v0 = j1, v1 = j1;  // vector body [v0, v1); scalar head/tail around it
  if (e[5] & kFlagVec) {
    v0 = min64(j1, (j0 + kVec - 1) / kVec * kVec);
    v1 = max64(v0, j1 / kVec * kVec);
  }
  for (int64_t j = j0 + threadIdx.x; j < v0; j += blockDim.x) {
    float w = pack_value(load1(src, j, src_bf16), ef, rin, rout, j, wire_bf16);
    store1(arena, off + j, w, wire_bf16);
  }
  for (int64_t j = v0 + int64_t(threadIdx.x) * kVec; j < v1; j += int64_t(blockDim.x) * kVec) {
    float x[8], r[8], w[8];
    load8(src, j, src_bf16, x);
    if (ef) load8(rin, j, false, r);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float a = ef ? __fadd_rn(x[k], r[k]) : x[k];
      w[k] = wire_bf16 ? __bfloat162float(__float2bfloat16_rn(a)) : a;
      r[k] = __fsub_rn(a, w[k]);
    }
    store8(arena, off + j, w, wire_bf16);
    if (ef) store8(rout, j, r, false);
  }
  for (int64_t j = v1 + threadIdx.x; j < j1; j += blockDim.x) {
    float w = pack_value(load1(src, j, src_bf16), ef, rin, rout, j, wire_bf16);
    store1(arena, off + j, w, wire_bf16);
  }
}

// Unpack part coordinates [j0, j1) of one table row.
__device__ void unpack_span(const int64_t* e, const void* arena, bool wire_bf16, float scale,
                            int64_t j0, int64_t j1) {
  void* dst = reinterpret_cast<void*>(e[0]);
  const int64_t off = e[3];
  const bool dst_bf16 = e[5] & kFlagBF16;
  int64_t v0 = j1, v1 = j1;
  if (e[5] & kFlagVec) {
    v0 = min64(j1, (j0 + kVec - 1) / kVec * kVec);
    v1 = max64(v0, j1 / kVec * kVec);
  }
  for (int64_t j = j0 + threadIdx.x; j < v0; j += blockDim.x)
    store1(dst, j, __fmul_rn(load1(arena, off + j, wire_bf16), scale), dst_bf16);
  for (int64_t j = v0 + int64_t(threadIdx.x) * kVec; j < v1; j += int64_t(blockDim.x) * kVec) {
    float x[8];
    load8(arena, off + j, wire_bf16, x);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = __fmul_rn(x[k], scale);
    store8(dst, j, x, dst_bf16);
  }
  for (int64_t j = v1 + threadIdx.x; j < j1; j += blockDim.x)
    store1(dst, j, __fmul_rn(load1(arena, off + j, wire_bf16), scale), dst_bf16);
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const int64_t* table, int n, void* arena, int64_t arena_size, bool wire_bf16, bool ef) {
  const int64_t t0 = int64_t(blockIdx.x) * kTile;
  const int64_t t1 = min64(t0 + kTile, arena_size);
  for (int k = first_entry(table, n, t0); k < n; ++k) {
    const int64_t* e = table + int64_t(k) * kCols;
    if (e[3] >= t1) break;
    const int64_t a = max64(t0, e[3]), b = min64(t1, e[3] + e[4]);
    if (a < b) pack_span(e, arena, wire_bf16, ef, a - e[3], b - e[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const int64_t* table, int n, const void* arena, int64_t arena_size, bool wire_bf16,
              float scale) {
  const int64_t t0 = int64_t(blockIdx.x) * kTile;
  const int64_t t1 = min64(t0 + kTile, arena_size);
  for (int k = first_entry(table, n, t0); k < n; ++k) {
    const int64_t* e = table + int64_t(k) * kCols;
    if (e[3] >= t1) break;
    const int64_t a = max64(t0, e[3]), b = min64(t1, e[3] + e[4]);
    if (a < b) unpack_span(e, arena, wire_bf16, scale, a - e[3], b - e[3]);
  }
}

int grid_for(long long arena_size, unsigned* blocks) {
  const long long g = (arena_size + kTile - 1) / kTile;
  if (g <= 0 || g > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  *blocks = unsigned(g);
  return 0;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int comm_pack_pack(const int64_t* table, int n, void* arena, long long arena_size,
                              int wire_bf16, int ef, void* stream) {
  unsigned blocks = 0;
  if (int err = grid_for(arena_size, &blocks)) return err;
  pack_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n, arena, arena_size, wire_bf16 != 0, ef != 0);
  return int(cudaGetLastError());
}

extern "C" int comm_pack_unpack(const int64_t* table, int n, const void* arena,
                                long long arena_size, int wire_bf16, float scale, void* stream) {
  unsigned blocks = 0;
  if (int err = grid_for(arena_size, &blocks)) return err;
  unpack_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n, arena, arena_size, wire_bf16 != 0, scale);
  return int(cudaGetLastError());
}

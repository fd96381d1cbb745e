// Flash attention for Hopper (sm_90a) on the tensor cores: the forward, dQ and
// dK/dV for bf16 q, k, v and dO.
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention/ for bf16
// inputs (f32 inputs keep flash_fwd_kernel / flash_dq_kernel / flash_dkv_kernel
// of flash_attention.cu; ops.py picks by dtype):
//   flash_fwd_sm90_kernel                        <- _fwd_kernel (kernel.py:40, :167)
//   flash_dq_sm90_kernel                         <- _dq_kernel  (kernel_bwd.py:53, :185)
//   flash_dkv_sm90_kernel + flash_dkv_sum_kernel <- _dkv_kernel (kernel_bwd.py:89, :212)
//
// What they compute is what flash_attention.cu computes (plain versions in
// ../ref.py): with s = softcap(q k^T * hd^-1/2) under the causal / window mask,
// t = tanh, delta = rowsum(dO * o),
//   o = softmax(s) v,  lse = m + log(l)  (m the row max, l = sum exp(s - m)),
//   p = exp(s - lse),  ds = p * (dO v^T - delta) * (1 - t^2) * hd^-1/2,
//   dq = ds k,  dv = sum over the G query heads of p^T dO,  dk = the same of ds^T q.
// A masked (query, key) pair gets p = 0 by the mask's flag, never by a sentinel,
// so a row that sees no key gets o = 0, lse = m + log(max(l, 1e-30)) = -1e30 and
// dq = 0.  The one change of numbers: p (forward and backward) and ds are formed
// in f32 registers and rounded to bf16 as the operands of the second products
// (o, dq, dk, dv); the forward's l sums the f32 p; every product accumulates in
// f32.
//
// Bound.  At RecurrentGemma's attention (B 1, S 4096, 16 query heads over 1 KV
// head, hd 256, causal, window 2048) the forward does 103 GFLOP, dQ 155 GFLOP and
// dK/dV 206 GFLOP over the visible pairs: 0.10, 0.16 and 0.21 ms at 989 TFLOP/s
// bf16, against ~40 MB of inputs and outputs (12 us at 3.35 TB/s).  At TinyLlama's
// (B 4, S 512, 32 / 4 heads, hd 64, causal) the forward and dQ are bound by their
// 19 / 28 MB (6 / 8 us), dK/dV by its 8.6 GFLOP (9 us).  So all three are
// tensor-core work: every product is a wgmma.
//
// Design.
// - Tiles are 64 rows (queries or keys) by the head dim, bf16, in shared memory in
//   the 128-byte swizzled layout: hd / 64 panels of 64 rows x 128 bytes, the
//   16-byte chunk c of row r stored at chunk c ^ (r % 8).  hd 32 is zero-padded to
//   one 64-wide panel.  wgmma reads one tile both ways through its descriptor:
//   K-major where the head dim is the reduction (S = Q K^T, dP = dO V^T) and
//   N-major where the 64 rows are (O += P V, dQ += dS K, dV += P^T dO,
//   dK += dS^T Q), so nothing is transposed in memory.
// - P and dS never go to shared or device memory.  The accumulator of a 64 x 64
//   product holds, per thread, exactly the elements that the A operand of the next
//   wgmma wants from registers (rows 16 w + l/4 (+8), columns 2 (l%4) (+1) (+8) of
//   each 16-wide step), so they are rounded to bf16 pairs in place and fed as A.
// - Streamed tiles arrive by 16-byte cp.async (zero-filled past the sequence end
//   and past hd) into two stages: the next tile's loads run under the current
//   tile's products.  All threads load and compute (a single-role double buffer).
// - Forward: one block per (128 query rows, q head, b), two warpgroups of 64 query
//   rows each sharing every K/V stage; Q stays resident.  Per key tile each
//   warpgroup forms S = Q K^T with the same m64n64k16 steps as dQ (so the
//   backward recomputes the forward's very s), keeps the row max m and sum l in
//   f32 registers (a row lives in one quad of lanes: two shuffles), rescales O by
//   exp(m_old - m_new) and adds P V.  A warpgroup skips the key tiles that its
//   rows cannot see; the block loops over the tiles that some row of it can see.
//   Shared memory at hd 256: Q 64 KB, 2 stages of K, V 128 KB.  Registers per
//   thread at hd 256: O 128, S 32, P 16.
// - dQ: one warpgroup per block, one block per (64 q rows, q head, b), looping
//   over the 64-key tiles its rows can see.  Q and dO stay resident.  Registers
//   per thread at hd 256: dQ 128, S 32, dP 32.  Shared memory: Q, dO 2 x 32 KB,
//   2 stages of K, V 4 x 32 KB: 192 KB.  Blocks are numbered heavy first (causal:
//   the q tiles that see the most keys); so are the forward's.
// - dK/dV: two warpgroups per block, one block per (64 keys, KV head, b, slice of
//   the G query heads), looping over the slice's heads and the q tiles that see
//   its keys.  At hd 256 dK and dV take 128 registers a thread each, more than one
//   warpgroup can hold beside S and dP, so the work splits by product, not by hd
//   (which would compute S and dP twice): warpgroup 0 computes S^T = K Q^T, forms
//   P^T and dV += P^T dO; warpgroup 1 computes dP^T = V dO^T and, once warpgroup 0
//   has put p (1 - t^2) hd^-1/2 into shared memory (f32, in the accumulator's own
//   thread order: each thread reads back what its twin wrote), dS^T and dK +=
//   dS^T Q.  Each warpgroup holds one 128-register accumulator and one of 32.
//   Shared memory at hd 256: K, V 64 KB, 2 stages of Q, dO 128 KB, p 16 KB, lse
//   and delta 1 KB: 209 KB.  Slices fill the card when Hkv x B is small (MQA: 64
//   k tiles alone are half a wave); each block writes f32 partial dK / dV for its
//   slice, and flash_dkv_sum_kernel adds the slices in slice order and casts.
//   Blocks are numbered heavy first (causal: the k tiles that the most rows see).
// - No atomics and no split over keys: every output has one writer and one
//   summation order, so runs repeat bit for bit.
// Shape, the masks and the score are flash_attention.cu's, copied: each library is
// built from its one source.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                 // rows of every q and k tile
constexpr int kPanelBytes = kTile * 128;  // one 64-wide panel of a tile
constexpr int kDqThreads = 128;           // one warpgroup
constexpr int kDkvThreads = 256;          // two warpgroups
constexpr int kFwdWarpgroups = 2;         // forward: 64 query rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;         // running max of a row that has seen no key yet

struct Shape {
  int B, Sq, Sk, Hq, Hkv, G;
  long long qsb, qss, qsh;  // element strides of q, o, dO, dq: batch, sequence, head
  long long ksb, kss, ksh;  // element strides of k, v
  int causal, window;       // window <= 0: no window
  float scale, softcap;     // softcap <= 0: no softcap
};

// ---------------------------------------------------------------------------
// wgmma wrappers: m64nNk16, bf16 operands, f32 accumulators.  A is K-major from
// shared memory (ss) or registers (rs); B is K-major (TB = 0) or N-major (TB = 1).
// ---------------------------------------------------------------------------

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d += A (smem, K-major) . B (smem, K-major when TB = 0, N-major when TB = 1)
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TB));
  }
  // d += A (registers, the accumulator layout of a 64-row product) . B (smem, TB as above)
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  // d += A (registers, the accumulator layout of a 64-row product) . B (smem, TB as above)
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct Wgmma<256> {
  // d += A (registers, the accumulator layout of a 64-row product) . B (smem, TB as above)
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};


__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from touching an accumulator across the asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a 128-byte swizzled operand at shared address addr (8-row groups
// 1024 bytes apart).  K-major: the reduction runs along the 128-byte rows (LBO
// unused).  N-major: the reduction runs down the rows, and the N dimension steps
// from one 64-wide panel to the next (LBO = one panel).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}
__device__ __forceinline__ uint64_t desc_nmajor(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(kPanelBytes >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// Step kk (16 head-dim columns) of a tile read K-major; step kk (16 rows) read N-major.
__device__ __forceinline__ uint64_t tile_k(uint32_t tile, int kk) {
  return desc_kmajor(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32);
}
__device__ __forceinline__ uint64_t tile_n(uint32_t tile, int kk) {
  return desc_nmajor(tile + kk * 16 * 128);
}

// Byte offset of 16-byte chunk c (8 head-dim columns) of row r in a swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * kPanelBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// The cp.async writes of this thread, then the block's, visible to wgmma (async proxy).
__device__ __forceinline__ void tiles_ready() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Rows [row0, row0 + 64) of one head into a swizzled tile; rows at or past n and
// columns at or past HD read as 0.
template <int HD, int HDP, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ src,
                                          long long base, long long row_stride, int row0, int n,
                                          int tid) {
  constexpr int CH = HDP / 8;
#pragma unroll 4
  for (int idx = tid; idx < kTile * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH, s = row0 + r;
    const bool ok = s < n && c * 8 < HD;
    cp_async16(dst + swz(r, c), ok ? src + base + s * row_stride + c * 8 : src, ok);
  }
}

__device__ __forceinline__ bool visible(const Shape& p, int qpos, int kpos) {
  return qpos < p.Sq && kpos < p.Sk && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// Scaled (and soft-capped) score of one dot product; *dcap = d(score)/d(scaled dot).
__device__ __forceinline__ float score(const Shape& p, float dot, float* dcap) {
  const float s = dot * p.scale;
  if (p.softcap > 0.f) {
    const float t = tanhf(s / p.softcap);
    *dcap = 1.f - t * t;
    return t * p.softcap;
  }
  *dcap = 1.f;
  return s;
}

// Keys [*lo, *hi) that some row of [q0, q1) can see.
__device__ __forceinline__ void key_range(const Shape& p, int q0, int q1, int* lo, int* hi) {
  *lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  *hi = p.causal ? min(p.Sk, q1) : p.Sk;
}

// Query rows [*lo, *hi) that can see some key of [k0, k1).
__device__ __forceinline__ void query_range(const Shape& p, int k0, int k1, int* lo, int* hi) {
  *lo = p.causal ? k0 : 0;
  *hi = p.window > 0 ? min(p.Sq, k1 - 1 + p.window) : p.Sq;
}

// 64-row tiles covering [lo, hi): the first one and how many.
__device__ __forceinline__ int tiles_of(int lo, int hi, int* first) {
  *first = lo / kTile;
  return hi > lo ? (hi - 1) / kTile - *first + 1 : 0;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 64 x 64 accumulator x (rows 16 w + l/4 (+8), columns 8 j + 2 (l%4) (+1) for
// x[4 j .. 4 j + 3]) as bf16 A operands of four 16-deep steps.
__device__ __forceinline__ void to_operand(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// Row (within the 64) and column of accumulator element i of this thread.
__device__ __forceinline__ int acc_row(int warp, int lane, int i) {
  return 16 * warp + (lane >> 2) + ((i & 2) ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int lane, int i) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); }

template <int HD>
struct Dims {
  static constexpr int HDP = HD < 64 ? 64 : HD;   // padded to one panel
  static constexpr int TB = kTile * HDP * 2;       // bytes of one tile
  static constexpr int KS = HDP / 16;              // 16-deep steps over the head dim
  static constexpr size_t dq_smem = 6 * TB + 1024;  // Q, dO, 2 x (K, V), alignment
  static constexpr size_t dkv_smem = 6 * TB + 32 * 128 * 4 + 4 * kTile * 4 + 1024;
  static constexpr size_t fwd_smem = (kFwdWarpgroups + 4) * TB + 1024;  // Q, 2 x (K, V), alignment
};

// Max and sum over the quad of lanes that holds one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
__global__ void __launch_bounds__(128 * kFwdWarpgroups, 1)
flash_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      Shape p, int n_qt) {
  using D = Dims<HD>;
  constexpr int HDP = D::HDP, TB = D::TB, NWG = kFwdWarpgroups, NT = 128 * NWG, BQ = kTile * NWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q tiles, then the K/V stages
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x % (p.Hq * p.B), t = blockIdx.x / (p.Hq * p.B);
  const int q0 = (p.causal ? n_qt - 1 - t : t) * BQ;  // heavy tiles first
  const int h = bh % p.Hq, b = bh / p.Hq;
  const long long qbase = b * p.qsb + h * p.qsh;
  const long long kbase = b * p.ksb + (h / p.G) * p.ksh;
  const int qw = q0 + wg * kTile;  // this warpgroup's first row
  const uint32_t sQ = base + wg * TB;

  int lo, hi, kt0, wlo, whi;
  key_range(p, q0, min(q0 + BQ, p.Sq), &lo, &hi);
  const int n_it = tiles_of(lo, hi, &kt0);
  key_range(p, qw, min(qw + kTile, p.Sq), &wlo, &whi);  // keys this warpgroup's rows see
  if (qw >= p.Sq) whi = wlo;
  const bool rows_whole = qw + kTile <= p.Sq;  // all 64 rows of this warpgroup exist

  float acc[HDP / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;

  auto load_kv = [&](int it) {
    const uint32_t sK = base + (NWG + 2 * (it & 1)) * TB;
    const int k0 = (kt0 + it) * kTile;
    load_tile<HD, HDP, NT>(sK, k, kbase, p.kss, k0, p.Sk, tid);
    load_tile<HD, HDP, NT>(sK + TB, v, kbase, p.kss, k0, p.Sk, tid);
  };
  if (n_it > 0) {
#pragma unroll
    for (int w = 0; w < NWG; ++w)
      load_tile<HD, HDP, NT>(base + w * TB, q, qbase, p.qss, q0 + w * kTile, p.Sq, tid);
    load_kv(0);
    cp_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    const uint32_t sK = base + (NWG + 2 * (it & 1)) * TB, sV = sK + TB;
    const int k0 = (kt0 + it) * kTile;
    if (it + 1 < n_it) {  // the other stage was released at the end of the last step
      load_kv(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    tiles_ready();

    if (k0 < whi && k0 + kTile > wlo) {  // uniform over the warpgroup
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D::KS; ++kk) Wgmma<64>::ss<0>(s, tile_k(sQ, kk), tile_k(sK, kk));
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      // every pair of the tile visible to every row: no test per pair
      const bool whole = rows_whole && k0 + kTile <= p.Sk &&
                         (!p.causal || k0 + kTile - 1 <= qw) &&
                         (p.window <= 0 || qw + kTile - 1 - k0 < p.window);
      uint32_t vis = 0;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float dc;
        s[i] = score(p, s[i], &dc);
        if (whole || visible(p, qw + acc_row(warp, lane, i), k0 + acc_col(lane, i))) {
          vis |= 1u << i;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      }
      float corr[2], ml[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        ml[r] = mx[r] * kLog2e;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = (vis >> i) & 1u ? exp2f(fmaf(s[i], kLog2e, -ml[r])) : 0.f;  // P
        rs[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      uint32_t a[4][4];
      to_operand(s, a);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<HDP>::template rs<1>(acc, a[kk], tile_n(sV, kk));
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
    }
    __syncthreads();  // this stage is free for the step after next
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);  // a row that sees no key: acc = 0
  }
#pragma unroll
  for (int i = 0; i < HDP / 2; i += 2) {
    const int qpos = qw + acc_row(warp, lane, i), col = acc_col(lane, i), r = (i >> 1) & 1;
    if (qpos < p.Sq && col < HD)
      *reinterpret_cast<__nv_bfloat162*>(o + qbase + qpos * p.qss + col) =
          __floats2bfloat162_rn(acc[i] * inv[r], acc[i + 1] * inv[r]);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qw + acc_row(warp, lane, 2 * r);
      if (qpos < p.Sq)
        lse[(static_cast<long long>(b) * p.Sq + qpos) * p.Hq + h] = m[r] + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_dq_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, Shape p, int n_qt) {
  using D = Dims<HD>;
  constexpr int HDP = D::HDP, TB = D::TB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = base + TB;  // stage st: K at base + (2 + 2 st) TB, V after it
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x % (p.Hq * p.B), t = blockIdx.x / (p.Hq * p.B);
  const int q0 = (p.causal ? n_qt - 1 - t : t) * kTile;  // heavy tiles first
  const int h = bh % p.Hq, b = bh / p.Hq;
  const long long qbase = b * p.qsb + h * p.qsh;
  const long long kbase = b * p.ksb + (h / p.G) * p.ksh;

  float L[2], Dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + acc_row(warp, lane, 2 * i);
    const long long row = (static_cast<long long>(b) * p.Sq + qpos) * p.Hq + h;
    L[i] = qpos < p.Sq ? lse[row] : 0.f;
    Dl[i] = qpos < p.Sq ? delta[row] : 0.f;
  }
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;

  int lo, hi, kt0;
  key_range(p, q0, min(q0 + kTile, p.Sq), &lo, &hi);
  const int n_it = tiles_of(lo, hi, &kt0);
  auto load_kv = [&](int it) {
    const uint32_t sK = base + (2 + 2 * (it & 1)) * TB;
    const int k0 = (kt0 + it) * kTile;
    load_tile<HD, HDP, kDqThreads>(sK, k, kbase, p.kss, k0, p.Sk, tid);
    load_tile<HD, HDP, kDqThreads>(sK + TB, v, kbase, p.kss, k0, p.Sk, tid);
  };
  if (n_it > 0) {
    load_tile<HD, HDP, kDqThreads>(sQ, q, qbase, p.qss, q0, p.Sq, tid);
    load_tile<HD, HDP, kDqThreads>(sO, dout, qbase, p.qss, q0, p.Sq, tid);
    load_kv(0);
    cp_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    const uint32_t sK = base + (2 + 2 * (it & 1)) * TB, sV = sK + TB;
    const int k0 = (kt0 + it) * kTile;
    if (it + 1 < n_it) {  // the other stage was released at the end of the last step
      load_kv(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    tiles_ready();

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D::KS; ++kk) Wgmma<64>::ss<0>(s, tile_k(sQ, kk), tile_k(sK, kk));
#pragma unroll
    for (int kk = 0; kk < D::KS; ++kk) Wgmma<64>::ss<0>(dp, tile_k(sO, kk), tile_k(sV, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i & 2) ? 1 : 0;
      float dc;
      const float x = score(p, s[i], &dc);
      const bool vis = visible(p, q0 + acc_row(warp, lane, i), k0 + acc_col(lane, i));
      const float pr = vis ? expf(x - L[r]) : 0.f;
      dp[i] = pr * (dp[i] - Dl[r]) * dc * p.scale;  // dS
    }
    uint32_t a[4][4];
    to_operand(dp, a);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<HDP>::template rs<1>(acc, a[kk], tile_n(sK, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    __syncthreads();  // this stage is free for the step after next
  }

#pragma unroll
  for (int i = 0; i < HDP / 2; i += 2) {
    const int qpos = q0 + acc_row(warp, lane, i), col = acc_col(lane, i);
    if (qpos < p.Sq && col < HD)
      *reinterpret_cast<__nv_bfloat162*>(dq + qbase + qpos * p.qss + col) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_dkv_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk_part, float* __restrict__ dv_part, Shape p, int ns) {
  using D = Dims<HD>;
  constexpr int HDP = D::HDP, TB = D::TB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + TB;  // stage st: Q at base + (2 + 2 st) TB, dO after it
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  float* const sP = reinterpret_cast<float*>(gbase + 6 * TB);  // [32][128]
  float* const sRows = sP + 32 * 128;                             // [stage][lse 64, delta 64]
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31;
  const int per = p.Hkv * p.B * ns;
  const int k0 = (blockIdx.x / per) * kTile;  // heavy tiles first (causal: low k0)
  int rem = blockIdx.x % per;
  const int slice = rem % ns;
  rem /= ns;
  const int hk = rem % p.Hkv, b = rem / p.Hkv;
  const int gs = p.G / ns, g0 = slice * gs;
  const long long kbase = b * p.ksb + hk * p.ksh;

  float acc[HDP / 2];  // dV in warpgroup 0, dK in warpgroup 1
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;

  int lo, hi, qt0;
  query_range(p, k0, min(k0 + kTile, p.Sk), &lo, &hi);
  const int nq = tiles_of(lo, hi, &qt0);
  const int n_it = gs * nq;
  auto load_q = [&](int it) {
    const int st = it & 1, h = hk * p.G + g0 + it / nq, q0 = (qt0 + it % nq) * kTile;
    const long long qbase = b * p.qsb + h * p.qsh;
    const uint32_t sQ = base + (2 + 2 * st) * TB;
    load_tile<HD, HDP, kDkvThreads>(sQ, q, qbase, p.qss, q0, p.Sq, tid);
    load_tile<HD, HDP, kDkvThreads>(sQ + TB, dout, qbase, p.qss, q0, p.Sq, tid);
    if (tid < 2 * kTile) {
      const int qpos = q0 + (tid & (kTile - 1));
      const bool ok = qpos < p.Sq;
      const long long row = ok ? (static_cast<long long>(b) * p.Sq + qpos) * p.Hq + h : 0;
      cp_async4(smem_u32(sRows + st * 2 * kTile + tid), (tid < kTile ? lse : delta) + row, ok);
    }
  };
  if (n_it > 0) {
    load_tile<HD, HDP, kDkvThreads>(sK, k, kbase, p.kss, k0, p.Sk, tid);
    load_tile<HD, HDP, kDkvThreads>(sV, v, kbase, p.kss, k0, p.Sk, tid);
    load_q(0);
    cp_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, q0 = (qt0 + it % nq) * kTile;
    const uint32_t sQ = base + (2 + 2 * st) * TB, sO = sQ + TB;
    const float* const rows = sRows + st * 2 * kTile;  // lse, then delta
    if (it + 1 < n_it) {
      load_q(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    tiles_ready();

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): rows are keys,
    // columns query rows
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    const uint32_t sA = wg ? sV : sK, sB = wg ? sO : sQ;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D::KS; ++kk) Wgmma<64>::ss<0>(x, tile_k(sA, kk), tile_k(sB, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(x);

    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = acc_col(lane, i);
        float dc;
        const float sc = score(p, x[i], &dc);
        const bool vis = visible(p, q0 + r, k0 + acc_row(warp, lane, i));
        x[i] = vis ? expf(sc - rows[r]) : 0.f;  // P^T
        sP[i * 128 + t] = x[i] * dc * p.scale;
      }
      asm volatile("bar.arrive 1, %0;\n" ::"n"(kDkvThreads) : "memory");
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kDkvThreads) : "memory");
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = sP[i * 128 + t] * (x[i] - rows[kTile + acc_col(lane, i)]);  // dS^T
    }
    uint32_t a[4][4];
    to_operand(x, a);
    const uint32_t sN = wg ? sQ : sO;  // dK += dS^T Q, dV += P^T dO
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<HDP>::template rs<1>(acc, a[kk], tile_n(sN, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    __syncthreads();  // this stage and sP are free
  }

  // f32 partials [ns][B][Sk][Hkv][HD] of this slice
  float* const part = wg ? dk_part : dv_part;
#pragma unroll
  for (int i = 0; i < HDP / 2; i += 2) {
    const int kpos = k0 + acc_row(warp, lane, i), col = acc_col(lane, i);
    if (kpos < p.Sk && col < HD) {
      const long long idx =
          ((static_cast<long long>(slice * p.B + b) * p.Sk + kpos) * p.Hkv + hk) * HD + col;
      *reinterpret_cast<float2*>(part + idx) = make_float2(acc[i], acc[i + 1]);
    }
  }
}

// dk, dv (bf16, n4 groups of 4) = the sum of the ns slices' partials, slice 0 first.
__global__ void __launch_bounds__(256)
flash_dkv_sum_kernel(const float4* __restrict__ dk_part, const float4* __restrict__ dv_part,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, long long n4, int ns) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += gridDim.x * 256ll) {
    float4 a = dk_part[i], c = dv_part[i];
    for (int s = 1; s < ns; ++s) {
      const float4 x = dk_part[s * n4 + i], y = dv_part[s * n4 + i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    __nv_bfloat162* const ok = reinterpret_cast<__nv_bfloat162*>(dk + 4 * i);
    __nv_bfloat162* const ov = reinterpret_cast<__nv_bfloat162*>(dv + 4 * i);
    ok[0] = __floats2bfloat162_rn(a.x, a.y);
    ok[1] = __floats2bfloat162_rn(a.z, a.w);
    ov[0] = __floats2bfloat162_rn(c.x, c.y);
    ov[1] = __floats2bfloat162_rn(c.z, c.w);
  }
}

int n_tiles(int n) { return (n + kTile - 1) / kTile; }

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& p,
               cudaStream_t stream) {
  constexpr size_t smem = Dims<HD>::fwd_smem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  constexpr int BQ = kTile * kFwdWarpgroups;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  flash_fwd_sm90_kernel<HD><<<n_qt * p.Hq * p.B, 128 * kFwdWarpgroups, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, p, n_qt);
  return int(cudaGetLastError());
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, const Shape& p, cudaStream_t stream) {
  constexpr size_t smem = Dims<HD>::dq_smem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dq_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  const int n_qt = n_tiles(p.Sq);
  flash_dq_sm90_kernel<HD><<<n_qt * p.Hq * p.B, kDqThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), p, n_qt);
  return int(cudaGetLastError());
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, float* dk_part, float* dv_part, void* dk, void* dv,
               const Shape& p, int ns, cudaStream_t stream) {
  constexpr size_t smem = Dims<HD>::dkv_smem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  flash_dkv_sm90_kernel<HD><<<n_tiles(p.Sk) * p.Hkv * p.B * ns, kDkvThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, dk_part, dv_part, p, ns);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long n4 = static_cast<long long>(p.B) * p.Sk * p.Hkv * HD / 4;
  const long long want = (n4 + 255) / 256;
  const int blocks = int(want < 132 * 16 ? want : 132 * 16);
  flash_dkv_sum_kernel<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dk_part), reinterpret_cast<const float4*>(dv_part),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n4, ns);
  return int(cudaGetLastError());
}

Shape make_shape(const int* dims, const long long* strides, int causal, int window, float scale,
                 float softcap) {
  Shape p;
  p.B = dims[0];
  p.Sq = dims[1];
  p.Sk = dims[2];
  p.Hq = dims[3];
  p.Hkv = dims[4];
  p.G = dims[4] > 0 ? dims[3] / dims[4] : 0;
  p.qsb = strides[0];
  p.qss = strides[1];
  p.qsh = strides[2];
  p.ksb = strides[3];
  p.kss = strides[4];
  p.ksh = strides[5];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  return p;
}

bool valid(const Shape& p) {
  return p.B > 0 && p.Sq > 0 && p.Sk > 0 && p.Hkv > 0 && p.Hq % p.Hkv == 0 &&
         (p.qss | p.qsh | p.qsb | p.kss | p.ksh | p.ksb) % 8 == 0;  // 16-byte rows
}

}  // namespace

// dims = {B, Sq, Sk, Hq, Hkv, hd}; strides = {q batch, q seq, q head, k batch, k seq,
// k head} in elements (the last axis is contiguous; o, dO and dq share q's strides,
// v shares k's), multiples of 8, and every pointer 16-byte aligned; lse and delta
// are (B, Sq, Hq) f32, contiguous.  All tensors bf16 but lse, delta and the partials.
// Each returns the cudaError_t of its launches (0 on success).
#define SM90_DISPATCH(FN, ...)                   \
  switch (dims[5]) {                             \
    case 32: return FN<32>(__VA_ARGS__);         \
    case 64: return FN<64>(__VA_ARGS__);         \
    case 128: return FN<128>(__VA_ARGS__);       \
    case 256: return FN<256>(__VA_ARGS__);       \
    default: return int(cudaErrorInvalidValue);  \
  }

extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                              const int* dims, const long long* strides, int causal, int window,
                              float scale, float softcap, void* stream) {
  const Shape p = make_shape(dims, strides, causal, window, scale, softcap);
  if (!valid(p)) return int(cudaErrorInvalidValue);
  SM90_DISPATCH(launch_fwd, q, k, v, o, lse, p, static_cast<cudaStream_t>(stream))
}

extern "C" int flash_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dq, const int* dims,
                             const long long* strides, int causal, int window, float scale,
                             float softcap, void* stream) {
  const Shape p = make_shape(dims, strides, causal, window, scale, softcap);
  if (!valid(p)) return int(cudaErrorInvalidValue);
  SM90_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, p, static_cast<cudaStream_t>(stream))
}

// dk_part and dv_part: f32 scratch of ns x B x Sk x Hkv x hd each; ns divides G.
extern "C" int flash_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, float* dk_part,
                              float* dv_part, void* dk, void* dv, int ns, const int* dims,
                              const long long* strides, int causal, int window, float scale,
                              float softcap, void* stream) {
  const Shape p = make_shape(dims, strides, causal, window, scale, softcap);
  if (!valid(p) || ns < 1 || p.G % ns != 0) return int(cudaErrorInvalidValue);
  SM90_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk_part, dv_part, dk, dv, p, ns,
               static_cast<cudaStream_t>(stream))
}

// RG-LRU diagonal linear recurrence, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/rglru/:
//   rglru_fwd_kernel,  <- _rglru_kernel / rglru_pallas   (kernel.py:31, :72, pallas_call :91)
//   rglru_step_kernel     (the tiled and the short-T kernel of the forward)
//   rglru_bwd_kernel      its gradient; the JAX package has no kernel for it (JAX
//                         differentiates jax.lax.associative_scan itself)
//
// What they compute (the plain versions are in ../ref.py).  a, g, h are (B, T, W)
// f32, h0 and hT are (B, W) f32, h0 absent means 0:
//   forward   h_t = a_t h_{t-1} + g_t   (h_{-1} = h0),   hT = h_{T-1}
//   backward  from dh = dL/dh and dhT = dL/dhT (absent: 0), in reverse time
//             dg_{T-1} = dh_{T-1} + dhT,   dg_t = dh_t + a_{t+1} dg_{t+1}
//             da_t = dg_t h_{t-1}   (h_{-1} = h0, or 0),   dh0 = a_0 dg_0
// The backward is the forward's recurrence run in reverse, with multiplier
// a_{t+1} (1 at the last step) and input dh_t, plus da fused into its second pass.
//
// Bound.  Each kernel reads and writes every element once: the forward moves
// 3 x 4 B per (b, t, w) (a, g in; h out), the backward 5 x 4 B (a, h, dh in; da,
// dg out).  At the training shape (1, 4096, 4096) that is 201 MB and 335 MB,
// 0.060 and 0.100 ms at 3.35 TB/s (a plain device copy of as many bytes reaches
// ~3.0 TB/s); the arithmetic (a few FMAs per element) is far below the f32 rate.
// So training and prefill are bound by device memory, and the decode step (T 1,
// 0.33 MB) by the launch and one round trip to memory.
//
// Two kernels for the forward, chosen by T alone (never by B, so that a row's
// bits do not depend on the rows batched with it):
//
// T <= kStepMaxT (12): rglru_step_kernel (the decode step, T = 1).  Each thread
//   owns 4 adjacent channels (16-byte loads and stores; 1 channel where W is not
//   a multiple of 4 or a pointer is not 16-byte aligned, with the same
//   arithmetic) and walks T sequentially with one fmaf a step: no shared memory,
//   no barrier, no combine, so the launch and one round trip to memory are all
//   it costs.  Its h_t for t < 16 are the bits of the tiled kernel's first
//   chunk, which starts from h0 and walks the same fmafs: at T = 1 both give
//   fmaf(a, h0, g), the decode step's bits before the step kernel.  The threshold
//   is measured (python -m repro_torch.kernels.rglru.compare, with builds of this
//   file whose kStepMaxT is 0 and 64): at B = 1 the step kernel wins through
//   T = 12 and loses at 16, where one thread's serial walk leaves too few loads
//   in flight; at B = 4 it wins through 64, but a choice by B would let a row's
//   bits depend on its batch.
//
// T > kStepMaxT: rglru_fwd_kernel (training, T = 4096; prefill, T up to 2304).
//   The main path has only B x W = 4096 independent channels, so one thread per
//   channel walking 4096 dependent steps would fill 32 of the card's 132 SMs.  So
//   T is split too:
//   - a block owns kLanes = 32 adjacent channels (each time step of a tile is one
//     128-byte row) and walks T in tiles of 16 chunks x 16 steps;
//   - the tiles arrive through a 2-stage ring in shared memory (128 KB of a and
//     g), filled by 16-byte cp.async copies (4-byte where W is ragged) one tile
//     ahead: the next tile's loads are in flight while this one combines,
//     rescans and stores.  With 128 blocks for 132 SMs at B x W = 4096, one
//     block a SM, loads straight into registers left each SM waiting on memory
//     between tiles;
//   - in each tile, thread (lane, c) takes chunk c's 16 steps of its channel from
//     the ring into registers and folds them into the chunk's aggregate (A, G):
//     h_out = A h_in + G;
//   - the threads of chunk 0 combine the 16 aggregates in shared memory, in chunk
//     order, from the tile's carry-in, giving each chunk its carry-in;
//   - each thread rescans its registers from that carry-in, sequentially, and
//     writes h; the last chunk's last value is the next tile's carry-in, and the
//     thread that computes h_{T-1} writes it as hT.
//
// The backward, rglru_bwd_kernel, runs only in training (T 128 to 4096) and
// walks tiles and chunks the same way in reverse order, its 48 loads a thread
// straight from device memory into registers, all independent: enough bytes in
// flight to run within ~10% of a plain device copy of its bytes, so its design
// is kept as it was.
//
// One order of operations in each kernel, no atomics: every run gives the same
// bits (activation checkpointing reruns the forward, and the data-parallel issue
// orders must stay bitwise equal).  The chunk aggregates reassociate the carry
// against a strictly sequential loop, which changes results in the last bits
// only.  The ring changes where a value waits, not the arithmetic (each
// multiply-add of the forward an fmaf, as nvcc contracted it before), so both
// tiled kernels give the bits of the kernels before it.  Steps past T are padded with the identity
// (a = 1, g = 0) and not stored; channels past W are not loaded or stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kStepMaxT = 12;              // longest T the step kernel takes
constexpr int kStepThreads = 128;
constexpr int kLanes = 32;                 // channels per block of the tiled kernels
constexpr int kChunks = 16;                // time chunks per tile (blockDim.y)
constexpr int kSteps = 16;                 // steps per chunk, held in registers
constexpr int kTile = kChunks * kSteps;    // steps per tile
constexpr int kThreads = kLanes * kChunks;
constexpr int kStages = 2;                 // tiles in the forward's ring
constexpr int kStageRows = kTile * kLanes;  // floats of one array in one stage
constexpr size_t kFwdSmem = size_t(kStages) * 2 * kStageRows * sizeof(float);

// ------------------------------------------------------------------ cp.async

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy rows [t0, t0 + kTile) of channels [w0, w0 + kLanes) into a stage (row r of
// the stage is time step t0 + r).  Rows past T and channels past W are not
// copied (the reader substitutes for them).
template <int VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int t0, int T, int W,
                                           int w0, int tid) {
  constexpr int kPerRow = kLanes / VEC;
#pragma unroll
  for (int p = tid; p < kTile * kPerRow; p += kThreads) {
    const int r = p / kPerRow, col = (p % kPerRow) * VEC;
    if (t0 + r < T && w0 + col < W)
      cp_async<VEC>(dst + r * kLanes + col, src + (long long)(t0 + r) * W + w0 + col);
  }
}

// ------------------------------------------------------------------ tiled kernels

template <int VEC>
__global__ void __launch_bounds__(kThreads)
rglru_fwd_kernel(const float* __restrict__ a, const float* __restrict__ g,
                 const float* __restrict__ h0, float* __restrict__ h, float* __restrict__ hT,
                 int T, int W) {
  extern __shared__ __align__(16) float ring[];  // [kStages][a, g][kTile][kLanes]
  __shared__ float sA[kChunks][kLanes], sG[kChunks][kLanes], sC[kChunks][kLanes];
  __shared__ float s_carry[kLanes];
  const int lane = threadIdx.x, c = threadIdx.y, tid = c * kLanes + lane;
  const int w0 = blockIdx.x * kLanes, w = w0 + lane;
  const bool live = w < W;
  const long long row = (long long)blockIdx.y * W + w;    // (b, w) in (B, W)
  const long long bt = (long long)blockIdx.y * T * W;     // (b, 0, 0) in (B, T, W)
  const long long base = bt + w;                          // (b, 0, w)
  const int n_tiles = (T + kTile - 1) / kTile;
  auto issue = [&](int k) {  // tile k's a and g into stage k % kStages
    float* st = ring + (k % kStages) * 2 * kStageRows;
    stage_rows<VEC>(st, a + bt, k * kTile, T, W, w0, tid);
    stage_rows<VEC>(st + kStageRows, g + bt, k * kTile, T, W, w0, tid);
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_tiles) issue(k);
    cp_async_commit();
  }
  if (c == kChunks - 1) s_carry[lane] = (live && h0 != nullptr) ? h0[row] : 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    const int ts = k * kTile + c * kSteps;
    // the stage refilled here was last read before the previous tile's barriers
    if (k + kStages - 1 < n_tiles) issue(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of tile k have landed
    __syncthreads();               // and every thread's
    const float* st = ring + (k % kStages) * 2 * kStageRows;
    float ra[kSteps], rg[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const bool in = live && ts + i < T;
      ra[i] = in ? st[(c * kSteps + i) * kLanes + lane] : 1.f;
      rg[i] = in ? st[kStageRows + (c * kSteps + i) * kLanes + lane] : 0.f;
    }
    float A = 1.f, G = 0.f;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      A *= ra[i];
      G = fmaf(ra[i], G, rg[i]);
    }
    sA[c][lane] = A;
    sG[c][lane] = G;
    __syncthreads();  // aggregates (and the tile's carry-in) are in place
    if (c == 0) {
      float carry = s_carry[lane];
      for (int j = 0; j < kChunks; ++j) {
        sC[j][lane] = carry;
        carry = fmaf(sA[j][lane], carry, sG[j][lane]);
      }
    }
    __syncthreads();  // carry-ins are in place
    float x = sC[c][lane];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      x = fmaf(ra[i], x, rg[i]);
      if (live && ts + i < T) h[base + (long long)(ts + i) * W] = x;
      if (live && ts + i == T - 1) hT[row] = x;
    }
    // a full tile's last step; the next tile's combine reads it after its
    // barriers
    if (c == kChunks - 1) s_carry[lane] = x;
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ h0, const float* __restrict__ dh,
                 const float* __restrict__ dhT, float* __restrict__ da, float* __restrict__ dg,
                 float* __restrict__ dh0, int T, int W) {
  __shared__ float sA[kChunks][kLanes], sG[kChunks][kLanes], sC[kChunks][kLanes];
  const int lane = threadIdx.x, c = threadIdx.y;
  const int w = blockIdx.x * kLanes + lane;
  const bool live = w < W;
  const long long row = (long long)blockIdx.y * W + w;
  const long long base = (long long)blockIdx.y * T * W + w;
  // the carry in reverse time: dg of the step after the tile; held by the
  // threads of chunk 0, which also run the combine
  float carry = (c == 0 && live && dhT != nullptr) ? dhT[row] : 0.f;
  float x = 0.f;
  const int last = ((T - 1) / kTile) * kTile;
  for (int t0 = last; t0 >= 0; t0 -= kTile) {
    const int ts = t0 + c * kSteps;
    float rm[kSteps], rd[kSteps], rh[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = ts + i;
      const bool in = live && t < T;
      rm[i] = (in && t + 1 < T) ? a[base + (long long)(t + 1) * W] : 1.f;
      rd[i] = in ? dh[base + (long long)t * W] : 0.f;
      rh[i] = !in ? 0.f
              : t > 0 ? h[base + (long long)(t - 1) * W]
              : h0 != nullptr ? h0[row] : 0.f;
    }
    float M = 1.f, D = 0.f;
#pragma unroll
    for (int i = kSteps - 1; i >= 0; --i) {
      M *= rm[i];
      D = rm[i] * D + rd[i];
    }
    sA[c][lane] = M;
    sG[c][lane] = D;
    __syncthreads();  // aggregates are in place
    if (c == 0) {
      float y = carry;
      for (int j = kChunks - 1; j >= 0; --j) {
        sC[j][lane] = y;
        y = sA[j][lane] * y + sG[j][lane];
      }
    }
    __syncthreads();  // carry-ins are in place
    x = sC[c][lane];
#pragma unroll
    for (int i = kSteps - 1; i >= 0; --i) {
      x = rm[i] * x + rd[i];
      const int t = ts + i;
      if (live && t < T) {
        dg[base + (long long)t * W] = x;
        da[base + (long long)t * W] = x * rh[i];
      }
    }
    // chunk 0's first step, dg_{t0}, is the carry into the tile before; the
    // next combine rewrites sC only after its first barrier
    carry = x;
  }
  if (c == 0 && live && dh0 != nullptr) dh0[row] = a[base] * x;
}

// ------------------------------------------------------------------ step kernel

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float vfma(float m, float x, float y) { return fmaf(m, x, y); }
__device__ __forceinline__ float4 vfma(float4 m, float4 x, float4 y) {
  return make_float4(fmaf(m.x, x.x, y.x), fmaf(m.y, x.y, y.y), fmaf(m.z, x.z, y.z),
                     fmaf(m.w, x.w, y.w));
}
template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 vzero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// One thread per VEC adjacent channels of one row b: h_t = fmaf(a_t, h_{t-1}, g_t).
template <int VEC>
__global__ void __launch_bounds__(kStepThreads)
rglru_step_kernel(const float* __restrict__ a, const float* __restrict__ g,
                  const float* __restrict__ h0, float* __restrict__ h, float* __restrict__ hT,
                  int T, int W, long long n) {
  using V = typename Vec<VEC>::T;
  const long long i = (long long)blockIdx.x * kStepThreads + threadIdx.x;
  if (i >= n) return;
  const long long e = i * VEC, b = e / W;  // (b, w) in (B, W); VEC divides W
  const long long base = b * T * W + (e - b * W);
  V x = h0 != nullptr ? *reinterpret_cast<const V*>(h0 + e) : vzero<V>();
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const long long o = base + (long long)t * W;
    x = vfma(*reinterpret_cast<const V*>(a + o), x, *reinterpret_cast<const V*>(g + o));
    *reinterpret_cast<V*>(h + o) = x;
  }
  *reinterpret_cast<V*>(hT + e) = x;
}

// ------------------------------------------------------------------ host side

bool valid(int B, int T, int W) { return B > 0 && T > 0 && W > 0 && B <= 65535; }

// 16-byte vectors where W is a multiple of 4 and every pointer 16-byte aligned
bool vec4(int W, std::initializer_list<const void*> ptrs) {
  if (W % 4) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <int VEC>
int launch_step(const float* a, const float* g, const float* h0, float* h, float* hT, int B,
                int T, int W, cudaStream_t stream) {
  const long long n = (long long)B * W / VEC;
  const int blocks = int((n + kStepThreads - 1) / kStepThreads);
  rglru_step_kernel<VEC><<<blocks, kStepThreads, 0, stream>>>(a, g, h0, h, hT, T, W, n);
  return int(cudaGetLastError());
}

template <int VEC>
int launch_tiled(const float* a, const float* g, const float* h0, float* h, float* hT, int B,
                 int T, int W, cudaStream_t stream) {
  // the ring is above 48 KB: set on the library's first use of this kernel, which
  // the engine's prefills make eagerly (never on a CUDA graph's capture path)
  static const cudaError_t attr = cudaFuncSetAttribute(
      rglru_fwd_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kFwdSmem));
  if (attr != cudaSuccess) return int(attr);
  rglru_fwd_kernel<VEC><<<dim3((W + kLanes - 1) / kLanes, B), dim3(kLanes, kChunks), kFwdSmem,
                          stream>>>(a, g, h0, h, hT, T, W);
  return int(cudaGetLastError());
}

}  // namespace

// The longest T for which rglru_fwd takes the step kernel.
extern "C" int rglru_step_max_t() { return kStepMaxT; }

// a, g, h: (B, T, W) f32, contiguous; h0, hT: (B, W) f32, contiguous; h0 may be
// null (a zero initial state).  The step kernel for T <= kStepMaxT, else the
// tiled one.  Returns the cudaError_t of the launch (0 on success).
extern "C" int rglru_fwd(const float* a, const float* g, const float* h0, float* h, float* hT,
                         int B, int T, int W, void* stream) {
  if (!valid(B, T, W)) return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool v4 = vec4(W, {a, g, h0, h, hT});
  if (T <= kStepMaxT)
    return v4 ? launch_step<4>(a, g, h0, h, hT, B, T, W, s)
              : launch_step<1>(a, g, h0, h, hT, B, T, W, s);
  return v4 ? launch_tiled<4>(a, g, h0, h, hT, B, T, W, s)
            : launch_tiled<1>(a, g, h0, h, hT, B, T, W, s);
}

// a, h, dh, da, dg: (B, T, W) f32, contiguous (h is the forward's output); h0, dhT,
// dh0: (B, W) f32, contiguous.  h0 and dhT may be null (zero); dh0 may be null (not
// wanted).  Returns the cudaError_t of the launch (0 on success).
extern "C" int rglru_bwd(const float* a, const float* h, const float* h0, const float* dh,
                         const float* dhT, float* da, float* dg, float* dh0, int B, int T, int W,
                         void* stream) {
  if (!valid(B, T, W)) return int(cudaErrorInvalidValue);
  rglru_bwd_kernel<<<dim3((W + kLanes - 1) / kLanes, B), dim3(kLanes, kChunks), 0,
                      static_cast<cudaStream_t>(stream)>>>(a, h, h0, dh, dhT, da, dg, dh0, T, W);
  return int(cudaGetLastError());
}

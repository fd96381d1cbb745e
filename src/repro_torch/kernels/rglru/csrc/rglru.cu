// RG-LRU diagonal linear recurrence, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/rglru/:
//   rglru_fwd_kernel <- _rglru_kernel / rglru_pallas   (kernel.py:31, :72, pallas_call :91)
//   rglru_bwd_kernel    its gradient; the JAX package has no kernel for it (JAX
//                       differentiates jax.lax.associative_scan itself)
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
// dg out).  At the main path's shape (1, 4096, 4096) that is 201 MB and 335 MB,
// 0.060 and 0.100 ms at 3.35 TB/s; the arithmetic (a few FMAs per element) is far
// below the f32 rate, so both are bound by device memory.
//
// Design.  The TPU kernel walks T sequentially over a grid axis, carrying the
// state in VMEM, with a doubling scan inside each time chunk.  Here the main
// path has only B x W = 4096 independent channels, so one thread per channel
// walking 4096 dependent steps would fill 32 of the card's 132 SMs and wait on
// latency at every step.  So T is split too:
//   - a block owns 32 adjacent channels (one warp wide: each load of a time step
//     is one coalesced 128-byte row) and walks T in tiles of 16 chunks x 16 steps;
//   - in each tile, thread (lane, c) loads chunk c's 16 steps of its channel into
//     registers (all 32 loads independent, so many bytes are in flight) and folds
//     them into the chunk's aggregate (A, G): h_out = A h_in + G;
//   - warp 0 combines the 16 aggregates in shared memory, in chunk order, from
//     the tile's carry-in, giving each chunk its carry-in;
//   - each thread rescans its registers from that carry-in, sequentially, and
//     writes h; the last chunk's last value is the next tile's carry-in, and
//     the thread that computes h_{T-1} writes it as hT.
// The backward does the same over tiles and chunks in reverse order.  One order
// of operations, no atomics: every run gives the same bits (activation
// checkpointing reruns the forward, and the data-parallel issue orders must stay
// bitwise equal).  The chunk aggregates reassociate the carry against a strictly
// sequential loop, which changes results in the last bits only.
// Steps past T are padded with the identity (a = 1, g = 0) and not stored;
// channels past W are not loaded or stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                 // channels per block
constexpr int kChunks = 16;                // time chunks per tile (blockDim.y)
constexpr int kSteps = 16;                 // steps per chunk, held in registers
constexpr int kTile = kChunks * kSteps;    // steps per tile
constexpr int kThreads = kLanes * kChunks;

__global__ void __launch_bounds__(kThreads)
rglru_fwd_kernel(const float* __restrict__ a, const float* __restrict__ g,
                 const float* __restrict__ h0, float* __restrict__ h, float* __restrict__ hT,
                 int T, int W) {
  __shared__ float sA[kChunks][kLanes], sG[kChunks][kLanes], sC[kChunks][kLanes];
  __shared__ float s_carry[kLanes];
  const int lane = threadIdx.x, c = threadIdx.y;
  const int w = blockIdx.x * kLanes + lane;
  const bool live = w < W;
  const long long row = (long long)blockIdx.y * W + w;    // (b, w) in (B, W)
  const long long base = (long long)blockIdx.y * T * W + w;  // (b, 0, w) in (B, T, W)
  if (c == kChunks - 1) s_carry[lane] = (live && h0 != nullptr) ? h0[row] : 0.f;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int ts = t0 + c * kSteps;
    float ra[kSteps], rg[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const bool in = live && ts + i < T;
      ra[i] = in ? a[base + (long long)(ts + i) * W] : 1.f;
      rg[i] = in ? g[base + (long long)(ts + i) * W] : 0.f;
    }
    float A = 1.f, G = 0.f;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      A *= ra[i];
      G = ra[i] * G + rg[i];
    }
    sA[c][lane] = A;
    sG[c][lane] = G;
    __syncthreads();  // aggregates (and the tile's carry-in) are in place
    if (c == 0) {
      float carry = s_carry[lane];
      for (int j = 0; j < kChunks; ++j) {
        sC[j][lane] = carry;
        carry = sA[j][lane] * carry + sG[j][lane];
      }
    }
    __syncthreads();  // carry-ins are in place
    float x = sC[c][lane];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      x = ra[i] * x + rg[i];
      if (live && ts + i < T) h[base + (long long)(ts + i) * W] = x;
      if (live && ts + i == T - 1) hT[row] = x;
    }
    // a full tile's last step; the next tile's combine reads it after its
    // first barrier
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

bool valid(int B, int T, int W) { return B > 0 && T > 0 && W > 0 && B <= 65535; }

dim3 grid_of(int B, int W) { return dim3((W + kLanes - 1) / kLanes, B); }

}  // namespace

// a, g, h: (B, T, W) f32, contiguous; h0, hT: (B, W) f32, contiguous; h0 may be
// null (a zero initial state).  Returns the cudaError_t of the launch (0 on success).
extern "C" int rglru_fwd(const float* a, const float* g, const float* h0, float* h, float* hT,
                         int B, int T, int W, void* stream) {
  if (!valid(B, T, W)) return int(cudaErrorInvalidValue);
  rglru_fwd_kernel<<<grid_of(B, W), dim3(kLanes, kChunks), 0, static_cast<cudaStream_t>(stream)>>>(
      a, g, h0, h, hT, T, W);
  return int(cudaGetLastError());
}

// a, h, dh, da, dg: (B, T, W) f32, contiguous (h is the forward's output); h0, dhT,
// dh0: (B, W) f32, contiguous.  h0 and dhT may be null (zero); dh0 may be null (not
// wanted).  Returns the cudaError_t of the launch (0 on success).
extern "C" int rglru_bwd(const float* a, const float* h, const float* h0, const float* dh,
                         const float* dhT, float* da, float* dg, float* dh0, int B, int T, int W,
                         void* stream) {
  if (!valid(B, T, W)) return int(cudaErrorInvalidValue);
  rglru_bwd_kernel<<<grid_of(B, W), dim3(kLanes, kChunks), 0, static_cast<cudaStream_t>(stream)>>>(
      a, h, h0, dh, dhT, da, dg, dh0, T, W);
  return int(cudaGetLastError());
}

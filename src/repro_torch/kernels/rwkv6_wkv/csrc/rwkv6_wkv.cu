// WKV6 recurrence (RWKV6 "Finch" time mix), forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/rwkv6_wkv/:
//   wkv_fwd_kernel               <- _wkv_kernel / wkv_pallas  (kernel.py:31, :91, pallas_call :117)
//   wkv_bwd_state_kernel,        its gradient; the JAX package has no kernel for it (JAX
//   wkv_bwd_decay_kernel            differentiates the jnp chunked form, models/rwkv6.py:177)
//
// What they compute (the plain versions are in ../ref.py).  Per batch row b and head
// h, over a (K, K) f32 state S from s0 (absent: 0); r, k, v (B, T, H, K) in f32 or
// bf16, w (B, T, H, K) f32 in (0, 1), u (H, K) f32:
//   forward   out_t = r_t·S + (r_t·(u⊙k_t)) v_t,   then S <- diag(w_t) S + k_tᵀ v_t;
//             out (B, T, H, K) f32 and s_final (B, H, K, K) f32.
//   backward  from dout and ds_final (absent: 0), with dS_t the gradient with respect
//             to the state after step t (dS_{T-1} = ds_final):
//     dv_t[v] = Σ_k dS_t[k,v] k_t[k]     + (r_t·(u⊙k_t)) do_t[v]
//     dk_t[k] = Σ_v dS_t[k,v] v_t[v]     + u[k] r_t[k] (do_t·v_t)          (= dkˢ + ...)
//     dr_t[k] = Σ_v S_{t-1}[k,v] do_t[v] + u[k] k_t[k] (do_t·v_t)          (= drˢ + ...)
//     dw_t[k] = Σ_v dS_t[k,v] S_{t-1}[k,v]
//     du[k]   = Σ_{b,t} r_t[k] k_t[k] (do_t·v_t)
//     dS_{t-1} = diag(w_t) dS_t + r_tᵀ do_t,   ds0 = dS_{-1}.
//   dw needs S_{t-1} in a reverse walk.  Recomputing it as (S_t - k_tᵀv_t) / w_t is
//   unstable, so dw goes through the log of the decay: with x_t = r_t ⊙ drˢ_t,
//     dlogw_t = Σ_{m >= t} gb_m,   gb_m = x_{m+1} - k_m ⊙ dkˢ_m   (x_T = 0),
//   plus Σ_v ds_final ⊙ S_{T-1} at m = T-1, and dw_t = dlogw_t / w_t.  Exact for any
//   decay in (0, 1): nothing divides by a cumulative product of decays (the TPU
//   kernel's k / max(W_inc, 1e-30) breaks where a chunk's decay underflows 1e-30).
//
// Design.  Each column v of S evolves on its own in the forward (S[:, v] <- w ⊙ S[:, v]
// + k v[v]), and so does each row k (S[k, :] <- w[k] S[k, :] + k[k] v): the update
// is elementwise.  Only the products reduce, over k for out and dv, over v for dr and
// dk.  So a block owns 32 columns (or rows) of one (b, h) and gives each 8 threads,
// adjacent lanes: a thread keeps K/8 elements of its column (row) in registers, the
// strip {p, p+8, p+16, ...} (p the thread's part), and three xor shuffles sum the 8
// partial products.  K = 64 takes two blocks per (b, h), 128 blocks at the main path's
// B·H = 64.  The block stages 16 steps of r, k, v, w (and dout) as f32 in shared
// memory with coalesced loads, the next tile's loads in flight in registers while the
// current tile is computed; per-step scalars (r·(u⊙k), do·v) are summed by a warp
// each; outputs of a tile are staged and written as 128-byte rows.
//   forward              column layout, forward time: out, s_final.
//   wkv_bwd_state_kernel blockIdx.z = 0: row layout, forward time (recomputes S from
//                        s0): dr, x_t = r_t ⊙ drˢ_t, per-(b, h) du partials and
//                        Σ_v ds_final ⊙ S_{T-1};  blockIdx.z = 1: column layout,
//                        reverse time over dS: dv.
//   wkv_bwd_decay_kernel row layout, reverse time over dS: dk, the dlogw sum, dw,
//                        ds0, and du summed over b in order.
// One fixed order of operations and no atomics: every run gives the same bits
// (activation checkpointing reruns the forward, and the data-parallel issue orders
// must stay bitwise equal).
//
// Bound.  The forward reads r, k, v (2 B each in bf16) and w (4 B) and writes out
// (4 B): 14 B per (b, t, h, k), 235 MB at the main path's (1, 4096, 64, 64), 0.070 ms
// at 3.35 TB/s.  Its arithmetic is 5 FLOP per state element per step (r·S: 2;
// w S + k v: 3), 5.37 GFLOP, 0.080 ms on the f32 CUDA cores (67 TFLOP/s): bound by
// operations.  The backward reads r, k, v, w, dout and writes dr, dk, dv, dw (f32):
// 30 B per element, 503 MB, 0.150 ms; 14 FLOP per state element per step (S
// recomputed: 3, dS: 3, dS·k, dS·v, S·do, dS⊙S: 2 each), 15.0 GFLOP, 0.224 ms: bound
// by operations too.  This simple version runs everything on the CUDA cores in f32,
// one step after another; chunked wgmma tiles are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParts = 8;                  // threads that share one column (row)
constexpr int kOwned = 32;                 // columns (rows) a block owns
constexpr int kThreads = kParts * kOwned;  // 256
constexpr int kTS = 16;                    // time steps staged per tile

enum Role { kFwd, kDr, kDv, kDk };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Sum over the 8 lanes of one part group; every lane gets the same bits (each
// level adds the same two values, in either order).
__device__ __forceinline__ float part_sum(float p) {
  p += __shfl_xor_sync(0xffffffffu, p, 1);
  p += __shfl_xor_sync(0xffffffffu, p, 2);
  p += __shfl_xor_sync(0xffffffffu, p, 4);
  return p;
}

template <typename In>
struct Args {
  const In *r, *k, *v;
  const float *w, *u, *s0, *dout, *dsT;  // dsT: ds_final, may be null; s0 may be null
  float *out, *sT;                       // forward outputs
  float *dr, *dk, *dv, *dw, *du, *ds0;   // backward outputs; ds0 may be null
  float *x;                              // (B, T, H, K): x_t = r_t ⊙ drˢ_t
  float *part;                           // (2, B, H, K): du partials, Σ_v dsT ⊙ S_{T-1}
  int B, T, H;
};

template <int K>
struct Smem {
  float r[kTS][K], k[kTS][K], v[kTS][K], w[kTS][K], d[kTS][K];
  float x[kTS][kOwned];                  // the decay pass's x of the owned rows
  float o0[kTS][kOwned], o1[kTS][kOwned];  // outputs of the owned index, per step
  float sc[kTS];                         // per-step scalar: r·(u⊙k) or do·v
  float u[K];
};

// One role over all of T for the block's (b, h) and its 32 owned columns (rows).
template <int K, int R, typename In>
__device__ __forceinline__ void wkv_pass(const Args<In>& a, Smem<K>& sm) {
  constexpr int S = K / kParts;              // state elements a thread keeps
  constexpr bool kBwd = R != kFwd;
  constexpr bool kRev = R == kDv || R == kDk;  // reverse time
  constexpr bool kBonus = R == kFwd || R == kDv;  // scalar r·(u⊙k), else do·v
  constexpr int kLoads = kTS * K / kThreads;  // elements of one array per thread per tile
  constexpr int kXLoads = kTS * kOwned / kThreads;

  const int tid = threadIdx.x, part = tid & (kParts - 1), own = tid >> 3;
  const int idx = blockIdx.x * kOwned + own;  // the owned column (row)
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T;
  const long long HK = (long long)a.H * K;
  const long long seq0 = ((long long)b * T_ * a.H + h) * K;  // (b, 0, h, 0)
  const long long st0 = (long long)bh * K * K;                // (b, h, 0, 0)
  const long long row0 = (long long)bh * K;                   // (b, h, 0)
  const long long plane = (long long)a.B * a.H * K;

  if (tid < K) sm.u[tid] = a.u[h * K + tid];

  // the state strip: element i is S[part + 8 i][idx] (columns) or S[idx][part + 8 i]
  // (rows); in the backward's reverse passes it holds dS
  float M[S];
  const float* init = (R == kFwd || R == kDr) ? a.s0 : a.dsT;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int j = part + kParts * i;
    const long long at = (R == kFwd || R == kDv) ? st0 + (long long)j * K + idx
                                                 : st0 + (long long)idx * K + j;
    M[i] = init != nullptr ? init[at] : 0.f;
  }
  float acc = 0.f, x_next = 0.f;  // kDr: du partial; kDk: dlogw sum, x_{t+1}
  if constexpr (R == kDk) acc = a.part[plane + row0 + idx];

  float pr[kLoads], pk[kLoads], pv[kLoads], pw[kLoads], pd[kBwd ? kLoads : 1], px[kXLoads];
  auto load = [&](int tile) {
    const int t0 = tile * kTS;
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int flat = tid + e * kThreads, s = flat / K, c = flat % K;
      const bool in = t0 + s < T_;
      const long long off = seq0 + (long long)(t0 + s) * HK + c;
      pr[e] = in ? to_f(a.r[off]) : 0.f;
      pk[e] = in ? to_f(a.k[off]) : 0.f;
      pv[e] = in ? to_f(a.v[off]) : 0.f;
      pw[e] = in ? a.w[off] : 1.f;
      if constexpr (kBwd) pd[e] = in ? a.dout[off] : 0.f;
    }
    if constexpr (R == kDk) {
#pragma unroll
      for (int e = 0; e < kXLoads; ++e) {
        const int flat = tid + e * kThreads, s = flat / kOwned, c = flat % kOwned;
        const bool in = t0 + s < T_;
        px[e] = in ? a.x[seq0 + (long long)(t0 + s) * HK + blockIdx.x * kOwned + c] : 0.f;
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int flat = tid + e * kThreads, s = flat / K, c = flat % K;
      sm.r[s][c] = pr[e];
      sm.k[s][c] = pk[e];
      sm.v[s][c] = pv[e];
      sm.w[s][c] = pw[e];
      if constexpr (kBwd) sm.d[s][c] = pd[e];
    }
    if constexpr (R == kDk) {
#pragma unroll
      for (int e = 0; e < kXLoads; ++e) {
        const int flat = tid + e * kThreads;
        sm.x[flat / kOwned][flat % kOwned] = px[e];
      }
    }
  };

  const int n_tiles = (T_ + kTS - 1) / kTS;
  int tile = kRev ? n_tiles - 1 : 0;
  load(tile);
  for (int it = 0; it < n_tiles; ++it) {
    store();  // the previous tile's readers passed the barrier after its compute
    __syncthreads();
    {  // per-step scalars, one warp per step, lanes over K in a fixed order
      const int warp = tid >> 5, lane = tid & 31;
      for (int s = warp; s < kTS; s += kThreads / 32) {
        float p = 0.f;
        for (int c = lane; c < K; c += 32)
          p += kBonus ? sm.r[s][c] * sm.u[c] * sm.k[s][c] : sm.d[s][c] * sm.v[s][c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        if (lane == 0) sm.sc[s] = p;
      }
    }
    __syncthreads();
    const int t0 = tile * kTS, n = min(kTS, T_ - t0);
    const int next = kRev ? tile - 1 : tile + 1;
    if (it + 1 < n_tiles) load(next);  // in flight while this tile is computed
    for (int q = 0; q < n; ++q) {
      const int s = kRev ? n - 1 - q : q;
      float p = 0.f;
      if constexpr (R == kFwd) {  // column idx = v: out = r·S + bonus v
        const float vv = sm.v[s][idx];
#pragma unroll
        for (int i = 0; i < S; ++i) p = fmaf(sm.r[s][part + kParts * i], M[i], p);
        p = part_sum(p);
        if (part == 0) sm.o0[s][own] = fmaf(sm.sc[s], vv, p);
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const int j = part + kParts * i;
          M[i] = fmaf(sm.w[s][j], M[i], sm.k[s][j] * vv);
        }
      } else if constexpr (R == kDr) {  // row idx = k: drˢ = S_{t-1}[k, :]·do
#pragma unroll
        for (int i = 0; i < S; ++i) p = fmaf(M[i], sm.d[s][part + kParts * i], p);
        p = part_sum(p);
        const float rk = sm.r[s][idx], kk = sm.k[s][idx], wk = sm.w[s][idx];
        const float ukd = sm.u[idx] * sm.sc[s];
        acc = fmaf(rk * kk, sm.sc[s], acc);
        if (part == 0) {
          sm.o0[s][own] = fmaf(ukd, kk, p);
          sm.o1[s][own] = rk * p;
        }
#pragma unroll
        for (int i = 0; i < S; ++i) M[i] = fmaf(wk, M[i], kk * sm.v[s][part + kParts * i]);
      } else if constexpr (R == kDv) {  // column idx = v: dv = dS[:, v]·k + bonus do
        const float dd = sm.d[s][idx];
#pragma unroll
        for (int i = 0; i < S; ++i) p = fmaf(M[i], sm.k[s][part + kParts * i], p);
        p = part_sum(p);
        if (part == 0) sm.o0[s][own] = fmaf(sm.sc[s], dd, p);
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const int j = part + kParts * i;
          M[i] = fmaf(sm.w[s][j], M[i], sm.r[s][j] * dd);
        }
      } else {  // kDk, row idx = k: dkˢ = dS[k, :]·v, the dlogw sum, dw
#pragma unroll
        for (int i = 0; i < S; ++i) p = fmaf(M[i], sm.v[s][part + kParts * i], p);
        p = part_sum(p);
        const float rk = sm.r[s][idx], kk = sm.k[s][idx], wk = sm.w[s][idx];
        acc = fmaf(-kk, p, acc + x_next);
        x_next = sm.x[s][own];
        if (part == 0) {
          sm.o0[s][own] = fmaf(sm.u[idx] * rk, sm.sc[s], p);
          sm.o1[s][own] = acc / wk;
        }
#pragma unroll
        for (int i = 0; i < S; ++i) M[i] = fmaf(wk, M[i], rk * sm.d[s][part + kParts * i]);
      }
    }
    __syncthreads();  // the tile's outputs are staged
    float* o0 = R == kFwd ? a.out : R == kDr ? a.dr : R == kDv ? a.dv : a.dk;
    float* o1 = R == kDr ? a.x : a.dw;
    for (int e = tid; e < n * kOwned; e += kThreads) {
      const int s = e / kOwned, c = e % kOwned;
      const long long off = seq0 + (long long)(t0 + s) * HK + blockIdx.x * kOwned + c;
      o0[off] = sm.o0[s][c];
      if constexpr (R == kDr || R == kDk) o1[off] = sm.o1[s][c];
    }
    tile = next;
  }

  if constexpr (R == kFwd) {
#pragma unroll
    for (int i = 0; i < S; ++i) a.sT[st0 + (long long)(part + kParts * i) * K + idx] = M[i];
  } else if constexpr (R == kDr) {
    float fin = 0.f;  // Σ_v ds_final[k, v] S_{T-1}[k, v]
    if (a.dsT != nullptr) {
#pragma unroll
      for (int i = 0; i < S; ++i)
        fin = fmaf(a.dsT[st0 + (long long)idx * K + part + kParts * i], M[i], fin);
    }
    fin = part_sum(fin);
    if (part == 0) {
      a.part[row0 + idx] = acc;
      a.part[plane + row0 + idx] = fin;
    }
  } else if constexpr (R == kDk) {
    if (a.ds0 != nullptr) {
#pragma unroll
      for (int i = 0; i < S; ++i) a.ds0[st0 + (long long)idx * K + part + kParts * i] = M[i];
    }
    if (b == 0 && part == 0) {  // du[h, k]: the partials summed over b, in order
      float du = 0.f;
      for (int bb = 0; bb < a.B; ++bb) du += a.part[((long long)bb * a.H + h) * K + idx];
      a.du[h * K + idx] = du;
    }
  }
}

template <int K, typename In>
__global__ void __launch_bounds__(kThreads) wkv_fwd_kernel(Args<In> a) {
  __shared__ Smem<K> sm;
  wkv_pass<K, kFwd>(a, sm);
}

template <int K, typename In>
__global__ void __launch_bounds__(kThreads) wkv_bwd_state_kernel(Args<In> a) {
  __shared__ Smem<K> sm;
  if (blockIdx.z == 0)
    wkv_pass<K, kDr>(a, sm);
  else
    wkv_pass<K, kDv>(a, sm);
}

template <int K, typename In>
__global__ void __launch_bounds__(kThreads) wkv_bwd_decay_kernel(Args<In> a) {
  __shared__ Smem<K> sm;
  wkv_pass<K, kDk>(a, sm);
}

template <int K, typename In>
int launch_fwd(const Args<In>& a, cudaStream_t st) {
  wkv_fwd_kernel<K, In><<<dim3(K / kOwned, a.B * a.H), kThreads, 0, st>>>(a);
  return int(cudaGetLastError());
}

template <int K, typename In>
int launch_bwd(const Args<In>& a, cudaStream_t st) {
  wkv_bwd_state_kernel<K, In><<<dim3(K / kOwned, a.B * a.H, 2), kThreads, 0, st>>>(a);
  int err = int(cudaGetLastError());
  if (err) return err;
  wkv_bwd_decay_kernel<K, In><<<dim3(K / kOwned, a.B * a.H), kThreads, 0, st>>>(a);
  return int(cudaGetLastError());
}

template <typename In>
int dispatch(const Args<In>& a, int K, bool bwd, cudaStream_t st) {
  if (K == 32) return bwd ? launch_bwd<32>(a, st) : launch_fwd<32>(a, st);
  return bwd ? launch_bwd<64>(a, st) : launch_fwd<64>(a, st);
}

template <typename In>
Args<In> make_args(const void* r, const void* k, const void* v, const float* w, const float* u,
                  const float* s0, int B, int T, int H) {
  Args<In> a{};
  a.r = static_cast<const In*>(r);
  a.k = static_cast<const In*>(k);
  a.v = static_cast<const In*>(v);
  a.w = w;
  a.u = u;
  a.s0 = s0;
  a.B = B;
  a.T = T;
  a.H = H;
  return a;
}

bool valid(int B, int T, int H, int K) {
  return B > 0 && T > 0 && H > 0 && (K == 32 || K == 64) && (long long)B * H <= 65535;
}

}  // namespace

// r, k, v: (B, T, H, K), f32 (bf16 = 0) or bf16 (bf16 = 1); w, out: (B, T, H, K) f32;
// u: (H, K) f32; s0, s_final: (B, H, K, K) f32; s0 may be null (a zero state).  All
// contiguous; K is 32 or 64.  Returns the cudaError_t of the launch (0 on success).
extern "C" int wkv_fwd(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const float* s0, float* out, float* s_final, int B,
                       int T, int H, int K, int bf16, void* stream) {
  if (!valid(B, T, H, K)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    Args<__nv_bfloat16> a = make_args<__nv_bfloat16>(r, k, v, w, u, s0, B, T, H);
    a.out = out;
    a.sT = s_final;
    return dispatch(a, K, false, st);
  }
  Args<float> a = make_args<float>(r, k, v, w, u, s0, B, T, H);
  a.out = out;
  a.sT = s_final;
  return dispatch(a, K, false, st);
}

// The gradient of wkv_fwd.  Inputs as there, plus dout (B, T, H, K) f32 and ds_final
// (B, H, K, K) f32 (may be null: zero).  Outputs dr, dk, dv, dw (B, T, H, K), du
// (H, K) and ds0 (B, H, K, K), all f32; ds0 may be null (not wanted).  Scratch: x
// (B, T, H, K) and part (2, B, H, K) f32.  Two launches on `stream`.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int wkv_bwd(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const float* s0, const float* dout,
                       const float* ds_final, float* dr, float* dk, float* dv, float* dw,
                       float* du, float* ds0, float* x, float* part, int B, int T, int H, int K,
                       int bf16, void* stream) {
  if (!valid(B, T, H, K)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& a) {
    a.dout = dout;
    a.dsT = ds_final;
    a.dr = dr;
    a.dk = dk;
    a.dv = dv;
    a.dw = dw;
    a.du = du;
    a.ds0 = ds0;
    a.x = x;
    a.part = part;
  };
  if (bf16) {
    Args<__nv_bfloat16> a = make_args<__nv_bfloat16>(r, k, v, w, u, s0, B, T, H);
    fill(a);
    return dispatch(a, K, true, st);
  }
  Args<float> a = make_args<float>(r, k, v, w, u, s0, B, T, H);
  fill(a);
  return dispatch(a, K, true, st);
}

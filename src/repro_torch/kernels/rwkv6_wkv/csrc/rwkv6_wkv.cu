// WKV6 recurrence (RWKV6 "Finch" time mix), forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/rwkv6_wkv/:
//   wkv_fwd_state_kernel,        <- _wkv_kernel / wkv_pallas  (kernel.py:31, :91, pallas_call
//   wkv_fwd_out_kernel              :117), the forward, in two launches
//   wkv_bwd_state_kernel,        its gradient; the JAX package has no kernel for it (JAX
//   wkv_bwd_decay_kernel            differentiates the jnp chunked form, models/rwkv6.py:177)
//
// What they compute (the plain versions are in ../ref.py).  Per batch row b and head
// h, over a (K, K) f32 state S from s0 (absent: 0); r, k, v (B, T, H, K) in f32 or
// bf16, w (B, T, H, K) f32 in [0, 1), u (H, K) f32:
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
// The forward: a chunked form on the tensor cores (its CPU mirror is
// ../ref.py:wkv_chunked_ref).  With lw = max(log w, -88) (the floor turns a w that
// underflowed to 0 into a decay below f32's normal range) and P(a, b) = Σ_{a<=m<b} lw_m
// over a chunk's local steps, a chunk of n <= 64 steps from state S_c gives
//   out_i   = r_i·(e^{P(0,i)} ⊙ S_c) + Σ_{j<i} [Σ_k r_i k_j e^{P(j+1,i)}] v_j
//             + (r_i·(u⊙k_i)) v_i
//   S_{c+1} = e^{P(0,n)} ⊙ S_c + Σ_j (k_j ⊙ e^{P(j+1,n)})ᵀ v_j.
// No exponent is a difference of cumulative sums (that cancels where a chunk mixes tiny
// and near-1 decays): each is a sum of sub-chunk pieces (8 steps each), the prefix
// `pre` and suffix `suf` within a sub-chunk and whole sub-chunk totals, and nothing
// divides by a decay, so any w in [0, 1) is exact to rounding.  Sub-chunk pairs I > J
// are one product: (r_i e^{pre_i + totals between}) · (k_j e^{suf_j}); within a
// sub-chunk a running sum of lw from i - 1 down to j + 1 sits on the CUDA cores.
//   wkv_fwd_state_kernel  grid (K / 32, B·H): walks the chunks of one (b, h) in order,
//       32 state columns in the mma accumulators; writes S_c of every chunk to a
//       scratch (B, H, ceil(T / 64), K, K) and then S_{c+1} = e^{P(0,n)} ⊙ S_c + ktᵀ V
//       (a K x 32 x 64 product); the next chunk's k, v, w in flight (cp.async).
//   wkv_fwd_out_kernel    grid (ceil(T / 64), B·H), all chunks at once: the pieces,
//       the 64 x 64 weight matrix A (sub-chunk pairs on the tensor cores, the
//       diagonal sub-chunks and the bonus on the CUDA cores), then
//       out = (r e^{P(0,i)}) S_c + A V on the tensor cores.
// Products in 3xTF32 (mma.sync m16n8k8): each f32 operand is hi = tf32(x) plus lo =
// tf32(x - hi), and a·b = a.lo b.hi + a.hi b.lo + a.hi b.hi in that order (a bf16
// operand is exact in TF32 and skips its lo).  One TF32 or bf16 pass is off by ~100x
// the 2e-4 tolerance; three are within it.
//
// The backward: each column v of S evolves on its own (S[:, v] <- w ⊙ S[:, v] + k v[v]),
// and so does each row k (S[k, :] <- w[k] S[k, :] + k[k] v): the update is
// elementwise.  Only the products reduce, over k for dv, over v for dr and dk.  So a
// block owns 32 rows (or columns) of one (b, h) and gives each 8 threads, adjacent
// lanes: a thread keeps K/8 elements of its row (column) in registers, the strip
// {p, p+8, p+16, ...} (p the thread's part), and three xor shuffles sum the 8 partial
// products.  K = 64 takes two blocks per (b, h).  The block stages 16 steps of r, k, v,
// w and dout as f32 in shared memory with coalesced loads, the next tile's loads in
// flight in registers while the current tile is computed; per-step scalars
// (r·(u⊙k), do·v) are summed by a warp each; outputs of a tile are staged and written
// as 128-byte rows.
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
// w S + k v: 3), 5.37 GFLOP: 0.033 ms in 3xTF32 on the tensor cores (495 / 3 TFLOP/s),
// the path its products take, so it is bound by bytes (0.080 ms on the f32 CUDA cores
// at 67 TFLOP/s, where the sequential kernel did them).  The chunked form pays for the
// scratch S_c (67 MB written and read again, ~0.04 ms) and for the serial walk over
// 64 chunks; what holds it now is latency: the walk's chunk steps, and in the chunk
// kernel the block's phases with two blocks (16 warps) an SM.  The backward reads
// r, k, v, w, dout and writes dr, dk, dv, dw (f32): 30 B per element, 503 MB,
// 0.150 ms; 14 FLOP per state element per step (S recomputed: 3, dS: 3, dS·k, dS·v,
// S·do, dS⊙S: 2 each), 15.0 GFLOP, 0.224 ms on the f32 CUDA cores: bound by
// operations; it still walks the steps one at a time there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParts = 8;                  // threads that share one column (row)
constexpr int kOwned = 32;                 // columns (rows) a block owns
constexpr int kThreads = kParts * kOwned;  // 256
constexpr int kTS = 16;                    // time steps staged per tile

enum Role { kDr, kDv, kDk };

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
  float* sc;                             // forward scratch: S_c of every chunk (B, H, NC, K, K)
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
  constexpr bool kRev = R == kDv || R == kDk;  // reverse time
  constexpr bool kBonus = R == kDv;              // scalar r·(u⊙k), else do·v
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
  const float* init = R == kDr ? a.s0 : a.dsT;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int j = part + kParts * i;
    const long long at = R == kDv ? st0 + (long long)j * K + idx : st0 + (long long)idx * K + j;
    M[i] = init != nullptr ? init[at] : 0.f;
  }
  float acc = 0.f, x_next = 0.f;  // kDr: du partial; kDk: dlogw sum, x_{t+1}
  if constexpr (R == kDk) acc = a.part[plane + row0 + idx];

  float pr[kLoads], pk[kLoads], pv[kLoads], pw[kLoads], pd[kLoads], px[kXLoads];
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
      pd[e] = in ? a.dout[off] : 0.f;
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
      sm.d[s][c] = pd[e];
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
      if constexpr (R == kDr) {  // row idx = k: drˢ = S_{t-1}[k, :]·do
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
    float* o0 = R == kDr ? a.dr : R == kDv ? a.dv : a.dk;
    float* o1 = R == kDr ? a.x : a.dw;
    for (int e = tid; e < n * kOwned; e += kThreads) {
      const int s = e / kOwned, c = e % kOwned;
      const long long off = seq0 + (long long)(t0 + s) * HK + blockIdx.x * kOwned + c;
      o0[off] = sm.o0[s][c];
      if constexpr (R == kDr || R == kDk) o1[off] = sm.o1[s][c];
    }
    tile = next;
  }

  if constexpr (R == kDr) {
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

// ---------------------------------------------------------------------------
// The forward: the chunked form, its products on the tensor cores in 3xTF32.
// ---------------------------------------------------------------------------

constexpr int kL = 64;            // steps per chunk
constexpr int kSub = 8;           // steps per sub-chunk
constexpr int kNS = kL / kSub;    // sub-chunks per chunk
constexpr int kOutThreads = 256;  // wkv_fwd_out_kernel: 8 warps
constexpr float kLwFloor = -88.f * 1.4426950408889634f;  // log2 of e^-88

// The log decay in log2 units, floored: a w that underflowed to 0 decays by
// e^-88 (below f32's normal range) instead of giving -inf - (-inf).  lg2.approx is
// off by up to ~2^-22 in the log, absolute: a few 1e-6 of |log2 w| >= 0.093 below
// w = 15/16, but ~1% of a log of 1e-5, and the walk sums thousands of them (at w in
// (0.9999, 0.99999) that missed the gate by ~50x).  So from 15/16 up, where w - 1
// is exact, the log is log1p(w - 1) from its series to x^6: truncation below 1e-8
// and rounding below 2e-7 of the log, in 6 FMAs (log1pf's general path made the
// forward ~1.3x slower).  A subnormal w flushes to 0, so to the floor.
__device__ __forceinline__ float log2_decay(float w) {
  const float x = w - 1.f;
  if (x >= -0.0625f) {
    float p = fmaf(x, -1.f / 6.f, 0.2f);
    p = fmaf(x, p, -0.25f);
    p = fmaf(x, p, 1.f / 3.f);
    p = fmaf(x, p, -0.5f);
    p = fmaf(x, p, 1.f);
    return x * p * 1.4426950408889634f;
  }
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(w));
  return fmaxf(y, kLwFloor);
}

// 2^x for x <= 0, to ~2^-22 relative; results below f32's normal range flush to 0.
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative: both halves TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

// d += a b on the tensor cores: one m16n8k8 TF32 product with f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); b0 (t, g), b1 (t+4, g); d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t),
// d3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

// d += a b in 3xTF32, in one fixed order: a.lo b.hi, a.hi b.lo, then a.hi b.hi.
// kExactB: b is exact in TF32 (bf16 values), so its lo half is 0 and skipped.
template <bool kExactB>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  if constexpr (!kExactB) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// cp.async `rows` rows of `cols` elements, global row stride `gs`, into shared
// rows of stride `ss`; rows from `valid` on are zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ss, const T* src, long long gs, int rows,
                                          int cols, int valid, int tid, int nthr) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = cols / E;
  for (int p = tid; p < rows * per_row; p += nthr) {
    const int row = p / per_row, c = (p % per_row) * E;
    const bool in = row < valid;
    cp_async16(dst + row * ss + c, src + (in ? row : 0) * gs + c, in);
  }
}

// wkv_fwd_state_kernel: one block per 32 value columns of one (b, h), 4K threads:
// warp w owns the state rows 16 (w / 2) .. + 15 and the 16 columns 16 (w % 2) .. + 15
// of the block's 32, in its mma accumulators, and every thread two (sub-chunk,
// column) pieces of a chunk.  Two stages of k, v, w: the next chunk's are in flight
// while the current one is computed.
constexpr int kSlice = 32;  // value columns a block
constexpr int kStages = 2;  // chunks of k, v, w in shared memory

template <int K, typename In>
struct StateSmem {
  In k[kStages][kL][K + 8];
  In v[kStages][kL][kSlice + 8];  // the block's columns
  float w[kStages][kL][K];
  float kt[kL][K + 8];      // k_j e^{P(j+1, n)}, the product's A operand (transposed)
  float tot[kNS][K];        // sub-chunk totals of lw
};

template <int K>
constexpr int kStateThreads = 4 * K;  // two pieces a thread

template <int K, typename In>
__global__ void __launch_bounds__(kStateThreads<K>) wkv_fwd_state_kernel(Args<In> a) {
  constexpr int kThr = kStateThreads<K>;
  constexpr bool kBExact = sizeof(In) == 2;  // bf16 v is exact in TF32
  static_assert(kThr / 32 == (K / 16) * (kSlice / 16), "a warp a 16 x 16 tile of the slice");
  extern __shared__ __align__(16) unsigned char wkv_smem[];
  StateSmem<K, In>& sm = *reinterpret_cast<StateSmem<K, In>*>(wkv_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int v0 = blockIdx.x * kSlice;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, NC = (T_ + kL - 1) / kL;
  const long long HK = (long long)a.H * K;
  const long long seq0 = ((long long)b * T_ * a.H + h) * K;  // (b, 0, h, 0)
  const long long st0 = (long long)bh * K * K;                // (b, h, 0, 0)
  const int row0 = 16 * (warp >> 1) + g, row1 = row0 + 8;     // the warp's state rows
  const int nc = 16 * (warp & 1);                             // and columns, in the block's
  const int Jp = tid / K, kc = tid % K;  // the thread's pieces: sub-chunks 2 Jp, 2 Jp + 1

  auto load = [&](int c, int stage) {
    const int t0 = c * kL, n = min(kL, T_ - t0);
    const long long at = seq0 + (long long)t0 * HK;
    load_rows(&sm.k[stage][0][0], K + 8, a.k + at, HK, kL, K, n, tid, kThr);
    load_rows(&sm.v[stage][0][0], kSlice + 8, a.v + at + v0, HK, kL, kSlice, n, tid, kThr);
    load_rows(&sm.w[stage][0][0], K, a.w + at, HK, kL, K, n, tid, kThr);
    cp_async_commit();
  };

  float acc[2][4];  // S[row0 | row1][v0 + nc + 8 nt + 2t (+1)]
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = v0 + nc + 8 * nt + 2 * t;
    acc[nt][0] = a.s0 ? a.s0[st0 + (long long)row0 * K + col] : 0.f;
    acc[nt][1] = a.s0 ? a.s0[st0 + (long long)row0 * K + col + 1] : 0.f;
    acc[nt][2] = a.s0 ? a.s0[st0 + (long long)row1 * K + col] : 0.f;
    acc[nt][3] = a.s0 ? a.s0[st0 + (long long)row1 * K + col + 1] : 0.f;
  }
  auto store_state = [&](float* S) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = v0 + nc + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(S + row0 * K + col) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(S + row1 * K + col) = make_float2(acc[nt][2], acc[nt][3]);
    }
  };

  load(0, 0);
  for (int c = 0; c < NC; ++c) {
    const int stage = c % kStages, n = min(kL, T_ - c * kL);
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; chunk c - 1's buffers are no longer read
    if (c + 1 < NC) load(c + 1, (c + 1) % kStages);
    store_state(a.sc + st0 * NC + (long long)c * K * K);  // S_c

    // the pieces (J, kc), two a thread: the suffixes of lw in sub-chunk J in
    // registers, its total
    float suf[2][kSub];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int J = 2 * Jp + e;
      float p = 0.f;
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        const int j = kSub * J + s;
        suf[e][s] = j < n ? log2_decay(sm.w[stage][j][kc]) : 0.f;
        p += suf[e][s];
      }
      sm.tot[J][kc] = p;
      float q = 0.f;
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        const float l = suf[e][s];
        suf[e][s] = q;
        q += l;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int J = 2 * Jp + e;
      float after = 0.f;
#pragma unroll
      for (int M = 1; M < kNS; ++M) after += M > J ? sm.tot[M][kc] : 0.f;
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        const int j = kSub * J + s;
        sm.kt[j][kc] = to_f(sm.k[stage][j][kc]) * exp2_neg(suf[e][s] + after);
      }
    }
    __syncthreads();

    // S <- e^{P(0, n)} ⊙ S + ktᵀ V: the product in accumulators of its own (the
    // TF32 cross terms apart from hi·hi), so that S waits on one FMA a chunk
    float big[2][4] = {}, small[2][4] = {};
#pragma unroll
    for (int kb = 0; kb < kL / 8; ++kb) {
      const int j0 = 8 * kb + t, j1 = j0 + 4;
      FragA fa;
      fa.set(sm.kt[j0][row0], sm.kt[j0][row1], sm.kt[j1][row0], sm.kt[j1][row1]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        FragB fb;
        fb.set(to_f(sm.v[stage][j0][nc + 8 * nt + g]), to_f(sm.v[stage][j1][nc + 8 * nt + g]));
        mma_tf32(small[nt], fa.lo, fb.hi);
        if constexpr (!kBExact) mma_tf32(small[nt], fa.hi, fb.lo);
        mma_tf32(big[nt], fa.hi, fb.hi);
      }
    }
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int M = 0; M < kNS; ++M) {
      d0 += sm.tot[M][row0];
      d1 += sm.tot[M][row1];
    }
    d0 = exp2_neg(d0);
    d1 = exp2_neg(d1);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      acc[nt][0] = fmaf(d0, acc[nt][0], big[nt][0] + small[nt][0]);
      acc[nt][1] = fmaf(d0, acc[nt][1], big[nt][1] + small[nt][1]);
      acc[nt][2] = fmaf(d1, acc[nt][2], big[nt][2] + small[nt][2]);
      acc[nt][3] = fmaf(d1, acc[nt][3], big[nt][3] + small[nt][3]);
    }
  }
  store_state(a.sT + st0);
}

// wkv_fwd_out_kernel: one block per chunk of one (b, h), 8 warps.
template <int K, typename In>
struct OutSmem {
  In r[kL][K + 8], k[kL][K + 8], v[kL][K + 8];
  float w[kL][K + 4];     // w, then lw (log2 units), then k_j e^{suf_j}
  float S[K][K + 8];      // S_c ([k][v])
  float pre[kL][K + 4];   // prefix exponents, then r_i e^{P(0, i)}
  float A[kL][kL + 4];    // the chunk's weights of v_j in out_i (j <= i)
  float tot[kNS][K];
  float btw[16][K];       // totals strictly between J = q and 2p, for the tiles of 3
  float u[K];
};

template <int K, typename In>
__global__ void __launch_bounds__(kOutThreads) wkv_fwd_out_kernel(Args<In> a) {
  static_assert(kSub == 8 && kL == 64, "16-row tiles are two sub-chunks; four tiles a chunk");
  extern __shared__ __align__(16) unsigned char wkv_smem[];
  OutSmem<K, In>& sm = *reinterpret_cast<OutSmem<K, In>*>(wkv_smem);
  constexpr bool kBExact = sizeof(In) == 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, NC = (T_ + kL - 1) / kL, t0 = c * kL, n = min(kL, T_ - t0);
  const long long HK = (long long)a.H * K;
  const long long at = ((long long)b * T_ * a.H + h) * K + (long long)t0 * HK;  // (b, t0, h, 0)

  load_rows(&sm.r[0][0], K + 8, a.r + at, HK, kL, K, n, tid, kOutThreads);
  load_rows(&sm.k[0][0], K + 8, a.k + at, HK, kL, K, n, tid, kOutThreads);
  load_rows(&sm.v[0][0], K + 8, a.v + at, HK, kL, K, n, tid, kOutThreads);
  load_rows(&sm.w[0][0], K + 4, a.w + at, HK, kL, K, n, tid, kOutThreads);
  cp_async_commit();
  load_rows(&sm.S[0][0], K + 8, a.sc + ((long long)bh * NC + c) * K * K, K, K, K, K, tid,
            kOutThreads);
  cp_async_commit();  // S_c is first read in 5
  if (tid < K) sm.u[tid] = a.u[h * K + tid];
  cp_async_wait<1>();
  __syncthreads();

  // 1. pieces of column `col` over sub-chunk I: lw, prefixes, total
  for (int item = tid; item < kNS * K; item += kOutThreads) {
    const int I = item / K, col = item % K;
    float p = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int i = kSub * I + s;
      const float l = i < n ? log2_decay(sm.w[i][col]) : 0.f;
      sm.w[i][col] = l;
      sm.pre[i][col] = p;
      p += l;
    }
    sm.tot[I][col] = p;
  }
  __syncthreads();

  // 2. within a sub-chunk on the CUDA cores: A_ij = Σ_k r_i k_j e^{P(j+1, i)} for
  //    j < i, P a running sum of lw from i - 1 down to j + 1; A_ii = r_i·(u⊙k_i);
  //    0 above.  Thread (rows ra and 7 - ra of a sub-chunk, kq) sums its K/8
  //    columns for both (7 + 3 steps of j a column, not 8 + 8); 8 lanes sum the
  //    partials.
  {
    static_assert(kSub == 8, "the row pairs (ra, 7 - ra) of a sub-chunk");
    const int I = tid >> 5, ra = (tid >> 3) & 3, rb = kSub - 1 - ra, kq = tid & 7;
    const int ia = kSub * I + ra, ib = kSub * I + rb;
    float pa[3] = {}, pb[kSub - 1] = {}, ba = 0.f, bb = 0.f;
#pragma unroll
    for (int e = 0; e < K / 8; ++e) {
      const int col = kq + 8 * e;
      const float rka = to_f(sm.r[ia][col]), rkb = to_f(sm.r[ib][col]);
      float run = 0.f;
#pragma unroll
      for (int jj = kSub - 2; jj >= 0; --jj) {  // rb >= 4 > jj for jj < 4
        const int j = kSub * I + jj;
        const bool in = jj < rb;
        pb[jj] = fmaf(in ? rkb * to_f(sm.k[j][col]) : 0.f, exp2_neg(run), pb[jj]);
        run = in ? run + sm.w[j][col] : run;
      }
      run = 0.f;
#pragma unroll
      for (int jj = 2; jj >= 0; --jj) {  // ra <= 3
        const int j = kSub * I + jj;
        const bool in = jj < ra;
        pa[jj] = fmaf(in ? rka * to_f(sm.k[j][col]) : 0.f, exp2_neg(run), pa[jj]);
        run = in ? run + sm.w[j][col] : run;
      }
      ba = fmaf(rka * sm.u[col], to_f(sm.k[ia][col]), ba);
      bb = fmaf(rkb * sm.u[col], to_f(sm.k[ib][col]), bb);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
#pragma unroll
      for (int jj = 0; jj < kSub - 1; ++jj) pb[jj] += __shfl_xor_sync(0xffffffffu, pb[jj], o);
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) pa[jj] += __shfl_xor_sync(0xffffffffu, pa[jj], o);
      ba += __shfl_xor_sync(0xffffffffu, ba, o);
      bb += __shfl_xor_sync(0xffffffffu, bb, o);
    }
    const int jj = kq;  // lane kq writes column jj of both rows' blocks
    float xa = jj == ra ? ba : 0.f, xb = jj == rb ? bb : 0.f;
#pragma unroll
    for (int x = 0; x < 3; ++x)
      if (x == jj && x < ra) xa = pa[x];
#pragma unroll
    for (int x = 0; x < kSub - 1; ++x)
      if (x == jj && x < rb) xb = pb[x];
    sm.A[ia][kSub * I + jj] = xa;
    sm.A[ib][kSub * I + jj] = xb;
    if (I % 2 == 0) {  // the upper corner of the 16-row tile
      sm.A[ia][kSub * (I + 1) + jj] = 0.f;
      sm.A[ib][kSub * (I + 1) + jj] = 0.f;
    }
  }
  __syncthreads();

  // k_j e^{suf_j}, the B operand of 3, over lw (each piece by the thread that reads
  // it), and the totals between the sub-chunks of each tile of 3, in increasing order
  for (int item = tid; item < kNS * K; item += kOutThreads) {
    const int I = item / K, col = item % K;
    float q = 0.f;
#pragma unroll
    for (int s = kSub - 1; s >= 0; --s) {
      const int i = kSub * I + s;
      const float l = sm.w[i][col];
      sm.w[i][col] = to_f(sm.k[i][col]) * exp2_neg(q);
      q += l;
    }
  }
  for (int item = tid; item < 16 * K; item += kOutThreads) {
    const int task = item / K, col = item % K;
    const int p = task >= 9 ? 3 : task >= 4 ? 2 : task >= 1 ? 1 : 0, q = task - p * p;
    float b = 0.f;
#pragma unroll
    for (int M = 1; M < kNS - 1; ++M) b += M > q && M < 2 * p ? sm.tot[M][col] : 0.f;
    sm.btw[task][col] = b;
  }
  __syncthreads();

  // 3. sub-chunk pairs I > J on the tensor cores, 16 tiles of 16 rows (the
  //     sub-chunks 2p, 2p + 1) by 8 columns (sub-chunk J = q <= 2p), two a warp:
  //     A_ij = (r_i e^{pre_i + between_JI}) · (k_j e^{suf_j}).  In the tile q = 2p
  //     only the rows of 2p + 1 are pairs; those of 2p are 2's.
  {
    int p[2], q[2], task[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      task[x] = warp + 8 * x;
      p[x] = task[x] >= 9 ? 3 : task[x] >= 4 ? 2 : task[x] >= 1 ? 1 : 0;
      q[x] = task[x] - p[x] * p[x];
    }
    float d[2][4] = {};
#pragma unroll
    for (int kb = 0; kb < K / 8; ++kb) {
      const int k0 = 8 * kb + t, k1 = k0 + 4;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i0 = 16 * p[x] + g, i1 = i0 + 8, j = 8 * q[x] + g;
        // between J and 2p at k0 and k1, then J and 2p + 1
        const float b00 = sm.btw[task[x]][k0], b01 = sm.btw[task[x]][k1];
        const bool full = q[x] < 2 * p[x];
        const float b10 = full ? b00 + sm.tot[2 * p[x]][k0] : 0.f;
        const float b11 = full ? b01 + sm.tot[2 * p[x]][k1] : 0.f;
        FragA fa;
        fa.set(to_f(sm.r[i0][k0]) * exp2_neg(sm.pre[i0][k0] + b00),
               to_f(sm.r[i1][k0]) * exp2_neg(sm.pre[i1][k0] + b10),
               to_f(sm.r[i0][k1]) * exp2_neg(sm.pre[i0][k1] + b01),
               to_f(sm.r[i1][k1]) * exp2_neg(sm.pre[i1][k1] + b11));
        FragB fb;
        fb.set(sm.w[j][k0], sm.w[j][k1]);
        mma3<false>(d[x], fa, fb);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i0 = 16 * p[x] + g, i1 = i0 + 8, j = 8 * q[x] + 2 * t;
      if (q[x] < 2 * p[x]) {
        sm.A[i0][j] = d[x][0];
        sm.A[i0][j + 1] = d[x][1];
      }
      sm.A[i1][j] = d[x][2];
      sm.A[i1][j + 1] = d[x][3];
    }
  }
  __syncthreads();

  // 4. the state term's operand r_i e^{before_I + pre_i}, over pre: a thread keeps
  //    one column, and its totals before each sub-chunk in registers
  {
    constexpr int kRows = kOutThreads / K;  // rows a pass
    static_assert(kSub % kRows == 0, "a thread's rows of one pass lie in one sub-chunk");
    const int col = tid % K, r0 = tid / K;
    float before[kNS];
    before[0] = 0.f;
#pragma unroll
    for (int M = 1; M < kNS; ++M) before[M] = before[M - 1] + sm.tot[M - 1][col];
#pragma unroll
    for (int x = 0; x < kL / kRows; ++x) {
      const int i = r0 + kRows * x;
      sm.pre[i][col] = to_f(sm.r[i][col]) * exp2_neg(before[kRows * x / kSub] + sm.pre[i][col]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 5. out = (r e^{P(0, i)}) S_c + A V: warp (p, half) owns 16 rows x K/2 columns
  {
    constexpr int NT = K / 16;  // n-tiles of 8 a warp
    const int p = warp >> 1, nt0 = (warp & 1) * NT;
    const int i0 = 16 * p + g, i1 = i0 + 8;
    float d[NT][4] = {};
#pragma unroll
    for (int kb = 0; kb < K / 8; ++kb) {
      const int k0 = 8 * kb + t, k1 = k0 + 4;
      FragA fa;
      fa.set(sm.pre[i0][k0], sm.pre[i1][k0], sm.pre[i0][k1], sm.pre[i1][k1]);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int col = 8 * (nt0 + q) + g;
        FragB fb;
        fb.set(sm.S[k0][col], sm.S[k1][col]);
        mma3<false>(d[q], fa, fb);
      }
    }
    for (int jb = 0; jb < 2 * (p + 1); ++jb) {  // j < 16 (p + 1): the rest of A is 0
      const int j0 = 8 * jb + t, j1 = j0 + 4;
      FragA fa;
      fa.set(sm.A[i0][j0], sm.A[i1][j0], sm.A[i0][j1], sm.A[i1][j1]);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int col = 8 * (nt0 + q) + g;
        FragB fb;
        fb.set(to_f(sm.v[j0][col]), to_f(sm.v[j1][col]));
        mma3<kBExact>(d[q], fa, fb);
      }
    }
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int col = 8 * (nt0 + q) + 2 * t;
      if (i0 < n)
        *reinterpret_cast<float2*>(a.out + at + i0 * HK + col) = make_float2(d[q][0], d[q][1]);
      if (i1 < n)
        *reinterpret_cast<float2*>(a.out + at + i1 * HK + col) = make_float2(d[q][2], d[q][3]);
    }
  }
}

template <int K, typename In>
int launch_fwd(const Args<In>& a, cudaStream_t st) {
  const int NC = (a.T + kL - 1) / kL;
  const int state_bytes = sizeof(StateSmem<K, In>), out_bytes = sizeof(OutSmem<K, In>);
  static const cudaError_t state_attr = cudaFuncSetAttribute(
      wkv_fwd_state_kernel<K, In>, cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes);
  if (state_attr != cudaSuccess) return int(state_attr);
  static const cudaError_t out_attr = cudaFuncSetAttribute(
      wkv_fwd_out_kernel<K, In>, cudaFuncAttributeMaxDynamicSharedMemorySize, out_bytes);
  if (out_attr != cudaSuccess) return int(out_attr);
  wkv_fwd_state_kernel<K, In>
      <<<dim3(K / kSlice, a.B * a.H), kStateThreads<K>, state_bytes, st>>>(a);
  const int err = int(cudaGetLastError());
  if (err) return err;
  wkv_fwd_out_kernel<K, In><<<dim3(NC, a.B * a.H), kOutThreads, out_bytes, st>>>(a);
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

// The forward's chunk and sub-chunk lengths in steps: the wrapper sizes the scratch
// from the first and holds its CPU mirror to both.
extern "C" int wkv_fwd_chunk() { return kL; }
extern "C" int wkv_fwd_sub() { return kSub; }

// r, k, v: (B, T, H, K), f32 (bf16 = 0) or bf16 (bf16 = 1); w, out: (B, T, H, K) f32;
// u: (H, K) f32; s0, s_final: (B, H, K, K) f32; s0 may be null (a zero state); scratch
// chunk_states: (B, H, ceil(T / wkv_fwd_chunk()), K, K) f32.  All contiguous; K is 32 or 64.  Two
// launches on `stream`.  Returns the cudaError_t of the launches (0 on success).
extern "C" int wkv_fwd(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const float* s0, float* out, float* s_final,
                       float* chunk_states, int B, int T, int H, int K, int bf16, void* stream) {
  if (!valid(B, T, H, K)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    Args<__nv_bfloat16> a = make_args<__nv_bfloat16>(r, k, v, w, u, s0, B, T, H);
    a.out = out;
    a.sT = s_final;
    a.sc = chunk_states;
    return dispatch(a, K, false, st);
  }
  Args<float> a = make_args<float>(r, k, v, w, u, s0, B, T, H);
  a.out = out;
  a.sT = s_final;
  a.sc = chunk_states;
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

// WKV6 recurrence (RWKV6 "Finch" time mix), forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/rwkv6_wkv/:
//   wkv_step_kernel,             <- _wkv_kernel / wkv_pallas  (kernel.py:31, :91, pallas_call
//   wkv_fwd_state_kernel,           :117), the forward: the step kernel for T <= kStepMaxT
//   wkv_fwd_out_kernel              (the decode step), the chunked pair in two launches past it
//   wkv_bwd_state_kernel,        its gradient; the JAX package has no kernel for it (JAX
//   wkv_bwd_dv_kernel,              differentiates the jnp chunked form, models/rwkv6.py:177)
//   wkv_bwd_grad_kernel,
//   wkv_bwd_du_kernel
//
// What they compute (the plain versions are in ../ref.py).  Per batch row b and head
// h, over a (K, K) f32 state S from s0 (absent: 0); r, k, v (B, T, H, K) in f32 or
// bf16, w (B, T, H, K) f32 in [0, 1), u (H, K) f32:
//   forward   out_t = r_t·S + (r_t·(u⊙k_t)) v_t,   then S <- diag(w_t) S + k_tᵀ v_t;
//             out (B, T, H, K) f32 and s_final (B, H, K, K) f32.
//   backward  from dout and ds_final (absent: 0), with dS_t the gradient with respect
//             to the state after step t (dS_{T-1} = ds_final):
//     dv_t[v] = Σ_k dS_t[k,v] k_t[k]     + (r_t·(u⊙k_t)) do_t[v]
//     dk_t[k] = Σ_v dS_t[k,v] v_t[v]     + u[k] r_t[k] (do_t·v_t)
//     dr_t[k] = Σ_v S_{t-1}[k,v] do_t[v] + u[k] k_t[k] (do_t·v_t)
//     dw_t[k] = Σ_v dS_t[k,v] S_{t-1}[k,v]
//     du[k]   = Σ_{b,t} r_t[k] k_t[k] (do_t·v_t)
//     dS_{t-1} = diag(w_t) dS_t + r_tᵀ do_t,   ds0 = dS_{-1}.
//
// The forward takes one of two designs, chosen by T alone (never by B, so that a row's
// bits do not depend on the rows batched with it):
//
// T <= kStepMaxT: wkv_step_kernel (the decode step, T = 1), one launch.  The step's
//   bound is one pass over S: at the decode step's (4, 1, 64, 64) S is 4.2 MB read and
//   4.2 MB written, the rows 0.1 MB, 2.58 us at 3.35 TB/s.  One block of 256 threads
//   per (b, h); each thread owns one 16-byte vector of 4 adjacent state columns in
//   K / (256 / (K / 4)) rows (4 at K 64), held in registers across the T steps, so each
//   S element is loaded once (coalesced: a warp reads whole 256-byte rows) and stored
//   once.  Each step, the row's r, k, v, w go through shared memory; each thread sums
//   r_i S[i][c] and the bonus r_i u_i k_i over its rows, then updates its S in place
//   (fmaf(w_i, S, k_i v_c)); the row groups' partial sums meet in shared memory and K
//   threads add them in one fixed order (no atomics, the same bits every run).  No
//   scratch is written and no dynamic shared memory is opted in to: for T <= 64 the
//   chunk state the backward reads (S_c of chunk 0) is s0 itself, which the wrapper
//   hands over.  kStepMaxT (24) is measured (python -m repro_torch.kernels.rwkv6_wkv.compare,
//   builds of this file with kStepMaxT 0 and 64): see its definition below.
//
// T > kStepMaxT: the chunked pair, below.  Both directions run in chunks of 64 steps on
// the tensor cores (CPU mirrors:
// ../ref.py:wkv_chunked_ref and wkv_bwd_chunked_ref).  With lw = max(log w, -88) (the
// floor turns a w that underflowed to 0 into a decay below f32's normal range) and
// P(a, b) = Σ_{a<=m<b} lw_m over a chunk's local steps, a chunk of n <= 64 steps from
// state S_c gives
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
//
// The backward, with dS_{c+1} the cotangent at the end of chunk c:
//   dS_c = e^{P(0,n)} ⊙ dS_{c+1} + Σ_i (r_i ⊙ e^{P(0,i)})ᵀ do_i, and
//   dv_t = (k_t ⊙ e^{P(t+1,n)}) dS_{c+1} + Σ_{i>t} A_it do_i + (k_t·(u⊙r_t)) do_t.
// Read backward in time within a chunk (step i -> n - 1 - i), these are the forward's
// state update and output with r and k swapped and do in v's place.  So the forward's
// two kernels run them, templated on the direction (kRev: chunks walked last to first,
// each chunk's rows loaded and stored in reverse order, one more type for the v slot):
//   wkv_bwd_state_kernel  the forward's state walk backward: dS_c of every chunk to a
//       second scratch, ds0 at its end (from ds_final);
//   wkv_bwd_dv_kernel     the forward's chunk kernel backward: dv, from dS_{c+1}.
//   wkv_bwd_grad_kernel   grid (ceil(T / 64) K / 32, B·H), all chunks at once, 32 of
//       the K columns a block: dr, dk, dw and the chunk's du partial, from S_c (the
//       forward's scratch) and dS_{c+1}.  On the tensor cores: M = dO Vᵀ, H = dO S_cᵀ and
//       G = V dS_{c+1}ᵀ.  Then one warp a sub-chunk I, one lane a column k, on the CUDA
//       cores (every term below is elementwise in k): for t in I, with S the state at
//       the start of I and dS the cotangent at its end,
//         dr_t = Y_t[t] + u k_t (do_t·v_t),        Y_t[i] = (S_{t-1} do_i)[k]
//         dk_t = e^{suf_t} (dS v_t) + Σ_{i∈I, i>t} r_i e^{P(t+1,i)} (do_i·v_t) + bonus
//         dw_t = e^{suf_t} Σ_v dS ⊙ S_{t-1} + Σ_{i∈I, i>t} r_i e^{P(t+1,i)} Y_t[i].
//       S do_i, dS v_j and Σ_v dS ⊙ S at the sub-chunk's ends are sums over the other
//       sub-chunks in pieces (every factor e^{sum of pieces} <= 1); inside I they walk
//       by the recurrence itself (x <- w_t x + k_t ·), and the sums over i are Horner's
//       rule in w.  dw is the product of the two states, never d(log w) / w: nothing
//       divides by a decay, and any w in [0, 1) (exact zeros, 1e-30) is exact to rounding.
//   wkv_bwd_du_kernel     du[h] = the chunks' partials summed over b, then c, in order.
// Products in 3xTF32 (mma.sync m16n8k8): each f32 operand is hi = tf32(x) plus lo =
// tf32(x - hi), and a·b = a.lo b.hi + a.hi b.lo + a.hi b.hi in that order (a bf16
// operand is exact in TF32 and skips its lo).  One TF32 or bf16 pass is off by ~100x
// the 2e-4 tolerance; three are within it.  One fixed order of operations and no
// atomics: every run gives the same bits (activation checkpointing reruns the forward,
// and the data-parallel issue orders must stay bitwise equal).
//
// Bound.  The forward reads r, k, v (2 B each in bf16) and w (4 B) and writes out
// (4 B): 14 B per (b, t, h, k), 235 MB at the main path's (1, 4096, 64, 64), 0.070 ms
// at 3.35 TB/s.  Its arithmetic is 5 FLOP per state element per step (r·S: 2;
// w S + k v: 3), 5.37 GFLOP: 0.033 ms in 3xTF32 on the tensor cores (495 / 3 TFLOP/s),
// the path its products take, so it is bound by bytes (0.080 ms on the f32 CUDA cores
// at 67 TFLOP/s).  The chunked form pays for the scratch S_c (67 MB written and read
// again, ~0.04 ms) and for the serial walk over 64 chunks.  The backward reads r, k,
// v, w, dout and writes dr, dk, dv, dw (f32): 30 B per element, 503 MB, 0.150 ms; 14
// FLOP per state element per step (S: 3, dS: 3, dS·k, dS·v, S·do, dS⊙S: 2 each), 15.0
// GFLOP: 0.091 ms at 3xTF32's rate, 0.224 ms on the f32 CUDA cores: bound by bytes.
// Outside that bound: the scratches (S_c read, 67 MB; dS_c written and read, 134 MB)
// and the inputs that its four kernels each read again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The kernels' operands.  VIn is the type of the v slot: the forward's v (In), or do
// (f32) where the backward runs the forward's kernels with other operands in its slots.
template <typename In, typename VIn = In>
struct Args {
  const In *r, *k;
  const VIn* v;
  const float *w, *u, *s0, *dout;    // s0 may be null
  float *out, *sT;                   // forward outputs
  float* sc;                         // S_c of every chunk (B, H, NC, K, K)
  float* dsc;                        // dS_{c+1} of every chunk (B, H, NC, K, K)
  float *dr, *dk, *dw, *du;          // backward outputs
  float* part;                       // (B, H, NC, K): the chunks' du partials
  int B, T, H;
};

// ---------------------------------------------------------------------------
// The chunked form, its products on the tensor cores in 3xTF32.
// ---------------------------------------------------------------------------

constexpr int kL = 64;            // steps per chunk
constexpr int kSub = 8;           // steps per sub-chunk
constexpr int kNS = kL / kSub;    // sub-chunks per chunk
constexpr int kOutThreads = 256;  // the chunk kernels: 8 warps
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

// The state walk (wkv_fwd_state_kernel; backward in time, wkv_bwd_state_kernel): one
// block per 32 value columns of one (b, h), 4K threads: warp w owns the state rows
// 16 (w / 2) .. + 15 and the 16 columns 16 (w % 2) .. + 15 of the block's 32, in its
// mma accumulators, and every thread two (sub-chunk, column) pieces of a chunk.  Two
// stages of k, v, w: the next chunk's are in flight while the current one is computed.
constexpr int kSlice = 32;  // value columns a block
constexpr int kStages = 2;  // chunks of k, v, w in shared memory

template <int K, typename In, typename VIn>
struct StateSmem {
  In k[kStages][kL][K + 8];
  VIn v[kStages][kL][kSlice + 8];  // the block's columns
  float w[kStages][kL][K];
  float kt[kL][K + 8];      // k_j e^{P(j+1, n)}, the product's A operand (transposed)
  float tot[kNS][K];        // sub-chunk totals of lw
};

template <int K>
constexpr int kStateThreads = 4 * K;  // two pieces a thread

// kRev: the chunks from last to first, each one's rows from last to first; S_c goes to
// the scratch slot of its chunk.
template <int K, typename In, typename VIn, bool kRev>
__device__ __forceinline__ void state_walk(const Args<In, VIn>& a) {
  constexpr int kThr = kStateThreads<K>;
  constexpr bool kBExact = sizeof(VIn) == 2;  // bf16 v is exact in TF32
  static_assert(kThr / 32 == (K / 16) * (kSlice / 16), "a warp a 16 x 16 tile of the slice");
  extern __shared__ __align__(16) unsigned char wkv_smem[];
  StateSmem<K, In, VIn>& sm = *reinterpret_cast<StateSmem<K, In, VIn>*>(wkv_smem);
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

  auto chunk_of = [&](int c) { return kRev ? NC - 1 - c : c; };  // the c-th walked
  auto load = [&](int c, int stage) {
    const int t0 = chunk_of(c) * kL, n = min(kL, T_ - t0);
    const long long at = seq0 + (long long)(kRev ? t0 + n - 1 : t0) * HK, gs = kRev ? -HK : HK;
    load_rows(&sm.k[stage][0][0], K + 8, a.k + at, gs, kL, K, n, tid, kThr);
    load_rows(&sm.v[stage][0][0], kSlice + 8, a.v + at + v0, gs, kL, kSlice, n, tid, kThr);
    load_rows(&sm.w[stage][0][0], K, a.w + at, gs, kL, K, n, tid, kThr);
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
    const int stage = c % kStages, n = min(kL, T_ - chunk_of(c) * kL);
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; chunk c - 1's buffers are no longer read
    if (c + 1 < NC) load(c + 1, (c + 1) % kStages);
    store_state(a.sc + st0 * NC + (long long)chunk_of(c) * K * K);  // S_c

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

template <int K, typename In>
__global__ void __launch_bounds__(kStateThreads<K>) wkv_fwd_state_kernel(Args<In> a) {
  state_walk<K, In, In, false>(a);
}

// dS_c of every chunk into a.sc, ds0 into a.sT: the walk backward in time from a.s0
// (ds_final), with r in k's slot and do in v's.
template <int K, typename In>
__global__ void __launch_bounds__(kStateThreads<K>) wkv_bwd_state_kernel(Args<In, float> a) {
  state_walk<K, In, float, true>(a);
}

// The chunk kernel (wkv_fwd_out_kernel; backward in time, wkv_bwd_dv_kernel): one
// block per chunk of one (b, h), 8 warps.
template <int K, typename In, typename VIn>
struct OutSmem {
  In r[kL][K + 8], k[kL][K + 8];
  VIn v[kL][K + 8];
  float w[kL][K + 4];     // w, then lw (log2 units), then k_j e^{suf_j}
  float S[K][K + 8];      // S_c ([k][v])
  float pre[kL][K + 4];   // prefix exponents, then r_i e^{P(0, i)}
  float A[kL][kL + 4];    // the chunk's weights of v_j in out_i (j <= i)
  float tot[kNS][K];
  float btw[16][K];       // totals strictly between J = q and 2p, for the tiles of 3
  float u[K];
};

// kRev: the chunk's rows loaded and stored from last to first.
template <int K, typename In, typename VIn, bool kRev>
__device__ __forceinline__ void chunk_out(const Args<In, VIn>& a) {
  static_assert(kSub == 8 && kL == 64, "16-row tiles are two sub-chunks; four tiles a chunk");
  extern __shared__ __align__(16) unsigned char wkv_smem[];
  OutSmem<K, In, VIn>& sm = *reinterpret_cast<OutSmem<K, In, VIn>*>(wkv_smem);
  constexpr bool kBExact = sizeof(VIn) == 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, NC = (T_ + kL - 1) / kL, t0 = c * kL, n = min(kL, T_ - t0);
  const long long HK = (long long)a.H * K;
  const long long at = ((long long)b * T_ * a.H + h) * K + (long long)t0 * HK;  // (b, t0, h, 0)
  // row i of the block is step i of the chunk, or step n - 1 - i backward in time
  const long long row0 = kRev ? at + (long long)(n - 1) * HK : at, gs = kRev ? -HK : HK;

  load_rows(&sm.r[0][0], K + 8, a.r + row0, gs, kL, K, n, tid, kOutThreads);
  load_rows(&sm.k[0][0], K + 8, a.k + row0, gs, kL, K, n, tid, kOutThreads);
  load_rows(&sm.v[0][0], K + 8, a.v + row0, gs, kL, K, n, tid, kOutThreads);
  load_rows(&sm.w[0][0], K + 4, a.w + row0, gs, kL, K, n, tid, kOutThreads);
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
        *reinterpret_cast<float2*>(a.out + row0 + i0 * gs + col) = make_float2(d[q][0], d[q][1]);
      if (i1 < n)
        *reinterpret_cast<float2*>(a.out + row0 + i1 * gs + col) = make_float2(d[q][2], d[q][3]);
    }
  }
}

template <int K, typename In>
__global__ void __launch_bounds__(kOutThreads) wkv_fwd_out_kernel(Args<In> a) {
  chunk_out<K, In, In, false>(a);
}

// dv into a.out, from dS_{c+1} in a.sc: the chunk kernel backward in time, with k in
// r's slot, r in k's and do in v's.
template <int K, typename In>
__global__ void __launch_bounds__(kOutThreads) wkv_bwd_dv_kernel(Args<In, float> a) {
  chunk_out<K, In, float, true>(a);
}

// wkv_bwd_grad_kernel: one block per chunk of one (b, h) and 32 of its K columns (rows
// of S), 8 warps; warp I owns sub-chunk I in the CUDA-core phases, lane x column x.
constexpr int kCols = 32;  // columns a block

template <int K, typename In>
struct GradOperands {  // the products' operands, dead once the products are done
  In v[kL][K + 8];
  float d[kL][K + 4];                         // do
  float S[kCols][K + 4], dS[kCols][K + 4];  // the block's rows of S_c and dS_{c+1}
};

struct GradPieces {
  float rh[kL][kCols], kh[kL][kCols];  // r_i e^{pre_i}, k_j e^{suf_j}
  // W[J + 1][L] = Σ_{j∈J, i∈L} rh_i kh_j (do_i·v_j) for J + 2 <= L; J = -1 stands for
  // S_c (W[0][L] = Σ_{i∈L} rh_i (S_c do_i)), L = kNS for dS_{c+1} (W[J + 1][kNS] =
  // Σ_{j∈J} kh_j (dS_{c+1} v_j)), and W[0][kNS] = Σ_v dS_{c+1} ⊙ S_c
  float W[kNS + 1][kNS + 1][kCols];
};

template <int K, typename In>
struct GradSmem {
  In r[kL][kCols + 8], k[kL][kCols + 8];
  float w[kL][kCols + 4];
  float M[kL][kL + 4];     // do_i·v_j
  float H[kL][kCols + 4];  // S_c do_i, then S at the start of i's sub-chunk times do_i
  float G[kL][kCols + 4];  // dS_{c+1} v_j, then dS at the end of j's sub-chunk times v_j
  float tot[kNS][kCols];
  float c0[kCols];         // Σ_v dS_{c+1} ⊙ S_c
  float part[kNS][kCols];  // du partial of each sub-chunk
  float u[kCols];
  union {
    GradOperands<K, In> ops;
    GradPieces pc;
  };
};

template <int K, typename In>
__global__ void __launch_bounds__(kOutThreads) wkv_bwd_grad_kernel(Args<In> a) {
  static_assert(kSub == 8 && kL == 64 && kOutThreads / 32 == kNS && kCols == 32,
                "one warp a sub-chunk, one lane a column");
  constexpr bool kVExact = sizeof(In) == 2;  // bf16 v is exact in TF32
  extern __shared__ __align__(16) unsigned char wkv_smem[];
  GradSmem<K, In>& sm = *reinterpret_cast<GradSmem<K, In>*>(wkv_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  // a chunk's column blocks side by side in the grid: the second reads v and do from L2
  const int c = blockIdx.x / (K / kCols), c0 = blockIdx.x % (K / kCols) * kCols;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, NC = (T_ + kL - 1) / kL, t0 = c * kL, n = min(kL, T_ - t0);
  const long long HK = (long long)a.H * K;
  const long long at = ((long long)b * T_ * a.H + h) * K + (long long)t0 * HK;  // (b, t0, h, 0)
  const long long st = (((long long)bh * NC + c) * K + c0) * K;  // row c0 of S_c

  load_rows(&sm.r[0][0], kCols + 8, a.r + at + c0, HK, kL, kCols, n, tid, kOutThreads);
  load_rows(&sm.k[0][0], kCols + 8, a.k + at + c0, HK, kL, kCols, n, tid, kOutThreads);
  load_rows(&sm.w[0][0], kCols + 4, a.w + at + c0, HK, kL, kCols, n, tid, kOutThreads);
  load_rows(&sm.ops.v[0][0], K + 8, a.v + at, HK, kL, K, n, tid, kOutThreads);
  load_rows(&sm.ops.d[0][0], K + 4, a.dout + at, HK, kL, K, n, tid, kOutThreads);
  load_rows(&sm.ops.S[0][0], K + 4, a.sc + st, K, kCols, K, kCols, tid, kOutThreads);
  load_rows(&sm.ops.dS[0][0], K + 4, a.dsc + st, K, kCols, K, kCols, tid, kOutThreads);
  cp_async_commit();
  if (tid < kCols) sm.u[tid] = a.u[h * K + c0 + tid];
  cp_async_wait<0>();
  __syncthreads();

  // 1. On the tensor cores: M = dO Vᵀ (its 16 x 8 tiles that reach the diagonal or
  //    below), H = dO S_cᵀ and Gᵀ = dS_{c+1} Vᵀ over the block's columns (rows of S).
  //    Warp (p, half) takes rows 16 p of dO: the M tiles q = half, half + 2, ... <= 2p
  //    + 1 and the H tiles 2 half, 2 half + 1; and of the 16 Gᵀ tiles 4, 3, 1 or 0 (for
  //    p = 0 .. 3), all in one row block pg of dS.  One A fragment a row block and step.
  {
    static_assert(kCols / 8 == 4 && kL == 64, "two H tiles a warp, 16 Gᵀ tiles");
    const int p = warp >> 1, half = warp & 1, nm = p + 1;
    auto first = [](int w) { return w < 2 ? 4 * w : w < 4 ? 3 * w + 2 : w < 6 ? w + 10 : 16; };
    const int g0 = first(warp), ng = first(warp + 1) - g0, pg = g0 / 8 % 2, q0 = g0 % 8;
    const int i0 = 16 * p + g, i1 = i0 + 8, k0r = 16 * pg + g, k1r = k0r + 8;
    float dm[4][4] = {}, dh[2][4] = {}, dg[4][4] = {};
#pragma unroll 2
    for (int kb = 0; kb < K / 8; ++kb) {
      const int k0 = 8 * kb + t, k1 = k0 + 4;
      FragA fa;
      fa.set(sm.ops.d[i0][k0], sm.ops.d[i1][k0], sm.ops.d[i0][k1], sm.ops.d[i1][k1]);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (x < nm) {
          const int j = 8 * (half + 2 * x) + g;
          FragB fb;
          fb.set(to_f(sm.ops.v[j][k0]), to_f(sm.ops.v[j][k1]));
          mma3<kVExact>(dm[x], fa, fb);
        }
      }
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int kk = 8 * (2 * half + y) + g;
        FragB fb;
        fb.set(sm.ops.S[kk][k0], sm.ops.S[kk][k1]);
        mma3<false>(dh[y], fa, fb);
      }
      if (ng > 0) {
        FragA fs;
        fs.set(sm.ops.dS[k0r][k0], sm.ops.dS[k1r][k0], sm.ops.dS[k0r][k1], sm.ops.dS[k1r][k1]);
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          if (y < ng) {
            const int j = 8 * (q0 + y) + g;
            FragB fb;
            fb.set(to_f(sm.ops.v[j][k0]), to_f(sm.ops.v[j][k1]));
            mma3<kVExact>(dg[y], fs, fb);
          }
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (x < nm) {
        const int col = 8 * (half + 2 * x) + 2 * t;
        *reinterpret_cast<float2*>(&sm.M[i0][col]) = make_float2(dm[x][0], dm[x][1]);
        *reinterpret_cast<float2*>(&sm.M[i1][col]) = make_float2(dm[x][2], dm[x][3]);
      }
    }
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int col = 8 * (2 * half + y) + 2 * t;
      *reinterpret_cast<float2*>(&sm.H[i0][col]) = make_float2(dh[y][0], dh[y][1]);
      *reinterpret_cast<float2*>(&sm.H[i1][col]) = make_float2(dh[y][2], dh[y][3]);
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      if (y < ng) {  // stored transposed into G
        const int jc = 8 * (q0 + y) + 2 * t;
        sm.G[jc][k0r] = dg[y][0];
        sm.G[jc + 1][k0r] = dg[y][1];
        sm.G[jc][k1r] = dg[y][2];
        sm.G[jc + 1][k1r] = dg[y][3];
      }
    }
  }
  if (tid < kCols) {
    float p = 0.f;
    for (int v = 0; v < K; ++v) p = fmaf(sm.ops.dS[tid][v], sm.ops.S[tid][v], p);
    sm.c0[tid] = p;
  }
  __syncthreads();  // the operands are dead: rh, kh and W take their space

  // 2. The pieces of sub-chunk I = warp in column `lane`: lw (log2 units), the
  //    prefixes into rh, the suffixes into kh and registers, the total.
  const int I = warp;
  float suf[kSub];
  {
    float l[kSub], p = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int i = kSub * I + s;
      l[s] = i < n ? log2_decay(sm.w[i][lane]) : 0.f;
      sm.pc.rh[i][lane] = to_f(sm.r[i][lane]) * exp2_neg(p);
      p += l[s];
    }
    sm.tot[I][lane] = p;
    float q = 0.f;
#pragma unroll
    for (int s = kSub - 1; s >= 0; --s) {
      const int i = kSub * I + s;
      suf[s] = q;
      sm.pc.kh[i][lane] = to_f(sm.k[i][lane]) * exp2_neg(q);
      q += l[s];
    }
  }
  __syncthreads();

  // 3. The sums across sub-chunks: with eb[J + 1] = e^{totals strictly between J and I}
  //    (J = -1: all before I) and ea[L] = e^{totals strictly between I and L} (L = kNS:
  //    all after I), each summed in increasing order,
  //      H_i <- Xc_i = eb[0] H_i + Σ_{J<I} eb[J + 1] Σ_{j∈J} (do_i·v_j) kh_j   (i in I)
  //      G_j <- Zc_j = ea[kNS] G_j + Σ_{L>I} ea[L] Σ_{i∈L} (do_i·v_j) rh_i     (j in I)
  //    and this warp's terms of W.
  float eb[kNS + 1], ea[kNS + 1];
#pragma unroll
  for (int J = -1; J < kNS; ++J) {
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int m = 0; m < kNS; ++m) {
      x += m > J && m < I ? sm.tot[m][lane] : 0.f;
      y += m > I && m < J + 1 ? sm.tot[m][lane] : 0.f;
    }
    eb[J + 1] = exp2_neg(x);  // for J < I
    ea[J + 1] = exp2_neg(y);  // for J + 1 > I
  }
  {
    float x[kSub], rh[kSub], hh = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int i = kSub * I + s;
      rh[s] = sm.pc.rh[i][lane];
      x[s] = eb[0] * sm.H[i][lane];
      hh = fmaf(rh[s], sm.H[i][lane], hh);
    }
    if (I >= 1) sm.pc.W[0][I][lane] = hh;
#pragma unroll
    for (int J = 0; J < kNS - 1; ++J) {
      if (J < I) {
        float kh[kSub];
#pragma unroll
        for (int j = 0; j < kSub; ++j) kh[j] = sm.pc.kh[kSub * J + j][lane];
        float wsum = 0.f;
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          const float* mrow = &sm.M[kSub * I + s][kSub * J];
          const float4 m0 = *reinterpret_cast<const float4*>(mrow);
          const float4 m1 = *reinterpret_cast<const float4*>(mrow + 4);
          float pk = m0.x * kh[0];
          pk = fmaf(m0.y, kh[1], pk);
          pk = fmaf(m0.z, kh[2], pk);
          pk = fmaf(m0.w, kh[3], pk);
          pk = fmaf(m1.x, kh[4], pk);
          pk = fmaf(m1.y, kh[5], pk);
          pk = fmaf(m1.z, kh[6], pk);
          pk = fmaf(m1.w, kh[7], pk);
          x[s] = fmaf(eb[J + 1], pk, x[s]);
          wsum = fmaf(rh[s], pk, wsum);
        }
        if (J + 2 <= I) sm.pc.W[J + 1][I][lane] = wsum;
      }
    }
    float z[kSub], gg = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int j = kSub * I + s;
      z[s] = ea[kNS] * sm.G[j][lane];
      gg = fmaf(sm.pc.kh[j][lane], sm.G[j][lane], gg);
    }
    if (I + 2 <= kNS) sm.pc.W[I + 1][kNS][lane] = gg;
#pragma unroll
    for (int L = 1; L < kNS; ++L) {
      if (L > I) {
        float pr[kSub] = {};
#pragma unroll
        for (int x = 0; x < kSub; ++x) {
          const int i = kSub * L + x;
          const float ri = sm.pc.rh[i][lane];
          const float4 m0 = *reinterpret_cast<const float4*>(&sm.M[i][kSub * I]);
          const float4 m1 = *reinterpret_cast<const float4*>(&sm.M[i][kSub * I + 4]);
          pr[0] = fmaf(m0.x, ri, pr[0]);
          pr[1] = fmaf(m0.y, ri, pr[1]);
          pr[2] = fmaf(m0.z, ri, pr[2]);
          pr[3] = fmaf(m0.w, ri, pr[3]);
          pr[4] = fmaf(m1.x, ri, pr[4]);
          pr[5] = fmaf(m1.y, ri, pr[5]);
          pr[6] = fmaf(m1.z, ri, pr[6]);
          pr[7] = fmaf(m1.w, ri, pr[7]);
        }
#pragma unroll
        for (int s = 0; s < kSub; ++s) z[s] = fmaf(ea[L], pr[s], z[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) {  // rows of I: read by this warp alone
      sm.H[kSub * I + s][lane] = x[s];
      sm.G[kSub * I + s][lane] = z[s];
    }
  }
  if (tid < kCols) sm.pc.W[0][kNS][tid] = sm.c0[tid];
  __syncthreads();

  // 4. phi = Σ_v dS ⊙ S at the start of I (dS the cotangent at the end of I, S the state
  //    at its start) from W, then the walk through I's steps.
  float phi = 0.f;
#pragma unroll
  for (int J = -1; J < kNS - 1; ++J) {
    if (J < I) {
      float inner = ea[kNS] * sm.pc.W[J + 1][kNS][lane];
#pragma unroll
      for (int L = 1; L < kNS; ++L)
        if (L > I) inner = fmaf(ea[L], sm.pc.W[J + 1][L][lane], inner);
      phi = fmaf(eb[J + 1], inner, phi);
    }
  }
  float y[kSub], z[kSub], wv[kSub], rv[kSub], kv[kSub];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const int i = kSub * I + s;
    y[s] = sm.H[i][lane];
    z[s] = sm.G[i][lane];
    wv[s] = sm.w[i][lane];
    rv[s] = to_f(sm.r[i][lane]);
    kv[s] = to_f(sm.k[i][lane]);
  }
  const float uk = sm.u[lane];
  float* const dr = a.dr + at + c0 + lane;
  float* const dk = a.dk + at + c0 + lane;
  float* const dw = a.dw + at + c0 + lane;
  float du = 0.f;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const int i = kSub * I + s;
    const float mss = sm.M[i][i];
    float zy = 0.f, zm = 0.f;  // Σ_{x>s} r_x Π_{s<m<x} w_m (Y_x, M[x][i]): Horner's rule
#pragma unroll
    for (int x = kSub - 1; x > s; --x) {
      zy = fmaf(wv[x], zy, rv[x] * y[x]);
      zm = fmaf(wv[x], zm, rv[x] * sm.M[kSub * I + x][i]);
    }
    const float es = exp2_neg(suf[s]);
    if (i < n) {
      dr[i * HK] = fmaf(uk * kv[s], mss, y[s]);
      dk[i * HK] = fmaf(uk * rv[s], mss, fmaf(es, z[s], zm));
      dw[i * HK] = fmaf(es, phi, zy);
    }
    du = fmaf(rv[s] * kv[s], mss, du);
    phi = fmaf(wv[s], phi, kv[s] * z[s]);
#pragma unroll
    for (int x = s + 1; x < kSub; ++x) y[x] = fmaf(wv[s], y[x], kv[s] * sm.M[kSub * I + x][i]);
  }
  sm.part[I][lane] = du;
  __syncthreads();
  if (tid < kCols) {  // the chunk's du partial: its sub-chunks' in order
    float p = 0.f;
#pragma unroll
    for (int x = 0; x < kNS; ++x) p += sm.part[x][tid];
    a.part[((long long)bh * NC + c) * K + c0 + tid] = p;
  }
}

// du[h, k]: the chunks' partials of head h, over b, then c, in order.
__global__ void wkv_bwd_du_kernel(const float* part, float* du, int B, int NC, int H) {
  const int h = blockIdx.x, k = threadIdx.x, K = blockDim.x;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < NC; ++c) s += part[(((long long)b * H + h) * NC + c) * K + k];
  du[h * K + k] = s;
}

// ---------------------------------------------------------------------------
// The step kernel: T <= kStepMaxT, the recurrence itself, one pass over S.
// ---------------------------------------------------------------------------

// The longest T that the forward runs in the step kernel.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (python -m repro_torch.kernels.rwkv6_wkv.compare, builds with kStepMaxT
// 0 and 64, device time at (B, T, 64, 64) bf16 with s0): at B 1 the step kernel wins through
// T 24 (14.68 us against the chunked pair's 16.48) and loses at 32 (19.06 against 16.55):
// each step is a serial round of three barriers.  At B 4 it wins through T 48, but a choice
// by B would let a row's bits depend on its batch.  At T 1: 2.13 / 3.08 us at B 1 / 4,
// against 14.97 / 28.10 for the chunked pair.
constexpr int kStepMaxT = 24;
constexpr int kStepThreads = 256;

template <int K>
struct StepSmem {
  float row[4][K];                                     // r, k, v, w of the step
  float u[K];
  float4 part[kStepThreads / (K / 4)][K / 4];          // each row group's r·S
  float bonus[kStepThreads / (K / 4)];                 // each row group's r·(u⊙k)
};

// One block per (b, h); thread (g, c) owns columns 4c .. 4c + 3 of rows gR .. gR + R - 1.
template <int K, typename In>
__global__ void __launch_bounds__(kStepThreads) wkv_step_kernel(Args<In> a) {
  constexpr int kVecs = K / 4;                  // 16-byte column vectors a row
  constexpr int kGroups = kStepThreads / kVecs;  // row groups
  constexpr int R = K / kGroups;                // rows a thread
  static_assert(R >= 1 && kGroups * R == K, "K 32 or 64");
  __shared__ __align__(16) StepSmem<K> sm;
  const int tid = threadIdx.x, c = tid % kVecs, g = tid / kVecs;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const long long HK = (long long)a.H * K;
  const long long st = (long long)bh * K * K + (long long)g * R * K + 4 * c;  // (b, h, gR, 4c)
  float4 S[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    S[j] = a.s0 != nullptr ? *reinterpret_cast<const float4*>(a.s0 + st + (long long)j * K)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < K) sm.u[tid] = a.u[h * K + tid];
  for (int t = 0; t < a.T; ++t) {
    const long long at = ((long long)b * a.T + t) * HK + (long long)h * K;  // (b, t, h, 0)
    __syncthreads();  // the last step's sums are read
    for (int e = tid; e < 4 * K; e += kStepThreads) {
      const int which = e / K, col = e % K;
      sm.row[which][col] = which == 0 ? to_f(a.r[at + col])
                         : which == 1 ? to_f(a.k[at + col])
                         : which == 2 ? to_f(a.v[at + col]) : a.w[at + col];
    }
    __syncthreads();
    const float4 v = *reinterpret_cast<const float4*>(&sm.row[2][4 * c]);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float bonus = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = g * R + j;
      const float ri = sm.row[0][i], ki = sm.row[1][i], wi = sm.row[3][i];
      acc.x = fmaf(ri, S[j].x, acc.x);
      acc.y = fmaf(ri, S[j].y, acc.y);
      acc.z = fmaf(ri, S[j].z, acc.z);
      acc.w = fmaf(ri, S[j].w, acc.w);
      bonus = fmaf(ri * sm.u[i], ki, bonus);
      S[j].x = fmaf(wi, S[j].x, ki * v.x);
      S[j].y = fmaf(wi, S[j].y, ki * v.y);
      S[j].z = fmaf(wi, S[j].z, ki * v.z);
      S[j].w = fmaf(wi, S[j].w, ki * v.w);
    }
    sm.part[g][c] = acc;
    if (c == 0) sm.bonus[g] = bonus;
    __syncthreads();
    if (tid < K) {  // out[col]: the row groups' sums in order, then the bonus
      const float* part = reinterpret_cast<const float*>(&sm.part[0][0]);
      float o = 0.f, bsum = 0.f;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        o += part[q * K + tid];
        bsum += sm.bonus[q];
      }
      a.out[at + tid] = fmaf(bsum, sm.row[2][tid], o);
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) *reinterpret_cast<float4*>(a.sT + st + (long long)j * K) = S[j];
}

template <int K, typename In>
int launch_step(const Args<In>& a, cudaStream_t st) {
  wkv_step_kernel<K, In><<<a.B * a.H, kStepThreads, 0, st>>>(a);
  return int(cudaGetLastError());
}

// Opts kKernel in to `bytes` of dynamic shared memory (once), then launches it.
template <auto kKernel, typename A>
int launch(dim3 grid, int threads, int bytes, const A& a, cudaStream_t st) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return int(attr);
  kKernel<<<grid, threads, bytes, st>>>(a);
  return int(cudaGetLastError());
}

template <int K, typename In>
int launch_fwd(const Args<In>& a, cudaStream_t st) {
  const int NC = (a.T + kL - 1) / kL;
  const int err = launch<wkv_fwd_state_kernel<K, In>>(
      dim3(K / kSlice, a.B * a.H), kStateThreads<K>, sizeof(StateSmem<K, In, In>), a, st);
  if (err) return err;
  return launch<wkv_fwd_out_kernel<K, In>>(dim3(NC, a.B * a.H), kOutThreads,
                                           sizeof(OutSmem<K, In, In>), a, st);
}

// states_ready: a.sc holds the forward's S_c; else the forward's walk fills it first,
// its s_final passing through ds0.
template <int K, typename In>
int launch_bwd(const Args<In>& a, bool states_ready, const float* ds_final, float* dv,
               float* ds0, cudaStream_t st) {
  const int NC = (a.T + kL - 1) / kL, BH = a.B * a.H;
  int err;
  if (!states_ready) {
    Args<In> f = a;
    f.sT = ds0;
    err = launch<wkv_fwd_state_kernel<K, In>>(dim3(K / kSlice, BH), kStateThreads<K>,
                                              sizeof(StateSmem<K, In, In>), f, st);
    if (err) return err;
  }
  // backward in time: k in r's slot, r in k's, do in v's, ds_final as the state
  Args<In, float> rv{};
  rv.r = a.k;
  rv.k = a.r;
  rv.v = a.dout;
  rv.w = a.w;
  rv.u = a.u;
  rv.s0 = ds_final;
  rv.sc = a.dsc;
  rv.sT = ds0;
  rv.out = dv;
  rv.B = a.B;
  rv.T = a.T;
  rv.H = a.H;
  err = launch<wkv_bwd_state_kernel<K, In>>(dim3(K / kSlice, BH), kStateThreads<K>,
                                            sizeof(StateSmem<K, In, float>), rv, st);
  if (err) return err;
  err = launch<wkv_bwd_dv_kernel<K, In>>(dim3(NC, BH), kOutThreads,
                                         sizeof(OutSmem<K, In, float>), rv, st);
  if (err) return err;
  err = launch<wkv_bwd_grad_kernel<K, In>>(dim3(NC * (K / kCols), BH), kOutThreads,
                                           sizeof(GradSmem<K, In>), a, st);
  if (err) return err;
  wkv_bwd_du_kernel<<<a.H, K, 0, st>>>(a.part, a.du, a.B, NC, a.H);
  return int(cudaGetLastError());
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

// The chunk and sub-chunk lengths in steps: the wrapper sizes the scratches from the
// first and holds the CPU mirrors to both.
extern "C" int wkv_fwd_chunk() { return kL; }
extern "C" int wkv_fwd_sub() { return kSub; }
// The longest T that wkv_fwd runs in the step kernel.
extern "C" int wkv_step_max_t() { return kStepMaxT; }

// r, k, v: (B, T, H, K), f32 (bf16 = 0) or bf16 (bf16 = 1); w, out: (B, T, H, K) f32;
// u: (H, K) f32; s0, s_final: (B, H, K, K) f32, 16-byte aligned; s0 may be null (a zero
// state); scratch chunk_states: (B, H, ceil(T / wkv_fwd_chunk()), K, K) f32, unused (may be
// null) for T <= wkv_step_max_t().  All contiguous; K is 32 or 64.  For T <= wkv_step_max_t()
// one launch of the step kernel, else the chunked pair's two, on `stream`.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int wkv_fwd(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const float* s0, float* out, float* s_final,
                       float* chunk_states, int B, int T, int H, int K, int bf16, void* stream) {
  if (!valid(B, T, H, K)) return int(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(s0) % 16 || reinterpret_cast<uintptr_t>(s_final) % 16)
    return int(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto a) {
    a.out = out;
    a.sT = s_final;
    a.sc = chunk_states;
    if (T <= kStepMaxT) return K == 32 ? launch_step<32>(a, st) : launch_step<64>(a, st);
    return K == 32 ? launch_fwd<32>(a, st) : launch_fwd<64>(a, st);
  };
  return bf16 ? run(make_args<__nv_bfloat16>(r, k, v, w, u, s0, B, T, H))
              : run(make_args<float>(r, k, v, w, u, s0, B, T, H));
}

// The gradient of wkv_fwd.  Inputs as there, plus dout (B, T, H, K) f32 and ds_final
// (B, H, K, K) f32 (may be null: zero).  Outputs dr, dk, dv, dw (B, T, H, K), du (H, K)
// and ds0 (B, H, K, K), all f32, ds0 always written.  chunk_states: wkv_fwd's scratch for
// these inputs if states_ready, else filled here first (one more launch).  Scratch:
// ds_chunks, shaped as chunk_states, and part (B, H, ceil(T / wkv_fwd_chunk()), K) f32.
// Four or five launches on `stream`.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int wkv_bwd(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const float* s0, const float* dout,
                       const float* ds_final, float* chunk_states, int states_ready, float* dr,
                       float* dk, float* dv, float* dw, float* du, float* ds0, float* ds_chunks,
                       float* part, int B, int T, int H, int K, int bf16, void* stream) {
  if (!valid(B, T, H, K)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto a) {
    a.dout = dout;
    a.sc = chunk_states;
    a.dsc = ds_chunks;
    a.dr = dr;
    a.dk = dk;
    a.dw = dw;
    a.du = du;
    a.part = part;
    return K == 32 ? launch_bwd<32>(a, states_ready != 0, ds_final, dv, ds0, st)
                   : launch_bwd<64>(a, states_ready != 0, ds_final, dv, ds0, st);
  };
  return bf16 ? run(make_args<__nv_bfloat16>(r, k, v, w, u, s0, B, T, H))
              : run(make_args<float>(r, k, v, w, u, s0, B, T, H));
}

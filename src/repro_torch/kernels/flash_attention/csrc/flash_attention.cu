// Flash-attention forward, dQ and dK/dV kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention/:
//   flash_fwd_kernel <- _fwd_kernel / flash_attention_fwd   (kernel.py:40, :167)
//   flash_dq_kernel  <- _dq_kernel  / flash_attention_bwd   (kernel_bwd.py:53, :185)
//   flash_dkv_kernel <- _dkv_kernel / flash_attention_bwd   (kernel_bwd.py:89, :212)
//
// What they compute (the plain versions are in ../ref.py).  q is (B, Sq, Hq, hd),
// k and v are (B, Sk, Hkv, hd), query head h reads KV head h / G with G = Hq / Hkv,
// and for one (b, h) with s = softcap(q k^T * hd^-1/2) under the causal / window
// mask:
//   forward  o = softmax(s) v, lse = rowwise logsumexp(s); a row that sees no key
//            gets o = 0 (and lse = -1e30)
//   dQ       p = exp(s - lse), ds = p * (dO v^T - delta) * (1 - t^2) * hd^-1/2,
//            dq = ds k                           (delta = rowsum(dO * o), t = tanh)
//   dK/dV    dv = sum over the G heads of p^T dO, dk = sum over the G heads of ds^T q
//
// Bound.  At the main path's shape (B 4, S 512, 32 query / 4 KV heads, hd 64, bf16)
// one launch moves ~19-28 MB and does 4-9 GFLOP of causal products: the forward
// and dQ are bound by device memory (~6-8 us at 3.35 TB/s), dK/dV by the bf16
// tensor-core rate (~9 us at 989 TFLOP/s).  These kernels are the simple, right
// first version: every product runs in f32 on the CUDA cores, so they sit far
// above that bound.  wgmma/TMA tiles are later work.
//
// Design.  The TPU kernels carry their f32 accumulators in VMEM scratch across a
// sequential grid axis.  Here each block owns its output tile and loops over the
// other axis itself, so nothing carries between blocks:
//   forward: one block per (q tile, q head, b), looping over the KV tiles its
//            rows can see (tiles that the causal mask or the window hide entirely
//            are skipped; that changes no row with a visible key).  Online
//            softmax with the row max, row sum and output accumulator in f32.
//   dQ:      one block per (q tile, q head, b), looping over KV tiles, p
//            recomputed from lse, dq accumulated in f32.
//   dK/dV:   one block per (k tile, KV head, b), looping in a fixed order over
//            the G query heads of its group and over their q tiles, dk and dv
//            accumulated in f32 and written once, at the KV head.  There is no
//            G-times f32 buffer and no atomic anywhere: each output element has
//            one writer and one summation order, so every run gives the same bits
//            (a recomputed forward under activation checkpointing equals the
//            first, and the data-parallel issue orders stay bitwise equal).
// Tiles are staged in shared memory as f32 (bf16 inputs are widened on load), rows
// padded to hd + 1 floats so that the threads of a warp that read one column of
// different rows hit different banks.  256 threads form a 16 x 16 grid; thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j of every tile, so a row's
// max and sum reduce over the 16 lanes of a half-warp with shuffles.  hd 256 uses
// 32-row tiles to stay inside the 227 KB of shared memory a block may have.
// Masked scores use the flag of the mask, never a sentinel value, so a row that
// sees no key contributes p = 0 everywhere (the TPU kernel's -1e30 sentinel gives
// such a row exp(0) = 1 weights; its documented semantics and attention_ref give 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

struct Shape {
  int B, Sq, Sk, Hq, Hkv, G;
  long long qsb, qss, qsh;  // element strides of q, o, dO, dq: batch, sequence, head
  long long ksb, kss, ksh;  // element strides of k, v, dk, dv
  int causal, window;       // window <= 0: no window
  float scale, softcap;     // softcap <= 0: no softcap
};

template <int HD>
struct Tiles {  // rows of a q tile and of a k tile
  static constexpr int BQ = HD > 128 ? 32 : 64;
  static constexpr int BK = BQ;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows [row0, row0 + ROWS) of one head into dst (ROWS x (HD + 1) f32); rows at or
// past n read as 0.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long base,
                                          long long row_stride, int row0, int n) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, s = row0 + r;
    dst[r * (HD + 1) + d] = s < n ? to_f32(src[base + s * row_stride + d]) : 0.f;
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

__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
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

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Shape p) {
  constexpr int TM = BQ / 16, TN = BK / 16, TD = HD / 16, LD = HD + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;          // BQ x LD
  float* sK = sQ + BQ * LD;  // BK x LD
  float* sV = sK + BK * LD;  // BK x LD
  float* sP = sV + BK * LD;  // BQ x LP
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long qbase = b * p.qsb + h * p.qsh;
  const long long kbase = b * p.ksb + (h / p.G) * p.ksh;
  load_tile<T, HD, BQ>(sQ, q, qbase, p.qss, q0, p.Sq);

  float acc[TM][TD], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  key_range(p, q0, min(q0 + BQ, p.Sq), &lo, &hi);
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<T, HD, BK>(sK, k, kbase, p.kss, k0, p.Sk);
    load_tile<T, HD, BK>(sV, v, kbase, p.kss, k0, p.Sk);
    __syncthreads();
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[TM], c[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool vis[TN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float dc;
        vis[j] = visible(p, qpos, k0 + tx + 16 * j);
        s[i][j] = score(p, s[i][j], &dc);
        if (vis[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float pj = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * LP + tx + 16 * j] = pj;
        rs += pj;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], c[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sP[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < TD; ++j) c[j] = sV[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // a row that sees no key: acc = 0
#pragma unroll
    for (int j = 0; j < TD; ++j) store(o + qbase + qpos * p.qss + tx + 16 * j, acc[i][j] / li);
    if (tx == 0) lse[(static_cast<long long>(b) * p.Sq + qpos) * p.Hq + h] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, Shape p) {
  constexpr int TM = BQ / 16, TN = BK / 16, TD = HD / 16, LD = HD + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;          // BQ x LD
  float* sO = sQ + BQ * LD;  // BQ x LD: dO
  float* sK = sO + BQ * LD;  // BK x LD
  float* sV = sK + BK * LD;  // BK x LD
  float* sS = sV + BK * LD;  // BQ x LP: dS
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long qbase = b * p.qsb + h * p.qsh;
  const long long kbase = b * p.ksb + (h / p.G) * p.ksh;
  load_tile<T, HD, BQ>(sQ, q, qbase, p.qss, q0, p.Sq);
  load_tile<T, HD, BQ>(sO, dout, qbase, p.qss, q0, p.Sq);

  float acc[TM][TD], L[TM], D[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = q0 + ty + 16 * i;
    const long long row = (static_cast<long long>(b) * p.Sq + qpos) * p.Hq + h;
    L[i] = qpos < p.Sq ? lse[row] : 0.f;
    D[i] = qpos < p.Sq ? delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  key_range(p, q0, min(q0 + BQ, p.Sq), &lo, &hi);
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();
    load_tile<T, HD, BK>(sK, k, kbase, p.kss, k0, p.Sk);
    load_tile<T, HD, BK>(sV, v, kbase, p.kss, k0, p.Sk);
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[TM], a2[TM], c[TN], c2[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = sQ[(ty + 16 * i) * LD + d];
        a2[i] = sO[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        c[j] = sK[(tx + 16 * j) * LD + d];
        c2[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(a2[i], c2[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float dc;
        const float x = score(p, s[i][j], &dc);
        const float pr = visible(p, qpos, k0 + tx + 16 * j) ? expf(x - L[i]) : 0.f;
        sS[(ty + 16 * i) * LP + tx + 16 * j] = pr * (dp[i][j] - D[i]) * dc * p.scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], c[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sS[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < TD; ++j) c[j] = sK[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) store(dq + qbase + qpos * p.qss + tx + 16 * j, acc[i][j]);
  }
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 Shape p) {
  constexpr int TK = BK / 16, TQ = BQ / 16, TD = HD / 16, LD = HD + 1, LT = BQ + 1;
  extern __shared__ float smem[];
  float* sK = smem;           // BK x LD
  float* sV = sK + BK * LD;   // BK x LD
  float* sQ = sV + BK * LD;   // BQ x LD
  float* sO = sQ + BQ * LD;   // BQ x LD: dO
  float* sP = sO + BQ * LD;   // BK x LT: p, transposed
  float* sS = sP + BK * LT;   // BK x LT: dS, transposed
  float* sL = sS + BK * LT;   // BQ: lse of the q tile's rows
  float* sD = sL + BQ;        // BQ: delta
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const long long kbase = b * p.ksb + hk * p.ksh;
  load_tile<T, HD, BK>(sK, k, kbase, p.kss, k0, p.Sk);
  load_tile<T, HD, BK>(sV, v, kbase, p.kss, k0, p.Sk);

  float acc_k[TK][TD], acc_v[TK][TD];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  int lo, hi;
  query_range(p, k0, min(k0 + BK, p.Sk), &lo, &hi);
  for (int g = 0; g < p.G; ++g) {  // fixed order: the same sum in every run
    const int h = hk * p.G + g;
    const long long qbase = b * p.qsb + h * p.qsh;
    for (int q0 = (lo / BQ) * BQ; q0 < hi; q0 += BQ) {
      __syncthreads();
      load_tile<T, HD, BQ>(sQ, q, qbase, p.qss, q0, p.Sq);
      load_tile<T, HD, BQ>(sO, dout, qbase, p.qss, q0, p.Sq);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int qpos = q0 + r;
        const long long row = (static_cast<long long>(b) * p.Sq + qpos) * p.Hq + h;
        sL[r] = qpos < p.Sq ? lse[row] : 0.f;
        sD[r] = qpos < p.Sq ? delta[row] : 0.f;
      }
      __syncthreads();
      float s[TK][TQ], dp[TK][TQ];  // transposed: [key row][query row]
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[TK], a2[TK], c[TQ], c2[TQ];
#pragma unroll
        for (int i = 0; i < TK; ++i) {
          a[i] = sK[(ty + 16 * i) * LD + d];
          a2[i] = sV[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
          c[j] = sQ[(tx + 16 * j) * LD + d];
          c2[j] = sO[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < TK; ++i)
#pragma unroll
          for (int j = 0; j < TQ; ++j) {
            s[i][j] = fmaf(c[j], a[i], s[i][j]);
            dp[i][j] = fmaf(c2[j], a2[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
          const int r = tx + 16 * j;
          float dc;
          const float x = score(p, s[i][j], &dc);
          const float pr = visible(p, q0 + r, kpos) ? expf(x - sL[r]) : 0.f;
          sP[(ty + 16 * i) * LT + r] = pr;
          sS[(ty + 16 * i) * LT + r] = pr * (dp[i][j] - sD[r]) * dc * p.scale;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pa[TK], sa[TK], co[TD], cq[TD];
#pragma unroll
        for (int i = 0; i < TK; ++i) {
          pa[i] = sP[(ty + 16 * i) * LT + r];
          sa[i] = sS[(ty + 16 * i) * LT + r];
        }
#pragma unroll
        for (int j = 0; j < TD; ++j) {
          co[j] = sO[r * LD + tx + 16 * j];
          cq[j] = sQ[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < TK; ++i)
#pragma unroll
          for (int j = 0; j < TD; ++j) {
            acc_v[i][j] = fmaf(pa[i], co[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sa[i], cq[j], acc_k[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      store(dk + kbase + kpos * p.kss + tx + 16 * j, acc_k[i][j]);
      store(dv + kbase + kpos * p.kss + tx + 16 * j, acc_v[i][j]);
    }
  }
}

// Shared memory of each kernel, in bytes.
template <int HD>
constexpr size_t fwd_smem() {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  return sizeof(float) * ((BQ + 2 * BK) * (HD + 1) + BQ * (BK + 1));
}
template <int HD>
constexpr size_t dq_smem() {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  return sizeof(float) * (2 * (BQ + BK) * (HD + 1) + BQ * (BK + 1));
}
template <int HD>
constexpr size_t dkv_smem() {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  return sizeof(float) * (2 * (BQ + BK) * (HD + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& p,
               cudaStream_t stream) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  constexpr size_t smem = fwd_smem<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<T, HD, BQ, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, p);
  return int(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, const Shape& p, cudaStream_t stream) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  constexpr size_t smem = dq_smem<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dq_kernel<T, HD, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_dq_kernel<T, HD, BQ, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), p);
  return int(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, const Shape& p, cudaStream_t stream) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  constexpr size_t smem = dkv_smem<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_kernel<T, HD, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((p.Sk + BK - 1) / BK, p.Hkv, p.B);
  flash_dkv_kernel<T, HD, BQ, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), p);
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
  return p.B > 0 && p.Sq > 0 && p.Sk > 0 && p.Hkv > 0 && p.Hq % p.Hkv == 0 && p.Hq <= 65535 &&
         p.B <= 65535;
}

}  // namespace

// One call per kernel.  dims = {B, Sq, Sk, Hq, Hkv, hd}; strides = {q batch, q seq,
// q head, k batch, k seq, k head} in elements (the last axis is contiguous; o, dO and
// dq share q's strides, v, dk and dv share k's); lse and delta are (B, Sq, Hq) f32,
// contiguous.  bf16 != 0: q, k, v, dO and the outputs are bf16, else f32.  Each
// returns the cudaError_t of the launch (0 on success).
#define FLASH_DISPATCH(FN, ...)                                                     \
  switch (dims[5]) {                                                                \
    case 32: return bf16 ? FN<__nv_bfloat16, 32>(__VA_ARGS__) : FN<float, 32>(__VA_ARGS__);    \
    case 64: return bf16 ? FN<__nv_bfloat16, 64>(__VA_ARGS__) : FN<float, 64>(__VA_ARGS__);    \
    case 128: return bf16 ? FN<__nv_bfloat16, 128>(__VA_ARGS__) : FN<float, 128>(__VA_ARGS__); \
    case 256: return bf16 ? FN<__nv_bfloat16, 256>(__VA_ARGS__) : FN<float, 256>(__VA_ARGS__); \
    default: return int(cudaErrorInvalidValue);                                     \
  }

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         const int* dims, const long long* strides, int causal, int window,
                         float scale, float softcap, int bf16, void* stream) {
  const Shape p = make_shape(dims, strides, causal, window, scale, softcap);
  if (!valid(p)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, o, lse, p, st)
}

extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, const int* dims,
                        const long long* strides, int causal, int window, float scale,
                        float softcap, int bf16, void* stream) {
  const Shape p = make_shape(dims, strides, causal, window, scale, softcap);
  if (!valid(p)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, p, st)
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv,
                         const int* dims, const long long* strides, int causal, int window,
                         float scale, float softcap, int bf16, void* stream) {
  const Shape p = make_shape(dims, strides, causal, window, scale, softcap);
  if (!valid(p)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, p, st)
}

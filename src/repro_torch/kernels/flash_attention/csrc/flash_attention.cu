// Flash attention for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU Pallas kernel of the JAX package:
//   flash_fwd_mma_kernel, <- kernels/flash_attention/flash_attention.py::_attn_kernel
//   flash_fwd_kernel         (flash_attention_fwd, :29-89)
// and gives it the backward the TPU side never had (the reference
// recomputes its gradient through the oracle's VJP, which on this card
// would materialise (b, H, s, L) f32 scores per buffer per layer), in
// FlashAttention-2's split:
//   flash_bwd_preprocess_kernel                       D = rowsum(dO * O)
//   flash_bwd_dkdv_mma_kernel, flash_bwd_dkdv_kernel  dK, dV of one (batch, KV head, key tile)
//   flash_bwd_dq_mma_kernel, flash_bwd_dq_kernel      dQ of one (batch, query head, query tile)
//
// Semantics are the TPU kernel's: q (b, s, H, d), k and v (b, L, Hk, d);
// query head h reads KV head h / G (G = H / Hk) and repeated K/V is never
// materialised; query row i sits at q_offset + i and attends key t iff
// t < L, (not causal or t <= q_pos) and (no window or t > q_pos - window);
// scores are f32 (q.k * d^-0.5), masked to -1e30; a row with no live key
// writes 0 (acc / max(l, 1e-30)), as the TPU kernel does.  The forward also
// writes the row log-sum-exp (b, H, s) f32, from which the backward
// recomputes P = exp(s - lse) tile by tile.
//
// What bounds them on the card: operations.  At the training shape
// (b=4, s=L=2048, H=32, Hk=8, d=64, causal) the forward does 4*b*H*d flops
// per live (query, key) pair, ~6.9e10, against ~84 MB of q, k, v, o and
// lse: ~800 flop/byte, far above the ~295 at which the H100's tensor cores
// stop waiting on memory.  Two bodies (ops.py's flash_body picks one):
// * mma (bf16, d a multiple of 16 up to 128; the *_mma_kernel functions,
//   their section below): FlashAttention-2 on the tensor cores with
//   mma.sync, cp.async double-buffered tiles and ldmatrix fragments;
//   P.V as P_hi.V + P_lo.V so that the output stays inside
//   kernel_tolerance, one bf16 rounding of P and dS in the backward.
// * fma (f32, and bf16 at a head dim the mma body does not take, up to
//   256): f32 FMAs on the CUDA cores (67 TFLOP/s peak), exact enough for
//   f32's 1e-5 gradient checks.  Each block keeps its query (or key)
//   tile in shared memory for the whole KV (or query) loop; each of the
//   128 threads owns a register micro-tile of scores and of the f32
//   accumulator (rows ty + 8i, columns tx + 16j); row strides are padded
//   to d + 1 so the column reads of a warp hit distinct banks.
// Both skip the tiles that causality or the window mask entirely, and
// the loop over them.  Both backward dK/dV blocks loop over the G query
// heads of their KV head, so GQA's sum over the group stays inside one
// block: no atomics, one summation order (a resumed training run equals
// an uninterrupted one bit for bit).  Not yet: wgmma, TMA, warp
// specialisation.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (see ../../build.py and ../ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's mask value
constexpr int kThreads = 128;       // a 8 x 16 grid of threads per block
constexpr int kTY = 8;
constexpr int kTX = 16;

enum DTypeCode { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// reductions over the 16 threads (tx) that share one row ty: they are one
// half of a warp, so xor offsets below 16 stay inside the row
__device__ __forceinline__ float row_max(float v) {
  for (int o = kTX / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = kTX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Shape {
  int b, s, L, H, Hk, G, d;
  int causal;     // 0 or 1
  int window;     // 0 = no window
  int q_offset;   // absolute position of query row 0
  float scale;    // d^-0.5
};

__device__ __forceinline__ bool live(const Shape& sh, int qp, int t) {
  return t < sh.L && (!sh.causal || t <= qp) && (sh.window <= 0 || t > qp - sh.window);
}

// Tiles.  Forward and dQ: BQ query rows x BK keys per step, the f32
// accumulator (BQ x d) in registers: (BQ / 8) x (DMAX / 16) per thread,
// 32 at d <= 64 and 64 at d <= 128 or 256.  dK/dV: BK keys x d twice in
// registers, (BK / 8) x (DMAX / 16) x 2 = 64 per thread, so BK = 4096/DMAX.
template <int DMAX>
struct FwdTile {
  static constexpr int BQ = DMAX <= 128 ? 64 : 32;
  static constexpr int BK = DMAX <= 128 ? 64 : 32;
};
template <int DMAX>
struct KvTile {
  static constexpr int BK = 4096 / DMAX;
  static constexpr int BQ = DMAX <= 128 ? 64 : 32;
};

// [k_lo, k_hi): the keys any row of query rows [i0, i0 + n) may attend
__device__ __forceinline__ void key_range(const Shape& sh, int i0, int n, int* k_lo, int* k_hi) {
  const int qp_first = sh.q_offset + i0;
  const int qp_last = sh.q_offset + i0 + n - 1;
  *k_hi = sh.causal ? min(sh.L, qp_last + 1) : sh.L;
  *k_lo = sh.window > 0 ? max(0, qp_first - sh.window + 1) : 0;
}

// rows [r0, r0 + n_rows) of a (rows, d) slab whose consecutive rows are
// `stride` elements apart, into shared memory as f32 with row stride dp;
// rows at or past `limit` are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int n_rows, int limit, size_t stride, int d, int dp) {
  for (int e = threadIdx.x; e < n_rows * d; e += kThreads) {
    const int r = e / d, j = e - r * d;
    const int R = r0 + r;
    dst[r * dp + j] = R < limit ? to_f32(src[static_cast<size_t>(R) * stride + j]) : 0.f;
  }
}

// sc[i][c] = sum_j a[(ty + 8i) * dp + j] * b[(tx + 16c) * dp + j]
template <int RQ, int CK>
__device__ __forceinline__ void tile_dot(float (&sc)[RQ][CK], const float* a, const float* b,
                                         int d, int dp, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < CK; ++c) sc[i][c] = 0.f;
  for (int j = 0; j < d; ++j) {
    float av[RQ], bv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) av[i] = a[(ty + kTY * i) * dp + j];
#pragma unroll
    for (int c = 0; c < CK; ++c) bv[c] = b[(tx + kTX * c) * dp + j];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) sc[i][c] = fmaf(av[i], bv[c], sc[i][c]);
  }
}

// acc[i][cd] += sum_t p[(ty + 8i) * ps + t] * m[t * dp + tx + 16cd], t < n
template <int RQ, int CD>
__device__ __forceinline__ void tile_acc(float (&acc)[RQ][CD], const float* p, int ps,
                                         const float* m, int n, int d, int dp, int ty, int tx) {
  for (int t = 0; t < n; ++t) {
    float pv[RQ], mv[CD];
#pragma unroll
    for (int i = 0; i < RQ; ++i) pv[i] = p[(ty + kTY * i) * ps + t];
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + kTX * c;
      mv[c] = col < d ? m[t * dp + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], mv[c], acc[i][c]);
  }
}

size_t fwd_smem_floats(int bq, int bk, int d) {
  // q: bq x (d+1); k, v: bk x (d+1); p: bq x (bk+1)
  return static_cast<size_t>(bq + 2 * bk) * (d + 1) + static_cast<size_t>(bq) * (bk + 1);
}
size_t dq_smem_floats(int bq, int bk, int d) {
  // q, dO: bq x (d+1); k, v: bk x (d+1); dS: bq x (bk+1); lse, D: bq
  return static_cast<size_t>(2 * bq + 2 * bk) * (d + 1) + static_cast<size_t>(bq) * (bk + 1) +
         2 * static_cast<size_t>(bq);
}
size_t dkdv_smem_floats(int bq, int bk, int d) {
  // k, v: bk x (d+1); q, dO: bq x (d+1); P, dS: bq x (bk+1); lse, D: bq
  return static_cast<size_t>(2 * bq + 2 * bk) * (d + 1) +
         2 * static_cast<size_t>(bq) * (bk + 1) + 2 * static_cast<size_t>(bq);
}

// grid (ceil(s / BQ), H, b): query rows [i0, i0 + BQ) of head h walk the
// live key tiles in order (the TPU's sequential ki grid axis) with an
// online softmax; writes o and the rows' log-sum-exp.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Shape sh) {
  constexpr int BQ = FwdTile<DMAX>::BQ, BK = FwdTile<DMAX>::BK;
  constexpr int RQ = BQ / kTY, CK = BK / kTX, CD = DMAX / kTX;
  constexpr int PS = BK + 1;
  const int d = sh.d, dp = d + 1;
  extern __shared__ float smem[];
  float* q_s = smem;              // BQ x dp
  float* k_s = q_s + BQ * dp;     // BK x dp
  float* v_s = k_s + BK * dp;     // BK x dp
  float* p_s = v_s + BK * dp;     // BQ x PS

  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int i0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / sh.G;
  const size_t q_stride = static_cast<size_t>(sh.H) * d;
  const size_t kv_stride = static_cast<size_t>(sh.Hk) * d;
  const size_t q_base = (static_cast<size_t>(bi) * sh.s * sh.H + h) * d;
  const size_t kv_base = (static_cast<size_t>(bi) * sh.L * sh.Hk + kvh) * d;

  load_tile(q_s, q + q_base, i0, BQ, sh.s, q_stride, d, dp);

  float acc[RQ][CD], m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int k_lo, k_hi;
  key_range(sh, i0, min(BQ, sh.s - i0), &k_lo, &k_hi);
  for (int t0 = (k_lo / BK) * BK; t0 < k_hi; t0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    load_tile(k_s, k + kv_base, t0, BK, sh.L, kv_stride, d, dp);
    load_tile(v_s, v + kv_base, t0, BK, sh.L, kv_stride, d, dp);
    __syncthreads();

    float sc[RQ][CK];
    tile_dot(sc, q_s, k_s, d, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + kTY * i;
      const int qp = sh.q_offset + i0 + r;
      const bool row = i0 + r < sh.s;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const bool lv = row && live(sh, qp, t0 + tx + kTX * c);
        sc[i][c] = lv ? sc[i][c] * sh.scale : kNegInf;
        mx = fmaxf(mx, sc[i][c]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const bool lv = row && live(sh, qp, t0 + tx + kTX * c);
        const float p = lv ? expf(sc[i][c] - m_new) : 0.f;
        p_s[r * PS + tx + kTX * c] = p;
        psum += p;
      }
      psum = row_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_acc(acc, p_s, PS, v_s, BK, d, dp, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + kTY * i;
    const int row = i0 + r;
    if (row >= sh.s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + q_base + static_cast<size_t>(row) * q_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + kTX * c;
      if (col < d) orow[col] = from_f32<T>(acc[i][c] / denom);
    }
    if (tx == 0)
      lse[(static_cast<size_t>(bi) * sh.H + h) * sh.s + row] = m[i] + logf(denom);
  }
}

// one warp per (b, i, h) row of o / dO: delta[(b*H + h)*s + i] = sum_j dO*O
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                            float* __restrict__ delta, Shape sh) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = sh.b * sh.s * sh.H;
  if (warp >= rows) return;
  const int h = warp % sh.H;
  const int i = (warp / sh.H) % sh.s;
  const int bi = warp / (sh.H * sh.s);
  const size_t base = static_cast<size_t>(warp) * sh.d;
  float acc = 0.f;
  for (int j = lane; j < sh.d; j += 32) acc += to_f32(dout[base + j]) * to_f32(o[base + j]);
  acc = warp_sum(acc);
  if (lane == 0) delta[(static_cast<size_t>(bi) * sh.H + h) * sh.s + i] = acc;
}

// grid (ceil(L / BK), Hk, b): keys [t0, t0 + BK) of KV head kvh.  Loops
// over the G query heads of the group and, for each, over the query tiles
// that may attend these keys; recomputes P from the saved log-sum-exp and
// sums dV += P^T dO and dK += dS^T Q (dS = P * (dP - D), dP = dO V^T) in
// registers: the whole group's sum in one block, in one order.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  constexpr int BQ = KvTile<DMAX>::BQ, BK = KvTile<DMAX>::BK;
  constexpr int RQ = BQ / kTY, CK = BK / kTX, RK = BK / kTY, CD = DMAX / kTX;
  constexpr int PS = BK + 1;
  const int d = sh.d, dp = d + 1;
  extern __shared__ float smem[];
  float* k_s = smem;               // BK x dp
  float* v_s = k_s + BK * dp;      // BK x dp
  float* q_s = v_s + BK * dp;      // BQ x dp
  float* do_s = q_s + BQ * dp;     // BQ x dp
  float* p_s = do_s + BQ * dp;     // BQ x PS
  float* ds_s = p_s + BQ * PS;     // BQ x PS
  float* lse_s = ds_s + BQ * PS;   // BQ
  float* dl_s = lse_s + BQ;        // BQ

  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int t0 = blockIdx.x * BK, kvh = blockIdx.y, bi = blockIdx.z;
  const size_t q_stride = static_cast<size_t>(sh.H) * d;
  const size_t kv_stride = static_cast<size_t>(sh.Hk) * d;
  const size_t kv_base = (static_cast<size_t>(bi) * sh.L * sh.Hk + kvh) * d;

  load_tile(k_s, k + kv_base, t0, BK, sh.L, kv_stride, d, dp);
  load_tile(v_s, v + kv_base, t0, BK, sh.L, kv_stride, d, dp);

  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int a = 0; a < RK; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  // query rows that may attend keys [t0, t_last]
  const int t_last = min(t0 + BK, sh.L) - 1;
  const int i_lo = sh.causal ? max(0, t0 - sh.q_offset) : 0;
  const int i_hi = sh.window > 0 ? min(sh.s, t_last + sh.window - sh.q_offset) : sh.s;

  for (int g = 0; g < sh.G; ++g) {
    const int h = kvh * sh.G + g;
    const size_t q_base = (static_cast<size_t>(bi) * sh.s * sh.H + h) * d;
    const float* lse_h = lse + (static_cast<size_t>(bi) * sh.H + h) * sh.s;
    const float* dl_h = delta + (static_cast<size_t>(bi) * sh.H + h) * sh.s;
    for (int i0 = (i_lo / BQ) * BQ; i0 < i_hi; i0 += BQ) {
      __syncthreads();   // the previous tile's readers are done
      load_tile(q_s, q + q_base, i0, BQ, sh.s, q_stride, d, dp);
      load_tile(do_s, dout + q_base, i0, BQ, sh.s, q_stride, d, dp);
      for (int r = tid; r < BQ; r += kThreads) {
        const bool in = i0 + r < sh.s;
        lse_s[r] = in ? lse_h[i0 + r] : 0.f;
        dl_s[r] = in ? dl_h[i0 + r] : 0.f;
      }
      __syncthreads();

      float pr[RQ][CK], dpr[RQ][CK];
      tile_dot(pr, q_s, k_s, d, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = ty + kTY * i;
        const int qp = sh.q_offset + i0 + r;
        const bool row = i0 + r < sh.s;
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          const bool lv = row && live(sh, qp, t0 + tx + kTX * c);
          pr[i][c] = lv ? expf(pr[i][c] * sh.scale - lse_s[r]) : 0.f;
          p_s[r * PS + tx + kTX * c] = pr[i][c];
        }
      }
      tile_dot(dpr, do_s, v_s, d, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = ty + kTY * i;
#pragma unroll
        for (int c = 0; c < CK; ++c)
          ds_s[r * PS + tx + kTX * c] = pr[i][c] * (dpr[i][c] - dl_s[r]);
      }
      __syncthreads();

      // dV[t][col] += sum_r P[r][t] dO[r][col]; dK[t][col] += sum_r dS[r][t] Q[r][col]
      for (int r = 0; r < BQ; ++r) {
        float pv[RK], dsv[RK], dov[CD], qv[CD];
#pragma unroll
        for (int a = 0; a < RK; ++a) {
          pv[a] = p_s[r * PS + ty + kTY * a];
          dsv[a] = ds_s[r * PS + ty + kTY * a];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const int col = tx + kTX * c;
          dov[c] = col < d ? do_s[r * dp + col] : 0.f;
          qv[c] = col < d ? q_s[r * dp + col] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < RK; ++a)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dv_acc[a][c] = fmaf(pv[a], dov[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(dsv[a], qv[c], dk_acc[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RK; ++a) {
    const int t = t0 + ty + kTY * a;
    if (t >= sh.L) continue;
    const size_t off = kv_base + static_cast<size_t>(t) * kv_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + kTX * c;
      if (col < d) {
        dk[off + col] = from_f32<T>(dk_acc[a][c] * sh.scale);
        dv[off + col] = from_f32<T>(dv_acc[a][c]);
      }
    }
  }
}

// grid (ceil(s / BQ), H, b): dQ of query rows [i0, i0 + BQ) of head h,
// walking the live key tiles: dQ += dS K, with dS recomputed as above.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Shape sh) {
  constexpr int BQ = FwdTile<DMAX>::BQ, BK = FwdTile<DMAX>::BK;
  constexpr int RQ = BQ / kTY, CK = BK / kTX, CD = DMAX / kTX;
  constexpr int PS = BK + 1;
  const int d = sh.d, dp = d + 1;
  extern __shared__ float smem[];
  float* q_s = smem;               // BQ x dp
  float* do_s = q_s + BQ * dp;     // BQ x dp
  float* k_s = do_s + BQ * dp;     // BK x dp
  float* v_s = k_s + BK * dp;      // BK x dp
  float* ds_s = v_s + BK * dp;     // BQ x PS
  float* lse_s = ds_s + BQ * PS;   // BQ
  float* dl_s = lse_s + BQ;        // BQ

  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int i0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / sh.G;
  const size_t q_stride = static_cast<size_t>(sh.H) * d;
  const size_t kv_stride = static_cast<size_t>(sh.Hk) * d;
  const size_t q_base = (static_cast<size_t>(bi) * sh.s * sh.H + h) * d;
  const size_t kv_base = (static_cast<size_t>(bi) * sh.L * sh.Hk + kvh) * d;
  const size_t row_base = (static_cast<size_t>(bi) * sh.H + h) * sh.s;

  load_tile(q_s, q + q_base, i0, BQ, sh.s, q_stride, d, dp);
  load_tile(do_s, dout + q_base, i0, BQ, sh.s, q_stride, d, dp);
  for (int r = tid; r < BQ; r += kThreads) {
    const bool in = i0 + r < sh.s;
    lse_s[r] = in ? lse[row_base + i0 + r] : 0.f;
    dl_s[r] = in ? delta[row_base + i0 + r] : 0.f;
  }

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  int k_lo, k_hi;
  key_range(sh, i0, min(BQ, sh.s - i0), &k_lo, &k_hi);
  for (int t0 = (k_lo / BK) * BK; t0 < k_hi; t0 += BK) {
    __syncthreads();
    load_tile(k_s, k + kv_base, t0, BK, sh.L, kv_stride, d, dp);
    load_tile(v_s, v + kv_base, t0, BK, sh.L, kv_stride, d, dp);
    __syncthreads();

    float pr[RQ][CK], dpr[RQ][CK];
    tile_dot(pr, q_s, k_s, d, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + kTY * i;
      const int qp = sh.q_offset + i0 + r;
      const bool row = i0 + r < sh.s;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const bool lv = row && live(sh, qp, t0 + tx + kTX * c);
        pr[i][c] = lv ? expf(pr[i][c] * sh.scale - lse_s[r]) : 0.f;
      }
    }
    tile_dot(dpr, do_s, v_s, d, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + kTY * i;
#pragma unroll
      for (int c = 0; c < CK; ++c)
        ds_s[r * PS + tx + kTX * c] = pr[i][c] * (dpr[i][c] - dl_s[r]);
    }
    __syncthreads();
    tile_acc(acc, ds_s, PS, k_s, BK, d, dp, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = i0 + ty + kTY * i;
    if (row >= sh.s) continue;
    T* drow = dq + q_base + static_cast<size_t>(row) * q_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + kTX * c;
      if (col < d) drow[col] = from_f32<T>(acc[i][c] * sh.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core bodies: flash_fwd_mma_kernel, flash_bwd_dkdv_mma_kernel,
// flash_bwd_dq_mma_kernel (bf16, d a multiple of 16 up to 128)
// ---------------------------------------------------------------------------
//
// FlashAttention-2 on mma.sync.m16n8k16 (bf16 operands, f32 accumulate).
// The head dim is padded to DP = 64 or 128 with zero columns (staged as
// zeros, never stored).  Four warps per block, each owning 16 rows (query
// rows in the forward and dQ, keys in dK/dV); K/V (or Q/dO) tiles are
// staged by cp.async into shared memory, double-buffered, rows padded to
// DP + 8 bf16 so that ldmatrix and fragment reads hit distinct banks.
// Scores are exact products of bf16 summed in f32; the softmax runs in
// f32 registers in base 2 (log2(e) folded into the scale).  The forward
// takes P.V as P_hi.V + P_lo.V (P_hi = bf16(P), P_lo = bf16(P - P_hi)):
// a single bf16 P moves the output by several times kernel_tolerance.
// The backward rounds P (into dV) and dS (into dK, dQ) once to bf16: that
// keeps every gradient ~7x inside its 2e-2 relative-norm limit
// (tests/test_torch_flash_numerics.py emulates both designs).  Key (or
// query) tiles that the mask hides from a whole block are never visited,
// and a warp skips the arithmetic of a tile that is masked for all its
// rows (exact: the tile would add nothing).  The block and tile plan is
// ops.py's mma_tiles / key_tile_range / query_tile_range.

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMmaRows = 64;    // forward and dQ query rows per block
constexpr int kMmaKeys = 64;    // forward key tile, dK/dV keys per block

// the backward's inner tile: dK/dV's query rows per step, dQ's keys per
// step (halved at DP = 128 so that the f32 accumulators stay in registers)
template <int DP>
struct BwdInner {
  static constexpr int N = DP == 64 ? 64 : 32;
};

// 2^x by the special-function unit alone (relative error ~2^-22, far below
// a bf16 ulp; denormal results flush to 0), without exp2f's range handling,
// which the softmax does not need: every argument is at most about 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;       // 0 source bytes: zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Fragment loaders over a staged tile (row stride LD bf16).  A operand
// (16 x 16, row-major) of rows [r0, r0 + 16), columns [c0, c0 + 16):
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8);
}
// B operands of two n8 tiles, B[k][n] = tile[n][k]: rows (n) [n0, n0 + 16),
// columns (k) [c0, c0 + 16); b[0], b[1] for n0, b[2], b[3] for n0 + 8
template <int LD>
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                            int c0, int lane) {
  const int mat = lane >> 3;
  ldsm_x4(b, tile + (n0 + (mat >> 1) * 8 + (lane & 7)) * LD + c0 + (mat & 1) * 8);
}
// B operands of two n8 tiles, B[k][n] = tile[k][n]: rows (k) [k0, k0 + 16),
// columns (n) [n0, n0 + 16); b[0], b[1] for n0, b[2], b[3] for n0 + 8
template <int LD>
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0,
                                            int n0, int lane) {
  const int mat = lane >> 3;
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + (mat & 1) * 8) * LD + n0 + (mat >> 1) * 8);
}

// an accumulator tile c[n][4] (16 rows x 8n columns) as the A operand of
// the k16 step kt: columns [16 kt, 16 kt + 16), rounded once to bf16
template <int N>
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4], float (&c)[N][4], int kt) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = c[2 * kt + i / 2] + 2 * (i % 2);
    a[i] = pack_bf16(p[0], p[1]);
  }
}

// rows [r0, r0 + n_rows) of a (rows, d) bf16 slab with row stride `stride`
// into a tile of row stride DP + 8 by cp.async; rows at or past `limit`
// and columns at or past d are zero
template <int DP>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                           int r0, int n_rows, int limit, size_t stride, int d) {
  constexpr int LD = DP + 8, CH = DP / 8;
  for (int c = threadIdx.x; c < n_rows * CH; c += kThreads) {
    const int r = c / CH, part = c - r * CH;
    const int R = r0 + r;
    const bool ok = R < limit && part * 8 < d;
    cp_async16(dst + r * LD + part * 8, ok ? src + static_cast<size_t>(R) * stride + part * 8 : src,
               ok);
  }
}

// true when no (query, key) pair of key positions [k_first, k_last] and
// query rows [i_first, i_last] is live (rows clipped to s)
__device__ __forceinline__ bool tile_dead(const Shape& sh, int k_first, int k_last, int i_first,
                                          int i_last) {
  k_last = min(k_last, sh.L - 1);
  i_last = min(i_last, sh.s - 1);
  if (k_first > k_last || i_first > i_last) return true;
  const int qp_first = sh.q_offset + i_first, qp_last = sh.q_offset + i_last;
  return (sh.causal && k_first > qp_last) || (sh.window > 0 && k_last <= qp_first - sh.window);
}

// true when every pair of those is live: the warp's tile needs no mask
__device__ __forceinline__ bool tile_full(const Shape& sh, int k_first, int k_last, int i_first,
                                          int i_last) {
  if (k_last >= sh.L || i_last >= sh.s) return false;
  const int qp_first = sh.q_offset + i_first, qp_last = sh.q_offset + i_last;
  return (!sh.causal || k_last <= qp_first) && (sh.window <= 0 || k_first > qp_last - sh.window);
}

// The scores of a warp's row tile (sc[nt][i]: rows lo (i < 2) and hi,
// keys kb + 8 nt + (i & 1)) as f32 logits in base 2: times scale2, or
// -1e30 where masked.  kMasked false: the whole tile is live.
template <bool kMasked, int NT>
__device__ __forceinline__ void mask_rows(float (&sc)[NT][4], const Shape& sh, float scale2,
                                          int kb, bool in_lo, int qp_lo, bool in_hi, int qp_hi) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = kb + nt * 8 + (i & 1);
      const bool lv =
          !kMasked || (i < 2 ? in_lo && live(sh, qp_lo, t) : in_hi && live(sh, qp_hi, t));
      sc[nt][i] = lv ? sc[nt][i] * scale2 : kNegInf;
    }
}

// dK/dV's transposed tile (rows: keys key_lo (i < 2) and key_lo + 8;
// columns: queries i0 + 8 nq + 2 (lane % 4) + (i & 1)): S^T into P^T =
// exp(S^T - lse) on live pairs, dP^T into dS^T = P^T (dP^T - D)
template <bool kMasked, int NQ>
__device__ __forceinline__ void probs_t(float (&st)[NQ][4], float (&dpt)[NQ][4], const Shape& sh,
                                        float scale2, const float* lse2, const float* dl, int i0,
                                        int key_lo, int lane) {
#pragma unroll
  for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = nq * 8 + 2 * (lane % 4) + (i & 1);
      const int row = i0 + qi;
      const bool lv = !kMasked || (row < sh.s && live(sh, sh.q_offset + row,
                                                       i < 2 ? key_lo : key_lo + 8));
      const float pr = lv ? ex2(st[nq][i] * scale2 - lse2[qi]) : 0.f;
      st[nq][i] = pr;
      dpt[nq][i] = pr * (dpt[nq][i] - dl[qi]);
    }
}

size_t fwd_mma_smem(int dp) {
  return static_cast<size_t>(2 * 2 * kMmaKeys) * (dp + 8) * sizeof(__nv_bfloat16);
}
size_t dkdv_mma_smem(int dp) {
  const int bq = dp == 64 ? 64 : 32;
  return static_cast<size_t>(2 * kMmaKeys + 2 * 2 * bq) * (dp + 8) * sizeof(__nv_bfloat16) +
         2 * 2 * static_cast<size_t>(bq) * sizeof(float);
}
size_t dq_mma_smem(int dp) {
  const int bk = dp == 64 ? 64 : 32;
  return static_cast<size_t>(2 * kMmaRows + 2 * 2 * bk) * (dp + 8) * sizeof(__nv_bfloat16);
}

// grid (ceil(s / 64), H, b), 128 threads, the heaviest query tiles (the
// last, under a causal mask) first.  Warp w owns query rows
// [i0 + 16w, i0 + 16w + 16) and keeps their q fragments in registers;
// the block walks the live 64-key tiles with an online softmax.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, Shape sh) {
  constexpr int BQ = kMmaRows, BK = kMmaKeys, LD = DP + 8;
  constexpr int DK = DP / 16, DN = DP / 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [2][K, V][BK][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int d = sh.d;
  const size_t q_stride = static_cast<size_t>(sh.H) * d;
  const size_t kv_stride = static_cast<size_t>(sh.Hk) * d;
  const size_t q_base = (static_cast<size_t>(bi) * sh.s * sh.H + h) * d;
  const size_t kv_base = (static_cast<size_t>(bi) * sh.L * sh.Hk + h / sh.G) * d;

  // this thread's two rows and their q fragments
  const int w0 = i0 + 16 * warp;
  const int r_lo = w0 + lane / 4, r_hi = r_lo + 8;
  const int qp_lo = sh.q_offset + r_lo, qp_hi = qp_lo + 8;
  const bool in_lo = r_lo < sh.s, in_hi = r_hi < sh.s;
  auto ld2 = [&](bool in, int r, int col) -> uint32_t {
    return in && col < d
               ? *reinterpret_cast<const uint32_t*>(q + q_base + static_cast<size_t>(r) * q_stride + col)
               : 0u;
  };
  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const int col = kk * 16 + 2 * (lane % 4);
    qa[kk][0] = ld2(in_lo, r_lo, col);
    qa[kk][1] = ld2(in_hi, r_hi, col);
    qa[kk][2] = ld2(in_lo, r_lo, col + 8);
    qa[kk][3] = ld2(in_hi, r_hi, col + 8);
  }

  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  const float scale2 = sh.scale * kLog2e;

  int k_lo, k_hi;
  key_range(sh, i0, min(BQ, sh.s - i0), &k_lo, &k_hi);
  const int t_first = (k_lo / BK) * BK;
  const int n_tiles = k_hi > t_first ? (k_hi - t_first + BK - 1) / BK : 0;
  auto load = [&](int j) {
    __nv_bfloat16* ks = stages + (j & 1) * 2 * BK * LD;
    stage_rows<DP>(ks, k + kv_base, t_first + j * BK, BK, sh.L, kv_stride, d);
    stage_rows<DP>(ks + BK * LD, v + kv_base, t_first + j * BK, BK, sh.L, kv_stride, d);
    cp_async_commit();
  };

  if (n_tiles > 0) load(0);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = t_first + j * BK;
    if (!tile_dead(sh, t0, t0 + BK - 1, w0, w0 + 15)) {
      const __nv_bfloat16* Ks = stages + (j & 1) * 2 * BK * LD;
      const __nv_bfloat16* Vs = Ks + BK * LD;
      // S = Q.K^T
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t b[4];
          frag_b_rows<LD>(b, Ks, nt * 8, kk * 16, lane);
          mma_bf16(sc[nt], qa[kk], b[0], b[1]);
          mma_bf16(sc[nt + 1], qa[kk], b[2], b[3]);
        }
      // mask, scale (base 2), online softmax
      const int kb = t0 + 2 * (lane % 4);
      if (tile_full(sh, t0, t0 + BK - 1, w0, w0 + 15))
        mask_rows<false>(sc, sh, scale2, kb, in_lo, qp_lo, in_hi, qp_hi);
      else
        mask_rows<true>(sc, sh, scale2, kb, in_lo, qp_lo, in_hi, qp_hi);
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[nt][0], sc[nt][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[nt][2], sc[nt][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float al_lo = ex2(m_lo - mn_lo), al_hi = ex2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = sc[nt][i];
          const float pr = x > kNegInf ? ex2(x - (i < 2 ? mn_lo : mn_hi)) : 0.f;
          sc[nt][i] = pr;
          if (i < 2) ps_lo += pr; else ps_hi += pr;
        }
      }
      l_lo = l_lo * al_lo + ps_lo;     // this thread's columns; the quad adds at the end
      l_hi = l_hi * al_hi + ps_hi;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        acc[dn][0] *= al_lo;
        acc[dn][1] *= al_lo;
        acc[dn][2] *= al_hi;
        acc[dn][3] *= al_hi;
      }
      // acc += P_hi.V + P_lo.V, one k16 step per 16 keys
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* pv = sc[2 * kt + i / 2] + 2 * (i % 2);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(pv[0], pv[1]);
          ah[i] = *reinterpret_cast<const uint32_t*>(&hi);
          al[i] = pack_bf16(pv[0] - __low2float(hi), pv[1] - __high2float(hi));
        }
#pragma unroll
        for (int dn = 0; dn < DN; dn += 2) {
          uint32_t b[4];
          frag_b_cols<LD>(b, Vs, kt * 16, dn * 8, lane);
          mma_bf16(acc[dn], ah, b[0], b[1]);
          mma_bf16(acc[dn], al, b[0], b[1]);
          mma_bf16(acc[dn + 1], ah, b[2], b[3]);
          mma_bf16(acc[dn + 1], al, b[2], b[3]);
        }
      }
    }
    __syncthreads();                   // the stage is free for tile j + 2
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * (lane % 4);
    if (col >= d) continue;
    if (in_lo)
      *reinterpret_cast<__nv_bfloat162*>(o + q_base + static_cast<size_t>(r_lo) * q_stride + col) =
          __floats2bfloat162_rn(acc[dn][0] / den_lo, acc[dn][1] / den_lo);
    if (in_hi)
      *reinterpret_cast<__nv_bfloat162*>(o + q_base + static_cast<size_t>(r_hi) * q_stride + col) =
          __floats2bfloat162_rn(acc[dn][2] / den_hi, acc[dn][3] / den_hi);
  }
  if (lane % 4 == 0) {
    float* lrow = lse + (static_cast<size_t>(bi) * sh.H + h) * sh.s;
    if (in_lo) lrow[r_lo] = (m_lo + log2f(den_lo)) * kLn2;
    if (in_hi) lrow[r_hi] = (m_hi + log2f(den_hi)) * kLn2;
  }
}

// grid (ceil(L / 64), Hk, b), 128 threads: keys [t0, t0 + 64) of KV head
// kvh.  Warp w owns keys [t0 + 16w, t0 + 16w + 16).  The block loops over
// the G query heads of the group and, for each, over the query tiles of
// BQ rows that attend these keys (Q, dO, lse and D double-buffered); per
// tile it recomputes S^T = K.Q^T, takes P^T = exp(S^T - lse) in f32,
// dV += P^T.dO, dP^T = V.dO^T, dS^T = P^T (dP^T - D) in f32, and
// dK += dS^T.Q: the whole group's sum in registers, in one order.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, Shape sh) {
  constexpr int BK = kMmaKeys, BQ = BwdInner<DP>::N, LD = DP + 8;
  constexpr int DK = DP / 16, DN = DP / 8, NQ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BK x LD
  __nv_bfloat16* Vs = Ks + BK * LD;                                 // BK x LD
  __nv_bfloat16* stages = Vs + BK * LD;                             // [2][Q, dO][BQ][LD]
  float* rows_f = reinterpret_cast<float*>(stages + 2 * 2 * BQ * LD);   // [2][lse2, D][BQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * BK, kvh = blockIdx.y, bi = blockIdx.z;
  const int d = sh.d;
  const size_t q_stride = static_cast<size_t>(sh.H) * d;
  const size_t kv_stride = static_cast<size_t>(sh.Hk) * d;
  const size_t kv_base = (static_cast<size_t>(bi) * sh.L * sh.Hk + kvh) * d;
  const int kw0 = t0 + 16 * warp;                  // this warp's first key
  const int key_lo = kw0 + lane / 4, key_hi = key_lo + 8;
  const float scale2 = sh.scale * kLog2e;

  // the query rows that attend keys [t0, t_last] (ops.query_tile_range)
  const int t_last = min(t0 + BK, sh.L) - 1;
  const int i_lo = sh.causal ? max(0, t0 - sh.q_offset) : 0;
  const int i_hi = sh.window > 0 ? min(sh.s, t_last + sh.window - sh.q_offset) : sh.s;
  const int i_first = (i_lo / BQ) * BQ;
  const int n_qt = i_hi > i_first ? (i_hi - i_first + BQ - 1) / BQ : 0;
  const int n_it = sh.G * n_qt;

  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[dn][i] = dv_acc[dn][i] = 0.f;

  auto load = [&](int it) {
    const int g = it / n_qt, i0 = i_first + (it - g * n_qt) * BQ;
    const int h = kvh * sh.G + g;
    const size_t q_base = (static_cast<size_t>(bi) * sh.s * sh.H + h) * d;
    __nv_bfloat16* qs = stages + (it & 1) * 2 * BQ * LD;
    stage_rows<DP>(qs, q + q_base, i0, BQ, sh.s, q_stride, d);
    stage_rows<DP>(qs + BQ * LD, dout + q_base, i0, BQ, sh.s, q_stride, d);
    cp_async_commit();
    // lse (in base 2) and D of these rows: plain loads, made visible by
    // the barrier before the tile is read
    const size_t row_base = (static_cast<size_t>(bi) * sh.H + h) * sh.s;
    float* rf = rows_f + (it & 1) * 2 * BQ;
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = i0 + r < sh.s;
      rf[r] = in ? lse[row_base + i0 + r] * kLog2e : 0.f;
      rf[BQ + r] = in ? delta[row_base + i0 + r] : 0.f;
    }
  };

  if (n_it > 0) {
    stage_rows<DP>(Ks, k + kv_base, t0, BK, sh.L, kv_stride, d);
    stage_rows<DP>(Vs, v + kv_base, t0, BK, sh.L, kv_stride, d);
    load(0);                           // one group with K and V
  }
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = i_first + (it % n_qt) * BQ;
    if (!tile_dead(sh, kw0, kw0 + 15, i0, i0 + BQ - 1)) {
      const __nv_bfloat16* Qs = stages + (it & 1) * 2 * BQ * LD;
      const __nv_bfloat16* dOs = Qs + BQ * LD;
      const float* lse2 = rows_f + (it & 1) * 2 * BQ;
      const float* dl = lse2 + BQ;
      // S^T = K.Q^T and dP^T = V.dO^T (this warp's 16 keys x BQ queries)
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nq][i] = dpt[nq][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t ka[4], va[4];
        frag_a<LD>(ka, Ks, 16 * warp, kk * 16, lane);
        frag_a<LD>(va, Vs, 16 * warp, kk * 16, lane);
#pragma unroll
        for (int nq = 0; nq < NQ; nq += 2) {
          uint32_t b[4];
          frag_b_rows<LD>(b, Qs, nq * 8, kk * 16, lane);
          mma_bf16(st[nq], ka, b[0], b[1]);
          mma_bf16(st[nq + 1], ka, b[2], b[3]);
          frag_b_rows<LD>(b, dOs, nq * 8, kk * 16, lane);
          mma_bf16(dpt[nq], va, b[0], b[1]);
          mma_bf16(dpt[nq + 1], va, b[2], b[3]);
        }
      }
      // P^T = exp(S^T - lse) on live pairs; dS^T = P^T (dP^T - D)
      if (tile_full(sh, kw0, kw0 + 15, i0, i0 + BQ - 1))
        probs_t<false>(st, dpt, sh, scale2, lse2, dl, i0, key_lo, lane);
      else
        probs_t<true>(st, dpt, sh, scale2, lse2, dl, i0, key_lo, lane);
      // dV += P^T.dO and dK += dS^T.Q, one k16 step per 16 queries
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq) {
        uint32_t pa[4], sa[4];
        acc_as_a(pa, st, kq);
        acc_as_a(sa, dpt, kq);
#pragma unroll
        for (int dn = 0; dn < DN; dn += 2) {
          uint32_t b[4];
          frag_b_cols<LD>(b, dOs, kq * 16, dn * 8, lane);
          mma_bf16(dv_acc[dn], pa, b[0], b[1]);
          mma_bf16(dv_acc[dn + 1], pa, b[2], b[3]);
          frag_b_cols<LD>(b, Qs, kq * 16, dn * 8, lane);
          mma_bf16(dk_acc[dn], sa, b[0], b[1]);
          mma_bf16(dk_acc[dn + 1], sa, b[2], b[3]);
        }
      }
    }
    __syncthreads();                   // the stage is free for iteration it + 2
  }

#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * (lane % 4);
    if (col >= d) continue;
    if (key_lo < sh.L) {
      const size_t off = kv_base + static_cast<size_t>(key_lo) * kv_stride + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(dk_acc[dn][0] * sh.scale, dk_acc[dn][1] * sh.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dv_acc[dn][0], dv_acc[dn][1]);
    }
    if (key_hi < sh.L) {
      const size_t off = kv_base + static_cast<size_t>(key_hi) * kv_stride + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(dk_acc[dn][2] * sh.scale, dk_acc[dn][3] * sh.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dv_acc[dn][2], dv_acc[dn][3]);
    }
  }
}

// grid (ceil(s / 64), H, b), 128 threads, the heaviest query tiles first:
// dQ of query rows [i0, i0 + 64) of head h.  Q and dO stay in shared
// memory; the block walks the live key tiles of BK keys (K and V
// double-buffered): S = Q.K^T, dP = dO.V^T, dS = P (dP - D), dQ += dS.K.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, Shape sh) {
  constexpr int BQ = kMmaRows, BK = BwdInner<DP>::N, LD = DP + 8;
  constexpr int DK = DP / 16, DN = DP / 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BQ x LD
  __nv_bfloat16* dOs = Qs + BQ * LD;                                // BQ x LD
  __nv_bfloat16* stages = dOs + BQ * LD;                            // [2][K, V][BK][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int d = sh.d;
  const size_t q_stride = static_cast<size_t>(sh.H) * d;
  const size_t kv_stride = static_cast<size_t>(sh.Hk) * d;
  const size_t q_base = (static_cast<size_t>(bi) * sh.s * sh.H + h) * d;
  const size_t kv_base = (static_cast<size_t>(bi) * sh.L * sh.Hk + h / sh.G) * d;
  const size_t row_base = (static_cast<size_t>(bi) * sh.H + h) * sh.s;
  const float scale2 = sh.scale * kLog2e;

  const int w0 = i0 + 16 * warp;
  const int r_lo = w0 + lane / 4, r_hi = r_lo + 8;
  const int qp_lo = sh.q_offset + r_lo, qp_hi = qp_lo + 8;
  const bool in_lo = r_lo < sh.s, in_hi = r_hi < sh.s;
  const float lse2_lo = in_lo ? lse[row_base + r_lo] * kLog2e : 0.f;
  const float lse2_hi = in_hi ? lse[row_base + r_hi] * kLog2e : 0.f;
  const float dl_lo = in_lo ? delta[row_base + r_lo] : 0.f;
  const float dl_hi = in_hi ? delta[row_base + r_hi] : 0.f;

  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  int k_lo, k_hi;
  key_range(sh, i0, min(BQ, sh.s - i0), &k_lo, &k_hi);
  const int t_first = (k_lo / BK) * BK;
  const int n_tiles = k_hi > t_first ? (k_hi - t_first + BK - 1) / BK : 0;
  auto load = [&](int j) {
    __nv_bfloat16* ks = stages + (j & 1) * 2 * BK * LD;
    stage_rows<DP>(ks, k + kv_base, t_first + j * BK, BK, sh.L, kv_stride, d);
    stage_rows<DP>(ks + BK * LD, v + kv_base, t_first + j * BK, BK, sh.L, kv_stride, d);
    cp_async_commit();
  };

  if (n_tiles > 0) {
    stage_rows<DP>(Qs, q + q_base, i0, BQ, sh.s, q_stride, d);
    stage_rows<DP>(dOs, dout + q_base, i0, BQ, sh.s, q_stride, d);
    load(0);                           // one group with Q and dO
  }
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = t_first + j * BK;
    if (!tile_dead(sh, t0, t0 + BK - 1, w0, w0 + 15)) {
      const __nv_bfloat16* Ks = stages + (j & 1) * 2 * BK * LD;
      const __nv_bfloat16* Vs = Ks + BK * LD;
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t qa[4], da[4];
        frag_a<LD>(qa, Qs, 16 * warp, kk * 16, lane);
        frag_a<LD>(da, dOs, 16 * warp, kk * 16, lane);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t b[4];
          frag_b_rows<LD>(b, Ks, nt * 8, kk * 16, lane);
          mma_bf16(sc[nt], qa, b[0], b[1]);
          mma_bf16(sc[nt + 1], qa, b[2], b[3]);
          frag_b_rows<LD>(b, Vs, nt * 8, kk * 16, lane);
          mma_bf16(dp[nt], da, b[0], b[1]);
          mma_bf16(dp[nt + 1], da, b[2], b[3]);
        }
      }
      const int kb = t0 + 2 * (lane % 4);
      if (tile_full(sh, t0, t0 + BK - 1, w0, w0 + 15))
        mask_rows<false>(sc, sh, scale2, kb, in_lo, qp_lo, in_hi, qp_hi);
      else
        mask_rows<true>(sc, sh, scale2, kb, in_lo, qp_lo, in_hi, qp_hi);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool lo = i < 2;
          const float x = sc[nt][i];
          const float pr = x > kNegInf ? ex2(x - (lo ? lse2_lo : lse2_hi)) : 0.f;
          dp[nt][i] = pr * (dp[nt][i] - (lo ? dl_lo : dl_hi));
        }
      }
      // dQ += dS.K, one k16 step per 16 keys
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        uint32_t sa[4];
        acc_as_a(sa, dp, kt);
#pragma unroll
        for (int dn = 0; dn < DN; dn += 2) {
          uint32_t b[4];
          frag_b_cols<LD>(b, Ks, kt * 16, dn * 8, lane);
          mma_bf16(acc[dn], sa, b[0], b[1]);
          mma_bf16(acc[dn + 1], sa, b[2], b[3]);
        }
      }
    }
    __syncthreads();                   // the stage is free for tile j + 2
  }

#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * (lane % 4);
    if (col >= d) continue;
    if (in_lo)
      *reinterpret_cast<__nv_bfloat162*>(dq + q_base + static_cast<size_t>(r_lo) * q_stride + col) =
          __floats2bfloat162_rn(acc[dn][0] * sh.scale, acc[dn][1] * sh.scale);
    if (in_hi)
      *reinterpret_cast<__nv_bfloat162*>(dq + q_base + static_cast<size_t>(r_hi) * q_stride + col) =
          __floats2bfloat162_rn(acc[dn][2] * sh.scale, acc[dn][3] * sh.scale);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int dmax_of(int d) { return d <= 64 ? 64 : (d <= 128 ? 128 : 256); }

template <typename T, int DMAX>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, Shape sh,
               cudaStream_t stream) {
  constexpr int BQ = FwdTile<DMAX>::BQ, BK = FwdTile<DMAX>::BK;
  const size_t smem = sizeof(float) * fwd_smem_floats(BQ, BK, sh.d);
  auto kernel = flash_fwd_kernel<T, DMAX>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sh.s + BQ - 1) / BQ, sh.H, sh.b);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), lse,
                                           sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, Shape sh,
               cudaStream_t stream) {
  const int rows = sh.b * sh.s * sh.H;
  flash_bwd_preprocess_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                                   stream>>>(static_cast<const T*>(o),
                                             static_cast<const T*>(dout), delta, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  {
    constexpr int BQ = KvTile<DMAX>::BQ, BK = KvTile<DMAX>::BK;
    const size_t smem = sizeof(float) * dkdv_smem_floats(BQ, BK, sh.d);
    auto kernel = flash_bwd_dkdv_kernel<T, DMAX>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sh.L + BK - 1) / BK, sh.Hk, sh.b);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    constexpr int BQ = FwdTile<DMAX>::BQ, BK = FwdTile<DMAX>::BK;
    const size_t smem = sizeof(float) * dq_smem_floats(BQ, BK, sh.d);
    auto kernel = flash_bwd_dq_kernel<T, DMAX>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sh.s + BQ - 1) / BQ, sh.H, sh.b);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sh);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, float* lse, Shape sh,
                   cudaStream_t stream) {
  const size_t smem = fwd_mma_smem(DP);
  auto kernel = flash_fwd_mma_kernel<DP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sh.s + kMmaRows - 1) / kMmaRows, sh.H, sh.b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, Shape sh,
                   cudaStream_t stream) {
  using T = __nv_bfloat16;
  const int rows = sh.b * sh.s * sh.H;
  flash_bwd_preprocess_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                                   stream>>>(static_cast<const T*>(o),
                                             static_cast<const T*>(dout), delta, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    const size_t smem = dkdv_mma_smem(DP);
    auto kernel = flash_bwd_dkdv_mma_kernel<DP>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sh.L + kMmaKeys - 1) / kMmaKeys, sh.Hk, sh.b);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    const size_t smem = dq_mma_smem(DP);
    auto kernel = flash_bwd_dq_mma_kernel<DP>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sh.s + kMmaRows - 1) / kMmaRows, sh.H, sh.b);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sh);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadArgs = -1;

Shape make_shape(int b, int s, int L, int H, int Hk, int d, int causal, int window,
                 int q_offset, float scale) {
  Shape sh;
  sh.b = b; sh.s = s; sh.L = L; sh.H = H; sh.Hk = Hk; sh.G = H / Hk; sh.d = d;
  sh.causal = causal; sh.window = window; sh.q_offset = q_offset; sh.scale = scale;
  return sh;
}

bool bad(int b, int s, int L, int H, int Hk, int d, int dtype) {
  return b < 1 || s < 1 || L < 1 || Hk < 1 || H % Hk != 0 || d < 1 || d > 256 ||
         (dtype != kF32 && dtype != kBF16);
}

bool bad_mma(int d) { return d < 16 || d > 128 || d % 16 != 0; }

}  // namespace

#define FA_DISPATCH(LAUNCH, ...)                                                   \
  switch (dtype * 3 + (dmax_of(d) == 64 ? 0 : (dmax_of(d) == 128 ? 1 : 2))) {       \
    case kF32 * 3 + 0: return LAUNCH<float, 64>(__VA_ARGS__);                       \
    case kF32 * 3 + 1: return LAUNCH<float, 128>(__VA_ARGS__);                      \
    case kF32 * 3 + 2: return LAUNCH<float, 256>(__VA_ARGS__);                      \
    case kBF16 * 3 + 0: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);              \
    case kBF16 * 3 + 1: return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);             \
    case kBF16 * 3 + 2: return LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__);             \
    default: return kBadArgs;                                                       \
  }

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o, dO, dq, dk, dv all of
// it); lse and delta are float32 (b, H, s).  window 0 = none.  Returns the
// cudaError_t of the launches (0 on success) or -1 for arguments the
// kernels do not take.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                     int s, int L, int H, int Hk, int d, int causal, int window, int q_offset,
                     int dtype, float scale, void* stream) {
  if (bad(b, s, L, H, Hk, d, dtype)) return kBadArgs;
  const Shape sh = make_shape(b, s, L, H, Hk, d, causal, window, q_offset, scale);
  FA_DISPATCH(launch_fwd, q, k, v, o, static_cast<float*>(lse), sh,
              static_cast<cudaStream_t>(stream))
}

int flash_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* delta, void* dq, void* dk,
                     void* dv, int b, int s, int L, int H, int Hk, int d, int causal, int window,
                     int q_offset, int dtype, float scale, void* stream) {
  if (bad(b, s, L, H, Hk, d, dtype)) return kBadArgs;
  const Shape sh = make_shape(b, s, L, H, Hk, d, causal, window, q_offset, scale);
  FA_DISPATCH(launch_bwd, q, k, v, o, dout, static_cast<const float*>(lse),
              static_cast<float*>(delta), dq, dk, dv, sh, static_cast<cudaStream_t>(stream))
}

// The tensor-core bodies: bf16 only, d a multiple of 16 up to 128; the
// same arguments as above without the dtype code.
int flash_fwd_mma_launch(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                         int s, int L, int H, int Hk, int d, int causal, int window,
                         int q_offset, float scale, void* stream) {
  if (bad(b, s, L, H, Hk, d, kBF16) || bad_mma(d)) return kBadArgs;
  const Shape sh = make_shape(b, s, L, H, Hk, d, causal, window, q_offset, scale);
  const auto st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  return d <= 64 ? launch_fwd_mma<64>(q, k, v, o, lse_f, sh, st)
                 : launch_fwd_mma<128>(q, k, v, o, lse_f, sh, st);
}

int flash_bwd_mma_launch(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const void* lse, void* delta, void* dq, void* dk,
                         void* dv, int b, int s, int L, int H, int Hk, int d, int causal,
                         int window, int q_offset, float scale, void* stream) {
  if (bad(b, s, L, H, Hk, d, kBF16) || bad_mma(d)) return kBadArgs;
  const Shape sh = make_shape(b, s, L, H, Hk, d, causal, window, q_offset, scale);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  return d <= 64 ? launch_bwd_mma<64>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, sh, st)
                 : launch_bwd_mma<128>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, sh, st);
}

// The tensor-core bodies' tiles for head dim d (ops.py's MmaTiles, in its
// field order): dp, forward rows and keys, dK/dV keys and rows, dQ rows
// and keys.  Returns -1 for a d the bodies do not take.
int flash_mma_tiles(int d, int* out) {
  if (bad_mma(d)) return kBadArgs;
  const int dp = d <= 64 ? 64 : 128;
  const int inner = dp == 64 ? BwdInner<64>::N : BwdInner<128>::N;
  const int tiles[7] = {dp, kMmaRows, kMmaKeys, kMmaKeys, inner, kMmaRows, inner};
  for (int i = 0; i < 7; ++i) out[i] = tiles[i];
  return 0;
}

const char* flash_error_string(int code) {
  if (code == kBadArgs) return "arguments the flash attention kernels do not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

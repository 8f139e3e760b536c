// Flash attention for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU Pallas kernel of the JAX package:
//   flash_fwd_kernel <- kernels/flash_attention/flash_attention.py::_attn_kernel
//                       (flash_attention_fwd, :29-89)
// and gives it the backward the TPU side never had (the reference
// recomputes its gradient through the oracle's VJP, which on this card
// would materialise (b, H, s, L) f32 scores per buffer per layer):
//   flash_bwd_preprocess_kernel  D = rowsum(dO * O)
//   flash_bwd_dkdv_kernel        dK, dV of one (batch, KV head, key tile)
//   flash_bwd_dq_kernel          dQ of one (batch, query head, query tile)
// (FlashAttention-2's split of the backward.)
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
// stop waiting on memory.  This first version does its arithmetic in f32
// FMAs on the CUDA cores (67 TFLOP/s peak, not the tensor cores' 989), so
// it is bound by the FMA pipe and shared-memory loads.  What the design
// does about it: each block keeps its query (or key) tile in shared memory
// for the whole KV (or query) loop, so every element of q, k and v is read
// from device memory once per tile pair and reused BQ or BK times; each of
// the 128 threads owns a register micro-tile of scores and of the f32
// accumulator (rows ty + 8i, columns tx + 16j), so one shared-memory load
// feeds several FMAs; row strides are padded to d + 1 so the column reads
// of a warp hit distinct banks; tiles that causality or the window mask
// entirely are skipped, and so is the loop over them.  The backward's
// dK/dV block loops over the G query heads of its KV head, so GQA's sum
// over the group stays inside one block: no atomics, one summation order.
// wgmma, TMA and pipelined loads are left for later work.
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

const char* flash_error_string(int code) {
  if (code == kBadArgs) return "arguments the flash attention kernels do not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

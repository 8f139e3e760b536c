// Per-group int4/int8 dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel of the JAX package:
//   quant_matmul_wgmma_kernel,  <- kernels/quant_matmul/quant_matmul.py::quant_matmul_fwd
//   quant_matmul_splitk_kernel     (_qmm_kernel)
//
//   y = x @ ((w_q - zero) * scale)          x: (m, k) f32 or bf16
//
// w_q is (k, n) int8 holding one int4 value in [-8, 7] (or one int8 value)
// per byte, the reference's layout; scale and zero are (k / g, n) bf16, one
// row per group of g consecutive k rows.  y is written once in x's dtype.
//
// Exactness.  Both bodies use the zero-point split: per group,
//   part = x_g . q_g - rowsum(x_g) * zero_g,   acc += scale_g * part.
// A q value is an integer of magnitude at most 128, exact in bf16, and a
// bf16 x times it is exact in f32, so every product is the reference
// oracle's product exactly; only the order of the f32 sums differs, and
// the output then differs from the oracle's by at most one bf16 rounding
// flip (within kernel_tolerance).  A weight dequantized to bf16 before a
// bf16 GEMM would not be: (q - zero) * scale needs 13 bits, and rounding
// it to bf16's 8 moves a llama2-7b-sized output by several times the
// tolerance (tests/test_torch_kernel_numerics.py shows both).
//
// Two bodies; the wrapper (../ops.py, ``qmm_body``) picks one by x's dtype,
// m, n and g:
//
// * quant_matmul_wgmma_kernel (bf16 x, m >= the wrapper's threshold,
//   g % 64 == 0, n % 16 == 0): a 128 x 128 output tile per block of two
//   warpgroups, 64 rows each.  The k step is 64 rows: one thread starts
//   two TMA boxes per step, x's [128 x 64] bf16 tile and w_q's [64 x 128]
//   int8 tile, both 128-byte swizzled, into a ring of five stages (four in
//   flight) tracked by mbarriers; the group's scale and zero follow by
//   cp.async.  The int8 tile is converted to bf16 in shared memory (exact:
//   a byte under the exponent 2^23, one f32 subtraction, the upper half)
//   into an MN-major B tile with eight columns of ones beside it, so that
//   wgmma.m64n136k16 gives each row's sum of x with the group partial.
//   Tile t's wgmma runs while the previous group is folded into the f32
//   accumulator (two partials alternate by group) and tile t+1 is
//   converted.  m tiles run fastest in the grid, so blocks of one n tile
//   share w_q's bytes through L2; when the tiles alone give fewer than
//   two blocks per SM, k is split across blocks as in the decode body.
//   What bounds it: a 256-row chunk through llama2-7b's lm_head (4096 x
//   32000) is 67.1 GFLOP, 0.068 ms at 989 TFLOP/s: operations; w_q's
//   131 MB take 0.039 ms at 3.35 TB/s.
// * quant_matmul_splitk_kernel (small m, any f32 x, any g): CUDA cores.
//   A block of 128 threads owns 128 columns and a range of groups (a split
//   of k); a thread owns C neighbouring columns and reads them with one
//   C-byte load per k row (16 bytes at m <= 4), the block's k lanes taking
//   interleaved rows, eight rows per thread in flight.  Rows are templated
//   (M = 1, 2, 4, 8, 16 per tile, C = 16, 16, 16, 8, 4: M*C partial and
//   M*C running sums stay in registers), so m = 4 holds 4 accumulators per
//   column.  k is split across blocks until the grid fills the SMs (the
//   wrapper's ``splitk_plan``); the splits' f32 partials go to a scratch
//   (splits, m, n) the wrapper allocates, and quant_matmul_reduce_kernel
//   adds them in split order: no atomics, one summation order, the same
//   bits on every run.  What bounds it at decode: bytes, k*n of w_q plus
//   4*(k/g)*n of scale and zero, 0.040 ms for lm_head at 3.35 TB/s, 0.0052
//   ms for a 4096 x 4096 projection, 0.0139 ms for gate/up/down.
//
// Not yet: warp-specialised producer and consumer warps, TMA multicast of
// x across the n tiles of a cluster, a persistent grid, and two nibbles
// per byte (the reference's layout is one value per byte, and
// QuantizedTensor keeps it).
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (see ../../build.py and ../ops.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float byte_f32(uint32_t word, int b) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * b)) & 0xffu));
}

// ---------------------------------------------------------------------------
// decode body: split-k on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 128;
constexpr int kSplitCols = 128;      // columns per block
constexpr int kUnroll = 8;           // k rows per thread per chunk (loads in flight)

template <int M> struct SplitCols { static constexpr int value = M <= 4 ? 16 : 64 / M; };

template <int C>
__device__ __forceinline__ void load_cols(const int8_t* __restrict__ p, bool vec, int valid,
                                          uint32_t (&w)[C / 4]) {
  if (vec) {
    if constexpr (C == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (C == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
  } else {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) w[i] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c)           // unrolled: w stays in registers
      if (c < valid) w[c / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[c])) << (8 * (c % 4));
  }
}

// grid (n tiles of 128, splits, m tiles of M).  Block columns n0 .. n0+127;
// thread (kl, ct) owns columns n0 + ct*C .. +C-1 and k rows kl, kl+KL, ...
// of each chunk of KL*kUnroll rows; its groups are [split*gps, +gps).
template <typename XT, int M>
__global__ void __launch_bounds__(kSplitThreads)
quant_matmul_splitk_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                           const __nv_bfloat16* __restrict__ scales,
                           const __nv_bfloat16* __restrict__ zeros, XT* __restrict__ out,
                           float* __restrict__ partial, int m, int k, int n, int g, int gps) {
  constexpr int C = SplitCols<M>::value;
  constexpr int CT = kSplitCols / C;        // column threads
  constexpr int KL = kSplitThreads / CT;    // k lanes (= C)
  constexpr int KC = KL * kUnroll;          // k rows per chunk
  __shared__ float xs[M][KC];
  __shared__ float red[KL * M * kSplitCols];

  const int tid = threadIdx.x;
  const int ct = tid % CT, kl = tid / CT;
  const int col0 = blockIdx.x * kSplitCols + ct * C;
  const int row0 = blockIdx.z * M;
  const int split = blockIdx.y;
  const int groups = k / g;
  const int g0 = split * gps, g1 = min(groups, g0 + gps);
  const int valid = max(0, min(C, n - col0));
  const bool vec = valid == C && (n % C) == 0;

  float acc[M][C], part[M][C], rs[M];
#pragma unroll
  for (int r = 0; r < M; ++r) {
    rs[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = part[r][c] = 0.f;
  }

  for (int gi = g0; gi < g1; ++gi) {
    for (int kc = 0; kc < g; kc += KC) {
      const int rows = min(KC, g - kc);
      const size_t kbase = static_cast<size_t>(gi) * g + kc;
      uint32_t wv[kUnroll][C / 4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = kl + KL * u;
        if (r < rows && valid > 0) {
          load_cols<C>(wq + (kbase + r) * n + col0, vec, valid, wv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < C / 4; ++i) wv[u][i] = 0;
        }
      }
      __syncthreads();                      // the previous chunk's x is consumed
      for (int e = tid; e < M * KC; e += kSplitThreads) {
        const int rr = e / KC, kk = e - rr * KC;
        xs[rr][kk] = (row0 + rr < m && kk < rows)
                         ? to_f32(x[static_cast<size_t>(row0 + rr) * k + kbase + kk])
                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = kl + KL * u;          // rows past the chunk read x = 0, w = 0
        float xv[M];
#pragma unroll
        for (int rr = 0; rr < M; ++rr) {
          xv[rr] = xs[rr][r];
          rs[rr] += xv[rr];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float qf = byte_f32(wv[u][c / 4], c % 4);
#pragma unroll
          for (int rr = 0; rr < M; ++rr) part[rr][c] = fmaf(xv[rr], qf, part[rr][c]);
        }
      }
    }
    // fold the group: acc += scale * (part - rowsum * zero)
    const size_t meta = static_cast<size_t>(gi) * n + col0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool ok = c < valid;
      const float sc = ok ? __bfloat162float(scales[meta + c]) : 0.f;
      const float ze = ok ? __bfloat162float(zeros[meta + c]) : 0.f;
#pragma unroll
      for (int rr = 0; rr < M; ++rr) {
        acc[rr][c] = fmaf(sc, part[rr][c] - rs[rr] * ze, acc[rr][c]);
        part[rr][c] = 0.f;
      }
    }
#pragma unroll
    for (int rr = 0; rr < M; ++rr) rs[rr] = 0.f;
  }

  // the k lanes' sums meet in shared memory and are added in lane order
#pragma unroll
  for (int rr = 0; rr < M; ++rr)
#pragma unroll
    for (int c = 0; c < C; ++c) red[(kl * M + rr) * kSplitCols + ct * C + c] = acc[rr][c];
  __syncthreads();
  for (int e = tid; e < M * kSplitCols; e += kSplitThreads) {
    const int rr = e / kSplitCols, cc = e - rr * kSplitCols;
    const int row = row0 + rr, col = blockIdx.x * kSplitCols + cc;
    if (row >= m || col >= n) continue;
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < KL; ++l) s += red[(l * M + rr) * kSplitCols + cc];
    if (partial != nullptr)
      partial[(static_cast<size_t>(split) * m + row) * n + col] = s;
    else
      out[static_cast<size_t>(row) * n + col] = from_f32<XT>(s);
  }
}

// out[i] = sum over splits, in split order, of partial[split][i]
template <typename XT>
__global__ void quant_matmul_reduce_kernel(const float* __restrict__ partial,
                                           XT* __restrict__ out, size_t count, int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[static_cast<size_t>(sp) * count + i];
  out[i] = from_f32<XT>(s);
}

// ---------------------------------------------------------------------------
// prefill body: wgmma on bf16 tiles
// ---------------------------------------------------------------------------

constexpr int kBM = 128;             // rows per block: one 64-row wgmma per warpgroup
constexpr int kBN = 128;             // columns per block
constexpr int kBNX = kBN + 8;        // B's columns with the block of ones (wgmma n136)
constexpr int kXBox = 64;            // k columns of x per TMA box: 128 swizzled bytes
constexpr int kWgThreads = 256;      // two warpgroups
constexpr int kCore = 128;           // bytes of one 8 x 16-byte core matrix
// the TMA ring: five stages of 64 k rows or three of 128 (four or two in flight)
template <int KT> constexpr int wg_stages() { return KT == 64 ? 5 : 3; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;      // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a 2-D box of a tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor: start address, leading byte offset
// (between core matrices along K; unused by the 128-byte swizzle) and
// stride byte offset (between 8-row core-matrix groups along M or N), in
// 16-byte units, and the layout: 0 no swizzle, 1 the 128-byte swizzle.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// D(64 x 136, f32) (+)= A(64 x 16, bf16, K-major) * B(16 x 136, bf16, MN-major)
__device__ __forceinline__ void wgmma_m64n136k16(float (&d)[68], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67}, "
      "%68, %69, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keeps the compiler from moving reads or writes of the accumulator
// registers across the asynchronous wgmma (and its wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// int8 -> exact f32: byte b of w ^ 0x80808080 under exponent 2^23 is
// 2^23 + v + 128, and one subtraction leaves v (no I2F on the slow pipe).
__device__ __forceinline__ float i8_f32(uint32_t flipped, int b) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 | b)) - 8388736.f;
}
// two small-integer f32 -> bf16x2: their upper halves, exactly
__device__ __forceinline__ uint32_t hi_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Shared memory of the wgmma body, from a 1024-byte boundary.  A ring of
// stages of KT k rows, each filled by TMA boxes: x's tile as KT/64 boxes
// [128 rows][64] bf16 and w_q's tile [KT k rows][128] int8, all rows of
// 128 bytes whose
// 16-byte chunks are swizzled by row % 8 (the layout wgmma reads for a
// K-major A, and one that spreads the conversion's reads over the banks).
// Two B buffers: w_q's tile as bf16 in B's MN-major core layout
// [k/8][136/8][8 k rows][8 bf16], no swizzle, whose last eight columns hold
// ones, so that the products also give each row's sum of x in columns
// 128-135.  A ring of eight groups' scale and zero rows [2][128] bf16
// (cp.async), read by the group's fold after its stages are reused.  One
// mbarrier per stage.
template <int KT>
struct WgSmem {
  static constexpr int kStages = wg_stages<KT>();
  static constexpr int kA = kBM * KT * 2;                 // KT / 64 boxes of x
  static constexpr int kW = KT * kBN;
  static constexpr int kStage = kA + kW;
  static constexpr int kB = kBNX * KT * 2;
  static constexpr int kMeta = 2 * kBN * 2;
  static constexpr int kBars = kStages * kStage + 2 * kB + 8 * kMeta;
  static constexpr int kBytes = kBars + 8 * kStages + 1024;     // + alignment slack
  static_assert(kA % 1024 == 0 && kStage % 1024 == 0, "swizzled boxes need 1024 B alignment");
};

// grid (m tiles of 128, n tiles of 128, k splits of gps groups); two
// warpgroups per block, each owning 64 rows.  Tile t's products run
// (wgmma is asynchronous) while the previous group's partial is folded
// (two partials alternate by group), tile t+1 is converted, and tiles
// t+2 .. t+4 are in flight.
template <int KT>
__global__ void __launch_bounds__(kWgThreads)
quant_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const __nv_bfloat16* __restrict__ scales,
                          const __nv_bfloat16* __restrict__ zeros,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int m,
                          int k, int n, int g, int gps) {
  using S = WgSmem<KT>;
  constexpr int kWgStages = S::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bbuf = smem + kWgStages * S::kStage;                   // 2 B tiles
  unsigned char* metas = bbuf + 2 * S::kB;                              // 8 groups
  const uint32_t bars = smem_u32(smem + S::kBars);                      // kWgStages

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const bool wg_live = m0 + 64 * wg < m;                 // this warpgroup has rows
  const int tpg = g / KT;                                // tiles per group
  const int groups = k / g;
  const int g0 = blockIdx.z * gps, g1 = min(groups, g0 + gps);
  const int t0 = g0 * tpg, tiles = (g1 - g0) * tpg;
  const bool meta_vec = (n % 8) == 0;

  auto stage_of = [&](int t) { return smem + (t % kWgStages) * S::kStage; };
  auto bar_of = [&](int t) { return bars + 8 * (t % kWgStages); };
  // tile t (the block's index): one thread starts its two boxes; the
  // group's scale and zero come with its first tile
  auto load_tile = [&](int t) {
    const int kt = (t0 + t) * KT;
    if (tid == 0) {
      const uint32_t bar = bar_of(t);
      mbar_expect_tx(bar, S::kStage);
#pragma unroll
      for (int h = 0; h < KT / kXBox; ++h)
        tma_load_2d(smem_u32(stage_of(t) + h * kBM * 128), &map_x, kt + h * kXBox, m0, bar);
      tma_load_2d(smem_u32(stage_of(t) + S::kA), &map_w, n0, kt, bar);
    }
    if (t % tpg == 0 && tid < 2 * kBN / 8) {
      __nv_bfloat16* meta =
          reinterpret_cast<__nv_bfloat16*>(metas + ((t / tpg) & 7) * S::kMeta);
      const size_t mrow = static_cast<size_t>(kt / g) * n;
      const int which = tid / (kBN / 8), cb = tid - which * (kBN / 8);
      const int col = n0 + cb * 8;
      const __nv_bfloat16* src = (which ? zeros : scales) + mrow + col;
      if (meta_vec) {
        cp_async16(meta + which * kBN + cb * 8, col < n ? src : scales, col < n);
      } else {
        for (int b = 0; b < 8; ++b)
          meta[which * kBN + cb * 8 + b] = col + b < n ? src[b] : __float2bfloat16(0.f);
      }
    }
  };

  // w_q int8 -> bf16 (exact) into B buffer t % 2, MN-major: thread task
  // (k row, 16 columns) is one 16-byte read (at its swizzled place) and
  // two core-matrix rows
  auto prepare = [&](int t) {
    const unsigned char* wr = stage_of(t) + S::kA;
    unsigned char* bs = bbuf + (t & 1) * S::kB;
#pragma unroll
    for (int i = 0; i < KT * (kBN / 16) / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads;
      const int kr = c % KT, cb = c / KT;
      const uint4 raw = *reinterpret_cast<const uint4*>(wr + kr * kBN + ((cb ^ (kr & 7)) << 4));
      const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                             raw.w ^ 0x80808080u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t word = w[2 * h + j / 2];
          const int b = 2 * (j % 2);
          o[j] = hi_halves(i8_f32(word, b), i8_f32(word, b + 1));
        }
        *reinterpret_cast<uint4*>(bs + ((kr / 8) * (kBNX / 8) + 2 * cb + h) * kCore +
                                  (kr % 8) * 16) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // acc += scale * (part - rowsum * zero) for block group gb.  D's
  // fragment: register i of warp w (of its warpgroup) holds row 16w +
  // lane/4 + 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2; registers
  // 64-67 are columns of ones, each the row's sum of x over the group
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  auto fold = [&](float(&part)[68], int gb) {
    const __nv_bfloat16* meta =
        reinterpret_cast<const __nv_bfloat16*>(metas + (gb & 7) * S::kMeta);
    const float rs_lo = part[64], rs_hi = part[66];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const float2 sc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(meta + col));
      const float2 ze =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(meta + kBN + col));
      const float r = ((i / 2) % 2) ? rs_hi : rs_lo;
      acc[i] = fmaf(sc.x, part[i] - r * ze.x, acc[i]);
      acc[i + 1] = fmaf(sc.y, part[i + 1] - r * ze.y, acc[i + 1]);
    }
  };

  // tile t: its products into cur (a fresh partial at its group's first
  // k step; a warpgroup past m has none), then, once the previous tile's
  // are done, the previous group's fold from prev; then the loads of the
  // tile kWgStages - 1 ahead and tile t+1's conversion, all while tile
  // t's products run
  auto step = [&](int t, float(&cur)[68], float(&prev)[68]) {
    const unsigned char* st = stage_of(t);
    const unsigned char* bs = bbuf + (t & 1) * S::kB;
    const bool group_start = t % tpg == 0;
    if (wg_live) {
      fence_regs(cur);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks) {
        const uint64_t da = gmma_desc(
            smem_u32(st + (ks / 4) * kBM * 128 + wg * 64 * 128 + (ks % 4) * 32), 16, 1024, 1);
        const uint64_t db = gmma_desc(smem_u32(bs + 2 * ks * (kBNX / 8) * kCore),
                                      (kBNX / 8) * kCore, kCore, 0);
        wgmma_m64n136k16(cur, da, db, (group_start && ks == 0) ? 0 : 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");   // tile t-1's
      if (group_start && t > 0) {
        fence_regs(prev);
        fold(prev, t / tpg - 1);
      }
    }
    cp_async_wait<kWgStages - 3>();    // tile t+1's scale and zero
    if (t + 1 < tiles) mbar_wait(bar_of(t + 1), ((t + 1) / kWgStages) & 1);
    __syncthreads();                   // tile t-1's stage and B buffer are free
    if (t + kWgStages - 1 < tiles) load_tile(t + kWgStages - 1);
    cp_async_commit();                 // possibly empty: the wait counts stay uniform
    if (t + 1 < tiles) prepare(t + 1);
    __syncthreads();
  };

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the ones of both B buffers (columns 128-135), written once
  if (tid < 2 * KT) {
    const int buf = tid / KT, kr = tid % KT;
    *reinterpret_cast<uint4*>(bbuf + buf * S::kB + ((kr / 8) * (kBNX / 8) + kBN / 8) * kCore +
                              (kr % 8) * 16) =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
  }
  __syncthreads();
  for (int t = 0; t < kWgStages - 1; ++t) {             // prologue: the ring fills
    if (t < tiles) load_tile(t);
    cp_async_commit();
  }
  cp_async_wait<kWgStages - 2>();
  mbar_wait(bar_of(0), 0);
  __syncthreads();
  prepare(0);
  __syncthreads();

  float p0[68], p1[68];
  const int block_groups = g1 - g0;
  for (int gb = 0, t = 0; gb < block_groups; gb += 2) {
    for (int j = 0; j < tpg; ++j, ++t) step(t, p0, p1);
    if (gb + 1 < block_groups)
      for (int j = 0; j < tpg; ++j, ++t) step(t, p1, p0);
  }
  if (wg_live) {                       // the last group's fold
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if ((block_groups - 1) & 1) {
      fence_regs(p1);
      fold(p1, block_groups - 1);
    } else {
      fence_regs(p0);
      fold(p0, block_groups - 1);
    }
  }

  // epilogue: y in bf16, or this split's f32 partial; ragged rows and
  // columns masked
  const int wrow = m0 + 64 * wg + 16 * (warp & 3) + lane / 4;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = wrow + 8 * ((i / 2) % 2);
    const int col = n0 + 8 * (i / 4) + 2 * (lane % 4);
    if (row >= m) continue;
    const size_t o = static_cast<size_t>(row) * n + col;
    const bool pair = col + 1 < n && (n % 2) == 0;
    if (partial != nullptr) {
      float* dst = partial + static_cast<size_t>(blockIdx.z) * m * n + o;
      if (pair) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[i], acc[i + 1]);
      } else {
        if (col < n) dst[0] = acc[i];
        if (col + 1 < n) dst[1] = acc[i + 1];
      }
    } else {
      __nv_bfloat16* dst = out + o;
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
      } else {
        if (col < n) dst[0] = __float2bfloat16(acc[i]);
        if (col + 1 < n) dst[1] = __float2bfloat16(acc[i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename XT>
int reduce_splits(void* partial, void* out, int m, int n, int splits, cudaStream_t stream) {
  const size_t count = static_cast<size_t>(m) * n;
  const int threads = 256;
  quant_matmul_reduce_kernel<XT><<<static_cast<unsigned>((count + threads - 1) / threads),
                                   threads, 0, stream>>>(static_cast<const float*>(partial),
                                                         static_cast<XT*>(out), count, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, int M>
int launch_splitk(const void* x, const void* wq, const void* scales, const void* zeros,
                  void* out, void* partial, int m, int k, int n, int g, int splits, int gps,
                  cudaStream_t stream) {
  const dim3 grid((n + kSplitCols - 1) / kSplitCols, splits, (m + M - 1) / M);
  quant_matmul_splitk_kernel<XT, M><<<grid, kSplitThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(wq),
      static_cast<const __nv_bfloat16*>(scales), static_cast<const __nv_bfloat16*>(zeros),
      static_cast<XT*>(out), splits > 1 ? static_cast<float*>(partial) : nullptr, m, k, n, g,
      gps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return reduce_splits<XT>(partial, out, m, n, splits, stream);
}

template <typename XT>
int dispatch_splitk(int rows, const void* x, const void* wq, const void* scales,
                    const void* zeros, void* out, void* partial, int m, int k, int n, int g,
                    int splits, int gps, cudaStream_t st) {
#define QMM_ROWS(M)                                                                       \
  case M:                                                                                 \
    return launch_splitk<XT, M>(x, wq, scales, zeros, out, partial, m, k, n, g, splits, gps, \
                                st);
  switch (rows) {
    QMM_ROWS(1)
    QMM_ROWS(2)
    QMM_ROWS(4)
    QMM_ROWS(8)
    QMM_ROWS(16)
    default: return -1;
  }
#undef QMM_ROWS
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) matrix of `elem`-byte values, boxes of
// box_rows x box_cols, 128-byte swizzle; rows past the end read as zeros
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                int rows, int cols, int box_rows, int box_cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estrides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estrides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kNoTensorMap = -2;

template <int KT>
int launch_wgmma(const void* x, const void* wq, const void* scales, const void* zeros,
                 void* out, void* partial, int m, int k, int n, int g, int splits, int gps,
                 cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  if (!tensor_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, kBM, kXBox) ||
      !tensor_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, k, n, KT, kBN))
    return kNoTensorMap;
  auto kernel = quant_matmul_wgmma_kernel<KT>;
  const int smem = WgSmem<KT>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN, splits);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      map_x, map_w, static_cast<const __nv_bfloat16*>(scales),
      static_cast<const __nv_bfloat16*>(zeros), static_cast<__nv_bfloat16*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, m, k, n, g, gps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return reduce_splits<__nv_bfloat16>(partial, out, m, n, splits, stream);
}

constexpr int kBadArgs = -1;

}  // namespace

extern "C" {

// The decode body.  x_dtype: 0 = float32, 1 = bfloat16 (x and the
// output); rows: the m tile (1, 2, 4, 8 or 16); splits and gps: k split
// into `splits` ranges of `gps` groups; partial: an f32 scratch of
// splits * m * n (unused when splits == 1).  Returns the cudaError_t of
// the launches (0 on success) or -1 for unsupported arguments.
int quant_matmul_splitk_launch(const void* x, const void* wq, const void* scales,
                               const void* zeros, void* out, void* partial, int m, int k, int n,
                               int g, int x_dtype, int rows, int splits, int gps, void* stream) {
  if (m < 1 || k < 1 || n < 1 || g < 1 || k % g != 0) return kBadArgs;
  if (splits < 1 || splits > 65535 || gps < 1 || (splits - 1) * gps >= k / g) return kBadArgs;
  if ((m + rows - 1) / rows > 65535 || (splits > 1 && partial == nullptr)) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return dispatch_splitk<float>(rows, x, wq, scales, zeros, out, partial, m, k, n, g,
                                    splits, gps, st);
    case kBF16:
      return dispatch_splitk<__nv_bfloat16>(rows, x, wq, scales, zeros, out, partial, m, k, n,
                                            g, splits, gps, st);
    default: return kBadArgs;
  }
}

// The prefill body: bf16 x and output, g a multiple of 64, n a multiple
// of 16 (w_q's rows are a TMA tensor's strides); k split into `splits`
// ranges of `gps` groups (partial: an f32 scratch of splits * m * n,
// unused when splits == 1).
int quant_matmul_wgmma_launch(const void* x, const void* wq, const void* scales,
                              const void* zeros, void* out, void* partial, int m, int k, int n,
                              int g, int splits, int gps, void* stream) {
  if (m < 1 || k < 1 || n < 1 || g < kXBox || g % kXBox != 0 || k % g != 0) return kBadArgs;
  if (n % 16 != 0 || (n + kBN - 1) / kBN > 65535) return kBadArgs;
  if (splits < 1 || splits > 65535 || gps < 1 || (splits - 1) * gps >= k / g) return kBadArgs;
  if (splits > 1 && partial == nullptr) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g % 128 == 0)
    return launch_wgmma<128>(x, wq, scales, zeros, out, partial, m, k, n, g, splits, gps, st);
  return launch_wgmma<64>(x, wq, scales, zeros, out, partial, m, k, n, g, splits, gps, st);
}

const char* quant_matmul_error_string(int code) {
  if (code == kBadArgs) return "unsupported x dtype, shape or split (k % group_size != 0?)";
  if (code == kNoTensorMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

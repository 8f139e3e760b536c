// Per-group int4/int8 dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel of the JAX package:
//   quant_matmul_kernel <- kernels/quant_matmul/quant_matmul.py::quant_matmul_fwd
//                          (_qmm_kernel)
//
//   y = x @ ((w_q - zero) * scale)          x: (m, k) f32 or bf16
//
// w_q is (k, n) int8 holding one int4 value in [-8, 7] (or one int8 value)
// per byte, the reference's layout; scale and zero are (k / g, n) bf16, one
// row per group of g consecutive k rows.  Each weight is dequantized in f32
// in the reference oracle's order, (float(w_q) - float(zero)) *
// float(scale), products accumulate in f32, and y is written once in x's
// dtype.  Any m, any n (the ragged n edge is masked; the TPU kernel pads n
// to 128), any g that divides k.
//
// What bounds it on the card.  Decode (m = 4) reads each weight byte once
// and does 2*m flops on it: k*n bytes of w_q plus 4*(k/g)*n of scale and
// zero, so llama2-7b's lm_head (4096 x 32000, g = 128) moves 135.2 MB,
// about 0.040 ms at 3.35 TB/s, a 4096 x 4096 projection about 0.0052 ms,
// gate/up/down (4096 <-> 11008) about 0.0139 ms each: bytes.  A 256-row
// prefill chunk through lm_head is 2*256*4096*32000 = 67.1 GFLOP, about
// 0.068 ms at 989 TFLOP/s of bf16 tensor cores: operations.
//
// This first version is simple and right, on the CUDA cores in f32:
//
// * one block per (16-row m tile, 32-column n tile): 256 threads, eight
//   warps; lane j of every warp owns column n0 + j for the tile's rows, so
//   a warp's w_q loads are 32 neighbouring bytes of one k row (coalesced),
//   and n = 4096 already gives 128 blocks at decode;
// * the k/g groups are dealt round-robin to the eight warps (the TPU grid's
//   sequential K axis becomes a loop inside the block); a warp loads its
//   group's scale and zero for its column once, then streams the group's
//   rows in chunks of 32: it starts the chunk's 32 w_q loads together
//   (so 32 loads per warp are in flight, not one), stages the x chunk
//   (16 rows x 32 k, f32) in its own slice of shared memory, stored
//   k-major so that one 16-byte read gives four rows' x, and runs 16 FMAs
//   per dequantized weight into 16 f32 accumulators in registers
//   (warp-synchronous: no block barrier in the main loop);
// * at the end the eight warps' partial sums meet in shared memory, are
//   added in warp order (one summation order, deterministic) and written.
//
// Not yet: tensor cores (wgmma on dequantized bf16 tiles for m >= 64),
// vectorised 16-byte w_q loads, two nibbles per byte, and a split of k
// across blocks for narrow n at decode.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (see ../../build.py and ../ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;            // rows of x per block (m tile)
constexpr int kCols = 32;            // columns per block (one per lane)
constexpr int kChunk = 32;           // k rows staged per step of a warp
constexpr int kStride = kRows + 4;   // floats per staged k row: 16-byte aligned

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

template <typename XT>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                    const __nv_bfloat16* __restrict__ scales,
                    const __nv_bfloat16* __restrict__ zeros, XT* __restrict__ out, int m,
                    int k, int n, int g) {
  __shared__ __align__(16) float x_s[kWarps][kChunk * kStride];   // per warp, k-major
  __shared__ float part[kWarps][kRows * kCols];                   // per-warp partial sums

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * kRows;
  const int j = blockIdx.x * kCols + lane;    // this lane's column
  const int rows = min(kRows, m - m0);
  const bool col_ok = j < n;
  const int jc = col_ok ? j : n - 1;          // masked lanes read a valid column
  float* xs = x_s[warp];

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  const int groups = k / g;
  for (int gi = warp; gi < groups; gi += kWarps) {
    const size_t meta = static_cast<size_t>(gi) * n + jc;
    const float scale = __bfloat162float(scales[meta]);
    const float zero = __bfloat162float(zeros[meta]);
    for (int kk = 0; kk < g; kk += kChunk) {
      const int k0 = gi * g + kk;
      const int kc = min(kChunk, g - kk);
      // the chunk's w_q bytes of this column first, all loads in flight
      const int8_t* wrow = wq + static_cast<size_t>(k0) * n + jc;
      int8_t wv[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) wv[c] = c < kc ? wrow[static_cast<size_t>(c) * n] : 0;
      __syncwarp();                           // the previous chunk is consumed
      // stage x[m0 : m0 + 16, k0 : k0 + kc] as f32, lane = k offset; rows
      // and k offsets past the edge are 0, so they add exact zeros below
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        xs[lane * kStride + r] =
            (r < rows && lane < kc) ? to_f32(x[static_cast<size_t>(m0 + r) * k + k0 + lane])
                                    : 0.f;
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float w = (static_cast<float>(wv[c]) - zero) * scale;
        const float4* xr = reinterpret_cast<const float4*>(xs + c * kStride);
#pragma unroll
        for (int r4 = 0; r4 < kRows / 4; ++r4) {
          const float4 xv = xr[r4];
          acc[4 * r4 + 0] += xv.x * w;
          acc[4 * r4 + 1] += xv.y * w;
          acc[4 * r4 + 2] += xv.z * w;
          acc[4 * r4 + 3] += xv.w * w;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) part[warp][r * kCols + lane] = acc[r];
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols, c = e - r * kCols;
    const int col = blockIdx.x * kCols + c;
    if (r >= rows || col >= n) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][e];
    out[static_cast<size_t>(m0 + r) * n + col] = from_f32<XT>(sum);
  }
}

template <typename XT>
int launch(const void* x, const void* wq, const void* scales, const void* zeros, void* out,
           int m, int k, int n, int g, cudaStream_t stream) {
  const dim3 grid((n + kCols - 1) / kCols, (m + kRows - 1) / kRows);
  quant_matmul_kernel<XT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(wq),
      static_cast<const __nv_bfloat16*>(scales), static_cast<const __nv_bfloat16*>(zeros),
      static_cast<XT*>(out), m, k, n, g);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadArgs = -1;

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16 (x and the output).  Returns the
// cudaError_t of the launch (0 on success) or -1 for an unsupported dtype
// or shape (m, k, n, g < 1, k not a multiple of g, more than 65535 m tiles).
int quant_matmul_launch(const void* x, const void* wq, const void* scales, const void* zeros,
                        void* out, int m, int k, int n, int g, int x_dtype, void* stream) {
  if (m < 1 || k < 1 || n < 1 || g < 1 || k % g != 0) return kBadArgs;
  if ((m + kRows - 1) / kRows > 65535) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32: return launch<float>(x, wq, scales, zeros, out, m, k, n, g, st);
    case kBF16: return launch<__nv_bfloat16>(x, wq, scales, zeros, out, m, k, n, g, st);
    default: return kBadArgs;
  }
}

const char* quant_matmul_error_string(int code) {
  if (code == kBadArgs) return "unsupported x dtype or shape (k % group_size != 0?)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

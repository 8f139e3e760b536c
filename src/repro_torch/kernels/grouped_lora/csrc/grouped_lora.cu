// Grouped low-rank (LoRA) matmul for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel of the JAX package:
//   grouped_lora_kernel <- kernels/grouped_lora/grouped_lora.py::grouped_lora_fwd
//                          (_grouped_lora_kernel)
//
// Multi-tenant serving applies a different adapter per batch slot:
//
//   out[s] = scale * (x[s] @ A[idx[s]]) @ B[idx[s]]        x[s]: (T, k)
//
// with A (P, k, R) and B (P, R, n) a rank-padded adapter pool (lanes past
// an adapter's true rank are zeros) and idx[s] < 0 meaning "no adapter",
// which gives an exact-zero delta.  An idx[s] >= P is a fault, as it is
// for torch's own indexing: the block traps, and the next synchronisation
// raises.  (__trap, not assert: on an H100, assert's call took the
// kernel from 48 to 64 registers and 15 % more time.)  T is 1 in decode, k+1 in speculative verify
// and the chunk size in prefill; R <= 64.
//
// What bounds it on the card: bytes.  It does 2*(k + n)*R flops per row of
// x for the (k + n)*R factor elements it reads once per adapter, so at
// decode (T = 1) it is ~R/2 flops per byte read, far below the ~295 the
// H100 needs before its tensor cores are the limit; only a long prefill
// chunk (T = 256) comes near balance.  This first version is simple and
// right, on the CUDA cores in f32:
//
// * grid (ceil(n / 256), ceil(T / 16), S): a block owns 16 rows of slot s
//   and 256 output columns, one column per thread;
// * the block reads idx[s] itself (scalar prefetch has no counterpart on
//   the card); a block with idx[s] < 0 writes zeros and reads no factor;
// * phase 1 computes the 16 x R tile x @ A[idx] in f32, streaming k through
//   shared memory in slices of 64 (so shared memory is 24 KB whatever T and
//   k are: T = 256 and k = 4096 fit as well as T = 1);
// * phase 2 multiplies that tile by the block's 256 columns of B[idx],
//   reading each factor element once, and writes scale * sum in x's dtype.
//
// One launch: every n-tile recomputes its rows' x @ A (16 x k x R) and
// re-reads A[idx], where a second launch would compute the (S, T, R)
// intermediate once and pass it through device memory.  Which costs less
// is not measured.  Phase 1 maps (row, lane) pairs to threads, so at
// rank 16 only 16 of the 256 threads work at T = 1 (decode) and 64 at
// T >= 4, each running k as one serial chain of FMAs.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (see ../../build.py and ../ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // one output column per thread
constexpr int kRows = 16;        // rows of x per block
constexpr int kChunkK = 64;      // slice of k staged per step of phase 1
constexpr int kMaxRank = 64;     // largest padded pool rank taken
constexpr int kPhase1 = kRows * kMaxRank / kThreads;   // (row, lane) pairs per thread

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

template <typename XT, typename FT>
__global__ void __launch_bounds__(kThreads)
grouped_lora_kernel(const XT* __restrict__ x, const FT* __restrict__ A,
                    const FT* __restrict__ B, const int* __restrict__ idx,
                    XT* __restrict__ out, int T, int k, int R, int n, int P, float scale) {
  __shared__ float x_s[kRows * kChunkK];      // rows x k-slice
  __shared__ float a_s[kChunkK * kMaxRank];   // k-slice x R
  __shared__ float xa_s[kRows * kMaxRank];    // rows x R: x @ A[idx]

  const int tid = threadIdx.x;
  const int j = blockIdx.x * kThreads + tid;  // this thread's output column
  const int t0 = blockIdx.y * kRows;
  const int s = blockIdx.z;
  const int rows = min(kRows, T - t0);
  XT* o = out + (static_cast<size_t>(s) * T + t0) * n;

  const int a = idx[s];
  if (a < 0) {                                // no adapter: exact zeros
    if (j < n)
      for (int t = 0; t < rows; ++t) o[static_cast<size_t>(t) * n + j] = from_f32<XT>(0.f);
    return;
  }
  if (a >= P) __trap();                       // a slot past the pool: fault
  const XT* xs = x + (static_cast<size_t>(s) * T + t0) * k;
  const FT* Ap = A + static_cast<size_t>(a) * k * R;
  const FT* Bp = B + static_cast<size_t>(a) * R * n;

  // phase 1: thread owns (row, lane) pairs e = tid + i * kThreads
  float acc1[kPhase1];
#pragma unroll
  for (int i = 0; i < kPhase1; ++i) acc1[i] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kChunkK) {
    const int kc = min(kChunkK, k - k0);
    for (int e = tid; e < kRows * kChunkK; e += kThreads) {
      const int t = e / kChunkK, c = e - t * kChunkK;
      x_s[e] = (t < rows && c < kc) ? to_f32(xs[static_cast<size_t>(t) * k + k0 + c]) : 0.f;
    }
    for (int e = tid; e < kChunkK * R; e += kThreads) {
      const int c = e / R, r = e - c * R;
      a_s[c * kMaxRank + r] = c < kc ? to_f32(Ap[static_cast<size_t>(k0 + c) * R + r]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPhase1; ++i) {
      const int e = tid + i * kThreads;
      const int t = e / kMaxRank, r = e - t * kMaxRank;
      if (r < R && t < rows) {
        float sum = acc1[i];
        for (int c = 0; c < kc; ++c) sum += x_s[t * kChunkK + c] * a_s[c * kMaxRank + r];
        acc1[i] = sum;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPhase1; ++i) xa_s[tid + i * kThreads] = acc1[i];
  __syncthreads();

  // phase 2: column j of (x @ A[idx]) @ B[idx] for the block's rows
  if (j >= n) return;
  float acc[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) acc[t] = 0.f;
  for (int r = 0; r < R; ++r) {
    const float b = to_f32(Bp[static_cast<size_t>(r) * n + j]);
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] += xa_s[t * kMaxRank + r] * b;
  }
  for (int t = 0; t < rows; ++t) o[static_cast<size_t>(t) * n + j] = from_f32<XT>(scale * acc[t]);
}

template <typename XT, typename FT>
int launch(const void* x, const void* A, const void* B, const void* idx, void* out, int S,
           int T, int k, int R, int n, int P, float scale, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, (T + kRows - 1) / kRows, S);
  grouped_lora_kernel<XT, FT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const FT*>(A), static_cast<const FT*>(B),
      static_cast<const int*>(idx), static_cast<XT*>(out), T, k, R, n, P, scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadArgs = -1;

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, for x (and the output) and for
// the factors.  Returns the cudaError_t of the launch (0 on success) or -1
// for an unsupported dtype pair or a rank above 64.
int grouped_lora_launch(const void* x, const void* A, const void* B, const void* idx,
                        void* out, int S, int T, int k, int R, int n, int P, int x_dtype,
                        int f_dtype, float scale, void* stream) {
  if (R < 1 || R > kMaxRank) return kBadArgs;
  if (x_dtype < kF32 || x_dtype > kBF16 || f_dtype < kF32 || f_dtype > kBF16) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + f_dtype) {
    case kF32 * 2 + kF32: return launch<float, float>(x, A, B, idx, out, S, T, k, R, n, P, scale, st);
    case kF32 * 2 + kBF16:
      return launch<float, __nv_bfloat16>(x, A, B, idx, out, S, T, k, R, n, P, scale, st);
    case kBF16 * 2 + kF32:
      return launch<__nv_bfloat16, float>(x, A, B, idx, out, S, T, k, R, n, P, scale, st);
    case kBF16 * 2 + kBF16:
      return launch<__nv_bfloat16, __nv_bfloat16>(x, A, B, idx, out, S, T, k, R, n, P, scale,
                                                    st);
    default: return kBadArgs;
  }
}

int grouped_lora_max_rank() { return kMaxRank; }

const char* grouped_lora_error_string(int code) {
  if (code == kBadArgs) return "unsupported (x, factor) dtype pair or rank";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

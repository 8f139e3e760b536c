// Grouped low-rank (LoRA) matmul for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel of the JAX package:
//   grouped_lora_xa_kernel    <- kernels/grouped_lora/grouped_lora.py::grouped_lora_fwd
//   + grouped_lora_xb_kernel     (_grouped_lora_kernel)
//
// Multi-tenant serving applies a different adapter per batch slot:
//
//   out[s] = scale * (x[s] @ A[idx[s]]) @ B[idx[s]]        x[s]: (T, k)
//
// with A (P, k, R) and B (P, R, n) a rank-padded adapter pool (lanes past
// an adapter's true rank are zeros) and idx[s] < 0 meaning "no adapter",
// which gives an exact-zero delta and reads no factor.  An idx[s] >= P is a
// fault, as it is for torch's own indexing: the block traps, and the next
// synchronisation raises.  (__trap, not assert: on an H100, assert's call
// took the first version of this kernel from 48 to 64 registers and 15 %
// more time.)  T is 1 in decode, k+1 in speculative verify and the chunk
// size in prefill; R <= 64.  One launch takes up to three projections of
// the same x (q, k and v: one pool slot, k and R, each its own B, n and
// output), so that the engine adds the three deltas with one launch.
//
// What bounds it on the card: bytes.  It does 2*(k + n)*R flops per row of
// x for the (k + n)*R factor elements it reads once per adapter, so at
// decode (T = 1) it is ~R/2 flops per byte read, far below the ~295 the
// H100 needs before its tensor cores are the limit; only a long prefill
// chunk (T = 256) comes near balance.  At the main path's sizes the bytes
// take well under a microsecond, so what sets its time is latency: how
// many dependent loads a thread waits for, and how much of the card the
// grid fills.  Two launches, all f32 on the CUDA cores (f32 x stays exact,
// and bf16 products are exact in f32 too):
//
// * grouped_lora_xa_kernel, x @ A[idx] once: grid (k slices, tiles of 16
//   rows, S), enough slices for two blocks per SM, at most 32 (../ops.py
//   split_plan: phase 2 adds the slices in a chain).
//   In a block every thread takes 4 rows and 8 rank lanes of one
//   projection and a share of the slice, reads 8 consecutive k of each
//   row and the 8 x 8 block of A beside them with 16-byte loads (each A
//   load serves the 4 rows), keeps 32 partial sums in registers, and the
//   block adds the shares in a fixed order through shared memory, writing
//   f32 partial sums (splits, S, T, n_proj * R) to device memory: no
//   serial chain over k, and the same bits on every run;
// * grouped_lora_xb_kernel, (x @ A) @ B: grid (groups of 64-column tiles
//   of every projection, row tiles, S); a block adds the slices' partial
//   sums in slice order, then computes one column per thread for 4 of the
//   tile's rows, each factor element read once per row tile, and writes
//   scale * sum in x's dtype.
//
// One launch instead, every 64-column tile recomputing its rows' x @ A,
// was measured against these two on the card and lost at every main-path
// T (PERF.md): it reads A once per column tile (32 MB from L2 at 4 slots,
// n = 4096) where the split reads it once per slot.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (see ../../build.py and ../ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;        // rows of x per block
constexpr int kCols = 64;        // output columns per phase-2 tile
constexpr int kMaxRank = 64;     // largest padded pool rank taken
constexpr int kMaxProj = 3;      // projections of one x per launch
constexpr int kLanes = 8;        // rank lanes per phase-1 thread
constexpr int kQuad = 4;         // rows per phase-1 thread
// (row quad, projection, 8 lanes) items of phase 1: at most 96, so every
// item has at least two threads and their sums fit kThreads * 32 floats
constexpr int kMaxItems = kRows / kQuad * kMaxProj * (kMaxRank / kLanes);
static_assert(kMaxItems * 2 <= kThreads, "phase 1 gives every item two threads");
constexpr int kRedRow = kQuad * kLanes + 1;        // one thread's sums, padded
constexpr int kRed = kThreads * kRedRow;
constexpr int kRowGroups = kThreads / kCols;       // phase 2: rows t = g + 4i
constexpr int kRowsPerThread = kRows / kRowGroups;

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

struct Proj {
  const void* A;    // (P, k, R)
  const void* B;    // (P, R, n)
  void* out;        // (S, T, n)
  int n;
};

struct LoraArgs {
  const void* x;    // (S, T, k)
  const int* idx;   // (S,)
  Proj p[kMaxProj];
  int n_proj, S, T, k, R, P;
  float scale;
  float* partial;   // (splits, S, T, n_proj * R) f32
  int k_split;      // k per slice, a multiple of 8
  int col_tiles;    // 64-column tiles per phase-2 block
};

// v[0..8) = p[0..n) as f32, zeros past n: one (bf16) or two (f32) 16-byte
// loads when all 8 are there and p is aligned, else one load per value.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int n, float (&v)[8]) {
  if (n == 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    if constexpr (sizeof(T) == 2) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < n ? to_f32(p[i]) : 0.f;
  }
}

// Phase 1: dst[t * ld + pp * R + r] = sum_{k0 <= c < k1} x[t][c] A_pp[c][r]
// for the block's `rows` rows of x (xs, row stride k) and the n_proj
// projections of pool slot `slot`.  A thread owns one item (4 rows, pp, 8
// lanes) and every KT-th group of 8 k; the KT shares of an item are added
// in share order.
template <typename XT, typename FT>
__device__ void xa_tile(const LoraArgs& a, const XT* xs, int rows, int k0, int k1, int slot,
                        float* red, float* dst, int ld) {
  const int k = a.k, R = a.R, np = a.n_proj, tid = threadIdx.x;
  const int chunks = (R + kLanes - 1) / kLanes;
  const int items = (rows + kQuad - 1) / kQuad * np * chunks;
  const int groups = (k1 - k0 + 7) / 8;
  const int KT = min(kThreads / items, groups);   // threads per item
  const int it = tid / KT, kl = tid % KT;
  if (it < items) {
    const int tq = it / (np * chunks), rem = it - tq * np * chunks;
    const int pp = rem / chunks, rc = rem - pp * chunks;
    const int lanes = min(kLanes, R - rc * kLanes);
    const int nr = min(kQuad, rows - tq * kQuad);
    const XT* xr = xs + static_cast<size_t>(tq) * kQuad * k;
    const FT* ap = static_cast<const FT*>(a.p[pp].A) + static_cast<size_t>(slot) * k * R +
                   rc * kLanes;
    float acc[kQuad][kLanes];
#pragma unroll
    for (int i = 0; i < kQuad; ++i)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) acc[i][l] = 0.f;
    for (int g = kl; g < groups; g += KT) {
      const int kk = k0 + 8 * g;
      const int nk = min(8, k1 - kk);
      float xv[kQuad][8];
#pragma unroll
      for (int i = 0; i < kQuad; ++i) load8(xr + static_cast<size_t>(i) * k + kk, i < nr ? nk : 0, xv[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nk) {
          float av[8];
          load8(ap + static_cast<size_t>(kk + j) * R, lanes, av);
#pragma unroll
          for (int i = 0; i < kQuad; ++i)
#pragma unroll
            for (int l = 0; l < kLanes; ++l) acc[i][l] = fmaf(xv[i][j], av[l], acc[i][l]);
        }
      }
    }
    // a thread's 32 sums on a row of 33 floats: a warp's writes hit 32 banks
#pragma unroll
    for (int i = 0; i < kQuad; ++i)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) red[tid * kRedRow + i * kLanes + l] = acc[i][l];
  }
  __syncthreads();
  const int width = np * R;
  for (int e = tid; e < rows * width; e += kThreads) {
    const int t = e / width, j = e - t * width;
    const int pp = j / R, r = j - pp * R;
    const int item = ((t / kQuad) * np + pp) * chunks + r / kLanes;
    const float* share = red + item * KT * kRedRow + (t % kQuad) * kLanes + r % kLanes;
    float sum = 0.f;
    for (int s = 0; s < KT; ++s) sum += share[s * kRedRow];
    dst[static_cast<size_t>(t) * ld + j] = sum;
  }
}

// Phase 2: o[t][c] = scale * sum_r xa[t * ld + r] * B[r][c] for the block's
// rows and columns [c0, c0 + 64) of an (R, n) factor; o is row 0's output.
// B is read 16 rank lanes at a time, the 16 loads in flight together; xa
// comes from shared memory, one broadcast per warp.  (Keeping xa in
// registers instead measured slower: the registers cost more occupancy
// than the shared-memory reads cost.)
template <typename XT, typename FT>
__device__ void xa_times_b(const float* xa, int ld, int rows, const FT* B, int R, int n, int c0,
                           XT* o, float scale) {
  const int col = c0 + threadIdx.x % kCols, rg = threadIdx.x / kCols;
  if (col >= n) return;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int r0 = 0; r0 < R; r0 += 16) {
    float b[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      b[j] = r0 + j < R ? to_f32(B[static_cast<size_t>(r0 + j) * n + col]) : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (r0 + j < R) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i] = fmaf(xa[(rg + kRowGroups * i) * ld + r0 + j], b[j], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = rg + kRowGroups * i;
    if (t < rows) o[static_cast<size_t>(t) * n + col] = from_f32<XT>(scale * acc[i]);
  }
}

// Which projection, and which of its groups of col_tiles 64-column tiles,
// a phase-2 block's blockIdx.x names.
__device__ __forceinline__ void find_tile(const LoraArgs& a, int& pp, int& c0) {
  const int cols = kCols * a.col_tiles;
  int b = blockIdx.x;
  for (pp = 0; pp < a.n_proj - 1; ++pp) {
    const int groups = (a.p[pp].n + cols - 1) / cols;
    if (b < groups) break;
    b -= groups;
  }
  c0 = b * cols;
}

template <typename XT>
__device__ void write_zeros(XT* o, int rows, int n, int c0, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int t = e / cols, col = c0 + e - t * cols;
    if (col < n) o[static_cast<size_t>(t) * n + col] = from_f32<XT>(0.f);
  }
}

// phase 1: grid (splits, ceil(T / 16), S); slice blockIdx.x of k
template <typename XT, typename FT>
__global__ void __launch_bounds__(kThreads) grouped_lora_xa_kernel(LoraArgs a) {
  __shared__ float red[kRed];
  const int s = blockIdx.z, t0 = blockIdx.y * kRows, rows = min(kRows, a.T - t0);
  const int slot = a.idx[s];
  if (slot < 0) return;                       // phase 2 writes the zeros
  if (slot >= a.P) __trap();                  // a slot past the pool: fault
  const int k0 = blockIdx.x * a.k_split, k1 = min(a.k, k0 + a.k_split);
  const int width = a.n_proj * a.R;
  const XT* xs = static_cast<const XT*>(a.x) + (static_cast<size_t>(s) * a.T + t0) * a.k;
  xa_tile<XT, FT>(a, xs, rows, k0, k1, slot, red,
                  a.partial + ((static_cast<size_t>(blockIdx.x) * a.S + s) * a.T + t0) * width,
                  width);
}

// phase 2: grid (groups of col_tiles 64-column tiles of every projection,
// ceil(T / 16), S); splits = gridDim.x of phase 1
template <typename XT, typename FT>
__global__ void __launch_bounds__(kThreads) grouped_lora_xb_kernel(LoraArgs a, int splits) {
  __shared__ float xa[kRows * kMaxRank];
  int pp, c0;
  find_tile(a, pp, c0);
  const int s = blockIdx.z, t0 = blockIdx.y * kRows, rows = min(kRows, a.T - t0);
  const Proj& pj = a.p[pp];
  XT* o = static_cast<XT*>(pj.out) + (static_cast<size_t>(s) * a.T + t0) * pj.n;
  const int slot = a.idx[s];
  if (slot < 0) {                             // no adapter: exact zeros
    write_zeros(o, rows, pj.n, c0, kCols * a.col_tiles);
    return;
  }
  if (slot >= a.P) __trap();
  const int R = a.R, width = a.n_proj * R;
  const size_t stride = static_cast<size_t>(a.S) * a.T * width;       // one split
  const float* src = a.partial + (static_cast<size_t>(s) * a.T + t0) * width + pp * R;
  for (int e = threadIdx.x; e < rows * R; e += kThreads) {
    const int t = e / R, r = e - t * R;
    float sum = 0.f;
#pragma unroll 8
    for (int ks = 0; ks < splits; ++ks) sum += src[ks * stride + static_cast<size_t>(t) * width + r];
    xa[e] = sum;
  }
  __syncthreads();
  const FT* B = static_cast<const FT*>(pj.B) + static_cast<size_t>(slot) * R * pj.n;
  for (int i = 0; i < a.col_tiles; ++i)
    xa_times_b<XT, FT>(xa, R, rows, B, R, pj.n, c0 + i * kCols, o, a.scale);
}

int col_blocks(const LoraArgs& a) {
  const int cols = kCols * a.col_tiles;
  int blocks = 0;
  for (int i = 0; i < a.n_proj; ++i) blocks += (a.p[i].n + cols - 1) / cols;
  return blocks;
}

template <typename XT, typename FT>
int launch(const LoraArgs& a, int splits, cudaStream_t stream) {
  const int row_tiles = (a.T + kRows - 1) / kRows;
  grouped_lora_xa_kernel<XT, FT><<<dim3(splits, row_tiles, a.S), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_lora_xb_kernel<XT, FT>
      <<<dim3(col_blocks(a), row_tiles, a.S), kThreads, 0, stream>>>(a, splits);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadArgs = -1;

}  // namespace

extern "C" {

// x (S, T, k) and up to three projections i < n_proj of it, each with
// factors A_i (P, k, R), B_i (P, R, n_i) and output out_i (S, T, n_i).
// dtype codes: 0 = float32, 1 = bfloat16, for x (and the outputs) and for
// the factors.  Phase 1 sums `splits` slices of `k_split` of k into
// `partial` (splits, S, T, n_proj * R) f32; phase 2 takes `col_tiles`
// 64-column tiles per block.  Returns the cudaError_t of the launches (0
// on success) or -1 for arguments it does not take.
int grouped_lora_launch(const void* x, const void* idx, const void* A0, const void* B0,
                        void* out0, int n0, const void* A1, const void* B1, void* out1, int n1,
                        const void* A2, const void* B2, void* out2, int n2, int n_proj, int S,
                        int T, int k, int R, int P, int x_dtype, int f_dtype, float scale,
                        void* partial, int splits, int k_split, int col_tiles, void* stream) {
  if (R < 1 || R > kMaxRank || n_proj < 1 || n_proj > kMaxProj) return kBadArgs;
  if (splits < 1 || k_split < 8 || k_split % 8 || static_cast<long long>(splits) * k_split < k ||
      static_cast<long long>(splits - 1) * k_split >= k || col_tiles < 1 || partial == nullptr)
    return kBadArgs;
  if (x_dtype < kF32 || x_dtype > kBF16 || f_dtype < kF32 || f_dtype > kBF16) return kBadArgs;
  const LoraArgs a{x, static_cast<const int*>(idx),
                   {{A0, B0, out0, n0}, {A1, B1, out1, n1}, {A2, B2, out2, n2}},
                   n_proj, S, T, k, R, P, scale, static_cast<float*>(partial), k_split,
                   col_tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + f_dtype) {
    case kF32 * 2 + kF32: return launch<float, float>(a, splits, st);
    case kF32 * 2 + kBF16: return launch<float, __nv_bfloat16>(a, splits, st);
    case kBF16 * 2 + kF32: return launch<__nv_bfloat16, float>(a, splits, st);
    case kBF16 * 2 + kBF16: return launch<__nv_bfloat16, __nv_bfloat16>(a, splits, st);
    default: return kBadArgs;
  }
}

int grouped_lora_max_rank() { return kMaxRank; }

const char* grouped_lora_error_string(int code) {
  if (code == kBadArgs) return "unsupported dtype pair, rank, projection count or split plan";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Paged flash attention for Hopper (sm_90a): decode, chunked prefill and
// speculative verify.
//
// Replaces the TPU Pallas kernels of the JAX package:
//   paged_decode_kernel  <- kernels/paged_attention/paged_attention.py::paged_decode_fwd
//                           (_decode_kernel)
//   paged_prefill_kernel <- kernels/paged_attention/paged_attention.py::paged_prefill_fwd
//                           (_prefill_kernel)
//   paged_verify_kernel  <- kernels/paged_attention/paged_attention.py::paged_verify_fwd
//                           (_verify_kernel)
//
// KV lives in one global block pool (N, bs, Hk, d) addressed through block
// tables.  Both kernels read K/V block by block through the table with an
// online softmax, so no page buffer is ever written to device memory, and
// skip every block past the keys a row may attend.  int8 KV is dequantized
// by a plain cast while it is staged into shared memory.
//
// What bounds them on the card: bytes.  Decode does 4 flops per K/V element
// it reads (G rows), far below the ~295 flop/byte the H100 needs before its
// tensor cores become the limit; it must read sum_s (pos[s]+1)*Hk*d*2*kv_bytes
// per layer.  Prefill at chunk C reuses each K/V element C*G times and is
// closer to balanced, but this first version does its arithmetic in f32 on
// the CUDA cores.  Verify is prefill per slot: Q = k+1 queries (or a whole
// bucketed-admission chunk) at pos[s] .. pos[s]+Q-1 over the slot's table.
// The design keeps everything simple and right: one thread block per (slot,
// KV head) for decode and per (KV head, tile of 16 query rows[, slot]) for
// prefill and verify; the block loops over its own KV blocks in order (the
// TPU's sequential grid axis), carrying the running max, sum and f32
// accumulator in shared memory.  wgmma, TMA, vectorised loads and split-KV
// are left for later work.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (see ../../build.py and ../ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's mask value
constexpr int kThreads = 128;       // four warps per block
constexpr int kPrefillRows = 16;    // query rows (c, g) per prefill block

enum DTypeCode { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(int rows, int d, int bs) {
  // q, acc: rows x d; K, V: bs x d; scores: rows x bs; m, l, alpha: rows
  return sizeof(float) * (2 * static_cast<size_t>(rows) * d +
                          2 * static_cast<size_t>(bs) * d +
                          static_cast<size_t>(rows) * bs + 3 * static_cast<size_t>(rows));
}

// One thread block attends `n_rows` query rows against one KV head `h`.
// Local row r is global row R = row0 + r of the (C|S, Hk, G, d) query
// tensor read as rows R = c * G + g (the grouped heads interleaved, as the
// reference's prefill kernel lays them out).  Row R sits at absolute
// position qpos0 + qpos_stride * c and attends key k iff k <= q_pos and
// k < key_end.  The block walks table[0 .. n_kv_blocks) in order.
template <typename QT, typename KT>
__device__ void attend_rows(const QT* __restrict__ q, const KT* __restrict__ ck,
                            const KT* __restrict__ cv, const int* __restrict__ table,
                            QT* __restrict__ out, int row0, int n_rows, int G, int Hk,
                            int h, int d, int bs, int n_kv_blocks, int qpos0,
                            int qpos_stride, int key_end, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                   // n_rows x d
  float* acc = q_s + n_rows * d;       // n_rows x d
  float* k_s = acc + n_rows * d;       // bs x d
  float* v_s = k_s + bs * d;           // bs x d
  float* p_s = v_s + bs * d;           // n_rows x bs (scores, then probs)
  float* m_s = p_s + n_rows * bs;      // n_rows running max
  float* l_s = m_s + n_rows;           // n_rows running sum
  float* a_s = l_s + n_rows;           // n_rows rescale factor of this block

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int e = tid; e < n_rows * d; e += blockDim.x) {
    const int r = e / d, j = e - r * d;
    const int R = row0 + r, c = R / G, g = R - c * G;
    q_s[e] = to_f32(q[(static_cast<size_t>(c * Hk + h) * G + g) * d + j]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < n_rows; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int i = 0; i < n_kv_blocks; ++i) {
    // stage this KV block of head h as f32 (int8 dequantizes here)
    const size_t base = static_cast<size_t>(table[i]) * bs;
    for (int e = tid; e < bs * d; e += blockDim.x) {
      const int t = e / d, j = e - t * d;
      const size_t src = ((base + t) * Hk + h) * d + j;
      k_s[e] = to_f32(ck[src]);
      v_s[e] = to_f32(cv[src]);
    }
    __syncthreads();

    // scores: one warp per (row, key) pair, lanes across the head dim
    for (int pr = warp; pr < n_rows * bs; pr += n_warps) {
      const int r = pr / bs, t = pr - r * bs;
      float s = 0.f;
      for (int j = lane; j < d; j += 32) s += q_s[r * d + j] * k_s[t * d + j];
      s = warp_sum(s);
      if (lane == 0) {
        const int c = (row0 + r) / G;
        const int q_pos = qpos0 + qpos_stride * c;
        const int k_pos = i * bs + t;
        p_s[pr] = (k_pos <= q_pos && k_pos < key_end) ? s * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < n_rows; r += n_warps) {
      const int c = (row0 + r) / G;
      const int q_pos = qpos0 + qpos_stride * c;
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, p_s[r * bs + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float psum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const int k_pos = i * bs + t;
        const bool live = k_pos <= q_pos && k_pos < key_end;
        const float p = live ? expf(p_s[r * bs + t] - m_new) : 0.f;
        p_s[r * bs + t] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
    for (int e = tid; e < n_rows * d; e += blockDim.x) {
      const int r = e / d, j = e - r * d;
      float a = acc[e] * a_s[r];
      for (int t = 0; t < bs; ++t) a += p_s[r * bs + t] * v_s[t * d + j];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < n_rows * d; e += blockDim.x) {
    const int r = e / d, j = e - r * d;
    const int R = row0 + r, c = R / G, g = R - c * G;
    out[(static_cast<size_t>(c * Hk + h) * G + g) * d + j] =
        from_f32<QT>(acc[e] / fmaxf(l_s[r], 1e-30f));
  }
}

// grid (Hk, S): slot s's G grouped query heads of KV head h attend keys
// [0, pos[s]] through block table s; blocks past the cursor are skipped.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ ck,
                    const KT* __restrict__ cv, const int* __restrict__ block_tables,
                    const int* __restrict__ pos, QT* __restrict__ out, int Hk, int G,
                    int d, int bs, int nb, float scale) {
  const int h = blockIdx.x, s = blockIdx.y;
  const int p = pos[s];
  const int n_blk = min(nb, p / bs + 1);
  attend_rows<QT, KT>(q, ck, cv, block_tables + static_cast<size_t>(s) * nb, out, s * G, G, G,
                      Hk, h, d, bs, n_blk, p, 0, p + 1, scale);
}

// grid (Hk, ceil(C*G / 16)): a tile of 16 chunk rows (c, g) of KV head h;
// row (c, g) sits at start + c and attends keys k <= start + c with
// k < start + valid.  The tile stops at the last block any of its rows
// may attend.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const QT* __restrict__ q, const KT* __restrict__ ck,
                     const KT* __restrict__ cv, const int* __restrict__ table,
                     QT* __restrict__ out, int C, int Hk, int G, int d, int bs, int nb,
                     int start, int valid, float scale) {
  const int h = blockIdx.x;
  const int row0 = blockIdx.y * kPrefillRows;
  const int n_rows = min(kPrefillRows, C * G - row0);
  const int key_end = start + valid;
  const int last_qpos = start + (row0 + n_rows - 1) / G;
  const int key_lim = min(key_end, last_qpos + 1);
  const int n_blk = min(nb, (key_lim + bs - 1) / bs);
  attend_rows<QT, KT>(q, ck, cv, table, out, row0, n_rows, G, Hk, h, d, bs, n_blk, start, 1,
                      key_end, scale);
}

// grid (Hk, ceil(Q*G / 16), S): a tile of 16 rows (i, g) of slot s and KV
// head h; query i sits at pos[s] + i and attends keys k <= pos[s] + i.  The
// tile stops at the last block its last row may attend, and never walks
// past the table: padding rows of a bucketed chunk's tail can sit beyond
// the table's nb*bs positions (they then attend every key of the table,
// as the reference does, and their outputs are not used).
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const QT* __restrict__ q, const KT* __restrict__ ck,
                    const KT* __restrict__ cv, const int* __restrict__ block_tables,
                    const int* __restrict__ pos, QT* __restrict__ out, int Q, int Hk, int G,
                    int d, int bs, int nb, float scale) {
  const int h = blockIdx.x;
  const int row0 = blockIdx.y * kPrefillRows;
  const int s = blockIdx.z;
  const int n_rows = min(kPrefillRows, Q * G - row0);
  const int p = pos[s];
  const int last_qpos = p + (row0 + n_rows - 1) / G;
  const int n_blk = min(nb, last_qpos / bs + 1);
  const size_t slot_off = static_cast<size_t>(s) * Q * Hk * G * d;
  attend_rows<QT, KT>(q + slot_off, ck, cv, block_tables + static_cast<size_t>(s) * nb,
                      out + slot_off, row0, n_rows, G, Hk, h, d, bs, n_blk, p, 1, p + Q,
                      scale);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename QT, typename KT>
int launch_decode(const void* q, const void* ck, const void* cv, const void* bt,
                  const void* pos, void* out, int S, int Hk, int G, int d, int bs, int nb,
                  float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, d, bs);
  auto kernel = paged_decode_kernel<QT, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(Hk, S), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(ck), static_cast<const KT*>(cv),
      static_cast<const int*>(bt), static_cast<const int*>(pos), static_cast<QT*>(out), Hk, G,
      d, bs, nb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_prefill(const void* q, const void* ck, const void* cv, const void* table,
                   void* out, int C, int Hk, int G, int d, int bs, int nb, int start,
                   int valid, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(kPrefillRows, d, bs);
  auto kernel = paged_prefill_kernel<QT, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (C * G + kPrefillRows - 1) / kPrefillRows;
  kernel<<<dim3(Hk, tiles), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(ck), static_cast<const KT*>(cv),
      static_cast<const int*>(table), static_cast<QT*>(out), C, Hk, G, d, bs, nb, start, valid,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_verify(const void* q, const void* ck, const void* cv, const void* bt,
                  const void* pos, void* out, int S, int Q, int Hk, int G, int d, int bs,
                  int nb, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(kPrefillRows, d, bs);
  auto kernel = paged_verify_kernel<QT, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (Q * G + kPrefillRows - 1) / kPrefillRows;
  kernel<<<dim3(Hk, tiles, S), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(ck), static_cast<const KT*>(cv),
      static_cast<const int*>(bt), static_cast<const int*>(pos), static_cast<QT*>(out), Q, Hk,
      G, d, bs, nb, scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadDType = -1;

}  // namespace

#define PA_DISPATCH(LAUNCH, ...)                                               \
  switch (q_dtype * 3 + kv_dtype) {                                            \
    case kF32 * 3 + kF32: return LAUNCH<float, float>(__VA_ARGS__);            \
    case kF32 * 3 + kBF16: return LAUNCH<float, __nv_bfloat16>(__VA_ARGS__);   \
    case kF32 * 3 + kI8: return LAUNCH<float, int8_t>(__VA_ARGS__);            \
    case kBF16 * 3 + kF32: return LAUNCH<__nv_bfloat16, float>(__VA_ARGS__);   \
    case kBF16 * 3 + kBF16:                                                    \
      return LAUNCH<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);                \
    case kBF16 * 3 + kI8: return LAUNCH<__nv_bfloat16, int8_t>(__VA_ARGS__);   \
    default: return kBadDType;                                                 \
  }

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (KV only).  Returns the
// cudaError_t of the launch (0 on success) or -1 for an unsupported pair.
int paged_decode_launch(const void* q, const void* cache_k, const void* cache_v,
                        const void* block_tables, const void* pos, void* out, int S, int Hk,
                        int G, int d, int bs, int nb, int q_dtype, int kv_dtype, float scale,
                        void* stream) {
  if (q_dtype < kF32 || q_dtype > kBF16 || kv_dtype < kF32 || kv_dtype > kI8) return kBadDType;
  PA_DISPATCH(launch_decode, q, cache_k, cache_v, block_tables, pos, out, S, Hk, G, d, bs, nb,
              scale, static_cast<cudaStream_t>(stream))
}

int paged_prefill_launch(const void* q, const void* cache_k, const void* cache_v,
                         const void* block_table, void* out, int C, int Hk, int G, int d, int bs,
                         int nb, int start, int valid, int q_dtype, int kv_dtype, float scale,
                         void* stream) {
  if (q_dtype < kF32 || q_dtype > kBF16 || kv_dtype < kF32 || kv_dtype > kI8) return kBadDType;
  PA_DISPATCH(launch_prefill, q, cache_k, cache_v, block_table, out, C, Hk, G, d, bs, nb, start,
              valid, scale, static_cast<cudaStream_t>(stream))
}

int paged_verify_launch(const void* q, const void* cache_k, const void* cache_v,
                        const void* block_tables, const void* pos, void* out, int S, int Q,
                        int Hk, int G, int d, int bs, int nb, int q_dtype, int kv_dtype,
                        float scale, void* stream) {
  if (q_dtype < kF32 || q_dtype > kBF16 || kv_dtype < kF32 || kv_dtype > kI8) return kBadDType;
  PA_DISPATCH(launch_verify, q, cache_k, cache_v, block_tables, pos, out, S, Q, Hk, G, d, bs, nb,
              scale, static_cast<cudaStream_t>(stream))
}

// Bytes of dynamic shared memory a launch asks for (the wrapper checks it
// against the card's 227 KB per block before launching).
long long paged_smem_bytes(int rows, int d, int bs) {
  return static_cast<long long>(smem_bytes(rows, d, bs));
}

int paged_prefill_rows() { return kPrefillRows; }

const char* paged_error_string(int code) {
  if (code == kBadDType) return "unsupported (q, kv) dtype pair";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

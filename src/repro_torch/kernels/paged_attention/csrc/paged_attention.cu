// Paged flash attention for Hopper (sm_90a): decode, chunked prefill and
// speculative verify.
//
// Replaces the TPU Pallas kernels of the JAX package:
//   paged_decode_split_kernel, <- kernels/paged_attention/paged_attention.py::paged_decode_fwd
//   paged_decode_combine_kernel   (_decode_kernel)
//   paged_prefill_mma_kernel, <- kernels/paged_attention/paged_attention.py::paged_prefill_fwd
//   paged_prefill_kernel          (_prefill_kernel)
//   paged_verify_mma_kernel, <- kernels/paged_attention/paged_attention.py::paged_verify_fwd
//   paged_verify_kernel         (_verify_kernel)
//
// KV lives in one global block pool (N, bs, Hk, d) addressed through block
// tables.  Every kernel reads K/V block by block through the table with an
// online softmax, so no page buffer is ever written to device memory, and
// skips every block past the keys a row may attend.  int8 KV is dequantized
// by a plain cast while it is staged into shared memory.
//
// What bounds them on the card: bytes.  Decode does 4 flops per K/V element
// it reads (G rows), far below the ~295 flop/byte the H100 needs before its
// tensor cores become the limit; it must read sum_s (pos[s]+1)*Hk*d*2*kv_bytes
// per layer.  Prefill and verify are one function: Q queries of a slot (a
// prompt chunk, the k+1 speculative candidates, or a bucketed-admission
// chunk) at p .. p+Q-1 over the slot's table, attending keys k <= its
// position and k < key_end (prefill: start + valid; verify: no limit past
// the causal one).  At llama2-7b's main-path shapes they are bound by bytes
// too: 0.0038 ms for a 256-row prefill chunk at start 256, 0.0071 ms for the
// speculative pass's 4 slots x 5 queries at cursors 540-552, 0.0063 and
// 0.0113 ms for bucketed admission's 4 x 256-row chunks at cursors 0 and 256
// (each distinct K/V byte once at 3.35 TB/s).
//
// Three bodies:
// * decode_split (K1; see its section below): split-KV ("flash-decoding").
//   One block walks one split of a slot's keys for one KV head in 16-byte
//   loads, a few keys in flight per lane, f32 on the CUDA cores, and writes
//   an f32 partial (max, sum, accumulator); a second kernel combines the
//   splits in split order.  At S = 4, Hk = 32 that is 512 blocks where one
//   block per (slot, head) made 128, each walking ~35 KV blocks in turn.
// * attend_rows (K2 and K3 for f32 q or f32 KV or a head dim the
//   tensor-core body does not take): one thread block per (KV head, tile
//   of 16 query rows[, slot]); the block loops over its KV blocks in order
//   (the TPU's sequential grid axis), carrying the running max, sum and f32
//   accumulator in shared memory, all arithmetic f32 on the CUDA cores.
//   f32 q stays exact in f32 there.
// * attend_mma (K2 and K3 for bf16 q with bf16 or int8 KV, d a multiple of
//   16 up to 128; see its section below): FlashAttention-2 on mma.sync,
//   64-key tiles by cp.async, double-buffered, P.V as P_hi.V + P_lo.V so
//   that every comparison stays inside kernel_tolerance; a chunk puts 64
//   rows in a block (four warps sharing each tile), a slot whose rows fit
//   one 16-row tile (the speculative verify, a short chunk) splits each
//   tile's keys over the four warps.  mma.sync and not wgmma: the work is
//   bound by bytes, and P stays in registers between the two products, as
//   FA2 needs.  paged_prefill_mma_kernel and paged_verify_mma_kernel are
//   its two entry points (two names, so that a profile tells them apart).
//
// Not yet: TMA (and multicast of a shared prefix across a slot's blocks), a
// persistent grid, split-KV in K3 (the speculative verify runs one block
// per (slot, head): 128 blocks at S = 4, Hk = 32), reading a prefix block
// that several slots share once for all of them in K1, and tensor cores in
// K1 for large G.
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

// ---------------------------------------------------------------------------
// K2 and K3 on the tensor cores: attend_mma
// ---------------------------------------------------------------------------
//
// FlashAttention-2 on mma.sync.m16n8k16 (bf16 in, f32 accumulate) for bf16
// q with bf16 or int8 KV and d a multiple of 16 up to 128.  Each warp owns
// 16 of the slot's Q*G rows (R = c*G + g), its q fragments in registers for
// the whole loop; row R sits at p + R / G and attends keys k <= p + R / G
// with k < key_end.  KV comes in tiles of 64 keys read through the slot's
// table (any bs), staged by cp.async and double-buffered; int8 K and V land
// raw and are converted to bf16 in shared memory (exact).  S = Q.K^T and the
// online softmax stay in f32 registers; P.V runs as two MMAs, on P_hi =
// bf16(P) and P_lo = bf16(P - P_hi), so P keeps ~16 bits: a single bf16 P
// moves the output by several times kernel_tolerance (see
// tests/test_torch_kernel_numerics.py).  Every product of bf16 operands is
// exact in f32, so the rest differs from the plain version by f32 sum order.
//
// KS = 1 (a chunk): four warps own 64 rows and share each tile.
// KS = 4 (Q*G <= 16: the speculative verify, a short chunk): one 16-row
// tile, the four warps take keys [16w, 16w + 16) of each tile and merge
// their (m, l, acc) in shared memory in warp order at the end
// (deterministic).
//
// Padding rows of a chunk (c >= valid, or past the table) attend every key
// below the limit, as the reference's do; each has key 0 at least, so its
// output stays finite, and it is not used.
constexpr int kTileKeys = 64;

// What one launch of attend_mma computes: slot s's Q*G rows of q (S, Q, Hk,
// G, D) at p .. p+Q-1 through table s.  Verify: p = pos[s], and key_end =
// p + Q puts no limit past the causal one.  Prefill: S = 1, pos = nullptr,
// p = start and key_end = start + valid.
struct MmaArgs {
  const __nv_bfloat16* q;
  const void* ck;
  const void* cv;
  const int* tables;    // (S, nb)
  const int* pos;       // (S,) cursors, or nullptr for a prefill chunk
  __nv_bfloat16* out;
  int Q, Hk, G, bs, nb;
  int start, valid;     // the prefill chunk's span (pos == nullptr)
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;       // 0 source bytes: zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
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

// Dynamic shared memory of attend_mma.  bf16 KV: two stages
// of K and V tiles, rows padded to d + 8 (16 bytes) so that fragment reads
// hit distinct banks.  int8 KV: two stages of raw K and V tiles, then one
// bf16 K and V tile converted from them.  KS = 4 reuses it to merge.
size_t verify_mma_smem(int d, bool int8_kv) {
  const size_t tile = static_cast<size_t>(kTileKeys) * (d + 8) * 2;
  const size_t merge = 4 * 16 * static_cast<size_t>(d + 2) * sizeof(float);
  const size_t main =
      int8_kv ? 2 * 2 * static_cast<size_t>(kTileKeys) * d + 2 * tile : 2 * 2 * tile;
  return main > merge ? main : merge;
}

// grid (Hk, ceil(Q*G / (64 / KS)), S), 128 threads
template <int D, int KS, typename KT>
__device__ __forceinline__ void attend_mma(const MmaArgs& a) {
  constexpr int RW = 4 / KS;               // row warps
  constexpr int KW = kTileKeys / KS;       // keys of a tile per warp
  constexpr int NT = KW / 8;               // n8 tiles of S
  constexpr int DK = D / 16;               // k16 steps of Q.K^T
  constexpr int DN = D / 8;                // n8 tiles of the output
  constexpr int LD = D + 8;                // bf16 per staged row
  constexpr int CH = D / 8;                // 16-byte bf16 chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const __nv_bfloat16* __restrict__ q = a.q;
  const KT* __restrict__ ck = static_cast<const KT*>(a.ck);
  const KT* __restrict__ cv = static_cast<const KT*>(a.cv);
  __nv_bfloat16* __restrict__ out = a.out;
  const int Q = a.Q, Hk = a.Hk, G = a.G, bs = a.bs, nb = a.nb;
  const float scale = a.scale;
  const int h = blockIdx.x, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = warp % RW, ks = warp / RW;
  const int QG = Q * G;
  const int row_base = blockIdx.y * 16 * RW;
  const int p = a.pos ? a.pos[s] : a.start;
  const int key_end = a.pos ? p + Q : a.start + a.valid;
  const int* table = a.tables + static_cast<size_t>(s) * nb;
  // keys at or past L are masked for every row: the key limit, and never
  // past the table (padding rows past it attend the whole table)
  const int L = min(nb * bs, key_end);
  // every warp walks the same tiles: up to the block's last row's limit
  const int last_row = min(QG, row_base + 16 * RW) - 1;
  const int n_keys = min(p + last_row / G + 1, L);
  const int n_tiles = (n_keys + kTileKeys - 1) / kTileKeys;
  const size_t slot_off = static_cast<size_t>(s) * Q * Hk * G * D;

  // this thread's two rows, their positions, and their q fragments
  const int r_lo = row_base + 16 * rt + lane / 4, r_hi = r_lo + 8;
  const int qpos_lo = p + r_lo / G, qpos_hi = p + r_hi / G;
  auto q_row = [&](int R) -> const __nv_bfloat16* {
    const int c = R / G, g = R - c * G;
    return q + slot_off + (static_cast<size_t>(c * Hk + h) * G + g) * D;
  };
  const __nv_bfloat16* q_lo = r_lo < QG ? q_row(r_lo) : nullptr;
  const __nv_bfloat16* q_hi = r_hi < QG ? q_row(r_hi) : nullptr;
  auto ld2 = [](const __nv_bfloat16* row, int col) -> uint32_t {
    return row ? *reinterpret_cast<const uint32_t*>(row + col) : 0u;
  };
  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const int col = kk * 16 + 2 * (lane % 4);
    qa[kk][0] = ld2(q_lo, col);
    qa[kk][1] = ld2(q_hi, col);
    qa[kk][2] = ld2(q_lo, col + 8);
    qa[kk][3] = ld2(q_hi, col + 8);
  }

  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  // staging: key t of tile j sits at position j*64 + t, block table[pos/bs]
  constexpr bool kInt8 = sizeof(KT) == 1;
  constexpr size_t kTileBf16 = static_cast<size_t>(kTileKeys) * LD;   // elements
  constexpr size_t kRaw = static_cast<size_t>(kTileKeys) * D;         // int8 bytes
  auto stage_ptr = [&](int stage, int which) -> unsigned char* {
    if constexpr (kInt8) return smem_raw + (stage * 2 + which) * kRaw;
    return smem_raw + (stage * 2 + which) * kTileBf16 * 2;
  };
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(smem_raw + 4 * kRaw);  // int8 only
  auto load_tile = [&](int j, int stage) {
    constexpr int per_row = kInt8 ? D / 16 : CH;     // 16-byte chunks per key row
    for (int c = tid; c < 2 * kTileKeys * per_row; c += kThreads) {
      const int which = c / (kTileKeys * per_row);
      const int e = c - which * kTileKeys * per_row;
      const int t = e / per_row, part = e - t * per_row;
      const int kp = j * kTileKeys + t;
      const bool ok = kp < n_keys;
      const KT* base = which ? cv : ck;
      const KT* src = base;
      if (ok)
        src = base + ((static_cast<size_t>(table[kp / bs]) * bs + kp % bs) * Hk + h) * D +
              part * (16 / sizeof(KT));
      unsigned char* dst = stage_ptr(stage, which);
      if constexpr (kInt8)
        cp_async16(dst + t * D + part * 16, src, ok);
      else
        cp_async16(dst + (t * LD + part * 8) * 2, src, ok);
    }
  };

  load_tile(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(j + 1, stage ^ 1);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* Ks;
    const __nv_bfloat16* Vs;
    if constexpr (kInt8) {
      // raw int8 -> bf16 (exact), 8 values per step
      for (int e = tid; e < 2 * kTileKeys * CH; e += kThreads) {
        const int which = e / (kTileKeys * CH);
        const int f = e - which * kTileKeys * CH;
        const int t = f / CH, part = f - t * CH;
        const uint2 raw =
            *reinterpret_cast<const uint2*>(stage_ptr(stage, which) + t * D + part * 8);
        const uint32_t w[2] = {raw.x, raw.y};
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t word = w[i / 2];
          const int b = (i % 2) * 2;
          o[i] = pack_bf16(static_cast<float>(static_cast<int8_t>((word >> (8 * b)) & 0xffu)),
                           static_cast<float>(static_cast<int8_t>((word >> (8 * b + 8)) & 0xffu)));
        }
        *reinterpret_cast<uint4*>(conv + which * kTileBf16 + t * LD + part * 8) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
      __syncthreads();
      Ks = conv;
      Vs = conv + kTileBf16;
    } else {
      Ks = reinterpret_cast<const __nv_bfloat16*>(stage_ptr(stage, 0));
      Vs = reinterpret_cast<const __nv_bfloat16*>(stage_ptr(stage, 1));
    }

    // S = Q.K^T over this warp's KW keys of the tile
    const int key0 = ks * KW;
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (key0 + nt * 8 + lane / 4) * LD + 2 * (lane % 4);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(sc[nt], qa[kk], b0, b1);
      }
    }
    // mask (k <= q_pos of the row, k below the limit), scale, online softmax
    const int kbase = j * kTileKeys + key0 + 2 * (lane % 4);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = kbase + nt * 8 + (i & 1);
        const bool live = kp <= (i < 2 ? qpos_lo : qpos_hi) && kp < L;
        sc[nt][i] = live ? sc[nt][i] * scale : kNegInf;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(sc[nt][0], sc[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = kbase + nt * 8 + (i & 1);
        const bool live = kp <= (i < 2 ? qpos_lo : qpos_hi) && kp < L;
        const float pr = live ? expf(sc[nt][i] - (i < 2 ? mn_lo : mn_hi)) : 0.f;
        sc[nt][i] = pr;
        if (i < 2) ps_lo += pr; else ps_hi += pr;
      }
    }
    l_lo = l_lo * al_lo + ps_lo;        // this thread's columns; the quad adds at the end
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
    for (int kt = 0; kt < KW / 16; ++kt) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* pv = sc[2 * kt + i / 2] + 2 * (i % 2);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(pv[0], pv[1]);
        ah[i] = *reinterpret_cast<const uint32_t*>(&hi);
        al[i] = pack_bf16(pv[0] - __low2float(hi), pv[1] - __high2float(hi));
      }
      // V fragments by ldmatrix.trans: matrices (keys 0-7 | 8-15) x (d tile dn | dn+1)
      const int mat = lane / 8;
      const __nv_bfloat16* vrow =
          Vs + (key0 + kt * 16 + (lane % 8) + (mat & 1) * 8) * LD + (mat >> 1) * 8;
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t b[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
            : "r"(smem_u32(vrow + dn * 8)));
        mma_bf16(acc[dn], ah, b[0], b[1]);
        mma_bf16(acc[dn], al, b[0], b[1]);
        mma_bf16(acc[dn + 1], ah, b[2], b[3]);
        mma_bf16(acc[dn + 1], al, b[2], b[3]);
      }
    }
    __syncthreads();                    // the stage is free for tile j + 2
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
  }
  auto out_row = [&](int R) -> __nv_bfloat16* {
    const int c = R / G, g = R - c * G;
    return out + slot_off + (static_cast<size_t>(c * Hk + h) * G + g) * D;
  };
  if constexpr (KS == 1) {
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int col = dn * 8 + 2 * (lane % 4);
      if (r_lo < QG)
        *reinterpret_cast<__nv_bfloat162*>(out_row(r_lo) + col) = __floats2bfloat162_rn(
            acc[dn][0] / fmaxf(l_lo, 1e-30f), acc[dn][1] / fmaxf(l_lo, 1e-30f));
      if (r_hi < QG)
        *reinterpret_cast<__nv_bfloat162*>(out_row(r_hi) + col) = __floats2bfloat162_rn(
            acc[dn][2] / fmaxf(l_hi, 1e-30f), acc[dn][3] / fmaxf(l_hi, 1e-30f));
    }
  } else {
    // the four key splits meet in shared memory (the loop ended on a
    // barrier, so the stages are free) and merge in warp order
    float* mbuf = reinterpret_cast<float*>(smem_raw);   // [4][16] max
    float* lbuf = mbuf + 4 * 16;                        // [4][16] sum
    float* abuf = lbuf + 4 * 16;                        // [4][16][D] acc
    const int lr = lane / 4;
    if (lane % 4 == 0) {
      mbuf[warp * 16 + lr] = m_lo;
      mbuf[warp * 16 + lr + 8] = m_hi;
      lbuf[warp * 16 + lr] = l_lo;
      lbuf[warp * 16 + lr + 8] = l_hi;
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int col = dn * 8 + 2 * (lane % 4);
      float* a = abuf + (warp * 16 + lr) * D + col;
      a[0] = acc[dn][0];
      a[1] = acc[dn][1];
      a[8 * D] = acc[dn][2];
      a[8 * D + 1] = acc[dn][3];
    }
    __syncthreads();
    for (int e = tid; e < 16 * D; e += kThreads) {
      const int r = e / D, col = e - r * D;
      const int R = row_base + r;
      if (R >= QG) continue;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < 4; ++w) mx = fmaxf(mx, mbuf[w * 16 + r]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float f = expf(mbuf[w * 16 + r] - mx);
        l += lbuf[w * 16 + r] * f;
        a += abuf[(w * 16 + r) * D + col] * f;
      }
      out_row(R)[col] = __float2bfloat16(a / fmaxf(l, 1e-30f));
    }
  }
}

template <int D, int KS, typename KT>
__global__ void __launch_bounds__(kThreads) paged_verify_mma_kernel(MmaArgs a) {
  attend_mma<D, KS, KT>(a);
}

template <int D, int KS, typename KT>
__global__ void __launch_bounds__(kThreads) paged_prefill_mma_kernel(MmaArgs a) {
  attend_mma<D, KS, KT>(a);
}

// ---------------------------------------------------------------------------
// K1: split-KV decode
// ---------------------------------------------------------------------------
//
// One query token per slot: slot s's G grouped heads of KV head h attend
// keys [0, pos[s]] through block table s.  Bound by bytes: 4*G flops per
// K/V element pair it reads (at most 7 flop/B at qwen2-7b's G = 7, 2 at
// llama2-7b's G = 1), where the f32 CUDA cores sustain ~20 flop/B (67
// TFLOP/s over 3.35 TB/s); so the design is about keeping enough bytes in
// flight, not about the tensor cores (at G = 1 an m16n8k16 tile would use
// one row of 16, and hi/lo P would double the P.V products).
//
// paged_decode_split_kernel, grid (n_splits, Hk * row_groups, S), 128
// threads: split j of slot s covers keys [j*split_keys, (j+1)*split_keys)
// below the cursor (split_keys a multiple of bs, chosen on the host from
// the table's width alone, never from pos: no sync, and a grid a CUDA graph
// can hold).  A split past the cursor returns at once; the combine reads
// only the splits below it.  Inside a split:
// * the split's block ids are staged in shared memory once;
// * a key row is read by LPK lanes (LPK the power of two >= d/8), 8
//   elements, 16 bytes of bf16, per lane: one warp load covers 32/LPK keys
//   (two at d = 128), and each lane issues the K and V loads of U keys
//   before it uses any of them;
// * each lane holds its 8 columns of R query rows in f32 registers; the
//   score of a key is an f32 sum of exact products (bf16 x bf16, int8 and
//   f32 q all exact in f32), reduced over the LPK lanes by shuffles;
// * each lane group (the LPK lanes of one key slot) runs its own online
//   softmax over its keys; the groups of a warp merge by shuffles, the four
//   warps in shared memory in warp order, and the block writes the split's
//   (m, l, acc) in f32.
// paged_decode_combine_kernel, grid (Hk * G, S): M = max_j m_j, out = sum_j
// e^(m_j - M) acc_j / max(sum_j e^(m_j - M) l_j, 1e-30) over the live
// splits in split order, cast to q's dtype.  No atomics anywhere, so a
// repeated call gives the same bits.
constexpr int kDecodeRows = 8;      // query rows of one block (R at most)

struct DecodeArgs {
  const void* q;          // (S, Hk, G, d)
  const void* ck;         // (N, bs, Hk, d)
  const void* cv;
  const int* tables;      // (S, nb)
  const int* pos;         // (S,)
  float* part;            // acc (S, Hk, splits, G, d), then (m, l) (S, Hk, splits, G, 2)
  void* out;              // (S, Hk, G, d)
  int S, Hk, G, d, bs, nb;
  int splits, split_blocks, row_groups, lanes;   // lanes: LPK
  float scale;
};

// 8 consecutive elements of a K or V row, as loaded
template <typename KT> struct Row8;
template <> struct Row8<__nv_bfloat16> { uint4 r; };
template <> struct Row8<int8_t> { uint2 r; };
template <> struct Row8<float> { uint4 a, b; };

__device__ __forceinline__ void load8(Row8<__nv_bfloat16>& x, const __nv_bfloat16* p) {
  x.r = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load8(Row8<int8_t>& x, const int8_t* p) {
  x.r = __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ void load8(Row8<float>& x, const float* p) {
  x.a = __ldg(reinterpret_cast<const uint4*>(p));
  x.b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
}

__device__ __forceinline__ void unpack8(const Row8<__nv_bfloat16>& x, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x.r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack8(const Row8<int8_t>& x, float (&f)[8]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&x.r);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(b[i]);
}
__device__ __forceinline__ void unpack8(const Row8<float>& x, float (&f)[8]) {
  const float* a = reinterpret_cast<const float*>(&x.a);
  const float* b = reinterpret_cast<const float*>(&x.b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = a[i];
    f[4 + i] = b[i];
  }
}

// keys [0, key_lim) of slot s are attended: through its cursor, never past
// the table (at least key 0, so that every row has a key)
__device__ __forceinline__ int decode_key_lim(const DecodeArgs& a, int s) {
  return max(1, min(a.pos[s] + 1, a.nb * a.bs));
}

size_t decode_split_smem(int d, int split_blocks) {
  // four warps' acc (R x d) and (m, l) (R each), then the split's block ids
  return sizeof(float) * 4 * kDecodeRows * (static_cast<size_t>(d) + 2) +
         sizeof(int) * static_cast<size_t>(split_blocks);
}

template <typename QT, typename KT, int R, int U>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) float dsm[];
  const int j = blockIdx.x;
  const int h = blockIdx.y / a.row_groups, g0 = (blockIdx.y - h * a.row_groups) * R;
  const int s = blockIdx.z;
  const int Hk = a.Hk, G = a.G, d = a.d, bs = a.bs;
  const int split_keys = a.split_blocks * bs;
  const int k0 = j * split_keys;
  const int key_lim = decode_key_lim(a, s);
  if (k0 >= key_lim) return;             // past the cursor: the combine skips it
  const int k1 = min(k0 + split_keys, key_lim);
  const int rows = min(R, G - g0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpk = a.lanes, kpr = 32 / lpk;      // lanes per key, keys per warp load
  const int c = lane & (lpk - 1), kg = lane / lpk;
  const bool on = 8 * c < d;                     // lanes past d/8 hold no columns

  float* acc_s = dsm;                            // [4][R][d]
  float* m_s = acc_s + 4 * kDecodeRows * d;      // [4][R]
  float* l_s = m_s + 4 * kDecodeRows;            // [4][R]
  int* blk_s = reinterpret_cast<int*>(l_s + 4 * kDecodeRows);
  const int* table = a.tables + static_cast<size_t>(s) * a.nb + j * a.split_blocks;
  const int n_blk = (k1 - k0 + bs - 1) / bs;
  for (int i = tid; i < n_blk; i += kThreads) blk_s[i] = table[i];

  // this lane's 8 columns of the block's R rows, in f32
  const QT* q = static_cast<const QT*>(a.q) + ((static_cast<size_t>(s) * Hk + h) * G + g0) * d;
  float qr[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[r][e] = (r < rows && on) ? to_f32(q[r * d + 8 * c + e]) : 0.f;

  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();

  const KT* ck = static_cast<const KT*>(a.ck);
  const KT* cv = static_cast<const KT*>(a.cv);
  const int chunk = kpr * U;                     // keys of one warp step
  for (int base = k0 + warp * chunk; base < k1; base += 4 * chunk) {
    Row8<KT> kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kp = base + u * kpr + kg;
      if (kp < k1 && on) {
        const int t = kp - k0;
        const size_t off =
            ((static_cast<size_t>(blk_s[t / bs]) * bs + t % bs) * Hk + h) * d + 8 * c;
        load8(kr[u], ck + off);
        load8(vr[u], cv + off);
      } else {
        kr[u] = Row8<KT>{};
        vr[u] = Row8<KT>{};
      }
    }
    float sc[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(kr[u], kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) t = fmaf(qr[r][e], kf[e], t);
        sc[u][r] = t;
      }
    }
    for (int o = lpk >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r) sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], o);
    // online softmax of this lane group over its U keys
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool live = base + u * kpr + kg < k1;
        sc[u][r] = live ? sc[u][r] * a.scale : kNegInf;
        mx = fmaxf(mx, sc[u][r]);
      }
      const float alpha = expf(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool live = base + u * kpr + kg < k1;
        sc[u][r] = live ? expf(sc[u][r] - mx) : 0.f;
        l[r] += sc[u][r];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      unpack8(vr[u], vf);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(sc[u][r], vf[e], acc[r][e]);
    }
  }

  // the warp's lane groups merge (lanes c, c + lpk, ... hold one column set)
  for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float fa = expf(m[r] - mn), fb = expf(mo - mn);
      l[r] = l[r] * fa + lo * fb;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] = acc[r][e] * fa + __shfl_xor_sync(0xffffffffu, acc[r][e], o) * fb;
      m[r] = mn;
    }
  }
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (on && r < rows)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc_s[(warp * kDecodeRows + r) * d + 8 * c + e] = acc[r][e];
      if (lane == 0) {
        m_s[warp * kDecodeRows + r] = m[r];
        l_s[warp * kDecodeRows + r] = l[r];
      }
    }
  }
  __syncthreads();

  // the four warps merge in warp order into the split's partial
  const size_t prow = ((static_cast<size_t>(s) * Hk + h) * a.splits + j) * G + g0;
  float* p_acc = a.part + prow * d;
  float* p_ml = a.part + static_cast<size_t>(a.S) * Hk * a.splits * G * d + prow * 2;
  for (int e = tid; e < rows * d; e += kThreads) {
    const int r = e / d, col = e - r * d;
    float mx = m_s[r];
#pragma unroll
    for (int w = 1; w < 4; ++w) mx = fmaxf(mx, m_s[w * kDecodeRows + r]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = expf(m_s[w * kDecodeRows + r] - mx);
      lt += l_s[w * kDecodeRows + r] * f;
      at += acc_s[(w * kDecodeRows + r) * d + col] * f;
    }
    p_acc[e] = at;
    if (col == 0) {
      p_ml[2 * r] = mx;
      p_ml[2 * r + 1] = lt;
    }
  }
}

// grid (Hk * G, S): one query row (s, h, g) per block, a column per thread
template <typename QT>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(DecodeArgs a) {
  const int s = blockIdx.y, G = a.G, d = a.d;
  const int live = (decode_key_lim(a, s) - 1) / (a.split_blocks * a.bs) + 1;
  const size_t hg = static_cast<size_t>(s) * a.Hk * G + blockIdx.x;       // (s, h, g)
  const size_t prow = (hg / G * a.splits) * G + hg % G;                    // its split 0
  const float* p_acc = a.part + prow * d;
  const float* p_ml = a.part + static_cast<size_t>(a.S) * a.Hk * a.splits * G * d + prow * 2;
  QT* out = static_cast<QT*>(a.out) + hg * d;
  float mx = kNegInf;
  for (int jj = 0; jj < live; ++jj) mx = fmaxf(mx, p_ml[2 * jj * G]);
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float lt = 0.f, at = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < live; ++jj) {
      const float f = expf(p_ml[2 * jj * G] - mx);
      lt += p_ml[2 * jj * G + 1] * f;
      at += p_acc[static_cast<size_t>(jj) * G * d + col] * f;
    }
    out[col] = from_f32<QT>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename QT, typename KT, int R, int U>
int launch_decode_rows(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = decode_split_smem(a.d, a.split_blocks);
  auto split = paged_decode_split_kernel<QT, KT, R, U>;
  cudaError_t err = allow_smem(split, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  split<<<dim3(a.splits, a.Hk * a.row_groups, a.S), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_combine_kernel<QT><<<dim3(a.Hk * a.G, a.S), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// R, the rows of one block: G rounded up to a power of two, at most 8 (a
// larger G takes ceil(G / 8) row groups); U keys in flight per lane, fewer
// where R's registers are many (timed against U = 4 and 2 on an H100: a
// little faster, and no spills)
template <typename QT, typename KT>
int launch_decode(DecodeArgs a, cudaStream_t stream) {
  const int R = a.G > 4 ? 8 : a.G > 2 ? 4 : a.G;
  a.row_groups = (a.G + R - 1) / R;
  if (R == 1) return launch_decode_rows<QT, KT, 1, 8>(a, stream);
  if (R == 2) return launch_decode_rows<QT, KT, 2, 8>(a, stream);
  if (R == 4) return launch_decode_rows<QT, KT, 4, 4>(a, stream);
  return launch_decode_rows<QT, KT, 8, 4>(a, stream);
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

template <int D, int KS, typename KT>
int launch_mma(const MmaArgs& a, int S, bool prefill, cudaStream_t stream) {
  const size_t smem = verify_mma_smem(D, sizeof(KT) == 1);
  auto kernel = prefill ? paged_prefill_mma_kernel<D, KS, KT> : paged_verify_mma_kernel<D, KS, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = 16 * (4 / KS);
  const int tiles = (a.Q * a.G + rows - 1) / rows;
  kernel<<<dim3(a.Hk, tiles, S), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename KT>
int mma_ks(int key_splits, const MmaArgs& a, int S, bool prefill, cudaStream_t st) {
  if (key_splits == 4) return launch_mma<D, 4, KT>(a, S, prefill, st);
  if (key_splits == 1) return launch_mma<D, 1, KT>(a, S, prefill, st);
  return -1;
}

template <typename KT>
int mma_d(int d, int key_splits, const MmaArgs& a, int S, bool prefill, cudaStream_t st) {
#define PA_MMA_D(DD) \
  case DD: return mma_ks<DD, KT>(key_splits, a, S, prefill, st);
  switch (d) {
    PA_MMA_D(16)
    PA_MMA_D(32)
    PA_MMA_D(48)
    PA_MMA_D(64)
    PA_MMA_D(80)
    PA_MMA_D(96)
    PA_MMA_D(112)
    PA_MMA_D(128)
    default: return -1;
  }
#undef PA_MMA_D
}

int mma_launch(int kv_dtype, int d, int key_splits, const MmaArgs& a, int S, bool prefill,
               cudaStream_t st) {
  if (kv_dtype == kBF16) return mma_d<__nv_bfloat16>(d, key_splits, a, S, prefill, st);
  if (kv_dtype == kI8) return mma_d<int8_t>(d, key_splits, a, S, prefill, st);
  return -1;
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
//
// K1's two launches: the splits of `split_blocks` table entries each
// (`splits` = ceil(nb / split_blocks)) into `scratch`, S*Hk*splits*G*(d+2)
// floats, then their combine into `out`.  d a multiple of 8 up to 256.
int paged_decode_launch(const void* q, const void* cache_k, const void* cache_v,
                        const void* block_tables, const void* pos, void* scratch, void* out,
                        int S, int Hk, int G, int d, int bs, int nb, int splits,
                        int split_blocks, int q_dtype, int kv_dtype, float scale, void* stream) {
  if (d % 8 != 0 || d < 8 || d > 256 || nb < 1 || splits < 1 || split_blocks < 1)
    return kBadDType;
  int lanes = 1;
  while (8 * lanes < d) lanes *= 2;
  const DecodeArgs a{q, cache_k, cache_v, static_cast<const int*>(block_tables),
                     static_cast<const int*>(pos), static_cast<float*>(scratch), out,
                     S, Hk, G, d, bs, nb, splits, split_blocks, 1, lanes, scale};
  if (q_dtype < kF32 || q_dtype > kBF16 || kv_dtype < kF32 || kv_dtype > kI8) return kBadDType;
  PA_DISPATCH(launch_decode, a, static_cast<cudaStream_t>(stream))
}

// Bytes of dynamic shared memory K1's split kernel asks for.
long long paged_decode_smem_bytes(int d, int split_blocks) {
  return static_cast<long long>(decode_split_smem(d, split_blocks));
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

// The tensor-core body (attend_mma): bf16 q and output, bf16 (1) or int8 (2)
// KV, d a multiple of 16 up to 128, key_splits 1 (four 16-row warps per
// block) or 4 (one 16-row tile, the keys split four ways).  Each returns
// the cudaError_t of the launch, or -1 for arguments it does not take.
int paged_verify_mma_launch(const void* q, const void* cache_k, const void* cache_v,
                            const void* block_tables, const void* pos, void* out, int S, int Q,
                            int Hk, int G, int d, int bs, int nb, int kv_dtype, int key_splits,
                            float scale, void* stream) {
  const MmaArgs a{static_cast<const __nv_bfloat16*>(q), cache_k, cache_v,
                  static_cast<const int*>(block_tables), static_cast<const int*>(pos),
                  static_cast<__nv_bfloat16*>(out), Q, Hk, G, bs, nb, 0, 0, scale};
  return mma_launch(kv_dtype, d, key_splits, a, S, false, static_cast<cudaStream_t>(stream));
}

int paged_prefill_mma_launch(const void* q, const void* cache_k, const void* cache_v,
                             const void* block_table, void* out, int C, int Hk, int G, int d,
                             int bs, int nb, int start, int valid, int kv_dtype, int key_splits,
                             float scale, void* stream) {
  const MmaArgs a{static_cast<const __nv_bfloat16*>(q), cache_k, cache_v,
                  static_cast<const int*>(block_table), nullptr,
                  static_cast<__nv_bfloat16*>(out), C, Hk, G, bs, nb, start, valid, scale};
  return mma_launch(kv_dtype, d, key_splits, a, 1, true, static_cast<cudaStream_t>(stream));
}

long long paged_verify_mma_smem_bytes(int d, int kv_dtype) {
  return static_cast<long long>(verify_mma_smem(d, kv_dtype == kI8));
}

// Bytes of dynamic shared memory a launch asks for (the wrapper checks it
// against the card's 227 KB per block before launching).
long long paged_smem_bytes(int rows, int d, int bs) {
  return static_cast<long long>(smem_bytes(rows, d, bs));
}

int paged_prefill_rows() { return kPrefillRows; }

const char* paged_error_string(int code) {
  if (code == kBadDType) return "unsupported (q, kv) dtype pair, head dim, key split or split plan";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

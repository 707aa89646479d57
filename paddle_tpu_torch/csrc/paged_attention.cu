// Paged attention straight off the KV block pool, for Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/kernels/paged_attention.py::_kernel
// (pallas_call at paged_attention.py:254), both entry points:
//   decode  q [M, 1, H, D]                 row attends j <= seq_lens[m]
//   verify  q [M, Q, H, D] + draft_lens    row (qi, g) attends
//                                          j <= seq_lens[m] + min(qi, draft_lens[m])
// over one layer's pool k/v [N, bs, Hk, D] (fp32 / bf16, or int8 with fp32
// per-token-per-head scales [N, bs, Hk] dequantized at load). Slot m's KV
// position j lives in block block_tables[m, j / bs] at offset j % bs. Query
// head h = kh * G + g reads kv head kh; masked scores are -1e30 and weigh
// exactly 0; V past seq_len + draft_len is zeroed by select, never by a
// product (the poison contract: the NaN null block and freed blocks never
// reach an output); a row whose softmax sum l is 0 outputs 0.
//
// What bounds it on the H100: bytes at decode (each (slot, kv head) reads
// its window's K/V for 4 D flops per (row, key), far below the card's ~295
// flops/byte ridge); at the mixed dispatch's 256 query rows per slot the
// same K/V serves 256 G rows, and the products decide.
//
// Three routes, chosen by the wrapper's plan (kernels/paged_attention.py
// _plan) from the dtypes and Q * G:
//
//  * Multi-query tile (bf16 q; bf16 or int8 pools; Q * G >= 16: the mixed
//    and verify dispatches): paged_attention_mq_kernel, one block of 4
//    warps per (64-row tile of the Q * G rows of kv head kh, kh, slot),
//    rows qi-major so a tile's windows are nearly equal. Key tiles of 64
//    are assembled from the block table (any block size) with 16-byte
//    cp.async pieces, double-buffered; keys past the slot's widest window
//    are zero-filled, never read, and tiles past the tile's widest window
//    are never loaded. QK^T and P.V run on mma.sync.m16n8k16 bf16 with
//    fp32 accumulators (gemm_abt / gemm_pb of mma_common.cuh), the online
//    softmax in the accumulator layout, exp2 with log2(e) folded into the
//    scale. int8 pools land as int8 and are widened to bf16 in shared
//    memory (exact); the k-scale multiplies the score column and the
//    v-scale (0 past the window) multiplies P before P.V. A fp32 output (the
//    int8-pool default) keeps P to ~16 bits: P = hi + lo, two bf16
//    products. Against the FMA kernel below: one tile of 64 rows where 8
//    rows re-read the window 8x as often, and tensor cores where lanes
//    scored one key each.
//  * Decode (bf16 q; bf16 or int8 pools; Q * G < 16: the decode dispatch,
//    Q = 1 and Q = 8 verify): paged_attention_split_kernel splits the
//    window (flash-decoding). Grid (splits, Hk, M); the plan picks splits
//    from the table's capacity W * bs and the SM count so the grid reaches
//    about 4 blocks per SM (M = 8, Hk = 16, W * bs = 2048: 5 splits of 448
//    keys, 640 blocks where the FMA kernel launches 128). All Q * G rows of
//    a kv head share one block; its 4 warps take 16 keys each of every 64-key
//    tile, and their (m, l, acc) meet in shared memory in warp order. With
//    one split the block writes the output; with more it writes fp32 (m, l,
//    acc[D]) partials to wrapper-allocated scratch and
//    paged_attention_merge_kernel combines the splits in split order: the
//    output is the same bits on every run.
//  * fp32 q or fp32 pools: paged_attention_kernel, the first FMA kernel (the
//    parity path, chosen by dtype only; the card tests hold it to 1e-4):
//    one block per (8-row tile, kv head, slot), one key per lane, K/V
//    widened to fp32 in shared memory, the next KV block's loads in flight
//    while the current one is scored.
//
// Times on NVIDIA H100 80GB HBM3, 700.00 W: PERF.md section 6, row 1.

#include "mma_common.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr int kDimsPerLane = kMaxD / 32;
constexpr int kMaxBlockSize = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kRowsPerWarp * kWarps;
// 16-byte pieces per thread for one of K or V: a 32 x 128 fp32 block is
// 1024 pieces over 128 threads
constexpr int kMaxPieces = kMaxBlockSize * kMaxD * 4 / 16 / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One KV block of one kv head in flight: this thread's 16-byte pieces of K
// and V, and (thread t < bs) token t's scales.
struct Staged {
  uint4 k[kMaxPieces], v[kMaxPieces];
  float ks, vs;
};

template <typename TKV>
__device__ __forceinline__ void fetch(Staged& st, const TKV* __restrict__ k_pool,
                                      const TKV* __restrict__ v_pool,
                                      const float* __restrict__ k_scale,
                                      const float* __restrict__ v_scale,
                                      size_t first_tok, int Hk, int kh, int D,
                                      int bs) {
  constexpr int kPer = 16 / sizeof(TKV);  // elements in a piece
  const int per_row = D / kPer;
#pragma unroll
  for (int j = 0; j < kMaxPieces; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < bs * per_row) {
      const int t = c / per_row, e = c % per_row;
      const size_t row = ((first_tok + t) * Hk + kh) * D;
      st.k[j] = reinterpret_cast<const uint4*>(k_pool + row)[e];
      st.v[j] = reinterpret_cast<const uint4*>(v_pool + row)[e];
    }
  }
  if (k_scale != nullptr && static_cast<int>(threadIdx.x) < bs) {
    const size_t tok = (first_tok + threadIdx.x) * Hk + kh;
    st.ks = k_scale[tok];
    st.vs = v_scale[tok];
  }
}

template <typename TKV>
__device__ __forceinline__ void stage(
    const Staged& st, float (*k_s)[kMaxD + 1], float (*v_s)[kMaxD],
    float* ks_s, float* vs_s, bool scaled, int base, int v_limit, int D,
    int bs) {
  constexpr int kPer = 16 / sizeof(TKV);
  const int per_row = D / kPer;
#pragma unroll
  for (int j = 0; j < kMaxPieces; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < bs * per_row) {
      const int t = c / per_row, d0 = (c % per_row) * kPer;
      const bool keep = base + t <= v_limit;  // select, never multiply
      const TKV* kp = reinterpret_cast<const TKV*>(&st.k[j]);
      const TKV* vp = reinterpret_cast<const TKV*>(&st.v[j]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        k_s[t][d0 + i] = to_f(kp[i]);
        v_s[t][d0 + i] = keep ? to_f(vp[i]) : 0.f;
      }
    }
  }
  const int t = threadIdx.x;
  if (t < bs) {
    const bool keep = base + t <= v_limit;
    ks_s[t] = scaled ? st.ks : 1.f;
    vs_s[t] = keep ? (scaled ? st.vs : 1.f) : 0.f;
  }
}

template <typename TQ, typename TKV, typename TO>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ seq_lens,
                       const int* __restrict__ draft_lens,
                       TO* __restrict__ out, int Q, int H, int Hk, int D,
                       int bs, int W, float scale) {
  __shared__ float q_s[kRows][kMaxD];
  __shared__ float k_s[kMaxBlockSize][kMaxD + 1];  // +1: conflict-free rows
  __shared__ float v_s[kMaxBlockSize][kMaxD];
  __shared__ float ks_s[kMaxBlockSize], vs_s[kMaxBlockSize];

  const int G = H / Hk;
  const int QG = Q * G;
  const int m = blockIdx.z;
  const int kh = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool scaled = k_scale != nullptr;

  const int sl = seq_lens[m];
  const int dl = draft_lens != nullptr ? draft_lens[m] : 0;
  const int v_limit = sl + dl;  // widest window any row of the slot reaches

  // stage the tile's query rows: row r = qi * G + g is query head kh*G + g
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int rr = i / D, d = i % D, r = r0 + rr;
    float val = 0.f;
    if (r < QG) {
      const int qi = r / G, h = kh * G + r % G;
      val = to_f(q[((static_cast<size_t>(m) * Q + qi) * H + h) * D + d]);
    }
    q_s[rr][d] = val;
  }

  float acc[kRowsPerWarp][kDimsPerLane];
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
  int hi[kRowsPerWarp];  // last key position the row attends; -1 = no row
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) acc[i][c] = 0.f;
    const int r = r0 + warp * kRowsPerWarp + i;
    hi[i] = r < QG ? sl + min(r / G, dl) : -1;
  }
  // blocks past the tile's widest window would carry only zero weights
  const int r_last = min(r0 + kRows, QG) - 1;
  const int tile_hi = sl + min(r_last / G, dl);
  const int n_blocks = min(W, tile_hi / bs + 1);
  const int* table = tables + static_cast<size_t>(m) * W;

  Staged st;
  fetch(st, k_pool, v_pool, k_scale, v_scale,
        static_cast<size_t>(table[0]) * bs, Hk, kh, D, bs);
  for (int w = 0; w < n_blocks; ++w) {
    const int base = w * bs;
    __syncthreads();  // the previous block is consumed; q_s is staged
    stage<TKV>(st, k_s, v_s, ks_s, vs_s, scaled, base, v_limit, D, bs);
    __syncthreads();
    if (w + 1 < n_blocks)  // the next block's loads fly during this one
      fetch(st, k_pool, v_pool, k_scale, v_scale,
            static_cast<size_t>(table[w + 1]) * bs, Hk, kh, D, bs);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (hi[i] < 0) continue;  // uniform across the warp
      const int rr = warp * kRowsPerWarp + i;
      float s = kNegInf;
      if (lane < bs && base + lane <= hi[i]) {
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
        for (int d = 0; d < D; d += 4) {
          d0 += q_s[rr][d] * k_s[lane][d];
          d1 += q_s[rr][d + 1] * k_s[lane][d + 1];
          d2 += q_s[rr][d + 2] * k_s[lane][d + 2];
          d3 += q_s[rr][d + 3] * k_s[lane][d + 3];
        }
        s = ((d0 + d1) + (d2 + d3)) * ks_s[lane] * scale;
      }
      const float m_cur = fmaxf(m_run[i], warp_max(s));
      // exactly 0 for a masked key, whatever the running max
      const float p = s != kNegInf ? expf(s - m_cur) : 0.f;
      const float alpha = expf(m_run[i] - m_cur);
      l_run[i] = l_run[i] * alpha + warp_sum(p);
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) acc[i][c] *= alpha;
      for (int t = 0; t < bs; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t) * vs_s[t];
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[i][c] += pt * v_s[t][d];
        }
      }
      m_run[i] = m_cur;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (hi[i] < 0) continue;
    const int r = r0 + warp * kRowsPerWarp + i;
    const int qi = r / G, h = kh * G + r % G;
    const float inv = l_run[i] == 0.f ? 0.f : 1.f / l_run[i];
    TO* o = out + ((static_cast<size_t>(m) * Q + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = from_f<TO>(acc[i][c] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core routes: bf16 q, bf16 or int8 pools
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kKT = 64;      // keys per tile
constexpr int kMqRows = 64;  // query rows per multi-query block
constexpr int kSplitRows = 16;
constexpr float kMaskedBelow = -5e29f;
constexpr float kLog2e = 1.4426950408889634f;

enum Route { kFma = 0, kMultiQuery = 1, kSplit = 2 };

struct TcArgs {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *tables, *seq_lens, *draft_lens;
  void* out;
  float *part_ml, *part_acc;  // split partials (null with one split)
  int M, Q, H, Hk, D, bs, W, span, splits;
  float scale_log2;  // softmax scale * log2(e): scores in log2 units
};

// 4 bytes global -> shared (a scale beside its tile); zero-fill when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// 16 int8 values -> 16 bf16 (exact for |q| <= 127, which int8 KV entries
// are) in two 16-byte words.
__device__ __forceinline__ void int8x16_to_bf16(const uint4& in, uint4 (&out)[2]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&in);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = pack(static_cast<float>(b[2 * i]), static_cast<float>(b[2 * i + 1]));
}

// Shared-memory layout of both kernels after the R query rows: staged K/V
// tiles [2 buffers][K, V][64 keys] (bf16 rows padded to DP + 8 elements for
// conflict-free ldmatrix; int8 rows DP bytes), for int8 the widened bf16
// K/V tile [K, V][64][DP + 8] and the scales [2 buffers][K, V][64].
template <typename TKV, int DP>
struct Tiles {
  static constexpr bool kInt8 = sizeof(TKV) == 1;
  static constexpr int LD = DP + 8;
  static constexpr int kRawStride = kInt8 ? DP : LD * 2;  // bytes per staged row
  static constexpr size_t kRaw = static_cast<size_t>(kKT) * kRawStride;
  static constexpr size_t kWide = kInt8 ? 2 * static_cast<size_t>(kKT) * LD * 2 : 0;
  static constexpr size_t kScales = kInt8 ? 4 * kKT * sizeof(float) : 0;
  static constexpr size_t bytes(int rows) {
    return static_cast<size_t>(rows) * LD * 2 + 4 * kRaw + kWide + kScales;
  }
};

// Starts the copies of keys [t0, t0 + 64) of slot m, kv head kh into
// staged buffer `buf`: 16-byte cp.async pieces through the block table,
// zero-filled at and past k_end and past D; int8 scales as 4-byte pieces
// (0 past k_end).
template <typename TKV, int DP>
__device__ __forceinline__ void issue_kv(unsigned char* raw, float* sc, int buf,
                                         const TcArgs& a, int m, int kh, int t0,
                                         int k_end) {
  using T = Tiles<TKV, DP>;
  constexpr int kPer = 16 / sizeof(TKV);
  constexpr int kPieces = DP / kPer;
  const TKV* kp = static_cast<const TKV*>(a.k_pool);
  const TKV* vp = static_cast<const TKV*>(a.v_pool);
  const int* table = a.tables + static_cast<size_t>(m) * a.W;
  unsigned char* k_dst = raw + (2 * buf) * T::kRaw;
  unsigned char* v_dst = raw + (2 * buf + 1) * T::kRaw;
  for (int c = threadIdx.x; c < kKT * kPieces; c += kThreads) {
    const int r = c / kPieces, e = (c % kPieces) * kPer;
    const int j = t0 + r;
    const bool valid = j < k_end && e < a.D;
    size_t off = 0;
    if (valid)
      off = ((static_cast<size_t>(table[j / a.bs]) * a.bs + j % a.bs) * a.Hk + kh) *
                a.D + e;
    const int at = r * T::kRawStride + e * static_cast<int>(sizeof(TKV));
    cp_async16(k_dst + at, kp + off, valid);
    cp_async16(v_dst + at, vp + off, valid);
  }
  if (T::kInt8 && static_cast<int>(threadIdx.x) < kKT) {
    const int j = t0 + threadIdx.x;
    const bool valid = j < k_end;
    const size_t tok =
        valid ? (static_cast<size_t>(table[j / a.bs]) * a.bs + j % a.bs) * a.Hk + kh
              : 0;
    cp_async4(sc + (2 * buf) * kKT + threadIdx.x, a.k_scale + tok, valid);
    cp_async4(sc + (2 * buf + 1) * kKT + threadIdx.x, a.v_scale + tok, valid);
  }
}

// The R query rows [r0, r0 + R) of kv head kh (row r is query offset r / G,
// head kh * G + r % G) into q_s, zero past Q * G and past D.
template <int DP, int R>
__device__ __forceinline__ void issue_q(bf16* q_s, const TcArgs& a, int m, int kh,
                                        int r0) {
  constexpr int LD = DP + 8, kPieces = DP / 8;
  const int G = a.H / a.Hk, QG = a.Q * G;
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int c = threadIdx.x; c < R * kPieces; c += kThreads) {
    const int r = c / kPieces, e = (c % kPieces) * 8, rr = r0 + r;
    const bool valid = rr < QG && e < a.D;
    const size_t off =
        valid ? ((static_cast<size_t>(m) * a.Q + rr / G) * a.H + kh * G + rr % G) *
                        a.D + e
              : 0;
    cp_async16(q_s + r * LD + e, q + off, valid);
  }
}

// The K and V tiles of staged buffer `buf` as bf16: in place for bf16
// pools; widened (exactly) into `wide` for int8 pools, which takes a
// barrier of its own.
template <typename TKV, int DP>
__device__ __forceinline__ void kv_tiles(unsigned char* raw, bf16* wide, int buf,
                                         const bf16*& k_t, const bf16*& v_t) {
  using T = Tiles<TKV, DP>;
  if (!T::kInt8) {
    k_t = reinterpret_cast<const bf16*>(raw + (2 * buf) * T::kRaw);
    v_t = reinterpret_cast<const bf16*>(raw + (2 * buf + 1) * T::kRaw);
    return;
  }
  constexpr int P = DP / 16;
  for (int c = threadIdx.x; c < 2 * kKT * P; c += kThreads) {
    const int kv = c / (kKT * P), r = (c / P) % kKT, e = (c % P) * 16;
    const unsigned char* src = raw + (2 * buf + kv) * T::kRaw + r * DP + e;
    uint4 o[2];
    int8x16_to_bf16(*reinterpret_cast<const uint4*>(src), o);
    uint4* dst = reinterpret_cast<uint4*>(wide + (kv * kKT + r) * T::LD + e);
    dst[0] = o[0];
    dst[1] = o[1];
  }
  __syncthreads();
  k_t = wide;
  v_t = wide + kKT * T::LD;
}

// acc += P . V with P split into bf16 hi + lo parts: ~16 bits of P, for
// a fp32 output (one bf16 P would round the output at ~3 decimal digits).
template <int KT, int NT>
__device__ __forceinline__ void gemm_pb_split(float (&acc)[NT][4],
                                              const float (&p)[KT][4],
                                              const bf16* Bm, int ldb) {
  const int lane = threadIdx.x & 31;
  const bf16* b_row =
      Bm + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + (lane >> 4) * 8;
  auto lo = [](float x) { return x - __bfloat162float(__float2bfloat16(x)); };
#pragma unroll
  for (int kc = 0; kc < KT / 2; ++kc) {
    const float(&p0)[4] = p[2 * kc];
    const float(&p1)[4] = p[2 * kc + 1];
    const uint32_t h0 = pack(p0[0], p0[1]), h1 = pack(p0[2], p0[3]);
    const uint32_t h2 = pack(p1[0], p1[1]), h3 = pack(p1[2], p1[3]);
    const uint32_t l0 = pack(lo(p0[0]), lo(p0[1])), l1 = pack(lo(p0[2]), lo(p0[3]));
    const uint32_t l2 = pack(lo(p1[0]), lo(p1[1])), l3 = pack(lo(p1[2]), lo(p1[3]));
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_row + 16 * kc * ldb + nt * 8);
      mma_bf16(acc[nt], h0, h1, h2, h3, b[0], b[1]);
      mma_bf16(acc[nt + 1], h0, h1, h2, h3, b[2], b[3]);
      mma_bf16(acc[nt], l0, l1, l2, l3, b[0], b[1]);
      mma_bf16(acc[nt + 1], l0, l1, l2, l3, b[2], b[3]);
    }
  }
}

// One warp, 16 query rows x 8 NT keys (logical key0 + column): scores,
// mask (key > hi[row] -> -1e30; `interior` tiles are wholly visible),
// online softmax (m, l in log2 units) and P . V into acc.
template <int NT, int DP, bool SCALED, bool FP32_OUT>
__device__ __forceinline__ void attend(float (&acc)[DP / 8][4], float (&m_run)[2],
                                       float (&l_run)[2], const bf16* q_rows,
                                       const bf16* k_rows, const bf16* v_rows,
                                       const float* ks, const float* vs, int key0,
                                       const int (&hi)[2], bool interior,
                                       float scale_log2) {
  constexpr int LD = DP + 8;
  const int t = threadIdx.x & 3;
  float s[NT][4];
  zero(s);
  gemm_abt<NT, DP>(s, q_rows, LD, k_rows, LD);
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t + (e & 1);
      float v = s[n][e] * scale_log2;
      if (SCALED) v *= ks[col];
      if (!interior && key0 + col > hi[e >> 1]) v = kNegInf;
      s[n][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    alpha[i] = exp2f(m_run[i] - mx[i]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // exactly 0 for a masked key, whatever the running max
      const float p = s[n][e] <= kMaskedBelow ? 0.f : exp2f(s[n][e] - mx[e >> 1]);
      rsum[e >> 1] += p;
      s[n][e] = SCALED ? p * vs[n * 8 + 2 * t + (e & 1)] : p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] = l_run[i] * alpha[i] + quad_sum(rsum[i]);
    m_run[i] = mx[i];
  }
#pragma unroll
  for (int d = 0; d < DP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];
  if (FP32_OUT)
    gemm_pb_split<NT, DP / 8>(acc, s, v_rows, LD);
  else
    gemm_pb<NT, DP / 8>(acc, s, v_rows, LD);
}

template <typename TO>
__device__ __forceinline__ TO* out_row(const TcArgs& a, int m, int kh, int r) {
  const int G = a.H / a.Hk;
  return static_cast<TO*>(a.out) +
         ((static_cast<size_t>(m) * a.Q + r / G) * a.H + kh * G + r % G) * a.D;
}

// grid (ceil(Q * G / 64), Hk, M)
template <typename TKV, typename TO, int DP>
__global__ void __launch_bounds__(kThreads)
paged_attention_mq_kernel(const TcArgs a) {
  using T = Tiles<TKV, DP>;
  constexpr int LD = T::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                       // [64][LD]
  unsigned char* raw = reinterpret_cast<unsigned char*>(q_s + kMqRows * LD);
  bf16* wide = reinterpret_cast<bf16*>(raw + 4 * T::kRaw);
  float* sc = reinterpret_cast<float*>(raw + 4 * T::kRaw + T::kWide);

  const int m = blockIdx.z, kh = blockIdx.y, r0 = blockIdx.x * kMqRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = a.H / a.Hk, QG = a.Q * G;
  const int sl = a.seq_lens[m];
  const int dl = a.draft_lens != nullptr ? a.draft_lens[m] : 0;
  const int k_end = sl + dl + 1;  // keys past the slot's widest window: never read
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  int hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) hi[i] = row[i] < QG ? sl + min(row[i] / G, dl) : -1;
  const int tile_hi = sl + min((min(r0 + kMqRows, QG) - 1) / G, dl);
  const int hi_min = sl + min(r0 / G, dl);  // the block's narrowest window
  const int n_tiles = tile_hi < 0 ? 0 : tile_hi / kKT + 1;

  issue_q<DP, kMqRows>(q_s, a, m, kh, r0);
  if (n_tiles > 0) issue_kv<TKV, DP>(raw, sc, 0, a, m, kh, 0, k_end);
  cp_async_commit();

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[DP / 8][4];
  zero(acc);
  for (int i = 0, buf = 0; i < n_tiles; ++i, buf ^= 1) {
    if (i + 1 < n_tiles) {
      issue_kv<TKV, DP>(raw, sc, buf ^ 1, a, m, kh, (i + 1) * kKT, k_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and q) landed for every thread
    const bf16 *k_t, *v_t;
    kv_tiles<TKV, DP>(raw, wide, buf, k_t, v_t);
    const int t0 = i * kKT;
    attend<8, DP, T::kInt8, sizeof(TO) == 4>(
        acc, m_run, l_run, q_s + warp * 16 * LD, k_t, v_t, sc + (2 * buf) * kKT,
        sc + (2 * buf + 1) * kKT, t0, hi, t0 + kKT - 1 <= hi_min, a.scale_log2);
    __syncthreads();  // every warp is done with this buffer before its refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= QG) continue;
    const float inv = l_run[i] == 0.f ? 0.f : 1.f / l_run[i];
    TO* o = out_row<TO>(a, m, kh, row[i]);
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
      const int col = d * 8 + 2 * t;
      if (col < a.D) store2(o + col, acc[d][2 * i] * inv, acc[d][2 * i + 1] * inv);
    }
  }
}

// grid (splits, Hk, M); the Q * G (< 16) rows of kv head kh over keys
// [split * span, min((split + 1) * span, seq_len + draft_len + 1)).
template <typename TKV, typename TO, int DP>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const TcArgs a) {
  using T = Tiles<TKV, DP>;
  constexpr int LD = T::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                       // [16][LD]
  unsigned char* raw = reinterpret_cast<unsigned char*>(q_s + kSplitRows * LD);
  bf16* wide = reinterpret_cast<bf16*>(raw + 4 * T::kRaw);
  float* sc = reinterpret_cast<float*>(raw + 4 * T::kRaw + T::kWide);

  const int split = blockIdx.x, kh = blockIdx.y, m = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = a.H / a.Hk, QG = a.Q * G;
  const int sl = a.seq_lens[m];
  const int dl = a.draft_lens != nullptr ? a.draft_lens[m] : 0;
  const int k_beg = split * a.span;
  const int k_end = min(k_beg + a.span, sl + dl + 1);
  int hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    hi[i] = r < QG ? min(sl + min(r / G, dl), k_end - 1) : -1;
  }
  const int hi_min = min(sl, k_end - 1);  // row 0's window, the narrowest
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + kKT - 1) / kKT : 0;

  issue_q<DP, kSplitRows>(q_s, a, m, kh, 0);
  if (n_tiles > 0) issue_kv<TKV, DP>(raw, sc, 0, a, m, kh, k_beg, k_end);
  cp_async_commit();

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[DP / 8][4];
  zero(acc);
  for (int i = 0, buf = 0; i < n_tiles; ++i, buf ^= 1) {
    const int t0 = k_beg + i * kKT;
    if (i + 1 < n_tiles) {
      issue_kv<TKV, DP>(raw, sc, buf ^ 1, a, m, kh, t0 + kKT, k_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16 *k_t, *v_t;
    kv_tiles<TKV, DP>(raw, wide, buf, k_t, v_t);
    const int key0 = t0 + warp * 16;  // this warp's 16 keys of the tile
    attend<2, DP, T::kInt8, sizeof(TO) == 4>(
        acc, m_run, l_run, q_s, k_t + warp * 16 * LD, v_t + warp * 16 * LD,
        sc + (2 * buf) * kKT + warp * 16, sc + (2 * buf + 1) * kKT + warp * 16,
        key0, hi, t0 + kKT - 1 <= hi_min, a.scale_log2);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();  // the tile buffers become the warps' meeting place

  // the 4 warps' (m, l, acc) over rows 0..15, combined in warp order
  float* red = reinterpret_cast<float*>(raw);  // [4 warps][16 rows][DP]
  float* ml = red + 4 * kSplitRows * DP;       // [4 warps][16 rows][m, l]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    if (t == 0) {
      ml[(warp * kSplitRows + r) * 2] = m_run[i];
      ml[(warp * kSplitRows + r) * 2 + 1] = l_run[i];
    }
#pragma unroll
    for (int d = 0; d < DP / 8; ++d)
      store2(red + (warp * kSplitRows + r) * DP + d * 8 + 2 * t, acc[d][2 * i],
             acc[d][2 * i + 1]);
  }
  __syncthreads();
  const size_t part = (static_cast<size_t>(m) * a.Hk + kh) * a.splits + split;
  for (int idx = threadIdx.x; idx < QG * a.D; idx += kThreads) {
    const int r = idx / a.D, d = idx % a.D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml[(w * kSplitRows + r) * 2]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(ml[(w * kSplitRows + r) * 2] - mx);
      l += ml[(w * kSplitRows + r) * 2 + 1] * f;
      o += red[(w * kSplitRows + r) * DP + d] * f;
    }
    if (a.part_acc == nullptr) {
      out_row<TO>(a, m, kh, r)[d] = from_f<TO>(l == 0.f ? 0.f : o / l);
    } else {
      a.part_acc[(part * QG + r) * a.D + d] = o;
      if (d == 0) {
        a.part_ml[(part * QG + r) * 2] = mx;
        a.part_ml[(part * QG + r) * 2 + 1] = l;
      }
    }
  }
}

// grid (Q * G, Hk, M), D threads: one output row from its splits' partials,
// merged in split order (a running max, rescaled as it grows); the
// partials' loads go out 8 splits at a time.
template <typename TO>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const TcArgs a) {
  const int r = blockIdx.x, kh = blockIdx.y, m = blockIdx.z, d = threadIdx.x;
  const int QG = gridDim.x;
  if (d >= a.D) return;
  const size_t base = (static_cast<size_t>(m) * a.Hk + kh) * a.splits;
  float mx = kNegInf, l = 0.f, o = 0.f;
  for (int s0 = 0; s0 < a.splits; s0 += 8) {
    float ms[8], ls[8], os[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u >= a.splits) break;
      const size_t at = (base + s0 + u) * QG + r;
      ms[u] = a.part_ml[at * 2];
      ls[u] = a.part_ml[at * 2 + 1];
      os[u] = a.part_acc[at * a.D + d];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u >= a.splits) break;
      const float nm = fmaxf(mx, ms[u]);
      const float f_old = exp2f(mx - nm), f_new = exp2f(ms[u] - nm);
      l = l * f_old + ls[u] * f_new;
      o = o * f_old + os[u] * f_new;
      mx = nm;
    }
  }
  out_row<TO>(a, m, kh, r)[d] = from_f<TO>(l == 0.f ? 0.f : o / l);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  // above 48 KB a block's shared memory is opt-in, once per kernel
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(bytes))
             : cudaSuccess;
}

template <typename TKV, typename TO, int DP>
cudaError_t launch_tc(const TcArgs& a, int route, cudaStream_t stream) {
  using T = Tiles<TKV, DP>;
  const int QG = a.Q * (a.H / a.Hk);
  if (route == kMultiQuery) {
    auto kernel = paged_attention_mq_kernel<TKV, TO, DP>;
    constexpr size_t bytes = T::bytes(kMqRows);
    static const cudaError_t opted = allow_smem(kernel, bytes);
    if (opted != cudaSuccess) return opted;
    kernel<<<dim3((QG + kMqRows - 1) / kMqRows, a.Hk, a.M), kThreads, bytes,
             stream>>>(a);
    return cudaGetLastError();
  }
  auto kernel = paged_attention_split_kernel<TKV, TO, DP>;
  constexpr size_t bytes = T::bytes(kSplitRows);
  static_assert(4 * T::kRaw + T::kWide >=
                    (4 * kSplitRows * DP + 2 * 4 * kSplitRows) * sizeof(float),
                "the warps' meeting place fits in the tile buffers");
  static const cudaError_t opted = allow_smem(kernel, bytes);
  if (opted != cudaSuccess) return opted;
  kernel<<<dim3(a.splits, a.Hk, a.M), kThreads, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  paged_attention_merge_kernel<TO><<<dim3(QG, a.Hk, a.M), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TKV, typename TO>
cudaError_t launch_tc_d(const TcArgs& a, int route, cudaStream_t stream) {
  return a.D <= 64 ? launch_tc<TKV, TO, 64>(a, route, stream)
                   : launch_tc<TKV, TO, 128>(a, route, stream);
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *tables, *seq_lens, *draft_lens;
  void* out;
  int M, Q, H, Hk, D, bs, W;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, typename TO>
int launch(const Args& a) {
  const int QG = a.Q * (a.H / a.Hk);
  const dim3 grid((QG + kRows - 1) / kRows, a.Hk, a.M);
  paged_attention_kernel<TQ, TKV, TO><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.k_scale, a.v_scale, a.tables,
      a.seq_lens, a.draft_lens, static_cast<TO*>(a.out), a.Q, a.H, a.Hk,
      a.D, a.bs, a.W, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_out(const Args& a, int out_dtype) {
  switch (out_dtype) {
    case 0: return launch<TQ, TKV, float>(a);
    case 1: return launch<TQ, TKV, __nv_bfloat16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int launch_kv(const Args& a, int kv_dtype, int out_dtype) {
  switch (kv_dtype) {
    case 0: return launch_out<TQ, float>(a, out_dtype);
    case 1: return launch_out<TQ, __nv_bfloat16>(a, out_dtype);
    case 2: return launch_out<TQ, int8_t>(a, out_dtype);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// k_scale / v_scale are null for fp pools; draft_lens is null for decode.
// The pools (and, on routes 1-2, q) must be 16-byte aligned with
// D % 16 == 0. route: 0 = the FMA kernel (any dtypes), 1 = multi-query
// tensor-core tiles, 2 = split decode (Q * G <= 16); routes 1-2 take bf16
// q and bf16 or int8 pools. Route 2 cuts the W * bs keys into `splits`
// spans of `span` keys (a multiple of 64); splits > 1 needs fp32 scratch
// part_ml [M, Hk, splits, Q * G, 2] and part_acc [M, Hk, splits, Q * G, D].
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* seq_lens, const void* draft_lens, void* out, int M, int Q,
    int H, int Hk, int D, int bs, int W, float scale, int q_dtype,
    int kv_dtype, int out_dtype, void* part_ml, void* part_acc, int route,
    int splits, int span, void* stream) {
  if (D > kMaxD || D % 16 != 0 || bs > kMaxBlockSize || bs < 1 || Hk <= 0 ||
      H % Hk != 0 || W < 1 ||
      (reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route != kFma) {
    const long long C = static_cast<long long>(W) * bs;
    if (q_dtype != 1 || kv_dtype < 1 || kv_dtype > 2 || out_dtype < 0 ||
        out_dtype > 1 || reinterpret_cast<uintptr_t>(q) % 16 ||
        (route != kMultiQuery && route != kSplit) ||
        (route == kSplit &&
         (Q * (H / Hk) > kSplitRows || splits < 1 || span % kKT != 0 ||
          static_cast<long long>(splits) * span < C ||
          static_cast<long long>(splits - 1) * span >= C ||
          (splits > 1 && (part_ml == nullptr || part_acc == nullptr)))) ||
        (route == kMultiQuery && splits != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    TcArgs a{q, k_pool, v_pool,
             static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
             static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
             static_cast<const int*>(draft_lens), out,
             splits > 1 ? static_cast<float*>(part_ml) : nullptr,
             splits > 1 ? static_cast<float*>(part_acc) : nullptr,
             M, Q, H, Hk, D, bs, W, span, splits, scale * kLog2e};
    cudaError_t err;
    if (kv_dtype == 1)
      err = out_dtype == 0 ? launch_tc_d<bf16, float>(a, route, st)
                           : launch_tc_d<bf16, bf16>(a, route, st);
    else
      err = out_dtype == 0 ? launch_tc_d<int8_t, float>(a, route, st)
                           : launch_tc_d<int8_t, bf16>(a, route, st);
    return static_cast<int>(err);
  }
  Args a{q, k_pool, v_pool,
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
         static_cast<const int*>(draft_lens), out, M, Q, H, Hk, D, bs, W, scale,
         st};
  switch (q_dtype) {
    case 0: return launch_kv<float>(a, kv_dtype, out_dtype);
    case 1: return launch_kv<__nv_bfloat16>(a, kv_dtype, out_dtype);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of paddle_tpu/kernels/flash_attention.py:
//   flash_fwd_kernel      <- _fwd_kernel      (:67,  pallas_call :164)
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel   (:204, pallas_call :334)
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel  (:259, pallas_call :360)
// on q [B, Sq, H, D], k/v [B, Sk, Hk, D] (contiguous; no transpose to
// [B, H, S, D]), lse/delta [B, H, Sq] fp32, optional int32 segment ids
// seg_q [B, Sq] / seg_k [B, Sk]. What they compute:
//   * scores s = (q . k) * scale, masked to -1e30 where query i may not see
//     key j: causal bottom-right aligned (j <= i + Sk - Sq), and
//     seg_q[i] == seg_k[j] when segments are on; GQA: query head h reads kv
//     head h / (H / Hk);
//   * forward: online softmax in fp32; p is forced to exactly 0 where
//     s <= -5e29 (a row with no visible key yet would otherwise weigh masked
//     keys 1); a row whose sum l is 0 outputs 0 with lse = m + log(1);
//   * dq:  p = exp(s - lse) (0 where s <= -5e29), dp = dO . v,
//          ds = p * (dp - delta) * scale, dq = sum_k ds . k, in q's dtype;
//   * dkv: dv = sum_q p^T . dO and dk = sum_q ds^T . q in fp32, summed over
//          the G query heads of each kv head, then cast to k/v's dtype.
//
// What bounds them on the H100: operations. At the training step's shape
// (B 8, S 2048, H 16, D 128, causal) the forward does 4*D flops per visible
// (query, key) pair, dq 6*D, dk/dv 8*D, on ~1.5 MB of q/k/v per (b, h) read
// once: hundreds of flops per byte, far above the card's ~295 flops/byte
// bf16 ridge. So the products have to run on the tensor cores.
//
// Design (simple first; not yet fast):
//  * The TPU grid's sequential kv (or q) dimension becomes a loop inside one
//    thread block of 4 warps. Forward and dq: one block per (64-row query
//    tile, head, batch), walking 32-key tiles up to the causal limit (small
//    tiles keep the double-buffered shared memory at 52 KB (forward) and
//    70 KB (dq) for D 128 bf16, so three blocks share an SM). dk/dv:
//    one block per (64-key tile, kv head, batch), looping over the G query
//    heads of the group and over 32-row query tiles from the first row that
//    can see the tile; the GQA fold happens in registers, so the [B, H, Sk,
//    D] fp32 temporary of the TPU version never exists.
//  * Each warp owns 16 rows. Every product is one of two warp-level forms on
//    tiles in shared memory, and both keep the result in the register layout
//    of mma.sync's m16n8 accumulator (row g = lane/4 and g + 8, columns
//    2*(lane%4) + {0, 1} of each 8-wide tile):
//      gemm_abt: acc[16 x N] += A[16 x K] . B[N x K]^T  (both K-contiguous),
//      gemm_pb:  acc[16 x N] += P[16 x K] . B[K x N]    (P in accumulator
//                registers, B N-contiguous),
//    so the masking, online softmax and row reductions (quad shuffles) are
//    written once. For bf16 both forms are mma.sync.m16n8k16 bf16 with fp32
//    accumulation; gemm_pb re-packs the fp32 accumulator tiles as the A
//    operand, so P and dS round to bf16 before their products, as on the
//    tensor cores of any flash kernel. For fp32 inputs both forms are fp32
//    FMA loops on the same layout (gemm_pb fetches P with shuffles inside
//    the quad): full fp32, no TF32.
//  * Tiles move global -> shared with cp.async (16-byte pieces, rows past S
//    zero-filled), double-buffered: the next visible K/V tile (Q/dO tile in
//    dk/dv) is in flight while the current one is used, with one barrier
//    before and one after the use. Shared rows are padded by 16 bytes, so
//    the 8 rows of every 8x8 ldmatrix fall in distinct banks. bf16
//    operands reach mma.sync through ldmatrix (.trans for the
//    N-contiguous operand of gemm_pb).
//  * The kernels mask ragged edges themselves and take any S; a tile that
//    is wholly visible (inside the causal limit, no ragged edge, no
//    segments) skips the per-element mask.
//  * With segments on, a key (or query) tile whose id range cannot meet the
//    other tile's is never loaded: the next visible tile is found by a warp
//    reduction over its ids; this changes no output (the TPU version's
//    _seg_overlap gate).
//  * Scores are exponentiated with exp2 for bf16 inputs (exp_of): per score
//    the softmax's scalar work competes with the products for issue slots.
//  * Not yet: wgmma and TMA, a warp-specialised producer, 32 rows per warp
//    (each K/V fragment feeding two products). Every warp re-reads the K/V
//    tile it shares with the block's other warps from shared memory.
//  * The bf16 forms, ldmatrix, cp.async and the quad reductions live in
//    mma_common.cuh, shared with paged_attention.cu and quant_matmul.cu.

#include <climits>

#include "mma_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows (fwd, dq) / keys (dkv) a block owns
constexpr int kKeys = 32;           // keys per tile (fwd, dq)
constexpr int kQTile = 32;          // query rows per tile (dkv)
constexpr float kNegInf = -1e30f;
constexpr float kMaskedBelow = -5e29f;
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory row stride in elements: D plus 16 bytes
template <typename T, int D>
__host__ __device__ constexpr int row_ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *seg_q, *seg_k;
  void *out, *dq, *dk, *dv;
  float* lse_out;
  int B, H, Hk, Sq, Sk;
  float scale;
  int causal;
};

// e^x. For bf16 inputs through exp2f (a multiply, then the
// special-function unit): the accurate expf takes several more
// instructions per score, and its extra accuracy is far below bf16's
// rounding. fp32 inputs keep expf, as the plain versions do.
template <typename T>
__device__ __forceinline__ float exp_of(float x);
template <>
__device__ __forceinline__ float exp_of<float>(float x) { return expf(x); }
template <>
__device__ __forceinline__ float exp_of<__nv_bfloat16>(float x) {
  return exp2f(x * kLog2e);
}

template <int NT, int K>
__device__ __forceinline__ void gemm_abt(float (&acc)[NT][4], const float* A,
                                         int lda, const float* Bm, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float b0 = Bm[(nt * 8 + 2 * t) * ldb + k];
      const float b1 = Bm[(nt * 8 + 2 * t + 1) * ldb + k];
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

template <int KT, int NT>
__device__ __forceinline__ void gemm_pb(float (&acc)[NT][4],
                                        const float (&p)[KT][4],
                                        const float* Bm, int ldb) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 8 * KT; ++k) {
    // P[g][k] and P[g+8][k] live in the quad's lane holding column k % 8
    const int src = (lane & ~3) | ((k & 7) >> 1);
    const float p0 = __shfl_sync(kFull, p[k >> 3][k & 1], src);
    const float p1 = __shfl_sync(kFull, p[k >> 3][2 + (k & 1)], src);
    const float* b = Bm + k * ldb + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float b0 = b[nt * 8], b1 = b[nt * 8 + 1];
      acc[nt][0] = fmaf(p0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(p0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(p1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(p1, b1, acc[nt][3]);
    }
  }
}

// Starts the copy of rows [row0, row0 + R) of an operand whose row r
// starts at base + r * rs into s (row stride row_ld), as 16-byte cp.async
// pieces; rows at or past S are zero-filled. The caller commits and waits.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ base,
                                          size_t rs, int row0, int S) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = D / kPer;
  constexpr int LD = row_ld<T, D>();
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, e = (c % kChunks) * kPer;
    const bool valid = row0 + r < S;
    cp_async16(s + r * LD + e, valid ? base + (row0 + r) * rs + e : base,
               valid);
  }
}

// The first tile start in [t0, t_end), stepping by W (a multiple of 32), whose
// segment ids ids[start, start + W) can meet [lo, hi]; t_end when none.
// Every lane of the warp computes it (the ranges are warp reductions).
template <int W>
__device__ __forceinline__ int next_tile(const int* ids, int S, int t0,
                                         int t_end, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  for (int t = t0; t < t_end; t += W) {
    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int j = lane; j < W; j += 32) {
      if (t + j < S) {
        mn = min(mn, ids[t + j]);
        mx = max(mx, ids[t + j]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(kFull, mn, o));
      mx = max(mx, __shfl_xor_sync(kFull, mx, o));
    }
    if (mx >= lo && mn <= hi) return t;
  }
  return t_end;
}

// [lo, hi] of ids[0, n) (n > 0), read by every thread.
__device__ __forceinline__ void id_range(const int* ids, int n, int& lo,
                                         int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = 0; i < n; ++i) {
    lo = min(lo, ids[i]);
    hi = max(hi, ids[i]);
  }
}

// Scales accumulator-layout scores s (this thread's rows row[0], row[1];
// columns col0 + 8 n + 2 (lane % 4) + {0, 1}) and sets those of invisible
// (query, key) pairs to -1e30. Rows are queries and columns keys, or the
// other way round (dk/dv). seg_col holds the columns' segment ids from
// col0 on. A tile the caller knows to be wholly visible skips the test.
template <int N>
__device__ __forceinline__ void scale_mask(float (&s)[N][4], const Args& a,
                                           bool interior, bool rows_are_queries,
                                           const int (&row)[2], int col0,
                                           const int (&seg_row)[2],
                                           const int* seg_col) {
  const int t = threadIdx.x & 3;
  const int off = a.Sk - a.Sq;
  const bool seg = a.seg_q != nullptr;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (interior) {
        s[n][e] *= a.scale;
        continue;
      }
      const int r = row[e >> 1], cl = n * 8 + 2 * t + (e & 1), c = col0 + cl;
      const int i = rows_are_queries ? r : c, j = rows_are_queries ? c : r;
      bool vis = i < a.Sq && j < a.Sk && (!a.causal || j <= i + off);
      if (seg) vis = vis && seg_row[e >> 1] == seg_col[cl];
      s[n][e] = vis ? s[n][e] * a.scale : kNegInf;
    }
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  return (kRows + 4 * kKeys) * row_ld<T, D>() * sizeof(T) +
         2 * kKeys * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int LD = row_ld<T, D>();
  constexpr int NT = kKeys / 8, DT = D / 8;
  constexpr int kTile = kKeys * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* kv_s = q_s + kRows * LD;  // [2 buffers][K, V] tiles
  int* segk_s = reinterpret_cast<int*>(kv_s + 4 * kTile);  // [2][kKeys]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kh = h / (a.H / a.Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = a.Sk - a.Sq;
  const bool seg = a.seg_q != nullptr;
  const size_t q_rs = static_cast<size_t>(a.H) * D;
  const size_t kv_rs = static_cast<size_t>(a.Hk) * D;
  const T* qb = static_cast<const T*>(a.q) + static_cast<size_t>(b) * a.Sq * q_rs + h * D;
  const T* kb = static_cast<const T*>(a.k) + static_cast<size_t>(b) * a.Sk * kv_rs + kh * D;
  const T* vb = static_cast<const T*>(a.v) + static_cast<size_t>(b) * a.Sk * kv_rs + kh * D;
  const int* segk = seg ? a.seg_k + static_cast<size_t>(b) * a.Sk : nullptr;

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int last = min(q0 + kRows, a.Sq);
  int sq[2] = {0, 0}, qlo = 0, qhi = 0;
  if (seg) {
    const int* ids = a.seg_q + static_cast<size_t>(b) * a.Sq;
    for (int i = 0; i < 2; ++i) sq[i] = row[i] < a.Sq ? ids[row[i]] : 0;
    id_range(ids + q0, last - q0, qlo, qhi);
  }
  const int k_end = a.causal ? min(a.Sk, last - 1 + off + 1) : a.Sk;

  // the next visible key tile's K, V (and ids) start loading while the
  // current one is in use
  auto issue = [&](int k0, int buf) {
    load_tile<T, D, kKeys>(kv_s + (2 * buf) * kTile, kb, kv_rs, k0, a.Sk);
    load_tile<T, D, kKeys>(kv_s + (2 * buf + 1) * kTile, vb, kv_rs, k0, a.Sk);
    if (seg && threadIdx.x < kKeys)
      segk_s[buf * kKeys + threadIdx.x] =
          k0 + threadIdx.x < a.Sk ? segk[k0 + threadIdx.x] : 0;
  };
  load_tile<T, D, kRows>(q_s, qb, q_rs, q0, a.Sq);
  int k0 = seg ? next_tile<kKeys>(segk, a.Sk, 0, k_end, qlo, qhi) : 0;
  if (k0 < k_end) issue(k0, 0);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
  zero(acc);

  for (int buf = 0; k0 < k_end; buf ^= 1) {
    const int k_next = seg ? next_tile<kKeys>(segk, a.Sk, k0 + kKeys, k_end, qlo, qhi)
                           : k0 + kKeys;
    if (k_next < k_end) {
      issue(k_next, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and q) landed for every thread
    const T* k_s = kv_s + (2 * buf) * kTile;
    const T* v_s = kv_s + (2 * buf + 1) * kTile;
    const int* sk = segk_s + buf * kKeys;

    float s[NT][4];
    zero(s);
    gemm_abt<NT, D>(s, q_s + warp * 16 * LD, LD, k_s, LD);

    const bool interior = !seg && q0 + kRows <= a.Sq && k0 + kKeys <= a.Sk &&
                          (!a.causal || k0 + kKeys - 1 <= q0 + off);
    scale_mask(s, a, interior, true, row, k0, sq, sk);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp_of<T>(m[i] - mx[i]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] <= kMaskedBelow ? 0.f : exp_of<T>(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + quad_sum(rsum[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];
    gemm_pb<NT, DT>(acc, s, v_s, LD);
    __syncthreads();  // everyone is done with this buffer before its refill
    k0 = k_next;
  }
  cp_async_wait<0>();

  T* ob = static_cast<T*>(a.out) + static_cast<size_t>(b) * a.Sq * q_rs + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= a.Sq) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    T* o = ob + row[i] * q_rs + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      store2(o + d * 8, acc[d][2 * i] / safe, acc[d][2 * i + 1] / safe);
    if (t == 0)
      a.lse_out[(static_cast<size_t>(b) * a.H + h) * a.Sq + row[i]] =
          m[i] + logf(safe);
  }
}

template <typename T, int D>
constexpr size_t dq_smem() {
  return (2 * kRows + 4 * kKeys) * row_ld<T, D>() * sizeof(T) +
         2 * kKeys * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = row_ld<T, D>();
  constexpr int NT = kKeys / 8, DT = D / 8;
  constexpr int kTile = kKeys * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kRows * LD;
  T* kv_s = do_s + kRows * LD;  // [2 buffers][K, V] tiles
  int* segk_s = reinterpret_cast<int*>(kv_s + 4 * kTile);  // [2][kKeys]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kh = h / (a.H / a.Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = a.Sk - a.Sq;
  const bool seg = a.seg_q != nullptr;
  const size_t q_rs = static_cast<size_t>(a.H) * D;
  const size_t kv_rs = static_cast<size_t>(a.Hk) * D;
  const size_t q_base = static_cast<size_t>(b) * a.Sq * q_rs + h * D;
  const T* kb = static_cast<const T*>(a.k) + static_cast<size_t>(b) * a.Sk * kv_rs + kh * D;
  const T* vb = static_cast<const T*>(a.v) + static_cast<size_t>(b) * a.Sk * kv_rs + kh * D;
  const int* segk = seg ? a.seg_k + static_cast<size_t>(b) * a.Sk : nullptr;

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int last = min(q0 + kRows, a.Sq);
  float lse[2], delta[2];
  const size_t stat = (static_cast<size_t>(b) * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = row[i] < a.Sq ? a.lse[stat + row[i]] : 0.f;
    delta[i] = row[i] < a.Sq ? a.delta[stat + row[i]] : 0.f;
  }
  int sq[2] = {0, 0}, qlo = 0, qhi = 0;
  if (seg) {
    const int* ids = a.seg_q + static_cast<size_t>(b) * a.Sq;
    for (int i = 0; i < 2; ++i) sq[i] = row[i] < a.Sq ? ids[row[i]] : 0;
    id_range(ids + q0, last - q0, qlo, qhi);
  }
  const int k_end = a.causal ? min(a.Sk, last - 1 + off + 1) : a.Sk;

  auto issue = [&](int k0, int buf) {
    load_tile<T, D, kKeys>(kv_s + (2 * buf) * kTile, kb, kv_rs, k0, a.Sk);
    load_tile<T, D, kKeys>(kv_s + (2 * buf + 1) * kTile, vb, kv_rs, k0, a.Sk);
    if (seg && threadIdx.x < kKeys)
      segk_s[buf * kKeys + threadIdx.x] =
          k0 + threadIdx.x < a.Sk ? segk[k0 + threadIdx.x] : 0;
  };
  load_tile<T, D, kRows>(q_s, static_cast<const T*>(a.q) + q_base, q_rs, q0, a.Sq);
  load_tile<T, D, kRows>(do_s, static_cast<const T*>(a.dout) + q_base, q_rs, q0, a.Sq);
  int k0 = seg ? next_tile<kKeys>(segk, a.Sk, 0, k_end, qlo, qhi) : 0;
  if (k0 < k_end) issue(k0, 0);
  cp_async_commit();

  float dq[DT][4];
  zero(dq);

  for (int buf = 0; k0 < k_end; buf ^= 1) {
    const int k_next = seg ? next_tile<kKeys>(segk, a.Sk, k0 + kKeys, k_end, qlo, qhi)
                           : k0 + kKeys;
    if (k_next < k_end) {
      issue(k_next, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_s = kv_s + (2 * buf) * kTile;
    const T* v_s = kv_s + (2 * buf + 1) * kTile;
    const int* sk = segk_s + buf * kKeys;

    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    gemm_abt<NT, D>(s, q_s + warp * 16 * LD, LD, k_s, LD);
    gemm_abt<NT, D>(dp, do_s + warp * 16 * LD, LD, v_s, LD);
    const bool interior = !seg && q0 + kRows <= a.Sq && k0 + kKeys <= a.Sk &&
                          (!a.causal || k0 + kKeys - 1 <= q0 + off);
    scale_mask(s, a, interior, true, row, k0, sq, sk);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] <= kMaskedBelow ? 0.f : exp_of<T>(s[n][e] - lse[e >> 1]);
        s[n][e] = p * (dp[n][e] - delta[e >> 1]) * a.scale;  // ds
      }
    gemm_pb<NT, DT>(dq, s, k_s, LD);
    __syncthreads();
    k0 = k_next;
  }
  cp_async_wait<0>();

  T* o = static_cast<T*>(a.dq) + q_base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= a.Sq) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      store2(o + row[i] * q_rs + d * 8 + 2 * t, dq[d][2 * i], dq[d][2 * i + 1]);
  }
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  return (2 * kRows + 4 * kQTile) * row_ld<T, D>() * sizeof(T) +
         2 * 3 * kQTile * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Args a) {
  constexpr int LD = row_ld<T, D>();
  constexpr int NQ = kQTile / 8, DT = D / 8;
  constexpr int kTile = kQTile * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kRows * LD;
  T* qd_s = v_s + kRows * LD;  // [2 buffers][Q, dO] tiles
  float* stat_s = reinterpret_cast<float*>(qd_s + 4 * kTile);  // [2][lse, delta, seg]

  const int b = blockIdx.z, kh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int G = a.H / a.Hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = a.Sk - a.Sq;
  const bool seg = a.seg_q != nullptr;
  const size_t q_rs = static_cast<size_t>(a.H) * D;
  const size_t kv_rs = static_cast<size_t>(a.Hk) * D;
  const size_t kv_base = static_cast<size_t>(b) * a.Sk * kv_rs + kh * D;
  const int* segq = seg ? a.seg_q + static_cast<size_t>(b) * a.Sq : nullptr;

  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  int sk[2] = {0, 0}, klo = 0, khi = 0;
  if (seg) {
    const int* ids = a.seg_k + static_cast<size_t>(b) * a.Sk;
    for (int i = 0; i < 2; ++i) sk[i] = key[i] < a.Sk ? ids[key[i]] : 0;
    id_range(ids + k0, min(k0 + kRows, a.Sk) - k0, klo, khi);
  }
  // steps n = 0 .. G * nq - 1 walk the G query heads of kv head kh
  // (n / nq) and, for each, the query tiles from the first row that sees
  // any key of the tile (i_first + (n % nq) * kQTile)
  const int i_first = (a.causal ? max(0, k0 - off) : 0) / kQTile * kQTile;
  const int nq = (a.Sq - i_first + kQTile - 1) / kQTile;
  const int n_end = G * nq;
  // the segment test does not depend on the head
  const int first_hit =
      seg ? next_tile<kQTile>(segq, a.Sq, i_first, a.Sq, klo, khi) : i_first;
  auto next_step = [&](int n) {
    if (!seg || n >= n_end) return n;
    const int tile = i_first + (n % nq) * kQTile;
    const int hit = next_tile<kQTile>(segq, a.Sq, tile, a.Sq, klo, khi);
    if (hit < a.Sq) return n + (hit - tile) / kQTile;
    const int head_next = (n / nq + 1) * nq;
    if (head_next >= n_end || first_hit >= a.Sq) return n_end;
    return head_next + (first_hit - i_first) / kQTile;
  };
  auto issue = [&](int n, int buf) {
    const int h = kh * G + n / nq, i0 = i_first + (n % nq) * kQTile;
    const size_t q_base = static_cast<size_t>(b) * a.Sq * q_rs + h * D;
    load_tile<T, D, kQTile>(qd_s + (2 * buf) * kTile,
                            static_cast<const T*>(a.q) + q_base, q_rs, i0, a.Sq);
    load_tile<T, D, kQTile>(qd_s + (2 * buf + 1) * kTile,
                            static_cast<const T*>(a.dout) + q_base, q_rs, i0, a.Sq);
    if (threadIdx.x < kQTile) {
      const int i = i0 + threadIdx.x;
      const bool in = i < a.Sq;
      const size_t stat = (static_cast<size_t>(b) * a.H + h) * a.Sq;
      float* st = stat_s + buf * 3 * kQTile;
      st[threadIdx.x] = in ? a.lse[stat + i] : 0.f;
      st[kQTile + threadIdx.x] = in ? a.delta[stat + i] : 0.f;
      reinterpret_cast<int*>(st)[2 * kQTile + threadIdx.x] = seg && in ? segq[i] : 0;
    }
  };
  load_tile<T, D, kRows>(k_s, static_cast<const T*>(a.k) + kv_base, kv_rs, k0, a.Sk);
  load_tile<T, D, kRows>(v_s, static_cast<const T*>(a.v) + kv_base, kv_rs, k0, a.Sk);
  int n = next_step(0);
  if (n < n_end) issue(n, 0);
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
  zero(dk);
  zero(dv);

  for (int buf = 0; n < n_end; buf ^= 1) {
    const int n_next = next_step(n + 1);
    if (n_next < n_end) {
      issue(n_next, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = i_first + (n % nq) * kQTile;
    const T* q_s = qd_s + (2 * buf) * kTile;
    const T* do_s = qd_s + (2 * buf + 1) * kTile;
    const float* lse_s = stat_s + buf * 3 * kQTile;
    const float* delta_s = lse_s + kQTile;
    const int* segq_s = reinterpret_cast<const int*>(lse_s + 2 * kQTile);

    // this warp's 16 keys against the tile's queries: s^T = k . q^T
    float s[NQ][4], dp[NQ][4];
    zero(s);
    zero(dp);
    gemm_abt<NQ, D>(s, k_s + warp * 16 * LD, LD, q_s, LD);
    const bool interior = !seg && i0 + kQTile <= a.Sq && k0 + kRows <= a.Sk &&
                          (!a.causal || k0 + kRows - 1 <= i0 + off);
    scale_mask(s, a, interior, false, key, i0, sk, segq_s);
#pragma unroll
    for (int nn = 0; nn < NQ; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = nn * 8 + 2 * t + (e & 1);
        s[nn][e] = s[nn][e] <= kMaskedBelow ? 0.f : exp_of<T>(s[nn][e] - lse_s[il]);  // p^T
      }
    gemm_pb<NQ, DT>(dv, s, do_s, LD);                         // dv += p^T . dO
    gemm_abt<NQ, D>(dp, v_s + warp * 16 * LD, LD, do_s, LD);  // dp^T = v . dO^T
#pragma unroll
    for (int nn = 0; nn < NQ; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = nn * 8 + 2 * t + (e & 1);
        s[nn][e] = s[nn][e] * (dp[nn][e] - delta_s[il]) * a.scale;  // ds^T
      }
    gemm_pb<NQ, DT>(dk, s, q_s, LD);                          // dk += ds^T . q
    __syncthreads();
    n = n_next;
  }
  cp_async_wait<0>();

  T* dkb = static_cast<T*>(a.dk) + kv_base;
  T* dvb = static_cast<T*>(a.dv) + kv_base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= a.Sk) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const size_t at = key[i] * kv_rs + d * 8 + 2 * t;
      store2(dkb + at, dk[d][2 * i], dk[d][2 * i + 1]);
      store2(dvb + at, dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

enum Which { kFwd, kDq, kDkv };

template <typename T, int D>
int launch(Which which, const Args& a, cudaStream_t stream) {
  const dim3 block(kThreads);
  void (*kernel)(const Args);
  size_t smem;
  dim3 grid;
  if (which == kFwd) {
    kernel = flash_fwd_kernel<T, D>;
    smem = fwd_smem<T, D>();
    grid = dim3((a.Sq + kRows - 1) / kRows, a.H, a.B);
  } else if (which == kDq) {
    kernel = flash_bwd_dq_kernel<T, D>;
    smem = dq_smem<T, D>();
    grid = dim3((a.Sq + kRows - 1) / kRows, a.H, a.B);
  } else {
    kernel = flash_bwd_dkv_kernel<T, D>;
    smem = dkv_smem<T, D>();
    grid = dim3((a.Sk + kRows - 1) / kRows, a.Hk, a.B);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Which which, const Args& a, int D, int dtype, void* stream) {
  if (a.B <= 0 || a.Hk <= 0 || a.H % a.Hk != 0 || a.Sq < 0 || a.Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((which == kDkv ? a.Sk : a.Sq) == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<float, 64>(which, a, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(which, a, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(which, a, s);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(which, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* v, const void* seg_q,
               const void* seg_k, int B, int H, int Hk, int Sq, int Sk,
               float scale, int causal) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.B = B;
  a.H = H;
  a.Hk = Hk;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs
// alike); D is 64 or 128. Every tensor is contiguous: q/out/dout/dq
// [B, Sq, H, D], k/v/dk/dv [B, Sk, Hk, D], lse/delta [B, H, Sq] fp32,
// seg_q [B, Sq] / seg_k [B, Sk] int32 or both null. Each returns
// cudaGetLastError() after its launch.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* seg_q, const void* seg_k, void* out,
                                void* lse, int B, int H, int Hk, int Sq, int Sk,
                                int D, float scale, int causal, int dtype,
                                void* stream) {
  Args a = make_args(q, k, v, seg_q, seg_k, B, H, Hk, Sq, Sk, scale, causal);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return dispatch(kFwd, a, D, dtype, stream);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* seg_q,
                                   const void* seg_k, void* dq, int B, int H,
                                   int Hk, int Sq, int Sk, int D, float scale,
                                   int causal, int dtype, void* stream) {
  Args a = make_args(q, k, v, seg_q, seg_k, B, H, Hk, Sq, Sk, scale, causal);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  return dispatch(kDq, a, D, dtype, stream);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, const void* seg_q,
                                    const void* seg_k, void* dk, void* dv, int B,
                                    int H, int Hk, int Sq, int Sk, int D,
                                    float scale, int causal, int dtype,
                                    void* stream) {
  Args a = make_args(q, k, v, seg_q, seg_k, B, H, Hk, Sq, Sk, scale, causal);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return dispatch(kDkv, a, D, dtype, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

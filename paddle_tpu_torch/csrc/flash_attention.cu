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
//     keys 1); a row whose sum l is 0 outputs 0 with lse = -1e30;
//   * dq:  p = exp(s - lse) (0 where s <= -5e29), dp = dO . v,
//          ds = p * (dp - delta) * scale, dq = sum_k ds . k, in q's dtype;
//   * dkv: dv = sum_q p^T . dO and dk = sum_q ds^T . q in fp32, summed over
//          the G query heads of each kv head, then cast to k/v's dtype.
//
// What bounds them on the H100: operations. At the training step's shape
// (B 8, S 2048, H 16, D 128, causal) the forward does 4*D flops per visible
// (query, key) pair, dq 6*D, dk/dv 8*D, on ~1.5 MB of q/k/v per (b, h) read
// once: hundreds of flops per byte, far above the card's ~295 flops/byte
// bf16 ridge. So the products have to run on the tensor cores at wgmma's
// rate, and the softmax's scalar work (an exp per score) has to hide behind
// them.
//
// Two routes:
//  * bf16 (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
//    wgmma fed by TMA through an mbarrier ring, the helpers in
//    sm90_common.cuh. A block is three warpgroups: one producer warp issues
//    every TMA load (128-byte swizzle, rows past S zero-filled by TMA) into a
//    ring of stages, each with a "full" barrier (transaction bytes) and an
//    "empty" one (one arrival per consumer warp), and writes beside each
//    stage the tile's start (-1: no more tiles) after the causal limit and
//    the segment skip, so consumers never recompute the sequence; two
//    consumer warpgroups run the products.
//      Forward: 128 query rows per block, 64 per consumer; 128-key K/V
//    stages (2; 3 at D 64), each taken as two 64-key sub-tiles, so s (32 registers)
//    sits beside o (64) and no wgmma chain is serialised: with 128-key
//    products ptxas, which holds a 384-thread block to 168 registers a
//    thread, serialised every wgmma. s = q . k^T from shared memory (both
//    K-major), o += p . v with p from registers (bf16, the accumulator
//    layout) and V MN-major. Online softmax in log2 units (scale folded
//    into one FFMA per score, ex2.approx.ftz), partial max/sum chains kept
//    short. Query tiles are
//    the fastest grid dimension, heaviest first within a head, so the
//    blocks in flight share few heads' K/V in L2.
//      dq: the forward's block, grid and key-tile sequence (the same
//    producer), with dO loaded once beside Q. Per 64-key sub-tile a
//    consumer computes s = q . k^T and dp = dO . v^T (two commit groups, so
//    p is computed while dp's products run), p = 2^(s scale log2e - lse
//    log2e), ds = p (dp - delta) in registers, and dq += ds . k with ds from
//    registers (bf16) and K read MN-major from the same stage, as the
//    forward reads V. s, dp (32 registers each) and dq (64 at D 128) fit the
//    168. scale multiplies dq once, in the epilogue. Each block owns its dq
//    rows: no atomics, the same bits on every run.
//      dk/dv: 64 keys per block, K and V loaded once; 64-row (Q, dO) tiles
//    of every query head of the group from the first row that sees the
//    block, 3 stages, lse and delta loaded by the producer one step ahead.
//    dk and dv (64 x D fp32 each) cannot share a thread's registers with
//    the score tiles, so the two consumers split by output: the dV
//    warpgroup computes s^T = k . q^T, p^T, hands p^T (fp32) to the other
//    through shared memory (named barriers), and sums dv += p^T . dO; the
//    dK warpgroup computes dp^T = v . dO^T, ds^T, and sums dk += ds^T . q.
//    GQA is folded in registers and no atomics are used: dk and dv are the
//    same bits on every run. Key blocks are the fastest grid dimension.
//  * fp32 (flash_fwd_fp32_kernel, flash_bwd_dq_fp32_kernel,
//    flash_bwd_dkv_fp32_kernel): the full-fp32 parity paths (wgmma on fp32
//    would be TF32). One block of 4 warps per 64-row (fwd, dq) or 64-key
//    (dk/dv) tile walks 32-row tiles of the other side double-buffered with
//    cp.async; each warp owns 16 rows and every product is one of two
//    warp-level FMA forms in mma.sync's m16n8 accumulator layout (row g =
//    lane/4 and g + 8, columns 2*(lane%4) + {0, 1} of each 8-wide tile):
//      gemm_abt: acc[16 x N] += A[16 x K] . B[N x K]^T  (both K-contiguous),
//      gemm_pb:  acc[16 x N] += P[16 x K] . B[K x N]    (P in accumulator
//                registers, B N-contiguous).
//    Shared rows are padded by 16 bytes.
// Every route masks ragged edges itself and takes any S; a tile wholly
// visible (inside the causal limit, no ragged edge, no segments) skips the
// per-element mask; with segments on, a tile whose id range cannot meet
// the other side's is never loaded (the TPU version's _seg_overlap gate).

#include <climits>

#include "mma_common.cuh"
#include "sm90_common.cuh"

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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_fp32_kernel(const Args a) {
  using T = float;
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
      alpha[i] = expf(m[i] - mx[i]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] <= kMaskedBelow ? 0.f : expf(s[n][e] - mx[e >> 1]);
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fp32_kernel(const Args a) {
  using T = float;
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
        const float p = s[n][e] <= kMaskedBelow ? 0.f : expf(s[n][e] - lse[e >> 1]);
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_fp32_kernel(const Args a) {
  using T = float;
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
        s[nn][e] = s[nn][e] <= kMaskedBelow ? 0.f : expf(s[nn][e] - lse_s[il]);  // p^T
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

// ---------------------------------------------------------------------------
// bf16 forward and dk/dv: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kWg = 128;                  // threads of a warpgroup
constexpr int kTmaThreads = 3 * kWg;      // producer + two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg
constexpr int kBlockRows = 128;           // query rows a forward block owns
constexpr int kFwdKeys = 128;             // keys per forward tile (stage)
constexpr int kFwdSub = 64;               // keys per forward product
constexpr int kDkvKeys = 64;              // keys a dk/dv block owns
constexpr int kDkvRows = 64;              // query rows per dk/dv tile
// named barriers (0 is __syncthreads): the dk/dv kernel's p^T buffers
constexpr int kPReady = 1, kPFree = 3;
constexpr int kHalfRow = 128;             // bytes of one row of a 64-column half
constexpr uint32_t kSbo = 8 * kHalfRow;   // 8-row swizzle atom


template <int D>
struct FwdSmem {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr bool kDout = false;  // no dO tile beside Q
  alignas(1024) __nv_bfloat16 q[kBlockRows * D];
  alignas(1024) __nv_bfloat16 k[kStages][kFwdKeys * D];
  alignas(1024) __nv_bfloat16 v[kStages][kFwdKeys * D];
  int segk[kStages][kFwdKeys];
  int kstart[kStages];  // the stage's first key, -1: no more tiles
  uint64_t q_full, full[kStages], empty[kStages];
};

// dq: the forward's ring with dO beside Q. At D 128: Q 32 KB + dO 32 KB +
// 2 stages x (K 32 + V 32) KB = 192 KB.
template <int D>
struct DqSmem {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr bool kDout = true;
  alignas(1024) __nv_bfloat16 q[kBlockRows * D];
  alignas(1024) __nv_bfloat16 dout[kBlockRows * D];
  alignas(1024) __nv_bfloat16 k[kStages][kFwdKeys * D];
  alignas(1024) __nv_bfloat16 v[kStages][kFwdKeys * D];
  int segk[kStages][kFwdKeys];
  int kstart[kStages];  // the stage's first key, -1: no more tiles
  uint64_t q_full, full[kStages], empty[kStages];
};

template <int D>
struct DkvSmem {
  static constexpr int kStages = 3;
  alignas(1024) __nv_bfloat16 k[kDkvKeys * D];
  alignas(1024) __nv_bfloat16 v[kDkvKeys * D];
  alignas(1024) __nv_bfloat16 q[kStages][kDkvRows * D];
  alignas(1024) __nv_bfloat16 dout[kStages][kDkvRows * D];
  // p^T of a tile from the dV warpgroup to the dK one, fp32 in the
  // accumulator layout: thread t's tile n as a float4 at [n * 128 + t]
  alignas(16) float p[2][kDkvKeys * kDkvRows];
  float lse2[kStages][kDkvRows];  // lse in log2 units
  float delta[kStages][kDkvRows];
  int segq[kStages][kDkvRows];
  int istart[kStages];  // the stage's first query row, -1: no more tiles
  uint64_t kv_full, full[kStages], empty[kStages];
};

template <typename S>
__device__ __forceinline__ S& smem_as() {
  extern __shared__ unsigned char smem_raw[];
  const uintptr_t p = (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023);
  return *reinterpret_cast<S*>(p);
}

// [lo, hi] of ids[0, n) (n > 0) by a warp reduction, in every lane
__device__ __forceinline__ void warp_id_range(const int* ids, int n, int& lo,
                                              int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    lo = min(lo, ids[i]);
    hi = max(hi, ids[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, o));
    hi = max(hi, __shfl_xor_sync(kFull, hi, o));
  }
}

// Loads `halves` 64-column boxes of one tile (rows from `row`) into dst.
template <int Halves>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst, int rows,
                                         const CUtensorMap* map, uint64_t* bar,
                                         int head, int row, int b) {
#pragma unroll
  for (int hf = 0; hf < Halves; ++hf)
    tma_load_4d(dst + hf * rows * 64, map, bar, hf * 64, head, row, b);
}

// The producer of the forward and dq blocks (one warp): Q (and dO, for
// dq) once, then every key tile the block can see, in order, each into the
// next free stage with its start (and its keys' segment ids) beside it;
// then a stage whose start is -1.
template <typename S, int D>
__device__ __forceinline__ void key_producer(S& sm, const Args& a,
                                             const CUtensorMap* tq,
                                             const CUtensorMap* tdo,
                                             const CUtensorMap* tk,
                                             const CUtensorMap* tv, int b,
                                             int h, int q0) {
  constexpr int kH = D / 64;
  constexpr uint32_t kTileBytes = kFwdKeys * D * 2;
  constexpr uint32_t kRowBytes = kBlockRows * D * 2;
  const int lane = threadIdx.x & 31;
  const int kh = h / (a.H / a.Hk);
  const int last = min(q0 + kBlockRows, a.Sq);
  const bool seg = a.seg_q != nullptr;
  if (lane == 0) {
    tma_prefetch_map(tk);
    tma_prefetch_map(tv);
    mbar_expect_tx(&sm.q_full, (S::kDout ? 2 : 1) * kRowBytes);
    tma_tile<kH>(sm.q, kBlockRows, tq, &sm.q_full, h, q0, b);
    if constexpr (S::kDout) tma_tile<kH>(sm.dout, kBlockRows, tdo, &sm.q_full, h, q0, b);
  }
  int qlo = 0, qhi = 0;
  const int* segk = seg ? a.seg_k + static_cast<size_t>(b) * a.Sk : nullptr;
  if (seg) warp_id_range(a.seg_q + static_cast<size_t>(b) * a.Sq + q0, last - q0, qlo, qhi);
  const int k_end = a.causal ? min(a.Sk, last + a.Sk - a.Sq) : a.Sk;
  int k0 = seg ? next_tile<kFwdKeys>(segk, a.Sk, 0, k_end, qlo, qhi) : 0;
  for (int stage = 0, phase = 0;;) {
    const bool done = k0 >= k_end;
    mbar_wait(&sm.empty[stage], phase ^ 1);
    if (!done && seg)
      for (int j = lane; j < kFwdKeys; j += 32)
        sm.segk[stage][j] = k0 + j < a.Sk ? segk[k0 + j] : 0;
    if (lane == 0) {
      sm.kstart[stage] = done ? -1 : k0;
      if (done) {
        mbar_arrive(&sm.full[stage]);
      } else {
        mbar_expect_tx(&sm.full[stage], 2 * kTileBytes);
        tma_tile<kH>(sm.k[stage], kFwdKeys, tk, &sm.full[stage], kh, k0, b);
        tma_tile<kH>(sm.v[stage], kFwdKeys, tv, &sm.full[stage], kh, k0, b);
      }
    } else {
      mbar_arrive(&sm.full[stage]);
    }
    if (done) break;
    k0 = seg ? next_tile<kFwdKeys>(segk, a.Sk, k0 + kFwdKeys, k_end, qlo, qhi)
             : k0 + kFwdKeys;
    if (++stage == S::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The barriers of a forward or dq block's ring, before any thread uses them
template <typename S>
__device__ __forceinline__ void init_key_ring(S& sm) {
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&sm.full[s], 32);      // the producer warp's lanes
      mbar_init(&sm.empty[s], 8);      // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, denormals flushed
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sets the accumulator-layout scores of invisible pairs to -1e30 (rows r of
// this thread see columns [lo[r], hi[r]] of the segment seg_row[r]; columns
// from col0 on, their ids seg_col in shared memory, used when `seg`).
template <int N>
__device__ __forceinline__ void mask_tile(float (&s)[N][4], int col0,
                                          const int (&lo)[2], const int (&hi)[2],
                                          bool seg, const int (&seg_row)[2],
                                          const int* seg_col) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cl = n * 8 + 2 * t + (e & 1), c = col0 + cl, r = e >> 1;
      const bool vis = (c >= lo[r]) & (c <= hi[r]) &
                       (!seg | (seg_row[r] == seg_col[cl]));
      s[n][e] = vis ? s[n][e] : kNegInf;
    }
}

// One forward tile's online softmax on raw scores s (q . k, masked to
// -1e30): the running max m (raw units) and sum l updated, s replaced by
// p = 2^((s - m) scale2), alpha the factor the output so far is to be
// scaled by. Masked scores give p = 0 exactly (`masked`: the tile may hold
// some).
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               float scale2, bool masked) {
  // four independent partial maxima / sums per row: short dependency
  // chains, since one warp per scheduler leaves little latency hidden
  float pm[2][4], ps[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pm[0][j] = pm[1][j] = kNegInf;
    ps[0][j] = ps[1][j] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pm[e >> 1][(n & 1) * 2 + (e & 1)] = fmaxf(pm[e >> 1][(n & 1) * 2 + (e & 1)], s[n][e]);
  float mx[2], base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(fmaxf(fmaxf(pm[i][0], pm[i][1]), fmaxf(pm[i][2], pm[i][3])), m[i]);
    mx[i] = quad_max(mx[i]);
    alpha[i] = ex2((m[i] - mx[i]) * scale2);
    base[i] = mx[i] * scale2;
    m[i] = mx[i];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[n][e], scale2, -base[e >> 1]));
      if (masked) p = s[n][e] <= kMaskedBelow ? 0.f : p;
      s[n][e] = p;
      ps[e >> 1][(n & 1) * 2 + (e & 1)] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = l[i] * alpha[i] + quad_sum((ps[i][0] + ps[i][1]) + (ps[i][2] + ps[i][3]));
}

// A forward consumer warpgroup: 64 query rows (c = 0 or 1 of the block),
// online softmax over the producer's key tiles, each as two 64-key
// sub-tiles: s takes 32 registers beside o's 64, which keeps every wgmma
// chain within the registers ptxas allots (at 128 keys it serialises them).
// The two consumers are not synchronised with each other, so one's softmax
// overlaps the other's products.
template <int D>
__device__ __forceinline__ void fwd_consumer(FwdSmem<D>& sm, const Args& a,
                                             int b, int h, int q0, int c) {
  using S = FwdSmem<D>;
  constexpr int NT = kFwdSub / 8, DT = D / 8;
  constexpr uint32_t kQHalf = kBlockRows * kHalfRow, kKHalf = kFwdKeys * kHalfRow;
  const int tid = threadIdx.x % kWg, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = a.Sk - a.Sq;
  const bool seg = a.seg_q != nullptr;
  const int r0 = q0 + 64 * c;                       // this warpgroup's first row
  const int r_last = min(r0 + 64, a.Sq) - 1;        // < r0: no row here
  const int row[2] = {r0 + 16 * w + g, r0 + 16 * w + g + 8};
  // keys row r may see: [0, hi[r]] (hi < 0: a row past Sq sees none)
  int sq[2] = {0, 0}, lo[2] = {0, 0}, hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    hi[i] = row[i] >= a.Sq ? -1 : a.causal ? min(a.Sk - 1, row[i] + off) : a.Sk - 1;
    if (seg && row[i] < a.Sq) sq[i] = a.seg_q[static_cast<size_t>(b) * a.Sq + row[i]];
  }
  const float scale2 = a.scale * kLog2e;            // exponents in log2 units
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DT][4];
  zero(o);
  uint32_t pa[NT / 2][4];                           // p of the pending sub-tile

  const uint32_t q_at = smem_addr(sm.q) + 64 * c * kHalfRow;
  mbar_wait(&sm.q_full, 0);
  int pending = -1;                   // sub-tile (stage * 2 + half) whose p . v is due
  bool first = true;
  for (int stage = 0, phase = 0, half = 0;;) {
    if (pending >= 0) {
      // o += p . v: A = p (bf16, registers), B = the V sub-tile, MN-major
      const uint32_t v_at = smem_addr(sm.v[pending >> 1]) + (pending & 1) * kFwdSub * kHalfRow;
      fence_acc(o);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc)
        wgmma_rs<1>(o, pa[kc], wgmma_desc(v_at + kc * 16 * kHalfRow, kKHalf, kSbo));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
    }
    if (half == 0 && !first) {
      // the previous stage is through (its last p . v is done): release it
      const int prev = stage == 0 ? S::kStages - 1 : stage - 1;
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[prev]);
    }
    first = false;
    pending = -1;
    if (half == 0) mbar_wait(&sm.full[stage], phase);
    const int kstart = sm.kstart[stage];
    const int k0 = kstart < 0 ? -1 : kstart + half * kFwdSub;
    if (k0 < 0) break;
    if (k0 < a.Sk && r_last >= r0 && (!a.causal || k0 <= r_last + off)) {
      // s = q . k^T: A = this warpgroup's 64 rows of Q, B = the key
      // sub-tile, both K-major
      float s[NT][4];
      const uint32_t k_at = smem_addr(sm.k[stage]) + half * kFwdSub * kHalfRow;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk >> 2) * kQHalf + (kk & 3) * 32;
        const uint32_t bt = (kk >> 2) * kKHalf + (kk & 3) * 32;
        wgmma_ss<0>(s, wgmma_desc(q_at + at, 16, kSbo),
                    wgmma_desc(k_at + bt, 16, kSbo), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);

      const bool interior = !seg && r0 + 64 <= a.Sq && k0 + kFwdSub <= a.Sk &&
                            (!a.causal || k0 + kFwdSub - 1 <= r0 + off);
      if (!interior) mask_tile(s, k0, lo, hi, seg, sq, sm.segk[stage] + half * kFwdSub);
      float alpha[2];
      online_softmax(s, m, l, alpha, scale2, !interior);
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] *= alpha[e >> 1];
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) pack_a(pa[kc], s, kc);
      pending = stage * 2 + half;
    }
    if (++half == 2) {
      half = 0;
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  const size_t q_rs = static_cast<size_t>(a.H) * D;
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) +
                      static_cast<size_t>(b) * a.Sq * q_rs + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= a.Sq) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    __nv_bfloat16* orow = ob + row[i] * q_rs + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      store2(orow + d * 8, o[d][2 * i] / safe, o[d][2 * i + 1] / safe);
    // l == 0: every score masked, m is still -1e30
    if (t == 0)
      a.lse_out[(static_cast<size_t>(b) * a.H + h) * a.Sq + row[i]] =
          l[i] == 0.f ? kNegInf : m[i] * a.scale + logf(l[i]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_kernel(const Args a, const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv) {
  using S = FwdSmem<D>;
  S& sm = smem_as<S>();
  // query tiles fastest, so the blocks in flight share few heads' K/V (in
  // L2); within a head, heaviest (last) tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;
  init_key_ring(sm);
  // roles by warpgroup, warp-uniform to the compiler (a shuffle)
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / kWg, 0);
  if (wg == 0) {
    reg_dealloc<kProducerRegs>();
    if (__shfl_sync(kFull, static_cast<int>(threadIdx.x) / 32, 0) == 0)
      key_producer<S, D>(sm, a, &tq, nullptr, &tk, &tv, b, h, q0);
  } else {
    reg_alloc<kConsumerRegs>();
    fwd_consumer<D>(sm, a, b, h, q0, wg - 1);
  }
}

// A dq consumer warpgroup: 64 query rows (c = 0 or 1 of the block) over
// the producer's key tiles, each as two 64-key sub-tiles. Per sub-tile:
// s = q . k^T and dp = dO . v^T from shared memory (both K-major), p =
// 2^(s scale2 - lse2) (0 where masked), ds = p (dp - delta), dq += ds . k
// with ds from registers (bf16) and the K sub-tile MN-major. dq holds the
// sum of ds . k; scale multiplies it once, at the end.
template <int D>
__device__ __forceinline__ void dq_consumer(DqSmem<D>& sm, const Args& a,
                                            int b, int h, int q0, int c) {
  using S = DqSmem<D>;
  constexpr int NT = kFwdSub / 8, DT = D / 8;
  constexpr uint32_t kQHalf = kBlockRows * kHalfRow, kKHalf = kFwdKeys * kHalfRow;
  const int tid = threadIdx.x % kWg, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = a.Sk - a.Sq;
  const bool seg = a.seg_q != nullptr;
  const int r0 = q0 + 64 * c;                       // this warpgroup's first row
  const int r_last = min(r0 + 64, a.Sq) - 1;        // < r0: no row here
  const int row[2] = {r0 + 16 * w + g, r0 + 16 * w + g + 8};
  const size_t stat = (static_cast<size_t>(b) * a.H + h) * a.Sq;
  // keys row r may see: [0, hi[r]] (hi < 0: a row past Sq sees none); its
  // lse in log2 units and delta
  int sq[2] = {0, 0}, lo[2] = {0, 0}, hi[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < a.Sq;
    hi[i] = !in ? -1 : a.causal ? min(a.Sk - 1, row[i] + off) : a.Sk - 1;
    if (seg && in) sq[i] = a.seg_q[static_cast<size_t>(b) * a.Sq + row[i]];
    lse2[i] = in ? a.lse[stat + row[i]] * kLog2e : 0.f;
    delta[i] = in ? a.delta[stat + row[i]] : 0.f;
  }
  const float scale2 = a.scale * kLog2e;
  float dq[DT][4];
  zero(dq);

  const uint32_t q_at = smem_addr(sm.q) + 64 * c * kHalfRow;
  const uint32_t do_at = smem_addr(sm.dout) + 64 * c * kHalfRow;
  mbar_wait(&sm.q_full, 0);
  for (int stage = 0, phase = 0;;) {
    mbar_wait(&sm.full[stage], phase);
    const int kstart = sm.kstart[stage];
    if (kstart < 0) break;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int k0 = kstart + half * kFwdSub;
      if (k0 >= a.Sk || r_last < r0 || (a.causal && k0 > r_last + off)) continue;
      const uint32_t k_at = smem_addr(sm.k[stage]) + half * kFwdSub * kHalfRow;
      const uint32_t v_at = smem_addr(sm.v[stage]) + half * kFwdSub * kHalfRow;
      // s = q . k^T, then dp = dO . v^T: A = this warpgroup's 64 rows, B
      // the key sub-tile, both K-major; one commit group each
      float s[NT][4], dp[NT][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk >> 2) * kQHalf + (kk & 3) * 32;
        const uint32_t bt = (kk >> 2) * kKHalf + (kk & 3) * 32;
        wgmma_ss<0>(s, wgmma_desc(q_at + at, 16, kSbo),
                    wgmma_desc(k_at + bt, 16, kSbo), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk >> 2) * kQHalf + (kk & 3) * 32;
        const uint32_t bt = (kk >> 2) * kKHalf + (kk & 3) * 32;
        wgmma_ss<0>(dp, wgmma_desc(do_at + at, 16, kSbo),
                    wgmma_desc(v_at + bt, 16, kSbo), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // s is in; dp's products still run
      fence_acc(s);

      const bool interior = !seg && r0 + 64 <= a.Sq && k0 + kFwdSub <= a.Sk &&
                            (!a.causal || k0 + kFwdSub - 1 <= r0 + off);
      if (!interior) mask_tile(s, k0, lo, hi, seg, sq, sm.segk[stage] + half * kFwdSub);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[n][e], scale2, -lse2[e >> 1]));
          // a row with no visible key has lse -1e30: its masked scores
          // would give 2^+huge
          s[n][e] = !interior && s[n][e] <= kMaskedBelow ? 0.f : p;
        }
      wgmma_wait<0>();
      fence_acc(dp);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - delta[e >> 1];  // ds

      // dq += ds . k: A = ds (bf16, registers), B = the key sub-tile MN-major
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) pack_a(pa[kc], s, kc);
      fence_acc(dq);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc)
        wgmma_rs<1>(dq, pa[kc], wgmma_desc(k_at + kc * 16 * kHalfRow, kKHalf, kSbo));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    if (++stage == S::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  const size_t q_rs = static_cast<size_t>(a.H) * D;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq) +
                       static_cast<size_t>(b) * a.Sq * q_rs + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= a.Sq) continue;
    __nv_bfloat16* orow = out + row[i] * q_rs + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      store2(orow + d * 8, dq[d][2 * i] * a.scale, dq[d][2 * i + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_bwd_dq_kernel(const Args a, const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo) {
  using S = DqSmem<D>;
  S& sm = smem_as<S>();
  // the forward's order: query tiles fastest, heaviest first within a head
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;
  init_key_ring(sm);
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / kWg, 0);
  if (wg == 0) {
    reg_dealloc<kProducerRegs>();
    if (__shfl_sync(kFull, static_cast<int>(threadIdx.x) / 32, 0) == 0)
      key_producer<S, D>(sm, a, &tq, &tdo, &tk, &tv, b, h, q0);
  } else {
    reg_alloc<kConsumerRegs>();
    dq_consumer<D>(sm, a, b, h, q0, wg - 1);
  }
}

// The dk/dv producer (one warp): K and V of the block's 64 keys once, then
// the (query head, 64-row query tile) steps that can see them, each step's
// Q and dO tiles into the next free stage with its first row, lse (log2
// units), delta and query segment ids beside it; then a stage whose start
// is -1.
template <int D>
__device__ __forceinline__ void dkv_producer(DkvSmem<D>& sm, const Args& a,
                                             const CUtensorMap* tq,
                                             const CUtensorMap* tk,
                                             const CUtensorMap* tv,
                                             const CUtensorMap* tdo, int b,
                                             int kh, int k0) {
  using S = DkvSmem<D>;
  constexpr int kH = D / 64;
  constexpr uint32_t kTileBytes = kDkvRows * D * 2;
  const int lane = threadIdx.x & 31;
  const int G = a.H / a.Hk;
  const int off = a.Sk - a.Sq;
  const bool seg = a.seg_q != nullptr;
  if (lane == 0) {
    tma_prefetch_map(tq);
    tma_prefetch_map(tdo);
    mbar_expect_tx(&sm.kv_full, 2 * kDkvKeys * D * 2);
    tma_tile<kH>(sm.k, kDkvKeys, tk, &sm.kv_full, kh, k0, b);
    tma_tile<kH>(sm.v, kDkvKeys, tv, &sm.kv_full, kh, k0, b);
  }
  const int* segq = seg ? a.seg_q + static_cast<size_t>(b) * a.Sq : nullptr;
  int klo = 0, khi = 0;
  if (seg)
    warp_id_range(a.seg_k + static_cast<size_t>(b) * a.Sk + k0,
                  min(k0 + kDkvKeys, a.Sk) - k0, klo, khi);
  // steps n = 0 .. G * nq - 1 walk the G query heads of kv head kh (n / nq)
  // and, for each, the query tiles from the first row that sees any key of
  // the block (i_first + (n % nq) * 64)
  const int i_first = (a.causal ? max(0, k0 - off) : 0) / kDkvRows * kDkvRows;
  const int nq = (a.Sq - i_first + kDkvRows - 1) / kDkvRows;
  const int n_end = G * nq;
  const int first_hit =
      seg ? next_tile<kDkvRows>(segq, a.Sq, i_first, a.Sq, klo, khi) : i_first;
  auto next_step = [&](int n) {
    if (!seg || n >= n_end) return n;
    const int tile = i_first + (n % nq) * kDkvRows;
    const int hit = next_tile<kDkvRows>(segq, a.Sq, tile, a.Sq, klo, khi);
    if (hit < a.Sq) return n + (hit - tile) / kDkvRows;
    const int head_next = (n / nq + 1) * nq;
    if (head_next >= n_end || first_hit >= a.Sq) return n_end;
    return head_next + (first_hit - i_first) / kDkvRows;
  };
  // each lane's rows lane and lane + 32 of a step's lse, delta and segment
  // ids, loaded one step ahead so their latency overlaps the wait for a
  // free stage
  constexpr int kPer = kDkvRows / 32;
  float lse_n[kPer], delta_n[kPer];
  int seg_n[kPer];
  auto fetch = [&](int n) {
    const int h = kh * G + n / nq, i0 = i_first + (n % nq) * kDkvRows;
    const size_t stat = (static_cast<size_t>(b) * a.H + h) * a.Sq;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = i0 + lane + 32 * r;
      const bool in = n < n_end && i < a.Sq;
      lse_n[r] = in ? a.lse[stat + i] * kLog2e : 0.f;
      delta_n[r] = in ? a.delta[stat + i] : 0.f;
      seg_n[r] = seg && in ? segq[i] : 0;
    }
  };
  int n = next_step(0);
  fetch(n);
  for (int stage = 0, phase = 0;;) {
    const bool done = n >= n_end;
    mbar_wait(&sm.empty[stage], phase ^ 1);
    const int h = kh * G + n / nq, i0 = i_first + (n % nq) * kDkvRows;
    if (!done) {
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        sm.lse2[stage][lane + 32 * r] = lse_n[r];
        sm.delta[stage][lane + 32 * r] = delta_n[r];
        sm.segq[stage][lane + 32 * r] = seg_n[r];
      }
    }
    if (lane == 0) {
      sm.istart[stage] = done ? -1 : i0;
      if (done) {
        mbar_arrive(&sm.full[stage]);
      } else {
        mbar_expect_tx(&sm.full[stage], 2 * kTileBytes);
        tma_tile<kH>(sm.q[stage], kDkvRows, tq, &sm.full[stage], h, i0, b);
        tma_tile<kH>(sm.dout[stage], kDkvRows, tdo, &sm.full[stage], h, i0, b);
      }
    } else {
      mbar_arrive(&sm.full[stage]);
    }
    if (done) break;
    n = next_step(n + 1);
    fetch(n);
    if (++stage == S::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The dk/dv consumers, both over the block's 64 keys and the producer's
// steps. The dV warpgroup (c = 0): s^T = k . q^T, p^T = exp(s^T - lse),
// handed to the other warpgroup through shared memory, dv += p^T . dO. The
// dK warpgroup (c = 1): dp^T = v . dO^T, ds^T = p^T (dp^T - delta) scale,
// dk += ds^T . q. Each holds one 64 x D fp32 accumulator for the whole
// loop (summed over the G query heads) beside one 64 x 64 score tile.
template <int D>
__device__ __forceinline__ void dkv_consumer(DkvSmem<D>& sm, const Args& a,
                                             int b, int kh, int k0, int c) {
  using S = DkvSmem<D>;
  constexpr int NQ = kDkvRows / 8, DT = D / 8;
  constexpr uint32_t kKHalf = kDkvKeys * kHalfRow, kQHalf = kDkvRows * kHalfRow;
  const int tid = threadIdx.x % kWg, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = a.Sk - a.Sq;
  const bool seg = a.seg_q != nullptr;
  const bool dv_group = c == 0;
  const int k_last = min(k0 + kDkvKeys, a.Sk) - 1;
  const int key[2] = {k0 + 16 * w + g, k0 + 16 * w + g + 8};
  // query rows key r is seen by: [lo[r], Sq - 1] (none for a key past Sk)
  int sk[2] = {0, 0}, lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lo[i] = a.causal ? max(0, key[i] - off) : 0;
    hi[i] = key[i] < a.Sk ? a.Sq - 1 : -1;
    if (seg && key[i] < a.Sk) sk[i] = a.seg_k[static_cast<size_t>(b) * a.Sk + key[i]];
  }
  const float scale2 = a.scale * kLog2e;
  float acc[DT][4];  // dv (c = 0) or dk (c = 1)
  zero(acc);
  // A of the score product: K (dV warpgroup) or V; B: Q or dO
  const uint32_t a_at = smem_addr(dv_group ? sm.k : sm.v);
  int np = 0;  // tiles handed over so far (p buffer np % 2)
  mbar_wait(&sm.kv_full, 0);
  for (int stage = 0, phase = 0;;) {
    mbar_wait(&sm.full[stage], phase);
    const int i0 = sm.istart[stage];
    if (i0 < 0) break;
    if (!a.causal || i0 + kDkvRows - 1 + off >= k0) {
      const uint32_t q_at = smem_addr(sm.q[stage]), do_at = smem_addr(sm.dout[stage]);
      const uint32_t b_at = dv_group ? q_at : do_at;
      float s[NQ][4];  // s^T (then p^T) or dp^T (then ds^T)
      // this thread's 16 query columns of lse2 (dV group) or delta (dK
      // group), read while the product runs
      float stat[NQ][2];
      const float* stat_s = dv_group ? sm.lse2[stage] : sm.delta[stage];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) stat[n][e] = stat_s[n * 8 + 2 * t + e];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk >> 2) * kKHalf + (kk & 3) * 32;
        const uint32_t bt = (kk >> 2) * kQHalf + (kk & 3) * 32;
        wgmma_ss<0>(s, wgmma_desc(a_at + at, 16, kSbo),
                    wgmma_desc(b_at + bt, 16, kSbo), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);

      const int buf = np & 1;
      float* pbuf = sm.p[buf];
      if (dv_group) {
        // p^T = 2^(s^T scale2 - lse2): raw scores, lse in log2 units
        const bool interior = !seg && i0 + kDkvRows <= a.Sq && k0 + kDkvKeys <= a.Sk &&
                              (!a.causal || k0 + kDkvKeys - 1 <= i0 + off);
        if (interior) {
#pragma unroll
          for (int n = 0; n < NQ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = ex2(fmaf(s[n][e], scale2, -stat[n][e & 1]));
        } else {
          mask_tile(s, i0, lo, hi, seg, sk, sm.segq[stage]);
#pragma unroll
          for (int n = 0; n < NQ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = ex2(fmaf(s[n][e], scale2, -stat[n][e & 1]));
              s[n][e] = s[n][e] <= kMaskedBelow ? 0.f : p;
            }
        }
        if (np >= 2) named_sync(kPFree + buf, 2 * kWg);  // the dK group read it
        float4* p4 = reinterpret_cast<float4*>(pbuf);
#pragma unroll
        for (int n = 0; n < NQ; ++n)
          p4[n * kWg + tid] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        named_arrive(kPReady + buf, 2 * kWg);
      } else {
        named_sync(kPReady + buf, 2 * kWg);
        const float4* p4 = reinterpret_cast<const float4*>(pbuf);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const float4 p = p4[n * kWg + tid];
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = pv[e] * (s[n][e] - stat[n][e & 1]) * a.scale;
        }
        named_arrive(kPFree + buf, 2 * kWg);
      }
      ++np;

      // dv += p^T . dO or dk += ds^T . q: A from registers, B MN-major
      uint32_t pa[NQ / 2][4];
#pragma unroll
      for (int kc = 0; kc < NQ / 2; ++kc) pack_a(pa[kc], s, kc);
      const uint32_t v_at = dv_group ? do_at : q_at;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < NQ / 2; ++kc)
        wgmma_rs<1>(acc, pa[kc], wgmma_desc(v_at + kc * 16 * kHalfRow, kQHalf, kSbo));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    if (++stage == S::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // the dK group's last arrival on each p buffer used is matched by a wait
  if (dv_group)
    for (int i = 0; i < min(np, 2); ++i) named_sync(kPFree + i, 2 * kWg);

  const size_t kv_rs = static_cast<size_t>(a.Hk) * D;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dv_group ? a.dv : a.dk) +
                       static_cast<size_t>(b) * a.Sk * kv_rs + kh * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] > k_last) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      store2(out + key[i] * kv_rs + d * 8 + 2 * t, acc[d][2 * i], acc[d][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_bwd_dkv_kernel(const Args a, const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo) {
  using S = DkvSmem<D>;
  S& sm = smem_as<S>();
  // key blocks fastest (the blocks in flight share few heads' Q/dO in L2);
  // causal: the first key blocks see the most query rows, and go first
  const int kh = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kDkvKeys;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / kWg, 0);
  if (wg == 0) {
    reg_dealloc<kProducerRegs>();
    if (__shfl_sync(kFull, static_cast<int>(threadIdx.x) / 32, 0) == 0)
      dkv_producer<D>(sm, a, &tq, &tk, &tv, &tdo, b, kh, k0);
  } else {
    reg_alloc<kConsumerRegs>();
    dkv_consumer<D>(sm, a, b, kh, k0, wg - 1);
  }
}

enum Which { kFwd, kDq, kDkv };

// the cp.async + FMA kernels: fp32 forward, dq and dk/dv
template <int D>
int launch_fp32(Which which, const Args& a, cudaStream_t stream) {
  const dim3 block(kThreads);
  void (*kernel)(const Args);
  size_t smem;
  dim3 grid;
  if (which == kFwd) {
    kernel = flash_fwd_fp32_kernel<D>;
    smem = fwd_smem<float, D>();
    grid = dim3((a.Sq + kRows - 1) / kRows, a.H, a.B);
  } else if (which == kDq) {
    kernel = flash_bwd_dq_fp32_kernel<D>;
    smem = dq_smem<float, D>();
    grid = dim3((a.Sq + kRows - 1) / kRows, a.H, a.B);
  } else {
    kernel = flash_bwd_dkv_fp32_kernel<D>;
    smem = dkv_smem<float, D>();
    grid = dim3((a.Sk + kRows - 1) / kRows, a.Hk, a.B);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// shared memory the launch asks for: the storage plus room to align it
template <typename S>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(S) + 1024);
}
static_assert(smem_bytes<FwdSmem<128>>() <= 232448 && smem_bytes<DqSmem<128>>() <= 232448 &&
                  smem_bytes<DkvSmem<128>>() <= 232448,
              "over the 227 KB of shared memory a block may have");

// the bf16 kernels: tensor maps built here, one block of three warpgroups
// per 128 query rows (forward, dq) or 64 keys (dk/dv)
template <int D>
int launch_tma(Which which, const Args& a, cudaStream_t stream) {
  if (a.Sq == 0 || a.Sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  const int rows_q = which == kDkv ? kDkvRows : kBlockRows;
  const int rows_kv = which == kDkv ? kDkvKeys : kFwdKeys;
  int err = make_map(&tq, a.q, a.B, a.Sq, a.H, D, rows_q);
  if (err == 0) err = make_map(&tk, a.k, a.B, a.Sk, a.Hk, D, rows_kv);
  if (err == 0) err = make_map(&tv, a.v, a.B, a.Sk, a.Hk, D, rows_kv);
  if (err == 0 && which != kFwd) err = make_map(&tdo, a.dout, a.B, a.Sq, a.H, D, rows_q);
  if (err != 0) return err;
  const dim3 block(kTmaThreads);
  const dim3 q_grid((a.Sq + kBlockRows - 1) / kBlockRows, a.H, a.B);
  cudaError_t e;
  if (which == kFwd) {
    const int smem = smem_bytes<FwdSmem<D>>();
    e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) flash_fwd_kernel<D><<<q_grid, block, smem, stream>>>(a, tq, tk, tv);
  } else if (which == kDq) {
    const int smem = smem_bytes<DqSmem<D>>();
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      flash_bwd_dq_kernel<D><<<q_grid, block, smem, stream>>>(a, tq, tk, tv, tdo);
  } else {
    const int smem = smem_bytes<DkvSmem<D>>();
    e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid((a.Sk + kDkvKeys - 1) / kDkvKeys, a.Hk, a.B);
    if (e == cudaSuccess)
      flash_bwd_dkv_kernel<D><<<grid, block, smem, stream>>>(a, tq, tk, tv, tdo);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Which which, const Args& a, int D, int dtype, void* stream) {
  if (a.B <= 0 || a.Hk <= 0 || a.H % a.Hk != 0 || a.Sq < 0 || a.Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((which == kDkv ? a.Sk : a.Sq) == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return launch_tma<64>(which, a, s);
  if (dtype == 1 && D == 128) return launch_tma<128>(which, a, s);
  if (dtype == 0 && D == 64) return launch_fp32<64>(which, a, s);
  if (dtype == 0 && D == 128) return launch_fp32<128>(which, a, s);
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

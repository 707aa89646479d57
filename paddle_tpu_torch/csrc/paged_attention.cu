// Paged decode attention straight off the KV block pool, for Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/kernels/paged_attention.py::_kernel
// (pallas_call at paged_attention.py:254), both entry points:
//   decode  q [M, 1, H, D]                 row attends j <= seq_lens[m]
//   verify  q [M, Q, H, D] + draft_lens    row (qi, g) attends
//                                          j <= seq_lens[m] + min(qi, draft_lens[m])
// over one layer's pool k/v [N, bs, Hk, D] (fp32 / bf16, or int8 with fp32
// per-token-per-head scales [N, bs, Hk] dequantized at load). Slot m's KV
// position j lives in block block_tables[m, j / bs] at offset j % bs.
//
// What bounds it on the H100: bytes. Each (slot, kv head) reads its window's
// K/V and does 4*D flops per (query row, key), far below the card's ~295
// flops/byte ridge, so the K/V stream sets the time.
//
// Design (simple first; not yet fast):
//  * One thread block of 4 warps per (query tile, kv head, slot). The block
//    reads the slot's block table itself and loops over the KV blocks of its
//    window in order, merging them with the online softmax (running max m,
//    sum l and the weighted value sum in registers, all fp32 whatever the
//    pool type). The Pallas (M, Hk, W) grid ran KV blocks in sequence on one
//    TPU core; here that sequence is the loop inside one block.
//  * Query rows of the tile are the Q*G rows (query offset qi, group member g)
//    that share kv head kh (query head h = kh*G + g), 2 rows per warp, 8 per
//    tile: a 256-row mixed-step chunk times G does not fit one block's
//    registers, so it spreads over several tiles.
//  * A single warp walking a window waits on one chain of loads after
//    another, and that wait, not the bytes, was the time of the first
//    version of this kernel. So all 128 threads load each KV block's K and V
//    rows as 16-byte pieces into registers one KV block AHEAD, while the
//    current block is scored out of shared memory: one load latency is paid
//    per KV block, overlapped with the work on the previous one.
//  * Shared memory holds the block's K and V as fp32 (int8 converted, its
//    scales kept beside it and applied to the score and to the weight).
//    V rows past seq_len + draft_len and their scales are stored as 0 — the
//    poison containment contract: NaN in the null block, a freed block or a
//    stale tail never reaches an output, since 0 * NaN would. Masked scores
//    are -1e30 and weigh exactly 0. Rows whose l is 0 output 0.
//  * Lane t of a warp scores key t of the block (bs <= 32); lane d owns dims
//    d, d+32, ... of the value sum (D <= 128, D % 16 == 0 so a row is whole
//    16-byte pieces).
//  * Parallelism is the known weak point: at M = 8 slots and Hk = 16 a
//    decode step launches 128 blocks for 132 SMs, and only one warp of each
//    has a query row. A split over KV blocks with a second merge pass is the
//    first thing a later change adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// The pools must be 16-byte aligned with D % 16 == 0.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* seq_lens, const void* draft_lens, void* out, int M, int Q,
    int H, int Hk, int D, int bs, int W, float scale, int q_dtype,
    int kv_dtype, int out_dtype, void* stream) {
  if (D > kMaxD || D % 16 != 0 || bs > kMaxBlockSize || Hk <= 0 ||
      H % Hk != 0 || W < 1 ||
      (reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || Q == 0) return 0;
  Args a{q, k_pool, v_pool,
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
         static_cast<const int*>(draft_lens), out, M, Q, H, Hk, D, bs, W, scale,
         static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case 0: return launch_kv<float>(a, kv_dtype, out_dtype);
    case 1: return launch_kv<__nv_bfloat16>(a, kv_dtype, out_dtype);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

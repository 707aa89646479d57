// Weight-only int8 matmul for Hopper (sm_90a):
//   out[M, N] = (x[M, K] @ float(w[K, N])) * scale[N]
// x in fp32 or bf16, w int8, fp32 accumulation, the per-column scale applied
// in the epilogue after accumulation, out in fp32 or bf16.
//
// Replaces the Pallas kernel paddle_tpu/kernels/quant_matmul.py::_kernel
// (pallas_call at quant_matmul.py:91). That kernel fell back to XLA when the
// shapes did not divide its 512 blocks (quant_matmul.py:86-87); these mask
// the ragged edges of M, N and K themselves (intermediate 5504 = 43 * 128
// and vocab 32000 both occur on the serving path), so there is no fallback.
//
// Routes, chosen by the wrapper's plan (kernels/quant_matmul.py _plan)
// from x's dtype and M; every one masks ragged M, N and K:
//
//  * bf16 x: weight_only_matmul_tc_kernel, tensor-core tiles of BM x 128
//    outputs, 4 warps, 64-deep K steps on mma.sync.m16n8k16 bf16 with fp32
//    accumulators. x (bf16) and w (int8) move global -> shared as 16-byte
//    cp.async pieces in a ring of 4 stages, one barrier per step, rows and
//    columns out of range zero-filled by the copy's source size. Shared
//    memory, like device memory, only ever holds int8 weights: w's tile is
//    N-contiguous, so its B fragments come through ldmatrix.trans on pairs
//    of int8 columns, one 16-byte row read feeding two column tiles (even
//    and odd columns), and are widened to bf16 in registers, exactly
//    (w_fragments). Shapes whose rows are not whole 16-byte pieces (K % 8
//    or N % 16 not 0: K = 300, N = 129 in the card tests) load their pieces
//    element by element; nothing is refused.
//     - M > 64 (the mixed dispatch and prefill, M = 2048 on the serving
//       path): 128 x 128 tiles, warps of 64 x 64. Bound by operations:
//       2 M flops per weight byte is thousands, far above the card's ~295
//       flops/byte bf16 ridge.
//     - M <= 16 (decode, M = 8 on the path): 16 x 128 tiles, warps of
//       16 x 32; 8 < M <= 64: 64 x 128 tiles, warps of 32 x 64. Bound by
//       bytes: 2 M flops per weight byte is far below the ridge, so the
//       time is the int8 weight stream, and N / 128 tiles alone would
//       leave most of the 132 SMs idle. The plan splits K into spans of
//       whole steps until the grid reaches 2 blocks per SM (M = 8, (K, N)
//       = (5504, 2048): 16 column tiles x 18 spans of 320 rows, where the
//       SIMT kernel launches 32 blocks). Each block writes its fp32 partial
//       tile to wrapper-allocated scratch [splits, M, N], and
//       weight_only_matmul_splitk_sum_kernel adds the partials in split
//       order and applies the scale: the output is the same bits on every
//       run. Rows of the tile past M cost tensor-core issue slots only.
//  * fp32 x: weight_only_matmul_fp32_kernel, the first shared-memory tiled
//    SIMT GEMM in full fp32 FMA (the card tests hold it to 1e-4 of
//    max|ref|): the parity path, chosen by dtype only.
//
// Times on NVIDIA H100 80GB HBM3, 700.00 W: PERF.md section 6, row 2.

#include "mma_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kThreads = 256;

// Route codes, as kernels/quant_matmul.py names them.
enum Route { kFp32 = 0, kTc16 = 1, kTc64 = 2, kTc128 = 3 };

// ---------------------------------------------------------------------------
// fp32 x: shared-memory tiled SIMT GEMM in full fp32
// ---------------------------------------------------------------------------

constexpr int kBK32 = 32;

template <typename TO, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
weight_only_matmul_fp32_kernel(const float* __restrict__ x,
                               const int8_t* __restrict__ w,
                               const float* __restrict__ scale,
                               TO* __restrict__ out, int M, int K, int N) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile/thread mismatch");
  constexpr int kCols = BN / TN;  // threads across the tile's columns
  constexpr int kRows = BM / TM;
  __shared__ float x_s[kBK32][BM + 1];  // transposed: x_s[k][m]
  __shared__ float w_s[kBK32][BN];

  const int tx = threadIdx.x % kCols;
  const int ty = threadIdx.x / kCols;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK32) {
    for (int i = threadIdx.x; i < BM * kBK32; i += kThreads) {
      const int mm = i / kBK32, kk = i % kBK32;  // consecutive threads: along K
      const int gm = m0 + mm, gk = k0 + kk;
      x_s[kk][mm] = gm < M && gk < K ? x[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < kBK32 * BN; i += kThreads) {
      const int kk = i / BN, nn = i % BN;  // consecutive threads: along N
      const int gk = k0 + kk, gn = n0 + nn;
      w_s[kk][nn] = gk < K && gn < N
                        ? static_cast<float>(w[static_cast<size_t>(gk) * N + gn])
                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK32; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = x_s[kk][ty + i * kRows];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = w_s[kk][tx + j * kCols];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * kRows;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * kCols;
      if (gn < N)
        out[static_cast<size_t>(gm) * N + gn] = from_f<TO>(acc[i][j] * scale[gn]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 x: tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcBN = 128, kTcBK = 64, kTcStages = 4;
constexpr int kXLd = kTcBK + 8;   // x tile row stride (bf16): 144 bytes
constexpr int kWLd = kTcBN + 16;  // w tile row stride (int8): 144 bytes

template <int BM>
constexpr size_t tc_smem() {
  return static_cast<size_t>(kTcStages) *
         (BM * kXLd * sizeof(bf16) + kTcBK * kWLd);
}

// Rows [0, BM) x K-columns [k0, k0 + 64) of x and K-rows [k0, k0 + 64) x
// columns [n0, n0 + 128) of w into one ring slot; anything at or past (M,
// k_end, N) reads as 0. VEC: 16-byte cp.async pieces (K % 8 == 0,
// N % 16 == 0, 16-byte aligned bases); otherwise element by element.
template <int BM, bool VEC>
__device__ __forceinline__ void tc_issue(bf16* xs, int8_t* w8,
                                         const bf16* __restrict__ x,
                                         const int8_t* __restrict__ w,
                                         int M, int K, int N, int m0, int n0,
                                         int k0, int k_end) {
  constexpr int XP = kTcBK / 8, WP = kTcBN / 16;  // pieces per row
  for (int c = threadIdx.x; c < BM * XP; c += kTcThreads) {
    const int r = c / XP, e = (c % XP) * 8;
    const int gm = m0 + r, gk = k0 + e;
    bf16* dst = xs + r * kXLd + e;
    const bf16* src = x + static_cast<size_t>(gm) * K + gk;
    if (VEC) {
      const bool valid = gm < M && gk < k_end;
      cp_async16(dst, valid ? src : x, valid);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[i] = gm < M && gk + i < k_end ? src[i] : __float2bfloat16(0.f);
    }
  }
  for (int c = threadIdx.x; c < kTcBK * WP; c += kTcThreads) {
    const int r = c / WP, e = (c % WP) * 16;
    const int gk = k0 + r, gn = n0 + e;
    int8_t* dst = w8 + r * kWLd + e;
    const int8_t* src = w + static_cast<size_t>(gk) * N + gn;
    if (VEC) {
      const bool valid = gk < k_end && gn < N;
      cp_async16(dst, valid ? src : w, valid);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dst[i] = gk < k_end && gn + i < N ? src[i] : static_cast<int8_t>(0);
    }
  }
}

// The int8 B fragments of one 16-deep step of a 32-column group, straight
// from the int8 tile. ldmatrix.trans moves 16-bit units, here pairs of
// neighbouring columns: lane (g = l / 4, t = l % 4) receives, of each of
// its four 8 x 8 matrices (k 0-7 / 8-15 x columns 0-15 / 16-31), the bytes
// w[2t][2g], w[2t][2g + 1], w[2t + 1][2g], w[2t + 1][2g + 1]. Bytes 0 and
// 2 are a k-pair of column 2g, bytes 1 and 3 of column 2g + 1: so each
// matrix feeds two m16n8k16 column tiles, the even and the odd columns of
// its 16, and b[tile] below is tile (h, parity) = (tile / 2, tile % 2),
// whose column g is column 16 h + 2 g + parity of the group.
//
// The bytes widen to bf16 exactly with two masks and one bf16x2
// subtraction: bf16 0x4300 | m is 128 + m for a 7-bit m and 0x4380 is
// 256, so q = (0x4300 | (q & 0x7f)) - (0x4300 | (q & 0x80)).
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ void widen_pairs(uint32_t r, uint32_t& even,
                                            uint32_t& odd) {
  const uint32_t e = __byte_perm(r, 0x43u, 0x4240);  // q0, 0x43, q2, 0x43
  const uint32_t o = __byte_perm(r, 0x43u, 0x4341);  // q1, 0x43, q3, 0x43
  even = bf16x2_sub(e & 0xff7fff7fu, e & 0xff80ff80u);
  odd = bf16x2_sub(o & 0xff7fff7fu, o & 0xff80ff80u);
}

__device__ __forceinline__ void w_fragments(uint32_t (&b)[4][2], const int8_t* w_row) {
  uint32_t r[4];
  ldmatrix_x4_trans(r, w_row);
  widen_pairs(r[0], b[0][0], b[1][0]);  // k 0-7, columns 0-15
  widen_pairs(r[1], b[0][1], b[1][1]);  // k 8-15
  widen_pairs(r[2], b[2][0], b[3][0]);  // k 0-7, columns 16-31
  widen_pairs(r[3], b[2][1], b[3][1]);
}

template <typename TO>
__device__ __forceinline__ void store4(TO* o, const float (&v)[4], const float* s,
                                       int col, int N, bool vec) {
  if (vec && col + 3 < N) {
    if (sizeof(TO) == 4) {
      *reinterpret_cast<float4*>(o) =
          make_float4(v[0] * s[0], v[1] * s[1], v[2] * s[2], v[3] * s[3]);
    } else {
      *reinterpret_cast<uint2*>(o) =
          make_uint2(pack(v[0] * s[0], v[1] * s[1]), pack(v[2] * s[2], v[3] * s[3]));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < N) o[i] = from_f<TO>(v[i] * s[i]);
}

// grid (ceil(M / BM), ceil(N / 128), splits), 4 warps of WM x WN: the
// blocks that share a column strip of w run together, so the strip comes
// from device memory once and from L2 for the other row tiles (vocab
// 32000: 65 MB of int8 weights, more than L2 holds). Block z sums K rows
// [z * span, min(K, (z + 1) * span)). part == nullptr: the
// block writes out (scaled); else its fp32 partial tile at part[z].
template <typename TO, int BM, int WM, int WN, bool VEC>
__global__ void __launch_bounds__(kTcThreads, 2)
weight_only_matmul_tc_kernel(const bf16* __restrict__ x,
                             const int8_t* __restrict__ w,
                             const float* __restrict__ scale,
                             TO* __restrict__ out, float* __restrict__ part,
                             int M, int K, int N, int span) {
  constexpr int kWarpsM = BM / WM, kWarpsN = kTcBN / WN;
  constexpr int MT = WM / 16, GROUPS = WN / 32;  // 16-row tiles, 32-column groups
  static_assert(kWarpsM * kWarpsN == 4 && WN % 32 == 0, "warp layout");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                            // [S][BM][kXLd]
  int8_t* w8 = reinterpret_cast<int8_t*>(xs + kTcStages * BM * kXLd);  // [S][64][kWLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / kWarpsN) * WM, wn0 = (warp % kWarpsN) * WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kTcBN;
  const int k_beg = blockIdx.z * span, k_end = min(K, k_beg + span);
  const int steps = (k_end - k_beg + kTcBK - 1) / kTcBK;

  float acc[MT][GROUPS * 4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) zero(acc[i]);

  auto issue = [&](int step) {
    const int slot = step % kTcStages;
    tc_issue<BM, VEC>(xs + slot * BM * kXLd, w8 + slot * kTcBK * kWLd, x, w,
                      M, K, N, m0, n0, k_beg + step * kTcBK, k_end);
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kTcStages - 2>();
    // this step's tiles landed for every thread, and every warp is done
    // with the slot the next issue refills
    __syncthreads();
    if (step + kTcStages - 1 < steps) issue(step + kTcStages - 1);
    cp_async_commit();
    const int slot = step % kTcStages;
    const bf16* a_row = xs + (slot * BM + wm0 + (lane & 15)) * kXLd + (lane >> 4) * 8;
    const int8_t* b_row = w8 + (slot * kTcBK + (lane & 7) + ((lane >> 3) & 1) * 8) * kWLd +
                          wn0 + (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], a_row + i * 16 * kXLd + kk);
#pragma unroll
      for (int gr = 0; gr < GROUPS; ++gr) {
        uint32_t b[4][2];
        w_fragments(b, b_row + kk * kWLd + gr * 32);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int tt = 0; tt < 4; ++tt)
            mma_bf16(acc[i][gr * 4 + tt], a[i][0], a[i][1], a[i][2], a[i][3],
                     b[tt][0], b[tt][1]);
      }
    }
  }
  cp_async_wait<0>();

  // tiles (h, even) and (h, odd) hold this thread's columns 16 h + 4 t + {0..3}
  const bool vec = (N & 3) == 0;
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm0 + i * 16 + g + 8 * hh;
      if (row >= M) continue;
#pragma unroll
      for (int gr = 0; gr < GROUPS; ++gr)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float(&e)[4] = acc[i][gr * 4 + 2 * h];
          const float(&o)[4] = acc[i][gr * 4 + 2 * h + 1];
          const float v[4] = {e[2 * hh], o[2 * hh], e[2 * hh + 1], o[2 * hh + 1]};
          const int col = n0 + wn0 + gr * 32 + h * 16 + 4 * t;
          if (col >= N) continue;
          if (part != nullptr) {
            store4(part + (static_cast<size_t>(blockIdx.z) * M + row) * N + col, v,
                   ones, col, N, vec);
          } else {
            float s[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) s[c] = col + c < N ? scale[col + c] : 0.f;
            store4(out + static_cast<size_t>(row) * N + col, v, s, col, N, vec);
          }
        }
    }
}

// out[i] = (part[0][i] + part[1][i] + ...) * scale[i % N], in split order;
// the partials' loads go out 8 at a time (L2 latency, not bytes, would
// otherwise set the time).
template <typename TO>
__global__ void __launch_bounds__(kThreads)
weight_only_matmul_splitk_sum_kernel(const float* __restrict__ part,
                                     const float* __restrict__ scale,
                                     TO* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t n_out = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_out) return;
  float v = 0.f;
  int z = 0;
  for (; z + 8 <= splits; z += 8) {
    float p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) p[u] = part[(z + u) * n_out + i];
#pragma unroll
    for (int u = 0; u < 8; ++u) v += p[u];
  }
  for (; z < splits; ++z) v += part[z * n_out + i];
  out[i] = from_f<TO>(v * scale[i % N]);
}

struct Args {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* part;
  int M, K, N, splits, span;
  bool vec;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  // above 48 KB a block's shared memory is opt-in, once per kernel
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(bytes))
             : cudaSuccess;
}

template <typename TO, int BM, int WM, int WN, bool VEC>
cudaError_t launch_tc(const Args& a) {
  auto kernel = weight_only_matmul_tc_kernel<TO, BM, WM, WN, VEC>;
  constexpr size_t bytes = tc_smem<BM>();
  static const cudaError_t opted = allow_smem(kernel, bytes);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((a.M + BM - 1) / BM, (a.N + kTcBN - 1) / kTcBN, a.splits);
  kernel<<<grid, kTcThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.x), a.w, a.scale, static_cast<TO*>(a.out),
      a.splits > 1 ? a.part : nullptr, a.M, a.K, a.N, a.span);
  return cudaGetLastError();
}

template <typename TO, int BM, int WM, int WN>
cudaError_t launch_tc_vec(const Args& a) {
  return a.vec ? launch_tc<TO, BM, WM, WN, true>(a)
               : launch_tc<TO, BM, WM, WN, false>(a);
}

template <typename TO>
cudaError_t launch_bf16(const Args& a, int route) {
  cudaError_t err;
  if (route == kTc16)
    err = launch_tc_vec<TO, 16, 16, 32>(a);
  else if (route == kTc64)
    err = launch_tc_vec<TO, 64, 32, 64>(a);
  else
    err = launch_tc_vec<TO, 128, 64, 64>(a);
  if (err != cudaSuccess || a.splits == 1) return err;
  const size_t n_out = static_cast<size_t>(a.M) * a.N;
  weight_only_matmul_splitk_sum_kernel<TO>
      <<<static_cast<unsigned>((n_out + kThreads - 1) / kThreads), kThreads, 0,
         a.stream>>>(a.part, a.scale, static_cast<TO*>(a.out), a.M, a.N,
                     a.splits);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_fp32(const Args& a) {
  const float* x = static_cast<const float*>(a.x);
  TO* out = static_cast<TO*>(a.out);
  if (a.M <= 16) {
    constexpr int BM = 16, BN = 64;
    const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
    weight_only_matmul_fp32_kernel<TO, BM, BN, 1, 4><<<grid, kThreads, 0, a.stream>>>(
        x, a.w, a.scale, out, a.M, a.K, a.N);
  } else {
    constexpr int BM = 64, BN = 64;
    const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
    weight_only_matmul_fp32_kernel<TO, BM, BN, 4, 4><<<grid, kThreads, 0, a.stream>>>(
        x, a.w, a.scale, out, a.M, a.K, a.N);
  }
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. All operands contiguous row-major.
// route: 0 = fp32 x, 1 / 2 / 3 = tensor-core tiles of 16 (M <= 16), 64
// (M <= 64) or 128 rows, which take bf16 x. splits spans of `span` K rows
// (a multiple of 64; splits * span >= K > (splits - 1) * span);
// splits > 1 needs `partial`, fp32 scratch of [splits, M, N].
extern "C" int weight_only_matmul_launch(const void* x, const void* w,
                                         const void* scale, void* out, int M,
                                         int K, int N, int x_dtype,
                                         int out_dtype, void* partial,
                                         int route, int splits, int span,
                                         void* stream) {
  if (M == 0 || N == 0) return 0;
  const bool bf16_x = x_dtype == 1;
  if (x_dtype < 0 || x_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      route < kFp32 || route > kTc128 || (route == kFp32) == bf16_x ||
      (route == kTc16 && M > 16) || (route == kTc64 && M > 64) || splits < 1 ||
      span < 1 ||
      (splits > 1 && (partial == nullptr || route == kFp32 || route == kTc128)) ||
      (route != kFp32 && (span % kTcBK != 0 ||
                          static_cast<long long>(splits) * span < K ||
                          (splits > 1 &&
                           static_cast<long long>(splits - 1) * span >= K))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
         out, static_cast<float*>(partial), M, K, N, splits,
         route == kFp32 ? K : span,
         K % 8 == 0 && N % 16 == 0 && aligned(x, 16) && aligned(w, 16),
         static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (route == kFp32)
    err = out_dtype == 0 ? launch_fp32<float>(a) : launch_fp32<bf16>(a);
  else
    err = out_dtype == 0 ? launch_bf16<float>(a, route) : launch_bf16<bf16>(a, route);
  return static_cast<int>(err);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Weight-only int8 matmul for Hopper (sm_90a):
//   out[M, N] = (x[M, K] @ float(w[K, N])) * scale[N]
// x in fp32 or bf16, w int8, fp32 accumulation, the per-column scale applied
// in the epilogue after accumulation, out in fp32 or bf16.
//
// Replaces the Pallas kernel paddle_tpu/kernels/quant_matmul.py::_kernel
// (pallas_call at quant_matmul.py:91). That kernel fell back to XLA when the
// shapes did not divide its 512 blocks (quant_matmul.py:86-87); this one masks
// the ragged edges of M, N and K itself (intermediate 5504 = 43 * 128 and
// vocab 32000 both occur on the serving path), so it has no fallback.
//
// What bounds it on the H100: at decode (M = 8) the int8 weight stream — about
// 2*M flops per weight byte, far below the ~295 flops/byte ridge; at prefill
// (M = 2048) the arithmetic. Storing w as int8 halves the bytes of a bf16
// weight, and the dequantization happens in shared memory, so device memory
// only ever carries int8 weights.
//
// Design (simple first; not yet fast): a classic shared-memory tiled SIMT
// GEMM. A block computes a BM x BN output tile; per BK-deep step it stages x
// (converted to fp32) and w (int8 converted to fp32) in shared memory, then
// each of 256 threads accumulates a TM x TN sub-tile in fp32 registers.
// Loads outside M, N or K read as zero. Small M (decode) takes a 16-row tile
// so fewer rows of the tile are wasted. No tensor cores, no TMA, no split-K:
// those are later work, and this kernel's times say how much they are worth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kThreads = 256;
constexpr int kBK = 32;

template <typename TX, typename TO, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
weight_only_matmul_kernel(const TX* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ scale,
                          TO* __restrict__ out, int M, int K, int N) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile/thread mismatch");
  constexpr int kCols = BN / TN;  // threads across the tile's columns
  constexpr int kRows = BM / TM;
  __shared__ float x_s[kBK][BM + 1];  // transposed: x_s[k][m]
  __shared__ float w_s[kBK][BN];

  const int tx = threadIdx.x % kCols;
  const int ty = threadIdx.x / kCols;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int mm = i / kBK, kk = i % kBK;  // consecutive threads: along K
      const int gm = m0 + mm, gk = k0 + kk;
      x_s[kk][mm] = gm < M && gk < K
                        ? to_f(x[static_cast<size_t>(gm) * K + gk])
                        : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * BN; i += kThreads) {
      const int kk = i / BN, nn = i % BN;  // consecutive threads: along N
      const int gk = k0 + kk, gn = n0 + nn;
      w_s[kk][nn] = gk < K && gn < N
                        ? static_cast<float>(w[static_cast<size_t>(gk) * N + gn])
                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
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

template <typename TX, typename TO>
int launch(const void* x, const int8_t* w, const float* scale, void* out,
           int M, int K, int N, cudaStream_t stream) {
  if (M <= 16) {
    constexpr int BM = 16, BN = 64;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    weight_only_matmul_kernel<TX, TO, BM, BN, 1, 4><<<grid, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), w, scale, static_cast<TO*>(out), M, K, N);
  } else {
    constexpr int BM = 64, BN = 64;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    weight_only_matmul_kernel<TX, TO, BM, BN, 4, 4><<<grid, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), w, scale, static_cast<TO*>(out), M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. All operands contiguous row-major.
extern "C" int weight_only_matmul_launch(const void* x, const void* w,
                                         const void* scale, void* out, int M,
                                         int K, int N, int x_dtype,
                                         int out_dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, wq, s, out, M, K, N, st);
  if (x_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, wq, s, out, M, K, N, st);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, wq, s, out, M, K, N, st);
  if (x_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, wq, s, out, M, K, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

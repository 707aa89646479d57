// RMSNorm forward and backward for Hopper (sm_90a), over rows of length d:
//   forward:  rstd = rsqrt(mean(x^2) + eps), out = x * rstd * w
//   backward: xhat = x * rstd, wg = g * w,
//             dx = rstd * (wg - xhat * mean(wg * xhat)),  dw = sum_rows g * xhat
// All arithmetic in fp32; out and dx in x's dtype, dw in w's dtype, rstd fp32.
// x (and g) fp32 or bf16, w fp32 or bf16, in any of the four pairings.
//
// Replaces the Pallas kernels paddle_tpu/kernels/rms_norm.py::_fwd_kernel
// (pallas_call at rms_norm.py:77) and ::_bwd_kernel (pallas_call at :110).
// The TPU backward walks its row blocks in order on one core and carries dw
// in a VMEM block revisited by every grid step. Blocks here run in parallel
// and in no order, so each block writes the fp32 partial of its own rows to
// a scratch row ([n_blocks, d], allocated by the wrapper), and a second small
// kernel sums the partials column by column in a fixed order: dw is the same
// bits on every run, with no atomics.
//
// What bounds it on the H100: bytes. A row is read and written once with ~4
// (forward) or ~10 (backward) fp32 operations per element, far below the
// ~20 operations per byte where fp32 arithmetic would take over. So the
// design reads every element with 16-byte loads where the row length and the
// pointers allow it (a scalar path takes any other d), and keeps the second
// read of a row (after its reduction) in L1/L2 rather than device memory:
// one warp owns one row, so the row a warp re-reads is the one it just read.
// The dw pass re-reads its block's rows from L2 in the column direction.

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

// V consecutive elements moved as one aligned vector (16 bytes of x; 8 to
// 32 bytes of w, by its dtype). The wrapper picks V > 1 only when d is a
// multiple of V and every pointer is aligned to V elements.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = to_f(pk.e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int i = 0; i < V; ++i) pk.e[i] = from_f<T>(v[i]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 8;  // row slices of the dw reduction

// One warp per row. The products round one at a time (__fmul_rn), in the
// order of the plain formula, so the kernel and its plain version differ
// only by the order of the row sum and rsqrtf's last bits.
template <typename TX, typename TW, int V>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    TX* __restrict__ out, float* __restrict__ rstd, int n,
                    int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp: one row per warp
  const TX* xr = x + static_cast<size_t>(row) * d;
  TX* orow = out + static_cast<size_t>(row) * d;
  float ss = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    float v[V];
    load<TX, V>(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(d)), eps));
  for (int c = lane * V; c < d; c += 32 * V) {
    float v[V], wv[V], o[V];
    load<TX, V>(xr + c, v);
    load<TW, V>(w + c, wv);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = __fmul_rn(__fmul_rn(v[i], r), wv[i]);
    store<TX, V>(orow + c, o);
  }
  if (lane == 0) rstd[row] = r;
}

// Block b owns rows [b * rows_per_block, ...): dx one warp per row, then the
// fp32 partial of dw over the block's rows, each thread summing its V
// columns down the rows in order, into dw_part[b, :].
template <typename TX, typename TW, int V>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ rstd, const TX* __restrict__ g,
                    TX* __restrict__ dx, float* __restrict__ dw_part, int n,
                    int d, int rows_per_block) {
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  for (int row = r0 + (threadIdx.x >> 5); row < r1; row += kWarps) {
    const size_t base = static_cast<size_t>(row) * d;
    const float r = rstd[row];
    float acc = 0.f;
    for (int c = lane * V; c < d; c += 32 * V) {
      float xv[V], gv[V], wv[V];
      load<TX, V>(x + base + c, xv);
      load<TX, V>(g + base + c, gv);
      load<TW, V>(w + c, wv);
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(gv[i], wv[i]),
                                       __fmul_rn(xv[i], r)));
    }
    const float m = __fdiv_rn(warp_sum(acc), static_cast<float>(d));
    for (int c = lane * V; c < d; c += 32 * V) {
      float xv[V], gv[V], wv[V], o[V];
      load<TX, V>(x + base + c, xv);
      load<TX, V>(g + base + c, gv);
      load<TW, V>(w + c, wv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xhat = __fmul_rn(xv[i], r);
        const float wg = __fmul_rn(gv[i], wv[i]);
        o[i] = __fmul_rn(r, __fsub_rn(wg, __fmul_rn(xhat, m)));
      }
      store<TX, V>(dx + base + c, o);
    }
  }
  for (int c = threadIdx.x * V; c < d; c += kThreads * V) {
    float s[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int row = r0; row < r1; ++row) {
      const size_t base = static_cast<size_t>(row) * d;
      const float r = rstd[row];
      float xv[V], gv[V];
      load<TX, V>(x + base + c, xv);
      load<TX, V>(g + base + c, gv);
#pragma unroll
      for (int i = 0; i < V; ++i)
        s[i] = __fadd_rn(s[i], __fmul_rn(gv[i], __fmul_rn(xv[i], r)));
    }
    store<float, V>(dw_part + static_cast<size_t>(blockIdx.x) * d + c, s);
  }
}

// dw[col] = sum over the n_blocks partials, in a fixed order: 32 columns per
// block, kSlices warps each summing every kSlices-th partial, then slice 0
// adds the slices in order.
template <typename TW>
__global__ void __launch_bounds__(32 * kSlices)
rms_norm_dw_kernel(const float* __restrict__ dw_part, int n_blocks, int d,
                   TW* __restrict__ dw) {
  __shared__ float sums[kSlices][33];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d)
    for (int b = slice; b < n_blocks; b += kSlices)
      s = __fadd_rn(s, dw_part[static_cast<size_t>(b) * d + col]);
  sums[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) t = __fadd_rn(t, sums[k][lane]);
    dw[col] = from_f<TW>(t);
  }
}

template <typename TX, typename TW>
int fwd(const void* x, const void* w, void* out, float* rstd, int n, int d,
        float eps, int vec, cudaStream_t st) {
  const dim3 grid((n + kWarps - 1) / kWarps);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  if (vec)
    rms_norm_fwd_kernel<TX, TW, 16 / sizeof(TX)>
        <<<grid, kThreads, 0, st>>>(xp, wp, op, rstd, n, d, eps);
  else
    rms_norm_fwd_kernel<TX, TW, 1>
        <<<grid, kThreads, 0, st>>>(xp, wp, op, rstd, n, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int bwd(const void* x, const void* w, const float* rstd, const void* g,
        void* dx, float* dw_part, void* dw, int n, int d, int rows_per_block,
        int n_blocks, int vec, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const TX* gp = static_cast<const TX*>(g);
  TX* dxp = static_cast<TX*>(dx);
  if (n > 0) {
    if (vec)
      rms_norm_bwd_kernel<TX, TW, 16 / sizeof(TX)><<<n_blocks, kThreads, 0, st>>>(
          xp, wp, rstd, gp, dxp, dw_part, n, d, rows_per_block);
    else
      rms_norm_bwd_kernel<TX, TW, 1><<<n_blocks, kThreads, 0, st>>>(
          xp, wp, rstd, gp, dxp, dw_part, n, d, rows_per_block);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  // no rows: no partials, and the reduction writes dw = 0
  rms_norm_dw_kernel<TW><<<(d + 31) / 32, 32 * kSlices, 0, st>>>(
      dw_part, n > 0 ? n_blocks : 0, d, static_cast<TW*>(dw));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. All operands contiguous row-major:
// x, out, g, dx [n, d]; w, dw [d]; rstd [n] fp32; dw_part [n_blocks, d] fp32
// scratch with n_blocks = ceil(n / rows_per_block). vec != 0 selects 16-byte
// loads of x (the caller checks d and the pointers' alignment).
extern "C" int rms_norm_fwd_launch(const void* x, const void* w, void* out,
                                   void* rstd, int n, int d, float eps,
                                   int x_dtype, int w_dtype, int vec,
                                   void* stream) {
  if (n == 0 || d == 0) return 0;
  float* r = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return fwd<float, float>(x, w, out, r, n, d, eps, vec, st);
  if (x_dtype == 0 && w_dtype == 1)
    return fwd<float, __nv_bfloat16>(x, w, out, r, n, d, eps, vec, st);
  if (x_dtype == 1 && w_dtype == 0)
    return fwd<__nv_bfloat16, float>(x, w, out, r, n, d, eps, vec, st);
  if (x_dtype == 1 && w_dtype == 1)
    return fwd<__nv_bfloat16, __nv_bfloat16>(x, w, out, r, n, d, eps, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rms_norm_bwd_launch(const void* x, const void* w,
                                   const void* rstd, const void* g, void* dx,
                                   void* dw_part, void* dw, int n, int d,
                                   int rows_per_block, int x_dtype,
                                   int w_dtype, int vec, void* stream) {
  if (d == 0) return 0;
  const int n_blocks = (n + rows_per_block - 1) / rows_per_block;
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(dw_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return bwd<float, float>(x, w, r, g, dx, part, dw, n, d, rows_per_block,
                             n_blocks, vec, st);
  if (x_dtype == 0 && w_dtype == 1)
    return bwd<float, __nv_bfloat16>(x, w, r, g, dx, part, dw, n, d,
                                     rows_per_block, n_blocks, vec, st);
  if (x_dtype == 1 && w_dtype == 0)
    return bwd<__nv_bfloat16, float>(x, w, r, g, dx, part, dw, n, d,
                                     rows_per_block, n_blocks, vec, st);
  if (x_dtype == 1 && w_dtype == 1)
    return bwd<__nv_bfloat16, __nv_bfloat16>(x, w, r, g, dx, part, dw, n, d,
                                             rows_per_block, n_blocks, vec,
                                             st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

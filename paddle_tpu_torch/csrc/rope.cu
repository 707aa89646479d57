// Rotate-half rotary position embedding for Hopper (sm_90a), on x [B, S, H, D]
// with tables cos, sin [S, D] (fp32):
//   out = x * cos + rotate_half(x) * (sign * sin),  rotate_half(x) = [-x2, x1]
// where x1, x2 are the two halves of the last dimension. sign = +1 is the
// forward; sign = -1 is the backward (rotation by -theta), so the backward
// needs no negated copy of the table. fp32 arithmetic, out in x's dtype
// (fp32 or bf16).
//
// Replaces the Pallas kernel paddle_tpu/kernels/rope.py::_rope_kernel
// (pallas_call at rope.py:39; its custom_vjp runs the same kernel with -sin,
// rope.py:64-67). The TPU wrapper moves x to [B*H, S, D] so that each grid
// step is one (batch, head) slab against the whole [S, D] table; here each
// thread reads its pair of V-wide chunks, x[..., i:i+V] and x[..., D/2+i:...],
// straight from the [B, S, H, D] layout, so no transposed copy exists.
//
// What bounds it on the H100: bytes (x read and out written once, three fp32
// operations per element). Loads and stores are 16 bytes of x per chunk
// where D/2 and the pointers allow it (a scalar path takes any other even
// D); the tables, 2 x S x D x 4 bytes, stay in L2 across the batch and heads.
// Each product and the sum round one at a time (__fmul_rn, __fadd_rn) in the
// order of the plain formula, so the kernel's fp32 result is the plain
// version's, bit for bit.

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

constexpr int kThreads = 256;

// One thread per (row, V-wide chunk of the first half); a row is one (b, s,
// h) vector of D elements.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, T* __restrict__ out,
            int64_t rows, int S, int H, int D, float sign) {
  const int half = D / 2;
  const int chunks = half / V;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= rows * chunks) return;
  const int64_t row = i / chunks;
  const int c = static_cast<int>(i % chunks) * V;
  const int s = static_cast<int>((row / H) % S);
  const T* xr = x + row * D;
  T* orow = out + row * D;
  const float* cr = cos_t + static_cast<int64_t>(s) * D;
  const float* sr = sin_t + static_cast<int64_t>(s) * D;
  float x1[V], x2[V], c1[V], c2[V], s1[V], s2[V], o1[V], o2[V];
  load<T, V>(xr + c, x1);
  load<T, V>(xr + half + c, x2);
  load<float, V>(cr + c, c1);
  load<float, V>(cr + half + c, c2);
  load<float, V>(sr + c, s1);
  load<float, V>(sr + half + c, s2);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    o1[k] = __fadd_rn(__fmul_rn(x1[k], c1[k]), __fmul_rn(-x2[k], sign * s1[k]));
    o2[k] = __fadd_rn(__fmul_rn(x2[k], c2[k]), __fmul_rn(x1[k], sign * s2[k]));
  }
  store<T, V>(orow + c, o1);
  store<T, V>(orow + half + c, o2);
}

template <typename T>
int launch(const void* x, const float* cos_t, const float* sin_t, void* out,
           int64_t rows, int S, int H, int D, float sign, int vec,
           cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  const int64_t chunks = (D / 2) / (vec ? kV : 1);
  const int64_t blocks = (rows * chunks + kThreads - 1) / kThreads;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (vec)
    rope_kernel<T, kV><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        xp, cos_t, sin_t, op, rows, S, H, D, sign);
  else
    rope_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        xp, cos_t, sin_t, op, rows, S, H, D, sign);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x and out contiguous [rows = B*S*H,
// D] with D even; cos, sin contiguous fp32 [S, D]; sign is +1 (forward) or -1
// (backward). vec != 0 selects 16-byte chunks of x (the caller checks that
// D/2 is a multiple of the chunk and that every pointer is aligned to it).
extern "C" int rope_launch(const void* x, const void* cos_t,
                           const void* sin_t, void* out, int64_t rows, int S,
                           int H, int D, float sign, int dtype, int vec,
                           void* stream) {
  if (rows == 0 || D == 0) return 0;
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, c, s, out, rows, S, H, D, sign, vec, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, c, s, out, rows, S, H, D, sign, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// time is set by how many bytes are in flight, and how often.
//
// Forward, two routes, picked by the wrapper from the shape and the
// pointers' alignment (kernels/rms_norm.py _fwd_plan):
//  * registers (rms_norm_fwd_reg_kernel), for rows of d = 32 V VPL WPR
//    elements (V per 16-byte vector, VPL <= 8 vectors per lane, WPR warps
//    per row) on 16-byte-aligned pointers: each lane issues all VPL loads of
//    its part of the row before any arithmetic, sums squares in VPL
//    independent partials, and writes out from the same registers, so x is
//    read from device memory once with a whole row in flight per warp. A
//    persistent grid (as many blocks as fit on the card) walks the rows, and
//    each warp keeps its slice of w in registers across them.
//  * two passes (rms_norm_fwd_kernel), any d: one warp per row reads it
//    for the sum of squares, then again (from L1/L2) for the output, with
//    16-byte loads where d and the pointers allow it, else scalar ones.
// Backward, two routes, picked the same way (_bwd_plan):
//  * registers (rms_norm_bwd_reg_kernel), the forward's layout and grid:
//    each lane issues all VPL loads of x and of g before any arithmetic,
//    computes the row sum and then dx from the same registers, and adds
//    g * xhat into an fp32 dw partial that stays in its registers for the
//    whole walk (its columns are fixed). So x and g are read from device
//    memory once and dx written once, the backward's least traffic; the
//    partials meet in shared memory at the end, one row of dw_part per
//    block. A lane holds x, g (packed), w and dw (fp32): the plan keeps
//    that within 64 registers (else kBwdRegs) by spreading a row over
//    more warps.
//  * two passes (rms_norm_bwd_kernel), any d: one warp owns one row and
//    reads it twice (the reduction, then dx; the second read from L1/L2),
//    and the dw pass re-reads its block's rows in the column direction.
// Both end in rms_norm_dw_kernel, which sums the blocks' partials in a
// fixed order: dw is the same bits on every run, with no atomics.

#include <algorithm>

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

// The backward's register route: the most registers a lane's data may
// take (the plan keeps to 64 where 8 warps a row allow it). Each 16-byte
// vector of x costs 4 registers packed, and as many of g; its V columns
// cost V fp32 registers of w and V of the dw partial.
constexpr int kBwdRegs = 128;
template <typename TX>
constexpr int bwd_vpl_max() {
  return kBwdRegs / (8 + 2 * (16 / static_cast<int>(sizeof(TX))));
}

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

// The register route: WPR warps (a group) own a row of d = 32 V VPL WPR
// elements; lane l of warp k in the group holds the vectors at elements
// ((j WPR + k) 32 + l) V, j < VPL, so each j is one contiguous span of the
// row across the group. The group's partial sums meet in shared memory
// under a named barrier per group (double-buffered by the row's parity,
// so one barrier per row suffices), added in warp order: every warp of the
// group gets the same bits. Products round one at a time, as in the
// two-pass kernel.
template <typename TX, typename TW, int VPL>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_reg_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        TX* __restrict__ out, float* __restrict__ rstd, int n,
                        int wpr, float eps) {
  constexpr int V = 16 / sizeof(TX);
  __shared__ float part[2][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kWarps / wpr, grp = warp / wpr, k = warp % wpr;
  const int d = 32 * V * VPL * wpr;
  int col[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) col[j] = ((j * wpr + k) * 32 + lane) * V;
  float wv[VPL][V];
#pragma unroll
  for (int j = 0; j < VPL; ++j) load<TW, V>(w + col[j], wv[j]);
  int parity = 0;
  for (int row = blockIdx.x * groups + grp; row < n;
       row += gridDim.x * groups, parity ^= 1) {
    const TX* xr = x + static_cast<size_t>(row) * d;
    Pack<TX, V> raw[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      raw[j] = *reinterpret_cast<const Pack<TX, V>*>(xr + col[j]);
    float ss[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      ss[j] = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = to_f(raw[j].e[i]);
        ss[j] = __fadd_rn(ss[j], __fmul_rn(v, v));
      }
    }
#pragma unroll
    for (int st = 1; st < VPL; st *= 2)
#pragma unroll
      for (int j = 0; j + st < VPL; j += 2 * st) ss[j] = __fadd_rn(ss[j], ss[j + st]);
    float sum = warp_sum(ss[0]);
    if (wpr > 1) {
      if (lane == 0) part[parity][warp] = sum;
      asm volatile("bar.sync %0, %1;" :: "r"(1 + grp), "r"(32 * wpr) : "memory");
      sum = 0.f;
      for (int i = 0; i < wpr; ++i) sum = __fadd_rn(sum, part[parity][grp * wpr + i]);
    }
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(sum, static_cast<float>(d)), eps));
    TX* orow = out + static_cast<size_t>(row) * d;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = __fmul_rn(__fmul_rn(to_f(raw[j].e[i]), r), wv[j][i]);
      store<TX, V>(orow + col[j], o);
    }
    if (k == 0 && lane == 0) rstd[row] = r;
  }
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

// The backward's register route, on rms_norm_fwd_reg_kernel's layout: a
// group of wpr warps owns a row of d = 32 V VPL wpr elements, lane l of
// warp k holding the vectors at ((j wpr + k) 32 + l) V; group grp of block
// b walks rows b groups + grp + t gridDim.x groups, t = 0, 1, ... Per row:
// all loads of x and g first, the row sum of (g w) (x rstd) in VPL
// independent partials (the group's warps meet as in the forward), then dx
// and dw's partial from the same registers. When the walk ends the groups
// add their partials in group order through shared memory ([d] floats,
// dynamic, when there is more than one group) and the block writes row
// blockIdx.x of dw_part. Products round one at a time, in the plain
// formula's order, as in the two-pass kernel. The launch bounds' minimum
// of one block an SM keeps ptxas from capping registers at an occupancy
// step and spilling (it did at 64, 80 and 128 registers without it).
template <typename TX, typename TW, int VPL>
__global__ void __launch_bounds__(kThreads, 1)
rms_norm_bwd_reg_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        const float* __restrict__ rstd, const TX* __restrict__ g,
                        TX* __restrict__ dx, float* __restrict__ dw_part, int n,
                        int wpr) {
  constexpr int V = 16 / sizeof(TX);
  __shared__ float part[2][kWarps];
  extern __shared__ float dw_meet[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kWarps / wpr, grp = warp / wpr, k = warp % wpr;
  const int d = 32 * V * VPL * wpr;
  int col[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) col[j] = ((j * wpr + k) * 32 + lane) * V;
  float wv[VPL][V], dw[VPL][V];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    load<TW, V>(w + col[j], wv[j]);
#pragma unroll
    for (int i = 0; i < V; ++i) dw[j][i] = 0.f;
  }
  int parity = 0;
  for (int row = blockIdx.x * groups + grp; row < n;
       row += gridDim.x * groups, parity ^= 1) {
    const size_t base = static_cast<size_t>(row) * d;
    Pack<TX, V> rx[VPL], rg[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      rx[j] = *reinterpret_cast<const Pack<TX, V>*>(x + base + col[j]);
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      rg[j] = *reinterpret_cast<const Pack<TX, V>*>(g + base + col[j]);
    const float r = rstd[row];
    float acc[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      acc[j] = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(__fmul_rn(to_f(rg[j].e[i]), wv[j][i]),
                                             __fmul_rn(to_f(rx[j].e[i]), r)));
    }
#pragma unroll
    for (int st = 1; st < VPL; st *= 2)
#pragma unroll
      for (int j = 0; j + st < VPL; j += 2 * st) acc[j] = __fadd_rn(acc[j], acc[j + st]);
    float sum = warp_sum(acc[0]);
    if (wpr > 1) {
      if (lane == 0) part[parity][warp] = sum;
      asm volatile("bar.sync %0, %1;" :: "r"(1 + grp), "r"(32 * wpr) : "memory");
      sum = 0.f;
      for (int i = 0; i < wpr; ++i) sum = __fadd_rn(sum, part[parity][grp * wpr + i]);
    }
    const float m = __fdiv_rn(sum, static_cast<float>(d));
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float gv = to_f(rg[j].e[i]);
        const float xhat = __fmul_rn(to_f(rx[j].e[i]), r);
        o[i] = __fmul_rn(r, __fsub_rn(__fmul_rn(gv, wv[j][i]), __fmul_rn(xhat, m)));
        dw[j][i] = __fadd_rn(dw[j][i], __fmul_rn(gv, xhat));
      }
      store<TX, V>(dx + base + col[j], o);
    }
  }
  // ((group 0 + group 1) + group 2) + ...: each group in turn adds the sum
  // so far to its partial, the last writes the block's row
  for (int q = 0; q + 1 < groups; ++q) {
    if (grp == q)
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int i = 0; i < V; ++i)
          dw_meet[col[j] + i] = q == 0 ? dw[j][i] : __fadd_rn(dw_meet[col[j] + i], dw[j][i]);
    __syncthreads();
  }
  if (grp == groups - 1) {
    float* out = dw_part + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (groups > 1)
#pragma unroll
        for (int i = 0; i < V; ++i) dw[j][i] = __fadd_rn(dw_meet[col[j] + i], dw[j][i]);
      store<float, V>(out + col[j], dw[j]);
    }
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

template <typename TX, typename TW, int VPL>
int fwd_reg(const void* x, const void* w, void* out, float* rstd, int n,
            int wpr, int sms, float eps, cudaStream_t st) {
  const auto kernel = rms_norm_fwd_reg_kernel<TX, TW, VPL>;
  // the persistent grid: at most as many blocks as fit on the card's `sms`
  // SMs at once, the occupancy asked once per instantiation
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, rms_norm_fwd_reg_kernel<TX, TW, VPL>,
                                                  kThreads, 0);
    return std::max(b, 1);
  }();
  const int groups = kWarps / wpr;
  const int blocks = std::min((n + groups - 1) / groups, sms * per_sm);
  kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out),
      rstd, n, wpr, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int fwd_reg(const void* x, const void* w, void* out, float* rstd, int n,
            int vpl, int wpr, int sms, float eps, cudaStream_t st) {
  switch (vpl) {
    case 1: return fwd_reg<TX, TW, 1>(x, w, out, rstd, n, wpr, sms, eps, st);
    case 2: return fwd_reg<TX, TW, 2>(x, w, out, rstd, n, wpr, sms, eps, st);
    case 3: return fwd_reg<TX, TW, 3>(x, w, out, rstd, n, wpr, sms, eps, st);
    case 4: return fwd_reg<TX, TW, 4>(x, w, out, rstd, n, wpr, sms, eps, st);
    case 5: return fwd_reg<TX, TW, 5>(x, w, out, rstd, n, wpr, sms, eps, st);
    case 6: return fwd_reg<TX, TW, 6>(x, w, out, rstd, n, wpr, sms, eps, st);
    case 7: return fwd_reg<TX, TW, 7>(x, w, out, rstd, n, wpr, sms, eps, st);
    case 8: return fwd_reg<TX, TW, 8>(x, w, out, rstd, n, wpr, sms, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// The backward register route's operands, down the dispatch over VPL.
// blocks_out non-null: only ask the grid's size and write it there.
struct BwdRegArgs {
  const void* x;
  const void* w;
  const float* rstd;
  const void* g;
  void* dx;
  float* dw_part;
  void* dw;
  int n, wpr, sms, blocks;
  int* blocks_out;
  cudaStream_t st;
};

template <typename TX, typename TW, int VPL>
int bwd_reg_run(const BwdRegArgs& a) {
  const auto kernel = rms_norm_bwd_reg_kernel<TX, TW, VPL>;
  const int d = 32 * (16 / sizeof(TX)) * VPL * a.wpr;
  const int groups = kWarps / a.wpr;
  const size_t meet = groups > 1 ? d * sizeof(float) : 0;
  if (a.blocks_out) {
    // the persistent grid: at most as many blocks as fit on the card's
    // `sms` SMs at once, and no block without a row
    int per_sm = 0;
    const int err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, meet));
    if (err) return err;
    *a.blocks_out = std::min((a.n + groups - 1) / groups, a.sms * std::max(per_sm, 1));
    return 0;
  }
  if (a.n > 0) {
    kernel<<<a.blocks, kThreads, meet, a.st>>>(
        static_cast<const TX*>(a.x), static_cast<const TW*>(a.w), a.rstd,
        static_cast<const TX*>(a.g), static_cast<TX*>(a.dx), a.dw_part, a.n, a.wpr);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  rms_norm_dw_kernel<TW><<<(d + 31) / 32, 32 * kSlices, 0, a.st>>>(
      a.dw_part, a.n > 0 ? a.blocks : 0, d, static_cast<TW*>(a.dw));
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW, int VPL = 1>
int bwd_reg(int vpl, const BwdRegArgs& a) {
  if constexpr (VPL > bwd_vpl_max<TX>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (vpl == VPL) return bwd_reg_run<TX, TW, VPL>(a);
    return bwd_reg<TX, TW, VPL + 1>(vpl, a);
  }
}

int bwd_reg_any(int x_dtype, int w_dtype, int d, int vpl, const BwdRegArgs& a) {
  const int v = x_dtype == 0 ? 4 : 8;
  const int vpl_max = x_dtype == 0 ? bwd_vpl_max<float>() : bwd_vpl_max<__nv_bfloat16>();
  if (vpl < 1 || vpl > vpl_max || a.wpr < 1 || a.wpr > kWarps || kWarps % a.wpr != 0 ||
      d != 32 * v * vpl * a.wpr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0 && w_dtype == 0) return bwd_reg<float, float>(vpl, a);
  if (x_dtype == 0 && w_dtype == 1) return bwd_reg<float, __nv_bfloat16>(vpl, a);
  if (x_dtype == 1 && w_dtype == 0) return bwd_reg<__nv_bfloat16, float>(vpl, a);
  if (x_dtype == 1 && w_dtype == 1) return bwd_reg<__nv_bfloat16, __nv_bfloat16>(vpl, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. All operands contiguous row-major:
// x, out, g, dx [n, d]; w, dw [d]; rstd [n] fp32; dw_part [n_blocks, d] fp32
// scratch with n_blocks = ceil(n / rows_per_block). vec != 0 selects 16-byte
// loads of x (the caller checks d and the pointers' alignment).
// rms_norm_fwd_launch is the two-pass forward.
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

// The register route: rows of d = 32 * (16 / sizeof(x)) * vpl * wpr
// elements, 1 <= vpl <= 8, wpr in {1, 2, 4, 8}; x, w and out aligned to 16
// bytes of x's elements (the caller checks both); sms the card's SM count.
extern "C" int rms_norm_fwd_reg_launch(const void* x, const void* w, void* out,
                                       void* rstd, int n, int d, float eps,
                                       int x_dtype, int w_dtype, int vpl,
                                       int wpr, int sms, void* stream) {
  if (n == 0) return 0;
  const int v = x_dtype == 0 ? 4 : 8;
  if (vpl < 1 || vpl > 8 || wpr < 1 || wpr > kWarps || kWarps % wpr != 0 ||
      d != 32 * v * vpl * wpr || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* r = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return fwd_reg<float, float>(x, w, out, r, n, vpl, wpr, sms, eps, st);
  if (x_dtype == 0 && w_dtype == 1)
    return fwd_reg<float, __nv_bfloat16>(x, w, out, r, n, vpl, wpr, sms, eps, st);
  if (x_dtype == 1 && w_dtype == 0)
    return fwd_reg<__nv_bfloat16, float>(x, w, out, r, n, vpl, wpr, sms, eps, st);
  if (x_dtype == 1 && w_dtype == 1)
    return fwd_reg<__nv_bfloat16, __nv_bfloat16>(x, w, out, r, n, vpl, wpr, sms, eps, st);
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

// The backward's register route: rows of d = 32 * (16 / sizeof(x)) * vpl *
// wpr elements, wpr in {1, 2, 4, 8}, 1 <= vpl <= bwd_vpl_max (5 for bf16
// x, 8 for fp32); x, w, g and dx aligned to 16 bytes of x's elements (the
// caller checks both); sms the card's SM count. rms_norm_bwd_reg_blocks
// writes the persistent grid's size to *blocks; rms_norm_bwd_reg_launch
// takes it, with dw_part [blocks, d] fp32 scratch.
extern "C" int rms_norm_bwd_reg_blocks(int n, int d, int x_dtype, int w_dtype,
                                       int vpl, int wpr, int sms, int* blocks) {
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  BwdRegArgs a{};
  a.n = n;
  a.wpr = wpr;
  a.sms = sms;
  a.blocks_out = blocks;
  return bwd_reg_any(x_dtype, w_dtype, d, vpl, a);
}

extern "C" int rms_norm_bwd_reg_launch(const void* x, const void* w,
                                       const void* rstd, const void* g,
                                       void* dx, void* dw_part, void* dw,
                                       int n, int d, int x_dtype, int w_dtype,
                                       int vpl, int wpr, int blocks,
                                       void* stream) {
  if (n > 0 && blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  BwdRegArgs a{x, w, static_cast<const float*>(rstd), g, dx,
               static_cast<float*>(dw_part), dw, n, wpr, 0, blocks, nullptr,
               static_cast<cudaStream_t>(stream)};
  return bwd_reg_any(x_dtype, w_dtype, d, vpl, a);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

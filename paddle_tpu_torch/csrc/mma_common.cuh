// Warp-level tensor-core and async-copy helpers shared by the port's CUDA
// kernels (flash_attention.cu, paged_attention.cu, quant_matmul.cu).
//
// Products are mma.sync.m16n8k16 bf16 with fp32 accumulation; results live
// in the accumulator layout of its m16n8 tile: lane l holds rows l / 4 and
// l / 4 + 8, columns 2 (l % 4) + {0, 1} of each 8-wide tile. Operands reach
// the tensor cores from shared memory through ldmatrix (.trans for an
// N-contiguous B), and tiles move global -> shared with 16-byte cp.async
// pieces. kernels/build.py hashes this header into every library that
// includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of matrix i, row l / 4, columns 2 (l % 4) + {0, 1}
// (with .trans: rows 2 (l % 4) + {0, 1}, column l / 4) in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without passing through registers; zero-fill
// when !valid (src is then only a placeholder and is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// acc[16 x 8NT] += A[16 x K] . B[8NT x K]^T; A and B row-major, K-contiguous.
// NT is even.
template <int NT, int K>
__device__ __forceinline__ void gemm_abt(float (&acc)[NT][4],
                                         const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* Bm, int ldb) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* a_row = A + (lane & 15) * lda + (lane >> 4) * 8;
  const __nv_bfloat16* b_row =
      Bm + ((lane & 7) + (lane >> 4) * 8) * ldb + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, a_row + kk);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_row + nt * 8 * ldb + kk);
      mma_bf16(acc[nt], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma_bf16(acc[nt + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
  }
}

// acc[16 x 8NT] += P[16 x 8KT] . B[8KT x 8NT]; P in accumulator layout, B
// row-major, N-contiguous. KT and NT are even.
template <int KT, int NT>
__device__ __forceinline__ void gemm_pb(float (&acc)[NT][4],
                                        const float (&p)[KT][4],
                                        const __nv_bfloat16* Bm, int ldb) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* b_row =
      Bm + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < KT / 2; ++kc) {
    const uint32_t a0 = pack(p[2 * kc][0], p[2 * kc][1]);
    const uint32_t a1 = pack(p[2 * kc][2], p[2 * kc][3]);
    const uint32_t a2 = pack(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    const uint32_t a3 = pack(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_row + 16 * kc * ldb + nt * 8);
      mma_bf16(acc[nt], a0, a1, a2, a3, b[0], b[1]);
      mma_bf16(acc[nt + 1], a0, a1, a2, a3, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack(x, y);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int d = 0; d < N; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
}

}  // namespace

// Shared device helpers of the bf16 subm-conv kernels (sm_90a): bf16
// products on the tensor cores (mma.sync m16n8k16, fp32 accumulation), their
// fragments loaded from shared memory by ldmatrix, 16-byte cp.async, and the
// rounding of an fp32 result to bf16.  The cp.async group helpers
// (cp_async_commit, cp_async_wait) are those of mma_tf32.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace gapartnet {

// 16-byte copy from src to dst through L1, or 16 zero bytes (no read) when
// !valid; src must be a valid address either way
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes, 16-byte aligned), thread t receives row t / 4, columns
// 2 (t % 4) and 2 (t % 4) + 1 of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// as ldmatrix_x4, each matrix transposed: thread t receives rows 2 (t % 4)
// and 2 (t % 4) + 1 of column t / 4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// two matrices (lanes 0-15 give the addresses)
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// d += a * b, m16n8k16, bf16 operands, fp32 accumulation: one pass (a bf16
// product is exact in fp32)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to bf16 (to nearest, ties to even) and widened back, when
// `round`: the JAX VJP's `.astype(bfloat16)` of an fp32 result
__device__ __forceinline__ float round_bf16(float x, bool round) {
  return round ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

}  // namespace gapartnet

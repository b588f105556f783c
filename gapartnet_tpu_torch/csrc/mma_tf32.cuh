// Shared device helpers of the subm-conv kernels (sm_90a): cp.async with
// zero-fill, and fp32 products on the tensor cores as 3xTF32 mma.sync.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gapartnet {

// row stride (floats) of a shared operand whose mma fragments are read at
// (row t, column g), t < 4, g < 8: t * stride must fall on distinct
// multiples of 8 banks
__host__ __device__ constexpr int frag_stride(int n) {
  return n + ((n % 32 == 0 || n % 32 == 16) ? 8 : 0);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// VEC floats from src to dst through L1, or VEC zeros (no read) when
// !valid; src must be a valid address either way
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 * VEC : 0;
  if constexpr (VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    static_assert(VEC == 1, "copies are 16 or 4 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
  }
}

// a rounded to TF32 (low 13 mantissa bits zero) as cvt.rna.tf32.f32 rounds
// it, to nearest with ties away from zero, in two integer operations: half
// a TF32 ulp added to the magnitude's bits, then the low bits cleared.  Equal
// to cvt.rna for every number and infinity (ptxas expands cvt.rna into a
// longer sequence with a range check); a NaN stays a NaN unless its payload
// bits 12-22 are all set
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32: hi = rna(a), lo = rna(a - hi) (a - hi is exact)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(a);
  lo = rna_tf32(a - __uint_as_float(hi));
}

// d += a * b, m16n8k8, TF32 operands, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b to fp32 accuracy from the split operands: lo*hi, hi*lo, hi*hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

}  // namespace gapartnet

// Shared device helpers for the hand-written Hopper kernels: cp.async copies,
// ldmatrix fragment loads, the m16n8k16 bf16 tensor-core product, bf16
// packing and the GEMM epilogues' residual add and tanh-GELU.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                         a3 = (g+8, 2t+8..)
//   B (16x8, "col"):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16x8, f32):        c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy; when `pred` is false the destination is
// zero-filled and the source is not read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem))
               : "memory");
}

// d += A(16x16 bf16) * B(16x8 bf16), f32 accumulation.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, `lo` in the low half (lower column).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Two packed bf16 pairs added in f32 and rounded again: a residual added to
// a rounded projection, as the Pallas epilogues add it.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float2 x = unpack_bf16x2(a), y = unpack_bf16x2(b);
  return pack_bf16x2(x.x + y.x, x.y + y.y);
}

// tanh-GELU in f32 (the GEMM epilogues').
__device__ __forceinline__ float gelu_tanh(float h) {
  return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace ovt

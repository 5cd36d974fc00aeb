// Shared device helpers for the hand-written Hopper kernels: shared-memory
// addresses, bf16 packing, the GEMM epilogues' residual add and tanh-GELU,
// and a warp sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

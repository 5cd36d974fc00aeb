// Row LayerNorm over the feature dim: bf16 in, f32 statistics, bf16 out.
//
// Replaces the LN prologue of the Pallas kernels _mhsa_t_kernel and
// _mlp_t_kernel (openvision_tpu/ops/fused_encoder.py:71, :502) and of the
// natural-layout block _block_kernel (openvision_tpu/ops/fused_attention.py
// :440, whose E[x^2] - mean^2 variance differs from this two-pass one by f32
// rounding only). Bound on the
// card by device-memory bytes (one read and one write of the row; the three
// passes over the row after the first hit L1). One warp owns one row and
// moves 16 bytes a lane, so a block touches contiguous memory and no shared
// memory or block-wide barrier is needed.
#include "common.cuh"

namespace {

using ovt::bf16;

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, bf16* __restrict__ y,
                 int rows, int d, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + static_cast<size_t>(row) * d;
  bf16* yr = y + static_cast<size_t>(row) * d;

  float sum = 0.f;
  for (int i = lane * 8; i < d; i += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + i);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = ovt::unpack_bf16x2(w[j]);
      sum += f.x + f.y;
    }
  }
  const float mean = ovt::warp_sum(sum) / d;

  float sq = 0.f;  // two-pass variance, as the jnp reference (jnp.var)
  for (int i = lane * 8; i < d; i += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + i);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = ovt::unpack_bf16x2(w[j]);
      sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
    }
  }
  const float rstd = rsqrtf(ovt::warp_sum(sq) / d + eps);

  for (int i = lane * 8; i < d; i += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + i);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = ovt::unpack_bf16x2(w[j]);
      const int c = i + 2 * j;
      o[j] = ovt::pack_bf16x2((f.x - mean) * rstd * gamma[c] + beta[c],
                              (f.y - mean) * rstd * gamma[c + 1] + beta[c + 1]);
    }
    *reinterpret_cast<uint4*>(yr + i) = out;
  }
}

}  // namespace

// x, y: (rows, d) bf16, rows contiguous, 16-byte aligned; d % 8 == 0.
// gamma, beta: (d,) f32. Returns cudaGetLastError() after the launch.
extern "C" int ovt_layernorm(const void* x, const void* gamma, const void* beta,
                             void* y, int rows, int d, float eps, void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  layernorm_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

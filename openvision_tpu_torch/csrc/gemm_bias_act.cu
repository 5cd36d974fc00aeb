// C[M,N] = A[M,K] . W[N,K]^T + b, then optionally tanh-GELU, then optionally
// + R[M,N]. bf16 operands, f32 accumulation and epilogue, bf16 out.
//
// Replaces the four projections inside the Pallas kernels _mhsa_t_kernel
// (QKV + bias; out-proj + bo + residual) and _mlp_t_kernel (fc1 + b1 +
// tanh-GELU; fc2 + b2 + residual), openvision_tpu/ops/fused_encoder.py:71,
// :502, the QKV and out-proj + residual of the natural-layout block
// _block_kernel (openvision_tpu/ops/fused_attention.py:440), the QKV of
// fused_qkv_attention's _kernel (:92) and the shard's projections of
// _block_partial_kernel (:938), and the forward recomputes of their
// backwards. At ViT-L/14 shapes (M = B*257, K and N of 1024..4096) the
// products are bound by the tensor cores: M=16448, N=K=1024 does 2MNK FLOPs
// over 2(MK+NK+MN) bytes, about 500 FLOP/byte, above the card's ~295
// FLOP/byte ridge, so the design is about keeping wgmma busy: the
// warp-specialised persistent TMA + wgmma mainloop of hopper.cuh (a
// six-stage ring of 128 x 128 x 64 tiles, two consumer warpgroups, one
// producer thread), with both operands K-major as they lie (W in torch's
// (out, in) layout). The epilogue runs on the accumulators in registers
// while the producer loads the next tile: + bias in f32, tanh-GELU in f32
// with tanhf, round to bf16, then the bf16 residual add (the Pallas kernels
// add the residual to the rounded projection), stored 16 bytes a lane.
// Without GELU it runs the pingpong schedule (one warpgroup's epilogue under
// the other's products); with GELU, whose tanhf chains outlast a K = 1024
// tile's products, the cooperative one, which measured faster for fc1 on
// the H100. GELU and the residual are template flags: a runtime branch in
// the unrolled epilogue would cut it into one basic block per element pair.
// Ragged M, N and K: TMA's zero fill and masked stores; N and K must be
// multiples of 8.
#include "hopper.cuh"

namespace {

using ovt::bf16;
namespace hp = ovt::hopper;

template <bool kGelu, bool kResidual>
struct BiasActEpilogue {
  const float* bias;
  const bf16* residual;
  bf16* out;
  int m, n;

  __device__ __forceinline__ void operator()(float (&acc)[64], const hp::TileCtx& t) const {
    const int q = t.lane & 3;
    const int row0 = t.mt * hp::BM + t.half * 64 + t.warp * 16 + (t.lane >> 2);
    // every bias pair of the tile first: one load latency, not one per store
    float2 b[hp::BN / 8];
#pragma unroll
    for (int j = 0; j < hp::BN / 8; ++j) {
      const int col = t.nt * hp::BN + 8 * j + 2 * q;
      b[j] = bias && col < n ? __ldg(reinterpret_cast<const float2*>(bias + col))
                             : make_float2(0.f, 0.f);
    }
    // the residual's loads all together, first (a store between them would
    // order each load after it: out and residual may alias), under the
    // arithmetic of the half's 4 x 2 rows of 8 columns a lane (transpose_quad)
    uint4 r[hp::BN / 32][2];
    if constexpr (kResidual) {
#pragma unroll
      for (int g = 0; g < hp::BN / 32; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h, col = t.nt * hp::BN + 32 * g + 8 * q;
          r[g][h] = make_uint4(0u, 0u, 0u, 0u);
          if (row < m && col < n)
            r[g][h] = *reinterpret_cast<const uint4*>(residual + static_cast<size_t>(row) * n + col);
        }
    }
    uint32_t w[hp::BN / 32][2][4];
#pragma unroll
    for (int g = 0; g < hp::BN / 32; ++g) {  // 32 columns: chunks 4g..4g+3
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v0 = acc[16 * g + 4 * c + 2 * h] + b[4 * g + c].x;
          float v1 = acc[16 * g + 4 * c + 2 * h + 1] + b[4 * g + c].y;
          if constexpr (kGelu) {
            v0 = ovt::gelu_tanh(v0);
            v1 = ovt::gelu_tanh(v1);
          }
          w[g][h][c] = ovt::pack_bf16x2(v0, v1);
        }
        hp::transpose_quad(w[g][h], q);
        if constexpr (kResidual) {  // added to the rounded projection, then rounded again
          w[g][h][0] = ovt::add_bf16x2(w[g][h][0], r[g][h].x);
          w[g][h][1] = ovt::add_bf16x2(w[g][h][1], r[g][h].y);
          w[g][h][2] = ovt::add_bf16x2(w[g][h][2], r[g][h].z);
          w[g][h][3] = ovt::add_bf16x2(w[g][h][3], r[g][h].w);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < hp::BN / 32; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = t.nt * hp::BN + 32 * g + 8 * q;
        if (row < m && col < n)  // n % 8 == 0: the 8 columns end together
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * n + col) =
              make_uint4(w[g][h][0], w[g][h][1], w[g][h][2], w[g][h][3]);
      }
  }
};

template <bool kGelu, bool kResidual>
int launch_bias_act(const hp::Maps& maps, const void* bias, const void* residual, void* c, int m,
                    int n, int k, cudaStream_t stream) {
  const BiasActEpilogue<kGelu, kResidual> epi{static_cast<const float*>(bias),
                                              static_cast<const bf16*>(residual),
                                              static_cast<bf16*>(c), m, n};
  // GELU's epilogue outlasts the next tile's products: both warpgroups
  // share it (cooperative) rather than overlap it with them (pingpong)
  return hp::launch<hp::Bf16Cfg, 1, !kGelu, false, false, false, false>(
      maps, hp::make_tiles(m, n, k), epi, stream);
}

}  // namespace

// a: (m, k) bf16; w: (n, k) bf16; bias: (n,) f32 or null; residual: (m, n)
// bf16 or null; c: (m, n) bf16. All contiguous and 16-byte aligned; n % 8 ==
// 0 and k % 8 == 0. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue if the driver refuses an operand's tensor map.
extern "C" int ovt_gemm_bias_act(const void* a, const void* w, const void* bias,
                                 const void* residual, void* c, int m, int n, int k, int gelu,
                                 void* stream) {
  if (m == 0 || n == 0) return 0;
  hp::Maps maps;
  if (!hp::operand_map(&maps.a[0], a, false, m, k) || !hp::operand_map(&maps.b[0], w, false, n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  maps.a[1] = maps.a[0];
  maps.b[1] = maps.b[0];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gelu)
    return residual ? launch_bias_act<true, true>(maps, bias, residual, c, m, n, k, st)
                    : launch_bias_act<true, false>(maps, bias, residual, c, m, n, k, st);
  return residual ? launch_bias_act<false, true>(maps, bias, residual, c, m, n, k, st)
                  : launch_bias_act<false, false>(maps, bias, residual, c, m, n, k, st);
}

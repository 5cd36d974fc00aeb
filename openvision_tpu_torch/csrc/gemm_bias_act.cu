// C[M,N] = A[M,K] . W[N,K]^T + b, then optionally tanh-GELU, then optionally
// + R[M,N]. bf16 operands, f32 accumulation and epilogue, bf16 out; with
// H given, the f32 pre-activation A . W^T + b is written there too (the fc1
// recompute of the MLP backward, _mlp_t_bwd_kernel
// openvision_tpu/ops/fused_encoder.py:593, whose tanh-GELU derivative reads
// h in f32: 4 bytes per element more out, 269 MB at M = 64*257, N = 4096).
//
// Replaces the four projections inside the Pallas kernels _mhsa_t_kernel
// (QKV + bias; out-proj + bo + residual) and _mlp_t_kernel (fc1 + b1 +
// tanh-GELU; fc2 + b2 + residual), openvision_tpu/ops/fused_encoder.py:71,
// :502, and the QKV and out-proj + residual of the natural-layout block
// _block_kernel (openvision_tpu/ops/fused_attention.py:440). At ViT-L/14
// shapes (M = B*257, K and N of 1024..4096) the products
// are bound by the tensor cores: M=16448, N=K=1024 does 2MNK FLOPs over
// 2(MK+NK+MN) bytes, about 500 FLOP/byte, above the card's ~295 FLOP/byte
// ridge. This first version uses mma.sync
// m16n8k16 from ldmatrix fragments with a two-stage cp.async ring of
// 128x128x32 tiles (8 warps, 64x32 outputs each); wgmma, TMA and a
// persistent schedule are later work. W stays in torch's (out, in) layout,
// which is K-contiguous like the mma B operand wants. Ragged M, N and K
// tails are zero-filled on load and masked on store, so any M works and N, K
// need only be multiples of 8 (one 16-byte chunk).
#include "common.cuh"

namespace {

using ovt::bf16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // padded row: 80 bytes, conflict-free ldmatrix
constexpr int kThreads = 256;

__device__ __forceinline__ float gelu_tanh(float h) {
  return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
}

__global__ void __launch_bounds__(kThreads)
gemm_bias_act_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                     const float* __restrict__ bias, const bf16* __restrict__ R,
                     bf16* __restrict__ C, float* __restrict__ H, int M, int N, int K,
                     int gelu) {
  __shared__ __align__(16) bf16 As[2][BM][LDS];
  __shared__ __align__(16) bf16 Ws[2][BN][LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along M, 64 rows each
  const int wn = warp & 3;   // 4 warps along N, 32 columns each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 8, per operand
      const int c = tid + i * kThreads;
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gk = k0 + kc;
      const bool pa = (m0 + r) < M && gk < K;
      ovt::cp_async16(&As[s][r][kc], pa ? A + static_cast<size_t>(m0 + r) * K + gk : A, pa);
      const bool pw = (n0 + r) < N && gk < K;
      ovt::cp_async16(&Ws[s][r][kc], pw ? W + static_cast<size_t>(n0 + r) * K + gk : W, pw);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load_stage(0, 0);
  ovt::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      ovt::cp_async_commit();
      ovt::cp_async_wait<1>();
    } else {
      ovt::cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ovt::ldmatrix_x4(af[mt], &As[s][wm * 64 + mt * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
      uint32_t bfr[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // two n8 tiles per ldmatrix.x4
        uint32_t t[4];
        ovt::ldmatrix_x4(t, &Ws[s][wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7)]
                               [kk + ((lane >> 3) & 1) * 8]);
        bfr[2 * np][0] = t[0];
        bfr[2 * np][1] = t[1];
        bfr[2 * np + 1][0] = t[2];
        bfr[2 * np + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          ovt::mma_bf16_16816(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  // Epilogue in f32: + bias, GELU, round to bf16, then the bf16 residual add
  // (the Pallas kernels add the residual to the bf16-rounded projection).
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + t4 * 2;
    if (col >= N) continue;  // N % 8 == 0, so col + 1 < N too
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = acc[mt][nt][2 * half] + b0, v1 = acc[mt][nt][2 * half + 1] + b1;
        const size_t off = static_cast<size_t>(row) * N + col;
        if (H) *reinterpret_cast<float2*>(H + off) = make_float2(v0, v1);
        if (gelu) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        uint32_t out = ovt::pack_bf16x2(v0, v1);
        if (R) {
          const float2 o = ovt::unpack_bf16x2(out);
          const float2 r = ovt::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(R + off));
          out = ovt::pack_bf16x2(o.x + r.x, o.y + r.y);
        }
        *reinterpret_cast<uint32_t*>(C + off) = out;
      }
    }
  }
}

}  // namespace

// a: (m, k) bf16; w: (n, k) bf16; bias: (n,) f32 or null; residual: (m, n)
// bf16 or null; c: (m, n) bf16; h: (m, n) f32 or null (the pre-activation).
// All contiguous and 16-byte aligned; n % 8 == 0 and k % 8 == 0. Returns
// cudaGetLastError() after the launch.
extern "C" int ovt_gemm_bias_act(const void* a, const void* w, const void* bias,
                                 const void* residual, void* c, void* h, int m, int n, int k,
                                 int gelu, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_bias_act_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const bf16*>(residual),
      static_cast<bf16*>(c), static_cast<float*>(h), m, n, k, gelu);
  return static_cast<int>(cudaGetLastError());
}

// C[M,N] = dequant(Aq[M,K] . Wq[N,K]^T) for int8 operands: the int32 sum of
// each output, then in f32  acc * w_scale[n] * a_scale[m] + bias[n],
// optionally tanh-GELU, and out as f32, as bf16, or as bf16 + R[M,N] rounded
// again (the residual added to the rounded projection).
//
// Replaces the four int8 products inside the Pallas kernels
// _mhsa_t_int8_kernel (QKV :65-69, dequant + bias rounded to bf16; out-proj
// :127-134, + bo rounded, + residual) and _mlp_t_int8_kernel (fc1 :150-153,
// dequant + b1 kept in f32, then tanh-GELU in f32, :154; fc2 :156-163, + b2
// rounded, + residual), openvision_tpu/ops/fused_encoder_int8.py:39, :138,
// and the int8 head of quantized_encode_fused (openvision_tpu/serving/
// quant.py:415-416, which dequantises as acc * a_scale * w_scale; the two
// orders differ by f32 rounding only). The weights come per output channel
// (w_scale) and the activations per row (a_scale) from ovt_layernorm_quant or
// ovt_quant_rows. The fused path is always tanh-GELU, whatever the model's
// GELU flag (:154).
//
// Bound on the H100 (1979 int8 TOPS over 3.35 TB/s: a ridge of ~590
// ops/byte), at ViT-L/14 shapes (M = 64*257 = 16448): QKV (855 ops/byte)
// and fc2 by the int8 tensor cores; out-proj with its residual read (405)
// and fc1 with its f32 output (476) by device memory, so the f32 hidden's
// round trip is the fc1 launch's floor. This first version is the bf16 GEMM's
// structure at the same bytes: mma.sync m16n8k32 (s8.s8.s32) from ldmatrix
// fragments (an int8 16x32 tile is laid out as a b16 16x16 one, so the bf16
// kernel's addressing carries over byte for byte) with a two-stage cp.async
// ring of 128x128x64 tiles, 8 warps of 64x32 outputs each. wgmma, TMA and a
// persistent schedule are later work. Both operands are K-major: A row-major,
// W in torch's (out, in) layout, as mma's "row.col" wants. Ragged M, N and K
// tails are zero-filled on load and masked on store: any M works, N must be a
// multiple of 8 and K of 16 (one 16-byte chunk).
#include "common.cuh"

namespace {

using ovt::bf16;

constexpr int BM = 128, BN = 128, BK = 64;  // BK in int8 elements (bytes)
constexpr int LDS = BK + 16;  // padded row: 80 bytes, conflict-free ldmatrix
constexpr int kThreads = 256;

__device__ __forceinline__ float gelu_tanh(float h) {
  return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
}

// d += A(16x32 s8) * B(32x8 s8), s32 accumulation. Fragments (g = lane / 4,
// t = lane % 4): a0 = (g, 4t..4t+3), a1 = (g+8, 4t..), a2 = (g, 16+4t..),
// a3 = (g+8, 16+4t..); b0 = (k 4t..4t+3, n g), b1 = (k 16+4t.., n g); the
// s32 C fragment is laid out as the f32 one of m16n8k16.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C is f32 when out_f32, else bf16 (plus R, when given, after the rounding).
__global__ void __launch_bounds__(kThreads)
gemm_int8_kernel(const int8_t* __restrict__ A, const float* __restrict__ a_scale,
                 const int8_t* __restrict__ W, const float* __restrict__ w_scale,
                 const float* __restrict__ bias, const bf16* __restrict__ R,
                 void* __restrict__ C, int M, int N, int K, int gelu, int out_f32) {
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Ws[2][BN][LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along M, 64 rows each
  const int wn = warp & 3;   // 4 warps along N, 32 columns each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 16 bytes, per operand
      const int c = tid + i * kThreads;
      const int r = c >> 2, kc = (c & 3) * 16;
      const int gk = k0 + kc;
      const bool pa = (m0 + r) < M && gk < K;
      ovt::cp_async16(&As[s][r][kc], pa ? A + static_cast<size_t>(m0 + r) * K + gk : A, pa);
      const bool pw = (n0 + r) < N && gk < K;
      ovt::cp_async16(&Ws[s][r][kc], pw ? W + static_cast<size_t>(n0 + r) * K + gk : W, pw);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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
    for (int kk = 0; kk < BK; kk += 32) {  // one k32 step: 32 bytes of each row
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ovt::ldmatrix_x4(af[mt], &As[s][wm * 64 + mt * 16 + (lane & 15)][kk + (lane >> 4) * 16]);
      uint32_t bfr[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // two n8 tiles per ldmatrix.x4
        uint32_t t[4];
        ovt::ldmatrix_x4(t, &Ws[s][wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7)]
                               [kk + ((lane >> 3) & 1) * 16]);
        bfr[2 * np][0] = t[0];
        bfr[2 * np][1] = t[1];
        bfr[2 * np + 1][0] = t[2];
        bfr[2 * np + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8_16832(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  // Epilogue in f32, in the Pallas order: float(acc) * w_scale * a_scale +
  // bias, GELU, then f32 out, or rounded to bf16 (+ the bf16 residual,
  // rounded again).
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + t4 * 2;
    if (col >= N) continue;  // N % 8 == 0, so col + 1 < N too
    const float ws0 = w_scale[col], ws1 = w_scale[col + 1];
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
        if (row >= M) continue;
        const float as = a_scale[row];
        float v0 = __fmul_rn(__fmul_rn(static_cast<float>(acc[mt][nt][2 * half]), ws0), as);
        float v1 = __fmul_rn(__fmul_rn(static_cast<float>(acc[mt][nt][2 * half + 1]), ws1), as);
        v0 = __fadd_rn(v0, b0);  // no FMA contraction: Pallas rounds the product first
        v1 = __fadd_rn(v1, b1);
        if (gelu) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        const size_t off = static_cast<size_t>(row) * N + col;
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(C) + off) = make_float2(v0, v1);
          continue;
        }
        uint32_t out = ovt::pack_bf16x2(v0, v1);
        if (R) {
          const float2 o = ovt::unpack_bf16x2(out);
          const float2 r = ovt::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(R + off));
          out = ovt::pack_bf16x2(o.x + r.x, o.y + r.y);
        }
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(C) + off) = out;
      }
    }
  }
}

}  // namespace

// a: (m, k) int8, a_scale: (m,) f32; w: (n, k) int8, w_scale: (n,) f32;
// bias: (n,) f32 or null; residual: (m, n) bf16 or null (bf16 out only);
// c: (m, n), f32 when out_f32, else bf16. All contiguous and 16-byte
// aligned; n % 8 == 0 and k % 16 == 0. Returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for what the kernel does not take).
extern "C" int ovt_gemm_int8(const void* a, const void* a_scale, const void* w,
                             const void* w_scale, const void* bias, const void* residual,
                             void* c, int m, int n, int k, int gelu, int out_f32,
                             void* stream) {
  if (n % 8 || k % 16 || (out_f32 && residual)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const float*>(a_scale),
      static_cast<const int8_t*>(w), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<const bf16*>(residual), c, m, n, k, gelu,
      out_f32);
  return static_cast<int>(cudaGetLastError());
}

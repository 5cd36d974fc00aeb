// The two GEMM layouts of a linear layer's backward, bf16 operands and f32
// accumulation: C[M,N] = sum_k A(m, k) B(k, n) with
// - NN (dA = dC . W): A is dC (M, K) row-major, B is the weight W (K, N) in
//   torch's (out, in) layout, read along its rows;
// - TN (dW = dC^T . X): A is dC^T, read from dC (K, M) row-major, and B is the
//   layer input X (K, N) row-major; the reduction runs over K = B*L rows.
// The output is f32 or bf16 (the f32 sum rounded once). A TN product with too
// few output tiles to fill the card splits K over gridDim.z: each split writes
// an f32 partial and a second kernel sums them and rounds once.
//
// Replaces the weight and input products of the Pallas backward
// _block_bwd_kernel (openvision_tpu/ops/fused_attention.py:698): do = g.Wo^T
// (:751), dWo = o^T g (:807), dW_{q,k,v} = y^T d{q,k,v} (:823-831) and dy =
// sum d* . W*^T (:811-819), which the Pallas kernel computes in its own body.
// Bound on the H100: at the port's shapes (M = B*L of 8192..29632, N and K of
// 768..3072) each product does 2MNK FLOPs over 2(MK + KN) + 2..4 MN bytes,
// several hundred FLOP/byte, above the card's ~295 FLOP/byte ridge: the
// tensor cores bound it. This version uses mma.sync m16n8k16 over a
// two-stage cp.async ring of 128x128x32 tiles (8 warps, 64x32 outputs each),
// as gemm_bias_act.cu; an operand whose reduction runs down its rows is
// staged as it lies in memory and fed to the tensor cores with ldmatrix.trans.
// wgmma, TMA and a persistent schedule are later work. Ragged tails are
// zero-filled on load and masked on store; the contiguous dimension of every
// operand must be a multiple of 8.
//
// The NN product also has a tanh-GELU-derivative epilogue
// (ovt_gemm_nn_dgelu), for the MLP backward _mlp_t_bwd_kernel
// (openvision_tpu/ops/fused_encoder.py:593, :628-635): dgact = g . W2 in
// f32, then dh = dgact * gelu'(h) with the f32 pre-activation h read from
// device memory (written by the fc1 recompute, gemm_bias_act.cu), dh
// rounded to bf16 for the dW1 and dy products, and each warp's f32 column
// sums of the unrounded dh written as one row of partials (two rows per
// 128-row tile) for db1, which a column sum reduces. The f32 h costs 4 bytes
// per element read (269 MB at M = 64*257, N = 4096), where the Pallas
// kernel keeps it in VMEM; keeping it on chip is later work.
#include <algorithm>

#include "common.cuh"

namespace {

using ovt::bf16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDK = BK + 8;    // [row][k] tiles: 80-byte rows
constexpr int LDMN = BM + 8;   // [k][m or n] tiles: 272-byte rows
constexpr int kThreads = 256;
constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

// d/dh of 0.5 h (1 + tanh(C (h + A h^3))), in the Pallas kernel's order.
__device__ __forceinline__ float gelu_tanh_grad(float h) {
  const float t = tanhf(kGeluC * (h + kGeluA * h * h * h));
  return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * kGeluC * (1.f + 3.f * kGeluA * h * h);
}

// kAT: A is stored (K, M) ("A transposed"); else (M, K).
// kBT: B is stored (K, N); else (N, K) (the forward's weight layout).
// kDGelu: the tanh-GELU-derivative epilogue (see the file's note): Cb gets
// bf16(C * gelu'(H)), colpart row (2 * blockIdx.y + warp row) its f32
// column sums.
template <bool kAT, bool kBT, bool kDGelu = false>
__global__ void __launch_bounds__(kThreads)
gemm_grad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 float* __restrict__ Cf, bf16* __restrict__ Cb, const float* __restrict__ H,
                 float* __restrict__ colpart, int M, int N, int K, int k_split) {
  constexpr int A_ELEMS = kAT ? BK * LDMN : BM * LDK;
  constexpr int B_ELEMS = kBT ? BK * LDMN : BN * LDK;
  __shared__ __align__(16) bf16 As[2][A_ELEMS];
  __shared__ __align__(16) bf16 Bs[2][B_ELEMS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along M, 64 rows each
  const int wn = warp & 3;   // 4 warps along N, 32 columns each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);

  auto load_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      if (kAT) {  // 32 k-rows x 16 chunks of 8 along M
        const int r = c >> 4, mc = (c & 15) * 8;
        const bool p = (k0 + r) < ke && (m0 + mc) < M;
        ovt::cp_async16(&As[s][r * LDMN + mc],
                        p ? A + static_cast<size_t>(k0 + r) * M + m0 + mc : A, p);
      } else {  // 128 m-rows x 4 chunks of 8 along K
        const int r = c >> 2, kc = (c & 3) * 8;
        const bool p = (m0 + r) < M && (k0 + kc) < ke;
        ovt::cp_async16(&As[s][r * LDK + kc],
                        p ? A + static_cast<size_t>(m0 + r) * K + k0 + kc : A, p);
      }
      if (kBT) {
        const int r = c >> 4, nc = (c & 15) * 8;
        const bool p = (k0 + r) < ke && (n0 + nc) < N;
        ovt::cp_async16(&Bs[s][r * LDMN + nc],
                        p ? B + static_cast<size_t>(k0 + r) * N + n0 + nc : B, p);
      } else {
        const int r = c >> 2, kc = (c & 3) * 8;
        const bool p = (n0 + r) < N && (k0 + kc) < ke;
        ovt::cp_async16(&Bs[s][r * LDK + kc],
                        p ? B + static_cast<size_t>(n0 + r) * K + k0 + kc : B, p);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  if (nk > 0) {
    load_stage(0, kb);
    ovt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, kb + (kt + 1) * BK);
      ovt::cp_async_commit();
      ovt::cp_async_wait<1>();
    } else {
      ovt::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As[kt & 1];
    const bf16* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int mr = wm * 64 + mt * 16;
        if (kAT)
          ovt::ldmatrix_x4_trans(af[mt], as + (kk + (lane & 7) + (lane >> 4) * 8) * LDMN + mr +
                                             ((lane >> 3) & 1) * 8);
        else
          ovt::ldmatrix_x4(af[mt], as + (mr + (lane & 15)) * LDK + kk + (lane >> 4) * 8);
      }
      uint32_t bfr[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // two n8 tiles per ldmatrix.x4
        const int nr = wn * 32 + np * 16;
        uint32_t t[4];
        if (kBT)
          ovt::ldmatrix_x4_trans(t, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDMN + nr +
                                        (lane >> 4) * 8);
        else
          ovt::ldmatrix_x4(t, bs + (nr + (lane >> 4) * 8 + (lane & 7)) * LDK + kk +
                                  ((lane >> 3) & 1) * 8);
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

  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (kDGelu) {
    const size_t prow = 2 * static_cast<size_t>(blockIdx.y) + wm;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + t4 * 2;
      if (col >= N) continue;  // the warp's 8 columns of this n8 tile all end, N % 8 == 0
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
          if (row >= M) continue;
          const size_t off = static_cast<size_t>(row) * N + col;
          const float2 h = *reinterpret_cast<const float2*>(H + off);
          const float d0 = acc[mt][nt][2 * half] * gelu_tanh_grad(h.x);
          const float d1 = acc[mt][nt][2 * half + 1] * gelu_tanh_grad(h.y);
          *reinterpret_cast<uint32_t*>(Cb + off) = ovt::pack_bf16x2(d0, d1);
          s0 += d0;
          s1 += d1;
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // the 8 lanes of one column pair (same t4)
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) *reinterpret_cast<float2*>(colpart + prow * N + col) = make_float2(s0, s1);
    }
    return;
  }
  float* cf = Cf ? Cf + static_cast<size_t>(blockIdx.z) * M * N : nullptr;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + t4 * 2;
    if (col >= N) continue;  // N % 8 == 0, so col + 1 < N too
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
        if (row >= M) continue;
        const size_t off = static_cast<size_t>(row) * N + col;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (cf)
          *reinterpret_cast<float2*>(cf + off) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(Cb + off) = ovt::pack_bf16x2(v0, v1);
      }
    }
  }
}

// out[i] = sum over `splits` f32 partials of `count` elements, written as f32
// or rounded once to bf16.
__global__ void splitk_sum_kernel(const float* __restrict__ parts, int splits, size_t count,
                                  float* __restrict__ outf, bf16* __restrict__ outb) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += parts[z * count + i];
    if (outf)
      outf[i] = s;
    else
      outb[i] = __float2bfloat16(s);
  }
}

template <bool kAT, bool kBT>
int launch(const bf16* a, const bf16* b, float* cf, bf16* cb, int m, int n, int k, int k_split,
           int splits, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  gemm_grad_kernel<kAT, kBT><<<grid, kThreads, 0, stream>>>(a, b, cf, cb, nullptr, nullptr, m, n,
                                                             k, k_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c = a_op . b_op with a_op (m, k) and b_op (k, n):
// a_t = 0: a is (m, k) row-major; a_t = 1: a is (k, m) row-major.
// b_t = 0: b is (n, k) row-major; b_t = 1: b is (k, n) row-major.
// out_f32 = 1: c is (m, n) f32, else bf16. splits > 1 splits k into `splits`
// ranges of k_split rows (a multiple of 32) whose f32 partials go to
// `workspace` (splits * m * n f32) and are then summed into c. All tensors
// contiguous and 16-byte aligned; the contiguous dimension of a, b and c is
// a multiple of 8. Returns cudaGetLastError() after the launches.
extern "C" int ovt_gemm_grad(const void* a, const void* b, void* c, void* workspace, int m, int n,
                             int k, int a_t, int b_t, int out_f32, int splits, int k_split,
                             void* stream) {
  if (splits < 1 || (splits > 1 && (workspace == nullptr || k_split % BK)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  float* cf = splits > 1 ? static_cast<float*>(workspace)
                         : (out_f32 ? static_cast<float*>(c) : nullptr);
  bf16* cb = (splits == 1 && !out_f32) ? static_cast<bf16*>(c) : nullptr;
  if (splits == 1) k_split = k;
  int rc;
  if (a_t && b_t)
    rc = launch<true, true>(A, B, cf, cb, m, n, k, k_split, splits, st);
  else if (a_t)
    rc = launch<true, false>(A, B, cf, cb, m, n, k, k_split, splits, st);
  else if (b_t)
    rc = launch<false, true>(A, B, cf, cb, m, n, k, k_split, splits, st);
  else
    rc = launch<false, false>(A, B, cf, cb, m, n, k, k_split, splits, st);
  if (rc != 0 || splits == 1) return rc;
  const size_t count = static_cast<size_t>(m) * n;
  const int blocks = static_cast<int>(std::min<size_t>((count + 255) / 256, 4096));
  splitk_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(workspace), splits, count,
                                            out_f32 ? static_cast<float*>(c) : nullptr,
                                            out_f32 ? nullptr : static_cast<bf16*>(c));
  return static_cast<int>(cudaGetLastError());
}

// dh = bf16((a . b) * gelu'(h)) with a: (m, k) bf16 row-major (the output
// gradient g), b: (k, n) bf16 row-major (W2 in torch's (out, in) layout),
// h: (m, n) f32 (the pre-activation), dh: (m, n) bf16; colpart: (2 *
// ceil(m / 128), n) f32, the column sums of the unrounded product per
// 64-row warp tile (sum them for db1). All contiguous and 16-byte aligned;
// n % 8 == 0 and k % 8 == 0. Returns cudaGetLastError() after the launch.
extern "C" int ovt_gemm_nn_dgelu(const void* a, const void* b, const void* h, void* dh,
                                 void* colpart, int m, int n, int k, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, 1);
  gemm_grad_kernel<false, true, true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), nullptr, static_cast<bf16*>(dh),
      static_cast<const float*>(h), static_cast<float*>(colpart), m, n, k, k);
  return static_cast<int>(cudaGetLastError());
}

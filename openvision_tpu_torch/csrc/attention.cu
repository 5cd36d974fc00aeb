// softmax(q . k^T) . v per (batch, head), read by stride straight from the
// (B, L, 3D) QKV buffer and written as (B, L, D) for the out-projection.
//
// Replaces the attention core of the Pallas kernel _mhsa_t_kernel
// (openvision_tpu/ops/fused_encoder.py:71): q scaled by head_dim**-0.5 and
// rounded before q.k^T (:112), an f32 softmax over the keys, unnormalized
// probabilities rounded to bf16 for p.v and divided by the f32 row sum
// afterwards (:143-152), and the `nomax` variant exp(min(s, 80)) with no max
// subtraction (:139-141). Keys at or past L are masked, so any L works
// (257 = 4*64 + 1 at ViT-L/14-224).
//
// At L = 257 and head_dim 64 the work is small next to the projections
// (about 2*L*L*D MACs per image against 12*L*D*D); it is bound by the
// tensor-core throughput of mma.sync and by the online-softmax arithmetic.
// One block of 4 warps owns a 64-query tile of one (batch, head); each warp
// owns 16 query rows and keeps its scores and output in registers (the
// FlashAttention-2 layout: the score accumulator fragment is reused as the
// A operand of p.v), looping over 64-key tiles with an online softmax, so
// no (L, L) matrix ever reaches device memory. K and V tiles are single-
// buffered; overlapping their loads with compute is later work.
#include "common.cuh"

namespace {

using ovt::bf16;

constexpr int HD = 64;  // head_dim the kernel takes
constexpr int BQ = 64, BKV = 64;
constexpr int LDA = HD + 8;  // padded row: 144 bytes, conflict-free ldmatrix
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // NEG_INF of the Pallas kernel

__global__ void __launch_bounds__(kThreads)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int H,
                 float scale, int nomax) {
  __shared__ __align__(16) bf16 Qs[BQ][LDA];
  __shared__ __align__(16) bf16 Ks[BKV][LDA];
  __shared__ __align__(16) bf16 Vs[BKV][LDA];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * L * row_stride + h * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 64 rows x 8 chunks of 8
    const int c = tid + i * kThreads;
    const int r = c >> 3, cc = (c & 7) * 8;
    const bool p = (q0 + r) < L;
    ovt::cp_async16(&Qs[r][cc], p ? base + (q0 + r) * row_stride + cc : qkv, p);
  }
  ovt::cp_async_commit();
  ovt::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[4][4];  // this warp's 16 query rows, 4 k16 steps over head_dim
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    ovt::ldmatrix_x4(qf[ks], &Qs[warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = ovt::unpack_bf16x2(qf[ks][j]);
      qf[ks][j] = ovt::pack_bf16x2(f.x * scale, f.y * scale);
    }
  }

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};              // this lane's partial row sums

  const int nkv = (L + BKV - 1) / BKV;
  for (int kt = 0; kt < nkv; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // every warp is done with the previous K/V tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, cc = (c & 7) * 8;
      const bool p = (k0 + r) < L;
      const bf16* src = base + (k0 + r) * row_stride + cc;
      ovt::cp_async16(&Ks[r][cc], p ? src + D : qkv, p);
      ovt::cp_async16(&Vs[r][cc], p ? src + 2 * D : qkv, p);
    }
    ovt::cp_async_commit();
    ovt::cp_async_wait<0>();
    __syncthreads();

    float s[8][4];  // 16 rows x 64 keys
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t t[4];
        ovt::ldmatrix_x4(t, &Ks[np * 16 + (lane >> 4) * 8 + (lane & 7)]
                               [ks * 16 + ((lane >> 3) & 1) * 8]);
        ovt::mma_bf16_16816(s[2 * np], qf[ks], t[0], t[1]);
        ovt::mma_bf16_16816(s[2 * np + 1], qf[ks], t[2], t[3]);
      }
    }

#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + nt * 8 + t4 * 2 + (e & 1) >= L) s[nt][e] = kNegInf;

    if (nomax) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(fminf(s[nt][e], 80.f));
          l_run[e >> 1] += s[nt][e];
        }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_run[r];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = expf(m_run[r] - mx);
        m_run[r] = mx;
        float ls = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          s[nt][2 * r] = expf(s[nt][2 * r] - mx);
          s[nt][2 * r + 1] = expf(s[nt][2 * r + 1] - mx);
          ls += s[nt][2 * r] + s[nt][2 * r + 1];
        }
        l_run[r] = l_run[r] * alpha + ls;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          o[nt][2 * r] *= alpha;
          o[nt][2 * r + 1] *= alpha;
        }
      }
    }

#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 16 keys per step
      uint32_t pa[4];
      pa[0] = ovt::pack_bf16x2(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = ovt::pack_bf16x2(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = ovt::pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = ovt::pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t t[4];
        ovt::ldmatrix_x4_trans(t, &Vs[ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                     [np * 16 + (lane >> 4) * 8]);
        ovt::mma_bf16_16816(o[2 * np], pa, t[0], t[1]);
        ovt::mma_bf16_16816(o[2 * np + 1], pa, t[2], t[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  const int qa = q0 + warp * 16 + g, qb = qa + 8;
  bf16* obase = out + static_cast<size_t>(b) * L * D + h * HD + t4 * 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (qa < L)
      *reinterpret_cast<uint32_t*>(obase + static_cast<size_t>(qa) * D + nt * 8) =
          ovt::pack_bf16x2(o[nt][0] * inv0, o[nt][1] * inv0);
    if (qb < L)
      *reinterpret_cast<uint32_t*>(obase + static_cast<size_t>(qb) * D + nt * 8) =
          ovt::pack_bf16x2(o[nt][2] * inv1, o[nt][3] * inv1);
  }
}

}  // namespace

// qkv: (batch, seq, 3 * heads * head_dim) bf16, contiguous, 16-byte aligned,
// q | k | v blocks each head-major; out: (batch, seq, heads * head_dim) bf16.
// head_dim must be 64. Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a head_dim the kernel does not take).
extern "C" int ovt_attention(const void* qkv, void* out, int batch, int seq, int heads,
                             int head_dim, float scale, int nomax, void* stream) {
  if (head_dim != HD) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), seq, heads, scale, nomax);
  return static_cast<int>(cudaGetLastError());
}

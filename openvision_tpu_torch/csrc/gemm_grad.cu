// The two GEMM layouts of a linear layer's backward, and the MLP backward's
// dual-accumulator kernel, on the Hopper mainloop of hopper.cuh. bf16
// operands, f32 accumulation: C[M,N] = sum_k A(m, k) B(k, n) with
// - NN (dA = dC . W): A is dC (M, K), K-major; B is the weight W (K, N) in
//   torch's (out, in) layout, MN-major (wgmma's B-transpose bit);
// - TN (dW = dC^T . X): A is dC^T, read from dC (K, M), MN-major (the
//   A-transpose bit), and B is the layer input X (K, N), MN-major; the
//   reduction runs over K = B*L rows.
// The output is f32 or bf16 (the f32 sum rounded once). A TN product with too
// few output tiles to fill the card splits K into ranges of whole 64-row
// k-blocks: each split writes an f32 partial and a second kernel sums them
// and rounds once.
//
// Replaces the weight and input products of the Pallas backwards
// _block_bwd_kernel (openvision_tpu/ops/fused_attention.py:698): do = g.Wo^T
// (:751), dWo = o^T g (:807), dW_{q,k,v} = y^T d{q,k,v} (:823-831) and dy =
// sum d* . W*^T (:811-819); of _mhsa_t_bwd_kernel, _qkv_bwd_kernel and
// _block_partial_bwd_kernel, which run the same chain (fused_encoder.py:215,
// fused_attention.py:215, :1057); and of _mlp_t_bwd_kernel
// (fused_encoder.py:593): dW2, dW1 and dy.
// Bound on the H100: at the port's shapes (M = B*L of 8192..29632, N and K
// of 256..4096) each product does 2MNK FLOPs over 2(MK + KN) + 2..4 MN
// bytes, several hundred FLOP/byte, above the card's ~295 FLOP/byte ridge:
// the tensor cores bound it, and the design keeps wgmma fed from a six-stage
// TMA ring in a persistent, warp-specialised kernel (hopper.cuh), pingpong
// for NN and TN, with bf16 outputs stored 16 bytes a lane.
//
// ovt_mlp_bwd_dual is the rest of _mlp_t_bwd_kernel (:612-635): for a tile
// of (rows, hidden units) it runs two products over the same K = D into two
// f32 accumulators, h = y . W1^T (y and W1 K-major) and dgact = g . W2 (W2
// (D, hidden), MN-major), and its epilogue forms, in the Pallas order, h +=
// b1, t = tanh(C (h + A h^3)), gact = bf16(0.5 h (1 + t)) for dW2, dh =
// dgact (0.5 (1 + t) + 0.5 h (1 - t^2) C (1 + 3 A h^2)), bf16 dh for dW1 and
// dy, and the f32 column sums of the unrounded dh over each consumer's 64
// rows (one row of partials each, two per 128-row tile) for db1. The f32
// pre-activation stays in registers, as the Pallas kernel keeps it in VMEM:
// two 64 x 128 f32 accumulators a consumer thread (128 registers), so the
// dual kernel runs the cooperative schedule.
#include "hopper.cuh"

namespace {

using ovt::bf16;
namespace hp = ovt::hopper;

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

struct GradEpilogue {
  float* cf;  // f32 out, or the split partials (split z at z * m * n)
  bf16* cb;   // bf16 out when cf is null
  int m, n;

  __device__ __forceinline__ void operator()(float (&acc)[64], const hp::TileCtx& t) const {
    const int q = t.lane & 3;
    const int row0 = t.mt * hp::BM + t.half * 64 + t.warp * 16 + (t.lane >> 2);
    if (cf) {  // 8 bytes a lane: each row's 32 bytes of a chunk, a whole sector
      float* f = cf + static_cast<size_t>(t.z) * m * n;
#pragma unroll
      for (int j = 0; j < hp::BN / 8; ++j) {
        const int col = t.nt * hp::BN + j * 8 + 2 * q;  // n % 8 == 0, so col + 1 < n too
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < m && col < n)
            *reinterpret_cast<float2*>(f + static_cast<size_t>(row) * n + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      return;
    }
#pragma unroll
    for (int g = 0; g < hp::BN / 32; ++g) {  // bf16: 16 bytes a lane (hopper.cuh, transpose_quad)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          w[c] = ovt::pack_bf16x2(acc[16 * g + 4 * c + 2 * h], acc[16 * g + 4 * c + 2 * h + 1]);
        hp::transpose_quad(w, q);
        const int row = row0 + 8 * h, col = t.nt * hp::BN + 32 * g + 8 * q;
        if (row < m && col < n)
          *reinterpret_cast<uint4*>(cb + static_cast<size_t>(row) * n + col) =
              make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};

struct DualEpilogue {
  const float* b1;
  bf16* gact;
  bf16* dh;
  float* colpart;  // (2 * tiles_m, n)
  int m, n;

  __device__ __forceinline__ void operator()(float (&hacc)[64], float (&gacc)[64],
                                             const hp::TileCtx& t) const {
    const int q = t.lane & 3;
    const int row0 = t.mt * hp::BM + t.half * 64 + t.warp * 16 + (t.lane >> 2);
#pragma unroll
    for (int g = 0; g < hp::BN / 32; ++g) {  // 32 columns: chunks 4g..4g+3
      const int c0 = t.nt * hp::BN + 32 * g;
      // b1 a group at a time: the tile's 32 registers of it, beside the two
      // accumulators, would spill
      float2 b[4];
      float s[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + 8 * c + 2 * q;
        b[c] = col < n ? __ldg(reinterpret_cast<const float2*>(b1 + col)) : make_float2(0.f, 0.f);
        s[c][0] = s[c][1] = 0.f;
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 8 * hr;
        uint32_t wa[4], wd[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float ga[2], d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 16 * g + 4 * c + 2 * hr + e;
            const float h = hacc[i] + (e ? b[c].y : b[c].x);
            const float th = tanhf(kGeluC * (h + kGeluA * h * h * h));
            ga[e] = 0.5f * h * (1.f + th);
            d[e] = gacc[i] * (0.5f * (1.f + th) + 0.5f * h * (1.f - th * th) * kGeluC *
                                                      (1.f + 3.f * kGeluA * h * h));
          }
          wa[c] = ovt::pack_bf16x2(ga[0], ga[1]);
          wd[c] = ovt::pack_bf16x2(d[0], d[1]);
          // rows past m are left out of the sums (selects, not branches)
          s[c][0] += row < m ? d[0] : 0.f;
          s[c][1] += row < m ? d[1] : 0.f;
        }
        hp::transpose_quad(wa, q);
        hp::transpose_quad(wd, q);
        const int col = c0 + 8 * q;
        if (row < m && col < n) {
          const size_t off = static_cast<size_t>(row) * n + col;
          *reinterpret_cast<uint4*>(gact + off) = make_uint4(wa[0], wa[1], wa[2], wa[3]);
          *reinterpret_cast<uint4*>(dh + off) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {  // the 8 lanes of one column pair (same lane % 4)
          s[c][0] += __shfl_xor_sync(0xffffffffu, s[c][0], o);
          s[c][1] += __shfl_xor_sync(0xffffffffu, s[c][1], o);
        }
        if (t.lane < 4) {
          t.scratch[t.warp * hp::BN + 32 * g + 8 * c + 2 * q] = s[c][0];
          t.scratch[t.warp * hp::BN + 32 * g + 8 * c + 2 * q + 1] = s[c][1];
        }
      }
    }
    // the warpgroup's 64 rows: its four warps' sums, in warp order
    hp::named_barrier(1 + t.wg, 128);
    const int col = t.nt * hp::BN + t.tid;
    if (col < n) {
      const float* sc = t.scratch + t.tid;
      colpart[static_cast<size_t>(2 * t.mt + t.half) * n + col] =
          sc[0] + sc[hp::BN] + sc[2 * hp::BN] + sc[3 * hp::BN];
    }
    hp::named_barrier(1 + t.wg, 128);  // the scratch is free for the next tile
  }
};

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

}  // namespace

// c = a_op . b_op with a_op (m, k) and b_op (k, n), in one of the two
// layouts the backward uses:
// NN (a_t = 0, b_t = 1): a is (m, k) row-major, b is (k, n) row-major;
// TN (a_t = 1, b_t = 1): a is (k, m) row-major, b is (k, n) row-major.
// out_f32 = 1: c is (m, n) f32, else bf16. splits > 1 splits k into `splits`
// ranges of k_split rows (a multiple of 64) whose f32 partials go to
// `workspace` (splits * m * n f32) and are then summed into c. All tensors
// contiguous and 16-byte aligned; the contiguous dimension of a, b and c is
// a multiple of 8. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for another layout, a bad split or an operand the
// driver's tensor maps refuse.
extern "C" int ovt_gemm_grad(const void* a, const void* b, void* c, void* workspace, int m, int n,
                             int k, int a_t, int b_t, int out_f32, int splits, int k_split,
                             void* stream) {
  if (b_t != 1 || splits < 1 || (splits > 1 && (workspace == nullptr || k_split % hp::BK)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  hp::Maps maps;
  if (!hp::operand_map(&maps.a[0], a, a_t != 0, m, k) ||
      !hp::operand_map(&maps.b[0], b, true, n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  maps.a[1] = maps.a[0];
  maps.b[1] = maps.b[0];
  float* cf = splits > 1 ? static_cast<float*>(workspace)
                         : (out_f32 ? static_cast<float*>(c) : nullptr);
  bf16* cb = (splits == 1 && !out_f32) ? static_cast<bf16*>(c) : nullptr;
  const hp::Tiles tiles = hp::make_tiles(m, n, k, splits, k_split);
  const GradEpilogue epi{cf, cb, m, n};
  using C = hp::Bf16Cfg;
  const int rc = a_t ? hp::launch<C, 1, true, true, true, false, false>(maps, tiles, epi, st)
                     : hp::launch<C, 1, true, false, true, false, false>(maps, tiles, epi, st);
  if (rc != 0 || splits == 1) return rc;
  const size_t count = static_cast<size_t>(m) * n;
  const int blocks = static_cast<int>(std::min<size_t>((count + 255) / 256, 4096));
  splitk_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(workspace), splits, count,
                                            out_f32 ? static_cast<float*>(c) : nullptr,
                                            out_f32 ? nullptr : static_cast<bf16*>(c));
  return static_cast<int>(cudaGetLastError());
}

// The MLP backward's dual kernel: y, g (m, k) bf16 (the LayerNorm output and
// the output gradient); w1 (n, k) bf16 (fc1's (out, in) weight, n = hidden);
// b1 (n,) f32; w2 (k, n) bf16 (fc2's (out, in) weight). Writes gact and dh
// (m, n) bf16 and colpart (2 * ceil(m / 128), n) f32, the column sums of the
// unrounded dh over each 64-row slab (their sum over rows is db1). All
// contiguous and 16-byte aligned; n % 8 == 0 and k % 8 == 0. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue if the
// driver refuses an operand's tensor map.
extern "C" int ovt_mlp_bwd_dual(const void* y, const void* w1, const void* b1, const void* g,
                                const void* w2, void* gact, void* dh, void* colpart, int m, int n,
                                int k, void* stream) {
  if (m == 0 || n == 0) return 0;
  hp::Maps maps;
  if (!hp::operand_map(&maps.a[0], y, false, m, k) ||
      !hp::operand_map(&maps.b[0], w1, false, n, k) ||
      !hp::operand_map(&maps.a[1], g, false, m, k) || !hp::operand_map(&maps.b[1], w2, true, n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const DualEpilogue epi{static_cast<const float*>(b1), static_cast<bf16*>(gact),
                         static_cast<bf16*>(dh), static_cast<float*>(colpart), m, n};
  return hp::launch<hp::Bf16Cfg, 2, false, false, false, false, true>(
      maps, hp::make_tiles(m, n, k), epi, static_cast<cudaStream_t>(stream));
}

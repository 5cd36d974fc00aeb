// C[M,N] = dequant(Aq[M,K] . Wq[N,K]^T) for int8 operands: the int32 sum of
// each output, then in f32  acc * w_scale[n] * a_scale[m] + bias[n],
// optionally tanh-GELU, and out as f32, as bf16, or as bf16 + R[M,N] rounded
// again (the residual added to the rounded projection). With GELU into f32
// (fc1) the launch can also write each row's max |out| (row_amax), the
// scale that quantising the hidden needs, so that ovt_quant_rows reads it
// once.
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
// GELU flag (:154). The Pallas kernel keeps fc1's f32 hidden in VMEM and
// quantises it there (:155); here it goes through device memory, and its
// row max (exact in any order) comes from this epilogue instead of a read.
//
// Bound on the H100 (1979 int8 TOPS over 3.35 TB/s: a ridge of ~590
// ops/byte), at ViT-L/14 shapes (M = 64*257 = 16448): QKV (855 ops/byte)
// and fc2 by the int8 tensor cores; out-proj with its residual read (405)
// and fc1 with its f32 output (476) by device memory, so the f32 hidden's
// write is the fc1 launch's floor. The design is hopper.cuh's mainloop with
// s8 operands: TMA boxes of 128 rows x 128 int8 K values into a ring of
// stages, s8 wgmma (m64n128k32, or m64n256k32 on a 128 x 256 tile) into s32
// accumulators, one producer thread and two consumer warpgroups in one
// persistent block per SM. Both operands are K-major as they lie (A
// row-major, W in torch's (out, in) layout), which s8 wgmma requires.
// The epilogue runs on the s32 accumulators in registers, in the Pallas
// order and without FMA contraction (the plain version's bits):
// __int2float_rn, * w_scale, * a_scale, + bias, then GELU. The tile's
// column scales and biases are staged once in the warpgroup's shared
// scratch and every other load comes before the first store (a load after
// a store waits for it: out may alias the residual). bf16 outputs are
// stored 16 bytes a lane (transpose_quad), f32 ones as the fragment's
// 8-byte pairs, a whole 32-byte sector a row per four lanes; the row max
// reduces over each row's four lanes by shuffles, then one atomicMax on the
// float's bits (non-negative floats order as their bits) per row, warp and
// tile. GELU, the residual, the f32 output and the row max are template
// flags. Schedules: tanh-GELU and the 128 x 256 tile cooperative, the rest
// pingpong; which tile a product takes was measured (ovt_gemm_int8).
// Ragged M, N and K come from TMA's zero fill and masked stores: any M
// works, N must be a multiple of 8 and K of 16 (a 16-byte row pitch).
#include "hopper.cuh"

namespace {

using ovt::bf16;
namespace hp = ovt::hopper;

// The dequant epilogue; out is f32 when kF32, else bf16 (+ the residual).
template <class C, bool kGelu, bool kResidual, bool kF32, bool kAmax>
struct DequantEpilogue {
  static_assert(!(kF32 && kResidual) && (!kAmax || (kF32 && kGelu)),
                "a residual takes a bf16 output, the row max the f32 GELU hidden");
  const float* a_scale;
  const float* w_scale;
  const float* bias;
  const bf16* residual;
  void* out;
  float* amax;
  int m, n;

  __device__ __forceinline__ void operator()(int (&acc)[C::kAcc], const hp::TileCtx& t) const {
    constexpr int kGroups = C::BN / 32;  // 32 columns: fragment chunks 4g..4g+3
    const int q = t.lane & 3;
    const int row0 = t.mt * hp::BM + t.half * 64 + t.warp * 16 + (t.lane >> 2);
    const int col0 = t.nt * C::BN;
    float as[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) as[h] = row0 + 8 * h < m ? a_scale[row0 + 8 * h] : 0.f;
    uint4 r[kResidual ? kGroups : 1][2];
    if constexpr (kResidual) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h, col = col0 + 32 * g + 8 * q;
          r[g][h] = make_uint4(0u, 0u, 0u, 0u);
          if (row < m && col < n)
            r[g][h] =
                *reinterpret_cast<const uint4*>(residual + static_cast<size_t>(row) * n + col);
        }
    }
    // the tile's column scales and biases, once for the warpgroup
    float* sw = t.scratch;
    float* sb = t.scratch + C::BN;
    hp::named_barrier(1 + t.wg, 128);  // its reads of the previous tile's are done
    for (int i = t.tid; i < C::BN; i += 128) {
      const int col = col0 + i;
      sw[i] = col < n ? w_scale[col] : 0.f;
      sb[i] = bias != nullptr && col < n ? bias[col] : 0.f;
    }
    hp::named_barrier(1 + t.wg, 128);

    float mx[2] = {0.f, 0.f};
    uint32_t w[kF32 ? 1 : kGroups][2][4];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * g + c, lc = 8 * j + 2 * q;
          const float2 ws = *reinterpret_cast<const float2*>(sw + lc);
          const float2 b = *reinterpret_cast<const float2*>(sb + lc);
          float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), ws.x), as[h]);
          float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), ws.y), as[h]);
          v0 = __fadd_rn(v0, b.x);  // no FMA contraction: Pallas rounds the product first
          v1 = __fadd_rn(v1, b.y);
          if constexpr (kGelu) {
            v0 = ovt::gelu_tanh(v0);
            v1 = ovt::gelu_tanh(v1);
          }
          if constexpr (kF32) {
            const int col = col0 + lc;  // n % 8 == 0, so col + 1 < n too
            if (row < m && col < n) {
              *reinterpret_cast<float2*>(static_cast<float*>(out) + static_cast<size_t>(row) * n +
                                         col) = make_float2(v0, v1);
              if constexpr (kAmax) mx[h] = fmaxf(mx[h], fmaxf(fabsf(v0), fabsf(v1)));
            }
          } else {
            w[g][h][c] = ovt::pack_bf16x2(v0, v1);
          }
        }
        if constexpr (!kF32) {
          hp::transpose_quad(w[g][h], q);
          if constexpr (kResidual) {  // added to the rounded projection, then rounded again
            w[g][h][0] = ovt::add_bf16x2(w[g][h][0], r[g][h].x);
            w[g][h][1] = ovt::add_bf16x2(w[g][h][1], r[g][h].y);
            w[g][h][2] = ovt::add_bf16x2(w[g][h][2], r[g][h].z);
            w[g][h][3] = ovt::add_bf16x2(w[g][h][3], r[g][h].w);
          }
        }
      }
    }
    if constexpr (!kF32) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h, col = col0 + 32 * g + 8 * q;
          if (row < m && col < n)  // n % 8 == 0: the 8 columns end together
            *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + static_cast<size_t>(row) * n +
                                      col) = make_uint4(w[g][h][0], w[g][h][1], w[g][h][2],
                                                        w[g][h][3]);
        }
    }
    if constexpr (kAmax) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the row's four lanes, then one atomic on its bits
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const int row = row0 + 8 * h;
        if (q == 0 && row < m && mx[h] > 0.f)
          atomicMax(reinterpret_cast<int*>(amax) + row, __float_as_int(mx[h]));
      }
    }
  }
};

struct Operands {
  const float* a_scale;
  const float* w_scale;
  const float* bias;
  const bf16* residual;
  void* out;
  float* amax;
  int m, n, k;
};

template <class C, bool kGelu, bool kResidual, bool kF32, bool kAmax>
int launch_dequant(const hp::Maps& maps, const Operands& o, cudaStream_t stream) {
  const DequantEpilogue<C, kGelu, kResidual, kF32, kAmax> epi{
      o.a_scale, o.w_scale, o.bias, o.residual, o.out, o.amax, o.m, o.n};
  // tanh-GELU's epilogue outlasts the next tile's products: both warpgroups
  // share it (cooperative) rather than overlap it with them (pingpong); a
  // 128 x 256 tile's accumulators fit a consumer only as one 64-row half
  constexpr bool kPingpong = C::BN == 128 && !kGelu;
  return hp::launch<C, 1, kPingpong, false, false, false, false>(
      maps, hp::make_tiles<C>(o.m, o.n, o.k), epi, stream);
}

template <class C>
int launch_tile(const void* a, const void* w, const Operands& o, bool gelu, bool f32,
                cudaStream_t st) {
  hp::Maps maps;
  if (!hp::operand_map<C>(&maps.a[0], a, false, o.m, o.k) ||
      !hp::operand_map<C>(&maps.b[0], w, false, o.n, o.k, C::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  maps.a[1] = maps.a[0];
  maps.b[1] = maps.b[0];
  if constexpr (C::BN == 256) {  // GELU into bf16 registers spills at this width: not taken
    if (gelu && !f32) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f32) {
    if (gelu)
      return o.amax ? launch_dequant<C, true, false, true, true>(maps, o, st)
                    : launch_dequant<C, true, false, true, false>(maps, o, st);
    return launch_dequant<C, false, false, true, false>(maps, o, st);
  }
  if constexpr (C::BN == 128) {
    if (gelu)
      return o.residual ? launch_dequant<C, true, true, false, false>(maps, o, st)
                        : launch_dequant<C, true, false, false, false>(maps, o, st);
  }
  return o.residual ? launch_dequant<C, false, true, false, false>(maps, o, st)
                    : launch_dequant<C, false, false, false, false>(maps, o, st);
}

}  // namespace

// a: (m, k) int8, a_scale: (m,) f32; w: (n, k) int8, w_scale: (n,) f32;
// bias: (n,) f32 or null; residual: (m, n) bf16 or null (bf16 out only);
// c: (m, n), f32 when out_f32, else bf16; row_amax: (m,) f32 or null (f32
// out with GELU only), zero-filled by the caller, gets max |c[row, :]|.
// tile_n: 0 for the kernel's choice (every caller on the path), or 128 or
// 256 (not with GELU into bf16) forced, for tests and for timing the
// choice. All contiguous and 16-byte aligned; n % 8 == 0 and k % 16 == 0.
// Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what the kernel does not take (or an operand
// whose tensor map cuTensorMapEncodeTiled refuses).
extern "C" int ovt_gemm_int8(const void* a, const void* a_scale, const void* w,
                             const void* w_scale, const void* bias, const void* residual,
                             void* c, void* row_amax, int m, int n, int k, int gelu, int out_f32,
                             int tile_n, void* stream) {
  if (n % 8 || k % 16 || (out_f32 && residual) || (row_amax && !(out_f32 && gelu)) ||
      (tile_n != 0 && tile_n != 128 && tile_n != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const Operands o{static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
                   static_cast<const float*>(bias), static_cast<const bf16*>(residual), c,
                   static_cast<float*>(row_amax), m, n, k};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_n == 0) {
    // The 128 x 256 tile reads a sixth less shared memory per operation and
    // runs the cooperative schedule: per tile it costs 1.81-1.94x a 128 x
    // 128 one (QKV, fc1, fc2), 2.2x for out-proj (a residual read under a
    // K = 1024 mainloop: pingpong's overlapped epilogue wins). Each block
    // of the persistent grid takes whole tiles, so a product lasts as many
    // rounds of tiles as its most loaded SM takes. The wide tile pays only
    // when the narrow grid needs twice its rounds; otherwise (fc1 at b = 4
    // and 8, QKV at b <= 2, fc2 at b <= 4, the head) it was up to 1.7x
    // slower. Measured by chip_smoke.py --gemm at the daemon's buckets and
    // at b = 64, M = b * 257.
    const int sms = hp::sm_count(), mt = (m + hp::BM - 1) / hp::BM;
    const int rounds128 = (mt * ((n + 127) / 128) + sms - 1) / sms;
    const int rounds256 = (mt * ((n + 255) / 256) + sms - 1) / sms;
    const bool wide = rounds128 >= 2 * rounds256 && !(residual && k <= 1024) &&
                      (out_f32 || !gelu);
    tile_n = wide ? 256 : 128;
  }
  if (tile_n == 256)
    return launch_tile<hp::Cfg<hp::S8, 256>>(a, w, o, gelu != 0, out_f32 != 0, st);
  return launch_tile<hp::Cfg<hp::S8, 128>>(a, w, o, gelu != 0, out_f32 != 0, st);
}

// softmax(q . k^T) . v per (batch, head), with q, k and v read by base
// pointer and strides, so one kernel serves both layouts of the port:
// - the (B, L, 3D) QKV buffer of the fused encoder blocks (ovt_attention),
//   output (B, L, D) for the out-projection;
// - separate (B, L, H, head_dim) q, k and v of the flash path
//   (ovt_flash_attention), with Lq != Lk and an optional f32 LSE output.
//
// Replaces the attention core of these Pallas kernels:
// - _mhsa_t_kernel (openvision_tpu/ops/fused_encoder.py:71): q scaled by
//   head_dim**-0.5 and rounded before q.k^T, an f32 softmax over the keys,
//   unnormalized probabilities rounded to bf16 for p.v and divided by the f32
//   row sum afterwards, and the `nomax` variant exp(min(s, 80)) with no max
//   subtraction;
// - _mhsa_t_int8_kernel (openvision_tpu/ops/fused_encoder_int8.py:39), the
//   same core with an f32 output: Pallas quantises the f32 oT / l to int8
//   (:112-126), so ovt_attention's `out_f32` writes o / l unrounded, divided
//   by the row sum as Pallas divides (the bf16 output multiplies by 1 / l,
//   which its bf16 rounding hides);
// - _kernel, _block_kernel and _block_partial_kernel
//   (openvision_tpu/ops/fused_attention.py:92, :440, :938): the same core
//   and the unmasked, causal and prefix-LM masks (_tvalid, :64); Pallas folds
//   the scale into the q projection, and at head_dim 64 (scale 2**-3) scaling
//   q here gives the same bits;
// - _fwd_kernel and _fwd_kernel_single_k(_nolse)
//   (openvision_tpu/ops/flash_attention.py:133, :76, :85): `prescale` picks
//   the single-k order (q * scale rounded to bf16 before q.k^T) or the
//   multi-k order (f32 scores times scale); the LSE m + log(l) is written
//   when asked for (log(l) under nomax), which the backward chains'
//   recompute of the forward reads (_mhsa_t_bwd_kernel, _qkv_bwd_kernel,
//   _block_bwd_kernel, _block_partial_bwd_kernel).
// Key j is visible to query i iff j < Lk and, when causal, j <= max(i,
// prefix - 1). Whole key tiles that no query of the block can see are
// skipped, as _live (flash_attention.py:61) skips dead blocks: the live tiles
// are the contiguous range [0, last].
//
// Bound on the H100: at the port's shapes (head_dim 64, L of 128..900) the
// FLOPs are 4*Lq*Lk*64 per (batch, head) against 2*(2*Lq + 2*Lk)*64 bytes,
// about Lq*Lk/(Lq+Lk) FLOP/byte: 64..145, below the card's ~295 FLOP/byte
// ridge, so the floor is the bytes of q, k, v and o (40.2 us at b=64,
// L=257, 16 heads). The exponentials come next: 64*16*257*257 of them at
// that shape, ~17 us at the special-function units' ~3.9 T/s.
//
// What held the mma.sync kernel this replaces (1.39x SDPA at L=257), and
// what this design does about each (csrc/attention.cuh holds what it
// shares with the backward pair):
// 1. No load overlap: each K/V tile was loaded, waited for and computed in
//    turn. Here K and V tiles of 64 keys stream through a ring of four
//    stages under full/empty mbarriers, loaded by TMA from one thread of a
//    producer warp that runs the ring ahead, each stage as soon as the
//    consumers release it. The maps read the QKV buffer's heads by stride
//    (one map over its 3H heads) and the flash path's views; TMA's zero
//    fill supplies rows past the sequence.
// 2. mma.sync with ldmatrix for every K and V fragment. Here S = Q K^T is
//    wgmma from shared memory (both K-major), and O += P V takes P from
//    registers as wgmma's A operand (the score accumulator rounded to bf16
//    in place) and V as an MN-major B (the transpose bit): P never goes
//    through shared memory. The next tile's S group is issued before this
//    tile's P V group, so the softmax of tile t runs while P V of tile t - 1
//    is in the tensor cores.
// 3. L2 re-reads: every 64-row CTA reads its head's whole K and V. Two
//    consumer warpgroups sharing each tile (128 rows a CTA) would halve
//    that, but their nine warps fit two CTAs an SM only at 96 registers
//    (one SM partition's share), which spills this loop; measured, one
//    warpgroup (three CTAs an SM at 106 registers) is the faster.
// 4. Ragged tiles: the last key tile runs at the narrowest wgmma N (8, 16,
//    32 or 64) that covers it, so at L = 257 the fifth key tile (one key)
//    costs an N = 8 product. Its P V reduces over N rounded up to k16: the
//    A fragment's extra columns are zero and the V rows past Lk TMA's
//    zeros. Masks are applied only in tiles that straddle Lk or the causal
//    edge (a warp-uniform test per 16 rows). The CTA's own 64 rows stay a
//    whole tile: at L = 257 one CTA in five holds one row.
// 5. The exponential: one ex2 an element, exp(s sc - m sc) = ex2(s c -
//    m c) with c = sc log2(e), the score's scale folded into the exponent in
//    both orders; under nomax ex2(min(s c, 80 log2(e))). The single-k
//    order's rounding of q * scale to bf16 is a pass over the Q tile in
//    shared memory, taken only where it changes bits: a power-of-two scale
//    (2**-3 at head_dim 64) goes into the exponent as the multi-k order's
//    does, with the same bits.
// The epilogue writes bf16 rows 16 bytes a lane (each row's four lanes swap
// column pairs) or f32 pairs (a whole 32-byte sector a row a step).
// The alternatives measured against this design (two warpgroups, 128-key
// tiles, 2 or 3 stages, no overlap, no producer warp, no fold) are in
// PERF.md's design-choice table.
#include <cmath>
#include <type_traits>

#include "attention.cuh"

namespace {

using namespace ovt::attn;
using ovt::bf16;

constexpr int kStages = 4;                // K/V tiles in the ring
constexpr int kThreads = 128 + 32;        // one consumer warpgroup, then the producer warp
constexpr int kSmem = 1024 + kTileBytes + kStages * 2 * kTileBytes;  // Q, then K, V a stage
constexpr int kMinBlocks = 3;             // CTAs an SM (registers)

struct FwdMaps {
  CUtensorMap q, k, v;
};

struct FwdArgs {
  void* o;     // bf16, or f32 for the int8 block
  float* lse;  // (B, H, Lq) f32, or null
  Strides so;
  int Lq, Lk, H;
  int hk, hv;  // k's and v's first heads in their maps: 0, or H and 2H in the QKV buffer's
  int prescale;    // 1: q * scale rounded to bf16 before q.k^T
  float scale;
  float sc;      // the score's scale: 1 once q is scaled, else `scale`
  float c;       // sc * log2(e): exp(s sc - m sc) = ex2(s c - m c)
  float clamp2;  // 80 * log2(e), the nomax exponent's clamp
  int nomax, causal, prefix;
};

// Calls f(std::integral_constant<int, N>) for the narrowest wgmma N that
// covers `rem` keys (a whole tile past BT).
template <class F>
__device__ __forceinline__ void by_width(int rem, F&& f) {
  if (rem > 32)
    f(std::integral_constant<int, BT>{});
  else if (rem > 16)
    f(std::integral_constant<int, 32>{});
  else if (rem > 8)
    f(std::integral_constant<int, 16>{});
  else
    f(std::integral_constant<int, 8>{});
}

// One key tile's online softmax in place: the scores s (64 x N, keys k0..)
// become the unnormalised probabilities, m (the running max of the raw
// scores) and l (this lane's partial row sums) move on, and alpha is what
// O's rows are rescaled by. Rows row0 and row0 + 8 are this lane's; wrow is
// its warp's first row, for the warp-uniform whole-tile test.
template <int N, bool kCausal>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const FwdArgs& a, int k0,
                                             int row0, int col0, int wrow) {
  const bool whole =
      k0 + N <= a.Lk && (!kCausal || k0 + N - 1 <= max(wrow, a.prefix - 1));
  if (!whole) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int col = col0 + (i >> 2) * 8 + (i & 1), row = row0 + 8 * ((i >> 1) & 1);
      if (!(col < a.Lk && (!kCausal || col <= max(row, a.prefix - 1)))) s[i] = -INFINITY;
    }
  }
  if (a.nomax) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      s[i] = ex2(fminf(s[i] * a.c, a.clamp2));
      l[(i >> 1) & 1] += s[i];
    }
    alpha[0] = alpha[1] = 1.f;
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row with no visible key so far keeps m = -inf; subtract 0 then
    const float ms = mx == -INFINITY ? 0.f : mx;
    alpha[r] = ex2((m[r] - ms) * a.c);
    m[r] = mx;
    const float mc = ms * a.c;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      s[4 * j + 2 * r] = ex2(fmaf(s[4 * j + 2 * r], a.c, -mc));
      s[4 * j + 2 * r + 1] = ex2(fmaf(s[4 * j + 2 * r + 1], a.c, -mc));
      ls += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + ls;
  }
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// The warpgroup's 64 output rows from r0: o / l as bf16 (by the reciprocal)
// or as f32 (by a division, as Pallas's oT / l), rows below Lq only.
__device__ __forceinline__ void store_out(bf16* base, long long stride, int r0, int rows,
                                          const float (&o)[32], const float (&l)[2], int warp,
                                          int lane) {
  store_tile(base, stride, r0, rows, o, warp, lane, 1.f / l[0], 1.f / l[1]);
}
__device__ __forceinline__ void store_out(float* base, long long stride, int r0, int rows,
                                          const float (&o)[32], const float (&l)[2], int warp,
                                          int lane) {
  const int ra = r0 + warp * 16 + (lane >> 2), rb = ra + 8, col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (ra < rows)
      *reinterpret_cast<float2*>(base + (ra * stride + 8 * j + col)) =
          make_float2(o[4 * j] / l[0], o[4 * j + 1] / l[0]);
    if (rb < rows)
      *reinterpret_cast<float2*>(base + (rb * stride + 8 * j + col)) =
          make_float2(o[4 * j + 2] / l[1], o[4 * j + 3] / l[1]);
  }
}

// kCausal: the causal / prefix-LM mask (a compile-time switch, so the
// unmasked encoder path carries none of its index arithmetic). OutT: the
// output's type, bf16 or f32.
template <bool kCausal, typename OutT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attention_fwd_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_bar;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];

  // the Q tile, then the ring's stages of K then V
  const uint32_t raw = ovt::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  auto k_at = [&](int st) { return base + kTileBytes + st * 2 * kTileBytes; };
  const int r0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;  // r0: the CTA's first row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkv = (a.Lk + BT - 1) / BT;
  // the live key tiles of the CTA's rows are [0, last]
  const int last =
      kCausal ? min(nkv - 1, max(min(r0 + BT, a.Lq) - 1, a.prefix - 1) / BT) : nkv - 1;

  if (tid == 0) {
    hp::mbar_init(&q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    hp::tma_prefetch_map(&maps.q);
    hp::tma_prefetch_map(&maps.k);
    hp::tma_prefetch_map(&maps.v);
  }
  __syncthreads();
  if (tid >= 128) {  // the producer warp: one thread runs the ring ahead
    if (tid == 128) {
      hp::mbar_expect_tx(&q_bar, kTileBytes);
      load_tile(base, &maps.q, &q_bar, h, r0, b);
      for (int t = 0; t <= last; ++t) {  // each stage as soon as the consumers release it
        const int st = t % kStages;
        if (t >= kStages) hp::mbar_wait(&empty[st], (t / kStages - 1) & 1);
        hp::mbar_expect_tx(&full[st], 2 * kTileBytes);
        load_tile(k_at(st), &maps.k, &full[st], a.hk + h, t * BT, b);
        load_tile(k_at(st) + kTileBytes, &maps.v, &full[st], a.hv + h, t * BT, b);
      }
    }
    return;
  }
  auto release = [&](int t) {  // the consumers are done with tile t's stage
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[t % kStages]);
  };

  hp::mbar_wait(&q_bar, 0);
  if (a.prescale) {  // the single-k order: q * scale rounded to bf16, in place
    uint4* t = reinterpret_cast<uint4*>(smem);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = t[tid + 128 * i];
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 f = ovt::unpack_bf16x2(w[c]);
        w[c] = ovt::pack_bf16x2(f.x * a.scale, f.y * a.scale);
      }
      t[tid + 128 * i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    // the generic writes before wgmma's (async proxy) reads, in all 4 warps
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    hp::named_barrier(1, 128);
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const int wrow = r0 + warp * 16, row0 = wrow + (lane >> 2), col_lane = 2 * (lane & 3);

  // The next tile's S group is issued before the previous tile's P V group,
  // so the softmax of a tile runs while the tensor cores hold P V.
  uint32_t p[BT / 16][4];  // the previous tile's probabilities, A fragments
  hp::mbar_wait(&full[0], 0);
  by_width(a.Lk, [&](auto n) {
    constexpr int N = decltype(n)::value;
    float s[N / 2];
    hp::wgmma_fence();
    start_ss<N>(s, base, k_at(0));
    hp::wgmma_wait<0>();
    hp::fence_acc(s);
    float alpha[2];
    softmax_tile<N, kCausal>(s, m, l, alpha, a, 0, row0, col_lane, wrow);
    pack_a<N>(p, s);
  });
  for (int kt = 1; kt <= last; ++kt) {
    const int st = kt % kStages, k0 = kt * BT;
    hp::mbar_wait(&full[st], (kt / kStages) & 1);
    by_width(a.Lk - k0, [&](auto n) {
      constexpr int N = decltype(n)::value;
      float s[N / 2];
      // this tile's scores, then the previous tile's P V (a whole tile)
      hp::wgmma_fence();
      start_ss<N>(s, base, k_at(st));
      start_rs<BT / 16>(o, p, k_at((kt - 1) % kStages) + kTileBytes);
      hp::wgmma_wait<1>();
      hp::fence_acc(s);
      float alpha[2];
      softmax_tile<N, kCausal>(s, m, l, alpha, a, k0, row0, col_lane + k0, wrow);
      hp::wgmma_wait<0>();
      hp::fence_acc(o);
      fence_frag(p);
      release(kt - 1);
      if (!a.nomax) rescale(o, alpha);
      pack_a<N>(p, s);
    });
  }
  by_width(a.Lk - last * BT, [&](auto n) {  // the last tile's P V
    constexpr int N = decltype(n)::value;
    start_rs<(N + 15) / 16>(o, p, k_at(last % kStages) + kTileBytes);
    hp::wgmma_wait<0>();
    hp::fence_acc(o);
    fence_frag(p);
  });
  release(last);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] <= 0.f) l[r] = 1.f;  // no visible key: o = 0
  }
  store_out(static_cast<OutT*>(a.o) + b * a.so.b + h * a.so.h, a.so.l, r0, a.Lq, o, l, warp,
            lane);
  if (a.lse != nullptr && (lane & 3) == 0) {  // rows of 257 floats: no 16-byte alignment
    float* lrow = a.lse + (static_cast<long long>(b) * a.H + h) * a.Lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.Lq) lrow[row] = (m[r] == -INFINITY ? 0.f : m[r] * a.sc) + logf(l[r]);
    }
  }
}

template <bool kCausal, typename OutT>
int run(const FwdMaps& maps, const FwdArgs& a, int batch, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(attention_fwd_kernel<kCausal, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Lq + BT - 1) / BT, a.H, batch);
  attention_fwd_kernel<kCausal, OutT><<<grid, kThreads, kSmem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const FwdMaps& maps, const FwdArgs& a, int batch, int out_f32, void* stream) {
  if (a.Lq == 0 || a.H == 0 || batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)  // the int8 block: unmasked
    return run<false, float>(maps, a, batch, st);
  return a.causal ? run<true, bf16>(maps, a, batch, st) : run<false, bf16>(maps, a, batch, st);
}

FwdArgs make_args(void* out, void* lse, const Strides& so, int lq, int lk, int heads,
                  float scale, int prescale, int nomax, int causal, int prefix) {
  // a power-of-two scale (head_dim 64's 2**-3) commutes with every rounding:
  // bf16(q * scale) . k = scale * (q . k) bit for bit, so the single-k order
  // needs no pass over Q and the scale goes into the exponent
  int e;
  if (std::frexp(scale, &e) == 0.5f) prescale = 0;
  const float sc = prescale ? 1.f : scale;
  return FwdArgs{out, static_cast<float*>(lse), so, lq, lk, heads, 0, 0, prescale, scale,
                 sc, sc * kLog2e, 80.f * kLog2e, nomax, causal, prefix};
}

}  // namespace

// qkv: (batch, seq, 3 * heads * head_dim) bf16, contiguous, 16-byte aligned,
// q | k | v blocks each head-major; out: (batch, seq, heads * head_dim) bf16,
// or f32 when out_f32 (unmasked only); one batch item of qkv must hold fewer
// than 2**31 elements.
// q is scaled by `scale` and rounded before q.k^T. causal / prefix select the
// causal and prefix-LM masks. head_dim must be 64. Returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for what the kernel does not take).
extern "C" int ovt_attention(const void* qkv, void* out, int batch, int seq, int heads,
                             int head_dim, float scale, int nomax, int causal, int prefix,
                             int out_f32, void* stream) {
  if (head_dim != HD || (out_f32 && causal)) return static_cast<int>(cudaErrorInvalidValue);
  const int d = heads * HD;
  FwdMaps maps;  // one map over the buffer's 3 * heads heads: q, k and v by head offset
  if (!head_map(&maps.q, qkv, Strides{static_cast<long long>(seq) * 3 * d, 3 * d, HD}, 3 * heads,
                seq, batch))
    return static_cast<int>(cudaErrorInvalidValue);
  maps.k = maps.v = maps.q;
  FwdArgs a = make_args(out, nullptr, Strides{static_cast<long long>(seq) * d, d, HD}, seq, seq,
                        heads, scale, 1, nomax, causal, prefix);
  a.hk = heads;
  a.hv = 2 * heads;
  return launch(maps, a, batch, out_f32, stream);
}

// q: (batch, lq, heads, 64), k and v: (batch, lk, heads, 64), all bf16 with
// unit stride in head_dim and 16-byte aligned rows; `strides` holds the
// (batch, row, head) strides of q, k, v and out, in elements, 12 in all.
// Within one batch item, offsets must stay below 2**31 elements.
// out: (batch, lq, heads, 64) bf16 by its strides; lse: (batch, heads, lq)
// f32 contiguous, or null. prescale = 1 rounds q * scale to bf16 before
// q.k^T (the single-k Pallas order), 0 scales the f32 scores. nomax = 1
// takes exp(min(s, 80)) with no max subtraction (the fused_t option), and
// the lse it writes is then log(l): the recompute of _mhsa_t_bwd_kernel's
// forward (openvision_tpu/ops/fused_encoder.py:215) for the backward.
extern "C" int ovt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   void* lse, const long long* strides, int batch, int lq,
                                   int lk, int heads, int head_dim, float scale,
                                   int prescale, int causal, int prefix, int nomax,
                                   void* stream) {
  if (head_dim != HD) return static_cast<int>(cudaErrorInvalidValue);
  FwdMaps maps;
  if (!head_map(&maps.q, q, strides_of(strides, 0), heads, lq, batch) ||
      !head_map(&maps.k, k, strides_of(strides, 1), heads, lk, batch) ||
      !head_map(&maps.v, v, strides_of(strides, 2), heads, lk, batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a = make_args(out, lse, strides_of(strides, 3), lq, lk, heads, scale, prescale,
                              nomax, causal, prefix);
  return launch(maps, a, batch, 0, stream);
}

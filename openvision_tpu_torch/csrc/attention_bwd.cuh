// The attention backward pair of attention_bwd.cu (see its notes), templated
// on the padded head_dim, with one entry a kernel (bwd_dq, bwd_dkv).
// attention_bwd.cu instantiates the padded head_dims up to 64,
// attention_bwd_wide.cu those from 80 to 128 and attention_bwd_xwide.cu 192
// and 256 (two column parts each, attention.cuh's Part), so that the three
// build in parallel.
#pragma once

#include <limits>

#include "attention.cuh"

namespace {

using namespace ovt::attn;
using ovt::bf16;

constexpr int kThreads = 128;  // one warpgroup
// The streamed operand's ring: kStages stages of two tiles (K and V, or Q and
// dO), loaded kStages - 1 tiles ahead of use.
constexpr int kStages = 2;

// Per padded head_dim: dynamic shared memory (1 KB to align the swizzled
// tiles, then Q and dO (dq) or K and V (dk/dv), then the ring: 193 KB at
// 256), CTAs an SM, and the dk/dv kernel's streamed sub-tile (queries a
// product).
template <int HDP>
struct Bwd {
  static constexpr int kTileBytes = Hd<HDP>::kTileBytes;
  static constexpr int kSmem = 1024 + (2 + 2 * kStages) * kTileBytes;
  // 48 spills at 128 registers
  static constexpr int kDqBlocks = HDP == 48 ? 3 : HDP <= 64 ? 4 : HDP <= 128 ? 2 : 1;
  static constexpr int kDkvBlocks = HDP <= 64 ? 3 : HDP <= 128 ? 2 : 1;
  static constexpr int kSub = HDP <= 96 ? BT : 32;
};

// The operands' tensor maps: (hd, heads, rows, batch) views read in boxes
// of one head's 64 rows, one map a chunk. dk/dv does not read o.
enum { kQ, kK, kV, kO, kDo, kMaps };
template <int HDP>
struct Maps {
  OpMaps<HDP> m[kMaps];
};

struct BwdArgs {
  const float* lse;  // (B, H, Lq) f32
  float* delta;      // (B, H, Lq) f32, written by the dq kernel
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sdq, sdk, sdv;
  int Lq, Lk, H, hd;
  float scale;   // dS's factor
  float scale2;  // scale * log2(e): P's exponent
  float clamp2;  // 80 * log2(e) under nomax, else +inf
  float dq_scale;  // dq's factor on its f32 sum (1: none)
  int dq_round;    // 1: dq's sum is rounded to bf16 before dq_scale
  int causal, prefix;
};

__device__ __forceinline__ bool visible(int key, int query, const BwdArgs& a) {
  return key < a.Lk && (!a.causal || key <= max(query, a.prefix - 1));
}

// Starts a tile's two 64 x N score products as two wgmma groups: x = A . B^T
// then y = C . D^T over the head dim, all four operands K-major tiles (B and
// D `rb` rows in). wgmma_wait<1> then leaves y running while x is read.
template <int HDP, int N>
__device__ __forceinline__ void start_scores(float (&x)[N / 2], float (&y)[N / 2], uint32_t a,
                                             uint32_t b, uint32_t c, uint32_t d, int rb = 0) {
  hp::wgmma_fence();
  start_ss<HDP, N>(x, a, b, 0, rb);
  start_ss<HDP, N>(y, c, d, 0, rb);
}

// bar[0]: the tiles loaded once; bar[1 + s]: ring stage s.
template <int HDP>
__device__ __forceinline__ void init_barriers(uint64_t* bar, const Maps<HDP>& maps, int count) {
  for (int i = 0; i <= kStages; ++i) hp::mbar_init(&bar[i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int i = 0; i < count; ++i) prefetch_maps(maps.m[i]);
}

// Calls f(std::integral_constant<int, N>) for the narrowest wgmma N (at most
// kMax) that covers `rem` rows.
template <int kMax, class F>
__device__ __forceinline__ void by_rows(int rem, F&& f) {
  if constexpr (kMax == 64) {
    if (rem > 32) {
      f(std::integral_constant<int, 64>{});
      return;
    }
  }
  if (rem > 16)
    f(std::integral_constant<int, 32>{});
  else if (rem > 8)
    f(std::integral_constant<int, 16>{});
  else
    f(std::integral_constant<int, 8>{});
}

// ---------------------------------------------------------------------------
// dq (and delta)
// ---------------------------------------------------------------------------

// P of the dq kernel's tile in place: s (rows: the CTA's queries, columns:
// keys k0..) becomes P. kMask: the tile straddles Lk or the causal edge for
// this warp's rows.
template <int N, bool kMask>
__device__ __forceinline__ void dq_probs(float (&s)[N / 2], const BwdArgs& a, int row0, int col0,
                                         const float (&lse)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int e = i & 3;
    const float p = ex2(fminf(s[i] * a.scale2, a.clamp2) - lse[e >> 1]);
    s[i] = (kMask && !visible(col0 + (i >> 2) * 8 + (e & 1), row0 + 8 * (e >> 1), a)) ? 0.f : p;
  }
}

// One K/V tile: S and dP over the whole head_dim (the dP product runs on
// while P is formed), dS in place of P, then dq += dS K from registers over
// the part's HO columns of K (kp: where they start in the K tile).
template <int HDP, int HO, int N>
__device__ __forceinline__ void dq_tile(float (&dq)[HO / 2], uint32_t qs, uint32_t dos,
                                        uint32_t ks, uint32_t vs, uint32_t kp, const BwdArgs& a,
                                        int k0, int q0, int warp, int lane,
                                        const float (&lse)[2], const float (&del)[2]) {
  float s[N / 2], dp[N / 2];
  start_scores<HDP, N>(s, dp, qs, ks, dos, vs);
  hp::wgmma_wait<1>();
  hp::fence_acc(s);
  const int row0 = q0 + warp * 16 + (lane >> 2), col0 = k0 + 2 * (lane & 3);
  // warp-uniform: every key of the tile is visible to every row of the warp
  const bool whole =
      k0 + N <= a.Lk && (!a.causal || k0 + N - 1 <= max(q0 + warp * 16, a.prefix - 1));
  if (whole)
    dq_probs<N, false>(s, a, row0, col0, lse);
  else
    dq_probs<N, true>(s, a, row0, col0, lse);
  hp::wgmma_wait<0>();
  hp::fence_acc(dp);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = s[i] * (dp[i] - del[(i >> 1) & 1]) * a.scale;
  uint32_t f[(N + 15) / 16][4];
  pack_a<N>(f, s);
  start_rs<HO, (N + 15) / 16>(dq, f, kp);
  hp::wgmma_wait<0>();
  hp::fence_acc(dq);
  fence_frag(f);
}

template <int HDP, int PART>
__global__ void __launch_bounds__(kThreads, Bwd<HDP>::kDqBlocks)
    attention_bwd_dq_kernel(const __grid_constant__ Maps<HDP> maps, const BwdArgs a) {
  using H = Hd<HDP>;
  using Cols = Part<HDP, PART>;
  constexpr int kTileBytes = H::kTileBytes, HO = Cols::kCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[1 + kStages];  // Q, dO and O; the K/V stages
  __shared__ float delta_s[BT];

  // Q, dO, then the K/V stages; O, read once for delta, lands in the last
  // stage, which is not loaded before the first tile's iteration
  const uint32_t raw = ovt::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);
  const int o_off = (2 + 2 * (kStages - 1)) * kTileBytes;
  const uint32_t qs = base, dos = base + kTileBytes, os = base + o_off;
  auto stage_at = [&](int st) { return base + (2 + 2 * st) * kTileBytes; };
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int last = (a.Lk + BT - 1) / BT - 1;  // the live key tiles are [0, last]
  if (a.causal) last = min(last, max(q0 + BT - 1, a.prefix - 1) / BT);

  if (tid == 0) init_barriers(bar, maps, kMaps);
  __syncthreads();
  if (tid == 0) {
    hp::mbar_expect_tx(&bar[0], 3 * kTileBytes);
    load_tile(qs, maps.m[kQ], &bar[0], h, q0, b);
    load_tile(dos, maps.m[kDo], &bar[0], h, q0, b);
    load_tile(os, maps.m[kO], &bar[0], h, q0, b);
    for (int t = 0; t < kStages - 1 && t <= last; ++t) {  // the first K/V tiles
      hp::mbar_expect_tx(&bar[1 + t], 2 * kTileBytes);
      load_tile(stage_at(t), maps.m[kK], &bar[1 + t], h, t * BT, b);
      load_tile(stage_at(t) + kTileBytes, maps.m[kV], &bar[1 + t], h, t * BT, b);
    }
  }
  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8
  const float* lrow = a.lse + (static_cast<long long>(b) * a.H + h) * a.Lq;
  const float lse[2] = {row0 < a.Lq ? lrow[row0] * kLog2e : 0.f,
                        row0 + 8 < a.Lq ? lrow[row0 + 8] * kLog2e : 0.f};

  hp::mbar_wait(&bar[0], 0);
  {  // delta: two threads a row, each half of every chunk's 16-byte units (pad columns are 0)
    const int r = tid >> 1;
    float acc = 0.f;
    for_chunks<HDP>([&](auto cc) {
      constexpr int c = decltype(cc)::value, W = H::width(c);
#pragma unroll
      for (int i = 0; i < W / 16; ++i) {
        const int off = H::off(c) + swizzled<W>(r, 2 * i + (tid & 1));
        const uint4 d4 = *reinterpret_cast<const uint4*>(smem + kTileBytes + off);
        const uint4 o4 = *reinterpret_cast<const uint4*>(smem + o_off + off);
        const uint32_t dw[4] = {d4.x, d4.y, d4.z, d4.w}, ow[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 d2 = ovt::unpack_bf16x2(dw[w]), o2 = ovt::unpack_bf16x2(ow[w]);
          acc += d2.x * o2.x + d2.y * o2.y;
        }
      }
    });
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      if (PART == 0 && q0 + r < a.Lq) a.delta[(static_cast<long long>(b) * a.H + h) * a.Lq + q0 + r] = acc;
    }
  }
  // O's reads (generic proxy) before the next TMA write (async proxy) there
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const float del[2] = {delta_s[warp * 16 + (lane >> 2)], delta_s[warp * 16 + (lane >> 2) + 8]};

  float dq[HO / 2];  // this part's columns of dq
#pragma unroll
  for (int i = 0; i < HO / 2; ++i) dq[i] = 0.f;
  for (int kt = 0; kt <= last; ++kt) {
    const int s = kt % kStages, ahead = kt + kStages - 1;
    hp::mbar_wait(&bar[1 + s], (kt / kStages) & 1);
    if (tid == 0 && ahead <= last) {  // into the stage the last iteration freed
      const int sa = ahead % kStages;
      hp::mbar_expect_tx(&bar[1 + sa], 2 * kTileBytes);
      load_tile(stage_at(sa), maps.m[kK], &bar[1 + sa], h, ahead * BT, b);
      load_tile(stage_at(sa) + kTileBytes, maps.m[kV], &bar[1 + sa], h, ahead * BT, b);
    }
    const int k0 = kt * BT;
    const uint32_t ks = stage_at(s), vs = ks + kTileBytes;
    by_rows<BT>(a.Lk - k0, [&](auto n) {
      dq_tile<HDP, HO, decltype(n)::value>(dq, qs, dos, ks, vs, ks + Cols::kOff, a, k0, q0, warp,
                                            lane, lse, del);
    });
    __syncthreads();  // every thread is done with this stage before it is loaded again
  }
  if (a.dq_round) {  // the fused blocks' dq: the rounded sum times the scale
#pragma unroll
    for (int i = 0; i < HO / 2; ++i) dq[i] = round_bf16(dq[i]);
  }
  store_tile<HO>(a.dq + b * a.sdq.b + h * a.sdq.h + Cols::kCol0, a.sdq.l, q0, a.Lq,
                 a.hd - Cols::kCol0, dq, warp, lane, a.dq_scale, a.dq_scale);
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------

// P^T of the dk/dv kernel's tile in place: st (rows: the CTA's keys,
// columns: queries q0..) becomes P^T; lse_s holds the tile's lse * log2(e)
// from its column 0.
// kMask: the tile straddles the causal edge for this warp's keys.
template <int N, bool kMask>
__device__ __forceinline__ void dkv_probs(float (&st)[N / 2], const BwdArgs& a, int key0, int q0,
                                          int t4, const float* lse_s) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    const float2 lse = *reinterpret_cast<const float2*>(&lse_s[c]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float p = ex2(fminf(st[i] * a.scale2, a.clamp2) - ((e & 1) ? lse.y : lse.x));
      st[i] = (kMask && !(key0 + 8 * (e >> 1) <= max(q0 + c + (e & 1), a.prefix - 1))) ? 0.f : p;
    }
  }
}

// N queries of a Q/dO tile, `sub` rows into it: S^T and dP^T over the whole
// head_dim (the dP^T product runs on while P^T is formed), dv += P^T dO
// started before dS^T is formed in place of dP^T, then dk += dS^T Q; both
// from registers, over the part's HO columns of dO and Q (`off` bytes into
// their tiles). rows[0] holds the queries' lse * log2(e), rows[1] their
// delta.
template <int HDP, int HO, int N>
__device__ __forceinline__ void dkv_tile(float (&dk)[HO / 2], float (&dv)[HO / 2], uint32_t ks,
                                         uint32_t vs, uint32_t qs, uint32_t dos, uint32_t off,
                                         int sub, const BwdArgs& a, int k0, int q0, int warp,
                                         int lane, const float* lse_s, const float* del_s) {
  float st[N / 2], dpt[N / 2];
  start_scores<HDP, N>(st, dpt, ks, qs, vs, dos, sub);
  hp::wgmma_wait<1>();
  hp::fence_acc(st);
  // warp-uniform: every query of the tile sees every key of the warp
  const bool whole = !a.causal || k0 + warp * 16 + 15 <= max(q0, a.prefix - 1);
  const int key0 = k0 + warp * 16 + (lane >> 2), t4 = lane & 3;
  if (whole)
    dkv_probs<N, false>(st, a, key0, q0, t4, lse_s);
  else
    dkv_probs<N, true>(st, a, key0, q0, t4, lse_s);
  uint32_t fp[(N + 15) / 16][4], fd[(N + 15) / 16][4];
  pack_a<N>(fp, st);
  start_rs<HO, (N + 15) / 16>(dv, fp, dos + off, sub);
  hp::wgmma_wait<1>();  // dP^T (dv's product may still run)
  hp::fence_acc(dpt);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 del = *reinterpret_cast<const float2*>(&del_s[8 * j + 2 * t4]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      dpt[i] = st[i] * (dpt[i] - ((e & 1) ? del.y : del.x)) * a.scale;
    }
  }
  pack_a<N>(fd, dpt);
  start_rs<HO, (N + 15) / 16>(dk, fd, qs + off, sub);
  hp::wgmma_wait<0>();
  hp::fence_acc(dk);
  hp::fence_acc(dv);
  fence_frag(fp);
  fence_frag(fd);
}

template <int HDP, int PART>
__global__ void __launch_bounds__(kThreads, Bwd<HDP>::kDkvBlocks)
    attention_bwd_dkv_kernel(const __grid_constant__ Maps<HDP> maps, const BwdArgs a) {
  using Cols = Part<HDP, PART>;
  constexpr int kTileBytes = Hd<HDP>::kTileBytes, kSub = Bwd<HDP>::kSub, HO = Cols::kCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[1 + kStages];       // K and V; the Q/dO stages
  __shared__ __align__(16) float rows_s[kStages][2][BT];  // per stage: lse * log2(e), delta

  const uint32_t raw = ovt::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  const uint32_t ks = base, vs = base + kTileBytes;
  auto stage_at = [&](int st) { return base + (2 + 2 * st) * kTileBytes; };
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (a.Lq + BT - 1) / BT;
  // query tiles that can see this key tile: all of them, or with the causal
  // mask those from the diagonal on unless the tile reaches into the prefix
  const int first = (a.causal && k0 >= a.prefix) ? k0 / BT : 0;
  bf16* dk_out = a.dk + b * a.sdk.b + h * a.sdk.h + Cols::kCol0;
  bf16* dv_out = a.dv + b * a.sdv.b + h * a.sdv.h + Cols::kCol0;
  const int hd = a.hd - Cols::kCol0;  // this part's columns below head_dim

  float dk[HO / 2], dv[HO / 2];  // this part's columns
#pragma unroll
  for (int i = 0; i < HO / 2; ++i) dk[i] = dv[i] = 0.f;
  if (first >= nq) {  // keys no query sees: zero gradients
    store_tile<HO>(dk_out, a.sdk.l, k0, a.Lk, hd, dk, warp, lane);
    store_tile<HO>(dv_out, a.sdv.l, k0, a.Lk, hd, dv, warp, lane);
    return;
  }

  if (tid == 0) {
    init_barriers(bar, maps, kO);  // q, k, v
    prefetch_maps(maps.m[kDo]);
    hp::mbar_expect_tx(&bar[0], 2 * kTileBytes);
    load_tile(ks, maps.m[kK], &bar[0], h, k0, b);
    load_tile(vs, maps.m[kV], &bar[0], h, k0, b);
    for (int t = 0; t < kStages - 1 && first + t < nq; ++t) {  // the first Q/dO tiles
      hp::mbar_expect_tx(&bar[1 + t], 2 * kTileBytes);
      load_tile(stage_at(t), maps.m[kQ], &bar[1 + t], h, (first + t) * BT, b);
      load_tile(stage_at(t) + kTileBytes, maps.m[kDo], &bar[1 + t], h, (first + t) * BT, b);
    }
  }
  // lse and delta of a query tile: threads 0-63 one lse each, 64-127 one delta
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Lq;
  auto row_entry = [&](int qt) {
    const int q = qt * BT + (tid & (BT - 1));
    if (q >= a.Lq) return 0.f;
    return tid < BT ? a.lse[row_base + q] * kLog2e : a.delta[row_base + q];
  };
  rows_s[0][tid / BT][tid & (BT - 1)] = row_entry(first);
  __syncthreads();  // the barriers' init and the first rows
  hp::mbar_wait(&bar[0], 0);

  for (int qt = first; qt < nq; ++qt) {
    const int it = qt - first, s = it % kStages, ahead = qt + kStages - 1;
    hp::mbar_wait(&bar[1 + s], (it / kStages) & 1);
    if (tid == 0 && ahead < nq) {  // into the stage the last iteration freed
      const int sa = (it + kStages - 1) % kStages;
      hp::mbar_expect_tx(&bar[1 + sa], 2 * kTileBytes);
      load_tile(stage_at(sa), maps.m[kQ], &bar[1 + sa], h, ahead * BT, b);
      load_tile(stage_at(sa) + kTileBytes, maps.m[kDo], &bar[1 + sa], h, ahead * BT, b);
    }
    // the next tile's lse or delta entry, staged a tile ahead
    rows_s[(it + 1) % kStages][tid / BT][tid & (BT - 1)] = qt + 1 < nq ? row_entry(qt + 1) : 0.f;
    const uint32_t qs = stage_at(s), dos = qs + kTileBytes;
#pragma unroll
    for (int sub = 0; sub < BT; sub += kSub) {
      const int q0 = qt * BT + sub;
      if (q0 >= a.Lq) break;
      by_rows<kSub>(a.Lq - q0, [&](auto n) {
        dkv_tile<HDP, HO, decltype(n)::value>(dk, dv, ks, vs, qs, dos, Cols::kOff, sub, a, k0,
                                              q0, warp, lane, rows_s[s][0] + sub,
                                              rows_s[s][1] + sub);
      });
    }
    __syncthreads();  // every thread is done with this stage before it is loaded again
  }
  store_tile<HO>(dk_out, a.sdk.l, k0, a.Lk, hd, dk, warp, lane);
  store_tile<HO>(dv_out, a.sdv.l, k0, a.Lk, hd, dv, warp, lane);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

BwdArgs make_args(const void* lse, void* delta, void* dq, void* dk, void* dv, const long long* s,
                  int lq, int lk, int heads, int hd, float scale, int causal, int prefix,
                  int nomax, float dq_scale, int dq_round) {
  return BwdArgs{static_cast<const float*>(lse), static_cast<float*>(delta),
                 static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 strides_of(s, 5), strides_of(s, 6), strides_of(s, 7), lq, lk, heads, hd, scale,
                 scale * kLog2e, nomax ? 80.f * kLog2e : std::numeric_limits<float>::infinity(),
                 dq_scale, dq_round, causal, prefix};
}

// One column part's launch of each kernel (the shared-memory limit raised
// once an instantiation).
template <int HDP, int PART>
int run_dq(const Maps<HDP>& maps, const BwdArgs& a, dim3 grid, void* stream) {
  constexpr int kSmem = Bwd<HDP>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<HDP, PART>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attention_bwd_dq_kernel<HDP, PART>
      <<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}
template <int HDP, int PART>
int run_dkv(const Maps<HDP>& maps, const BwdArgs& a, dim3 grid, void* stream) {
  constexpr int kSmem = Bwd<HDP>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_dkv_kernel<HDP, PART>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attention_bwd_dkv_kernel<HDP, PART>
      <<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

// The maps of the operands in `ops` (null: not read), rows lk for k and v.
template <int HDP>
bool make_maps(Maps<HDP>* maps, const void* const* ops, const long long* strides, int hd,
               int heads, int lq, int lk, int batch) {
  for (int i = 0; i < kMaps; ++i) {
    if (ops[i] == nullptr) continue;
    const int rows = (i == kK || i == kV) ? lk : lq;
    if (!head_maps(&maps->m[i], ops[i], strides_of(strides, i), hd, heads, rows, batch))
      return false;
  }
  return true;
}

// The dq (and delta) entry at one padded head_dim.
template <int HDP>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, const long long* strides, int batch, int lq,
           int lk, int heads, int hd, float scale, int causal, int prefix, int nomax,
           float dq_scale, int dq_round, void* stream) {
  Maps<HDP> maps;
  const void* ops[kMaps] = {q, k, v, o, dout};
  if (!make_maps(&maps, ops, strides, hd, heads, lq, lk, batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = make_args(lse, delta, dq, nullptr, nullptr, strides, lq, lk, heads, hd, scale,
                              causal, prefix, nomax, dq_scale, dq_round);
  const dim3 grid((lq + BT - 1) / BT, heads, batch);
  const int rc = run_dq<HDP, 0>(maps, a, grid, stream);
  if constexpr (kParts<HDP> > 1) {
    if (rc == 0) return run_dq<HDP, 1>(maps, a, grid, stream);
  }
  return rc;
}

// The dk/dv entry at one padded head_dim.
template <int HDP>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, const long long* strides, int batch, int lq,
            int lk, int heads, int hd, float scale, int causal, int prefix, int nomax,
            void* stream) {
  Maps<HDP> maps;
  const void* ops[kMaps] = {q, k, v, nullptr, dout};
  if (!make_maps(&maps, ops, strides, hd, heads, lq, lk, batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = make_args(lse, const_cast<void*>(delta), nullptr, dk, dv, strides, lq, lk,
                              heads, hd, scale, causal, prefix, nomax, 1.f, 0);
  const dim3 grid((lk + BT - 1) / BT, heads, batch);
  const int rc = run_dkv<HDP, 0>(maps, a, grid, stream);
  if constexpr (kParts<HDP> > 1) {
    if (rc == 0) return run_dkv<HDP, 1>(maps, a, grid, stream);
  }
  return rc;
}

}  // namespace

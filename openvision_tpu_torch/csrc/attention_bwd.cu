// FlashAttention-2 backward over head_dim-64 q, k and v read by base pointer
// and strides, so one kernel family serves both layouts of the port:
// - the flash path's separate (B, L, H, 64) q, k, v, o and do, with Lq != Lk;
// - the fused natural-layout block, whose q, k and v are strided views of the
//   (B, L, 3D) QKV buffer and whose dq, dk and dv land in a (B, L, 3D) dqkv
//   buffer for the weight and input gradients.
//
// Replaces the Pallas backward kernels _dq_kernel and _dkv_kernel
// (openvision_tpu/ops/flash_attention.py:207, :245, through _bwd_impl :388)
// and the attention part of _block_bwd_kernel
// (openvision_tpu/ops/fused_attention.py:698, :755-804). What they compute,
// per (batch, head), with s = (q . k^T) * scale in f32 and the forward's
// logsumexp lse (_recompute_p, :201):
//   P  = exp(s - lse), 0 where key j is masked (j >= Lk, or causal and
//        j > max(i, prefix - 1));
//   delta_i = sum_d do_id * o_id                        (f32, :398-401)
//   dP = do . v^T (f32);  dS = P * (dP - delta) * scale
//   dq = dS . k,  dk = dS^T . q,  dv = P^T . do          (f32 sums, bf16 out)
// dS is rounded to bf16 for its two products, as the Pallas kernels round it
// (ds.astype(k.dtype)); P is rounded to bf16 for dv (the Pallas flash kernel
// keeps it in f32 there, the fused block rounds it). The fused block's
// formulation (q scaled before q.k^T, dq scaled after) gives the same bits
// at head_dim 64, where the scale is 2**-3. P is taken as
// exp2(s_raw * scale * log2(e) - lse * log2(e)) (one ex2 an element); under
// nomax (the fused_t forward's exp(min(s, 80))) the scaled score is clamped
// at 80 * log2(e) first.
//
// Bound on the H100: at the port's shapes (L of 128..463, head_dim 64) the
// bytes of q, k, v, o, do, dq, dk and dv over the card's memory rate exceed
// the 7 products (2 Lq Lk 64 FLOPs each per (batch, head)) over its bf16
// rate, so the pair is bytes-bound on paper (121.6 us at b=64, L=257, 16
// heads). What they move between L2 and the SMs is more: each 64-row CTA
// reads the whole streamed sequence of its head, ~460 MB for the dq kernel
// at that shape by its tile counts. A CTA of 128 rows (twice the registers:
// the dk/dv kernel already holds 168 a thread) or TMA multicast across a
// cluster would halve that; whether the L2 is what holds the pair at ~2x
// its bound is not measured (the card gives no counters here).
//
// Two kernels, each one warpgroup (128 threads) per (64-row tile, head,
// batch) whose 64 rows are the M of every product (wgmma, csrc/hopper.cuh's
// descriptors and 128-byte swizzle):
// - attention_bwd_dq: the CTA's rows are queries. Q, dO and O arrive once by
//   TMA (O into the ring's last stage, free until the loop starts); delta is
//   formed from dO and O and written for the dk/dv kernel. The live key
//   tiles (those some query of the tile sees, as _live does) stream through
//   a ring of K/V tiles, each loaded a tile ahead of its use by one thread's
//   TMA under an mbarrier. Per tile S = Q K^T and dP = dO V^T run on
//   shared-memory operands (both K-major) as two wgmma groups, P is formed
//   from S while dP's group still runs, then dS in place of P, and
//   dq += dS K takes dS from registers as wgmma's A operand and K as an
//   MN-major B (the transpose bit): dS never goes through shared memory.
//   Four CTAs an SM (122 registers, 49 KB).
// - attention_bwd_dkv: the CTA's rows are keys. K and V arrive once; Q/dO
//   tiles stream through the ring with their lse and delta rows (staged in
//   shared memory a tile ahead by plain loads: a row of 257 floats has no
//   16-byte alignment for TMA). Per tile S^T = K Q^T and dP^T = V dO^T from
//   shared memory, P^T from S^T while dP^T runs, dv += P^T dO started from
//   registers before dS^T is formed, then dk += dS^T Q. It reads the delta
//   the dq kernel wrote, so it runs after it on the stream. Three CTAs an
//   SM (168 registers: two 64 x 64 f32 sums and two score blocks).
// Each kernel recomputes S and dP: 7 products where the math needs 5, and no
// atomics, so both stay deterministic as the Pallas pair is. Two ring stages:
// three and four measured no faster on the card.
//
// The ragged tail. The last tile of the streamed sequence runs at the
// narrowest wgmma N of 8, 16, 32 or 64 that covers it (keys in the dq
// kernel, queries in the dk/dv kernel); its product into dq, dk or dv then
// reduces over N rows rounded up to wgmma's k16 (the rest of the A fragment
// is zero, the rest of the B tile TMA's zero fill). At L = 257 per (batch,
// head) and per kernel: 5 x 5 = 25 tile pairs of 64 x 64 before, each paying
// the whole products and exps; now 5 x (4 whole + 1 of N = 8): 20.6 of the
// S/dP products' work in 64 x 64 units, against 16.1 of useful work. The
// CTA's own 64 rows stay a whole tile: at L = 257 one CTA in five holds one
// valid row (the cls token), 20% of each kernel's work for 1/257 of the rows.
// Rows past the sequence read zeros (TMA), take lse = delta = 0 and so add
// exact zeros (P = 1 times a zero row); keys past Lk are masked in the tile
// that straddles Lk. The causal mask is applied only in tiles that straddle
// its edge (a warp-uniform test per 16 rows); whole tiles run unmasked.
#include <limits>

#include "attention.cuh"

namespace {

using namespace ovt::attn;
using ovt::bf16;

constexpr int kThreads = 128;  // one warpgroup
// The streamed operand's ring: kStages stages of two tiles (K and V, or Q and
// dO), loaded kStages - 1 tiles ahead of use.
constexpr int kStages = 2;
// Dynamic shared memory: 1 KB to align the swizzled tiles, then Q and dO
// (dq) or K and V (dk/dv), then the ring.
constexpr int kSmem = 1024 + (2 + 2 * kStages) * kTileBytes;

// The operands' tensor maps: (64, heads, rows, batch) views read in boxes of
// one head's 64 rows. dk/dv does not read o.
enum { kQ, kK, kV, kO, kDo, kMaps };
struct Maps {
  CUtensorMap m[kMaps];
};

struct BwdArgs {
  const float* lse;  // (B, H, Lq) f32
  float* delta;      // (B, H, Lq) f32, written by the dq kernel
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sdq, sdk, sdv;
  int Lq, Lk, H;
  float scale;   // dS's factor
  float scale2;  // scale * log2(e): P's exponent
  float clamp2;  // 80 * log2(e) under nomax, else +inf
  int causal, prefix;
};

__device__ __forceinline__ bool visible(int key, int query, const BwdArgs& a) {
  return key < a.Lk && (!a.causal || key <= max(query, a.prefix - 1));
}

// Starts a tile's two 64 x N score products as two wgmma groups: x = A . B^T
// then y = C . D^T over the head dim, all four operands K-major 64-row
// tiles. wgmma_wait<1> then leaves y running while x is read.
template <int N>
__device__ __forceinline__ void start_scores(float (&x)[N / 2], float (&y)[N / 2], uint32_t a,
                                             uint32_t b, uint32_t c, uint32_t d) {
  hp::wgmma_fence();
  start_ss<N>(x, a, b);
  start_ss<N>(y, c, d);
}

// bar[0]: the tiles loaded once; bar[1 + s]: ring stage s.
__device__ __forceinline__ void init_barriers(uint64_t* bar, const Maps& maps, int count) {
  for (int i = 0; i <= kStages; ++i) hp::mbar_init(&bar[i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int i = 0; i < count; ++i) hp::tma_prefetch_map(&maps.m[i]);
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

// One K/V tile: S and dP (the dP product runs on while P is formed), dS in
// place of P, then dq += dS K from registers.
template <int N>
__device__ __forceinline__ void dq_tile(float (&dq)[32], uint32_t qs, uint32_t dos, uint32_t ks,
                                        uint32_t vs, const BwdArgs& a, int k0, int q0, int warp,
                                        int lane, const float (&lse)[2], const float (&del)[2]) {
  float s[N / 2], dp[N / 2];
  start_scores<N>(s, dp, qs, ks, dos, vs);
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
  start_rs<(N + 15) / 16>(dq, f, ks);
  hp::wgmma_wait<0>();
  hp::fence_acc(dq);
  fence_frag(f);
}

__global__ void __launch_bounds__(kThreads, 4) attention_bwd_dq_kernel(const __grid_constant__ Maps maps,
                                                                  const BwdArgs a) {
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
    load_tile(qs, &maps.m[kQ], &bar[0], h, q0, b);
    load_tile(dos, &maps.m[kDo], &bar[0], h, q0, b);
    load_tile(os, &maps.m[kO], &bar[0], h, q0, b);
    for (int t = 0; t < kStages - 1 && t <= last; ++t) {  // the first K/V tiles
      hp::mbar_expect_tx(&bar[1 + t], 2 * kTileBytes);
      load_tile(stage_at(t), &maps.m[kK], &bar[1 + t], h, t * BT, b);
      load_tile(stage_at(t) + kTileBytes, &maps.m[kV], &bar[1 + t], h, t * BT, b);
    }
  }
  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8
  const float* lrow = a.lse + (static_cast<long long>(b) * a.H + h) * a.Lq;
  const float lse[2] = {row0 < a.Lq ? lrow[row0] * kLog2e : 0.f,
                        row0 + 8 < a.Lq ? lrow[row0 + 8] * kLog2e : 0.f};

  hp::mbar_wait(&bar[0], 0);
  {  // delta: two threads a row, four 16-byte chunks each
    const int r = tid >> 1;
    const uint8_t* drow = smem + kTileBytes + r * 128;
    const uint8_t* orow = smem + o_off + r * 128;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int off = (((tid & 1) * 4 + c) ^ (r & 7)) * 16;  // the 128-byte swizzle
      const uint4 d4 = *reinterpret_cast<const uint4*>(drow + off);
      const uint4 o4 = *reinterpret_cast<const uint4*>(orow + off);
      const uint32_t dw[4] = {d4.x, d4.y, d4.z, d4.w}, ow[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 d2 = ovt::unpack_bf16x2(dw[w]), o2 = ovt::unpack_bf16x2(ow[w]);
        acc += d2.x * o2.x + d2.y * o2.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      if (q0 + r < a.Lq) a.delta[(static_cast<long long>(b) * a.H + h) * a.Lq + q0 + r] = acc;
    }
  }
  // O's reads (generic proxy) before the next TMA write (async proxy) there
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const float del[2] = {delta_s[warp * 16 + (lane >> 2)], delta_s[warp * 16 + (lane >> 2) + 8]};

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int kt = 0; kt <= last; ++kt) {
    const int s = kt % kStages, ahead = kt + kStages - 1;
    hp::mbar_wait(&bar[1 + s], (kt / kStages) & 1);
    if (tid == 0 && ahead <= last) {  // into the stage the last iteration freed
      const int sa = ahead % kStages;
      hp::mbar_expect_tx(&bar[1 + sa], 2 * kTileBytes);
      load_tile(stage_at(sa), &maps.m[kK], &bar[1 + sa], h, ahead * BT, b);
      load_tile(stage_at(sa) + kTileBytes, &maps.m[kV], &bar[1 + sa], h, ahead * BT, b);
    }
    const int k0 = kt * BT, rem = a.Lk - k0;
    const uint32_t ks = stage_at(s), vs = ks + kTileBytes;
    if (rem > 32)
      dq_tile<64>(dq, qs, dos, ks, vs, a, k0, q0, warp, lane, lse, del);
    else if (rem > 16)
      dq_tile<32>(dq, qs, dos, ks, vs, a, k0, q0, warp, lane, lse, del);
    else if (rem > 8)
      dq_tile<16>(dq, qs, dos, ks, vs, a, k0, q0, warp, lane, lse, del);
    else
      dq_tile<8>(dq, qs, dos, ks, vs, a, k0, q0, warp, lane, lse, del);
    __syncthreads();  // every thread is done with this stage before it is loaded again
  }
  store_tile(a.dq + b * a.sdq.b + h * a.sdq.h, a.sdq.l, q0, a.Lq, dq, warp, lane);
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------

// P^T of the dk/dv kernel's tile in place: st (rows: the CTA's keys,
// columns: queries q0..) becomes P^T; lse_s holds the tile's lse * log2(e).
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

// One Q/dO tile: S^T and dP^T (the dP^T product runs on while P^T is
// formed), dv += P^T dO started before dS^T is formed in place of dP^T, then
// dk += dS^T Q; both from registers. rows[0] holds the tile's lse * log2(e),
// rows[1] its delta; `next` (the next tile's row entry, loaded before the
// products) goes to next_slot.
template <int N>
__device__ __forceinline__ void dkv_tile(float (&dk)[32], float (&dv)[32], uint32_t ks,
                                         uint32_t vs, uint32_t qs, uint32_t dos, const BwdArgs& a,
                                         int k0, int q0, int warp, int lane,
                                         const float (*rows)[BT], float* next_slot, float next) {
  float st[N / 2], dpt[N / 2];
  start_scores<N>(st, dpt, ks, qs, vs, dos);
  *next_slot = next;
  hp::wgmma_wait<1>();
  hp::fence_acc(st);
  // warp-uniform: every query of the tile sees every key of the warp
  const bool whole = !a.causal || k0 + warp * 16 + 15 <= max(q0, a.prefix - 1);
  const int key0 = k0 + warp * 16 + (lane >> 2), t4 = lane & 3;
  if (whole)
    dkv_probs<N, false>(st, a, key0, q0, t4, rows[0]);
  else
    dkv_probs<N, true>(st, a, key0, q0, t4, rows[0]);
  uint32_t fp[(N + 15) / 16][4], fd[(N + 15) / 16][4];
  pack_a<N>(fp, st);
  start_rs<(N + 15) / 16>(dv, fp, dos);
  hp::wgmma_wait<1>();  // dP^T (dv's product may still run)
  hp::fence_acc(dpt);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 del = *reinterpret_cast<const float2*>(&rows[1][8 * j + 2 * t4]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      dpt[i] = st[i] * (dpt[i] - ((e & 1) ? del.y : del.x)) * a.scale;
    }
  }
  pack_a<N>(fd, dpt);
  start_rs<(N + 15) / 16>(dk, fd, qs);
  hp::wgmma_wait<0>();
  hp::fence_acc(dk);
  hp::fence_acc(dv);
  fence_frag(fp);
  fence_frag(fd);
}

__global__ void __launch_bounds__(kThreads, 3) attention_bwd_dkv_kernel(const __grid_constant__ Maps maps,
                                                                   const BwdArgs a) {
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
  bf16* dk_out = a.dk + b * a.sdk.b + h * a.sdk.h;
  bf16* dv_out = a.dv + b * a.sdv.b + h * a.sdv.h;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  if (first >= nq) {  // keys no query sees: zero gradients
    store_tile(dk_out, a.sdk.l, k0, a.Lk, dk, warp, lane);
    store_tile(dv_out, a.sdv.l, k0, a.Lk, dv, warp, lane);
    return;
  }

  if (tid == 0) {
    init_barriers(bar, maps, kO);  // q, k, v
    hp::tma_prefetch_map(&maps.m[kDo]);
    hp::mbar_expect_tx(&bar[0], 2 * kTileBytes);
    load_tile(ks, &maps.m[kK], &bar[0], h, k0, b);
    load_tile(vs, &maps.m[kV], &bar[0], h, k0, b);
    for (int t = 0; t < kStages - 1 && first + t < nq; ++t) {  // the first Q/dO tiles
      hp::mbar_expect_tx(&bar[1 + t], 2 * kTileBytes);
      load_tile(stage_at(t), &maps.m[kQ], &bar[1 + t], h, (first + t) * BT, b);
      load_tile(stage_at(t) + kTileBytes, &maps.m[kDo], &bar[1 + t], h, (first + t) * BT, b);
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
      load_tile(stage_at(sa), &maps.m[kQ], &bar[1 + sa], h, ahead * BT, b);
      load_tile(stage_at(sa) + kTileBytes, &maps.m[kDo], &bar[1 + sa], h, ahead * BT, b);
    }
    // the next tile's lse or delta entry, staged a tile ahead
    const float next = qt + 1 < nq ? row_entry(qt + 1) : 0.f;
    float* next_slot = &rows_s[(it + 1) % kStages][tid / BT][tid & (BT - 1)];
    const int q0 = qt * BT, rem = a.Lq - q0;
    const uint32_t qs = stage_at(s), dos = qs + kTileBytes;
    if (rem > 32)
      dkv_tile<64>(dk, dv, ks, vs, qs, dos, a, k0, q0, warp, lane, rows_s[s], next_slot, next);
    else if (rem > 16)
      dkv_tile<32>(dk, dv, ks, vs, qs, dos, a, k0, q0, warp, lane, rows_s[s], next_slot, next);
    else if (rem > 8)
      dkv_tile<16>(dk, dv, ks, vs, qs, dos, a, k0, q0, warp, lane, rows_s[s], next_slot, next);
    else
      dkv_tile<8>(dk, dv, ks, vs, qs, dos, a, k0, q0, warp, lane, rows_s[s], next_slot, next);
    __syncthreads();  // every thread is done with this stage before it is loaded again
  }
  store_tile(dk_out, a.sdk.l, k0, a.Lk, dk, warp, lane);
  store_tile(dv_out, a.sdv.l, k0, a.Lk, dv, warp, lane);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

BwdArgs make_args(const void* lse, void* delta, void* dq, void* dk, void* dv, const long long* s,
                  int lq, int lk, int heads, float scale, int causal, int prefix, int nomax) {
  return BwdArgs{static_cast<const float*>(lse), static_cast<float*>(delta),
                 static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 strides_of(s, 5), strides_of(s, 6), strides_of(s, 7), lq, lk, heads, scale,
                 scale * kLog2e, nomax ? 80.f * kLog2e : std::numeric_limits<float>::infinity(), causal,
                 prefix};
}

}  // namespace

// q, o, do, dq: (batch, lq, heads, 64); k, v, dk, dv: (batch, lk, heads, 64);
// all bf16 with unit stride in head_dim and 16-byte aligned rows; `strides`
// holds the (batch, row, head) strides of q, k, v, o, do, dq, dk and dv in
// elements, 24 in all; offsets inside one batch item stay below 2**31.
// lse and delta: (batch, heads, lq) f32 contiguous. The dq entry writes delta
// and dq; the dk/dv entry reads delta, so it runs after the dq entry on the
// same stream. nomax = 1 recomputes P as exp(min(s, 80) - lse), lse = log(l)
// from the nomax forward. Each returns cudaGetLastError() after its launch,
// or cudaErrorInvalidValue if a tensor map cannot describe an operand.
extern "C" int ovt_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, void* delta, void* dq,
                                    const long long* strides, int batch, int lq, int lk,
                                    int heads, int head_dim, float scale, int causal,
                                    int prefix, int nomax, void* stream) {
  if (head_dim != HD) return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  const void* ops[kMaps] = {q, k, v, o, dout};
  for (int i = 0; i < kMaps; ++i) {
    const int rows = (i == kK || i == kV) ? lk : lq;
    if (!head_map(&maps.m[i], ops[i], strides_of(strides, i), heads, rows, batch))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a = make_args(lse, delta, dq, nullptr, nullptr, strides, lq, lk, heads, scale,
                              causal, prefix, nomax);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((lq + BT - 1) / BT, heads, batch);
  attention_bwd_dq_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(maps,
                                                                                         a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ovt_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, const long long* strides, int batch,
                                     int lq, int lk, int heads, int head_dim, float scale,
                                     int causal, int prefix, int nomax, void* stream) {
  if (head_dim != HD) return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  const void* ops[kMaps] = {q, k, v, nullptr, dout};
  for (int i = 0; i < kMaps; ++i) {
    if (i == kO) continue;
    const int rows = (i == kK || i == kV) ? lk : lq;
    if (!head_map(&maps.m[i], ops[i], strides_of(strides, i), heads, rows, batch))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a = make_args(lse, const_cast<void*>(delta), nullptr, dk, dv, strides, lq, lk,
                              heads, scale, causal, prefix, nomax);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((lk + BT - 1) / BT, heads, batch);
  attention_bwd_dkv_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(maps,
                                                                                           a);
  return static_cast<int>(cudaGetLastError());
}

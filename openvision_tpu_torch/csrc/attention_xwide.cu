// The forward attention kernel from head_dim 136 to 256, built beside
// attention.cu in a build of its own; attention.cu's entries call these. It
// replaces, at these head_dims, the attention core of the Pallas kernels
// that attention.cu lists (#1, #5, #7, #9, #11, #13, #14), with the same
// masks, LSE and roundings, in one launch a call.
//
// Bound on the H100: the bytes of q, k, v and o (at b=64, 16 heads, L=257,
// head_dim 136: 85.5 us; the FLOPs, 4 Lq Lk hd a head, come to about 0.6 of
// that at 989 TFLOP/s), then the exponentials as at 128.
//
// The design (what held attention_fwd.cuh's kernel here, two launches of a
// 64-row CTA, one a 128-column part of O, and what this does about it):
// - The CTA: two consumer warpgroups and a producer warpgroup (384
//   threads). The producer drops to 24 registers (setmaxnreg) and one of
//   its threads runs the TMA ring; the consumers rise to 240. Each consumer
//   owns 64 query rows (the CTA 128) and its rows' whole O in registers:
//   HDP / 2 <= 128 f32 a thread, no column parts, so the scores of a row
//   against a key tile are formed once (S = Q K^T, one wgmma group of HDP /
//   16 k16 steps from shared memory) and P V is one register-A chain, V's
//   full 64-column chunks side by side in one product of N = 128..256 a
//   k16 step (measured 10-13% faster at 192-256 than a product a chunk).
// - Sharing K and V: both consumers read the same stage, so a K/V byte that
//   reaches shared memory serves 128 query rows (64 before, twice over).
//   K and V have rings of their own (two stages each), so K of tile t + 2
//   loads as soon as both consumers' S of tile t is done, V of tile t + 2
//   once their P V of tile t is: the loads run a tile ahead of the products
//   (three stages, where they fit, measured no faster).
// - Overlap: within a consumer, tile t's S is issued before tile t - 1's
//   P V, so its softmax runs while the tensor cores hold P V; the two
//   consumers interleave on their own. Measured and dropped (H100, b=64):
//   named barriers that made the consumers take turns at issuing (3-10%
//   slower), and persistent CTAs that walk the row blocks and load the next
//   one's Q and K/V under the last one's tail (0.9-1.1x at L = 257, spills
//   from 176 up).
// - Where the time goes (H100, 136 at b=64, from L = 128 to 2048): about
//   5.5 us a CTA of fixed cost (the Q and first K/V loads, the pipeline's
//   fill and drain, the stores) and 1.75 us a key tile of both consumers,
//   against ~0.6 us of tensor-core time (S's operands both from shared
//   memory: N = 64 reads 4 KB a 32-cycle product, the bandwidth of shared
//   memory, for each consumer).
// - Shared memory: Q's two tiles and two stages each of K and V, six tiles
//   of 64 x HDP bf16: 193 KB at 256 (227 KB is the most a block takes).
//   Registers: 168 a thread at launch; after setmaxnreg 240 a consumer
//   thread (O's HDP / 2, S 32, P 16), no spill.
// - Padding: HDP is hd rounded up to 16 (144, 160, .., 256; attention.cuh's
//   chunks of 64, 32 and 16 columns, TMA's zero fill past hd): 136 runs at
//   144, where the column parts ran it at 192.
// - Short queries: where a CTA holds at most 64 rows (Lq <= 64: #13's 64 x
//   900 case, a decode-sized tail; or the last CTA at L = 257) a consumer
//   would idle, so the two split the key tiles instead: consumer c takes the
//   tiles of parity c, the stage of parity c and a producer thread of its
//   own (so that neither's loads wait behind the other's stage), over the
//   same 64 Q rows, and consumer 1 hands its (m, l, O) to consumer 0
//   through its own, now idle, stage of shared memory (64 x HDP f32 is one
//   K and one V tile) for the merge.
// - The last key tile runs at the narrowest wgmma N that covers it, as at
//   128; the masks, as attention.cu's.
#include "attention_fwd.cuh"

namespace {

constexpr int kXThreads = 3 * 128;  // consumers 0 and 1, then the producer warpgroup
constexpr int kQBar = 3;            // 3, 4: a consumer's Q scaled; 5: both (the split's shared Q)
constexpr int kXStages = 2;         // a ring each for K and V (three measured no faster)

template <int HDP>
struct XFwd {
  static constexpr int kTileBytes = Hd<HDP>::kTileBytes;  // 64 rows of HDP columns
  // Q's two tiles, then stage s's K and V side by side (the split's merge
  // buffer is consumer 1's stage, K and V together: 64 x HDP f32)
  static constexpr int kSmem = 1024 + 2 * kTileBytes + kXStages * 2 * kTileBytes;
  static_assert(kSmem + 2 * 2 * 128 * 4 + 256 <= 232448, "shared memory of a block");
};

// start_rs with the full 64-column chunks of T side by side in one product
// a k16 step (N = 128, 192 or 256), then the narrower rest chunk by chunk.
template <int HDP, int K, int KF>
__device__ __forceinline__ void start_rs_wide(float (&acc)[HDP / 2], const uint32_t (&f)[KF][4],
                                              uint32_t tile) {
  static_assert(K <= KF, "more k16 steps than fragments");
  using H = Hd<HDP>;
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    wgmma_rs<64 * H::kFull>(acc, f[kk], desc_mn<64>(tile, kk));
    for_chunks<HDP>([&](auto cc) {
      constexpr int c = decltype(cc)::value, W = H::width(c);
      if constexpr (c >= H::kFull)
        wgmma_rs<W>(acc + H::col(c) / 2, f[kk], desc_mn<W>(tile + H::off(c), kk));
    });
  }
  hp::wgmma_commit();
}

template <int HDP, bool kCausal, typename OutT>
__global__ void __launch_bounds__(kXThreads, 1)
    attention_fwd_xwide_kernel(const __grid_constant__ FwdMaps<HDP> maps, const FwdArgs a) {
  constexpr int kTileBytes = XFwd<HDP>::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_bar;
  __shared__ __align__(8) uint64_t k_full[kXStages], k_empty[kXStages];
  __shared__ __align__(8) uint64_t v_full[kXStages], v_empty[kXStages];
  __shared__ float merge_ml[2][2][128];  // the split: consumer 1's m and l, per thread

  const uint32_t raw = ovt::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  auto k_at = [&](int st) { return base + (2 + 2 * st) * kTileBytes; };
  auto v_at = [&](int st) { return k_at(st) + kTileBytes; };
  const int r0 = blockIdx.x * 2 * BT, h = blockIdx.y, b = blockIdx.z;
  // a CTA with at most 64 rows (Lq <= 64, or the last CTA of an Lq just
  // past a multiple of 128, as 257) splits the key tiles of one Q tile
  const bool split = a.Lq - r0 <= BT;
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
  const int nkv = (a.Lk + BT - 1) / BT;
  // the live key tiles of the CTA's rows are [0, last]
  const int last =
      kCausal ? min(nkv - 1, max(min(r0 + 2 * BT, a.Lq) - 1, a.prefix - 1) / BT) : nkv - 1;
  // tile t goes to stage t % 2 after t / 2 tiles before it there: in the
  // split, consumer c's tiles (t = c, c + 2, ..) all go to stage c
  static_assert(kXStages == 2, "the split gives each consumer one stage");

  if (tid == 0) {
    hp::mbar_init(&q_bar, 1);
    for (int s = 0; s < kXStages; ++s) {
      hp::mbar_init(&k_full[s], 1);
      hp::mbar_init(&v_full[s], 1);
      hp::mbar_init(&k_empty[s], split ? 4 : 8);  // one arrive per warp that reads the stage
      hp::mbar_init(&v_empty[s], split ? 4 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_maps(maps.q);
    prefetch_maps(maps.k);
    prefetch_maps(maps.v);
  }
  __syncthreads();

  // The producer: one thread runs both rings ahead, each stage as soon as
  // its readers release it; in the split, one thread a consumer's tiles, so
  // that neither consumer's loads wait behind the other's stage.
  if (wg == 2) {
    hp::setmaxnreg_dec<24>();
    if (t128 == 0) {
      hp::mbar_expect_tx(&q_bar, (split ? 1 : 2) * kTileBytes);
      load_tile(base, maps.q, &q_bar, h, r0, b);
      if (!split) load_tile(base + kTileBytes, maps.q, &q_bar, h, r0 + BT, b);
    }
    if (t128 == 0 || (split && t128 == 32)) {
      for (int t = t128 / 32; t <= last; t += split ? 2 : 1) {
        const int st = t % kXStages, n = t / kXStages;
        if (n > 0) hp::mbar_wait(&k_empty[st], (n - 1) & 1);
        hp::mbar_expect_tx(&k_full[st], kTileBytes);
        load_tile(k_at(st), maps.k, &k_full[st], a.hk + h, t * BT, b);
        if (n > 0) hp::mbar_wait(&v_empty[st], (n - 1) & 1);
        hp::mbar_expect_tx(&v_full[st], kTileBytes);
        load_tile(v_at(st), maps.v, &v_full[st], a.hv + h, t * BT, b);
      }
    }
    return;
  }
  hp::setmaxnreg_inc<240>();

  const int c = wg;  // this consumer
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(bar);
  };
  const uint32_t q = base + (split ? 0 : c * kTileBytes);
  hp::mbar_wait(&q_bar, 0);
  if (a.prescale) {  // the single-k order: q * scale rounded to bf16, in place (pad columns stay 0)
    if (!split || c == 0) {
      uint4* t = reinterpret_cast<uint4*>(smem + (q - base));
#pragma unroll
      for (int i = 0; i < kTileBytes / 16 / 128; ++i) {
        const uint4 v = t[t128 + 128 * i];
        uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = ovt::unpack_bf16x2(w[e]);
          w[e] = ovt::pack_bf16x2(f.x * a.scale, f.y * a.scale);
        }
        t[t128 + 128 * i] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    // the generic writes before wgmma's (async proxy) reads, in every reader
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (split)
      hp::named_barrier(kQBar + 2, 256);
    else
      hp::named_barrier(kQBar + c, 128);
  }

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const int rbase = split ? r0 : r0 + c * BT;  // this consumer's first row
  const int wrow = rbase + warp * 16, row0 = wrow + (lane >> 2), col_lane = 2 * (lane & 3);

  // Tile t's S is issued before the previous own tile's P V (a whole tile).
  uint32_t p[BT / 16][4];  // the previous own tile's probabilities, A fragments
  const int step = split ? 2 : 1;
  int prev = -1;
  for (int t = split ? c : 0; t <= last; t += step) {
    const int st = t % kXStages, pst = prev % kXStages, k0 = t * BT;
    hp::mbar_wait(&k_full[st], t / kXStages & 1);
    if (prev >= 0) hp::mbar_wait(&v_full[pst], prev / kXStages & 1);
    auto tile = [&](auto n) {
      constexpr int N = decltype(n)::value;
      float s[N / 2];
      hp::wgmma_fence();
      start_ss<HDP, N>(s, q, k_at(st));
      if (prev >= 0) start_rs_wide<HDP, BT / 16>(o, p, v_at(pst));
      if (prev >= 0)
        hp::wgmma_wait<1>();
      else
        hp::wgmma_wait<0>();
      hp::fence_acc(s);
      release(&k_empty[st]);
      float alpha[2];
      softmax_tile<N, kCausal>(s, m, l, alpha, a, k0, row0, col_lane + k0, wrow);
      if (prev >= 0) {
        hp::wgmma_wait<0>();
        hp::fence_acc(o);
        fence_frag(p);
        release(&v_empty[pst]);
      }
      if (!a.nomax) rescale<HDP>(o, alpha);
      pack_a<N>(p, s);
    };
    if (t == last)
      by_width(a.Lk - k0, tile);
    else
      tile(std::integral_constant<int, BT>{});
    prev = t;
  }
  if (prev >= 0) {  // the last own tile's P V
    const int st = prev % kXStages;
    hp::mbar_wait(&v_full[st], prev / kXStages & 1);
    by_width(a.Lk - prev * BT, [&](auto n) {
      constexpr int N = decltype(n)::value;
      start_rs_wide<HDP, (N + 15) / 16>(o, p, v_at(st));
      hp::wgmma_wait<0>();
      hp::fence_acc(o);
      fence_frag(p);
    });
    release(&v_empty[st]);
  }

  if (split) {  // consumer 1's (m, l, O) into its stage, merged by consumer 0
    float* ob = reinterpret_cast<float*>(smem + (k_at(1) - base));
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) ob[i * 128 + t128] = o[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        merge_ml[0][r][t128] = m[r];
        merge_ml[1][r][t128] = l[r];
      }
    }
    hp::named_barrier(kQBar + 2, 256);
    if (c == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = merge_ml[0][r][t128], mm = fmaxf(m[r], m1);
      a0[r] = a1[r] = 1.f;  // nomax (m stays -inf), or no visible key on either side
      if (mm != -INFINITY) {
        a0[r] = ex2((m[r] - mm) * a.c);
        a1[r] = ex2((m1 - mm) * a.c);
      }
      l[r] = l[r] * a0[r] + merge_ml[1][r][t128] * a1[r];
      m[r] = mm;
    }
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i)
      o[i] = o[i] * a0[(i >> 1) & 1] + ob[i * 128 + t128] * a1[(i >> 1) & 1];
  }
  finish_rows<HDP>(static_cast<OutT*>(a.o) + b * a.so.b + h * a.so.h, a, b, h, rbase, row0, o, m,
                   l, warp, lane);
}

template <int HDP, bool kCausal, typename OutT>
int run_xwide(const FwdMaps<HDP>& maps, const FwdArgs& a, int batch, cudaStream_t stream) {
  constexpr int kSmem = XFwd<HDP>::kSmem;
  static const cudaError_t attr =
      cudaFuncSetAttribute(attention_fwd_xwide_kernel<HDP, kCausal, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Lq + 2 * BT - 1) / (2 * BT), a.H, batch);
  attention_fwd_xwide_kernel<HDP, kCausal, OutT><<<grid, kXThreads, kSmem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_xwide(const FwdMaps<HDP>& maps, const FwdArgs& a, int batch, int out_f32,
                 void* stream) {
  if (a.Lq == 0 || a.H == 0 || batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)  // the int8 block: unmasked
    return run_xwide<HDP, false, float>(maps, a, batch, st);
  return a.causal ? run_xwide<HDP, true, bf16>(maps, a, batch, st)
                  : run_xwide<HDP, false, bf16>(maps, a, batch, st);
}

}  // namespace

int attention_xwide(const void* qkv, void* out, int batch, int seq, int heads, int head_dim,
                    float scale, int nomax, int causal, int prefix, int out_f32, void* stream) {
  return by_padded<144, 160, 176, 192, 208, 224, 240, 256>(
      fwd_padded_head_dim(head_dim), [&](auto hdp) {
        constexpr int HDP = decltype(hdp)::value;
        FwdMaps<HDP> maps;
        FwdArgs a;
        if (!packed_setup(&maps.q, &maps.k, &a, qkv, out, batch, seq, heads, head_dim, scale,
                          nomax, causal, prefix))
          return static_cast<int>(cudaErrorInvalidValue);
        maps.v = maps.k;
        return launch_xwide<HDP>(maps, a, batch, out_f32, stream);
      });
}

int flash_attention_xwide(const void* q, const void* k, const void* v, void* out, void* lse,
                          const long long* strides, int batch, int lq, int lk, int heads,
                          int head_dim, float scale, int prescale, int causal, int prefix,
                          int nomax, void* stream) {
  return by_padded<144, 160, 176, 192, 208, 224, 240, 256>(
      fwd_padded_head_dim(head_dim), [&](auto hdp) {
        constexpr int HDP = decltype(hdp)::value;
        FwdMaps<HDP> maps;
        FwdArgs a;
        if (!flash_setup(&maps.q, &maps.k, &maps.v, &a, q, k, v, out, lse, strides, batch, lq,
                         lk, heads, head_dim, scale, prescale, causal, prefix, nomax))
          return static_cast<int>(cudaErrorInvalidValue);
        return launch_xwide<HDP>(maps, a, batch, 0, stream);
      });
}

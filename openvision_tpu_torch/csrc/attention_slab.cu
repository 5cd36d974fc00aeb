// The forward attention kernels above head_dim 256, built beside
// attention.cu in a build of its own; attention.cu's entries call these.
// They replace, above 256, the attention core of the Pallas kernels that
// attention.cu lists (#1, #5, #7, #9, #11, #13, #14), as attention.cu's
// tile kernel does below, with the same masks, LSE and roundings. Bound: as
// attention.cu's (the bytes of q, k, v and o at the port's shapes).
//
// From 264 to 512 (attention_fwd_slabs_kernel): a CTA owns 64 query rows of
// one head and holds the whole head_dim, cut into NW = ceil(hd / 128)
// slabs of 128 columns (attention.cuh's slabs), one consumer warpgroup a
// slab. Consumer w owns Q's, K's, V's and O's columns [128 w, 128 w + 128).
// For each key tile it forms a partial S over its slab (a wgmma group of
// depth 128), the partials are summed once through shared memory (each
// consumer writes its own f32 partial, then every consumer adds all NW in
// the same order, so all hold the same S to the bit), every consumer runs
// the same online softmax on it and P V over its own V columns. K and V
// tiles land in shared memory once a CTA, through TMA rings (a ring each,
// two stages), where the per-part kernel loaded them once a part and formed
// the scores ceil(hd / 128) times. Tile t + 1's partial S is issued with
// tile t's P V, so the sum and the softmax of a tile run under a P V.
// The budget at 512 (NW = 4, one CTA an SM): the register file is four
// partitions of 16,384, a warp in one of them, so 16 warps get 128
// registers a thread (O's 64 columns, S 16, P 8) where a 17th, producer
// warp would cut every warp to 96 (ptxas: 96 registers, ~400 bytes of
// spill) and a producer warpgroup under setmaxnreg leaves the consumers 112.
// So there is no producer: thread 0 issues the TMA loads between its own
// products, each tile's K two tiles ahead (once every warp has released
// the stage after its partial S) and V one tile ahead (after the P V).
// Shared memory: Q's 64 rows (64 KB), two stages each of 32-key K and V
// tiles (128 KB), the partials (32 KB): 225 KB of the 227 KB a block takes.
// 64-key tiles do not fit beside Q there, hence 32-key ones at every width
// (at NW = 3: 169 KB). ptxas: 125 registers at NW = 4, 135-139 at NW = 3,
// no spill.
//
// Above 512 (attention_fwd_slab_kernel, the per-part kernel): a CTA owns 64
// rows and one 128-column part of O and streams the (Q, K) slab pairs of
// the whole head_dim through one ring for each key tile, so the scores are
// formed once a part; more slabs than four do not fit beside each other in
// registers. No tower has such a head_dim.
#include "attention_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// From 264 to 512: one consumer warpgroup a slab, the scores formed once
// ---------------------------------------------------------------------------

constexpr int kSlabKeys = 32;  // keys of a K or V tile
constexpr int kSlabRing = 2;   // stages of each of the K and V rings
constexpr int kSumBar = 8;     // named barriers 8..11: warp j of every consumer (the partials)

template <int NW>  // slabs = consumer warpgroups
struct Slabs {
  static_assert(NW == 3 || NW == 4, "264..384: three slabs, 392..512: four");
  static constexpr int kThreads = NW * 128;  // the consumers; thread 0 also loads
  static constexpr int kQBytes = NW * BT * kSlab * 2;          // 16 KB a slab
  static constexpr int kKvBytes = NW * kSlabKeys * kSlab * 2;  // 8 KB a slab
  static constexpr int kPartBytes = BT * kSlabKeys * 4;         // a consumer's f32 partial S
  static constexpr int kSmem = 1024 + kQBytes + 2 * kSlabRing * kKvBytes + NW * kPartBytes;
  static_assert(kSmem <= 232448 - 128, "shared memory of a block");
};

struct SlabsMaps {
  OpMaps<64> q, k, v;  // q in 64-row boxes, k and v in 32-row ones
};

template <int NW, bool kCausal, typename OutT>
__global__ void __launch_bounds__(Slabs<NW>::kThreads, 1)
    attention_fwd_slabs_kernel(const __grid_constant__ SlabsMaps maps, const FwdArgs a) {
  using C = Slabs<NW>;
  constexpr int kQSlab = BT * kSlab * 2, kKvSlab = kSlabKeys * kSlab * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_bar;
  __shared__ __align__(8) uint64_t k_full[kSlabRing], k_empty[kSlabRing];
  __shared__ __align__(8) uint64_t v_full[kSlabRing], v_empty[kSlabRing];

  // Q's slabs, the K stages, the V stages, the consumers' partial S
  const uint32_t raw = ovt::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  auto k_at = [&](int st) { return base + C::kQBytes + st * C::kKvBytes; };
  auto v_at = [&](int st) { return k_at(kSlabRing + st); };
  float* part = reinterpret_cast<float*>(smem + C::kQBytes + 2 * kSlabRing * C::kKvBytes);
  const int r0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 7, t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
  const int nkv = (a.Lk + kSlabKeys - 1) / kSlabKeys;
  const int last = kCausal
                       ? min(nkv - 1, max(min(r0 + BT, a.Lq) - 1, a.prefix - 1) / kSlabKeys)
                       : nkv - 1;

  if (tid == 0) {
    hp::mbar_init(&q_bar, 1);
    for (int s = 0; s < kSlabRing; ++s) {
      hp::mbar_init(&k_full[s], 1);
      hp::mbar_init(&v_full[s], 1);
      hp::mbar_init(&k_empty[s], 4 * NW);  // one arrive per warp
      hp::mbar_init(&v_empty[s], 4 * NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_maps(maps.q);
    prefetch_maps(maps.k);
    prefetch_maps(maps.v);
  }
  __syncthreads();
  // Thread 0's loads: tile t's K (V) slabs into stage t % kSlabRing.
  auto load_k = [&](int t) {
    const int st = t % kSlabRing;
    hp::mbar_expect_tx(&k_full[st], C::kKvBytes);
    for (int j = 0; j < NW; ++j)
      load_slab(k_at(st) + j * kKvSlab, maps.k, &k_full[st], j, a.hk + h, t * kSlabKeys, b,
                kSlabKeys);
  };
  auto load_v = [&](int t) {
    const int st = t % kSlabRing;
    hp::mbar_expect_tx(&v_full[st], C::kKvBytes);
    for (int j = 0; j < NW; ++j)
      load_slab(v_at(st) + j * kKvSlab, maps.v, &v_full[st], j, a.hv + h, t * kSlabKeys, b,
                kSlabKeys);
  };
  if (tid == 0) {  // Q's slabs and both stages of each ring
    hp::mbar_expect_tx(&q_bar, C::kQBytes);
    for (int j = 0; j < NW; ++j) load_slab(base + j * kQSlab, maps.q, &q_bar, j, h, r0, b, BT);
    for (int t = 0; t < kSlabRing && t <= last; ++t) {
      load_k(t);
      load_v(t);
    }
  }
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(bar);
  };

  const uint32_t q = base + w * kQSlab;
  hp::mbar_wait(&q_bar, 0);
  if (a.prescale) {  // the single-k order: this slab of q * scale rounded to bf16, in place
    uint4* t = reinterpret_cast<uint4*>(smem + (q - base));
#pragma unroll
    for (int i = 0; i < kQSlab / 16 / 128; ++i) {
      const uint4 v = t[t128 + 128 * i];
      uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = ovt::unpack_bf16x2(u[e]);
        u[e] = ovt::pack_bf16x2(f.x * a.scale, f.y * a.scale);
      }
      t[t128 + 128 * i] = make_uint4(u[0], u[1], u[2], u[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    hp::named_barrier(1 + w, 128);
  }

  // S = the sum of the NW partials, in the order 0, 1, ..: each thread holds
  // the same fragment entries in every consumer, so thread t128 of
  // consumer u writes, and threads t128 of the others read, entry i at
  // (u, i, t128). Warp j of every consumer meets on barrier kSumBar + j
  // before the write (the others have read the last tile's) and after it.
  auto sum_partials = [&](float (&s)[kSlabKeys / 2]) {
    hp::named_barrier(kSumBar + warp, 32 * NW);
#pragma unroll
    for (int i = 0; i < kSlabKeys / 2; ++i) part[(w * kSlabKeys / 2 + i) * 128 + t128] = s[i];
    hp::named_barrier(kSumBar + warp, 32 * NW);
#pragma unroll
    for (int i = 0; i < kSlabKeys / 2; ++i) {
      float x = w == 0 ? s[i] : part[i * 128 + t128];
#pragma unroll
      for (int u = 1; u < NW; ++u) x += u == w ? s[i] : part[(u * kSlabKeys / 2 + i) * 128 + t128];
      s[i] = x;
    }
  };

  float o[kSlab / 2];  // this slab's columns of O
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const int wrow = r0 + warp * 16, row0 = wrow + (lane >> 2), col_lane = 2 * (lane & 3);
  uint32_t p[kSlabKeys / 16][4];  // the previous tile's probabilities, A fragments
  for (int t = 0; t <= last; ++t) {
    const int st = t % kSlabRing, k0 = t * kSlabKeys, pst = (t + kSlabRing - 1) % kSlabRing;
    float s[kSlabKeys / 2];
    hp::mbar_wait(&k_full[st], (t / kSlabRing) & 1);
    if (t > 0) hp::mbar_wait(&v_full[pst], ((t - 1) / kSlabRing) & 1);
    hp::wgmma_fence();
    slab_ss<kSlabKeys>(s, q, BT, k_at(st) + w * kKvSlab, kSlabKeys, false);
    if (t > 0) {
      slab_rs<kSlabKeys / 16>(o, p, v_at(pst) + w * kKvSlab, kSlabKeys);
      hp::wgmma_wait<1>();
    } else {
      hp::wgmma_wait<0>();
    }
    hp::fence_acc(s);
    release(&k_empty[st]);
    sum_partials(s);
    if (tid == 0 && t + kSlabRing <= last) {  // K two tiles ahead, once every warp is done with t's
      hp::mbar_wait(&k_empty[st], (t / kSlabRing) & 1);
      load_k(t + kSlabRing);
    }
    __syncwarp();
    float alpha[2];
    softmax_tile<kSlabKeys, kCausal>(s, m, l, alpha, a, k0, row0, col_lane + k0, wrow);
    if (t > 0) {
      hp::wgmma_wait<0>();
      hp::fence_acc(o);
      fence_frag(p);
      release(&v_empty[pst]);
      if (tid == 0 && t + 1 <= last) {  // V one tile ahead, into t - 1's stage
        hp::mbar_wait(&v_empty[pst], ((t - 1) / kSlabRing) & 1);
        load_v(t + 1);
      }
      __syncwarp();
    }
    if (!a.nomax) rescale<kSlab>(o, alpha);
    pack_a<kSlabKeys>(p, s);
  }
  {  // the last tile's P V
    const int st = last % kSlabRing;
    hp::mbar_wait(&v_full[st], (last / kSlabRing) & 1);
    slab_rs<kSlabKeys / 16>(o, p, v_at(st) + w * kKvSlab, kSlabKeys);
    hp::wgmma_wait<0>();
    hp::fence_acc(o);
    fence_frag(p);
    release(&v_empty[st]);
  }
  finish_rows<kSlab>(static_cast<OutT*>(a.o) + b * a.so.b + h * a.so.h, a, b, h, r0, row0, o, m,
                     l, warp, lane, kSlab * w, w == 0);
}

template <int NW, bool kCausal, typename OutT>
int run_slabs(const SlabsMaps& maps, const FwdArgs& a, int batch, cudaStream_t stream) {
  using C = Slabs<NW>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(attention_fwd_slabs_kernel<NW, kCausal, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Lq + BT - 1) / BT, a.H, batch);
  attention_fwd_slabs_kernel<NW, kCausal, OutT><<<grid, C::kThreads, C::kSmem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_nw(const SlabsMaps& maps, const FwdArgs& a, int batch, int out_f32, cudaStream_t st) {
  if (out_f32) return run_slabs<NW, false, float>(maps, a, batch, st);
  return a.causal ? run_slabs<NW, true, bf16>(maps, a, batch, st)
                  : run_slabs<NW, false, bf16>(maps, a, batch, st);
}

int launch_slabs(const SlabsMaps& maps, const FwdArgs& a, int batch, int out_f32, void* stream) {
  if (a.Lq == 0 || a.H == 0 || batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.hd <= 3 * kSlab ? launch_nw<3>(maps, a, batch, out_f32, st)
                           : launch_nw<4>(maps, a, batch, out_f32, st);
}

// ---------------------------------------------------------------------------
// Above 512: the per-part kernel (attention.cuh's slabs)
// ---------------------------------------------------------------------------
//
// A CTA owns 64 query rows of one head and one 128-column part of O. For
// each live key tile it streams the (Q, K) slab pairs of the whole head_dim
// through the ring, accumulating the 64 x 64 scores over them (Q's slab
// scaled in place first under `prescale`), runs the tile's online softmax
// as the tile kernel does, then streams the part's V slab for P V. The
// scores are formed once a part (ceil(hd / 128) times in all), the price
// of a shared memory that does not grow with the head_dim; the S of the
// next tile does not overlap this tile's P V.

struct SlabFwdMaps {
  OpMaps<64> q, k, v;
};

template <bool kCausal, typename OutT>
__global__ void __launch_bounds__(kSlabThreads, 1)
    attention_fwd_slab_kernel(const __grid_constant__ SlabFwdMaps maps, const FwdArgs a) {
  constexpr uint32_t kSlabBytes = BT * kSlab * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kSlabStages];
  __shared__ __align__(8) uint64_t empty[kSlabStages];
  const uint32_t raw = ovt::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const SlabRing ring{full, empty, base};
  const int slabs = (a.hd + kSlab - 1) / kSlab;
  const int r0 = blockIdx.x * BT, h = blockIdx.y / slabs, part = blockIdx.y % slabs;
  const int b = blockIdx.z, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkv = (a.Lk + BT - 1) / BT;
  const int last =
      kCausal ? min(nkv - 1, max(min(r0 + BT, a.Lq) - 1, a.prefix - 1) / BT) : nkv - 1;

  if (tid == 0) {
    ring.init();
    prefetch_maps(maps.q);
    prefetch_maps(maps.k);
    prefetch_maps(maps.v);
  }
  __syncthreads();
  if (tid >= 128) {  // the producer: per key tile, every (Q, K) slab pair, then the part's V slab
    if (tid == 128) {
      int t = 0;
      for (int kt = 0; kt <= last; ++kt) {
        for (int j = 0; j < slabs; ++j, ++t) {
          const uint32_t st = ring.acquire(t, 2 * kSlabBytes);
          load_slab(st, maps.q, ring.bar(t), j, h, r0, b, BT);
          load_slab(st + kSlabBytes, maps.k, ring.bar(t), j, a.hk + h, kt * BT, b, BT);
        }
        load_slab(ring.acquire(t, kSlabBytes), maps.v, ring.bar(t), part, a.hv + h, kt * BT, b,
                  BT);
        ++t;
      }
    }
    return;
  }

  float o[kSlab / 2];  // this part's columns of O
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const int wrow = r0 + warp * 16, row0 = wrow + (lane >> 2), col_lane = 2 * (lane & 3);
  uint32_t p[BT / 16][4];
  int t = 0;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BT;
    float s[BT / 2];
    for (int j = 0; j < slabs; ++j, ++t) {
      const uint32_t qs = ring.wait(t);
      if (a.prescale) {  // q * scale rounded to bf16, in place (pad columns stay 0)
        uint4* q4 = reinterpret_cast<uint4*>(smem + (qs - base));
#pragma unroll
        for (int i = 0; i < static_cast<int>(kSlabBytes) / 16 / 128; ++i) {
          const uint4 v = q4[tid + 128 * i];
          uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float2 f = ovt::unpack_bf16x2(w[c]);
            w[c] = ovt::pack_bf16x2(f.x * a.scale, f.y * a.scale);
          }
          q4[tid + 128 * i] = make_uint4(w[0], w[1], w[2], w[3]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        hp::named_barrier(1, 128);
      }
      hp::wgmma_fence();
      slab_ss<BT>(s, qs, BT, qs + kSlabBytes, BT, j > 0);
      hp::wgmma_wait<0>();
      hp::fence_acc(s);
      ring.release(t, lane);
    }
    float alpha[2];
    softmax_tile<BT, kCausal>(s, m, l, alpha, a, k0, row0, col_lane + k0, wrow);
    if (!a.nomax) rescale<kSlab>(o, alpha);
    pack_a<BT>(p, s);
    start_rs<kSlab, BT / 16>(o, p, ring.wait(t));
    hp::wgmma_wait<0>();
    hp::fence_acc(o);
    fence_frag(p);
    ring.release(t, lane);
    ++t;
  }

  finish_rows<kSlab>(static_cast<OutT*>(a.o) + b * a.so.b + h * a.so.h, a, b, h, r0, row0, o, m,
                     l, warp, lane, part * kSlab, part == 0);
}

template <bool kCausal, typename OutT>
int run_slab(const SlabFwdMaps& maps, const FwdArgs& a, int batch, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(attention_fwd_slab_kernel<kCausal, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Lq + BT - 1) / BT, a.H * ((a.hd + kSlab - 1) / kSlab), batch);
  attention_fwd_slab_kernel<kCausal, OutT><<<grid, kSlabThreads, kSlabSmem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_slab(const SlabFwdMaps& maps, const FwdArgs& a, int batch, int out_f32, void* stream) {
  if (a.Lq == 0 || a.H == 0 || batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32) return run_slab<false, float>(maps, a, batch, st);
  return a.causal ? run_slab<true, bf16>(maps, a, batch, st)
                  : run_slab<false, bf16>(maps, a, batch, st);
}

// The packed (B, L, 3D) QKV entry above head_dim 256.
int fwd_packed_slab(const void* qkv, void* out, int batch, int seq, int heads, int hd, float scale,
                    int nomax, int causal, int prefix, int out_f32, void* stream) {
  FwdArgs a;
  if (hd <= 4 * kSlab) {
    SlabsMaps maps;
    if (!packed_setup(&maps.q, &maps.k, &a, qkv, out, batch, seq, heads, hd, scale, nomax, causal,
                      prefix, kSlabKeys))
      return static_cast<int>(cudaErrorInvalidValue);
    maps.v = maps.k;
    return launch_slabs(maps, a, batch, out_f32, stream);
  }
  SlabFwdMaps maps;
  if (!packed_setup(&maps.q, &maps.k, &a, qkv, out, batch, seq, heads, hd, scale, nomax, causal,
                    prefix))
    return static_cast<int>(cudaErrorInvalidValue);
  maps.v = maps.k;
  return launch_slab(maps, a, batch, out_f32, stream);
}

// The flash entry above head_dim 256.
int fwd_flash_slab(const void* q, const void* k, const void* v, void* out, void* lse,
                   const long long* strides, int batch, int lq, int lk, int heads, int hd,
                   float scale, int prescale, int causal, int prefix, int nomax, void* stream) {
  FwdArgs a;
  if (hd <= 4 * kSlab) {
    SlabsMaps maps;
    if (!flash_setup(&maps.q, &maps.k, &maps.v, &a, q, k, v, out, lse, strides, batch, lq, lk,
                     heads, hd, scale, prescale, causal, prefix, nomax, kSlabKeys))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_slabs(maps, a, batch, 0, stream);
  }
  SlabFwdMaps maps;
  if (!flash_setup(&maps.q, &maps.k, &maps.v, &a, q, k, v, out, lse, strides, batch, lq, lk,
                   heads, hd, scale, prescale, causal, prefix, nomax))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_slab(maps, a, batch, 0, stream);
}

}  // namespace

int attention_slab(const void* qkv, void* out, int batch, int seq, int heads, int head_dim,
                   float scale, int nomax, int causal, int prefix, int out_f32, void* stream) {
  return fwd_packed_slab(qkv, out, batch, seq, heads, head_dim, scale, nomax, causal, prefix,
                         out_f32, stream);
}

int flash_attention_slab(const void* q, const void* k, const void* v, void* out, void* lse,
                         const long long* strides, int batch, int lq, int lk, int heads,
                         int head_dim, float scale, int prescale, int causal, int prefix,
                         int nomax, void* stream) {
  return fwd_flash_slab(q, k, v, out, lse, strides, batch, lq, lk, heads, head_dim, scale,
                        prescale, causal, prefix, nomax, stream);
}

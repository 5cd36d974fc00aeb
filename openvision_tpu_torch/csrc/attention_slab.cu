// The forward attention kernel above head_dim 256, built beside attention.cu
// in a build of its own; attention.cu's entries call these. It streams the
// head_dim in 128-column slabs (attention.cuh's slabs), ceil(hd / 128)
// column parts of O in one launch. It replaces, above 256, the attention
// core of the Pallas kernels that attention.cu lists (#1, #5, #7, #9, #11,
// #13, #14), as attention.cu's tile kernel does below. Bound: as
// attention.cu's (the bytes of q, k, v and o at the port's shapes); the
// slabs recompute the scores once a column part.
#include "attention_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// Above head_dim 256: the slab kernel (attention.cuh's slabs)
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] <= 0.f) l[r] = 1.f;  // no visible key: o = 0
  }
  store_out<kSlab>(static_cast<OutT*>(a.o) + b * a.so.b + h * a.so.h + part * kSlab, a.so.l, r0,
                   a.Lq, a.hd - part * kSlab, o, l, warp, lane);
  if (part == 0 && a.lse != nullptr && (lane & 3) == 0) {
    float* lrow = a.lse + (static_cast<long long>(b) * a.H + h) * a.Lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.Lq) lrow[row] = (m[r] == -INFINITY ? 0.f : m[r] * a.sc) + logf(l[r]);
    }
  }
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
  const int d = heads * hd;
  SlabFwdMaps maps;
  if (!head_maps(&maps.q, qkv, Strides{static_cast<long long>(seq) * 3 * d, 3 * d, hd}, hd,
                 3 * heads, seq, batch))
    return static_cast<int>(cudaErrorInvalidValue);
  maps.k = maps.v = maps.q;
  FwdArgs a = make_args(out, nullptr, Strides{static_cast<long long>(seq) * d, d, hd}, seq, seq,
                        heads, hd, scale, 1, nomax, causal, prefix);
  a.hk = heads;
  a.hv = 2 * heads;
  return launch_slab(maps, a, batch, out_f32, stream);
}

// The flash entry above head_dim 256.
int fwd_flash_slab(const void* q, const void* k, const void* v, void* out, void* lse,
                   const long long* strides, int batch, int lq, int lk, int heads, int hd,
                   float scale, int prescale, int causal, int prefix, int nomax, void* stream) {
  SlabFwdMaps maps;
  if (!head_maps(&maps.q, q, strides_of(strides, 0), hd, heads, lq, batch) ||
      !head_maps(&maps.k, k, strides_of(strides, 1), hd, heads, lk, batch) ||
      !head_maps(&maps.v, v, strides_of(strides, 2), hd, heads, lk, batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a = make_args(out, lse, strides_of(strides, 3), lq, lk, heads, hd, scale,
                              prescale, nomax, causal, prefix);
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

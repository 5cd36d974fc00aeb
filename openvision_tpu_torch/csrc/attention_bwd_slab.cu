// The attention backward pair above head_dim 256, built beside
// attention_bwd.cu in a build of its own; attention_bwd.cu's entries call
// these. Each streams the head_dim in 128-column slabs (attention.cuh's
// slabs), ceil(hd / 128) column parts of dq (or dk and dv) in one launch.
// They replace, above 256, the Pallas backward kernels that
// attention_bwd.cu lists (#15 _dq_kernel, #16 _dkv_kernel), as its tile
// kernels do below. Bound: as attention_bwd.cu's (the bytes of the
// operands); the slabs recompute the scores once a column part.
#include "attention_bwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// Above head_dim 256: the slab kernels (attention.cuh's slabs)
// ---------------------------------------------------------------------------
//
// The dq kernel: a CTA owns 64 queries of one head and one 128-column part
// of dq. It first streams the (dO, O) slab pairs for delta, then per live
// key tile the (Q, K) slab pairs for S and the (dO, V) pairs for dP, forms
// P and dS in registers as the tile kernel does (dq_probs), and streams
// the part's K slab for dq += dS K. The dk/dv kernel: a CTA owns 64 keys
// and one part of dk and dv, and walks the query tiles of 32 rows (its Q
// and dO maps read 32-row boxes: S^T and dP^T of 64 keys by 32 queries keep
// its registers where the tile kernel's 256 instance has them), streaming
// the (K, Q) and (V, dO) slab pairs for S^T and dP^T, then the part's (Q,
// dO) slabs for dv += P^T dO and dk += dS^T Q. Each reads K and V (or Q and
// dO) again for every tile of the other side, from L2, and forms the scores
// once a part: the price of a shared memory that does not grow with the
// head_dim.

constexpr int kQt = 32;  // the dk/dv slab kernel's query tile

struct SlabBwdMaps {
  OpMaps<64> m[kMaps];
};

__global__ void __launch_bounds__(kSlabThreads, 1)
    attention_bwd_dq_slab_kernel(const __grid_constant__ SlabBwdMaps maps, const BwdArgs a) {
  constexpr uint32_t kSlabBytes = BT * kSlab * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kSlabStages];
  __shared__ __align__(8) uint64_t empty[kSlabStages];
  __shared__ float delta_s[BT];
  const uint32_t raw = ovt::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);
  const SlabRing ring{full, empty, base};
  const int slabs = (a.hd + kSlab - 1) / kSlab;
  const int q0 = blockIdx.x * BT, h = blockIdx.y / slabs, part = blockIdx.y % slabs;
  const int b = blockIdx.z, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int last = (a.Lk + BT - 1) / BT - 1;  // the live key tiles are [0, last]
  if (a.causal) last = min(last, max(q0 + BT - 1, a.prefix - 1) / BT);

  if (tid == 0) {
    ring.init();
    for (int i = 0; i < kMaps; ++i) prefetch_maps(maps.m[i]);
  }
  __syncthreads();
  if (tid >= 128) {  // the producer
    if (tid == 128) {
      int t = 0;
      for (int j = 0; j < slabs; ++j, ++t) {  // delta's (dO, O) pairs
        const uint32_t st = ring.acquire(t, 2 * kSlabBytes);
        load_slab(st, maps.m[kDo], ring.bar(t), j, h, q0, b, BT);
        load_slab(st + kSlabBytes, maps.m[kO], ring.bar(t), j, h, q0, b, BT);
      }
      for (int kt = 0; kt <= last; ++kt) {
        for (int pass = 0; pass < 2; ++pass)  // (Q, K) for S, then (dO, V) for dP
          for (int j = 0; j < slabs; ++j, ++t) {
            const uint32_t st = ring.acquire(t, 2 * kSlabBytes);
            load_slab(st, maps.m[pass ? kDo : kQ], ring.bar(t), j, h, q0, b, BT);
            load_slab(st + kSlabBytes, maps.m[pass ? kV : kK], ring.bar(t), j, h, kt * BT, b,
                      BT);
          }
        load_slab(ring.acquire(t, kSlabBytes), maps.m[kK], ring.bar(t), part, h, kt * BT, b, BT);
        ++t;
      }
    }
    return;
  }

  int t = 0;
  {  // delta: two threads a row, each half of every chunk's 16-byte units
    const int r = tid >> 1;
    float acc = 0.f;
    for (int j = 0; j < slabs; ++j, ++t) {
      const uint8_t* d = smem + (ring.wait(t) - base);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int off = c * BT * 128 + swizzled<64>(r, 2 * i + (tid & 1));
          const uint4 d4 = *reinterpret_cast<const uint4*>(d + off);
          const uint4 o4 = *reinterpret_cast<const uint4*>(d + kSlabBytes + off);
          const uint32_t dw[4] = {d4.x, d4.y, d4.z, d4.w}, ow[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float2 d2 = ovt::unpack_bf16x2(dw[w]), o2 = ovt::unpack_bf16x2(ow[w]);
            acc += d2.x * o2.x + d2.y * o2.y;
          }
        }
      // the generic reads before the next TMA write (async proxy) to this stage
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      ring.release(t, lane);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      if (part == 0 && q0 + r < a.Lq)
        a.delta[(static_cast<long long>(b) * a.H + h) * a.Lq + q0 + r] = acc;
    }
  }
  hp::named_barrier(1, 128);
  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8
  const float* lrow = a.lse + (static_cast<long long>(b) * a.H + h) * a.Lq;
  const float lse[2] = {row0 < a.Lq ? lrow[row0] * kLog2e : 0.f,
                        row0 + 8 < a.Lq ? lrow[row0 + 8] * kLog2e : 0.f};
  const float del[2] = {delta_s[warp * 16 + (lane >> 2)], delta_s[warp * 16 + (lane >> 2) + 8]};

  float dq[kSlab / 2];  // this part's columns of dq
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) dq[i] = 0.f;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BT;
    float s[BT / 2], dp[BT / 2];
    for (int j = 0; j < slabs; ++j, ++t) {
      const uint32_t st = ring.wait(t);
      hp::wgmma_fence();
      slab_ss<BT>(s, st, BT, st + kSlabBytes, BT, j > 0);
      hp::wgmma_wait<0>();
      hp::fence_acc(s);
      ring.release(t, lane);
    }
    for (int j = 0; j < slabs; ++j, ++t) {
      const uint32_t st = ring.wait(t);
      hp::wgmma_fence();
      slab_ss<BT>(dp, st, BT, st + kSlabBytes, BT, j > 0);
      hp::wgmma_wait<0>();
      hp::fence_acc(dp);
      ring.release(t, lane);
    }
    const int col0 = k0 + 2 * (lane & 3);
    const bool whole =
        k0 + BT <= a.Lk && (!a.causal || k0 + BT - 1 <= max(q0 + warp * 16, a.prefix - 1));
    if (whole)
      dq_probs<BT, false>(s, a, row0, col0, lse);
    else
      dq_probs<BT, true>(s, a, row0, col0, lse);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = s[i] * (dp[i] - del[(i >> 1) & 1]) * a.scale;
    uint32_t f[BT / 16][4];
    pack_a<BT>(f, s);
    start_rs<kSlab, BT / 16>(dq, f, ring.wait(t));
    hp::wgmma_wait<0>();
    hp::fence_acc(dq);
    fence_frag(f);
    ring.release(t, lane);
    ++t;
  }
  if (a.dq_round) {
#pragma unroll
    for (int i = 0; i < kSlab / 2; ++i) dq[i] = round_bf16(dq[i]);
  }
  store_tile<kSlab>(a.dq + b * a.sdq.b + h * a.sdq.h + part * kSlab, a.sdq.l, q0, a.Lq,
                    a.hd - part * kSlab, dq, warp, lane, a.dq_scale, a.dq_scale);
}

__global__ void __launch_bounds__(kSlabThreads, 1)
    attention_bwd_dkv_slab_kernel(const __grid_constant__ SlabBwdMaps maps, const BwdArgs a) {
  constexpr uint32_t kKBytes = BT * kSlab * 2, kQBytes = kQt * kSlab * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kSlabStages];
  __shared__ __align__(8) uint64_t empty[kSlabStages];
  __shared__ __align__(16) float rows_s[2][2][kQt];  // by tile parity: lse * log2(e), delta
  const uint32_t raw = ovt::smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  const SlabRing ring{full, empty, base};
  const int slabs = (a.hd + kSlab - 1) / kSlab;
  const int k0 = blockIdx.x * BT, h = blockIdx.y / slabs, part = blockIdx.y % slabs;
  const int b = blockIdx.z, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (a.Lq + kQt - 1) / kQt;
  const int first = (a.causal && k0 >= a.prefix) ? k0 / kQt : 0;
  bf16* dk_out = a.dk + b * a.sdk.b + h * a.sdk.h + part * kSlab;
  bf16* dv_out = a.dv + b * a.sdv.b + h * a.sdv.h + part * kSlab;
  const int hd = a.hd - part * kSlab;  // this part's columns below head_dim

  float dk[kSlab / 2], dv[kSlab / 2];
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) dk[i] = dv[i] = 0.f;
  if (first >= nq) {  // keys no query sees: zero gradients
    if (tid < 128) {
      store_tile<kSlab>(dk_out, a.sdk.l, k0, a.Lk, hd, dk, warp, lane);
      store_tile<kSlab>(dv_out, a.sdv.l, k0, a.Lk, hd, dv, warp, lane);
    }
    return;
  }
  if (tid == 0) {
    ring.init();
    for (int i = 0; i < kMaps; ++i)
      if (i != kO) prefetch_maps(maps.m[i]);
  }
  __syncthreads();
  if (tid >= 128) {  // the producer: per query tile (K, Q) pairs, (V, dO) pairs, the part's (Q, dO)
    if (tid == 128) {
      int t = 0;
      for (int qt = first; qt < nq; ++qt) {
        const int q0 = qt * kQt;
        for (int pass = 0; pass < 2; ++pass)
          for (int j = 0; j < slabs; ++j, ++t) {
            const uint32_t st = ring.acquire(t, kKBytes + kQBytes);
            load_slab(st, maps.m[pass ? kV : kK], ring.bar(t), j, h, k0, b, BT);
            load_slab(st + kKBytes, maps.m[pass ? kDo : kQ], ring.bar(t), j, h, q0, b, kQt);
          }
        const uint32_t st = ring.acquire(t, 2 * kQBytes);
        load_slab(st, maps.m[kQ], ring.bar(t), part, h, q0, b, kQt);
        load_slab(st + kQBytes, maps.m[kDo], ring.bar(t), part, h, q0, b, kQt);
        ++t;
      }
    }
    return;
  }

  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Lq;
  const int key0 = k0 + warp * 16 + (lane >> 2), t4 = lane & 3;
  int t = 0;
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * kQt, buf = (qt - first) & 1;
    if (tid < 2 * kQt) {  // this tile's lse (threads 0-31) and delta (32-63)
      const int q = q0 + (tid & (kQt - 1));
      rows_s[buf][tid / kQt][tid & (kQt - 1)] =
          q >= a.Lq ? 0.f : tid < kQt ? a.lse[row_base + q] * kLog2e : a.delta[row_base + q];
    }
    hp::named_barrier(1, 128);
    float st[kQt / 2], dpt[kQt / 2];
    for (int j = 0; j < slabs; ++j, ++t) {
      const uint32_t s0 = ring.wait(t);
      hp::wgmma_fence();
      slab_ss<kQt>(st, s0, BT, s0 + kKBytes, kQt, j > 0);
      hp::wgmma_wait<0>();
      hp::fence_acc(st);
      ring.release(t, lane);
    }
    for (int j = 0; j < slabs; ++j, ++t) {
      const uint32_t s0 = ring.wait(t);
      hp::wgmma_fence();
      slab_ss<kQt>(dpt, s0, BT, s0 + kKBytes, kQt, j > 0);
      hp::wgmma_wait<0>();
      hp::fence_acc(dpt);
      ring.release(t, lane);
    }
    // warp-uniform: every query of the tile sees every key of the warp
    const bool whole = !a.causal || k0 + warp * 16 + 15 <= max(q0, a.prefix - 1);
    if (whole)
      dkv_probs<kQt, false>(st, a, key0, q0, t4, rows_s[buf][0]);
    else
      dkv_probs<kQt, true>(st, a, key0, q0, t4, rows_s[buf][0]);
#pragma unroll
    for (int j = 0; j < kQt / 8; ++j) {
      const float2 del = *reinterpret_cast<const float2*>(&rows_s[buf][1][8 * j + 2 * t4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dpt[i] = st[i] * (dpt[i] - ((e & 1) ? del.y : del.x)) * a.scale;
      }
    }
    uint32_t fp[kQt / 16][4], fd[kQt / 16][4];
    pack_a<kQt>(fp, st);
    pack_a<kQt>(fd, dpt);
    const uint32_t qs = ring.wait(t);
    slab_rs<kQt / 16>(dv, fp, qs + kQBytes, kQt);
    slab_rs<kQt / 16>(dk, fd, qs, kQt);
    hp::wgmma_wait<0>();
    hp::fence_acc(dk);
    hp::fence_acc(dv);
    fence_frag(fp);
    fence_frag(fd);
    ring.release(t, lane);
    ++t;
  }
  store_tile<kSlab>(dk_out, a.sdk.l, k0, a.Lk, hd, dk, warp, lane);
  store_tile<kSlab>(dv_out, a.sdv.l, k0, a.Lk, hd, dv, warp, lane);
}

// The maps of the operands in `ops` (null: not read): rows lk for k and v;
// q and dO in boxes of `q_rows` rows.
bool make_slab_maps(SlabBwdMaps* maps, const void* const* ops, const long long* strides, int hd,
                    int heads, int lq, int lk, int batch, int q_rows) {
  for (int i = 0; i < kMaps; ++i) {
    if (ops[i] == nullptr) continue;
    const bool kv = i == kK || i == kV;
    if (!head_maps(&maps->m[i], ops[i], strides_of(strides, i), hd, heads, kv ? lk : lq, batch,
                   kv || i == kO ? BT : q_rows))
      return false;
  }
  return true;
}

template <class Kernel>
int run_slab(Kernel kernel, const SlabBwdMaps& maps, const BwdArgs& a, int rows, int batch,
             int box, void* stream) {
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((rows + box - 1) / box, a.H * ((a.hd + kSlab - 1) / kSlab), batch);
  kernel<<<grid, kSlabThreads, kSlabSmem, static_cast<cudaStream_t>(stream)>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

int bwd_dq_slab(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const void* lse, void* delta, void* dq, const long long* strides, int batch,
                int lq, int lk, int heads, int hd, float scale, int causal, int prefix, int nomax,
                float dq_scale, int dq_round, void* stream) {
  SlabBwdMaps maps;
  const void* ops[kMaps] = {q, k, v, o, dout};
  if (!make_slab_maps(&maps, ops, strides, hd, heads, lq, lk, batch, BT))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = make_args(lse, delta, dq, nullptr, nullptr, strides, lq, lk, heads, hd, scale,
                              causal, prefix, nomax, dq_scale, dq_round);
  return run_slab(attention_bwd_dq_slab_kernel, maps, a, lq, batch, BT, stream);
}

int bwd_dkv_slab(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dk, void* dv, const long long* strides, int batch,
                 int lq, int lk, int heads, int hd, float scale, int causal, int prefix,
                 int nomax, void* stream) {
  SlabBwdMaps maps;
  const void* ops[kMaps] = {q, k, v, nullptr, dout};
  if (!make_slab_maps(&maps, ops, strides, hd, heads, lq, lk, batch, kQt))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = make_args(lse, const_cast<void*>(delta), nullptr, dk, dv, strides, lq, lk,
                              heads, hd, scale, causal, prefix, nomax, 1.f, 0);
  return run_slab(attention_bwd_dkv_slab_kernel, maps, a, lk, batch, BT, stream);
}

}  // namespace

int attention_bwd_dq_slab(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, void* delta, void* dq,
                          const long long* strides, int batch, int lq, int lk, int heads,
                          int head_dim, float scale, int causal, int prefix, int nomax,
                          float dq_scale, int dq_round, void* stream) {
  return bwd_dq_slab(q, k, v, o, dout, lse, delta, dq, strides, batch, lq, lk, heads, head_dim,
                     scale, causal, prefix, nomax, dq_scale, dq_round, stream);
}

int attention_bwd_dkv_slab(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv,
                           const long long* strides, int batch, int lq, int lk, int heads,
                           int head_dim, float scale, int causal, int prefix, int nomax,
                           void* stream) {
  return bwd_dkv_slab(q, k, v, dout, lse, delta, dk, dv, strides, batch, lq, lk, heads,
                      head_dim, scale, causal, prefix, nomax, stream);
}

// The forward attention kernel of attention.cu (see its notes) up to head_dim
// 128, templated on the padded head_dim, with one entry a layout (fwd_packed,
// fwd_flash), and what the forward kernels above 128 share with it (the
// arguments, the online softmax, the epilogue, the entries' maps).
// attention.cu instantiates the padded head_dims up to 64 and
// attention_wide.cu those from 80 to 128, so that they build in parallel;
// attention_xwide.cu holds the kernel from 136 to 256 and attention_slab.cu
// the one above.
#pragma once

#include <cmath>
#include <type_traits>

#include "attention.cuh"

namespace {

using namespace ovt::attn;
using ovt::bf16;

constexpr int kThreads = 128 + 32;        // one consumer warpgroup, then the producer warp

// The ring's K/V stages, CTAs an SM (registers) and dynamic shared memory
// (Q, then K, V a stage) of a padded head_dim up to 128.
template <int HDP>
struct Fwd {
  static constexpr int kStages = HDP <= 64 ? 4 : 2;
  static constexpr int kMinBlocks = HDP <= 64 ? 3 : 2;
  static constexpr int kTileBytes = Hd<HDP>::kTileBytes;
  static constexpr int kSmem = 1024 + kTileBytes + kStages * 2 * kTileBytes;
};

template <int HDP>
struct FwdMaps {
  OpMaps<HDP> q, k, v;
};

struct FwdArgs {
  void* o;     // bf16, or f32 for the int8 block
  float* lse;  // (B, H, Lq) f32, or null
  Strides so;
  int Lq, Lk, H, hd;
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

template <int HDP>
__device__ __forceinline__ void rescale(float (&o)[HDP / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// The warpgroup's 64 output rows from r0: o / l as bf16 (by the reciprocal)
// or as f32 (by a division, as Pallas's oT / l), rows below Lq and columns
// below hd only.
template <int HDP>
__device__ __forceinline__ void store_out(bf16* base, long long stride, int r0, int rows, int hd,
                                          const float (&o)[HDP / 2], const float (&l)[2],
                                          int warp, int lane) {
  store_tile<HDP>(base, stride, r0, rows, hd, o, warp, lane, 1.f / l[0], 1.f / l[1]);
}
template <int HDP>
__device__ __forceinline__ void store_out(float* base, long long stride, int r0, int rows, int hd,
                                          const float (&o)[HDP / 2], const float (&l)[2],
                                          int warp, int lane) {
  const int ra = r0 + warp * 16 + (lane >> 2), rb = ra + 8, col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    if (8 * j >= hd) continue;
    if (ra < rows)
      *reinterpret_cast<float2*>(base + (ra * stride + 8 * j + col)) =
          make_float2(o[4 * j] / l[0], o[4 * j + 1] / l[0]);
    if (rb < rows)
      *reinterpret_cast<float2*>(base + (rb * stride + 8 * j + col)) =
          make_float2(o[4 * j + 2] / l[1], o[4 * j + 3] / l[1]);
  }
}

// A warpgroup's 64 rows from r0 at the end: each row's sum over its quad of
// lanes, o / l stored into the head's columns col0.. below hd (base: the
// head's first column), and, with `lse`, each row's m + log(l) (log(l)
// under nomax: m stays -inf there).
template <int HO, typename OutT>
__device__ __forceinline__ void finish_rows(OutT* base, const FwdArgs& a, int b, int h, int r0,
                                            int row0, const float (&o)[HO / 2],
                                            const float (&m)[2], float (&l)[2], int warp,
                                            int lane, int col0 = 0, bool lse = true) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] <= 0.f) l[r] = 1.f;  // no visible key: o = 0
  }
  store_out<HO>(base + col0, a.so.l, r0, a.Lq, a.hd - col0, o, l, warp, lane);
  if (lse && a.lse != nullptr && (lane & 3) == 0) {  // rows of 257 floats: no 16-byte alignment
    float* lrow = a.lse + (static_cast<long long>(b) * a.H + h) * a.Lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.Lq) lrow[row] = (m[r] == -INFINITY ? 0.f : m[r] * a.sc) + logf(l[r]);
    }
  }
}

// HDP: the padded head_dim (up to 128). kCausal: the causal / prefix-LM
// mask (a compile-time switch, so the unmasked encoder path carries none of
// its index arithmetic). OutT: the output's type, bf16 or f32.
template <int HDP, bool kCausal, typename OutT>
__global__ void __launch_bounds__(kThreads, Fwd<HDP>::kMinBlocks)
    attention_fwd_kernel(const __grid_constant__ FwdMaps<HDP> maps, const FwdArgs a) {
  static_assert(HDP <= 128, "above 128: attention_xwide.cu's kernel");
  using P = Fwd<HDP>;
  constexpr int kStages = P::kStages, kTileBytes = P::kTileBytes, HO = HDP;
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
    prefetch_maps(maps.q);
    prefetch_maps(maps.k);
    prefetch_maps(maps.v);
  }
  __syncthreads();
  if (tid >= 128) {  // the producer warp: one thread runs the ring ahead
    if (tid == 128) {
      hp::mbar_expect_tx(&q_bar, kTileBytes);
      load_tile(base, maps.q, &q_bar, h, r0, b);
      for (int t = 0; t <= last; ++t) {  // each stage as soon as the consumers release it
        const int st = t % kStages;
        if (t >= kStages) hp::mbar_wait(&empty[st], (t / kStages - 1) & 1);
        hp::mbar_expect_tx(&full[st], 2 * kTileBytes);
        load_tile(k_at(st), maps.k, &full[st], a.hk + h, t * BT, b);
        load_tile(k_at(st) + kTileBytes, maps.v, &full[st], a.hv + h, t * BT, b);
      }
    }
    return;
  }
  auto release = [&](int t) {  // the consumers are done with tile t's stage
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[t % kStages]);
  };

  hp::mbar_wait(&q_bar, 0);
  if (a.prescale) {  // the single-k order: q * scale rounded to bf16, in place (pad columns stay 0)
    uint4* t = reinterpret_cast<uint4*>(smem);
#pragma unroll
    for (int i = 0; i < kTileBytes / 16 / 128; ++i) {
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

  float o[HO / 2];
#pragma unroll
  for (int i = 0; i < HO / 2; ++i) o[i] = 0.f;
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
    start_ss<HDP, N>(s, base, k_at(0));
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
      start_ss<HDP, N>(s, base, k_at(st));
      start_rs<HO, BT / 16>(o, p, k_at((kt - 1) % kStages) + kTileBytes);
      hp::wgmma_wait<1>();
      hp::fence_acc(s);
      float alpha[2];
      softmax_tile<N, kCausal>(s, m, l, alpha, a, k0, row0, col_lane + k0, wrow);
      hp::wgmma_wait<0>();
      hp::fence_acc(o);
      fence_frag(p);
      release(kt - 1);
      if (!a.nomax) rescale<HO>(o, alpha);
      pack_a<N>(p, s);
    });
  }
  by_width(a.Lk - last * BT, [&](auto n) {  // the last tile's P V
    constexpr int N = decltype(n)::value;
    start_rs<HO, (N + 15) / 16>(o, p, k_at(last % kStages) + kTileBytes);
    hp::wgmma_wait<0>();
    hp::fence_acc(o);
    fence_frag(p);
  });
  release(last);

  finish_rows<HO>(static_cast<OutT*>(a.o) + b * a.so.b + h * a.so.h, a, b, h, r0, row0, o, m, l,
                  warp, lane);
}

template <int HDP, bool kCausal, typename OutT>
int run(const FwdMaps<HDP>& maps, const FwdArgs& a, int batch, cudaStream_t stream) {
  constexpr int kSmem = Fwd<HDP>::kSmem;
  static const cudaError_t attr =
      cudaFuncSetAttribute(attention_fwd_kernel<HDP, kCausal, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Lq + BT - 1) / BT, a.H, batch);
  attention_fwd_kernel<HDP, kCausal, OutT><<<grid, kThreads, kSmem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch(const FwdMaps<HDP>& maps, const FwdArgs& a, int batch, int out_f32, void* stream) {
  if (a.Lq == 0 || a.H == 0 || batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)  // the int8 block: unmasked
    return run<HDP, false, float>(maps, a, batch, st);
  return a.causal ? run<HDP, true, bf16>(maps, a, batch, st)
                  : run<HDP, false, bf16>(maps, a, batch, st);
}

FwdArgs make_args(void* out, void* lse, const Strides& so, int lq, int lk, int heads, int hd,
                  float scale, int prescale, int nomax, int causal, int prefix) {
  // a power-of-two scale (head_dim 64's 2**-3) commutes with every rounding:
  // bf16(q * scale) . k = scale * (q . k) bit for bit, so the single-k order
  // needs no pass over Q and the scale goes into the exponent
  int e;
  if (std::frexp(scale, &e) == 0.5f) prescale = 0;
  const float sc = prescale ? 1.f : scale;
  return FwdArgs{out, static_cast<float*>(lse), so, lq, lk, heads, hd, 0, 0, prescale, scale,
                 sc, sc * kLog2e, 80.f * kLog2e, nomax, causal, prefix};
}

// The packed (B, L, 3D) QKV entry's maps and arguments: one map set over
// the buffer's 3 * heads heads, q, k and v by head offset (k's and v's box
// rows `kv_rows` where they differ from q's 64). False if TMA refuses a view.
template <int W>
bool packed_setup(OpMaps<W>* q, OpMaps<W>* kv, FwdArgs* a, const void* qkv, void* out, int batch,
                  int seq, int heads, int hd, float scale, int nomax, int causal, int prefix,
                  int kv_rows = BT) {
  const int d = heads * hd;
  const Strides st{static_cast<long long>(seq) * 3 * d, 3 * d, hd};
  if (!head_maps(q, qkv, st, hd, 3 * heads, seq, batch)) return false;
  if (kv_rows == BT)
    *kv = *q;
  else if (!head_maps(kv, qkv, st, hd, 3 * heads, seq, batch, kv_rows))
    return false;
  *a = make_args(out, nullptr, Strides{static_cast<long long>(seq) * d, d, hd}, seq, seq, heads,
                 hd, scale, 1, nomax, causal, prefix);
  a->hk = heads;
  a->hv = 2 * heads;
  return true;
}

// The flash entry's maps (q, k, v by strides; k's and v's box rows
// `kv_rows`) and arguments.
template <int W>
bool flash_setup(OpMaps<W>* q, OpMaps<W>* k, OpMaps<W>* v, FwdArgs* a, const void* qp,
                 const void* kp, const void* vp, void* out, void* lse, const long long* strides,
                 int batch, int lq, int lk, int heads, int hd, float scale, int prescale,
                 int causal, int prefix, int nomax, int kv_rows = BT) {
  if (!head_maps(q, qp, strides_of(strides, 0), hd, heads, lq, batch) ||
      !head_maps(k, kp, strides_of(strides, 1), hd, heads, lk, batch, kv_rows) ||
      !head_maps(v, vp, strides_of(strides, 2), hd, heads, lk, batch, kv_rows))
    return false;
  *a = make_args(out, lse, strides_of(strides, 3), lq, lk, heads, hd, scale, prescale, nomax,
                 causal, prefix);
  return true;
}

// The packed (B, L, 3D) QKV entry at one padded head_dim.
template <int HDP>
int fwd_packed(const void* qkv, void* out, int batch, int seq, int heads, int hd, float scale,
               int nomax, int causal, int prefix, int out_f32, void* stream) {
  FwdMaps<HDP> maps;
  FwdArgs a;
  if (!packed_setup(&maps.q, &maps.k, &a, qkv, out, batch, seq, heads, hd, scale, nomax, causal,
                    prefix))
    return static_cast<int>(cudaErrorInvalidValue);
  maps.v = maps.k;
  return launch<HDP>(maps, a, batch, out_f32, stream);
}

// The flash entry (q, k, v by strides) at one padded head_dim.
template <int HDP>
int fwd_flash(const void* q, const void* k, const void* v, void* out, void* lse,
              const long long* strides, int batch, int lq, int lk, int heads, int hd, float scale,
              int prescale, int causal, int prefix, int nomax, void* stream) {
  FwdMaps<HDP> maps;
  FwdArgs a;
  if (!flash_setup(&maps.q, &maps.k, &maps.v, &a, q, k, v, out, lse, strides, batch, lq, lk,
                   heads, hd, scale, prescale, causal, prefix, nomax))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<HDP>(maps, a, batch, 0, stream);
}

}  // namespace

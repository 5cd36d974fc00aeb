// softmax(q . k^T) . v per (batch, head), with q, k and v read by base
// pointer and strides, so one kernel serves both layouts of the port:
// - the (B, L, 3D) QKV buffer of the fused encoder blocks (ovt_attention),
//   output (B, L, D) for the out-projection;
// - separate (B, L, H, head_dim) q, k and v of the flash path
//   (ovt_flash_attention), with Lq != Lk and an optional f32 LSE output.
//
// Replaces the attention core of three Pallas kernels:
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
// - _block_kernel (openvision_tpu/ops/fused_attention.py:440): the same core
//   and the unmasked, causal and prefix-LM masks (_tvalid, :64); Pallas folds
//   the scale into the q projection, and at head_dim 64 (scale 2**-3) scaling
//   q here gives the same bits;
// - _fwd_kernel and _fwd_kernel_single_k(_nolse)
//   (openvision_tpu/ops/flash_attention.py:133, :76, :85): `prescale` picks
//   the single-k order (q * scale rounded to bf16 before q.k^T) or the
//   multi-k order (f32 scores times scale); the LSE m + log(l) is written
//   when asked for.
// Key j is visible to query i iff j < Lk and, when causal, j <= max(i,
// prefix - 1). Whole key tiles that no query of the block can see are
// skipped, as _live (flash_attention.py:61) skips dead blocks: the live tiles
// are the contiguous range [0, last].
//
// Bound on the H100: at the port's shapes (head_dim 64, L of 128..577) the
// FLOPs are 4*Lq*Lk*64 per (batch, head) against 2*(2*Lq + 2*Lk)*64 bytes,
// about Lq*Lk/(Lq+Lk) FLOP/byte: 64..145, below the card's ~295 FLOP/byte
// ridge, so the floor is the bytes of q, k, v and o. What this kernel is
// actually bound by is mma.sync issue and the online-softmax arithmetic.
// One block of 4 warps owns a 64-query tile of one (batch, head); each warp
// owns 16 query rows and keeps its scores and output in registers (the
// FlashAttention-2 layout: the score accumulator fragment is reused as the A
// operand of p.v), looping over 64-key tiles with an online softmax, so no
// (Lq, Lk) matrix ever reaches device memory. K and V tiles are single-
// buffered; overlapping their loads with compute is later work.
#include "common.cuh"

namespace {

using ovt::bf16;

constexpr int HD = 64;  // head_dim the kernel takes
constexpr int BQ = 64, BKV = 64;
constexpr int LDA = HD + 8;  // padded row: 144 bytes, conflict-free ldmatrix
constexpr int kThreads = 128;

struct Strides {  // in elements: batch, row (sequence position), head; the
  long long b;     // offsets inside one batch item fit in 32 bits (the
  int l, h;        // wrappers check), which keeps the inner loop's address
};                 // arithmetic 32-bit

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  void* o;     // OutT: bf16, or f32 for the int8 block
  float* lse;  // (B, H, Lq) f32, or null
  Strides sq, sk, sv, so;
  int Lq, Lk, H;
  float scale;
  int prescale;  // 1: round q * scale to bf16 first; 0: scale the f32 scores
  int nomax, causal, prefix;
};

// Two output columns (c, c + 1) of one row: o / l rounded to bf16 (by the
// reciprocal), or o / l in f32 (by a division, as Pallas's oT / l).
__device__ __forceinline__ void store_out(bf16* p, float x, float y, float l) {
  const float inv = 1.f / l;
  *reinterpret_cast<uint32_t*>(p) = ovt::pack_bf16x2(x * inv, y * inv);
}
__device__ __forceinline__ void store_out(float* p, float x, float y, float l) {
  *reinterpret_cast<float2*>(p) = make_float2(x / l, y / l);
}

// kCausal: the causal / prefix-LM mask (a compile-time switch, so the
// unmasked encoder path carries none of its index arithmetic). OutT: the
// output's type, bf16 or f32.
template <bool kCausal, typename OutT>
__global__ void __launch_bounds__(kThreads) attention_kernel(const AttnArgs a) {
  __shared__ __align__(16) bf16 Qs[BQ][LDA];
  __shared__ __align__(16) bf16 Ks[BKV][LDA];
  __shared__ __align__(16) bf16 Vs[BKV][LDA];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qbase = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* kbase = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vbase = a.v + b * a.sv.b + h * a.sv.h;

#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 64 rows x 8 chunks of 8
    const int c = tid + i * kThreads;
    const int r = c >> 3, cc = (c & 7) * 8;
    const bool p = (q0 + r) < a.Lq;
    ovt::cp_async16(&Qs[r][cc], p ? qbase + ((q0 + r) * a.sq.l + cc) : a.q, p);
  }
  ovt::cp_async_commit();
  ovt::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[4][4];  // this warp's 16 query rows, 4 k16 steps over head_dim
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    ovt::ldmatrix_x4(qf[ks], &Qs[warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
    if (a.prescale) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = ovt::unpack_bf16x2(qf[ks][j]);
        qf[ks][j] = ovt::pack_bf16x2(f.x * a.scale, f.y * a.scale);
      }
    }
  }
  const float s_scale = a.prescale ? 1.f : a.scale;

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};              // this lane's partial row sums
  const int row0 = q0 + warp * 16 + g;       // row of e = 0, 1; e = 2, 3 add 8
  // a key is visible to row i iff j <= max(i, prefix - 1) (causal only)
  const int vis0 = kCausal ? max(row0, a.prefix - 1) : a.Lk - 1;
  const int vis1 = kCausal ? max(row0 + 8, a.prefix - 1) : a.Lk - 1;
  // the last key every row of this warp sees: tiles up to it need no mask
  const int vis_warp = kCausal ? max(q0 + warp * 16, a.prefix - 1) : a.Lk - 1;

  const int nkv = (a.Lk + BKV - 1) / BKV;
  int last = nkv - 1;
  if (kCausal) {  // the live key tiles of this query tile are [0, last]
    int live = (q0 + BQ - 1) / BKV;
    if (a.prefix > 0) live = max(live, (a.prefix - 1) / BKV);
    last = min(last, live);
  }
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // every warp is done with the previous K/V tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, cc = (c & 7) * 8;
      const bool p = (k0 + r) < a.Lk;
      ovt::cp_async16(&Ks[r][cc], p ? kbase + ((k0 + r) * a.sk.l + cc) : a.k, p);
      ovt::cp_async16(&Vs[r][cc], p ? vbase + ((k0 + r) * a.sv.l + cc) : a.v, p);
    }
    ovt::cp_async_commit();
    ovt::cp_async_wait<0>();
    __syncthreads();

    float s[8][4];  // 16 rows x 64 keys
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t t[4];
        ovt::ldmatrix_x4(t, &Ks[np * 16 + (lane >> 4) * 8 + (lane & 7)]
                               [ks * 16 + ((lane >> 3) & 1) * 8]);
        ovt::mma_bf16_16816(s[2 * np], qf[ks], t[0], t[1]);
        ovt::mma_bf16_16816(s[2 * np + 1], qf[ks], t[2], t[3]);
      }
    }

    // scale (multi-k order) and mask: a masked score is -inf, and its
    // probability exp(-inf - m) is exactly 0 once m is finite. A tile that
    // every row of the warp sees whole skips the mask (warp-uniform branch).
    if (k0 + BKV <= a.Lk && k0 + BKV - 1 <= vis_warp) {
      if (!a.prescale) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] *= s_scale;
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
          const bool ok = kCausal ? col <= ((e & 2) ? vis1 : vis0) && col < a.Lk : col < a.Lk;
          s[nt][e] = ok ? s[nt][e] * s_scale : -INFINITY;
        }
    }

    if (a.nomax) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(fminf(s[nt][e], 80.f));
          l_run[e >> 1] += s[nt][e];
        }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_run[r];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row with no visible key so far keeps m = -inf; subtract 0 then
        const float ms = mx == -INFINITY ? 0.f : mx;
        const float alpha = expf(m_run[r] - ms);
        m_run[r] = mx;
        float ls = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          s[nt][2 * r] = expf(s[nt][2 * r] - ms);
          s[nt][2 * r + 1] = expf(s[nt][2 * r + 1] - ms);
          ls += s[nt][2 * r] + s[nt][2 * r + 1];
        }
        l_run[r] = l_run[r] * alpha + ls;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          o[nt][2 * r] *= alpha;
          o[nt][2 * r + 1] *= alpha;
        }
      }
    }

#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 16 keys per step
      uint32_t pa[4];
      pa[0] = ovt::pack_bf16x2(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = ovt::pack_bf16x2(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = ovt::pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = ovt::pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t t[4];
        ovt::ldmatrix_x4_trans(t, &Vs[ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                     [np * 16 + (lane >> 4) * 8]);
        ovt::mma_bf16_16816(o[2 * np], pa, t[0], t[1]);
        ovt::mma_bf16_16816(o[2 * np + 1], pa, t[2], t[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (l_run[r] <= 0.f) l_run[r] = 1.f;  // no visible key: o = 0
  }
  const int qa = row0, qb = row0 + 8;
  OutT* obase = static_cast<OutT*>(a.o) + b * a.so.b + h * a.so.h + t4 * 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (qa < a.Lq) store_out(obase + (qa * a.so.l + nt * 8), o[nt][0], o[nt][1], l_run[0]);
    if (qb < a.Lq) store_out(obase + (qb * a.so.l + nt * 8), o[nt][2], o[nt][3], l_run[1]);
  }
  if (a.lse != nullptr && t4 == 0) {
    float* lrow = a.lse + (static_cast<long long>(b) * a.H + h) * a.Lq;
    const float m0 = m_run[0] == -INFINITY ? 0.f : m_run[0];
    const float m1 = m_run[1] == -INFINITY ? 0.f : m_run[1];
    if (qa < a.Lq) lrow[qa] = m0 + logf(l_run[0]);
    if (qb < a.Lq) lrow[qb] = m1 + logf(l_run[1]);
  }
}

int launch(const AttnArgs& a, int batch, int out_f32, void* stream) {
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)  // the int8 block: unmasked
    attention_kernel<false, float><<<grid, kThreads, 0, st>>>(a);
  else if (a.causal)
    attention_kernel<true, bf16><<<grid, kThreads, 0, st>>>(a);
  else
    attention_kernel<false, bf16><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
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
  const long long d = static_cast<long long>(heads) * HD;
  const bf16* base = static_cast<const bf16*>(qkv);
  const Strides in{seq * 3 * d, static_cast<int>(3 * d), HD};
  AttnArgs a{base, base + d, base + 2 * d, out, nullptr,
             in, in, in, Strides{seq * d, static_cast<int>(d), HD},
             seq, seq, heads, scale, 1, nomax, causal, prefix};
  return launch(a, batch, out_f32, stream);
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
  const long long* s = strides;
  AttnArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), out,
             static_cast<float*>(lse),
             Strides{s[0], static_cast<int>(s[1]), static_cast<int>(s[2])},
             Strides{s[3], static_cast<int>(s[4]), static_cast<int>(s[5])},
             Strides{s[6], static_cast<int>(s[7]), static_cast<int>(s[8])},
             Strides{s[9], static_cast<int>(s[10]), static_cast<int>(s[11])},
             lq, lk, heads, scale, prescale, nomax, causal, prefix};
  return launch(a, batch, 0, stream);
}

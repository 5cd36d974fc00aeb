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
// at head_dim 64, where the scale is 2**-3.
//
// Bound on the H100: like the forward, at the port's shapes (L of 128..463,
// head_dim 64) the bytes of q, k, v, o, do, dq, dk and dv over the card's
// memory rate against 8*Lq*Lk*64 FLOPs per (batch, head) put these kernels
// near the ridge; what bounds this version is mma.sync throughput and the
// exp/mask arithmetic, with no overlap of loads and compute.
//
// Two kernels, each a FlashAttention-2 loop that keeps every (Lq, Lk) tile in
// registers:
// - attention_bwd_dq: one block of 4 warps per (64-query tile, head, batch);
//   it first writes delta for its rows, then walks the live key tiles
//   (tiles no query of the block sees are skipped, as _live does) and
//   accumulates dq in registers;
// - attention_bwd_dkv: one block per (64-key tile, head, batch); each warp
//   owns 16 keys, keeps its k and v fragments in registers, walks the query
//   tiles that can see its keys and accumulates dk and dv. It reads the delta
//   the dq kernel wrote, so it runs after it on the same stream.
#include "common.cuh"

namespace {

using ovt::bf16;

constexpr int HD = 64;
constexpr int BQ = 64, BKV = 64;
constexpr int LDA = HD + 8;  // padded row: 144 bytes, conflict-free ldmatrix
constexpr int kThreads = 128;

struct Strides {  // in elements: batch, row (sequence position), head
  long long b;
  int l, h;
};

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (B, H, Lq) f32
  float* delta;      // (B, H, Lq) f32, written by the dq kernel
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int Lq, Lk, H;
  float scale;
  int causal, prefix;
  int nomax;  // P = exp(min(s, 80) - lse): the fused_t forward's nomax softmax
};

// The scaled score whose exp, less the forward's lse, is P: clamped at 80
// under nomax, as the forward's exp(min(s, 80)).
__device__ __forceinline__ float score(float qk, const BwdArgs& a) {
  const float s = qk * a.scale;
  return a.nomax ? fminf(s, 80.f) : s;
}

__device__ __forceinline__ bool visible(int key, int query, const BwdArgs& a) {
  return key < a.Lk && query < a.Lq && (!a.causal || key <= max(query, a.prefix - 1));
}

// Loads a 64 x 64 bf16 tile (rows r0.., columns 0..63) by row stride into
// shared memory; rows at or past `rows` are zero-filled.
__device__ __forceinline__ void load_tile(bf16 (*dst)[LDA], const bf16* base, int stride,
                                          int r0, int rows, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 64 rows x 8 chunks of 8
    const int c = tid + i * kThreads;
    const int r = c >> 3, cc = (c & 7) * 8;
    const bool p = (r0 + r) < rows;
    ovt::cp_async16(&dst[r][cc], p ? base + (static_cast<long long>(r0 + r) * stride + cc) : base,
                    p);
  }
}

// acc[8][4] (16 rows x 64 columns) += A (16 x 64, four k16 fragments) . B^T
// with B's 64 rows in shared memory (row-major, the reduction along a row).
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&af)[4][4],
                                        bf16 (*bs)[LDA], int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t t[4];
      ovt::ldmatrix_x4(t, &bs[np * 16 + (lane >> 4) * 8 + (lane & 7)]
                              [ks * 16 + ((lane >> 3) & 1) * 8]);
      ovt::mma_bf16_16816(acc[2 * np], af[ks], t[0], t[1]);
      ovt::mma_bf16_16816(acc[2 * np + 1], af[ks], t[2], t[3]);
    }
  }
}

// acc[8][4] (16 rows x 64 columns) += P (16 x 64 accumulator layout, rounded
// to bf16) . B with B's 64 rows in shared memory (the reduction down the rows).
__device__ __forceinline__ void mma_pb(float (&acc)[8][4], const float (&p)[8][4],
                                       bf16 (*bs)[LDA], int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t pa[4];
    pa[0] = ovt::pack_bf16x2(p[2 * ks][0], p[2 * ks][1]);
    pa[1] = ovt::pack_bf16x2(p[2 * ks][2], p[2 * ks][3]);
    pa[2] = ovt::pack_bf16x2(p[2 * ks + 1][0], p[2 * ks + 1][1]);
    pa[3] = ovt::pack_bf16x2(p[2 * ks + 1][2], p[2 * ks + 1][3]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t t[4];
      ovt::ldmatrix_x4_trans(t, &bs[ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                   [np * 16 + (lane >> 4) * 8]);
      ovt::mma_bf16_16816(acc[2 * np], pa, t[0], t[1]);
      ovt::mma_bf16_16816(acc[2 * np + 1], pa, t[2], t[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// Writes a warp's 16 x 64 f32 accumulator as bf16 rows r0 + g and r0 + g + 8.
__device__ __forceinline__ void store_rows(bf16* base, int stride, int r0, int rows,
                                           const float (&acc)[8][4], int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + t4 * 2;
    if (ra < rows)
      *reinterpret_cast<uint32_t*>(base + (static_cast<long long>(ra) * stride + col)) =
          ovt::pack_bf16x2(acc[nt][0], acc[nt][1]);
    if (rb < rows)
      *reinterpret_cast<uint32_t*>(base + (static_cast<long long>(rb) * stride + col)) =
          ovt::pack_bf16x2(acc[nt][2], acc[nt][3]);
  }
}

__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(const BwdArgs a) {
  __shared__ __align__(16) bf16 Qs[BQ][LDA];
  __shared__ __align__(16) bf16 Ds[BQ][LDA];  // do
  __shared__ __align__(16) bf16 Ks[BKV][LDA];  // o while delta is formed, then k
  __shared__ __align__(16) bf16 Vs[BKV][LDA];
  __shared__ float delta_s[BQ];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* kbase = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vbase = a.v + b * a.sv.b + h * a.sv.h;

  load_tile(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.l, q0, a.Lq, tid);
  load_tile(Ds, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.l, q0, a.Lq, tid);
  load_tile(Ks, a.o + b * a.so.b + h * a.so.h, a.so.l, q0, a.Lq, tid);
  ovt::cp_async_commit();
  ovt::cp_async_wait<0>();
  __syncthreads();

  // delta for the tile's 64 rows: two threads per row, 32 columns each
  {
    const int r = tid >> 1, c0 = (tid & 1) * 32;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      const float2 d2 = ovt::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(&Ds[r][c0 + c]));
      const float2 o2 = ovt::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(&Ks[r][c0 + c]));
      acc += d2.x * o2.x + d2.y * o2.y;
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      if (q0 + r < a.Lq) a.delta[(static_cast<long long>(b) * a.H + h) * a.Lq + q0 + r] = acc;
    }
  }

  uint32_t qf[4][4], df[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    ovt::ldmatrix_x4(qf[ks], &Qs[warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
    ovt::ldmatrix_x4(df[ks], &Ds[warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
  }
  __syncthreads();  // delta_s is complete; Ks is free for k

  const int row0 = q0 + warp * 16 + g;  // rows of e = 0, 1; e = 2, 3 add 8
  const float* lrow = a.lse + (static_cast<long long>(b) * a.H + h) * a.Lq;
  const float lse0 = row0 < a.Lq ? lrow[row0] : 0.f;
  const float lse1 = row0 + 8 < a.Lq ? lrow[row0 + 8] : 0.f;
  const float del0 = delta_s[warp * 16 + g], del1 = delta_s[warp * 16 + g + 8];
  const int vis_warp = a.causal ? max(q0 + warp * 16, a.prefix - 1) : a.Lk - 1;

  float dq[8][4];
  zero(dq);
  const int nkv = (a.Lk + BKV - 1) / BKV;
  int last = nkv - 1;
  if (a.causal) {  // the live key tiles of this query tile are [0, last]
    int live = (q0 + BQ - 1) / BKV;
    if (a.prefix > 0) live = max(live, (a.prefix - 1) / BKV);
    last = min(last, live);
  }
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(Ks, kbase, a.sk.l, k0, a.Lk, tid);
    load_tile(Vs, vbase, a.sv.l, k0, a.Lk, tid);
    ovt::cp_async_commit();
    ovt::cp_async_wait<0>();
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt(s, qf, Ks, lane);
    mma_abt(dp, df, Vs, lane);
    const bool whole = k0 + BKV <= a.Lk && k0 + BKV - 1 <= vis_warp && q0 + warp * 16 + 15 < a.Lq;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int row = row0 + ((e & 2) ? 8 : 0);
        const float p = (whole || visible(col, row, a))
                            ? expf(score(s[nt][e], a) - ((e & 2) ? lse1 : lse0))
                            : 0.f;
        s[nt][e] = p * (dp[nt][e] - ((e & 2) ? del1 : del0)) * a.scale;
      }
    mma_pb(dq, s, Ks, lane);
  }
  store_rows(a.dq + b * a.sdq.b + h * a.sdq.h, a.sdq.l, q0 + warp * 16, a.Lq, dq, lane);
}

__global__ void __launch_bounds__(kThreads) attention_bwd_dkv_kernel(const BwdArgs a) {
  __shared__ __align__(16) bf16 Qs[BQ][LDA];
  __shared__ __align__(16) bf16 Ds[BQ][LDA];  // do
  __shared__ __align__(16) bf16 Ks[BKV][LDA];
  __shared__ __align__(16) bf16 Vs[BKV][LDA];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int k0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qbase = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* dbase = a.dout + b * a.sdo.b + h * a.sdo.h;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Lq;

  load_tile(Ks, a.k + b * a.sk.b + h * a.sk.h, a.sk.l, k0, a.Lk, tid);
  load_tile(Vs, a.v + b * a.sv.b + h * a.sv.h, a.sv.l, k0, a.Lk, tid);
  ovt::cp_async_commit();
  ovt::cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    ovt::ldmatrix_x4(kf[ks], &Ks[warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
    ovt::ldmatrix_x4(vf[ks], &Vs[warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
  }

  const int key0 = k0 + warp * 16 + g;  // keys of e = 0, 1; e = 2, 3 add 8
  const int key_last = k0 + warp * 16 + 15;
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const int nq = (a.Lq + BQ - 1) / BQ;
  // query tiles that can see this key tile: all of them, or with the causal
  // mask those from the diagonal on unless the tile lies in the prefix
  const int first = (a.causal && k0 >= a.prefix) ? k0 / BQ : 0;
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile(Qs, qbase, a.sq.l, q0, a.Lq, tid);
    load_tile(Ds, dbase, a.sdo.l, q0, a.Lq, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < a.Lq;
      lse_s[tid] = in ? a.lse[row_base + q0 + tid] : 0.f;
      delta_s[tid] = in ? a.delta[row_base + q0 + tid] : 0.f;
    }
    ovt::cp_async_commit();
    ovt::cp_async_wait<0>();
    __syncthreads();

    float st[8][4], dpt[8][4];  // s^T and dP^T: 16 keys x 64 queries
    zero(st);
    zero(dpt);
    mma_abt(st, kf, Qs, lane);
    mma_abt(dpt, vf, Ds, lane);
    // every (key, query) pair of the warp's tile is visible
    const bool whole = key_last < a.Lk && q0 + BQ <= a.Lq &&
                       (!a.causal || key_last <= max(q0, a.prefix - 1));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + t4 * 2 + (e & 1);
        const int key = key0 + ((e & 2) ? 8 : 0);
        const float p =
            (whole || visible(key, q0 + c, a)) ? expf(score(st[nt][e], a) - lse_s[c]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[c]) * a.scale;
      }
    mma_pb(dv, st, Ds, lane);
    mma_pb(dk, dpt, Qs, lane);
  }
  store_rows(a.dk + b * a.sdk.b + h * a.sdk.h, a.sdk.l, k0 + warp * 16, a.Lk, dk, lane);
  store_rows(a.dv + b * a.sdv.b + h * a.sdv.h, a.sdv.l, k0 + warp * 16, a.Lk, dv, lane);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, void* delta, void* dq, void* dk, void* dv,
                  const long long* s, int lq, int lk, int heads, float scale, int causal,
                  int prefix, int nomax) {
  auto st = [s](int i) {
    return Strides{s[3 * i], static_cast<int>(s[3 * i + 1]), static_cast<int>(s[3 * i + 2])};
  };
  return BwdArgs{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                 static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                 static_cast<float*>(delta), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                 static_cast<bf16*>(dv), st(0), st(1), st(2), st(3), st(4), st(5), st(6), st(7),
                 lq, lk, heads, scale, causal, prefix, nomax};
}

}  // namespace

// q, o, do, dq: (batch, lq, heads, 64); k, v, dk, dv: (batch, lk, heads, 64);
// all bf16 with unit stride in head_dim and 16-byte aligned rows; `strides`
// holds the (batch, row, head) strides of q, k, v, o, do, dq, dk and dv in
// elements, 24 in all; offsets inside one batch item stay below 2**31.
// lse and delta: (batch, heads, lq) f32 contiguous. The dq entry writes delta
// and dq; the dk/dv entry reads delta, so it runs after the dq entry on the
// same stream. nomax = 1 recomputes P as exp(min(s, 80) - lse), lse = log(l)
// from the nomax forward. Each returns cudaGetLastError() after its launch.
extern "C" int ovt_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, void* delta, void* dq,
                                    const long long* strides, int batch, int lq, int lk,
                                    int heads, int head_dim, float scale, int causal,
                                    int prefix, int nomax, void* stream) {
  if (head_dim != HD) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = make_args(q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, strides, lq,
                              lk, heads, scale, causal, prefix, nomax);
  const dim3 grid((lq + BQ - 1) / BQ, heads, batch);
  attention_bwd_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ovt_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, const long long* strides, int batch,
                                     int lq, int lk, int heads, int head_dim, float scale,
                                     int causal, int prefix, int nomax, void* stream) {
  if (head_dim != HD) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = make_args(q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk,
                              dv, strides, lq, lk, heads, scale, causal, prefix, nomax);
  const dim3 grid((lk + BKV - 1) / BKV, heads, batch);
  attention_bwd_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

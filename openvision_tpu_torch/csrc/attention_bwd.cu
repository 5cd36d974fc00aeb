// FlashAttention-2 backward over q, k and v read by base pointer and
// strides, at every head_dim that is a multiple of 8 from 16 up
// (attention.cuh's chunked tiles, one instantiation a padded head_dim; above
// 128 two launches of each kernel, one a column part of dq, dk and dv, each
// recomputing S and dP over the whole head_dim), so
// one kernel family serves both layouts of the port:
// - the flash path's separate (B, L, H, hd) q, k, v, o and do, with Lq != Lk;
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
// keeps it in f32 there, the fused block rounds it). The fused blocks'
// formulation (q scaled before q.k^T, dq scaled after) is scale = 1 on a q
// the QKV projection scaled, and dq's own factor `dq_scale` applied to the
// f32 sum (_mhsa_t_bwd_kernel) or to its bf16 rounding (`dq_round`:
// _block_bwd_kernel, _qkv_bwd_kernel) before dq is rounded. P is taken as
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
//   Four CTAs an SM at head_dim 64 (122 registers, 49 KB), two above.
// - attention_bwd_dkv: the CTA's rows are keys. K and V arrive once; Q/dO
//   tiles stream through the ring with their lse and delta rows (staged in
//   shared memory a tile ahead by plain loads: a row of 257 floats has no
//   16-byte alignment for TMA). Per tile S^T = K Q^T and dP^T = V dO^T from
//   shared memory, P^T from S^T while dP^T runs, dv += P^T dO started from
//   registers before dS^T is formed, then dk += dS^T Q. It reads the delta
//   the dq kernel wrote, so it runs after it on the stream. Three CTAs an
//   SM at head_dim 64 (168 registers: two 64 x 64 f32 sums and two score
//   blocks), two above; past a padded head_dim of 96 the two sums alone take
//   HDP registers, so each streamed tile runs as two 32-query halves (score
//   blocks of 32 columns) to stay clear of spills.
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
#include "attention_bwd.cuh"

// The padded head_dims 80..128, built in attention_bwd_wide.cu, 192 and 256,
// built in attention_bwd_xwide.cu, and the slab kernels above, in
// attention_bwd_slab.cu.
int attention_bwd_dq_slab(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, void* delta, void* dq,
                          const long long* strides, int batch, int lq, int lk, int heads,
                          int head_dim, float scale, int causal, int prefix, int nomax,
                          float dq_scale, int dq_round, void* stream);
int attention_bwd_dkv_slab(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv,
                           const long long* strides, int batch, int lq, int lk, int heads,
                           int head_dim, float scale, int causal, int prefix, int nomax,
                           void* stream);
int attention_bwd_dq_xwide(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* delta, void* dq,
                           const long long* strides, int batch, int lq, int lk, int heads,
                           int head_dim, float scale, int causal, int prefix, int nomax,
                           float dq_scale, int dq_round, void* stream);
int attention_bwd_dkv_xwide(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv,
                            const long long* strides, int batch, int lq, int lk, int heads,
                            int head_dim, float scale, int causal, int prefix, int nomax,
                            void* stream);
int attention_bwd_dq_wide(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, void* delta, void* dq,
                          const long long* strides, int batch, int lq, int lk, int heads,
                          int head_dim, float scale, int causal, int prefix, int nomax,
                          float dq_scale, int dq_round, void* stream);
int attention_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv,
                           const long long* strides, int batch, int lq, int lk, int heads,
                           int head_dim, float scale, int causal, int prefix, int nomax,
                           void* stream);


// q, o, do, dq: (batch, lq, heads, head_dim); k, v, dk, dv: (batch, lk,
// heads, head_dim); all bf16 with unit stride in head_dim (a multiple of 8
// from 16 up) and 16-byte aligned rows; `strides` holds the (batch, row,
// head) strides of q, k, v, o, do, dq, dk and dv in elements, 24 in all;
// offsets inside one batch item stay below 2**31.
// lse and delta: (batch, heads, lq) f32 contiguous. The dq entry writes delta
// and dq (its f32 sum times dq_scale, rounded to bf16 first when dq_round);
// the dk/dv entry reads delta, so it runs after the dq entry on the same
// stream. nomax = 1 recomputes P as exp(min(s, 80) - lse), lse = log(l)
// from the nomax forward. Each returns cudaGetLastError() after its launch,
// or cudaErrorInvalidValue if a tensor map cannot describe an operand or
// the head_dim is not one the kernels take.
extern "C" int ovt_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, void* delta, void* dq,
                                    const long long* strides, int batch, int lq, int lk,
                                    int heads, int head_dim, float scale, int causal,
                                    int prefix, int nomax, float dq_scale, int dq_round,
                                    void* stream) {
  if (!head_dim_ok(head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim > 256)
    return attention_bwd_dq_slab(q, k, v, o, dout, lse, delta, dq, strides, batch, lq, lk, heads,
                                 head_dim, scale, causal, prefix, nomax, dq_scale, dq_round,
                                 stream);
  if (head_dim > 128)
    return attention_bwd_dq_xwide(q, k, v, o, dout, lse, delta, dq, strides, batch, lq, lk,
                                  heads, head_dim, scale, causal, prefix, nomax, dq_scale,
                                  dq_round, stream);
  if (head_dim > 64)
    return attention_bwd_dq_wide(q, k, v, o, dout, lse, delta, dq, strides, batch, lq, lk, heads,
                                 head_dim, scale, causal, prefix, nomax, dq_scale, dq_round,
                                 stream);
  return by_head_dim<16, 32, 48, 64>(head_dim, [&](auto hdp) {
    return bwd_dq<decltype(hdp)::value>(q, k, v, o, dout, lse, delta, dq, strides, batch, lq, lk,
                                        heads, head_dim, scale, causal, prefix, nomax, dq_scale,
                                        dq_round, stream);
  });
}

extern "C" int ovt_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, const long long* strides, int batch,
                                     int lq, int lk, int heads, int head_dim, float scale,
                                     int causal, int prefix, int nomax, void* stream) {
  if (!head_dim_ok(head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim > 256)
    return attention_bwd_dkv_slab(q, k, v, dout, lse, delta, dk, dv, strides, batch, lq, lk,
                                  heads, head_dim, scale, causal, prefix, nomax, stream);
  if (head_dim > 128)
    return attention_bwd_dkv_xwide(q, k, v, dout, lse, delta, dk, dv, strides, batch, lq, lk,
                                   heads, head_dim, scale, causal, prefix, nomax, stream);
  if (head_dim > 64)
    return attention_bwd_dkv_wide(q, k, v, dout, lse, delta, dk, dv, strides, batch, lq, lk,
                                  heads, head_dim, scale, causal, prefix, nomax, stream);
  return by_head_dim<16, 32, 48, 64>(head_dim, [&](auto hdp) {
    return bwd_dkv<decltype(hdp)::value>(q, k, v, dout, lse, delta, dk, dv, strides, batch, lq,
                                         lk, heads, head_dim, scale, causal, prefix, nomax,
                                         stream);
  });
}

// softmax(q . k^T) . v per (batch, head), with q, k and v read by base
// pointer and strides, so one kernel serves both layouts of the port:
// - the (B, L, 3D) QKV buffer of the fused encoder blocks (ovt_attention),
//   output (B, L, D) for the out-projection;
// - separate (B, L, H, head_dim) q, k and v of the flash path
//   (ovt_flash_attention), with Lq != Lk and an optional f32 LSE output.
//
// Replaces the attention core of these Pallas kernels:
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
// - _kernel, _block_kernel and _block_partial_kernel
//   (openvision_tpu/ops/fused_attention.py:92, :440, :938): the same core
//   and the unmasked, causal and prefix-LM masks (_tvalid, :64); Pallas folds
//   the scale into the q projection: at a power-of-two scale (2**-3 at
//   head_dim 64) scaling q here gives the same bits, at any other the
//   wrapper folds it into the weights as Pallas does and passes scale 1;
// - _fwd_kernel and _fwd_kernel_single_k(_nolse)
//   (openvision_tpu/ops/flash_attention.py:133, :76, :85): `prescale` picks
//   the single-k order (q * scale rounded to bf16 before q.k^T) or the
//   multi-k order (f32 scores times scale); the LSE m + log(l) is written
//   when asked for (log(l) under nomax), which the backward chains'
//   recompute of the forward reads (_mhsa_t_bwd_kernel, _qkv_bwd_kernel,
//   _block_bwd_kernel, _block_partial_bwd_kernel).
// Key j is visible to query i iff j < Lk and, when causal, j <= max(i,
// prefix - 1). Whole key tiles that no query of the block can see are
// skipped, as _live (flash_attention.py:61) skips dead blocks: the live tiles
// are the contiguous range [0, last].
//
// Every head_dim that is a multiple of 8 from 16 (attention.cuh: a tile is
// the head_dim rounded up to 16 in chunks of 64, 32 and 16 columns, one TMA
// box and one swizzle each); one instantiation a padded head_dim. Above 64
// the ring holds two stages (not four) and two CTAs an SM (not three): the
// P V accumulator grows with head_dim (HDP / 2 registers). From 136 to 256
// attention_xwide.cu's kernel holds the whole O in two consumer warpgroups
// of a 128-row CTA (193 KB of shared memory at 256), and from 264 to 512
// attention_slab.cu's holds it in one consumer warpgroup a 128-column slab,
// the scores summed over the slabs once; above 512 the per-part slab kernel
// streams the head_dim. Each is one launch a call.
//
// Bound on the H100: at the port's shapes (head_dim 64, L of 128..900) the
// FLOPs are 4*Lq*Lk*64 per (batch, head) against 2*(2*Lq + 2*Lk)*64 bytes,
// about Lq*Lk/(Lq+Lk) FLOP/byte: 64..145, below the card's ~295 FLOP/byte
// ridge, so the floor is the bytes of q, k, v and o (40.2 us at b=64,
// L=257, 16 heads). The exponentials come next: 64*16*257*257 of them at
// that shape, ~17 us at the special-function units' ~3.9 T/s.
//
// What held the mma.sync kernel this replaces (1.39x SDPA at L=257), and
// what this design does about each (csrc/attention.cuh holds what it
// shares with the backward pair):
// 1. No load overlap: each K/V tile was loaded, waited for and computed in
//    turn. Here K and V tiles of 64 keys stream through a ring of four
//    stages under full/empty mbarriers, loaded by TMA from one thread of a
//    producer warp that runs the ring ahead, each stage as soon as the
//    consumers release it. The maps read the QKV buffer's heads by stride
//    (one map over its 3H heads) and the flash path's views; TMA's zero
//    fill supplies rows past the sequence.
// 2. mma.sync with ldmatrix for every K and V fragment. Here S = Q K^T is
//    wgmma from shared memory (both K-major), and O += P V takes P from
//    registers as wgmma's A operand (the score accumulator rounded to bf16
//    in place) and V as an MN-major B (the transpose bit): P never goes
//    through shared memory. The next tile's S group is issued before this
//    tile's P V group, so the softmax of tile t runs while P V of tile t - 1
//    is in the tensor cores.
// 3. L2 re-reads: every 64-row CTA reads its head's whole K and V. Two
//    consumer warpgroups sharing each tile (128 rows a CTA) would halve
//    that, but their nine warps fit two CTAs an SM only at 96 registers
//    (one SM partition's share), which spills this loop; measured, one
//    warpgroup (three CTAs an SM at 106 registers) is the faster.
// 4. Ragged tiles: the last key tile runs at the narrowest wgmma N (8, 16,
//    32 or 64) that covers it, so at L = 257 the fifth key tile (one key)
//    costs an N = 8 product. Its P V reduces over N rounded up to k16: the
//    A fragment's extra columns are zero and the V rows past Lk TMA's
//    zeros. Masks are applied only in tiles that straddle Lk or the causal
//    edge (a warp-uniform test per 16 rows). The CTA's own 64 rows stay a
//    whole tile: at L = 257 one CTA in five holds one row.
// 5. The exponential: one ex2 an element, exp(s sc - m sc) = ex2(s c -
//    m c) with c = sc log2(e), the score's scale folded into the exponent in
//    both orders; under nomax ex2(min(s c, 80 log2(e))). The single-k
//    order's rounding of q * scale to bf16 is a pass over the Q tile in
//    shared memory, taken only where it changes bits: a power-of-two scale
//    (2**-3 at head_dim 64) goes into the exponent as the multi-k order's
//    does, with the same bits.
// The epilogue writes bf16 rows 16 bytes a lane (each row's four lanes swap
// column pairs) or f32 pairs (a whole 32-byte sector a row a step).
// The alternatives measured against this design (two warpgroups, 128-key
// tiles, 2 or 3 stages, no overlap, no producer warp, no fold) are in
// PERF.md's design-choice table.
#include "attention_fwd.cuh"

// The padded head_dims 80..128, built in attention_wide.cu, 144..256, built
// in attention_xwide.cu, and the slab kernels above, in attention_slab.cu.
int attention_slab(const void* qkv, void* out, int batch, int seq, int heads, int head_dim,
                   float scale, int nomax, int causal, int prefix, int out_f32, void* stream);
int flash_attention_slab(const void* q, const void* k, const void* v, void* out, void* lse,
                         const long long* strides, int batch, int lq, int lk, int heads,
                         int head_dim, float scale, int prescale, int causal, int prefix,
                         int nomax, void* stream);
int attention_xwide(const void* qkv, void* out, int batch, int seq, int heads, int head_dim,
                    float scale, int nomax, int causal, int prefix, int out_f32, void* stream);
int flash_attention_xwide(const void* q, const void* k, const void* v, void* out, void* lse,
                          const long long* strides, int batch, int lq, int lk, int heads,
                          int head_dim, float scale, int prescale, int causal, int prefix,
                          int nomax, void* stream);
int attention_wide(const void* qkv, void* out, int batch, int seq, int heads, int head_dim,
                   float scale, int nomax, int causal, int prefix, int out_f32, void* stream);
int flash_attention_wide(const void* q, const void* k, const void* v, void* out, void* lse,
                         const long long* strides, int batch, int lq, int lk, int heads,
                         int head_dim, float scale, int prescale, int causal, int prefix,
                         int nomax, void* stream);

// qkv: (batch, seq, 3 * heads * head_dim) bf16, contiguous, 16-byte aligned,
// q | k | v blocks each head-major; out: (batch, seq, heads * head_dim) bf16,
// or f32 when out_f32 (unmasked only); one batch item of qkv must hold fewer
// than 2**31 elements.
// q is scaled by `scale` and rounded before q.k^T. causal / prefix select the
// causal and prefix-LM masks. head_dim: a multiple of 8 from 16 up.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// what the kernel does not take).
extern "C" int ovt_attention(const void* qkv, void* out, int batch, int seq, int heads,
                             int head_dim, float scale, int nomax, int causal, int prefix,
                             int out_f32, void* stream) {
  if ((out_f32 && causal) || !head_dim_ok(head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim > 256)
    return attention_slab(qkv, out, batch, seq, heads, head_dim, scale, nomax, causal, prefix,
                          out_f32, stream);
  if (head_dim > 128)
    return attention_xwide(qkv, out, batch, seq, heads, head_dim, scale, nomax, causal, prefix,
                           out_f32, stream);
  if (head_dim > 64)
    return attention_wide(qkv, out, batch, seq, heads, head_dim, scale, nomax, causal, prefix,
                          out_f32, stream);
  return by_head_dim<16, 32, 48, 64>(head_dim, [&](auto hdp) {
    return fwd_packed<decltype(hdp)::value>(qkv, out, batch, seq, heads, head_dim, scale, nomax,
                                            causal, prefix, out_f32, stream);
  });
}

// q: (batch, lq, heads, head_dim), k and v: (batch, lk, heads, head_dim), all
// bf16 with unit stride in head_dim and 16-byte aligned rows (head_dim a
// multiple of 8 from 16 up); `strides` holds the (batch, row, head)
// strides of q, k, v and out, in elements, 12 in all.
// Within one batch item, offsets must stay below 2**31 elements.
// out: (batch, lq, heads, head_dim) bf16 by its strides; lse: (batch, heads,
// lq) f32 contiguous, or null. prescale = 1 rounds q * scale to bf16 before
// q.k^T (the single-k Pallas order), 0 scales the f32 scores. nomax = 1
// takes exp(min(s, 80)) with no max subtraction (the fused_t option), and
// the lse it writes is then log(l): the recompute of _mhsa_t_bwd_kernel's
// forward (openvision_tpu/ops/fused_encoder.py:215) for the backward.
extern "C" int ovt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   void* lse, const long long* strides, int batch, int lq,
                                   int lk, int heads, int head_dim, float scale,
                                   int prescale, int causal, int prefix, int nomax,
                                   void* stream) {
  if (!head_dim_ok(head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim > 256)
    return flash_attention_slab(q, k, v, out, lse, strides, batch, lq, lk, heads, head_dim,
                                scale, prescale, causal, prefix, nomax, stream);
  if (head_dim > 128)
    return flash_attention_xwide(q, k, v, out, lse, strides, batch, lq, lk, heads, head_dim,
                                 scale, prescale, causal, prefix, nomax, stream);
  if (head_dim > 64)
    return flash_attention_wide(q, k, v, out, lse, strides, batch, lq, lk, heads, head_dim,
                                scale, prescale, causal, prefix, nomax, stream);
  return by_head_dim<16, 32, 48, 64>(head_dim, [&](auto hdp) {
    return fwd_flash<decltype(hdp)::value>(q, k, v, out, lse, strides, batch, lq, lk, heads,
                                           head_dim, scale, prescale, causal, prefix, nomax,
                                           stream);
  });
}

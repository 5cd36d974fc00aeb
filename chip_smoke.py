#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (each prints as it goes; any failure raises and exits non-zero):
1. torch / CUDA versions, the card's name and power limit, and the nvcc
   build of the kernels in openvision_tpu_torch/csrc (timed; one nvcc per
   source, in parallel). Fails if a GEMM kernel (bf16 or int8, one
   mainloop), an int8 quantiser, an attention kernel (the forward's
   instantiations, the two backward kernels) or a row-stream LayerNorm
   kernel (bf16 or int8) spills registers, or if the build holds no int8
   GEMM, no forward attention kernel, not both attention backward kernels
   or not both LayerNorm kernels at every chunk count; prints ptxas's notes
   on serialized wgmma.
2. Each kernel against its plain PyTorch version at ViT-L/14 shapes
   (B=8, L=257, D=1024, 16 heads, MLP 4096) and at a ragged L=101, with
   nomax on and off for attention. Inputs are bf16; the plain version runs
   in f32 from the same bf16 inputs.
2b. The masked attention and flash kernels against their plain versions at
   the caption path's shapes (B=8): unmasked L=257 over 16 heads, prefix-LM
   L=463 with prefix 335, causal L=128, a ragged causal L=101 with prefix 37
   (12 heads), flash cross-attention Lq=128 over Lk=335, and flash with the
   single-k and, at Lk > 768, the multi-k Pallas rounding order; the
   composed fused block (layernorm, QKV, attention, out-proj) against its
   plain version, held on what it adds to its input.
2c. The Hopper GEMM family (csrc/hopper.cuh: TMA + wgmma, warp-specialised,
   persistent): each layout (forward, NN, TN with and without the split over
   rows, #4's dual kernel) and epilogue against its plain version at a
   ragged M = 1000 and at the main path's b=64 products (QKV, out-proj,
   fc1, fc2, the tensor-2 shards, the dgrads, the wgrads, the dual kernel),
   bf16 outputs within 2**-7 and f32 ones within 2**-12 of max|plain|; each
   product then timed by CUDA-graph replay, its TFLOP/s and share of 989
   beside F.linear / torch.matmul, and the wrapper's host time a call; then
   #2 (mlp_block) and #4 (_mlp_backward_kernels) whole. Then the int8
   products (gemm_int8 on the same mainloop with s8 wgmma): bit-equal to
   their plain versions without GELU, 2**-12 with it, fc1's row max
   bit-equal to that of its output, at ragged shapes and the b=64 products
   for each tile width (128 x 128, 128 x 256 and the kernel's own choice);
   each of the int8 encode's products (QKV, out-proj, fc1 + GELU, fc2, the
   head) timed by graph replay at each tile width, its TOPS and share of
   1979 beside torch._int_mm alone and the bf16 product of the same shape;
   fc1 with its row max and one read of the hidden against two reads; #5
   and #6 whole beside the bf16 library calls; each int8 product at each
   bucket the daemon forms (M = b*257, b <= 48) at both tile widths and at
   the kernel's choice, the data of its tile rule. `python3 chip_smoke.py
   --gemm [ROOT]` runs this phase alone on the package of the checkout at
   ROOT (checks only for this checkout), so that two checkouts are timed on
   one card in one call; it then also times the int8, bf16 and plain
   encode at b=64 as phase 11 does, on a random export kept under build/.
3. The zero-shot path at full width, with random weights made from a seed:
   a ViT-L/14-224 + text-L export in OpenCLIP layout is written to a temp
   dir, loaded with load_model(dtype=bfloat16, attn_impl="fused_t",
   fast_gelu=True, device="cuda"), the testcat images are encoded through
   serving/encode.py and ranked against the nine zero-shot labels through
   tools/zero_shot.py. Checks: every kernel was launched the expected
   number of times, the embeddings are finite and unit-norm, and zimg has
   cosine >= 0.999 with the port's f32 plain (xla) path on the same card.
4. Encode throughput at batch 64 (CUDA events), kernels against the plain
   eager bf16 path, and each kernel's time against its plain version.
5. The caption path at full width (the caption tool's default model:
   ViT-L/14-224, text L, decoder L, vocab 32000, bf16): random weights from
   seed 0 drawn as a port state dict, mapped to the JAX flat names and
   written with the port's save_npz, loaded with tools/caption.py's
   build_captioner(device="cuda"); the testcat images captioned greedily and
   with top_k 40 at temperature 0.7, under dec_fusion concat and cross_attn
   with dec_attn_impl fused and flash. Checks: each kernel launched as the
   block counts give, finite logits, per-image logit cosine >= 0.999 with
   the port's f32 plain (xla) path on the same card, ids masked after the
   first eos; the share of greedy ids that agree with the f32 path is
   printed, not gated.
6. Captions/s at batch 64, kernels against the plain eager bf16 path (CUDA
   events), the device's idle share and top kernels under torch.profiler,
   where the caption time goes (image tower, text tower, decoder, head),
   and each kernel's time at the caption shapes beside its bound, its plain
   version and one PyTorch library call computing the same function (its
   library_ms, a yardstick the port never calls).
7. The backward kernels against their plain versions at B=8: the fused
   block's backward (the Pallas _block_bwd_kernel: layernorm, QKV, flash
   forward, gemm_nn, attention_bwd, gemm_tn, layernorm_bwd, colsum) at the
   image tower's L=257 D=1024, the concat decoder's prefix-LM L=463 and the
   cross_attn decoder's causal L=128, against the plain Pallas-order
   backward, dx held on dx - g; the flash backward (_dq_kernel /
   _dkv_kernel) at cross 128x335, causal L=128, Lk=900 (multi-k order) and
   the image tower's L=257 (a one-row tail tile on both axes).
   Each output's max|err| / max|plain| is printed beside its bound.
8. Training at full width: ViT-L/14-224 + text L + decoder L, bf16 compute
   on f32 master weights, remat=full, batch 64, seed-0 init, on the
   synthetic source at 224x224 through the trainer's data path
   (inception_crop is dropped from the pp string when the machine lacks
   Pillow). On identical params and batch the kernel path's loss and
   gradients are held against the plain bf16 path (loss within 2**-7
   relative, global gradient cosine >= 0.999; the per-tensor minimum cosine
   and the f32 plain path's printed beside). Then train/trainer.py runs 3
   steps on the kernels with dec_fusion=concat + dec_attn_impl=fused and
   with cross_attn + flash, and 3 on the plain bf16 path: every loss
   finite, each kernel launched as the block counts give (remat=full runs
   each forward twice); per configuration the step time by CUDA events,
   images/s, peak memory and the profiler's busy/event ratio of one step.
9. Each backward kernel at B=64, replayed from a CUDA graph, beside its
   bound, its plain version and one PyTorch library call (the autograd
   backward of scaled_dot_product_attention, torch.matmul in the same
   layout, the autograd backward of F.layer_norm, a column sum); per flash
   backward shape the pair's sum (attention_bwd_dq + attention_bwd_dkv, by
   events and by graph replay) beside SDPA's autograd backward, which
   computes what the two compute together, and each wrapper's host time a
   call. `python3 chip_smoke.py --attn [ROOT]` times the forward kernel's
   cases (phase 2b's, the f32 nomax output at L=257, b=64: events, graph
   replay, bound, SDPA, the wrapper's host time a call), then runs the
   flash backward shapes and #10's chain at L=257 alone, on the package of
   the checkout at ROOT (for this checkout it first applies phase 1's spill
   gate and the forward and phase 7's checks at B=8), so that two checkouts
   are timed on one card in one call.
10. The int8 serving kernels against their plain versions at ViT-L/14
   shapes (B=8, L=257 and a ragged L=101): gemm_int8 in each epilogue (QKV
   bf16, out-proj + residual, fc1 + GELU in f32, fc2 + residual),
   layernorm_quant, quant_rows (attention output and GELU hidden), the
   attention kernel's f32 output, and the composed int8 sub-blocks
   (mhsa_t_int8, mlp_t_int8) held on out - x. The products without GELU
   are bit-equal to their plain versions; fc1 also gives the hidden's row
   max, bit-equal to that of its output, and quant_rows on that hidden with
   that max is bit-equal to quant_rows reading the hidden for it. Quantised
   outputs against their plain versions: per-row scales within 2**-20 relative, int8 values
   equal but for flips by 1 (an f32 value on a rounding boundary) on at
   most 0.1% of them.
11. The int8 encode and the serving daemon at full width, on phase 3's
   export and phase 5's concat checkpoint: load_model(int8=True), the
   testcat batch through build_encode_fn(int8=True) on float and on uint8
   input (exact launch counts, unit-norm rows, zimg cosine >= 0.995
   against the f32 plain path, uint8 against float input); encode img/s at
   b=64 (CUDA events) on the int8 kernels, the bf16 fused_t kernels and
   plain eager bf16; each int8 kernel at b=64 by events and graph replay
   beside its bound (max(bytes / 3.35 TB/s, int8 ops / 1979 TOPS)), its
   plain version and a library yardstick (torch._int_mm plus the dequant
   as torch ops; the bf16 F.layer_norm + F.linear + SDPA sequence for the
   sub-blocks); layernorm_quant's JSON row is one launch (LN1). Then the port's server in-process on 127.0.0.1 (port 0,
   max_batch 48, so the capped bucket is warmed and used), once --int8 and
   once bf16 fused_t with the caption service, driven from 8 client
   threads over http.client on every route (the caption route's 503 and
   the next request on the same keep-alive connection included): replies,
   embeddings against build_encode_fn on the same rows (cosine >=
   0.99999), captions against the caption tool's greedy ids, coalescing;
   then requests/s and p50/p95 latency of /v1/embed/tensor under load.
   Without Pillow on the machine the routes that decode PNG bytes
   (/v1/rank, /v1/caption with an image) are not driven, and the script
   says so; the caption service is then driven through its batcher.
12. The training paths' kernels against their plain twins at B=8: the
   _mhsa_t_bwd_kernel chain (#3: the fused block's backward with the nomax
   recompute and f32 bias sums) at the image tower's L=257 D=1024 and the
   text tower's L=80 D=768, nomax off and on; the _mlp_t_bwd_kernel chain
   (#4: LayerNorm, the dual kernel (fc1 recompute and dGELU product in two
   accumulators, the f32 pre-activation kept on chip, column partials), the
   NN/TN GEMMs, LN backward, column sums) at both widths; the dual kernel
   alone; fused_qkv_attention's forward (#7) and
   the _qkv_bwd_kernel chain (#8) unmasked at L=257, causal at L=128 and
   prefix-LM at L=463. Each output within its bound (BWD_TOL), dx on dx - g.
13. Those kernels at B=64 (the image tower's shapes): CUDA events and
   CUDA-graph replay, launches per call, bound, plain, and the library
   calls for the same function (the autograd backward of F.layer_norm,
   F.linear, SDPA, F.linear + add for #3; of F.layer_norm, F.linear + tanh
   F.gelu, F.linear + add for #4; F.linear + SDPA and its autograd
   backward for #7 and #8).
14. Training path (a): phase 8's model and config with attn_impl=fused_t
   (both towers' 36 blocks on the fused_t kernels and their backwards, the
   concat decoder on fused): on identical params and batch the first
   step's loss within 2**-7 and gradient cosine >= 0.999 against plain
   bf16; then 3 steps through train/trainer.py with exact launch counts;
   step time, images/s, peak memory and the profiler's busy/event ratio.
15. Training path (b): the attn_impl=auto model with
   model.image.init_values=1e-5 and model.image.drop_path=0.1 (#7/#8 in
   all 24 image blocks), checked and timed as path (a) on one drop-path
   generator; then the trained weights loaded into an inference model
   encode one batch on #7's forward alone (24 launches of each kernel),
   zimg cosine >= 0.999 against the plain f32 path.
16. The tensor-parallel block kernels against their plain twins at B=8:
   _block_partial_kernel (#11: layernorm, QKV on the shard's (3D/t, D)
   rows, attention over its heads, the out-projection with K = D/t and no
   bias or residual) and _block_partial_bwd_kernel (#12: #10's chain on the
   shard's weights, dx the LayerNorm path's alone, no db_o) at the image
   tower's L=257 D=1024 (16 heads), the concat decoder's prefix-LM L=463
   (prefix 335, D=768, 12 heads) at tensor 2 and 4, and a ragged causal
   L=101 at tensor 2; then the shard identity on the card: the shards'
   #11 summed, plus x and bo, against #9, and #12's dx summed plus g and
   its gradients joined against #10.
17. #11 and #12 at B=64, L=257, tensor 2 and 4: CUDA events and CUDA-graph
   replay, launches per call, bound (max(bytes / 3.35 TB/s, FLOPs / 989
   TFLOP/s)), plain twin, and the library calls (F.layer_norm, F.linear on
   the shard, SDPA, F.linear; their autograd backward).
18. Tensor-parallel training through the normal entry point: torchrun
   (python -m torch.distributed.run --nproc_per_node 2) runs this script's
   --tp-grads mode, two ranks on the one card over gloo at tensor 2 (phase
   8's model, config, params and batch), whose loss and gathered gradients
   are held against the one-process kernel path (loss within 2**-7
   relative, global cosine >= 0.999), and which prints each rank's step
   time, peak memory and the all-reduce's share of a step; then
   python -m torch.distributed.run --nproc_per_node 2 -m
   openvision_tpu_torch.main_clip with sharding.mesh tensor=2 trains 3
   steps: finite losses, every TP block's #11/#12 launches as the block
   counts give (24 image + 12 decoder blocks, the forward twice under
   remat), one checkpoint, which the caption tool loads in one process and
   captions the testcat images with. A failure in any rank fails the phase.
`python3 chip_smoke.py --ln [ROOT]` times the row LayerNorm kernels of the
checkout at ROOT (csrc/layernorm.cu: the bf16 layernorm at b=64 over the
ViT-L/14 tower's 16448 x 1024, the decoder's prefix-LM 29632 x 768 and
causal 8192 x 768, beside F.layer_norm; layernorm_quant at 16448 x 1024)
by CUDA events and graph replay, beside the bytes bound, the plain version
and the wrapper's host time a call, then encode img/s at b=64 (int8, bf16
fused_t, plain eager bf16) on --gemm's export; it checks both kernels at
B=8 first and, for this checkout, applies phase 1's spill gate.
The last lines are the card's name and power limit, one JSON object of
per-kernel results, and {"ok": true, "device": {...}}.

It needs no network and imports no JAX. It decodes the testcat PNGs with
zlib (the card's machine may lack Pillow).
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# ViT-L/14-224 image tower + text tower L, embed 768: the published widths
# (openvision_tpu/models/vit.py:42, convert/export.py:41,141).
L14_CONFIG = {
    "model_cfg": {
        "embed_dim": 768,
        "vision_cfg": {"layers": 24, "width": 1024, "head_width": 64, "patch_size": 14,
                       "image_size": 224, "pool_type": "avg", "final_ln_after_pool": True,
                       "no_ln_pre": True},
        "text_cfg": {"layers": 12, "width": 768, "heads": 12, "context_length": 80,
                     "vocab_size": 30522, "pool_type": "last", "no_causal_mask": True,
                     "act_kwargs": {"approximate": "tanh"}},
    },
    "preprocess_cfg": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
}

# Per encoder block on the kernels (fused_t, or fused with tanh GELU):
# 2 LayerNorms, 4 projections, 1 attention.
# The backward kernels (phases 7-9) launch on no inference path.
LAUNCHES_PER_BLOCK = {"layernorm": 2, "gemm_bias_act": 4, "attention": 1, "flash_attention": 0,
                      "attention_bwd_dq": 0, "attention_bwd_dkv": 0, "gemm_nn": 0, "gemm_tn": 0,
                      "layernorm_bwd": 0, "colsum": 0, "gemm_int8": 0, "layernorm_quant": 0,
                      "quant_rows": 0, "mlp_bwd_dual": 0}
# Per int8 block (phase 11): 2 LN + quantise, 4 int8 products, 1 attention
# with f32 output, 2 quantises; per encode the pooled row's quantise and the
# head's int8 product on top.
INT8_LAUNCHES_PER_BLOCK = {"layernorm_quant": 2, "gemm_int8": 4, "attention": 1,
                           "quant_rows": 2}
INT8_LAUNCHES_PER_ENCODE = {"gemm_int8": 1, "quant_rows": 1}

# Kernel-vs-plain bounds, relative to the largest |plain output|: the kernels
# round their outputs to bf16 (<= 2**-9 relative), the residual add rounds
# once more and f32 sums run in another order -> 2**-7; attention also rounds
# the probabilities to bf16 before p.v -> 2**-6. The composed fused block is
# held on what its four launches add to x, out - x, whose largest value is
# far below the residual's: 2**-6 of max|out - x| (the attention bound),
# plus per element the bf16 rounding of the residual add, 2**-8 of |out|.
REL_TOL = {"layernorm": 2**-7, "gemm_bias_act": 2**-7, "attention": 2**-6,
           "flash_attention": 2**-6}
# The int8 kernels (phase 10), from the same int8 or bf16 inputs as their
# plain versions: gemm_int8's int32 sums are exact and its epilogue repeats
# the plain order, so only the bf16 rounding of its output (2**-9), the
# residual add's and GELU's last bits remain -> 2**-7; the composed int8
# sub-blocks are held on out - x as the fused block (2**-6 plus the residual
# rounding), since an int8 value that flips at a rounding boundary moves its
# row's product by one quantisation step. Quantised outputs: per-row scales
# within SCALE_REL_TOL, int8 values equal but for flips by 1 on at most
# QUANT_FLIPS of them.
REL_TOL["gemm_int8"] = 2**-7
SCALE_REL_TOL, QUANT_FLIPS = 2**-20, 1e-3
# Backward outputs, relative to max|plain| of each output (phase 7): the
# attention gradients round dS and P to bf16 where a different f32 summation
# order can flip a rounding -> 2**-6; the fused block's backward is a chain
# of 12 launches held against the plain Pallas-order backward, whose o and
# delta come from the rounded normalized probabilities where the kernels
# take the flash forward's -> 2**-5 for every output, dx on dx - g plus, per
# element, the bf16 rounding of dx = g + (dx - g) on both sides (2**-8 of
# |dx|, RESIDUAL_ROUNDING).
# The training paths' backward chains (phase 12) are held like the fused
# block's: #3 (the fused block's chain with the nomax recompute and f32
# bias sums), #4 (8 launches: dh rounded to bf16 where a sum order can flip
# it, compounded through dW1 and dy) and #8 (7 launches) -> 2**-5 for every
# output, dx on dx - g; #7's forward as the attention kernel, 2**-6; the
# dual kernel's bf16 gact and dh 2**-7 and its f32 column sums (db1) 2**-12.
# The tensor-parallel kernels (phase 16) are held as #9 and #10: #11's
# partial (no residual) at 2**-6 of max|plain|, #12's outputs at 2**-5, dx
# on dx alone (it has no residual).
BWD_TOL = {"attention_bwd": 2**-6, "fused block bwd": 2**-5, "mhsa_t bwd": 2**-5,
           "mlp_t bwd": 2**-5, "qkv bwd": 2**-5, "tp block bwd": 2**-5}
CASE_REL_TOL = {**REL_TOL, "fused block": 2**-6, "int8 mhsa block": 2**-6,
                "int8 mlp block": 2**-6, "qkv attention": 2**-6, "tp block": 2**-6}
RESIDUAL_ROUNDING = 2**-8  # half a bf16 ulp, relative to the value, at most

# Source and the Pallas kernels each serves, as file:line; the JSON line's
# "replaces" is the first of them, "serves" all of them.
_FE, _FA, _FL = ("openvision_tpu/ops/fused_encoder.py", "openvision_tpu/ops/fused_attention.py",
                 "openvision_tpu/ops/flash_attention.py")
_F8, _Q = "openvision_tpu/ops/fused_encoder_int8.py", "openvision_tpu/serving/quant.py"
_BWD3, _BWD4, _QKV7, _QKV8 = f"{_FE}:215", f"{_FE}:593", f"{_FA}:92", f"{_FA}:215"
_TP11, _TP12 = f"{_FA}:938", f"{_FA}:1057"
KERNEL_INFO = {
    "layernorm": ("openvision_tpu_torch/csrc/layernorm.cu",
                  [f"{_FE}:71", f"{_FE}:502", f"{_FA}:440", _BWD3, _BWD4, _TP11, _TP12]),
    "gemm_bias_act": ("openvision_tpu_torch/csrc/gemm_bias_act.cu",
                      [f"{_FE}:71", f"{_FE}:502", f"{_FA}:440", _QKV7, _BWD3, _BWD4, _QKV8, _TP11,
                       _TP12]),
    "attention": ("openvision_tpu_torch/csrc/attention.cu",
                  [f"{_FE}:71", f"{_FA}:440", f"{_F8}:39", _QKV7, _TP11]),
    "flash_attention": ("openvision_tpu_torch/csrc/attention.cu",
                        [f"{_FL}:133", f"{_FL}:76", f"{_FL}:85", _BWD3, _QKV8, _TP12]),
    "attention_bwd_dq": ("openvision_tpu_torch/csrc/attention_bwd.cu",
                         [f"{_FL}:207", f"{_FA}:698", _BWD3, _QKV8, _TP12]),
    "attention_bwd_dkv": ("openvision_tpu_torch/csrc/attention_bwd.cu",
                          [f"{_FL}:245", f"{_FA}:698", _BWD3, _QKV8, _TP12]),
    "gemm_nn": ("openvision_tpu_torch/csrc/gemm_grad.cu",
                [f"{_FA}:698", _BWD3, _BWD4, _QKV8, _TP12]),
    "gemm_tn": ("openvision_tpu_torch/csrc/gemm_grad.cu",
                [f"{_FA}:698", _BWD3, _BWD4, _QKV8, _TP12]),
    "layernorm_bwd": ("openvision_tpu_torch/csrc/layernorm.cu",
                      [f"{_FA}:698", _BWD3, _BWD4, _TP12]),
    "colsum": ("openvision_tpu_torch/csrc/layernorm.cu",
               [f"{_FA}:698", _BWD3, _BWD4, _QKV8, _TP12]),
    "mlp_bwd_dual": ("openvision_tpu_torch/csrc/gemm_grad.cu", [_BWD4]),
    "gemm_int8": ("openvision_tpu_torch/csrc/gemm_int8.cu", [f"{_F8}:39", f"{_F8}:138", f"{_Q}:415"]),
    "layernorm_quant": ("openvision_tpu_torch/csrc/layernorm.cu", [f"{_F8}:39", f"{_F8}:138"]),
    "quant_rows": ("openvision_tpu_torch/csrc/layernorm.cu", [f"{_F8}:39", f"{_F8}:138", f"{_Q}:415"]),
}

BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
F32_PEAK_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT8_PEAK_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)

# The caption tool's default model (tools/caption.py --config), bf16 for the
# kernels: ViT-L/14-224, text L, decoder L, vocab 32000, 80 text tokens and
# 128 queries.
CAPTION_ARG = "res=224,img=L/14,txt_name=L,txt_decoder_name=L"
RES, TOKEN_LEN, QUERIES, VOCAB, DEC_BLOCKS, IMG_BLOCKS = 224, 80, 128, 32000, 12, 24


def vit_l14_flops_per_image(res: int = 224) -> float:
    """Forward FLOPs of one ViT-L/14 image (as bench.py counts them)."""
    l = (res // 14) ** 2 + 1
    d, depth, mlp = 1024, 24, 4096
    per_block = 4 * l * d * d + 2 * l * l * d + 2 * l * d * mlp
    stem = l * d * (3 * 14 * 14)
    return 2.0 * (depth * per_block + stem)


# ---------------------------------------------------------------------------
# PNG decoding (8-bit, non-interlaced RGB / RGBA) with the standard library
# ---------------------------------------------------------------------------


def read_png(path: str) -> np.ndarray:
    """Decodes a PNG to (H, W, 3) uint8, dropping alpha like PIL's convert("RGB")."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or color not in (2, 6):
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are decoded")
    bpp = 3 if color == 2 else 4
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    out = bytearray(h * stride)
    prev = bytearray(stride)
    for y in range(h):
        start = y * (stride + 1)
        ftype, cur = raw[start], bytearray(raw[start + 1:start + 1 + stride])
        if ftype == 1:  # sub
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 255
        elif ftype == 2:  # up
            for i in range(stride):
                cur[i] = (cur[i] + prev[i]) & 255
        elif ftype == 3:  # average
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 255
        elif ftype == 4:  # paeth
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
        elif ftype != 0:
            raise ValueError(f"{path}: bad PNG filter {ftype}")
        out[y * stride:(y + 1) * stride] = cur
        prev = cur
    return np.frombuffer(bytes(out), np.uint8).reshape(h, w, bpp)[..., :3].copy()


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def phase(title: str) -> None:
    print(f"\n== {title} ==", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """Prints each kernel's registers and spill stores from nvcc's -Xptxas -v
    output (build.log); returns {kernel: spill store bytes}."""
    import re

    spills, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills[name] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"  ptxas: {name[:100]:100s} {m.group(1):>3s} registers, "
                  f"{spills.get(name, 0)} bytes spill stores")
            name = None
    return spills


def spill_gate(lib_path) -> None:
    """Phase 1's gate on the build log: the GEMM family (bf16 and int8, one
    mainloop), the int8 quantisers, the attention kernels (the forward's
    instantiations and the backward pair) and both row-stream LayerNorm
    kernels (bf16 and int8, one instantiation a chunk count) must not spill
    registers; the build must hold an int8 GEMM, the forward attention
    kernel, both attention backward kernels and both LayerNorm kernels.
    ptxas's notes on serialized wgmma are printed."""
    log = (lib_path.parent / "build.log").read_text()
    spills = ptxas_summary(log)
    gated = [f for f in spills if "gemm_ws_kernel" in f or "quant" in f or "attention_" in f
             or "ln_rows_kernel" in f]
    int8_gemms = [f for f in gated if "gemm_ws_kernel" in f and "2S8E" in f]
    attn_fwd = [f for f in gated if "attention_fwd" in f]
    attn_bwd = [f for f in gated if "attention_bwd" in f]
    ln = {epi: [f for f in gated if "ln_rows_kernel" in f and epi in f]
          for epi in ("LnBf16", "LnQuant")}
    print(f"spill gate: {len(gated)} kernels, {len(int8_gemms)} of them int8 GEMMs, "
          f"{len(attn_fwd)} attention forward, {len(attn_bwd)} attention backward, "
          f"{len(ln['LnBf16'])} + {len(ln['LnQuant'])} LayerNorm (bf16 + int8)")
    for epi, found in ln.items():
        if len(found) != 8:  # NC = 1..8
            raise AssertionError(f"expected the row-stream LayerNorm kernel ({epi}) at 8 chunk "
                                 f"counts, found {found}")
    for line in log.splitlines():
        if "wgmma" in line and "serializ" in line:
            print(f"  ptxas: {line.strip()[:200]}")
    if not int8_gemms:
        raise AssertionError("no int8 instantiation of gemm_ws_kernel in the build")
    if not attn_fwd:
        raise AssertionError("no forward attention kernel (attention_fwd_kernel) in the build")
    if len(attn_bwd) != 2:
        raise AssertionError(f"expected the two attention backward kernels, found {attn_bwd}")
    if any(spills[f] for f in gated):
        raise AssertionError(f"kernels that spill registers: {[f for f in gated if spills[f]]}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean time of fn() replayed from one CUDA graph of `iters` calls: the
    device time with no host time between launches. cuda_ms of back-to-back
    calls measures the host instead when a launch is shorter than its Python
    wrapper."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # off the capture: lazy module loads and first allocations
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(graph.replay, iters=3, warmup=1) / iters
    del graph
    return ms


def kernel_ms(fn, iters: int) -> dict:
    """{CUDA kernel name: its device time per fn() call in ms}, from
    torch.profiler over `iters` calls after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / iters / 1e3
    return per_kernel


def export_random_model(out_dir: str, cfg: dict, seed: int) -> None:
    """Writes a random-init OpenCLIP export (config + .bin) of `cfg`.

    Block matrices ~ N(0, 0.02) (the flax "vit" init's scale), LayerNorm
    scales 1 + N(0, 0.02), biases and embeddings N(0, 0.02), heads and the
    patch conv N(0, fan_in**-0.5), logit scale log(1/0.07).
    """
    import torch

    from openvision_tpu_torch.convert.openclip import state_dict_to_openclip
    from openvision_tpu_torch.models.clip import CLIPModel

    mcfg = cfg["model_cfg"]
    v, t = mcfg["vision_cfg"], mcfg["text_cfg"]
    shapes = CLIPModel(
        out_dim=mcfg["embed_dim"],
        image=dict(patch_size=(v["patch_size"],) * 2, width=v["width"], depth=v["layers"],
                   mlp_dim=4 * v["width"], num_heads=v["width"] // v["head_width"],
                   emb_head_bias=False, image_size=v["image_size"]),
        text=dict(width=t["width"], depth=t["layers"], mlp_dim=4 * t["width"],
                  num_heads=t["heads"], vocab_size=t["vocab_size"],
                  context_length=t["context_length"]),
    ).state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in shapes.items():
        shape = tuple(p.shape)
        if name == "logit_scale":
            arr = np.full(shape, np.log(1 / 0.07), np.float32)
        elif name.endswith(("proj", "projection", "conv1.weight")):
            fan_in = int(np.prod(shape[1:])) if name.endswith("conv1.weight") else shape[0]
            arr = rng.standard_normal(shape, dtype=np.float32) * fan_in**-0.5
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
            if ".ln_" in name and name.endswith("weight"):
                arr += 1.0
        sd[name] = torch.from_numpy(arr)
    torch.save(state_dict_to_openclip(sd), os.path.join(out_dir, "open_clip_pytorch_model.bin"))
    with open(os.path.join(out_dir, "open_clip_config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


class Case:
    """One kernel call at fixed inputs: the kernel, its plain version, one
    PyTorch library call computing the same function (or None), the bytes
    and operations the function needs (for its bound), and for a residual
    block its input x (the check then holds the block on out - x)."""

    def __init__(self, name, label, kern, plain, lib, nbytes, flops, f32_ops=0, residual=None,
                 int8_ops=0, quant=False, exact=False, row_max=False):
        self.name, self.label, self.kern, self.plain, self.lib = name, label, kern, plain, lib
        self.nbytes, self.flops, self.f32_ops, self.int8_ops = nbytes, flops, f32_ops, int8_ops
        self.residual = residual
        self.quant = quant  # kern and plain return (int8 values, f32 per-row scales)
        self.exact = exact  # the kernel's output must equal the plain version's bit for bit
        # (not for a quantise: the plain scale on the card may round otherwise)
        self.row_max = row_max  # kern returns (out, each row's max |out|): held bit-equal

    def bound(self):
        """(ms, "bytes" | "operations"): the least time the card could take,
        each input read once and each output written once."""
        t_bytes = self.nbytes / HBM_BYTES_PER_S
        t_ops = (self.flops / BF16_PEAK_FLOPS + self.f32_ops / F32_PEAK_FLOPS
                 + self.int8_ops / INT8_PEAK_OPS)
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def visible_pairs(lq: int, lk: int, causal: bool, prefix: int) -> int:
    """(query, key) pairs the mask lets through: key j is visible to query i
    iff j <= max(i, prefix - 1) when causal."""
    if not causal:
        return lq * lk
    i = np.arange(lq)
    return int(np.minimum(lk, np.maximum(i, prefix - 1) + 1).sum())


def _sdpa_kwargs(lq: int, lk: int, causal: bool, prefix: int, device) -> dict:
    """The mask arguments of torch's scaled_dot_product_attention."""
    import torch

    if causal and prefix > 0:
        rows = torch.arange(lq, device=device)[:, None]
        cols = torch.arange(lk, device=device)[None, :]
        return {"attn_mask": cols <= torch.clamp(rows, min=prefix - 1)}
    return {"is_causal": causal}


def _sdpa(q, k, v, causal: bool, prefix: int):
    """The library call: torch's scaled_dot_product_attention on (B, H, L, hd)."""
    import torch.nn.functional as F

    kw = _sdpa_kwargs(q.shape[2], k.shape[2], causal, prefix, q.device)
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def _library_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, sdpa_kw: dict):
    """The block as a sequence of library calls: F.layer_norm, F.linear,
    scaled_dot_product_attention, F.linear and the residual add."""
    import torch.nn.functional as F

    b, l, d = x.shape
    y = F.layer_norm(x, (d,), ln_w, ln_b, 1e-6)
    q, k, v = F.linear(y, w_qkv, b_qkv).view(b, l, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, **sdpa_kw)
    return x + F.linear(o.transpose(1, 2).reshape(b, l, d), w_o, b_o)


def attention_case(fe, qkv, heads: int, *, causal=False, prefix=0, nomax=False) -> Case:
    b, l, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.reshape(b, l, heads, 64).transpose(1, 2).contiguous()
               for t in qkv.split(d, dim=-1))
    mask = f" prefix={prefix}" if prefix else " causal" if causal else ""
    return Case(
        "attention", f"attn b={b} L={l} H={heads}{mask}{' nomax' if nomax else ''}",
        lambda: fe.attention(qkv, heads, nomax=nomax, causal=causal, prefix_len=prefix),
        lambda: fe.attention_plain(qkv.float(), heads, nomax=nomax, causal=causal,
                                   prefix_len=prefix),
        _sdpa(q, k, v, causal, prefix),
        (3 * b * l * d + b * l * d) * 2, 4 * b * heads * 64 * visible_pairs(l, l, causal, prefix))


def f32_attention_case(fe, qkv, heads: int) -> Case:
    """The int8 block's attention (#5): nomax, o / l written in f32."""
    import torch

    b, l, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.reshape(b, l, heads, 64).transpose(1, 2).contiguous()
               for t in qkv.split(d, dim=-1))
    return Case("attention", f"attn f32 out b={b} L={l} H={heads} nomax",
                lambda: fe.attention(qkv, heads, nomax=True, out_dtype=torch.float32),
                lambda: fe.attention_plain(qkv, heads, nomax=True, out_dtype=torch.float32),
                _sdpa(q, k, v, False, 0), 3 * b * l * d * 2 + b * l * d * 4,
                4 * b * heads * 64 * l * l)


def flash_case(fl, q, k, v, label, *, causal=False, prefix=0) -> Case:
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return Case(
        "flash_attention", f"flash {label} b={b} Lq={lq} Lk={lk} H={h}",
        lambda: fl.flash_attention(q, k, v, causal=causal, prefix_len=prefix),
        lambda: fl.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                         prefix_len=prefix)[0],
        _sdpa(qt, kt, vt, causal, prefix),
        (2 * b * lq * h * hd + 2 * b * lk * h * hd) * 2,
        4 * b * h * hd * visible_pairs(lq, lk, causal, prefix))


def kernel_cases(fe, device, gen, b: int, l: int, d: int = 1024, heads: int = 16,
                 mlp: int = 4096):
    """Cases of one ViT block's launches (the zero-shot path's shapes)."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    m = b * l
    x = rnd(b, l, d).bfloat16()
    ln_w, ln_b = rnd(d, scale=0.1) + 1, rnd(d, scale=0.1)
    ln_w16, ln_b16 = ln_w.bfloat16(), ln_b.bfloat16()
    proj = {
        "qkv": (rnd(3 * d, d, scale=d**-0.5).bfloat16(), rnd(3 * d, scale=0.1), False, False, d),
        "out+res": (rnd(d, d, scale=d**-0.5).bfloat16(), rnd(d, scale=0.1), False, True, d),
        "fc1+gelu": (rnd(mlp, d, scale=d**-0.5).bfloat16(), rnd(mlp, scale=0.1), True, False, d),
        "fc2+res": (rnd(d, mlp, scale=mlp**-0.5).bfloat16(), rnd(d, scale=0.1), False, True, mlp),
    }
    inputs = {d: x, mlp: rnd(b, l, mlp).bfloat16()}
    qkv = rnd(b, l, 3 * d).bfloat16()
    cases = [Case("layernorm", f"LN ({m}x{d})",
                  lambda: fe.layernorm(x, ln_w, ln_b, 1e-6),
                  lambda: fe.layernorm_plain(x.float(), ln_w, ln_b, 1e-6),
                  lambda: F.layer_norm(x, (d,), ln_w16, ln_b16, 1e-6),
                  2 * m * d * 2 + 2 * d * 4, 0, 8 * m * d)]
    for label, (w, bias, gelu, res, k) in proj.items():
        a = inputs[k]
        r = x if res else None
        n = w.shape[0]
        cases.append(Case(
            "gemm_bias_act", f"{label} ({m}x{n}x{k})",
            lambda a=a, w=w, bias=bias, gelu=gelu, r=r: fe.gemm_bias_act(a, w, bias, gelu=gelu,
                                                                          residual=r),
            lambda a=a, w=w, bias=bias, gelu=gelu, r=r: fe.linear_plain(
                a.float(), w.float(), bias, gelu=gelu, residual=None if r is None else r.float()),
            lambda a=a, w=w, b16=bias.bfloat16(): F.linear(a, w, b16),
            (m * k + n * k + m * n * (2 if res else 1)) * 2 + n * 4, 2 * m * n * k))
    for nomax in (False, True):
        cases.append(attention_case(fe, qkv, heads, nomax=nomax))
    return cases


def caption_attention_cases(fe, fl, device, gen, b: int):
    """The masked attention and flash cases at the caption path's shapes."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).bfloat16()

    cases = []
    for l, heads, causal, prefix in ((257, 16, False, 0), (463, 12, True, 335),
                                     (128, 12, True, 0), (101, 12, True, 37)):
        cases.append(attention_case(fe, rnd(b, l, 3 * heads * 64), heads, causal=causal,
                                    prefix=prefix))
    for label, lq, lk, causal, prefix in (
            ("cross", 128, 335, False, 0), ("prefix=335", 463, 463, True, 335),
            ("causal", 128, 128, True, 0), ("prefix=37", 101, 101, True, 37),
            ("multi-k", 64, 900, False, 0), ("multi-k prefix=340", 780, 780, True, 340)):
        q = rnd(b, lq, 12, 64)
        kv = rnd(b, lk, 2, 12, 64)  # k and v as strided views, as the model slices them
        cases.append(flash_case(fl, q, kv[:, :, 0], kv[:, :, 1], label, causal=causal,
                                prefix=prefix))
    return cases


def block_cases(fa, device, gen, b: int):
    """The composed fused block (#9) at the caption path's three shapes: the
    image tower, the concat decoder and the cross_attn decoder's
    self-attention. Its bound counts x, the weights and the output once (the
    Pallas kernel keeps every intermediate on chip); its library time is the
    sequence of library calls of :func:`_library_block`."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    out = []
    for l, d, heads, causal, prefix in ((257, 1024, 16, False, 0), (463, 768, 12, True, 335),
                                        (128, 768, 12, True, 0)):
        x = rnd(b, l, d).bfloat16()
        w = (rnd(d, scale=0.1) + 1, rnd(d, scale=0.1), rnd(3 * d, d, scale=d**-0.5).bfloat16(),
             rnd(3 * d, scale=0.1), rnd(d, d, scale=d**-0.5).bfloat16(), rnd(d, scale=0.1))
        w16 = tuple(t.bfloat16() for t in w)
        kw = dict(num_heads=heads, causal=causal, prefix_len=prefix)
        sdpa_kw = _sdpa_kwargs(l, l, causal, prefix, device)
        out.append(Case(
            "fused block", f"block b={b} L={l} D={d} H={heads}"
            + (f" prefix={prefix}" if prefix else " causal" if causal else ""),
            lambda x=x, w=w, kw=kw: fa.fused_mhsa_block(x, *w, **kw),
            lambda x=x, w=w, kw=kw: fa.fused_mhsa_block_plain(
                x.float(), w[0], w[1], w[2].float(), w[3], w[4].float(), w[5], **kw),
            lambda x=x, w16=w16, h=heads, skw=sdpa_kw: _library_block(x, *w16, h, skw),
            (2 * b * l * d + 4 * d * d) * 2 + 6 * d * 4,
            2 * b * l * 4 * d * d + 4 * b * heads * 64 * visible_pairs(l, l, causal, prefix),
            residual=x))
    return out


def check_cases(cases, worst: dict) -> None:
    """Each case's kernel within its bound of its plain version; a residual
    block is held on what it adds to its input (see CASE_REL_TOL)."""
    import torch

    for c in cases:
        got, ref = c.kern(), c.plain()
        torch.cuda.synchronize()
        if c.row_max:
            got, amax = got
            if not torch.equal(amax, got.abs().amax(-1)):
                raise AssertionError(f"{c.name} {c.label}: the row max is not that of the output")
        if c.quant:
            check_quant(c, got, ref, worst)
            continue
        err = (got.float() - ref).abs()
        if c.residual is None:
            scale = ref.abs().max().item()
            bound = torch.full_like(ref, CASE_REL_TOL[c.name] * scale)
            note = ""
        else:
            scale = (ref - c.residual.float()).abs().max().item()
            bound = CASE_REL_TOL[c.name] * scale + RESIDUAL_ROUNDING * ref.abs()
            note = f" max|out-x|={scale:.3e}"
        ratio = (err / bound).max().item()
        ok = ratio <= 1 and bool(torch.isfinite(got).all())
        if c.exact:
            ok = ok and err.max().item() == 0
            note += "  (bit-equal required)"
        print(f"  {c.name:15s} {c.label:46s} max|err|={err.max().item():.3e}  "
              f"bound={CASE_REL_TOL[c.name] * scale:.3e}{note}  err/bound<={ratio:.3f}  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{c.name} {c.label}: max|err|/bound {ratio} > 1")
        worst[c.name] = max(worst.get(c.name, 0.0), err.max().item())


def check_quant(c: Case, got, ref, worst: dict) -> None:
    """A quantise: per-row scales within SCALE_REL_TOL, int8 values equal
    but for flips by 1 on at most QUANT_FLIPS of them; its max|err| is that
    of the dequantised values."""
    import torch

    (q, scale), (q_ref, scale_ref) = got, ref
    rel = ((scale - scale_ref).abs() / scale_ref.abs()).max().item()
    diff = (q.int() - q_ref.int()).abs()
    flips = diff.count_nonzero().item() / diff.numel()
    err = (q.float() * scale[..., None] - q_ref.float() * scale_ref[..., None]).abs().max().item()
    ok = (q.dtype == torch.int8 and rel <= SCALE_REL_TOL and diff.max().item() <= 1
          and flips <= QUANT_FLIPS)
    print(f"  {c.name:15s} {c.label:46s} scales max rel {rel:.3e} (bound {SCALE_REL_TOL:.3e})  "
          f"int8 flips {100 * flips:.4f}% (bound {100 * QUANT_FLIPS:.1f}%, max {diff.max().item()})"
          f"  dequantised max|err|={err:.3e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{c.name} {c.label}: scales {rel}, flips {flips}")
    worst[c.name] = max(worst.get(c.name, 0.0), err)


def time_case(c: Case) -> dict:
    """CUDA-event times of the kernel, its plain version and the library
    call over back-to-back calls, and the kernel's and the library call's
    time replayed from a CUDA graph (no host time between launches)."""
    k_ms, p_ms = cuda_ms(c.kern, 20), cuda_ms(c.plain, 3, warmup=1)
    l_ms = cuda_ms(c.lib, 20) if c.lib is not None else None
    k_graph = graph_ms(c.kern)
    l_graph = graph_ms(c.lib) if c.lib is not None else None
    b_ms, b_by = c.bound()

    def us(ms):
        return "n/a" if ms is None else f"{ms * 1e3:.1f}"

    print(f"  {c.name:15s} {c.label:46s} kernel {us(k_ms)} us (graph {us(k_graph)})  bound "
          f"{us(b_ms)} us ({b_by})  plain {us(p_ms)} us  library {us(l_ms)} us "
          f"(graph {us(l_graph)})")
    return {"ms": k_ms, "graph_ms": k_graph, "plain_ms": p_ms, "library_ms": l_ms,
            "library_graph_ms": l_graph, "bound_ms": b_ms, "bound_by": b_by}


def time_kernels(fe, device, batch: int = 64) -> dict:
    """Phase 4b: one ViT encoder block's launches of each kernel at `batch`,
    summed per kernel (time, bound, plain version and library call)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    times, largest = {}, {}
    for c in kernel_cases(fe, device, gen, batch, 257):
        if "nomax" in c.label:
            continue  # the encode path runs the max-subtracted softmax
        t = time_case(c)
        keys = ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms", "bound_ms")
        acc = times.setdefault(c.name, dict.fromkeys(keys, 0.0))
        for key in keys:
            acc[key] += t[key] or 0.0
        if t["bound_ms"] >= largest.get(c.name, 0.0):  # the largest launch names the bound
            largest[c.name] = t["bound_ms"]
            acc["bound_by"] = t["bound_by"]
    return times


# ---------------------------------------------------------------------------
# The Hopper GEMM family (phase 2c; alone: chip_smoke.py --gemm [ROOT])
# ---------------------------------------------------------------------------


GEMM_ROWS = 64 * 257  # b=64 at ViT-L/14's 257 tokens
# The main path's products at b=64: (label, layout, N, K, options). "fwd" is
# gemm_bias_act, A (M, K) . W (N, K)^T; "nn" is gemm_nn, dC (M, K) . W (K, N);
# "tn" is gemm_tn, dC (M, N)^T . X (M, K) -> (N, K); "dual" is #4's
# mlp_bwd_dual, y . W1^T and g . W2 over K = D into N = hidden.
GEMM_PRODUCTS = [
    ("QKV", "fwd", 3072, 1024, {}),
    ("out-proj + res", "fwd", 1024, 1024, {"residual": True}),
    ("fc1 + GELU", "fwd", 4096, 1024, {"gelu": True}),
    ("fc2 + res", "fwd", 1024, 4096, {"residual": True}),
    ("QKV t=2 (N = 3D/2)", "fwd", 1536, 1024, {}),
    ("out-proj t=2 (K = D/2, no bias)", "fwd", 1024, 512, {"bias": False}),
    ("do = g.Wo", "nn", 1024, 1024, {}),
    ("dy = dqkv.Wqkv, f32", "nn", 1024, 3072, {"f32": True}),
    ("dy = dh.W1, f32", "nn", 1024, 4096, {"f32": True}),
    ("dy t=2 = dqkv.Wqkv shard, f32", "nn", 1024, 1536, {"f32": True}),
    ("dWqkv = dqkv^T y", "tn", 3072, 1024, {}),
    ("dWo = g^T o", "tn", 1024, 1024, {}),
    ("dW1 = dh^T y", "tn", 4096, 1024, {}),
    ("dW2 = g^T gact", "tn", 1024, 4096, {}),
    ("dWqkv t=2", "tn", 1536, 1024, {}),
    ("#4 dual: y.W1^T and g.W2", "dual", 4096, 1024, {}),
]
GEMM_NAMES = {"fwd": "gemm_bias_act", "nn": "gemm_nn", "tn": "gemm_tn", "dual": "mlp_bwd_dual"}


def gemm_product(fe, gk, device, gen, m: int, layout: str, n: int, k: int, opts: dict):
    """(kernel, plain, library, flops) of one product: the kernel's call, its
    plain version in f32 from the same bf16 inputs (a tuple of outputs), the
    PyTorch call(s) for the same product, and its operations."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    if layout == "fwd":
        a, w = rnd(m, k).bfloat16(), rnd(n, k, scale=k**-0.5).bfloat16()
        b = rnd(n, scale=0.1) if opts.get("bias", True) else None
        r = rnd(m, n).bfloat16() if opts.get("residual") else None
        gelu = bool(opts.get("gelu"))
        b16 = None if b is None else b.bfloat16()
        return (lambda: (fe.gemm_bias_act(a, w, b, gelu=gelu, residual=r),),
                lambda: (fe.linear_plain(a.float(), w.float(), b, gelu=gelu,
                                         residual=None if r is None else r.float()),),
                lambda: F.linear(a, w, b16), 2 * m * n * k)
    if layout == "nn":
        a, w = rnd(m, k).bfloat16(), rnd(k, n, scale=k**-0.5).bfloat16()
        out = torch.float32 if opts.get("f32") else torch.bfloat16
        return (lambda: (gk.gemm_nn(a, w, out),), lambda: (gk.gemm_nn_plain(a, w, torch.float32),),
                lambda: torch.matmul(a, w), 2 * m * n * k)
    if layout == "tn":
        dc, x = rnd(m, n).bfloat16(), rnd(m, k).bfloat16()
        return (lambda: (gk.gemm_tn(dc, x),), lambda: (gk.gemm_tn_plain(dc, x, torch.float32),),
                lambda: torch.matmul(dc.t(), x), 2 * m * n * k)
    y, g = rnd(m, k).bfloat16(), rnd(m, k).bfloat16()
    w1, b1 = rnd(n, k, scale=k**-0.5).bfloat16(), rnd(n, scale=0.1)
    w2 = rnd(k, n, scale=n**-0.5).bfloat16()

    def sums(gact, dh, col):
        return gact, dh, col.sum(0)

    return (lambda: sums(*gk.mlp_bwd_dual(y, w1, b1, g, w2)),
            lambda: sums(*gk.mlp_bwd_dual_plain(y, w1, b1, g, w2)),
            lambda: (torch.matmul(y, w1.t()), torch.matmul(g, w2)), 4 * m * n * k)


def check_gemm(name: str, label: str, kern, plain, worst: dict) -> None:
    """Each output within 2**-7 (bf16) or 2**-12 (f32) of max|plain|."""
    import torch

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    ratios = []
    for a, r in zip(got, ref):
        err = (a.float() - r.float()).abs().max().item()
        tol = 2**-7 if a.dtype == torch.bfloat16 else 2**-12
        ok = err <= tol * r.float().abs().max().item() and bool(torch.isfinite(a).all())
        ratios.append(err / (tol * r.float().abs().max().item()))
        if not ok:
            raise AssertionError(f"{name} {label}: max|err| {err} over {tol} of max|plain|")
        worst[name] = max(worst.get(name, 0.0), err)
    print(f"  {name:13s} {label:44s} err/bound <= {max(ratios):.3f} ok")


def gemm_phase(fe, gk, fe8, device, worst: dict, check: bool = True) -> None:
    """Phase 2c: the GEMM family's layouts and epilogues against their plain
    versions at a ragged M = 1000 and at the main path's b=64 shapes, then
    each product timed by CUDA-graph replay beside F.linear / torch.matmul,
    with the wrapper's host time a call (tensor maps encoded, launch, no
    synchronize); then #2 (mlp_block) and #4 (_mlp_backward_kernels) whole.
    Products whose wrapper the package lacks are left out (an older
    checkout)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    products = [p for p in GEMM_PRODUCTS if hasattr(gk if p[1] != "fwd" else fe,
                                                    GEMM_NAMES[p[1]])]
    if check:
        for layout, n, k, opts in (("fwd", 1536, 768, {"gelu": True, "residual": True}),
                                   ("fwd", 256, 4096, {"bias": False}),
                                   ("nn", 768, 1536, {}), ("nn", 3072, 256, {"f32": True}),
                                   ("tn", 256, 4096, {}), ("dual", 768, 256, {})):
            if hasattr(gk if layout != "fwd" else fe, GEMM_NAMES[layout]):
                kern, plain, _, _ = gemm_product(fe, gk, device, gen, 1000, layout, n, k, opts)
                check_gemm(GEMM_NAMES[layout], f"{layout} 1000x{n}x{k} {opts}", kern, plain, worst)
    print(f"  products at M = {GEMM_ROWS} (b=64, L=257), CUDA-graph replay; peak 989 TFLOP/s "
          f"bf16 dense")
    for label, layout, n, k, opts in products:
        name = GEMM_NAMES[layout]
        kern, plain, lib, flops = gemm_product(fe, gk, device, gen, GEMM_ROWS, layout, n, k, opts)
        if check:
            check_gemm(name, f"{label} ({GEMM_ROWS}x{n}x{k})", kern, plain, worst)
        ms, lib_ms = graph_ms(kern), graph_ms(lib)
        t0 = time.perf_counter()
        for _ in range(50):
            kern()
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        tf, lib_tf = flops / ms / 1e9, flops / lib_ms / 1e9
        print(f"  {label:36s} {n:5d}x{k:<5d} {ms * 1e3:7.1f} us {tf:6.1f} TFLOP/s "
              f"({100 * tf / (BF16_PEAK_FLOPS / 1e12):4.1f}% of 989)  library {lib_ms * 1e3:7.1f} "
              f"us {lib_tf:6.1f} TFLOP/s  host {host_us:5.1f} us/call")
    rnd = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=device) * scale
    d, hidden = 1024, 4096
    x, g = rnd(64, 257, d).bfloat16(), rnd(64, 257, d).bfloat16()
    w = _mlp_params(rnd, d, hidden)
    w16 = [t.bfloat16() for t in w]
    fwd_ms, fwd_lib = graph_ms(lambda: fe.mlp_block(x, *w)), graph_ms(lambda: _library_mlp(x, *w16))
    bwd_ms = graph_ms(lambda: fe._mlp_backward_kernels(x, *w, g, eps=1e-6), iters=10)
    print(f"  #2 mlp_block (LN, fc1 + GELU, fc2 + res) b=64: {fwd_ms * 1e3:.1f} us (library "
          f"{fwd_lib * 1e3:.1f} us: F.layer_norm, F.linear + tanh F.gelu, F.linear + add)")
    print(f"  #4 _mlp_backward_kernels b=64: {bwd_ms * 1e3:.1f} us")
    del x, g, w, w16
    int8_gemm_phase(fe, fe8, device, worst, check)


# The int8 encode's products at b=64 (phase 2c, gemm_int8): (label, N, K,
# options); M = GEMM_ROWS, the head's M = 64 (the batch).
INT8_PRODUCTS = [
    ("QKV", 3072, 1024, {}),
    ("out-proj + res", 1024, 1024, {"residual": True}),
    ("fc1 + GELU, f32 + row max", 4096, 1024, {"gelu": True}),
    ("fc2 + res", 1024, 4096, {"residual": True}),
    ("head (M = 64), f32", 768, 1024, {"rows": 64}),
]


def int8_product(fe, fe8, device, gen, m: int, n: int, k: int, opts: dict, new_api: bool):
    """(kernel(tile_n), plain, _int_mm, bf16 product, int8 ops, bytes) of one
    gemm_int8 product: the kernel's call at a tile width (0: its own choice;
    an older package takes only 0), its plain version, torch._int_mm alone,
    and gemm_bias_act on bf16 operands of the same shape."""
    import torch

    a = torch.randint(-127, 128, (m, k), generator=gen, device=device).to(torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=device).to(torch.int8)
    a_s = torch.rand(m, generator=gen, device=device) * 0.05 + 1e-3
    w_s = torch.rand(n, generator=gen, device=device) * k**-0.5 / 127 + 1e-5
    b = torch.randn(n, generator=gen, device=device) * 0.1
    gelu, res = bool(opts.get("gelu")), opts.get("residual")
    r = torch.randn(m, n, generator=gen, device=device).bfloat16() if res else None
    out = torch.float32 if gelu or "rows" in opts else torch.bfloat16
    kw = dict(gelu=gelu, out_dtype=out, residual=r)

    def kern(tile_n=0, row_amax=gelu):
        if not new_api:
            return fe8.gemm_int8(a, a_s, w, w_s, b, **kw)
        return fe8._gemm_int8(a, a_s, w, w_s, b, row_amax=row_amax, tile_n=tile_n, **kw)

    a16 = torch.randn(m, k, generator=gen, device=device).bfloat16()
    w16 = (torch.randn(n, k, generator=gen, device=device) * k**-0.5).bfloat16()
    nbytes = m * k + n * k + m * n * (4 if out == torch.float32 else 2) + (m * n * 2 if res else 0)
    return (kern, lambda: fe8.gemm_int8_plain(a, a_s, w, w_s, b, **kw),
            lambda: torch._int_mm(a, w.t()),
            lambda: fe.gemm_bias_act(a16, w16, b, gelu=gelu, residual=r),
            2 * m * n * k, nbytes + m * 4 + n * 8)


def int8_gemm_phase(fe, fe8, device, worst: dict, check: bool = True) -> None:
    """Phase 2c's int8 half: gemm_int8 against its plain version (bit-equal
    without GELU, 2**-12 with it, the row max bit-equal to that of its own
    output) at ragged shapes and at the int8 encode's b=64 products, at each
    tile width; then each product by CUDA-graph replay, its TOPS and share
    of 1979 at each tile width, beside torch._int_mm alone and the bf16
    product of the same shape; fc1 with the row max and one read of the
    hidden against fc1 and two reads; then #5 (mhsa_t_int8) and #6
    (mlp_t_int8) whole beside the bf16 library calls; then each product at
    each of the daemon's buckets at both widths and at the kernel's choice.
    An older package (no forced width, no row max) is timed at its own tile
    and route, at b=64 only."""
    import torch
    import torch.nn.functional as F

    from openvision_tpu_torch.serving.quant import quant_w

    new_api = hasattr(fe8, "_gemm_int8")
    tiles = (0, 128, 256) if new_api else (0,)
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    if check:
        shapes = [(1000, n, k, o) for _, n, k, o in INT8_PRODUCTS]
        shapes += [(257, 776, 1040, {"residual": True}), (257, 776, 1040, {"gelu": True}),
                   (GEMM_ROWS, 3072, 1024, {}), (GEMM_ROWS, 4096, 1024, {"gelu": True})]
        for m, n, k, opts in shapes:
            kern, plain, _, _, _, _ = int8_product(fe, fe8, device, gen, m, n, k, opts, new_api)
            ref = plain()
            for tile_n in tiles:
                got = kern(tile_n)
                label = f"{m}x{n}x{k} {opts} tile_n={tile_n}"
                if opts.get("gelu"):
                    got, amax = got
                    if not torch.equal(amax, got.abs().amax(-1)):
                        raise AssertionError(f"gemm_int8 {label}: row max differs")
                    err = (got - ref).abs().max().item()
                    ok = err <= 2**-12 * ref.abs().max().item()
                else:
                    err = (got.float() - ref.float()).abs().max().item()
                    ok = torch.equal(got, ref)
                worst["gemm_int8"] = max(worst.get("gemm_int8", 0.0), err)
                print(f"  gemm_int8     {label:60s} max|err|={err:.3e} "
                      f"{'(row max equal) ' if opts.get('gelu') else '(bit-equal) '}"
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"gemm_int8 {label}: max|err| {err}")
    print(f"  int8 products (b=64), CUDA-graph replay; peak 1979 TOPS int8 dense; tile widths "
          f"{tiles} (0: the kernel's own choice)")
    for label, n, k, opts in INT8_PRODUCTS:
        m = opts.get("rows", GEMM_ROWS)
        kern, _, int_mm, bf16_mm, ops, nbytes = int8_product(fe, fe8, device, gen, m, n, k,
                                                             opts, new_api)
        bound = max(ops / INT8_PEAK_OPS, nbytes / HBM_BYTES_PER_S) * 1e6
        times = {t: graph_ms(lambda t=t: kern(t)) for t in tiles}
        lib_ms, bf_ms = graph_ms(int_mm), graph_ms(bf16_mm)
        line = "  ".join(f"tile {t or 'auto'} {ms * 1e3:7.1f} us {ops / ms / 1e9:6.1f} TOPS "
                         f"({100 * ops / ms / 1e9 / (INT8_PEAK_OPS / 1e12):4.1f}%)"
                         for t, ms in times.items())
        print(f"  int8 {label:27s} {m}x{n}x{k}  {line}  bound {bound:6.1f} us  _int_mm "
              f"{lib_ms * 1e3:7.1f} us  bf16 gemm_bias_act {bf_ms * 1e3:7.1f} us")
    m, d, hidden, heads = GEMM_ROWS, 1024, 4096, 16
    x = torch.randn(64, 257, d, generator=gen, device=device).bfloat16()
    h = torch.randn(64, 257, hidden, generator=gen, device=device) * 2
    if new_api:
        amax = h.abs().amax(-1)
        kern, _, _, _, _, _ = int8_product(fe, fe8, device, gen, m, hidden, d, {"gelu": True},
                                           new_api)
        one = graph_ms(lambda: fe8.quant_rows(*kern()))
        two = graph_ms(lambda: fe8.quant_rows(kern(row_amax=False)))
        q_one = graph_ms(lambda: fe8.quant_rows(h, amax))
        q_two = graph_ms(lambda: fe8.quant_rows(h))
        print(f"  fc1 + GELU, then quant_rows of its hidden (b=64): with fc1's row max, one "
              f"read {one * 1e3:.1f} us; without, two reads {two * 1e3:.1f} us; quant_rows "
              f"alone {q_one * 1e3:.1f} / {q_two * 1e3:.1f} us")
    rnd = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=device) * scale
    ln = [(rnd(d, scale=0.1) + 1, rnd(d, scale=0.1)) for _ in range(2)]
    w = {"qkv": rnd(3 * d, d, scale=d**-0.5), "out": rnd(d, d, scale=d**-0.5),
         "fc1": rnd(hidden, d, scale=d**-0.5), "fc2": rnd(d, hidden, scale=hidden**-0.5)}
    bias = {k_: rnd(v.shape[0], scale=0.1) for k_, v in w.items()}
    q = {k_: quant_w(v) for k_, v in w.items()}
    w16 = {k_: v.bfloat16() for k_, v in w.items()}
    b16 = {k_: v.bfloat16() for k_, v in bias.items()}
    ln16 = [(lw.bfloat16(), lb.bfloat16()) for lw, lb in ln]
    mhsa = graph_ms(lambda: fe8.mhsa_t_int8(x, *ln[0], *q["qkv"], bias["qkv"], *q["out"],
                                            bias["out"], num_heads=heads), iters=10)
    mlp = graph_ms(lambda: fe8.mlp_t_int8(x, *ln[1], *q["fc1"], bias["fc1"], *q["fc2"],
                                          bias["fc2"]), iters=10)
    mhsa_lib = graph_ms(lambda: _library_block(x, *ln16[0], w16["qkv"], b16["qkv"], w16["out"],
                                               b16["out"], heads, {}), iters=10)

    def library_mlp():
        y = F.layer_norm(x, (d,), *ln16[1], 1e-6)
        y = F.gelu(F.linear(y, w16["fc1"], b16["fc1"]), approximate="tanh")
        return x + F.linear(y, w16["fc2"], b16["fc2"])

    mlp_lib = graph_ms(library_mlp, iters=10)
    print(f"  #5 mhsa_t_int8 b=64: {mhsa * 1e3:.1f} us (bf16 library {mhsa_lib * 1e3:.1f} us: "
          f"F.layer_norm, F.linear, SDPA, F.linear + add)")
    print(f"  #6 mlp_t_int8 b=64: {mlp * 1e3:.1f} us (bf16 library {mlp_lib * 1e3:.1f} us: "
          f"F.layer_norm, F.linear + tanh F.gelu, F.linear + add)")
    if new_api:
        int8_bucket_tiles(fe, fe8, device, gen)


def int8_bucket_tiles(fe, fe8, device, gen) -> None:
    """The int8 products at each bucket the daemon forms (max_batch 48:
    M = b*257, the head's M = b), by graph replay at tile widths 128 and
    256 and at the kernel's own choice, with the choice's time over the
    faster width's: the measurement that sets gemm_int8's tile rule."""
    from openvision_tpu_torch.serving.server import bucket_sizes

    print("  int8 products at the daemon's buckets (max_batch 48), graph replay, us: "
          "tile 128 / tile 256 / the kernel's choice (choice over the faster)")
    worst = 1.0
    for b in bucket_sizes(48):
        cells = []
        for label, n, k, opts in INT8_PRODUCTS:
            m = b if "rows" in opts else b * 257
            kern = int8_product(fe, fe8, device, gen, m, n, k, opts, True)[0]
            t = [graph_ms(lambda t=t: kern(t)) * 1e3 for t in (128, 256, 0)]
            worst = max(worst, t[2] / min(t[:2]))
            cells.append(f"{label.split(',')[0].split(' (')[0]} {t[0]:.1f}/{t[1]:.1f}/{t[2]:.1f} "
                         f"({t[2] / min(t[:2]):.3f})")
        print(f"  bucket b={b:2d} (M={b * 257:5d}): " + "; ".join(cells))
    print(f"  int8 tile choice at the buckets: worst {worst:.3f}x the faster width")


# ---------------------------------------------------------------------------
# The caption path (phases 5 and 6)
# ---------------------------------------------------------------------------


def caption_arg(fusion: str, dec_impl: str, dtype: str = "bfloat16", plain: bool = False) -> str:
    arg = f"{CAPTION_ARG},dtype={dtype},dec_fusion={fusion},dec_attn_impl={dec_impl}"
    return arg + ",attn_impl=xla" if plain else arg


def write_random_caption_checkpoint(path: str, fusion: str, seed: int) -> int:
    """Random CoCa weights drawn as a port state dict, mapped to the JAX flat
    names with the port's inverse map and written with the port's save_npz.

    Block matrices, biases and embeddings ~ N(0, 0.02), LayerNorm scales
    1 + N(0, 0.02), the learnable queries N(0, 1), heads, projections and the
    patch conv N(0, fan_in**-0.5), logit scale log(1/0.07). Returns the
    parameter count.
    """
    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.convert.openclip import state_dict_to_jax_params
    from openvision_tpu_torch.tools.caption import build_model
    from openvision_tpu_torch.train.checkpoint import save_npz

    model = build_model(get_config(caption_arg(fusion, "xla", "float32", True)))
    heads = {"vision": model.visual.transformer.resblocks[0].num_heads,
             "text": model.text.transformer.resblocks[0].num_heads,
             "decoder": model.txt_decoder.transformer.resblocks[0].num_heads}
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    del model
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        if name == "logit_scale":
            arr = np.full(shape, np.log(1 / 0.07), np.float32)
        elif name.endswith("learnable_tokens"):
            arr = rng.standard_normal(shape, dtype=np.float32)
        elif name.endswith(("visual.proj", "text_projection", "conv1.weight")):
            fan_in = int(np.prod(shape[1:])) if name.endswith("conv1.weight") else shape[0]
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(fan_in**-0.5)
        elif name.endswith(("projection_layer.weight", "txt_decoder.head.weight")):
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(shape[1]**-0.5)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
            if (".ln_" in name or "decoder_norm" in name) and name.endswith("weight"):
                arr += 1.0
        sd[name] = torch.from_numpy(arr)
    params = state_dict_to_jax_params(sd, num_heads_vision=heads["vision"],
                                      num_heads_text=heads["text"],
                                      num_heads_decoder=heads["decoder"])
    save_npz(path, {"params": params})
    return sum(int(np.prod(s)) for s in shapes.values())


def expected_caption_launches(fusion: str, dec_impl: str) -> dict:
    """Launches of one caption forward: the image tower's 24 fused blocks,
    the text tower on xla (none), and the decoder's blocks."""
    want = {k: IMG_BLOCKS * v for k, v in LAUNCHES_PER_BLOCK.items()}
    if dec_impl == "fused":  # concat: 12 masked fused blocks; cross_attn: 6 causal ones
        n = DEC_BLOCKS if fusion == "concat" else DEC_BLOCKS // 2
        for k, v in LAUNCHES_PER_BLOCK.items():
            want[k] += n * v
    else:  # flash: 12 self-attentions, or 6 causal self- and 6 cross-attentions
        want["flash_attention"] += DEC_BLOCKS
    return want


def check_eos_masking(ids, eos: int, pad: int) -> None:
    rows = ids.cpu().tolist()
    for row in rows:
        if eos in row:
            tail = row[row.index(eos) + 1:]
            if any(t != pad for t in tail):
                raise AssertionError(f"ids after the first eos are not pad: {row}")


def cosine_rows(a, b):
    import torch

    a, b = a.flatten(1).double(), b.flatten(1).double()
    return (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1))


def caption_phase(device, tmp: str, batch: np.ndarray, names, totals: dict) -> dict:
    """Phase 5: drives the caption path and checks it. Returns the loaded
    kernel captioners by (fusion, dec_impl) and the checkpoint paths."""
    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.models.decoder import mask_after_eos
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.tools.caption import build_captioner

    loaded, ckpts = {}, {}
    for fusion in ("concat", "cross_attn"):
        ckpts[fusion] = os.path.join(tmp, f"caption_{fusion}.npz")
        t0 = time.perf_counter()
        n_params = write_random_caption_checkpoint(ckpts[fusion], fusion, SEED)
        print(f"\n[{fusion}] wrote {n_params / 1e6:.1f}M random params as "
              f"{os.path.getsize(ckpts[fusion]) / 1e9:.2f} GB npz in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ref, _ = build_captioner(get_config(caption_arg(fusion, "xla", "float32", True)),
                                 ckpts[fusion], device=device)
        ref_logits = ref.logits(batch)
        ref_ids = mask_after_eos(ref_logits.argmax(-1), ref.eos, ref.pad)
        del ref
        print(f"[{fusion}] f32 plain (xla) reference in {time.perf_counter() - t0:.1f} s")
        for dec_impl in ("fused", "flash"):
            tag = f"[{fusion} / dec_attn_impl={dec_impl}]"
            t0 = time.perf_counter()
            cap, tok = build_captioner(get_config(caption_arg(fusion, dec_impl)), ckpts[fusion],
                                       device=device)
            print(f"{tag} build_captioner(bf16) in {time.perf_counter() - t0:.1f} s")
            want = expected_caption_launches(fusion, dec_impl)
            gen = torch.Generator(device=device).manual_seed(SEED)
            runs = {}
            for run, kw in (("greedy", {}),
                            ("top_k 40, temperature 0.7",
                             dict(temperature=0.7, top_k=40, generator=gen))):
                kernels.reset_launch_counts()
                ids = cap(batch, **kw)
                torch.cuda.synchronize()
                got = dict(kernels.LAUNCHES)
                print(f"{tag} {run}: launches {got}")
                if got != want:
                    raise AssertionError(f"{tag} {run}: launches {got}, expected {want}")
                for k, v in got.items():
                    totals[k] += v
                if (tuple(ids.shape) != (len(batch), QUERIES) or int(ids.min()) < 0
                        or int(ids.max()) >= VOCAB):
                    raise AssertionError(f"{tag} {run}: ids of shape {tuple(ids.shape)} "
                                         f"in [{int(ids.min())}, {int(ids.max())}]")
                check_eos_masking(ids, cap.eos, cap.pad)
                runs[run] = ids
            logits = cap.logits(batch)
            if logits.shape != ref_logits.shape or not torch.isfinite(logits).all():
                raise AssertionError(f"{tag}: logits {tuple(logits.shape)} are not finite")
            cos = cosine_rows(logits, ref_logits)
            agree = (runs["greedy"] == ref_ids).float().mean().item()
            print(f"{tag} logit cosine vs f32 plain: min {cos.min().item():.6f}  per image "
                  f"{[round(c, 6) for c in cos.tolist()]}; greedy ids agreeing with the f32 "
                  f"path: {100 * agree:.1f}% (not gated)")
            if cos.min().item() < 0.999:
                raise AssertionError(f"{tag}: logit cosine against the f32 plain path < 0.999")
            sampled = runs["top_k 40, temperature 0.7"]
            top40 = (logits / 0.7).topk(40, dim=-1).indices
            live = sampled != cap.pad
            if not (top40 == sampled[..., None]).any(-1)[live].all():
                raise AssertionError(f"{tag}: a sampled id lies outside the top 40")
            forced = runs["greedy"].clone()
            forced[:, 5] = cap.eos
            masked = mask_after_eos(forced, cap.eos, cap.pad)
            if not (masked[:, 6:] == cap.pad).all() or not (masked[:, 5] == cap.eos).all():
                raise AssertionError(f"{tag}: ids after a forced eos are not masked")
            for name, row in list(zip(names, runs["greedy"].tolist()))[:2]:
                print(f"{tag} {name}\tgreedy: {tok.decode(row)[:70]!r}")
            loaded[(fusion, dec_impl)] = cap
    return loaded, ckpts


def device_profile(fn, event_ms: float, iters: int = 3) -> str:
    """Device time of one fn() summed over its CUDA kernels, its raw ratio to
    `event_ms` (the CUDA-event time of one call, taken without the
    profiler), the idle share 1 - ratio, and the kernels that take the most
    of it. A ratio above 1 or below 0.5 is flagged SUSPECT: the profiler
    then over- or under-counts kernel time, and the shares are not read."""
    per_kernel = kernel_ms(fn, iters)
    busy = sum(per_kernel.values())
    if busy <= 0:
        return "device time not measured (the profiler recorded no CUDA kernel)"
    ratio = busy / event_ms
    flag = "" if 0.5 <= ratio <= 1.0 else " SUSPECT"
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return (f"device busy {busy:.2f} of {event_ms:.2f} ms, busy/event {ratio:.4f}{flag} "
            f"(idle {100 * (1 - ratio):.1f}%); top kernels: "
            + "; ".join(f"{k[:60]} {100 * v / busy:.1f}%" for k, v in top))


def caption_throughput(device, loaded: dict, ckpts: dict, batch: int = 64) -> dict:
    """Phase 6a: captions/s at `batch`, kernels against the plain eager bf16
    path, the device's busy time under torch.profiler, and where the time of
    one caption forward goes."""
    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.tools.caption import build_captioner

    x = torch.randn(batch, RES, RES, 3, generator=torch.Generator(device=device).manual_seed(2),
                    device=device)
    rates = {}
    for fusion in ("concat", "cross_attn"):
        plain, _ = build_captioner(get_config(caption_arg(fusion, "xla", plain=True)),
                                   ckpts[fusion], device=device)
        order = [("plain", plain)] + [(f"kernels {d}", loaded[(fusion, d)])
                                      for d in ("fused", "flash")]
        event_ms = {}
        for which, cap in order + order[::-1]:
            ms = cuda_ms(lambda: cap(x), iters=5, warmup=1)
            event_ms.setdefault(which, []).append(ms)
            rates.setdefault(f"{fusion} {which}", []).append(batch / (ms / 1e3))
            print(f"  {fusion:10s} {which:14s} b={batch}: {ms:8.2f} ms/batch  "
                  f"{batch / (ms / 1e3):8.1f} captions/s")
        for which, cap in order:
            print(f"  {fusion:10s} {which:14s} profile b={batch}: "
                  f"{device_profile(lambda: cap(x), min(event_ms[which]))}")
        for which, cap in (("kernels fused", loaded[(fusion, "fused")]), ("plain", plain)):
            m = cap.model
            text = torch.full((batch, TOKEN_LEN), cap.pad, dtype=torch.long, device=device)
            text[:, 0] = cap.bos
            img_tok, txt_tok = cap.tokens(x)
            with torch.inference_mode():
                h = torch.randn(batch, QUERIES, m.txt_decoder.head.weight.shape[1],
                                device=device)
            parts = {"image tower": lambda: m.visual(x), "text tower": lambda: m.text(text),
                     "decoder (with head)": lambda: m.txt_decoder(img_tok, txt_tok),
                     "head (f32)": lambda: h @ m.txt_decoder.head.weight.t()}
            line = "  ".join(f"{k} {cuda_ms(f, iters=5, warmup=1):.2f} ms" for k, f in parts.items())
            print(f"  {fusion:10s} {which:14s} breakdown b={batch}: {line}")
        del plain
    return rates


# ---------------------------------------------------------------------------
# The backward kernels and training (phases 7, 8 and 9)
# ---------------------------------------------------------------------------


# The trainer's model (the caption tool's default model) in bf16 compute.
TRAIN_ARG = "res=224,img=L/14,txt_name=L,txt_decoder_name=L"
TRAIN_BATCH, TRAIN_STEPS = 64, 3

# Launches of one fused block per step under remat=full: its forward twice
# (the step's forward, then the recompute before its backward) and its
# backward once; one differentiable flash call likewise.
FUSED_BLOCK_STEP = {"layernorm": 3, "gemm_bias_act": 5, "attention": 2, "flash_attention": 1,
                    "gemm_nn": 2, "attention_bwd_dq": 1, "attention_bwd_dkv": 1, "gemm_tn": 2,
                    "layernorm_bwd": 1, "colsum": 2}
FLASH_CALL_STEP = {"flash_attention": 2, "attention_bwd_dq": 1, "attention_bwd_dkv": 1}


def expected_train_launches(fusion: str, dec_impl: str, steps: int, names) -> dict:
    """Launches of `steps` training steps: the image tower's 24 fused blocks,
    the text tower on xla (none), and the decoder's blocks."""
    want = dict.fromkeys(names, 0)

    def add(per, n):
        for k, v in per.items():
            want[k] += v * n * steps

    if dec_impl == "xla":
        return want  # the plain path: every tower on xla
    add(FUSED_BLOCK_STEP, IMG_BLOCKS)
    if dec_impl == "fused":  # concat: 12 masked fused blocks; cross_attn: 6 causal ones
        add(FUSED_BLOCK_STEP, DEC_BLOCKS if fusion == "concat" else DEC_BLOCKS // 2)
    else:  # flash: 12 self-attentions, or 6 causal self- and 6 cross-attentions
        add(FLASH_CALL_STEP, DEC_BLOCKS)
    return want


def _leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def attention_bwd_cases(fl, gk, device, gen, b: int, which=None):
    """The flash backward kernels (#15/#16, #10's attention) at the caption
    and training shapes: per shape one case for each kernel, on the o and
    logsumexp of the flash forward kernel. Their library call is the
    autograd backward of scaled_dot_product_attention (all of dq, dk, dv)."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).bfloat16()

    shapes = [("cross", 128, 335, 12, False, 0), ("causal", 128, 128, 12, True, 0),
              ("multi-k", 64, 900, 12, False, 0), ("#10 image", 257, 257, 16, False, 0),
              ("#10 prefix=335", 463, 463, 12, True, 335)]
    cases = []
    for label, lq, lk, h, causal, prefix in shapes:
        if which is not None and label not in which:
            continue
        q, do = rnd(b, lq, h, 64), rnd(b, lq, h, 64)
        kv = rnd(b, lk, 2, h, 64)
        k, v = kv[:, :, 0], kv[:, :, 1]
        o, lse = fl.flash_attention(q, k, v, causal=causal, prefix_len=prefix, return_lse=True)
        kw = dict(scale=0.125, causal=causal, prefix_len=prefix)
        _, delta = gk.attention_bwd_dq(q, k, v, o, lse, do, **kw)
        plain = (lambda q=q, k=k, v=v, o=o, lse=lse, do=do, kw=kw: gk.attention_bwd_plain(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(), **kw))
        qt, kt, vt = _leaves(*(t.transpose(1, 2) for t in (q, k, v)))
        with torch.enable_grad():
            out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, **_sdpa_kwargs(lq, lk, causal, prefix, device))
        lib = (lambda out=out, leaves=(qt, kt, vt), g=do.transpose(1, 2): torch.autograd.grad(
            out, leaves, g, retain_graph=True))
        pairs = b * h * visible_pairs(lq, lk, causal, prefix)
        tag = f"{label} b={b} Lq={lq} Lk={lk} H={h}"
        cases.append(Case(
            "attention_bwd_dq", tag,
            lambda q=q, k=k, v=v, o=o, lse=lse, do=do, kw=kw: (
                gk.attention_bwd_dq(q, k, v, o, lse, do, **kw)[0],),
            lambda plain=plain: plain()[:1], lib,
            (4 * b * lq * h * 64 + 2 * b * lk * h * 64) * 2 + b * h * lq * 4, 3 * 2 * 64 * pairs))
        cases.append(Case(
            "attention_bwd_dkv", tag,
            lambda q=q, k=k, v=v, lse=lse, delta=delta, do=do, kw=kw: gk.attention_bwd_dkv(
                q, k, v, lse, delta, do, **kw),
            lambda plain=plain: plain()[1:], lib,
            (2 * b * lq * h * 64 + 4 * b * lk * h * 64) * 2 + 2 * b * h * lq * 4,
            4 * 2 * 64 * pairs))
    return cases


def block_bwd_parts(gk, device, gen, b: int, l: int = 257, d: int = 1024):
    """One fused-block backward's GEMM, LayerNorm and column-sum launches at
    the image tower's shapes (M = b * l rows), each a case of its kernel.
    Library calls: torch.matmul in the same layout, the autograd backward of
    F.layer_norm, torch.sum over the rows."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    m = b * l
    g, o, y = (rnd(b, l, d).bfloat16() for _ in range(3))
    dqkv = rnd(b, l, 3 * d, scale=0.1).bfloat16()
    w_o, w_qkv = rnd(d, d, scale=d**-0.5).bfloat16(), rnd(3 * d, d, scale=d**-0.5).bfloat16()
    x = (rnd(b, l, d) * 3 + 1).bfloat16()
    gamma, dy = rnd(d, scale=0.1) + 1, rnd(b, l, d)
    cases = []
    for label, a, w, out in (("do = g.Wo", g, w_o, torch.bfloat16),
                             ("dy = dqkv.Wqkv (f32 out)", dqkv, w_qkv, torch.float32)):
        n_in, n_out = w.shape
        cases.append(Case("gemm_nn", f"{label} ({m}x{n_in}->{n_out})",
                          lambda a=a, w=w, out=out: (gk.gemm_nn(a, w, out),),
                          lambda a=a, w=w: (gk.gemm_nn_plain(a, w, torch.float32),),
                          lambda a=a, w=w: a @ w,
                          (m * n_in + n_in * n_out) * 2 + m * n_out * (4 if out == torch.float32
                                                                        else 2),
                          2 * m * n_in * n_out))
    for label, dc, xin in (("dWo = g^T o", g, o), ("dWqkv = dqkv^T y", dqkv, y)):
        n, k = dc.shape[-1], xin.shape[-1]
        cases.append(Case("gemm_tn", f"{label} ({n}x{k} over {m})",
                          lambda dc=dc, xin=xin: (gk.gemm_tn(dc, xin),),
                          lambda dc=dc, xin=xin: (gk.gemm_tn_plain(dc, xin, torch.float32),),
                          lambda dc=dc, xin=xin, n=n, k=k: dc.reshape(-1, n).t() @ xin.reshape(-1, k),
                          (m * n + m * k + n * k) * 2, 2 * m * n * k))
    xl, wl, bl = _leaves(x, gamma.bfloat16(), torch.zeros(d, device=device).bfloat16())
    with torch.enable_grad():
        ln_out = F.layer_norm(xl, (d,), wl, bl, 1e-6)
    cases.append(Case("layernorm_bwd", f"LN bwd + residual ({m}x{d})",
                      lambda: gk.layernorm_bwd(x, gamma, dy, g, eps=1e-6),
                      lambda: gk.layernorm_bwd_plain(x.float(), gamma, dy, g.float(), eps=1e-6),
                      lambda: torch.autograd.grad(ln_out, (xl, wl, bl), dy.bfloat16(),
                                                  retain_graph=True),
                      m * d * (2 + 4 + 2 + 2) + 3 * d * 4, 0, 10 * m * d))
    for label, t, rnd_ in (("db_qkv per image, rounded", dqkv, True), ("db_o", g, False)):
        n = t.shape[-1]
        cases.append(Case("colsum", f"{label} ({m}x{n})",
                          lambda t=t, r=rnd_: (gk.colsum(t, l, r),),
                          lambda t=t, r=rnd_: (gk.colsum_plain(t, l, r),),
                          lambda t=t, n=n: t.reshape(-1, n).sum(0, dtype=torch.float32),
                          m * n * 2 + n * 4, 0, m * n))
    return cases


def fused_block_bwd_cases(fa, device, gen, b: int, lengths=(257, 463, 128)):
    """The fused block's whole backward (#10's 12 launches) at the three
    training shapes (those of `lengths`), against the plain Pallas-order
    backward; its library call is the autograd backward of the block as
    library calls."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    cases = []
    for l, d, heads, causal, prefix in ((257, 1024, 16, False, 0), (463, 768, 12, True, 335),
                                        (128, 768, 12, True, 0)):
        if l not in lengths:
            continue
        x, g = rnd(b, l, d).bfloat16(), rnd(b, l, d).bfloat16()
        w = (rnd(d, scale=0.1) + 1, rnd(d, scale=0.1), rnd(3 * d, d, scale=d**-0.5).bfloat16(),
             rnd(3 * d, scale=0.1), rnd(d, d, scale=d**-0.5).bfloat16(), rnd(d, scale=0.1))
        kw = dict(num_heads=heads, sm_scale=None, causal=causal, prefix_len=prefix, eps=1e-6)
        leaves = _leaves(x, *(t.bfloat16() for t in w))
        with torch.enable_grad():
            out = _library_block(*leaves, heads, _sdpa_kwargs(l, l, causal, prefix, device))
        m, pairs = b * l, b * heads * visible_pairs(l, l, causal, prefix)
        cases.append(Case(
            "fused block bwd", f"block bwd b={b} L={l} D={d} H={heads}"
            + (f" prefix={prefix}" if prefix else " causal" if causal else ""),
            lambda x=x, w=w, g=g, kw=kw: fa._backward_kernels(x, *w, g, **kw),
            lambda x=x, w=w, g=g, kw=kw: fa.fused_mhsa_block_bwd_plain(x, *w, g, **kw),
            lambda out=out, leaves=leaves, g=g: torch.autograd.grad(out, leaves, g,
                                                                    retain_graph=True),
            (3 * m * d + 4 * d * d + 4 * d * d) * 2 + 12 * d * 4,
            3 * 6 * m * d * d + 2 * 2 * m * d * d + 6 * 2 * 64 * pairs, residual=g))
    return cases


BWD_OUTPUTS = {"fused block bwd": ("dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_o", "db_o"),
               "attention_bwd_dq": ("dq",), "attention_bwd_dkv": ("dk", "dv"),
               "gemm_nn": ("out",), "gemm_tn": ("dW",), "layernorm_bwd": ("dx", "dvec"),
               "colsum": ("sums",),
               "mhsa_t bwd": ("dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_o", "db_o"),
               "mlp_t bwd": ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2"),
               "qkv bwd": ("dy", "dw_qkv", "db_qkv"), "mlp_bwd_dual": ("gact", "dh", "db1"),
               "tp block bwd": ("dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_o")}


def bwd_tol(case, out_name: str, got) -> float:
    """The bound of one backward output (see BWD_TOL and the GPU tests)."""
    import torch

    if case.name in BWD_TOL:
        return BWD_TOL[case.name]
    if case.name == "mlp_bwd_dual":
        return 2**-12 if out_name == "db1" else 2**-7
    if case.name.startswith("attention_bwd"):
        return BWD_TOL["attention_bwd"]
    if case.name == "layernorm_bwd":
        return 2**-6 if out_name == "dx" else 1e-4
    if case.name == "colsum":
        return 2**-7 if "rounded" in case.label else 1e-4
    return 2**-7 if got.dtype == torch.bfloat16 else 2**-12


def check_bwd_cases(cases, worst: dict) -> None:
    """Each output of each case within its bound of max|plain|; a residual
    case holds dx on dx - g. worst[kernel] collects max|err|."""
    import torch

    for c in cases:
        got, ref = c.kern(), c.plain()
        torch.cuda.synchronize()
        for out_name, a, r in zip(BWD_OUTPUTS[c.name], got, ref):
            a, r = a.float(), r.float()
            tol = bwd_tol(c, out_name, got[0])
            rounding = 0.0
            if c.residual is not None and out_name == "dx":
                # held on dx - g; both sides round dx = g + (dx - g) to bf16
                rounding = RESIDUAL_ROUNDING * r.abs()
                a, r = a - c.residual.float(), r - c.residual.float()
            err, scale = (a - r).abs().max().item(), r.abs().max().item()
            ok = bool(((a - r).abs() <= tol * scale + rounding).all()) and bool(
                torch.isfinite(a).all())
            print(f"  {c.name:17s} {c.label:44s} {out_name:6s} max|err|/max|plain| = "
                  f"{err / max(scale, 1e-30):.3e}  bound {tol:.3e}  {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{c.name} {c.label} {out_name}: {err / scale} > {tol}")
            if c.name in KERNEL_INFO:  # the composed chains are not rows of the JSON line
                worst[c.name] = max(worst.get(c.name, 0.0), err)


def time_bwd_case(c) -> dict:
    """The kernel by CUDA events and replayed from a CUDA graph, its plain
    version and its library call by CUDA events (an autograd backward is
    not captured)."""
    k_ms, p_ms = cuda_ms(c.kern, 10), cuda_ms(c.plain, 2, warmup=1)
    l_ms = cuda_ms(c.lib, 10) if c.lib is not None else None
    k_graph = graph_ms(c.kern, iters=10)
    b_ms, b_by = c.bound()
    print(f"  {c.name:17s} {c.label:44s} kernel {k_ms * 1e3:.1f} us (graph {k_graph * 1e3:.1f})"
          f"  bound {b_ms * 1e3:.1f} us ({b_by})  plain {p_ms * 1e3:.1f} us  library "
          f"{'n/a' if l_ms is None else f'{l_ms * 1e3:.1f}'} us")
    return {"ms": k_ms, "graph_ms": k_graph, "plain_ms": p_ms, "library_ms": l_ms,
            "library_graph_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def time_attention_bwd(fl, gk, device, gen, b: int = 64) -> dict:
    """Phase 9's flash backward cases (#15/#16, #10's attention) at `b`:
    each kernel timed (time_bwd_case), then per shape the pair's sum against
    the autograd backward of SDPA, which computes what the two compute
    together (its time the mean of the two cases' library calls), and each
    wrapper's host time a call (50 calls, no synchronize: the checks, the
    tensor maps and the launch). Returns the cross-attention shape's rows,
    the JSON line's."""
    import torch

    rows, by_shape = {}, {}
    for c in attention_bwd_cases(fl, gk, device, gen, b):
        t = time_bwd_case(c)
        t0 = time.perf_counter()
        for _ in range(50):
            c.kern()
        t["host_us"] = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        by_shape.setdefault(c.label, []).append(t)
        if c.label.startswith("cross"):  # the JSON row: the flash cross-attention
            rows[c.name] = t
    for label, (dq, dkv) in by_shape.items():
        pair, graph = (dq["ms"] + dkv["ms"]) * 1e3, (dq["graph_ms"] + dkv["graph_ms"]) * 1e3
        lib = (dq["library_ms"] + dkv["library_ms"]) / 2 * 1e3
        bound = (dq["bound_ms"] + dkv["bound_ms"]) * 1e3
        print(f"  pair {label:44s} dq + dkv {pair:.1f} us (graph {graph:.1f})  bound {bound:.1f} "
              f"us  SDPA backward {lib:.1f} us  pair / SDPA {pair / lib:.2f}  wrappers' host "
              f"time {dq['host_us']:.1f} + {dkv['host_us']:.1f} us a call")
    return rows


def forward_attention_cases(fe, fl, device, gen, b: int):
    """The forward kernel's cases (csrc/attention.cu) at batch b: the int8
    block's f32 nomax output at L=257 over the QKV buffer (#5), then phase
    2b's attention (#1, #7, #9, #11: unmasked L=257, prefix-LM, causal) and
    flash cases (#13, #14)."""
    import torch

    qkv = torch.randn(b, 257, 3 * 1024, generator=gen, device=device).bfloat16()
    return [f32_attention_case(fe, qkv, 16), *caption_attention_cases(fe, fl, device, gen, b)]


def time_attention_fwd(fe, fl, device, gen, b: int = 64) -> None:
    """Each forward case at `b` by CUDA events and graph replay beside its
    bound, SDPA's time (the library call) and the wrapper's host time a
    call (50 calls, no synchronize: the checks, the tensor maps and the
    launch); the kernel's ratio to SDPA and to its bound by graph."""
    import torch

    for c in forward_attention_cases(fe, fl, device, gen, b):
        t = time_case(c)
        t0 = time.perf_counter()
        for _ in range(50):
            c.kern()
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        print(f"  {'':15s} {c.label:46s} kernel / SDPA {t['ms'] / t['library_ms']:.2f} (graph "
              f"{t['graph_ms'] / t['library_graph_ms']:.2f})  graph / bound "
              f"{t['graph_ms'] / t['bound_ms']:.2f}  wrapper host {host_us:.1f} us a call")


def train_config(fusion: str, dec_impl: str, dtype: str = "bfloat16", no_pil: bool = False):
    """The trainer's config for phase 8: the caption model's widths, batch 64, on
    the synthetic source at 224x224, 3 steps (warmup 1 step, so the cosine
    over 3 steps applies), no checkpoint. Every config computes the image
    tower's MLP with tanh GELU (the bf16 default), so the f32 reference
    computes the same function."""
    from openvision_tpu_torch.configs.openvision import get_config

    plain = dec_impl == "xla"
    c = get_config(f"{TRAIN_ARG},dtype={dtype},dec_fusion={fusion},dec_attn_impl={dec_impl}"
                   + (",attn_impl=xla" if plain else ""))
    c["input"]["batch_size"] = TRAIN_BATCH
    c["input"]["data"] = {"name": "synthetic", "num_examples": 1024, "res": RES}
    c["total_steps"], c["log_training_steps"], c["save_ckpt"] = TRAIN_STEPS, 1, False
    c["schedule"][0][1]["warmup_steps"] = 1
    c["model"]["image"]["fast_gelu"] = True
    if no_pil:  # the crop resizes with PIL; the source is already 224x224
        c["input"]["pp"] = c["input"]["pp"].split("|", 1)[1]
    return c


def grad_cosines(a: dict, b: dict):
    """(global cosine, (min per-tensor cosine, its name)) of two gradient dicts."""
    import torch

    dot = sum((a[n].double() * b[n].double()).sum() for n in a)
    na = torch.sqrt(sum((a[n].double() ** 2).sum() for n in a))
    nb = torch.sqrt(sum((b[n].double() ** 2).sum() for n in b))
    per = {n: (a[n].double() * b[n].double()).sum().item()
           / max((torch.linalg.norm(a[n].double()) * torch.linalg.norm(b[n].double())).item(),
                 1e-300) for n in a}
    worst = min(per, key=per.get)
    return (dot / (na * nb)).item(), (per[worst], worst)


def train_phase(device, no_pil: bool, totals: dict) -> dict:
    """Phase 8. Returns per configuration its step ms, images/s and peak GB."""
    import torch

    from openvision_tpu_torch.data import pipeline
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.train import step as tstep
    from openvision_tpu_torch.train import trainer

    # gradients on identical params and batch: kernels, plain bf16, plain f32
    cfg_k = train_config("concat", "fused", no_pil=no_pil)
    loader, _ = pipeline.training(cfg_k["input"], seed=SEED)
    batch = next(loader)
    print(f"batch: { {k: (v.shape, str(v.dtype)) for k, v in batch.items()} }")
    model = tstep.build_model(cfg_k).to(device)
    init_params(model, SEED)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model

    def grads_for(cfg):
        m = tstep.build_model(cfg).to(device)
        m.load_state_dict(state)
        loss, _ = tstep.make_loss_fn(cfg, m)(tstep.to_device(batch, device))
        loss.backward()
        g = {n: p.grad.detach().float().clone() for n, p in m.named_parameters()}
        return loss.item(), g

    t0 = time.perf_counter()
    runs = {"kernels": grads_for(cfg_k),
            "plain bf16": grads_for(train_config("concat", "xla", no_pil=no_pil)),
            "plain f32": grads_for(train_config("concat", "xla", "float32", no_pil=no_pil))}
    print(f"three forward/backward passes in {time.perf_counter() - t0:.1f} s; losses "
          + ", ".join(f"{k} {v[0]:.6f}" for k, v in runs.items()))
    (lk, gk_), (lp, gp), (_, gf) = runs.values()
    for a, b, gb in (("kernels", "plain bf16", gp), ("kernels", "plain f32", gf),
                     ("plain bf16", "plain f32", gf)):
        glob, (worst, name) = grad_cosines(runs[a][1], gb)
        print(f"  grads {a} vs {b}: global cosine {glob:.6f}, min per-tensor cosine {worst:.6f} "
              f"({name})")
    glob, _ = grad_cosines(gk_, gp)
    if abs(lk - lp) > 2**-7 * abs(lp) or glob < 0.999:
        raise AssertionError(f"kernel path vs plain bf16: loss {lk} vs {lp}, gradient cosine "
                             f"{glob}")
    del runs, gk_, gp, gf, state
    torch.cuda.empty_cache()

    results = {}
    for fusion, dec_impl in (("concat", "fused"), ("cross_attn", "flash"), ("concat", "xla")):
        tag = f"[{fusion} / dec_attn_impl={dec_impl}]" + (" plain bf16" if dec_impl == "xla" else "")
        cfg = train_config(fusion, dec_impl, no_pil=no_pil)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with tempfile.TemporaryDirectory() as wd:
            t0 = time.perf_counter()
            model, opt, _ = trainer.train(cfg, wd, device)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            got = dict(kernels.LAUNCHES)
            rows = [json.loads(line) for line in open(os.path.join(wd, "metrics.jsonl"))]
        want = expected_train_launches(fusion, dec_impl, TRAIN_STEPS, kernels.LAUNCHES)
        losses = [r["training_loss"] for r in rows]
        print(f"{tag} trainer: {TRAIN_STEPS} steps in {took:.1f} s (build, init, data and "
              f"steps); losses {losses}; launches {got}")
        if got != want:
            raise AssertionError(f"{tag}: launches {got}, expected {want}")
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"{tag}: losses {losses}")
        for k, v in got.items():
            totals[k] += v
        last = rows[-1]
        print(f"{tag} trainer's last step: step_ms {last.get('step_ms')}, img/sec "
              f"{last.get('img/sec')}, host_wait_share {last.get('host_wait_share')}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        update = tstep.make_update_fn(cfg, model, opt)
        step_batch = next(loader)
        ms = cuda_ms(lambda: update(step_batch), iters=2, warmup=1)
        prof = device_profile(lambda: update(step_batch), ms, iters=1)
        print(f"{tag} step b={TRAIN_BATCH}: {ms:.1f} ms (CUDA events)  "
              f"{TRAIN_BATCH / (ms / 1e3):.1f} images/s  peak memory {peak:.2f} GB")
        print(f"{tag} profile of one step: {prof}")
        results[tag] = {"step_ms": ms, "images_per_s": TRAIN_BATCH / (ms / 1e3), "peak_gb": peak}
        del model, opt, update
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# The int8 serving kernels, the int8 encode and the daemon (phases 10, 11)
# ---------------------------------------------------------------------------


# uint8 input against float input through the int8 encode (phase 11): the
# JAX package's f32 bound is 1e-4 (tests/test_quant.py:275); on the card the
# int8 path rounds the normalized pixels to bf16 for its conv, and a pixel
# whose host (f64, then f32) and device (f32) normalization straddle a bf16
# rounding boundary moves by one bf16 step (2**-8 relative) -> 1e-4 * 10.
UINT8_TOL = 1e-3
DAEMON_MAX_BATCH = 48  # not a power of two: the capped bucket is formed and warmed
DAEMON_CLIENTS, DAEMON_LOAD_REQUESTS = 8, 40  # client threads; tensor requests each under load


def int8_cases(fe, fe8, device, gen, b: int, l: int, d: int = 1024, heads: int = 16,
               mlp: int = 4096):
    """Cases of one int8 block's launches (the int8 encode's shapes) and of
    the composed sub-blocks. Weights are quantised from random f32
    ones; the activations the products take are quantised with the plain
    versions, so each case sees the int8 values and scales its kernel sees
    on the path."""
    import torch
    import torch.nn.functional as F

    from openvision_tpu_torch.serving.quant import quant_w

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    m = b * l
    x = rnd(b, l, d).bfloat16()
    ln = [(rnd(d, scale=0.1) + 1, rnd(d, scale=0.1)) for _ in range(2)]
    w = {"qkv": rnd(3 * d, d, scale=d**-0.5), "out": rnd(d, d, scale=d**-0.5),
         "fc1": rnd(mlp, d, scale=d**-0.5), "fc2": rnd(d, mlp, scale=mlp**-0.5)}
    q = {k: quant_w(v) for k, v in w.items()}
    bias = {k: rnd(v.shape[0], scale=0.1) for k, v in w.items()}
    w16 = {k: v.bfloat16() for k, v in w.items()}
    b16 = {k: v.bfloat16() for k, v in bias.items()}
    yq, ys = fe8.layernorm_quant_plain(x, *ln[0], 1e-6)
    o, h = rnd(b, l, d, scale=0.5), rnd(b, l, mlp)
    oq, os_ = fe8.quant_plain(o)
    hq, hs = fe8.quant_plain(h)
    qkv = rnd(b, l, 3 * d).bfloat16()

    def int_mm(a, a_s, name, gelu=False, res=None, out=torch.bfloat16):
        """torch._int_mm and the dequant as torch ops (a yardstick the port never calls)."""
        wq, ws = q[name]

        def run():
            y = torch._int_mm(a.reshape(-1, a.shape[-1]), wq.t()).float()
            y = (y * ws * a_s.reshape(-1, 1) + bias[name]).reshape(*a.shape[:-1], -1)
            if gelu:
                y = F.gelu(y, approximate="tanh")
            y = y.to(out)
            return y if res is None else y + res
        return run

    cases = []
    for i, (lw, lb) in enumerate(ln):
        cases.append(Case("layernorm_quant", f"LN{i + 1} + quantise ({m}x{d})",
                          lambda lw=lw, lb=lb: fe8.layernorm_quant(x, lw, lb, 1e-6),
                          lambda lw=lw, lb=lb: fe8.layernorm_quant_plain(x, lw, lb, 1e-6), None,
                          m * d * 2 + m * d + m * 4 + 2 * d * 4, 0, 10 * m * d, quant=True))
    # fc1 as the path runs it: with the hidden's row max, which must be that
    # of its own output bit for bit
    for label, a, a_s, name, gelu, res, out in (
            ("qkv", yq, ys, "qkv", False, None, torch.bfloat16),
            ("out+res", oq, os_, "out", False, x, torch.bfloat16),
            ("fc1+gelu f32 + row max", yq, ys, "fc1", True, None, torch.float32),
            ("fc2+res", hq, hs, "fc2", False, x, torch.bfloat16)):
        n, k = q[name][0].shape
        cases.append(Case(
            "gemm_int8", f"{label} ({m}x{n}x{k})",
            lambda a=a, a_s=a_s, name=name, gelu=gelu, res=res, out=out: fe8.gemm_int8(
                a, a_s, *q[name], bias[name], gelu=gelu, out_dtype=out, residual=res,
                row_amax=gelu),
            lambda a=a, a_s=a_s, name=name, gelu=gelu, res=res, out=out: fe8.gemm_int8_plain(
                a, a_s, *q[name], bias[name], gelu=gelu, out_dtype=out, residual=res).float(),
            int_mm(a, a_s, name, gelu, res, out),
            m * k + n * k + m * n * (2 if out == torch.bfloat16 else 4)
            + (m * n * 2 if res is not None else 0) + m * 4 + n * 8,
            0, int8_ops=2 * m * n * k, exact=not gelu, row_max=gelu))
    # the GELU hidden as the path quantises it: fc1's output, read once with
    # fc1's row max, bit-equal to the kernel's quantise that reads it for its
    # max (the plain version's scale, amax / 127 on the card, may round
    # otherwise: it is held as every quantise is)
    h, hmax = fe8.gemm_int8(yq, ys, *q["fc1"], bias["fc1"], gelu=True, out_dtype=torch.float32,
                            row_amax=True)
    (q1, s1), (q2, s2) = fe8.quant_rows(h, hmax), fe8.quant_rows(h)
    if not (torch.equal(q1, q2) and torch.equal(s1, s2)):
        raise AssertionError("quant_rows with fc1's row max differs from quant_rows alone")
    print(f"  quant_rows      GELU hidden ({m}x{mlp}): with fc1's row max, bit-equal to its "
          f"quantise alone  ok")
    for label, t, t_max in (("attention output", o, None), ("GELU hidden, fc1's row max", h, hmax)):
        n = t.shape[-1]
        cases.append(Case("quant_rows", f"{label} ({m}x{n})",
                          lambda t=t, t_max=t_max: fe8.quant_rows(t, t_max),
                          lambda t=t: fe8.quant_plain(t), None,
                          m * n * 4 + m * n + m * 4, 0, 3 * m * n, quant=True))
    cases.append(f32_attention_case(fe, qkv, heads))
    mhsa_args = (*ln[0], *q["qkv"], bias["qkv"], *q["out"], bias["out"])
    mlp_args = (*ln[1], *q["fc1"], bias["fc1"], *q["fc2"], bias["fc2"])
    ln16 = [(lw.bfloat16(), lb.bfloat16()) for lw, lb in ln]
    cases.append(Case(
        "int8 mhsa block", f"mhsa_t_int8 b={b} L={l} D={d} H={heads}",
        lambda: fe8.mhsa_t_int8(x, *mhsa_args, num_heads=heads),
        lambda: fe8.mhsa_t_int8_plain(x, *mhsa_args, num_heads=heads).float(),
        lambda: _library_block(x, *ln16[0], w16["qkv"], b16["qkv"], w16["out"], b16["out"],
                               heads, {}),
        2 * m * d * 2 + 4 * d * d + 8 * d * 4, 4 * b * heads * 64 * l * l, residual=x,
        int8_ops=2 * m * 4 * d * d))

    def library_mlp():
        y = F.layer_norm(x, (d,), *ln16[1], 1e-6)
        y = F.gelu(F.linear(y, w16["fc1"], b16["fc1"]), approximate="tanh")
        return x + F.linear(y, w16["fc2"], b16["fc2"])

    cases.append(Case(
        "int8 mlp block", f"mlp_t_int8 b={b} L={l} D={d} MLP={mlp}",
        lambda: fe8.mlp_t_int8(x, *mlp_args),
        lambda: fe8.mlp_t_int8_plain(x, *mlp_args).float(), library_mlp,
        2 * m * d * 2 + 2 * d * mlp + (2 * mlp + 2 * d) * 4, 0, residual=x,
        int8_ops=2 * m * 2 * d * mlp))
    return cases


def time_int8_kernels(fe, fe8, device, batch: int = 64) -> dict:
    """Phase 11b: one int8 block's launches at `batch`, summed per kernel
    (time, graph time, bound, plain version and library yardstick), but
    layernorm_quant's one launch (LN1; LN2 has its shape); the f32 attention
    and the composed sub-blocks are printed beside them."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    keys = ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms", "bound_ms")
    times, largest = {}, {}
    for c in int8_cases(fe, fe8, device, gen, batch, 257):
        t = time_case(c)
        if c.name not in ("gemm_int8", "layernorm_quant", "quant_rows"):
            continue
        if c.name == "layernorm_quant" and c.name in times:
            continue  # one launch: LN2's is LN1's shape
        acc = times.setdefault(c.name, dict.fromkeys(keys, 0.0))
        for key in keys:  # no library call for one launch: none for the kernel
            acc[key] = None if t[key] is None or acc[key] is None else acc[key] + t[key]
        if t["bound_ms"] >= largest.get(c.name, 0.0):
            largest[c.name] = t["bound_ms"]
            acc["bound_by"] = t["bound_by"]
    return times


def int8_encode_phase(model_dir: str, images, totals: dict, device):
    """Phase 11a: the testcat batch through build_encode_fn(int8=True) on
    float and uint8 input. Returns the loaded model (bf16 fused_t tower and
    int8 weights)."""
    import torch

    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.serving.encode import build_encode_fn
    from openvision_tpu_torch.tools.model_io import load_model

    t0 = time.perf_counter()
    model = load_model(model_dir, dtype=torch.bfloat16, attn_impl="fused_t", fast_gelu=True,
                       device=device, int8=True)
    print(f"load_model(bf16, fused_t, int8=True) in {time.perf_counter() - t0:.1f} s")
    depth = len(model.vision.transformer.resblocks)
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for k, v in INT8_LAUNCHES_PER_BLOCK.items():
        want[k] += v * depth
    for k, v in INT8_LAUNCHES_PER_ENCODE.items():
        want[k] += v
    raw = np.stack(images)  # the testcat images are 224 px: the uint8 rows as they are
    pre = np.stack([model.preprocess(im) for im in images]).astype(np.float32)
    n = len(images)
    z = {}
    for which, rows, kw in (("float", pre, {}), ("uint8", raw, {"uint8_input": True})):
        enc = build_encode_fn(model, int8=True, **kw)
        padded = np.pad(rows, ((0, 8 - n), (0, 0), (0, 0), (0, 0)))
        kernels.reset_launch_counts()
        z[which] = enc(torch.from_numpy(padded).to(device))[:n]
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        print(f"int8 encode ({which} input), launches {got}")
        if got != want:
            raise AssertionError(f"int8 encode ({which}): launches {got}, expected {want}")
        for k, v in got.items():
            totals[k] += v
        norms = torch.linalg.norm(z[which], dim=-1)
        if z[which].shape != (n, 768) or not torch.isfinite(z[which]).all():
            raise AssertionError(f"int8 embeddings ({which}) are not finite or misshapen")
        if (norms - 1).abs().max().item() > 1e-3:
            raise AssertionError(f"int8 embeddings ({which}) are not unit-norm")
    cos = {}
    for gelu_name, fast in (("exact GELU", False), ("tanh GELU", True)):
        ref = load_model(model_dir, dtype=torch.float32, attn_impl="xla", fast_gelu=fast,
                         device=device)
        cos[gelu_name] = (z["float"] * ref.encode_image(torch.from_numpy(pre).to(device))).sum(-1)
        print(f"zimg cosine, int8 kernels vs plain f32 xla ({gelu_name}): min "
              f"{cos[gelu_name].min().item():.6f}  per image "
              f"{[round(c, 6) for c in cos[gelu_name].tolist()]}")
        del ref
    diff = (z["uint8"] - z["float"]).abs().max().item()
    print(f"int8 encode, uint8 against float input: max|diff| {diff:.3e} (bound {UINT8_TOL:.0e})")
    if cos["exact GELU"].min().item() < 0.995:
        raise AssertionError("int8 zimg cosine against the f32 plain path is below 0.995")
    if diff > UINT8_TOL:
        raise AssertionError(f"int8 encode: uint8 and float input differ by {diff}")
    return model


def encode_rates(model, model_dir: str, device, batch: int = 64) -> dict:
    """Phase 11b: encode img/s at `batch` (CUDA events around build_encode_fn
    on f32 input on the card) for the int8 kernels, the bf16 fused_t kernels
    and the plain eager bf16 path, in turns."""
    import torch

    from openvision_tpu_torch.serving.encode import build_encode_fn
    from openvision_tpu_torch.tools.model_io import load_model

    plain = load_model(model_dir, dtype=torch.bfloat16, attn_impl="xla", fast_gelu=True,
                       device=device)
    fns = {"int8 kernels": build_encode_fn(model, int8=True),
           "bf16 fused_t kernels": build_encode_fn(model, int8=False),
           "plain eager bf16": build_encode_fn(plain, int8=False)}
    x = torch.randn(batch, RES, RES, 3, generator=torch.Generator(device=device).manual_seed(3),
                    device=device)
    rates = {}
    for which in list(fns) + list(fns)[::-1]:
        ms = cuda_ms(lambda: fns[which](x), iters=10)
        rates.setdefault(which, []).append(batch / (ms / 1e3))
        print(f"  {which:22s} encode b={batch}: {ms:8.2f} ms/batch  {rates[which][-1]:8.1f} img/s")
    del plain, fns
    torch.cuda.empty_cache()
    return rates


def _http(conn, method: str, path: str, body=None, headers=None):
    """(status, reply bytes, seconds) of one request on a kept-alive connection."""
    t0 = time.perf_counter()
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, resp.read(), time.perf_counter() - t0


def _tensor_headers(rows: np.ndarray, raw_reply: bool = False) -> dict:
    h = {"Content-Type": "application/octet-stream", "X-Tensor-Dtype": "uint8",
         "X-Tensor-Shape": ",".join(map(str, rows.shape))}
    if raw_reply:
        h["Accept"] = "application/octet-stream"
    return h


def _run_clients(fn, n: int) -> list:
    """fn(i) on n threads at once; returns their results, raises the first error."""
    import threading

    out, errs = [None] * n, []

    def body(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 -- raised below, in the main thread
            errs.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errs:
        raise errs[0]
    return out


def daemon_phase(model, ckpt: str, images, names, totals: dict, device) -> dict:
    """Phase 11c: the port's server in-process, --int8 and bf16 fused_t (the
    latter with the caption service), driven over HTTP. Returns per server
    its /v1/embed/tensor requests/s and p50/p95 latency under load."""
    import http.client
    import threading

    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.serving import server as srv
    from openvision_tpu_torch.serving.encode import build_encode_fn
    from openvision_tpu_torch.tools import caption as tcap
    from openvision_tpu_torch.tools.zero_shot import TEXTS

    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
        print("Pillow is not installed: the routes that decode PNG bytes (/v1/rank, /v1/caption "
              "with an image) are not driven over HTTP; the caption service is driven through "
              "its batcher with the caption tool's preprocessed rows")
    pngs = []
    for f in names:
        with open(os.path.join(REPO, "testcat", f), "rb") as fh:
            pngs.append(fh.read())
    raw = np.stack(images)
    cap_rows = np.stack([tcap.preprocess(im, RES) for im in images]).astype(np.float32)

    t0 = time.perf_counter()
    services = {"int8": srv.EmbedService(model, int8=True, max_batch=DAEMON_MAX_BATCH),
                "bf16": srv.EmbedService(model, int8=False, max_batch=DAEMON_MAX_BATCH)}
    capsvc = srv.CaptionService(get_config(caption_arg("concat", "fused")), ckpt,
                                max_batch=DAEMON_MAX_BATCH, device=device)
    print(f"services up in {time.perf_counter() - t0:.1f} s (caption: build_captioner of the "
          f"concat checkpoint, bf16, fused)")
    t0 = time.perf_counter()
    buckets = [svc.warmup() for svc in services.values()] + [capsvc.warmup()]
    print(f"warmup of every bucket {buckets[0]} (image f32, image uint8, text; captions) in "
          f"{time.perf_counter() - t0:.1f} s")
    if any(b[-1] != DAEMON_MAX_BATCH for b in buckets):
        raise AssertionError(f"warmup did not run the capped bucket {DAEMON_MAX_BATCH}: {buckets}")
    servers = {"int8": srv.make_server(services["int8"], "127.0.0.1", 0),
               "bf16": srv.make_server(services["bf16"], "127.0.0.1", 0, caption_service=capsvc)}
    for s in servers.values():
        threading.Thread(target=s.serve_forever, daemon=True).start()
    addr = {k: s.server_address for k, s in servers.items()}
    results = {}
    try:
        n = len(images)
        with torch.inference_mode():
            direct = {k: build_encode_fn(model, int8=k == "int8", uint8_input=True)(
                torch.from_numpy(raw).to(device)).cpu().numpy() for k in services}
            ztxt = model.encode_text(model.tokenize(TEXTS)).cpu().numpy()
            # the caption tool's greedy ids for the images as one batch, padded
            # to the bucket the daemon forms for them (the cuBLAS f32
            # projections pick their algorithm by batch size, which can flip
            # a near-tie argmax between batch sizes)
            padded = np.zeros((srv.bucket_size(n, DAEMON_MAX_BATCH),) + cap_rows.shape[1:],
                              np.float32)
            padded[:n] = cap_rows
            ids = capsvc.captioner(torch.from_numpy(padded).to(device))[:n].cpu().tolist()
        want_caps = [capsvc.tok.decode(row) for row in ids]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()  # the daemon's own run starts here

        def client(i):
            j, out = i % len(images), []
            for tag in ("int8", "bf16"):
                conn = http.client.HTTPConnection(*addr[tag], timeout=300)
                for path in ("/healthz", "/stats"):
                    st, body, _ = _http(conn, "GET", path)
                    out.append((tag, path, st, 200, json.loads(body)))
                rows = raw[j:j + 1]
                st, body, _ = _http(conn, "POST", "/v1/embed/tensor", rows.tobytes(),
                                    _tensor_headers(rows))
                out.append((tag, "tensor json", st, 200,
                            ([j], np.asarray(json.loads(body)["embeddings"], np.float32))))
                pair = raw[[j, (j + 1) % len(images)]]
                st, body, _ = _http(conn, "POST", "/v1/embed/tensor", pair.tobytes(),
                                    _tensor_headers(pair, raw_reply=True))
                out.append((tag, "tensor octet-stream", st, 200,
                            ([j, (j + 1) % len(images)],
                             np.frombuffer(body, np.float32).reshape(2, -1))))
                t = [i % len(TEXTS), (i + 1) % len(TEXTS)]
                st, body, _ = _http(conn, "POST", "/v1/embed/text",
                                    json.dumps({"texts": [TEXTS[k] for k in t]}),
                                    {"Content-Type": "application/json"})
                out.append((tag, "text", st, 200,
                            (t, np.asarray(json.loads(body)["embeddings"], np.float32))))
                if have_pil:
                    st, body, _ = _http(conn, "POST", "/v1/rank", json.dumps(
                        {"b64": base64.b64encode(pngs[j]).decode(),
                         "texts": TEXTS}), {"Content-Type": "application/json"})
                    out.append((tag, "rank", st, 200, json.loads(body)))
                if tag == "bf16" and have_pil:
                    st, body, _ = _http(conn, "POST", "/v1/caption", pngs[j],
                                        {"Content-Type": "image/png"})
                    out.append((tag, "caption", st, 200, (j, json.loads(body)["captions"])))
                if tag == "int8":  # no caption model: 503, then the same connection serves on
                    st, body, _ = _http(conn, "POST", "/v1/caption", pngs[j],
                                        {"Content-Type": "image/png"})
                    out.append((tag, "caption (none loaded)", st, 503, json.loads(body)))
                    st, body, _ = _http(conn, "GET", "/healthz")
                    out.append((tag, "healthz after the 503", st, 200, json.loads(body)))
                conn.close()
            if not have_pil:
                out.append(("bf16", "caption (batcher)", 200, 200,
                            (j, [capsvc.batcher.submit(cap_rows[j]).result(timeout=300)])))
            return out

        t0 = time.perf_counter()
        replies = [r for rs in _run_clients(client, DAEMON_CLIENTS) for r in rs]
        print(f"{DAEMON_CLIENTS} clients, {len(replies)} requests on every route in "
              f"{time.perf_counter() - t0:.2f} s")
        worst_cos, worst_diff, counts, caps_equal = 1.0, 0.0, {}, 0
        for tag, route, st, want_st, out in replies:
            counts[(tag, route)] = counts.get((tag, route), 0) + 1
            if st != want_st:
                raise AssertionError(f"[{tag}] {route}: status {st}, expected {want_st}: {out}")
            if route.startswith("tensor") or route == "text":
                rows, z = out
                ref = (direct[tag] if route != "text" else ztxt)[rows]
                cos = (z * ref).sum(-1) / (np.linalg.norm(z, axis=-1) * np.linalg.norm(ref, axis=-1))
                worst_cos = min(worst_cos, float(cos.min()))
                worst_diff = max(worst_diff, float(np.abs(z - ref).max()))
            elif route == "rank":
                if abs(sum(out["probs"]) - 1) > 1e-4 or sorted(out["texts"]) != sorted(TEXTS):
                    raise AssertionError(f"[{tag}] rank: {out}")
            elif route.startswith("caption") and st == 200:
                j, caps = out
                caps_equal += caps == [want_caps[j]]
            elif route == "healthz after the 503" and out["status"] != "ok":
                raise AssertionError(f"{route}: {out}")
        print(f"replies per route: { {f'{t} {r}': c for (t, r), c in sorted(counts.items())} }")
        print(f"daemon embeddings against build_encode_fn on the same rows: min cosine "
              f"{worst_cos:.7f}, max|diff| {worst_diff:.3e}")
        if worst_cos < 0.99999:
            raise AssertionError(f"daemon embeddings differ from the direct encode: {worst_cos}")
        print(f"captions under concurrent load equal to the caption tool's: "
              f"{caps_equal} of {DAEMON_CLIENTS} (not gated: the batches "
              f"the load forms differ in size from the tool's)")
        # the images as one batch, as the tool captions them: equal, gated
        old_wait, capsvc.batcher.max_wait = capsvc.batcher.max_wait, 1.0
        try:
            if have_pil:
                conn = http.client.HTTPConnection(*addr["bf16"], timeout=300)
                st, body, _ = _http(conn, "POST", "/v1/caption", json.dumps(
                    {"b64": [base64.b64encode(b).decode() for b in pngs]}),
                    {"Content-Type": "application/json"})
                conn.close()
                caps = json.loads(body)["captions"] if st == 200 else body
            else:
                futs = [capsvc.batcher.submit(r) for r in cap_rows]
                st, caps = 200, [f.result(timeout=300) for f in futs]
        finally:
            capsvc.batcher.max_wait = old_wait
        if st != 200 or caps != want_caps:
            raise AssertionError(f"captions of the {n} images in one request: {st} {caps}, "
                                 f"expected {want_caps}")
        print(f"captions of the {n} images in one request "
              f"({'over HTTP' if have_pil else 'through the batcher'}) equal the caption tool's "
              f"greedy ids; e.g. {names[0]}: {want_caps[0][:60]!r}")

        for tag in ("int8", "bf16"):
            lat, lock = [], threading.Lock()

            def load(i, tag=tag, lat=lat, lock=lock):
                conn = http.client.HTTPConnection(*addr[tag], timeout=300)
                for r in range(DAEMON_LOAD_REQUESTS):
                    rows = raw[(i + r) % len(images)][None]
                    st, _, dt = _http(conn, "POST", "/v1/embed/tensor", rows.tobytes(),
                                      _tensor_headers(rows))
                    if st != 200:
                        raise AssertionError(f"[{tag}] /v1/embed/tensor under load: {st}")
                    with lock:
                        lat.append(dt)
                conn.close()

            before = services[tag].images.stats()
            t0 = time.perf_counter()
            _run_clients(load, DAEMON_CLIENTS)
            wall = time.perf_counter() - t0
            st = services[tag].images.stats()
            lat.sort()
            p50, p95 = lat[len(lat) // 2], lat[min(len(lat) - 1, int(0.95 * len(lat)))]
            batches = st["batches"] - before["batches"]
            mean_batch = (st["requests"] - before["requests"]) / max(batches, 1)
            results[tag] = {"requests_per_s": len(lat) / wall, "p50_ms": p50 * 1e3,
                            "p95_ms": p95 * 1e3, "mean_batch": mean_batch}
            print(f"[{tag}] /v1/embed/tensor under load: {len(lat)} requests of one uint8 row "
                  f"from {DAEMON_CLIENTS} threads in {wall:.2f} s: {len(lat) / wall:.1f} "
                  f"requests/s, p50 {p50 * 1e3:.1f} ms, p95 {p95 * 1e3:.1f} ms, {batches} "
                  f"batches (mean {mean_batch:.2f} rows)")
            if mean_batch <= 1:
                raise AssertionError(f"[{tag}] the batcher did not coalesce: {st}")
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        print(f"daemon launches (routes and load): {got}; stats: "
              f"{ {k: s.stats() for k, s in services.items()} } caption {capsvc.stats()}")
        for k, v in got.items():
            totals[k] += v
    finally:
        for s in servers.values():
            s.shutdown()
            s.server_close()
        for svc in (*services.values(), capsvc):
            svc.stop()
    return results


# ---------------------------------------------------------------------------
# Training on fused_t and on LayerScale / drop-path blocks (phases 12-15)
# ---------------------------------------------------------------------------


# Launches of one fused_t block per step under remat=full: both sub-blocks'
# forwards twice (4 + 3 launches each time), the _mhsa_t_bwd_kernel chain
# (12) and the _mlp_t_bwd_kernel chain (8) once.
FUSED_T_BLOCK_STEP = {"layernorm": 6, "gemm_bias_act": 9, "attention": 2, "flash_attention": 1,
                      "gemm_nn": 3, "attention_bwd_dq": 1, "attention_bwd_dkv": 1, "gemm_tn": 4,
                      "layernorm_bwd": 2, "colsum": 4, "mlp_bwd_dual": 1}
# One LayerScale block's attention per step: #7 twice (QKV gemm_bias_act and
# attention) and the #8 chain (7 launches) once; its out-projection and MLP
# are plain PyTorch in training, as XLA in the JAX package.
QKV_BLOCK_STEP = {"gemm_bias_act": 3, "attention": 2, "flash_attention": 1, "attention_bwd_dq": 1,
                  "attention_bwd_dkv": 1, "gemm_tn": 1, "gemm_nn": 1, "colsum": 1}
TXT_BLOCKS = 12
LAYERSCALE_INIT, DROP_PATH = 1e-5, 0.1  # the JAX LayerScale default (models/layers.py:189)


def _block_params(rnd, d: int):
    return (rnd(d, scale=0.1) + 1, rnd(d, scale=0.1), rnd(3 * d, d, scale=d**-0.5).bfloat16(),
            rnd(3 * d, scale=0.1), rnd(d, d, scale=d**-0.5).bfloat16(), rnd(d, scale=0.1))


def _mlp_params(rnd, d: int, hidden: int):
    return (rnd(d, scale=0.1) + 1, rnd(d, scale=0.1), rnd(hidden, d, scale=d**-0.5).bfloat16(),
            rnd(hidden, scale=0.1), rnd(d, hidden, scale=hidden**-0.5).bfloat16(),
            rnd(d, scale=0.1))


def _library_mlp(x, ln_w, ln_b, w1, b1, w2, b2):
    """The MLP sub-block as library calls: F.layer_norm, F.linear + tanh
    F.gelu, F.linear and the residual add."""
    import torch.nn.functional as F

    y = F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, 1e-6)
    return x + F.linear(F.gelu(F.linear(y, w1, b1), approximate="tanh"), w2, b2)


def _library_qkv(y, w_qkv, b_qkv, heads: int, sdpa_kw: dict):
    """#7 as library calls: F.linear (QKV) and scaled_dot_product_attention."""
    import torch.nn.functional as F

    b, l, d = y.shape
    q, k, v = F.linear(y, w_qkv, b_qkv).view(b, l, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    return F.scaled_dot_product_attention(q, k, v, **sdpa_kw).transpose(1, 2).reshape(b, l, d)


def training_kernel_cases(fe, fa, gk, device, gen, b: int):
    """The new training kernels at B=`b`: the #3 chain (image and text
    shapes, nomax off and on), the #4 chain, #7's forward and the #8 chain
    (unmasked image shapes, causal, prefix-LM), and #4's dual kernel alone.
    Each with its bound, its plain twin and its library call(s); the
    forward #7 cases apart (a forward check)."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    fwd, bwd = [], []
    for l, d, heads, nomax in ((257, 1024, 16, False), (257, 1024, 16, True),
                               (80, 768, 12, False), (80, 768, 12, True)):
        if b > 8 and (nomax or d != 1024):
            continue  # the timings run the image tower's shapes, max-subtracted
        x, g = rnd(b, l, d).bfloat16(), rnd(b, l, d).bfloat16()
        w = _block_params(rnd, d)
        kw = dict(num_heads=heads, eps=1e-6, nomax=nomax)
        leaves = _leaves(x, *(t.bfloat16() for t in w))
        with torch.enable_grad():
            out = _library_block(*leaves, heads, {})
        m, pairs = b * l, b * heads * l * l
        bwd.append(Case(
            "mhsa_t bwd", f"#3 b={b} L={l} D={d} H={heads}{' nomax' if nomax else ''}",
            lambda x=x, w=w, g=g, kw=kw: fa._backward_kernels(
                x, *w, g, sm_scale=None, causal=False, prefix_len=0, bias_sum_per_image=False,
                **kw),
            lambda x=x, w=w, g=g, kw=kw: fe.mhsa_block_bwd_plain(x, *w, g, **kw),
            lambda out=out, leaves=leaves, g=g: torch.autograd.grad(out, leaves, g,
                                                                    retain_graph=True),
            (3 * m * d + 4 * d * d + 4 * d * d) * 2 + 12 * d * 4,
            22 * m * d * d + 12 * 64 * pairs, residual=g))
    for l, d in ((257, 1024), (80, 768)):
        if b > 8 and d != 1024:
            continue
        hidden = 4 * d
        x, g = rnd(b, l, d).bfloat16(), rnd(b, l, d).bfloat16()
        w = _mlp_params(rnd, d, hidden)
        leaves = _leaves(x, *(t.bfloat16() for t in w))
        with torch.enable_grad():
            out = _library_mlp(*leaves)
        m = b * l
        bwd.append(Case(
            "mlp_t bwd", f"#4 b={b} L={l} D={d} hidden={hidden}",
            lambda x=x, w=w, g=g: fe._mlp_backward_kernels(x, *w, g, eps=1e-6),
            lambda x=x, w=w, g=g: fe.mlp_block_bwd_plain(x, *w, g),
            lambda out=out, leaves=leaves, g=g: torch.autograd.grad(out, leaves, g,
                                                                    retain_graph=True),
            3 * m * d * 2 + 4 * d * hidden * 2 + 14 * d * 4, 10 * m * d * hidden, residual=g))
        y = rnd(b, l, d).bfloat16()
        w1, b1, w2 = w[2], w[3], w[4]
        bwd.append(Case(
            "mlp_bwd_dual", f"gact, dh = y.W1^T, (g.W2) gelu' ({m}x{d}->{hidden})",
            lambda y=y, w1=w1, b1=b1, g=g, w2=w2: (lambda ga, dh, col: (ga, dh, col.sum(0)))(
                *gk.mlp_bwd_dual(y, w1, b1, g, w2)),
            lambda y=y, w1=w1, b1=b1, g=g, w2=w2: (lambda ga, dh, col: (ga, dh, col.sum(0)))(
                *gk.mlp_bwd_dual_plain(y, w1, b1, g, w2)),
            None,
            2 * m * d * 2 + 2 * d * hidden * 2 + hidden * 4 + 2 * m * hidden * 2
            + 2 * -(-m // 128) * hidden * 4,
            4 * m * d * hidden))
    for l, d, heads, causal, prefix in ((257, 1024, 16, False, 0), (128, 768, 12, True, 0),
                                        (463, 768, 12, True, 335)):
        if b > 8 and causal:
            continue  # path (b) runs the image tower's unmasked shape
        y, g = rnd(b, l, d).bfloat16(), rnd(b, l, d).bfloat16()
        w_qkv, b_qkv = rnd(3 * d, d, scale=d**-0.5).bfloat16(), rnd(3 * d, scale=0.1)
        kw = dict(num_heads=heads, sm_scale=None, causal=causal, prefix_len=prefix)
        sdpa_kw = _sdpa_kwargs(l, l, causal, prefix, device)
        m, pairs = b * l, b * heads * visible_pairs(l, l, causal, prefix)
        mask = f" prefix={prefix}" if prefix else " causal" if causal else ""
        fwd.append(Case(
            "qkv attention", f"#7 b={b} L={l} D={d} H={heads}{mask}",
            lambda y=y, w=w_qkv, bq=b_qkv, kw=kw: fa._qkv_forward_kernels(y, w, bq, **kw),
            lambda y=y, w=w_qkv, bq=b_qkv, kw=kw: fa.fused_qkv_attention_plain(
                y.float(), w.float(), bq, **kw),
            lambda y=y, w=w_qkv, bq=b_qkv.bfloat16(), h=heads, skw=sdpa_kw: _library_qkv(
                y, w, bq, h, skw),
            2 * m * d * 2 + 3 * d * d * 2 + 3 * d * 4, 6 * m * d * d + 4 * 64 * pairs))
        leaves = _leaves(y, w_qkv, b_qkv.bfloat16())
        with torch.enable_grad():
            out = _library_qkv(*leaves, heads, sdpa_kw)
        bwd.append(Case(
            "qkv bwd", f"#8 b={b} L={l} D={d} H={heads}{mask}",
            lambda y=y, w=w_qkv, bq=b_qkv, g=g, kw=kw: fa._qkv_backward_kernels(y, w, bq, g, **kw),
            lambda y=y, w=w_qkv, bq=b_qkv, g=g, kw=kw: fa.fused_qkv_attention_bwd_plain(
                y, w, bq, g, **kw),
            lambda out=out, leaves=leaves, g=g: torch.autograd.grad(out, leaves, g,
                                                                    retain_graph=True),
            3 * m * d * 2 + 6 * d * d * 2 + 6 * d * 4, 18 * m * d * d + 12 * 64 * pairs))
    return fwd, bwd


def time_training_kernels(fe, fa, gk, device) -> dict:
    """Phase 13: each case of :func:`training_kernel_cases` at b=64 with its
    launches per call; returns the dual kernel's times (its JSON row)."""
    import torch

    from openvision_tpu_torch.ops import kernels

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    row = None
    with torch.no_grad():
        fwd, bwd = training_kernel_cases(fe, fa, gk, device, gen, 64)
        for c in fwd + bwd:
            kernels.reset_launch_counts()
            c.kern()
            torch.cuda.synchronize()
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
            t = time_bwd_case(c)
            print(f"  {'':17s} launches per call: {launched}")
            if c.name == "mlp_bwd_dual" and row is None:  # the image tower's shape
                row = t
    return row


def training_config(path: str, dtype: str = "bfloat16", plain: bool = False,
                    no_pil: bool = False) -> dict:
    """Phase 14/15's config: phase 8's model, batch, steps and schedule with
    ``attn_impl=fused_t`` (path a) or ``auto`` with LayerScale and drop-path
    on the image tower (path b); `plain` runs every tower on xla."""
    c = train_config("concat", "xla" if plain else "fused", dtype, no_pil=no_pil)
    if not plain and path == "a":
        for tower in ("image", "text"):
            c["model"][tower]["attn_impl"] = "fused_t"  # the config's attn_impl=fused_t
    if path == "b":
        c["model"]["image"]["init_values"] = LAYERSCALE_INIT
        c["model"]["image"]["drop_path"] = DROP_PATH
    return c


def expected_path_launches(path: str, steps: int, names) -> dict:
    """Launches of `steps` training steps of path (a) or (b): the fused_t
    chains in the 24 image and 12 text blocks, or #7/#8 in the 24 image
    blocks; the concat decoder's 12 fused blocks either way."""
    want = dict.fromkeys(names, 0)
    per = ((FUSED_T_BLOCK_STEP, IMG_BLOCKS + TXT_BLOCKS) if path == "a"
           else (QKV_BLOCK_STEP, IMG_BLOCKS))
    for table, n in (per, (FUSED_BLOCK_STEP, DEC_BLOCKS)):
        for k, v in table.items():
            want[k] += v * n * steps
    return want


def training_path_phase(path: str, device, no_pil: bool, totals: dict) -> dict:
    """Phases 14 and 15: on identical params, batch and drop-path generator
    the kernel path's loss and gradients against the plain bf16 path (loss
    within 2**-7 relative, global gradient cosine >= 0.999); then
    train/trainer.py's TRAIN_STEPS steps with exact launch counts, the step
    time by CUDA events, images/s, peak memory and the profiler's
    busy/event ratio of one step. Path (b) then loads the trained weights
    into an inference model and encodes one batch on #7's forward alone,
    against the plain f32 path (cosine >= 0.999)."""
    import torch

    from openvision_tpu_torch.data import pipeline
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.train import step as tstep
    from openvision_tpu_torch.train import trainer

    tag = {"a": "[a: attn_impl=fused_t]",
           "b": f"[b: LayerScale {LAYERSCALE_INIT}, drop_path {DROP_PATH}]"}[path]
    cfg_k = training_config(path, no_pil=no_pil)
    loader, _ = pipeline.training(cfg_k["input"], seed=SEED)
    batch = next(loader)
    model = tstep.build_model(cfg_k).to(device)
    init_params(model, SEED)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model

    def grads_for(cfg):
        m = tstep.build_model(cfg).to(device)
        m.load_state_dict(state)
        kernels.reset_launch_counts()
        loss, _ = tstep.make_loss_fn(cfg, m)(tstep.to_device(batch, device),
                                             rng=tstep.step_generator(SEED, 0))
        loss.backward()
        launched = sum(kernels.LAUNCHES.values())
        return loss.item(), {n: p.grad.detach().float().clone()
                             for n, p in m.named_parameters()}, launched

    t0 = time.perf_counter()
    (lk, gk_, nk), (lp, gp, npl) = grads_for(cfg_k), grads_for(training_config(path, plain=True,
                                                                                no_pil=no_pil))
    del state
    glob, (worst, name) = grad_cosines(gk_, gp)
    print(f"{tag} first step on identical params, batch and drop-path generator "
          f"({time.perf_counter() - t0:.1f} s): loss kernels {lk:.6f} plain bf16 {lp:.6f} "
          f"(rel {abs(lk - lp) / abs(lp):.3e}, bound {2**-7:.3e}); gradient cosine {glob:.6f}, "
          f"min per-tensor {worst:.6f} ({name}); launches {nk} kernels / {npl} plain")
    if abs(lk - lp) > 2**-7 * abs(lp) or glob < 0.999 or npl != 0 or nk == 0:
        raise AssertionError(f"{tag}: loss {lk} vs {lp}, gradient cosine {glob}")
    del gk_, gp
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        model, opt, _ = trainer.train(cfg_k, wd, device)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
        rows = [json.loads(line) for line in open(os.path.join(wd, "metrics.jsonl"))]
    want = expected_path_launches(path, TRAIN_STEPS, kernels.LAUNCHES)
    losses = [r["training_loss"] for r in rows]
    print(f"{tag} trainer: {TRAIN_STEPS} steps in {took:.1f} s (build, init, data and steps); "
          f"losses {losses}; launches {got}")
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    for k, v in got.items():
        totals[k] += v
    peak = torch.cuda.max_memory_allocated() / 1e9
    update = tstep.make_update_fn(cfg_k, model, opt)
    step_batch = next(loader)
    ms = cuda_ms(lambda: update(step_batch), iters=2, warmup=1)
    prof = device_profile(lambda: update(step_batch), ms, iters=1)
    print(f"{tag} step b={TRAIN_BATCH}: {ms:.1f} ms (CUDA events)  "
          f"{TRAIN_BATCH / (ms / 1e3):.1f} images/s  peak memory {peak:.2f} GB")
    print(f"{tag} profile of one step: {prof}")
    result = {"step_ms": ms, "images_per_s": TRAIN_BATCH / (ms / 1e3), "peak_gb": peak,
              "loss_rel": abs(lk - lp) / abs(lp), "grad_cosine": glob}
    if path == "b":
        trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model, opt, update
        torch.cuda.empty_cache()
        result["encode_cosine"] = layerscale_encode(trained, step_batch, device, no_pil, totals)
    return result


def layerscale_encode(trained: dict, batch: dict, device, no_pil: bool, totals: dict) -> float:
    """Path (b)'s trained weights loaded into an inference model: one batch
    through the image tower on #7's forward (24 blocks, no backward kernel)
    against the plain f32 path; returns the minimum per-image cosine."""
    import torch

    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.train import step as tstep

    images = tstep.normalize_uint8(torch.as_tensor(np.asarray(batch["image"])).to(device))
    zs = {}
    for which, cfg in (("kernels", training_config("b", no_pil=no_pil)),
                       ("plain f32", training_config("b", "float32", plain=True,
                                                     no_pil=no_pil))):
        m = tstep.build_model(cfg).to(device)
        m.load_state_dict(trained)
        m.eval()
        kernels.reset_launch_counts()
        with torch.inference_mode():
            z, _ = m.visual(images)
            zs[which] = torch.nn.functional.normalize(z.float(), dim=-1)
        torch.cuda.synchronize()
        if which == "kernels":
            got = dict(kernels.LAUNCHES)
            want = {**dict.fromkeys(kernels.LAUNCHES, 0), "gemm_bias_act": IMG_BLOCKS,
                    "attention": IMG_BLOCKS}
            print(f"[b] inference encode of {images.shape[0]} images: launches {got}")
            if got != want:
                raise AssertionError(f"[b] encode launches {got}, expected {want}")
            for k, v in got.items():
                totals[k] += v
        del m
    cos = (zs["kernels"] * zs["plain f32"]).sum(-1)
    print(f"[b] encode zimg cosine, kernels bf16 vs plain f32: min {cos.min().item():.6f}")
    if not bool(torch.isfinite(zs["kernels"]).all()) or cos.min().item() < 0.999:
        raise AssertionError(f"[b] encode does not match the plain path: {cos.min().item()}")
    return cos.min().item()


# ---------------------------------------------------------------------------
# Tensor parallelism: #11, #12 and training on a mesh (phases 16, 17, 18)
# ---------------------------------------------------------------------------


# One tensor-parallel block per training step under remat=full: #11's four
# launches twice (the forward, then the recompute before its backward) and
# #12's eleven (#10's chain without db_o's column sum).
TP_BLOCK_STEP = {**FUSED_BLOCK_STEP, "colsum": 1}
TP_PARTIAL_LAUNCHES = {"layernorm": 1, "gemm_bias_act": 2, "attention": 1}
TP_PARTIAL_BWD_LAUNCHES = {"layernorm": 1, "gemm_bias_act": 1, "flash_attention": 1,
                           "gemm_nn": 2, "attention_bwd_dq": 1, "attention_bwd_dkv": 1,
                           "gemm_tn": 2, "layernorm_bwd": 1, "colsum": 1}
TP_SIZE = 2  # phase 18's tensor axis: two ranks share the one card
TP_TIMEOUT_S = 420  # each torchrun launch of phase 18


def _library_partial(x, ln_w, ln_b, w_qkv, b_qkv, w_o, heads: int, sdpa_kw: dict):
    """The shard's partial block as library calls: F.layer_norm, F.linear on
    the shard's rows, scaled_dot_product_attention, F.linear (no bias)."""
    import torch.nn.functional as F

    b, l, d = x.shape
    dl = w_qkv.shape[0] // 3
    y = F.layer_norm(x, (d,), ln_w, ln_b, 1e-6)
    q, k, v = F.linear(y, w_qkv, b_qkv).view(b, l, 3, heads, dl // heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, **sdpa_kw)
    return F.linear(o.transpose(1, 2).reshape(b, l, dl), w_o)


def tp_block_cases(fa, device, gen, b: int, shapes):
    """Per (L, D, heads, causal, prefix, t): #11's Case, #12's Case (the
    last shard's weights) and the whole block's inputs for the identity."""
    import torch

    from openvision_tpu_torch.convert.openclip import shard_tensor

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    out = []
    for l, d, heads, causal, prefix, t in shapes:
        x, g = rnd(b, l, d).bfloat16(), rnd(b, l, d).bfloat16()
        whole = (rnd(d, scale=0.1) + 1, rnd(d, scale=0.1), rnd(3 * d, d, scale=d**-0.5).bfloat16(),
                 rnd(3 * d, scale=0.1), rnd(d, d, scale=d**-0.5).bfloat16(), rnd(d, scale=0.1))
        ln_w, ln_b, w_qkv, b_qkv, w_o, _ = whole
        ws, bs, wos = (shard_tensor(v, kind, t - 1, t).contiguous()
                       for v, kind in ((w_qkv, "qkv"), (b_qkv, "qkv"), (w_o, "cols")))
        h, dl, m = heads // t, d // t, b * l
        kw = dict(num_heads=h, sm_scale=0.125, causal=causal, prefix_len=prefix)
        lib_args = (ln_w.bfloat16(), ln_b.bfloat16(), ws, bs.bfloat16(), wos)
        sdpa_kw = _sdpa_kwargs(l, l, causal, prefix, device)
        pairs = b * h * visible_pairs(l, l, causal, prefix)
        tag = (f"b={b} L={l} D={d} H={heads} t={t}"
               + (f" prefix={prefix}" if prefix else " causal" if causal else ""))
        fwd = Case(
            "tp block", f"#11 {tag}",
            lambda x=x, kw=kw, s=(ws, bs, wos), lw=ln_w, lb=ln_b: fa.block_partial(x, lw, lb, *s,
                                                                                 **kw),
            lambda x=x, kw=kw, s=(ws, bs, wos), lw=ln_w, lb=ln_b: fa.block_partial_plain(
                x.float(), lw, lb, s[0].float(), s[1], s[2].float(), **kw),
            lambda x=x, a=lib_args, h=h, skw=sdpa_kw: _library_partial(x, *a, h, skw),
            (2 * m * d + 4 * d * dl) * 2 + (2 * d + 3 * dl) * 4,
            2 * m * d * 3 * dl + 2 * m * dl * d + 4 * 64 * pairs)
        leaves = _leaves(x, *lib_args)
        with torch.enable_grad():
            lib_out = _library_partial(*leaves, h, sdpa_kw)
        bwd = Case(
            "tp block bwd", f"#12 {tag}",
            lambda x=x, g=g, kw=kw, s=(ws, bs, wos), lw=ln_w, lb=ln_b: fa.block_partial_bwd(
                x, lw, lb, *s, g, **kw),
            lambda x=x, g=g, kw=kw, s=(ws, bs, wos), lw=ln_w, lb=ln_b: fa.block_partial_bwd_plain(
                x, lw, lb, *s, g, **kw),
            lambda out=lib_out, leaves=leaves, g=g: torch.autograd.grad(out, leaves, g,
                                                                        retain_graph=True),
            (3 * m * d + 8 * d * dl) * 2 + (4 * d + 6 * dl) * 4,
            3 * 6 * m * d * dl + 2 * 2 * m * d * dl + 6 * 2 * 64 * pairs)
        out.append((fwd, bwd, (x, g, whole, dict(num_heads=heads, causal=causal,
                                                 prefix_len=prefix), t)))
    return out


def check_tp_identity(fa, x, g, whole, kw, t: int) -> None:
    """On the card: the t shards' #11 summed (in bf16, as the all-reduce of
    bf16 partials), then + x + bo, against #9; #12's dx summed, + g, and its
    gradients summed (LayerNorm) or joined (the sharded leaves) against
    #10. Out on out - x within 2**-6 of max|out - x| plus per element two
    bf16 roundings of the residual adds (the TP block rounds x + sum and
    + bo apart); dx on dx - g alike at 2**-5; each gradient at 2**-5 of its
    max|#10|."""
    import torch

    from openvision_tpu_torch.convert.openclip import shard_tensor, unshard_tensor

    ln_w, ln_b, w_qkv, b_qkv, w_o, b_o = whole
    kw_shard = dict(kw, num_heads=kw["num_heads"] // t, sm_scale=0.125)
    shards = [tuple(shard_tensor(v, kind, r, t).contiguous()
                    for v, kind in ((w_qkv, "qkv"), (b_qkv, "qkv"), (w_o, "cols")))
              for r in range(t)]
    parts = [fa.block_partial(x, ln_w, ln_b, *s, **kw_shard) for s in shards]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    out = (x + total) + b_o.bfloat16()
    ref = fa.fused_mhsa_block(x, *whole, **kw)
    grads = [fa.block_partial_bwd(x, ln_w, ln_b, *s, g, **kw_shard) for s in shards]
    want = fa._backward_kernels(x, *whole, g, sm_scale=None, eps=1e-6, **kw)
    torch.cuda.synchronize()
    dx = g
    for gr in grads:
        dx = dx + gr[0]
    checks = [("out", out, ref, x, 2**-6), ("dx", dx, want[0], g, 2**-5)]
    for label, a, r, base, tol in checks:
        a, r, base = a.float(), r.float(), base.float()
        scale = (r - base).abs().max().item()
        ratio = ((a - r).abs() / (tol * scale + 2 * RESIDUAL_ROUNDING * r.abs())).max().item()
        err = (a - r).abs().max().item()
        print(f"  tp identity t={t} L={x.shape[1]} {label:6s} max|err|={err:.3e}  "
              f"err/bound<={ratio:.3f}  {'ok' if ratio <= 1 else 'FAIL'}")
        if ratio > 1 or not torch.isfinite(a).all():
            raise AssertionError(f"tp identity {label}: err/bound {ratio}")
    joined = [sum(gr[1] for gr in grads), sum(gr[2] for gr in grads)]
    joined += [unshard_tensor([gr[i].float() for gr in grads], kind)
               for i, kind in ((3, "qkv"), (4, "qkv"), (5, "cols"))]
    for label, a, r in zip(("dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_o"), joined, want[1:6]):
        rel = ((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
        print(f"  tp identity t={t} L={x.shape[1]} {label:6s} max|err|/max|#10| = {rel:.3e}  "
              f"bound {2**-5:.3e}  {'ok' if rel <= 2**-5 else 'FAIL'}")
        if rel > 2**-5:
            raise AssertionError(f"tp identity {label}: {rel}")


def count_launches(fn) -> dict:
    """The kernel launches of one call of fn (nonzero counts)."""
    from openvision_tpu_torch.ops import kernels

    before = dict(kernels.LAUNCHES)
    fn()
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}


def time_tp_kernels(fa, device) -> dict:
    """Phase 17: #11 and #12 at b=64, L=257, D=1024, 16 heads, tensor 2 and
    4; returns {label: times}."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    rows = {}
    for t in (2, 4):
        fwd, bwd, _ = tp_block_cases(fa, device, gen, 64, [(257, 1024, 16, False, 0, t)])[0]
        for c, want, timer in ((fwd, TP_PARTIAL_LAUNCHES, time_case),
                               (bwd, TP_PARTIAL_BWD_LAUNCHES, time_bwd_case)):
            got = count_launches(c.kern)
            print(f"  {c.label}: launches per call {got}")
            if got != want:
                raise AssertionError(f"{c.label}: launches {got}, expected {want}")
            rows[c.label] = {**timer(c), "launches_per_call": sum(got.values())}
        del fwd, bwd
        torch.cuda.empty_cache()
    return rows


def tp_train_overrides(no_pil: bool) -> list:
    """main_clip's arguments for phase 8's config (train_config) with the
    mesh's tensor axis at TP_SIZE and a checkpoint at the last step."""
    c = train_config("concat", "fused", no_pil=no_pil)
    arg = (f"{TRAIN_ARG},dtype=bfloat16,dec_fusion=concat,dec_attn_impl=fused,"
           f"tensor_parallelism={TP_SIZE}")
    args = ["--config", f"openvision_tpu_torch/configs/openvision.py:{arg}"]
    for key, value in (("input.batch_size", TRAIN_BATCH), ("input.data.num_examples", 1024),
                       ("input.data.res", RES), ("total_steps", TRAIN_STEPS),
                       ("log_training_steps", 1), ("schedule.0.1.warmup_steps", 1),
                       ("model.image.fast_gelu", True), ("input.pp", c["input"]["pp"])):
        args += ["--override", f"{key}={value}"]
    return args


def torchrun(args, log_path: str) -> None:
    """python -m torch.distributed.run --nproc_per_node TP_SIZE `args`, in a
    session of its own (every process it starts ends with it, or is killed
    at TP_TIMEOUT_S); raises unless every rank exits 0."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(TP_SIZE),
           "--master_port", str(port), *args]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=TP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    text = open(log_path).read()
    if rc != 0:
        print(text[-8000:])
        raise AssertionError(f"torchrun {' '.join(args[:2])}: exit {rc}")
    return text


def tp_grads_worker(out_dir: str, no_pil: bool) -> int:
    """One rank of phase 18's first launch (``chip_smoke.py --tp-grads``):
    phase 8's model on a tensor-2 mesh, the loss and gradients of the first
    batch (process 0 writes them gathered whole), then each rank's step
    time, peak memory and the collectives' share of one step."""
    import torch

    sys.path.insert(0, REPO)
    from openvision_tpu_torch import parallel
    from openvision_tpu_torch.data import pipeline
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.parallel import mesh as mesh_mod
    from openvision_tpu_torch.train import checkpoint as ckpt
    from openvision_tpu_torch.train import step as tstep

    device = parallel.maybe_distributed_init("cuda")
    mesh = parallel.create_mesh(data=1, fsdp=1, tensor=TP_SIZE, device_type="cuda")
    rank = parallel.rank()
    cfg = train_config("concat", "fused", no_pil=no_pil)
    with parallel.use_mesh(mesh):
        model = tstep.build_model(cfg).to(device)
        opt = tstep.init_train_state(cfg, model, total_steps=TRAIN_STEPS, mesh=mesh)
        loader, _ = pipeline.training(cfg["input"], seed=SEED,
                                      rows=mesh.batch_rows(TRAIN_BATCH))
        batch = tstep.to_device(next(loader), device)
        kernels.reset_launch_counts()
        meas, grads = tstep.make_grad_fn(cfg, model, opt)(batch)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        whole = ckpt.gather_leaves(grads, model, opt)
        if rank == 0:
            torch.save({"loss": float(meas["training_loss"]), "grads": whole},
                       os.path.join(out_dir, "tp_grads.pt"))
        del grads, whole
        update = tstep.make_update_fn(cfg, model, opt)
        step_batch = next(loader)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: update(step_batch), iters=1, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        mesh_mod.COMM.update(timing=True, seconds=0.0, calls=0)
        t0 = time.perf_counter()
        update(step_batch)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3
        mesh_mod.COMM["timing"] = False
    with open(os.path.join(out_dir, f"tp_rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "step_ms": ms, "peak_gb": peak, "timed_step_ms": timed_ms,
                   "comm_ms": mesh_mod.COMM["seconds"] * 1e3, "comm_calls": mesh_mod.COMM["calls"],
                   "launches": launches}, f)
    parallel.sync("done")
    torch.distributed.destroy_process_group()
    return 0


def tp_train_phase(device, work: str, no_pil: bool, cap_batch, totals: dict) -> dict:
    """Phase 18 (see the module doc). Returns the step times and memory."""
    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.data import pipeline
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.tools.caption import build_captioner
    from openvision_tpu_torch.train import step as tstep

    # the one-process kernel path on the params and batch the ranks see
    cfg = train_config("concat", "fused", no_pil=no_pil)
    loader, _ = pipeline.training(cfg["input"], seed=SEED)
    model = init_params(tstep.build_model(cfg).to(device), SEED)
    loss, _ = tstep.make_loss_fn(cfg, model)(tstep.to_device(next(loader), device))
    loss.backward()
    ref_loss = loss.item()
    ref = {n: p.grad.detach().float() for n, p in model.named_parameters()}
    del model, loss
    torch.cuda.empty_cache()

    out_dir = os.path.join(work, "tp")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    torchrun([os.path.abspath(__file__), "--tp-grads", out_dir]
             + (["--no-pil"] if no_pil else []), os.path.join(out_dir, "grads.log"))
    print(f"[tensor={TP_SIZE}] --tp-grads ranks done in {time.perf_counter() - t0:.1f} s")
    got = torch.load(os.path.join(out_dir, "tp_grads.pt"))
    tp = {n: g.to(device) for n, g in got["grads"].items()}
    glob, (worst, name) = grad_cosines(tp, ref)
    print(f"[tensor={TP_SIZE}] first-batch loss {got['loss']:.6f} vs one process {ref_loss:.6f} "
          f"(rel {abs(got['loss'] - ref_loss) / abs(ref_loss):.3e}); gradient cosine global "
          f"{glob:.6f}, min per-tensor {worst:.6f} ({name})")
    if abs(got["loss"] - ref_loss) > 2**-7 * abs(ref_loss) or glob < 0.999:
        raise AssertionError(f"tensor parallel vs one process: loss {got['loss']} vs {ref_loss}, "
                             f"gradient cosine {glob}")
    del tp, ref, got
    torch.cuda.empty_cache()
    ranks = [json.load(open(os.path.join(out_dir, f"tp_rank{r}.json"))) for r in range(TP_SIZE)]
    blocks = IMG_BLOCKS + DEC_BLOCKS
    grad_want = {k: v * blocks for k, v in TP_BLOCK_STEP.items()}  # fwd, recompute, bwd
    for r in ranks:
        print(f"[tensor={TP_SIZE}] rank {r['rank']}: step {r['step_ms']:.1f} ms (CUDA events; two "
              f"ranks share one card over gloo, so not comparable with phase 8), peak memory "
              f"{r['peak_gb']:.2f} GB, all-reduce {r['comm_ms']:.1f} ms over {r['comm_calls']} "
              f"calls = {100 * r['comm_ms'] / r['timed_step_ms']:.1f}% of a timed step of "
              f"{r['timed_step_ms']:.1f} ms (each collective synchronized); launches of the "
              f"gradient step {r['launches']}")
        if {k: v for k, v in r["launches"].items() if v} != {k: v for k, v in grad_want.items()
                                                            if v}:
            raise AssertionError(f"rank {r['rank']}: launches {r['launches']}, expected "
                                 f"{grad_want}")

    wd = os.path.join(out_dir, "train")
    t0 = time.perf_counter()
    log = torchrun(["-m", "openvision_tpu_torch.main_clip", *tp_train_overrides(no_pil),
                    "--workdir", wd], os.path.join(out_dir, "train.log"))
    took = time.perf_counter() - t0
    print("\n".join(line for line in log.splitlines() if line.startswith("NOTE")))
    rows = [json.loads(line) for line in open(os.path.join(wd, "metrics.jsonl"))]
    losses = [r["training_loss"] for r in rows if "training_loss" in r]
    launches = {k.split("/", 1)[1]: int(v) for k, v in rows[-1].items()
                if k.startswith("launches/")}
    want = {k: v * blocks * TRAIN_STEPS for k, v in TP_BLOCK_STEP.items() if v}
    print(f"[tensor={TP_SIZE}] main_clip: {TRAIN_STEPS} steps in {took:.1f} s (start-up, build, "
          f"init, data, steps, checkpoint); losses {losses}; process 0's launches {launches}; "
          f"last step_ms {rows[-1].get('step_ms')}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"tensor parallel training: losses {losses}")
    if launches != want:
        raise AssertionError(f"tensor parallel training: launches {launches}, expected {want}")
    for k, v in launches.items():
        totals[k] += v

    ckpts = sorted(os.listdir(os.path.join(wd, "checkpoints")))
    if ckpts != [f"ckpt-{TRAIN_STEPS}.npz"]:
        raise AssertionError(f"tensor parallel training wrote {ckpts}")
    with torch.inference_mode():
        cap, tok = build_captioner(get_config(caption_arg("concat", "fused")),
                                   os.path.join(wd, "checkpoints", ckpts[0]), device=device)
        ids = cap(cap_batch)
        logits = cap.logits(cap_batch)
    if (tuple(ids.shape) != (len(cap_batch), QUERIES) or not torch.isfinite(logits).all()
            or int(ids.min()) < 0 or int(ids.max()) >= VOCAB):
        raise AssertionError(f"captions from the tensor-parallel checkpoint: {tuple(ids.shape)}")
    print(f"[tensor={TP_SIZE}] the checkpoint captions in one process: "
          f"{tok.decode(ids[0].tolist())[:70]!r}")
    del cap
    torch.cuda.empty_cache()
    return {f"[tensor={TP_SIZE}] rank {r['rank']}": {
        "step_ms": r["step_ms"], "images_per_s": TRAIN_BATCH / (r["step_ms"] / 1e3),
        "peak_gb": r["peak_gb"]} for r in ranks}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    # phase 3's export and phase 5's checkpoints are read again in phase 11
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(work: str) -> int:
    import torch

    sys.path.insert(0, REPO)
    from openvision_tpu_torch.ops import flash_attention as fl
    from openvision_tpu_torch.ops import fused_attention as fa
    from openvision_tpu_torch.ops import fused_encoder as fe
    from openvision_tpu_torch.ops import fused_encoder_int8 as fe8
    from openvision_tpu_torch.ops import grad_kernels as gk
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.serving.encode import build_encode_fn
    from openvision_tpu_torch.tools import caption as tcap
    from openvision_tpu_torch.tools import zero_shot
    from openvision_tpu_torch.tools.model_io import load_model

    t_start = time.perf_counter()
    device = torch.device("cuda")
    # f32 references in full f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1. versions, card, kernel build")
    smi = smi_line()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.lib()
    print(f"built {os.path.relpath(lib_path, REPO)} with {kernels.nvcc()} "
          f"in {time.perf_counter() - t0:.1f} s")
    spill_gate(lib_path)

    worst = {}
    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    with torch.inference_mode():
        phase("2. kernels against their plain versions (bf16 in, plain in f32)")
        gen = torch.Generator(device=device).manual_seed(SEED)
        for b, l in ((8, 257), (3, 101)):
            check_cases(kernel_cases(fe, device, gen, b, l), worst)

        phase("2b. masked attention and flash kernels at the caption shapes (B=8)")
        check_cases(caption_attention_cases(fe, fl, device, gen, 8) + block_cases(fa, device, gen, 8),
                    worst)

        phase("2c. the Hopper GEMM family: layouts and epilogues, the main path's products")
        gemm_phase(fe, gk, fe8, device, worst)

        phase("3. zero-shot path: ViT-L/14-224 + text-L, random weights (seed 0)")
        names = sorted(f for f in os.listdir(os.path.join(REPO, "testcat")) if f.endswith(".png"))
        images = [read_png(os.path.join(REPO, "testcat", f)) for f in names]
        print(f"decoded {len(images)} testcat images {images[0].shape} {images[0].dtype}")
        model_dir = os.path.join(work, "model")
        os.makedirs(model_dir)
        t0 = time.perf_counter()
        export_random_model(model_dir, L14_CONFIG, SEED)
        print(f"wrote random-init export in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        model = load_model(model_dir, dtype=torch.bfloat16, attn_impl="fused_t",
                           fast_gelu=True, device=device)
        print(f"load_model(bf16, fused_t, fast_gelu) in {time.perf_counter() - t0:.1f} s")
        depth = len(model.vision.transformer.resblocks)
        per_encode = {k: v * depth for k, v in LAUNCHES_PER_BLOCK.items()}

        encode = build_encode_fn(model, int8=False)
        batch = np.stack([model.preprocess(im) for im in images]).astype(np.float32)
        padded = np.pad(batch, ((0, 8 - len(batch)), (0, 0), (0, 0), (0, 0)))

        kernels.reset_launch_counts()
        z = encode(torch.from_numpy(padded).to(device, torch.bfloat16))[:len(images)]
        torch.cuda.synchronize()
        after_encode = dict(kernels.LAUNCHES)
        results = zero_shot.rank(model, names, images)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        for k, v in launches.items():
            totals[k] += v
        print(f"\nlaunches after one batch encode: {after_encode} (expected {per_encode})")
        print(f"launches after the zero-shot ranking ({len(images)} single-image encodes): "
              f"{launches}")
        if after_encode != per_encode:
            raise AssertionError("the encode did not launch each kernel the expected times")
        if launches != {k: v * (1 + len(images)) for k, v in per_encode.items()}:
            raise AssertionError("the ranking did not run every encode through the kernels")

        norms = torch.linalg.norm(z, dim=-1)
        print(f"zimg {tuple(z.shape)} finite={bool(torch.isfinite(z).all())} "
              f"norms in [{norms.min().item():.6f}, {norms.max().item():.6f}]")
        if z.shape != (len(images), 768) or not torch.isfinite(z).all():
            raise AssertionError("embeddings are not finite or have the wrong shape")
        if (norms - 1).abs().max().item() > 1e-3:
            raise AssertionError("embeddings are not unit-norm")
        if len(results) != len(images):
            raise AssertionError("zero-shot ranking did not cover every image")

        cos = {}
        for gelu_name, fast in (("exact GELU", False), ("tanh GELU", True)):
            ref = load_model(model_dir, dtype=torch.float32, attn_impl="xla",
                             fast_gelu=fast, device=device)
            z_ref = ref.encode_image(torch.from_numpy(batch).to(device))
            cos[gelu_name] = (z * z_ref).sum(-1)
            print(f"zimg cosine, kernels bf16 vs plain f32 xla ({gelu_name}): "
                  f"min {cos[gelu_name].min().item():.6f}  "
                  f"per image {[round(c, 6) for c in cos[gelu_name].tolist()]}")
            del ref
        if cos["exact GELU"].min().item() < 0.999:
            raise AssertionError("zimg cosine against the f32 plain path is below 0.999")

        phase("4. encode throughput at batch 64 and per-kernel time")
        plain = load_model(model_dir, dtype=torch.bfloat16, attn_impl="xla",
                           fast_gelu=True, device=device)
        flops = vit_l14_flops_per_image()
        x64 = torch.randn(64, 224, 224, 3, generator=torch.Generator(device=device).manual_seed(1),
                          device=device).bfloat16()
        rates = {"kernels": [], "plain": []}
        for which in ("kernels", "plain", "kernels", "plain"):
            tower = model.vision if which == "kernels" else plain.vision
            ms = cuda_ms(lambda: tower(x64), iters=10)
            rates[which].append(64 / (ms / 1e3))
            print(f"  {which:8s} encode b=64: {ms:8.2f} ms/batch  {rates[which][-1]:8.1f} img/s  "
                  f"{rates[which][-1] * flops / 1e12:6.1f} TFLOP/s "
                  f"({100 * rates[which][-1] * flops / BF16_PEAK_FLOPS:.1f}% of 989 bf16 peak)")
        del plain, model
        times = time_kernels(fe, device)

    phase("5. caption path: ViT-L/14-224 + text-L + decoder-L, bf16, random weights (seed 0)")
    cap_batch = np.stack([tcap.preprocess(im, RES) for im in images]).astype(np.float32)
    with torch.inference_mode():
        loaded, ckpts = caption_phase(device, work, cap_batch, names, totals)

        phase("6. caption throughput at batch 64, and the new kernels' time at caption shapes")
        cap_rates = caption_throughput(device, loaded, ckpts)
    del loaded
    torch.cuda.empty_cache()
    with torch.inference_mode():
        gen = torch.Generator(device=device).manual_seed(SEED + 2)
        caption_times = {}
        for c in caption_attention_cases(fe, fl, device, gen, 64):
            caption_times[c.label] = (c.name, time_case(c))
        for c in block_cases(fa, device, gen, 64):
            time_case(c)
    flash_row = next(t for name, t in caption_times.values() if name == "flash_attention")
    times["flash_attention"] = flash_row  # the cross-attention case (first flash case)

    phase("7. backward kernels against their plain versions (B=8)")
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    with torch.no_grad():
        check_bwd_cases(fused_block_bwd_cases(fa, device, gen, 8)
                        + attention_bwd_cases(fl, gk, device, gen, 8,
                                              which=("cross", "causal", "multi-k", "#10 image"))
                        + block_bwd_parts(gk, device, gen, 8), worst)

    phase("8. training at full width: L/14 + text L + decoder L, bf16, batch 64, remat=full")
    try:
        import PIL  # noqa: F401
        no_pil = False
    except ImportError:
        no_pil = True
        print("Pillow is not installed: input.pp drops inception_crop (the synthetic source "
              "is already 224x224); the CPU tests cover the crop")
    train_results = train_phase(device, no_pil, totals)

    phase("9. backward kernels at B=64: CUDA events and graph replay, bound, plain, library")
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    with torch.no_grad():
        for c in fused_block_bwd_cases(fa, device, gen, 64):
            time_bwd_case(c)
        torch.cuda.empty_cache()
        times.update(time_attention_bwd(fl, gk, device, gen))
        torch.cuda.empty_cache()
        keys = ("ms", "graph_ms", "plain_ms", "library_ms", "bound_ms")
        largest = {}
        for c in block_bwd_parts(gk, device, gen, 64):  # one image-tower block's launches
            t = time_bwd_case(c)
            acc = times.setdefault(c.name, {**dict.fromkeys(keys, 0.0), "library_graph_ms": None})
            for key in keys:
                acc[key] += t[key] or 0.0
            if t["bound_ms"] >= largest.get(c.name, 0.0):
                largest[c.name] = t["bound_ms"]
                acc["bound_by"] = t["bound_by"]

    phase("10. int8 serving kernels against their plain versions (B=8, L=257 and L=101)")
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    with torch.inference_mode():
        for b, l in ((8, 257), (8, 101)):
            check_cases(int8_cases(fe, fe8, device, gen, b, l), worst)
    torch.cuda.empty_cache()

    phase("11. int8 encode and the serving daemon: ViT-L/14-224 + text-L, phase 3's export")
    with torch.inference_mode():
        model8 = int8_encode_phase(model_dir, images, totals, device)
        int8_rates = encode_rates(model8, model_dir, device)
        times.update(time_int8_kernels(fe, fe8, device))
    torch.cuda.empty_cache()
    daemon = daemon_phase(model8, ckpts["concat"], images, names, totals, device)
    del model8
    torch.cuda.empty_cache()

    phase("12. training kernels against their plain twins (B=8): #3, #4, #7, #8, dual kernel")
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    with torch.no_grad():
        fwd, bwd = training_kernel_cases(fe, fa, gk, device, gen, 8)
        check_cases(fwd, worst)
        check_bwd_cases(bwd, worst)
    del fwd, bwd
    torch.cuda.empty_cache()

    phase("13. training kernels at B=64: CUDA events and graph replay, bound, plain, library")
    times["mlp_bwd_dual"] = time_training_kernels(fe, fa, gk, device)
    torch.cuda.empty_cache()

    phase("14. training path (a): attn_impl=fused_t, L/14 + text L + decoder L, bf16, batch 64")
    train_results["[a] fused_t"] = training_path_phase("a", device, no_pil, totals)
    torch.cuda.empty_cache()

    phase("15. training path (b): LayerScale + drop-path image tower, attn_impl=auto, batch 64")
    train_results["[b] LayerScale"] = training_path_phase("b", device, no_pil, totals)
    torch.cuda.empty_cache()

    phase("16. tensor-parallel kernels #11/#12 against their plain twins, and #9/#10 (B=8)")
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    shapes = [(257, 1024, 16, False, 0, 2), (257, 1024, 16, False, 0, 4),
              (463, 768, 12, True, 335, 2), (463, 768, 12, True, 335, 4),
              (101, 768, 12, True, 0, 2)]
    with torch.no_grad():
        for fwd, bwd, (x, g, whole, kw, t) in tp_block_cases(fa, device, gen, 8, shapes):
            check_cases([fwd], worst)
            check_bwd_cases([bwd], worst)
            check_tp_identity(fa, x, g, whole, kw, t)
    torch.cuda.empty_cache()

    phase("17. #11/#12 at B=64, L=257, tensor 2 and 4: events, graph replay, bound, plain, library")
    with torch.no_grad():
        time_tp_kernels(fa, device)
    torch.cuda.empty_cache()

    phase(f"18. tensor-parallel training, tensor={TP_SIZE}: torchrun, two ranks on the one card")
    train_results.update(tp_train_phase(device, work, no_pil, cap_batch, totals))

    phase("summary")
    print(f"card: {smi}")
    print(f"encode b=64 img/s: kernels {rates['kernels']}  plain eager bf16 {rates['plain']}")
    for k, v in int8_rates.items():
        print(f"encode b=64 img/s (f32 input, phase 11) {k}: {[round(r, 1) for r in v]}")
    for k, v in daemon.items():
        print(f"daemon [{k}] /v1/embed/tensor: {v['requests_per_s']:.1f} requests/s, p50 "
              f"{v['p50_ms']:.1f} ms, p95 {v['p95_ms']:.1f} ms, mean batch {v['mean_batch']:.2f}")
    for k, v in cap_rates.items():
        print(f"captions/s b=64 {k}: {[round(r, 1) for r in v]}")
    for k, v in train_results.items():
        print(f"train step b={TRAIN_BATCH} {k}: {v['step_ms']:.1f} ms, {v['images_per_s']:.1f} "
              f"images/s, peak {v['peak_gb']:.2f} GB")
    print(f"main-path launches (zero-shot, caption, training, int8 encode and daemon runs): "
          f"{totals}")
    missing = [k for k, v in totals.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels the main path never launched: {missing}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1][0], "serves": KERNEL_INFO[name][1],
         "launches": totals[name],
         "max_abs_err": worst[name], "ms": times[name]["ms"],
         "graph_ms": times[name]["graph_ms"],
         "library_graph_ms": times[name]["library_graph_ms"],
         "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"]}
        for name in KERNEL_INFO
    ]}
    print(smi_line())
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def gemm_only(root: str) -> int:
    """``chip_smoke.py --gemm [ROOT]``: phase 2c alone, then encode img/s at
    b=64 (int8, bf16 fused_t, plain eager bf16; phase 11's encode_rates) on
    a random ViT-L/14 export kept under build/, on the package of the
    checkout at ROOT (this one by default), so that two checkouts are timed
    on one card in one call; checks only for this checkout's package."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --gemm: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from openvision_tpu_torch.ops import fused_encoder as fe
    from openvision_tpu_torch.ops import fused_encoder_int8 as fe8
    from openvision_tpu_torch.ops import grad_kernels as gk
    from openvision_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"package {os.path.dirname(kernels.__file__)}")
    print(f"nvidia-smi: {smi_line()}")
    t0 = time.perf_counter()
    kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda")
    with torch.inference_mode():
        gemm_phase(fe, gk, fe8, device, {}, check=root == REPO)
        export_encode_rates(device)
    return 0


def export_encode_rates(device) -> dict:
    """Encode img/s at b=64 (phase 11's encode_rates: int8, bf16 fused_t,
    plain eager bf16) on one random ViT-L/14 export under build/, written at
    first use and shared by the checkouts that one call times."""
    import torch

    from openvision_tpu_torch.tools.model_io import load_model

    model_dir = os.path.join(REPO, "build", "chip_smoke_export")
    if not os.path.exists(os.path.join(model_dir, "open_clip_config.json")):
        os.makedirs(model_dir, exist_ok=True)
        export_random_model(model_dir, L14_CONFIG, SEED)  # the config is written last
    model = load_model(model_dir, dtype=torch.bfloat16, attn_impl="fused_t", fast_gelu=True,
                       device=device, int8=True)
    rates = encode_rates(model, model_dir, device)
    del model
    torch.cuda.empty_cache()
    return rates


def attn_only(root: str) -> int:
    """``chip_smoke.py --attn [ROOT]``: the forward attention kernel's cases
    at b=64 (time_attention_fwd: events, graph replay, bound, SDPA and the
    wrapper's host time a call), then phase 9's flash backward cases at b=64
    (each kernel by CUDA events and graph replay, the pair's sum beside
    SDPA's autograd backward) and #10's chain at L=257, on the package of the
    checkout at ROOT (this one by default), so that two checkouts are timed
    on one card in one call. For this checkout's package it first holds the
    build to phase 1's spill gate, the forward cases at B=8 and the
    backward cases at B=8 to their bounds (phases 2b and 7)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --attn: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from openvision_tpu_torch.ops import flash_attention as fl
    from openvision_tpu_torch.ops import fused_attention as fa
    from openvision_tpu_torch.ops import fused_encoder as fe
    from openvision_tpu_torch.ops import grad_kernels as gk
    from openvision_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"package {os.path.dirname(kernels.__file__)}")
    print(f"nvidia-smi: {smi_line()}")
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda")
    with torch.no_grad():
        if root == REPO:
            spill_gate(lib_path)
            gen = torch.Generator(device=device).manual_seed(SEED + 2)
            check_cases(forward_attention_cases(fe, fl, device, gen, 8), {})
            gen = torch.Generator(device=device).manual_seed(SEED + 3)
            check_bwd_cases(attention_bwd_cases(fl, gk, device, gen, 8)
                            + fused_block_bwd_cases(fa, device, gen, 8, lengths=(257,)), {})
        gen = torch.Generator(device=device).manual_seed(SEED + 2)
        print("forward attention (csrc/attention.cu) at b=64:")
        time_attention_fwd(fe, fl, device, gen)
        torch.cuda.empty_cache()
        gen = torch.Generator(device=device).manual_seed(SEED + 4)
        for c in fused_block_bwd_cases(fa, device, gen, 64, lengths=(257,)):
            time_bwd_case(c)
        torch.cuda.empty_cache()
        time_attention_bwd(fl, gk, device, gen)
    return 0


# The row LayerNorm's shapes at b=64 (--ln): the ViT-L/14 tower (encode and
# caption), the decoder's prefix-LM L=463 and causal L=128; the int8 LN at
# the tower's shape.
LN_SHAPES = [("ViT-L/14 tower", 257, 1024), ("decoder prefix-LM L=463", 463, 768),
             ("decoder causal L=128", 128, 768)]


def ln_cases(fe, fe8, device, gen, b: int):
    """The row-stream LayerNorm kernels (csrc/layernorm.cu) at batch b: the
    bf16 layernorm at LN_SHAPES beside F.layer_norm, and layernorm_quant at
    the tower's shape (no library call computes it)."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    cases = []
    for label, l, d in LN_SHAPES:
        m = b * l
        x, ln_w, ln_b = rnd(m, d).bfloat16(), rnd(d, scale=0.1) + 1, rnd(d, scale=0.1)
        w16, b16 = ln_w.bfloat16(), ln_b.bfloat16()
        cases.append(Case(
            "layernorm", f"{label} ({m}x{d})",
            lambda x=x, w=ln_w, bias=ln_b: fe.layernorm(x, w, bias, 1e-6),
            lambda x=x, w=ln_w, bias=ln_b: fe.layernorm_plain(x.float(), w, bias, 1e-6),
            lambda x=x, w=w16, bias=b16, d=d: F.layer_norm(x, (d,), w, bias, 1e-6),
            2 * m * d * 2 + 2 * d * 4, 0, 8 * m * d))
    _, l, d = LN_SHAPES[0]
    m = b * l
    x, ln_w, ln_b = rnd(m, d).bfloat16(), rnd(d, scale=0.1) + 1, rnd(d, scale=0.1)
    cases.append(Case("layernorm_quant", f"LN + quantise ({m}x{d})",
                      lambda: fe8.layernorm_quant(x, ln_w, ln_b, 1e-6),
                      lambda: fe8.layernorm_quant_plain(x, ln_w, ln_b, 1e-6), None,
                      m * d * 2 + m * d + m * 4 + 2 * d * 4, 0, 10 * m * d, quant=True))
    return cases


def ln_only(root: str) -> int:
    """``chip_smoke.py --ln [ROOT]``: the row LayerNorm kernels of the
    checkout at ROOT (this one by default) at b=64 (ln_cases: CUDA events
    and graph replay, bound, plain, F.layer_norm, the wrapper's host time a
    call), then encode img/s at b=64 on --gemm's export, so that two
    checkouts are timed on one card in one call. It first checks both
    kernels at B=8, and for this checkout applies phase 1's spill gate."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --ln: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from openvision_tpu_torch.ops import fused_encoder as fe
    from openvision_tpu_torch.ops import fused_encoder_int8 as fe8
    from openvision_tpu_torch.ops import kernels

    print(f"package {os.path.dirname(kernels.__file__)}")
    print(f"nvidia-smi: {smi_line()}")
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda")
    with torch.inference_mode():
        if root == REPO:
            spill_gate(lib_path)
        check_cases(ln_cases(fe, fe8, device, torch.Generator(device=device).manual_seed(SEED), 8),
                    {})
        gen = torch.Generator(device=device).manual_seed(SEED + 10)
        print("row LayerNorm kernels (csrc/layernorm.cu) at b=64:")
        for c in ln_cases(fe, fe8, device, gen, 64):
            t = time_case(c)
            t0 = time.perf_counter()
            for _ in range(50):
                c.kern()
            host_us = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
            lib = ("" if c.lib is None else f"kernel / F.layer_norm {t['ms'] / t['library_ms']:.2f}"
                   f" (graph {t['graph_ms'] / t['library_graph_ms']:.2f})  ")
            print(f"  {'':15s} {c.label:46s} {lib}graph / bound "
                  f"{t['graph_ms'] / t['bound_ms']:.2f}  wrapper host {host_us:.1f} us a call")
        export_encode_rates(device)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-grads"]:  # one rank of phase 18 (torchrun starts it)
        sys.exit(tp_grads_worker(sys.argv[2], "--no-pil" in sys.argv))
    if sys.argv[1:2] == ["--gemm"]:
        sys.exit(gemm_only(sys.argv[2] if len(sys.argv) > 2 else REPO))
    if sys.argv[1:2] == ["--attn"]:
        sys.exit(attn_only(sys.argv[2] if len(sys.argv) > 2 else REPO))
    if sys.argv[1:2] == ["--ln"]:
        sys.exit(ln_only(sys.argv[2] if len(sys.argv) > 2 else REPO))
    sys.exit(main())

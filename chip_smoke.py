#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (each prints as it goes; any failure raises and exits non-zero):
1. torch / CUDA versions, the card's name and power limit, and the nvcc
   build of the kernels in openvision_tpu_torch/csrc (timed; one nvcc per
   source, in parallel). Fails if a GEMM kernel (bf16 or int8, one
   mainloop), an int8 quantiser, an attention kernel (the forward's
   instantiations, the two backward kernels), a row-stream LayerNorm
   kernel (bf16 or int8) or the LayerNorm backward (and its finish) spills
   registers, or if the build holds no int8 GEMM, no forward attention
   kernel, not both attention backward kernels or not all three LayerNorm
   kernels (bf16, int8, backward) at every chunk count; prints ptxas's
   notes on serialized wgmma.
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
   layout, F.layer_norm's backward (aten.native_layer_norm_backward), a
   column sum); per flash
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
   Then --data_parallel's mechanism (11d): the bf16 EmbedService and the
   caption service over two replicas of cuda:0 (the card's machine has one
   GPU; each replica its own stream), every bucket floored at 2 and split
   by rows: a burst of the testcat rows against the direct encode (cosine
   >= 0.99999), one caption batch against the caption tool's greedy ids on
   each replica's rows, and 11c's load over HTTP (requests/s, p50/p95)
   beside the one-replica figures.
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
   8's model and config at a sixth of its depth since phase 23 came: 4
   image, 2 text and 2 decoder blocks at the full widths; its params and
   batch), whose loss and
   gathered gradients
   are held against the one-process kernel path (loss within 2**-7
   relative, global cosine >= 0.999), and which prints each rank's step
   time, peak memory and the all-reduce's share of a step; then
   python -m torch.distributed.run --nproc_per_node 2 -m
   openvision_tpu_torch.main_clip with sharding.mesh tensor=2 trains 3
   steps: finite losses, every TP block's #11/#12 launches as the block
   counts give (4 image + 2 decoder blocks, the forward twice under
   remat), one checkpoint (an Orbax step directory; its save's GB/s from
   the trainer's note), which the caption tool loads in one process and
   captions the testcat images with. The vocab axis is over tensor (the
   token embedding and the decoder head by vocab rows, the towers' heads by
   output features): each rank's peak memory is printed beside the one
   measured when those leaves were whole on each rank. A failure in any rank fails
   the phase.
19. Evaluation at full width on phase 3's export: 1000 PNGs of 224 x 288
   (testcat images in a wider canvas, each at another offset), one class
   directory each, turned into TFRecord shards by data/prepare.py, and an
   npz of the same pixels with 5 captions an image. The disclf evaluator
   (the config's eval section: IN-1K names x 81 clip_paper prompts, batch
   256, so the last batch holds 232 real rows, device_norm vgg) in bf16
   fused_t, in int8 with static scales calibrated on 64 images and in int8
   with dynamic scales; the retrieval evaluator over the 5000 captions;
   then main_clip eval_only on a port state npz of the same weights.
   Checks: ntotal == 1000, the accuracy from the counts equals the one
   from return_preds, exact launch counts (#1 and #2 24 times an image
   batch; the int8 kernels per block and per encode, the calibration's two
   32-image encodes included), zimg and class-embedding cosine >= 0.999
   against the f32 xla path (int8 zimg >= 0.995), every Recall@k hit equal
   to the f32 path's where its top-k margin exceeds 1e-3, and eval_only's
   accuracy and recalls equal to the evaluators'. Prints eval images/s,
   the host share of the image loop (decode + pp, the copy; PNG decode
   alone), the class embeddings' host tokenisation and device seconds,
   and Recall@k.
20. The interpretability tools at full width: gradient_ascent.main on phase
   3's L/14 export (catcat.png, batch 8, all 340 iterations,
   --deterministic, in a temp working directory), feature_viz.main on a
   new random ViT-S/8-224 export (S8_CONFIG, seed 1; --layer 6 --feature
   5, all 400 steps), neuron_capture.main (all 24 layers, --topk 3) and
   adversarial.main on catbat.png (untargeted PGD, targeted towards "a
   dog", --unsigned, each with --out), every CLI at its defaults (f32 xla)
   with the loads shared. Then feature viz step 0, one PGD input gradient,
   the GELU capture, the image embedding and one gradient-ascent step on
   the same inputs through load_model(bf16, attn_impl="fused") (#9, and
   #10 under an input gradient), plain xla bf16 and f32. Checks: finite
   losses; gradient ascent's best loss below its first, a non-empty tokens
   file, txtembeds (8, 768) f32 on the CPU; feature viz's last loss below
   step 0's, its PNG (224, 224, 3); 24 captured layers of (257, 4096);
   PGD within eps (+1e-6) and [0, 1], the untargeted signed attack's loss
   not below the clean one, the targeted one's p(target) not below the
   clean one; fused against plain bf16 cosine >= 0.999 for both input
   gradients, every layer's capture and the image embedding (against f32
   printed); launches per step: 12 #9 and 7 #10 for feature viz (blocks
   0-6 only: its loss reads block 6), 24 and 24 for a PGD gradient, 24
   and 0 for the capture and for a gradient-ascent step; the capture on
   fused_t raises GeluCaptureError. Prints seconds an iteration of each
   tool on each route (the profiler's device busy share on fused and f32), #10's chain at the tools' shapes beside the
   weight- and bias-gradient launches that frozen weights do not need, and
   the phase's seconds.
21. Webdataset pretraining and the resolution curriculum (BASELINE.json
   configs 4 and 5) through main_clip's main in this process (since phase
   23 came; a subprocess each before): ViT-B/16 + text B + decoder L (the JAX default config:
   coca, concat, image tower and decoder on fused, text tower on xla,
   remat=full) at the full widths and a third of the depth since phase 23
   came (4 blocks a tower, CUR_DEPTH), bf16 on f32 master weights, on 4
   webdataset tar shards of
   512 records (a 256 x 320 PNG of a testcat image at an offset of its
   own, a .txt caption, a .json with llava_caption) written by the script.
   First the pp's records/s with 0 and 8 worker processes; #9 and #10
   against their plain twins at B=8, D=768, 12 heads, L = 25 (112
   masked), 50, 197, 577 and the concat decoder's prefix-LM L=231 (prefix
   103); GradCache on the card on stage 1's model and a batch of 256
   (grad_accum 4 against 1 with masking off, L=50; the kernel route
   against plain bf16 at grad_accum 4, mask 0.5, on the same draws: loss
   within 2**-7, gradient cosine >= 0.999). Then stage 1 (res 112,
   mask_ratio 0.5, batch 1024, grad_accum 4, 8 input workers, 3 steps, a
   checkpoint), stage 2 (ft_from stage 1 at 224, batch 512, grad_accum 2,
   3 steps: SIGTERM, which the script sends itself once step 1's update is
   done, must leave a checkpoint at step 1 and return; the rerun must
   resume from it and finish),
   stage 3 (ft_from stage 2 at 384, batch 256, grad_accum 4, 2 steps) and
   a load_transform start (a learned-posemb B/16 state written at 224,
   started at 384: posemb 1+196 -> 1+576, 1 step). Checks: finite losses,
   every run's #9/#10 launches as a GradCache step gives them (pass 1: the
   image tower's blocks forward, #9 and the MLP kernels; pass 2: the
   image tower's and decoder's blocks each forward twice and backward
   once; times grad_accum), the checkpoints (Orbax step directories, each
   save's bytes, seconds and GB/s from the trainer's note; the next stage's
   ft_from is the last one's checkpoints directory). Prints each stage's step ms,
   images/s, data-wait share and peak memory (stage 1's last step also
   through the trainer's profiler hook: device busy ms from the trace's
   kernels), and #9/#10 at the slice's shapes (b=256 at L=25, 197 and the decoder's 231; b=64 at L=577) by
   events and graph replay beside bound, plain and library.
   `python3 chip_smoke.py --curriculum` builds the kernels and runs this
   phase alone (~250 s).
22. Checkpoints and the OpenCLIP export at full width: phase 5's concat
   CoCa weights (the JAX param tree of its npz) written as an Orbax train
   state by train/checkpoint.py:save_orbax (params, and an opt subtree of
   the same shapes) and read back by restore_params, every leaf bit-equal;
   bytes, seconds and GB/s of the write, the read and the npz load.
   convert.export on that directory (the sincos2d posemb materialized; the
   parity probe's max |delta| on the card), then the zero-shot path on the
   export (load_model bf16 fused_t: #1/#2, launch counts) against the same
   weights from the npz through load_state_dict into the port's CLIP on
   fused_t: zimg cosine >= 0.99999 and the same ranking. The caption CLI
   (--checkpoint <orbax dir> --step, concat / flash: #14) and the daemon's
   CaptionService(step=) (concat / fused: #9; then its batcher route on one
   burst of the PNGs) give phase 5's greedy ids exactly. Then the committed
   fixtures (tests/fixtures: a JAX-written Orbax state with the
   ocdbt.process_0 merge and a 4-chunk sharded leaf, and a legacy
   blosc/lz4 directory; Orbax's zarr v3 arrays, the numbered OCDBT
   manifest and a two-process save) equal their npz exactly. 22e: the
   committed JAX train state whose opt is the real optim.make chain (frozen
   params, two schedules, an lr multiplier, clipping; after 3 JAX updates)
   restored into the port's optimizer on the card, which applies the
   fixture's next gradients: params, mu and nu against JAX's result (mu
   within one bf16 rounding, 2**-7 of its largest value: JAX's jitted
   update keeps b1 * mu in f32; nu within 1e-6; each param within 2**-7 of
   its update), the count equal. `python3 chip_smoke.py --checkpoints`
   builds the kernels and runs this phase alone, on phase 5's concat
   checkpoint written by the script (~140 s).
23. The recipe on a process mesh (BASELINE.json config 5 at the full
   widths: ViT-L/14 + text L + decoder L, the JAX default CoCa config
   otherwise, learned position embeddings, bf16 on f32 masters; at a third
   of the depth, 8 image, 4 text and 4 decoder blocks, MR_DEPTH), two ranks
   of a data=2 mesh on the one card over gloo (NCCL takes one card a
   process), so its times are not comparable with one process's. One
   torchrun of this script's --mesh-worker mode runs the whole phase in two
   processes (one start-up, as a job that trains, resumes and evaluates in
   turn): (a) one global batch of 128 at 160 with mask 0.5 from phase 21's
   shards, three gradients (coca with GradCache 2 and drop-path 0.1 on the
   image tower, siglip with GradCache 2, coca in the global contrastive
   mode at accum 1), process 0 writing each, and each rank's step ms at 160
   and 224, images/s, peak memory and the collectives' share of a timed
   step; this process computes the same three gradients on the whole batch
   from the same seed: loss within 2**-7 relative, global gradient cosine
   >= 0.999, the smallest per-tensor cosine printed. (b) main_clip's main
   in the same processes: 160 at batch 128, GradCache 2, mask 0.5, 2 steps,
   SIGTERM to rank 1 alone during step 1 (both ranks stop at step 1 and
   write one checkpoint), the rerun resumes to step 2; then a
   load_transform start at 224 from that checkpoint (position embedding 1 +
   121 -> 1 + 256), batch 64, GradCache 2, one step, then disclf bf16,
   disclf int8 with static scales and retrieval on phase 19's fixture (1000
   IN-1K classes x 7 clip_best prompts; 1000 images; 5000 captions).
   Checks: finite losses, process 0's launches of each run as a GradCache
   step gives them; each Orbax save's GB/s (the trainer's note). (c) main_clip eval_only on the mesh from that
   checkpoint, its evaluators recording what they computed: the metrics
   equal the run's evals, each rank's launches exact; then the same
   evaluators in this process on the same checkpoint: class embeddings per
   row cosine >= 0.999, predictions agree on >= 99% of the images, accuracy
   within 0.5 points, retrieval similarities within SIM_TOL, the int8
   static scales equal on both ranks and to this process's; the eval
   seconds on two ranks and on one.
   `python3 chip_smoke.py --mesh-recipe` builds the kernels and runs this
   phase alone (it writes the shards and the fixture itself).
`python3 chip_smoke.py --ln [ROOT]` times the row LayerNorm kernels of the
checkout at ROOT (csrc/layernorm.cu: the bf16 layernorm at b=64 over the
ViT-L/14 tower's 16448 x 1024, the decoder's prefix-LM 29632 x 768 and
causal 8192 x 768, beside F.layer_norm; layernorm_quant at 16448 x 1024)
by CUDA events and graph replay, beside the bytes bound, the plain version
and the wrapper's host time a call, then encode img/s at b=64 (int8, bf16
fused_t, plain eager bf16) on --gemm's export; then the LayerNorm
backward (layernorm_bwd) at the same three shapes with and without the
residual's gradient g, beside F.layer_norm's backward
(aten.native_layer_norm_backward, by events and graph replay), and the
composed backward chains that run it, #3 and #4 at L=257 and #10 at L=257,
by events and graph replay. It checks the forward kernels and the
backward cases at B=8 first and, for this checkout, applies phase 1's
spill gate.
The last lines are the card's name and power limit, one JSON object of
per-kernel results, and {"ok": true, "device": {...}}.

It needs no network and imports no JAX. PNGs are decoded by the package's
own decoder (zlib and numpy: the card's machine may lack Pillow).
"""

from __future__ import annotations

import base64
import glob
import io
import json
import os
import re
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
# PNG writing (8-bit RGB, every row filter 0) with the standard library; the
# package decodes them (openvision_tpu_torch/data/ops_image.py:decode_png)
# ---------------------------------------------------------------------------


def adaptive_rows(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> PNG scanlines, each row's filter chosen as
    libpng's adaptive heuristic chooses it (the least sum of |residual| over
    the row's bytes taken as signed), so that the common encoders' mix of
    None, Sub, Up, Average and Paeth rows occurs."""
    h, w, _ = image.shape
    x = image.reshape(h, w * 3).astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 3:], b[1:], c[1:, 3:] = x[:, :-3], x[:-1], x[:-1, :-3]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    res = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 255
    f = np.minimum(res, 256 - res).sum(-1).argmin(0)
    return np.concatenate([f[:, None], res[f, np.arange(h)]], axis=1).astype(np.uint8)


def write_png(path: str, image: np.ndarray, adaptive: bool = False) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG with filter-0 rows, or with rows
    filtered as :func:`adaptive_rows` filters them."""
    h, w, _ = image.shape
    rows = (adaptive_rows(image) if adaptive else
            np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


_T0 = time.perf_counter()


def phase(title: str) -> None:
    print(f"\n== {title} == [{time.perf_counter() - _T0:.1f} s]", flush=True)


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
    kernels (bf16 and int8, one instantiation a chunk count) and the
    LayerNorm backward (one a chunk count) and its finish must not spill
    registers; the build must hold an int8 GEMM, the forward attention
    kernel, both attention backward kernels and the three LayerNorm kernels
    at all 8 chunk counts.
    ptxas's notes on serialized wgmma are printed."""
    log = (lib_path.parent / "build.log").read_text()
    spills = ptxas_summary(log)
    gated = [f for f in spills if "gemm_ws_kernel" in f or "quant" in f or "attention_" in f
             or "ln_rows_kernel" in f or "layernorm_bwd_" in f]
    int8_gemms = [f for f in gated if "gemm_ws_kernel" in f and "2S8E" in f]
    attn_fwd = [f for f in gated if "attention_fwd" in f]
    attn_bwd = [f for f in gated if "attention_bwd" in f]
    ln = {epi: [f for f in gated if "ln_rows_kernel" in f and epi in f]
          for epi in ("LnBf16", "LnQuant")}
    ln["backward"] = [f for f in gated if "layernorm_bwd_kernel" in f]
    print(f"spill gate: {len(gated)} kernels, {len(int8_gemms)} of them int8 GEMMs, "
          f"{len(attn_fwd)} attention forward, {len(attn_bwd)} attention backward, "
          f"{len(ln['LnBf16'])} + {len(ln['LnQuant'])} + {len(ln['backward'])} LayerNorm "
          "(bf16 + int8 + backward)")
    for epi, found in ln.items():
        if len(found) != 8:  # NC = 1..8
            raise AssertionError(f"expected the LayerNorm kernel ({epi}) at 8 chunk counts, "
                                 f"found {found}")
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


# (L, D, heads, causal, prefix) of the fused block: the caption path's image
# tower, concat decoder and cross_attn decoder self-attention
BLOCK_SHAPES = ((257, 1024, 16, False, 0), (463, 768, 12, True, 335), (128, 768, 12, True, 0))


def block_cases(fa, device, gen, b: int, shapes=BLOCK_SHAPES):
    """The composed fused block (#9) at `shapes` (default: the caption
    path's three). Its bound counts x, the weights and the output once (the
    Pallas kernel keeps every intermediate on chip); its library time is the
    sequence of library calls of :func:`_library_block`."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    out = []
    for l, d, heads, causal, prefix in shapes:
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
    kernel captioners by (fusion, dec_impl), the checkpoint paths, and the
    greedy ids by (fusion, dec_impl) (on the CPU; phase 22 holds the Orbax
    path to them)."""
    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.models.decoder import mask_after_eos
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.tools.caption import build_captioner

    loaded, ckpts, greedy = {}, {}, {}
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
            greedy[(fusion, dec_impl)] = runs["greedy"].cpu()
    return loaded, ckpts, greedy


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


def ln_backward_library(x, gamma, dy):
    """F.layer_norm's backward as one PyTorch call on the same inputs
    (bf16, as autograd runs it for a bf16 forward):
    aten.native_layer_norm_backward for dx, dgamma and dbeta, with the
    forward's mean and rstd computed here once. A plain call, so a CUDA
    graph captures it (an autograd.grad does not)."""
    import torch

    d = x.shape[-1]
    w, bias = gamma.bfloat16(), torch.zeros(d, device=x.device, dtype=torch.bfloat16)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], w, bias, 1e-6)
    dy16 = dy.bfloat16()
    return lambda: torch.ops.aten.native_layer_norm_backward(dy16, x, [d], mean, rstd, w, bias,
                                                             [True, True, True])


def block_bwd_parts(gk, device, gen, b: int, l: int = 257, d: int = 1024):
    """One fused-block backward's GEMM, LayerNorm and column-sum launches at
    the image tower's shapes (M = b * l rows), each a case of its kernel.
    Library calls: torch.matmul in the same layout, F.layer_norm's backward
    (ln_backward_library), torch.sum over the rows."""
    import torch

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
    cases.append(Case("layernorm_bwd", f"LN bwd + residual ({m}x{d})",
                      lambda: gk.layernorm_bwd(x, gamma, dy, g, eps=1e-6),
                      lambda: gk.layernorm_bwd_plain(x.float(), gamma, dy, g.float(), eps=1e-6),
                      ln_backward_library(x, gamma, dy),
                      m * d * (2 + 4 + 2 + 2) + 3 * d * 4, 0, 10 * m * d))
    for label, t, rnd_ in (("db_qkv per image, rounded", dqkv, True), ("db_o", g, False)):
        n = t.shape[-1]
        cases.append(Case("colsum", f"{label} ({m}x{n})",
                          lambda t=t, r=rnd_: (gk.colsum(t, l, r),),
                          lambda t=t, r=rnd_: (gk.colsum_plain(t, l, r),),
                          lambda t=t, n=n: t.reshape(-1, n).sum(0, dtype=torch.float32),
                          m * n * 2 + n * 4, 0, m * n))
    return cases


def fused_block_bwd_cases(fa, device, gen, b: int, lengths=(257, 463, 128),
                          shapes=BLOCK_SHAPES):
    """The fused block's whole backward (#10's 12 launches) at those of
    `shapes` (default: the three training shapes) whose length is in
    `lengths`, against the plain Pallas-order backward; its library call is
    the autograd backward of the block as library calls."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    cases = []
    for l, d, heads, causal, prefix in shapes:
        if lengths is not None and l not in lengths:
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
# --data_parallel's replicas in phase 11d: the card's machine has one GPU, so two replicas
# of cuda:0 (two streams) drive the mechanism; the burst repeats the images this often
DP_REPLICAS, DP_BURST = 2, 6


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


def data_parallel_phase(model, ckpt: str, images, totals: dict, device, one: dict) -> dict:
    """Phase 11d: ``--data_parallel``'s mechanism on the one card: the bf16
    EmbedService and the caption service over DP_DEVICES (two replicas of
    cuda:0, each on its own stream, sharing the weights). Every bucket's
    rows split over the replicas: embeddings against the direct encode
    (cosine >= 0.99999), captions of one burst against the caption tool's
    greedy ids on the rows each replica took, then the load of phase 11c
    over HTTP beside its one-replica figures (`one`)."""
    import http.client
    import threading

    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.serving import server as srv
    from openvision_tpu_torch.serving.encode import build_encode_fn
    from openvision_tpu_torch.tools import caption as tcap

    devices = [torch.device(device)] * DP_REPLICAS
    raw = np.stack(images)
    cap_rows = np.stack([tcap.preprocess(im, RES) for im in images]).astype(np.float32)
    t0 = time.perf_counter()
    svc = srv.EmbedService(model, int8=False, max_batch=DAEMON_MAX_BATCH, devices=devices)
    capsvc = srv.CaptionService(get_config(caption_arg("concat", "fused")), ckpt,
                                max_batch=DAEMON_MAX_BATCH, max_wait_ms=100.0, devices=devices)
    buckets = svc.warmup(), capsvc.warmup()
    print(f"[11d] {DP_REPLICAS} replicas on {device}: services up and every bucket {buckets[0]} "
          f"warmed on each in {time.perf_counter() - t0:.1f} s; /stats devices "
          f"{svc.stats()['devices']}, caption {capsvc.stats()['devices']}")
    if buckets[0][0] != DP_REPLICAS or buckets[1][0] != DP_REPLICAS:
        raise AssertionError(f"[11d] buckets not floored at {DP_REPLICAS}: {buckets}")
    server = srv.make_server(svc, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    res = {}
    try:
        with torch.inference_mode():
            direct = build_encode_fn(model, int8=False, uint8_input=True)(
                torch.from_numpy(raw).to(device)).cpu().numpy()
        kernels.reset_launch_counts()
        rows = np.concatenate([raw] * DP_BURST)
        order = np.arange(len(rows)) % len(raw)
        old_wait, svc.images.max_wait = svc.images.max_wait, 0.05
        try:  # bursts of 1, 3, 7 and the rest: buckets of 2, 4, 8 and more
            z, start = [], 0
            for k in (1, 3, 7, len(rows) - 11):
                z += [f.result(timeout=300) for f in svc.embed_image_tensor(rows[start:start + k])]
                start += k
            z = np.stack(z)
        finally:
            svc.images.max_wait = old_wait
        ref = direct[order]
        cos = float(((z * ref).sum(-1) / (np.linalg.norm(z, axis=-1)
                                           * np.linalg.norm(ref, axis=-1))).min())
        print(f"[11d] {len(rows)} rows in {svc.images.stats()['batches']} batches over the "
              f"replicas: embeddings against the direct encode, min cosine {cos:.7f}")
        if cos < 0.99999:
            raise AssertionError(f"[11d] replica embeddings differ from the direct encode: {cos}")
        # the images in one caption batch: each replica captions its half of the bucket
        futs = [capsvc.batcher.submit(r) for r in cap_rows]
        got = [f.result(timeout=300) for f in futs]
        n = len(cap_rows)
        padded = np.zeros((srv.bucket_size(n, DAEMON_MAX_BATCH, DP_REPLICAS),)
                          + cap_rows.shape[1:], np.float32)
        padded[:n] = cap_rows
        with torch.inference_mode():
            ids = torch.cat([capsvc.captioners[0](torch.from_numpy(part).to(device)).cpu()
                             for part in np.array_split(padded, DP_REPLICAS)])[:n]
        want = [capsvc.tok.decode(r) for r in ids.tolist()]
        if capsvc.stats()["batches"] != 1 or got != want:
            raise AssertionError(f"[11d] replica captions {got} against the tool's {want}")
        print(f"[11d] captions of the {n} images in one batch over {DP_REPLICAS} replicas equal "
              f"the caption tool's greedy ids on each replica's rows")
        lat, lock = [], threading.Lock()

        def load(i):
            conn = http.client.HTTPConnection(*server.server_address, timeout=300)
            for r in range(DAEMON_LOAD_REQUESTS):
                rows1 = raw[(i + r) % len(images)][None]
                st, _, dt = _http(conn, "POST", "/v1/embed/tensor", rows1.tobytes(),
                                  _tensor_headers(rows1))
                if st != 200:
                    raise AssertionError(f"[11d] /v1/embed/tensor under load: {st}")
                with lock:
                    lat.append(dt)
            conn.close()

        before = svc.images.stats()
        t0 = time.perf_counter()
        _run_clients(load, DAEMON_CLIENTS)
        wall = time.perf_counter() - t0
        st = svc.images.stats()
        lat.sort()
        p50, p95 = lat[len(lat) // 2], lat[min(len(lat) - 1, int(0.95 * len(lat)))]
        batches = st["batches"] - before["batches"]
        res = {"requests_per_s": len(lat) / wall, "p50_ms": p50 * 1e3, "p95_ms": p95 * 1e3,
               "mean_batch": (st["requests"] - before["requests"]) / max(batches, 1)}
        print(f"[11d] bf16 /v1/embed/tensor under phase 11c's load over {DP_REPLICAS} replicas: "
              f"{res['requests_per_s']:.1f} requests/s, p50 {res['p50_ms']:.1f} ms, p95 "
              f"{res['p95_ms']:.1f} ms, mean batch {res['mean_batch']:.2f}; one replica (11c): "
              f"{one['requests_per_s']:.1f} requests/s, p50 {one['p50_ms']:.1f} ms, p95 "
              f"{one['p95_ms']:.1f} ms  [{smi_line()}]")
        torch.cuda.synchronize()
        got_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        print(f"[11d] the replicas' launches (burst, captions, load): {got_launches}")
        for k, v in got_launches.items():
            totals[k] += v
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
        capsvc.stop()
    return res


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
# each rank's peak in this phase with the vocab axis (the token embedding, the towers'
# heads, the decoder head) whole on each rank, before it was split over tensor (H100 80GB
# HBM3, 700 W)
TP_PEAK_GB_WHOLE_VOCAB = 2.28
TP_TIMEOUT_S = 420  # each torchrun launch of phase 18
# Phase 18's depth, cut from phase 8's 24 image, 12 text and 12 decoder
# blocks (the full widths kept; a third until phase 23 needed the room): two
# ranks on one card spend ~90% of a step in gloo's host-staged all-reduces,
# which scale with the blocks
TP_DEPTH = {"image": 4, "text": 2, "text_decoder_config": 2}


def tp_config(cfg: dict) -> dict:
    """`cfg` at phase 18's depth (TP_DEPTH)."""
    for tower, depth in TP_DEPTH.items():
        cfg["model"][tower]["depth"] = depth
    return cfg


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
                       ("model.image.fast_gelu", True), ("input.pp", c["input"]["pp"]),
                       *((f"model.{t}.depth", d) for t, d in TP_DEPTH.items())):
        args += ["--override", f"{key}={value}"]
    return args


def torchrun(args, log_path: str) -> None:
    """python -m torch.distributed.run --nproc_per_node TP_SIZE `args`, in a
    session of its own (every process it starts ends with it, or is killed
    at TP_TIMEOUT_S, :func:`kill_tree`); raises unless every rank exits 0."""
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
            kill_tree(proc.pid)
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
    cfg = tp_config(train_config("concat", "fused", no_pil=no_pil))
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
    cfg = tp_config(train_config("concat", "fused", no_pil=no_pil))
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
    blocks = TP_DEPTH["image"] + TP_DEPTH["text_decoder_config"]
    grad_want = {k: v * blocks for k, v in TP_BLOCK_STEP.items()}  # fwd, recompute, bwd
    for r in ranks:
        print(f"[tensor={TP_SIZE}] rank {r['rank']}: step {r['step_ms']:.1f} ms (CUDA events; two "
              f"ranks share one card over gloo, so not comparable with phase 8), peak memory "
              f"{r['peak_gb']:.2f} GB (the vocab leaves whole on each rank: "
              f"{TP_PEAK_GB_WHOLE_VOCAB} GB), all-reduce {r['comm_ms']:.1f} ms over {r['comm_calls']} "
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
    if ckpts != [str(TRAIN_STEPS), f"data_position-{TRAIN_STEPS}.json"]:
        raise AssertionError(f"tensor parallel training wrote {ckpts}")
    print_saves(f"[tensor={TP_SIZE}]", log)
    with torch.inference_mode():
        cap, tok = build_captioner(tp_config(get_config(caption_arg("concat", "fused"))),
                                   os.path.join(wd, "checkpoints"), device=device,
                                   step=TRAIN_STEPS)
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


# ---------------------------------------------------------------------------
# Evaluation at full width (phase 19)
# ---------------------------------------------------------------------------

EVAL_IMAGES, EVAL_H, EVAL_W, EVAL_BATCH, EVAL_CAPTIONS = 1000, 224, 288, 256, 5
# the trainer's config of phase 3's export (main_clip eval_only): its widths,
# vocabulary and 80 text tokens
EVAL_ARG = "res=224,img=L/14,txt_name=L,vocab_size=30522,token_len=80"
EVAL_CALIB = 64
EVAL_CLASS_CHECK = 100  # classes whose prompts the f32 text tower also embeds
RECALL_MARGIN = 1e-3
# max|sim - f32 sim| over the 1000 x 5000 retrieval similarities, bf16
# fused_t towers against f32 xla at random weights: 1.46e-3 measured on an
# H100, bound at about three times that
SIM_TOL = 5e-3


def write_eval_fixture(work: str, images) -> tuple:
    """EVAL_IMAGES 224 x 288 PNGs (a testcat image in a wider canvas, each
    at another offset and row roll), one per class directory c0000...,
    through the port's data/prepare.py into TFRecord shards, and an npz of
    the same pixels with EVAL_CAPTIONS captions an image (CLIP templates of
    the image's class name). Returns (TFDS dir, npz path, labels)."""
    from openvision_tpu_torch.data import prepare
    from openvision_tpu_torch.evaluators import prompts

    tree, tfds_dir = os.path.join(work, "eval_tree"), os.path.join(work, "eval_tfds")
    names = prompts.get_class_names()
    templates = prompts.get_prompt_templates("clip_paper")[:EVAL_CAPTIONS]
    pixels = np.zeros((EVAL_IMAGES, EVAL_H, EVAL_W, 3), np.uint8)
    captions = np.empty(EVAL_IMAGES, object)
    t0 = time.perf_counter()
    for i in range(EVAL_IMAGES):
        off = i % (EVAL_W - EVAL_H + 1)
        pixels[i, :, off:off + EVAL_H] = np.roll(images[i % len(images)], 7 * (i // 5), axis=0)
        os.makedirs(os.path.join(tree, f"c{i:04d}"))
        write_png(os.path.join(tree, f"c{i:04d}", f"{i:04d}.png"), pixels[i])
        captions[i] = [t.format(names[i]) for t in templates]
    t1 = time.perf_counter()
    n = prepare.prepare(tree, tfds_dir, split="validation")
    t2 = time.perf_counter()
    npz = os.path.join(work, "eval_captions.npz")
    np.savez(npz, image=pixels, captions=captions)
    print(f"eval fixture: {EVAL_IMAGES} PNGs {EVAL_H}x{EVAL_W} written in {t1 - t0:.1f} s, "
          f"data/prepare.py wrote {n} records in {t2 - t1:.1f} s, npz "
          f"({EVAL_IMAGES * EVAL_CAPTIONS} captions) in {time.perf_counter() - t2:.1f} s")
    return tfds_dir, npz, np.arange(EVAL_IMAGES)


def eval_launches(encodes: int, int8: bool, depth: int) -> dict:
    """Launches of `encodes` image batches: bf16 fused_t (#1 and #2 each
    `depth` times a batch) or the int8 kernels (#5 and #6)."""
    from openvision_tpu_torch.ops import kernels

    want = dict.fromkeys(kernels.LAUNCHES, 0)
    per_block = INT8_LAUNCHES_PER_BLOCK if int8 else LAUNCHES_PER_BLOCK
    for k, v in per_block.items():
        want[k] += v * depth * encodes
    for k, v in (INT8_LAUNCHES_PER_ENCODE if int8 else {}).items():
        want[k] += v * encodes
    return want


def counted(fn, want: dict, label: str, totals: dict):
    """fn() with the launch counts set to 0 before and read after; raises
    unless they are `want`."""
    import torch

    from openvision_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    print(f"{label}: launches {({k: v for k, v in got.items() if v})}")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    for k, v in got.items():
        totals[k] += v
    return out


def recall_hits(sim: np.ndarray, txt2img: np.ndarray, k: int):
    """Per query hit@k and top-k margin (k-th minus (k+1)-th similarity),
    text -> image and image -> text."""
    out = {}
    for name, s, match in (("txt2img", sim.T, lambda order: order == txt2img[:, None]),
                           ("img2txt", sim, lambda order: txt2img[order]
                            == np.arange(sim.shape[0])[:, None])):
        order = np.argsort(-s, axis=1)
        top = np.take_along_axis(s, order[:, :k + 1], axis=1)
        out[name] = (match(order)[:, :k].any(axis=1), top[:, k - 1] - top[:, k])
    return out


def adaptive_png_decode(work: str, pixels: np.ndarray, reps: int = 50) -> dict:
    """ms an image to decode one fixture image written as a PNG with
    adaptively filtered rows (what common encoders write; the fixture's own
    rows are unfiltered), by decode_png and, where it is installed, by
    Pillow; decode_png must give the pixels back."""
    from openvision_tpu_torch.data.ops_image import decode_png

    path = os.path.join(work, "adaptive.png")
    write_png(path, pixels, adaptive=True)
    with open(path, "rb") as f:
        data = f.read()
    if not np.array_equal(decode_png(data), pixels):
        raise AssertionError("decode_png of an adaptively filtered PNG differs from its pixels")
    decoders = {"decode_png": decode_png}
    try:
        from PIL import Image

        decoders["pillow"] = lambda d: np.asarray(Image.open(io.BytesIO(d)).convert("RGB"))
    except ImportError:
        pass
    out = {}
    for name, fn in decoders.items():
        fn(data)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(data)
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    kinds = np.bincount(adaptive_rows(pixels)[:, 0], minlength=5).tolist()
    print(f"PNG decode of an adaptively filtered {pixels.shape[0]}x{pixels.shape[1]} PNG (rows "
          f"None/Sub/Up/Average/Paeth {kinds}): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in out.items())
          + ("" if "pillow" in out else " (Pillow is not installed)"))
    return out


def static_scale_checks(q8: dict, x, scales: dict, geom: dict) -> None:
    """The static-scale branch of layernorm_quant and quant_rows at the
    eval's shapes, on block 0's real activations of the image batch `x`
    with calibrate_vit's scales, each held against its plain version with
    the same scale (quant_rows bit-equal, layernorm_quant as phase 10 holds
    it); every row's returned scale must be the calibrated one."""
    import torch

    from openvision_tpu_torch.ops import fused_encoder as fe
    from openvision_tpu_torch.ops import fused_encoder_int8 as fe8
    from openvision_tpu_torch.serving import quant

    qb, site = q8["blocks"][0], scales["blocks"][0]

    def check(name, label, got, ref, s):
        """quant_rows bit-equal to its plain version, layernorm_quant held
        as phase 10 holds it; every row's scale the static one."""
        (q, scale), (q_ref, scale_ref) = got, ref
        label = f"{label} ({'x'.join(map(str, q.shape))}), static scale {s.item():.4e}"
        if not bool((scale == s).all()):
            raise AssertionError(f"{name} {label}: a row's scale is not the static scale")
        if name == "layernorm_quant":
            check_quant(Case(name, label, None, None, None, 0, 0, quant=True), got, ref, {})
            return q, scale
        ok = torch.equal(q, q_ref) and torch.equal(scale, scale_ref)
        print(f"  {name:15s} {label}: bit-equal to its plain version {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label}: differs from its plain version")
        return q, scale

    x0 = quant._embed_tokens(q8, x, **geom)
    yq, ys = check("layernorm_quant", "block 0 LN1", fe8.layernorm_quant(
        x0, qb["ln1_w"], qb["ln1_b"], qb["eps"], site["attn_in"]), fe8.layernorm_quant_plain(
        x0, qb["ln1_w"], qb["ln1_b"], qb["eps"], site["attn_in"]), site["attn_in"])
    o = fe.attention(fe8.gemm_int8(yq, ys, qb["wqkv_q"], qb["wqkv_s"], qb["bqkv"]),
                     qb["num_heads"]).float()
    oq, os_ = check("quant_rows", "block 0 attention output", fe8.quant_rows(
        o, static_scale=site["attn_out"]), fe8.quant_plain(o, static_scale=site["attn_out"]),
        site["attn_out"])
    x1 = fe8.gemm_int8(oq, os_, qb["wo_q"], qb["wo_s"], qb["bo"], residual=x0)
    yq, ys = check("layernorm_quant", "block 0 LN2", fe8.layernorm_quant(
        x1, qb["ln2_w"], qb["ln2_b"], qb["eps"], site["mlp_in"]), fe8.layernorm_quant_plain(
        x1, qb["ln2_w"], qb["ln2_b"], qb["eps"], site["mlp_in"]), site["mlp_in"])
    if qb["gelu_tanh"]:
        h, hmax = fe8.gemm_int8(yq, ys, qb["w1_q"], qb["w1_s"], qb["b1"], gelu=True,
                                out_dtype=torch.float32, row_amax=True)
    else:
        h = torch.nn.functional.gelu(fe8.gemm_int8(yq, ys, qb["w1_q"], qb["w1_s"], qb["b1"],
                                                   out_dtype=torch.float32))
        hmax = None
    check("quant_rows", "block 0 GELU hidden", fe8.quant_rows(
        h, hmax, static_scale=site["mlp_hid"]), fe8.quant_plain(
        h, static_scale=site["mlp_hid"]), site["mlp_hid"])


def eval_phase(model_dir: str, work: str, images, device, totals: dict) -> dict:
    """Phase 19: the zero-shot (bf16, int8 static and dynamic) and retrieval
    evaluators at full width on a TFRecord fixture of 1000 images, and
    main_clip eval_only on a port state npz of the same weights."""
    import torch

    from openvision_tpu_torch import main_clip
    from openvision_tpu_torch.configs import openvision as cfg_mod
    from openvision_tpu_torch.convert.openclip import openclip_to_state_dict
    from openvision_tpu_torch.data import pipeline as pipe
    from openvision_tpu_torch.data.ops_image import decode_png
    from openvision_tpu_torch.evaluators import disclf, retrieval
    from openvision_tpu_torch.serving import quant
    from openvision_tpu_torch.tools.model_io import load_model
    from openvision_tpu_torch.train import checkpoint as ckpt_lib
    from openvision_tpu_torch.train.step import normalize_uint8

    vocab = os.path.join(REPO, "assets", "bert_base_vocab_bos_eos.txt")
    evals = cfg_mod.get_config(f"{EVAL_ARG},vocab_path={vocab}")["evals"]
    dcfg, rcfg = dict(evals["disclf"]), dict(evals["retrieval"])
    for cfg in (dcfg, rcfg):
        for key in ("type", "prefix", "log_steps"):
            cfg.pop(key, None)
    tfds_dir, npz, labels = write_eval_fixture(work, images)
    src = pipe.TfdsDirectorySource(tfds_dir, "validation")
    t0 = time.perf_counter()
    for i in range(len(src)):
        decode_png(src[i]["image"])
    decode_s = time.perf_counter() - t0
    print(f"PNG decode alone: {decode_s:.2f} s for {len(src)} records "
          f"({1e3 * decode_s / len(src):.2f} ms an image)")
    png_ms = adaptive_png_decode(work, decode_png(src[0]["image"]))

    t0 = time.perf_counter()
    model = load_model(model_dir, dtype=torch.bfloat16, attn_impl="fused_t", fast_gelu=True,
                       device=device, int8=True)
    ref = load_model(model_dir, dtype=torch.float32, attn_impl="xla", fast_gelu=True,
                     device=device)
    print(f"load_model bf16 fused_t (+int8) and f32 xla in {time.perf_counter() - t0:.1f} s")
    depth = len(model.vision.transformer.resblocks)
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    ev = disclf.Evaluator(model, **{**dcfg, "data_dir": tfds_dir, "batch_size": EVAL_BATCH})
    results = {}
    accs = {}
    for mode, int8, calib in (("bf16", False, 0), ("int8 static", True, EVAL_CALIB),
                              ("int8 dynamic", True, 0)):
        ev.int8, ev.int8_calibration = int8, calib
        encodes = batches + (-(-calib // 32) if int8 else 0)
        t0 = time.perf_counter()
        metrics, preds, mask = counted(lambda: ev.run(return_preds=True),
                                       eval_launches(encodes, int8, depth), f"disclf {mode}",
                                       totals)
        wall = time.perf_counter() - t0
        t = dict(ev.timings)
        ncorrect, ntotal = ev.counts
        acc = metrics[0][1]
        acc_preds = float((preds[mask > 0] == labels).mean())
        print(f"disclf {mode}: {metrics}  ncorrect {ncorrect} ntotal {ntotal}  accuracy from "
              f"return_preds {acc_preds}  last batch real rows {int(mask[-EVAL_BATCH:].sum())}")
        print(f"  {wall:.2f} s: prompts tokenized on the host {t['tokenize']:.2f} s "
              f"({len(ev.class_names) * len(ev.templates)} prompts), class embeddings "
              f"{t['class_embed']:.2f} s; image loop {t['loop']:.2f} s = "
              f"{EVAL_IMAGES / t['loop']:.1f} images/s, host share "
              f"{(t['host'] + t['copy']) / t['loop']:.3f} (decode + pp {t['host']:.2f} s, "
              f"copy {t['copy']:.2f} s)")
        if ntotal != EVAL_IMAGES or len(preds) != batches * EVAL_BATCH:
            raise AssertionError(f"disclf {mode}: ntotal {ntotal}, expected {EVAL_IMAGES}")
        if int(mask[-EVAL_BATCH:].sum()) != EVAL_IMAGES - (batches - 1) * EVAL_BATCH:
            raise AssertionError(f"disclf {mode}: the last batch's mask is wrong")
        if acc != acc_preds:
            raise AssertionError(f"disclf {mode}: accuracy {acc} from the counts, {acc_preds} "
                                 "from return_preds")
        if (calib > 0) != (ev.int8_scales is not None):
            raise AssertionError(f"disclf {mode}: static scales {ev.int8_scales is not None}")
        accs[mode] = acc
        results[mode] = {"images_per_s": EVAL_IMAGES / t["loop"], **t}

    with torch.no_grad():
        tokens = ev.prompt_tokens()[:EVAL_CLASS_CHECK * len(ev.templates)]
        names = ev.class_names
        ev.class_names = names[:EVAL_CLASS_CHECK]
        ev_ref = disclf.Evaluator(ref, **{**dcfg, "data_dir": tfds_dir})
        ev_ref.class_names = ev.class_names
        with ev.towers.evaluating():
            cls_k = ev.class_embeddings(tokens)
        with ev_ref.towers.evaluating():
            cls_f = ev_ref.class_embeddings(tokens)
        ev.class_names = names
        cls_cos = (cls_k * cls_f).sum(-1)
        batch0 = next(pipe.make_for_inference(src, dcfg["pp_img"], EVAL_BATCH)())
        x = normalize_uint8(torch.from_numpy(batch0["image"]).to(device))
        z_k = ev.towers.embed_images(x)
        z_f = ev_ref.towers.embed_images(x)
        geom = dict(patch_size=model.vision.conv1.kernel_size[0], posemb=model.vision.posemb)
        scales = quant.calibrate_vit(model.int8, x[:EVAL_CALIB], **geom)
        z_s = quant.quantized_encode(model.int8, x, act_scales=scales, **geom)
        z_d = quant.quantized_encode(model.int8, x, **geom)
        static_scale_checks(model.int8, x, scales, geom)
    cos = {"bf16": (z_k * z_f).sum(-1), "int8 static": (z_s * z_f).sum(-1),
           "int8 dynamic": (z_d * z_f).sum(-1)}
    print(f"class embeddings ({EVAL_CLASS_CHECK} classes x {len(ev.templates)} prompts), bf16 "
          f"text tower vs f32 xla: min cosine {cls_cos.min().item():.6f}")
    for mode, c in cos.items():
        print(f"zimg cosine, {mode} vs f32 xla (first batch of {EVAL_BATCH}): min "
              f"{c.min().item():.6f} mean {c.mean().item():.6f}")
    if cls_cos.min().item() < 0.999 or cos["bf16"].min().item() < 0.999:
        raise AssertionError("bf16 class embedding or zimg cosine below 0.999")
    if min(cos["int8 static"].min().item(), cos["int8 dynamic"].min().item()) < 0.995:
        raise AssertionError("int8 zimg cosine below 0.995")

    rv = retrieval.Evaluator(model, **{**rcfg, "data_dir": npz, "batch_size": EVAL_BATCH})
    t0 = time.perf_counter()
    zimg, ztxt, txt2img = counted(rv.embeddings, eval_launches(batches, False, depth),
                                  "retrieval", totals)
    rwall = time.perf_counter() - t0
    rv_ref = retrieval.Evaluator(ref, **{**rcfg, "data_dir": npz, "batch_size": EVAL_BATCH})
    zimg_f, ztxt_f, _ = rv_ref.embeddings()
    cos_img = torch.nn.functional.cosine_similarity(zimg.float(), zimg_f.float(), dim=-1)
    cos_txt = torch.nn.functional.cosine_similarity(ztxt.float(), ztxt_f.float(), dim=-1)
    sim = zimg.cpu().numpy() @ ztxt.cpu().numpy().T
    sim_f = zimg_f.cpu().numpy() @ ztxt_f.cpu().numpy().T
    sim_err = float(np.abs(sim - sim_f).max())
    recalls = retrieval.recall_at_k(sim, txt2img)
    print(f"retrieval over {len(txt2img)} captions of {EVAL_IMAGES} images in {rwall:.2f} s: "
          f"{recalls}")
    print(f"  f32 xla: {retrieval.recall_at_k(sim_f, txt2img)}; max|sim - f32 sim| "
          f"{sim_err:.2e} (bound {SIM_TOL:g}), similarities of a caption to the images span "
          f"{np.median(sim_f.max(0) - sim_f.min(0)):.2e} (median); cosine vs f32 xla, min over "
          f"{len(cos_img)} images {cos_img.min().item():.6f}, over {len(cos_txt)} captions "
          f"{cos_txt.min().item():.6f}")
    if not np.array_equal(txt2img, np.repeat(np.arange(EVAL_IMAGES), EVAL_CAPTIONS)):
        raise AssertionError("retrieval: txt2img is not each image's captions in order")
    if (zimg.shape, ztxt.shape) != (zimg_f.shape, ztxt_f.shape) or zimg.shape[0] != EVAL_IMAGES \
            or ztxt.shape[0] != EVAL_IMAGES * EVAL_CAPTIONS:
        raise AssertionError(f"retrieval: embeddings {tuple(zimg.shape)}, {tuple(ztxt.shape)}")
    if min(cos_img.min().item(), cos_txt.min().item()) < 0.999:
        raise AssertionError("retrieval: an image or caption embedding's cosine vs f32 xla is "
                             "below 0.999")
    if not sim_err <= SIM_TOL:
        raise AssertionError(f"retrieval: max|sim - f32 sim| {sim_err} above {SIM_TOL}")
    for k in retrieval.RECALL_KS:
        got, want = recall_hits(sim, txt2img, k), recall_hits(sim_f, txt2img, k)
        for direction in got:
            sure = want[direction][1] > RECALL_MARGIN
            bad = int((got[direction][0][sure] != want[direction][0][sure]).sum())
            print(f"  {direction}@{k}: {int(sure.sum())} queries with a f32 top-k margin above "
                  f"{RECALL_MARGIN:g}, {bad} disagree; the other {int((~sure).sum())} "
                  f"(margin below): hit {int(got[direction][0][~sure].sum())} on the kernels, "
                  f"{int(want[direction][0][~sure].sum())} on f32")
            if bad:
                raise AssertionError(f"retrieval {direction}@{k}: {bad} confident queries differ")

    # main_clip eval_only on a port state npz of the same weights
    state = os.path.join(work, "eval_state.npz")
    t0 = time.perf_counter()
    sd = torch.load(os.path.join(model_dir, "open_clip_pytorch_model.bin"), map_location="cpu",
                    weights_only=True)
    ckpt_lib.save_npz(state, {"params": openclip_to_state_dict(sd)})
    del sd
    print(f"port state npz written in {time.perf_counter() - t0:.1f} s")
    del model, ref, ev, ev_ref, rv, rv_ref
    torch.cuda.empty_cache()
    wd = os.path.join(work, "eval_only")
    args = ["--config", os.path.join(REPO, "openvision_tpu_torch", "configs", "openvision.py")
            + f":{EVAL_ARG},vocab_path={vocab},dtype=bfloat16",
            "--workdir", wd, "--device", torch.device(device).type]
    for ov in ("eval_only=True", f"ft_from={state}", "model.image.posemb=learn",
               "model.image.attn_impl=fused_t", "model.text_decoder=none",
               f"evals.disclf.data_dir={tfds_dir}", f"evals.retrieval.data_dir={npz}"):
        args += ["--override", ov]
    t0 = time.perf_counter()
    counted(lambda: main_clip.main(args), eval_launches(2 * batches, False, depth),
            "main_clip eval_only", totals)
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    print(f"main_clip eval_only in {time.perf_counter() - t0:.1f} s: {rows}")
    if len(rows) != 1 or rows[0].get("z/0shot/imagenet2012_accuracy") != accs["bf16"]:
        raise AssertionError(f"eval_only accuracy {rows} differs from disclf's {accs['bf16']}")
    if any(rows[0].get(f"retrieval/{k}") != v for k, v in recalls.items()):
        raise AssertionError(f"eval_only recalls {rows} differ from the evaluator's {recalls}")
    torch.cuda.empty_cache()
    print(f"card: {smi_line()}")
    results["recall"] = recalls
    results["png_decode_ms"] = png_ms
    return results


# ---------------------------------------------------------------------------
# The interpretability tools at full width (phase 20)
# ---------------------------------------------------------------------------

# ViT-S/8-224 (BASELINE.json config 2's tower): 12 blocks of width 384, 6
# heads of 64 (a power-of-two softmax scale for #9/#10), 785 tokens, MLP
# 1536; phase 3's text tower, embed 384.
S8_CONFIG = {
    "model_cfg": {
        "embed_dim": 384,
        "vision_cfg": {"layers": 12, "width": 384, "head_width": 64, "patch_size": 8,
                       "image_size": 224, "pool_type": "avg", "final_ln_after_pool": True,
                       "no_ln_pre": True},
        "text_cfg": L14_CONFIG["model_cfg"]["text_cfg"],
    },
    "preprocess_cfg": L14_CONFIG["preprocess_cfg"],
}
FV_LAYER, FV_FEATURE = 6, 5
ADV_LABELS = "a cat,a bat,a dog,text"
# #9's forward and #10's backward of one fused block (ops/fused_attention.py).
# A step runs #9 in every block and #10 in the blocks its loss reaches back
# through: all of them for an embedding's loss, blocks 0..layer for a GELU
# feature of block `layer`, none under no_grad.
BLOCK_FWD = {"layernorm": 1, "gemm_bias_act": 2, "attention": 1}
BLOCK_BWD = {"layernorm": 1, "gemm_bias_act": 1, "flash_attention": 1, "gemm_nn": 2,
             "attention_bwd_dq": 1, "attention_bwd_dkv": 1, "gemm_tn": 2, "layernorm_bwd": 1,
             "colsum": 2}
ROUTE_COS = 0.999  # the fused route against plain bf16 (the training gradients' bar)
TOOL_ITERS = 3  # timed iterations a tool and route, beside the CLIs' full runs


def block_launches(fwd: int, bwd: int) -> dict:
    from openvision_tpu_torch.ops import kernels

    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for per, n in ((BLOCK_FWD, fwd), (BLOCK_BWD, bwd)):
        for k, v in per.items():
            want[k] += v * n
    return want


def flat_cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def route_cosines(label: str, got: dict) -> None:
    """Prints fused / plain bf16 / f32 cosines of one quantity; raises unless
    fused against plain bf16 reaches ROUTE_COS."""
    c = {"fused vs plain bf16": flat_cos(got["fused"], got["bf16"]),
         "fused vs f32": flat_cos(got["fused"], got["f32"]),
         "plain bf16 vs f32": flat_cos(got["bf16"], got["f32"])}
    print(f"{label}: " + "  ".join(f"{k} {v:.6f}" for k, v in c.items()))
    if c["fused vs plain bf16"] < ROUTE_COS:
        raise AssertionError(f"{label}: fused vs plain bf16 cosine {c['fused vs plain bf16']}")


def step_seconds(fn, iters: int = TOOL_ITERS) -> float:
    """Seconds an iteration of fn() after one warm-up call, synchronized."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


class SharedLoads:
    """The tools' ``load_model``, loading each (model dir, options) once:
    the CLIs run their mains in turn on two exports."""

    def __init__(self):
        self.models = {}

    def __call__(self, model_dir, **kw):
        from openvision_tpu_torch.tools.model_io import load_model

        key = (model_dir, tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in self.models:
            self.models[key] = load_model(model_dir, **kw)
        return self.models[key]


def run_cli(module, argv, log: list) -> str:
    """module.main(argv) with each step's start time and loss appended to
    `log` (module.build_step wrapped); returns what main printed."""
    import contextlib

    orig = getattr(module, "build_step", None)

    def build_step(*a, **k):
        step, opt = orig(*a, **k)

        def timed(*args):
            t = time.perf_counter()
            out = step(*args)
            log.append((t, out[2]))
            return out

        return timed, opt

    if orig is not None:
        module.build_step = build_step
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            module.main(argv)
    finally:
        if orig is not None:
            module.build_step = orig
    return buf.getvalue()


def frozen_weight_cost(fa, gk, device) -> dict:
    """#10's chain at the tools' shapes by graph replay, beside the part that
    frozen weights do not need: the two weight-gradient products (gemm_tn)
    and the two bias sums (colsum)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    out = {}
    for label, b, l, d, heads in (("feature viz S/8, b=8 L=785", 8, 785, 384, 6),
                                  ("PGD L/14, b=1 L=257", 1, 257, 1024, 16)):
        def r(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=device) * scale).bfloat16()

        x, g = r(b, l, d), r(b, l, d)
        ln_w, ln_b = 1 + r(d, scale=0.02).float(), r(d, scale=0.02).float()
        w_qkv, b_qkv = r(3 * d, d, scale=d**-0.5), r(3 * d, scale=0.02).float()
        w_o, b_o = r(d, d, scale=d**-0.5), r(d, scale=0.02).float()
        kw = dict(num_heads=heads, sm_scale=None, causal=False, prefix_len=0, eps=1e-6)
        y, o, dqkv = r(b, l, d), r(b, l, d), r(b, l, 3 * d)
        whole = graph_ms(lambda: fa._backward_kernels(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, g,
                                                      **kw))
        dw = graph_ms(lambda: (gk.gemm_tn(g, o), gk.gemm_tn(dqkv, y)))
        db = graph_ms(lambda: (gk.colsum(dqkv, seg_len=l, round_bf16=True),
                               gk.colsum(g, seg_len=l)))
        out[label] = {"chain_us": 1e3 * whole, "dw_us": 1e3 * dw, "db_us": 1e3 * db}
        print(f"#10 {label}: chain {1e3 * whole:.1f} us by graph; the frozen weights' unneeded "
              f"dW_o + dW_qkv (2 gemm_tn) {1e3 * dw:.1f} us, db_qkv + db_o (2 colsum) "
              f"{1e3 * db:.1f} us: {100 * (dw + db) / whole:.1f}% of the chain")
    return out


def interp_phase(model_dir: str, work: str, device, totals: dict) -> dict:
    """Phase 20: the interpretability tools at full width. The CLIs' mains
    (f32 xla, their defaults) on phase 3's L/14 export and a new S/8 export,
    their outputs checked; then feature viz step 0, one PGD gradient, the
    GELU capture, the image embedding and a gradient-ascent step through
    ``fused`` bf16 (#9, and #10 under an input gradient), plain xla bf16 and
    f32 on the same inputs, with launch counts; the named capture error on
    ``fused_t``; each tool's seconds an iteration on each route, with the
    profiler's device busy share on ``fused`` and f32 (a ratio to the
    synchronized wall time of an iteration: below 0.5 the step is
    host-bound, whatever the flag says); #10's cost for frozen weights."""
    import torch

    from openvision_tpu_torch.data.ops_image import decode_png
    from openvision_tpu_torch.ops import fused_attention as fa
    from openvision_tpu_torch.ops import grad_kernels as gk
    from openvision_tpu_torch.tools import adversarial as advm
    from openvision_tpu_torch.tools import feature_viz as fv
    from openvision_tpu_torch.tools import gradient_ascent as ga
    from openvision_tpu_torch.tools import neuron_capture as nc
    from openvision_tpu_torch.tools.capture import GeluCaptureError

    t_phase = time.perf_counter()
    dev = torch.device(device).type
    s8_dir = os.path.join(work, "s8")
    os.makedirs(s8_dir)
    t0 = time.perf_counter()
    export_random_model(s8_dir, S8_CONFIG, SEED + 1)
    print(f"wrote the random ViT-S/8-224 export in {time.perf_counter() - t0:.1f} s")
    cat = os.path.join(REPO, "testcat", "catcat.png")
    bat = os.path.join(REPO, "testcat", "catbat.png")
    loads = SharedLoads()
    tools = (ga, fv, nc, advm)
    originals = [m.load_model for m in tools]
    for m in tools:
        m.load_model = loads
    cwd = os.getcwd()
    results, secs = {}, {}
    try:
        # -- the CLIs at their defaults (f32 xla) --
        ga_dir = os.path.join(work, "ga")
        os.makedirs(ga_dir)
        os.chdir(ga_dir)  # the tool writes opinion-tokens/ and txtembeds/ here
        log = []
        t0 = time.perf_counter()
        out = run_cli(ga, ["--use_model", model_dir, "--use_image", cat, "--deterministic",
                           "--device", dev], log)
        wall = time.perf_counter() - t0
        os.chdir(cwd)
        losses = [float(v) for _, v in log]
        secs["gradient ascent f32 xla (CLI)"] = (log[-1][0] - log[1][0]) / (len(log) - 2)
        print("\n".join(l for l in out.splitlines() if l.startswith(("Iteration", "Done"))))
        with open(os.path.join(ga_dir, "opinion-tokens", "tokens_catcat.txt")) as f:
            tokens_txt = f.read()
        emb = torch.load(os.path.join(ga_dir, "txtembeds", "catcat_text_embedding.pt"))
        print(f"gradient_ascent.main: {len(log)} iterations in {wall:.1f} s; first loss "
              f"{losses[0]:.4f}, best {min(losses):.4f}; tokens {tokens_txt!r}; txtembeds "
              f"{tuple(emb.shape)} {emb.dtype} {emb.device}")
        if len(log) != ga.ITERATIONS or not all(np.isfinite(losses)):
            raise AssertionError(f"gradient ascent: {len(log)} iterations, losses {losses[:5]}")
        if not min(losses) < losses[0]:
            raise AssertionError("gradient ascent: no iteration beat the first")
        if not tokens_txt.strip():
            raise AssertionError("gradient ascent: empty tokens file")
        embed_dim = loads(model_dir, device=dev).text.num_classes
        if emb.shape != (8, embed_dim) or emb.dtype != torch.float32 or emb.device.type != "cpu":
            raise AssertionError(f"gradient ascent: txtembeds {emb.shape} {emb.dtype}")
        results["gradient_ascent"] = {"first": losses[0], "best": min(losses)}

        log = []
        fv_out = os.path.join(work, "fv")
        t0 = time.perf_counter()
        out = run_cli(fv, ["--use_model", s8_dir, "--layer", str(FV_LAYER), "--feature",
                           str(FV_FEATURE), "--out", fv_out, "--deterministic",
                           "--device", dev], log)
        wall = time.perf_counter() - t0
        losses = [float(v) for _, v in log]
        secs["feature viz S/8 f32 xla (CLI)"] = (log[-1][0] - log[1][0]) / (len(log) - 2)
        print(out.strip())
        png = os.path.join(fv_out, f"s8_L{FV_LAYER}_F{FV_FEATURE}.png")
        with open(png, "rb") as f:
            img = decode_png(f.read())
        print(f"feature_viz.main: {len(log)} steps in {wall:.1f} s; loss step 0 "
              f"{losses[0]:.4f}, step {len(log) - 1} {losses[-1]:.4f}; PNG {img.shape}")
        if len(log) != fv.STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"feature viz: {len(log)} steps, losses {losses[:5]}")
        if not losses[-1] < losses[0]:
            raise AssertionError("feature viz: the last step's loss is not below step 0's")
        if img.shape != (224, 224, 3):
            raise AssertionError(f"feature viz: PNG {img.shape}")
        results["feature_viz"] = {"step0": losses[0], "last": losses[-1]}

        t0 = time.perf_counter()
        out = run_cli(nc, ["--use_model", model_dir, "--image", cat, "--topk", "3",
                           "--device", dev], [])
        print(out.strip())
        print(f"neuron_capture.main in {time.perf_counter() - t0:.1f} s")
        f32 = loads(model_dir, device=dev)
        lines = [l for l in out.splitlines() if l.startswith("layer ")]
        if len(lines) != len(f32.vision.transformer.resblocks) or "top neuron" not in out:
            raise AssertionError("neuron capture: not every layer reported")

        labels = [t.strip() for t in ADV_LABELS.split(",")]
        ztxt = f32.encode_text(f32.tokenize(labels)).clone()
        image01 = torch.as_tensor(advm._load_image01(f32, bat), device=device)
        probs0 = advm.classify(f32, image01, ztxt)
        pred, dog = int(probs0.argmax()), labels.index("a dog")
        mean = torch.tensor(f32.mean, device=device)
        std = torch.tensor(f32.std, device=device)

        def zs_loss(model, img, label):
            with torch.no_grad():
                return float(advm._zero_shot_loss(model.vision, img, mean, std, ztxt,
                                                  model.logit_scale, label))

        for mode, extra in (("untargeted", []), ("targeted", ["--target", "a dog"]),
                            ("unsigned", ["--unsigned"])):
            out_png = os.path.join(work, f"adv_{mode}.png")
            out = run_cli(advm, ["--use_model", model_dir, "--image", bat, "--labels",
                                 ADV_LABELS, "--out", out_png, "--device", dev] + extra, [])
            print(f"adversarial.main ({mode}):\n{out.strip()}")
            with open(out_png, "rb") as f:
                if decode_png(f.read()).shape != (224, 224, 3):
                    raise AssertionError(f"adversarial {mode}: PNG shape")
        eps = 8 / 255
        for mode in ("untargeted", "targeted", "unsigned"):
            if mode == "unsigned":
                adv_img = advm.adv(f32, image01, ztxt, pred, eps=eps)
            else:
                adv_img = advm.pgd(f32, image01, ztxt, dog if mode == "targeted" else pred,
                                   eps=eps, targeted=mode == "targeted")
            linf = float((adv_img - image01).abs().max())
            lo, hi = float(adv_img.min()), float(adv_img.max())
            probs1 = advm.classify(f32, adv_img, ztxt)
            clean_l, adv_l = zs_loss(f32, image01, pred), zs_loss(f32, adv_img, pred)
            print(f"{mode}: L-inf {linf:.6f} (eps {eps:.6f}), pixels in [{lo:.4f}, {hi:.4f}], "
                  f"loss at the clean prediction {clean_l:.4f} -> {adv_l:.4f}, p(a dog) "
                  f"{probs0[dog]:.4f} -> {probs1[dog]:.4f}")
            if linf > eps + 1e-6 or lo < 0.0 or hi > 1.0 or not np.isfinite(adv_l):
                raise AssertionError(f"adversarial {mode}: out of the eps ball or [0, 1]")
            # the unsigned attack moves by lr * |gradient|, which can leave the
            # f32 loss within rounding of the clean one: checked on eps only
            if mode == "untargeted" and adv_l < clean_l:
                raise AssertionError(f"adversarial {mode}: the loss went down")
            if mode == "targeted" and probs1[dog] < probs0[dog]:
                raise AssertionError("adversarial targeted: p(target) went down")
        results["adversarial"] = {"clean_prob_target": float(probs0[dog])}
    finally:
        os.chdir(cwd)
        for m, orig in zip(tools, originals):
            m.load_model = orig

    # -- the kernel route against the plain ones, on the same inputs --
    routes = {"fused": dict(dtype=torch.bfloat16, attn_impl="fused"),
              "bf16": dict(dtype=torch.bfloat16), "f32": {}}
    l14 = {r: loads(model_dir, device=dev, **kw) for r, kw in routes.items()}
    s8 = {r: loads(s8_dir, device=dev, **kw) for r, kw in routes.items()}
    depth_l = len(l14["f32"].vision.transformer.resblocks)
    depth_s = len(s8["f32"].vision.transformer.resblocks)

    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    fv_img = fv.new_init(gen, 224)
    fv_draws = fv.draw_augs(gen, 224)
    grads, losses, profiles = {}, {}, {}
    for r, m in s8.items():
        step, opt = fv.build_step(m, FV_LAYER, FV_FEATURE)
        run = lambda: step(fv_img, opt.init(fv_img), fv_draws)  # noqa: E731
        if r == "fused":
            counted(run, block_launches(depth_s, FV_LAYER + 1),
                    f"feature viz step on fused bf16 (S/8, layer {FV_LAYER})", totals)
        loss_fn = fv.build_loss(m, FV_LAYER, FV_FEATURE)
        x = fv_img.clone().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(x, fv_draws)
            (grads[r],) = torch.autograd.grad(loss, x)
        losses[r] = float(loss.detach())
        secs[f"feature viz S/8 {r}"] = step_seconds(run)
        if r != "bf16":
            profiles[f"feature viz S/8 {r}"] = device_profile(run,
                                                              1e3 * secs[f"feature viz S/8 {r}"])
    print(f"feature viz step 0 loss: {losses}")
    route_cosines("feature viz step 0 input gradient (S/8)", grads)

    img01 = torch.as_tensor(advm._load_image01(l14["f32"], bat), device=device)
    grads = {}
    for r, m in l14.items():
        def pgd_grad(m=m):
            x = img01.clone().requires_grad_(True)
            with torch.enable_grad():
                loss = advm._zero_shot_loss(m.vision, x, mean, std, ztxt, m.logit_scale, pred)
                return torch.autograd.grad(loss, x)[0]
        if r == "fused":
            grads[r] = counted(pgd_grad, block_launches(depth_l, depth_l),
                               "PGD input gradient on fused bf16 (L/14)", totals)
        else:
            grads[r] = pgd_grad()
        secs[f"PGD L/14 {r}"] = step_seconds(
            lambda m=m: advm.pgd(m, img01, ztxt, pred, iters=10), iters=1) / 10
        if r != "bf16":
            profiles[f"PGD L/14 {r}"] = device_profile(
                lambda m=m: advm.pgd(m, img01, ztxt, pred, iters=1), 1e3 * secs[f"PGD L/14 {r}"])
    route_cosines("PGD input gradient (L/14)", grads)

    with open(cat, "rb") as f:
        cat_img = decode_png(f.read())
    acts, zimg = {}, {}
    for r, m in l14.items():
        if r == "fused":
            acts[r] = counted(lambda m=m: nc.capture_gelu(m, cat_img), block_launches(depth_l, 0),
                              "GELU capture on fused bf16 (L/14)", totals)
        else:
            acts[r] = nc.capture_gelu(m, cat_img)
        secs[f"capture L/14 {r}"] = step_seconds(lambda m=m: nc.capture_gelu(m, cat_img))
        if r != "bf16":
            profiles[f"capture L/14 {r}"] = device_profile(
                lambda m=m: nc.capture_gelu(m, cat_img), 1e3 * secs[f"capture L/14 {r}"])
        zimg[r] = m.encode_image(m.preprocess(cat_img)[None].astype(np.float32))
    shapes = {a.shape for a in acts["f32"].values()}
    vis = l14["f32"].vision
    want_shape = ((l14["f32"].image_size // vis.conv1.stride[0]) ** 2 + 1,
                  vis.transformer.resblocks[0].mlp.c_fc.out_features)
    print(f"capture: {len(acts['f32'])} layers of {shapes}")
    if sorted(acts["f32"]) != list(range(depth_l)) or shapes != {want_shape}:
        raise AssertionError(f"capture: {sorted(acts['f32'])} {shapes}")
    worst = min(range(depth_l), key=lambda i: flat_cos(torch.from_numpy(acts["fused"][i]),
                                                       torch.from_numpy(acts["bf16"][i])))
    for i in sorted({0, worst, depth_l - 1}):
        route_cosines(f"GELU capture layer {i}", {r: torch.from_numpy(a[i]) for r, a in acts.items()})
    for i in range(depth_l):
        if flat_cos(torch.from_numpy(acts["fused"][i]), torch.from_numpy(acts["bf16"][i])) < ROUTE_COS:
            raise AssertionError(f"capture layer {i}: fused vs plain bf16 below {ROUTE_COS}")
    route_cosines("image embedding (L/14)", zimg)

    image = ga.load_normalized(l14["f32"], cat)
    for r, m in l14.items():
        step, opt = ga.build_step(m, m.context_length, ga.N_TOKENS, pad_id=0)
        gen = torch.Generator(device=device).manual_seed(SEED + 11)
        normu = torch.randn((8, ga.N_TOKENS, m.vocab_size), generator=gen, device=device)
        draws = ga.draw_step(gen, 8, ga.N_TOKENS, m.vocab_size)
        run = lambda step=step, opt=opt, normu=normu, draws=draws: step(  # noqa: E731
            normu, opt.init(normu), image, draws)
        if r == "fused":
            out = counted(run, block_launches(depth_l, 0),
                          "gradient ascent step on fused bf16 (L/14)", totals)
            if not torch.isfinite(out[2]):
                raise AssertionError("gradient ascent on fused: loss not finite")
        secs[f"gradient ascent L/14 {r}"] = step_seconds(run)
        if r != "bf16":
            profiles[f"gradient ascent L/14 {r}"] = device_profile(
                run, 1e3 * secs[f"gradient ascent L/14 {r}"])

    fused_t = loads(s8_dir, device=dev, dtype=torch.bfloat16, attn_impl="fused_t",
                    fast_gelu=True)
    try:
        nc.capture_gelu(fused_t, cat_img)
    except GeluCaptureError as e:
        print(f"capture on fused_t raises by name: {e}")
    else:
        raise AssertionError("capture on fused_t returned without GELU outputs")

    for k, v in secs.items():
        print(f"seconds an iteration, {k}: {v:.6f}; {profiles.get(k, 'not profiled')}")
    results["seconds"] = secs
    with torch.no_grad():
        results["frozen_weight_cost"] = frozen_weight_cost(fa, gk, device)
    loads.models.clear()
    torch.cuda.empty_cache()
    results["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 20 in {results['phase_s']:.1f} s")
    return results


# ---------------------------------------------------------------------------
# Webdataset pretraining and the resolution curriculum (phase 21)
# ---------------------------------------------------------------------------

# BASELINE.json configs 4 and 5 through main_clip: ViT-B/16 + text B +
# decoder L (the JAX default config, coca, concat, remat=full), bf16 on f32
# master weights, on webdataset tar shards written by the script.
CUR_ARG = "img=B/16,txt_name=B,dtype=bfloat16"
CUR_SHARDS, CUR_RECORDS, CUR_H, CUR_W = 4, 512, 256, 320
CUR_WORKERS = 8
# Phase 21's depth, cut from the 12 blocks of every tower (the full widths
# kept) to make room for phase 23: a run's start-up, init and 3 GB train
# state scale with it
CUR_DEPTH = {"image": 4, "text": 4, "text_decoder_config": 4}
CUR_IMG_BLOCKS, CUR_DEC_BLOCKS = CUR_DEPTH["image"], CUR_DEPTH["text_decoder_config"]
# (name, res, batch, grad_accum, steps, mask_ratio): pretraining at 112 with
# half the patch tokens masked, then the 224 and 384 finetunes
CUR_STAGES = (("stage 1", 112, 1024, 4, 3, 0.5), ("stage 2", 224, 512, 2, 3, 0.0),
              ("stage 3", 384, 256, 4, 2, 0.0))
CUR_LOAD_TRANSFORM = ("load_transform", 384, 256, 4, 1, 0.0)  # from a learned-posemb 224 state
CUR_CHECK_BATCH = 256  # GradCache and the kernel route on the card
# #9 (L, D, heads, causal, prefix) at the slice's lengths: the image tower at
# 112 masked (1 + 24), 112 (1 + 49), 224 (1 + 196) and 384 (1 + 576), and the
# concat decoder at the masked stage (24 image + 79 text tokens + 128 queries)
CUR_BLOCK_SHAPES = ((25, 768, 12, False, 0), (50, 768, 12, False, 0), (197, 768, 12, False, 0),
                    (577, 768, 12, False, 0), (231, 768, 12, True, 103))
# the main path's batch at each of them (a microbatch of its stage)
CUR_TIMED = ((256, (25, 768, 12, False, 0)), (256, (197, 768, 12, False, 0)),
             (64, (577, 768, 12, False, 0)), (256, (231, 768, 12, True, 103)))


def curriculum_step_launches(accum: int) -> dict:
    """Launches of one GradCache step: pass 1 runs the image tower's
    CUR_IMG_BLOCKS fused blocks forward without autograd (#9 and the
    tanh-GELU MLP on its kernels), no decoder; pass 2 runs the image
    tower's and the concat decoder's fused blocks (CUR_DEC_BLOCKS) each
    forward twice and backward once
    (remat=full); `accum` microbatches each; the text tower is on xla."""
    from openvision_tpu_torch.ops import kernels

    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for per, n in ((LAUNCHES_PER_BLOCK, CUR_IMG_BLOCKS),
                   (FUSED_BLOCK_STEP, CUR_IMG_BLOCKS + CUR_DEC_BLOCKS)):
        for k, v in per.items():
            want[k] += v * n * accum
    return want


def write_curriculum_shards(work: str, images) -> str:
    """CUR_SHARDS webdataset tars of CUR_RECORDS records each: a PNG of
    CUR_H x CUR_W (a testcat image at an offset of its own, rows rolled),
    a .txt caption and a .json with llava_caption. Returns the glob."""
    import tarfile
    from concurrent.futures import ThreadPoolExecutor

    from openvision_tpu_torch.data.ops_image import encode_png

    words = ("cat", "dog", "bat", "car", "tree", "house", "boat", "bird", "flower", "chair")
    n = CUR_SHARDS * CUR_RECORDS
    ih, iw = images[0].shape[:2]

    def record(i):
        canvas = np.full((CUR_H, CUR_W, 3), (37 * i) % 256, np.uint8)
        y, x = (5 * i) % (CUR_H - ih + 1), (11 * i) % (CUR_W - iw + 1)
        canvas[y:y + ih, x:x + iw] = np.roll(images[i % len(images)], 3 * (i // 9), axis=0)
        a, b = words[i % 10], words[(i // 10) % 10]
        return (encode_png(canvas), f"a photo of a {a} next to a {b}",
                f"a detailed picture: a {a} stands beside a {b}, seen from angle {i % 360}.")

    out = os.path.join(work, "shards")
    os.makedirs(out)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        records = list(pool.map(record, range(n)))
    for s in range(CUR_SHARDS):
        with tarfile.open(os.path.join(out, f"train-{s:05d}.tar"), "w") as tf:
            for i in range(s * CUR_RECORDS, (s + 1) * CUR_RECORDS):
                png, txt, llava = records[i]
                for ext, data in (("png", png), ("txt", txt.encode()),
                                  ("json", json.dumps({"llava_caption": llava}).encode())):
                    info = tarfile.TarInfo(f"{i:07d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    mb = sum(len(r[0]) for r in records) / 1e6
    print(f"webdataset fixture: {CUR_SHARDS} shards x {CUR_RECORDS} records ({CUR_H}x{CUR_W} "
          f"PNG + txt + json, {mb:.0f} MB of PNG) in {time.perf_counter() - t0:.1f} s")
    return os.path.join(out, "*.tar")


def curriculum_config(res: int, batch: int, accum: int, steps: int, mask: float,
                      pattern: str, workers: int = CUR_WORKERS, base: str = CUR_ARG,
                      depth: dict | None = CUR_DEPTH, **extra) -> tuple:
    """(the config arg, the --override list) of one curriculum run (the
    model and dtype of `base`, each tower's blocks cut to `depth`), and the
    config dict they give."""
    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.main_clip import apply_override

    arg = f"res={res},{base},mask_ratio={mask}"
    overrides = [f"{k}={v}" for k, v in (
        ("input.data.name", "webdataset"), ("input.data.pattern", pattern),
        ("input.batch_size", batch), ("input.num_workers", workers), ("grad_accum", accum),
        ("total_steps", steps), ("log_training_steps", 1), ("ckpt_steps", steps),
        ("schedule.0.1.warmup_steps", min(1, steps - 1)),
        *((f"model.{t}.depth", d) for t, d in (depth or {}).items()), *extra.items())]
    config = get_config(arg)
    for ov in overrides:
        apply_override(config, ov)
    return arg, overrides, config


class _Tee(io.TextIOBase):
    """A text stream writing to a file and echoing main_clip's notes."""

    def __init__(self, log):
        self.log = log

    def write(self, text):
        self.log.write(text)
        for line in text.splitlines():
            if line.startswith("NOTE"):
                sys.__stdout__.write(f"    {line}\n")
        return len(text)


SAVE_NOTE = re.compile(r"(checkpoint of|restored) step (\d+): (\d+) bytes in ([0-9.]+) s")
SAVES = []  # (tag, "save" or "restore", step, bytes, seconds) of the trainer's train states


def print_saves(tag: str, log: str) -> list:
    """The trainer's Orbax saves and restores that `log` notes (step, bytes,
    seconds), printed with their rate and kept in SAVES."""
    found = [("save" if w == "checkpoint of" else "restore", int(a), int(b), float(c))
             for w, a, b, c in SAVE_NOTE.findall(log)]
    for what, step, nbytes, secs in found:
        print(f"{tag}: Orbax train state {what} of step {step}: {nbytes / 1e9:.3f} GB in "
              f"{secs:.2f} s ({nbytes / secs / 1e9:.3f} GB/s)")
        SAVES.append((tag, what, step, nbytes, secs))
    return found


def main_clip_run(arg: str, overrides, workdir: str, log_path: str, sigterm_after_step: int = 0,
                  device: str = "cuda"):
    """main_clip's main in this process (its output to `log_path`, its
    notes echoed), the launch counts set to 0 first; with
    `sigterm_after_step`, this process sends itself SIGTERM once that
    step's update is done, which the trainer's handler takes. Returns
    (0, seconds, the metrics rows)."""
    import contextlib
    import signal

    from openvision_tpu_torch import main_clip
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.train import step as tstep

    argv = ["--config", os.path.join(REPO, "openvision_tpu_torch", "configs", "openvision.py")
            + f":{arg}", "--workdir", workdir, "--device", device]
    for ov in overrides:
        argv += ["--override", ov]
    make_update_fn = tstep.make_update_fn

    def signalling(config, model, opt):
        update = make_update_fn(config, model, opt)

        def step(batch):
            out = update(batch)
            if opt.state["count"] == sigterm_after_step:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return step

    if sigterm_after_step:
        tstep.make_update_fn = signalling
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as log, contextlib.redirect_stdout(_Tee(log)):
            main_clip.main(argv)
    finally:
        tstep.make_update_fn = make_update_fn
    took = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(os.path.join(workdir, "metrics.jsonl"))]
    return 0, took, rows


def stage_report(tag: str, rows, steps_run: int, accum: int, batch: int, took: float,
                 totals: dict, profiled: int = 0) -> dict:
    """Checks a run's losses and launch counts (the last row's, this
    process's since it started) and prints its numbers (those of the
    `profiled` step apart)."""
    losses = [r["training_loss"] for r in rows if "training_loss" in r]
    launches = {k.split("/", 1)[1]: int(v) for k, v in rows[-1].items()
                if k.startswith("launches/")}
    want = {k: v * steps_run for k, v in curriculum_step_launches(accum).items() if v}
    timed = [r for r in rows if "step_ms" in r and r["step"] != profiled]
    step_ms = [r["step_ms"] for r in timed]
    wait = [r["host_wait_share"] for r in timed]
    peak = max(r.get("peak_gb", 0.0) for r in rows)
    print(f"{tag}: {len(losses)} steps in {took:.1f} s (in this process: shards index, init, "
          f"workers, steps, checkpoint); losses {[round(x, 4) for x in losses]}; launches "
          f"{launches}")
    print(f"{tag}: step ms {[round(x, 1) for x in step_ms]}, images/s "
          f"{[round(batch / (x / 1e3), 1) for x in step_ms]}, data-wait share "
          f"{[round(x, 4) for x in wait]}, peak {peak:.2f} GB  [{smi_line()}]")
    if len(losses) != steps_run or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    for k, v in launches.items():
        totals[k] += v
    return {"step_ms": step_ms, "images_per_s": [batch / (x / 1e3) for x in step_ms],
            "wait_share": wait, "peak_gb": peak, "losses": losses}


def pp_rates(pattern: str) -> dict:
    """Records/s of stage 1's input pipeline (webdataset read, PNG decode,
    inception crop to 112, color jitter, two tokenizations) with 0 and
    CUR_WORKERS worker processes: a batch of 1024 after a warm-up batch."""
    from openvision_tpu_torch.data import pipeline

    rates = {}
    for workers in (0, CUR_WORKERS):
        _, _, cfg = curriculum_config(112, 1024, 4, 3, 0.5, pattern, workers=workers)
        loader, _ = pipeline.training(cfg["input"], seed=SEED)
        try:
            t0 = time.perf_counter()
            next(loader)
            t1 = time.perf_counter()
            next(loader)  # the pool works on it only once the first is returned
            t2 = time.perf_counter()
        finally:
            loader.close()
        rates[workers] = 1024 / (t2 - t1)
        print(f"pp, {workers} workers: {rates[workers]:.1f} records/s (first batch, with the "
              f"start-up: {t1 - t0:.2f} s)  [{smi_line()}]")
    return rates


def gradcache_checks(pattern: str, device) -> None:
    """GradCache and the kernel route on the card, on stage 1's model (seed 0)
    and one batch of CUR_CHECK_BATCH: grad_accum=4 against grad_accum=1 with
    masking off (the two paths draw their masks differently: accum=1 from the
    step's generator, accum=4 from one per microbatch, as the JAX step folds
    the microbatch index into its key), L = 50; then at mask_ratio 0.5 (L =
    25) the kernel route against plain bf16 (attn_impl and dec_attn_impl
    xla), both at grad_accum=4 on the same draws. Loss within 2**-7
    relative, global gradient cosine >= 0.999. Last, at mask_ratio 0.5 with
    drop-path 0.1 in every tower and the step's generator, pass 2 must
    replay pass 1's draws: each microbatch's embeddings in pass 2 against
    the ones pass 1 cached, cosine >= 0.999 per row (the image tower's
    blocks take fused_qkv_attention, #7/#8, under drop-path)."""
    import torch

    from openvision_tpu_torch.data import pipeline
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.train import step as tstep

    _, _, cfg = curriculum_config(112, CUR_CHECK_BATCH, 4, 1, 0.5, pattern, workers=0)
    loader, _ = pipeline.training(cfg["input"], seed=SEED)
    batch = tstep.to_device(next(loader), device)
    model = init_params(tstep.build_model(cfg).to(device), SEED)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model

    def grads(accum: int, mask: float, plain: bool = False, drop_path: float = 0.0):
        c = curriculum_config(112, CUR_CHECK_BATCH, accum, 1, mask, pattern, workers=0)[2]
        for tower in ("image", "text", "text_decoder_config"):
            if plain:
                c["model"][tower]["attn_impl"] = "xla"
            if drop_path:
                c["model"][tower]["drop_path"] = drop_path
        m = tstep.build_model(c).to(device)
        opt = tstep.init_train_state(c, m, total_steps=10, params=state)
        t0 = time.perf_counter()
        meas, g = tstep.make_grad_fn(c, m, opt)(batch, rng=tstep.step_generator(SEED, 0))
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        out = float(meas["training_loss"]), {n: t.detach().float().clone() for n, t in g.items()}
        del m, opt, g
        torch.cuda.empty_cache()
        return out, took

    for label, (a, b) in (
            ("grad_accum=4 vs grad_accum=1, kernels, L=50", ((4, 0.0), (1, 0.0))),
            ("kernels vs plain bf16, grad_accum=4, mask 0.5 (L=25)", ((4, 0.5), (4, 0.5, True)))):
        (la, ga_), ta = grads(*a)
        (lb, gb), tb = grads(*b)
        glob, (worst, name) = grad_cosines(ga_, gb)
        print(f"  {label}: losses {la:.6f} vs {lb:.6f} (rel {abs(la - lb) / abs(lb):.3e}), "
              f"gradient cosine global {glob:.6f}, min per-tensor {worst:.6f} ({name}); "
              f"{ta:.2f} s and {tb:.2f} s a gradient (first call)")
        if abs(la - lb) > 2**-7 * abs(lb) or glob < 0.999:
            raise AssertionError(f"{label}: loss {la} vs {lb}, gradient cosine {glob}")
        del ga_, gb

    seen = []
    forward = tstep.forward

    def recording(config, model, mb, rng=None, caption=True):
        zimg, ztxt, out = forward(config, model, mb, rng, caption)
        seen.append(torch.cat([zimg, ztxt]).detach().float())
        return zimg, ztxt, out

    tstep.forward = recording
    try:
        (loss, g), took = grads(4, 0.5, drop_path=0.1)
    finally:
        tstep.forward = forward
    del g
    if len(seen) != 8:
        raise AssertionError(f"GradCache ran {len(seen)} tower forwards, not 2 x 4")
    cos = min(torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
              for a, b in zip(seen[:4], seen[4:]))
    print(f"  pass 2 replays pass 1's draws (grad_accum=4, mask 0.5, drop-path 0.1, kernels): "
          f"min row cosine of the embeddings {cos:.6f}, loss {loss:.6f}; {took:.2f} s a gradient")
    if not cos >= 0.999 or not np.isfinite(loss):
        raise AssertionError(f"GradCache pass 2 drew other masks than pass 1: cosine {cos}, "
                             f"loss {loss}")


def trace_busy(path: str) -> tuple:
    """(device busy ms, traced ms) of a torch.profiler Chrome trace: the
    union of its GPU kernels' intervals, and the span from its first event
    to its last."""
    events = json.load(open(path))["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    wall = max(e["ts"] + e.get("dur", 0) for e in timed) - min(e["ts"] for e in timed)
    return busy / 1e3, wall / 1e3


def curriculum_phase(images, work: str, device, totals: dict, worst: dict) -> dict:
    """Phase 21: webdataset pretraining and the resolution curriculum."""
    import torch

    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.ops import fused_attention as fa
    from openvision_tpu_torch.train import checkpoint as ckpt_lib
    from openvision_tpu_torch.train import step as tstep

    t_phase = time.perf_counter()
    dev = torch.device(device).type
    pattern = write_curriculum_shards(work, images)
    rates = pp_rates(pattern)

    print("#9 and #10 against their plain twins at the slice's lengths (B=8, D=768, 12 heads):")
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    with torch.no_grad():
        check_cases(block_cases(fa, device, gen, 8, CUR_BLOCK_SHAPES), worst)
        check_bwd_cases(fused_block_bwd_cases(fa, device, gen, 8, None, CUR_BLOCK_SHAPES), worst)
    torch.cuda.empty_cache()

    print("GradCache and the kernel route on the card:")
    gradcache_checks(pattern, device)

    results, ckpt = {}, None
    for name, res, batch, accum, steps, mask in CUR_STAGES:
        wd = os.path.join(work, name.replace(" ", ""))
        extra = {"ft_from": ckpt} if ckpt else {}
        if name == "stage 1":  # the profiler hook traces the last step (step 2 runs without)
            extra.update(profile_start_step=steps, profile_stop_step=steps)
        arg, ovs, _ = curriculum_config(res, batch, accum, steps, mask, pattern, **extra)
        tag = f"[{name}: res {res}, batch {batch}, grad_accum {accum}, mask {mask}]"
        if name == "stage 2":  # preempted after its first step, then resumed
            _, took, rows = main_clip_run(arg, ovs, wd, wd + ".log", 1, dev)
            saved = ckpt_lib.saved_steps(os.path.join(wd, "checkpoints"))
            log = open(wd + ".log").read()
            if len(saved) != 1 or not 1 <= saved[0] < steps or "preemption signal" not in log:
                raise AssertionError(f"{tag}: SIGTERM left checkpoints {saved}")
            print(f"{tag}: SIGTERM after step 1's update: checkpoint at step {saved[0]}, returned")
            first = stage_report(f"{tag} before SIGTERM", rows, saved[0], accum, batch, took,
                                 totals)
            _, took, rows = main_clip_run(arg, ovs, wd, wd + "-resumed.log", device=dev)
            if f"resuming from step {saved[0]}" not in open(wd + "-resumed.log").read():
                raise AssertionError(f"{tag}: the rerun did not resume from step {saved[0]}")
            rows = [r for r in rows if r["step"] > saved[0]]
            second = stage_report(f"{tag} resumed", rows, steps - saved[0], accum, batch, took,
                                  totals)
            results[name] = {k: first[k] + second[k] if isinstance(first[k], list)
                             else max(first[k], second[k]) for k in first}
        else:
            profiled = steps if name == "stage 1" else 0
            _, took, rows = main_clip_run(arg, ovs, wd, wd + ".log", device=dev)
            results[name] = stage_report(tag, rows, steps, accum, batch, took, totals, profiled)
        if name == "stage 1":
            busy, wall = trace_busy(os.path.join(wd, "profile", f"trace-{steps}-{steps}.json"))
            results[name]["busy_ms"], results[name]["traced_ms"] = busy, wall
            step_ms = next(r["step_ms"] for r in rows if r["step"] == steps)
            print(f"{tag}: the profiler hook's trace of step {steps}: device busy {busy:.1f} ms "
                  f"of {wall:.1f} traced ({100 * (1 - busy / wall):.1f}% idle); the step under "
                  f"the profiler {step_ms:.1f} ms")
        ckpt = os.path.join(wd, "checkpoints")  # the next stage's ft_from: its newest step
        if ckpt_lib.saved_steps(ckpt)[-1:] != [steps]:
            raise AssertionError(f"{tag}: no checkpoint at step {steps}")
        for log in sorted(glob.glob(wd + "*.log")):
            print_saves(tag, open(log).read())

    # load_transform: a learned-posemb B/16 state written at 224, started at 384
    name, res, batch, accum, steps, mask = CUR_LOAD_TRANSFORM
    src_cfg = curriculum_config(224, batch, accum, steps, mask, pattern,
                                **{"model.image.posemb": "learn"})[2]
    src = init_params(tstep.build_model(src_cfg).to(device), SEED + 5)
    pe = src.visual.positional_embedding.shape
    src_path = os.path.join(work, "posemb_learn_224.npz")
    ckpt_lib.save_npz(src_path, {"params": dict(src.state_dict())})
    del src
    wd = os.path.join(work, "load_transform")
    arg, ovs, _ = curriculum_config(res, batch, accum, steps, mask, pattern,
                                    **{"model.image.posemb": "learn", "load_transform": src_path})
    _, took, rows = main_clip_run(arg, ovs, wd, wd + ".log", device=dev)
    tag = f"[load_transform: posemb {tuple(pe)} at 224 -> res {res}, batch {batch}]"
    results[name] = stage_report(tag, rows, steps, accum, batch, took, totals)
    print_saves(tag, open(wd + ".log").read())
    loaded = ckpt_lib.load_state_dict(os.path.join(wd, "checkpoints"), steps)
    got = tuple(np.asarray(loaded["visual.positional_embedding"]).shape)
    if got != (1 + (res // 16) ** 2, pe[1]):
        raise AssertionError(f"{tag}: position embedding {got}")
    print(f"{tag}: the trained state's position embedding {got}")

    print("#9 and #10 at the slice's shapes (CUDA events, graph replay, bound, plain, library):")
    times = {}
    with torch.no_grad():
        for b, shape in CUR_TIMED:
            for c in block_cases(fa, device, gen, b, (shape,)):
                times[c.label] = time_case(c)
            for c in fused_block_bwd_cases(fa, device, gen, b, None, (shape,)):
                times[c.label] = time_bwd_case(c)
            torch.cuda.empty_cache()
    results["pp_records_per_s"] = rates
    results["block_times"] = times
    results["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 21 in {results['phase_s']:.1f} s  [{smi_line()}]")
    return results


def curriculum_only() -> int:
    """``chip_smoke.py --curriculum``: the kernel build and phase 21 alone."""
    import torch

    sys.path.insert(0, REPO)
    from openvision_tpu_torch.data.ops_image import decode_png
    from openvision_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"nvidia-smi: {smi_line()}")
    t0 = time.perf_counter()
    kernels.lib()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    images = [decode_png(open(os.path.join(REPO, "testcat", f), "rb").read())
              for f in sorted(os.listdir(os.path.join(REPO, "testcat"))) if f.endswith(".png")]
    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        curriculum_phase(images, work, torch.device("cuda"), totals, {})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 21 launches: { {k: v for k, v in totals.items() if v} }")
    return 0


CKPT_STEP = 1000  # phase 22's Orbax step
CKPT_EXPORT = {"img": "L/14", "txt": "L"}  # CAPTION_ARG's towers, as convert.export names them
CKPT_COS = 0.99999  # the export's zimg against the npz path's, same weights and kernels
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _tree_leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def same_leaves(got, want, label: str) -> int:
    """Raises unless the two trees have the same leaf names and every leaf
    the same type, dtype, shape and bytes; returns the bytes compared."""
    import torch

    g, w = dict(_tree_leaves(got)), dict(_tree_leaves(want))
    if g.keys() != w.keys():
        raise AssertionError(f"{label}: leaf names differ: {sorted(g.keys() ^ w.keys())[:8]}")
    total = 0
    for k, b in w.items():
        a = g[k]
        if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
            raise AssertionError(f"{label}: {k} is {type(a).__name__}, expected "
                                 f"{type(b).__name__}")
        if isinstance(b, torch.Tensor):  # bf16 leaves: compare their bits
            a, b = a.view(torch.int16).numpy(), b.view(torch.int16).numpy()
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        if (a.dtype != b.dtype or a.shape != b.shape
                or not np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))):
            raise AssertionError(f"{label}: {k} differs ({a.dtype}{a.shape} against "
                                 f"{b.dtype}{b.shape})")
        total += b.nbytes
    return total


def _du(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def checkpoint_phase(ckpt: str, images, names, work: str, device, totals: dict,
                     want_ids: dict | None = None) -> dict:
    """Phase 22: phase 5's concat CoCa weights (the npz `ckpt`) through the
    Orbax writer and reader, the OpenCLIP export, the zero-shot path on
    fused_t, the caption CLI's --step and the daemon's caption_step, and the
    committed fixtures. `want_ids`: phase 5's greedy ids by (fusion,
    dec_impl); None: computed here from the npz as phase 5 does."""
    import contextlib
    import ctypes.util
    import dataclasses

    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.convert import export as texport
    from openvision_tpu_torch.models.encoder import cast_block_matrices
    from openvision_tpu_torch.serving import server as srv
    from openvision_tpu_torch.tools import caption as tcap
    from openvision_tpu_torch.tools import zero_shot
    from openvision_tpu_torch.tools.model_io import load_model
    from openvision_tpu_torch.train import checkpoint as ck
    from openvision_tpu_torch.train.step import build_model

    t_phase = time.perf_counter()
    res = {}
    print(f"codec libraries: zstd {ctypes.util.find_library('zstd')}, "
          f"lz4 {ctypes.util.find_library('lz4')}")

    # (a) the full-width train state written as Orbax and read back
    t0 = time.perf_counter()
    params = ck.load_npz(ckpt)["params"]
    res["npz_s"] = time.perf_counter() - t0
    nbytes = sum(np.asarray(v).nbytes for _, v in _tree_leaves(params))
    root = os.path.join(work, "orbax")
    state = {"params": params, "opt": {"count": np.asarray(CKPT_STEP, np.int32), "mu": params}}
    t0 = time.perf_counter()
    ck.save_orbax(root, CKPT_STEP, state)
    res["write_s"] = time.perf_counter() - t0
    res["disk_bytes"] = _du(root)
    t0 = time.perf_counter()
    back = ck.restore_params(root)
    res["read_s"] = time.perf_counter() - t0
    read = same_leaves(back, params, "[22a] restore_params against phase 5's npz")
    del back
    res["write_bytes"], res["read_bytes"] = 2 * nbytes, read
    print(f"[22a] {len(dict(_tree_leaves(params)))} leaves, {nbytes / 1e9:.3f} GB of params; "
          f"npz load {res['npz_s']:.2f} s ({nbytes / res['npz_s'] / 1e9:.2f} GB/s)")
    print(f"[22a] save_orbax (params + opt.mu, {2 * nbytes / 1e9:.3f} GB of arrays, "
          f"{res['disk_bytes'] / 1e9:.3f} GB on disk): {res['write_s']:.2f} s "
          f"({2 * nbytes / res['write_s'] / 1e9:.2f} GB/s)")
    print(f"[22a] restore_params ({read / 1e9:.3f} GB): {res['read_s']:.2f} s "
          f"({read / res['read_s'] / 1e9:.2f} GB/s); every leaf bit-equal")

    # (b) export, then the zero-shot path on the export against the npz path
    export_dir = os.path.join(work, "orbax_export")
    t0 = time.perf_counter()
    res["probe"] = texport.export(root, export_dir, **CKPT_EXPORT, res=RES,
                                  out_dim=int(params["img"]["head"]["kernel"].shape[1]),
                                  context_length=TOKEN_LEN, vocab_size=VOCAB, device=device)
    print(f"[22b] convert.export in {time.perf_counter() - t0:.1f} s; parity probe max|delta| "
          f"{res['probe']:.3e}")
    del params, state
    em = load_model(export_dir, dtype=torch.bfloat16, attn_impl="fused_t", fast_gelu=True,
                    device=device)
    cfg = get_config(caption_arg("concat", "fused") + ",attn_impl=fused_t")
    cfg["model"]["text"]["attn_impl"] = "xla"  # load_model's text tower
    cfg["model"]["image"]["output_tokens"] = cfg["model"]["text"]["output_tokens"] = False
    clip = build_model(cfg)
    clip.load_state_dict(ck.load_state_dict(ckpt))
    clip = clip.to(device).eval().requires_grad_(False)
    cast_block_matrices(clip, torch.bfloat16)
    nm = dataclasses.replace(em, vision=clip.visual, text=clip.text)
    batch = np.stack([em.preprocess(im) for im in images]).astype(np.float32)
    per_encode = {k: v * IMG_BLOCKS for k, v in LAUNCHES_PER_BLOCK.items()}

    def zero_shot_path(m):
        with contextlib.redirect_stdout(io.StringIO()):
            return m.encode_image(batch), zero_shot.rank(m, names, images)

    z_e, rank_e = counted(lambda: zero_shot_path(em),
                          {k: v * (1 + len(images)) for k, v in per_encode.items()},
                          "[22b] export on fused_t: one batch encode + the zero-shot ranking",
                          totals)
    z_n, rank_n = zero_shot_path(nm)
    cos = (z_e * z_n).sum(-1)
    order = [[np.argsort(-np.asarray(r[3])).tolist() for r in ranks] for ranks in (rank_e, rank_n)]
    res["zimg_cos"] = cos.min().item()
    print(f"[22b] zimg cosine, export against the npz path (fused_t, bf16): min "
          f"{res['zimg_cos']:.7f}, max|delta| {(z_e - z_n).abs().max().item():.3e}; "
          f"best labels {[r[1] for r in rank_e]}")
    if res["zimg_cos"] < CKPT_COS or not torch.isfinite(z_e).all():
        raise AssertionError(f"[22b] zimg cosine {res['zimg_cos']} < {CKPT_COS}")
    if order[0] != order[1]:
        raise AssertionError(f"[22b] the rankings differ: {order[0]} against {order[1]}")
    del em, nm, clip, z_e, z_n
    torch.cuda.empty_cache()

    # (c) the caption CLI's --step and the daemon's caption_step on the Orbax directory
    cli_arg, daemon_arg = caption_arg("concat", "flash"), caption_arg("concat", "fused")
    cap_batch = np.stack([tcap.preprocess(im, RES) for im in images]).astype(np.float32)
    if want_ids is None:
        want_ids = {}
        for key in (("concat", "flash"), ("concat", "fused")):
            cap, _ = tcap.build_captioner(get_config(caption_arg(*key)), ckpt, device=device)
            want_ids[key] = cap(cap_batch).cpu()
            del cap
    built, build = {}, tcap.build_captioner

    def keep(*a, **kw):
        built["cap"] = build(*a, **kw)
        return built["cap"]

    testcat, out = os.path.join(REPO, "testcat"), io.StringIO()

    def cli():
        with contextlib.redirect_stdout(out):
            tcap.main(["--checkpoint", root, "--step", str(CKPT_STEP), "--config", cli_arg,
                       "--image_folder", testcat, "--device", torch.device(device).type])

    tcap.build_captioner = keep
    try:
        t0 = time.perf_counter()
        counted(cli, expected_caption_launches("concat", "flash"), "[22c] caption CLI", totals)
    finally:
        tcap.build_captioner = build
    print(out.getvalue().splitlines()[0])
    cap, tok = built["cap"]
    want = [f"{os.path.join(testcat, n)}\t{tok.decode(row)}"
            for n, row in zip(names, want_ids[("concat", "flash")].tolist())]
    if out.getvalue().strip().splitlines() != want:
        raise AssertionError(f"[22c] the CLI's captions differ from phase 5's: "
                             f"{out.getvalue()[-2000:]}")
    if not torch.equal(cap(cap_batch).cpu(), want_ids[("concat", "flash")]):
        raise AssertionError("[22c] the CLI's captioner gives other ids than phase 5's")
    print(f"[22c] caption CLI --checkpoint <orbax> --step {CKPT_STEP} (concat / flash): "
          f"{len(want)} captions, ids equal to phase 5's, in {time.perf_counter() - t0:.1f} s")
    del cap, built
    t0 = time.perf_counter()
    capsvc = srv.CaptionService(get_config(daemon_arg), root, step=CKPT_STEP,
                                max_batch=DAEMON_MAX_BATCH, max_wait_ms=100.0, device=device)
    try:
        ids = counted(lambda: capsvc.captioner(torch.from_numpy(cap_batch).to(device)),
                      expected_caption_launches("concat", "fused"),
                      "[22c] CaptionService(step) captioner", totals)
        if not torch.equal(ids.cpu(), want_ids[("concat", "fused")]):
            raise AssertionError("[22c] the daemon's captioner gives other ids than phase 5's")
        # the route's preprocessing (caption_image_bytes) first, then one burst of submits
        rows = [tcap.preprocess(open(os.path.join(testcat, n), "rb").read(), RES)
                .astype(np.float32) for n in names]
        futures = [capsvc.batcher.submit(r) for r in rows]
        got = [f.result(timeout=300) for f in futures]
        padded = np.zeros((srv.bucket_size(len(images), DAEMON_MAX_BATCH),) + cap_batch.shape[1:],
                          np.float32)
        padded[:len(images)] = cap_batch
        rows = capsvc.captioner(torch.from_numpy(padded).to(device))[:len(images)].tolist()
        if capsvc.stats()["batches"] != 1 or got != [capsvc.tok.decode(r) for r in rows]:
            raise AssertionError(f"[22c] the caption route's batch {capsvc.stats()} gave {got}")
    finally:
        capsvc.stop()
    print(f"[22c] CaptionService(<orbax>, step={CKPT_STEP}) (concat / fused): ids equal to "
          f"phase 5's; the route's one batch of {len(rows)} PNGs captioned as its padded "
          f"forward, in {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(export_dir, ignore_errors=True)

    # (d) the committed fixtures: JAX-written Orbax (ocdbt.process_0, sharded chunks) and legacy
    orbax = os.path.join(FIXTURES, "orbax_train_state")
    n = same_leaves(ck.restore_params(orbax, subtree=None), ck.load_npz(orbax + ".npz"),
                    "[22d] the Orbax fixture")
    legacy = os.path.join(FIXTURES, "legacy_ts")
    m = same_leaves(ck.load_legacy_ts(legacy), ck.load_npz(legacy + ".npz"),
                    "[22d] the legacy fixture")
    print(f"[22d] the Orbax fixture ({n} bytes) and the legacy blosc/lz4 fixture ({m} bytes) "
          "equal their npz")
    for name in ("orbax_zarr3", "orbax_numbered", "orbax_two_process"):
        root = os.path.join(FIXTURES, name)
        n = same_leaves(ck.restore_params(root, subtree=None), ck.load_npz(root + ".npz"),
                        f"[22d] the {name} fixture")
        print(f"[22d] {name} (Orbax's zarr v3 / numbered OCDBT manifest / two-process save, "
              f"written by JAX's Orbax): {n} bytes equal its npz")
    res["chain"] = chain_step(device)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 22 in {res['phase_s']:.1f} s  [{smi_line()}]")
    return res


def chain_step(device) -> dict:
    """Phase 22e: the committed JAX train state whose ``opt`` is the real
    ``optim.make`` chain (tests/fixtures/orbax_chain: frozen params, two
    schedules, an lr multiplier, clipping; after 3 JAX updates) restored
    into the port's optimizer on the card, which applies the fixture's next
    gradients: params, mu and nu against JAX's result (mu within one bf16
    rounding, 2**-7 of its largest value, as JAX's jitted update keeps
    b1 * mu in f32; nu within 1e-6 of its largest value; each param within
    2**-7 of its update) and the count equal."""
    import torch

    from openvision_tpu_torch import optim
    from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict, recover_tree
    from openvision_tpu_torch.train import checkpoint as ck

    root = os.path.join(FIXTURES, "orbax_chain")
    with open(root + ".json") as f:
        meta = json.load(f)
    config = dict(meta["optimizer"], schedule=[tuple(x) for x in meta["optimizer"]["schedule"]])
    tree = ck.restore_params(root, subtree=None)
    params = {n: v.to(device) for n, v in jax_params_to_state_dict(tree["params"]).items()}
    before = {n: v.clone() for n, v in params.items()}
    opt = optim.Optimizer(config, params, sched_kw=meta["sched_kw"])
    opt.load_state_dict(optim.chain_to_state_dict(tree["opt"], opt.chain,
                                                  from_jax=jax_params_to_state_dict))
    with np.load(root + ".npz") as data:
        def part(prefix):
            return jax_params_to_state_dict(recover_tree(
                {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}))

        grads = {n: g.to(device) for n, g in part("grads/").items()}
        want = {w: part(f"want/{w}/") for w in ("params", "mu", "nu")}
        count = int(data["want/count"])
    opt.step(grads)
    torch.cuda.synchronize()
    worst = {"params": 0.0, "mu": 0.0, "nu": 0.0}
    for n, w in want["params"].items():
        step = (w - before[n].cpu()).abs().max().item()
        err = (params[n].cpu() - w).abs().max().item()
        worst["params"] = max(worst["params"], err / max(step, 1e-30))
        if err > 2**-7 * step + 1e-7:
            raise AssertionError(f"[22e] {n}: |param - JAX's| {err} over its update {step}")
    for what, tol in (("mu", 2**-7), ("nu", 1e-6)):
        if set(want[what]) != set(opt.live):
            raise AssertionError(f"[22e] {what}'s leaves differ from the live params")
        for n, w in want[what].items():
            err = (opt.state[what][n].float().cpu() - w).abs().max().item()
            rel = err / max(w.abs().max().item(), 1e-30)
            worst[what] = max(worst[what], rel)
            if rel > tol:
                raise AssertionError(f"[22e] {what} {n}: {rel} of its largest value")
    if opt.state["count"] != count:
        raise AssertionError(f"[22e] count {opt.state['count']}, JAX's {count}")
    print(f"[22e] the JAX optax chain (orbax_chain: {len(params)} params, {len(opt.frozen)} "
          f"frozen, layout {opt.chain}) restored on {device} and stepped: count {count} as "
          f"JAX's; worst params / update {worst['params']:.2e}, mu {worst['mu']:.2e}, nu "
          f"{worst['nu']:.2e} of their largest values")
    return worst


def checkpoints_only() -> int:
    """``chip_smoke.py --checkpoints``: the kernel build and phase 22 alone,
    on phase 5's concat checkpoint written here."""
    import torch

    sys.path.insert(0, REPO)
    from openvision_tpu_torch.data.ops_image import decode_png
    from openvision_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"nvidia-smi: {smi_line()}")
    t0 = time.perf_counter()
    kernels.lib()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    names = sorted(f for f in os.listdir(os.path.join(REPO, "testcat")) if f.endswith(".png"))
    images = [decode_png(open(os.path.join(REPO, "testcat", f), "rb").read()) for f in names]
    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ckpt = os.path.join(work, "caption_concat.npz")
        write_random_caption_checkpoint(ckpt, "concat", SEED)
        with torch.inference_mode():
            checkpoint_phase(ckpt, images, names, work, torch.device("cuda"), totals)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 22 launches: { {k: v for k, v in totals.items() if v} }")
    return 0


# ---------------------------------------------------------------------------
# The recipe on a process mesh (phase 23)
# ---------------------------------------------------------------------------

# BASELINE.json config 5 (ViT-L/14 at 160 -> 224) at the full widths, the JAX
# default CoCa config otherwise (concat, `fused` image tower and decoder, `xla`
# text, remat=full), bf16 on f32 masters, learned position embeddings (the
# load_transform start resamples them), on phase 21's webdataset shards, two
# ranks of a data=2 mesh on the one card over gloo.
MR_ARG = "img=L/14,txt_name=L,txt_decoder_name=L,dtype=bfloat16"
MR_RANKS = 2  # torchrun's processes: data=2
MR_TIMEOUT_S = 600  # the phase's torchrun launch
MR_WORKERS = 0  # input workers a rank: phase 21 measures them; here their start-up outweighs
# the pp of one or two steps
# The depth, cut to a third (8 image, 4 text and 4 decoder blocks of the 24,
# 12 and 12; the widths kept): at the full depth the phase took 342-360 s
# on the card (five torchrun launches, three 6.3 GB train states written and
# two read), which the script's 1200 s could not hold beside phases 1-22
MR_DEPTH = {"image": 8, "text": 4, "text_decoder_config": 4}
MR_IMG_BLOCKS, MR_DEC_BLOCKS = MR_DEPTH["image"], MR_DEPTH["text_decoder_config"]
# (res, global batch, grad_accum, steps, mask_ratio)
MR_STAGE = (160, 128, 2, 2, 0.5)  # SIGTERM to rank 1 in step 1, then the resume to step 2
MR_LOAD_TRANSFORM = (224, 64, 2, 1, 0.0)  # from the stage's checkpoint, evals after its step
# (a): three gradients of one global batch of 128 at 160 (mask 0.5), each on the mesh
# and in one process on the same params and batch
MR_GRAD_CASES = (
    ("coca, GradCache 2, drop-path 0.1", {"grad_accum": 2, "model.image.drop_path": 0.1}),
    ("siglip, GradCache 2", {"grad_accum": 2, "loss_type": "siglip",
                             "model.init_logit_bias": -10.0}),
    ("coca, global mode, accum 1", {"grad_accum": 1, "local_loss": False}))
MR_PROMPTS = "clip_best"  # 7 templates an IN-1K class (phase 19 runs the 81 of clip_paper)
MR_PRED_AGREE, MR_ACC_POINTS = 0.99, 0.5
# The runs' config file: the repo's config with a second zero-shot evaluator
# on the int8 encode (static scales from 64 images)
MR_CONFIG_PY = '''"""The repo's config with a second zero-shot evaluator on the int8 encode."""

from openvision_tpu_torch.configs.openvision import get_config as repo_config


def get_config(arg=None):
    c = repo_config(arg)
    c["evals"]["disclf_int8"] = dict(c["evals"]["disclf"], int8=True, int8_calibration=64,
                                     prefix="z/0shot_int8/")
    return c
'''


def recipe_config(res: int, batch: int, accum: int, steps: int, mask: float, pattern: str,
                  **extra) -> tuple:
    """(arg, overrides, config dict) of one phase-23 run or gradient."""
    return curriculum_config(res, batch, accum, steps, mask, pattern, workers=MR_WORKERS,
                             base=MR_ARG, depth=MR_DEPTH,
                             **{"model.image.posemb": "learn", **extra})


def mesh_step_launches(accum: int, decoder: bool = True) -> dict:
    """Launches of one GradCache step on a rank: as curriculum_step_launches,
    at the image tower's MR_IMG_BLOCKS blocks and the decoder's
    MR_DEC_BLOCKS (which pass 2 runs for coca only)."""
    from openvision_tpu_torch.ops import kernels

    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for per, n in ((LAUNCHES_PER_BLOCK, MR_IMG_BLOCKS),
                   (FUSED_BLOCK_STEP, MR_IMG_BLOCKS + MR_DEC_BLOCKS * decoder)):
        for k, v in per.items():
            want[k] += v * n * accum
    return {k: v for k, v in want.items() if v}


def mesh_grads(out_dir: str, pattern: str, device, report: dict) -> None:
    """Phase 23 (a) in one rank: the three MR_GRAD_CASES gradients of one
    global batch on a data=2 mesh (process 0 writes each one's loss and
    gradients), then this rank's step time at each stage, its peak memory
    and the collectives' share of a step, into `report`."""
    import torch

    from openvision_tpu_torch import parallel
    from openvision_tpu_torch.data import pipeline
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.parallel import mesh as mesh_mod
    from openvision_tpu_torch.train import checkpoint as ckpt
    from openvision_tpu_torch.train import step as tstep

    mesh = parallel.create_mesh(data=MR_RANKS, device_type="cuda")
    rank = parallel.rank()
    res, batch_size, accum, _, mask = MR_STAGE
    with parallel.use_mesh(mesh):
        batch = None
        for i, (label, extra) in enumerate(MR_GRAD_CASES):
            cfg = recipe_config(res, batch_size, extra.get("grad_accum", accum), 1, mask,
                                pattern, **{"input.num_workers": 0, **extra})[2]
            if batch is None:
                loader, _ = pipeline.training(cfg["input"], seed=SEED,
                                              rows=mesh.batch_rows(batch_size))
                batch = tstep.to_device(next(loader), device)
                loader.close()
            model = tstep.build_model(cfg).to(device)
            opt = tstep.init_train_state(cfg, model, total_steps=10, mesh=mesh)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            meas, grads = tstep.make_grad_fn(cfg, model, opt)(
                batch, rng=tstep.step_generator(SEED, 0))
            torch.cuda.synchronize()
            report["grads"][label] = {"s": time.perf_counter() - t0,
                                      "launches": {k: v for k, v in kernels.LAUNCHES.items() if v}}
            whole = ckpt.gather_leaves(grads, model, opt)
            if rank == 0:
                torch.save({"loss": float(meas["training_loss"]), "grads": whole},
                           os.path.join(out_dir, f"mesh_grads_{i}.pt"))
            del model, opt, grads, whole
            torch.cuda.empty_cache()
        for res_s, batch_s, accum_s, _, mask_s in (MR_STAGE, MR_LOAD_TRANSFORM):
            cfg = recipe_config(res_s, batch_s, accum_s, 1, mask_s, pattern,
                                **{"input.num_workers": 0})[2]
            loader, _ = pipeline.training(cfg["input"], seed=SEED, rows=mesh.batch_rows(batch_s))
            step_batch = next(loader)
            loader.close()
            model = tstep.build_model(cfg).to(device)
            opt = tstep.init_train_state(cfg, model, total_steps=10, mesh=mesh)
            update = tstep.make_update_fn(cfg, model, opt)
            torch.cuda.reset_peak_memory_stats()
            mesh_mod.COMM.update(timing=True, seconds=0.0, calls=0)
            t0 = time.perf_counter()
            update(step_batch)  # the first step, its collectives synchronized and timed
            torch.cuda.synchronize()
            timed_ms = (time.perf_counter() - t0) * 1e3
            mesh_mod.COMM["timing"] = False
            ms = cuda_ms(lambda: update(step_batch), iters=1, warmup=0)
            report["stages"][res_s] = {
                "batch": batch_s, "step_ms": ms, "images_per_s": batch_s / (ms / 1e3),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "timed_step_ms": timed_ms,
                "comm_ms": mesh_mod.COMM["seconds"] * 1e3, "comm_calls": mesh_mod.COMM["calls"]}
            del model, opt, update
            torch.cuda.empty_cache()


def _keep(rec: dict, key: str, value):
    rec[key] = value
    return value


def instrument_evaluators(evaluators, store: dict):
    """The trainer's evaluators, each run recording into store[name] what
    it computed: disclf's class embeddings and every image batch's zimg
    (padded rows included), its static int8 scales, counts and timings;
    retrieval's embeddings; each run's metrics and seconds."""
    import torch

    for name, ev, _, _ in evaluators:
        rec = store.setdefault(name, {})

        def run(train_state=None, ev=ev, rec=rec, orig=ev.run, **kw):
            zs = []
            if hasattr(ev, "class_matrix"):
                cm, embed, int8 = ev.class_matrix, ev.towers.embed_images, ev._int8_encoder
                ev.class_matrix = lambda tokens: _keep(rec, "classes", cm(tokens))
                ev.towers.embed_images = lambda x: zs.append(embed(x)) or zs[-1]
                ev._int8_encoder = lambda images, opt=None: (
                    lambda f: lambda im: zs.append(f(im)) or zs[-1])(int8(images, opt))
            else:
                emb = ev.embeddings
                ev.embeddings = lambda: _keep(rec, "embeddings", emb())
            t0 = time.perf_counter()
            try:
                out = orig(train_state, **kw)
            finally:
                for attr in ("class_matrix", "_int8_encoder", "embeddings"):
                    ev.__dict__.pop(attr, None)
                ev.towers.__dict__.pop("embed_images", None)
            rec.update(metrics=out, seconds=time.perf_counter() - t0,
                       scales=getattr(ev, "int8_scales", None), counts=getattr(ev, "counts", None),
                       timings=dict(getattr(ev, "timings", {})),
                       zimg=torch.cat(zs).float().cpu() if zs else None)
            if "classes" in rec:
                rec["classes"] = rec["classes"].float().cpu()
            if "embeddings" in rec:
                rec["embeddings"] = tuple(t.float().cpu() if torch.is_tensor(t) else t
                                          for t in rec["embeddings"])
            return out

        ev.run = run
    return evaluators


def mesh_recipe_worker(run_dir: str) -> int:
    """One rank of phase 23 (``chip_smoke.py --mesh-worker RUN_DIR``;
    torchrun starts it): (a)'s gradients and step times, then every
    main_clip run that RUN_DIR/runs.json lists, in turn, in this process,
    through main_clip's main. This rank's pid goes to RUN_DIR first, and
    again once the trainer has installed its SIGTERM handler (so the phase
    can signal one rank inside step 1 and kill every rank at its timeout);
    the launch counts start at 0 before each run; in a run marked
    ``capture`` the evaluators are instrumented and what they computed is
    written with this rank's launches."""
    import torch

    sys.path.insert(0, REPO)
    from openvision_tpu_torch import main_clip, parallel
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.train import trainer

    rank = int(os.environ["RANK"])
    with open(os.path.join(run_dir, f"pid_rank{rank}"), "w") as f:
        f.write(str(os.getpid()))
    install = trainer.install_preemption_flag

    def installed():
        flag = install()
        with open(os.path.join(run_dir, f"ready_rank{rank}"), "w") as f:
            f.write(str(os.getpid()))
        return flag

    trainer.install_preemption_flag = installed
    spec = json.load(open(os.path.join(run_dir, "runs.json")))
    device = parallel.maybe_distributed_init("cuda")
    report = {"rank": rank, "grads": {}, "stages": {}, "runs": {}}
    mesh_grads(run_dir, spec["pattern"], device, report)
    build = trainer.build_evaluators
    for run in spec["runs"]:
        store = {}
        trainer.build_evaluators = build if not run["capture"] else (
            lambda *a, store=store, **k: instrument_evaluators(build(*a, **k), store))
        if rank == 0:
            print(f"RUN {run['name']}", flush=True)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        main_clip.main(run["argv"])
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        report["runs"][run["name"]] = {"s": time.perf_counter() - t0, "launches": launches}
        if run["capture"]:
            torch.save({"rank": rank, "store": store, "launches": launches},
                       os.path.join(run_dir, f"evals_rank{rank}.pt"))
    trainer.build_evaluators = build
    with open(os.path.join(run_dir, f"mesh_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    parallel.sync("done")
    torch.distributed.destroy_process_group()
    return 0


def _descendants(root: int) -> list:
    """The pids of every process `root` started, and theirs (from /proc)."""
    parents = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    parents[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                pass
    found, frontier = [], [root]
    while frontier:
        frontier = [p for p, pp in parents.items() if pp in frontier]
        found += frontier
    return found


def kill_tree(root: int) -> None:
    """SIGKILL to `root`'s process group and to every process it started,
    each in its own session too (torchrun starts each worker in a session of
    its own, so killing torchrun's group alone would orphan them)."""
    import signal

    for pid in [root] + _descendants(root):
        for kill in (os.killpg, os.kill):
            try:
                kill(pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass


def _run_pids(run_dir: str) -> list:
    pids = []
    for name in os.listdir(run_dir):
        if name.startswith("pid_rank"):
            with open(os.path.join(run_dir, name)) as f:
                pids.append(int(f.read()))
    return pids


def mesh_launch(run_dir: str, log_path: str) -> tuple:
    """torchrun (MR_RANKS processes) of this script's --mesh-worker mode on
    RUN_DIR, in a session of its own; torchrun, the ranks and all they start
    are killed at MR_TIMEOUT_S. Once the first main_clip run has noted the
    model's size and rank 1 has installed its SIGTERM handler (its training
    loop is starting: step 1 is under way), rank 1 alone gets SIGTERM.
    Returns (seconds, the second at which SIGTERM was sent)."""
    import signal
    import socket
    import threading

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-u", "-m", "torch.distributed.run", "--nproc_per_node",
           str(MR_RANKS), "--master_port", str(port), os.path.abspath(__file__), "--mesh-worker",
           run_dir]

    def kill_all(proc):
        for pid in _run_pids(run_dir):
            kill_tree(pid)
        kill_tree(proc.pid)

    t0 = time.perf_counter()
    sent = None
    ready = os.path.join(run_dir, "ready_rank1")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)
        timer = threading.Timer(MR_TIMEOUT_S, kill_all, (proc,))
        timer.start()  # the launch and every process it starts end by the timeout
        try:
            for line in proc.stdout:
                log.write(line)
                if line.startswith(("NOTE", "RUN")):
                    print(f"    [{time.perf_counter() - t0:.1f} s] {line.rstrip()}")
                if sent is None and line.startswith("NOTE") and "M params" in line:
                    while not os.path.exists(ready) and proc.poll() is None \
                            and time.perf_counter() - t0 < MR_TIMEOUT_S:
                        time.sleep(0.01)
                    if os.path.exists(ready):
                        time.sleep(0.05)  # the file's content is written
                        os.kill(int(open(ready).read()), signal.SIGTERM)
                        sent = time.perf_counter() - t0
                        print(f"    SIGTERM to rank 1 alone at {sent:.1f} s")
            rc = proc.wait()
        finally:
            timer.cancel()
            if proc.poll() is None:
                kill_all(proc)
                proc.wait()
    took = time.perf_counter() - t0
    if rc != 0:
        print(open(log_path).read()[-8000:])
        raise AssertionError(f"phase 23's torchrun: exit {'timeout' if rc < 0 else rc}")
    if sent is None:
        raise AssertionError("rank 1 never installed its SIGTERM handler")
    return took, sent


def mesh_stage_report(tag: str, rows, steps_run: int, accum: int, batch: int, took: float,
                      totals: dict) -> dict:
    """Checks a mesh run's losses and process 0's launches (the last logged
    row's) and prints process 0's step ms, images/s and peak memory."""
    losses = [r["training_loss"] for r in rows if "training_loss" in r]
    last = [r for r in rows if "training_loss" in r][-1]  # the log row: launches so far
    launches = {k.split("/", 1)[1]: int(v) for k, v in last.items() if k.startswith("launches/")}
    want = {k: v * steps_run for k, v in mesh_step_launches(accum).items()}
    step_ms = [r["step_ms"] for r in rows if "step_ms" in r]
    peak = max(r.get("peak_gb", 0.0) for r in rows)
    print(f"{tag}: {len(losses)} steps in {took:.1f} s (main_clip in the ranks: init, steps, "
          f"checkpoint); losses {[round(x, 4) for x in losses]}; process 0's launches "
          f"{launches}")
    print(f"{tag}: process 0's step ms {[round(x, 1) for x in step_ms]}, images/s "
          f"{[round(batch / (x / 1e3), 1) for x in step_ms]}, peak {peak:.2f} GB (two ranks "
          f"share the card over gloo)  [{smi_line()}]")
    if len(losses) != steps_run or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    for k, v in launches.items():
        totals[k] += v
    return {"step_ms": step_ms, "peak_gb": peak, "losses": losses}


def mesh_grad_checks(out_dir: str, pattern: str, device) -> None:
    """Phase 23 (a) in this process: each MR_GRAD_CASES gradient on the
    whole batch, held against the mesh's (loss within 2**-7 relative,
    global gradient cosine >= 0.999; the smallest per-tensor cosine
    printed)."""
    import torch

    from openvision_tpu_torch.data import pipeline
    from openvision_tpu_torch.train import step as tstep

    res, batch_size, accum, _, mask = MR_STAGE
    batch = None
    for i, (label, extra) in enumerate(MR_GRAD_CASES):
        cfg = recipe_config(res, batch_size, extra.get("grad_accum", accum), 1, mask, pattern,
                            **{"input.num_workers": 0, **extra})[2]
        if batch is None:
            loader, _ = pipeline.training(cfg["input"], seed=SEED)
            batch = tstep.to_device(next(loader), device)
            loader.close()
        model = tstep.build_model(cfg).to(device)
        opt = tstep.init_train_state(cfg, model, total_steps=10)  # the mesh's init (seed 0)
        t0 = time.perf_counter()
        meas, grads = tstep.make_grad_fn(cfg, model, opt)(batch,
                                                          rng=tstep.step_generator(SEED, 0))
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        ref = {n: g.detach().float() for n, g in grads.items()}
        loss = float(meas["training_loss"])
        del model, opt, grads
        got = torch.load(os.path.join(out_dir, f"mesh_grads_{i}.pt"))
        mesh = {n: g.to(device) for n, g in got["grads"].items()}
        glob = grad_cosines(mesh, ref)[0]
        live = [n for n in ref if ref[n].abs().max() > 0]  # siglip leaves the decoder at zero
        worst, name = grad_cosines({n: mesh[n] for n in live}, {n: ref[n] for n in live})[1]
        rel = abs(got["loss"] - loss) / abs(loss)
        print(f"  [{label}] mesh loss {got['loss']:.6f} vs one process {loss:.6f} (rel "
              f"{rel:.3e}, bound {2**-7:.3e}); gradient cosine global {glob:.6f}, min "
              f"per-tensor {worst:.6f} ({name}); one process {took:.2f} s a gradient")
        if rel > 2**-7 or glob < 0.999 or set(mesh) != set(ref):
            raise AssertionError(f"{label}: mesh vs one process: loss {got['loss']} vs {loss}, "
                                 f"gradient cosine {glob}")
        del mesh, ref, got
        torch.cuda.empty_cache()


def _preds(zimg, classes, real: int):
    return (zimg[:real].float() @ classes.float().T).argmax(-1)


def _flat_scales(scales) -> list:
    if isinstance(scales, dict):
        return [t for k in sorted(scales) for t in _flat_scales(scales[k])]
    if isinstance(scales, (list, tuple)):
        return [t for v in scales for t in _flat_scales(v)]
    import torch

    return [torch.as_tensor(scales).float().cpu()]


def mesh_eval_checks(ranks: list, one: dict, n_images: int) -> dict:
    """The mesh's evaluators (each rank's store) against one process's on
    the same checkpoint: class embeddings per row cosine >= 0.999,
    predictions agree on >= MR_PRED_AGREE of the images, accuracy within
    MR_ACC_POINTS points, retrieval similarities within SIM_TOL, the int8
    static scales equal on every rank and to one process's. Returns the
    eval seconds, mesh and one process."""
    import torch

    shares = [len(a) for a in np.array_split(np.arange(n_images), len(ranks))]
    seconds = {}
    for name, want in one.items():
        got = [r["store"][name] for r in ranks]
        seconds[name] = {"mesh": [g["seconds"] for g in got], "one": want["seconds"]}
        if "classes" in want:
            cos = torch.nn.functional.cosine_similarity(got[0]["classes"], want["classes"], dim=-1)
            preds = torch.cat([_preds(g["zimg"], g["classes"], k) for g, k in zip(got, shares)])
            ref = _preds(want["zimg"], want["classes"], n_images)
            agree = float((preds == ref).float().mean())
            acc, acc1 = got[0]["metrics"][0][1], want["metrics"][0][1]
            print(f"  {name}: class embeddings ({len(cos)} classes) min row cosine "
                  f"{cos.min().item():.6f}; predictions agree on {100 * agree:.2f}% of "
                  f"{n_images} images; accuracy mesh {acc:.4f} vs one process {acc1:.4f}; "
                  f"counts {got[0]['counts']} vs {want['counts']}")
            if cos.min().item() < 0.999 or agree < MR_PRED_AGREE \
                    or abs(acc - acc1) * 100 > MR_ACC_POINTS or got[0]["counts"][1] != n_images:
                raise AssertionError(f"{name} on the mesh vs one process: cosine "
                                     f"{cos.min().item()}, agreement {agree}, accuracy {acc} vs "
                                     f"{acc1}")
            if want["scales"] is not None:
                flat = [_flat_scales(g["scales"]) for g in got]
                ref_s = _flat_scales(want["scales"])
                same_ranks = all(torch.equal(a, b) for f in flat[1:] for a, b in zip(flat[0], f))
                same_one = all(torch.equal(a, b) for a, b in zip(flat[0], ref_s))
                print(f"  {name}: {len(ref_s)} static scales, equal on every rank {same_ranks}, "
                      f"equal to one process's {same_one}")
                if not (same_ranks and same_one and len(flat[0]) == len(ref_s)):
                    raise AssertionError(f"{name}: int8 static scales differ")
        else:
            zimg, ztxt, _ = got[0]["embeddings"]
            zimg1, ztxt1, _ = want["embeddings"]
            err = float((zimg @ ztxt.T - zimg1 @ ztxt1.T).abs().max())
            print(f"  {name}: max|sim mesh - sim one process| {err:.2e} (bound {SIM_TOL:g}); "
                  f"{dict(got[0]['metrics'])}")
            if not err <= SIM_TOL or zimg.shape != zimg1.shape:
                raise AssertionError(f"{name}: similarities differ by {err}")
    return seconds


def mesh_recipe_phase(work: str, images, device, totals: dict) -> dict:
    """Phase 23: the recipe on a process mesh (see the module doc)."""
    import torch

    from openvision_tpu_torch.main_clip import apply_override, load_config
    from openvision_tpu_torch.train import checkpoint as ckpt_lib
    from openvision_tpu_torch.train import step as tstep
    from openvision_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    print("two ranks share the one card over gloo (NCCL takes one card a process): their times "
          "are not comparable with one process's")
    pattern = os.path.join(work, "shards", "*.tar")
    if not os.path.isdir(os.path.join(work, "shards")):
        pattern = write_curriculum_shards(work, images)
    tfds_dir, npz = os.path.join(work, "eval_tfds"), os.path.join(work, "eval_captions.npz")
    if not os.path.exists(npz):
        tfds_dir, npz, _ = write_eval_fixture(work, images)
    out_dir = os.path.join(work, "mesh")
    os.makedirs(out_dir)
    config_py = os.path.join(out_dir, "recipe_config.py")
    with open(config_py, "w") as f:
        f.write(MR_CONFIG_PY)

    def argv(arg, overrides, workdir):
        out = ["--config", f"{config_py}:{arg}", "--workdir", workdir, "--device", "cuda"]
        for ov in overrides:
            out += ["--override", ov]
        return out

    # (b): the stage at 160 (SIGTERM to rank 1 in step 1, then the rerun), the
    # load_transform start at 224 with the evals; (c): eval_only from its checkpoint
    stage_wd = os.path.join(out_dir, "stage160")
    res, batch, accum, steps, mask = MR_STAGE
    stage_arg, stage_ovs, _ = recipe_config(res, batch, accum, steps, mask, pattern)
    lt_res, lt_batch, lt_accum, lt_steps, lt_mask = MR_LOAD_TRANSFORM
    lt_wd, eval_wd = os.path.join(out_dir, "load_transform224"), os.path.join(out_dir, "eval_only")
    evals = {"evals.disclf.data_dir": tfds_dir, "evals.disclf.batch_size": EVAL_BATCH,
             "evals.disclf.prompt_templates": MR_PROMPTS, "evals.disclf.log_steps": lt_steps,
             "evals.retrieval.data_dir": npz, "evals.retrieval.batch_size": EVAL_BATCH,
             "evals.retrieval.log_steps": lt_steps}
    lt_arg, lt_ovs, _ = recipe_config(lt_res, lt_batch, lt_accum, lt_steps, lt_mask, pattern,
                                      **evals, **{"load_transform": os.path.join(
                                          stage_wd, "checkpoints")})
    lt_ovs += [f"evals.disclf_int8.{k.split('.', 2)[2]}={v}" for k, v in evals.items()
               if k.startswith("evals.disclf.")]
    final = os.path.join(lt_wd, "checkpoints")  # its newest (Orbax) step
    eval_ovs = [o for o in lt_ovs if not o.startswith("load_transform=")] + [
        "eval_only=True", f"ft_from={final}"]
    runs = [("stage 160", stage_arg, stage_ovs, stage_wd, False),
            ("stage 160 resumed", stage_arg, stage_ovs, stage_wd, False),
            ("load_transform 224", lt_arg, lt_ovs, lt_wd, False),
            ("eval_only", lt_arg, eval_ovs, eval_wd, True)]
    with open(os.path.join(out_dir, "runs.json"), "w") as f:
        json.dump({"pattern": pattern, "runs": [
            {"name": n, "argv": argv(a, o, w), "capture": c} for n, a, o, w, c in runs]}, f)
    torch.cuda.empty_cache()

    print("one torchrun of two ranks: (a) three gradients of one global batch of 128 at 160 "
          "(mask 0.5) and each rank's step times, then main_clip's runs in the same processes")
    took, sent = mesh_launch(out_dir, os.path.join(out_dir, "ranks.log"))
    ranks = [json.load(open(os.path.join(out_dir, f"mesh_rank{r}.json")))
             for r in range(MR_RANKS)]
    print(f"  the ranks done in {took:.1f} s; main_clip runs (rank 0, in-process seconds) "
          f"{ {n: round(r['s'], 1) for n, r in ranks[0]['runs'].items()} }")

    print("(a) the mesh's gradients against one process:")
    mesh_grad_checks(out_dir, pattern, device)
    results = {"ranks": {}}
    for r in ranks:
        for label, g in r["grads"].items():
            print(f"  rank {r['rank']} [{label}]: {g['s']:.2f} s a gradient (first call); "
                  f"launches {g['launches']}")
        for res_s, st in r["stages"].items():
            print(f"  rank {r['rank']} at {res_s} (b={st['batch']} global, GradCache 2): step "
                  f"{st['step_ms']:.1f} ms (CUDA events), {st['images_per_s']:.1f} images/s, "
                  f"peak {st['peak_gb']:.2f} GB; collectives {st['comm_ms']:.1f} ms over "
                  f"{st['comm_calls']} calls = {100 * st['comm_ms'] / st['timed_step_ms']:.1f}% "
                  f"of a timed step of {st['timed_step_ms']:.1f} ms (each synchronized)  "
                  f"[{smi_line()}]")
        results["ranks"][r["rank"]] = r["stages"]
    want_a = mesh_step_launches(2, decoder=False)  # siglip: no caption, no decoder
    for r in ranks:
        got_a = r["grads"][MR_GRAD_CASES[1][0]]["launches"]
        if got_a != want_a:
            raise AssertionError(f"(a) rank {r['rank']}, siglip GradCache: launches {got_a}, "
                                 f"expected {want_a}")

    print("(b) config 5 through main_clip on the mesh (process 0 writes the metrics):")
    log = open(os.path.join(out_dir, "ranks.log")).read()
    print_saves("[mesh recipe, process 0]", log)
    runs_s = {n: r["s"] for n, r in ranks[0]["runs"].items()}
    tag = f"[stage: res {res}, batch {batch}, grad_accum {accum}, mask {mask}]"
    if "preemption signal at step 1" not in log or "resuming from step 1" not in log:
        raise AssertionError(f"{tag}: SIGTERM to rank 1 did not stop the ranks at step 1, or "
                             "the rerun did not resume from it")
    print(f"{tag}: SIGTERM to rank 1 alone at {sent:.1f} s: both ranks stopped at step 1 and "
          "checkpointed; the rerun resumed from step 1")
    rows = [json.loads(line) for line in open(os.path.join(stage_wd, "metrics.jsonl"))]
    first = mesh_stage_report(f"{tag} before SIGTERM", [r for r in rows if r["step"] == 1], 1,
                              accum, batch, runs_s["stage 160"], totals)
    second = mesh_stage_report(f"{tag} resumed", [r for r in rows if r["step"] > 1], steps - 1,
                               accum, batch, runs_s["stage 160 resumed"], totals)
    results["stage 160"] = {k: first[k] + second[k] if isinstance(first[k], list)
                            else max(first[k], second[k]) for k in first}
    tag = f"[load_transform: {res} -> {lt_res}, batch {lt_batch}, grad_accum {lt_accum}, evals]"
    rows = [json.loads(line) for line in open(os.path.join(lt_wd, "metrics.jsonl"))]
    results["load_transform 224"] = mesh_stage_report(tag, rows, lt_steps, lt_accum, lt_batch,
                                                      runs_s["load_transform 224"], totals)
    params = ckpt_lib.load_state_dict(final)
    posemb = tuple(params["visual.positional_embedding"].shape)
    patch = params["visual.conv1.weight"].shape[-1]
    if posemb[0] != 1 + (lt_res // patch) ** 2:
        raise AssertionError(f"{tag}: position embedding {posemb}")
    in_run = {k: v for k, v in rows[-1].items() if k.startswith(("z/0shot", "retrieval/"))}
    print(f"{tag}: position embedding 1 + {(res // patch) ** 2} -> {posemb}; evals in the run "
          f"{in_run}")
    if len(in_run) != 8 or not all(np.isfinite(list(in_run.values()))):
        raise AssertionError(f"{tag}: evals in the run {in_run}")

    print("(c) eval_only on the mesh, then the same evaluators in one process:")
    mesh_ranks = [torch.load(os.path.join(out_dir, f"evals_rank{r}.pt"), weights_only=False)
                  for r in range(MR_RANKS)]
    eval_rows = [json.loads(line) for line in open(os.path.join(eval_wd, "metrics.jsonl"))]
    metrics = {k: v for k, v in eval_rows[0].items() if k.startswith(("z/0shot", "retrieval/"))}
    print(f"  eval_only on the mesh in {runs_s['eval_only']:.1f} s (main_clip in the ranks: "
          f"the checkpoint's params, three evaluators): {metrics}")
    if len(eval_rows) != 1 or metrics != in_run:
        raise AssertionError(f"eval_only's metrics {metrics} differ from the run's {in_run}")
    n_img = len(np.load(npz, allow_pickle=True)["image"])
    per_rank = -(-n_img // EVAL_BATCH)  # image batches a rank: EVAL_BATCH / 2 rows each
    calib = -(-64 // 32)
    want_ev = eval_launches(per_rank, False, MR_IMG_BLOCKS)
    for k, v in eval_launches(per_rank + calib, True, MR_IMG_BLOCKS).items():
        want_ev[k] += v
    for k, v in eval_launches(-(-n_img // (EVAL_BATCH // MR_RANKS)), False,
                              MR_IMG_BLOCKS).items():  # retrieval: every rank every image
        want_ev[k] += v
    want_ev = {k: v for k, v in want_ev.items() if v}
    for r in mesh_ranks:
        print(f"  rank {r['rank']}: eval_only launches {r['launches']}")
        if r["launches"] != want_ev:
            raise AssertionError(f"rank {r['rank']}: eval_only launches {r['launches']}, "
                                 f"expected {want_ev}")
    for k, v in mesh_ranks[0]["launches"].items():
        totals[k] += v

    cfg = load_config(f"{config_py}:{lt_arg}")
    for ov in eval_ovs:
        apply_override(cfg, ov)
    model = tstep.build_model(cfg).to(device)
    model.load_state_dict({k: v.to(device) for k, v in params.items()})
    del params
    one = {}
    with torch.no_grad():
        for name, ev, _, _ in instrument_evaluators(trainer.build_evaluators(cfg, model, None),
                                                    one):
            ev.run({"model": model})
    seconds = mesh_eval_checks(mesh_ranks, one, n_img)
    for name, s in seconds.items():
        print(f"  {name}: seconds on the mesh {[round(x, 2) for x in s['mesh']]} (each rank), "
              f"in one process {s['one']:.2f}  [{smi_line()}]")
    del model
    torch.cuda.empty_cache()
    results["eval_seconds"] = seconds
    results["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 23 in {results['phase_s']:.1f} s  [{smi_line()}]")
    return results


def mesh_recipe_only() -> int:
    """``chip_smoke.py --mesh-recipe``: the kernel build and phase 23 alone
    (it writes phase 21's shards and phase 19's fixture itself)."""
    import torch

    sys.path.insert(0, REPO)
    from openvision_tpu_torch.data.ops_image import decode_png
    from openvision_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"nvidia-smi: {smi_line()}")
    t0 = time.perf_counter()
    kernels.lib()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    images = [decode_png(open(os.path.join(REPO, "testcat", f), "rb").read())
              for f in sorted(os.listdir(os.path.join(REPO, "testcat"))) if f.endswith(".png")]
    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        mesh_recipe_phase(work, images, torch.device("cuda"), totals)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 23 launches: { {k: v for k, v in totals.items() if v} }")
    print(smi_line())
    return 0


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
    from openvision_tpu_torch.data.ops_image import decode_png
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
        images = []
        for f in names:
            with open(os.path.join(REPO, "testcat", f), "rb") as fh:
                images.append(decode_png(fh.read()))
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
        loaded, ckpts, greedy = caption_phase(device, work, cap_batch, names, totals)

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
    daemon["bf16 x2 replicas"] = data_parallel_phase(model8, ckpts["concat"], images, totals,
                                                     device, daemon["bf16"])
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

    phase("19. evaluation at full width: zero-shot IN-1K (bf16, int8 static and dynamic) and "
          "retrieval over a 1000-image TFRecord fixture, then main_clip eval_only")
    eval_results = eval_phase(model_dir, work, images, device, totals)
    torch.cuda.empty_cache()

    phase("20. interpretability tools at full width: gradient ascent (L/14), feature viz (S/8), "
          "neuron capture and PGD (L/14); fused bf16 against plain bf16 and f32")
    interp = interp_phase(model_dir, work, device, totals)
    torch.cuda.empty_cache()

    phase("21. webdataset pretraining and the resolution curriculum: ViT-B/16 + text B + "
          "decoder L, bf16, GradCache, through main_clip on tar shards")
    curriculum = curriculum_phase(images, work, device, totals, worst)

    phase("22. checkpoints and export at full width: phase 5's concat CoCa as an Orbax train "
          "state, convert.export, zero-shot on fused_t, the caption CLI's --step and the "
          "daemon's caption_step, the committed fixtures")
    with torch.inference_mode():
        ckpt_res = checkpoint_phase(ckpts["concat"], images, names, work, device, totals, greedy)

    phase("23. the recipe on a process mesh: ViT-L/14 + text L + decoder L at a third of the depth, "
          "two ranks of a data=2 mesh on the one card (gloo); GradCache, siglip and the global mode against one "
          "process, config 5 through main_clip with SIGTERM and load_transform, evals and "
          "eval_only")
    mesh_res = mesh_recipe_phase(work, images, device, totals)

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
    for k, v in eval_results.items():
        if k not in ("recall", "png_decode_ms"):
            print(f"eval {k}: {v['images_per_s']:.1f} images/s, host share "
                  f"{(v['host'] + v['copy']) / v['loop']:.3f}, class embeddings "
                  f"{v['class_embed']:.2f} s (tokenize {v['tokenize']:.2f} s)")
    print(f"eval retrieval: {eval_results['recall']}")
    print(f"PNG decode ms an image, 224 x 288: {eval_results['png_decode_ms']}")
    for k, v in interp["seconds"].items():
        print(f"tools: seconds an iteration, {k}: {v:.6f}")
    print(f"tools: phase 20 in {interp['phase_s']:.1f} s")
    for k in ("stage 1", "stage 2", "stage 3", "load_transform"):
        v = curriculum[k]
        print(f"curriculum {k}: step ms {[round(x, 1) for x in v['step_ms']]}, images/s "
              f"{[round(x, 1) for x in v['images_per_s']]}, data-wait share "
              f"{[round(x, 4) for x in v['wait_share']]}, peak {v['peak_gb']:.2f} GB"
              + (f", device busy {v['busy_ms']:.1f} of {v['traced_ms']:.1f} ms traced"
                 if "busy_ms" in v else ""))
    print(f"checkpoints: npz load {ckpt_res['npz_s']:.2f} s, save_orbax {ckpt_res['write_s']:.2f} s "
          f"({ckpt_res['write_bytes'] / ckpt_res['write_s'] / 1e9:.2f} GB/s), restore_params "
          f"{ckpt_res['read_s']:.2f} s ({ckpt_res['read_bytes'] / ckpt_res['read_s'] / 1e9:.2f} "
          f"GB/s); export zimg cosine {ckpt_res['zimg_cos']:.7f}; phase 22 in "
          f"{ckpt_res['phase_s']:.1f} s")
    for r, stages in mesh_res["ranks"].items():
        for res, st in stages.items():
            print(f"mesh recipe rank {r} at {res}: step {st['step_ms']:.1f} ms, "
                  f"{st['images_per_s']:.1f} images/s, peak {st['peak_gb']:.2f} GB, collectives "
                  f"{100 * st['comm_ms'] / st['timed_step_ms']:.1f}% of a timed step")
    print(f"mesh recipe: eval seconds {mesh_res['eval_seconds']}; phase 23 in "
          f"{mesh_res['phase_s']:.1f} s")
    for tag, what, step, nbytes, secs in SAVES:
        print(f"Orbax train state {what} {tag} step {step}: {nbytes / 1e9:.3f} GB in {secs:.2f} "
              f"s ({nbytes / secs / 1e9:.3f} GB/s)")
    print(f"optax chain step on the card (22e): worst {ckpt_res['chain']}")
    print(f"curriculum pp records/s (0 and {CUR_WORKERS} workers): "
          f"{curriculum['pp_records_per_s']}; phase 21 in {curriculum['phase_s']:.1f} s")
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


def ln_bwd_cases(gk, device, gen, b: int):
    """The LayerNorm backward (csrc/layernorm.cu layernorm_bwd) at batch b
    over LN_SHAPES, with the residual's gradient g (dx held on dx - g) and
    without; the library call is F.layer_norm's backward
    (ln_backward_library). Bytes: x bf16, dy f32, g bf16 read and dx bf16
    written once; gamma read and dgamma, dbeta written."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    cases = []
    for label, l, d in LN_SHAPES:
        m = b * l
        x = (rnd(m, d) * 3 + 1).bfloat16()
        gamma, dy, g = rnd(d, scale=0.1) + 1, rnd(m, d), rnd(m, d).bfloat16()
        for res in (g, None):
            cases.append(Case(
                "layernorm_bwd", f"{label} ({m}x{d}){' + g' if res is not None else ''}",
                lambda x=x, gamma=gamma, dy=dy, res=res: gk.layernorm_bwd(x, gamma, dy, res,
                                                                           eps=1e-6),
                lambda x=x, gamma=gamma, dy=dy, res=res: gk.layernorm_bwd_plain(
                    x.float(), gamma, dy, None if res is None else res.float(), eps=1e-6),
                ln_backward_library(x, gamma, dy),
                m * d * (2 + 4 + 2 + (2 if res is not None else 0)) + 3 * d * 4, 0, 10 * m * d,
                residual=res))
    return cases


def ln_bwd_chain_cases(fe, fa, gk, device, gen, b: int):
    """The composed backward chains that run the LayerNorm backward, at the
    image tower's L=257 D=1024: #3 (max-subtracted) and #4 from
    training_kernel_cases, #10 from fused_block_bwd_cases."""
    _, bwd = training_kernel_cases(fe, fa, gk, device, gen, b)
    chains = [c for c in bwd if c.name in ("mhsa_t bwd", "mlp_t bwd") and "L=257" in c.label
              and "nomax" not in c.label]
    return chains + fused_block_bwd_cases(fa, device, gen, b, lengths=(257,))


def time_ln_case(c) -> None:
    """time_case, then the kernel against its library call and its bound,
    and the wrapper's host time a call (50 calls, no synchronize)."""
    import torch

    t = time_case(c)
    t0 = time.perf_counter()
    for _ in range(50):
        c.kern()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    lib = ("" if c.lib is None else f"kernel / library {t['ms'] / t['library_ms']:.2f}"
           f" (graph {t['graph_ms'] / t['library_graph_ms']:.2f})  ")
    print(f"  {'':15s} {c.label:46s} {lib}graph / bound {t['graph_ms'] / t['bound_ms']:.2f}  "
          f"wrapper host {host_us:.1f} us a call")


def ln_only(root: str) -> int:
    """``chip_smoke.py --ln [ROOT]``: the row LayerNorm kernels of the
    checkout at ROOT (this one by default) at b=64 (ln_cases: CUDA events
    and graph replay, bound, plain, F.layer_norm, the wrapper's host time a
    call), encode img/s at b=64 on --gemm's export, then the LayerNorm
    backward (ln_bwd_cases: the same numbers beside F.layer_norm's
    backward) and the composed chains #3, #4 and #10 at L=257
    (ln_bwd_chain_cases, events and graph replay), so that two checkouts
    are timed on one card in one call. It first checks the forward kernels
    and the backward cases at B=8 (phase 7's bounds), and for this checkout
    applies phase 1's spill gate."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --ln: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from openvision_tpu_torch.ops import fused_attention as fa
    from openvision_tpu_torch.ops import fused_encoder as fe
    from openvision_tpu_torch.ops import fused_encoder_int8 as fe8
    from openvision_tpu_torch.ops import grad_kernels as gk
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
        check_bwd_cases(ln_bwd_cases(gk, device, torch.Generator(device=device).manual_seed(SEED),
                                     8), {})
        gen = torch.Generator(device=device).manual_seed(SEED + 10)
        print("row LayerNorm kernels (csrc/layernorm.cu) at b=64:")
        for c in ln_cases(fe, fe8, device, gen, 64):
            time_ln_case(c)
        export_encode_rates(device)
    torch.cuda.empty_cache()
    with torch.no_grad():  # the chains' library calls run autograd
        gen = torch.Generator(device=device).manual_seed(SEED + 11)
        print("LayerNorm backward (csrc/layernorm.cu layernorm_bwd) at b=64:")
        for c in ln_bwd_cases(gk, device, gen, 64):
            time_ln_case(c)
        torch.cuda.empty_cache()
        print("the composed backward chains that run it, b=64:")
        for c in ln_bwd_chain_cases(fe, fa, gk, device, gen, 64):
            time_bwd_case(c)
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
    if sys.argv[1:2] == ["--curriculum"]:
        sys.exit(curriculum_only())
    if sys.argv[1:2] == ["--checkpoints"]:
        sys.exit(checkpoints_only())
    if sys.argv[1:2] == ["--mesh-worker"]:  # one rank of phase 23 (torchrun starts it)
        sys.exit(mesh_recipe_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-recipe"]:
        sys.exit(mesh_recipe_only())
    sys.exit(main())

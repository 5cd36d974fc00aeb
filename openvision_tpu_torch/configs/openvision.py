"""The base OpenVision config: model, input, optimizer, schedule and loss.

Counterpart of ``openvision_tpu/configs/openvision.py:get_config`` (:19-270)
with the same tunables and constants: the tower and decoder variants, the
``"auto"`` resolution of ``attn_impl`` (image tower ``fused``, text tower
``xla``; ``xla`` for both under pipeline parallelism) and of
``dec_attn_impl`` (``fused``, or ``xla`` under pipeline parallelism),
``fast_gelu = dtype == "bfloat16"``, the pp-string input pipeline, Adam
with a bf16 first moment and b2 0.95, weight decay 0.2 on kernels, warmup +
cosine over ImageNet-equivalent epochs, the ``coca`` loss (1 CLIP + 2
caption, the caption cross-entropy head-fused in ``cap_xent_chunk`` chunks),
``remat``, ``total_steps`` and ``runlocal``. The result is a plain dict; the
tower dicts carry the port's keyword names (the JAX names, plus
``image_size`` and ``context_length``, which flax infers from the first
input). ``sharding.mesh`` is the JAX section (:81-92): the (data, fsdp,
tensor, seq, pipe) process mesh of ``train/trainer.py``; ``auto`` picks
``xla`` for every tower under pipe > 1 (JAX :144-165). The
eval section is JAX's (:272-316): ``eval_only`` and ``evals.disclf`` (zero-shot
ImageNet-1K, prefix ``z/0shot/``) and ``evals.retrieval`` (COCO captions),
their data_dir empty until a run names one, the image pp stopping after the
crop and ``device_norm="vgg"`` normalising uint8 batches on the device; the
wandb section is not ported.
"""

from __future__ import annotations

from openvision_tpu_torch.configs.common import parse_arg

IMAGENET_SAMPLES = 1_281_167

DEFAULTS = dict(
    res=112,
    batch_factor=2.0,
    base_lr=8e-6,
    imagenet_epoch=2000,
    vitual_warmup_epoch=20,
    runlocal=False,
    data_parallelism=-1,
    fsdp_parallelism=1,
    tensor_parallelism=1,
    seq_parallelism=1,
    token_len=80,
    output_token_len=128,
    remat="full",
    img="L/16",
    txt_name="L/16",
    pipe_parallelism=1,
    img_head=True,
    use_sovit=False,
    mask_ratio=0.0,
    txt_key1="txt",
    txt_key2="llava_caption",
    color_jitter=True,
    vocab_path="assets/bert_base_vocab_bos_eos.txt",
    txt_decoder_name="L",
    vocab_size=32000,
    attn_impl="auto",
    dec_attn_impl="auto",
    dec_fusion="concat",
    cap_xent_chunk=16,
    dtype="float32",
    param_dtype="float32",
)


def get_config(arg: str | None = None) -> dict:
    arg = parse_arg(arg, **DEFAULTS)
    img_attn = txt_attn = arg["attn_impl"]
    if img_attn == "auto":
        img_attn, txt_attn = "fused", "xla"
        if arg["pipe_parallelism"] > 1:
            img_attn = txt_attn = "xla"
    dec_attn = arg["dec_attn_impl"]
    if dec_attn == "auto":
        dec_attn = "xla" if arg["pipe_parallelism"] > 1 else "fused"
    dtype = arg["dtype"]
    dim = 1152 if arg["use_sovit"] else {
        "m": 32, "T": 192, "S": 384, "B": 512, "L": 768, "H": 1024, "g": 1024,
    }[arg["img"][0]]

    batch_size = int(1024 * 16 * arg["batch_factor"])
    tokenizer = (
        f'my_bert_tokenize(max_len={arg["token_len"]}, '
        f'output_token_len={arg["output_token_len"]}, '
        f'vocab_path="{arg["vocab_path"]}", add_bos=True, add_eos=True, '
        f'key1="{arg["txt_key1"]}", key2="{arg["txt_key2"]}")')
    text_pp = (f"|flatten|{tokenizer}|get_autoreg_label(pad_token=0)"
               '|keep("image", "labels1", "labels2", "autoreg_labels", "cap_loss_mask")')
    img_pp = (f'inception_crop(inkey="jpg", size={arg["res"]}, area_min=40, '
              'method="bilinear", antialias=True)')
    if arg["color_jitter"]:
        img_pp += "|simclr_jitter_gray(jitter_strength=0.4)"

    lr = arg["base_lr"] * 64 * arg["batch_factor"]
    total_samples = IMAGENET_SAMPLES * arg["imagenet_epoch"]
    warmup_samples = IMAGENET_SAMPLES * arg["vitual_warmup_epoch"]
    remat = arg["remat"]
    sub = "[:4]" if arg["runlocal"] else ""
    eval_tok = (f'my_eval_bert_tokenize(inkey="texts", max_len={arg["token_len"]}, '
                f'vocab_path="{arg["vocab_path"]}", add_bos=True, add_eos=True)')
    eval_img_pp = (f'|resize_small({arg["res"]}, method="bilinear", antialias=True)'
                   f'|central_crop({arg["res"]})')
    eval_every = int(2000 // arg["batch_factor"])
    return {
        "res": arg["res"],
        "seed": 0,
        "runlocal": arg["runlocal"],
        "sharding": {"mesh": dict(
            data=arg["data_parallelism"], fsdp=arg["fsdp_parallelism"],
            tensor=arg["tensor_parallelism"], seq=arg["seq_parallelism"],
            pipe=arg["pipe_parallelism"])},
        "save_ckpt": True,
        "ckpt_steps": 1000,
        "log_training_steps": 50,
        "init_shapes": [(128, arg["res"], arg["res"], 3), (256, arg["token_len"])],
        "input": {
            "data": {"name": "synthetic", "split": "train", "data_dir": ""},
            "shuffle_buffer_size": 250_000 if not arg["runlocal"] else 50,
            "txt_token_length": arg["token_len"],
            "batch_size": batch_size,
            # batch-level mixup/cutmix after batching (JAX :107-112); off for CLIP
            "mixup": dict(enabled=False, mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5,
                          image_key="image", label_key="labels"),
            "pp": img_pp + text_pp,
        },
        "vocab_path": arg["vocab_path"],
        "model_name": "clip",
        "model": {
            "image": dict(
                variant=arg["img"], posemb="sincos2d", pool_type="gap", attn_impl=img_attn,
                remat_policy=remat, mask_ratio=arg["mask_ratio"],
                fast_gelu=dtype == "bfloat16", emb_head_bias=False, head_zeroinit=False,
                dtype=dtype, param_dtype=arg["param_dtype"], output_tokens=True,
                image_size=arg["res"]),
            "text": dict(
                variant=arg["txt_name"], pool_type="last", causal=False, attn_impl=txt_attn,
                remat_policy=remat, head_zeroinit=False, dtype=dtype,
                param_dtype=arg["param_dtype"], vocab_size=arg["vocab_size"], embed_cls=True,
                output_tokens=True, context_length=arg["token_len"]),
            "text_decoder": "text_decoder",
            "text_decoder_config": dict(
                variant=arg["txt_decoder_name"], num_classes=arg["vocab_size"], dtype=dtype,
                param_dtype=arg["param_dtype"], remat_policy=remat,
                fusion_style=arg["dec_fusion"], causal=True, attn_impl=dec_attn,
                num_learnable_tokens=arg["output_token_len"], drop_token=0,
                return_prelogits=arg["cap_xent_chunk"] > 0),
            "out_dim": (dim if arg["img_head"] else None, dim),
            "temperature_init": 1 / 0.07,
        },
        "param_dtype": arg["param_dtype"],
        "cap_xent_chunk": arg["cap_xent_chunk"],
        # optimizer / schedule
        "total_steps": int(total_samples // batch_size) if not arg["runlocal"] else 1,
        "optax_name": "scale_by_adam",
        "optax": {"mu_dtype": "bfloat16", "b1": 0.9, "b2": 0.95},
        "lr": lr,
        "wd": 0.2,
        "schedule": [(".*", dict(decay_type="cosine",
                                 warmup_steps=int(warmup_samples // batch_size),
                                 min_lr=0, max_lr=lr))],
        # loss
        "loss_type": "coca",
        "coca_caption_loss_weight": 2.0,
        "clip_loss_weight": 1.0,
        "local_loss": True,
        "cpu_unit8": True,
        "grad_accum": 1,
        # evals
        "eval_only": False,
        "evals": {
            "disclf": dict(
                type="discriminative_classifier", dataset_names=["imagenet2012"],
                split=f"validation{sub}", data_dir="", pp_img=eval_img_pp, pp_txt=eval_tok,
                device_norm="vgg", canonicalize=True, first_class_name_only=False,
                prefix="z/0shot/", log_steps=eval_every),
            "retrieval": dict(
                type="retrieval", dataset="coco_captions", split="val", data_dir="",
                txt_name=("captions", "text"), pp_img=eval_img_pp, pp_txt=eval_tok,
                device_norm="vgg", log_steps=eval_every),
        },
    }

"""The OpenVision model config: the model section of the JAX package's base
config.

Counterpart of ``openvision_tpu/configs/openvision.py:get_config``
(:19-236) for what building a model needs: the tower and decoder variants,
the ``"auto"`` resolution of ``attn_impl`` (image tower ``fused``, text
tower ``xla``; ``xla`` for both under pipeline parallelism) and of
``dec_attn_impl`` (``fused``, or ``xla`` under pipeline parallelism),
``fast_gelu = dtype == "bfloat16"``, ``token_len``, ``output_token_len``,
``vocab_size``, ``res`` and ``init_shapes``. The data pipeline, optimizer,
schedule, loss, sharding and eval sections are training matters and are not
ported. The result is a plain dict; the tower dicts carry the port's keyword
names (the JAX names, plus ``image_size`` and ``context_length``, which flax
infers from the first input, and without the training-only keys).
"""

from __future__ import annotations

from openvision_tpu_torch.configs.common import parse_arg

DEFAULTS = dict(
    res=112,
    token_len=80,
    output_token_len=128,
    img="L/16",
    txt_name="L/16",
    pipe_parallelism=1,
    img_head=True,
    use_sovit=False,
    vocab_path="assets/bert_base_vocab_bos_eos.txt",
    txt_decoder_name="L",
    vocab_size=32000,
    attn_impl="auto",
    dec_attn_impl="auto",
    dec_fusion="concat",
    dtype="float32",
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
    return {
        "res": arg["res"],
        "init_shapes": [(128, arg["res"], arg["res"], 3), (256, arg["token_len"])],
        "input": {"txt_token_length": arg["token_len"]},
        "vocab_path": arg["vocab_path"],
        "model_name": "clip",
        "model": {
            "image": dict(
                variant=arg["img"], posemb="sincos2d", pool_type="gap", attn_impl=img_attn,
                fast_gelu=dtype == "bfloat16", emb_head_bias=False, dtype=dtype,
                output_tokens=True, image_size=arg["res"]),
            "text": dict(
                variant=arg["txt_name"], pool_type="last", causal=False, attn_impl=txt_attn,
                dtype=dtype, vocab_size=arg["vocab_size"], output_tokens=True,
                context_length=arg["token_len"]),
            "text_decoder": "text_decoder",
            "text_decoder_config": dict(
                variant=arg["txt_decoder_name"], num_classes=arg["vocab_size"], dtype=dtype,
                fusion_style=arg["dec_fusion"], causal=True, attn_impl=dec_attn,
                num_learnable_tokens=arg["output_token_len"], drop_token=0),
            "out_dim": (dim if arg["img_head"] else None, dim),
            "temperature_init": 1 / 0.07,
        },
    }

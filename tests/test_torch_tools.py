"""The port's zero-shot and encode CLIs against the JAX package's.

One tiny exported model, built as tests/test_tools.py builds it (JAX random
init -> OpenCLIP artifacts), is loaded by both packages. Both zero-shot
tools rank the testcat images and must agree on every top-1, with
probabilities within 1e-4; the port's encode CLI must write embeddings
within 1e-4 of the JAX ``build_encode_fn`` on the same images. f32 on the
CPU throughout.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.convert.openclip import jax_to_openclip
from openvision_tpu.models import text as text_mod
from openvision_tpu.models import vit as vit_mod
from openvision_tpu.parallel import unbox

W, L, H, E, RES, P, CTX, V = 64, 2, 2, 32, 32, 16, 16, 30522
IMG_DIR = "testcat"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_model")
    vision = vit_mod.ViT(
        num_classes=E, patch_size=(P, P), width=W, depth=L, mlp_dim=W * 4,
        num_heads=H, posemb="learn", pool_type="gap", emb_head_bias=False,
    )
    text = text_mod.TextTransformer(
        num_classes=E, width=W, depth=L, mlp_dim=W * 4, num_heads=H,
        vocab_size=V, posemb="learn", pool_type="last",
    )
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {
        "img": unbox(vision.init(k1, jnp.zeros((1, RES, RES, 3)))["params"]),
        "txt": unbox(text.init(k2, jnp.zeros((1, CTX), jnp.int32))["params"]),
        "t": np.log(1 / 0.07) * np.ones((1,), np.float32),
    }
    sd = {k: torch.tensor(np.asarray(v)) for k, v in jax_to_openclip(params).items()}
    torch.save(sd, os.path.join(d, "open_clip_pytorch_model.bin"))
    cfg = {
        "model_cfg": {
            "embed_dim": E,
            "vision_cfg": {
                "layers": L, "width": W, "head_width": W // H,
                "patch_size": P, "image_size": RES, "pool_type": "avg",
                "final_ln_after_pool": True, "no_ln_pre": True,
            },
            "text_cfg": {
                "layers": L, "width": W, "heads": H, "vocab_size": V,
                "context_length": CTX, "pool_type": "last",
                "no_causal_mask": True,
            },
        },
        "preprocess_cfg": {
            "mean": [0.48145466, 0.4578275, 0.40821073],
            "std": [0.26862954, 0.26130258, 0.27577711],
        },
    }
    with open(os.path.join(d, "open_clip_config.json"), "w") as f:
        json.dump(cfg, f)
    return str(d)


def test_zero_shot_matches_jax(model_dir, capsys):
    from openvision_tpu.tools import zero_shot as jzs
    from openvision_tpu_torch.tools import zero_shot as tzs

    want = jzs.run(model_dir, IMG_DIR)
    capsys.readouterr()
    got = tzs.run(model_dir, IMG_DIR, device="cpu")
    out = capsys.readouterr().out
    assert "Best Image Per Text" in out and "catdog.png" in out
    assert [r[0] for r in got] == [r[0] for r in want]
    assert len(got) == 5
    for (name, top1, _, probs), (_, top1_j, _, probs_j) in zip(got, want):
        assert top1 == top1_j, name
        np.testing.assert_allclose(probs, probs_j, atol=1e-4)


def test_encode_cli_matches_jax(model_dir, tmp_path):
    from openvision_tpu.serving.encode import build_encode_fn as jbuild
    from openvision_tpu.tools.model_io import load_model as jload
    from openvision_tpu_torch.serving import encode as tenc

    out = tmp_path / "emb.npz"
    # batch 4 over 5 images: the last batch is padded
    tenc.main(["--use_model", model_dir, "--img_folder", IMG_DIR, "--batch", "4",
               "--dtype", "float32", "--device", "cpu", "--out", str(out)])
    got = np.load(out)
    files = sorted(os.listdir(IMG_DIR))
    assert list(got["files"]) == files

    m = jload(model_dir)
    imgs = []
    for f in files:
        with open(os.path.join(IMG_DIR, f), "rb") as fh:
            imgs.append(m.preprocess(fh.read()))
    want = np.asarray(jbuild(m, int8=False, on_tpu=False)(jnp.asarray(np.stack(imgs), jnp.float32)))
    np.testing.assert_allclose(got["embeddings"], want, atol=1e-4)


def test_fused_t_matches_xla_on_cpu(model_dir):
    from openvision_tpu_torch.tools.model_io import load_model

    m_x = load_model(model_dir, device="cpu")
    m_f = load_model(model_dir, attn_impl="fused_t", fast_gelu=True, device="cpu")
    img = np.random.default_rng(0).random((2, RES, RES, 3), dtype=np.float32)
    cos = (m_x.encode_image(img) * m_f.encode_image(img)).sum(-1)
    assert cos.min() > 0.999, cos
    assert m_f.logit_scale == pytest.approx(1 / 0.07, rel=1e-4)


def test_int8_encode_is_not_ported(model_dir):
    """The int8 encode is ported now (tests/test_torch_quant.py holds it
    against the JAX package): it needs the int8 weights that
    load_model(int8=True) quantises from the f32 tower, and stays within the
    serving bound (cosine >= 0.995) of the float encode."""
    from openvision_tpu_torch.serving.encode import build_encode_fn
    from openvision_tpu_torch.tools.model_io import load_model

    with pytest.raises(ValueError, match="int8=True"):
        build_encode_fn(load_model(model_dir, device="cpu"), int8=True)
    m = load_model(model_dir, device="cpu", int8=True)
    img = np.random.default_rng(0).random((2, RES, RES, 3), dtype=np.float32)
    z = build_encode_fn(m, int8=True)(img)
    assert (z * m.encode_image(img)).sum(-1).min() >= 0.995


def test_load_model_refuses_absent_cuda(model_dir):
    from openvision_tpu_torch.tools.model_io import load_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        load_model(model_dir)  # device defaults to cuda


def test_tokenizer_matches_jax():
    from openvision_tpu.data.tokenizer import get_tokenizer as jget
    from openvision_tpu.tools.model_io import tokenize_labels as jtok
    from openvision_tpu_torch.data.tokenizer import get_tokenizer
    from openvision_tpu_torch.tools.model_io import DEFAULT_VOCAB, tokenize_labels

    labels = ["a photo of a cat", "Hello, naïve WordPiece — ÜBER 123!", "x " * 100]
    tokens = tokenize_labels(labels, DEFAULT_VOCAB, CTX)
    np.testing.assert_array_equal(tokens, jtok(labels, "assets/bert_base_vocab_bos_eos.txt", CTX))
    tok, jt = get_tokenizer(DEFAULT_VOCAB), jget("assets/bert_base_vocab_bos_eos.txt")
    assert [tok.decode(t) for t in tokens] == [jt.decode(t) for t in tokens]

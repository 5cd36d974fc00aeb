"""The resolution curriculum's weight transforms against the JAX package, on
the CPU.

- ``resample_posemb`` and the patch-kernel resize against
  ``jax.image.resize(..., "bilinear")`` (which antialiases when it
  shrinks), growing and shrinking: within 1e-5 of the largest |value|
  (f32; the port forms its filter weights in f64);
- ``load_transform`` (the patch kernel resized, the learned position
  embedding resampled, then merged into the fresh init under ``dont_load``)
  and ``masked_init`` (merged as it is) against the JAX trainer's
  ``_load_transform`` and ``utils.merge_params`` on the same npz and the
  same init: every parameter within 1e-5 of its largest |value|, the
  dont_load'ed ones equal to their init; a checkpoint/model mismatch that
  ``dont_load`` does not cover raises on both sides;
- the trainer starts from them: a 1-step run whose only step has a
  learning rate of 0 ends on the merged weights.
Torch runs one intra-op thread here, as the suite runs this file beside
others on a shared CPU.
"""

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from openvision_tpu.models import vit as jvit
from openvision_tpu.train import checkpoint as jckpt
from openvision_tpu.train import trainer as jtrainer
from openvision_tpu.utils import merge_params as jmerge
from openvision_tpu_torch.configs import openvision as tcfg
from openvision_tpu_torch.convert.openclip import (
    jax_params_to_state_dict, state_dict_to_jax_params)
from openvision_tpu_torch.main_clip import apply_override
from openvision_tpu_torch.models import vit as tvit
from openvision_tpu_torch.models.init import init_params
from openvision_tpu_torch.train import checkpoint as tckpt
from openvision_tpu_torch.train import step as tstep
from openvision_tpu_torch.train import trainer


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("old,new", [(14, 24), (24, 14), (7, 14), (16, 7)])
def test_resample_posemb_matches_jax(old, new):
    rng = np.random.default_rng(old * 100 + new)
    pe = rng.standard_normal((1 + old * old, 24)).astype(np.float32)
    want = np.asarray(jvit.resample_posemb(jnp.asarray(pe[None]), 1 + new * new))[0]
    got = tvit.resample_posemb(torch.from_numpy(pe), 1 + new * new).numpy()
    assert got.shape == want.shape == (1 + new * new, 24)
    assert _rel(got, want) <= 1e-5
    np.testing.assert_array_equal(got[0], pe[0])  # the cls row as it is


@pytest.mark.parametrize("old,new", [(16, 14), (14, 16), (16, 8), (8, 14)])
def test_patch_kernel_resize_matches_jax(old, new):
    rng = np.random.default_rng(old + 7 * new)
    hwio = rng.standard_normal((old, old, 3, 10)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(hwio), (new, new, 3, 10), method="bilinear"))
    oihw = torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy())
    got = tvit.resize_patch_kernel(oihw, (new, new)).numpy().transpose(2, 3, 1, 0)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


def _config(res: int, patch: int, vocab: int = 64, **kw) -> dict:
    c = tcfg.get_config(f"res={res},img=mu/{patch},txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
                        f"output_token_len=8,vocab_size={vocab},runlocal=True,remat=none")
    c["model"]["out_dim"] = (32, 32)
    c["model"]["image"]["posemb"] = "learn"  # sincos2d has nothing to resample
    c.update(kw)
    return c


def _heads(model):
    return dict(num_heads_vision=model.visual.transformer.resblocks[0].num_heads,
                num_heads_text=model.text.transformer.resblocks[0].num_heads,
                num_heads_decoder=model.txt_decoder.transformer.resblocks[0].num_heads)


def _jax_tree(sd: dict, model) -> dict:
    return state_dict_to_jax_params({k: v.detach().numpy() for k, v in sd.items()},
                                    **_heads(model))


def _write_source(path: str, res: int, patch: int, vocab: int = 64) -> None:
    """A JAX param tree (flat-name npz) of another geometry, from seed 5."""
    src = init_params(tstep.build_model(_config(res, patch, vocab)), seed=5)
    tckpt.save_npz(path, _jax_tree(src.state_dict(), src))


CASES = [  # (source res, patch) -> (target res, patch), dont_load
    ((64, 16), (48, 8), ("txt/.*",)),  # kernel shrinks, posemb grows 4x4 -> 6x6
    ((48, 8), (64, 16), ("img/head/.*", "t")),  # kernel grows, posemb shrinks 6x6 -> 4x4
]


@pytest.mark.parametrize("src,dst,dont_load", CASES)
def test_load_transform_matches_jax(tmp_path, monkeypatch, src, dst, dont_load):
    path = str(tmp_path / "src.npz")
    _write_source(path, *src)
    c = _config(*dst, load_transform=path, dont_load=list(dont_load))
    model = tstep.build_model(c)
    got = trainer.initial_params(c, model, note=lambda m: None)
    inited = {k: v.detach().clone() for k, v in init_params(model, 0).state_dict().items()}

    # the JAX side reads the same npz (restore_params reads Orbax directories)
    monkeypatch.setattr(jckpt, "restore_params", lambda p, _abstract: jckpt.load_npz(p))
    jc = ml_collections.ConfigDict({"load_transform": path, "dont_load": list(dont_load)})
    merged = jtrainer._load_transform(jc, jax.tree.map(jnp.asarray, _jax_tree(inited, model)),
                                      None)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, merged))
    assert set(got) == set(want) == set(inited)
    for k in want:
        assert tuple(got[k].shape) == tuple(inited[k].shape), k
        assert _rel(got[k].numpy(), want[k].numpy()) <= 1e-5, k
    kept = [k for k in inited if k.startswith("text.")] if "txt/.*" in dont_load else \
        ["visual.proj", "logit_scale"]
    for k in kept:
        assert torch.equal(got[k], inited[k]), k
    assert not torch.equal(got["visual.conv1.weight"], inited["visual.conv1.weight"])


def test_masked_init_matches_jax_merge_params(tmp_path):
    path = str(tmp_path / "src.npz")
    _write_source(path, 32, 16)
    dont_load = ["img/Transformer/encoderblock_0/MlpBlock_0/.*", "txt_decoder/head/kernel"]
    c = _config(32, 16, masked_init=path, dont_load=dont_load)
    model = tstep.build_model(c)
    got = trainer.initial_params(c, model, note=lambda m: None)
    inited = {k: v.detach().clone() for k, v in init_params(model, 0).state_dict().items()}
    merged = jmerge(jckpt.load_npz(path), _jax_tree(inited, model), dont_load=dont_load)
    want = jax_params_to_state_dict(merged)
    for k in want:
        assert _rel(got[k].numpy(), want[k].numpy()) <= 1e-6, k
    for k in ("visual.transformer.resblocks.0.mlp.c_fc.weight", "txt_decoder.head.weight"):
        assert torch.equal(got[k], inited[k])
    src = tckpt.load_state_dict(path)
    assert torch.equal(got["visual.transformer.resblocks.0.attn.in_proj_weight"],
                       src["visual.transformer.resblocks.0.attn.in_proj_weight"])

    # a parameter missing from the checkpoint and not dont_load'ed raises on both sides
    tree = jckpt.load_npz(path)
    del tree["img"]["head"]
    tckpt.save_npz(path, tree)
    with pytest.raises(ValueError, match="mismatch"):
        trainer.initial_params(_config(32, 16, masked_init=path), model, note=lambda m: None)
    with pytest.raises(ValueError, match="mismatch"):
        jmerge(jckpt.load_npz(path), _jax_tree(inited, model))
    # and a dont_load regex that splits a fused q/k/v parameter is refused
    with pytest.raises(ValueError, match="some but not all"):
        trainer.merge_params(src, inited, [".*/query/kernel"])


def test_trainer_starts_from_load_transform(tmp_path):
    path = str(tmp_path / "src.npz")
    _write_source(path, 64, 16, vocab=30522)
    c = _config(48, 16, vocab=30522, load_transform=path, evals={})
    c["input"]["batch_size"] = 4
    c["input"]["data"] = dict(name="synthetic", num_examples=8, res=56)
    for ov in ("total_steps=1", "schedule.0.1.warmup_steps=1", "log_training_steps=1"):
        apply_override(c, ov)  # step 1's learning rate is 0
    model = tstep.build_model(c)
    want = trainer.initial_params(c, model, note=lambda m: None)
    trained, _, meas = trainer.train(c, None, "cpu")
    assert np.isfinite(meas["training_loss"])
    for k, v in trained.state_dict().items():
        assert torch.equal(v, want[k]), k

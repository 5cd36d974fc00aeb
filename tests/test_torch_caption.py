"""The port's caption tool against the JAX caption tool, on the CPU.

One npz written by the JAX package's ``save_npz`` from a randomly
initialized CoCa model (the tests/test_caption_tool.py config: ViT mu/16 at
32 px, text and decoder Ti, 16 text tokens, 8 queries) is loaded by both
``build_captioner``s; the same preprocessed images go through both. The JAX
side runs its default picks (image tower and decoder ``fused``: Pallas in
interpret mode). Greedy ids must be identical and the f32 logits within
atol 1e-5 of the largest logit, rtol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.configs import openvision as jcfg
from openvision_tpu.parallel import unbox
from openvision_tpu.tools import caption as jcap
from openvision_tpu.train import checkpoint as jck
from openvision_tpu.train import step as jstep
from openvision_tpu_torch.configs import openvision as tcfg
from openvision_tpu_torch.tools import caption as tcap
from openvision_tpu_torch.train import checkpoint as tck

CFG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
       "output_token_len=8,vocab_size=30522")


@pytest.fixture(scope="module", params=["concat", "cross_attn"])
def run(request, tmp_path_factory):
    """(config arg, npz path, images, JAX logits, JAX greedy ids)."""
    arg = f"{CFG},dec_fusion={request.param}"
    config = jcfg.get_config(arg)
    model = jstep.build_model(config)
    # random params of the model's tree shapes (N(0, 0.05), LayerNorm scales
    # 1 + N(0, 0.05)), drawn with numpy: flax's own init runs eagerly and
    # slowly. The tree does not depend on the attention impl: trace on xla.
    xla_model = jstep.build_model(jcfg.get_config(f"{arg},attn_impl=xla,dec_attn_impl=xla"))
    shapes = unbox(jax.eval_shape(lambda: xla_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 16), jnp.int32))))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32) * np.float32(0.05)
        return x + 1 if path[-1].key == "scale" else x

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    npz = os.path.join(tmp_path_factory.mktemp("caption"), "ckpt.npz")
    jck.save_npz(npz, {"params": params})
    rs = np.random.RandomState(0)
    images = np.stack([tcap.preprocess(rs.randint(0, 255, (48, 40, 3), np.uint8), 32)
                       for _ in range(3)])
    fn, tok = jcap.build_captioner(config, npz)
    ids = np.asarray(fn(jnp.asarray(images), jax.random.PRNGKey(0), 0.0))
    text = jnp.full((3, 16), tok.pad_id, jnp.int32).at[:, 0].set(tok.bos_id)
    _, _, out = jax.jit(lambda p, i, t: model.apply({"params": p}, i, t))(
        params, jnp.asarray(images), text)
    return arg, npz, images, np.asarray(out["logits"]), ids


def test_captions_match_the_jax_tool(run):
    arg, npz, images, want_logits, want_ids = run
    captioner, _ = tcap.build_captioner(tcfg.get_config(arg), npz, device="cpu")
    logits = captioner.logits(images).numpy()
    np.testing.assert_allclose(logits, want_logits, atol=1e-5 * np.abs(want_logits).max(),
                               rtol=1e-5)
    np.testing.assert_array_equal(captioner(images).numpy(), want_ids)


def test_preprocessing_matches_the_jax_tool(tmp_path):
    from PIL import Image

    path = str(tmp_path / "img.png")
    Image.fromarray(np.random.RandomState(1).randint(0, 255, (48, 40, 3), np.uint8)).save(path)
    np.testing.assert_array_equal(tcap.load_image(path, 32), jcap._load_image(path, 32))


def test_cli_prints_one_caption_per_image(run, tmp_path, capsys):
    from PIL import Image

    arg, npz, *_ = run
    for i in range(2):
        Image.fromarray(np.full((40, 48, 3), 60 * i, np.uint8)).save(tmp_path / f"{i}.png")
    tcap.main(["--checkpoint", npz, "--config", arg, "--image_folder", str(tmp_path),
               "--top_k", "40", "--temperature", "0.7", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split("\t")[0] for line in lines] == [str(tmp_path / f"{i}.png") for i in range(2)]


def test_npz_round_trips_bfloat16(tmp_path):
    tree = {"a": {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3).bfloat16()},
            "c": np.ones(3, np.float32)}
    tck.save_npz(str(tmp_path / "t.npz"), tree)
    back = tck.load_npz(str(tmp_path / "t.npz"))
    assert back["a"]["b"].dtype == torch.bfloat16
    torch.testing.assert_close(back["a"]["b"], tree["a"]["b"])
    np.testing.assert_array_equal(back["c"], tree["c"])
    np.testing.assert_array_equal(tck.load_npz(str(tmp_path / "t.npz") + ":c"), tree["c"])


def test_unported_checkpoint_formats_raise(tmp_path):
    # Orbax and legacy tensorstore checkpoints load (tests/test_torch_checkpoint_formats.py);
    # an uncommitted Orbax step, zarr v3 and blosc's zlib blocks raise by name
    (tmp_path / "orbax" / "1000" / "default").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="committed"):
        tck.load_checkpoint(str(tmp_path / "orbax"))
    (tmp_path / "orbax" / "1000" / "_CHECKPOINT_METADATA").write_text("{}")
    (tmp_path / "orbax" / "1000" / "default" / "_METADATA").write_text(
        '{"tree_metadata": {}, "use_zarr3": true}')
    with pytest.raises(NotImplementedError, match="zarr v3"):
        tck.load_checkpoint(str(tmp_path / "orbax"))
    (tmp_path / "ts" / "img~cls").mkdir(parents=True)
    (tmp_path / "ts" / "img~cls" / ".zarray").write_text(
        '{"chunks": [2], "compressor": {"id": "blosc"}, "dtype": "<f4", "fill_value": null, '
        '"filters": null, "order": "C", "shape": [2], "zarr_format": 2}')
    blosc = bytes([2, 1, 0x1 | 3 << 5, 4]) + np.array([8, 8, 24], "<u4").tobytes() + bytes(8)
    (tmp_path / "ts" / "img~cls" / "0").write_bytes(blosc)
    with pytest.raises(NotImplementedError, match="compressor code 3"):
        tck.load_checkpoint(str(tmp_path / "ts"))


def test_float32_with_kernel_picks_on_cuda_raises():
    # the check runs before the device is resolved, so it holds without a card
    with pytest.raises(ValueError, match="bfloat16"):
        tcap.build_captioner(tcfg.get_config(CFG), "unused.npz", device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        tcap.build_captioner(tcfg.get_config(f"{CFG},attn_impl=xla,dec_attn_impl=flash"),
                             "unused.npz", device="cuda")

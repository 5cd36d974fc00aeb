"""The port's OpenCLIP export against the JAX package's, on the CPU.

A tiny two-tower CLIP (ViT Ti/16 at 32 px, text Ti with a 128-token vocab
and 16 positions, 32-d embeddings; random N(0, 0.05) params drawn with
numpy, LayerNorm scales 1 + N(0, 0.05)), saved by the JAX package as an
Orbax train state, is exported by both ``export``s: the same
``open_clip_config.json``, the same ``vocab.txt`` and a bit-equal state
dict, including the sincos2d position embedding materialized for a source
that has none; the port's parity probe (its ViT on the source params
against the export reloaded by ``tools/model_io.load_model``, f32 ``xla``)
within 1e-5. The CLI writes the same artifacts and refuses the Hugging Face
upload. Torch runs one intra-op thread here.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.convert import export as jexport
from openvision_tpu.models import clip as jclip
from openvision_tpu.parallel import unbox
from openvision_tpu.train import checkpoint as jck
from openvision_tpu_torch.convert import export as texport

KW = dict(img="Ti/16", txt="Ti", res=32, out_dim=32, context_length=16, vocab_size=128)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["sincos2d", "learn"])
def orbax_dir(request, tmp_path_factory):
    model = jclip.Model(
        out_dim=(32, 32),
        image=dict(variant="Ti/16", posemb=request.param, pool_type="gap", emb_head_bias=False),
        text=dict(variant="Ti", pool_type="last", vocab_size=128),
        text_decoder="none")
    shapes = unbox(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 16), jnp.int32))))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32) * np.float32(0.05)
        return x + 1 if path[-1].key == "scale" else x

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    assert ("pos_embedding" in params["img"]) == (request.param == "learn")
    root = str(tmp_path_factory.mktemp("export") / "ckpt")
    mngr = jck.create_checkpoint_manager(root, async_save=False)
    jck.save_train_state(mngr, 1, {"params": jax.tree.map(jnp.asarray, params)})
    mngr.wait_until_finished()
    mngr.close()
    return root


def _same_export(got_dir: str, want_dir: str) -> None:
    for name in ("open_clip_config.json", "vocab.txt"):
        with open(os.path.join(got_dir, name)) as g, open(os.path.join(want_dir, name)) as w:
            got, want = g.read(), w.read()
        if name.endswith(".json"):
            got, want = json.loads(got), json.loads(want)
        assert got == want, name
    load = lambda d: torch.load(os.path.join(d, "open_clip_pytorch_model.bin"),  # noqa: E731
                                weights_only=True)
    got, want = load(got_dir), load(want_dir)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_export_matches_jax(orbax_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # JAX's vocab
    jexport.export(orbax_dir, str(tmp_path / "jax"), **KW)
    gap = texport.export(orbax_dir, str(tmp_path / "port"), device="cpu", **KW)
    _same_export(str(tmp_path / "port"), str(tmp_path / "jax"))
    sd = torch.load(str(tmp_path / "port" / "open_clip_pytorch_model.bin"), weights_only=True)
    assert tuple(sd["visual.positional_embedding"].shape) == (5, 192)
    assert gap <= 1e-5


def test_export_cli(orbax_dir, tmp_path):
    args = ["--checkpoint", orbax_dir, "--img", "Ti/16", "--txt", "Ti", "--res", "32",
            "--out_dim", "32", "--context_length", "16", "--vocab_size", "128", "--device", "cpu"]
    assert texport.main(args + ["--out", str(tmp_path / "a"), "--step", "1"]) <= 1e-5
    texport.export(orbax_dir, str(tmp_path / "b"), device="cpu", **KW)
    _same_export(str(tmp_path / "a"), str(tmp_path / "b"))
    with pytest.raises(NotImplementedError, match="network"):
        texport.main(args + ["--out", str(tmp_path / "c"), "--repo", "user/model"])


def test_synthesize_config_matches_jax():
    for img, txt in (("L/14", "L"), ("So400m/14", "So400m"), ("B/16", "B"), ("H/14", "H")):
        assert texport.synthesize_config(img, txt, res=224, out_dim=768) == \
            jexport.synthesize_config(img, txt, res=224, out_dim=768)

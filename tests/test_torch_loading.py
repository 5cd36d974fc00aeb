"""Per-tower loading, the reference-config keys and the entry points that
take Orbax checkpoints, against the JAX package, on the CPU.

- ``translate_model_kwargs`` agrees with JAX's on every reference key (JAX's
  "scan" is the port's "flash"; dtypes by name), and the towers' factories
  apply it;
- ``load_two_towers`` and ``load_vit`` (with the position embedding
  resampled, and ``dont_load``) equal JAX's on the same npz and Orbax
  directory: every parameter bit-equal, the resampled embedding within
  1e-5 of its largest |value| (``jax.image.resize`` against the port's own
  filter, as tests/test_torch_curriculum.py); the ``gs://`` short names
  raise;
- the caption CLI with ``--step``, the daemon's ``CaptionService(step=)``
  and the trainer's ``ft_from`` / ``load_transform`` / ``masked_init`` on an
  Orbax directory written by the JAX package give exactly what the npz of
  the same params gives (a 1-step run at learning rate 0 ends on them).
Torch runs one intra-op thread here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.models import clip as jclip
from openvision_tpu.models import compat as jcompat
from openvision_tpu.models import loading as jloading
from openvision_tpu.parallel import unbox
from openvision_tpu.train import checkpoint as jck
from openvision_tpu_torch.configs import openvision as tcfg
from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict
from openvision_tpu_torch.main_clip import apply_override
from openvision_tpu_torch.models import compat as tcompat
from openvision_tpu_torch.models import decoder as tdecoder
from openvision_tpu_torch.models import loading as tloading
from openvision_tpu_torch.models import text as ttext
from openvision_tpu_torch.models import vit as tvit
from openvision_tpu_torch.models.clip import CLIPModel
from openvision_tpu_torch.train import checkpoint as tck
from openvision_tpu_torch.train import trainer


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REFERENCE_KW = [
    {"use_flash_attn": True, "scan_attn": False},
    {"scan_attn": True},
    {"scan_attn": False, "attn_impl": "xla"},
    {"use_flash_attn": False},
    {"mlp_chunck": 4, "patch_embeding": "conv", "casual_mask": True},
    {"dtype": "bfloat16", "param_dtype": "float32"},
    {"dtype": "bf16", "param_dtype": "f32"},
    {"dtype": "float16"},
    {"mesh": "a mesh", "block_size": 512, "variant": "L/14", "posemb": "learn"},
]


@pytest.mark.parametrize("kw", REFERENCE_KW)
def test_translate_model_kwargs_matches_jax(kw):
    got, want = tcompat.translate_model_kwargs(kw), jcompat.translate_model_kwargs(kw)
    if "use_flash_attn" in kw and "scan_attn" in kw:
        # JAX keeps scan_attn beside use_flash_attn, which its towers then refuse
        assert want.pop("scan_attn") == kw["scan_attn"] and "scan_attn" not in got
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in ("dtype", "param_dtype"):
            assert str(got[k]).removeprefix("torch.") == jnp.dtype(v).name, k
        elif k == "attn_impl" and v == "scan":
            assert got[k] == "flash"  # the port's memory-efficient attention
        else:
            assert got[k] == v, k


def test_factories_translate_reference_keys():
    vit = tvit.Model(8, variant="mu/16", dtype="bfloat16", scan_attn=True, image_size=32)
    assert vit.transformer.attn_impl == "flash"
    assert vit.transformer.resblocks[0].attn.in_proj_weight.dtype == torch.float32
    txt = ttext.Model(8, variant="Ti", casual_mask=True, use_flash_attn=True, vocab_size=16,
                      dtype="float32")
    assert txt.transformer.causal and txt.transformer.attn_impl == "flash"
    dec = tdecoder.Model(16, variant="Ti", use_flash_attn=True, image_width=64, text_width=192)
    assert dec.transformer.attn_impl == "flash"
    chunked = tvit.Model(8, variant="mu/16", mlp_chunck=4, scan_mlp=True, image_size=32)
    assert chunked.transformer.resblocks[0].chunk == 4 and chunked.transformer.scan_mlp


def _draw(shapes, seed: int):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32) * np.float32(0.05)
        return x + 1 if path[-1].key == "scale" else x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_clip_params(seed: int, res: int = 32):
    model = jclip.Model(
        out_dim=(32, 32),
        image=dict(variant="mu/16", posemb="learn", pool_type="gap", emb_head_bias=False),
        text=dict(variant="Ti", pool_type="last", vocab_size=128), text_decoder="none")
    shapes = unbox(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, res, res, 3)), jnp.zeros((1, 8), jnp.int32))))
    return _draw(shapes["params"], seed)


def _port_clip(res: int = 32) -> CLIPModel:
    return CLIPModel(out_dim=(32, 32),
                     image=dict(variant="mu/16", posemb="learn", pool_type="gap",
                                emb_head_bias=False, image_size=res),
                     text=dict(variant="Ti", pool_type="last", vocab_size=128, context_length=8))


def _save_orbax(root: str, trees) -> str:
    mngr = jck.create_checkpoint_manager(root, async_save=False, max_to_keep=None)
    for step, params in trees:
        jck.save_train_state(mngr, step, {"params": jax.tree.map(jnp.asarray, params),
                                          "opt": {"count": jnp.asarray(step, jnp.int32)}})
    mngr.wait_until_finished()
    mngr.close()
    return root


@pytest.fixture(scope="module")
def clip_ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    params = _jax_clip_params(0)
    npz = str(d / "ckpt.npz")
    jck.save_npz(npz, params)
    return params, npz, _save_orbax(str(d / "orbax"), [(1, params)])


def _assert_equal_state(got: dict, want: dict, resampled=()):
    assert got.keys() == want.keys()
    for k in want:
        g, w = torch.as_tensor(got[k]).float(), torch.as_tensor(want[k]).float()
        assert g.shape == w.shape, k
        if k in resampled:
            assert (g - w).abs().max() <= 1e-5 * w.abs().max(), k
        else:
            assert torch.equal(g, w), k


def test_load_two_towers_matches_jax(clip_ckpts):
    params, npz, orbax = clip_ckpts
    zeroed = {k: torch.zeros_like(v) for k, v in _port_clip().state_dict().items()}
    jzeroed = jax.tree.map(np.zeros_like, params)
    want = jax_params_to_state_dict(jloading.load_two_towers(jzeroed, npz))
    _assert_equal_state(tloading.load_two_towers(zeroed, npz), want)
    files = {"img": orbax, "txt": orbax}
    want = jax_params_to_state_dict(jloading.load_two_towers(jzeroed, files))
    _assert_equal_state(tloading.load_two_towers(zeroed, files), want)
    # the "dir:img" subtree form (JAX reads it only from an npz)
    got = tloading.load_two_towers(zeroed, {"image": f"{orbax}:img", "text": f"{orbax}:txt",
                                            "temperature": f"{npz}:t"})
    _assert_equal_state(got, jax_params_to_state_dict(params))
    with pytest.raises(ValueError, match="unused"):
        tloading.load_two_towers(zeroed, {"img": npz, "other": npz})


@pytest.mark.parametrize("source", ["npz", "orbax"])
def test_load_vit_resamples_like_jax(clip_ckpts, source):
    params, npz, orbax = clip_ckpts
    path = npz if source == "npz" else orbax
    big = _jax_clip_params(1, res=64)["img"]  # 4 x 4 patches against the source's 2 x 2
    inited = {k.removeprefix("visual."): v
              for k, v in jax_params_to_state_dict({"img": big}).items()}
    for dont_load in ((), ("head/.*",)):
        want = jloading.load_vit(big, path, dont_load=dont_load)
        want = {k.removeprefix("visual."): v
                for k, v in jax_params_to_state_dict({"img": want}).items()}
        got = tloading.load_vit(inited, path, dont_load=dont_load)
        _assert_equal_state(got, want, resampled=("positional_embedding",))
        assert got["positional_embedding"].shape == inited["positional_embedding"].shape
        assert torch.equal(got["proj"], inited["proj"]) == bool(dont_load)
    tower = tvit.Model(32, variant="mu/16", posemb="learn", emb_head_bias=False, image_size=64)
    tower.load_state_dict(got)
    assert tower(torch.zeros(1, 64, 64, 3)).shape == (1, 32)


def test_vanity_names_need_the_network():
    with pytest.raises(NotImplementedError, match="network"):
        tloading.load_vit({}, "i1k-s16-300ep")
    assert tloading.VANITY_NAMES == jloading.VANITY_NAMES


CAPTION_ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
               "output_token_len=8,vocab_size=30522,attn_impl=xla,dec_attn_impl=xla")


@pytest.fixture(scope="module")
def caption_ckpts(tmp_path_factory):
    """A random CoCa param tree as an npz, and as steps 1 (the same) and 2
    (another draw) of a JAX-written Orbax directory."""
    from openvision_tpu.configs import openvision as jcfg
    from openvision_tpu.train import step as jstep

    model = jstep.build_model(jcfg.get_config(CAPTION_ARG))
    shapes = unbox(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 16), jnp.int32))))
    params = _draw(shapes["params"], 0)
    d = tmp_path_factory.mktemp("coca")
    npz = str(d / "ckpt.npz")
    jck.save_npz(npz, {"params": params})
    orbax = _save_orbax(str(d / "orbax"), [(1, params), (2, _draw(shapes["params"], 1))])
    return npz, orbax


def _pngs(folder) -> list:
    from PIL import Image

    paths = []
    for i in range(2):
        rs = np.random.RandomState(i)
        paths.append(str(folder / f"{i}.png"))
        Image.fromarray(rs.randint(0, 255, (40, 48, 3), np.uint8)).save(paths[-1])
    return paths


def test_caption_cli_step_reads_the_orbax_step(caption_ckpts, tmp_path, capsys):
    from openvision_tpu_torch.tools import caption as tcap

    npz, orbax = caption_ckpts
    _pngs(tmp_path)
    common = ["--config", CAPTION_ARG, "--image_folder", str(tmp_path), "--device", "cpu"]
    outputs = []
    for ckpt in (["--checkpoint", npz], ["--checkpoint", orbax, "--step", "1"]):
        tcap.main(ckpt + common)
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] and len(outputs[0].splitlines()) == 2
    images = np.stack([tcap.load_image(p, 32) for p in sorted(
        str(tmp_path / f) for f in os.listdir(tmp_path))])
    config = tcfg.get_config(CAPTION_ARG)
    logits = [tcap.build_captioner(config, ckpt, device="cpu", step=step)[0].logits(images)
              for ckpt, step in ((npz, None), (orbax, 1), (orbax, None), (orbax, 2))]
    assert torch.equal(logits[0], logits[1])
    assert torch.equal(logits[2], logits[3]) and not torch.equal(logits[1], logits[2])


def test_daemon_caption_step_reads_the_orbax_step(caption_ckpts, tmp_path):
    from openvision_tpu_torch.serving import server as srv

    npz, orbax = caption_ckpts
    blobs = [open(p, "rb").read() for p in _pngs(tmp_path)]
    caps = []
    for ckpt, step in ((npz, None), (orbax, 1)):
        svc = srv.CaptionService(tcfg.get_config(CAPTION_ARG), ckpt, step=step, max_batch=2,
                                 device="cpu")
        try:
            caps.append([f.result(timeout=60) for f in map(svc.caption_image_bytes, blobs)])
        finally:
            svc.stop()
    assert caps[0] == caps[1]


def _train_config(**kw) -> dict:
    c = tcfg.get_config("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
                        "output_token_len=8,vocab_size=30522,runlocal=True,remat=none")
    c["model"]["out_dim"] = (32, 32)
    c["model"]["image"]["posemb"] = "learn"
    c.update(evals={}, **kw)
    return c


def test_trainer_starts_from_an_orbax_directory(tmp_path):
    from openvision_tpu_torch.convert.openclip import state_dict_to_jax_params
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.train import step as tstep

    model = tstep.build_model(_train_config())
    src = init_params(model, seed=5)
    heads = lambda m: m.transformer.resblocks[0].num_heads  # noqa: E731
    params = state_dict_to_jax_params(
        {k: v.detach().numpy() for k, v in src.state_dict().items()},
        num_heads_vision=heads(src.visual), num_heads_text=heads(src.text),
        num_heads_decoder=heads(src.txt_decoder))
    npz = str(tmp_path / "ckpt.npz")
    jck.save_npz(npz, {"params": params})
    orbax = _save_orbax(str(tmp_path / "orbax"), [(7, params)])
    for key in ("ft_from", "load_transform", "masked_init"):
        got, want = (trainer.initial_params(_train_config(**{key: path}), model,
                                            note=lambda m: None) for path in (orbax, npz))
        _assert_equal_state(got, want)

    c = _train_config(ft_from=orbax)
    c["input"]["batch_size"] = 4
    c["input"]["data"] = dict(name="synthetic", num_examples=8, res=40)
    for ov in ("total_steps=1", "schedule.0.1.warmup_steps=1", "log_training_steps=1"):
        apply_override(c, ov)  # step 1's learning rate is 0
    trained, _, meas = trainer.train(c, None, "cpu")
    assert np.isfinite(meas["training_loss"])
    _assert_equal_state(trained.state_dict(), tck.load_state_dict(npz))

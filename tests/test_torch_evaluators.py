"""The port's evaluators and the trainer's evals against the JAX package, on the CPU.

One tiny CLIP (mu/16 image tower at 32 px, a 2-block Ti text tower, f32,
eager ``xla`` attention) is drawn by the port's initializer; the same
weights cross to JAX through ``convert/openclip.py``. Both packages then
evaluate the same seeded numpy data. Bounds:
- disclf, for each ``device_norm`` ("", "vgg", "value_range(-1,1)"), with
  a multi-label key and with custom class names: class embeddings within
  1e-5 (f32 sums in another order), the accuracy equal, and the
  predictions equal wherever JAX's top-2 logit margin exceeds 1e-4;
- retrieval: ``recall_at_k`` equal on random similarities, and every
  Recall@k of the evaluator equal to JAX's;
- the contrastive monitor: loss within 1e-5, ncorrect equal;
- ``device_norm_fn`` within 1e-6 of JAX's;
- the trainer: ``eval_only`` and the in-loop evals write the JAX metric
  names, each evaluator once a step; on a process mesh the trainer no
  longer refuses evaluators with data or ``eval_only`` (they run there,
  tests/test_torch_mesh_recipe.py), and disclf refuses ``return_preds``
  on several processes by name.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.configs import openvision as jcfg
from openvision_tpu.data import pipeline as jpipe
from openvision_tpu.evaluators import common as jcommon
from openvision_tpu.evaluators import contrastive as jcontrastive
from openvision_tpu.evaluators import disclf as jdisclf
from openvision_tpu.evaluators import retrieval as jretrieval
from openvision_tpu.parallel import create_mesh
from openvision_tpu.train import step as jstep
from openvision_tpu_torch.configs import openvision as tcfg
from openvision_tpu_torch.convert.openclip import state_dict_to_jax_params
from openvision_tpu_torch.data import pipeline as tpipe
from openvision_tpu_torch.evaluators import common as tcommon
from openvision_tpu_torch.evaluators import contrastive as tcontrastive
from openvision_tpu_torch.evaluators import disclf as tdisclf
from openvision_tpu_torch.evaluators import retrieval as tretrieval
from openvision_tpu_torch.main_clip import main
from openvision_tpu_torch.models.init import init_params
from openvision_tpu_torch.train import step as tstep
from openvision_tpu_torch.train import trainer
from torch_jax_wordpiece import jax_python_wordpiece  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "assets", "bert_base_vocab_bos_eos.txt")
ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=8,"
       f"vocab_size=30522,runlocal=True,remat=none,attn_impl=xla,dec_attn_impl=xla,"
       f"vocab_path={VOCAB}")
TOK = (f'my_eval_bert_tokenize(inkey="texts", max_len=16, vocab_path="{VOCAB}", '
       'add_bos=True, add_eos=True)')
CROP = "decode|resize_small(32)|central_crop(32)"
NAMES = ["tench", "goldfish", "a red car", "two dogs", "snowy mountain", "city at night",
         "a bowl of soup"]


@pytest.fixture(scope="module")
def models():
    tc = tcfg.get_config(ARG)
    tc["model"]["text"]["depth"] = 2
    tc["model"]["text_decoder_config"]["depth"] = 1
    tc["model"]["out_dim"] = (32, 32)
    model = init_params(tstep.build_model(tc), 0).eval().requires_grad_(False)
    heads = dict(num_heads_vision=model.visual.transformer.resblocks[0].num_heads,
                 num_heads_text=model.text.transformer.resblocks[0].num_heads,
                 num_heads_decoder=model.txt_decoder.transformer.resblocks[0].num_heads)
    params = jax.tree.map(jnp.asarray, state_dict_to_jax_params(
        {k: v.numpy() for k, v in model.state_dict().items()}, **heads))
    jc = jcfg.get_config(ARG)
    jc.model.text.depth = 2
    jc.model.text_decoder_config.depth = 1
    jc.model.out_dim = (32, 32)
    jmodel = jstep.build_model(jc)
    mesh = create_mesh(data=1, fsdp=1, tensor=1, devices=jax.devices()[:1])
    return model, jmodel, params, mesh


def _images(n, seed, h=40, w=36):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), np.uint8)


def test_towers_agree(models):
    model, jmodel, params, _ = models
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(np.float32)
    tok = np.random.default_rng(1).integers(1, 30000, (3, 16))
    jz, jt, _ = jmodel.apply({"params": params}, x, tok, train=False)
    towers = tcommon.Towers(model)
    with towers.evaluating():
        z = towers.embed_images(torch.from_numpy(x))
        t = towers.embed_texts(torch.from_numpy(tok))
    assert np.abs(z.numpy() - np.asarray(jz)).max() <= 1e-5
    assert np.abs(t.numpy() - np.asarray(jt)).max() <= 1e-5


@pytest.mark.parametrize("spec", ["", "vgg", "value_range(-1, 1)", "value_range(0.5,2)"])
def test_device_norm_matches_jax(spec):
    img = _images(2, 3)
    want = np.asarray(jcommon.device_norm_fn(spec)(jnp.asarray(img)))
    got = tcommon.device_norm_fn(spec)(torch.from_numpy(img)).numpy()
    assert np.abs(got.astype(np.float32) - want.astype(np.float32)).max() <= 1e-6 * 255


def test_device_norm_rejects_unknown_spec():
    with pytest.raises(ValueError, match="device_norm"):
        tcommon.device_norm_fn("imagenet")


# ---------------------------------------------------------------------------
# disclf
# ---------------------------------------------------------------------------


def _disclf_pair(models, source_kw, **kw):
    model, jmodel, params, mesh = models
    jev = jdisclf.Evaluator(jmodel, mesh, source=jpipe.DictSource(source_kw), pp_txt=TOK, **kw)
    tev = tdisclf.Evaluator(model, source=tpipe.DictSource(source_kw), pp_txt=TOK, **kw)
    return jev, tev


def _jax_margins(jev, params):
    """JAX's top-2 logit margin of every row, padded rows included."""
    embs = jev._build_class_embeddings(params)
    out = []
    for batch in jpipe.make_for_inference(jev.source, jev.pp_img_string, jev.batch_size)():
        img = np.asarray(batch["image"], np.uint8 if jev.device_norm else np.float32)
        z = jev._embed_image_impl(params, jev._apply_device_norm(jnp.asarray(img)))
        top2 = np.sort(np.asarray(z @ embs.T), axis=-1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
    return np.concatenate(out)


DISCLF_CASES = {
    "plain pp": dict(device_norm="", pp_img=CROP + "|vgg_value_range"),
    "vgg": dict(device_norm="vgg", pp_img=CROP),
    "value_range": dict(device_norm="value_range(-1,1)", pp_img=CROP),
    "multi-label": dict(device_norm="vgg", pp_img=CROP, multi_label_key="real"),
}


@pytest.mark.parametrize("case", sorted(DISCLF_CASES))
def test_disclf_matches_jax(models, case):
    _, _, params, _ = models
    kw = dict(DISCLF_CASES[case], class_names=NAMES, prompt_templates="clip_paper",
              batch_size=4)
    rng = np.random.default_rng(7)
    data = {"image": _images(10, 5), "label": rng.integers(0, len(NAMES), (10,))}
    if case == "multi-label":
        real = rng.integers(-1, len(NAMES), (10, 3))
        real[3] = -1  # no valid label: not counted
        data["real"] = real
    # half of the rows labelled with what the model predicts, so the
    # accuracy is not near zero
    _, probe = _disclf_pair(models, data, **kw)
    _, preds, _ = probe.run(return_preds=True)
    data["label"][::2] = preds[:10][::2]
    if case == "multi-label":
        data["real"][::2, 0] = preds[:10][::2]
    jev, tev = _disclf_pair(models, data, **kw)

    want_embs = np.asarray(jev._build_class_embeddings(params))
    got_embs = tev.class_embeddings(tev.prompt_tokens()).numpy()
    assert got_embs.shape == (len(NAMES), 32)
    assert np.abs(got_embs - want_embs).max() <= 1e-5

    (wname, wacc), wpred, wmask = (lambda r: (r[0][0], r[1], r[2]))(
        jev.run({"params": params}, return_preds=True))
    metrics, tpred, tmask = tev.run(return_preds=True)
    assert metrics[0][0] == wname == "imagenet2012_accuracy"
    assert metrics[0][1] == wacc
    assert np.array_equal(tmask, wmask)
    margin = _jax_margins(jev, params)
    sure = margin > 1e-4
    assert sure.sum() >= 8
    assert np.array_equal(tpred[sure], wpred[sure])
    if case == "multi-label":
        assert tev.counts[1] == 9  # the row without a valid label is not counted
    else:
        assert tev.counts[1] == 10 and wacc >= 0.5


def test_disclf_imagenet_names_and_synthetic_data_match_jax(models):
    model, jmodel, params, mesh = models
    kw = dict(data_dir="synthetic", pp_img="resize_small(32)|central_crop(32)", pp_txt=TOK,
              device_norm="vgg", prompt_templates="none", first_class_name_only=True,
              batch_size=16)
    jev = jdisclf.Evaluator(jmodel, mesh, **kw)
    tev = tdisclf.Evaluator(model, **kw)
    assert tev.class_names == jev.class_names and len(tev.class_names) == 1000
    want = np.asarray(jev._build_class_embeddings(params))
    assert np.abs(tev.class_embeddings(tev.prompt_tokens()).numpy() - want).max() <= 1e-5
    assert tev.run()[0][1] == jev.run({"params": params})[0][1]


def test_disclf_reads_a_prepared_directory_and_an_npz(models, tmp_path):
    from PIL import Image

    from openvision_tpu_torch.data import prepare

    model, jmodel, params, mesh = models
    imgs = _images(6, 11)
    for i, img in enumerate(imgs):
        os.makedirs(tmp_path / "tree" / f"c{i % 3}", exist_ok=True)
        Image.fromarray(img).save(tmp_path / "tree" / f"c{i % 3}" / f"{i}.png")
    prepare.prepare(str(tmp_path / "tree"), str(tmp_path / "tf"), shards=2)
    np.savez(tmp_path / "d.npz", image=imgs, label=np.arange(6) % 3)
    for data_dir in (str(tmp_path / "tf"), str(tmp_path / "d.npz")):
        kw = dict(data_dir=data_dir, pp_img=CROP, pp_txt=TOK, device_norm="vgg",
                  class_names=NAMES[:3], prompt_templates="simple", batch_size=4)
        jev = jdisclf.Evaluator(jmodel, mesh, **kw)
        tev = tdisclf.Evaluator(model, **kw)
        assert tev.run()[0][1] == jev.run({"params": params})[0][1]
        assert tev.counts[1] == 6


def test_disclf_gives_the_trainers_model_back_in_train_mode(models):
    model = models[0]
    model.train()
    try:
        tev = tdisclf.Evaluator(model, data_dir="synthetic", pp_img=CROP, pp_txt=TOK,
                                device_norm="vgg", class_names=NAMES, prompt_templates="none",
                                batch_size=16)
        tev.run()
        assert model.visual.training and model.text.training
    finally:
        model.eval()


# ---------------------------------------------------------------------------
# retrieval and the contrastive monitor
# ---------------------------------------------------------------------------


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(2)
    sim = rng.standard_normal((9, 23)).astype(np.float32)
    txt2img = rng.integers(0, 9, 23)
    assert tretrieval.recall_at_k(sim, txt2img) == jretrieval.recall_at_k(sim, txt2img)
    assert tretrieval.recall_at_k(sim, txt2img, ks=(2, 3)) == jretrieval.recall_at_k(
        sim, txt2img, ks=(2, 3))


@pytest.mark.parametrize("norm", ["", "vgg"])
def test_retrieval_matches_jax(models, norm):
    model, jmodel, params, mesh = models
    words = ["cat", "dog", "car", "tree", "house", "river", "bird", "boat", "snow", "sun", "red"]
    rng = np.random.default_rng(9)
    caps = np.empty(12, object)
    for i in range(12):
        caps[i] = [" ".join(rng.choice(words, 4)) for _ in range(1 + i % 3)]
    data = {"image": _images(12, 13), "captions": caps}
    pp = CROP if norm else CROP + "|vgg_value_range"
    kw = dict(pp_img=pp, pp_txt=TOK, device_norm=norm, batch_size=5)
    want = dict(jretrieval.Evaluator(jmodel, mesh, source=jpipe.DictSource(data), **kw).run(
        {"params": params}))
    got = dict(tretrieval.Evaluator(model, source=tpipe.DictSource(data), **kw).run())
    assert sorted(got) == sorted(want) and len(got) == 6
    assert got == want


def test_contrastive_matches_jax(models):
    model, jmodel, params, mesh = models
    rng = np.random.default_rng(4)
    data = {"image": rng.standard_normal((10, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(1, 30000, (10, 16))}
    want = dict(jcontrastive.Evaluator(jmodel, mesh, source=jpipe.DictSource(data),
                                       batch_size=4, num_batches=2).run({"params": params}))
    got = dict(tcontrastive.Evaluator(model, source=tpipe.DictSource(data), batch_size=4,
                                      num_batches=2).run())
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * max(1.0, abs(want["loss"]))
    assert got["ncorrect"] == want["ncorrect"]
    assert tcontrastive.Evaluator(model).run() == []


def test_from_config_maps_types_and_skips_unavailable(models):
    model = models[0]
    cfg = {"evals": {
        "disclf": dict(type="discriminative_classifier", data_dir="synthetic", pp_txt=TOK,
                       prefix="z/0shot/", log_steps=7),
        "retrieval": dict(type="proj.image_text.retrieval", data_dir=""),
        "contrastive": dict(type="contrastive")}}
    errors = []
    built = tcommon.from_config(cfg, model, on_error=lambda n, e: errors.append(n))
    assert [(n, type(e).__module__, s, p) for n, e, s, p in built] == [
        ("disclf", "openvision_tpu_torch.evaluators.disclf", 7, "z/0shot/"),
        ("contrastive", "openvision_tpu_torch.evaluators.contrastive", 1000, "contrastive/")]
    assert errors == ["retrieval"]
    with pytest.raises(ValueError, match="retrieval evaluator needs"):
        tcommon.from_config(cfg, model)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TRAIN_ARG = ("openvision_tpu_torch/configs/openvision.py:res=32,img=mu/16,txt_name=Ti,"
             "txt_decoder_name=Ti,token_len=16,output_token_len=8,vocab_size=30522")
EVAL_OVERRIDES = ["evals.disclf.data_dir=synthetic", "evals.disclf.batch_size=16",
                  "evals.disclf.prompt_templates=none", "evals.retrieval.data_dir=synthetic",
                  "evals.retrieval.batch_size=8", "model.text.depth=2",
                  "model.text_decoder_config.depth=1", "input.batch_size=8",
                  "input.data.num_examples=16", "schedule.0.1.warmup_steps=1"]
EVAL_KEYS = {"z/0shot/imagenet2012_accuracy", "z/secs/eval/disclf", "z/secs/eval/retrieval",
             *(f"retrieval/{d}_recall@{k}" for d in ("txt2img", "img2txt") for k in (1, 5, 10))}


def _main(workdir, *overrides):
    args = ["--config", TRAIN_ARG, "--workdir", str(workdir), "--device", "cpu"]
    for ov in EVAL_OVERRIDES + list(overrides):
        args += ["--override", ov]
    main(args)
    return [json.loads(l) for l in open(os.path.join(workdir, "metrics.jsonl"))]


def test_eval_only_writes_the_jax_metric_names(tmp_path):
    rows = _main(tmp_path / "run", "eval_only=True")
    assert len(rows) == 1 and rows[0]["step"] == 0
    assert set(rows[0]) == EVAL_KEYS | {"step"}
    assert not os.path.exists(tmp_path / "run" / "checkpoints")


def test_evals_run_in_the_loop_once_a_step(tmp_path):
    rows = _main(tmp_path / "run", "total_steps=2", "log_training_steps=1",
                 "evals.disclf.log_steps=1", "evals.retrieval.log_steps=2")
    evals = [(r["step"], sorted(k for k in r if k in EVAL_KEYS)) for r in rows]
    disclf_keys = ["z/0shot/imagenet2012_accuracy", "z/secs/eval/disclf"]
    assert evals == [(1, disclf_keys), (2, sorted(EVAL_KEYS))]
    assert all("training_loss" in r for r in rows)


def test_evals_are_refused_by_name_on_a_process_mesh(models):
    """The name is from when a process mesh refused evaluators with data and
    eval_only; the trainer has no such refusal now. What a mesh still
    refuses by name: disclf's return_preds, a one-process probe, before any
    collective runs."""
    from openvision_tpu_torch.parallel import Mesh

    assert not hasattr(trainer, "refuse_evals_on_a_mesh")
    kw = dict(data_dir="synthetic", pp_img=CROP, pp_txt=TOK, device_norm="vgg",
              class_names=NAMES, prompt_templates="none", batch_size=16)
    for shape in (dict(data=2, fsdp=1, tensor=1), dict(data=1, fsdp=1, tensor=2)):
        mesh = Mesh(shape, dict(data=0, fsdp=0, tensor=0))
        tev = tdisclf.Evaluator(models[0], mesh, **kw)
        with pytest.raises(ValueError, match="return_preds is a single-process probe"):
            tev.run(return_preds=True)
    one = tdisclf.Evaluator(models[0], Mesh(dict(data=1, fsdp=1, tensor=1),
                                            dict(data=0, fsdp=0, tensor=0)), **kw)
    metrics, preds, masks = one.run(return_preds=True)  # a mesh of one process is one process
    assert metrics == tdisclf.Evaluator(models[0], **kw).run() and len(preds) == len(masks)

"""The port's interpretability CLIs against the JAX package's.

Each CLI runs on the tiny export of tests/test_torch_tools.py (f32, the
CPU) with ITERATIONS / STEPS patched small, beside the JAX CLI on the same
arguments: the same output files (names, shapes, dtypes; adversarial's PNG
equal to JAX's but for at most 0.1% of the values, where the sign of a
near-zero gradient flips), the same printout lines, and neuron_capture's
printed top features equal to JAX's wherever the top-k margin exceeds
1e-4 (values within 1e-3, the printed precision).
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from test_torch_tools import RES, model_dir  # noqa: F401  (the tiny export)
from torch_jax_wordpiece import jax_python_wordpiece  # noqa: E402,F401 (autouse)

IMG = "testcat/catcat.png"


def _top_lines(out: str) -> dict:
    tops = {}
    for m in re.finditer(r"layer\s+(\d+): (.*)", out):
        tops[int(m.group(1))] = [(int(f), float(v), int(t)) for f, v, t in
                                 re.findall(r"F(\d+) \(([-\d.]+) @tok(\d+)\)", m.group(2))]
    return tops


def test_neuron_capture_cli_matches_jax(model_dir, capsys):  # noqa: F811
    from openvision_tpu.tools import neuron_capture as jnc
    from openvision_tpu.tools.model_io import load_model as jload
    from openvision_tpu_torch.data.ops_image import decode_png
    from openvision_tpu_torch.tools import neuron_capture as tnc

    argv = ["--use_model", model_dir, "--image", IMG, "--topk", "4"]
    jnc.main(argv)
    want = capsys.readouterr().out
    tnc.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert "top neuron overall:" in got
    with open(IMG, "rb") as f:
        acts = jnc.capture_gelu(jload(model_dir), decode_png(f.read()))
    wt, gt = _top_lines(want), _top_lines(got)
    assert sorted(gt) == sorted(wt) == [0, 1]
    checked = 0
    for layer, feats in wt.items():
        per_feature = np.sort(acts[layer].max(axis=0))[::-1]
        for k, (want_f, got_f) in enumerate(zip(feats, gt[layer])):
            if per_feature[k] - per_feature[k + 1] > 1e-4:
                assert got_f[0] == want_f[0] and got_f[2] == want_f[2], (layer, k)
                assert abs(got_f[1] - want_f[1]) <= 1e-3
                checked += 1
    assert checked >= 4


def test_feature_viz_cli_writes_what_jax_writes(model_dir, tmp_path, monkeypatch,  # noqa: F811
                                                capsys):
    from openvision_tpu.tools import feature_viz as jfv
    from openvision_tpu_torch.data.ops_image import decode_png
    from openvision_tpu_torch.tools import feature_viz as tfv

    monkeypatch.setattr(jfv, "STEPS", 2)
    monkeypatch.setattr(tfv, "STEPS", 2)
    argv = ["--use_model", model_dir, "--layer", "0-1", "--feature", "3,7", "--size", "32"]
    jfv.main(argv + ["--out", str(tmp_path / "jax")])
    tfv.main(argv + ["--out", str(tmp_path / "torch"), "--deterministic", "--device", "cpu"])
    out = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) and len(names) == 4
    assert "L1 F7 step 0: act-loss" in out
    for name in names:
        img = decode_png((tmp_path / "torch" / name).read_bytes())
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8


def test_gradient_ascent_cli_writes_what_jax_writes(model_dir, tmp_path, monkeypatch,  # noqa: F811
                                                    capsys):
    from openvision_tpu.tools import gradient_ascent as jga
    from openvision_tpu_torch.tools import gradient_ascent as tga

    monkeypatch.setattr(jga, "ITERATIONS", 3)
    monkeypatch.setattr(tga, "ITERATIONS", 3)
    img = os.path.abspath(IMG)
    # the JAX tool's default vocab path is relative to the repo: a vocab.txt in
    # the model dir takes its place, so both tools can run in another directory
    model = str(tmp_path / "model")
    shutil.copytree(model_dir, model)
    shutil.copy("assets/bert_base_vocab_bos_eos.txt", os.path.join(model, "vocab.txt"))
    outs = {}
    for name, mod, extra in (("jax", jga, []), ("torch", tga, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        mod.main(["--use_model", model, "--use_image", img, "--batch_size", "3",
                  "--deterministic"] + extra)
        outs[name] = capsys.readouterr().out
        assert sorted(os.listdir(d)) == ["opinion-tokens", "txtembeds"]
        assert os.listdir(d / "opinion-tokens") == ["tokens_catcat.txt"]
        assert os.listdir(d / "txtembeds") == ["catcat_text_embedding.pt"]
    assert "Iteration 0: Average Loss:" in outs["torch"] and "New best loss" in outs["torch"]
    assert (tmp_path / "torch" / "opinion-tokens" / "tokens_catcat.txt").read_text().strip()
    want = torch.load(tmp_path / "jax" / "txtembeds" / "catcat_text_embedding.pt")
    got = torch.load(tmp_path / "torch" / "txtembeds" / "catcat_text_embedding.pt")
    assert got.shape == want.shape == (3, 32) and got.dtype == want.dtype == torch.float32
    assert got.device.type == "cpu"


@pytest.mark.parametrize("mode", [[], ["--target", "a dog"], ["--unsigned"]])
def test_adversarial_cli_writes_what_jax_writes(model_dir, tmp_path, capsys, mode):  # noqa: F811
    from openvision_tpu.tools import adversarial as jadv
    from openvision_tpu_torch.data.ops_image import decode_png
    from openvision_tpu_torch.tools import adversarial as tadv

    argv = ["--use_model", model_dir, "--image", IMG, "--labels", "a cat,a dog,text",
            "--iters", "3"] + mode
    outs = {n: str(tmp_path / f"{n}.png") for n in ("jax", "torch")}
    jadv.main(argv + ["--out", outs["jax"]])
    want = capsys.readouterr().out.replace(outs["jax"], "OUT")
    tadv.main(argv + ["--out", outs["torch"], "--device", "cpu"])
    got = capsys.readouterr().out.replace(outs["torch"], "OUT")
    # the same printout, the probabilities to the 4 printed digits but for rounding
    jl, tl = want.splitlines(), got.splitlines()
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert re.sub(r"[-\d.]+", "#", a) == re.sub(r"[-\d.]+", "#", b)
    a, b = (decode_png((tmp_path / f"{n}.png").read_bytes()) for n in ("jax", "torch"))
    # equal but where a near-zero gradient's sign flips (signed steps), at most 0.1%
    assert a.shape == b.shape == (RES, RES, 3) and (a != b).mean() <= 1e-3

"""The port imports neither JAX, flax, optax, grain, Triton, tensorflow,
tensorflow_datasets, protobuf, tensorstore nor orbax, directly or through
openvision_tpu, nor Pillow, transformers, tokenizers or regex when its
modules are imported (the card's machine may lack them); no line of chip_smoke.py imports JAX, tensorstore, orbax or
openvision_tpu; and chip_smoke.py refuses to run without a card."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "openvision_tpu_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_imports_no_jax_flax_or_triton():
    mods = _port_modules()
    for m in ("ops.fused_encoder", "ops.grad_kernels", "losses", "optim", "train.step",
              "train.trainer", "main_clip", "data.pipeline", "data.bert_ops", "utils.registry",
              "ops.fused_encoder_int8", "serving.quant", "serving.server", "parallel",
              "parallel.mesh", "ops.fused_attention", "train.checkpoint", "convert.openclip",
              "data.tfrecord", "data.prepare", "data.ops_image", "evaluators.common",
              "evaluators.disclf", "evaluators.retrieval", "evaluators.contrastive",
              "evaluators.prompts", "evaluators.in1k_classes", "tools.augment", "tools.capture",
              "tools.optimizers", "tools.feature_viz", "tools.gradient_ascent",
              "tools.neuron_capture", "tools.adversarial", "train.codecs", "train.zarr",
              "train.ocdbt", "models.compat", "models.loading", "convert.export",
              "ops.ring_attention", "ops.pipeline_parallel", "data.hf_tokenizer",
              "data.unicode_tables", "data.hf_classes", "data.gen_hf_tables"):
        assert f"openvision_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'grain', 'triton', 'openvision_tpu', 'tensorflow', "
        "'tensorflow_datasets', 'PIL', 'tensorstore', 'orbax', 'transformers', 'tokenizers', "
        "'regex') "
        "or m.startswith('google.protobuf'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax_tensorstore_orbax_or_the_jax_package():
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    bad = sorted(n for n in names if n.split(".")[0] in
                 ("jax", "jaxlib", "tensorstore", "orbax", "openvision_tpu"))
    assert not bad, bad
    assert "openvision_tpu_torch.train.checkpoint" in names


def test_chip_smoke_defines_each_top_level_name_once():
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert sorted({n for n in names if names.count(n) > 1}) == []


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

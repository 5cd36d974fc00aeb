"""The trainer's options and the towers' drop-path, on the CPU.

- SIGTERM: a ``main_clip`` subprocess sent SIGTERM after its step-2 log
  line writes the checkpoint of the step it is at and exits 0; a second run
  resumes from it and ends on the parameters of an uninterrupted run
  (exact: the same ops on the same data in the same order);
- ``steps_per_dispatch=2`` runs chunks of two updates (between log steps)
  and ends on the parameters of ``steps_per_dispatch=1`` (exact);
- ``profile_start_step`` / ``profile_stop_step`` write a Chrome trace under
  ``workdir/profile``;
Torch runs one intra-op thread here (the subprocesses too), as the suite
runs this file beside others on a shared CPU.

- drop-path in the text tower and in the caption decoder (concat and
  cross_attn) on given masks: the JAX modules' ``DropPath`` and the port's
  fed the same per-call masks, outputs within 1e-4 (f32, summation order
  only); with a generator the port's masks are a function of its seed;
- dropout in every tower (the image tower's embedding, the text tower's,
  each block's attention probabilities, attention output, MLP hidden and
  MLP output, the decoder's concat and cross-attention blocks) on given
  masks: the keep masks the JAX modules draw (``jax.random.bernoulli``),
  call by call, fed to the port's draws in the same order, outputs within
  1e-4.
"""

import itertools
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.models import decoder as jdec
from openvision_tpu.models import layers as jlayers
from openvision_tpu.models import text as jtext
from openvision_tpu.parallel import unbox
from openvision_tpu_torch.convert.openclip import (
    jax_decoder_to_state_dict, jax_params_to_state_dict)
from openvision_tpu_torch.main_clip import apply_override
from openvision_tpu_torch.models import decoder as tdec
from openvision_tpu_torch.models import layers as tlayers
from openvision_tpu_torch.models import text as ttext
from openvision_tpu_torch.train import checkpoint as tckpt
from openvision_tpu_torch.train import trainer
from openvision_tpu_torch.train.chrono import Chrono
from openvision_tpu_torch.configs import openvision as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=12,"
       "remat=full")
@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OVERRIDES = ["input.batch_size=4", "input.data.num_examples=24", "input.data.res=40",
             "model.out_dim=32", "schedule.0.1.warmup_steps=1", "log_training_steps=1",
             "ckpt_steps=100", "lr=0.001"]


def _cli(workdir: str, total: int) -> list:
    args = [sys.executable, "-u", "-m", "openvision_tpu_torch.main_clip", "--config",
            f"openvision_tpu_torch/configs/openvision.py:{ARG}", "--workdir", workdir,
            "--device", "cpu", "--override", f"total_steps={total}"]
    for ov in OVERRIDES:
        args += ["--override", ov]
    return args


def _params(workdir: str, step: int) -> dict:
    """The params of a workdir's step (an Orbax step directory), by the
    port's names."""
    return tckpt.load_state_dict(os.path.join(workdir, "checkpoints"), step)


def test_sigterm_checkpoints_the_current_step_and_resumes(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    subprocess.run(_cli(full, 5), cwd=REPO, env=env, check=True, capture_output=True,
                   timeout=600)
    proc = subprocess.Popen(_cli(cut, 5), cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("NOTE: step 2/5"):
                proc.send_signal(signal.SIGTERM)
                break
        lines += proc.stdout.readlines()
        assert proc.wait(timeout=600) == 0, "".join(lines)
    finally:
        proc.kill()
    saved = tckpt.saved_steps(os.path.join(cut, "checkpoints"))
    assert len(saved) == 1 and 2 <= saved[0] < 5, (saved, "".join(lines))
    assert any("preemption signal at step" in line for line in lines)
    rows = [json.loads(line) for line in open(os.path.join(cut, "metrics.jsonl"))]
    assert rows[-1]["step"] == saved[0]

    resumed = subprocess.run(_cli(cut, 5), cwd=REPO, env=env, check=True, capture_output=True,
                             text=True, timeout=600)
    assert f"resuming from step {saved[0]}" in resumed.stdout
    want, got = _params(full, 5), _params(cut, 5)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _config(**over) -> dict:
    c = tcfg.get_config(ARG)
    c["input"]["data"] = dict(name="synthetic", num_examples=24, res=40)
    for ov in OVERRIDES + [f"{k}={v}" for k, v in over.items()]:
        apply_override(c, ov)
    return c


def test_steps_per_dispatch_gives_the_parameters_of_one(monkeypatch):
    chunks = []
    step_done = Chrono.step_done

    def recording(self, step_time, wait_time, steps=1):
        chunks.append(steps)
        return step_done(self, step_time, wait_time, steps)

    monkeypatch.setattr(Chrono, "step_done", recording)
    runs = {}
    for k in (1, 2):
        chunks.clear()
        model, opt, _ = trainer.train(_config(total_steps=5, log_training_steps=4,
                                              steps_per_dispatch=k), None, "cpu")
        runs[k] = (model.state_dict(), list(chunks))
        assert opt.state["count"] == 5
    assert runs[1][1] == [1] * 5
    assert runs[2][1] == [2, 2, 1]  # steps 1-2, 3-4 (the log step ends a chunk), 5
    for n, v in runs[1][0].items():
        assert torch.equal(v, runs[2][0][n]), n


def test_profiler_writes_a_trace(tmp_path):
    trainer.train(_config(total_steps=3, profile_start_step=2, profile_stop_step=3),
                  str(tmp_path), "cpu")
    path = tmp_path / "profile" / "trace-2-3.json"
    assert path.exists()
    assert json.loads(path.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# drop-path in the text tower and the decoder, on given masks
# ---------------------------------------------------------------------------


def _given_masks(monkeypatch, n: int, seed: int):
    """Both packages' DropPath take their per-sample masks, call by call,
    from one seeded list (each package's calls counted apart)."""
    rng = np.random.default_rng(seed)
    masks = [rng.random(n) < 0.6 for _ in range(64)]
    calls = {"jax": itertools.count(), "torch": itertools.count()}

    def jax_call(self, x, deterministic=True):
        if deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        m = masks[next(calls["jax"])].astype(np.float32).reshape((n,) + (1,) * (x.ndim - 1))
        return x / keep * jnp.asarray(m)

    def torch_forward(self, x, generator=None):
        if generator is None or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        m = masks[next(calls["torch"])].astype(np.float32).reshape((n,) + (1,) * (x.ndim - 1))
        return x / keep * torch.from_numpy(m)

    monkeypatch.setattr(jlayers.DropPath, "__call__", jax_call)
    monkeypatch.setattr(tlayers.DropPath, "forward", torch_forward)
    return calls


def test_text_tower_drop_path_on_given_masks(monkeypatch):
    n, length, vocab = 3, 10, 50
    calls = _given_masks(monkeypatch, 2 * n, seed=1)
    cfg = dict(width=32, depth=3, mlp_dim=64, num_heads=2, vocab_size=vocab, drop_path=0.3,
               pool_type="last", output_tokens=True)
    ids = np.random.default_rng(0).integers(0, vocab, (2 * n, length)).astype(np.int32)
    jmodel = jtext.TextTransformer(num_classes=16, **cfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    want = jmodel.apply({"params": params}, jnp.asarray(ids), train=True,
                        rngs={"dropout": jax.random.PRNGKey(1),
                              "drop_path": jax.random.PRNGKey(1)})
    port = ttext.TextTransformer(num_classes=16, context_length=length, **cfg)
    port.load_state_dict({k.removeprefix("text."): v
                          for k, v in jax_params_to_state_dict({"txt": params}).items()})
    got = port(torch.from_numpy(ids), train=True, rng=torch.Generator().manual_seed(0))
    assert next(calls["jax"]) == next(calls["torch"]) == 4  # blocks 1 and 2, two branches
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    # eval: no drop-path; the masks move the output
    plain = port(torch.from_numpy(ids))
    assert not torch.allclose(plain[0], got[0])


@pytest.mark.parametrize("fusion", ["concat", "cross_attn"])
def test_decoder_drop_path_on_given_masks(monkeypatch, fusion):
    n = 2
    calls = _given_masks(monkeypatch, n, seed=2)
    rng = np.random.default_rng(3)
    img = rng.standard_normal((n, 5, 24)).astype(np.float32)
    txt = rng.standard_normal((n, 4, 16)).astype(np.float32)
    dec = dict(width=32, depth=4, mlp_dim=64, num_heads=2, num_classes=40,
               num_learnable_tokens=3, drop_path=0.3, fusion_style=fusion, attn_impl="xla")
    jmodel = jdec.TextDecoder(**dec)
    params = unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img),
                               jnp.asarray(txt))["params"])
    want, _ = jmodel.apply({"params": params}, jnp.asarray(img), jnp.asarray(txt), train=True,
                           rngs={"dropout": jax.random.PRNGKey(1),
                                 "drop_path": jax.random.PRNGKey(1)})
    port = tdec.TextDecoder(image_width=24, text_width=16, **dec)
    port.load_state_dict({k.removeprefix("txt_decoder."): torch.tensor(v)
                          for k, v in jax_decoder_to_state_dict(params).items()})
    got = port(torch.from_numpy(img), torch.from_numpy(txt), train=True,
               rng=torch.Generator().manual_seed(0))
    # concat: blocks 1-3 of 4 drop; cross_attn: self-attention block 1 of 2
    want_calls = 6 if fusion == "concat" else 2
    assert next(calls["jax"]) == next(calls["torch"]) == want_calls
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_port_masks_follow_the_generator():
    dec = tdec.TextDecoder(width=32, depth=2, mlp_dim=64, num_heads=2, num_classes=40,
                           num_learnable_tokens=3, image_width=24, text_width=16, drop_path=0.5,
                           dropout=0.1)
    for p in dec.parameters():
        p.data.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(p.numel()))
    img, txt = torch.randn(4, 5, 24), torch.randn(4, 4, 16)
    a = dec(img, txt, train=True, rng=torch.Generator().manual_seed(1))
    b = dec(img, txt, train=True, rng=torch.Generator().manual_seed(1))
    c = dec(img, txt, train=True, rng=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, c)
    torch.testing.assert_close(dec(img, txt), dec(img, txt))  # not training: no masks


# ---------------------------------------------------------------------------
# dropout in every tower, on given masks
# ---------------------------------------------------------------------------


def _shared_dropout_masks(monkeypatch):
    """JAX's keep masks are drawn and recorded call by call; the port's
    ``torch.rand`` then returns, call by call, 0 where JAX kept and 1 where
    it dropped (u < keep is the port's keep test)."""
    rng = np.random.default_rng(0)
    masks = []

    def bernoulli(key, p=0.5, shape=None):
        m = rng.random(shape) < p
        masks.append(m)
        return jnp.asarray(m)

    def rand(*shape, generator=None, device=None, dtype=torch.float32):
        shape = shape[0] if len(shape) == 1 and isinstance(shape[0], (tuple, torch.Size)) \
            else shape
        m = masks.pop(0)
        assert m.size == int(np.prod(shape)), (m.shape, shape)
        return torch.from_numpy(np.where(m, 0.0, 1.0).astype(np.float32).reshape(shape))

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return masks, rand


@pytest.mark.parametrize("tower", ["image", "text", "concat", "cross_attn"])
def test_dropout_on_given_masks_matches_jax(monkeypatch, tower):
    from openvision_tpu.models import vit as jvit
    from openvision_tpu_torch.models import vit as tvit

    masks, rand = _shared_dropout_masks(monkeypatch)
    rng = np.random.default_rng(5)
    rngs = {"dropout": jax.random.PRNGKey(1), "drop_path": jax.random.PRNGKey(1)}
    block = dict(width=32, depth=2, mlp_dim=64, num_heads=2, dropout=0.2, attn_impl="xla")
    if tower == "image":
        x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
        cfg = dict(block, patch_size=(8, 8), posemb="learn", pool_type="gap")
        jmodel = jvit.ViT(num_classes=8, **cfg)
        params = unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
        want = jmodel.apply({"params": params}, jnp.asarray(x), train=True, rngs=rngs)
        port = tvit.Model(8, image_size=16, **cfg)
        port.load_state_dict({k.removeprefix("visual."): v for k, v in
                              jax_params_to_state_dict({"img": params}).items()})
        args = (torch.from_numpy(x),)
    elif tower == "text":
        x = rng.integers(0, 50, (3, 9)).astype(np.int32)
        cfg = dict(block, vocab_size=50, pool_type="last")
        jmodel = jtext.TextTransformer(num_classes=8, **cfg)
        params = unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
        want = jmodel.apply({"params": params}, jnp.asarray(x), train=True, rngs=rngs)
        port = ttext.TextTransformer(num_classes=8, context_length=9, **cfg)
        port.load_state_dict({k.removeprefix("text."): v for k, v in
                              jax_params_to_state_dict({"txt": params}).items()})
        args = (torch.from_numpy(x),)
    else:
        img = rng.standard_normal((2, 5, 24)).astype(np.float32)
        txt = rng.standard_normal((2, 4, 16)).astype(np.float32)
        cfg = dict(block, depth=4, num_classes=40, num_learnable_tokens=3, fusion_style=tower)
        jmodel = jdec.TextDecoder(**cfg)
        params = unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img),
                                   jnp.asarray(txt))["params"])
        want, _ = jmodel.apply({"params": params}, jnp.asarray(img), jnp.asarray(txt),
                               train=True, rngs=rngs)
        port = tdec.TextDecoder(image_width=24, text_width=16, **cfg)
        port.load_state_dict({k.removeprefix("txt_decoder."): torch.tensor(v)
                              for k, v in jax_decoder_to_state_dict(params).items()})
        args = (torch.from_numpy(img), torch.from_numpy(txt))
    drawn = len(masks)
    monkeypatch.setattr(torch, "rand", rand)
    got = port(*args, train=True, rng=torch.Generator().manual_seed(0))
    assert drawn >= 8 and not masks  # every JAX draw had a port draw, in order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)

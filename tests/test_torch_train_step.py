"""One whole train step and the trainer, against the JAX package's, on the CPU.

- one train step of the tiny config (tests/test_train_step.py) on a
  one-device mesh: loss within 1e-5 relative, every gradient within 1e-4 of
  its norm, and the parameters after the optimizer step within 1e-6 given
  the JAX gradients. Both sides run attention on ``xla`` here: the JAX
  side's ``auto`` pick would run the whole model's Pallas kernels in
  interpret mode, far over this file's time budget; tests/test_torch_grads.py
  holds the fused block's and flash attention's backward to the Pallas
  kernels instead;
- the trainer: 3 steps on the CPU write metrics and checkpoints, and a run
  resumed at step 2 ends on the parameters of an uninterrupted one; the CLI
  refuses ``--device cuda`` without a card and trains on ``--device cpu``.
Torch runs one intra-op thread here, as the suite runs this file beside
others on a shared CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openvision_tpu import optim as joptim
from openvision_tpu.configs import openvision as jcfg
from openvision_tpu.parallel import create_mesh
from openvision_tpu.train import step as jstep
from openvision_tpu_torch.configs import openvision as tcfg
from openvision_tpu_torch.convert.openclip import (
    jax_params_to_state_dict, state_dict_to_jax_params, tree_flatten_with_names)
from openvision_tpu_torch.main_clip import apply_override, main
from openvision_tpu_torch.train import step as tstep
from openvision_tpu_torch.train import trainer


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tiny_config(**kw):
    c = tcfg.get_config("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
                        "output_token_len=8,vocab_size=64,runlocal=True,remat=none")
    c["input"]["batch_size"] = 16
    c["model"]["out_dim"] = (32, 32)
    c["lr"] = 1e-3
    c.update(kw)
    return c


def _heads(model):
    return dict(num_heads_vision=model.visual.transformer.resblocks[0].num_heads,
                num_heads_text=model.text.transformer.resblocks[0].num_heads,
                num_heads_decoder=model.txt_decoder.transformer.resblocks[0].num_heads)


def _to_jax(sd, model):
    return jax.tree.map(jnp.asarray, state_dict_to_jax_params(
        {k: v.detach().numpy() for k, v in sd.items()}, **_heads(model)))


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------


def _fake_batch(b=16, rng=0):
    r = np.random.RandomState(rng)
    return {"image": r.randint(0, 255, (b, 32, 32, 3)).astype(np.uint8),
            "labels1": r.randint(0, 64, (b, 16)).astype(np.int32),
            "labels2": r.randint(0, 64, (b, 16)).astype(np.int32),
            "autoreg_labels": r.randint(0, 64, (b, 8)).astype(np.int32),
            "cap_loss_mask": (r.rand(b, 8) > 0.2).astype(np.float32)}


def _jax_tiny_config():
    c = jcfg.get_config("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
                        "output_token_len=8,vocab_size=64,runlocal=True,remat=none,"
                        "attn_impl=xla,dec_attn_impl=xla")
    c.input.batch_size = 16
    c.init_shapes = [(16, 32, 32, 3), (32, 16)]
    c.model.out_dim = (32, 32)
    c.lr = 1e-3
    c.schedule = [(".*", dict(decay_type="cosine"))]
    return c


def _capturing(tx):
    """tx, with the gradients it is given kept in its state (so one compiled
    JAX step yields loss, gradients and updated parameters)."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def test_train_step_matches_jax_update_fn():
    tc = _tiny_config(schedule=[(".*", dict(decay_type="cosine"))], total_steps=10)
    for tower in ("image", "text", "text_decoder_config"):
        tc["model"][tower]["attn_impl"] = "xla"
    model = tstep.build_model(tc)
    opt = tstep.init_train_state(tc, model, total_steps=10, seed=0)
    params0 = _to_jax(model.state_dict(), model)
    batch = _fake_batch()

    jc = _jax_tiny_config()
    mesh = create_mesh(data=1, fsdp=1, tensor=1, devices=jax.devices()[:1])
    jmodel = jstep.build_model(jc)
    tx, _ = joptim.make(jc, params0, sched_kw=dict(total_steps=10, batch_size=16,
                                                   data_size=None))
    tx = _capturing(tx)
    with mesh:
        new_state, meas = jax.jit(jstep.make_update_fn(jc, jmodel, tx, mesh))(
            {"params": params0, "opt": tx.init(params0)}, batch, jax.random.PRNGKey(1))
    jgrads = jax.device_get(new_state["opt"][1])

    loss, _ = tstep.make_loss_fn(tc, model)(tstep.to_device(batch, "cpu"))
    loss.backward()
    assert _rel(loss.item(), float(meas["training_loss"])) <= 1e-5
    want = tree_flatten_with_names(jgrads)
    got = tree_flatten_with_names(state_dict_to_jax_params(
        {n: p.grad.numpy() for n, p in model.named_parameters()}, **_heads(model)))
    # a gradient that is zero in exact arithmetic (the key biases) holds
    # rounding noise on both sides: its floor is 1e-5 of the global norm
    floor = 1e-5 * float(meas["l2_grads"])
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-4 * max(np.linalg.norm(w), floor), k

    # the optimizer step from the JAX gradients
    opt.step(jax_params_to_state_dict(jgrads))
    want = tree_flatten_with_names(jax.device_get(new_state["params"]))
    got = tree_flatten_with_names(_to_jax(model.state_dict(), model))
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= 1e-6


# ---------------------------------------------------------------------------
# the trainer and its CLI
# ---------------------------------------------------------------------------


def _trainer_config(total_steps, ckpt_steps):
    c = tcfg.get_config("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
                        "output_token_len=12,vocab_size=30522,remat=full")
    c["input"]["batch_size"] = 8
    c["input"]["data"] = dict(name="synthetic", num_examples=24, res=40)
    c["model"]["out_dim"] = (32, 32)
    for ov in (f"total_steps={total_steps}", "lr=1e-3", "schedule.0.1.warmup_steps=1",
               "log_training_steps=1", f"ckpt_steps={ckpt_steps}"):
        apply_override(c, ov)
    return c


def test_trainer_writes_metrics_and_resumes_to_the_same_params(tmp_path):
    full, _, meas = trainer.train(_trainer_config(3, 100), str(tmp_path / "full"), "cpu")
    rows = [json.loads(l) for l in open(tmp_path / "full" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert {"training_loss", "clip_loss", "caption_loss", "l2_grads", "l2_params",
            "l2_updates", "img/sec", "host_wait_share"} <= set(rows[-1])
    assert np.isfinite(meas["training_loss"])
    assert sorted(os.listdir(tmp_path / "full" / "checkpoints")) == ["3", "data_position-3.json"]

    trainer.train(_trainer_config(2, 2), str(tmp_path / "cut"), "cpu")
    resumed, opt, _ = trainer.train(_trainer_config(3, 2), str(tmp_path / "cut"), "cpu")
    assert opt.state["count"] == 3
    for (n, a), b in zip(full.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), n


def test_main_clip_refuses_cuda_without_a_card_and_trains_on_cpu(tmp_path):
    args = ["--config", "openvision_tpu_torch/configs/openvision.py:res=32,img=mu/16,"
            "txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=12,remat=none",
            "--workdir", str(tmp_path), "--override", "input.batch_size=4",
            "--override", "input.data.num_examples=8", "--override", "total_steps=1",
            "--override", "schedule.0.1.warmup_steps=0"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            main(args)
    model, opt, meas = main(args + ["--device", "cpu"])
    assert opt.state["count"] == 1 and np.isfinite(meas["training_loss"])


def test_trainer_fine_tunes_from_a_jax_npz(tmp_path):
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.train.checkpoint import save_npz

    c = _trainer_config(1, 100)  # a 1-step warmup: step 1's learning rate is 0
    model = init_params(tstep.build_model(c), seed=7)
    save_npz(str(tmp_path / "ft.npz"), {"params": state_dict_to_jax_params(
        {k: v.numpy() for k, v in model.state_dict().items()}, **_heads(model))})
    c["ft_from"] = str(tmp_path / "ft.npz")
    trained, _, _ = trainer.train(c, None, "cpu")
    for (n, a), b in zip(model.state_dict().items(), trained.state_dict().values()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("policy", ["full", "minimal", "minimal_offloaded"])
def test_remat_policies_give_the_gradients_of_no_remat(policy):
    from openvision_tpu_torch.models.encoder import Encoder

    gen = torch.Generator().manual_seed(0)
    plain = Encoder(32, 2, 2, init_style="scaled", causal=True, remat_policy="none")
    for p in plain.parameters():
        p.data.normal_(0.0, 0.2, generator=gen)
    remat = Encoder(32, 2, 2, init_style="scaled", causal=True, remat_policy=policy)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 7, 32, generator=gen)
    grads = []
    for enc in (plain, remat):
        xi = x.clone().requires_grad_(True)
        (enc(xi, prefix_len=3) ** 2).sum().backward()
        grads.append([xi.grad] + [p.grad for p in enc.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Unknown remat policy"):
        Encoder(32, 1, 2, remat_policy="offloaded")


def test_init_draws_the_jax_initializers_distributions():
    """The seeded init against samples of the JAX package's own
    initializers (``_make_inits``) at the same shapes: std within 10%."""
    from openvision_tpu.models.encoder import _make_inits
    from openvision_tpu_torch.models.init import init_params

    model = init_params(tstep.build_model(_tiny_config()), seed=0)
    params = dict(model.named_parameters())
    vit, scaled = _make_inits("vit", 32, 1), _make_inits("scaled", 192, 12)
    checks = [("visual.transformer.resblocks.0.attn.in_proj_weight", vit["qkv"]),
              ("visual.transformer.resblocks.0.mlp.c_fc.weight", vit["fc"]),
              ("visual.transformer.resblocks.0.mlp.c_proj.weight", vit["proj"]),
              ("text.transformer.resblocks.0.attn.in_proj_weight", scaled["qkv"]),
              ("text.transformer.resblocks.3.attn.out_proj.weight", scaled["out"]),
              ("txt_decoder.transformer.resblocks.0.mlp.c_fc.weight", scaled["fc"]),
              ("txt_decoder.transformer.resblocks.5.mlp.c_proj.weight", scaled["proj"])]
    for name, init in checks:
        got = params[name].detach().numpy().T  # the flax (in, out) layout
        want = np.asarray(init(jax.random.PRNGKey(0), got.shape, jnp.float32))
        assert abs(got.std() - want.std()) <= 0.1 * want.std(), name
        assert abs(got.mean()) <= 0.1 * want.std(), name

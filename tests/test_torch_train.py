"""The port's training pieces against the JAX package's, on the CPU.

Same inputs, made with seeded numpy, go through both packages:

- the losses (openvision_tpu/losses.py): f32, within 1e-5 relative
  (summation order only);
- the learning-rate schedules and the optimizer chain (optim.py): the
  schedule within 1e-6 relative; three Adam updates from identical
  gradients, with a frozen group, weight decay on the ``.*/kernel$`` mask
  matched by flax path, and either the bf16 first moment with lr_mults or
  global-norm clipping: parameters within 1e-6 absolute (f32 arithmetic in
  the same order);
- the pp ops the base config names, on the same np.random.Generator state:
  identical outputs (the integer ops) or within 1e-4 (the float jitter);
tests/test_torch_train_step.py holds one whole train step and the trainer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openvision_tpu import losses as jlosses
from openvision_tpu import optim as joptim
from openvision_tpu.configs import openvision as jcfg
from openvision_tpu.parallel import create_mesh
from openvision_tpu_torch import losses, optim
from openvision_tpu_torch.configs import openvision as tcfg
from openvision_tpu_torch.convert.openclip import (
    jax_params_to_state_dict, state_dict_to_jax_params, tree_flatten_with_names)
from openvision_tpu_torch.train import step as tstep


def _mesh1():
    return create_mesh(data=1, fsdp=1, tensor=1, devices=jax.devices()[:1])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _embeddings(seed, b=8, d=16):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((3, b, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


@pytest.mark.parametrize("mode", ["global", "efficient", "local"])
def test_contrastive_loss_matches_jax(mode):
    zimg, v1, v2 = _embeddings(0)
    t = np.float32(10.0)
    want, wx = jlosses.bidirectional_contrastive_loss(zimg, [v1, v2], t, mode=mode, mesh=_mesh1())
    got, gx = losses.bidirectional_contrastive_loss(
        torch.from_numpy(zimg), [torch.from_numpy(v1), torch.from_numpy(v2)], torch.tensor(t),
        mode=mode)
    assert _rel(got.item(), float(want)) <= 1e-5
    assert _rel(gx["ncorrect"].item(), float(wx["ncorrect"])) <= 1e-6 or float(wx["ncorrect"]) == 0


def test_siglip_and_softmax_xent_match_jax():
    zimg, ztxt, _ = _embeddings(1)
    t, b = np.float32(10.0), np.float32(-3.0)
    want, _ = jlosses.siglip_loss(zimg, ztxt, t, b, mesh=_mesh1())
    got, _ = losses.siglip_loss(*(torch.from_numpy(a) for a in (zimg, ztxt)), torch.tensor(t),
                                torch.tensor(b))
    assert _rel(got.item(), float(want)) <= 1e-5
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 6)).astype(np.int32)
    mask = (rng.random((4, 6)) > 0.3).astype(np.float32)
    want = jlosses.softmax_xent(logits=logits, labels=labels, mask=mask)
    got = losses.softmax_xent(logits=torch.from_numpy(logits), labels=torch.from_numpy(labels),
                              mask=torch.from_numpy(mask))
    assert _rel(got.item(), float(want)) <= 1e-5


@pytest.mark.parametrize("chunk,normalize", [(4, True), (5, False), (16, True)])
def test_linear_softmax_xent_matches_jax(chunk, normalize):
    rng = np.random.default_rng(chunk)
    h = rng.standard_normal((3, 10, 8)).astype(np.float32)
    kernel = (rng.standard_normal((8, 40)) * 0.3).astype(np.float32)  # flax (D, V)
    labels = rng.integers(0, 40, (3, 10)).astype(np.int32)
    mask = (rng.random((3, 10)) > 0.2).astype(np.float32)
    want = jlosses.linear_softmax_xent(prelogits=h, kernel=kernel, labels=labels, mask=mask,
                                       chunk=chunk, normalize=normalize)
    th = torch.from_numpy(h).requires_grad_(True)
    tk = torch.from_numpy(kernel.T.copy()).requires_grad_(True)
    got = losses.linear_softmax_xent(prelogits=th, kernel=tk, labels=torch.from_numpy(labels),
                                     mask=torch.from_numpy(mask), chunk=chunk,
                                     normalize=normalize)
    assert _rel(got.item(), float(want)) <= 1e-5
    gh, gk = jax.grad(lambda a, k: jlosses.linear_softmax_xent(
        prelogits=a, kernel=k, labels=labels, mask=mask, chunk=chunk, normalize=normalize),
        argnums=(0, 1))(h, kernel)
    got.backward()
    assert _rel(th.grad.numpy(), gh) <= 1e-5 and _rel(tk.grad.numpy().T, gk) <= 1e-5


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(decay_type="cosine", warmup_steps=3),
    dict(decay_type="cosine", warmup_steps=2, min_lr=1e-4, max_lr=1e-3),
    dict(decay_type="linear", warmup_steps=2, cooldown_steps=3, linear_end=0.1),
    dict(decay_type="rsqrt", warmup_steps=4, timescale=5),
    dict(decay_type="stair", steps=[3, 7], mults=[0.5, 0.1]),
])
def test_schedule_values_match_jax(kw):
    want = joptim.create_learning_rate_schedule(total_steps=12, base=0.7, **kw)
    got = optim.create_learning_rate_schedule(total_steps=12, base=0.7, **kw)
    for s in range(13):
        assert abs(got(s) - float(want(jnp.int32(s)))) <= 1e-6 * max(abs(float(want(s))), 1e-6)


def _tiny_config(**kw):
    c = tcfg.get_config("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
                        "output_token_len=8,vocab_size=64,runlocal=True,remat=none")
    c["input"]["batch_size"] = 16
    c["model"]["out_dim"] = (32, 32)
    c["lr"] = 1e-3
    c["schedule"] = [(".*", dict(decay_type="cosine", warmup_steps=1))]
    c.update(kw)
    return c


def _tiny_port_model(seed=0, depth=None):
    c = _tiny_config()
    if depth:  # fewer blocks: faster eager optax over the tree
        c["model"]["text"]["depth"] = c["model"]["text_decoder_config"]["depth"] = depth
    model = tstep.build_model(c)
    from openvision_tpu_torch.models.init import init_params

    return init_params(model, seed)


def _heads(model):
    return dict(num_heads_vision=model.visual.transformer.resblocks[0].num_heads,
                num_heads_text=model.text.transformer.resblocks[0].num_heads,
                num_heads_decoder=model.txt_decoder.transformer.resblocks[0].num_heads)


def _to_jax(sd, model):
    return jax.tree.map(jnp.asarray, state_dict_to_jax_params(
        {k: v.detach().numpy() for k, v in sd.items()}, **_heads(model)))


@pytest.mark.parametrize("extra", [
    dict(optax=dict(mu_dtype="bfloat16", b1=0.9, b2=0.95), lr_mults=[("txt/.*", 0.5), (".*", 1.0)]),
    # clipping scales by a global norm whose f32 sum runs in another order in
    # each package; a bf16 mu would turn that into bf16 rounding flips
    dict(optax=dict(b1=0.9, b2=0.95), grad_clip_norm=5.0),
])
def test_optimizer_updates_match_optax(extra):
    model = _tiny_port_model(depth=1)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    config = dict(schedule=[("img/embedding/.*", None),
                            (".*", dict(decay_type="cosine", warmup_steps=1))],
                  lr=1e-2, wd=0.2, optax_name="scale_by_adam", **extra)
    sched_kw = dict(total_steps=10, batch_size=16, data_size=None)
    tx, _ = joptim.make(config, _to_jax(sd, model), sched_kw=sched_kw)
    jparams = _to_jax(sd, model)
    jstate = tx.init(jparams)
    tx_update = tx.update  # eager: jit would contract the moment updates into FMAs
    params = {k: torch.nn.Parameter(v.clone()) for k, v in sd.items()}
    opt = optim.Optimizer(config, params, sched_kw=sched_kw)
    assert opt.frozen == {"visual.conv1.weight"}  # emb_head_bias=False: no conv bias
    assert "visual.transformer.resblocks.0.attn.in_proj_weight" in opt.decays[0][0]
    assert "visual.transformer.resblocks.0.attn.in_proj_bias" not in opt.decays[0][0]
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
                 for k, v in sd.items()}
        updates, jstate = tx_update(_to_jax(grads, model), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(grads)
    want = tree_flatten_with_names(jax.device_get(jparams))
    got = tree_flatten_with_names(_to_jax({k: p.detach() for k, p in params.items()}, model))
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= 1e-6
    # the optimizer state both ways: the port's per-parameter mu/nu as the
    # JAX trees, and the JAX trees as the port's mu/nu
    adam = joptim.find_states(jstate, optax.ScaleByAdamState)[0]
    mu_dt = torch.bfloat16 if "mu_dtype" in config["optax"] else torch.float32
    for key, dt in (("mu", mu_dt), ("nu", torch.float32)):
        jtree = jax.tree.map(lambda x: jnp.zeros(()) if isinstance(x, optax.MaskedNode) else x,
                             getattr(adam, key),
                             is_leaf=lambda x: isinstance(x, optax.MaskedNode))
        back = jax_params_to_state_dict(jax.device_get(
            jax.tree.map(lambda a, p: jnp.broadcast_to(a, p.shape).astype(jnp.float32),
                         jtree, jparams)))
        for n in opt.live:  # mu within a bf16 rounding, else f32 summation order
            a, b = back[n].to(dt).float(), opt.state[key][n].float()
            tol = 2**-7 if dt == torch.bfloat16 else 1e-5
            assert (a - b).abs().max() <= tol * b.abs().max(), (key, n, (a - b).abs().max(),
                                                                 b.abs().max())
    assert opt.state["count"] == 3 == int(adam.count)


# ---------------------------------------------------------------------------
# pp ops
# ---------------------------------------------------------------------------


def test_pp_ops_match_jax_on_the_same_generator():
    from openvision_tpu.data import pp as jpp
    from openvision_tpu_torch.data import pp as tpp

    jpp.import_pp_modules()
    tpp.import_pp_modules()
    arg = "res=24,token_len=16,output_token_len=8"
    spec = tcfg.get_config(arg)["input"]["pp"]
    assert spec == jcfg.get_config(arg).input.pp
    rng = np.random.default_rng(5)
    for i in range(4):
        rec = {"jpg": rng.integers(0, 255, (40, 52, 3), np.uint8),
               "txt": "a photo of a cat sitting on a mat",
               "llava_caption": "an aerial view of a city at night. bright lights everywhere!"}
        want = jpp.build_pp_fn(spec)(dict(rec), np.random.default_rng(i))
        got = tpp.build_pp_fn(spec)(dict(rec), np.random.default_rng(i))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k].astype(np.float32), want[k].astype(np.float32),
                                       atol=1e-4, err_msg=k)

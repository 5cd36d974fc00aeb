"""GradCache (``grad_accum > 1``) against the big-batch step and against the
JAX package's accumulated step, on the CPU, on tests/test_grad_accum.py's
tiny config with the text tower and the decoder cut to 2 blocks each
(attention on ``xla`` on both sides, as tests/test_torch_train_step.py runs
it); torch runs one intra-op thread here, as the suite runs this file
beside others on a shared CPU.

- the port at grad_accum=4 against the port at grad_accum=1 on the same
  parameters and batch, for ``coca``, ``clip`` and ``siglip``: the loss
  terms within 1e-6 relative, every gradient within 1e-5 of its norm (f32
  resolution: the two sum in another order);
- the port at grad_accum=4 against the JAX ``_make_update_fn_accum`` on the
  same parameters and batch: loss within 1e-5 relative, every gradient
  within 1e-4 of its norm (floor 1e-5 of the global norm), as the one-step
  test holds accum=1;
- microbatch i holds rows i::accum, the JAX ``_microbatch``'s assignment;
- with token masking (ratio 0.5), dropout and drop-path in every tower and
  a step generator, pass 2 replays pass 1's draws: each microbatch's
  embeddings in pass 2 equal the ones pass 1 cached, exactly, and the
  accumulated gradient is the autograd gradient of the whole batch's loss
  on those same per-microbatch draws (every gradient within 1e-5 of its
  norm), for ``coca``, ``clip`` and ``siglip``;
- one accumulated update through ``make_update_fn`` reports the big-batch
  update's loss, gradient norm and parameter norm (within 1e-5 relative);
- on a process mesh grad_accum > 1 and siglip build and run (the name of
  the test is from when the mesh refused them; tests/test_torch_mesh_recipe.py
  holds them across processes against one process): siglip returns this
  shard's share of the loss, and a microbatch count that does not divide
  this process's batch is refused by name.
"""

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
    state_dict_to_jax_params, tree_flatten_with_names)
from openvision_tpu_torch.parallel import Mesh
from openvision_tpu_torch.train import step as tstep

ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=8,"
       "vocab_size=64,runlocal=True,remat=none,attn_impl=xla,dec_attn_impl=xla")
LOSSES = ["coca", "clip", "siglip"]
DEPTH = 2  # the text tower's and the decoder's blocks


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(loss_type: str, accum: int) -> dict:
    c = tcfg.get_config(ARG)
    c["input"]["batch_size"] = 16
    c["model"]["out_dim"] = (32, 32)
    c["lr"] = 1e-3
    c["schedule"] = [(".*", dict(decay_type="cosine", warmup_steps=1))]
    c["loss_type"], c["grad_accum"] = loss_type, accum
    c["model"]["text"]["depth"] = c["model"]["text_decoder_config"]["depth"] = DEPTH
    if loss_type == "siglip":
        c["model"]["init_logit_bias"] = -10.0
    return c


def _batch(b=16, seed=0):
    r = np.random.RandomState(seed)
    return {"image": r.randint(0, 255, (b, 32, 32, 3)).astype(np.uint8),
            "labels1": r.randint(0, 64, (b, 16)).astype(np.int32),
            "labels2": r.randint(0, 64, (b, 16)).astype(np.int32),
            "autoreg_labels": r.randint(0, 64, (b, 8)).astype(np.int32),
            "cap_loss_mask": (r.rand(b, 8) > 0.2).astype(np.float32)}


def _grads(c: dict, batch: dict):
    model = tstep.build_model(c)
    opt = tstep.init_train_state(c, model, total_steps=10, seed=0)
    meas, grads = tstep.make_grad_fn(c, model, opt)(tstep.to_device(batch, "cpu"))
    return model, meas, grads


def _heads(model):
    return dict(num_heads_vision=model.visual.transformer.resblocks[0].num_heads,
                num_heads_text=model.text.transformer.resblocks[0].num_heads,
                num_heads_decoder=model.txt_decoder.transformer.resblocks[0].num_heads)


@pytest.mark.parametrize("loss_type", LOSSES)
def test_accum_matches_the_big_batch_step(loss_type):
    batch = _batch()
    _, m1, g1 = _grads(_config(loss_type, 1), batch)
    _, m4, g4 = _grads(_config(loss_type, 4), batch)
    assert set(m1) == set(m4)
    for k in ("training_loss", "clip_loss", "caption_loss", "t", "nimg", "ntxt"):
        if k in m1:
            assert abs(float(m4[k]) - float(m1[k])) <= 1e-6 * abs(float(m1[k])), k
    for n, g in g1.items():
        assert (g4[n] - g).abs().max() <= 1e-5 * max(torch.linalg.norm(g).item(), 1e-12), n
    if loss_type == "siglip":
        assert g4["logit_bias"].abs() > 0


def _capturing(tx):
    """tx, with the gradients it is given kept in its state."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.mark.parametrize("loss_type", LOSSES)
def test_accum_matches_jax_accum_step(loss_type):
    batch = _batch(seed=1)
    model, meas, grads = _grads(_config(loss_type, 4), batch)
    params0 = jax.tree.map(jnp.asarray, state_dict_to_jax_params(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}, **_heads(model)))

    jc = jcfg.get_config(ARG)
    jc.input.batch_size = 16
    jc.init_shapes = [(16, 32, 32, 3), (32, 16)]
    jc.model.out_dim = (32, 32)
    jc.lr = 1e-3
    jc.schedule = [(".*", dict(decay_type="cosine"))]
    jc.loss_type, jc.grad_accum = loss_type, 4
    jc.model.text.depth = jc.model.text_decoder_config.depth = DEPTH
    if loss_type == "siglip":
        jc.model.init_logit_bias = -10.0
    mesh = create_mesh(data=1, fsdp=1, tensor=1, devices=jax.devices()[:1])
    tx, _ = joptim.make(jc, params0, sched_kw=dict(total_steps=10, batch_size=16,
                                                   data_size=None))
    tx = _capturing(tx)
    with mesh:
        new_state, jmeas = jax.jit(jstep.make_update_fn(jc, jstep.build_model(jc), tx, mesh))(
            {"params": params0, "opt": tx.init(params0)}, batch, jax.random.PRNGKey(1))
    loss = float(jmeas["training_loss"])
    assert abs(float(meas["training_loss"]) - loss) <= 1e-5 * abs(loss)
    want = tree_flatten_with_names(jax.device_get(new_state["opt"][1]))
    got = tree_flatten_with_names(state_dict_to_jax_params(
        {n: g.numpy() for n, g in grads.items()}, **_heads(model)))
    assert set(got) == set(want)
    floor = 1e-5 * float(jmeas["l2_grads"])
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-4 * max(np.linalg.norm(w), floor), k


def test_microbatches_are_strided_as_jax(monkeypatch):
    accum, batch = 4, _batch()
    seen = []
    forward = tstep.forward

    def recording(config, model, mb, rng=None, caption=True):
        seen.append((caption, mb["image"].clone()))
        return forward(config, model, mb, rng, caption)

    monkeypatch.setattr(tstep, "forward", recording)
    _grads(_config("coca", accum), batch)
    want = np.asarray(jstep._microbatch(jnp.asarray(batch["image"]), accum))
    assert [c for c, _ in seen] == [False] * accum + [True] * accum  # pass 1, then pass 2
    for i, (_, images) in enumerate(seen):
        np.testing.assert_array_equal(images.numpy(), want[i % accum])
        np.testing.assert_array_equal(images.numpy(), batch["image"][i % accum::accum])


def _drawing_config(loss_type: str) -> dict:
    """The accum=4 config with token masking, dropout and drop-path on."""
    c = _config(loss_type, 4)
    c["model"]["image"]["mask_ratio"] = 0.5
    for tower in ("image", "text", "text_decoder_config"):
        c["model"][tower].update(dropout=0.1, drop_path=0.1)
    return c


@pytest.mark.parametrize("loss_type", LOSSES)
def test_pass_two_replays_pass_one_draws(loss_type, monkeypatch):
    accum, batch = 4, _batch(seed=3)
    seen = []
    forward = tstep.forward

    def recording(config, model, mb, rng=None, caption=True):
        zimg, ztxt, out = forward(config, model, mb, rng, caption)
        seen.append((zimg.detach().clone(), ztxt.detach().clone()))
        return zimg, ztxt, out

    monkeypatch.setattr(tstep, "forward", recording)
    c = _drawing_config(loss_type)
    model = tstep.build_model(c)
    opt = tstep.init_train_state(c, model, total_steps=10, seed=0)
    tstep.make_grad_fn(c, model, opt)(tstep.to_device(batch, "cpu"),
                                      rng=tstep.step_generator(7, 0))
    assert len(seen) == 2 * accum
    for (zi1, zt1), (zi2, zt2) in zip(seen[:accum], seen[accum:]):
        assert torch.equal(zi1, zi2) and torch.equal(zt1, zt2)
    # the draws are real: another seed masks and drops otherwise
    mb = {k: v[0::accum] for k, v in tstep.to_device(batch, "cpu").items()}
    with torch.no_grad():
        other = forward(c, model, mb, tstep.micro_generator(12345), caption=False)[0]
    assert not torch.allclose(other, seen[0][0])


@pytest.mark.parametrize("loss_type", LOSSES)
def test_accum_is_the_gradient_on_the_microbatch_draws(loss_type):
    accum, batch = 4, _batch(seed=4)
    c = _drawing_config(loss_type)
    model = tstep.build_model(c)
    opt = tstep.init_train_state(c, model, total_steps=10, seed=0)
    b = tstep.to_device(batch, "cpu")
    meas, got = tstep.make_grad_fn(c, model, opt)(b, rng=tstep.step_generator(7, 0))
    got = {n: g.clone() for n, g in got.items()}

    # the reference: one autograd pass of the whole batch's loss, each
    # microbatch's forward on the generator of its seed
    coca = loss_type == "coca"
    seeds = tstep.micro_seeds(tstep.step_generator(7, 0), accum)
    model.zero_grad(set_to_none=True)
    zimgs, v1s, v2s, cap = [], [], [], 0.0
    for i, seed in enumerate(seeds):
        mb = {k: v[i::accum] for k, v in b.items()}
        zimg, ztxt, out = tstep.forward(c, model, mb, tstep.micro_generator(seed), caption=coca)
        half = ztxt.shape[0] // 2
        zimgs.append(zimg)
        v1s.append(ztxt[:half])
        v2s.append(ztxt[half:])
        if coca:
            cap = cap + tstep.caption_sum(c, model, out, mb)
    loss = tstep.contrastive_loss(loss_type, torch.cat(zimgs), [torch.cat(v1s), torch.cat(v2s)],
                                  out["t"], out.get("b"), mode="local")[0]
    if coca:
        loss = c["clip_loss_weight"] * loss + c["coca_caption_loss_weight"] * cap / (
            b["cap_loss_mask"].float().sum() + 1e-8)
    loss.backward()
    assert abs(float(meas["training_loss"]) - loss.item()) <= 1e-6 * abs(loss.item())
    for n, p in model.named_parameters():
        want = p.grad if p.grad is not None else torch.zeros_like(p)
        assert (got[n] - want).abs().max() <= 1e-5 * max(torch.linalg.norm(want).item(),
                                                         1e-12), n


def test_accumulated_update_reports_the_big_batch_update():
    batch = _batch(seed=2)
    runs = []
    for accum in (1, 4):
        c = _config("coca", accum)
        c["schedule"] = [(".*", dict(decay_type="cosine", warmup_steps=0))]
        model = tstep.build_model(c)
        opt = tstep.init_train_state(c, model, total_steps=10, seed=0)
        runs.append({k: float(v) for k, v in tstep.make_update_fn(c, model, opt)(batch).items()})
        assert opt.state["count"] == 1
    for k in ("training_loss", "l2_grads", "l2_params"):
        assert abs(runs[1][k] - runs[0][k]) <= 1e-5 * abs(runs[0][k]), k


def test_a_process_mesh_refuses_accum_and_siglip():
    """A mesh of two batch shards (this process shard 0; groups of one
    process, so the gathers are the identity): the GradCache step builds,
    refuses a local batch that 4 microbatches do not divide, and siglip
    returns this shard's share, its rows' loss over the shard count."""
    mesh = Mesh(dict(data=2, fsdp=1, tensor=1), dict(data=0, fsdp=0, tensor=0))
    c = _config("coca", 4)
    model = tstep.build_model(c)
    opt = tstep.init_train_state(c, model, total_steps=10, seed=0)
    opt.mesh = mesh
    grad_fn = tstep.make_grad_fn(c, model, opt)
    local = {k: torch.from_numpy(v[:6]) for k, v in _batch().items()}
    with pytest.raises(ValueError, match="grad_accum=4 must divide the batch 6 that this "
                                         "process holds"):
        grad_fn(local)
    r = np.random.default_rng(3)
    zimg, ztxt = (torch.nn.functional.normalize(torch.from_numpy(
        r.standard_normal((4, 8)).astype(np.float32)), dim=-1) for _ in range(2))
    t, b = torch.full((1,), 10.0), torch.full((1,), -5.0)
    share, _ = tstep.contrastive_loss("siglip", zimg, [ztxt], t, b, mode="local", mesh=mesh)
    whole, _ = tstep.contrastive_loss("siglip", zimg, [ztxt], t, b, mode="local")
    torch.testing.assert_close(share, whole / 2)

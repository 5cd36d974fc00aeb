"""``param_dtype=bfloat16``: the towers store their parameters in bf16, as
the flax modules do (``layers.py:151-219``, ``attention_module.py:42-255``,
``decoder.py:77, 145``), and the optimizer updates them in bf16, as optax
does. The tiny CoCa config (text and decoder cut to 1 block, ``xla``
attention, bf16 compute) on both sides from the same bf16 weights:

- every port parameter has the dtype of its JAX leaf (bf16, but those JAX
  creates in f32: cls, the image position embedding, the text tower's final
  norm, the decoder's projections, norm and learnable tokens, the
  temperature), before and after the step;
- one jitted JAX train step against the port's loss and gradients: the
  loss within 2**-6 relative and every gradient's cosine with JAX's at
  least 0.99, its norm within 2**-4 (bf16 rounding: the two frameworks
  promote a few mixed bf16/f32 products differently and sum in other
  orders, in a 1-block model where one rounding is a large share);
- the optimizer step from JAX's gradients: every parameter within two bf16
  ulps of JAX's (the Adam chain in bf16, each scalar rounded to bf16 as
  JAX's weak types are) and stored in bf16;
- the train state through an Orbax step directory and back into a fresh
  model and optimizer, bit for bit, each leaf in its own dtype.
Torch runs one intra-op thread here.
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
    flax_paths, jax_params_to_state_dict, state_dict_to_jax_params, tree_flatten_with_names)
from openvision_tpu_torch.train import step as tstep

ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=8,"
       "vocab_size=64,runlocal=True,remat=none,param_dtype=bfloat16,dtype=bfloat16")
SCHEDULE = [(".*", dict(decay_type="cosine"))]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(b=8):
    r = np.random.RandomState(0)
    return {"image": r.randint(0, 255, (b, 32, 32, 3)).astype(np.uint8),
            "labels1": r.randint(0, 64, (b, 16)).astype(np.int32),
            "labels2": r.randint(0, 64, (b, 16)).astype(np.int32),
            "autoreg_labels": r.randint(0, 64, (b, 8)).astype(np.int32),
            "cap_loss_mask": (r.rand(b, 8) > 0.2).astype(np.float32)}


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def test_bf16_params_step_against_jax():
    tc = tcfg.get_config(ARG)
    tc["input"]["batch_size"], tc["model"]["out_dim"], tc["lr"] = 8, (32, 32), 1e-3
    tc["schedule"], tc["total_steps"] = SCHEDULE, 10
    tc["model"]["text"]["depth"] = tc["model"]["text_decoder_config"]["depth"] = 1
    for tower in ("image", "text", "text_decoder_config"):
        tc["model"][tower]["attn_impl"] = "xla"
    model = tstep.build_model(tc)
    opt = tstep.init_train_state(tc, model, total_steps=10, seed=0)
    heads = dict(num_heads_vision=model.visual.transformer.resblocks[0].num_heads,
                 num_heads_text=model.text.transformer.resblocks[0].num_heads,
                 num_heads_decoder=model.txt_decoder.transformer.resblocks[0].num_heads)

    jc = jcfg.get_config(ARG + ",attn_impl=xla,dec_attn_impl=xla")
    jc.input.batch_size, jc.model.out_dim, jc.lr, jc.schedule = 8, (32, 32), 1e-3, SCHEDULE
    jc.model.text.depth = jc.model.text_decoder_config.depth = 1
    jc.init_shapes = [(8, 32, 32, 3), (16, 16)]  # two captions an image
    jmodel = jstep.build_model(jc)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((8, 32, 32, 3)), jnp.zeros((16, 16), jnp.int32),
        train=True)["params"])
    shapes = jax.tree.map(lambda s: s.value if hasattr(s, "value") else s, shapes,
                          is_leaf=lambda s: hasattr(s, "value"))
    want_dtypes = {"/".join(k.key for k in path): leaf.dtype
                   for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    # the port's bf16 weights as JAX's leaves, each in its JAX dtype
    flat = tree_flatten_with_names(state_dict_to_jax_params(
        {k: v.float().numpy() for k, v in model.state_dict().items()}, **heads))
    assert set(flat) == set(want_dtypes)
    got_dtypes = {path: jnp.dtype(jnp.float32 if p.dtype == torch.float32 else jnp.bfloat16)
                  for n, p in model.named_parameters() for path in flax_paths(n)}
    assert got_dtypes == want_dtypes
    params0 = state_dict_to_jax_params(
        {k: v.float().numpy() for k, v in model.state_dict().items()}, **heads)
    params0 = jax.tree.map(lambda v, s: jnp.asarray(v, s.dtype), params0, shapes)

    tx, _ = joptim.make(jc, params0, sched_kw=dict(total_steps=10, batch_size=8, data_size=None))

    def capture(tx):  # the gradients kept in the state
        return optax.GradientTransformation(
            lambda p: (tx.init(p), jax.tree.map(jnp.zeros_like, p)),
            lambda g, s, p=None: (lambda u, i: (u, (i, g)))(*tx.update(g, s[0], p)))

    tx = capture(tx)
    mesh = create_mesh(data=1, fsdp=1, tensor=1, devices=jax.devices()[:1])
    batch = _batch()
    with mesh:
        new_state, meas = jax.jit(jstep.make_update_fn(jc, jmodel, tx, mesh))(
            {"params": params0, "opt": tx.init(params0)}, batch, jax.random.PRNGKey(1))
    jgrads = jax.device_get(new_state["opt"][1])

    loss, _ = tstep.make_loss_fn(tc, model)(tstep.to_device(batch, "cpu"))
    loss.backward()
    assert abs(loss.item() - float(meas["training_loss"])) <= 2**-6 * abs(float(
        meas["training_loss"]))
    want = tree_flatten_with_names(jgrads)
    got = tree_flatten_with_names(state_dict_to_jax_params(
        {n: p.grad.float().numpy() for n, p in model.named_parameters()}, **heads))
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        if np.linalg.norm(w) <= 1e-3 * float(meas["l2_grads"]):  # zero but for rounding
            continue
        assert _cosine(got[k], w) >= 0.99, k
        assert abs(np.linalg.norm(got[k]) / np.linalg.norm(w) - 1) <= 2**-4, k

    opt.step(jax_params_to_state_dict(jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads)))
    assert {path: jnp.dtype(jnp.float32 if p.dtype == torch.float32 else jnp.bfloat16)
            for n, p in model.named_parameters() for path in flax_paths(n)} == want_dtypes
    want = tree_flatten_with_names(jax.device_get(new_state["params"]))
    got = tree_flatten_with_names(state_dict_to_jax_params(
        {k: v.float().numpy() for k, v in model.state_dict().items()}, **heads))
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        assert (np.abs(got[k] - w) <= 2 * 2**-8 * np.abs(w) + 1e-30).all(), k


def test_bf16_params_cross_the_orbax_train_state(tmp_path):
    """The port's bf16 train state written as an Orbax step directory and
    read back into a fresh model and optimizer: every parameter and moment
    bit for bit, in its own dtype."""
    from openvision_tpu_torch.train import checkpoint as tck

    tc = tcfg.get_config(ARG)
    tc["input"]["batch_size"], tc["model"]["out_dim"], tc["lr"] = 8, (32, 32), 1e-3
    tc["schedule"], tc["total_steps"] = SCHEDULE, 10
    tc["model"]["text"]["depth"] = tc["model"]["text_decoder_config"]["depth"] = 1
    for tower in ("image", "text", "text_decoder_config"):
        tc["model"][tower]["attn_impl"] = "xla"
    model = tstep.build_model(tc)
    opt = tstep.init_train_state(tc, model, total_steps=10, seed=0)
    tstep.make_update_fn(tc, model, opt)(_batch())
    tck.save_train_state(str(tmp_path), 1, model, opt, data_position=8)
    fresh = tstep.build_model(tc)
    opt2 = tstep.init_train_state(tc, fresh, total_steps=10, seed=1)
    tck.restore_train_state(str(tmp_path), 1, fresh, opt2)
    assert opt2.state["count"] == 1
    for (n, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    for f in ("mu", "nu"):
        for n, a in opt.state[f].items():
            b = opt2.state[f][n]
            assert a.dtype == b.dtype and torch.equal(a, b), (f, n)

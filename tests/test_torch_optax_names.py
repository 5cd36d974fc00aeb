"""The optax transformations the port takes beside Adam (``optim.py``
``OPTAX_NAMES``): ``scale_by_lion``, ``scale_by_rms`` (with and without
bias correction), ``trace`` (momentum, Nesterov) and
``scale_by_factored_rms`` (Adafactor's core, on the JAX leaves' shapes),
each as ``optim.make``'s masked chain over the tiny CoCa of
tests/fixtures/orbax_chain (frozen params, an lr multiplier, weight decay,
clipping, two schedules), against the JAX package's chain run eagerly by
optax on the same gradients (seeded numpy) for three steps: every param
within 1e-6 of its largest update (f32 summation order and rsqrt's last
bit) plus one f32 ulp of the param (the rounding of param + update).
Its state then crosses both ways through the Orbax chain state: the port's
written as JAX's tree equals optax's state leaf for leaf (shapes and
values within 1e-6 relative), and a fresh port optimizer loaded from
optax's state takes step four as optax does. Another name raises, listing
the ones the port takes.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from openvision_tpu import optim as joptim
from openvision_tpu_torch import optim as toptim
from openvision_tpu_torch.convert.openclip import (
    jax_params_to_state_dict,
    partial_state_dict_to_jax_params,
)
from openvision_tpu_torch.train import checkpoint as tck

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CASES = {
    "lion": ("scale_by_lion", {"b1": 0.9, "b2": 0.95, "mu_dtype": "bfloat16"}),
    "rms": ("scale_by_rms", {"decay": 0.8, "eps": 1e-6}),
    "rms_bias": ("scale_by_rms", {"decay": 0.8, "bias_correction": True,
                                  "eps_in_sqrt": False}),
    "trace": ("trace", {"decay": 0.9, "nesterov": True}),
    "factored": ("scale_by_factored_rms", {"min_dim_size_to_factor": 8, "decay_rate": 0.8}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture():
    root = os.path.join(FIXTURES, "orbax_chain")
    with open(root + ".json") as f:
        meta = json.load(f)
    params = tck.restore_params(root, subtree=None)["params"]
    return meta, jax.tree.map(np.asarray, params)


def _as_tree(state):
    """An optax state as Orbax restores it: NamedTuples as dicts of their
    fields, tuples by index, MaskedNode and EmptyState left out."""
    if isinstance(state, (optax.MaskedNode, optax.EmptyState)):
        return None
    if hasattr(state, "_fields"):
        items = zip(state._fields, state)
    elif isinstance(state, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(state))
    elif isinstance(state, dict):
        items = state.items()
    else:
        return np.asarray(state)
    return {k: t for k, t in ((k, _as_tree(v)) for k, v in items) if t is not None}


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), what


@pytest.mark.parametrize("case", list(CASES))
def test_optax_name_matches_eager_optax_and_crosses_the_chain(fixture, case):
    meta, jparams = fixture
    name, kw = CASES[case]
    config = dict(meta["optimizer"], optax_name=name, optax=kw)
    config["schedule"] = [tuple(s) for s in config["schedule"]]
    heads = {k: meta[k] for k in ("num_heads_vision", "num_heads_text", "num_heads_decoder")}
    tx, _ = joptim.make(config, jparams, sched_kw=meta["sched_kw"])
    jstate = tx.init(jparams)
    params = {n: t.clone() for n, t in jax_params_to_state_dict(jparams).items()}
    shapes = {n: tuple(t.shape) for n, t in params.items()}
    layout = lambda m: partial_state_dict_to_jax_params(m, shapes, **heads)  # noqa: E731
    opt = toptim.Optimizer(config, params, sched_kw=meta["sched_kw"], jax_layout=layout)
    assert opt.slot == ("rms_count" if case == "rms_bias" else toptim.OPTAX_NAMES[name])
    rng = np.random.default_rng(len(case))

    def step():
        nonlocal jparams, jstate
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.05).astype(p.dtype),
                             jparams)
        updates, jstate = tx.update(grads, jstate, jparams)
        before = jax.tree.map(np.asarray, jparams)
        jparams = jax.tree.map(np.asarray, optax.apply_updates(jparams, updates))
        opt.step(jax_params_to_state_dict(grads))
        want, prev = jax_params_to_state_dict(jparams), jax_params_to_state_dict(before)
        for n, w in want.items():
            moved = (w - prev[n]).abs().max().item()
            tol = 1e-6 * moved + 2**-23 * w.abs().max().item()  # + the add's rounding
            assert (params[n] - w).abs().max().item() <= tol, (case, n)

    for _ in range(3):
        step()
    # port -> JAX: the chain state the port writes is optax's
    got = tck._jax_train_state({"params": params, **opt.state_dict()}, heads, opt)["opt"]
    want = _as_tree(jstate)
    flat_got = {k: v for k, v in tck._flatten(got).items() if v is not None}
    flat_want = {k: v for k, v in tck._flatten(want).items() if v is not None}
    assert set(flat_got) == set(flat_want)
    for k, w in flat_want.items():
        g = flat_got[k]
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        _close(g, np.asarray(w, np.float32), 1e-6, k)
    # JAX -> port: a fresh optimizer loaded from optax's state takes step 4 as optax
    params = {n: t.clone() for n, t in jax_params_to_state_dict(jparams).items()}
    opt = toptim.Optimizer(config, params, sched_kw=meta["sched_kw"], jax_layout=layout)
    opt.load_state_dict(toptim.chain_to_state_dict(want, opt.chain,
                                                   from_jax=jax_params_to_state_dict))
    assert opt.state["count"] == 3
    step()


def test_other_optax_names_raise_listing_the_ported_ones(fixture):
    meta, _ = fixture
    config = dict(meta["optimizer"], optax_name="scale_by_adafactor")
    config["schedule"] = [tuple(s) for s in config["schedule"]]
    with pytest.raises(NotImplementedError, match="scale_by_lion.*scale_by_factored_rms"):
        toptim.chain_layout(config)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_scalars_are_host_floats_rounded_to_the_dtype(dtype):
    """The update's scalars are Python floats (a device tensor would cost a
    blocking copy each) holding the value JAX's weak-typed scalar takes in
    that dtype; on the CPU a divisor is one too. Exact."""
    like = torch.zeros(3, dtype=dtype)
    for x in (0.9, 0.999, 1e-8, 1 - 0.9 ** 3):
        want = torch.tensor(x, dtype=dtype).item()
        for got in (toptim._s(x, like), toptim._divisor(x, like)):
            assert type(got) is float and got == want
        y = torch.full((3,), 1.7, dtype=dtype)
        assert torch.equal(y * toptim._s(x, y), y * torch.tensor(x, dtype=dtype))

"""One workdir for both trainers, on the CPU: the port's trainer resumes a
run of the JAX package's trainer, and the reverse.

Both trainers run the tiny CoCa config of tests/test_trainer_e2e.py with
the text tower and the decoder cut to 1 block, attention on ``xla``, two
schedules and gradient clipping (no frozen subtree: JAX's train step
fails on one, ROADMAP queue 3), fed the same batches (a fake loader on each side hands out the batch of
each record position; the JAX side's carries grain's iterator state, so
the port maps grain's position as it would a real one):

- **JAX -> port**: JAX trains 2 steps into a workdir (an Orbax step
  directory and grain's ``data_state-2-p0.bin``); the JAX trainer and the
  port's each resume a copy of it for step 3. Params, Adam's mu and nu
  after step 3 agree within 1e-5 absolute (params, lr 1e-3) and 1e-4 of
  each leaf's norm (mu, nu; a whole step's gradients agree within 1e-4 of
  their norm, tests/test_torch_train_step.py; mu also within one bf16
  rounding, 2**-7 of its largest value, see the chain step below), the
  count is 3 on both, the
  learning rates the port applied at step 3 are JAX's schedules at JAX's
  restored count, and step 3's ``l2_updates`` agree within 1e-4 relative;
- **port -> JAX**: the same, the port writing steps 1-2 (JAX finds no
  grain state of the port's and restarts its data, as the port then does
  without its position file);
- with a frozen subtree (``img/embedding``) in the config, a state the
  port's trainer saved restores in JAX through ``restore_train_state``
  with the abstract state JAX's ``init_train_state`` builds for the same
  config (``MaskedNode`` moments included), every leaf bit for bit;
- **the chain map**: tests/fixtures/orbax_chain (the real ``optim.make``
  chain with frozen params, an lr multiplier and two schedules) read by
  the port and written back equals JAX's restore of it bit for bit,
  ``MaskedNode`` and ``EmptyState`` included; the port's optimizer applies
  the fixture's next gradients to JAX's jitted result: nu within 1e-6 of
  its leaf's largest value, mu within one bf16 rounding (2**-7 of it: JAX's
  jitted update keeps b1 * mu in f32, the port rounds it to bf16 as eager
  optax does) and each param within 2**-7 of its update;
  schedule counts that disagree raise;
- grain's iterator state after two batches of a real grain loader maps to
  the records read; one it cannot map leaves the data to restart;
- a workdir of the port's earlier npz format still resumes, on the
  parameters an Orbax resume of the same state reaches;
- a committed step directory the port cannot read raises, it does not
  start from scratch.
Torch runs one intra-op thread here, as the suite runs this file beside
others on a shared CPU.
"""

import json
import os
import shutil

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from openvision_tpu import optim as joptim
from openvision_tpu.configs import openvision as jcfg
from openvision_tpu.train import checkpoint as jck
from openvision_tpu.train import trainer as jtrainer
from openvision_tpu.utils import tree_flatten_with_names as jflatten
from openvision_tpu_torch import optim as toptim
from openvision_tpu_torch.configs import openvision as tcfg
from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict
from openvision_tpu_torch.train import checkpoint as tck
from openvision_tpu_torch.train import trainer as ttrainer

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=8,"
       "vocab_size=64,runlocal=True,remat=none,attn_impl=xla,dec_attn_impl=xla")
BATCH = 16
SCHEDULE = [("txt/.*", {"decay_type": "cosine", "warmup_steps": 1}),
            (".*", {"decay_type": "linear", "warmup_steps": 1, "linear_end": 0.1})]
# JAX's train step cannot take a frozen subtree (its telemetry's _l2_norm
# meets the float 0.0 that replace_frozen puts in the gradients), so the
# trainers run without one; frozen params cross in the chain map and
# the abstract-state restore below
FROZEN = [("img/embedding/.*", None)] + SCHEDULE


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(position: int) -> dict:
    r = np.random.RandomState(position)
    return {"image": r.randint(0, 255, (BATCH, 32, 32, 3)).astype(np.uint8),
            "labels1": r.randint(0, 64, (BATCH, 16)).astype(np.int32),
            "labels2": r.randint(0, 64, (BATCH, 16)).astype(np.int32),
            "autoreg_labels": r.randint(0, 64, (BATCH, 8)).astype(np.int32),
            "cap_loss_mask": (r.rand(BATCH, 8) > 0.2).astype(np.float32)}


class _GrainIterator:
    """A grain DataLoader iterator's interface over :func:`_batch`; its
    state is grain's own JSON (no workers, one shard)."""

    def __init__(self):
        self.position = 0

    def __iter__(self):
        return self

    def __next__(self):
        batch = _batch(self.position)
        self.position += BATCH
        return batch

    def get_state(self) -> bytes:
        return json.dumps({
            "version": 2, "last_seen_indices": {"0": self.position - 1},
            "last_worker_index": -1, "worker_count": 0,
            "sampler": "IndexSampler(num_records=64, shard_options=ShardByJaxProcess("
                       "shard_index=0, shard_count=1, drop_remainder=True), shuffle=True, "
                       "num_epochs=None, seed=0)",
            "data_source": "fake"}, indent=4).encode()

    def set_state(self, state: bytes) -> None:
        self.position = json.loads(state)["last_seen_indices"]["0"] + 1


class _GrainLoader:
    def __iter__(self):
        return _GrainIterator()


class _PortLoader:
    def __init__(self):
        self.position = 0

    def __next__(self):
        batch = _batch(self.position)
        self.position += BATCH
        return batch

    def get_state(self) -> int:
        return self.position

    def close(self) -> None:
        pass


@pytest.fixture
def same_batches(monkeypatch):
    monkeypatch.setattr(jtrainer.input_pipeline, "training",
                        lambda *a, **k: (_GrainLoader(), 64))
    monkeypatch.setattr(ttrainer.pipeline, "training", lambda *a, **k: (_PortLoader(), 64))


def _common(c, total, schedule=SCHEDULE):
    c["input"]["batch_size"] = BATCH
    c["model"]["out_dim"] = (32, 32)
    c["total_steps"] = total
    c["lr"] = 1e-3
    c["grad_clip_norm"] = 1.0
    c["schedule"] = [(p, None if s is None else dict(s)) for p, s in schedule]
    c["log_training_steps"] = 1
    c["ckpt_steps"] = 2
    c["evals"] = {}


def _jax_config(total: int, schedule=SCHEDULE):
    c = jcfg.get_config(ARG)
    _common(c, total, schedule)
    c.init_shapes = [(BATCH, 32, 32, 3), (2 * BATCH, 16)]
    c.model.text.depth = c.model.text_decoder_config.depth = 1
    return c


def _port_config(total: int, schedule=SCHEDULE) -> dict:
    c = tcfg.get_config(ARG)
    _common(c, total, schedule)
    c["model"]["text"]["depth"] = c["model"]["text_decoder_config"]["depth"] = 1
    return c


def _run_port(workdir: str, total: int, monkeypatch=None, schedule=SCHEDULE):
    lrs = []
    step = toptim.Optimizer.step

    def recording(self, grads):
        lrs.append((self.state["count"], [fn(self.state["count"]) for _, fn in self.schedules]))
        return step(self, grads)

    if monkeypatch is not None:
        monkeypatch.setattr(toptim.Optimizer, "step", recording)
    model, opt, _ = ttrainer.train(_port_config(total, schedule), workdir, device="cpu")
    return model, opt, lrs


def _rows(workdir: str) -> dict:
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f) if "training_loss" in r}


def _compare(jax_state, jax_dir, model, opt, lrs, port_dir):
    """Step 3 of the JAX trainer against step 3 of the port's."""
    assert joptim.get_count(jax_state["opt"]) == 3 == opt.state["count"]
    want = jax_params_to_state_dict(jax.device_get(jax_state["params"]))
    got = model.state_dict()
    assert set(got) == set(want)
    for n, w in want.items():
        assert (got[n] - w).abs().max() <= 1e-5, n
    adam = jax.device_get(jax_state["opt"][1].inner_state)
    for what in ("mu", "nu"):
        live = {k: v for k, v in jflatten(getattr(adam, what))[0]
                if not isinstance(v, optax.MaskedNode)}
        want = jax_params_to_state_dict(_unflatten(live))
        assert set(want) == set(opt.live)
        for n, w in want.items():  # mu: also one bf16 rounding (jitted JAX keeps b1 * mu f32)
            g = opt.state[what][n].float()
            tol = 1e-4 * torch.linalg.norm(w).item() + (2**-7 * w.abs().max().item()
                                                       if what == "mu" else 0.0)
            assert (g - w).abs().max() <= max(tol, 1e-12), (what, n)
    # the learning rates of step 3: JAX's schedules at JAX's restored count
    _, sched_fns = joptim.make(_jax_config(3), jax_state["params"], sched_kw=dict(
        total_steps=3, batch_size=BATCH, data_size=64))
    count, got_lrs = lrs[-1]
    assert count == 2 and len(got_lrs) == len(sched_fns) == 2
    for got_lr, fn in zip(got_lrs, sched_fns):
        assert got_lr == pytest.approx(float(fn(2)), rel=1e-6)
    jrow, trow = _rows(jax_dir)[3], _rows(port_dir)[3]
    assert abs(trow["l2_updates"] - jrow["l2_updates"]) <= 1e-4 * jrow["l2_updates"]


def _unflatten(flat: dict) -> dict:
    tree = {}
    for name, v in flat.items():
        *parents, leaf = name.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v, np.float32)
    return tree


def test_port_resumes_a_jax_workdir(tmp_path, same_batches, monkeypatch):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtrainer.train(_jax_config(2), jax_dir)
    ckpts = os.path.join(jax_dir, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["2", "data_state-2-p0.bin"]
    shutil.copytree(jax_dir, port_dir)
    jax_state = jtrainer.train(_jax_config(3), jax_dir)
    model, opt, lrs = _run_port(port_dir, 3, monkeypatch)
    _compare(jax_state, jax_dir, model, opt, lrs, port_dir)
    # the port's step 3 is an Orbax step directory beside its own position file
    assert sorted(os.listdir(os.path.join(port_dir, "checkpoints"))) == [
        "3", "data_position-3.json", "data_state-2-p0.bin"]


def test_jax_resumes_a_port_workdir(tmp_path, same_batches, monkeypatch):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _run_port(port_dir, 2)
    ckpts = os.path.join(port_dir, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["2", "data_position-2.json"]
    shutil.copytree(port_dir, jax_dir)
    jax_state = jtrainer.train(_jax_config(3), jax_dir)  # restores with its own abstract state
    # JAX finds no grain state of the port's step and restarts its data; so does the port
    # without its position file, and both take step 3 on the first batch
    os.remove(os.path.join(ckpts, "data_position-2.json"))
    model, opt, lrs = _run_port(port_dir, 3, monkeypatch)
    _compare(jax_state, jax_dir, model, opt, lrs, port_dir)


def test_jax_restores_a_port_state_with_its_abstract_state(tmp_path, same_batches):
    from openvision_tpu.parallel import create_mesh
    from openvision_tpu.train import step as jstep

    workdir = str(tmp_path / "port")
    model, opt, _ = _run_port(workdir, 2, schedule=FROZEN)
    assert "visual.conv1.weight" in opt.frozen
    c = _jax_config(2, FROZEN)
    mesh = create_mesh(data=1, fsdp=1, tensor=1, devices=jax.devices()[:1])
    state, _, _, _ = jstep.init_train_state(c, jstep.build_model(c), mesh, jax.random.PRNGKey(0),
                                            total_steps=2, data_size=64)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                                           sharding=x.sharding), state)
    mngr = jck.create_checkpoint_manager(os.path.join(workdir, "checkpoints"), async_save=False)
    restored = jax.device_get(jck.restore_train_state(mngr, abstract))
    mngr.close()
    assert joptim.get_count(restored["opt"]) == 2
    adam = restored["opt"][1].inner_state
    assert isinstance(adam.mu["img"]["embedding"]["kernel"], optax.MaskedNode)
    want = tck._jax_train_state(tck.gather_train_state(model, opt), tck.jax_heads(model), opt)
    for path, w in tck._flatten(want).items():
        node = restored
        for key in path.split("/"):
            node = node[int(key)] if key.isdigit() else (
                getattr(node, key) if hasattr(node, "_fields") else node[key])
        if w is None:
            assert isinstance(node, (optax.MaskedNode, optax.EmptyState, tuple)), path
            continue
        w = w.view(torch.int16).numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        got = np.asarray(node)
        assert got.shape == w.shape and got.tobytes() == w.tobytes(), path


def _chain_fixture():
    root = os.path.join(FIXTURES, "orbax_chain")
    with open(root + ".json") as f:
        meta = json.load(f)
    config = dict(meta["optimizer"])
    config["schedule"] = [tuple(s) for s in config["schedule"]]
    return root, meta, config


def test_chain_map_round_trips_bit_exact():
    root, meta, config = _chain_fixture()
    layout = toptim.chain_layout(config)
    assert layout == ["masked", "adam", "masked", "empty", "masked", "schedule", "schedule",
                      "masked", "empty"]
    tree = tck.restore_params(root, subtree=None)
    state = toptim.chain_to_state_dict(tree["opt"], layout, from_jax=jax_params_to_state_dict)
    assert state["count"] == 3
    assert not any(n.startswith("visual.conv1") for n in state["mu"])  # frozen: masked nodes
    heads = {k: meta[k] for k in ("num_heads_vision", "num_heads_text", "num_heads_decoder")}
    shapes = {n: tuple(v.shape) for n, v in jax_params_to_state_dict(tree["params"]).items()}
    chain = tck._jax_train_state(
        {"params": jax_params_to_state_dict(tree["params"]), **state}, heads,
        type("Opt", (), {"chain": layout, "mu_dtype": torch.bfloat16})())["opt"]
    assert len(shapes) > len(state["mu"])
    # JAX's own restore of the fixture, MaskedNode and EmptyState included
    mngr = jck.create_checkpoint_manager(root, async_save=False)
    jax_opt = jax.device_get(mngr.restore(3, args=ocp.args.StandardRestore(
        jax.tree.map(lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype),
                     mngr.item_metadata(3).tree)))["opt"])
    mngr.close()
    flat_got = tck._flatten(chain)
    flat_disk = {k: v for k, v in tck._flatten(tree["opt"]).items()}
    assert {k for k, v in flat_got.items() if v is not None} == set(flat_disk)
    for k, v in flat_disk.items():
        g = flat_got[k]
        if isinstance(v, torch.Tensor):
            assert g.dtype == v.dtype == torch.bfloat16 and torch.equal(g.view(torch.int16),
                                                                       v.view(torch.int16)), k
        else:
            assert np.asarray(g).dtype == v.dtype and np.asarray(g).tobytes() == v.tobytes(), k
        node = jax_opt
        for key in k.split("/"):
            node = node[int(key)] if key.isdigit() and isinstance(node, list) else node[key]
        assert np.asarray(node).tobytes() == (v.view(torch.int16).numpy().tobytes()
                                              if isinstance(v, torch.Tensor) else v.tobytes()), k
    empty = sorted(k for k, v in flat_got.items() if v is None)
    assert "0/inner_state" in empty and "8" in empty
    assert any(k.startswith("1/inner_state/mu/img/embedding") for k in empty)
    with pytest.raises(ValueError, match="schedule counts disagree"):
        tree["opt"]["6"]["inner_state"]["count"] = np.asarray(4, np.int32)
        toptim.chain_to_state_dict(tree["opt"], layout, from_jax=jax_params_to_state_dict)


def test_port_optimizer_takes_jax_chain_step():
    """The fixture's next update through the port's optimizer equals JAX's."""
    root, meta, config = _chain_fixture()
    tree = tck.restore_params(root, subtree=None)
    params = {n: v.clone() for n, v in jax_params_to_state_dict(tree["params"]).items()}
    opt = toptim.Optimizer(config, params, sched_kw=meta["sched_kw"])
    opt.load_state_dict(toptim.chain_to_state_dict(tree["opt"], opt.chain,
                                                   from_jax=jax_params_to_state_dict))
    with np.load(root + ".npz") as data:
        def part(prefix):
            return jax_params_to_state_dict(_unflatten(
                {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}))

        grads, want = part("grads/"), {w: part(f"want/{w}/") for w in ("params", "mu", "nu")}
        count = int(data["want/count"])
    before = {n: p.clone() for n, p in params.items()}
    opt.step(grads)
    assert opt.state["count"] == count == 4
    # mu within one bf16 rounding: JAX's jitted update keeps b1 * mu in f32
    # (XLA's excess precision), the port rounds it to bf16 as eager optax does
    for n, w in want["params"].items():
        step = (w - before[n]).abs().max().item()
        assert (params[n] - w).abs().max() <= 2**-7 * step + 1e-7, n
    for what, tol in (("mu", 2**-7), ("nu", 1e-6)):
        assert set(want[what]) == set(opt.live)
        for n, w in want[what].items():
            assert (opt.state[what][n].float() - w).abs().max() <= tol * max(
                w.abs().max().item(), 1e-30), (what, n)


def test_grain_position_maps_a_real_grain_state():
    from ml_collections import ConfigDict

    from openvision_tpu.data import pipeline as jpipeline

    cfg = ConfigDict({"batch_size": 4, "data": {"name": "synthetic", "num_examples": 16,
                                                "res": 8},
                      "pp": "keep('jpg')"})
    loader, _ = jpipeline.training(cfg, seed=0)
    it = iter(loader)
    next(it), next(it)
    assert tck.grain_position(it.get_state()) == 8
    assert tck.grain_position(b"not json") is None
    two_workers = json.loads(it.get_state())
    two_workers["worker_count"] = 2
    assert tck.grain_position(json.dumps(two_workers).encode()) is None


def test_old_npz_workdir_resumes(tmp_path, same_batches):
    orbax_dir, npz_dir = str(tmp_path / "orbax"), str(tmp_path / "npz")
    model, opt, _ = _run_port(orbax_dir, 2)
    shutil.copytree(orbax_dir, npz_dir, ignore=shutil.ignore_patterns("2", "data_position-*"))
    state = tck.gather_train_state(model, opt)
    tck.save_npz(os.path.join(npz_dir, "checkpoints", "ckpt-2.npz"), {  # the earlier format
        "params": state["params"],
        "opt": {"count": np.asarray(state["count"]), "mu": state["mu"], "nu": state["nu"]},
        "step": np.asarray(2), "data_position": np.asarray(2 * BATCH)})
    assert tck.saved_steps(os.path.join(npz_dir, "checkpoints")) == [2]
    assert tck.step_format(os.path.join(npz_dir, "checkpoints"), 2) == "npz"
    a, _, _ = _run_port(orbax_dir, 3)
    b, opt_b, _ = _run_port(npz_dir, 3)
    assert opt_b.state["count"] == 3
    for n, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[n]), n
    # the npz step was replaced by the Orbax one
    assert sorted(os.listdir(os.path.join(npz_dir, "checkpoints"))) == [
        "3", "data_position-3.json"]


def test_an_unreadable_step_raises(tmp_path, same_batches):
    workdir = str(tmp_path / "run")
    _run_port(workdir, 2)
    meta = os.path.join(workdir, "checkpoints", "2", "default", "_METADATA")
    with open(meta) as f:
        doc = json.load(f)
    doc["tree_metadata"] = {k: v for k, v in doc["tree_metadata"].items()
                            if not k.startswith("('opt', '5'")}  # a schedule's count gone
    with open(meta, "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="optimizer chain holds state at indices"):
        _run_port(workdir, 3)

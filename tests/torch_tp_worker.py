"""One process of the gloo world that tests/test_torch_tp_dist.py starts.

Run as ``python tests/torch_tp_worker.py OUT_DIR`` with torchrun's
environment (RANK, WORLD_SIZE=4, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); the
test file starts the four processes. Every process runs every check (the
checks' collectives need all of them); process 0 writes each check's
results to OUT_DIR (``<check>.npz``: arrays the test compares with the JAX
package, ``<check>.json``: relative errors against the port's one-process
result, which the test bounds). The inputs come from seeded numpy, as the
test's JAX side makes them (:func:`block_inputs`, :func:`coca_batch`).
"""

from __future__ import annotations

import json
import logging
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from openvision_tpu_torch import losses, parallel
from openvision_tpu_torch.convert.openclip import shard_tensor, unshard_tensor
from openvision_tpu_torch.ops import fused_attention as fa

B, L, D, HEADS = 8, 20, 16, 4


def block_inputs(seed=0, d=D, b=B, l=L):
    """x and the block's parameters in the JAX layout: (x, (lns, lnb, wq, bq,
    wk, bk, wv, bv, wo, bo)), as tests/test_fused_tp.py:_args shapes them."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = n(b, l, d)
    wq, wk, wv, wo = (n(d, d, s=0.2) for _ in range(4))
    bq, bk, bv, bo = (n(d, s=0.05) for _ in range(4))
    return x, (1 + n(d, s=0.1), n(d, s=0.1), wq, bq, wk, bk, wv, bv, wo, bo)


def port_block_params(p):
    """The JAX-layout block parameters as the port's (ln_w, ln_b, w_qkv,
    b_qkv, w_o, b_o)."""
    lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo = (torch.from_numpy(a) for a in p)
    return (lns, lnb, torch.cat([wq.t(), wk.t(), wv.t()]), torch.cat([bq, bk, bv]),
            wo.t().contiguous(), bo)


def jax_layout_grads(dx, g):
    """The port's block grads (ln_w, ln_b, w_qkv, b_qkv, w_o, b_o) in the
    JAX argument order (dx, dlns, dlnb, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)."""
    dlns, dlnb, dw_qkv, db_qkv, dw_o, dbo = g
    d = dw_qkv.shape[1]
    out = [dx, dlns, dlnb]
    for i in range(3):
        out += [dw_qkv[i * d:(i + 1) * d].t(), db_qkv[i * d:(i + 1) * d]]
    return [t.detach().numpy() for t in out + [dw_o.t(), dbo]]


def coca_config():
    """The tiny CoCa config of tests/test_fused_tp.py:_tiny_config("fused"),
    its text tower and decoder cut to 2 blocks each."""
    from openvision_tpu_torch.configs.openvision import get_config

    c = get_config("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
                   "output_token_len=8,vocab_size=64,runlocal=True,remat=none,attn_impl=fused")
    c["model"]["text"]["depth"] = c["model"]["text_decoder_config"]["depth"] = 2
    c["input"]["batch_size"] = 16
    c["model"]["out_dim"] = (32, 32)
    c["lr"] = 1e-3
    c["schedule"] = [(".*", dict(decay_type="cosine", warmup_steps=1))]
    return c


def coca_batch(b=16, rng=0):
    r = np.random.RandomState(rng)
    return {"image": r.randint(0, 255, (b, 32, 32, 3)).astype(np.uint8),
            "labels1": r.randint(0, 64, (b, 16)).astype(np.int32),
            "labels2": r.randint(0, 64, (b, 16)).astype(np.int32),
            "autoreg_labels": r.randint(0, 64, (b, 8)).astype(np.int32),
            "cap_loss_mask": (r.rand(b, 8) > 0.2).astype(np.float32)}


def rel(a, b, scale=None):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / (b.abs().max() if scale is None else scale))


class World:
    def __init__(self, out_dir: str):
        self.out = out_dir
        self.rank = dist.get_rank()

    def save(self, name: str, arrays=None, errors=None) -> None:
        if self.rank != 0:
            return
        if arrays is not None:
            np.savez(os.path.join(self.out, f"{name}.npz"), **arrays)
        if errors is not None:
            with open(os.path.join(self.out, f"{name}.json"), "w") as f:
                json.dump(errors, f)


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    return parallel.gather_batch(t.detach(), mesh)


def whole(t: torch.Tensor, kind, mesh) -> torch.Tensor:
    """A tensor-sharded leaf whole again (its shards gathered over tensor)."""
    if kind is None:
        return t.detach()
    parts = [torch.empty_like(t) for _ in range(mesh.tensor)]
    dist.all_gather(parts, t.detach().contiguous(), group=mesh.tensor_group)
    return unshard_tensor(parts, kind)


def tp_block(world, mesh, name, causal=False, prefix=0):
    """The TP block on `mesh` (value and grads of sum(out**2)) against the
    one-process block; the gathered result goes to the JAX comparison."""
    x, p = block_inputs()
    params = port_block_params(p)
    kinds = (None, None, "qkv", "qkv", "cols", None)
    r, t = mesh.coords["tensor"], mesh.tensor
    pieces = [(shard_tensor(v, k, r, t) if k else v).clone().requires_grad_(True)
              for v, k in zip(params, kinds)]
    xl = torch.from_numpy(x)[mesh.batch_rows(B)].clone().requires_grad_(True)
    kw = dict(num_heads=HEADS, causal=causal, prefix_len=prefix)
    with parallel.use_mesh(mesh):
        out = fa.fused_mhsa_block_tp(xl, *pieces, **kw)
    (out ** 2).sum().backward()
    grads = [parallel.all_reduce(q.grad, mesh.batch_group) for q in pieces]  # the step's sum
    grads = [whole(g, k, mesh) for g, k in zip(grads, kinds)]
    out_all, dx_all = gather_rows(out, mesh), gather_rows(xl.grad, mesh)

    # the one-process block (#9/#10's plain twins) on the whole batch
    xf = torch.from_numpy(x).requires_grad_(True)
    full = [v.clone().requires_grad_(True) for v in params]
    ref = fa.fused_mhsa_block(xf, *full, **kw)
    (ref ** 2).sum().backward()
    errors = {"out": rel(out_all, ref.detach()), "dx": rel(dx_all, xf.grad)}
    for label, a, b in zip(("dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_o", "db_o"), grads, full):
        scale = float(b.grad[:D].abs().max()) if label == "db_qkv" else None  # key bias ~ 0
        errors[label] = rel(a, b.grad, scale)
    world.save(name, {f"g{i}": g for i, g in enumerate(jax_layout_grads(dx_all, grads))}
               | {"out": out_all.detach().numpy()}, errors)


def tp_qkv(world, mesh):
    """fused_qkv_attention_tp (#7/#8 on the shard's heads, dy summed over
    tensor) against the one-process fused_qkv_attention."""
    x, p = block_inputs(seed=1)
    _, _, w_qkv, b_qkv, _, _ = port_block_params(p)
    r, t = mesh.coords["tensor"], mesh.tensor
    ws = shard_tensor(w_qkv, "qkv", r, t).clone().requires_grad_(True)
    bs = shard_tensor(b_qkv, "qkv", r, t).clone().requires_grad_(True)
    y = torch.from_numpy(x)[mesh.batch_rows(B)].clone().requires_grad_(True)
    with parallel.use_mesh(mesh):
        o = fa.fused_qkv_attention_tp(y, ws, bs, num_heads=HEADS)
    (o ** 2).sum().backward()
    parts = [torch.empty_like(o) for _ in range(t)]  # the shards' heads, in head order
    dist.all_gather(parts, o.detach().contiguous(), group=mesh.tensor_group)
    o_all = gather_rows(torch.cat(parts, -1), mesh)
    dw = whole(parallel.all_reduce(ws.grad, mesh.batch_group), "qkv", mesh)
    db = whole(parallel.all_reduce(bs.grad, mesh.batch_group), "qkv", mesh)
    dy = gather_rows(y.grad, mesh)
    yf, wf, bf = (v.clone().requires_grad_(True) for v in (torch.from_numpy(x), w_qkv, b_qkv))
    ref = fa.fused_qkv_attention(yf, wf, bf, num_heads=HEADS)
    (ref ** 2).sum().backward()
    world.save("tp_qkv", errors={"out": rel(o_all, ref.detach()), "dy": rel(dy, yf.grad),
                                 "dw_qkv": rel(dw, wf.grad),
                                 "db_qkv": rel(db, bf.grad, float(bf.grad[:D].abs().max()))})


def encoder_case(world, mesh, name, width, heads, attn_impl, caplog=None):
    """A 2-block Encoder on `mesh` against the same Encoder in one process:
    value and grads (the step's batch sum, then the tensor shards joined)."""
    from openvision_tpu_torch.models.encoder import Encoder
    from openvision_tpu_torch.train.step import shard_model, tensor_plan

    def build():
        torch.manual_seed(0)
        enc = Encoder(width, 2, heads, 4 * width, init_style="scaled", attn_impl=attn_impl)
        with torch.no_grad():
            g = torch.Generator().manual_seed(3)
            for q in enc.parameters():
                q.copy_(torch.randn(q.shape, generator=g) * 0.2 + (1.0 if q.ndim == 1 and
                                                                     q.shape[0] == width else 0))
        return enc

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, 9, width)).astype(np.float32))
    ref_enc = build()
    xf = x.clone().requires_grad_(True)
    ref = ref_enc(xf, train=True)
    (ref ** 2).sum().backward()

    enc = build()
    plan = shard_model(enc, mesh)
    xl = x[mesh.batch_rows(B)].clone().requires_grad_(True)
    with parallel.use_mesh(mesh):
        out = enc(xl, train=True)
    (out ** 2).sum().backward()
    errors = {"out": rel(gather_rows(out, mesh), ref.detach()),
              "dx": rel(gather_rows(xl.grad, mesh), xf.grad),
              "sharded_attention": int(any(".attn." in k for k in plan)),
              "sharded_mlp": int(any(".mlp." in k for k in plan)),
              "plan_is_rule": int(plan == tensor_plan(ref_enc, mesh.tensor))}
    ref_grads = dict(ref_enc.named_parameters())
    for n, q in enc.named_parameters():
        g = whole(parallel.all_reduce(q.grad, mesh.batch_group), plan.get(n), mesh)
        rg = ref_grads[n].grad
        scale = float(rg[:width].abs().max()) if n.endswith("in_proj_bias") else None
        errors[f"d{n}"] = rel(g, rg, scale)
    world.save(name, errors=errors)


def contrastive(world, mesh):
    """The local loss's shares summed over the batch shards, and their
    gradients, against the global loss on the whole batch."""
    r = np.random.default_rng(7)
    zimg, z1, z2 = (torch.nn.functional.normalize(torch.from_numpy(
        r.standard_normal((B, 12)).astype(np.float32)), dim=-1) for _ in range(3))
    t = torch.tensor([10.0])
    leaves = [z[mesh.batch_rows(B)].clone().requires_grad_(True) for z in (zimg, z1, z2)]
    share, _ = losses.bidirectional_contrastive_loss(leaves[0], leaves[1:], t, mode="local",
                                                     mesh=mesh)
    share.backward()
    total = parallel.all_reduce(share.detach(), mesh.batch_group)
    full = [z.clone().requires_grad_(True) for z in (zimg, z1, z2)]
    ref, _ = losses.bidirectional_contrastive_loss(full[0], full[1:], t, mode="global")
    ref.backward()
    errors = {"loss": rel(total, ref.detach())}
    for i, (a, b) in enumerate(zip(leaves, full)):
        errors[f"dz{i}"] = rel(gather_rows(a.grad, mesh), b.grad)
    world.save("contrastive", errors=errors)


def coca(world, mesh):
    """The tiny CoCa loss and gradients on `mesh` (FSDP2 with fsdp > 1)
    against the one-process port; the sharded global norm against the
    unsharded one."""
    from openvision_tpu_torch import optim
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.train import checkpoint as ckpt
    from openvision_tpu_torch.train import step as tstep

    c = coca_config()
    batch = {k: torch.from_numpy(v) for k, v in coca_batch().items()}
    ref_model = init_params(tstep.build_model(c), 0)
    state = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
    ref_opt = optim.Optimizer(c, dict(ref_model.named_parameters()), sched_kw=dict(
        total_steps=10, batch_size=16))
    ref_meas, ref_grads = tstep.make_grad_fn(c, ref_model, ref_opt)(batch)

    model = tstep.build_model(c)
    with parallel.use_mesh(mesh):
        opt = tstep.init_train_state(c, model, total_steps=10, mesh=mesh, params=state)
        local = {k: v[mesh.batch_rows(16)] for k, v in batch.items()}
        meas, grads = tstep.make_grad_fn(c, model, opt)(local)
        norm = opt.global_norm({n: grads[n] for n in opt.live})
    got = ckpt.gather_leaves(grads, model, opt)
    errors = {"loss": rel(meas["training_loss"], ref_meas["training_loss"]),
              "fsdp_chunked": len(opt.fsdp_chunked), "tensor_sharded": len(opt.tensor_plan),
              "norm": rel(norm, optim.l2_norm(ref_grads[n] for n in ref_opt.live))}
    worst = 0.0
    for n, g in got.items():
        if n.endswith("attn.in_proj_bias"):
            d = g.shape[0] // 3  # the key bias's true gradient is 0 (softmax shift-invariance)
            keep = torch.cat([torch.arange(d), torch.arange(2 * d, 3 * d)])
            g, ref = g[keep], ref_grads[n][keep]
        else:
            ref = ref_grads[n]
        # atol 1e-5, rtol 1e-3 (tests/test_fused_tp.py): the excess over the bound
        worst = max(worst, float(((g - ref).abs() - (1e-5 + 1e-3 * ref.abs())).max()))
    errors["grad_excess"] = worst
    world.save("coca", errors=errors)


def trainer_run(world, out_dir):
    """main_clip for 2 steps on a (data 1, fsdp 2, tensor 2) mesh: finite
    losses, process 0's one checkpoint, and that checkpoint equal to the
    gathered parameters and loadable in one process."""
    from openvision_tpu_torch.main_clip import main
    from openvision_tpu_torch.train import checkpoint as ckpt
    from openvision_tpu_torch.train import step as tstep

    wd = os.path.join(out_dir, "train")
    arg = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=12,"
           "fsdp_parallelism=2,tensor_parallelism=2")
    model, opt, meas = main(["--config", f"openvision_tpu_torch/configs/openvision.py:{arg}",
                             "--workdir", wd, "--override", "input.batch_size=8",
                             "--override", "input.data.num_examples=16",
                             "--override", "total_steps=2", "--override", "model.text.depth=2",
                             "--override", "model.text_decoder_config.depth=2",
                             "--override", "schedule.0.1.warmup_steps=1",
                             "--override", "log_training_steps=1", "--device", "cpu"])
    params = ckpt.gather_leaves(opt.params, model, opt)
    if world.rank != 0:
        return
    rows = [json.loads(line) for line in open(os.path.join(wd, "metrics.jsonl"))]
    saved = ckpt.saved_steps(os.path.join(wd, "checkpoints"))
    tree = ckpt.load_npz(os.path.join(wd, "checkpoints", f"ckpt-{saved[-1]}.npz"))
    config = arg_config(arg)
    config["model"]["text"]["depth"] = config["model"]["text_decoder_config"]["depth"] = 2
    one = tstep.build_model(config)
    one.load_state_dict({k: torch.as_tensor(v) for k, v in tree["params"].items()})
    equal = all(torch.equal(one.state_dict()[n], params[n]) for n in params)
    from openvision_tpu_torch.tools.caption import build_captioner

    cap, _ = build_captioner(config, os.path.join(wd, "checkpoints", f"ckpt-{saved[-1]}.npz"),
                             device="cpu")
    ids = cap(np.random.default_rng(0).random((2, 32, 32, 3), np.float32))
    world.save("trainer", errors={
        "losses": [r["training_loss"] for r in rows if "training_loss" in r],
        "checkpoints": saved, "equal": int(equal), "caption_ids": list(ids.shape),
        "files": sorted(os.listdir(wd)), "count": opt.state["count"]})


def arg_config(arg):
    from openvision_tpu_torch.configs.openvision import get_config

    return get_config(arg)


def main(out_dir: str) -> None:
    parallel.maybe_distributed_init("cpu")
    world = World(out_dir)
    logging.basicConfig(level=logging.WARNING)
    dp_tp = parallel.create_mesh(data=2, fsdp=1, tensor=2)
    fsdp_tp = parallel.create_mesh(data=1, fsdp=2, tensor=2)
    tp_block(world, dp_tp, "block")
    tp_block(world, fsdp_tp, "block_prefix", causal=True, prefix=7)
    tp_qkv(world, dp_tp)
    encoder_case(world, dp_tp, "indivisible", 12, 3, "fused")  # 3 heads, tensor 2
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("openvision_tpu_torch.models.encoder").addHandler(handler)
    encoder_case(world, dp_tp, "fused_t", 128, 2, "fused_t")
    world.save("fused_t_warning", errors={"messages": [r.getMessage() for r in records]})
    contrastive(world, dp_tp)
    coca(world, fsdp_tp)
    trainer_run(world, out_dir)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])

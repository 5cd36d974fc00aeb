"""One process of the gloo world that tests/test_torch_mesh_recipe.py starts.

Run as ``python tests/torch_mesh_recipe_worker.py OUT_DIR`` with torchrun's
environment (RANK, WORLD_SIZE=4, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).
Every process builds both meshes, (data 2, tensor 2) and (fsdp 2, tensor 2),
and runs every check (their collectives need all four); process 0 writes
each check's results to OUT_DIR (``<check>.json``: errors against the
port's one-process result, which the test bounds; ``<check>.npz``: arrays
the test holds against the JAX package). The inputs come from seeded numpy
and the port's seeded initializer.
"""

from __future__ import annotations

import json
import os
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_worker as tp  # noqa: E402

from openvision_tpu_torch import losses, parallel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16  # the global batch
VOCAB = os.path.join(REPO, "assets", "bert_base_vocab_bos_eos.txt")
TOK = (f'my_eval_bert_tokenize(inkey="texts", max_len=16, vocab_path="{VOCAB}", '
       'add_bos=True, add_eos=True)')
CROP = "decode|resize_small(32)|central_crop(32)"
NAMES = ["tench", "goldfish", "a red car", "two dogs", "snowy mountain", "city at night",
         "a bowl of soup"]  # 7 classes: 4 and 3 over two batch shards
EVAL_IMAGES = 22  # batches of 8 (4 a shard): 11 images a shard, its last batch ragged
# GradCache on the mesh against one process: (loss_type, grad_accum, local_loss, image extras)
GRAD_CASES = (("coca", 2, True, dict(mask_ratio=0.5, drop_path=0.1)), ("clip", 2, True, {}),
              ("siglip", 2, True, {}), ("siglip", 1, True, {}), ("coca", 1, False, {}),
              ("clip", 2, False, {}))
TRAIN_ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=8,"
             "mask_ratio=0.5,tensor_parallelism=2")
TRAIN_OVERRIDES = ["input.batch_size=8", "input.data.num_examples=32", "model.text.depth=2",
                   "model.text_decoder_config.depth=2", "schedule.0.1.warmup_steps=1",
                   "log_training_steps=1", "grad_accum=2", "model.image.drop_path=0.1"]
EVAL_ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=8,"
            "vocab_size=30522,tensor_parallelism=2")
EVAL_OVERRIDES = ["evals.disclf.data_dir=synthetic", "evals.disclf.batch_size=16",
                  "evals.disclf.prompt_templates=none", "evals.retrieval.data_dir=synthetic",
                  "evals.retrieval.batch_size=8", "model.text.depth=2",
                  "model.text_decoder_config.depth=1", "input.batch_size=8",
                  "input.data.num_examples=16", "schedule.0.1.warmup_steps=1"]


def embeddings(seed=7, b=B, d=12):
    """Normalised (zimg, ztxt1, ztxt2) of the loss checks, the test's JAX
    side's too."""
    r = np.random.default_rng(seed)
    z = [r.standard_normal((b, d)).astype(np.float32) for _ in range(3)]
    return [a / np.linalg.norm(a, axis=-1, keepdims=True) for a in z]


def tensor_equal(t: torch.Tensor, mesh) -> bool:
    """Whether every process of this one's tensor group holds `t`."""
    parts = [torch.empty_like(t) for _ in range(mesh.tensor)]
    dist.all_gather(parts, t.contiguous(), group=mesh.tensor_group)
    return all(torch.equal(p, t) for p in parts)


def draws(world, mesh, name):
    """Masking, drop-path and dropout draws on `mesh`: the shards' parts,
    the tensor group's and (masking, drop-path) one process's for the
    same rows."""
    from openvision_tpu_torch.models.layers import DropPath, Dropout, dropout_generator
    from openvision_tpu_torch.models.vit import random_token_masking

    n = B // mesh.batch_shards
    x = torch.arange(B * 6 * 2, dtype=torch.float32).reshape(B, 6, 2)  # 6 tokens, a 2 x 3 grid
    with parallel.use_mesh(mesh):
        mask = random_token_masking(x[mesh.batch_rows(B)], 0.5,
                                    torch.Generator().manual_seed(5), "random", 2, 3)[1]
        path = DropPath(0.5)(torch.ones(n, 3), torch.Generator().manual_seed(6))
        drop = Dropout(0.5)(torch.ones(n, 3),
                            dropout_generator(torch.Generator().manual_seed(7), 0.5))
    want = {"mask": random_token_masking(x, 0.5, torch.Generator().manual_seed(5), "random",
                                         2, 3)[1],
            "drop_path": DropPath(0.5)(torch.ones(B, 3), torch.Generator().manual_seed(6))}
    out = {}
    for label, local in (("mask", mask), ("drop_path", path), ("dropout", drop)):
        rows = tp.gather_rows(local, mesh)
        out[f"{label}_shards_differ"] = int(not torch.equal(rows[:n], rows[n:2 * n]))
        out[f"{label}_tensor_equal"] = int(tensor_equal(local, mesh))
        if label in want:
            out[f"{label}_one_process"] = int(torch.equal(rows, want[label]))
    world.save(f"draws_{name}", errors=out)


def grad_config(loss_type: str, accum: int, local_loss: bool, image: dict) -> dict:
    c = tp.coca_config()
    c["loss_type"], c["grad_accum"], c["local_loss"] = loss_type, accum, local_loss
    c["model"]["image"].update(image)
    if loss_type == "siglip":
        c["model"]["init_logit_bias"] = -10.0
    return c


def gradcache(world, meshes):
    """Each GRAD_CASES gradient on each mesh against the port's one process
    on the whole batch, f32: loss and every gradient (relative to its
    norm)."""
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.train import checkpoint as ckpt
    from openvision_tpu_torch.train import step as tstep

    batch = {k: torch.from_numpy(v) for k, v in tp.coca_batch().items()}
    out = {}
    for loss_type, accum, local_loss, image in GRAD_CASES:
        c = grad_config(loss_type, accum, local_loss, image)
        tag = f"{loss_type}_accum{accum}_{'local' if local_loss else 'global'}"
        ref_model = init_params(tstep.build_model(c), 0)
        state = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
        ref_opt = tstep.init_train_state(c, ref_model, total_steps=10, params=state)
        ref_meas, ref_grads = tstep.make_grad_fn(c, ref_model, ref_opt)(
            batch, rng=tstep.step_generator(0, 0))
        for name, mesh in meshes.items():
            model = tstep.build_model(c)
            with parallel.use_mesh(mesh):
                opt = tstep.init_train_state(c, model, total_steps=10, mesh=mesh, params=state)
                local = {k: v[mesh.batch_rows(B)] for k, v in batch.items()}
                meas, grads = tstep.make_grad_fn(c, model, opt)(
                    local, rng=tstep.step_generator(0, 0))
            got = ckpt.gather_leaves(grads, model, opt)
            worst = max(float((g - ref_grads[n]).abs().max())
                        / max(float(torch.linalg.norm(ref_grads[n])), 1e-12)
                        for n, g in got.items())
            out[f"{name}/{tag}"] = {
                "loss": tp.rel(meas["training_loss"], ref_meas["training_loss"]),
                "grad": worst, "leaves": len(got), "want_leaves": len(ref_grads),
                "fsdp_chunked": len(opt.fsdp_chunked), "tensor_sharded": len(opt.tensor_plan)}
    world.save("gradcache", errors=out)


VOCAB_LEAVES = {"text.token_embedding.weight": 0, "visual.proj": 1, "text.text_projection": 1,
                "txt_decoder.head.weight": 0}  # the leaf -> the axis tensor splits


def vocab_shards(world, mesh):
    """The coca GradCache config's model on (data 2, tensor 2): the shard
    of each vocab-axis leaf (the token embedding and the decoder head by
    vocab rows, the towers' heads by output features) this rank holds, and
    the tensor ranks' parameters joined by ``unshard_state_dict`` against
    the one-process leaves, bit for bit."""
    from openvision_tpu_torch.convert.openclip import unshard_state_dict
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.train import step as tstep

    c = grad_config(*GRAD_CASES[0])
    state = {k: v.detach().clone() for k, v in
             init_params(tstep.build_model(c), 0).state_dict().items()}
    model = tstep.build_model(c)
    with parallel.use_mesh(mesh):
        opt = tstep.init_train_state(c, model, total_steps=10, mesh=mesh, params=state)
    mine = {n: p.detach() for n, p in model.named_parameters()}
    parts = []
    for n in sorted(mine):
        gathered = [torch.empty_like(mine[n]) for _ in range(mesh.tensor)]
        dist.all_gather(gathered, mine[n].contiguous(), group=mesh.tensor_group)
        parts.append(gathered)
    ranks = [{n: parts[i][r] for i, n in enumerate(sorted(mine))} for r in range(mesh.tensor)]
    joined = unshard_state_dict(ranks, opt.tensor_plan)
    world.save("vocab", errors={
        "kinds": {n: opt.tensor_plan.get(n) for n in VOCAB_LEAVES},
        "fractions": {n: mine[n].shape[a] / state[n].shape[a] for n, a in VOCAB_LEAVES.items()},
        "flags": [model.text.vocab_parallel, model.text.head_parallel,
                  model.visual.head_parallel, model.txt_decoder.vocab_parallel],
        "unshard_equal": int(joined.keys() == state.keys()
                             and all(torch.equal(joined[n], state[n]) for n in state))})


def mesh_losses(world, meshes):
    """siglip local and global and the global contrastive mode on each
    mesh: the shares summed and the embeddings' gradients gathered, for the
    test's JAX comparison, and against one process."""
    zimg, z1, z2 = (torch.from_numpy(a) for a in embeddings())
    t, b = torch.tensor([10.0]), torch.tensor([-5.0])
    fns = {"siglip_local": lambda zi, zs, mesh: losses.siglip_loss(zi, zs[0], t, b, mode="local",
                                                                   mesh=mesh)[0],
           "siglip_global": lambda zi, zs, mesh: losses.siglip_loss(zi, zs[0], t, b,
                                                                    mode="global", mesh=mesh)[0],
           "contrastive_global": lambda zi, zs, mesh: losses.bidirectional_contrastive_loss(
               zi, zs, t, mode="global", mesh=mesh)[0]}
    arrays, errors = {}, {}
    for name, mesh in meshes.items():
        for label, fn in fns.items():
            leaves = [z[mesh.batch_rows(B)].clone().requires_grad_(True) for z in (zimg, z1, z2)]
            share = fn(leaves[0], leaves[1:], mesh)
            share.backward()
            total = parallel.all_reduce(share.detach(), mesh.batch_group)
            grads = [tp.gather_rows(q.grad if q.grad is not None else torch.zeros_like(q), mesh)
                     for q in leaves]
            full = [z.clone().requires_grad_(True) for z in (zimg, z1, z2)]
            ref = fn(full[0], full[1:], None)
            ref.backward()
            errors[f"{name}/{label}"] = {"loss": tp.rel(total, ref.detach()), **{
                f"dz{i}": tp.rel(g, f.grad, max(float(f.grad.abs().max()), 1e-12))
                for i, (g, f) in enumerate(zip(grads, full)) if f.grad is not None}}
            arrays[f"{name}.{label}.loss"] = total.numpy()
            for i, g in enumerate(grads):
                arrays[f"{name}.{label}.dz{i}"] = g.numpy()
    world.save("losses", arrays, errors)


def eval_model():
    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.train import step as tstep

    c = get_config(EVAL_ARG + f",vocab_path={VOCAB}")
    c["model"]["text"]["depth"] = 2
    c["model"]["text_decoder_config"]["depth"] = 1
    c["model"]["out_dim"] = (32, 32)
    c["schedule"] = [(".*", dict(decay_type="cosine", warmup_steps=1))]
    return c, init_params(tstep.build_model(c), 0).eval()


def eval_sources():
    from openvision_tpu_torch.data import pipeline as pipe

    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (EVAL_IMAGES, 40, 36, 3), np.uint8)
    words = ["cat", "dog", "car", "tree", "house", "river", "bird", "boat", "snow", "sun"]
    caps = np.empty(10, object)
    for i in range(10):
        caps[i] = [" ".join(rng.choice(words, 4)) for _ in range(1 + i % 3)]
    contrastive = {"image": rng.standard_normal((10, 32, 32, 3)).astype(np.float32),
                   "labels": rng.integers(1, 30000, (10, 16))}
    return (pipe.DictSource({"image": images, "label": np.arange(EVAL_IMAGES) % len(NAMES)}),
            pipe.DictSource({"image": images[:10], "captions": caps}),
            pipe.DictSource(contrastive))


def evaluators(world, meshes):
    """disclf (the f32 towers, and int8 with calibration), retrieval and the
    contrastive monitor on each mesh against the one-process evaluator."""
    from openvision_tpu_torch.evaluators import contrastive, disclf, retrieval
    from openvision_tpu_torch.train import step as tstep

    c, ref_model = eval_model()
    state = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
    cls_src, ret_src, con_src = eval_sources()
    kw = dict(pp_img=CROP, pp_txt=TOK, device_norm="vgg", class_names=NAMES,
              prompt_templates="simple", batch_size=8)
    ref = {}
    for mode in ("f32", "int8"):
        ev = disclf.Evaluator(ref_model, source=cls_src, int8=mode == "int8", int8_calibration=4,
                              **kw)
        ref[mode] = (ev.run({"model": ref_model}), ev.counts, ev.int8_scales)
    with torch.no_grad():
        ref["classes"] = disclf.Evaluator(ref_model, source=cls_src, **kw).class_embeddings(
            disclf.Evaluator(ref_model, source=cls_src, **kw).prompt_tokens())
    ret_kw = dict(pp_img=CROP, pp_txt=TOK, device_norm="vgg", batch_size=4)
    ref_ret = retrieval.Evaluator(ref_model, source=ret_src, **ret_kw)
    ref["retrieval"], ref["ret_emb"] = dict(ref_ret.run()), ref_ret.embeddings()
    # a mesh's global batch i is each batch shard's batch i of its contiguous part, in
    # shard order (both meshes have two): one process reads them in that order
    parts = np.array_split(np.arange(len(con_src)), 2)
    order = [int(r) for i in range(2) for part in parts for r in part[2 * i:2 * i + 2]]
    ref["contrastive"] = dict(contrastive.Evaluator(
        ref_model, source=_Records(con_src, order), batch_size=4, num_batches=2).run())
    out = {}
    for name, mesh in meshes.items():
        model = tstep.build_model(c).eval()
        with parallel.use_mesh(mesh):
            opt = tstep.init_train_state(c, model, total_steps=10, mesh=mesh, params=state)
            res = {}
            for mode in ("f32", "int8"):
                ev = disclf.Evaluator(model, mesh, source=cls_src, int8=mode == "int8",
                                      int8_calibration=4, **kw)
                metrics = ev.run({"model": model, "opt": opt})
                scales = ev.int8_scales
                same_scales = scales is None and ref[mode][2] is None or all(
                    torch.equal(a, b) for a, b in zip(_flat(scales), _flat(ref[mode][2])))
                res[mode] = {"metrics_equal": int(metrics == ref[mode][0]),
                             "counts": list(ev.counts), "want_counts": list(ref[mode][1]),
                             "scales_equal": int(same_scales),
                             "scales_tensor_equal": int(scales is None or all(
                                 tensor_equal(a, mesh) for a in _flat(scales)))}
                if mode == "f32":
                    with ev.towers.evaluating():
                        classes = ev.class_matrix(ev.prompt_tokens(ev.local_classes()))
                    res["classes"] = tp.rel(classes, ref["classes"])
            ret = retrieval.Evaluator(model, mesh, source=ret_src, **ret_kw)
            got = dict(ret.run())
            zimg, ztxt, _ = ret.embeddings()
            res["retrieval"] = {"equal": int(got == ref["retrieval"]),
                                "zimg": tp.rel(zimg, ref["ret_emb"][0]),
                                "ztxt": tp.rel(ztxt, ref["ret_emb"][1])}
            con = dict(contrastive.Evaluator(model, mesh, source=con_src, batch_size=4,
                                             num_batches=2).run())
            res["contrastive"] = {"loss": tp.rel(con["loss"], ref["contrastive"]["loss"]),
                                  "ncorrect_equal": int(con["ncorrect"]
                                                        == ref["contrastive"]["ncorrect"])}
        out[name] = res
    world.save("evaluators", errors=out)


class _Records:
    """The records of `source` at `order`."""

    def __init__(self, source, order):
        self.source, self.order = source, order

    def __len__(self):
        return len(self.order)

    def __getitem__(self, i):
        return self.source[self.order[i]]


def _flat(scales):
    """The tensors of an int8_scales tree, in order."""
    if isinstance(scales, dict):
        return [t for k in sorted(scales) for t in _flat(scales[k])]
    if isinstance(scales, (list, tuple)):
        return [t for v in scales for t in _flat(v)]
    return [torch.as_tensor(scales)]


def main_clip(args: list, workdir: str, overrides: list, *extra: str):
    from openvision_tpu_torch.main_clip import main

    argv = ["--config", f"openvision_tpu_torch/configs/openvision.py:{args}", "--workdir",
            workdir, "--device", "cpu"]
    for ov in overrides + list(extra):
        argv += ["--override", ov]
    return main(argv)


def eval_only(world, out_dir):
    """main_clip eval_only on a (data 2, tensor 2) mesh against the same
    evaluators in one process on the same init."""
    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.main_clip import apply_override
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.train import step as tstep
    from openvision_tpu_torch.train import trainer

    wd = os.path.join(out_dir, "eval_only")
    main_clip(EVAL_ARG, wd, EVAL_OVERRIDES, "eval_only=True")
    if world.rank != 0:
        return
    rows = [json.loads(line) for line in open(os.path.join(wd, "metrics.jsonl"))]
    c = get_config(EVAL_ARG)
    for ov in EVAL_OVERRIDES:
        apply_override(c, ov)
    model = init_params(tstep.build_model(c), c.get("seed", 0))
    want = {}
    for _, ev, _, prefix in trainer.build_evaluators(c, model, None):
        want.update({f"{prefix}{k}": v for k, v in ev.run({"model": model})})
    got = {k: v for k, v in rows[0].items() if k in want}
    world.save("eval_only", errors={"rows": len(rows), "step": rows[0]["step"], "got": got,
                                    "want": want, "keys": sorted(rows[0])})


def sigterm(world, out_dir):
    """main_clip on a (data 2, tensor 2) mesh with GradCache, masking and
    drop-path: SIGTERM to process 1 alone after step 1, then a rerun to
    step 3, against an uninterrupted run of 3 steps."""
    from openvision_tpu_torch.train import checkpoint as ckpt
    from openvision_tpu_torch.train import step as tstep

    make_update_fn = tstep.make_update_fn

    def signalling(config, model, opt):
        update = make_update_fn(config, model, opt)

        def fn(batch):
            out = update(batch)
            if dist.get_rank() == 1 and opt.state["count"] == 1 and signalling.armed:
                signalling.armed = False
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return fn

    signalling.armed = True
    wd = os.path.join(out_dir, "sigterm")
    tstep.make_update_fn = signalling
    try:
        _, opt, _ = main_clip(TRAIN_ARG, wd, TRAIN_OVERRIDES, "total_steps=3")
    finally:
        tstep.make_update_fn = make_update_fn
    stopped_at = opt.state["count"]
    saved = ckpt.saved_steps(os.path.join(wd, "checkpoints"))
    model, opt, _ = main_clip(TRAIN_ARG, wd, TRAIN_OVERRIDES, "total_steps=3")
    resumed = ckpt.gather_leaves(opt.params, model, opt)
    model, opt, _ = main_clip(TRAIN_ARG, os.path.join(out_dir, "straight"), TRAIN_OVERRIDES,
                              "total_steps=3")
    straight = ckpt.gather_leaves(opt.params, model, opt)
    stops = [torch.zeros((), dtype=torch.int64) for _ in range(dist.get_world_size())]
    dist.all_gather(stops, torch.tensor(stopped_at))
    if world.rank != 0:
        return
    rows = [json.loads(line) for line in open(os.path.join(wd, "metrics.jsonl"))]
    world.save("sigterm", errors={
        "stopped_at": [int(s) for s in stops], "saved": saved,
        "resumed_steps": [r["step"] for r in rows if "training_loss" in r],
        "params": max(tp.rel(resumed[n], straight[n], max(float(straight[n].abs().max()), 1e-12))
                      for n in straight),
        "count": opt.state["count"]})


def main(out_dir: str) -> None:
    torch.set_num_threads(1)
    parallel.maybe_distributed_init("cpu")
    world = tp.World(out_dir)
    meshes = {"data2_tensor2": parallel.create_mesh(data=2, fsdp=1, tensor=2),
              "fsdp2_tensor2": parallel.create_mesh(data=1, fsdp=2, tensor=2)}
    for name, mesh in meshes.items():
        draws(world, mesh, name)
    mesh_losses(world, meshes)
    vocab_shards(world, meshes["data2_tensor2"])
    gradcache(world, meshes)
    evaluators(world, meshes)
    eval_only(world, out_dir)
    sigterm(world, out_dir)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])

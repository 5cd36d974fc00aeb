"""Contrastive-loss health monitor.

Counterpart of ``openvision_tpu/evaluators/contrastive.py``: the global
bidirectional contrastive loss and ``ncorrect`` (its image->text top-1
accuracy) of the model on up to ``num_batches`` held-out batches of
``source``, each batch of ``make_for_inference`` (one epoch, in order, the
last zero-padded) passed through the pp string whole, as the JAX evaluator
does; the mean of each over the batches. On a process mesh each batch
shard reads its rows of a batch and embeds them, and the loss is the global
one over the shards' embeddings gathered, as the JAX evaluator's over its
global batch. No source: no metrics. Training health monitoring only.
"""

from __future__ import annotations

import numpy as np
import torch

from openvision_tpu_torch import losses
from openvision_tpu_torch.data import pipeline as pipe
from openvision_tpu_torch.data.pp import build_pp_fn, import_pp_modules
from openvision_tpu_torch.evaluators import common as eval_common


class Evaluator:
    def __init__(self, model, mesh=None, *, pp="", batch_size: int = 256, num_batches: int = 4,
                 source=None, **unused):
        self.towers = eval_common.Towers(model)
        self.mesh = mesh
        self.batch_size = batch_size
        self.num_batches = num_batches
        import_pp_modules()
        self.pp = build_pp_fn(pp) if pp else None
        self.source = source

    def run(self, train_state=None):
        if self.source is None:
            return []
        dev = self.towers.device
        rng = np.random.default_rng(0)
        losses_, ncorrect_ = [], []
        mesh = eval_common.batch_mesh(self.mesh)
        it = pipe.make_for_inference(self.source, "", self.batch_size, mesh=mesh)()
        with self.towers.evaluating():
            for i, batch in enumerate(it):
                if i >= self.num_batches:
                    break
                data = self.pp(dict(batch), rng) if self.pp is not None else batch
                image = torch.from_numpy(np.asarray(data["image"], np.float32)).to(dev)
                text = torch.from_numpy(np.asarray(data["labels"], np.int64)).to(dev)
                zimg, ztxt = (eval_common.gather_rows(z, mesh) for z in (
                    self.towers.embed_images(image), self.towers.embed_texts(text)))
                loss, extras = losses.bidirectional_contrastive_loss(
                    zimg, ztxt, self.towers.temperature(), mode="global")
                losses_.append(float(loss))
                ncorrect_.append(float(extras["ncorrect"]))
        if not losses_:
            return []
        return [("loss", float(np.mean(losses_))), ("ncorrect", float(np.mean(ncorrect_)))]

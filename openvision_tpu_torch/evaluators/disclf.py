"""Zero-shot discriminative classifier (ImageNet-style).

Counterpart of ``openvision_tpu/evaluators/disclf.py:Evaluator`` (:32):
class-name x prompt-template text embeddings, averaged over the templates
and L2-normalised per class (``+ 1e-8``) in 512-row chunks
(``_build_class_embeddings``, :192), then top-1 accuracy of zimg . ztxt^T
over the one-epoch eval stream of ``data/pipeline.py:make_for_inference``,
its ``_mask`` counting the real rows; with ``multi_label_key`` a row of
labels padded with -1 counts as correct when the prediction is any of them
(:181-190). Counts accumulate on the device and are read once at the end
(:238-296). The towers run in eval mode under ``torch.no_grad()`` and are
given back in the mode they had (the trainer's model goes back to
training).

Data: ``source`` (any object with len and [i] giving {"image", "label"}),
or ``data_dir``: "synthetic" (32 random 64x64 images), a TFDS-format
directory (``TfdsDirectorySource``, as ``data/prepare.py`` writes it) or an
npz with "image" (N, H, W, 3) uint8 and "label". With ``device_norm`` the
images cross to the card as uint8 and are normalised there
(``evaluators/common.py:device_norm_fn``).

``int8`` embeds the images through ``serving/quant.py:quantized_encode``
on the int8 kernels: static per-tensor scales from ``calibrate_vit`` on the
first ``int8_calibration`` images of the first batch, or per-token dynamic
scales with 0 (:142-175). The int8 weights come from the model's f32
weights (the trainer's model), or from a ``LoadedModel`` loaded with
``int8=True``; a tower whose block matrices were already cast to bf16 is
refused by name. The text tower and the class embeddings stay as they are.

On a process mesh (:201-247): the classes are split over the batch shards
(``np.array_split``, each split padded to the largest with class 0), each
shard tokenizes and embeds its prompts and an all-gather over data x fsdp
puts the class matrix back together; the images come from
``make_for_inference`` sharded over the batch shards, and the counts are
summed over them. The int8 calibration gathers the shards' first batches
and calibrates on the same global prefix, so every process holds the same
static scales; a model whose leaves the mesh shards (tensor or FSDP2) is
quantised from its whole leaves, gathered first
(``train/checkpoint.py:gather_leaves``; the optimizer comes in
``train_state["opt"]``). ``return_preds`` on several processes raises.

:attr:`Evaluator.timings` holds the last run's seconds: ``tokenize`` (the
host WordPiece of this process's prompts, on the first run only: the token ids are
kept for later runs), ``class_embed`` (the text tower over the
prompts, through a device synchronize), ``host`` (the image loop's time in
the input pipeline: decode and pp), ``copy`` (host -> device) and ``loop``
(the whole image loop, through the final synchronize).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from openvision_tpu_torch.data import pipeline as pipe
from openvision_tpu_torch.data.pp import build_pp_fn, import_pp_modules
from openvision_tpu_torch.evaluators import common as eval_common
from openvision_tpu_torch.evaluators import prompts as prompt_lib

TEXT_CHUNK = 512  # prompts embedded at a time (disclf.py:228)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Evaluator:
    def __init__(self, model, mesh=None, *, dataset_names=("imagenet2012",),
                 split="validation", data_dir="", pp_img="", pp_txt="", batch_size: int = 256,
                 prompt_templates: str = "clip_paper", canonicalize: bool = True,
                 first_class_name_only: bool = False, source=None, num_workers: int = 0,
                 multi_label_key: str = "", int8: bool = False, int8_calibration: int = 64,
                 class_names=None, device_norm: str = "", **unused):
        self.towers = eval_common.Towers(model)
        self.mesh = mesh
        self.dataset_name = dataset_names[0] if dataset_names else "imagenet2012"
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.multi_label_key = multi_label_key
        self.int8 = int8
        self.int8_calibration = int8_calibration
        self.device_norm = device_norm
        self._apply_device_norm = eval_common.device_norm_fn(device_norm)
        import_pp_modules()
        self.pp_img_string = pp_img
        self.pp_txt = build_pp_fn(pp_txt) if pp_txt else None
        self.class_names = list(class_names) if class_names else prompt_lib.get_class_names(
            self.dataset_name, canonicalize=canonicalize,
            first_class_name_only=first_class_name_only)
        self.templates = prompt_lib.get_prompt_templates(prompt_templates)
        self.timings: dict = {}
        self._tokens = None  # ((names, templates), token ids)
        self.int8_scales = None

        if source is not None:
            self.source = source
        elif data_dir == "synthetic":
            rng = np.random.RandomState(0)
            self.source = pipe.DictSource({
                "image": rng.randint(0, 255, (32, 64, 64, 3), np.uint8),
                "label": rng.randint(0, 1000, (32,)),
            })
        elif data_dir and os.path.isdir(data_dir):
            self.source = pipe.TfdsDirectorySource(data_dir, split)
        elif data_dir:
            data = np.load(data_dir)
            self.source = pipe.DictSource({"image": data["image"], "label": data["label"]})
        else:
            raise ValueError("disclf evaluator needs `source` or npz `data_dir`")

    # -- class embeddings ---------------------------------------------------

    def prompt_tokens(self, classes=None) -> np.ndarray:
        """(classes x templates, L) token ids, class-major (disclf.py:217-222),
        of `classes` (indices; default all), tokenized once for each set of
        names, templates and classes (the host WordPiece of every prompt is
        the costly part on the host)."""
        classes = range(len(self.class_names)) if classes is None else classes
        key = (tuple(self.class_names), tuple(self.templates), tuple(int(c) for c in classes))
        if self._tokens is None or self._tokens[0] != key:
            rows = []
            for ci in classes:
                cname = self.class_names[ci]
                for tmpl in self.templates:
                    text = tmpl.format(cname) if "{}" in tmpl else f"{tmpl} {cname}"
                    rows.append(self.pp_txt({"texts": text}, np.random.default_rng(0))["labels"])
            self._tokens = (key, np.stack(rows))
        return self._tokens[1]

    def prompt_embeddings(self, tokens: np.ndarray) -> torch.Tensor:
        """(prompts, D) f32 on the device: the text tower over the prompts
        TEXT_CHUNK at a time, the last chunk zero-padded."""
        dev = self.towers.device
        zs = []
        for i in range(0, len(tokens), TEXT_CHUNK):
            chunk = tokens[i:i + TEXT_CHUNK]
            real = len(chunk)
            if real < TEXT_CHUNK:
                chunk = np.pad(chunk, ((0, TEXT_CHUNK - real), (0, 0)))
            z = self.towers.embed_texts(torch.from_numpy(np.asarray(chunk, np.int64)).to(dev))
            zs.append(z[:real])
        return torch.cat(zs)

    def _average(self, z: torch.Tensor) -> torch.Tensor:
        z = z.reshape(len(self.class_names), len(self.templates), -1).mean(1)
        return z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)

    def class_embeddings(self, tokens: np.ndarray) -> torch.Tensor:
        """(classes, D) f32 on the device: each class's prompt embeddings
        averaged, then L2-normalised with + 1e-8 (one process's tokens of
        every class)."""
        return self._average(self.prompt_embeddings(tokens))

    def _splits(self, mesh) -> list:
        """The class indices of each batch shard (JAX :201-206)."""
        return np.array_split(np.arange(len(self.class_names)), mesh.batch_shards)

    def local_classes(self):
        """The classes whose prompts this process embeds: all in one
        process; on a mesh its batch shard's split, padded with class 0 to
        the largest split (every shard embeds as many prompts)."""
        mesh = eval_common.batch_mesh(self.mesh)
        if mesh is None:
            return None
        splits = self._splits(mesh)
        mine = [int(c) for c in splits[mesh.batch_index]]
        return mine + [0] * (max(len(c) for c in splits) - len(mine))

    def class_matrix(self, tokens: np.ndarray) -> torch.Tensor:
        """The class embeddings from this process's prompt tokens (those of
        :meth:`local_classes`); on a process mesh an all-gather joins the
        shards' prompt embeddings (JAX ``_build_class_embeddings``,
        :192-240)."""
        mesh = eval_common.batch_mesh(self.mesh)
        if mesh is None:
            return self.class_embeddings(tokens)
        splits, n_t = self._splits(mesh), len(self.templates)
        parts = eval_common.gather_rows(self.prompt_embeddings(tokens), mesh)
        parts = parts.reshape(mesh.batch_shards, len(tokens), -1)
        return self._average(torch.cat([parts[p, :len(c) * n_t] for p, c in enumerate(splits)]))

    # -- int8 ---------------------------------------------------------------

    def _whole_vision(self, opt) -> dict | None:
        """The image tower's whole leaves (name within the tower -> tensor
        on its device) when the mesh shards them, gathered (a collective);
        None when the model holds them whole."""
        if opt is None or opt.mesh is None or not (opt.tensor_plan or opt.fsdp_chunked):
            return None
        from openvision_tpu_torch.train.checkpoint import gather_leaves

        pieces = {n: p for n, p in opt.params.items() if n.startswith("visual.")}
        return {n.removeprefix("visual."): t.to(self.towers.device)
                for n, t in gather_leaves(pieces, self.towers.model, opt).items()}

    def _int8_encoder(self, calib_images: torch.Tensor, opt=None):
        """zimg of (normalised) images through the int8 kernels, with the
        scales fixed on `calib_images` (this process's; on a mesh every
        shard's are gathered and the same global prefix taken) or dynamic."""
        from openvision_tpu_torch.serving import quant

        vision = self.towers.vision
        qp = self.towers.int8
        if qp is None:
            whole = self._whole_vision(opt)
            dtypes = ({v.dtype for k, v in whole.items() if k.endswith("attn.in_proj_weight")}
                      if whole is not None else
                      {blk.attn.in_proj_weight.dtype for blk in vision.transformer.resblocks})
            if dtypes != {torch.float32}:
                raise ValueError(
                    "disclf int8 quantises the image tower from its f32 weights, but its block "
                    f"matrices are {sorted(map(str, dtypes))}: load the model with "
                    "load_model(..., int8=True), or evaluate the trainer's f32 model")
            qp = quant.quantize_vit_params(vision, whole)
        geom = dict(patch_size=vision.conv1.kernel_size[0], posemb=vision.posemb)
        scales = None
        if self.int8_calibration > 0 and len(calib_images):
            calib = eval_common.gather_rows(calib_images.float(), self.mesh)
            scales = quant.calibrate_vit(qp, calib[:self.int8_calibration], **geom)
        self.int8_scales = scales
        return lambda image: quant.quantized_encode(qp, image, act_scales=scales, **geom)

    # -- run ----------------------------------------------------------------

    def run(self, train_state=None, return_preds: bool = False):
        """[(f"{dataset}_accuracy", value)]; with `return_preds`, also the
        per-row argmax predictions and the batches' ``_mask`` as flat numpy
        arrays (padded rows included, as JAX returns them; one process
        only)."""
        mesh = eval_common.batch_mesh(self.mesh)
        if return_preds and self.mesh is not None and self.mesh.batch_shards * self.mesh.tensor > 1:
            raise ValueError("return_preds is a single-process probe; on a process mesh the "
                             "accuracy metrics themselves are what runs")
        dev = self.towers.device
        timings = self.timings = {}
        self.int8_scales = None
        with self.towers.evaluating():
            t0 = time.perf_counter()
            tokens = self.prompt_tokens(self.local_classes())
            timings["tokenize"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            class_embs = self.class_matrix(tokens)
            _sync(dev)
            timings["class_embed"] = time.perf_counter() - t0

            it = pipe.make_for_inference(self.source, self.pp_img_string, self.batch_size,
                                         num_workers=self.num_workers, mesh=mesh)()
            ncorrect = torch.zeros((), device=dev)
            ntotal = torch.zeros((), device=dev)
            preds, masks = [], []
            encode = None
            host = copy = 0.0
            t_loop = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                host += time.perf_counter() - t0
                if batch is None:
                    break
                label_key = (self.multi_label_key if self.multi_label_key
                             and self.multi_label_key in batch else "label")
                t0 = time.perf_counter()
                images = torch.from_numpy(np.asarray(
                    batch["image"], np.uint8 if self.device_norm else np.float32)).to(dev)
                labels = torch.from_numpy(np.asarray(batch[label_key], np.int64)).to(dev)
                mask = torch.from_numpy(np.asarray(batch["_mask"], np.float32)).to(dev)
                copy += time.perf_counter() - t0
                images = self._apply_device_norm(images)
                if self.int8:
                    if encode is None:
                        encode = self._int8_encoder(images, (train_state or {}).get("opt"))
                    zimg = encode(images)
                else:
                    zimg = self.towers.embed_images(images)
                pred = torch.argmax(zimg @ class_embs.T, dim=-1)
                if return_preds:
                    preds.append(pred)
                    masks.append(mask)
                if labels.ndim == 2:  # multi-label: any valid label; rows padded with -1
                    hit = (pred[:, None] == labels).any(-1)
                    has_any = (labels >= 0).any(-1)
                    correct = (hit & has_any).float()
                    mask = mask * has_any.float()
                else:
                    correct = (pred == labels).float()
                ncorrect += (correct * mask).sum()
                ntotal += mask.sum()
            if mesh is not None:
                from openvision_tpu_torch.parallel import all_reduce

                ncorrect, ntotal = all_reduce(torch.stack([ncorrect, ntotal]), mesh.batch_group)
            ncorrect, ntotal = float(ncorrect), float(ntotal)  # the one sync
            timings.update(host=host, copy=copy, loop=time.perf_counter() - t_loop)
        self.counts = (ncorrect, ntotal)
        metrics = [(f"{self.dataset_name}_accuracy", ncorrect / max(ntotal, 1.0))]
        if return_preds:
            return (metrics, torch.cat(preds).cpu().numpy().ravel(),
                    torch.cat(masks).cpu().numpy().ravel())
        return metrics

"""Image<->text retrieval evaluator (COCO / Flickr30k style).

Counterpart of ``openvision_tpu/evaluators/retrieval.py``: captions unrolled
per image with a ``txt2img`` map, images embedded through
``data/pipeline.py:make_for_inference`` (the pp string, ``device_norm``
honoured: uint8 across to the card), captions through the text tower in
``batch_size`` chunks, the full similarity matrix of the L2-normalised
(``+ 1e-8``) embeddings, and Recall@{1,5,10} both ways
(:func:`recall_at_k`, :25). The towers run in eval mode under
``torch.no_grad()`` and go back to the mode they had. On a process mesh
every process embeds every image (``make_for_inference(shard=False)``,
batches of ``batch_size / batch_shards`` rows) and every caption, in
lockstep, and scores the whole matrix itself (JAX :110-140).

Data: ``source`` giving {"image", "captions"} (a list or array of strings,
or one string of lines), or ``data_dir``: "synthetic" (16 random 64x64
images, one caption each) or an npz with "image" and an object array
"captions".
"""

from __future__ import annotations

import numpy as np
import torch

from openvision_tpu_torch.data import pipeline as pipe
from openvision_tpu_torch.data.pp import build_pp_fn, import_pp_modules
from openvision_tpu_torch.evaluators import common as eval_common

RECALL_KS = (1, 5, 10)


def recall_at_k(sim: np.ndarray, txt2img: np.ndarray, ks=RECALL_KS) -> dict:
    """sim: (n_img, n_txt). Returns Recall@k for both directions."""
    n_img, n_txt = sim.shape
    out = {}
    order = np.argsort(-sim.T, axis=1)  # text -> image: rank images for each text
    correct = order == txt2img[:, None]
    for k in ks:
        out[f"txt2img_recall@{k}"] = float(correct[:, :k].any(axis=1).mean())
    order = np.argsort(-sim, axis=1)  # image -> text: rank texts for each image
    hit = txt2img[order] == np.arange(n_img)[:, None]
    for k in ks:
        out[f"img2txt_recall@{k}"] = float(hit[:, :k].any(axis=1).mean())
    return out


class _ImagesOnly:
    """The source's images alone (ragged caption lists cannot be stacked)."""

    def __init__(self, source):
        self.source = source

    def __len__(self):
        return len(self.source)

    def __getitem__(self, i):
        return {"image": self.source[i]["image"]}


class Evaluator:
    def __init__(self, model, mesh=None, *, dataset="coco_captions", split="val", data_dir="",
                 txt_name=("captions", "text"), pp_img="", pp_txt="", batch_size: int = 256,
                 source=None, device_norm: str = "", num_workers: int = 0, **unused):
        self.towers = eval_common.Towers(model)
        self.mesh = mesh
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        import_pp_modules()
        self.pp_img_string = pp_img
        self.pp_txt = build_pp_fn(pp_txt) if pp_txt else None
        self.device_norm = device_norm
        self._norm = eval_common.device_norm_fn(device_norm)
        if source is not None:
            self.source = source
        elif data_dir == "synthetic":
            rng = np.random.RandomState(0)
            self.source = pipe.DictSource({
                "image": rng.randint(0, 255, (16, 64, 64, 3), np.uint8),
                "captions": np.array([f"a photo number {i}" for i in range(16)]),
            })
        elif data_dir:
            data = np.load(data_dir, allow_pickle=True)
            self.source = pipe.DictSource({"image": data["image"], "captions": data["captions"]})
        else:
            raise ValueError("retrieval evaluator needs `source` or npz `data_dir`")

    def caption_tokens(self):
        """(token ids (n_txt, L), txt2img (n_txt,)): every caption of every
        image, in order."""
        rng = np.random.default_rng(0)
        texts, txt2img = [], []
        for i in range(len(self.source)):
            caps = self.source[i]["captions"]
            if isinstance(caps, (bytes, str)):
                caps = str(caps).split("\n")
            for cap in np.asarray(caps).reshape(-1):
                cap = cap.decode() if isinstance(cap, bytes) else str(cap)
                texts.append(self.pp_txt({"texts": cap}, rng)["labels"])
                txt2img.append(i)
        return np.stack(texts), np.asarray(txt2img)

    def embed_images(self) -> torch.Tensor:
        """(n_img, D) f32 on the device, the pp in the eval pipeline."""
        dev = self.towers.device
        it = pipe.make_for_inference(_ImagesOnly(self.source), self.pp_img_string,
                                     self.batch_size, num_workers=self.num_workers,
                                     shard=False, mesh=eval_common.batch_mesh(self.mesh))()
        outs = []
        for batch in it:
            images = torch.from_numpy(np.asarray(
                batch["image"], np.uint8 if self.device_norm else np.float32)).to(dev)
            keep = torch.from_numpy(np.asarray(batch["_mask"]) > 0).to(dev)
            outs.append(self.towers.embed_images(self._norm(images))[keep])
        return torch.cat(outs)

    def embed_texts(self, tokens: np.ndarray) -> torch.Tensor:
        dev, bs = self.towers.device, self.batch_size
        outs = []
        for i in range(0, len(tokens), bs):
            chunk = tokens[i:i + bs]
            pad = bs - len(chunk)
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            z = self.towers.embed_texts(torch.from_numpy(np.asarray(chunk, np.int64)).to(dev))
            outs.append(z[:bs - pad])
        return torch.cat(outs)

    def embeddings(self):
        """(zimg, ztxt, txt2img): the normalised embeddings on the device."""
        with self.towers.evaluating():
            tokens, txt2img = self.caption_tokens()
            zimg = self.embed_images()
            ztxt = self.embed_texts(tokens)
        zimg = zimg / (torch.linalg.norm(zimg, dim=-1, keepdim=True) + 1e-8)
        ztxt = ztxt / (torch.linalg.norm(ztxt, dim=-1, keepdim=True) + 1e-8)
        return zimg, ztxt, txt2img

    def run(self, train_state=None):
        zimg, ztxt, txt2img = self.embeddings()
        sim = zimg.cpu().numpy() @ ztxt.cpu().numpy().T  # on the host, as JAX
        return list(recall_at_k(sim, txt2img).items())

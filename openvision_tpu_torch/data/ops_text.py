"""Text preprocessing ops ``clip_i1k_label_names`` and ``get_autoreg_label``
(numpy).

The port's copies of ``openvision_tpu/data/ops_text.py:15, :26``: an
ImageNet-1K label's CLIP class name, and next-token targets (the bos
dropped and a pad appended).
"""

from __future__ import annotations

import numpy as np

from openvision_tpu_torch.data.pp import inkey_outkey, pp_op


@pp_op("clip_i1k_label_names")
@inkey_outkey(indefault="label", outdefault="labels")
def get_clip_i1k_label_names():
    from openvision_tpu_torch.evaluators.in1k_classes import CLIP_IMAGENET_CLASS_NAMES

    def op(label, rng):
        return np.asarray(CLIP_IMAGENET_CLASS_NAMES)[np.asarray(label)]

    return op


@pp_op("get_autoreg_label")
@inkey_outkey(indefault="labels_for_regress", outdefault="autoreg_labels")
def get_autoreg_label(pad_token=0):
    def op(label, rng):
        label = np.asarray(label)
        return np.concatenate([label[1:], np.array([pad_token], label.dtype)])

    return op

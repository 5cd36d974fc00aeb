"""Text preprocessing op ``get_autoreg_label`` (numpy).

The port's copy of ``openvision_tpu/data/ops_text.py:26``: next-token
targets, the bos dropped and a pad appended.
"""

from __future__ import annotations

import numpy as np

from openvision_tpu_torch.data.pp import inkey_outkey, pp_op


@pp_op("get_autoreg_label")
@inkey_outkey(indefault="labels_for_regress", outdefault="autoreg_labels")
def get_autoreg_label(pad_token=0):
    def op(label, rng):
        label = np.asarray(label)
        return np.concatenate([label[1:], np.array([pad_token], label.dtype)])

    return op

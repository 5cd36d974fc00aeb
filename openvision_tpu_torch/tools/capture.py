"""GELU activations of the image tower's encoder blocks, by forward hooks.

The JAX tools read the GELU output that ``MlpBlock`` sows as
``intermediates/Transformer/encoderblock_i/MlpBlock_0/gelu``
(openvision_tpu/models/layers.py:164-168) through ``mutable=
["intermediates"]``. The port hooks the block's ``mlp.act`` submodule
instead. Two routes never run ``MlpBlock.forward`` and so expose no GELU
output: ``fused_t`` blocks, and ``fused`` blocks with tanh GELU when autograd
records no parameter gradient (the tools' case: frozen weights), whose MLP
runs on the ``mlp_block`` kernels (models/encoder.py). The JAX ``fused_t``
block does not sow either and its tools then fail on a missing key; here
:func:`gelu_hooks` raises :class:`GeluCaptureError` naming the route, never
an empty capture.
"""

from __future__ import annotations

import contextlib


class GeluCaptureError(RuntimeError):
    """A hooked block ran no ``MlpBlock.forward`` (the MLP ran on a kernel)."""


def _mlp_route(vision) -> str:
    enc = vision.transformer
    if enc.attn_impl == "fused_t":
        return "attn_impl='fused_t'"
    if enc.attn_impl == "fused" and enc.gelu_approx:
        return "attn_impl='fused' with tanh GELU (fast_gelu)"
    return f"attn_impl={enc.attn_impl!r}"


class GeluCapture:
    """The captured activations by layer; reading a layer that did not fire
    raises :class:`GeluCaptureError`."""

    def __init__(self, vision, layers):
        self.vision, self.layers, self.acts = vision, list(layers), {}

    def _missing(self, layers) -> GeluCaptureError:
        return GeluCaptureError(
            f"GELU capture: encoder block(s) {layers} ran no MlpBlock.forward: on the route "
            f"{_mlp_route(self.vision)} the MLP runs on the mlp_block kernels "
            "(ops/fused_encoder.py), which expose no GELU output; load the model with "
            "attn_impl='xla', or 'fused' with exact GELU (fast_gelu=False)")

    def __getitem__(self, layer: int):
        if layer not in self.acts:
            raise self._missing([layer])
        return self.acts[layer]

    def check(self) -> None:
        missing = [i for i in self.layers if i not in self.acts]
        if missing:
            raise self._missing(missing)


@contextlib.contextmanager
def gelu_hooks(vision, layers):
    """Hooks the GELU of each block in `layers` of the ViT `vision` while the
    context is open; yields a :class:`GeluCapture` that the forwards inside
    fill ({layer: (B, L, mlp_dim) activations in the compute dtype}). On a
    normal exit every hooked layer must have fired."""
    cap = GeluCapture(vision, layers)
    blocks = vision.transformer.resblocks
    handles = []

    def hook(layer):
        def store(_module, _inputs, out):
            cap.acts[layer] = out
        return store

    try:
        for i in cap.layers:
            handles.append(blocks[i].mlp.act.register_forward_hook(hook(i)))
        yield cap
        cap.check()
    finally:
        for h in handles:
            h.remove()

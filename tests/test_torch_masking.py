"""Token masking and batch mixup/cutmix against the JAX package, on the CPU.

- ``random_token_masking`` in its three modes (``random``, ``square``,
  ``per2x2_random_grid``) on the draws the JAX function makes from its key
  (uniform noise; a window index, top and left; 2x2 scores): the kept
  tokens, the mask and ids_restore equal to the JAX outputs (exact: the
  same stable sort of the same numbers);
- the masked ViT in training (``mask_ratio`` > 0, the cls token kept, the
  tokens after the position embedding) against the JAX ViT, both fed the
  same masking draws: pooled output and patch tokens within 1e-4 (f32,
  summation order only), the tokens cut to 1 + int(P (1 - ratio));
- ``mixup_cutmix`` on one ``np.random.Generator`` state: the same images
  and soft labels as the JAX function (exact), mixup and cutmix both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.data.ops_aug import mixup_cutmix as jmixup
from openvision_tpu.models import vit as jvit
from openvision_tpu.parallel import unbox
from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict
from openvision_tpu_torch.data.ops_aug import mixup_cutmix as tmixup
from openvision_tpu_torch.models import vit as tvit

CASES = [("random", 0.75, 14), ("random", 0.5, 7), ("square", 0.75, 14), ("square", 0.5, 14),
         ("square", 0.5, 7), ("per2x2_random_grid", 0.75, 14),
         ("per2x2_random_grid", 0.5, 14), ("per2x2_random_grid", 0.25, 8)]


def jax_draws(key, mode: str, ratio: float, n: int, h: int, w: int) -> dict:
    """The draws ``openvision_tpu.models.vit.random_token_masking`` makes
    from `key` (:128-155), as numpy."""
    if mode == "random":
        return {"noise": np.asarray(jax.random.uniform(key, (n, h * w)))}
    if mode == "square":
        hs, _ = jvit._SQUARE_WINDOWS[ratio]
        k_idx, k_top, k_left = jax.random.split(key, 3)
        return {"pick": np.asarray(jax.random.randint(k_idx, (n,), 0, len(hs))),
                "top": np.asarray(jax.random.randint(k_top, (n,), 0, h)),
                "left": np.asarray(jax.random.randint(k_left, (n,), 0, w))}
    return {"scores": np.asarray(jax.random.uniform(key, (n, h // 2, w // 2, 4)))}


def _torch(draws: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("mode,ratio,grid", CASES)
def test_masking_modes_match_jax_on_its_draws(mode, ratio, grid):
    n, d = 3, 5
    x = np.random.default_rng(grid).standard_normal((n, grid * grid, d)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jvit.random_token_masking(jnp.asarray(x), ratio, key, mask_mode=mode, height=grid,
                                     width=grid)
    draws = _torch(jax_draws(key, mode, ratio, n, grid, grid))
    got = tvit.random_token_masking(torch.from_numpy(x), ratio, mask_mode=mode, height=grid,
                                    width=grid, draws=draws)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (n, int(grid * grid * (1 - ratio)), d)


def test_masking_draws_come_from_the_generator():
    x = torch.randn(2, 49, 4)
    a = tvit.random_token_masking(x, 0.5, torch.Generator().manual_seed(1), height=7, width=7)
    b = tvit.random_token_masking(x, 0.5, torch.Generator().manual_seed(1), height=7, width=7)
    c = tvit.random_token_masking(x, 0.5, torch.Generator().manual_seed(2), height=7, width=7)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert a[0].shape == (2, 24, 4)


@pytest.mark.parametrize("mode,ratio", [("random", 0.5), ("square", 0.5),
                                        ("per2x2_random_grid", 0.5)])
def test_masked_vit_forward_matches_jax(monkeypatch, mode, ratio):
    """Both towers fed the same draws: the JAX function's key is fixed by a
    wrapper, and the port's draws are the ones it makes from that key."""
    key = jax.random.PRNGKey(3)
    orig = jvit.random_token_masking
    monkeypatch.setattr(jvit, "random_token_masking",
                        lambda x, r, _rng, **kw: orig(x, r, key, **kw))
    res, patch, width = 64, 8, 32
    cfg = dict(patch_size=(patch, patch), width=width, depth=2, mlp_dim=64, num_heads=2,
               posemb="learn", pool_type="gap", attn_impl="xla", mask_ratio=ratio,
               mask_mode=mode, output_tokens=True)
    jmodel = jvit.ViT(num_classes=16, **cfg)
    images = np.random.default_rng(0).standard_normal((2, res, res, 3)).astype(np.float32)
    params = unbox(jmodel.init({"params": jax.random.PRNGKey(0),
                                "random_mask": jax.random.PRNGKey(1)},
                               jnp.asarray(images), train=True)["params"])
    pooled, tokens = jmodel.apply({"params": params}, jnp.asarray(images), train=True,
                                  rngs={"random_mask": jax.random.PRNGKey(1)})
    g = res // patch
    draws = _torch(jax_draws(key, mode, ratio, 2, g, g))
    monkeypatch.setattr(tvit, "draw_masking", lambda *a, **k: draws)
    port = tvit.Model(16, image_size=res, **cfg)
    port.load_state_dict({k.removeprefix("visual."): v for k, v in
                          jax_params_to_state_dict({"img": params}).items()})
    got_pooled, got_tokens = port(torch.from_numpy(images), train=True,
                                  rng=torch.Generator().manual_seed(0))
    assert got_tokens.shape == (2, int(g * g * (1 - ratio)), width)
    np.testing.assert_allclose(got_pooled.detach().numpy(), np.asarray(pooled), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got_tokens.detach().numpy(), np.asarray(tokens), atol=1e-4,
                               rtol=1e-4)
    # not training: no masking, every token
    assert port(torch.from_numpy(images))[1].shape == (2, g * g, width)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mixup_cutmix_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    imgs = rng.integers(0, 255, (6, 16, 12, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, (6,))
    kw = dict(num_classes=10, switch_prob=0.5)
    want = jmixup(imgs, labels, np.random.default_rng(seed), **kw)
    got = tmixup(imgs, labels, np.random.default_rng(seed), **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[1].sum(axis=1), 1.0, atol=1e-5)

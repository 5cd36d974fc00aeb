"""The port's augmentations, tool optimizers and PNG writer against the JAX
package and optax.

Each random augmentation of ``openvision_tpu_torch/tools/augment.py`` is
held on its apply: the draws JAX's function makes from its key (split as
that function splits it) go into the port's ``*_apply``, whose output must
match the JAX function's within rtol 1e-5 (atol 1e-6; f32 on the CPU). The
port's own draws are held on their ranges and shapes. The deterministic
functions take the same inputs, the same tolerance; the affine warp's
gradient with respect to the images is held against ``jax.grad`` the same
way, within rtol 1e-5 and atol 1e-5 (atol 1e-6 for the values): a pixel's
gradient sums several interpolation weights, in another order than XLA's
scatter-add. The Adamax-with-cosine-decay and Adam updates
(``tools/optimizers.py``) match optax's over 4 steps within rtol 1e-6.
``encode_png`` round-trips through ``decode_png`` and Pillow exactly.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openvision_tpu.tools import augment as jaug
from openvision_tpu_torch.tools import augment as taug
from openvision_tpu_torch.tools import optimizers

RTOL, ATOL = 1e-5, 1e-6


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=atol)


def _affine_draws(key, b, degrees=10.0, translate=0.1, p=0.8):
    """The draws of jaug.random_affine(key, ...), split as it splits key."""
    k_ang, k_tx, k_ty, k_p = jax.random.split(key, 4)
    max_rad = jnp.deg2rad(degrees)
    return (jax.random.uniform(k_ang, (b,), minval=-max_rad, maxval=max_rad),
            jax.random.uniform(k_tx, (b,), minval=-translate, maxval=translate),
            jax.random.uniform(k_ty, (b,), minval=-translate, maxval=translate),
            jax.random.bernoulli(k_p, p, (b,)))


@pytest.mark.parametrize("shape,degrees,translate,p", [
    ((6, 16, 16, 3), 10.0, 0.1, 0.8),
    ((4, 13, 21, 2), 45.0, 0.4, 1.0),  # odd sizes, far past the border
    ((3, 8, 8, 1), 180.0, 0.0, 0.5),
])
def test_random_affine_apply_matches_jax(shape, degrees, translate, p):
    key = jax.random.PRNGKey(sum(shape))
    x = _images(shape)
    want = jaug.random_affine(key, jnp.asarray(x), degrees=degrees, translate=translate, p=p)
    draws = [_t(d) for d in _affine_draws(key, shape[0], degrees, translate, p)]
    _close(taug.random_affine_apply(_t(x), *draws), want)


def test_random_affine_gradient_matches_jax():
    key = jax.random.PRNGKey(3)
    x = _images((4, 12, 12, 3))
    w = _images((4, 12, 12, 3), seed=1)
    want = jax.grad(lambda im: jnp.sum(jaug.random_affine(key, im, degrees=30.0, p=1.0) * w))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    draws = [_t(d) for d in _affine_draws(key, 4, 30.0, 0.1, 1.0)]
    (taug.random_affine_apply(xt, *draws) * _t(w)).sum().backward()
    _close(xt.grad, want, atol=1e-5)


def test_random_affine_draw_ranges():
    gen = torch.Generator().manual_seed(0)
    angles, txs, tys, on = taug.random_affine_draw(gen, 4096, degrees=10.0, translate=0.1, p=0.8)
    assert angles.shape == txs.shape == tys.shape == on.shape == (4096,)
    assert angles.abs().max() <= np.deg2rad(10.0) and angles.abs().max() > np.deg2rad(9.9)
    assert txs.abs().max() <= 0.1 and tys.abs().max() <= 0.1
    assert on.dtype == torch.bool and 0.77 < on.float().mean() < 0.83


@pytest.mark.parametrize("lim", [1, 3, 8])
def test_pixel_jitter_matches_jax(lim):
    key = jax.random.PRNGKey(lim)
    x = _images((5, 9, 11, 3))
    want = jaug.pixel_jitter(key, jnp.asarray(x), lim=lim)
    shifts = jax.random.randint(key, (5, 2), -lim, lim + 1)
    _close(taug.pixel_jitter_apply(_t(x), _t(shifts)), want)
    got = taug.pixel_jitter_draw(torch.Generator().manual_seed(0), 2048, lim)
    assert got.shape == (2048, 2) and got.min() == -lim and got.max() == lim


def test_color_jitter_matches_jax():
    key = jax.random.PRNGKey(5)
    x = _images((4, 8, 8, 3))
    want = jaug.color_jitter(key, jnp.asarray(x), brightness=0.2, contrast=0.3)
    kb, kc = jax.random.split(key)
    bf = 1 + jax.random.uniform(kb, (4, 1, 1, 1), minval=-0.2, maxval=0.2)
    cf = 1 + jax.random.uniform(kc, (4, 1, 1, 1), minval=-0.3, maxval=0.3)
    _close(taug.color_jitter_apply(_t(x), _t(bf), _t(cf)), want)
    bf_t, cf_t = taug.color_jitter_draw(torch.Generator().manual_seed(0), 1024, 0.2, 0.3)
    assert bf_t.shape == cf_t.shape == (1024, 1, 1, 1)
    assert (bf_t - 1).abs().max() <= 0.2 and (cf_t - 1).abs().max() <= 0.3


def test_gaussian_noise_matches_jax():
    key = jax.random.PRNGKey(6)
    x = _images((2, 8, 8, 3))
    want = jaug.gaussian_noise(key, jnp.asarray(x), std=0.05)
    noise = jax.random.normal(key, x.shape)
    _close(taug.gaussian_noise_apply(_t(x), _t(noise), std=0.05), want)
    n = taug.gaussian_noise_draw(torch.Generator().manual_seed(0), (64, 32, 32, 3))
    assert n.shape == (64, 32, 32, 3) and abs(n.mean()) < 0.01 and abs(n.std() - 1) < 0.01


@pytest.mark.parametrize("size,std", [(8, 4.0), (10, 0.5), (15, 3.0), (5, 100.0)])
def test_centering_matches_jax(size, std):
    key = jax.random.PRNGKey(size)
    x = _images((2, 16, 15, 3))
    want = jaug.centering(key, jnp.asarray(x), size, std)
    pert = (jax.random.uniform(key, (2,)) * 2.0 - 1.0) * std
    _close(taug.centering_apply(_t(x), _t(pert), size), want)
    p = taug.centering_draw(torch.Generator().manual_seed(0), std)
    assert p.shape == (2,) and p.abs().max() <= std
    with pytest.raises(ValueError, match="larger"):
        taug.centering_apply(_t(x), _t(pert), 16)


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_flip_matches_jax(p):
    key = jax.random.PRNGKey(7)
    x = _images((3, 4, 6, 2))
    want = jaug.flip(key, jnp.asarray(x), p=p)
    do = jax.random.bernoulli(key, p)
    _close(taug.flip_apply(_t(x), _t(do)), want)
    assert taug.flip_draw(torch.Generator().manual_seed(0), p).shape == ()


def test_color_jitter_affine_matches_jax():
    key = jax.random.PRNGKey(8)
    x = _images((4, 6, 6, 3))
    want = jaug.color_jitter_affine(key, jnp.asarray(x), mean=0.5, std=0.7)
    km, ks = jax.random.split(key)
    m = (jax.random.uniform(km, (4, 1, 1, 3)) - 0.5) * 2.0 * 0.5
    s = jnp.exp((jax.random.uniform(ks, (4, 1, 1, 3)) - 0.5) * 2.0 * 0.7)
    _close(taug.color_jitter_affine_apply(_t(x), _t(m), _t(s)), want)
    m_t, s_t = taug.color_jitter_affine_draw(torch.Generator().manual_seed(0), 512, 0.5, 0.7)
    assert m_t.shape == s_t.shape == (512, 1, 1, 3)
    assert m_t.abs().max() <= 0.5 and s_t.log().abs().max() <= 0.7 + 1e-6


@pytest.mark.parametrize("name,args", [
    ("total_variation", ()),
    ("tile", (3,)),
    ("repeat_batch", (3,)),
    ("zoom", (24,)),  # up
    ("zoom", (5,)),  # down: antialiased
    ("zoom", (7,)),
])
def test_deterministic_functions_match_jax(name, args):
    x = _images((2, 11, 11, 3))
    want = getattr(jaug, name)(jnp.asarray(x), *args)
    _close(getattr(taug, name)(_t(x), *args), want)


@pytest.mark.parametrize("name,shape", [
    ("activation_norm_loss", (3, 7, 16)),
    ("diversity_loss", (6, 32)),
    ("diversity_loss", (2, 5)),
])
def test_losses_match_jax(name, shape):
    x = _images(shape)
    _close(getattr(taug, name)(_t(x)), getattr(jaug, name)(jnp.asarray(x)))


def _optax_run(tx, grads, x0):
    state = tx.init(jnp.asarray(x0))
    x, out = jnp.asarray(x0), []
    for g in grads:
        u, state = tx.update(jnp.asarray(g), state, x)
        x = optax.apply_updates(x, u)
        out.append(np.asarray(x))
    return out


@pytest.mark.parametrize("which", ["adamax_cosine", "adam"])
def test_tool_optimizers_match_optax(which):
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 5, 7)).astype(np.float32)
    grads = [rng.standard_normal(x0.shape).astype(np.float32) * s for s in (1.0, 0.01, 3.0, 1e-5)]
    if which == "adam":
        want = _optax_run(optax.adam(5.0), grads, x0)
        tx = optimizers.adam(5.0)
    else:  # few decay steps, so the schedule moves between steps
        want = _optax_run(optax.adamax(optax.cosine_decay_schedule(1.0, 3)), grads, x0)
        tx = optimizers.adamax(optimizers.cosine_decay_schedule(1.0, 3))
    x = _t(x0)
    state = tx.init(x)
    for g, w in zip(grads, want):
        u, state = tx.update(_t(g), state)
        x = optimizers.apply_updates(x, u)
        np.testing.assert_allclose(x.numpy(), w, rtol=1e-6, atol=1e-6)


def test_cosine_schedule_matches_optax():
    want = optax.cosine_decay_schedule(1.0, 400)
    got = optimizers.cosine_decay_schedule(1.0, 400)
    for count in (0, 1, 57, 199, 200, 399, 400, 1000):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (33, 5), (224, 224)])
def test_encode_png_round_trip(h, w):
    from PIL import Image

    from openvision_tpu_torch.data.ops_image import decode_png, encode_png

    x = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    data = encode_png(x)
    np.testing.assert_array_equal(decode_png(data), x)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), x)


def test_encode_png_refuses_other_arrays():
    from openvision_tpu_torch.data.ops_image import encode_png

    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4, 4), np.uint8))

"""The port's interpretability tools against the JAX package's.

One tiny exported model (tests/test_torch_tools.py's: JAX random init ->
OpenCLIP artifacts, 2 blocks, width 64, 32 x 32 images in 16 x 16 patches)
is loaded by both packages, f32 on the CPU. Held against JAX, with the
tolerances stated:

- the text tower's soft one-hot branch against JAX's 3-D branch (1e-5
  relative), against the integer path on exact one-hots (1e-6), and its
  gradient with respect to the soft tokens against ``jax.grad`` (1e-4 of
  the largest gradient: a sum over 30522 vocab rows);
- ``capture_gelu`` against JAX's sown intermediates for every layer (1e-5
  of the largest activation), and the named error on the kernel routes;
  on ``fused`` with exact GELU the capture equals xla's (1e-5), and the
  input gradient with frozen weights through the fused blocks' autograd
  Function (its plain twins on the CPU) equals xla's (1e-5);
- one ``build_step`` of feature_viz and of gradient_ascent with the same
  image, the same noise and augmentation draws and the same init: loss,
  per-sample loss, text embedding, tokens and updated parameters (1e-4
  relative: one step of Adamax / Adam divides by a gradient's magnitude);
- ``adv`` for 3 iterations (1e-5), ``pgd``'s first gradient against
  ``jax.grad`` (1e-4 of its largest value), eps, [0, 1] and the loss's
  direction.

The CLIs are held in tests/test_torch_interpretability_cli.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tools import CTX, RES, V, model_dir  # noqa: F401  (the tiny export)
from torch_jax_wordpiece import jax_python_wordpiece  # noqa: E402,F401 (autouse)

IMG = "testcat/catcat.png"


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def models(model_dir):  # noqa: F811
    from openvision_tpu.tools.model_io import load_model as jload
    from openvision_tpu_torch.tools.model_io import load_model

    return jload(model_dir), load_model(model_dir, device="cpu")


# ---- the soft one-hot text tower ----


def test_soft_text_tokens_match_jax(models):
    jm, tm = models
    rng = np.random.default_rng(0)
    soft = jax.nn.softmax(rng.standard_normal((3, CTX, V)).astype(np.float32) * 4, axis=-1)
    soft = np.array(soft)
    want = jm.text.apply({"params": jm.params["txt"]}, jnp.asarray(soft))
    got = tm.text(torch.from_numpy(soft))
    assert _rel(got.detach(), want) < 1e-5

    ids = rng.integers(0, V, (3, CTX))
    onehot = torch.nn.functional.one_hot(torch.from_numpy(ids), V).float()
    assert _rel(tm.text(onehot).detach(), tm.text(torch.from_numpy(ids)).detach()) < 1e-6

    w = rng.standard_normal((3, want.shape[-1])).astype(np.float32)
    g_want = jax.grad(lambda s: jnp.sum(jm.text.apply({"params": jm.params["txt"]}, s) * w))(
        jnp.asarray(soft))
    x = torch.from_numpy(soft).requires_grad_(True)
    (tm.text(x) * torch.from_numpy(w)).sum().backward()
    assert _rel(x.grad, g_want) < 1e-4


def test_soft_tokens_refuse_argmax_pool():
    from openvision_tpu_torch.models.text import TextTransformer

    tower = TextTransformer(num_classes=8, width=16, depth=1, num_heads=2, vocab_size=11,
                            context_length=4, pool_type="argmax")
    tower(torch.zeros(2, 4, dtype=torch.long))  # integer ids pool by argmax
    with pytest.raises(ValueError, match="argmax"):
        tower(torch.zeros(2, 4, 11))


# ---- GELU capture ----


def test_capture_gelu_matches_jax(models):
    from openvision_tpu.tools import neuron_capture as jnc
    from openvision_tpu_torch.data.ops_image import decode_png
    from openvision_tpu_torch.tools import neuron_capture as tnc

    jm, tm = models
    with open(IMG, "rb") as f:
        image = decode_png(f.read())
    want, got = jnc.capture_gelu(jm, image), tnc.capture_gelu(tm, image)
    assert sorted(got) == sorted(want) == [0, 1]
    for layer in want:
        assert got[layer].shape == want[layer].shape == ((RES // 16) ** 2 + 1, 256)
        assert got[layer].dtype == np.float32
        assert _rel(got[layer], want[layer]) < 1e-5, layer


@pytest.mark.parametrize("impl,fast_gelu,route", [
    ("fused_t", True, "fused_t"),
    ("fused", True, "tanh GELU"),
])
def test_capture_names_the_kernel_route(model_dir, impl, fast_gelu, route):  # noqa: F811
    from openvision_tpu_torch.tools import neuron_capture as tnc
    from openvision_tpu_torch.tools.capture import GeluCaptureError
    from openvision_tpu_torch.tools.model_io import load_model

    m = load_model(model_dir, attn_impl=impl, fast_gelu=fast_gelu, device="cpu")
    image = np.zeros((RES, RES, 3), np.uint8)
    with pytest.raises(GeluCaptureError, match=re.escape(route)):
        tnc.capture_gelu(m, image)


def test_capture_on_fused_with_exact_gelu_matches_xla(models, model_dir):  # noqa: F811
    from openvision_tpu_torch.tools import neuron_capture as tnc
    from openvision_tpu_torch.tools.model_io import load_model

    image = np.random.default_rng(1).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    want = tnc.capture_gelu(models[1], image)
    got = tnc.capture_gelu(load_model(model_dir, attn_impl="fused", device="cpu"), image)
    for layer in want:
        assert _rel(got[layer], want[layer]) < 1e-5


def test_input_gradient_through_fused_blocks_matches_xla(models, model_dir):  # noqa: F811
    """Frozen weights, an input that requires grad: the fused blocks' autograd
    Function (its plain twins on the CPU) gives xla's input gradient."""
    from openvision_tpu_torch.tools.model_io import load_model

    fused = load_model(model_dir, attn_impl="fused", device="cpu")
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal((2, RES, RES, 3),
                                                                   dtype=np.float32))
    grads = []
    for m in (models[1], fused):
        x = x0.clone().requires_grad_(True)
        m.vision(x).pow(2).sum().backward()
        grads.append(x.grad)
    assert _rel(grads[1], grads[0]) < 1e-5
    assert all(p.grad is None for p in fused.vision.parameters())


# ---- feature_viz ----


def _jax_fv_draws(key, size, repeat):
    k1, k2, k3 = jax.random.split(key, 3)
    kb, kc = jax.random.split(k1)
    bf = 1 + jax.random.uniform(kb, (repeat, 1, 1, 1), minval=-0.1, maxval=0.1)
    cf = 1 + jax.random.uniform(kc, (repeat, 1, 1, 1), minval=-0.1, maxval=0.1)
    noise = jax.random.normal(k2, (repeat, size, size, 3))
    shifts = jax.random.randint(k3, (repeat, 2), -max(1, size // 28), max(1, size // 28) + 1)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    return {"color": (t(bf), t(cf)), "noise": t(noise), "shifts": t(shifts)}


def test_feature_viz_steps_match_jax(models):
    from openvision_tpu.tools import feature_viz as jfv
    from openvision_tpu_torch.tools import feature_viz as tfv

    jm, tm = models
    layer, feature = 1, 5
    jstep, jopt = jfv.build_step(jm, layer, feature)
    tstep, topt = tfv.build_step(tm, layer, feature)
    image = np.asarray(jfv.new_init(jax.random.PRNGKey(0), RES))
    jimg, jstate = jnp.asarray(image), jopt.init(jnp.asarray(image))
    timg = torch.from_numpy(image.copy())
    tstate = topt.init(timg)
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        jimg, jstate, jloss = jstep(jimg, jstate, key)
        timg, tstate, tloss = tstep(timg, tstate, _jax_fv_draws(key, RES, tfv.REPEAT))
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
        assert _rel(timg, jimg) < 1e-4, i
        assert _rel(tstate["nu"], jstate[0].nu) < 1e-4, i


# ---- gradient_ascent ----


def test_gradient_ascent_step_matches_jax(models):
    from openvision_tpu.tools import gradient_ascent as jga
    from openvision_tpu_torch.tools import gradient_ascent as tga

    jm, tm = models
    b, n = 3, jga.N_TOKENS
    jstep, jopt = jga.build_step(jm, jm.context_length, n, pad_id=0)
    tstep, topt = tga.build_step(tm, tm.context_length, n, pad_id=0)
    image = tga.load_normalized(tm, IMG)
    normu0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (b, n, V)))
    jn, jstate = jnp.asarray(normu0), jopt.init(jnp.asarray(normu0))
    tn = torch.from_numpy(normu0.copy())
    tstate = topt.init(tn)
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        jn, jstate, jloss, jper, jtx, jtok = jstep(jn, jstate, jnp.asarray(image.numpy()), key)
        k_gumbel, k_aug = jax.random.split(key)
        k_ang, k_tx, k_ty, k_p = jax.random.split(k_aug, 4)
        max_rad = jnp.deg2rad(10.0)
        t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
        draws = {"noise": t(jax.random.gumbel(k_gumbel, (b, n, V))),
                 "affine": (t(jax.random.uniform(k_ang, (b,), minval=-max_rad, maxval=max_rad)),
                            t(jax.random.uniform(k_tx, (b,), minval=-0.1, maxval=0.1)),
                            t(jax.random.uniform(k_ty, (b,), minval=-0.1, maxval=0.1)),
                            t(jax.random.bernoulli(k_p, 0.8, (b,))))}
        tn, tstate, tloss, tper, ttx, ttok = tstep(tn, tstate, image, draws)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
        assert _rel(tper, jper) < 1e-5 and _rel(ttx, jtx) < 1e-5, i
        np.testing.assert_array_equal(ttok.argmax(-1).numpy(), np.asarray(jtok).argmax(-1))
        assert _rel(ttok, jtok) < 1e-6, i
        assert _rel(tn, jn) < 1e-4, i


def test_gumbel_softmax_hard_is_straight_through():
    from openvision_tpu_torch.tools.gradient_ascent import gumbel_softmax_hard

    logits = torch.randn(2, 3, 50, generator=torch.Generator().manual_seed(0),
                         requires_grad=True)
    y = gumbel_softmax_hard(torch.Generator().manual_seed(1), logits, 1000.0)
    assert torch.allclose(y.sum(-1), torch.ones(2, 3)) and ((y > 0.5).sum(-1) == 1).all()
    w = torch.randn(2, 3, 50, generator=torch.Generator().manual_seed(2))
    (y * w).sum().backward()
    assert logits.grad.abs().max() > 0  # the softmax's gradient, not the argmax's zero


# ---- adversarial ----


def _adv_inputs(jm, tm):
    from openvision_tpu.tools import adversarial as jadv
    from openvision_tpu_torch.tools import adversarial as tadv

    labels = ["a cat", "a dog", "text"]
    jz = jm.encode_text(jnp.asarray(jm.tokenize(labels)))
    tz = tm.encode_text(tm.tokenize(labels))
    assert _rel(tz, jz) < 1e-5
    img = tadv._load_image01(tm, IMG)
    np.testing.assert_array_equal(img, jadv._load_image01(jm, IMG))
    return jadv, tadv, jz, tz, img


def test_adv_matches_jax(models):
    jm, tm = models
    jadv, tadv, jz, tz, img = _adv_inputs(jm, tm)
    want = jadv.adv(jm, jnp.asarray(img), jz, 1, eps=8 / 255, lr=0.1, iters=3)
    got = tadv.adv(tm, img, tz, 1, eps=8 / 255, lr=0.1, iters=3)
    assert _rel(got, want) < 1e-5
    np.testing.assert_allclose(tadv.classify(tm, got, tz), jadv.classify(jm, want, jz),
                               atol=1e-5)


@pytest.mark.parametrize("targeted", [False, True])
def test_pgd_matches_jax(models, targeted):
    jm, tm = models
    jadv, tadv, jz, tz, img = _adv_inputs(jm, tm)
    probs0 = tadv.classify(tm, img, tz)
    label = int(probs0.argmin() if targeted else probs0.argmax())

    def jloss(x):
        return jadv._zero_shot_loss(jm.vision.apply, jm.params["img"], x, jnp.asarray(jm.mean),
                                    jnp.asarray(jm.std), jz, jm.logit_scale, label)

    g_want = jax.grad(jloss)(jnp.asarray(img))
    x = torch.from_numpy(img.copy()).requires_grad_(True)
    mean, std = torch.tensor(tm.mean), torch.tensor(tm.std)
    loss = tadv._zero_shot_loss(tm.vision, x, mean, std, tz.clone(), tm.logit_scale, label)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss(jnp.asarray(img)))) <= 1e-5 * abs(float(loss.detach()))
    assert _rel(x.grad, g_want) < 1e-4

    eps = 8 / 255
    out = tadv.pgd(tm, img, tz, label, eps=eps, iters=5, targeted=targeted)
    assert float((out - torch.from_numpy(img)).abs().max()) <= eps + 1e-6
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    probs1 = tadv.classify(tm, out, tz)
    if targeted:  # towards the target
        assert probs1[label] >= probs0[label]
    else:  # away from the prediction
        assert probs1[label] <= probs0[label] + 1e-6

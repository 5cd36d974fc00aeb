"""The per-image augmentation pp ops (``data/ops_aug.py``:
``randaug``, ``color_jitter``, ``random_erasing``, ``three_aug``,
``color_jitter_timm``) and ``autoaugment`` (``data/ops_autoaugment.py``,
both policies, the ``increase`` levels) against the JAX package's ops of
the same pp names: the same uint8 image and the same
``np.random.Generator`` state must give the same bytes, and leave the
generator in the same state, over a sweep of seeds (every RandAugment and
AutoAugment op is reached). Without Pillow an op raises an ImportError
naming it.
"""

import builtins

import numpy as np
import pytest

from openvision_tpu.data import pp as jpp
from openvision_tpu_torch.data import ops_autoaugment
from openvision_tpu_torch.data import pp as tpp

SPECS = ["randaug(2, 10)", "randaug(3, 7, increase=False)", "randaug(2, 9, timm=True)",
         "color_jitter(0.4)", "color_jitter([0.0, 0.3, 0.2])", "random_erasing(probability=1.0)",
         "random_erasing()", "three_aug()", "color_jitter_timm(0.3)", "autoaugment()",
         "autoaugment('test')", "autoaugment(increase=True)"]
SEEDS = range(24)


def _image(seed):
    rng = np.random.default_rng(1000 + seed)
    h, w = 24 + seed % 5, 32 - seed % 3
    ramp = np.linspace(0, 255, w)[None, :, None] * np.ones((h, 1, 3))
    return np.clip(ramp + rng.normal(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pp_factories():
    jpp.import_pp_modules()
    tpp.import_pp_modules()
    return jpp.build_pp_fn, tpp.build_pp_fn


@pytest.mark.parametrize("spec", SPECS)
def test_aug_op_gives_jax_bytes(pp_factories, spec):
    jbuild, tbuild = pp_factories
    jfn, tfn = jbuild(spec), tbuild(spec)
    for seed in SEEDS:
        img = _image(seed)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want = np.asarray(jfn({"image": img.copy()}, rj)["image"])
        got = tfn({"image": img.copy()}, rt)["image"]
        assert got.dtype == want.dtype and got.shape == want.shape, (spec, seed)
        np.testing.assert_array_equal(got, want, err_msg=f"{spec} seed {seed}")
        assert rj.integers(2**62) == rt.integers(2**62), (spec, seed)  # same draws taken


def test_every_op_and_level_of_the_tables_matches(pp_factories):
    """Each op of RandAugment and AutoAugment at levels 0..10, both level
    mappings, through ``level_args`` and ``apply_op`` of both packages."""
    from openvision_tpu.data import ops_autoaugment as jaa

    assert ops_autoaugment.POLICIES == jaa.POLICIES
    assert ops_autoaugment.RANDAUG_OPS == jaa.RANDAUG_OPS
    img = _image(3)
    for name in ops_autoaugment.RANDAUG_OPS + ["Cutout"]:
        for level in range(11):
            for increase in (False, True):
                rj, rt = np.random.default_rng(level), np.random.default_rng(level)
                kw = dict(increase=increase, cutout_const=40, translate_const=100)
                aj = jaa.level_args(name, level, rj, **kw)
                at = ops_autoaugment.level_args(name, level, rt, **kw)
                assert aj == at, (name, level)
                want = jaa.apply_op(name, img, aj, rj)
                got = ops_autoaugment.apply_op(name, img, at, rt)
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {level}")


def test_without_pillow_the_ops_name_it(pp_factories, monkeypatch):
    real = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    monkeypatch.setattr(ops_autoaugment.importlib, "import_module",
                        lambda name: no_pil(name))
    fn = pp_factories[1]("color_jitter(0.4)")
    with pytest.raises(ImportError, match="need Pillow"):
        fn({"image": _image(0)}, np.random.default_rng(0))
    out = pp_factories[1]("random_erasing(probability=1.0)")({"image": _image(0)},
                                                          np.random.default_rng(0))
    assert out["image"].shape == _image(0).shape  # needs no Pillow

"""The port's image ops and stages against the JAX package's.

Every op of ``ops/image_ops.py`` and a chain of all of them run on the same
numpy uint8 NHWC batches through ``mmlspark_tpu.ops.image_ops.
apply_op_chain`` and the port's ``apply_op_chain(..., device="cpu")``.

Tolerances: the float32 ops within 1e-3 absolute on the 0..255 scale
(the resize is antialiased on both sides when it shrinks, and agrees
within ~3e-4; everything else within float rounding). The stages round
to uint8 (``rint``, clip): within 1 count; UnrollImage exactly.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.core.schema import make_image_row as jax_image_row
from mmlspark_tpu.core.utils import object_column
from mmlspark_tpu.ops import image_ops as jax_ops
from mmlspark_tpu.ops import image_stages as jax_stages
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core.schema import (image_to_array, is_image_column,
                                            make_image_row)
from mmlspark_tpu_torch.core.serialize import load_stage
from mmlspark_tpu_torch.ops import image_ops
from mmlspark_tpu_torch.ops.image_stages import (ImageSetAugmenter,
                                                 ImageTransformer, UnrollImage)

TOL = 1e-3

OPS = {
    "resize_down": {"op": "resize", "height": 20, "width": 50},
    "resize_down_both": {"op": "resize", "height": 17, "width": 13},
    "resize_up": {"op": "resize", "height": 64, "width": 80},
    "crop": {"op": "crop", "x": 3, "y": 5, "height": 20, "width": 11},
    "flip_ud": {"op": "flip", "flipCode": 0},
    "flip_lr": {"op": "flip", "flipCode": 1},
    "flip_both": {"op": "flip", "flipCode": -1},
    "bgr2rgb": {"op": "colorformat", "format": "BGR2RGB"},
    "bgr2gray": {"op": "colorformat", "format": "BGR2GRAY"},
    "rgb2gray": {"op": "colorformat", "format": "RGB2GRAY"},
    "blur_odd": {"op": "blur", "height": 3, "width": 5},
    "blur_even": {"op": "blur", "height": 4, "width": 2},
    "gaussian": {"op": "gaussiankernel", "appertureSize": 5, "sigma": 1.5},
    "gaussian_even_auto_sigma": {"op": "gaussiankernel", "appertureSize": 4,
                                 "sigma": 0.0},
    **{f"threshold_{t}": {"op": "threshold", "threshold": 127.5,
                          "maxVal": 200.0, "type": t}
       for t in ("binary", "binary_inv", "trunc", "tozero", "tozero_inv")},
}

CHAIN = [OPS["resize_up"], OPS["crop"], OPS["flip_both"], OPS["bgr2rgb"],
         OPS["blur_odd"], OPS["gaussian"], OPS["resize_down_both"],
         OPS["threshold_trunc"], OPS["bgr2gray"],
         {"op": "colorformat", "format": "GRAY2BGR"}]


def _batch(shape=(3, 37, 29, 3), seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape) \
        .astype(np.uint8)


def _check(ops, batch):
    want = jax_ops.apply_op_chain(batch, ops)
    got = image_ops.apply_op_chain(batch, ops, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name):
    _check([OPS[name]], _batch())


@pytest.mark.parametrize("shape,size", [((2, 256, 256, 3), (224, 224)),
                                        ((2, 32, 32, 3), (224, 224)),
                                        ((2, 64, 48, 3), (17, 13))])
def test_resize_shapes_match_jax(shape, size):
    """The ImageFeaturizer's 256 -> 224 and a CIFAR image up to 224."""
    _check([{"op": "resize", "height": size[0], "width": size[1]}],
           _batch(shape, seed=1))


@pytest.mark.parametrize("op", [{"op": "blur", "height": 5, "width": 5},
                                {"op": "gaussiankernel", "appertureSize": 7,
                                 "sigma": 2.0}])
def test_filters_on_images_smaller_than_the_pad_match_jax(op):
    """reflect-101 needs the pad inside the image: a 2 x 3 image takes the
    edge-padding branch on both sides."""
    _check([op], _batch((2, 2, 3, 3), seed=2))


def test_gray_to_bgr_and_unroll_match_jax():
    gray = _batch((2, 9, 7, 1), seed=3)
    _check([{"op": "colorformat", "format": "GRAY2BGR"}], gray)
    import jax.numpy as jnp
    b = _batch(seed=4).astype(np.float32)
    np.testing.assert_array_equal(
        image_ops.unroll(torch.from_numpy(b)).numpy(),
        np.asarray(jax_ops.unroll(jnp.asarray(b))))


def test_chain_of_every_op_matches_jax():
    _check(CHAIN, _batch((4, 40, 36, 3), seed=5))


def test_bad_arguments_raise_like_jax():
    b = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError, match="exceeds image bounds"):
        image_ops.crop(b, 4, 4, 5, 5)
    with pytest.raises(ValueError, match="flipCode"):
        image_ops.flip(b, 2)
    with pytest.raises(ValueError, match="color conversion"):
        image_ops.color_format(b, "BGR2HSV")
    with pytest.raises(ValueError, match="threshold type"):
        image_ops.threshold(b, 1.0, 2.0, "otsu")
    np.testing.assert_array_equal(image_ops.gaussian_kernel_1d(5, 0.0),
                                  jax_ops.gaussian_kernel_1d(5, 0.0))


# ------------------------------------------------------------------ stages

def _frames(n=5, seed=6):
    """Image rows of two shapes (two buckets), in both packages' frames."""
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, size=(20, 24, 3) if i % 2 else (17, 15, 3))
            .astype(np.uint8) for i in range(n)]
    rows = object_column([make_image_row(f"p{i}", *im.shape, im)
                          for i, im in enumerate(imgs)])
    jrows = object_column([jax_image_row(f"p{i}", *im.shape, im)
                           for i, im in enumerate(imgs)])
    return DataFrame({"image": rows}), JaxDataFrame({"image": jrows})


def _arrays(df, col):
    return [image_to_array(r) for r in df.col(col)]


def _build(cls, ops=()):
    t = cls().setInputCol("image").setOutputCol("out")
    for name, args in ops:
        t = getattr(t, name)(*args)
    return t


STAGE_OPS = [("resize", (16, 12)), ("flip", (1,)), ("blur", (3, 3)),
             ("gaussianKernel", (3, 1.0)), ("threshold", (100.0, 250.0,
                                                          "trunc")),
             ("crop", (1, 2, 10, 8)), ("colorFormat", ("RGB2BGR",))]


def test_image_transformer_matches_jax_within_one_count():
    df, jdf = _frames()
    got = _build(ImageTransformer, STAGE_OPS).setDevice("cpu").transform(df)
    want = _build(jax_stages.ImageTransformer, STAGE_OPS).transform(jdf)
    assert is_image_column(got, "out")
    for a, b in zip(_arrays(got, "out"), _arrays(want, "out")):
        assert a.shape == b.shape == (10, 8, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert [r["path"] for r in got.col("out")] == \
        [f"p{i}" for i in range(5)]


def test_unroll_image_matches_jax():
    df, jdf = _frames()
    got = UnrollImage().setInputCol("image").transform(df).col("unrolled")
    want = jax_stages.UnrollImage().setInputCol("image").transform(jdf) \
        .col("unrolled")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_image_set_augmenter_matches_jax():
    df, jdf = _frames()
    got = ImageSetAugmenter(flipUpDown=True, device="cpu").transform(df)
    want = jax_stages.ImageSetAugmenter(flipUpDown=True).transform(jdf)
    assert got.count() == want.count() == 15
    for a, b in zip(_arrays(got, "image"), _arrays(want, "image")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stage", [
    lambda: _build(ImageTransformer, STAGE_OPS).setDevice("cpu"),
    lambda: UnrollImage().setInputCol("image").setOutputCol("out"),
    lambda: ImageSetAugmenter(flipUpDown=True, device="cpu",
                              outputCol="out")])
def test_stages_round_trip_save_load(tmp_path, stage):
    s = stage()
    s.save(str(tmp_path / "stage"))
    back = load_stage(str(tmp_path / "stage"))
    assert type(back) is type(s)
    df, _ = _frames(3)
    a, b = s.transform(df), back.transform(df)
    for x, y in zip(a.col("out"), b.col("out")):
        if isinstance(x, dict):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    df, _ = _frames(2)
    t = _build(ImageTransformer, [("flip", (0,))])
    assert t.getDevice() == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t.transform(df)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        image_ops.apply_op_chain(_batch(), [OPS["flip_lr"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageSetAugmenter().transform(df)

"""The port's io layer (``mmlspark_tpu_torch.io``) against the JAX package's
(``mmlspark_tpu.io``) on the same files.

* The binary, image and Arrow cases of tests/test_io.py: recursive and
  flat reads, seeded sampling (the same paths in both packages), zip
  entries, ImageSchema rows equal to the JAX package's bit for bit,
  ``batch_to_matrix`` equal to ``np.stack`` and to the JAX package's,
  staging-buffer bounds, ``DataFrame.fromArrowStream`` of a table and of
  an IPC file equal to the JAX package's frame, ``arrow_frames``, and
  fitStream fed by ``arrow_feature_batches(device="cpu")``.
* ``write_images`` -> ``read_images`` round trips for PNG, BMP and PPM,
  which the port encodes by hand: the pixels come back bit for bit in
  both packages (and through cv2), gray and 4-channel rows as BGR.
* ``device_image_batches(device="cpu")`` gives the JAX package's
  batches.
"""

import os
import zipfile

import cv2
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.io import (device_image_batches as jax_device_batches,
                             read_binary_files as jax_read_binary_files,
                             read_images as jax_read_images)
from mmlspark_tpu_torch import DataFrame, TorchLearner
from mmlspark_tpu_torch.core.schema import (image_to_array, is_image_column,
                                            make_image_row, tag_image_column)
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.io import (device_image_batches, list_images,
                                   read_binary_files, read_images,
                                   readBinaryFiles, readImages, write_images)
from mmlspark_tpu_torch.io.image import decode_image


@pytest.fixture(scope="module")
def media_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    for i in range(4):
        img = rng.integers(0, 255, (10 + i, 12, 3), dtype=np.uint8)
        cv2.imwrite(str(d / f"img{i}.png"), img)
    (d / "notes.txt").write_bytes(b"hello world")
    sub = d / "sub"
    sub.mkdir()
    cv2.imwrite(str(sub / "nested.png"),
                rng.integers(0, 255, (8, 8, 3), dtype=np.uint8))
    with zipfile.ZipFile(d / "arch.zip", "w") as zf:
        zf.writestr("inner.txt", b"zipped")
    return str(d)


def _paths(df):
    return [str(p) for p in df.col("path")]


class TestBinary:
    def test_read_recursive(self, media_dir):
        df = read_binary_files(media_dir)
        paths = _paths(df)
        assert any("nested.png" in p for p in paths)
        assert any("arch.zip::inner.txt" in p for p in paths)
        row = [r for r in df.iterRows() if "notes.txt" in str(r["path"])][0]
        assert row["bytes"] == b"hello world"
        jdf = jax_read_binary_files(media_dir)
        assert paths == _paths(jdf)
        assert list(df.col("bytes")) == list(jdf.col("bytes"))
        assert readBinaryFiles is read_binary_files

    def test_non_recursive(self, media_dir):
        df = read_binary_files(media_dir, recursive=False)
        assert not any("nested" in p for p in _paths(df))
        assert _paths(df) == _paths(jax_read_binary_files(media_dir,
                                                          recursive=False))

    @pytest.mark.parametrize("ratio", [0.05, 0.5])
    def test_sampling_deterministic(self, media_dir, ratio):
        a = read_binary_files(media_dir, sample_ratio=ratio, seed=7)
        assert _paths(a) == _paths(read_binary_files(
            media_dir, sample_ratio=ratio, seed=7))
        assert _paths(a) == _paths(jax_read_binary_files(
            media_dir, sample_ratio=ratio, seed=7))
        full = read_binary_files(media_dir)
        assert set(_paths(a)) <= set(_paths(full))
        if ratio < 0.1:
            assert a.count() < full.count()

    def test_zip_entries_sampled_not_archives(self, media_dir):
        full = read_binary_files(media_dir, sample_ratio=1.0)
        assert [p for p in _paths(full) if "::" in p]


class TestImages:
    def test_read_images_schema(self, media_dir):
        df = read_images(media_dir)
        assert df.count() == 5  # 4 + nested, txt/zip skipped
        row = df.col("image")[0]
        assert set(row.keys()) == {"path", "height", "width", "type",
                                   "bytes"}
        assert row["type"] == 3
        assert is_image_column(df, "image")
        jdf = jax_read_images(media_dir)
        assert [r["bytes"] for r in df.col("image")] == \
            [r["bytes"] for r in jdf.col("image")]
        assert readImages is read_images

    @pytest.mark.parametrize("fmt", ["png", "bmp", "ppm"])
    @pytest.mark.parametrize("channels", [3, 1, 4])
    def test_write_read_round_trip(self, tmp_path, fmt, channels):
        rng = np.random.default_rng(channels)
        imgs = [rng.integers(0, 256, (9 + i, 13, channels), dtype=np.uint8)
                for i in range(3)]
        df = tag_image_column(DataFrame({"image": object_column(
            [make_image_row(f"src/im{i}.png", *im.shape, im)
             for i, im in enumerate(imgs)])}), "image")
        written = write_images(df, str(tmp_path), format=fmt)
        assert [os.path.basename(p) for p in written] == \
            [f"im{i}.{fmt}" for i in range(3)]
        back = read_images(str(tmp_path))
        jback = jax_read_images(str(tmp_path))
        for i, im in enumerate(imgs):
            want = (np.repeat(im, 3, axis=2) if channels == 1
                    else im[:, :, :3])
            assert np.array_equal(image_to_array(back.col("image")[i]), want)
            assert np.array_equal(image_to_array(jback.col("image")[i]),
                                  want)
            assert np.array_equal(cv2.imread(written[i], cv2.IMREAD_COLOR),
                                  want)

    def test_write_never_clobbers(self, media_dir, tmp_path):
        df = read_images(media_dir).limit(2)
        first = write_images(df, str(tmp_path / "out"))
        second = write_images(df, str(tmp_path / "out"))
        assert len(set(first + second)) == 4

    def test_undecodable_rows(self, tmp_path):
        (tmp_path / "bad.png").write_bytes(b"\x89PNG not really")
        (tmp_path / "bad.gif").write_bytes(b"GIF89a not really")
        assert read_images(str(tmp_path)).count() == 0
        kept = read_images(str(tmp_path), drop_invalid=False)
        assert kept.count() == 2 and list(kept.col("image")) == [None, None]

    def test_tiff_goes_through_cv2(self, tmp_path):
        img = np.random.default_rng(1).integers(0, 256, (6, 7, 3),
                                                dtype=np.uint8)
        ok, enc = cv2.imencode(".tiff", img)
        row = decode_image("x.tiff", enc.tobytes())
        assert np.array_equal(image_to_array(row), img)

    def test_feeds_image_transformer(self, media_dir):
        from mmlspark_tpu_torch.ops import ImageTransformer
        out = (ImageTransformer(device="cpu").setInputCol("image")
               .setOutputCol("s").resize(6, 6)
               .transform(read_images(media_dir)))
        assert all(r["height"] == 6 for r in out.col("s"))


def test_device_image_batches_match_the_jax_package(media_dir):
    paths = list_images(media_dir)
    ours = [(d.numpy(), ok, n) for d, ok, n in device_image_batches(
        paths, batch=2, height=9, width=9, device="cpu")]
    theirs = [(np.asarray(d), ok, n) for d, ok, n in jax_device_batches(
        paths, batch=2, height=9, width=9)]
    assert len(ours) == len(theirs) == 3
    for (a, oka, na), (b, okb, nb) in zip(ours, theirs):
        assert na == nb and np.array_equal(oka, okb)
        assert np.array_equal(a, b)


# --------------------------------------------------------------------- arrow

class TestArrowBridge:
    @pytest.fixture(autouse=True)
    def _needs_pyarrow(self):
        pytest.importorskip("pyarrow")

    def _table(self, n=1000, d=6, seed=0):
        import pyarrow as pa
        rng = np.random.default_rng(seed)
        cols = {f"x{j}": rng.normal(size=n).astype(np.float32)
                for j in range(d)}
        cols["label"] = rng.integers(0, 2, n).astype(np.int64)
        return pa.table(cols)

    def test_batch_to_matrix_matches_stack(self):
        from mmlspark_tpu.io.arrow import batch_to_matrix as jax_b2m
        from mmlspark_tpu_torch import native
        from mmlspark_tpu_torch.io.arrow import batch_to_matrix
        cols = [f"x{j}" for j in range(6)]
        before = native.calls.get("interleave", 0)
        for batch in self._table().to_batches(max_chunksize=256):
            got = batch_to_matrix(batch, cols)
            exp = np.stack([batch.column(j).to_numpy() for j in range(6)],
                           axis=1)
            np.testing.assert_array_equal(got, exp)
            np.testing.assert_array_equal(got, jax_b2m(batch, cols))
        assert native.calls["interleave"] == before + 4

    def test_staging_buffer_reuse_and_bounds(self):
        from mmlspark_tpu_torch.io.arrow import batch_to_matrix
        cols = [f"x{j}" for j in range(6)]
        b = self._table(n=300).to_batches()[0]
        buf = np.empty((512, 6), np.float32)
        out = batch_to_matrix(b, cols, out=buf)
        assert out.base is buf and out.shape == (300, 6)
        with pytest.raises(ValueError, match="too small"):
            batch_to_matrix(b, cols, out=np.empty((10, 6), np.float32))
        with pytest.raises(KeyError, match="nope"):
            batch_to_matrix(b, ["nope"])

    def test_from_arrow_stream_frame(self, tmp_path):
        import pyarrow as pa
        from mmlspark_tpu_torch.io import arrow_frames
        t = self._table(n=500)
        df = DataFrame.fromArrowStream(t)
        assert df.count() == 500
        assert set(df.columns) == {f"x{j}" for j in range(6)} | {"label"}
        path = str(tmp_path / "t.arrow")
        with pa.OSFile(path, "wb") as f:
            with pa.ipc.new_file(f, t.schema) as w:
                for b in t.to_batches(max_chunksize=128):
                    w.write_batch(b)
        df2 = DataFrame.fromArrowStream(path)
        jdf = JaxDataFrame.fromArrowStream(path)
        assert df2.count() == 500 and df2.columns == jdf.columns
        for c in df2.columns:
            np.testing.assert_array_equal(df2.col(c), jdf.col(c))
            np.testing.assert_array_equal(df2.col(c), df.col(c))
        frames = list(arrow_frames(path))
        assert [f.count() for f in frames] == [128, 128, 128, 116]
        assert DataFrame.fromArrowStream([]).count() == 0

    def test_fitstream_from_arrow(self):
        """Arrow record batches feed training without a row conversion."""
        import pyarrow as pa
        from mmlspark_tpu_torch.io.arrow import arrow_feature_batches
        rng = np.random.default_rng(3)
        n = 1024
        y = rng.integers(0, 2, n)
        x = (rng.normal(size=(n, 6)) + y[:, None] * 2).astype(np.float32)
        t = pa.table({**{f"x{j}": x[:, j] for j in range(6)},
                      "label": y.astype(np.int64)})
        feats = [f"x{j}" for j in range(6)]
        batches = list(arrow_feature_batches(
            t.to_batches(max_chunksize=256), feats, "label", device="cpu"))
        assert [tuple(b[0].shape) for b in batches] == [(256, 6)] * 4
        np.testing.assert_array_equal(
            torch.cat([b[0] for b in batches]).numpy(), x)
        with pytest.raises(ValueError, match="max_batch_rows"):
            list(arrow_feature_batches(t, feats, "label", max_batch_rows=10,
                                       device="cpu"))
        model = TorchLearner(modelConfig={"type": "mlp", "hidden": [16],
                                          "num_classes": 2},
                             epochs=3, learningRate=0.05, device="cpu") \
            .fitStream(lambda: arrow_feature_batches(
                t.to_batches(max_chunksize=256), feats, "label",
                device="cpu"))
        assert np.isfinite(model._final_loss)
        df = DataFrame({"features": object_column([r for r in x])})
        preds = np.stack(list(model.transform(df).col("scores"))).argmax(1)
        assert (preds == y).mean() > 0.95

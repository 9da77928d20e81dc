"""The port's native runtime (``mmlspark_tpu_torch.native``, its own copy of
the C++ sources, built with g++ into ``mmlspark_tpu_torch/_build/native``)
against the JAX package's (``mmlspark_tpu.native``) on the same bytes.

* The cases of tests/test_native.py: decode (PNG, BMP, PPM bit for bit;
  JPEG equal to the JAX package's decode, which links the same libjpeg,
  and within 1 count of cv2), resize (bit for bit against the JAX
  package's, within 1 count of cv2), the batch loader's order, counts,
  mask, zero fill, content and cv2 patch for TIFF, the device feed
  (``device="cpu"``) not aliasing its staging buffer, the CSV parser
  (bit for bit against the JAX package's parse), ``interleave_f32``
  against ``np.stack`` and ``bin_data_native`` against the JAX package's.
* The build: two processes building at once into one directory yield one
  library and no temporary file; a build without the optional decoders
  reports BMP and PPM only and raises ValueError naming PNG or JPEG, from
  ``decode_image`` and from the batch loader; a source that does not
  compile raises with the compiler's message; ``MMLSPARK_TPU_NO_NATIVE=1``
  is the only way to the pure-Python fallbacks.
"""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mmlspark_tpu import native as jax_native
from mmlspark_tpu.io import read_csv_matrix as jax_read_csv_matrix
from mmlspark_tpu_torch import native
from mmlspark_tpu_torch.io import (device_image_batches, image_batches,
                                   list_images, read_csv, read_csv_matrix)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


def _enc(ext, img, *params):
    ok, enc = cv2.imencode(ext, img, list(params))
    assert ok
    return enc.tobytes()


class TestDecode:
    @pytest.mark.parametrize("ext,shape", [(".png", (33, 47, 3)),
                                           (".bmp", (21, 17, 3))])
    def test_lossless_bit_exact(self, rng, ext, shape):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        data = _enc(ext, img)
        out = native.decode_image(data)
        assert np.array_equal(out, img)
        assert np.array_equal(out, jax_native.decode_image(data))

    def test_jpeg_matches_the_jax_package_and_cv2(self, rng):
        img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        data = _enc(".jpg", img, cv2.IMWRITE_JPEG_QUALITY, 90)
        ours = native.decode_image(data)
        assert np.array_equal(ours, jax_native.decode_image(data))
        theirs = cv2.imdecode(np.frombuffer(data, np.uint8),
                              cv2.IMREAD_COLOR)
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1

    def test_ppm(self, rng):
        img = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
        raw = b"P6\n# comment\n11 9\n255\n" + img[:, :, ::-1].tobytes()
        assert np.array_equal(native.decode_image(raw), img)
        assert np.array_equal(jax_native.decode_image(raw), img)

    def test_grayscale_jpeg_upconverts(self, rng):
        gray = rng.integers(0, 256, (20, 20), dtype=np.uint8)
        out = native.decode_image(_enc(".jpg", gray))
        assert out.shape == (20, 20, 3)

    @pytest.mark.parametrize("data", [b"not an image at all....", b"",
                                      b"\x89PNGgarbage-but-long-enough"])
    def test_undecodable_returns_none(self, data):
        assert native.decode_image(data) is None
        assert jax_native.decode_image(data) is None

    def test_truncated_png_returns_none(self, rng):
        img = rng.integers(0, 256, (30, 30, 3), dtype=np.uint8)
        assert native.decode_image(_enc(".png", img)[:40]) is None

    def test_formats_of_this_build(self):
        """BMP and PPM always; JPEG and PNG exactly where the compiler
        finds their headers."""
        got = set(native.formats())
        assert {"bmp", "ppm"} <= got
        assert got - {"bmp", "ppm"} == native._headers_found(native._cxx())


class TestResize:
    def test_matches_the_jax_package_and_cv2(self, rng):
        img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
        ours = native.resize_bilinear(img, 24, 31)
        assert np.array_equal(ours, jax_native.resize_bilinear(img, 24, 31))
        theirs = cv2.resize(img, (31, 24), interpolation=cv2.INTER_LINEAR)
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1

    def test_identity(self, rng):
        img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        assert np.array_equal(native.resize_bilinear(img, 16, 16), img)

    def test_upscale_shape(self, rng):
        img = rng.integers(0, 256, (8, 8, 1), dtype=np.uint8)
        assert native.resize_bilinear(img, 32, 24).shape == (32, 24, 1)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    r = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("imgs")
    for i in range(10):
        img = r.integers(0, 256, (20 + i, 30 - i, 3), dtype=np.uint8)
        cv2.imwrite(str(d / f"img{i:02d}.png"), img)
    (d / "broken.png").write_bytes(b"\x89PNGgarbage")
    return str(d)


def _jax_batches(paths, batch, h, w, **kw):
    from mmlspark_tpu.io import image_batches as jax_image_batches
    return [(b.copy(), ok.copy(), n)
            for b, ok, n in jax_image_batches(paths, batch, h, w, **kw)]


class TestBatchLoader:
    def test_order_counts_and_mask(self, image_dir):
        paths = list_images(image_dir)
        assert len(paths) == 11  # 10 good + 1 broken
        ours = [(b.copy(), ok.copy(), n) for b, ok, n in image_batches(
            paths, batch=4, height=16, width=16, threads=3)]
        theirs = _jax_batches(paths, 4, 16, 16, threads=3)
        assert len(ours) == len(theirs) == 3
        seen = ok_total = 0
        for (buf, ok, count), (jbuf, jok, jcount) in zip(ours, theirs):
            assert buf.shape == (4, 16, 16, 3)
            assert not ok[count:].any() and (buf[count:] == 0).all()
            assert count == jcount
            assert np.array_equal(ok, jok) and np.array_equal(buf, jbuf)
            seen += count
            ok_total += int(ok[:count].sum())
        assert seen == 11 and ok_total == 10

    def test_failed_decode_is_zero_filled(self, image_dir):
        paths = [os.path.join(image_dir, "broken.png")]
        [(buf, ok, count)] = list(image_batches(paths, 2, 8, 8))
        assert count == 1 and not ok[0]
        assert (buf[0] == 0).all()

    def test_content_matches_direct_decode(self, image_dir):
        paths = [p for p in list_images(image_dir) if "broken" not in p][:3]
        [(buf, ok, count)] = list(image_batches(paths, batch=3, height=12,
                                                width=12, threads=2))
        for i, p in enumerate(paths):
            want = native.resize_bilinear(cv2.imread(p, cv2.IMREAD_COLOR),
                                          12, 12)
            assert np.array_equal(buf[i], want)

    def test_batches_larger_than_a_work_unit(self, tmp_path):
        """Batches of 300 files take two work units each (256 files a
        unit), the last batch is partial, and a broken file sits inside
        the second unit: the batches equal the JAX package's loader's."""
        r = np.random.default_rng(3)
        paths = []
        for i in range(700):
            p = tmp_path / f"im{i:04d}.ppm"
            img = r.integers(0, 256, (6 + i % 3, 5, 3), dtype=np.uint8)
            p.write_bytes(b"P6\n5 %d\n255\n" % img.shape[0]
                          + img[:, :, ::-1].tobytes())
            paths.append(str(p))
        (tmp_path / "im0290.ppm").write_bytes(b"P6 broken")
        ours = [(b.copy(), ok.copy(), n) for b, ok, n in image_batches(
            paths, batch=300, height=6, width=5, threads=4, prefetch=1)]
        theirs = _jax_batches(paths, 300, 6, 5, threads=4, prefetch=1)
        assert [n for *_, n in ours] == [300, 300, 100]
        for (buf, ok, n), (jbuf, jok, _) in zip(ours, theirs):
            assert np.array_equal(buf, jbuf) and np.array_equal(ok, jok)
        assert not ours[0][1][290] and ours[0][1].sum() == 299
        assert not ours[2][0][100:].any()

    def test_empty_path_list(self):
        assert list(image_batches([], batch=4, height=8, width=8)) == []

    def test_non_native_format_is_patched_in_by_cv2(self, tmp_path, rng):
        img = rng.integers(0, 256, (14, 14, 3), dtype=np.uint8)
        p = str(tmp_path / "pic.tif")
        cv2.imwrite(p, img)
        [(buf, ok, count)] = list(image_batches([p], 2, 14, 14))
        assert count == 1 and ok[0]
        assert np.array_equal(buf[0], img)

    def test_device_feed_batches_do_not_alias_staging(self, image_dir):
        paths = [p for p in list_images(image_dir) if "broken" not in p]
        got = [dev[:count].numpy() for dev, ok, count in
               device_image_batches(paths, batch=2, height=10, width=10,
                                    device="cpu")]
        want = [b[:n] for b, _ok, n in _jax_batches(paths, 2, 10, 10)]
        assert np.array_equal(np.concatenate(got), np.concatenate(want))

    def test_device_feed_transform(self, image_dir):
        paths = list_images(image_dir)
        total = 0
        for dev, ok, count in device_image_batches(
                paths, batch=4, height=16, width=16, device="cpu",
                transform=lambda b: b.astype(np.float32) / 255.0):
            assert isinstance(dev, torch.Tensor)
            assert dev.dtype == torch.float32 and float(dev.max()) <= 1.0
            total += count
        assert total == len(paths)
        assert native.calls.get("loader_batches", 0) > 0


class TestCsv:
    def _both(self, path, **kw):
        ours = read_csv_matrix(str(path), **kw)
        theirs = jax_read_csv_matrix(str(path), **kw)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
        return ours

    def test_parity_with_numpy(self, tmp_path, rng):
        mat = rng.normal(size=(200, 7)).astype(np.float32)
        p = tmp_path / "data.csv"
        np.savetxt(p, mat, delimiter=",", fmt="%.6e")
        out = self._both(p)
        assert out.shape == (200, 7)
        np.testing.assert_allclose(out, mat, rtol=1e-5, atol=1e-30)

    def test_header_sniffing_and_names(self, tmp_path):
        p = tmp_path / "d.csv"
        p.write_text("alpha,beta\n1,2\n3,4\n")
        df = read_csv(str(p))
        assert df.columns == ["alpha", "beta"]
        np.testing.assert_array_equal(df.col("alpha"), [1.0, 3.0])

    def test_no_header(self, tmp_path):
        p = tmp_path / "d.csv"
        p.write_text("1,2\n3,4\n")
        df = read_csv(str(p))
        assert df.columns == ["c0", "c1"] and len(df) == 2

    @pytest.mark.parametrize("text,delim,want", [
        (b"1,,x\n4,5,6\n", ",", [[1, np.nan, np.nan], [4, 5, 6]]),
        (b"-1.5e-3,2.25E2\n", ",", [[-0.0015, 225.0]]),
        (b"1,2\r\n\r\n3,4\r\n", ",", [[1, 2], [3, 4]]),
        (b"1\t2\n3\t4\n", "\t", [[1, 2], [3, 4]]),
        (b"1\n2\n3\n", ",", [[1], [2], [3]])])
    def test_fields(self, tmp_path, text, delim, want):
        p = tmp_path / "d.csv"
        p.write_bytes(text)
        m = self._both(p, delim=delim)
        np.testing.assert_allclose(m, np.array(want, np.float32), rtol=1e-6)

    def test_single_column_fallback_path(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MMLSPARK_TPU_NO_NATIVE", "1")
        assert native.get_lib() is None and native.read_csv("x") is None
        p = tmp_path / "one.csv"
        p.write_text("v\n1\n2\n3\n")
        df = read_csv(str(p))
        assert df.columns == ["v"] and len(df) == 3

    def test_large_parallel_chunking(self, tmp_path, rng):
        mat = rng.integers(0, 1000, size=(5000, 3)).astype(np.float32)
        p = tmp_path / "big.csv"
        np.savetxt(p, mat, delimiter=",", fmt="%.1f")
        before = native.calls.get("csv", 0)
        out = self._both(p, threads=4)
        np.testing.assert_array_equal(out, mat)
        assert native.calls["csv"] == before + 1


def test_interleave_f32_matches_stack(rng):
    cols = [rng.normal(size=1000).astype(np.float32) for _ in range(7)]
    out = np.empty((1000, 7), np.float32)
    assert native.interleave_f32(cols, out, threads=3)
    np.testing.assert_array_equal(out, np.stack(cols, axis=1))
    with pytest.raises(TypeError):
        native.interleave_f32([c.astype(np.float64) for c in cols], out)


def test_bin_data_matches_the_jax_package(rng):
    x = rng.normal(size=(500, 5)).astype(np.float32)
    x[::7, 1] = np.nan
    x[:, 4] = rng.integers(0, 300, 500)
    edges = np.sort(rng.normal(size=(5, 31)).astype(np.float32), axis=1)
    cat = np.array([0, 0, 0, 0, 1], np.uint8)
    ours = native.bin_data_native(x, edges, cat, max_bin=256, threads=2)
    np.testing.assert_array_equal(
        ours, jax_native.bin_data_native(x, edges, cat, max_bin=256,
                                         threads=2))
    np.testing.assert_array_equal(
        ours[:, 0], np.searchsorted(edges[0], x[:, 0], side="left"))


# ------------------------------------------------------------------ build

def test_concurrent_builds_yield_one_library(tmp_path):
    code = ("import sys; from mmlspark_tpu_torch import native; "
            "print(native.build(build_dir=sys.argv[1]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    [so] = {o.strip() for o, _e in outs}
    assert sorted(f.name for f in tmp_path.iterdir()) == \
        sorted([Path(so).name, "lock"])
    assert "bmp" in native.formats(native.load(so))


@pytest.fixture(scope="module")
def bmp_ppm_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_build")
    return native.load(native.build(exclude=("jpeg", "png"), build_dir=d))


def test_unbuilt_format_raises(bmp_ppm_lib, rng):
    assert native.formats(bmp_ppm_lib) == ("bmp", "ppm")
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    for ext, name in ((".png", "PNG"), (".jpg", "JPEG")):
        with pytest.raises(ValueError, match=name):
            native.decode_image(_enc(ext, img), bmp_ppm_lib)
    assert np.array_equal(native.decode_image(_enc(".bmp", img),
                                              bmp_ppm_lib), img)
    assert native.decode_image(b"not an image at all", bmp_ppm_lib) is None


def test_loader_raises_on_an_unbuilt_format(bmp_ppm_lib, tmp_path,
                                            monkeypatch, rng):
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    (tmp_path / "a.bmp").write_bytes(_enc(".bmp", img))
    (tmp_path / "b.png").write_bytes(_enc(".png", img))
    monkeypatch.setattr(native, "_lib", bmp_ppm_lib)
    [(buf, ok, n)] = list(image_batches([str(tmp_path / "a.bmp")], 2, 8, 8))
    assert ok[0] and np.array_equal(buf[0], img)
    with pytest.raises(ValueError, match=r"b\.png: PNG"):
        list(image_batches([str(tmp_path / "a.bmp"),
                            str(tmp_path / "b.png")], 2, 8, 8))


def test_failed_build_raises_with_the_compiler_message(tmp_path,
                                                       monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cc").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "CSRC", src)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build(build_dir=tmp_path / "out")
    assert not any((tmp_path / "out").glob("*.so"))


def test_library_name_follows_sources_and_flags():
    cmd = native.build_command()
    assert native.library_path(cmd) == native.library_path(list(cmd))
    assert native.library_path(cmd) != native.library_path(
        cmd + ["-DMMLTPU_NO_PNG"])
    assert native.library_path(cmd).parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-3:] == ("mmlspark_tpu_torch", "_build",
                                           "native")

"""The model zoo's packed artifacts, the downloader, weight import and the
ImageFeaturizer in the port, against the JAX package.

* ``unpack_model`` of every ``zoo/*.model`` equals flax's
  ``msgpack_restore`` bit for bit, and ``write_flax_msgpack`` gives flax's
  bytes back; a port ``pack_model`` is read by the JAX package.
* ``ResNet20_shapes10`` scores shapes10's held-out images with
  ``TpuModel``'s argmax (bf16, the artifact's config) and within 1e-4 of
  its scores in float32.
* ``ImageFeaturizer`` on ``ResNet26b_digits8`` at cut 0, 1 and 3, float32,
  against the JAX featurizer on random 40 x 36 images: within 1e-3 of
  max(1, max |jax|) (the resize to 32 x 32 rounds to uint8 on both sides,
  and a pixel within float rounding of a half count may land one count
  apart).
* ``import_resnet50`` of a tiny torchvision-layout net built here with
  ``torch.nn`` against that net's eval forward (2e-4, as
  tests/test_import_weights.py holds the JAX import) and against the JAX
  import's tree (1e-6).
* The port's datagen copies equal the JAX package's bit for bit.
"""

import glob
import os
import shutil
import zipfile

import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.core.schema import make_image_row as jax_image_row
from mmlspark_tpu.core.utils import object_column
from mmlspark_tpu.models import downloader as jax_downloader
from mmlspark_tpu.models import import_weights as jax_import
from mmlspark_tpu.models.image_featurizer import \
    ImageFeaturizer as JaxImageFeaturizer
from mmlspark_tpu.models.tpu_model import TpuModel
from mmlspark_tpu.testing import datagen as jax_datagen
from mmlspark_tpu_torch import DataFrame, TorchModel
from mmlspark_tpu_torch.core.schema import make_image_row
from mmlspark_tpu_torch.core.serialize import load_stage
from mmlspark_tpu_torch.models import downloader, import_weights
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models.modules import build_model
from mmlspark_tpu_torch.models.weights import from_flax_params
from mmlspark_tpu_torch.testing import datagen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(ROOT, "zoo")
ARTIFACTS = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(ZOO, "*.model")))


def _same_tree(a, b):
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert set(fa) == set(fb)
    for k in fb:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _rows(x, maker):
    return object_column([maker(f"i{i}", *x[i].shape, x[i])
                          for i in range(len(x))])


def test_zoo_holds_five_artifacts():
    assert len(ARTIFACTS) == 5


@pytest.mark.parametrize("name", ARTIFACTS)
def test_unpack_matches_flax_bit_for_bit(name):
    with open(os.path.join(ZOO, name), "rb") as f:
        blob = f.read()
    config, params = downloader.unpack_model(blob)
    raw = zipfile.ZipFile(os.path.join(ZOO, name)).read("params.msgpack")
    _same_tree(params, serialization.msgpack_restore(raw))
    assert downloader.write_flax_msgpack(params) == raw
    jconfig, _ = jax_downloader.unpack_model(blob)
    assert config == jconfig
    sd = from_flax_params(params, config)        # carries into the module
    with torch.device("meta"):
        want = build_model(config).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def test_port_pack_is_read_by_jax_and_back():
    cfg = {"type": "resnet", "blocks_per_stage": 1, "num_classes": 3}
    from mmlspark_tpu_torch.models import trainer
    sd = trainer.init_params(cfg, 4)
    blob = downloader.pack_model(cfg, sd)
    jcfg, jtree = jax_downloader.unpack_model(blob)
    assert jcfg == cfg
    got = from_flax_params(jtree, cfg)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    # and a JAX-packed tree reads back in the port
    blob2 = jax_downloader.pack_model(cfg, jtree)
    _, tree2 = downloader.unpack_model(blob2)
    _same_tree(tree2, jtree)


def test_reader_refuses_what_flax_params_never_hold():
    with pytest.raises(ValueError, match="subset"):
        downloader.read_flax_msgpack(b"\xc1")
    with pytest.raises(ValueError, match="ext type"):
        downloader.read_flax_msgpack(b"\xd4\x05\x00")
    with pytest.raises(ValueError, match="trailing"):
        downloader.read_flax_msgpack(b"\x01\x02")
    with pytest.raises(ValueError, match="not all str"):
        downloader.write_flax_msgpack({1: np.zeros(2)})


# --------------------------------------------------------------- downloader

@pytest.fixture
def local_zoo(tmp_path):
    root = tmp_path / "zoo"
    shutil.copytree(ZOO, root)
    return str(root)


def test_downloader_serves_the_zoo_with_hash_checks(local_zoo):
    d = downloader.ModelDownloader(local_zoo)
    names = {(s.name, s.dataset) for s in d.localModels()}
    assert ("ResNet20", "shapes10") in names and len(names) == 5
    schema = d.downloadByName("ResNet20", "shapes10")
    assert os.path.isabs(schema.uri) and schema.layerNames[-1] == "logits"
    model = TorchModel(device="cpu").setModelSchema(schema)
    assert model.layerNames() == schema.layerNames
    with open(schema.uri, "r+b") as f:           # a corrupted artifact
        f.seek(100)
        f.write(b"\x00\x01\x02")
    with pytest.raises(ValueError, match="does not match"):
        d.downloadByName("ResNet20", "shapes10")
    with pytest.raises(downloader.ModelNotFoundException):
        d.downloadByName("ResNet99")


def test_publish_round_trips_through_both_packages(tmp_path):
    cfg = {"type": "mlp", "hidden": [8], "num_classes": 2, "input_dim": 6}
    from mmlspark_tpu_torch.models import trainer
    sd = trainer.init_params(cfg, 1)
    d = downloader.ModelDownloader(str(tmp_path / "repo"))
    schema = d.publish(cfg, sd, "Tiny", "toy", modelType="vector")
    assert schema.layerNames == ["dense0", "logits"]
    back = jax_downloader.LocalRepo(str(tmp_path / "repo")).listSchemas()
    assert [s.hash for s in back] == [schema.hash]
    x = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    want = np.stack(TpuModel().setModelLocation(schema.uri)
                    .transform(JaxDataFrame({"features": list(x)}))
                    .col("scores"))
    got = np.stack(TorchModel(device="cpu").setModelLocation(schema.uri)
                   .transform(DataFrame({"features": list(x)}))
                   .col("scores"))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_model_directory_with_flax_msgpack_loads(tmp_path):
    cfg, params = jax_downloader.unpack_model(
        open(os.path.join(ZOO, "ResNet20_digits8.model"), "rb").read())
    d = tmp_path / "m"
    d.mkdir()
    (d / "config.json").write_text('{"type": "resnet", "num_classes": 8}')
    (d / "params.msgpack").write_bytes(serialization.msgpack_serialize(params))
    model = TorchModel(device="cpu").setModelLocation(str(d))
    assert model.getModelConfig() == cfg
    _same_tree(model.getModelParams(), params)


def test_http_repository_waits_for_io():
    with pytest.raises(NotImplementedError, match="item 10"):
        downloader.ModelDownloader("/nonexistent", server_url="http://x")
    with pytest.raises(NotImplementedError, match="item 10"):
        downloader.RemoteRepo("http://x")


# -------------------------------------------------------------- serving

def test_zoo_resnet20_scores_shapes10_like_tpu_model(local_zoo):
    x, y = datagen.make_shapes10(256, seed=8)
    schema = downloader.ModelDownloader(local_zoo).downloadByName(
        "ResNet20", "shapes10")
    jschema = jax_downloader.ModelDownloader(local_zoo).downloadByName(
        "ResNet20", "shapes10")
    jdf = JaxDataFrame({"image": _rows(x, jax_image_row)})
    df = DataFrame({"image": _rows(x, make_image_row)})
    jm = TpuModel(inputCol="image").setModelSchema(jschema)
    tm = TorchModel(inputCol="image", device="cpu").setModelSchema(schema)
    want = np.stack(jm.transform(jdf).col("scores"))
    got = np.stack(tm.transform(df).col("scores"))
    assert (got.argmax(1) == want.argmax(1)).all()
    assert (got.argmax(1) == y).mean() >= 0.98
    # in float32 the scores themselves agree
    cfg32 = dict(jm.getModelConfig(), dtype="float32")
    want32 = np.stack(jm.setModelConfig(cfg32).transform(jdf).col("scores"))
    got32 = np.stack(tm.setModelConfig(cfg32).transform(df).col("scores"))
    err = np.abs(got32 - want32).max() / max(1.0, np.abs(want32).max())
    assert err <= 1e-4


@pytest.fixture(scope="module")
def digits8():
    with open(os.path.join(ZOO, "ResNet26b_digits8.model"), "rb") as f:
        cfg, params = downloader.unpack_model(f.read())
    return dict(cfg, dtype="float32"), params


@pytest.mark.parametrize("cut", [0, 1, 3])
def test_image_featurizer_matches_jax(digits8, cut):
    cfg, params = digits8
    x = np.random.default_rng(cut).integers(0, 256, size=(6, 40, 36, 3)) \
        .astype(np.uint8)
    want = np.stack(JaxImageFeaturizer(cutOutputLayers=cut).setModel(
        TpuModel().setModelConfig(cfg).setModelParams(params)).transform(
        JaxDataFrame({"image": _rows(x, jax_image_row)})).col("features"))
    feat = ImageFeaturizer(cutOutputLayers=cut, device="cpu").setModel(
        TorchModel().setModelConfig(cfg).setModelParams(params))
    df = DataFrame({"image": _rows(x, make_image_row)})
    got = np.stack(feat.transform(df).col("features"))
    assert got.shape == want.shape and got.ndim == 2
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) <= 1e-3
    inner = feat._inner
    feat.transform(df)
    assert feat._inner is inner                 # one inner model, reused
    assert feat.getModel().getDevice() == "cuda"   # the featurizer's rules


def test_image_featurizer_round_trips_and_refuses_deep_cuts(digits8,
                                                           tmp_path):
    cfg, params = digits8
    feat = ImageFeaturizer(cutOutputLayers=2, device="cpu").setModel(
        TorchModel().setModelConfig(cfg).setModelParams(params))
    feat.save(str(tmp_path / "feat"))
    back = load_stage(str(tmp_path / "feat"))
    x = np.random.default_rng(9).integers(0, 256, size=(2, 32, 32, 3)) \
        .astype(np.uint8)
    df = DataFrame({"image": _rows(x, make_image_row)})
    np.testing.assert_array_equal(np.stack(back.transform(df).col("features")),
                                  np.stack(feat.transform(df).col("features")))
    with pytest.raises(ValueError, match="cutOutputLayers"):
        feat.setCutOutputLayers(len(feat.layerNames())).transform(df)


# ------------------------------------------------------------ weight import

def _tiny_torchvision_resnet():
    """torchvision's ResNet graph (v1.5: stride on the 3x3) at toy size,
    from torch.nn with torchvision's parameter names: widths 8 and 16, one
    bottleneck a stage, 4 classes, non-trivial BN running statistics."""
    nn = torch.nn

    class Bottleneck(nn.Module):
        def __init__(self, cin, width, stride):
            super().__init__()
            inner = width // 4
            self.conv1 = nn.Conv2d(cin, inner, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(inner)
            self.conv2 = nn.Conv2d(inner, inner, 3, stride, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(inner)
            self.conv3 = nn.Conv2d(inner, width, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(width)
            self.downsample = None
            if stride != 1 or cin != width:
                self.downsample = nn.Sequential(
                    nn.Conv2d(cin, width, 1, stride, bias=False),
                    nn.BatchNorm2d(width))

        def forward(self, x):
            idn = x if self.downsample is None else self.downsample(x)
            y = torch.relu(self.bn1(self.conv1(x)))
            y = torch.relu(self.bn2(self.conv2(y)))
            return torch.relu(self.bn3(self.conv3(y)) + idn)

    class TinyResNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 2, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(2)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            self.layer1 = nn.Sequential(Bottleneck(2, 8, 1))
            self.layer2 = nn.Sequential(Bottleneck(8, 16, 2))
            self.fc = nn.Linear(16, 4)

        def forward(self, x):
            x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
            x = self.layer2(self.layer1(x))
            return self.fc(x.mean(dim=(2, 3)))

    torch.manual_seed(0)
    net = TinyResNet()
    with torch.no_grad():
        net(torch.randn(8, 3, 64, 64))          # train mode: running stats
    return net.eval()


def _state_numpy(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def test_import_resnet50_matches_torch_eval_and_the_jax_import(tmp_path):
    net = _tiny_torchvision_resnet()
    torch.save(net.state_dict(), str(tmp_path / "tiny.pth"))
    cfg, sd = import_weights.import_resnet50(
        str(tmp_path / "tiny.pth"), depths=(1, 1), widths=[8, 16])
    assert cfg["norm"] == "frozen" and cfg["padding"] == "torch"
    x = np.random.default_rng(0).normal(size=(2, 65, 63, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        module = build_model(cfg)
        module.load_state_dict(sd)
        got = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    jcfg, jtree = jax_import.import_resnet50(_state_numpy(net),
                                             depths=(1, 1), widths=[8, 16])
    assert jcfg == cfg
    carried = from_flax_params(jtree, cfg)
    assert set(carried) == set(sd)
    for k in sd:
        np.testing.assert_allclose(sd[k].numpy(), carried[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_uint8_preprocess_fold_matches_torch_transform():
    net = _tiny_torchvision_resnet()
    cfg, sd = import_weights.import_resnet50(
        _state_numpy(net), depths=(1, 1), widths=[8, 16],
        preprocess="imagenet_uint8")
    assert cfg["input_norm"] is True
    x = np.random.default_rng(1).integers(0, 256, size=(2, 64, 64, 3)) \
        .astype(np.uint8)
    norm = ((x / 255.0 - import_weights.IMAGENET_MEAN)
            / import_weights.IMAGENET_STD).astype(np.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(norm).permute(0, 3, 1, 2)).numpy()
        module = build_model(cfg)
        module.load_state_dict(sd)
        got = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_import_refuses_a_wrong_family_and_bad_shapes():
    state = _state_numpy(_tiny_torchvision_resnet())
    with pytest.raises(ValueError, match="unconsumed backbone"):
        import_weights.import_resnet50(dict(state), depths=(1,), widths=[8])
    with pytest.raises(ValueError, match="shape mismatch"):
        import_weights.import_resnet50(dict(state), depths=(1, 1),
                                       widths=[8, 32])
    with pytest.raises(ValueError, match="preprocess"):
        import_weights.import_resnet50(dict(state), depths=(1, 1),
                                       widths=[8, 16], preprocess="caffe")


def test_import_flax_paths_round_trips(tmp_path):
    cfg = {"type": "convnet", "channels": [4, 8], "dense": 6,
           "num_classes": 3}
    from mmlspark_tpu_torch.models import trainer
    from mmlspark_tpu_torch.models.weights import to_flax_params
    sd = trainer.init_params(cfg, 2)
    flat = {"/".join(k): v for k, v in
            flatten_dict(to_flax_params(sd, cfg)["params"]).items()}
    np.savez(str(tmp_path / "ck.npz"),
             **{k.replace("/", "."): v for k, v in flat.items()})
    back = import_weights.import_flax_paths(str(tmp_path / "ck.npz"), cfg)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    flat.pop("Dense_1/bias")
    with pytest.raises(ValueError, match="missing"):
        import_weights.import_flax_paths(flat, cfg)


# ------------------------------------------------------------------ datagen

def test_datagen_copies_are_bit_equal():
    x, y = datagen.make_shapes10(48, seed=8)
    jx, jy = jax_datagen.make_shapes10(48, seed=8)
    assert x.tobytes() == jx.tobytes() and (y == jy).all()
    x, y = datagen.make_shapes10(12, size=24, seed=3, class_offset=4)
    jx, jy = jax_datagen.make_shapes10(12, size=24, seed=3, class_offset=4)
    assert x.tobytes() == jx.tobytes() and (y == jy).all()
    assert datagen.SHAPES10_CLASSES == jax_datagen.SHAPES10_CLASSES
    st = datagen.make_torchvision_state(depths=(1, 2), widths=(8, 16),
                                        num_classes=5, seed=3)
    jst = jax_datagen.make_torchvision_state(depths=(1, 2), widths=(8, 16),
                                             num_classes=5, seed=3)
    assert list(st) == list(jst)
    assert all(st[k].dtype == jst[k].dtype and st[k].tobytes() ==
               jst[k].tobytes() for k in st)

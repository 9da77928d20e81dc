"""``TorchLearner.fitStream`` on the CPU, against the JAX package's
``TpuLearner.fitStream``.

* The fitStream cases of tests/test_models.py: it learns, ragged batches
  bucket to powers of two with weighted-out zero pad rows, checkpoints
  resume, an empty stream and a length mismatch raise, uint8 batches stay
  uint8 on the wire, and files -> ``io.loader.device_image_batches`` ->
  fitStream learns (PPM files written by ``io.image.encode_ppm``).
* The prefetch thread changes nothing (depth 0 and 2 give the same bits,
  tests/test_prefetch.py), bf16_mixed streams (tests/test_precision.py),
  a stream of tensors trains like the same stream of numpy arrays, and a
  fit killed in epoch 3 and resumed from its epoch checkpoint ends on the
  uninterrupted fit's parameters bit for bit.
* Parity: the same numpy-seeded ragged stream through both packages from
  the same JAX init, in float32: the final loss within atol = rtol = 1e-4
  and the parameters within 2e-3, the bars of the fit-parity test in
  tests/test_torch_trainer.py (an MLP, and the small causal transformer of
  that file with T = 16, the JAX side's flash kernels in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.modules import build_model as jax_build_model
from mmlspark_tpu.models.trainer import TpuLearner
from mmlspark_tpu_torch import DataFrame, TorchLearner
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.io.image import encode_ppm
from mmlspark_tpu_torch.io.loader import device_image_batches
from mmlspark_tpu_torch.models import trainer
from mmlspark_tpu_torch.models.weights import from_flax_params
from mmlspark_tpu_torch.resilience import faults

MLP = {"type": "mlp", "hidden": [16], "num_classes": 2}
CENTERS = np.array([[-2.0] * 6, [2.0] * 6], dtype=np.float32)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _stream_fn(seed=3, batches=8, bs=32, ragged=False, tensors=False):
    def make():
        r = np.random.default_rng(seed)
        for i in range(batches):
            n = bs - (i % 5) if ragged else bs
            y = r.integers(0, 2, n)
            x = (CENTERS[y] + r.normal(size=(n, 6))).astype(np.float32)
            yield (torch.from_numpy(x), torch.from_numpy(y)) if tensors \
                else (x, y)
    return make


def _learner(**kw):
    base = dict(modelConfig=MLP, epochs=3, learningRate=0.05, device="cpu")
    base.update(kw)
    return TorchLearner(**base)


def _params_equal(a, b) -> bool:
    pa, pb = a.getModelParams(), b.getModelParams()
    return set(pa) == set(pb) and all(torch.equal(pa[k], pb[k]) for k in pa)


def _no_prefetch_threads() -> bool:
    import threading
    return not any(t.name.startswith("prefetch-fit-stream")
                   for t in threading.enumerate())


def test_learns_from_stream():
    model = _learner().fitStream(_stream_fn())
    assert np.isfinite(model._final_loss)
    assert model._fit_stats["path"] == "stream"
    assert model._fit_stats["stream_batches"] == [8, 8, 8]
    rng = np.random.default_rng(9)
    y = rng.integers(0, 2, 64)
    x = (CENTERS[y] + rng.normal(size=(64, 6))).astype(np.float32)
    out = model.transform(DataFrame({"features": object_column(list(x))}))
    preds = np.stack(list(out.col("scores"))).argmax(axis=1)
    assert (preds == y).mean() > 0.95


def test_ragged_batches_bucket_to_powers_of_two():
    learner = _learner()
    batches = list(_stream_fn(ragged=True, batches=5)())
    steps = list(learner._stream_epoch_steps(iter(batches), MLP,
                                             torch.device("cpu")))
    for (x, y), (n, xb, yb, wb) in zip(batches, steps):
        assert n == len(x) and xb.shape == (32, 6) and yb.shape == (32,)
        assert wb.tolist() == [1.0] * n + [0.0] * (32 - n)
        assert torch.equal(xb[:n], torch.from_numpy(x))
        assert not xb[n:].any() and not yb[n:].any()
    small = list(learner._stream_epoch_steps(
        iter([(np.ones((5, 6), np.float32), np.ones(5))]), MLP,
        torch.device("cpu")))
    assert small[0][1].shape == (8, 6)             # at least 8 rows
    assert np.isfinite(learner.fitStream(
        _stream_fn(ragged=True))._final_loss)


def test_pad_rows_change_neither_loss_nor_gradient():
    """A batch of 5 rows and the same rows zero-padded to 8 with weight 0
    give the same loss and gradients."""
    step, (params, opt, _) = _learner()._training_setup(
        MLP, (5, 6), torch.device("cpu"))
    x, y = next(_stream_fn(bs=5)())
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int32))
    _, o5, _, l5 = step(params, opt, None, xt, yt, torch.ones(5))
    xp, yp = trainer._pad_rows(xt, 8), trainer._pad_rows(yt, 8)
    wp = torch.tensor([1.0] * 5 + [0.0] * 3)
    _, o8, _, l8 = step(params, opt, None, xp, yp, wp)
    assert torch.allclose(l5, l8, rtol=1e-6, atol=0)
    for k in o5["trace"]:
        torch.testing.assert_close(o5["trace"][k], o8["trace"][k],
                                   rtol=1e-6, atol=1e-7)


def test_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck")
    _learner(epochs=2, checkpointDir=ck).fitStream(_stream_fn())
    assert len(list((tmp_path / "ck").glob("ckpt_*"))) == 2
    model = _learner(epochs=4, checkpointDir=ck).fitStream(_stream_fn())
    assert len(list((tmp_path / "ck").glob("ckpt_*"))) == 4
    assert model._fit_stats["stream_batches"] == [8, 8]   # epochs 2 and 3


@pytest.mark.parametrize("opts", [{}, {"precision": "bf16_mixed",
                                       "asyncCheckpoint": True,
                                       "optimizer": "adam"}])
def test_killed_stream_resumes_bit_exact(tmp_path, opts):
    """Killed in epoch 3 (every dispatch after the 20th faults): the refit
    resumes from epoch 2's checkpoint and ends on the uninterrupted fit's
    bits."""
    clean = _learner(**opts).fitStream(_stream_fn())
    ck = str(tmp_path / "ck")
    faults.configure("trainer.step:error:1.0:20", seed=0)
    with pytest.raises(ConnectionError):
        _learner(checkpointDir=ck, **opts).fitStream(_stream_fn())
    faults.clear()
    learner = _learner(checkpointDir=ck, **opts)
    assert learner._latest_checkpoint() == (1, None)
    resumed = learner.fitStream(_stream_fn())
    assert resumed._fit_stats["stream_batches"] == [8]
    assert _params_equal(resumed, clean)
    assert resumed._final_loss == clean._final_loss


def test_step_checkpoint_restarts_the_stream_epoch(tmp_path):
    """A step checkpoint resumes at its epoch's start (a generator cannot
    seek): the epoch's batches all run again from the checkpointed
    state."""
    ck = str(tmp_path / "ck")
    faults.configure("trainer.step:error:1.0:12", seed=0)
    with pytest.raises(ConnectionError):
        _learner(checkpointDir=ck, checkpointEverySteps=3).fitStream(
            _stream_fn())
    faults.clear()
    learner = _learner(checkpointDir=ck, checkpointEverySteps=3)
    assert learner._latest_checkpoint() == (1, 2)
    model = learner.fitStream(_stream_fn())
    assert model._fit_stats["stream_batches"] == [8, 8]
    assert np.isfinite(model._final_loss)


def test_empty_stream_raises():
    with pytest.raises(ValueError, match="no batches"):
        _learner().fitStream(lambda: iter(()))


def test_length_mismatch_raises():
    def bad():
        yield np.zeros((4, 6), np.float32), np.zeros(3, np.int64)
    with pytest.raises(ValueError, match="mismatch"):
        _learner().fitStream(bad)


def test_token_ids_out_of_range_raise():
    cfg = {"type": "transformer", "vocab_size": 50, "d_model": 16,
           "heads": 2, "layers": 1, "num_classes": 2, "max_len": 8}

    def bad():
        yield np.full((2, 8), 50, np.int64), np.zeros(2, np.int64)
    with pytest.raises(ValueError, match="token ids"):
        _learner(modelConfig=cfg).fitStream(bad)


def test_parallelism_raises_naming_its_item():
    # fitStream is data(+tensor)-parallel, as in the JAX package
    with pytest.raises(ValueError, match="fitStream is data"):
        _learner(sequenceParallel=2).fitStream(_stream_fn())
    # fitStreamCaptured is ported: raw batches through a one-stage plan
    # train exactly as fitStream over the staged batches
    from mmlspark_tpu_torch.core.capture import compose_fit_capture
    from mmlspark_tpu_torch.stages.basic import FastVectorAssembler
    frames = [DataFrame({"x": xb.astype(np.float64), "label": yb})
              for xb, yb in _stream_fn(batches=3)()]
    asm = FastVectorAssembler(inputCols=("x",), outputCol="features")
    plan = compose_fit_capture([asm], frames[0], "features", "label")
    fused = _learner().fitStreamCaptured(lambda: iter(frames), plan)
    staged = _learner().fitStream(lambda: (
        (np.stack(list(asm.transform(f).col("features"))), f.col("label"))
        for f in frames))
    assert _params_equal(fused, staged)


def test_stream_batch_keeps_uint8_wire():
    x = np.zeros((4, 8, 8, 3), np.uint8)
    y = np.zeros(4, np.int64)
    xs, ys = trainer._stream_batch((x, y), {"type": "convnet"},
                                   "cross_entropy")
    assert xs.dtype == np.uint8 and ys.dtype == np.int32
    xs, _ = trainer._stream_batch((x.astype(np.float64), y),
                                  {"type": "convnet"}, "cross_entropy")
    assert xs.dtype == np.float32
    xt, yt = trainer._stream_batch((torch.from_numpy(x), torch.from_numpy(y)),
                                   {"type": "convnet"}, "mse")
    assert xt.dtype == torch.uint8 and yt.dtype == torch.float32

    def byte_stream():
        r = np.random.default_rng(0)
        for _ in range(4):
            yb = r.integers(0, 2, 16)
            xb = (yb[:, None, None, None] * 200).astype(np.uint8) + \
                r.integers(0, 20, (16, 8, 8, 3)).astype(np.uint8)
            yield xb, yb
    model = _learner(modelConfig={"type": "convnet", "channels": [4],
                                  "dense": 8, "num_classes": 2},
                     epochs=2, learningRate=0.01).fitStream(byte_stream)
    assert np.isfinite(model._final_loss)


def test_tensor_stream_trains_like_the_numpy_stream():
    a = _learner().fitStream(_stream_fn(ragged=True))
    b = _learner().fitStream(_stream_fn(ragged=True, tensors=True))
    assert _params_equal(a, b)


def test_prefetch_matches_sync_bitwise():
    m_sync = _learner(prefetchDepth=0, epochs=2).fitStream(_stream_fn())
    m_pre = _learner(prefetchDepth=2, epochs=2).fitStream(_stream_fn())
    assert m_pre._final_loss == m_sync._final_loss
    assert _params_equal(m_pre, m_sync)
    assert _no_prefetch_threads()


def test_divergence_halt_shuts_the_prefetcher_down():
    with pytest.raises(RuntimeError, match="diverged"):
        _learner(learningRate=1e30, optimizer="sgd").fitStream(_stream_fn())
    assert _no_prefetch_threads()


def test_fit_stream_mixed():
    rng = np.random.default_rng(0)

    def batches():
        for _ in range(6):
            x = rng.normal(size=(32, 8)).astype(np.float32)
            yield x, (x[:, 0] > 0).astype(np.int64)
    model = _learner(precision="bf16_mixed", epochs=2).fitStream(batches)
    assert np.isfinite(model._final_loss)
    assert model._fit_stats["scale_state"]["skipped"] == 0


def test_fitstream_from_image_loader(tmp_path):
    """Files -> io.loader.device_image_batches -> fitStream, never
    materialising the dataset."""
    rng = np.random.default_rng(0)
    paths, labels = [], []
    for i in range(48):
        y = i % 2
        img = rng.integers(0, 80, (16, 16, 3))
        img[(slice(0, 8) if y == 0 else slice(8, 16))] += 150
        p = str(tmp_path / f"im{i:02d}.ppm")
        with open(p, "wb") as f:
            f.write(encode_ppm(img.astype(np.uint8)))
        paths.append(p)
        labels.append(y)
    labels = np.array(labels, dtype=np.int64)

    def batches():
        for bi, (dev, ok, count) in enumerate(device_image_batches(
                paths, 16, 16, 16, device="cpu")):
            assert dev.dtype == torch.uint8 and ok[:count].all()
            yield dev[:count], labels[bi * 16: bi * 16 + count]

    model = _learner(modelConfig={"type": "convnet", "channels": [8],
                                  "dense": 16, "num_classes": 2},
                     epochs=6).fitStream(batches)
    assert np.isfinite(model._final_loss) and model._final_loss < 0.5


# ------------------------------------------------------------------ parity

def _jax_init(cfg, x_example):
    variables = jax_build_model(dict(cfg, attn_impl="blockwise")
                                if cfg["type"] == "transformer" else cfg) \
        .init(jax.random.PRNGKey(0), jnp.asarray(x_example))
    return jax.tree_util.tree_map(np.asarray, variables)


TRANSFORMER = {"type": "transformer", "vocab_size": 100, "d_model": 64,
               "heads": 2, "layers": 2, "num_classes": 8, "causal": True,
               "max_len": 128, "attn_impl": "flash"}


def _token_stream():
    r = np.random.default_rng(5)
    for i in range(3):
        n = 8 - 3 * (i == 2)                   # a ragged last batch
        yield (r.integers(0, 100, size=(n, 16)).astype(np.int32),
               r.integers(0, 8, size=n))


@pytest.mark.parametrize("model", ["mlp", "transformer"])
def test_fit_stream_matches_tpu_learner(monkeypatch, model):
    if model == "mlp":
        cfg, stream = MLP, _stream_fn(ragged=True, batches=5)
        example = np.zeros((1, 6), np.float32)
    else:
        cfg, stream = TRANSFORMER, _token_stream
        example = np.zeros((1, 16), np.int32)
    tree = _jax_init(cfg, example)
    monkeypatch.setattr(trainer, "init_params",
                        lambda c, seed: from_flax_params(tree, c))
    common = dict(modelConfig=cfg, optimizer="adam", learningRate=1e-3,
                  epochs=2, precision="f32", seed=0)
    jmodel = TpuLearner().set(**common).fitStream(stream)
    model_ = TorchLearner(device="cpu", **common).fitStream(stream)
    np.testing.assert_allclose(model_._final_loss, jmodel._final_loss,
                               atol=1e-4, rtol=1e-4)
    want = from_flax_params(jax.tree_util.tree_map(
        np.asarray, jmodel.getModelParams()),
        trainer.sized_for(cfg, example.shape))
    got = model_.getModelParams()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=2e-3, err_msg=k)

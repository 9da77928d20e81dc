"""The port's checkpoints (``resilience/ckpt.py`` and the trainer's
checkpoint block) against the JAX package's.

* The commit protocol, the async writer and the sharded group of
  tests/test_resilience.py, each run against both packages' ``ckpt``
  modules (``lib`` fixture), and a directory committed by one package
  verified and read by the other.
* The trainer on the CPU (an MLP, the per-step feed path forced with
  ``deviceDataCap=1``): step-checkpoint kill-and-resume counts only the
  steps left, torn and corrupt checkpoints fall back, keep-last-K, async
  and sharded saves resume, and a killed fit resumed from an epoch
  checkpoint (scan and feed paths) or from a step checkpoint (feed path)
  ends on the uninterrupted fit's parameters bit for bit.
* The file format: a bf16_mixed checkpoint written by the port read with
  flax's own ``msgpack_restore`` (f32 masters, the backed-off scale), and
  cross-package resume for sgd, momentum, adam and adamw (and momentum
  with decoupled weight decay, a two-member optax chain): a JAX fit of 2
  epochs continued by the port to 4 agrees with JAX's own 4-epoch fit, and
  the other way round, within 1e-5 relative (float32, TF32 off; the
  epochs run the same numpy shuffle draws in both packages).
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu import telemetry as jax_telemetry
from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.core.utils import object_column as jax_object_column
from mmlspark_tpu.models.trainer import TpuLearner
from mmlspark_tpu.resilience import ckpt as jax_ckpt
from mmlspark_tpu.resilience import faults as jax_faults
from mmlspark_tpu_torch import telemetry
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.models.trainer import TorchLearner
from mmlspark_tpu_torch.models.weights import from_flax_params
from mmlspark_tpu_torch.resilience import ckpt
from mmlspark_tpu_torch.resilience import faults

MLP = {"type": "mlp", "hidden": [4], "num_classes": 2}

PACKAGES = {"torch": (ckpt, faults, telemetry),
            "jax": (jax_ckpt, jax_faults, jax_telemetry)}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(params=sorted(PACKAGES))
def lib(request):
    """(ckpt module, faults module, telemetry package) of one package, its
    telemetry on and reset."""
    mod, flt, tel = PACKAGES[request.param]
    tel.enable()
    tel.registry.reset()
    yield mod, flt, tel
    tel.disable()
    tel.registry.reset()


@pytest.fixture
def telemetry_on():
    telemetry.enable()
    telemetry.registry.reset()
    yield telemetry
    telemetry.disable()
    telemetry.registry.reset()


def _counter(tel, name):
    series = tel.snapshot()[name]["series"]
    return series[0]["value"] if series else 0


# ------------------------------------------------------ the commit protocol

class TestCommitProtocol:
    def test_publish_commits_manifest_last(self, lib, tmp_path):
        mod, _, _ = lib
        d = str(tmp_path)
        mod.publish(os.path.join(d, "ckpt_00000.msgpack"), b"x" * 64)
        assert mod.load_manifest(d)["ckpt_00000.msgpack"]["size"] == 64
        assert mod.verify(d, "ckpt_00000.msgpack")
        # either package vouches for the other's commit
        other = jax_ckpt if mod is ckpt else ckpt
        assert other.verify(d, "ckpt_00000.msgpack")
        assert other.verify_bytes(d, "ckpt_00000.msgpack", b"x" * 64)
        assert not other.verify_bytes(d, "ckpt_00000.msgpack", b"y" * 64)

    def test_newest_wins_coalescing(self, lib, tmp_path):
        mod, _, tel = lib
        d = str(tmp_path)
        written = []

        def slow_payload(tag):
            def fn():
                time.sleep(0.15)
                written.append(tag)
                return tag.encode()
            return fn

        w = mod.AsyncCheckpointWriter("t")
        try:
            # the first starts at once; 2 and 3 land while it is in flight
            # -> 2 is coalesced away, 3 survives
            w.submit(os.path.join(d, "ckpt_00001.msgpack"),
                     slow_payload("one"))
            deadline = time.monotonic() + 10       # the writer picks it up
            while not w._in_flight and time.monotonic() < deadline:
                time.sleep(0.002)
            w.submit(os.path.join(d, "ckpt_00002.msgpack"),
                     slow_payload("two"))
            w.submit(os.path.join(d, "ckpt_00003.msgpack"),
                     slow_payload("three"))
            assert w.wait(timeout=10)
        finally:
            w.close()
        assert written == ["one", "three"]
        assert sorted(f for f in os.listdir(d) if f.endswith(".msgpack")) \
            == ["ckpt_00001.msgpack", "ckpt_00003.msgpack"]
        assert _counter(tel, "mmlspark_ckpt_coalesced_total") == 1

    def test_writer_error_surfaces_at_wait(self, lib, tmp_path):
        mod, flt, _ = lib
        flt.configure("ckpt.write:error:1.0", seed=0)
        w = mod.AsyncCheckpointWriter("t")
        try:
            w.submit(str(tmp_path / "ckpt_00000.msgpack"), lambda: b"x")
            with pytest.raises(ConnectionError):
                w.wait(timeout=10)
        finally:
            flt.clear()
            w.close()
        assert not (tmp_path / "ckpt_00000.msgpack").exists()

    def test_crash_at_rename_leaves_no_candidate(self, lib, tmp_path):
        mod, flt, _ = lib
        d = str(tmp_path)
        mod.publish(os.path.join(d, "ckpt_00000_s0000001.msgpack"), b"good")
        flt.configure("ckpt.rename:error:1.0", seed=0)
        try:
            with pytest.raises(ConnectionError):
                mod.publish(os.path.join(d, "ckpt_00000_s0000003.msgpack"),
                            b"doomed")
        finally:
            flt.clear()
        assert not os.path.exists(
            os.path.join(d, "ckpt_00000_s0000003.msgpack"))
        assert "ckpt_00000_s0000003.msgpack" not in mod.load_manifest(d)
        assert mod.verify(d, "ckpt_00000_s0000001.msgpack")


class TestShardedCheckpoints:
    def _state(self):
        rng = np.random.default_rng(0)
        return {"params": {"dense": {"kernel": rng.normal(
                    size=(16, 8)).astype(np.float32),
                    "bias": rng.normal(size=(8,)).astype(np.float32)}},
                "opt": {"0": {"mu": rng.normal(size=(16, 8)).astype(
                    np.float32)}, "1": {}}}

    def test_flatten_round_trip_keeps_empty_dicts(self, lib):
        mod, _, _ = lib
        flat = mod.flatten_state(self._state())
        want = jax_ckpt.flatten_state(self._state())
        assert sorted(flat) == sorted(want)
        assert all(np.array_equal(flat[k], v) for k, v in want.items())
        back = mod.unflatten_state(flat)
        assert back["opt"]["1"] == {}
        np.testing.assert_array_equal(back["params"]["dense"]["kernel"],
                                      self._state()["params"]["dense"][
                                          "kernel"])

    def test_partition_is_deterministic_and_covers(self, lib):
        mod, _, _ = lib
        sizes = [100, 1, 1, 100, 50, 50, 1]
        parts = mod.partition_leaves(sizes, 3)
        assert parts == jax_ckpt.partition_leaves(sizes, 3)
        assert sorted(i for p in parts for i in p) == list(range(7))
        assert len(parts) == 3

    def test_publish_sharded_commit_and_verify(self, lib, tmp_path):
        mod, _, _ = lib
        d = str(tmp_path)
        path = os.path.join(d, "ckpt_00001_s0000003.msgpack")
        mod.publish_sharded(path, [b"shard-a" * 10, b"shard-b" * 20])
        head = mod.parse_head(open(path, "rb").read())
        assert head == ["ckpt_00001_s0000003.shard_0.msgpack",
                        "ckpt_00001_s0000003.shard_1.msgpack"]
        for reader in (ckpt, jax_ckpt):
            assert reader.verify(d, "ckpt_00001_s0000003.msgpack")
            assert len(reader.load_manifest(d)[
                "ckpt_00001_s0000003.msgpack"]["shards"]) == 2
            assert reader.read_shards(d, head) == [b"shard-a" * 10,
                                                   b"shard-b" * 20]

    def test_torn_shard_disqualifies_whole_candidate(self, lib, tmp_path):
        mod, _, tel = lib
        d = str(tmp_path)
        mod.publish_sharded(os.path.join(d, "ckpt_00001.msgpack"),
                            [b"old-a", b"old-b"])
        mod.publish_sharded(os.path.join(d, "ckpt_00002.msgpack"),
                            [b"new-a", b"new-b"])
        with open(os.path.join(d, "ckpt_00002.shard_1.msgpack"), "wb") as f:
            f.write(b"n")
        assert not mod.verify(d, "ckpt_00002.msgpack")
        assert mod.verify(d, "ckpt_00001.msgpack")
        assert _counter(tel, "mmlspark_ckpt_corrupt_total") >= 1
        assert _counter(tel, "mmlspark_ckpt_shards_written_total") == 4

    def test_missing_shard_disqualifies(self, lib, tmp_path):
        mod, _, _ = lib
        d = str(tmp_path)
        mod.publish_sharded(os.path.join(d, "ckpt_00001.msgpack"),
                            [b"a", b"b", b"c"])
        os.remove(os.path.join(d, "ckpt_00001.shard_2.msgpack"))
        assert not mod.verify(d, "ckpt_00001.msgpack")

    def test_shard_content_hash_checked_at_read(self, lib, tmp_path):
        mod, _, _ = lib
        d = str(tmp_path)
        mod.publish_sharded(os.path.join(d, "ckpt_00001.msgpack"),
                            [b"aaaa", b"bbbb"])
        with open(os.path.join(d, "ckpt_00001.shard_0.msgpack"), "wb") as f:
            f.write(b"zzzz")
        assert mod.verify(d, "ckpt_00001.msgpack")   # sizes still match
        with pytest.raises(mod.CorruptCheckpoint):
            mod.read_shards(d, ["ckpt_00001.shard_0.msgpack",
                                "ckpt_00001.shard_1.msgpack"])

    def test_prune_takes_shards_with_the_head(self, lib, tmp_path):
        mod, _, _ = lib
        d = str(tmp_path)
        mod.publish_sharded(os.path.join(d, "ckpt_00001.msgpack"),
                            [b"a", b"b"])
        mod.prune(d, ["ckpt_00001.msgpack"])
        assert [f for f in os.listdir(d) if f.endswith(".msgpack")] == []
        assert "ckpt_00001.msgpack" not in mod.load_manifest(d)

    def test_shard_fault_site(self, lib, tmp_path):
        mod, flt, _ = lib
        flt.configure("ckpt.shard:error:1.0", seed=0)
        with pytest.raises(ConnectionError):
            mod.write_shard(str(tmp_path / "ckpt_00001.shard_0.msgpack"),
                            b"x")


@pytest.mark.parametrize("name,pos", [
    ("ckpt_00002.msgpack", (2, None)),
    ("ckpt_00002_s0000005.msgpack", (2, 5)),
    ("ckpt_00002.msgpack.tmp.0", None),
    ("ckpt_00002.shard_0.msgpack", None),
    ("other.msgpack", None)])
def test_checkpoint_name_parsing(name, pos):
    assert TorchLearner._parse_ckpt_name(name) == pos
    assert TpuLearner._parse_ckpt_name(name) == pos


def test_candidates_rank_epoch_finals_first(tmp_path):
    for f in ("ckpt_00001_s0000003.msgpack", "ckpt_00001.msgpack",
              "ckpt_00002_s0000001.msgpack", "ckpt_00002_s0000004.msgpack",
              "ckpt_00000.msgpack"):
        (tmp_path / f).write_bytes(b"x")
    learner = TorchLearner(checkpointDir=str(tmp_path))
    got = [pos for pos, _ in learner._ckpt_candidates()]
    assert got == [(2, 4), (2, 1), (1, None), (1, 3), (0, None)]
    assert got == [pos for pos, _ in TpuLearner().setCheckpointDir(
        str(tmp_path))._ckpt_candidates()]
    assert TorchLearner()._latest_checkpoint() is None


# ------------------------------------------------------------- the trainer

def _toy_df(n=64):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    return DataFrame({"features": object_column([r for r in x]),
                      "label": y})


def _toy_learner(ck: str, **kw):
    base = dict(modelConfig=MLP, epochs=1, batchSize=8, learningRate=0.05,
                deviceDataCap=1, checkpointDir=ck, checkpointEverySteps=2,
                device="cpu")
    base.update(kw)
    return TorchLearner(**base)


def _params_equal(a, b) -> bool:
    pa, pb = a.getModelParams(), b.getModelParams()
    return set(pa) == set(pb) and all(torch.equal(pa[k], pb[k]) for k in pa)


def test_trainer_kill_and_resume_from_step_checkpoint(tmp_path,
                                                      telemetry_on):
    """A fit killed mid-epoch (a trainer.step fault that outlives the retry
    budget) leaves step checkpoints; the refit resumes from the last one
    and dispatches only the steps left."""
    ck = str(tmp_path / "ck")
    df = _toy_df(64)                      # 64 rows / bs 8 -> 8 steps
    faults.configure("trainer.step:error:1.0:5", seed=0)  # die at step 5
    with pytest.raises(ConnectionError):
        _toy_learner(ck).fit(df)
    names = sorted(os.listdir(ck))
    assert "ckpt_00000_s0000003.msgpack" in names        # steps 1 and 3
    assert "ckpt_00000.msgpack" not in names             # epoch incomplete
    faults.clear()

    telemetry.registry.reset()
    learner = _toy_learner(ck)
    assert learner._latest_checkpoint() == (0, 3)
    model = learner.fit(df)
    assert np.isfinite(model._final_loss)
    hist = telemetry.snapshot()["mmlspark_trainer_step_seconds"]
    assert hist["series"][0]["count"] == 4       # steps 4..7
    assert sorted(os.listdir(ck)) == ["ckpt_00000.msgpack", "manifest.json"]
    assert learner._latest_checkpoint() == (0, None)


def test_torn_checkpoint_skipped_at_resume(tmp_path, telemetry_on):
    """A file the manifest never vouched for (rename landed, crash before
    the manifest commit) is skipped, counted, and the resume falls back."""
    ck = str(tmp_path / "ck")
    df = _toy_df(32)                       # 4 steps -> ckpts at s1, s3
    faults.configure("trainer.step:error:1.0:3", seed=0)
    with pytest.raises(ConnectionError):
        _toy_learner(ck).fit(df)
    faults.clear()
    learner = _toy_learner(ck)
    assert learner._latest_checkpoint() == (0, 1)
    with open(os.path.join(ck, "ckpt_00000_s0000003.msgpack"), "wb") as f:
        f.write(b"torn garbage")
    assert learner._latest_checkpoint() == (0, 1)
    assert _counter(telemetry, "mmlspark_ckpt_corrupt_total") >= 1
    assert np.isfinite(learner.fit(df)._final_loss)


@pytest.mark.parametrize("corrupt", ["same_size_garbage", "truncated_msgpack"])
def test_corrupt_checkpoint_content_falls_back(tmp_path, telemetry_on,
                                               corrupt):
    """Manifest-listed but corrupt content: the sha check (or, with the
    manifest's size and digest fixed up, the decoder) rejects it at restore
    and the resume falls back to the previous checkpoint."""
    ck = str(tmp_path / "ck")
    df = _toy_df(64)
    faults.configure("trainer.step:error:1.0:5", seed=0)
    with pytest.raises(ConnectionError):
        _toy_learner(ck).fit(df)
    faults.clear()
    name = "ckpt_00000_s0000003.msgpack"
    path = os.path.join(ck, name)
    blob = open(path, "rb").read()
    if corrupt == "same_size_garbage":
        open(path, "wb").write(b"\xff" * len(blob))
    else:
        import hashlib
        import json
        blob = blob[:len(blob) // 2]
        open(path, "wb").write(blob)
        doc = json.load(open(os.path.join(ck, "manifest.json")))
        doc["files"][name] = {"size": len(blob),
                              "sha256": hashlib.sha256(blob).hexdigest()}
        json.dump(doc, open(os.path.join(ck, "manifest.json"), "w"))
    learner = _toy_learner(ck)
    assert learner._latest_checkpoint() == (0, 3)    # the size matches
    telemetry.registry.reset()
    learner.fit(df)
    assert _counter(telemetry, "mmlspark_ckpt_corrupt_total") >= 1
    # resumed from s1: steps 2..7 dispatched
    hist = telemetry.snapshot()["mmlspark_trainer_step_seconds"]
    assert hist["series"][0]["count"] == 6


def test_step_checkpoint_retention_keep_last_k(tmp_path):
    ck = str(tmp_path / "ck")
    df = _toy_df(128)                      # 16 steps, ckpt every 2
    faults.configure("trainer.step:error:1.0:14", seed=0)  # die at s14
    with pytest.raises(ConnectionError):
        _toy_learner(ck).fit(df)           # keep default: 3
    faults.clear()
    steps = sorted(f for f in os.listdir(ck)
                   if f.endswith(".msgpack") and "_s" in f)
    assert steps == ["ckpt_00000_s%07d.msgpack" % s for s in (9, 11, 13)]
    assert np.isfinite(_toy_learner(ck).fit(df)._final_loss)


def _clean_and_resumed(tmp_path, kill_at: int, **kw):
    """(clean fit, resumed fit, its learner): every dispatch after the
    first ``kill_at`` faults, and the killed fit is refitted on its
    directory; the step-time histogram holds the refit's dispatches
    alone."""
    df = _toy_df(64)
    clean = _toy_learner(str(tmp_path / "clean"), **kw).fit(df)
    ck = str(tmp_path / "ck")
    faults.configure(f"trainer.step:error:1.0:{kill_at}", seed=0)
    with pytest.raises(ConnectionError):
        _toy_learner(ck, **kw).fit(df)
    faults.clear()
    telemetry.registry.reset()
    learner = _toy_learner(ck, **kw)
    assert learner._latest_checkpoint() is not None
    return clean, learner.fit(df), learner


@pytest.mark.parametrize("case", [
    "feed_step", "feed_step_async", "feed_step_sharded", "feed_epoch",
    "scan_epoch", "scan_epoch_rotate", "feed_step_bf16_mixed"])
def test_resumed_fit_is_bit_exact(tmp_path, case):
    """Killed in epoch 2 of 3 and resumed: the final parameters equal the
    uninterrupted fit's bit for bit (shuffle on: the completed epochs'
    draws are replayed)."""
    kw = dict(epochs=3, optimizer="adam")
    kill_at = 13                          # dies in epoch 1, at step 5 of 8
    if case.startswith("scan"):
        kw.update(deviceDataCap=0, stepsPerDispatch=1,
                  epochReshuffleCap=1 if case == "scan_epoch_rotate" else 0)
    if case == "feed_epoch":
        kw.update(checkpointEverySteps=0)
    kw.update({"feed_step_async": {"asyncCheckpoint": True},
               "feed_step_sharded": {"checkpointShards": 3},
               "feed_step_bf16_mixed": {"precision": "bf16_mixed"}}
              .get(case, {}))
    telemetry.enable()
    try:
        clean, resumed, learner = _clean_and_resumed(tmp_path, kill_at,
                                                     **kw)
        hist = telemetry.snapshot()["mmlspark_trainer_step_seconds"]
    finally:
        telemetry.disable()
        telemetry.registry.reset()
    # the resumed fit dispatched only the steps after its checkpoint:
    # (1, 3) on a step checkpoint, (0, None) on an epoch one
    assert hist["series"][0]["count"] == (12 if "step" in case else 16)
    assert _params_equal(resumed, clean)
    assert resumed._final_loss == clean._final_loss


def test_async_checkpoint_kill_and_resume(tmp_path):
    ck = str(tmp_path / "ck")
    df = _toy_df(64)
    faults.configure("trainer.step:error:1.0:5", seed=0)
    with pytest.raises(ConnectionError):
        _toy_learner(ck, asyncCheckpoint=True).fit(df)
    faults.clear()
    learner = _toy_learner(ck, asyncCheckpoint=True)
    pos = learner._latest_checkpoint()
    assert pos is not None and pos[1] is not None
    assert ckpt.load_manifest(ck)
    assert np.isfinite(learner.fit(df)._final_loss)
    assert learner._ckpt_writer_inst is None       # closed at fit exit


def test_ckpt_roundtrip_scale_state_and_f32_masters(tmp_path):
    """The port's bf16_mixed step checkpoint, read by flax: f32 masters and
    the backed-off scale (an inf row skipped step 0); the resumed fit
    continues from that scale."""
    from flax import serialization
    ck = str(tmp_path / "ck")
    x = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    x[0] = np.inf
    df = DataFrame({"features": object_column([r for r in x]),
                    "label": (np.arange(64) % 2).astype(np.int64)})
    learner = _toy_learner(ck, precision="bf16_mixed", shuffle=False,
                           lossScaleInit=float(2.0 ** 12),
                           haltOnNonFinite=False)
    faults.configure("trainer.step:error:1.0:5", seed=0)
    with pytest.raises(ConnectionError):
        learner.fit(df)
    faults.clear()
    with open(os.path.join(ck, "ckpt_00000_s0000003.msgpack"), "rb") as f:
        state = serialization.msgpack_restore(f.read())
    assert state["scale"] == {"scale": float(2.0 ** 11), "growth": 3,
                              "skipped": 1}
    leaves = jax.tree_util.tree_leaves(state["params"])
    assert leaves and all(np.asarray(v).dtype == np.float32 for v in leaves)
    model = _toy_learner(ck, precision="bf16_mixed", shuffle=False,
                         lossScaleInit=float(2.0 ** 12),
                         haltOnNonFinite=False).fit(df)
    assert model._fit_stats["scale_state"] == {
        "scale": float(2.0 ** 11), "growth": 7, "skipped": 1}


# ------------------------------------------------------- across the packages

_OPTIMIZERS = [("sgd", 0.0), ("momentum", 0.0), ("adam", 0.0),
               ("adamw", 0.01), ("momentum", 0.01)]
_CROSS = dict(modelConfig=MLP, batchSize=8, learningRate=0.05, seed=0,
              precision="f32")


def _frames(n=64):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int64)
    return (DataFrame({"features": object_column([r for r in x]),
                       "label": y}),
            JaxDataFrame({"features": jax_object_column([r for r in x]),
                          "label": y}))


def _jax_fit(opt, wd, epochs, ck=""):
    jdf = _frames()[1]
    learner = TpuLearner().set(optimizer=opt, weightDecay=wd, epochs=epochs,
                               checkpointDir=ck, **_CROSS)
    model = learner.fit(jdf)
    return from_flax_params(jax.tree_util.tree_map(
        np.asarray, model.getModelParams()), dict(MLP, input_dim=4))


def _torch_fit(opt, wd, epochs, ck=""):
    model = TorchLearner(optimizer=opt, weightDecay=wd, epochs=epochs,
                         checkpointDir=ck, device="cpu", **_CROSS) \
        .fit(_frames()[0])
    return model.getModelParams()


def _assert_rel_close(got: dict, want: dict, rel: float):
    for k in want:
        a, b = got[k].numpy(), want[k].numpy()
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), k


@pytest.mark.parametrize("opt,wd", _OPTIMIZERS)
def test_jax_checkpoint_resumes_in_the_port(tmp_path, opt, wd):
    ck = str(tmp_path / "ck")
    _jax_fit(opt, wd, 2, ck)
    assert sorted(f for f in os.listdir(ck) if f.endswith(".msgpack")) == \
        ["ckpt_00000.msgpack", "ckpt_00001.msgpack"]
    want = _jax_fit(opt, wd, 4)
    got = _torch_fit(opt, wd, 4, ck)
    assert "ckpt_00003.msgpack" in os.listdir(ck)
    _assert_rel_close(got, want, 1e-5)


@pytest.mark.parametrize("opt,wd", _OPTIMIZERS)
def test_port_checkpoint_resumes_in_jax(tmp_path, opt, wd):
    ck = str(tmp_path / "ck")
    _torch_fit(opt, wd, 2, ck)
    want = _torch_fit(opt, wd, 4)
    got = _jax_fit(opt, wd, 4, ck)
    assert "ckpt_00003.msgpack" in os.listdir(ck)
    _assert_rel_close(got, want, 1e-5)

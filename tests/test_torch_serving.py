"""The port's continuous-batching engine (``mmlspark_tpu_torch.io.serving``)
against the JAX package's, on the CPU.

A tiny float32 transformer (2 layers, d_model 64, ``attn_impl="flash"``:
the port runs row 1's plain version, the JAX package its Pallas kernel in
interpret mode) and a tiny uint8 convnet are initialised by the JAX
package and carried across as flax trees (the port's
``from_flax_params`` inside the step). The same numpy-seeded payloads go
through both packages' ``FusedServingStep`` and ``serve_continuous`` over
HTTP on 127.0.0.1: labels equal, scores within TOL = 1e-4 (float32: the
same function summed in another order, tests/test_torch_model.py). Both
packages' ``BucketPolicy``/``ContinuousBatcher`` form the same buckets
from the same arrival trace. Then tests/test_serving_engine.py's cases
against the port: a bad payload answers 400 alone, the SLO sheds at
admission, the ``serving.batch`` fault is retried, the miss and hit
counters count; the bundle round trip (torn capture shard -> that bucket
cold, torn model shard -> CorruptCheckpoint, absent -> FileNotFoundError,
the ``serving.bundle_load`` fault -> cold; flax reads the model shard back
to the same params); ``WorkerServer(bundle=...)`` answers with
``compiles()`` flat; and the profiler's AOT surface (on the CPU a
signature is cached once it has run once)."""

import base64
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from mmlspark_tpu.io.http.server import _Exchange as JaxExchange
from mmlspark_tpu.io.serving import (BucketPolicy as JaxBucketPolicy,
                                     ContinuousBatcher as JaxBatcher,
                                     FusedServingStep as JaxStep,
                                     pow2_bucket as jax_pow2_bucket,
                                     serve_continuous as jax_serve)
from mmlspark_tpu.models.modules import build_model as jax_build_model
from mmlspark_tpu_torch import telemetry
from mmlspark_tpu_torch.io.http.server import _Exchange
from mmlspark_tpu_torch.io.serving import (BUNDLE_HEAD, BucketPolicy,
                                           ContinuousBatcher,
                                           FusedServingStep, load_bundle,
                                           pow2_bucket, save_bundle,
                                           serve_continuous)
from mmlspark_tpu_torch.resilience import faults
from mmlspark_tpu_torch.resilience.ckpt import CorruptCheckpoint
from mmlspark_tpu_torch.telemetry import profiler

TOL = 1e-4
T = 32
TCFG = {"type": "transformer", "vocab_size": 100, "d_model": 64, "heads": 2,
        "layers": 2, "num_classes": 8, "causal": True, "max_len": 64,
        "dtype": "float32", "attn_impl": "flash"}
CCFG = {"type": "convnet", "channels": [4], "dense": 8, "num_classes": 3,
        "height": 8, "width": 8, "channels_in": 3, "dtype": "float32"}
MODELS = {"transformer": (TCFG, (T,), np.int32),
          "convnet": (CCFG, (8, 8, 3), np.uint8)}


@pytest.fixture
def tel():
    telemetry.enable()
    telemetry.registry.reset()
    yield telemetry
    telemetry.disable()


def _counter_total(name):
    snap = telemetry.snapshot()
    return sum(s["value"] for s in snap.get(name, {}).get("series", []))


@pytest.fixture(scope="module")
def flax_trees():
    """The JAX package's init of each tiny model, as numpy trees."""
    out = {}
    for name, (cfg, row, dt) in MODELS.items():
        init_cfg = dict(cfg, attn_impl="blockwise") if name == "transformer" \
            else cfg
        v = jax_build_model(init_cfg).init(jax.random.PRNGKey(0),
                                           np.zeros((1,) + row, dt))
        out[name] = jax.tree_util.tree_map(np.asarray, v)
    return out


def _rows(name, n, seed=0):
    cfg, row, dt = MODELS[name]
    rng = np.random.default_rng(seed)
    if dt == np.int32:
        return rng.integers(0, cfg["vocab_size"], size=(n,) + row,
                            dtype=np.int32)
    return rng.integers(0, 256, size=(n,) + row).astype(np.uint8)


def _step(name, trees, max_batch=16, output="scores", **kw):
    cfg, row, dt = MODELS[name]
    return FusedServingStep(cfg, trees[name], row_shape=row, in_dtype=dt,
                            output=output, device="cpu",
                            policy=BucketPolicy(max_batch=max_batch,
                                                min_bucket=8), **kw)


def _jax_step(name, trees, max_batch=16, output="scores"):
    cfg, row, dt = MODELS[name]
    return JaxStep(cfg, trees[name], row_shape=row, in_dtype=dt,
                   output=output,
                   policy=JaxBucketPolicy(max_batch=max_batch, min_bucket=8))


def _payload(row) -> bytes:
    return base64.b64encode(np.ascontiguousarray(row).tobytes())


def _post(url, data: bytes, timeout=60.0):
    req = urllib.request.Request(url, data=data)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


# ------------------------------------------------------- the fused step

@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_matches_jax_step(flax_trees, name):
    rows = _rows(name, 5)
    got = _step(name, flax_trees).score_rows(rows, 8)
    want = np.asarray(_jax_step(name, flax_trees).score_rows(rows, 8))
    assert got.shape == want.shape == (5, MODELS[name][0]["num_classes"])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    labels = _step(name, flax_trees, output="argmax").score_rows(rows, 8)
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, want.argmax(-1))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_serve_continuous_matches_jax_over_http(flax_trees, name):
    """12 concurrent clients per package, the same payloads: every label
    equal and every score within TOL."""
    rows = _rows(name, 12, seed=1)
    answers = {}
    for pkg, serve, step in (
            ("port", serve_continuous, _step(name, flax_trees)),
            ("jax", jax_serve, _jax_step(name, flax_trees))):
        source, loop = serve(step, max_wait=0.01)
        got = [None] * len(rows)
        try:
            def client(i):
                got[i] = _post(source.url, _payload(rows[i]))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(rows))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            loop.stop()
            source.close()
        assert all(code == 200 for code, _ in got), got
        answers[pkg] = np.array([json.loads(b)["scores"] for _, b in got])
    np.testing.assert_allclose(answers["port"], answers["jax"], atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(answers["port"].argmax(-1),
                                  answers["jax"].argmax(-1))


def test_step_surface(tel, flax_trees):
    """compile_buckets captures (on the CPU: runs) each bucket once,
    idempotently; hits and misses count; decode checks its size; the
    output mode is validated; a pipeline composite replies with its
    pipeline's predictions."""
    step = _step("convnet", flax_trees, max_batch=32, output="argmax")
    assert step.warm_buckets() == []
    assert step.compile_buckets() == 3
    assert step.warm_buckets() == [8, 16, 32] and step.compiles() == 3
    assert step.compile_buckets() == 0
    assert _counter_total("mmlspark_serving_aot_compiles_total") == 3
    cold = _step("convnet", flax_trees, max_batch=32, output="argmax")
    rows = _rows("convnet", 3)
    cold.score_rows(rows, 8)
    assert _counter_total("mmlspark_serving_exec_cache_misses_total") == 1
    cold.score_rows(rows, 8)
    assert _counter_total("mmlspark_serving_exec_cache_hits_total") == 1
    assert cold.compiles() == 1
    row = _rows("convnet", 1)[0]
    np.testing.assert_array_equal(step.decode(_payload(row).decode()), row)
    with pytest.raises(ValueError, match="expected 192"):
        step.decode(base64.b64encode(b"\x00" * 8).decode())
    with pytest.raises(ValueError, match="argmax|scores"):
        _step("convnet", flax_trees, output="probabilities")
    # from_pipeline is ported: an assembler -> logistic regression
    # composite replies with the pipeline's own predictions
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.core.utils import object_column
    from mmlspark_tpu_torch.models.classical import LogisticRegressionModel
    from mmlspark_tpu_torch.stages.basic import FastVectorAssembler
    r = np.random.default_rng(4)
    pm = PipelineModel(stages=(
        FastVectorAssembler(inputCols=("features",), outputCol="v"),
        LogisticRegressionModel(featuresCol="v",
                                coefficients=r.normal(size=(5, 3)),
                                intercept=r.normal(size=3))))
    composite = FusedServingStep.from_pipeline(
        pm, row_shape=(5,), device="cpu",
        policy=BucketPolicy(max_batch=8, min_bucket=8))
    xs = r.normal(size=(6, 5)).astype(np.float32)
    want = pm.transform(DataFrame({"features": object_column(list(xs))}))
    assert [json.loads(o)["label"] for o in composite(
        [base64.b64encode(x.tobytes()).decode() for x in xs])] == \
        want.col("prediction").astype(int).tolist()
    if not torch.cuda.is_available():   # the default device is cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FusedServingStep(CCFG, flax_trees["convnet"],
                             row_shape=(8, 8, 3))
    out = step([_payload(r).decode() for r in rows])
    assert [json.loads(o)["label"] for o in out] == list(
        step.score_rows(rows, 8))


# ------------------------------------------------------- batch formation

class _FakeSource:
    """drain-compatible double over a list of exchanges (either package's
    ``_Exchange``)."""

    def __init__(self, exchange):
        self.exchange = exchange
        self.items = []

    def add(self, value):
        self.items.append(self.exchange(str(value)))

    def drain(self, max_rows, timeout=0.05, wait_first=True):
        take, self.items = self.items[:max_rows], self.items[max_rows:]
        return take


def test_batchers_form_the_same_buckets():
    """One arrival trace (bursts of requests, each burst queued before the
    batcher runs) through both packages' BucketPolicy and
    ContinuousBatcher: the same batches in the same buckets."""
    trace = [5, 16, 20, 3, 1, 40, 9, 0, 33]
    formed = {}
    for pkg, policy, batcher, exchange in (
            ("port", BucketPolicy, ContinuousBatcher, _Exchange),
            ("jax", JaxBucketPolicy, JaxBatcher, JaxExchange)):
        src = _FakeSource(exchange)
        b = batcher(src, policy(max_batch=16, min_bucket=2), max_wait=0.0)
        out, n = [], 0
        for burst in trace:
            for _ in range(burst):
                src.add(n)
                n += 1
            while (got := b.next_batch()) is not None:
                out.append(([ex.value for ex in got[0]], got[1]))
        formed[pkg] = out
    assert formed["port"] == formed["jax"]
    assert [bucket for _, bucket in formed["port"]][:4] == [8, 16, 16, 4]
    for n in (0, 1, 7, 9, 100, 5000):
        assert pow2_bucket(n) == jax_pow2_bucket(n)
    for mb, lo in ((64, 8), (100, 5), (3, 1)):
        assert BucketPolicy(mb, lo).buckets == JaxBucketPolicy(mb, lo).buckets
    with pytest.raises(ValueError, match="exceed max_batch"):
        BucketPolicy(max_batch=32).bucket_for(33)
    with pytest.raises(ValueError):
        BucketPolicy(max_batch=4, min_bucket=8)


# ------------------------------------------ tests/test_serving_engine.py

def test_bad_payload_answers_400_alone(tel, flax_trees):
    source, loop = serve_continuous(_step("convnet", flax_trees,
                                          output="argmax"), max_wait=0.05)
    try:
        ok = {}
        t = threading.Thread(target=lambda: ok.update(
            r=_post(source.url, _payload(_rows("convnet", 1)[0]))))
        t.start()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(source.url, base64.b64encode(b"\x01\x02"))
        assert ei.value.code == 400
        t.join(timeout=60)
        assert ok["r"][0] == 200
        assert _counter_total("mmlspark_serving_exec_cache_misses_total") == 0
        hist = telemetry.snapshot()["mmlspark_serving_bucket_rows"]
        assert sum(s["count"] for s in hist["series"]) >= 1
    finally:
        loop.stop()
        source.close()


def test_slo_breach_sheds_at_admission(tel, flax_trees):
    from mmlspark_tpu_torch.telemetry.registry import MetricsRegistry
    from mmlspark_tpu_torch.telemetry.slo import SLOEngine
    from mmlspark_tpu_torch.telemetry.timeseries import TimeSeriesSampler
    reg = MetricsRegistry()
    ts = TimeSeriesSampler(registry=reg)
    eng = SLOEngine([{
        "name": "errors", "kind": "error_rate",
        "bad": "t_cb_bad_total", "total": "t_cb_requests_total",
        "target": 0.9, "windows": [10, 60],
        "shed_on_breach": True}], sampler=ts)
    total = reg.counter("t_cb_requests", "")
    bad = reg.counter("t_cb_bad", "")
    source, loop = serve_continuous(_step("convnet", flax_trees,
                                          output="argmax"),
                                    max_wait=0.01, slo=eng)
    try:
        payload = _payload(_rows("convnet", 1)[0])
        assert _post(source.url, payload)[0] == 200
        total.inc(10)
        bad.inc(9)
        ts.tick(now=0.0)
        total.inc(10)
        bad.inc(9)
        ts.tick(now=5.0)
        eng.evaluate(now=5.0)
        assert eng.should_shed()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(source.url, payload)
        assert ei.value.code == 503
        assert ei.value.headers["Retry-After"] is not None
        assert _counter_total("mmlspark_http_shed_requests") >= 1
        eng.evaluate(now=1e4)
        assert _post(source.url, payload)[0] == 200
    finally:
        loop.stop()
        source.close()


def test_serving_batch_fault_is_retried(tel, flax_trees):
    faults.configure("serving.batch:error:1.0:0:1", seed=0)
    source, loop = serve_continuous(_step("convnet", flax_trees,
                                          output="argmax"), max_wait=0.01)
    try:
        code, _ = _post(source.url, _payload(_rows("convnet", 1)[0]))
        assert code == 200
        assert _counter_total("mmlspark_faults_injected_total") == 1

        def dispatches():
            disp = telemetry.snapshot().get(
                "mmlspark_serving_dispatch_seconds", {"series": []})
            return sum(s["count"] for s in disp["series"])
        # the loop observes the dispatch timer after it hands the reply to
        # the handler thread: wait for that observation instead of racing it
        deadline = time.monotonic() + 10.0
        while dispatches() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert dispatches() == 1
    finally:
        loop.stop()
        source.close()
        faults.clear()


# ------------------------------------------------------------ bundles

def test_bundle_round_trip_is_warm_and_flax_reads_it(tel, flax_trees,
                                                     tmp_path):
    step = _step("transformer", flax_trees)
    save_bundle(str(tmp_path), step)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted([BUNDLE_HEAD, "manifest.json", "bundle_meta.json",
                            "bundle_model.msgpack", "bundle_exec_b8.bin",
                            "bundle_exec_b16.bin"])
    meta = json.loads((tmp_path / "bundle_meta.json").read_text())
    assert meta["backend"] == "cpu" and meta["kind"] == "model"
    assert {"torch", "cuda", "device_name", "capability",
            "device_count"} <= set(meta)
    rec = json.loads((tmp_path / "bundle_exec_b16.bin").read_text())
    assert rec["signature"] == {"shape": [16, T], "dtype": "torch.int32",
                                "device": "cpu"}
    # the model shard is the JAX package's param tree, read by flax
    restored = serialization.msgpack_restore(
        (tmp_path / "bundle_model.msgpack").read_bytes())
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           restored, flax_trees["transformer"])
    loaded = load_bundle(str(tmp_path), device="cpu")
    assert loaded.warm_buckets() == [8, 16] and loaded.compiles() == 0
    rows = _rows("transformer", 3, seed=2)
    np.testing.assert_array_equal(loaded.score_rows(rows, 8),
                                  step.score_rows(rows, 8))
    assert loaded.compiles() == 0
    series = telemetry.snapshot()[
        "mmlspark_serving_bundle_loads_total"]["series"]
    assert {tuple(sorted(s["labels"].items())): s["value"]
            for s in series if s["value"]} == {(("result", "warm"),): 1.0}
    # a state_dict-held step writes the same flax tree
    from mmlspark_tpu_torch.models.weights import from_flax_params
    sd_step = FusedServingStep(
        TCFG, from_flax_params(flax_trees["transformer"], TCFG),
        row_shape=(T,), in_dtype=np.int32, output="scores", device="cpu",
        policy=BucketPolicy(max_batch=8, min_bucket=8))
    save_bundle(str(tmp_path / "sd"), sd_step)
    assert (tmp_path / "sd" / "bundle_model.msgpack").read_bytes() == \
        (tmp_path / "bundle_model.msgpack").read_bytes()


def test_torn_capture_shard_makes_its_bucket_cold(tel, flax_trees, tmp_path):
    step = _step("convnet", flax_trees, max_batch=32)
    save_bundle(str(tmp_path), step)
    shard = tmp_path / "bundle_exec_b16.bin"
    shard.write_bytes(shard.read_bytes()[:-7])
    loaded = load_bundle(str(tmp_path), device="cpu")
    assert loaded.warm_buckets() == [8, 32]
    assert _counter_total("mmlspark_serving_bundle_exec_failures_total") == 1
    out = loaded.score_rows(_rows("convnet", 10), 16)
    assert out.shape == (10, 3) and loaded.compiles() == 1
    assert _counter_total("mmlspark_serving_exec_cache_misses_total") == 1


def test_torn_model_shard_and_absent_bundle_raise(tel, flax_trees, tmp_path):
    with pytest.raises(FileNotFoundError):
        load_bundle(str(tmp_path / "none"), device="cpu")
    series = telemetry.snapshot()[
        "mmlspark_serving_bundle_loads_total"]["series"]
    assert [s["labels"]["result"] for s in series if s["value"]] == [
        "absent"]
    save_bundle(str(tmp_path), _step("convnet", flax_trees))
    blob = (tmp_path / "bundle_model.msgpack").read_bytes()
    (tmp_path / "bundle_model.msgpack").write_bytes(blob[:-3])
    with pytest.raises(CorruptCheckpoint):
        load_bundle(str(tmp_path), device="cpu")
    assert _counter_total("mmlspark_ckpt_corrupt_total") >= 1


def test_bundle_load_fault_and_stale_runtime_degrade_to_cold(
        tel, flax_trees, tmp_path):
    save_bundle(str(tmp_path), _step("convnet", flax_trees, max_batch=32))
    faults.configure("serving.bundle_load:error:1.0:0:1", seed=0)
    try:
        loaded = load_bundle(str(tmp_path), device="cpu")
    finally:
        faults.clear()
    assert loaded.warm_buckets() == [16, 32]
    assert _counter_total("mmlspark_serving_bundle_exec_failures_total") == 1
    assert loaded.score_rows(_rows("convnet", 2), 8).shape == (2, 3)
    # a bundle captured under another torch is cold everywhere, and serves
    from mmlspark_tpu_torch.resilience import ckpt
    meta = json.loads((tmp_path / "bundle_meta.json").read_text())
    meta["torch"] = "0.0.0"
    ckpt.write_shard(str(tmp_path / "bundle_meta.json"),
                     json.dumps(meta, sort_keys=True).encode())
    ckpt.commit_sharded(str(tmp_path / BUNDLE_HEAD),
                        [n for n in sorted(os.listdir(tmp_path))
                         if n.startswith("bundle_")])
    cold = load_bundle(str(tmp_path), device="cpu")
    assert cold.warm_buckets() == []
    assert cold.score_rows(_rows("convnet", 2), 8).shape == (2, 3)


def test_worker_serves_its_bundle_warm(tel, flax_trees, tmp_path):
    """WorkerServer(bundle=...) in this process: every bucket is warm
    before the port opens, the answers equal the saved step's, and
    compiles() stays flat under traffic (control-plane /healthz)."""
    from mmlspark_tpu_torch.io.http.worker import WorkerServer
    step = _step("transformer", flax_trees, output="argmax")
    save_bundle(str(tmp_path), step)
    w = WorkerServer(bundle=str(tmp_path), device="cpu")
    try:
        assert w.step.warm_buckets() == [8, 16]
        rows = _rows("transformer", 4, seed=3)
        got = [json.loads(_post(w.source.url, _payload(r))[1])["label"]
               for r in rows]
        assert got == list(step.score_rows(rows, 8))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{w.control_port}/healthz",
                timeout=10) as r:
            health = json.loads(r.read())
        assert health["serving"]["compiles"] == 0
        assert health["serving"]["warm_buckets"] == [8, 16]
        assert health["serving"]["nvcc_builds"] == 0
        assert _counter_total(
            "mmlspark_serving_exec_cache_misses_total") == 0
    finally:
        w.close()


def test_worker_main_prints_its_ports(tmp_path):
    """``python -m mmlspark_tpu_torch.io.http.worker`` without a bundle:
    one JSON line with the probed ports, then it serves until killed."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.io.http.worker"],
        cwd=root, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=root))
    try:
        ports = json.loads(proc.stdout.readline())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ports['control']}/health",
                timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True,
                                            "port": ports["port"]}
    finally:
        proc.kill()
        proc.wait(timeout=10)


# ------------------------------------------- the profiler's AOT surface

def test_profiler_aot_cache_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        return x * 2

    pf = profiler.wrap(fn, "test.aot", aot=True)
    spec = profiler.TensorSpec((4, 3), torch.float32)
    assert not pf.is_cached(spec)
    ex = pf.aot_compile(spec)
    assert isinstance(ex, profiler.EagerExec)
    assert pf.compiles == 1 and calls == [(4, 3)]     # ran once
    x = torch.ones(4, 3)
    assert pf.is_cached(x) and pf.aot_compile(x) is ex
    assert torch.equal(pf(x), x * 2) and pf.compiles == 1
    pf(torch.ones(2, 3))                              # a new signature
    assert pf.compiles == 2 and pf.causes == {"first": 1,
                                              "shape_change": 1}
    pre = profiler.wrap(fn, "test.aot.preload", aot=True)
    pre.preload((spec,))
    assert pre.is_cached(x) and pre.compiles == 0


def test_capture_record_replays_launch_counts():
    """A wrapper's launch count and FLOP report go into the capture's
    record while a capture runs, and every replay counts them again."""
    def kernel():
        pass

    kernel.launches = 0
    rec = profiler.CaptureRecord()
    profiler._capturing.record = rec
    try:
        for _ in range(3):
            profiler.count_launch(kernel, library="flash_attention_fwd")
            profiler.note_kernel(10.0, 4.0)
    finally:
        profiler._capturing.record = None
    assert kernel.launches == 0
    assert rec.summary() == {"launches": {"kernel.launches": 3},
                             "libraries": ["flash_attention_fwd"]}
    _, cost = profiler.count_call(lambda: [rec.replay(), rec.replay()], ())
    assert kernel.launches == 6
    assert cost["flops"] == 60.0 and cost["bytes"] >= 24.0
    profiler.count_launch(kernel)
    assert kernel.launches == 7

"""The port's HTTP layer (``mmlspark_tpu_torch.io.http``, ``io.powerbi``)
with real sockets on 127.0.0.1: tests/test_io.py's source/sink, client,
parser, PowerBI and distributed-serving cases run against the port, whose
clients send through ``urllib`` (the card's machine has no ``requests``);
the serving surface (``/healthz``, ``/metrics``, the debug endpoints,
traceparent propagation, admission shedding); and ``serve_pipeline`` over
a fitted level-wise booster, whose replies equal ``transform``'s bit for
bit. The JAX package's client stages hit the same port-served endpoints
and read the same answers."""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.core.utils import object_column as jax_object_column
from mmlspark_tpu.io.http import (HTTPTransformer as JaxHTTPTransformer,
                                  JSONInputParser as JaxJSONInputParser)
from mmlspark_tpu_torch import DataFrame, telemetry
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.io import powerbi
from mmlspark_tpu_torch.io.http import (DistributedHTTPSource,
                                        HTTPTransformer, JSONInputParser,
                                        JSONOutputParser, SharedVariable,
                                        SimpleHTTPTransformer,
                                        StringOutputParser, serve_distributed,
                                        serve_pipeline)
from mmlspark_tpu_torch.io.http.transformer import request
from mmlspark_tpu_torch.resilience import faults


def _post(url, obj=None, data=None, headers=None, timeout=10):
    """POST json (or raw bytes) -> (status, body text, headers); HTTP
    errors answer as responses."""
    body = data if data is not None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


class _Doubler(Transformer):
    """Serving-side pipeline: parse json value, double it, emit reply."""

    def transform(self, df):
        replies = [json.dumps({"y": json.loads(v)["x"] * 2})
                   for v in df.col("value")]
        return df.withColumn("reply", object_column(replies))


class _Boom(Transformer):
    def transform(self, df):
        raise RuntimeError("kaput")


@pytest.fixture
def echo_server():
    source, loop = serve_pipeline(_Doubler())
    yield source
    loop.stop()
    source.close()


@pytest.fixture
def tel():
    telemetry.enable()
    telemetry.registry.reset()
    yield telemetry
    telemetry.disable()


# ------------------------------------------------------ source, sink, loop

def test_source_sink_roundtrip():
    source, loop = serve_pipeline(_Doubler(), max_batch=16)
    try:
        assert _post(source.url, {"x": 21})[:2] == (200, '{"y": 42}')
        results = []

        def client(i):
            results.append((i, json.loads(_post(source.url,
                                                {"x": i})[1])["y"]))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(results) == [(i, i * 2) for i in range(16)]
    finally:
        loop.stop()
        source.close()


def test_pipeline_error_returns_500():
    source, loop = serve_pipeline(_Boom())
    try:
        code, body, _ = _post(source.url, {"x": 1})
        assert code == 500 and "kaput" in json.loads(body)["error"]
    finally:
        loop.stop()
        source.close()


def test_probe_and_debug_surface(tel):
    """/healthz, /metrics (the port's registry), /debug/flight and
    /debug/trace/<id> answer; the fleet endpoints 404 and /debug/threads
    501, naming ROADMAP.md item 13b; an incoming traceparent is the
    request's trace."""
    source, loop = serve_pipeline(_Doubler())
    try:
        tid = "4bf92f3577b34da6a3ce929d0e0e4736"
        tp = f"00-{tid}-00f067aa0ba902b7-01"
        assert _post(source.url, {"x": 2},
                     headers={"traceparent": tp})[0] == 200
        code, body, _ = _get(source.url + "healthz")
        health = json.loads(body)
        assert code == 200 and health["ok"] and health["queue_depth"] == 0
        assert "elastic" not in health and "breakers" in health
        code, body, headers = _get(source.url + "metrics")
        assert code == 200 and headers["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        assert "mmlspark_http_request_seconds" in body
        assert _get(source.url + "debug/flight")[0] == 200
        code, body, _ = _get(source.url + f"debug/trace/{tid}")
        assert code == 200 and json.loads(body)["trace_id"] == tid
        for path, want in (("fleet/metrics", 404),
                           ("timeseries?scope=fleet", 404),
                           ("debug/threads", 501)):
            code, body, _ = _get(source.url + path)
            assert code == want and "13b" in body, path
        assert _get(source.url + "timeseries")[0] == 200
        assert _get(source.url + "nowhere")[0] == 404
    finally:
        loop.stop()
        source.close()


def test_queue_bound_and_draining_shed_503():
    """A full queue and a draining source answer 503 + Retry-After at the
    door, before any queueing."""
    from mmlspark_tpu_torch.io.http import HTTPSource
    source = HTTPSource(max_queue_depth=1)
    try:
        waiter = threading.Thread(target=_post, args=(source.url, {"x": 1}),
                                  kwargs={"timeout": 5})
        waiter.start()
        deadline = time.monotonic() + 5
        while source.health()["queue_depth"] < 1 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        code, body, headers = _post(source.url, {"x": 2})
        assert code == 503 and "overloaded" in body
        assert headers["Retry-After"] == "1"
        for ex in source.drain(4):
            source.respond(ex.id, 200, "{}")
        waiter.join()
        source.set_draining(True)
        code, body, _ = _post(source.url, {"x": 3})
        assert code == 503 and "draining" in body
    finally:
        source.close()


# ------------------------------------------------------------ clients

def test_simple_http_transformer(echo_server):
    df = DataFrame({"data": object_column([{"x": 1}, {"x": 5}])})
    out = (SimpleHTTPTransformer().setInputCol("data").setOutputCol("res")
           .setUrl(echo_server.url).transform(df))
    assert [r["y"] for r in out.col("res")] == [2, 10]


def test_http_transformer_parsers_match_the_jax_clients(echo_server):
    """The port's urllib client and the JAX package's requests client
    send the same request dicts to one server and read the same answers."""
    rows = [{"x": 3}, {"x": 4}]
    out = (JSONInputParser().setInputCol("data").setOutputCol("req")
           .setUrl(echo_server.url)
           .transform(DataFrame({"data": object_column(rows)})))
    out = (HTTPTransformer().setInputCol("req").setOutputCol("resp")
           .transform(out))
    resp = out.col("resp")
    assert [r["statusCode"] for r in resp] == [200, 200]
    jout = (JaxJSONInputParser().setInputCol("data").setOutputCol("req")
            .setUrl(echo_server.url)
            .transform(JaxDataFrame({"data": jax_object_column(rows)})))
    jresp = (JaxHTTPTransformer().setInputCol("req").setOutputCol("resp")
             .transform(jout).col("resp"))
    assert list(out.col("req")) == list(jout.col("req"))
    assert [r["body"] for r in resp] == [r["body"] for r in jresp]
    parsed = (JSONOutputParser().setInputCol("resp").setOutputCol("parsed")
              .transform(out).col("parsed"))
    assert list(parsed) == [{"y": 6}, {"y": 8}]
    text = (StringOutputParser().setInputCol("resp").setOutputCol("s")
            .transform(out).col("s"))
    assert list(text) == ['{"y": 6}', '{"y": 8}']


def test_unreachable_host_is_captured():
    df = DataFrame({"req": object_column(
        [{"url": "http://127.0.0.1:1/none", "method": "GET"}, {}])})
    out = (HTTPTransformer().setInputCol("req").setOutputCol("resp")
           .setTimeout(2.0).transform(df))
    for r in out.col("resp"):
        assert r["statusCode"] == 0 and "error" in r


def test_error_statuses_answer_and_5xx_retry():
    """A 4xx/5xx answer is a response (as requests gives it), not an
    error; with retries a 503 is re-attempted and the last answer kept."""
    hits = []

    class Flaky(BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            hits.append(self.path)
            code = 404 if self.path == "/missing" else \
                503 if len(hits) < 3 else 200
            body = json.dumps({"n": len(hits)}).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Flaky)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        r = request("POST", url + "/missing", data="{}")
        assert r.status_code == 404 and json.loads(r.text) == {"n": 1}
        df = DataFrame({"req": object_column([{"url": url + "/flaky",
                                               "body": "{}"}])})
        out = (HTTPTransformer().setInputCol("req").setOutputCol("resp")
               .setRetries(3).transform(df))
        assert out.col("resp")[0]["statusCode"] == 200
        assert hits == ["/missing", "/flaky", "/flaky"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_request_fault_site_fails_the_row_only(echo_server):
    faults.configure("http.request:error:1.0:0:1", seed=0)
    try:
        df = DataFrame({"data": object_column([{"x": 1}])})
        req = (JSONInputParser().setInputCol("data").setOutputCol("req")
               .setUrl(echo_server.url).transform(df))
        out = (HTTPTransformer().setInputCol("req").setOutputCol("resp")
               .setConcurrency(1).transform(req))
        assert out.col("resp")[0]["statusCode"] == 0
        again = (HTTPTransformer().setInputCol("req").setOutputCol("resp")
                 .transform(req))
        assert again.col("resp")[0]["statusCode"] == 200
    finally:
        faults.clear()


# ------------------------------------------------------------ PowerBI

class _Sink:
    """A local PowerBI endpoint: records each posted batch; answers 503 to
    the first ``fail`` posts."""

    def __init__(self, fail: int = 0):
        received, left = [], {"n": fail}
        self.received = received

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get(
                    "Content-Length", 0)))
                if left["n"] > 0:
                    left["n"] -= 1
                    self.send_response(503)
                    self.end_headers()
                    return
                received.append(json.loads(body))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}/"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_powerbi_write_batches():
    sink = _Sink()
    try:
        df = DataFrame({"a": np.arange(5.0), "b": np.arange(5)})
        assert powerbi.write(df, sink.url, batch_size=2) == 3
        assert sum(len(p["rows"]) for p in sink.received) == 5
        assert sink.received[0]["rows"][1] == {"a": 1.0, "b": 1}
    finally:
        sink.close()


def test_powerbi_non_2xx_raises_transient_and_retry_recovers():
    from mmlspark_tpu_torch.resilience.policy import RetryPolicy
    sink = _Sink(fail=1)
    try:
        df = DataFrame({"a": np.arange(2.0)})
        with pytest.raises(IOError, match="503") as ei:
            powerbi.write(df, sink.url)
        assert ei.value.transient
        policy = RetryPolicy(name="powerbi.test", max_attempts=3,
                             base_delay=0.0, max_delay=0.0)
        sink2 = _Sink(fail=1)
        try:
            assert powerbi.write(df, sink2.url, retry=policy) == 1
            assert len(sink2.received) == 1
        finally:
            sink2.close()
    finally:
        sink.close()


def test_powerbi_stream_writer():
    sink = _Sink()
    batches = [DataFrame({"a": np.arange(3.0)}), None,
               DataFrame({"a": np.arange(2.0)})]
    w = powerbi.stream(lambda: batches.pop(0) if batches else None,
                       sink.url, interval=0.05)
    deadline = time.monotonic() + 10
    while len(sink.received) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    w.stop()
    sink.close()
    assert [len(r["rows"]) for r in sink.received] == [3, 2]
    assert w.batches_sent == 2 and w.errors == 0


def test_powerbi_stream_retries_failed_batch():
    sink = _Sink(fail=2)
    batches = [DataFrame({"a": np.arange(4.0)})]
    w = powerbi.stream(lambda: batches.pop(0) if batches else None,
                       sink.url, interval=0.05)
    deadline = time.monotonic() + 10
    while not sink.received and time.monotonic() < deadline:
        time.sleep(0.05)
    w.stop()
    sink.close()
    assert len(sink.received) == 1 and len(sink.received[0]["rows"]) == 4
    assert w.errors == 2 and w.batches_sent == 1


# ------------------------------------------------------ distributed serving

def test_multi_worker_fleet():
    source, loop = serve_distributed(_Doubler(), n_workers=3, max_batch=32)
    try:
        assert len(set(source.urls)) == 3
        results = []

        def client(i):
            code, body, _ = _post(source.urls[i % 3], {"x": i})
            results.append((i, code, json.loads(body)["y"]))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(results) == [(i, 200, 2 * i) for i in range(12)]
    finally:
        loop.stop()


def test_distributed_error_path():
    source, loop = serve_distributed(_Boom(), n_workers=2)
    try:
        code, body, _ = _post(source.urls[0], {"x": 1})
        assert code == 500 and "kaput" in json.loads(body)["error"]
    finally:
        loop.stop()


def test_distributed_skewed_traffic_uses_full_budget():
    """All traffic on one worker: the idle workers' quota is handed over,
    so one getBatch collects every queued row."""
    source = DistributedHTTPSource(n_workers=4)
    try:
        results = []

        def client(i):
            results.append(json.loads(_post(source.urls[0], {"x": i},
                                            timeout=15)[1])["y"])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while (source.workers[0]._pending.qsize() < 32
               and time.monotonic() < deadline):
            time.sleep(0.05)
        batch = source.getBatch(64)
        assert batch.count() == 32
        for row in batch.iterRows():
            source.respond(row["id"], 200, json.dumps(
                {"y": json.loads(row["value"])["x"]}))
        for t in threads:
            t.join()
        assert sorted(results) == list(range(32))
    finally:
        source.close()


def test_shared_variable():
    SharedVariable.clear()
    calls = []
    a = SharedVariable.get("k", lambda: calls.append(1) or {"n": 0})
    b = SharedVariable.get("k", lambda: calls.append(1) or {"n": 0})
    assert a is b and len(calls) == 1
    inner = SharedVariable.get
    v = SharedVariable.get("outer",
                           lambda: {"dep": inner("inner", lambda: 41)})
    assert v["dep"] == 41
    SharedVariable.remove("k")
    assert SharedVariable.get("k", lambda: {"n": 1}) == {"n": 1}
    SharedVariable.clear()


# ------------------------------------------- the booster behind the loop

class _BoosterReplies(Transformer):
    """value (a JSON list of 28 floats) -> the booster's prediction and
    probability as the reply."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def transform(self, df):
        x = np.stack([np.asarray(json.loads(v), np.float32)
                      for v in df.col("value")])
        scored = self.model.transform(df.withColumn(
            "features", object_column(list(x))))
        return df.withColumn("reply", object_column(_replies(scored)))


def _replies(scored):
    return [json.dumps({"prediction": float(p),
                        "probability": np.asarray(q).tolist()})
            for p, q in zip(scored.col("prediction"),
                            scored.col("probability"))]


def test_serve_pipeline_over_a_levelwise_booster():
    """bench_gbdt.py's draws at a small size -> a level-wise booster on the
    CPU -> serve_pipeline: every reply equals transform's on its row, bit
    for bit, however the loop batched the requests."""
    from mmlspark_tpu_torch import LightGBMClassifier
    rng = np.random.default_rng(0)
    n, d = 512, 28
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = ((x[:, 0] * 2 + x[:, 1] - x[:, 2] * 0.5
          + rng.normal(0, 0.5, n)) > 0).astype(np.float32)
    model = LightGBMClassifier(numIterations=5, growthPolicy="depthwise",
                               device="cpu").fit(
        DataFrame({"features": object_column(list(x)), "label": y}))
    rows = x[:24]
    want = _replies(model.transform(DataFrame(
        {"features": object_column(list(rows))})))
    source, loop = serve_pipeline(_BoosterReplies(model), max_batch=8)
    try:
        got = [None] * len(rows)

        def client(i):
            got[i] = _post(source.url, rows[i].tolist())[1]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(rows))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert got == want
    finally:
        loop.stop()
        source.close()

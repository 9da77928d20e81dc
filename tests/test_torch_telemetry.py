"""The port's telemetry against the JAX package's.

* The registry, tracer, exposition, trace-context, merge, flight-recorder,
  snapshot-delta, time-series, SLO and straggler cases of
  tests/test_telemetry.py, tests/test_observability.py and
  tests/test_perf_observatory.py, run against ``mmlspark_tpu_torch.telemetry``
  (the cases that need ``io/http``, serving, the fleet, elastic training or
  ``perf/`` are left out: the port has none of them yet).
* The port's own design: span ``sync`` waits on one CUDA event per device
  and never on ``torch.cuda.synchronize``; the profiler counts FLOPs and
  bytes once per new signature (exact FLOP counts of small matmuls), adds
  the kernels' reported costs, keys its peak table on the card's name and
  reads NaN for a card it does not list.
* Parity: the same seeded inputs through both packages give the same
  metric families and counts and the same span names — a GBDT fit (256 x 4,
  3 iterations), a small MLP ``fit`` (``fit/step`` count, nesting inside
  ``fit``), and ``profile=True`` with ``sloConfig``, which fill the same
  gauges. Counts compare exactly; timings are not compared.
"""

import collections
import json
import logging
import math
import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import telemetry
from mmlspark_tpu_torch.telemetry import context
from mmlspark_tpu_torch.telemetry.registry import MetricsRegistry
from mmlspark_tpu_torch.telemetry.slo import (SLOEngine, SLOObjective,
                                              StepTimeAnomalyDetector)
from mmlspark_tpu_torch.telemetry.timeseries import (TimeSeriesSampler,
                                                     load_jsonl,
                                                     percentile_from_buckets)


@pytest.fixture
def tel():
    """Enabled telemetry with clean state; restores the disabled default."""
    telemetry.registry.reset()
    telemetry.trace.clear()
    telemetry.enable()
    yield telemetry
    telemetry.disable()
    telemetry.profiler.disable()
    telemetry.profiler.reset()
    telemetry.flight.disable()
    telemetry.flight.clear()
    telemetry.registry.reset()
    telemetry.trace.clear()


class TestRegistry:
    def test_counter_inc_and_identity(self, tel):
        c = tel.registry.counter("t_requests", "help text")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        # get-or-create: same family object on re-registration
        assert tel.registry.counter("t_requests") is c
        with pytest.raises(ValueError):
            c.inc(-1)
        with pytest.raises(ValueError):  # name/kind clash
            tel.registry.gauge("t_requests")

    def test_labels_are_independent_series(self, tel):
        c = tel.registry.counter("t_errs", "errs", labels=("worker",))
        c.labels(worker="0").inc()
        c.labels(worker="0").inc()
        c.labels(worker="1").inc(5)
        assert c.labels(worker="0").value == 2
        assert c.labels(worker="1").value == 5
        with pytest.raises(ValueError):
            c.labels(bogus="x")
        text = tel.registry.prometheus_text()
        assert 't_errs_total{worker="0"} 2' in text
        assert 't_errs_total{worker="1"} 5' in text

    def test_gauge(self, tel):
        g = tel.registry.gauge("t_depth")
        g.set(7)
        g.inc()
        g.dec(3)
        assert g.value == 5
        assert "t_depth 5" in tel.registry.prometheus_text()

    def test_histogram_buckets_sum_count(self, tel):
        h = tel.registry.histogram("t_lat", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v)
        assert h.count == 5
        assert h.sum == pytest.approx(56.05)
        cum = h.bucket_counts()
        assert cum[0.1] == 1 and cum[1.0] == 3 and cum[10.0] == 4
        assert cum[float("inf")] == 5
        text = tel.registry.prometheus_text()
        assert 't_lat_bucket{le="0.1"} 1' in text
        assert 't_lat_bucket{le="+Inf"} 5' in text
        assert "t_lat_count 5" in text
        # boundary value lands in its own bucket (le semantics)
        h2 = tel.registry.histogram("t_edge", buckets=(1.0,))
        h2.observe(1.0)
        assert h2.bucket_counts()[1.0] == 1

    def test_snapshot_is_jsonable(self, tel):
        tel.registry.counter("t_c").inc()
        tel.registry.histogram("t_h").observe(0.2)
        snap = json.loads(json.dumps(tel.snapshot()))
        assert snap["t_c"]["series"][0]["value"] == 1
        assert snap["t_h"]["series"][0]["count"] == 1

    def test_disabled_is_noop(self, tel):
        c = tel.registry.counter("t_off")
        h = tel.registry.histogram("t_off_h")
        g = tel.registry.gauge("t_off_g")
        tel.disable()
        c.inc()
        h.observe(1.0)
        g.set(9)
        with h.time():
            pass
        assert c.value == 0 and h.count == 0 and g.value == 0
        assert not tel.trace.events()
        with tel.trace.span("never"):
            pass
        assert tel.trace.events() == []

    def test_thread_safety(self, tel):
        c = tel.registry.counter("t_mt")
        h = tel.registry.histogram("t_mt_h", buckets=(0.5,))

        def work():
            for _ in range(1000):
                c.inc()
                h.observe(0.1)

        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert c.value == 8000
        assert h.count == 8000
        assert h.bucket_counts()[0.5] == 8000


# ------------------------------------------------------------------ tracer

class TestTracer:
    def test_span_nesting_and_roundtrip(self, tel, tmp_path):
        with tel.trace.span("outer", kind="test"):
            with tel.trace.span("inner", step=1):
                time.sleep(0.002)
        path = str(tmp_path / "trace.jsonl")
        n = tel.trace.export_chrome_trace(path)
        assert n == 2
        evs = [json.loads(line) for line in open(path)]
        by_name = {e["name"]: e for e in evs}
        inner, outer = by_name["inner"], by_name["outer"]
        for e in evs:
            assert e["ph"] == "X" and "pid" in e and "tid" in e
        # time containment = nesting in chrome://tracing / Perfetto
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
        assert inner["args"]["step"] == 1
        assert outer["args"]["kind"] == "test"

    def test_array_export_is_valid_json(self, tel, tmp_path):
        with tel.trace.span("a"):
            pass
        path = str(tmp_path / "trace.json")
        tel.trace.export_chrome_trace(path, array=True)
        evs = json.loads(open(path).read())
        assert [e["name"] for e in evs] == ["a"]

    def test_buffer_is_bounded(self, tel):
        small = telemetry.Tracer(max_events=10)
        from mmlspark_tpu_torch.telemetry.registry import _state
        assert _state.enabled
        for i in range(50):
            with small.span("s", i=i):
                pass
        evs = small.events()
        assert len(evs) == 10
        assert evs[-1]["args"]["i"] == 49


class TestSpanContext:
    def test_traceparent_round_trip(self):
        ctx = context.new_trace()
        assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
        parsed = context.parse_traceparent(ctx.to_traceparent())
        assert parsed == ctx

    def test_malformed_headers_are_none(self):
        for bad in (None, "", "garbage", "00-abc-def-01",
                    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",   # zero trace
                    "00-" + "z" * 32 + "-" + "1" * 16 + "-01"):  # non-hex
            assert context.parse_traceparent(bad) is None

    def test_child_keeps_trace_new_span(self):
        ctx = context.new_trace()
        child = ctx.child()
        assert child.trace_id == ctx.trace_id
        assert child.span_id != ctx.span_id

    def test_use_installs_and_restores(self):
        assert context.current() is None
        ctx = context.new_trace()
        with context.use(ctx):
            assert context.current() == ctx
            with context.use(context.new_trace()):
                assert context.current() != ctx
            assert context.current() == ctx
        assert context.current() is None
        # raw header + None both accepted
        with context.use(ctx.to_traceparent()):
            assert context.current() == ctx
        with context.use(None):
            assert context.current() is None

    def test_spans_tag_and_parent_under_context(self, tel):
        ctx = context.new_trace()
        with context.use(ctx):
            with tel.trace.span("outer"):
                with tel.trace.span("inner"):
                    pass
            tel.trace.instant("mark")
        evs = {e["name"]: e["args"] for e in tel.trace.events()}
        assert evs["outer"]["trace_id"] == ctx.trace_id
        assert evs["outer"]["parent_span_id"] == ctx.span_id
        assert evs["inner"]["parent_span_id"] == evs["outer"]["span_id"]
        assert evs["mark"]["trace_id"] == ctx.trace_id

    def test_span_without_context_stays_plain(self, tel):
        with tel.trace.span("plain"):
            pass
        (ev,) = tel.trace.events()
        assert "trace_id" not in ev.get("args", {})

    def test_complete_records_explicit_duration_child(self, tel):
        ctx = context.new_trace()
        t0 = time.perf_counter_ns()
        time.sleep(0.003)
        tel.trace.complete("hop", t0, parent=ctx.to_traceparent(), code=200)
        (ev,) = tel.trace.events()
        assert ev["ph"] == "X" and ev["dur"] >= 2000
        assert ev["args"]["parent_span_id"] == ctx.span_id
        assert ev["args"]["code"] == 200


class TestMergeTraces:
    def test_merge_and_filter(self, tel, tmp_path):
        ctx = context.new_trace()
        with context.use(ctx), tel.trace.span("a"):
            pass
        p1 = str(tmp_path / "p1.jsonl")
        tel.trace.export_chrome_trace(p1)
        tel.trace.clear()
        with tel.trace.span("unrelated"):
            pass
        with context.use(ctx.child()), tel.trace.span("b"):
            pass
        p2 = str(tmp_path / "p2.json")
        tel.trace.export_chrome_trace(p2, array=True)   # both forms load
        merged = telemetry.merge_traces([p1, p2],
                                        str(tmp_path / "merged.jsonl"))
        assert {e["name"] for e in merged} == {"a", "unrelated", "b"}
        only = telemetry.merge_traces([p1, p2], trace_id=ctx.trace_id)
        assert {e["name"] for e in only} == {"a", "b"}
        # merged file is valid JSONL
        lines = [json.loads(line)
                 for line in open(tmp_path / "merged.jsonl")]
        assert len(lines) == 3


class TestRetryInstants:
    def test_retry_instants_tag_owning_trace(self, tel):
        from mmlspark_tpu_torch.resilience.policy import RetryPolicy
        ctx = context.new_trace()
        calls = {"n": 0}

        def flaky(_a):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ConnectionError("blip")
            return "ok"
        with context.use(ctx):
            assert RetryPolicy(name="t.obs", base_delay=0.0,
                               max_delay=0.0).run(flaky) == "ok"
        retries = [e for e in tel.trace.events() if e["name"] == "retry"]
        assert retries
        assert retries[0]["args"]["trace_id"] == ctx.trace_id


class TestFlightRecorder:
    def test_note_and_metric_delta_samples(self, tel):
        telemetry.flight.enable()
        telemetry.flight.note("supervisor_verdict", worker=0, dead=True)
        c = tel.registry.counter("t_obs_flight_c")
        c.inc(5)
        # force a second sample window
        telemetry.flight._last_sample = 0.0
        telemetry.flight.note("later")
        b = telemetry.flight.bundle()
        notes = [e for e in b["events"] if e["kind"] == "note"]
        assert notes and notes[0]["name"] == "supervisor_verdict"
        deltas = [e for e in b["events"] if e["kind"] == "metrics"]
        assert any(d["delta"].get("t_obs_flight_c") == 5 for d in deltas)

    def test_excepthook_chain_dumps_then_delegates(self, tel, tmp_path):
        import sys
        telemetry.flight.enable(str(tmp_path))
        called = {}
        prev = sys.excepthook
        telemetry.flight._prev_excepthook = \
            lambda *a: called.setdefault("prev", a)
        try:
            telemetry.flight._excepthook(ValueError, ValueError("boom"),
                                         None)
        finally:
            sys.excepthook = prev
        assert called["prev"][0] is ValueError
        doc = json.loads(
            open(tmp_path / f"flight_{telemetry.flight.bundle()['pid']}"
                            ".json").read())
        assert doc["reason"] == "excepthook"
        assert any(e.get("name") == "unhandled_exception"
                   for e in doc["events"])

    def test_flight_env_parsing(self, monkeypatch):
        from mmlspark_tpu_torch.core import env
        monkeypatch.delenv("MMLSPARK_TPU_FLIGHT", raising=False)
        assert env.flight_path() is None
        monkeypatch.setenv("MMLSPARK_TPU_FLIGHT", "0")
        assert env.flight_path() is None
        monkeypatch.setenv("MMLSPARK_TPU_FLIGHT", "1")
        assert env.flight_path() == ""
        monkeypatch.setenv("MMLSPARK_TPU_FLIGHT", "/tmp/flightdir")
        assert env.flight_path() == "/tmp/flightdir"


class TestExpositionCorrectness:
    def test_label_values_escaped(self, tel):
        c = tel.registry.counter("t_obs_esc", "esc", labels=("k",))
        c.labels(k='a"b\\c\nd').inc()
        text = tel.registry.prometheus_text()
        line = [l for l in text.splitlines()
                if l.startswith("t_obs_esc_total")][0]
        assert line == 't_obs_esc_total{k="a\\"b\\\\c\\nd"} 1'
        # the exposition stays line-parseable
        assert "\nd" not in line

    def test_histogram_boundary_le_semantics(self, tel):
        """A value equal to a bucket bound lands in the bucket whose
        ``le`` it equals (Prometheus <= semantics), for every bound."""
        h = tel.registry.histogram("t_obs_edge", buckets=(0.1, 1.0, 10.0))
        for v in (0.1, 1.0, 10.0):
            h.observe(v)
        cum = h.bucket_counts()
        assert cum[0.1] == 1          # 0.1 <= 0.1
        assert cum[1.0] == 2          # cumulative: 0.1 and 1.0
        assert cum[10.0] == 3
        assert cum[float("inf")] == 3
        # just past a bound goes one bucket up; under stays put
        h2 = tel.registry.histogram("t_obs_edge2", buckets=(1.0, 2.0))
        h2.observe(1.0000001)
        h2.observe(0.9999999)
        cum2 = h2.bucket_counts()
        assert cum2[1.0] == 1 and cum2[2.0] == 2
        # exposition agrees
        text = tel.registry.prometheus_text()
        assert 't_obs_edge_bucket{le="0.1"} 1' in text

    def test_tracer_drop_counter_and_truncated_metadata(self, tel,
                                                        tmp_path):
        small = telemetry.Tracer(max_events=5)
        for i in range(9):
            with small.span("s", i=i):
                pass
        assert small.dropped() == 4
        assert tel.registry.counter(
            "mmlspark_telemetry_events_dropped").value == 4
        path = str(tmp_path / "trunc.jsonl")
        n = small.export_chrome_trace(path)
        evs = [json.loads(line) for line in open(path)]
        assert n == len(evs) == 6    # 5 events + 1 metadata
        meta = evs[0]
        assert meta["ph"] == "M"
        assert meta["args"] == {"truncated": True, "dropped": 4}
        # an un-truncated tracer exports no metadata event
        ok = telemetry.Tracer(max_events=50)
        with ok.span("fine"):
            pass
        path2 = str(tmp_path / "ok.jsonl")
        ok.export_chrome_trace(path2)
        evs2 = [json.loads(line) for line in open(path2)]
        assert all(e["ph"] != "M" for e in evs2)
        # clear resets the drop accounting
        small.clear()
        assert small.dropped() == 0


class TestSnapshotDelta:
    def test_changed_families_only(self, tel):
        reg = MetricsRegistry()
        a = reg.counter("t_sd_a", "a")
        b = reg.counter("t_sd_b", "b")
        a.inc()
        b.inc(2)
        changed, token = reg.snapshot_delta(None)
        assert {"t_sd_a", "t_sd_b"} <= set(changed)
        # quiet tick: nothing changed, nothing rebuilt
        changed2, token2 = reg.snapshot_delta(token)
        assert changed2 == {}
        assert token2 == token
        # one write -> exactly that family comes back
        a.inc(3)
        changed3, _ = reg.snapshot_delta(token2)
        assert set(changed3) == {"t_sd_a"}
        assert changed3["t_sd_a"]["series"][0]["value"] == 4

    def test_labeled_series_and_histograms(self, tel):
        reg = MetricsRegistry()
        c = reg.counter("t_sd_lab", "l", labels=("k",))
        h = reg.histogram("t_sd_h", "h", buckets=(1.0, 2.0))
        _, token = reg.snapshot_delta(None)
        c.labels(k="x").inc()
        h.observe(1.5)
        changed, _ = reg.snapshot_delta(token)
        assert set(changed) == {"t_sd_lab", "t_sd_h"}

    def test_reset_is_a_change(self, tel):
        reg = MetricsRegistry()
        c = reg.counter("t_sd_r", "r")
        c.inc(5)
        _, token = reg.snapshot_delta(None)
        reg.reset()
        changed, _ = reg.snapshot_delta(token)
        assert changed["t_sd_r"]["series"][0]["value"] == 0


# ------------------------------------------------------------- time series

class TestTimeSeries:
    def _sampler(self, capacity=600):
        reg = MetricsRegistry()
        return reg, TimeSeriesSampler(registry=reg, capacity=capacity)

    def test_exposition_keys(self, tel):
        reg, ts = self._sampler()
        reg.counter("t_ts_c", "c").inc()
        reg.gauge("t_ts_g", "g").set(7)
        reg.histogram("t_ts_h", "h", buckets=(1.0,)).observe(0.5)
        reg.counter("t_ts_l", "l", labels=("w",)).labels(w="0").inc()
        ts.tick(now=1.0)
        keys = set(ts.keys())
        assert "t_ts_c_total" in keys           # counter suffix
        assert "t_ts_g" in keys                 # gauge bare
        assert {"t_ts_h_count", "t_ts_h_sum"} <= keys
        assert 't_ts_h_bucket{le="1"}' in keys
        assert 't_ts_h_bucket{le="+Inf"}' in keys
        assert 't_ts_l_total{w="0"}' in keys    # labels render

    def test_ring_eviction(self, tel):
        reg, ts = self._sampler(capacity=3)
        c = reg.counter("t_ts_ring", "r")
        for i in range(5):
            c.inc()
            ts.tick(now=float(i))
        pts = ts.series("t_ts_ring_total")
        # oldest two dropped; survivors keep (t, cumulative) order
        assert pts == [(2.0, 3.0), (3.0, 4.0), (4.0, 5.0)]

    def test_quiet_series_not_reappended(self, tel):
        reg, ts = self._sampler()
        c = reg.counter("t_ts_q", "q")
        c.inc()
        ts.tick(now=1.0)
        ts.tick(now=2.0)    # no writes: no new point
        assert len(ts.series("t_ts_q_total")) == 1

    def test_window_delta_and_value_at(self, tel):
        reg, ts = self._sampler()
        c = reg.counter("t_ts_w", "w")
        for t, inc in ((0.0, 1), (10.0, 2), (20.0, 4)):
            c.inc(inc)
            ts.tick(now=t)
        key = "t_ts_w_total"
        assert ts.value_at(key, 15.0) == 3.0            # carry-forward
        assert ts.value_at(key, -1.0) is None
        assert ts.window_delta(key, 10.0, now=20.0) == 4.0
        assert ts.window_delta(key, 100.0, now=20.0) == 6.0  # partial
        assert ts.window_delta(key, 5.0, now=-5.0) is None

    def test_series_born_mid_sampling_baseline_is_zero(self, tel):
        """A labeled child minted by its first write (the first 500
        reply ever) must show its whole first burst in a window delta —
        its value before birth was 0 — while a series that predates the
        sampler keeps the earliest-point baseline (its pre-sampling
        history is unknown)."""
        reg, ts = self._sampler()
        c = reg.counter("t_ts_b", "b", labels=("code",))
        c.labels(code="200").inc()
        ts.tick(now=0.0)                 # seeds the 200 series
        c.labels(code="500").inc(4)      # born mid-sampling
        ts.tick(now=31.0)
        k200 = 't_ts_b_total{code="200"}'
        k500 = 't_ts_b_total{code="500"}'
        # seeded + window predating the first tick: earliest point
        # stands in (no phantom +1 burst at sampler startup)
        assert ts.window_delta(k200, 100.0, now=31.0) == 0.0
        # born mid-sampling: baseline 0, the burst is fully visible
        assert ts.window_delta(k500, 5.0, now=31.0) == 4.0

    def test_jsonl_round_trip(self, tel, tmp_path):
        reg, ts = self._sampler()
        c = reg.counter("t_ts_io", "io")
        g = reg.gauge("t_ts_io_g", "g")
        for t in (1.0, 2.0, 3.0):
            c.inc()
            g.set(t * 10)
            ts.tick(now=t)
        path = str(tmp_path / "ts.jsonl")
        n = ts.export_jsonl(path)
        assert n == len(ts.keys())
        loaded = load_jsonl(path)
        assert loaded["t_ts_io_total"] == [(1.0, 1.0), (2.0, 2.0),
                                           (3.0, 3.0)]
        assert loaded["t_ts_io_g"][-1] == (3.0, 30.0)

    def test_snapshot_schema(self, tel):
        reg, ts = self._sampler()
        reg.counter("t_ts_s", "s").inc()
        ts.tick(now=1.0)
        doc = ts.snapshot()
        assert doc["schema"] == "mmlspark-timeseries/v1"
        assert doc["series"]["t_ts_s_total"] == [[1.0, 1.0]]

    def test_percentile_from_buckets(self):
        # cumulative deltas: 90 at <=0.1, 99 at <=1.0, 100 total
        deltas = {"0.1": 90.0, "1.0": 99.0, "+Inf": 100.0}
        assert percentile_from_buckets(deltas, 0.5) == 0.1
        assert percentile_from_buckets(deltas, 0.99) == 1.0
        assert percentile_from_buckets(deltas, 1.0) == float("inf")
        assert percentile_from_buckets({}, 0.5) is None


# ------------------------------------------------------------ SLO objectives

class TestSLOEngine:
    def _world(self):
        reg = MetricsRegistry()
        ts = TimeSeriesSampler(registry=reg)
        eng = SLOEngine([{
            "name": "errors", "kind": "error_rate",
            "bad": "t_slo_bad_total",
            "total": "t_slo_requests_total",
            "target": 0.9,              # 10% error budget
            "windows": [10.0, 60.0],
        }], sampler=ts)
        reg.counter("t_slo_bad", "bad")
        total = reg.counter("t_slo_requests", "total")
        return reg, ts, eng, total

    def test_spec_validation(self):
        with pytest.raises(ValueError, match="unknown kind"):
            SLOObjective("x", "nope")
        with pytest.raises(ValueError, match="missing"):
            SLOObjective("x", "error_rate", bad="b", total="t")
        with pytest.raises(ValueError, match="windows"):
            SLOObjective("x", "latency", windows=(60, 60), hist="h",
                         threshold_s=0.1, target=0.99)
        with pytest.raises(ValueError, match="duplicate"):
            SLOEngine([
                {"name": "a", "kind": "step_time", "hist": "h",
                 "budget_s": 1.0},
                {"name": "a", "kind": "step_time", "hist": "h",
                 "budget_s": 2.0}])

    def test_burn_breach_and_recovery(self, tel):
        reg, ts, eng, total = self._world()
        bad = reg.counter("t_slo_bad", "bad")
        telemetry.flight.enable()
        try:
            # healthy traffic fills both windows
            for t in (0.0, 30.0, 60.0):
                total.inc(100)
                ts.tick(now=t)
            r = eng.evaluate(now=60.0)
            assert r["errors"]["state"] == "ok"
            # an error burst: 50% errors vs a 10% budget burns both the
            # fast (10s) and slow (60s) windows -> breach transition
            total.inc(100)
            bad.inc(50)
            ts.tick(now=65.0)
            r = eng.evaluate(now=65.0)
            assert r["errors"]["state"] == "breach"
            assert r["errors"]["burn_fast"] > 1.0
            assert r["errors"]["burn_slow"] > 1.0
            assert eng.breached() == {"errors"}
            # the transition surfaced as a trace instant + flight note
            names = [e.get("name") for e in telemetry.trace.events()]
            assert "slo/breach" in names
            kinds = [e for e in telemetry.flight.bundle()["events"]
                     if e.get("kind") == "note"
                     and e.get("name") == "slo/breach"]
            assert kinds
            # quiet recovery: the fast window clears first, then the slow
            for t in (120.0, 125.0, 130.0):
                total.inc(200)
                ts.tick(now=t)
            r = eng.evaluate(now=130.0)
            assert r["errors"]["state"] == "ok"
            assert eng.breached() == set()
            assert eng.breached_ever() == {"errors"}
            names = [e.get("name") for e in telemetry.trace.events()]
            assert "slo/recover" in names
        finally:
            telemetry.flight.disable()
            telemetry.flight.clear()

    def test_one_window_burning_is_not_breach(self, tel):
        reg, ts, eng, total = self._world()
        bad = reg.counter("t_slo_bad", "bad")
        # a long healthy history, then a SHORT blip: the fast window
        # burns, the slow window absorbs it -> "burning", no alert
        for t in (0.0, 20.0, 40.0, 49.0):
            total.inc(250)
            ts.tick(now=t)
        total.inc(10)
        bad.inc(5)
        ts.tick(now=60.0)
        r = eng.evaluate(now=60.0)
        assert r["errors"]["state"] == "burning"
        assert eng.breached() == set()

    def test_latency_and_step_time_kinds(self, tel):
        reg = MetricsRegistry()
        ts = TimeSeriesSampler(registry=reg)
        h = reg.histogram("t_slo_lat", "lat", buckets=(0.1, 0.5, 1.0))
        eng = SLOEngine([
            {"name": "p99", "kind": "latency", "hist": "t_slo_lat",
             "threshold_s": 0.5, "target": 0.9, "windows": [10, 60]},
            {"name": "step", "kind": "step_time", "hist": "t_slo_lat",
             "budget_s": 0.3, "windows": [10, 60]},
        ], sampler=ts)
        ts.tick(now=0.0)        # zero baseline for every series
        for _ in range(95):
            h.observe(0.05)
        for _ in range(5):
            h.observe(0.8)
        ts.tick(now=5.0)
        r = eng.evaluate(now=5.0)
        # 5% slow vs a 10% budget: under
        assert r["p99"]["state"] == "ok"
        assert 0 < r["p99"]["burn_fast"] < 1.0
        # mean ~0.0875s vs 0.3s budget: well under
        assert r["step"]["state"] == "ok"
        # now a slow burst pushes both
        for _ in range(50):
            h.observe(0.8)
        ts.tick(now=8.0)
        r = eng.evaluate(now=8.0)
        assert r["p99"]["state"] == "breach"
        assert r["p99"]["burn_fast"] > 1.0

    def test_goodput_kind(self, tel):
        reg = MetricsRegistry()
        ts = TimeSeriesSampler(registry=reg)
        c = reg.counter("t_slo_rows", "rows")
        eng = SLOEngine([{
            "name": "goodput", "kind": "goodput",
            "series": "t_slo_rows_total", "min": 10.0,    # rows/sec
            "windows": [10, 60]}], sampler=ts)
        c.inc(1)
        ts.tick(now=0.0)
        c.inc(200)                      # 20/s over the 10s fast window
        ts.tick(now=10.0)
        r = eng.evaluate(now=10.0)
        assert r["goodput"]["burn_fast"] == pytest.approx(0.5)
        c.inc(10)                       # 1/s: half the floor -> burn 10
        ts.tick(now=20.0)
        r = eng.evaluate(now=20.0)
        assert r["goodput"]["burn_fast"] == pytest.approx(10.0)

    def test_from_config_and_should_shed(self, tel):
        reg = MetricsRegistry()
        ts = TimeSeriesSampler(registry=reg)
        cfg = json.dumps({"objectives": [
            {"name": "errors", "kind": "error_rate",
             "bad": "t_slo_bad_total", "total": "t_slo_requests_total",
             "target": 0.9, "windows": [10, 60],
             "shed_on_breach": True}]})
        eng = SLOEngine.from_config(cfg, sampler=ts)
        total = reg.counter("t_slo_requests", "total")
        bad = reg.counter("t_slo_bad", "bad")
        total.inc(10)
        bad.inc(9)
        ts.tick(now=0.0)
        ts2 = 5.0
        total.inc(10)
        bad.inc(9)
        ts.tick(now=ts2)
        eng.evaluate(now=ts2)
        assert eng.should_shed()
        hz = eng.healthz()
        assert hz["ok"] is False
        assert hz["objectives"]["errors"]["state"] == "breach"


# ----------------------------------------------------- straggler detection

class TestStragglerDetection:
    def test_synthetic_straggler_flagged(self):
        det = StepTimeAnomalyDetector(min_samples=8)
        rng = np.random.default_rng(0)
        for _ in range(32):
            for h in ("host0", "host1", "host2", "host3"):
                base = 0.30 if h == "host2" else 0.10
                det.observe(h, base + rng.normal(0, 0.002))
        assert det.stragglers() == {"host2"}
        rep = det.report()
        assert rep["stragglers"] == ["host2"]
        assert rep["host_median_s"]["host2"] > rep["host_median_s"]["host0"]

    def test_uniform_fleet_is_quiet(self):
        det = StepTimeAnomalyDetector(min_samples=8)
        rng = np.random.default_rng(1)
        for _ in range(32):
            for h in ("host0", "host1", "host2", "host3"):
                det.observe(h, 0.1 + rng.normal(0, 0.005))
        assert det.stragglers() == set()

    def test_min_samples_gate(self):
        det = StepTimeAnomalyDetector(min_samples=8)
        for h, v in (("a", 0.1), ("b", 10.0)):
            for _ in range(4):              # below min_samples
                det.observe(h, v)
        assert det.stragglers() == set()
        # bad samples (negative, NaN) are dropped at the door
        det.observe("a", -1.0)
        det.observe("a", float("nan"))
        assert len(det.report()["host_median_s"]) == 0


class TestSamplerLifecycle:
    def test_sampler_lifecycle(self, tel):
        """start() is idempotent, arms telemetry, and stop() joins."""
        ts = TimeSeriesSampler(interval=0.01)
        telemetry.disable()
        try:
            ts.start()
            assert ts.running
            assert telemetry.enabled()      # arming enables telemetry
            ts.start()                      # idempotent
            ts.stop()
            assert not ts.running
        finally:
            ts.stop()
            telemetry.enable()              # hand back to the fixture


class TestEnvWiring:
    def test_env_switch(self, monkeypatch):
        from mmlspark_tpu_torch.core import env
        monkeypatch.delenv("MMLSPARK_TPU_TELEMETRY", raising=False)
        assert not env.telemetry_enabled()
        for v in ("1", "true", "YES", "on"):
            monkeypatch.setenv("MMLSPARK_TPU_TELEMETRY", v)
            assert env.telemetry_enabled()
        monkeypatch.setenv("MMLSPARK_TPU_TELEMETRY", "0")
        assert not env.telemetry_enabled()
        monkeypatch.setenv("MMLSPARK_TPU_TRACE", "/tmp/x.jsonl")
        assert env.telemetry_trace_path() == "/tmp/x.jsonl"


# ------------------------------------------------------ the port's own design

class _FakeCuda:
    """Stands for a CUDA tensor: what ``tracer.wait_for`` reads of one."""
    is_cuda = True

    def __init__(self, dev):
        self.device = dev


class TestTorchSync:
    def test_cpu_tensors_need_no_wait(self, tel, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("waited on a CPU tensor")
        monkeypatch.setattr(torch.cuda, "Event", boom)
        with tel.trace.span("compute") as sp:
            sp.set_sync({"a": torch.arange(8).sum(), "b": [torch.ones(2)]})
        (ev,) = tel.trace.events()
        assert ev["name"] == "compute"

    def test_waits_on_one_event_per_device_never_the_device(self, tel,
                                                          monkeypatch):
        log = []

        class Event:
            def record(self, stream):
                log.append(("record", stream))

            def synchronize(self):
                log.append(("sync",))

        def no_device_wide(*a, **k):
            raise AssertionError("torch.cuda.synchronize stalls the device")
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev: f"stream-of-{dev}")
        monkeypatch.setattr(torch.cuda, "synchronize", no_device_wide)
        value = (_FakeCuda("cuda:0"), [_FakeCuda("cuda:0"),
                                       _FakeCuda("cuda:1")], torch.ones(1))
        with tel.trace.span("step", sync=value):
            pass
        assert sorted(log) == [("record", "stream-of-cuda:0"),
                               ("record", "stream-of-cuda:1"),
                               ("sync",), ("sync",)]

    def test_disabled_span_never_waits(self, tel, monkeypatch):
        tel.disable()
        monkeypatch.setattr(torch.cuda, "Event", None)
        with tel.trace.span("off", sync=_FakeCuda("cuda:0")):
            pass
        assert tel.trace.events() == []


class TestProfiler:
    def test_signatures_counted_once_with_cause(self, tel):
        prof = telemetry.profiler
        prof.enable()
        pf = prof.wrap(lambda a: (a @ a.T).sum(), "t.obs.fn")
        pf(torch.ones((8, 8)))
        assert pf.cost["flops"] == 2 * 8 * 8 * 8      # one 8x8x8 matmul
        pf(torch.ones((8, 8)))                        # cached signature
        pf(torch.ones((16, 16)))                      # shape change
        pf(torch.ones((16, 16), dtype=torch.float64))  # dtype change
        rep = prof.report()["functions"]["t.obs.fn"]
        assert rep["compiles"] == 3
        assert rep["recompile_causes"] == {"first": 1, "shape_change": 1,
                                           "dtype_change": 1}
        assert rep["flops_per_call"] == 2 * 16 ** 3
        assert rep["bytes_per_call"] > 16 * 16 * 8
        assert rep["compile_seconds"] > 0
        assert rep["calls"] == 4
        assert rep["achieved_flops_per_sec"] > 0
        assert 0 < rep["roofline_utilization"] < 1
        snap = telemetry.snapshot()
        by_cause = {s["labels"]["cause"]: s["value"]
                    for s in snap["mmlspark_profiler_compiles"]["series"]
                    if s["labels"]["fn"] == "t.obs.fn"}
        assert by_cause == {"first": 1, "shape_change": 1,
                            "dtype_change": 1}
        assert any(e["name"] == "fit/compile" for e in tel.trace.events())

    def test_backward_flops_are_counted(self, tel):
        telemetry.profiler.enable()
        w = torch.ones((4, 6), requires_grad=True)

        def step(x):
            (x @ w).sum().backward()
            return w.grad
        pf = telemetry.profiler.wrap(step, "t.obs.bwd")
        pf(torch.ones((5, 4)))
        # forward 2*5*4*6, and the weight gradient's matmul of the same size
        assert pf.cost["flops"] == 2 * (2 * 5 * 4 * 6)

    def test_kernel_notes_join_the_running_count(self, tel):
        prof = telemetry.profiler
        prof.enable()
        prof.note_kernel(1e9, 1e9)          # no count running: dropped

        def fn(x):
            prof.note_kernel(100.0, 200.0)
            return x + 1
        pf = prof.wrap(fn, "t.obs.kernel")
        pf(torch.zeros(4))
        assert pf.cost["flops"] == 100.0
        assert pf.cost["bytes"] >= 200.0 + 2 * 4 * 4
        assert prof._counts == []

    def test_attention_forward_cost_matches_the_plain_matmuls(self, tel):
        """The forward kernel's analytic FLOPs equal what FlopCounterMode
        counts of the plain version's two matmuls (no mask: every pair)."""
        from mmlspark_tpu_torch.ops import flash_attention as fa
        B, T, H, D = 2, 5, 3, 4
        q, k, v = (torch.randn(B, T, H, D) for _ in range(3))
        _, cost = telemetry.profiler.count_call(
            fa.flash_attention_reference, (q, k, v))
        flops, _ = fa.attention_costs(B, H, T, T, D, False, 4)["fwd"]
        assert cost["flops"] == flops
        assert fa.visible_pairs(5, 5, True) == 15
        assert fa.visible_pairs(7, 3, True) == sum(min(i + 1, 3)
                                                   for i in range(7))
        assert fa.visible_pairs(3, 7, True) == 6

    def test_live_buffer_gauge_on_the_cpu(self, tel):
        prof = telemetry.profiler
        prof.enable()
        keep = torch.ones((256, 256))
        assert prof.sample_live_buffers("cpu", keep) == keep.nbytes
        assert prof.report()["live_buffer_peak_bytes"] >= keep.nbytes

    def test_disabled_is_passthrough(self, tel):
        prof = telemetry.profiler
        assert not prof.enabled()
        pf = prof.wrap(lambda a: a + 1, "t.obs.off")
        assert pf(torch.zeros(4)).shape == (4,)
        assert prof.sample_live_buffers("cpu", torch.zeros(4)) == 0.0
        assert "t.obs.off" not in prof.report()["functions"]

    def test_peak_table_is_the_h100_alone(self, monkeypatch):
        prof = telemetry.profiler
        assert prof._PEAK_BY_NAME == {"NVIDIA H100": 989e12}
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev=None: "NVIDIA H100 80GB HBM3")
        assert prof.peak_flops("cuda") == 989e12
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev=None: "NVIDIA A100-SXM4-80GB")
        assert math.isnan(prof.peak_flops("cuda"))     # no guess
        prof.set_peak_flops(312e12)
        try:
            assert prof.peak_flops("cuda") == 312e12
        finally:
            prof.set_peak_flops(None)
        assert prof.peak_flops("cpu") > 0

    def test_learner_profile_param(self, tel):
        """TorchLearner(profile=True): the fit's dispatches run through
        the profiler — signatures, FLOPs, the memory peak."""
        from mmlspark_tpu_torch.models.trainer import TorchLearner
        df, _ = _mlp_frames()
        TorchLearner(**_MLP, profile=True).fit(df)
        rep = telemetry.profiler.report()
        (tag,) = [t for t in rep["functions"] if t.startswith("trainer.")]
        fn = rep["functions"][tag]
        assert tag == "trainer.scan_epoch"
        assert fn["compiles"] == 1 and fn["calls"] == 2
        # 64 rows x 2 epochs of an 8->8->2 MLP: forward 2*64*(64+16) FLOPs
        # an epoch, backward the same plus the hidden layer's input grad
        assert fn["flops_per_call"] == 2 * 64 * (8 * 8 + 8 * 2) * 3 \
            - 2 * 64 * 8 * 8
        assert rep["live_buffer_peak_bytes"] > 0


# ------------------------------------------------------ instrumented paths

def _mlp_frames(n=64, seed=0):
    from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.utils import object_column
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.int64)
    cols = lambda: {"features": object_column(list(x.copy())),  # noqa: E731
                    "label": y.copy()}
    return DataFrame(cols()), JaxDataFrame(cols())


_MLP = dict(modelConfig={"type": "mlp", "hidden": [8], "num_classes": 2},
            epochs=2, batchSize=32, device="cpu")


def _names(events) -> collections.Counter:
    return collections.Counter(e["name"] for e in events)


def _nested_in(outer, inner) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


class TestInstrumentationSmoke:
    def test_trainer_fit_populates_metrics_and_trace(self, tel, tmp_path):
        from mmlspark_tpu_torch.models.trainer import TorchLearner
        df, _ = _mlp_frames()
        TorchLearner(**_MLP).fit(df)
        snap = telemetry.snapshot()
        assert snap["mmlspark_trainer_step_seconds"]["series"][0][
            "count"] == 2
        assert snap["mmlspark_trainer_rows_per_sec"]["series"][0][
            "value"] > 0
        assert snap["mmlspark_trainer_transfer_bytes"]["series"][0][
            "value"] > 0
        path = str(tmp_path / "fit_trace.jsonl")
        telemetry.trace.export_chrome_trace(path)
        evs = [json.loads(line) for line in open(path)]
        fit = next(e for e in evs if e["name"] == "fit")
        inner = [e for e in evs if e["name"].startswith("fit/")]
        assert {e["name"] for e in inner} >= {"fit/step", "fit/epoch",
                                              "fit/upload"}
        assert all(_nested_in(fit, e) for e in inner)

    def test_feed_path_prefetch_metrics_and_spans(self, tel):
        from mmlspark_tpu_torch.models import trainer as tr
        tr._seen_step_sigs.clear()
        df, _ = _mlp_frames()
        tr.TorchLearner(**_MLP, deviceDataCap=1, prefetchDepth=2).fit(df)
        snap = telemetry.snapshot()
        steps = snap["mmlspark_trainer_step_seconds"]["series"][0]["count"]
        assert steps == 4
        assert snap["mmlspark_prefetch_produce_seconds"]["series"][0][
            "count"] == 4
        assert snap["mmlspark_prefetch_consumer_stall_seconds"]["series"][
            0]["count"] == 4
        # one (32, 8) / (32,) batch signature for the whole fit
        assert snap["mmlspark_trainer_recompiles"]["series"][0][
            "value"] == 1
        names = _names(telemetry.trace.events())
        # the producer's span also covers its last call, which ends the
        # source (as in the JAX package)
        assert names["fit/step"] == 4 and names["fit/prefetch"] == 5

    def test_trainer_recompile_counter(self, tel):
        from mmlspark_tpu_torch.models import trainer as tr
        tr._seen_step_sigs.clear()
        base = tr._m_recompiles.value
        a = np.zeros((8, 4), np.float32)
        tr._note_step_signature("t", a, a)
        tr._note_step_signature("t", a, a)          # same shapes: no bump
        tr._note_step_signature("t", np.zeros((16, 4), np.float32), a)
        assert tr._m_recompiles.value == base + 2

    def test_mixed_precision_loss_scale_gauge(self, tel):
        from mmlspark_tpu_torch.models.trainer import TorchLearner
        df, _ = _mlp_frames()
        TorchLearner(**_MLP, precision="bf16_mixed",
                     lossScaleInit=1024.0).fit(df)
        snap = telemetry.snapshot()
        assert snap["mmlspark_trainer_loss_scale"]["series"][0][
            "value"] == 1024.0
        assert snap["mmlspark_trainer_skipped_steps"]["series"][0][
            "value"] == 0

    def test_gbdt_fit_populates_metrics_and_spans(self, tel):
        from mmlspark_tpu_torch.models.gbdt.engine import (GBDTParams,
                                                           fit_gbdt)
        x, y = _gbdt_data()
        fit_gbdt(x, y, GBDTParams(num_iterations=3, max_depth=3),
                 device="cpu")
        snap = telemetry.snapshot()
        assert snap["mmlspark_gbdt_iterations"]["series"][0]["value"] == 3
        assert snap["mmlspark_gbdt_iter_seconds"]["series"][0]["count"] == 3
        assert snap["mmlspark_gbdt_bin_seconds"]["series"][0]["count"] == 1
        evs = telemetry.trace.events()
        fit = next(e for e in evs if e["name"] == "gbdt/fit")
        inner = [e for e in evs if e["name"] != "gbdt/fit"]
        assert _names(inner) == {"gbdt/bin": 1, "gbdt/iter/step": 3}
        assert all(_nested_in(fit, e) for e in inner)

    def test_gbdt_early_stopping_eval_metrics(self, tel):
        from mmlspark_tpu_torch.models.gbdt.engine import (GBDTParams,
                                                           fit_gbdt)
        x, y = _gbdt_data()
        fit_gbdt(x, y, GBDTParams(num_iterations=4, max_depth=3,
                                  early_stopping_round=10), device="cpu")
        snap = telemetry.snapshot()
        assert snap["mmlspark_gbdt_eval_seconds"]["series"][0]["count"] == 4
        assert _names(telemetry.trace.events())["gbdt/eval"] == 4

    @pytest.mark.parametrize("impl", ["dense", "pallas", "pallas_int8"])
    def test_gbdt_predict_gauges_and_profile(self, tel, impl):
        from mmlspark_tpu_torch.models.gbdt.engine import (GBDTParams,
                                                           fit_gbdt,
                                                           predict_raw)
        x, y = _gbdt_data()
        ens = fit_gbdt(x, y, GBDTParams(num_iterations=2, max_depth=3),
                       device="cpu")
        telemetry.profiler.enable()
        predict_raw(ens, x, predict_impl=impl)
        snap = telemetry.snapshot()
        assert snap["mmlspark_gbdt_predict_table_bytes"]["series"][0][
            "value"] > 0
        assert snap["mmlspark_gbdt_predict_bytes_per_row"]["series"][0][
            "value"] > 4
        fns = telemetry.profiler.report()["functions"]
        if impl == "dense":
            assert "gbdt.predict_quant" not in fns
        else:
            assert fns["gbdt.predict_quant"]["calls"] == 1
            assert fns["gbdt.predict_quant"]["bytes_per_call"] > 0

    def test_auto_depthwise_reroute_counter(self, tel):
        from mmlspark_tpu_torch.models.gbdt import engine, stages
        clf = stages.LightGBMClassifier(device="cpu")
        clf._engine_params("binary", n_rows=1 << 20)
        assert engine._m_auto_depthwise.value == 1

    def test_warn_once_logs_once_counts_every(self, tel, caplog):
        telemetry._warned_keys.discard("test-key")
        logger = logging.getLogger("mmlspark_tpu_torch.test")
        with caplog.at_level(logging.WARNING, "mmlspark_tpu_torch.test"):
            telemetry.warn_once(logger, "test-key", "warned %d", 1)
            telemetry.warn_once(logger, "test-key", "warned %d", 2)
        assert len([r for r in caplog.records
                    if "warned" in r.message]) == 1
        fam = telemetry.registry.counter("mmlspark_warnings_total")
        assert fam.labels(key="test-key").value == 2

    def test_flight_bundle_holds_a_retried_trainer_fault(self, tel,
                                                          tmp_path):
        from mmlspark_tpu_torch.models.trainer import TorchLearner
        from mmlspark_tpu_torch.resilience import faults
        telemetry.flight.enable(str(tmp_path))
        faults.configure("trainer.step:error:1.0:0:1", seed=0)
        try:
            df, _ = _mlp_frames()
            TorchLearner(**_MLP, stepsPerDispatch=1).fit(df)
        finally:
            faults.clear()
        bundle = telemetry.flight.bundle()
        names = [e.get("name") for e in bundle["events"]]
        assert "fault/injected" in names and "retry" in names
        assert bundle["faults"] == {}          # cleared plan
        path = telemetry.flight.dump("test")
        assert json.loads(open(path).read())["reason"] == "test"


def _gbdt_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    return x, y


# ---------------------------------------------------------------- parity

@pytest.fixture
def both():
    """Both packages' telemetry enabled with clean registries and traces;
    each package keeps its own process-global state."""
    from mmlspark_tpu import telemetry as jtel
    mods = (telemetry, jtel)
    for m in mods:
        m.registry.reset()
        m.trace.clear()
        m.enable()
    yield mods
    for m in mods:
        m.disable()
        m.profiler.disable()
        m.profiler.reset()
        m.registry.reset()
        m.trace.clear()


def _families(snap, prefix):
    return {k for k in snap if k.startswith(prefix)}


def test_gbdt_fit_parity(both):
    from mmlspark_tpu.models.gbdt import engine as jeng
    from mmlspark_tpu_torch.models.gbdt import engine as teng
    port, jtel = both
    x, y = _gbdt_data()
    teng.fit_gbdt(x, y, teng.GBDTParams(num_iterations=3, max_depth=3),
                  device="cpu")
    jeng.fit_gbdt(x, y, jeng.GBDTParams(num_iterations=3, max_depth=3))
    got, want = port.snapshot(), jtel.snapshot()
    assert _families(got, "mmlspark_gbdt") == _families(want,
                                                        "mmlspark_gbdt")
    for name, key in (("mmlspark_gbdt_iterations", "value"),
                      ("mmlspark_gbdt_iter_seconds", "count"),
                      ("mmlspark_gbdt_bin_seconds", "count"),
                      ("mmlspark_gbdt_eval_seconds", "count")):
        assert got[name]["series"][0][key] == want[name]["series"][0][key]
    assert _names(port.trace.events()) == _names(jtel.trace.events())


def test_mlp_fit_parity(both):
    from mmlspark_tpu.models.trainer import TpuLearner
    from mmlspark_tpu_torch.models.trainer import TorchLearner
    port, jtel = both
    df, jdf = _mlp_frames()
    TorchLearner(**_MLP).fit(df)
    jkw = {k: v for k, v in _MLP.items() if k != "device"}
    TpuLearner(**jkw).fit(jdf)
    got, want = port.trace.events(), jtel.trace.events()
    fit_names = lambda evs: collections.Counter(  # noqa: E731
        e["name"] for e in evs if e["name"].split("/")[0] == "fit")
    assert fit_names(got) == fit_names(want)
    assert fit_names(got)["fit/step"] == 2
    for evs in (got, want):
        fit = next(e for e in evs if e["name"] == "fit")
        assert all(_nested_in(fit, e) for e in evs
                   if e["name"] == "fit/step")
    gs, ws = port.snapshot(), jtel.snapshot()
    assert gs["mmlspark_trainer_step_seconds"]["series"][0]["count"] == \
        ws["mmlspark_trainer_step_seconds"]["series"][0]["count"]
    assert _families(gs, "mmlspark_trainer") <= _families(ws,
                                                          "mmlspark_trainer")


def test_profile_and_slo_config_fill_the_same_gauges(both):
    from mmlspark_tpu.models.trainer import TpuLearner
    from mmlspark_tpu_torch.models.trainer import TorchLearner
    port, jtel = both
    df, jdf = _mlp_frames()
    slo = {"stepTimeBudget": 60.0, "windows": [0.5, 2.0], "interval": 0.05}
    lrn = TorchLearner(**_MLP, profile=True, sloConfig=slo)
    lrn.fit(df)
    jkw = {k: v for k, v in _MLP.items() if k != "device"}
    jlrn = TpuLearner(**jkw, profile=True, sloConfig=slo)
    jlrn.fit(jdf)

    def filled(snap):
        return {(name, tuple(sorted(s["labels"].items())))
                for name, fam in snap.items()
                if name.startswith(("mmlspark_profiler", "mmlspark_slo"))
                for s in fam["series"]
                if s.get("value", s.get("count", 0))}
    assert filled(port.snapshot()) == filled(jtel.snapshot())
    assert lrn._last_slo_report["breached"] == \
        jlrn._last_slo_report["breached"] == []
    assert set(lrn._last_slo_report["objectives"]) == \
        set(jlrn._last_slo_report["objectives"]) == {"fit-step-time"}
    assert set(port.profiler.report()["functions"]) == \
        set(jtel.profiler.report()["functions"]) == {"trainer.scan_epoch"}


def test_trainer_slo_config_shorthand(tel):
    """An absurdly tight step budget comes back breached in the final
    report on the learner; a config with neither objectives nor a budget
    fails eagerly."""
    from mmlspark_tpu_torch.models.trainer import TorchLearner
    df, _ = _mlp_frames(n=128)
    lrn = TorchLearner(**dict(_MLP, epochs=1), sloConfig={
        "stepTimeBudget": 1e-6, "windows": [0.5, 2.0], "interval": 0.05})
    lrn.fit(df)
    rep = lrn._last_slo_report
    assert rep["breached"] == ["fit-step-time"]
    assert rep["objectives"]["fit-step-time"]["burn_fast"] > 1.0
    with pytest.raises(ValueError, match="sloConfig"):
        lrn.setSloConfig({"interval": 1.0}).fit(df)


@pytest.mark.parametrize("var,values,fn", [
    ("MMLSPARK_TPU_TIMESERIES", ["", "0", "1", "on", "0.25", "-1", "x"],
     "timeseries_interval"),
    ("MMLSPARK_TPU_FAULTS", ["", "a:error:1.0"], "fault_spec"),
    ("MMLSPARK_TPU_FAULTS_SEED", ["", "7", "x"], "fault_seed"),
    ("MMLSPARK_TPU_FLIGHT", ["", "off", "yes", "/d"], "flight_path"),
    ("MMLSPARK_TPU_TRACE", ["", "/t/{pid}.jsonl"], "telemetry_trace_path"),
    ("MMLSPARK_TPU_TELEMETRY", ["", "1", "TRUE", "no"],
     "telemetry_enabled")])
def test_env_switches_read_like_the_jax_package(monkeypatch, var, values,
                                                fn):
    from mmlspark_tpu.core import env as jenv
    from mmlspark_tpu_torch.core import env
    for v in values:
        monkeypatch.setenv(var, v)
        assert getattr(env, fn)() == getattr(jenv, fn)(), (var, v)


def test_profiled_remat_step_flops_match_the_analytic_count(tel):
    """A remat transformer's profiled training step counts 6 x the dense
    parameters x the tokens, the checkpoint's second forward of each block
    up to (not through) fc2, the attention forward twice and its backward
    once — exactly. On the CPU the attention is the plain version's, so its
    FLOPs are counted the same way; on the card the kernels report theirs
    (chip_smoke.py's ``train_step_flops``)."""
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.models.trainer import TorchLearner
    from mmlspark_tpu_torch.ops import flash_attention as fa
    B, T, d, H, L, C = 4, 16, 32, 2, 2, 4
    cfg = {"type": "transformer", "vocab_size": 50, "d_model": d,
           "heads": H, "layers": L, "mlp_ratio": 4, "num_classes": C,
           "causal": False, "max_len": T, "dtype": "float32",
           "attn_impl": "flash", "remat": True}
    rng = np.random.default_rng(0)
    df = DataFrame({"tokens": rng.integers(0, 50, (2 * B, T),
                                           dtype=np.int32),
                    "label": rng.integers(0, C, 2 * B, dtype=np.int32)})
    TorchLearner(featuresCol="tokens", modelConfig=cfg, optimizer="adam",
                 batchSize=B, epochs=1, device="cpu", profile=True,
                 stepsPerDispatch=1).fit(df)
    got = telemetry.profiler.report()["functions"]["trainer.scan_epoch"]
    q, k, v = (torch.randn(B, T, H, d // H) for _ in range(3))
    count = telemetry.profiler.count_call
    _, fwd = count(fa.flash_attention_reference, (q, k, v))
    out, lse = fa.flash_attention_reference(q, k, v)
    _, bwd = count(fa.flash_attention_bwd_reference,
                   (q, k, v, out, lse, torch.randn_like(out)))
    tokens = B * T
    block = 2 * tokens * 12 * d * d            # qkv, proj, fc1, fc2
    fc2 = 2 * tokens * 4 * d * d
    want = L * (3 * block + (block - fc2) + 2 * fwd["flops"]
                + bwd["flops"]) + 6 * B * d * C
    assert got["flops_per_call"] == want
    assert got["calls"] == 2 and got["compiles"] == 1

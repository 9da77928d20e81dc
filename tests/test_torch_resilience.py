"""The port's retry and circuit-breaking policies and fault injection.

The ``faults`` and ``policy`` cases of tests/test_resilience.py against
``mmlspark_tpu_torch.resilience``; a parity case (the same spec and seed
inject at the same calls in both packages: each site draws from
``Random(seed ^ crc32(site))`` in both); and the trainer's ``trainer.step``
site on the CPU: a fault injected at one step is retried once, and the
fitted parameters equal a clean fit's exactly, on the scan path (one
dispatch a step) and on the per-step feed path. The step computes its new
parameters and optimizer state out of place, so the retried attempt starts
from the unchanged old ones.
"""

import time
import urllib.error

import numpy as np
import pytest
import torch

from mmlspark_tpu.resilience import faults as jax_faults
from mmlspark_tpu_torch import telemetry
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.models.trainer import TorchLearner
from mmlspark_tpu_torch.resilience import faults
from mmlspark_tpu_torch.resilience.policy import (BreakerOpen,
                                                  CircuitBreaker,
                                                  RetryPolicy,
                                                  default_transient)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture
def telemetry_on():
    telemetry.enable()
    telemetry.registry.reset()
    yield telemetry
    telemetry.disable()
    telemetry.registry.reset()


# --------------------------------------------------------------- policies

class TestRetryPolicy:
    def test_succeeds_after_transient_failures(self):
        sleeps = []
        p = RetryPolicy(max_attempts=4, base_delay=0.1, seed=0,
                        sleep=sleeps.append)
        calls = []

        def fn(attempt):
            calls.append(attempt)
            if attempt < 2:
                raise ConnectionError("blip")
            return "ok"

        assert p.run(fn) == "ok"
        assert calls == [0, 1, 2]
        assert len(sleeps) == 2

    def test_fatal_errors_not_retried(self):
        p = RetryPolicy(max_attempts=5, base_delay=0.0)
        calls = []

        def fn(attempt):
            calls.append(attempt)
            raise ValueError("bad input")

        with pytest.raises(ValueError):
            p.run(fn)
        assert calls == [0]

    def test_budget_exhaustion_raises_last_error(self):
        p = RetryPolicy(max_attempts=3, base_delay=0.0)
        with pytest.raises(TimeoutError):
            p.run(lambda a: (_ for _ in ()).throw(TimeoutError(str(a))))

    def test_full_jitter_bounds(self):
        p = RetryPolicy(base_delay=0.1, multiplier=2.0, max_delay=0.5,
                        seed=7)
        for attempt in range(8):
            cap = min(0.5, 0.1 * 2 ** attempt)
            for _ in range(20):
                assert 0.0 <= p.backoff(attempt) <= cap

    def test_deadline_budget(self):
        # base_delay 10s >> deadline: the first retry would blow the
        # budget, so the policy gives up immediately without sleeping
        sleeps = []
        p = RetryPolicy(max_attempts=10, base_delay=10.0, multiplier=1.0,
                        max_delay=10.0, deadline=0.05, seed=1,
                        sleep=sleeps.append)
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            p.run(lambda a: (_ for _ in ()).throw(ConnectionError()))
        assert time.monotonic() - t0 < 1.0
        assert not sleeps

    def test_default_classification(self):
        assert default_transient(ConnectionError())
        assert default_transient(TimeoutError())
        assert default_transient(urllib.error.URLError("x"))
        assert default_transient(faults.InjectedFault("s"))
        assert not default_transient(ValueError())
        assert not default_transient(KeyError())
        err = ValueError("tagged")
        err.transient = True
        assert default_transient(err)
        http500 = urllib.error.HTTPError("u", 500, "boom", {}, None)
        http404 = urllib.error.HTTPError("u", 404, "gone", {}, None)
        assert default_transient(http500)
        assert not default_transient(http404)

    def test_retry_metrics(self, telemetry_on):
        p = RetryPolicy(name="t.metrics", max_attempts=2, base_delay=0.0)
        with pytest.raises(ConnectionError):
            p.run(lambda a: (_ for _ in ()).throw(ConnectionError()))
        snap = telemetry.snapshot()
        series = {tuple(s["labels"].items()): s["value"]
                  for s in snap["mmlspark_retry_attempts_total"]["series"]}
        assert series[(("policy", "t.metrics"),)] == 1
        series = {tuple(s["labels"].items()): s["value"]
                  for s in snap["mmlspark_retry_exhausted_total"]["series"]}
        assert series[(("policy", "t.metrics"),)] == 1


class TestCircuitBreaker:
    def _clock(self):
        t = {"now": 0.0}

        def clock():
            return t["now"]
        return t, clock

    def test_state_machine(self):
        t, clock = self._clock()
        b = CircuitBreaker("test.sm", failure_threshold=2,
                           reset_timeout=1.0, clock=clock)
        assert b.allow("w") and b.state("w") == "closed"
        b.record("w", ok=False)
        assert b.state("w") == "closed"     # one failure: still closed
        b.record("w", ok=False)
        assert b.state("w") == "open"       # threshold reached
        assert not b.allow("w")             # short-circuited
        t["now"] = 1.5                      # reset window elapsed
        assert b.allow("w")                 # half-open probe admitted
        assert b.state("w") == "half_open"
        assert not b.allow("w")             # only one probe in flight
        b.record("w", ok=True)
        assert b.state("w") == "closed"     # probe success closes

    def test_half_open_failure_reopens(self):
        t, clock = self._clock()
        b = CircuitBreaker("test.ho", failure_threshold=1,
                           reset_timeout=1.0, clock=clock)
        b.record("w", ok=False)
        t["now"] = 1.1
        assert b.allow("w")
        b.record("w", ok=False)
        assert b.state("w") == "open"
        assert not b.allow("w")

    def test_call_wrapper_and_targets_independent(self):
        b = CircuitBreaker("test.call", failure_threshold=1,
                           reset_timeout=60.0)
        with pytest.raises(RuntimeError):
            b.call(lambda: (_ for _ in ()).throw(RuntimeError()), "a")
        with pytest.raises(BreakerOpen):
            b.call(lambda: "x", "a")
        assert b.call(lambda: "fine", "b") == "fine"   # target b unharmed
        b.reset("a")
        assert b.call(lambda: "back", "a") == "back"

    def test_snapshot_all(self):
        b = CircuitBreaker("test.snap", failure_threshold=1)
        b.record("t0", ok=False)
        snap = CircuitBreaker.snapshot_all()
        assert snap["test.snap"]["t0"] == "open"


# --------------------------------------------------------- fault injection

class TestFaultInjection:
    def test_spec_parsing_and_validation(self):
        assert faults.parse("a.b:error:0.5") == [("a.b", "error", 0.5, [])]
        assert faults.parse("a:delay:1.0:0.02 ; b:error:0.1:3:2") == [
            ("a", "delay", 1.0, ["0.02"]), ("b", "error", 0.1, ["3", "2"])]
        with pytest.raises(ValueError):
            faults.parse("missing-fields")
        with pytest.raises(ValueError):
            faults.configure("a:explode:0.5")
        with pytest.raises(ValueError):
            faults.configure("a:error:1.5")

    def test_off_by_default_and_clear(self):
        assert not faults.active()
        faults.inject("anything")           # no-op, no error
        faults.configure("x:error:1.0")
        with pytest.raises(faults.InjectedFault):
            faults.inject("x")
        faults.clear()
        faults.inject("x")                  # disarmed again

    def test_seeded_determinism(self):
        def pattern():
            faults.configure("d.site:error:0.3", seed=42)
            hits = []
            for _ in range(100):
                try:
                    faults.inject("d.site")
                    hits.append(0)
                except faults.InjectedFault:
                    hits.append(1)
            return hits

        a, b = pattern(), pattern()
        assert a == b                       # same seed -> same pattern
        assert 10 < sum(a) < 60             # ~30% of 100
        faults.configure("d.site:error:0.3", seed=43)
        c = [0] * 100
        for i in range(100):
            try:
                faults.inject("d.site")
            except faults.InjectedFault:
                c[i] = 1
        assert c != a                       # different seed -> different

    def test_error_after_and_budget_args(self):
        faults.configure("t:error:1.0:2:1")    # arm after 2 calls, 1 total
        faults.inject("t")
        faults.inject("t")                     # 2 clean warmup calls
        with pytest.raises(faults.InjectedFault):
            faults.inject("t")
        faults.inject("t")                     # budget spent: clean again

    def test_delay_kind_sleeps(self):
        faults.configure("slow:delay:1.0:0.02")
        t0 = time.perf_counter()
        faults.inject("slow")
        assert time.perf_counter() - t0 >= 0.02

    def test_env_gating(self, monkeypatch):
        monkeypatch.setenv("MMLSPARK_TPU_FAULTS", "e.site:error:1.0")
        monkeypatch.setenv("MMLSPARK_TPU_FAULTS_SEED", "9")
        faults._init_from_env()
        assert faults.active()
        with pytest.raises(faults.InjectedFault):
            faults.inject("e.site")

    def test_injected_counter(self, telemetry_on):
        faults.configure("m.site:error:1.0")
        with pytest.raises(faults.InjectedFault):
            faults.inject("m.site")
        snap = telemetry.snapshot()["mmlspark_faults_injected_total"]
        assert any(s["labels"] == {"site": "m.site", "kind": "error"}
                   and s["value"] == 1 for s in snap["series"])


def test_fault_patterns_match_the_jax_package():
    spec = "p.site:error:0.3;q.site:error:0.5:4"

    def pattern(mod):
        mod.configure(spec, seed=11)
        hits = []
        try:
            for i in range(60):
                site = "p.site" if i % 2 else "q.site"
                try:
                    mod.inject(site)
                    hits.append(0)
                except mod.InjectedFault:
                    hits.append(1)
        finally:
            mod.clear()
        return hits

    assert pattern(faults) == pattern(jax_faults)
    assert faults.SITES == jax_faults.SITES


# ------------------------------------------------------ trainer.step retry

def _toy_df(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int64)
    return DataFrame({"features": object_column(list(x)), "label": y})


def _fit(**kw):
    params = dict(modelConfig={"type": "mlp", "hidden": [8],
                               "num_classes": 2},
                  device="cpu", optimizer="adam", learningRate=0.01,
                  batchSize=8, epochs=2, seed=3)
    params.update(kw)
    return TorchLearner(**params).fit(_toy_df())


@pytest.mark.parametrize("path", ["scan", "feed"])
def test_trainer_step_fault_is_retried_to_the_clean_params(path,
                                                           telemetry_on):
    kw = ({"stepsPerDispatch": 1} if path == "scan"
          else {"deviceDataCap": 1, "prefetchDepth": 0})
    clean = _fit(**kw)
    assert clean._fit_stats["path"] == path
    telemetry.registry.reset()
    # the 4th dispatch faults once (after 3 clean calls, budget 1)
    faults.configure("trainer.step:error:1.0:3:1", seed=0)
    retried = _fit(**kw)
    assert faults.snapshot()["trainer.step"][0]["injected"] == 1
    want, got = clean.getModelParams(), retried.getModelParams()
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert retried._final_loss == clean._final_loss
    snap = telemetry.snapshot()
    attempts = {s["labels"]["policy"]: s["value"]
                for s in snap["mmlspark_retry_attempts_total"]["series"]}
    assert attempts["trainer.step"] == 1
    # 2 epochs x 4 steps: one observation per completed dispatch
    assert snap["mmlspark_trainer_step_seconds"]["series"][0]["count"] == 8


def test_trainer_step_faulting_twice_in_a_row_fails_the_fit():
    """Every call faults: the first dispatch and its one retry both fail,
    which exhausts the retry-once policy and ends the fit."""
    faults.configure("trainer.step:error:1.0:0", seed=0)
    with pytest.raises(faults.InjectedFault):
        _fit(stepsPerDispatch=1)
    assert faults.snapshot()["trainer.step"][0]["injected"] == 2


def test_trainer_step_non_transient_error_is_not_retried(monkeypatch):
    calls = []

    def broken(site):
        calls.append(site)
        raise ValueError("bad model code")
    monkeypatch.setattr(faults, "inject", broken)
    with pytest.raises(ValueError):
        _fit(stepsPerDispatch=1)
    assert calls == ["trainer.step"]

"""The port's elastic training (``resilience/elastic.py``, the elastic half
of ``parallel/distributed.py``, TorchLearner's and the GBDT engine's
elastic fits) against the JAX package's, on the CPU.

* Heartbeats and the supervisor: each verdict case of
  tests/test_resilience.py (death, grow, straggler, evict, seq freshness,
  a skewed wall clock) runs against both packages' classes, with the same
  verdicts; a heartbeat directory written by one package is read by the
  other's supervisor, and both write the same keys and values.
* In-process chaos on the MLP learner (``_elastic_learner``): simulated
  hosts over the one CPU device. A killed host re-meshes, the fit resumes
  from the consensus checkpoint with all 8 steps committed and ends on the
  uninterrupted fit's parameters bit for bit; grow after ``relaunch_host``,
  the ``max_hosts`` cap, evict and rejoin, the fleet lost below
  ``min_hosts``, ``checkpointDir`` required, inner axes refused, and
  ``fitStream`` surviving a kill.
* Parity with JAX: the port's killed elastic fit against the JAX package's
  killed elastic fit from the same flax init (float32, TF32 off): every
  parameter within 1e-5 of the largest, relative (the JAX fit re-meshes
  from 8 CPU devices to 6, which reorders its float32 sums).
* GBDT: ``fit_gbdt_elastic`` killed mid-boosting keeps its pre-kill trees
  bit for bit and ends on the port's serial fit's ensemble bit for bit;
  its splits equal the JAX package's elastic fit's within the tie rule
  (ROADMAP.md: where gains tie exactly another feature may win; at most
  2 of its 70 nodes) and its scores are within 1e-5; the stage's
  ``elasticConfig`` routing.
* Rendezvous: the protocol cases with the two packages writing and reading
  each other's rendezvous and lease files, the ``elastic.remesh`` fault
  site, and ``/healthz``'s ``elastic`` section.
"""

import json
import os
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu import telemetry as jax_telemetry
from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.core.utils import object_column as jax_object_column
from mmlspark_tpu.models.gbdt import engine as jeng
from mmlspark_tpu.models.trainer import TpuLearner
from mmlspark_tpu.parallel import distributed as jax_dist
from mmlspark_tpu.resilience import elastic as jax_elastic
from mmlspark_tpu.resilience import faults as jax_faults
from mmlspark_tpu_torch import telemetry
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.models import trainer as ttrainer
from mmlspark_tpu_torch.models.downloader import read_flax_msgpack
from mmlspark_tpu_torch.models.gbdt import engine as teng
from mmlspark_tpu_torch.models.gbdt import stages as tstages
from mmlspark_tpu_torch.models.trainer import TorchLearner, _params_digest
from mmlspark_tpu_torch.models.weights import from_flax_params
from mmlspark_tpu_torch.parallel import distributed
from mmlspark_tpu_torch.resilience import elastic
from mmlspark_tpu_torch.resilience import faults

pytestmark = pytest.mark.chaos

MLP = {"type": "mlp", "hidden": [4], "num_classes": 2}
# the chaos fits' clock: a death verdict after GRACE s of heartbeat
# silence (beacons every HB s), each step paced by PACE s. GRACE is wide
# enough that a live beacon starved by a loaded machine (the suite runs
# beside other workers) is not declared dead; PACE keeps a fit running
# several steps past a verdict.
GRACE, HB, PACE = 1.0, 0.05, 0.3
PACKAGES = {"torch": (elastic, faults, telemetry),
            "jax": (jax_elastic, jax_faults, jax_telemetry)}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture
def telemetry_on():
    telemetry.enable()
    telemetry.registry.reset()
    yield telemetry
    telemetry.disable()
    telemetry.registry.reset()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """(elastic module, faults module, telemetry) of one package, its
    telemetry on and reset."""
    mod, flt, tel = PACKAGES[request.param]
    tel.enable()
    tel.registry.reset()
    yield mod, flt, tel
    tel.disable()
    tel.registry.reset()


def _toy_df(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    return DataFrame({"features": object_column([r for r in x]),
                      "label": y})


def _elastic_learner(ck: str, epochs: int = 1, **kw):
    base = dict(modelConfig=MLP, epochs=epochs, batchSize=8,
                learningRate=0.05, deviceDataCap=1, checkpointDir=ck,
                checkpointEverySteps=2, device="cpu")
    base.update(kw)
    return TorchLearner(**base)


def _same_params(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _metric(tel, name):
    series = tel.snapshot()[name]["series"]
    return {tuple(s["labels"].values()): s["value"] for s in series}


# ------------------------------------------------- heartbeats + supervisor

class TestTrainSupervisor:
    """Deterministic (tick-driven, injected-probe) verdicts, both
    packages."""

    def test_grace_window_and_sticky_verdict(self, pkg, tmp_path):
        mod = pkg[0]
        ages = {"host0": 0.0, "host1": 0.0}
        sup = mod.TrainSupervisor(["host0", "host1"], str(tmp_path),
                                  grace=1.0, probe=ages.get)
        sup.tick()
        assert sup.dead_hosts() == set()
        ages["host1"] = 5.0
        sup.tick()
        assert sup.dead_hosts() == {"host1"}
        assert sup.alive_hosts() == ["host0"]
        ages["host1"] = 0.0           # a zombie does NOT resurrect
        sup.tick()
        assert sup.dead_hosts() == {"host1"}

    def test_missing_heartbeat_fatal_after_grace(self, pkg, tmp_path):
        sup = pkg[0].TrainSupervisor(["host0"], str(tmp_path), grace=0.05,
                                     probe=lambda h: None)
        sup.tick()
        assert sup.dead_hosts() == set()
        time.sleep(0.08)
        sup.tick()
        assert sup.dead_hosts() == {"host0"}

    def test_shrink_vs_restart_decision(self, pkg, tmp_path):
        ages = {f"host{i}": 0.0 for i in range(3)}
        sup = pkg[0].TrainSupervisor(list(ages), str(tmp_path), grace=1.0,
                                     min_hosts=2, probe=ages.get)
        assert sup.decision() == "shrink"
        ages["host0"] = 9.0
        sup.tick()
        assert sup.decision() == "shrink"
        ages["host1"] = 9.0
        sup.tick()
        assert sup.decision() == "restart"

    def test_heartbeat_probe_fault_site(self, pkg, tmp_path):
        mod, flt, _ = pkg
        flt.configure("supervisor.heartbeat:error:1.0", seed=0)
        sup = mod.TrainSupervisor(["host0"], str(tmp_path), grace=1.0,
                                  probe=lambda h: 0.0)
        with pytest.raises(ConnectionError):
            sup.tick()


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
def test_heartbeat_directory_reads_across_packages(writer, reader, tmp_path):
    """A beacon of one package read by the other's supervisor: fresh while
    it beats, the carried (epoch, step), generation and joining flag as
    written; dead once killed."""
    d = str(tmp_path)
    hb = PACKAGES[writer][0].HostHeartbeat("hostX", d, interval=HB)
    hb.set_generation(3)
    hb.start()
    try:
        hb.beat(1, 7)
        sup = PACKAGES[reader][0].TrainSupervisor(["hostX"], d,
                                                  grace=GRACE)
        time.sleep(3 * HB)
        age = sup._probe_file("hostX")
        assert age is not None and age < GRACE
        doc = json.load(open(hb.path))
        assert (doc["host"], doc["epoch"], doc["step"], doc["generation"]) \
            == ("hostX", 1, 7, 3)
        hb.kill()
        sup.tick()
        time.sleep(GRACE + 0.1)
        sup.tick()
        assert sup.dead_hosts() == {"hostX"}
    finally:
        hb.stop()


def test_heartbeat_docs_have_the_same_keys_and_values(tmp_path):
    """Both packages' beacons, in the same state, write the same doc (but
    the wall time)."""
    docs = []
    for name, (mod, _f, _t) in sorted(PACKAGES.items()):
        d = str(tmp_path / name)
        os.makedirs(d)
        for joining, gen in ((False, 0), (True, 5)):
            hb = mod.HostHeartbeat("host1", d, interval=60.0,
                                   joining=joining)
            hb.set_generation(gen)
            hb.beat(2, 9)
            hb._write()
            doc = json.load(open(hb.path))
            doc.pop("time")
            docs.append((name, joining, doc))
    by_pkg = {}
    for name, joining, doc in docs:
        by_pkg.setdefault(joining, {})[name] = doc
    for joining, pair in by_pkg.items():
        assert pair["torch"] == pair["jax"], joining
    assert by_pkg[True]["torch"] == {"host": "host1", "seq": 1, "epoch": 2,
                                     "step": 9, "generation": 5,
                                     "joining": True}


def test_stale_heartbeat_ghosts_cleared(pkg, tmp_path):
    d = str(tmp_path)
    for h in ("host0", "host1"):
        with open(os.path.join(d, f"hb_{h}.json"), "w") as f:
            json.dump({"host": h, "time": time.time(), "epoch": 0,
                       "step": 0}, f)
    old = time.time() - 60
    os.utime(os.path.join(d, "hb_host0.json"), (old, old))
    sup = pkg[0].TrainSupervisor(["host0", "host1"], d, grace=1.0)
    sup.clear_stale_heartbeats()
    assert not os.path.exists(os.path.join(d, "hb_host0.json"))
    assert os.path.exists(os.path.join(d, "hb_host1.json"))
    sup.tick()          # missing file is inside the startup grace: alive
    assert sup.dead_hosts() == set()


class TestGrowVerdicts:
    def _dead_sup(self, mod, d, **kw):
        sup = mod.TrainSupervisor(["host0", "host1"], d, grace=1.0, **kw)
        sup._dead.add("host1")
        return sup

    def _write_hb(self, d, host, joining, age=0.0):
        with open(os.path.join(d, f"hb_{host}.json"), "w") as f:
            json.dump({"host": host, "time": time.time() - age,
                       "epoch": 0, "step": 0,
                       **({"joining": True} if joining else {})}, f)

    def test_flagless_zombie_stays_dead(self, pkg, tmp_path):
        d = str(tmp_path)
        sup = self._dead_sup(pkg[0], d, rejoin_grace=0.0)
        self._write_hb(d, "host1", joining=False)
        sup.tick()
        assert sup.joining_hosts() == {}
        assert sup.dead_hosts() == {"host1"}

    def test_joining_heartbeat_earns_grow_verdict(self, pkg, tmp_path):
        d = str(tmp_path)
        sup = self._dead_sup(pkg[0], d, rejoin_grace=0.0)
        self._write_hb(d, "host1", joining=True)
        sup.tick()
        assert set(sup.joining_hosts()) == {"host1"}
        assert sup.dead_hosts() == {"host1"}   # a verdict is not an admit
        sup.admit("host1")
        assert sup.dead_hosts() == set()
        assert sup.joining_hosts() == {}

    def test_rejoin_grace_window(self, pkg, tmp_path):
        d = str(tmp_path)
        sup = self._dead_sup(pkg[0], d, rejoin_grace=0.2)
        self._write_hb(d, "host1", joining=True)
        sup.tick()
        assert sup.joining_hosts() == {}
        time.sleep(0.25)
        self._write_hb(d, "host1", joining=True)
        sup.tick()
        assert set(sup.joining_hosts()) == {"host1"}

    def test_stale_joining_heartbeat_restarts_window(self, pkg, tmp_path):
        d = str(tmp_path)
        sup = self._dead_sup(pkg[0], d, rejoin_grace=0.2)
        self._write_hb(d, "host1", joining=True)
        sup.tick()
        time.sleep(0.25)
        self._write_hb(d, "host1", joining=True, age=5.0)
        sup.tick()
        assert sup.joining_hosts() == {}

    def test_rejoin_fault_site(self, pkg, tmp_path):
        d = str(tmp_path)
        sup = self._dead_sup(pkg[0], d, rejoin_grace=0.0)
        self._write_hb(d, "host1", joining=True)
        pkg[1].configure("supervisor.rejoin:error:1.0", seed=0)
        with pytest.raises(ConnectionError):
            sup._grow_pass()


class TestSeqHeartbeats:
    def _write(self, d, host, seq, wall_offset=0.0, joining=False):
        doc = {"host": host, "seq": seq, "time": time.time() + wall_offset,
               "epoch": 0, "step": seq}
        if joining:
            doc["joining"] = True
        with open(os.path.join(d, f"hb_{host}.json"), "w") as f:
            json.dump(doc, f)

    def test_skewed_wall_clock_does_not_kill_a_beating_host(self, pkg,
                                                           tmp_path):
        d = str(tmp_path)
        sup = pkg[0].TrainSupervisor(["host0"], d, grace=0.5)
        for seq in range(3):
            self._write(d, "host0", seq, wall_offset=-3600.0)
            sup.tick()
            time.sleep(0.05)
        assert sup.dead_hosts() == set()

    def test_stalled_seq_dies_despite_fresh_wall_time(self, pkg, tmp_path):
        d = str(tmp_path)
        sup = pkg[0].TrainSupervisor(["host0"], d, grace=0.15)
        self._write(d, "host0", 7, wall_offset=+3600.0)
        sup.tick()
        assert sup.dead_hosts() == set()
        time.sleep(0.25)
        self._write(d, "host0", 7, wall_offset=+3600.0)
        sup.tick()
        assert sup.dead_hosts() == {"host0"}

    def test_grow_freshness_uses_seq(self, pkg, tmp_path):
        d = str(tmp_path)
        sup = pkg[0].TrainSupervisor(["host0", "host1"], d, grace=5.0,
                                     rejoin_grace=0.0)
        sup._dead.add("host1")
        self._write(d, "host1", 3, wall_offset=-3600.0, joining=True)
        sup.tick()
        assert set(sup.joining_hosts()) == {"host1"}

    def test_relaunched_inmesh_host_self_reports_via_joining(self, pkg,
                                                            tmp_path):
        d = str(tmp_path)
        sup = pkg[0].TrainSupervisor(["host0"], d, grace=60.0)
        self._write(d, "host0", 1)
        sup.tick()
        assert sup.dead_hosts() == set()
        self._write(d, "host0", 2, joining=True)
        sup.tick()
        assert sup.dead_hosts() == {"host0"}


class TestEvictVerdicts:
    def _sup(self, mod, d, hosts=4, evict_after=2, min_hosts=1):
        ids = [f"host{i}" for i in range(hosts)]
        return mod.TrainSupervisor(ids, d, grace=60.0, min_hosts=min_hosts,
                                   evict_after=evict_after,
                                   probe=lambda h: 0.0)

    def _feed_straggler(self, sup, victim="host2"):
        for _ in range(16):
            for h in sup.host_ids:
                sup.anomaly.observe(h, 0.5 if h == victim else 0.1)

    def test_consecutive_flags_promote_to_evict(self, pkg, tmp_path):
        sup = self._sup(pkg[0], str(tmp_path), evict_after=3)
        self._feed_straggler(sup)
        sup.tick()
        assert sup.straggler_hosts() == {"host2"}
        assert sup.evict_verdicts() == {}
        sup.tick()
        assert sup.evict_verdicts() == {}
        sup.tick()
        assert set(sup.evict_verdicts()) == {"host2"}
        assert sup.dead_hosts() == set()

    def test_advisory_only_when_evict_after_zero(self, pkg, tmp_path):
        sup = self._sup(pkg[0], str(tmp_path), evict_after=0)
        self._feed_straggler(sup)
        for _ in range(5):
            sup.tick()
        assert sup.straggler_hosts() == {"host2"}
        assert sup.evict_verdicts() == {}

    def test_flag_gap_resets_the_streak(self, pkg, tmp_path):
        sup = self._sup(pkg[0], str(tmp_path), evict_after=2)
        self._feed_straggler(sup)
        sup.tick()
        for _ in range(64):
            sup.anomaly.observe("host2", 0.1)
        sup.tick()
        assert sup.straggler_hosts() == set()
        self._feed_straggler(sup)
        sup.tick()
        assert sup.evict_verdicts() == {}

    def test_coordinator_host_is_never_evicted(self, pkg, tmp_path):
        sup = self._sup(pkg[0], str(tmp_path), evict_after=1)
        self._feed_straggler(sup, victim="host0")
        for _ in range(4):
            sup.tick()
        assert sup.straggler_hosts() == {"host0"}
        assert sup.evict_verdicts() == {}

    def test_min_hosts_floor_blocks_evict(self, pkg, tmp_path):
        sup = self._sup(pkg[0], str(tmp_path), hosts=2, evict_after=1,
                        min_hosts=2)
        self._feed_straggler(sup, victim="host1")
        for _ in range(4):
            sup.tick()
        assert sup.evict_verdicts() == {}

    def test_mark_evicted_clears_straggler_state(self, pkg, tmp_path):
        mod, _f, tel = pkg
        sup = self._sup(mod, str(tmp_path), evict_after=1)
        self._feed_straggler(sup)
        sup.tick()
        assert set(sup.evict_verdicts()) == {"host2"}
        sup.mark_evicted("host2")
        assert sup.dead_hosts() == {"host2"}
        assert sup.evict_verdicts() == {}
        assert sup.straggler_hosts() == set()
        assert "host2" not in sup.anomaly.report()["host_median_s"]
        ev = _metric(tel, "mmlspark_elastic_evictions_total")
        assert [h for (h,), v in ev.items() if v > 0] == ["host2"]


def test_heartbeats_of_a_simulated_straggler_promote_to_evict(pkg, tmp_path):
    """The throttle switch end to end: a beacon whose carried progress
    advances one step in five reads 5x slower from its heartbeats, and the
    supervisor's passes promote it to an evict verdict."""
    mod = pkg[0]
    d = str(tmp_path)
    hbs = {f"host{i}": mod.HostHeartbeat(f"host{i}", d, interval=60.0)
           for i in range(4)}
    hbs["host3"].throttle(5)
    sup = mod.TrainSupervisor(list(hbs), d, grace=60.0, evict_after=2)
    for tick in range(30):
        for hb in hbs.values():
            for step in range(5 * tick, 5 * tick + 5):   # 5 steps a beat
                hb.beat(0, step)
            hb._write()
        time.sleep(0.002)
        sup.tick()
    assert sup.straggler_hosts() == {"host3"}
    assert set(sup.evict_verdicts()) == {"host3"}


# --------------------------------------------- in-process chaos: the learner

def test_elastic_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpointDir"):
        elastic.ElasticFitCoordinator(TorchLearner(device="cpu"))
    with pytest.raises(ValueError, match="checkpointDir"):
        TorchLearner(modelConfig=MLP, elastic=True,
                     device="cpu").fit(_toy_df(16))


@pytest.mark.parametrize("axis", ["pipelineParallel", "sequenceParallel",
                                  "expertParallel"])
def test_elastic_rejects_inner_axes(tmp_path, axis):
    learner = _elastic_learner(str(tmp_path / "ck"), elastic=True,
                               modelConfig={"type": "transformer",
                                            "vocab_size": 8, "d_model": 8,
                                            "heads": 2, "layers": 2,
                                            "num_classes": 2},
                               **{axis: 2})
    with pytest.raises(ValueError, match="elastic fit composes with "
                                         r"data\(\+tensor\)"):
        learner.fit(_toy_df(16))


def test_elastic_fleet_lost_below_min_hosts(tmp_path):
    coord = elastic.ElasticFitCoordinator(
        _elastic_learner(str(tmp_path / "ck")), n_hosts=2, min_hosts=2,
        grace=60.0)
    coord.supervisor._dead.add("host1")
    with pytest.raises(elastic.ElasticFleetLost, match="min_hosts"):
        coord._remesh({"host1"})


def test_simulated_hosts_share_the_one_device(tmp_path):
    """``n_hosts`` failure domains over a world of one rank: every host's
    group is rank 0, and an attempt's pool is that one rank."""
    coord = elastic.ElasticFitCoordinator(
        _elastic_learner(str(tmp_path / "ck")), n_hosts=4, grace=60.0)
    assert coord.groups == {f"host{i}": [0] for i in range(4)}
    assert coord._pool() == [0]
    assert coord._mesh_hosts == {f"host{i}" for i in range(4)}


def test_elastic_fit_clean_run_no_overhead_path(tmp_path, telemetry_on):
    """No faults, no deaths: the wrapper is pass-through — one attempt,
    every step committed once, no remesh, the plain feed-path fit's
    parameters."""
    df = _toy_df(64)
    model = _elastic_learner(str(tmp_path / "ck"), elastic=True,
                             elasticHosts=4,
                             elasticGraceSeconds=5.0).fit(df)
    plain = _elastic_learner(str(tmp_path / "plain")).fit(df)
    assert _same_params(model.getModelParams(), plain.getModelParams())
    assert _metric(telemetry, "mmlspark_elastic_remeshes_total")[()] == 0
    assert _metric(telemetry, "mmlspark_elastic_hosts_alive")[()] == 4


def _kill_at_first_step_checkpoint(coord, ck, copies, done):
    """Keep a copy of every checkpoint file (the epoch-final save prunes
    the step ones) and kill host2's beacon once a step checkpoint lands."""
    killed = False
    while not done.is_set():
        for f in os.listdir(ck) if os.path.isdir(ck) else []:
            if f.startswith("ckpt_") and f.endswith(".msgpack") \
                    and f not in copies:
                try:
                    copies[f] = open(os.path.join(ck, f), "rb").read()
                except OSError:
                    continue
                if not killed and "_s" in f:
                    coord.heartbeats["host2"].kill()
                    killed = True
        time.sleep(0.005)


def _run_with(target, fit, *args):
    done = threading.Event()
    t = threading.Thread(target=target, args=args + (done,), daemon=True)
    t.start()
    try:
        return fit()
    finally:
        done.set()
        t.join(timeout=5)


def test_elastic_fit_survives_host_kill(tmp_path, telemetry_on):
    """THE elastic guarantee: a simulated host killed mid-fit under a 10 %
    elastic.step fault rate is detected by heartbeat silence, the fit
    re-meshes over the survivors and resumes from the consensus checkpoint
    bit for bit: every step of the epoch committed, the resumed params'
    digest equal to the checkpoint file's, and the final parameters equal
    to the uninterrupted fit's."""
    ck = str(tmp_path / "ck")
    df = _toy_df(64)                      # 64 rows / bs 8 -> 8 steps
    faults.configure(f"elastic.step:error:0.1;trainer.step:delay:1.0:{PACE}",
                     seed=3)
    coord = elastic.ElasticFitCoordinator(_elastic_learner(ck), n_hosts=4,
                                          grace=GRACE, heartbeat_interval=HB)
    copies = {}
    model = _run_with(_kill_at_first_step_checkpoint,
                      lambda: coord.fit(df), coord, ck, copies)
    faults.clear()
    assert coord.supervisor.dead_hosts() == {"host2"}
    assert len(coord.attempts) >= 2
    final = coord.attempts[-1]
    assert final["hosts"] == ["host0", "host1", "host3"]
    assert final["devices"] == 1
    assert _metric(telemetry, "mmlspark_elastic_remeshes_total")[()] >= 1
    losses = _metric(telemetry, "mmlspark_elastic_host_losses_total")
    assert [h for (h,), v in losses.items() if v > 0] == ["host2"]
    assert {s for (_e, s) in coord.committed} == set(range(8))
    epoch, step = final["resume_pos"]
    name = f"ckpt_{epoch:05d}_s{step:07d}.msgpack"
    state = read_flax_msgpack(copies[name])
    assert _params_digest(state["params"]) == final["resume_digest"]
    assert final.get("recovery_s", 0) > 0
    assert sorted(f for f in os.listdir(ck) if f.endswith(".msgpack")) \
        == ["ckpt_00000.msgpack"]
    plain = _elastic_learner(str(tmp_path / "plain")).fit(df)
    assert _same_params(model.getModelParams(), plain.getModelParams())


def test_elastic_fit_grows_back_after_relaunch(tmp_path, telemetry_on):
    """A host killed mid-fit shrinks the mesh; its relaunch (a joining
    heartbeat) earns a grow verdict and the mesh grows back to 4 hosts at
    the next checkpoint boundary: every step committed, the uninterrupted
    fit's parameters."""
    ck = str(tmp_path / "ck")
    df = _toy_df(64)
    learner = _elastic_learner(ck, epochs=2, asyncCheckpoint=True)
    faults.configure(f"trainer.step:delay:1.0:{PACE}", seed=3)
    coord = elastic.ElasticFitCoordinator(learner, n_hosts=4, grace=GRACE,
                                          heartbeat_interval=HB,
                                          rejoin_grace=0.1)

    def chaos(done):
        while not done.is_set():
            if os.path.isdir(ck) and any(
                    "_s" in f for f in os.listdir(ck)
                    if f.endswith(".msgpack")):
                coord.heartbeats["host2"].kill()
                break
            time.sleep(0.005)
        while not done.is_set():
            if len(coord.attempts) >= 2:
                coord.relaunch_host("host2")
                return
            time.sleep(0.005)

    model = _run_with(chaos, lambda: coord.fit(df))
    faults.clear()
    assert len(coord.attempts) >= 3
    assert coord.attempts[-1]["hosts"] == ["host0", "host1", "host2",
                                           "host3"]
    assert coord.supervisor.dead_hosts() == set()
    grow = next(a for a in coord.attempts if "grow_recovery_s" in a)
    assert grow["grow_recovery_s"] > 0
    assert _metric(telemetry, "mmlspark_elastic_grows_total")[()] >= 1
    rejoins = _metric(telemetry, "mmlspark_elastic_rejoins_total")
    assert [h for (h,), v in rejoins.items() if v > 0] == ["host2"]
    assert set(coord.committed) >= {(e, s) for e in range(2)
                                    for s in range(8)}
    plain = _elastic_learner(str(tmp_path / "plain"), epochs=2).fit(df)
    assert _same_params(model.getModelParams(), plain.getModelParams())


def test_elastic_max_hosts_caps_grow(tmp_path):
    coord = elastic.ElasticFitCoordinator(
        _elastic_learner(str(tmp_path / "ck")), n_hosts=4, grace=60.0,
        max_hosts=3)
    coord.supervisor._dead.add("host3")
    coord._mesh_hosts = {"host0", "host1", "host2"}
    coord.supervisor._joining["host3"] = 0.0
    coord.note_checkpoint(0, 5)
    assert coord.pending_grow() == set()
    coord.max_hosts = 4
    assert coord.pending_grow() == {"host3"}


@pytest.mark.parametrize("pos,replayed", [((0, 3), 6), ((0, None), 2),
                                           ((1, 0), 1)])
def test_steps_replayed_after_a_resume(tmp_path, pos, replayed):
    """The steps committed past the resume position re-run: an epoch
    checkpoint (step None) covers every step of its epoch (the JAX
    package's count takes the whole epoch as replayed there)."""
    coord = elastic.ElasticFitCoordinator(
        _elastic_learner(str(tmp_path / "ck")), n_hosts=2, grace=60.0)
    coord.committed = [(0, s) for s in range(8)] + [(1, 0), (1, 1)]
    coord.attempts.append({})
    coord.note_resume(pos, None)
    assert coord.attempts[-1]["replayed"] == replayed


def test_pending_evict_arms_only_after_checkpoint_boundary(tmp_path):
    coord = elastic.ElasticFitCoordinator(
        _elastic_learner(str(tmp_path / "ck")), n_hosts=4, grace=60.0,
        evict_after=1)
    coord._mesh_hosts = {"host0", "host1", "host2", "host3"}
    coord.supervisor._evict["host2"] = time.monotonic()
    assert coord.pending_evict() == set()
    coord.note_checkpoint(0, 5)
    assert coord.pending_evict() == {"host2"}


@pytest.mark.parametrize("site,call", [
    ("elastic.evict", lambda c: c._evict({"host2"})),
    ("elastic.remesh", lambda c: c._remesh(["host1"])),
    ("elastic.remesh", lambda c: c._grow({"host1"}))])
def test_coordinator_fault_sites(tmp_path, site, call):
    coord = elastic.ElasticFitCoordinator(n_hosts=4,
                                          checkpoint_dir=str(tmp_path))
    coord._mesh_hosts = {"host0", "host1", "host2", "host3"}
    faults.configure(f"{site}:error:1.0")
    with pytest.raises(faults.InjectedFault):
        call(coord)


def test_elastic_straggler_evict_and_rejoin(tmp_path, telemetry_on):
    """A delayed-but-alive host (its heartbeat progress throttled 5x while
    an elastic.step delay paces the fleet; ~10 steps a verdict pass, so
    its heartbeats read ~5x slower than the others') is flagged, promoted
    to an evict verdict after 2 passes and dropped at a committed
    checkpoint boundary
    — a 4-shard checkpoint resumed on the 3-host mesh, its digest the
    committed shards' — then relaunched healthy it rejoins through the grow
    path and the fit ends on the full fleet with every step committed and
    the uninterrupted fit's parameters."""
    from mmlspark_tpu_torch.resilience import ckpt as ckptlib
    ck = str(tmp_path / "ck")
    df = _toy_df(512, seed=1)              # 64 steps an epoch
    kw = dict(epochs=3, checkpointEverySteps=4, checkpointShards=4)
    faults.configure("elastic.step:delay:1.0:0.02", seed=11)
    coord = elastic.ElasticFitCoordinator(
        _elastic_learner(ck, **kw), n_hosts=4, grace=GRACE,
        heartbeat_interval=HB, rejoin_grace=0.1, evict_after=2)
    coord.heartbeats["host3"].throttle(5)
    snaps = {}

    def chaos(done):
        relaunched = False
        while not done.is_set():
            for f in (os.listdir(ck) if os.path.isdir(ck) else []):
                if f.endswith(".msgpack") and f not in snaps:
                    try:
                        snaps[f] = open(os.path.join(ck, f), "rb").read()
                    except OSError:
                        continue
            if not relaunched and "host3" in coord.supervisor.dead_hosts():
                coord.relaunch_host("host3")
                relaunched = True
            time.sleep(0.005)

    model = _run_with(chaos, lambda: coord.fit(df))
    faults.clear()
    ev = _metric(telemetry, "mmlspark_elastic_evictions_total")
    assert [h for (h,), v in ev.items() if v > 0] == ["host3"]
    assert _metric(telemetry, "mmlspark_elastic_grows_total")[()] >= 1
    assert coord.supervisor.dead_hosts() == set()
    assert coord.attempts[-1]["hosts"] == ["host0", "host1", "host2",
                                           "host3"]
    rec = next(a for a in coord.attempts if "evict_recovery_s" in a)
    assert rec["evict_recovery_s"] > 0
    assert set(coord.committed) >= {(e, s) for e in range(3)
                                    for s in range(64)}
    epoch, step = rec["resume_pos"]
    name = (f"ckpt_{epoch:05d}.msgpack" if step is None
            else f"ckpt_{epoch:05d}_s{step:07d}.msgpack")
    shards = ckptlib.parse_head(snaps[name])
    assert shards is not None and len(shards) == 4
    flat = {}
    for sname in shards:
        flat.update(read_flax_msgpack(snaps[sname]))
    state = ckptlib.unflatten_state(flat)
    assert _params_digest(state["params"]) == rec["resume_digest"]
    plain = _elastic_learner(str(tmp_path / "plain"), **kw).fit(df)
    assert _same_params(model.getModelParams(), plain.getModelParams())


def test_elastic_fitstream_survives_host_kill(tmp_path, telemetry_on):
    """fitStream through the coordinator: a host killed mid-stream
    re-meshes over the survivors and the fit completes (the interrupted
    epoch restarts from the checkpointed optimizer state)."""
    rng = np.random.default_rng(0)
    n = 64
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)

    def batches():
        for i in range(0, n, 8):
            time.sleep(PACE)
            yield x[i:i + 8], y[i:i + 8]

    learner = _elastic_learner(str(tmp_path / "ck"), epochs=2,
                               elastic=True, elasticHosts=4,
                               elasticGraceSeconds=GRACE)
    coords = []
    orig = learner._elastic_coordinator

    def capture():
        c = orig()
        c._hb_interval = HB
        for h in c.heartbeats.values():
            h.interval = HB
        coords.append(c)
        return c

    learner._elastic_coordinator = capture

    def killer(done):
        while not done.is_set():
            if coords and len(coords[0].committed) >= 2:
                coords[0].heartbeats["host2"].kill()
                return
            time.sleep(0.005)

    model = _run_with(killer, lambda: learner.fitStream(batches))
    assert np.isfinite(model._final_loss)
    coord = coords[0]
    assert coord.supervisor.dead_hosts() == {"host2"}
    assert len(coord.attempts) >= 2
    assert coord.attempts[-1]["hosts"] == ["host0", "host1", "host3"]
    assert _metric(telemetry, "mmlspark_elastic_remeshes_total")[()] >= 1


# ----------------------------------------------------- parity with the JAX fit

def _jax_frame(df):
    return JaxDataFrame({"features": jax_object_column(
        [np.asarray(r) for r in df.col("features")]),
        "label": np.asarray(df.col("label"))})


def _killed_fit(mod, flt, learner, ck, df):
    """An elastic fit of ``mod``'s coordinator with host2 killed at the
    first step checkpoint, paced by a trainer.step delay."""
    flt.configure(f"trainer.step:delay:1.0:{PACE}", seed=3)
    coord = mod.ElasticFitCoordinator(learner, n_hosts=4, grace=GRACE,
                                      heartbeat_interval=HB)
    try:
        model = _run_with(_kill_at_first_step_checkpoint,
                          lambda: coord.fit(df), coord, ck, {})
    finally:
        flt.clear()
    assert coord.supervisor.dead_hosts() == {"host2"}
    assert len(coord.attempts) >= 2
    assert {s for (_e, s) in coord.committed} == set(range(8))
    return model


def test_killed_elastic_fit_matches_the_jax_packages(tmp_path, monkeypatch):
    """The same kill in both packages from the same flax init (the JAX
    learner's init, read off a learning-rate-0 fit): every parameter of
    the port's fit within 1e-5 of the JAX fit's, relative to the largest
    (float32 compute; the JAX fit re-meshes from 8 CPU devices to 6)."""
    df = _toy_df(64)
    jdf = _jax_frame(df)
    common = dict(modelConfig=MLP, epochs=1, batchSize=8, deviceDataCap=1,
                  checkpointEverySteps=2, precision="f32")
    init = TpuLearner().set(learningRate=0.0, **common).fit(jdf) \
        .getModelParams()
    init = jax.tree_util.tree_map(np.asarray, init)
    jck = str(tmp_path / "jax")
    jmodel = _killed_fit(jax_elastic, jax_faults, TpuLearner().set(
        learningRate=0.05, checkpointDir=jck, **common), jck, jdf)
    want = from_flax_params(jax.tree_util.tree_map(
        np.asarray, jmodel.getModelParams()), dict(MLP, input_dim=4))
    monkeypatch.setattr(ttrainer, "init_params",
                        lambda cfg, seed: from_flax_params(init, cfg))
    tck = str(tmp_path / "torch")
    got = _killed_fit(elastic, faults, TorchLearner(
        learningRate=0.05, checkpointDir=tck, device="cpu", **common),
        tck, df).getModelParams()
    for k in want:
        a, b = got[k].numpy(), want[k].numpy()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), k


# ------------------------------------------------------------------- GBDT

def _gbdt_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1024, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    return x, y


GBDT = dict(num_iterations=10, max_depth=3, objective="binary",
            tree_learner="data")


def test_elastic_gbdt_kill_and_resume(tmp_path):
    """The boosting loop through ElasticStepContext: a host killed
    mid-boosting re-meshes and the fit resumes from the per-iteration
    snapshot — the trees built before the kill survive bit for bit, the
    full ensemble equals the port's serial fit's bit for bit, and it grows
    the JAX package's elastic fit's trees within the tie rule."""
    x, y = _gbdt_data()
    p = teng.GBDTParams(**GBDT)
    coord = elastic.ElasticFitCoordinator(
        checkpoint_dir=str(tmp_path / "ck"), n_hosts=4, grace=GRACE,
        heartbeat_interval=HB)
    faults.configure(f"elastic.step:delay:1.0:{PACE}", seed=0)

    def killer(done):
        while not done.is_set():
            if len(coord.committed) >= 2:
                coord.heartbeats["host2"].kill()
                return
            time.sleep(0.005)

    def attempt(devices, ctx):
        return teng.fit_gbdt(x, y, p, mesh=_mesh(), elastic_ctx=ctx,
                             device="cpu")

    ens = _run_with(killer, lambda: coord.run(attempt))
    faults.clear()
    assert coord.supervisor.dead_hosts() == {"host2"}
    assert len(coord.attempts) >= 2
    resumed = coord.attempts[-1]
    assert resumed["resume_pos"] is not None and resumed["resume_pos"][1] >= 1
    assert ens.leaf.shape[0] == 10
    k = resumed["resume_pos"][1] + 1
    for i in range(k):
        assert torch.equal(ens.leaf[i], coord.snapshot["leaves"][i])
    serial = tstages._ensemble_to_state(teng.fit_gbdt(
        x, y, p._replace(tree_learner="serial"), device="cpu"))
    got = tstages._ensemble_to_state(ens)
    for key, v in serial.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(v),
                                      err_msg=key)
    want = jeng.fit_gbdt_elastic(x, y, jeng.GBDTParams(**GBDT),
                                 checkpoint_dir=str(tmp_path / "jax"),
                                 n_hosts=4, grace=30.0)
    # the tie rule (ROADMAP.md, deliberate differences: GBDT): where two
    # splits' gains tie exactly another feature may win, with the same
    # predictions; at most 2 of the 70 nodes, and the scores within 1e-5
    split_differs = ((ens.feature.numpy() != np.asarray(want.feature))
                     | (ens.threshold.numpy() != np.asarray(want.threshold)))
    assert split_differs.size == 70 and split_differs.sum() <= 2
    np.testing.assert_allclose(
        teng.predict_raw(ens, x, predict_impl="dense"),
        np.asarray(jeng.predict_raw(want, x, predict_impl="dense")),
        atol=1e-5)


def _mesh():
    from mmlspark_tpu_torch.parallel import mesh as meshlib
    return meshlib.create_mesh()


def test_elastic_gbdt_resume_restores_bagging_and_early_stopping(tmp_path):
    """The snapshot carries both RNG streams, the bagging row mask, the
    holdout margins and the early-stopping state: a fit killed between
    bagging draws resumes on the serial fit's trees bit for bit."""
    x, y = _gbdt_data()
    p = teng.GBDTParams(**dict(GBDT, bagging_fraction=0.7, bagging_freq=3,
                               feature_fraction=0.6, early_stopping_round=3,
                               num_iterations=12))
    coord = elastic.ElasticFitCoordinator(
        checkpoint_dir=str(tmp_path / "ck"), n_hosts=2, grace=60.0)
    calls = []

    def attempt(devices, ctx):
        calls.append(len(coord.committed))
        if len(calls) == 1:
            orig = ctx.step_committed

            def lose_after_four(epoch, step):
                orig(epoch, step)
                if step == 4:
                    coord.supervisor._dead.add("host1")
            ctx.step_committed = lose_after_four
        else:
            ctx.step_committed = type(ctx).step_committed.__get__(ctx)
        return teng.fit_gbdt(x, y, p, mesh=_mesh(), elastic_ctx=ctx,
                             device="cpu")

    ens = coord.run(attempt)
    assert calls == [0, 5]
    assert coord.attempts[-1]["resume_pos"] == (0, 4)
    want = tstages._ensemble_to_state(teng.fit_gbdt(
        x, y, p._replace(tree_learner="serial"), device="cpu"))
    got = tstages._ensemble_to_state(ens)
    for key, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(v),
                                      err_msg=key)


def test_elastic_gbdt_stage_routing(tmp_path):
    """elasticConfig on the LightGBM stage routes the fit through the
    coordinator: a clean run is the plain stage fit's model."""
    rng = np.random.default_rng(0)
    n = 2000
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)
    df = DataFrame({"features": object_column([r for r in x]), "label": y})
    kw = dict(numIterations=5, numLeaves=4, device="cpu")
    model = tstages.LightGBMClassifier(
        elasticConfig={"checkpointDir": str(tmp_path / "ck"), "hosts": 4,
                       "graceSeconds": 5.0}, **kw).fit(df)
    pred = np.asarray(model.transform(df).col("prediction"))
    assert (pred == y).mean() > 0.8
    plain = tstages.LightGBMClassifier(**kw).fit(df)
    np.testing.assert_array_equal(
        pred, np.asarray(plain.transform(df).col("prediction")))
    with pytest.raises(ValueError, match="data-parallel"):
        tstages.LightGBMClassifier(
            parallelism="serial",
            elasticConfig={"checkpointDir": str(tmp_path / "s")},
            **kw).fit(df)


# ------------------------------------------------ rendezvous + fleet health

DIST = {"torch": distributed, "jax": jax_dist}


def _rdzv(pkg_name, d, host="host0"):
    kw = {"device": "cpu"} if pkg_name == "torch" else {}
    return DIST[pkg_name].RendezvousCoordinator(str(d), host, **kw)


@pytest.mark.parametrize("a,b", [("torch", "jax"), ("jax", "torch")])
def test_propose_and_read_across_packages(tmp_path, a, b):
    """A generation proposed by one package is read, extended and awaited
    by the other: the docs and lease files cross over."""
    first = _rdzv(a, tmp_path)
    doc = first.propose(["host0", "host1"])
    assert doc["generation"] == 1
    assert doc["ranks"] == {"host0": 0, "host1": 1}
    second = _rdzv(b, tmp_path)
    assert second.read()["generation"] == 1
    assert second.lease.read()["holder"] == "host0"
    doc2 = second.propose(["host0"])        # same host id: the lease is ours
    assert doc2["generation"] == 2 and doc2["lease_term"] == 2
    assert first.read()["generation"] == 2
    follower = _rdzv(a, tmp_path, host="host2")
    with pytest.raises(DIST[a].RendezvousError, match="named"):
        follower.await_membership(2, timeout=0.3)
    second.propose(["host0", "host1", "host2"])
    assert follower.await_membership(3, timeout=1.0)["ranks"]["host2"] == 2


def test_only_the_leader_may_propose(tmp_path):
    r = _rdzv("torch", tmp_path, host="host1")
    with pytest.raises(distributed.RendezvousError, match="leader"):
        r.propose(["host0", "host1"])
    # a survivor leads when the lowest host is a parked joiner
    doc = r.propose(["host0", "host1"], leaders=["host1"])
    assert doc["leader"] == "host1" and doc["ranks"]["host0"] == 0


def test_a_fresh_lease_of_another_package_refuses_takeover(tmp_path):
    _rdzv("jax", tmp_path, host="host0").propose(["host0", "host1"])
    r = _rdzv("torch", tmp_path, host="host1")
    with pytest.raises(distributed.RendezvousError, match="fresh leader"):
        r.propose(["host1"])


def test_stale_generation_can_never_be_joined(tmp_path):
    r = _rdzv("torch", tmp_path)
    doc = _rdzv("jax", tmp_path).propose(["host0", "host1"])
    r.generation = 5
    with pytest.raises(distributed.RendezvousError, match="[Ss]tale"):
        r.join(doc)


def test_join_refuses_a_doc_that_omits_us(tmp_path):
    doc = _rdzv("jax", tmp_path).propose(["host0", "host1"])
    with pytest.raises(distributed.RendezvousError, match="include"):
        _rdzv("torch", tmp_path, host="host9").join(doc)


def test_rendezvous_fault_site(tmp_path):
    faults.configure("distributed.rendezvous:error:1.0", seed=0)
    with pytest.raises(ConnectionError):
        _rdzv("torch", tmp_path).propose(["host0"])


def test_deterministic_unwind_at_boundary(tmp_path):
    """check_rendezvous raises RendezvousPending exactly when the committed
    step reaches the doc's unwind_at (a JAX leader's proposal here)."""
    hb = tmp_path / "ck" / "heartbeats"
    os.makedirs(str(hb), exist_ok=True)
    coord = elastic.ElasticFitCoordinator(
        _elastic_learner(str(tmp_path / "ck")), n_hosts=2, grace=60.0)
    coord._rdzv = _rdzv("torch", hb, host="host1")
    coord._multiproc = True
    coord._mesh_hosts = {"host0", "host1"}
    coord.check_rendezvous(0, 3)
    _rdzv("jax", hb).propose(["host0", "host1"], unwind_at=(0, 6))
    coord.check_rendezvous(0, 4)
    coord.check_rendezvous(0, 5)
    time.sleep(0.06)
    with pytest.raises(elastic.RendezvousPending):
        coord.check_rendezvous(0, 6)


def test_rendezvous_failure_falls_back_to_full_relaunch(tmp_path,
                                                        telemetry_on):
    hb_dir = tmp_path / "ck" / "heartbeats"
    os.makedirs(str(hb_dir), exist_ok=True)
    coord = elastic.ElasticFitCoordinator(
        _elastic_learner(str(tmp_path / "ck")), n_hosts=2, grace=60.0,
        max_failures=2)
    coord._rdzv = _rdzv("torch", hb_dir)
    coord._multiproc = True
    coord._mesh_hosts = {"host0", "host1"}
    faults.configure("distributed.rendezvous:error:1.0", seed=0)
    t0 = time.monotonic()
    with pytest.raises(elastic.ElasticFleetLost, match="relaunch"):
        coord._rendezvous_cycle(coord.heartbeats["host0"])
    assert time.monotonic() - t0 >= 0.2
    assert faults.snapshot()["distributed.rendezvous"][0]["injected"] >= 2


def test_one_process_generations_form_and_tear_down(tmp_path):
    """A generation of one gloo rank through the rendezvous doc: join,
    a collective, teardown without a collective, a second generation."""
    hb = str(tmp_path / "hb")
    os.makedirs(hb)
    r = _rdzv("torch", hb)
    try:
        for gen in (1, 2):
            r.join(r.propose(["host0"]))
            assert r.generation == gen and distributed.is_initialized()
            distributed.process_barrier()
            distributed.teardown_for_rendezvous()
            assert not torch.distributed.is_initialized()
    finally:
        distributed.teardown_for_rendezvous()


def test_fleet_health_surfaces_on_healthz(tmp_path):
    from mmlspark_tpu_torch.io.http.server import HTTPSource
    assert elastic.fleet_health() is None
    coord = elastic.ElasticFitCoordinator(
        _elastic_learner(str(tmp_path / "ck")), n_hosts=4, grace=60.0,
        evict_after=2)
    coord._mesh_hosts = {"host0", "host1", "host2", "host3"}
    coord.supervisor._dead.add("host3")
    coord.supervisor._flagged.add("host2")
    coord.supervisor._evict["host2"] = 0.0
    coord.supervisor._joining["host3"] = 0.0
    elastic._register_fleet(coord)
    try:
        h = elastic.fleet_health()
        assert h["hosts_alive"] == 3 and h["dead"] == ["host3"]
        assert h["stragglers"] == ["host2"]
        assert h["pending_evict"] == ["host2"]
        assert h["pending_grow"] == ["host3"]
        assert h["rendezvous_generation"] == 0
        src = HTTPSource(name="t", host="127.0.0.1", port=0)
        try:
            body = json.loads(urllib.request.urlopen(
                src.url + "healthz", timeout=5).read())
            assert body["elastic"]["hosts_alive"] == 3
            assert body["elastic"]["pending_evict"] == ["host2"]
        finally:
            src.close()
    finally:
        elastic._unregister_fleet(coord)
    assert elastic.fleet_health() is None

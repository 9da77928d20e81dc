"""Real multi-process elastic fits of the port: gloo ranks as separate
processes on the CPU, one of them ``kill -9``'d mid-epoch (the JAX
package's tests/test_elastic_multiproc.py, over ``torch.distributed``).

* Fixed fleet (``initialize_from_env``, no rendezvous): the survivor's
  next collective fails at once (gloo), and the coordinator fails FAST
  with ``ElasticFleetLost`` within one grace window, never a hung
  collective: the survivor exits non-zero within 30 s of the kill.
* Relaunch at full size against the same checkpointDir after rank 0 —
  the rank that writes every checkpoint file — is killed: the resumed fit
  ends on the uninterrupted 2-rank fit's parameters bit for bit.
* Re-rendezvous (``elastic_initialize``): the killed process relaunches,
  parks behind a joining heartbeat and joins the running fit's next
  generation (a fresh store and process group); the final generation is
  at least 2 and the parameters are the uninterrupted fit's bit for bit.
  Killed: rank 1, and rank 0, whose store dies with it — the survivor
  then leads the next generation and hosts its store.

Shuffle is off, so a resumed fit replays the uninterrupted fit's batches;
``elasticMinHosts=2`` keeps every step on the full fleet. Each process
takes 3-5 s to import torch; the kill is timed against the first step
checkpoint of a fit paced by a ``trainer.step`` delay. Each case takes
5-16 s on one core, so all run in tier-1.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r'''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.models.trainer import TorchLearner, _params_digest
from mmlspark_tpu_torch.parallel import distributed as dist

ck = os.environ["TEST_CKPT_DIR"]
rendezvous = os.environ.get("TEST_RENDEZVOUS") == "1"
if rendezvous:
    assert dist.elastic_initialize(ck, device="cpu") is True
    rdzv = dist.rendezvous_coordinator()
    print(f"JOINED_GEN={rdzv.generation}", flush=True)
else:
    assert dist.initialize_from_env(device="cpu") is True
pid = int(os.environ["MMLTPU_PROCESS_ID"])
# each process feeds its own shard; shuffle off, so a resumed fit replays
# the identical batch order
rng = np.random.default_rng(7 + pid)
n = 64
x = rng.normal(size=(n, 4)).astype(np.float32)
y = (x[:, 0] > 0).astype(np.int64)
df = DataFrame({"features": object_column([r for r in x]), "label": y})
learner = TorchLearner(
    modelConfig={"type": "mlp", "hidden": [4], "num_classes": 2},
    epochs=2, batchSize=16, learningRate=0.05, shuffle=False,
    deviceDataCap=1, checkpointDir=ck, checkpointEverySteps=2,
    elastic=True, elasticMinHosts=2, elasticGraceSeconds=1.0,
    device="cpu")
print(f"RESUME_POS={learner._latest_checkpoint()}", flush=True)
model = learner.fit(df)
if rendezvous:
    print(f"FINAL_GEN={rdzv.generation}", flush=True)
print(f"DIGEST={_params_digest(model.getModelParams(), learner._ckpt_cfg)}",
      flush=True)
print("ELASTIC_MP_OK", flush=True)
'''

PACE = "trainer.step:delay:1.0:0.1"


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(worker, ck, pid, port, faults="", rendezvous=False):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MMLTPU_COORDINATOR=f"127.0.0.1:{port}",
               MMLTPU_NUM_PROCESSES="2", MMLTPU_PROCESS_ID=str(pid),
               MMLTPU_INIT_TIMEOUT="20", MMLTPU_HOST_ADDRESS="127.0.0.1",
               MMLTPU_REJOIN_TIMEOUT="120", MMLTPU_LEASE_TIMEOUT="2",
               TEST_CKPT_DIR=str(ck),
               TEST_RENDEZVOUS="1" if rendezvous else "0")
    env.pop("MMLSPARK_TPU_TELEMETRY", None)
    if faults:
        env["MMLSPARK_TPU_FAULTS"] = faults
    else:
        env.pop("MMLSPARK_TPU_FAULTS", None)
    return subprocess.Popen([sys.executable, str(worker)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _drain(p, timeout):
    try:
        return p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        return out, err + "\n<killed: timeout>"


def _field(out, key):
    return [ln.split("=", 1)[1] for ln in out.splitlines()
            if ln.startswith(key + "=")]


def _kill_at_first_step_checkpoint(ck, victim, others):
    """SIGKILL ``victim`` once a step checkpoint is committed; the time of
    the kill (monotonic)."""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if ck.is_dir() and any("_s" in f for f in os.listdir(ck)
                               if f.endswith(".msgpack")):
            os.kill(victim.pid, signal.SIGKILL)
            return time.monotonic()
        if victim.poll() is not None or any(p.poll() is not None
                                            for p in others):
            break
        time.sleep(0.02)
    raise AssertionError("no step checkpoint appeared to time the kill "
                         "against")


@pytest.fixture
def worker(tmp_path):
    path = tmp_path / "elastic_worker.py"
    path.write_text(_WORKER)
    return path


def _baseline(worker, ck, rendezvous=False):
    """The uninterrupted 2-process elastic fit's digest."""
    port = _free_port()
    procs = [_launch(worker, ck, i, port, rendezvous=rendezvous)
             for i in range(2)]
    digests = []
    for p in procs:
        out, err = _drain(p, timeout=180)
        assert p.returncode == 0, (out[-1500:], err[-1500:])
        digests += _field(out, "DIGEST")
    assert len(digests) == 2 and digests[0] == digests[1]
    return digests[0]


def test_survivor_fails_fast_on_a_killed_peer(worker, tmp_path):
    """Fixed fleet: rank 1 is kill -9'd mid-epoch; rank 0's collective
    fails and the coordinator raises ElasticFleetLost (pointing at the
    relaunch) within 30 s of the kill instead of hanging."""
    ck = tmp_path / "ck"
    port = _free_port()
    procs = [_launch(worker, ck, i, port, faults=PACE) for i in range(2)]
    t_kill = _kill_at_first_step_checkpoint(ck, procs[1], procs[:1])
    _drain(procs[1], timeout=30)
    out, err = _drain(procs[0], timeout=60)
    took = time.monotonic() - t_kill
    assert procs[0].returncode != 0, (out[-1500:], err[-1500:])
    assert "ELASTIC_MP_OK" not in out
    assert "ElasticFleetLost" in err and "relaunch" in err.lower(), \
        err[-2000:]
    assert "<killed: timeout>" not in err
    assert took < 30, took


def test_relaunch_at_full_size_after_rank0_kill_is_bitexact(worker,
                                                             tmp_path):
    """Rank 0 (it writes every checkpoint file) is kill -9'd at the first
    step checkpoint; rank 1 fails fast; the fleet relaunches at full size
    against the same checkpointDir, resumes, and ends on the uninterrupted
    2-process fit's parameters bit for bit."""
    ck = tmp_path / "ck"
    port = _free_port()
    procs = [_launch(worker, ck, i, port, faults=PACE) for i in range(2)]
    _kill_at_first_step_checkpoint(ck, procs[0], procs[1:])
    _drain(procs[0], timeout=30)
    out, err = _drain(procs[1], timeout=60)
    assert procs[1].returncode != 0, (out[-1500:], err[-1500:])
    port = _free_port()
    procs = [_launch(worker, ck, i, port) for i in range(2)]
    digests = []
    for p in procs:
        out, err = _drain(p, timeout=180)
        assert p.returncode == 0, (out[-1500:], err[-1500:])
        assert "ELASTIC_MP_OK" in out
        assert _field(out, "RESUME_POS")[0] != "None", "must RESUME"
        digests += _field(out, "DIGEST")
    assert len(digests) == 2 and digests[0] == digests[1]
    assert digests[0] == _baseline(worker, tmp_path / "ck_clean")


@pytest.mark.parametrize("victim", [1, 0])
def test_killed_process_rejoins_the_running_fit_bitexact(worker, tmp_path,
                                                         victim):
    """THE re-rendezvous acceptance: kill -9 one process mid-fit and
    relaunch it; it parks behind a joining heartbeat and joins the next
    generation (a fresh store on a free port, hosted by that generation's
    leader: the survivor when rank 0 was killed) instead of forcing a
    full-size relaunch. The survivor either re-rendezvouses in-job or, if
    its attempt was pinned, fails fast and its own relaunch re-enters the
    same lineage. min_hosts=2, so the final parameters equal an
    uninterrupted 2-process run's bit for bit."""
    ck = tmp_path / "ck"
    port = _free_port()
    procs = [_launch(worker, ck, i, port, faults=PACE, rendezvous=True)
             for i in range(2)]
    survivor = procs[1 - victim]
    _kill_at_first_step_checkpoint(ck, procs[victim], [survivor])
    _drain(procs[victim], timeout=30)
    rejoin = _launch(worker, ck, victim, port, faults=PACE, rendezvous=True)
    out_s, err_s = _drain(survivor, timeout=240)
    if survivor.returncode != 0:
        # pinned inside the dead collective: it failed fast and its
        # relaunch re-enters the same rendezvous lineage
        assert "ElasticFleetLost" in err_s or "rendezvous" in err_s, \
            (out_s[-1000:], err_s[-1500:])
        survivor = _launch(worker, ck, 1 - victim, port, faults=PACE,
                           rendezvous=True)
        out_s, err_s = _drain(survivor, timeout=240)
    out_r, err_r = _drain(rejoin, timeout=240)
    assert survivor.returncode == 0, (out_s[-1500:], err_s[-2500:])
    assert rejoin.returncode == 0, (out_r[-1500:], err_r[-2500:])
    assert "ELASTIC_MP_OK" in out_s and "ELASTIC_MP_OK" in out_r
    final = _field(out_s, "FINAL_GEN")[-1]
    assert int(final) >= 2 and _field(out_r, "FINAL_GEN")[-1] == final
    assert int(_field(out_r, "JOINED_GEN")[-1]) >= 2
    digest = _field(out_s, "DIGEST")[0]
    assert _field(out_r, "DIGEST")[0] == digest
    assert digest == _baseline(worker, tmp_path / "ck_clean",
                               rendezvous=True)

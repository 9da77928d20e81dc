"""The port's distributed substrate (``parallel/{mesh,distributed,
dataplane}.py``) against the JAX package's.

* Meshes with no process group: the JAX package's errors, word for word,
  for a mesh larger than the world (one rank: ``tensorParallel=2`` never
  runs unsharded); ``local_fit_mode``; the launch-rank host id.
* ``TP_PARAM_RULES`` (and the EP rules) give every flax leaf the spec the
  JAX package's ``shard_params_tp`` gives it on an 8-device (data 4,
  model 2) mesh — the divisibility fallback included — and a rank's slice
  of a state_dict is its shard of the flax kernel, transposed.
* One 2-rank gloo group (``tests/torch_dist_workers.py``) runs the rest:
  ``process_barrier``, the object gathers, ``ShardedDataFrame``'s global
  count, collect, groupBy/agg, distinct, limit and joins against the same
  ops on the plain frame of all rows (as ``tests/test_dataplane.py`` holds
  the JAX package's), meshes over two ranks and their errors, host groups,
  the inner-block locality rule, and the multi-process transform
  (``_transform_multihost``) of a dense transformer, a MoE transformer
  whose capacity binds (capacity 1.0: the routing is global) and a
  ``tensorParallel=2`` model, with rank 1's shard shorter (dummy chunks).
  Scores match the JAX package's module on the same global chunks within
  1e-5 (float32), and the TP ones ``TpuModel(tensorParallel=2)`` on the
  8-device mesh.
* ``initialize_from_env`` with 2 ranks over a TCPStore at
  ``MMLTPU_COORDINATOR``, and a fleet missing one worker failing its
  rendezvous inside ``MMLTPU_INIT_TIMEOUT``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.models.modules import build_model as jax_build_model
from mmlspark_tpu.parallel import mesh as jmesh
from mmlspark_tpu_torch.parallel import distributed
from mmlspark_tpu_torch.parallel import mesh as meshlib

from torch_dist_workers import free_port, run_ranks

CFG = {"type": "transformer", "vocab_size": 17, "d_model": 8, "heads": 2,
       "layers": 1, "num_classes": 4, "max_len": 8, "dtype": "float32"}
MOE = dict(CFG, num_experts=4, capacity_factor=1.0)
FRAME = {"k": np.array([0, 1, 0, 2, 1, 0, 3, 2, 5]),
         "v": np.array([1, 2, 3, 4, 5, 6, 7, 8, 9])}


def _flax_init(cfg, seed=0):
    v = jax_build_model(cfg).init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, v)


# ------------------------------------------------------------ no group

def test_meshes_without_a_group_raise_the_jax_errors():
    one = jax.devices()[:1]
    pairs = [(lambda: meshlib.create_mesh(model=2),
              lambda: jmesh.create_mesh(model=2, devices=one)),
             (lambda: meshlib.create_mesh(model=3),
              lambda: jmesh.create_mesh(model=3, devices=one)),
             (lambda: meshlib.make_mesh({"data": 1, "model": 2}),
              lambda: jmesh.make_mesh({"data": 1, "model": 2}, devices=one)),
             (lambda: meshlib.make_mesh({"data": 0}),
              lambda: jmesh.make_mesh({"data": 0}, devices=one))]
    for port, ref in pairs:
        with pytest.raises(ValueError) as got:
            port()
        with pytest.raises(ValueError) as want:
            ref()
        assert str(got.value) == str(want.value)
    m = meshlib.create_mesh()
    assert (m.shape, m.size, m.distributed) == ({"data": 1, "model": 1}, 1,
                                                False)
    assert m.axis_index("model") == 0 and m.group("model") is None
    with pytest.raises(ValueError, match="no axis"):
        m.group("seq")
    distributed.process_barrier()            # no group: nothing to wait on


def test_local_fit_mode_and_host_ids(monkeypatch):
    assert meshlib.effective_process_count() == 1
    with meshlib.local_fit_mode():
        with meshlib.local_fit_mode():
            assert meshlib.in_local_fit()
        assert meshlib.in_local_fit()
    assert not meshlib.in_local_fit()
    monkeypatch.setenv("MMLTPU_PROCESS_ID", "3")
    assert meshlib.stable_host_id() == "host3"
    monkeypatch.delenv("MMLTPU_PROCESS_ID")
    assert meshlib.stable_host_id() == "host0"
    assert meshlib.host_device_groups() == [("host0", [0])]
    with pytest.raises(ValueError, match="cannot split"):
        meshlib.host_device_groups(2)
    a = np.arange(5.0)
    m = meshlib.create_mesh()
    padded, n = meshlib.pad_batch_to_devices(a, m)
    assert n == 5 and np.array_equal(padded, a)
    # placement on a one-rank mesh: the array itself, on the mesh's device
    assert meshlib.batch_sharding(m).spec == meshlib.P("data")
    assert meshlib.replicated(m).spec == meshlib.P()
    t = meshlib.put_global_batch(a, m)
    assert isinstance(t, torch.Tensor) and t.device == m.device
    np.testing.assert_array_equal(meshlib.local_rows(t, 3), a[:3])
    np.testing.assert_array_equal(meshlib.local_rows(
        meshlib.shard_batch([a], m)[0]), a)
    rep = meshlib.put_replicated({"w": a}, m)
    assert torch.equal(rep["w"], torch.from_numpy(a))
    # a 4-row batch does not split over a 3-way data axis without padding
    with pytest.raises(ValueError, match="pad it first"):
        meshlib.shard_batch(np.arange(4.0),
                            meshlib.Mesh({"data": 3}, torch.device("cpu")))


def _spec(s):
    t = tuple(s)
    while t and t[-1] is None:
        t = t[:-1]
    return t


@pytest.mark.parametrize("cfg,rules,axes", [
    (CFG, "tp", {"data": 4, "model": 2}),
    (dict(CFG, num_classes=3), "tp", {"data": 4, "model": 2}),
    (MOE, "tp", {"data": 4, "model": 2}),
    (MOE, "ep", {"data": 2, "expert": 2, "model": 2})])
def test_param_specs_match_shard_params_tp(cfg, rules, axes):
    from jax.sharding import PartitionSpec as JP
    flax = _flax_init(cfg)
    jm = jmesh.make_mesh(axes)
    jrules = (list(jmesh.TP_PARAM_RULES) if rules == "tp" else
              [("expert_w", JP("expert",)), ("expert_b", JP("expert",))]
              + list(jmesh.TP_PARAM_RULES))
    placed = jmesh.shard_params_tp(flax["params"], jm, jrules)
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            _spec(leaf.sharding.spec) for path, leaf in
            jax.tree_util.tree_flatten_with_path(placed)[0]}
    pm = meshlib.Mesh(axes, torch.device("cpu"))
    prules = (list(meshlib.TP_PARAM_RULES) if rules == "tp" else
              list(meshlib.EP_PARAM_RULES) + list(meshlib.TP_PARAM_RULES))
    got = {k: _spec(s) for k, s in
           meshlib.param_specs(flax, pm, prules).items()}
    assert got == want
    # the divisibility fallback: a 3-class head stays replicated
    head = want["Dense_0/kernel"]
    assert head == ((None, "model") if cfg["num_classes"] % 2 == 0 else ())


def test_state_dict_shards_are_the_flax_kernel_shards(monkeypatch):
    """Rank 1's slice of the port's qkv weight (out, in) is the transpose
    of the JAX package's model-axis shard 1 of the flax kernel (in, out)."""
    from mmlspark_tpu_torch.models.weights import from_flax_params
    flax = _flax_init(CFG)
    sd = from_flax_params(flax, CFG)
    pm = meshlib.Mesh({"data": 1, "model": 2}, torch.device("cpu"))
    monkeypatch.setattr(pm, "axis_index", lambda axis: 1)
    local = meshlib.shard_params_tp(sd, pm, meshlib.TP_PARAM_RULES,
                                    config=CFG)
    kernel = flax["params"]["block0"]["Dense_0"]["kernel"]     # (8, 24)
    np.testing.assert_array_equal(local["blocks.0.qkv.weight"].numpy(),
                                  kernel[:, 12:].T)
    # biases (1-D) and embeddings never split
    assert local["blocks.0.fc1.bias"].shape == sd["blocks.0.fc1.bias"].shape
    assert torch.equal(local["tok_embed.weight"], sd["tok_embed.weight"])


# ------------------------------------------------------------ 2 ranks

@pytest.fixture(scope="module")
def substrate(tmp_path_factory):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 17, size=(9, 8))
    res = run_ranks(2, "substrate", tmp_path_factory.mktemp("sub"),
                    frame=FRAME, toks=toks, cfg=CFG, moe_cfg=MOE,
                    flax_dense=_flax_init(CFG), flax_moe=_flax_init(MOE, 1))
    return toks, res


def test_object_gathers_and_barrier(substrate):
    _, (r0, r1) = substrate
    for r in (r0, r1):
        assert r["pyobj"] == [{"rank": 0, "blob": b""},
                              {"rank": 1, "blob": b"x"}]
        np.testing.assert_array_equal(r["sum"], np.arange(3) * 3)
    assert (r0["cap"], r1["cap"]) == (10, 20)
    assert r0["paths"] + r1["paths"] == ["f0", "f2", "f4", "f1", "f3"]


def test_sharded_frame_matches_the_plain_frame(substrate):
    _, (r0, r1) = substrate
    plain = JaxDataFrame(FRAME)
    assert r0["count"] == r1["count"] == plain.count()
    want = sorted(r["k"] * 1000 + r["v"] for r in plain.collect())
    assert r0["collect"] == r1["collect"] == want
    agg = plain.groupBy("k").agg(s=("v", "sum"), m=("v", "mean"),
                                 c=("v", "count"), lo=("v", "min"))
    order = np.argsort(agg.col("k"))
    for r in (r0, r1):
        got = np.argsort(r["agg"]["k"])
        for c in ("k", "s", "m", "c", "lo"):
            np.testing.assert_allclose(np.asarray(r["agg"][c])[got],
                                       agg.col(c)[order])
    assert r0["distinct"] == sorted(set(FRAME["k"].tolist()))
    assert r0["limit"] + r1["limit"] == 5
    right = JaxDataFrame({"k": np.array([0, 1, 9]),
                          "name": np.array(["a", "b", "z"], dtype=object)})
    for how in ("inner", "left", "outer"):
        assert (r0[f"join_{how}"] + r1[f"join_{how}"]
                == plain.join(right, "k", how=how).count()), how


def test_two_rank_meshes_and_locality(substrate):
    _, (r0, r1) = substrate
    # a global batch's rows split over the data axis; local rows need no
    # padding (one data index a rank)
    np.testing.assert_array_equal(r0["shard_batch"], [0, 1, 2, 3])
    np.testing.assert_array_equal(r1["shard_batch"], [4, 5, 6, 7])
    assert r0["padded"][1] == 3 and len(r0["padded"][0]) == 3
    assert r0["mesh"] == ({"data": 1, "model": 2}, 0, 0, 2)
    assert r1["mesh"] == ({"data": 1, "model": 2}, 1, 0, 2)
    assert r0["mesh_errors"] == [
        "mesh {'data': 2, 'model': 2} needs 4 devices, have 2",
        "mesh {'model': 3} needs 3 devices, have 2"]
    assert r0["hosts"] == [("host0", [0, 1])]
    assert r0["hosts2"] == [("host0", [0]), ("host1", [1])]
    assert "must divide the LOCAL device count (2)" in r0["inner_error"]


def _global_chunks(toks, bs=3):
    """The JAX package's multi-host chunks: each step stacks every rank's
    ``bs`` rows (rank 1's shard is 2 rows: one short chunk, then a dummy),
    with a row mask of the real rows."""
    shards = [toks[0::2], toks[1::2][:2]]
    n_chunks = -(-max(len(s) for s in shards) // bs)
    for c in range(n_chunks):
        xs, ms = [], []
        for s in shards:
            part = s[c * bs:(c + 1) * bs]
            m = np.zeros(bs, np.float32)
            m[:len(part)] = 1
            xs.append(np.concatenate([part, np.zeros((bs - len(part), 8),
                                                     part.dtype)]))
            ms.append(m)
        yield np.concatenate(xs), np.concatenate(ms)


@pytest.mark.parametrize("name,cfg,seed", [("dense", CFG, 0),
                                           ("moe", MOE, 1),
                                           ("tp", CFG, 0)])
def test_multi_process_transform_matches_jax(substrate, name, cfg, seed):
    toks, (r0, r1) = substrate
    module = jax_build_model(cfg)
    params = _flax_init(cfg, seed)
    per_rank = [[], []]
    for x, m in _global_chunks(toks):
        kw = {"row_mask": jnp.asarray(m)} if "num_experts" in cfg else {}
        y = np.asarray(module.apply(params, jnp.asarray(x, jnp.int32), **kw))
        for r in range(2):
            rows = y[r * 3:(r + 1) * 3][m[r * 3:(r + 1) * 3] > 0]
            per_rank[r].append(rows)
    for r, got in enumerate((r0, r1)):
        want = np.concatenate(per_rank[r])
        assert got[f"scores_{name}"].shape == want.shape
        np.testing.assert_allclose(got[f"scores_{name}"], want, atol=1e-5,
                                   rtol=1e-5)
    if name == "tp":
        # and TpuModel(tensorParallel=2) on the 8-device mesh (data 4 x
        # model 2) scores the same rows alike
        from mmlspark_tpu.models.tpu_model import TpuModel
        rows = [toks[0::2], toks[1::2][:2]]
        col = np.empty(sum(len(x) for x in rows), dtype=object)
        for i, row in enumerate(np.concatenate(rows)):
            col[i] = row.astype(np.float32)
        jm = (TpuModel().setInputCol("features").setModelConfig(cfg)
              .setModelParams(params).setTensorParallel(2))
        want = np.stack(jm.transform(JaxDataFrame({"features": col}))
                        .col("scores"))
        got = np.concatenate([r0["scores_tp"], r1["scores_tp"]])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_moe_capacity_binds_in_the_transform_case(substrate):
    """The MoE case drops tokens: capacity 1.0 at top-2 of 4 experts holds
    half the (token, choice) pairs, and the routing is uneven."""
    from mmlspark_tpu.models.moe import MoEMLP
    toks, _ = substrate
    x, m = next(_global_chunks(toks))
    params = _flax_init(MOE, 1)["params"]
    emb = (params["Embed_0"]["embedding"][x]
           + params["Embed_1"]["embedding"][np.arange(8)])
    moe = MoEMLP(num_experts=4, d_hidden=32, capacity_factor=1.0,
                 dtype=jnp.float32)
    h = np.asarray(moe.apply({"params": params["block0"]["MoEMLP_0"]},
                             jnp.asarray(emb), row_mask=jnp.asarray(m)))
    full = np.asarray(MoEMLP(num_experts=4, d_hidden=32,
                             capacity_factor=4.0, dtype=jnp.float32).apply(
        {"params": params["block0"]["MoEMLP_0"]}, jnp.asarray(emb),
        row_mask=jnp.asarray(m)))
    assert not np.allclose(h, full)


# ------------------------------------------------------------ rendezvous

def test_initialize_from_env_and_barrier(tmp_path):
    port = free_port()
    env = [{"MMLTPU_COORDINATOR": f"127.0.0.1:{port}",
            "MMLTPU_NUM_PROCESSES": "2", "MMLTPU_PROCESS_ID": str(r)}
           for r in range(2)]
    res = run_ranks(2, "ranks", tmp_path, launch_env=env)
    assert res == [{"rank": r, "world": 2, "all": [0, 1]} for r in range(2)]
    assert distributed.initialize_from_env() is False    # no contract set


def test_rendezvous_times_out_on_missing_worker(tmp_path):
    env = [{"MMLTPU_COORDINATOR": f"127.0.0.1:{free_port()}",
            "MMLTPU_NUM_PROCESSES": "2", "MMLTPU_PROCESS_ID": "0",
            "MMLTPU_INIT_TIMEOUT": "3"}]
    t0 = time.monotonic()
    (rc, _out, err), = run_ranks(2, "ranks", tmp_path, launch_env=env,
                                 ranks=[0], expect_ok=False, timeout=90)
    assert rc != 0
    assert "rendezvous" in err and "failed within 3 s" in err
    assert time.monotonic() - t0 < 60


def test_elastic_half_raises_naming_item_13b(tmp_path, monkeypatch):
    """The elastic half is ported (tests/test_torch_elastic.py,
    tests/test_torch_elastic_multiproc.py): with no launcher contract
    elastic_initialize is single-process mode (False, no generation
    armed), and a coordinator proposes generation 1 under a fresh lease."""
    monkeypatch.delenv(distributed.ENV_COORDINATOR, raising=False)
    assert distributed.elastic_initialize(str(tmp_path / "ck"),
                                          device="cpu") is False
    assert distributed.rendezvous_coordinator() is None
    rdzv = distributed.RendezvousCoordinator(str(tmp_path), "host0",
                                             device="cpu")
    doc = rdzv.propose(["host0"])
    assert doc["generation"] == 1 and doc["ranks"] == {"host0": 0}
    assert doc["leader"] == "host0" and rdzv.lease.held()
    if not torch.cuda.is_available():      # a CUDA rank never uses gloo
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize("127.0.0.1:1", 1, 0, device="cuda")

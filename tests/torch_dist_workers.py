"""Multi-process helpers for the port's distributed tests (not a test file).

``run_ranks(world, job, tmp_path, **kw)`` starts ``world`` Python processes,
each joining one gloo process group over a ``FileStore`` under
``tmp_path`` (never a fixed port: several pytest workers run at once),
runs the job ``JOBS[job](rank, world, **kw)`` (or, for a ``job`` of the
form ``"module:function"``, that function of a module in this directory)
and pickles its result;
the caller gets the ranks' results in rank order. Every group has a time
limit, so a hung collective fails its test instead of eating the clock.
The workers import torch and the port only (no JAX).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_ranks(world: int, job: str, tmp_path, timeout: float = 180,
              expect_ok: bool = True, init_timeout: int = 60,
              launch_env=None, ranks=None, **kw):
    """``launch_env``: per-rank env dicts (the ``MMLTPU_*`` contract: the
    workers then rendezvous through ``initialize_from_env``); ``ranks``:
    start only these ranks (a missing peer)."""
    os.makedirs(str(tmp_path), exist_ok=True)
    tag = job.replace(":", "_")
    store = os.path.join(str(tmp_path), f"store_{tag}")
    if os.path.exists(store):
        os.remove(store)
    arg = os.path.join(str(tmp_path), f"args_{tag}.pkl")
    with open(arg, "wb") as f:
        pickle.dump(kw, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("MMLSPARK_TPU_TELEMETRY", None)
    procs = []
    for r in (range(world) if ranks is None else ranks):
        out = os.path.join(str(tmp_path), f"out_{tag}_{r}.pkl")
        penv = dict(env, **(launch_env[r] if launch_env else {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {HERE!r}); "
             f"import torch_dist_workers as w; w._main()",
             job, str(r), str(world), store, arg, out, str(init_timeout)],
            env=penv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    results, errs = [], []
    try:
        for r, p in enumerate(procs):
            o, e = p.communicate(timeout=timeout)
            errs.append((p.returncode, o[-2000:], e[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if not expect_ok:
        return errs
    for r, (rc, o, e) in enumerate(errs):
        assert rc == 0, f"rank {r} rc {rc}\n{o}\n{e}"
    for r in range(world):
        with open(os.path.join(str(tmp_path), f"out_{tag}_{r}.pkl"),
                  "rb") as f:
            results.append(pickle.load(f))
    return results


def _main():
    job, rank, world, store, arg, out, init_timeout = sys.argv[1:8]
    rank, world = int(rank), int(world)
    import torch
    torch.set_num_threads(1)
    from mmlspark_tpu_torch.parallel import distributed
    with open(arg, "rb") as f:
        kw = pickle.load(f)
    if os.environ.get(distributed.ENV_COORDINATOR):
        assert distributed.initialize_from_env(device="cpu")
    else:
        distributed.initialize(f"file://{store}", world, rank, device="cpu",
                               init_timeout=int(init_timeout))
    if ":" in job:
        import importlib
        mod, fn = job.split(":")
        run = getattr(importlib.import_module(mod), fn)
    else:
        run = JOBS[job]
    try:
        res = run(rank, world, **kw)
    finally:
        distributed.shutdown()
    with open(out, "wb") as f:
        pickle.dump(res, f)


# ------------------------------------------------------------------ jobs

def _np(t):
    import torch
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return t


def token_frame(rows, labels):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.utils import object_column
    return DataFrame({"features": object_column(
        [r.astype(np.float32) for r in rows]), "label": labels})


def block_cyclic(n: int, bs_local: int, world: int, rank: int):
    """The JAX tests' row split: rank p takes the rows of every
    world-th block of ``bs_local`` rows, so each step's global batch (rank
    order) is the solo fit's (shuffle off)."""
    return (np.arange(n) // bs_local) % world == rank


def fit_job(rank, world, cfg, knobs, toks, labels, batch, epochs=2,
            lr=0.05, optimizer="momentum", extra=None):
    """One fit on this rank's block-cyclic share; returns the whole params
    and the final loss (and the local shards' digest of replicated
    leaves, for the bit-equality checks)."""
    from mmlspark_tpu_torch.models.trainer import TorchLearner
    mine = block_cyclic(len(toks), batch // world, world, rank)
    df = token_frame(toks[mine], labels[mine])
    lr_ = TorchLearner(featuresCol="features", modelConfig=cfg,
                       device="cpu", epochs=epochs, batchSize=batch,
                       learningRate=lr, shuffle=False, deviceDataCap=1,
                       optimizer=optimizer, **knobs, **(extra or {}))
    model = lr_.fit(df)
    out = model.transform(df)
    return {"params": _np(model.getModelParams()),
            "loss": model._final_loss,
            "scores": np.stack([np.asarray(v) for v in out.col("scores")]),
            "rows": int(mine.sum())}





def _patch_init(flax_params):
    """Every rank starts from the JAX package's init (the port's own draws
    are not flax's bits)."""
    from mmlspark_tpu_torch.models import trainer
    from mmlspark_tpu_torch.models.weights import from_flax_params
    if flax_params is not None:
        trainer.init_params = lambda cfg, seed: from_flax_params(
            flax_params, cfg)


def run_ranks_async(*args, **kw):
    """run_ranks on a thread: a Future of its result, so the caller's own
    work (the JAX references) overlaps the group's."""
    import concurrent.futures
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(run_ranks, *args, **kw)
    ex.shutdown(wait=False)
    return fut


def fits_job(rank, world, fits, flax_params=None, streams=None,
             pipeline=None):
    """Several fits in one group: ``fits`` maps a name to fit_job's
    keyword arguments, ``streams`` a name to stream_job's; ``pipeline``:
    pipeline_job's keyword arguments."""
    _patch_init(flax_params)
    out = {name: fit_job(rank, world, **kw) for name, kw in fits.items()}
    for name, kw in (streams or {}).items():
        out[name] = stream_job(rank, world, **kw)
    if pipeline is not None:
        out["pipeline"] = pipeline_job(rank, world, **pipeline)
    return out


def stream_job(rank, world, cfg, toks, labels, batches, knobs=None):
    """fitStream where rank r's stream yields ``batches[r]`` (a list of row
    index arrays; an empty list is an empty stream)."""
    from mmlspark_tpu_torch.models.trainer import TorchLearner
    mine = batches[rank]

    def fn():
        for idx in mine:
            yield toks[idx].astype(np.int64), labels[idx]
    lr_ = TorchLearner(featuresCol="features", modelConfig=cfg,
                       device="cpu", epochs=2, learningRate=0.05,
                       **(knobs or {}))
    model = lr_.fitStream(fn)
    return {"params": _np(model.getModelParams()),
            "loss": model._final_loss,
            "batches": model._fit_stats["stream_batches"]}


def substrate_job(rank, world, frame, toks, cfg, moe_cfg, flax_dense,
                  flax_moe):
    """The substrate in one group: barrier, object gathers, the sharded
    frame's relational ops, meshes and their errors, host groups, and the
    multi-process transforms (dense, MoE at capacity 1.0, and TP)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.parallel import dataplane as dp
    from mmlspark_tpu_torch.parallel import distributed
    from mmlspark_tpu_torch.parallel import mesh as meshlib
    out = {}
    distributed.process_barrier("start")
    out["pyobj"] = dp.allgather_pyobj({"rank": rank, "blob": b"x" * rank})
    out["sum"] = dp.allreduce_sum(np.arange(3) * (rank + 1))
    out["cap"] = dp.proportional_sample_cap(10 * (rank + 1), 30)
    out["paths"] = dp.shard_paths([f"f{i}" for i in range(5)])
    # rank r holds the rows of frame with index % world == r
    local = {k: v[rank::world] for k, v in frame.items()}
    sdf = dp.ShardedDataFrame.fromLocal(DataFrame(local))
    out["count"] = sdf.globalCount()
    out["collect"] = sorted(r["k"] * 1000 + r["v"] for r in sdf.collectGlobal())
    agg = sdf.groupBy("k").agg(s=("v", "sum"), m=("v", "mean"),
                               c=("v", "count"), lo=("v", "min"))
    out["agg"] = {c: agg.col(c).tolist() for c in agg.columns}
    out["distinct"] = sorted(sdf.select("k").distinct().col("k").tolist())
    out["limit"] = sdf.limit(5).count()
    right = DataFrame({"k": np.array([0, 1, 9]), "name": np.array(
        ["a", "b", "z"], dtype=object)})
    for how in ("inner", "left", "outer"):
        j = sdf.join(right, "k", how=how)
        out[f"join_{how}"] = j.count()
    dm = meshlib.make_mesh({"data": world})
    out["shard_batch"] = meshlib.local_rows(
        meshlib.shard_batch(np.arange(4.0 * world), dm))
    out["padded"] = meshlib.pad_batch_to_local_devices(np.arange(3.0), dm)
    m = meshlib.make_mesh({"data": 1, "model": world})
    out["mesh"] = (m.shape, m.axis_index("model"), m.axis_index("data"),
                   dist_size(m.group("model")))
    errs = []
    for axes in ({"data": 2, "model": world}, {"model": world + 1}):
        try:
            meshlib.make_mesh(axes)
        except ValueError as e:
            errs.append(str(e))
    out["mesh_errors"] = errs
    out["hosts"] = meshlib.host_device_groups()
    out["hosts2"] = meshlib.host_device_groups(2)
    try:
        meshlib.require_inner_block_local({"tensorParallel": 4 * world})
    except ValueError as e:
        out["inner_error"] = str(e)
    # multi-process transforms: rank r's shard of the rows; rank 1's is
    # shorter, so it pads with dummy chunks
    rows = toks[rank::world] if rank == 0 else toks[rank::world][:2]
    tf = token_frame(rows, np.zeros(len(rows), np.int64))
    for name, c, params, tp in (("dense", cfg, flax_dense, 1),
                                ("moe", moe_cfg, flax_moe, 1),
                                ("tp", cfg, flax_dense, world)):
        model = TorchModel(inputCol="features", modelConfig=c,
                           modelParams=params, device="cpu",
                           miniBatchSize=3, tensorParallel=tp)
        sc = model.transform(tf).col("scores")
        out[f"scores_{name}"] = np.stack([np.asarray(v) for v in sc])
    out["rows"] = len(rows)
    distributed.process_barrier("end")
    return out


def dist_size(group):
    import torch.distributed as dist
    return dist.get_world_size(group)


def attention_job(rank, world, q, k, v, g, cases):
    """make_sp_attention over a ``seq`` axis of the whole world, for each
    (mode, causal) of ``cases``: every rank holds the whole (B, T, H, D)
    inputs (replicated, as in a fit); returns the output and the q/k/v
    gradients of sum(out * g)."""
    import torch
    from mmlspark_tpu_torch.parallel import mesh as meshlib
    from mmlspark_tpu_torch.parallel.sequence import make_sp_attention
    mesh = meshlib.make_mesh({"data": 1, "seq": world})
    out = {}
    for mode, causal in cases:
        attn = make_sp_attention(mesh, "seq", mode=mode, causal=causal)
        ts = [torch.tensor(a).to(torch.bfloat16).requires_grad_(True)
              for a in (q, k, v)]
        o = attn(*ts)
        (o.float() * torch.tensor(g)).sum().backward()
        out[(mode, causal)] = {"out": o.float().detach().numpy(),
                               "grads": [t.grad.float().numpy()
                                         for t in ts]}
    return out


def pipeline_job(rank, world, stages, x, cfg, flax_params, tokens, micro):
    """pipeline_apply of a tanh(h W + b) stage over a pipe axis of the
    world (output and the gradients of sum(out)), and the transformer's
    pipelined forward and its gradients."""
    import torch
    from mmlspark_tpu_torch.models.weights import from_flax_params
    from mmlspark_tpu_torch.parallel import mesh as meshlib
    from mmlspark_tpu_torch.parallel.pipeline_parallel import (
        pipeline_apply, shard_pipeline_params, stack_stage_params,
        transformer_pp_forward)
    mesh = meshlib.make_mesh({"pipe": world})
    stacked = stack_stage_params([{k: torch.tensor(v) for k, v in s.items()}
                                  for s in stages])
    local = shard_pipeline_params(stacked, mesh)
    local = {k: t.requires_grad_(True) for k, t in local.items()}
    xt = torch.tensor(x).requires_grad_(True)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    y = pipeline_apply(stage_fn, local, xt, mesh, n_microbatches=micro)
    y.sum().backward()
    sd = {k: t.requires_grad_(True)
          for k, t in from_flax_params(flax_params, cfg).items()}
    logits = transformer_pp_forward(cfg, sd, torch.tensor(tokens), mesh)
    logits.sum().backward()
    return {"y": y.detach().numpy(), "gx": xt.grad.numpy(),
            "gw": local["w"].grad.numpy(), "logits": logits.detach().numpy(),
            "grads": {k: t.grad.numpy() for k, t in sd.items()
                      if t.grad is not None}}


def ranks_job(rank, world):
    import torch.distributed as dist
    from mmlspark_tpu_torch.parallel import dataplane as dp
    from mmlspark_tpu_torch.parallel import distributed
    distributed.process_barrier()
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "all": dp.allgather_pyobj(rank)}


JOBS = {"fit": fit_job, "fits": fits_job, "stream": stream_job,
        "substrate": substrate_job, "attention": attention_job,
        "pipeline": pipeline_job, "ranks": ranks_job}

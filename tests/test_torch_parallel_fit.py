"""Distributed ``TorchLearner`` fits against the JAX package's.

Every port fit runs in gloo groups of separate processes
(``tests/torch_dist_workers.py``): each rank passes its block-cyclic share
of the rows (the JAX tests' split, ``tests/test_parallel_depth.py``), so
with shuffle off each step's global batch, in rank order, is the
single-process fit's. Each is held against ``TpuLearner`` on the
conftest's 8-device CPU mesh with the same knob (the same logical mesh:
data x model, data x pipe), from the same flax init, on the feed path
(``deviceDataCap=1``), float32:

* 2 ranks: data-parallel (momentum), ``tensorParallel=2`` (adam, global
  clip 0.5: the norm adds the shards' parts), ``pipelineParallel=2``
  (GPipe, 2 microbatches);
* 4 ranks: data x tensor parallel (2 x 2, adam, clip 0.5).

Params agree within 2e-4 and losses within 1e-5; the fitted tree is the
whole tree and the same bits on every rank (replicated leaves stay
bit-equal over their inner group). ``fitStream`` over unequal per-rank
streams, one rank's empty, trains as ``TpuLearner.fitStream`` over the
merged stream (each step's global batch). ``pipeline_apply`` and
``transformer_pp_forward`` match the JAX package's outputs and gradients
within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.core.utils import object_column as jax_object_column
from mmlspark_tpu.models import TpuLearner
from mmlspark_tpu.models.modules import build_model as jax_build_model
from mmlspark_tpu.parallel import mesh as jmesh
from mmlspark_tpu.parallel.pipeline_parallel import (
    pipeline_apply as jax_pipeline_apply, stack_stage_params as jax_stack,
    transformer_pp_forward as jax_pp_forward)
from mmlspark_tpu_torch.models.weights import from_flax_params

from torch_dist_workers import run_ranks_async

CFG = {"type": "transformer", "vocab_size": 17, "d_model": 8, "heads": 2,
       "layers": 2, "num_classes": 2, "max_len": 8, "dtype": "float32"}
N, B = 32, 8
FITS = {
    "dp": ({}, {"optimizer": "momentum"}),
    "tp": ({"tensorParallel": 2},
           {"optimizer": "adam", "extra": {"gradClipNorm": 0.5}}),
    "pp": ({"pipelineParallel": 2}, {"optimizer": "momentum"}),
}


def _data():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 17, size=(N, 8))
    return toks, (toks[:, 0] > 8).astype(np.int64)


def _flax_init(cfg=CFG):
    v = jax_build_model(cfg).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, v)


class _FixedInit:
    """TpuLearner's module with its init replaced by a given tree."""

    def __init__(self, module, tree):
        self.module, self.tree = module, tree

    def init(self, *a, **k):
        return jax.tree_util.tree_map(jnp.asarray, self.tree)

    def __getattr__(self, name):
        return getattr(self.module, name)


def _with_init(tree, fn):
    import mmlspark_tpu.models.trainer as jt
    orig = jt.build_model
    jt.build_model = lambda cfg, attn_fn=None: _FixedInit(
        orig(cfg, attn_fn), tree)
    try:
        return fn()
    finally:
        jt.build_model = orig


def _jax_fit(tree, knobs, optimizer, extra=None):
    toks, y = _data()
    df = JaxDataFrame({"features": jax_object_column(
        [r.astype(np.float32) for r in toks]), "label": y})
    lr = (TpuLearner().setModelConfig(CFG).setEpochs(2).setBatchSize(B)
          .setLearningRate(0.05).setShuffle(False).setDeviceDataCap(1)
          .setOptimizer(optimizer))
    for k, v in dict(knobs, **(extra or {})).items():
        lr.set(**{k: v})
    m = _with_init(tree, lambda: lr.fit(df))
    return from_flax_params(m.getModelParams(), CFG), m._final_loss


# rank 0's stream: batches of 8, 8 and 5 rows; rank 1's: one of 8, or
# none at all. Each step's global batch is that step's rows on every rank
STREAMS = {"unequal": ([np.arange(0, 8), np.arange(8, 16), np.arange(16, 21)],
                       [np.arange(21, 29)]),
           "empty": ([np.arange(0, 8), np.arange(8, 16), np.arange(16, 21)],
                     [])}


def _jax_stream_fit(tree, merged):
    toks, y = _data()

    def fn():
        for idx in merged:
            yield toks[idx].astype(np.int32), y[idx]
    lr = (TpuLearner().setModelConfig(CFG).setEpochs(2)
          .setLearningRate(0.05))
    m = _with_init(tree, lambda: lr.fitStream(fn))
    return from_flax_params(m.getModelParams(), CFG), m._final_loss


PIPE_CFG = dict(CFG, causal=True)


def _pipeline_inputs():
    x = np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32)
    tokens = np.random.default_rng(2).integers(0, 17, size=(4, 8))
    return x, tokens


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The 2-rank group (three fits, two streams, the pipeline ops) and
    the 4-rank group run while the JAX references fit."""
    tree = _flax_init()
    toks, y = _data()
    common = dict(cfg=CFG, toks=toks, labels=y, batch=B)
    fits = {name: dict(common, knobs=knobs, **kw)
            for name, (knobs, kw) in FITS.items()}
    tmp = tmp_path_factory.mktemp("fits")
    streams = {name: dict(cfg=CFG, toks=toks, labels=y, batches=b)
               for name, b in STREAMS.items()}
    x, tokens = _pipeline_inputs()
    pipe = dict(stages=_stages(), x=x, cfg=PIPE_CFG,
                flax_params=_flax_init(PIPE_CFG), tokens=tokens, micro=4)
    two = run_ranks_async(2, "fits", tmp / "two", flax_params=tree,
                          fits=fits, streams=streams, pipeline=pipe)
    four = run_ranks_async(4, "fits", tmp / "four", flax_params=tree,
                           fits={"dp_tp": fits["tp"]})
    jax_refs = {name: _jax_fit(tree, knobs, kw["optimizer"],
                               kw.get("extra"))
                for name, (knobs, kw) in FITS.items()}
    for name, (b0, b1) in STREAMS.items():
        merged = [np.concatenate([b0[i]] + ([b1[i]] if i < len(b1) else []))
                  for i in range(len(b0))]
        jax_refs[name] = _jax_stream_fit(tree, merged)
    return two.result(), four.result(), jax_refs, pipe


def _check(ranks, name, want, loss):
    r0 = ranks[0][name]
    for k, v in want.items():
        np.testing.assert_allclose(r0["params"][k], v.numpy(), atol=2e-4,
                                   rtol=0, err_msg=f"{name} {k}")
    assert abs(r0["loss"] - loss) < 1e-5, (name, r0["loss"], loss)
    for r in ranks[1:]:
        for k in r0["params"]:
            np.testing.assert_array_equal(r[name]["params"][k],
                                          r0["params"][k])


@pytest.mark.parametrize("name", sorted(FITS))
def test_two_rank_fit_matches_jax(results, name):
    two, _, refs, _ = results
    _check(two, name, *refs[name])
    # transform after the fit: each rank scores its own rows
    assert len(two[0][name]["scores"]) == two[0][name]["rows"]


def test_four_rank_data_by_tensor_fit_matches_jax(results):
    _, four, refs, _ = results
    _check(four, "dp_tp", *refs["tp"])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_fit_stream_over_unequal_and_empty_streams(results, name):
    two, _, refs, _ = results
    # every rank runs the longest stream's steps (drained ones feed
    # zero-weight dummies)
    assert [r[name]["batches"] for r in two] == [[3, 3], [3, 3]]
    _check(two, name, *refs[name])


# ---------------------------------------------------------- pipeline ops

def _stages(n=2, d=4):
    rng = np.random.default_rng(0)
    return [{"w": (rng.normal(size=(d, d)) * 0.5).astype(np.float32),
             "b": rng.normal(size=(d,)).astype(np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def pipeline(results):
    two, _, _, pipe = results
    return (PIPE_CFG, pipe["flax_params"], pipe["x"], pipe["tokens"],
            [r["pipeline"] for r in two])


def test_pipeline_apply_matches_jax(pipeline):
    _, _, x, _, res = pipeline
    mesh = jmesh.make_mesh({"pipe": 2})
    stacked = jax_stack([{k: jnp.asarray(v) for k, v in s.items()}
                         for s in _stages()])

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def loss(params, xx):
        return jnp.sum(jax_pipeline_apply(stage_fn, params, xx, mesh,
                                          n_microbatches=4))
    y = jax.jit(lambda p, xx: jax_pipeline_apply(
        stage_fn, p, xx, mesh, n_microbatches=4))(stacked, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(stacked,
                                                     jnp.asarray(x))
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["y"], np.asarray(y), atol=1e-5)
        # x enters at stage 0: its gradient lives on rank 0
        if r == 0:
            np.testing.assert_allclose(got["gx"], np.asarray(gx), atol=1e-5)
        else:
            assert not got["gx"].any()
        # rank r holds stage r's slice of the stacked weights
        np.testing.assert_allclose(got["gw"][0], np.asarray(gp["w"])[r],
                                   atol=1e-5)


def test_transformer_pp_forward_matches_jax(pipeline):
    cfg, tree, _, tokens, res = pipeline
    mesh = jmesh.make_mesh({"pipe": 2})
    toks = jnp.asarray(tokens, jnp.int32)
    logits = jax.jit(lambda p: jax_pp_forward(cfg, p, toks, mesh))(tree)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(
        jax_pp_forward(cfg, p, toks, mesh))))(tree)
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, grads), cfg)
    for got in res:
        np.testing.assert_allclose(got["logits"], np.asarray(logits),
                                   atol=1e-5)
    for k, g in want.items():
        # a block's gradient lives on its stage's rank, the embedding's on
        # stage 0's, the head's (replicated compute) on both
        parts = [r["grads"].get(k) for r in res]
        if k.startswith("blocks."):
            got = parts[int(k.split(".")[1])]
        else:
            got = parts[0]
        np.testing.assert_allclose(got, g.numpy(), atol=1e-5, err_msg=k)

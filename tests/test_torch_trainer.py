"""The port's TorchLearner against the JAX package's TpuLearner.

A small causal transformer (vocab 100, d_model 64, 2 heads, 2 layers,
max_len 128, T = 64) is initialised by flax from a seed and carried across
with ``from_flax_params``; the same numpy token ids and labels go through
both packages. The JAX side runs ``attn_impl="flash"`` (the Pallas kernels
in interpret mode, on the conftest's 8-device CPU mesh); the port runs its
flash path (the kernels' plain versions on CPU tensors).

* One step: the step bodies (``_make_step_body`` /
  ``_make_mixed_step_body``) from the same params, with and without remat:
  loss, every gradient and the updated params.
* Whole fit: ``TorchLearner(device="cpu")`` against ``TpuLearner`` with the
  port's ``init_params`` replaced by the JAX init, 32 rows, batch 8 (a
  multiple of the mesh's 8 devices, so neither side pads), 2 epochs, adam
  1e-3, float32 — on the scan path with a fresh permutation per epoch, with
  rotation + window order (``epochReshuffleCap=1``), and on the feed path
  (``deviceDataCap=1``).

Tolerances: float32 at atol = rtol = 1e-4 on losses, gradients and
params. bfloat16 at 3e-2: bf16 gradients are sums of bf16 products over
512 tokens rounded at different places (a bias gradient differs by a few
per cent of its largest element), and the embedding gradient differs on
purpose — flax differentiates the cast of the whole table, a bf16
scatter-add of every repeated token, while the port gathers f32 rows and
accumulates them in f32 (at vocab 100 and 512 tokens per batch, tokens
repeat a lot). After a whole fit the params agree to an absolute 2e-3: Adam divides each update
by the root of its second moment, so rounding in a near-zero gradient can
move a weight by up to lr per step.

An absolute bar passes a leaf whose values are all small, so the one-step
tests also hold every gradient and every update (p2 - p) leaf by leaf, on
the leaf's own largest element: 1e-3 in float32, 1e-1 in bfloat16. The
bf16 bar is set from the readings: weights differ by at most ~1.4e-2 of
their largest element, the MLP biases by up to ~6e-2 (their gradients are
sums of 512 bf16 terms that mostly cancel), and a wrong or missing
gradient by ~1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.models import precision as jprec
from mmlspark_tpu.models.modules import build_model as jax_build_model
from mmlspark_tpu.models.trainer import (
    TpuLearner, _make_loss_compute as jax_loss_compute,
    _make_mixed_step_body as jax_mixed_body, _make_step_body as jax_step_body,
    make_loss as jax_make_loss, make_optimizer as jax_make_optimizer)
from mmlspark_tpu_torch import DataFrame, Pipeline, TorchLearner, TorchModel
from mmlspark_tpu_torch.core.serialize import load_stage
from mmlspark_tpu_torch.models import precision as prec
from mmlspark_tpu_torch.models import trainer
from mmlspark_tpu_torch.models.modules import build_model
from mmlspark_tpu_torch.models.weights import from_flax_params
from mmlspark_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                    flash_attention_fwd)
from mmlspark_tpu_torch.parallel.prefetch import DevicePrefetcher, prefetched

CFG = {"type": "transformer", "vocab_size": 100, "d_model": 64, "heads": 2,
       "layers": 2, "num_classes": 8, "causal": True, "max_len": 128,
       "attn_impl": "flash"}
T = 64
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# per leaf, of the leaf's largest element (see _assert_close_per_leaf)
LEAF_TOL = {"float32": 1e-3, "bfloat16": 1e-1}


def _tokens(rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG["vocab_size"], size=(rows, T)).astype(np.int32),
            rng.integers(0, CFG["num_classes"], size=rows).astype(np.int32))


def _jax_init(cfg, seed):
    """The flax init TpuLearner draws (param_dtype float32, so the same
    tree for every compute dtype), as numpy."""
    variables = jax_build_model(dict(cfg, attn_impl="blockwise")).init(
        jax.random.PRNGKey(seed), jnp.zeros((2, T), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def flax_params():
    return _jax_init(CFG, 0)


def _sd(tree):
    return from_flax_params(tree, CFG)


def _assert_close(got: dict, want: dict, atol: float, rtol: float = 0.0):
    for k in want:
        np.testing.assert_allclose(got[k].detach().float().numpy(),
                                   want[k].numpy(), atol=atol, rtol=rtol,
                                   err_msg=k)


def _assert_close_per_leaf(got: dict, want: dict, tol: float, mask=None):
    """max |got - want| <= tol * max |want|, leaf by leaf, so leaves whose
    values are small are held to their own scale (an absolute bar passes a
    near-zero or missing gradient). ``mask(k, want)`` restricts the
    comparison to the elements it selects."""
    for k in want:
        a = got[k].detach().float().numpy()
        b = want[k].detach().float().numpy()
        scale = float(np.abs(b).max())
        if mask is not None:
            sel = mask(k, b)
            a, b = a[sel], b[sel]
        err = float(np.abs(a - b).max()) if b.size else 0.0
        assert err <= tol * scale, (k, err, scale)


def _changes(after: dict, before: dict) -> dict:
    return {k: after[k].detach().float() - before[k].float() for k in before}


# ------------------------------------------------------------------ one step

@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", False),
                                         ("bfloat16", True)])
def test_step_body_matches_jax(flax_params, dtype, remat):
    """Loss, every gradient, and the params after one sgd step."""
    cfg = dict(CFG, dtype=dtype, remat=remat)
    x, y = _tokens(8, 1)
    w = np.ones(8, np.float32)
    w[-1] = 0.0                              # a weighted-out row
    jmod = jax_build_model(cfg)
    jloss_fn = jax_make_loss("cross_entropy", per_example=True)
    jtx = jax_make_optimizer("sgd", 0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, flax_params)
    compute = jax_loss_compute(jmod, jloss_fn, False, 0.0)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: compute(p, x, y, w)))(jp)
    jp2, _, _ = jax.jit(jax_step_body(jmod, jtx, jloss_fn, False, 0.0))(
        jp, jtx.init(jp), x, y, w)

    with torch.device("meta"):
        module = build_model(cfg)
    loss_fn = trainer.make_loss("cross_entropy", per_example=True)
    tx = trainer.make_optimizer("sgd", 0.5)
    params = _sd(flax_params)
    xb, yb, wb = (torch.from_numpy(a) for a in (x, y, w))
    loss, grads = prec.value_and_grad(
        trainer._make_loss_compute(module, loss_fn), params, xb, yb, wb)
    p2, _, loss2 = trainer._make_step_body(module, tx, loss_fn)(
        params, tx.init(params), xb, yb, wb)
    assert float(loss) == float(loss2)
    np.testing.assert_allclose(float(loss), float(jloss), atol=TOL[dtype],
                               rtol=TOL[dtype])
    want_grads = _sd(jax.tree_util.tree_map(np.asarray, jgrads))
    want_p2 = _sd(jax.tree_util.tree_map(np.asarray, jp2))
    _assert_close(grads, want_grads, TOL[dtype], TOL[dtype])
    _assert_close(p2, want_p2, TOL[dtype], TOL[dtype])
    # each leaf's gradient and its update (p2 - p) on the leaf's own scale
    _assert_close_per_leaf(grads, want_grads, LEAF_TOL[dtype])
    _assert_close_per_leaf(_changes(p2, params), _changes(want_p2, params),
                           LEAF_TOL[dtype])
    assert all(v.dtype == torch.float32 for v in p2.values())


def test_mixed_step_body_matches_jax(flax_params):
    """bf16_mixed, remat on, adam: the fused scale/unscale/update body."""
    cfg = dict(CFG, dtype="bfloat16", remat=True)
    x, y = _tokens(8, 2)
    w = np.ones(8, np.float32)
    jmod = jax_build_model(cfg)
    jtx = jax_make_optimizer("adam", 1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, flax_params)
    jbody = jax.jit(jax_mixed_body(jmod, jtx, jax_make_loss(
        "cross_entropy", per_example=True), False, 0.0))
    jp2, jopt, js2, jloss = jbody(jp, jtx.init(jp),
                                  jprec.init_scale_state(), x, y, w)

    with torch.device("meta"):
        module = build_model(cfg)
    tx = trainer.make_optimizer("adam", 1e-3)
    params = _sd(flax_params)
    body = trainer._make_mixed_step_body(
        module, tx, trainer.make_loss("cross_entropy", per_example=True))
    p2, opt2, s2, loss = body(params, tx.init(params),
                              prec.init_scale_state(),
                              *(torch.from_numpy(a) for a in (x, y, w)))
    assert prec.scale_state_to_host(s2) == jprec.scale_state_to_host(js2)
    np.testing.assert_allclose(float(loss), float(jloss), atol=3e-2)
    want_p2 = _sd(jax.tree_util.tree_map(np.asarray, jp2))
    _assert_close(p2, want_p2, 3e-2, 3e-2)
    # Adam's first moment is 0.1 x the unscaled gradient: per leaf, on its
    # own scale, it shows the scale/unscale and that the step was taken
    want_mu = _sd(jax.tree_util.tree_map(np.asarray, jopt[0].mu))
    _assert_close_per_leaf(opt2["mu"], want_mu, LEAF_TOL["bfloat16"])
    # the first Adam step is about -lr * sign(g) everywhere, so where a
    # gradient is rounding noise its sign (and the step) may flip; where it
    # is at least a tenth of its leaf's largest, the step must agree
    strong = lambda k, b: np.abs(want_mu[k].numpy()) >= 0.1 * np.abs(
        want_mu[k].numpy()).max()
    _assert_close_per_leaf(
        {k: v / 1e-3 for k, v in _changes(p2, params).items()},
        {k: v / 1e-3 for k, v in _changes(want_p2, params).items()},
        1e-2, mask=strong)
    assert int(opt2["count"]) == 1
    assert all(m.dtype == torch.float32 for m in opt2["mu"].values())


# ------------------------------------------------------------------ whole fit

_COMMON = dict(featuresCol="tokens", optimizer="adam", learningRate=1e-3,
               batchSize=8, epochs=2, precision="f32", seed=0)


def _frames(rows=32, seed=3):
    x, y = _tokens(rows, seed)
    cols = {"tokens": [r for r in x], "label": y}
    return DataFrame(dict(cols)), JaxDataFrame(dict(cols))


@pytest.fixture
def jax_init(monkeypatch):
    """The port's init replaced by the JAX init of the same seed."""
    monkeypatch.setattr(
        trainer, "init_params",
        lambda cfg, seed: from_flax_params(_jax_init(cfg, seed), cfg))


@pytest.mark.parametrize("path", ["scan_reshuffle", "scan_rotate", "feed"])
def test_fit_matches_tpu_learner(jax_init, path):
    extra = {"scan_reshuffle": {}, "scan_rotate": {"epochReshuffleCap": 1},
             "feed": {"deviceDataCap": 1}}[path]
    df, jdf = _frames()
    jmodel = TpuLearner(modelConfig=CFG, **_COMMON, **extra).fit(jdf)
    model = TorchLearner(modelConfig=CFG, device="cpu", **_COMMON,
                         **extra).fit(df)
    assert isinstance(model, TorchModel)
    assert model._fit_stats["path"] == ("feed" if path == "feed" else "scan")
    assert len(model._fit_stats["epoch_losses"]) == 2
    np.testing.assert_allclose(model._final_loss, jmodel._final_loss,
                               atol=1e-4, rtol=1e-4)
    want = _sd(jax.tree_util.tree_map(np.asarray, jmodel.getModelParams()))
    got = model.getModelParams()
    assert set(got) == set(want)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in got.values())
    _assert_close(got, want, 2e-3)
    if path == "scan_reshuffle":
        # the fitted models serve the same scores
        jscores = np.stack(jmodel.setInputCol("tokens").setMiniBatchSize(16)
                           .transform(jdf).col("scores"))
        scores = np.stack(model.setMiniBatchSize(16).transform(df)
                          .col("scores"))
        np.testing.assert_allclose(scores, jscores, atol=1e-3, rtol=1e-3)
        assert model.getModelConfig()["dtype"] == "float32"


def test_bf16_and_bf16_mixed_fits_agree_bit_for_bit():
    """Power-of-two loss scaling is exact: with no skipped step the mixed
    fit's loss equals plain bf16's bit for bit (test_precision.py:88)."""
    df, _ = _frames(rows=16, seed=4)
    common = dict(_COMMON, epochs=2, device="cpu", modelConfig=dict(
        CFG, remat=True))
    plain = TorchLearner(**dict(common, precision="bf16")).fit(df)
    mixed = TorchLearner(**dict(common, precision="bf16_mixed")).fit(df)
    assert np.isfinite(plain._final_loss)
    assert plain._final_loss == mixed._final_loss
    assert mixed._fit_stats["scale_state"] == {
        "scale": 2.0 ** 15, "growth": 4, "skipped": 0}
    assert "dtype" not in plain.getModelConfig()
    assert mixed.getModelConfig()["dtype"] == "bfloat16"


def test_fit_paths_and_prefetch_depth_agree():
    """The feed path with and without the prefetcher, and the scan path with
    and without ``stepsPerDispatch`` (accepted; the port's steps are eager
    either way), replay the same trajectory bit for bit."""
    df, _ = _frames(rows=24, seed=5)
    common = dict(_COMMON, device="cpu", modelConfig=CFG, precision="bf16",
                  batchSize=8)
    losses = [TorchLearner(**common, **kw).fit(df)._fit_stats["epoch_losses"]
              for kw in ({"deviceDataCap": 1, "prefetchDepth": 0},
                         {"deviceDataCap": 1, "prefetchDepth": 3},
                         {"stepsPerDispatch": 1}, {})]
    assert losses[0] == losses[1]
    assert losses[2] == losses[3]


def test_cpu_fit_launches_no_kernel():
    df, _ = _frames(rows=8, seed=6)
    counts = lambda: (flash_attention_fwd.launches,
                      flash_attention_bwd.launches_dq,
                      flash_attention_bwd.launches_dkv)
    before = counts()
    TorchLearner(**dict(_COMMON, epochs=1, device="cpu",
                        modelConfig=dict(CFG, remat=True))).fit(df)
    assert counts() == before


@pytest.mark.parametrize("fault", ["dq_zeroed", "delta_dropped"])
def test_chip_smoke_gradient_gate_sees_attention_faults(monkeypatch, fault):
    """chip_smoke.py's train phase holds one step's gradients, flash against
    blockwise attention, per parameter. At a small width on the CPU (the
    flash backward's plain version) a sound backward passes that bar, and
    a planted fault in the backward fails it many times over."""
    import chip_smoke
    from mmlspark_tpu_torch.ops import flash_attention as fa
    cfg = dict(chip_smoke.TRAIN_CFG, **{k: CFG[k] for k in (
        "vocab_size", "d_model", "heads", "layers", "max_len")})
    x, y = _tokens(chip_smoke.TRAIN_BATCH, 11)

    def worst():
        errs = chip_smoke.step_grad_errors(torch, cfg, x, y, device="cpu")
        return max(e["l2_rel"] for e in errs.values())

    assert worst() <= chip_smoke.TOL_TRAIN_GRAD
    if fault == "dq_zeroed":
        bwd = fa.flash_attention_bwd
        monkeypatch.setattr(fa, "flash_attention_bwd", lambda *a, **k: (
            lambda dq, dk, dv: (torch.zeros_like(dq), dk, dv))(*bwd(*a, **k)))
    else:                                  # ds = p * dp, without the - D
        row_dot = fa._row_dot
        monkeypatch.setattr(fa, "_row_dot", lambda do, out: torch.zeros_like(
            row_dot(do, out)))
    assert worst() > 10 * chip_smoke.TOL_TRAIN_GRAD


def test_divergence_halts_the_fit():
    df, _ = _frames(rows=16, seed=7)
    learner = TorchLearner(**dict(_COMMON, learningRate=1e30, optimizer="sgd",
                                  device="cpu", modelConfig=CFG))
    with pytest.raises(RuntimeError, match="diverged"):
        learner.fit(df)


# ----------------------------------------------------------- init and params

def test_init_params_shapes_and_distributions():
    cfg = dict(CFG, d_model=128, vocab_size=1000)
    sd = trainer.init_params(cfg, 0)
    module = build_model(cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert all(v.dtype == torch.float32 for v in sd.values())
    emb = sd["tok_embed.weight"]
    assert abs(emb.std().item() - 128 ** -0.5) < 0.01
    w = sd["blocks.0.fc1.weight"]                  # fan_in 128, truncated
    assert w.abs().max().item() <= 2 * 128 ** -0.5 / trainer._TRUNC_STD
    assert abs(w.std().item() - 128 ** -0.5) < 0.01
    assert not sd["blocks.0.fc1.bias"].any()
    assert torch.equal(sd["ln_f.weight"], torch.ones(128))
    again = trainer.init_params(cfg, 0)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(trainer.init_params(cfg, 1)["head.weight"],
                           sd["head.weight"])


@pytest.mark.parametrize("param,value", [
    ("tensorParallel", 2), ("sequenceParallel", 2), ("expertParallel", 2),
    ("pipelineParallel", 2), ("elastic", True),
    ("checkpointDir", "/ckpt")])
def test_unported_params_raise(param, value, tmp_path):
    """Every Param of the list is ported now. The four parallel Params
    (tests/test_torch_parallel_fit.py): with no process group the world is
    one rank, and each raises the JAX package's ValueError for one device
    instead of running unsharded. Elastic training
    (tests/test_torch_elastic.py) needs a checkpointDir, and raises the
    JAX package's ValueError without one; with one (``value`` names a
    directory under ``tmp_path``) the elastic fit runs its one attempt
    and ends on the plain fit's parameters."""
    df, _ = _frames(rows=8, seed=8)
    if param == "checkpointDir":
        value = str(tmp_path / value.strip("/"))
    extra = {"elastic": True} if param == "checkpointDir" else {}
    learner = TorchLearner(modelConfig=CFG, device="cpu", featuresCol="tokens",
                           **{param: value}, **extra)
    one_rank = {
        "tensorParallel": r"model axis \(2\) must divide the device count "
                          r"\(1\)",
        "sequenceParallel": r"sequenceParallel\*tensorParallel = 2\*1 must "
                            r"divide the device count \(1\)",
        "expertParallel": "expertParallel>1 requires a transformer model "
                          "with num_experts set",
        "pipelineParallel": r"pipelineParallel \(2\) must divide the device "
                            r"count \(1\)"}
    if param in one_rank:
        with pytest.raises(ValueError, match=one_rank[param]):
            learner.fit(df)
        return
    if param == "elastic":
        with pytest.raises(ValueError, match="requires checkpointDir"):
            learner.fit(df)
        return
    model = learner.fit(df)
    plain = TorchLearner(modelConfig=CFG, device="cpu", featuresCol="tokens",
                         deviceDataCap=1).fit(df)
    got, want = model.getModelParams(), plain.getModelParams()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert model._fit_stats["path"] == "feed"


def test_fit_stream_and_cuda_without_a_card_raise():
    learner = TorchLearner(modelConfig=CFG, featuresCol="tokens",
                           device="cpu")
    with pytest.raises(ValueError, match="no batches"):
        learner.fitStream(lambda: iter(()))
    learner = TorchLearner(modelConfig=CFG, featuresCol="tokens")
    # fitStreamCaptured is ported; a token model has no featurized batch
    # to fuse, so it refuses (as the JAX learner does)
    with pytest.raises(ValueError, match="token model"):
        learner.fitStreamCaptured(lambda: iter(()), None)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    df, _ = _frames(rows=8, seed=9)
    assert learner.getDevice() == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        learner.fit(df)


def test_token_ids_out_of_range_raise():
    bad = DataFrame({"tokens": [np.array([1, 2, CFG["vocab_size"]])],
                     "label": np.array([1])})
    learner = TorchLearner(modelConfig=CFG, device="cpu", featuresCol="tokens")
    with pytest.raises(ValueError, match="token ids"):
        learner.fit(bad)


def test_learner_params_round_trip_and_pipeline(tmp_path):
    learner = TorchLearner(modelConfig=CFG, device="cpu", featuresCol="tokens",
                           optimizer="adamw", weightDecay=0.01, epochs=1,
                           batchSize=4, precision="bf16_mixed",
                           inputShape=(1, 2, 3))
    learner.save(str(tmp_path / "learner"))
    back = load_stage(str(tmp_path / "learner"))
    assert isinstance(back, TorchLearner) and back.uid == learner.uid
    for p in ("modelConfig", "optimizer", "weightDecay", "epochs",
              "batchSize", "precision", "device", "featuresCol",
              "inputShape"):
        assert back.getOrDefault(p) == learner.getOrDefault(p), p
    # the JAX learner's Params are all here, plus device
    assert set(TorchLearner.params()) == set(TpuLearner.params()) | {"device"}
    df, _ = _frames(rows=8, seed=10)
    fitted = Pipeline(stages=(back.setInputShape(()),)).fit(df)
    out = np.stack(fitted.transform(df).col("scores"))
    assert out.shape == (8, CFG["num_classes"]) and np.isfinite(out).all()


# ------------------------------------------------------------------ prefetch

def test_prefetch_keeps_order_and_bounds_depth():
    seen = []

    def produce():
        for i in range(20):
            seen.append(i)
            yield i

    with DevicePrefetcher(produce, depth=3) as it:
        first = next(it)
        deadline = __import__("time").monotonic() + 5
        while it.items < 4 and __import__("time").monotonic() < deadline:
            pass
        # one consumed + at most `depth` produced ahead
        assert first == 0 and it.items <= 4
        assert [first] + list(it) == list(range(20))
    assert not it._thread.is_alive()


def test_prefetch_propagates_errors_and_depth_zero_is_synchronous():
    def produce():
        yield 1
        raise KeyError("boom")

    it = prefetched(produce, depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)
    sync = prefetched(lambda: iter([1, 2]), depth=0)
    assert list(sync) == [1, 2]
    sync.close()
    with pytest.raises(ValueError):
        DevicePrefetcher(lambda: iter(()), depth=0)

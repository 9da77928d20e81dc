"""The port's image and sequence families against the JAX package's.

MLP, ConvNet, ResNet (CIFAR ResNet-20 at full width; the ``resnet50``
family at ``blocks_per_stage=[1, 1, 1, 1]``, widths 32-256, 64 x 64) and
BiLSTM get the same numpy-seeded weights in flax's layout, carried across
with ``from_flax_params``, and the same numpy inputs (uint8 NHWC images,
int token ids). Odd and even heights and widths: a stride-2 SAME conv pads
(0, 1) on an even input and (1, 1) on an odd one, so a wrong alignment
shows on one of them.

Tolerances, on max |port - jax| / max(1, max |jax|):
* float32 forward, every ``output_layer`` tap: 1e-4;
* bfloat16 forward: 2e-2 (bf16 products rounded at other places; the
  port's LSTM recurrence runs in float32 where flax's gate products are
  bf16);
* one step (loss, every gradient and update): float32 1e-4. In bfloat16
  the loss within 3e-2, the transformer's gate (PERF.md §2), and each
  leaf's gradient and momentum step within twice the JAX package's own
  distance from the float32 gradient plus 3e-2 (||. ||_2 of the leaf):
  bf16 gradients of these toy GroupNorm nets are 3-30 % off float32 in
  both packages alike;
* a 2-epoch ``TorchLearner`` fit against ``TpuLearner`` from the JAX init:
  epoch losses within 5e-2 in bfloat16, the transformer's loss gate.
* ``init_params``: the keys and shapes of ``from_flax_params(flax init)``,
  and each kernel's std within 10 % of flax's (norms exactly 1 and 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.core.schema import make_image_row as jax_image_row
from mmlspark_tpu.core.utils import object_column
from mmlspark_tpu.models.modules import build_model as jax_build_model
from mmlspark_tpu.models.trainer import (
    TpuLearner, _make_loss_compute as jax_loss_compute,
    _make_step_body as jax_step_body, make_loss as jax_make_loss,
    make_optimizer as jax_make_optimizer)
from mmlspark_tpu_torch import DataFrame, TorchLearner, TorchModel
from mmlspark_tpu_torch.core.schema import make_image_row
from mmlspark_tpu_torch.models import precision as prec
from mmlspark_tpu_torch.models import trainer
from mmlspark_tpu_torch.models.modules import (build_model, example_input,
                                               sized_for)
from mmlspark_tpu_torch.models.weights import (flax_map, from_flax_params,
                                               to_flax_params)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_STEP_BF16 = 3e-2
TOL_FIT_LOSS = 5e-2
R50 = {"type": "resnet50", "blocks_per_stage": [1, 1, 1, 1],
       "widths": [32, 64, 128, 256], "num_classes": 10}
BILSTM = {"type": "bilstm", "vocab_size": 50, "embed_dim": 16, "hidden": 12,
          "num_classes": 5}

# (config, input shape): images are NHWC uint8, tokens (B, T) int
FORWARD_CASES = {
    "mlp": ({"type": "mlp", "hidden": [16, 8], "num_classes": 3},
            (3, 5, 7, 3)),
    "convnet_odd": ({"type": "convnet", "channels": [4, 4, 8, 8],
                     "dense": 16}, (2, 31, 33, 3)),
    "convnet_even": ({"type": "convnet", "channels": [4, 4, 8, 8],
                      "dense": 16}, (2, 32, 32, 3)),
    "resnet20_even": ({"type": "resnet"}, (2, 32, 32, 3)),
    "resnet20_odd": ({"type": "resnet"}, (2, 31, 33, 3)),
    "resnet50_same_group": (R50, (2, 64, 64, 3)),
    "resnet50_torch_frozen": (dict(R50, norm="frozen", padding="torch",
                                   input_norm=True), (2, 65, 63, 3)),
    "resnet50_same_frozen_odd": (dict(R50, norm="frozen", input_norm=True),
                                 (2, 63, 65, 3)),
    "bilstm": (BILSTM, (2, 11)),
}


def _input(cfg, shape, seed=0):
    rng = np.random.default_rng(seed)
    if cfg["type"] == "bilstm":
        return rng.integers(0, cfg["vocab_size"], size=shape).astype(np.int32)
    return rng.integers(0, 256, size=shape).astype(np.uint8)


def _random_tree(cfg, x, seed=1):
    """Weights of the flax tree's shapes from a numpy seed: kernels
    N(0, 1/fan_in), norm scales around 1 and biases around 0, so the
    affine and norm paths carry non-trivial values."""
    jm = jax_build_model(cfg)
    shapes = flatten_dict(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))))
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in shapes.items():
        if k[-1] == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.normal(size=s.shape) / np.sqrt(fan_in)
        elif k[-1] == "embedding":
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[-1])
        elif k[-1] == "scale":
            v = 1.0 + 0.2 * rng.normal(size=s.shape)
        else:
            v = 0.1 * rng.normal(size=s.shape)
        out[k] = v.astype(np.float32)
    return unflatten_dict(out)


def _port_module(cfg, tree, shape):
    module = build_model(sized_for(cfg, shape))
    module.load_state_dict(from_flax_params(tree, cfg), strict=True)
    return module.eval()


def _as_torch(x):
    return torch.from_numpy(x).long() if x.dtype == np.int32 \
        else torch.from_numpy(x)


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_and_every_tap_match_jax_f32(case):
    cfg, shape = FORWARD_CASES[case]
    cfg = dict(cfg, dtype="float32")
    x = _input(cfg, shape)
    tree = _random_tree(cfg, x)
    jm = jax_build_model(cfg)
    module = _port_module(cfg, tree, shape)
    assert module.layer_names() == jm.layer_names()
    for layer in [None] + jm.layer_names():
        want = np.asarray(jm.apply(tree, jnp.asarray(x), output_layer=layer))
        with torch.no_grad():
            got = module(_as_torch(x), output_layer=layer).numpy()
        assert got.shape == want.shape, (layer, got.shape, want.shape)
        assert got.dtype == np.float32
        assert _rel_err(got, want) <= TOL["float32"], layer


@pytest.mark.parametrize("case", ["mlp", "convnet_odd", "resnet20_even",
                                  "resnet50_torch_frozen", "bilstm"])
def test_forward_matches_jax_bf16(case):
    cfg, shape = FORWARD_CASES[case]
    x = _input(cfg, shape, seed=2)
    tree = _random_tree(cfg, x, seed=3)
    jm = jax_build_model(cfg)
    module = _port_module(cfg, tree, shape)
    for layer in (None, jm.layer_names()[1]):
        want = np.asarray(jm.apply(tree, jnp.asarray(x), output_layer=layer))
        with torch.no_grad():
            got = module(_as_torch(x), output_layer=layer).numpy()
        assert _rel_err(got, want) <= TOL["bfloat16"], layer


@pytest.mark.parametrize("family", ["mlp", "convnet", "resnet", "resnet50",
                                    "bilstm", "transformer"])
def test_flax_map_round_trips_every_family(family):
    """to_flax_params(from_flax_params(tree)) gives the tree back bit for
    bit, and the map names every flax leaf exactly once."""
    cfg = {"mlp": FORWARD_CASES["mlp"][0],
           "convnet": FORWARD_CASES["convnet_even"][0],
           "resnet": {"type": "resnet", "blocks_per_stage": 2},
           "resnet50": dict(R50, norm="frozen", input_norm=True),
           "bilstm": BILSTM,
           "transformer": {"type": "transformer", "vocab_size": 30,
                           "d_model": 16, "heads": 2, "layers": 2,
                           "max_len": 8, "seq_len": 8}}[family]
    x = np.asarray(example_input(cfg).numpy())
    if family in ("bilstm", "transformer"):
        x = x.astype(np.int32)
    tree = _random_tree(cfg, x)
    sd = from_flax_params(tree, cfg)
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in
                build_model(sized_for(cfg, x.shape)).state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    back = flatten_dict(to_flax_params(sd, cfg)["params"])
    flat = flatten_dict(tree["params"])
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    paths = [p for e in flax_map(cfg) for p in e.paths]
    assert sorted(paths) == sorted("/".join(k) for k in flat)


# --------------------------------------------------------------------- init

INIT_CASES = {"mlp": ({"type": "mlp", "hidden": [256, 128]}, (2, 8, 8, 3)),
              "convnet": ({"type": "convnet"}, (2, 32, 32, 3)),
              "resnet": ({"type": "resnet"}, (2, 32, 32, 3)),
              "resnet50": (R50, (2, 64, 64, 3)),
              "bilstm": ({"type": "bilstm", "vocab_size": 500}, (2, 8))}


def _init_kind(key: str, value) -> str:
    if "lstm" in key:
        return key.split(".")[1].rsplit("_l0", 1)[0]   # weight_ih, weight_hh
    if "embed" in key:
        return "embedding"
    return "conv" if value.dim() == 4 else "dense"


def _pooled_std(sd: dict) -> dict:
    """Per kind of kernel, the std of every such leaf scaled by
    sqrt(fan_in) (its trailing dims: flax's fan_in for a kernel, the width
    for an embedding, H for an orthogonal (H, H) gate), pooled, so small
    leaves count without their sampling noise."""
    pools: dict = {}
    for k, v in sd.items():
        if k.endswith("weight") and v.dim() >= 2:
            fan_in = int(np.prod(v.shape[1:]))
            pools.setdefault(_init_kind(k, v), []).append(
                v.flatten() * fan_in ** 0.5)
    return {kind: float(torch.cat(vs).std()) for kind, vs in pools.items()}


@pytest.mark.parametrize("family", sorted(INIT_CASES))
def test_init_params_matches_flax_init(family):
    cfg, shape = INIT_CASES[family]
    x = _input(cfg, shape)
    jm = jax_build_model(cfg)
    flax_init = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    want = from_flax_params(flax_init, cfg)
    got = trainer.init_params(sized_for(cfg, shape), 0)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    for k, w in want.items():
        if float(w.std()) == 0:                # norms, biases
            assert torch.equal(got[k], w), k
    want_std, got_std = _pooled_std(want), _pooled_std(got)
    assert set(got_std) == set(want_std)
    for kind in want_std:
        assert abs(got_std[kind] / want_std[kind] - 1.0) <= 0.10, kind
    again = trainer.init_params(sized_for(cfg, shape), 0)
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_lstm_recurrent_init_is_orthogonal_per_gate():
    sd = trainer.init_params({"type": "bilstm", "vocab_size": 20,
                              "embed_dim": 8, "hidden": 16}, 3)
    for name in ("lstm.weight_hh_l0", "lstm.weight_hh_l0_reverse"):
        for gate in sd[name].chunk(4):
            torch.testing.assert_close(gate @ gate.T, torch.eye(16),
                                       atol=1e-5, rtol=0)
    assert not sd["lstm.bias_ih_l0"].any()


# --------------------------------------------------------------- training

TRAIN_CASES = {
    "resnet": {"type": "resnet", "blocks_per_stage": 1, "widths": [4, 8, 8],
               "num_classes": 4},
    "convnet": {"type": "convnet", "channels": [4, 8], "dense": 16,
                "num_classes": 4},
    "mlp": {"type": "mlp", "hidden": [16], "num_classes": 4},
}
TRAIN_SHAPE = (32, 8, 8, 3)


def _train_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=TRAIN_SHAPE).astype(np.uint8)
    y = rng.integers(0, 4, size=TRAIN_SHAPE[0]).astype(np.int32)
    return x, y


def _flax_init(cfg, x, seed):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_build_model(cfg).init)(jax.random.PRNGKey(seed),
                                   jnp.asarray(x[:2])))


def _l2_rel(got, want) -> float:
    diff = got.detach().float() - want.float()
    return float(diff.norm() / want.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(TRAIN_CASES))
def test_step_matches_jax(family, dtype):
    """Loss, every gradient and the params after one momentum step, from
    the same carried weights; a weighted-out row included."""
    cfg = dict(TRAIN_CASES[family], dtype=dtype)
    x, y = _train_data(1)
    x, y = x[:8], y[:8]
    w = np.ones(8, np.float32)
    w[-1] = 0.0
    tree = _flax_init(cfg, x, 0)
    jmod = jax_build_model(cfg)
    jloss_fn = jax_make_loss("cross_entropy", per_example=True)
    jtx = jax_make_optimizer("momentum", 0.05, 0.9)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    compute = jax_loss_compute(jmod, jloss_fn, False, 0.0)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: compute(p, x, y, w)))(jp)
    jp2, _, _ = jax.jit(jax_step_body(jmod, jtx, jloss_fn, False, 0.0))(
        jp, jtx.init(jp), x, y, w)

    with torch.device("meta"):
        module = build_model(sized_for(cfg, x.shape))
    loss_fn = trainer.make_loss("cross_entropy", per_example=True)
    tx = trainer.make_optimizer("momentum", 0.05, 0.9)
    params = from_flax_params(tree, cfg)
    xb, yb, wb = (torch.from_numpy(a) for a in (x, y, w))
    loss, grads = prec.value_and_grad(
        trainer._make_loss_compute(module, loss_fn), params, xb, yb, wb)
    p2, _, _ = trainer._make_step_body(module, tx, loss_fn)(
        params, tx.init(params), xb, yb, wb)
    want_g = from_flax_params(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    want_p2 = from_flax_params(jax.tree_util.tree_map(np.asarray, jp2), cfg)
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4,
                                   rtol=1e-4)
        for k in want_g:
            np.testing.assert_allclose(grads[k].numpy(), want_g[k].numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(p2[k].numpy(), want_p2[k].numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
    else:
        # bf16 gradients through GroupNorm nets at toy widths carry 3-30 %
        # rounding noise in both packages (||bf16 - f32|| / ||f32||, read on
        # six seeds); each leaf is held to the f32 gradient, no further off
        # than twice the JAX package's bf16 gradient plus the 3e-2 gate
        np.testing.assert_allclose(float(loss), float(jloss),
                                   atol=TOL_STEP_BF16, rtol=TOL_STEP_BF16)
        f32 = dict(cfg, dtype="float32")
        with torch.device("meta"):
            module32 = build_model(sized_for(f32, x.shape))
        _, exact = prec.value_and_grad(
            trainer._make_loss_compute(module32, loss_fn), params, xb, yb, wb)
        for k in want_g:
            bar = 2 * _l2_rel(want_g[k], exact[k]) + TOL_STEP_BF16
            assert _l2_rel(grads[k], exact[k]) <= bar, k
            step, want_step = p2[k] - params[k], want_p2[k] - params[k]
            assert _l2_rel(step, -0.05 * exact[k]) <= 2 * _l2_rel(
                want_step, -0.05 * exact[k]) + TOL_STEP_BF16, k


@pytest.mark.parametrize("family", sorted(TRAIN_CASES))
def test_fit_matches_tpu_learner(monkeypatch, family):
    """A 2-epoch bf16 fit of an image column (uint8 rows, scan path) from
    the JAX init of the same seed: the epoch losses agree, and the fitted
    model scores the rows."""
    cfg = TRAIN_CASES[family]
    x, y = _train_data(2)
    monkeypatch.setattr(trainer, "init_params", lambda c, seed: (
        from_flax_params(_flax_init(c, x, seed), c)))
    common = dict(featuresCol="image", modelConfig=cfg, optimizer="momentum",
                  learningRate=0.05, batchSize=8, epochs=2, seed=0)
    jrows = object_column([jax_image_row(f"r{i}", 8, 8, 3, x[i])
                           for i in range(len(x))])
    rows = object_column([make_image_row(f"r{i}", 8, 8, 3, x[i])
                          for i in range(len(x))])
    jmodel = TpuLearner(**common).fit(JaxDataFrame({"image": jrows,
                                                    "label": y}))
    model = TorchLearner(**common, device="cpu").fit(
        DataFrame({"image": rows, "label": y}))
    losses = model._fit_stats["epoch_losses"]
    assert model._fit_stats["path"] == "scan"
    assert len(losses) == 2 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses[-1], jmodel._final_loss,
                               atol=TOL_FIT_LOSS, rtol=TOL_FIT_LOSS)
    assert model.getModelConfig() == cfg      # sized from the data, not saved
    scores = np.stack(model.transform(DataFrame({"image": rows})).col(
        "scores"))
    assert scores.shape == (len(x), 4) and np.isfinite(scores).all()


def test_scan_path_keeps_images_uint8(monkeypatch):
    """The epoch goes to the device as uint8 NHWC rows (4x less than f32);
    the model casts each batch."""
    seen = []
    real = trainer._to_device

    def spy(a, dev):
        seen.append(a.dtype)
        return real(a, dev)

    monkeypatch.setattr(trainer, "_to_device", spy)
    x, y = _train_data(3)
    rows = object_column([make_image_row(f"r{i}", 8, 8, 3, x[i])
                          for i in range(len(x))])
    TorchLearner(featuresCol="image", modelConfig=TRAIN_CASES["convnet"],
                 batchSize=8, epochs=1, device="cpu").fit(
        DataFrame({"image": rows, "label": y}))
    assert np.dtype(np.uint8) in seen


# ------------------------------------------------------------- the registry

def test_every_family_builds_and_moe_still_raises():
    for cfg in (FORWARD_CASES["mlp"][0], {"type": "convnet"},
                {"type": "resnet"}, {"type": "resnet50"}, BILSTM,
                {"type": "transformer"}):
        with torch.device("meta"):
            module = build_model(cfg)
        assert module.layer_names()[-1] == "logits"
        assert tuple(example_input(cfg, batch=3).shape)[0] == 3
    # the MoE transformer is ported (tests/test_torch_moe.py)
    with torch.device("meta"):
        moe = build_model({"type": "transformer", "num_experts": 4})
    assert moe.layer_names()[-1] == "logits" and moe.blocks[0].moe is not None
    with pytest.raises(ValueError, match="stages"):
        build_model({"type": "resnet", "blocks_per_stage": [1, 1]})
    with pytest.raises(ValueError, match="norm"):
        build_model({"type": "resnet", "norm": "batch"})


def test_sized_for_takes_the_sizes_flax_infers():
    assert sized_for({"type": "mlp"}, (4, 8, 8, 3))["input_dim"] == 192
    conv = sized_for({"type": "convnet", "height": 5}, (2, 28, 30, 1))
    assert (conv["height"], conv["width"], conv["channels_in"]) == (28, 30, 1)
    assert sized_for({"type": "resnet"}, (2, 9, 9, 4))["channels_in"] == 4
    assert sized_for(BILSTM, (2, 7)) == BILSTM


def test_torch_model_scores_images_like_tpu_model():
    """TorchModel over a uint8 image column, f32 ResNet-20 with carried
    weights, against TpuModel on the same rows (miniBatchSize buckets
    included: 5 rows pad to 8)."""
    from mmlspark_tpu.models.tpu_model import TpuModel
    cfg = {"type": "resnet", "dtype": "float32"}
    x = _input(cfg, (5, 32, 32, 3), seed=4)
    tree = _random_tree(cfg, x, seed=5)
    jrows = object_column([jax_image_row(f"r{i}", 32, 32, 3, x[i])
                           for i in range(5)])
    rows = object_column([make_image_row(f"r{i}", 32, 32, 3, x[i])
                          for i in range(5)])
    want = np.stack(TpuModel(inputCol="image", modelConfig=cfg,
                             modelParams=tree, miniBatchSize=8)
                    .transform(JaxDataFrame({"image": jrows})).col("scores"))
    model = TorchModel(inputCol="image", modelConfig=cfg, modelParams=tree,
                       miniBatchSize=8, device="cpu")
    got = np.stack(model.transform(DataFrame({"image": rows})).col("scores"))
    assert _rel_err(got, want) <= TOL["float32"]
    assert model.layerNames()[0] == "stem"
    empty = model.transform(DataFrame({"image": object_column([])}))
    assert len(empty.col("scores")) == 0

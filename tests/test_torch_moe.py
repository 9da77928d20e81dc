"""The port's MoE (``models/moe.py``) and MoE transformer against the JAX
package's.

* ``MoEMLP`` forward, Switch aux loss and gradients (inputs and every
  param, of ``sum(y * g) + aux``) against flax's ``MoEMLP`` on the same
  numpy inputs and flax-initialised params, top-k 1 and 2, capacity 1.0
  (it binds: tokens drop) and 4.0, with a ``row_mask`` that zeroes a row:
  float32 within 1e-5; bfloat16 expert matmuls within 2e-2 of the largest
  output.
* The index dispatch against the dense one-hot plain version
  (``moe_one_hot``, the JAX body as written): ``xin`` bit for bit, the
  output within 1e-6; no tensor of the index form holds S*E*C elements;
  top-k ties go to the lower expert index, as ``lax.top_k``.
* The MoE transformer forward against the JAX package's and its weight map
  round trip, bit for bit; ``TorchModel`` scores that do not depend on the
  bucket padding (the JAX package's ``test_moe_inference_padding_invariant``).
* Fits (float32, momentum, ``moeAuxWeight`` 0.01, capacity 1.0, the JAX
  init carried across, the feed path on both sides): a one-device
  ``TorchLearner`` against ``TpuLearner``; a 2-rank data-parallel fit
  (global capacity and aux over the split batch) and a 2-rank
  ``expertParallel=2`` fit (gloo, ``tests/torch_dist_workers.py``, the JAX
  tests' block-cyclic row split) against the JAX fits on the 8-device
  mesh, the data-parallel one and ``setExpertParallel(2)``: params within
  2e-4, losses within 1e-5, and the whole tree bit-equal on both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.core.utils import object_column as jax_object_column
from mmlspark_tpu.models import TpuLearner, TpuModel
from mmlspark_tpu.models.modules import build_model as jax_build_model
from mmlspark_tpu.models.moe import MoEMLP as JaxMoE
from mmlspark_tpu.models.moe import read_moe_aux_loss as jax_read_aux
from mmlspark_tpu_torch.models import trainer
from mmlspark_tpu_torch.models.modules import build_model
from mmlspark_tpu_torch.models.moe import MoEMLP, moe_one_hot, top_k
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.trainer import TorchLearner
from mmlspark_tpu_torch.models.weights import (flax_paths, from_flax_params,
                                               to_flax_params)

from torch_dist_workers import run_ranks_async, token_frame

NAMES = ("gate", "expert_w1", "expert_b1", "expert_w2", "expert_b2")
CFG = {"type": "transformer", "vocab_size": 17, "d_model": 8, "heads": 2,
       "layers": 1, "num_classes": 2, "max_len": 8, "dtype": "float32",
       "num_experts": 4, "capacity_factor": 1.0}


def _pair(top, cf, dtype=jnp.float32, seed=0):
    jm = JaxMoE(num_experts=4, d_hidden=16, top_k=top, capacity_factor=cf,
                dtype=dtype)
    # a positive shift of x and of expert 0's gate column skews the routing
    # to expert 0, so capacity 1.0 drops tokens
    x = (np.random.default_rng(seed).normal(size=(3, 8, 8)) + 0.5
         ).astype(np.float32)
    p = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    p["params"]["gate"][:, 0] += 0.5
    tm = MoEMLP(4, 16, top_k=top, capacity_factor=cf,
                dtype=torch.float32 if dtype == jnp.float32
                else torch.bfloat16, d_model=8)
    for n in NAMES:
        getattr(tm, n).data = torch.tensor(np.asarray(p["params"][n]))
    return jm, p, tm, x


MASK = np.array([1, 0, 1], np.float32)


@pytest.mark.parametrize("top", [1, 2])
@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_moe_mlp_matches_flax(top, cf):
    jm, p, tm, x = _pair(top, cf)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        y, inter = jm.apply(params, xx, row_mask=jnp.asarray(MASK),
                            mutable=["intermediates"])
        return jnp.sum(y * g) + jax_read_aux(inter["intermediates"]), y
    (jl, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    aux = []
    y = tm(xt, row_mask=torch.tensor(MASK), aux=aux)
    loss = (y * torch.tensor(g)).sum() + aux[0]
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-5)
    for n in NAMES:
        np.testing.assert_allclose(getattr(tm, n).grad.numpy(),
                                   np.asarray(jgp["params"][n]), atol=1e-5,
                                   rtol=1e-5, err_msg=n)
    # the masked row claims nothing: its tokens' outputs are zero
    assert not y[1].detach().abs().any()


def test_moe_mlp_bf16_matches_flax():
    jm, p, tm, x = _pair(2, 1.25, jnp.bfloat16)
    jy = np.asarray(jm.apply(p, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        y = tm(torch.tensor(x)).float().numpy()
    assert np.abs(y - jy).max() <= 2e-2 * np.abs(jy).max()


@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_index_dispatch_matches_the_one_hot_plain_version(cf):
    _, _, tm, x = _pair(2, cf, seed=3)
    xt, mask = torch.tensor(x), torch.tensor(MASK)
    aux = []
    y = tm(xt, row_mask=mask, aux=aux)
    y_ref, aux_ref, xin_ref = moe_one_hot(tm, xt, mask, return_xin=True)
    torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=1e-6)
    assert torch.equal(aux[0], aux_ref)
    # xin: the same bits; the index buffer holds min(C, S) slots
    xin = tm.dispatch(xt, mask)[0]
    cb = xin.shape[1]
    assert torch.equal(xin, xin_ref[:, :cb])
    assert not xin_ref[:, cb:].any()
    S, E, C = 24, 4, xin_ref.shape[1]
    # no tensor of the index form holds S*E*C elements
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else [out]:
                if isinstance(t, torch.Tensor):
                    Largest.most = max(Largest.most, t.numel())
            return out
    with Largest():
        tm(xt, row_mask=mask)
    assert Largest.most < S * E * C
    # capacity 1.0 binds: fewer (token, choice) pairs kept than asked for
    kept = sum(int(k.sum()) for k in tm.dispatch(xt, mask)[2])
    assert (kept < 2 * 16) == (cf == 1.0)
    # and in the flax comparison's cases too
    for top in (1, 2):
        _, _, tm1, x1 = _pair(top, 1.0)
        kept = sum(int(k.sum()) for k in tm1.dispatch(
            torch.tensor(x1), mask)[2])
        assert kept < top * 16


def test_top_k_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 3]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _flax_init(cfg, seed=0):
    v = jax_build_model(cfg).init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, v)


def test_moe_transformer_forward_and_weight_round_trip():
    flax = _flax_init(dict(CFG, layers=2))
    cfg = dict(CFG, layers=2)
    sd = from_flax_params(flax, cfg)
    assert "blocks.1.moe.expert_w1" in sd and "blocks.0.fc1.weight" not in sd
    back = to_flax_params(sd, cfg)
    assert flax_paths(back) == flax_paths(flax)
    for path in flax_paths(flax):
        node_a, node_b = flax["params"], back["params"]
        for part in path.split("/"):
            node_a, node_b = node_a[part], node_b[part]
        np.testing.assert_array_equal(node_a, node_b, err_msg=path)
    module = build_model(cfg)
    module.load_state_dict(sd)
    toks = np.random.default_rng(0).integers(0, 17, size=(4, 8))
    mask = np.array([1, 1, 0, 1], np.float32)
    want = np.asarray(jax.jit(jax_build_model(cfg).apply)(
        flax, jnp.asarray(toks, jnp.int32), row_mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = module(torch.tensor(toks), row_mask=torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert module.layer_names() == ["embed", "block0", "block1", "logits"]


def test_remat_with_moe_raises_and_stray_experts_are_ignored():
    module = build_model(dict(CFG, remat=True))
    with pytest.raises(ValueError, match="remat with MoE blocks"):
        module(torch.zeros(1, 8, dtype=torch.long))
    # num_experts on another family is ignored by the builder and the fit
    mlp = {"type": "mlp", "hidden": [4], "num_classes": 2, "num_experts": 4,
           "dtype": "float32"}
    rng = np.random.default_rng(0)
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.utils import object_column
    df = DataFrame({"features": object_column(
        [r for r in rng.normal(size=(16, 3)).astype(np.float32)]),
        "label": rng.integers(0, 2, 16)})
    model = TorchLearner(modelConfig=mlp, device="cpu", epochs=1,
                         batchSize=8).fit(df)
    assert len(model.transform(df).col("scores")) == 16


def test_torch_model_scores_do_not_depend_on_padding():
    cfg = {"type": "transformer", "vocab_size": 30, "d_model": 8,
           "heads": 2, "layers": 1, "num_classes": 3, "max_len": 16,
           "num_experts": 2, "capacity_factor": 1.0, "dtype": "float32"}
    params = _flax_init(cfg)
    toks = np.random.default_rng(0).integers(0, 30, size=(9, 8))

    def scores(rows):
        m = TorchModel(inputCol="features", modelConfig=cfg,
                       modelParams=params, device="cpu")
        return np.stack(m.transform(token_frame(rows, np.zeros(len(rows))))
                        .col("scores"))
    s9, s8 = scores(toks), scores(toks[:8])      # 9 rows pad to 16
    np.testing.assert_allclose(s9[:8], s8, rtol=1e-5, atol=1e-5)
    col = np.empty(9, dtype=object)
    for i, r in enumerate(toks):
        col[i] = r.astype(np.float32)
    jm = TpuModel().setInputCol("features").setModelConfig(cfg) \
        .setModelParams(params)
    want = np.stack(jm.transform(JaxDataFrame({"features": col}))
                    .col("scores"))
    np.testing.assert_allclose(s9, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ fits

N, B = 32, 8


def _data():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 17, size=(N, 8))
    return toks, (toks[:, 0] > 8).astype(np.int64)


def _jax_fit(flax, knob=None):
    toks, y = _data()
    df = JaxDataFrame({"features": jax_object_column(
        [r.astype(np.float32) for r in toks]), "label": y})
    lr = (TpuLearner().setModelConfig(CFG).setEpochs(2).setBatchSize(B)
          .setLearningRate(0.05).setShuffle(False).setDeviceDataCap(1)
          .setMoeAuxWeight(0.01))
    if knob:
        lr = lr.setExpertParallel(2)
    import mmlspark_tpu.models.trainer as jt
    orig = jt.build_model

    class _Init:
        def __init__(self, m):
            self.m = m

        def init(self, *a, **k):
            return jax.tree_util.tree_map(jnp.asarray, flax)

        def __getattr__(self, name):
            return getattr(self.m, name)
    jt.build_model = lambda cfg, attn_fn=None: _Init(orig(cfg, attn_fn))
    try:
        m = lr.fit(df)
    finally:
        jt.build_model = orig
    return from_flax_params(m.getModelParams(), CFG), m._final_loss


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    flax = _flax_init(CFG)
    toks, y = _data()
    common = dict(cfg=CFG, toks=toks, labels=y, batch=B,
                  extra={"moeAuxWeight": 0.01})
    ranks = run_ranks_async(2, "fits", tmp_path_factory.mktemp("moe"),
                            flax_params=flax,
                            fits={"dp": dict(common, knobs={}),
                                  "ep": dict(common,
                                             knobs={"expertParallel": 2})})
    refs = {"jax": _jax_fit(flax), "jax_ep": _jax_fit(flax, knob="ep")}
    return dict(refs, ranks=ranks.result(), flax=flax)


def _params_close(got: dict, want: dict, atol=2e-4):
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), v.numpy(), atol=atol,
                                   rtol=0, err_msg=k)


def test_one_device_moe_fit_matches_tpu_learner(fits, monkeypatch):
    monkeypatch.setattr(trainer, "init_params", lambda cfg, seed:
                        from_flax_params(fits["flax"], cfg))
    toks, y = _data()
    m = TorchLearner(featuresCol="features", modelConfig=CFG, device="cpu",
                     epochs=2, batchSize=B, learningRate=0.05,
                     shuffle=False, deviceDataCap=1,
                     moeAuxWeight=0.01).fit(token_frame(toks, y))
    want, loss = fits["jax"]
    _params_close({k: v.numpy() for k, v in m.getModelParams().items()},
                  want)
    assert abs(m._final_loss - loss) < 1e-5


@pytest.mark.parametrize("name,ref", [("dp", "jax"), ("ep", "jax_ep")])
def test_two_rank_moe_fits_match_jax(fits, name, ref):
    r0, r1 = (r[name] for r in fits["ranks"])
    want, loss = fits[ref]
    _params_close(r0["params"], want)
    assert abs(r0["loss"] - loss) < 1e-5
    for k in r0["params"]:               # the whole tree on both ranks
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k])

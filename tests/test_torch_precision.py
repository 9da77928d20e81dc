"""The port's loss scaler, optimizers and losses against the JAX package's.

``mmlspark_tpu_torch.models.precision`` is held against
``mmlspark_tpu.models.precision`` and ``trainer.make_optimizer`` /
``make_loss`` against ``mmlspark_tpu.models.trainer``'s (optax's update
math): the same numpy params, gradients and batches go through both.

Tolerances: the scale recurrence is exact (the same selections on the same
powers of two). Optimizer updates and losses at 1e-6: the same float32
formulas, evaluated by another library (the bias correction's power, the
logsumexp's max shift).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.models import precision as jprec
from mmlspark_tpu.models.trainer import (make_loss as jax_make_loss,
                                         make_optimizer as jax_make_optimizer)
from mmlspark_tpu_torch.models import precision as prec
from mmlspark_tpu_torch.models.trainer import make_loss, make_optimizer


def _host(state) -> tuple:
    return (float(np.asarray(state.scale)), int(np.asarray(state.growth)),
            int(np.asarray(state.skipped)))


@pytest.mark.parametrize("scale,growth,finite", [
    (2.0 ** 15, 0, True),                        # an ordinary finite step
    (2.0 ** 15, 7, False),                       # skip: back off, count
    (2.0 ** 15, jprec.GROWTH_INTERVAL - 1, True),   # growth is reached
    (jprec.MAX_SCALE, jprec.GROWTH_INTERVAL - 1, True),  # clamped at MAX
    (jprec.MIN_SCALE, 3, False),                 # clamped at MIN
    (1.5, jprec.GROWTH_INTERVAL - 2, True),
])
def test_update_scale_matches_jax(scale, growth, finite):
    jstate = jprec.ScaleState(jnp.float32(scale), jnp.int32(growth),
                              jnp.int32(4))
    state = prec.ScaleState(torch.tensor(scale, dtype=torch.float32),
                            torch.tensor(growth, dtype=torch.int32),
                            torch.tensor(4, dtype=torch.int32))
    want = _host(jprec.update_scale(jstate, jnp.bool_(finite)))
    got = prec.update_scale(state, torch.tensor(finite))
    assert (got.scale.dtype, got.growth.dtype, got.skipped.dtype) == (
        torch.float32, torch.int32, torch.int32)
    assert _host(got) == want


def test_scale_state_host_round_trip():
    s = prec.init_scale_state(2.0 ** 10)
    assert prec.scale_state_to_host(s) == jprec.scale_state_to_host(
        jprec.init_scale_state(2.0 ** 10))
    back = prec.scale_state_from_host({"scale": 8.0, "growth": 3,
                                       "skipped": 2})
    assert prec.scale_state_to_host(back) == {"scale": 8.0, "growth": 3,
                                              "skipped": 2}
    assert prec.MODES == jprec.MODES


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(4, 3)) * scale).astype(np.float32),
            "b": (rng.normal(size=(3,)) * scale).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(0)
    want = jprec.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                     max_norm)
    got = prec.clip_by_global_norm(_t(g), max_norm)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad", [None, np.inf, -np.inf, np.nan])
def test_all_finite_matches_jax(bad):
    g = _tree(1)
    if bad is not None:
        g["b"][1] = bad
    want = bool(jprec.all_finite({k: jnp.asarray(v) for k, v in g.items()}))
    got = prec.all_finite(_t(g))
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == want == (bad is None)


def _linear_loss_jax(p, xb, yb, wb):
    losses = jnp.mean((xb @ p["w"] + p["b"] - yb) ** 2, axis=-1)
    return jnp.sum(losses * wb) / jnp.maximum(jnp.sum(wb), 1.0)


def _linear_loss_torch(p, xb, yb, wb):
    losses = torch.mean((xb @ p["w"] + p["b"] - yb) ** 2, dim=-1)
    return torch.sum(losses * wb) / torch.clamp_min(torch.sum(wb), 1.0)


def _batch(seed, poison=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    if poison:
        x[2, 1] = np.inf
    y = rng.normal(size=(6, 3)).astype(np.float32)
    w = np.array([1, 1, 1, 1, 1, 0], np.float32)
    return x, y, w


@pytest.mark.parametrize("case", ["finite", "skip", "growth", "clip"])
def test_mixed_step_body_matches_jax(case):
    """The fused bf16_mixed body on one loss closure and one set of params:
    a finite step, a non-finite one (old params and opt_state kept, scale
    halved, skip counted), the growth after GROWTH_INTERVAL steps (reached
    by presetting growth), and a clipped step."""
    params = _tree(2)
    x, y, w = _batch(3, poison=case == "skip")
    growth = jprec.GROWTH_INTERVAL - 1 if case == "growth" else 5
    clip = 0.05 if case == "clip" else 0.0
    jtx = jax_make_optimizer("adam", 1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jbody = jax.jit(jprec.make_mixed_step_body(_linear_loss_jax, jtx, clip))
    jstate = jprec.ScaleState(jnp.float32(2.0 ** 15), jnp.int32(growth),
                              jnp.int32(0))
    jp2, jopt2, js2, jloss = jbody(jp, jtx.init(jp), jstate, x, y, w)

    tx = make_optimizer("adam", 1e-3)
    tp = _t(params)
    state = prec.ScaleState(torch.tensor(2.0 ** 15),
                            torch.tensor(growth, dtype=torch.int32),
                            torch.tensor(0, dtype=torch.int32))
    body = prec.make_mixed_step_body(_linear_loss_torch, tx, clip)
    p2, opt2, s2, loss = body(tp, tx.init(tp), state, *map(torch.from_numpy,
                                                            (x, y, w)))
    assert _host(s2) == _host(js2)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(p2[k].numpy(), np.asarray(jp2[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(opt2["mu"][k].numpy(),
                                   np.asarray(jopt2[0].mu[k]), rtol=1e-5,
                                   atol=1e-9)
    assert int(opt2["count"]) == int(jopt2[0].count)
    if case == "skip":
        assert _host(s2)[2] == 1 and _host(s2)[0] == 2.0 ** 14
        for k in params:     # the old values, bit for bit
            assert np.array_equal(p2[k].numpy(), params[k])
            assert not opt2["nu"][k].any()
    if case == "growth":
        assert _host(s2)[:2] == (2.0 ** 16, 0)


def _optax_chain(name, wd):
    return jax_make_optimizer(name, 1e-2, momentum=0.8, weight_decay=wd)


@pytest.mark.parametrize("name,wd", [("sgd", 0.0), ("momentum", 0.0),
                                     ("adam", 0.0), ("adamw", 0.0),
                                     ("adamw", 0.1), ("sgd", 0.05),
                                     ("momentum", 0.05), ("adam", 0.05)])
def test_make_optimizer_matches_optax(name, wd):
    """Five updates from the same params and gradients; wd > 0 on the other
    optimizers chains add_decayed_weights in front, as the JAX trainer
    does."""
    params = _tree(4)
    jtx = _optax_chain(name, wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = jtx.init(jp)
    tx = make_optimizer(name, 1e-2, momentum=0.8, weight_decay=wd)
    tp = _t(params)
    opt = tx.init(tp)
    for i in range(5):
        g = _tree(10 + i, scale=0.3)
        ju, jopt = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                              jopt, jp)
        jp = optax.apply_updates(jp, ju)
        u, opt = tx.update(_t(g), opt, tp)
        tp = prec.apply_updates(tp, u)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} step {i} {k}")


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError):
        make_optimizer("rmsprop", 0.1)
    with pytest.raises(ValueError):
        make_loss("hinge")


@pytest.mark.parametrize("name", ["cross_entropy", "mse"])
def test_make_loss_matches_jax(name):
    rng = np.random.default_rng(5)
    if name == "cross_entropy":
        preds = rng.normal(size=(7, 5)).astype(np.float32) * 3
        labels = rng.integers(0, 5, size=7).astype(np.int32)
    else:
        preds = rng.normal(size=(7, 1)).astype(np.float32)
        labels = rng.normal(size=7).astype(np.float32)
    for per_example in (True, False):
        want = np.asarray(jax_make_loss(name, per_example)(
            jnp.asarray(preds), jnp.asarray(labels)))
        got = make_loss(name, per_example)(torch.from_numpy(preds),
                                           torch.from_numpy(labels))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_value_and_grad_matches_jax():
    params = _tree(6)
    x, y, w = _batch(7)
    jl, jg = jax.value_and_grad(_linear_loss_jax)(
        {k: jnp.asarray(v) for k, v in params.items()}, x, y, w)
    loss, grads = prec.value_and_grad(_linear_loss_torch, _t(params),
                                      *map(torch.from_numpy, (x, y, w)))
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6)

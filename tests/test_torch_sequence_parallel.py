"""The port's ring and Ulysses attention against the JAX package's.

``parallel.sequence.make_sp_attention`` over a ``seq`` axis of 2 and of 4
gloo ranks (one process each, ``tests/torch_dist_workers.py``), causal and
not, on the same bfloat16 (B, T, H, D) inputs made from a numpy seed, is
held against ``mmlspark_tpu.parallel.sequence.make_sp_attention`` over a
``seq`` axis of the conftest's 8-device CPU mesh: the output, and the
gradients of ``sum(out * g)`` with respect to q, k and v. Every rank holds
the whole inputs (as in a fit, where the data slice is replicated over the
seq group) and must return the same output and gradients as every other.

Tolerance: both sides round the bf16 output and gradients, and the
per-block products sum in different orders; outputs and gradients agree
within 2e-2 of each array's largest element (a bf16 ulp at 1 is 7.8e-3).
Ulysses with heads not divisible by the axis raises the JAX error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmlspark_tpu.parallel import mesh as jmesh
from mmlspark_tpu.parallel.sequence import make_sp_attention as jax_sp

from torch_dist_workers import run_ranks

B, T, H, D = 2, 16, 4, 8
TOL = 2e-2
CASES = [(mode, causal) for mode in ("ring", "ulysses")
         for causal in (False, True)]


def _inputs():
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)  # noqa: E731
                              .astype(jnp.float32))
    return bf(q), bf(k), bf(v), g


def _jax_reference(sp, mode, causal, q, k, v, g):
    mesh = jmesh.make_mesh({"seq": sp})
    attn = jax_sp(mesh, "seq", mode=mode, causal=causal)

    def loss(q_, k_, v_):
        return jnp.sum(attn(q_, k_, v_).astype(jnp.float32) * g)
    args = tuple(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    out = np.asarray(jax.jit(attn)(*args).astype(jnp.float32))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return out, [np.asarray(x.astype(jnp.float32)) for x in grads]


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.fixture(scope="module", params=[2, 4])
def ranks_results(request, tmp_path_factory):
    """One gloo group of ``sp`` ranks runs every (mode, causal) case."""
    sp = request.param
    q, k, v, g = _inputs()
    tmp = tmp_path_factory.mktemp(f"sp{sp}")
    return sp, run_ranks(sp, "attention", tmp, q=q, k=k, v=v, g=g,
                         cases=CASES)


@pytest.mark.parametrize("mode,causal", CASES)
def test_sp_attention_matches_jax(ranks_results, mode, causal):
    sp, res = ranks_results
    q, k, v, g = _inputs()
    want_out, want_grads = _jax_reference(sp, mode, causal, q, k, v, g)
    per_rank = [r[(mode, causal)] for r in res]
    for r, got in enumerate(per_rank):
        _close(got["out"], want_out, f"rank {r} out")
        for name, a, b in zip("qkv", got["grads"], want_grads):
            _close(a, b, f"rank {r} d{name}")
        # replicated over the seq group: every rank the same bits
        np.testing.assert_array_equal(got["out"], per_rank[0]["out"])
        for a, b in zip(got["grads"], per_rank[0]["grads"]):
            np.testing.assert_array_equal(a, b)


def test_ulysses_needs_heads_divisible_by_the_axis():
    import torch

    from mmlspark_tpu_torch.parallel import sequence

    class _Four:          # a stand-in group of size 4 for the shape check
        pass
    q = torch.zeros(1, 4, 6, 2)
    orig = sequence.coll.group_size
    sequence.coll.group_size = lambda g: 4 if isinstance(g, _Four) else 1
    try:
        with pytest.raises(ValueError, match=r"heads \(6\) divisible by sp"):
            sequence.ulysses_attention(q, q, q, _Four())
    finally:
        sequence.coll.group_size = orig
    mesh = jmesh.make_mesh({"seq": 4})
    with pytest.raises(ValueError, match=r"heads \(6\) divisible by sp"):
        jax_sp(mesh, "seq", mode="ulysses")(
            *(jnp.zeros((1, 8, 6, 2)),) * 3)


def test_one_rank_forms_are_blockwise_attention():
    """With no group (None) both forms are the single-device recurrence."""
    import torch

    from mmlspark_tpu_torch.parallel.sequence import (blockwise_attention,
                                                      ring_attention,
                                                      ulysses_attention)
    q, k, v, _ = (torch.tensor(a) for a in _inputs())
    for causal in (False, True):
        want = blockwise_attention(q, k, v, causal=causal)
        torch.testing.assert_close(ring_attention(q, k, v, None,
                                                  causal=causal), want,
                                   atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(ulysses_attention(q, k, v, None,
                                                     causal=causal), want,
                                   atol=0, rtol=0)

"""The port's flash-attention backward against the JAX package's custom VJP.

``flash_attention_bwd_reference`` (the plain PyTorch version of the dq and
dk/dv kernels, and what the kernel wrapper runs on CPU tensors) and
``torch.autograd.grad`` through ``flash_attention`` are held against
``jax.vjp`` of ``mmlspark_tpu.ops.pallas_kernels.flash_attention`` — its
backward kernels in Pallas interpret mode on the CPU, with 8-row blocks so
the ragged and cross-attention lengths are padded on the JAX side. The
same numpy inputs and cotangent go through both packages.

Tolerances: float32 at atol = rtol = 1e-4 (the same algorithm, summed in
another order). bfloat16 at 3e-2 of each gradient's max-abs: both round P
and dS to bf16 before their products, but from scores summed in another
order, so single elements round to neighbouring bf16 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.pallas_kernels import flash_attention as jax_flash
from mmlspark_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_reference)

# (B, Tq, Tk, H, D): tests/test_pallas_kernels.py:110, a T that no block
# divides, cross-attention lengths, and the slice's head dim of 128
SHAPES = {
    "base": (2, 64, 64, 2, 8),
    "nondivisible": (2, 20, 20, 2, 8),
    "cross": (1, 12, 28, 2, 8),
    "d128": (1, 24, 24, 2, 128),
}


def _inputs(shape, seed=0):
    B, Tq, Tk, H, D = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    g = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    return q, k, v, g


def _jax_grads(q, k, v, g, causal, dtype):
    qj, kj, vj, gj = (jnp.asarray(x, dtype=dtype) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal, None, 8, 8),
                     qj, kj, vj)
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(gj)]


def _port_grads(q, k, v, g, causal, dtype):
    """(reference backward from the forward's out/lse, autograd through
    flash_attention), each as float32 numpy (dq, dk, dv)."""
    tq, tk, tv, tg = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    out, lse = flash_attention_fwd(tq, tk, tv, causal=causal)
    ref = flash_attention_bwd_reference(tq, tk, tv, out, lse, tg,
                                        causal=causal)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    auto = torch.autograd.grad(flash_attention(*leaves, causal=causal),
                               leaves, tg)
    for got in (ref, auto):
        assert all(x.dtype == dtype for x in got)
    return ([x.float().numpy() for x in ref], [x.float().numpy() for x in auto])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_backward_matches_jax_vjp_f32(shape, causal):
    q, k, v, g = _inputs(SHAPES[shape])
    want = _jax_grads(q, k, v, g, causal, jnp.float32)
    for got in _port_grads(q, k, v, g, causal, torch.float32):
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                       err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", ["base", "cross", "d128"])
def test_backward_matches_jax_vjp_bf16(shape, causal):
    q, k, v, g = _inputs(SHAPES[shape], seed=1)
    want = _jax_grads(q, k, v, g, causal, jnp.bfloat16)
    for got in _port_grads(q, k, v, g, causal, torch.bfloat16):
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            tol = 3e-2 * max(1e-6, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_autograd_path_passes_gradcheck(causal):
    """float64 through the autograd Function: the plain versions then
    accumulate in float64, so finite differences can check the backward."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, T, 2, 4)))
               .requires_grad_() for T in (5, 7, 7))
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention(a, b, c, causal=causal), (q, k, v))


def test_cpu_tensors_never_touch_the_backward_launch_counters():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(SHAPES["base"]))
    before = (flash_attention_bwd.launches_dq,
              flash_attention_bwd.launches_dkv, flash_attention_fwd.launches)
    out, lse = flash_attention_reference(q, k, v, causal=True)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    ref = flash_attention_bwd_reference(q, k, v, out, lse, g, causal=True)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves, causal=True).backward(g)
    assert (flash_attention_bwd.launches_dq,
            flash_attention_bwd.launches_dkv,
            flash_attention_fwd.launches) == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_explicit_scale_and_no_grad_forward():
    """A custom scale reaches the backward; without grad mode the Function
    is a plain forward."""
    q, k, v, g = _inputs((1, 16, 40, 2, 8), seed=3)
    qj, kj, vj, gj = (jnp.asarray(x) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, True, 0.3, 8, 16),
                     qj, kj, vj)
    want = vjp(gj)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, causal=True,
                                              scale=0.3),
                              leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    with torch.no_grad():
        out = flash_attention(*leaves, causal=True, scale=0.3)
    assert not out.requires_grad


def test_backward_wrapper_rejects_mismatched_inputs():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(SHAPES["cross"]))
    out, lse = flash_attention_reference(q, k, v)
    with pytest.raises(ValueError, match="out and dO"):
        flash_attention_bwd(q, k, v, out, lse, g[:, :5])
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse[:, :5], g)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse.double(), g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,tol_l2", [(torch.float32, 1e-4, 2e-6),
                                              (torch.bfloat16, 2e-2, 2e-3)])
def test_cuda_backward_kernels_match_reference(dtype, tol, tol_l2):
    """On a card: the dq and dk/dv kernels against their plain version
    (ragged cross-attention lengths, both masks, both head dims, a
    non-contiguous dO), each launched once per call. Each gradient is held
    on max |error| over max(1, max |plain|) and on ||error||_2 /
    ||plain||_2, which the large gradients of early causal rows cannot
    swamp (as chip_smoke.py holds them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for D in (64, 128):
        for causal in (False, True):
            q, k, v, g = (torch.from_numpy(x).to("cuda", dtype)
                          for x in _inputs((2, 77, 130, 3, D)))
            g = g.transpose(0, 1).contiguous().transpose(0, 1)  # a view
            out, lse = flash_attention_fwd(q, k, v, causal=causal)
            before = (flash_attention_bwd.launches_dq,
                      flash_attention_bwd.launches_dkv)
            got = flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
            ref = flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                causal=causal)
            torch.cuda.synchronize()
            assert (flash_attention_bwd.launches_dq,
                    flash_attention_bwd.launches_dkv) == (before[0] + 1,
                                                          before[1] + 1)
            for a, b in zip(got, ref):
                err = (a.float() - b.float()).abs().max().item()
                assert err <= tol * max(1.0, b.float().abs().max().item())
                l2 = (a.float() - b.float()).norm() / b.float().norm()
                assert l2.item() <= tol_l2

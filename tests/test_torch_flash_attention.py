"""The port's flash-attention forward against the JAX package's.

``flash_attention_reference`` (the plain PyTorch version of the CUDA kernel,
and what the kernel wrapper runs on CPU tensors) is held against
``mmlspark_tpu.ops.pallas_kernels.flash_attention`` and, for the row
logsumexp, ``_flash_attention_fwd_impl`` — both in Pallas interpret mode on
the CPU, as the JAX package's own tests run them. Inputs come from a seeded
numpy generator and go through both packages.

Tolerances: float32 at 1e-5 on out and lse (the same algorithm in another
summation order). bfloat16 inputs at 2e-2 on out: the TPU kernel rounds P to
bf16 after subtracting a running max per 8-key block, the plain version after
subtracting the global row max, so the rounding lands in different places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.pallas_kernels import (_flash_attention_fwd_impl,
                                             flash_attention as jax_flash)
from mmlspark_tpu.parallel.sequence import plain_attention as jax_plain
from mmlspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_fwd,
                                                    flash_attention_reference)
from mmlspark_tpu_torch.parallel.sequence import (blockwise_attention,
                                                  plain_attention)

# (B, Tq, Tk, H, D): tests/test_pallas_kernels.py:19 (:27 non-divisible T,
# :35 cross-attention lengths), and a head dim of 128 as the slice runs
SHAPES = {
    "base": (2, 32, 32, 2, 16),
    "nondivisible": (2, 20, 20, 2, 16),
    "cross": (1, 12, 28, 2, 8),
    "d128": (1, 24, 24, 2, 128),
}


def _qkv(shape, seed=0):
    B, Tq, Tk, H, D = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, H, D)).astype(np.float32)
                 for T in (Tq, Tk, Tk))


def _jax(q, k, v, causal, dtype):
    qj, kj, vj = (jnp.asarray(x, dtype=dtype) for x in (q, k, v))
    out = jax_flash(qj, kj, vj, causal=causal, block_q=8, block_k=8)
    _, lse = _flash_attention_fwd_impl(qj, kj, vj, causal, None, 8, 8, None)
    return (np.asarray(out.astype(jnp.float32)), np.asarray(lse))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_reference_matches_jax_flash_f32(shape, causal):
    q, k, v = _qkv(SHAPES[shape])
    ref_out, ref_lse = _jax(q, k, v, causal, jnp.float32)
    out, lse = flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert out.shape == q.shape and lse.shape == ref_lse.shape
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", ["base", "cross", "d128"])
def test_reference_matches_jax_flash_bf16(shape, causal):
    q, k, v = _qkv(SHAPES[shape], seed=1)
    ref_out, ref_lse = _jax(q, k, v, causal, jnp.bfloat16)
    out, lse = flash_attention_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref_out, atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-2)


def test_fully_masked_rows_and_explicit_scale():
    """Keys past Tk never count; a custom scale matches the JAX kernel."""
    q, k, v = _qkv((1, 16, 40, 2, 8), seed=2)
    ref_out = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=True, scale=0.3, block_q=8,
                                   block_k=16))
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=True, scale=0.3)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5, rtol=1e-5)


def test_cpu_tensors_never_touch_the_launch_counter():
    q, k, v = (torch.from_numpy(x) for x in _qkv(SHAPES["base"]))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    ref_out, ref_lse = flash_attention_reference(q, k, v, causal=True)
    assert flash_attention_fwd.launches == before
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


def test_wrapper_rejects_mismatched_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(SHAPES["cross"]))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k[:, :, :1], v)           # head count differs
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k.double(), v)             # dtype differs
    with pytest.raises(ValueError):
        flash_attention_fwd(q[0], k[0], v[0])             # not (B, T, H, D)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_and_blockwise_match_jax_plain(causal):
    q, k, v = _qkv((2, 40, 40, 2, 16), seed=3)
    ref = np.asarray(jax_plain(*(jnp.asarray(x) for x in (q, k, v)),
                               causal=causal))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(plain_attention(tq, tk, tv, causal=causal)
                               .numpy(), ref, atol=1e-5, rtol=1e-5)
    # block 16 over 40 keys leaves a short last block
    np.testing.assert_allclose(blockwise_attention(tq, tk, tv, block_size=16,
                                                   causal=causal).numpy(),
                               ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_reference(dtype, tol):
    """On a card: the CUDA kernel against its plain version (ragged
    cross-attention lengths, both masks, both head dims)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for D in (64, 128):
        for causal in (False, True):
            q, k, v = (torch.from_numpy(x).to("cuda", dtype)
                       for x in _qkv((2, 77, 130, 3, D)))
            before = flash_attention_fwd.launches
            out, lse = flash_attention_fwd(q, k, v, causal=causal)
            ref_out, ref_lse = flash_attention_reference(q, k, v,
                                                         causal=causal)
            torch.cuda.synchronize()
            assert flash_attention_fwd.launches == before + 1
            assert (out.float() - ref_out.float()).abs().max().item() <= tol
            assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_cuda_refuses_gradients_and_other_head_dims():
    """On a card: head dims other than 64 and 128 raise. Gradients no
    longer raise: they run the backward kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (torch.from_numpy(x).cuda() for x in _qkv(SHAPES["base"]))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v)                      # D = 16
    q, k, v = (torch.from_numpy(x).cuda().requires_grad_()
               for x in _qkv(SHAPES["d128"]))
    flash_attention(q, k, v, causal=True).sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in (q, k, v))

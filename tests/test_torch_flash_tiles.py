"""The flash-attention forward at the edges of the bf16 CUDA kernel's tiles.

The kernel (``mmlspark_tpu_torch/ops/csrc/flash_attention_fwd.cu``) owns
128-row query tiles, walks 128-key K/V tiles, and reads q, k and v by TMA
boxes of 64 values of D x 128 time steps, zero-filled past the last row.
Here, on the CPU:

* ``flash_attention_reference`` (what the kernel is held against on the card,
  and what the wrapper runs on CPU tensors) against the JAX package's
  ``_flash_attention_fwd_impl`` and ``flash_attention`` in Pallas interpret
  mode, at the lengths where those tiles and boxes meet the data. Block
  sizes of 64 keep interpret mode quick. Tolerances as in
  ``test_torch_flash_attention.py``: float32 at 1e-5 (the same algorithm in
  another summation order), bfloat16 at 2e-2 (P rounded to bf16 after
  another running max).
* which operands TMA reads in place and which the wrapper copies;
* the tensor-map geometry the kernel encodes, emulated box by box.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.pallas_kernels import (_flash_attention_fwd_impl,
                                             flash_attention as jax_flash)
from mmlspark_tpu_torch.ops.flash_attention import (
    TMA_BOX, TMA_TILE, _kernel_readable, _readable, _strides, _tma_geometry,
    flash_attention_reference)

# (Tq, Tk): one row, one row over a second key tile, one tile less a row,
# one tile, one tile and a row, and cross-attention across both edges
TILE_EDGES = [(1, 1), (1, 129), (127, 127), (128, 128), (129, 129),
              (129, 300), (300, 129)]
BLOCK = 64


def _qkv(Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(1, T, 2, D)).astype(np.float32)
                 for T in (Tq, Tk, Tk))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk", TILE_EDGES)
def test_reference_matches_jax_at_tile_edges_f32(Tq, Tk, causal, D):
    q, k, v = _qkv(Tq, Tk, D, seed=Tq * 1000 + Tk)
    ref_out, ref_lse = _flash_attention_fwd_impl(
        *(jnp.asarray(x) for x in (q, k, v)), causal, None, BLOCK, BLOCK,
        None)
    out, lse = flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert out.shape == q.shape and lse.shape == (2, Tq)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk", [(1, 129), (129, 129), (129, 300),
                                   (300, 129)])
def test_reference_matches_jax_at_tile_edges_bf16(Tq, Tk, causal):
    q, k, v = _qkv(Tq, Tk, 128, seed=7)
    qj, kj, vj = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    ref_out = jax_flash(qj, kj, vj, causal=causal, block_q=BLOCK,
                        block_k=BLOCK)
    _, ref_lse = _flash_attention_fwd_impl(qj, kj, vj, causal, None, BLOCK,
                                           BLOCK, None)
    out, lse = flash_attention_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref_out.astype(jnp.float32)),
                               atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-2)


def _qkv_views(B, T, H, D, dtype):
    """q, k, v as the model's fused projection hands them over: views of
    one (B, T, 3H, D) tensor."""
    return torch.randn(B, T, 3 * H, D).to(dtype).split(H, dim=2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
def test_qkv_projection_views_are_read_in_place(dtype, D):
    views = _qkv_views(2, 129, 4, D, dtype)
    assert not views[1].is_contiguous()
    assert all(_kernel_readable(x) for x in views)
    assert all(got is x for got, x in zip(_readable(*views), views))


def _offset_view(shape, dtype, offset):
    """A (B, T, H, D) tensor starting ``offset`` elements into its buffer."""
    n = int(np.prod(shape))
    return torch.randn(n + offset).to(dtype)[offset:].view(shape)


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 1),
                                          (torch.bfloat16, 4),
                                          (torch.float32, 2)])
def test_unaligned_base_is_copied(dtype, offset):
    x = _offset_view((1, 130, 2, 64), dtype, offset)
    assert x.data_ptr() % 16 != 0 and not _kernel_readable(x)
    (y,) = _readable(x)
    assert y is not x and y.data_ptr() % 16 == 0 and _kernel_readable(y)
    assert torch.equal(y, x)


@pytest.mark.parametrize("pad", [1, 4])
def test_stride_off_16_bytes_is_copied(pad):
    """Heads padded by ``pad`` bf16 values: the head stride (D + pad) * 2
    bytes is not a multiple of 16, which TMA refuses."""
    x = torch.randn(2, 130, 2, 128 + pad).to(torch.bfloat16)[..., :128]
    assert x.stride(3) == 1 and not _kernel_readable(x)
    (y,) = _readable(x)
    assert y.is_contiguous() and _kernel_readable(y) and torch.equal(y, x)


def test_head_dim_not_contiguous_is_copied():
    x = torch.randn(1, 130, 64, 2).to(torch.bfloat16).transpose(2, 3)
    assert x.stride(3) != 1 and not _kernel_readable(x)
    (y,) = _readable(x)
    assert y.stride(3) == 1 and torch.equal(y, x)


def test_extent_one_dims_take_packed_strides():
    """B = 1 and H = 1 are never stepped: whatever strides PyTorch gives
    them (``contiguous()`` keeps them), the kernels get packed ones and TMA
    reads the tensor in place."""
    base = torch.randn(1 * 300 * 1 * 64).to(torch.bfloat16)
    x = base.as_strided((1, 300, 1, 64), (3, 64, 5, 1))
    assert x.is_contiguous() and x.contiguous() is x
    assert _strides(x) == (300 * 64, 64, 64)
    assert _kernel_readable(x) and _readable(x)[0] is x
    assert _tma_geometry(x)["strides"] == (128, 128, 300 * 128)


@pytest.mark.parametrize("D", [64, 128])
def test_tma_geometry_of_contiguous_and_view_operands(D):
    B, T, H = 2, 300, 4
    x = torch.zeros(B, T, H, D, dtype=torch.bfloat16)
    g = _tma_geometry(x)
    assert g["dims"] == (D, H, T, B)
    assert g["strides"] == (2 * D, 2 * H * D, 2 * T * H * D)
    assert g["box"] == (TMA_BOX, 1, TMA_TILE, 1) == (64, 1, 128, 1)
    assert g["boxes"] == D // 64
    # one box row is one 128-byte swizzled row
    assert g["box"][0] * x.element_size() == 128
    qv = _qkv_views(B, T, H, D, torch.bfloat16)[0]
    assert _tma_geometry(qv)["strides"] == (2 * D, 2 * 3 * H * D,
                                            2 * T * 3 * H * D)


def _tma_box(x, g, coords):
    """What one TMA load of the geometry ``g`` at ``coords`` (innermost
    first) brings: (128 rows of time, 64 values of D), zeros past the
    tensor's extent, addressed only through g's dims and byte strides."""
    esize = x.element_size()
    # the whole buffer from its first element, as TMA's base pointer sees it
    base = x.as_strided((x.untyped_storage().nbytes() // esize,), (1,), 0)
    d0, h, t0, b = coords
    dims, strides = g["dims"], g["strides"]
    rows = []
    for t in range(t0, t0 + g["box"][2]):
        if t >= dims[2]:
            rows.append(torch.zeros(g["box"][0], dtype=x.dtype))
            continue
        off = (x.storage_offset() * esize + h * strides[0] + t * strides[1]
               + b * strides[2]) // esize + d0
        rows.append(base[off:off + g["box"][0]])
    return torch.stack(rows)


@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("T", [1, 129, 300])
def test_tma_boxes_cover_the_operand(T, views):
    """Every box of every (batch, head, time tile, D half) the kernel loads
    holds exactly the operand's rows, and zeros past T."""
    B, H, D = 2, 3, 128
    x = (_qkv_views(B, T, H, D, torch.bfloat16)[1] if views
         else torch.randn(B, T, H, D).to(torch.bfloat16))
    g = _tma_geometry(x)
    n_tiles = -(-T // TMA_TILE)
    for b in range(B):
        for h in range(H):
            for i in range(n_tiles):
                for c in range(g["boxes"]):
                    box = _tma_box(x, g, (c * TMA_BOX, h, i * TMA_TILE, b))
                    want = torch.zeros(TMA_TILE, TMA_BOX, dtype=x.dtype)
                    rows = x[b, i * TMA_TILE:(i + 1) * TMA_TILE, h,
                             c * TMA_BOX:(c + 1) * TMA_BOX]
                    want[:rows.shape[0]] = rows
                    assert torch.equal(box, want), (b, h, i, c)


# ptxas' report for the forward library, as nvcc -Xptxas -v prints it
_FN = ("_ZN55_GLOBAL__N__4b2830eb_22_flash_attention_fwd_cu_cc076fa214"
       "flash_fwd_bf16ILi{}EEEv14CUtensorMap_stS1_S1_S1_Pfiiiif")
_F32 = ("_ZN55_GLOBAL__N__4b2830eb_22_flash_attention_fwd_cu_cc076fa213"
        "flash_fwd_f32ILi128EEEvPKfS2_S2_NS_4RowsES3_S3_PfS4_iiiif")


def _ptxas(spill128=0, serialized=False):
    lines = ["ptxas info    : 0 bytes gmem"]
    if serialized:
        lines.append("ptxas info    : (C7512) Potential Performance Loss: "
                     "wgmma.mma_async instructions are serialized due to "
                     f"insufficient register resources for the function "
                     f"'{_FN.format(128)}'")
    for fn, spill in ((_FN.format(128), spill128), (_FN.format(64), 0),
                      (_F32, 8)):
        lines += [f"ptxas info    : Compiling entry function '{fn}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Function properties for {fn}",
                  f"    {spill} bytes stack frame, {spill} bytes spill "
                  f"stores, {spill} bytes spill loads",
                  "ptxas info    : Used 168 registers, used 16 barriers"]
    return "\n".join(lines)


@pytest.mark.parametrize("spill,serialized,clean", [(0, False, True),
                                                    (80, False, False),
                                                    (0, True, False)])
def test_chip_smoke_reads_the_forward_ptxas_report(spill, serialized, clean):
    """chip_smoke.py's build phase picks the bf16 forward's lines out of
    ptxas' report (not the float32 kernel's) and fails on any spill or
    serialised wgmma."""
    import chip_smoke
    lines = chip_smoke.ptxas_lines(_ptxas(spill, serialized),
                                   "flash_fwd_bf16")
    assert sum("Used 168 registers" in ln for ln in lines) == 2
    assert not any("flash_fwd_f32" in ln for ln in lines)
    assert chip_smoke.spill_free(lines, 2) is clean

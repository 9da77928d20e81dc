"""The flash-attention backward at the edges of the bf16 CUDA kernels' tiles.

The dq and dk/dv kernels (``mmlspark_tpu_torch/ops/csrc/flash_attention_bwd.cu``)
hold 128-row stationary tiles (dq's queries, dk/dv's keys) and walk 64-row
ring tiles (dq's keys, dk/dv's queries), all read by TMA in boxes of 64
values of D x 64 time steps, zero-filled past the last row. Here, on the
CPU:

* ``flash_attention_bwd_reference`` (what the kernels are held against on
  the card, and what the wrapper runs on CPU tensors) against ``jax.vjp`` of
  the JAX package's ``flash_attention`` in Pallas interpret mode, at the
  lengths where those tiles and boxes meet the data. Blocks of 64 keep
  interpret mode quick. Tolerances: float32 at 1e-5 (the same algorithm
  summed in another order), bfloat16 at 2e-2 of each gradient's max-abs (P
  and dS rounded to bf16 from scores summed in another order).
* the rule by which ``chip_smoke.py`` skips its relative-L2 gate: exactly
  the gradients that vanish in exact arithmetic;
* the 64-row tensor-map geometry, emulated box by box over dO as autograd
  hands it over and over the forward's out;
* ``chip_smoke.py``'s reading of ptxas' report for the three warp-specialised
  bf16 kernels.

And on a card (``cuda`` marker): D = rowsum(dO * O) as the dq kernel writes
it, against the plain row dot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.pallas_kernels import flash_attention as jax_flash
from mmlspark_tpu_torch.ops.flash_attention import (
    TMA_BOX, TMA_BWD_ROWS, _BwdLaunch, _kernel_readable, _readable, _row_dot,
    _tma_geometry, flash_attention, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_reference)
from test_torch_flash_tiles import _tma_box

import chip_smoke

BLOCK = 64
# (Tq, Tk) where the 64-row ring tiles meet the data, beside the 128-row
# edges the forward's tests cover
RING_EDGES = [(63, 63), (64, 64), (65, 65), (1, 65)]
EDGES = list(chip_smoke.TILE_EDGES) + RING_EDGES


def _inputs(Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(1, T, 2, D)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    g = rng.normal(size=(1, Tq, 2, D)).astype(np.float32)
    return q, k, v, g


def _jax_grads(q, k, v, g, causal, dtype):
    qj, kj, vj, gj = (jnp.asarray(x, dtype=dtype) for x in (q, k, v, g))
    _, vjp = jax.vjp(
        lambda a, b, c: jax_flash(a, b, c, causal, None, BLOCK, BLOCK),
        qj, kj, vj)
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(gj)]


def _reference_grads(q, k, v, g, causal, dtype):
    tq, tk, tv, tg = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    out, lse = flash_attention_reference(tq, tk, tv, causal=causal)
    return [x.float().numpy() for x in flash_attention_bwd_reference(
        tq, tk, tv, out, lse, tg, causal=causal)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk", EDGES)
def test_reference_matches_jax_vjp_at_tile_edges_f32(Tq, Tk, causal):
    q, k, v, g = _inputs(Tq, Tk, 64, seed=Tq * 1000 + Tk)
    want = _jax_grads(q, k, v, g, causal, jnp.float32)
    got = _reference_grads(q, k, v, g, causal, torch.float32)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk", RING_EDGES)
def test_reference_matches_jax_vjp_at_ring_edges_d128_f32(Tq, Tk, causal):
    q, k, v, g = _inputs(Tq, Tk, 128, seed=Tq + Tk)
    want = _jax_grads(q, k, v, g, causal, jnp.float32)
    got = _reference_grads(q, k, v, g, causal, torch.float32)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk", [(65, 65), (129, 300)])
def test_reference_matches_jax_vjp_at_tile_edges_bf16(Tq, Tk, causal):
    q, k, v, g = _inputs(Tq, Tk, 128, seed=11)
    want = _jax_grads(q, k, v, g, causal, jnp.bfloat16)
    got = _reference_grads(q, k, v, g, causal, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        tol = 2e-2 * max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk", EDGES + [(3, 1), (7, 2)])
def test_l2_gate_skips_exactly_the_vanishing_gradients(Tq, Tk, causal):
    """chip_smoke.py's kernel_bwd phase skips its relative-L2 gate for dq
    and dk only where every row sees one key. In float64 those gradients
    are zero to rounding exactly there, and nowhere else."""
    q, k, v, g = (torch.from_numpy(x).double()
                  for x in _inputs(Tq, Tk, 64, seed=5))
    out, lse = flash_attention_reference(q, k, v, causal=causal)
    dq, dk, dv = flash_attention_bwd_reference(q, k, v, out, lse, g,
                                               causal=causal)
    vanish = [x.abs().max().item() < 1e-12 for x in (dq, dk)]
    skipped = chip_smoke.one_key_rows(Tq, Tk, causal)
    assert vanish == [skipped, skipped]
    assert dv.abs().max().item() > 1e-3


def test_backward_tile_edges_extend_the_forwards():
    assert set(chip_smoke.TILE_EDGES) < set(chip_smoke.BWD_TILE_EDGES)
    assert set(chip_smoke.BWD_TILE_EDGES) == set(EDGES)


# ------------------------------------------------------- TMA geometry (64)

def _autograd_dout(B, T, H, D, dtype):
    """dO exactly as autograd hands it to the backward when the model reads
    attention's output through a transpose: a non-contiguous view."""
    q, k, v = (torch.randn(B, T, H, D).to(dtype).requires_grad_()
               for _ in range(3))
    seen = []
    out = flash_attention(q, k, v, causal=True)
    out.register_hook(seen.append)
    w = torch.randn(B, H, T, D).to(dtype)
    (out.transpose(1, 2) * w).sum().backward()
    return seen[0], out.detach()


@pytest.mark.parametrize("D", [64, 128])
def test_tma_geometry_with_64_row_boxes(D):
    B, T, H = 2, 300, 4
    x = torch.zeros(B, T, H, D, dtype=torch.bfloat16)
    g = _tma_geometry(x, rows=TMA_BWD_ROWS)
    assert g["dims"] == (D, H, T, B)
    assert g["strides"] == (2 * D, 2 * H * D, 2 * T * H * D)
    assert g["box"] == (TMA_BOX, 1, TMA_BWD_ROWS, 1) == (64, 1, 64, 1)
    assert g["boxes"] == D // 64
    # the default stays the forward's 128-row box
    assert _tma_geometry(x)["box"] == (64, 1, 128, 1)


def test_autograd_dout_is_a_readable_view():
    do, _ = _autograd_dout(2, 130, 3, 64, torch.bfloat16)
    assert not do.is_contiguous() and do.stride(3) == 1
    assert _kernel_readable(do) and _readable(do)[0] is do


def test_expanded_dout_is_copied():
    """The gradient of ``out.sum()`` arrives expanded (stride 0 over every
    dim): the wrapper hands TMA a packed copy, not zero strides."""
    do = torch.ones((), dtype=torch.bfloat16).expand(2, 130, 3, 64)
    assert not _kernel_readable(do)
    (y,) = _readable(do)
    assert y.is_contiguous() and _kernel_readable(y) and torch.equal(y, do)


@pytest.mark.parametrize("which", ["dout", "out"])
@pytest.mark.parametrize("T", [1, 65, 130])
def test_64_row_boxes_cover_dout_and_out(T, which):
    """Every 64-row box the kernels load of dO (a non-contiguous autograd
    view) and of the forward's out holds exactly the operand's rows, and
    zeros past T; a 128-row tile is the two boxes at t0 and t0 + 64."""
    B, H, D = 2, 3, 128
    do, out = _autograd_dout(B, T, H, D, torch.bfloat16)
    x = do if which == "dout" else out
    g = _tma_geometry(x, rows=TMA_BWD_ROWS)
    for b in range(B):
        for h in range(H):
            for i in range(-(-T // TMA_BWD_ROWS)):
                t0 = i * TMA_BWD_ROWS
                for c in range(g["boxes"]):
                    box = _tma_box(x, g, (c * TMA_BOX, h, t0, b))
                    want = torch.zeros(TMA_BWD_ROWS, TMA_BOX, dtype=x.dtype)
                    rows = x[b, t0:t0 + TMA_BWD_ROWS, h,
                             c * TMA_BOX:(c + 1) * TMA_BOX]
                    want[:rows.shape[0]] = rows
                    assert torch.equal(box, want), (b, h, i, c)


# ------------------------------------------------------------ ptxas report

_MANGLED = {
    "flash_fwd_bf16": (
        "_ZN55_GLOBAL__N__4b2830eb_22_flash_attention_fwd_cu_cc076fa214"
        "flash_fwd_bf16ILi{}EEEv14CUtensorMap_stS1_S1_S1_Pfiiiif"),
    "flash_bwd_dq_bf16": (
        "_ZN55_GLOBAL__N__d0b972fd_22_flash_attention_bwd_cu_ce5dac7d17"
        "flash_bwd_dq_bf16ILi{}EEEvNS_7BwdMapsEPKfPfP13__nv_bfloat16iiiiif"),
    "flash_bwd_dkv_bf16": (
        "_ZN55_GLOBAL__N__d0b972fd_22_flash_attention_bwd_cu_ce5dac7d18"
        "flash_bwd_dkv_bf16ILi{}EEEvNS_7BwdMapsEPKfS3_iiiiif"),
}
_F32 = ("_ZN55_GLOBAL__N__d0b972fd_22_flash_attention_bwd_cu_ce5dac7d16"
        "flash_bwd_dq_f32ILi128EEEvPKfS2_S2_S2_NS_4RowsES3_S3_S3_S2_S2_Pfiiiif")


def _report(bad: str, fault: str) -> str:
    """ptxas' report as nvcc -Xptxas -v prints it for the three bf16
    entries at both head dims and a float32 one that spills; ``bad`` gets
    the ``fault`` ("spill" or "serialized") at D = 128."""
    lines = ["ptxas info    : 0 bytes gmem"]
    fns = [(entry, m.format(d)) for entry, m in _MANGLED.items()
           for d in (128, 64)] + [("f32", _F32)]
    for entry, fn in fns:
        spill = 8 if entry == "f32" else 0
        if entry == bad and fault == "spill" and "ILi128" in fn:
            spill = 80
        if entry == bad and fault == "serialized" and "ILi128" in fn:
            lines.append("ptxas info    : (C7512) Potential Performance "
                         "Loss: wgmma.mma_async instructions are serialized "
                         "due to insufficient register resources for the "
                         f"function '{fn}'")
        lines += [f"ptxas info    : Compiling entry function '{fn}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Function properties for {fn}",
                  f"    {spill} bytes stack frame, {spill} bytes spill "
                  f"stores, {spill} bytes spill loads",
                  "ptxas info    : Used 168 registers, used 16 barriers"]
    return "\n".join(lines)


@pytest.mark.parametrize("fault", ["spill", "serialized"])
@pytest.mark.parametrize("bad", list(_MANGLED))
@pytest.mark.parametrize("entry", [e for _, e in chip_smoke.WGMMA_ENTRIES])
def test_chip_smoke_reads_each_wgmma_kernels_ptxas_report(entry, bad, fault):
    """The build phase picks each warp-specialised kernel's own lines (not
    the float32 kernel's, not the other bf16 entries') and fails it alone
    on a spill or a serialised wgmma."""
    lines = chip_smoke.ptxas_lines(_report(bad, fault), entry)
    assert sum("Used 168 registers" in ln for ln in lines) == 2
    assert not any("_f32" in ln for ln in lines)
    assert all(entry in ln for ln in lines if "entry function" in ln)
    assert chip_smoke.spill_free(lines, 2) is (entry != bad)


# ------------------------------------------------------------- on a card

@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_cuda_dq_kernel_writes_the_row_dot(D):
    """On a card: D = rowsum(dO * O) as the bf16 dq kernel writes it for
    the dk/dv kernel, against the plain row dot (float32 sums of the same
    products in another order), within 1e-5 of its max-abs, at a ragged
    length, with dO a non-contiguous view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 300, 3, D), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    do = (torch.randn((2, 3, 300, D), generator=gen, device="cuda")
          .to(torch.bfloat16).transpose(1, 2))
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    call = _BwdLaunch(q, k, v, out, lse, do, True, D ** -0.5)
    call.dq_kernel()
    want = _row_dot(do, out)
    torch.cuda.synchronize()
    err = (call.delta - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-5

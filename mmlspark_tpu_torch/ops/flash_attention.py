"""Flash attention, forward: the port of ``mmlspark_tpu/ops/pallas_kernels.py``
``flash_attention`` / ``_flash_attention_fwd_impl`` / ``_flash_kernel``.

Three functions, all in the JAX package's (B, T, H, D) layout:

* :func:`flash_attention_fwd` — the kernel wrapper, returning ``(out, lse)``
  with ``lse`` of shape (B*H, Tq) in float32. On CUDA tensors it launches
  the hand-written kernel ``csrc/flash_attention_fwd.cu`` or raises; on CPU
  tensors (the tests) it runs the plain version. ``flash_attention_fwd.
  launches`` counts kernel launches and nothing else.
* :func:`flash_attention_reference` — the plain PyTorch version of the same
  function, with the kernel's masks, rounding points and lse semantics.
* :func:`flash_attention` — returns ``out`` only, the counterpart of the JAX
  package's public function. Forward only for now: on CUDA it refuses inputs
  that require a gradient, because the backward kernels are the next slice.

Semantics (from the TPU kernel): scores are float32 sums of input-typed
products, times ``scale`` (default 1/sqrt(D)); the causal mask is aligned
top-left (query i sees keys j <= i); P is rounded to the value type before
the PV product while the denominator sums unrounded P; a row that sees no
key gets output 0 and lse = NEG_INF = -1e30.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_C_FUNCTIONS = {
    "mmlspark_flash_attention_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "mmlspark_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check_qkv(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, T, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"k and v must be (B, Tk, H, D) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError("attention over zero keys")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def _to_bh(x):
    """(B, T, H, D) -> contiguous (B*H, T, D)."""
    B, T, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, T, D).contiguous()


def _kernel_readable(x) -> bool:
    """Whether the kernel can read ``x`` in place: contiguous head dim, and
    every row start 16-byte aligned (its cp.async copies move 16 bytes)."""
    esize = x.element_size()
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all((s * esize) % 16 == 0 for s in x.stride()[:3]))


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None):
    """Plain PyTorch flash-attention forward: (out (B, Tq, H, D) in q.dtype,
    lse (B*H, Tq) float32). Materializes the (Tq, Tk) scores — the
    kernel's yardstick for correctness, not for speed."""
    _check_qkv(q, k, v)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qb, kb, vb = _to_bh(q), _to_bh(k), _to_bh(v)
    s = torch.matmul(qb.float(), kb.float().transpose(1, 2)) * scale
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    none = m <= NEG_INF / 2
    p = torch.where(none, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vb.float())
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    lse = torch.where(none, NEG_INF, m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out.reshape(B, H, Tq, D).transpose(1, 2), lse


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Flash-attention forward: (out (B, Tq, H, D), lse (B*H, Tq) f32).

    CPU tensors run :func:`flash_attention_reference`. CUDA tensors launch
    the kernel on the current stream; they must be float32 or bfloat16 with
    head dim 64 or 128, or this raises."""
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu tensors, "
                         f"not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dim {_HEAD_DIMS}, "
                         f"not {D}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel grid's 65535")
    if Tq > 2 ** 31 - 64 or Tk > 2 ** 31 - 64:
        raise ValueError("sequence lengths must fit the kernel's int32")
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    # the kernel reads each (B, T, H, D) operand in place through its
    # strides — the model's qkv split hands over views of one projection;
    # an operand whose rows are not 16-byte aligned runs on a packed copy
    q, k, v = (x if _kernel_readable(x) else x.contiguous() for x in (q, k, v))
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    from . import _build
    lib = _build.load("flash_attention_fwd", _C_FUNCTIONS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mmlspark_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], B, H, Tq, Tk, D, int(bool(causal)),
            float(scale), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        msg = lib.mmlspark_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"cudaError {rc} ({msg})")
    flash_attention_fwd.launches += 1
    return out, lse


#: kernel launches since the last reset (a run sets it to 0 and reads it)
flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """FlashAttention forward: q/k/v (B, T, H, D) -> (B, Tq, H, D).

    Forward only: on CUDA, inputs that require a gradient (with grad mode
    on) raise rather than differentiate through some other path — the
    backward kernels are slice 2 (ROADMAP.md Queue 2 item 2)."""
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        raise NotImplementedError(
            "flash_attention backward is not ported yet (slice 2, ROADMAP.md "
            "Queue 2 item 2); run under torch.inference_mode() or no_grad()")
    out, _ = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    return out

"""Flash attention: the port of ``mmlspark_tpu/ops/pallas_kernels.py``
``flash_attention`` (its forward ``_flash_attention_fwd_impl`` /
``_flash_kernel`` and its custom VJP ``_flash_attention_bwd`` /
``_flash_bwd_dq_kernel`` / ``_flash_bwd_dkv_kernel``).

All in the JAX package's (B, T, H, D) layout:

* :func:`flash_attention_fwd` — the forward kernel wrapper, returning
  ``(out, lse)`` with ``lse`` of shape (B*H, Tq) in float32. On CUDA tensors
  it launches the hand-written kernel ``csrc/flash_attention_fwd.cu`` or
  raises; on CPU tensors (the tests) it runs the plain version.
  ``flash_attention_fwd.launches`` counts kernel launches and nothing else.
* :func:`flash_attention_bwd` — the backward kernel wrapper, returning
  ``(dq, dk, dv)``. On CUDA tensors it launches the two kernels of
  ``csrc/flash_attention_bwd.cu`` (dq, then dk/dv; in bf16 the dq kernel
  also takes D = rowsum(dO * O) and hands it to the dk/dv kernel) or
  raises; on CPU tensors it runs the plain version.
  ``flash_attention_bwd.launches_dq`` and ``.launches_dkv`` count the
  launches of each.
* :func:`attention_costs` — the analytic FLOPs and bytes of each kernel,
  which every launch reports to ``telemetry.profiler`` (the profiler's
  torch-op counters cannot see a kernel bound through ``ctypes``).
* :func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`
  — the plain PyTorch versions of the same functions, with the kernels'
  masks, rounding points and lse semantics.
* :func:`flash_attention` — returns ``out`` only, the counterpart of the JAX
  package's public function, differentiable through ``_FlashAttention``.

Semantics (from the TPU kernels): scores are float32 sums of input-typed
products, times ``scale`` (default 1/sqrt(D)); the causal mask is aligned
top-left (query i sees keys j <= i); P is rounded to the value type before
the PV product while the denominator sums unrounded P; a row that sees no
key gets output 0 and lse = NEG_INF = -1e30. The backward recomputes P from
lse, takes D = rowsum(dO * O) in float32, rounds P to dO's type before
P^T dO and dS = P (dO V^T - D) to the input type before dS K and dS^T Q,
and scales dq and dk once at the end. (The plain versions accumulate in
float64 for float64 inputs, so the autograd path can be gradchecked; the
kernels take float32 and bfloat16.)
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..telemetry import profiler

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
_C_FUNCTIONS_BWD = {
    "mmlspark_flash_attention_bwd_encode": (
        ctypes.c_int,
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 5),
    "mmlspark_flash_attention_bwd_dq": (
        ctypes.c_int,
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "mmlspark_flash_attention_bwd_dkv": (
        ctypes.c_int,
        [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "mmlspark_wgmma_tile_probe": (
        ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]),
    "mmlspark_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
#: bytes of the bf16 backward's seven tensor maps (q, k, v, dO and out read,
#: dk and dv written), one ``CUtensorMap`` of 128 bytes each
_BWD_MAPS_BYTES = 7 * 128


def visible_pairs(Tq: int, Tk: int, causal: bool) -> int:
    """(query, key) pairs the top-left causal mask leaves visible."""
    if not causal:
        return Tq * Tk
    m = min(Tq, Tk)
    return m * (m + 1) // 2 + max(0, Tq - Tk) * Tk


def attention_costs(B, H, Tq, Tk, D, causal, esize) -> dict:
    """{kernel: (FLOPs, bytes)} of one forward and of the two backward
    kernels (``esize`` bytes per q/k/v element). The forward does QK^T and
    PV over the visible pairs (2 FLOP per MAC) and reads q, k, v once and
    writes out and lse once; dq does three products per visible pair and
    dk/dv four, both reading q, k, v, dO, lse and D once and writing their
    gradients once."""
    pairs = B * H * visible_pairs(Tq, Tk, causal)
    qkv = esize * B * H * D * (2 * Tq + 2 * Tk)
    reads = qkv + 2 * 4 * B * H * Tq
    return {"fwd": (4.0 * D * pairs, qkv + 4 * B * H * Tq),
            "dq": (6.0 * D * pairs, reads + esize * B * H * Tq * D),
            "dkv": (8.0 * D * pairs, reads + 2 * esize * B * H * Tk * D)}


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


def _from_bh(x, B, H):
    """(B*H, T, D) -> (B, T, H, D)."""
    _, T, D = x.shape
    return x.reshape(B, H, T, D).transpose(1, 2)


def _acc_dtype(x) -> torch.dtype:
    """The plain versions' accumulation type: float32, or float64 for
    float64 inputs."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _scores(qb, kb, causal: bool, scale: float, acc):
    """Masked scores (B*H, Tq, Tk) from (B*H, T, D) operands."""
    s = torch.matmul(qb.to(acc), kb.to(acc).transpose(1, 2)) * scale
    if causal:
        Tq, Tk = qb.shape[1], kb.shape[1]
        qpos = torch.arange(Tq, device=qb.device)[:, None]
        kpos = torch.arange(Tk, device=qb.device)[None, :]
        s = s.masked_fill(qpos < kpos, NEG_INF)
    return s


#: rows of a query tile and keys of a K/V tile in the bf16 forward kernel,
#: and the bf16 values of D in one TMA box (one 128-byte swizzled row)
TMA_TILE, TMA_BOX = 128, 64
#: rows of a TMA box in the bf16 backward kernels: their ring tiles are 64
#: rows, and a 128-row stationary tile is loaded as two boxes
TMA_BWD_ROWS = 64


def _strides(x):
    """(batch, time, head) strides of a (B, T, H, D) operand, in elements,
    as the kernels take them: a dim of extent 1 is never stepped, so its
    stride (which PyTorch leaves arbitrary, and ``contiguous()`` keeps) is
    replaced by the packed one."""
    B, T, H, D = x.shape
    packed = (T * H * D, H * D, D)
    return tuple(s if n > 1 else p
                 for s, n, p in zip(x.stride()[:3], (B, T, H), packed))


def _tma_geometry(x, rows: int = TMA_TILE) -> dict:
    """The 4-D tensor map a bf16 kernel encodes for operand ``x``
    (B, T, H, D) with ``cuTensorMapEncodeTiled``: dims innermost first
    (D, H, T, B), byte strides of dims 1-3, and a box of 64 values of D x 1
    head x ``rows`` time steps x 1 batch, so D is read as D / 64 boxes
    (``encode_operand``, flash_common.cuh). The forward uses 128-row
    boxes, the backward 64-row ones."""
    B, T, H, D = x.shape
    sb, st, sh = _strides(x)
    esize = x.element_size()
    return {"dims": (D, H, T, B),
            "strides": (sh * esize, st * esize, sb * esize),
            "box": (TMA_BOX, 1, rows, 1),
            "boxes": D // TMA_BOX}


def _kernel_readable(x) -> bool:
    """Whether the kernels can read ``x`` in place: D contiguous, the base
    16-byte aligned and every stepped stride a positive multiple of 16
    bytes (TMA's rule for a tensor map, which the float32 kernels are held
    to as well; an expanded dO, stride 0, is packed)."""
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(0 < s < 2 ** 40 and s % 16 == 0
                    for s in _tma_geometry(x)["strides"]))


def _check_cuda(q, k, name: str):
    """What every CUDA kernel here takes; raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{q.device}")
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


def _readable(*xs):
    """Each operand as the kernels read it: in place through its strides
    (the model's qkv split hands over views of one projection), or a packed
    copy when TMA cannot read it (a base or stride not 16-byte aligned). The
    copy is a fresh allocation: ``contiguous()`` would hand back a packed
    tensor that starts off alignment unchanged."""
    return tuple(x if _kernel_readable(x)
                 else x.clone(memory_format=torch.contiguous_format)
                 for x in xs)


def _raise_on(rc: int, lib, what: str):
    if rc != 0:
        msg = lib.mmlspark_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {rc} ({msg})")


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None):
    """Plain PyTorch flash-attention forward: (out (B, Tq, H, D) in q.dtype,
    lse (B*H, Tq) float32, float64 for float64 inputs). Materializes the
    (Tq, Tk) scores — the kernel's yardstick for correctness, not for
    speed."""
    _check_qkv(q, k, v)
    B, Tq, H, D = q.shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    acc = _acc_dtype(q)
    qb, kb, vb = _to_bh(q), _to_bh(k), _to_bh(v)
    s = _scores(qb, kb, causal, scale, acc)
    m = s.amax(dim=-1, keepdim=True)
    none = m <= NEG_INF / 2
    p = torch.where(none, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).to(acc), vb.to(acc))
    out = (o / l.clamp_min(1e-30)).to(q.dtype)
    lse = torch.where(none, NEG_INF, m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return _from_bh(out, B, H), lse


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Flash-attention forward: (out (B, Tq, H, D), lse (B*H, Tq) f32).

    CPU tensors run :func:`flash_attention_reference`. CUDA tensors launch
    the kernel on the current stream; they must be float32 or bfloat16 with
    head dim 64 or 128, or this raises."""
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    _check_cuda(q, k, "flash_attention_fwd")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    q, k, v = _readable(q, k, v)
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    from . import _build
    lib = _build.load("flash_attention_fwd", _C_FUNCTIONS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mmlspark_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *_strides(q), *_strides(k), *_strides(v),
            B, H, Tq, Tk, D, int(bool(causal)),
            float(scale), _DTYPE_CODE[q.dtype], stream)
    _raise_on(rc, lib, "flash_attention_fwd")
    profiler.count_launch(flash_attention_fwd, library="flash_attention_fwd")
    profiler.note_kernel(*attention_costs(B, H, Tq, Tk, D, causal,
                                          q.element_size())["fwd"])
    return out, lse


#: kernel launches since the last reset (a run sets it to 0 and reads it)
flash_attention_fwd.launches = 0


def _check_bwd(q, k, v, out, lse, do):
    _check_qkv(q, k, v)
    B, Tq, H, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out and dO must be q's shape {tuple(q.shape)}; "
                         f"got {tuple(out.shape)}, {tuple(do.shape)}")
    if lse.shape != (B * H, Tq) or lse.dtype != _acc_dtype(q):
        raise ValueError(f"lse must be {_acc_dtype(q)} (B*H, Tq) = "
                         f"{(B * H, Tq)}; got {lse.dtype} {tuple(lse.shape)}")
    if not (q.device == out.device == lse.device == do.device):
        raise ValueError("q, out, lse and dO on different devices")


def _row_dot(do, out):
    """D = rowsum(dO * O) in float32, as (B*H, Tq): the JAX package takes it
    in XLA outside its kernels (pallas_kernels.py:282). The plain version's
    and the float32 kernels'; the bf16 dq kernel computes its own."""
    B, Tq, H, _ = do.shape
    acc = torch.promote_types(_acc_dtype(do), _acc_dtype(out))
    d = (do.to(acc) * out.to(acc)).sum(-1)               # (B, Tq, H)
    return d.transpose(1, 2).reshape(B * H, Tq).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal: bool = False,
                                  scale: Optional[float] = None):
    """Plain PyTorch flash-attention backward: (dq, dk, dv) in the input
    types. Materializes P from ``lse`` over the (Tq, Tk) scores (no autograd
    through the forward) — the kernels' yardstick for correctness, not for
    speed."""
    _check_bwd(q, k, v, out, lse, do)
    B, Tq, H, D = q.shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    acc = _acc_dtype(q)
    do = do.to(q.dtype)
    qb, kb, vb, dob = _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(do)
    s = _scores(qb, kb, causal, scale, acc)
    L = lse.to(acc)[..., None]
    p = torch.where(L <= NEG_INF / 2, 0.0, torch.exp(s - L))
    dp = torch.matmul(dob.to(acc), vb.to(acc).transpose(1, 2))
    ds = p * (dp - _row_dot(do, out).to(acc)[..., None])
    dv = torch.matmul(p.to(do.dtype).to(acc).transpose(1, 2), dob.to(acc))
    dq = torch.matmul(ds.to(k.dtype).to(acc), kb.to(acc)) * scale
    dk = torch.matmul(ds.to(q.dtype).to(acc).transpose(1, 2),
                      qb.to(acc)) * scale
    return (_from_bh(dq.to(q.dtype), B, H), _from_bh(dk.to(k.dtype), B, H),
            _from_bh(dv.to(v.dtype), B, H))


class _BwdLaunch:
    """One backward call's operands as the two kernels take them: the
    tensors (held here, so their memory outlives the launches), the packed
    C arguments, the outputs, and for bfloat16 the seven tensor maps,
    encoded once here for both launches. ``delta`` holds rowsum(dO * O):
    the bf16 dq kernel writes it and the dk/dv kernel reads it, so
    ``dq_kernel`` runs first; for float32 it is computed here."""

    def __init__(self, q, k, v, out, lse, do, causal, scale):
        B, Tq, H, D = q.shape
        Tk = k.shape[1]
        do = do.to(q.dtype)
        self.lse = lse.contiguous()
        # dO from autograd may be any view; it is packed only when unreadable
        self.q, self.k, self.v, self.do, self.out = _readable(q, k, v, do,
                                                              out)
        self.dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
        self.dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=q.device)
        self.dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=q.device)
        from . import _build
        self.lib = _build.load("flash_attention_bwd", _C_FUNCTIONS_BWD)
        self.device = q.device
        if q.dtype == torch.bfloat16:
            self.delta = torch.empty((B * H, Tq), dtype=torch.float32,
                                     device=q.device)
            self.maps = ctypes.create_string_buffer(_BWD_MAPS_BYTES)
            ops = (self.q, self.k, self.v, self.do, self.out)
            rc = self.lib.mmlspark_flash_attention_bwd_encode(
                self.maps, *(x.data_ptr() for x in ops),
                self.dk.data_ptr(), self.dv.data_ptr(),
                *(s for x in ops for s in _strides(x)), B, H, Tq, Tk, D)
            _raise_on(rc, self.lib, "flash_attention_bwd (tensor maps)")
        else:
            self.delta = _row_dot(self.do, self.out)
            self.maps = None
        self.ins = tuple(x.data_ptr() for x in (self.q, self.k, self.v,
                                                 self.do, self.lse,
                                                 self.delta))
        self.shape = (*_strides(self.q), *_strides(self.k),
                      *_strides(self.v), *_strides(self.do),
                      B, H, Tq, Tk, D, int(bool(causal)), float(scale),
                      _DTYPE_CODE[q.dtype])
        self.costs = attention_costs(B, H, Tq, Tk, D, causal,
                                     q.element_size())

    def _stream(self):
        return torch.cuda.current_stream(self.device).cuda_stream

    def dq_kernel(self):
        with torch.cuda.device(self.device):
            rc = self.lib.mmlspark_flash_attention_bwd_dq(
                self.maps, *self.ins, self.dq.data_ptr(), *self.shape,
                self._stream())
        _raise_on(rc, self.lib, "flash_attention_bwd (dq)")
        profiler.count_launch(flash_attention_bwd, "launches_dq",
                              "flash_attention_bwd")
        profiler.note_kernel(*self.costs["dq"])

    def dkv_kernel(self):
        with torch.cuda.device(self.device):
            rc = self.lib.mmlspark_flash_attention_bwd_dkv(
                self.maps, *self.ins, self.dk.data_ptr(), self.dv.data_ptr(),
                *self.shape, self._stream())
        _raise_on(rc, self.lib, "flash_attention_bwd (dk/dv)")
        profiler.count_launch(flash_attention_bwd, "launches_dkv",
                              "flash_attention_bwd")
        profiler.note_kernel(*self.costs["dkv"])


def _wgmma_tile_probe(a, b):
    """The bf16 backward's two new wgmma forms on one tile, for checking on
    the card: ``a`` and ``b`` contiguous (64, D) bfloat16 CUDA tensors (D 64
    or 128) -> (s = a b^T, (64, 64), and o = bf16(s) b, (64, D)), both
    float32: s as S = Q K^T reads Q and K, o as dQ += dS K reads K."""
    if a.shape != b.shape or a.shape[0] != TMA_BWD_ROWS \
            or a.shape[1] not in _HEAD_DIMS or a.dtype != torch.bfloat16 \
            or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the probe takes two contiguous (64, 64|128) bf16 "
                         "tensors")
    from . import _build
    lib = _build.load("flash_attention_bwd", _C_FUNCTIONS_BWD)
    D = a.shape[1]
    s = torch.empty((TMA_BWD_ROWS, TMA_BWD_ROWS), dtype=torch.float32,
                    device=a.device)
    o = torch.empty((TMA_BWD_ROWS, D), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = lib.mmlspark_wgmma_tile_probe(
            a.data_ptr(), b.data_ptr(), s.data_ptr(), o.data_ptr(), D,
            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, lib, "wgmma tile probe")
    return s, o


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        scale: Optional[float] = None):
    """Flash-attention backward: (dq (B, Tq, H, D), dk, dv (B, Tk, H, D)).

    ``out`` and ``lse`` are the forward's; ``do`` is the gradient of out,
    cast to q's type. CPU tensors run :func:`flash_attention_bwd_reference`.
    CUDA tensors launch the dq kernel, then the dk/dv kernel, on the current
    stream; the kinds of input the forward kernel refuses raise here too."""
    _check_bwd(q, k, v, out, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do,
                                             causal=causal, scale=scale)
    _check_cuda(q, k, "flash_attention_bwd")
    if out.dtype != q.dtype:
        raise ValueError(f"the CUDA kernels take out in q's dtype {q.dtype}, "
                         f"not {out.dtype}")
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    call = _BwdLaunch(q, k, v, out, lse, do, causal, scale)
    call.dq_kernel()
    call.dkv_kernel()
    return call.dq, call.dk, call.dv


#: launches of each backward kernel since the last reset
flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0


class _FlashAttention(torch.autograd.Function):
    """The kernels paired as forward and backward, as the JAX package pairs
    them with ``jax.custom_vjp``. Under a non-reentrant checkpoint the
    forward runs again during the backward, and the backward reads the
    recomputed ``out`` and ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.to(q.dtype),
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


@torch.library.custom_op(
    "mmlspark_torch::flash_attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float? scale) "
           "-> (Tensor, Tensor)")
def flash_attention_fwd_op(q, k, v, causal, scale):
    """The forward as a registered operator, so ``torch.export`` can trace
    a model through it (it cannot trace the ``ctypes`` launch): on CUDA
    tensors the kernel wrapper :func:`flash_attention_fwd` (which counts
    the launch), on CPU tensors :func:`flash_attention_reference`.
    Returns fresh ``(out, lse)``."""
    out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    return out.contiguous(), lse


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, causal, scale):
    B, Tq, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B * H, Tq), dtype=_acc_dtype(q)))


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """FlashAttention: q/k/v (B, T, H, D) -> (B, Tq, H, D), differentiable
    (the backward runs the dq and dk/dv kernels on CUDA tensors). Where no
    gradient is taken (inference, ``torch.export``, a CUDA graph capture)
    it calls the registered operator ``mmlspark_torch::flash_attention_fwd``;
    training keeps the autograd function and its two backward kernels."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return torch.ops.mmlspark_torch.flash_attention_fwd(q, k, v, causal,
                                                        scale)[0]

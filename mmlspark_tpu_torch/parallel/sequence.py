"""Single-device attention in plain PyTorch: the port of
``mmlspark_tpu/parallel/sequence.py``'s ``blockwise_attention`` (the
FlashAttention recurrence over key blocks, O(T) memory) and
``plain_attention`` (dense, for tests and tiny sequences).

Both keep the JAX layout (B, T, H, D), compute scores in float32 from
input-typed products, round P to the value type before the PV product, and
return q.dtype. The ring and Ulysses sequence-parallel forms wait for the
``parallel/`` slice (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _attend_block(q, k, v, qpos, kpos, causal: bool, scale: float,
                  kv_valid_below=None):
    """One (Q-resident, KV-block) step: (out_unnorm (B, Tq, H, D) f32,
    m (B, H, Tq), l (B, H, Tq))."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    if kv_valid_below is not None:
        scores = torch.where((kpos < kv_valid_below)[None, None, None, :],
                             scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(m[..., None] <= NEG_INF / 2, 0.0, p)  # all-masked row -> 0
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out, m, l


def _online_merge(acc, m_acc, l_acc, out, m, l):
    """Merge a block's (out, m, l) into the running (acc, m_acc, l_acc)."""
    m_new = torch.maximum(m_acc, m)
    corr_old = torch.where(m_acc <= NEG_INF / 2, 0.0, torch.exp(m_acc - m_new))
    corr_new = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
    l_new = l_acc * corr_old + l * corr_new
    acc_new = (acc * corr_old.transpose(1, 2)[..., None]
               + out * corr_new.transpose(1, 2)[..., None])
    return acc_new, m_new, l_new


def blockwise_attention(q, k, v, block_size: int = 512, causal: bool = False,
                        scale: Optional[float] = None):
    """Memory-efficient single-device attention: q/k/v (B, T, H, D), a loop
    over key blocks with an online softmax, so peak memory is
    O(B*H*Tq*block) instead of O(B*H*Tq*Tk)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    block_size = min(block_size, Tk)
    qpos = torch.arange(Tq, device=q.device)
    acc = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m_acc = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    for lo in range(0, Tk, block_size):
        # the last block may be short: its missing keys are the JAX
        # version's masked padding, which contributes exactly zero
        kpos = torch.arange(lo, min(lo + block_size, Tk), device=q.device)
        out, m, l = _attend_block(q, k[:, lo:lo + block_size],
                                  v[:, lo:lo + block_size], qpos, kpos,
                                  causal=causal, scale=scale)
        acc, m_acc, l_acc = _online_merge(acc, m_acc, l_acc, out, m, l)
    denom = l_acc.transpose(1, 2)[..., None]
    return (acc / denom.clamp_min(1e-30)).to(q.dtype)


def plain_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """Dense reference attention (for tests and tiny sequences)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        scores = torch.where((qpos >= kpos)[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)

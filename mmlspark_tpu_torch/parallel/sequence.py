"""Sequence / context parallelism in plain PyTorch: the port of
``mmlspark_tpu/parallel/sequence.py``.

* ``blockwise_attention`` — single-device memory-efficient attention (the
  FlashAttention recurrence over key blocks, O(T) memory), and
  ``plain_attention`` (dense, for tests and tiny sequences);
* ``ring_attention`` — context parallelism over a process group: Q/K/V
  are this rank's sequence shard; K/V shards rotate around the ring
  (``collectives.ring_shift``, the JAX ``ppermute`` pairs
  ``(i, (i - 1) % sp)``) while each rank folds every visiting block into
  its queries' online softmax, global positions keeping the causal mask
  exact; the resident block first, then ``sp - 1`` exchange-and-fold
  rounds;
* ``ulysses_attention`` — two ``all_to_all`` collectives re-shard
  (seq-sharded, all heads) -> (head-sharded, full sequence), run
  ``blockwise_attention`` per head group, and re-shard back; it needs
  ``H % sp == 0``;
* ``make_sp_attention`` — wraps either form into a plain ``(q, k, v) -> o``
  callable over a mesh's ``seq`` axis for ``build_model(attn_fn=...)``.

All forms keep the JAX layout (B, T, H, D), compute scores in float32 from
input-typed products, round P to the value type before the PV product,
and return q.dtype. The per-block attention is the JAX package's plain
einsum form (``_attend_block``): neither SP form launches the flash
kernel, as in the JAX package. Every collective is an autograd function
whose backward is its conjugate (``parallel/collectives.py``), so the SP
forms train.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import collectives as coll

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


def _finalize(acc, l):
    """acc (B, Tq, H, D) unnormalised, l (B, H, Tq) -> the output."""
    return acc / l.transpose(1, 2)[..., None].clamp_min(1e-30)


def _init_carry(q):
    B, Tq, H, D = q.shape
    return (torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device),
            torch.full((B, H, Tq), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device))


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
    acc, m_acc, l_acc = _init_carry(q)
    for lo in range(0, Tk, block_size):
        # the last block may be short: its missing keys are the JAX
        # version's masked padding, which contributes exactly zero
        kpos = torch.arange(lo, min(lo + block_size, Tk), device=q.device)
        out, m, l = _attend_block(q, k[:, lo:lo + block_size],
                                  v[:, lo:lo + block_size], qpos, kpos,
                                  causal=causal, scale=scale)
        acc, m_acc, l_acc = _online_merge(acc, m_acc, l_acc, out, m, l)
    return _finalize(acc, l_acc).to(q.dtype)


# --------------------------------------------------------------- ring

def ring_attention(q, k, v, axis_name, causal: bool = False,
                   scale: Optional[float] = None):
    """Context-parallel attention over the process group ``axis_name``.

    q/k/v are this rank's sequence shard (B, T/sp, H, D); shard ``s``
    holds global positions ``[s*T/sp, (s+1)*T/sp)``. The resident block
    is folded first, then ``sp - 1`` rounds each rotate (k, v) one step
    around the ring and fold the visiting block."""
    group = axis_name       # a process group; None is one rank
    sp = coll.group_size(group)
    idx = coll.group_rank(group)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    dev = q.device
    qpos = idx * Tq + torch.arange(Tq, device=dev)
    out, m, l = _attend_block(q, k, v, qpos,
                              idx * Tk + torch.arange(Tk, device=dev),
                              causal=causal, scale=scale)
    acc, m_acc, l_acc = _online_merge(*_init_carry(q), out, m, l)
    kv = torch.stack([k, v])
    for s in range(1, sp):
        # shard s holds block idx + s after s rotations (k and v travel
        # together: one exchange a round)
        kv = coll.ring_shift(kv, group, 1)
        src = (idx + s) % sp
        out, m, l = _attend_block(q, kv[0], kv[1], qpos,
                                  src * Tk + torch.arange(Tk, device=dev),
                                  causal=causal, scale=scale)
        acc, m_acc, l_acc = _online_merge(acc, m_acc, l_acc, out, m, l)
    return _finalize(acc, l_acc).to(q.dtype)


# --------------------------------------------------------------- ulysses

def ulysses_attention(q, k, v, axis_name, causal: bool = False,
                      scale: Optional[float] = None, block_size: int = 512):
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses form) over
    the process group ``axis_name``: sequence-sharded (B, T/sp, H, D)
    inputs with full heads re-shard to (B, T, H/sp, D), run
    ``blockwise_attention``, and re-shard back."""
    group = axis_name       # a process group; None is one rank
    sp = coll.group_size(group)
    H = q.shape[2]
    if H % sp != 0:
        raise ValueError(f"ulysses needs heads ({H}) divisible by sp ({sp})")

    def fwd(x):       # split heads, concatenate the sequence
        return coll.all_to_all(x, 2, 1, group)

    out = blockwise_attention(fwd(q), fwd(k), fwd(v), block_size=block_size,
                              causal=causal, scale=scale)
    return coll.all_to_all(out, 1, 2, group)


# --------------------------------------------------------------- wrapper

def make_sp_attention(mesh, axis_name: str = "seq", mode: str = "ring",
                      causal: bool = False,
                      batch_axis: Optional[str] = "data"):
    """A plain ``(q, k, v) -> o`` attention callable, sequence-parallel over
    ``mesh``'s ``axis_name`` group.

    Inputs and outputs are this data rank's whole sequences (B, T, H, D),
    replicated over the ``seq`` group (the rows of a data slice are
    gathered over the inner group before the step, and every op but
    attention runs replicated): each rank takes its sequence chunk
    (``own_chunk``: the backward all-gathers the chunk gradients), runs the
    SP form, and all-gathers the output chunks (``gather``: the backward
    keeps this chunk's gradient). So every replicated parameter's gradient
    is identical on every rank of the group. The batch is already this
    data rank's (``batch_axis`` needs no further split)."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis_name!r}")
    if mode == "ring":
        local = ring_attention
    elif mode == "ulysses":
        local = ulysses_attention
    else:
        raise ValueError(f"unknown sp mode {mode!r} (ring|ulysses)")
    group = mesh.group(axis_name)

    def attn(q, k, v):
        qs, ks, vs = (coll.own_chunk(t, 1, group) for t in (q, k, v))
        return coll.gather(local(qs, ks, vs, group, causal=causal), 1, group)
    return attn


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

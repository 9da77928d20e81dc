"""Mixture-of-Experts FFN with expert parallelism (the port of
``mmlspark_tpu/models/moe.py``).

Token-choice top-k routing with a static capacity bound, the JAX package's
math: an f32 softmax over the gate logits, the top ``k`` experts with ties
to the lower index (``lax.top_k``; here a stable descending sort),
renormalised; capacity ``C = max(1, int(cf * S * k / E))``; slot-major
priority, so every token's first choice is placed before any second
choice, in token order within a slot; rows of ``row_mask`` 0 claim no
capacity and stay out of the Switch aux loss; expert matmuls in ``dtype``;
``gelu`` in flax's tanh form. Overflowing tokens are dropped (combine
weight 0; the residual carries them).

**Dispatch by index.** The JAX body builds dense (S, E, C) one-hot
dispatch and combine tensors and two selection einsums over them. The port
computes the same slot positions with the same cumsum over the (S, E)
one-hots, then gathers each kept token's row into its (expert, slot) of an
(E, Cb, d) buffer (``Cb = min(C, S)``: no expert can hold more than S
tokens; one ``index_copy`` a choice), an empty slot reading zeros, and
combines as
``sum_j gate_j * out[e_j, pos_j]`` over kept choices in f32 (the gate
rounded to ``dtype`` first, as the JAX combine tensor is), then casts. The
dispatch is a pure selection, so ``xin`` equals the einsum's bit for bit;
no (S, E, C) tensor is ever built, and nothing reads the device from the
host, so CUDA graphs capture the block. :func:`moe_one_hot` is the dense
form, kept as the plain version for tests and the chip gate.

**Distributed.** Under the JAX package's SPMD the block sees the GLOBAL
batch. With the batch split over a ``data`` group, ``C`` takes the global
token count, and each rank's positions are offset, slot by slot, by the
tokens of lower data ranks (one all-gather of the (k, E) per-choice counts;
every rank's first choices still come before any rank's second), and the
aux loss's sums are all-reduced; so the routing, drops included, is the
one-process routing. With an ``expert`` group (EP) the expert stacks hold
this rank's ``E / ep`` experts: routing is computed identically on every
rank of the group (the batch is replicated over it) and only the expert
compute splits, its outputs all-gathered before the combine.

The aux loss has no flax ``sow``: a caller passes a list as ``aux`` and
each block appends its value (per call; never module state, since fits
run on threads). :func:`read_moe_aux_loss` sums it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives as coll


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot without ``F.one_hot``'s host-side range check (a device
    sync, which a CUDA graph capture refuses)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(capacity_factor: float, S: int, k: int, E: int) -> int:
    return max(1, int(capacity_factor * S * k / E))


def _route(xf, gate_w, k: int, tok_w, C: int, data_group, want_aux: bool):
    """The routing shared by both dispatch forms: ``(probs, gate_vals, sel,
    keeps, slots, aux)`` where ``keeps[j]``/``slots[j]`` are (S, E): choice
    j's kept one-hots and each token's slot in this rank's buffer (the
    global position on one rank)."""
    S = xf.shape[0]
    E = gate_w.shape[1]
    logits = xf.float() @ gate_w
    probs = torch.softmax(logits, dim=-1)                 # (S, E) f32
    gate_vals, sel = top_k(probs, k)                      # (S, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)            # renormalise
    aux = None
    if want_aux:
        # Switch aux loss: E * sum_e fraction_routed_e * mean_prob_e over
        # VALID tokens (fraction from the top-1 choices)
        denom = tok_w.sum()
        frac = (_one_hot(sel[:, 0], E) * tok_w[:, None]).sum(0)
        mprob = (probs * tok_w[:, None]).sum(0)
        if data_group is not None:
            stats = torch.cat([denom[None], frac])
            torch.distributed.all_reduce(stats, group=data_group)
            denom, frac = stats[0], stats[1:]
            mprob = coll.reduce_replicated(mprob, data_group)
        denom = torch.clamp_min(denom, 1.0)
        aux = E * torch.sum((frac / denom) * (mprob / denom))
    # the one-hots are built expert-major, (E, S), so each cumsum runs
    # along the innermost dim (a scan down 32k rows of 4 columns took 2.8
    # ms on an H100); the counts are exact integers in f32, so the order
    # changes no bit
    valid = (tok_w > 0).float()[None, :]
    ohs = [_one_hot(sel[:, j], E).t() * valid for j in range(k)]  # (E, S)
    cnt = torch.stack([oh.sum(1) for oh in ohs])                  # (k, E)
    if data_group is not None:
        counts = coll.all_gather_dim(cnt[None], 0, data_group)  # (R, k, E)
        r = coll.group_rank(data_group)
        before = counts[:r].sum(0)
        total = counts.sum(0)
    else:
        before = torch.zeros_like(cnt)
        total = cnt
    counts_g = torch.zeros(E, 1, device=xf.device)
    counts_l = torch.zeros(E, 1, device=xf.device)
    keeps, slots = [], []
    for j, oh in enumerate(ohs):                       # k static, tiny
        cs = torch.cumsum(oh, dim=1) - oh
        pos = counts_g + before[j][:, None] + cs       # global position
        keep = oh * (pos < C)
        keeps.append(keep.t())                         # (S, E) views
        slots.append((counts_l + cs).t())              # this rank's slot
        counts_l = counts_l + keep.sum(1, keepdim=True)
        counts_g = counts_g + torch.clamp(C - counts_g, min=0.0,
                                          max=None).minimum(total[j][:, None])
    return probs, gate_vals, sel, keeps, slots, aux


def _token_weights(row_mask, B: int, T: int, dev):
    """(B*T,) float32 token weights: each row's mask over its T tokens
    (all ones without a mask)."""
    if row_mask is None:
        return torch.ones(B * T, device=dev)
    return row_mask.float()[:, None].expand(B, T).reshape(B * T)


def _experts(xin, w1, b1, w2, b2, dt):
    h = torch.bmm(xin, w1.to(dt)) + b1[:, None, :].to(dt)
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, w2.to(dt)) + b2[:, None, :].to(dt)


class MoEMLP(nn.Module):
    """Capacity-bounded top-k MoE feed-forward block: (B, T, d) -> (B, T, d).

    Params in the flax layout: ``gate`` (d, E), ``expert_w1`` (E, d, h),
    ``expert_b1`` (E, h), ``expert_w2`` (E, h, d), ``expert_b2`` (E, d),
    all float32. ``d_model`` is flax's inferred input width. Set
    ``data_group`` (global capacity over a split batch) and
    ``expert_group`` (EP: the expert stacks hold this rank's experts)
    for a distributed run; both None is the one-device block."""

    def __init__(self, num_experts: int, d_hidden: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16, *, d_model: int):
        super().__init__()
        E, d, h = num_experts, d_model, d_hidden
        self.num_experts = E
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.gate = nn.Parameter(torch.zeros(d, E))
        self.expert_w1 = nn.Parameter(torch.zeros(E, d, h))
        self.expert_b1 = nn.Parameter(torch.zeros(E, h))
        self.expert_w2 = nn.Parameter(torch.zeros(E, h, d))
        self.expert_b2 = nn.Parameter(torch.zeros(E, d))
        self.data_group = None
        self.expert_group = None

    def forward(self, x, row_mask=None, aux: Optional[list] = None):
        """row_mask: optional (B,) weights; 0-rows (padding) neither claim
        expert capacity nor count in the balancing statistics. ``aux``: a
        list the block appends its aux loss to."""
        B, T, d = x.shape
        dt = self.dtype
        eg = self.expert_group
        xin, lins, kept, gate_vals, a = self.dispatch(x, row_mask,
                                                      aux is not None)
        if aux is not None:
            aux.append(a)
        E, Cb = xin.shape[:2]
        if eg is not None:                    # this rank's experts only
            el = E // coll.group_size(eg)
            xin = xin.narrow(0, coll.group_rank(eg) * el, el)
        out = _experts(xin, self.expert_w1, self.expert_b1, self.expert_w2,
                       self.expert_b2, dt)
        out = coll.gather(out, 0, eg)                       # (E, Cb, d)
        # a dropped pair reads its token's zero row past the buffer
        flat = torch.cat([out.reshape(E * Cb, d), out.new_zeros(B * T, d)])
        y = torch.zeros(B * T, d, device=x.device)
        for lin, keep, g in zip(lins, kept, gate_vals.unbind(1)):
            w = (g * keep).to(dt).float()
            y = y + w[:, None] * flat.index_select(0, lin).float()
        return y.to(dt).reshape(B, T, d).to(x.dtype)

    def dispatch(self, x, row_mask=None, want_aux: bool = False):
        """The routing and the index dispatch: ``(xin, lins, kept,
        gate_vals, aux)`` — the (E, Cb, d) expert buffer (every expert),
        and for each choice j the (S,) buffer row of each token (its own
        row past the (E * Cb) buffer where it was not kept), its kept
        flag, and the renormalised gate values (S, k)."""
        B, T, d = x.shape
        S = B * T
        E = self.num_experts
        k = min(self.top_k, E)
        dg, eg = self.data_group, self.expert_group
        C = capacity(self.capacity_factor, S * coll.group_size(dg), k, E)
        Cb = min(C, S)
        xf = x.reshape(S, d)
        tok_w = _token_weights(row_mask, B, T, x.device)
        _, gate_vals, sel, keeps, slots, a = _route(
            xf, self.gate, k, tok_w, C, dg, want_aux)
        # each kept (token, choice) -> its row of the (E * Cb) buffer; a
        # dropped one -> its token's own row past the end, so no row is
        # written twice by one copy (and no gradient row sums thousands of
        # duplicates: an index backward serialises those)
        trash = E * Cb
        tok_ids = torch.arange(S, device=x.device)
        lins, kept = [], []
        for j in range(k):
            e = sel[:, j]
            keep = keeps[j].gather(1, e[:, None])[:, 0]
            pos = slots[j].gather(1, e[:, None])[:, 0]
            kept.append(keep)
            lins.append(torch.where(keep > 0, e * Cb + pos.long(),
                                    trash + tok_ids))
        # EP: every rank routes alike; the input's gradient sums the
        # experts' shares over the expert group
        xsrc = coll.copy_in(xf.to(self.dtype), eg)
        buf = xsrc.new_zeros(trash + S, d)
        for lin in lins:
            buf = buf.index_copy(0, lin, xsrc)
        xin = buf[:trash].view(E, Cb, d)
        return xin, lins, kept, gate_vals, a


def moe_one_hot(module: MoEMLP, x, row_mask=None, return_xin: bool = False):
    """The plain version: the JAX body as written, with dense (S, E, C)
    dispatch and combine tensors and the selection einsums (one device, no
    groups). Returns ``(y, aux)``, or ``(y, aux, xin)``."""
    B, T, d = x.shape
    S = B * T
    E = module.num_experts
    k = min(module.top_k, E)
    dt = module.dtype
    C = capacity(module.capacity_factor, S, k, E)
    xf = x.reshape(S, d)
    tok_w = _token_weights(row_mask, B, T, x.device)
    _, gate_vals, sel, keeps, slots, aux = _route(xf, module.gate, k, tok_w,
                                                  C, None, True)
    # the JAX accumulation, in place (the same 0/1 and gate values)
    dispatch = torch.zeros(S, E, C, device=x.device)
    combine = torch.zeros(S, E, C, device=x.device)
    for j in range(k):
        slot = _one_hot(slots[j].long(), C)                  # (S, E, C)
        slot.mul_(keeps[j][..., None])
        dispatch.add_(slot)
        combine.add_(slot.mul_(gate_vals[:, j][:, None, None]))
        del slot
    xin = torch.einsum("sec,sd->ecd", dispatch.to(dt), xf.to(dt))
    out = _experts(xin, module.expert_w1, module.expert_b1,
                   module.expert_w2, module.expert_b2, dt)
    y = torch.einsum("sec,ecd->sd", combine.to(dt), out)
    y = y.reshape(B, T, d).to(x.dtype)
    return (y, aux, xin) if return_xin else (y, aux)


def read_moe_aux_loss(aux: list) -> torch.Tensor:
    """Sum the aux losses a forward appended to its ``aux`` list."""
    total = torch.zeros((), dtype=torch.float32)
    for a in aux:
        total = total.to(a.device) + a.float()
    return total

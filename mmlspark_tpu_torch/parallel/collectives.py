"""Differentiable collectives: each ``torch.distributed`` call on a training
path wrapped in an ``autograd.Function`` whose backward is its conjugate.

XLA derives these pairs from the shardings in the JAX package; the port
issues them by hand. Every op takes a process group and returns its input
unchanged (no collective at all) when the group is None, so a module built
for one device runs the plain path.

=====================  ==============================  =====================
op                     forward                         backward
=====================  ==============================  =====================
``gather``             all-gather chunks along a dim   own chunk of the grad
``own_chunk``          own chunk of a replicated value all-gather the grads
``copy_in``            identity                        all-reduce (sum)
``reduce_replicated``  all-reduce (sum)                identity
``ring_shift``         send to rank-1, recv from +1    send to +1, recv -1
``all_to_all``         split a dim, concat another     the inverse all_to_all
=====================  ==============================  =====================

``gather`` and ``reduce_replicated`` produce a value replicated over the
group whose downstream compute (and so its gradient) is identical on every
rank; ``copy_in`` marks where a replicated value enters work that differs
by rank (a column shard of a matmul), so the partial gradients sum.
``torch.distributed.nn.functional.all_gather`` is not used: its backward
sums over the group, which multiplies a replicated gradient by the group
size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Plain (non-differentiable) all-gather of equal chunks along ``dim``,
    in group-rank order."""
    n = group_size(group)
    if n == 1 and group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    per = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * per, per).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class _OwnChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to group rank ``r - step`` and receive from ``r + step``
    (mod the group size), as one batched exchange."""
    n = group_size(group)
    r = group_rank(group)
    dst = dist.get_global_rank(group, (r - step) % n)
    src = dist.get_global_rank(group, (r + step) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.step), None, None


def _a2a(x: torch.Tensor, split_dim: int, concat_dim: int, group):
    n = group_size(group)
    # chunks of split_dim go to the ranks in order; all_to_all_single
    # exchanges along dim 0, so move split_dim there first
    xs = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    # out dim 0 now holds n received chunks (rank order) of the split dim
    parts = out.chunk(n, dim=0)
    parts = [p.movedim(0, split_dim) for p in parts]
    return torch.cat(parts, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.args = (split_dim, concat_dim, group)
        return _a2a(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group = ctx.args
        return _a2a(g, concat_dim, split_dim, group), None, None, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather equal chunks along ``dim`` into a value replicated over
    ``group``; backward keeps this rank's chunk of the gradient."""
    if group is None:
        return x
    return _Gather.apply(x, dim, group)


def own_chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk (along ``dim``) of a value replicated over
    ``group``; backward all-gathers the chunk gradients."""
    if group is None:
        return x
    return _OwnChunk.apply(x, dim, group)


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward all-reduces (sums) the gradient."""
    if group is None:
        return x
    return _CopyIn.apply(x, group)


def reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) into a value replicated over ``group``; backward
    passes the (replicated) gradient through to each rank's addend."""
    if group is None:
        return x
    return _ReduceReplicated.apply(x, group)


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Rotate around the ring: send to group rank ``r - step``, receive
    from ``r + step`` (the JAX ``ppermute`` pairs ``(i, (i - step) % n)``);
    backward sends the gradient the other way."""
    if group is None:
        return x
    return _RingShift.apply(x, group, step)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: split ``split_dim`` into group-size
    chunks, send chunk j to rank j, concatenate the received chunks along
    ``concat_dim`` in rank order; backward is the inverse all_to_all."""
    if group is None:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)

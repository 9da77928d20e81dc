"""Pipeline parallelism: GPipe-style microbatch pipelining over a mesh's
``pipe`` axis (the port of ``mmlspark_tpu/parallel/pipeline_parallel.py``).

The JAX package writes the pipeline as one ``shard_map``ed ``lax.scan`` over
``n_microbatches + n_stages - 1`` ticks and lets ``jax.grad`` transpose it.
The port runs the same tick schedule eagerly, rank ``s`` holding stage
``s``: at tick ``t`` it runs microbatch ``t - s`` (stage 0 injects it) and
the activations hop one stage forward around the ring
(``collectives`` send to ``s + 1``). Ticks where a stage has no
microbatch (the bubble) send zeros instead of computing: in the JAX
schedule their values never reach an output. The last stage collects the
outputs, and an all-reduce over the pipe group (the masked ``psum``)
replicates them.

Eager autograd cannot transpose that schedule: a stage whose received
activation goes unused (stage 0's) would skip its share of the backward
exchange and its peers would wait forever. So the whole pipeline is one
``autograd.Function`` with a hand-written backward over the same ticks in
reverse: at each, the stages pass the activation gradient one stage back
and re-run their stage forward on the saved input to take its gradient
(the stage recomputes its forward once, as ``nn.remat`` would). Every rank
makes the same exchanges in the same order.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .collectives import _shift


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    return next(it)


def stack_stage_params(stage_params: list):
    """Stack per-stage param trees (identical structure) along a new
    leading axis — the axis the ``pipe`` mesh dimension splits."""
    return _tree_map(lambda *xs: torch.stack(xs), *stage_params)


def shard_pipeline_params(stacked, mesh, axis_name: str = "pipe"):
    """THIS rank's stage slice (leading axis 1) of stacked stage params, on
    the mesh's device."""
    s = mesh.axis_index(axis_name)
    return _tree_map(lambda a: a[s:s + 1].to(mesh.device), stacked)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, group, n_stages, s, M, x, *params):
        mb = x.shape[0] // M
        xm = x.reshape(M, mb, *x.shape[1:])
        ticks = M + n_stages - 1
        last = n_stages - 1
        state = torch.zeros_like(xm[0])
        outbuf = torch.zeros_like(xm)
        saved = [None] * M
        for t in range(ticks):
            m = t - s
            if 0 <= m < M:
                h_in = xm[m] if s == 0 else state
                saved[m] = h_in
                y = run(list(params), h_in)
                if s == last:
                    outbuf[m] = y.to(outbuf.dtype)
            else:
                y = torch.zeros_like(state)
            if t < ticks - 1 and n_stages > 1:
                # every stage sends to s + 1 and receives from s - 1
                state = _shift(y.to(state.dtype), group, -1)
        if group is not None:
            dist.all_reduce(outbuf, group=group)   # the masked psum
        ctx.run, ctx.group, ctx.n_stages, ctx.s, ctx.M = \
            run, group, n_stages, s, M
        ctx.saved = saved
        ctx.save_for_backward(*params)
        ctx.x_shape = x.shape
        return outbuf.reshape(x.shape)

    @staticmethod
    def backward(ctx, g_out):
        run, group, n_stages, s, M = (ctx.run, ctx.group, ctx.n_stages,
                                      ctx.s, ctx.M)
        params = ctx.saved_tensors
        last = n_stages - 1
        g = g_out.reshape(M, -1, *g_out.shape[1:])
        g_x = torch.zeros_like(g)
        g_params = [torch.zeros_like(p) for p in params]
        zero = torch.zeros_like(g[0])
        g_next = zero          # d loss / d (this stage's input at tick t+1)
        ticks = M + n_stages - 1
        for t in reversed(range(ticks)):
            if t < ticks - 1 and n_stages > 1:
                # stage s+1's input gradient of tick t+1 is this stage's
                # output gradient of tick t: send to s - 1, receive from s + 1
                recv = _shift(g_next.contiguous(), group, 1)
            else:
                recv = zero
            m = t - s
            if not 0 <= m < M:
                g_next = zero
                continue
            g_y = g[m] if s == last else recv
            with torch.enable_grad():
                h = ctx.saved[m].detach().requires_grad_(True)
                leaves = [p.detach().requires_grad_(True) for p in params]
                y = run(leaves, h)
                grads = torch.autograd.grad(y, [h] + leaves,
                                            g_y.to(y.dtype),
                                            allow_unused=True)
            for acc, gp in zip(g_params, grads[1:]):
                if gp is not None:
                    acc += gp
            if s == 0:
                g_x[m] = grads[0].to(g_x.dtype)
                g_next = zero
            else:
                g_next = grads[0].to(zero.dtype)
        ctx.saved = None
        return (None, None, None, None, None,
                g_x.reshape(ctx.x_shape), *g_params)


def pipeline_run(run: Callable, params: list, x, group, n_stages: int,
                 stage: int, n_microbatches: int):
    """The tick schedule over one rank's stage: ``run(params, h) -> h'``
    is stage ``stage``'s forward over the tensors ``params`` (the ones the
    backward returns gradients for); ``x`` (N, ...) is the pipeline input,
    replicated over the pipe group. Returns the output (N, ...),
    replicated."""
    N = x.shape[0]
    M = n_microbatches
    if N % M != 0:
        raise ValueError(f"batch {N} not divisible by n_microbatches {M}")
    if group is None or n_stages == 1:
        mb = N // M
        return torch.cat([run(params, x[m * mb:(m + 1) * mb])
                          for m in range(M)]).to(x.dtype)
    return _Pipeline.apply(run, group, n_stages, stage, M, x, *params)


def pipeline_apply(stage_fn: Callable, stacked_params, x, mesh,
                   axis_name: str = "pipe", n_microbatches: int = None,
                   batch_axis: str = None):
    """Run ``n_stages`` chained applications of ``stage_fn`` as a pipeline.

    stage_fn(params_i, h) -> h'   one stage; h and h' share a shape.
    stacked_params: a tree with leading axis n_stages (= the mesh's
      ``axis_name`` size), or this rank's slice of it (leading axis 1,
      ``shard_pipeline_params``).
    x: this data rank's batch (N, ...), split into ``n_microbatches``
      (default n_stages) equal microbatches; ``batch_axis`` needs no split
      here (the rows are already this data rank's).

    Returns f(x) (N, ...), equal to applying every stage in turn,
    replicated over the pipe group."""
    n_stages = mesh.axis_size(axis_name)
    M = n_microbatches or n_stages
    s = mesh.axis_index(axis_name)
    lead = _leaves(stacked_params)[0].shape[0]
    local = _tree_map(lambda a: a[s] if lead == n_stages else a[0],
                      stacked_params)
    flat = _leaves(local)

    def run(leaves, h):
        return stage_fn(_unflatten(local, iter(leaves)), h)

    return pipeline_run(run, flat, x, mesh.group(axis_name), n_stages, s, M)


def transformer_pp_forward(cfg: dict, params: dict, tokens, mesh,
                           n_microbatches: Optional[int] = None,
                           axis_name: str = "pipe",
                           batch_axis: str = "data", module=None):
    """Forward pass of the transformer family with its encoder-block stack
    run as a GPipe pipeline over the ``pipe`` axis: how
    ``TorchLearner.setPipelineParallel(k)`` trains. The embedding and the
    head run replicated over the pipe group, the L blocks split into k
    stages of L/k (rank s runs blocks ``[s*L/k, (s+1)*L/k)``), and the
    microbatch activations hop stage to stage. ``params`` is the port's
    whole state_dict (every rank holds all of it, as the JAX package
    replicates the tree); ``module`` (a transformer built from ``cfg``,
    meta is fine) saves building one. Returns float32 logits."""
    from ..models.modules import build_model
    from ..models.trainer import _bind
    if module is None:
        with torch.device("meta"):
            module = build_model(cfg)
    _bind(module, params)
    L, pp = module.layers, mesh.axis_size(axis_name)
    if L % pp != 0:
        raise ValueError(f"layers ({L}) must divide by the pipe axis ({pp})")
    k = L // pp
    s = mesh.axis_index(axis_name)
    lo = s * k
    names = [f"blocks.{i}.{n}" for i in range(lo, lo + k)
             for n, _ in module.blocks[i].named_parameters()]
    blocks = [module.blocks[i] for i in range(lo, lo + k)]

    def run(leaves, h):
        _bind(module, dict(zip(names, leaves)))
        for blk in blocks:
            h = blk(h)
        return h

    h = module.embed(tokens)
    h = pipeline_run(run, [params[n] for n in names], h,
                     mesh.group(axis_name), pp, s, n_microbatches or pp)
    return module.head_out(h)

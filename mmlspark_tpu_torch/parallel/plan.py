"""How one fit or transform spreads over the ranks: the port's counterpart
of the placement the JAX trainer hands XLA (``trainer.py``'s
``_place_params`` and the batch sharding), made explicit.

A :class:`ParallelPlan` holds the mesh, the axis groups and each
parameter's partition spec (``mesh.TP_PARAM_RULES`` for ``tensorParallel``,
``mesh.EP_PARAM_RULES`` for ``expertParallel``, matched against the flax
paths). Its parts:

* **rows**: each rank passes its own shard and contributes
  ``bs_global // world`` rows a step; the members of one inner block
  (tp/sp/ep/pp) all-gather their rows into their data slice, so the global
  batch, in rank order, is the batch the JAX package's ``P("data")``
  splits (:meth:`rows`).
* **module**: Dense layers whose kernel splits get the ``model`` group
  (column-parallel, ``modules.Dense``), MoE blocks the ``data`` group
  (global capacity) and the ``expert`` group (:meth:`configure`); SP's
  attention comes through ``build_model(attn_fn=...)``.
* **gradients**: summed over the ``data`` group in one flat all-reduce,
  after the pipe group's for the parameters only one stage touches (PP);
  the loss is the local weighted sum over the GLOBAL weight denominator
  (``trainer.py``'s weighted mean), so the sum is the global gradient
  (:meth:`sync_grads`, :meth:`denominator`). Replicated parameters get the
  same bits on every rank of their inner block; the global gradient norm
  and the bf16_mixed finiteness flag add the shards' parts.
* **state**: shards from the whole tree (:meth:`shard`) and the whole tree
  back from the shards (:meth:`gather`), which ``getModelParams()`` and
  the checkpoints read.

A world of one rank is a world: every collective still runs (NCCL on a
card), and the results equal the no-group path's bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import collectives as coll
from . import mesh as meshlib

# parameters that run after the pipeline (replicated compute on every
# stage): their gradients are already whole on each rank of the pipe group
_POST_PIPE = ("ln_f.", "head.")


class ParallelPlan:
    """The collective side of one fit or transform over ``mesh``.

    ``cfg`` is the model config, ``params`` a whole state_dict (its shapes
    decide which leaves divide), ``tp``/``ep``/``pp`` the axis sizes
    (``seq`` only changes the attention: ``make_sp_attention``, which the
    module gets through ``build_model(attn_fn=...)``)."""

    def __init__(self, mesh, cfg: dict, params: dict, tp: int = 1,
                 ep: int = 1, pp: int = 1):
        self.mesh = mesh
        self.device = mesh.device
        self.data_group = mesh.group("data")
        self.inner_group = mesh.inner_group()
        self.model_group = mesh.group("model") if tp > 1 else None
        self.expert_group = mesh.group("expert") if ep > 1 else None
        self.pipe_group = mesh.group("pipe") if pp > 1 else None
        rules = []
        if ep > 1:
            rules += list(meshlib.EP_PARAM_RULES)
        if tp > 1:
            rules += list(meshlib.TP_PARAM_RULES)
        specs = (meshlib.param_specs(params, mesh, rules, config=cfg)
                 if rules else {})
        # key -> (dim, axis) of every split leaf
        self.split = {}
        for k, spec in specs.items():
            for dim, axis in enumerate(spec):
                if axis is not None:
                    self.split[k] = (dim, axis)

    # ---- state ----
    def shard(self, tree):
        """This rank's slice of every split leaf of a whole state_dict (or
        a nest of them: an optimizer state), on the plan's device."""
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k in self.split and isinstance(v, torch.Tensor):
                    dim, axis = self.split[k]
                    n = self.mesh.axis_size(axis)
                    per = v.shape[dim] // n
                    v = v.narrow(dim, self.mesh.axis_index(axis) * per, per)
                    out[k] = v.contiguous().to(self.device)
                else:
                    out[k] = self.shard(v)
            return out
        if isinstance(tree, torch.Tensor):
            return tree.to(self.device)
        return tree

    def gather(self, tree):
        """The whole tree from the shards (a collective: every rank calls
        it at the same point); unsplit leaves pass through."""
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k in self.split and isinstance(v, torch.Tensor):
                    dim, axis = self.split[k]
                    out[k] = coll.all_gather_dim(v.detach(), dim,
                                                 self.mesh.group(axis))
                else:
                    out[k] = self.gather(v)
            return out
        return tree

    # ---- module ----
    def configure(self, module):
        """Point the module's layers at their groups: split Dense layers at
        the ``model`` group, MoE blocks at the ``data`` and ``expert``
        groups. Returns the module."""
        from ..models.modules import Dense
        from ..models.moe import MoEMLP
        for name, mod in module.named_modules():
            if isinstance(mod, Dense):
                split = f"{name}.weight" in self.split
                mod.tp_group = self.model_group if split else None
            elif isinstance(mod, MoEMLP):
                mod.data_group = self.data_group
                mod.expert_group = self.expert_group
        return module

    def shard_module(self, module):
        """Cut a module holding the whole weights down to this rank's
        shards (in place) and configure it: the serving side of TP."""
        for name, p in list(module.named_parameters()):
            if name in self.split:
                owner, _, attr = name.rpartition(".")
                sub = module.get_submodule(owner)
                local = self.shard({name: p.detach()})[name]
                setattr(sub, attr, torch.nn.Parameter(
                    local, requires_grad=p.requires_grad))
        return self.configure(module)

    # ---- batch ----
    def rows(self, *tensors):
        """Gather the inner block's rows into this data slice (rank order);
        with no inner block, the tensors as they are."""
        g = self.inner_group
        if g is None:
            return tensors
        return tuple(coll.all_gather_dim(t, 0, g) for t in tensors)

    def own_rows(self, t, n: int):
        """This rank's ``n`` rows of a data-slice output (inverse of
        :meth:`rows` for ``n`` rows a rank)."""
        if self.inner_group is None:
            return t
        r = coll.group_rank(self.inner_group)
        return t[r * n:(r + 1) * n]

    # ---- loss and gradients ----
    def denominator(self, wb):
        """The global weight sum (every data rank's slice)."""
        d = torch.sum(wb).reshape(1)
        dist.all_reduce(d, group=self.data_group)
        return d[0]

    def reduce_loss(self, main, aux=None):
        """The global loss: the data ranks' weighted-sum parts added, plus
        the (replicated) MoE aux term once."""
        total = main.detach().float().reshape(1).clone()
        dist.all_reduce(total, group=self.data_group)
        total = total[0]
        return total if aux is None else total + aux.detach()

    def _all_reduce_flat(self, grads: dict, keys, group):
        if not keys:
            return
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, group=group)
        off = 0
        for k in keys:
            n = grads[k].numel()
            grads[k] = flat[off:off + n].view_as(grads[k])
            off += n

    def sync_grads(self, grads: dict) -> dict:
        grads = dict(grads)
        if self.pipe_group is not None:
            self._all_reduce_flat(
                grads, [k for k in grads if not k.startswith(_POST_PIPE)],
                self.pipe_group)
        by_dtype: dict = {}
        for k, g in grads.items():
            by_dtype.setdefault(g.dtype, []).append(k)
        for keys in by_dtype.values():
            self._all_reduce_flat(grads, keys, self.data_group)
        return grads

    def sq_norm(self, grads: dict):
        """The squared global L2 norm: a split leaf's square sum is added
        over its axis group (no split leaves: the one-device sum, in the
        same order)."""
        if not self.split:
            return sum(torch.sum(torch.square(g)) for g in grads.values())
        rep = [k for k in grads if k not in self.split]
        total = sum(torch.sum(torch.square(grads[k])) for k in rep)
        for axis in sorted({a for _, a in self.split.values()}):
            part = sum(torch.sum(torch.square(grads[k]))
                       for k, (_, a) in self.split.items()
                       if a == axis and k in grads).reshape(1)
            dist.all_reduce(part, group=self.mesh.group(axis))
            total = total + part[0]
        return total

    def all_finite(self, finite):
        """A finiteness flag every rank agrees on (the shards may differ)."""
        if not self.split:
            return finite
        f = finite.to(torch.int32).reshape(1)
        dist.all_reduce(f, op=dist.ReduceOp.MIN, group=self.inner_group)
        return f[0] > 0

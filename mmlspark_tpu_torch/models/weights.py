"""Weights carried across from the JAX package.

:func:`from_flax_params` turns a flax param tree (as numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, variables)``) of any ``build_model``
family into the port's ``state_dict``, so both packages run on the same
weights; :func:`to_flax_params` is its inverse (the zoo's artifacts hold
flax trees). Both read one map, :func:`flax_map`: for each state_dict entry,
the flax paths it is made of and how.

* ``Dense.kernel`` is (in, out) and ``nn.Linear.weight`` (out, in):
  transposed. The transformer's qkv kernel needs nothing more: both
  packages view its output as (B, T, 3H, D) and split heads in thirds.
* ``Conv.kernel`` is HWIO and a torch conv weight OIHW.
* flax's ``LSTMCell`` holds one (in, H) kernel per gate, ``ii if ig io``
  unbiased and ``hi hf hg ho`` biased; torch packs the gates (i, f, g, o)
  into ``weight_ih`` (4H, E) and ``weight_hh`` (4H, H) with two biases:
  the hidden biases become ``bias_hh`` and ``bias_ih`` is zero. The
  forward cell is ``LSTMCell_0``, the backward ``LSTMCell_1`` (torch's
  ``_reverse`` weights).
* GroupNorm's and ``_FrozenAffine``'s ``scale`` is the port's ``weight``.

The transformer, for each block ``i``:

    params/Embed_0/embedding (V, d)          -> tok_embed.weight
    params/Embed_1/embedding (max_len, d)    -> pos_embed.weight
    params/block{i}/LayerNorm_0/{scale,bias} -> blocks.{i}.ln1.{weight,bias}
    params/block{i}/Dense_0/kernel (d, 3d)   -> blocks.{i}.qkv.weight (3d, d)
    params/block{i}/Dense_1/kernel (d, d)    -> blocks.{i}.proj.weight
    params/block{i}/LayerNorm_1/{scale,bias} -> blocks.{i}.ln2.{weight,bias}
    params/block{i}/Dense_2/{kernel,bias}    -> blocks.{i}.fc1.{weight,bias}
    params/block{i}/Dense_3/{kernel,bias}    -> blocks.{i}.fc2.{weight,bias}
    params/LayerNorm_0/{scale,bias}          -> ln_f.{weight,bias}

A MoE block (``num_experts > 0``) has no ``Dense_2``/``Dense_3``; its
``MoEMLP_0/{gate,expert_w1,expert_b1,expert_w2,expert_b2}`` become
``blocks.{i}.moe.{...}`` as they are (the port keeps the flax layout of
the gate and the expert stacks).
    params/Dense_0/{kernel,bias}             -> head.{weight,bias}

The ResNet family numbers its blocks across stages (``_BasicBlock_{i}`` or
``_BottleneckBlock_{i}`` -> ``blocks.{i}``); a block's ``Conv_{j}`` is
``conv{j+1}``, its last one the projection (``proj``), and its norms
follow the same order (``_FrozenAffine`` of the projection:
``proj_norm``).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

_GATES = "ifgo"


class Entry(NamedTuple):
    """One state_dict entry: its key, the flax paths (``/``-joined, under
    ``params``) it is made of, and how (``copy``, ``dense``: transpose,
    ``conv``: HWIO -> OIHW, ``gates``: four (in, H) kernels -> (4H, in),
    ``concat``: four biases, ``zeros``: no flax counterpart, of ``shape``)."""
    key: str
    paths: tuple
    kind: str = "copy"
    shape: tuple = ()


def _dense(key, path, bias=True):
    out = [Entry(f"{key}.weight", (f"{path}/kernel",), "dense")]
    if bias:
        out.append(Entry(f"{key}.bias", (f"{path}/bias",)))
    return out


def _norm(key, path):
    return [Entry(f"{key}.weight", (f"{path}/scale",)),
            Entry(f"{key}.bias", (f"{path}/bias",))]


def _conv(key, path, bias=False):
    out = [Entry(f"{key}.weight", (f"{path}/kernel",), "conv")]
    if bias:
        out.append(Entry(f"{key}.bias", (f"{path}/bias",)))
    return out


# a MoE block's params, in the flax layout on both sides
_MOE_PARAMS = ("gate", "expert_w1", "expert_b1", "expert_w2", "expert_b2")


def _transformer_map(cfg):
    out = [Entry("tok_embed.weight", ("Embed_0/embedding",)),
           Entry("pos_embed.weight", ("Embed_1/embedding",))]
    for i in range(cfg.get("layers", 2)):
        pre, b = f"blocks.{i}.", f"block{i}/"
        out += (_norm(pre + "ln1", b + "LayerNorm_0")
                + _dense(pre + "qkv", b + "Dense_0", bias=False)
                + _dense(pre + "proj", b + "Dense_1", bias=False)
                + _norm(pre + "ln2", b + "LayerNorm_1"))
        if cfg.get("num_experts", 0) > 0:
            out += [Entry(f"{pre}moe.{n}", (f"{b}MoEMLP_0/{n}",))
                    for n in _MOE_PARAMS]
        else:
            out += (_dense(pre + "fc1", b + "Dense_2")
                    + _dense(pre + "fc2", b + "Dense_3"))
    return out + _norm("ln_f", "LayerNorm_0") + _dense("head", "Dense_0")


def _mlp_map(cfg):
    n = len(cfg.get("hidden", (128, 64)))
    out = []
    for i in range(n):
        out += _dense(f"hidden.{i}", f"Dense_{i}")
    return out + _dense("head", f"Dense_{n}")


def _convnet_map(cfg):
    out = []
    for i in range(len(cfg.get("channels", (32, 32, 64, 64)))):
        out += _conv(f"convs.{i}", f"Conv_{i}", bias=True)
    return out + _dense("dense", "Dense_0") + _dense("head", "Dense_1")


def _resnet_map(cfg):
    from .modules import build_model
    with torch.device("meta"):
        net = build_model(cfg)      # the blocks and their projections
    frozen = cfg.get("norm", "group") == "frozen"
    norm_name = "_FrozenAffine" if frozen else "GroupNorm"
    out = []
    if net.input_norm is not None:
        out += _norm("input_norm", "input_norm")
    out += _conv("stem", "Conv_0") + _norm("stem_norm", f"{norm_name}_0")
    for i, blk in enumerate(net.blocks):
        flax_blk = f"{type(blk).__name__}_{i}/"
        convs = 3 if hasattr(blk, "conv3") else 2
        for j in range(convs):
            out += (_conv(f"blocks.{i}.conv{j + 1}", f"{flax_blk}Conv_{j}")
                    + _norm(f"blocks.{i}.norm{j + 1}",
                            f"{flax_blk}{norm_name}_{j}"))
        if blk.proj is not None:
            out += _conv(f"blocks.{i}.proj", f"{flax_blk}Conv_{convs}")
            if blk.proj_norm is not None:
                out += _norm(f"blocks.{i}.proj_norm",
                             f"{flax_blk}_FrozenAffine_{convs}")
    return out + _dense("head", "Dense_0")


def _bilstm_map(cfg):
    out = [Entry("embed.weight", ("Embed_0/embedding",))]
    four_h = 4 * cfg.get("hidden", 128)
    for cell, suffix in (("LSTMCell_0", ""), ("LSTMCell_1", "_reverse")):
        out += [
            Entry(f"lstm.weight_ih_l0{suffix}",
                  tuple(f"{cell}/i{g}/kernel" for g in _GATES), "gates"),
            Entry(f"lstm.weight_hh_l0{suffix}",
                  tuple(f"{cell}/h{g}/kernel" for g in _GATES), "gates"),
            Entry(f"lstm.bias_ih_l0{suffix}", (), "zeros", (four_h,)),
            Entry(f"lstm.bias_hh_l0{suffix}",
                  tuple(f"{cell}/h{g}/bias" for g in _GATES), "concat")]
    return out + _dense("head", "Dense_0")


_MAPS = {"transformer": _transformer_map, "mlp": _mlp_map,
         "convnet": _convnet_map, "resnet": _resnet_map,
         "resnet50": _resnet_map, "bilstm": _bilstm_map}


def flax_map(config: dict) -> list:
    """The :class:`Entry` list of ``config``'s family, in state_dict
    order."""
    mtype = config.get("type")
    if mtype not in _MAPS:
        raise KeyError(f"unknown model type {mtype!r}; have {sorted(_MAPS)}")
    return _MAPS[mtype](config)


def is_flax_tree(params: Mapping) -> bool:
    """A flax tree nests dicts; a state_dict maps flat names to tensors."""
    return any(isinstance(v, Mapping) for v in params.values())


def _leaf(tree: Mapping, path: str) -> np.ndarray:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node, dtype=np.float32)


def from_flax_params(params_np: Mapping, config: dict) -> dict:
    """flax param tree -> the port's state_dict (CPU float32 tensors).
    Accepts the tree with or without its top-level ``params``."""
    p = params_np.get("params", params_np)
    sd = {}
    for e in flax_map(config):
        a = [_leaf(p, path) for path in e.paths]
        if e.kind == "dense":
            v = a[0].T
        elif e.kind == "conv":
            v = a[0].transpose(3, 2, 0, 1)
        elif e.kind == "gates":
            v = np.concatenate([k.T for k in a], axis=0)
        elif e.kind == "concat":
            v = np.concatenate(a)
        elif e.kind == "zeros":
            v = np.zeros(e.shape, np.float32)
        else:
            v = a[0]
        sd[e.key] = torch.tensor(np.ascontiguousarray(v))   # a copy
    return sd


def to_flax_params(state_dict: Mapping, config: dict) -> dict:
    """The port's state_dict -> the flax tree ``{"params": ...}`` of numpy
    float32 arrays the JAX package builds for ``config``."""
    tree: dict = {}

    def put(path, value):
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.ascontiguousarray(value, dtype=np.float32)

    for e in flax_map(config):
        v = state_dict[e.key]
        v = (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v, np.float32))
        if e.kind == "dense":
            put(e.paths[0], v.T)
        elif e.kind == "conv":
            put(e.paths[0], v.transpose(2, 3, 1, 0))
        elif e.kind == "gates":
            for path, k in zip(e.paths, np.split(v, 4, axis=0)):
                put(path, k.T)
        elif e.kind == "concat":
            for path, b in zip(e.paths, np.split(v, 4)):
                put(path, b)
        elif e.kind == "copy":
            put(e.paths[0], v)
    return {"params": tree}


def flax_paths(tree: Mapping) -> set:
    """Every leaf path of a flax tree (under ``params``), ``/``-joined."""
    p = tree.get("params", tree)
    out = set()

    def walk(node, pre):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{pre}{k}/")
            else:
                out.add(pre + k)

    walk(p, "")
    return out


def as_state_dict(params: Mapping, config: dict) -> dict:
    """Either form -> a state_dict: flax trees go through
    :func:`from_flax_params`, numpy leaves become tensors."""
    if is_flax_tree(params):
        return from_flax_params(params, config)
    return {k: v if isinstance(v, torch.Tensor) else torch.tensor(v)
            for k, v in params.items()}

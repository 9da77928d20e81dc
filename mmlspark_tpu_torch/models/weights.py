"""Weights carried across from the JAX package.

:func:`from_flax_params` turns a flax param tree of the transformer family
(as numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray, variables)``)
into the port's ``state_dict``, so both packages run on the same weights.
The map, for each block ``i``:

    params/Embed_0/embedding (V, d)          -> tok_embed.weight
    params/Embed_1/embedding (max_len, d)    -> pos_embed.weight
    params/block{i}/LayerNorm_0/{scale,bias} -> blocks.{i}.ln1.{weight,bias}
    params/block{i}/Dense_0/kernel (d, 3d)   -> blocks.{i}.qkv.weight (3d, d)
    params/block{i}/Dense_1/kernel (d, d)    -> blocks.{i}.proj.weight
    params/block{i}/LayerNorm_1/{scale,bias} -> blocks.{i}.ln2.{weight,bias}
    params/block{i}/Dense_2/{kernel,bias}    -> blocks.{i}.fc1.{weight,bias}
    params/block{i}/Dense_3/{kernel,bias}    -> blocks.{i}.fc2.{weight,bias}
    params/LayerNorm_0/{scale,bias}          -> ln_f.{weight,bias}
    params/Dense_0/{kernel,bias}             -> head.{weight,bias}

flax ``Dense.kernel`` is (in, out) and ``nn.Linear.weight`` (out, in), so
kernels are transposed. The qkv kernel needs nothing more: both packages
view its output as (B, T, 3H, D) and split heads in thirds.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def is_flax_tree(params: Mapping) -> bool:
    """A flax tree nests dicts; a state_dict maps flat names to tensors."""
    return any(isinstance(v, Mapping) for v in params.values())


def from_flax_params(params_np: Mapping, config: dict) -> dict:
    """flax transformer param tree -> the port's state_dict (CPU float32
    tensors). Accepts the tree with or without its top-level ``params``."""
    if config.get("type") != "transformer":
        raise NotImplementedError(
            f"weights of model family {config.get('type')!r} are not carried "
            f"across yet (ROADMAP.md Queue 1 item 2)")
    p = params_np.get("params", params_np)

    def t(a, transpose=False):
        a = np.asarray(a, dtype=np.float32)
        return torch.tensor(a.T if transpose else a)    # a copy, contiguous

    sd = {"tok_embed.weight": t(p["Embed_0"]["embedding"]),
          "pos_embed.weight": t(p["Embed_1"]["embedding"])}
    for i in range(config.get("layers", 2)):
        b = p[f"block{i}"]
        pre = f"blocks.{i}."
        sd[pre + "ln1.weight"] = t(b["LayerNorm_0"]["scale"])
        sd[pre + "ln1.bias"] = t(b["LayerNorm_0"]["bias"])
        sd[pre + "qkv.weight"] = t(b["Dense_0"]["kernel"], transpose=True)
        sd[pre + "proj.weight"] = t(b["Dense_1"]["kernel"], transpose=True)
        sd[pre + "ln2.weight"] = t(b["LayerNorm_1"]["scale"])
        sd[pre + "ln2.bias"] = t(b["LayerNorm_1"]["bias"])
        sd[pre + "fc1.weight"] = t(b["Dense_2"]["kernel"], transpose=True)
        sd[pre + "fc1.bias"] = t(b["Dense_2"]["bias"])
        sd[pre + "fc2.weight"] = t(b["Dense_3"]["kernel"], transpose=True)
        sd[pre + "fc2.bias"] = t(b["Dense_3"]["bias"])
    sd["ln_f.weight"] = t(p["LayerNorm_0"]["scale"])
    sd["ln_f.bias"] = t(p["LayerNorm_0"]["bias"])
    sd["head.weight"] = t(p["Dense_0"]["kernel"], transpose=True)
    sd["head.bias"] = t(p["Dense_0"]["bias"])
    return sd


def as_state_dict(params: Mapping, config: dict) -> dict:
    """Either form -> a state_dict: flax trees go through
    :func:`from_flax_params`, numpy leaves become tensors."""
    if is_flax_tree(params):
        return from_flax_params(params, config)
    return {k: v if isinstance(v, torch.Tensor) else torch.tensor(v)
            for k, v in params.items()}

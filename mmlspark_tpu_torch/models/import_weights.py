"""Import externally trained weights: the port of
``mmlspark_tpu/models/import_weights.py``.

A user who has a pretrained checkpoint — torchvision's ResNet-50 saved as
``.pth``, ``.npz`` or ``.safetensors`` — maps it onto the ``resnet50``
family and gets the ImageFeaturizer flow:

    from mmlspark_tpu_torch.models.import_weights import import_resnet50
    cfg, sd = import_resnet50("resnet50-imagenet.pth",
                              preprocess="imagenet_uint8")
    feat = (ImageFeaturizer().setModel(
        TorchModel().setModelConfig(cfg).setModelParams(sd))
        .setCutOutputLayers(1))              # 2048-d ImageNet features

The returned config pins ``norm="frozen"`` and ``padding="torch"``, so the
forward reproduces torch's eval-mode activations: BatchNorm running
statistics fold into per-channel affines (scale = gamma / sqrt(var + eps),
bias = beta - mean * scale, eps 1e-5) and stride-2 convs pad k//2 each
side. ``preprocess="imagenet_uint8"`` folds torchvision's input transform
((x/255 - mean) / std per RGB channel) into an affine ahead of the stem,
so the net takes raw uint8 pixels and its zero-padded border still sees
the normalized zero.

The port's module holds torch's OIHW conv layout, so a torchvision weight
goes in as it is; the result is the port's state_dict. Every key and shape
is checked against the port's module before anything is returned: an
import never half-loads. ``import_flax_paths`` lays a checkpoint whose keys
are flax path strings ("Conv_0/kernel") onto any family.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from ..core.utils import get_logger

log = get_logger("import_weights")

#: BatchNorm epsilon used when folding running stats (torch's default)
BN_EPS = 1e-5

#: torchvision's ImageNet input normalization (per RGB channel)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# torchvision resnet stage depths per family name
RESNET_DEPTHS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def load_checkpoint(path: str) -> dict:
    """name -> float32 ndarray from .safetensors / .npz / torch .pt(h).
    Torch checkpoints load with ``weights_only=True`` and may wrap the
    weights in a 'state_dict' entry."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".safetensors":
        from safetensors.numpy import load_file
        return {k: np.asarray(v) for k, v in load_file(path).items()}
    if ext == ".npz":
        with np.load(path, allow_pickle=False) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    if ext in (".pt", ".pth", ".bin"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        return {k: v.detach().cpu().numpy() for k, v in state.items()
                if isinstance(v, torch.Tensor)}
    raise ValueError(f"unsupported checkpoint format {ext!r} "
                     f"(expected .safetensors, .npz, .pt/.pth/.bin)")


def fold_batchnorm(gamma, beta, mean, var, eps: float = BN_EPS):
    """BN eval-mode -> (scale, bias) of a frozen affine:
    y = gamma*(x-mean)/sqrt(var+eps) + beta  ==  x*scale + bias."""
    scale = np.asarray(gamma, np.float32) / np.sqrt(
        np.asarray(var, np.float32) + eps)
    bias = np.asarray(beta, np.float32) - np.asarray(mean,
                                                     np.float32) * scale
    return scale, bias


def _t(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, dtype=np.float32))


def _affine(state: dict, prefix: str, key: str, sd: dict):
    """A torch BN param group -> the folded ``key.{weight,bias}``."""
    scale, bias = fold_batchnorm(
        state.pop(f"{prefix}.weight"), state.pop(f"{prefix}.bias"),
        state.pop(f"{prefix}.running_mean"),
        state.pop(f"{prefix}.running_var"))
    state.pop(f"{prefix}.num_batches_tracked", None)
    sd[f"{key}.weight"], sd[f"{key}.bias"] = _t(scale), _t(bias)


def _conv(state: dict, name: str, key: str, sd: dict):
    w = state.pop(name)
    if w.ndim != 4:
        raise ValueError(f"{name}: expected a 4-D conv kernel, "
                         f"got shape {w.shape}")
    sd[key] = _t(w)


def import_resnet50(checkpoint, num_classes: Optional[int] = None,
                    family: str = "resnet50", depths=None,
                    widths=None, preprocess: Optional[str] = None) -> tuple:
    """Map a torchvision-layout ResNet-50/101/152 checkpoint (a path or a
    preloaded name -> array dict) onto the port's ``resnet50`` module.

    Returns ``(config, state_dict)`` ready for TorchModel / ImageFeaturizer:
    the ``resnet50`` family pinned to frozen affines and torch padding.
    Raises naming the offending key on any shape mismatch or unconsumed
    backbone key; warns on other leftover keys. ``depths``/``widths``
    override the family table for sibling layouts.
    ``preprocess="imagenet_uint8"`` folds torchvision's input transform in
    (see the module docstring); None expects normalized float input."""
    state = dict(load_checkpoint(checkpoint)
                 if isinstance(checkpoint, (str, os.PathLike))
                 else checkpoint)
    if depths is None:
        if family not in RESNET_DEPTHS:
            raise ValueError(
                f"family must be one of {sorted(RESNET_DEPTHS)} (or pass "
                f"depths=), got {family!r}")
        depths = RESNET_DEPTHS[family]
    widths = list(widths) if widths is not None else [256, 512, 1024, 2048]
    if preprocess not in (None, "imagenet_uint8"):
        raise ValueError(f"preprocess must be None or 'imagenet_uint8', "
                         f"got {preprocess!r}")
    fc_w = np.asarray(state.pop("fc.weight"))
    if num_classes is None:
        num_classes = int(fc_w.shape[0])

    sd: dict = {}
    if preprocess == "imagenet_uint8":
        # z = x * (1 / (255 std)) - mean / std, ahead of the stem conv
        sd["input_norm.weight"] = _t(1.0 / (255.0 * IMAGENET_STD))
        sd["input_norm.bias"] = _t(-IMAGENET_MEAN / IMAGENET_STD)
    _conv(state, "conv1.weight", "stem.weight", sd)
    _affine(state, "bn1", "stem_norm", sd)
    bi = 0   # the port numbers blocks across stages
    for stage, depth in enumerate(depths, start=1):
        for b in range(depth):
            t, pre = f"layer{stage}.{b}", f"blocks.{bi}"
            for j in (1, 2, 3):
                _conv(state, f"{t}.conv{j}.weight", f"{pre}.conv{j}.weight",
                      sd)
                _affine(state, f"{t}.bn{j}", f"{pre}.norm{j}", sd)
            if f"{t}.downsample.0.weight" in state:
                _conv(state, f"{t}.downsample.0.weight", f"{pre}.proj.weight",
                      sd)
                _affine(state, f"{t}.downsample.1", f"{pre}.proj_norm", sd)
            bi += 1
    sd["head.weight"] = _t(fc_w)
    sd["head.bias"] = _t(state.pop("fc.bias"))
    if state:
        structural = sorted(k for k in state
                            if re.match(r"(layer\d+|conv1|bn1|fc)\.", k))
        if structural:
            # a deeper net loaded under the wrong family leaves its extra
            # blocks here — that must be loud
            raise ValueError(
                f"checkpoint has {len(structural)} unconsumed backbone "
                f"keys (first: {structural[0]!r}) — wrong family/depths? "
                f"(e.g. a resnet101 checkpoint needs family='resnet101')")
        log.warning("checkpoint keys not consumed by the %s mapping "
                    "(ignored non-backbone entries): %s",
                    family, sorted(state)[:8])

    config = {"type": "resnet50", "blocks_per_stage": list(depths),
              "widths": widths, "num_classes": num_classes,
              "norm": "frozen", "padding": "torch", "dtype": "float32",
              "height": 224, "width": 224}
    if preprocess is not None:
        config["input_norm"] = True
    validate_state_dict(config, sd)
    return config, sd


def import_flax_paths(checkpoint, config: dict) -> dict:
    """Family-agnostic import: checkpoint keys are flax path strings
    ('_BottleneckBlock_0/Conv_1/kernel' or with '.' separators), laid onto
    ``config``'s flax tree and carried into the port's state_dict; the
    paths must be exactly the family's, and every shape the module's."""
    from .weights import flax_map, flax_paths, from_flax_params
    state = (load_checkpoint(checkpoint)
             if isinstance(checkpoint, (str, os.PathLike))
             else dict(checkpoint))
    params: dict = {}
    for key, value in state.items():
        parts = [p for p in key.replace(".", "/").split("/")
                 if p and p != "params"]
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value, np.float32)
    want = {p for e in flax_map(config) for p in e.paths}
    got = flax_paths(params)
    missing, extra = sorted(want - got), sorted(got - want)
    if missing or extra:
        raise ValueError(
            f"imported params do not match the {config['type']} tree; "
            f"missing={missing[:5]} extra={extra[:5]}")
    sd = from_flax_params(params, config)
    validate_state_dict(config, sd)
    return sd


def validate_state_dict(config: dict, sd: dict) -> None:
    """Compare keys and shapes with the port's module of ``config``
    (built on the meta device); raises naming the first mismatch."""
    from .modules import build_model
    with torch.device("meta"):
        module = build_model(config)
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(
            f"imported params do not match the {config['type']} module; "
            f"missing={missing[:5]} extra={extra[:5]}")
    for k in want:
        if want[k] != got[k]:
            raise ValueError(f"shape mismatch at {k}: checkpoint "
                             f"{got[k]} vs module {want[k]}")

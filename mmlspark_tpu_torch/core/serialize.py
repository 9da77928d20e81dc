"""Stage save/load, including non-JSON ("complex") params.

The PyTorch port's copy of ``mmlspark_tpu/core/serialize.py`` (reference:
src/core/serialize/src/main/scala/ComplexParamsSerializer.scala:16-33,137).

Layout on disk:
    <path>/metadata.json            class name, uid, simple params, complex index
    <path>/complex/<param>...       one entry per complex param, kind-tagged:
        stage/        a nested PipelineStage (recursive save)
        stage_list/0..N  list/tuple of stages
        ndarray .npy  numpy array
        tensors .npz  string-keyed (nested) dict of numpy arrays / torch
                      tensors, e.g. a flax-shaped param tree or a state_dict
        pickle .pkl   anything else picklable

The JAX package stores parameter trees as flax msgpack and restores them as
``jnp`` arrays; the port stores them as ``.npz`` (no pickle inside) and
restores each leaf as what it was saved as: a numpy array, or a CPU torch
tensor of its original dtype.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import sys
from typing import Any

import numpy as np

from .pipeline import PipelineStage, _qualname, lookup_stage_class

_FORMAT_VERSION = 1
_SEP = "/"


def _ensure_registry_populated():
    # importing the stage modules registers every stage subclass
    import mmlspark_tpu_torch.automl.featurize  # noqa: F401
    import mmlspark_tpu_torch.automl.model_statistics  # noqa: F401
    import mmlspark_tpu_torch.automl.train_classifier  # noqa: F401
    import mmlspark_tpu_torch.automl.tune  # noqa: F401
    import mmlspark_tpu_torch.automl.value_indexer  # noqa: F401
    import mmlspark_tpu_torch.io.http.transformer  # noqa: F401
    import mmlspark_tpu_torch.models.classical  # noqa: F401
    import mmlspark_tpu_torch.models.gbdt.stages  # noqa: F401
    import mmlspark_tpu_torch.models.image_featurizer  # noqa: F401
    import mmlspark_tpu_torch.models.torch_model  # noqa: F401
    import mmlspark_tpu_torch.models.trainer  # noqa: F401
    import mmlspark_tpu_torch.ops.image_stages  # noqa: F401
    import mmlspark_tpu_torch.ops.text_stages  # noqa: F401
    import mmlspark_tpu_torch.ops.word2vec  # noqa: F401
    import mmlspark_tpu_torch.stages  # noqa: F401


def _is_tensor(v) -> bool:
    torch = sys.modules.get("torch")   # no tensor exists before torch loads
    return torch is not None and isinstance(v, torch.Tensor)


def _flatten_tensors(value, prefix=""):
    """{path: leaf} for a string-keyed (nested) dict whose leaves are numpy
    arrays or torch tensors; None when ``value`` is not such a tree."""
    if not isinstance(value, dict) or not value:
        return None
    out = {}
    for k, v in value.items():
        if not isinstance(k, str) or _SEP in k:
            return None
        path = prefix + k
        if isinstance(v, dict):
            sub = _flatten_tensors(v, path + _SEP)
            if sub is None:
                return None
            out.update(sub)
        elif isinstance(v, np.ndarray) or _is_tensor(v):
            out[path] = v
        else:
            return None
    return out


def _save_tensors(flat: dict, path: str) -> dict:
    arrays, leaves = {}, {}
    for k, v in flat.items():
        if isinstance(v, np.ndarray):
            arrays[k] = v
            leaves[k] = "numpy"
        else:
            # torch leaf: float32 holds every narrower float exactly
            t = v.detach().cpu()
            leaves[k] = str(t.dtype).replace("torch.", "")
            arrays[k] = (t.float() if t.is_floating_point() else t).numpy()
    np.savez(path + ".npz", **arrays)
    return {"kind": "tensors", "leaves": leaves}


def _load_tensors(tag: dict, path: str) -> dict:
    out: dict = {}
    with np.load(path + ".npz", allow_pickle=False) as z:
        for k, kind in tag["leaves"].items():
            a = z[k]
            if kind == "numpy":
                leaf = a
            else:
                import torch
                leaf = torch.from_numpy(a).to(getattr(torch, kind))
            node = out
            parts = k.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
    return out


def _save_complex(value: Any, path: str) -> dict:
    if isinstance(value, PipelineStage):
        save_stage(value, path)
        return {"kind": "stage"}
    if isinstance(value, (list, tuple)) and value and all(
            isinstance(v, PipelineStage) for v in value):
        os.makedirs(path, exist_ok=True)
        for i, v in enumerate(value):
            save_stage(v, os.path.join(path, str(i)))
        return {"kind": "stage_list", "n": len(value)}
    if isinstance(value, np.ndarray):
        np.save(path + ".npy", value)
        return {"kind": "ndarray"}
    flat = _flatten_tensors(value)
    if flat is not None:
        return _save_tensors(flat, path)
    with open(path + ".pkl", "wb") as f:
        pickle.dump(value, f)
    return {"kind": "pickle"}


def _load_complex(tag: dict, path: str) -> Any:
    kind = tag["kind"]
    if kind == "stage":
        return load_stage(path)
    if kind == "stage_list":
        return tuple(load_stage(os.path.join(path, str(i)))
                     for i in range(tag["n"]))
    if kind == "ndarray":
        return np.load(path + ".npy", allow_pickle=False)
    if kind == "tensors":
        return _load_tensors(tag, path)
    if kind == "pickle":
        with open(path + ".pkl", "rb") as f:
            return pickle.load(f)
    raise ValueError(f"unknown complex-param kind {kind!r}")


def _jsonable(v):
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def save_stage(stage: PipelineStage, path: str, overwrite: bool = True):
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path)

    simple, complex_idx = {}, {}
    complex_dir = os.path.join(path, "complex")
    for name, value in stage._paramMap.items():
        p = stage._params[name]
        if p.jsonable and _jsonable(value):
            simple[name] = value
        else:
            os.makedirs(complex_dir, exist_ok=True)
            complex_idx[name] = _save_complex(
                value, os.path.join(complex_dir, name))

    meta = {"format": _FORMAT_VERSION, "class": _qualname(type(stage)),
            "uid": stage.uid, "params": simple, "complex": complex_idx}
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)


def load_stage(path: str) -> PipelineStage:
    _ensure_registry_populated()
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = lookup_stage_class(meta["class"])
    # stages must be no-arg constructible (same contract as Spark ML stages)
    stage = cls()
    stage.uid = meta["uid"]
    # restore simple params through validation; tuples arrive as JSON lists
    for k, v in meta["params"].items():
        if isinstance(v, list) and isinstance(stage._params[k].default, tuple):
            v = tuple(v)
        stage.set(**{k: v})
    for k, tag in meta["complex"].items():
        stage._paramMap[k] = _load_complex(
            tag, os.path.join(path, "complex", k))
    return stage

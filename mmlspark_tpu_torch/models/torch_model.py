"""TorchModel: batched inference as a pipeline stage, on one CUDA device.

The port of ``mmlspark_tpu/models/tpu_model.py``'s ``TpuModel`` (the
CNTKModel analog, reference: cntk-model/.../CNTKModel.scala:125-261): the
minibatch column block goes host -> device in one copy per chunk and the
forward pass runs under ``torch.inference_mode()``. Output-node selection
by layer name (reference :98-108) is the ``outputLayer`` param.

It runs on ``device`` ("cuda" by default). Asked for CUDA where there is
none, it raises: it never continues on the CPU. The tests ask for "cpu".
Image columns cross to the device as NHWC uint8 and the model casts them.
A float32 model config scores with TF32 off (full float32 products, as
``TorchLearner(precision="f32")`` trains); bf16 configs run on the tensor
cores.

Not ported yet, and raising when asked for: ``tensorParallel > 1`` (the
``parallel/`` slice), ``exportStableHLO`` and ``capture`` (the capture
slice), and the multi-host scoring path.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Optional

import numpy as np
import torch

from .. import telemetry
from ..core.dataframe import DataFrame
from ..core.env import resolve_device
from ..core.params import (ComplexParam, DictParam, IntParam, ListParam,
                           StringParam)
from ..core.pipeline import Transformer
from ..core.schema import image_to_array, is_image_column
from ..core.utils import get_logger, object_column, to_float32_matrix

log = get_logger("torch_model")


def _coerce_wire_dtype(x: np.ndarray) -> np.ndarray:
    """Cast an unsupported transfer dtype onto the wire table (int -> int32,
    else float32) — with a range check and a one-time warning instead of a
    silent cast: int64 values beyond the int32 range would otherwise be
    silently corrupted, and float64 inputs lose precision without a trace."""
    if np.issubdtype(x.dtype, np.integer):
        info = np.iinfo(np.int32)
        if x.size and (x.min() < info.min or x.max() > info.max):
            raise ValueError(
                f"{x.dtype} feature values exceed the int32 transfer range "
                f"[{info.min}, {info.max}]; rescale or re-index them "
                f"before scoring (the device wire format is int32)")
        tgt = np.int32
    else:
        tgt = np.float32
    telemetry.warn_once(
        log, "wire-dtype-downcast",
        "input dtype %s is not a device wire format; casting to %s "
        "(precision beyond %s is dropped — cast explicitly to silence "
        "this)", x.dtype, np.dtype(tgt).name, np.dtype(tgt).name)
    return x.astype(tgt)


def _next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 8 so tiny serving batches share a
    few shapes)."""
    t = 8
    while t < n:
        t <<= 1
    return t


def _prep_input(df: DataFrame, col_name: str, input_shape) -> np.ndarray:
    """Column -> device-ready batch. Images become NHWC and STAY uint8
    (shipping bytes moves 4x less host->device traffic than f32). Flat
    vectors are f32, reshaped from CHW to NHWC when input_shape=(C,H,W)."""
    col = df.col(col_name)
    if is_image_column(df, col_name):
        if len(col) == 0:
            return np.zeros((0, 1, 1, 3), np.uint8)
        return np.stack([image_to_array(r) for r in col])
    mat = to_float32_matrix(col)
    if input_shape:
        c, h, w = input_shape
        return mat.reshape(-1, c, h, w).transpose(0, 2, 3, 1)
    return mat


def _token_matrix(df: DataFrame, col_name: str) -> np.ndarray:
    """Token-id column -> (n, T) int32. Integer ids keep their exact values
    (through the wire table's range check) instead of a float32 round trip;
    float ids are cast like the JAX package casts them."""
    col = df.col(col_name)
    if len(col) == 0:
        return np.zeros((0, 0), np.int32)
    mat = (np.stack([np.asarray(v).ravel() for v in col])
           if col.dtype.kind == "O" else col.reshape(len(col), -1))
    if mat.dtype.kind == "f":
        return mat.astype(np.float32).astype(np.int32)
    if mat.dtype != np.int32:
        mat = _coerce_wire_dtype(mat)
    return mat


#: guards the count of threads inside ``full_precision_matmuls(True)`` and
#: the TF32 switches saved by the first of them: the switches are
#: process-global, so two threads saving and restoring them on their own
#: could turn TF32 back on inside another thread's block
_TF32_SWITCH_LOCK = threading.Lock()
_tf32_blocks = 0
_tf32_saved = None


@contextlib.contextmanager
def full_precision_matmuls(on: bool):
    """Full float32 products while ``on``: TF32 off for cuBLAS and cuDNN
    (PyTorch lets cuDNN's convolutions take TF32 by default). Blocks of
    several threads overlap: the first one in turns TF32 off and the last
    one out restores the switches, so each sees TF32 off throughout."""
    global _tf32_blocks, _tf32_saved
    if not on:
        yield
        return
    with _TF32_SWITCH_LOCK:
        if _tf32_blocks == 0:
            _tf32_saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_blocks += 1
    try:
        yield
    finally:
        with _TF32_SWITCH_LOCK:
            _tf32_blocks -= 1
            if _tf32_blocks == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _tf32_saved


class TorchModel(Transformer):
    """Batch inference on one device.

    Params mirror the JAX package's TpuModel (CNTKModel's surface):
    inputCol/outputCol, miniBatchSize, outputLayer (truncation), inputShape
    (CHW shape for flat-vector inputs), plus ``device``.
    """

    inputCol = StringParam("input column (vectors or images)", default="features")
    outputCol = StringParam("output column", default="scores")
    modelConfig = DictParam("declarative model config (models.build_model)",
                            default=None)
    modelParams = ComplexParam(
        "trained parameters: a state_dict of the port's module, or the JAX "
        "package's flax param tree as numpy arrays", default=None)
    outputLayer = StringParam("layer name to emit (headless nets)", default="")
    inputShape = ListParam("CHW shape to reshape flat vectors", default=())
    miniBatchSize = IntParam("rows per device batch", default=4096, min=1)
    transferDtype = StringParam(
        "wire dtype for float inputs: bfloat16 halves host->device traffic "
        "(~3 decimal digits kept)",
        default="float32", choices=("float32", "bfloat16"))
    tensorParallel = IntParam(
        "model-parallel width for inference; only 1 is ported so far",
        default=1, min=1)
    device = StringParam(
        "torch device to score on: 'cuda' (default), 'cuda:N' or 'cpu'. "
        "Asking for CUDA where there is none raises; nothing falls back",
        default="cuda")

    # ---- model loading ----
    def setModelLocation(self, path: str) -> "TorchModel":
        """Load a saved model: a packed ``.model`` artifact (the zoo's and
        ModelDownloader's form), or a directory holding ``config.json``
        and either ``params.npz`` (a state_dict, as :meth:`saveModel`
        writes it) or ``params.msgpack`` (a flax tree, as the JAX package
        writes it)."""
        from .downloader import read_flax_msgpack, unpack_model
        if os.path.isfile(path):
            with open(path, "rb") as f:
                config, params = unpack_model(f.read())
            return self.setModelConfig(config).setModelParams(params)
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        params_file = os.path.join(path, "params.npz")
        if os.path.exists(params_file):
            with np.load(params_file, allow_pickle=False) as z:
                params = {k: torch.from_numpy(z[k]) for k in z.files}
        else:
            with open(os.path.join(path, "params.msgpack"), "rb") as f:
                params = read_flax_msgpack(f.read())
        self.setModelConfig(config)
        self.setModelParams(params)
        return self

    def setModelSchema(self, schema) -> "TorchModel":
        """Load from a ModelDownloader ``ModelSchema`` (a local uri)."""
        return self.setModelLocation(schema.uri)

    def saveModel(self, path: str):
        """Persist {config.json, params.npz}: the state_dict, float32."""
        from .weights import as_state_dict
        os.makedirs(path, exist_ok=True)
        sd = as_state_dict(self.getModelParams(), self.getModelConfig())
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.getModelConfig(), f)
        np.savez(os.path.join(path, "params.npz"),
                 **{k: v.detach().float().cpu().numpy() for k, v in sd.items()})

    def layerNames(self) -> list[str]:
        from .modules import build_model
        with torch.device("meta"):
            return build_model(self.getModelConfig()).layer_names()

    def exportStableHLO(self, path: str, batch: Optional[int] = None,
                        in_dtype=None) -> str:
        raise NotImplementedError(
            "exportStableHLO is an XLA artifact; the port's deployment "
            "artifact waits for the serving-bundle port (ROADMAP.md Queue 1 "
            "item 10, serving half)")

    def capture(self, columns):
        raise NotImplementedError(
            "cross-stage capture waits for the port of core/capture.py "
            "(ROADMAP.md Queue 1 item 11)")

    # ---- device state ----
    def _device(self) -> torch.device:
        return resolve_device(self.getDevice(), "TorchModel")

    def _device_module(self, dev: torch.device, cfg: dict):
        """The module of ``cfg`` (the config sized for the input) with its
        weights on ``dev``, uploaded ONCE per (params, config, device): the
        serving loop calls transform per request batch, and re-shipping
        every weight each time would dominate request latency. Validity is
        object identity through STRONG references, so a new params object
        can never alias a freed one; updating weights means setModelParams
        (a new object)."""
        host = self.getModelParams()
        key = (json.dumps(cfg, sort_keys=True, default=str), str(dev))
        if (getattr(self, "_dev_params_src", None) is not host
                or getattr(self, "_dev_module_key", None) != key):
            from .modules import build_model
            from .weights import as_state_dict
            sd = as_state_dict(host, cfg)
            with torch.device(dev):
                module = build_model(cfg)
            module.load_state_dict(sd, strict=True)
            self._dev_module = module.eval().requires_grad_(False)
            self._dev_params_src = host
            self._dev_module_key = key
        return self._dev_module

    # ---- scoring ----
    def warmup(self, example_df: DataFrame, max_rows: Optional[int] = None
               ) -> "TorchModel":
        """Run every bucketed batch shape up to ``max_rows`` (default
        miniBatchSize) once on tiled copies of ``example_df``'s first row,
        so weights are on the device and kernels are built and loaded
        before the first client request."""
        row = {k: example_df.col(k)[:1] for k in example_df.columns}
        cap = min(self.getMiniBatchSize(),
                  _next_pow2(max_rows or self.getMiniBatchSize()))
        t = 8
        while True:
            n = min(t, cap)
            tiled = DataFrame({k: np.concatenate([v] * n)
                               for k, v in row.items()})
            self.transform(tiled)
            if t >= cap:
                break
            t <<= 1
        return self

    def transform(self, df: DataFrame) -> DataFrame:
        if self.getModelParams() is None:
            raise ValueError("TorchModel has no params; set modelParams or "
                             "call setModelLocation")
        if self.getTensorParallel() > 1:
            raise NotImplementedError(
                "tensorParallel > 1 waits for the port's parallel/ slice "
                "(ROADMAP.md Queue 1 item 12)")
        dev = self._device()
        cfg = self.getModelConfig()
        from .modules import TOKEN_MODELS, resolve_dtype, sized_for
        if cfg.get("type") in TOKEN_MODELS:
            x = _token_matrix(df, self.getInputCol())
            vocab = cfg.get("vocab_size", 10000)
            if x.size and (x.min() < 0 or x.max() >= vocab):
                # XLA clamps an out-of-range gather; a CUDA embedding
                # lookup would fault the device instead — refuse on host
                raise ValueError(f"token ids must lie in [0, {vocab}); got "
                                 f"[{x.min()}, {x.max()}]")
        else:
            x = _prep_input(df, self.getInputCol(),
                            tuple(self.getInputShape()))
        # an empty column has no shape to size the module by: nothing runs
        module = (self._device_module(dev, sized_for(cfg, x.shape))
                  if len(x) else None)
        ol = self.getOutputLayer() or None
        bs = self.getMiniBatchSize()
        outs = []
        f32 = resolve_dtype(cfg.get("dtype")) == torch.float32
        with torch.inference_mode(), full_precision_matmuls(f32):
            for lo in range(0, len(x), bs):
                chunk = x[lo:lo + bs]
                n_real = len(chunk)
                # bucket partial chunks to the next power of two, as the
                # JAX package does: ragged request batches then reuse a
                # few shapes; padding rows are sliced off on read-back
                target = min(_next_pow2(n_real), bs)
                if n_real < target:
                    filler = np.zeros((target - n_real,) + chunk.shape[1:],
                                      chunk.dtype)
                    chunk = np.concatenate([chunk, filler])
                xb = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
                if xb.dtype == torch.int32:
                    xb = xb.long()             # nn.Embedding takes int64 ids
                elif (xb.dtype == torch.float32
                      and self.getTransferDtype() == "bfloat16"):
                    xb = xb.to(torch.bfloat16)
                y = module(xb, output_layer=ol)
                outs.append(y[:n_real].float().cpu().numpy())
        y = np.concatenate(outs, axis=0) if outs else np.empty((0,))
        if y.ndim == 1:
            return df.withColumn(self.getOutputCol(), y)
        return df.withColumn(self.getOutputCol(), object_column(y))

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

Each chunk ships from pinned memory on a side copy stream and its output
comes back the same way, at most two chunks in flight
(``_dispatch_windowed``). ``warmup`` captures one CUDA graph per
power-of-two bucket; ``transform`` replays it for batches of that bucket
and runs eagerly otherwise. ``exportStableHLO`` writes a ``torch.export``
program of the forward.

``capture`` hands a fused pipeline segment (core/capture.py) the same
module forward for flat float inputs (MLPs), run on the segment's device.

MoE transformers score with a row mask of the bucket's real rows, so the
padding claims no expert capacity and the scores do not depend on it.

Under a process group (``parallel.distributed``) each rank's DataFrame is
its own shard: the ranks agree once on a chunk count and score lockstep
fixed-shape chunks, a short shard padding with dummy chunks
(``_transform_multihost``). ``tensorParallel > 1`` serves with the Dense
kernels column-split over the ``model`` group of a mesh of the world's
ranks (the ranks of one model group score each other's rows together),
under ``collective_fit_lock``; with no process group it raises the JAX
package's ``ValueError``.
"""

from __future__ import annotations

import collections
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
        "model-parallel width for inference (needs a process group of a "
        "multiple of this many ranks)", default=1, min=1)
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
        """Write the inference program as a deployment artifact: a
        ``torch.export`` program of the module's forward at batch
        ``batch`` (default miniBatchSize), saved with ``torch.export.save``
        to ``path`` and loadable with ``torch.export.load`` once
        ``mmlspark_tpu_torch`` is imported (which registers the flash
        forward as the operator ``mmlspark_torch::flash_attention_fwd``).
        The name is the JAX package's, whose artifact is StableHLO text;
        the port's runs under PyTorch without this package's Python.

        The program takes the wire batch ``transform`` ships and returns
        float32 scores. Its input dtype follows the JAX package's rules:
        int32 for token models; uint8 for image-shaped models fed image
        columns; otherwise float32 (bfloat16 under transferDtype).
        Flat-vector inputs (inputShape set) always arrive as floats. Pass
        ``in_dtype`` (a numpy dtype or "bfloat16") to override. The
        program is traced on ``device``."""
        if self.getModelParams() is None:
            raise ValueError("TorchModel has no params; set modelParams or "
                             "call setModelLocation before exporting")
        cfg = self.getModelConfig()
        from .modules import TOKEN_MODELS, example_input, sized_for
        b = batch or self.getMiniBatchSize()
        if self.getInputShape():
            # the serving shape: _prep_input reshapes CHW vectors to NHWC
            c, h, w = self.getInputShape()
            row_shape = (h, w, c)
        else:
            row_shape = tuple(example_input(cfg).shape[1:])
        if in_dtype is None:
            if cfg.get("type") in TOKEN_MODELS:
                in_dtype = np.int32
            elif (cfg.get("type") in ("convnet", "resnet", "resnet50")
                  and not self.getInputShape()):
                in_dtype = np.uint8  # image rows ship as bytes
            elif self.getTransferDtype() == "bfloat16":
                in_dtype = "bfloat16"
            else:
                in_dtype = np.float32
        wire = (torch.bfloat16 if str(in_dtype) in ("bfloat16", "bf16")
                else torch.from_numpy(np.zeros(0, in_dtype)).dtype)
        dev = self._device()
        module = self._device_module(dev, sized_for(cfg, (b,) + row_shape))
        program = _WireForward(module, self.getOutputLayer() or None)
        example = torch.zeros((b,) + row_shape, dtype=wire, device=dev)
        with torch.no_grad():
            exported = torch.export.export(program, (example,))
        torch.export.save(exported, path)
        return path

    def capture(self, columns):
        """The inference forward as a pipeline capture (cross-stage fusion,
        core/capture.py): the SAME ``_WireForward`` of the device module
        the staged transform runs, minus its chunking and bucketing — the
        fused segment runs the whole batch in its one program. Offered
        for non-TP, non-MoE models with flat float inputs (the wire shape
        a fused column feed produces); image and token models keep the
        staged transform's windowed dispatch."""
        from ..core.capture import StageCapture
        from .modules import example_input, sized_for
        cfg = self.getModelConfig()
        if (cfg is None or self.getModelParams() is None
                or self.getInputCol() not in columns):
            return None
        if (cfg.get("num_experts", 0) > 0 or self.getTensorParallel() > 1
                or self.getInputShape()):
            return None
        try:
            ex = example_input(cfg)
        except Exception:
            return None
        if ex.ndim != 2 or not ex.dtype.is_floating_point:
            return None     # image/token models keep the staged wire path
        ol = self.getOutputLayer() or None
        wire = self.getTransferDtype()

        def fn(p, xs):
            x = xs[0].to(torch.float32)
            x = x.reshape(x.shape[0], -1)
            # built (and its weights uploaded) by the segment's first,
            # uncaptured run; a capture finds it cached
            module = self._device_module(x.device, sized_for(cfg, x.shape))
            return (_WireForward(module, ol, wire)(x),)

        # the weights live in the device module: nothing else to place.
        # The host params still key the segment cache by identity, so new
        # weights (setModelParams) re-capture
        return StageCapture(fn, inputs=(self.getInputCol(),),
                            outputs=(self.getOutputCol(),),
                            params=self.getModelParams(),
                            tag="torch_model.forward",
                            place=lambda p, device: {})

    def __getstate__(self):
        # device state (the module on the card, its graphs) is rebuilt
        # where the model is unpickled (a pipeline serving bundle)
        state = dict(self.__dict__)
        for k in ("_dev_module", "_dev_params_src", "_dev_module_key",
                  "_graphs", "_graph_lane"):
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._drop_graphs()

    def setModelParams(self, value) -> "TorchModel":
        """New weights: the device module and every captured graph of the
        old ones are dropped here, not at the next transform."""
        self._drop_graphs()
        self.__dict__.pop("_dev_module", None)
        self.__dict__.pop("_dev_params_src", None)
        return self.set(modelParams=value)

    def _drop_graphs(self):
        self._graphs = {}
        self._graph_lane = None

    # ---- device state ----
    def _device(self) -> torch.device:
        return resolve_device(self.getDevice(), "TorchModel")

    def _is_moe(self) -> bool:
        cfg = self.getModelConfig()
        return (cfg.get("type") == "transformer"
                and cfg.get("num_experts", 0) > 0)

    def _serving_plan(self, cfg: dict):
        """The plan of a distributed transform (None on one device): a
        (data, model) mesh over the world's ranks. Raises the JAX
        package's errors: tensorParallel inside local-fit mode, a model
        axis that does not divide the world (one rank: always)."""
        from ..parallel import mesh as meshlib
        tp = self.getTensorParallel()
        if tp > 1 and meshlib.in_local_fit():
            raise ValueError(
                "tensorParallel serving is unavailable inside local-fit mode "
                "(fleet tuner trials run single-device)")
        if tp == 1 and not meshlib.distributed_active():
            return None
        if meshlib.effective_process_count() > 1:
            meshlib.require_inner_block_local({"tensorParallel": tp})
        mesh = meshlib.create_mesh(model=tp)
        key = (id(mesh), json.dumps(cfg, sort_keys=True, default=str))
        if getattr(self, "_plan_key", None) != key:
            from ..parallel.plan import ParallelPlan
            from .modules import build_model
            with torch.device("meta"):
                shapes = build_model(cfg).state_dict()
            self._plan_cache = ParallelPlan(mesh, cfg, shapes, tp=tp)
            self._plan_key = key
        return self._plan_cache

    def _device_module(self, dev: torch.device, cfg: dict, plan=None):
        """The module of ``cfg`` (the config sized for the input) with its
        weights on ``dev``, uploaded ONCE per (params, config, device): the
        serving loop calls transform per request batch, and re-shipping
        every weight each time would dominate request latency. Validity is
        object identity through STRONG references, so a new params object
        can never alias a freed one; updating weights means setModelParams
        (a new object). A new module drops the graphs of the old one."""
        host = self.getModelParams()
        key = (json.dumps(cfg, sort_keys=True, default=str), str(dev),
               id(plan))
        if (getattr(self, "_dev_params_src", None) is not host
                or getattr(self, "_dev_module_key", None) != key):
            from .modules import build_model
            from .weights import as_state_dict
            sd = as_state_dict(host, cfg)
            with torch.device(dev):
                module = build_model(cfg)
            module.load_state_dict(sd, strict=True)
            if plan is not None:
                plan.shard_module(module)
            self._drop_graphs()
            self._dev_module = module.eval().requires_grad_(False)
            self._dev_params_src = host
            self._dev_module_key = key
        return self._dev_module

    def _graph_fn(self, module, ol: Optional[str]):
        """The profiler's AOT cache of ``module``'s forward with output
        layer ``ol``: one CUDA graph per signature (pow2 bucket, wire
        dtype), all of this model's graphs in one memory pool. Built per
        device module (params object, sized config, device), so the cache
        key is theirs plus the bucket, the wire dtype and outputLayer."""
        pf = self._graphs.get(ol)
        if pf is None:
            if self._graph_lane is None:
                self._graph_lane = telemetry.profiler.GraphLane()
            pf = self._graphs[ol] = telemetry.profiler.wrap(
                _WireForward(module, ol, self.getTransferDtype()),
                "torch_model.transform", aot=True, lane=self._graph_lane)
        return pf

    # ---- scoring ----
    def warmup(self, example_df: DataFrame, max_rows: Optional[int] = None
               ) -> "TorchModel":
        """Run every bucketed batch shape up to ``max_rows`` (default
        miniBatchSize) once on tiled copies of ``example_df``'s first row,
        so weights are on the device and kernels are built and loaded
        before the first client request. On a CUDA device each bucket's
        forward is captured as one CUDA graph, which ``transform`` then
        replays for batches of that bucket (one launch instead of one per
        op); nothing else captures."""
        row = {k: example_df.col(k)[:1] for k in example_df.columns}
        cap = min(self.getMiniBatchSize(),
                  _next_pow2(max_rows or self.getMiniBatchSize()))
        t = 8
        while True:
            n = min(t, cap)
            tiled = DataFrame({k: np.concatenate([v] * n)
                               for k, v in row.items()})
            self._score(tiled, capture=True)
            if t >= cap:
                break
            t <<= 1
        return self

    def transform(self, df: DataFrame) -> DataFrame:
        return self._score(df, capture=False)

    def _score(self, df: DataFrame, capture: bool) -> DataFrame:
        if self.getModelParams() is None:
            raise ValueError("TorchModel has no params; set modelParams or "
                             "call setModelLocation")
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
        plan = self._serving_plan(sized_for(cfg, x.shape))
        ol = self.getOutputLayer() or None
        if plan is not None:
            if plan.device.type != dev.type:
                raise ValueError(
                    f"the process group's ranks run on {plan.device.type} "
                    f"but this model asks for device={self.getDevice()!r}")
            from ..parallel import mesh as meshlib
            # a collective program: never interleaved with another
            # thread's collective fit
            with meshlib.collective_fit_lock, torch.inference_mode(), \
                    full_precision_matmuls(
                        resolve_dtype(cfg.get("dtype")) == torch.float32):
                y = self._transform_multihost(x, cfg, plan, ol)
            if y.ndim == 1:
                return df.withColumn(self.getOutputCol(), y)
            return df.withColumn(self.getOutputCol(), object_column(y))
        # an empty column has no shape to size the module by: nothing runs
        module = (self._device_module(dev, sized_for(cfg, x.shape))
                  if len(x) else None)
        bs = self.getMiniBatchSize()
        moe = self._is_moe()

        def chunks():
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
                yield np.ascontiguousarray(chunk), n_real

        f32 = resolve_dtype(cfg.get("dtype")) == torch.float32
        y = np.empty((0,))
        if module is not None:
            eager = _WireForward(module, ol, self.getTransferDtype())
            graphs = (self._graph_fn(module, ol) if dev.type == "cuda"
                      else None)

            def run(xb, n_real):
                # MoE: the bucket's padding rows claim no expert capacity
                args = ((xb, _row_mask(len(xb), n_real, xb.device))
                        if moe else (xb,))
                if graphs is not None and capture:
                    graphs.aot_compile(*args)
                if graphs is not None and graphs.is_cached(*args):
                    return graphs(*args)
                return eager(*args)

            with torch.inference_mode(), full_precision_matmuls(f32):
                y = self._dispatch_windowed(chunks(), run, dev)
        if y.ndim == 1:
            return df.withColumn(self.getOutputCol(), y)
        return df.withColumn(self.getOutputCol(), object_column(y))

    def _transform_multihost(self, x, cfg: dict, plan, ol) -> np.ndarray:
        """Lockstep chunked scoring over every rank's local shard. The
        ranks agree ONCE (an object gather) on the chunk count — the
        largest shard's at miniBatchSize rows a chunk, never more rows
        than that shard — and every rank makes that many identical-shape
        calls, a short (or empty) shard scoring zero-filled dummy chunks.
        A call gathers the model group's rows, runs the forward with its
        collectives (TP, MoE's global capacity), and keeps this rank's
        rows."""
        from ..parallel.dataplane import allgather_pyobj
        n = len(x)
        meta = allgather_pyobj((n, tuple(x.shape[1:]), x.dtype.str)
                               if n else (0, None, None))
        max_n = max(m[0] for m in meta)
        if max_n == 0:
            return np.empty((0,))
        bs = max(min(self.getMiniBatchSize(), max_n), 1)
        n_chunks = -(-max_n // bs)
        if n == 0:
            _, tail, dt = next(m for m in meta if m[0])
            x = np.zeros((0,) + tuple(tail), np.dtype(dt))
        dev = plan.device
        from .modules import sized_for
        module = self._device_module(dev, sized_for(cfg, x.shape), plan)
        eager = _WireForward(module, ol, self.getTransferDtype())
        moe = self._is_moe()

        def chunks():
            for k in range(n_chunks):
                chunk = x[k * bs:(k + 1) * bs]
                n_real = len(chunk)    # 0 for a drained shard's dummy chunk
                if n_real < bs:
                    filler = np.zeros((bs - n_real,) + x.shape[1:], x.dtype)
                    chunk = (np.concatenate([chunk, filler])
                             if n_real else filler)
                yield np.ascontiguousarray(chunk), n_real

        def run(xb, n_real):
            wb = _row_mask(len(xb), n_real, xb.device)
            xs, ws = plan.rows(xb, wb)
            y = eager(xs, ws) if moe else eager(xs)
            return plan.own_rows(y, len(xb))

        return self._dispatch_windowed(chunks(), run, dev)

    def _dispatch_windowed(self, chunks, run, dev: torch.device,
                           window: int = 2) -> np.ndarray:
        """The dispatch loop of ``transform`` (the counterpart of the JAX
        package's ``TpuModel._dispatch_windowed``): each ``(padded chunk,
        n_real)`` ships from pinned host memory on a side copy stream and
        runs through ``run`` on the compute (current) stream once its copy
        is done; its output is copied device-to-host, non-blocking, into
        pinned memory and read after its event. At most ``window`` chunks
        are in flight, so the next chunk's copy overlaps the current
        one's compute and device memory holds ~window chunks, not the
        dataset. On the CPU the chunks simply run in turn."""
        outs: list = []
        if dev.type != "cuda":
            for chunk, n_real in chunks:
                outs.append(run(torch.from_numpy(chunk), n_real)[:n_real]
                            .numpy())
            return (np.concatenate(outs, axis=0) if outs
                    else np.empty((0,)))
        compute = torch.cuda.current_stream(dev)
        copy = torch.cuda.Stream(dev)
        pending: collections.deque = collections.deque()

        def drain():
            host, n_real, done = pending.popleft()
            done.synchronize()
            outs.append(host[:n_real].numpy())

        for chunk, n_real in chunks:
            if len(pending) >= window:
                drain()
            staged = torch.from_numpy(chunk).pin_memory()
            with torch.cuda.stream(copy):
                xb = staged.to(dev, non_blocking=True)
            compute.wait_stream(copy)
            xb.record_stream(compute)
            y = run(xb, n_real)
            host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            host.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record(compute)
            pending.append((host, n_real, done))
        while pending:
            drain()
        return np.concatenate(outs, axis=0) if outs else np.empty((0,))


class _WireForward(torch.nn.Module):
    """The module's forward from a wire batch: int32 token ids become the
    int64 ids ``nn.Embedding`` takes, float32 rows become bfloat16 under
    ``transferDtype="bfloat16"``, and the output is float32 — one function
    that transform runs eagerly, captures as a CUDA graph per bucket, and
    exports."""

    def __init__(self, module, output_layer: Optional[str] = None,
                 transfer_dtype: str = "float32"):
        super().__init__()
        self.module = module
        self.output_layer = output_layer
        self.bf16_wire = transfer_dtype == "bfloat16"

    def forward(self, xb, row_mask=None):
        if xb.dtype == torch.int32:
            xb = xb.long()
        elif xb.dtype == torch.float32 and self.bf16_wire:
            xb = xb.to(torch.bfloat16)
        if row_mask is not None:       # a MoE transformer's real rows
            return self.module(xb, output_layer=self.output_layer,
                               row_mask=row_mask).float()
        return self.module(xb, output_layer=self.output_layer).float()


def _row_mask(rows: int, n_real: int, dev) -> torch.Tensor:
    """(rows,) float32 weights: 1 for the first ``n_real`` rows, 0 for the
    padding."""
    return (torch.arange(rows, device=dev) < n_real).to(torch.float32)

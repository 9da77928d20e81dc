"""The fused decode -> pad -> one graph replay -> unpad serving step: the
port of ``mmlspark_tpu/io/serving/step.py``.

:class:`FusedServingStep` does the per-batch work in four steps, one of
which touches the device:

1. **decode** (host): payload string -> one wire-format row (uint8 for
   images, int32 for token ids: bytes on the wire, cast on the device);
2. **pad** (host): rows land in a pinned ``(bucket, *row_shape)`` buffer
   of the wire dtype, zero past the real rows — the bucket is one of
   :class:`~.batcher.BucketPolicy`'s static power-of-two shapes;
3. **dispatch** (device, ONE graph replay): the pinned rows are copied
   into the bucket graph's static input on the step's stream, and the
   graph replays the whole cast -> forward -> argmax computation. Every
   bucket's ``torch.cuda.CUDAGraph`` is captured ahead of time through
   the profiler's AOT cache (``telemetry.profiler.wrap(..., aot=True)``;
   a bundle restores them, :mod:`.bundle`): one launch a dispatch instead
   of one per op. A bucket captured on live traffic is a cold capture —
   warned and counted on the cache-miss counter, as the JAX package
   counts a cold compile;
4. **unpad** (host): the first ``n`` rows of the output are copied back
   (argmax mode reads 4 bytes a row, not the score matrix).

On the CPU there is no graph: a bucket is "captured" once it has run
once, and the dispatch is the plain forward.

:meth:`FusedServingStep.from_pipeline` makes the same step over a whole
``PipelineModel`` (core/capture.py): every stage's capture composed into
one body, featurize -> predict in one graph per bucket.
"""

from __future__ import annotations

import base64
import contextlib
import json
import threading
import time
from typing import Callable, Optional

import numpy as np

from ... import telemetry
from ...core.env import resolve_device
from ...core.utils import get_logger
from .batcher import BucketPolicy

log = get_logger("io.serving")

_m_aot_compiles = telemetry.registry.counter(
    "mmlspark_serving_aot_compiles_total",
    "bucket executables compiled ahead of live traffic (startup warmup "
    "or bundle build); in the port a compile is a CUDA graph capture")
_m_cache_hits = telemetry.registry.counter(
    "mmlspark_serving_exec_cache_hits_total",
    "dispatches served by an already-compiled bucket executable")
_m_cache_misses = telemetry.registry.counter(
    "mmlspark_serving_exec_cache_misses_total",
    "dispatches that had to compile on live traffic (a cold compile some "
    "client's latency paid for — zero when warmup/bundle covered every "
    "bucket)")


def _default_decode(row_shape, dtype):
    """base64 payload -> one wire row. The ubiquitous serving wire format
    (bench_serving's image payloads): raw bytes, base64'd for HTTP."""
    size = int(np.prod(row_shape)) if row_shape else 1

    def decode(value: str) -> np.ndarray:
        a = np.frombuffer(base64.b64decode(value), dtype=dtype)
        if a.size != size:
            raise ValueError(f"payload decodes to {a.size} {dtype} "
                             f"elements, expected {size} {row_shape}")
        return a.reshape(row_shape)
    return decode


def _default_encode(output: str):
    if output == "argmax":
        return lambda y: json.dumps({"label": int(y)})
    return lambda y: json.dumps({"scores": np.asarray(y).tolist()})


class FusedServingStep:
    """One graph replay per bucket over a built model.

    ``model_config`` / ``params`` are the :func:`models.build_model` pair
    (the same artifacts TorchModel serves: a state_dict or the JAX
    package's flax tree); ``row_shape`` is the per-row wire shape (e.g.
    ``(32, 32, 3)``, or ``(T,)`` token ids) and ``in_dtype`` its wire
    dtype (uint8 ships bytes and int32 token ids; the cast to the
    compute dtype happens inside the graph). ``output='argmax'`` folds the
    reply reduction into the graph (4 readback bytes a row); ``'scores'``
    returns the score rows. ``decode``/``encode`` override the payload
    codecs. ``device`` is where the model serves ("cuda" by default;
    asking for CUDA where there is none raises). A float32 model serves
    with TF32 off, set at capture time. ``_body`` (``from_pipeline``)
    replaces the model: a function of the wire batch on the device.
    """

    def __init__(self, model_config: Optional[dict], params, *,
                 policy: Optional[BucketPolicy] = None,
                 row_shape=(), in_dtype=np.uint8, output: str = "argmax",
                 decode: Optional[Callable] = None,
                 encode: Optional[Callable] = None,
                 tag: str = "serving.step", device: str = "cuda",
                 _body: Optional[Callable] = None):
        import torch
        from ...models.modules import build_model, resolve_dtype, sized_for
        from ...models.torch_model import full_precision_matmuls
        from ...models.weights import as_state_dict
        if output not in ("argmax", "scores"):
            raise ValueError(f"output must be argmax|scores, got {output!r}")
        self.device = resolve_device(device, "FusedServingStep")
        self.model_config = None if model_config is None \
            else dict(model_config)
        self.policy = policy or BucketPolicy()
        self.row_shape = tuple(int(d) for d in row_shape)
        self.in_dtype = np.dtype(in_dtype)
        self.output = output
        self.decode = decode or _default_decode(self.row_shape,
                                                self.in_dtype)
        self.encode = encode or _default_encode(output)
        self.params = params
        self._wire_dtype = torch.from_numpy(
            np.zeros(0, self.in_dtype)).dtype
        if _body is None:
            cfg = sized_for(self.model_config, (1,) + self.row_shape)
            with torch.device(self.device):
                module = build_model(cfg)
            module.load_state_dict(as_state_dict(params, cfg), strict=True)
            self.module = module.eval().requires_grad_(False)
            f32 = resolve_dtype(cfg.get("dtype")) == torch.float32
            grad_off = torch.inference_mode

            def _body(x):
                return self.module(x.long() if x.dtype == torch.int32
                                   else x)
        else:
            # a pipeline body builds device state (a net's module) on its
            # first, uncaptured run, which must outlive inference mode
            self.module = None
            f32, grad_off = True, torch.no_grad

        def fused(x):
            with grad_off(), full_precision_matmuls(f32):
                y = _body(x)
                if output == "argmax" and y.ndim > 1:
                    return y.argmax(dim=-1).to(torch.int32)
                return y

        #: the step's whole computation run eagerly, without a graph: what
        #: every bucket's capture records, and the yardstick of a replay
        self.forward = fused
        # aot=True: the executable cache is authoritative even with
        # profiling off — that cache IS the warm-start story
        self._pf = telemetry.profiler.wrap(fused, tag, aot=True)
        self._host: dict = {}      # bucket -> pinned (bucket, *row) buffer
        self._host_lock = threading.Lock()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    @classmethod
    def from_pipeline(cls, pipeline, *, input_col: str = "features",
                      score_col: Optional[str] = None, row_shape=(),
                      in_dtype=np.float32,
                      policy: Optional[BucketPolicy] = None,
                      output: str = "argmax",
                      decode: Optional[Callable] = None,
                      encode: Optional[Callable] = None,
                      tag: str = "serving.pipeline",
                      device: str = "cuda") -> "FusedServingStep":
        """A whole PIPELINE as the fused step body: every stage of
        ``pipeline`` (a ``PipelineModel``) must expose a capture
        (core/capture.py — uncapturable stages raise), and the composed
        featurize -> predict function is captured as ONE CUDA graph per
        bucket, bundle-restorable like any model step — a serving worker
        loads the pipeline composite warm. ``input_col`` is the wire
        column the decoded payload feeds; ``score_col`` the pipeline
        output column served (default: ``scores``/``probability``/
        ``prediction``, first match, else the last produced column)."""
        from ...core import capture as capturelib
        stages = tuple(pipeline.getOrDefault("stages"))
        seg = capturelib.whole_pipeline_capture(stages, [input_col])
        if list(seg.in_names) != [input_col]:
            raise ValueError(
                f"pipeline serving composites take ONE wire column "
                f"({input_col!r}); this pipeline also reads "
                f"{[n for n in seg.in_names if n != input_col]}")
        if score_col is None:
            score_col = next((c for c in ("scores", "probability",
                                          "prediction")
                              if c in seg.out_names), seg.out_names[-1])
        body, params = capturelib.segment_body(seg, score_col)
        dev = resolve_device(device, "FusedServingStep")
        params_dev = capturelib.place_segment_params(seg, dev)
        step = cls(None, params, policy=policy, row_shape=row_shape,
                   in_dtype=in_dtype, output=output, decode=decode,
                   encode=encode, tag=tag, device=device,
                   _body=lambda x: body(params_dev, (x,)))
        step.pipeline = pipeline
        step.bundle_kind = "pipeline"
        step.input_col = input_col
        step.score_col = score_col
        return step

    # ---- warmup / bundle surface ----
    def bucket_spec(self, bucket: int):
        """The abstract wire input of one bucket (the graph's signature)."""
        return telemetry.profiler.TensorSpec(
            (bucket,) + self.row_shape, self._wire_dtype, self.device)

    def compile_bucket(self, bucket: int):
        """Capture one bucket's graph (no-op when cached); returns its
        executable (a ``profiler.GraphExec`` on CUDA)."""
        spec = self.bucket_spec(bucket)
        fresh = not self._pf.is_cached(spec)
        ex = self._pf.aot_compile(spec)
        if fresh:
            _m_aot_compiles.inc()
        return ex

    def compile_buckets(self) -> int:
        """Capture every bucket of the policy ahead of live traffic (the
        startup path when no bundle exists; also the bundle build).
        Returns the number of graphs actually captured."""
        n = 0
        for b in self.policy.buckets:
            if not self._pf.is_cached(self.bucket_spec(b)):
                self.compile_bucket(b)
                n += 1
        return n

    def preload_bucket(self, bucket: int):
        """Capture one bucket for a serving bundle (the warm path a
        restarted worker takes): no compile is counted."""
        return self._pf.preload((self.bucket_spec(bucket),))

    def warm_buckets(self) -> list:
        """Buckets whose graph is already captured (warm telemetry for
        /healthz and tests)."""
        return [b for b in self.policy.buckets
                if self._pf.is_cached(self.bucket_spec(b))]

    def executable(self, bucket: int):
        """The captured executable of ``bucket``, or None."""
        return self._pf.executable(self.bucket_spec(bucket))

    def compiles(self) -> int:
        """Graph captures this step has counted (warm-restart tests assert
        this stays flat across a bundle-loaded restart)."""
        return self._pf.compiles

    # ---- the hot path ----
    #: the engine may pass per-request phase ledgers (ledgers=) — step
    #: doubles without this attribute get the bare two-arg call
    accepts_ledgers = True

    def _host_buffer(self, bucket: int):
        import torch
        buf = self._host.get(bucket)
        if buf is None:
            buf = self._host[bucket] = torch.zeros(
                (bucket,) + self.row_shape, dtype=self._wire_dtype,
                pin_memory=self.device.type == "cuda")
        return buf

    def score_rows(self, rows: np.ndarray, bucket: int,
                   ledgers=None) -> np.ndarray:
        """(n, *row_shape) wire rows -> (n, ...) outputs via ONE padded
        bucket replay. ``ledgers`` (one per row, from the serving engine)
        get pad / device / readback phase stamps; the stream wait between
        the device and readback stamps splits device execution from the
        copy back but adds no wall time: the copy would have waited for
        the same replay anyway."""
        import torch
        n = len(rows)
        if n > bucket:
            raise ValueError(f"{n} rows exceed bucket {bucket}")
        spec = self.bucket_spec(bucket)
        ex = self._pf.executable(spec)
        if ex is not None:
            _m_cache_hits.inc()
        else:
            _m_cache_misses.inc()
            log.warning("serving bucket %d captured on live traffic "
                        "(warmup/bundle did not cover it)", bucket)
            ex = self._pf.aot_compile(spec)
        with self._host_lock:
            # the pinned pad buffer is reused: this lock holds it until
            # the copy into the graph's static input has been read back
            hb = self._host_buffer(bucket)
            hb[:n] = torch.from_numpy(
                np.ascontiguousarray(rows, dtype=self.in_dtype))
            hb[n:] = 0
            if ledgers:
                t = time.perf_counter_ns()
                for led in ledgers:
                    led.mark("pad", t)
            with (torch.cuda.stream(self._stream) if self._stream
                  is not None else contextlib.nullcontext()):
                y = ex(hb)
                if ledgers:
                    if self._stream is not None:
                        self._stream.synchronize()
                    t = time.perf_counter_ns()
                    for led in ledgers:
                        led.mark("device", t)
                out = y[:n].cpu().numpy()
        if ledgers:
            t = time.perf_counter_ns()
            for led in ledgers:
                led.mark("readback", t)
        return out

    def __call__(self, values: list, bucket: Optional[int] = None) -> list:
        """Payload strings -> reply strings (decode -> pad -> one
        replay -> unpad -> encode)."""
        rows = np.stack([self.decode(v) for v in values])
        out = self.score_rows(rows,
                              bucket or self.policy.bucket_for(len(values)))
        return [self.encode(y) for y in out]

"""Whole-pipeline capture: cross-stage fusion for PipelineModel, the port of
``mmlspark_tpu/core/capture.py``.

A ``Pipeline`` of N stages runs N transforms with a host-numpy columnar
round trip between every pair, so a featurize -> predict chain pays N
dispatches plus host <-> device copies that one program would not need.
This module composes the stages instead:

* every ``Transformer``/``Model`` may expose a :class:`StageCapture` — its
  device computation as a function of device tensors
  (``capture(columns)``); host-only stages (``UDFTransformer``,
  ``Repartition``, ``Cacher``, ...) say so with the ``_uncapturable =
  True`` class marker;
* :func:`run_fused_pipeline` composes consecutive capturable stages into
  **maximal fused segments**. Each segment is one function over device
  tensors, run through :class:`~..telemetry.profiler.ProfiledFunction`'s
  executable cache (``wrap(fn, tag, aot=True)``): on a CUDA device ONE
  CUDA graph per abstract signature (row count, dtypes), all graphs of a
  segment in one memory pool; on the CPU the function itself, cached once
  it has run. Tensors stay on the device across stage boundaries inside a
  segment, and the intermediate columns a later stage drops never return
  to the host;
* the fused segment callable is also the serving composite:
  ``io/serving``'s ``FusedServingStep.from_pipeline`` builds its body from
  :func:`segment_body` and captures one graph per bucket, and a pipeline
  bundle restores them warm;
* the fit side (:class:`FitCapturePlan`, :func:`compose_fit_capture`):
  the featurize prefix of a ``Pipeline.fit`` composed into one body that
  the learner folds into its training step or binning slab, so raw
  wire-dtype rows are the only fit-time upload.

Capture contract (``StageCapture``): ``fn(params, inputs) -> outputs`` is a
pure, sync-free function of device tensors — no ``.item()``, boolean-mask
indexing, ``nonzero`` or host-sized loop, since a CUDA graph cannot
capture them — with ``params`` the stage's constants placed on the
segment's device (``{}`` when none), ``inputs`` a tuple of column tensors
aligned with ``capture.inputs``, returning a tuple aligned with
``capture.outputs``. ``drops`` removes columns (Select/Drop/Rename);
unmentioned columns pass through on the host, untouched.

Device dtypes follow the JAX package, which runs without 64-bit types: a
column or constant uploads float64 -> float32 and int64 -> int32 (the
cast runs on the host, so the upload moves the narrow bytes), and the
segment computes in those. ``host_cast`` widens an output again at
readback (prediction columns stay float64, as the staged path gives
them).
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Optional, Sequence

import numpy as np

from .. import telemetry
from .utils import get_logger

log = get_logger("pipeline")

_m_segments = telemetry.registry.gauge(
    "mmlspark_pipeline_segments",
    "fused segments in the last fused PipelineModel.transform plan")
_m_fused_dispatches = telemetry.registry.counter(
    "mmlspark_pipeline_fused_dispatches_total",
    "fused-segment device dispatches (one per segment execution — the "
    "staged path would have paid one per stage)")
_m_staged_stages = telemetry.registry.counter(
    "mmlspark_pipeline_staged_stage_transforms_total",
    "stages executed via their own transform inside a fused "
    "PipelineModel.transform (uncapturable, ineligible inputs, or a "
    "segment of one)")
_m_fallbacks = telemetry.registry.counter(
    "mmlspark_pipeline_fusion_fallbacks_total",
    "planned fused segments that fell back to staged execution at "
    "encode time (a column the cheap planner predicate accepted turned "
    "out not to be device-encodable, e.g. ragged rows)")
_m_transfer = telemetry.registry.counter(
    "mmlspark_pipeline_transfer_bytes_total",
    "host<->device bytes moved at fused-segment boundaries; within a "
    "segment stage-to-stage traffic is zero by construction. phase="
    "transform counts PipelineModel.transform segments, phase=fit the "
    "fused featurize->train fit path (raw wire-dtype rows in, learner "
    "state out)",
    labels=("direction", "phase"))
_m_fit_fused = telemetry.registry.counter(
    "mmlspark_fit_fused_dispatches_total",
    "fused featurize->train device dispatches on the fit side (one per "
    "train step / scan window step / binning slab whose featurization ran "
    "inside the consumer's own dispatch)")
_m_fit_fallbacks = telemetry.registry.counter(
    "mmlspark_fit_fusion_fallbacks_total",
    "Pipeline.fit calls that requested fusePipeline but fell back to "
    "the staged fit (uncapturable prefix stage, non-encodable raw "
    "column, or a learner that declined the fused plan)")


def count_fit_transfer(direction: str, nbytes) -> None:
    """Account fit-side host<->device traffic under phase="fit" (the
    trainer's raw-row uploads and the GBDT fused-binning slabs)."""
    _m_transfer.labels(direction=direction, phase="fit").inc(float(nbytes))


class StageCapture:
    """A stage's device computation as a function of device tensors.

    ``fn(params, inputs)``: pure and sync-free; ``inputs`` aligned with
    :attr:`inputs`, returns value(s) aligned with :attr:`outputs`.
    ``params`` is the host-side constant tree (numpy arrays, tensors,
    Python scalars; it keys the segment cache and the fit digest);
    ``place(params, device)`` puts it on the segment's device (default
    :func:`place_tree`) — a stage whose weights already live on the
    device passes its own. ``drops`` names columns the stage removes.
    ``host_cast`` maps output columns to a numpy dtype applied at
    readback. ``finalize`` is an optional host-side ``df -> df`` hook
    applied after the segment's frame is rebuilt (column-metadata
    tagging — SparkSchema score kinds)."""

    __slots__ = ("fn", "inputs", "outputs", "params", "drops",
                 "host_cast", "finalize", "tag", "place")

    def __init__(self, fn: Callable, inputs: Sequence[str] = (),
                 outputs: Sequence[str] = (), *, params: Any = None,
                 drops: Sequence[str] = (),
                 host_cast: Optional[dict] = None,
                 finalize: Optional[Callable] = None, tag: str = "",
                 place: Optional[Callable] = None):
        self.fn = fn
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)
        self.params = {} if params is None else params
        self.drops = tuple(drops)
        self.host_cast = dict(host_cast or {})
        self.finalize = finalize
        self.tag = tag
        self.place = place or place_tree


# ------------------------------------------------------------ param trees

def tree_flatten(tree) -> tuple:
    """``(structure, leaves)`` of a param tree in the JAX package's leaf
    order: dict keys sorted, lists and tuples in order, ``None`` an empty
    subtree (no leaf); everything else is a leaf."""
    leaves: list = []

    def walk(v):
        if isinstance(v, dict):
            keys = sorted(v)
            return ("dict", tuple(keys), tuple(walk(v[k]) for k in keys))
        if isinstance(v, (list, tuple)):
            return (type(v).__name__, tuple(walk(x) for x in v))
        if v is None:
            return ("none",)
        leaves.append(v)
        return ("*",)
    return walk(tree), leaves


def tree_map(fn, tree):
    """``tree`` with every leaf (in :func:`tree_flatten`'s sense) replaced
    by ``fn(leaf)``; containers keep their type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def wire_array(a: np.ndarray) -> np.ndarray:
    """A host array in the device dtype the JAX package would give it:
    float64 -> float32, int64 -> int32, wider unsigned -> int64 (torch's
    unsigned types past uint8 have few kernels); contiguous."""
    k, size = a.dtype.kind, a.dtype.itemsize
    if k == "f" and size == 8:
        a = a.astype(np.float32)
    elif k == "i" and size == 8:
        a = a.astype(np.int32)
    elif k == "u" and size > 1:
        a = a.astype(np.int64)
    a = np.ascontiguousarray(a)
    # torch.from_numpy wants a writable array (a JAX-made state is not)
    return a if a.flags.writeable else a.copy()


def meta_batch(raws) -> tuple:
    """Two rows of each raw column as tensors on the meta device (shapes
    and dtypes, no data): what a featurize body runs on to give the shapes
    of its outputs."""
    import torch
    return tuple(torch.empty((2,) + a.shape[1:],
                             dtype=torch.from_numpy(a[:0]).dtype,
                             device="meta") for a in raws)


def upload(a: np.ndarray, device):
    """A host array (already :func:`wire_array`-cast) as a tensor on
    ``device``: through pinned memory, without blocking, on a card."""
    import torch
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _place_leaf(v, device):
    import torch
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.float64:
            v = v.float()
        elif v.dtype == torch.int64:
            v = v.int()
        return v.to(device)
    if isinstance(v, (bool, np.bool_)):
        return torch.tensor(bool(v), device=device)
    if isinstance(v, (int, np.integer)):
        return torch.tensor(int(v), dtype=torch.int32, device=device)
    if isinstance(v, (float, np.floating)):
        return torch.tensor(float(v), dtype=torch.float32, device=device)
    arr = np.asarray(v)
    if arr.dtype.kind not in "biuf":
        return v
    return torch.from_numpy(wire_array(arr)).to(device)


def place_tree(tree, device):
    """A host param tree on ``device`` in device dtypes (the port's
    ``jax.device_put``): arrays and tensors as tensors, Python scalars as
    0-d tensors, anything else as it is."""
    return tree_map(lambda v: _place_leaf(v, device), tree)


# ------------------------------------------------------------- host encoding

def encodable(col: np.ndarray) -> bool:
    """Cheap planning predicate: can this column feed the device?
    (Numeric arrays; object columns of numeric vectors/scalars. The
    authoritative check is :func:`encode_column` — ragged rows pass
    here and fall back there.)"""
    if col.dtype.kind in "biuf":
        return True
    if col.dtype.kind != "O":
        return False
    if len(col) == 0:
        return True
    v = col[0]
    if isinstance(v, np.ndarray):
        return v.dtype.kind in "biuf"
    if isinstance(v, (list, tuple)):
        return len(v) == 0 or isinstance(v[0], (int, float, np.number))
    return isinstance(v, (int, float, np.number)) \
        and not isinstance(v, bool)


def encode_column(col: np.ndarray) -> Optional[np.ndarray]:
    """Column -> device-feedable host array in its device dtype (None when
    it has no device encoding). Numeric columns ship as they are, narrowed
    by :func:`wire_array`; object columns of fixed-shape numeric vectors
    become the (n, d) float32 matrix (the TorchModel wire convention,
    ``core.utils.to_float32_matrix``)."""
    if col.dtype.kind in "biuf":
        return wire_array(col)
    if col.dtype.kind != "O":
        return None
    from .utils import to_float32_matrix
    try:
        return wire_array(to_float32_matrix(col))
    except (ValueError, TypeError):
        return None


def decode_column(arr: np.ndarray) -> np.ndarray:
    """Device output -> DataFrame column (2D+ becomes an object column
    of per-row vectors, the frame's canonical vector form)."""
    if arr.ndim <= 1:
        return arr
    from .utils import object_column
    return object_column(arr)


# ------------------------------------------------------------- fused runner

class _Segment:
    """One maximal run of capturable stages + its name-flow plan."""

    __slots__ = ("pairs", "in_names", "out_names", "names", "host_cast",
                 "renamed")

    def __init__(self, pairs, df_columns):
        self.pairs = list(pairs)          # [(stage, capture), ...]
        produced: set = set()
        in_names: list = []
        names = list(df_columns)          # running column order
        host_cast: dict = {}
        renamed: dict = {}                # output -> the input it renames
        for _, cap in self.pairs:
            if cap.tag == "rename":
                src = cap.inputs[0]
                if src in renamed or src not in produced:
                    renamed[cap.outputs[0]] = renamed.pop(src, src)
            for i in cap.inputs:
                if i not in produced and i not in in_names:
                    in_names.append(i)
            for d in cap.drops:
                if d in names:
                    names.remove(d)
                produced.discard(d)
            for o in cap.outputs:
                if o not in names:
                    names.append(o)
                produced.add(o)
            if cap.tag == "rename" and cap.inputs[0] in host_cast:
                # a renamed column keeps its readback dtype
                host_cast[cap.outputs[0]] = host_cast.pop(cap.inputs[0])
            host_cast.update(cap.host_cast)
        self.in_names = in_names
        self.names = names
        self.out_names = [n for n in names if n in produced]
        self.host_cast = host_cast
        self.renamed = renamed


def _param_key(tree) -> tuple:
    """Cache-validity key for a segment's capture params: array leaves
    by identity (the framework-wide convention — updating weights means
    a NEW tree, TorchModel.setModelParams), scalar leaves by value (a
    fresh ``[0.5]`` fills list every transform must still hit)."""
    structure, leaves = tree_flatten(tree)
    return (structure,
            tuple(x if isinstance(x, (int, float, str, bool, bytes,
                                      type(None)))
                  else id(x) for x in leaves))


def _compose(caps, in_names):
    """The composed body of ``caps``: ``run(param_tuple, arrays) -> cols``
    threading the running column map stage by stage."""
    fns = [(c.fn, c.inputs, c.drops, c.outputs) for c in caps]
    in_names = list(in_names)

    def run(param_tuple, arrays):
        cols = dict(zip(in_names, arrays))
        for (fn, inputs, drops, outputs), p in zip(fns, param_tuple):
            vals = fn(p, tuple(cols[i] for i in inputs))
            if not isinstance(vals, (tuple, list)):
                vals = (vals,)
            for d in drops:
                cols.pop(d, None)
            cols.update(zip(outputs, vals))
        return cols
    return run


def _placed(caps, device) -> tuple:
    return tuple(c.place(c.params, device) for c in caps)


def _segment_program(owner, seg: _Segment, seg_index: int, device):
    """The ONE program of a segment on ``device`` — a
    ``ProfiledFunction`` with the AOT cache, so each new row count is a
    counted capture (``compiles``, with its cause) — cached on the owning
    PipelineModel. Capture params are placed once per (segment,
    params-identity): re-shipping model weights per transform would
    dominate small-batch latency."""
    import torch

    from ..models.torch_model import full_precision_matmuls
    caps = [c for _, c in seg.pairs]
    # simple (jsonable) params pin the computation: a config change that
    # alters the capture without renaming columns (e.g.
    # DataConversion.convertTo) must not reuse a stale program
    key = (tuple(s.uid for s, _ in seg.pairs),
           tuple(repr(sorted(s._jsonParams().items()))
                 for s, _ in seg.pairs),
           tuple(seg.in_names), tuple(seg.out_names), str(device))
    cache = owner.__dict__.get("_seg_cache")
    if cache is None:
        cache = owner._seg_cache = {}
    entry = cache.get(key)
    params = tuple(c.params for c in caps)
    if entry is None or entry["param_ids"] != _param_key(params):
        run = _compose(caps, seg.in_names)
        out_names = list(seg.out_names)
        params_dev = _placed(caps, device)

        def seg_fn(*arrays):
            # products in full float32 (TF32 off), as the staged stages
            # compute them; a graph keeps the choice it was captured with
            with torch.no_grad(), full_precision_matmuls(True):
                cols = run(params_dev, arrays)
                return tuple(cols[n] for n in out_names)

        tag = f"pipeline.seg{seg_index}.{getattr(owner, 'uid', 'anon')}"
        entry = {"pf": telemetry.profiler.wrap(seg_fn, tag, aot=True),
                 "param_ids": _param_key(params)}
        cache[key] = entry
    return entry["pf"]


def _run_segment(owner, seg: _Segment, df, seg_index: int, device):
    """Execute one fused segment: encode inputs, ONE device dispatch,
    decode outputs, rebuild the frame (pass-through columns keep their
    values and metadata; produced columns land in staged order)."""
    from .dataframe import DataFrame
    arrays = []
    for n in seg.in_names:
        a = encode_column(df.col(n))
        if a is None:       # the cheap planner predicate over-promised
            _m_fallbacks.inc()
            log.warning("fused segment fell back to staged execution: "
                        "column %r is not device-encodable", n)
            cur = df
            for stage, _ in seg.pairs:
                _m_staged_stages.inc()
                cur = stage.transform(cur)
            return cur
        arrays.append(a)
    pf = _segment_program(owner, seg, seg_index, device)
    _m_transfer.labels(direction="in", phase="transform").inc(
        float(sum(a.nbytes for a in arrays)))
    with telemetry.trace.span("pipeline/segment", stages=len(seg.pairs),
                              rows=len(df)):
        outs = pf(*(upload(a, device) for a in arrays))
        outs = [o.cpu().numpy() for o in outs]
    _m_fused_dispatches.inc()
    _m_transfer.labels(direction="out", phase="transform").inc(
        float(sum(o.nbytes for o in outs)))
    outmap = dict(zip(seg.out_names, outs))
    produced_meta = _segment_metadata(seg, df)
    data, meta = {}, {}
    for n in seg.names:
        if n in outmap:
            arr = outmap[n]
            if n in seg.host_cast:
                arr = arr.astype(seg.host_cast[n])
            elif n in seg.renamed and df.col(seg.renamed[n]).dtype.kind \
                    in "biuf":
                # a renamed input column reads back in its own dtype
                arr = arr.astype(df.col(seg.renamed[n]).dtype)
            data[n] = decode_column(arr)
            m = produced_meta.get(n)
        else:
            data[n] = df.col(n)
            m = df.metadata(n)
        if m:
            meta[n] = m
    return DataFrame(data, metadata=meta, npartitions=df.npartitions)


def _segment_metadata(seg: _Segment, df) -> dict:
    """The column metadata the staged chain would leave on the segment's
    produced columns: each capture's ``finalize`` tags (applied to a
    one-row probe of its outputs), carried through later renames and
    dropped with their columns; a rename of an input column carries the
    input's metadata."""
    from .dataframe import DataFrame
    meta: dict = {}
    for _, cap in seg.pairs:
        if cap.tag == "rename":
            src = cap.inputs[0]
            m = meta.pop(src) if src in meta else df.metadata(src)
            if m:
                meta[cap.outputs[0]] = m
        for d in cap.drops:
            meta.pop(d, None)
        if cap.finalize is not None:
            probe = cap.finalize(DataFrame(
                {o: np.zeros(1) for o in cap.outputs}))
            for o in cap.outputs:
                m = probe.metadata(o)
                if m:
                    meta[o] = m
    return meta


def stage_capture(stage, columns) -> Optional[StageCapture]:
    """A stage's capture for the given column-name schema, honoring the
    explicit ``_uncapturable`` marker; None when the stage cannot (or
    declines to) describe its computation."""
    if getattr(type(stage), "_uncapturable", False):
        return None
    cap_fn = getattr(stage, "capture", None)
    if cap_fn is None:
        return None
    return cap_fn(list(columns))


def segment_device(owner, stages):
    """The torch device a pipeline's fused segments run on: the owner's
    ``device`` param where the caller set it, else the device of the
    first stage that names one (a fitted booster or net keeps its fit's),
    else "cuda". Asking for CUDA where there is none raises."""
    from .env import resolve_device
    name = None
    if owner is not None and owner.hasParam("device") \
            and owner.isSet("device"):
        name = owner.getOrDefault("device")
    for stage in stages if name is None else ():
        if stage.hasParam("device") and stage.isSet("device"):
            name = stage.getOrDefault("device")
            break
    return resolve_device(name or "cuda", "fused pipeline")


def run_fused_pipeline(owner, stages, df):
    """``PipelineModel.transform`` with cross-stage fusion: walk the
    stages left-to-right, accumulating consecutive capturable stages
    (whose capture inputs are device-encodable under the running schema)
    into maximal segments; each segment of >= 2 stages runs as ONE
    program, everything else runs its own ``transform``. Uncapturable
    stages therefore split segments at prefix/middle/suffix positions and
    the plan degrades gracefully to the staged chain."""
    cur = df
    pending: list = []
    schema = {n: encodable(df.col(n)) for n in df.columns}
    segments = 0
    device = None

    def flush():
        nonlocal cur, pending, segments, device
        if not pending:
            return
        if len(pending) >= 2:
            if device is None:
                device = segment_device(owner, stages)
            seg = _Segment(pending, list(cur.columns))
            cur = _run_segment(owner, seg, cur, segments, device)
            segments += 1
        else:
            for stage, _ in pending:
                _m_staged_stages.inc()
                cur = stage.transform(cur)
        pending = []

    for stage in stages:
        cap = stage_capture(stage, list(schema))
        if cap is not None and all(schema.get(i, False)
                                   for i in cap.inputs):
            pending.append((stage, cap))
            for d in cap.drops:
                schema.pop(d, None)
            for o in cap.outputs:
                schema[o] = True
        else:
            flush()
            _m_staged_stages.inc()
            cur = stage.transform(cur)
            schema = {n: encodable(cur.col(n)) for n in cur.columns}
    flush()
    _m_segments.set(segments)
    return cur


def whole_pipeline_capture(stages, input_cols: Sequence[str]):
    """One :class:`_Segment` covering EVERY stage, or raise — the serving
    composite's contract (``FusedServingStep.from_pipeline``): a bundle
    must not silently serve a half-fused pipeline. ``input_cols`` seed
    the schema (all assumed device-encodable wire inputs)."""
    schema = {n: True for n in input_cols}
    pairs = []
    for stage in stages:
        cap = stage_capture(stage, list(schema))
        if cap is None:
            raise ValueError(
                f"stage {type(stage).__name__} ({stage.uid}) is not "
                f"capturable; a pipeline serving composite needs every "
                f"stage to expose a capture")
        missing = [i for i in cap.inputs if not schema.get(i, False)]
        if missing:
            raise ValueError(
                f"stage {type(stage).__name__} reads column(s) {missing} "
                f"that no earlier stage produces and no input column "
                f"provides")
        pairs.append((stage, cap))
        for d in cap.drops:
            schema.pop(d, None)
        for o in cap.outputs:
            schema[o] = True
    return _Segment(pairs, list(input_cols))


def segment_body(seg: _Segment, out_name: str):
    """``(body(params, cols_tuple) -> out tensor, params)`` for a serving
    composite built over ``seg``: the whole-pipeline function the fused
    serving step captures per bucket. ``params`` is the host tree; place
    it with :func:`place_segment_params`."""
    if out_name not in seg.out_names:
        raise ValueError(f"pipeline produces {seg.out_names}, not "
                         f"{out_name!r}")
    caps = [c for _, c in seg.pairs]
    run = _compose(caps, seg.in_names)

    def body(param_tuple, arrays):
        return run(param_tuple, arrays)[out_name]

    return body, tuple(c.params for c in caps)


def place_segment_params(seg: _Segment, device) -> tuple:
    """The capture params of every stage of ``seg`` on ``device``."""
    return _placed([c for _, c in seg.pairs], device)


# ------------------------------------------------------------- fit-side plan

class FitCapturePlan:
    """The featurize prefix of a ``Pipeline.fit``, composed into ONE
    ``body(param_tuple, raw_arrays) -> (xb, yb)`` over device tensors.

    Built by :func:`compose_fit_capture` when EVERY stage ahead of the
    final estimator captures; the learner folds :meth:`body` into its
    per-step work (train step, scan window step, or GBDT binning slab), so
    raw wire-dtype rows are the only fit-time H2D traffic and the
    intermediate featurized columns never exist on the host.

    ``params`` are fit-constants (fill values, conversion targets —
    computed once, before training): checkpoints store learner state
    only and record :meth:`digest` in the manifest so a resume can
    verify it re-enters the *same* featurization bit-exact.

    ``fitted`` holds the prefix stages as they would appear in the
    resulting ``PipelineModel`` (transformers as-is, estimators as their
    fitted models) — also the staged-fallback executor
    (:meth:`apply_staged`). ``metadata`` carries column metadata a stage
    chose to surface without staging (``capture_metadata`` hook — the
    assembled categorical slot ranges GBDT reads)."""

    __slots__ = ("pairs", "fitted", "in_names", "features_col",
                 "label_col", "params", "metadata", "_run", "_placed")

    def __init__(self, pairs, fitted, df_columns, features_col: str,
                 label_col: str, metadata: Optional[dict] = None):
        self.pairs = list(pairs)
        self.fitted = list(fitted)
        seg = _Segment(self.pairs, df_columns)
        in_names = list(seg.in_names)
        produced = set()
        for _, cap in self.pairs:
            produced.update(cap.outputs)
        for need in (features_col, label_col):
            # raw pass-through targets (an untouched label column) ride
            # along as extra wire inputs
            if need not in produced and need not in in_names:
                in_names.append(need)
        self.in_names = in_names
        self.features_col = features_col
        self.label_col = label_col
        self.params = tuple(cap.params for _, cap in self.pairs)
        self.metadata = dict(metadata or {})
        self._run = _compose([cap for _, cap in self.pairs], in_names)
        self._placed: dict = {}

    def body(self, param_tuple, arrays):
        """The featurize composition: raw column tensors (one per
        :attr:`in_names` entry, batch-leading) -> ``(xb, yb)``. Computes
        in device dtypes — ``host_cast`` is a readback concern the fit
        side never pays."""
        cols = self._run(param_tuple, arrays)
        return cols[self.features_col], cols[self.label_col]

    # ---- host-side helpers -------------------------------------------
    def encode(self, df) -> Optional[list]:
        """Raw wire arrays for :attr:`in_names` (contiguous, device dtypes
        — narrow ints and bools ship un-widened); None when a column turns
        out not to be device-encodable (caller falls back staged)."""
        arrays = []
        for n in self.in_names:
            a = encode_column(df.col(n))
            if a is None:
                return None
            arrays.append(a)
        return arrays

    def device_params(self, device):
        """The capture params placed on ``device``, once per plan and
        device (fit-constants — re-shipping them per step would cost an
        upload a step)."""
        key = str(device)
        if key not in self._placed:
            self._placed[key] = _placed([c for _, c in self.pairs], device)
        return self._placed[key]

    def apply_staged(self, df):
        """The staged equivalent (fallback path): run every fitted
        prefix stage's own transform."""
        cur = df
        for stage in self.fitted:
            _m_staged_stages.inc()
            cur = stage.transform(cur)
        return cur

    def key(self) -> tuple:
        """Identity key for caching the fused program wrapper — same
        convention as :func:`_segment_program` (stage uids + json params
        pin the structure, ``_param_key`` pins the constant leaves)."""
        return (tuple(s.uid for s, _ in self.pairs),
                tuple(repr(sorted(s._jsonParams().items()))
                      for s, _ in self.pairs),
                tuple(self.in_names), self.features_col, self.label_col,
                _param_key(self.params))

    def digest(self) -> str:
        """Content hash over the plan's structure AND param bytes —
        recorded in checkpoint manifests so resume verifies the fused
        featurization is byte-identical to the one that produced the
        checkpoint (fill values recomputed over different data would
        silently change the model being trained). The JAX package's hex
        for the same plan: a checkpoint directory resumes in either."""
        h = hashlib.sha256()
        for stage, _ in self.pairs:
            h.update(type(stage).__name__.encode())
            h.update(repr(sorted(stage._jsonParams().items())).encode())
        h.update(("|".join(self.in_names) + "->" + self.features_col
                  + "," + self.label_col).encode())
        for leaf in tree_flatten(self.params)[1]:
            arr = (leaf.detach().cpu().numpy() if hasattr(leaf, "detach")
                   else np.asarray(leaf))
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()


def compose_fit_capture(stages, df, features_col: Optional[str],
                        label_col: Optional[str]):
    """Compose the featurize prefix of a fit into a
    :class:`FitCapturePlan`, or None when it must stay staged.

    Walks ``stages`` (everything ahead of the final learner) like
    :func:`run_fused_pipeline`, but the fused fit only engages when the
    prefix is *fully* capturable — a staged stage in the middle would
    re-materialize the frame and forfeit the raw-wire H2D win, so any
    uncapturable stage (or a capture input that is not device-encodable
    under the running schema) rejects the whole plan.

    Estimator prefix stages (CleanMissingData) use fit-then-capture:
    the staged frame is materialized lazily, only up to the stage being
    fitted, to compute its fit-constants — a one-time host pass, after
    which training runs fused. Transformer-only prefixes stage nothing.
    """
    from .pipeline import Estimator, Transformer
    if not stages or features_col is None or label_col is None:
        return None
    schema = {n: encodable(df.col(n)) for n in df.columns}
    pairs: list = []
    fitted: list = []
    metadata: dict = {}
    staged = {"df": df, "applied": 0}

    def staged_upto(k):
        # lazy staged materialization for fit-then-capture estimators
        while staged["applied"] < k:
            staged["df"] = fitted[staged["applied"]].transform(staged["df"])
            staged["applied"] += 1
        return staged["df"]

    for stage in stages:
        if isinstance(stage, Estimator) and not isinstance(stage,
                                                           Transformer):
            model = stage.fit(staged_upto(len(fitted)))
        else:
            model = stage
        cap = stage_capture(model, list(schema))
        if cap is None or not all(schema.get(i, False)
                                  for i in cap.inputs):
            log.info("fit-side fusion declined: stage %s does not "
                     "capture under the running schema",
                     type(stage).__name__)
            return None
        meta_fn = getattr(model, "capture_metadata", None)
        if meta_fn is not None and cap.outputs:
            m = meta_fn(df)
            if m:
                metadata[cap.outputs[0]] = m
        pairs.append((model, cap))
        fitted.append(model)
        for d in cap.drops:
            schema.pop(d, None)
        for o in cap.outputs:
            schema[o] = True
    if not schema.get(features_col, False) \
            or not schema.get(label_col, False):
        log.info("fit-side fusion declined: %r/%r not produced by the "
                 "prefix and not device-encodable in the raw frame",
                 features_col, label_col)
        return None
    return FitCapturePlan(pairs, fitted, list(df.columns), features_col,
                          label_col, metadata=metadata)

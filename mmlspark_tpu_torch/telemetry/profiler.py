"""Device-level profiling: FLOP and byte counts, signature accounting,
device memory.

The port of ``mmlspark_tpu/telemetry/profiler.py``. It answers *why* a
step is slow, which the span tracer alone cannot:

  * **FLOPs / bytes per call** — counted once for each new argument
    signature (the shapes, dtypes and devices of the tensors handed in:
    the port's analog of a compile) and cached for later calls. The count
    runs the call once under ``torch.utils.flop_counter.FlopCounterMode``
    (matmul-class FLOPs of every torch op, backward and checkpoint
    recomputes included) and under a byte-counting dispatch mode (the
    tensors each non-view op reads and writes). The port's own CUDA
    kernels are bound through ``ctypes`` and are invisible to both modes,
    so each kernel wrapper reports its analytic FLOPs and bytes through
    :func:`note_kernel` while a count is running;
  * **roofline attribution** — later calls are timed to completion (a
    wait on the stream that produced the output, never a device-wide
    synchronize), giving achieved FLOP/s and a share of the card's peak;
  * **signature accounting** — new signatures count under the JAX
    package's compile metric names, with their cause (first |
    shape_change | dtype_change);
  * **device memory gauges** — :func:`sample_live_buffers` reads
    ``torch.cuda.memory_allocated`` (current) and
    ``max_memory_allocated`` (peak) of the device, in place of the JAX
    package's ``jax.live_arrays()`` walk. On the CPU, where torch keeps no
    allocator statistics, the sample is the bytes of the profiled call's
    own argument and result tensors.

The peak table holds the H100 only, keyed on
``torch.cuda.get_device_name()``: NVIDIA's published dense bf16 peak,
989 TFLOP/s. Another card takes :func:`set_peak_flops`, else its roofline
gauge reads NaN: the profiler does not guess a card's peak. The CPU keeps
the JAX package's order-of-magnitude heuristic, so the tests can read the
gauge.

Off by default, independent of the span tracer's switch:
``profiler.enable()`` (which also enables telemetry — the gauges live in
the shared registry) or ``TorchLearner(profile=True)``. A disabled
:class:`ProfiledFunction` call is one attribute check and the plain call.

**AOT executables** (``wrap(fn, tag, aot=True)``): the serving engine's
warm-start cache, kept even while profiling is off. In the port the
"executable" of an abstract signature (shapes, dtypes, devices) is a
``torch.cuda.CUDAGraph`` captured for it (:class:`GraphExec`): a warm-up
run on a side stream first (it builds and loads the kernels), then one
capture, serialised process-wide and in ``thread_local`` error mode.
:meth:`ProfiledFunction.aot_compile` captures ahead of traffic,
:meth:`~ProfiledFunction.preload` captures for a serving bundle without
counting a compile, :meth:`~ProfiledFunction.is_cached` says whether a
call would replay, and ``compiles`` counts captures. A kernel wrapper's
launch count (:func:`count_launch`) and FLOP report (:func:`note_kernel`)
run in Python, which a replay skips: a capture records them instead of
counting, and every replay counts them again. On the CPU there is no
graph: a signature is cached once it has run once (:class:`EagerExec`),
so the counters keep their meaning in the CPU tests.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

from .registry import REGISTRY

_m_compiles = REGISTRY.counter(
    "mmlspark_profiler_compiles",
    "new argument signatures of profiled functions (each one counted for "
    "FLOPs and bytes once), by function tag and cause (first | "
    "shape_change | dtype_change)", labels=("fn", "cause"))
_m_compile_seconds = REGISTRY.counter(
    "mmlspark_profiler_compile_seconds",
    "cumulative wall seconds of the counted first calls of new signatures",
    labels=("fn",))
_m_flops = REGISTRY.gauge(
    "mmlspark_profiler_flops_per_call",
    "FLOPs of one call of the profiled function (torch ops plus the "
    "port's kernels)", labels=("fn",))
_m_bytes = REGISTRY.gauge(
    "mmlspark_profiler_bytes_per_call",
    "bytes read and written by one call (torch ops plus the port's "
    "kernels)", labels=("fn",))
_m_achieved = REGISTRY.gauge(
    "mmlspark_profiler_achieved_flops",
    "achieved FLOP/s of the last profiled call (counted FLOPs / measured "
    "wall time to completion)", labels=("fn",))
_m_roofline = REGISTRY.gauge(
    "mmlspark_profiler_roofline_utilization",
    "achieved FLOP/s as a fraction of the device peak (see "
    "set_peak_flops; NaN on a card the peak table does not know)",
    labels=("fn",))
_m_live_bytes = REGISTRY.gauge(
    "mmlspark_profiler_live_buffer_bytes",
    "device bytes allocated by torch at the last sample "
    "(torch.cuda.memory_allocated)")
_m_live_peak = REGISTRY.gauge(
    "mmlspark_profiler_live_buffer_peak_bytes",
    "peak device bytes allocated by torch "
    "(torch.cuda.max_memory_allocated)")


class _PState:
    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = False


_pstate = _PState()
_lock = threading.Lock()
_live_peak = 0.0
_peak_flops_override: Optional[float] = None
_functions: dict = {}      # tag -> ProfiledFunction (for report())

#: dense bf16 peak FLOP/s by CUDA device name prefix (NVIDIA's published
#: H100 SXM figure). Only the H100: the port is measured on no other card
_PEAK_BY_NAME = {"NVIDIA H100": 989e12}

#: the running counts kernel wrappers report into (a list, so the check in
#: note_kernel is one truth test). Process-wide, not per thread: a CUDA
#: backward runs on autograd's device thread, not the thread that counts
_counts: list = []

#: the capture a thread is recording (``_capturing.record``): while set, a
#: kernel wrapper's launch and FLOP report go into it instead of the counts
_capturing = threading.local()
#: one CUDA graph capture at a time in the process
_CAPTURE_LOCK = threading.Lock()


def enabled() -> bool:
    return _pstate.enabled


def enable():
    """Arm profiling (and telemetry — the profiler reports through the
    shared registry and tracer)."""
    from . import enable as telemetry_enable
    telemetry_enable()
    _pstate.enabled = True


def disable():
    _pstate.enabled = False


def set_peak_flops(value: Optional[float]):
    """Pin the roofline peak (FLOP/s) instead of the device-name table."""
    global _peak_flops_override
    _peak_flops_override = value


def peak_flops(device=None) -> float:
    """The roofline denominator for ``device`` ("cuda" where a card is
    present and no device is named): the pinned value, else the table's
    entry for the card's name (NaN for a card it does not list), else on
    the CPU an order-of-magnitude estimate — cores x an assumed 8-wide
    FMA at 3 GHz — so utilization compares across runs on one host."""
    if _peak_flops_override:
        return _peak_flops_override
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        for prefix, peak in _PEAK_BY_NAME.items():
            if name.startswith(prefix):
                return peak
        return math.nan
    import os
    return max(1.0, (os.cpu_count() or 1) * 2 * 8 * 3e9)


def _tensor_bytes(values) -> float:
    from .tracer import _tensors
    return float(sum(t.numel() * t.element_size() for t in _tensors(values)))


def sample_live_buffers(device=None, held=None) -> float:
    """Set the device memory gauges and return the current bytes (0.0 when
    profiling is off). On a CUDA ``device`` the gauges read the caching
    allocator: ``memory_allocated`` now and ``max_memory_allocated`` as
    the peak. Elsewhere the sample is the bytes of ``held`` (a tensor or a
    tuple, list or dict of them), and the peak the largest sample."""
    global _live_peak
    if not _pstate.enabled:
        return 0.0
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        total = float(torch.cuda.memory_allocated(dev))
        peak = float(torch.cuda.max_memory_allocated(dev))
    else:
        total = _tensor_bytes(held)
        peak = None
    _m_live_bytes.set(total)
    with _lock:
        _live_peak = max(_live_peak, total) if peak is None else peak
        _m_live_peak.set(_live_peak)
    return total


def live_buffer_peak() -> float:
    return _live_peak


def _abstract_sig(args) -> tuple:
    """The (shape, dtype, device) signature of every tensor or array in
    ``args`` (a tuple, list or dict nest), other leaves by type: what a
    compiled program would be keyed on, observed host-side."""
    out = []

    def walk(v):
        if isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for k in v:
                walk(v[k])
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            out.append((tuple(v.shape), str(v.dtype),
                        _device_name(getattr(v, "device", "cpu"))))
        elif v is not None:
            out.append(("py", type(v).__name__))
    walk(args)
    return tuple(out)


def _device_name(device) -> str:
    """A device as a signature names it: CUDA always with its index, so a
    :class:`TensorSpec` for "cuda" and a tensor on "cuda:0" agree."""
    name = str(device)
    if name == "cuda":
        import torch
        return f"cuda:{torch.cuda.current_device()}"
    return name


def _diff_cause(prev: Optional[tuple], sig: tuple) -> str:
    if prev is None:
        return "first"
    for a, b in zip(prev, sig):
        if a != b:
            return "dtype_change" if a[0] == b[0] else "shape_change"
    return "shape_change"   # arity changed


def _device_of(args):
    from .tracer import _tensors
    for t in _tensors(args):
        return t.device
    return None


def count_launch(owner, attr: str = "launches",
                 library: Optional[str] = None):
    """Add one to a kernel wrapper's launch count (``owner.attr``, a plain
    integer on the wrapper) where it launches its kernel. Inside a CUDA
    graph capture nothing runs: the launch goes into the capture's record
    instead (with ``library``, the ``ops/_build`` name of the kernel's
    library), and every replay of the graph counts it."""
    rec = getattr(_capturing, "record", None)
    if rec is not None:
        rec.launch(owner, attr, library)
        return
    with _lock:
        setattr(owner, attr, getattr(owner, attr) + 1)


def note_kernel(flops: float, nbytes: float):
    """A kernel wrapper's report of one launch's work (analytic FLOPs and
    bytes), added to every count that is running; inside a capture, kept
    in the capture's record for its replays. One truth test when no count
    is running."""
    rec = getattr(_capturing, "record", None)
    if rec is not None:
        rec.kernels.append((float(flops), float(nbytes)))
        return
    if not _counts:
        return
    with _lock:
        for c in _counts:
            c["flops"] += float(flops)
            c["bytes"] += float(nbytes)


def _bytes_mode(acc: dict):
    """A dispatch mode adding the bytes each non-view torch op reads and
    writes (its tensor arguments and results) to ``acc["bytes"]``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _BytesMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not func.is_view:
                acc["bytes"] += sum(
                    x.numel() * x.element_size()
                    for x in tree_leaves((args, kwargs, out))
                    if hasattr(x, "element_size"))
            return out

    return _BytesMode()


def count_call(fn, args, kwargs=None):
    """Run ``fn(*args, **kwargs)`` once while counting its FLOPs (torch's
    ``FlopCounterMode``) and bytes (every non-view op's tensors), plus what
    the port's kernel wrappers report through :func:`note_kernel`.
    Returns ``(out, {"flops": ..., "bytes": ...})``."""
    from torch.utils.flop_counter import FlopCounterMode
    acc = {"flops": 0.0, "bytes": 0.0}
    with _lock:
        _counts.append(acc)
    try:
        with FlopCounterMode(display=False) as fc, _bytes_mode(acc):
            out = fn(*args, **(kwargs or {}))
    finally:
        with _lock:
            _counts.remove(acc)
    acc["flops"] += float(fc.get_total_flops())
    return out, acc


class TensorSpec:
    """An abstract argument: the shape, dtype and device of a tensor, with
    no data (the port's ``jax.ShapeDtypeStruct``). :meth:`ProfiledFunction
    .aot_compile` takes these for inputs it has not seen yet."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype, device="cpu"):
        import torch
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.device = torch.device(device)

    def zeros(self):
        import torch
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)


class CaptureRecord:
    """What a kernel wrapper did while a graph was captured: its launches
    (``(owner, attr) -> count``), the ``ops/_build`` libraries they came
    from, and its FLOP and byte reports. :meth:`replay` counts them again,
    once per replay of the graph."""

    def __init__(self):
        self.launches: dict = {}
        self.libraries: set = set()
        self.kernels: list = []

    def launch(self, owner, attr: str, library: Optional[str]):
        key = (owner, attr)
        self.launches[key] = self.launches.get(key, 0) + 1
        if library:
            self.libraries.add(library)

    def replay(self):
        if self.launches:
            with _lock:
                for (owner, attr), n in self.launches.items():
                    setattr(owner, attr, getattr(owner, attr) + n)
        for flops, nbytes in self.kernels:
            note_kernel(flops, nbytes)

    def summary(self) -> dict:
        """JSON-able: ``{"launches": {"<wrapper>.<attr>": n},
        "libraries": [...]}`` (what a serving bundle keeps)."""
        launches = {f"{getattr(o, '__name__', type(o).__name__)}.{a}": n
                    for (o, a), n in self.launches.items()}
        return {"launches": dict(sorted(launches.items())),
                "libraries": sorted(self.libraries)}


def _materialize(args):
    return tuple(a.zeros() if isinstance(a, TensorSpec) else a for a in args)


def _map_tensors(fn, value):
    if isinstance(value, tuple):
        return tuple(_map_tensors(fn, v) for v in value)
    if isinstance(value, list):
        return [_map_tensors(fn, v) for v in value]
    if isinstance(value, dict):
        return {k: _map_tensors(fn, v) for k, v in value.items()}
    return fn(value) if hasattr(value, "is_cuda") else value


class EagerExec:
    """The CPU's "executable": the function itself, run eagerly. It exists
    once the signature has run once (its construction runs it);
    ``replays`` counts its calls."""

    record = None

    def __init__(self, fn, args):
        self._fn = fn
        self.replays = 0
        fn(*_materialize(args))

    def __call__(self, *args):
        self.replays += 1
        return self._fn(*args)


class GraphLane:
    """What the graphs of one memory pool share: the pool, one lock, and
    an event marking the end of the last replay. Graphs that share a pool
    may reuse each other's intermediate memory, so their replays must not
    overlap: each takes the lane's lock for its copy-in, replay and
    copy-out, and its stream waits for the previous replay's event."""

    def __init__(self, device=None):
        import torch
        self.pool = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.done = None
        self.device = device


class GraphExec:
    """One ``torch.cuda.CUDAGraph`` captured for one abstract signature.

    Static input buffers of the signature's shapes and dtypes are filled
    from the first real arguments (zeros for :class:`TensorSpec`); the
    function runs ``warmup`` times eagerly on a side stream (the first
    ``ops/_build`` load compiles there, outside any capture), then once
    under capture in ``thread_local`` error mode, serialised with every
    other capture of the process. A call copies its arguments into the
    static inputs on the current stream, replays, and returns clones of
    the static outputs (so the next replay cannot overwrite a result still
    being read). A failed capture raises with the CUDA error."""

    def __init__(self, fn, args, lane: Optional[GraphLane] = None,
                 warmup: int = 1):
        import torch
        args = tuple(args)
        dev = next(a.device for a in args if hasattr(a, "device")
                   and torch.device(a.device).type == "cuda")
        self.device = torch.device(dev)
        self.lane = lane or GraphLane(self.device)
        # normal tensors even under inference mode, so that a call from
        # outside it may still copy into them
        with torch.inference_mode(False):
            self.static_in = tuple(
                (a.zeros() if isinstance(a, TensorSpec)
                 else a.detach().clone()) if hasattr(a, "dtype") else a
                for a in args)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn(*self.static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.graph = torch.cuda.CUDAGraph()
        self.record = CaptureRecord()
        with _CAPTURE_LOCK, self.lane.lock:
            _capturing.record = self.record
            try:
                with torch.cuda.graph(self.graph, pool=self.lane.pool,
                                      capture_error_mode="thread_local"):
                    self.static_out = fn(*self.static_in)
            finally:
                _capturing.record = None
        self.replays = 0

    def __call__(self, *args):
        import torch
        lane = self.lane
        with lane.lock:
            stream = torch.cuda.current_stream(self.device)
            if lane.done is not None:
                stream.wait_event(lane.done)
            for dst, src in zip(self.static_in, args):
                if hasattr(dst, "copy_"):
                    dst.copy_(src, non_blocking=True)
            self.graph.replay()
            out = _map_tensors(lambda t: t.clone(), self.static_out)
            ev = torch.cuda.Event()
            ev.record(stream)
            lane.done = ev
            self.replays += 1
            self.record.replay()
        return out


class ProfiledFunction:
    """A function observed through the profiler.

    Disabled (default): one flag check, then the plain call. Enabled: the
    first call with a new argument signature runs under the counting
    modes (its wall time lands in the compile-seconds counter, its FLOPs
    and bytes in the per-call gauges, cached for the signature); every
    other call is timed to completion — a wait on the current stream of
    each CUDA device its result lives on — which sets the achieved-FLOP/s
    and roofline gauges. Either way the device memory gauges are sampled
    after the call.

    ``aot=True`` keeps an executable cache keyed on the abstract signature
    even while profiling is off: every call runs the signature's
    executable — a CUDA graph replay (:class:`GraphExec`) on a CUDA
    device, the plain function (:class:`EagerExec`) on the CPU — capturing
    it first when the signature is new. Captures count as compiles, with
    their causes, on the JAX package's metric names. ``lane`` is the
    :class:`GraphLane` (memory pool) the graphs share; one is made per
    function by default."""

    def __init__(self, fn, tag: str, aot: bool = False,
                 lane: Optional[GraphLane] = None):
        self._fn = fn
        self.tag = tag
        self.aot = bool(aot)
        self._lane = lane
        self._execs: dict = {}     # sig -> GraphExec | EagerExec (aot)
        self._cache: dict = {}     # sig -> cost
        self._last_sig: Optional[tuple] = None
        self.compiles = 0
        self.compile_seconds = 0.0
        self.calls = 0
        self.last_call_seconds = 0.0
        self.cost = {"flops": 0.0, "bytes": 0.0}
        self.causes: dict[str, int] = {}
        self.device = None
        with _lock:
            _functions[tag] = self

    def _count(self, args, kwargs, sig):
        from . import trace
        from .tracer import wait_for
        cause = _diff_cause(self._last_sig, sig)
        t0 = time.perf_counter()
        with trace.span("fit/compile", fn=self.tag, cause=cause):
            out, cost = count_call(self._fn, args, kwargs)
            wait_for(out)
        dt = time.perf_counter() - t0
        self._note_compile(cause, dt)
        self.cost = cost
        _m_flops.labels(fn=self.tag).set(cost["flops"])
        _m_bytes.labels(fn=self.tag).set(cost["bytes"])
        return out, cost

    def _note_compile(self, cause: str, dt: float):
        self.compiles += 1
        self.compile_seconds += dt
        self.causes[cause] = self.causes.get(cause, 0) + 1
        _m_compiles.labels(fn=self.tag, cause=cause).inc()
        _m_compile_seconds.labels(fn=self.tag).inc(dt)

    # ---- the AOT executable cache ----
    def _lane_for(self, args):
        if self._lane is None:
            dev = _device_of(args)
            self._lane = GraphLane(dev)
        return self._lane

    def _make_exec(self, args, sig, counted: bool):
        """Capture (CUDA) or run once (CPU) the executable of ``args``'
        signature and cache it; a counted capture is a compile."""
        from . import trace
        cause = _diff_cause(self._last_sig, sig)
        on_cuda = any(d[2].startswith("cuda") for d in sig if len(d) == 3)
        t0 = time.perf_counter()
        with trace.span("fit/compile", fn=self.tag, cause=cause,
                        graph=on_cuda):
            ex = (GraphExec(self._fn, args, self._lane_for(args)) if on_cuda
                  else EagerExec(self._fn, args))
        if counted:
            self._note_compile(cause, time.perf_counter() - t0)
        self._execs[sig] = ex
        self._last_sig = sig
        return ex

    def is_cached(self, *args) -> bool:
        """Would a call with these args replay a captured executable?
        (The serving engine's cache hit/miss accounting — a miss on live
        traffic is a capture somebody's request pays for.)"""
        return _abstract_sig(args) in self._execs

    def executable(self, *args):
        """The cached executable of ``args``' signature, or None."""
        return self._execs.get(_abstract_sig(args))

    def aot_compile(self, *args):
        """Capture (and cache) the executable for ``args``' abstract
        signature ahead of traffic — args may be tensors or
        :class:`TensorSpec` s. A no-op for a cached signature. Returns
        the executable."""
        sig = _abstract_sig(args)
        ex = self._execs.get(sig)
        if ex is None:
            ex = self._make_exec(args, sig, counted=True)
        return ex

    def preload(self, args):
        """Seed the cache for ``args``' signature from a serving bundle:
        the capture runs here, as :meth:`aot_compile`'s does, but counts
        no compile (the warm start). Returns the executable."""
        sig = _abstract_sig(args)
        return self._execs.get(sig) or self._make_exec(args, sig,
                                                       counted=False)

    def __call__(self, *args, **kwargs):
        if self.aot:
            sig = _abstract_sig(args)
            ex = self._execs.get(sig)
            if ex is None:
                ex = self._make_exec(args, sig, counted=True)
            self.calls += 1
            if not _pstate.enabled:
                return ex(*args)
            from .tracer import wait_for
            t0 = time.perf_counter()
            out = ex(*args)
            wait_for(out)
            self.last_call_seconds = max(time.perf_counter() - t0, 1e-9)
            sample_live_buffers(_device_of(args), (args, out))
            return out
        if not _pstate.enabled:
            return self._fn(*args, **kwargs)
        from .tracer import wait_for
        sig = _abstract_sig((args, kwargs))
        self.device = _device_of(args)
        cost = self._cache.get(sig)
        if cost is None:
            out, cost = self._count(args, kwargs, sig)
            self._cache[sig] = cost
        else:
            self.cost = cost
            t0 = time.perf_counter()
            out = self._fn(*args, **kwargs)
            wait_for(out)
            dt = max(time.perf_counter() - t0, 1e-9)
            self.last_call_seconds = dt
            if cost["flops"]:
                achieved = cost["flops"] / dt
                _m_achieved.labels(fn=self.tag).set(achieved)
                _m_roofline.labels(fn=self.tag).set(
                    achieved / peak_flops(self.device or "cpu"))
        self._last_sig = sig
        self.calls += 1
        sample_live_buffers(self.device, (args, kwargs, out))
        return out


def wrap(fn, tag: str, aot: bool = False,
         lane: Optional[GraphLane] = None) -> ProfiledFunction:
    """Wrap a function for profiling (idempotent per tag: wrapping
    replaces the report slot, not accumulates). ``aot=True`` keeps the
    executable cache — one CUDA graph per signature — live even while
    profiling is off (serving warm starts)."""
    if isinstance(fn, ProfiledFunction):
        return fn
    return ProfiledFunction(fn, tag, aot=aot, lane=lane)


def report() -> dict:
    """JSON-able profile summary, in the JAX package's shape."""
    fns = {}
    with _lock:
        items = list(_functions.items())
    for tag, pf in items:
        if not pf.compiles and not pf.calls:
            continue
        achieved = (pf.cost["flops"] / pf.last_call_seconds
                    if pf.cost["flops"] and pf.last_call_seconds else 0.0)
        peak = peak_flops(pf.device or "cpu")
        fns[tag] = {
            "flops_per_call": pf.cost["flops"],
            "bytes_per_call": pf.cost["bytes"],
            "compiles": pf.compiles,
            "compile_seconds": round(pf.compile_seconds, 4),
            "recompile_causes": dict(pf.causes),
            "calls": pf.calls,
            "last_call_seconds": round(pf.last_call_seconds, 6),
            "achieved_flops_per_sec": achieved,
            "roofline_utilization": (achieved / peak if peak else 0.0),
            "peak_flops": peak,
        }
    return {"functions": fns, "peak_flops": peak_flops(),
            "live_buffer_bytes": _m_live_bytes.value,
            "live_buffer_peak_bytes": max(_live_peak, _m_live_peak.value)}


def reset():
    """Forget profiled functions and peaks (tests)."""
    global _live_peak
    with _lock:
        _functions.clear()
        _live_peak = 0.0

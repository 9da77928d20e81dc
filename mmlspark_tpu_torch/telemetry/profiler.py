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

Not ported: ``aot=True``, ``aot_compile``, ``preload`` and ``is_cached``,
which serve the serving bundle's warm starts (ROADMAP.md Queue 1 item 10,
serving half).
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
                        str(getattr(v, "device", "cpu"))))
        elif v is not None:
            out.append(("py", type(v).__name__))
    walk(args)
    return tuple(out)


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


def note_kernel(flops: float, nbytes: float):
    """A kernel wrapper's report of one launch's work (analytic FLOPs and
    bytes), added to every count that is running. One truth test when no
    count is running."""
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


class ProfiledFunction:
    """A function observed through the profiler.

    Disabled (default): one flag check, then the plain call. Enabled: the
    first call with a new argument signature runs under the counting
    modes (its wall time lands in the compile-seconds counter, its FLOPs
    and bytes in the per-call gauges, cached for the signature); every
    other call is timed to completion — a wait on the current stream of
    each CUDA device its result lives on — which sets the achieved-FLOP/s
    and roofline gauges. Either way the device memory gauges are sampled
    after the call."""

    def __init__(self, fn, tag: str):
        self._fn = fn
        self.tag = tag
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
        self.compiles += 1
        self.compile_seconds += dt
        self.causes[cause] = self.causes.get(cause, 0) + 1
        self.cost = cost
        _m_compiles.labels(fn=self.tag, cause=cause).inc()
        _m_compile_seconds.labels(fn=self.tag).inc(dt)
        _m_flops.labels(fn=self.tag).set(cost["flops"])
        _m_bytes.labels(fn=self.tag).set(cost["bytes"])
        return out, cost

    def __call__(self, *args, **kwargs):
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


def wrap(fn, tag: str) -> ProfiledFunction:
    """Wrap a function for profiling (idempotent per tag: wrapping
    replaces the report slot, not accumulates)."""
    if isinstance(fn, ProfiledFunction):
        return fn
    return ProfiledFunction(fn, tag)


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

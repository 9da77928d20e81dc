"""Environment switches and device discovery (reference: src/core/env
EnvironmentUtils.scala:41-50, which counts GPUs by shelling out to
``nvidia-smi -L``); the port's counterpart of ``mmlspark_tpu/core/env.py``.

The switches keep the JAX package's environment variable names
(``MMLSPARK_TPU_TELEMETRY``, ``MMLSPARK_TPU_TRACE``, ``MMLSPARK_TPU_FLIGHT``,
``MMLSPARK_TPU_TIMESERIES``, ``MMLSPARK_TPU_FAULTS``,
``MMLSPARK_TPU_FAULTS_SEED``), so a deployment's settings carry over to the
port unchanged. Each package reads them when its own ``telemetry`` and
``resilience.faults`` modules are imported."""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


def telemetry_enabled() -> bool:
    """MMLSPARK_TPU_TELEMETRY=1: the port's telemetry package enables its
    metrics registry and span tracer at import. Default off: a disabled
    metric or span costs one attribute check per call site."""
    return os.environ.get("MMLSPARK_TPU_TELEMETRY", "").strip().lower() \
        in _TRUTHY


def telemetry_trace_path() -> Optional[str]:
    """MMLSPARK_TPU_TRACE=/path/file.jsonl: export the span buffer as
    Chrome-trace JSON-lines at interpreter exit (telemetry must also be on
    for spans to record). A literal ``{pid}`` in the path becomes the
    process id."""
    return os.environ.get("MMLSPARK_TPU_TRACE") or None


def flight_path() -> Optional[str]:
    """MMLSPARK_TPU_FLIGHT: arm the crash flight recorder at import.
    ``=1`` dumps bundles to the working directory, ``=/path/dir`` there.
    Returns None (disarmed), "" (armed, default dir) or the directory."""
    v = os.environ.get("MMLSPARK_TPU_FLIGHT", "").strip()
    if not v or v.lower() in _FALSY:
        return None
    if v.lower() in _TRUTHY:
        return ""
    return v


def timeseries_interval() -> Optional[float]:
    """MMLSPARK_TPU_TIMESERIES: arm the time-series sampler at import.
    ``=1`` samples every second; a float (``=0.25``) is the tick interval
    in seconds. Returns None (disarmed) or the interval. Arming also
    enables telemetry."""
    v = os.environ.get("MMLSPARK_TPU_TIMESERIES", "").strip()
    if not v or v.lower() in _FALSY:
        return None
    if v.lower() in _TRUTHY:
        return 1.0
    try:
        iv = float(v)
    except ValueError:
        return 1.0
    return iv if iv > 0 else None


def fault_spec() -> Optional[str]:
    """MMLSPARK_TPU_FAULTS="site:kind:rate[:arg];...": arm the seeded
    fault-injection plan (resilience.faults) at import. Unset by default:
    an injection site is then one module-bool check."""
    return os.environ.get("MMLSPARK_TPU_FAULTS") or None


def fault_seed() -> int:
    """MMLSPARK_TPU_FAULTS_SEED=<int>: the base seed every fault site's RNG
    derives from (seed ^ crc32(site)), so reruns replay identically."""
    try:
        return int(os.environ.get("MMLSPARK_TPU_FAULTS_SEED", "0"))
    except ValueError:
        return 0


def accelerator_count() -> int:
    """Attached CUDA devices (0 on a CPU-only build or host)."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def resolve_device(name: str, who: str):
    """``name`` ("cuda", "cuda:N" or "cpu") as a torch device for the stage
    ``who``. Asking for CUDA where torch sees none raises: nothing falls
    back to the CPU."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} device={name!r} but torch sees no CUDA device; set "
            f"device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{who} runs on cuda or cpu, not {dev}")
    return dev


def gpu_name_and_power_limit() -> Optional[str]:
    """The card's name and power limit exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (first card), or None where nvidia-smi is absent. A card may be set
    below its maximum power and then runs slower under load, so every
    measurement is reported beside this line."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=30)
    if r.returncode != 0:
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def device_summary() -> dict:
    """Platform/topology snapshot for logs and measurement records."""
    import torch
    n = accelerator_count()
    return {
        "backend": "cuda" if n else "cpu",
        "device_count": n,
        "device_kinds": sorted({torch.cuda.get_device_name(i)
                                for i in range(n)}),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvidia_smi": gpu_name_and_power_limit() if n else None,
    }

"""Device discovery (reference: src/core/env EnvironmentUtils.scala:41-50,
which counts GPUs by shelling out to ``nvidia-smi -L``); the port's
counterpart of ``mmlspark_tpu/core/env.py:93-111``."""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional


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

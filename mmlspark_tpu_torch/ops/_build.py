"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers: a build takes seconds, not minutes). Libraries go into
``mmlspark_tpu_torch/_build/`` (git-ignored), named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built at import: the first launch builds, or a caller builds
every kernel up front with :func:`build_all`, which starts one ``nvcc`` per
source, all at once. A failed build raises with ``nvcc``'s stderr; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}  # guarded-by: _lock — name -> ctypes.CDLL
#: nvcc processes this process started (a warm restart from a serving
#: bundle must start none)
builds = 0


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return exe


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Sequence[str]] = None) -> dict:
    """Compile every named kernel (default: all of ``csrc/``) whose library
    is missing, one ``nvcc`` process per source, all started together.
    Returns {name: {"path", "seconds", "ptxas"}}; ``ptxas`` holds the
    compiler's register/shared-memory/spill report, kept beside the library
    (``.ptxas``) so a library built earlier still has it. Raises
    RuntimeError naming every failed source."""
    global builds
    names = list(names or kernel_names())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name)
        if so.exists():
            log = so.with_suffix(".ptxas")
            report[name] = {"path": str(so), "seconds": 0.0,
                            "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        builds += 1
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       so, tmp)
    failures = []
    for name, (proc, so, tmp) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{err}{out}")
            continue
        ptxas = (err + out).strip()
        so.with_suffix(".ptxas").write_text(ptxas)
        os.replace(tmp, so)
        report[name] = {"path": str(so),
                        "seconds": time.perf_counter() - t0,
                        "ptxas": ptxas}
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return report


def load(name: str, functions: dict) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.
    ``functions`` maps each exported C function to (restype, argtypes); every
    pointer and the stream must be ``ctypes.c_void_p`` so ctypes passes
    64 bits."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            so = library_path(name)
            if not so.exists():
                build_all([name])
            lib = ctypes.CDLL(str(so))
            for fn, (restype, argtypes) in functions.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return lib

"""ctypes bindings for the port's native host runtime (libmmltpu).

The port of ``mmlspark_tpu/native/__init__.py``. The reference's native
layer arrives as prebuilt JNI/SWIG jars extracted and System.load-ed at
runtime (core/env/src/main/scala/NativeLoader.java:28); this one is the
port's own copy of the C++ sources (``csrc/``), compiled on first use by
``g++`` into ``mmlspark_tpu_torch/_build/native/`` and loaded with ctypes:
image decode and bilinear resize, the threaded prefetching batch loader
(``BatchLoader``), the threaded CSV parser (``read_csv``), the Arrow
columns -> rows interleave (``interleave_f32``) and GBDT binning
(``bin_data_native``, bound and used by nothing yet).

The build:

* one ``g++`` invocation over every source; the library is named by a
  hash of the sources and the flags, written under a temporary name and
  ``os.replace``-d into place while an ``fcntl`` lock on the build
  directory is held, so concurrent processes (pytest-xdist workers) build
  it once and never load a half-written file;
* JPEG and PNG decoding compile in only where ``<jpeglib.h>`` and
  ``<png.h>`` are found (``__has_include``); BMP and PPM are decoded by
  hand and always built. :func:`formats` names what this build decodes,
  and a file in a format it does not decode raises ``ValueError`` naming
  the format (a corrupt file of a built format is zero-filled instead);
* a failed build raises ``RuntimeError`` with the compiler's stderr.
  Nothing falls back silently: the JAX package's pure-Python fallbacks
  (cv2, ``np.genfromtxt``, ``np.stack``) run only when the caller sets
  ``MMLSPARK_TPU_NO_NATIVE=1``, and then :func:`get_lib` returns None.

``calls`` counts the native entry points' runs by name (``decode``,
``resize``, ``loader_batches``, ``csv``, ``interleave``, ``bin``), so a
caller can check that the native path, not a fallback, did the work.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread",
             "-shared")
#: optional decoders: (format, header, library, define that leaves it out)
OPTIONAL = (("jpeg", "jpeglib.h", "-ljpeg", "MMLTPU_NO_JPEG"),
            ("png", "png.h", "-lpng", "MMLTPU_NO_PNG"))
_FORMAT_BITS = (("jpeg", 1), ("png", 2), ("bmp", 4), ("ppm", 8))

# held across the build + dlopen on purpose: one thread builds, the rest
# wait for its result
_lock = threading.Lock()
_lib = None                 # guarded-by: _lock

#: native entry-point runs by name
calls: dict = {}
_calls_lock = threading.Lock()


def _count(name: str):
    with _calls_lock:
        calls[name] = calls.get(name, 0) + 1


def _cxx() -> str:
    exe = os.environ.get("CXX") or shutil.which("g++")
    if exe is None:
        raise RuntimeError("g++ not found: the port's native runtime is "
                           "built from mmlspark_tpu_torch/native/csrc with "
                           "g++ (set MMLSPARK_TPU_NO_NATIVE=1 for the "
                           "pure-Python fallbacks)")
    return exe


def _headers_found(cxx: str) -> set:
    """The optional decoders whose header the compiler finds."""
    probe = "".join(f"#if __has_include(<{hdr}>)\nFOUND_{fmt}\n#endif\n"
                    for fmt, hdr, _lib, _d in OPTIONAL)
    r = subprocess.run([cxx, "-x", "c++", "-E", "-"], input=probe,
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} could not preprocess a probe:\n"
                           f"{r.stderr}")
    return {fmt for fmt, *_ in OPTIONAL if f"FOUND_{fmt}" in r.stdout}


def build_command(exclude: Sequence[str] = ()) -> list:
    """The compiler's arguments for this machine, without the output
    path: the optional decoders whose header is found and that
    ``exclude`` does not name compile in and link their library."""
    cxx = _cxx()
    found = _headers_found(cxx) - set(exclude)
    defines = [f"-D{d}" for fmt, _h, _l, d in OPTIONAL if fmt not in found]
    libs = [lib for fmt, _h, lib, _d in OPTIONAL if fmt in found]
    sources = sorted(str(p) for p in CSRC.glob("*.cc"))
    return [cxx, *CXX_FLAGS, *defines, *sources, *libs]


def library_path(cmd: Sequence[str], build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built by ``cmd`` lives: named by a hash of the
    sources (and header) and of the command's flags."""
    h = hashlib.sha256(" ".join(a for a in cmd[1:]
                                if not a.endswith(".cc")).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return Path(build_dir) / f"libmmltpu-{h.hexdigest()[:16]}.so"


def build(exclude: Sequence[str] = (), build_dir: Path = BUILD_DIR) -> Path:
    """Build the library (unless one for these sources and flags exists)
    and return its path. Concurrent builders serialise on an ``fcntl``
    lock in ``build_dir``; the loser finds the winner's library. Raises
    RuntimeError with the compiler's stderr."""
    cmd = build_command(exclude)
    so = library_path(cmd, build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():
                return so
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            r = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                               text=True)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"the native runtime did not build "
                                   f"(exit {r.returncode}):\n{r.stderr}")
            os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    sigs = {
        "mmltpu_free": (None, [ctypes.c_void_p]),
        "mmltpu_formats": (ctypes.c_int, []),
        "mmltpu_decode_image": (ctypes.c_int, [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]),
        "mmltpu_resize_bilinear": (None, [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
            ctypes.c_int, ctypes.c_int]),
        "mmltpu_loader_create": (ctypes.c_void_p, [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
        "mmltpu_loader_next": (ctypes.c_int, [
            ctypes.c_void_p, u8p, u8p, ctypes.POINTER(ctypes.c_int)]),
        "mmltpu_loader_destroy": (None, [ctypes.c_void_p]),
        "mmltpu_csv_parse": (ctypes.c_int, [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char, ctypes.c_int,
            ctypes.POINTER(fp), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]),
        "mmltpu_interleave_f32": (None, [
            ctypes.POINTER(fp), ctypes.c_int, ctypes.c_int64, fp,
            ctypes.c_int]),
        "mmltpu_bin_data": (None, [
            fp, ctypes.c_int64, ctypes.c_int, fp, ctypes.c_int, u8p,
            ctypes.c_int, u8p, ctypes.c_int]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def load(path) -> ctypes.CDLL:
    """A built library at ``path``, bound."""
    return _bind(ctypes.CDLL(str(path)))


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded runtime, built first if needed; None only when
    ``MMLSPARK_TPU_NO_NATIVE`` is set. A failed build raises."""
    global _lib
    if os.environ.get("MMLSPARK_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def available() -> bool:
    return get_lib() is not None


def formats(lib: Optional[ctypes.CDLL] = None) -> tuple:
    """The image formats the native decoder of this build handles."""
    lib = lib or get_lib()
    if lib is None:
        return ()
    bits = lib.mmltpu_formats()
    return tuple(name for name, bit in _FORMAT_BITS if bits & bit)


def sniff_format(data: bytes) -> Optional[str]:
    """The format the native decoder would take ``data`` for, by its magic
    bytes (None: not one it decodes)."""
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:4] == b"\x89PNG":
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    if data[:2] == b"P6":
        return "ppm"
    return None


def _not_built(what: str, fmt: str, lib) -> ValueError:
    return ValueError(f"{what}: {fmt.upper()} images are not decoded by "
                      f"this build of the native runtime (it decodes "
                      f"{', '.join(formats(lib))}; {fmt} needs its "
                      f"library's header when the runtime is built)")


def decode_image(data: bytes, lib: Optional[ctypes.CDLL] = None
                 ) -> Optional[np.ndarray]:
    """Encoded bytes -> HWC uint8 BGR array, or None if undecodable (or the
    runtime is disabled). Raises ValueError for a format this build does
    not decode."""
    lib = lib or get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.mmltpu_decode_image(data, len(data), ctypes.byref(out),
                                 ctypes.byref(h), ctypes.byref(w),
                                 ctypes.byref(c))
    _count("decode")
    if rc == -2:
        raise _not_built("decode_image", sniff_format(data), lib)
    if rc != 0:
        return None
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.mmltpu_free(out)
    return arr.reshape(h.value, w.value, c.value)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """HWC uint8 bilinear resize (half-pixel centres, clamped edges)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native runtime is disabled "
                           "(MMLSPARK_TPU_NO_NATIVE)")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3:
        raise ValueError(f"expected an HWC image, got shape {img.shape}")
    h, w, c = img.shape
    dst = np.empty((out_h, out_w, c), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mmltpu_resize_bilinear(img.ctypes.data_as(u8p), h, w, c,
                               dst.ctypes.data_as(u8p), out_h, out_w)
    _count("resize")
    return dst


class BatchLoader:
    """Fixed-shape image batches decoded and resized by C++ worker threads.

    Iterating yields ``(batch[B,H,W,3] uint8 BGR, ok[B] bool, count)``
    from one staging buffer reused across iterations (copy before
    advancing); :meth:`next_into` fills a caller's buffer instead (the
    device feed passes pinned host memory). A file in a format this build
    does not decode raises ValueError naming it; an unreadable or corrupt
    one is a zero-filled slot with ok False."""

    def __init__(self, paths: Sequence[str], batch: int, height: int,
                 width: int, threads: int = 0, prefetch: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("the native runtime is disabled "
                               "(MMLSPARK_TPU_NO_NATIVE)")
        self._lib = lib
        self.paths = list(paths)
        self.batch, self.height, self.width = batch, height, width
        if threads <= 0:
            threads = min(8, os.cpu_count() or 1)
        arr = (ctypes.c_char_p * len(self.paths))(
            *[os.fsencode(p) for p in self.paths])
        self._handle = lib.mmltpu_loader_create(
            arr, len(self.paths), batch, height, width, threads, prefetch)
        if not self._handle:
            raise RuntimeError("loader creation failed")
        self._buf = np.empty((batch, height, width, 3), dtype=np.uint8)
        self._ok = np.empty((batch,), dtype=np.uint8)
        self._next_batch = 0

    def next_into(self, out: np.ndarray, ok: np.ndarray) -> Optional[int]:
        """Decode the next batch into ``out`` (B, H, W, 3 uint8) and ``ok``
        (B uint8: 1 decoded, 0 not); returns its row count, None at the
        end."""
        if (out.shape != (self.batch, self.height, self.width, 3)
                or out.dtype != np.uint8 or not out.flags.c_contiguous
                or ok.shape != (self.batch,) or ok.dtype != np.uint8
                or not ok.flags.c_contiguous):
            raise ValueError(f"staging buffers must be C-contiguous uint8 "
                             f"({self.batch}, {self.height}, {self.width}, "
                             f"3) and ({self.batch},); got {out.shape} "
                             f"{out.dtype} and {ok.shape} {ok.dtype}")
        if not self._handle:
            raise RuntimeError("the loader is closed")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        count = ctypes.c_int()
        rc = self._lib.mmltpu_loader_next(self._handle, out.ctypes.data_as(u8p),
                                          ok.ctypes.data_as(u8p),
                                          ctypes.byref(count))
        if rc == 0:
            return None
        lo = self._next_batch * self.batch
        self._next_batch += 1
        _count("loader_batches")
        not_built = np.flatnonzero(ok[:count.value] == 2)
        if not_built.size:
            path = self.paths[lo + int(not_built[0])]
            with open(path, "rb") as f:
                fmt = sniff_format(f.read(8))
            raise _not_built(path, fmt, self._lib)
        return count.value

    def __iter__(self):
        while (count := self.next_into(self._buf, self._ok)) is not None:
            yield self._buf, self._ok.astype(bool), count

    def close(self):
        if self._handle:
            self._lib.mmltpu_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_csv(path: str, skip_header: bool = False, delim: str = ",",
             threads: int = 0) -> Optional[np.ndarray]:
    """Delimited numeric file -> float32 matrix (threaded parse); None
    when the runtime is disabled. Raises OSError when the file cannot be
    read."""
    lib = get_lib()
    if lib is None:
        return None
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    out = ctypes.POINTER(ctypes.c_float)()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.mmltpu_csv_parse(os.fsencode(path), int(skip_header),
                              delim.encode(), threads, ctypes.byref(out),
                              ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise OSError(f"the native CSV parser could not read {path}")
    _count("csv")
    try:
        n = rows.value * cols.value
        if n == 0:
            return np.zeros((0, max(cols.value, 0)), dtype=np.float32)
        mat = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.mmltpu_free(out)
    return mat.reshape(rows.value, cols.value)


def interleave_f32(cols: list, out: np.ndarray, threads: int = 0) -> bool:
    """Columnar float32 arrays -> the row-major ``out`` (n, d) through the
    threaded cache-blocked C++ transpose (the Arrow bridge; replaces the
    reference's per-element JNI copies, CNTKModel.scala:67-74). Returns
    False when the runtime is disabled (callers then use np.stack)."""
    lib = get_lib()
    if lib is None:
        return False
    n, d = out.shape
    if len(cols) != d:
        raise ValueError(f"{len(cols)} columns for a {d}-wide output")
    if out.dtype != np.float32 or not out.flags.c_contiguous:
        raise TypeError("output must be C-contiguous float32")
    fp = ctypes.POINTER(ctypes.c_float)
    ptrs = (fp * d)()
    for j, c in enumerate(cols):
        if c.dtype != np.float32 or not c.flags.c_contiguous:
            raise TypeError(f"column {j} must be contiguous float32, "
                            f"got {c.dtype}")
        if len(c) != n:
            raise ValueError(f"column {j} has {len(c)} rows, output {n}")
        ptrs[j] = c.ctypes.data_as(fp)
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    lib.mmltpu_interleave_f32(ptrs, d, n, out.ctypes.data_as(fp), threads)
    _count("interleave")
    return True


def bin_data_native(x: np.ndarray, edges: np.ndarray,
                    cat_mask: Optional[np.ndarray] = None,
                    max_bin: int = 256,
                    threads: int = 0) -> Optional[np.ndarray]:
    """GBDT quantile binning in C++: (n, d) f32 -> (n, d) uint8 (bin =
    count of edges strictly below the value, NaN -> 0, categorical columns
    by identity clipped to ``max_bin - 1``). None when the runtime is
    disabled."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    edges = np.ascontiguousarray(edges, dtype=np.float32)
    n, d = x.shape
    if edges.shape[0] != d:
        raise ValueError(f"edges has {edges.shape[0]} feature rows for a "
                         f"{d}-wide matrix")
    out = np.empty((n, d), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cat_ptr = None
    if cat_mask is not None:
        cat_arr = np.ascontiguousarray(cat_mask, dtype=np.uint8)
        if len(cat_arr) != d:
            raise ValueError(f"cat_mask has {len(cat_arr)} entries for "
                             f"{d} features")
        cat_ptr = cat_arr.ctypes.data_as(u8p)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.mmltpu_bin_data(x.ctypes.data_as(fp), n, d,
                        edges.ctypes.data_as(fp), int(edges.shape[1]),
                        cat_ptr, int(max_bin), out.ctypes.data_as(u8p),
                        int(threads))
    _count("bin")
    return out

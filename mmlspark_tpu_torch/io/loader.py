"""Device feed: files -> decoded fixed-shape batches -> the card.

The port of ``mmlspark_tpu/io/loader.py``. The ingest pipeline the
reference lacks: it moves training data by writing text files and scp-ing
them to GPU VMs (cntk-train/.../CommandBuilders.scala:200-228) and feeds
inference through per-element JNI copies (cntk-model/.../CNTKModel.scala:
51-88). Here the native threaded loader (``native.BatchLoader``, C++)
decodes ahead of the consumer, each batch lands in one of two pinned host
buffers, and a side stream copies it to the card without blocking
(:class:`StagingRing`), so decode, the copy and device compute overlap.
The cv2 loader runs only when the native runtime is disabled
(``MMLSPARK_TPU_NO_NATIVE=1``).
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .. import native
from ..core.env import resolve_device
from .binary import recurse_path
from .image import IMAGE_EXTENSIONS, NATIVE_EXTENSIONS


def _cv2_fill(path: str, buf_slot: np.ndarray, height: int,
              width: int) -> bool:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        return False
    if img.shape[:2] != (height, width):
        img = cv2.resize(img, (width, height),
                         interpolation=cv2.INTER_LINEAR)
    buf_slot[:] = img
    return True


def _decoded(paths, batch, height, width, threads, prefetch, slot):
    """Decode batch after batch into the host buffers ``slot(k)`` returns
    for batch k — ``(buf[B,H,W,3] uint8, ok[B] uint8)`` — yielding
    ``(buf, ok, count)``. Files the native decoder does not cover
    (gif/tiff/webp) are patched in through cv2."""
    if native.get_lib() is None:            # MMLSPARK_TPU_NO_NATIVE
        for k, lo in enumerate(range(0, len(paths), batch)):
            buf, ok = slot(k)
            chunk = paths[lo:lo + batch]
            buf[:] = 0
            ok[:] = 0
            for i, p in enumerate(chunk):
                ok[i] = _cv2_fill(p, buf[i], height, width)
            yield buf, ok, len(chunk)
        return
    with native.BatchLoader(paths, batch, height, width, threads=threads,
                            prefetch=prefetch) as ld:
        k = 0
        while True:
            buf, ok = slot(k)
            count = ld.next_into(buf, ok)
            if count is None:
                return
            for i in range(count):
                p = paths[k * batch + i]
                if not ok[i] and not p.lower().endswith(NATIVE_EXTENSIONS):
                    ok[i] = _cv2_fill(p, buf[i], height, width)
            yield buf, ok, count
            k += 1


def image_batches(paths: list[str], batch: int, height: int, width: int,
                  threads: int = 0, prefetch: int = 4
                  ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Yield (batch[B,H,W,3] uint8 BGR staging buffer, ok[B] bool, count).

    The buffer is reused across yields — copy before advancing. Slots past
    ``count`` and files that did not decode are zero-filled, ok False."""
    stage = (np.zeros((batch, height, width, 3), dtype=np.uint8),
             np.zeros((batch,), dtype=np.uint8))
    for buf, ok, count in _decoded(paths, batch, height, width, threads,
                                   prefetch, lambda k: stage):
        yield buf, ok.astype(bool), count


class StagingRing:
    """Pinned host buffers in turn, each copied to the card on a side
    stream.

    :meth:`slot` hands out buffer ``k % depth`` for batch k once that
    buffer's previous copy has landed (its event), so no buffer is refilled
    under a copy still reading it. :meth:`copy` starts a buffer's (or a
    pinned tensor's) non-blocking copy on the side stream and records an
    event after it. :meth:`consume` makes the caller's current stream wait
    on that event and ties the device tensor to that stream
    (``record_stream``), so the caching allocator does not hand its block to
    the side stream's next copy before the consumer has read it."""

    def __init__(self, dev: torch.device, shape: tuple, dtype: torch.dtype,
                 depth: int = 2):
        self.dev = dev
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=True)
                     for _ in range(depth)]
        self._events: list = [None] * depth
        self.stream = torch.cuda.Stream(dev)

    def slot(self, k: int) -> torch.Tensor:
        i = k % len(self.host)
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        return self.host[i]

    def copy(self, k: int, src: Optional[torch.Tensor] = None) -> tuple:
        """(device tensor, event): ``src`` (a pinned tensor; buffer ``k``
        by default) on its way to the card."""
        i = k % len(self.host)
        src = self.host[i] if src is None else src
        with torch.cuda.stream(self.stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=self.dev)
            out.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._events[i] = ev
        return out, ev

    def consume(self, out: torch.Tensor, ev) -> torch.Tensor:
        stream = torch.cuda.current_stream(self.dev)
        stream.wait_event(ev)
        out.record_stream(stream)
        return out


def device_image_batches(paths: list[str], batch: int, height: int,
                         width: int, *, transform: Optional[Callable] = None,
                         threads: int = 0, prefetch: int = 4,
                         device: str = "cuda"):
    """Yield ``(tensor on device, ok mask on host, count)`` with a
    one-batch lookahead: batch k+1 is decoded into the other pinned buffer
    and its copy started before batch k is handed over, so decode (C++
    threads), the copy and the consumer's compute overlap. ``transform``
    (host-side, e.g. a dtype cast) runs on the staging buffer before the
    copy. On the CPU (``device="cpu"``) each yield is a copy of the staging
    buffer."""
    dev = resolve_device(device, "device_image_batches")
    if dev.type != "cuda":
        for buf, ok, count in image_batches(paths, batch, height, width,
                                            threads=threads,
                                            prefetch=prefetch):
            arr = transform(buf) if transform is not None else buf
            yield torch.from_numpy(np.array(arr)), ok.copy(), count
        return
    ring = StagingRing(dev, (batch, height, width, 3), torch.uint8)
    oks = [np.zeros((batch,), np.uint8) for _ in ring.host]
    pending = None
    k = 0
    for buf, ok, count in _decoded(
            paths, batch, height, width, threads, prefetch,
            lambda j: (ring.slot(j).numpy(), oks[j % len(oks)])):
        src = None
        if transform is not None:
            src = torch.from_numpy(np.ascontiguousarray(
                transform(buf))).pin_memory()
        nxt = (*ring.copy(k, src), ok.astype(bool), count)
        if pending is not None:
            yield ring.consume(*pending[:2]), pending[2], pending[3]
        pending = nxt
        k += 1
    if pending is not None:
        yield ring.consume(*pending[:2]), pending[2], pending[3]


def list_images(path: str, recursive: bool = True) -> list[str]:
    """All decodable image files under path, sorted for determinism."""
    if os.path.isfile(path):
        return [path]
    files = recurse_path(path) if recursive else [
        os.path.join(path, f) for f in sorted(os.listdir(path))
        if os.path.isfile(os.path.join(path, f))]
    return sorted(p for p in files if p.lower().endswith(IMAGE_EXTENSIONS))

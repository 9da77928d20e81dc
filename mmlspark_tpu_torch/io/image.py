"""Image ingest (reference: io/image — Image.scala:58-125 decodes via OpenCV
Imgcodecs.imdecode into ImageSchema rows; ImageFileFormat.scala:27-95 adds
subsampling; ImageWriter). The port of ``mmlspark_tpu/io/image.py``.

read_images decodes to the reference's layout: HWC uint8, BGR channel order
(OpenCV's), one ImageSchema struct per row. Undecodable files follow the
reference's contract: dropped when drop_invalid, else a null row.

Decode goes through the port's native runtime (``native``: libjpeg and
libpng where the build found them, BMP and PPM by hand). A JPEG or PNG
where the build has no decoder for it raises ValueError naming the format.
GIF, TIFF and WebP go to cv2, imported only for them (the card's machine
has no cv2). write_images encodes PNG (zlib), BMP and PPM by hand, so the
files decode to the same pixels in both packages; other formats go through
cv2.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.schema import image_to_array, make_image_row, tag_image_column
from ..core.utils import object_column
from .binary import read_binary_files

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".gif", ".tif",
                    ".tiff", ".webp")
# the formats the native decoder handles; the rest go through cv2
NATIVE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm")


def decode_image(path: str, data: bytes) -> Optional[dict]:
    """bytes -> ImageSchema row (BGR HWC uint8), None if undecodable."""
    from .. import native
    img = native.decode_image(data)
    if img is None and (native.get_lib() is None
                        or native.sniff_format(data) is None):
        import cv2      # GIF/TIFF/WebP, or the native runtime disabled
        img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8),
                           cv2.IMREAD_COLOR)
    if img is None:
        return None
    h, w, c = img.shape
    return make_image_row(path, h, w, c, img)


def read_images(path: str, recursive: bool = True, sample_ratio: float = 1.0,
                seed: int = 0, drop_invalid: bool = True,
                inspect_zip: bool = True, npartitions: int = 1,
                image_col: str = "image") -> DataFrame:
    """Directory (or zip) of images -> DataFrame with one ImageSchema column."""
    binary = read_binary_files(path, recursive=recursive,
                               sample_ratio=sample_ratio, seed=seed,
                               inspect_zip=inspect_zip)
    rows, paths = [], []
    for r in binary.iterRows():
        p = str(r["path"])
        if not p.lower().endswith(IMAGE_EXTENSIONS):
            continue
        decoded = decode_image(p, r["bytes"])
        if decoded is None and drop_invalid:
            continue
        rows.append(decoded)
        paths.append(p)
    df = DataFrame({image_col: object_column(rows),
                    "path": object_column(paths)}, npartitions=npartitions)
    return tag_image_column(df, image_col)


# ------------------------------------------------------------- encoders

def _bgr(arr: np.ndarray) -> np.ndarray:
    """HWC uint8 with 1, 3 or 4 channels -> 3-channel BGR (gray
    replicated, alpha dropped)."""
    if arr.shape[2] == 1:
        return np.repeat(arr, 3, axis=2)
    return arr[:, :, :3]


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """8-bit PNG of an HWC BGR (or one-channel gray) image: one IDAT, every
    row with filter type 0."""
    h, w, c = arr.shape
    if c == 1:
        color, raw = 0, arr.reshape(h, w)
    else:
        color, raw = 2, _bgr(arr)[:, :, ::-1].reshape(h, w * 3)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def encode_bmp(arr: np.ndarray) -> bytes:
    """24-bit uncompressed bottom-up BMP (BITMAPINFOHEADER)."""
    bgr = _bgr(arr)
    h, w, _ = bgr.shape
    pad = (-w * 3) % 4
    rows = np.concatenate([bgr[::-1].reshape(h, w * 3),
                           np.zeros((h, pad), np.uint8)], axis=1)
    pixels = rows.tobytes()
    header = struct.pack("<2sIHHI", b"BM", 54 + len(pixels), 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pixels),
                       2835, 2835, 0, 0)
    return header + info + pixels


def encode_ppm(arr: np.ndarray) -> bytes:
    """Binary PPM (P6, maxval 255)."""
    bgr = _bgr(arr)
    h, w, _ = bgr.shape
    return (f"P6\n{w} {h}\n255\n".encode("ascii")
            + np.ascontiguousarray(bgr[:, :, ::-1]).tobytes())


ENCODERS = {"png": encode_png, "bmp": encode_bmp, "ppm": encode_ppm}


def write_images(df: DataFrame, out_dir: str, image_col: str = "image",
                 format: str = "png") -> list[str]:
    """ImageSchema rows -> encoded files (reference ImageWriter). PNG, BMP
    and PPM are encoded here; any other format through cv2."""
    os.makedirs(out_dir, exist_ok=True)
    # seed with files already on disk so repeated writes never clobber either
    used = {os.path.splitext(f)[0] for f in os.listdir(out_dir)}
    written = []
    for i, row in enumerate(df.col(image_col)):
        if row is None:
            continue
        arr = image_to_array(row)
        name = os.path.splitext(os.path.basename(str(row["path"])) or
                                f"img{i}")[0]
        # basenames can collide across source directories — never clobber
        candidate, k = name, 0
        while candidate in used:
            k += 1
            candidate = f"{name}_{k}"
        used.add(candidate)
        out = os.path.join(out_dir, f"{candidate}.{format}")
        encode = ENCODERS.get(format.lower())
        if encode is None:
            import cv2
            ok, enc = cv2.imencode(f".{format}", arr)
            if not ok:
                raise ValueError(f"cv2 cannot encode {format!r}")
            data = enc.tobytes()
        else:
            data = encode(arr)
        with open(out, "wb") as f:
            f.write(data)
        written.append(out)
    return written

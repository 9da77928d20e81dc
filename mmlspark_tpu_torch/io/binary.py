"""Binary file ingest (reference: io/binary — BinaryFileFormat.scala:118,
BinaryRecordReader.scala:36 with zip inspection + seeded subsampling,
BinaryFileReader.read/recursePath).

Produces BinaryFileSchema rows (path, bytes). Zip archives are optionally
inspected so each entry becomes its own row, and subsampling is seeded and
per-file deterministic, matching the reference's sampling contract. The
port's copy of ``mmlspark_tpu/io/binary.py``: the same rows, in the same
order, for the same tree and seed."""

from __future__ import annotations

import fnmatch
import os
import zipfile
import zlib

import numpy as np

from ..core.dataframe import DataFrame
from ..core.schema import make_binary_row
from ..core.utils import object_column


def recurse_path(path: str, pattern: str = "*",
                 recursive: bool = True) -> list[str]:
    """All matching file paths under `path` (reference
    BinaryFileReader.recursePath)."""
    out = []
    if os.path.isfile(path):
        return [path]
    for root, dirs, files in os.walk(path):
        for f in sorted(files):
            if fnmatch.fnmatch(f, pattern):
                out.append(os.path.join(root, f))
        if not recursive:
            break
    return sorted(out)


def _keep(path: str, sample_ratio: float, seed: int) -> bool:
    """Per-file deterministic subsampling: hash(path, seed) < ratio."""
    if sample_ratio >= 1.0:
        return True
    h = zlib.crc32(f"{seed}:{path}".encode()) / 0xFFFFFFFF
    return h < sample_ratio


def read_binary_files(path: str, recursive: bool = True,
                      sample_ratio: float = 1.0, seed: int = 0,
                      inspect_zip: bool = True, pattern: str = "*",
                      npartitions: int = 1) -> DataFrame:
    """Directory/file -> DataFrame of BinaryFileSchema rows."""
    root = path if os.path.isdir(path) else os.path.dirname(path)
    rows = []
    for p in recurse_path(path, pattern, recursive):
        rel = os.path.relpath(p, root)  # sampling is stable across roots
        if inspect_zip and zipfile.is_zipfile(p):
            # zips are always opened; only ENTRIES are sampled (reference
            # ZipIterator semantics — no whole-archive drop)
            with zipfile.ZipFile(p) as zf:
                for name in sorted(zf.namelist()):
                    if name.endswith("/"):
                        continue
                    if _keep(f"{rel}::{name}", sample_ratio, seed):
                        rows.append(make_binary_row(f"{p}::{name}",
                                                    zf.read(name)))
        elif _keep(rel, sample_ratio, seed):
            with open(p, "rb") as f:
                rows.append(make_binary_row(p, f.read()))
    if not rows:
        return DataFrame({"path": np.array([], dtype=object),
                          "bytes": np.array([], dtype=object)})
    return DataFrame({"path": object_column([r["path"] for r in rows]),
                      "bytes": object_column([r["bytes"] for r in rows])},
                     npartitions=npartitions)

"""Image pipeline stages: ImageTransformer, UnrollImage, ImageSetAugmenter.

The port of ``mmlspark_tpu/ops/image_stages.py`` (reference:
ImageTransformer.scala:261, UnrollImage.scala:18-43,
image-featurizer/.../ImageSetAugmenter.scala:15): rows are grouped by image
shape into NHWC batches, and each batch crosses to ``device`` once as
uint8, runs the whole op chain there (``ops.image_ops``), is rounded and
clipped to uint8 there and comes back once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.env import resolve_device
from ..core.params import BooleanParam, ListParam, StringParam
from ..core.pipeline import Transformer
from ..core.schema import image_to_array, make_image_row, tag_image_column
from . import image_ops


def _rows_to_batches(col: np.ndarray):
    """Group image-struct rows by (h, w, c) so every batch is one shape.
    Yields (indices, NHWC uint8 batch, paths)."""
    groups: dict[tuple, list[int]] = {}
    for i, row in enumerate(col):
        groups.setdefault((row["height"], row["width"], row["type"]),
                          []).append(i)
    for idxs in groups.values():
        batch = np.stack([image_to_array(col[i]) for i in idxs])
        yield idxs, batch, [col[i]["path"] for i in idxs]


class ImageTransformer(Transformer):
    """Pipelined image processing (reference: ImageTransformer.scala:261).

    Ops are recorded as a list of ``{"op": name, **params}`` dicts via the
    fluent builder methods, mirroring the reference's stage-list param, and
    run as one chain per shape bucket on ``device``.
    """

    inputCol = StringParam("input image column", default="image")
    outputCol = StringParam("output image column", default="out")
    stages = ListParam("list of {op, **params} dicts", default=())
    device = StringParam(
        "torch device the op chain runs on: 'cuda' (default), 'cuda:N' or "
        "'cpu'. Asking for CUDA where there is none raises", default="cuda")

    def _add(self, d: dict) -> "ImageTransformer":
        self.setStages(tuple(self.getStages()) + (d,))
        return self

    def resize(self, height: int, width: int):
        return self._add({"op": "resize", "height": int(height),
                          "width": int(width)})

    def crop(self, x: int, y: int, height: int, width: int):
        return self._add({"op": "crop", "x": int(x), "y": int(y),
                          "height": int(height), "width": int(width)})

    def flip(self, flipCode: int = 1):
        return self._add({"op": "flip", "flipCode": int(flipCode)})

    def colorFormat(self, format: str):
        return self._add({"op": "colorformat", "format": format})

    def blur(self, height: float, width: float):
        return self._add({"op": "blur", "height": int(height),
                          "width": int(width)})

    def threshold(self, threshold: float, maxVal: float,
                  thresholdType: str = "binary"):
        return self._add({"op": "threshold", "threshold": float(threshold),
                          "maxVal": float(maxVal), "type": thresholdType})

    def gaussianKernel(self, appertureSize: int, sigma: float):
        return self._add({"op": "gaussiankernel",
                          "appertureSize": int(appertureSize),
                          "sigma": float(sigma)})

    def transform(self, df: DataFrame) -> DataFrame:
        dev = resolve_device(self.getDevice(), "ImageTransformer")
        col = df.col(self.getInputCol())
        ops = [dict(d) for d in self.getStages()]
        out = np.empty(len(col), dtype=object)
        for idxs, batch, paths in _rows_to_batches(col):
            x = torch.from_numpy(batch).to(dev).float()
            y = image_ops.run_chain(x, ops)
            # rint rounds half to even, as np.rint
            res = torch.round(y).clamp_(0, 255).to(torch.uint8).cpu().numpy()
            for j, i in enumerate(idxs):
                h, w, c = res[j].shape
                out[i] = make_image_row(paths[j], h, w, c, res[j])
        return tag_image_column(df.withColumn(self.getOutputCol(), out),
                                self.getOutputCol())


class UnrollImage(Transformer):
    """Image struct column -> flat CHW float vector column (reference:
    UnrollImage.scala:18-43). A host transpose and reshape: nothing here
    runs on a device."""

    inputCol = StringParam("input image column", default="image")
    outputCol = StringParam("output vector column", default="unrolled")

    def transform(self, df: DataFrame) -> DataFrame:
        col = df.col(self.getInputCol())
        out = np.empty(len(col), dtype=object)
        for i, row in enumerate(col):
            arr = image_to_array(row).astype(np.float64)
            out[i] = np.transpose(arr, (2, 0, 1)).ravel()
        return df.withColumn(self.getOutputCol(), out)


class ImageSetAugmenter(Transformer):
    """Dataset augmentation by flips (reference: ImageSetAugmenter.scala:15):
    emits the original rows plus flipped copies, flipped by an
    ImageTransformer on ``device``."""

    inputCol = StringParam("input image column", default="image")
    outputCol = StringParam("output image column", default="image")
    flipLeftRight = BooleanParam("add left-right flipped copies", default=True)
    flipUpDown = BooleanParam("add up-down flipped copies", default=False)
    device = StringParam(
        "torch device the flips run on: 'cuda' (default), 'cuda:N' or "
        "'cpu'", default="cuda")

    def transform(self, df: DataFrame) -> DataFrame:
        frames = [df.withColumn(self.getOutputCol(),
                                df.col(self.getInputCol()))]
        for flag, code in ((self.getFlipLeftRight(), 1),
                           (self.getFlipUpDown(), 0)):
            if flag:
                t = (ImageTransformer(device=self.getDevice())
                     .setInputCol(self.getInputCol())
                     .setOutputCol(self.getOutputCol()).flip(code))
                frames.append(t.transform(df))
        out = frames[0]
        for f in frames[1:]:
            out = out.union(f.select(*out.columns))
        return tag_image_column(out, self.getOutputCol())

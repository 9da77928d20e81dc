"""ImageFeaturizer: headless-net transfer learning as one pipeline stage.

The port of ``mmlspark_tpu/models/image_featurizer.py`` (reference:
image-featurizer/.../ImageFeaturizer.scala:117-142): ``ImageTransformer``
resizes the images to the net's input shape, and a ``TorchModel`` cut
``cutOutputLayers`` layers from the top (``outputLayer =
layerNames()[-(1 + cut)]``) emits feature vectors instead of class scores.
Activations of shape (H, W, C) are flattened in that order. One inner
``TorchModel`` is kept across transforms, so the weights go to the device
once.
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, IntParam, StringParam
from ..core.pipeline import Transformer
from ..core.schema import findUnusedColumnName, tag_image_column
from ..ops.image_stages import ImageTransformer
from .torch_model import TorchModel


class ImageFeaturizer(Transformer):
    """Featurize an image column with a truncated pre-trained net.

    ``cutOutputLayers`` counts layers removed from the top (reference default
    1 = drop the classifier head); 0 keeps the full net (scoring mode).
    The resize and the net run on ``device``, whatever the device of the
    TorchModel handed in.
    """

    inputCol = StringParam("input image column", default="image")
    outputCol = StringParam("output feature-vector column", default="features")
    cutOutputLayers = IntParam("layers cut from the top (0 = full net)",
                               default=1, min=0)
    model = ComplexParam("inner TorchModel holding config+params",
                         default=None)
    device = StringParam(
        "torch device of the resize and the net: 'cuda' (default), "
        "'cuda:N' or 'cpu'. Asking for CUDA where there is none raises",
        default="cuda")

    # ---- model wiring (ModelDownloader handoff) ----
    def setModel(self, model: TorchModel) -> "ImageFeaturizer":
        return self.set(model=model)

    def setModelLocation(self, path: str) -> "ImageFeaturizer":
        return self.setModel(TorchModel().setModelLocation(path))

    def setModelSchema(self, schema) -> "ImageFeaturizer":
        """Accepts a ModelSchema from the port's ModelDownloader (the
        reference's setModel(ModelSchema), ImageFeaturizer.scala:60-66)."""
        return self.setModel(TorchModel().setModelSchema(schema))

    def layerNames(self) -> list[str]:
        return self.getModel().layerNames()

    def transform(self, df: DataFrame) -> DataFrame:
        tm = self.getModel()
        if tm is None or tm.getModelParams() is None:
            raise ValueError("ImageFeaturizer has no model; call setModel / "
                             "setModelLocation / setModelSchema")
        cfg = tm.getModelConfig()
        h = int(cfg.get("height", 32))
        w = int(cfg.get("width", 32))
        layers = tm.layerNames()
        cut = self.getCutOutputLayers()
        if cut >= len(layers):
            raise ValueError(f"cutOutputLayers={cut} >= model depth "
                             f"{len(layers)}")
        output_layer = "" if cut == 0 else layers[-(1 + cut)]

        rcol = findUnusedColumnName("resized", df)
        tmp = tag_image_column(
            df.withColumn(rcol, df.col(self.getInputCol())), rcol)
        tmp = (ImageTransformer(device=self.getDevice()).setInputCol(rcol)
               .setOutputCol(rcol).resize(h, w).transform(tmp))

        # one inner TorchModel across transforms, so its device module (the
        # weights on the card) is reused; the key holds a strong reference
        # to the params, so a new object can never alias a freed one
        ckey = (tm.getModelParams(), output_layer, repr(sorted(cfg.items())),
                tm.getMiniBatchSize(), self.getDevice())
        prev = getattr(self, "_inner_key", None)
        if prev is None or prev[0] is not ckey[0] or prev[1:] != ckey[1:]:
            self._inner = TorchModel(
                modelConfig=cfg, modelParams=tm.getModelParams(),
                outputLayer=output_layer,
                miniBatchSize=tm.getMiniBatchSize(), device=self.getDevice())
            self._inner_key = ckey
        inner = (self._inner.setInputCol(rcol)
                 .setOutputCol(self.getOutputCol()))
        out = inner.transform(tmp).drop(rcol)

        # intermediate activations may be (H, W, C); flatten to vectors so
        # the column feeds straight into a learner
        col = out.col(self.getOutputCol())
        if col.dtype.kind == "O" and len(col) and np.ndim(col[0]) > 1:
            flat = np.empty(len(col), dtype=object)
            for i in range(len(col)):
                flat[i] = np.asarray(col[i]).ravel()
            out = out.withColumn(self.getOutputCol(), flat)
        return out

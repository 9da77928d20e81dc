"""mmlspark_tpu_torch — the PyTorch/CUDA port of mmlspark_tpu.

A second package beside the JAX one, with the same stages, Params and
DataFrame contract, for one NVIDIA H100. It imports torch and numpy, never
jax or anything of ``mmlspark_tpu``. Entry points run on CUDA unless the
caller asks for the CPU.

Ported so far (ROADMAP.md), over the causal ``TransformerEncoder``:
the serving path — DataFrame of token ids -> ``TorchModel.transform`` ->
scores column — and the training path — DataFrame of token ids and labels
-> ``TorchLearner.fit`` -> a ``TorchModel``. Attention runs in hand-written
CUDA flash-attention kernels: the forward
(``ops/csrc/flash_attention_fwd.cu``) and the dq and dk/dv backward
(``ops/csrc/flash_attention_bwd.cu``).

Gradient-boosted trees: DataFrame of feature vectors and labels ->
``LightGBMClassifier.fit`` / ``LightGBMRegressor.fit`` (level-wise, or
leaf-wise with categorical set splits and EFB bundles of wide sparse
inputs) -> a model whose ``transform`` scores rows. The node histogram, the
v1 fused histogram and the quantized level-wise and leaf-wise ensemble
predicts are hand-written CUDA kernels (``ops/csrc/gbdt_histogram.cu``,
``ops/csrc/gbdt_predict.cu``).

The image path: every model family of ``build_model`` (MLP, ConvNet,
ResNet, the ResNet-50 class, BiLSTM, transformer); ``ops.image_stages``
(``ImageTransformer``, ``UnrollImage``, ``ImageSetAugmenter``) over
image-row columns; ``TorchLearner`` on uint8 image columns; the model
zoo's packed artifacts through ``models.downloader.ModelDownloader``;
``models.import_weights.import_resnet50`` and
``models.image_featurizer.ImageFeaturizer``. It runs on cuDNN/cuBLAS
through torch.

The serving path (``io.http``, ``io.serving``): an HTTP source and loops,
continuous batching with one CUDA graph per shape bucket, the serving
bundle and the warm-restarting worker
(``python -m mmlspark_tpu_torch.io.http.worker --bundle DIR``).

Importing the package loads torch and registers the flash forward as the
operator ``mmlspark_torch::flash_attention_fwd``, so a program that
``TorchModel.exportStableHLO`` wrote loads with ``torch.export.load``;
the model families and stages load on first use.
"""

from .core.dataframe import DataFrame
from .core.pipeline import Pipeline, PipelineModel
from .ops import flash_attention as _flash_attention  # noqa: F401

__all__ = ["DataFrame", "LightGBMClassificationModel", "LightGBMClassifier",
           "LightGBMRegressionModel", "LightGBMRegressor", "Pipeline",
           "PipelineModel", "TorchLearner", "TorchModel", "build_model"]

_GBDT_STAGES = ("LightGBMClassifier", "LightGBMClassificationModel",
                "LightGBMRegressor", "LightGBMRegressionModel")


def __getattr__(name):
    if name == "TorchModel":
        from .models.torch_model import TorchModel
        return TorchModel
    if name == "TorchLearner":
        from .models.trainer import TorchLearner
        return TorchLearner
    if name == "build_model":
        from .models.modules import build_model
        return build_model
    if name in _GBDT_STAGES:
        from .models.gbdt import stages
        return getattr(stages, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

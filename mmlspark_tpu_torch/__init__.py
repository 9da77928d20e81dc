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

Importing the package stays light: torch loads on first use of
``TorchModel``, ``TorchLearner`` or ``build_model``.
"""

from .core.dataframe import DataFrame
from .core.pipeline import Pipeline, PipelineModel

__all__ = ["DataFrame", "Pipeline", "PipelineModel", "TorchLearner",
           "TorchModel", "build_model"]


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
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

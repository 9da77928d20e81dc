"""Continuous-batching serving engine on CUDA graphs: the port of
``mmlspark_tpu/io/serving``.

Dynamic batching into a static set of power-of-two shape buckets under a
max-wait deadline (:mod:`.batcher`), a fused decode -> pad -> one graph
replay -> unpad step per bucket (:mod:`.step`), every bucket captured as a
``torch.cuda.CUDAGraph`` ahead of live traffic through the profiler's AOT
cache (``telemetry.profiler.wrap(..., aot=True)``), and a versioned,
manifest-committed model + capture bundle (:mod:`.bundle`) from which a
restarted worker captures every bucket again before its first request,
with no ``nvcc`` run. Admission control rides the SLO ``should_shed()``
and queue-bound machinery of ``io.http.server``.
"""

from .batcher import BucketPolicy, ContinuousBatcher, pow2_bucket
from .bundle import BUNDLE_HEAD, load_bundle, save_bundle
from .engine import ContinuousServingLoop, serve_continuous
from .step import FusedServingStep

__all__ = ["BucketPolicy", "ContinuousBatcher", "ContinuousServingLoop",
           "FusedServingStep", "BUNDLE_HEAD", "load_bundle",
           "save_bundle", "serve_continuous", "pow2_bucket"]

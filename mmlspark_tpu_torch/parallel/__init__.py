"""The distributed substrate over ``torch.distributed`` (mesh, rendezvous,
data plane, collectives, the parallel plan), the attention forms (plain,
blockwise, ring and Ulysses), GPipe pipelining and the bounded host
prefetcher."""

from . import (collectives, dataplane, distributed, mesh, pipeline_parallel,
               prefetch, sequence)
from .dataplane import ShardedDataFrame, shard_paths
from .mesh import (batch_sharding, create_mesh, make_mesh,
                   pad_batch_to_devices, replicated, shard_batch,
                   shard_params_tp)
from .pipeline_parallel import (pipeline_apply, shard_pipeline_params,
                                stack_stage_params)
from .prefetch import DevicePrefetcher, prefetched

__all__ = ["mesh", "sequence", "distributed", "pipeline_parallel",
           "dataplane", "prefetch", "collectives", "ShardedDataFrame",
           "shard_paths", "create_mesh", "make_mesh", "batch_sharding",
           "replicated", "shard_batch", "pad_batch_to_devices",
           "shard_params_tp", "pipeline_apply", "stack_stage_params",
           "shard_pipeline_params", "DevicePrefetcher", "prefetched"]

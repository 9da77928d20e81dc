"""Generic pipeline stages of the port: the port of ``mmlspark_tpu/stages``
(basic, data-shaping and mini-batch stages, and the column UDF helpers).
Every class registers in the port's stage registry on import."""

from . import udfs
from .basic import (Cacher, CheckpointData, ClassBalancer, ClassBalancerModel,
                    DropColumns, FastVectorAssembler, MultiColumnAdapter,
                    Profiler, RenameColumn, Repartition, SelectColumns, Timer,
                    UDFTransformer)
from .data_stages import (CleanMissingData, CleanMissingDataModel,
                          DataConversion, EnsembleByKey, PartitionSample,
                          SummarizeData, TextPreprocessor)
from .minibatch import FlattenBatch, MiniBatchTransformer

__all__ = [n for n in dir() if not n.startswith("_")]

"""Runtime data movement (counterpart of ``mxnet_tpu/runtime/``), shared
by training and serving:

* :mod:`.staging` — host-to-device transfers (``stage_pytree``) and the
  bounded in-flight :class:`~.staging.PipelineWindow` that the serving
  dispatcher and the streaming input pipeline both run on;
* :mod:`.source` — shard-aware record sources (``num_parts`` /
  ``part_index`` partitions, disjoint and complete) with seedable,
  checkpointable epoch order;
* :mod:`.pipeline` — :class:`~.pipeline.StreamingIter`, the streaming
  input pipeline: parallel host decode workers, batch assembly off the
  training thread and device staging ahead of the consumer, with
  per-stage ``io.*`` metrics.
"""
from . import pipeline, source, staging
from .pipeline import (StreamingIter, io_pipeline_key,
                       resolve_decode_backend, resolve_decode_workers,
                       resolve_prefetch_depth)
from .source import RecordFileSource, shard_partition
from .staging import PipelineWindow, stage_pytree

__all__ = ["staging", "source", "pipeline", "stage_pytree",
           "PipelineWindow", "RecordFileSource", "shard_partition",
           "StreamingIter", "io_pipeline_key", "resolve_decode_backend",
           "resolve_decode_workers", "resolve_prefetch_depth"]

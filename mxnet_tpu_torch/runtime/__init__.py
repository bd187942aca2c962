"""Runtime data movement (counterpart of ``mxnet_tpu/runtime/``): the
staging half, :mod:`.staging` (``stage_pytree`` and the bounded in-flight
:class:`~.staging.PipelineWindow` the serving dispatcher runs on). The
streaming input pipeline (``pipeline.py``) and the shard-aware record
sources (``source.py``) wait for ROADMAP A12."""
from . import staging
from .staging import PipelineWindow, stage_pytree

__all__ = ["staging", "stage_pytree", "PipelineWindow"]

"""Kernels and parallel training of the port (counterpart of
``mxnet_tpu/parallel/``): the fused matmul, flash attention, the
single-device mesh and its shardings, ``ShardedTrainer`` (a Symbol's
training step captured as a CUDA graph) and the causal-LM transformer
step. ``ring_attention`` and ``pipeline_apply`` need more than one device
(ROADMAP.md Queue A10)."""
from .mesh import make_mesh, data_parallel_sharding, replicated_sharding
from .trainer import ShardedTrainer
from .ring_attention import attention_reference
from .flash_attention import flash_attention
from .transformer import TransformerParallel

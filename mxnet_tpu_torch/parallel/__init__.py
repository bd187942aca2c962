"""Kernels and parallel training of the port (counterpart of
``mxnet_tpu/parallel/``): the fused matmul, flash attention, the
single-device mesh and the causal-LM transformer step."""
from .mesh import make_mesh
from .ring_attention import attention_reference
from .flash_attention import flash_attention
from .transformer import TransformerParallel

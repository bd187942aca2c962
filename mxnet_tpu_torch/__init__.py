"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, slice by slice.

``import mxnet_tpu_torch as mx`` gives the same public names as
``mxnet_tpu`` for the ported slices: the symbol frontend (``mx.sym``),
model builders (``mx.models``), the graph-pass layer (``mx.graph_pass``),
inference serving (``mx.serving``), the kernels and transformer
training step (``mx.parallel``), and symbolic training: ``mx.nd``,
``mx.mod.Module``, ``mx.init``, ``mx.optimizer``, ``mx.metric``,
``mx.io``, ``mx.kv``, ``mx.callback``. Entry points run on the CUDA card
unless the caller passes ``mx.cpu()``. The package imports torch and
numpy, never jax and nothing of ``mxnet_tpu``.
"""
from . import base
from .base import MXNetError, NameManager, AttrScope
from . import config
from .context import cpu, gpu
from . import ops
from . import symbol
from . import symbol as sym
from . import graph_pass
from . import executor
from . import ndarray
from . import ndarray as nd
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import metric
from . import io
from . import kvstore
from . import kvstore as kv
from . import model
from . import callback
from . import module
from . import module as mod
from . import models
from . import serving
from . import parallel
from .convert import params_from_jax

__version__ = "0.1.0"

"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, slice by slice.

``import mxnet_tpu_torch as mx`` gives the same public names as
``mxnet_tpu`` for the ported slices: the symbol frontend (``mx.sym``),
model builders (``mx.models``), the graph-pass layer (``mx.graph_pass``),
inference serving (``mx.serving``) with its telemetry, fault injection,
staging and tuning cache (``mx.observability``, ``mx.resilience``,
``mx.runtime``, ``mx.autotune``), the kernels and transformer
training step (``mx.parallel``), and symbolic training: ``mx.nd``,
``mx.mod.Module``, ``mx.init``, ``mx.optimizer``, ``mx.metric``,
``mx.io``, ``mx.kv``, ``mx.callback``, ``mx.mon``; imperative autograd
(``mx.autograd``), custom operators (``mx.operator``), runtime CUDA
kernels compiled by NVRTC (``mx.rtc``), the random generators
(``mx.random``), the symbolic RNN toolkit (``mx.rnn``), Gluon
(``mx.gluon``), and data and IO: RecordIO (``mx.recordio``), the image
pipeline (``mx.image`` / ``mx.img``) and the record iterators, with
resumable training (``fit(resume=)``, ``mx.resilience``), the legacy
``mx.model.FeedForward``, ``mx.visualization`` / ``mx.viz``,
``mx.contrib`` and the reference's small facades (``mx.attribute``,
``mx.name``, ``mx.registry``, ``mx.engine``, ``mx.storage``, ``mx.log``,
``mx.libinfo``, ``mx.executor_manager``, fluent methods on NDArray and
Symbol). Entry points run on the CUDA card
unless the caller passes ``mx.cpu()`` or opens ``with mx.cpu():``. The
package imports torch and numpy, never jax and nothing of ``mxnet_tpu``.
"""
from . import base
from .base import MXNetError, NameManager, AttrScope, Prefix
from . import config
from .context import (Context, cpu, gpu, tpu, cpu_pinned, current_context,
                      num_gpus)
from . import autograd
from . import random
from . import random as rnd
from . import ops
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import graph_pass
from . import executor
from .executor import Executor
from . import ndarray
from . import ndarray as nd
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import optimizer as opt
from . import metric
from . import io
from . import recordio
from . import kvstore
from . import kvstore as kv
from . import model
from . import callback
from . import module
from . import module as mod
from . import monitor
from . import monitor as mon
from .monitor import Monitor
from . import models
from . import observability
from . import profiler
from . import resilience
from . import runtime
from . import autotune
from . import serving
from . import parallel
from . import rtc
from . import test_utils
from . import rnn
from . import gluon
from . import image
from . import image as img
from . import storage
from . import attribute
from . import name
from . import log
from . import libinfo
from . import engine
from . import executor_manager
from . import registry
from . import contrib
from . import visualization
from . import visualization as viz
from . import operator
from .operator import _install_frontends as _iff
from .convert import gluon_params_from_jax, params_from_jax

_iff()
del _iff

from .fluent import install as _install_fluent  # noqa: E402
from .fluent import NotImplementedForSymbol  # noqa: E402,F401

_install_fluent()
del _install_fluent

__version__ = "0.1.0"

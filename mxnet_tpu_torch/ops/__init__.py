"""Operator library — registration side (counterpart of
``mxnet_tpu/ops/``). Importing this package registers every ported op
into :mod:`.registry`, from which ``mx.sym`` is generated."""
from . import registry
from .registry import OP_REGISTRY, get_op, list_ops, register_op

# op definition modules — import order is registration order only
from . import elemwise
from . import broadcast_reduce
from . import matrix
from . import indexing
from . import nn
from . import random_ops
from . import fused
from . import optimizer_ops
from . import init_ops
from . import rnn
from . import detection
from . import spatial
from . import linalg
from . import legacy_ops
from . import contrib
from . import fork_ops
from .. import operator as _operator  # noqa: F401  (registers Custom)

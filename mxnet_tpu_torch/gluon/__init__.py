"""Gluon: the imperative / hybridizable frontend (reference:
python/mxnet/gluon/).

Counterpart of ``mxnet_tpu/gluon/``: the Block family, the Parameter
machinery, Trainer (with ``compile_step``), and the nn, loss, data,
model_zoo, rnn, contrib and utils subpackages.
"""
from . import contrib, data, loss, model_zoo, nn, rnn, utils  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (DeferredInitializationError, Parameter,  # noqa: F401
                        ParameterDict)
from .trainer import Trainer  # noqa: F401

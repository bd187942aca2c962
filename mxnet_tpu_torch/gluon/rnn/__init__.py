"""Gluon recurrent API: cells (step-wise) and fused layers.

Counterpart of ``mxnet_tpu/gluon/rnn/`` at the reference gluon/rnn
package's import location.
"""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403

from . import rnn_cell as _cells, rnn_layer as _layers

__all__ = list(_cells.__all__) + list(_layers.__all__)

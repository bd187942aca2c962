"""Contrib recurrent cells (Conv*Cells, VariationalDropoutCell);
counterpart of ``mxnet_tpu/gluon/contrib/rnn/``."""
from .conv_rnn_cell import *  # noqa: F401,F403
from .rnn_cell import *  # noqa: F401,F403

from . import conv_rnn_cell as _conv, rnn_cell as _plain

__all__ = list(_conv.__all__) + list(_plain.__all__)

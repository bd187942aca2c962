"""Symbolic (pre-Gluon) RNN toolkit — BucketingModule's companion.

Counterpart of ``mxnet_tpu/rnn/`` (its own copy: the port imports nothing
of the JAX package): the cells, ``BucketSentenceIter`` and the RNN
checkpoint helpers."""
from .io import BucketSentenceIter, encode_sentences  # noqa: F401
from .conv_rnn_cell import (BaseConvRNNCell, ConvGRUCell,  # noqa: F401
                            ConvLSTMCell, ConvRNNCell)
from .rnn import (do_rnn_checkpoint, load_rnn_checkpoint,  # noqa: F401
                  rnn_unroll, save_rnn_checkpoint)
from .rnn_cell import *  # noqa: F401,F403

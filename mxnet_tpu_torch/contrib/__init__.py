"""Experimental/contrib namespaces (reference: python/mxnet/contrib/ —
the old experimental autograd API, the TensorBoard metric callback, and
the contrib op namespaces re-exported from nd/sym). Counterpart of
``mxnet_tpu/contrib/``."""
from . import autograd
from . import tensorboard
from ..ndarray import contrib as ndarray  # noqa: F401  (mx.contrib.ndarray.*)
from ..symbol import contrib as symbol  # noqa: F401  (mx.contrib.symbol.*)

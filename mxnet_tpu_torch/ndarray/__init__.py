"""NDArray package: the imperative frontend (counterpart of
``mxnet_tpu/ndarray/``). Importing it registers every ported op and
generates the ``nd.*`` functions from the registry; ``nd.save`` and
``nd.load`` read and write the reference ``.params`` format."""
from .. import ops as _ops  # noqa: F401  (registers every op)

from .ndarray import (NDArray, array, zeros, ones, full, empty, concatenate,
                      waitall)
from . import op
from . import utils
from .utils import save, load
from . import _internal
from .register import populate_namespaces as _populate

_populate(op, _internal)

globals().update(
    {k: v for k, v in op.__dict__.items() if not k.startswith("__")})

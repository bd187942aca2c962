"""NDArray package: the imperative frontend (counterpart of
``mxnet_tpu/ndarray/``). Importing it registers every ported op and
generates the ``nd.*`` functions from the registry. ``nd.save`` and
``nd.load`` in the reference ``.params`` format are not ported yet."""
from .. import ops as _ops  # noqa: F401  (registers every op)

from .ndarray import (NDArray, array, zeros, ones, full, empty, concatenate,
                      waitall)
from . import op
from . import _internal
from .register import populate_namespaces as _populate

_populate(op, _internal)

globals().update(
    {k: v for k, v in op.__dict__.items() if not k.startswith("__")})

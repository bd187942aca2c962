"""NDArray package: the imperative frontend (counterpart of
``mxnet_tpu/ndarray/``). Importing it registers every ported op and
generates the ``nd.*`` functions from the registry; ``nd.save`` and
``nd.load`` read and write the reference ``.params`` format;
``nd.random`` names the samplers by distribution; ``nd.contrib`` holds the
``_contrib_*`` ops under their short names; ``nd.sparse`` holds the sparse
storage types, and ``nd.cast_storage`` / ``sparse_retain`` / ``square_sum``
are its storage-aware functions (over the registry's dense ops of those
names)."""
from .. import ops as _ops  # noqa: F401  (registers every op)

from .ndarray import (NDArray, array, zeros, ones, full, empty, arange,
                      concatenate, moveaxis, waitall)
from . import op
from . import utils
from .utils import save, load
from . import _internal
from . import contrib
from .register import populate_namespaces as _populate

_populate(op, _internal, contrib)
from . import random  # noqa: E402  (over the generated _internal ops)

globals().update(
    {k: v for k, v in op.__dict__.items() if not k.startswith("__")})

from . import sparse  # noqa: E402
from .sparse import (BaseSparseNDArray, RowSparseNDArray,  # noqa: E402
                     CSRNDArray, cast_storage, sparse_retain, square_sum)

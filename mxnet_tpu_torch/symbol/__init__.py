"""Symbol package: the declarative frontend (counterpart of
``mxnet_tpu/symbol/``)."""
from .. import ops as _ops  # noqa: F401  (registers every op)

from .symbol import Symbol, var, Variable, Group, load, load_json
from . import op
from . import _internal
from . import contrib
from .register import populate_namespaces as _populate

_populate(op, _internal, contrib)

globals().update(
    {k: v for k, v in op.__dict__.items() if not k.startswith("__")})


# creation sugar matching mx.sym.zeros/ones/arange (map onto init ops)
def zeros(shape, dtype=None, **kwargs):
    return _internal._zeros(shape=shape, dtype=dtype or "float32", **kwargs)


def ones(shape, dtype=None, **kwargs):
    return _internal._ones(shape=shape, dtype=dtype or "float32", **kwargs)


def arange(start, stop=None, step=1.0, repeat=1, dtype=None, **kwargs):
    return _internal._arange(start=start, stop=stop, step=step, repeat=repeat,
                             dtype=dtype or "float32", **kwargs)

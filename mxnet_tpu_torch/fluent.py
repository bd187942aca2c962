"""Fluent convenience methods on NDArray and Symbol.

Counterpart of ``mxnet_tpu/fluent.py``. Reference:
python/mxnet/ndarray/ndarray.py + symbol/symbol.py define
per-op fluent methods (``x.exp()``, ``x.sum(axis=1)``,
``sym.reshape(shape=...)``) that delegate to the registry functions with
the instance as first input. Here one installer generates them from the
same name list for both frontends; NDArray-only operations become
``NotImplementedForSymbol``-raising stubs on Symbol, exactly like the
reference (symbol.py:2335-2354). ``NDArray.tostype`` comes with the
storage cast of the sparse family (``ROADMAP.md`` Queue A)."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["install", "NotImplementedForSymbol"]


class NotImplementedForSymbol(MXNetError):
    """Raised by NDArray-only methods on Symbol (reference: base.py:61)."""

    def __init__(self, function, alias, *args):
        super().__init__()
        self.function = getattr(function, "__name__", str(function))
        self.alias = alias
        self.args = [str(type(a)) for a in args]

    def __str__(self):
        msg = "Function %s" % self.function
        if self.alias:
            msg += ' (namely operator "%s")' % self.alias
        if self.args:
            msg += " with arguments (%s)" % ", ".join(self.args)
        msg += " is not supported for Symbol and only available in NDArray."
        return msg


# fluent method name == registry function name, same for both frontends
_FLUENT = [
    "abs", "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh",
    "argmax", "argmax_channel", "argmin", "argsort", "broadcast_axes",
    "broadcast_to", "cbrt", "ceil", "clip", "cos", "cosh", "degrees",
    "exp", "expand_dims", "expm1", "fix", "flatten", "flip", "floor",
    "log", "log10", "log1p", "log2", "log_softmax", "max", "mean", "min",
    "nanprod", "nansum", "norm", "one_hot", "ones_like", "pad", "pick",
    "prod", "radians", "rcbrt", "reciprocal", "relu", "repeat", "reshape",
    "reshape_like", "rint", "round", "rsqrt", "sigmoid", "sign", "sin",
    "sinh", "slice", "slice_axis", "softmax", "sort", "split", "sqrt",
    "square", "sum", "swapaxes", "take", "tan", "tanh", "tile", "topk",
    "transpose", "trunc", "zeros_like",
]

# NDArray-only surface stubbed on Symbol (reference symbol.py:2335)
_ND_ONLY = ["wait_to_read", "asnumpy", "asscalar", "copy",
            "as_in_context", "detach", "backward", "gradient"]


def _make_fluent(ns, name):
    def method(self, *args, **kwargs):
        return getattr(ns, name)(self, *args, **kwargs)

    method.__name__ = name
    method.__doc__ = ("Convenience fluent method for :py:func:`%s` with "
                      "this array as the first input." % name)
    return method


def _make_stub(name):
    def method(self, *args, **kwargs):
        raise NotImplementedForSymbol(method, None, *args)

    method.__name__ = name
    return method


def install():
    """Install fluent methods; called once at package import."""
    from . import ndarray as nd_ns
    from . import symbol as sym_ns
    from .ndarray.ndarray import NDArray
    from .symbol.symbol import Symbol

    for name in _FLUENT:
        if not hasattr(NDArray, name) and hasattr(nd_ns, name):
            setattr(NDArray, name, _make_fluent(nd_ns, name))
        if not hasattr(Symbol, name) and hasattr(sym_ns, name):
            setattr(Symbol, name, _make_fluent(sym_ns, name))
    if not hasattr(Symbol, "astype"):
        def astype(self, dtype):
            """Insert a Cast (the reference Symbol.astype delegates to
            the Cast op)."""
            return sym_ns.Cast(self, dtype=dtype)

        Symbol.astype = astype
    if not hasattr(NDArray, "tostype"):
        def tostype(self, stype):
            """This array in storage type ``stype`` (the storage-aware
            ``nd.cast_storage``)."""
            return nd_ns.cast_storage(self, stype)

        NDArray.tostype = tostype
    for name in _ND_ONLY:
        if not hasattr(Symbol, name):
            setattr(Symbol, name, _make_stub(name))

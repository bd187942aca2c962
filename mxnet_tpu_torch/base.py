"""Core shared plumbing: error type, name manager, attribute scope, dtypes.

Counterpart of ``mxnet_tpu/base.py``. The port is Python over PyTorch; dtype
names (``"float32"``, ``"bfloat16"``, ...) are the common currency, and
:func:`torch_dtype` maps them onto ``torch.dtype`` for the tensors.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["MXNetError", "NameManager", "Prefix", "AttrScope", "np_dtype",
           "torch_dtype", "dtype_name", "string_types"]

string_types = (str,)


class MXNetError(RuntimeError):
    """Error raised by mxnet_tpu_torch."""


_thread_state = threading.local()


class NameManager:
    """Auto-naming for symbols, ``with``-scoped: ``<hint>N`` names when the
    user gives none."""

    def __init__(self):
        self._counter = {}

    @staticmethod
    def current():
        stack = getattr(_thread_state, "name_stack", None)
        if not stack:
            _thread_state.name_stack = [NameManager()]
        return _thread_state.name_stack[-1]

    def get(self, name, hint):
        if name:
            return name
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return "%s%d" % (hint, count)

    def __enter__(self):
        NameManager.current()
        _thread_state.name_stack.append(self)
        return self

    def __exit__(self, *exc):
        _thread_state.name_stack.pop()


class Prefix(NameManager):
    """A NameManager that prepends ``prefix`` to every name it gives."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


class AttrScope:
    """``with``-scope attaching string attributes to the symbols created
    inside it."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, string_types):
                raise ValueError("Attributes need to be string")
        self._attr = kwargs

    @staticmethod
    def current():
        stack = getattr(_thread_state, "attr_stack", None)
        if not stack:
            _thread_state.attr_stack = [AttrScope()]
        return _thread_state.attr_stack[-1]

    def get(self, attr):
        """Merge scope attrs into user attrs (user wins)."""
        if self._attr:
            ret = dict(self._attr)
            ret.update(attr or {})
            return ret
        return dict(attr) if attr else {}

    def __enter__(self):
        merged = AttrScope()
        merged._attr = dict(AttrScope.current()._attr, **self._attr)
        _thread_state.attr_stack.append(merged)
        return self

    def __exit__(self, *exc):
        _thread_state.attr_stack.pop()


_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def dtype_name(dtype):
    """Canonical string name of a dtype given as a string, numpy dtype or
    type, or ``torch.dtype``."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def np_dtype(dtype):
    """Normalize a dtype spec to ``np.dtype``. numpy has no bfloat16 of its
    own: that name resolves through the ``ml_dtypes`` package, and raises
    where it is not installed."""
    if dtype is None:
        return None
    name = dtype_name(dtype)
    if name == "bfloat16":
        try:
            import ml_dtypes
        except ImportError:
            raise MXNetError("a numpy bfloat16 array needs the ml_dtypes "
                             "package; keep bfloat16 data in torch tensors")
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def torch_dtype(dtype):
    """``torch.dtype`` for a dtype name, numpy dtype or torch dtype."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype_name(dtype)
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise MXNetError("unsupported dtype %r" % (dtype,))

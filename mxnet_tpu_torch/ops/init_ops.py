"""Creation ops: ``_zeros``, ``_ones``, ``_full`` and ``_arange``, behind
``mx.sym.zeros`` / ``ones`` / ``arange``.

Counterpart of ``mxnet_tpu/ops/init_ops.py``. An op without inputs creates
its tensor on the device its ``ctx`` attribute names, else in the innermost
``with`` scope, else on the card: the executor walks a bound graph in the
scope of its arrays' device, so the tensor lands beside them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import np_dtype, torch_dtype
from ..context import as_device
from .param import DType, Float, Int, Shape, Str
from .registry import register_op


def _creation(fill):
    def fn(attrs):
        return fill(tuple(attrs.shape), dtype=torch_dtype(attrs.dtype),
                    device=as_device(attrs.ctx or None))
    return fn


def _full(attrs):
    return torch.full(tuple(attrs.shape), attrs.value,
                      dtype=torch_dtype(attrs.dtype),
                      device=as_device(attrs.ctx or None))


def arange_values(start, stop, step, repeat, dtype):
    """numpy's ``arange`` (``stop`` None counts from 0 to ``start``) in
    ``dtype``, each value repeated ``repeat`` times: the JAX package's
    values."""
    a = np.arange(start, stop, step, dtype=np_dtype(dtype))
    return np.repeat(a, repeat) if repeat != 1 else a


def _arange(attrs):
    a = arange_values(attrs.start, attrs.stop, attrs.step, attrs.repeat,
                      attrs.dtype)
    return torch.from_numpy(a).to(as_device(attrs.ctx or None))


def _arange_shape(attrs, i, a):
    n = len(np.arange(attrs.start, attrs.stop, attrs.step)) * attrs.repeat
    return ([], [(n,)], a)


def _register():
    def same(attrs, i, a):
        return ([], [tuple(attrs.shape)], a)

    def dtype_of(attrs, i, a):
        return ([], [attrs.dtype], a)

    base = {"shape": Shape(default=()), "ctx": Str(default=""),
            "dtype": DType(default="float32")}
    for name, fn, params in (
            ("_zeros", _creation(torch.zeros), base),
            ("_ones", _creation(torch.ones), base),
            ("_full", _full, dict(base, value=Float()))):
        register_op(name, fn, params=params, num_inputs=0, input_names=[],
                    infer_shape=same, infer_dtype=dtype_of)
    register_op("_arange", _arange,
                params={"start": Float(default=0.0),
                        "stop": Float(default=None),
                        "step": Float(default=1.0), "repeat": Int(default=1),
                        "ctx": Str(default=""),
                        "dtype": DType(default="float32")},
                num_inputs=0, input_names=[], infer_shape=_arange_shape,
                infer_dtype=dtype_of)


_register()

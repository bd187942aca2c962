"""Creation ops: ``_zeros`` and ``_ones``, behind ``mx.sym.zeros`` /
``mx.sym.ones``.

Counterpart of ``mxnet_tpu/ops/init_ops.py``, limited to those two (the
JAX package's ``_full`` and ``_arange`` are not ported yet). An op without
inputs creates its tensor on the device its ``ctx`` attribute names, else
in the innermost ``with`` scope: the executor walks a bound graph in the
scope of its arrays' device, so the tensor lands beside them.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from ..context import as_device
from .param import DType, Shape, Str
from .registry import register_op


def _creation(fill):
    def fn(attrs):
        return fill(tuple(attrs.shape), dtype=torch_dtype(attrs.dtype),
                    device=as_device(attrs.ctx or None))
    return fn


def _register():
    for name, fill in (("_zeros", torch.zeros), ("_ones", torch.ones)):
        register_op(
            name, _creation(fill),
            params={"shape": Shape(default=()), "ctx": Str(default=""),
                    "dtype": DType(default="float32")},
            num_inputs=0, input_names=[],
            infer_shape=lambda attrs, i, a: ([], [tuple(attrs.shape)], a),
            infer_dtype=lambda attrs, i, a: ([], [attrs.dtype], a))


_register()

"""Elementwise unary, binary and tensor-scalar operators.

Counterpart of ``mxnet_tpu/ops/elemwise.py``, limited to the ops the ported
slice emits: the ResNet graph, the ``bn_fold`` scale/bias arithmetic and
the scalar steps of the fuse grammar.
"""
from __future__ import annotations

import torch

from .param import Float
from .registry import alias_op, register_op


def _elemwise_infer(n_in, n_out=1):
    """Same-shape inference with per-dim merge: known dims of any input fix
    the unknown (0) dims of the rest."""

    def infer(attrs, in_shapes, aux_shapes):
        merged = None
        for s in in_shapes:
            if s is None:
                continue
            if merged is None:
                merged = tuple(s)
            elif len(s) == len(merged):
                merged = tuple(a if a != 0 else b for a, b in zip(merged, s))
        if merged is None:
            return None
        return ([merged] * len(in_shapes), [merged] * n_out, aux_shapes)

    return infer


def softrelu(x):
    """softplus in the form jax.nn.softplus computes (logaddexp(x, 0))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def softsign(x):
    return x / (1.0 + x.abs())


_UNARY = {
    "exp": torch.exp,
    "rsqrt": torch.rsqrt,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softsign": softsign,
}

_BINARY = {
    "elemwise_add": torch.add,
    "elemwise_sub": torch.sub,
    "elemwise_mul": torch.mul,
}

_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
}


def _register():
    for name, f in _UNARY.items():
        register_op(name, lambda attrs, x, _f=f: _f(x), num_inputs=1,
                    infer_shape=_elemwise_infer(1))
    for name, f in _BINARY.items():
        register_op(name, lambda attrs, a, b, _f=f: _f(a, b), num_inputs=2,
                    infer_shape=_elemwise_infer(2))
    alias_op("elemwise_add", "_plus")
    alias_op("elemwise_sub", "_minus")
    alias_op("elemwise_sub", "_sub")
    alias_op("elemwise_mul", "_mul")
    for name, f in _SCALAR.items():
        register_op(name, lambda attrs, x, _f=f: _f(x, attrs.scalar),
                    params={"scalar": Float()}, num_inputs=1,
                    infer_shape=_elemwise_infer(1))


_register()

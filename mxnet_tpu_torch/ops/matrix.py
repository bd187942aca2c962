"""Shape-manipulation ops and products: Reshape, Flatten, transpose, Cast,
dot, batch_dot.

Counterpart of ``mxnet_tpu/ops/matrix.py``, limited to the ops the ported
slices emit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from .param import Bool, DType, Shape
from .registry import alias_op, register_op


def _apply_reshape_codes(cur, shape, reverse=False):
    """MXNet Reshape's special codes 0, -1, -2, -3, -4."""
    if reverse:
        cur = tuple(reversed(cur))
        shape = tuple(reversed(shape))
    out = []
    i = 0   # index into cur
    si = 0  # index into shape
    while si < len(shape):
        s = shape[si]
        if s == 0:
            out.append(cur[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(cur[i:])
            i = len(cur)
        elif s == -3:
            out.append(cur[i] * cur[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[si + 1], shape[si + 2]
            if a == -1:
                a = cur[i] // b
            if b == -1:
                b = cur[i] // a
            out.extend([a, b])
            i += 1
            si += 2
        else:
            out.append(int(s))
            i += 1
        si += 1
    if out.count(-1) > 1:
        raise MXNetError("more than one -1 in reshape")
    if reverse:
        out = list(reversed(out))
    return tuple(out)


def _reshape(attrs, x):
    return x.reshape(_apply_reshape_codes(tuple(x.shape), attrs.shape,
                                          attrs.reverse))


def _reshape_infer(attrs, in_shapes, aux_shapes):
    (s,) = in_shapes
    if s is None:
        return None
    tgt = list(_apply_reshape_codes(s, attrs.shape, attrs.reverse))
    if -1 in tgt:
        known = int(np.prod([d for d in tgt if d != -1])) or 1
        tgt[tgt.index(-1)] = int(np.prod(s)) // known
    return ([s], [tuple(tgt)], aux_shapes)


def _flatten(attrs, x):
    return x.reshape(x.shape[0], -1) if x.ndim > 1 else x.reshape(-1, 1)


def _flatten_infer(attrs, in_shapes, aux_shapes):
    s = in_shapes[0]
    if s is None:
        return None
    return ([s], [(s[0], int(np.prod(s[1:])) if len(s) > 1 else 1)],
            aux_shapes)


def _transpose(attrs, x):
    axes = attrs.axes or tuple(reversed(range(x.ndim)))
    return x.permute(*axes)


def _transpose_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    axes = attrs.axes or tuple(reversed(range(len(d))))
    return ([d], [tuple(d[a] for a in axes)], aux_shapes)


def _transpose_infer_backward(attrs, out_shapes, in_shapes):
    # inverse-permute the output shape back onto the input: the layout
    # pass's weight transpose resolves its variable's shape this way
    o = out_shapes[0] if out_shapes else None
    if o is None or not attrs.axes or len(attrs.axes) != len(o):
        return None
    inv = [0] * len(o)
    for i, a in enumerate(attrs.axes):
        inv[a] = o[i]
    return [tuple(inv)]


def _cast(attrs, x):
    return x.to(torch_dtype(attrs.dtype))


def _dot(attrs, a, b):
    if attrs.transpose_a:
        a = a.t() if a.dim() == 2 else torch.movedim(a, 0, -1)
    if attrs.transpose_b:
        b = b.t() if b.dim() == 2 else torch.movedim(b, -1, 0)
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    # numpy dot: contract a's last axis with b's first
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


def _dot_infer(attrs, in_shapes, aux_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return None
    ash = tuple(reversed(a)) if attrs.transpose_a else a
    bsh = tuple(reversed(b)) if attrs.transpose_b else b
    return ([a, b], [ash[:-1] + bsh[1:]], aux_shapes)


def _batch_dot(attrs, a, b):
    if attrs.transpose_a:
        a = a.transpose(-1, -2)
    if attrs.transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _register():
    register_op("dot", _dot,
                params={"transpose_a": Bool(default=False),
                        "transpose_b": Bool(default=False)},
                num_inputs=2, input_names=["lhs", "rhs"],
                infer_shape=_dot_infer,
                doc="Dot product (numpy semantics; 2-d is a matmul)")
    register_op("batch_dot", _batch_dot,
                params={"transpose_a": Bool(default=False),
                        "transpose_b": Bool(default=False)},
                num_inputs=2, input_names=["lhs", "rhs"],
                doc="Batched matrix product over the leading axis")
    register_op("Reshape", _reshape,
                params={"shape": Shape(default=()),
                        "reverse": Bool(default=False),
                        "target_shape": Shape(default=None),
                        "keep_highest": Bool(default=False)},
                num_inputs=1, infer_shape=_reshape_infer)
    alias_op("Reshape", "reshape")
    register_op("Flatten", _flatten, num_inputs=1,
                infer_shape=_flatten_infer)
    alias_op("Flatten", "flatten")
    register_op("transpose", _transpose, params={"axes": Shape(default=())},
                num_inputs=1, infer_shape=_transpose_infer,
                infer_backward=_transpose_infer_backward)
    register_op("Cast", _cast, params={"dtype": DType()}, num_inputs=1,
                infer_shape=lambda attrs, i, a: (
                    None if i[0] is None else ([i[0]], [i[0]], a)),
                infer_backward=lambda attrs, out_shapes, in_shapes: (
                    [out_shapes[0]] if out_shapes
                    and out_shapes[0] is not None else None),
                infer_dtype=lambda attrs, i, a: (i, [attrs.dtype], a))
    alias_op("Cast", "cast")


_register()

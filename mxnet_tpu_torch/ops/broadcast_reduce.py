"""Broadcasting binary ops, axis reductions and broadcast shapes.

Counterpart of ``mxnet_tpu/ops/broadcast_reduce.py``: every
``broadcast_*`` binary (comparisons return the left input's dtype), the
reductions with ``axis`` / ``keepdims`` / ``exclude`` (``axis=None`` or
``()`` reduces every axis; ``exclude`` reduces the axes not named, so
``exclude=True`` with ``axis=()`` reduces none), ``norm``, ``argmax`` /
``argmin`` / ``argmax_channel`` (float32 indices, MXNet's quirk) and
``broadcast_to`` / ``broadcast_axis`` / ``broadcast_like``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .param import Bool, Int, Shape
from .registry import alias_op, register_op


def _bcast_infer(attrs, in_shapes, aux_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return None
    if len(a) == len(b) and (0 in a or 0 in b):
        # partial dims (0 = unknown): a known non-1 dim is authoritative,
        # and unknown input dims backfill from the merged shape
        out = []
        for x, y in zip(a, b):
            if x == 0:
                out.append(y)
            elif y == 0 or x == y:
                out.append(x)
            elif x == 1 or y == 1:
                out.append(max(x, y))
            else:
                raise ValueError("incompatible broadcast dims %s vs %s"
                                 % (a, b))
        out = tuple(out)
        new_a = tuple(o if x == 0 else x for x, o in zip(a, out))
        new_b = tuple(o if y == 0 else y for y, o in zip(b, out))
        return ([new_a, new_b], [out], aux_shapes)
    return ([a, b], [tuple(np.broadcast_shapes(a, b))], aux_shapes)


def _cmp(f):
    return lambda a, b: f(a, b).to(a.dtype)


_BROADCAST = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
    "broadcast_equal": _cmp(torch.eq),
    "broadcast_not_equal": _cmp(torch.ne),
    "broadcast_greater": _cmp(torch.gt),
    "broadcast_greater_equal": _cmp(torch.ge),
    "broadcast_lesser": _cmp(torch.lt),
    "broadcast_lesser_equal": _cmp(torch.le),
}


def norm_axes(axis, ndim, exclude=False):
    """The reduced axes, as the JAX package resolves them."""
    if axis is None or axis == ():
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _reduce_infer(attrs, in_shapes, aux_shapes):
    (s,) = in_shapes
    if s is None:
        return None
    axes = norm_axes(attrs.axis, len(s), attrs.exclude)
    if attrs.keepdims:
        out = tuple(1 if i in axes else d for i, d in enumerate(s))
    else:
        out = tuple(d for i, d in enumerate(s) if i not in axes)
    return ([s], [out], aux_shapes)


def _float(x):
    return x if x.is_floating_point() else x.float()


def _prod(x, axes, keepdims):
    # torch.prod reduces one axis at a time; the highest first keeps the
    # remaining indices valid
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


_REDUCERS = {
    "sum": lambda x, axes, kd: torch.sum(x, dim=axes, keepdim=kd),
    "mean": lambda x, axes, kd: torch.mean(_float(x), dim=axes, keepdim=kd),
    "prod": _prod,
    "nansum": lambda x, axes, kd: torch.nansum(x, dim=axes, keepdim=kd),
    "nanprod": lambda x, axes, kd: _prod(_nan_to(x, 1.0), axes, kd),
    "max": lambda x, axes, kd: torch.amax(x, dim=axes, keepdim=kd),
    "min": lambda x, axes, kd: torch.amin(x, dim=axes, keepdim=kd),
}

_REDUCE_PARAMS = {"axis": Shape(default=None),
                  "keepdims": Bool(default=False),
                  "exclude": Bool(default=False)}


def _nan_to(x, value):
    return torch.where(torch.isnan(x), torch.full_like(x, value), x)


# what a reduction over no axis gives (torch reads an empty dim list as
# "every axis")
_NO_AXIS = {"mean": _float, "nansum": lambda x: _nan_to(x, 0.0),
            "nanprod": lambda x: _nan_to(x, 1.0)}


def _reduction(f, name):
    def fn(attrs, x):
        axes = norm_axes(attrs.axis, x.ndim, attrs.exclude)
        if not axes:
            return _NO_AXIS.get(name, torch.clone)(x)
        return f(x, axes, attrs.keepdims)
    return fn


def _norm(attrs, x):
    if attrs.ord not in (1, 2):
        raise MXNetError("norm only supports ord=1 or ord=2, got %r"
                         % (attrs.ord,))
    mag = x.abs() if attrs.ord == 1 else torch.square(x)
    if attrs.axis is None:
        red = torch.sum(mag)
        if attrs.keepdims:
            red = red.reshape((1,) * x.ndim)
    elif attrs.axis == ():
        red = mag
    else:
        red = torch.sum(mag, dim=tuple(attrs.axis), keepdim=attrs.keepdims)
    if attrs.ord == 2:
        red = torch.sqrt(red)
    if attrs.axis is None and not attrs.keepdims:
        red = red.reshape((1,))   # the reference's full reduce is (1,)
    return red


def _arg_infer(attrs, in_shapes, aux_shapes):
    (s,) = in_shapes
    if s is None:
        return None
    if attrs.axis is None:
        out = (1,) if not attrs.keepdims else tuple(1 for _ in s)
    else:
        ax = attrs.axis % len(s)
        if attrs.keepdims:
            out = tuple(1 if i == ax else d for i, d in enumerate(s))
        else:
            out = tuple(d for i, d in enumerate(s) if i != ax)
    return ([s], [out], aux_shapes)


def _arg_reduction(f):
    def fn(attrs, x):
        if attrs.axis is None:
            out = f(x.reshape(-1)).float()
            return out.reshape((1,) * x.ndim if attrs.keepdims else (1,))
        return f(x, dim=attrs.axis, keepdim=attrs.keepdims).float()
    return fn


def _broadcast_to(attrs, x):
    # 0 in the target shape keeps the input's dim
    return x.expand(tuple(d if t == 0 else t for d, t in
                          zip(x.shape, attrs.shape))).contiguous()


def _broadcast_axis(attrs, x):
    tgt = list(x.shape)
    for ax, sz in zip(attrs.axis, attrs.size):
        tgt[ax] = sz
    return x.expand(tuple(tgt)).contiguous()


def _register():
    for name, f in _BROADCAST.items():
        register_op(name, lambda attrs, a, b, _f=f: _f(a, b), num_inputs=2,
                    input_names=["lhs", "rhs"], infer_shape=_bcast_infer)
    alias_op("broadcast_add", "broadcast_plus")
    alias_op("broadcast_sub", "broadcast_minus")

    for name, f in _REDUCERS.items():
        register_op(name, _reduction(f, name), params=dict(_REDUCE_PARAMS),
                    num_inputs=1, infer_shape=_reduce_infer)
    alias_op("sum", "sum_axis")
    alias_op("max", "max_axis")
    alias_op("min", "min_axis")
    register_op("norm", _norm, num_inputs=1,
                params={"ord": Int(default=2), "axis": Shape(default=None),
                        "keepdims": Bool(default=False)},
                doc="L1/L2 norm over all elements or the given axes")

    for name, f in (("argmax", torch.argmax), ("argmin", torch.argmin)):
        register_op(name, _arg_reduction(f),
                    params={"axis": Int(default=None),
                            "keepdims": Bool(default=False)},
                    num_inputs=1, infer_shape=_arg_infer,
                    infer_dtype=lambda attrs, i, a: (i, ["float32"], a))
    register_op("argmax_channel",
                lambda attrs, x: torch.argmax(x, dim=-1).float(),
                num_inputs=1,
                infer_shape=lambda attrs, i, a: (
                    ([i[0]], [i[0][:-1]], a) if i[0] else None),
                infer_dtype=lambda attrs, i, a: (i, ["float32"], a))

    register_op("broadcast_to", _broadcast_to, params={"shape": Shape()},
                num_inputs=1,
                infer_shape=lambda attrs, i, a: (
                    None if i[0] is None else
                    ([i[0]], [tuple(d if t == 0 else t
                                    for d, t in zip(i[0], attrs.shape))],
                     a)))
    # rhs gives only its shape (its gradient is zero)
    register_op("broadcast_like",
                lambda attrs, lhs, rhs: lhs.expand(rhs.shape).contiguous(),
                num_inputs=2, input_names=["lhs", "rhs"],
                infer_shape=lambda attrs, i, a: (
                    None if i[1] is None else (i, [i[1]], a)))
    register_op("broadcast_axis", _broadcast_axis,
                params={"axis": Shape(default=()),
                        "size": Shape(default=())},
                num_inputs=1)
    alias_op("broadcast_axis", "broadcast_axes")


_register()

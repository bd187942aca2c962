"""Shape-manipulation, slicing, joining and ordering ops, and the products
``dot`` / ``batch_dot``.

Counterpart of ``mxnet_tpu/ops/matrix.py`` (with the slice assignments of
``mxnet_tpu/ops/legacy_ops.py``): Reshape, Flatten, expand_dims,
transpose, SwapAxis, Cast, slice / crop, slice_axis, reverse, repeat,
tile, clip, Concat, SliceChannel, stack, where, reshape_like, sort,
argsort, topk and ``_slice_assign`` / ``_slice_assign_scalar``. Index
outputs (argsort, topk) are float32, as MXNet's are.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from .intmath import integer_contraction, is_integer
from .param import Bool, DType, Enum, Float, Int, Shape
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
    if is_integer(a, b):
        return integer_contraction(lambda x, y: _dot(attrs, x, y), a, b)
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
    if is_integer(a, b):
        return integer_contraction(torch.matmul,
                                   *_batch_operands(attrs, a, b))
    return torch.matmul(*_batch_operands(attrs, a, b))


def _batch_operands(attrs, a, b):
    if attrs.transpose_a:
        a = a.transpose(-1, -2)
    if attrs.transpose_b:
        b = b.transpose(-1, -2)
    return a, b


# --- slicing ---------------------------------------------------------------

def _slice_bounds(shape, begin, end, step=None):
    """One ``slice`` per dim from MXNet's begin / end / step (None =
    the whole dim)."""
    idx = []
    step = step or ()
    for i, d in enumerate(shape):
        b = begin[i] if i < len(begin) and begin[i] is not None else 0
        e = end[i] if i < len(end) and end[i] is not None else d
        s = step[i] if i < len(step) and step[i] is not None else 1
        idx.append(slice(b, e, s))
    return tuple(idx)


def _index_lists(shape, slices, device):
    """Per-dim index tensors of ``slices`` (torch slicing takes no
    negative step)."""
    return [torch.arange(*sl.indices(d), device=device)
            for sl, d in zip(slices, shape)]


def _take_slices(x, slices):
    if all((sl.step or 1) > 0 for sl in slices):
        return x[slices]
    for ax, idx in enumerate(_index_lists(x.shape, slices, x.device)):
        x = x.index_select(ax, idx)
    return x


def _slice(attrs, x):
    return _take_slices(x, _slice_bounds(x.shape, attrs.begin, attrs.end,
                                         attrs.step))


def _slice_infer(attrs, in_shapes, aux_shapes):
    (s,) = in_shapes
    if s is None:
        return None
    out = tuple(len(range(*sl.indices(d))) for sl, d in zip(
        _slice_bounds(s, attrs.begin, attrs.end, attrs.step), s))
    return ([s], [out], aux_shapes)


def _slice_axis(attrs, x):
    ax = attrs.axis % x.ndim
    end = attrs.end if attrs.end is not None else x.shape[ax]
    idx = [slice(None)] * x.ndim
    idx[ax] = slice(attrs.begin, end)
    return x[tuple(idx)]


def _assign(lhs, attrs, value):
    out = lhs.clone()
    slices = _slice_bounds(lhs.shape, attrs.begin, attrs.end, attrs.step)
    if all((sl.step or 1) > 0 for sl in slices):
        out[slices] = value
    else:
        grids = torch.meshgrid(*_index_lists(lhs.shape, slices, lhs.device),
                               indexing="ij")
        out[grids] = value
    return out


# --- joining and splitting ------------------------------------------------

def _concat_infer(attrs, in_shapes, aux_shapes):
    if any(s is None for s in in_shapes):
        return None
    out = list(in_shapes[0])
    out[attrs.dim] = sum(s[attrs.dim] for s in in_shapes)
    return (list(in_shapes), [tuple(out)], aux_shapes)


def _slice_channel(attrs, x):
    ax = attrs.axis % x.ndim
    parts = torch.chunk(x, attrs.num_outputs, dim=ax)
    if attrs.squeeze_axis:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


def _slice_channel_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    ax = attrs.axis % len(d)
    piece = d[ax] // attrs.num_outputs if d[ax] else 0
    out = d[:ax] + d[ax + 1:] if attrs.squeeze_axis \
        else d[:ax] + (piece,) + d[ax + 1:]
    return ([d], [tuple(out)] * attrs.num_outputs, aux_shapes)


def _where(attrs, cond, a, b):
    # cond is either x's shape or 1-D over x's first axis (whole rows);
    # nothing else, no trailing-axis broadcast
    if tuple(cond.shape) != tuple(a.shape):
        if not (cond.dim() == 1 and a.dim() >= 1
                and cond.shape[0] == a.shape[0]):
            raise ValueError(
                "where: condition shape %s must equal x shape %s or be 1-D "
                "of length x.shape[0]" % (tuple(cond.shape),
                                          tuple(a.shape)))
        cond = cond.reshape((-1,) + (1,) * (a.dim() - 1))
    return torch.where(cond != 0, a, b)


# --- ordering -------------------------------------------------------------

def _sort(attrs, x):
    ax = -1 if attrs.axis is None else attrs.axis
    y = torch.sort(x, dim=ax, stable=True).values
    return y if attrs.is_ascend else torch.flip(y, dims=(ax,))


def _argsort(attrs, x):
    ax = -1 if attrs.axis is None else attrs.axis
    y = torch.argsort(x, dim=ax, stable=True)
    if not attrs.is_ascend:
        y = torch.flip(y, dims=(ax,))
    return y.float()


def _topk(attrs, x):
    ax = -1 if attrs.axis is None else attrs.axis % x.ndim
    if attrs.ret_typ == "mask":
        raise MXNetError("topk ret_typ=mask not supported yet")
    vals, idx = torch.topk(x, attrs.k, dim=ax, largest=not attrs.is_ascend,
                           sorted=True)
    idx = idx.float()
    if attrs.ret_typ == "value":
        return vals
    if attrs.ret_typ == "indices":
        return idx
    return (vals, idx)


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
    register_op("expand_dims", lambda attrs, x: x.unsqueeze(attrs.axis),
                params={"axis": Int()}, num_inputs=1)
    register_op("SwapAxis",
                lambda attrs, x: x.transpose(attrs.dim1, attrs.dim2),
                params={"dim1": Int(default=0), "dim2": Int(default=0)},
                num_inputs=1)
    alias_op("SwapAxis", "swapaxes")

    register_op("slice", _slice,
                params={"begin": Shape(), "end": Shape(),
                        "step": Shape(default=None)},
                num_inputs=1, infer_shape=_slice_infer)
    alias_op("slice", "crop")
    register_op("slice_axis", _slice_axis,
                params={"axis": Int(), "begin": Int(default=0),
                        "end": Int(default=None)},
                num_inputs=1)
    register_op("reverse",
                lambda attrs, x: torch.flip(x, dims=tuple(attrs.axis)),
                params={"axis": Shape()}, num_inputs=1,
                infer_shape=_same_shape)
    alias_op("reverse", "flip")
    register_op("repeat",
                lambda attrs, x: torch.repeat_interleave(x, attrs.repeats,
                                                         dim=attrs.axis),
                params={"repeats": Int(), "axis": Int(default=None)},
                num_inputs=1)
    register_op("tile", lambda attrs, x: torch.tile(x, tuple(attrs.reps)),
                params={"reps": Shape()}, num_inputs=1)
    register_op("clip",
                lambda attrs, x: torch.clamp(x, attrs.a_min, attrs.a_max),
                params={"a_min": Float(), "a_max": Float()}, num_inputs=1,
                infer_shape=_same_shape)

    register_op("Concat", lambda attrs, *xs: torch.cat(xs, dim=attrs.dim),
                params={"num_args": Int(default=1), "dim": Int(default=1)},
                num_inputs=lambda attrs: attrs.num_args,
                input_names=lambda attrs: ["arg%d" % i
                                           for i in range(attrs.num_args)],
                infer_shape=_concat_infer)
    alias_op("Concat", "concat")
    register_op("SliceChannel", _slice_channel,
                params={"num_outputs": Int(), "axis": Int(default=1),
                        "squeeze_axis": Bool(default=False)},
                num_inputs=1, num_outputs=lambda attrs: attrs.num_outputs,
                infer_shape=_slice_channel_infer)
    alias_op("SliceChannel", "split")
    register_op("stack", lambda attrs, *xs: torch.stack(xs, dim=attrs.axis),
                params={"num_args": Int(default=1), "axis": Int(default=0)},
                num_inputs=lambda attrs: attrs.num_args,
                input_names=lambda attrs: ["arg%d" % i
                                           for i in range(attrs.num_args)])
    register_op("where", _where, num_inputs=3,
                input_names=["condition", "x", "y"])
    register_op("reshape_like", lambda attrs, a, b: a.reshape(b.shape),
                num_inputs=2, input_names=["lhs", "rhs"])

    order = {"axis": Int(default=-1), "is_ascend": Bool(default=True)}
    register_op("sort", _sort, params=dict(order), num_inputs=1)
    register_op("argsort", _argsort, params=dict(order), num_inputs=1,
                infer_dtype=lambda attrs, i, a: (i, ["float32"], a))
    register_op("topk", _topk,
                params={"axis": Int(default=-1), "k": Int(default=1),
                        "ret_typ": Enum(["value", "indices", "mask", "both"],
                                        default="indices"),
                        "is_ascend": Bool(default=False)},
                num_inputs=1,
                num_outputs=lambda attrs: 2 if attrs.ret_typ == "both" else 1)

    slice_params = {"begin": Shape(), "end": Shape(),
                    "step": Shape(default=None)}
    register_op("_slice_assign",
                lambda attrs, lhs, rhs: _assign(lhs, attrs, rhs),
                params=dict(slice_params), num_inputs=2,
                input_names=["lhs", "rhs"],
                infer_shape=lambda attrs, ins, auxs:
                    None if ins[0] is None else (ins, [ins[0]], auxs))
    alias_op("_slice_assign", "_crop_assign")
    register_op("_slice_assign_scalar",
                lambda attrs, lhs: _assign(lhs, attrs, attrs.scalar),
                params=dict(slice_params, scalar=Float(default=0.0)),
                num_inputs=1, infer_shape=_same_shape)
    alias_op("_slice_assign_scalar", "_crop_assign_scalar")


def _same_shape(attrs, i, a):
    return None if i[0] is None else ([i[0]], [i[0]], a)


_register()

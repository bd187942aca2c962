"""Indexing ops: take, Embedding, one_hot, pick, batch_take, gather_nd,
scatter_nd.

Counterpart of ``mxnet_tpu/ops/indexing.py``. MXNet passes indices as
floats; each op casts them to integers explicitly and clips (or wraps)
them as the JAX package does, so an index past the end reads the last
row instead of faulting. Gradients are torch's (scatter-adds of the
gathers).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .param import Bool, DType, Enum, Float, Int, Shape
from .registry import alias_op, register_op


def _long(indices):
    return indices.to(torch.int64)


def _take(attrs, a, indices):
    ax = attrs.axis % a.dim()
    idx = _long(indices)
    n = a.shape[ax]
    if attrs.mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif attrs.mode == "wrap":
        idx = torch.remainder(idx, n)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


def _take_infer(attrs, in_shapes, aux_shapes):
    a, idx = in_shapes
    if a is None or idx is None:
        return None
    ax = attrs.axis % len(a)
    return ([a, idx], [a[:ax] + tuple(idx) + a[ax + 1:]], aux_shapes)


def _embedding(attrs, data, weight):
    return F.embedding(_long(data).clamp(0, attrs.input_dim - 1), weight)


def _embedding_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    return ([d, (attrs.input_dim, attrs.output_dim)],
            [tuple(d) + (attrs.output_dim,)], aux_shapes)


def _one_hot(attrs, indices):
    # an index outside [0, depth) gives a row of off_value
    hot = (_long(indices).unsqueeze(-1) == torch.arange(
        attrs.depth, device=indices.device)).to(torch.float32)
    return hot * (attrs.on_value - attrs.off_value) + attrs.off_value


def _pick_axis(attrs, ndim):
    return (attrs.axis if attrs.axis is not None else ndim - 1) % ndim


def _pick(attrs, data, index):
    ax = _pick_axis(attrs, data.dim())
    idx = _long(index).clamp(0, data.shape[ax] - 1)
    if idx.dim() < data.dim():
        idx = idx.unsqueeze(ax)
    out = torch.gather(data, ax, idx)
    return out if attrs.keepdims else out.squeeze(ax)


def _pick_infer(attrs, in_shapes, aux_shapes):
    d, idx = in_shapes
    if d is None:
        return None
    ax = _pick_axis(attrs, len(d))
    if attrs.keepdims:
        out = tuple(1 if i == ax else x for i, x in enumerate(d))
    else:
        out = tuple(x for i, x in enumerate(d) if i != ax)
    return ([d, out if idx is None else idx], [out], aux_shapes)


def _batch_take(attrs, a, indices):
    # N-d data is read as (prod(shape[:-1]), shape[-1]) rows, one element
    # taken from each
    last = a.shape[-1]
    rows = a.reshape(-1, last)
    idx = _long(indices).reshape(-1).clamp(0, last - 1)
    return torch.gather(rows, 1, idx[:, None])[:, 0].reshape(a.shape[:-1])


def _batch_take_infer(attrs, in_shapes, aux_shapes):
    a, i = in_shapes
    if a is None:
        return None
    out = a[:-1]
    return ([a, out if i is None else i], [out], aux_shapes)


def _nd_index(indices):
    """indices (M, Y...) -> a tuple of M integer index tensors."""
    return tuple(_long(indices[i]) for i in range(indices.shape[0]))


def _gather_nd_infer(attrs, in_shapes, aux_shapes):
    d, i = in_shapes
    if d is None or i is None:
        return None
    return ([d, i], [tuple(i[1:]) + tuple(d[i[0]:])], aux_shapes)


def _scatter_nd(attrs, data, indices):
    out = torch.zeros(tuple(attrs.shape), dtype=data.dtype,
                      device=data.device)
    # duplicate indices keep one of their values, as in the reference
    return out.index_put(_nd_index(indices), data)


def _register():
    register_op("take", _take,
                params={"axis": Int(default=0),
                        "mode": Enum(["clip", "wrap", "raise"],
                                     default="clip")},
                num_inputs=2, input_names=["a", "indices"],
                infer_shape=_take_infer)
    register_op("Embedding", _embedding,
                params={"input_dim": Int(), "output_dim": Int(),
                        "dtype": DType(default="float32")},
                num_inputs=2, input_names=["data", "weight"],
                infer_shape=_embedding_infer,
                doc="Embedding lookup; indices clipped to [0, input_dim)")
    register_op("one_hot", _one_hot,
                params={"depth": Int(), "on_value": Float(default=1.0),
                        "off_value": Float(default=0.0),
                        "dtype": DType(default="float32")},
                num_inputs=1, input_names=["indices"],
                infer_shape=lambda attrs, i, a: (
                    None if i[0] is None else
                    ([i[0]], [tuple(i[0]) + (attrs.depth,)], a)))
    register_op("pick", _pick,
                params={"axis": Int(default=-1),
                        "keepdims": Bool(default=False)},
                num_inputs=2, input_names=["data", "index"],
                infer_shape=_pick_infer)
    alias_op("pick", "choose_element_0index")
    register_op("batch_take", _batch_take, num_inputs=2,
                input_names=["a", "indices"], infer_shape=_batch_take_infer)
    register_op("gather_nd",
                lambda attrs, data, indices: data[_nd_index(indices)],
                num_inputs=2, input_names=["data", "indices"],
                infer_shape=_gather_nd_infer)
    register_op("scatter_nd", _scatter_nd, params={"shape": Shape()},
                num_inputs=2, input_names=["data", "indices"],
                infer_shape=lambda attrs, i, a: (i, [tuple(attrs.shape)],
                                                 a))
    register_op("_scatter_set_nd",
                lambda attrs, lhs, rhs, indices: lhs.index_put(
                    _nd_index(indices), rhs),
                params={"shape": Shape()}, num_inputs=3,
                input_names=["lhs", "rhs", "indices"],
                infer_shape=lambda attrs, i, a: (i, [tuple(attrs.shape)],
                                                 a))


_register()

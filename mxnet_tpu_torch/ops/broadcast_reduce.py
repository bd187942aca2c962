"""Broadcasting binary ops.

Counterpart of ``mxnet_tpu/ops/broadcast_reduce.py``, limited to
``broadcast_add`` (the ResNet and attention residuals), ``broadcast_mul``
(the ``bn_fold`` weight scale) and ``broadcast_sub`` / ``broadcast_div``
(Symbol and NDArray arithmetic).
"""
from __future__ import annotations

import numpy as np
import torch

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


def _register():
    for name, f in (("broadcast_add", torch.add),
                    ("broadcast_sub", torch.sub),
                    ("broadcast_mul", torch.mul),
                    ("broadcast_div", torch.div)):
        register_op(name, lambda attrs, a, b, _f=f: _f(a, b), num_inputs=2,
                    input_names=["lhs", "rhs"], infer_shape=_bcast_infer)
    alias_op("broadcast_add", "broadcast_plus")
    alias_op("broadcast_sub", "broadcast_minus")


_register()

"""The exact route of the integer contractions.

The JAX package computes ``Convolution``, ``FullyConnected``, ``dot`` and
``batch_dot`` on int32 operands with XLA's integer lowering: exact
accumulation, int32 results (wrapping on overflow). cuDNN and cuBLAS take
no int32 convolution or matmul, and torch's CPU convolution takes no
integer tensor, so here an integer contraction runs in float64 on the
same library calls and is rounded back: every product and every partial
sum of integers below 2**53 in magnitude is a float64 integer, so the sum
is exact whatever the summation order. The int8 islands of the
``quantize`` pass stay far inside that: operands on +-127 make a product
at most 16129, and ResNet-50's widest reduction (3 x 3 x 512 = 4608
terms) sums to below 2**27. The round before the cast only guards a
library algorithm that is not a plain sum of products.
"""
from __future__ import annotations

import torch

__all__ = ["is_integer", "integer_contraction"]


def is_integer(*tensors):
    """True when any of ``tensors`` holds an integer (or bool) dtype."""
    return any(not (t.is_floating_point() or t.is_complex())
               for t in tensors if t is not None)


def integer_contraction(fn, *operands):
    """``fn`` over ``operands`` (None passes through) in float64, rounded
    and cast back to the operands' promoted integer dtype, wrapping modulo
    2**32 past int32 as XLA's integer arithmetic does."""
    live = [t for t in operands if t is not None]
    dtype = live[0].dtype
    for t in live[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    out = fn(*(None if t is None else t.to(torch.float64)
               for t in operands))
    return torch.round(out).to(torch.int64).to(dtype)

"""Legacy and internal graph ops: ``Crop``, ``IdentityAttachKLSparseReg``,
the ``_scatter_*`` nodes, ``_grad_add``, ``_identity_with_attr_like_rhs``,
and the ``*_v1`` and ``_linalg_*`` names as aliases.

Counterpart of ``mxnet_tpu/ops/legacy_ops.py`` (reference: crop.cc,
identity_attach_KL_sparse_reg-inl.h, elemwise_scatter_op.cc). The sparse
storage ops of that file (``cast_storage``, ``_sparse_retain``,
``_square_sum``), ``_contrib_SparseEmbedding`` and ``_CrossDeviceCopy``
are not ported: they come with the sparse types and model-parallel binds
(ROADMAP.md Queue A13). ``_slice_assign`` lives in ``matrix.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .param import Bool, Float, Int, Shape
from .registry import alias_op, register_op


# --- Crop (legacy layer, crop.cc) -------------------------------------------

def _crop(attrs, *inputs):
    """``data[:, :, oy:oy+h, ox:ox+w]`` with (h, w) from ``h_w`` or from
    ``crop_like``'s spatial size, at ``offset`` or centred. ``crop_like``
    gets no gradient."""
    data = inputs[0]
    h, w = data.shape[2], data.shape[3]
    if attrs.num_args == 2:
        ch, cw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        ch, cw = attrs.h_w
    if attrs.center_crop:
        oy, ox = (h - ch) // 2, (w - cw) // 2
    else:
        oy, ox = attrs.offset
    if oy + ch > h or ox + cw > w:
        raise MXNetError("crop offset+size exceeds input (%d+%d > %d or "
                         "%d+%d > %d)" % (oy, ch, h, ox, cw, w))
    return data[:, :, oy:oy + ch, ox:ox + cw]


def _crop_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    if attrs.num_args == 2:
        like = in_shapes[1]
        if like is None:
            return None
        ch, cw = like[2], like[3]
    else:
        ch, cw = attrs.h_w
    return (in_shapes, [(d[0], d[1], ch, cw)], aux_shapes)


# --- IdentityAttachKLSparseReg ------------------------------------------------

class _KLSparseRegFn(torch.autograd.Function):
    """Identity forward on the (N, rest) view; the backward adds the KL
    penalty ``penalty * (-rho / avg + (1 - rho) / (1 - avg))`` of the
    moving average ``avg`` to every sample's gradient, and gives ``avg``
    none: the JAX package's ``jax.custom_vjp``."""

    @staticmethod
    def forward(ctx, rho, penalty, flat, avg):
        ctx.rho, ctx.penalty = rho, penalty
        ctx.save_for_backward(avg)
        return flat.clone()

    @staticmethod
    def backward(ctx, g):
        (avg,) = ctx.saved_tensors
        pen = ctx.penalty * (-ctx.rho / avg + (1 - ctx.rho) / (1 - avg))
        return None, None, g + pen[None, :], None


def _kl_sparse_reg(attrs, data, aux=(), is_train=False):
    """Identity; in training the moving average of the mean activation is
    updated first (``momentum``), and the backward's penalty reads the
    updated average, which the executor writes back as an aux state."""
    (moving_avg,) = aux
    flat = data.reshape(data.shape[0], -1)
    if is_train:
        with torch.no_grad():
            new_avg = attrs.momentum * moving_avg + \
                (1 - attrs.momentum) * flat.mean(dim=0)
    else:
        new_avg = moving_avg
    if torch.is_grad_enabled() and data.requires_grad:
        flat = _KLSparseRegFn.apply(attrs.sparseness_target, attrs.penalty,
                                    flat, new_avg.detach())
    return (flat.reshape(data.shape),), (new_avg,)


def _kl_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    rest = int(np.prod(d[1:])) if len(d) > 1 else 1
    return ([d], [d], [(rest,)])


def _lhs_shape(attrs, ins, auxs):
    return None if ins[0] is None else (ins, [ins[0]], auxs)


def _register():
    register_op(
        "Crop", _crop,
        params={"num_args": Int(default=1), "offset": Shape(default=(0, 0)),
                "h_w": Shape(default=(0, 0)),
                "center_crop": Bool(default=False)},
        num_inputs=lambda attrs: attrs.num_args,
        input_names=lambda attrs: (["data", "crop_like"]
                                   if attrs.num_args == 2 else ["data"]),
        infer_shape=_crop_infer,
        doc="crop 4-D data to h_w or to crop_like's spatial size")
    register_op(
        "IdentityAttachKLSparseReg", _kl_sparse_reg,
        params={"sparseness_target": Float(default=0.1),
                "penalty": Float(default=0.001),
                "momentum": Float(default=0.9)},
        num_inputs=1, input_names=["data"], aux_names=["moving_avg"],
        needs_is_train=True, infer_shape=_kl_infer,
        doc="identity forward; the backward adds the KL sparseness penalty")
    register_op("_grad_add", lambda attrs, lhs, rhs: lhs + rhs,
                num_inputs=2, input_names=["lhs", "rhs"],
                doc="the gradient pass's aggregation add")
    register_op("_identity_with_attr_like_rhs",
                lambda attrs, lhs, rhs: lhs,
                num_inputs=2, input_names=["lhs", "rhs"],
                infer_shape=_lhs_shape,
                doc="lhs, carrying rhs's storage attributes (dense here)")
    for name, fn in (("_scatter_plus_scalar",
                      lambda attrs, x: x + attrs.scalar),
                     ("_scatter_minus_scalar",
                      lambda attrs, x: x - attrs.scalar)):
        register_op(name, fn, params={"scalar": Float(default=0.0)},
                    num_inputs=1, input_names=["data"],
                    doc="the scalar op keeping sparse storage (dense here)")
    register_op("_scatter_elemwise_div", lambda attrs, lhs, rhs: lhs / rhs,
                num_inputs=2, input_names=["lhs", "rhs"],
                doc="elemwise div keeping lhs's sparse storage (dense here)")
    # the pre-NNVM layer names and the la_op registrations' own names
    alias_op("Convolution", "Convolution_v1")
    alias_op("Pooling", "Pooling_v1")
    alias_op("BatchNorm", "BatchNorm_v1")
    for la in ("gemm", "gemm2", "potrf", "potri", "trmm", "trsm",
               "sumlogdiag", "syrk", "gelqf", "syevd"):
        alias_op("linalg_" + la, "_linalg_" + la)


_register()

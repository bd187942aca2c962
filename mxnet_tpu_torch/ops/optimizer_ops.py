"""Fused optimizer update ops: sgd_update, sgd_mom_update and their
multi-precision forms.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference:
src/operator/optimizer_op-inl.h). Each op is a function of its inputs, as
in the JAX package: it returns the new weight and the new optimizer state.
The imperative layer (``mx.nd.sgd_update(..., out=weight)``) then writes
both into the given arrays in place (ndarray/register.py), where the JAX
package rebinds each array to a new buffer. The other optimizers' ops wait
for the Gluon slice.
"""
from __future__ import annotations

import torch

from .param import Float
from .registry import register_op

_COMMON = {
    "lr": Float(),
    "wd": Float(default=0.0),
    "rescale_grad": Float(default=1.0),
    "clip_gradient": Float(default=-1.0),
}


def _prep_grad(attrs, grad):
    g = grad * attrs.rescale_grad
    if attrs.clip_gradient is not None and attrs.clip_gradient > 0:
        g = torch.clamp(g, -attrs.clip_gradient, attrs.clip_gradient)
    return g


def _sgd_update(attrs, weight, grad):
    g = _prep_grad(attrs, grad)
    return weight - attrs.lr * (g + attrs.wd * weight)


def _sgd_mom_update(attrs, weight, grad, aux=()):
    (mom,) = aux
    g = _prep_grad(attrs, grad)
    new_mom = attrs.momentum * mom - attrs.lr * (g + attrs.wd * weight)
    return (weight + new_mom,), (new_mom,)


def _mp_sgd_update(attrs, weight, grad, aux=()):
    (weight32,) = aux
    g = _prep_grad(attrs, grad).to(weight32.dtype)
    new_w32 = weight32 - attrs.lr * (g + attrs.wd * weight32)
    return (new_w32.to(weight.dtype),), (new_w32,)


def _mp_sgd_mom_update(attrs, weight, grad, aux=()):
    mom, weight32 = aux
    g = _prep_grad(attrs, grad).to(weight32.dtype)
    new_mom = attrs.momentum * mom - attrs.lr * (g + attrs.wd * weight32)
    new_w32 = weight32 + new_mom
    return (new_w32.to(weight.dtype),), (new_mom, new_w32)


def _register():
    register_op("sgd_update", _sgd_update, params=dict(_COMMON),
                num_inputs=2, input_names=["weight", "grad"],
                doc="w -= lr*(rescale*clip(grad) + wd*w)")
    register_op("sgd_mom_update", _sgd_mom_update,
                params=dict(_COMMON, momentum=Float(default=0.0)),
                num_inputs=2, input_names=["weight", "grad"],
                aux_names=["mom"], doc="momentum SGD")
    register_op("mp_sgd_update", _mp_sgd_update, params=dict(_COMMON),
                num_inputs=2, input_names=["weight", "grad"],
                aux_names=["weight32"],
                doc="multi-precision SGD: low-precision weight, fp32 master")
    register_op("mp_sgd_mom_update", _mp_sgd_mom_update,
                params=dict(_COMMON, momentum=Float(default=0.0)),
                num_inputs=2, input_names=["weight", "grad"],
                aux_names=["mom", "weight32"],
                doc="multi-precision momentum SGD")


_register()

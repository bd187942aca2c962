"""Fused optimizer update ops: sgd_update, sgd_mom_update, their
multi-precision forms, adam_update, rmsprop_update, rmspropalex_update and
ftrl_update.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference:
src/operator/optimizer_op-inl.h). Each op is a function of its inputs, as
in the JAX package: it returns the new weight and the new optimizer state.
The imperative layer (``mx.nd.sgd_update(..., out=weight)``) then writes
both into the given arrays in place (ndarray/register.py), where the JAX
package rebinds each array to a new buffer.

``lr`` is a Python float, or a 0-dim fp32 tensor when a training step reads
it from the device (``parallel.ShardedTrainer``, so that a schedule needs
no recapture). The JAX package's step passes it as a strongly typed fp32
scalar, which promotes a bf16 operand to fp32; a 0-dim torch tensor would
not (torch keeps the dimensioned operand's dtype within a category), so
every product or quotient with ``lr`` goes through :func:`_lr_mul` /
:func:`_lr_div`, which promote as JAX does.
"""
from __future__ import annotations

import torch

from .param import Bool, Float
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


def _promoted(lr, x):
    """``x`` in the dtype JAX gives ``lr`` op ``x``: a tensor ``lr`` is a
    strong scalar, so it promotes ``x`` (bf16 with fp32 is fp32)."""
    if isinstance(lr, torch.Tensor):
        return x.to(torch.promote_types(lr.dtype, x.dtype))
    return x


def _lr_mul(lr, x):
    return lr * _promoted(lr, x)


def _lr_div(x, lr):
    return _promoted(lr, x) / lr


def _sgd_update(attrs, weight, grad):
    g = _prep_grad(attrs, grad)
    return weight - _lr_mul(attrs.lr, g + attrs.wd * weight)


def _sgd_mom_update(attrs, weight, grad, aux=()):
    (mom,) = aux
    g = _prep_grad(attrs, grad)
    new_mom = attrs.momentum * mom - _lr_mul(attrs.lr, g + attrs.wd * weight)
    return (weight + new_mom,), (new_mom,)


def _mp_sgd_update(attrs, weight, grad, aux=()):
    (weight32,) = aux
    g = _prep_grad(attrs, grad).to(weight32.dtype)
    new_w32 = weight32 - _lr_mul(attrs.lr, g + attrs.wd * weight32)
    return (new_w32.to(weight.dtype),), (new_w32,)


def _mp_sgd_mom_update(attrs, weight, grad, aux=()):
    mom, weight32 = aux
    g = _prep_grad(attrs, grad).to(weight32.dtype)
    new_mom = attrs.momentum * mom - _lr_mul(attrs.lr,
                                             g + attrs.wd * weight32)
    new_w32 = weight32 + new_mom
    return (new_w32.to(weight.dtype),), (new_mom, new_w32)


def _adam_update(attrs, weight, grad, aux=()):
    mean, var = aux
    g = _prep_grad(attrs, grad) + attrs.wd * weight
    new_mean = attrs.beta1 * mean + (1 - attrs.beta1) * g
    new_var = attrs.beta2 * var + (1 - attrs.beta2) * torch.square(g)
    new_w = weight - _lr_mul(attrs.lr, new_mean) / (torch.sqrt(new_var)
                                                    + attrs.epsilon)
    return (new_w,), (new_mean, new_var)


def _rmsprop_update(attrs, weight, grad, aux=()):
    (n,) = aux
    g = _prep_grad(attrs, grad) + attrs.wd * weight
    new_n = (1 - attrs.gamma1) * torch.square(g) + attrs.gamma1 * n
    new_w = weight - _lr_mul(attrs.lr, g) / torch.sqrt(new_n + attrs.epsilon)
    return (new_w,), (new_n,)


def _rmspropalex_update(attrs, weight, grad, aux=()):
    n, g_state, delta = aux
    g = _prep_grad(attrs, grad) + attrs.wd * weight
    new_n = (1 - attrs.gamma1) * torch.square(g) + attrs.gamma1 * n
    new_g = (1 - attrs.gamma1) * g + attrs.gamma1 * g_state
    new_delta = attrs.gamma2 * delta - _lr_mul(attrs.lr, g) / torch.sqrt(
        new_n - torch.square(new_g) + attrs.epsilon)
    return (weight + new_delta,), (new_n, new_g, new_delta)


def _ftrl_update(attrs, weight, grad, aux=()):
    z, n = aux
    g = _prep_grad(attrs, grad)
    new_n = n + torch.square(g)
    sigma = _lr_div(torch.sqrt(new_n) - torch.sqrt(n), attrs.lr)
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) > attrs.lamda1,
        -(new_z - torch.sign(new_z) * attrs.lamda1)
        / (_lr_div(attrs.beta + torch.sqrt(new_n), attrs.lr) + attrs.wd),
        0.0)
    return (new_w,), (new_z, new_n)


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
    register_op("adam_update", _adam_update,
                params=dict(_COMMON, beta1=Float(default=0.9),
                            beta2=Float(default=0.999),
                            epsilon=Float(default=1e-8),
                            lazy_update=Bool(default=False)),
                num_inputs=2, input_names=["weight", "grad"],
                aux_names=["mean", "var"],
                doc="Adam step; the Optimizer applies bias correction "
                    "through lr, as in the reference")
    register_op("rmsprop_update", _rmsprop_update,
                params=dict(_COMMON, gamma1=Float(default=0.95),
                            epsilon=Float(default=1e-8),
                            clip_weights=Float(default=-1.0)),
                num_inputs=2, input_names=["weight", "grad"],
                aux_names=["n"], doc="RMSProp (Tieleman and Hinton)")
    register_op("rmspropalex_update", _rmspropalex_update,
                params=dict(_COMMON, gamma1=Float(default=0.95),
                            gamma2=Float(default=0.9),
                            epsilon=Float(default=1e-8),
                            clip_weights=Float(default=-1.0)),
                num_inputs=2, input_names=["weight", "grad"],
                aux_names=["n", "g", "delta"], doc="RMSProp (Graves)")
    register_op("ftrl_update", _ftrl_update,
                params=dict(_COMMON, lamda1=Float(default=0.01),
                            beta=Float(default=1.0)),
                num_inputs=2, input_names=["weight", "grad"],
                aux_names=["z", "n"], doc="FTRL-proximal")


_register()

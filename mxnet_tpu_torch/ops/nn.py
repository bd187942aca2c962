"""Neural-network layer ops: the ResNet op set.

Counterpart of ``mxnet_tpu/ops/nn.py`` for FullyConnected, Convolution,
Pooling, Activation, softmax, BatchNorm (training and inference) and
SoftmaxOutput (a loss head whose backward injects MXNet's gradient).
Layouts follow the JAX package: a channels-last Convolution
(``layout="NHWC"``) takes spatial-major HWIO weights, a channels-first one
OIHW. The channels-last forms run as ``torch.nn.functional`` calls on a
channels_last *view* of the same memory (a permute, no copy).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .elemwise import softrelu, softsign
from .param import Bool, Enum, Float, Int, Shape, Str
from .registry import alias_op, register_op


def _is_channels_last(attrs):
    return bool(attrs.layout) and attrs.layout.endswith("C")


def _to_channels_first(x, nd):
    """(N, *spatial, C) -> (N, C, *spatial) as a view."""
    return x.permute(0, nd + 1, *range(1, nd + 1))


def _to_channels_last(x, nd):
    """(N, C, *spatial) -> (N, *spatial, C) as a view."""
    return x.permute(0, *range(2, nd + 2), 1)


# --- FullyConnected ---------------------------------------------------------

def _fully_connected(attrs, data, weight, *rest):
    x = data.reshape(data.shape[0], -1) if attrs.flatten else data
    return F.linear(x, weight, None if attrs.no_bias else rest[0])


def _fc_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    in_dim = int(np.prod(d[1:])) if attrs.flatten else d[-1]
    shapes = [d, (attrs.num_hidden, in_dim)] + \
        ([] if attrs.no_bias else [(attrs.num_hidden,)])
    out = (d[0], attrs.num_hidden) if attrs.flatten \
        else d[:-1] + (attrs.num_hidden,)
    return (shapes, [out], aux_shapes)


def _fc_infer_backward(attrs, out_shapes, in_shapes):
    # the batch dim flows back from the output
    o = out_shapes[0] if out_shapes else None
    d = in_shapes[0]
    if o is None or not o or o[0] == 0 or d is None or not d:
        return None
    if attrs.flatten:
        return [(o[0],) + tuple(d[1:])] + list(in_shapes[1:])
    return [tuple(o[:-1]) + (d[-1],)] + list(in_shapes[1:])


# --- Convolution ------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _convolution(attrs, data, weight, *rest):
    # The JAX package rewrites a stride-2 channels-last stem with few input
    # channels into a space-to-depth convolution (_s2d_conv) so the TPU's
    # 128 lanes are not wasted on 3 channels. That is a rewrite of the same
    # convolution for the TPU's layout; it is not ported, and the
    # convolution runs directly.
    nd = len(attrs.kernel)
    stride = attrs.stride or (1,) * nd
    dilate = attrs.dilate or (1,) * nd
    pad = attrs.pad or (0,) * nd
    bias = None if attrs.no_bias else rest[0]
    if _is_channels_last(attrs):
        x = _to_channels_first(data, nd)
        w = weight.permute(nd + 1, nd, *range(nd))   # (*k, I, O) -> OI*k
        out = _CONV[nd](x, w, bias, stride, pad, dilate, attrs.num_group)
        return _to_channels_last(out, nd)
    return _CONV[nd](data, weight, bias, stride, pad, dilate,
                     attrs.num_group)


def _conv_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    nd = len(attrs.kernel)
    stride = attrs.stride or (1,) * nd
    dilate = attrs.dilate or (1,) * nd
    pad = attrs.pad or (0,) * nd
    channels_last = _is_channels_last(attrs)
    c = d[-1] if channels_last else d[1]
    if channels_last:
        w = tuple(attrs.kernel) + (c // attrs.num_group, attrs.num_filter)
        sp_in = d[1:-1]
    else:
        w = (attrs.num_filter, c // attrs.num_group) + tuple(attrs.kernel)
        sp_in = d[2:]
    spatial = tuple(
        (sp_in[i] + 2 * pad[i] - dilate[i] * (attrs.kernel[i] - 1) - 1)
        // stride[i] + 1 for i in range(nd))
    out = ((d[0],) + spatial + (attrs.num_filter,)) if channels_last \
        else ((d[0], attrs.num_filter) + spatial)
    shapes = [d, w] + ([] if attrs.no_bias else [(attrs.num_filter,)])
    return (shapes, [out], aux_shapes)


def _conv_infer_backward(attrs, out_shapes, in_shapes):
    o = out_shapes[0] if out_shapes else None
    d = in_shapes[0]
    if o is None or not o or o[0] == 0 or d is None or not d:
        return None
    return [(o[0],) + tuple(d[1:])] + list(in_shapes[1:])


# --- Pooling ----------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_pads(in_sizes, kernel, stride, pad, convention):
    """(low, high) pads per spatial dim; the ``full`` convention pads the
    high side so a last partial window exists (ceil rounding)."""
    pads = []
    for n, k, s, p in zip(in_sizes, kernel, stride, pad):
        if convention == "full":
            out = int(np.ceil((n + 2 * p - k) / s)) + 1
            pads.append((p, p + max(0, (out - 1) * s + k - n - 2 * p)))
        else:
            pads.append((p, p))
    return pads


def _pooling(attrs, data):
    nd = len(attrs.kernel) if attrs.kernel else data.ndim - 2
    channels_last = _is_channels_last(attrs)
    x = _to_channels_first(data, nd) if channels_last else data
    sp_in = tuple(x.shape[2:])
    if attrs.global_pool:
        kernel, stride, pad = sp_in, (1,) * nd, (0,) * nd
    else:
        kernel = tuple(attrs.kernel)
        stride = attrs.stride or (1,) * nd
        pad = attrs.pad or (0,) * nd
    pads = _pool_pads(sp_in, kernel, stride, pad, attrs.pooling_convention)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if attrs.pool_type == "max":
        # padding never wins a max: pad with -inf
        if any(flat):
            x = F.pad(x, flat, value=float("-inf"))
        out = _MAX_POOL[nd](x, kernel, stride)
    elif attrs.pool_type in ("avg", "sum"):
        # zero padding, and avg divides by the full kernel size
        # (padding included), as the JAX package does
        if any(flat):
            x = F.pad(x, flat, value=0.0)
        out = _AVG_POOL[nd](x, kernel, stride)
        if attrs.pool_type == "sum":
            out = out * float(np.prod(kernel))
    else:
        raise MXNetError("unknown pool_type %r" % attrs.pool_type)
    return _to_channels_last(out, nd) if channels_last else out


def _pool_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    channels_last = _is_channels_last(attrs)
    if attrs.global_pool:
        if channels_last:
            return ([d], [(d[0],) + (1,) * (len(d) - 2) + (d[-1],)],
                    aux_shapes)
        return ([d], [d[:2] + (1,) * (len(d) - 2)], aux_shapes)
    nd = len(attrs.kernel)
    stride = attrs.stride or (1,) * nd
    pad = attrs.pad or (0,) * nd
    sp_in = d[1:-1] if channels_last else d[2:]
    spatial = []
    for i in range(nd):
        n, k, s, p = sp_in[i], attrs.kernel[i], stride[i], pad[i]
        if attrs.pooling_convention == "full":
            spatial.append(int(np.ceil((n + 2 * p - k) / s)) + 1)
        else:
            spatial.append((n + 2 * p - k) // s + 1)
    out = ((d[0],) + tuple(spatial) + (d[-1],)) if channels_last \
        else (d[:2] + tuple(spatial))
    return ([d], [out], aux_shapes)


# --- activations and softmax ------------------------------------------------

ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
               "tanh": torch.tanh, "softrelu": softrelu,
               "softsign": softsign}


def _activation(attrs, x):
    return ACTIVATIONS[attrs.act_type](x)


def _softmax(attrs, x):
    z = x / attrs.temperature if attrs.temperature != 1.0 else x
    return torch.softmax(z, dim=attrs.axis)


def _same_shape(attrs, i, a):
    return None if i[0] is None else ([i[0]], [i[0]], a)


# --- BatchNorm --------------------------------------------------------------

class _BatchNormTrainFn(torch.autograd.Function):
    """Training-mode BatchNorm over the batch statistics: forward
    ``(out, mean, var)`` with fp32 statistics for any activation dtype,
    backward the closed form ``dx = g.ivar.(go - (dbeta + xhat.dgamma)/n)``
    with the mean and var cotangents dropped (the reference's BNBackward
    differentiates through the output only) and ``dgamma`` zero under
    ``fix_gamma``: the JAX package's ``jax.custom_vjp``
    (``mxnet_tpu/ops/nn.py`` ``_bn_train_core``). Not
    ``F.batch_norm(training=True)``: torch updates its running variance
    with the unbiased variance and takes the complement of MXNet's
    momentum."""

    @staticmethod
    def forward(ctx, ax, eps, fix_gamma, x, gamma, beta):
        red = tuple(i for i in range(x.dim()) if i != ax)
        bshape = tuple(-1 if i == ax else 1 for i in range(x.dim()))
        n = x.numel() // x.shape[ax]
        x32 = x.float()
        # biased statistics from one sum and one sum of squares
        mean = x32.sum(dim=red) / n
        var = torch.clamp((x32 * x32).sum(dim=red) / n - mean * mean,
                          min=0.0)
        ivar = torch.rsqrt(var + eps)
        g32 = torch.ones_like(gamma, dtype=torch.float32) if fix_gamma \
            else gamma.float()
        out = (x32 - mean.reshape(bshape)) * ivar.reshape(bshape) \
            * g32.reshape(bshape) + beta.float().reshape(bshape)
        ctx.save_for_backward(x, g32, mean, ivar)
        ctx.bn = (red, bshape, n, fix_gamma, gamma.dtype)
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, go, _dmean, _dvar):
        x, g32, mean, ivar = ctx.saved_tensors
        red, bshape, n, fix_gamma, gdtype = ctx.bn
        go = go.float()
        xhat = (x.float() - mean.reshape(bshape)) * ivar.reshape(bshape)
        dbeta = go.sum(dim=red)
        dgamma = (go * xhat).sum(dim=red)
        dx = (g32.reshape(bshape) * ivar.reshape(bshape)
              * (go - (dbeta.reshape(bshape)
                       + xhat * dgamma.reshape(bshape)) / n)).to(x.dtype)
        if fix_gamma:
            dgamma = torch.zeros_like(dgamma)
        return None, None, None, dx, dgamma.to(gdtype), dbeta.to(gdtype)


def _batch_norm(attrs, data, gamma, beta, aux=(), is_train=False):
    """BatchNorm with fp32 statistics and the output cast back to the
    activation dtype. Training (``is_train`` without ``use_global_stats``)
    normalises over the batch statistics and returns the moving stats
    updated as ``m * moving + (1 - m) * batch``, in the moving stats' own
    dtype; otherwise the moving statistics normalise and stay as they
    are. Batch statistics returned by ``output_mean_var`` stay fp32."""
    moving_mean, moving_var = aux
    ax = attrs.axis if attrs.axis >= 0 else data.ndim + attrs.axis
    bshape = tuple(-1 if i == ax else 1 for i in range(data.ndim))
    if is_train and not attrs.use_global_stats:
        out, mean, var = _BatchNormTrainFn.apply(
            ax, attrs.eps, bool(attrs.fix_gamma), data, gamma, beta)
        m = attrs.momentum
        new_aux = ((m * moving_mean + (1 - m) * mean.detach())
                   .to(moving_mean.dtype),
                   (m * moving_var + (1 - m) * var.detach())
                   .to(moving_var.dtype))
    else:
        mean, var = moving_mean, moving_var
        new_aux = (moving_mean, moving_var)
        g = torch.ones_like(gamma) if attrs.fix_gamma else gamma
        out = (data.float() - mean.reshape(bshape)) * torch.rsqrt(
            var.reshape(bshape) + attrs.eps)
        out = out * g.float().reshape(bshape) + beta.float().reshape(bshape)
        out = out.to(data.dtype)
    if attrs.output_mean_var:
        return (out, mean, var), new_aux
    return (out,), new_aux


def _bn_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    c = (d[attrs.axis],)
    outs = [d] + ([c, c] if attrs.output_mean_var else [])
    return ([d, c, c], outs, [c, c])


# --- SoftmaxOutput ----------------------------------------------------------

def _so_axis(attrs, data):
    if attrs.preserve_shape:
        return data.ndim - 1
    return 1 if data.ndim > 1 else 0


class _SoftmaxOutputFn(torch.autograd.Function):
    """Softmax forward; the backward ignores the head gradient (unless
    ``out_grad``) and injects ``(p - onehot) * grad_scale``, normalized by
    ``normalization`` — the JAX package's ``jax.custom_vjp``
    (``mxnet_tpu/ops/nn.py`` ``_softmax_output_fn``). The label gets a zero
    gradient."""

    @staticmethod
    def forward(ctx, attrs, data, label):
        out = torch.softmax(data, dim=_so_axis(attrs, data))
        ctx.attrs = attrs
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    def backward(ctx, g):
        attrs = ctx.attrs
        out, label = ctx.saved_tensors
        ax = _so_axis(attrs, out)
        if tuple(label.shape) == tuple(out.shape):
            onehot = label.to(out.dtype)
            valid = torch.ones(label.shape[:1], dtype=out.dtype,
                               device=out.device)
            scale = 1.0
        else:
            lab = label.to(torch.int64)
            onehot = torch.movedim(
                F.one_hot(lab.clamp(0, out.shape[ax] - 1),
                          out.shape[ax]).to(out.dtype), -1, ax)
            # one_hot of an out-of-range label (an ignore label) is 0 in
            # the JAX package; clamp + mask reproduces that
            in_range = ((lab >= 0) & (lab < out.shape[ax])).to(out.dtype)
            onehot = onehot * in_range.unsqueeze(ax)
            valid = torch.ones(lab.shape, dtype=out.dtype, device=out.device)
            scale = 1.0
            if attrs.use_ignore:
                keep = (lab != int(attrs.ignore_label)).to(out.dtype)
                valid = keep
                onehot = onehot * keep.unsqueeze(ax)
                scale = onehot.sum(dim=ax, keepdim=True)
        grad = (out * scale - onehot) * attrs.grad_scale
        if attrs.normalization == "batch":
            grad = grad / out.shape[0]
        elif attrs.normalization == "valid":
            grad = grad / torch.clamp(valid.sum(), min=1.0)
        if attrs.out_grad:
            grad = grad * g
        return None, grad.to(out.dtype), torch.zeros_like(label)


def _softmax_output(attrs, data, label):
    """Softmax over the class axis; under autograd, the loss head whose
    backward is MXNet's (``_SoftmaxOutputFn``)."""
    if torch.is_grad_enabled() and data.requires_grad:
        return _SoftmaxOutputFn.apply(attrs, data, label)
    return torch.softmax(data, dim=_so_axis(attrs, data))


def _so_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    lab = d[:1] + d[2:] if attrs.preserve_shape or attrs.multi_output \
        else d[:1]
    return ([d, in_shapes[1] or lab], [d], aux_shapes)


def _register():
    register_op(
        "FullyConnected", _fully_connected,
        params={"num_hidden": Int(), "no_bias": Bool(default=False),
                "flatten": Bool(default=True)},
        num_inputs=lambda attrs: 2 if attrs.no_bias else 3,
        input_names=lambda attrs: ["data", "weight"]
        + ([] if attrs.no_bias else ["bias"]),
        infer_shape=_fc_infer, infer_backward=_fc_infer_backward,
        doc="y = x.W^T + b, weight layout (num_hidden, in_dim)")
    register_op(
        "Convolution", _convolution,
        params={"kernel": Shape(), "stride": Shape(default=()),
                "dilate": Shape(default=()), "pad": Shape(default=()),
                "num_filter": Int(), "num_group": Int(default=1),
                "workspace": Int(default=1024),
                "no_bias": Bool(default=False),
                "cudnn_tune": Str(default=None),
                "cudnn_off": Bool(default=False),
                "layout": Str(default=None)},
        num_inputs=lambda attrs: 2 if attrs.no_bias else 3,
        input_names=lambda attrs: ["data", "weight"]
        + ([] if attrs.no_bias else ["bias"]),
        infer_shape=_conv_infer, infer_backward=_conv_infer_backward,
        doc="N-d convolution; channels-last layouts take HWIO weights")
    register_op(
        "Pooling", _pooling,
        params={"kernel": Shape(default=()),
                "pool_type": Enum(["max", "avg", "sum"], default="max"),
                "global_pool": Bool(default=False),
                "pooling_convention": Enum(["valid", "full"],
                                           default="valid"),
                "stride": Shape(default=()), "pad": Shape(default=()),
                "layout": Str(default=None),
                "cudnn_off": Bool(default=False)},
        num_inputs=1, infer_shape=_pool_infer,
        doc="Max/avg/sum pooling; avg divides by the kernel size incl. "
            "padding")
    register_op("Activation", _activation,
                params={"act_type": Enum(list(ACTIVATIONS))},
                num_inputs=1, infer_shape=_same_shape)
    register_op("softmax", _softmax,
                params={"axis": Int(default=-1),
                        "temperature": Float(default=1.0)},
                num_inputs=1, infer_shape=_same_shape)
    register_op(
        "BatchNorm", _batch_norm,
        params={"eps": Float(default=1e-3), "momentum": Float(default=0.9),
                "fix_gamma": Bool(default=True),
                "use_global_stats": Bool(default=False),
                "output_mean_var": Bool(default=False),
                "axis": Int(default=1), "cudnn_off": Bool(default=False)},
        num_inputs=3, input_names=["data", "gamma", "beta"],
        aux_names=["moving_mean", "moving_var"],
        num_outputs=lambda attrs: 3 if attrs.output_mean_var else 1,
        infer_shape=_bn_infer, needs_is_train=True,
        doc="Batch normalization with moving-stat aux states")
    register_op(
        "SoftmaxOutput", _softmax_output,
        params={"grad_scale": Float(default=1.0),
                "ignore_label": Float(default=-1.0),
                "multi_output": Bool(default=False),
                "use_ignore": Bool(default=False),
                "preserve_shape": Bool(default=False),
                "normalization": Enum(["null", "batch", "valid"],
                                      default="null"),
                "out_grad": Bool(default=False),
                "smooth_alpha": Float(default=0.0)},
        num_inputs=2, input_names=["data", "label"], infer_shape=_so_infer,
        doc="Softmax head with MXNet's injected loss gradient")
    alias_op("SoftmaxOutput", "Softmax")


_register()

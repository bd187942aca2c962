"""Neural-network layer ops.

Counterpart of ``mxnet_tpu/ops/nn.py`` for FullyConnected, Convolution,
Deconvolution, Pooling, Activation, LeakyReLU, softmax, log_softmax,
SoftmaxActivation, BatchNorm (training and inference), Dropout, Pad,
SoftmaxOutput (a loss head whose backward injects MXNet's gradient),
softmax_cross_entropy, the regression heads, L2Normalization, LRN,
InstanceNorm and the Sequence ops.
Layouts follow the JAX package: a channels-last Convolution
(``layout="NHWC"``) takes spatial-major HWIO weights, a channels-first one
OIHW. The channels-last forms run as ``torch.nn.functional`` calls on a
channels_last *view* of the same memory (a permute, no copy).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from .elemwise import softrelu, softsign
from .intmath import integer_contraction, is_integer
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
    bias = None if attrs.no_bias else rest[0]
    if is_integer(x, weight):
        return integer_contraction(F.linear, x, weight, bias)
    return F.linear(x, weight, bias)


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
    if is_integer(data, weight):
        return integer_contraction(
            lambda x, w, *b: _float_convolution(attrs, x, w, *b),
            data, weight, *rest)
    return _float_convolution(attrs, data, weight, *rest)


def _float_convolution(attrs, data, weight, *rest):
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
        # cuDNN picks its algorithms by the operand's memory format: a
        # channels-last operand that is a view of channels-first memory (a
        # transpose of NCHW data) would run this convolution, and the
        # graph after it, channels-first, in another summation order than
        # the channels-last GEMMs of the graph's fused regions
        x = _to_channels_first(data.contiguous(), nd)
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


# --- Deconvolution ----------------------------------------------------------

_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _deconv_geometry(attrs):
    nd = len(attrs.kernel)
    return (attrs.stride or (1,) * nd, attrs.pad or (0,) * nd,
            attrs.adj or (0,) * nd, attrs.dilate or (1,) * nd)


def _deconv_out_size(n, k, s, p, a, d):
    """MXNet's transposed-convolution size: s(n-1) + d(k-1) + 1 - 2p + a."""
    return s * (n - 1) + d * (k - 1) + 1 - 2 * p + a


def _deconvolution(attrs, data, weight, *rest):
    """Transposed convolution, channels first, weight (C, num_filter /
    num_group, *kernel); ``target_shape`` picks ``adj``."""
    stride, pad, adj, dilate = _deconv_geometry(attrs)
    if attrs.target_shape:
        adj = tuple(t - _deconv_out_size(data.shape[2 + i], attrs.kernel[i],
                                         stride[i], pad[i], 0, dilate[i])
                    for i, t in enumerate(attrs.target_shape))
    return _CONV_T[len(attrs.kernel)](
        data, weight, None if attrs.no_bias else rest[0], stride, pad, adj,
        attrs.num_group, dilate)


def _deconv_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    stride, pad, adj, dilate = _deconv_geometry(attrs)
    w = (d[1], attrs.num_filter // attrs.num_group) + tuple(attrs.kernel)
    spatial = tuple(attrs.target_shape) if attrs.target_shape else tuple(
        _deconv_out_size(d[2 + i], k, stride[i], pad[i], adj[i], dilate[i])
        for i, k in enumerate(attrs.kernel))
    shapes = [d, w] + ([] if attrs.no_bias else [(attrs.num_filter,)])
    return (shapes, [(d[0], attrs.num_filter) + spatial], aux_shapes)


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


def _log_softmax(attrs, x):
    z = x / attrs.temperature if attrs.temperature != 1.0 else x
    return torch.log_softmax(z, dim=attrs.axis)


def _same_shape(attrs, i, a):
    return None if i[0] is None else ([i[0]], [i[0]], a)


def _leaky_relu(attrs, x, *rest):
    t = attrs.act_type
    if t == "leaky":
        return torch.where(x > 0, x, attrs.slope * x)
    if t == "elu":
        return torch.where(x > 0, x, attrs.slope * torch.expm1(x))
    if t == "prelu":
        gamma = rest[0].reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x > 0, x, gamma * x)
    raise MXNetError("act_type %r not supported" % t)


def _lrelu_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    if attrs.act_type == "prelu":
        return ([d, (d[1],)], [d], aux_shapes)
    return ([d], [d], aux_shapes)


# --- Dropout and Pad ---------------------------------------------------------

def _dropout(attrs, x, is_train=False, rng=None):
    """Inverted dropout: in training (or under ``mode="always"``) each
    element is kept with probability 1 - p and scaled by 1 / (1 - p). The
    mask is size 1 on ``axes`` (whole slices dropped together). The bits
    come from ``rng``, else from ``mx.random``'s generator of the device
    (on a card its default generator: a captured step draws anew on each
    replay)."""
    if (not is_train and attrs.mode != "always") or attrs.p <= 0.0:
        return x
    keep = 1.0 - attrs.p
    axes = tuple(a % x.dim() for a in (attrs.axes or ()))
    mask_shape = tuple(1 if i in axes else s for i, s in enumerate(x.shape))
    gen = rng if rng is not None else _random.generator(x.device)
    mask = torch.rand(mask_shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _pad(attrs, x):
    pw = attrs.pad_width
    if attrs.mode == "constant":
        flat = [p for i in reversed(range(x.dim()))
                for p in (pw[2 * i], pw[2 * i + 1])]
        return F.pad(x, flat, value=attrs.constant_value)
    # edge / reflect pad the trailing spatial axes (N and C unpadded)
    nsp = x.dim() - 2
    flat = [p for i in reversed(range(2, x.dim()))
            for p in (pw[2 * i], pw[2 * i + 1])]
    mode = "replicate" if attrs.mode == "edge" else "reflect"
    if any(pw[:4]):
        raise MXNetError("Pad: %s mode pads only the spatial axes" %
                         attrs.mode)
    return F.pad(x, flat[:2 * nsp], mode=mode)


def _pad_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    pw = attrs.pad_width
    return ([d], [tuple(n + pw[2 * i] + pw[2 * i + 1]
                        for i, n in enumerate(d))], aux_shapes)


def _softmax_cross_entropy(attrs, data, label):
    logp = torch.log_softmax(data, dim=-1)
    nll = -torch.gather(logp, -1, label.to(torch.int64)[:, None])
    return nll.sum().reshape((1,))


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


# --- regression heads -------------------------------------------------------

class _HeadFn(torch.autograd.Function):
    """A loss head whose backward ignores the head gradient: ``grad_of(pred,
    label)`` for the data and a zero gradient for the label, as the JAX
    package's ``jax.custom_vjp`` heads do."""

    @staticmethod
    def forward(ctx, forward, grad_of, data, label):
        out = forward(data)
        if out is data:
            out = data.clone()
        ctx.grad_of = grad_of
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    def backward(ctx, g):
        pred, label = ctx.saved_tensors
        return (None, None, ctx.grad_of(pred, label).to(pred.dtype),
                torch.zeros_like(label))


def loss_head(forward, grad_of):
    """The op function of a head: ``forward(attrs, data)`` and, under
    autograd, the backward ``grad_of(attrs, pred, label)`` (:class:`_HeadFn`).
    """
    def fn(attrs, data, label):
        if torch.is_grad_enabled() and data.requires_grad:
            return _HeadFn.apply(lambda x: forward(attrs, x),
                                 lambda p, y: grad_of(attrs, p, y),
                                 data, label)
        return forward(attrs, data)
    return fn


def _regression(kind):
    """Identity (or sigmoid) forward; the backward gives ``(pred - label)``
    (``sign(...)`` for MAE) times ``grad_scale / prod(shape[1:])``
    (``mxnet_tpu/ops/nn.py:791-813``)."""
    def forward(attrs, data):
        return torch.sigmoid(data) if kind == "logistic" else data

    def grad_of(attrs, pred, label):
        diff = pred - label.reshape(pred.shape)
        grad = torch.sign(diff) if kind == "mae" else diff
        num_out = float(np.prod(pred.shape[1:])) or 1.0
        return grad * (attrs.grad_scale / num_out)
    return loss_head(forward, grad_of)


# --- normalization extras ---------------------------------------------------

def _l2_normalization(attrs, x):
    if attrs.mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif attrs.mode == "channel":
        axes = (1,)
    else:  # spatial
        axes = tuple(range(2, x.dim()))
    return x / torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True)
                          + attrs.eps)


def _lrn(attrs, x):
    """Cross-channel LRN: the squares summed over a zero-padded window of
    ``nsize`` channels, alpha divided by ``nsize``."""
    pad = attrs.nsize // 2
    sq = F.pad(x * x, (0, 0) * (x.dim() - 2) + (pad, pad))
    window = sum(sq[:, i:i + x.shape[1]] for i in range(attrs.nsize))
    return x / torch.pow(attrs.knorm + attrs.alpha * window / attrs.nsize,
                         attrs.beta)


def _instance_norm(attrs, x, gamma, beta):
    """Per-sample, per-channel normalization with the biased variance."""
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) / torch.sqrt(var + attrs.eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


# --- sequence ops (time-major; ``axis`` is accepted and ignored, as in the
# JAX package) ---------------------------------------------------------------

def _seq_inputs(attrs):
    return ["data", "sequence_length"] if attrs.use_sequence_length \
        else ["data"]


def _seq_infer(out_of):
    def infer(attrs, i, a):
        if i[0] is None:
            return None
        ins = [i[0]] + ([(i[0][1],)] if attrs.use_sequence_length else [])
        return (ins, [out_of(i[0])], a)
    return infer


def _sequence_mask(attrs, data, *rest):
    """``data * mask + value * (1 - mask)``: a ``value`` of -inf gives NaN
    at the kept steps too, as in the JAX package."""
    T = data.shape[0]
    if attrs.use_sequence_length and rest:
        t = torch.arange(T, device=data.device)[:, None]
        mask = (t < rest[0].to(torch.int32)[None, :]).to(data.dtype)
    else:
        mask = torch.ones((T, data.shape[1]), dtype=data.dtype,
                          device=data.device)
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return data * mask + attrs.value * (1 - mask)


def _sequence_last(attrs, data, *rest):
    if attrs.use_sequence_length and rest:
        idx = rest[0].to(torch.int64) - 1
        idx = torch.where(idx < 0, idx + data.shape[0], idx)
        idx = idx.reshape((1, -1) + (1,) * (data.dim() - 2)).expand(
            (1,) + tuple(data.shape[1:]))
        return torch.gather(data, 0, idx)[0]
    return data[-1]


def _sequence_reverse(attrs, data, *rest):
    if attrs.use_sequence_length and rest:
        T = data.shape[0]
        seq = rest[0].to(torch.int64)[None, :]
        t = torch.arange(T, device=data.device)[:, None]
        rev = torch.where(t < seq, seq - 1 - t, t)
        rev = rev.reshape(rev.shape + (1,) * (data.dim() - 2)).expand(
            data.shape)
        return torch.gather(data, 0, rev)
    return torch.flip(data, dims=(0,))


def _register_extras():
    for name, kind in (("LinearRegressionOutput", "linear"),
                       ("LogisticRegressionOutput", "logistic"),
                       ("MAERegressionOutput", "mae")):
        register_op(name, _regression(kind),
                    params={"grad_scale": Float(default=1.0)},
                    num_inputs=2, input_names=["data", "label"],
                    infer_shape=lambda attrs, i, a: (
                        None if i[0] is None
                        else ([i[0], i[1] or i[0]], [i[0]], a)))
    register_op("L2Normalization", _l2_normalization,
                params={"eps": Float(default=1e-10),
                        "mode": Enum(["instance", "spatial", "channel"],
                                     default="instance")},
                num_inputs=1, infer_shape=_same_shape)
    register_op("LRN", _lrn,
                params={"alpha": Float(default=1e-4),
                        "beta": Float(default=0.75),
                        "knorm": Float(default=2.0), "nsize": Int()},
                num_inputs=1, infer_shape=_same_shape)
    register_op("InstanceNorm", _instance_norm,
                params={"eps": Float(default=1e-3)},
                num_inputs=3, input_names=["data", "gamma", "beta"],
                infer_shape=lambda attrs, i, a: (
                    None if i[0] is None else
                    ([i[0], (i[0][1],), (i[0][1],)], [i[0]], a)))
    seq_n = lambda attrs: 2 if attrs.use_sequence_length else 1  # noqa
    register_op("SequenceMask", _sequence_mask,
                params={"use_sequence_length": Bool(default=False),
                        "value": Float(default=0.0), "axis": Int(default=0)},
                num_inputs=seq_n, input_names=_seq_inputs,
                infer_shape=_seq_infer(lambda d: d))
    register_op("SequenceLast", _sequence_last,
                params={"use_sequence_length": Bool(default=False),
                        "axis": Int(default=0)},
                num_inputs=seq_n, input_names=_seq_inputs,
                infer_shape=_seq_infer(lambda d: d[1:]))
    register_op("SequenceReverse", _sequence_reverse,
                params={"use_sequence_length": Bool(default=False),
                        "axis": Int(default=0)},
                num_inputs=seq_n, input_names=_seq_inputs,
                infer_shape=_seq_infer(lambda d: d))


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
        "Deconvolution", _deconvolution,
        params={"kernel": Shape(), "stride": Shape(default=()),
                "dilate": Shape(default=()), "pad": Shape(default=()),
                "adj": Shape(default=()), "target_shape": Shape(default=()),
                "num_filter": Int(), "num_group": Int(default=1),
                "workspace": Int(default=512),
                "no_bias": Bool(default=True),
                "cudnn_tune": Str(default=None),
                "cudnn_off": Bool(default=False),
                "layout": Str(default=None)},
        num_inputs=lambda attrs: 2 if attrs.no_bias else 3,
        input_names=lambda attrs: ["data", "weight"]
        + ([] if attrs.no_bias else ["bias"]),
        infer_shape=_deconv_infer,
        doc="Transposed convolution (channels first)")
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
    register_op("log_softmax", _log_softmax,
                params={"axis": Int(default=-1),
                        "temperature": Float(default=1.0)},
                num_inputs=1, infer_shape=_same_shape)
    register_op("SoftmaxActivation",
                lambda attrs, x: torch.softmax(
                    x, dim=1 if attrs.mode == "channel" else -1),
                params={"mode": Enum(["instance", "channel"],
                                     default="instance")},
                num_inputs=1, infer_shape=_same_shape)
    register_op("LeakyReLU", _leaky_relu,
                params={"act_type": Enum(["rrelu", "leaky", "prelu", "elu"],
                                         default="leaky"),
                        "slope": Float(default=0.25),
                        "lower_bound": Float(default=0.125),
                        "upper_bound": Float(default=0.334)},
                num_inputs=lambda attrs: 2 if attrs.act_type == "prelu"
                else 1,
                input_names=lambda attrs: (["data", "gamma"]
                                           if attrs.act_type == "prelu"
                                           else ["data"]),
                infer_shape=_lrelu_infer,
                doc="Leaky / PReLU / ELU")
    register_op("Dropout", _dropout,
                params={"p": Float(default=0.5), "axes": Shape(default=()),
                        "mode": Enum(["training", "always"],
                                     default="training")},
                num_inputs=1, needs_is_train=True, needs_rng=True,
                infer_shape=_same_shape,
                doc="Inverted dropout from mx.random's generators")
    register_op("Pad", _pad,
                params={"mode": Enum(["constant", "edge", "reflect"],
                                     default="constant"),
                        "pad_width": Shape(),
                        "constant_value": Float(default=0.0)},
                num_inputs=1, infer_shape=_pad_infer)
    alias_op("Pad", "pad")
    register_op("softmax_cross_entropy", _softmax_cross_entropy,
                num_inputs=2, input_names=["data", "label"],
                infer_shape=lambda attrs, i, a: (
                    None if i[0] is None else ([i[0], (i[0][0],)], [(1,)],
                                               a)))
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
_register_extras()

"""Spatial warp ops: GridGenerator, BilinearSampler, SpatialTransformer,
UpSampling, SVMOutput.

Counterpart of ``mxnet_tpu/ops/spatial.py``. Sampling is a gather plus an
elementwise lerp over the whole batch; every op is NCHW like the
reference. Bilinear UpSampling is the grouped transposed convolution the
reference builds (``conv_transpose2d``); SVMOutput is an identity forward
whose backward injects the hinge-loss gradient, a
``torch.autograd.Function`` as the JAX package's ``custom_vjp``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .param import Bool, Enum, Float, Int, Shape
from .registry import register_op

_F32 = torch.float32


def _affine_grid(theta, h, w):
    """theta (n, 6) -> normalized sampling grid (n, 2, h, w), rows
    [x_src; y_src] in [-1, 1] (reference: grid_generator-inl.h:92-108)."""
    dev = theta.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    xn = -1.0 + xs.to(_F32) * (2.0 / max(w - 1, 1))
    yn = -1.0 + ys.to(_F32) * (2.0 / max(h - 1, 1))
    base = torch.stack([xn.reshape(-1), yn.reshape(-1),
                        torch.ones_like(xn).reshape(-1)], dim=0)  # (3, hw)
    out = torch.matmul(theta.reshape(-1, 2, 3).to(_F32), base)
    return out.reshape(-1, 2, h, w)


def _bilinear_sample(data, grid):
    """Sample NCHW ``data`` at the normalized ``grid`` (n, 2, h', w'), zero
    outside [-1, 1] (reference: bilinear_sampler-inl.h)."""
    n, _c, h, w = data.shape
    gx = (grid[:, 0].to(_F32) + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1].to(_F32) + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    bi = torch.arange(n, device=data.device)[:, None, None]

    def fetch(yi, xi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = xi.clamp(0, w - 1).to(torch.long)
        yc = yi.clamp(0, h - 1).to(torch.long)
        v = data[bi, :, yc, xc]                      # (n, h', w', c)
        return torch.where(valid[..., None], v, 0.0)

    out = (fetch(y0, x0) * (1 - wx) * (1 - wy)
           + fetch(y0, x0 + 1) * wx * (1 - wy)
           + fetch(y0 + 1, x0) * (1 - wx) * wy
           + fetch(y0 + 1, x0 + 1) * wx * wy)
    return out.permute(0, 3, 1, 2).to(data.dtype)


# --- GridGenerator ----------------------------------------------------------

def _grid_generator(attrs, data):
    if attrs.transform_type == "affine":
        h, w = attrs.target_shape
        return _affine_grid(data, h, w)
    # warp: data is (n, 2, h, w) optical flow in pixels; the grid is
    # normalize(pixel + flow) (reference: grid_generator-inl.h:114)
    _n, _two, h, w = data.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=data.device),
                            torch.arange(w, device=data.device),
                            indexing="ij")
    fx = data[:, 0].to(_F32) + xs.to(_F32)
    fy = data[:, 1].to(_F32) + ys.to(_F32)
    xn = -1.0 + fx * (2.0 / max(w - 1, 1))
    yn = -1.0 + fy * (2.0 / max(h - 1, 1))
    return torch.stack([xn, yn], dim=1).to(data.dtype)


def _grid_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    if attrs.transform_type == "affine":
        h, w = attrs.target_shape
        return ([d], [(d[0], 2, h, w)], aux_shapes)
    return ([d], [d], aux_shapes)


def _bs_infer(attrs, in_shapes, aux_shapes):
    d, g = in_shapes
    if d is None or g is None:
        return None
    return ([d, g], [(d[0], d[1], g[2], g[3])], aux_shapes)


# --- SpatialTransformer -----------------------------------------------------

def _spatial_transformer(attrs, data, loc):
    if attrs.transform_type != "affine":
        raise MXNetError("SpatialTransformer supports affine only "
                         "(matches reference)")
    h, w = attrs.target_shape
    return _bilinear_sample(data, _affine_grid(loc, h, w))


def _st_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    h, w = attrs.target_shape
    return ([d, (d[0], 6)], [(d[0], d[1], h, w)], aux_shapes)


# --- UpSampling -------------------------------------------------------------

def _upsampling(attrs, *inputs):
    scale = attrs.scale
    if attrs.sample_type == "nearest":
        h0 = inputs[0].shape[2]
        outs = []
        for d in inputs:
            r = (scale * h0) // d.shape[2]
            outs.append(d.repeat_interleave(r, dim=2)
                        .repeat_interleave(r, dim=3))
        if attrs.multi_input_mode == "sum":
            out = outs[0]
            for o in outs[1:]:
                out = out + o
            return out
        return torch.cat(outs, dim=1)
    # bilinear: the grouped transposed convolution with the supplied
    # (C, 1, k, k) weight, k = 2s - s % 2, stride s, pad ceil((s - 1) / 2)
    # (reference: upsampling.cc:40-55)
    data, weight = inputs
    pad = int(np.ceil((scale - 1) / 2.0))
    return F.conv_transpose2d(data, weight, stride=scale, padding=pad,
                              groups=data.shape[1])


def _upsampling_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    s = attrs.scale
    out_h, out_w = d[2] * s, d[3] * s
    if attrs.sample_type == "nearest":
        c = d[1]
        if attrs.multi_input_mode != "sum":
            c = 0
            for sh in in_shapes:
                if sh is None:
                    return None
                c += sh[1]
        return (list(in_shapes), [(d[0], c, out_h, out_w)], aux_shapes)
    k = 2 * s - s % 2
    return ([d, (d[1], 1, k, k)], [(d[0], d[1], out_h, out_w)], aux_shapes)


# --- SVMOutput --------------------------------------------------------------

class _SVMOutputFn(torch.autograd.Function):
    """Identity forward; the backward ignores the head gradient and returns
    the L1- or L2-SVM hinge gradient (svm_output-inl.h:31-47)."""

    @staticmethod
    def forward(ctx, margin, reg_coef, use_linear, data, label):
        ctx.cfg = (margin, reg_coef, use_linear)
        ctx.save_for_backward(data, label)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        margin, reg_coef, use_linear = ctx.cfg
        data, label = ctx.saved_tensors
        x = data.to(_F32)
        k = x.shape[-1]
        onehot = label.to(torch.long)[..., None] == torch.arange(
            k, device=x.device)
        if use_linear:
            # L1-SVM: d/df_y = -reg [f_y < margin]; d/df_x = reg [f_x > -margin]
            g_true = -(x < margin).to(_F32) * reg_coef
            g_wrong = (x > -margin).to(_F32) * reg_coef
        else:
            # L2-SVM: d/df_y = -2 reg max(0, margin - f_y);
            # d/df_x = 2 reg max(0, margin + f_x). The reference snapshot's
            # L2 branch (svm_output.cc:59-62) has these signs inverted, a
            # known upstream bug fixed in later MXNet; this is the descent
            # direction, as in the JAX package.
            g_true = -2.0 * reg_coef * (margin - x).clamp_min(0.0)
            g_wrong = 2.0 * reg_coef * (margin + x).clamp_min(0.0)
        grad = torch.where(onehot, g_true, g_wrong)
        return None, None, None, grad.to(data.dtype), torch.zeros_like(label)


def _svm_output(attrs, data, label):
    return _SVMOutputFn.apply(attrs.margin, attrs.regularization_coefficient,
                              attrs.use_linear, data, label)


def _svm_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    return ([d, tuple(d[:-1])], [d], aux_shapes)


def _register():
    register_op(
        "GridGenerator", _grid_generator,
        params={"transform_type": Enum(("affine", "warp")),
                "target_shape": Shape(default=(0, 0))},
        num_inputs=1, infer_shape=_grid_infer,
        doc="generate a BilinearSampler grid from an affine transform or "
            "optical flow (reference: src/operator/grid_generator.cc)")
    register_op(
        "BilinearSampler", lambda attrs, data, grid:
        _bilinear_sample(data, grid), params={},
        num_inputs=2, input_names=["data", "grid"], infer_shape=_bs_infer,
        doc="bilinear sampling of NCHW data at a normalized grid, zero "
            "outside [-1,1] (reference: src/operator/bilinear_sampler.cc)")
    register_op(
        "SpatialTransformer", _spatial_transformer,
        params={"target_shape": Shape(default=(0, 0)),
                "transform_type": Enum(("affine",)),
                "sampler_type": Enum(("bilinear",))},
        num_inputs=2, input_names=["data", "loc"], infer_shape=_st_infer,
        doc="affine spatial transformer = GridGenerator + BilinearSampler "
            "in one op (reference: src/operator/spatial_transformer.cc)")
    register_op(
        "UpSampling", _upsampling,
        params={"scale": Int(), "num_filter": Int(default=0),
                "sample_type": Enum(("nearest", "bilinear")),
                "multi_input_mode": Enum(("concat", "sum"),
                                         default="concat"),
                "num_args": Int(default=1),
                "workspace": Int(default=512)},
        num_inputs=lambda attrs: (attrs.num_args
                                  if attrs.sample_type == "nearest" else 2),
        input_names=lambda attrs: (
            ["arg%d" % i for i in range(attrs.num_args)]
            if attrs.sample_type == "nearest" else ["data", "weight"]),
        infer_shape=_upsampling_infer,
        doc="nearest (repeat) or bilinear (grouped transposed conv with a "
            "learnable weight) upsampling (reference: "
            "src/operator/upsampling.cc)")
    register_op(
        "SVMOutput", _svm_output,
        params={"margin": Float(default=1.0),
                "regularization_coefficient": Float(default=1.0),
                "use_linear": Bool(default=False)},
        num_inputs=2, input_names=["data", "label"], infer_shape=_svm_infer,
        doc="hinge-loss output head: identity forward, L1/L2 SVM gradient "
            "in backward (reference: src/operator/svm_output.cc)")


_register()

"""The fork's research ops (SURVEY.md §2.6): LSoftmax, MultiLogistic,
WeightedL1, nAvg, SPN, SCN, Correlation1D and Correlation.

Counterpart of ``mxnet_tpu/ops/fork_ops.py`` (reference:
src/operator/lsoftmax-inl.h, multi_logistic-inl.h, weighted_l1-inl.h,
nonzero-average-inl.h, spatial-propagation-inl.h, spatial-completion-inl.h,
correlation1D-inl.h, correlation-inl.h). None was a Pallas kernel in the
JAX package; the ops here are plain torch. Gradients are autograd of the
same forward (LSoftmax's segment index ``k`` is an integer and carries
none), except for the heads, whose backward is the stated formula.

- SPN / SCN are a recurrence over the scan axis: one step per column,
  W sequential steps, each a few elementwise launches over (N, C, H); the
  gates are masked once for all columns before the loop.
- Correlation reduces over the channels one displacement at a time, so
  its memory is one (N, C, H', W') product at a time, not all (2r+1)^2 of
  them (about 11 GB at FlowNetC's setting).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import loss_head
from .param import Bool, Float, Int
from .registry import register_op


# --- LSoftmax -----------------------------------------------------------------

def _lsoftmax(attrs, x, w, label, is_train=False):
    """The large-margin FC head: in training the target logit becomes
    ``((-1)^k cos(m t) - 2k) |x||w|``, blended with the plain one by
    ``beta``; ``k`` is the margin segment of ``cos t`` (ties at a segment
    boundary resolve to the smaller one, eps 1e-5)."""
    out = torch.matmul(x, w.t())
    x_norm = torch.sqrt(torch.sum(x * x, dim=1))
    w_norm = torch.sqrt(torch.sum(w * w, dim=1))
    if not is_train:
        return out, x_norm, w_norm
    margin, beta = attrs.margin, attrs.beta
    k_table = torch.tensor([math.cos(i * math.pi / margin)
                            for i in range(margin + 1)], dtype=torch.float32,
                           device=x.device)
    rows = torch.arange(x.shape[0], device=x.device)
    yi = label.to(torch.int64)
    fo = out[rows, yi]
    denom = x_norm * w_norm[yi]
    cos_t = fo / denom
    with torch.no_grad():
        k = ((k_table[1:][None, :] - cos_t[:, None]) >= 1e-5).sum(dim=1)
        k = k.clamp(0, margin - 1) if margin > 1 else torch.zeros_like(k)
        kf = k.to(torch.float32)
        sign = 1.0 - 2.0 * (kf % 2)
    sin2_t = 1 - cos_t * cos_t
    cos_mt = torch.zeros_like(cos_t)
    for p in range(margin // 2 + 1):
        coef = (-1.0) ** p * math.comb(margin, 2 * p)
        cos_mt = cos_mt + coef * cos_t ** (margin - 2 * p) * sin2_t ** p
    f = (sign * cos_mt - 2.0 * kf) * denom
    new = (f + beta * fo) / (1.0 + beta)
    return out.index_put((rows, yi), new.to(out.dtype)), x_norm, w_norm


def _lsoftmax_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    m = attrs.num_hidden
    return ([d, (m, d[1]), (d[0],)], [(d[0], m), (d[0],), (m,)], aux_shapes)


# --- the heads ------------------------------------------------------------------

def _multi_logistic_forward(attrs, data):
    return torch.sigmoid(data.to(torch.float32)).to(data.dtype)


def _multi_logistic_grad(attrs, out, label):
    """``scale * ((out - y) * y * weight + (out - y) * (1 - y))``."""
    o, lab = out.to(torch.float32), label.to(torch.float32)
    diff = o - lab
    return attrs.grad_scale * (diff * lab * attrs.weight + diff * (1 - lab))


def _weighted_l1_grad(attrs, out, label):
    """``scale * sign(x - y) * (y > 0)``."""
    o, lab = out.to(torch.float32), label.to(torch.float32)
    return attrs.grad_scale * torch.sign(o - lab) * (lab > 0)


def _headlike_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    return None if d is None else ([d, d], [d], aux_shapes)


# --- nAvg -------------------------------------------------------------------------

def _navg(attrs, x):
    """Channel 0: the mean over channels of the values above
    ``threshold`` (0 where none is), per (n, h, w); the rest zero."""
    mask = (x > attrs.threshold).to(torch.float32)
    cnt = mask.sum(dim=1, keepdim=True)
    avg = torch.where(cnt > 0,
                      (x.to(torch.float32) * mask).sum(dim=1, keepdim=True)
                      / cnt.clamp_min(1.0),
                      torch.zeros((), device=x.device))
    rest = torch.zeros_like(x[:, 1:], dtype=torch.float32)
    return torch.cat([avg, rest], dim=1).to(x.dtype)


# --- SPN / SCN --------------------------------------------------------------------

def _canon(arrs, horizontal, reverse):
    """The scan axis last, scanned left to right."""
    if not horizontal:
        arrs = [a.transpose(2, 3) for a in arrs]
    if reverse:
        arrs = [torch.flip(a, dims=(-1,)) for a in arrs]
    return arrs


def _decanon(a, horizontal, reverse):
    if reverse:
        a = torch.flip(a, dims=(-1,))
    return a if horizontal else a.transpose(2, 3)


def _propagate(x, g1, g2, g3, c_mask):
    """The SPN / SCN recurrence over the last axis, one column a step:
    ``h_t[i] = mix(x_t[i], g1 h_{t-1}[i-1] + g2 h_{t-1}[i] + g3
    h_{t-1}[i+1])``, gates zero where the neighbour is outside the column
    and in the first column; the SPN mix is ``(1 - sum g) x + sum g h``,
    the SCN mix ``c x + (1 - c) sum g h``."""
    H, W = x.shape[2], x.shape[3]
    dev = x.device
    rows = torch.arange(H, device=dev)
    up_ok = (rows > 0).to(torch.float32)[:, None]
    dn_ok = (rows < H - 1).to(torch.float32)[:, None]
    first = torch.ones(W, dtype=torch.float32, device=dev)
    first[0] = 0.0
    g1z = g1.to(torch.float32) * up_ok * first
    g2z = g2.to(torch.float32) * first
    g3z = g3.to(torch.float32) * dn_ok * first
    xf = x.to(torch.float32)
    if c_mask is None:
        base, keep = (1 - g1z - g2z - g3z) * xf, None
    else:
        cf = c_mask.to(torch.float32)
        base, keep = cf * xf, 1 - cf
    prev = torch.zeros(x.shape[:3], dtype=torch.float32, device=dev)
    hs = []
    for t in range(W):
        mix = (g1z[..., t] * F.pad(prev[..., :-1], (1, 0))
               + g2z[..., t] * prev
               + g3z[..., t] * F.pad(prev[..., 1:], (0, 1)))
        prev = base[..., t] + (mix if keep is None else keep[..., t] * mix)
        hs.append(prev)
    return torch.stack(hs, dim=-1).to(x.dtype)


def _spn(attrs, x, g1, g2, g3):
    x, g1, g2, g3 = _canon([x, g1, g2, g3], attrs.horizontal, attrs.reverse)
    return _decanon(_propagate(x, g1, g2, g3, None), attrs.horizontal,
                    attrs.reverse)


def _scn(attrs, x, g1, g2, g3, c):
    x, g1, g2, g3, c = _canon([x, g1, g2, g3, c], attrs.horizontal,
                              attrs.reverse)
    return _decanon(_propagate(x, g1, g2, g3, c), attrs.horizontal,
                    attrs.reverse)


def _same_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    return None if d is None else ([d] * len(in_shapes), [d], aux_shapes)


# --- Correlation1D / Correlation ----------------------------------------------

def _corr1d_dims(attrs, h, w):
    kr = (attrs.kernel_size - 1) // 2
    ngr = attrs.max_displacement // attrs.stride2
    ngw = ngr + 1 if attrs.single_side != 0 else 2 * ngr + 1
    border = attrs.max_displacement + kr
    top_w = int(np.ceil((w + 2 * attrs.pad_size - 2 * border)
                        / float(attrs.stride1)))
    top_h = int(np.ceil((h - 2 * kr) / float(attrs.stride1)))
    return ngr, ngw, top_h, top_w


def _correlation1d(attrs, data1, data2):
    """Per horizontal displacement, the mean over the kernel window and
    the channels of data1 times shifted data2; displacements outside the
    image read zeros."""
    ks = attrs.kernel_size
    if ks % 2 == 0:
        raise MXNetError("kernel_size must be odd")
    s1, s2, pad, max_d = (attrs.stride1, attrs.stride2, attrs.pad_size,
                          attrs.max_displacement)
    ngr, ngw, top_h, top_w = _corr1d_dims(attrs, *data1.shape[2:])
    x_shift = {-1: -ngw, 1: 0}.get(attrs.single_side, -ngr)
    extra = abs(x_shift) * s2
    a = F.pad(data1.to(torch.float32), (pad, pad))
    b = F.pad(data2.to(torch.float32), (pad + extra, pad + extra))
    norm = float(ks * ks * data1.shape[1])
    chans = []
    for tc in range(ngw):
        s2o = (tc + x_shift) * s2
        acc = 0.0
        for j in range(ks):
            for i in range(ks):
                av = a[:, :, j:j + top_h * s1:s1,
                       max_d + i:max_d + i + top_w * s1:s1]
                x2 = extra + max_d + s2o + i
                bv = b[:, :, j:j + top_h * s1:s1, x2:x2 + top_w * s1:s1]
                acc = acc + (av * bv).sum(dim=1)
        chans.append(acc / norm)
    return torch.stack(chans, dim=1).to(data1.dtype)


def _corr1d_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    _ngr, ngw, top_h, top_w = _corr1d_dims(attrs, d[2], d[3])
    return ([d, d], [(d[0], ngw, top_h, top_w)], aux_shapes)


def _corr_dims(attrs, h, w):
    kr = (attrs.kernel_size - 1) // 2
    border = attrs.max_displacement + kr
    top_h = int(np.ceil((h + 2 * attrs.pad_size - 2 * border)
                        / float(attrs.stride1)))
    top_w = int(np.ceil((w + 2 * attrs.pad_size - 2 * border)
                        / float(attrs.stride1)))
    ngr = attrs.max_displacement // attrs.stride2
    return top_h, top_w, ngr, 2 * ngr + 1


def _check_corr(attrs, h, w):
    if attrs.kernel_size % 2 == 0:
        raise MXNetError("kernel_size must be odd")
    top_h, top_w, ngr, ngw = _corr_dims(attrs, h, w)
    if top_h < 1 or top_w < 1:
        raise MXNetError("Correlation: neighborhood and kernel do not fit "
                         "in the input")
    return top_h, top_w, ngr, ngw


def _correlation(attrs, data1, data2):
    """FlowNet's 2-D correlation: channel ``tc`` holds displacement
    ``(dy, dx) = ((tc // W) - r, (tc % W) - r) * stride2``; the mean over
    the kernel window and the channels of data1 times (``is_multiply``) or
    minus (absolute) shifted data2, reduced one displacement at a time."""
    ks = attrs.kernel_size
    s1, s2, pad, max_d = (attrs.stride1, attrs.stride2, attrs.pad_size,
                          attrs.max_displacement)
    top_h, top_w, ngr, ngw = _check_corr(attrs, *data1.shape[2:])
    a = F.pad(data1.to(torch.float32), (pad, pad, pad, pad))
    b = F.pad(data2.to(torch.float32), (pad, pad, pad, pad))
    norm = float(ks * ks * data1.shape[1])
    chans = []
    for tc in range(ngw * ngw):
        s2o = (tc % ngw - ngr) * s2
        s2p = (tc // ngw - ngr) * s2
        acc = 0.0
        for j in range(ks):
            for i in range(ks):
                av = a[:, :, max_d + j:max_d + j + top_h * s1:s1,
                       max_d + i:max_d + i + top_w * s1:s1]
                y0, x0 = max_d + s2p + j, max_d + s2o + i
                bv = b[:, :, y0:y0 + top_h * s1:s1, x0:x0 + top_w * s1:s1]
                term = av * bv if attrs.is_multiply else (av - bv).abs()
                acc = acc + term.sum(dim=1)
        chans.append(acc / norm)
    return torch.stack(chans, dim=1).to(data1.dtype)


def _corr_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    top_h, top_w, _ngr, ngw = _check_corr(attrs, d[2], d[3])
    return ([d, d], [(d[0], ngw * ngw, top_h, top_w)], aux_shapes)


def _register():
    register_op(
        "LSoftmax", _lsoftmax,
        params={"margin": Int(default=2), "beta": Float(default=1.0),
                "beta_min": Float(default=0.0), "scale": Float(default=1.0),
                "num_hidden": Int(), "verbose": Bool(default=False)},
        num_inputs=3, input_names=["data", "weight", "label"],
        num_outputs=3, needs_is_train=True, infer_shape=_lsoftmax_infer,
        doc="large-margin softmax FC head (margin in training only)")
    register_op(
        "MultiLogistic", loss_head(_multi_logistic_forward,
                                   _multi_logistic_grad),
        params={"p": Float(default=2.0), "grad_scale": Float(default=1.0),
                "weight": Float(default=1.0)},
        num_inputs=2, input_names=["data", "label"],
        infer_shape=_headlike_infer,
        doc="multi-label sigmoid head with positive-class weighting")
    register_op(
        "WeightedL1", loss_head(lambda attrs, data: data, _weighted_l1_grad),
        params={"grad_scale": Float(default=1.0)},
        num_inputs=2, input_names=["data", "label"],
        infer_shape=_headlike_infer,
        doc="L1 regression head masked to positive labels")
    register_op(
        "nAvg", _navg, params={"threshold": Float(default=1.0)},
        num_inputs=1, input_names=["X"],
        infer_shape=lambda attrs, s, a: ([s[0]], [s[0]], a)
        if s[0] is not None else None,
        doc="channel 0 := mean over channels of values > threshold")
    scan = {"horizontal": Bool(default=False),
            "reverse": Bool(default=False)}
    register_op("SPN", _spn, params=dict(scan), num_inputs=4,
                input_names=["X", "G1", "G2", "G3"], infer_shape=_same_infer,
                doc="three-way spatial propagation")
    register_op("SCN", _scn, params=dict(scan), num_inputs=5,
                input_names=["X", "G1", "G2", "G3", "C"],
                infer_shape=_same_infer, doc="masked spatial completion")
    register_op(
        "Correlation1D", _correlation1d,
        params={"kernel_size": Int(default=1),
                "max_displacement": Int(default=1),
                "stride1": Int(default=1), "stride2": Int(default=1),
                "pad_size": Int(default=0), "single_side": Int(default=0)},
        num_inputs=2, input_names=["data1", "data2"],
        infer_shape=_corr1d_infer,
        doc="FlowNet-style horizontal correlation")
    register_op(
        "Correlation", _correlation,
        params={"kernel_size": Int(default=1),
                "max_displacement": Int(default=1),
                "stride1": Int(default=1), "stride2": Int(default=1),
                "pad_size": Int(default=0), "is_multiply": Bool(default=True)},
        num_inputs=2, input_names=["data1", "data2"],
        infer_shape=_corr_infer,
        doc="FlowNet 2-D correlation over a (2r+1)^2 displacement grid")


_register()

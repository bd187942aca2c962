"""Contrib ops: ``_contrib_CTCLoss`` (also ``ctc_loss`` and
``contrib_ctc_loss``), ``_contrib_fft``, ``_contrib_ifft``,
``_contrib_count_sketch`` and ``_contrib_quantize`` /
``_contrib_dequantize``.

Counterpart of ``mxnet_tpu/ops/contrib.py`` (reference: contrib/ctc_loss.cc,
fft-inl.h, ifft-inl.h, count_sketch-inl.h, quantize-inl.h,
dequantize-inl.h). ``_contrib_SparseEmbedding`` comes with the sparse
types (ROADMAP.md Queue A13).

CTC keeps the JAX package's conventions: pre-softmax ``(T, N, C)`` input,
the per-sample loss ``(N,)`` in float64 (the JAX package runs its
recursion in float64 under ``jax_enable_x64``, on float32 log-probabilities); ``blank_label="first"``: blank 0, labels
0-padded, a label's length the count of its entries > 0;
``blank_label="last"``: blank C-1, -1-padded, the count of entries >= 0;
``use_data_lengths`` freezes a sample's alpha past its length; log-space
"minus infinity" is -1e30, so an infeasible alignment (a label longer than
its input allows) costs about 1e30, not inf; a zero-length label costs the
all-blank path. On the CPU the op is that log-space alpha recursion
(:func:`ctc_recursion`), differentiated by autograd. On the card it is
``torch.nn.functional.ctc_loss`` over ``log_softmax`` (CTC was never a
Pallas kernel), mapped onto those conventions: the samples the library
would call infinite take the recursion's value.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .elemwise import div_scalar
from .param import Bool, Enum, Int, Str
from .registry import alias_op, register_op

NEG_INF = -1e30
# the JAX package's first alpha holds -1e30 rounded through float32 where
# it is valid (its ``.at[].set`` of float32 emissions into a weakly typed
# float64 array), exact -1e30 elsewhere: 1.5e22 apart, which decides the
# first step's merges (and so an infeasible sample's gradient)
NEG_INF_F32 = float(np.float32(NEG_INF))


def _ctc_lengths(attrs, data, label, length_inputs):
    """(blank, int64 labels clipped to the classes, data lengths, label
    lengths)."""
    T, N, C = data.shape
    blank = 0 if attrs.blank_label == "first" else C - 1
    li = list(length_inputs)
    dev = data.device
    data_len = li.pop(0).to(torch.int64) if attrs.use_data_lengths \
        else torch.full((N,), T, dtype=torch.int64, device=dev)
    lab = label.to(torch.int64)
    if attrs.use_label_lengths:
        lab_len = li.pop(0).to(torch.int64)
    elif attrs.blank_label == "first":
        lab_len = (lab > 0).sum(dim=1)
    else:
        lab_len = (lab >= 0).sum(dim=1)
    return blank, lab.clamp(0, C - 1), data_len, lab_len


def _logsumexp0(x):
    """logsumexp over dim 0 as ``jax.scipy.special.logsumexp`` computes it:
    ``log(sum(exp(x - max))) + max`` with the max held constant, so the
    gradient is the softmax weights even where adding ``log(sum)`` to the
    max rounds away (terms near -1e30)."""
    amax = x.amax(dim=0).detach()
    return torch.log(torch.exp(x - amax).sum(dim=0)) + amax


def ctc_recursion(data, lab, data_len, lab_len, blank):
    """The JAX package's log-space alpha recursion
    (``mxnet_tpu/ops/contrib.py:44-96``), step for step: (N,) float64
    losses; alpha is float64, the emissions the input's log-softmax."""
    T, N, C = data.shape
    S = 2 * lab.shape[1] + 1
    dev = data.device
    logp = torch.log_softmax(data, dim=2)
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    s_idx = torch.arange(S, device=dev)
    valid = s_idx[None, :] < (2 * lab_len[:, None] + 1)
    ext_m2 = F.pad(ext, (2, 0), value=blank)[:, :S]
    can_skip = ((s_idx[None, :] % 2) == 1) & (ext != ext_m2)
    neg = torch.full((), NEG_INF, dtype=torch.float64, device=dev)
    neg32 = torch.full((), NEG_INF_F32, dtype=torch.float64, device=dev)

    def emit(t):
        return torch.gather(logp[t], 1, ext)

    e0 = emit(0)
    e0 = e0.to(torch.float64)
    alpha = torch.cat(
        [e0[:, :1], torch.where(lab_len > 0, e0[:, 1], neg32)[:, None],
         neg32.expand(N, S - 2)], dim=1) if S > 1 else e0[:, :1]
    alpha = torch.where(valid, alpha, neg)
    for t in range(1, T):
        a1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :S]
        a2 = F.pad(alpha, (2, 0), value=NEG_INF)[:, :S]
        a2 = torch.where(can_skip, a2, neg)
        new = _logsumexp0(torch.stack([alpha, a1, a2])) + emit(t)
        new = torch.where(valid, new, neg)
        alpha = torch.where((t < data_len)[:, None], new, alpha)
    last = 2 * lab_len
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, (last - 1).clamp_min(0)[:, None])[:, 0]
    a_prev = torch.where(lab_len > 0, a_prev, neg)
    return -_logsumexp0(torch.stack([a_last, a_prev]))


def _ctc_infeasible(lab, data_len, lab_len):
    """Samples whose label needs more steps than their input has (a blank
    between repeated labels included): the library's infinite losses."""
    L = lab.shape[1]
    pos = torch.arange(L - 1, device=lab.device)[None, :]
    repeats = ((lab[:, 1:] == lab[:, :-1])
               & (pos < lab_len[:, None] - 1)).sum(dim=1)
    return lab_len + repeats > data_len


def _ctc_loss(attrs, data, label, *length_inputs):
    blank, lab, data_len, lab_len = _ctc_lengths(attrs, data, label,
                                                 length_inputs)
    if data.device.type != "cuda":
        return ctc_recursion(data, lab, data_len, lab_len, blank)
    lib = F.ctc_loss(torch.log_softmax(data, dim=2).to(torch.float64), lab,
                     data_len, lab_len, blank=blank, reduction="none",
                     zero_infinity=True)
    bad = _ctc_infeasible(lab, data_len, lab_len)
    if not bool(bad.any()):
        return lib
    idx = bad.nonzero()[:, 0]
    rec = ctc_recursion(data[:, idx], lab[idx], data_len[idx], lab_len[idx],
                        blank)
    return lib.index_put((idx,), rec)


def _ctc_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    return (list(in_shapes), [(d[1],)], aux_shapes)


# --- fft, ifft, count_sketch --------------------------------------------------

def _fft(attrs, data):
    """(..., d) real -> (..., 2d): each frequency's real and imaginary
    parts interleaved (fft-inl.h's layout)."""
    c = torch.fft.fft(data.to(torch.complex64), dim=-1)
    out = torch.stack([c.real, c.imag], dim=-1)
    return out.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],)) \
        .to(torch.float32)


def _ifft(attrs, data):
    """The unnormalized inverse of :func:`_fft`'s layout (times d)."""
    d = data.shape[-1] // 2
    x = data.reshape(tuple(data.shape[:-1]) + (d, 2)).to(torch.float32)
    c = torch.complex(x[..., 0], x[..., 1])
    return (torch.fft.ifft(c, dim=-1).real * d).to(torch.float32)


def _count_sketch(attrs, data, h, s):
    """``out[b, h[i]] += s[i] * data[b, i]``: a signed ``index_add``."""
    idx = h.reshape(-1).to(torch.int64)
    contrib = data.to(torch.float32) * s.reshape(-1).to(torch.float32)[None]
    out = torch.zeros((data.shape[0], attrs.out_dim), dtype=torch.float32,
                      device=data.device)
    return out.index_add(1, idx, contrib).to(data.dtype)


# --- uint8 quantization over a calibrated range ------------------------------

def _uint8_step(lo, hi):
    """255 / (hi - lo) as a float32 division (torch's ``255 / t`` would
    multiply by a reciprocal, one rounding more than the reference)."""
    span = hi - lo
    return torch.full_like(span, 255.0) / span


def _quantize(attrs, data, min_range, max_range):
    """float -> uint8 over [min_range, max_range], round half to even."""
    lo, hi = min_range.reshape(()), max_range.reshape(())
    q = torch.round((data.to(torch.float32) - lo) * _uint8_step(lo, hi))
    return q.clamp(0, 255).to(torch.uint8), min_range, max_range


def _dequantize(attrs, data, min_range, max_range):
    """The inverse of :func:`_quantize`: ``q * (hi - lo) / 255 + lo``."""
    lo, hi = min_range.reshape(()), max_range.reshape(())
    return (div_scalar(data.to(torch.float32) * (hi - lo), 255.0) + lo) \
        .to(torch.float32)


def _register():
    register_op(
        "_contrib_quantize", _quantize,
        params={"out_type": Str(default="uint8")},
        num_inputs=3, input_names=["data", "min_range", "max_range"],
        num_outputs=3,
        infer_shape=lambda attrs, s, a: (s, [s[0], (1,), (1,)], a)
        if s[0] is not None else None,
        doc="uint8 quantization over a calibration range")
    register_op(
        "_contrib_dequantize", _dequantize,
        params={"out_type": Str(default="float32")},
        num_inputs=3, input_names=["data", "min_range", "max_range"],
        infer_shape=lambda attrs, s, a: (s, [s[0]], a)
        if s[0] is not None else None,
        doc="the inverse of _contrib_quantize")
    register_op(
        "_contrib_CTCLoss", _ctc_loss,
        params={"use_data_lengths": Bool(default=False),
                "use_label_lengths": Bool(default=False),
                "blank_label": Enum(["first", "last"], default="first")},
        num_inputs=lambda attrs: (2 + int(attrs.use_data_lengths)
                                  + int(attrs.use_label_lengths)),
        input_names=lambda attrs: (
            ["data", "label"]
            + (["data_lengths"] if attrs.use_data_lengths else [])
            + (["label_lengths"] if attrs.use_label_lengths else [])),
        infer_shape=_ctc_infer,
        doc="CTC alignment loss per sample")
    alias_op("_contrib_CTCLoss", "ctc_loss")
    alias_op("_contrib_CTCLoss", "contrib_ctc_loss")
    register_op(
        "_contrib_fft", _fft, params={"compute_size": Int(default=128)},
        num_inputs=1,
        infer_shape=lambda attrs, s, a: (
            [s[0]], [tuple(s[0][:-1]) + (2 * s[0][-1],)], a)
        if s[0] is not None else None,
        doc="FFT along the last axis, re/im interleaved")
    register_op(
        "_contrib_ifft", _ifft, params={"compute_size": Int(default=128)},
        num_inputs=1,
        infer_shape=lambda attrs, s, a: (
            [s[0]], [tuple(s[0][:-1]) + (s[0][-1] // 2,)], a)
        if s[0] is not None else None,
        doc="unnormalized inverse FFT of re/im interleaved input")
    register_op(
        "_contrib_count_sketch", _count_sketch,
        params={"out_dim": Int(), "processing_batch_size": Int(default=32)},
        num_inputs=3, input_names=["data", "h", "s"],
        infer_shape=lambda attrs, s, a: (
            s, [(s[0][0], attrs.out_dim)], a) if s[0] is not None else None,
        doc="count-sketch projection through hash indices and signs")


_register()

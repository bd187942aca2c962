"""Fused multi-layer RNN op (reference: src/operator/rnn-inl.h +
cudnn_rnn-inl.h; cuDNN-only there).

Counterpart of ``mxnet_tpu/ops/rnn.py``, which runs a ``lax.scan`` per
layer and direction. The packed flat parameter layout is the reference's
FusedRNNCell convention: per layer, per direction, W_i2h (G*H, I) and
W_h2h (G*H, H); then all biases, b_i2h (G*H) and b_h2h (G*H). Gate order:
LSTM i, f, c, o; GRU r, z, n with n = tanh(x W_in + b_in + r (h W_hn +
b_hn)). That is cuDNN's math and weight order, which torch shares.

Layout: data (T, N, I) ("TNC"), states (L*D, N, H).

Two routes compute the op:
- :func:`rnn_reference`, the plain version: one input projection over all
  T steps, then a Python loop over time (the reverse direction from the
  last step back). It is what the op runs on the CPU.
- on a CUDA card, cuDNN's RNN through ``torch._VF``, its weight list views
  into the flat ``parameters`` tensor (so gradients reach the flat
  vector). torch copies those views into cuDNN's packed weight buffer on
  every call; the warning it gives for that is silenced here.
Dropout between layers (``p`` > 0 in training) is drawn from mx.random's
generator for the device, inverted, after every layer but the last; on
the card the layers then run one cuDNN call each. cuDNN's own dropout is
not used: its cached dropout state is out of reach of ``mx.random.seed``
and of the generator replay that mirroring relies on.
"""
from __future__ import annotations

import warnings

import torch

from .. import random as _random
from .param import Bool, Enum, Float, Int
from .registry import register_op

__all__ = ["rnn_param_size", "rnn_reference", "rnn_cudnn", "CUDNN_CALLS"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}

# cuDNN RNN calls made by the op on a card (one per layer when dropout
# splits the stack); read by the chip check
CUDNN_CALLS = {"rnn": 0}

warnings.filterwarnings(
    "ignore", message="RNN module weights are not part of single contiguous "
    "chunk of memory", category=UserWarning)


def rnn_param_size(num_layers, state_size, input_size, mode,
                   bidirectional=False):
    """Total packed parameter count (reference: FusedRNNCell._num_gates &
    cudnn weight-space size)."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (in_size + state_size + 2)
    return size


def _layer_offsets(num_layers, state_size, input_size, mode, bidirectional):
    """Compute (weight, bias) slices into the flat parameter vector:
    all weights first (layer-major, direction-minor), then all biases."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    H = state_size
    weights = []
    off = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else H * dirs
        for d in range(dirs):
            w_i2h = (off, gates * H, in_size)
            off += gates * H * in_size
            w_h2h = (off, gates * H, H)
            off += gates * H * H
            weights.append((w_i2h, w_h2h))
    biases = []
    for layer in range(num_layers):
        for d in range(dirs):
            b_i2h = (off, gates * H)
            off += gates * H
            b_h2h = (off, gates * H)
            off += gates * H
            biases.append((b_i2h, b_h2h))
    return weights, biases, off


def _weight_views(parameters, num_layers, state_size, input_size, mode,
                  bidirectional):
    """[w_ih, w_hh, b_ih, b_hh] per (layer, direction), as views into the
    flat vector, in torch's (and cuDNN's) order."""
    weights, biases, _ = _layer_offsets(num_layers, state_size, input_size,
                                        mode, bidirectional)
    views = []
    for ((wo, r, c), (ho, hr, hc)), ((io, ilen), (bo, blen)) in zip(
            weights, biases):
        views.append([parameters[wo:wo + r * c].view(r, c),
                      parameters[ho:ho + hr * hc].view(hr, hc),
                      parameters[io:io + ilen], parameters[bo:bo + blen]])
    return views


def _between_layers_dropout(x, p, gen):
    """Inverted dropout of a layer's output, as the Dropout op draws it."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _direction(mode, x, w_ih, w_hh, b_ih, b_hh, h, c, reverse):
    """One layer, one direction of the plain version: (T, N, I) ->
    ((T, N, H), h_T, c_T)."""
    gi_all = torch.matmul(x, w_ih.t()) + b_ih
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    ys = [None] * x.shape[0]
    for t in steps:
        gh = torch.matmul(h, w_hh.t()) + b_hh
        if mode == "lstm":
            i, f, g, o = (gi_all[t] + gh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            ir, iz, inn = gi_all[t].chunk(3, dim=-1)
            hr, hz, hn = gh.chunk(3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(inn + r * hn)
            h = (1 - z) * n + z * h
        elif mode == "rnn_tanh":
            h = torch.tanh(gi_all[t] + gh)
        else:
            h = torch.relu(gi_all[t] + gh)
        ys[t] = h
    return torch.stack(ys), h, c


def rnn_reference(mode, data, parameters, state, state_cell=None,
                  num_layers=1, state_size=None, bidirectional=False, p=0.0,
                  is_train=False, rng=None):
    """The plain version of the fused op: returns (output (T, N, H*D),
    h_T (L*D, N, H), c_T (L*D, N, H) or None)."""
    H = state_size if state_size is not None else state.shape[-1]
    dirs = 2 if bidirectional else 1
    views = _weight_views(parameters, num_layers, H, data.shape[2], mode,
                          bidirectional)
    x = data
    h_outs, c_outs = [], []
    for layer in range(num_layers):
        ys_dirs = []
        for d in range(dirs):
            idx = layer * dirs + d
            c0 = state_cell[idx] if mode == "lstm" else None
            ys, hT, cT = _direction(mode, x, *views[idx], state[idx], c0,
                                    reverse=d == 1)
            ys_dirs.append(ys)
            h_outs.append(hT)
            c_outs.append(cT)
        x = ys_dirs[0] if dirs == 1 else torch.cat(ys_dirs, dim=-1)
        if is_train and p > 0 and layer < num_layers - 1:
            gen = rng if rng is not None else _random.generator(x.device)
            x = _between_layers_dropout(x, p, gen)
    return (x, torch.stack(h_outs),
            torch.stack(c_outs) if mode == "lstm" else None)


def _cudnn_call(mode, x, flat_weights, hx, cx, num_layers, bidirectional,
                train):
    """One torch RNN call over ``num_layers`` layers (cuDNN on a card)."""
    CUDNN_CALLS["rnn"] += 1
    fn = getattr(torch._VF, mode)    # lstm, gru, rnn_tanh, rnn_relu
    if mode == "lstm":
        out, h, c = fn(x, (hx, cx), flat_weights, True, num_layers, 0.0,
                       train, bidirectional, False)
        return out, h, c
    out, h = fn(x, hx, flat_weights, True, num_layers, 0.0, train,
                bidirectional, False)
    return out, h, None


def rnn_cudnn(mode, data, parameters, state, state_cell=None, num_layers=1,
              state_size=None, bidirectional=False, p=0.0, is_train=False,
              rng=None):
    """The fused op on a CUDA card through cuDNN; the contract of
    :func:`rnn_reference`. One multi-layer call when no dropout is drawn,
    else one call per layer with the dropout between them."""
    if data.device.type != "cuda":
        raise RuntimeError("rnn_cudnn runs on a CUDA device, got %s"
                           % data.device)
    H = state_size if state_size is not None else state.shape[-1]
    dirs = 2 if bidirectional else 1
    views = _weight_views(parameters, num_layers, H, data.shape[2], mode,
                          bidirectional)
    # cuDNN keeps its backward's reserve space only in training mode
    train = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (data, parameters, state, state_cell))
    data = data.contiguous()
    state = state.contiguous()
    state_cell = state_cell.contiguous() if mode == "lstm" else None
    if not (is_train and p > 0 and num_layers > 1):
        return _cudnn_call(mode, data, [w for v in views for w in v], state,
                           state_cell, num_layers, bidirectional, train)
    x = data
    h_outs, c_outs = [], []
    for layer in range(num_layers):
        lo, hi = layer * dirs, (layer + 1) * dirs
        x, h, c = _cudnn_call(
            mode, x, [w for v in views[lo:hi] for w in v], state[lo:hi],
            state_cell[lo:hi] if mode == "lstm" else None, 1, bidirectional,
            train)
        h_outs.append(h)
        c_outs.append(c)
        if layer < num_layers - 1:
            gen = rng if rng is not None else _random.generator(x.device)
            x = _between_layers_dropout(x, p, gen)
    return (x, torch.cat(h_outs),
            torch.cat(c_outs) if mode == "lstm" else None)


def _rnn(attrs, data, parameters, state, *rest, is_train=False, rng=None):
    state_cell = rest[0] if attrs.mode == "lstm" else None
    route = rnn_cudnn if data.device.type == "cuda" else rnn_reference
    out, h, c = route(attrs.mode, data, parameters, state, state_cell,
                      num_layers=attrs.num_layers,
                      state_size=attrs.state_size,
                      bidirectional=attrs.bidirectional, p=attrs.p,
                      is_train=is_train, rng=rng)
    outs = [out]
    if attrs.state_outputs:
        outs.append(h)
        if attrs.mode == "lstm":
            outs.append(c)
    return tuple(outs)


def rnn_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    T, N, I = d
    H = attrs.state_size
    L = attrs.num_layers
    dirs = 2 if attrs.bidirectional else 1
    psize = rnn_param_size(L, H, I, attrs.mode, attrs.bidirectional)
    shapes = [d, (psize,), (L * dirs, N, H)]
    if attrs.mode == "lstm":
        shapes.append((L * dirs, N, H))
    outs = [(T, N, H * dirs)]
    if attrs.state_outputs:
        outs.append((L * dirs, N, H))
        if attrs.mode == "lstm":
            outs.append((L * dirs, N, H))
    return (shapes, outs, aux_shapes)


register_op(
    "RNN", _rnn,
    params={"state_size": Int(), "num_layers": Int(),
            "mode": Enum(["rnn_relu", "rnn_tanh", "lstm", "gru"]),
            "bidirectional": Bool(default=False),
            "p": Float(default=0.0),
            "state_outputs": Bool(default=False),
            "pkeep_": Float(default=1.0),
            "lstm_q_": Bool(default=False)},
    num_inputs=lambda attrs: 4 if attrs.mode == "lstm" else 3,
    input_names=lambda attrs: (
        ["data", "parameters", "state"] +
        (["state_cell"] if attrs.mode == "lstm" else [])),
    num_outputs=lambda attrs: (
        (3 if attrs.mode == "lstm" else 2) if attrs.state_outputs else 1),
    infer_shape=rnn_infer, needs_is_train=True, needs_rng=True,
    doc="Fused multi-layer (bi)directional RNN/LSTM/GRU: cuDNN on a card, "
        "a loop over time elsewhere (reference: src/operator/rnn-inl.h:45, "
        "cudnn_rnn-inl.h)")

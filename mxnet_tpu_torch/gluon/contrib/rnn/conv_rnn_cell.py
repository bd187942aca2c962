"""Convolutional recurrent cells (ConvRNN / ConvLSTM / ConvGRU, 1-3D).

Reference: python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py:975 — the
Shi et al. ConvLSTM family, where every gate is a convolution over a
spatial hidden state instead of a dense product. Counterpart of
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``; the gate convolutions
are the ported ``Convolution`` (cuDNN on a card).

The state keeps MXNet's NC-major layout; kernels are declared
(num_gates*hidden_channels, in_channels, *kernel) exactly like the
reference so checkpoints line up.
"""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell
from ...utils import _to_initializer as _b

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tuple(v, dims, what):
    if isinstance(v, int):
        return (v,) * dims
    v = tuple(v)
    if len(v) != dims:
        raise ValueError("%s must be an int or a length-%d tuple, got %r"
                         % (what, dims, v))
    return v


class _ConvRNNBase(HybridRecurrentCell):
    """Shared machinery: shape bookkeeping + the two gate convolutions."""

    # subclasses set: _gate_names (tuple), _num_states (int)

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if conv_layout != "NC" + "DHW"[3 - dims:]:
            raise ValueError(
                "only the channel-major layout %r is supported here "
                "(as in the JAX package); got %r"
                % ("NC" + "DHW"[3 - dims:], conv_layout))
        self._dims = dims
        self._conv_layout = conv_layout
        self._activation = activation
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)   # (C, spatial...)
        if len(self._input_shape) != dims + 1:
            raise ValueError(
                "input_shape must be (channels, %s) — %d entries for a "
                "%dD cell; got %r"
                % (", ".join("spatial"[:7] + str(i)
                             for i in range(dims)), dims + 1, dims,
                   input_shape))
        self._i2h_kernel = _tuple(i2h_kernel, dims, "i2h_kernel")
        self._h2h_kernel = _tuple(h2h_kernel, dims, "h2h_kernel")
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError("h2h_kernel must be odd (state-sized output "
                             "needs symmetric padding); got %r"
                             % (self._h2h_kernel,))
        self._i2h_pad = _tuple(i2h_pad, dims, "i2h_pad")
        self._i2h_dilate = _tuple(i2h_dilate, dims, "i2h_dilate")
        self._h2h_dilate = _tuple(h2h_dilate, dims, "h2h_dilate")
        # the h2h conv must map state -> same-shaped state: "same" pad
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))

        in_channels = self._input_shape[0]
        spatial = self._input_shape[1:]
        out_spatial = tuple(
            (s + 2 * p - d * (k - 1) - 1) + 1
            for s, p, d, k in zip(spatial, self._i2h_pad,
                                  self._i2h_dilate, self._i2h_kernel))
        self._state_shape = (hidden_channels,) + out_spatial

        ngates = len(self._gate_names)
        self.i2h_weight = self.params.get(
            "i2h_weight",
            shape=(ngates * hidden_channels, in_channels) + self._i2h_kernel,
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(ngates * hidden_channels,
                   hidden_channels) + self._h2h_kernel,
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(ngates * hidden_channels,),
            init=_b(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(ngates * hidden_channels,),
            init=_b(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._conv_layout}
                for _ in range(self._num_states)]

    def _conv_gates(self, F, inputs, state_h, i2h_weight, h2h_weight,
                    i2h_bias, h2h_bias):
        nf = self._hidden_channels * len(self._gate_names)
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias, num_filter=nf,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            dilate=self._i2h_dilate,
                            name="t%d_i2h" % self._counter)
        h2h = F.Convolution(state_h, h2h_weight, h2h_bias, num_filter=nf,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate,
                            name="t%d_h2h" % self._counter)
        return i2h, h2h


class _ConvRNNCell(_ConvRNNBase):
    _gate_names = ("",)
    _num_states = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, states[0], i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation,
                                      name="t%d_out" % self._counter)
        return output, [output]


class _ConvLSTMCell(_ConvRNNBase):
    _gate_names = ("_i", "_f", "_c", "_o")
    _num_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, states[0], i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        gates = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1,
                               name="t%d_slice" % self._counter)
        in_gate = F.Activation(gates[0], act_type="sigmoid")
        forget_gate = F.Activation(gates[1], act_type="sigmoid")
        in_transform = self._get_activation(F, gates[2], self._activation)
        out_gate = F.Activation(gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c,
                                                 self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_ConvRNNBase):
    _gate_names = ("_r", "_z", "_o")
    _num_states = 1

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, states[0], i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_o = F.SliceChannel(
            i2h, num_outputs=3, axis=1, name="t%d_i2h" % self._counter)
        h2h_r, h2h_z, h2h_o = F.SliceChannel(
            h2h, num_outputs=3, axis=1, name="t%d_h2h" % self._counter)
        reset = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        cand = self._get_activation(F, i2h_o + reset * h2h_o,
                                    self._activation)
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]


def _make_cell(base, dims, alias_doc):
    class Cell(base):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     i2h_weight_initializer=None,
                     h2h_weight_initializer=None,
                     i2h_bias_initializer="zeros",
                     h2h_bias_initializer="zeros",
                     conv_layout="NC" + "DHW"[3 - dims:],
                     activation="tanh", prefix=None, params=None):
            super().__init__(
                input_shape=input_shape, hidden_channels=hidden_channels,
                i2h_kernel=i2h_kernel, h2h_kernel=h2h_kernel,
                i2h_pad=i2h_pad, i2h_dilate=i2h_dilate,
                h2h_dilate=h2h_dilate,
                i2h_weight_initializer=i2h_weight_initializer,
                h2h_weight_initializer=h2h_weight_initializer,
                i2h_bias_initializer=i2h_bias_initializer,
                h2h_bias_initializer=h2h_bias_initializer,
                dims=dims, conv_layout=conv_layout, activation=activation,
                prefix=prefix, params=params)

    Cell.__doc__ = alias_doc
    return Cell


Conv1DRNNCell = _make_cell(_ConvRNNCell, 1,
                           "1D ConvRNN (reference: conv_rnn_cell.py:218)")
Conv2DRNNCell = _make_cell(_ConvRNNCell, 2,
                           "2D ConvRNN (reference: conv_rnn_cell.py:285)")
Conv3DRNNCell = _make_cell(_ConvRNNCell, 3,
                           "3D ConvRNN (reference: conv_rnn_cell.py:352)")
Conv1DLSTMCell = _make_cell(_ConvLSTMCell, 1,
                            "1D ConvLSTM (Shi et al.; reference: "
                            "conv_rnn_cell.py:473)")
Conv2DLSTMCell = _make_cell(_ConvLSTMCell, 2,
                            "2D ConvLSTM (Shi et al.; reference: "
                            "conv_rnn_cell.py:550)")
Conv3DLSTMCell = _make_cell(_ConvLSTMCell, 3,
                            "3D ConvLSTM (Shi et al.; reference: "
                            "conv_rnn_cell.py:627)")
Conv1DGRUCell = _make_cell(_ConvGRUCell, 1,
                           "1D ConvGRU (reference: conv_rnn_cell.py:762)")
Conv2DGRUCell = _make_cell(_ConvGRUCell, 2,
                           "2D ConvGRU (reference: conv_rnn_cell.py:834)")
Conv3DGRUCell = _make_cell(_ConvGRUCell, 3,
                           "3D ConvGRU (reference: conv_rnn_cell.py:906)")

for _name in __all__:
    _cls = globals()[_name]
    _cls.__name__ = _cls.__qualname__ = _name

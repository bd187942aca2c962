"""Convolutional RNN cells for the symbolic API, the counterpart of
``mxnet_tpu/rnn/conv_rnn_cell.py`` (reference:
python/mxnet/rnn/rnn_cell.py:1094-1460 BaseConvRNNCell/ConvRNNCell/
ConvLSTMCell/ConvGRUCell — Shi et al. NeurIPS 2015 ConvLSTM).

Design: one base that builds the i2h/h2h gate convolutions (shared
weight Variables via RNNParams) and infers the spatial state shape from
the i2h geometry; each concrete cell supplies its gate table and step
combination — the same decomposition as the dense cells in
rnn_cell.py, with Convolution replacing FullyConnected.
"""
import functools

from .. import symbol
from ..base import MXNetError
from .rnn_cell import BaseRNNCell

__all__ = ["BaseConvRNNCell", "ConvRNNCell", "ConvLSTMCell",
           "ConvGRUCell"]

_DEFAULT_ACT = functools.partial(symbol.LeakyReLU, act_type="leaky",
                                 slope=0.2)


class BaseConvRNNCell(BaseRNNCell):
    """Shared machinery: gate convolutions + state-shape inference."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation=_DEFAULT_ACT,
                 prefix="", params=None, conv_layout="NCHW"):
        super().__init__(prefix=prefix, params=params)
        if conv_layout != "NCHW":
            raise MXNetError("conv RNN cells support conv_layout='NCHW' "
                             "(got %r)" % (conv_layout,))
        if any(k % 2 == 0 for k in h2h_kernel):
            raise MXNetError("h2h_kernel must be odd (state shape must "
                             "be preserved), got %s" % (h2h_kernel,))
        self._num_hidden = num_hidden
        self._input_shape = tuple(input_shape)
        self._activation = activation
        self._conv_layout = conv_layout
        self._i2h_geom = dict(kernel=tuple(i2h_kernel),
                              stride=tuple(i2h_stride),
                              pad=tuple(i2h_pad),
                              dilate=tuple(i2h_dilate))
        # "same" padding keeps the h2h conv state-shape-preserving
        self._h2h_geom = dict(
            kernel=tuple(h2h_kernel),
            stride=(1, 1),
            pad=tuple(d * (k - 1) // 2
                      for k, d in zip(h2h_kernel, h2h_dilate)),
            dilate=tuple(h2h_dilate))

        probe = symbol.Convolution(symbol.Variable("data"),
                                   num_filter=num_hidden,
                                   **self._i2h_geom)
        out_shape = probe.infer_shape(data=self._input_shape)[1][0]
        self._state_shape = (0,) + tuple(out_shape[1:])

        self._bind_gate_params()

    @property
    def _num_gates(self):
        return len(self._gate_names)

    @property
    def state_info(self):
        one = {"shape": self._state_shape,
               "__layout__": self._conv_layout}
        return [dict(one)]

    def _gates(self, inputs, states, tag):
        """The (i2h, h2h) gate-stack pair (num_hidden * num_gates maps);
        most cells sum them, GRU combines them gate-wise."""
        nf = self._num_hidden * self._num_gates
        i2h = symbol.Convolution(inputs, weight=self._iW, bias=self._iB,
                                 num_filter=nf, name=tag + "i2h",
                                 **self._i2h_geom)
        h2h = symbol.Convolution(states[0], weight=self._hW,
                                 bias=self._hB, num_filter=nf,
                                 name=tag + "h2h", **self._h2h_geom)
        return i2h, h2h

    def _split_gates(self, gates, tag):
        return list(symbol.SliceChannel(
            gates, num_outputs=self._num_gates, axis=1,
            name=tag + "slice"))


class ConvRNNCell(BaseConvRNNCell):
    """Elman step with convolutions: h' = act(conv_i(x) + conv_h(h))."""

    def __init__(self, input_shape, num_hidden, prefix="ConvRNN_",
                 **kwargs):
        super().__init__(input_shape, num_hidden, prefix=prefix, **kwargs)

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        tag = self._step_tag()
        i2h, h2h = self._gates(inputs, states, tag)
        out = self._get_activation(i2h + h2h, self._activation,
                                   name=tag + "out")
        return out, [out]


class ConvLSTMCell(BaseConvRNNCell):
    """ConvLSTM (Shi et al. 2015): gate order i, f, c, o."""

    def __init__(self, input_shape, num_hidden, prefix="ConvLSTM_",
                 **kwargs):
        super().__init__(input_shape, num_hidden, prefix=prefix, **kwargs)

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    @property
    def state_info(self):
        one = {"shape": self._state_shape,
               "__layout__": self._conv_layout}
        return [dict(one), dict(one)]

    def __call__(self, inputs, states):
        self._counter += 1
        tag = self._step_tag()
        i2h, h2h = self._gates(inputs, states, tag)
        gi, gf, gc, go = self._split_gates(i2h + h2h, tag)
        in_gate = symbol.Activation(gi, act_type="sigmoid", name=tag + "i")
        forget = symbol.Activation(gf, act_type="sigmoid", name=tag + "f")
        cand = self._get_activation(gc, self._activation, name=tag + "c")
        out_gate = symbol.Activation(go, act_type="sigmoid",
                                     name=tag + "o")
        next_c = forget * states[1] + in_gate * cand
        next_h = out_gate * self._get_activation(next_c, self._activation)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """Convolutional GRU: gate order r, z, o."""

    def __init__(self, input_shape, num_hidden, prefix="ConvGRU_",
                 **kwargs):
        super().__init__(input_shape, num_hidden, prefix=prefix, **kwargs)

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        tag = self._step_tag()
        i2h, h2h = self._gates(inputs, states, tag)
        i_r, i_z, i_o = self._split_gates(i2h, tag + "i2h_")
        h_r, h_z, h_o = self._split_gates(h2h, tag + "h2h_")
        reset = symbol.Activation(i_r + h_r, act_type="sigmoid",
                                  name=tag + "r")
        update = symbol.Activation(i_z + h_z, act_type="sigmoid",
                                   name=tag + "z")
        cand = self._get_activation(i_o + reset * h_o, self._activation,
                                    name=tag + "h")
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]

"""Gluon fused recurrent layers (RNN / LSTM / GRU).

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference
gluon/rnn/rnn_layer.py): ctor signatures, parameter naming
(``l0_i2h_weight`` ...), begin_state/forward protocol, _unfuse. Every
forward goes through the registered ``RNN`` op (ops/rnn.py: cuDNN on a
card, the loop over time on the CPU), so no unfuse fallback is needed.
Parameters come from one spec generator shared with the flat-blob packing
order, and the state layout is a class attribute instead of per-class
state_info bodies.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import Block
from ..utils import _to_initializer as _b

__all__ = ["RNN", "LSTM", "GRU"]

_GATE_COUNTS = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _RNNLayer(Block):
    """Multi-layer (optionally bidirectional) fused recurrent layer."""

    _STATE_TENSORS = 1  # LSTM carries (h, c)

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise AssertionError(
                "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = _GATE_COUNTS[mode]

        inits = {"i2h_weight": i2h_weight_initializer,
                 "h2h_weight": h2h_weight_initializer,
                 "i2h_bias": _b(i2h_bias_initializer),
                 "h2h_bias": _b(h2h_bias_initializer)}
        for name, shape in self._param_specs(input_size):
            kind = name.split("_", 1)[1]
            p = self.params.get(name, shape=shape, init=inits[kind],
                                allow_deferred_init=True)
            setattr(self, name, p)

    def _directions(self):
        return ("l", "r")[:self._dir]

    def _param_specs(self, input_size):
        """(name, shape) for every parameter, in registration order."""
        width = self._gates * self._hidden_size
        fan_in = input_size
        for layer in range(self._num_layers):
            for side in self._directions():
                tag = "%s%d_" % (side, layer)
                yield tag + "i2h_weight", (width, fan_in)
                yield tag + "h2h_weight", (width, self._hidden_size)
                yield tag + "i2h_bias", (width,)
                yield tag + "h2h_bias", (width,)
            fan_in = self._hidden_size * self._dir

    def __repr__(self):
        shape = self.l0_i2h_weight.shape
        head = "%s -> %s" % (shape[1] if shape[1] else None,
                             shape[0] // self._gates)
        extras = [head, self._layout]
        if self._num_layers != 1:
            extras.append("num_layers=%s" % self._num_layers)
        if self._dropout != 0:
            extras.append("dropout=%s" % self._dropout)
        if self._dir == 2:
            extras.append("bidirectional")
        return "%s(%s)" % (type(self).__name__, ", ".join(extras))

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"}
                for _ in range(self._STATE_TENSORS)]

    def _unfuse(self):
        """Equivalent explicit cell stack sharing this layer's params."""
        from . import rnn_cell as cell_mod

        step_cls, step_kw = {
            "rnn_relu": (cell_mod.RNNCell, {"activation": "relu"}),
            "rnn_tanh": (cell_mod.RNNCell, {"activation": "tanh"}),
            "lstm": (cell_mod.LSTMCell, {}),
            "gru": (cell_mod.GRUCell, {}),
        }[self._mode]

        stack = cell_mod.SequentialRNNCell(prefix=self.prefix,
                                           params=self.collect_params())
        with stack.name_scope():
            fan_in = self._input_size
            for layer in range(self._num_layers):
                common = dict(
                    step_kw, input_size=fan_in,
                    i2h_weight_initializer=self._i2h_weight_initializer,
                    h2h_weight_initializer=self._h2h_weight_initializer,
                    i2h_bias_initializer=self._i2h_bias_initializer,
                    h2h_bias_initializer=self._h2h_bias_initializer)

                def make(side, layer=layer, common=common):
                    return step_cls(self._hidden_size,
                                    prefix="%s%d_" % (side, layer), **common)

                if self._dir == 2:
                    stack.add(cell_mod.BidirectionalCell(make("l"), make("r")))
                else:
                    stack.add(make("l"))
                if self._dropout > 0 and layer != self._num_layers - 1:
                    stack.add(cell_mod.DropoutCell(self._dropout))
                fan_in = self._hidden_size * self._dir
        return stack

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial state tensors (default zeros)."""
        func = func or nd.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            spec = dict(info)
            spec.pop("__layout__", None)
            spec.update(kwargs)
            try:
                states.append(func(name="%sh0_%d" % (self.prefix, i), **spec))
            except TypeError:
                states.append(func(**spec))
        return states

    def _finish_deferred(self, inputs):
        """Resolve deferred weight shapes from the first real input."""
        feature_size = inputs.shape[2]
        for side in self._directions():
            first = getattr(self, "%s0_i2h_weight" % side)
            first.shape = (self._gates * self._hidden_size, feature_size)
        for p in self.collect_params().values():
            p._finish_deferred_init()
        self._input_size = feature_size

    def forward(self, inputs, states=None):
        batch_size = inputs.shape[self._layout.find("N")]
        implicit = states is None
        if implicit:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, nd.NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s."
                    % (str(info["shape"]), str(state.shape)))
        if self._input_size == 0:
            self._finish_deferred(inputs)
        out = self._forward_kernel(inputs, states)
        return out[0] if implicit else out

    def _flat_params(self, ctx):
        """All weights then all biases, layer-major, as one flat vector
        (the fused op's canonical blob layout)."""
        chunks = []
        for kind in ("weight", "bias"):
            for layer in range(self._num_layers):
                for side in self._directions():
                    for group in ("i2h", "h2h"):
                        p = getattr(self, "%s%d_%s_%s"
                                    % (side, layer, group, kind))
                        chunks.append(p.data(ctx).reshape((-1,)))
        return nd.concatenate(chunks, axis=0)

    def _forward_kernel(self, inputs, states):
        if self._layout == "NTC":
            inputs = nd.swapaxes(inputs, dim1=0, dim2=1)
        blob = self._flat_params(inputs.context)
        node = nd.RNN(inputs, blob, *states, state_size=self._hidden_size,
                      num_layers=self._num_layers,
                      bidirectional=self._dir == 2, p=self._dropout,
                      state_outputs=True, mode=self._mode)
        outputs = node[0]
        states = [node[1], node[2]] if self._mode == "lstm" else [node[1]]
        if self._layout == "NTC":
            outputs = nd.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, states


def _ctor_args(local_vars):
    """Rearrange a subclass ctor's locals() into base-ctor kwargs."""
    picked = dict(local_vars)
    picked.pop("self")
    picked.pop("__class__", None)
    extra = picked.pop("kwargs")
    picked.update(extra)
    return picked


class RNN(_RNNLayer):
    """Stacked Elman RNN with relu/tanh activation."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        picked = _ctor_args(locals())
        super().__init__(mode="rnn_" + picked.pop("activation"), **picked)


class LSTM(_RNNLayer):
    """Stacked LSTM (BASELINE config #4's layer)."""

    _STATE_TENSORS = 2

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(mode="lstm", **_ctor_args(locals()))


class GRU(_RNNLayer):
    """Stacked GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(mode="gru", **_ctor_args(locals()))

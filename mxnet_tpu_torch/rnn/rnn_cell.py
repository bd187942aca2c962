"""Symbolic RNN cells (pre-Gluon toolkit; feeds BucketingModule).

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (reference rnn/rnn_cell.py):
cell classes, weight naming (``<prefix>i2h_weight`` etc.), pack/unpack
between per-gate and fused layouts, the unroll protocol. FusedRNNCell
emits the registered ``RNN`` op (ops/rnn.py: cuDNN on a card, a loop over
time elsewhere). The three step cells share one projection helper,
fused-blob slicing walks a generated (name, size, shape) spec, and gate
math uses sigmoid/tanh ops directly.
"""
from __future__ import annotations

import numpy as np

from .. import symbol
from ..base import MXNetError
from ..ops.rnn import rnn_param_size

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


class RNNParams(object):
    """Lazily-created, prefix-scoped weight Variables shared by cells."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = symbol.Variable(full, **kwargs)
        return self._params[full]


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Coerce ``inputs`` to a step list (merge=False) or a stacked symbol
    (merge=True); merge=None keeps the incoming form. Returns
    (inputs, time_axis)."""
    if inputs is None:
        raise AssertionError("unroll requires explicit input symbols")
    time_axis = layout.find("T")
    src_axis = in_layout.find("T") if in_layout is not None else time_axis

    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            if len(inputs.list_outputs()) != 1:
                raise AssertionError(
                    "unroll doesn't allow grouped symbol as input. Please "
                    "convert to list with list(inputs) first or let unroll "
                    "handle splitting.")
            inputs = list(symbol.SliceChannel(inputs, axis=src_axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
    else:
        if length is not None and len(inputs) != length:
            raise AssertionError("sequence length mismatch")
        if merge is True:
            grown = [symbol.expand_dims(s, axis=time_axis) for s in inputs]
            inputs = symbol.Concat(*grown, dim=time_axis, num_args=len(grown))
            src_axis = time_axis

    if isinstance(inputs, symbol.Symbol) and time_axis != src_axis:
        inputs = symbol.SwapAxis(inputs, dim1=time_axis, dim2=src_axis)
    return inputs, time_axis


class BaseRNNCell(object):
    """Abstract symbolic step cell."""

    def __init__(self, prefix="", params=None):
        self._own_params = params is None
        self._params = RNNParams(prefix) if params is None else params
        self._prefix = prefix
        self._modified = False
        self.reset()

    def reset(self):
        self._counter = -1
        self._init_counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Fresh initial-state symbols built by ``func``."""
        if self._modified:
            raise AssertionError(
                "After applying modifier cells (e.g. DropoutCell) the base "
                "cell cannot be called directly. Call the modifier cell "
                "instead.")
        out = []
        for info in self.state_info:
            self._init_counter += 1
            if info is not None:
                kwargs.update(info)
            out.append(func(name="%sbegin_state_%d"
                            % (self._prefix, self._init_counter), **kwargs))
        return out

    def _fused_entries(self):
        """(fused name, [per-gate names]) pairs for i2h/h2h weights+biases."""
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            for kind in ("weight", "bias"):
                fused = f"{self._prefix}{group}_{kind}"
                split = [f"{self._prefix}{group}{gate}_{kind}"
                         for gate in self._gate_names]
                yield fused, split, h

    def unpack_weights(self, args):
        """Fused blobs -> per-gate entries (identity for gateless cells)."""
        args = args.copy()
        if not self._gate_names:
            return args
        for fused, split, h in self._fused_entries():
            blob = args.pop(fused)
            for j, name in enumerate(split):
                args[name] = blob[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Per-gate entries -> fused blobs."""
        args = args.copy()
        if not self._gate_names:
            return args
        for fused, split, _h in self._fused_entries():
            parts = [args.pop(name) for name in split]
            if isinstance(parts[0], np.ndarray):
                args[fused] = np.concatenate(parts)
            else:
                from .. import ndarray as nd
                args[fused] = nd.concatenate(parts)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Step the cell ``length`` times building an explicit graph."""
        self.reset()
        steps, _ = _normalize_sequence(length, inputs, layout, False)
        states = begin_state if begin_state is not None else self.begin_state()
        outs = []
        for t in range(length):
            out, states = self(steps[t], states)
            outs.append(out)
        outs, _ = _normalize_sequence(length, outs, layout, merge_outputs)
        return outs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def _step_tag(self):
        """Per-step node-name prefix."""
        return "%st%d_" % (self._prefix, self._counter)

    def _bind_gate_params(self, bias_init=None):
        """Create/fetch the four standard projection weights."""
        self._iW = self.params.get("i2h_weight")
        self._iB = (self.params.get("i2h_bias", init=bias_init)
                    if bias_init is not None
                    else self.params.get("i2h_bias"))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    def _project(self, inputs, hidden, gates, tag):
        """Fused input and hidden projections of width gates*num_hidden."""
        width = gates * self._num_hidden
        return (symbol.FullyConnected(inputs, self._iW, self._iB,
                                      num_hidden=width, name=tag + "i2h"),
                symbol.FullyConnected(hidden, self._hW, self._hB,
                                      num_hidden=width, name=tag + "h2h"))


class RNNCell(BaseRNNCell):
    """Elman step cell: h' = act(W_i x + W_h h + b)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._bind_gate_params()

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        tag = self._step_tag()
        i2h, h2h = self._project(inputs, states[0], 1, tag)
        out = self._get_activation(i2h + h2h, self._activation,
                                   name=tag + "out")
        return out, [out]


class LSTMCell(BaseRNNCell):
    """LSTM step cell; gates stacked i, f, c, o; forget bias via init."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        from ..initializer import LSTMBias
        self._bind_gate_params(bias_init=LSTMBias(forget_bias=forget_bias))

    @property
    def state_info(self):
        hc = {"shape": (0, self._num_hidden), "__layout__": "NC"}
        return [dict(hc), dict(hc)]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        tag = self._step_tag()
        i2h, h2h = self._project(inputs, states[0], 4, tag)
        gi, gf, gc, go = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                             name=tag + "slice")
        memory = (symbol.sigmoid(gf, name=tag + "f") * states[1]
                  + symbol.sigmoid(gi, name=tag + "i")
                  * symbol.tanh(gc, name=tag + "c"))
        hidden = symbol.sigmoid(go, name=tag + "o") * symbol.tanh(memory)
        return hidden, [hidden, memory]


class GRUCell(BaseRNNCell):
    """GRU step cell; gates stacked r, z, o."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._bind_gate_params()

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        tag = self._step_tag()
        prev = states[0]
        i2h, h2h = self._project(inputs, prev, 3, tag)
        ir, iz, ic = symbol.SliceChannel(i2h, num_outputs=3,
                                         name=tag + "i2h_slice")
        hr, hz, hc = symbol.SliceChannel(h2h, num_outputs=3,
                                         name=tag + "h2h_slice")
        reset = symbol.sigmoid(ir + hr, name=tag + "r_act")
        update = symbol.sigmoid(iz + hz, name=tag + "z_act")
        cand = symbol.tanh(ic + reset * hc, name=tag + "h_act")
        out = update * prev + (1. - update) * cand
        return out, [out]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence multi-layer cell emitting one fused RNN node."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        super().__init__(prefix=mode + "_" if prefix is None else prefix,
                         params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        from ..initializer import FusedRNN
        self._parameter = self.params.get(
            "parameters", init=FusedRNN(None, num_hidden, num_layers, mode,
                                        bidirectional, forget_bias))

    @property
    def state_info(self):
        dirs = len(self._directions)
        shape = (dirs * self._num_layers, 0, self._num_hidden)
        count = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"}
                for _ in range(count)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _blob_spec(self, num_input):
        """Yield (name, size, shape|None) for every slice of the flat blob,
        in the canonical order: all weights, then all biases."""
        lh = self._num_hidden
        dirs = self._directions
        fan_in_scale = len(dirs)
        for kind in ("weight", "bias"):
            for layer in range(self._num_layers):
                for direction in dirs:
                    for group in ("i2h", "h2h"):
                        for gate in self._gate_names:
                            name = (f"{self._prefix}{direction}{layer}_"
                                    f"{group}{gate}_{kind}")
                            if kind == "bias":
                                yield name, lh, None
                            elif group == "h2h":
                                yield name, lh * lh, (lh, lh)
                            else:
                                fan_in = (num_input if layer == 0
                                          else lh * fan_in_scale)
                                yield name, lh * fan_in, (lh, fan_in)

    def unpack_weights(self, args):
        args = args.copy()
        blob = args.pop(self._parameter.name)
        dirs = len(self._directions)
        m, h = self._num_gates, self._num_hidden
        # invert rnn_param_size to recover the input width
        num_input = (int(blob.size) // dirs // h // m
                     - (self._num_layers - 1) * (h + dirs * h + 2) - h - 2)
        at = 0
        for name, size, shape in self._blob_spec(num_input):
            piece = blob[at:at + size]
            args[name] = piece.reshape(shape) if shape else piece
            at += size
        if at != blob.size:
            raise AssertionError("Invalid parameters size for FusedRNNCell")
        return args

    def pack_weights(self, args):
        args = args.copy()
        probe = f"{self._prefix}l0_i2h{self._gate_names[0]}_weight"
        num_input = args[probe].shape[1]
        flat = [args.pop(name).reshape((-1,))
                for name, _size, _shape in self._blob_spec(num_input)]
        if isinstance(flat[0], np.ndarray):
            # initializer path works on host numpy buffers
            packed = np.concatenate(flat)
        else:
            from .. import ndarray as nd
            packed = nd.concatenate(flat)
        want = rnn_param_size(self._num_layers, self._num_hidden, num_input,
                              self._mode, self._bidirectional)
        if packed.size != want:
            raise AssertionError("Invalid parameters size: %d vs %d"
                                 % (packed.size, want))
        args[self._parameter.name] = packed
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError("FusedRNNCell cannot be stepped. Please "
                                  "use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:  # the fused op wants TNC
            inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        states = begin_state if begin_state is not None else self.begin_state()

        node = symbol.RNN(inputs, self._parameter, *states,
                          state_size=self._num_hidden,
                          num_layers=self._num_layers,
                          bidirectional=self._bidirectional, p=self._dropout,
                          state_outputs=self._get_next_state, mode=self._mode,
                          name=self._prefix + "rnn")

        if not self._get_next_state:
            outputs, out_states = node, []
        elif self._mode == "lstm":
            outputs, out_states = node[0], [node[1], node[2]]
        else:
            outputs, out_states = node[0], [node[1]]
        if axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol.SliceChannel(outputs, axis=axis,
                                               num_outputs=length,
                                               squeeze_axis=1))
        return outputs, out_states

    def unfuse(self):
        """Build the equivalent stack of explicit step cells."""
        step_cls, step_kw = {
            "rnn_relu": (RNNCell, {"activation": "relu"}),
            "rnn_tanh": (RNNCell, {"activation": "tanh"}),
            "lstm": (LSTMCell, {}),
            "gru": (GRUCell, {}),
        }[self._mode]

        stack = SequentialRNNCell()
        for layer in range(self._num_layers):
            def cell_for(side, layer=layer):  # bind: invoked per iteration
                return step_cls(self._num_hidden,
                                prefix="%s%s%d_" % (self._prefix, side,
                                                    layer),
                                **step_kw)
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    cell_for("l"), cell_for("r"),
                    output_prefix="%sbi_l%d_" % (self._prefix, layer)))
            else:
                stack.add(cell_for("l"))
            if self._dropout > 0 and layer != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, layer)))
        return stack


def _merged_state_info(cells):
    return sum((c.state_info for c in cells), [])


def _merged_begin_state(cells, **kwargs):
    return sum((c.begin_state(**kwargs) for c in cells), [])


def _repack_through(cells, args, direction):
    for cell in cells:
        args = getattr(cell, direction)(args)
    return args


class SequentialRNNCell(BaseRNNCell):
    """Vertical stack of cells with a flattened state list."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            if not cell._own_params:
                raise AssertionError(
                    "Either specify params for SequentialRNNCell or child "
                    "cells, not both.")
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _merged_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _merged_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        return _repack_through(self._cells, args, "unpack_weights")

    def pack_weights(self, args):
        return _repack_through(self._cells, args, "pack_weights")

    def _state_slices(self, states):
        at = 0
        for cell in self._cells:
            width = len(cell.state_info)
            yield cell, states[at:at + width]
            at += width

    def __call__(self, inputs, states):
        self._counter += 1
        carried = []
        for cell, chunk in self._state_slices(states):
            if isinstance(cell, BidirectionalCell):
                raise AssertionError("bidirectional cells cannot be stepped")
            inputs, chunk = cell(inputs, chunk)
            carried.extend(chunk)
        return inputs, carried

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        final = []
        last = len(self._cells) - 1
        for i, (cell, chunk) in enumerate(self._state_slices(begin_state)):
            inputs, chunk = cell.unroll(
                length, inputs=inputs, begin_state=chunk, layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            final.extend(chunk)
        return inputs, final


class DropoutCell(BaseRNNCell):
    """Stateless dropout over step inputs (or the whole merged tensor)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        if not isinstance(dropout, (int, float)):
            raise AssertionError("dropout rate must be numeric")
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if isinstance(inputs, symbol.Symbol):
            return self(inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(BaseRNNCell):
    """Wrap a base cell: weights/states belong to it, the step differs."""

    def __init__(self, base_cell):
        base_cell._modified = True
        super().__init__()
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, init_sym=symbol.zeros, **kwargs):
        if self._modified:
            raise MXNetError("cannot request begin_state through an "
                             "already-consumed modifier")
        # temporarily lift the wrapped cell's modified latch so it can
        # build its own initial states
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(init_sym, **kwargs)
        finally:
            self.base_cell._modified = True

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Per-step stochastic identity on outputs/states (Krueger et al.)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        for bad, why in ((FusedRNNCell, "unfuse the cell first"),
                         (BidirectionalCell,
                          "wrap the inner directional cells instead "
                          "(bidirectional cells cannot step)")):
            if isinstance(base_cell, bad):
                raise MXNetError("ZoneoutCell cannot wrap a %s: %s"
                                 % (bad.__name__, why))
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        new_out, new_states = self.base_cell(inputs, states)

        def keep(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        old_out = (self.prev_output if self.prev_output is not None
                   else symbol.zeros_like(new_out))
        out = new_out
        if self.zoneout_outputs != 0.:
            out = symbol.where(keep(self.zoneout_outputs, new_out),
                               new_out, old_out)
        if self.zoneout_states != 0.:
            new_states = [
                symbol.where(keep(self.zoneout_states, ns), ns, os)
                for ns, os in zip(new_states, states)]
        self.prev_output = out
        return out, new_states


class ResidualCell(ModifierCell):
    """Add the step input to the wrapped cell's output."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        try:
            outs, states = self.base_cell.unroll(
                length, inputs=inputs, begin_state=begin_state, layout=layout,
                merge_outputs=merge_outputs)
        finally:
            self.base_cell._modified = True
        if merge_outputs is None:
            merge_outputs = isinstance(outs, symbol.Symbol)
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if merge_outputs:
            return outs + inputs, states
        return [o + x for o, x in zip(outs, inputs)], states


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cells over the sequence, outputs concatenated."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            if not (l_cell._own_params and r_cell._own_params):
                raise AssertionError(
                    "Either specify params for BidirectionalCell or child "
                    "cells, not both.")
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _repack_through(self._cells, args, "unpack_weights")

    def pack_weights(self, args):
        return _repack_through(self._cells, args, "pack_weights")

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. "
                                  "Please use unroll")

    @property
    def state_info(self):
        return _merged_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _merged_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        fwd, bwd = self._cells
        split_at = len(fwd.state_info)
        fwd_out, fwd_states = fwd.unroll(
            length, inputs=steps, begin_state=begin_state[:split_at],
            layout=layout, merge_outputs=merge_outputs)
        bwd_out, bwd_states = bwd.unroll(
            length, inputs=list(reversed(steps)),
            begin_state=begin_state[split_at:], layout=layout,
            merge_outputs=False)

        if merge_outputs is None:
            merge_outputs = isinstance(fwd_out, symbol.Symbol)
        if merge_outputs:
            if not isinstance(fwd_out, symbol.Symbol):
                fwd_out, _ = _normalize_sequence(length, fwd_out, layout,
                                                 True)
            bwd_out, _ = _normalize_sequence(length,
                                             list(reversed(bwd_out)),
                                             layout, True)
            outs = symbol.Concat(fwd_out, bwd_out, dim=2, num_args=2,
                                 name="%sout" % self._output_prefix)
        else:
            if isinstance(fwd_out, symbol.Symbol):
                fwd_out = list(symbol.SliceChannel(
                    fwd_out, axis=axis, num_outputs=length, squeeze_axis=1))
            outs = [symbol.Concat(f, b, dim=1, num_args=2,
                                  name="%st%d" % (self._output_prefix, t))
                    for t, (f, b) in enumerate(zip(fwd_out,
                                                   reversed(bwd_out)))]
        return outs, fwd_states + bwd_states

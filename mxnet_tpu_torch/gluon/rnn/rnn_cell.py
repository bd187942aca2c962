"""Gluon recurrent cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference
gluon/rnn/rnn_cell.py: cell classes, unroll protocol,
state_info/begin_state, parameter names i2h_*/h2h_*). The three gated cells derive from one
``_GatedCell`` that owns the fused input/hidden projections (gate count is
a class attribute), sequence formatting is split into typed helpers, and
gate math uses the sigmoid/tanh ops directly.
"""
from __future__ import annotations

from ... import ndarray as nd
from ... import symbol as sym_mod
from ..block import Block, HybridBlock
from ..utils import _to_initializer as _b

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _is_tensor(x):
    return isinstance(x, (nd.NDArray, sym_mod.Symbol))


def _namespace_of(x):
    probe = x if _is_tensor(x) else x[0]
    return sym_mod if isinstance(probe, sym_mod.Symbol) else nd


def _split_seq(F, tensor, time_axis, length):
    """Merged tensor -> list of per-step tensors (time axis squeezed)."""
    if F is sym_mod:
        if len(tensor.list_outputs()) != 1:
            raise AssertionError(
                "unroll doesn't allow grouped symbol as input. Please "
                "convert to list first or let unroll handle splitting.")
        return list(sym_mod.SliceChannel(tensor, axis=time_axis,
                                         num_outputs=length, squeeze_axis=1))
    steps = tensor.shape[time_axis]
    if length is not None and length != steps:
        raise AssertionError("sequence length mismatch")
    return [t.squeeze(axis=time_axis)
            for t in nd.SliceChannel(tensor, axis=time_axis,
                                     num_outputs=steps)]


def _stack_seq(F, seq, axis):
    """List of per-step tensors -> one merged tensor with a new time axis."""
    grown = [F.expand_dims(s, axis=axis) for s in seq]
    return F.Concat(*grown, dim=axis, num_args=len(grown))


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Normalize ``inputs`` to the requested form.

    Returns (inputs, time_axis, F, batch_size). merge=False yields a list of
    step tensors; merge=True yields one stacked tensor; merge=None keeps the
    incoming form.
    """
    if inputs is None:
        raise AssertionError(
            "unroll(inputs=None) has been deprecated. Please create input "
            "variables outside unroll.")
    time_axis = layout.find("T")
    batch_axis = layout.find("N")
    src_axis = in_layout.find("T") if in_layout is not None else time_axis
    batch_size = 0

    if _is_tensor(inputs):
        F = _namespace_of(inputs)
        if F is nd:
            batch_size = inputs.shape[batch_axis]
        if merge is False:
            inputs = _split_seq(F, inputs, src_axis, length)
    else:
        if length is not None and len(inputs) != length:
            raise AssertionError("sequence length mismatch")
        F = _namespace_of(inputs)
        if F is nd:
            batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = _stack_seq(F, inputs, time_axis)

    if _is_tensor(inputs) and time_axis != src_axis:
        inputs = F.swapaxes(inputs, dim1=time_axis, dim2=src_axis)
    return inputs, time_axis, F, batch_size


def _stacked_state_info(cells, batch_size):
    return sum((c.state_info(batch_size) for c in cells), [])


def _stacked_begin_state(cells, **kwargs):
    return sum((c.begin_state(**kwargs) for c in cells), [])


def _default_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is not None:
        return begin_state
    if F is nd:
        ctx = inputs.context if _is_tensor(inputs) else inputs[0].context
        with ctx:
            return cell.begin_state(func=F.zeros, batch_size=batch_size)
    return cell.begin_state(func=F.zeros, batch_size=batch_size)


class RecurrentCell(Block):
    """Abstract step cell: ``cell(step_input, states) -> (out, states)``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Forget unroll counters so the cell can be unrolled again."""
        self._counter = -1
        self._init_counter = -1

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Build initial state arrays/symbols via ``func`` (default zeros)."""
        if self._modified:
            raise AssertionError(
                "After applying modifier cells (e.g. ZoneoutCell) the base "
                "cell cannot be called directly. Call the modifier cell "
                "instead.")
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            spec = dict(info or {})
            spec.pop("__layout__", None)
            spec.update(kwargs)
            tag = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            try:
                states.append(func(name=tag, **spec))
            except TypeError:
                states.append(func(**spec))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Apply the cell ``length`` times over the time axis."""
        self.reset()
        steps, _, F, batch_size = _format_sequence(length, inputs, layout,
                                                   False)
        states = _default_begin_state(self, F, begin_state, steps, batch_size)
        outs = []
        for t in range(length):
            out, states = self(steps[t], states)
            outs.append(out)
        outs, _, _, _ = _format_sequence(length, outs, layout, merge_outputs)
        return outs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Recurrent cell usable under hybridize."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _GatedCell(HybridRecurrentCell):
    """Shared machinery for RNN/LSTM/GRU: fused i2h / h2h projections with
    ``_GATES`` gates stacked along the hidden axis."""

    _GATES = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        width = self._GATES * hidden_size
        for tag, shape, init in (
                ("i2h_weight", (width, input_size), i2h_weight_initializer),
                ("h2h_weight", (width, hidden_size), h2h_weight_initializer),
                ("i2h_bias", (width,), _b(i2h_bias_initializer)),
                ("h2h_bias", (width,), _b(h2h_bias_initializer))):
            setattr(self, tag, self.params.get(
                tag, shape=shape, init=init, allow_deferred_init=True))

    def _hc_info(self, batch_size):
        return {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}

    def state_info(self, batch_size=0):
        return [self._hc_info(batch_size)]

    def _project(self, F, inputs, hidden, i2h_weight, h2h_weight, i2h_bias,
                 h2h_bias):
        width = self._GATES * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                 num_hidden=width, name="i2h"),
                F.FullyConnected(hidden, h2h_weight, h2h_bias,
                                 num_hidden=width, name="h2h"))


class RNNCell(_GatedCell):
    """Elman cell: h' = act(W_i x + W_h h + b)."""

    _GATES = 1

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        # activation sits between hidden_size and the initializer kwargs in
        # the reference signature; accept it positionally here too
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._project(F, inputs, states[0], i2h_weight, h2h_weight,
                                 i2h_bias, h2h_bias)
        out = self._get_activation(F, i2h + h2h, self._activation, name="out")
        return out, [out]


class LSTMCell(_GatedCell):
    """LSTM with gates stacked in i, f, c, o order."""

    _GATES = 4

    def state_info(self, batch_size=0):
        return [self._hc_info(batch_size), self._hc_info(batch_size)]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._project(F, inputs, states[0], i2h_weight, h2h_weight,
                                 i2h_bias, h2h_bias)
        gi, gf, gc, go = F.SliceChannel(i2h + h2h, num_outputs=4,
                                        name="slice")
        memory = F.sigmoid(gf) * states[1] + F.sigmoid(gi) * F.tanh(gc)
        hidden = F.sigmoid(go) * F.tanh(memory)
        return hidden, [hidden, memory]


class GRUCell(_GatedCell):
    """GRU with gates stacked in r, z, o order."""

    _GATES = 3

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev = states[0]
        i2h, h2h = self._project(F, inputs, prev, i2h_weight, h2h_weight,
                                 i2h_bias, h2h_bias)
        ir, iz, ic = F.SliceChannel(i2h, num_outputs=3, name="i2h_slice")
        hr, hz, hc = F.SliceChannel(h2h, num_outputs=3, name="h2h_slice")
        reset = F.sigmoid(ir + hr, name="r_act")
        update = F.sigmoid(iz + hz, name="z_act")
        candidate = F.tanh(ic + reset * hc, name="h_act")
        out = update * prev + (1. - update) * candidate
        return out, [out]


class SequentialRNNCell(RecurrentCell):
    """Vertically stacked cells sharing one flattened state list."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _stacked_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _stacked_begin_state(self._children, **kwargs)

    def _state_slices(self, states):
        """Carve the flat state list into per-cell chunks."""
        at = 0
        for cell in self._children:
            width = len(cell.state_info())
            yield cell, states[at:at + width]
            at += width

    def __call__(self, inputs, states):
        self._counter += 1
        collected = []
        for cell, chunk in self._state_slices(states):
            if isinstance(cell, BidirectionalCell):
                raise AssertionError(
                    "BidirectionalCell cannot be stepped inside a stack")
            inputs, chunk = cell(inputs, chunk)
            collected.extend(chunk)
        return inputs, collected

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _, F, batch_size = _format_sequence(length, inputs, layout,
                                                    None)
        begin_state = _default_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        final_states = []
        last = len(self._children) - 1
        for i, (cell, chunk) in enumerate(
                self._state_slices(begin_state)):
            inputs, chunk = cell.unroll(
                length, inputs=inputs, begin_state=chunk, layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            final_states.extend(chunk)
        return inputs, final_states

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Stateless dropout applied to the step input."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix, params)
        if not isinstance(rate, float):
            raise AssertionError("rate must be a float")
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate,
                               name="t%d_fwd" % self._counter)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if _is_tensor(inputs):
            # dropout is time-independent: apply once to the merged tensor
            return self.hybrid_forward(F, inputs, begin_state or [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(HybridRecurrentCell):
    """Wrap a base cell, reusing its parameters but changing its step."""

    def __init__(self, base_cell):
        if base_cell._modified:
            raise AssertionError(
                "Cell %s is already modified. One cell cannot be modified "
                "twice" % base_cell.name)
        base_cell._modified = True
        tag = base_cell.prefix + self._alias()
        super().__init__(prefix=tag, params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(func=func or nd.zeros, **kwargs)
        finally:
            self.base_cell._modified = True

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Randomly preserve previous outputs/states (Krueger et al. 2016)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        if isinstance(base_cell, BidirectionalCell):
            raise AssertionError(
                "BidirectionalCell doesn't support zoneout since it doesn't "
                "support step. Please add ZoneoutCell to the cells "
                "underneath instead.")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self.prev_output = None

    def hybrid_forward(self, F, inputs, states):
        new_out, new_states = self.base_cell(inputs, states)

        def keep_mask(p, like):
            return F.Dropout(like * 0 + 1, p=p)

        old_out = (self.prev_output if self.prev_output is not None
                   else new_out * 0)
        out = new_out
        if self.zoneout_outputs != 0.:
            out = F.where(keep_mask(self.zoneout_outputs, new_out),
                          new_out, old_out)
        if self.zoneout_states != 0.:
            new_states = [F.where(keep_mask(self.zoneout_states, ns), ns, os)
                          for ns, os in zip(new_states, states)]
        self.prev_output = out
        return out, new_states


class ResidualCell(ModifierCell):
    """Add the step input to the base cell's output."""

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
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
            merge_outputs = _is_tensor(outs)
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if merge_outputs:
            outs = outs + inputs
        else:
            outs = [o + x for o, x in zip(outs, inputs)]
        return outs, states


class BidirectionalCell(HybridRecurrentCell):
    """Run one cell forward and one backward; concat their outputs."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _stacked_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _stacked_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, _axis, F, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        states = _default_begin_state(self, F, begin_state, steps, batch_size)
        fwd_cell, bwd_cell = self._children
        split_at = len(fwd_cell.state_info())

        fwd_out, fwd_states = fwd_cell.unroll(
            length, inputs=steps, begin_state=states[:split_at],
            layout=layout, merge_outputs=merge_outputs)
        bwd_out, bwd_states = bwd_cell.unroll(
            length, inputs=list(reversed(steps)),
            begin_state=states[split_at:], layout=layout, merge_outputs=False)

        if merge_outputs is None:
            merge_outputs = _is_tensor(fwd_out)
            fwd_out, _, _, _ = _format_sequence(None, fwd_out, layout,
                                                merge_outputs)
        if merge_outputs:
            bwd_out, _, _, _ = _format_sequence(
                None, list(reversed(bwd_out)), layout, True)
            outs = F.Concat(fwd_out, bwd_out, dim=2, num_args=2)
        else:
            outs = [F.Concat(f, b, dim=1, num_args=2)
                    for f, b in zip(fwd_out, reversed(bwd_out))]
        return outs, fwd_states + bwd_states

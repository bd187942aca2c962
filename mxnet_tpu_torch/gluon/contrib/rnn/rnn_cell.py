"""Contrib recurrent cell modifiers (counterpart of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``).

Reference: python/mxnet/gluon/contrib/rnn/rnn_cell.py —
VariationalDropoutCell (Gal & Ghahramani variational dropout: one
dropout mask sampled per sequence and reused at every time step, unlike
DropoutCell's fresh mask per step).
"""
from __future__ import annotations

from ...rnn.rnn_cell import BidirectionalCell, ModifierCell

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(ModifierCell):
    """Same-mask-across-time dropout on a wrapped cell's inputs, outputs
    and/or first state channel (reference: contrib/rnn/rnn_cell.py:26).

    Masks are sampled lazily at the first step after ``reset()`` and held
    fixed until the next reset; ``unroll`` resets automatically, manual
    stepping must call ``reset()`` between sequences.
    """

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        # the reference only rejects bidirectional stacks for state
        # dropout; a plain SequentialRNNCell shares its first state
        # legitimately and needs no special case
        if drop_states and isinstance(base_cell, BidirectionalCell):
            raise ValueError(
                "BidirectionalCell cannot take variational state dropout "
                "from outside (it has no single step direction); wrap the "
                "inner cells instead")
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._masks = {}

    def _alias(self):
        return "vardrop"

    def hybridize(self, active=True):
        """This cell itself stays eager: under a hybridized walk the
        dropout node would resample per invocation, silently degrading
        to per-step dropout. The wrapped cell still hybridizes — the mask
        multiply is the only eager op left."""
        if active:
            import warnings

            warnings.warn(
                "VariationalDropoutCell runs eagerly (masks must persist "
                "across steps); hybridizing only the wrapped cell",
                stacklevel=2)
        self._active = False
        self._clear_cached_op()
        for child in self._children:
            child.hybridize(active)

    def reset(self):
        super().reset()
        self._masks = {}

    def _mask(self, F, name, rate, like):
        # one mask per sequence: sample once, reuse every step
        if name not in self._masks:
            ones = like * 0 + 1
            self._masks[name] = F.Dropout(ones, p=rate)
        return self._masks[name]

    def hybrid_forward(self, F, inputs, states):
        if self.drop_states:
            states = list(states)
            # only h (always the first state entry) is dropped, matching
            # the reference
            states[0] = states[0] * self._mask(F, "states",
                                               self.drop_states, states[0])
        if self.drop_inputs:
            inputs = inputs * self._mask(F, "inputs", self.drop_inputs,
                                         inputs)
        output, next_states = self.base_cell(inputs, states)
        if self.drop_outputs:
            output = output * self._mask(F, "outputs", self.drop_outputs,
                                         output)
        return output, next_states

"""Checkpoint helpers for the symbolic RNN toolkit.

Counterpart of ``mxnet_tpu/rnn/rnn.py`` (reference rnn/rnn.py): fused cell weights are unpacked to
per-gate form on save (so checkpoints are portable across fused/unfused
cells) and re-packed on load.
"""
from __future__ import annotations

from functools import reduce

from .. import model
from .rnn_cell import BaseRNNCell

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _through(cells, args, op):
    """Fold args through op ('pack_weights'/'unpack_weights') of each cell."""
    chain = [cells] if isinstance(cells, BaseRNNCell) else list(cells)
    return reduce(lambda acc, cell: getattr(cell, op)(acc), chain, args)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save, converting each cell's fused weights to per-gate entries."""
    model.save_checkpoint(prefix, epoch, symbol,
                          _through(cells, arg_params, "unpack_weights"),
                          aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load, re-fusing per-gate entries into each cell's packed layout."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    return sym, _through(cells, arg, "pack_weights"), aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch callback running save_rnn_checkpoint every ``period`` epochs."""
    stride = max(1, int(period))

    def maybe_save(epoch, sym=None, arg=None, aux=None):
        tick = epoch + 1
        if tick % stride == 0:
            save_rnn_checkpoint(cells, prefix, tick, sym, arg, aux)

    return maybe_save


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):
    """Deprecated alias of ``cell.unroll`` (reference: rnn/rnn.py:26).
    Auto-creates the legacy per-step input variables
    ``%st%d_data`` when ``inputs`` is None."""
    import warnings

    from .. import symbol

    warnings.warn("rnn_unroll is deprecated. Please call cell.unroll "
                  "directly.")
    if inputs is None:
        inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                  for i in range(length)]
    return cell.unroll(length=length, inputs=inputs,
                       begin_state=begin_state, layout=layout)

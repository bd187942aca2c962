"""The pre-1.0 experimental autograd surface.

Counterpart of ``mxnet_tpu/contrib/autograd.py`` (reference
contrib/autograd.py: set_is_training, train_section/test_section,
mark_variables, backward, compute_gradient, grad_and_loss, grad), kept
so old user code keeps running; the modern
surface is ``mx.autograd``. The old API coupled recording and training
into one flag, so every toggle here flips both on the current tape.
"""
from __future__ import annotations

import contextlib
import functools

from .. import autograd as _ag

__all__ = ["set_is_training", "train_section", "test_section",
           "mark_variables", "backward", "compute_gradient",
           "grad_and_loss", "grad", "TrainingStateScope"]


def set_is_training(is_train):
    """Flip training+recording together; returns the previous train flag."""
    previous = _ag.set_training(is_train)
    _ag.set_recording(is_train)
    return previous


@contextlib.contextmanager
def _coupled_scope(state):
    outer = set_is_training(state)
    try:
        yield
    finally:
        set_is_training(outer)


def train_section():
    """Scope with training (and recording) on."""
    return _coupled_scope(True)


def test_section():
    """Scope with training (and recording) off."""
    return _coupled_scope(False)


mark_variables = _ag.mark_variables


def backward(outputs, out_grads=None, retain_graph=False):
    """Old-API spelling of autograd.backward."""
    return _ag.backward(outputs, head_grads=out_grads,
                        retain_graph=retain_graph)


def compute_gradient(outputs):
    """Backward with implicit all-ones head gradients."""
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """Wrap ``func`` so calls return (gradients, outputs)."""

    @functools.wraps(func)
    def wrapped(*args):
        from ..ndarray import NDArray, zeros_like

        if argnum is None:
            chosen = list(range(len(args)))
        elif isinstance(argnum, int):
            chosen = [argnum]
        else:
            chosen = list(argnum)
        leaves = [args[i] for i in chosen]
        for leaf in leaves:
            if not isinstance(leaf, NDArray):
                raise AssertionError(
                    "type of autograd input should be NDArray")
        buffers = [zeros_like(leaf) for leaf in leaves]
        mark_variables(leaves, buffers)
        with train_section():
            outputs = func(*args)
            heads = [outputs] if isinstance(outputs, NDArray) else outputs
            backward(heads)
        return buffers, outputs

    return wrapped


def grad(func, argnum=None):
    """Wrap ``func`` so calls return only the gradients."""
    paired = grad_and_loss(func, argnum)

    @functools.wraps(paired)
    def wrapped(*args):
        return paired(*args)[0]

    return wrapped


class TrainingStateScope:
    """Scope that sets/restores the training flag (reference:
    contrib/autograd.py:54)."""

    def __init__(self, enter_state):
        self._enter_state = enter_state
        self._prev = None

    def __enter__(self):
        self._prev = set_is_training(self._enter_state)

    def __exit__(self, ptype, value, trace):
        if self._prev != self._enter_state:
            set_is_training(self._prev)

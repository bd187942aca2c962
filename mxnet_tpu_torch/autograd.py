"""Imperative autograd on torch's own (reference: python/mxnet/autograd.py,
src/imperative/imperative.cc).

Counterpart of ``mxnet_tpu/autograd.py``, which keeps a tape of ``jax.vjp``
closures. Here torch's autograd is the tape: inside :func:`record`, the
``mx.nd`` ops run with grad enabled and their results keep their
``grad_fn``; outside it they run under ``torch.no_grad()``.
``attach_grad`` / :func:`mark_variables` make an array's tensor a leaf
that requires grad and give it a gradient buffer with a ``grad_req``.
:func:`backward` walks the graph from the heads to the marked leaves it
reaches and computes their gradients with ``torch.autograd.grad``, then
writes them into the buffers: ``"write"`` overwrites, ``"add"``
accumulates, ``"null"`` skips (torch itself would always accumulate into
``.grad``, which is never used here). :func:`grad` returns gradients
instead, with ``create_graph`` for higher orders.

The recording and training flags are thread-local, as in the JAX
package. An in-place write (``a[:] = x``, ``+=``, an optimizer update)
into a tensor that a recorded graph saved for its backward makes that
backward raise (torch's version counter): MXNet's semantics are that a
recorded op reads its inputs' values at record time.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = [
    "record",
    "pause",
    "train_mode",
    "predict_mode",
    "is_recording",
    "is_training",
    "mark_variables",
    "backward",
    "grad",
    "set_recording",
    "set_training",
    "Function",
    "get_symbol",
]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.train_mode = False
    return _state


def is_recording():
    """Whether ops are recorded for autograd (reference: autograd.py:160)."""
    return _st().recording


def is_training():
    """Whether ops run in train mode (reference: autograd.py:168)."""
    return _st().train_mode


def set_recording(is_record):
    st = _st()
    prev = st.recording
    st.recording = bool(is_record)
    return prev


def set_training(train_mode_):
    st = _st()
    prev = st.train_mode
    st.train_mode = bool(train_mode_)
    return prev


class _RecordingStateScope:
    """with-scope flipping recording/train flags (reference: autograd.py:93)."""

    def __init__(self, is_record, train_mode_):
        self._enter_record = is_record
        self._enter_train = train_mode_
        self._prev = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.train_mode)
        if self._enter_record is not None:
            st.recording = self._enter_record
        if self._enter_train is not None:
            st.train_mode = self._enter_train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.train_mode = self._prev


def record(train_mode=True):
    """Scope: record ops for autograd (reference: autograd.py:93)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope: stop recording (reference: autograd.py:126)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    """Scope: train mode without recording (reference: autograd.py:151)."""
    return _RecordingStateScope(None, True)


def predict_mode():
    """Scope: predict mode (reference: autograd.py:165)."""
    return _RecordingStateScope(None, False)


# --- variables and gradients ------------------------------------------------

def _make_variable(arr, grad_arr, grad_req):
    """Make ``arr``'s tensor a leaf that requires grad (a floating one),
    with ``grad_arr`` as its gradient buffer."""
    t = arr._data.detach()
    if t.is_floating_point() or t.is_complex():
        t.requires_grad_(grad_req != "null")
    t._mx_variable = weakref.ref(arr)
    arr._data = t
    arr._grad = grad_arr
    arr._grad_req = grad_req


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to arrays (reference: autograd.py:197 /
    imperative.cc:112)."""
    from .ndarray.ndarray import NDArray

    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, gradient, req in zip(variables, gradients, grad_reqs):
        _make_variable(var, gradient, req)


def _as_list(x, kind):
    from .ndarray.ndarray import NDArray

    if isinstance(x, NDArray):
        return [x]
    if not isinstance(x, (list, tuple)):
        raise MXNetError("%s must be an NDArray or a list of them" % kind)
    return list(x)


def _head_pairs(heads, head_grads):
    heads = _as_list(heads, "heads")
    if head_grads is None:
        head_grads = [None] * len(heads)
    else:
        head_grads = _as_list(head_grads, "head_grads")
    if len(heads) != len(head_grads):
        raise MXNetError("heads and head_grads must match in length")
    outs, seeds = [], []
    for h, g in zip(heads, head_grads):
        if not h._data.requires_grad:
            continue
        outs.append(h._data)
        seeds.append(torch.ones_like(h._data) if g is None
                     else g._data.to(h._data.device, h._data.dtype))
    return outs, seeds


def _marked_leaves(tensors):
    """The marked arrays reachable from ``tensors`` through their
    ``grad_fn`` graphs: [(leaf tensor, NDArray)]."""
    found = {}

    def take(t):
        ref = getattr(t, "_mx_variable", None)
        arr = ref() if ref is not None else None
        if arr is not None and arr._data is t and arr._grad_req != "null":
            found[id(t)] = (t, arr)

    stack, seen = [], set()
    for t in tensors:
        if t.grad_fn is None:
            take(t)
        else:
            stack.append(t.grad_fn)
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            take(var)
        stack.extend(nxt for nxt, _ in fn.next_functions if nxt is not None)
    return list(found.values())


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):  # pylint: disable=redefined-outer-name
    """Gradients of the heads into the marked variables' ``.grad`` per
    their ``grad_req`` (reference: autograd.py:243 → Imperative::Backward,
    imperative.cc:361). ``train_mode`` is accepted for API parity: torch's
    backward re-runs no forward. Under ``MXNET_HEALTH`` the loss heads are
    checked after the gradients are applied (observability.health;
    backward cannot withhold an update, so ``skip_step`` is left to the
    update site's own check)."""
    from .observability import health
    from .observability.tracing import trace_span

    with trace_span("autograd.backward", "autograd"):
        _backward_impl(heads, head_grads, retain_graph)
    if health.active():
        if not isinstance(heads, (list, tuple)):
            heads = [heads]
        health.guard_step(
            "autograd.backward",
            losses=[("head%d" % i, h) for i, h in enumerate(heads)],
            step=health.next_step("autograd.backward"), can_skip=False)


def _backward_impl(heads, head_grads, retain_graph):
    outs, seeds = _head_pairs(heads, head_grads)
    leaves = _marked_leaves(outs)
    if not outs or not leaves:
        raise MXNetError(
            "cannot differentiate: no recorded computation reaches a marked "
            "variable from the heads (did you attach_grad and run inside "
            "autograd.record()?)")
    grads = torch.autograd.grad(outs, [t for t, _ in leaves], seeds,
                                retain_graph=bool(retain_graph),
                                allow_unused=True)
    with torch.no_grad():
        for (_t, arr), g in zip(leaves, grads):
            if g is None or arr._grad is None:
                continue
            if g.is_sparse or arr._grad.stype != "default":
                _write_sparse_grad(arr, g)
                continue
            buf = arr._grad._data
            if arr._grad_req == "add":
                buf.add_(g.to(buf.dtype))
            else:
                buf.copy_(g)


def _write_sparse_grad(arr, g):
    """Write a gradient where a side is sparse (reference: the row-sparse
    cotangent of SparseEmbedding, indexing_op.cc): a sparse COO gradient
    into a RowSparseNDArray buffer collapses to its sorted unique rows
    (``"add"`` merges through ``rsp_add``), into a dense buffer it
    densifies; a dense gradient into a sparse buffer goes through
    ``cast_storage``, which keeps every row with a nonzero."""
    from .ndarray.ndarray import _wrap
    from .ndarray.sparse import (RowSparseNDArray, cast_storage,
                                 coo_to_dense, coo_to_rsp, rsp_add)

    buf, add = arr._grad, arr._grad_req == "add"
    if g.is_sparse and isinstance(buf, RowSparseNDArray):
        rsp = coo_to_rsp(g).astype(buf._data.dtype)
        (rsp_add(buf, rsp) if add else rsp).copyto(buf)
        return
    dense = coo_to_dense(g) if g.is_sparse else g
    if buf.stype == "default":
        if add:
            buf._data.add_(dense.to(buf._data.dtype))
        else:
            buf._data.copy_(dense)
        return
    dense = dense.to(buf._data.dtype)
    if add:
        dense = dense + buf._dense()
    cast_storage(_wrap(dense), buf.stype).copyto(buf)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):  # pylint: disable=redefined-outer-name
    """Gradients of heads with respect to variables, returned as new
    arrays; the variables' ``.grad`` buffers are left alone (reference:
    autograd.py:270). With ``create_graph=True`` the returned gradients are
    recorded and can be differentiated again."""
    from .ndarray.ndarray import _wrap

    variables = _as_list(variables, "variables")
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("autograd.grad: a variable does not require "
                             "grad; call attach_grad() on it before "
                             "recording")
    outs, seeds = _head_pairs(heads, head_grads)
    if not outs:
        raise MXNetError("cannot differentiate: no head was recorded")
    retain = create_graph if retain_graph is None else retain_graph
    gs = torch.autograd.grad(outs, [v._data for v in variables], seeds,
                             retain_graph=bool(retain),
                             create_graph=bool(create_graph),
                             allow_unused=True)
    from .ndarray.sparse import coo_to_dense

    return [_wrap(torch.zeros_like(v._data) if g is None else
                  coo_to_dense(g) if g.is_sparse else g)
            for g, v in zip(gs, variables)]


class _FunctionNode(torch.autograd.Function):
    """Bridges a user :class:`Function` into torch's graph."""

    @staticmethod
    def forward(ctx, fn, inputs, *tensors):
        with pause():
            outputs = fn.forward(*inputs)
        ctx.fn = fn
        ctx.n_in = len(inputs)
        fn._ret_tuple = isinstance(outputs, tuple)
        outs = outputs if fn._ret_tuple else (outputs,)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray, _wrap

        with pause():
            igrads = ctx.fn.backward(*[_wrap(g) for g in out_grads])
        if not isinstance(igrads, tuple):
            igrads = (igrads,)
        if len(igrads) != ctx.n_in:
            raise MXNetError(
                "%s.backward must return %d input grads, got %d"
                % (type(ctx.fn).__name__, ctx.n_in, len(igrads)))
        return (None, None) + tuple(
            g._data if isinstance(g, NDArray) else g for g in igrads)


class Function:
    """User-defined differentiable function (reference: autograd.py:364
    Function, c_api_function.cc).

    Subclass with ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)``; both run with autograd paused, and
    under :func:`record` the pair is one node of the graph whose backward
    is the user's."""

    def forward(self, *inputs):
        raise NotImplementedError()

    def backward(self, *output_grads):
        raise NotImplementedError()

    def save_for_backward(self, *arrays):
        self.saved_tensors = arrays

    def __call__(self, *inputs):
        from .ndarray.ndarray import _wrap

        if not is_recording():
            with pause():
                return self.forward(*inputs)
        outs = _FunctionNode.apply(self, inputs,
                                   *[x._data for x in inputs])
        wrapped = tuple(_wrap(o) for o in outs)
        return wrapped if self._ret_tuple else wrapped[0]


def get_symbol(x):
    raise NotImplementedError("autograd.get_symbol is not supported: the "
                              "port records torch graphs, not symbols")

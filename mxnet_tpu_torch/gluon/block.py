"""Block / HybridBlock / SymbolBlock (reference: gluon/block.py).

Counterpart of ``mxnet_tpu/gluon/block.py``. ``HybridBlock.hybridize()``
traces ``hybrid_forward`` with Symbols once per block (nested list inputs
flattened to one variable per leaf, ``_flatten`` / ``_regroup``) into one
``executor._GraphProgram``: one walk of the graph per call, its outputs and
its aux-state updates (BatchNorm's moving statistics) from the same walk,
as the JAX package's cached program returns them. As there, the program is
bare: no bind-time graph pass (``fuse`` included) runs on it. Under
``autograd.record()`` the walk runs with grad enabled, so the recorded
graph reaches the parameters' marked tensors. ``infer_shape`` finishes
deferred initialization through ``Symbol.infer_shape_partial``.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from .. import ndarray as nd
from .. import symbol as sym_mod
from ..executor import _GraphProgram
from ..observability.tracing import trace_span
from ..ndarray import NDArray
from ..ndarray.ndarray import _from_data
from ..symbol import Symbol
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_naming = threading.local()


class _BlockScope:
    """Name and parameter scoping (reference: block.py _BlockScope)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """The prefix and ParameterDict of a new Block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                if not hasattr(_naming, "counter"):
                    _naming.counter = {}
                count = _naming.counter.get(hint, 0)
                _naming.counter[hint] = count + 1
                prefix = "%s%d_" % (hint, count)
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            ordinal = current._counter.get(hint, 0)
            current._counter[hint] = ordinal + 1
            prefix = "%s%d_" % (hint, ordinal)
        if params is not None:
            params = ParameterDict(params.prefix, params)
        else:
            enclosing = current._block.params
            params = ParameterDict(enclosing.prefix + prefix,
                                   enclosing._shared)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block:
    """Base building block (reference: block.py:121)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []
        self._reg_params = {}

    def __repr__(self):
        body = "\n".join(
            "  (%s): %s" % (attr, repr(child).replace("\n", "\n  "))
            for attr, child in self.__dict__.items()
            if isinstance(child, Block))
        return "%s(\n%s\n)" % (type(self).__name__, body)

    def __setattr__(self, name, value):
        """Register parameters and child blocks."""
        existing = getattr(self, name, None)
        if isinstance(existing, (Parameter, Block)) and \
                not isinstance(value, type(existing)):
            raise TypeError(
                "Changing attribute type for %s from %s to %s is not "
                "allowed." % (name, type(existing), type(value)))
        if isinstance(existing, Block):
            self._children = [value if c is existing else c
                              for c in self._children]
        elif isinstance(value, Block):
            self.register_child(value)
        if isinstance(value, Parameter):
            if name in self._reg_params and \
                    self._reg_params[name] is not value:
                raise AssertionError(
                    "Overriding Parameter attribute %s is not allowed."
                    % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        """This Block's own Parameters (not its children's)."""
        return self._params

    def collect_params(self, select=None):
        """Every Parameter of this Block and its children, optionally
        those whose name matches the regex ``select``."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children:
            ret.update(cld.collect_params(select=select))
        return ret

    def save_params(self, filename):
        """Write every parameter, this block's prefix stripped."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Inverse of :meth:`save_params` (restores this block's
        prefix)."""
        self.collect_params().load(filename, ctx,
                                   allow_missing=allow_missing,
                                   ignore_extra=ignore_extra,
                                   restore_prefix=self.prefix)

    def register_child(self, block):
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from ..initializer import Uniform

        self.collect_params().initialize(init or Uniform(), ctx, verbose,
                                         force_reinit)

    def hybridize(self, active=True):
        """Switch the HybridBlocks below to cached-graph execution."""
        for child in self._children:
            child.hybridize(active)

    def cast(self, dtype):
        """Cast every parameter (children first)."""
        for child in self._children:
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block with one forward for NDArrays and Symbols (reference:
    block.py:319)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._cached_graph = ()
        self._cached_op = None
        self._active = False

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s. If you are using Sequential, please try "
                "HybridSequential instead." % (str(block), str(type(block))))
        super().register_child(block)
        self._clear_cached_op()

    def hybridize(self, active=True):
        self._active = active
        self._clear_cached_op()
        super().hybridize(active)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_op = None

    def _get_graph(self, *args):
        """``hybrid_forward`` traced with Symbols: one variable per
        (flattened) input."""
        if not self._cached_graph:
            flat_args, self._in_format = _flatten(list(args))
            inputs = [sym_mod.Variable("data%d" % i)
                      for i in range(len(flat_args))]
            grouped = _regroup(iter(inputs), self._in_format)
            params = {i: j.var() for i, j in self._reg_params.items()}
            with self.name_scope():
                out = self.hybrid_forward(sym_mod, *grouped, **params)
            if isinstance(out, (list, tuple)):
                out = _flatten_syms(out)
            self._cached_graph = inputs, out
        return self._cached_graph

    def infer_shape(self, *args):
        """Set the unknown Parameter shapes from a sample input."""
        inputs, out = self._get_graph(*args)
        args, _ = _flatten(list(args))
        arg_shapes, _, aux_shapes = out.infer_shape_partial(
            **{i.name: j.shape for i, j in zip(inputs, args)})
        sdict = dict(zip(out.list_arguments(), arg_shapes))
        sdict.update(zip(out.list_auxiliary_states(), aux_shapes))
        for name, param in self.collect_params().items():
            if name in sdict and sdict[name] is not None:
                param.shape = sdict[name]

    def _deferred_infer_shape(self, *args):
        try:
            self.infer_shape(*args)
        except Exception as e:
            raise ValueError(
                "Deferred initialization failed because shape cannot be "
                "inferred: %s" % e)

    def _finish_deferred(self, params, *args):
        self._deferred_infer_shape(*args)
        for param in params:
            param._finish_deferred_init()

    def _build_cache(self, *args):
        inputs, out = self._get_graph(*args)
        prog = _GraphProgram(out)
        input_names = [i.name for i in inputs]
        params = self.collect_params()
        plan = [("input", input_names.index(name)) if name in input_names
                else ("param", params[name]) for name in prog.arg_names]
        aux_params = [params[name] for name in prog.aux_names]
        self._cached_op = (prog, plan, aux_params)

    def _call_cached_op(self, *args):
        """One walk of the cached program: the outputs, and (in train
        mode) the aux states written from the same walk."""
        if self._cached_op is None:
            self._build_cache(*args)
        prog, plan, aux_params = self._cached_op
        flat_args, _ = _flatten(list(args))
        ctx = flat_args[0].context
        arg_d = {name: (flat_args[v] if kind == "input"
                        else v.data(ctx))._data
                 for name, (kind, v) in zip(prog.arg_names, plan)}
        aux_d = {name: p.data(ctx)._data
                 for name, p in zip(prog.aux_names, aux_params)}
        is_train = autograd.is_training()
        with trace_span("cached_op", "gluon"), \
                torch.set_grad_enabled(autograd.is_recording()):
            outs, aux_upd = prog._eval(arg_d, aux_d, is_train)
        if is_train:
            with torch.no_grad():
                for name, p in zip(prog.aux_names, aux_params):
                    if name in aux_upd:
                        for arr in p._data.values():
                            arr._set_data(aux_upd[name].detach())
        outs = [_from_data(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def forward(self, x, *args):
        """NDArray input: the cached program when hybridized, else
        ``hybrid_forward`` with ``mx.nd``; Symbol input: the graph."""
        if isinstance(x, NDArray):
            if self._active:
                try:
                    return self._call_cached_op(x, *args)
                except DeferredInitializationError:
                    self._finish_deferred(
                        self.collect_params().values(), x, *args)
                    return self._call_cached_op(x, *args)
            ctx = x.context
            try:
                params = {i: j.data(ctx) for i, j in self._reg_params.items()}
            except DeferredInitializationError:
                self._finish_deferred(self._reg_params.values(), x, *args)
                params = {i: j.data(ctx) for i, j in self._reg_params.items()}
            return self.hybrid_forward(nd, x, *args, **params)
        assert isinstance(x, Symbol), \
            "HybridBlock requires the first argument to forward be either " \
            "Symbol or NDArray, but got %s" % type(x)
        params = {i: j.var() for i, j in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(sym_mod, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """Override: the forward with ``F`` = ``mx.nd`` or ``mx.sym``."""
        raise NotImplementedError


def _flatten(args):
    """Nested lists of arrays -> (flat list, format)."""
    flat, fmts = [], []
    for a in args:
        if isinstance(a, (list, tuple)):
            f, fmt = _flatten(list(a))
            flat.extend(f)
            fmts.append(fmt)
        else:
            flat.append(a)
            fmts.append(0)
    return flat, fmts


def _regroup(flat_iter, fmts):
    """Inverse of :func:`_flatten`."""
    out = []
    for fmt in fmts:
        out.append(next(flat_iter) if fmt == 0
                   else _regroup(flat_iter, fmt))
    return out


def _flatten_syms(out):
    flat, _ = _flatten(list(out) if isinstance(out, (list, tuple))
                       else [out])
    return sym_mod.Group(flat) if len(flat) > 1 else flat[0]


class SymbolBlock(HybridBlock):
    """An existing Symbol as a Block (reference: block.py:537): its
    arguments that are not inputs become Parameters, its aux states
    Parameters without gradient."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, Symbol) and len(inputs.list_outputs()) == 1:
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(list(outputs))
        syms, _ = _flatten(list(inputs))
        input_names = set()
        for i in syms:
            assert len(i.get_internals().list_outputs()) == 1, \
                "Input symbols must be variable, but %s is an output of " \
                "operators" % str(i)
            input_names.add(i.name)
        for i in outputs.list_arguments():
            if i not in input_names:
                self.params.get(i, allow_deferred_init=True)
        for i in outputs.list_auxiliary_states():
            if i not in input_names:
                self.params.get(i, grad_req="null", allow_deferred_init=True)
        self._cached_graph = syms, outputs

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            try:
                return self._call_cached_op(x, *args)
            except DeferredInitializationError:
                self._finish_deferred(self.collect_params().values(), x,
                                      *args)
                return self._call_cached_op(x, *args)
        assert isinstance(x, Symbol), \
            "HybridBlock requires the first argument to forward be either " \
            "Symbol or NDArray, but got %s" % type(x)
        input_names = [i.name for i in self._cached_graph[0]]
        return self._cached_graph[1](**dict(zip(input_names,
                                                [x] + list(args))))

    def _clear_cached_op(self):
        tmp = self._cached_graph
        super()._clear_cached_op()
        self._cached_graph = tmp

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

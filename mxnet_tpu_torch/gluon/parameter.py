"""Parameter and ParameterDict: trainable state with deferred shapes.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference:
gluon/parameter.py): the deferred-initialization contract (a shape may
hold 0s until the first forward infers it), ``grad_req``, the per-context
replicas (``data`` / ``list_data`` / ``grad`` / ``list_grad``), ``cast``,
``set_data``, ``zero_grad``, and ``ParameterDict`` with ``get``,
``initialize`` and ``save`` / ``load`` in the reference ``.params`` format.

Values are initialised on the host with numpy (the initializers draw from
``np.random``, as the JAX package's do, so a seed gives both packages the
same weights) and copied to each context. Each replica's tensor is a
marked autograd variable with a gradient buffer beside it (see
:mod:`..autograd`); optimizer updates write into it in place, so its
address stays fixed (a captured training step reads it).
"""
from __future__ import annotations

import warnings

import numpy as np

from .. import autograd
from .. import initializer as init_mod
from .. import ndarray as nd
from ..base import MXNetError
from ..context import Context, as_device, cpu, current_context
from ..initializer import InitDesc
from ..ndarray.ndarray import NDArray
from ..symbol import Symbol

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "tensor_types"]

tensor_types = (Symbol, NDArray)


class DeferredInitializationError(MXNetError):
    """Raised when touching a parameter whose init is still deferred."""


def default_context():
    """Where a parameter goes when the caller names no context: the
    innermost ``with`` scope, else the card (raises where there is
    none)."""
    return Context.from_device(as_device(None))


def _ctx_list(ctx, fallback=None):
    if ctx is None:
        return fallback
    if isinstance(ctx, Context):
        return [ctx]
    return list(ctx)


def _merge_shapes(declared, incoming):
    """Reconcile two shapes where 0 means unknown; None if incompatible."""
    if incoming is None or len(incoming) != len(declared):
        return None
    merged = []
    for a, b in zip(incoming, declared):
        if a != b and a * b != 0:
            return None
        merged.append(b if a == 0 else a)
    return tuple(merged)


class Parameter:
    """One named tensor with an optional gradient, replicated per
    context."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._var = None
        self._data = None
        self._grad = None
        self._ctx_list = None
        self._deferred_init = ()
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._grad_req = None
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req
        self.init = init
        # sparse storage is held dense, as in the JAX package
        self._stype = stype

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    # --- grad_req ------------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise AssertionError(
                "grad_req must be one of 'write', 'add', or 'null', but got "
                "'%s'" % req)
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null" and self._grad is not None:
            self._grad = None
            for arr in self._data.values():
                autograd.mark_variables([arr], [None], "null")
        elif self._data is not None:
            self._init_grad()

    # --- accessors -----------------------------------------------------------
    def _uninitialized_error(self):
        if self._deferred_init:
            return DeferredInitializationError(
                "Parameter %s has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass. Please pass one batch of "
                "data through the network before accessing Parameters."
                % self.name)
        return RuntimeError(
            "Parameter %s has not been initialized. Note that you should "
            "initialize parameters and create Trainer with "
            "Block.collect_params() instead of Block.params because the "
            "later does not include Parameters of nested child Blocks"
            % self.name)

    def _fetch(self, table, ctx):
        """One replica (all of them when ``ctx`` is ``list``)."""
        if table is None:
            raise self._uninitialized_error()
        if ctx is list:
            return list(table.values())
        if ctx is None:
            if len(table) == 1:
                return next(iter(table.values()))
            ctx = current_context()
        if ctx in table:
            return table[ctx]
        for c, arr in table.items():   # same device type, any id
            if c.device_type == ctx.device_type:
                return arr
        raise RuntimeError(
            "Parameter %s was not initialized on context %s. It was only "
            "initialized on %s." % (self.name, str(ctx),
                                    str(list(table.keys()))))

    def data(self, ctx=None):
        return self._fetch(self._data, ctx)

    def list_data(self):
        return self._fetch(self._data, list)

    def _grad_table(self):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter %s because "
                "grad_req='null'" % self.name)
        return self._grad

    def grad(self, ctx=None):
        return self._fetch(self._grad_table(), ctx)

    def list_grad(self):
        return self._fetch(self._grad_table(), list)

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise RuntimeError("Parameter %s has not been initialized"
                               % self.name)
        return self._ctx_list

    # --- initialization ------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Materialise (or defer) the parameter on the given contexts."""
        default_init = default_init or init_mod.Uniform()
        if self._data is not None and not force_reinit:
            warnings.warn("Parameter %s is already initialized, ignoring. "
                          "Set force_reinit=True to re-initialize."
                          % self.name, stacklevel=2)
            return
        self._data = self._grad = None
        ctx = _ctx_list(ctx) or [default_context()]
        chosen = init if init is not None else (self.init or default_init)
        self._deferred_init = (chosen, ctx, default_init, None)
        if self.shape is None or np.prod(self.shape) <= 0:
            if not self._allow_deferred_init:
                raise ValueError(
                    "Cannot initialize Parameter %s because it has invalid "
                    "shape: %s." % (self.name, str(self.shape)))
            return
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        """Run the stored init once the shape is fully known."""
        if not self._deferred_init:
            return
        chosen, ctx, default_init, data = self._deferred_init
        self._deferred_init = ()
        if isinstance(chosen, str):
            chosen = init_mod.create(chosen)
        if isinstance(default_init, str):
            default_init = init_mod.create(default_init)
        if self.shape is None or np.prod(self.shape) <= 0:
            raise AssertionError(
                "Cannot initialize Parameter %s because it has invalid "
                "shape: %s. Please specify in_units, in_channels, etc for "
                "`Block`s." % (self.name, str(self.shape)))
        with autograd.pause():
            if data is None:
                data = np.zeros(self.shape, dtype=self.dtype)
                (chosen if chosen is not None else default_init)(
                    InitDesc(self.name, {"__init__": ""}), data)
            self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        """Place ``data`` (numpy or an NDArray) on every context and build
        the gradient buffers."""
        self._ctx_list = list(ctx_list)
        self._data = {c: nd.array(data, ctx=c, dtype=self.dtype)
                      for c in self._ctx_list}
        self.shape = tuple(next(iter(self._data.values())).shape)
        self._init_grad()

    def _init_grad(self):
        if self.grad_req == "null":
            self._grad = None
            return
        self._grad = {c: nd.zeros(self.shape, ctx=c, dtype=self.dtype)
                      for c in self._ctx_list}
        for c in self._ctx_list:
            autograd.mark_variables([self._data[c]], [self._grad[c]],
                                    self.grad_req)

    def _load_init(self, data, ctx):
        """Initialize from a loaded array, checking shape and contexts."""
        if self.shape:
            for mine, theirs in zip(self.shape, data.shape):
                if mine not in (0, theirs):
                    raise AssertionError(
                        "Failed loading Parameter %s from saved params: "
                        "shape incompatible expacted %s vs saved %s"
                        % (self.name, str(self.shape), str(data.shape)))
        ctx = _ctx_list(ctx)
        if self._data is not None:
            if ctx is not None and set(ctx) != set(self.list_ctx()):
                raise AssertionError(
                    "Failed to load Parameter %s on %s because it was "
                    "previous initialized on %s."
                    % (self.name, str(ctx), str(self.list_ctx())))
            self.set_data(data)
        else:
            if self._deferred_init:
                deferred_ctx = self._deferred_init[1]
                if ctx is not None and set(ctx) != set(deferred_ctx):
                    raise AssertionError(
                        "Failed to load Parameter %s on %s because it was "
                        "previous initialized on %s."
                        % (self.name, str(ctx), str(self.list_ctx())))
                ctx = deferred_ctx
            elif ctx is None:
                ctx = [default_context()]
            self._init_impl(data, ctx)
        self._deferred_init = ()

    # --- mutation ------------------------------------------------------------
    def _reduce(self):
        """One host copy, averaged across replicas."""
        replicas = self.list_data()
        host = [r.as_in_context(cpu()) for r in replicas]
        if len(host) == 1:
            return host[0].copy()
        return sum(host[1:], host[0]) / len(host)

    def reset_ctx(self, ctx):
        """Move the parameter to a new context list."""
        ctx = _ctx_list(ctx) or [default_context()]
        if self._data:
            merged = self._reduce()
            with autograd.pause():
                self._init_impl(merged, ctx)
        elif self._deferred_init:
            chosen, _old, default_init, data = self._deferred_init
            self._deferred_init = (chosen, ctx, default_init, data)
        else:
            raise ValueError("Cannot reset context for Parameter %s because "
                             "it has not been initialized." % self.name)

    def set_data(self, data):
        """Write ``data`` into every replica, in place."""
        if self._data is None:
            raise AssertionError("Parameter %s has not been initialized"
                                 % self.name)
        if not isinstance(data, NDArray):
            data = nd.array(np.asarray(data), ctx=cpu(), dtype=self.dtype)
        for arr in self._data.values():
            arr._set_data(data._data)

    def zero_grad(self):
        if self._grad is None:
            return
        for g in self._grad.values():
            g._data.zero_()

    def cast(self, dtype):
        """Change the dtype in place (replicas and gradients re-made)."""
        self.dtype = dtype
        if self._data is None:
            return
        with autograd.pause():
            self._data = {c: v.astype(dtype) for c, v in self._data.items()}
            if self._grad is not None:
                self._grad = {c: v.astype(dtype)
                              for c, v in self._grad.items()}
                for c in self._ctx_list:
                    autograd.mark_variables([self._data[c]], [self._grad[c]],
                                            self.grad_req)

    def var(self):
        """The Symbol standing for this parameter in hybrid traces."""
        from .. import symbol as sym

        if self._var is None:
            self._var = sym.Variable(self.name, shape=self.shape,
                                     lr_mult=self.lr_mult,
                                     wd_mult=self.wd_mult)
        return self._var


class ParameterDict:
    """Insertion-ordered, prefix-scoped mapping of Parameters with an
    optional fallthrough to a shared dict."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    def __repr__(self):
        head = self._prefix + " " if self._prefix else ""
        body = "\n".join(repr(p).replace("\n", "\n  ")
                         for p in self.values())
        return "%s(\n%s\n)" % (head, body)

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _find(self, name):
        """Local lookup, then the shared dict (cached locally on a hit)."""
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            borrowed = self._shared._params[name]
            self._params[name] = borrowed
            return borrowed
        return None

    def get(self, name, **kwargs):
        """Fetch or create ``prefix + name``, reconciling attributes."""
        name = self.prefix + name
        param = self._find(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for attr, wanted in kwargs.items():
            stored = getattr(param, attr, None)
            if stored is None:
                setattr(param, attr, wanted)
                continue
            if attr == "shape" and wanted is not None:
                merged = _merge_shapes(stored, wanted)
                if merged is not None:
                    param.shape = merged
                    continue
            if wanted is not None and wanted != stored:
                raise AssertionError(
                    "Cannot retrieve Parameter %s because desired attribute "
                    "does not match with stored for attribute %s: desired "
                    "%s vs stored %s." % (name, attr, str(wanted),
                                          str(stored)))
        return param

    def update(self, other):
        """Merge another dict; same-name entries must be the same object."""
        for name, param in other.items():
            mine = self._params.get(name)
            if mine is None:
                self._params[name] = param
            elif mine is not param:
                raise AssertionError(
                    "Cannot update self with other because they have "
                    "different Parameters with the same name %s" % name)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter (``init`` overrides their own)."""
        if init is not None and not (isinstance(init, str)
                                     or callable(init)):
            raise TypeError("init must be an Initializer, callable or None")
        if isinstance(init, str):
            init = init_mod.create(init)
        if verbose and init is not None:
            init.set_verbosity(verbose=verbose)
        fallback = init if init is not None else init_mod.Uniform()
        for p in self.values():
            p.initialize(None, ctx, fallback, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Write the replicas' average; names lose ``strip_prefix``."""
        blobs = {}
        for p in self.values():
            if not p.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix %s is to be striped before saving, but "
                    "Parameter %s does not start with %s."
                    % (strip_prefix, p.name, strip_prefix))
            blobs[p.name[len(strip_prefix):]] = p._reduce()
        nd.save(filename, blobs)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Inverse of :meth:`save`; reads ``arg:`` / ``aux:`` Module
        checkpoints too."""
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise AssertionError(
                        "restore_prefix is %s but Parameters name %s does "
                        "not start with %s" % (restore_prefix, name,
                                               restore_prefix))
        cut = len(restore_prefix)

        def renamed(key):
            stripped = (key.split(":", 1)[-1]
                        if key.startswith(("arg:", "aux:")) else key)
            return restore_prefix + stripped

        table = {renamed(k): v for k, v in nd.load(filename).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in table:
                    raise AssertionError(
                        "Parameter %s is missing in file %s"
                        % (name[cut:], filename))
        for name, value in table.items():
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter %s loaded from file %s is not present in "
                        "ParameterDict" % (name[cut:], filename))
                continue
            self[name]._load_init(value, ctx)

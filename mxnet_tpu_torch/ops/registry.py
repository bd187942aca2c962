"""The operator registry — one registry behind ``mx.sym``.

Counterpart of ``mxnet_tpu/ops/registry.py``. An op registers its name, its
parameter ``Field`` dict (param.py), a forward written as a plain function
on ``torch.Tensor`` inputs, optional shape/dtype inference for symbolic
partial inference, and is_train / aux-state flags. The symbol frontend is
generated from this registry (symbol/register.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .param import parse_params, params_to_str_dict

__all__ = ["OpDef", "OpAttrs", "register_op", "get_op", "list_ops",
           "alias_op", "OP_REGISTRY"]

OP_REGISTRY = {}


class OpAttrs:
    """Parsed, hashable op attributes with attribute access."""

    __slots__ = ("_d", "key")

    def __init__(self, d):
        self._d = d
        self.key = tuple(sorted(d.items(), key=lambda kv: kv[0]))

    def __getattr__(self, k):
        try:
            return self._d[k]
        except KeyError:
            raise AttributeError(k)

    def __getitem__(self, k):
        return self._d[k]

    def get(self, k, default=None):
        return self._d.get(k, default)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, OpAttrs) and self.key == other.key

    def __repr__(self):
        return "OpAttrs(%r)" % (self._d,)


def _resolve(v, attrs):
    return v(attrs) if callable(v) else v


class OpDef:
    """One registered operator."""

    def __init__(self, name, fn, params=None, num_inputs=1, input_names=None,
                 num_outputs=1, aux_names=(), infer_shape=None,
                 infer_backward=None, infer_dtype=None, needs_rng=False,
                 needs_is_train=False, hint=None, doc=""):
        self.name = name
        self.fn = fn
        self.params = params or {}
        self.num_inputs = num_inputs
        self._input_names = input_names
        self.num_outputs = num_outputs
        self.aux_names = aux_names
        self.infer_shape = infer_shape
        # optional backward shape flow: (attrs, out_shapes, in_shapes) ->
        # updated in_shapes (FullyConnected assigns batch from its output)
        self.infer_backward = infer_backward
        self.infer_dtype = infer_dtype
        # a random op takes ``rng``: a torch.Generator, or None for the
        # device's own (mx.random); the fold pass never folds it
        self.needs_rng = needs_rng
        self.needs_is_train = needs_is_train
        self.hint = hint or name.strip("_").lower()
        self.doc = doc

    # --- attr handling ---------------------------------------------------
    def parse_attrs(self, kwargs):
        return OpAttrs(parse_params(self.params, kwargs, self.name))

    def bind_positional_params(self, args, attr_kwargs, tensor_type):
        """Bind trailing non-tensor positional args (``sym.clip(x, 0, 1)``)
        to declared params in registration order; returns the leading
        tensor args. ``attr_kwargs`` is mutated."""
        tensors = list(args)
        trailing = []
        while tensors and not isinstance(tensors[-1], tensor_type):
            trailing.append(tensors.pop())
        trailing.reverse()
        for value in trailing:
            if isinstance(value, np.ndarray) and value.ndim > 0 or \
                    isinstance(value, (list, tuple)) and any(
                        isinstance(e, tensor_type)
                        or (isinstance(e, np.ndarray) and e.ndim > 0)
                        for e in value):
                raise MXNetError(
                    "%s: positional argument %r looks like tensor data; "
                    "only scalar/shape parameters may follow the input "
                    "tensors" % (self.name, type(value)))
        if trailing:
            names = [k for k in self.params if k != "num_args"]
            if len(trailing) > len(names):
                raise MXNetError(
                    "%s: %d positional parameter(s) given but the op "
                    "declares only %s" % (self.name, len(trailing), names))
            for value, key in zip(trailing, names):
                if key in attr_kwargs:
                    raise MXNetError("%s: got multiple values for parameter "
                                     "%r" % (self.name, key))
                attr_kwargs[key] = value
        return tensors

    def attrs_to_str_dict(self, attrs):
        return params_to_str_dict(self.params, attrs._d)

    def get_num_inputs(self, attrs):
        return _resolve(self.num_inputs, attrs)

    def get_num_outputs(self, attrs):
        return _resolve(self.num_outputs, attrs)

    def get_input_names(self, attrs):
        if self._input_names is None:
            n = self.get_num_inputs(attrs)
            return ["data"] if n == 1 else ["data%d" % i for i in range(n)]
        return list(_resolve(self._input_names, attrs))

    def get_aux_names(self, attrs):
        return list(_resolve(self.aux_names, attrs))

    # --- execution -------------------------------------------------------
    def apply(self, attrs, inputs, aux=(), is_train=False, rng=None):
        """Normalized call on tensors: returns (outputs_tuple, new_aux_tuple).
        The single entry point of the graph executor, the fold pass and
        the fused-region reference composition."""
        kw = {"is_train": is_train} if self.needs_is_train else {}
        if self.needs_rng:
            kw["rng"] = rng
        if self.get_aux_names(attrs):
            outputs, new_aux = self.fn(attrs, *inputs, aux=tuple(aux), **kw)
        else:
            outputs = self.fn(attrs, *inputs, **kw)
            new_aux = tuple(aux)
        if not isinstance(outputs, (tuple, list)):
            outputs = (outputs,)
        return tuple(outputs), tuple(new_aux)

    # --- inference -------------------------------------------------------
    def default_infer_shape(self, attrs, in_shapes, aux_shapes):
        """Shape inference by running the forward on ``meta`` tensors (no
        storage, no compute) when every input shape is known; ops that
        backfill unbound weight shapes register ``infer_shape`` instead."""
        if any(s is None for s in in_shapes) or \
                any(s is None for s in aux_shapes):
            return None
        ins = [torch.empty(s, device="meta") for s in in_shapes]
        auxs = [torch.empty(s, device="meta") for s in aux_shapes]
        outs, new_aux = self.apply(attrs, ins, auxs)
        return (list(in_shapes), [tuple(o.shape) for o in outs],
                [tuple(a.shape) for a in new_aux] if aux_shapes
                else list(aux_shapes))

    def run_infer_shape(self, attrs, in_shapes, aux_shapes=()):
        in_shapes = list(in_shapes)
        aux_shapes = list(aux_shapes)
        if self.infer_shape is not None:
            res = self.infer_shape(attrs, in_shapes, aux_shapes)
            if res is not None and len(res) == 2:  # (in, out) shorthand
                res = (res[0], res[1], aux_shapes)
            return res
        return self.default_infer_shape(attrs, in_shapes, aux_shapes)

    def run_infer_dtype(self, attrs, in_dtypes, aux_dtypes=()):
        if self.infer_dtype is not None:
            res = self.infer_dtype(attrs, list(in_dtypes), list(aux_dtypes))
            if res is not None and len(res) == 2:
                res = (res[0], res[1], list(aux_dtypes))
            return res
        # default: everything takes the first known input dtype
        known = [d for d in list(in_dtypes) + list(aux_dtypes)
                 if d is not None]
        if not known:
            return None
        d = known[0]
        return ([x if x is not None else d for x in in_dtypes],
                [d] * self.get_num_outputs(attrs),
                [x if x is not None else d for x in aux_dtypes])

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register_op(name, fn=None, **kwargs):
    """Register an operator; usable directly or as a decorator."""

    def _do(f):
        if name in OP_REGISTRY:
            raise MXNetError("op %r already registered" % name)
        opdef = OpDef(name, f, **kwargs)
        OP_REGISTRY[name] = opdef
        return opdef

    return _do(fn) if fn is not None else _do


def get_op(name):
    try:
        return OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("operator %r is not registered" % name)


def list_ops():
    return sorted(OP_REGISTRY)


def alias_op(name, alias):
    """Register an additional name for an existing op."""
    opdef = get_op(name)
    if alias in OP_REGISTRY:
        raise MXNetError("op %r already registered" % alias)
    OP_REGISTRY[alias] = opdef
    return opdef

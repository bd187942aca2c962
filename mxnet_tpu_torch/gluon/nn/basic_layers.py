"""Core Gluon layers: containers, Dense, Activation, Dropout, BatchNorm,
LeakyReLU, Embedding, Flatten, Lambda / HybridLambda.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` (reference:
gluon/nn/basic_layers.py): the same class names, constructor signatures
and child / parameter naming, so parameter names (and ``.params`` files)
match the JAX package's. Each layer's forward is one registered op
(``F.FullyConnected``, ``F.BatchNorm``, ...), through ``mx.nd`` eagerly or
``mx.sym`` when hybridized.
"""
from __future__ import annotations

import numpy as np

from ..block import Block, HybridBlock
from ..utils import _to_initializer as _init

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation", "Dropout",
           "BatchNorm", "LeakyReLU", "Embedding", "Flatten", "Lambda",
           "HybridLambda"]


class _ChainMixin:
    """add()/indexing/repr shared by the two sequential containers."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)

    def __repr__(self):
        body = "\n".join(
            "  (%d): %s" % (i, repr(child).replace("\n", "\n  "))
            for i, child in enumerate(self._children))
        return "%s(\n%s\n)" % (type(self).__name__, body)


class Sequential(_ChainMixin, Block):
    """Imperative container running children in insertion order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        for child in self._children:
            x = child(x)
        return x


class HybridSequential(_ChainMixin, HybridBlock):
    """Hybridizable container running children in insertion order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        for child in self._children:
            x = child(x)
        return x


class _OpLayer(HybridBlock):
    """A parameterless layer applying one registered operator.

    Subclasses set ``_repr_tmpl`` and implement ``_apply(F, x)``.
    """

    _repr_tmpl = "{cls}"

    def hybrid_forward(self, F, x):
        return self._apply(F, x)

    def __repr__(self):
        return self._repr_tmpl.format(cls=type(self).__name__,
                                      **vars(self))


class Activation(_OpLayer):
    """Elementwise activation by name (relu/sigmoid/tanh/softrelu)."""

    _repr_tmpl = "{cls}({_act_type})"

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def _apply(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")


class Dropout(_OpLayer):
    """Zero inputs with probability ``rate`` at train time."""

    _repr_tmpl = "{cls}(p = {_rate})"

    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def _apply(self, F, x):
        return F.Dropout(x, p=self._rate, name="fwd")


class LeakyReLU(_OpLayer):
    """max(x, alpha*x)."""

    _repr_tmpl = "{cls}({_alpha})"

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def _apply(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha, name="fwd")


class Flatten(_OpLayer):
    """Collapse all but the batch axis."""

    def _apply(self, F, x):
        return F.Flatten(x)


class Dense(HybridBlock):
    """y = act(x W^T + b), optionally flattening non-batch axes first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        self._in_units = in_units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), init=_init(bias_initializer),
                allow_deferred_init=True) if use_bias else None
            self.act = (Activation(activation, prefix=activation + "_")
                        if activation is not None else None)

    def hybrid_forward(self, F, x, weight, bias=None):
        fc_kw = dict(num_hidden=self._units, flatten=self._flatten,
                     name="fwd")
        if bias is None:
            out = F.FullyConnected(x, weight, no_bias=True, **fc_kw)
        else:
            out = F.FullyConnected(x, weight, bias, **fc_kw)
        return out if self.act is None else self.act(out)

    def __repr__(self):
        shape = self.weight.shape
        return "%s(%s -> %s, %s)" % (type(self).__name__,
                                     shape[1] if shape[1] else None,
                                     shape[0],
                                     self.act if self.act else "linear")


class BatchNorm(HybridBlock):
    """Batch normalization with running-stat aux state.

    ``scale=False`` freezes gamma at 1; ``center=False`` freezes beta at 0.
    """

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        if in_channels != 0:
            self.in_channels = in_channels

        def channel_param(name, init, trainable):
            return self.params.get(
                name, grad_req="write" if trainable else "null",
                shape=(in_channels,), init=_init(init),
                allow_deferred_init=True, differentiable=trainable)

        self.gamma = channel_param("gamma", gamma_initializer, scale)
        self.beta = channel_param("beta", beta_initializer, center)
        self.running_mean = channel_param("running_mean",
                                          running_mean_initializer, False)
        self.running_var = channel_param("running_var",
                                         running_variance_initializer, False)

    def cast(self, dtype):
        # BN statistics stay in fp32 even under half-precision casts
        if np.dtype(dtype).name == "float16":
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)

    def __repr__(self):
        width = self.gamma.shape[0]
        inner = ", ".join("%s=%r" % kv for kv in self._kwargs.items())
        return "%s(%s, in_channels=%s)" % (type(self).__name__, inner,
                                           width if width else None)


class Embedding(HybridBlock):
    """Integer ids -> learned dense vectors."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim),
            init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)

    def __repr__(self):
        return "{cls}({input_dim} -> {output_dim}, {dtype})".format(
            cls=type(self).__name__, **self._kwargs)


def _resolve_named_func(function, *namespaces):
    """Look up a function by name in the given op namespaces (all must
    provide it); returns the per-namespace mapping."""
    table = {}
    for ns in namespaces:
        if not hasattr(ns, function):
            raise AssertionError(
                "Function name %s is not found in %s."
                % (function, "/".join(n.__name__.split(".")[-1]
                                      for n in namespaces)))
        table[ns] = getattr(ns, function)
    return table


class Lambda(Block):
    """Wrap a free function (or an ndarray op name) as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        from ... import ndarray as nd_mod

        if isinstance(function, str):
            self._func_impl = _resolve_named_func(function, nd_mod)[nd_mod]
            self._func_name = function
        elif callable(function):
            self._func_impl = function
            self._func_name = getattr(function, "__name__", str(function))
        else:
            raise ValueError("Lambda accepts an op name or a callable; got "
                             "%r (%s)" % (function, type(function)))

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._func_name)


class HybridLambda(HybridBlock):
    """Wrap an F-generic function (or op name) as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        from ... import ndarray as nd_mod
        from ... import symbol as sym_mod

        if isinstance(function, str):
            table = _resolve_named_func(function, nd_mod, sym_mod)
            self._func = lambda F, *args: table[F](*args)
            self._func_name = function
        elif callable(function):
            self._func = lambda F, *args: function(F, *args)
            self._func_name = getattr(function, "__name__", str(function))
        else:
            raise ValueError("HybridLambda accepts an op name or a callable; "
                             "got %r (%s)" % (function, type(function)))

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._func_name)

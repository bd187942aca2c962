"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (its own copy: the port imports
nothing of the JAX package). Dispatch on parameter-name patterns
(``_weight`` -> weight init, ``_bias`` -> zero, ...) with ``__init__``
attribute overrides. The fills are numpy on the host with numpy's global
RNG, exactly as in the JAX package, so one ``np.random.seed`` gives the
same bits in both packages; the caller moves the buffer onto the device.
The initializers are those a ``Module`` of this slice uses; ``Orthogonal``,
``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``Load``, ``Mixed`` and
``FusedRNN`` wait for later slices (``ROADMAP.md`` Queue A4).
"""
from __future__ import annotations

import json
import logging
import math

import numpy as np

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Xavier"]

_INIT_REGISTRY = {}


def register(klass):
    """Register an initializer under its lowercased class name
    (reference: initializer.py ``register`` decorator)."""
    name = klass.__name__.lower()
    _INIT_REGISTRY[name] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    if callable(name):
        return name
    key = name.lower()
    if key not in _INIT_REGISTRY:
        raise MXNetError("unknown initializer %r" % name)
    return _INIT_REGISTRY[key](**kwargs)


class InitDesc(str):
    """A parameter name that carries its symbol attrs and the enclosing
    global initializer (so composite inits can delegate)."""

    def __new__(cls, name, attrs=None, global_init=None):
        desc = str.__new__(cls, name)
        desc.attrs = attrs or {}
        desc.global_init = global_init
        return desc


def _ctor_kwargs(local_vars):
    """Everything from a ctor's locals() except self (for dumps)."""
    return {k: v for k, v in local_vars.items()
            if k not in ("self", "__class__")}


class Initializer:
    """Base initializer with the reference's name-pattern dispatch
    (reference: initializer.py:127 ``__call__``)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._print_func = None
        self._verbose = False

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        if print_func is None:
            def asum_stat(x):
                return str((np.abs(x).mean(),))
            print_func = asum_stat
        self._print_func = print_func
        return self

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def _verbose_print(self, desc, init, arr):
        if self._verbose and self._print_func:
            logging.info("Initialized %s as %s: %s", desc, init,
                         self._print_func(arr))

    # suffix -> (handler method name, verbose tag or None); checked in order
    _SUFFIX_DISPATCH = (
        (("weight",), "_init_weight", "weight"),
        (("bias",), "_init_bias", "bias"),
        (("gamma",), "_init_gamma", "gamma"),
        (("beta",), "_init_beta", "beta"),
        (("moving_mean", "running_mean"), "_init_zero", None),
        (("moving_var", "running_var", "moving_inv_var"), "_init_one", None),
        (("moving_avg", "min", "max"), "_init_zero", None),
    )

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        override = desc.attrs.get("__init__", "")
        if override:
            klass, kwargs = json.loads(override)
            create(klass, **kwargs)._init_weight(desc, arr)
            self._verbose_print(desc, override, arr)
            return
        name = desc.lower()
        for suffixes, handler, tag in self._SUFFIX_DISPATCH:
            if name.endswith(suffixes):
                getattr(self, handler)(desc, arr)
                if tag:
                    self._verbose_print(desc, tag, arr)
                return
        self._init_default(desc, arr)

    # numpy-buffer fillers; subclasses override _init_weight ---------------
    def _fill(self, arr, value):
        arr[:] = value

    def _init_zero(self, _, arr):
        self._fill(arr, 0.0)

    def _init_one(self, _, arr):
        self._fill(arr, 1.0)

    def _init_bias(self, _, arr):
        self._fill(arr, 0.0)

    def _init_gamma(self, _, arr):
        self._fill(arr, 1.0)

    def _init_beta(self, _, arr):
        self._fill(arr, 0.0)

    def _init_weight(self, name, arr):
        raise NotImplementedError()

    def _init_default(self, name, _):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization "
            "is now limited to \"weight\", \"bias\", \"gamma\" (1.0), and "
            "\"beta\" (0.0)." % name)

    def __eq__(self, other):
        return (self.__class__ == other.__class__
                and self._kwargs == getattr(other, "_kwargs", None))


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._fill(arr, 0.0)


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._fill(arr, 1.0)


# the reference registers these under both names ("zeros" alias via
# mx.init.Zero.__init__ docstring usage in Gluon layers)
_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._fill(arr, self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale) (reference: initializer.py:Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = np.random.uniform(-self.scale, self.scale, arr.shape)


@register
class Normal(Initializer):
    """N(0, sigma) (reference: initializer.py:Normal)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = np.random.normal(0.0, self.sigma, arr.shape)


@register
class Xavier(Initializer):
    """Xavier/Glorot (reference: initializer.py:Xavier)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(**_ctor_kwargs(locals()))
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(
                "Xavier initializer cannot be applied to vector %s. It "
                "requires at least 2D." % name)
        spatial = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * spatial, shape[0] * spatial
        try:
            factor = {"avg": (fan_in + fan_out) / 2.0,
                      "in": fan_in, "out": fan_out}[self.factor_type]
        except KeyError:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[:] = np.random.uniform(-scale, scale, shape)
        elif self.rnd_type == "gaussian":
            arr[:] = np.random.normal(0.0, scale, shape)
        else:
            raise ValueError("Unknown random type")

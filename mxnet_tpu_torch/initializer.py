"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (its own copy: the port imports
nothing of the JAX package). Dispatch on parameter-name patterns
(``_weight`` -> weight init, ``_bias`` -> zero, ...) with ``__init__``
attribute overrides. The fills are numpy on the host with numpy's global
RNG, exactly as in the JAX package, so one ``np.random.seed`` gives the
same bits in both packages; the caller moves the buffer onto the device.
Every initializer of the JAX package is here but ``FusedRNN``, which
unpacks a fused RNN cell's parameters and raises until the RNN slice
(``ROADMAP.md`` Queue A7).
"""
from __future__ import annotations

import json
import logging
import math
import re

import numpy as np

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "Load", "Mixed"]

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
class Orthogonal(Initializer):
    """Orthogonal matrix init (reference: initializer.py:Orthogonal)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(**_ctor_kwargs(locals()))
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
        if self.rand_type == "uniform":
            tmp = np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * q).reshape(arr.shape)


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


@register
class MSRAPrelu(Xavier):
    """Kaiming/MSRA init (reference: initializer.py:MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernel (reference: initializer.py:Bilinear)."""

    def _init_weight(self, _, arr):
        # separable triangular kernel, computed per axis
        h, w = arr.shape[2], arr.shape[3]
        f = np.ceil(w / 2.0)
        center = (2 * f - 1 - f % 2) / (2.0 * f)
        wx = 1 - np.abs(np.arange(w) / f - center)
        wy = 1 - np.abs(np.arange(h) / f - center)
        arr[:] = np.broadcast_to(np.outer(wy, wx), arr.shape)


@register
class LSTMBias(Initializer):
    """Forget-gate bias init (reference: initializer.py:LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _, arr):
        arr[:] = 0.0
        h = arr.shape[0] // 4
        arr[h:2 * h] = self.forget_bias  # gates are stacked i, f, c, o


@register
class FusedRNN(Initializer):
    """Init for a fused RNN cell's packed parameters (reference:
    initializer.py:FusedRNN). It unpacks them with ``rnn_cell``, which
    the port does not have yet."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        raise MXNetError("initializer.FusedRNN needs rnn_cell.FusedRNNCell, "
                         "which is not yet ported (ROADMAP.md Queue A7)")


class Load:
    """Initialize from an existing param dict (reference:
    initializer.py:Load); names missing from it go to ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {}
        for name, arr in param.items():
            if name.startswith("arg:") or name.startswith("aux:"):
                name = name[4:]
            self.param[name] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            src_np = src.asnumpy() if hasattr(src, "asnumpy") \
                else np.asarray(src)
            if tuple(src_np.shape) != tuple(arr.shape):
                raise AssertionError(
                    "Parameter %s cannot be initialized from loading. Shape "
                    "mismatch, target %s vs loaded %s"
                    % (name, arr.shape, src_np.shape))
            arr[:] = src_np
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise AssertionError(
                    "Cannot Initialize parameter %s. Not found in loaded "
                    "param and no default initializer is provided." % name)
            self.default_init(name, arr)
            if self.verbose:
                logging.info("Initialized %s by default", name)


class Mixed:
    """Pattern to initializer dispatch (reference: initializer.py:Mixed):
    the first pattern that matches the name picks the initializer."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("Mixed: %d patterns for %d initializers"
                             % (len(patterns), len(initializers)))
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            "Parameter name %s did not match any pattern. Consider adding a "
            "\".*\" pattern at the and with default Initializer." % name)

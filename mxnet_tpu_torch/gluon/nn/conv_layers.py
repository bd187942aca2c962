"""Convolution and pooling Gluon layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (reference:
gluon/nn/conv_layers.py): the public classes with their constructor
signatures and parameter naming. Two blocks do the work (``_Conv``,
``_Pooling``); each public class comes from a factory that pins the
dimensionality, layout, operator and pooling kind. Weight shapes come
from partial shape inference through the symbolic op (``Convolution``,
or ``Deconvolution`` for the transposed layers).
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation, _init

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D"]


def _tuple_of(value, ndim):
    return (value,) * ndim if isinstance(value, int) else tuple(value)


class _Conv(HybridBlock):
    """Shared conv/deconv block driving a named symbolic operator."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            ndim = len(kernel_size)
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size,
                "stride": _tuple_of(strides, ndim),
                "dilate": _tuple_of(dilation, ndim),
                "pad": _tuple_of(padding, ndim),
                "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj

            probe = [0] * (ndim + 2)
            probe[layout.find("N")] = 1
            probe[layout.find("C")] = in_channels
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(tuple(probe)),
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=_init(bias_initializer),
                allow_deferred_init=True) if use_bias else None
            self.act = (Activation(activation, prefix=activation + "_")
                        if activation is not None else None)

    def _op_kwargs(self):
        return {k: v for k, v in self._kwargs.items() if k != "layout"}

    def _weight_shape(self, data_shape):
        """Infer the weight shape by tracing the op on a probe input."""
        from ... import symbol as sym_mod
        probe = sym_mod.Variable("data", shape=data_shape)
        traced = getattr(sym_mod, self._op_name)(probe, **self._op_kwargs())
        return traced.infer_shape_partial(data=data_shape)[0][1]

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        tensors = (x, weight) if bias is None else (x, weight, bias)
        out = op(*tensors, name="fwd", **self._op_kwargs())
        return out if self.act is None else self.act(out)

    def _alias(self):
        return "conv"

    def __repr__(self):
        ndim = len(self._kwargs["kernel"])
        parts = ["kernel_size={kernel}", "stride={stride}"]
        if self._kwargs["pad"] != (0,) * ndim:
            parts.append("padding={pad}")
        if self._kwargs["dilate"] != (1,) * ndim:
            parts.append("dilation={dilate}")
        if self._kwargs["num_group"] != 1:
            parts.append("groups={num_group}")
        if self.bias is None:
            parts.append("bias=False")
        shape = self.weight.shape
        head = "%s -> %s" % (shape[1] if shape[1] else None, shape[0])
        return ("%s(%s, %s)" % (type(self).__name__, head,
                                ", ".join(parts))).format(**self._kwargs)


def _conv_factory(name, ndim, default_layout, transpose=False):
    """Build a ConvND / ConvNDTranspose class pinned to ``ndim``."""

    if transpose:
        def __init__(self, channels, kernel_size, strides=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     layout=default_layout, activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros",
                     in_channels=0, **kwargs):
            kernel_size = _tuple_of(kernel_size, ndim)
            if len(kernel_size) != ndim:
                raise AssertionError(
                    "kernel_size must be a number or a list of %d ints"
                    % ndim)
            _Conv.__init__(self, channels, kernel_size, strides, padding,
                           dilation, groups, layout, in_channels, activation,
                           use_bias, weight_initializer, bias_initializer,
                           op_name="Deconvolution",
                           adj=_tuple_of(output_padding, ndim), **kwargs)
    else:
        def __init__(self, channels, kernel_size, strides=1, padding=0,
                     dilation=1, groups=1, layout=default_layout,
                     activation=None, use_bias=True, weight_initializer=None,
                     bias_initializer="zeros", in_channels=0, **kwargs):
            kernel_size = _tuple_of(kernel_size, ndim)
            if len(kernel_size) != ndim:
                raise AssertionError(
                    "kernel_size must be a number or a list of %d ints"
                    % ndim)
            _Conv.__init__(self, channels, kernel_size, strides, padding,
                           dilation, groups, layout, in_channels, activation,
                           use_bias, weight_initializer, bias_initializer,
                           **kwargs)

    doc = "%dD %sconvolution layer (layout %s)." % (
        ndim, "transposed " if transpose else "", default_layout)
    return type(name, (_Conv,), {"__init__": __init__, "__doc__": doc})


class _Pooling(HybridBlock):
    """Shared pooling block over the symbolic Pooling operator."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", **kwargs):
        super().__init__(**kwargs)
        ndim = len(pool_size)
        strides = pool_size if strides is None else strides
        self._kwargs = {
            "kernel": pool_size,
            "stride": _tuple_of(strides, ndim),
            "pad": _tuple_of(padding, ndim),
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        return ("{name}(size={kernel}, stride={stride}, padding={pad}, "
                "ceil_mode={ceil}").format(
                    name=type(self).__name__,
                    ceil=self._kwargs["pooling_convention"] == "full",
                    **self._kwargs) + ")"


def _pool_factory(name, ndim, kind, canonical_layout):
    """Build a Max/AvgPoolND class."""

    def __init__(self, pool_size=2, strides=None, padding=0,
                 layout=canonical_layout, ceil_mode=False, **kwargs):
        if layout != canonical_layout:
            raise AssertionError("Only supports %s layout for now"
                                 % canonical_layout)
        _Pooling.__init__(self, _tuple_of(pool_size, ndim), strides, padding,
                          ceil_mode, False, kind, **kwargs)

    doc = "%dD %s pooling (layout %s)." % (ndim, kind, canonical_layout)
    return type(name, (_Pooling,), {"__init__": __init__, "__doc__": doc})


def _global_pool_factory(name, ndim, kind, layout):
    """Build a Global{Max,Avg}PoolND class."""

    def __init__(self, layout=layout, **kwargs):
        _Pooling.__init__(self, (1,) * ndim, None, 0, True, True, kind,
                          **kwargs)

    doc = "Global %dD %s pooling." % (ndim, kind)
    return type(name, (_Pooling,), {"__init__": __init__, "__doc__": doc})


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}

for _n, _layout in _LAYOUTS.items():
    globals()["Conv%dD" % _n] = _conv_factory("Conv%dD" % _n, _n, _layout)
    for _kind in ("max", "avg"):
        _title = _kind.capitalize()
        globals()["%sPool%dD" % (_title, _n)] = _pool_factory(
            "%sPool%dD" % (_title, _n), _n, _kind, _layout)
        globals()["Global%sPool%dD" % (_title, _n)] = _global_pool_factory(
            "Global%sPool%dD" % (_title, _n), _n, _kind, _layout)
for _n in (1, 2, 3):
    globals()["Conv%dDTranspose" % _n] = _conv_factory(
        "Conv%dDTranspose" % _n, _n, _LAYOUTS[_n], transpose=True)
del _n, _layout, _kind, _title

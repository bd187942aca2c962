"""Elementwise unary, binary, variadic and tensor-scalar operators.

Counterpart of ``mxnet_tpu/ops/elemwise.py``: the unary math table, the
same-shape binary family with its comparisons (which return the first
input's dtype, as MXNet does), ``add_n``, the identity family
(``_copy`` / ``BlockGrad``) and the ``_*_scalar`` forms behind the NDArray
and Symbol operators. Gradients are torch's autograd of the same
expressions.
"""
from __future__ import annotations

import math

import torch

from .param import Enum, Float, Int
from .registry import alias_op, register_op


def _elemwise_infer(n_in, n_out=1):
    """Same-shape inference with per-dim merge: known dims of any input fix
    the unknown (0) dims of the rest."""

    def infer(attrs, in_shapes, aux_shapes):
        merged = None
        for s in in_shapes:
            if s is None:
                continue
            if merged is None:
                merged = tuple(s)
            elif len(s) == len(merged):
                merged = tuple(a if a != 0 else b for a, b in zip(merged, s))
        if merged is None:
            return None
        return ([merged] * len(in_shapes), [merged] * n_out, aux_shapes)

    return infer


def softrelu(x):
    """softplus in the form jax.nn.softplus computes (logaddexp(x, 0))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def softsign(x):
    return x / (1.0 + x.abs())


def cbrt(x):
    """Real cube root (torch has no ``cbrt``)."""
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _as(x, ref):
    """A comparison's mask in ``ref``'s dtype."""
    return x.to(ref.dtype)


_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "rint": torch.round,        # round half to even, as jnp.rint
    "round": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": cbrt,
    "rcbrt": lambda x: 1.0 / cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "degrees": lambda x: x * (180.0 / math.pi),
    "radians": lambda x: x * (math.pi / 180.0),
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "reciprocal": lambda x: 1.0 / x,
    "negative": torch.neg,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softsign": softsign,
    "logical_not": lambda x: _as(x == 0, x),
}

_BINARY = {
    "elemwise_add": torch.add,
    "elemwise_sub": torch.sub,
    "elemwise_mul": torch.mul,
    "elemwise_div": torch.div,
    "_maximum": torch.maximum,
    "_minimum": torch.minimum,
    "_hypot": torch.hypot,
    "_power": torch.pow,
    "_mod": torch.remainder,    # floor modulo, as jnp.mod
    "_equal": lambda a, b: _as(a == b, a),
    "_not_equal": lambda a, b: _as(a != b, a),
    "_greater": lambda a, b: _as(a > b, a),
    "_greater_equal": lambda a, b: _as(a >= b, a),
    "_lesser": lambda a, b: _as(a < b, a),
    "_lesser_equal": lambda a, b: _as(a <= b, a),
}


def _scalar_like(s, x):
    return torch.tensor(s, dtype=x.dtype, device=x.device)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(_scalar_like(s, x), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.clamp(x, min=s),
    "_minimum_scalar": lambda x, s: torch.clamp(x, max=s),
    "_hypot_scalar": lambda x, s: torch.hypot(x, _scalar_like(s, x)),
    "_equal_scalar": lambda x, s: _as(x == s, x),
    "_not_equal_scalar": lambda x, s: _as(x != s, x),
    "_greater_scalar": lambda x, s: _as(x > s, x),
    "_greater_equal_scalar": lambda x, s: _as(x >= s, x),
    "_lesser_scalar": lambda x, s: _as(x < s, x),
    "_lesser_equal_scalar": lambda x, s: _as(x <= s, x),
}


class _MakeLossFn(torch.autograd.Function):
    """Identity forward; the backward ignores the head gradient and
    returns ``grad_scale`` (over the batch under ``normalization="batch"``),
    the JAX package's ``jax.custom_vjp``."""

    @staticmethod
    def forward(ctx, grad_scale, batch_norm, data):
        ctx.scale = (grad_scale, batch_norm)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        grad_scale, batch_norm = ctx.scale
        grad = torch.full_like(g, grad_scale)
        if batch_norm:
            grad = grad / g.shape[0]
        return None, None, grad


def _make_loss(attrs, x):
    return _MakeLossFn.apply(attrs.grad_scale,
                             attrs.normalization == "batch", x)


def _smooth_l1(attrs, x):
    s2 = attrs.scalar * attrs.scalar
    ax = x.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


def _add_n(attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _register():
    for name, f in _UNARY.items():
        register_op(name, lambda attrs, x, _f=f: _f(x), num_inputs=1,
                    infer_shape=_elemwise_infer(1))
    # identity returns a copy: an NDArray never shares its input's storage
    register_op("_copy", lambda attrs, x: x.clone(), num_inputs=1,
                infer_shape=_elemwise_infer(1))
    alias_op("_copy", "identity")
    register_op("BlockGrad", lambda attrs, x: x.detach().clone(),
                num_inputs=1, infer_shape=_elemwise_infer(1))
    alias_op("BlockGrad", "stop_gradient")
    register_op("zeros_like", lambda attrs, x: torch.zeros_like(x),
                num_inputs=1, infer_shape=_elemwise_infer(1))
    register_op("ones_like", lambda attrs, x: torch.ones_like(x),
                num_inputs=1, infer_shape=_elemwise_infer(1))

    for name, f in _BINARY.items():
        register_op(name, lambda attrs, a, b, _f=f: _f(a, b), num_inputs=2,
                    infer_shape=_elemwise_infer(2))
    alias_op("elemwise_add", "_plus")
    alias_op("elemwise_sub", "_minus")
    alias_op("elemwise_sub", "_sub")
    alias_op("elemwise_mul", "_mul")
    alias_op("elemwise_div", "_div")
    register_op(
        "add_n", _add_n, params={"num_args": Int(default=1)},
        num_inputs=lambda attrs: attrs.num_args,
        input_names=lambda attrs: ["arg%d" % i
                                   for i in range(attrs.num_args)],
        infer_shape=lambda attrs, i, a: _elemwise_infer(attrs.num_args)(
            attrs, i, a))
    alias_op("add_n", "ElementWiseSum")
    alias_op("add_n", "_sum")

    for name, f in _SCALAR.items():
        register_op(name, lambda attrs, x, _f=f: _f(x, attrs.scalar),
                    params={"scalar": Float()}, num_inputs=1,
                    infer_shape=_elemwise_infer(1))
    register_op("smooth_l1", _smooth_l1,
                params={"scalar": Float(default=1.0)}, num_inputs=1,
                infer_shape=_elemwise_infer(1))
    register_op(
        "MakeLoss", _make_loss,
        params={"grad_scale": Float(default=1.0),
                "valid_thresh": Float(default=0.0),
                "normalization": Enum(["null", "batch", "valid"],
                                      default="null")},
        num_inputs=1, infer_shape=_elemwise_infer(1),
        doc="Gradient source: d(out)/d(in) = grad_scale, ignores the head "
            "gradient")
    alias_op("MakeLoss", "make_loss")


_register()

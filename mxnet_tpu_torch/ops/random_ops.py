"""Random sampling ops: the ``_random_*`` samplers, their ``_like`` forms
and ``_sample_multinomial``.

Counterpart of ``mxnet_tpu/ops/random_ops.py``. Each op draws from the
generator it is given, else from ``mx.random``'s generator of its device
(seeded by ``mx.random.seed``); the distributions are the JAX package's,
the streams torch's. Negative binomials are Gamma-Poisson mixtures, as
there.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import torch_dtype
from ..context import as_device
from .param import Bool, DType, Float, Int, Shape, Str
from .registry import alias_op, register_op


def _gen(rng, device):
    return rng if rng is not None else _random.generator(device)


def _uniform(attrs, shape, dtype, dev, g):
    return torch.rand(shape, generator=g, dtype=dtype, device=dev) \
        * (attrs.high - attrs.low) + attrs.low


def _normal(attrs, shape, dtype, dev, g):
    return attrs.loc + attrs.scale * torch.randn(shape, generator=g,
                                                 dtype=dtype, device=dev)


def _std_gamma(alpha, shape, dev, g):
    return torch._standard_gamma(
        torch.full(shape, float(alpha), dtype=torch.float32, device=dev),
        generator=g)


def _poisson(lam, g):
    return torch.poisson(lam, generator=g)


def _sampler(draw):
    def fn(attrs, rng=None):
        dev = as_device(attrs.ctx or None)
        dtype = torch_dtype(attrs.dtype or "float32")
        return draw(attrs, tuple(attrs.shape), dtype, dev,
                    _gen(rng, dev)).to(dtype)
    return fn


_SAMPLERS = {
    "_random_uniform": (
        _uniform, {"low": Float(default=0.0), "high": Float(default=1.0)},
        ["uniform", "random_uniform"]),
    "_random_normal": (
        _normal, {"loc": Float(default=0.0), "scale": Float(default=1.0)},
        ["normal", "random_normal"]),
    "_random_gamma": (
        lambda a, shape, dtype, dev, g: a.beta * _std_gamma(a.alpha, shape,
                                                            dev, g),
        {"alpha": Float(default=1.0), "beta": Float(default=1.0)},
        ["random_gamma"]),
    "_random_exponential": (
        lambda a, shape, dtype, dev, g: torch.empty(
            shape, dtype=torch.float32, device=dev).exponential_(
                1.0, generator=g) / a.lam,
        {"lam": Float(default=1.0)}, ["random_exponential"]),
    "_random_poisson": (
        lambda a, shape, dtype, dev, g: _poisson(torch.full(
            shape, a.lam, dtype=torch.float32, device=dev), g),
        {"lam": Float(default=1.0)}, ["random_poisson"]),
    "_random_negative_binomial": (
        lambda a, shape, dtype, dev, g: _poisson(
            _std_gamma(a.k, shape, dev, g) * (1 - a.p) / a.p, g),
        {"k": Int(default=1), "p": Float(default=1.0)},
        ["random_negative_binomial"]),
    "_random_generalized_negative_binomial": (
        lambda a, shape, dtype, dev, g: _poisson(
            _std_gamma(1.0 / a.alpha, shape, dev, g) * (a.alpha * a.mu), g),
        {"mu": Float(default=1.0), "alpha": Float(default=1.0)},
        ["random_generalized_negative_binomial"]),
}


def _uniform_like(attrs, data, rng=None):
    return _uniform(attrs, tuple(data.shape), data.dtype, data.device,
                    _gen(rng, data.device))


def _normal_like(attrs, data, rng=None):
    return _normal(attrs, tuple(data.shape), data.dtype, data.device,
                   _gen(rng, data.device))


def _sample_multinomial(attrs, data, rng=None):
    """Draws from the categorical rows of ``data`` (..., k), with their
    log-probabilities under ``get_prob``."""
    n = attrs.shape[0] if attrs.shape else 1
    rows = data.reshape(-1, data.shape[-1]).float()
    samples = torch.multinomial(rows, n, replacement=True,
                                generator=_gen(rng, data.device))
    samples = samples.reshape(tuple(data.shape[:-1]) + (n,))
    if not attrs.shape:
        samples = samples.reshape(data.shape[:-1])
    out = samples.to(torch_dtype(attrs.dtype))
    if attrs.get_prob:
        logp = torch.log_softmax(torch.log(torch.clamp(data.float(),
                                                       min=1e-30)), dim=-1)
        picked = torch.gather(logp, -1, samples.reshape(
            tuple(data.shape[:-1]) + (-1,)))
        return out, picked.reshape(out.shape)
    return out


def _register():
    for name, (draw, params, aliases) in _SAMPLERS.items():
        full = {"shape": Shape(default=()), "ctx": Str(default=""),
                "dtype": DType(default=None)}
        full.update(params)
        register_op(name, _sampler(draw), params=full, num_inputs=0,
                    input_names=[], needs_rng=True,
                    infer_shape=lambda attrs, i, a: (
                        [], [tuple(attrs.shape)], a),
                    infer_dtype=lambda attrs, i, a: (
                        [], [attrs.dtype or "float32"], a))
        for alias in aliases:
            alias_op(name, alias)
    register_op("_random_uniform_like", _uniform_like,
                params={"low": Float(default=0.0),
                        "high": Float(default=1.0)},
                num_inputs=1, needs_rng=True)
    register_op("_random_normal_like", _normal_like,
                params={"loc": Float(default=0.0),
                        "scale": Float(default=1.0)},
                num_inputs=1, needs_rng=True)
    register_op("_sample_multinomial", _sample_multinomial,
                params={"shape": Shape(default=()),
                        "get_prob": Bool(default=False),
                        "dtype": DType(default="int32")},
                num_inputs=1, needs_rng=True,
                num_outputs=lambda attrs: 2 if attrs.get_prob else 1,
                infer_dtype=lambda attrs, i, a: (
                    i, [attrs.dtype] + (["float32"] if attrs.get_prob
                                        else []), a))
    alias_op("_sample_multinomial", "sample_multinomial")


_register()

"""``mx.nd.random``: the samplers by their distribution's name (MXNet
1.x's ``mx.nd.random.uniform`` etc.), over the registered ``_random_*``
and ``_sample_multinomial`` ops; they draw from ``mx.random``'s
generators."""
from __future__ import annotations

from . import _internal

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial"]


def _draw(op, shape, dtype, ctx, out, **params):
    kw = dict(params, shape=shape if shape is not None else (1,))
    if dtype is not None:
        kw["dtype"] = dtype
    if ctx is not None:
        kw["ctx"] = str(ctx)
    if out is not None:
        kw["out"] = out
    return getattr(_internal, op)(**kw)


def uniform(low=0, high=1, shape=None, dtype=None, ctx=None, out=None):
    return _draw("_random_uniform", shape, dtype, ctx, out, low=low,
                 high=high)


def normal(loc=0, scale=1, shape=None, dtype=None, ctx=None, out=None):
    return _draw("_random_normal", shape, dtype, ctx, out, loc=loc,
                 scale=scale)


def gamma(alpha=1, beta=1, shape=None, dtype=None, ctx=None, out=None):
    return _draw("_random_gamma", shape, dtype, ctx, out, alpha=alpha,
                 beta=beta)


def exponential(scale=1, shape=None, dtype=None, ctx=None, out=None):
    return _draw("_random_exponential", shape, dtype, ctx, out,
                 lam=1.0 / scale)


def poisson(lam=1, shape=None, dtype=None, ctx=None, out=None):
    return _draw("_random_poisson", shape, dtype, ctx, out, lam=lam)


def negative_binomial(k=1, p=1, shape=None, dtype=None, ctx=None,
                      out=None):
    return _draw("_random_negative_binomial", shape, dtype, ctx, out, k=k,
                 p=p)


def generalized_negative_binomial(mu=1, alpha=1, shape=None, dtype=None,
                                  ctx=None, out=None):
    return _draw("_random_generalized_negative_binomial", shape, dtype, ctx,
                 out, mu=mu, alpha=alpha)


def multinomial(data, shape=None, get_prob=False, dtype="int32", out=None):
    kw = {"shape": shape or (), "get_prob": get_prob, "dtype": dtype}
    if out is not None:
        kw["out"] = out
    return _internal._sample_multinomial(data, **kw)

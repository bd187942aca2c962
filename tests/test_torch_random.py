"""Port parity for the random ops: every sampler's moments against the
distribution's and against the JAX package's draws, Dropout's keep rate
and scaling, and ``mx.random.seed``'s determinism.

The streams differ (torch's generators, not threefry), so the two
packages are held to moments, not bits: each sample mean within 6
standard errors (plus 5% of the scale) of the analytic mean, each
variance within 10%, and the two packages' means within 6 standard errors
of their difference. N = 200 000 draws a case.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

N = 200_000
MEAN_TOL = 0.05
VAR_TOL = 0.10


def _draw(mx, op, ctx, **kwargs):
    mx.random.seed(42)
    return getattr(mx.nd, op)(shape=(N,), **ctx, **kwargs).asnumpy() \
        .astype(np.float64)


def _check(s, mean, var):
    se = np.sqrt(max(var, 1e-4) / s.size)
    assert abs(s.mean() - mean) < MEAN_TOL * max(abs(mean), 1e-2) + 6 * se, \
        "mean %g vs analytic %g" % (s.mean(), mean)
    assert abs(s.var() - var) < VAR_TOL * max(var, 1e-2) + 1e-2, \
        "var %g vs analytic %g" % (s.var(), var)


# op, params, analytic (mean, var)
SAMPLERS = [
    ("random_uniform", dict(low=-1.5, high=2.5), (0.5, 16 / 12)),
    ("uniform", dict(low=0.0, high=1.0), (0.5, 1 / 12)),
    ("random_normal", dict(loc=1.2, scale=0.7), (1.2, 0.49)),
    ("normal", dict(), (0.0, 1.0)),
    ("random_gamma", dict(alpha=2.5, beta=1.5), (3.75, 5.625)),
    ("random_exponential", dict(lam=2.0), (0.5, 0.25)),
    ("random_poisson", dict(lam=3.5), (3.5, 3.5)),
    ("random_negative_binomial", dict(k=3, p=0.4), (4.5, 11.25)),
    ("random_generalized_negative_binomial", dict(mu=2.0, alpha=0.5),
     (2.0, 4.0)),
]


@pytest.mark.parametrize("op,params,moments", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_sampler_moments_match_the_jax_package(op, params, moments):
    port = _draw(tmx, op, {"ctx": tmx.cpu()}, **params)
    ref = _draw(jmx, op, {}, **params)
    for s in (port, ref):
        _check(s, *moments)
    se = np.sqrt(2 * max(moments[1], 1e-4) / N)
    assert abs(port.mean() - ref.mean()) < 6 * se


def test_uniform_support_and_dtype():
    with tmx.cpu():
        tmx.random.seed(0)
        s = tmx.nd.random_uniform(low=2.0, high=3.0, shape=(1000,),
                                  dtype="float16").asnumpy()
    assert s.dtype == np.float16
    assert s.min() >= 2.0 and s.max() <= 3.0


def test_nd_random_namespace_draws_the_same_distributions():
    with tmx.cpu():
        tmx.random.seed(5)
        a = tmx.nd.random.uniform(-1, 1, shape=(N,)).asnumpy()
        b = tmx.nd.random.normal(2.0, 0.5, shape=(N,)).asnumpy()
        c = tmx.nd.random.exponential(scale=2.0, shape=(N,)).asnumpy()
        d = tmx.nd.random.gamma(2.0, 0.5, shape=(N,)).asnumpy()
        e = tmx.nd.random.poisson(2.0, shape=(N,)).asnumpy()
        f = tmx.nd.random.negative_binomial(2, 0.5, shape=(N,)).asnumpy()
        g = tmx.nd.random.generalized_negative_binomial(
            1.0, 0.5, shape=(N,)).asnumpy()
    _check(a.astype(np.float64), 0.0, 4 / 12)
    _check(b.astype(np.float64), 2.0, 0.25)
    _check(c.astype(np.float64), 2.0, 4.0)
    _check(d.astype(np.float64), 1.0, 0.5)
    _check(e.astype(np.float64), 2.0, 2.0)
    _check(f.astype(np.float64), 2.0, 4.0)
    _check(g.astype(np.float64), 1.0, 1.5)


@pytest.mark.parametrize("op,params,moments", [
    ("_random_uniform_like", dict(low=-1.0, high=3.0), (1.0, 16 / 12)),
    ("_random_normal_like", dict(loc=-0.5, scale=2.0), (-0.5, 4.0))])
def test_like_samplers(op, params, moments):
    shape = (400, 500)

    def draw(mx, ctx):
        mx.random.seed(3)
        like = mx.nd.zeros(shape, **ctx)
        out = getattr(mx.nd._internal, op)(like, **params).asnumpy()
        assert out.shape == shape and out.dtype == np.float32
        return out.reshape(-1).astype(np.float64)

    port, ref = draw(tmx, {"ctx": tmx.cpu()}), draw(jmx, {})
    _check(port, *moments)
    _check(ref, *moments)


@pytest.mark.parametrize("get_prob", [False, True])
def test_multinomial_frequencies_match_the_jax_package(get_prob):
    probs = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1]],
                     np.float32)
    n = 50_000

    def draw(mx, ctx):
        mx.random.seed(9)
        out = mx.nd.sample_multinomial(mx.nd.array(probs, **ctx),
                                       shape=(n,), get_prob=get_prob)
        samples = out[0] if get_prob else out
        s = samples.asnumpy()
        assert s.shape == (2, n) and s.dtype == np.int32
        if get_prob:
            logp = out[1].asnumpy()
            np.testing.assert_allclose(
                logp, np.log(np.take_along_axis(probs, s, axis=1)),
                rtol=1e-5, atol=1e-6)
        return np.stack([np.bincount(r, minlength=4) / n for r in s])

    port, ref = draw(tmx, {"ctx": tmx.cpu()}), draw(jmx, {})
    se = np.sqrt(probs * (1 - probs) / n)
    assert (np.abs(port - probs) < 5 * se).all()
    assert (np.abs(port - ref) < 5 * np.sqrt(2) * se).all()


def test_multinomial_single_draw_shape():
    with tmx.cpu():
        out = tmx.nd.random.multinomial(tmx.nd.array([[0.5, 0.5],
                                                       [0.0, 1.0]]))
    assert out.shape == (2,)
    assert out.asnumpy()[1] == 1


def test_seed_gives_the_same_draws_and_other_seeds_others():
    def draw(seed):
        with tmx.cpu():
            tmx.random.seed(seed)
            return tmx.nd.random_normal(shape=(64,)).asnumpy()

    np.testing.assert_array_equal(draw(1), draw(1))
    assert not np.array_equal(draw(1), draw(2))


def test_get_and_set_state_replay_the_stream():
    with tmx.cpu():
        tmx.random.seed(4)
        state = tmx.random.get_state()
        a = tmx.nd.random_uniform(shape=(16,)).asnumpy()
        tmx.random.set_state(state)
        b = tmx.nd.random_uniform(shape=(16,)).asnumpy()
    np.testing.assert_array_equal(a, b)


def _dropout(mx, x, ctx, train=True, **kw):
    mx.random.seed(11)
    data = mx.nd.array(x, **ctx)
    if train:
        with mx.autograd.train_mode():
            return mx.nd.Dropout(data, **kw).asnumpy()
    return mx.nd.Dropout(data, **kw).asnumpy()


@pytest.mark.parametrize("p", [0.1, 0.5, 0.8])
def test_dropout_keep_rate_and_scale_match_the_jax_package(p):
    x = np.ones((500, 400), np.float32)
    for mx, ctx in ((tmx, {"ctx": tmx.cpu()}), (jmx, {})):
        out = _dropout(mx, x, ctx, p=p)
        kept = out != 0
        keep = 1 - p
        se = np.sqrt(keep * p / kept.size)
        assert abs(kept.mean() - keep) < 5 * se, (mx.__name__, kept.mean())
        np.testing.assert_allclose(out[kept], 1 / keep, rtol=1e-6)


def test_dropout_axes_drop_whole_slices():
    x = np.ones((64, 8, 32), np.float32)
    for mx, ctx in ((tmx, {"ctx": tmx.cpu()}), (jmx, {})):
        out = _dropout(mx, x, ctx, p=0.5, axes=(1,))
        kept = out != 0
        # the mask is shared along axis 1
        assert (kept == kept[:, :1, :]).all()
        assert 0.4 < kept.mean() < 0.6


def test_dropout_is_the_identity_outside_training():
    x = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    for mx, ctx in ((tmx, {"ctx": tmx.cpu()}), (jmx, {})):
        np.testing.assert_array_equal(_dropout(mx, x, ctx, train=False,
                                               p=0.5), x)
    with tmx.cpu():
        out = tmx.nd.Dropout(tmx.nd.array(x), p=0.5, mode="always")
    assert (out.asnumpy() == 0).any()


def test_dropout_gradient_is_the_mask():
    x = np.random.RandomState(1).randn(50, 40).astype(np.float32)
    with tmx.cpu():
        tmx.random.seed(2)
        data = tmx.nd.array(x)
        data.attach_grad()
        with tmx.autograd.record():
            out = tmx.nd.Dropout(data, p=0.3)
        out.backward()
        mask = out.asnumpy() != 0
        np.testing.assert_allclose(data.grad.asnumpy(), mask / 0.7,
                                   rtol=1e-6)


def test_mirrored_backward_replays_the_dropout_mask():
    """Under MXNET_BACKWARD_DO_MIRROR the backward recomputes the forward:
    it must draw the mask the forward drew, and leave the generator where
    the forward left it."""
    import os

    rng = np.random.RandomState(3)
    data = rng.randn(16, 8).astype(np.float32)
    w = rng.randn(4, 8).astype(np.float32)

    def run():
        sym = tmx.sym.FullyConnected(
            tmx.sym.Dropout(tmx.sym.var("data"), p=0.5), num_hidden=4,
            no_bias=True, name="fc")
        ex = sym.simple_bind(tmx.cpu(), data=(16, 8), grad_req="write")
        ex.arg_dict["data"][:] = data
        ex.arg_dict["fc_weight"][:] = w
        tmx.random.seed(6)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([tmx.nd.ones((16, 4), ctx=tmx.cpu())])
        after = tmx.nd.random_uniform(shape=(4,), ctx=tmx.cpu()).asnumpy()
        return out, ex.grad_dict["fc_weight"].asnumpy(), after

    plain = run()
    os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
    try:
        mirrored = run()
    finally:
        del os.environ["MXNET_BACKWARD_DO_MIRROR"]
    for a, b in zip(plain, mirrored):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("random,capturing,walks,preserve", [
    (False, False, 2, False), (False, True, 2, False),
    (True, False, 2, True), (True, True, 1, None)])
def test_mirroring_reads_a_generator_only_for_a_random_walk(
        monkeypatch, random, capturing, walks, preserve):
    """Under MXNET_BACKWARD_DO_MIRROR a walk without a random op is
    recomputed without saving any generator's state; one with a random op
    saves and replays them, except inside a CUDA graph capture (faked
    here), where a card's generator can be neither read nor rewound: that
    walk keeps its activations and is walked once. The gradients are the
    unmirrored ones either way."""
    import torch
    import torch.utils.checkpoint as ckpt

    from mxnet_tpu_torch.config import set_flag
    from mxnet_tpu_torch.executor import _GraphProgram

    calls, flags = [], []
    real_walk, real_ckpt = _GraphProgram._walk, ckpt.checkpoint

    def counted(self, *args):
        calls.append(1)
        return real_walk(self, *args)

    def recorded(*args, **kw):
        flags.append(kw["preserve_rng_state"])
        return real_ckpt(*args, **kw)

    monkeypatch.setattr(_GraphProgram, "_walk", counted)
    monkeypatch.setattr(ckpt, "checkpoint", recorded)
    rng = np.random.RandomState(4)
    data = rng.randn(16, 8).astype(np.float32)
    w = rng.randn(4, 8).astype(np.float32)

    def run():
        x = tmx.sym.var("data")
        if random:
            x = tmx.sym.Dropout(x, p=0.5)
        sym = tmx.sym.FullyConnected(x, num_hidden=4, no_bias=True,
                                     name="fc")
        ex = sym.simple_bind(tmx.cpu(), data=(16, 8), grad_req="write")
        ex.arg_dict["data"][:] = data
        ex.arg_dict["fc_weight"][:] = w
        tmx.random.seed(6)
        del calls[:], flags[:]
        ex.forward(is_train=True)
        ex.backward([tmx.nd.ones((16, 4), ctx=tmx.cpu())])
        return ex.grad_dict["fc_weight"].asnumpy(), len(calls), list(flags)

    plain, _, _ = run()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    set_flag("MXNET_BACKWARD_DO_MIRROR", 1)
    try:
        mirrored, n_walks, preserved = run()
    finally:
        set_flag("MXNET_BACKWARD_DO_MIRROR", None)
    assert n_walks == walks
    assert preserved == ([] if preserve is None else [preserve])
    np.testing.assert_array_equal(plain, mirrored)

"""Port parity: the metrics of ``mxnet_tpu/metric.py`` that came with the
Module family (F1, MAE, MSE, RMSE, NegativeLogLikelihood,
PearsonCorrelation, Loss, Torch, Caffe, CustomMetric and ``metric.np``)
against the JAX package's, two updates then ``get()`` on the same numpy
labels and predictions, at 1e-6 (the same float64 numpy math on the host;
Loss sums in float32 on the arrays' device in both packages)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

_TOL = dict(rtol=1e-6, atol=1e-7)


def _batches(kind, rng):
    """Two (labels, predictions) update batches for a metric family."""
    out = []
    for _ in range(2):
        if kind == "binary":
            y = rng.randint(0, 2, 12).astype(np.float32)
            p = rng.dirichlet(np.ones(2), 12).astype(np.float32)
        elif kind == "classes":
            y = rng.randint(0, 5, 12).astype(np.float32)
            p = rng.dirichlet(np.ones(5), 12).astype(np.float32)
        elif kind == "regression":
            y = rng.standard_normal((12, 3)).astype(np.float32)
            p = y + 0.3 * rng.standard_normal((12, 3)).astype(np.float32)
        else:   # "vector": 1-d labels and predictions
            y = rng.standard_normal(12).astype(np.float32)
            p = (0.5 * y + rng.standard_normal(12)).astype(np.float32)
        out.append((y, p))
    return out


CASES = [
    ("f1", "binary", {}), ("mae", "regression", {}),
    ("mse", "regression", {}), ("rmse", "regression", {}),
    ("mae", "vector", {}), ("rmse", "vector", {}),
    ("nll-loss", "classes", {}), ("nll_loss", "classes", {"eps": 1e-6}),
    ("pearsoncorrelation", "vector", {}),
    ("pearsoncorrelation", "regression", {}),
    ("loss", "regression", {}), ("torch", "regression", {}),
    ("caffe", "regression", {}),
]


def _run(mx, name, kind, kw, seed=4, host_preds=False):
    rng = np.random.RandomState(seed)
    m = mx.metric.create(name, **kw)
    for y, p in _batches(kind, rng):
        preds = [p] if host_preds else [mx.nd.array(p, ctx=mx.cpu())]
        m.update([mx.nd.array(y, ctx=mx.cpu())], preds)
    return m


@pytest.mark.parametrize("name,kind,kw", CASES,
                         ids=["%s-%s" % (c[0], c[1]) for c in CASES])
def test_metric_matches_jax(name, kind, kw):
    got = [_run(mx, name, kind, kw) for mx in (jmx, tmx)]
    assert type(got[1]).__name__ == type(got[0]).__name__
    (jn, jv), (tn, tv) = got[0].get(), got[1].get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, **_TOL)
    assert got[1].num_inst == got[0].num_inst
    assert got[1].get_config() == got[0].get_config()


def test_loss_takes_host_arrays_and_sums_in_float32():
    j, t = (_run(mx, "loss", "regression", {}, host_preds=True)
            for mx in (jmx, tmx))
    np.testing.assert_allclose(t.get()[1], j.get()[1], **_TOL)
    bf16 = tmx.nd.array(np.full((300,), 1.0, np.float32),
                        ctx=tmx.cpu()).astype("bfloat16")
    m = tmx.metric.Loss()
    for _ in range(3):
        m.update(None, [bf16])
    assert m.get() == ("loss", 1.0)   # a bf16 running sum would stall
    assert tmx.metric.Loss().get()[1] != tmx.metric.Loss().get()[1]  # nan


def test_f1_refuses_more_than_two_classes():
    for mx in (jmx, tmx):
        m = mx.metric.F1()
        with pytest.raises(ValueError, match="binary"):
            m.update([mx.nd.array(np.array([0, 1, 2], np.float32),
                                  ctx=mx.cpu())],
                     [mx.nd.array(np.eye(3, dtype=np.float32),
                                  ctx=mx.cpu())])


def _mean_abs(label, pred):
    return float(np.abs(label - pred.reshape(label.shape)).mean())


def _sum_and_count(label, pred):
    return float(np.abs(label).sum()), label.size


@pytest.mark.parametrize("make", ["create", "np", "class", "tuple",
                                  "lambda"])
def test_custom_metrics_match_jax(make):
    rng = np.random.RandomState(9)
    batches = _batches("vector", rng)
    got = []
    for mx in (jmx, tmx):
        if make == "create":
            m = mx.metric.create(_mean_abs)
        elif make == "np":
            m = mx.metric.np(_mean_abs)
        elif make == "class":
            m = mx.metric.CustomMetric(_mean_abs, name="mine",
                                       allow_extra_outputs=True)
        elif make == "tuple":
            m = mx.metric.create(_sum_and_count)
        else:
            m = mx.metric.create(lambda label, pred: 1.0)
        for y, p in batches:
            m.update([mx.nd.array(y, ctx=mx.cpu())],
                     [mx.nd.array(p, ctx=mx.cpu())])
        got.append(m)
    (jn, jv), (tn, tv) = got[0].get(), got[1].get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, **_TOL)
    with pytest.raises(NotImplementedError):
        got[1].get_config()


def test_composite_of_new_metrics_and_the_registry():
    rng = np.random.RandomState(2)
    batches = _batches("regression", rng)
    got = []
    for mx in (jmx, tmx):
        m = mx.metric.create(["mae", "mse", "rmse", _mean_abs])
        for y, p in batches:
            m.update([mx.nd.array(y, ctx=mx.cpu())],
                     [mx.nd.array(p, ctx=mx.cpu())])
        got.append(m.get())
    assert got[1][0] == got[0][0]
    np.testing.assert_allclose(got[1][1], got[0][1], **_TOL)
    assert sorted(tmx.metric.__all__) == sorted(jmx.metric.__all__)
    for name in ("f1", "mae", "mse", "rmse", "nll-loss", "nll_loss",
                 "pearsoncorrelation", "loss", "torch", "caffe",
                 "custommetric", "ce", "cross-entropy", "acc", "top_k_acc"):
        assert tmx.metric._REGISTRY[name].__name__ == \
            jmx.metric._REGISTRY[name].__name__

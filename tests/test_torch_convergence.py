"""Convergence through the port (counterparts of
``tests/test_convergence.py``'s MLP on blobs and conv net on bars): train
to completion with ``NDArrayIter`` and ``Module.fit`` on the CPU and hold a
hard accuracy bar (>= 0.95 train accuracy), not just a falling loss. The
data and the optimizer settings are the JAX tests' own.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mx


def blob_dataset(n, rng):
    """Three well-separated Gaussian blobs in 8-d."""
    centers = rng.randn(3, 8) * 3.0
    x = np.concatenate([centers[i] + 0.5 * rng.randn(n // 3, 8)
                        for i in range(3)]).astype(np.float32)
    y = np.repeat(np.arange(3), n // 3).astype(np.float32)
    order = rng.permutation(len(x))
    return x[order], y[order]


def bars_dataset(n, rng, size=12):
    """Images of horizontal vs vertical bars (a conv-solvable task)."""
    x = rng.rand(n, 1, size, size).astype(np.float32) * 0.15
    y = rng.randint(0, 2, n).astype(np.float32)
    for i in range(n):
        pos = rng.randint(2, size - 2)
        if y[i] == 0:
            x[i, 0, pos, :] = 1.0
        else:
            x[i, 0, :, pos] = 1.0
    return x, y


def mlp():
    data = mx.sym.Variable("data")
    h1 = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=32,
                                                 name="fc1"),
                           act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(h1, num_hidden=3,
                                                      name="fc2"),
                                name="softmax")


def conv_net():
    data = mx.sym.Variable("data")
    c1 = mx.sym.Activation(
        mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                           name="conv1"), act_type="relu")
    p1 = mx.sym.Pooling(c1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.Flatten(p1), num_hidden=2, name="fc"),
        name="softmax")


@pytest.mark.parametrize("case", ["mlp_blobs", "conv_bars"])
def test_convergence(case):
    np.random.seed(0)
    if case == "mlp_blobs":
        x, y = blob_dataset(600, np.random.RandomState(0))
        net, bs, epochs, lr = mlp(), 50, 15, 0.2
    else:
        x, y = bars_dataset(400, np.random.RandomState(1))
        net, bs, epochs, lr = conv_net(), 40, 12, 0.1
    with mx.cpu():
        train = mx.io.NDArrayIter(x, y, batch_size=bs, shuffle=True,
                                  label_name="softmax_label")
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(train, num_epoch=epochs, optimizer="sgd",
                optimizer_params=(("learning_rate", lr), ("momentum", 0.9)),
                eval_metric="acc")
        score = mod.score(mx.io.NDArrayIter(x, y, batch_size=bs,
                                            label_name="softmax_label"),
                          "acc")
    acc = dict(score)["accuracy"]
    assert acc >= 0.95, "%s failed to converge: train acc %.3f" % (case, acc)

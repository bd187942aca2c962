"""Port parity for ``gluon.rnn`` and ``gluon.contrib.rnn``: the same
network is built in both packages, the JAX net's parameters are carried
into the port's (``mx.gluon_params_from_jax``), and the same numpy inputs
go through both on the CPU under ``autograd.record``.

- the cells (RNN tanh / relu, LSTM, GRU, sequential, residual,
  bidirectional) unrolled merged and step by step, and
  the contrib Conv1D/2D/3D RNN, LSTM and GRU cells: outputs, final states
  and the gradients of the inputs and of every parameter, 1e-5 of each
  tensor's max; Dropout and Zoneout cells in predict mode;
- the ``RNN`` / ``LSTM`` / ``GRU`` layers in ``TNC`` and ``NTC``, one and
  two layers, uni- and bidirectional, with implicit and explicit states;
- ``VariationalDropoutCell`` by moments: each mask's keep rate within 3
  standard errors, and one mask per sequence.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per case: the cases are small, and on a machine
    whose cores the other test workers keep busy torch's thread pool costs
    more than it saves (a 480 x 64 x 32 product took 7 ms on 8 threads
    beside a loaded run, 40 us on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / scale
    assert err <= tol, "%s: %.3g of max" % (what, err)


def _flat(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _drive(mx, net, xs, body, train=True, seed=9):
    """Run ``body(net, inputs)`` -> (outputs, states) under record on the
    CPU with a weighted sum as the loss: (numpy outputs, input grads,
    {stripped parameter name: grad})."""
    with mx.cpu():
        inputs = [mx.nd.array(x) for x in xs]
        for x in inputs:
            x.attach_grad()
        with mx.autograd.record(train_mode=train):
            outs, states = body(net, inputs)
            heads = _flat(outs) + _flat(states)
            rng = np.random.RandomState(seed)
            loss = None
            for h in heads:
                w = mx.nd.array(rng.randn(*h.shape).astype(np.float32))
                term = (h * w).sum()
                loss = term if loss is None else loss + term
        loss.backward()
        cut = len(net.prefix)
        grads = {name[cut:]: p.grad().asnumpy()
                 for name, p in net.collect_params().items()
                 if p.grad_req != "null"}
        return ([h.asnumpy() for h in heads],
                [x.grad.asnumpy() for x in inputs], grads)


def _pair(make, seed=0):
    jnet, tnet = make(jmx), make(tmx)
    np.random.seed(seed)
    jnet.collect_params().initialize(jmx.init.Uniform(0.4), ctx=jmx.cpu())
    with tmx.cpu():
        tmx.gluon_params_from_jax(jnet, tnet)
    return jnet, tnet


def _compare(make, xs, body, train=True):
    jnet, tnet = _pair(make)
    want = _drive(jmx, jnet, xs, body, train)
    got = _drive(tmx, tnet, xs, body, train)
    assert len(got[0]) == len(want[0])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g.shape == w.shape
        _close(g, w, what="head %d" % i)
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        _close(g, w, what="input grad %d" % i)
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        _close(got[2][k], want[2][k], what="d" + k)


def _cell(kind):
    def make(mx):
        r = mx.gluon.rnn
        if kind == "rnn_tanh":
            return r.RNNCell(6, input_size=3, prefix="c_")
        if kind == "rnn_relu":
            return r.RNNCell(6, activation="relu", input_size=3,
                             prefix="c_")
        if kind == "lstm":
            return r.LSTMCell(6, input_size=3, prefix="c_")
        if kind == "gru":
            return r.GRUCell(6, input_size=3, prefix="c_")
        if kind == "sequential":
            s = r.SequentialRNNCell(prefix="s_")
            with s.name_scope():
                s.add(r.LSTMCell(5, input_size=3))
                s.add(r.GRUCell(4, input_size=5))
            return s
        if kind == "residual":
            return r.ResidualCell(r.GRUCell(3, input_size=3, prefix="c_"))
        if kind == "bidirectional":
            return r.BidirectionalCell(
                r.LSTMCell(4, input_size=3, prefix="l_"),
                r.GRUCell(4, input_size=3, prefix="r_"))
        if kind == "dropout":
            s = r.SequentialRNNCell(prefix="s_")
            with s.name_scope():
                s.add(r.RNNCell(5, input_size=3))
                s.add(r.DropoutCell(0.4))
                s.add(r.RNNCell(4, input_size=5))
            return s
        if kind == "zoneout":
            return r.ZoneoutCell(r.LSTMCell(5, input_size=3, prefix="c_"),
                                 0.3, 0.2)
        raise KeyError(kind)
    return make


@pytest.mark.parametrize("kind", ["rnn_tanh", "rnn_relu", "lstm", "gru",
                                  "sequential",
                                  "residual", "bidirectional", "dropout",
                                  "zoneout"])
@pytest.mark.parametrize("merge", [True, False], ids=["merged", "steps"])
def test_cells_match_the_jax_package(kind, merge):
    x = np.random.RandomState(1).randn(2, 4, 3).astype(np.float32)

    def body(net, inputs):
        seq = inputs[0] if merge else [inputs[0][:, t] for t in range(4)]
        return net.unroll(4, seq, layout="NTC", merge_outputs=merge)

    # the random cells are compared where they are the identity
    _compare(_cell(kind), [x], body,
             train=kind not in ("dropout", "zoneout"))


_CONV = [(dims, kind) for dims in (1, 2, 3) for kind in ("RNN", "LSTM",
                                                         "GRU")]


@pytest.mark.parametrize("dims,kind", _CONV,
                         ids=["%dD-%s" % c for c in _CONV])
def test_contrib_conv_cells_match_the_jax_package(dims, kind):
    spatial = (5, 4, 3)[:dims]

    def make(mx):
        cls = getattr(mx.gluon.contrib.rnn, "Conv%dD%sCell" % (dims, kind))
        return cls(input_shape=(2,) + spatial, hidden_channels=3,
                   i2h_kernel=3, h2h_kernel=3, i2h_pad=1, prefix="cv_")

    x = np.random.RandomState(2).randn(2, 3, 2, *spatial).astype(
        np.float32)

    def body(net, inputs):
        return net.unroll(3, inputs[0], layout="NTC", merge_outputs=True)

    _compare(make, [x], body)


# each layout with one and two bidirectional layers, each of those with
# implicit and with explicit states, across the four layer kinds
_LAYERS = [(cls, layout, L, bi, explicit)
           for cls in ("RNN-relu", "RNN-tanh", "LSTM", "GRU")
           for layout, L, bi, explicit in (
               ("TNC", 1, False, False), ("TNC", 2, True, True),
               ("NTC", 1, False, True), ("NTC", 2, True, False))]


@pytest.mark.parametrize("cls,layout,L,bi,explicit", _LAYERS, ids=[
    "%s-%s-L%d%s-%s" % (c, lay, n, "-bi" if b else "",
                        "states" if e else "implicit")
    for c, lay, n, b, e in _LAYERS])
def test_rnn_layers_match_the_jax_package(cls, layout, L, bi, explicit):
    name, _, act = cls.partition("-")
    T, N = 5, 3

    def make(mx):
        kw = {"activation": act} if act else {}
        return getattr(mx.gluon.rnn, name)(6, num_layers=L, layout=layout,
                                           bidirectional=bi, input_size=4,
                                           prefix="layer_", **kw)

    shape = (T, N, 4) if layout == "TNC" else (N, T, 4)
    rng = np.random.RandomState(3)
    xs = [rng.randn(*shape).astype(np.float32)]
    n_states = 2 if name == "LSTM" else 1
    if explicit:
        xs += [(rng.randn(L * (2 if bi else 1), N, 6) * 0.5).astype(
            np.float32) for _ in range(n_states)]

    def body(net, inputs):
        if not explicit:
            return net(inputs[0]), []
        return net(inputs[0], inputs[1:])

    _compare(make, xs, body)


def test_variational_dropout_cell_moments():
    p, T, N, C = 0.4, 5, 256, 8
    x = np.ones((N, T, C), np.float32)
    for mx in (jmx, tmx):
        mx.random.seed(5)
        with mx.cpu():
            base = mx.gluon.rnn.RNNCell(C, input_size=C, prefix="b_")
            cell = mx.gluon.contrib.rnn.VariationalDropoutCell(
                base, drop_inputs=p, drop_outputs=p)
            cell.collect_params().initialize(mx.init.Uniform(0.3),
                                             ctx=mx.cpu())
            with mx.autograd.record():
                outs, _ = cell.unroll(T, mx.nd.array(x), layout="NTC",
                                      merge_outputs=False)
            masks = {k: v.asnumpy() for k, v in cell._masks.items()}
            assert sorted(masks) == ["inputs", "outputs"]
            se = np.sqrt(p * (1 - p) / (N * C))
            for k, m in masks.items():
                kept = m != 0
                assert abs(kept.mean() - (1 - p)) < 3 * se, (mx, k)
                np.testing.assert_allclose(m[kept], 1 / (1 - p), rtol=1e-6)
            # one mask per sequence: every step is the base cell over the
            # masked input, times the same output mask
            base._modified = False
            ref, _ = base.unroll(T, mx.nd.array(x * masks["inputs"][:, None]),
                                 layout="NTC", merge_outputs=False)
            for o, r in zip(outs, ref):
                np.testing.assert_allclose(
                    o.asnumpy(), r.asnumpy() * masks["outputs"], rtol=1e-5,
                    atol=1e-6)

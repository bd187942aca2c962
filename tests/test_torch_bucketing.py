"""Port parity for ``BucketingModule`` and the RNN language-model path,
on the CPU.

- ``BucketingModule.fit`` over ``BucketSentenceIter``'s three buckets:
  the parameters after each of the first three steps (each in another
  bucket than the one before) against the JAX package's, 1e-5 of each
  tensor's max, from the same ``np.random`` / ``random`` seeds;
- the counterpart of ``tests/test_convergence.py``'s
  ``test_lstm_bucketing_convergence``: perplexity < 2.0 on the port;
- ``examples/rnn/lstm_bucketing.py``, ``examples/rnn/char_rnn.py`` and
  ``examples/bi_lstm_sort/lstm_sort.py`` with ``--smoke``, run on the port
  with only their imports rewritten, each passing its own bar;
- ``bench_all.py``'s ``bench_lstm_ptb`` graph (a 2 x H ``FusedRNNCell``
  LSTM language model through ``Module``) at vocab 50, T 6, batch 4: the
  first step's loss and every gradient against the JAX package's, and the
  fuse report of both packages at that bind and at the bench's size.
"""
import contextlib
import io
import os
import random
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
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


def _sentences(seed, n, lengths, vocab):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start = rng.randint(0, vocab)
        out.append([(start + 3 * t) % vocab
                    for t in range(rng.choice(lengths))])
    return out


def _lm_sym_gen(mx, vocab, hidden=16, embed=8, fused=True):
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        emb = mx.sym.Embedding(data, input_dim=vocab, output_dim=embed,
                               name="embed")
        if fused:
            stack = mx.rnn.FusedRNNCell(hidden, num_layers=1, mode="lstm",
                                        prefix="lstm_")
        else:
            stack = mx.rnn.SequentialRNNCell()
            stack.add(mx.rnn.LSTMCell(hidden, prefix="lstm_l0_"))
        outputs, _ = stack.unroll(seq_len, inputs=emb, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        lab = mx.sym.Reshape(label, shape=(-1,))
        net = mx.sym.SoftmaxOutput(pred, lab, name="softmax",
                                   use_ignore=True, ignore_label=-1)
        return net, ("data",), ("softmax_label",)
    return sym_gen


def _first_steps(mx, fused, steps=3):
    """(bucket keys, params after each step) of ``fit`` on the CPU."""
    np.random.seed(16)     # buckets 7, 4, 10 for the first three steps
    random.seed(16)
    vocab = 12
    with mx.cpu():
        it = mx.rnn.BucketSentenceIter(
            _sentences(1, 60, [4, 7, 10], vocab), batch_size=5,
            buckets=[4, 7, 10], invalid_label=-1)
        mod = mx.mod.BucketingModule(
            _lm_sym_gen(mx, vocab, fused=fused),
            default_bucket_key=it.default_bucket_key, context=mx.cpu())
        seen = []

        def record(param):
            if param.nbatch < steps:
                mod._params_dirty = True
                arg, _ = mod.get_params()
                seen.append((mod._curr_bucket_key,
                             {k: v.asnumpy() for k, v in arg.items()}))

        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
                initializer=mx.init.Xavier(), batch_end_callback=record,
                eval_metric=mx.metric.Perplexity(ignore_label=-1))
        score = dict(mod.score(it, mx.metric.Perplexity(ignore_label=-1)))
    return seen, score["perplexity"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "cells"])
def test_bucketing_fit_first_steps_match_the_jax_package(fused):
    want, want_ppl = _first_steps(jmx, fused)
    got, got_ppl = _first_steps(tmx, fused)
    keys = [k for k, _ in got]
    assert keys == [k for k, _ in want] and len(keys) == 3
    assert keys[0] != keys[1] and keys[1] != keys[2], keys
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            _close(g[name], w[name], what=name)
    assert abs(got_ppl - want_ppl) <= 1e-4 * want_ppl


def test_lstm_bucketing_convergence_on_the_port():
    """tests/test_convergence.py's bar (perplexity < 2.0 on a learnable
    next-token pattern), with its seeds fixed."""
    np.random.seed(0)
    random.seed(0)
    rng = np.random.RandomState(3)
    vocab = 12
    sentences = []
    for _ in range(120):
        start = rng.randint(0, vocab)
        length = rng.choice([8, 12])
        sentences.append([(start + 3 * t) % vocab for t in range(length)])
    with tmx.cpu():
        train = tmx.rnn.BucketSentenceIter(sentences, batch_size=20,
                                           buckets=[8, 12], invalid_label=-1)

        def sym_gen(seq_len):
            net, names, labels = _lm_sym_gen(tmx, vocab, hidden=32,
                                             embed=16)(seq_len)
            return net, names, labels

        mod = tmx.mod.BucketingModule(
            sym_gen, default_bucket_key=train.default_bucket_key,
            context=tmx.cpu())
        mod.fit(train, num_epoch=30, optimizer="adam",
                optimizer_params=(("learning_rate", 0.02),),
                eval_metric=tmx.metric.Perplexity(ignore_label=-1))
        score = dict(mod.score(train, tmx.metric.Perplexity(ignore_label=-1)))
    assert score["perplexity"] < 2.0, score


def test_perplexity_matches_the_jax_package():
    rng = np.random.RandomState(0)
    pred = rng.rand(2, 6, 5).astype(np.float32)
    pred /= pred.sum(-1, keepdims=True)
    label = rng.randint(0, 5, (2, 6)).astype(np.float32)
    label[0, :2] = -1
    out = {}
    for mx in (jmx, tmx):
        for ignore in (-1, None):
            m = mx.metric.create("perplexity", ignore_label=ignore)
            lab = np.where(label < 0, 0, label) if ignore is None else label
            m.update([mx.nd.array(lab, ctx=mx.cpu())],
                     [mx.nd.array(pred, ctx=mx.cpu())])
            out[(mx, ignore)] = (m.get(), m.num_inst)
    for ignore in (-1, None):
        (jn, jv), jc = out[(jmx, ignore)]
        (tn, tv), tc = out[(tmx, ignore)]
        assert jn == tn == "perplexity" and jc == tc
        assert abs(tv - jv) <= 1e-9 * jv


_EXAMPLES = {
    "lstm_bucketing": ("rnn", "lstm_bucketing.py", "final train perplexity"),
    "char_rnn": ("rnn", "char_rnn.py", "CHAR_RNN_OK"),
    "lstm_sort": ("bi_lstm_sort", "lstm_sort.py", "BI_LSTM_SORT_OK"),
}


@pytest.mark.parametrize("name", sorted(_EXAMPLES))
def test_rnn_example_runs_on_the_port(name, monkeypatch):
    folder, fname, marker = _EXAMPLES[name]
    path = os.path.join(_REPO, "examples", folder, fname)
    with open(path) as f:
        src = f.read()
    assert src.count("import mxnet_tpu as mx") == 1
    for old in ("import mxnet_tpu as mx", "from mxnet_tpu.rnn import",
                "from mxnet_tpu.ops.rnn import"):
        src = src.replace(old, old.replace("mxnet_tpu", "mxnet_tpu_torch"))
    assert "mxnet_tpu." not in src and "mxnet_tpu " not in src
    scope = {"__name__": name, "__file__": path}
    monkeypatch.setattr(sys, "path", list(sys.path))
    exec(compile(src, fname, "exec"), scope)
    assert scope["mx"] is tmx
    monkeypatch.setattr(sys, "argv", [fname, "--smoke"])
    np.random.seed(0)
    random.seed(0)
    out = io.StringIO()
    with tmx.cpu(), contextlib.redirect_stdout(out):
        scope["main"]()          # each asserts its own smoke bar
    assert marker in out.getvalue()


def _ptb_module(mx, vocab, T, bs, hidden, layers=2):
    """bench_all.py bench_lstm_ptb's graph, bound by Module on the CPU."""
    stack = mx.rnn.FusedRNNCell(hidden, num_layers=layers, mode="lstm")
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=hidden,
                             name="embed")
    outputs, _ = stack.unroll(T, inputs=embed, merge_outputs=True)
    pred = mx.sym.Reshape(outputs, shape=(-1, hidden))
    pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
    lab = mx.sym.Reshape(label, shape=(-1,))
    net = mx.sym.SoftmaxOutput(pred, lab, name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=[("data", (bs, T))],
             label_shapes=[("softmax_label", (bs, T))])
    return mod


def _ptb(mx, vocab=50, T=6, bs=4, hidden=8):
    """bench_lstm_ptb's first step at a small size."""
    mod = _ptb_module(mx, vocab, T, bs, hidden)
    np.random.seed(1)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.1),))
    rng = np.random.RandomState(0)
    x = rng.randint(0, vocab, (bs, T)).astype(np.float32)
    y = rng.randint(0, vocab, (bs, T)).astype(np.float32)
    with mx.cpu():
        batch = mx.io.DataBatch(data=[mx.nd.array(x)],
                                label=[mx.nd.array(y)])
        mod.forward_backward(batch)
        prob = mod.get_outputs()[0].asnumpy()
        ex = mod._exec_group.execs[0]
        grads = {k: v.asnumpy() for k, v in ex.grad_dict.items()
                 if v is not None}
        arg = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    tgt = y.reshape(-1).astype(int)
    loss = -np.log(prob[np.arange(tgt.size), tgt]).mean()
    return loss, grads, arg, ex


def test_bench_lstm_ptb_graph_first_step_matches_the_jax_package():
    j_loss, j_grads, j_arg, j_ex = _ptb(jmx)
    t_loss, t_grads, t_arg, t_ex = _ptb(tmx)
    assert sorted(t_arg) == sorted(j_arg) == [
        "embed_weight", "lstm_parameters", "pred_bias", "pred_weight"]
    for k in j_arg:        # FusedRNN / Xavier / Uniform under one seed
        np.testing.assert_array_equal(t_arg[k], j_arg[k])
    assert abs(t_loss - j_loss) <= TOL * abs(j_loss)
    assert sorted(t_grads) == sorted(j_grads)
    for k in j_grads:
        assert np.abs(j_grads[k]).max() > 0, k
        _close(t_grads[k], j_grads[k], what="d" + k)
    # the fuse pass carves no region of this graph in either package: the
    # pred FC's consumer is SoftmaxOutput, not an epilogue step; so too at
    # the bench's own size (bound, not run)
    assert t_ex.fused_regions() == [] == j_ex.fused_regions()
    full = [_ptb_module(mx, 10000, 35, 32, 200)._exec_group.execs[0]
            .fused_regions() for mx in (jmx, tmx)]
    assert full == [[], []]

"""Port parity for the fused ``RNN`` op and the symbolic RNN toolkit
(``mx.rnn``): the same numpy inputs go through the JAX package and the
port on the CPU, where the port's op runs its plain version
(``ops.rnn.rnn_reference``).

- the op over modes x layers x directions x ``state_outputs``: outputs,
  final states and the gradients of data, parameters, ``state`` and
  ``state_cell``, 1e-5 of each tensor's max;
- dropout between layers (``p`` > 0): the keep rate within 3 standard
  errors, the output equal to the JAX layers composed around the port's
  mask, and a mirrored step (``MXNET_BACKWARD_DO_MIRROR``) equal to the
  unmirrored one bit for bit;
- shape inference, ``FusedRNNCell.unroll`` / ``unfuse``, pack / unpack,
  every cell kind and the conv cells from the same parameters (random
  cells in inference mode), ``BucketSentenceIter`` / ``encode_sentences``
  batch for batch, the RNN checkpoint files byte for byte and
  ``initializer.FusedRNN`` bit for bit under one ``np.random`` seed.
"""
import os
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import rnn as trnn

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

_GRID = [(mode, L, bi, so)
         for mode in ("rnn_tanh", "rnn_relu", "lstm", "gru")
         for L in (1, 2) for bi in (False, True) for so in (False, True)]


def _close(got, want, tol=TOL, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / scale
    assert err <= tol, "%s: %.3g of max" % (what, err)


def _run(mx, sym, inputs, head_seed=None, is_train=True):
    """Bind on the CPU, forward, and (with ``head_seed``) backward with
    random head gradients: (outputs, {name: gradient})."""
    ex = sym.simple_bind(mx.cpu(), grad_req="write",
                         **{k: v.shape for k, v in inputs.items()})
    for k, v in inputs.items():
        ex.arg_dict[k][:] = v
    outs = [o.asnumpy() for o in ex.forward(is_train=is_train)]
    grads = {}
    if head_seed is not None:
        rng = np.random.RandomState(head_seed)
        ex.backward([mx.nd.array(rng.randn(*o.shape).astype(np.float32),
                                 ctx=mx.cpu()) for o in outs])
        grads = {k: v.asnumpy() for k, v in ex.grad_dict.items()
                 if v is not None}
    return outs, grads


def _rnn_sym(mx, mode, L, bi, so, p=0.0):
    args = [mx.sym.Variable(n) for n in ("data", "parameters", "state")]
    if mode == "lstm":
        args.append(mx.sym.Variable("state_cell"))
    out = mx.sym.RNN(*args, state_size=6, num_layers=L, bidirectional=bi,
                     mode=mode, state_outputs=so, p=p, name="rnn")
    return out if not so else mx.sym.Group(list(out))


def _rnn_inputs(mode, L, bi, T=5, N=3, I=4, H=6, seed=0):
    D = 2 if bi else 1
    rng = np.random.RandomState(seed)
    inputs = {
        "data": rng.randn(T, N, I).astype(np.float32),
        "parameters": (rng.randn(trnn.rnn_param_size(L, H, I, mode, bi))
                       * 0.3).astype(np.float32),
        "state": (rng.randn(L * D, N, H) * 0.5).astype(np.float32)}
    if mode == "lstm":
        inputs["state_cell"] = (rng.randn(L * D, N, H) * 0.5).astype(
            np.float32)
    return inputs


@pytest.mark.parametrize("mode,L,bi,so", _GRID, ids=[
    "%s-L%d-%s-%s" % (m, l, "bi" if b else "uni", "states" if s else "out")
    for m, l, b, s in _GRID])
def test_rnn_op_matches_the_jax_package(mode, L, bi, so):
    inputs = _rnn_inputs(mode, L, bi)
    want = _run(jmx, _rnn_sym(jmx, mode, L, bi, so), inputs, head_seed=1)
    got = _run(tmx, _rnn_sym(tmx, mode, L, bi, so), inputs, head_seed=1)
    assert len(got[0]) == len(want[0]) == (
        1 if not so else (3 if mode == "lstm" else 2))
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g.shape == w.shape
        _close(g, w, what="output %d" % i)
    assert sorted(got[1]) == sorted(want[1]) == sorted(inputs)
    for name in inputs:
        _close(got[1][name], want[1][name], what="d" + name)


def test_rnn_reference_is_what_torch_rnn_computes():
    """The plain version against torch.nn.LSTM / GRU on the CPU (the
    weight mapping cuDNN shares), bidirectional, two layers."""
    for mode, cls in (("lstm", torch.nn.LSTM), ("gru", torch.nn.GRU)):
        inputs = _rnn_inputs(mode, 2, True)
        t = {k: torch.tensor(v) for k, v in inputs.items()}
        out, h, c = trnn.rnn_reference(
            mode, t["data"], t["parameters"], t["state"],
            t.get("state_cell"), num_layers=2, state_size=6,
            bidirectional=True)
        views = trnn._weight_views(t["parameters"], 2, 6, 4, mode, True)
        ref = cls(4, 6, num_layers=2, bidirectional=True)
        with torch.no_grad():
            for flat, v in zip(ref._flat_weights, (w for vs in views
                                                   for w in vs)):
                flat.copy_(v)
            hx = (t["state"], t["state_cell"]) if mode == "lstm" \
                else t["state"]
            r_out, r_h = ref(t["data"], hx)
        _close(out.detach().numpy(), r_out.numpy(), what=mode)
        want_h = r_h[0] if mode == "lstm" else r_h
        _close(h.detach().numpy(), want_h.numpy(), what=mode + " h")


def _dropout_drive(mirror, seed=11):
    """A 2-layer LSTM with p = 0.3 under a weighted sum, one training
    step on the port's CPU executor: (outputs, grads, draw after)."""
    inputs = _rnn_inputs("lstm", 2, False, T=6, N=64, H=6)
    sym = _rnn_sym(tmx, "lstm", 2, False, False, p=0.3)
    from mxnet_tpu_torch.config import set_flag

    set_flag("MXNET_BACKWARD_DO_MIRROR", 1 if mirror else None)
    try:
        tmx.random.seed(seed)
        outs, grads = _run(tmx, sym, inputs, head_seed=2)
        after = tmx.nd.random_uniform(shape=(4,), ctx=tmx.cpu()).asnumpy()
    finally:
        set_flag("MXNET_BACKWARD_DO_MIRROR", None)
    return inputs, outs, grads, after


def test_rnn_dropout_keep_rate_and_kept_units():
    p, seed = 0.3, 11
    inputs, outs, _, _ = _dropout_drive(False, seed)
    # the mask the op drew: the host generator from the same seed
    tmx.random.seed(seed)
    T, N, H = 6, 64, 6
    mask = (torch.rand((T, N, H), generator=tmx.random.generator("cpu"))
            < 1 - p).numpy()
    n = mask.size
    se = np.sqrt(p * (1 - p) / n)
    assert abs(mask.mean() - (1 - p)) < 3 * se, mask.mean()
    # JAX's layers around that mask give the port's output
    weights, biases, _ = trnn._layer_offsets(2, H, 4, "lstm", False)
    flat = inputs["parameters"]

    def layer(i, x):
        (wo, r, c), (ho, hr, hc) = weights[i]
        (io, il), (bo, bl) = biases[i]
        blob = np.concatenate([flat[wo:wo + r * c], flat[ho:ho + hr * hc],
                               flat[io:io + il], flat[bo:bo + bl]])
        out = jmx.nd.RNN(jmx.nd.array(x), jmx.nd.array(blob),
                         jmx.nd.array(inputs["state"][i:i + 1]),
                         jmx.nd.array(inputs["state_cell"][i:i + 1]),
                         state_size=H, num_layers=1, mode="lstm")
        return out.asnumpy()

    first = layer(0, inputs["data"])
    second = layer(1, np.where(mask, first / (1 - p), 0).astype(np.float32))
    _close(outs[0], second, what="output through the mask")


def test_rnn_dropout_mirrored_step_is_bit_identical():
    _, outs, grads, after = _dropout_drive(False)
    _, m_outs, m_grads, m_after = _dropout_drive(True)
    for a, b in zip(outs, m_outs):
        np.testing.assert_array_equal(a, b)
    assert sorted(grads) == sorted(m_grads)
    for k in grads:
        np.testing.assert_array_equal(grads[k], m_grads[k])
    np.testing.assert_array_equal(after, m_after)


def test_rnn_shape_inference_matches_rnn_infer():
    for mode, L, bi, so in _GRID:
        shapes = {}
        for mx in (jmx, tmx):
            data = mx.sym.Variable("data")
            out = mx.sym.RNN(data, mx.sym.Variable("parameters"),
                             mx.sym.Variable("state"),
                             *([mx.sym.Variable("state_cell")]
                               if mode == "lstm" else []),
                             state_size=7, num_layers=L, bidirectional=bi,
                             mode=mode, state_outputs=so)
            shapes[mx] = out.infer_shape(data=(5, 3, 4))
        assert shapes[jmx] == shapes[tmx], (mode, L, bi, so)


def _fill(sym, shapes, seed=0, skip=()):
    """Random values for every argument of ``sym`` given the data shapes."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    vals = {}
    for name, shape in sorted(zip(sym.list_arguments(), arg_shapes)):
        if name not in skip:
            vals[name] = (rng.randn(*shape) * 0.3).astype(np.float32)
    return vals


def _fused_sym(mx, layout, merge, mode="lstm", L=2, bi=True):
    cell = mx.rnn.FusedRNNCell(5, num_layers=L, mode=mode, bidirectional=bi,
                               get_next_state=True, prefix="f_")
    outs, states = cell.unroll(4, mx.sym.Variable("data"), layout=layout,
                               merge_outputs=merge)
    outs = outs if isinstance(outs, list) else [outs]
    return cell, mx.sym.Group(outs + list(states))


@pytest.mark.parametrize("layout,merge", [("NTC", True), ("TNC", True),
                                          ("NTC", False)])
def test_fused_cell_unroll_and_unfuse(layout, merge):
    shape = (3, 4, 2) if layout == "NTC" else (4, 3, 2)
    jcell, jsym = _fused_sym(jmx, layout, merge)
    tcell, tsym = _fused_sym(tmx, layout, merge)
    assert jsym.list_arguments() == tsym.list_arguments()
    vals = _fill(jsym, {"data": shape})
    want = _run(jmx, jsym, vals, head_seed=3)
    got = _run(tmx, tsym, vals, head_seed=3)
    for g, w in zip(got[0], want[0]):
        _close(g, w, what="fused output")
    for k in vals:
        _close(got[1][k], want[1][k], what="d" + k)
    # the unfused stack with the unpacked weights gives the fused output
    stack = tcell.unfuse()
    u_out, _ = stack.unroll(4, tmx.sym.Variable("data"), layout=layout,
                            merge_outputs=True)
    args = stack.pack_weights(tcell.unpack_weights(
        {"f_parameters": vals["f_parameters"]}))
    args["data"] = vals["data"]
    unfused = _run(tmx, u_out, args)[0][0]
    fused = got[0][0] if merge else np.stack(
        got[0][:4], axis=layout.find("T"))
    _close(unfused, fused, what="unfused")


def test_pack_unpack_roundtrip_matches_the_jax_package():
    cells = {
        "fused": lambda mx: mx.rnn.FusedRNNCell(
            8, num_layers=2, mode="gru", bidirectional=True, prefix="g_"),
        "lstm": lambda mx: mx.rnn.LSTMCell(8, prefix="l_"),
        "gru": lambda mx: mx.rnn.GRUCell(8, prefix="r_")}
    rng = np.random.RandomState(5)
    blobs = {"fused": {"g_parameters": rng.rand(
                 trnn.rnn_param_size(2, 8, 4, "gru", True)).astype(
                 np.float32)},
             "lstm": {"l_i2h_weight": rng.rand(32, 4).astype(np.float32),
                      "l_h2h_weight": rng.rand(32, 8).astype(np.float32),
                      "l_i2h_bias": rng.rand(32).astype(np.float32),
                      "l_h2h_bias": rng.rand(32).astype(np.float32)},
             "gru": {"r_i2h_weight": rng.rand(24, 4).astype(np.float32),
                     "r_h2h_weight": rng.rand(24, 8).astype(np.float32),
                     "r_i2h_bias": rng.rand(24).astype(np.float32),
                     "r_h2h_bias": rng.rand(24).astype(np.float32)}}
    for kind, make in cells.items():
        out = {}
        for mx in (jmx, tmx):
            cell = make(mx)
            unpacked = cell.unpack_weights(
                {k: mx.nd.array(v, ctx=mx.cpu())
                 for k, v in blobs[kind].items()})
            packed = cell.pack_weights(unpacked)
            out[mx] = ({k: v.asnumpy() for k, v in unpacked.items()},
                       {k: v.asnumpy() for k, v in packed.items()})
        for j, t in zip(out[jmx], out[tmx]):
            assert sorted(j) == sorted(t), kind
            for k in j:
                np.testing.assert_array_equal(j[k], t[k])
        for k, v in blobs[kind].items():
            np.testing.assert_array_equal(out[tmx][1][k], v)


def _cells(mx, kind):
    r = mx.rnn
    if kind == "rnn_tanh":
        return r.RNNCell(6, prefix="c_")
    if kind == "rnn_relu":
        return r.RNNCell(6, activation="relu", prefix="c_")
    if kind == "lstm":
        return r.LSTMCell(6, prefix="c_", forget_bias=0.5)
    if kind == "gru":
        return r.GRUCell(6, prefix="c_")
    if kind == "sequential":
        s = r.SequentialRNNCell()
        s.add(r.LSTMCell(6, prefix="a_"))
        s.add(r.GRUCell(5, prefix="b_"))
        return s
    if kind == "residual":
        return r.ResidualCell(r.GRUCell(3, prefix="c_"))
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(4, prefix="l_"),
                                   r.GRUCell(4, prefix="r_"))
    if kind == "dropout":
        s = r.SequentialRNNCell()
        s.add(r.RNNCell(6, prefix="a_"))
        s.add(r.DropoutCell(0.4, prefix="d_"))
        s.add(r.RNNCell(6, prefix="b_"))
        return s
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(6, prefix="c_"), 0.3, 0.2)
    raise KeyError(kind)


_RANDOM_CELLS = ("dropout", "zoneout")


@pytest.mark.parametrize("kind", ["rnn_tanh", "rnn_relu", "lstm", "gru",
                                  "sequential", "residual", "bidirectional",
                                  "dropout", "zoneout"])
@pytest.mark.parametrize("merge", [True, False], ids=["merged", "steps"])
def test_cells_match_the_jax_package(kind, merge):
    """Unrolled over 4 steps from the same parameters: outputs and every
    gradient (random cells: the inference forward, where they are the
    identity)."""
    syms = {}
    for mx in (jmx, tmx):
        cell = _cells(mx, kind)
        outs, states = cell.unroll(4, mx.sym.Variable("data"),
                                   merge_outputs=merge)
        outs = outs if isinstance(outs, list) else [outs]
        syms[mx] = mx.sym.Group(outs + list(states))
    assert syms[jmx].list_arguments() == syms[tmx].list_arguments()
    vals = _fill(syms[jmx], {"data": (2, 4, 3)})
    train = kind not in _RANDOM_CELLS
    seed = 4 if train else None
    want = _run(jmx, syms[jmx], vals, head_seed=seed, is_train=train)
    got = _run(tmx, syms[tmx], vals, head_seed=seed, is_train=train)
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        _close(g, w, what="%s output %d" % (kind, i))
    for k in want[1]:
        _close(got[1][k], want[1][k], what="%s d%s" % (kind, k))


@pytest.mark.parametrize("cls", ["ConvRNNCell", "ConvLSTMCell",
                                 "ConvGRUCell"])
def test_conv_cells_match_the_jax_package(cls):
    ishape = (2, 3, 6, 6)
    syms = {}
    for mx in (jmx, tmx):
        cell = getattr(mx.rnn, cls)(input_shape=ishape, num_hidden=4,
                                    prefix="cv_")
        outs, states = cell.unroll(
            3, [mx.sym.Variable("x%d" % t) for t in range(3)])
        syms[mx] = mx.sym.Group(list(outs) + list(states))
    vals = _fill(syms[jmx], {"x%d" % t: ishape for t in range(3)})
    want = _run(jmx, syms[jmx], vals, head_seed=6)
    got = _run(tmx, syms[tmx], vals, head_seed=6)
    for g, w in zip(got[0], want[0]):
        assert g.shape == w.shape
        _close(g, w, what=cls)
    for k in want[1]:
        _close(got[1][k], want[1][k], what="%s d%s" % (cls, k))


def test_begin_state_zeros_take_their_batch_from_inference():
    cell = tmx.rnn.LSTMCell(16, prefix="lstm_")
    outputs, _ = cell.unroll(3, tmx.sym.Variable("data"), merge_outputs=True)
    exe = outputs.simple_bind(tmx.cpu(), data=(8, 3, 4))
    assert exe.forward()[0].shape == (8, 3, 16)
    exe = outputs.simple_bind(tmx.cpu(), data=(5, 3, 4))
    assert exe.forward()[0].shape == (5, 3, 16)


def _corpus(seed=2):
    rng = np.random.RandomState(seed)
    return [[int(v) for v in rng.randint(1, 20, rng.randint(2, 12))]
            for _ in range(90)]


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_the_jax_package(layout):
    runs = []
    for mx in (jmx, tmx):
        np.random.seed(7)
        random.seed(7)
        with mx.cpu():
            it = mx.rnn.BucketSentenceIter(_corpus(), batch_size=5,
                                           buckets=[4, 8, 12],
                                           invalid_label=0, layout=layout)
            seen = []
            for _ in range(2):
                for b in it:
                    seen.append((b.bucket_key, b.data[0].asnumpy(),
                                 b.label[0].asnumpy(),
                                 [(d.name, tuple(d.shape))
                                  for d in b.provide_data
                                  + b.provide_label]))
                it.reset()
        runs.append((seen, it.default_bucket_key,
                     [(d.name, tuple(d.shape)) for d in it.provide_data]))
    assert runs[0][1:] == runs[1][1:]
    assert len(runs[0][0]) == len(runs[1][0]) > 0
    for (jk, jd, jl, jdesc), (tk, td, tl, tdesc) in zip(*[r[0]
                                                          for r in runs]):
        assert jk == tk and jdesc == tdesc
        np.testing.assert_array_equal(jd, td)
        np.testing.assert_array_equal(jl, tl)
        assert jd.dtype == td.dtype


def test_encode_sentences_matches_the_jax_package():
    sents = [["a", "b", "c"], ["b", "c", "d"], ["\n", "e"]]
    for kw in ({}, {"start_label": 1}, {"invalid_label": 0,
                                        "start_label": 0}):
        assert jmx.rnn.encode_sentences(sents, **kw) == \
            tmx.rnn.encode_sentences(sents, **kw)
    vocab = {"a": 1, "b": 2}
    assert jmx.rnn.encode_sentences([["a", "b"]], vocab=vocab) == \
        tmx.rnn.encode_sentences([["a", "b"]], vocab=vocab)
    with pytest.raises(AssertionError):
        tmx.rnn.encode_sentences([["z"]], vocab=vocab)


def test_rnn_checkpoints_are_byte_equal(tmp_path):
    vals = None
    for mx in (jmx, tmx):
        cell = mx.rnn.FusedRNNCell(4, num_layers=2, mode="lstm",
                                   prefix="ck_")
        out, _ = cell.unroll(3, mx.sym.Variable("data"), merge_outputs=True)
        if vals is None:
            vals = _fill(out, {"data": (2, 3, 5)}, skip=("data",))
        args = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in vals.items()}
        prefix = str(tmp_path / ("j" if mx is jmx else "t"))
        mx.rnn.save_rnn_checkpoint(cell, prefix, 3, out, args, {})
        cb = mx.rnn.do_rnn_checkpoint(cell, prefix + "cb", period=2)
        cb(1, out, args, {})
        cb(2, out, args, {})
    for suffix in ("-0003.params", "cb-0002.params"):
        with open(str(tmp_path / ("j" + suffix)), "rb") as f:
            jb = f.read()
        with open(str(tmp_path / ("t" + suffix)), "rb") as f:
            assert f.read() == jb, suffix
    assert not os.path.exists(str(tmp_path / "tcb-0003.params"))
    # each package loads the other's file back into the fused layout
    for mx, src in ((tmx, "j"), (jmx, "t")):
        cell = mx.rnn.FusedRNNCell(4, num_layers=2, mode="lstm",
                                   prefix="ck_")
        _, arg, aux = mx.rnn.load_rnn_checkpoint(
            cell, str(tmp_path / src), 3)
        assert sorted(arg) == ["ck_parameters"] and aux == {}
        np.testing.assert_array_equal(arg["ck_parameters"].asnumpy(),
                                      vals["ck_parameters"])


@pytest.mark.parametrize("mode,bi", [("lstm", False), ("gru", True),
                                     ("rnn_tanh", False)])
def test_fused_rnn_initializer_matches_the_jax_package(mode, bi):
    size = trnn.rnn_param_size(2, 5, 3, mode, bi)
    out = {}
    for mx in (jmx, tmx):
        for inner in (None, mx.init.Uniform(0.2)):
            init = mx.init.FusedRNN(inner, 5, 2, mode, bi, forget_bias=0.7)
            glob = mx.init.Xavier()
            arr = np.zeros((size,), np.float32)
            np.random.seed(3)
            glob(mx.init.InitDesc("rnn_parameters",
                                  attrs={"__init__": init.dumps()},
                                  global_init=glob), arr)
            out[(mx, inner is None)] = arr
    assert tmx.init.FusedRNN(None, 5, 2, mode, bi).dumps() == \
        jmx.init.FusedRNN(None, 5, 2, mode, bi).dumps()
    for glob in (True, False):
        np.testing.assert_array_equal(out[(tmx, glob)], out[(jmx, glob)])
        assert np.abs(out[(tmx, glob)]).max() > 0

"""Port parity: the small modules — ``visualization`` (``print_summary``
text equal to the JAX package's, ``plot_network``), ``contrib``
(the pre-1.0 autograd surface, ``LogMetricsCallback``), the facades
(``attribute``, ``name``, ``registry``, ``fluent``, ``engine``,
``storage``, ``log``, ``libinfo``, ``symbol_doc``) and the counterpart of
``__graft_entry__.entry()`` — against mxnet_tpu."""
import contextlib
import io
import json
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.symbol_doc as jsymbol_doc
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.symbol_doc as tsymbol_doc


def _summary(mx, sym, shape):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        total = mx.visualization.print_summary(sym, shape=shape)
    return total, buf.getvalue()


def _resnet(mx, layers, layout):
    """The model in a fresh naming scope: its auto-named nodes (``flatten0``
    and the like) number from 0 whatever symbols this process built
    before, in either package."""
    with mx.name.NameManager():
        return mx.models.get_resnet(num_layers=layers, layout=layout)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_print_summary_text_equals_the_jax_packages_for_resnet50(layout):
    row = (224, 224, 3) if layout == "NHWC" else (3, 224, 224)
    got = [_summary(mx, _resnet(mx, 50, layout), {"data": (1,) + row})
           for mx in (jmx, tmx)]
    assert got[1][0] == got[0][0]
    assert got[1][1] == got[0][1]
    assert "Total params: %d" % got[1][0] in got[1][1]


def test_print_summary_without_shapes_and_its_errors():
    def net(mx):
        x = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=5,
                                  name="fc")
        x = mx.sym.BatchNorm(x, name="bn")
        return mx.sym.SoftmaxOutput(mx.sym.Embedding(
            x, input_dim=7, output_dim=3, name="emb"), name="out")

    got = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            got.append(_summary(mx, net(mx), None))
    assert got[1] == got[0]
    with pytest.raises(TypeError):
        tmx.viz.print_summary("not a symbol")
    assert tmx.viz is tmx.visualization


def test_plot_network_builds_the_jax_packages_graph():
    pytest.importorskip("graphviz")
    dots = []
    for mx in (jmx, tmx):
        sym = _resnet(mx, 18, "NHWC")
        dots.append(mx.viz.plot_network(
            sym, shape={"data": (1, 32, 32, 3)}, title="r18").source)
    assert dots[1] == dots[0]


def test_contrib_autograd_matches_jax():
    x = np.random.RandomState(0).standard_normal((3, 4)).astype(np.float32)
    out = []
    for mx in (jmx, tmx):
        ag = mx.contrib.autograd

        def f(a, b):
            return (a * b + a).sum()

        grads, loss = ag.grad_and_loss(f)(mx.nd.array(x, ctx=mx.cpu()),
                                          mx.nd.array(x * 2, ctx=mx.cpu()))
        g1 = ag.grad(f, argnum=1)(mx.nd.array(x, ctx=mx.cpu()),
                                  mx.nd.array(x * 2, ctx=mx.cpu()))
        with ag.train_section():
            inside = (mx.autograd.is_training(), mx.autograd.is_recording())
            with ag.test_section():
                nested = mx.autograd.is_training()
        after = mx.autograd.is_training()
        with ag.TrainingStateScope(True):
            scoped = mx.autograd.is_training()
        out.append(([g.asnumpy() for g in grads], float(loss.asnumpy()),
                    g1[0].asnumpy(), inside, nested, after, scoped))
    for got, want in zip(out[1][0], out[0][0]):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=1e-6)
    assert out[1][3:] == out[0][3:] == ((True, True), False, False, True)
    with pytest.raises(AssertionError, match="NDArray"):
        tmx.contrib.autograd.grad_and_loss(lambda a: a)(x)
    assert tmx.contrib.ndarray is tmx.nd.contrib
    assert tmx.contrib.symbol is tmx.sym.contrib


class _Writer:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), step))


def test_log_metrics_callback_writes_the_jax_packages_scalars():
    rows = []
    for mx in (jmx, tmx):
        writer = _Writer()
        cb = mx.contrib.tensorboard.LogMetricsCallback(prefix="train",
                                                       summary_writer=writer)
        metric = mx.metric.create(["acc", "mse"])
        metric.update([mx.nd.array(np.array([0, 1], np.float32),
                                   ctx=mx.cpu())],
                      [mx.nd.array(np.array([[0.9, 0.1], [0.2, 0.8]],
                                            np.float32), ctx=mx.cpu())])
        for _ in range(2):
            cb(mx.model.BatchEndParam(epoch=0, nbatch=0, eval_metric=metric,
                                      locals=None))
        cb(mx.model.BatchEndParam(epoch=0, nbatch=1, eval_metric=None,
                                  locals=None))
        rows.append(writer.rows)
    assert rows[1] == rows[0] and len(rows[1]) == 4


def test_log_metrics_callback_resolves_a_summary_writer(tmp_path,
                                                        monkeypatch):
    """A log directory resolves ``torch.utils.tensorboard``'s
    SummaryWriter (a stand-in module here: the real one imports a large
    stack), else tensorboardX's, else raises ImportError."""
    import sys
    import types

    made = []
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = lambda logdir: made.append(logdir) or _Writer()
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    cb = tmx.contrib.tensorboard.LogMetricsCallback(str(tmp_path))
    assert made == [str(tmp_path)] and isinstance(cb.summary_writer, _Writer)
    for name in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, name, None)   # import fails
    with pytest.raises(ImportError, match="summary_writer="):
        tmx.contrib.tensorboard.LogMetricsCallback(str(tmp_path))


def test_scoping_facades_are_the_base_classes():
    assert tmx.attribute.AttrScope is tmx.AttrScope
    assert tmx.name.NameManager is tmx.NameManager
    assert tmx.name.Prefix is tmx.Prefix
    names = []
    for mx in (jmx, tmx):
        with mx.attribute.AttrScope(ctx_group="dev1"):
            v = mx.sym.var("x")
        with mx.name.Prefix("p_"):
            fc = mx.sym.FullyConnected(v, num_hidden=2)
        names.append((v.attr("ctx_group"), fc.list_arguments()))
    assert names[1] == names[0]


def test_registry_factories_match_jax():
    made = []
    for mx in (jmx, tmx):
        class Base:
            pass

        register = mx.registry.get_register_func(Base, "thing")
        alias = mx.registry.get_alias_func(Base, "thing")
        create = mx.registry.get_create_func(Base, "thing")

        @alias("g2")
        class Gadget(Base):
            def __init__(self, size=1):
                self.size = size

        register(Gadget)
        inst = Gadget(4)
        made.append([type(create(s)).__name__ for s in
                     ("gadget", "G2", '["gadget", {"size": 3}]')] +
                    [create('{"thing": "gadget", "size": 5}').size,
                     create({"thing": "g2", "size": 6}).size,
                     create("gadget", size=7).size, create(inst) is inst])
        with pytest.raises(mx.MXNetError):
            create("nothing")
        with pytest.raises(mx.MXNetError):
            create(inst, 1)
        with pytest.raises(AssertionError):
            register(int)
    assert made[1] == made[0]


def test_fluent_methods_match_jax():
    x = np.random.RandomState(0).uniform(0.1, 1.0, (2, 3)).astype(np.float32)
    calls = [("exp", (), {}), ("log", (), {}), ("sqrt", (), {}),
             ("sum", (), {"axis": 1}), ("transpose", (), {}),
             ("expand_dims", (), {"axis": 0}), ("clip", (0.2, 0.5), {}),
             ("softmax", (), {}), ("tile", (), {"reps": (2, 1)}),
             ("sort", (), {}), ("flip", (), {"axis": 1}),
             ("one_hot", (), {"depth": 3}), ("zeros_like", (), {})]
    for name, a, kw in calls:
        got = getattr(tmx.nd.array(x, ctx=tmx.cpu()), name)(*a, **kw)
        want = getattr(jmx.nd.array(x), name)(*a, **kw)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6,
                                   err_msg=name)
    shapes = []
    for mx in (jmx, tmx):
        s = mx.sym.var("d").exp().sum(axis=1).astype("float16")
        shapes.append(s.infer_type(d="float32")[1])
        with pytest.raises(mx.NotImplementedForSymbol,
                           match="only available in NDArray"):
            mx.sym.var("d").asnumpy()
    assert shapes[1] == shapes[0]
    assert tmx.fluent.NotImplementedForSymbol is tmx.NotImplementedForSymbol


def test_engine_bulk_size_is_recorded():
    prev = tmx.engine.set_bulk_size(4)
    try:
        with tmx.engine.bulk(9):
            assert tmx.engine.set_bulk_size(9) == 9
        assert tmx.engine.set_bulk_size(4) == 4
    finally:
        tmx.engine.set_bulk_size(prev)
    assert prev == jmx.engine._bulk_size == 15


def test_storage_on_the_cpu():
    assert tmx.storage.memory_info(tmx.cpu()) == {}
    assert jmx.storage.memory_info(jmx.cpu()) == {}
    store = tmx.storage.Storage.get()
    assert store is tmx.storage.Storage.get()
    h = store.alloc(64, tmx.cpu())
    assert h.size == 64 and tuple(h.array.shape) == (64,)
    assert str(h.array.device) == "cpu"
    store.free(h)
    assert h.array is None
    with pytest.raises(tmx.MXNetError, match="Context"):
        tmx.storage.memory_info("cpu")


def test_log_libinfo_and_symbol_doc(tmp_path):
    path = str(tmp_path / "run.log")
    logger = tmx.log.get_logger("port_small_modules", filename=path,
                                level=logging.INFO)
    assert tmx.log.get_logger("port_small_modules") is logger
    assert len(logger.handlers) == 1
    logger.info("hello")
    logger.handlers[0].flush()
    with open(path) as f:
        assert "[INFO] hello" in f.read()
    logger.handlers[0].close()
    logger.removeHandler(logger.handlers[0])
    assert tmx.libinfo.__version__ == jmx.libinfo.__version__
    assert all(p.endswith(".so") for p in tmx.libinfo.find_lib_path())
    shapes = [doc.SymbolDoc.get_output_shape(
        mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=3, name="fc"),
        data=(2, 5)) for mx, doc in ((jmx, jsymbol_doc),
                                     (tmx, tsymbol_doc))]
    assert shapes[1] == shapes[0] == {"fc_output": (2, 3)}


def test_graft_entry_forward_matches_the_jax_program():
    """The port's entry, on the CPU at batch 1: its example arguments are
    the JAX entry's seed-0 draws (argument order, normal(0, 0.05); moving
    variances 1; then the uniform data), and its forward through the
    bind's passes (fused regions on the kernel's plain version here)
    matches the JAX package's graph program on the same values."""
    from mxnet_tpu.executor import _GraphProgram
    from mxnet_tpu_torch.graft_entry import entry

    fn, (data, args, aux) = entry(ctx=tmx.cpu(), batch=1)
    sym = jmx.models.get_resnet(num_classes=1000, num_layers=50,
                                layout="NHWC")
    prog = _GraphProgram(sym)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1, 224, 224, 3))
    rng = np.random.RandomState(0)
    want_args = {n: rng.normal(0, 0.05, s).astype(np.float32)
                 for n, s in zip(prog.arg_names, arg_shapes)
                 if n != "data"}
    want_data = rng.uniform(0, 1, (1, 224, 224, 3)).astype(np.float32)
    assert sorted(args) == sorted(want_args)
    for n, v in want_args.items():
        np.testing.assert_array_equal(args[n].asnumpy(), v, err_msg=n)
    np.testing.assert_array_equal(data.asnumpy(), want_data)
    assert all(np.all(v.asnumpy() == (1.0 if n.endswith("var") else 0.0))
               for n, v in aux.items())
    jaux = {n: np.full(s, 1.0 if n.endswith("var") else 0.0, np.float32)
            for n, s in zip(prog.aux_names, aux_shapes)}
    outs, _ = prog._eval(dict(want_args, data=want_data), jaux, (), False)
    got = fn(data, args, aux)
    assert got.shape == (1, 1000)
    np.testing.assert_allclose(got.asnumpy(), np.asarray(outs[0]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(fn(data, args, aux).asnumpy(),
                               got.asnumpy(), rtol=0, atol=0)


def test_public_module_names_of_the_facades_match_jax():
    for name in ("attribute", "name", "registry", "engine", "storage",
                 "log", "symbol_doc", "visualization",
                 "executor_manager", "fluent"):
        jm = __import__("mxnet_tpu." + name, fromlist=["_"])
        tm = __import__("mxnet_tpu_torch." + name, fromlist=["_"])
        assert sorted(getattr(tm, "__all__")) == \
            sorted(getattr(jm, "__all__")), name
    assert sorted(tmx.contrib.autograd.__all__) == \
        sorted(jmx.contrib.autograd.__all__)
    assert json.dumps(sorted(tmx.resilience.__all__)) == \
        json.dumps(sorted(jmx.resilience.__all__))

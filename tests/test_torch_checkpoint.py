"""Port parity: ``nd.save`` / ``nd.load`` in the reference ``.params``
format, the checkpoint pair of ``mx.model``, ``Module``'s checkpoint
methods, the checkpoint callbacks and ``TopKAccuracy``, against mxnet_tpu.

Files must be byte-identical to the JAX package's for the same arrays, and
each package must read the other's. Checkpoints cross in both directions
and compute the same outputs within 1e-5 of max |output| (one forward in
another summation order, with BatchNorm folded where a module binds for
inference only).
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_resnet_train import (BATCH, small_data, small_params,
                                     small_resnet, to_package)

DTYPES = ["float32", "float64", "float16", "uint8", "int32", "int8",
          "int64"]
OUT_TOL = 1e-5


def _arrays(rng):
    """One array per dtype flag, of assorted ranks."""
    out = []
    for i, dt in enumerate(DTYPES):
        shape = [(3,), (2, 5), (2, 1, 3), (4, 2, 2, 1)][i % 4]
        out.append((rng.randn(*shape) * 50).astype(dt))
    return out


def _host(mx, a):
    return mx.nd.array(a, ctx=mx.cpu(), dtype=a.dtype)


@pytest.mark.parametrize("container", ["dict", "list"])
def test_save_is_byte_identical(tmp_path, container):
    arrays = _arrays(np.random.RandomState(0))
    blobs = []
    for mx in (jmx, tmx):
        nds = [_host(mx, a) for a in arrays]
        data = dict(zip(DTYPES, nds)) if container == "dict" else nds
        path = str(tmp_path / ("%s.params" % mx.__name__))
        mx.nd.save(path, data)
        with open(path, "rb") as f:
            blobs.append(f.read())
    assert blobs[1] == blobs[0]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_file(tmp_path, writer):
    arrays = _arrays(np.random.RandomState(1))
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    path = str(tmp_path / "x.params")
    src.nd.save(path, dict(zip(DTYPES, (_host(src, a) for a in arrays))))
    listed = str(tmp_path / "l.params")
    src.nd.save(listed, [_host(src, a) for a in arrays])
    got = dst.nd.load(path)
    assert sorted(got) == sorted(DTYPES)
    for dt, a in zip(DTYPES, arrays):
        assert got[dt].dtype == a.dtype
        np.testing.assert_array_equal(got[dt].asnumpy(), a)
    for g, a in zip(dst.nd.load(listed), arrays):
        np.testing.assert_array_equal(g.asnumpy(), a)


def test_port_loads_into_host_memory(tmp_path):
    path = str(tmp_path / "x.params")
    jmx.nd.save(path, {"w": jmx.nd.array(np.ones((2, 3), np.float32))})
    w = tmx.nd.load(path)["w"]
    assert w.context.device_type == "cpu" and w.shape == (2, 3)


def test_legacy_fixture_loads_the_same():
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "legacy_ndarray.v0")
    j, t = jmx.nd.load(path), tmx.nd.load(path)
    assert type(t) is type(j) and len(t) == len(j) > 0
    for a, b in (zip(j, t) if isinstance(j, list)
                 else ((j[k], t[k]) for k in j)):
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())


def test_legacy_symbol_file_loads_the_same():
    """The checkpoint symbol file of MXNet 0.8 (pre-0.9 JSON attrs)."""
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "save_000800.json")
    j, t = jmx.sym.load(path), tmx.sym.load(path)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs() == ["softmax_output"]
    assert t.infer_shape(data=(4, 10)) == j.infer_shape(data=(4, 10))
    assert t.attr_dict() == j.attr_dict()


def test_npz_archives_load_the_same(tmp_path):
    rng = np.random.RandomState(2)
    named = str(tmp_path / "named.npz")
    listed = str(tmp_path / "listed.npz")
    np.savez(named, w=rng.randn(2, 3).astype(np.float32),
             b=np.arange(4, dtype=np.int64))
    np.savez(listed, **{"__mxlist__%d" % i: rng.randn(i + 1)
                        for i in range(11)})
    for path in (named, listed):
        j, t = jmx.nd.load(path), tmx.nd.load(path)
        assert type(t) is type(j)
        pairs = zip(j, t) if isinstance(j, list) else \
            ((j[k], t[k]) for k in sorted(j))
        for a, b in pairs:
            np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())


def test_unsavable_arrays_raise_as_the_reference(tmp_path):
    path = str(tmp_path / "x.params")
    for mx in (jmx, tmx):
        bf16 = mx.nd.array(np.ones(3, np.float32), ctx=mx.cpu()) \
            .astype("bfloat16")
        with pytest.raises(mx.MXNetError, match="bfloat16 has no reference"):
            mx.nd.save(path, [bf16])
        scalar = mx.nd.array(np.array(1, np.float32), ctx=mx.cpu())
        assert scalar.shape == ()
        with pytest.raises(mx.MXNetError, match="0-d"):
            mx.nd.save(path, [scalar])


def test_sparse_records_are_not_ported(tmp_path):
    """Sparse records (the name is from before they were ported): the
    port loads the JAX package's csr and row_sparse records, values and
    indices bit for bit, and writes them back byte for byte."""
    rng = np.random.RandomState(3)
    dense = rng.randn(6, 4).astype(np.float32) * (rng.rand(6, 4) < 0.4)
    dense[2] = 0
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(jpath, {"c": jmx.nd.sparse.csr_matrix(dense),
                        "r": jmx.nd.sparse.row_sparse_array(dense)})
    got = tmx.nd.load(jpath)
    assert (got["c"].stype, got["r"].stype) == ("csr", "row_sparse")
    want = jmx.nd.load(jpath)
    for k in ("c", "r"):
        np.testing.assert_array_equal(got[k].asnumpy(), dense)
        np.testing.assert_array_equal(got[k].indices.asnumpy(),
                                      want[k].indices.asnumpy())
    np.testing.assert_array_equal(got["c"].indptr.asnumpy(),
                                  want["c"].indptr.asnumpy())
    tmx.nd.save(tpath, got)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


# ------------------------------------------------------------ checkpoints

def _trained(mx, layout="NHWC"):
    """The small ResNet after one batch of ``fit``."""
    args, aux = small_params(small_resnet(jmx, layout), layout)
    x, y = small_data(layout)
    mod = mx.mod.Module(small_resnet(mx, layout), context=mx.cpu())
    pargs, paux = to_package(mx, args, aux)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params=pargs, aux_params=paux)
    return mod, x, y


def _predict(mx, mod, x, y):
    return mod.predict(mx.io.NDArrayIter(x, y, batch_size=BATCH)).asnumpy()


def _params_np(arg, aux):
    out = {"arg:" + k: v.asnumpy() for k, v in arg.items()}
    out.update({"aux:" + k: v.asnumpy() for k, v in aux.items()})
    return out


def test_checkpoint_round_trip(tmp_path):
    mod, _x, _y = _trained(tmx)
    arg, aux = mod.get_params()
    prefix = str(tmp_path / "rn")
    tmx.model.save_checkpoint(prefix, 3, mod.symbol, arg, aux)
    assert os.path.exists(prefix + "-symbol.json")
    sym, arg2, aux2 = tmx.model.load_checkpoint(prefix, 3)
    assert sym.tojson() == mod.symbol.tojson()
    want, got = _params_np(arg, aux), _params_np(arg2, aux2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()


def test_module_load_predicts_as_the_saved_module(tmp_path):
    """The reloaded module binds for inference (BatchNorm folded into the
    convolutions), the trained one predicts through its training bind."""
    mod, x, y = _trained(tmx)
    prefix = str(tmp_path / "rn")
    mod.save_checkpoint(prefix, 1)
    loaded = tmx.mod.Module.load(prefix, 1, context=tmx.cpu())
    loaded.bind(data_shapes=[("data", x.shape)],
                label_shapes=[("softmax_label", y.shape)],
                for_training=False)
    _close(_predict(tmx, loaded, x, y), _predict(tmx, mod, x, y))


def test_save_params_and_optimizer_states_round_trip(tmp_path):
    mod, x, y = _trained(tmx)
    prefix = str(tmp_path / "rn")
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
    assert os.path.exists(prefix + "-0002.states")
    # save_params / load_params into a fresh bind of the same symbol
    fresh = tmx.mod.Module(mod.symbol, context=tmx.cpu())
    fresh.bind(data_shapes=[("data", x.shape)],
               label_shapes=[("softmax_label", y.shape)])
    fresh.init_params(tmx.init.Zero())
    fresh.load_params(prefix + "-0002.params")
    got, want = _params_np(*fresh.get_params()), _params_np(*mod.get_params())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # Module.load(load_optimizer_states=True) restores the momentum
    resumed = tmx.mod.Module.load(prefix, 2, load_optimizer_states=True,
                                  context=tmx.cpu())
    resumed.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
    resumed.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9, "wd": 1e-4})
    assert resumed._updater.get_states() == mod._updater.get_states()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_checkpoints_cross_packages(tmp_path, writer, layout):
    """A checkpoint one package trained and wrote loads in the other and
    computes the same outputs."""
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    mod, x, y = _trained(src, layout)
    prefix = str(tmp_path / "rn")
    mod.save_checkpoint(prefix, 1)
    loaded = dst.mod.Module.load(prefix, 1, context=dst.cpu())
    loaded.bind(data_shapes=[("data", x.shape)],
                label_shapes=[("softmax_label", y.shape)],
                for_training=False)
    want, got = _predict(src, mod, x, y), _predict(dst, loaded, x, y)
    assert want.shape == (BATCH, 10)
    _close(got, want)
    saved = _params_np(*mod.get_params())
    reloaded = _params_np(*loaded.get_params())
    for k in saved:
        np.testing.assert_array_equal(reloaded[k], saved[k])


def test_checkpoint_callbacks_write_every_period(tmp_path):
    do_prefix = str(tmp_path / "do")
    mod_prefix = str(tmp_path / "mod")
    mod = tmx.mod.Module(small_resnet(tmx, "NHWC"), context=tmx.cpu())
    mod_cb = tmx.callback.module_checkpoint(mod, mod_prefix, period=3)
    x, y = small_data("NHWC")
    args, aux = small_params(small_resnet(jmx, "NHWC"), "NHWC")
    pargs, paux = to_package(tmx, args, aux)
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=4,
            optimizer="sgd", arg_params=pargs, aux_params=paux,
            epoch_end_callback=[tmx.callback.do_checkpoint(do_prefix,
                                                           period=2),
                                mod_cb])
    names = sorted(os.listdir(tmp_path))
    assert names == ["do-0002.params", "do-0004.params", "do-symbol.json",
                     "mod-0003.params", "mod-symbol.json"]
    # the last epoch's checkpoint holds the trained parameters
    _sym, arg, aux = tmx.model.load_checkpoint(do_prefix, 4)
    got, want = _params_np(arg, aux), _params_np(*mod.get_params())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------- TopKAccuracy

@pytest.mark.parametrize("top_k", [2, 3, 20])
def test_top_k_accuracy_matches_jax(top_k):
    rng = np.random.RandomState(7)
    batches = [(rng.randint(0, 10, 16).astype(np.float32),
                rng.dirichlet(np.ones(10), 16).astype(np.float32))
               for _ in range(2)]
    got = []
    for mx in (jmx, tmx):
        m = mx.metric.create("top_k_accuracy", top_k=top_k)
        for y, p in batches:
            m.update([mx.nd.array(y, ctx=mx.cpu())],
                     [mx.nd.array(p, ctx=mx.cpu())])
        got.append(m.get())
    assert got[1][0] == got[0][0] == "top_k_accuracy_%d" % top_k
    assert got[1][1] == got[0][1]
    with pytest.raises(AssertionError, match="Accuracy"):
        tmx.metric.TopKAccuracy(top_k=1)

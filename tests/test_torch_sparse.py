"""Port parity: sparse storage (``nd.sparse``) against mxnet_tpu.

Every case of tests/test_sparse.py, the sparse records of
tests/test_backcompat.py, the ``tostype`` case of tests/test_module_parity.py
and the csr slice bounds of tests/test_model_parallel.py run the same
numpy inputs through both packages (the port under ``mx.cpu()``). Index
arrays (``indices``, ``indptr``) and storage types must be equal; values
agree within 1e-5 of the JAX package's max |value| in fp32 (one sum in
another order at most). The lazy optimizers are held to the JAX package
over 3 steps fed by a sparse embedding with repeated ids and
``grad_req="add"``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import sparse_from_jax
from time_limit import time_limit  # noqa: F401

TOL = 1e-5


def _rand_dense(shape, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = rng.uniform(0, 1, shape) < density
    return (d * mask).astype(np.float32)


def _view(x):
    """A result as plain values: a sparse array by its storage type,
    shape, dense values and aux arrays."""
    if hasattr(x, "stype") and x.stype != "default":
        out = {"stype": x.stype, "shape": tuple(x.shape),
               "dense": x.asnumpy(), "indices": x.indices.asnumpy()}
        if x.stype == "csr":
            out["indptr"] = x.indptr.asnumpy()
        return out
    if hasattr(x, "asnumpy"):
        return {"stype": "default", "dense": x.asnumpy()}
    return x


def _plain(x):
    if isinstance(x, (list, tuple)):
        return [_plain(e) for e in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return _view(x)


def _same(got, want, what="result"):
    got, want = _plain(got), _plain(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], "%s[%s]" % (what, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, "%s[%d]" % (what, i))
    elif isinstance(want, np.ndarray) and want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape, what
        scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
        err = float(np.abs(np.asarray(got, np.float64) - want).max()) \
            if want.size else 0.0
        assert err <= TOL * scale, (what, err, scale)
    else:
        assert got == want, (what, got, want)


def _both(body):
    """``body(mx)`` in the JAX package and in the port on the CPU, held
    to each other; the port's result."""
    want = _plain(body(jmx))
    with tmx.cpu():
        got = _plain(body(tmx))
    _same(got, want)
    return got


def test_rsp_creation_roundtrip():
    dense = _rand_dense((6, 4))

    def body(mx):
        sp = mx.nd.sparse
        rsp2 = sp.row_sparse_array((np.ones((2, 3), np.float32), [4, 1]),
                                   shape=(5, 3))
        return [sp.row_sparse_array(dense), rsp2, rsp2.data]

    got = _both(body)
    np.testing.assert_array_equal(got[0]["dense"], dense)
    np.testing.assert_array_equal(got[1]["indices"], [1, 4])


def test_csr_creation_roundtrip():
    import scipy.sparse as sps

    dense = _rand_dense((5, 7), seed=1)
    got = _both(lambda mx: [mx.nd.sparse.csr_matrix(dense),
                            mx.nd.sparse.csr_matrix(dense).data])
    ref = sps.csr_matrix(dense)
    np.testing.assert_array_equal(got[0]["indptr"], ref.indptr)
    np.testing.assert_array_equal(got[0]["indices"], ref.indices)
    np.testing.assert_array_equal(got[1]["dense"], ref.data)


@pytest.mark.parametrize("src", ["default", "row_sparse", "csr"])
def test_cast_storage_all_pairs(src):
    dense = _rand_dense((4, 5), seed=2)
    dense[1] = 0

    def body(mx):
        arr = mx.nd.sparse.cast_storage(mx.nd.array(dense), src)
        return [mx.nd.sparse.cast_storage(arr, dst) for dst in
                ("default", "row_sparse", "csr")] + \
            [mx.nd.cast_storage(arr, "row_sparse"), arr.tostype("csr")]

    for res in _both(body):
        np.testing.assert_array_equal(res["dense"], dense)


def test_zeros_and_setitem():
    def body(mx):
        sp = mx.nd.sparse
        z = sp.zeros("row_sparse", (3, 2))
        z[:] = sp.row_sparse_array(np.ones((3, 2), np.float32))
        zc = sp.zeros("csr", (3, 2))
        zd = sp.zeros("row_sparse", (3, 2))
        zd[:] = np.array([[0, 0], [2, 3], [0, 0]], np.float32)
        return [z, zc, zd, sp.empty("csr", (2, 2)).indptr]

    got = _both(body)
    np.testing.assert_array_equal(got[2]["indices"], [1])


def test_sparse_retain():
    dense = np.zeros((6, 2), np.float32)
    dense[[1, 3, 5]] = [[1, 1], [3, 3], [5, 5]]

    def body(mx):
        rsp = mx.nd.sparse.row_sparse_array(dense)
        return [mx.nd.sparse.sparse_retain(rsp, np.array([3, 5, 4])),
                mx.nd.sparse_retain(rsp, mx.nd.array([1])),
                rsp.retain(np.array([0, 2]))]

    got = _both(body)
    np.testing.assert_array_equal(got[0]["indices"], [3, 5])
    assert got[2]["indices"].size == 0


def test_csr_dot():
    lhs = _rand_dense((4, 6), seed=3)
    rhs = np.random.RandomState(4).uniform(-1, 1, (6, 3)).astype(np.float32)
    rhs_t = np.random.RandomState(5).uniform(-1, 1, (4, 2)) \
        .astype(np.float32)
    vec = np.random.RandomState(6).uniform(-1, 1, 6).astype(np.float32)

    def body(mx):
        sp = mx.nd.sparse
        csr = sp.csr_matrix(lhs)
        out = [sp.dot(csr, mx.nd.array(rhs)),
               sp.dot(csr, mx.nd.array(rhs_t), transpose_a=True),
               sp.dot(csr, mx.nd.array(vec)),
               sp.dot(csr, mx.nd.array(rhs_t[:, 0]), transpose_a=True),
               sp.dot(csr, sp.row_sparse_array(rhs)),
               sp.dot(sp.row_sparse_array(lhs), mx.nd.array(rhs))]
        with pytest.raises(mx.MXNetError):
            sp.dot(csr, mx.nd.array(rhs.T), transpose_b=True)
        return out

    got = _both(body)
    np.testing.assert_allclose(got[0]["dense"], lhs @ rhs, rtol=1e-5,
                               atol=1e-6)
    assert got[1]["stype"] == "row_sparse" and got[1]["shape"] == (6, 2)
    np.testing.assert_array_equal(got[1]["indices"],
                                  np.unique(np.nonzero(lhs)[1]))
    np.testing.assert_allclose(got[1]["dense"], lhs.T @ rhs_t, rtol=1e-5,
                               atol=1e-6)


def test_rsp_add_and_arith():
    def body(mx):
        sp = mx.nd.sparse
        a = sp.row_sparse_array((np.ones((2, 3), np.float32), [0, 2]),
                                shape=(5, 3))
        b = sp.row_sparse_array((2 * np.ones((2, 3), np.float32), [2, 4]),
                                shape=(5, 3))
        c = a + b
        a2 = a.copy()
        a2 += b
        return [c, a * 2, a / 2, -a, a - b, a + mx.nd.ones((5, 3)),
                2 - a, a ** 2, a2, (a == b), c.astype("float64")]

    got = _both(body)
    assert got[0]["stype"] == "row_sparse"
    assert got[1]["stype"] == "row_sparse" and got[4]["stype"] == "default"


def test_square_sum():
    dense = _rand_dense((6, 3), seed=6)

    def body(mx):
        sp = mx.nd.sparse
        rsp = sp.row_sparse_array(dense)
        return [sp.square_sum(rsp), sp.square_sum(rsp, axis=1),
                sp.square_sum(rsp, axis=1, keepdims=True),
                sp.square_sum(rsp, axis=0),
                mx.nd.square_sum(sp.csr_matrix(dense))]

    got = _both(body)
    np.testing.assert_allclose(got[0]["dense"], (dense ** 2).sum(),
                               rtol=1e-5)


_OPTS = [("sgd", {"learning_rate": 0.1}),
         ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
         ("adam", {"learning_rate": 0.01}),
         ("ftrl", {"learning_rate": 0.1}),
         ("sgd", {"learning_rate": 0.1, "wd": 0.01, "clip_gradient": 0.5,
                  "rescale_grad": 2.0})]


@pytest.mark.parametrize("opt_name,kwargs", _OPTS)
def test_sparse_optimizer_matches_dense_on_touched_rows(opt_name, kwargs):
    """The lazy update equals the dense one when every row is touched,
    and leaves untouched rows alone."""
    shape = (6, 4)
    rng = np.random.RandomState(7)
    w0 = rng.uniform(-1, 1, shape).astype(np.float32)
    g0 = rng.uniform(-1, 1, shape).astype(np.float32)

    def body(mx):
        sp = mx.nd.sparse
        opt_d = mx.optimizer.create(opt_name, **kwargs)
        opt_s = mx.optimizer.create(opt_name, **kwargs)
        w_d, w_s = mx.nd.array(w0), mx.nd.array(w0)
        s_d, s_s = opt_d.create_state(0, w_d), opt_s.create_state(0, w_s)
        opt_d.update(0, w_d, mx.nd.array(g0), s_d)
        opt_s.update(0, w_s, sp.row_sparse_array(
            (g0, np.arange(shape[0])), shape=shape), s_s)
        w_lazy = mx.nd.array(w0)
        opt_l = mx.optimizer.create(opt_name, **kwargs)
        s_l = opt_l.create_state(0, w_lazy)
        opt_l.update(0, w_lazy, sp.row_sparse_array((g0[:2], [0, 1]),
                                                    shape=shape), s_l)
        return [w_d, w_s, w_lazy]

    got = _both(body)
    _same(got[1], got[0])
    np.testing.assert_array_equal(got[2]["dense"][2:], w0[2:])
    assert not np.allclose(got[2]["dense"][:2], w0[:2])


_DENSE_FALLBACK = {
    "nag": {"momentum": 0.9, "wd": 0.01},
    "rmsprop": {"gamma1": 0.8, "gamma2": 0.95, "centered": True,
                "wd": 0.01},
    "adagrad": {"eps": 1e-6, "wd": 0.01, "rescale_grad": 2.0},
    "adadelta": {"rho": 0.8, "wd": 0.01},
    "adamax": {"wd": 0.01},
    "nadam": {"wd": 0.01},
    "dcasgd": {"momentum": 0.9, "wd": 0.01},
    "test": {"rescale_grad": 2.0},
}


@pytest.mark.parametrize("opt_name", sorted(_DENSE_FALLBACK))
def test_optimizer_without_lazy_rows_takes_the_dense_gradient(opt_name):
    """An optimizer without a lazy row path updates every row from the
    densified row-sparse gradient: 3 steps of the port fed the row-sparse
    gradient equal 3 steps of the JAX package fed the dense one (its NAG,
    RMSProp and Test refuse a row-sparse gradient). Weight decay and
    momentum make the rows the gradient leaves out move, so a lazy update
    taken by mistake fails."""
    kwargs = _DENSE_FALLBACK[opt_name]
    rng = np.random.RandomState(10)
    w0 = rng.uniform(-1, 1, (6, 4)).astype(np.float32)
    g0 = np.zeros((6, 4), np.float32)
    g0[[1, 4]] = rng.uniform(-1, 1, (2, 4))

    def body(mx):
        opt = mx.optimizer.create(opt_name, learning_rate=0.1, **kwargs)
        w = mx.nd.array(w0)
        state = opt.create_state(0, w)
        for _ in range(3):
            grad = mx.nd.array(g0) if mx is jmx \
                else mx.nd.sparse.row_sparse_array(g0)
            opt.update(0, w, grad, state)
        return [w]

    got = _both(body)
    if opt_name != "test":
        assert not np.allclose(got[0]["dense"][[0, 2, 3, 5]],
                               w0[[0, 2, 3, 5]])


@pytest.mark.parametrize("opt_name,kwargs", _OPTS[:4] + [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
             "multi_precision": True})])
def test_lazy_optimizer_steps_from_embedding_grads(opt_name, kwargs):
    """3 steps of a lazy optimizer fed by a sparse embedding with repeated
    ids, its row_sparse gradient buffer accumulating (``grad_req="add"``)
    across two backward passes a step."""
    vocab, dim = 12, 3
    rng = np.random.RandomState(11)
    w0 = rng.uniform(-1, 1, (vocab, dim)).astype(np.float32)
    ids = [np.array([[1, 3, 3], [7, 1, 3]], np.float32),
           np.array([[0, 0, 5]], np.float32),
           np.array([[11, 3], [3, 2]], np.float32)]
    heads = [rng.uniform(-1, 1, i.shape + (dim,)).astype(np.float32)
             for i in ids]
    dtype = "float16" if kwargs.get("multi_precision") else "float32"

    def body(mx):
        sp = mx.nd.sparse
        opt = mx.optimizer.create(opt_name, **kwargs)
        w = mx.nd.array(w0).astype(dtype)
        w.attach_grad(grad_req="add", stype="row_sparse")
        state = opt.create_state(0, w)
        grads = []
        for i, h in zip(ids, heads):
            for _ in range(2):
                with mx.autograd.record():
                    out = sp.sparse_embedding(mx.nd.array(i), w,
                                              input_dim=vocab,
                                              output_dim=dim)
                out.backward(mx.nd.array(h).astype(dtype))
            grads.append(w.grad.copy())
            opt.update(0, w, w.grad, state)
        return [w.astype("float32"), grads]

    got = _both(body)
    np.testing.assert_array_equal(got[1][0]["indices"], [1, 3, 7])
    np.testing.assert_array_equal(got[1][2]["indices"], [0, 1, 2, 3, 5, 7,
                                                         11])


def test_sparse_embedding_grad():
    vocab, dim = 10, 4
    w0 = np.random.RandomState(8).uniform(-1, 1, (vocab, dim)) \
        .astype(np.float32)

    def body(mx):
        weight = mx.nd.array(w0)
        weight.attach_grad(stype="row_sparse")
        with mx.autograd.record():
            out = mx.nd.sparse.sparse_embedding(
                mx.nd.array(np.array([[1, 3], [3, 7]], np.float32)), weight,
                input_dim=vocab, output_dim=dim)
            loss = out * 2
        loss.backward()
        return [out, weight.grad]

    got = _both(body)
    g = got[1]
    assert g["stype"] == "row_sparse"
    np.testing.assert_array_equal(g["indices"], [1, 3, 7])
    np.testing.assert_allclose(g["dense"][3], 4.0)
    np.testing.assert_allclose(g["dense"][0], 0.0)


@pytest.mark.parametrize("req", ["write", "add"])
def test_sparse_embedding_dense_grad_buffer(req):
    """A row-sparse gradient densifies into a dense buffer."""
    def body(mx):
        weight = mx.nd.array(np.ones((6, 3), np.float32))
        weight.attach_grad(grad_req=req)
        for _ in range(2):
            with mx.autograd.record():
                out = mx.nd.sparse.sparse_embedding(
                    mx.nd.array(np.array([2, 2, 4], np.float32)), weight,
                    input_dim=6, output_dim=3)
            out.backward()
        return weight.grad

    got = _both(body)
    np.testing.assert_allclose(got["dense"][2], 2.0 if req == "write"
                               else 4.0)


def test_kvstore_row_sparse_pull():
    w = np.arange(24, dtype=np.float32).reshape(8, 3)

    def body(mx):
        kv = mx.kv.create("local")
        kv.init("emb", mx.nd.array(w))
        out = mx.nd.sparse.zeros("row_sparse", (8, 3))
        kv.row_sparse_pull("emb", out=out, row_ids=mx.nd.array([5, 2, 5]))
        dense_out = mx.nd.zeros((8, 3))
        kv.row_sparse_pull("emb", out=dense_out, row_ids=mx.nd.array([7]))
        return [out, dense_out]

    got = _both(body)
    np.testing.assert_array_equal(got[0]["indices"], [2, 5])


def test_kvstore_rsp_push():
    def body(mx):
        sp = mx.nd.sparse
        kv = mx.kv.create("local")
        kv.init("w", sp.zeros("row_sparse", (6, 2), dtype="float32"))
        a = sp.row_sparse_array((np.ones((1, 2), np.float32), [1]),
                                shape=(6, 2))
        b = sp.row_sparse_array((np.ones((2, 2), np.float32), [1, 4]),
                                shape=(6, 2))
        kv.push("w", [a, b])
        out = mx.nd.zeros((6, 2))
        kv.pull("w", out=out)
        rsp_out = sp.zeros("row_sparse", (6, 2), dtype="float32")
        kv.pull("w", out=rsp_out)
        return [out, rsp_out]

    got = _both(body)
    assert got[0]["dense"][1, 0] == 2 and got[0]["dense"].sum() == 6


def test_dense_grad_into_rsp_buffer():
    def body(mx):
        w = mx.nd.array(np.ones((4, 3), np.float32))
        w.attach_grad(stype="row_sparse")
        with mx.autograd.record():
            y = w * mx.nd.array(np.array([[2], [0], [1], [3]], np.float32))
        y.backward()
        return w.grad

    got = _both(body)
    np.testing.assert_array_equal(got["indices"], [0, 2, 3])


def test_mp_sgd_rsp_keeps_momentum_and_master():
    shape = (6, 4)
    g_dense = np.zeros(shape, np.float32)
    g_dense[1] = 0.5
    g_dense[4] = -0.25

    def body(mx):
        w16 = mx.nd.array(np.ones(shape, np.float32)).astype(np.float16)
        sgd = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                  multi_precision=True, rescale_grad=1.0)
        state = sgd.create_state(0, w16)
        grad = mx.nd.sparse.row_sparse_array(g_dense)
        for _ in range(3):
            sgd.update(0, w16, grad, state)
        return [w16.astype("float32"), state[0], state[1]]

    got = _both(body)
    ref_w = np.ones(shape, np.float32)
    ref_m = np.zeros(shape, np.float32)
    for _ in range(3):
        rows = [1, 4]
        ref_m[rows] = 0.9 * ref_m[rows] - 0.1 * g_dense[rows]
        ref_w[rows] += ref_m[rows]
    np.testing.assert_allclose(got[2]["dense"], ref_w, rtol=1e-6)


def test_kvstore_rsp_stored_value_with_optimizer():
    dense0 = np.zeros((5, 2), np.float32)
    dense0[0] = 1.0
    dense0[3] = 2.0
    g = np.zeros((5, 2), np.float32)
    g[3] = 0.5

    def body(mx):
        kv = mx.kv.create("local")
        kv.init("w", mx.nd.sparse.row_sparse_array(dense0))
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=1.0,
                                             rescale_grad=1.0))
        kv.push("w", mx.nd.sparse.row_sparse_array(g))
        out = mx.nd.zeros((5, 2))
        kv.pull("w", out=out)
        return out

    got = _both(body)
    np.testing.assert_allclose(got["dense"], dense0 - g, rtol=1e-6)


def test_kvstore_pull_sparse_out_after_densify():
    dense0 = np.zeros((5, 2), np.float32)
    dense0[0] = 1.0
    g = np.zeros((5, 2), np.float32)
    g[3] = 0.5

    def body(mx):
        sp = mx.nd.sparse
        kv = mx.kv.create("local")
        kv.init("w", sp.row_sparse_array(dense0))
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=1.0,
                                             rescale_grad=1.0))
        kv.push("w", sp.row_sparse_array(g))
        out = sp.row_sparse_array(np.zeros((5, 2), np.float32))
        kv.pull("w", out=out)
        out2 = sp.row_sparse_array(np.zeros((5, 2), np.float32))
        kv.row_sparse_pull("w", out=out2, row_ids=mx.nd.array([0, 3]))
        return [out, out2]

    got = _both(body)
    np.testing.assert_allclose(got[0]["dense"], dense0 - g, rtol=1e-6)


def test_row_sparse_pull_out_of_range_raises():
    for mx in (jmx, tmx):
        with mx.cpu():
            kv = mx.kv.create("local")
            kv.init("w", mx.nd.zeros((5, 2)))
            out = mx.nd.sparse.row_sparse_array(np.zeros((5, 2), np.float32))
            for ids in ([1, 99], [-1, 2]):
                with pytest.raises(mx.MXNetError):
                    kv.row_sparse_pull("w", out=out,
                                       row_ids=mx.nd.array(ids))


def test_csr_row_slice():
    dense = _rand_dense((6, 4), seed=9)

    def body(mx):
        csr = mx.nd.sparse.csr_matrix(dense)
        with pytest.raises(mx.MXNetError):
            csr[::2]
        with pytest.raises(mx.MXNetError):
            csr[1]
        return [csr[1:4], csr[:], csr[-2:], csr.slice(2, 5)]

    got = _both(body)
    np.testing.assert_array_equal(got[0]["dense"], dense[1:4])


def test_csr_empty_slice():
    got = _both(lambda mx: mx.nd.sparse.csr_matrix(
        _rand_dense((5, 3), seed=3))[4:2])
    assert got["shape"] == (0, 3) and got["dense"].shape == (0, 3)


def test_csr_slice_bounds():
    for mx in (jmx, tmx):
        with mx.cpu():
            csr = mx.nd.sparse.csr_matrix(np.eye(4, dtype=np.float32))
            for lo, hi in ((0, 10), (-1, 2), (3, 2)):
                with pytest.raises(mx.MXNetError):
                    csr.slice(lo, hi)


def test_binary_sparse_roundtrip(tmp_path):
    """Sparse records written by either package load in both, and the
    port's file equals the JAX package's byte for byte."""
    dense = np.zeros((5, 3), np.float32)
    dense[1] = 1.5
    dense[4] = -2.0
    paths = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        with mx.cpu():
            sp = mx.nd.sparse
            paths[name] = str(tmp_path / ("%s.params" % name))
            mx.nd.save(paths[name], {"r": sp.row_sparse_array(dense),
                                     "c": sp.csr_matrix(dense),
                                     "d": mx.nd.array(dense)})
    with open(paths["j"], "rb") as a, open(paths["t"], "rb") as b:
        assert a.read() == b.read()
    for path in paths.values():
        back = {"j": jmx.nd.load(path), "t": tmx.nd.load(path)}
        _same(back["t"], back["j"])
        assert back["t"]["r"].stype == "row_sparse"
        assert back["t"]["c"].context.device_type == "cpu"
        np.testing.assert_array_equal(back["t"]["c"].asnumpy(), dense)


def test_tostype_fluent():
    x = np.arange(4, dtype=np.float32).reshape(2, 2)
    got = _both(lambda mx: [mx.nd.array(x).tostype("row_sparse"),
                            mx.nd.array(x).tostype("csr")])
    assert isinstance(tmx.nd.array(x, ctx=tmx.cpu()).tostype("row_sparse"),
                      tmx.nd.RowSparseNDArray)
    np.testing.assert_array_equal(got[0]["dense"], x)


def test_sparse_from_jax_carries_values_and_indices():
    dense = _rand_dense((5, 6), seed=12)
    with jmx.cpu():
        src = [jmx.nd.sparse.csr_matrix(dense),
               jmx.nd.sparse.row_sparse_array(dense), jmx.nd.array(dense)]
    for s in src:
        got = sparse_from_jax(s, tmx.cpu())
        assert got.stype == s.stype and got.shape == s.shape
        _same(got, s)


def test_contrib_sparse_embedding_op():
    """``_contrib_SparseEmbedding`` is ``Embedding`` in a graph and in
    ``nd.contrib``: the same rows and the same dense weight gradient."""
    rng = np.random.RandomState(14)
    w0 = rng.randn(9, 4).astype(np.float32)
    ids = np.array([[1, 8, 1], [0, 3, 3]], np.float32)

    def body(mx):
        w = mx.nd.array(w0)
        w.attach_grad()
        with mx.autograd.record():
            out = mx.nd.contrib.SparseEmbedding(
                mx.nd.array(ids), w, input_dim=9, output_dim=4)
        out.backward(mx.nd.array(np.arange(24, dtype=np.float32)
                                 .reshape(2, 3, 4)))
        s = mx.sym.contrib.SparseEmbedding(mx.sym.var("data"),
                                           input_dim=9, output_dim=4)
        exe = s.bind(mx.cpu(), dict(zip(
            s.list_arguments(), [mx.nd.array(ids), mx.nd.array(w0)])))
        return [out, w.grad, exe.forward()[0]]

    got = _both(body)
    np.testing.assert_array_equal(got[0]["dense"], w0[ids.astype(int)])


def test_storage_ops_in_a_graph():
    """The registry's storage ops give the dense values in a bound
    graph: a cast is the identity, retain zeroes the unlisted rows."""
    x = _rand_dense((5, 3), seed=13)

    def body(mx):
        data = mx.sym.var("data")
        idx = mx.sym.var("idx")
        outs = []
        for s in (mx.sym.cast_storage(data, stype="row_sparse"),
                  mx.sym._internal._sparse_retain(data, idx),
                  mx.sym._internal._square_sum(data, axis=1, keepdims=True),
                  mx.sym._internal._square_sum(data)):
            exe = s.bind(mx.cpu(), {"data": mx.nd.array(x),
                                    "idx": mx.nd.array([1, 3])})
            outs.append(exe.forward()[0])
        return outs

    _both(body)

"""Port parity: ``mx.io.LibSVMIter`` against mxnet_tpu (the libsvm cases of
tests/test_io.py), its native parser (``g++`` at first use, into
``mxnet_tpu_torch/_build/native/``) against the Python tokenizer bit for
bit, and examples/sparse/linear_classification.py on the port with only
its imports rewritten, held to its own bar.

Batches must be equal to the JAX package's: indptr, indices, values,
labels and pad, exactly (both parse the same text into float32).
"""
import contextlib
import io
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import native
from time_limit import time_limit  # noqa: F401

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

ROWS = ["1 0:1.5 3:2.0", "0 1:0.5", "2 2:1.0 4:4.0", "1 0:0.5 4:1.0",
        "0 3:3.0"]


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def _batches(it):
    """Every batch of ``it`` as (indptr, indices, values, dense, labels,
    pad)."""
    out = []
    for b in it:
        d = b.data[0]
        assert d.stype == "csr"
        out.append((d.indptr.asnumpy(), d.indices.asnumpy(),
                    d.data.asnumpy(), d.asnumpy(), b.label[0].asnumpy(),
                    b.pad))
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _both(make):
    """The batches of ``make(mx)`` in each package (the port's on the
    CPU), held equal; the port's."""
    want = _batches(make(jmx))
    got = _batches(make(tmx))
    _equal(got, want)
    return got


def test_libsvm_iter(tmp_path):
    path = _write(tmp_path / "train.libsvm", ROWS)
    got = _both(lambda mx: mx.io.LibSVMIter(data_libsvm=path,
                                            data_shape=(5,), batch_size=2))
    np.testing.assert_array_equal(got[0][3], [[1.5, 0, 0, 2.0, 0],
                                              [0, 0.5, 0, 0, 0]])
    assert [b[5] for b in got] == [0, 0, 1]
    it = tmx.io.LibSVMIter(data_libsvm=path, data_shape=(5,), batch_size=2)
    first = it.next()
    assert first.data[0].context.device_type == "cpu"
    for _ in range(2):
        it.next()
    with pytest.raises(StopIteration):
        it.next()
    it.reset()
    np.testing.assert_array_equal(it.next().data[0].asnumpy(), got[0][3])
    assert it.provide_data[0].shape == (2, 5)


@pytest.mark.parametrize("part", [0, 1, 2])
def test_libsvm_iter_parts(tmp_path, part):
    path = _write(tmp_path / "train.libsvm", ROWS)
    _both(lambda mx: mx.io.LibSVMIter(data_libsvm=path, data_shape=(5,),
                                      batch_size=2, num_parts=3,
                                      part_index=part))
    rows = sum(tmx.io.LibSVMIter(data_libsvm=path, data_shape=(5,),
                                 batch_size=2, num_parts=3,
                                 part_index=p)._n_rows for p in range(3))
    assert rows == len(ROWS)  # every row in exactly one part


def test_libsvm_label_file(tmp_path):
    path = _write(tmp_path / "train.libsvm", ROWS)
    lpath = _write(tmp_path / "lab.libsvm",
                   ["0 0:%d" % v for v in (9, 8, 7, 6, 5)])
    got = _both(lambda mx: mx.io.LibSVMIter(
        data_libsvm=path, label_libsvm=lpath, data_shape=(5,),
        batch_size=5))
    np.testing.assert_array_equal(got[0][4], [9, 8, 7, 6, 5])


def test_libsvm_multivalue_labels(tmp_path):
    dpath = _write(tmp_path / "d.libsvm", ["0 %d:1.0" % i for i in range(3)])
    lpath = _write(tmp_path / "l.libsvm", ["0 0:1.0 2:3.0", "0 1:2.0", "0"])
    got = _both(lambda mx: mx.io.LibSVMIter(
        data_libsvm=dpath, label_libsvm=lpath, data_shape=(3,),
        label_shape=(3,), batch_size=2))
    np.testing.assert_array_equal(got[0][4], [[1.0, 0, 3.0], [0, 2.0, 0]])
    _write(lpath, ["0 0:1.0"])
    for mx in (jmx, tmx):
        with pytest.raises(mx.MXNetError):
            mx.io.LibSVMIter(data_libsvm=dpath, label_libsvm=lpath,
                             data_shape=(3,), label_shape=(3,), batch_size=2)


@pytest.mark.parametrize("bad", ["1 0:1.5 x:2", "1 0:1.5 3", "abc 0:1"])
def test_parse_errors_match(tmp_path, bad, monkeypatch):
    path = _write(tmp_path / "bad.libsvm", ["1 0:1.0", bad])
    errors = []
    for mx in (jmx, tmx):
        with pytest.raises(mx.MXNetError) as e:
            mx.io.LibSVMIter(data_libsvm=path, data_shape=(5,), batch_size=1)
        errors.append(str(e.value))
    monkeypatch.setattr(native, "libsvm_lib", lambda: None)
    with pytest.raises(tmx.MXNetError) as e:
        tmx.io.LibSVMIter(data_libsvm=path, data_shape=(5,), batch_size=1)
    errors.append(str(e.value))
    assert errors[0] == errors[1] == errors[2]
    assert errors[0].endswith("bad.libsvm:2")


def test_feature_index_out_of_range(tmp_path):
    path = _write(tmp_path / "d.libsvm", ["1 0:1.0 7:2.0"])
    for mx in (jmx, tmx):
        with pytest.raises(mx.MXNetError, match="7 out of range 5"):
            mx.io.LibSVMIter(data_libsvm=path, data_shape=(5,), batch_size=1)


def _random_file(path, rows, nnz, width, seed):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        cols = np.sort(rng.choice(width, nnz, replace=False))
        vals = rng.uniform(-2, 2, nnz)
        lines.append("%d " % rng.randint(2) + " ".join(
            "%d:%.7g" % (c, v) for c, v in zip(cols, vals)))
    return _write(path, lines)


def test_native_parser_matches_the_python_tokenizer(tmp_path, monkeypatch):
    path = _random_file(tmp_path / "r.libsvm", 300, 7, 5000, 0)
    lib = native.libsvm_lib()
    assert lib is not None, "g++ is present here: the native path"
    assert native.built()["libsvmparse"].startswith(native.BUILD_DIR)
    assert not any(f.endswith(".so")
                   for f in os.listdir(os.path.dirname(native.__file__)))
    for a, b in zip(tio._parse_libsvm_native(lib, path),
                    tio._parse_libsvm_text(path)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    fast = _batches(tmx.io.LibSVMIter(data_libsvm=path, data_shape=(5000,),
                                      batch_size=64))
    monkeypatch.setattr(native, "libsvm_lib", lambda: None)
    _equal(_batches(tmx.io.LibSVMIter(data_libsvm=path, data_shape=(5000,),
                                      batch_size=64)), fast)


def test_linear_classification_example_runs_on_the_port(monkeypatch):
    fname = "linear_classification.py"
    path = os.path.join(_REPO, "examples", "sparse", fname)
    with open(path) as f:
        src = f.read()
    for old in ("import mxnet_tpu as mx", "from mxnet_tpu.ndarray import"):
        assert src.count(old) == 1
        src = src.replace(old, old.replace("mxnet_tpu", "mxnet_tpu_torch"))
    assert "mxnet_tpu." not in src and "mxnet_tpu " not in src
    scope = {"__name__": "linear_classification", "__file__": path}
    monkeypatch.setattr(sys, "path", list(sys.path))
    exec(compile(src, fname, "exec"), scope)
    assert scope["mx"] is tmx
    monkeypatch.setattr(sys, "argv", [fname, "--smoke"])
    out = io.StringIO()
    with tmx.cpu(), contextlib.redirect_stdout(out):
        scope["main"]()          # asserts its own loss bar
    assert "nonzero learned rows" in out.getvalue()

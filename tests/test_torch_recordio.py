"""Port parity for RecordIO: ``.rec`` / ``.idx`` pairs written by either
package read in the other byte for byte, the native reader (``g++`` at
first use, ``mxnet_tpu_torch/_build/native/``) against the pure-Python
one, the threaded prefetcher, the split-record framing and the
image-record packing, on records each test writes in ``tmp_path``.
"""
import os
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import native
from mxnet_tpu_torch import recordio as trio

PACKAGES = {"jax": jmx, "torch": tmx}


def payloads(n=9, seed=0):
    """Records of awkward lengths: empty, unaligned, one over 4 KB."""
    rng = np.random.RandomState(seed)
    sizes = [0, 1, 3, 4, 5, 17, 4099] + list(rng.randint(1, 300, n - 7))
    return [rng.bytes(int(s)) for s in sizes[:n]]


def write_indexed(mx, path, recs):
    w = mx.recordio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i, r in enumerate(recs):
        w.write_idx(i, r)
    w.close()
    return path + ".rec", path + ".idx"


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_records_cross_packages_byte_for_byte(tmp_path, writer, reader):
    recs = payloads()
    rec, idx = write_indexed(PACKAGES[writer], str(tmp_path / writer), recs)
    other, other_idx = write_indexed(PACKAGES[reader],
                                     str(tmp_path / reader), recs)
    with open(rec, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()
    with open(idx) as f, open(other_idx) as g:
        assert f.read() == g.read()
    r = PACKAGES[reader].recordio.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == list(range(len(recs)))
    for i in reversed(range(len(recs))):
        assert r.read_idx(i) == recs[i]
    r.close()
    seq = PACKAGES[reader].recordio.MXRecordIO(rec, "r")
    assert [seq.read() for _ in recs] == recs
    assert seq.read() is None
    seq.close()


def test_native_reader_built_outside_the_sources(tmp_path):
    w = trio.MXRecordIO(str(tmp_path / "a.rec"), "w")
    assert w._lib is not None, "g++ is present here: the native path"
    w.close()
    path = native.built()["recordio"]
    assert path.startswith(native.BUILD_DIR)
    assert not any(f.endswith(".so")
                   for f in os.listdir(os.path.dirname(native.__file__)))


@pytest.mark.parametrize("native_writer", [True, False])
def test_native_and_python_framing_agree(tmp_path, monkeypatch,
                                         native_writer):
    recs = payloads(seed=3)
    paths = {}
    for use_native in (True, False):
        if not use_native:
            monkeypatch.setattr(trio, "_native", lambda: None)
        p = str(tmp_path / ("n" if use_native else "p"))
        paths[use_native] = write_indexed(tmx, p, recs)
        monkeypatch.undo()
    with open(paths[True][0], "rb") as f, open(paths[False][0], "rb") as g:
        assert f.read() == g.read()
    # read the other writer's file through each reader
    rec, idx = paths[native_writer]
    for use_native in (True, False):
        if not use_native:
            monkeypatch.setattr(trio, "_native", lambda: None)
        r = trio.MXIndexedRecordIO(idx, rec, "r")
        assert (r._lib is not None) == use_native
        assert [r.read_idx(k) for k in r.keys] == recs
        r.reset()
        assert [r.read() for _ in recs] == recs and r.read() is None
        r.close()
        monkeypatch.undo()


def test_split_records_read_in_both_packages(tmp_path, monkeypatch):
    # records longer than the piece limit are split begin/middle/end:
    # shrink the limit so a few hundred bytes exercise the framing
    monkeypatch.setattr(trio, "_LEN_MASK", 7)
    monkeypatch.setattr(trio, "_native", lambda: None)
    recs = [b"", b"abc", bytes(range(30)), b"x" * 8]
    path = str(tmp_path / "split.rec")
    w = trio.MXRecordIO(path, "w")
    for r in recs:
        w.write(r)
    w.close()
    monkeypatch.undo()
    for mx in (jmx, tmx):
        r = mx.recordio.MXRecordIO(path, "r")
        assert [r.read() for _ in recs] == recs and r.read() is None
        r.close()
    p = trio.MXRecordIOPrefetcher(path)
    assert [p.read() for _ in recs] == recs and p.read() is None
    p.close()


def test_prefetcher_matches_the_plain_reader(tmp_path):
    recs = payloads(n=40, seed=5)
    rec, _ = write_indexed(tmx, str(tmp_path / "p"), recs)
    p = trio.MXRecordIOPrefetcher(rec, capacity=3)
    assert native.built()["prefetch"] is not None
    for _ in range(2):
        got = []
        while True:
            r = p.read()
            if r is None:
                break
            got.append(r)
        assert got == recs
        p.reset()
    q = pickle.loads(pickle.dumps(p))   # the clone restarts at the start
    assert q.read() == recs[0]
    q.close()
    p.close()
    p.close()


def test_pack_and_unpack_against_the_jax_package():
    for label in (3.0, [1.5, -2.0, 7.25], np.arange(6, dtype=np.float32)):
        header = (0, label, 11, 2)
        s = tmx.recordio.pack(header, b"payload")
        assert s == jmx.recordio.pack(header, b"payload")
        th, tp = tmx.recordio.unpack(s)
        jh, jp = jmx.recordio.unpack(s)
        assert tp == jp == b"payload"
        assert th.flag == jh.flag and th.id == jh.id and th.id2 == jh.id2
        np.testing.assert_array_equal(np.asarray(th.label),
                                      np.asarray(jh.label))


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_bytes_and_unpack_img(fmt):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (13, 21, 3)).astype(np.uint8)
    header = tmx.recordio.IRHeader(0, 4.0, 9, 0)
    s = tmx.recordio.pack_img(header, img, quality=90, img_fmt=fmt)
    assert s == jmx.recordio.pack_img(header, img, quality=90, img_fmt=fmt)
    for iscolor in (-1, 0, 1):
        th, timg = tmx.recordio.unpack_img(s, iscolor)
        jh, jimg = jmx.recordio.unpack_img(s, iscolor)
        np.testing.assert_array_equal(timg, jimg)
        assert th.label == jh.label == 4.0
    if fmt == ".png":
        np.testing.assert_array_equal(tmx.recordio.unpack_img(s)[1], img)
    with pytest.raises(tmx.MXNetError):
        tmx.recordio.pack_img(header, img, img_fmt=".bmp")


def test_reader_errors_and_pickling(tmp_path, monkeypatch):
    with pytest.raises(tmx.MXNetError):
        trio.MXRecordIO(str(tmp_path / "a.rec"), "x")
    with pytest.raises(tmx.MXNetError):
        trio.MXRecordIO(str(tmp_path / "missing.rec"), "r")
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"\x00" * 16)
    monkeypatch.setattr(trio, "_native", lambda: None)
    r = trio.MXRecordIO(str(bad), "r")
    with pytest.raises(tmx.MXNetError, match="magic"):
        r.read()
    r.close()
    monkeypatch.undo()
    rec, idx = write_indexed(tmx, str(tmp_path / "k"), payloads())
    r = trio.MXIndexedRecordIO(idx, rec, "r")
    r.read_idx(3)
    clone = pickle.loads(pickle.dumps(r))   # reopened at the start
    assert clone.keys == r.keys and clone.read_idx(2) == payloads()[2]
    clone.close()
    r.close()

"""Port parity for the iterators of ``mx.io`` beyond ``NDArrayIter``:
``ResizeIter``, ``PrefetchingIter`` (lifecycle included), ``MNISTIter`` on
idx-ubyte files written here (raw and gzipped), ``CSVIter``, and the
``ImageRecordIter`` factory on both backends and under
``MXNET_IO_STREAMING``, each batch for batch against the JAX package's,
bit for bit.
"""
import gzip
import struct
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from time_limit import time_limit  # noqa: F401


def host(b):
    return [(a.asnumpy() if a is not None else None) for a in b]


def collect(it, epochs=2):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((host(b.data), host(b.label or []), int(b.pad or 0)))
    return out


def assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp and len(gd) == len(wd) and len(gl) == len(wl)
        for g, w in zip(gd + gl, wd + wl):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def arrays(n=22):
    rng = np.random.RandomState(2)
    return (rng.rand(n, 3).astype(np.float32),
            rng.randint(0, 4, n).astype(np.float32))


def test_resize_iter():
    x, y = arrays()

    def run(mx):
        it = mx.io.ResizeIter(mx.io.NDArrayIter(x, y, batch_size=4), 9)
        assert it.provide_data[0].shape == (4, 3)
        return collect(it)

    with tmx.cpu():
        got = run(tmx)
    assert_same(got, run(jmx))
    assert len(got) == 18


@pytest.mark.parametrize("n_iters", [1, 2])
def test_prefetching_iter(n_iters):
    x, y = arrays()

    def run(mx):
        inner = [mx.io.NDArrayIter(x + k, y, batch_size=5,
                                   data_name="d%d" % k,
                                   label_name="l%d" % k)
                 for k in range(n_iters)]
        it = mx.io.PrefetchingIter(inner if n_iters > 1 else inner[0],
                                   prefetch_depth=3)
        try:
            names = [d.name for d in it.provide_data]
            return collect(it, epochs=3), names
        finally:
            it.close()

    with tmx.cpu():
        got, gnames = run(tmx)
    want, wnames = run(jmx)
    assert gnames == wnames
    assert_same(got, want)


def test_prefetching_iter_rename_and_state():
    x, y = arrays()
    with tmx.cpu():
        it = tmx.io.PrefetchingIter(
            [tmx.io.NDArrayIter(x, y, batch_size=4)],
            rename_data=[{"data": "img"}],
            rename_label=[{"softmax_label": "lab"}])
    assert [d.name for d in it.provide_data] == ["img"]
    assert [d.name for d in it.provide_label] == ["lab"]
    assert it.get_state() is None      # NDArrayIter has no position yet
    it.skip_batches(2)
    assert sum(1 for _ in it) == 4
    with pytest.raises(tmx.MXNetError):
        it.set_state({"children": [None, None], "delivered": 0})
    it.close()


def test_prefetching_close_is_idempotent_under_a_concurrent_reset():
    x = np.random.rand(64, 3).astype(np.float32)
    with tmx.cpu():
        it = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(x, None,
                                                       batch_size=8))
    stop, errors = threading.Event(), []

    def resetter():
        while not stop.is_set():
            try:
                it.reset()
            except tmx.MXNetError:
                return
            except Exception as err:  # pragma: no cover
                errors.append(err)
                return

    t = threading.Thread(target=resetter)
    t.start()
    time.sleep(0.05)
    it.close()
    it.close()
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive() and not errors
    with pytest.raises(tmx.MXNetError):
        it.next()


def test_prefetching_close_unwedges_a_racing_next():
    x = np.random.rand(400, 3).astype(np.float32)
    with tmx.cpu():
        it = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(x, None,
                                                       batch_size=4))
    outcome = []

    def consumer():
        try:
            while True:
                it.next()
        except (StopIteration, tmx.MXNetError) as err:
            outcome.append(err)

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.02)
    it.close()
    t.join(timeout=10)
    assert not t.is_alive() and outcome


def write_idx_ubyte(path, arr, gz=False):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(flat=True),
                                dict(shuffle=False),
                                dict(input_shape=(28, 28), seed=4)],
                         ids=["default", "flat", "unshuffled", "shape"])
def test_mnist_iter_from_idx_files(tmp_path, gz, kw):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (45, 28, 28))
    labels = rng.randint(0, 10, 45)
    suffix = ".gz" if gz else ""
    write_idx_ubyte(str(tmp_path / "img") + suffix, images, gz)
    write_idx_ubyte(str(tmp_path / "lab") + suffix, labels, gz)
    img, lab = str(tmp_path / "img"), str(tmp_path / "lab")
    np.testing.assert_array_equal(
        tmx.io._read_idx_ubyte(img + suffix),
        jmx.io._read_idx_ubyte(img + suffix))

    def run(mx):
        return collect(mx.io.MNISTIter(image=img, label=lab, batch_size=10,
                                       **kw))

    assert_same(run(tmx), run(jmx))
    with pytest.raises(tmx.MXNetError, match="not found"):
        tmx.io.MNISTIter(image=str(tmp_path / "nope"), label=lab)


def test_csv_iter(tmp_path):
    rng = np.random.RandomState(3)
    data = rng.rand(17, 6).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", np.arange(17), delimiter=",")

    def run(mx, label):
        it = mx.io.CSVIter(data_csv=str(tmp_path / "d.csv"),
                           data_shape=(2, 3), batch_size=5,
                           label_csv=(str(tmp_path / "l.csv") if label
                                      else None))
        return collect(it)

    for label in (True, False):
        got = run(tmx, label)
        assert_same(got, run(jmx, label))
        assert len(got) == 6 and got[0][0][0].shape == (5, 2, 3)


def make_rec(tmp_path, n=26, size=20, idx=True, fmt=".jpg"):
    rng = np.random.RandomState(0)
    rec = str(tmp_path / "data.rec")
    rio = tmx.recordio
    w = (rio.MXIndexedRecordIO(str(tmp_path / "data.idx"), rec, "w") if idx
         else rio.MXRecordIO(rec, "w"))
    for i in range(n):
        img = rng.randint(0, 255, (size, size + 3, 3)).astype(np.uint8)
        s = rio.pack_img(rio.IRHeader(0, [float(i), float(i % 3)], i, 0),
                         img, img_fmt=fmt, quality=90)
        w.write_idx(i, s) if idx else w.write(s)
    w.close()
    return rec


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("kw", [
    dict(), dict(shuffle=True, seed=4, label_width=2),
    dict(mean_r=120.0, mean_g=115.0, mean_b=100.0, std_r=60.0, std_g=58.0,
         std_b=57.0, resize=18),
    dict(num_parts=2, part_index=1, preprocess_threads=2,
         prefetch_buffer=1)],
    ids=["plain", "shuffled-width2", "normalized", "shard"])
def test_image_record_iter_matches_the_jax_package(tmp_path, streaming, kw):
    rec = make_rec(tmp_path)
    args = dict(path_imgrec=rec, data_shape=(3, 16, 16), batch_size=6, **kw)
    if streaming:
        args["decode_backend"] = "thread"   # the process one: streaming tests
        args.setdefault("preprocess_threads", 2)
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(streaming=streaming, **args)
    assert type(it).__name__ == ("StreamingIter" if streaming
                                 else "PrefetchingIter")
    got = collect(it)
    it.close()
    args.pop("decode_backend", None)
    ref = jmx.io.ImageRecordIter(streaming=False, **args)
    want = collect(ref)
    ref.close()
    assert_same(got, want)
    assert got[0][1][0].shape == ((6,) if "label_width" not in kw else (6, 2))


def test_streaming_flag_and_its_degrade_rule(tmp_path, monkeypatch, caplog):
    rec = make_rec(tmp_path, n=8, idx=False)
    monkeypatch.setenv("MXNET_IO_STREAMING", "1")
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(rec, (3, 16, 16), 4)
    assert type(it).__name__ == "PrefetchingIter"
    assert "MXNET_IO_STREAMING=1 ignored" in caplog.text
    assert type(it.iters[0].imgrec).__name__ == "MXRecordIOPrefetcher"
    got = collect(it)
    it.close()
    assert_same(got, collect(jmx.io.ImageRecordIter(rec, (3, 16, 16), 4)))
    with pytest.raises(tmx.MXNetError, match=".idx"):
        with tmx.cpu():
            tmx.io.ImageRecordIter(rec, (3, 16, 16), 4, streaming=True)
    tmx.config.set_flag("MXNET_IO_STREAMING", 0)
    try:
        with tmx.cpu():
            it = tmx.io.ImageRecordIter(rec, (3, 16, 16), 4)
        assert type(it).__name__ == "PrefetchingIter"
        it.close()
    finally:
        tmx.config.set_flag("MXNET_IO_STREAMING", None)
    assert tmx.config.get_flag("MXNET_IO_PREFETCH_DEPTH") == \
        jmx.config.get_flag("MXNET_IO_PREFETCH_DEPTH") == 2


def test_mx_data_iter_alias():
    assert tmx.io.MXDataIter is tmx.io.DataIter
    x, y = arrays()
    assert isinstance(tmx.io.NDArrayIter(x, y), tmx.io.MXDataIter)
    assert tmx.io.StreamingIter is tmx.runtime.StreamingIter

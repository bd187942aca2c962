"""Port parity for ``gluon.data.vision`` and ``RecordFileDataset``: MNIST /
FashionMNIST (idx-ubyte, raw and gzipped), CIFAR10 and CIFAR100 (binary
batches) from files written here under ``root`` (nothing is downloaded; a
missing file raises and names itself), ``ImageRecordDataset``,
``ImageFolderDataset`` over JPEG / PNG / ``.npy`` folders,
``SyntheticImageDataset``, and the port's ``DataLoader`` over
``ImageRecordDataset``, each against the JAX package's, bit for bit.
"""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from time_limit import time_limit  # noqa: F401


def np_of(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def assert_items_equal(tds, jds, idxs=None):
    assert len(tds) == len(jds)
    for i in (idxs if idxs is not None else range(len(jds))):
        t, j = tds[i], jds[i]
        assert len(t) == len(j)
        for a, b in zip(t, j):
            a, b = np_of(a), np_of(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def write_idx(path, arr, gz=False):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("train,gz", [(True, False), (False, True)])
def test_mnist_family_from_local_files(tmp_path, cls, train, gz):
    rng = np.random.RandomState(0)
    stem = ("train" if train else "t10k")
    suffix = ".gz" if gz else ""
    write_idx(str(tmp_path / (stem + "-images-idx3-ubyte")) + suffix,
              rng.randint(0, 256, (11, 28, 28)), gz)
    write_idx(str(tmp_path / (stem + "-labels-idx1-ubyte")) + suffix,
              rng.randint(0, 10, 11), gz)
    j = getattr(jmx.gluon.data.vision, cls)(root=str(tmp_path), train=train)
    with tmx.cpu():
        t = getattr(tmx.gluon.data.vision, cls)(root=str(tmp_path),
                                                train=train)
    assert_items_equal(t, j)
    assert np_of(t[0][0]).shape == (28, 28, 1)
    with pytest.raises(tmx.MXNetError, match="not found"):
        with tmx.cpu():
            getattr(tmx.gluon.data.vision, cls)(root=str(tmp_path),
                                                train=not train)


def test_cifar10_and_cifar100_from_local_files(tmp_path):
    rng = np.random.RandomState(1)
    for i in range(1, 6):
        rows = rng.randint(0, 256, (3, 3073)).astype(np.uint8)
        rows[:, 0] %= 10
        rows.tofile(str(tmp_path / ("data_batch_%d.bin" % i)))
    rows = rng.randint(0, 256, (4, 3074)).astype(np.uint8)
    rows.tofile(str(tmp_path / "train.bin"))
    with tmx.cpu():
        t10 = tmx.gluon.data.vision.CIFAR10(root=str(tmp_path))
        t100 = [tmx.gluon.data.vision.CIFAR100(root=str(tmp_path),
                                               fine_label=f)
                for f in (False, True)]
    assert_items_equal(t10, jmx.gluon.data.vision.CIFAR10(root=str(tmp_path)))
    for f, t in zip((False, True), t100):
        assert_items_equal(t, jmx.gluon.data.vision.CIFAR100(
            root=str(tmp_path), fine_label=f))
    assert t100[1][2][1] == rows[2, 1]
    with pytest.raises(tmx.MXNetError, match="test_batch.bin"):
        with tmx.cpu():
            tmx.gluon.data.vision.CIFAR10(root=str(tmp_path), train=False)


def write_rec(tmp_path, n=10):
    rng = np.random.RandomState(2)
    rec = str(tmp_path / "imgs.rec")
    w = tmx.recordio.MXIndexedRecordIO(str(tmp_path / "imgs.idx"), rec, "w")
    for i in range(n):
        img = rng.randint(0, 255, (10, 12, 3)).astype(np.uint8)
        w.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i % 3), i, 0), img,
            img_fmt=".jpg" if i % 2 else ".png", quality=90))
    w.close()
    return rec


def test_record_file_dataset(tmp_path):
    rec = write_rec(tmp_path)
    t = tmx.gluon.data.RecordFileDataset(rec)
    j = jmx.gluon.data.RecordFileDataset(rec)
    assert len(t) == len(j) == 10
    assert [t[i] for i in range(10)] == [j[i] for i in range(10)]
    bare = tmx.recordio.MXRecordIO(str(tmp_path / "bare.rec"), "w")
    bare.write(b"x")
    bare.close()
    with pytest.raises(tmx.MXNetError, match="idx"):
        tmx.gluon.data.RecordFileDataset(str(tmp_path / "bare.rec"))


@pytest.mark.parametrize("flag", [0, 1])
def test_image_record_dataset_and_its_loader(tmp_path, flag):
    rec = write_rec(tmp_path)
    tds = tmx.gluon.data.vision.ImageRecordDataset(rec, flag=flag)
    jds = jmx.gluon.data.vision.ImageRecordDataset(rec, flag=flag)
    assert_items_equal(tds, jds)

    def batches(mx, ds, **kw):
        np.random.seed(3)
        return [[np_of(x) for x in b]
                for b in mx.gluon.data.DataLoader(ds, batch_size=4, **kw)]

    trans = (lambda d, l: (np.asarray(d, np.float32) / 255, l))
    for kw in (dict(), dict(shuffle=True, last_batch="discard"),
               dict(num_workers=2)):
        # the reference is the JAX package's serial loader: its threaded
        # one shares an unlocked reader between threads and now and then
        # reads another record, or None (ROADMAP.md Queue C)
        serial = {k: v for k, v in kw.items() if k != "num_workers"}
        want = batches(jmx, jmx.gluon.data.vision.ImageRecordDataset(
            rec, flag=flag, transform=trans), **serial)
        with tmx.cpu():
            got = batches(tmx, tmx.gluon.data.vision.ImageRecordDataset(
                rec, flag=flag, transform=trans), **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_image_folder_dataset(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(4)
    for k, cat in enumerate(("cats", "dogs", "owls")):
        (tmp_path / cat).mkdir()
        for i in range(3):
            arr = rng.randint(0, 255, (8, 9, 3)).astype(np.uint8)
            if (i + k) % 3 == 0:
                Image.fromarray(arr).save(str(tmp_path / cat / ("%d.jpg" % i)),
                                          quality=90)
            elif (i + k) % 3 == 1:
                Image.fromarray(arr).save(str(tmp_path / cat / ("%d.png" % i)))
            else:
                np.save(str(tmp_path / cat / ("%d.npy" % i)),
                        arr.astype(np.float32))
        (tmp_path / cat / "notes.txt").write_text("skip me")
    (tmp_path / "stray.txt").write_text("not a category")
    j = jmx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    with tmx.cpu():
        t = tmx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
        assert t.synsets == j.synsets == ["cats", "dogs", "owls"]
        assert t.items == j.items and len(t) == 9
        assert_items_equal(t, j)


def test_synthetic_image_dataset():
    j = jmx.gluon.data.vision.SyntheticImageDataset(num_samples=20, seed=5)
    with tmx.cpu():
        t = tmx.gluon.data.vision.SyntheticImageDataset(num_samples=20,
                                                        seed=5)
    assert_items_equal(t, j)


def test_record_file_dataset_reads_from_many_threads(tmp_path):
    """The DataLoader's thread pool indexes one dataset from several
    threads: each item's seek and read on the shared reader go together,
    so every thread reads the records the JAX package's dataset returns
    (unlocked, a seek of one thread lands between another's seek and
    read, and ``unpack`` meets None). A pickled copy (process workers)
    reads alike."""
    import pickle
    import threading

    rec = write_rec(tmp_path, n=24)
    want = [jmx.gluon.data.RecordFileDataset(rec)[i] for i in range(24)]
    ds = tmx.gluon.data.RecordFileDataset(rec)
    errors = []

    def reader(seed):
        rng = np.random.RandomState(seed)
        try:
            for i in rng.randint(0, 24, 400):
                assert ds[i] == want[i]
        except BaseException as err:   # reported on the test's thread
            errors.append(err)

    threads = [threading.Thread(target=reader, args=(k,), daemon=True)
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    clone = pickle.loads(pickle.dumps(ds))
    assert [clone[i] for i in range(24)] == want

"""Port parity for the detection image pipeline (``mx.image.detection``):
each ``Det*Aug`` and the ``CreateMultiRandCropAugmenter`` /
``CreateDetAugmenter`` chains under the same ``random`` / ``np.random``
seeds, and ``ImageDetIter`` / ``ImageDetRecordIter`` batches (images and
the padded variable-box labels) against the JAX package's, bit for bit,
on a VOC-style record file written here.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.image import detection as tdet


def label_vec(objects, header=(2, 6)):
    flat = [float(header[0]), float(header[1])]
    for row in objects:
        flat.extend(float(v) for v in row)
    return np.array(flat, dtype=np.float32)


def write_det_rec(tmp_path, n=14, size=32, idx=True):
    rng = np.random.RandomState(3)
    rec = str(tmp_path / "det.rec")
    rio = tmx.recordio
    w = (rio.MXIndexedRecordIO(str(tmp_path / "det.idx"), rec, "w") if idx
         else rio.MXRecordIO(rec, "w"))
    most = 0
    for i in range(n):
        img = rng.randint(0, 255, (size, size + 4, 3)).astype(np.uint8)
        objs = []
        for _ in range(rng.randint(1, 5)):
            x1, y1 = rng.uniform(0, 0.5, 2)
            bw, bh = rng.uniform(0.2, 0.45, 2)
            objs.append([rng.randint(0, 3), x1, y1, min(1.0, x1 + bw),
                         min(1.0, y1 + bh), 0.0])
        most = max(most, len(objs))
        s = rio.pack_img(rio.IRHeader(0, label_vec(objs), i, 0), img,
                         quality=90)
        w.write_idx(i, s) if idx else w.write(s)
    w.close()
    return rec, most


def both(fn, seed=5):
    out = []
    for mx in (jmx, tmx):
        random.seed(seed)
        np.random.seed(seed)
        out.append(fn(mx))
    return out


def sample():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (40, 50, 3)).astype(np.uint8)
    label = np.array([[0, 0.1, 0.2, 0.5, 0.6, 0.0],
                      [2, 0.4, 0.3, 0.9, 0.95, 0.0],
                      [1, 0.05, 0.6, 0.3, 0.9, 0.0]], np.float32)
    return img, label


AUGS = [
    ("DetHorizontalFlipAug", lambda mx: mx.image.DetHorizontalFlipAug(0.5)),
    ("DetRandomCropAug", lambda mx: mx.image.DetRandomCropAug(
        min_object_covered=0.3, area_range=(0.1, 1.0))),
    ("DetRandomPadAug", lambda mx: mx.image.DetRandomPadAug(
        area_range=(1.0, 2.5))),
    ("DetBorrowAug", lambda mx: mx.image.DetBorrowAug(
        mx.image.BrightnessJitterAug(0.3))),
    ("DetRandomSelectAug", lambda mx: mx.image.DetRandomSelectAug(
        [mx.image.DetHorizontalFlipAug(1.0),
         mx.image.DetRandomPadAug(area_range=(1.0, 2.0))], skip_prob=0.3)),
    ("CreateMultiRandCropAugmenter",
     lambda mx: mx.image.CreateMultiRandCropAugmenter(
         min_object_covered=[0.1, 0.5], aspect_ratio_range=(0.75, 1.33),
         area_range=[(0.1, 1.0), (0.3, 1.0)], skip_prob=0.2)),
]


@pytest.mark.parametrize("name,make", AUGS, ids=[a[0] for a in AUGS])
def test_each_detection_augmenter_matches(name, make):
    img, label = sample()

    def run(mx):
        aug = make(mx)
        outs = [aug(img.copy(), label.copy()) for _ in range(12)]
        return outs, aug.dumps()

    (a, da), (b, db) = both(run)
    assert da == db
    for (ai, al), (bi, bl) in zip(a, b):
        assert np.asarray(ai).dtype == np.asarray(bi).dtype
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(al, bl)


@pytest.mark.parametrize("kw", [
    dict(), dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True),
    dict(resize=36, rand_gray=0.3, mean=True, std=True, brightness=0.1,
         contrast=0.1, saturation=0.1, hue=0.1, pca_noise=0.1)],
    ids=["default", "crop-pad-mirror", "photometric"])
def test_create_det_augmenter_chain_matches(kw):
    img, label = sample()

    def run(mx):
        chain = mx.image.CreateDetAugmenter((3, 24, 24), **kw)
        outs = []
        for _ in range(6):
            x, y = img, label
            for aug in chain:
                x, y = aug(x, y)
            outs.append((x, y))
        return outs, [str(a.dumps()) for a in chain]

    (a, da), (b, db) = both(run)
    assert da == db
    for (ai, al), (bi, bl) in zip(a, b):
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(al, bl)
        assert ai.shape == (24, 24, 3) and ai.dtype == np.float32


def collect(it, epochs=2):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                        int(b.pad or 0)))
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(shuffle=True, rand_crop=0.5, rand_pad=0.5,
                 rand_mirror=True),
    dict(preprocess_threads=3), dict(num_parts=2, part_index=1)],
    ids=["plain", "random", "pool", "shard"])
def test_image_det_iter_matches_the_jax_package(tmp_path, kw):
    rec, most = write_det_rec(tmp_path)

    def run(mx):
        it = mx.image.ImageDetIter(batch_size=4, data_shape=(3, 24, 24),
                                   path_imgrec=rec, **kw)
        try:
            return collect(it), it.label_shape, it.provide_label
        finally:
            it.close()

    random.seed(2)
    np.random.seed(2)
    want, wshape, wprov = run(jmx)
    random.seed(2)
    np.random.seed(2)
    with tmx.cpu():
        got, gshape, gprov = run(tmx)
    assert gshape == wshape == (most, 6)
    assert [tuple(d.shape) for d in gprov] == [tuple(d.shape) for d in wprov]
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        real = gl[gl[..., 0] >= 0]
        assert (real[:, 1:5] >= 0).all() and (real[:, 1:5] <= 1).all()


def test_det_record_iter_factory_and_label_shapes(tmp_path):
    rec, most = write_det_rec(tmp_path, idx=False)

    def run(mx):
        # serial decode: a pool's threads draw the random augmenters'
        # numbers in the order they run, in either package
        it = mx.io.ImageDetRecordIter(rec, (3, 24, 24), 4, rand_crop=1,
                                      rand_pad=1, rand_mirror=True,
                                      label_pad_width=most + 2,
                                      preprocess_threads=0)
        return it, collect(it, 1)

    random.seed(4)
    np.random.seed(4)
    jit, want = run(jmx)
    random.seed(4)
    np.random.seed(4)
    with tmx.cpu():
        tit, got = run(tmx)
    assert type(tit.imgrec).__name__ == "MXRecordIOPrefetcher"
    assert tit.provide_label[0].shape == (4, most + 2, 6)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    with pytest.raises(ValueError):
        tit.reshape(label_shape=(1, 6))
    with tmx.cpu():
        other = tdet.ImageDetIter(batch_size=2, data_shape=(3, 24, 24),
                                  path_imgrec=rec)
    assert tit.sync_label_shape(other) == (most + 2, 6)
    assert other.label_shape == (most + 2, 6)
    with pytest.raises(RuntimeError):
        other._parse_label(np.zeros(3, np.float32))

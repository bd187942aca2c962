"""Port parity for ``mx.image``: decode, resize and crops, every augmenter
(the deterministic ones exactly; the random ones under the same
``random`` / ``np.random`` seeds, draw for draw), ``CreateAugmenter`` and
``ImageIter`` batches against the JAX package's ``ImageIter``, bit for bit:
both packages decode with PIL and augment in numpy, so the same bytes in
give the same pixels out. Shuffled epochs come from a seed, and a run
resumed through ``get_state`` / ``set_state`` continues the same stream,
also from the other package's state.
"""
import io
import json
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PACKAGES = (jmx, tmx)


def encoded(fmt="JPEG", shape=(27, 35, 3), seed=0, mode="RGB"):
    from PIL import Image

    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 255, shape).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr if mode == "RGB" else arr[..., 0]).save(
        buf, format=fmt, quality=90)
    return buf.getvalue()


def make_rec(mx, tmp_path, n=21, size=24, name="data", idx=True):
    rng = np.random.RandomState(0)
    rec = str(tmp_path / (name + ".rec"))
    w = (mx.recordio.MXIndexedRecordIO(str(tmp_path / (name + ".idx")), rec,
                                       "w")
         if idx else mx.recordio.MXRecordIO(rec, "w"))
    for i in range(n):
        img = rng.randint(0, 255, (size + i % 5, size, 3)).astype(np.uint8)
        s = mx.recordio.pack_img(mx.recordio.IRHeader(0, float(i), i, 0),
                                 img, quality=90)
        if idx:
            w.write_idx(i, s)
        else:
            w.write(s)
    w.close()
    return rec


def both(fn, seed=7):
    """fn(package) in each package from the same Python / numpy seeds."""
    out = []
    for mx in PACKAGES:
        random.seed(seed)
        np.random.seed(seed)
        out.append(fn(mx))
    return out


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt,mode", [("JPEG", "RGB"), ("PNG", "RGB"),
                                      ("PNG", "L")])
def test_imdecode_and_imread(tmp_path, fmt, mode):
    buf = encoded(fmt, mode=mode)
    for flag in (0, 1):
        for to_rgb in (True, False):
            same(*both(lambda mx: mx.image.imdecode(buf, flag=flag,
                                                    to_rgb=to_rgb)))
    path = tmp_path / "im.bin"
    path.write_bytes(buf)
    same(*both(lambda mx: mx.image.imread(str(path))))


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4, 9])
def test_resize_and_crops(interp):
    src = tmx.image.imdecode(encoded())
    same(*both(lambda mx: mx.image.imresize(src, 19, 11, interp)))
    same(*both(lambda mx: mx.image.imresize(src.astype(np.float32), 40, 50,
                                            interp)))
    same(*both(lambda mx: mx.image.resize_short(src, 16, interp)))
    same(*both(lambda mx: mx.image.fixed_crop(src, 3, 4, 20, 10, (8, 8),
                                              interp)))
    for fn in ("center_crop", "random_crop"):
        a, b = both(lambda mx: getattr(mx.image, fn)(src, (15, 12), interp))
        same(a[0], b[0])
        assert a[1] == b[1]
    a, b = both(lambda mx: mx.image.random_size_crop(
        src, (16, 16), 0.08, (3 / 4, 4 / 3), interp))
    same(a[0], b[0])
    assert a[1] == b[1]
    assert tmx.image.scale_down((30, 20), (40, 40)) == \
        jmx.image.scale_down((30, 20), (40, 40))
    same(*both(lambda mx: mx.image.color_normalize(
        src, np.array([1.0, 2.0, 3.0]), np.array([2.0, 3.0, 4.0]))))


def test_random_interp_draws_alike():
    src = tmx.image.imdecode(encoded())
    a, b = both(lambda mx: [mx.image.imresize(src, 9 + k, 7, 10)
                            for k in range(6)])
    for x, y in zip(a, b):
        same(x, y)


AUGMENTERS = [
    ("ResizeAug", (14,)), ("ForceResizeAug", ((13, 9),)),
    ("RandomCropAug", ((12, 10),)), ("CenterCropAug", ((12, 10),)),
    ("RandomSizedCropAug", ((16, 16), 0.1, (0.75, 1.33))),
    ("BrightnessJitterAug", (0.3,)), ("ContrastJitterAug", (0.3,)),
    ("SaturationJitterAug", (0.3,)), ("HueJitterAug", (0.4,)),
    ("ColorJitterAug", (0.3, 0.2, 0.4)),
    ("LightingAug", (0.1, np.array([55.46, 4.794, 1.148]),
                     np.array([[-0.5675, 0.7192, 0.4009],
                               [-0.5808, -0.0045, -0.8140],
                               [-0.5836, -0.6948, 0.4203]]))),
    ("ColorNormalizeAug", (np.array([120.0, 110.0, 100.0]),
                           np.array([50.0, 60.0, 70.0]))),
    ("RandomGrayAug", (0.5,)), ("HorizontalFlipAug", (0.5,)),
    ("CastAug", ()),
]


@pytest.mark.parametrize("name,args", AUGMENTERS,
                         ids=[a[0] for a in AUGMENTERS])
def test_each_augmenter_matches_under_the_same_seeds(name, args):
    src = tmx.image.imdecode(encoded(shape=(26, 31, 3)))
    if name not in ("ResizeAug", "ForceResizeAug", "RandomCropAug",
                    "CenterCropAug", "RandomSizedCropAug", "CastAug"):
        src = src.astype(np.float32)

    def run(mx):
        aug = getattr(mx.image, name)(*args)
        return [aug(src.copy()) for _ in range(8)], aug.dumps()

    (a, da), (b, db) = both(run)
    for x, y in zip(a, b):
        same(x, y)
    assert da == db


def test_sequential_random_order_and_ctor_contract():
    src = tmx.image.imdecode(encoded()).astype(np.float32)

    def run(mx):
        parts = [mx.image.BrightnessJitterAug(0.2),
                 mx.image.HorizontalFlipAug(0.5), mx.image.CastAug()]
        seq = mx.image.SequentialAug(parts)
        order = mx.image.RandomOrderAug(parts)
        return ([seq(src) for _ in range(3)] + [order(src) for _ in range(5)],
                seq.dumps())

    (a, da), (b, db) = both(run)
    for x, y in zip(a, b):
        same(x, y)
    assert da == db
    with pytest.raises(TypeError, match="bogus"):
        tmx.image.CastAug(bogus=1)
    with pytest.raises(TypeError):
        tmx.image.HorizontalFlipAug(0.5, 0.7)
    assert json.loads(tmx.image.CastAug().dumps()) == \
        ["castaug", {"type": "float32"}]


@pytest.mark.parametrize("kw", [
    dict(), dict(resize=20, rand_crop=True, rand_mirror=True),
    dict(rand_crop=True, rand_resize=True, mean=True, std=True),
    dict(brightness=0.1, contrast=0.1, saturation=0.1, hue=0.1,
         pca_noise=0.05, rand_gray=0.5, mean=np.array([1.0, 2.0, 3.0]),
         inter_method=10)],
    ids=["default", "resize-crop-mirror", "rand-resize-imagenet",
         "photometric"])
def test_create_augmenter_chains_agree(kw):
    src = tmx.image.imdecode(encoded(shape=(30, 28, 3)))

    def run(mx):
        chain = mx.image.CreateAugmenter((3, 16, 16), **kw)
        outs = []
        for _ in range(4):
            x = src
            for aug in chain:
                x = aug(x)
            outs.append(x)
        return outs, [a.dumps() for a in chain]

    (a, da), (b, db) = both(run)
    for x, y in zip(a, b):
        same(x, y)
    assert da == db
    assert a[0].shape == (16, 16, 3) and a[0].dtype == np.float32


def collect(it, epochs=2):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                        int(b.pad or 0)))
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        same(gd, wd)
        same(gl, wl)


@pytest.mark.parametrize("kw", [
    dict(), dict(shuffle=True, seed=3),
    dict(preprocess_threads=3, resize=20),
    dict(shuffle=True, seed=5, last_batch_handle="discard"),
    dict(num_parts=3, part_index=1),
    dict(rand_crop=True, rand_mirror=True)],
    ids=["plain", "shuffled", "pool", "discard", "shard", "random-augs"])
def test_image_iter_batches_match_the_jax_package(tmp_path, kw):
    rec = make_rec(tmx, tmp_path)

    def run(mx):
        it = mx.image.ImageIter(batch_size=4, data_shape=(3, 16, 16),
                                path_imgrec=rec, **kw)
        try:
            return collect(it)
        finally:
            it.close()

    random.seed(11)
    np.random.seed(11)
    want = run(jmx)
    random.seed(11)
    np.random.seed(11)
    with tmx.cpu():
        got = run(tmx)
    assert_batches_equal(got, want)
    n = 7 if "num_parts" in kw else 21
    assert want[-1][2] == (0 if kw.get("last_batch_handle") == "discard"
                           else -n % 4)


def test_image_iter_without_index_reads_through_the_prefetcher(tmp_path):
    rec = make_rec(tmx, tmp_path, idx=False)
    with tmx.cpu():
        it = tmx.image.ImageIter(batch_size=5, data_shape=(3, 16, 16),
                                 path_imgrec=rec)
    assert type(it.imgrec).__name__ == "MXRecordIOPrefetcher"
    got = collect(it)
    it.close()
    want = collect(jmx.image.ImageIter(batch_size=5, data_shape=(3, 16, 16),
                                       path_imgrec=rec))
    assert_batches_equal(got, want)
    assert it.get_state() is None


@pytest.mark.parametrize("resume_from", ["torch", "jax"])
def test_image_iter_resumes_from_either_packages_state(tmp_path,
                                                        resume_from):
    rec = make_rec(tmx, tmp_path)
    kw = dict(batch_size=4, data_shape=(3, 16, 16), path_imgrec=rec,
              shuffle=True, seed=9)
    with tmx.cpu():
        whole = collect(tmx.image.ImageIter(**kw), epochs=3)
    src = (jmx.image.ImageIter(**kw) if resume_from == "jax"
           else tmx.image.ImageIter(device=tmx.cpu(), **kw))
    for _ in range(2):
        src.next()
    state = json.loads(json.dumps(src.get_state()))
    with tmx.cpu():
        resumed = tmx.image.ImageIter(**kw)
    resumed.set_state(state)
    rest = collect(resumed, epochs=1)
    resumed.reset()
    rest += collect(resumed, epochs=2)
    assert_batches_equal(rest, whole[2:])
    resumed.reset()
    resumed.skip_batches(2)
    assert resumed.cur == 8


def test_image_iter_device_and_lifecycle(tmp_path):
    rec = make_rec(tmx, tmp_path, n=8)
    it = tmx.image.ImageIter(batch_size=4, data_shape=(3, 16, 16),
                             path_imgrec=rec, device=tmx.cpu(),
                             preprocess_threads=2)
    b = it.next()
    assert b.data[0].context.device_type == "cpu"
    assert b.data[0].dtype == np.float32
    it.close()
    it.close()
    assert it.imgrec is None and it._pool is None
    with pytest.raises(tmx.MXNetError):
        it.next()
    with pytest.raises(tmx.MXNetError):
        it.reset()

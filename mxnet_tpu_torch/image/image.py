"""Host-side image pipeline: decode, resize/crop/color augmenters, and
ImageIter (reference: python/mxnet/image/image.py:1244 — the pure-python
pipeline over recordio/raw files; the C++ twin is
src/io/iter_image_recordio_2.cc with src/io/image_aug_default.cc).

Counterpart of ``mxnet_tpu/image/image.py``. Decode and augmentation are
host work in numpy and PIL, as in the JAX package, so that under the same
seeds and call order both packages produce the same pixels bit for bit:
images flow as HWC numpy arrays (uint8 in, float32 after CastAug), and
random augmenters draw from Python's ``random`` module and numpy's global
generator. Torch enters only when a finished batch becomes an NDArray on
the iterator's device (``device``, else the ``with`` scope at
construction, else the card).
"""
import os
import random as pyrandom

import numpy as np

from ..base import MXNetError
from .. import io as _io
from .. import ndarray as nd
from .. import recordio
from ..context import as_device

__all__ = [
    "imread", "imdecode", "imresize", "scale_down", "resize_short",
    "fixed_crop", "random_crop", "center_crop", "random_size_crop",
    "color_normalize",
    "Augmenter", "SequentialAug", "ResizeAug", "ForceResizeAug",
    "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
    "RandomOrderAug", "BrightnessJitterAug", "ContrastJitterAug",
    "SaturationJitterAug", "HueJitterAug", "ColorJitterAug", "LightingAug",
    "ColorNormalizeAug", "RandomGrayAug", "HorizontalFlipAug", "CastAug",
    "CreateAugmenter", "ImageIter",
]


def _pil():
    from PIL import Image

    return Image


def imdecode(buf, flag=1, to_rgb=True):
    """Decode an encoded image (JPEG/PNG bytes) to an HWC uint8 array
    (reference: image.py:85 imdecode — cv2 there, PIL here; to_rgb matches
    the reference's BGR→RGB conversion semantics: True yields RGB)."""
    import io as _pyio

    Image = _pil()
    img = Image.open(_pyio.BytesIO(bytes(buf)))
    if flag == 0:
        img = img.convert("L")
        return np.asarray(img)[:, :, None]
    img = img.convert("RGB")
    arr = np.asarray(img)
    if not to_rgb:
        arr = arr[:, :, ::-1]
    return arr


def imread(filename, flag=1, to_rgb=True):
    """Read and decode an image file (reference: image.py:44)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


_PIL_INTERP = {}


def _interp_method(interp, sizes=()):
    """Map the reference's cv2 interp codes (0 nearest, 1 bilinear,
    2 area/box, 3 bicubic, 4 lanczos, 9 auto, 10 random) to PIL resamples
    (reference: image.py:174 _get_interp_method)."""
    Image = _pil()
    table = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BOX,
             3: Image.BICUBIC, 4: Image.LANCZOS}
    if interp == 9:
        if sizes:
            oh, ow, nh, nw = sizes
            interp = 1 if nh > oh and nw > ow else 3 if nh < oh and nw < ow else 2
        else:
            interp = 2
    if interp == 10:
        interp = pyrandom.randint(0, 4)
    if interp not in table:
        raise MXNetError("Unknown interp method %d" % interp)
    return table[interp]


def imresize(src, w, h, interp=2):
    """Resize to exactly (w, h) (reference: image.py imresize op)."""
    Image = _pil()
    arr = np.asarray(src)
    dt = arr.dtype
    im = Image.fromarray(arr.astype(np.uint8) if dt != np.uint8 else arr)
    out = np.asarray(im.resize(
        (w, h), _interp_method(interp, (arr.shape[0], arr.shape[1], h, w))))
    return out.astype(dt) if dt != np.uint8 else out


def scale_down(src_size, size):
    """Scale requested crop down to fit the source (reference: image.py:139)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so the SHORT edge becomes ``size`` (reference: image.py:229)."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop a fixed region, optionally resizing (reference: image.py:291)."""
    out = np.asarray(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    """Random crop of `size` (scaled down if needed); returns
    (image, (x0, y0, w, h)) (reference: image.py:323)."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Center crop (reference: image.py:362)."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """Random area+aspect crop, the Inception-style augmentation
    (reference: image.py:435)."""
    h, w = src.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = pyrandom.uniform(min_area, 1.0) * area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std channelwise (reference: image.py:411)."""
    src = np.asarray(src, dtype=np.float32) - mean
    if std is not None:
        src = src / std
    return src


# --- augmenter classes (reference: image.py:482-883) ------------------------

class Augmenter(object):
    """Image augmentation base; ``dumps`` serializes for logging
    (reference: image.py:482)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, np.ndarray):
                kwargs[k] = v.tolist()  # one-time config parse

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


def _aug_class(name, fields, call, doc=""):
    """Build a simple Augmenter subclass: stores ``fields`` (name or
    (name, default) pairs) and runs ``call(self, src)``."""
    specs = [(f, None) if isinstance(f, str) else f for f in fields]

    def __init__(self, *args, **kwargs):
        if len(args) > len(specs):
            raise TypeError("%s() takes at most %d arguments (%d given)"
                            % (name, len(specs), len(args)))
        bound = {}
        for (fname, default), value in zip(specs, args):
            bound[fname] = value
        for fname, default in specs[len(args):]:
            bound[fname] = kwargs.pop(fname, default)
        if kwargs:
            raise TypeError("%s() got unexpected keyword argument(s) %s"
                            % (name, ", ".join(sorted(kwargs))))
        Augmenter.__init__(self, **dict(bound))
        for fname, value in bound.items():
            setattr(self, fname, value)

    cls = type(name, (Augmenter,), {"__init__": __init__,
                                    "__call__": call, "__doc__": doc})
    return cls


class SequentialAug(Augmenter):
    """Run sub-augmenters in order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [type(self).__name__.lower(), [t.dumps() for t in self.ts]]

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(SequentialAug):
    """Run sub-augmenters in a fresh random order each call."""

    def __call__(self, src):
        order = list(self.ts)
        pyrandom.shuffle(order)
        for t in order:
            src = t(src)
        return src


ResizeAug = _aug_class(
    "ResizeAug", ["size", ("interp", 2)],
    lambda self, src: resize_short(src, self.size, self.interp),
    doc="Short-edge resize.")

ForceResizeAug = _aug_class(
    "ForceResizeAug", ["size", ("interp", 2)],
    lambda self, src: imresize(src, self.size[0], self.size[1], self.interp),
    doc="Exact-size resize ignoring aspect ratio.")

RandomCropAug = _aug_class(
    "RandomCropAug", ["size", ("interp", 2)],
    lambda self, src: random_crop(src, self.size, self.interp)[0],
    doc="Uniform random crop.")

RandomSizedCropAug = _aug_class(
    "RandomSizedCropAug", ["size", "min_area", "ratio", ("interp", 2)],
    lambda self, src: random_size_crop(src, self.size, self.min_area,
                                       self.ratio, self.interp)[0],
    doc="Inception-style random area+aspect crop.")

CenterCropAug = _aug_class(
    "CenterCropAug", ["size", ("interp", 2)],
    lambda self, src: center_crop(src, self.size, self.interp)[0],
    doc="Center crop.")


_LUMA = np.array([[[0.299, 0.587, 0.114]]], np.float32)


def _luma(img):
    """Per-pixel luminance, keepdims."""
    return (img * _LUMA).sum(axis=2, keepdims=True)


def _jitter(limit):
    return 1.0 + pyrandom.uniform(-limit, limit)


def _brightness_call(self, src):
    return np.asarray(src, np.float32) * _jitter(self.brightness)


def _contrast_call(self, src):
    src = np.asarray(src, np.float32)
    alpha = _jitter(self.contrast)
    return src * alpha + _luma(src).mean() * (1.0 - alpha)


def _saturation_call(self, src):
    src = np.asarray(src, np.float32)
    alpha = _jitter(self.saturation)
    return src * alpha + _luma(src) * (1.0 - alpha)


BrightnessJitterAug = _aug_class("BrightnessJitterAug", ["brightness"],
                                 _brightness_call)
ContrastJitterAug = _aug_class("ContrastJitterAug", ["contrast"],
                               _contrast_call)
SaturationJitterAug = _aug_class("SaturationJitterAug", ["saturation"],
                                 _saturation_call)


class HueJitterAug(Augmenter):
    """Hue rotation in YIQ space."""

    _yiq = np.array([[0.299, 0.587, 0.114],
                     [0.596, -0.274, -0.321],
                     [0.211, -0.523, 0.311]], np.float32)
    _yiq_inv = np.array([[1.0, 0.956, 0.621],
                         [1.0, -0.272, -0.647],
                         [1.0, -1.107, 1.705]], np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        src = np.asarray(src, np.float32)
        theta = pyrandom.uniform(-self.hue, self.hue) * np.pi
        u, w = np.cos(theta), np.sin(theta)
        rot = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       np.float32)
        return src @ (self._yiq_inv @ rot @ self._yiq).T


class ColorJitterAug(RandomOrderAug):
    """Brightness/contrast/saturation jitters in random order.

    Applied as ONE fused pass: each jitter is affine in the algebra
    spanned by {x, luma(x), mean(luma(x))} (luma is a linear functional,
    so the random-order composition stays inside it). Composing the
    (a, l, m) coefficients host-side and materializing once replaces the
    3+ full-image passes of the sequential chain; the draws are the
    sequential chain's, in the same order."""

    def __init__(self, brightness, contrast, saturation):
        parts = [cls(v) for cls, v in
                 ((BrightnessJitterAug, brightness),
                  (ContrastJitterAug, contrast),
                  (SaturationJitterAug, saturation)) if v > 0]
        super().__init__(parts)

    def __call__(self, src):
        a, l, m = 1.0, 0.0, 0.0   # image = a*x + l*luma(x) + m*mean(luma)
        order = list(self.ts)
        pyrandom.shuffle(order)
        for t in order:
            if isinstance(t, BrightnessJitterAug):
                alpha = _jitter(t.brightness)
                a, l, m = alpha * a, alpha * l, alpha * m
            elif isinstance(t, ContrastJitterAug):
                alpha = _jitter(t.contrast)
                a, l, m = alpha * a, alpha * l, \
                    alpha * m + (1.0 - alpha) * (a + l + m)
            elif isinstance(t, SaturationJitterAug):
                alpha = _jitter(t.saturation)
                a, l, m = alpha * a, \
                    alpha * l + (1.0 - alpha) * (a + l), m
            else:   # user-extended chains fall back to sequential
                src = np.asarray(src, np.float32)
                if (a, l, m) != (1.0, 0.0, 0.0):
                    lum = _luma(src)
                    src = a * src + l * lum + m * lum.mean()
                    a, l, m = 1.0, 0.0, 0.0
                src = t(src)
        src = np.asarray(src, np.float32)
        if (a, l, m) == (1.0, 0.0, 0.0):
            return src
        lum = _luma(src)
        return a * src + l * lum + float(m) * lum.mean()


class LightingAug(Augmenter):
    """PCA lighting noise (AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd, eigval=eigval, eigvec=eigvec)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        shift = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return np.asarray(src, np.float32) + shift


def _normalize_call(self, src):
    return color_normalize(src,
                           None if self.mean is None
                           else np.asarray(self.mean, np.float32),
                           None if self.std is None
                           else np.asarray(self.std, np.float32))


def _gray_call(self, src):
    if pyrandom.random() < self.p:
        src = np.broadcast_to(_luma(np.asarray(src, np.float32)), src.shape)
    return src


def _flip_call(self, src):
    return np.asarray(src)[:, ::-1] if pyrandom.random() < self.p else src


class CastAug(Augmenter):
    """Cast to a dtype. Reference API: ctor keyword is ``typ`` but the
    serialized kwarg is ``type`` (image.py:624 passes
    ``super().__init__(type=typ)``)."""

    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return np.asarray(src, dtype=self.typ)


ColorNormalizeAug = _aug_class("ColorNormalizeAug", ["mean", "std"],
                               _normalize_call)
RandomGrayAug = _aug_class("RandomGrayAug", ["p"], _gray_call)
HorizontalFlipAug = _aug_class("HorizontalFlipAug", ["p"], _flip_call)


def _imagenet_stat(value, default):
    """Resolve mean/std flags: True -> ImageNet constants, arrays pass
    through validated."""
    if value is True:
        return np.array(default)
    if value is None:
        return None
    value = np.asarray(value)
    if value.shape[0] not in (1, 3):
        raise AssertionError("mean/std must have 1 or 3 channels")
    return value


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """Standard classification augmentation chain: resize → crop → mirror
    → cast → color jitter → hue → lighting → gray → normalize (the
    reference's ordering and defaults, image.py:885)."""
    chain = []
    if resize > 0:
        chain.append(ResizeAug(resize, inter_method))

    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise AssertionError("rand_resize requires rand_crop")
        chain.append(RandomSizedCropAug(crop_size, 0.08,
                                        (3.0 / 4.0, 4.0 / 3.0),
                                        inter_method))
    else:
        crop_cls = RandomCropAug if rand_crop else CenterCropAug
        chain.append(crop_cls(crop_size, inter_method))

    if rand_mirror:
        chain.append(HorizontalFlipAug(0.5))
    chain.append(CastAug())
    if brightness or contrast or saturation:
        chain.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        chain.append(HueJitterAug(hue))
    if pca_noise > 0:
        chain.append(LightingAug(
            pca_noise,
            np.array([55.46, 4.794, 1.148]),
            np.array([[-0.5675, 0.7192, 0.4009],
                      [-0.5808, -0.0045, -0.8140],
                      [-0.5836, -0.6948, 0.4203]])))
    if rand_gray > 0:
        chain.append(RandomGrayAug(rand_gray))

    mean = _imagenet_stat(mean, [123.68, 116.28, 103.53])
    std = _imagenet_stat(std, [58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        chain.append(ColorNormalizeAug(mean, std))
    return chain


class ImageIter(_io.DataIter):
    """Image iterator over .rec files or image lists with augmenters and
    ``num_parts``/``part_index`` sharding (reference: image.py:999 ImageIter;
    the distributed sharding mirrors iter_image_recordio_2.cc:78).

    Yields DataBatch with data in NCHW float32 (``data_shape`` is CHW) on
    ``device`` (a Context or torch device; None is the ``with`` scope at
    construction, else the card).
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, dtype="float32",
                 last_batch_handle="pad", preprocess_threads=0, seed=None,
                 device=None, **kwargs):
        super().__init__()
        # resolved here, not per batch: next() may run on a prefetch
        # thread, outside the caller's ``with`` scope
        self._device = as_device(device)
        assert path_imgrec or path_imglist or (isinstance(imglist, list))
        assert len(data_shape) == 3 and data_shape[0] in (1, 3)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.path_root = path_root
        self.dtype = dtype
        self.imgrec = None
        self.imglist = None
        self.seq = None

        if path_imgrec:
            if path_imgidx is None:
                guess = os.path.splitext(path_imgrec)[0] + ".idx"
                path_imgidx = guess if os.path.exists(guess) else None
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                # sequential scan: use the native read-ahead thread so
                # disk IO overlaps decode (PrefetcherIter analog); fall
                # back to the plain reader without a toolchain
                try:
                    self.imgrec = recordio.MXRecordIOPrefetcher(
                        path_imgrec)
                except MXNetError:
                    self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.seq = None
        if path_imglist:
            imglist_d = {}
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = np.array(parts[1:-1], dtype=np.float32)
                    imglist_d[int(parts[0])] = (label, parts[-1])
            self.imglist = imglist_d
            self.seq = list(imglist_d.keys())
        elif isinstance(imglist, list):
            imglist_d = {}
            for i, entry in enumerate(imglist):
                label = np.array(entry[0], dtype=np.float32).reshape(-1)
                imglist_d[i] = (label, entry[1])
            self.imglist = imglist_d
            self.seq = list(imglist_d.keys())

        if num_parts > 1:
            assert 0 <= part_index < num_parts
            if self.seq is None:
                raise MXNetError("sharding requires an index (.idx) or list")
            # dmlc InputSplit semantics (runtime/source.py): contiguous,
            # disjoint AND complete — uneven remainders spread across
            # parts, never dropped (the old //-based split lost up to
            # num_parts-1 trailing records per epoch)
            from ..runtime.source import shard_partition

            lo, hi = shard_partition(len(self.seq), num_parts, part_index)
            self.seq = self.seq[lo:hi]

        self.shuffle = shuffle
        # a seeded private RNG makes the per-epoch shuffle reproducible
        # (and the iterator position checkpointable via get_state);
        # unseeded keeps the reference's module-level random behavior.
        # Seeded epochs shuffle a CANONICAL base order — the same
        # permutation semantics as runtime.source.RecordFileSource, so
        # the two backends produce identical seeded epoch orders
        self._rng = np.random.RandomState(seed) if seed is not None else None
        self._base_seq = list(self.seq) if self.seq is not None else None
        if shuffle and self.seq is None:
            raise MXNetError(
                "shuffle=True needs random access: provide path_imgidx (an "
                ".idx next to the .rec) or an image list")
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError("last_batch_handle must be pad/discard/"
                             "roll_over, got %r" % (last_batch_handle,))
        if last_batch_handle == "roll_over":
            raise MXNetError("last_batch_handle='roll_over' is not "
                             "supported by ImageIter (reference semantics "
                             "only defined for NDArrayIter)")
        self.aug_list = (CreateAugmenter(data_shape, **kwargs)
                         if aug_list is None else aug_list)
        self.cur = 0
        self._allow_read = True
        self._closed = False
        # parallel decode+augment pool (the ImageRecordIter
        # preprocess_threads analog, iter_image_recordio_2.cc:139-145's
        # OMP decode loop): PIL decode and the numpy augmenters release
        # the GIL in their C kernels, so threads scale
        self._pool = None
        if preprocess_threads and preprocess_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            # bounded at the host's core count: decode threads beyond it
            # only add contention (and idle threads to leak)
            workers = min(int(preprocess_threads), os.cpu_count() or 1)
            if workers > 1:
                self._pool = ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="mxnet-image-decode")
        self.last_batch_handle = last_batch_handle
        self.num_image = len(self.seq) if self.seq is not None else None
        self._cache_data = None
        self.provide_data = [_io.DataDesc("data",
                                          (batch_size,) + self.data_shape,
                                          dtype)]
        label_shape = ((batch_size,) if label_width == 1
                       else (batch_size, label_width))
        self.provide_label = [_io.DataDesc("softmax_label", label_shape,
                                           "float32")]
        self.reset()

    def reset(self):
        if self._closed:
            raise MXNetError("reset() on a closed ImageIter")
        if self.shuffle:
            if self._rng is not None:
                self.seq = list(self._base_seq)
                self._rng.shuffle(self.seq)
            else:
                pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def close(self):
        """Release the decode pool's worker threads AND the record
        reader (iterators rebuilt per epoch would otherwise accumulate
        idle threads and open file handles). Idempotent."""
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self.imgrec is not None:
            try:
                self.imgrec.close()
            except Exception:
                pass  # gc/exit path: never raise out of close
            self.imgrec = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def skip_batches(self, n):
        """Fast-forward ``n`` batches by cursor math (no decode)."""
        if self.seq is None:
            super().skip_batches(n)
            return
        self.cur = min(self.cur + int(n) * self.batch_size, len(self.seq))

    def get_state(self):
        """Cursor + this epoch's sample order + the RNG stream (when
        seeded) — None for index-less sequential scans, which have no
        checkpointable random-access position."""
        if self.seq is None:
            return None
        from ..runtime.source import encode_rng_state

        return {"cur": int(self.cur),
                "seq": [int(k) for k in self.seq],
                "rng": (encode_rng_state(self._rng)
                        if self._rng is not None else None)}

    def set_state(self, state):
        if state is None:
            return
        if self.seq is None:
            raise MXNetError("set_state on an index-less ImageIter")
        from ..runtime.source import decode_rng_state

        seq = [int(k) for k in state["seq"]]
        if set(seq) != set(int(k) for k in self.seq):
            raise MXNetError(
                "iterator state does not match this dataset/shard "
                "(different key sets)")
        self.seq = seq
        self.cur = int(state["cur"])
        if state.get("rng") is not None:
            self._rng = decode_rng_state(state["rng"])

    def _next_raw(self):
        """(label, payload, kind) with decode deferred — the IO half."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                label = (header.label if self.imglist is None
                         else self.imglist[idx][0])
                return label, img, "bytes"
            label, fname = self.imglist[idx]
            return label, fname, "file"
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img, "bytes"

    def _decode_raw(self, payload, kind):
        return (imdecode(payload) if kind == "bytes"
                else self.read_image(payload))

    def next_sample(self):
        """Return (label, decoded HWC image) for the next sample."""
        label, payload, kind = self._next_raw()
        return label, self._decode_raw(payload, kind)

    def _prepare_sample(self, row, label, payload, kind,
                        batch_data, batch_label):
        """Decode+augment one sample into its batch row (pool worker)."""
        data = self.augmentation_transform(self._decode_raw(payload, kind))
        self.check_valid_image(data)
        if data.ndim == 2:
            data = data[:, :, None]
        batch_data[row] = data
        lab = np.asarray(label, np.float32).reshape(-1)
        batch_label[row, :len(lab[:self.label_width])] = \
            lab[:self.label_width]

    def next(self):
        # close() released the record reader — a bare read would die on
        # AttributeError; raise the lifecycle error like the other
        # guarded iterators
        if self._closed:
            raise MXNetError("next() on a closed ImageIter")
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, h, w, c), np.float32)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               np.float32)
        i = 0
        if self._pool is not None:
            # raw record IO stays serial (preserves sample order); decode
            # + augment fan out, each worker owning one batch row
            raws = []
            try:
                while len(raws) < self.batch_size:
                    raws.append(self._next_raw())
            except StopIteration:
                if not raws or self.last_batch_handle == "discard":
                    raise
            futs = [self._pool.submit(self._prepare_sample, j, label,
                                      payload, kind, batch_data, batch_label)
                    for j, (label, payload, kind) in enumerate(raws)]
            for f in futs:
                f.result()
            i = len(raws)
        else:
            try:
                while i < self.batch_size:
                    label, payload, kind = self._next_raw()
                    self._prepare_sample(i, label, payload, kind,
                                         batch_data, batch_label)
                    i += 1
            except StopIteration:
                if i == 0 or self.last_batch_handle == "discard":
                    raise
        pad = self.batch_size - i
        data_nchw = np.ascontiguousarray(
            batch_data.transpose(0, 3, 1, 2)).astype(self.dtype)
        label_out = (batch_label[:, 0] if self.label_width == 1
                     else batch_label)
        return _io.DataBatch(data=[nd.array(data_nchw, ctx=self._device)],
                             label=[nd.array(label_out, ctx=self._device)],
                             pad=pad, index=None)

    def check_data_shape(self, data_shape):
        if not len(data_shape) == 3:
            raise ValueError("data_shape should have length 3, with "
                             "dimensions CxHxW")

    def check_valid_image(self, data):
        if data.shape[0] == 0:
            raise RuntimeError("Data shape is wrong")

    def imdecode(self, s):
        return imdecode(s)

    def read_image(self, fname):
        path = os.path.join(self.path_root, fname) if self.path_root else fname
        return imread(path)

    def augmentation_transform(self, data):
        for aug in self.aug_list:
            data = aug(data)
        return data

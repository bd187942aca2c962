"""Detection image pipeline: box-aware augmenters + ImageDetIter.

Parity surface: reference python/mxnet/image/detection.py (DetAugmenter
family, CreateMultiRandCropAugmenter/CreateDetAugmenter, ImageDetIter over
VOC-style .rec/.lst sources) and src/io/iter_image_det_recordio.cc
(variable box counts padded with -1 rows).

Counterpart of ``mxnet_tpu/image/detection.py``: the same numpy geometry
and the same draws from Python's ``random`` module, so that under the same
seeds both packages crop, pad and flip alike.

Labels are numpy float32 matrices with one object per row:
``(class_id, xmin, ymin, xmax, ymax, ...)`` with coordinates normalised to
[0, 1]. The raw on-disk form is a flat header-prefixed vector
``(header_width, obj_width, ...header..., objects...)``.
"""
from __future__ import annotations

import json
import logging
import random as pyrandom

import numpy as np

from .. import io as _io
from .. import ndarray as nd
from .image import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
                    ForceResizeAug, HueJitterAug, ImageIter, LightingAug,
                    RandomGrayAug, ResizeAug, fixed_crop)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
           "ImageDetIter"]


# --------------------------------------------------------------- box algebra
def _box_areas(boxes):
    """Areas of (N, >=4) boxes given as (xmin, ymin, xmax, ymax, ...)."""
    w = np.maximum(0.0, boxes[:, 2] - boxes[:, 0])
    h = np.maximum(0.0, boxes[:, 3] - boxes[:, 1])
    return w * h


def _overlap_boxes(boxes, window):
    """Per-box intersection with ``window`` = (x1, y1, x2, y2); rows with no
    overlap are zeroed."""
    x1, y1, x2, y2 = window
    cut = boxes.copy()
    cut[:, 0] = np.maximum(boxes[:, 0], x1)
    cut[:, 1] = np.maximum(boxes[:, 1], y1)
    cut[:, 2] = np.minimum(boxes[:, 2], x2)
    cut[:, 3] = np.minimum(boxes[:, 3], y2)
    empty = (cut[:, 0] >= cut[:, 2]) | (cut[:, 1] >= cut[:, 3])
    cut[empty] = 0
    return cut


# ----------------------------------------------------------------- augmenters
class DetAugmenter(object):
    """Base class: ``aug(image, label) -> (image, label)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for key in ("mean", "std"):
            value = kwargs.get(key)
            if isinstance(value, np.ndarray):
                kwargs[key] = value.tolist()  # one-time config parse

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection chain (labels pass
    through untouched — valid for any purely photometric/resize aug)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise TypeError("DetBorrowAug requires an image Augmenter")
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def dumps(self):
        return [type(self).__name__.lower(), self.augmenter.dumps()]

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Apply one randomly chosen child augmenter (or none, with
    probability ``skip_prob``)."""

    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob
        if not aug_list:
            logging.warning("DetRandomSelectAug: empty list, always skip")

    def dumps(self):
        return [type(self).__name__.lower(),
                [a.dumps() for a in self.aug_list]]

    def __call__(self, src, label):
        if self.aug_list and pyrandom.random() >= self.skip_prob:
            src, label = pyrandom.choice(self.aug_list)(src, label)
        return src, label


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and x-coordinates with probability ``p``."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = src[:, ::-1]
            label = label.copy()
            # x_min', x_max' = 1 - x_max, 1 - x_min
            label[:, 1], label[:, 3] = 1.0 - label[:, 3], 1.0 - label[:, 1]
        return src, label


class _GeometrySampler:
    """Sample a (w, h) window with aspect ratio and area constraints —
    shared machinery for the crop and pad proposal loops."""

    def __init__(self, aspect_ratio_range, area_range, max_attempts):
        def pair(value):
            return ((value, value)
                    if not isinstance(value, (tuple, list)) else tuple(value))

        self.ratio_range = pair(aspect_ratio_range)
        self.area_range = pair(area_range)
        self.max_attempts = max_attempts

    def valid(self):
        lo_r, hi_r = self.ratio_range
        lo_a, hi_a = self.area_range
        return lo_r <= hi_r and lo_r > 0 and hi_a > 0 and lo_a <= hi_a

    def sample_ratio(self):
        return pyrandom.uniform(*self.ratio_range)


class DetRandomCropAug(DetAugmenter):
    """Random crop whose window must cover every surviving object by at
    least ``min_object_covered``; objects keeping less than
    ``min_eject_coverage`` of their area are dropped."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self._geom = _GeometrySampler(aspect_ratio_range, area_range,
                                      max_attempts)
        self.aspect_ratio_range = self._geom.ratio_range
        self.area_range = self._geom.area_range
        self.enabled = self._geom.valid() and self.area_range[1] > 0
        if not self.enabled:
            logging.warning("Skip DetRandomCropAug due to invalid "
                            "area/aspect ranges: %s %s",
                            self.area_range, self.aspect_ratio_range)

    def __call__(self, src, label):
        found = self._propose(label, src.shape[0], src.shape[1])
        if found:
            x, y, w, h, label = found
            src = fixed_crop(src, x, y, w, h, None)
        return src, label

    def _window_ok(self, label, window_px, width, height):
        """Every valid object overlapped by the window must be covered by
        more than min_object_covered of its own area."""
        x0, y0, x1, y1 = window_px
        if (x1 - x0) * (y1 - y0) < 2:
            return False
        window = (x0 / width, y0 / height, x1 / width, y1 / height)
        boxes = label[:, 1:]
        own = _box_areas(boxes)
        real = own * width * height > 2
        if not real.any():
            return False
        covered = _box_areas(_overlap_boxes(boxes[real], window)) / own[real]
        covered = covered[covered > 0]
        return covered.size > 0 and covered.min() > self.min_object_covered

    def _rebase_labels(self, label, crop_px, height, width):
        """Express boxes in the crop's normalized frame, clipping and
        ejecting objects that kept too little of themselves."""
        cx, cy, cw, ch = crop_px
        fx, fy = cx / width, cy / height
        fw, fh = cw / width, ch / height
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] - fx) / fw
        out[:, (2, 4)] = (out[:, (2, 4)] - fy) / fh
        out[:, 1:5] = np.clip(out[:, 1:5], 0, 1)
        kept_frac = (_box_areas(out[:, 1:]) * fw * fh
                     / _box_areas(label[:, 1:]))
        alive = ((out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
                 & (kept_frac > self.min_eject_coverage))
        if not alive.any():
            return None
        return out[alive]

    def _propose(self, label, height, width):
        """Rejection-sample a crop window; () when nothing qualifies."""
        if not self.enabled or height <= 0 or width <= 0:
            return ()
        lo_area = self.area_range[0] * height * width
        hi_area = self.area_range[1] * height * width
        for _ in range(self.max_attempts):
            ratio = self._geom.sample_ratio()
            if ratio <= 0:
                continue
            h = int(round(np.sqrt(lo_area / ratio)))
            h_cap = int(round(np.sqrt(hi_area / ratio)))
            if round(h_cap * ratio) > width:
                h_cap = int((width + 0.4999999) / ratio)
            h_cap = min(h_cap, height)
            h = min(h, h_cap)
            if h < h_cap:
                h = pyrandom.randint(h, h_cap)
            w = int(round(h * ratio))
            assert w <= width
            # nudge against rounding drift
            if w * h < lo_area:
                h += 1
                w = int(round(h * ratio))
            if w * h > hi_area:
                h -= 1
                w = int(round(h * ratio))
            if not (lo_area <= w * h <= hi_area and 0 < w <= width
                    and 0 < h <= height):
                continue
            y = pyrandom.randint(0, max(0, height - h))
            x = pyrandom.randint(0, max(0, width - w))
            if self._window_ok(label, (x, y, x + w, y + h), width, height):
                rebased = self._rebase_labels(label, (x, y, w, h), height,
                                              width)
                if rebased is not None:
                    return (x, y, w, h, rebased)
        return ()


class DetRandomPadAug(DetAugmenter):
    """Random expansion: paste the image onto a larger canvas filled with
    ``pad_val``; boxes shrink into the canvas frame."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(128, 128, 128)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.pad_val = pad_val
        self.max_attempts = max_attempts
        self._geom = _GeometrySampler(aspect_ratio_range, area_range,
                                      max_attempts)
        self.aspect_ratio_range = self._geom.ratio_range
        self.area_range = self._geom.area_range
        self.enabled = self._geom.valid() and self.area_range[1] > 1
        if not self.enabled:
            logging.warning("Skip DetRandomPadAug due to invalid "
                            "area/aspect ranges: %s %s",
                            self.area_range, self.aspect_ratio_range)

    def __call__(self, src, label):
        height, width = src.shape[:2]
        found = self._propose(label, height, width)
        if found:
            x, y, w, h, label = found
            canvas = np.full((h, w, src.shape[2]), self.pad_val,
                             dtype=src.dtype)
            canvas[y:y + height, x:x + width] = src
            src = canvas
        return src, label

    def _rebase_labels(self, label, pad_px, height, width):
        x, y, w, h = pad_px
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] * width + x) / w
        out[:, (2, 4)] = (out[:, (2, 4)] * height + y) / h
        return out

    def _propose(self, label, height, width):
        if not self.enabled or height <= 0 or width <= 0:
            return ()
        lo_area = self.area_range[0] * height * width
        hi_area = self.area_range[1] * height * width
        for _ in range(self.max_attempts):
            ratio = self._geom.sample_ratio()
            if ratio <= 0:
                continue
            h = int(round(np.sqrt(lo_area / ratio)))
            h_cap = int(round(np.sqrt(hi_area / ratio)))
            if round(h * ratio) < width:
                h = int((width + 0.499999) / ratio)
            h = max(h, height)
            h = min(h, h_cap)
            if h < h_cap:
                h = pyrandom.randint(h, h_cap)
            w = int(round(h * ratio))
            if (h - height) < 2 or (w - width) < 2:
                continue  # marginal padding is not helpful
            y = pyrandom.randint(0, max(0, h - height))
            x = pyrandom.randint(0, max(0, w - width))
            return (x, y, w, h, self._rebase_labels(label, (x, y, w, h),
                                                    height, width))
        return ()


# ------------------------------------------------------------------ factories
def _broadcast_params(*params):
    """Align scalar-or-list parameters to equal-length lists."""
    as_lists = [p if isinstance(p, list) else [p] for p in params]
    count = max(len(p) for p in as_lists)
    for i, p in enumerate(as_lists):
        if len(p) != count:
            if len(p) != 1:
                raise AssertionError("parameter lists must align")
            as_lists[i] = p * count
    return as_lists


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """One DetRandomSelectAug over several crop augmenters, each built from
    the i-th entry of every (scalar-or-list) parameter."""
    aligned = _broadcast_params(min_object_covered, aspect_ratio_range,
                                area_range, min_eject_coverage, max_attempts)
    crops = [DetRandomCropAug(min_object_covered=covered,
                              aspect_ratio_range=ratios, area_range=areas,
                              min_eject_coverage=eject, max_attempts=tries)
             for covered, ratios, areas, eject, tries in zip(*aligned)]
    return DetRandomSelectAug(crops, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 3.0),
                       min_eject_coverage=0.3, max_attempts=50,
                       pad_val=(127, 127, 127)):
    """The standard SSD-style detection augmentation chain."""
    chain = []
    if resize > 0:
        chain.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        chain.append(CreateMultiRandCropAugmenter(
            min_object_covered, aspect_ratio_range, area_range,
            min_eject_coverage, max_attempts, skip_prob=(1 - rand_crop)))
    if rand_mirror > 0:
        chain.append(DetHorizontalFlipAug(0.5))
    # padding late keeps the expensive photometric ops on smaller images
    if rand_pad > 0:
        chain.append(DetRandomSelectAug(
            [DetRandomPadAug(aspect_ratio_range, (1.0, area_range[1]),
                             max_attempts, pad_val)],
            1 - rand_pad))
    chain.append(DetBorrowAug(ForceResizeAug((data_shape[2], data_shape[1]),
                                             inter_method)))
    chain.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        chain.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        chain.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        chain.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        chain.append(DetBorrowAug(RandomGrayAug(rand_gray)))

    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    for stat in (mean, std):
        if stat is not None and not (isinstance(stat, np.ndarray)
                                     and stat.shape[0] in (1, 3)):
            raise AssertionError("mean/std must be ndarray of shape (1|3,)")
    if mean is not None or std is not None:
        chain.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return chain


# ------------------------------------------------------------------- iterator
class ImageDetIter(ImageIter):
    """Detection batches: images plus a fixed-shape padded label tensor
    (batch, max_objects, obj_width), unfilled rows at -1."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 preprocess_threads=0, device=None, **kwargs):
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=[], imglist=imglist,
                         label_width=1,
                         preprocess_threads=preprocess_threads,
                         device=device)
        self._data_name = data_name
        self._label_name = label_name
        self.auglist = (CreateDetAugmenter(data_shape, **kwargs)
                        if aug_list is None else aug_list)
        self.label_shape = self._scan_label_shape()
        self.provide_data = [_io.DataDesc(
            data_name, (batch_size,) + self.data_shape, "float32")]
        self.provide_label = [_io.DataDesc(
            label_name, (batch_size,) + self.label_shape, "float32")]

    # ---------------------------------------------------------- label logic
    def _parse_label(self, label):
        """Flat header-prefixed vector -> (N, obj_width) matrix of valid
        objects."""
        if isinstance(label, nd.NDArray):
            label = label.asnumpy()
        flat = np.asarray(label, dtype=np.float32).ravel()
        if flat.size < 7:
            raise RuntimeError("Label shape is invalid: " + str(flat.shape))
        head = int(flat[0])
        obj_width = int(flat[1])
        if (flat.size - head) % obj_width:
            raise RuntimeError(
                "Label shape %s inconsistent with annotation width %d."
                % (str(flat.shape), obj_width))
        objects = flat[head:].reshape(-1, obj_width)
        alive = (objects[:, 3] > objects[:, 1]) & (objects[:, 4]
                                                   > objects[:, 2])
        if not alive.any():
            raise RuntimeError("Encounter sample with no valid label.")
        return objects[alive]

    def _check_valid_label(self, label):
        if label.ndim != 2 or label.shape[1] < 5:
            raise RuntimeError("Label with shape (1+, 5+) required, %s "
                               "received." % str(label))
        good = ((label[:, 0] >= 0) & (label[:, 3] > label[:, 1])
                & (label[:, 4] > label[:, 2]))
        if not good.any():
            raise RuntimeError("Invalid label occurs.")

    def _scan_label_shape(self):
        """Max object count over the dataset fixes the padded label shape."""
        most, width = 0, 5
        self.reset()
        try:
            while True:
                raw, _img = self.next_sample()
                objects = self._parse_label(raw)
                most = max(most, objects.shape[0])
                width = objects.shape[1]
        except StopIteration:
            pass
        self.reset()
        return (most, width)

    def check_label_shape(self, label_shape):
        if len(label_shape) != 2:
            raise ValueError("label_shape should have length 2")
        if label_shape[0] < self.label_shape[0]:
            raise ValueError(
                "Attempts to reduce label count from %d to %d, not allowed."
                % (self.label_shape[0], label_shape[0]))
        if label_shape[1] != self.provide_label[0][1][2]:
            raise ValueError("label width cannot change")

    def reshape(self, data_shape=None, label_shape=None):
        """Adjust provided data/label shapes in place."""
        if data_shape is not None:
            self.check_data_shape(data_shape)
            self.provide_data = [_io.DataDesc(
                self.provide_data[0][0],
                (self.batch_size,) + tuple(data_shape), "float32")]
            self.data_shape = tuple(data_shape)
        if label_shape is not None:
            self.check_label_shape(label_shape)
            self.provide_label = [_io.DataDesc(
                self.provide_label[0][0],
                (self.batch_size,) + tuple(label_shape), "float32")]
            self.label_shape = tuple(label_shape)

    # ------------------------------------------------------------- batching
    def augmentation_transform(self, data, label):
        for aug in self.auglist:
            data, label = aug(data, label)
        return data, label

    def _prepare_det(self, row, raw_label, payload, kind, images, labels):
        """Decode + augment one sample into row ``row``; returns False when
        the sample is invalid and the row must be refilled."""
        img = self._decode_raw(payload, kind)
        try:
            self.check_valid_image([img])
            objects = self._parse_label(raw_label)
            img, objects = self.augmentation_transform(img, objects)
            self._check_valid_label(objects)
        except RuntimeError as err:
            logging.debug("Invalid image, skipping: %s", str(err))
            return False
        if img.ndim == 2:
            img = img[:, :, None]
        images[row] = img
        count = min(objects.shape[0], self.label_shape[0])
        labels[row, :count] = objects[:count]
        return True

    def next(self):
        c, h, w = self.data_shape
        images = np.zeros((self.batch_size, h, w, c), np.float32)
        labels = np.full((self.batch_size,) + self.label_shape, -1.0,
                         np.float32)
        filled = 0
        try:
            if self._pool is not None:
                while filled < self.batch_size:
                    want = self.batch_size - filled
                    raws = []
                    try:
                        while len(raws) < want:
                            raws.append(self._next_raw())
                    except StopIteration:
                        if not raws:
                            raise
                    futures = [
                        self._pool.submit(self._prepare_det, filled + j,
                                          lab, payload, kind, images, labels)
                        for j, (lab, payload, kind) in enumerate(raws)]
                    ok = [f.result() for f in futures]
                    # compact rejected rows so the batch stays contiguous
                    good = [filled + j for j, o in enumerate(ok) if o]
                    for dst, src in enumerate(good, start=filled):
                        if dst != src:
                            images[dst] = images[src]
                            labels[dst] = labels[src]
                    filled += len(good)
                    if len(raws) < want:
                        raise StopIteration
            else:
                while filled < self.batch_size:
                    raw, img = self.next_sample()
                    try:
                        self.check_valid_image([img])
                        objects = self._parse_label(raw)
                        img, objects = self.augmentation_transform(img,
                                                                   objects)
                        self._check_valid_label(objects)
                    except RuntimeError as err:
                        logging.debug("Invalid image, skipping: %s", str(err))
                        continue
                    if img.ndim == 2:
                        img = img[:, :, None]
                    images[filled] = img
                    count = min(objects.shape[0], self.label_shape[0])
                    labels[filled, :count] = objects[:count]
                    filled += 1
        except StopIteration:
            if not filled:
                raise

        nchw = np.ascontiguousarray(images.transpose(0, 3, 1, 2))
        return _io.DataBatch(data=[nd.array(nchw, ctx=self._device)],
                             label=[nd.array(labels, ctx=self._device)],
                             pad=self.batch_size - filled)

    def check_valid_image(self, data):
        if data[0].shape[0] == 0:
            raise RuntimeError("Data shape is wrong")

    def sync_label_shape(self, it, verbose=False):
        """Unify label shapes between train/val iterators (reference:
        detection.py sync_label_shape)."""
        if not isinstance(it, ImageDetIter):
            raise AssertionError("only syncs with another ImageDetIter")
        train_shape = self.label_shape
        val_shape = it.label_shape
        unified = (max(train_shape[0], val_shape[0]), train_shape[1])
        if unified != train_shape:
            self.reshape(label_shape=unified)
        if unified != val_shape:
            it.reshape(label_shape=unified)
        if verbose and unified != (train_shape and val_shape):
            logging.info("Resized label_shape to %s.", str(unified))
        return unified

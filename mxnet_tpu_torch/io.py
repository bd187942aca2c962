"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter`` and
``NDArrayIter``.

Counterpart of ``mxnet_tpu/io.py``, limited to the in-memory iterator
``Module.fit`` needs. Batches are NDArrays on the iterator's device: numpy
data stays on the host, as MXNet's iterators keep it, and NDArrays keep
their own device; ``Module`` copies each batch into its bound arrays on
its own device. The record-file, image, CSV and prefetching iterators
wait for later slices.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from . import ndarray as nd
from .context import cpu
from .ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "pad_batch_to_bound"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data descriptor: name/shape/type/layout (reference: io.py:43)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (reference: io.py:116)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        label_shapes = [l.shape for l in self.label] if self.label else None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


def _pad_rows(arr, extra):
    return nd.concatenate(
        [arr, nd.zeros((extra,) + tuple(arr.shape[1:]), ctx=arr.context,
                       dtype=arr.dtype)])


def pad_batch_to_bound(batch, data_descs, label_descs=None):
    """Pad a trailing short batch up to the bound batch size.

    Rather than re-binding the executor for a short final batch's
    one-off shape, pad the batch's data (and labels, when bound) with zero rows up to
    the shapes in ``data_descs``/``label_descs`` and let the caller
    slice the outputs back down; the bound-shape program serves every
    batch of the epoch. Returns ``(batch, extra)`` where ``extra`` is
    the number of synthetic rows appended (0 means the original batch
    came back untouched — full-size batches, non-leading batch axes,
    and bucketing batches, whose shapes the bucket key owns).
    """
    if batch.bucket_key is not None or not batch.data:
        return batch, 0
    # accept bare (name, shape) pairs — the form user iterators may
    # expose as provide_data — alongside DataDesc
    data_descs = [d if isinstance(d, DataDesc) else DataDesc(d[0], d[1])
                  for d in data_descs]
    if label_descs:
        label_descs = [d if isinstance(d, DataDesc) else DataDesc(d[0], d[1])
                       for d in label_descs]
    axes = [DataDesc.get_batch_axis(getattr(d, "layout", None) or "NCHW")
            for d in data_descs]
    if any(axis != 0 for axis in axes):
        return batch, 0
    incoming = batch.data[0].shape[0]
    bound = data_descs[0].shape[0]
    extra = bound - incoming
    if extra <= 0:
        return batch, 0
    data = [_pad_rows(arr, desc.shape[0] - arr.shape[0])
            if desc.shape[0] > arr.shape[0] else arr
            for arr, desc in zip(batch.data, data_descs)]
    label = batch.label
    if label and label_descs:
        label = [_pad_rows(arr, desc.shape[0] - arr.shape[0])
                 if desc.shape[0] > arr.shape[0] else arr
                 for arr, desc in zip(label, label_descs)]
    padded = DataBatch(data=data, label=label, pad=(batch.pad or 0) + extra,
                       index=batch.index)
    return padded, extra


class DataIter:
    """Base iterator (reference: io.py:177). The JAX package's position
    checkpoints (``get_state`` / ``set_state`` / ``skip_batches``) serve
    ``fit(resume=...)`` and wait for it (``ROADMAP.md`` Queue A13)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def close(self):
        """Release background resources (threads, pools, readers);
        idempotent. The base iterator holds none."""

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


def _init_data(data, allow_empty, default_name):
    """Normalize input data to list of (name, numpy) (reference: io.py:466)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError(
            "Input must be NDArray, numpy.ndarray, a list of them or dict "
            "with them as values")
    for k, v in data.items():
        if not isinstance(v, NDArray):
            try:
                data[k] = nd.array(np.asarray(v), ctx=cpu())
            except Exception:
                raise TypeError("Invalid type '%s' for %s, should be NDArray "
                                "or numpy.ndarray" % (type(v), k))
    return list(sorted(data.items()))


class NDArrayIter(DataIter):
    """In-memory iterator with pad/discard/roll_over (reference: io.py:545)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, nd.array(v.asnumpy()[self.idx], ctx=v.context))
                         for k, v in self.data]
            self.label = [(k, nd.array(v.asnumpy()[self.idx], ctx=v.context))
                          for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = self.data[0][1].shape[0] - \
                self.data[0][1].shape[0] % batch_size
            self.idx = self.idx[:new_n]
        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % \
                self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            return [x[1][self.cursor:self.cursor + self.batch_size]
                    for x in data_source]
        # padding wrap-around
        pad = self.batch_size - self.num_data + self.cursor
        return [nd.array(np.concatenate(
            [x[1].asnumpy()[self.cursor:], x[1].asnumpy()[:pad]], axis=0),
            ctx=x[1].context) for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

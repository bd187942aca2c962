"""Datasets (reference: gluon/data/dataset.py).

Counterpart of ``mxnet_tpu/gluon/data/dataset.py``: Dataset with
``transform`` / ``transform_first``, SimpleDataset, ArrayDataset and
RecordFileDataset (raw records of a ``.rec`` through its ``.idx``).
"""
from __future__ import annotations

import threading

from ... import ndarray as nd

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset (reference: dataset.py:Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """(reference: dataset.py:transform)"""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """(reference: dataset.py:transform_first)"""
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    """Wrap a list-like (reference: dataset.py:SimpleDataset)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of array-likes (reference: dataset.py:ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; array[0] has length " \
                "%d while array[%d] has %d." % (self._length, i, len(data))
            if isinstance(data, nd.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO (.rec) file with its .idx sidecar
    (reference: gluon/data/dataset.py:74): item ``i`` is the raw bytes of
    the i-th indexed record. Safe to index from several threads (the
    DataLoader's thread pool): one reader's seek and read go together
    under a lock."""

    def __init__(self, filename):
        import os

        from ... import recordio
        from ...base import MXNetError

        idx_file = os.path.splitext(filename)[0] + ".idx"
        if not os.path.exists(idx_file):
            raise MXNetError(
                "RecordFileDataset needs the .idx sidecar for random "
                "access; %r not found" % (idx_file,))
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")
        self._lock = threading.Lock()

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_lock")
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)

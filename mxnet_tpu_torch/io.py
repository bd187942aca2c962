"""Data iterators (reference: python/mxnet/io.py + src/io/).

Counterpart of ``mxnet_tpu/io.py``: ``NDArrayIter``, ``ResizeIter``,
``PrefetchingIter``, ``MNISTIter``, ``CSVIter`` and the ``ImageRecordIter``
/ ``ImageDetRecordIter`` factories, with ``StreamingIter`` (the streaming
pipeline of ``runtime/pipeline.py``) exposed here. In-memory data stays
on the host, as MXNet's iterators keep it, and NDArrays keep their own
device; ``Module`` copies each batch into its bound arrays on its own
device. The image iterators decode and augment on the host in numpy and
PIL and put each finished batch on their device (``device=``, else the
``with`` scope at construction, else the card). ``LibSVMIter`` produces
CSR batches and waits for the sparse NDArray (ROADMAP.md Queue A13).
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
from collections import namedtuple

import numpy as np

from . import ndarray as nd
from .base import MXNetError
from .context import cpu
from .ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "MXDataIter",
           "ResizeIter", "PrefetchingIter", "NDArrayIter", "MNISTIter",
           "CSVIter", "ImageRecordIter", "ImageDetRecordIter",
           "pad_batch_to_bound", "StreamingIter"]


def __getattr__(attr):
    # the streaming pipeline lives in runtime/ (it depends on image and
    # recordio, which import this module): expose it here lazily so
    # ``mx.io.StreamingIter`` reads like the other iterators
    if attr == "StreamingIter":
        from .runtime.pipeline import StreamingIter

        return StreamingIter
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, attr))


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
    """Base iterator (reference: io.py:177), with the JAX package's
    position protocol: ``get_state()`` returns a JSON-safe snapshot of the
    stream position (or None when unsupported), ``set_state()`` restores
    it and ``skip_batches(n)`` fast-forwards. ``NDArrayIter`` and the
    record iterators implement it; ``fit(resume=...)`` rides it."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def close(self):
        """Release background resources (threads, pools, readers);
        idempotent. The base iterator holds none."""

    def get_state(self):
        """JSON-safe position snapshot, or None (not checkpointable)."""
        return None

    def set_state(self, state):
        """Restore a :meth:`get_state` snapshot; raises when this
        iterator cannot (a None state is always accepted as a no-op)."""
        if state is not None:
            raise MXNetError("%s does not support set_state"
                             % type(self).__name__)

    def skip_batches(self, n):
        """Fast-forward ``n`` batches. The base implementation consumes
        them; subclasses with random access override with cursor math."""
        for _ in range(int(n)):
            try:
                self.next()
            except StopIteration:
                return

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


class ResizeIter(DataIter):
    """Resize an iterator to ``size`` batches per epoch (reference: io.py:279)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Thread-prefetching decorator over one or more iterators
    (reference: io.py:344 — python analog of src/io/iter_prefetcher.h)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self._queues = [queue.Queue(maxsize=prefetch_depth)
                        for _ in range(self.n_iter)]
        self._stop = threading.Event()
        self._threads = []
        self._life = threading.RLock()  # serializes close/reset/set_state
        self._closed = False            # guarded-by: self._life
        self._delivered = 0
        self._child_states = None       # children's epoch-start states
        self._start_threads()

    def _start_threads(self):
        # epoch-start child positions, captured BEFORE the producers
        # start reading ahead — the half of get_state() that stays
        # meaningful while the queues run ahead of the consumer
        self._child_states = [getattr(i, "get_state", lambda: None)()
                              for i in self.iters]
        stop, queues = self._stop, self._queues

        def put(q, item):
            # bounded put that aborts on shutdown so producer threads never
            # sit blocked inside native code at interpreter teardown
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer(i):
            while not stop.is_set():
                try:
                    batch = self.iters[i].next()
                except StopIteration:
                    put(queues[i], None)
                    return
                if not put(queues[i], batch):
                    return

        self._threads = [threading.Thread(target=producer, args=(i,),
                                          daemon=True)
                         for i in range(self.n_iter)]
        for t in self._threads:
            t.start()

    def _halt(self):
        """Stop and join the producer threads, draining the queues so a
        producer blocked on a full queue unwedges."""
        self._stop.set()
        for q in self._queues:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=5)
        self._threads = []

    def close(self):
        """Stop producer threads and close the wrapped iterators (their
        decode pools / record readers). Idempotent, and safe against a
        concurrent ``reset()`` — both take the lifecycle lock (also
        runs at gc/exit)."""
        with self._life:
            if self._closed:
                return
            self._closed = True
            self._halt()
            # unwedge a next() that passed its _closed check before this
            # close landed: with the producers joined its q.get() would
            # block forever — the epoch-end sentinel turns the race into
            # StopIteration
            for q in self._queues:
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass
            for i in self.iters:
                closer = getattr(i, "close", None)
                if closer is not None:
                    try:
                        closer()
                    except Exception:
                        pass  # gc/exit path: never raise out of close

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _restart(self):
        depth = self._queues[0].maxsize if self._queues else 2
        self._stop = threading.Event()
        self._queues = [queue.Queue(maxsize=depth)
                        for _ in range(self.n_iter)]
        self._start_threads()

    def reset(self):
        # drain, stop producers, reset children, restart
        with self._life:
            if self._closed:
                raise MXNetError("reset() on a closed PrefetchingIter")
            self._halt()
            for i in self.iters:
                i.reset()
            self._delivered = 0
            self._restart()

    def next(self):
        # unlocked flag read: after close() the producers are joined and
        # the queues drained, so q.get() would block forever — raise like
        # the other lifecycle-guarded methods instead
        if self._closed:
            raise MXNetError("next() on a closed PrefetchingIter")
        batches = [q.get() for q in self._queues]
        if any(b is None for b in batches):
            assert all(b is None for b in batches), \
                "Number of entry mismatches between iterators"
            raise StopIteration
        self._delivered += 1
        return DataBatch(
            data=sum([b.data for b in batches], []),
            label=sum([(b.label or []) for b in batches], []),
            pad=batches[0].pad, index=batches[0].index,
            provide_data=self.provide_data, provide_label=self.provide_label)

    def get_state(self):
        """Epoch-start child states + batches delivered — exactly
        reconstructible no matter how far the producers read ahead;
        None when any wrapped iterator is not checkpointable."""
        if self._child_states is None or \
                any(s is None for s in self._child_states):
            return None
        return {"children": list(self._child_states),
                "delivered": int(self._delivered)}

    def set_state(self, state):
        if state is None:
            return
        with self._life:
            if self._closed:
                raise MXNetError("set_state() on a closed PrefetchingIter")
            if len(state["children"]) != len(self.iters):
                # validate BEFORE halting: a zip would silently truncate
                # and leave the unmatched children at misaligned positions
                raise MXNetError(
                    "iterator state holds %d child streams, this "
                    "PrefetchingIter wraps %d"
                    % (len(state["children"]), len(self.iters)))
            self._halt()
            try:
                delivered = int(state.get("delivered", 0))
                for child, s in zip(self.iters, state["children"]):
                    child.set_state(s)
                    child.skip_batches(delivered)
            except BaseException:
                # a child rejected its snapshot AFTER earlier children
                # restored: re-align everyone to a fresh epoch start so
                # the restart below can never serve batches that pair
                # rows from different stream positions
                for child in self.iters:
                    child.reset()
                raise
            finally:
                # restart EVEN on failure (mismatched dataset/shard):
                # fit's consume-and-skip fallback needs live producers,
                # not a pipeline wedged between _halt() and _restart().
                # _restart snapshots the (fast-forwarded) child
                # positions as the new base, so the delivered counter
                # restarts at 0 — get_state stays exactly
                # reconstructible after a restore
                self._restart()
                self._delivered = 0

    def skip_batches(self, n):
        """Fast-forward by the children's cursor math — no decode, no
        queue consumption (the base implementation would make the
        producers decode every skipped batch).

        Positions ABSOLUTELY from the epoch-start base at
        ``delivered + n`` (the StreamingIter discipline): the producers
        may already have read ahead of the consumer, so a relative skip
        from the children's current cursors would overshoot by whatever
        they prefetched."""
        if n <= 0:
            return
        with self._life:
            if self._closed:
                raise MXNetError("skip_batches() on a closed "
                                 "PrefetchingIter")
            states = self._child_states
            if states is None or any(s is None for s in states):
                # no checkpointable base: consume-and-discard (exact,
                # but decodes the skipped batches)
                return super().skip_batches(n)
            self._halt()
            try:
                target = self._delivered + int(n)
                for child, s in zip(self.iters, states):
                    child.set_state(s)
                    child.skip_batches(target)
            finally:
                # _restart re-bases the child snapshots, so the
                # delivered counter restarts at 0 (the set_state
                # discipline) — get_state stays exactly reconstructible
                self._restart()
                self._delivered = 0

    def iter_next(self):
        try:
            self._cached = self.next()
            return True
        except StopIteration:
            return False


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

    def skip_batches(self, n):
        self.cursor += int(n) * self.batch_size

    def get_state(self):
        """Cursor + the construction-time shuffle permutation (the data
        order is fixed for the iterator's lifetime, so the permutation
        plus the cursor pin the stream position exactly)."""
        return {"cursor": int(self.cursor),
                "idx": np.asarray(self.idx).tolist()}

    def set_state(self, state):
        """Restore a snapshot — possibly from another process whose
        construction-time shuffle differed: the data is re-gathered into
        the saved permutation's order first."""
        if state is None:
            return
        saved = np.asarray(state["idx"], dtype=np.int64)
        current = np.asarray(self.idx, dtype=np.int64)
        if saved.shape != current.shape:
            raise MXNetError(
                "iterator state does not match this dataset "
                "(%d vs %d indexed rows)" % (saved.size, current.size))
        if not np.array_equal(saved, current):
            if len(current) != self.data_list[0].shape[0]:
                raise MXNetError(
                    "cannot restore a shuffled-state snapshot onto a "
                    "truncated (last_batch_handle='discard') iterator "
                    "with a different permutation")
            inverse = np.empty_like(current)
            inverse[current] = np.arange(len(current))
            take = inverse[saved]
            self.data = [(k, nd.array(v.asnumpy()[take], ctx=v.context))
                         for k, v in self.data]
            self.label = [(k, nd.array(v.asnumpy()[take], ctx=v.context))
                          for k, v in self.label]
            self.data_list = [x[1] for x in self.data] + \
                [x[1] for x in self.label]
            self.idx = saved
        self.cursor = int(state["cursor"])


def _read_idx_ubyte(path):
    """Read an MNIST idx-format file, gzipped or raw."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


class MNISTIter(NDArrayIter):
    """MNIST idx-file iterator (reference: src/io/iter_mnist.cc, exposed as
    mx.io.MNISTIter). Reads the same image/label idx files; ``flat`` selects
    (B, 784) vs (B, 1, 28, 28)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=0, input_shape=None, **kwargs):
        for p in (image, label):
            if not (os.path.exists(p) or os.path.exists(p + ".gz")):
                raise MXNetError("MNISTIter: file not found: %s" % p)
        image = image if os.path.exists(image) else image + ".gz"
        label = label if os.path.exists(label) else label + ".gz"
        img = _read_idx_ubyte(image).astype(np.float32) / 255.0
        lbl = _read_idx_ubyte(label).astype(np.float32)
        if flat:
            img = img.reshape(img.shape[0], -1)
        elif input_shape is not None:
            img = img.reshape((img.shape[0],) + tuple(input_shape))
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        if shuffle:
            rng = np.random.RandomState(seed)
            order = rng.permutation(img.shape[0])
            img, lbl = img[order], lbl[order]
        super().__init__(img, lbl, batch_size=batch_size, shuffle=False,
                         last_batch_handle="discard")


class CSVIter(NDArrayIter):
    """CSV file iterator (reference: src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="discard")


def ImageRecordIter(path_imgrec, data_shape, batch_size, path_imgidx=None,
                    shuffle=False, rand_crop=False, rand_mirror=False,
                    resize=0, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                    std_r=1.0, std_g=1.0, std_b=1.0, label_width=1,
                    num_parts=1, part_index=0, preprocess_threads=None,
                    prefetch_buffer=None, dtype="float32", seed=None,
                    streaming=None, **kwargs):
    """Factory mirroring the C++ ImageRecordIter registration
    (reference: src/io/iter_image_recordio_2.cc:50 ImageRecordIOParser2 +
    MXNET_REGISTER_IO_ITER(ImageRecordIter); python surface io.py:762
    MXDataIter): a record-file image source with the default augmenter
    stack, distributed num_parts/part_index sharding, and prefetching.

    Two backends behind one surface:

    * ``streaming=False`` (the MXNET-1.0 shape) — a PrefetchingIter
      wrapping an image.ImageIter: one prefetch thread double-buffering
      synchronous batch assembly (iter_prefetcher.h:47);
    * ``streaming=True`` (or ``MXNET_IO_STREAMING=1``) — the async
      runtime pipeline (:class:`~.runtime.pipeline.StreamingIter`):
      parallel decode workers, batch assembly + padding off the
      training thread, double-buffered device staging. Batch-for-batch
      identical output for unshuffled or same-``seed`` streams with
      deterministic augmenters (tests/test_torch_streaming.py); unseeded
      shuffles draw a fresh order per construction, and random
      augmenters per-worker randomness, on both backends.

    ``preprocess_threads``/``prefetch_buffer`` left at None defer to
    the ``io.decode_workers``/``io.prefetch_depth`` autotuner entries,
    then the ``MXNET_IO_*`` flags (streaming path), or the reference
    defaults of 4 (synchronous path). ``device=`` (in ``kwargs``) places
    the batches; None is the ``with`` scope at construction, else the
    card.
    """
    from .config import get_flag

    mean = None
    if mean_r or mean_g or mean_b:
        mean = np.array([mean_r, mean_g, mean_b], np.float32)
    std = None
    if (std_r, std_g, std_b) != (1.0, 1.0, 1.0):
        std = np.array([std_r, std_g, std_b], np.float32)
    if streaming is None:
        streaming = bool(get_flag("MXNET_IO_STREAMING"))
        if streaming:
            # the GLOBAL flag must not hard-fail workloads only the
            # synchronous backend supports (an index-less .rec falls
            # back to sequential imgrec.read() there; the streaming
            # source needs random access) — degrade with a warning.
            # An explicit streaming=True argument keeps the clear error.
            if path_imgidx is None:
                guess = os.path.splitext(path_imgrec)[0] + ".idx"
                if not os.path.exists(guess):
                    import logging

                    logging.getLogger(__name__).warning(
                        "MXNET_IO_STREAMING=1 ignored for %r: the "
                        "streaming source needs a .idx companion "
                        "(falling back to the synchronous backend)",
                        path_imgrec)
                    streaming = False
    if streaming:
        from .runtime.pipeline import StreamingIter

        return StreamingIter(
            path_imgrec=path_imgrec, path_imgidx=path_imgidx,
            data_shape=tuple(data_shape), batch_size=batch_size,
            label_width=label_width, shuffle=shuffle,
            seed=seed, num_parts=num_parts,
            part_index=part_index, dtype=dtype,
            decode_workers=preprocess_threads,
            prefetch_depth=prefetch_buffer, resize=resize,
            rand_crop=rand_crop, rand_mirror=rand_mirror, mean=mean,
            std=std, **kwargs)
    from .image import ImageIter

    inner = ImageIter(
        batch_size=batch_size, data_shape=tuple(data_shape),
        label_width=label_width, path_imgrec=path_imgrec,
        path_imgidx=path_imgidx, shuffle=shuffle, part_index=part_index,
        num_parts=num_parts, dtype=dtype, resize=resize,
        rand_crop=rand_crop, rand_mirror=rand_mirror, mean=mean, std=std,
        seed=seed,
        preprocess_threads=(4 if preprocess_threads is None
                            else preprocess_threads), **kwargs)
    return PrefetchingIter(inner, prefetch_depth=(
        4 if prefetch_buffer is None else prefetch_buffer))


def ImageDetRecordIter(path_imgrec, data_shape, batch_size,
                       path_imgidx=None, shuffle=False, num_parts=1,
                       part_index=0, preprocess_threads=4,
                       label_pad_width=0, label_pad_value=-1.0, **kwargs):
    """Factory mirroring the C++ ImageDetRecordIter registration
    (reference: src/io/iter_image_det_recordio.cc:582): a record-file
    detection source feeding ImageDetIter's augmenter chain with padded
    variable-box labels.

    ``label_pad_width`` optionally forces the padded object count
    (otherwise scanned from the data); extra kwargs flow to
    CreateDetAugmenter (rand_crop / rand_pad / rand_mirror / mean / std
    ...).
    """
    from .image.detection import ImageDetIter

    it = ImageDetIter(batch_size=batch_size, data_shape=tuple(data_shape),
                      path_imgrec=path_imgrec, path_imgidx=path_imgidx,
                      shuffle=shuffle, num_parts=num_parts,
                      part_index=part_index,
                      preprocess_threads=preprocess_threads, **kwargs)
    if label_pad_width and label_pad_width > it.label_shape[0]:
        it.reshape(label_shape=(label_pad_width, it.label_shape[1]))
    return it


# The reference returns MXDataIter (a wrapper over the C++ iterator
# handle, io.py:762) from factory iterators like CSVIter/ImageRecordIter;
# here the factories return Python DataIter subclasses directly, so the
# name aliases the base class: isinstance(it, mx.io.MXDataIter) holds for
# every built-in iterator.
MXDataIter = DataIter

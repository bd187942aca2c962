"""DataLoader (reference: gluon/data/dataloader.py).

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py``. Samples are
batched on the host (numpy) and each batch becomes one NDArray in the
caller's ``with`` scope, else on the card. ``num_workers`` > 0 loads
batches ahead in a thread pool (``thread_pool=True``, the default: numpy
releases the GIL) or in spawned worker processes that send numpy batches
back (``thread_pool=False``, the reference's ``_MultiWorkerIter``).
"""
from __future__ import annotations

import contextlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ... import ndarray as nd
from ...context import _ctx_stack
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference: dataloader.py
    default_batchify_fn)."""
    if isinstance(data[0], nd.NDArray):
        return nd.array(np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)
    return nd.array(data, dtype=data.dtype)


def _np_batchify(data):
    """Worker-side batchify to plain numpy (safe to pickle across
    processes; the parent wraps to NDArray once per batch — the role of
    the reference's CPUShared zero-copy NDArrays, dataloader.py:240)."""
    if isinstance(data[0], tuple):
        return [_np_batchify(list(i)) for i in zip(*data)]
    first = data[0]
    if hasattr(first, "asnumpy"):
        return np.stack([d.asnumpy() for d in data])
    return np.asarray(data)


_mp_dataset = None


def _mp_init(dataset):
    global _mp_dataset
    _mp_dataset = dataset


def _mp_load(indices):
    return _np_batchify([_mp_dataset[i] for i in indices])


def _mp_load_raw(indices):
    return [_mp_dataset[i] for i in indices]


def _shutdown_pool(pool):
    """Stop a worker pool without waiting on batches still in flight."""
    pool.shutdown(wait=True, cancel_futures=True)


def _wrap_np(batch):
    if isinstance(batch, list):
        return [_wrap_np(b) for b in batch]
    return nd.array(batch, dtype=batch.dtype)


class DataLoader:
    """Mini-batch loader over a Dataset (reference: dataloader.py
    DataLoader); see the module docstring for the worker paths."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, thread_pool=True):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._thread_pool = thread_pool

    def _get_pool(self):
        """Worker processes stay alive across epochs, as the reference's
        _MultiWorkerIter pool; spawned once per loader (a fork would copy
        torch's threads), the dataset shipped to them once. A
        ``ProcessPoolExecutor``: when a worker dies, every batch in flight
        fails with ``BrokenProcessPool`` instead of waiting forever."""
        if getattr(self, "_pool", None) is None:
            import multiprocessing as mp
            import weakref
            from concurrent.futures import ProcessPoolExecutor

            self._pool = ProcessPoolExecutor(
                self._num_workers, mp_context=mp.get_context("spawn"),
                initializer=_mp_init, initargs=(self._dataset,))
            self._pool_finalizer = weakref.finalize(
                self, _shutdown_pool, self._pool)
        return self._pool

    def close(self):
        """Shut the worker processes down now (they are spawned again by
        the next multi-process iteration)."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            self._pool = None
            self._pool_finalizer.detach()
            _shutdown_pool(pool)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _iter_multiprocess(self):
        """Process-based workers (reference: dataloader.py _MultiWorkerIter
        + worker_loop); results come back as numpy and are wrapped once in
        the parent. An exhausted epoch leaves the workers up for the next
        one; an epoch abandoned (the iterator closed) or failed (a worker
        died, a sample raised) shuts them down."""
        custom_fn = (self._batchify_fn
                     if self._batchify_fn is not default_batchify_fn
                     else None)
        loader = _mp_load_raw if custom_fn else _mp_load
        pool = self._get_pool()
        depth = 2 * self._num_workers
        pending = deque()
        it = iter(self._batch_sampler)
        done = False
        try:
            for _ in range(depth):
                batch = next(it, None)
                if batch is None:
                    break
                pending.append(pool.submit(loader, list(batch)))
            while pending:
                fut = pending.popleft()
                batch = next(it, None)
                if batch is not None:
                    pending.append(pool.submit(loader, list(batch)))
                got = fut.result()
                # a custom batchify_fn runs in the parent over the raw
                # samples the workers fetched (the fn may close over
                # unpicklable state)
                yield custom_fn(got) if custom_fn else _wrap_np(got)
            done = True
        finally:
            if not done:
                self.close()

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._batchify_fn(
                    [self._dataset[idx] for idx in batch])
            return
        if not self._thread_pool:
            yield from self._iter_multiprocess()
            return

        # the workers batchify in the caller's device scope
        stack = _ctx_stack()
        scope = stack[-1] if stack else None

        def _load(b):
            with scope if scope is not None else contextlib.nullcontext():
                return self._batchify_fn([self._dataset[idx] for idx in b])

        # bounded prefetch: 2 x num_workers batches in flight, as the
        # reference's _MultiWorkerIter keeps queued
        depth = 2 * self._num_workers
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            pending = deque()
            it = iter(self._batch_sampler)
            try:
                for _ in range(depth):
                    pending.append(pool.submit(_load, next(it)))
            except StopIteration:
                it = None
            while pending:
                fut = pending.popleft()
                if it is not None:
                    try:
                        pending.append(pool.submit(_load, next(it)))
                    except StopIteration:
                        it = None
                yield fut.result()

    def __len__(self):
        return len(self._batch_sampler)

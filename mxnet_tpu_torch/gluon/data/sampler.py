"""Index samplers for the Gluon DataLoader.

Counterpart of ``mxnet_tpu/gluon/data/sampler.py`` (reference:
gluon/data/sampler.py): Sampler, SequentialSampler, RandomSampler (a
``np.random`` permutation per epoch) and BatchSampler with its keep /
discard / rollover tail policies.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]

_TAIL_POLICIES = ("keep", "discard", "rollover")


class Sampler:
    """Iterable over sample indices; subclasses define order and length."""

    def _abstract(self):
        raise NotImplementedError

    __iter__ = _abstract
    __len__ = _abstract


class _RangeSampler(Sampler):
    """Indices 0..length-1 in an order given by ``_order``."""

    def __init__(self, length):
        self._n = int(length)

    def __len__(self):
        return self._n

    def _order(self):
        raise NotImplementedError

    def __iter__(self):
        return iter(self._order())


class SequentialSampler(_RangeSampler):
    """Natural order."""

    def _order(self):
        return range(self._n)


class RandomSampler(_RangeSampler):
    """A fresh uniform permutation per epoch."""

    def _order(self):
        return np.random.permutation(self._n)


class BatchSampler(Sampler):
    """Group a sampler's indices into lists of ``batch_size``.

    Tail handling: ``keep`` yields the short final batch, ``discard`` drops
    it, ``rollover`` saves it to prepend to the next epoch.
    """

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _TAIL_POLICIES:
            raise ValueError(
                f"last_batch must be one of {_TAIL_POLICIES}, got {last_batch}")
        self._source = sampler
        self._size = int(batch_size)
        self._tail = last_batch
        self._carry = []

    def _chunks(self):
        buf = list(self._carry)
        self._carry = []
        for idx in self._source:
            buf.append(idx)
            if len(buf) >= self._size:
                yield buf
                buf = []
        if buf:
            yield buf  # short tail, policy applied by caller

    def __iter__(self):
        for chunk in self._chunks():
            if len(chunk) == self._size:
                yield chunk
            elif self._tail == "keep":
                yield chunk
            elif self._tail == "rollover":
                self._carry = chunk

    def __len__(self):
        n = len(self._source)
        if self._tail == "rollover":
            n += len(self._carry)
        if self._tail == "keep":
            n += self._size - 1
        return n // self._size

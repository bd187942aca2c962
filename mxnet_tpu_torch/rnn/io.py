"""Bucketed sequence iterators for the symbolic RNN toolkit.

Counterpart of ``mxnet_tpu/rnn/io.py`` (reference rnn/io.py:
encode_sentences, BucketSentenceIter — the feeder for BucketingModule),
with the same seeds, buckets and batches: sentences are grouped into fixed-length buckets
up front as dense padded matrices, and next-token labels are derived from
the data matrix by a one-step shift at batch time rather than being
materialised at reset. The bucket matrices are shuffled with
``np.random`` and the batch schedule with ``random``, as in the JAX
package; the batches live where ``nd.array`` puts them (the caller's
``with`` scope, else the card).
"""
from __future__ import annotations

import bisect
import random
import numpy as np

from .. import ndarray as nd
from ..io import DataIter, DataBatch, DataDesc

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Map token sequences to integer id sequences.

    When ``vocab`` is None a new vocabulary is grown on the fly (ids start at
    ``start_label``, skipping ``invalid_label``); otherwise unknown tokens
    are an error. Returns (encoded sentences, vocab).
    """
    growing = vocab is None
    if growing:
        vocab = {invalid_key: invalid_label}
    next_id = start_label

    def intern(tok):
        nonlocal next_id
        if tok not in vocab:
            if not growing:
                raise AssertionError(f"Unknown token {tok}")
            if next_id == invalid_label:
                next_id += 1
            vocab[tok] = next_id
            next_id += 1
        return vocab[tok]

    return [[intern(w) for w in s] for s in sentences], vocab


def _auto_buckets(lengths, min_count):
    """Pick bucket sizes: every sentence length observed at least
    ``min_count`` times becomes a bucket boundary."""
    counts = np.bincount(lengths)
    return [size for size in range(len(counts)) if counts[size] >= min_count]


class BucketSentenceIter(DataIter):
    """Iterate fixed-shape batches drawn from length-bucketed sentences.

    Each bucket is a dense ``(num_sentences, bucket_len)`` matrix padded with
    ``invalid_label``. Batches carry ``bucket_key`` so BucketingModule can
    select the matching unrolled graph. ``layout`` is "NT" (batch-major) or
    "TN" (time-major).
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__()
        lengths = [len(s) for s in sentences]
        sizes = sorted(buckets) if buckets else _auto_buckets(lengths, batch_size)
        if not sizes:
            raise ValueError("no usable buckets for the given corpus")

        rows = [[] for _ in sizes]
        dropped = 0
        for sent, n in zip(sentences, lengths):
            slot = bisect.bisect_left(sizes, n)
            if slot >= len(sizes):
                dropped += 1
            else:
                rows[slot].append(np.asarray(sent, dtype=dtype))
        if dropped:
            print(f"WARNING: discarded {dropped} sentences longer than the "
                  f"largest bucket.")

        self._buckets = []
        for size, group in zip(sizes, rows):
            mat = np.full((len(group), size), invalid_label, dtype=dtype)
            for r, sent in enumerate(group):
                mat[r, :len(sent)] = sent
            self._buckets.append(mat)

        self.dtype, self.layout = dtype, layout
        self.data_name, self.label_name = data_name, label_name
        self.batch_size, self.invalid_label = batch_size, invalid_label
        self.buckets = sizes
        self.default_bucket_key = sizes[-1]
        if layout == "NT":
            self._time_major = False
        elif layout == "TN":
            self._time_major = True
        else:
            raise ValueError(
                f"Invalid layout {layout}: Must by NT (batch major) or TN "
                f"(time major)")

        self.provide_data = [self._desc(data_name, self.default_bucket_key)]
        self.provide_label = [self._desc(label_name, self.default_bucket_key)]

        self._schedule = []  # (bucket index, row offset) pairs, shuffled
        self._cursor = 0
        self._device_cache = None
        self.reset()

    def _desc(self, name, seq_len, batch=None):
        batch = batch if batch is not None else self.batch_size
        shape = (seq_len, batch) if self._time_major else (batch, seq_len)
        return DataDesc(name=name, shape=shape, layout=self.layout)

    def _shifted(self, mat):
        """Next-token labels: data shifted left one step, tail padded."""
        pad = np.full((mat.shape[0], 1), self.invalid_label, dtype=mat.dtype)
        return np.concatenate([mat[:, 1:], pad], axis=1)

    def reset(self):
        self._cursor = 0
        for mat in self._buckets:
            np.random.shuffle(mat)
        self._schedule = [
            (b, off)
            for b, mat in enumerate(self._buckets)
            for off in range(0, mat.shape[0] - self.batch_size + 1,
                             self.batch_size)]
        random.shuffle(self._schedule)
        self._device_cache = [
            (nd.array(mat, dtype=self.dtype),
             nd.array(self._shifted(mat), dtype=self.dtype))
            for mat in self._buckets]

    def next(self):
        if self._cursor >= len(self._schedule):
            raise StopIteration
        b, off = self._schedule[self._cursor]
        self._cursor += 1
        dmat, lmat = self._device_cache[b]
        data = dmat[off:off + self.batch_size]
        label = lmat[off:off + self.batch_size]
        if self._time_major:
            data, label = data.T, label.T
        descs = [DataDesc(name=n, shape=t.shape, layout=self.layout)
                 for n, t in ((self.data_name, data), (self.label_name, label))]
        return DataBatch([data], [label], pad=0, bucket_key=self.buckets[b],
                         provide_data=descs[:1], provide_label=descs[1:])

"""Shard-aware record sources for the streaming input pipeline.

Counterpart of ``mxnet_tpu/runtime/source.py``. A *source* owns stage 1 of
the pipeline: deciding which records this worker reads, in what order, and
handing out raw (label, payload) pairs — decode and augmentation stay
downstream in the worker pool. Sharding follows dmlc ``InputSplit``
semantics (the reference's ``iter_image_recordio_2.cc:78`` path):
``num_parts``/``part_index`` cut the key list into contiguous ranges that
are **disjoint and complete** — every record lands in exactly one part,
uneven remainders are spread, nothing is dropped.

Epoch order is owned by a private ``numpy.random.RandomState`` so it is
seedable and checkpointable: :meth:`RecordFileSource.get_state` /
``set_state`` round-trip the cursor, the epoch order, and the RNG stream,
in the JAX package's JSON layout, so a state written by either package
resumes in the other.
"""
from __future__ import annotations

import threading

import numpy as np

from ..base import MXNetError

__all__ = ["shard_partition", "encode_rng_state", "decode_rng_state",
           "RecordFileSource"]


def shard_partition(n, num_parts, part_index):
    """The ``[lo, hi)`` index range of shard ``part_index`` out of
    ``num_parts`` over ``n`` items: contiguous, disjoint, complete
    (dmlc InputSplit semantics — uneven remainders spread one item at a
    time, never dropped)."""
    if num_parts < 1:
        raise MXNetError("num_parts must be >= 1, got %d" % num_parts)
    if not 0 <= part_index < num_parts:
        raise MXNetError("part_index %d out of range [0, %d)"
                         % (part_index, num_parts))
    bounds = np.linspace(0, int(n), num_parts + 1).astype(np.int64)
    return int(bounds[part_index]), int(bounds[part_index + 1])


def encode_rng_state(rng):
    """JSON-safe encoding of a ``numpy.random.RandomState``'s state."""
    if rng is None:
        return None
    name, keys, pos, has_gauss, cached = rng.get_state()
    return [name, np.asarray(keys).tolist(), int(pos), int(has_gauss),
            float(cached)]


def decode_rng_state(state):
    """Inverse of :func:`encode_rng_state`; returns a RandomState."""
    rng = np.random.RandomState()
    name, keys, pos, has_gauss, cached = state
    rng.set_state((str(name), np.asarray(keys, dtype=np.uint32), int(pos),
                   int(has_gauss), float(cached)))
    return rng


class RecordFileSource:
    """Raw-record source over a ``.rec`` (+ ``.idx``) file: this shard's
    keys in (optionally shuffled) epoch order, one ``read()`` at a time.

    ``shuffle=True`` requires random access (an index); the per-epoch
    permutation comes from the private seeded RNG so two processes
    constructed with the same ``seed`` produce identical epoch orders —
    and :meth:`get_state`/:meth:`set_state` restore an interrupted
    run's exact position (cursor + current epoch order + RNG stream).

    Reads are serialized by a lock so a feeder thread and a
    state-capturing consumer never interleave a seek/read pair.
    """

    def __init__(self, path_imgrec, path_imgidx=None, num_parts=1,
                 part_index=0, shuffle=False, seed=0):
        import os

        from .. import recordio

        if path_imgidx is None:
            guess = os.path.splitext(path_imgrec)[0] + ".idx"
            path_imgidx = guess if os.path.exists(guess) else None
        if path_imgidx is None:
            raise MXNetError(
                "RecordFileSource needs a .idx companion next to %r "
                "(sharding, shuffling and checkpointable position all "
                "require random access)" % (path_imgrec,))
        self._record = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec,
                                                  "r")
        all_keys = list(self._record.keys)
        lo, hi = shard_partition(len(all_keys), num_parts, part_index)
        self.num_parts = num_parts
        self.part_index = part_index
        self.shuffle = shuffle
        self.seed = seed
        self._base = all_keys[lo:hi]        # canonical shard order
        self._rng = np.random.RandomState(seed)
        self._order = list(self._base)      # guarded-by: self._lock
        self._cur = 0                       # guarded-by: self._lock
        self._epoch = 0                     # guarded-by: self._lock
        self._lock = threading.Lock()
        self._closed = False
        if shuffle:
            self._reshuffle_locked()

    # ------------------------------------------------------------ epoch
    def _reshuffle_locked(self):
        # caller holds self._lock — the _locked suffix contract
        order = list(self._base)
        if self.shuffle:
            self._rng.shuffle(order)
        self._order = order

    def reset(self):
        """Start the next epoch: cursor to 0, fresh shuffle (the RNG
        stream advances, so every epoch has a distinct order)."""
        with self._lock:
            self._cur = 0
            self._epoch += 1
            self._reshuffle_locked()

    def __len__(self):
        return len(self._base)

    @property
    def keys(self):
        """This shard's keys in canonical (unshuffled) order."""
        return list(self._base)

    def epoch_order(self):
        """The current epoch's key order (a copy)."""
        with self._lock:
            return list(self._order)

    # ------------------------------------------------------------- read
    def read(self):
        """Next raw record as ``(label, payload-bytes)``; raises
        StopIteration at epoch end (call :meth:`reset` for the next)."""
        from .. import recordio

        with self._lock:
            if self._closed:
                raise MXNetError("read() on a closed RecordFileSource")
            if self._cur >= len(self._order):
                raise StopIteration
            key = self._order[self._cur]
            self._cur += 1
            s = self._record.read_idx(key)
        header, payload = recordio.unpack(s)
        return header.label, payload

    def skip_samples(self, n):
        """Advance the cursor ``n`` samples without reading them
        (resume fast-forward — no decode, no IO)."""
        with self._lock:
            self._cur = min(self._cur + int(n), len(self._order))

    # ------------------------------------------------------------ state
    def get_state(self):
        """JSON-safe position: cursor + epoch order + RNG stream."""
        with self._lock:
            return {
                "cursor": int(self._cur),
                "epoch": int(self._epoch),
                "order": [int(k) for k in self._order],
                "rng": encode_rng_state(self._rng),
            }

    def set_state(self, state):
        """Restore :meth:`get_state`'s snapshot exactly: the current
        epoch replays the saved order from the saved cursor, and later
        epochs reshuffle from the saved RNG stream — bit-exact data
        order for the rest of the run."""
        with self._lock:
            order = [self._key_type(k) for k in state["order"]]
            if set(order) != set(self._base):
                # symmetric check: a strict-subset order (a snapshot
                # from a narrower shard) would otherwise restore
                # silently and truncate every epoch
                missing = set(order) ^ set(self._base)
                raise MXNetError(
                    "iterator state does not match this record file/shard "
                    "(%d mismatched keys, e.g. %r)"
                    % (len(missing), next(iter(missing))))
            self._order = order
            self._cur = int(state["cursor"])
            self._epoch = int(state.get("epoch", 0))
            if state.get("rng") is not None:
                self._rng = decode_rng_state(state["rng"])

    def _key_type(self, k):
        return self._record.key_type(k)

    # -------------------------------------------------------- lifecycle
    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._record.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

"""KVStore — the local key-value store for parameter synchronization.

Counterpart of ``mxnet_tpu/kvstore.py`` for the in-process types
(``local``, ``device`` and their aliases): ``init`` / ``push`` / ``pull``
with str or int keys, ``set_optimizer`` (the update then runs in the store
on push), ``rank`` / ``num_workers`` / ``barrier`` and the optimizer-state
files. A push sums the per-device values on the stored value's device
and, with an optimizer set, updates the stored weight in place; without
one it replaces the stored value. The distributed types (``dist_sync``,
``dist_async``, ``dist_device_sync``, ``dist``) and ``mesh`` are not
ported yet (``ROADMAP.md`` Queue A10); creating one raises.

Row-sparse values: a push of several row-sparse values merge-sums them
by row (``rsp_add``); with an optimizer set, a row-sparse stored value is
densified before its first update (the updater's lazy rows index a dense
weight); ``row_sparse_pull`` gathers only the requested rows on the
stored value's device, and ``pull`` into a sparse ``out`` casts storage.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ndarray import NDArray
from .ndarray import sparse as sp
from .ndarray.ndarray import _from_data
from .ndarray.sparse import rsp_add
from . import optimizer as opt

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_allreduce_cpu", "local_allreduce_device",
          "device", "nccl")
_NOT_PORTED = ("dist_sync", "dist_async", "dist_device_sync", "dist", "mesh")


def _key_value(keys, vals):
    """Normalize (keys, vals) to parallel flat lists of keys and value
    lists."""
    if isinstance(keys, (tuple, list)):
        if len(keys) != len(vals):
            raise MXNetError("%d keys for %d values" % (len(keys), len(vals)))
        flat_k, flat_v = [], []
        for k, v in zip(keys, vals):
            fk, fv = _key_value(k, v)
            flat_k.extend(fk)
            flat_v.extend(fv)
        return flat_k, flat_v
    if isinstance(vals, NDArray):
        return [keys], [[vals]]
    return [keys], [list(vals)]


def _updater_key(key):
    try:
        return int(key)
    except (TypeError, ValueError):
        return key


class KVStore:
    """In-process key-value store."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._data = {}   # key -> stored NDArray
        self._updater = None
        self._optimizer = None

    def init(self, key, value):
        keys, vals = _key_value(key, value)
        for k, vlist in zip(keys, vals):
            if k in self._data:
                raise MXNetError("key %r already initialized" % (k,))
            self._data[k] = vlist[0].copy()

    @staticmethod
    def _reduce(vlist, device):
        """Sum of the pushed values, on ``device``; row-sparse values
        merge-sum by row (reference: ReduceSumCPUExSerial,
        src/kvstore/comm.h)."""
        if any(v.stype == "row_sparse" for v in vlist):
            merged = vlist[0].copyto(device)
            for v in vlist[1:]:
                merged = rsp_add(merged, v)
            return merged
        total = vlist[0]._data.to(device, copy=True)
        for v in vlist[1:]:
            total += v._data.to(device)
        return _from_data(total)

    def push(self, key, value, priority=0):
        keys, vals = _key_value(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._data:
                raise MXNetError("key %r has not been initialized" % (k,))
            merged = self._reduce(vlist, self._data[k]._data.device)
            if self._updater is not None:
                if self._data[k].stype != "default":
                    # the lazy row updates index a dense weight
                    self._data[k] = self._data[k]._dense_nd()
                self._updater(_updater_key(k), merged, self._data[k])
            else:
                # a push replaces the stored value with the merged one
                self._data[k] = merged

    def pull(self, key, out=None, priority=0):
        if out is None:
            raise MXNetError("pull needs out=")
        keys, outs = _key_value(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._data:
                raise MXNetError("key %r has not been initialized" % (k,))
            for o in olist:
                self._data[k].copyto(o)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` of each key, as row_sparse,
        gathered on the stored value's device (reference:
        kvstore.py row_sparse_pull); ids out of range raise."""
        if out is None:
            raise MXNetError("row_sparse_pull needs out=")
        if row_ids is None:
            self.pull(key, out=out, priority=priority)
            return
        keys, outs = _key_value(key, out)
        if not isinstance(row_ids, (tuple, list)):
            row_ids = [row_ids] * len(keys)
        for k, olist, rids in zip(keys, outs, row_ids):
            if k not in self._data:
                raise MXNetError("key %r has not been initialized" % (k,))
            src = self._data[k]
            rid_list = rids if isinstance(rids, (tuple, list)) else [rids]
            if len(rid_list) == 1 and len(olist) > 1:
                rid_list = rid_list * len(olist)
            for o, rid in zip(olist, rid_list):
                self._pull_rows(k, src, o, rid)

    @staticmethod
    def _pull_rows(k, src, out, rid):
        dev = src._data.device
        want = torch.unique(sp._tensor(rid, "int64", dev).reshape(-1))
        if want.numel():
            lo, hi = torch.stack((want[0], want[-1])).tolist()
            if lo < 0 or hi >= src.shape[0]:
                raise MXNetError(
                    "row_ids out of range for key %r: [%d, %d] vs %d rows"
                    % (k, lo, hi, src.shape[0]))
        if isinstance(src, sp.RowSparseNDArray):
            res = sp.sparse_retain(src, want)
        else:
            res = sp._sparse_new(sp.RowSparseNDArray, src._data.detach()[want],
                                 (want,), src.shape)
        res.copyto(out)

    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_updater(self, updater):
        self._updater = updater

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        """A no-op: one process."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set on this store")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set on this store")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def create(name="local"):
    """A store of type ``name``: the local types map onto :class:`KVStore`;
    the distributed ones raise until they are ported."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in _NOT_PORTED:
        raise MXNetError("KVStore type %r is not yet ported (ROADMAP.md "
                         "Queue A10)" % name)
    if name not in _LOCAL:
        raise MXNetError("unknown KVStore type %r" % name)
    return KVStore(name)

"""``nd.save`` / ``nd.load`` in the reference's binary ``.params`` format.

Counterpart of ``mxnet_tpu/ndarray/utils.py`` (its own copy of the format:
the port imports nothing of the JAX package). ``save`` writes the dmlc
list container (``kMXAPINDArrayListMagic``) of V2 records (magic, storage
type, shape, context, dtype flag, raw bytes) and the key names, byte for
byte as the JAX package and MXNet write them, so checkpoints move between
the three in every direction. ``load`` also reads V1 and pre-V1 records
and the JAX package's earlier ``.npz`` archives.

Sparse records (row_sparse, csr) carry the storage shape, the aux
arrays' dtypes and shapes, then the values and the aux arrays (rsp:
indices; csr: indptr, indices), as the reference's ``NDArray::Save``.
Arrays load into host memory, where ``Module`` keeps its parameter
copies; the record's context is not read (the writers here store
``cpu(0)``).
"""
from __future__ import annotations

import struct
import zipfile

import numpy as np
import torch

from ..base import MXNetError
from .ndarray import NDArray, _from_data

__all__ = ["save", "load"]

_LIST_PREFIX = "__mxlist__"

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9

# mshadow type codes (mshadow/base.h TypeFlag)
_DTYPE_TO_FLAG = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
                  np.dtype(np.float16): 2, np.dtype(np.uint8): 3,
                  np.dtype(np.int32): 4, np.dtype(np.int8): 5,
                  np.dtype(np.int64): 6}
_FLAG_TO_DTYPE = {v: k for k, v in _DTYPE_TO_FLAG.items()}

# NDArrayStorageType (include/mxnet/ndarray.h)
_STYPE_DEFAULT, _STYPE_RSP, _STYPE_CSR = 0, 1, 2
_STYPE_CODE = {"default": _STYPE_DEFAULT, "row_sparse": _STYPE_RSP,
               "csr": _STYPE_CSR}
_CPU_CONTEXT = (1, 0)     # (dev_type, dev_id) of cpu(0)


def _write_shape(f, shape):
    # nnvm::TShape dmlc save: uint32 ndim + uint32 dims (mxnet 1.x)
    f.write(struct.pack("<I", len(shape)))
    for d in shape:
        f.write(struct.pack("<I", int(d)))


def _read_shape(f):
    (ndim,) = struct.unpack("<I", f.read(4))
    return tuple(struct.unpack("<%dI" % ndim, f.read(4 * ndim)))


def _write_array(f, arr):
    f.write(struct.pack("<I", _V2_MAGIC))
    f.write(struct.pack("<i", _STYPE_CODE[arr.stype]))
    t = arr._data.detach()
    if t.dim() == 0:
        # the reference format cannot represent 0-d arrays (an ndim-0
        # shape on disk means a none/null handle, ndarray.cc:851)
        raise MXNetError("cannot save a 0-d NDArray in the reference "
                         ".params format; reshape to (1,) first")
    # csr's aux order on disk is (indptr, indices), the arrays' own
    auxes = [a.cpu().numpy() for a in getattr(arr, "_aux", ())]
    if auxes:
        _write_shape(f, t.shape)      # storage shape
    _write_shape(f, arr.shape)        # logical shape
    f.write(struct.pack("<ii", *_CPU_CONTEXT))
    if t.dtype == torch.bfloat16:
        raise MXNetError("dtype bfloat16 has no reference save format")
    values = t.cpu().numpy()
    dt = np.dtype(values.dtype)
    if dt not in _DTYPE_TO_FLAG:
        raise MXNetError("dtype %s has no reference save format" % dt)
    f.write(struct.pack("<i", _DTYPE_TO_FLAG[dt]))
    for aux in auxes:
        f.write(struct.pack("<i", _DTYPE_TO_FLAG[np.dtype(aux.dtype)]))
        _write_shape(f, aux.shape)
    f.write(np.ascontiguousarray(values).tobytes())
    for aux in auxes:
        f.write(np.ascontiguousarray(aux).tobytes())


def _host(values):
    """A host NDArray over a copy of ``values`` (the file's buffer is
    read-only)."""
    return _from_data(torch.from_numpy(values.copy()))


def _read_values(f, dt, shape):
    n = int(np.prod(shape)) if shape else 1
    return np.frombuffer(f.read(n * dt.itemsize), dtype=dt).reshape(shape)


def _read_array(f):
    (magic,) = struct.unpack("<I", f.read(4))
    shape = None
    stype = _STYPE_DEFAULT
    if magic == _V2_MAGIC:
        (stype,) = struct.unpack("<i", f.read(4))
        if stype not in (_STYPE_DEFAULT, _STYPE_RSP, _STYPE_CSR):
            raise MXNetError("unknown NDArray storage type %d" % stype)
    elif magic != _V1_MAGIC:
        # pre-V1 record: the "magic" IS the ndim (ndarray.cc:900
        # LegacyTShapeLoad), as in tests/fixtures/legacy_ndarray.v0
        if magic > 32:
            raise MXNetError("bad NDArray record magic 0x%x" % magic)
        shape = tuple(struct.unpack("<%dI" % magic, f.read(4 * magic)))
    n_aux = stype  # rsp has one aux array, csr two
    storage_shape = _read_shape(f) if n_aux else None
    if shape is None:
        shape = _read_shape(f)
    if len(shape) == 0:
        return _host(np.zeros((), np.float32))
    f.read(8)  # context
    (type_flag,) = struct.unpack("<i", f.read(4))
    dt = _FLAG_TO_DTYPE[type_flag]
    aux_meta = []
    for _ in range(n_aux):
        (aux_flag,) = struct.unpack("<i", f.read(4))
        aux_meta.append((_FLAG_TO_DTYPE[aux_flag], _read_shape(f)))
    values = _read_values(f, dt, storage_shape if n_aux else shape)
    if not n_aux:
        return _host(values)
    from .sparse import CSRNDArray, RowSparseNDArray, _sparse_new

    auxes = [torch.from_numpy(_read_values(f, adt, ashape).copy())
             for adt, ashape in aux_meta]
    cls = RowSparseNDArray if stype == _STYPE_RSP else CSRNDArray
    return _sparse_new(cls, torch.from_numpy(values.copy()), auxes, shape)


def save(fname, data):
    """Save an NDArray, a list of them or a str-keyed dict of them in the
    reference's binary format (MXNet's ``mx.nd.save``)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        arrays, names = list(data), []
    elif isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        raise ValueError("data needs to either be a NDArray, list of "
                         "NDArray or a dict of str to NDArray")
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _write_array(f, a)
        f.write(struct.pack("<Q", len(names)))
        for nm in names:
            b = nm.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load(fname):
    """Load what :func:`save`, MXNet or the JAX package wrote: a list, or
    a dict when the file names its arrays (MXNet's ``mx.nd.load``)."""
    with open(fname, "rb") as f:
        head = f.read(8)
        if len(head) == 8 and struct.unpack("<Q", head)[0] == _LIST_MAGIC:
            f.read(8)  # reserved
            (n,) = struct.unpack("<Q", f.read(8))
            arrays = [_read_array(f) for _ in range(n)]
            (nn,) = struct.unpack("<Q", f.read(8))
            names = []
            for _ in range(nn):
                (ln,) = struct.unpack("<Q", f.read(8))
                names.append(f.read(ln).decode("utf-8"))
            if names:
                return dict(zip(names, arrays))
            return arrays
    return _load_npz(fname)


def _load_npz(fname):
    """The JAX package's earlier ``.npz`` archives, into host memory."""
    try:
        npz = np.load(fname, allow_pickle=False)
    except (zipfile.BadZipFile, ValueError) as e:
        raise IOError("cannot parse %r as an NDArray archive: %s"
                      % (fname, e))
    keys = list(npz.keys())
    if keys and all(k.startswith(_LIST_PREFIX) for k in keys):
        keys.sort(key=lambda k: int(k[len(_LIST_PREFIX):]))
        return [_host(npz[k]) for k in keys]
    return {k: _host(npz[k]) for k in keys}

"""Sparse storage: ``RowSparseNDArray`` and ``CSRNDArray``.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference:
include/mxnet/ndarray.h storage types, python/mxnet/ndarray/sparse.py,
src/operator/tensor/cast_storage-inl.h, dot-inl.h, sparse_retain.cc,
square_sum-inl.h, optimizer_op.cc's row-sparse updates). A sparse array
is its values tensor (``_data``) plus int64 index tensors (``_aux``) on
one device, beside the logical dense shape: row_sparse holds
``(indices,)`` with sorted unique row ids and values of shape
``(len(indices),) + shape[1:]``; csr holds ``(indptr, indices)`` and the
values of its nonzeros in row-major order.

Nonzeros are found on the array's own device (``torch.nonzero``,
``torch.unique``, ``torch.isin``), in the JAX package's order: sorted
unique row ids, csr entries in row-major ``nonzero`` order. Each
data-dependent size costs one synchronisation and no copy to the host.
Every reduction has a fixed order, so two runs give the same bits on the
card, where ``index_add_`` would not: a csr product sums each row's
nonzeros as one segment of ``indptr``, and the transposed product, the
row collapse of a gradient and ``rsp_add`` sort their row ids stably
first. The row-sparse optimizer updates are lazy: they read and write
only the gradient's rows of the weight and its states, in place.
``sparse_embedding``'s weight gradient is a sparse COO tensor (what
``F.embedding(sparse=True)`` gives), which :mod:`..autograd` collapses
into a ``RowSparseNDArray`` gradient buffer or densifies.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, as_device
from .ndarray import NDArray, _from_data

__all__ = [
    "BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
    "csr_matrix", "row_sparse_array", "zeros", "empty", "array",
    "cast_storage", "sparse_retain", "square_sum", "dot",
]


class BaseSparseNDArray(NDArray):
    """Common base of the sparse storage types: ``_data`` is the values
    tensor, ``_aux`` the index tensors, ``_sshape`` the logical shape."""

    __slots__ = ("_sshape", "_aux")

    def __init__(self, *a, **kw):
        raise NotImplementedError("use row_sparse_array/csr_matrix")

    # --- shape and dtype of the logical dense tensor ----------------------
    @property
    def shape(self):
        return self._sshape

    @property
    def size(self):
        return int(np.prod(self._sshape)) if self._sshape else 1

    @property
    def ndim(self):
        return len(self._sshape)

    @property
    def data(self):
        """The values tensor."""
        return _from_data(self._data)

    def _aux_data(self, i):
        return _from_data(self._aux[i])

    @property
    def num_aux(self):
        return len(self._aux)

    # --- dense interop ----------------------------------------------------
    def _dense_nd(self):
        return _from_data(self._dense())

    @staticmethod
    def _densify_operand(x):
        return x._dense_nd() if isinstance(x, BaseSparseNDArray) else x

    def asnumpy(self):
        return self._dense().cpu().numpy()

    def astype(self, dtype, copy=True):
        return _sparse_new(type(self), self._data.to(torch_dtype(dtype)),
                           self._aux, self._sshape)

    def copy(self):
        return _sparse_new(type(self), self._data.clone(),
                           tuple(a.clone() for a in self._aux), self._sshape)

    def copyto(self, other):
        """A copy on a device, or written into ``other``: a sparse array
        of the same storage type takes these values and indices (moved to
        its device), a dense one the densified values."""
        if isinstance(other, (Context, torch.device, str)):
            dev = as_device(other)
            return _sparse_new(type(self), self._data.to(dev, copy=True),
                               tuple(a.to(dev, copy=True) for a in self._aux),
                               self._sshape)
        if isinstance(other, BaseSparseNDArray):
            if other.stype != self.stype:
                raise MXNetError("copyto stype mismatch: %s vs %s"
                                 % (self.stype, other.stype))
            if other is not self:
                dev = other._data.device
                other._data = self._data.to(dev)
                other._aux = tuple(a.to(dev) for a in self._aux)
                other._sshape = self._sshape
            return other
        if isinstance(other, NDArray):
            other._set_data(self._dense())
            return other
        raise TypeError("copyto does not support %s" % type(other))

    def tostype(self, stype):
        return cast_storage(self, stype)

    def __setitem__(self, key, value):
        if not (isinstance(key, slice) and key == slice(None)):
            raise MXNetError("%s only supports [:] assignment"
                             % type(self).__name__)
        if isinstance(value, BaseSparseNDArray):
            value.copyto(self)
            return
        src = value._data if isinstance(value, NDArray) else \
            torch.as_tensor(np.asarray(value))
        src = src.to(self._data.device, self._data.dtype)
        cast_storage(_from_data(src.expand(self._sshape)),
                     self.stype).copyto(self)

    def __getitem__(self, key):
        raise MXNetError("%s does not support slicing; tostype('default') "
                         "first" % type(self).__name__)

    def slice(self, begin, end):
        raise MXNetError("%s does not support slicing" % type(self).__name__)

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(map(str, self._sshape)),
                                  self.context)

    # elementwise arithmetic densifies (the reference's storage fallback,
    # src/common/exec_utils.h); rsp + rsp and scalar scaling stay sparse
    def __add__(self, other):
        if isinstance(self, RowSparseNDArray) and \
                isinstance(other, RowSparseNDArray):
            return rsp_add(self, other)
        return self._dense_nd() + self._densify_operand(other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._dense_nd() - self._densify_operand(other)

    def __rsub__(self, other):
        return self._densify_operand(other) - self._dense_nd()

    def __mul__(self, other):
        if np.isscalar(other):
            return _sparse_new(type(self), self._data * other, self._aux,
                               self._sshape)
        return self._dense_nd() * self._densify_operand(other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        if np.isscalar(other):
            return self.__mul__(1.0 / other)
        return self._dense_nd() / self._densify_operand(other)

    def __rtruediv__(self, other):
        return self._densify_operand(other) / self._dense_nd()

    def __neg__(self):
        return self.__mul__(-1.0)

    def __pow__(self, other):
        return self._dense_nd() ** self._densify_operand(other)

    def __iadd__(self, other):
        res = self.__add__(other)
        if isinstance(res, RowSparseNDArray):
            res.copyto(self)
            return self
        raise MXNetError("in-place add on %s with dense result; use "
                         "tostype('default')" % type(self).__name__)

    def __eq__(self, other):
        return self._dense_nd() == self._densify_operand(other)

    def __ne__(self, other):
        return self._dense_nd() != self._densify_operand(other)

    __hash__ = object.__hash__


def _sparse_new(cls, values, aux, shape):
    arr = cls.__new__(cls)
    arr._data = values
    arr._aux = tuple(aux)
    arr._sshape = tuple(int(s) for s in shape)
    arr._grad = None
    arr._grad_req = None
    return arr


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse tensor: ``indices`` (K,) sorted unique row ids and
    ``data`` (K,) + shape[1:] (reference: kRowSparseStorage)."""

    __slots__ = ()

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self):
        return self._aux_data(0)

    def _dense(self):
        out = torch.zeros(self._sshape, dtype=self._data.dtype,
                          device=self._data.device)
        return out.index_copy_(0, self._aux[0], self._data)

    def retain(self, indices):
        return sparse_retain(self, indices)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows: ``indptr`` (rows + 1,), ``indices`` and
    ``data`` (nnz,) (reference: kCSRStorage)."""

    __slots__ = ()

    @property
    def stype(self):
        return "csr"

    @property
    def indices(self):
        return self._aux_data(1)

    @property
    def indptr(self):
        return self._aux_data(0)

    def _row_ids(self):
        """The row of each stored value, expanded from ``indptr`` on the
        device (no synchronisation: nnz is the values' length)."""
        indptr = self._aux[0]
        return torch.repeat_interleave(
            torch.arange(self._sshape[0], device=indptr.device),
            torch.diff(indptr), output_size=self._data.shape[0])

    def _dense(self):
        out = torch.zeros(self._sshape, dtype=self._data.dtype,
                          device=self._data.device)
        out[self._row_ids(), self._aux[1]] = self._data
        return out

    def __getitem__(self, key):
        # row-range slicing, the one indexing form the reference's
        # CSRNDArray supports
        if isinstance(key, slice):
            if key.step not in (None, 1):
                raise MXNetError("CSRNDArray slicing supports step=1 only")
            start, stop, _ = key.indices(self._sshape[0])
            return self.slice(start, max(stop, start))
        raise MXNetError("CSRNDArray supports row-slice indexing only")

    def slice(self, begin, end):
        if not 0 <= begin <= end <= self._sshape[0]:
            raise MXNetError("slice [%s, %s) out of range for %d rows"
                             % (begin, end, self._sshape[0]))
        indptr = self._aux[0][begin:end + 1]
        lo, hi = torch.stack((indptr[0], indptr[-1])).tolist()
        return _sparse_new(CSRNDArray, self._data[lo:hi],
                           (indptr - lo, self._aux[1][lo:hi]),
                           (end - begin,) + self._sshape[1:])


# --- constructors ------------------------------------------------------------

def _tensor(x, dtype, dev):
    """``x`` (an NDArray, a tensor or an array-like) as a tensor on
    ``dev``; ``dtype`` None keeps the source's (numpy's for a list)."""
    if isinstance(x, NDArray):
        x = x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch_dtype(dtype) or x.dtype)
    from ..convert import tensor_from_array

    return tensor_from_array(np.asarray(x, dtype=np_dtype(dtype)), dev)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` or a dense source
    (reference: sparse.py row_sparse_array)."""
    dev = as_device(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = _tensor(data, dtype, dev)
        indices = _tensor(indices, "int64", dev).reshape(-1)
        order = torch.argsort(indices, stable=True)
        indices, data = indices[order], data[order]
        if shape is None:
            top = int(indices.max()) + 1 if indices.numel() else 0
            shape = (top,) + tuple(data.shape[1:])
        return _sparse_new(RowSparseNDArray, data, (indices,), shape)
    if isinstance(arg1, RowSparseNDArray):
        return arg1.copy()
    return cast_storage(_from_data(_tensor(arg1, dtype, dev)), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` or a dense source
    (reference: sparse.py csr_matrix)."""
    dev = as_device(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = _tensor(data, dtype, dev).reshape(-1)
        indices = _tensor(indices, "int64", dev).reshape(-1)
        indptr = _tensor(indptr, "int64", dev).reshape(-1)
        if shape is None:
            cols = int(indices.max()) + 1 if indices.numel() else 0
            shape = (indptr.shape[0] - 1, cols)
        return _sparse_new(CSRNDArray, data, (indptr, indices), shape)
    if isinstance(arg1, CSRNDArray):
        return arg1.copy()
    return cast_storage(_from_data(_tensor(arg1, dtype, dev)), "csr")


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type ``stype`` (float32 unless
    ``dtype`` says otherwise, as ``nd.zeros``)."""
    from .ndarray import zeros as dense_zeros

    if stype == "default":
        return dense_zeros(shape, ctx=ctx, dtype=dtype)
    dev = as_device(ctx)
    dt = torch_dtype(dtype or "float32")
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    idx = torch.zeros((0,), dtype=torch.int64, device=dev)
    if stype == "row_sparse":
        vals = torch.zeros((0,) + shape[1:], dtype=dt, device=dev)
        return _sparse_new(RowSparseNDArray, vals, (idx,), shape)
    if stype == "csr":
        vals = torch.zeros((0,), dtype=dt, device=dev)
        indptr = torch.zeros((shape[0] + 1,), dtype=torch.int64, device=dev)
        return _sparse_new(CSRNDArray, vals, (indptr, idx), shape)
    raise MXNetError("unknown storage type %r" % stype)


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


def array(source_array, stype="default", ctx=None, dtype=None):
    """An array of storage type ``stype`` from any array-like."""
    from .ndarray import array as dense_array

    if stype == "default":
        return dense_array(source_array, ctx=ctx, dtype=dtype)
    if stype == "row_sparse":
        return row_sparse_array(source_array, ctx=ctx, dtype=dtype)
    if stype == "csr":
        return csr_matrix(source_array, ctx=ctx, dtype=dtype)
    raise MXNetError("unknown storage type %r" % stype)


# --- storage conversion (reference: cast_storage-inl.h) ----------------------

def _dense_to_rsp(t):
    if t.dim() < 1:
        raise MXNetError("row_sparse needs ndim >= 1")
    rows = t.reshape(t.shape[0], -1) if t.numel() else \
        t.new_zeros((t.shape[0], 0))
    nz = torch.nonzero((rows != 0).any(dim=1)).reshape(-1)
    return _sparse_new(RowSparseNDArray, t[nz], (nz,), t.shape)


def _dense_to_csr(t):
    if t.dim() != 2:
        raise MXNetError("csr storage is 2-D only")
    rows, cols = torch.nonzero(t, as_tuple=True)
    indptr = torch.searchsorted(
        rows, torch.arange(t.shape[0] + 1, device=t.device))
    return _sparse_new(CSRNDArray, t[rows, cols], (indptr, cols), t.shape)


def cast_storage(arr, stype):
    """``arr`` in storage type ``stype`` (default, row_sparse or csr)."""
    if arr.stype == stype:
        return arr.copy()
    if isinstance(arr, BaseSparseNDArray):
        dense = arr._dense()
        if stype == "default":
            return _from_data(dense)
    else:
        dense = arr._data.detach()
    if stype == "row_sparse":
        return _dense_to_rsp(dense)
    if stype == "csr":
        return _dense_to_csr(dense)
    raise MXNetError("unknown storage type %r" % stype)


def sparse_retain(arr, indices):
    """Only the rows of a RowSparseNDArray listed in ``indices``
    (reference: src/operator/tensor/sparse_retain.cc)."""
    if not isinstance(arr, RowSparseNDArray):
        raise MXNetError("sparse_retain expects row_sparse storage")
    have = arr._aux[0]
    want = _tensor(indices, "int64", have.device).reshape(-1)
    keep = torch.nonzero(torch.isin(have, want)).reshape(-1)
    return _sparse_new(RowSparseNDArray, arr._data[keep], (have[keep],),
                       arr._sshape)


def square_sum(arr, axis=None, keepdims=False):
    """``sum(x ** 2)`` over the stored values only (reference:
    square_sum-inl.h, the row-sparse norm)."""
    if not isinstance(arr, BaseSparseNDArray):
        raise MXNetError("square_sum expects sparse storage")
    if axis is None:
        return _from_data(torch.sum(arr._data.float() ** 2))
    if isinstance(arr, RowSparseNDArray) and axis in (1, (1,)):
        vals = torch.sum(arr._data.reshape(arr._data.shape[0], -1) ** 2,
                         dim=1)
        shape = (arr._sshape[0],)
        if keepdims:
            vals, shape = vals[:, None], shape + (1,)
        return _sparse_new(RowSparseNDArray, vals, (arr._aux[0],), shape)
    dims = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return _from_data(torch.sum(arr._dense() ** 2, dim=dims,
                                keepdim=keepdims))


# --- fixed-order segment sums ------------------------------------------------

def _segment_sum(values, offsets):
    """Sum of ``values[offsets[i]:offsets[i + 1]]`` for each i, in a fixed
    order (no atomics)."""
    if values.shape[0] == 0:
        return values.new_zeros((offsets.shape[0] - 1,) + values.shape[1:])
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def _group_rows(ids):
    """(sorted unique ids, stable order of ``ids`` by id, offsets of each
    id's run in that order): one synchronisation, for the unique count."""
    ids_sorted, order = torch.sort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(ids_sorted, return_counts=True)
    offsets = torch.zeros(uniq.shape[0] + 1, dtype=torch.int64,
                          device=ids.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return uniq, order, offsets


def collapse_rows(ids, values, shape):
    """A RowSparseNDArray from rows ``values`` at row ids ``ids`` (which
    may repeat): sorted unique ids, the repeats summed in the order they
    come."""
    uniq, order, offsets = _group_rows(ids)
    return _sparse_new(RowSparseNDArray, _segment_sum(values[order], offsets),
                       (uniq,), shape)


def coo_to_rsp(g):
    """A sparse COO gradient (rows on dim 0) as a RowSparseNDArray."""
    return collapse_rows(g._indices()[0], g._values(), tuple(g.shape))


def coo_to_dense(g):
    """A sparse COO gradient as a dense tensor, its repeats summed in a
    fixed order."""
    return coo_to_rsp(g)._dense()


# --- sparse dot (reference: src/operator/tensor/dot-inl.h) ------------------

def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """csr . dense -> dense, csr^T . dense -> row_sparse; any other
    storage densifies into ``nd.dot``."""
    if not isinstance(lhs, CSRNDArray):
        from . import op as _op

        return _op.dot(BaseSparseNDArray._densify_operand(lhs),
                       BaseSparseNDArray._densify_operand(rhs),
                       transpose_a=transpose_a, transpose_b=transpose_b)
    if transpose_b:
        raise MXNetError("dot(csr, dns, transpose_b=True) unsupported "
                         "(as the reference's dot-inl.h)")
    dense_rhs = BaseSparseNDArray._densify_operand(rhs)
    r = dense_rhs._data.detach()
    r2 = r[:, None] if r.dim() == 1 else r
    vals, cols = lhs._data, lhs._aux[1]
    if not transpose_a:
        # out[i] = sum over row i's nonzeros of v * rhs[col], row by row
        out = _segment_sum(vals[:, None] * r2[cols], lhs._aux[0])
        return _from_data(out[:, 0] if r.dim() == 1 else out)
    # csr^T . dns: out[col] += v * rhs[row], grouped by column
    uniq, order, offsets = _group_rows(cols)
    contrib = vals[order, None] * r2[lhs._row_ids()[order]]
    return _sparse_new(RowSparseNDArray, _segment_sum(contrib, offsets),
                       (uniq,), (lhs._sshape[1], r2.shape[1]))


def rsp_add(a, b):
    """Merge-sum of two RowSparseNDArrays (reference: ReduceSumCPUExSerial,
    src/kvstore/comm.h)."""
    if not (isinstance(a, RowSparseNDArray) and
            isinstance(b, RowSparseNDArray)):
        raise MXNetError("rsp_add expects row_sparse operands")
    ia, ib = a._aux[0], b._aux[0].to(a._data.device)
    union = torch.unique(torch.cat([ia, ib]))
    out = torch.zeros((union.shape[0],) + tuple(a._sshape[1:]),
                      dtype=a._data.dtype, device=a._data.device)
    # each operand's ids are unique, so each write lands on its own row
    out.index_copy_(0, torch.searchsorted(union, ia), a._data)
    out.index_add_(0, torch.searchsorted(union, ib),
                   b._data.to(out.device, out.dtype))
    return _sparse_new(RowSparseNDArray, out, (union,), a._sshape)


# --- lazy row-sparse optimizer updates (reference: optimizer_op.cc
# SGDUpdateRspImpl / AdamUpdateRspImpl / FtrlUpdateRspImpl): only the rows
# present in the gradient are read and written, in place ----------------------

def _grad_rows(grad, rescale_grad, clip_gradient):
    g = grad._data * float(rescale_grad)
    if clip_gradient is not None:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return grad._aux[0], g


def _check_dense_weight(weight):
    # the updates index the weight by absolute row id, which only dense
    # storage has: a RowSparseNDArray's values are its packed rows
    if isinstance(weight, BaseSparseNDArray):
        raise MXNetError(
            "sparse optimizer updates require a dense (default-storage) "
            "weight; got stype=%r — densify the stored value first"
            % weight.stype)


def _write_rows(arr, idx, rows):
    with torch.no_grad():
        arr._data.index_copy_(0, idx, rows.to(arr._data.dtype))


def sgd_update_rsp(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=None):
    _check_dense_weight(weight)
    idx, g = _grad_rows(grad, rescale_grad, clip_gradient)
    rows = weight._data.detach()[idx]
    _write_rows(weight, idx, rows - lr * (g.to(rows.dtype) + wd * rows))


def sgd_mom_update_rsp(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=None):
    _check_dense_weight(weight)
    idx, g = _grad_rows(grad, rescale_grad, clip_gradient)
    w_rows, m_rows = weight._data.detach()[idx], mom._data[idx]
    m_rows = momentum * m_rows - lr * (g.to(w_rows.dtype) + wd * w_rows)
    _write_rows(mom, idx, m_rows)
    _write_rows(weight, idx, w_rows + m_rows)


def mp_sgd_update_rsp(weight, grad, mom, master, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=None):
    """Multi-precision lazy SGD: the fp32 master copy's touched rows are
    updated (with momentum when ``mom`` is given) and cast back into the
    low-precision weight (reference: MP_SGDMomUpdateRspImpl)."""
    _check_dense_weight(weight)
    idx, g = _grad_rows(grad, rescale_grad, clip_gradient)
    w_rows = master._data[idx]
    step = g.to(w_rows.dtype) + wd * w_rows
    if mom is not None:
        m_rows = momentum * mom._data[idx] - lr * step
        _write_rows(mom, idx, m_rows)
        w_rows = w_rows + m_rows
    else:
        w_rows = w_rows - lr * step
    _write_rows(master, idx, w_rows)
    _write_rows(weight, idx, w_rows)


def adam_update_rsp(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                    epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                    clip_gradient=None):
    _check_dense_weight(weight)
    idx, g = _grad_rows(grad, rescale_grad, clip_gradient)
    w_rows = weight._data.detach()[idx]
    g = g.to(w_rows.dtype) + wd * w_rows
    m_rows = beta1 * mean._data[idx] + (1 - beta1) * g
    v_rows = beta2 * var._data[idx] + (1 - beta2) * g * g
    _write_rows(mean, idx, m_rows)
    _write_rows(var, idx, v_rows)
    _write_rows(weight, idx,
                w_rows - lr * m_rows / (torch.sqrt(v_rows) + epsilon))


def ftrl_update_rsp(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=None):
    _check_dense_weight(weight)
    idx, g = _grad_rows(grad, rescale_grad, clip_gradient)
    w_rows = weight._data.detach()[idx]
    g = g.to(w_rows.dtype)
    n_rows, z_rows = n._data[idx], z._data[idx]
    n_new = n_rows + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n_rows)) / lr
    z_new = z_rows + g - sigma * w_rows
    w_new = torch.where(
        torch.abs(z_new) > lamda1,
        -(z_new - torch.sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd),
        torch.zeros_like(w_rows))
    _write_rows(n, idx, n_new)
    _write_rows(z, idx, z_new)
    _write_rows(weight, idx, w_new)


# --- the row-sparse-gradient embedding (reference: indexing_op.cc
# SparseEmbedding: a large table never materialises a dense gradient) ------

class _SparseEmbedding(torch.autograd.Function):
    """Gather of rows whose weight gradient is a sparse COO tensor, the
    form ``F.embedding(sparse=True)`` gives."""

    @staticmethod
    def forward(ctx, weight, idx):
        ctx.save_for_backward(idx)
        ctx.weight_shape = weight.shape
        return weight[idx]

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        shape = ctx.weight_shape
        return torch.sparse_coo_tensor(
            idx[None], cot.reshape(-1, shape[1]), shape,
            check_invariants=False), None


def sparse_embedding(data, weight, input_dim=None, output_dim=None, **_):
    """Embedding lookup whose weight gradient is row-sparse: the ids are
    ``data`` cast to int32, as the JAX package reads them."""
    from .. import autograd

    idx = data._data.detach().to(torch.int32).reshape(-1).to(torch.int64)
    w = weight._data
    if autograd.is_recording() and w.requires_grad:
        rows = _SparseEmbedding.apply(w, idx)
    else:
        rows = w.detach()[idx]
    return _from_data(rows.reshape(tuple(data.shape) + (w.shape[1],)))

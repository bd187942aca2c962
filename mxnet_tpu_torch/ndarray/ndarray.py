"""NDArray — the imperative value type, a wrapper over one ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. An NDArray holds one
tensor on one explicit device (``context``: a ``Context``, whose
``device`` is the tensor's). The creation functions put it where ``ctx``
says, else in the innermost ``with mx.cpu():`` / ``with mx.gpu(i):``
scope, else on the CUDA card, and raise where there is no card. MXNet's
mutation (``a[:] = x``, ``+=``, ``copyto``, optimizer and aux-state
updates) writes into that tensor in place under ``torch.no_grad()``; the
JAX package, whose arrays are immutable, rebinds the NDArray to a new
buffer instead. Launches are asynchronous on the current CUDA stream:
``asnumpy`` and ``wait_to_read`` are the sync points.

Autograd (``attach_grad``, ``.grad``, ``backward``, ``detach``) rides on
torch's: see :mod:`..autograd`. Outside ``autograd.record()`` an array
never carries a ``grad_fn``: a result computed from a tensor that requires
grad is detached when it is wrapped.
"""
from __future__ import annotations

import numpy as np
import torch

from ..autograd import is_recording
from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, as_device

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "moveaxis", "waitall"]


def _wrap(data):
    """Wrap a tensor into an NDArray without a copy, keeping its
    ``grad_fn``."""
    arr = NDArray.__new__(NDArray)
    arr._data = data
    arr._grad = None
    arr._grad_req = None
    return arr


def _from_data(data):
    """Wrap a tensor into an NDArray without a copy; outside
    ``autograd.record()`` a tensor that requires grad is detached first."""
    if data.requires_grad and not is_recording():
        data = data.detach()
    return _wrap(data)


def _dtype_of(t):
    """numpy dtype of a tensor (the string ``"bfloat16"`` where numpy has
    no such type)."""
    name = str(t.dtype).replace("torch.", "")
    try:
        return np_dtype(name)
    except MXNetError:
        return name


class NDArray:
    """Multi-dimensional array on one device."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, source_array, ctx=None, dtype=None):
        npa = np.array(source_array, dtype=np_dtype(dtype))
        self._data = torch.from_numpy(npa).to(as_device(ctx))
        self._grad = None
        self._grad_req = None

    # --- core properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _dtype_of(self._data)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return Context.from_device(self._data.device)

    ctx = context

    @property
    def T(self):
        return _from_data(self._data.t())

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        """Gradient buffer attached by :meth:`attach_grad`."""
        return self._grad

    # --- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Attach a zero gradient buffer, of storage type ``stype``
        (default, or row_sparse / csr); this array's tensor becomes a leaf
        that requires grad (reference: ndarray.py attach_grad)."""
        from .. import autograd

        if stype not in (None, "default"):
            from .sparse import zeros as sparse_zeros

            grad = sparse_zeros(stype, self.shape, ctx=self._data.device,
                                dtype=self._data.dtype)
        else:
            grad = _wrap(torch.zeros_like(self._data.detach()))
        autograd.mark_variables([self], [grad], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array into the marked variables it was
        recorded from (reference: ndarray.py backward)."""
        from .. import autograd

        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    def detach(self):
        """The same values, cut from the recorded graph."""
        return _wrap(self._data.detach())

    # --- data movement / sync --------------------------------------------
    def asnumpy(self):
        """Copy to a numpy array (a copy also on the CPU), blocking."""
        t = self._data.detach()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def astype(self, dtype, copy=True):
        return _from_data(self._data.to(torch_dtype(dtype), copy=copy))

    def copyto(self, other):
        """Copy into another NDArray (in place, cast to its dtype; into a
        sparse one through ``cast_storage``) or onto a device."""
        if isinstance(other, NDArray):
            if other.stype != "default":
                from .sparse import cast_storage

                src = self.astype(other._data.dtype) \
                    if self._data.dtype != other._data.dtype else self
                return cast_storage(src, other.stype).copyto(other)
            if other is not self:
                other._set_data(self._data)
            return other
        if isinstance(other, (Context, torch.device, str)):
            return _from_data(self._data.to(as_device(other), copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def copy(self):
        return _from_data(self._data.clone())

    def as_in_context(self, context):
        if self._data.device == as_device(context):
            return self
        return self.copyto(context)

    # --- mutation (in place) ----------------------------------------------
    def _set_data(self, data):
        """Write ``data`` into this array in place (cast to its dtype,
        moved to its device). A value of another shape rebinds the array
        to a new tensor, as a re-bind of the JAX package's does."""
        with torch.no_grad():
            if tuple(data.shape) == tuple(self._data.shape):
                self._data.copy_(data)
            else:
                self._data = data.to(self._data.device, self._data.dtype)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not np.isscalar(value):
            value = torch.as_tensor(np.asarray(value))
        with torch.no_grad():
            self._data[_unwrap_index(key)] = value

    def __getitem__(self, key):
        return _from_data(self._data[_unwrap_index(key)])

    # --- shape sugar ------------------------------------------------------
    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = tuple(self.shape[i] if s == 0 else int(s)
                      for i, s in enumerate(shape))
        return _from_data(self._data.reshape(shape))

    def flatten(self):
        return self.reshape((self.shape[0], -1))

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        axes = axes or tuple(reversed(range(self.ndim)))
        return _from_data(self._data.permute(*axes))

    def squeeze(self, axis=None):
        if axis is None:
            return _from_data(self._data.squeeze())
        axes = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
        for a in axes:
            if self.shape[a] != 1:
                raise ValueError("cannot squeeze axis %d of size %d"
                                 % (a, self.shape[a]))
        return _from_data(self._data.squeeze(axes))

    # --- reductions -------------------------------------------------------
    def _reduce(self, fn, axis, keepdims):
        if axis is None:
            out = fn(self._data)
            return _from_data(out.reshape((1,) * self.ndim) if keepdims
                              else out)
        axes = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
        return _from_data(fn(self._data, dim=axes, keepdim=keepdims))

    def sum(self, axis=None, keepdims=False):
        return self._reduce(torch.sum, axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce(torch.mean, axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce(torch.amax, axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce(torch.amin, axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _from_data(torch.argmax(self._data, dim=axis,
                                       keepdim=keepdims).to(self._data.dtype))

    def abs(self):
        return _from_data(self._data.abs())

    def clip(self, a_min, a_max):
        return _from_data(torch.clamp(self._data, a_min, a_max))

    # --- python protocol --------------------------------------------------
    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (str(self.asnumpy()),
                                         "x".join(map(str, self.shape)),
                                         self.context)

    # --- arithmetic (through the op registry) -----------------------------
    def _binop(self, other, op_name, scalar_op_name, reverse=False):
        from . import op as _op
        from . import _internal

        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return getattr(_op, op_name)(a, b)
        if np.isscalar(other) or isinstance(other, np.generic):
            return getattr(_internal, scalar_op_name)(self,
                                                      scalar=float(other))
        raise TypeError("type %s not supported" % str(type(other)))

    def __add__(self, other):
        return self._binop(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binop(other, "broadcast_sub", "_rminus_scalar",
                           reverse=True)

    def __mul__(self, other):
        return self._binop(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binop(other, "broadcast_div", "_rdiv_scalar",
                           reverse=True)

    def __neg__(self):
        return self._binop(-1.0, "broadcast_mul", "_mul_scalar")

    def __mod__(self, other):
        return self._binop(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binop(other, "broadcast_mod", "_rmod_scalar",
                           reverse=True)

    def __pow__(self, other):
        return self._binop(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binop(other, "broadcast_power", "_rpower_scalar",
                           reverse=True)

    def __abs__(self):
        return self.abs()

    def __eq__(self, other):
        if other is None:
            return False
        return self._binop(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        if other is None:
            return True
        return self._binop(other, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return self._binop(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binop(other, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binop(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binop(other, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    __hash__ = object.__hash__

    def _inplace(self, res):
        self._set_data(res._data)
        return self

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __imod__(self, other):
        return self._inplace(self.__mod__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))


def _unwrap_index(key):
    """NDArray indices (bare or in a tuple) become integer tensors."""
    def one(k):
        if isinstance(k, NDArray):
            k = k._data
            if k.is_floating_point():
                k = k.to(torch.int64)
        return k

    if isinstance(key, tuple):
        return tuple(one(k) for k in key)
    return one(key)


# --- creation functions -----------------------------------------------------

def array(source_array, ctx=None, dtype=None):
    """An NDArray from any array-like (a copy). ``ctx`` defaults to the
    source's own device for an NDArray or tensor, else to the innermost
    ``with`` scope, else the card."""
    if isinstance(source_array, (NDArray, torch.Tensor)):
        t = source_array._data if isinstance(source_array, NDArray) \
            else source_array
        dev = t.device if ctx is None else as_device(ctx)
        return _from_data(t.detach().to(dev, torch_dtype(dtype) or t.dtype,
                                        copy=True))
    return NDArray(source_array, ctx=ctx, dtype=dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _from_data(torch.zeros(_shape(shape),
                                  dtype=torch_dtype(dtype or "float32"),
                                  device=as_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _from_data(torch.ones(_shape(shape),
                                 dtype=torch_dtype(dtype or "float32"),
                                 device=as_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return _from_data(torch.full(_shape(shape), val,
                                 dtype=torch_dtype(dtype or "float32"),
                                 device=as_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """numpy's ``arange`` values, each repeated ``repeat`` times, on
    ``ctx`` (the card unless asked)."""
    from ..ops.init_ops import arange_values

    a = arange_values(start, stop, step, repeat, dtype or "float32")
    return _from_data(torch.from_numpy(a).to(as_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def concatenate(arrays, axis=0, always_copy=True):
    return _from_data(torch.cat([a._data for a in arrays], dim=axis))


def moveaxis(tensor, source, destination):
    """``tensor`` with axis ``source`` moved to ``destination`` (a view,
    recorded on the tape)."""
    return _from_data(torch.movedim(tensor._data, source, destination))


def waitall():
    """Block until the card's queued work is done."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()

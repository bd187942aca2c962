"""Weight bridge from the JAX package's parameter dicts.

``params_from_jax`` turns ``arg_params``/``aux_params`` as the JAX package
holds them (NDArrays with ``asnumpy()``, jax arrays, numpy arrays) into the
port's tensors under the same MXNet names and layouts: a channels-last
convolution keeps its HWIO weight, a channels-first one OIHW. Both packages
then compute on the same numbers. ``gluon_params_from_jax`` does the same
for a Gluon network: it copies a JAX net's ``collect_params()`` into the
port's net of the same architecture, matching names with each net's own
prefix stripped (the two packages number their blocks apart).
``sparse_from_jax`` carries a JAX ``RowSparseNDArray`` or ``CSRNDArray``
(its values and aux arrays) into the port's. Nothing of the JAX package is
imported: only ``asnumpy()``, ``stype`` or numpy's array protocol is used.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import as_device

__all__ = ["params_from_jax", "gluon_params_from_jax", "tensor_from_array",
           "sparse_from_jax"]


def tensor_from_array(value, device=None):
    """One array-like (or tensor) as a tensor on ``device``, same dtype;
    bfloat16 arrays from ``ml_dtypes`` are carried bit for bit."""
    if isinstance(value, torch.Tensor):
        return value.to(as_device(device))
    if hasattr(value, "asnumpy"):
        value = value.asnumpy()
    arr = np.ascontiguousarray(np.asarray(value))
    if not arr.flags.writeable:
        arr = arr.copy()  # torch tensors over read-only memory are unsafe
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(as_device(device))


def params_from_jax(arg_params, aux_params=None, device=None):
    """(arg tensors, aux tensors) on ``device`` (default: the card)."""
    dev = as_device(device)
    args = {k: tensor_from_array(v, dev) for k, v in
            (arg_params or {}).items()}
    aux = {k: tensor_from_array(v, dev) for k, v in
           (aux_params or {}).items()}
    return args, aux


def gluon_params_from_jax(jax_net, net):
    """Copy every parameter of ``jax_net`` (a JAX Gluon block) into the
    port's ``net`` by name, each net's own prefix stripped, through
    ``asnumpy()``. A parameter of ``net`` still awaiting its shape is
    initialised from the value; an initialised one is written in place.
    Raises when the two nets' names differ."""
    def stripped(block):
        cut = len(block.prefix)
        return {name[cut:] if name.startswith(block.prefix) else name: p
                for name, p in block.collect_params().items()}

    src, dst = stripped(jax_net), stripped(net)
    if set(src) != set(dst):
        raise ValueError("the nets' parameters differ: only in the JAX "
                         "net %s, only in this one %s"
                         % (sorted(set(src) - set(dst)),
                            sorted(set(dst) - set(src))))
    for name, p in dst.items():
        value = src[name].data().asnumpy()
        if p._data is None:
            p._load_init(value, p.list_ctx() if p._deferred_init else None)
        else:
            p.set_data(value)


def sparse_from_jax(arr, device=None):
    """The port's sparse array of a JAX package's ``RowSparseNDArray`` or
    ``CSRNDArray`` (or a dense NDArray, as a dense one), values and index
    arrays bit for bit, on ``device`` (default: the card)."""
    from .ndarray.ndarray import _from_data
    from .ndarray.sparse import CSRNDArray, RowSparseNDArray, _sparse_new

    dev = as_device(device)
    if arr.stype == "row_sparse":
        return _sparse_new(RowSparseNDArray, tensor_from_array(arr.data, dev),
                           (tensor_from_array(arr.indices, dev),), arr.shape)
    if arr.stype == "csr":
        return _sparse_new(CSRNDArray, tensor_from_array(arr.data, dev),
                           (tensor_from_array(arr.indptr, dev),
                            tensor_from_array(arr.indices, dev)), arr.shape)
    return _from_data(tensor_from_array(arr, dev))

"""Gluon helper utilities.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference: gluon/utils.py):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``.
``download`` returns a file that is already there and otherwise raises:
the package fetches nothing over the network.
"""
from __future__ import annotations

import hashlib
import os
import warnings

import numpy as np

from .. import ndarray as nd

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def _to_initializer(initializer):
    """Resolve a string initializer name to an Initializer instance
    (single home for the coercion used by nn/rnn layer constructors)."""
    from .. import initializer as init_mod

    if isinstance(initializer, str):
        return init_mod.create(initializer)
    return initializer


def _axis_slice(data, axis, start, stop):
    if axis == 0:
        return data[start:stop]
    return nd.slice_axis(data, axis, start, stop)


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Cut ``data`` into ``num_slice`` chunks along the batch axis; the
    final chunk absorbs the remainder when even_split is off."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d." % (str(data.shape), num_slice,
                                                 batch_axis))
    if even_split and size % num_slice:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))

    step = size // num_slice
    bounds = [i * step for i in range(num_slice)] + [size]
    return [_axis_slice(data, batch_axis, lo, hi)
            for lo, hi in zip(bounds, bounds[1:])]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """split_data + one as_in_context per chunk."""
    if not isinstance(data, nd.NDArray):
        data = nd.array(np.asarray(data), ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    chunks = split_data(data, len(ctx_list), batch_axis, even_split)
    return [chunk.as_in_context(ctx)
            for chunk, ctx in zip(chunks, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Jointly rescale ``arrays`` so their global 2-norm is <= max_norm;
    returns the pre-clip norm."""
    if not arrays:
        raise AssertionError("need at least one array")
    sq_sum = sum(float((a.reshape((-1,)) ** 2).sum().asscalar())
                 for a in arrays)
    norm = np.sqrt(sq_sum)
    if not np.isfinite(norm):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    ratio = max_norm / (norm + 1e-8)
    if ratio < 1.0:
        for a in arrays:
            a *= ratio
    return norm


def check_sha1(filename, sha1_hash):
    """True when the file's SHA1 digest equals ``sha1_hash``."""
    digest = hashlib.sha1()
    with open(filename, "rb") as stream:
        for block in iter(lambda: stream.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """An existing local file; anything else raises (not available
    offline)."""
    if path is None or os.path.isdir(path or ""):
        fname = url.split("/")[-1]
        if path is not None:
            fname = os.path.join(path, fname)
    else:
        fname = path
    if os.path.exists(fname) and not overwrite:
        return fname
    raise IOError("download is not available offline: %s" % url)

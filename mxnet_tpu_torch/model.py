"""Module helpers: the kvstore glue of ``Module``.

Counterpart of ``mxnet_tpu/model.py``: ``BatchEndParam``,
``_create_kvstore`` (decides update_on_kvstore), ``_initialize_kvstore``,
``_update_params(_on_kvstore)`` and the checkpoint pair
(``save_checkpoint`` / ``load_checkpoint``: ``prefix-symbol.json`` and
``prefix-%04d.params`` with ``arg:`` / ``aux:`` keys, the files MXNet and
the JAX package write). ``FeedForward`` waits for a later slice.
"""
from __future__ import annotations

import logging
from collections import namedtuple

from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore or None, update_on_kvstore): one device with a local type
    needs no store, and the update runs locally."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore and kvstore != "mesh":
            # no need for multi-device reduce; update locally
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                # reference heuristic: big arrays → update on kvstore
                max_size = max(np_prod(p.shape) for p in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def np_prod(shape):
    r = 1
    for s in shape:
        r *= s
    return r


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Seed the store with the host parameters, placed on the device of
    the parameter's first device array, so that the store's reduce and
    update run there; with update_on_kvstore, pull them back into the
    device arrays."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name].copyto(param_on_devs[0].context))
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore, param_names):
    """Push each gradient (the store updates its weight) and pull the
    weight back into every device array."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The per-device update: reduce through the store when there is one,
    then run the updater on each device's (grad, weight)."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        if kvstore:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, p in enumerate(zip(arg_list, grad_list)):
            w, g = p
            updater(index * num_device + k, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) from what :func:`save_checkpoint`
    wrote; the parameters load into host memory."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (symbol, arg_params, aux_params)

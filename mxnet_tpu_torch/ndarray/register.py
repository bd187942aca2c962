"""Imperative op invocation and the ``mx.nd.*`` functions.

Counterpart of ``mxnet_tpu/ndarray/register.py``: one function per
registered op, generated from the op registry at import. :func:`invoke`
parses the attrs, splits tensor from parameter kwargs, runs the op's
forward on the arrays' tensors (under ``torch.no_grad()``, or with grad
enabled inside ``autograd.record()``, in train mode as
``autograd.is_training()`` says), writes updated aux states (optimizer
momentum, master weights) into their arrays in place, and writes the
result into ``out=`` in place where one is given.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..base import MXNetError
from ..ops.registry import OP_REGISTRY
from .ndarray import NDArray, _from_data

__all__ = ["invoke", "populate_namespaces"]


def invoke(opdef, args, kwargs):
    """Invoke one registered op on NDArrays."""
    kwargs = dict(kwargs)
    out = kwargs.pop("out", None)
    kwargs.pop("name", None)
    tensor_kwargs = {k: v for k, v in kwargs.items()
                     if isinstance(v, NDArray)}
    attr_kwargs = {k: v for k, v in kwargs.items()
                   if not isinstance(v, NDArray)}
    args = opdef.bind_positional_params(args, attr_kwargs, NDArray)
    if "num_args" in opdef.params and "num_args" not in attr_kwargs:
        attr_kwargs["num_args"] = len(args) + len(tensor_kwargs)
    attrs = opdef.parse_attrs(attr_kwargs)
    n_in = opdef.get_num_inputs(attrs)
    aux_names = opdef.get_aux_names(attrs)

    inputs = list(args)
    if tensor_kwargs:
        all_names = opdef.get_input_names(attrs) + aux_names
        full = [None] * len(all_names)
        for i, a in enumerate(inputs):
            full[i] = a
        for k, v in tensor_kwargs.items():
            if k not in all_names:
                raise MXNetError("%s: unknown input %r (inputs: %s)"
                                 % (opdef.name, k, all_names))
            full[all_names.index(k)] = v
        inputs = [x for x in full if x is not None]
    main, aux = inputs[:n_in], inputs[n_in:]
    if aux_names and len(aux) != len(aux_names):
        raise MXNetError("%s: expected %d aux states %s, got %d inputs "
                         "beyond the %d main inputs"
                         % (opdef.name, len(aux_names), aux_names, len(aux),
                            n_in))
    with torch.set_grad_enabled(autograd.is_recording()):
        outs, new_aux = opdef.apply(attrs, [a._data for a in main],
                                    [a._data for a in aux],
                                    is_train=autograd.is_training())
    with torch.no_grad():
        for a, nv in zip(aux, new_aux):
            a._set_data(nv)
        if out is not None:
            dsts = out if isinstance(out, (list, tuple)) else [out]
            for dst, o in zip(dsts, outs):
                dst._set_data(o)
            return out
    results = [_from_data(o) for o in outs]
    return results[0] if len(results) == 1 else results


def _make_op_func(opdef):
    def op_fn(*args, **kwargs):
        return invoke(opdef, args, kwargs)

    op_fn.__name__ = op_fn.__qualname__ = opdef.name
    op_fn.__doc__ = opdef.doc or "%s (imperative op)" % opdef.name
    return op_fn


def populate_namespaces(op_module, internal_module, contrib_module=None):
    """One function per registered op: ``_contrib_X`` goes to
    ``_internal`` under its own name and to ``contrib`` as ``X``, another
    ``_X`` to ``_internal``, the rest to ``op``."""
    for name, opdef in OP_REGISTRY.items():
        if name.startswith("_contrib_") and contrib_module is not None:
            setattr(internal_module, name, _make_op_func(opdef))
            pub = _make_op_func(opdef)
            pub.__name__ = pub.__qualname__ = name[len("_contrib_"):]
            setattr(contrib_module, pub.__name__, pub)
            continue
        target = internal_module if name.startswith("_") else op_module
        setattr(target, name, _make_op_func(opdef))

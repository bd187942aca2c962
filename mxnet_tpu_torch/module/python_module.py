"""Modules whose compute is Python rather than a bound graph.

Counterpart of ``mxnet_tpu/module/python_module.py`` (reference:
python/mxnet/module/python_module.py — PythonModule + PythonLossModule).
The use case is a loss head whose gradient is easier to state in numpy or
``mx.nd`` than as a symbol, composed inside SequentialModule.

Almost everything on PythonModule is *deliberately inert* (it owns no
parameters, no optimizer, no device state); the only real logic lives
in ``bind``.
"""
import logging

import numpy as np

from .. import ndarray as nd
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]

class PythonModule(BaseModule):
    """Parameter-free module: subclasses supply ``forward``/``backward``
    plus ``_compute_output_shapes``; the rest of the BaseModule contract
    is inert (see class docstring)."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._names = {
            "data": list(data_names),
            "label": list(label_names) if label_names else [],
            "output": list(output_names),
        }
        self._shapes = {"data": None, "label": None, "output": None}

    data_names = property(lambda self: self._names["data"])
    output_names = property(lambda self: self._names["output"])
    data_shapes = property(lambda self: self._shapes["data"])
    label_shapes = property(lambda self: self._shapes["label"])
    output_shapes = property(lambda self: self._shapes["output"])

    def _compute_output_shapes(self):
        raise NotImplementedError

    # the parameter/optimizer/state surface is deliberately inert for a
    # parameter-free module (see module docstring)
    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        pass

    def install_monitor(self, mon):
        pass

    def get_states(self, merge_multi_context=True):
        return []

    def set_states(self, states=None, value=None):
        pass

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("PythonModule.bind: already bound; pass "
                                "force_rebind=True to rebind")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._shapes["data"] = [
            s if hasattr(s, "shape") else tuple(s) for s in data_shapes]
        self._shapes["label"] = label_shapes
        self._shapes["output"] = self._compute_output_shapes()


class PythonLossModule(PythonModule):
    """Identity on the forward pass; on the backward pass emits
    ``grad_func(scores, labels)`` as the input gradient. The caller must
    supply ``grad_func`` (or subclass and override ``backward``) — no
    default loss is assumed."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        data_names = tuple(data_names)  # consume any iterator exactly once
        if len(data_names) != 1:
            raise ValueError("PythonLossModule takes exactly one data input")
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        self._grad_func = grad_func
        self._cache = {"scores": None, "labels": None, "grad": None}

    def _compute_output_shapes(self):
        desc = self._shapes["data"][0]
        shape = desc.shape if hasattr(desc, "shape") else desc[1]
        return [(self._name + "_output", tuple(shape))]

    def forward(self, data_batch, is_train=None):
        scores = data_batch.data[0]
        self._cache["scores"] = scores
        train = self.for_training if is_train is None else is_train
        if train and data_batch.label:
            # the labels come from the iterator (on the host), the scores
            # from the stage before (on its device): grad_func sees both
            # where the scores live
            self._cache["labels"] = data_batch.label[0].as_in_context(
                scores.context)

    def get_outputs(self, merge_multi_context=True):
        return [self._cache["scores"]]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise ValueError("PythonLossModule is a loss head and accepts "
                             "no incoming gradient")
        if self._grad_func is None:
            raise RuntimeError("PythonLossModule requires grad_func "
                               "(or override backward)")
        scores = self._cache["scores"]
        grad = self._grad_func(scores, self._cache["labels"])
        if not isinstance(grad, nd.NDArray):
            # a numpy gradient goes where the scores live
            grad = nd.array(np.asarray(grad), ctx=scores.context)
        self._cache["grad"] = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._cache["grad"]]

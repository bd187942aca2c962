"""BucketingModule: per-sequence-length graphs sharing one parameter set.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (reference
python/mxnet/module/bucketing_module.py). Each bucket key materialises its
own Module bound with ``shared_module`` pointing at the default bucket, so
the parameters' device arrays and the optimizer are shared. Bucket
Modules come from one ``_spawn_module`` factory, and most of the compute
interface is delegated to the active bucket through a single dispatch
table.
"""
from __future__ import annotations

import logging
import warnings

from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    """Dispatch batches to per-bucket Modules built by sym_gen(key)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise AssertionError("default_bucket_key is required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key

        sym_gen(default_bucket_key)  # fail fast on a broken generator
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        self._context = context
        self._work_load_list = work_load_list

        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False

    def _spawn_module(self, bucket_key):
        """A fresh Module for one bucket's unrolled graph."""
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)


    def _ready(self, params=False, optimizer=False):
        """Guard: module lifecycle must have reached the required stage."""
        if not self.binded:
            raise AssertionError("not bound")
        if params and not self.params_initialized:
            raise AssertionError("parameters not initialized")
        if optimizer and not self.optimizer_initialized:
            raise AssertionError("optimizer not initialized")

    def _reset_bind(self):
        self._buckets = {}
        self._curr_bucket_key = None
        self._curr_module = None
        self.binded = False

    # ------------------------------------------------------------- views
    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._ready()
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        self._ready()
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        self._ready()
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        self._ready()
        return self._curr_module.symbol

    # ------------------------------------------------------------ params
    def get_params(self):
        self._ready(params=True)
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise AssertionError("call bind before initializing the parameters")
        self._curr_module.init_params(initializer, arg_params, aux_params,
                                      allow_missing, force_init, allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "set_params call ignored.", stacklevel=2)
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=True,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    # the host-side param dicts live on the active bucket's Module
    _arg_params = property(
        lambda self: self._curr_module._arg_params if self._curr_module
        else None,
        lambda self, value: None)
    _aux_params = property(
        lambda self: self._curr_module._aux_params if self._curr_module
        else None,
        lambda self, value: None)

    # -------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket; other buckets bind lazily on demand."""
        if shared_module is not None:
            raise AssertionError(
                "shared_module for BucketingModule is not supported")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return

        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

        root = self._spawn_module(self._default_bucket_key)
        root.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                  grad_req=grad_req)
        self._curr_module = root
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = root

        if self.params_initialized:
            self.set_params(self._arg_params, self._aux_params)

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` active, binding its Module on first use
        against the default bucket's memory."""
        if not self.binded:
            raise AssertionError("call bind before switching bucket")
        if bucket_key not in self._buckets:
            fresh = self._spawn_module(bucket_key)
            root = self._buckets[self._default_bucket_key]
            fresh.bind(data_shapes, label_shapes,
                       self._curr_module.for_training,
                       self._curr_module.inputs_need_grad,
                       shared_module=root)
            self._buckets[bucket_key] = fresh
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    # ------------------------------------------------------------ compute
    def forward(self, data_batch, is_train=None):
        """Route the batch to its bucket's module."""
        self._ready(params=True)
        self.switch_bucket(data_batch.bucket_key,
                           data_batch.provide_data,
                           label_shapes=data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def _to_active(name, needs_grad=False):  # noqa: N805 - class-body factory
        """Generate a method that forwards to the active bucket's Module."""
        def method(self, *args, **kwargs):
            self._ready(params=True)
            if needs_grad and not self.inputs_need_grad:
                raise AssertionError("bind with inputs_need_grad=True first")
            return getattr(self._curr_module, name)(*args, **kwargs)
        method.__name__ = name
        method.__doc__ = "Forward %r to the active bucket's Module." % name
        return method

    backward = _to_active("backward")
    get_outputs = _to_active("get_outputs")
    get_input_grads = _to_active("get_input_grads", needs_grad=True)
    update_metric = _to_active("update_metric")
    del _to_active

    def update(self):
        """Optimizer step on the active bucket (marks host params stale)."""
        self._ready(params=True, optimizer=True)
        self._params_dirty = True
        self._curr_module.update()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer on the active bucket; others borrow it."""
        self._ready(params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for sibling in self._buckets.values():
            if sibling is not self._curr_module:
                sibling.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def save_optimizer_states(self, fname):
        """Optimizer state of the shared optimizer (every bucket borrows
        the root's updater/kvstore, so the active bucket's view IS the
        state); the preemption checkpoint of ``fit(resume=...)`` writes
        it."""
        self._ready(params=True, optimizer=True)
        self._curr_module.save_optimizer_states(fname)

    def load_optimizer_states(self, fname):
        """Inverse of :meth:`save_optimizer_states`."""
        self._ready(params=True, optimizer=True)
        self._curr_module.load_optimizer_states(fname)

    def install_monitor(self, mon):
        self._ready()
        for module in self._buckets.values():
            module.install_monitor(mon)

"""SequentialModule: a pipeline of modules wired output-to-input.

Counterpart of ``mxnet_tpu/module/sequential_module.py`` (reference
python/mxnet/module/sequential_module.py: ``add`` with the take_labels /
auto_wiring metas, chained bind/forward/backward). The chain is stored as
(module, meta) pairs and the forward / backward wiring is a loop over
that list; each stage's outputs feed the next stage's data where they
lie (on the card for ``Module`` stages bound there).
"""
from __future__ import annotations

import logging

from ..initializer import Uniform
from .base_module import BaseModule


class SequentialModule(BaseModule):
    """Feed each module's outputs into the next one's data inputs."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._chain = []  # list of (module, meta-dict)
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {v for k, v in vars(SequentialModule).items()
                           if k.startswith("META_")}

    def add(self, module, **kwargs):
        """Append a module; metas: take_labels=True feeds labels to this
        stage, auto_wiring=True renames incoming data to its data_names."""
        unknown = set(kwargs) - self._meta_keys
        if unknown:
            raise AssertionError('Unknown meta "%s", a typo?' % unknown.pop())
        self._chain.append((module, kwargs))
        # the chain changed: previous bind/init state is void
        for flag in ("binded", "params_initialized", "optimizer_initialized"):
            setattr(self, flag, False)
        return self

    def _ready(self, params=False, optimizer=False):
        """Guard: module lifecycle must have reached the required stage."""
        if not self.binded:
            raise AssertionError("not bound")
        if params and not self.params_initialized:
            raise AssertionError("parameters not initialized")
        if optimizer and not self.optimizer_initialized:
            raise AssertionError("optimizer not initialized")

    # internal views
    @property
    def _modules(self):
        return [m for m, _meta in self._chain]

    def _takes_labels(self, meta):
        return bool(meta.get(self.META_TAKE_LABELS))

    # ------------------------------------------------------------ shapes
    @property
    def data_names(self):
        return self._chain[0][0].data_names if self._chain else []

    @property
    def output_names(self):
        return self._chain[-1][0].output_names if self._chain else []

    @property
    def data_shapes(self):
        self._ready()
        return self._chain[0][0].data_shapes

    @property
    def label_shapes(self):
        self._ready()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._ready()
        return self._chain[-1][0].output_shapes

    # ------------------------------------------------------------ params
    def get_params(self):
        self._ready(params=True)
        merged_args, merged_auxs = {}, {}
        for module, _meta in self._chain:
            arg, aux = module.get_params()
            merged_args.update(arg)
            merged_auxs.update(aux)
        return merged_args, merged_auxs

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise AssertionError("call bind before initializing the parameters")
        for module, _meta in self._chain:
            module.init_params(initializer, arg_params, aux_params,
                               allow_missing, force_init, allow_extra)
        self._assert_unique_params()
        self.params_initialized = True

    def _assert_unique_params(self):
        """No parameter name may appear in two stages."""
        owner = {}
        modules = self._modules
        for stage, module in enumerate(modules):
            for params in module.get_params():
                for name in params:
                    if name in owner:
                        raise AssertionError(
                            'Duplicated parameter names: name "%s" in layer '
                            "%d (%s) is already used in layer %d (%s)."
                            % (name, stage, type(modules[stage]),
                               owner[name], type(modules[owner[name]])))
                    owner[name] = stage

    # -------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind every stage, threading output shapes into the next stage."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if not self._chain:
            raise AssertionError(
                "Attempting to bind an empty SequentialModule")
        if inputs_need_grad and not for_training:
            raise AssertionError("inputs_need_grad requires training mode")
        if shared_module is not None:
            raise AssertionError("Shared module is not supported")

        self.binded = True
        self._label_shapes = label_shapes

        def rewire(module, shapes):
            names = module.data_names
            assert len(names) == len(shapes)
            return [(fresh, shape)
                    for fresh, (_stale, shape) in zip(names, shapes)]

        flowing = data_shapes
        label_consumed = False
        for stage, (module, meta) in enumerate(self._chain):
            wants_label = self._takes_labels(meta)
            label_consumed |= wants_label
            if meta.get(self.META_AUTO_WIRING, False):
                flowing = rewire(module, flowing)
            needs_grad = bool(for_training and (inputs_need_grad or stage))
            module.bind(flowing, label_shapes if wants_label else None,
                        for_training, needs_grad, force_rebind,
                        None, grad_req)
            flowing = module.output_shapes

        if not label_consumed:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._ready(params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module, _meta in self._chain:
            module.init_optimizer(kvstore, optimizer, optimizer_params,
                                  force_init)
        self.optimizer_initialized = True

    # ------------------------------------------------------------ compute
    def forward(self, data_batch, is_train=None):
        """Run stages in order, rebatching each stage's outputs."""
        self._ready(params=True)
        from ..io import DataBatch

        flowing = DataBatch(data=data_batch.data, label=data_batch.label,
                            pad=data_batch.pad, index=data_batch.index,
                            provide_data=data_batch.provide_data,
                            provide_label=data_batch.provide_label)
        last = len(self._chain) - 1
        for stage, (module, _meta) in enumerate(self._chain):
            module.forward(flowing, is_train=is_train)
            if stage == last:
                return
            outs = module.get_outputs()
            flowing.data = outs
            flowing.provide_data = [(name, arr.shape) for name, arr in
                                    zip(module.output_names, outs)]

    def backward(self, out_grads=None):
        """Run stages in reverse, threading input grads backwards."""
        self._ready(params=True)
        for stage in range(len(self._chain) - 1, -1, -1):
            module = self._chain[stage][0]
            module.backward(out_grads=out_grads)
            if stage:
                out_grads = module.get_input_grads()

    def _stagewise(name, want_labels=False):  # noqa: N805 - body factory
        """Generate a method that calls ``name`` on each stage in order
        (optionally only on label-taking stages)."""
        def method(self, *args):
            self._ready(params=name != "install_monitor",
                        optimizer=name == "update")
            for module, meta in self._chain:
                if want_labels and not self._takes_labels(meta):
                    continue
                getattr(module, name)(*args)
        method.__name__ = name
        method.__doc__ = "Apply %r across the chain." % name
        return method

    update = _stagewise("update")
    update_metric = _stagewise("update_metric", want_labels=True)
    install_monitor = _stagewise("install_monitor")
    del _stagewise

    def get_outputs(self, merge_multi_context=True):
        """Outputs come from the last stage."""
        self._ready(params=True)
        return self._chain[-1][0].get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        """Input grads come from the first stage."""
        self._ready(params=True)
        assert self.inputs_need_grad
        return self._chain[0][0].get_input_grads(
            merge_multi_context=merge_multi_context)

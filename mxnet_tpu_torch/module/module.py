"""Module: symbolic training of one Symbol on one device.

Counterpart of ``mxnet_tpu/module/module.py``: bind / init_params /
init_optimizer / forward / backward / update / update_metric, with the
host-side parameter copies (on the CPU, as MXNet keeps them) and the bound
executor, the gradients and the update on the module's device.
``Module(context=None)`` binds on the CUDA card (and raises where there is
none); the CPU is used only when the caller passes ``mx.cpu()``. Not
ported yet: more than one device (``ROADMAP.md`` Queue A10).
``save_checkpoint`` and ``Module.load`` write and read MXNet's checkpoint
files; ``save_resumable`` writes the resumable checkpoint that
``fit(resume=)`` restarts from.
"""
from __future__ import annotations

import logging
import warnings

import numpy as np

import torch

from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, as_device, cpu
from ..initializer import Uniform, InitDesc
from ..model import (
    _create_kvstore,
    _initialize_kvstore,
    _update_params,
    _update_params_on_kvstore,
    load_checkpoint)
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup


def _normalize_contexts(context):
    """The module's device, as a one-element list: the card for None."""
    if context is None or isinstance(context, (Context, torch.device, str)):
        return [as_device(context)]
    contexts = [as_device(c) for c in context]
    if len(contexts) != 1:
        raise MXNetError("Module over %d devices: multi-device training is "
                         "not yet ported (ROADMAP.md Queue A10)"
                         % len(contexts))
    return contexts


def _coerce_descs(data_shapes, label_shapes, data_names, label_names):
    """Normalize (name, shape) pairs / DataDesc lists and validate names."""
    from ..io import DataDesc

    def _norm(names, shapes):
        if shapes is None:
            return None
        descs = [s if isinstance(s, DataDesc)
                 else DataDesc(s[0], tuple(s[1]), *s[2:])
                 for s in shapes]
        provided = [d.name for d in descs]
        if set(provided) != set(names):
            raise ValueError(
                "Data provided by %s don't match names specified by %s "
                "(%s vs. %s)" % ("desc", "names", provided, list(names)))
        return descs

    return _norm(data_names, data_shapes), _norm(label_names, label_shapes)


class Module(BaseModule):
    """One Symbol bound over data-parallel device replicas."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        self._context = _normalize_contexts(context)
        if work_load_list is not None and len(work_load_list) != 1:
            raise ValueError("work_load_list length must match context count")

        self._symbol = symbol

        # normalize + validate the four name lists
        groups = {}
        for key, value, throw in (("data", data_names, True),
                                  ("label", label_names, False),
                                  ("state", state_names, True),
                                  ("fixed_param", fixed_param_names, True)):
            groups[key] = [] if value is None else list(value)
            _check_input_names(symbol, groups[key], key, throw)

        self._data_names = groups["data"]
        self._label_names = groups["label"]
        self._state_names = groups["state"]
        self._fixed_param_names = groups["fixed_param"]

        non_params = set(self._data_names + self._label_names
                         + self._state_names)
        self._param_names = [a for a in symbol.list_arguments()
                             if a not in non_params]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()

        for attr in ("_arg_params", "_aux_params", "_optimizer", "_kvstore",
                     "_update_on_kvstore", "_updater", "_preload_opt_states",
                     "_grad_req", "_exec_group", "_data_shapes",
                     "_label_shapes"):
            setattr(self, attr, None)
        self._params_dirty = False

    # ------------------------------------------------------------ loading
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """Rebuild a Module from a prefix-NNNN checkpoint."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write prefix-symbol.json + prefix-NNNN.params (+ .states)."""
        self._symbol.save(prefix + "-symbol.json")
        param_file = f"{prefix}-{epoch:04d}.params"
        self.save_params(param_file)
        logging.info('Saved checkpoint to "%s"', param_file)
        if save_optimizer_states:
            state_file = f"{prefix}-{epoch:04d}.states"
            self.save_optimizer_states(state_file)
            logging.info('Saved optimizer state to "%s"', state_file)

    def save_resumable(self, directory, epoch=0, batch=0, step=0,
                       data_iter=None, iterator_state=None):
        """Write one checksummed resumable checkpoint (params +
        optimizer state + random generators + position, plus the data
        stream position when ``data_iter``/``iterator_state`` is given —
        see ``resilience.checkpoint.save_resumable`` for their contract)
        into ``directory``: the operational sibling of
        :meth:`save_checkpoint` that ``fit(resume=directory)`` restarts
        from. Returns the checkpoint path."""
        from ..resilience import checkpoint as _ckpt

        self._require(bound=True, initialized=True)
        return _ckpt.save_resumable(self, directory, epoch=epoch,
                                    batch=batch, step=step,
                                    data_iter=data_iter,
                                    iterator_state=iterator_state)

    # ------------------------------------------------------------- shapes
    data_names = property(lambda self: self._data_names)
    label_names = property(lambda self: self._label_names)
    output_names = property(lambda self: self._output_names)

    def _bound(self, value):
        self._require(bound=True)
        return value

    @property
    def data_shapes(self):
        return self._bound(self._data_shapes)

    @property
    def label_shapes(self):
        return self._bound(self._label_shapes)

    @property
    def output_shapes(self):
        return self._bound(self._exec_group.get_output_shapes())

    def _require(self, bound=False, initialized=False, optimized=False):
        """Raise unless the module has reached the requested lifecycle stage."""
        if bound and not self.binded:
            raise AssertionError("Module is not bound; call bind() first")
        if initialized and not self.params_initialized:
            raise AssertionError("parameters not initialized; call "
                                 "init_params() first")
        if optimized and not self.optimizer_initialized:
            raise AssertionError("optimizer not initialized; call "
                                 "init_optimizer() first")

    # ------------------------------------------------------------- params
    def _skip_reinit(self, caller, force_init):
        """True when params exist and the caller should be a no-op."""
        if not self.params_initialized or force_init:
            return False
        warnings.warn("Parameters already initialized and force_init=False. "
                      "%s call ignored." % caller, stacklevel=3)
        return True

    def get_params(self):
        self._require(bound=True, initialized=True)
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def _initialize_one(self, name, arr, provided, initializer, allow_missing):
        """Fill one host-side parameter from user dict or initializer."""
        if provided is not None and name in provided:
            src = provided[name]
            if src is not arr:
                src.copyto(arr)
            return
        if provided is not None and not allow_missing:
            raise RuntimeError(f"{name} is not presented")
        if initializer is None:
            return
        buf = np.array(arr.asnumpy())  # asnumpy() views are read-only
        # global_init lets composite initializers (FusedRNN) fall back to
        # the module-wide initializer for their inner weights
        desc = InitDesc(name, attrs=self._symbol.attr_dict().get(name, {}),
                        global_init=initializer)
        initializer(desc, buf)
        arr._set_data(torch.from_numpy(buf))

    def _alloc_host_params(self):
        """Host-side master copies, shaped from the bound executors."""
        def fresh(names, device_arrays):
            return {name: nd.zeros(arrs[0].shape, ctx=cpu(),
                                   dtype=arrs[0].dtype)
                    for name, arrs in zip(names, device_arrays)}
        if self._arg_params is None:
            self._arg_params = fresh(self._param_names,
                                     self._exec_group.param_arrays)
        if self._aux_params is None:
            self._aux_params = fresh(self._aux_names,
                                     self._exec_group.aux_arrays)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Initialize (or overwrite) parameters on host and devices."""
        if self._skip_reinit("init_params", force_init):
            return
        self._require(bound=True)

        self._alloc_host_params()
        for host, provided in ((self._arg_params, arg_params),
                               (self._aux_params, aux_params)):
            for name in sorted(host):
                self._initialize_one(name, host[name], provided, initializer,
                                     allow_missing)

        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)
        self.params_initialized = True
        self._params_dirty = False

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Assign parameters. With allow_missing the host copies are left
        untouched and only devices are updated (marked dirty)."""
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self._skip_reinit("set_params", force_init):
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self.params_initialized = True
        self._params_dirty = True

    # --------------------------------------------------------------- bind
    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Allocate executors for the given input shapes."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise AssertionError("inputs_need_grad requires for_training")

        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req

        self._data_shapes, self._label_shapes = _coerce_descs(
            data_shapes, label_shapes, self.data_names, self.label_names)

        shared_group = None
        if shared_module is not None:
            if not (isinstance(shared_module, Module) and shared_module.binded
                    and shared_module.params_initialized):
                raise AssertionError(
                    "shared_module must be a bound, initialized Module")
            shared_group = shared_module._exec_group

        group_cfg = dict(logger=self.logger, grad_req=grad_req,
                         fixed_param_names=self._fixed_param_names,
                         state_names=self._state_names,
                         shared_group=shared_group,
                         for_training=for_training,
                         inputs_need_grad=inputs_need_grad,
                         param_names=self._param_names,
                         label_shapes=self._label_shapes)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes, **group_cfg)
        self._total_exec_bytes = 0

        if shared_module is not None:
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True
            if shared_module.optimizer_initialized:
                self.borrow_optimizer(shared_module)
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        elif self._arg_params is not None or self._aux_params is not None:
            raise AssertionError("unexpected host params on an unbound module")

    def reshape(self, data_shapes, label_shapes=None):
        """Re-bind executors to new input shapes, keeping parameters."""
        self._require(bound=True)
        old = (self._data_shapes, self._label_shapes)
        self._data_shapes, self._label_shapes = _coerce_descs(
            data_shapes, label_shapes, self.data_names, self.label_names)
        if (self._data_shapes, self._label_shapes) == old:
            return
        # simple_bind allocates FRESH zero arrays for every argument, so
        # the device parameters must ride across the re-bind: pull any
        # dirty device copies while the old executors are still alive,
        # then push them into the new ones ("keeping parameters" above
        # used to be silently false — outputs went uniform-zero-weights)
        if self.params_initialized and self._params_dirty:
            self._sync_params_from_devices()
        self._exec_group.reshape(self._data_shapes, self._label_shapes)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # ---------------------------------------------------------- optimizer
    def _build_optimizer(self, optimizer, optimizer_params, update_on_kvstore,
                         rescale_grad):
        """Resolve a string/instance optimizer, wiring param_idx2name."""
        if not isinstance(optimizer, str):
            if not isinstance(optimizer, opt.Optimizer):
                raise TypeError("optimizer must be a name or an Optimizer")
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    "num_workers (%s vs. %s). Is this intended?"
                    % (optimizer.rescale_grad, rescale_grad), stacklevel=2)
            return optimizer

        names = self._exec_group.param_names
        ndev = len(self._context)
        if update_on_kvstore:
            idx2name = dict(enumerate(names))
        else:
            idx2name = {i * ndev + k: n
                        for i, n in enumerate(names) for k in range(ndev)}
        settings = dict(optimizer_params)
        settings.setdefault("rescale_grad", rescale_grad)
        return opt.create(optimizer, sym=self.symbol,
                          param_idx2name=idx2name, **settings)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create kvstore + optimizer and decide where updates run."""
        self._require(bound=True, initialized=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)

        effective_batch = self._exec_group.batch_size

        self._optimizer = self._build_optimizer(
            optimizer, optimizer_params, update_on_kvstore,
            1.0 / effective_batch)
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        if kvstore:
            seed = dict(arg_params=self._arg_params,
                        param_names=self._param_names,
                        update_on_kvstore=update_on_kvstore)
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                **seed)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(self._optimizer)

        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share optimizer state with another Module (bucketing)."""
        assert shared_module.optimizer_initialized
        for attr in ("_optimizer", "_kvstore", "_update_on_kvstore",
                     "_updater"):
            setattr(self, attr, getattr(shared_module, attr))
        self.optimizer_initialized = True

    # ------------------------------------------------------------ compute
    def _adapt_to_batch(self, data_batch):
        """Reshape bound executors if this batch's shapes differ."""
        bound = tuple(d.shape for d in self._data_shapes)
        incoming = tuple(a.shape for a in data_batch.data)
        if bound == incoming:
            return

        def redesc(desc, shape):
            if hasattr(desc, "layout"):
                return type(desc)(desc.name, shape, desc.dtype, desc.layout)
            return type(desc)(desc.name, shape)

        if getattr(data_batch, "provide_data", None):
            dshapes = data_batch.provide_data
        else:
            dshapes = [redesc(d, s)
                       for d, s in zip(self._data_shapes, incoming)]
        if getattr(data_batch, "provide_label", None):
            lshapes = data_batch.provide_label
        elif getattr(data_batch, "label", None):
            lshapes = [redesc(d, arr.shape)
                       for d, arr in zip(self._label_shapes, data_batch.label)]
        else:
            lshapes = None
        self.reshape(dshapes, lshapes)

    def forward(self, data_batch, is_train=None):
        self._require(bound=True, initialized=True)
        self._adapt_to_batch(data_batch)
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._require(bound=True, initialized=True)
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply one optimizer step to all replicas."""
        self._require(bound=True, initialized=True, optimized=True)
        self._params_dirty = True
        grp = self._exec_group
        if self._update_on_kvstore:
            _update_params_on_kvstore(grp.param_arrays, grp.grad_arrays,
                                      self._kvstore, grp.param_names)
        else:
            _update_params(grp.param_arrays, grp.grad_arrays,
                           kvstore=self._kvstore,
                           param_names=grp.param_names,
                           updater=self._updater,
                           num_device=len(self._context))

    def _health_check(self, wall_s):
        """Per-step numerical health check (observability.health): the
        outputs (the loss surrogate), the gradients and the parameters go
        through ONE segmented reduction and ONE host fetch."""
        from ..observability import health

        grp = self._exec_group
        ex = grp.execs[0]
        losses = list(zip(self._output_names, ex.outputs))
        bound = [n for n in grp.param_names if n in grp.arg_names]
        grads = [(name, replicas[0])
                 for name, replicas in zip(bound, grp.grad_arrays or [])
                 if replicas[0] is not None]
        params = [(name, replicas[0])
                  for name, replicas in zip(bound, grp.param_arrays)]
        self._health_steps += 1
        lr = getattr(self._optimizer, "lr", None) \
            if self._optimizer is not None else None
        return health.guard_step(
            "module.fit", losses=losses, grads=grads, params=params,
            lr=lr, step=self._health_steps, wall_s=wall_s,
            can_skip=health.skip_allowed(self._kvstore))

    def _set_output_selection(self, sel):
        """Thread ``predict(outputs=...)`` selection into the bound
        executors: the compiled inference program is pruned to the
        selected heads' ancestors (Executor.select_outputs)."""
        self._require(bound=True)
        self._exec_group.set_output_selection(sel)
        return True

    def get_outputs(self, merge_multi_context=True):
        self._require(bound=True, initialized=True)
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require(bound=True, initialized=True)
        if not self.inputs_need_grad:
            raise AssertionError("bind with inputs_need_grad=True first")
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        grp = self._exec_group
        grp.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        grp = self._exec_group
        grp.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    # -------------------------------------------------------------- misc
    def save_optimizer_states(self, fname):
        self._require(optimized=True)
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        blob = self._updater.get_states()
        with open(fname, "wb") as sink:
            sink.write(blob)

    def load_optimizer_states(self, fname):
        self._require(optimized=True)
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as src:
            blob = src.read()
        self._updater.set_states(blob)

    def install_monitor(self, mon):
        self._require(bound=True)
        for exe in self._exec_group.execs:
            mon.install(exe)

    def prepare(self, data_batch):
        self._require(bound=True)

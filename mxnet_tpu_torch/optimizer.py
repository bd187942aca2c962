"""Optimizers: the registry, ``SGD`` and the ``Updater``.

Counterpart of ``mxnet_tpu/optimizer.py``: the registry / ``create``
surface, per-index lr/wd multipliers, ``SGD`` (momentum and
multi-precision) and the ``Updater`` with its pickled-state contract.
``SGD`` runs the update ops of ``ops/optimizer_ops.py`` through
``mx.nd`` with ``out=weight``, so each update writes the weight and its
state in place. The other optimizers (DCASGD, SGLD, NAG, Adam, AdaGrad,
RMSProp, AdaDelta, Ftrl, Adamax, Nadam) wait for the Gluon slice.
"""
from __future__ import annotations

import logging
import pickle

import numpy as np

from . import ndarray as nd
from .ndarray import NDArray


def _store_hyperparams(obj, local_vars, *names):
    """Assign ctor hyperparameters onto the instance in one place."""
    for name in names:
        setattr(obj, name, local_vars[name])


__all__ = ["Optimizer", "SGD", "create", "register", "Updater",
           "get_updater"]


class Optimizer:
    """Base class: hyperparameter bookkeeping + the update() contract."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        key = klass.__name__.lower()
        if key in Optimizer.opt_registry:
            logging.warning("WARNING: New optimizer %s is overriding "
                            "existing optimizer %s", klass.__name__, key)
        Optimizer.opt_registry[key] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        try:
            klass = Optimizer.opt_registry[name.lower()]
        except KeyError:
            raise ValueError("Cannot find optimizer %s" % name)
        # construct outside the except scope: a KeyError raised INSIDE
        # an optimizer ctor must propagate, not masquerade as a lookup miss
        return klass(**kwargs)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.sym = sym
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise AssertionError(
                "param_idx2name should be a dict of param indexes to names.")
        self.idx2name = dict(param_idx2name)
        self.set_lr_mult({})
        self.set_wd_mult({})

    # ------------------------------------------------------------ contract
    def create_state(self, index, weight):
        """Per-parameter auxiliary state (None when stateless)."""
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    # ----------------------------------------------------- hyperparameters
    def _sym_attr_mults(self, attr_key):
        """Multipliers declared as symbol attributes (__lr_mult__ etc.)."""
        table = {}
        if self.sym is not None:
            attrs = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if attr_key in attrs.get(name, ()):
                    table[name] = float(attrs[name][attr_key])
        return table

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_attr_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Bias/gamma/beta entries default to zero weight decay."""
        self.wd_mult = {
            n: 0.0 for n in self.idx2name.values()
            if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._sym_attr_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _mult_for(self, table, index):
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _resume_extras(self):
        """Host-side scalar state that must survive checkpoint-resume
        beyond per-index counts; optimizers with extra running scalars
        override (Nadam's m_schedule)."""
        return {}

    def _get_lr(self, index):
        base = (self.lr_scheduler(self.num_update)
                if self.lr_scheduler is not None else self.lr)
        return base * self._mult_for(self.lr_mult, index)

    def _get_wd(self, index):
        return self.wd * self._mult_for(self.wd_mult, index)

    # ----------------------------------------------------- shared plumbing
    def _fused_kwargs(self, index, **extra):
        """kwargs for the fused update ops: lr/wd/rescale(/clip) + extras."""
        kw = {"lr": self._get_lr(index), "wd": self._get_wd(index),
              "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        kw.update(extra)
        return kw


register = Optimizer.register


def create(name, **kwargs):
    """Instantiate a registered optimizer by name."""
    return Optimizer.create_optimizer(name, **kwargs)


@register
class SGD(Optimizer):
    """(Momentum) SGD with optional fp16 master weights, through the
    sgd_update / sgd_mom_update / mp_sgd_* ops."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        _store_hyperparams(self, locals(), "momentum", "multi_precision")

    def create_state(self, index, weight):
        if self.multi_precision and weight.dtype == np.float16:
            master = weight.astype(np.float32)
            mom = (nd.zeros(weight.shape, weight.context, dtype=np.float32)
                   if self.momentum != 0.0 else None)
            return (mom, master)
        if weight.dtype == np.float16:
            logging.warning(
                "Accumulating with float16 in optimizer can lead to poor "
                "accuracy or slow convergence. Consider using "
                "multi_precision=True option of the SGD optimizer")
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        extra = {"momentum": self.momentum} if self.momentum > 0 else {}
        kw = self._fused_kwargs(index, **extra)
        if isinstance(state, (list, tuple)):  # multi-precision
            mom, master = state
            if mom is not None:
                nd.mp_sgd_mom_update(weight, grad, mom, master, out=weight,
                                     **kw)
            else:
                nd.mp_sgd_update(weight, grad, master, out=weight, **kw)
        elif state is not None:
            nd.sgd_mom_update(weight, grad, state, out=weight, **kw)
        else:
            nd.sgd_update(weight, grad, out=weight, **kw)


def _to_host(value):
    """NDArray (possibly nested in tuples) -> numpy for pickling."""
    if isinstance(value, NDArray):
        return value.asnumpy()
    if isinstance(value, (tuple, list)):
        return tuple(_to_host(v) for v in value)
    return value


class Updater:
    """Per-key stateful update callable (local updates + kvstore server)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = self.sync_state_context(
                self.states[index], weight.context)
            self.states_synced[index] = True
        self.optimizer.update(index, weight, grad, self.states[index])

    def sync_state_context(self, state, context):
        """Rebuild loaded state on the right device (numpy → NDArray)."""
        if isinstance(state, NDArray):
            return state.as_in_context(context)
        if isinstance(state, np.ndarray):
            # get_states serializes to numpy; rebuild NDArrays on load so
            # the first post-resume update doesn't see raw numpy
            return nd.array(state, ctx=context)
        if isinstance(state, (tuple, list)):
            return type(state)(
                self.sync_state_context(s, context) for s in state)
        return state

    def set_states(self, states):
        obj = pickle.loads(states)
        if isinstance(obj, dict) and obj.get("__format__") == "mxtpu_v2":
            self.states = obj["states"]
            self._loaded_counts = dict(obj["counts"])
            self._loaded_num_update = obj["num_update"]
            self._loaded_extras = dict(obj.get("extras", {}))
            self._apply_counts(self.optimizer)
        elif isinstance(obj, tuple) and len(obj) == 2 \
                and isinstance(obj[1], Optimizer):
            # reference dump_optimizer format (optimizer.py get_states
            # pickles ``(states, optimizer)``): restore both — the
            # shipped optimizer carries its own update counts
            self.states, self.optimizer = obj
            self._loaded_counts = None
        elif isinstance(obj, dict):
            # legacy blob (reference format): bare {index: state} dict —
            # update counts are not recorded there, matching the
            # reference 1.0.0 wart that Adam's t restarts on resume
            self.states = obj
            self._loaded_counts = None
        else:
            raise TypeError(
                "set_states expects a pickled {index: state} dict, a "
                "(states, optimizer) tuple (dump_optimizer format), or "
                "an mxtpu_v2 blob; got %s" % type(obj).__name__)
        self.states_synced = dict.fromkeys(self.states, False)

    def _apply_counts(self, optimizer):
        """Restore per-index update counts (Adam/Adamax/Nadam bias
        correction, scheduler num_update) and host-side scalar state
        (Nadam's m_schedule) into ``optimizer``. Re-applied by callers
        that swap ``self.optimizer`` after set_states."""
        if getattr(self, "_loaded_counts", None) is None:
            return
        # REPLACE, don't merge: a rollback load (re-loading a step-100
        # checkpoint after training to step 200 in the same process)
        # must rewind the scheduler's num_update and every per-index
        # count together, or lr and Adam bias correction disagree
        optimizer._index_update_count = dict(self._loaded_counts)
        optimizer.num_update = self._loaded_num_update
        for k, v in getattr(self, "_loaded_extras", {}).items():
            setattr(optimizer, k, v)

    def get_states(self, dump_optimizer=False):
        host_states = {k: _to_host(v) for k, v in self.states.items()}
        if dump_optimizer:
            # reference format: pickle (states, optimizer) together so a
            # kvstore server can rebuild the whole updater from one blob
            return pickle.dumps((host_states, self.optimizer))
        return pickle.dumps({
            "__format__": "mxtpu_v2",
            "states": host_states,
            "counts": dict(self.optimizer._index_update_count),
            "num_update": self.optimizer.num_update,
            "extras": self.optimizer._resume_extras(),
        })


def get_updater(optimizer):
    """Wrap an optimizer in a fresh Updater."""
    return Updater(optimizer)

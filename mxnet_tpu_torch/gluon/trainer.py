"""Gluon Trainer: one optimizer step over a set of Parameters, and
``compile_step``: the whole training step as one CUDA graph.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
gluon/trainer.py): the constructor, ``step`` (through a kvstore, or the
fused local update), ``allreduce_grads`` / ``update``,
``set_learning_rate`` and ``save_states`` / ``load_states``.

``compile_step(net, loss_fn)`` returns ``step(data, label) -> loss``: the
forward of ``loss_fn(net(data), label)`` traced symbolically into one
``_GraphProgram`` (no graph pass, as in the JAX package), its gradient
(of ``sum(loss)``, as ``loss.backward()`` seeds it) and the optimizer's
update of every trainable parameter, with the BatchNorm moving statistics
from the same forward. The JAX package compiles that into one XLA program
per (input signature, optimizer signature); here, on a CUDA card, it is one
``torch.cuda.CUDAGraph`` per signature, captured once and replayed:

- the graph reads and writes the parameters', aux states' and optimizer
  states' own tensors (updates are in place, so their addresses hold) and
  copies each batch into its input buffers;
- the per-step scalars (each parameter's learning rate, Adam's bias
  correction folded in; ``rescale_grad``; ``clip_gradient``) live in a
  device vector that the host refreshes before each replay, so a schedule
  or ``set_learning_rate`` captures nothing new;
- the warm-up before a capture runs the step body on a side stream and
  drops its results, so it moves no parameter or state;
- Dropout draws from the card's default generator, which the graph
  captures: every replay draws new bits.

``compile_count`` counts the captures. On the CPU the same body runs
eagerly each step, with the same semantics.

Under ``MXNET_HEALTH`` (observability/health.py) ``step`` checks every
live gradient and weight before the update and ``compile_step`` checks
the loss and the updated weights after the replay. Under ``skip_step``
and ``raise`` the captured graph holds no copy into the live tensors: the
copies run after the verdict, outside the graph, and a skipped step
leaves every parameter, optimizer state and moving statistic as it was
(``off`` and ``warn`` capture the copies in the graph, as without the
check).
"""
from __future__ import annotations

import time

import torch

from .. import cuda_graph
from .. import optimizer as opt
from .. import symbol as sym_mod
from ..executor import _GraphProgram
from ..model import _create_kvstore
from ..ndarray.ndarray import _from_data
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _as_param_list(params):
    """A dict, ParameterDict or list of Parameters as a list."""
    if isinstance(params, (dict, ParameterDict)):
        params = list(params.values())
    if not isinstance(params, (list, tuple)):
        raise ValueError(
            "First argument must be a list or dict of Parameters, "
            "got %s." % (type(params)))
    for p in params:
        if not isinstance(p, Parameter):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got list of %s." % (type(p)))
    return list(params)


class Trainer:
    """Applies an Optimizer to a set of Parameters (reference:
    trainer.py Trainer)."""

    # optimizers whose per-step host scalar is the learning rate alone
    # (Adam's bias correction folded in): the fused local step and
    # compile_step take them
    _FUSABLE = ("SGD", "NAG", "Adam", "RMSProp", "AdaGrad", "AdaDelta",
                "Ftrl")

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None, fuse_step=True):
        self._params = _as_param_list(params)
        if compression_params:
            raise ValueError("gradient compression is not ported")
        optimizer_params = dict(optimizer_params or {})
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        self._contexts = self._common_contexts()
        self._optimizer = self._build_optimizer(optimizer, optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts]
        self._kv_initialized = False
        self._kvstore = kvstore
        self._update_on_kvstore = False
        self._fuse_step = fuse_step
        self._health_steps = 0

    def _common_contexts(self):
        """All parameters must live on one identical context list."""
        seen = None
        for p in self._params:
            ctx = p.list_ctx()
            if seen is not None and seen != ctx:
                raise AssertionError(
                    "All Parameters must be initialized on the same set of "
                    "contexts, but Parameter %s is initialized on %s while "
                    "previous Parameters are initialized on %s."
                    % (p.name, str(ctx), str(seen)))
            seen = ctx
        return seen

    def _build_optimizer(self, optimizer, optimizer_params):
        idx2name = {i: p.name for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise AssertionError(
                    "optimizer_params must be None if optimizer is an "
                    "Optimizer instance")
            optimizer.idx2name = idx2name
        else:
            optimizer = opt.create(optimizer, param_idx2name=idx2name,
                                   **optimizer_params)
        optimizer.set_lr_mult({p.name: p.lr_mult for p in self._params})
        optimizer.set_wd_mult({p.name: p.wd_mult for p in self._params})
        return optimizer

    def _init_kvstore(self):
        """Create the kvstore on the first step and seed it (one device
        with a local type needs none: the update runs locally)."""
        sample = {p.name: p.data(self._contexts[0]) for p in self._params}
        kvstore, update_on_kvstore = _create_kvstore(
            self._kvstore, len(self._contexts), sample)
        self._kvstore = kvstore or None
        self._update_on_kvstore = bool(kvstore) and update_on_kvstore
        if self._kvstore is not None:
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
            for i, p in enumerate(self._params):
                kvstore.init(p.name, p.data(self._contexts[0]))
                if update_on_kvstore:
                    kvstore.pull(p.name, p.list_data(), priority=-i)
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        """Change the learning rate (a compiled step reads it from the
        device, so nothing is captured again)."""
        self._optimizer.lr = lr

    def _set_rescale(self, batch_size):
        self._optimizer.rescale_grad = self._scale / batch_size

    def step(self, batch_size, ignore_stale_grad=False):
        """Push the gradients and pull the updated weights (kvstore), or
        update locally; ``batch_size`` normalizes the gradient."""
        from ..observability import health, record_step, trace_span

        started = time.perf_counter()
        with trace_span("trainer.step", "gluon"):
            if not self._kv_initialized:
                self._init_kvstore()
            self._set_rescale(batch_size)
            if health.active():
                # gradient/weight check BEFORE any push or update, so
                # skip_step drops the whole step and weights stay finite
                verdict = self._health_check(time.perf_counter() - started)
                if verdict is not None and verdict.skip:
                    record_step(time.perf_counter() - started)
                    return
            if self._kvstore is None and self._can_fuse():
                with trace_span("fused_update", "gluon"):
                    self._fused_local_step()
            else:
                with trace_span("optimizer_update", "gluon"):
                    self._update_all()
        record_step(time.perf_counter() - started)

    def _update_all(self):
        for i, p in self._live_params():
            if self._kvstore is not None:
                self._kvstore.push(p.name, p.list_grad(), priority=-i)
                if self._update_on_kvstore:
                    self._kvstore.pull(p.name, p.list_data(), priority=-i)
                    continue
                self._kvstore.pull(p.name, p.list_grad(), priority=-i)
            for updater, weight, grad in zip(self._updaters, p.list_data(),
                                             p.list_grad()):
                updater(i, grad, weight)

    def _health_check(self, wall_s):
        """Non-finite check over every live parameter's gradient (all
        contexts) and its weight — one reduction, one host fetch
        (observability.health.guard_step)."""
        from ..observability import health

        multi = len(self._contexts or ()) > 1
        grads, params = [], []
        for _i, p in self._live_params():
            for k, g in enumerate(p.list_grad()):
                grads.append(("%s@%d" % (p.name, k) if multi else p.name, g))
            params.append((p.name, p.list_data()[0]))
        self._health_steps += 1
        return health.guard_step(
            "gluon.trainer", grads=grads, params=params,
            lr=getattr(self._optimizer, "lr", None),
            step=self._health_steps, wall_s=wall_s,
            can_skip=health.skip_allowed(self._kvstore))

    def allreduce_grads(self):
        """Sum each gradient across contexts through the kvstore (nothing
        to do without one)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise AssertionError("allreduce_grads() when parameters are "
                                 "updated on the kvstore is not supported")
        if self._kvstore is None:
            return
        for i, p in self._live_params():
            self._kvstore.push(p.name, p.list_grad(), priority=-i)
            self._kvstore.pull(p.name, p.list_grad(), priority=-i)

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone (after :meth:`allreduce_grads`)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise AssertionError("update() when parameters are updated on "
                                 "the kvstore is not supported")
        self._set_rescale(batch_size)
        for i, p in self._live_params():
            for updater, weight, grad in zip(self._updaters, p.list_data(),
                                             p.list_grad()):
                updater(i, grad, weight)

    # --- the fused local update ----------------------------------------------
    def _can_fuse(self):
        return (self._fuse_step and len(self._contexts) == 1
                and type(self._optimizer).__name__ in self._FUSABLE)

    def _live_params(self):
        return [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]

    def _fused_signature(self):
        """What a captured step bakes in: the optimizer, its constant
        hyperparameters, the trainable parameters' shapes and dtypes, and
        whether gradients are clipped (the per-step scalars are read from
        the device)."""
        o = self._optimizer
        static = tuple(
            (k, getattr(o, k)) for k in
            ("wd", "momentum", "multi_precision", "beta1", "beta2",
             "epsilon", "gamma1", "gamma2", "centered", "clip_weights",
             "rho", "lamda1", "beta", "float_stable_eps") if hasattr(o, k))
        return (type(o).__name__,
                tuple((p.shape, str(p.dtype)) for _i, p in
                      self._live_params()),
                static, o.clip_gradient is not None,
                tuple(sorted(o.wd_mult.items())))

    def _materialize_states(self, live):
        """Each live parameter's optimizer state, created where missing."""
        updater = self._updaters[0]
        for i, p in live:
            if i not in updater.states:
                updater.states[i] = self._optimizer.create_state(
                    i, p.list_data()[0])
                updater.states_synced[i] = True

    def _host_prestep(self, live):
        """The host's part of a step: loaded states onto the device, the
        update counts advanced, and each parameter's learning rate for
        this step (schedule and Adam's bias correction resolved)."""
        updater = self._updaters[0]
        for i, p in live:
            if not updater.states_synced.get(i, True):
                updater.states[i] = updater.sync_state_context(
                    updater.states[i], p.list_data()[0].context)
                updater.states_synced[i] = True
        o = self._optimizer
        for i, _p in live:
            o._update_count(i)
        return [float(o.step_lr(i)) for i, _p in live]

    def _fused_local_step(self):
        """Every live parameter's update, in place, from one host pass."""
        live = self._live_params()
        self._materialize_states(live)
        lrs = self._host_prestep(live)
        o = self._optimizer
        states = self._updaters[0].states
        with torch.no_grad():
            for (i, p), lr in zip(live, lrs):
                w, g = p.list_data()[0], p.list_grad()[0]
                arrays = opt.flat_state(states[i])
                new_w, new_s = o.step_tensors(
                    i, w._data, g._data, [a._data for a in arrays], lr,
                    o.rescale_grad, o.clip_gradient)
                for arr, value in zip([w] + arrays, [new_w] + new_s):
                    arr._set_data(value)

    def compile_step(self, net, loss_fn, batch_axis=0):
        """``step(data, label) -> loss``: forward, backward and the update
        of every trainable parameter as one captured CUDA graph (one
        eager body on the CPU); see the module docstring. The same as
        ``loss.backward()`` then ``step(data.shape[batch_axis])``. Both
        ``net`` and ``loss_fn`` must be HybridBlocks."""
        return _FusedTrainStep(self, net, loss_fn, batch_axis)

    # --- optimizer state -----------------------------------------------------
    def save_states(self, fname):
        """Write the optimizer state (the store's when it updates)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as sink:
            sink.write(self._updaters[0].get_states())

    def load_states(self, fname):
        """Inverse of :meth:`save_states`."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
            return
        with open(fname, "rb") as src:
            blob = src.read()
        for updater in self._updaters:
            updater.set_states(blob)
            updater.optimizer = self._optimizer
            # the counts were restored into the optimizer just replaced
            updater._apply_counts(self._optimizer)


class _Captured:
    """One captured step: its graph, its batch input buffers, its loss
    output and the tensors whose addresses it holds."""

    def __init__(self, graph, data, label, loss, ptrs, new):
        self.graph = graph
        self.data = data
        self.label = label
        self.loss = loss
        self.ptrs = ptrs
        self.new = new  # (new weights, states, aux) when the copies are gated


class _FusedTrainStep:
    """The step :meth:`Trainer.compile_step` returns."""

    def __init__(self, trainer, net, loss_fn, batch_axis=0):
        self._trainer = trainer
        self._net = net
        self._loss_fn = loss_fn
        self._batch_axis = batch_axis
        self._built = None     # (prog, plan, live, aux_params, grad_pos)
        self._key = None
        self._captured = None
        self._scalars = None   # the per-step scalars on the device
        self.compile_count = 0

    def _check_local(self):
        trainer = self._trainer
        if trainer._kvstore is not None and trainer._kv_initialized:
            raise ValueError(
                "compile_step fuses the update locally; it does not "
                "support kvstore-backed training (use trainer.step)")

    def _build(self, data):
        trainer = self._trainer
        self._check_local()
        if not trainer._can_fuse():
            raise ValueError(
                "compile_step requires a fusable optimizer (%s) and a "
                "single context" % (Trainer._FUSABLE,))
        params = self._net.collect_params()
        if any(p._data is None for p in params.values()):
            self._net._finish_deferred(params.values(), data)
        data_var = sym_mod.Variable("data")
        label_var = sym_mod.Variable("label")
        loss_sym = self._loss_fn(self._net(data_var), label_var)
        if isinstance(loss_sym, (list, tuple)) or len(loss_sym) != 1:
            raise ValueError("loss_fn must produce a single output")
        prog = _GraphProgram(loss_sym)
        table = dict(params.items())
        table.update(self._loss_fn.collect_params().items())
        plan = [("input", name) if name in ("data", "label")
                else ("param", table[name]) for name in prog.arg_names]
        aux_params = [table[name] for name in prog.aux_names]
        in_graph = {id(p) for kind, p in plan if kind == "param"}
        live = [(i, p) for i, p in trainer._live_params()
                if id(p) in in_graph]
        if not live:
            raise ValueError("no trainable parameter of this Trainer "
                             "appears in the traced graph")
        slot = {id(p): j for j, (_i, p) in enumerate(live)}
        grad_pos = [slot.get(id(p)) for kind, p in plan if kind == "param"]
        return prog, plan, live, aux_params, grad_pos

    # --- the step body -------------------------------------------------------
    def _tensors(self, ctx):
        """(live weights, frozen weights, aux states, optimizer states)."""
        prog, plan, live, aux_params, grad_pos = self._built
        w_live = [p.data(ctx)._data for _i, p in live]
        graph_params = [p for kind, p in plan if kind == "param"]
        w_frozen = [p.data(ctx)._data
                    for p, s in zip(graph_params, grad_pos) if s is None]
        aux = [p.data(ctx)._data for p in aux_params]
        states = self._trainer._updaters[0].states
        opt_states = [[a._data for a in opt.flat_state(states[i])]
                      for i, _p in live]
        return w_live, w_frozen, aux, opt_states

    def _body(self, w_live, w_frozen, aux, data, label, opt_states,
              scalars):
        """One step as a function of its inputs: (loss, new live weights,
        new optimizer states, new aux states). ``scalars`` holds each live
        parameter's learning rate, then rescale_grad and clip_gradient."""
        prog, plan, live, _aux_params, grad_pos = self._built
        leaves = [w.detach().requires_grad_(True) for w in w_live]
        frozen = iter(w_frozen)
        arg_d = {}
        params = iter(grad_pos)
        for name, (kind, v) in zip(prog.arg_names, plan):
            if kind == "input":
                arg_d[name] = data if v == "data" else label
            else:
                s = next(params)
                arg_d[name] = next(frozen) if s is None else leaves[s]
        aux_d = dict(zip(prog.aux_names, aux))
        with torch.enable_grad():
            outs, aux_upd = prog._eval(arg_d, aux_d, True)
            loss = outs[0]
            grads = torch.autograd.grad(loss.sum(), leaves,
                                        allow_unused=True)
        o = self._trainer._optimizer
        n = len(live)
        clip = scalars[n + 1] if o.clip_gradient is not None else None
        new_w, new_s = [], []
        with torch.no_grad():
            for j, ((i, _p), w, g, st) in enumerate(
                    zip(live, w_live, grads, opt_states)):
                g = torch.zeros_like(w) if g is None else g.to(w.dtype)
                nw, ns = o.step_tensors(i, w, g, st, scalars[j], scalars[n],
                                        clip)
                new_w.append(nw.to(w.dtype))
                new_s.append(ns)
        new_aux = [aux_upd[name].detach() if name in aux_upd else a
                   for name, a in zip(prog.aux_names, aux)]
        return loss.detach(), new_w, new_s, new_aux

    @staticmethod
    def _write_back(tensors, new_w, new_s, new_aux):
        w_live, _w_frozen, aux, opt_states = tensors
        with torch.no_grad():
            for buf, v in zip(w_live, new_w):
                buf.copy_(v)
            for bufs, vs in zip(opt_states, new_s):
                for buf, v in zip(bufs, vs):
                    buf.copy_(v)
            for buf, v in zip(aux, new_aux):
                if buf is not v:
                    buf.copy_(v)

    def _step_eager(self, data, label, scalars):
        """The body run eagerly on the current state, which it leaves as
        it was: (loss, new live weights, new states, new aux). On the card
        it is what a replay is held to."""
        tensors = self._tensors(data.context)
        return self._body(*tensors[:3], data._data, label._data, tensors[3],
                          scalars)

    def _scalar_values(self, lrs):
        o = self._trainer._optimizer
        return lrs + [o.rescale_grad, o.clip_gradient or 0.0]

    def _capture(self, tensors, data, label, gated):
        """Capture one step over the state tensors and new batch buffers;
        the warm-up runs on the capture's side stream and drops its
        results. ``gated``: the copies into the live tensors stay out of
        the graph (they run after the health verdict)."""
        dev = data.device
        static_data = data.detach().clone()
        static_label = label.detach().clone()

        def body():
            return self._body(*tensors[:3], static_data, static_label,
                              tensors[3], self._scalars)

        write_back = None if gated else (
            lambda out: self._write_back(tensors, *out[1:]))
        graph, (loss, *new) = cuda_graph.capture(body, dev, write_back,
                                                 key=self._key)
        return _Captured(graph, static_data, static_label, loss,
                         _pointers(tensors), new)

    def _guard(self, loss, new_w):
        """The health verdict of a step from its loss and updated live
        weights (the gradients never leave the step: a non-finite
        gradient surfaces as a non-finite updated weight); None when
        health is off."""
        from ..observability import health

        if not health.active():
            return None
        trainer = self._trainer
        trainer._health_steps += 1
        return health.guard_step(
            "gluon.compile_step", losses=[("loss", loss)],
            params=[("%s(updated)" % p.name, w)
                    for (_i, p), w in zip(self._built[2], new_w)],
            lr=getattr(trainer._optimizer, "lr", None),
            step=trainer._health_steps)

    def __call__(self, data, label):
        trainer = self._trainer
        if self._built is None:
            # first: it finishes deferred parameter init, which the
            # kvstore decision samples
            self._built = self._build(data)
        if not trainer._kv_initialized:
            trainer._init_kvstore()
        self._check_local()
        if trainer._kvstore is not None:
            raise ValueError(
                "compile_step fuses the update locally; it does not "
                "support kvstore-backed training (use trainer.step)")
        live = self._built[2]
        trainer._set_rescale(data.shape[self._batch_axis])
        trainer._materialize_states(live)
        lrs = trainer._host_prestep(live)
        ctx = data.context
        tensors = self._tensors(ctx)
        from ..observability import health

        gated = health.active() and health.policy() in ("skip_step",
                                                        "raise")
        key = (tuple(data.shape), str(data.dtype), tuple(label.shape),
               str(label.dtype), trainer._fused_signature(), gated)
        if key != self._key:
            self._key = key
            self._captured = None
            self.compile_count += 1
        values = torch.tensor(self._scalar_values(lrs), dtype=torch.float32)
        if data._data.device.type != "cuda":
            self._scalars = values
            loss, new_w, new_s, new_aux = self._body(
                *tensors[:3], data._data, label._data, tensors[3], values)
            verdict = self._guard(loss, new_w)
            if verdict is None or not verdict.skip:
                self._write_back(tensors, new_w, new_s, new_aux)
            return _from_data(loss)
        if self._scalars is None or self._scalars.numel() != len(values) \
                or self._scalars.device != data._data.device:
            self._scalars = torch.zeros(len(values), dtype=torch.float32,
                                        device=data._data.device)
            self._captured = None
        self._scalars.copy_(values.pin_memory(), non_blocking=True)
        cap = self._captured
        if cap is not None and cap.ptrs != _pointers(tensors):
            # a state array was replaced (load_states, cast): capture anew
            cap = None
            self.compile_count += 1
        if cap is None:
            cap = self._captured = self._capture(tensors, data._data,
                                                 label._data, gated)
        with torch.no_grad():
            if data._data is not cap.data:
                cap.data.copy_(data._data)
            if label._data is not cap.label:
                cap.label.copy_(label._data)
        cap.graph.replay()
        loss = cap.loss.clone()
        verdict = self._guard(loss, cap.new[0])
        if gated and not verdict.skip:
            self._write_back(tensors, *cap.new)
        return _from_data(loss)


def _pointers(tensors):
    w_live, w_frozen, aux, opt_states = tensors
    flat = list(w_live) + list(w_frozen) + list(aux) + \
        [t for st in opt_states for t in st]
    return tuple(t.data_ptr() for t in flat)

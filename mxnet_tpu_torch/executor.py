"""Graph evaluation and binding: ``_GraphProgram`` and ``Executor``.

Counterpart of ``mxnet_tpu/executor.py``. The JAX package lowers a whole
graph into one jitted XLA program, and a training forward into one program
that also returns the gradients (``jax.vjp`` seeded with ones). PyTorch
runs eagerly, so here a program is a walk of the graph in topological
order that applies each op's forward to tensors: under
``torch.inference_mode()`` for inference, and under autograd for
training, with the gradient-carrying arguments as leaves. ``backward``
then differentiates the recorded walk (ones as the head gradient, which
the loss heads ignore, as in the JAX package). Launches are asynchronous
on the current CUDA stream, so one walk enqueues the whole forward before
anything waits on it.

With a monitor callback installed (:meth:`Executor.set_monitor_callback`)
the walk hands every node output to the callback as it is computed, under
the JAX package's ``<node>_output`` names and in its order: the per-node
spy pass of the reference's ``ExecuteMonCallback``, which calibration of
the ``quantize`` pass reads. The walk is eager anyway, so a monitored
forward costs one walk, also in training.

Observability: inside a fit-step scope (``observability.perf``) a program
run is timed on the card by two CUDA events on the current stream, one
before the walk's first launch and one after the last launch of its
backward (or of the inference walk); the step scope reads them at its end.
The analytic cost is memoized per (mode, shape signature) on the
``_GraphProgram``. While a profiler session runs each run records a
``forward`` / ``forward_backward`` event; :meth:`Executor.health_check`
runs the health layer's check over the outputs and gradients.

Not ported: model-parallel ``group2ctx`` binds (``ROADMAP.md`` Queue
A13); asking for one raises.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

from .autotune import cache as _tune_cache
from .autotune.registry import declare as _declare_tunable
from .base import MXNetError, dtype_name
from .context import Context, as_device
from .ops.registry import OpAttrs

__all__ = ["Executor", "resolve_output_indices"]


def _remat_default(ctx):
    from .config import get_flag

    return {"mirror": int(bool(get_flag("MXNET_BACKWARD_DO_MIRROR")))}


# the executor's program-build knob: store activations vs recompute the
# forward in the backward (torch.utils.checkpoint), a measured
# memory/backward-work tradeoff, keyed per graph fingerprint
# (autotune.tune_remat drives the measurement)
_declare_tunable(
    "exec.remat",
    space={"mirror": (0, 1)},
    default=_remat_default,
    doc="Training walk remat policy: 0 = store activations, 1 = recompute "
        "the forward in the backward (torch.utils.checkpoint).")

# each graph fingerprint's tuned exec.remat decision (None: no entry)
_REMAT_CARRY = _tune_cache.Carry()


def _tuned_remat(key):
    tuned = _tune_cache.lookup("exec.remat", key=key)
    return bool(tuned.get("mirror", 0)) if isinstance(tuned, dict) else None


def resolve_output_indices(names, outputs):
    """Map requested output heads (indices, output names, or node names
    with the ``_output`` suffix left off) onto positions in ``names``."""
    sel = []
    for o in outputs:
        if isinstance(o, int):
            if not 0 <= o < len(names):
                raise ValueError("outputs: index %d out of range (%d "
                                 "outputs)" % (o, len(names)))
            sel.append(o)
        elif o in names:
            sel.append(names.index(o))
        elif o + "_output" in names:
            sel.append(names.index(o + "_output"))
        else:
            raise ValueError("outputs: %r is not an output (outputs: %s)"
                             % (o, list(names)))
    return sel


class _GraphProgram:
    """Evaluation plan for one Symbol."""

    def __init__(self, symbol, tuning_key=None):
        # ``tuning_key`` pins the fingerprint when ``symbol`` is a
        # pass-rewritten graph: autotune entries (exec.remat) are keyed by
        # the original graph, so tuned decisions resolve under any pass
        # config
        self.symbol = symbol
        self._tuning_key = tuning_key
        self.topo = [n for n in symbol.topo_nodes() if not n.is_variable]
        args, aux = symbol._classify_vars()
        self.arg_names = [n.name for n in args]
        self.aux_names = [n.name for n in aux]
        # a random op in the walk (mirroring must replay its draws)
        self.random = any(n.opdef().needs_rng for n in self.topo)
        # creation nodes with 0 (unknown) dims in their declared shape (the
        # RNN cells' begin states): the real shape comes from inference
        # over the bound arguments' shapes, as the JAX package's
        self._deferred_init = [
            n for n in self.topo if n.op in ("_zeros", "_ones")
            and 0 in tuple(n.parsed_attrs().get("shape", ()))]
        self._init_attrs = {}  # guarded-by: self._lock
        self._sel_topo = {}  # guarded-by: self._lock
        self._perf_costs = {}  # (mode, shape sig) -> cost  # guarded-by: self._lock
        self._lock = threading.Lock()

    def tuning_key(self):
        """Stable graph fingerprint for tuning-cache keys (node count and a
        hash of the op sequence with each node's params; the JAX package's
        ``graph_fingerprint``). Bound input shapes are not part of it."""
        if self._tuning_key is None:
            from .graph_pass import graph_fingerprint

            self._tuning_key = graph_fingerprint(self.symbol)
        return self._tuning_key

    def remat_mirror(self):
        """Remat decision for this graph's training walk: a tuned
        ``exec.remat`` cache entry (autotune.tune_remat) wins over the
        MXNET_BACKWARD_DO_MIRROR flag. Looked up at the program's first
        training walk and carried until the tuning cache or a tuning flag
        changes, so a steady-state step performs no lookup."""
        key = self.tuning_key()
        tuned = _REMAT_CARRY.get(key, lambda: _tuned_remat(key))
        if tuned is not None:
            return tuned
        from .config import get_flag

        return bool(get_flag("MXNET_BACKWARD_DO_MIRROR"))

    def perf_cost(self, arg_d, aux_d, train=False, grad_names=()):
        """Analytic FLOPs + HBM-bytes accounting of this program at the
        given bound tensors (observability.perf), memoized per (mode,
        shape signature, arguments that take a gradient): the walk runs
        once per shape, steady-state runs pay one dict probe. None when
        shape inference cannot cover the graph."""
        key = (bool(train), tuple([v.shape for v in arg_d.values()]),
               tuple([v.shape for v in aux_d.values()]), tuple(grad_names))
        with self._lock:
            if key in self._perf_costs:
                return self._perf_costs[key]
        from .observability import perf as _perf

        var_shapes = {n: tuple(v.shape) for n, v in arg_d.items()}
        var_shapes.update((n, tuple(v.shape)) for n, v in aux_d.items())
        # the byte rule's dtype = the widest bound tensor's (bf16 params ->
        # 2-byte traffic; fp32 -> 4); the compute dtype is the
        # contractions' (perf.bound_cost)
        db = 4
        if arg_d:
            db = max(arg_d.values(), key=lambda v: v.numel()).element_size()
        names = self.symbol.list_outputs()
        graph = names[0] if names else "program"
        cost = _perf.program_cost(
            self.symbol, self.topo, var_shapes,
            dtype_bytes=db, train=train,
            graph="%s/%dn" % (graph, len(self.topo)))
        dtypes = {n: dtype_name(v.dtype) for n, v in arg_d.items()}
        dtypes.update((n, dtype_name(v.dtype)) for n, v in aux_d.items())
        cost = _perf.bound_cost(cost, self.symbol, self.topo, grad_names,
                                dtypes)
        with self._lock:
            self._perf_costs[key] = cost
        return cost

    def _resolve_init_attrs(self, arg_d):
        """{id(node): attrs with the inferred shape} for the deferred
        creation nodes, memoized per argument-shape signature."""
        shapes = {n: tuple(arg_d[n].shape) for n in self.arg_names
                  if n in arg_d}
        key = tuple(sorted(shapes.items()))
        with self._lock:
            cached = self._init_attrs.get(key)
        if cached is not None:
            return cached
        internals = self.symbol.get_internals()
        try:
            _, out_shapes, _ = internals.infer_shape_partial(**shapes)
        except MXNetError:
            out_shapes = [None] * len(internals._outputs)
        by_id = {id(node): s for (node, idx), s in
                 zip(internals._outputs, out_shapes) if idx == 0}
        cached = {}
        for node in self._deferred_init:
            shape = by_id.get(id(node))
            if shape is None or 0 in shape:
                raise MXNetError(
                    "cannot infer shape for %s node %r with declared shape "
                    "%s" % (node.op, node.name,
                            node.parsed_attrs().get("shape")))
            attrs = node.parsed_attrs()
            cached[id(node)] = OpAttrs(dict(attrs._d, shape=tuple(shape)))
        with self._lock:
            self._init_attrs[key] = cached
        return cached

    def topo_for(self, sel):
        """(topo subset, output entries) for a selection of output indices:
        the walk pruned to what those outputs need. Memoized."""
        if sel is None:
            return self.topo, self.symbol._outputs
        key = tuple(sel)
        with self._lock:
            cached = self._sel_topo.get(key)
        if cached is not None:
            return cached
        entries = [self.symbol._outputs[i] for i in key]
        reachable = set()
        stack = [n for n, _ in entries]
        while stack:
            node = stack.pop()
            if id(node) in reachable:
                continue
            reachable.add(id(node))
            stack.extend(src for src, _ in node.inputs)
        cached = ([n for n in self.topo if id(n) in reachable], entries)
        with self._lock:
            self._sel_topo[key] = cached
        return cached

    def _eval(self, arg_d, aux_d, is_train=False, sel=None, callback=None):
        """Walk the graph once; returns (outputs, {aux name: new value}).
        The walk runs in the scope of the bound arrays' device, so an op
        without inputs (``_zeros``) creates its tensor beside them. With
        ``callback``, ``callback(entry name, tensor)`` fires for every
        node output as it is computed."""
        first = next(iter(arg_d.values()), None)
        scope = contextlib.nullcontext()
        if first is not None and first.device.type in ("cpu", "cuda"):
            scope = Context.from_device(first.device)
        with scope:
            return self._walk(arg_d, aux_d, is_train, sel, callback)

    def _walk(self, arg_d, aux_d, is_train, sel, callback=None):
        env = {}
        aux_updates = {}
        topo, out_entries = self.topo_for(sel)
        init_attrs = (self._resolve_init_attrs(arg_d)
                      if self._deferred_init else {})

        def get_entry(e):
            n, i = e
            if n.is_variable:
                return arg_d[n.name] if n.name in arg_d else aux_d[n.name]
            return env[(id(n), i)]

        for node in topo:
            n_main = node.num_main_inputs()
            outs, new_aux = node.opdef().apply(
                init_attrs.get(id(node)) or node.parsed_attrs(),
                [get_entry(e) for e in node.inputs[:n_main]],
                [get_entry(e) for e in node.inputs[n_main:]],
                is_train=is_train)
            for i, o in enumerate(outs):
                env[(id(node), i)] = o
                if callback is not None:
                    # <node>_output entry naming (symbol list_outputs)
                    callback(node.name + "_output" if len(outs) == 1
                             else "%s_output%d" % (node.name, i), o)
            for (src, _), nv in zip(node.inputs[n_main:], new_aux):
                if src.is_variable:
                    aux_updates[src.name] = nv
        return tuple(get_entry(e) for e in out_entries), aux_updates

    def infer_fn(self, sel=None):
        """The inference forward: ``f(arg_d, aux_d) -> outputs``."""

        def f(arg_d, aux_d):
            with torch.inference_mode():
                return self._eval(arg_d, aux_d, False, sel=sel)[0]

        return f

    def train_walk(self, arg_d, aux_d, grad_names, callback=None):
        """The training forward under autograd: (outputs, aux updates,
        {name: leaf}) where each name in ``grad_names`` enters the walk
        as a leaf that requires grad (sharing its argument's storage).
        When mirroring (:meth:`remat_mirror`: a tuned ``exec.remat`` entry,
        else ``MXNET_BACKWARD_DO_MIRROR``) the backward recomputes the walk
        (:func:`_maybe_mirror`); a ``callback`` (the monitor) sees the
        first walk only."""
        leaves = {n: arg_d[n].detach().requires_grad_(True)
                  for n in grad_names}
        merged = dict(arg_d)
        merged.update(leaves)
        with torch.enable_grad():
            if callback is not None:
                outs, aux_upd = self._eval(merged, aux_d, True,
                                           callback=callback)
            else:
                outs, aux_upd = _maybe_mirror(
                    self._eval, self.random, self.remat_mirror())(
                    merged, aux_d, True)
        return outs, aux_upd, leaves


_obs_modules = None


def _observability():
    """(profiler, metrics, perf), imported once: a per-run import costs
    ~1 µs each on the measured path."""
    global _obs_modules
    if _obs_modules is None:
        from . import profiler
        from .observability import metrics, perf

        _obs_modules = (profiler, metrics, perf)
    return _obs_modules


def _maybe_mirror(fn, random=False, mirror=None):
    """``fn`` under ``torch.utils.checkpoint`` when mirroring is on:
    the backward recomputes the forward instead of reading stored
    activations, the reference's memory mirroring as the JAX package's
    ``jax.checkpoint``. ``mirror=None`` reads ``MXNET_BACKWARD_DO_MIRROR``;
    a caller with a tuned per-graph decision
    (``_GraphProgram.remat_mirror``) passes it. The aux updates are those
    of the first forward; the recompute's are dropped.

    A walk with a random op (``random``) must draw the same bits in its
    recompute: torch replays the cards' default generators and the host
    generator of mx.random is rewound here. Inside a CUDA graph capture a
    card's generator can be neither read nor rewound (a recompute there
    would draw other bits), so such a walk is not mirrored while
    capturing: it keeps its activations."""
    if mirror is None:
        from .config import get_flag

        mirror = get_flag("MXNET_BACKWARD_DO_MIRROR")
    if not mirror:
        return fn
    from torch.utils.checkpoint import checkpoint

    if not random:
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        preserve_rng_state=False)

    from . import random as _random

    def mirrored(*args):
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            return fn(*args)
        host = _random.generator("cpu")
        start = host.get_state()
        calls = []

        def replayable(*a):
            if calls:
                after = host.get_state()
                host.set_state(start)
                try:
                    return fn(*a)
                finally:
                    host.set_state(after)
            calls.append(1)
            return fn(*a)

        return checkpoint(replayable, *args, use_reentrant=False,
                          preserve_rng_state=True)

    return mirrored


def _grads_of(outs, leaves, seeds):
    """{name: d(outs . seeds)/d leaf}; zeros where a leaf does not reach
    the outputs."""
    pairs = [(o, g) for o, g in zip(outs, seeds) if o.requires_grad]
    names = list(leaves)
    grads = [None] * len(names)
    if pairs and names:
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    [leaves[n] for n in names],
                                    [g for _, g in pairs],
                                    allow_unused=True)
    return {n: (g if g is not None else torch.zeros_like(leaves[n]))
            for n, g in zip(names, grads)}


class Executor:
    """A symbol bound to arrays on one device.

    ``forward(is_train=True)`` walks the graph under autograd and keeps the
    recorded walk; ``backward()`` differentiates it and applies the
    gradients to ``grad_dict`` per ``grad_req`` (write / add / null), in
    place. A second ``backward()`` without a new forward re-applies the
    same gradients; ``backward(out_grads)`` uses the given head gradients
    (re-walking the forward when the recorded walk was already used)."""

    def __init__(self, symbol, ctx, args, args_grad, grad_req, aux_states,
                 shared_exec=None, group2ctx=None, frozen_params=None):
        if group2ctx:
            raise MXNetError("model-parallel binds (group2ctx) are not yet "
                             "ported (ROADMAP.md Queue A13)")
        self._symbol = symbol
        self._ctx = as_device(ctx)
        self.arg_dict = dict(args)
        self.grad_dict = dict(args_grad or {})
        self.grad_req = dict(grad_req)
        self.aux_dict = dict(aux_states or {})
        self._output_names = symbol.list_outputs()
        self._orig_arg_names = symbol.list_arguments()
        self._orig_aux_names = symbol.list_auxiliary_states()
        self._out_sel = None
        self._param_version = 0
        self._fold_vals = {}
        self._fold_version = -1
        if shared_exec is not None and shared_exec._symbol is symbol:
            # a re-bind for new shapes keeps the bind-time pass results
            self._prog = shared_exec._prog
            self._opt = shared_exec._opt
            self._train_prog = shared_exec._train_prog
        else:
            self._opt = self._run_graph_passes(symbol, frozen_params)
            self._prog = (_GraphProgram(self._opt.symbol,
                                        tuning_key=self._opt.graph_key)
                          if self._opt is not None
                          else _GraphProgram(symbol))
            # inference-only rewrites (pruned loss heads, folded BN) must
            # not leak into forward(is_train=True): that walk gets a
            # program over the original graph, built when first asked for
            self._train_prog = (self._prog if self._opt is None
                                or self._opt.for_training else None)
        folds = self._opt.fold_exprs if self._opt is not None else ()
        self._fold_names = frozenset(name for name, _e, _d in folds)
        self._fold_inputs = frozenset(d for _n, _e, deps in folds
                                      for d in deps)
        self._arg_names = [n for n in self._prog.arg_names
                           if n not in self._fold_names]
        missing = [n for n in self._arg_names
                   if n not in self.arg_dict and n not in self.aux_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        self.outputs = []
        self._recorded = None   # (outputs, leaves) of the last train walk
        self._stashed_grads = None
        # a re-bind (reshape, a bucket switch) keeps the monitor armed:
        # calibration feeds batches of any size through Module.forward
        self._monitor_callback = (shared_exec._monitor_callback
                                  if shared_exec is not None else None)
        self._perf_run = None   # a measured train run awaiting backward
        self._perf_cost = {}    # is_train -> the program's cost
        self._health_steps = 0

    def _run_graph_passes(self, symbol, frozen_params):
        """The bind-time pass pipeline, run with ``for_training`` set when
        any argument takes a gradient; None when nothing changed."""
        from . import graph_pass

        cfg = graph_pass.PassConfig()
        if not cfg.enabled:
            return None
        inference = not any(req != "null" for req in self.grad_req.values())
        frozen = set(frozen_params or ())
        if inference:
            frozen.update(self.aux_dict)
        shapes = {n: tuple(v.shape) for n, v in self.arg_dict.items()}
        shapes.update((n, tuple(v.shape)) for n, v in self.aux_dict.items())
        dtypes = {n: dtype_name(v._data.dtype)
                  for n, v in self.arg_dict.items()}
        dtypes.update((n, dtype_name(v._data.dtype))
                      for n, v in self.aux_dict.items())
        return graph_pass.optimize_for_bind(
            symbol, for_training=not inference, frozen=frozen,
            arg_shapes=shapes, arg_dtypes=dtypes, config=cfg)

    # --- array views (the original symbol's argument order) ---------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._orig_arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._orig_arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._orig_aux_names]

    @property
    def output_dict(self):
        return dict(zip(self.current_output_names, self.outputs))

    @property
    def current_output_names(self):
        if self._out_sel is None:
            return self._output_names
        return [self._output_names[i] for i in self._out_sel]

    def select_outputs(self, outputs):
        """Restrict inference forwards to a subset of the heads (names or
        indices; None restores all); training forwards ignore it."""
        self._out_sel = None if outputs is None else tuple(
            resolve_output_indices(self._output_names, outputs))

    # --- execution ----------------------------------------------------------
    def _train_program(self):
        if self._train_prog is None:
            self._train_prog = _GraphProgram(self._symbol)
        return self._train_prog

    def _folded(self):
        if self._opt is None or not self._opt.fold_exprs:
            return {}
        if self._fold_version != self._param_version:
            values = {}
            for n in self._fold_inputs:
                arr = self.arg_dict.get(n)
                values[n] = (arr if arr is not None
                             else self.aux_dict[n])._data
            with torch.no_grad():
                self._fold_vals = self._opt.fold(values)
            self._fold_version = self._param_version
        return self._fold_vals

    def _feeds(self, prog):
        """(arg tensors, aux tensors) a walk of ``prog`` reads."""
        folded = self._folded() if prog is self._prog else {}
        arg_d = {}
        for n in prog.arg_names:
            if n in folded:
                arg_d[n] = folded[n]
                continue
            arr = self.arg_dict.get(n)
            arg_d[n] = (arr if arr is not None else self.aux_dict[n])._data
        aux_d = {n: self.aux_dict[n]._data for n in prog.aux_names}
        return arg_d, aux_d

    def _grad_names(self, prog):
        return tuple(n for n in prog.arg_names
                     if self.grad_req.get(n, "null") != "null")

    def forward(self, is_train=False, **kwargs):
        """Run the forward; in train mode keep the walk for backward()."""
        from .ndarray.ndarray import _from_data

        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %r in forward" % k)
            if tuple(self.arg_dict[k].shape) != tuple(v.shape):
                self._perf_cost.clear()
            self.arg_dict[k]._set_data(v._data)
            if k in self._fold_inputs:
                self._param_version += 1
        self._recorded = None
        self._stashed_grads = None
        self._perf_run = None
        timing = self._timing_start(is_train)
        spy = self._spy()
        if not is_train and spy is not None:
            # the spy pass walks the whole graph; the output selection
            # applies on the way out
            arg_d, aux_d = self._feeds(self._prog)
            with torch.inference_mode():
                outs, _ = self._prog._eval(arg_d, aux_d, False,
                                           callback=spy)
            if self._out_sel is not None:
                outs = [outs[i] for i in self._out_sel]
        elif not is_train:
            arg_d, aux_d = self._feeds(self._prog)
            outs = self._prog.infer_fn(self._out_sel)(arg_d, aux_d)
        else:
            prog = self._train_program()
            arg_d, aux_d = self._feeds(prog)
            outs, aux_upd, leaves = prog.train_walk(
                arg_d, aux_d, self._grad_names(prog), callback=spy)
            for n, nv in aux_upd.items():
                self.aux_dict[n]._set_data(nv.detach())
            self._recorded = (outs, leaves)
        self.outputs = [_from_data(o.detach()) for o in outs]
        if timing is not None:
            if is_train:
                # the program ends with its backward's last launch
                self._perf_run = timing
            else:
                self._timing_end(timing)
        return self.outputs

    # --- observability ----------------------------------------------------
    def _timing_start(self, is_train):
        """(is_train, host t0, start event or None) when this run is
        measured: inside a perf step scope, a profiler session or under
        telemetry; else None."""
        _profiler, _metrics, _perf = _observability()
        if not (_perf.step_active() or _profiler.symbolic_active()
                or _metrics.enabled()):
            return None
        events = None
        if self._ctx.type == "cuda" and _perf.step_active():
            index = self._ctx.index
            stream = _perf.current_stream(
                torch.cuda.current_device() if index is None else index)
            events = _perf.event_pair() + (stream,)
            _perf.record(events[0], stream)
        return is_train, time.perf_counter(), events

    def _timing_end(self, timing):
        """Close a measured run after its last launch: the profiler's
        program event, the telemetry counters, and the perf note (CUDA
        events read at the step's end; on the CPU the walk's wall, since
        there the walk is the program)."""
        _profiler, _metrics, _perf = _observability()
        is_train, t0, events = timing
        t1 = time.perf_counter()
        if _profiler.symbolic_active():
            _profiler.record("forward_backward" if is_train else "forward",
                             "executor", (t0 - _profiler._t0) * 1e6,
                             (t1 - t0) * 1e6)
        if _metrics.enabled():
            _metrics.counter("dispatch.graph").inc()
            _metrics.histogram("executor.run_ms").observe((t1 - t0) * 1e3)
        if not _perf.step_active():
            return
        cost = self.perf_program_cost(is_train)
        if events is not None:
            _perf.record(events[1], events[2])
            _perf.note_program_events(cost, events[0], events[1], t1 - t0)
        else:
            _perf.note_program_run(cost, device_s=t1 - t0, host_s=0.0,
                                   card=self._ctx.type == "cuda")

    def perf_program_cost(self, is_train=False):
        """Analytic cost of the program a forward(is_train=...) on this
        executor runs, at its bound shapes: memoized on the program per
        shape signature, and held here per mode once probed (a bound
        executor's shapes are fixed; ``reshape`` binds a new one)."""
        cost = self._perf_cost.get(is_train)
        if cost is None:
            prog = self._train_program() if is_train else self._prog
            arg_d, aux_d = self._feeds(prog)
            cost = self._perf_cost[is_train] = prog.perf_cost(
                arg_d, aux_d, train=is_train,
                grad_names=self._grad_names(prog) if is_train else ())
        return cost

    def named_health_arrays(self):
        """``(kind, name, NDArray)`` triples for the health layer: every
        output and every gradient buffer this executor exposes."""
        out = [("loss", name, o)
               for name, o in zip(self.current_output_names, self.outputs)]
        out.extend(("grad", name, g)
                   for name, g in sorted(self.grad_dict.items())
                   if g is not None)
        return out

    def health_check(self, wall_s=None):
        """Non-finite check over this executor's outputs and grads
        (observability.health.guard_step) — the wiring point for code
        that drives executors directly rather than through Module.fit.
        Returns the Verdict, or None when MXNET_HEALTH is off."""
        from .observability import health

        if not health.active():
            return None
        named = self.named_health_arrays()
        self._health_steps += 1
        return health.guard_step(
            "executor",
            losses=[(n, a) for k, n, a in named if k == "loss"],
            grads=[(n, a) for k, n, a in named if k == "grad"],
            params=[(n, a) for n, a in sorted(self.arg_dict.items())
                    if n in self.grad_dict],
            step=self._health_steps, wall_s=wall_s, can_skip=False,
            sync=True)  # one-shot diagnostic: the caller wants THIS step

    def backward(self, out_grads=None, is_train=True):
        """Apply the gradients into ``grad_dict`` per ``grad_req``."""
        seeds = None
        if out_grads is not None:
            from .ndarray.ndarray import NDArray

            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            seeds = [g._data for g in out_grads]
        if self._recorded is not None:
            outs, leaves = self._recorded
            self._recorded = None
            grads = _grads_of(outs, leaves, seeds or [
                torch.ones_like(o) for o in outs])
            if seeds is None:
                self._stashed_grads = grads
        elif seeds is not None:
            prog = self._train_program()
            arg_d, aux_d = self._feeds(prog)
            outs, _aux, leaves = prog.train_walk(arg_d, aux_d,
                                                 self._grad_names(prog))
            grads = _grads_of(outs, leaves, seeds)
        elif self._stashed_grads is not None:
            grads = self._stashed_grads
        else:
            raise MXNetError("backward() called without a prior "
                             "forward(is_train=True)")
        with torch.no_grad():
            for n, g in grads.items():
                req = self.grad_req.get(n, "null")
                garr = self.grad_dict.get(n)
                if req == "null" or garr is None:
                    continue
                if req == "add":
                    garr._data.add_(g.to(garr._data.dtype))
                else:
                    garr._data.copy_(g)
        if self._perf_run is not None:
            timing, self._perf_run = self._perf_run, None
            self._timing_end(timing)
        return [self.grad_dict.get(n) for n in self._arg_names]

    # --- utilities --------------------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, array in arg_params.items():
            if name in self.arg_dict:
                array.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise ValueError("Find name \"%s\" that is not in the "
                                 "arguments" % name)
        for name, array in (aux_params or {}).items():
            if name in self.aux_dict:
                array.copyto(self.aux_dict[name])
            elif not allow_extra_params:
                raise ValueError("Find name \"%s\" that is not in the "
                                 "auxiliary states" % name)
        # the fold constants are functions of the parameters just replaced
        self._param_version += 1

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor bound to new input shapes; arrays whose shape is
        unchanged are shared, and so is the bind-time pass result."""
        from . import ndarray as nd

        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args, new_grads = {}, {}
        for name, shape in zip(self._orig_arg_names, arg_shapes):
            old = self.arg_dict[name]
            if tuple(old.shape) == tuple(shape):
                new_args[name] = old
                if name in self.grad_dict:
                    new_grads[name] = self.grad_dict[name]
            else:
                new_args[name] = nd.zeros(shape, ctx=self._ctx,
                                          dtype=old._data.dtype)
                if name in self.grad_dict:
                    new_grads[name] = nd.zeros(shape, ctx=self._ctx,
                                               dtype=old._data.dtype)
        new_aux = {}
        for name, shape in zip(self._orig_aux_names, aux_shapes):
            old = self.aux_dict[name]
            new_aux[name] = old if tuple(old.shape) == tuple(shape) else \
                nd.zeros(shape, ctx=self._ctx, dtype=old._data.dtype)
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self.grad_req, new_aux, shared_exec=self)

    def _spy(self):
        """The walk's callback for the installed monitor, or None: each
        node output reaches the monitor as a detached NDArray."""
        cb = self._monitor_callback
        if cb is None:
            return None
        from .ndarray.ndarray import _from_data

        return lambda name, value: cb(name, _from_data(value.detach()))

    def set_monitor_callback(self, callback, use_jit=False):
        """Install (None removes) a per-node monitor: every later forward
        calls ``callback(name, NDArray)`` for each node output, under the
        ``<node>_output`` names (``<node>_output<i>`` for a node of
        several outputs), in walk order (reference:
        MXExecutorSetMonitorCallback). ``use_jit`` is accepted for the JAX
        package's signature and means nothing here: that package can run
        the monitored forward as one compiled program, while this walk is
        always the eager one."""
        del use_jit
        self._monitor_callback = callback

    def fused_regions(self):
        """``[{name, base_op, members}]`` for each ``_FusedRegion`` of the
        bound program (the fuse pass's regions)."""
        import json

        out = []
        for node in self._prog.topo:
            if node.op != "_FusedRegion":
                continue
            out.append({"name": node.name,
                        "base_op": node.parsed_attrs().base_op,
                        "members": json.loads(node.user_attrs.get(
                            "__fused_members__", "[]"))})
        return out

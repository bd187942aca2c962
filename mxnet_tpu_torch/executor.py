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

Not ported: the monitor callback, model-parallel ``group2ctx`` binds and
the health/perf hooks (``ROADMAP.md`` Queue A13); asking for them raises.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError, dtype_name
from .context import Context, as_device
from .ops.registry import OpAttrs

__all__ = ["Executor", "resolve_output_indices"]


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

    def __init__(self, symbol):
        self.symbol = symbol
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
        self._lock = threading.Lock()

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

    def _eval(self, arg_d, aux_d, is_train=False, sel=None):
        """Walk the graph once; returns (outputs, {aux name: new value}).
        The walk runs in the scope of the bound arrays' device, so an op
        without inputs (``_zeros``) creates its tensor beside them."""
        first = next(iter(arg_d.values()), None)
        scope = contextlib.nullcontext()
        if first is not None and first.device.type in ("cpu", "cuda"):
            scope = Context.from_device(first.device)
        with scope:
            return self._walk(arg_d, aux_d, is_train, sel)

    def _walk(self, arg_d, aux_d, is_train, sel):
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

    def train_walk(self, arg_d, aux_d, grad_names):
        """The training forward under autograd: (outputs, aux updates,
        {name: leaf}) where each name in ``grad_names`` enters the walk
        as a leaf that requires grad (sharing its argument's storage).
        Under ``MXNET_BACKWARD_DO_MIRROR`` the backward recomputes the
        walk (:func:`_maybe_mirror`)."""
        leaves = {n: arg_d[n].detach().requires_grad_(True)
                  for n in grad_names}
        merged = dict(arg_d)
        merged.update(leaves)
        with torch.enable_grad():
            outs, aux_upd = _maybe_mirror(self._eval, self.random)(
                merged, aux_d, True)
        return outs, aux_upd, leaves


def _maybe_mirror(fn, random=False):
    """``fn`` under ``torch.utils.checkpoint`` when
    ``MXNET_BACKWARD_DO_MIRROR`` is set: the backward recomputes the
    forward instead of reading stored activations, the reference's memory
    mirroring as the JAX package's ``jax.checkpoint``. The aux updates are
    those of the first forward; the recompute's are dropped.

    A walk with a random op (``random``) must draw the same bits in its
    recompute: torch replays the cards' default generators and the host
    generator of mx.random is rewound here. Inside a CUDA graph capture a
    card's generator can be neither read nor rewound (a recompute there
    would draw other bits), so such a walk is not mirrored while
    capturing: it keeps its activations."""
    from .config import get_flag

    if not get_flag("MXNET_BACKWARD_DO_MIRROR"):
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
            self._prog = _GraphProgram(self._opt.symbol
                                       if self._opt is not None else symbol)
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
            self.arg_dict[k]._set_data(v._data)
            if k in self._fold_inputs:
                self._param_version += 1
        self._recorded = None
        self._stashed_grads = None
        if not is_train:
            arg_d, aux_d = self._feeds(self._prog)
            outs = self._prog.infer_fn(self._out_sel)(arg_d, aux_d)
        else:
            prog = self._train_program()
            arg_d, aux_d = self._feeds(prog)
            outs, aux_upd, leaves = prog.train_walk(
                arg_d, aux_d, self._grad_names(prog))
            for n, nv in aux_upd.items():
                self.aux_dict[n]._set_data(nv.detach())
            self._recorded = (outs, leaves)
        self.outputs = [_from_data(o.detach()) for o in outs]
        return self.outputs

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

    def set_monitor_callback(self, callback, use_jit=False):
        raise MXNetError("executor monitor callbacks are not yet ported "
                         "(ROADMAP.md Queue A13)")

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

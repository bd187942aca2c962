"""High-throughput inference serving on top of the symbolic executor.

Counterpart of ``mxnet_tpu/serving/engine.py`` ``InferenceServer``:

* **Shape-bucketed program cache.** Every request is padded up to a small
  ladder of batch buckets (:mod:`.buckets`). On the card each (replica,
  bucket) program is ONE CUDA graph of the whole forward, captured at its
  first use (or by ``warmup()``) and replayed for every batch that lands
  in that bucket, so the program count is ``len(buckets) * n_replicas`` —
  bounded by configuration, never by traffic — and a batch costs the host
  one replay instead of a walk of the graph's nodes. On the CPU the
  program is the eager walk of the same graph. Outputs are sliced back to
  each request's true row count before delivery.
* **Dynamic micro-batching.** An admission queue coalesces concurrent
  requests into the largest bucket available within
  ``MXNET_SERVING_MAX_WAIT_MS``; a full bucket flushes at once. The queue
  is bounded (``MXNET_SERVING_QUEUE`` rows) with ``block`` or ``reject``
  backpressure. Batching never reorders requests (FIFO admission, FIFO
  completion).
* **Pipelined dispatch.** The dispatcher keeps up to
  ``MXNET_SERVING_PIPELINE`` batches in flight
  (:class:`~..runtime.staging.PipelineWindow`): batch N+1 is staged
  (:func:`~..runtime.staging.stage_pytree`, pinned and asynchronous) and
  replayed while batch N runs, and the oldest batch's host fetch drains
  the window.
* **Replicas and the circuit breaker.** Replicas are append-only slots,
  each with its own parameters, CUDA stream, graph memory pool and bucket
  graphs; several may share one card. Dispatch is round-robin over the
  active, unquarantined slots. A replica whose dispatch or fetch faults
  is quarantined for ``MXNET_SERVING_COOLDOWN_MS``, the batch retries
  once on a survivor, and a probe replay of the smallest bucket re-admits
  the replica after the cooldown. ``resize_replicas`` changes the active
  set live (the autoscaler's actuator).
* **Observability.** One request trace per request (queue, batch,
  compute and fetch events), the ``serving.*`` metrics, a "serving"
  flight-recorder provider and ``get_stats()`` in the shared engine-stats
  schema.

Three rules keep the graphs sound. A graph writes its outputs into the
same buffers on every replay, and one replica's bucket graphs share one
memory pool, so each replay is followed on the replica's stream by a
clone of its outputs into fresh tensors and an event the fetch waits on:
a later replay never overwrites outputs that are still in the window.
Every capture, replay and release of one server runs under one lock,
and captures run in ``thread_local`` mode, so a capture sees no other
CUDA work of this server and does not trip over another thread's. A
capture that fails raises (from ``warmup()`` or into the batch's
futures): the server never walks the graph eagerly on a card.

``quantize=`` (a :class:`~..graph_pass.CalibrationTable`, its JSON path,
or True for the ambient table) binds the int8 rewrite: int8 weights per
replica, exact int32 contractions inside each bucket's CUDA graph. A
``quantize=`` that resolves no table raises. Left for later: replicas on
more than one card (ROADMAP A10).
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import logging
import threading
import time
import weakref

import numpy as np
import torch

from .. import cuda_graph
from ..base import MXNetError, dtype_name, torch_dtype
from ..context import as_device
from ..convert import tensor_from_array
from ..executor import _GraphProgram
from ..observability import metrics
from ..observability import request_trace as _rtrace
from ..observability import stats_schema as _schema
from ..resilience import DeadlineExceeded
from ..resilience import faults as _faults
from ..runtime.staging import PipelineWindow, stage_pytree
from .buckets import parse_buckets, pick_bucket

__all__ = ["ServingConfig", "InferenceServer", "QueueFullError",
           "ServerClosedError", "DeadlineExceeded"]

# fires on the host before one replica's bucket dispatch (before the
# replay, never inside a captured body), tagged with the replica index so
# a spec can fault exactly one replica (serving.replica_execute[1]:...)
_faults.declare("serving.replica_execute",
                doc="before one replica's bucket dispatch — a raise here "
                    "quarantines the replica and retries the batch once "
                    "on a surviving one")


class QueueFullError(MXNetError):
    """``submit`` under ``backpressure='reject'`` found no room for the
    request's rows."""


class ServerClosedError(MXNetError):
    """``submit`` after ``stop()``, or a request aborted by a non-draining
    shutdown."""


class ServingConfig:
    """Knobs of :class:`InferenceServer`; defaults come from the
    ``MXNET_SERVING_*`` environment."""

    def __init__(self, buckets=None, max_wait_ms=None, max_queue_rows=None,
                 backpressure=None, pipeline_depth=None, deadline_ms=None,
                 cooldown_ms=None):
        import os

        from ..config import get_flag

        self.buckets = parse_buckets(buckets)
        self.max_wait_ms = (get_flag("MXNET_SERVING_MAX_WAIT_MS")
                            if max_wait_ms is None else float(max_wait_ms))
        self.max_queue_rows = (get_flag("MXNET_SERVING_QUEUE")
                               if max_queue_rows is None
                               else int(max_queue_rows))
        self.backpressure = (backpressure if backpressure is not None
                             else os.environ.get("MXNET_SERVING_BACKPRESSURE",
                                                 "block"))
        self.pipeline_depth = (get_flag("MXNET_SERVING_PIPELINE")
                               if pipeline_depth is None
                               else int(pipeline_depth))
        # 0 = none; > 0 = a request still queued this many ms after submit
        # fails with DeadlineExceeded before dispatch
        self.deadline_ms = (get_flag("MXNET_SERVING_DEADLINE_MS")
                            if deadline_ms is None else float(deadline_ms))
        # circuit-breaker cooldown before a faulted replica is probed
        self.cooldown_ms = (get_flag("MXNET_SERVING_COOLDOWN_MS")
                            if cooldown_ms is None else float(cooldown_ms))
        if self.backpressure not in ("block", "reject"):
            raise ValueError("backpressure must be 'block' or 'reject', "
                             "got %r" % (self.backpressure,))
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0 (0 disables)")
        if self.cooldown_ms <= 0:
            raise ValueError("cooldown_ms must be > 0")
        if self.max_queue_rows < self.buckets[-1]:
            raise ValueError(
                "max_queue_rows (%d) must fit at least one largest bucket "
                "(%d)" % (self.max_queue_rows, self.buckets[-1]))
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")


class _Assembly:
    """Routes one submitted request's parts back to its future (oversize
    requests are chunked at admission, one part per chunk). One request
    trace per request: the parts of a chunked one append to it."""

    __slots__ = ("future", "parts", "remaining", "squeeze", "lock",
                 "trace")

    def __init__(self, future, n_parts, squeeze, trace=_rtrace.NOOP_TRACE):
        self.future = future
        self.parts = [None] * n_parts
        self.remaining = n_parts
        self.squeeze = squeeze
        self.lock = threading.Lock()
        self.trace = trace

    def deliver(self, idx, pieces):
        """``pieces``: one host array per output. True when this delivery
        completed the request."""
        with self.lock:
            self.parts[idx] = pieces
            self.remaining -= 1
            if self.remaining:
                return False
        outs = [np.concatenate([p[i] for p in self.parts])
                if len(self.parts) > 1 else self.parts[0][i]
                for i in range(len(self.parts[0]))]
        if self.squeeze:
            outs = [o[0] for o in outs]
        try:
            self.future.set_result(outs[0] if len(outs) == 1 else outs)
        except concurrent.futures.InvalidStateError:
            self.trace.finish("cancelled")   # cancelled by the caller
            return False
        self.trace.finish("ok")
        return True

    def fail(self, err, status="error"):
        try:
            if not self.future.done():
                self.future.set_exception(err)
        except concurrent.futures.InvalidStateError:
            pass  # cancelled between the check and the set
        self.trace.finish(status)


class _Request:
    """One admission-queue entry (a request, or one chunk of one)."""

    __slots__ = ("arrays", "n", "assembly", "part", "t_submit", "deadline")

    def __init__(self, arrays, n, assembly, part, t_submit, deadline):
        self.arrays = arrays
        self.n = n
        self.assembly = assembly
        self.part = part
        self.t_submit = t_submit
        self.deadline = deadline


# ``batch`` keeps the padded host arrays so a fetch-side fault can
# re-execute the batch on a surviving replica; ``retried`` caps the
# failover at one re-execution; ``ready`` is the event the fetch waits on
# (None on the CPU)
_InFlight = collections.namedtuple(
    "_InFlight", ["outs", "ready", "reqs", "bucket", "rows", "replica",
                  "batch", "retried"])

# every live server, GC-pruned — walked by ONE "serving" flight-recorder
# provider so a dump carries queue and in-flight state
_live_servers = weakref.WeakSet()

# gauges owned by a server: deleted from the registry when the owner
# stops or is collected, so /metrics never shows a dead server's values
_SERVER_GAUGES = ("serving.queue_depth", "serving.replicas_configured",
                  "serving.replicas_available")


def _servers_state():
    views = []
    for srv in list(_live_servers):
        try:
            views.append(srv.get_stats())
        except Exception as err:
            views.append({"error": repr(err)})
    if not views:
        return None
    return views[0] if len(views) == 1 else {"servers": views}


def _np_dtype(name):
    """numpy dtype of a dtype name, or None where numpy has none
    (bfloat16: such inputs are cast on the device)."""
    try:
        return np.dtype(name)
    except TypeError:
        return None


def _to_host(t):
    # numpy has no bfloat16: such outputs come back widened to float32
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _fetch(outs, ready):
    """Host copies of one batch's outputs, after its event."""
    if ready is not None:
        ready.synchronize()
    return [_to_host(o) for o in outs]


class _BucketGraph:
    """One (replica, bucket) program on a card: the forward captured as a
    CUDA graph over static input buffers, replayed per batch."""

    def __init__(self, forward, args, aux, data_names, shapes, dtypes,
                 device, pool):
        # the body reads these buffers on every replay: new batches are
        # copied into them, the graph never sees a host value
        self.inputs = [torch.zeros(s, dtype=d, device=device)
                       for s, d in zip(shapes, dtypes)]
        # the graph reads every tensor of the feed by address: it holds
        # them (parameters, zero-filled extras, aux) as long as it lives
        self.feed = dict(args)
        self.feed.update(zip(data_names, self.inputs))
        self.aux = aux
        self.graph, outs = cuda_graph.capture(
            lambda: forward(self.feed, self.aux), device, pool=pool,
            capture_error_mode="thread_local")
        self.outs = list(outs)

    def run(self, staged, stream):
        """Copy ``staged`` in, replay, and clone the outputs into fresh
        tensors, all on ``stream`` (the caller's current one); returns
        (outputs, the event after the clones)."""
        for buf, x in zip(self.inputs, staged):
            buf.copy_(x)
        self.graph.replay()
        outs = [o.clone() for o in self.outs]
        ready = torch.cuda.Event()
        ready.record(stream)
        return outs, ready

    def release(self):
        self.graph.reset()
        self.inputs = self.outs = self.graph = self.feed = self.aux = None


class InferenceServer:
    """Micro-batching, shape-bucketing inference engine for one Symbol::

        server = serving.InferenceServer(
            sym, arg_params, aux_params,
            data_shapes=[("data", (1, 224, 224, 3))])
        server.warmup()                  # capture every (replica, bucket)
        probs = server.submit(one_image).result()
        server.stop()                    # drains in-flight requests

    ``data_shapes`` follows the Module convention: (name, shape) pairs with
    the batch axis leading (the batch entry itself is ignored). Parameters
    may be torch tensors, numpy arrays or anything with ``asnumpy()``.
    ``devices`` lists one device per replica (repeats of one device are
    legal: each is a replica of its own); the default is one replica on
    the current card, or the devices of ``mesh``
    (:func:`~..parallel.mesh.replica_devices`). The CPU serves only when
    asked for (``[mx.cpu()]``).

    Without an explicit ``config``, the bucket ladder resolves through the
    tuning cache first — a ``serving.buckets`` entry for (this device,
    this model, ``traffic_key``) — then ``MXNET_SERVING_BUCKETS``, then
    the power-of-two default.
    """

    def __init__(self, symbol, arg_params, aux_params=None, data_shapes=None,
                 devices=None, mesh=None, config=None, start=True,
                 traffic_key="default", quantize=None):
        from .. import autotune, graph_pass
        from ..observability import flight_recorder

        if data_shapes is None:
            raise ValueError("data_shapes is required: [(name, shape), ...] "
                             "with the batch axis leading")
        self._symbol = symbol
        if config is None:
            # the tuning-cache consult: a ladder tuned for this (device,
            # model, traffic shape) beats the env/default ladder; keyed by
            # the ORIGINAL graph's fingerprint
            tuned = autotune.lookup(
                "serving.buckets",
                key=(graph_pass.graph_fingerprint(symbol), traffic_key))
            if not isinstance(tuned, dict):
                tuned = {}
            try:
                config = ServingConfig(buckets=tuned.get("buckets"))
            except (ValueError, TypeError):
                # a corrupt/hand-edited entry must never take the server
                # down — tuning is an optimization
                config = ServingConfig()
        self._cfg = config
        self._data_names = [d[0] for d in data_shapes]
        self._row_shapes = [tuple(d[1][1:]) for d in data_shapes]
        unknown = [n for n in self._data_names
                   if n not in symbol.list_arguments()]
        if unknown:
            raise MXNetError("data names %s not in symbol arguments"
                             % unknown)

        if devices is None:
            if mesh is not None:
                from ..parallel.mesh import replica_devices

                devices = replica_devices(mesh)
            else:
                devices = [None]
        self._devices = [as_device(d) for d in devices]
        if not self._devices:
            raise ValueError("devices is empty: need at least one replica")
        if len(set(self._devices)) != 1:
            raise MXNetError("serving replicas on more than one device (%s)"
                             " are not yet ported (ROADMAP A10): repeat one "
                             "device for several replicas"
                             % sorted(set(map(str, self._devices))))
        dev = self._devices[0]

        args = {k: tensor_from_array(v, dev) for k, v in
                (arg_params or {}).items() if k not in self._data_names}
        aux = {k: tensor_from_array(v, dev)
               for k, v in (aux_params or {}).items()}
        self._arg_dtypes = self._infer_dtypes()

        # freeze -> fold -> specialize: every parameter enters the pass
        # pipeline frozen, and the fold constants are computed once here.
        # ``quantize=`` appends the int8 rewrite to the ambient pipeline:
        # the conv / FC / matmul islands compute on the int8 lattice and
        # the fold materializes int8 weights per replica
        feed = {n: (1,) + s for n, s in zip(self._data_names,
                                            self._row_shapes)}
        opt = graph_pass.optimize_for_bind(
            symbol, for_training=False, frozen=set(args) | set(aux),
            arg_shapes=feed,
            arg_dtypes={**{k: dtype_name(v.dtype) for k, v in aux.items()},
                        **{k: dtype_name(v.dtype) for k, v in args.items()},
                        **self._arg_dtypes},
            config=self._quantize_config(quantize))
        self._opt = opt
        opt_symbol = symbol
        if opt is not None:
            args.update(opt.fold({**aux, **args}))
            opt_symbol = opt.symbol
            # bn_fold with fold off leaves moving stats as ARGUMENTS
            opt_args = set(opt_symbol.list_arguments())
            args.update((k, v) for k, v in aux.items() if k in opt_args)
        self._opt_symbol = opt_symbol
        self._prog = _GraphProgram(opt_symbol)
        self._forward = self._prog.infer_fn()
        # the post-fold parameters the rewritten program reads, kept on
        # the host: every replica (also one added by resize_replicas)
        # gets its own device copy of them
        used_args = set(opt_symbol.list_arguments())
        used_aux = set(opt_symbol.list_auxiliary_states())
        self._host_args = {k: v.detach().to("cpu", copy=True)
                           for k, v in args.items() if k in used_args}
        self._host_aux = {k: v.detach().to("cpu", copy=True)
                          for k, v in aux.items() if k in used_aux}
        del args, aux
        self._device_pool = list(self._devices)
        # replica SLOTS are append-only (indices stay stable for in-flight
        # batches and breaker bookkeeping); membership in the round-robin
        # set is self._active, mutated live by resize_replicas
        self._replica_args = [None] * len(self._devices)
        self._replica_aux = [None] * len(self._devices)
        self._streams = [None] * len(self._devices)
        self._pools = [None] * len(self._devices)
        for i in range(len(self._devices)):
            self._place_replica(i)

        self._lock = threading.Lock()
        self._active = set(range(len(self._devices)))  # guarded-by: self._lock
        self._stats = collections.Counter()   # guarded-by: self._lock
        self._bucket_extras = {}  # (replica, bucket) -> (extras, aux)  # guarded-by: self._lock
        # circuit breaker: replica -> monotonic probe-due time
        self._quarantined = {}                # guarded-by: self._lock
        # (replica, bucket) -> its program: a _BucketGraph on a card, None
        # on the CPU (the eager walk; the key counts the first use).
        # Every capture, replay and release runs under _graph_lock.
        self._graph_lock = threading.Lock()
        self._programs = {}                   # guarded-by: self._graph_lock

        self._cond = threading.Condition()
        self._queue = collections.deque()     # guarded-by: self._cond
        self._queued_rows = 0                 # guarded-by: self._cond
        self._stop = False                    # guarded-by: self._cond
        self._abort = False                   # guarded-by: self._cond
        # dispatcher-thread-only: the bounded in-flight window and the
        # round-robin replica cursor
        self._inflight = PipelineWindow(self._cfg.pipeline_depth)
        self._rr = 0
        self._thread = None
        self._life = threading.Lock()  # serializes start()/stop()
        _live_servers.add(self)
        flight_recorder.register_provider("serving", _servers_state)
        self._update_replica_gauges()
        # a collected (not stopped) server must not leave its gauges
        # frozen at their last value
        metrics.unregister_on_collect(self, _SERVER_GAUGES)
        if start:
            self.start()

    # ------------------------------------------------------------ plumbing
    @staticmethod
    def _quantize_config(quantize):
        """The pass config of a ``quantize=`` bind (None: the ambient
        one). ``quantize`` is a CalibrationTable, its JSON path, or True
        for the ambient table; int8 was asked for, so a table that does
        not resolve raises instead of serving fp32."""
        if quantize is None:
            return None
        from .. import graph_pass
        from ..graph_pass import quantize as _quant

        cfg = graph_pass.PassConfig()
        cfg.passes = frozenset(cfg.passes | {"quantize"})
        if quantize is not True:
            cfg.quant_table = _quant.as_table(quantize)
        if _quant.resolve_table(cfg) is None:
            raise MXNetError(
                "InferenceServer(quantize=...): no calibration table "
                "resolvable: pass a CalibrationTable or its JSON path, "
                "call graph_pass.set_calibration_table(), or set "
                "MXNET_QUANT_TABLE")
        return cfg

    def _infer_dtypes(self):
        """Argument dtype names from graph type inference."""
        arg_types, _, _ = self._symbol.infer_type()
        return {n: dtype_name(t) for n, t in
                zip(self._symbol.list_arguments(), arg_types)}

    @classmethod
    def from_module(cls, module, **kwargs):
        """Serve a bound, initialized Module's symbol + parameters."""
        arg_params, aux_params = module.get_params()
        kwargs.setdefault("data_shapes",
                          [(d.name, d.shape) for d in module.data_shapes])
        return cls(module.symbol, arg_params, aux_params, **kwargs)

    @classmethod
    def from_checkpoint(cls, prefix, epoch, **kwargs):
        """Serve a ``prefix-symbol.json`` + ``prefix-NNNN.params`` pair."""
        from ..model import load_checkpoint

        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return cls(symbol, arg_params, aux_params, **kwargs)

    def _place_replica(self, i):
        """Give slot ``i`` its own parameter tensors (and, on a card, a
        stream and a graph memory pool shared by its bucket graphs)."""
        dev = self._devices[i]
        self._replica_args[i] = {k: v.to(dev, copy=True)
                                 for k, v in self._host_args.items()}
        self._replica_aux[i] = {k: v.to(dev, copy=True)
                                for k, v in self._host_aux.items()}
        if dev.type == "cuda":
            if self._streams[i] is None:
                self._streams[i] = torch.cuda.Stream(device=dev)
            self._pools[i] = torch.cuda.graph_pool_handle()

    def _device_scope(self, dev):
        if dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _bindings(self, replica, bucket):
        """(extra zero args, aux dict) for one (replica, bucket) pair,
        made once: arguments the rewritten graph still reads that are
        neither data nor params are zero-filled at their inferred shapes."""
        key = (replica, bucket)
        with self._lock:
            cached = self._bucket_extras.get(key)
        if cached is not None:
            return cached
        feed = {n: (bucket,) + s
                for n, s in zip(self._data_names, self._row_shapes)}
        arg_shapes, _, aux_shapes = self._opt_symbol.infer_shape_partial(
            **feed)
        dev = self._devices[replica]
        args = self._replica_args[replica]
        extras = {}
        for name, shape in zip(self._opt_symbol.list_arguments(),
                               arg_shapes):
            if name in self._data_names or name in args:
                continue
            if shape is None or 0 in shape:
                raise MXNetError("serving: cannot infer shape for argument "
                                 "%r (not in arg_params and not a data "
                                 "input)" % name)
            extras[name] = torch.zeros(
                shape, dtype=torch_dtype(self._arg_dtypes.get(name,
                                                              "float32")),
                device=dev)
        aux = dict(self._replica_aux[replica])
        for name, shape in zip(self._opt_symbol.list_auxiliary_states(),
                               aux_shapes):
            if name not in aux:
                if shape is None or 0 in shape:
                    raise MXNetError("serving: cannot infer shape for "
                                     "auxiliary state %r" % name)
                aux[name] = torch.zeros(shape, device=dev)
        with self._lock:
            self._bucket_extras[key] = (extras, aux)
        return extras, aux

    # ----------------------------------------------------------- lifecycle
    def start(self):
        """Launch the dispatcher thread (idempotent)."""
        with self._life:
            if self._thread is not None and self._thread.is_alive():
                return self
            with self._cond:
                self._stop = False
                self._abort = False
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            name="mxnet-serving-dispatch",
                                            daemon=True)
            self._thread.start()
        self._update_replica_gauges()  # restart after stop() re-creates
        return self

    def stop(self, drain=True, timeout=None):
        """Shut down. ``drain=True`` serves every admitted request first;
        ``drain=False`` fails queued requests with ServerClosedError
        (batches already in flight still complete). ``timeout`` (seconds)
        bounds the drain: past it every still-pending request fails with
        ServerClosedError and ``stop`` returns."""
        with self._cond:
            self._stop = True
            self._abort = not drain
            self._cond.notify_all()
        with self._life:
            thread, self._thread = self._thread, None
            if thread is not None:
                thread.join(timeout)
                if thread.is_alive():
                    self._abandon_drain(timeout)
            elif self._queue or self._inflight:
                # never started: honour the drain contract inline
                self._dispatch_loop()
        for name in _SERVER_GAUGES:
            metrics.unregister(name)
        return self

    def _abandon_drain(self, timeout):
        """Drain timed out: fail everything still pending so callers
        unblock, and leave the (daemon) dispatcher to die on its own."""
        err = ServerClosedError("stop(drain=True) timed out after %ss; "
                                "remaining requests failed" % timeout)
        with self._cond:
            self._abort = True
            stranded = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            self._cond.notify_all()
        for r in stranded:
            r.assembly.fail(err)
        # best-effort: the wedged thread owns _inflight, but fail() is
        # idempotent, so failing a batch it later completes is a no-op
        for ent in self._inflight.snapshot():
            for r in ent.reqs:
                r.assembly.fail(err)
        with self._lock:
            self._stats["drain_timeouts"] += 1

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=True)

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    def warmup(self, replicas=None):
        """Run a zero batch through every (replica, bucket) program — on a
        card this captures each one's graph — so the first real request
        never pays a capture. Returns the number of programs warmed."""
        n = 0
        for rep in (self.active_replicas() if replicas is None
                    else replicas):
            for bucket in self._cfg.buckets:
                _fetch(*self._run_bucket(rep, bucket,
                                         self._zero_batch(bucket)))
                n += 1
        return n

    def _zero_batch(self, bucket):
        return [np.zeros((bucket,) + s,
                         dtype=_np_dtype(self._arg_dtypes.get(n, "float32"))
                         or np.float32)
                for n, s in zip(self._data_names, self._row_shapes)]

    # ---------------------------------------------------------- resizing
    def active_replicas(self):
        """Sorted indices of replicas currently in the round-robin set."""
        with self._lock:
            return sorted(self._active)

    def _update_replica_gauges(self):
        with self._lock:
            configured = len(self._active)
            available = len(self._active - set(self._quarantined))
        metrics.gauge("serving.replicas_configured").set(configured)
        metrics.gauge("serving.replicas_available").set(available)

    def _release_replica(self, rep):
        """Free a deactivated slot's parameters, bindings and programs: on
        a card its graphs (``CUDAGraph.reset``), their static buffers and
        its pool, after its stream has finished every replay."""
        with self._graph_lock:
            if self._streams[rep] is not None:
                self._streams[rep].synchronize()
            with self._lock:
                # a dispatch that picked the replica before it left the
                # rotation may have made bindings since: they go too
                for key in [k for k in self._bucket_extras if k[0] == rep]:
                    del self._bucket_extras[key]
            for key in [k for k in self._programs if k[0] == rep]:
                prog = self._programs[key]
                if prog is not None:
                    # a card's graph goes, and a reactivated slot
                    # captures (and counts) it anew; a CPU key stays,
                    # as the JAX package's program set does
                    prog.release()
                    del self._programs[key]
            self._pools[rep] = None
            self._replica_args[rep] = None
            self._replica_aux[rep] = None

    def resize_replicas(self, n):
        """Set the number of serving replicas to ``n``, live — the
        autoscaler's actuator, callable mid-traffic.

        Replica SLOTS are append-only so indices stay stable for in-flight
        batches: a scale-down *deactivates* slots (quarantined ones first,
        then the highest index), freeing their parameters, bindings and
        graphs; a scale-up first *reactivates* vacant slots (a fresh copy
        of the retained post-fold host parameters) before appending new
        slots on the device pool, round-robin. Admission, the queue and
        the in-flight window are untouched, so FIFO completion holds
        across a resize. A dispatcher racing a just-deactivated replica
        gets the normal quarantine-and-retry path.

        Returns ``{"replicas", "added", "removed"}``.
        """
        n = int(n)
        if n < 1:
            raise ValueError("resize_replicas(%d): need at least one "
                             "replica" % n)
        with self._lock:
            active = sorted(self._active)
            quarantined = set(self._quarantined)
        added, removed = [], []
        if n < len(active):
            # victims: quarantined first (already out of rotation), then
            # the highest index (newest capacity first)
            ordered = sorted(active, key=lambda r: (r in quarantined, r),
                             reverse=True)
            removed = sorted(ordered[:len(active) - n])
            with self._lock:
                for rep in removed:
                    self._active.discard(rep)
                    self._quarantined.pop(rep, None)
                self._stats["scale_downs"] += 1
            for rep in removed:
                self._release_replica(rep)
        elif n > len(active):
            need = n - len(active)
            with self._lock:
                vacant = [i for i in range(len(self._devices))
                          if i not in self._active]
            for i in vacant[:need]:
                self._place_replica(i)
                added.append(i)
            while len(added) < need:
                idx = len(self._devices)
                self._devices.append(
                    self._device_pool[idx % len(self._device_pool)])
                self._replica_args.append(None)
                self._replica_aux.append(None)
                self._streams.append(None)
                self._pools.append(None)
                self._place_replica(idx)
                added.append(idx)
            with self._lock:
                self._active.update(added)
                self._stats["scale_ups"] += 1
        if added or removed:
            self._update_replica_gauges()
            metrics.counter("serving.resizes").inc()
            with self._cond:
                self._cond.notify_all()  # new capacity: wake the loop
        with self._lock:
            count = len(self._active)
        return {"replicas": count, "added": added, "removed": removed}

    # ------------------------------------------------------------- submit
    def submit(self, data):
        """Enqueue one request; returns a ``concurrent.futures.Future``.

        ``data``: one array per data input (a bare array for single-input
        symbols), either one row (no batch axis; the result is unbatched
        too) or a stack of rows. Requests larger than the biggest bucket
        are chunked at admission and reassembled.
        """
        arrays, n_rows, squeeze = self._validate(data)
        future = concurrent.futures.Future()
        max_bucket = self._cfg.buckets[-1]
        n_parts = -(-n_rows // max_bucket)
        # submit is the trace's birth; the dispatcher marks the queue,
        # batch, compute and fetch ends as the request crosses them
        trace = _rtrace.begin("serving")
        trace.annotate(rows=n_rows, parts=n_parts)
        assembly = _Assembly(future, n_parts, squeeze, trace)
        t0 = time.monotonic()
        deadline = (t0 + self._cfg.deadline_ms / 1e3
                    if self._cfg.deadline_ms > 0 else None)
        parts = []
        for p in range(n_parts):
            lo, hi = p * max_bucket, min((p + 1) * max_bucket, n_rows)
            parts.append(_Request([a[lo:hi] for a in arrays], hi - lo,
                                  assembly, p, t0, deadline))
        bound = self._cfg.max_queue_rows
        with self._cond:
            if self._stop:
                trace.finish("rejected")
                raise ServerClosedError("submit() after stop()")
            if self._cfg.backpressure == "reject":
                if self._queued_rows + n_rows > bound:
                    with self._lock:
                        self._stats["rejected"] += 1
                    metrics.counter("serving.rejected").inc()
                    trace.finish("rejected")
                    if n_rows > bound:
                        raise QueueFullError(
                            "%d-row request can never fit the %d-row "
                            "admission queue under backpressure='reject'; "
                            "raise MXNET_SERVING_QUEUE or use "
                            "backpressure='block' (chunk-wise admission)"
                            % (n_rows, bound))
                    raise QueueFullError(
                        "admission queue full (%d queued + %d new > %d); "
                        "raise MXNET_SERVING_QUEUE or use "
                        "backpressure='block'"
                        % (self._queued_rows, n_rows, bound))
                self._queue.extend(parts)
                self._queued_rows += n_rows
            else:
                # chunk-wise admission: each part fits one largest bucket
                for part in parts:
                    while self._queued_rows + part.n > bound:
                        self._cond.wait()
                        if self._stop:
                            err = ServerClosedError(
                                "server stopped while submit() was blocked")
                            assembly.fail(err)
                            raise err
                    self._queue.append(part)
                    self._queued_rows += part.n
                    self._cond.notify_all()
            depth = self._queued_rows
            self._cond.notify_all()
        with self._lock:
            self._stats["requests"] += 1
            self._stats["rows_in"] += n_rows
            if n_parts > 1:
                self._stats["chunked"] += 1
        metrics.counter("serving.requests").inc()
        metrics.gauge("serving.queue_depth").set(depth)
        return future

    def predict(self, data, timeout=None):
        """``submit(data).result(timeout)``."""
        return self.submit(data).result(timeout)

    def _validate(self, data):
        if not isinstance(data, (list, tuple)):
            data = [data]
        if len(data) != len(self._data_names):
            raise ValueError("expected %d data inputs %s, got %d"
                             % (len(self._data_names), self._data_names,
                                len(data)))
        arrays, squeeze, n_rows = [], None, None
        for x, name, row_shape in zip(data, self._data_names,
                                      self._row_shapes):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            elif hasattr(x, "asnumpy"):
                x = x.asnumpy()
            x = np.asarray(x)
            if x.shape == row_shape:
                x, sq = x[None], True
            elif x.shape[1:] == row_shape:
                sq = False
            else:
                raise ValueError(
                    "input %r: expected row shape %s (or a leading batch "
                    "axis), got %s" % (name, row_shape, x.shape))
            if squeeze is None:
                squeeze, n_rows = sq, x.shape[0]
            elif sq != squeeze or x.shape[0] != n_rows:
                raise ValueError("all data inputs must agree on batching")
            dt = _np_dtype(self._arg_dtypes.get(name, "float32"))
            if dt is not None and x.dtype != dt:
                x = x.astype(dt)
            arrays.append(x)
        if n_rows == 0:
            raise ValueError("empty request (0 rows)")
        return arrays, n_rows, squeeze

    # --------------------------------------------------------- dispatcher
    def _dispatch_loop(self):
        """Collect -> pad -> stage -> replay, completing the oldest
        in-flight batch whenever the window is full or nothing is ready."""
        while True:
            while self._inflight.full:
                self._complete_oldest()
            reqs = self._collect(block=not self._inflight)
            if reqs is None:
                break
            self._probe_quarantined()
            if not reqs:
                if self._inflight:
                    self._complete_oldest()
                continue
            try:
                self._launch(reqs)
            except Exception as err:  # deliver, don't kill the thread
                for r in reqs:
                    r.assembly.fail(err)
        while self._inflight:
            self._complete_oldest()

    def _collect(self, block):
        """The next batch's requests (FIFO, at most the largest bucket);
        [] when nothing is ready and ``block`` is False; None when stopped
        and drained."""
        max_bucket = self._cfg.buckets[-1]
        wait_s = self._cfg.max_wait_ms / 1e3
        with self._cond:
            while True:
                if self._queue:
                    deadline = self._queue[0].t_submit + wait_s
                    if (self._queued_rows >= max_bucket or self._stop
                            or time.monotonic() >= deadline):
                        return self._pop_locked()
                    timeout = deadline - time.monotonic()
                elif self._stop:
                    return None
                else:
                    timeout = None
                if not block:
                    return []
                self._cond.wait(timeout)

    def _pop_locked(self):
        # caller (_collect) holds self._cond
        if self._abort:
            err = ServerClosedError("server stopped without draining")
            while self._queue:
                self._queue.popleft().assembly.fail(err)
            self._queued_rows = 0
            self._cond.notify_all()
            return None
        max_bucket = self._cfg.buckets[-1]
        now = time.monotonic()
        reqs, rows = [], 0
        while self._queue and rows + self._queue[0].n <= max_bucket:
            r = self._queue.popleft()
            self._queued_rows -= r.n
            # the queue phase ends here for this part, expired or not
            r.assembly.trace.event("queue")
            if r.deadline is not None and now >= r.deadline:
                r.assembly.fail(DeadlineExceeded(
                    "request expired in queue after %.0f ms (deadline "
                    "%.0f ms)" % ((now - r.t_submit) * 1e3,
                                  self._cfg.deadline_ms)),
                    status="deadline_expired")
                with self._lock:
                    self._stats["expired"] += 1
                metrics.counter("serving.deadline_expired").inc()
                continue
            reqs.append(r)
            rows += r.n
        self._cond.notify_all()  # wake submitters blocked on backpressure
        metrics.gauge("serving.queue_depth").set(self._queued_rows)
        return reqs

    def _launch(self, reqs):
        """Pad to the bucket, stage and replay (asynchronously on a card);
        the batch joins the in-flight window. A dispatch fault quarantines
        the replica and the batch retries ONCE on a surviving one."""
        rows = sum(r.n for r in reqs)
        bucket = pick_bucket(rows, self._cfg.buckets)
        batch = []
        for i, shape in enumerate(self._row_shapes):
            pieces = [r.arrays[i] for r in reqs]
            if rows < bucket:
                pieces.append(np.zeros((bucket - rows,) + shape,
                                       dtype=pieces[0].dtype))
            batch.append(pieces[0] if len(pieces) == 1
                         else np.concatenate(pieces))
        err = None
        for attempt in range(2):
            rep = self._pick_replica()
            if rep is None:
                # circuit OPEN: every replica is quarantined, so this
                # batch fails fast (requeueing would invert FIFO); the
                # dispatcher probes due replicas before every launch
                raise err or MXNetError(
                    "all %d serving replicas quarantined — failing fast; "
                    "a probe re-admits replicas after the %.0f ms "
                    "cooldown (MXNET_SERVING_COOLDOWN_MS)"
                    % (len(self._devices), self._cfg.cooldown_ms))
            try:
                outs, ready = self._run_bucket(rep, bucket, batch)
            except Exception as e:
                self._quarantine(rep, e)
                err = e
                continue
            self._inflight.push(_InFlight(outs, ready, reqs, bucket, rows,
                                          rep, batch, attempt > 0))
            for r in reqs:
                # batch formation ends at dispatch: padding, staging and
                # the asynchronous replay land between "queue" and here
                r.assembly.trace.event("batch")
                r.assembly.trace.annotate(bucket=bucket, replica=rep)
            with self._lock:
                if attempt > 0:
                    self._stats["batch_retries"] += 1
                self._stats["batches"] += 1
                self._stats["rows_real"] += rows
                self._stats["rows_padded"] += bucket - rows
            metrics.counter("serving.batches").inc()
            metrics.counter("serving.rows_real").inc(rows)
            metrics.counter("serving.rows_padded").inc(bucket - rows)
            metrics.histogram("serving.occupancy_pct").observe(
                100.0 * rows / bucket)
            return
        raise err

    # ------------------------------------------------- replica failover
    def _pick_replica(self):
        """Next ACTIVE replica in round-robin order, skipping quarantined
        ones; None when nothing is dispatchable."""
        with self._lock:
            active = sorted(self._active)
            quarantined = set(self._quarantined)
        if not active:
            return None
        for _ in range(len(active)):
            rep = active[self._rr % len(active)]
            self._rr += 1
            if rep not in quarantined:
                return rep
        return None

    def _quarantine(self, rep, err):
        """Pull a faulted replica out of round-robin until its probe."""
        with self._lock:
            if rep not in self._active:
                return   # raced a scale-down: already out of rotation
            self._quarantined[rep] = (time.monotonic()
                                      + self._cfg.cooldown_ms / 1e3)
            self._stats["quarantines"] += 1
        self._update_replica_gauges()
        metrics.counter("serving.replica_quarantined").inc()
        logging.warning("serving: replica %d quarantined for %.0f ms after "
                        "%s: %s", rep, self._cfg.cooldown_ms,
                        type(err).__name__, err)

    def _probe_quarantined(self):
        """Cooldown-expired quarantined replicas get one zero batch of the
        smallest bucket (on a card, a replay of its graph); success
        re-admits them, failure restarts the cooldown. Runs on the
        dispatcher thread between batches, never on the request path."""
        now = time.monotonic()
        with self._lock:
            due = [rep for rep, until in self._quarantined.items()
                   if now >= until and rep in self._active]
        for rep in due:
            probe_bucket = self._cfg.buckets[0]
            try:
                _fetch(*self._run_bucket(rep, probe_bucket,
                                         self._zero_batch(probe_bucket)))
            except Exception as err:
                self._quarantine(rep, err)
                continue
            with self._lock:
                self._quarantined.pop(rep, None)
                self._stats["readmitted"] += 1
            self._update_replica_gauges()
            metrics.counter("serving.replica_readmitted").inc()

    def _retry_batch(self, ent):
        """Re-execute a fetch-faulted batch on a surviving replica and
        fetch synchronously; returns host outputs or None when no replica
        survives (or the retry faults too)."""
        rep = self._pick_replica()
        if rep is None:
            return None
        with self._lock:
            self._stats["batch_retries"] += 1
        metrics.counter("serving.batch_retries").inc()
        try:
            return _fetch(*self._run_bucket(rep, ent.bucket, ent.batch))
        except Exception as err:
            self._quarantine(rep, err)
            return None

    def _run_bucket(self, replica, bucket, batch_arrays):
        """One dispatch of a padded bucket batch on ``replica``: (device
        outputs, the event the fetch waits on, None on the CPU). On a card
        the batch is staged on the replica's stream into its program's
        static inputs and the graph replayed — captured first if this is
        the program's first use."""
        _faults.inject("serving.replica_execute", tag=replica)
        dev = self._devices[replica]
        dtypes = [torch_dtype(self._arg_dtypes.get(n, "float32"))
                  for n in self._data_names]
        key = (replica, bucket)
        with self._graph_lock, self._device_scope(dev):
            args = self._replica_args[replica]
            if args is None:
                raise MXNetError("serving replica %d was removed by "
                                 "resize_replicas" % replica)
            fresh = key not in self._programs
            if dev.type != "cuda":
                extras, aux = self._bindings(replica, bucket)
                feed = dict(args)
                feed.update(extras)
                feed.update(
                    (n, t.to(d)) for n, t, d in
                    zip(self._data_names, stage_pytree(batch_arrays, dev),
                        dtypes))
                outs = list(self._forward(feed, aux))
                ready = None
                self._programs[key] = None
            else:
                stream = self._streams[replica]
                if fresh:
                    # the parameters were copied on the current stream
                    stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    if fresh:
                        # zero-filled on the stream that replays over them
                        extras, aux = self._bindings(replica, bucket)
                        feed = dict(args)
                        feed.update(extras)
                        self._programs[key] = _BucketGraph(
                            self._forward, feed, aux, self._data_names,
                            [(bucket,) + s for s in self._row_shapes],
                            dtypes, dev, self._pools[replica])
                    outs, ready = self._programs[key].run(
                        stage_pytree(batch_arrays, dev), stream)
        if fresh:
            with self._lock:
                self._stats["bucket_programs"] += 1
            metrics.counter("serving.bucket_compiles").inc()
        return outs, ready

    def _complete_oldest(self):
        """Fetch the oldest in-flight batch and route each request's rows
        to its future (FIFO — completion order == admission order)."""
        ent = None

        def _finalize(entry):
            # the one place serving blocks on the device: by now batch
            # N+1 is already replayed; pop_timed accounts the wait
            nonlocal ent
            ent = entry
            for r in entry.reqs:
                r.assembly.trace.event("compute")
            return _fetch(entry.outs, entry.ready)

        try:
            host = self._inflight.pop_timed(_finalize)
        except Exception as err:
            if ent is None:  # the pop itself failed (empty window)
                raise
            # device failure at fetch: quarantine the replica and retry
            # the batch ONCE on a surviving one — inference is idempotent
            self._quarantine(ent.replica, err)
            host = None if ent.retried else self._retry_batch(ent)
            if host is None:
                for r in ent.reqs:
                    r.assembly.fail(err)
                return
        now = time.monotonic()
        offset = 0
        finished = 0
        for r in ent.reqs:
            r.assembly.trace.event("fetch")
            done = r.assembly.deliver(
                r.part, [o[offset:offset + r.n] for o in host])
            offset += r.n
            if done:  # count (and time) whole requests, not chunks
                finished += 1
                metrics.histogram("serving.latency_ms").observe(
                    (now - r.t_submit) * 1e3)
        with self._lock:
            self._stats["completed"] += finished

    # -------------------------------------------------------------- stats
    def breaker_states(self):
        """Circuit-breaker view: overall state (``closed`` — all replicas
        serving; ``degraded`` — some quarantined; ``open`` — every replica
        quarantined, requests fail fast) plus per-quarantined-replica
        probe countdowns."""
        now = time.monotonic()
        with self._lock:
            quarantined = dict(self._quarantined)
            n = len(self._active)
        if not quarantined:
            state = "closed"
        elif len(quarantined) >= n:
            state = "open"
        else:
            state = "degraded"
        return {
            "state": state,
            "replicas": n,
            "quarantined": {
                str(rep): {"probe_in_ms":
                           round(max(0.0, (until - now) * 1e3), 1)}
                for rep, until in sorted(quarantined.items())},
            "cooldown_ms": self._cfg.cooldown_ms,
        }

    def get_stats(self):
        """Operational snapshot in the shared engine-stats schema
        (observability/stats_schema.py), with the JAX package's legacy
        flat keys (queue_rows, inflight, buckets, ...) on top.
        ``bucket_programs`` counts the programs made: on a card the
        captures, on the CPU the first uses."""
        with self._cond:
            depth = self._queued_rows
            stopped = self._stop
        with self._lock:
            counters = dict(self._stats)
            quarantined = sorted(self._quarantined)
            replicas = len(self._active)
            slots = len(self._devices)
        return _schema.engine_stats(
            "serving", counters,
            queue_depth=depth,
            completed=counters.get("completed", 0),
            running=self.running, stopped=stopped,
            capacity={
                "buckets": list(self._cfg.buckets),
                "replicas": replicas,
                "replica_slots": slots,
                "inflight": len(self._inflight),
                "pipeline_depth": self._cfg.pipeline_depth,
                "queue_limit_rows": self._cfg.max_queue_rows,
            },
            config={
                "max_wait_ms": self._cfg.max_wait_ms,
                "deadline_ms": self._cfg.deadline_ms,
                "backpressure": self._cfg.backpressure,
                "cooldown_ms": self._cfg.cooldown_ms,
            },
            resilience={
                "breaker": self.breaker_states(),
                "quarantines": counters.get("quarantines", 0),
                "batch_retries": counters.get("batch_retries", 0),
                "drain_timeouts": counters.get("drain_timeouts", 0),
            },
            provenance=(self._opt.summary() if self._opt is not None
                        else None),
            extra={
                "queue_rows": depth,
                "inflight": len(self._inflight),
                "staged_batches": self._inflight.pushed,
                "staging_wait_s": round(self._inflight.wait_s, 6),
                "buckets": list(self._cfg.buckets),
                "replicas": replicas,
                "quarantined_replicas": quarantined,
                "deadline_ms": self._cfg.deadline_ms,
                "max_wait_ms": self._cfg.max_wait_ms,
            })

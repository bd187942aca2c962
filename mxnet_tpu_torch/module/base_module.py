"""BaseModule: the train / score / predict loops shared by all modules.

Counterpart of ``mxnet_tpu/module/base_module.py``: ``fit`` / ``score`` /
``predict`` / ``iter_predict`` over the abstract bind / init / forward
family, built on a lookahead batch iterator (``prepare`` sees the next
batch while the current one runs) and a shared inference-batch
generator. ``fit(monitor=)`` installs a :class:`~..monitor.Monitor` on the
bound executors and ticks it around every step.

Each fit step runs inside a step-waterfall scope (``observability.perf``:
data wait, time blocked on the card, kvstore and host time, summing to the
step's wall) and a ``step`` span, and, under ``MXNET_HEALTH``, the health
layer's check over the step's outputs, gradients and parameters before the
update (``skip_step`` withholds the update). Not ported: ``fit(resume=...)``
(preemption-safe checkpoints, ``ROADMAP.md`` Queue A13); asking for it
raises.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from ..base import MXNetError
from ..observability import flight_recorder, health, perf, record_step
from ..observability.tracing import trace_span
from ..model import BatchEndParam
from .. import ndarray as nd
from ..context import cpu
from ..initializer import Uniform

_PARAM_KINDS = ("arg", "aux")
_WEIGHT_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta")


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _fire(callbacks, *args):
    """Invoke a callback or list of callbacks (ignoring None)."""
    if callbacks is None:
        return
    for cb in _as_list(callbacks):
        cb(*args)


def _resolve_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


def _check_input_names(symbol, names, typename, throw):
    """Warn (or raise) when a declared input name is absent from the graph,
    suggesting likely data/label argument names."""
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        data_like = [a for a in args
                     if not any(a.endswith(sfx) for sfx in _WEIGHT_SUFFIXES)]
        msg = ("\033[91mYou created Module with Module(..., %s_names=%s) but "
               "input with name '%s' is not found in symbol.list_arguments(). "
               "Did you mean one of:\n\t%s\033[0m"
               % (typename, str(names), name, "\n\t".join(data_like)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _lookahead(data_iter):
    """Yield (batch, is_last, next batch) triples, reading one batch
    ahead.

    Each ``next()`` is timed into the current perf step scope's
    data-wait segment: the fit loop opens the scope BEFORE resuming this
    generator, so the wait for batch N+1 lands in the step that stalls on
    it."""
    it = iter(data_iter)
    t0 = time.perf_counter()
    try:
        pending = next(it)
    except StopIteration:
        return
    finally:
        perf.note_data_wait(time.perf_counter() - t0)
    while True:
        t0 = time.perf_counter()
        try:
            upcoming = next(it)
        except StopIteration:
            perf.note_data_wait(time.perf_counter() - t0)
            yield pending, True, None
            return
        perf.note_data_wait(time.perf_counter() - t0)
        yield pending, False, upcoming
        pending = upcoming


class BaseModule:
    """Abstract module: a symbol + bound executors + parameters, with
    high-level loops implemented on the abstract interface."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._total_exec_bytes = 0
        self._health_steps = 0  # monotonic across epochs (flight recorder)
        self._fit_steps = 0     # completed fit steps (waterfall rows)

    # ------------------------------------------------------------------ fit
    def forward_backward(self, data_batch):
        """One fused optimization step's compute half."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, resume=None):
        """Train over ``train_data`` for ``num_epoch`` epochs."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        if resume is not None:
            raise MXNetError("fit(resume=...) is not yet ported (ROADMAP.md "
                             "Queue A13)")
        if health.active():
            # arm the crash hooks so an OOM or a raise mid-fit still
            # leaves the last-K step records on disk
            flight_recorder.install()
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        train_metric = _resolve_metric(eval_metric)
        validation_metric = (train_metric if validation_metric is None
                             else validation_metric)
        for epoch in range(begin_epoch, num_epoch):
            started = time.time()
            train_metric.reset()
            self._fit_epoch(train_data, train_metric, monitor,
                            batch_end_callback, epoch)
            for name, val in train_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - started)
            # sync params from the devices so callbacks and eval see them
            arg_now, aux_now = self.get_params()
            self.set_params(arg_now, aux_now)
            _fire(epoch_end_callback, epoch, self.symbol, arg_now, aux_now)
            if eval_data:
                scores = self.score(
                    eval_data, validation_metric,
                    score_end_callback=eval_end_callback,
                    batch_end_callback=eval_batch_end_callback, epoch=epoch)
                for name, val in scores:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
        if health.active():
            # settle the warn-mode lag-1 stash so the final step's
            # verdict is recorded before fit returns
            health.flush()

    def _fit_epoch(self, train_data, train_metric, monitor,
                   batch_end_callback, epoch):
        """One pass over train_data; returns the batches consumed."""
        nbatch = 0
        # step-time waterfall (observability.perf): the scope opens
        # BEFORE the lookahead fetches each batch, so data wait, the
        # wait for the card and kvstore time all land in the step that
        # paid them; the segments sum to the step wall by construction
        perf.step_begin()
        try:
            eval_metric = train_metric  # noqa: F841  (read via locals())
            for data_batch, _is_last, upcoming in _lookahead(train_data):
                step_started = time.perf_counter()
                if monitor is not None:
                    monitor.tic()
                with trace_span("step", "module"):
                    self.forward_backward(data_batch)
                    skip_update = False
                    if health.active():
                        # check this step's loss/grads/params BEFORE the
                        # update, so skip_step can withhold it
                        verdict = self._health_check(
                            time.perf_counter() - step_started)
                        skip_update = verdict is not None and verdict.skip
                    if not skip_update:
                        with trace_span("update", "module"):
                            self.update()
                if upcoming is not None:
                    self.prepare(upcoming)
                if not skip_update:
                    # a skipped step's outputs are the non-finite values
                    # the skip protects against: kept out of the metric
                    with trace_span("update_metric", "module"):
                        self.update_metric(train_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                record_step(time.perf_counter() - step_started)
                self._fit_steps += 1
                perf.step_end(step=self._fit_steps)
                perf.step_begin()
                _fire(batch_end_callback,
                      BatchEndParam(epoch=epoch, nbatch=nbatch,
                                    eval_metric=train_metric,
                                    locals=locals()))
                nbatch += 1
        finally:
            # the epoch end or an exception (a health raise) must not
            # leave a dangling scope: step_active() would keep timing
            # every later forward on this thread
            perf.step_abandon()
        return nbatch

    def _health_check(self, wall_s):
        """Hook: run observability.health's per-step check over this
        module's tensors; returns the Verdict (``verdict.skip`` withholds
        the update) or None. Subclasses with bound executors override —
        the base implementation watches nothing."""
        return None

    # ---------------------------------------------------------- inference
    def _set_output_selection(self, sel):
        """Hook: restrict forwards to the output indices in ``sel``
        (None restores all). Subclasses with bound executors thread it
        into their walk; the base implementation supports nothing and
        returns False, and callers then slice the outputs instead."""
        return False

    def _resolve_output_indices(self, outputs):
        """Map requested output names (bare or ``_output``-suffixed) or
        indices onto positions in this module's output list (one shared
        resolver: executor.resolve_output_indices)."""
        from ..executor import resolve_output_indices

        try:
            names = list(self.output_names)
        except (AttributeError, AssertionError):
            names = list(self.symbol.list_outputs())
        return resolve_output_indices(names, outputs)

    def _inference_batches(self, eval_data, num_batch, reset, outputs=None):
        """Forward (is_train=False) over eval_data, yielding
        (index, original batch, depadded outputs, extra pad rows).

        A trailing short batch is padded up to the bound batch size and
        the outputs are sliced back, instead of re-binding the executor
        for the leftover shape. ``outputs`` selects a subset of heads by
        name or index: the executors' walk is pruned to the selection
        where the module supports it, else the outputs are sliced."""
        from ..io import pad_batch_to_bound

        if not (self.binded and self.params_initialized):
            raise AssertionError("call bind and init_params first")
        if reset:
            eval_data.reset()
        sel = (self._resolve_output_indices(outputs)
               if outputs is not None else None)
        applied = sel is not None and self._set_output_selection(sel)
        try:
            for i, batch in enumerate(eval_data):
                if num_batch is not None and i == num_batch:
                    return
                fwd, extra = pad_batch_to_bound(batch, self.data_shapes,
                                                self.label_shapes)
                self.forward(fwd, is_train=False)
                pad = (batch.pad or 0) + extra
                keep = lambda o, _pad=pad: o[0:o.shape[0] - _pad]  # noqa: E731
                outs = self.get_outputs()
                if sel is not None and not applied:
                    outs = [outs[j] for j in sel]
                yield i, batch, [keep(o) for o in outs], extra
        finally:
            if applied:
                self._set_output_selection(None)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, outputs=None):
        """Run a full evaluation pass and return metric name/value pairs.
        ``outputs`` restricts the evaluated heads (see :meth:`predict`) —
        the metric then sees only the selected outputs."""
        eval_metric = _resolve_metric(eval_metric)
        eval_metric.reset()
        seen = 0
        for nbatch, batch, outs, extra in self._inference_batches(
                eval_data, num_batch, reset, outputs=outputs):
            if extra:
                # the executors ran on a padded batch; score the true
                # rows exactly (synthetic zero rows never reach the
                # metric — unlike pad-mode iterators, whose wrap-around
                # rows the reference metric path has always counted)
                pad = batch.pad or 0
                labels = [lbl[0:lbl.shape[0] - pad]
                          for lbl in (batch.label or [])]
                eval_metric.update(labels, outs)
            else:
                self.update_metric(eval_metric, batch.label)
            _fire(batch_end_callback,
                  BatchEndParam(epoch=epoch, nbatch=nbatch,
                                eval_metric=eval_metric, locals=locals()))
            seen += 1
        _fire(score_end_callback,
              BatchEndParam(epoch=epoch, nbatch=seen,
                            eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True,
                     outputs=None):
        """Generator over (outputs, batch index, batch)."""
        for i, batch, outs, _extra in self._inference_batches(
                eval_data, num_batch, reset, outputs=outputs):
            yield outs, i, batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, outputs=None):
        """Collect predictions; optionally concatenate across batches.
        ``outputs`` selects a subset of the graph's heads by name (bare or
        ``_output``-suffixed) or index."""
        collected = [
            [o.copy() for o in outs]
            for _i, _batch, outs, _extra in self._inference_batches(
                eval_data, num_batch, reset, outputs=outputs)]
        if not collected:
            return collected
        if not merge_batches:
            return collected
        width = len(collected[0])
        if any(len(outs) != width for outs in collected):
            raise AssertionError(
                "Cannot merge batches, as num of outputs is not the same "
                "in mini-batches. Maybe bucketing is used?")
        merged = [nd.concatenate([outs[i] for outs in collected])
                  for i in range(width)]
        if width == 1 and not always_output_list:
            return merged[0]
        return merged

    # ------------------------------------------------------------- params
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        """Write arg/aux params as a flat dict with arg:/aux: key prefixes."""
        blobs = {}
        for kind, params in zip(_PARAM_KINDS, self.get_params()):
            for name, value in params.items():
                blobs[f"{kind}:{name}"] = value.as_in_context(cpu())
        nd.save(fname, blobs)

    def load_params(self, fname):
        """Inverse of save_params."""
        split = {kind: {} for kind in _PARAM_KINDS}
        for key, value in nd.load(fname).items():
            kind, _, name = key.partition(":")
            if kind not in split or not name:
                raise ValueError("Invalid param file " + fname)
            split[kind][name] = value
        self.set_params(split["arg"], split["aux"])

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        assert not merge_multi_context
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        assert not states and not value

    def install_monitor(self, mon):
        raise NotImplementedError()

    def prepare(self, data_batch):
        """Hook called with the *next* batch before it is consumed."""

    # ---------------------------------------------------- abstract surface
    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

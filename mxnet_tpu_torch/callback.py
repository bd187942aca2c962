"""Epoch / batch callbacks for the fit loops.

Counterpart of ``mxnet_tpu/callback.py``: the checkpoint callbacks
(``module_checkpoint``, ``do_checkpoint``), ``log_train_metric`` and
``Speedometer`` (``ProgressBar`` and ``LogValidationMetricsCallback`` are
not ported yet). Batch callbacks receive a ``BatchEndParam`` with
``epoch``, ``nbatch`` and ``eval_metric``; epoch callbacks receive
``(epoch, symbol, arg_params, aux_params)``.
"""
from __future__ import annotations

import logging
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer"]


def _metric_pairs(param):
    """name/value pairs from a batch param, or () when no metric attached."""
    metric = getattr(param, "eval_metric", None)
    return metric.get_name_value() if metric is not None else ()


def _periodic_saver(period, save_fn):
    """Wrap ``save_fn(epoch_1based)`` to fire once per ``period`` epochs."""
    period = max(1, int(period))

    def maybe_save(epoch, *state):
        tick = epoch + 1
        if tick % period == 0:
            save_fn(tick, *state)

    return maybe_save


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch callback that saves ``mod`` every ``period`` epochs."""
    return _periodic_saver(
        period,
        lambda tick, *_s: mod.save_checkpoint(prefix, tick,
                                              save_optimizer_states))


def do_checkpoint(prefix, period=1):
    """Epoch callback that writes ``prefix-symbol.json`` and
    ``prefix-NNNN.params`` every ``period`` epochs."""
    from .model import save_checkpoint
    return _periodic_saver(
        period,
        lambda tick, sym, arg, aux: save_checkpoint(prefix, tick, sym,
                                                    arg, aux))


def log_train_metric(period, auto_reset=False):
    """Batch callback that logs the attached metric every ``period`` batches."""
    period = max(1, int(period))

    def emit(param):
        if param.nbatch % period:
            return
        head = f"Iter[{param.epoch}] Batch[{param.nbatch}]"
        for name, value in _metric_pairs(param):
            logging.info("%s Train-%s=%f", head, name, value)
        metric = getattr(param, "eval_metric", None)
        if auto_reset and metric is not None:
            metric.reset()

    return emit


class Speedometer:
    """Batch callback printing samples/sec (and metric values) every
    ``frequent`` batches.

    Internally keeps a single (batch-count, wall-clock) anchor; throughput is
    measured between consecutive report points rather than per batch, so the
    number is stable under asynchronous launches.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = max(1, int(frequent))
        self.auto_reset = auto_reset
        self._anchor = None  # (nbatch, time) of last report / epoch start

    def _report(self, param, rate):
        pairs = list(_metric_pairs(param))
        tag = "Epoch" if pairs else "Iter"
        line = f"{tag}[{param.epoch}] Batch [{param.nbatch}]" \
               f"\tSpeed: {rate:.2f} samples/sec"
        line += "".join(f"\t{k}={v:f}" for k, v in pairs)
        if pairs and self.auto_reset:
            param.eval_metric.reset()
        logging.info(line)

    def __call__(self, param):
        now = time.time()
        if self._anchor is None or param.nbatch < self._anchor[0]:
            # new epoch (counter went backwards) or first ever call
            self._anchor = (param.nbatch, now)
            return
        since_batch, since_time = self._anchor
        if param.nbatch % self.frequent == 0 and param.nbatch > since_batch:
            elapsed = max(now - since_time, 1e-12)
            rate = (param.nbatch - since_batch) * self.batch_size / elapsed
            self._report(param, rate)
            self._anchor = (param.nbatch, now)


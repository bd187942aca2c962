"""Monitor: periodic tensor statistics over bound executors.

Counterpart of ``mxnet_tpu/monitor.py`` (reference monitor.py). Every
``interval`` batches the monitor scans the outputs, arguments and
auxiliary states of the executors it watches and records ``stat_func`` of
the ones whose name matches its pattern. Interior node values reach a
caller through :meth:`~mxnet_tpu_torch.executor.Executor.
set_monitor_callback` instead.
"""
from __future__ import annotations

import logging
import re

import numpy as np

from .ndarray import NDArray

__all__ = ["Monitor"]


def _default_stat(x):
    """Mean absolute value, reduced on the array's device."""
    return x.abs().sum() / x.size


def _fetch(values):
    """Host-fetch a stat result ONCE: [(numpy value, scalarish)].

    Non-NDArray results raise AssertionError (a stat_func bug must stay
    loud); an aborted/deleted device buffer raises RuntimeError, which
    the caller treats as a per-entry skip."""
    if isinstance(values, NDArray):
        values = [values]
    if not isinstance(values, list):
        raise AssertionError("stat_func must return NDArray(s)")
    out = []
    for v in values:
        if not isinstance(v, NDArray):
            raise AssertionError("stat_func must return NDArray(s)")
        # one fetch per reported stat, after the on-device reduction
        out.append((v.asnumpy(), v.shape in ((1,), ())))
    return out


def _render(fetched):
    """Format host-fetched stat values for logging."""
    return "".join(
        str(arr.reshape(-1)[0] if scalarish else arr) + "\t"
        for arr, scalarish in fetched)


class Monitor:
    """Every ``interval`` batches, record stat_func over matching tensors."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.stat_func = stat_func or _default_stat
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def install(self, exe):
        """Start watching an executor's tensors."""
        self.exes.append(exe)

    def tic(self):
        """Call at batch start; arms collection on interval boundaries."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def _scan(self, exe):
        """All (name, array) pairs this executor exposes."""
        yield from zip(exe._symbol.list_outputs(), exe.outputs)
        yield from exe.arg_dict.items()
        yield from exe.aux_dict.items()

    def toc(self):
        """Call at batch end; returns [(step, name, rendered stat)].

        Arrays whose stat raises ``RuntimeError`` and all-NaN stats are
        skipped with a debug log instead of aborting the whole collection
        pass: one poisoned tensor must not hide every other statistic of
        the batch.
        """
        if not self.activated:
            return []
        for exe in self.exes:
            for name, array in self._scan(exe):
                if not self.re_prog.match(name):
                    continue
                try:
                    stat = self.stat_func(array)
                except RuntimeError as err:
                    # a released device buffer; anything else (a
                    # stat_func bug: NameError, TypeError) stays loud
                    logging.debug("monitor: skipping %s (stat aborted: %s)",
                                  name, err)
                    continue
                self.queue.append((self.step, name, stat))
        self.activated = False
        if self.sort:
            # reference parity (python/mxnet/monitor.py toc): stable sort
            # by entry name so grouped weights/grads log adjacently
            self.queue.sort(key=lambda entry: entry[1])
        rendered = []
        for step, name, stat in self.queue:
            try:
                fetched = _fetch(stat)
            except RuntimeError as err:  # a released device buffer
                logging.debug("monitor: skipping %s (stat aborted: %s)",
                              name, err)
                continue
            if any(arr.size and np.issubdtype(arr.dtype, np.inexact)
                   and np.isnan(arr).all() for arr, _ in fetched):
                logging.debug("monitor: skipping %s (all-NaN stat)", name)
                continue
            rendered.append((step, name, _render(fetched)))
        self.queue = []
        return rendered

    def toc_print(self):
        """toc() + log each entry."""
        for step, name, text in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, text)

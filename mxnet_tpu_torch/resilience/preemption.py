"""Preemption-safe training: catch SIGTERM, finish the in-flight step,
checkpoint, exit.

Counterpart of ``mxnet_tpu/resilience/preemption.py``. A preempted cloud
job gets SIGTERM and a grace window. The :class:`PreemptionGuard` armed
by ``fit(resume=...)`` turns that signal into a *flag*: the training loop
runs until the current step completes, then writes one atomic resumable
checkpoint (:mod:`.checkpoint`) and raises :class:`PreemptedError` to
unwind. The next ``fit(resume=<same dir>)`` restores parameters,
optimizer state (update counts included), the random generators and the
(epoch, batch) position, and continues — bit-exact at the checkpointed
step for deterministic input pipelines and kernels.

While armed, the handler does NOT chain to the previously-installed
SIGTERM handler: the flight recorder's signal hook (or the process
default) would dump-and-die mid-step, which is the torn state this guard
exists to avoid. Disarming restores the previous handler, and the
checkpoint itself embeds the recorder ring.
"""
from __future__ import annotations

import logging
import signal
import threading

from ..base import MXNetError
from . import checkpoint as _checkpoint

__all__ = ["PreemptedError", "PreemptionGuard"]


class PreemptedError(MXNetError):
    """Raised by the training loop after a SIGTERM-triggered checkpoint
    landed; ``checkpoint_path`` names it. Catch to exit gracefully, or
    let it kill the process — the checkpoint is already durable."""

    def __init__(self, checkpoint_path):
        self.checkpoint_path = checkpoint_path
        super().__init__("training preempted (SIGTERM); resumable "
                         "checkpoint written to %s" % checkpoint_path)


class PreemptionGuard:
    """Armed around one ``fit`` call: intercepts SIGTERM, exposes
    :attr:`triggered` for the loop to poll between steps, and writes
    the checkpoint via :meth:`checkpoint_and_raise`.

    Signal handlers only install from the main thread; elsewhere the
    guard arms inert (``triggered`` stays False) — a fit running in a
    worker thread keeps its host process's own SIGTERM semantics.
    """

    def __init__(self, directory, signals=(signal.SIGTERM,)):
        self.directory = directory
        self._event = threading.Event()
        self._prev = {}
        self._armed = False
        try:
            for sig in signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            self._armed = True
        except ValueError:  # not the main thread
            self._prev = {}

    def _on_signal(self, signum, frame):
        # flag only — the training loop finishes the in-flight step and
        # calls checkpoint_and_raise at the next step boundary
        self._event.set()

    @property
    def armed(self):
        return self._armed

    @property
    def triggered(self):
        return self._event.is_set()

    def disarm(self):
        """Restore the previous signal handlers (idempotent)."""
        if not self._armed:
            return
        self._armed = False
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass

    def checkpoint_and_raise(self, module, epoch, batch, step,
                             iterator_state=None):
        """Write the resumable checkpoint (the data stream's EPOCH-START
        state included when the caller captured one — see
        ``save_resumable``) and unwind with :class:`PreemptedError`; the
        guard disarms first so a second SIGTERM during the write falls
        through to the default/previous handler (the grace window is
        not infinite)."""
        self.disarm()
        logging.warning("resilience: SIGTERM received — checkpointing at "
                        "epoch %d batch %d (step %d) into %s",
                        epoch, batch, step, self.directory)
        path = _checkpoint.save_resumable(module, self.directory,
                                          epoch=epoch, batch=batch,
                                          step=step,
                                          iterator_state=iterator_state)
        raise PreemptedError(path)

"""Learning-rate schedules.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (its own copy: the port
imports nothing of the JAX package). Factor / MultiFactor / Poly, as
decay-count arithmetic: each
scheduler knows how many decay events a given ``num_update`` implies and
applies only the delta since the previous query. This keeps the reference's
observable behaviour — ``base_lr`` is the *live* learning rate and may be
reassigned by callers between queries (optimizer/Trainer do exactly that) —
without its incremental while-loop state machine.
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler"]

_log = logging.getLogger(__name__)


class LRScheduler:
    """Maps an update counter to a learning rate.

    Subclasses implement ``__call__(num_update) -> float``. ``base_lr`` holds
    the current rate and is mutable from outside (Optimizer.set_lr_scheduler
    assigns the optimizer's lr into it).
    """

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError("subclass must map num_update -> lr")


class _DecayCountScheduler(LRScheduler):
    """Shared machinery: multiply ``base_lr`` by ``factor`` once per decay
    event, where the total number of events implied by ``num_update`` is
    given by ``_events_before``."""

    def __init__(self, factor, floor=0.0):
        super().__init__()
        if not factor <= 1.0:
            raise ValueError("decay factor above 1.0 would grow the lr")
        self.factor = factor
        self._floor = floor
        self._applied = 0

    def _events_before(self, num_update):
        raise NotImplementedError

    def __call__(self, num_update):
        due = self._events_before(num_update)
        hit_floor = False
        while self._applied < due:
            self._applied += 1
            nxt = self.base_lr * self.factor
            if nxt < self._floor:
                self.base_lr = self._floor
                hit_floor = True
            else:
                self.base_lr = nxt
        if due:
            if hit_floor:
                _log.info("Update[%d]: lr clamped at floor %0.5e; no further "
                          "decay will occur", num_update, self.base_lr)
            else:
                _log.info("Update[%d]: lr decayed to %0.5e",
                          num_update, self.base_lr)
        return self.base_lr


class FactorScheduler(_DecayCountScheduler):
    """Geometric decay: one event each time ``num_update`` crosses a multiple
    of ``step``, with an optional lower bound ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        if step < 1:
            raise ValueError("step must be a positive update count")
        super().__init__(factor, floor=stop_factor_lr)
        self.step = step

    def _events_before(self, num_update):
        # an event fires when num_update exceeds k*step for k = 1, 2, ...
        return max(0, (int(num_update) - 1) // self.step)


class MultiFactorScheduler(_DecayCountScheduler):
    """Decay at an explicit increasing list of update milestones."""

    def __init__(self, step, factor=1):
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError("milestones must be positive update counts")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("milestones must be strictly increasing")
        super().__init__(factor)
        self.step = step

    def _events_before(self, num_update):
        return sum(1 for s in self.step if num_update > s)


class PolyScheduler(LRScheduler):
    """Polynomial decay from the constructed base rate to zero over
    ``max_update`` updates: lr(t) = lr0 * (1 - t/T)^pwr for t <= T."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError("max_update must be a positive integer")
        self._lr0 = base_lr
        self.max_update = max_update
        self.power = pwr

    def __call__(self, num_update):
        t = min(float(num_update), float(self.max_update))
        self.base_lr = self._lr0 * (1.0 - t / self.max_update) ** self.power
        return self.base_lr

"""SLO-class admission scheduling for the generation engine.

Counterpart of ``mxnet_tpu/serving/control/slo.py``, plain Python and the
same behaviour: :class:`SLOClass` is a named (priority tier, queue
deadline) pair a request is submitted under; :class:`ClassQueue` keeps
per-class FIFO queues and selects by priority plus aging (one tier per
``aging_ms`` of head wait), so higher tiers preempt queue order only, never
in-flight decode slots, and a starved class climbs until it wins;
queue-expired requests are shed before prefill.

The queue is not thread-safe: the engine holds its condition lock around
every call (``guarded-by: Generator._cond``).
"""
from __future__ import annotations

__all__ = ["SLOClass", "ClassQueue", "resolve_class", "BUILTIN_CLASSES"]


class SLOClass:
    """One service tier: ``priority`` orders admission (higher wins),
    ``deadline_ms`` bounds queue wait (None defers to the engine's
    ``MXNET_GEN_DEADLINE_MS`` default; 0 = never expire)."""

    __slots__ = ("name", "priority", "deadline_ms")

    def __init__(self, name, priority=0, deadline_ms=None):
        self.name = str(name)
        self.priority = int(priority)
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        if self.deadline_ms is not None and self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0 (0 = no deadline)")

    def __repr__(self):
        return ("SLOClass(%r, priority=%d, deadline_ms=%r)"
                % (self.name, self.priority, self.deadline_ms))


# the three tiers most deployments start from; submit(slo="interactive")
# resolves here, and custom SLOClass instances work anywhere a name does
BUILTIN_CLASSES = {
    "interactive": SLOClass("interactive", priority=10),
    "standard": SLOClass("standard", priority=0),
    "batch": SLOClass("batch", priority=-10),
}
DEFAULT_CLASS = BUILTIN_CLASSES["standard"]


def resolve_class(slo):
    """``None`` -> the standard tier; a name -> the builtin tier; an
    :class:`SLOClass` passes through."""
    if slo is None:
        return DEFAULT_CLASS
    if isinstance(slo, SLOClass):
        return slo
    cls = BUILTIN_CLASSES.get(str(slo))
    if cls is None:
        raise ValueError("unknown SLO class %r (builtins: %s; or pass an "
                         "SLOClass)" % (slo, sorted(BUILTIN_CLASSES)))
    return cls


class ClassQueue:
    """Per-SLO-class FIFO queues with priority + aging selection.

    Entries are any objects carrying ``slo`` (an :class:`SLOClass`),
    ``t_submit`` (monotonic seconds) and ``deadline`` (absolute
    monotonic seconds or None). Selection picks the head of the class
    with the highest *effective* priority — ``priority`` plus one tier
    per ``aging_ms`` of head wait — tie-broken by earliest submit, so
    equal-priority classes interleave FIFO and a starved class climbs
    one tier per aging interval until it wins.
    """

    def __init__(self, aging_ms=0):
        import collections

        self.aging_ms = float(aging_ms)
        self._deques = collections.OrderedDict()  # class name -> deque
        self._classes = {}                        # class name -> SLOClass
        self._make = collections.deque
        self._n = 0

    def __len__(self):
        return self._n

    def __bool__(self):
        return self._n > 0

    def push(self, entry):
        cls = entry.slo
        dq = self._deques.get(cls.name)
        if dq is None:
            dq = self._deques[cls.name] = self._make()
        # latest class object wins the name: a re-tuned SLOClass takes
        # effect for selection without draining the queue first
        self._classes[cls.name] = cls
        dq.append(entry)
        self._n += 1

    def _effective(self, cls, head, now):
        boost = 0
        if self.aging_ms > 0:
            boost = int(max(0.0, (now - head.t_submit) * 1e3)
                        / self.aging_ms)
        return cls.priority + boost

    def select(self, now):
        """The entry weighted admission would dispatch next (peek — the
        caller commits with :meth:`pop` once pool admission clears)."""
        best, best_key = None, None
        for name, dq in self._deques.items():
            if not dq:
                continue
            head = dq[0]
            key = (self._effective(self._classes[name], head, now),
                   -head.t_submit)
            if best_key is None or key > best_key:
                best, best_key = head, key
        return best

    def pop(self, entry):
        """Commit a :meth:`select` choice (must still be its class
        head — selection and pop happen under one lock hold)."""
        dq = self._deques.get(entry.slo.name)
        if not dq or dq[0] is not entry:
            raise ValueError("pop of a non-head entry (select/pop must "
                             "happen under one lock hold)")
        dq.popleft()
        self._n -= 1
        return entry

    def shed_expired(self, now):
        """Remove and return every queue-expired entry (deadline before
        ``now``). Per-class FIFO + a single per-class deadline bound
        make deadlines monotone within a class, but entries submitted
        with heterogeneous SLOClass objects under one name are not —
        so scan whole deques, preserving order among survivors."""
        expired = []
        for name, dq in self._deques.items():
            if not dq:
                continue
            keep = self._make()
            dead = []
            for ent in dq:
                if ent.deadline is not None and now >= ent.deadline:
                    dead.append(ent)
                else:
                    keep.append(ent)
            if dead:
                self._deques[name] = keep
                expired.extend(dead)
        self._n -= len(expired)
        return expired

    def drain(self):
        """Remove and return everything (abort/shutdown paths)."""
        out = []
        for dq in self._deques.values():
            out.extend(dq)
            dq.clear()
        self._n = 0
        return out

    def depths(self):
        """{class name: queued count} for metrics//statusz — every class
        ever seen, INCLUDING empty ones (a gauge that is never written
        back to 0 reads stale forever)."""
        return {name: len(dq) for name, dq in self._deques.items()}

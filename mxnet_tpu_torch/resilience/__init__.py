"""Fault tolerance: the counterpart of ``mxnet_tpu/resilience/``.

* :mod:`.faults` — deterministic fault injection: call sites declare
  named points (``serving.replica_execute``, ``checkpoint.write``) that
  are no-ops by default and, under a seeded ``MXNET_FAULTS`` spec,
  deterministically drop/delay/raise.
* :mod:`.retry` — the retry primitive (exponential backoff + jitter,
  attempt- and deadline-capped, per-policy telemetry).
* :mod:`.checkpoint` / :mod:`.preemption` — SIGTERM-safe training:
  finish the in-flight step, write an atomic checksummed resumable
  checkpoint (params + optimizer state + random generators + position +
  recorder ring), and ``fit(resume=dir)`` restarts from the newest
  *valid* one.
* Serving failover lives in :mod:`..serving`: per-request deadlines
  (:class:`DeadlineExceeded`) and a replica circuit breaker with cooldown
  re-admission.
"""
from ..base import MXNetError


class DeadlineExceeded(MXNetError):
    """A request's per-request deadline (``MXNET_SERVING_DEADLINE_MS``)
    expired while it was still queued — rejected before dispatch so a
    backlogged server sheds load instead of serving answers nobody is
    waiting for anymore."""


class BarrierTimeoutError(MXNetError):
    """A kvstore barrier timed out server-side. ``diagnostics`` carries
    the server's view: how many workers arrived, per-worker last-contact
    ages, and which ranks look dead."""

    def __init__(self, message, diagnostics=None):
        self.diagnostics = dict(diagnostics or {})
        super().__init__(message)


from . import faults  # noqa: E402
from . import retry  # noqa: E402
from . import checkpoint  # noqa: E402
from . import preemption  # noqa: E402
from .faults import InjectedDrop, InjectedFault  # noqa: E402
from .retry import RetryPolicy, RetryExhaustedError  # noqa: E402
from .checkpoint import save_resumable, load_latest  # noqa: E402
from .preemption import PreemptedError, PreemptionGuard  # noqa: E402

__all__ = ["faults", "retry", "checkpoint", "preemption",
           "DeadlineExceeded", "BarrierTimeoutError",
           "InjectedFault", "InjectedDrop",
           "RetryPolicy", "RetryExhaustedError",
           "save_resumable", "load_latest",
           "PreemptedError", "PreemptionGuard"]

# the injected-faults section rides every crash dump (providers run
# best-effort; None when no spec is active keeps clean dumps clean)
from ..observability import flight_recorder as _flight_recorder  # noqa: E402

_flight_recorder.register_provider("faults", faults._recorder_section)

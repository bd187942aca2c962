"""Crash flight recorder: a ring buffer of records that dumps one
self-contained triage file when a run goes bad.

Counterpart of ``mxnet_tpu/observability/flight_recorder.py``. The dump
bundles

* the last-K records (:func:`record`; anomaly flags mark the bad ones),
* a metrics-registry snapshot (Prometheus text, when telemetry is on),
* the tail of the profiler's span buffer (profiler.py),
* an env/config fingerprint (MXNET_* env, config overrides, the torch
  and CUDA versions and the card, argv),
* provider sections (e.g. the serving engine's live ``get_stats()``,
  registered as ``"serving"``, and the injected-faults section),

into one JSON file written atomically (temp file + rename) so a
concurrent reader never sees truncated JSON.

Dumps fire on demand (:func:`dump`), on anomaly (:func:`dump_on_anomaly`,
throttled), and — once :func:`install` armed the hooks, as in the JAX
package — on an uncaught exception, on SIGTERM/SIGINT and at interpreter
exit when an anomaly was recorded after the last dump.

Knobs: ``MXNET_HEALTH_RING`` (ring capacity, default 256, via
config.get_flag) and ``MXNET_HEALTH_DUMP_DIR`` (dump directory, default
``health_dumps/`` under the working directory; env-only string).
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import threading
import time

__all__ = ["record", "snapshot", "dump", "dump_on_anomaly", "install",
           "configure", "register_provider", "provider_sections",
           "last_dump_path", "reset"]

_lock = threading.Lock()
_ring = None            # deque of step records  # guarded-by: _lock
_dump_dir = None        # resolved dump directory  # guarded-by: _lock
_seq = 0                # records ever written  # guarded-by: _lock
_anomaly_seq = 0        # seq of the latest anomalous record  # guarded-by: _lock
_dumped_seq = 0         # seq high-water at the last dump (0 = nothing
                        # recorded yet, so a clean run never looks
                        # "undumped" to atexit)  # guarded-by: _lock
_dump_count = 0         # dumps written (filename uniquifier)  # guarded-by: _lock
_last_dump = None       # (path, monotonic ts) of the last dump  # guarded-by: _lock
_providers = {}         # name -> zero-arg callable  # guarded-by: _lock
_installed = False      # excepthook/atexit armed  # guarded-by: _lock
_prev_excepthook = None
_prev_signals = {}      # signum -> previous handler (chained)

# at most one anomaly dump per this many seconds: a run stuck at NaN must
# not grind itself to death re-serializing the same story every step
_ANOMALY_DUMP_INTERVAL_S = 60.0


def _ring_capacity():
    from ..config import get_flag

    return max(8, get_flag("MXNET_HEALTH_RING"))


def configure(ring=None, dump_dir=None):
    """Runtime overrides for ring capacity / dump directory (tests, or a
    launcher pointing dumps at durable storage)."""
    global _ring, _dump_dir
    with _lock:
        if ring is not None:
            old = list(_ring) if _ring is not None else []
            _ring = collections.deque(old[-int(ring):], maxlen=int(ring))
        if dump_dir is not None:
            _dump_dir = dump_dir


def reset():
    """Drop all records, dump bookkeeping, and the runtime dump-dir
    override (tests) — the MXNET_HEALTH_DUMP_DIR env governs again."""
    global _ring, _seq, _anomaly_seq, _dumped_seq, _last_dump, _dump_dir
    with _lock:
        _ring = None
        _seq = 0
        _anomaly_seq = 0
        _dumped_seq = 0
        _last_dump = None
        _dump_dir = None


def record(rec, anomaly=False):
    """Append one per-step record (a JSON-safe dict) to the ring."""
    global _ring, _seq, _anomaly_seq
    rec = dict(rec)
    rec["ts"] = time.time()
    with _lock:
        if _ring is None:   # lazy so MXNET_HEALTH_RING is read at use
            _ring = collections.deque(maxlen=_ring_capacity())
        _seq += 1
        rec["seq"] = _seq
        if anomaly:
            rec["anomaly"] = True
            _anomaly_seq = _seq
        _ring.append(rec)


def snapshot():
    """Chronological copy of the ring contents."""
    with _lock:
        return list(_ring) if _ring is not None else []


def register_provider(name, fn):
    """Attach a named zero-arg callable whose (JSON-safe) return value is
    embedded in every dump — e.g. the serving engine's live stats.
    Providers run best-effort: a raising/dead provider becomes an
    ``"error"`` entry, never a failed dump."""
    with _lock:
        _providers[name] = fn


def last_dump_path():
    with _lock:
        return _last_dump[0] if _last_dump else None


def _env_fingerprint():
    env = {k: v for k, v in os.environ.items()
           if k.startswith(("MXNET_", "CUDA_", "TORCH_"))}
    from .. import config as _config

    fp = {"env": env, "config_overrides": dict(_config._overrides),
          "argv": list(sys.argv), "python": sys.version.split()[0],
          "pid": os.getpid()}
    try:
        import torch

        fp["torch"] = {"version": torch.__version__,
                       "cuda": torch.version.cuda,
                       "device_count": torch.cuda.device_count()}
        if torch.cuda.is_available():
            fp["torch"]["card"] = torch.cuda.get_device_name()
    except Exception as err:
        fp["torch"] = {"error": repr(err)}
    return fp


def _metrics_snapshot():
    from . import metrics

    if not metrics.enabled():
        return None
    try:
        return metrics.dump_metrics()
    except Exception as err:
        return "error: %r" % (err,)


def _spans_tail(n=256):
    try:
        from .. import profiler

        return profiler.events_tail(n)
    except Exception:
        return []


def _provider_sections():
    with _lock:
        providers = dict(_providers)
    out = {}
    for name, fn in providers.items():
        try:
            val = fn()
        except Exception as err:
            val = {"error": repr(err)}
        if val is not None:
            out[name] = val
    return out


# public alias: the live provider sections a crash dump embeds
provider_sections = _provider_sections


def _json_safe(obj):
    """Best-effort JSON coercion so one exotic value (numpy scalar, a
    tensor) cannot sink the dump that was supposed to explain the crash."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        pass
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if hasattr(obj, "item"):
        try:
            return obj.item()
        except Exception:
            pass
    return repr(obj)


def dump(reason="on-demand", path=None):
    """Write the triage file atomically; returns its path."""
    global _dump_count, _dumped_seq, _last_dump
    try:
        # pull any warn-mode lag-1 health stash into the ring first, so
        # the dump covers the very last guarded step (allow_dump=False:
        # the flush must not recurse into a second dump)
        from . import health

        health.flush(allow_dump=False)
    except Exception:
        pass
    with _lock:
        records = list(_ring) if _ring is not None else []
        _dump_count += 1
        n = _dump_count
        seq_now = _seq
        out_dir = (_dump_dir or os.environ.get("MXNET_HEALTH_DUMP_DIR")
                   or "health_dumps")
    payload = {
        "version": 1,
        "reason": str(reason),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "records": records,
        "metrics": _metrics_snapshot(),
        "spans_tail": _spans_tail(),
        "fingerprint": _env_fingerprint(),
        "providers": _provider_sections(),
    }
    if path is None:
        try:
            os.makedirs(out_dir, exist_ok=True)
        except OSError:
            out_dir = "."
        path = os.path.join(
            out_dir, "health_dump_%d_%03d.json" % (os.getpid(), n))
    # temp+rename: a reader racing a dying process never sees a
    # truncated file
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), threading.get_ident())
    try:
        encoded = json.dumps(payload)
    except (TypeError, ValueError):
        # only pay the recursive coercion when something exotic (numpy
        # scalar, a tensor) actually slipped into the payload
        encoded = json.dumps(_json_safe(payload))
    with open(tmp, "w") as f:
        f.write(encoded)
    os.replace(tmp, path)
    with _lock:
        _dumped_seq = max(_dumped_seq, seq_now)
        _last_dump = (path, time.monotonic())
    return path


def dump_on_anomaly(reason):
    """Anomaly-triggered dump, rate-limited to one per
    ``_ANOMALY_DUMP_INTERVAL_S``. Returns the fresh dump's path, or None
    when throttled — a recent file does NOT contain this anomaly's
    record, so no path is claimed for it; the still-undumped anomaly is
    covered by the next dump or the atexit safety net."""
    with _lock:
        recent = (_last_dump is not None and
                  time.monotonic() - _last_dump[1] < _ANOMALY_DUMP_INTERVAL_S)
    if recent:
        return None
    try:
        return dump(reason)
    except Exception:
        # the recorder must never turn an anomaly into a second failure
        return None


def _excepthook(exc_type, exc, tb):
    try:
        dump("uncaught:%s: %s" % (exc_type.__name__, exc))
    except Exception:
        pass
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _signal_handler(signum, frame):
    """SIGTERM/SIGINT chain link: dump (same 60s throttle as anomaly
    dumps — a signal storm must not grind the dying process), then hand
    the signal on. Preemptions used to bypass the excepthook/atexit
    paths entirely, losing exactly the dumps that matter most."""
    import signal as _signal

    try:
        name = _signal.Signals(signum).name
    except (ValueError, AttributeError):
        name = str(signum)
    # reentrancy probe: the handler interrupts the MAIN thread, which
    # may be inside a `with _lock:` section — a blocking dump() would
    # then deadlock the dying process inside its own crash handler.
    # The suspended main thread can never release while we run, so a
    # short timed acquire either proves the lock is safe (another
    # thread holding it will release) or tells us to skip the dump.
    if _lock.acquire(timeout=0.25):
        _lock.release()
        try:
            dump_on_anomaly("signal:%s" % name)
        except Exception:
            pass
    prev = _prev_signals.get(signum)
    if callable(prev):
        prev(signum, frame)
    elif prev == _signal.SIG_DFL:
        # restore the default and re-deliver so the process dies with
        # the conventional signal status (the dump already landed)
        try:
            _signal.signal(signum, _signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        os.kill(os.getpid(), signum)
    # SIG_IGN: swallowed, matching the pre-install behavior


def _install_signal_hooks():
    """Chain SIGTERM/SIGINT (main thread only — signal.signal raises
    elsewhere, and a library must not steal handlers from a host that
    runs us in a worker thread)."""
    import signal as _signal

    for sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            _prev_signals[sig] = _signal.signal(sig, _signal_handler)
        except (ValueError, OSError):
            return


def _atexit_flush():
    # safety net: an anomaly was recorded after the last dump and the
    # process is exiting without an uncaught exception (swallowed error,
    # orderly-but-broken shutdown) — flush the story before it is lost
    try:
        from . import health

        health.flush(allow_dump=False)
    except Exception:
        pass
    with _lock:
        pending = _anomaly_seq > _dumped_seq
    if pending:
        try:
            dump("atexit:undumped-anomaly")
        except Exception:
            pass


def install(dump_dir=None):
    """Arm the crash hooks (idempotent): chain ``sys.excepthook`` so an
    uncaught exception dumps before the traceback prints, chain
    SIGTERM/SIGINT so preemptions dump before dying (throttled; skipped
    off the main thread), and register the atexit flush. Nothing calls it
    at import: a program that wants crash dumps calls it once."""
    global _installed, _prev_excepthook
    if dump_dir is not None:
        configure(dump_dir=dump_dir)
    with _lock:
        if _installed:
            return
        _installed = True
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    _install_signal_hooks()
    atexit.register(_atexit_flush)

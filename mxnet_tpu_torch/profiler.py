"""Profiler (reference: python/mxnet/profiler.py:27-55,
src/engine/profiler.cc — per-op chrome://tracing JSON).

Counterpart of ``mxnet_tpu/profiler.py``. Two layers in one dump:

1. **Framework events** — while a session runs, the executor records one
   event per program run (``forward`` / ``forward_backward``, mode
   ``symbolic`` or ``all``) and the phase spans of
   :func:`~.observability.tracing.trace_span` (fit-loop step, update,
   trainer step, autograd backward, a Gluon cached op) record in any mode;
   finished request traces add their phases (cat ``request``). Host
   timestamps in microseconds since this module's import.
2. **Device records** — ``set_state('run')`` also starts a
   ``torch.profiler`` session (CUDA activity when a card is present).
   :func:`dump_profile` merges its kernel records (cat ``kernel``, one
   chrome row per stream) into the same JSON, shifted onto the host
   timeline through a marker recorded at the session's start. In mode
   ``imperative`` or ``all`` the session's host op records (cat ``op``)
   join them: the eager op dispatch of the reference's imperative
   profiler.

The dump states how many kernel records it holds (``kernelRecords``) and
how many of them each kernel name has (``kernelRecordsByName``), so a
trace that lost records is visible beside a wrapper's launch count.

The initial mode can be set from the environment (``MXNET_PROFILER_MODE``)
so unmodified scripts can be traced. All state transitions take the
module lock, and ``dump_profile()`` writes via temp file + atomic rename
so a concurrent reader never observes truncated JSON.

The event buffer is a bounded ring (``MXNET_PROFILER_RING`` events,
default 200k). When the ring is full the OLDEST event is dropped and
counted: :func:`dropped_events`, the ``profiler.events_dropped`` metric
and a ``droppedEventsCount`` field in the dump expose the loss.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "pause", "resume", "events_tail", "record", "record_raw",
           "dropped_events", "configure_ring"]

_VALID_MODES = ("symbolic", "imperative", "all")
_MARKER = "mxnet::profiler_start"


def _env_mode():
    mode = os.environ.get("MXNET_PROFILER_MODE", "symbolic")
    return mode if mode in _VALID_MODES else "symbolic"


_state = {"mode": _env_mode(), "filename": "profile.json", "running": False,
          "paused": False}  # guarded-by: _lock
_events = collections.deque()  # bounded ring, manual cap  # guarded-by: _lock
_ring_cap = None  # resolved lazily from MXNET_PROFILER_RING  # guarded-by: _lock
_dropped = 0  # events evicted from the full ring  # guarded-by: _lock
_lock = threading.Lock()
_trace_lock = threading.Lock()  # serializes torch.profiler start/stop
_session = None   # (torch.profiler.profile, marker host us)  # guarded-by: _trace_lock
_finished = None  # the last stopped session, read by dump_profile  # guarded-by: _trace_lock
_t0 = time.perf_counter()


def _now_us():
    return (time.perf_counter() - _t0) * 1e6


def imperative_active():
    return (_state["running"] and not _state["paused"]
            and _state["mode"] in ("imperative", "all"))


def symbolic_active():
    return (_state["running"] and not _state["paused"]
            and _state["mode"] in ("symbolic", "all"))


def spans_active():
    """Phase spans (observability.trace_span) record in any mode while
    the session runs."""
    return _state["running"] and not _state["paused"]


def _cap_locked():
    # caller holds _lock
    global _ring_cap
    if _ring_cap is None:
        from .config import get_flag

        _ring_cap = max(1024, get_flag("MXNET_PROFILER_RING"))
    return _ring_cap


def configure_ring(capacity=None):
    """Runtime override of the event-ring capacity (tests; None restores
    the MXNET_PROFILER_RING flag resolution). Excess oldest events are
    evicted (and counted) immediately."""
    global _ring_cap
    evicted = 0
    with _lock:
        _ring_cap = None if capacity is None else max(1, int(capacity))
        cap = _cap_locked()
        while len(_events) > cap:
            _events.popleft()
            evicted += 1
        _count_dropped_locked(evicted)
    _note_dropped_metric(evicted)


def _count_dropped_locked(n):
    # caller holds _lock
    global _dropped
    _dropped += n


def _note_dropped_metric(n):
    if not n:
        return
    try:
        from .observability import metrics as _metrics

        _metrics.counter(
            "profiler.events_dropped",
            help="profiler ring evictions (trace tail truncated)").inc(n)
    except Exception:  # the ring must keep working during teardown
        pass


def dropped_events():
    """How many events the bounded ring has evicted since the last
    ``dump_profile`` (0 = the current buffer is complete; the
    ``profiler.events_dropped`` metric keeps the cumulative count)."""
    with _lock:
        return _dropped


def _append(ev):
    with _lock:
        dropped = len(_events) >= _cap_locked()
        if dropped:
            _events.popleft()
            _count_dropped_locked(1)
        _events.append(ev)
    if dropped:
        _note_dropped_metric(1)


def record(name, cat, ts_us, dur_us, args=None, tid=None):
    """Append one complete ('ph':'X') event. ``args`` rides into the
    chrome JSON verbatim (request tracing stores trace ids there);
    ``tid`` overrides the recording thread's id."""
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": ts_us, "dur": dur_us,
          "pid": os.getpid(),
          "tid": (threading.get_ident() % (1 << 20)
                  if tid is None else int(tid))}
    if args:
        ev["args"] = dict(args)
    _append(ev)


def record_raw(ev):
    """Append one pre-built chrome-trace event dict (flow events,
    instant events — phases the 'X' shape cannot express)."""
    _append(dict(ev))


def events_tail(n=256):
    """Copy of the most recent ``n`` recorded events (the flight
    recorder embeds this tail in its crash dump); O(n) under the lock."""
    import itertools

    with _lock:
        tail = list(itertools.islice(reversed(_events), max(0, int(n))))
    tail.reverse()
    return tail


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """(reference: profiler.py:profiler_set_config); mode is 'symbolic',
    'imperative', or 'all'."""
    if mode not in _VALID_MODES:
        raise ValueError("mode must be symbolic/imperative/all, got %r"
                         % (mode,))
    with _lock:
        _state["mode"] = mode
        _state["filename"] = filename


def _start_device_trace():
    """A torch.profiler session with CUDA activity where a card is
    present, and the host time of its start marker."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    with record_function(_MARKER):
        marker_us = _now_us()
    return prof, marker_us


def profiler_set_state(state="stop"):
    """(reference: profiler.py:profiler_set_state); 'run' starts
    recording (+ a torch.profiler device trace), 'stop' ends it."""
    global _session, _finished
    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop', got %r"
                         % (state,))
    with _lock:
        if state == "run" and not _state["running"]:
            _state["running"] = True
            _state["paused"] = False
        elif state == "stop" and _state["running"]:
            _state["running"] = False
        else:
            return
    # the torch.profiler calls run outside _lock (starting CUPTI takes
    # tens of ms and must not serialize against record()) but under
    # _trace_lock, so a stop racing a start cannot leak a session
    with _trace_lock:
        if state == "run":
            if _session is None:
                try:
                    _session = _start_device_trace()
                except Exception:  # device trace best-effort
                    _session = None
                _finished = None
        elif _session is not None:
            prof, marker_us = _session
            _session = None
            try:
                prof.stop()
                _finished = (prof, marker_us)
            except Exception:
                _finished = None


def pause():
    """Suspend event recording without ending the session
    (reference: profiler.py pause)."""
    with _lock:
        _state["paused"] = True


def resume():
    """(reference: profiler.py resume)"""
    with _lock:
        _state["paused"] = False


def _device_events(session, mode):
    """Chrome events of a stopped torch.profiler session on the host
    timeline: kernel records always, host op records in the imperative
    modes."""
    if session is None:
        return []
    import torch

    prof, marker_us = session
    try:
        events = prof.events()
    except Exception:
        return []
    cuda = torch.autograd.DeviceType.CUDA
    marker = [e.time_range.start for e in events
              if e.device_type != cuda and e.name == _MARKER]
    shift = marker_us - marker[0] if marker else 0.0
    ops = mode in ("imperative", "all")
    pid = os.getpid()
    out = []
    for e in events:
        if e.device_type == cuda:
            cat, ev_pid = "kernel", "gpu%d" % max(0, e.device_index)
        elif ops and e.name != _MARKER:
            cat, ev_pid = "op", pid
        else:
            continue
        out.append({"name": e.name, "cat": cat, "ph": "X",
                    "ts": e.time_range.start + shift,
                    "dur": e.time_range.elapsed_us(),
                    "pid": ev_pid, "tid": int(e.thread) % (1 << 20)})
    return out


def dump_profile():
    """Stop profiling and write the chrome://tracing JSON
    (reference: profiler.py:dump_profile → DumpProfile,
    src/engine/profiler.h:107): the host events, the session's device
    records, ``kernelRecords`` and, when the ring dropped events,
    ``droppedEventsCount``. The write is atomic (temp file + rename)."""
    global _dropped, _finished
    profiler_set_state("stop")
    with _trace_lock:
        session, _finished = _finished, None
    with _lock:
        events = list(_events)
        _events.clear()
        filename = _state["filename"]
        mode = _state["mode"]
        # the dump consumes the loss: dropped counts what THIS artifact
        # is missing (the events_dropped metric stays cumulative)
        dropped, _dropped = _dropped, 0
    device = _device_events(session, mode)
    kernels = collections.Counter(ev["name"] for ev in device
                                  if ev["cat"] == "kernel")
    payload = {"traceEvents": events + device, "displayTimeUnit": "ms",
               "kernelRecords": sum(kernels.values()),
               "kernelRecordsByName": dict(kernels)}
    if dropped:
        # non-standard but chrome-ignored: makes ring truncation visible
        # in the artifact itself, not just the live process
        payload["droppedEventsCount"] = dropped
    tmp = "%s.tmp.%d.%d" % (filename, os.getpid(), threading.get_ident())
    with open(tmp, "w") as f:
        f.write(json.dumps(payload))
    os.replace(tmp, filename)
    return filename


# aliased modern names
set_config = profiler_set_config
set_state = profiler_set_state

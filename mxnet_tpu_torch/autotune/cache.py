"""Persistent per-device tuning cache — the "nobody pays the search twice"
half of the autotuner.

Counterpart of ``mxnet_tpu/autotune/cache.py`` with the same JSON format
and key scheme. One JSON file maps ``(device fingerprint, op,
shape-bucket, dtype)`` to the winning candidate of a measured search.
Consumers (the kernel wrappers' tile resolution, the executor's remat
decision, the layout pass, ``serving.InferenceServer``'s bucket ladder,
the Generator, the streaming input pipeline) call :func:`lookup` when
they build their program, region or object: a hit costs one dict probe, a
miss falls back to the hand-picked default. What a kernel wrapper or a
program resolves it keeps in a :class:`Carry`, which the cache empties
when its entries change (a record, save, reload, reset or scrub) or a
tuning flag is set (``config.set_flag``), so a new entry takes effect at
the next resolution. The tuners of :mod:`.tuners` write
entries after a measured search; :func:`record` writes one by hand.

File protocol:

* Path: ``MXNET_TUNE_CACHE`` env, else
  ``$XDG_CACHE_HOME/mxnet_tpu_torch/tuning.json`` (``~/.cache``
  fallback) — the port's own file, beside the JAX package's.
* Writes are atomic (temp file + ``os.replace``) and **merge-on-write**:
  the writer re-reads the file and unions it with its own entries before
  renaming, so two concurrent writers both land. Last-writer-wins per
  key.
* The device fingerprint is part of the key (``cuda:<card name>`` or
  ``cpu:cpu``), so an entry measured on another chip — a TPU entry of the
  JAX package included — never resolves here; :func:`scrub_stale`
  physically drops foreign entries. A file written by either package
  loads in the other.

Counters (:func:`stats`): ``hits`` / ``misses`` / ``measurements`` /
``searches`` / ``records`` — the regression surface for "a warm cache
performs zero search measurements" and for "a steady-state step performs
zero lookups".
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import weakref

__all__ = ["cache_path", "device_fingerprint", "lookup", "lookup_entry",
           "record", "save", "entries", "reload", "reset", "scrub_stale",
           "stats", "reset_stats", "note_measurements", "note_search",
           "Carry", "drop_carried"]

_lock = threading.RLock()
_entries = None          # key -> entry dict; None = not loaded  # guarded-by: _lock
_loaded_path = None      # path _entries came from  # guarded-by: _lock
_stats = {"hits": 0, "misses": 0, "measurements": 0, "searches": 0,
          "records": 0}  # guarded-by: _lock
_fp_probe = None         # memoized backend probe  # guarded-by: _lock
_carries = weakref.WeakSet()  # every live Carry  # guarded-by: _lock

_VERSION = 1


def cache_path():
    """Resolved cache file path (``MXNET_TUNE_CACHE`` > XDG default)."""
    env = os.environ.get("MXNET_TUNE_CACHE")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "mxnet_tpu_torch", "tuning.json")


def device_fingerprint():
    """Stable id of the chip entries were measured on:
    ``cuda:<torch.cuda.get_device_name()>`` on a card, else ``cpu:cpu``.
    ``MXNET_TUNE_FINGERPRINT`` overrides (tests; or shipping one cache to
    a known fleet)."""
    global _fp_probe
    env = os.environ.get("MXNET_TUNE_FINGERPRINT")
    if env:
        return env
    with _lock:
        if _fp_probe is not None:
            return _fp_probe
    import torch

    probe = ("cuda:%s" % torch.cuda.get_device_name()
             if torch.cuda.is_available() else "cpu:cpu")
    with _lock:
        _fp_probe = probe
    return probe


def _canon(key):
    """Deterministic string form of a shape-bucket key (str / scalars /
    nested tuples / dicts of those)."""
    if isinstance(key, str):
        return key
    if isinstance(key, dict):
        return ",".join("%s=%s" % (k, _canon(key[k])) for k in sorted(key))
    if isinstance(key, (list, tuple)):
        return ",".join(_canon(k) for k in key)
    return str(key)


def _full_key(op, key, dtype, fingerprint=None):
    fp = fingerprint or device_fingerprint()
    return "|".join([fp, str(op), _canon(key), str(dtype or "-")])


def _mode():
    from ..config import get_flag

    return get_flag("MXNET_TUNE")


def _load_file(path):
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(payload, dict) or "entries" not in payload:
        return {}
    ent = payload["entries"]
    if not isinstance(ent, dict):
        return {}
    # drop non-dict entry bodies at the boundary: a hand-edited entry
    # must read as a miss everywhere (lookup, scrub, save), not crash
    return {k: v for k, v in ent.items() if isinstance(v, dict)}


def _ensure_loaded():
    # RLock: callers already inside `with _lock:` re-enter harmlessly
    global _entries, _loaded_path
    with _lock:
        path = cache_path()
        if _entries is None or _loaded_path != path:
            if _loaded_path not in (None, path):
                drop_carried()  # another file: what was carried is stale
            _entries = _load_file(path)
            _loaded_path = path
        return _entries


def lookup(op, key, dtype=None):
    """Tuned value for ``(device, op, key, dtype)`` or None: one dict
    probe on a loaded cache. Returns None without touching the cache when
    ``MXNET_TUNE=-1`` (bypass)."""
    if _mode() < 0:
        return None
    entry = lookup_entry(op, key, dtype)
    return entry.get("value") if entry else None


def lookup_entry(op, key, dtype=None):
    """Full cache entry dict (value + provenance) or None."""
    k = _full_key(op, key, dtype)
    with _lock:
        ent = _ensure_loaded()
        entry = ent.get(k)
        if entry is not None:
            _stats["hits"] += 1
        else:
            _stats["misses"] += 1
    return entry


def record(op, key, value, dtype=None, ms=None, trials=None, extra=None,
           persist=True):
    """Store a winner and (by default) persist the cache file. Returns
    the full entry."""
    fp = device_fingerprint()
    entry = {"value": value, "fingerprint": fp, "op": str(op),
             "key": _canon(key), "dtype": str(dtype or "-"),
             "time": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if ms is not None:
        entry["ms"] = round(float(ms), 4)
    if trials is not None:
        entry["trials"] = int(trials)
    if extra:
        entry.update(extra)
    k = _full_key(op, key, dtype, fingerprint=fp)
    with _lock:
        ent = _ensure_loaded()
        ent[k] = entry
        _stats["records"] += 1
        drop_carried()
    if persist:
        save()
    return entry


def _write_file(path, entries_dict):
    """The one atomic write protocol (makedirs + temp + os.replace)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), threading.get_ident())
    with open(tmp, "w") as f:
        json.dump({"version": _VERSION, "entries": entries_dict}, f,
                  indent=1, sort_keys=True)
    os.replace(tmp, path)


@contextlib.contextmanager
def _file_lock(path):
    """Advisory cross-process lock (POSIX flock on a sidecar .lock file)
    around the read-merge-write window, so two processes saving at the
    same instant cannot drop each other's entries. Degrades to a no-op
    where flock is unavailable — the atomic rename still guarantees
    readers never see a torn file."""
    lock_path = path + ".lock"
    try:
        import fcntl

        d = os.path.dirname(lock_path)
        if d:
            os.makedirs(d, exist_ok=True)
        lf = open(lock_path, "w")
    except Exception:
        yield
        return
    try:
        fcntl.flock(lf, fcntl.LOCK_EX)
        yield
    finally:
        try:
            fcntl.flock(lf, fcntl.LOCK_UN)
        finally:
            lf.close()


def save():
    """Atomic merge-on-write: union the on-disk entries with ours (ours
    win per key), temp+rename. The whole read-merge-write runs under the
    lock, so concurrent in-process tuners serialize and lose no entries;
    concurrent PROCESSES are covered by the re-read (their already-
    flushed entries merge in) plus each of their own subsequent saves."""
    global _entries, _loaded_path
    with _lock:
        path = cache_path()
        with _file_lock(path):
            merged = _load_file(path)
            merged.update(_ensure_loaded())
            _write_file(path, merged)
        _entries = merged
        _loaded_path = path
        drop_carried()
    return path


def entries():
    """Copy of the loaded entry map (tests/reporting)."""
    with _lock:
        return dict(_ensure_loaded())


def reload():
    """Force a re-read of the cache file (e.g. after another process
    wrote it)."""
    global _entries
    with _lock:
        _entries = None
        drop_carried()
        return dict(_ensure_loaded())


def reset():
    """Drop the in-memory cache and fingerprint probe (tests; simulates a
    fresh process — the file on disk is untouched)."""
    global _entries, _loaded_path, _fp_probe
    with _lock:
        _entries = None
        _loaded_path = None
        _fp_probe = None
        drop_carried()


class Carry:
    """Values a consumer resolved through the cache at its first use (a
    kernel wrapper's tile at a shape, a program's remat decision), kept
    with no cache lookup and no lock until :func:`drop_carried` empties
    every carry: a steady-state launch pays one dict probe. ``key`` must
    hold every input ``resolve`` reads besides the cache and the tuning
    flags (shape, dtype, explicit arguments)."""

    __slots__ = ("values", "__weakref__")

    def __init__(self):
        self.values = {}
        with _lock:
            _carries.add(self)

    def get(self, key, resolve):
        values = self.values  # a drop during resolve() leaves this dict
        try:
            return values[key]
        except KeyError:
            value = values[key] = resolve()
            return value


def drop_carried():
    """Empty every :class:`Carry`: the entries or a tuning flag changed,
    so the next use resolves again (the next launch at a shape, the next
    training walk); a CUDA graph keeps what it was captured with."""
    with _lock:
        for carry in list(_carries):
            carry.values = {}


def scrub_stale(persist=True):
    """Drop entries recorded under a different device fingerprint than the
    current one. Returns the number dropped. (The fingerprint is part of
    the key, so stale entries can never match; scrubbing reclaims the
    file.)

    With ``persist`` the write is a merge-then-scrub under the file lock:
    entries another process saved since we loaded survive (only
    foreign-fingerprint keys are dropped, from the merged map), the same
    lost-update discipline as :func:`save`."""
    global _entries, _loaded_path
    fp = device_fingerprint()

    def _is_stale(k, v):
        return v.get("fingerprint", k.split("|", 1)[0]) != fp

    with _lock:
        drop_carried()
        ent = _ensure_loaded()
        if not persist:
            stale = [k for k, v in ent.items() if _is_stale(k, v)]
            for k in stale:
                del ent[k]
            return len(stale)
        path = cache_path()
        with _file_lock(path):
            merged = _load_file(path)
            merged.update(ent)
            stale = [k for k, v in merged.items() if _is_stale(k, v)]
            for k in stale:
                del merged[k]
            _write_file(path, merged)
        _entries = merged
        _loaded_path = path
    return len(stale)


# ------------------------------------------------------------- accounting
def note_measurements(n=1):
    """Called by the search loop once per measured candidate — the
    counter the zero-measurement-on-warm-cache checks read."""
    with _lock:
        _stats["measurements"] += n
    from ..observability import metrics

    metrics.counter("autotune.measurements").inc(n)


def note_search():
    with _lock:
        _stats["searches"] += 1


def stats():
    """Copy of {hits, misses, measurements, searches, records}."""
    with _lock:
        return dict(_stats)


def reset_stats():
    with _lock:
        for k in _stats:
            _stats[k] = 0

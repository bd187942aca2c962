"""Built-in instruments: CUDA-graph captures and kernel builds, device
memory watermarks, per-step accounting.

Counterpart of ``mxnet_tpu/observability/instruments.py``. The JAX package
counts XLA compiles and retraces through ``jax.monitoring``; the port
compiles no graph. What takes their place:

* **Captures** — every ``cuda_graph.capture`` (a training step, a served
  bucket, a decode step) is counted with its signature key and capture
  time: ``cuda_graph.capture_count`` and ``cuda_graph.capture.ms`` under
  telemetry, :func:`captures` always. A steady-state loop shows a FLAT
  count. :func:`retrace_causes` keeps the most recent keys: what made a
  new graph.
* **Kernel builds** — each hand-written kernel library loaded at its
  first use (``cuda_build.build_all``: an ``nvcc`` run, or a library
  already built under ``_build/``): ``kernel.build_count`` /
  ``kernel.build.ms``, :func:`kernel_builds` always.
* **Memory watermarks** — :func:`sample_memory` reads the caching
  allocator (``torch.cuda.memory_allocated`` / ``max_memory_allocated``,
  the card's total as the limit) into the ``hbm.live_bytes`` /
  ``hbm.peak_bytes`` gauges; on the CPU the process RSS / VmHWM from
  /proc, and ``hbm.source`` says which (0 the card, 1 the host).
* **Step accounting** — :func:`record_step` feeds the ``step.ms``
  histogram and samples memory once per call.
"""
from __future__ import annotations

import collections
import os
import threading

from . import metrics

__all__ = ["note_capture", "note_kernel_build", "captures", "kernel_builds",
           "retrace_causes", "device_peak_bytes", "sample_memory",
           "record_step"]

_lock = threading.Lock()
_counts = {"captures": 0, "kernel_builds": 0}  # guarded-by: _lock
_capture_keys = collections.deque(maxlen=32)   # guarded-by: _lock


def note_capture(key, seconds):
    """One CUDA-graph capture of signature ``key`` that took ``seconds``
    (warm-up runs included)."""
    with _lock:
        _counts["captures"] += 1
        _capture_keys.append(str(key))
    if metrics.enabled():
        metrics.counter("cuda_graph.capture_count").inc()
        metrics.histogram("cuda_graph.capture.ms").observe(seconds * 1e3)


def note_kernel_build(name, seconds, built):
    """One kernel library loaded at its first use: ``built`` when nvcc
    ran, else a library found built."""
    with _lock:
        _counts["kernel_builds"] += 1
    if metrics.enabled():
        metrics.counter("kernel.build_count",
                        labels={"nvcc": "1" if built else "0"}).inc()
        metrics.histogram("kernel.build.ms").observe(seconds * 1e3)


def captures():
    """CUDA-graph captures in this process."""
    with _lock:
        return _counts["captures"]


def kernel_builds():
    """Kernel libraries loaded (built or found built) in this process."""
    with _lock:
        return _counts["kernel_builds"]


def retrace_causes():
    """The signature keys of the most recent captures, oldest first."""
    with _lock:
        return list(_capture_keys)


def _host_memory():
    """(live_bytes, peak_bytes) of this process from /proc — the fallback
    on the CPU."""
    live = peak = 0
    try:
        page = os.sysconf("SC_PAGE_SIZE")
        with open("/proc/self/statm") as f:
            live = int(f.read().split()[1]) * page  # resident pages
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024
                    break
    except Exception:
        pass
    return live, max(peak, live)


def _cuda_device(context):
    import torch

    if not torch.cuda.is_available():
        return None
    if context is not None:
        dev = getattr(context, "device_type", None)
        if dev is not None and dev != "gpu":
            return None
        return torch.device("cuda", getattr(context, "device_id", 0))
    return torch.device("cuda", torch.cuda.current_device())


def device_peak_bytes(context=None):
    """Ungated peak-memory read: the caching allocator's peak (the value
    ``torch.cuda.max_memory_allocated`` returns) on a card, the process
    VmHWM otherwise; None when nothing is readable.
    The health layer's per-step records read it without MXNET_TELEMETRY."""
    try:
        dev = _cuda_device(context)
        if dev is not None:
            import torch

            # the allocator's nested stats: ``max_memory_allocated``
            # flattens the whole table first (~0.5 ms a call)
            stats = torch.cuda.memory_stats_as_nested_dict(dev)
            return int(stats["allocated_bytes"]["all"]["peak"])
    except Exception:
        pass
    _live, peak = _host_memory()
    return peak or None


def sample_memory(context=None):
    """Record device-memory gauges: ``hbm.live_bytes`` (point-in-time)
    and ``hbm.peak_bytes`` (watermark across samples). Honors the
    MXNET_TELEMETRY_MEMSTATS flag (on by default under telemetry);
    returns the live-bytes sample, or None when disabled."""
    if not metrics.enabled():
        return None
    from ..config import get_flag

    if not get_flag("MXNET_TELEMETRY_MEMSTATS"):
        return None
    dev = None
    try:
        dev = _cuda_device(context)
    except Exception:
        dev = None
    if dev is not None:
        import torch

        live = int(torch.cuda.memory_allocated(dev))
        peak = int(torch.cuda.max_memory_allocated(dev))
        metrics.gauge("hbm.limit_bytes").set(
            torch.cuda.get_device_properties(dev).total_memory)
        metrics.gauge("hbm.source").set(0)
    else:
        live, peak = _host_memory()
        metrics.gauge("hbm.source").set(1)
    metrics.gauge("hbm.live_bytes").set(live)
    metrics.gauge("hbm.peak_bytes").set_max(peak)
    return live


def record_step(seconds, context=None):
    """Per-optimization-step accounting: step-time histogram + a memory
    sample. Call once per step from the training loop."""
    if not metrics.enabled():
        return
    metrics.counter("step.count").inc()
    metrics.histogram("step.ms").observe(seconds * 1e3)
    sample_memory(context)

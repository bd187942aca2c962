"""Active training-health layer: on-device numerical anomaly detection once
per step (no reference counterpart — the reference's answer to "why did
my run go bad" is MXNET_ENGINE_TYPE=NaiveEngine and a debugger).

Counterpart of ``mxnet_tpu/observability/health.py``. One call per
optimization step — :func:`guard_step` — does all of:

* **One segmented reduction** over every watched tensor (loss,
  gradients, parameters): per tensor the non-finite count, the
  finite-masked sum of squares and the finite-masked sum, fetched to the
  host as ONE (n, 3) array. The JAX package fuses this into one XLA
  program; a torch loop of ``isfinite`` / ``where`` / ``sum`` per tensor
  would launch ~5 kernels per tensor (over 1,500 a step for ResNet-50's
  parameters and gradients). On a card it is one launch of a hand-written
  kernel (``csrc/health_stats.cu``) whatever the tensor count: it reads
  each tensor in place through a table of device pointers, one block per
  chunk of a tensor, and the last block sums each tensor's chunks in a
  fixed order; the pointer table goes in and the result comes out by
  copies on the same stream. On the CPU its plain version
  (:func:`stats_plain`) runs. The bad count is an integer sum: the
  elements less the finite ones, counted per chunk and summed in
  float64, exact far past any tensor size. The sums are masked to the
  finite elements so the grad-norm trajectory stays readable on the very
  step a NaN appears.
* **Health gauges** — global gradient norm, parameter norm, and the
  update-to-param ratio ``lr * ||g|| / ||w||``, under telemetry.
* **A flight-recorder step record** (flight_recorder.py): loss, grad
  norm, lr, the device memory watermark (read at most every half second),
  step wall time, cumulative
  compile count (CUDA-graph captures + kernel builds, the port's
  compiles: observability/instruments.py).
* **Policy** (``MXNET_HEALTH=off|warn|raise|skip_step``):

  - ``off`` (default): :func:`active` is False and every call site takes
    its existing no-op path (one cached module-global read).
  - ``warn``: log the anomaly, dump the flight recorder (throttled), and
    keep training; the fetch lags one step, as in the JAX package: the
    (n, 3) result goes by an asynchronous copy into one of two pinned
    host slots with an event behind it, and the next guard, after
    launching its own step's reduction into the other slot, reads it
    (waiting only if the card has not reached it, a step later). The
    stash carries its own step/tensor metadata, so the record names the
    step the NaN occurred. Pending stats are flushed at fit end, on any
    dump, and at exit.
  - ``raise``: dump, then raise :class:`TrainingHealthError` on the step
    the anomaly occurred (synchronous).
  - ``skip_step``: additionally tell the caller to DROP this update
    (``verdict.skip``) so parameters stay finite. Synchronous: the
    verdict must gate the update it protects.

Call sites: the module ``fit`` loop (module/base_module.py), Gluon
``Trainer.step`` and ``compile_step`` (gluon/trainer.py), the autograd
backward (autograd.py, loss heads), and ``Executor.health_check``.
"""
from __future__ import annotations

import logging
import math
import os
import threading
import time

import numpy as np

from ..base import MXNetError

__all__ = ["TrainingHealthError", "Verdict", "policy", "set_policy",
           "active", "check", "guard_step", "flush", "compiles",
           "next_step", "skip_allowed"]

_POLICIES = ("off", "warn", "raise", "skip_step")

_lock = threading.Lock()
_policy = None        # resolved policy string, lazy from env  # guarded-by: _lock
_anomaly_log_count = 0    # throttles anomaly WARNING spam  # guarded-by: _lock
_pending = None       # the warn-mode lag-1 stash  # guarded-by: _lock
_plans = {}           # tensor signature -> _Plan  # guarded-by: _lock


class TrainingHealthError(MXNetError):
    """Raised by the ``raise`` policy when a step produces non-finite
    values; carries the verdict for programmatic triage."""

    def __init__(self, verdict):
        self.verdict = verdict
        super().__init__(
            "training health: non-finite values at step %s in %s "
            "(first bad tensor: %s; %s) — flight recorder dump: %s"
            % (verdict.step, verdict.where, verdict.first_bad,
               ", ".join("%s=%d" % (n, c) for n, c in verdict.bad[:4]),
               verdict.dump_path
               or "throttled (covered by the next dump / exit flush)"))


def _read_policy():
    # string-valued like MXNET_PROFILER_MODE: read straight from the
    # environment, NOT through the integer get_flag machinery
    p = os.environ.get("MXNET_HEALTH", "off").strip().lower()
    if p in _POLICIES:
        return p
    if p:
        # the user explicitly asked for protection; silently running
        # unprotected because of a typo is the worst failure mode here
        logging.warning(
            "MXNET_HEALTH=%r is not one of %s — health checking is OFF",
            p, "|".join(_POLICIES))
    return "off"


def policy():
    """Current health policy string (``MXNET_HEALTH``, overridable at
    runtime with :func:`set_policy`)."""
    global _policy
    if _policy is None:
        with _lock:
            if _policy is None:
                _policy = _read_policy()
    return _policy


def set_policy(p):
    """Programmatic policy override (``None`` re-reads the env)."""
    global _policy
    if p is not None and p not in _POLICIES:
        raise ValueError("MXNET_HEALTH policy must be one of %s, got %r"
                         % (_POLICIES, p))
    with _lock:
        _policy = p


def active():
    """True when any checking policy is in effect. Call sites guard on
    this so ``off`` costs one cached read per step."""
    return policy() != "off"


_mods = None


def _obs():
    """(metrics, flight_recorder, instruments, perf), imported once: an
    import statement on the per-step path costs about a microsecond."""
    global _mods
    if _mods is None:
        from . import flight_recorder, instruments, metrics, perf

        _mods = (metrics, flight_recorder, instruments, perf)
    return _mods


def compiles():
    """The port's compiles in this process: CUDA-graph captures plus
    kernel libraries loaded at their first use."""
    instruments = _obs()[2]
    return instruments.captures() + instruments.kernel_builds()


# ------------------------------------------------------ segmented reduction
#: elements a block of the card's kernel reduces (csrc/health_stats.cu)
_CHUNK = 8192
#: the kernel's dtype codes; another floating dtype is read as float32
_DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "float64": 3}
_lib = None          # (library, launch entry holding the GIL, plan struct)
_raw_stream = None   # torch's current raw CUDA stream of a device index


def _kernel():
    """``csrc/health_stats.cu``, built at first use: (its library, its
    launch entry called without releasing the GIL, a few microseconds of
    enqueueing, and the ctypes type of its plan struct)."""
    global _lib, _raw_stream
    if _lib is None:
        import ctypes

        import torch

        from .. import cuda_build

        lib = cuda_build.load_library("health_stats")
        P, I = ctypes.c_void_p, ctypes.c_int

        class HsPlan(ctypes.Structure):
            _fields_ = [(name, P) for name in (
                "dev_ptrs", "dtypes", "numels", "chunk_tensor",
                "chunk_start", "first_chunk", "partials", "counter",
                "dev_out")] + [("n", I), ("nchunks", I)]

        if lib.health_stats_chunk() != _CHUNK or \
                lib.health_stats_plan_size() != ctypes.sizeof(HsPlan):
            raise MXNetError("health_stats: the kernel's chunk or plan "
                             "layout does not match the wrapper's")
        launch = ctypes.PyDLL(cuda_build.build_info("health_stats")["path"]
                              ).health_stats_launch
        launch.argtypes = [P, P, P, P, P]
        launch.restype = I
        lib.health_stats_error_string.argtypes = [I]
        lib.health_stats_error_string.restype = ctypes.c_char_p
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda i: torch.cuda.current_stream(i).cuda_stream)
        _lib = (lib, launch, HsPlan)
    return _lib


_counter = None


def _count_launch():
    global _counter
    if _counter is None:
        from .. import cuda_build

        _counter = cuda_build.count_launch
    _counter("health_stats")


def stats_plain(tensors):
    """The reduction's plain version: (n, 3) float64 [finite count,
    finite sum(x^2), finite sum(x)] per tensor, torch ops per tensor in
    float64 (the CPU path, and the card kernel's reference)."""
    import torch

    rows = []
    for t in tensors:
        x = t.detach().reshape(-1).to(torch.float64)
        finite = torch.isfinite(x)
        xf = torch.where(finite, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))
        rows.append(torch.stack([finite.sum().to(torch.float64),
                                 (xf * xf).sum(), xf.sum()]))
    if not rows:
        return np.zeros((0, 3))
    return torch.stack(rows).cpu().numpy()


class _Plan:
    """Everything about one call signature (the watched tensors' kinds,
    names, dtypes, shapes and device) that does not change from step to
    step, built once and reused every step.

    On a card: the kernel's tables (each tensor's dtype and size, which
    tensor and element each block starts at), its scratch, two pinned host
    slots for the pointer table and the (n, 3) result, and an event per
    slot. A launch is one call into the kernel's library, which enqueues
    the pointer table's copy, the kernel and the result's copy on the
    current stream, and records the slot's event: the kernel reads the
    tensors where they are, whatever their count, with no copy of them. On
    the CPU: :func:`stats_plain`."""

    def __init__(self, datas, meta):
        self.device = datas[0].device
        self.n = len(datas)
        self.meta = meta
        kinds = [k for k, _n, _s in meta]
        # (n, 2) weights: the gradients' and the parameters' sums of
        # squares in one product
        self.norm_w = np.array([[k == "grad", k == "param"] for k in kinds],
                               np.float64)
        self.has_grad = "grad" in kinds
        self.has_param = "param" in kinds
        self.loss_at = kinds.index("loss") if "loss" in kinds else None
        # losses come first in a call and are new tensors every step
        self.n_loss = kinds.count("loss")
        self.sig = [(d.dtype, d.shape) for d in datas]
        self.numel = [d.numel() for d in datas]
        self.ptrs = None   # the stable tensors' addresses at the last check
        self.fix = []      # tensors the kernel reads through a copy
        self.slot = 0
        self.lib = None
        if self.device.type == "cuda":
            self._tables(datas)

    def _tables(self, datas):
        import ctypes

        import torch

        from ..base import dtype_name
        from . import perf

        self.lib, self.launch_fn, plan_type = _kernel()
        codes = [_DTYPE_CODES.get(dtype_name(d.dtype), -1) for d in datas]
        self.cast = [i for i, c in enumerate(codes) if c < 0]
        chunk_tensor, chunk_start, first = [], [], [0]
        for i, m in enumerate(self.numel):
            k = max(1, -(-m // _CHUNK))
            chunk_tensor.extend([i] * k)
            chunk_start.extend(range(0, k * _CHUNK, _CHUNK))
            first.append(len(chunk_tensor))
        dev = self.device
        self.index = dev.index if dev.index is not None else \
            torch.cuda.current_device()

        def table(values, dtype):
            return torch.tensor(values, dtype=dtype, device=dev)

        nchunks = len(chunk_tensor)
        # held here for as long as the plan: the struct holds their
        # addresses
        self.buffers = [
            torch.empty(self.n, dtype=torch.int64, device=dev),
            table([max(c, 0) for c in codes], torch.int32),
            table(self.numel, torch.int64),
            table(chunk_tensor, torch.int32),
            table(chunk_start, torch.int64),
            table(first, torch.int32),
            torch.empty(3 * nchunks, dtype=torch.float64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.empty(3 * self.n, dtype=torch.float64, device=dev)]
        self.cplan = plan_type(*[b.data_ptr() for b in self.buffers],
                               self.n, nchunks)
        self.cplan_addr = ctypes.addressof(self.cplan)
        # two slots, alternating: a slot is rewritten only after the
        # launch behind it was read (its event waited for)
        host_ptrs = [torch.empty(self.n, dtype=torch.int64, pin_memory=True)
                     for _ in range(2)]
        host_out = [torch.empty(self.n, 3, dtype=torch.float64,
                                pin_memory=True) for _ in range(2)]
        self.pinned = host_ptrs + host_out
        self.ptrs_np = [h.numpy() for h in host_ptrs]
        self.out_np = [h.numpy() for h in host_out]
        self.ptrs_addr = [h.data_ptr() for h in host_ptrs]
        self.out_addr = [h.data_ptr() for h in host_out]
        self.filled = [False, False]  # a slot holds the stable addresses
        self.events = [perf.new_event() for _ in range(2)]

    def launch(self, datas):
        """Run the reduction over ``datas``: the host slot its result goes
        to (on the CPU the result itself), or False when ``datas`` no
        longer fit this plan (a shape or dtype changed). A slot is read by
        :meth:`read` before the launch after next reuses it."""
        if self.lib is None:
            if [(d.dtype, d.shape) for d in datas] != self.sig:
                return False
            return stats_plain(datas)
        ptrs = [d.data_ptr() for d in datas]
        nl = self.n_loss
        slot = self.slot
        if ptrs[nl:] != self.ptrs:
            # the stable tensors moved (or the first launch): check them;
            # the other slot may still be read by a running copy, so it
            # takes the new addresses at its own next launch
            if [(d.dtype, d.shape) for d in datas] != self.sig:
                return False
            self.ptrs = ptrs[nl:]
            self.fix = sorted(set(self.cast) | {
                i for i, d in enumerate(datas) if not d.is_contiguous()})
            self.filled = [False, False]
        else:
            for i in range(nl):
                if (datas[i].dtype, datas[i].shape) != self.sig[i]:
                    return False
        table = self.ptrs_np[slot]
        if not self.filled[slot]:
            table[:] = ptrs
            self.filled[slot] = True
        else:
            for i in range(nl):
                table[i] = ptrs[i]
        held = []
        for i in self.fix + [i for i in range(nl) if i not in self.fix
                             and not datas[i].is_contiguous()]:
            # a strided or float8 tensor is read through a contiguous copy
            # (held until the launch is enqueued; the stream orders reuse)
            t = datas[i].contiguous()
            if i in self.cast:
                t = t.float()
            held.append(t)
            table[i] = t.data_ptr()
        self.slot = slot ^ 1
        err = self.launch_fn(self.cplan_addr, self.ptrs_addr[slot],
                             self.out_addr[slot], self.events[slot],
                             _raw_stream(self.index))
        if err:
            raise MXNetError("health_stats launch failed: %s" %
                             self.lib.health_stats_error_string(err).decode())
        _count_launch()
        return slot

    def read(self, slot):
        """The (n, 3) [finite count, finite sum(x^2), finite sum(x)] of
        the launch behind ``slot`` on the host, waiting for it if it still
        runs: the pinned slot itself, valid until the launch after next
        (a caller that keeps it copies it)."""
        if not isinstance(slot, int):
            return slot
        perf = _obs()[3]
        ev = self.events[slot]
        if not perf.query(ev):   # the wait releases the GIL
            perf.synchronize(ev)
        return self.out_np[slot]


def _prepare(losses, grads, params):
    """(plan, tensors) of a call, the plan found by the call's names (the
    per-step path: one pass over the arrays) and built on a miss; (None,
    []) when nothing is watchable. The caller launches."""
    import torch

    losses, grads, params = list(losses), list(grads), list(params)
    pairs = losses + grads + params
    if not pairs:
        return None, []
    names, arrays = zip(*pairs)
    key = (len(losses), len(grads), names)
    tensor = torch.Tensor
    arrays = [a if isinstance(a, tensor) else getattr(a, "_data", a)
              for a in arrays]
    with _lock:
        plan = _plans.get(key)
    if plan is None:
        kinds = (["loss"] * len(losses) + ["grad"] * len(grads)
                 + ["param"] * len(params))
        take = [i for i, d in enumerate(arrays)
                if d is not None and d.is_floating_point()]
        if not take:
            return None, []
        plan = _Plan([arrays[i] for i in take],
                     [(kinds[i], names[i], arrays[i].numel())
                      for i in take])
        plan.take = None if len(take) == len(arrays) else take
        with _lock:
            if len(_plans) > 16:  # a loop of changing signatures
                _plans.clear()
            _plans[key] = plan
    if plan.take is not None:
        arrays = [arrays[i] for i in plan.take]
    return plan, arrays


def _launch(losses, grads, params):
    """(plan, its result's host slot) of a launched call, or (None, None)
    when nothing is watchable."""
    plan, datas = _prepare(losses, grads, params)
    if plan is None:
        return None, None
    slot = plan.launch(datas)
    if slot is False:
        # same names, new shapes or dtypes: a new plan
        with _lock:
            _plans.clear()
        plan, datas = _prepare(losses, grads, params)
        slot = plan.launch(datas)
    return plan, slot


def _fused_stats(datas):
    """The (n, 3) [non-finite count, sum(x^2), sum(x)] of raw tensors,
    synchronously: the JAX package's ``_stats_impl``."""
    flush()
    plan, slot = _launch((), (), [("t%d" % i, d)
                                  for i, d in enumerate(datas)])
    stats = np.array(plan.read(slot))
    stats[:, 0] = np.asarray(plan.numel, np.float64) - stats[:, 0]
    return stats


class Verdict:
    """Result of one health check."""

    __slots__ = ("ok", "skip", "step", "where", "bad", "first_bad", "loss",
                 "grad_norm", "param_norm", "update_ratio", "lr",
                 "dump_path")

    def __init__(self):
        self.ok = True
        self.skip = False
        self.step = None
        self.where = ""
        self.bad = []          # [(name, non-finite count), ...]
        self.first_bad = None  # first bad tensor name, check order
        self.loss = None
        self.grad_norm = None
        self.param_norm = None
        self.update_ratio = None
        self.lr = None
        self.dump_path = None

    def as_record(self):
        return {"step": self.step, "where": self.where, "ok": self.ok,
                "skipped": self.skip, "loss": self.loss,
                "grad_norm": self.grad_norm, "param_norm": self.param_norm,
                "update_ratio": self.update_ratio, "lr": self.lr,
                "bad": list(self.bad), "first_bad": self.first_bad}


def _evaluate(plan, stats, lr, step, where):
    """Build a Verdict from the fetched (n, 3) [finite count, sum(x^2),
    sum(x)] and the plan's names."""
    v = Verdict()
    v.step = step
    v.where = where
    v.lr = lr
    finite = stats[:, 0].tolist()
    if finite != plan.numel:
        v.ok = False
        for i, (f, m) in enumerate(zip(finite, plan.numel)):
            if f != m:
                kind, name, _size = plan.meta[i]
                v.bad.append(("%s:%s" % (kind, name), int(m - f)))
        v.first_bad = v.bad[0][0]
    if plan.loss_at is not None:
        v.loss = float(stats[plan.loss_at, 2]) / max(
            plan.numel[plan.loss_at], 1)
    grad_sq, param_sq = (stats[:, 1] @ plan.norm_w).tolist()
    if plan.has_grad:
        v.grad_norm = math.sqrt(grad_sq)
    if plan.has_param:
        v.param_norm = math.sqrt(param_sq)
    if lr is not None and v.grad_norm is not None and v.param_norm:
        v.update_ratio = float(lr) * v.grad_norm / (v.param_norm + 1e-20)
    return v


def check(losses=(), grads=(), params=(), lr=None, step=None, where=""):
    """Run the reduction over the named tensors and build a
    :class:`Verdict` synchronously (no policy applied, no recording).
    Each of ``losses``/``grads``/``params`` is an iterable of
    ``(name, array)`` with NDArray or raw tensors. Returns None when
    nothing watchable (no floating-point tensors) was passed. A pending
    warn-mode stash is settled first: its plan may be this one."""
    flush()
    plan, slot = _launch(losses, grads, params)
    if plan is None:
        return None
    return _evaluate(plan, plan.read(slot), lr, step, where)


_site_steps = {}  # call-site -> monotonic step counter  # guarded-by: _lock


def next_step(site):
    """Per-call-site monotonic step counter for wiring points with no
    natural index of their own (one backward == one eager training
    step)."""
    with _lock:
        _site_steps[site] = _site_steps.get(site, 0) + 1
        return _site_steps[site]


def skip_allowed(kvstore):
    """May a skip_step verdict actually withhold the update given this
    kvstore? A worker-local skip in front of a synchronous distributed
    push would make workers disagree about entering the all-reduce, so
    skip_step degrades to warn under dist_sync stores."""
    kv_type = getattr(kvstore, "type", "") if kvstore is not None else ""
    return not ("dist" in kv_type and "async" not in kv_type)


def _record_gauges(v):
    metrics = _obs()[0]
    if not metrics.enabled():
        return
    metrics.counter("health.checks").inc()
    if v.grad_norm is not None:
        metrics.gauge("health.grad_norm").set(v.grad_norm)
    if v.update_ratio is not None:
        metrics.gauge("health.update_ratio").set(v.update_ratio)
    if not v.ok:
        metrics.counter("health.anomalies").inc()
    if v.skip:
        metrics.counter("health.skipped_steps").inc()


def _log_anomaly(v):
    """WARNING for the first few anomalies, then every 100th."""
    global _anomaly_log_count
    with _lock:
        _anomaly_log_count += 1
        n = _anomaly_log_count
    if n <= 5 or n % 100 == 0:
        logging.warning(
            "training health [%s]: non-finite values at step %s "
            "(first bad: %s; %s)%s%s",
            v.where, v.step, v.first_bad,
            ", ".join("%s=%d" % (name, c) for name, c in v.bad[:4]),
            " — SKIPPING update" if v.skip else "",
            (" — dump: %s" % v.dump_path) if v.dump_path else "")


_peak = [float("-inf"), None]  # (monotonic s, bytes) of the last read


def _hbm_watermark():
    """The device memory watermark, read at most every half second: the
    allocator's statistics cost more to read than the rest of a guard."""
    now = time.monotonic()
    if now - _peak[0] >= 0.5:
        _peak[:] = [now, _obs()[2].device_peak_bytes()]
    return _peak[1]


def _commit(v, wall_s, allow_dump=True):
    """Gauges + flight-recorder record + (throttled) anomaly dump/log for
    an evaluated verdict; never raises."""
    flight_recorder = _obs()[1]
    _record_gauges(v)
    rec = v.as_record()
    rec["wall_ms"] = round(wall_s * 1e3, 3) if wall_s is not None else None
    rec["compiles"] = compiles()
    rec["hbm_bytes"] = _hbm_watermark()
    flight_recorder.record(rec, anomaly=not v.ok)
    if not v.ok:
        if allow_dump:
            v.dump_path = flight_recorder.dump_on_anomaly(
                "anomaly:%s:step=%s:first_bad=%s"
                % (v.where, v.step, v.first_bad))
        _log_anomaly(v)
    return v


def _finish_pending(pending, allow_dump=True):
    """Read + evaluate + commit a warn-mode stash (no raise, no skip)."""
    plan, slot, lr, step, where, wall_s = pending
    try:
        stats = plan.read(slot)
    except Exception:
        return None
    return _commit(_evaluate(plan, stats, lr, step, where), wall_s,
                   allow_dump=allow_dump)


def _take_pending():
    global _pending
    with _lock:
        pending, _pending = _pending, None
    return pending


def flush(allow_dump=True):
    """Evaluate the warn-mode lag-1 stash now, waiting for the card (fit
    end, dump time, exit). Returns the flushed Verdict or None."""
    pending = _take_pending()
    if pending is None:
        return None
    return _finish_pending(pending, allow_dump=allow_dump)


def guard_step(where, losses=(), grads=(), params=(), lr=None, step=None,
               wall_s=None, can_skip=True, sync=None):
    """The per-step entry point every wired front-end calls.

    Launches the reduction, records the flight-recorder step record and
    the health gauges, and applies the policy. Under ``raise`` and
    ``skip_step`` (or ``sync=True``) the result is fetched immediately
    and the returned Verdict describes THIS step (callers that can
    withhold the update drop it when ``verdict.skip``). Under ``warn``
    the fetch lags one step: the returned Verdict describes the PREVIOUS
    guarded step, and this step's stats are stashed for the next call /
    :func:`flush`. Returns None when the policy is ``off`` or nothing was
    watchable.
    """
    global _pending
    if not active():
        return None
    # any actively-guarded step arms the crash hooks
    _obs()[1].install()
    pol = policy()
    if sync is None:
        sync = pol in ("raise", "skip_step")

    if not sync:
        # this step's reduction goes into one host slot while the last
        # step's result is read from the other
        plan, slot = _launch(losses, grads, params)
        if plan is None:
            return flush()
        with _lock:
            prev, _pending = _pending, (plan, slot, lr, step, where, wall_s)
        return _finish_pending(prev) if prev is not None else None

    flush()  # a stale warn stash must not outlive a sync verdict
    plan, slot = _launch(losses, grads, params)
    if plan is None:
        return None
    v = _evaluate(plan, plan.read(slot), lr, step, where)
    if not v.ok and pol == "skip_step" and can_skip:
        v.skip = True
    _commit(v, wall_s)
    if not v.ok and pol == "raise":
        raise TrainingHealthError(v)
    return v

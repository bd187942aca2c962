"""The streaming input pipeline: parallel decode, off-critical-path batch
assembly, and double-buffered device staging.

Counterpart of ``mxnet_tpu/runtime/pipeline.py``. The synchronous
iterators do everything on the training thread: read -> decode -> augment
-> assemble -> pad -> copy to the card -> step. This module restructures
that as a staged pipeline with bounded queues:

1. **Source** (feeder thread) — a shard-aware
   :class:`~.source.RecordFileSource` reads raw records serially
   (order-preserving, IO-bound, cheap);
2. **Decode/augment pool** — each record's JPEG decode + augmenter chain
   runs on a worker owning a contiguous run of batch rows. The default
   backend is a PROCESS pool writing decoded rows straight into a
   shared-memory batch buffer: PIL's decoder holds the GIL on common
   builds, so threads alone cannot scale it. ``MXNET_IO_DECODE_BACKEND=
   thread`` (or ``decode_backend="thread"``) selects the in-process pool;
   a process backend that was asked for and cannot start raises;
3. **Assembly** — workers write rows already transposed to the NCHW
   batch layout; the *last* worker's completion finalizes the batch
   (dtype cast + copy out of the recycled shared segment, label squeeze,
   zero-row padding to the bound batch size) so none of that runs on the
   training thread;
4. **Device staging** — the consumer keeps a
   :class:`~.staging.PipelineWindow` of batches already on their way to
   the device (:func:`~.staging.stage_pytree`: pinned host buffers,
   ``non_blocking`` copies on the current stream), so batch N+1's copy
   overlaps batch N's compute.

**Start method of the decode processes: forkserver.** A worker is forked
from the multiprocessing fork server, a fresh single-threaded Python
started once per process, never from the caller. Forking the caller (the
JAX package's choice) copies a process whose CUDA context, torch thread
pools and other pipelines' feeder and executor threads are live: a worker
forked while one of those threads holds a lock inherits it locked (the
JAX package's two-concurrent-iterators test hangs that way, on
``concurrent.futures``' wakeup lock at worker exit). The fork server
preloads this module, so a worker starts with the decode code imported,
and the augmenter chain reaches it by pickle: the built-in augmenters
pickle; a chain that does not (a lambda) raises at construction, with the
thread backend as the way out. Workers run PIL and numpy only, never
torch.

Every stage records wait time and queue depth in the metrics registry
(``io.decode_ms``, ``io.assemble_ms``, ``io.consumer_wait_ms``,
``io.stage_ms``, ``io.queue_depth``, ``io.batches``, ``io.rows``) and in an
always-on stats block, so ``StreamingIter.get_stats()`` answers
"input-bound or compute-bound?" directly.
"""
from __future__ import annotations

import queue
import threading
import time
import weakref
from multiprocessing import resource_tracker, shared_memory

import numpy as np

from .. import io as _io
from ..base import MXNetError
from ..context import as_device
from .source import RecordFileSource, shard_partition
from .staging import PipelineWindow, stage_pytree

__all__ = ["StreamingIter", "io_pipeline_key", "resolve_decode_workers",
           "resolve_prefetch_depth", "resolve_decode_backend"]

_EPOCH_END = object()


class _FeederError:
    """Feeder-thread crash carried to the consumer instead of a hang."""

    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error


def io_pipeline_key(batch_size, data_shape):
    """Tuning-cache key for the ``io.*`` tunables: the pipeline
    self-sizes per HOST (worker count ~ cores) and per workload shape."""
    import os

    c, h, w = data_shape
    return ("cpu%d" % (os.cpu_count() or 1), "b%d" % int(batch_size),
            "%dx%dx%d" % (int(c), int(h), int(w)))


def _tuned(op, key, field):
    from .. import autotune

    val = autotune.lookup(op, key=key)
    if isinstance(val, dict):
        try:
            n = int(val.get(field, 0))
            return n if n > 0 else None
        except (TypeError, ValueError):
            return None  # corrupt cache entry: fall through to flags
    return None


def resolve_decode_workers(explicit, batch_size, data_shape):
    """Worker-count resolution: explicit arg > ``io.decode_workers``
    tuning-cache entry > ``MXNET_IO_DECODE_WORKERS`` > auto (host cores,
    capped at 8). The tuner that writes the entry waits for ROADMAP.md
    Queue A13's search."""
    import os

    from ..config import get_flag

    if explicit is not None and int(explicit) > 0:
        return int(explicit)
    tuned = _tuned("io.decode_workers",
                   io_pipeline_key(batch_size, data_shape), "workers")
    if tuned is not None:
        return tuned
    flag = get_flag("MXNET_IO_DECODE_WORKERS")
    if flag > 0:
        return int(flag)
    return max(1, min(os.cpu_count() or 4, 8))


def resolve_prefetch_depth(explicit, batch_size, data_shape):
    """Prefetch-depth resolution, same order as the worker count."""
    from ..config import get_flag

    if explicit is not None and int(explicit) > 0:
        return int(explicit)
    tuned = _tuned("io.prefetch_depth",
                   io_pipeline_key(batch_size, data_shape), "depth")
    if tuned is not None:
        return tuned
    return max(1, get_flag("MXNET_IO_PREFETCH_DEPTH"))


def resolve_decode_backend(explicit):
    """``process`` (forkserver workers + shared-memory rows: the backend
    that scales a GIL-holding decoder) where the platform has the
    forkserver start method, ``thread`` otherwise.
    ``MXNET_IO_DECODE_BACKEND`` overrides ``auto``; an explicit argument
    overrides both. An explicit ``process`` without a forkserver raises."""
    import multiprocessing as mp
    import os

    choice = explicit or os.environ.get("MXNET_IO_DECODE_BACKEND", "auto")
    if choice not in ("auto", "process", "thread"):
        raise MXNetError("decode backend must be auto/process/thread, "
                         "got %r" % (choice,))
    if choice == "thread":
        return "thread"
    if "forkserver" in mp.get_all_start_methods():
        return "process"
    if choice == "process":
        raise MXNetError("decode_backend='process' needs the forkserver "
                         "start method, unavailable on this platform")
    return "thread"


def _process_context():
    """The forkserver context, its server preloading the decode modules
    (effective when this is the process's first forkserver use), so that
    each worker starts with them imported."""
    import multiprocessing as mp

    from ..image import image as _image

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__, _image.__name__, "PIL.Image"])
    return ctx


class _PendingBatch:
    """One batch in flight through the decode pool: a preallocated NCHW
    row buffer (shared-memory segment under the process backend), a
    countdown of outstanding decode chunks, and the finalized arrays
    once the last chunk's completion assembled them."""

    __slots__ = ("data", "label", "n", "pad", "remaining", "lock", "ready",
                 "error", "arrays", "finalize", "segment")

    def __init__(self, data, label, n, n_tasks, finalize, segment=None):
        self.data = data                # (B, C, H, W) float32 row buffer
        self.label = label              # (B, label_width) float32
        self.n = n                      # real rows; the rest stay zero
        self.pad = data.shape[0] - n
        self.remaining = n_tasks        # guarded-by: self.lock
        self.lock = threading.Lock()
        self.ready = threading.Event()
        self.error = None
        self.arrays = None              # (data_nchw, label_out) when ready
        # a WEAK method ref: pending batches parked in the feeder queue
        # must not pin an abandoned (never-closed) StreamingIter — its
        # __del__ is what closes the decode pool and shm ring
        self.finalize = weakref.WeakMethod(finalize)
        self.segment = segment          # shm segment to recycle, or None

    def chunk_done(self, error=None):
        if error is not None:
            self.error = error
        with self.lock:
            self.remaining -= 1
            last = self.remaining == 0
        if last:
            # finalize ALWAYS runs (it owns the segment release); it
            # returns None when the batch already failed
            try:
                fin = self.finalize()
                # a collected iterator's close() already destroyed the
                # shm ring — nothing left to assemble or release
                self.arrays = fin(self) if fin is not None else None
            except BaseException as err:  # surface at the consumer
                self.error = err
            self.ready.set()


class _ShmPool:
    """A small ring of reusable shared-memory batch segments (parent
    owns creation and unlinking; workers attach read-write and
    UNREGISTER from the resource tracker so a worker exit can never
    unlink a live segment — 3.10 registers attachments too)."""

    def __init__(self, nbytes, capacity):
        self._nbytes = int(nbytes)
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        self._free = []      # guarded-by: self._lock
        self._all = []       # guarded-by: self._lock
        self._sem = threading.Semaphore(capacity)

    def acquire(self, stop):
        while not self._sem.acquire(timeout=0.1):
            if stop.is_set():
                return None
        with self._lock:
            if self._free:
                return self._free.pop()
            seg = shared_memory.SharedMemory(create=True,
                                             size=self._nbytes)
            self._all.append(seg)
            return seg

    def release(self, seg):
        with self._lock:
            self._free.append(seg)
        self._sem.release()

    def destroy(self):
        with self._lock:
            segs, self._all, self._free = self._all, [], []
        for seg in segs:
            try:
                seg.close()
                seg.unlink()
            except Exception:
                pass  # already gone (interpreter teardown races)


# ---- process-backend worker half (module-level: picklable) -----------
_WORKER_AUGS = None
_WORKER_SHM = {}


def _decode_worker_init(aug_list):
    global _WORKER_AUGS
    _WORKER_AUGS = aug_list
    # workers forked from one server share ONE random state: left alone,
    # every worker would draw identical augmentation randomness
    # (correlated crops). Per-pid reseeding decorrelates them; like the
    # thread pool, random augmenters are therefore not bit-reproducible
    # across runs (the JAX package's process workers do the same).
    import os
    import random as pyrandom

    seed = (os.getpid() * 2654435761) & 0xFFFFFFFF
    pyrandom.seed(seed)
    np.random.seed(seed)


def _worker_attach(name):
    shm = _WORKER_SHM.get(name)
    if shm is None:
        # the PARENT owns the segment's lifecycle. Attaching would
        # REGISTER it with the (shared) resource tracker a second time
        # under the same name — and any later unregister
        # (ours or a worker exit's cleanup) would clobber the parent's
        # entry, so the tracker either unlinks a live segment or
        # KeyErrors at shutdown. Suppress the attach-side registration
        # entirely: the worker is a guest in the parent's segment.
        orig_register = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            shm = shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig_register
        _WORKER_SHM[name] = shm
    return shm


def _decode_rows_into(arr, lo, payloads, aug_list):
    """Decode + augment ``payloads`` into NCHW rows ``arr[lo:...]`` —
    the one decode implementation both backends run."""
    from ..image import imdecode

    for j, payload in enumerate(payloads):
        data = imdecode(payload)
        for aug in aug_list:
            data = aug(data)
        if data.ndim == 2:
            data = data[:, :, None]
        arr[lo + j] = np.transpose(data, (2, 0, 1))


def _process_decode_chunk(shm_name, shape, lo, payloads):
    shm = _worker_attach(shm_name)
    arr = np.ndarray(shape, dtype=np.float32, buffer=shm.buf)
    _decode_rows_into(arr, lo, payloads, _WORKER_AUGS)
    return len(payloads)


class StreamingIter(_io.DataIter):
    """Async streaming image iterator over a record file — the
    :class:`~..io.DataIter`-contract front of the pipeline
    (``provide_data``/``provide_label``, ``reset``, pad semantics all
    match ``ImageRecordIter``'s synchronous path batch for batch).

    Produces NCHW float batches already on ``device`` (a Context or torch
    device; None is the ``with`` scope at construction, else the card),
    staged ahead of the consumer. ``seed`` makes the per-epoch shuffle
    reproducible and :meth:`get_state`/:meth:`set_state` checkpoint the
    exact stream position (in the JAX package's layout).
    """

    def __init__(self, path_imgrec=None, data_shape=None, batch_size=1,
                 path_imgidx=None, label_width=1, shuffle=False, seed=None,
                 num_parts=1, part_index=0, aug_list=None, dtype="float32",
                 last_batch_handle="pad", decode_workers=None,
                 prefetch_depth=None, stage_depth=None, device=None,
                 decode_backend=None, source=None, **kwargs):
        from ..config import get_flag
        from ..image import CreateAugmenter

        super().__init__(batch_size)
        if data_shape is None or len(data_shape) != 3:
            raise MXNetError("data_shape must be CHW, got %r"
                             % (data_shape,))
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError("last_batch_handle must be 'pad' or 'discard' "
                             "for StreamingIter, got %r"
                             % (last_batch_handle,))
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.dtype = dtype
        self.last_batch_handle = last_batch_handle
        if seed is None:
            # unseeded = a fresh shuffle order per construction (every
            # other iterator's unseeded semantics). Still checkpointable:
            # the drawn seed's RNG stream rides get_state()
            import os as _os

            seed = int.from_bytes(_os.urandom(4), "little")
        self._source = source if source is not None else RecordFileSource(
            path_imgrec, path_imgidx, num_parts=num_parts,
            part_index=part_index, shuffle=shuffle, seed=seed)
        self.aug_list = (CreateAugmenter(data_shape, **kwargs)
                         if aug_list is None else aug_list)
        self.decode_workers = resolve_decode_workers(
            decode_workers, batch_size, self.data_shape)
        self.prefetch_depth = resolve_prefetch_depth(
            prefetch_depth, batch_size, self.data_shape)
        self._stage_depth = max(1, int(stage_depth)
                                if stage_depth is not None
                                else get_flag("MXNET_IO_STAGE_DEPTH"))
        self._device = as_device(device)
        self.num_image = len(self._source)

        self.provide_data = [_io.DataDesc(
            "data", (batch_size,) + self.data_shape, dtype)]
        label_shape = ((batch_size,) if label_width == 1
                       else (batch_size, label_width))
        self.provide_label = [_io.DataDesc("softmax_label", label_shape,
                                           "float32")]

        self.decode_backend = resolve_decode_backend(decode_backend)
        self._shm = None
        if self.decode_backend == "process":
            import pickle
            from concurrent.futures import ProcessPoolExecutor
            from concurrent.futures.process import BrokenProcessPool

            try:
                pickle.dumps(self.aug_list)
            except Exception as err:
                raise MXNetError(
                    "the process decode backend sends the augmenter chain "
                    "to its workers by pickle, and this one does not "
                    "pickle (%s): use picklable augmenters or "
                    "decode_backend='thread'" % (err,)) from err
            self._pool = ProcessPoolExecutor(
                max_workers=self.decode_workers,
                mp_context=_process_context(),
                initializer=_decode_worker_init,
                initargs=(self.aug_list,))
            # start every worker now, so the first epoch does not pay for
            # them, and prove the pool (and its initializer) live with one
            # round-trip before the feeder starts
            spawn = getattr(self._pool, "_spawn_process", None)
            while (spawn is not None
                   and len(self._pool._processes) < self.decode_workers):
                spawn()
            try:
                self._pool.submit(int, 0).result()
            except BrokenProcessPool as err:
                self._pool.shutdown(wait=False)
                raise MXNetError(
                    "the decode processes did not start: each imports the "
                    "main script again, as under spawn, so its entry must "
                    "run under 'if __name__ == \"__main__\":' (or pass "
                    "decode_backend='thread')") from err
            c, h, w = self.data_shape
            self._shm = _ShmPool(4 * batch_size * c * h * w,
                                 capacity=self.prefetch_depth + 2)
        else:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.decode_workers,
                thread_name_prefix="mxnet-io-decode")
        self._order_q = queue.Queue(maxsize=self.prefetch_depth)
        self._staged = PipelineWindow(self._stage_depth)
        self._stop = threading.Event()
        self._feeder = None
        self._closed = False
        self._exhausted = False
        self._delivered = 0
        self._life = threading.Lock()   # serializes reset/close/set_state

        # always-on stage accounting (floats; ~ns per update) feeding
        # get_stats() and the "io" flight-recorder provider
        self._stats_lock = threading.Lock()
        self._stats = {k: 0.0 for k in
                       ("read_s", "backpressure_s", "decode_s",
                        "assemble_s", "consumer_wait_s", "stage_s")}
        self._stats.update(batches=0, rows=0, epochs=0, decoded_rows=0)
        self._consume_t0 = None
        self._consume_t1 = None

        _live_pipelines.add(self)
        from ..observability import flight_recorder

        flight_recorder.register_provider("io", _pipelines_state)
        self._epoch_source_state = self._source.get_state()
        self._start_feeder()

    # -------------------------------------------------------- stage 1+2
    def _start_feeder(self):
        self._stop = threading.Event()
        self._exhausted = False
        self._feeder = threading.Thread(
            target=StreamingIter._feed_entry,
            args=(weakref.ref(self), self._stop, self._order_q),
            name="mxnet-io-feeder", daemon=True)
        self._feeder.start()

    @staticmethod
    def _feed_entry(ref, stop, order_q):
        """Feeder thread target. Holds only a WEAKREF to the iterator
        between steps: an abandoned (never-closed) StreamingIter must
        stay garbage-collectable — its ``__del__`` is what closes the
        decode pool and the shm ring — and a bound-method target (or a
        strong ref held across the backpressure wait) would pin it for
        the process lifetime, leaking workers and segments. A strong
        ref lives at most one read/submit step or one bounded 50 ms put
        attempt; the undelivered item carries across attempts so a full
        queue parks the thread ref-free."""
        carry, final = [], False
        while not stop.is_set():
            it = ref()
            if it is None:
                return                  # abandoned mid-epoch: GC runs close()
            if not carry:
                if final:
                    return
                try:
                    items, final = it._feed_step(stop)
                except BaseException as err:  # never die silently
                    items, final = [_FeederError(err)], True
                if items is None:       # stopped mid-submit
                    return
                carry.extend(items)
            t0 = time.perf_counter()
            try:
                order_q.put(carry[0], timeout=0.05)
                carry.pop(0)
            except queue.Full:
                it._acc("backpressure_s", time.perf_counter() - t0)
            del it
        # stopped: drop whatever was undelivered

    def _feed_step(self, stop):
        """One feeder step: serial record reads (order-preserving)
        fanning decode jobs out to the pool. Returns ``(items, final)``
        — the batches to enqueue (None when stopped mid-submit) and
        whether the epoch ends after delivering them."""
        raws, t0 = [], time.perf_counter()
        try:
            while len(raws) < self.batch_size:
                raws.append(self._source.read())
        except StopIteration:
            pass
        self._acc("read_s", time.perf_counter() - t0)
        short = len(raws) < self.batch_size
        if not raws or (short and self.last_batch_handle == "discard"):
            return [_EPOCH_END], True
        pending = self._submit_batch(stop, raws)
        if pending is None:
            return None, True
        if short:
            return [pending, _EPOCH_END], True
        return [pending], False

    def _submit_batch(self, stop, raws):
        """Build one pending batch and fan its decode chunks out to the
        pool. Contiguous worker-chunks, one task each: row order is
        positional (each task owns rows [lo, hi)), and per-row
        submit/lock overhead amortizes away. Labels are parent-side
        (already unpacked by the source); only decode travels."""
        import functools

        c, h, w = self.data_shape
        n = len(raws)
        label = np.zeros((self.batch_size, self.label_width), np.float32)
        for row, (lab, _payload) in enumerate(raws):
            flat = np.asarray(lab, np.float32).reshape(-1)
            label[row, :len(flat[:self.label_width])] = \
                flat[:self.label_width]
        payloads = [p for _, p in raws]
        tasks = max(1, min(self.decode_workers, n))
        # same contiguous/disjoint/complete cut as dataset sharding
        bounds = [shard_partition(n, tasks, t) for t in range(tasks)]
        if self._shm is not None:
            seg = self._shm.acquire(stop)
            if seg is None:
                return None
            shape = (self.batch_size, c, h, w)
            data = np.ndarray(shape, np.float32, buffer=seg.buf)
            if n < self.batch_size:  # recycled segment: zero pad rows
                data[n:] = 0.0
            pending = _PendingBatch(data, label, n, tasks,
                                    self._finalize, segment=seg)
            t0 = time.perf_counter()
            for t in range(tasks):
                lo, hi = bounds[t]
                fut = self._pool.submit(_process_decode_chunk, seg.name,
                                        shape, lo, payloads[lo:hi])
                fut.add_done_callback(
                    functools.partial(self._chunk_cb, pending, t0))
        else:
            data = np.zeros((self.batch_size, c, h, w), np.float32)
            pending = _PendingBatch(data, label, n, tasks, self._finalize)
            for t in range(tasks):
                lo, hi = bounds[t]
                self._pool.submit(self._decode_chunk, pending, lo,
                                  payloads[lo:hi])
        return pending

    def _chunk_cb(self, pending, t_submit, fut):
        """Process-backend chunk completion (runs on the executor's
        completion thread): roundtrip accounting + batch countdown.

        The LAST chunk's countdown runs ``_finalize`` (the copy out of
        the shared segment) on this same manager thread, serializing
        assembly across in-flight batches — a deliberate trade: finalize
        must run even for batches abandoned at close (it owns the
        segment release, see ``_PendingBatch``), and a dedicated
        assembly thread to lift the ceiling isn't warranted while the
        decode pool, not assembly, bounds measured throughput."""
        from ..observability import metrics

        err = fut.exception()
        if err is None:
            rows = fut.result()
            dt = time.perf_counter() - t_submit
            self._acc("decode_s", dt, decoded_rows=rows)
            metrics.histogram("io.decode_ms").observe(
                dt * 1e3 / max(1, rows))
        pending.chunk_done(error=err)

    def _decode_chunk(self, pending, lo, payloads):
        """Thread-backend stage-2 worker: decode + augment a contiguous
        run of samples into their batch rows (the generalized ImageIter
        ``preprocess_threads`` path, same decode body as the process
        workers)."""
        from ..observability import metrics

        t0 = time.perf_counter()
        try:
            _decode_rows_into(pending.data, lo, payloads, self.aug_list)
        except BaseException as err:
            pending.chunk_done(error=err)
            return
        dt = time.perf_counter() - t0
        self._acc("decode_s", dt, decoded_rows=len(payloads))
        metrics.histogram("io.decode_ms").observe(dt * 1e3 /
                                                  max(1, len(payloads)))
        pending.chunk_done()

    # ----------------------------------------------------------- stage 3
    def _finalize(self, pending):
        """Batch assembly off the training thread (last chunk's
        completion): rows are already NCHW, so this is the dtype cast —
        which doubles as the copy OUT of the recycled shared segment —
        plus the label squeeze; zero-row padding is already in place.
        Always releases the segment, error or not."""
        from ..observability import metrics

        try:
            if pending.error is not None:
                return None
            t0 = time.perf_counter()
            if pending.segment is not None:
                data_out = pending.data.astype(self.dtype, copy=True)
            else:  # thread backend owns its buffer: cast only if needed
                data_out = (pending.data
                            if np.dtype(self.dtype) == np.float32
                            else pending.data.astype(self.dtype))
            label_out = (pending.label[:, 0] if self.label_width == 1
                         else pending.label)
            dt = time.perf_counter() - t0
            self._acc("assemble_s", dt)
            metrics.histogram("io.assemble_ms").observe(dt * 1e3)
            return data_out, label_out
        finally:
            if pending.segment is not None:
                seg, pending.segment = pending.segment, None
                pending.data = None
                self._shm.release(seg)

    # ----------------------------------------------------------- stage 4
    def _take_finished(self):
        """Next finished host batch in admission order (None = epoch
        end); consumer wait — queue get + readiness — is the
        input-bound signal."""
        from ..observability import metrics

        t0 = time.perf_counter()
        while True:
            try:
                item = self._order_q.get(timeout=0.5)
                break
            except queue.Empty:
                if self._closed:
                    raise MXNetError("next() on a closed StreamingIter")
                if self._feeder is None or not self._feeder.is_alive():
                    raise MXNetError(
                        "StreamingIter feeder thread died unexpectedly")
        if item is _EPOCH_END:
            return None
        if isinstance(item, _FeederError):
            raise item.error
        item.ready.wait()
        dt = time.perf_counter() - t0
        self._acc("consumer_wait_s", dt)
        metrics.histogram("io.consumer_wait_ms").observe(dt * 1e3)
        metrics.gauge("io.queue_depth").set(self._order_q.qsize())
        if item.error is not None:
            raise item.error
        return item

    def _stage(self, pending):
        """One :func:`stage_pytree` of the finished batch; on the card
        asynchronous (pinned buffers, ``non_blocking`` copies), so the
        transfer overlaps the consumer's compute on the previous batch."""
        from ..ndarray.ndarray import _from_data
        from ..observability import metrics

        t0 = time.perf_counter()
        data_dev, label_dev = stage_pytree(pending.arrays, self._device)
        dt = time.perf_counter() - t0
        self._acc("stage_s", dt)
        metrics.histogram("io.stage_ms").observe(dt * 1e3)
        return _io.DataBatch(data=[_from_data(data_dev)],
                             label=[_from_data(label_dev)],
                             pad=pending.pad, index=None,
                             provide_data=self.provide_data,
                             provide_label=self.provide_label)

    def next(self):
        from ..observability import metrics

        if self._closed:
            raise MXNetError("next() on a closed StreamingIter")
        now = time.perf_counter()
        if self._consume_t0 is None:
            self._consume_t0 = now
        self._consume_t1 = now
        # keep the staging window full: batch N+1 (and N+2 ...) transfer
        # while the caller computes on batch N
        while not self._staged.full and not self._exhausted:
            pending = self._take_finished()
            if pending is None:
                self._exhausted = True
                break
            self._staged.push(self._stage(pending))
        if not self._staged:
            raise StopIteration
        batch = self._staged.pop()
        self._delivered += 1
        self._acc(batches=1, rows=self.batch_size - (batch.pad or 0))
        metrics.counter("io.batches").inc()
        metrics.counter("io.rows").inc(self.batch_size - (batch.pad or 0))
        return batch

    # ------------------------------------------------------- lifecycle
    def _halt_feeder(self):
        """Stop the feeder and drain its queue (join-safe)."""
        self._stop.set()
        feeder, self._feeder = self._feeder, None
        while True:
            try:
                self._order_q.get_nowait()
            except queue.Empty:
                break
        if feeder is not None and feeder.is_alive():
            feeder.join(timeout=10)
        # recreate post-join so no stale entry can ever resurface
        self._order_q = queue.Queue(maxsize=self.prefetch_depth)

    def reset(self):
        with self._life:
            if self._closed:
                raise MXNetError("reset() on a closed StreamingIter")
            self._halt_feeder()
            self._source.reset()
            self._staged.clear()
            self._delivered = 0
            self._acc(epochs=1)
            self._epoch_source_state = self._source.get_state()
            self._start_feeder()

    def close(self):
        """Stop the feeder, the decode pool and the record reader;
        idempotent (and concurrent-reset-safe: both take the lifecycle
        lock)."""
        with self._life:
            if self._closed:
                return
            self._closed = True
            self._halt_feeder()
            self._pool.shutdown(wait=True)
            if self._shm is not None:
                self._shm.destroy()
            self._staged.clear()
            self._source.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------ state
    def get_state(self):
        """Checkpointable position: the epoch-start source state (order
        + RNG stream) plus batches delivered to the consumer — exactly
        reconstructible regardless of how far ahead the pipeline has
        read."""
        return {"source": self._epoch_source_state,
                "delivered": int(self._delivered)}

    def set_state(self, state):
        """Restore :meth:`get_state`: replay this epoch's order,
        fast-forward past the delivered batches (cursor math, no decode)
        and restart the pipeline there."""
        with self._life:
            if self._closed:
                raise MXNetError("set_state() on a closed StreamingIter")
            self._halt_feeder()
            self._staged.clear()
            try:
                self._source.set_state(state["source"])
                delivered = int(state.get("delivered", 0))
                self._source.skip_samples(delivered * self.batch_size)
                self._delivered = delivered
                self._epoch_source_state = state["source"]
            except BaseException:
                # snapshot rejected (mismatched record file/shard) AFTER
                # the halt discarded the feeder's read-ahead — realign
                # the source to the delivered position (own epoch-start
                # state, always accepted) so fit's consume-and-skip
                # fallback sees a coherent stream, not one silently
                # missing the prefetched tail
                self._source.set_state(self._epoch_source_state)
                self._source.skip_samples(self._delivered * self.batch_size)
                raise
            finally:
                # restart EVEN on rejection: fit's fallback needs a live
                # feeder, not one wedged between halt and restart
                self._start_feeder()

    def skip_batches(self, n):
        """Fast-forward ``n`` batches by cursor math (no decode).

        Positions ABSOLUTELY from the epoch-start state at
        ``delivered + n`` batches: the feeder may already have read
        ahead of the consumer, so a relative cursor bump would skip
        whatever it prefetched on top of the requested batches."""
        if n <= 0:
            return
        with self._life:
            if self._closed:
                raise MXNetError("skip_batches() on a closed StreamingIter")
            self._halt_feeder()
            self._staged.clear()
            target = self._delivered + int(n)
            self._source.set_state(self._epoch_source_state)
            self._source.skip_samples(target * self.batch_size)
            self._delivered = target
            self._start_feeder()

    # ------------------------------------------------------------ stats
    def _acc(self, _key=None, _dt=None, **counts):
        with self._stats_lock:
            if _key is not None:
                self._stats[_key] += _dt
            for k, v in counts.items():
                self._stats[k] += v

    def get_stats(self):
        """JSON-safe per-stage snapshot + the input-bound verdict (also
        the "io" flight-recorder provider section)."""
        with self._stats_lock:
            s = dict(self._stats)
        batches = max(1, int(s["batches"]))
        rows = max(1, int(s["decoded_rows"]))
        span = ((self._consume_t1 - self._consume_t0)
                if self._consume_t0 is not None and self._consume_t1 is not None
                else 0.0)
        stall_pct = (100.0 * s["consumer_wait_s"] / span) if span > 0 else 0.0
        verdict = ("input-bound" if stall_pct > 10.0 else
                   "compute-bound" if s["batches"] else "idle")
        return {
            "batches": int(s["batches"]),
            "rows": int(s["rows"]),
            "epochs": int(s["epochs"]),
            "delivered": int(self._delivered),
            "decode_workers": self.decode_workers,
            "decode_backend": self.decode_backend,
            "prefetch_depth": self.prefetch_depth,
            "stage_depth": self._stage_depth,
            "queue_depth": self._order_q.qsize(),
            "staged": len(self._staged),
            "stages": {
                "read": {"wait_ms_per_batch":
                         round(1e3 * s["read_s"] / batches, 3)},
                "decode": {"ms_per_row":
                           round(1e3 * s["decode_s"] / rows, 3),
                           "workers": self.decode_workers},
                "assemble": {"ms_per_batch":
                             round(1e3 * s["assemble_s"] / batches, 3)},
                "backpressure": {"wait_ms_per_batch":
                                 round(1e3 * s["backpressure_s"] / batches,
                                       3)},
                "stage": {"ms_per_batch":
                          round(1e3 * s["stage_s"] / batches, 3)},
                "consumer": {"wait_ms_per_batch":
                             round(1e3 * s["consumer_wait_s"] / batches,
                                   3)},
            },
            "consume_span_s": round(span, 4),
            "host_stall_pct": round(stall_pct, 2),
            "verdict": verdict,
        }


# every live pipeline, GC-pruned — walked by ONE "io" flight-recorder
# provider (the serving/_live_servers discipline)
_live_pipelines = weakref.WeakSet()


def _pipelines_state():
    views = []
    for it in list(_live_pipelines):
        try:
            views.append(it.get_stats())
        except Exception as err:
            views.append({"error": repr(err)})
    if not views:
        return None
    return views[0] if len(views) == 1 else {"pipelines": views}

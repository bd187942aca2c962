"""Continuous-batching autoregressive generation engine.

Counterpart of ``mxnet_tpu/serving/generation/engine.py``: a
``TransformerParallel`` checkpoint in, token streams out, through the same
three parts.

* **Prefill / decode split.** A new request's prompt is padded up a ladder
  of token-length buckets and runs one causal forward
  (``prefill_forward``: on the card the flash forward kernel in every
  layer), whose K/V go straight into the paged cache, and whose last
  logits give the first sampled token. Each bucket's prefill is one
  fixed-shape step over fixed device buffers (tokens, length, prefix
  length, page row, copy-on-write pair, key, temperature, top-k).
* **One decode step for any batch.** The decode step has fixed shapes: a
  ``max_batch`` slot layout, an active-slot mask, per-slot sampling knobs
  and gather / scatter against the page pools
  (:func:`~...parallel.flash_attention.paged_decode_attention`). Its
  inputs sit in fixed device buffers that each step refreshes from the
  scheduler's host mirrors with one copy; the page pools are updated in
  place (the JAX package donates them); inactive slots write to the trash
  page 0. With speculation the verify step, and in draft mode the draft
  model's decode step, are steps of their own.
* **Iteration-level scheduling.** Between decode steps the scheduler
  evicts finished sequences (EOS / max tokens), frees their pages and
  admits queued requests into the free slots, by SLO class
  (:mod:`..control.slo`). Admission is bounded (``MXNET_GEN_QUEUE``) with
  block / reject backpressure, and reserves each sequence's worst-case
  pages so a mid-flight extension never fails. Results stream through per-
  request handles.

On the card every step (each prefill bucket, decode, verify, draft) is
captured once as a CUDA graph and replayed: the port's counterpart of the
JAX package's one compiled program per step. A capture runs its warm-up
and records with all-trash inputs, so it disturbs no live sequence. On
the CPU the same step bodies run eagerly. :meth:`Generator.warmup`
captures (on the CPU: runs) every step and returns the JAX package's
program count: ``len(prefill_buckets) + 1``, plus 1 with n-gram
speculation, plus 2 with a draft model; ``get_stats()["captures"]`` stays
there under any traffic.

The serving control plane rides on top: with ``prefix_cache=True`` a
radix tree (:class:`~..control.PrefixCache`) shares the KV pages of
page-aligned prompt prefixes copy-on-write across requests, and each
prefill runs only the suffix, attending the cached pages through
:meth:`Generator._suffix_attend`. ``amp`` (``GenerationConfig(amp=True)``
or ``amp`` in ``MXNET_GRAPH_PASSES``) casts the fp32 parameters to
bfloat16 once, at construction; the logits return to fp32 before
sampling. ``page_size`` / ``decode_blocks`` / ``spec_k`` / ``kv_dtype`` and
the control knobs resolve as in the JAX package: explicit config, then the
tuning cache (keyed by :func:`generation_tune_key`), then the flag. Every
request carries a trace, the ``generation.*`` series reach the metrics
registry, and the ``generation.decode_step`` fault point fails only the
faulted step's slots. ``kv_dtype="int8"`` stores symmetric-int8 pages
with one fp32 scale per (position, head) in scale pools beside them: K/V
quantize before every scatter (:func:`_quantize_kv`) and dequantize on
gather inside the paged attention's online softmax; the scale pools are
buffers the captured steps read and write like the pages.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import math
import os
import threading
import time
import weakref

import numpy as np
import torch

from ... import cuda_build, cuda_graph
from ...base import MXNetError, dtype_name
from ...config import get_flag
from ...observability import request_trace as _rtrace
from ...observability import stats_schema as _schema
from ...ops.elemwise import div_scalar
from ...parallel.flash_attention import (paged_decode_attention,
                                         paged_verify_attention)
from ...resilience import faults as _faults
from ..buckets import pick_bucket
from ..control.prefix_cache import PrefixCache
from ..control.slo import ClassQueue, SLOClass, resolve_class
from ..engine import DeadlineExceeded, QueueFullError, ServerClosedError
from .kv_cache import PagePool
from .sampling import SamplingParams, sample_tokens, seed_key, verify_tokens
from .speculative import ngram_propose

# a raise here is contained by the scheduler: the slots in the faulted
# step fail, their pages free, and the loop keeps serving queued requests
_faults.declare("generation.decode_step",
                doc="inside one continuous-batching decode iteration, "
                    "before the step runs")

__all__ = ["GenerationConfig", "Generator", "GenerationHandle",
           "SamplingParams", "SLOClass", "QueueFullError",
           "ServerClosedError", "DeadlineExceeded",
           "default_prefill_ladder"]

# valid KV-page storage dtypes ("model" = the checkpoint's dtype)
KV_DTYPES = frozenset({"model", "bfloat16", "int8"})


def _quantize_kv(arr):
    """Symmetric-int8 quantization of K/V vectors along head_dim: one fp32
    scale per (..., head), ``max(|x|, 1e-8) / 127``, values rounded half
    to even and clipped to +-127. Returns (int8 values, scales)."""
    a32 = arr.float()
    scale = div_scalar(a32.abs().amax(dim=-1).clamp_min(1e-8), 127.0)
    q = torch.round(a32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def default_prefill_ladder(max_seq):
    """Power-of-two prompt-length buckets up to ``max_seq`` (always
    topped by ``max_seq`` itself so any admissible prompt fits)."""
    ladder, b = [], 16
    while b < max_seq:
        ladder.append(b)
        b <<= 1
    ladder.append(int(max_seq))
    return tuple(sorted(set(ladder)))


def generation_tune_key(model, max_batch, max_seq):
    """The ``generation.*`` tuning-cache key of one (checkpoint shape, slot
    geometry): the JAX package's construction, so one cache file resolves
    the same knobs in both packages."""
    c = model.cfg
    sig = "lm-L%d-d%d-H%d-ff%d-e%d-V%d-%s" % (
        c["n_layers"], c["d_model"], c["n_heads"], c["d_ff"],
        c["n_experts"], c["vocab"], dtype_name(model.dtype))
    return (sig, "B%d-T%d" % (int(max_batch), int(max_seq)))


class GenerationConfig:
    """Knobs for :class:`Generator`. Defaults come from the ``MXNET_GEN_*``
    environment, as in the JAX package; ``page_size`` / ``decode_blocks`` /
    ``spec_k`` / ``kv_dtype`` left unset resolve through the tuning cache
    first, then their flags."""

    def __init__(self, page_size=None, decode_blocks=None, max_batch=None,
                 max_seq=None, pool_pages=None, prefill_buckets=None,
                 max_queue=None, backpressure=None, submit_timeout_ms=None,
                 amp=None, kv_dtype=None, prefix_cache=None,
                 prefix_pages=None, slo_aging_ms=None, deadline_ms=None,
                 spec_k=None, spec_ngram=None):
        self.amp = amp
        if kv_dtype is not None:
            kv_dtype = str(kv_dtype).lower()
            if kv_dtype not in KV_DTYPES:
                raise ValueError("kv_dtype must be one of %s, got %r"
                                 % (sorted(KV_DTYPES), kv_dtype))
        self.kv_dtype = kv_dtype
        self.page_size = None if page_size is None else int(page_size)
        self.decode_blocks = (None if decode_blocks is None
                              else int(decode_blocks))
        self.max_batch = (get_flag("MXNET_GEN_MAX_BATCH")
                          if max_batch is None else int(max_batch))
        self.max_seq = (get_flag("MXNET_GEN_MAX_SEQ")
                        if max_seq is None else int(max_seq))
        self.pool_pages = (get_flag("MXNET_GEN_POOL_PAGES")
                           if pool_pages is None else int(pool_pages))
        if prefill_buckets is None:
            spec = os.environ.get("MXNET_GEN_PREFILL_BUCKETS", "").strip()
            prefill_buckets = ([int(t) for t in
                                spec.replace(",", " ").split()]
                               if spec else default_prefill_ladder(
                                   self.max_seq))
        self.prefill_buckets = tuple(sorted(set(
            int(b) for b in prefill_buckets)))
        self.max_queue = (get_flag("MXNET_GEN_QUEUE")
                          if max_queue is None else int(max_queue))
        self.backpressure = (backpressure if backpressure is not None
                             else os.environ.get("MXNET_GEN_BACKPRESSURE",
                                                 "block"))
        # 0 = block forever; > 0 = a queue full this long raises
        self.submit_timeout_ms = (get_flag("MXNET_GEN_SUBMIT_TIMEOUT")
                                  if submit_timeout_ms is None
                                  else float(submit_timeout_ms))
        if self.submit_timeout_ms < 0:
            raise ValueError("submit_timeout_ms must be >= 0 (0 = no "
                             "timeout)")
        self.prefix_cache = (bool(get_flag("MXNET_GEN_PREFIX_CACHE"))
                             if prefix_cache is None else bool(prefix_cache))
        self.prefix_pages = (None if prefix_pages is None
                             else int(prefix_pages))
        self.slo_aging_ms = (None if slo_aging_ms is None
                             else float(slo_aging_ms))
        # default queue deadline of every SLO class without its own
        self.deadline_ms = (float(get_flag("MXNET_GEN_DEADLINE_MS"))
                            if deadline_ms is None else float(deadline_ms))
        self.spec_k = None if spec_k is None else int(spec_k)
        self.spec_ngram = (int(get_flag("MXNET_GEN_SPEC_NGRAM"))
                           if spec_ngram is None else int(spec_ngram))
        if self.spec_k is not None and self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 = speculation off)")
        if self.spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        if self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0 (0 = no deadline)")
        if self.prefix_pages is not None and self.prefix_pages < 0:
            raise ValueError("prefix_pages must be >= 0 (0 = pool-bounded)")
        if self.slo_aging_ms is not None and self.slo_aging_ms < 0:
            raise ValueError("slo_aging_ms must be >= 0 (0 = no aging)")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_seq < 2:
            raise ValueError("max_seq must be >= 2")
        if self.backpressure not in ("block", "reject"):
            raise ValueError("backpressure must be 'block' or 'reject', "
                             "got %r" % (self.backpressure,))
        if not self.prefill_buckets or self.prefill_buckets[0] < 1:
            raise ValueError("prefill_buckets must be positive ints")
        if self.prefill_buckets[-1] > self.max_seq:
            raise ValueError(
                "largest prefill bucket %d exceeds max_seq %d"
                % (self.prefill_buckets[-1], self.max_seq))


class GenerationHandle:
    """One request's result surface: ``result()`` blocks for the full
    generated-token list; ``stream()`` yields tokens as the scheduler
    produces them (iteration-level granularity)."""

    def __init__(self):
        self.future = concurrent.futures.Future()
        self._tokens = collections.deque()
        self._cond = threading.Condition()
        self._closed = False          # guarded-by: self._cond

    # scheduler-side -----------------------------------------------------
    def _push(self, token):
        with self._cond:
            self._tokens.append(token)
            self._cond.notify_all()

    def _finish(self, tokens):
        try:
            self.future.set_result(list(tokens))
        except concurrent.futures.InvalidStateError:
            pass  # cancelled by the caller, or failed by an abandoned drain
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _fail(self, err):
        try:
            self.future.set_exception(err)
        except concurrent.futures.InvalidStateError:
            pass  # already settled: failing is idempotent
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # caller-side --------------------------------------------------------
    def result(self, timeout=None):
        """The full generated token list (excludes the prompt)."""
        return self.future.result(timeout)

    def done(self):
        return self.future.done()

    def stream(self, timeout=None):
        """Yield generated tokens as they arrive; raises the request's
        error (if any) once the stream drains."""
        while True:
            with self._cond:
                while not self._tokens and not self._closed:
                    if not self._cond.wait(timeout):
                        raise TimeoutError("no token within %ss" % timeout)
                if self._tokens:
                    tok = self._tokens.popleft()
                else:
                    break
            yield tok
        err = self.future.exception() if self.future.done() else None
        if err is not None:
            raise err


class _Seq:
    """Scheduler-side state of one admitted sequence (slot-resident)."""

    __slots__ = ("handle", "prompt", "prompt_len", "params", "tokens",
                 "worst", "t_submit", "t_first", "t_last", "trace", "slo")

    def __init__(self, handle, prompt, params, worst, t_submit,
                 trace=_rtrace.NOOP_TRACE, slo=None):
        self.handle = handle
        self.prompt = prompt          # token list (prefix-cache insert)
        self.prompt_len = len(prompt)
        self.params = params          # SamplingParams
        self.worst = worst            # worst-case cached tokens (pages)
        self.tokens = []              # generated so far
        self.t_submit = t_submit
        self.t_first = None
        self.t_last = None            # last token instant (ITL)
        self.trace = trace            # RequestTrace (submit -> evict)
        self.slo = slo if slo is not None else resolve_class(None)


_Pending = collections.namedtuple(
    "_Pending", ["prompt", "params", "handle", "t_submit", "trace",
                 "slo", "deadline"])

# every live generator, GC-pruned: ONE "generation" flight-recorder
# provider walks them
_live_generators = weakref.WeakSet()

# gauges a Generator owns: removed from the registry when it stops or is
# collected, so /metrics never serves a dead engine's last values
_GENERATOR_GAUGES = ("generation.slo_queue_depth",
                     "generation.decode_batch_occupancy",
                     "generation.kv_pages_used",
                     "generation.kv_bytes_used")


def _generators_state():
    views = []
    for gen in list(_live_generators):
        try:
            views.append(gen.get_stats())
        except Exception as err:
            views.append({"error": repr(err)})
    if not views:
        return None
    return views[0] if len(views) == 1 else {"generators": views}


class _Step:
    """One fixed-shape step over the engine's device buffers. On the CPU
    :meth:`run` calls the body; on the card the body is captured once as a
    CUDA graph (warm-up runs on the capture's side stream first, every run
    after ``reset()``, which sets all-trash inputs) and :meth:`run`
    replays it and returns the graph's outputs.

    A kernel wrapper counts its launches where it is called, so a replay
    counts nothing: :attr:`launches` holds the launches of one body run,
    measured over the capture's runs, and :attr:`replays` the replays
    since; their product is what the replays launched."""

    def __init__(self, body, device, reset):
        self.body = body
        self.device = device
        self.reset = reset
        self.graph = None
        self.out = None
        self.replays = 0
        self.launches = {}

    def capture(self):
        before = cuda_build.launch_counts()
        self.graph, self.out = cuda_graph.capture(
            self.body, self.device, reset=self.reset,
            capture_error_mode="thread_local")
        runs = cuda_graph.WARMUP_RUNS + 1
        after = cuda_build.launch_counts()
        self.launches = {k: (n - before.get(k, 0)) // runs
                         for k, n in after.items() if n != before.get(k, 0)}

    def run(self):
        if self.graph is None:
            return self.body()
        self.graph.replay()
        self.replays += 1
        return self.out


class Generator:
    """Continuous-batching autoregressive generator for one checkpoint.

    ::

        model = TransformerParallel(make_mesh({"dp": 1}), vocab=..., ...)
        params = model.load_checkpoint("ckpt")     # or model.init(seed)
        gen = generation.Generator(model, params)
        h = gen.submit([1, 2, 3], SamplingParams(max_new_tokens=16))
        for tok in h.stream():
            ...                                    # or h.result()
        gen.stop()                                 # drains by default

    ``model`` is a :class:`~...parallel.transformer.TransformerParallel`;
    ``params`` its parameter dict (on the model's device). With
    ``spec_k > 0`` each scheduler iteration proposes k draft tokens per
    slot and verifies all k+1 positions in one batched-verify step, token
    for token the non-speculative output; ``draft_model`` /
    ``draft_params`` (a smaller checkpoint with the same vocabulary)
    select the draft-model proposer, else the n-gram proposer runs.
    """

    def __init__(self, model, params, config=None, start=True,
                 draft_model=None, draft_params=None):
        from ... import graph_pass
        from ...observability import flight_recorder, metrics

        self._model = model
        cfg = config if config is not None else GenerationConfig()
        self._cfg = cfg
        c = model.cfg
        self._tune_key = generation_tune_key(model, cfg.max_batch,
                                             cfg.max_seq)
        self.page_size = self._resolve("generation.page_size", "page_size",
                                       cfg.page_size, "MXNET_GEN_PAGE_SIZE")
        self.decode_blocks = self._resolve(
            "generation.decode_blocks", "decode_blocks", cfg.decode_blocks,
            "MXNET_GEN_DECODE_BLOCKS")
        self.spec_k = self._resolve("generation.spec_k", "spec_k",
                                    cfg.spec_k, "MXNET_GEN_SPEC_K",
                                    minimum=0)
        self.spec_ngram = int(cfg.spec_ngram)
        if draft_model is not None:
            if draft_params is None:
                raise ValueError("draft_model requires draft_params")
            if int(draft_model.cfg["vocab"]) != int(c["vocab"]):
                raise ValueError(
                    "draft model vocab %d != target vocab %d — draft "
                    "proposals must be target token ids"
                    % (draft_model.cfg["vocab"], c["vocab"]))
        self.spec_mode = ("off" if self.spec_k == 0
                          else "draft" if draft_model is not None
                          else "ngram")
        self._spec_draft = self.spec_mode == "draft"
        self._draft_model = draft_model if self._spec_draft else None
        self.kv_dtype = self._resolve_kv_dtype(cfg.kv_dtype)
        self._quant_kv = self.kv_dtype == "int8"
        self._device = model.device
        self._params = _detached(params, self._device)
        self._draft_params = (_detached(draft_params, self._device)
                              if self._spec_draft else None)
        # the amp policy: the graph pass's rewrite applied to the model's
        # functions, the fp32 parameters cast to bf16 ONCE here so every
        # step reads half-width weights; logits return to fp32 before
        # sampling (the fp32 island)
        if cfg.amp is None:
            self._amp = "amp" in graph_pass.PassConfig().passes
        else:
            self._amp = bool(cfg.amp)
        if self._amp:
            self._params = _bf16_params(self._params)
            if self._draft_params is not None:
                self._draft_params = _bf16_params(self._draft_params)
            graph_pass.note_program(
                "generation", amp=True, dtype=dtype_name(model.dtype),
                tune_key=list(self._tune_key))

        S = cfg.max_batch
        self._max_pages = -(-cfg.max_seq // self.page_size)
        pool_pages = cfg.pool_pages or (S * self._max_pages + 1)
        L, H = c["n_layers"], c["n_heads"]
        hd = c["d_model"] // H
        pool_dt = {"model": model.dtype, "int8": torch.int8,
                   "bfloat16": torch.bfloat16}[self.kv_dtype]
        # device bytes per cached token: K + V across layers and heads at
        # the pool dtype, plus the per-(position, head) fp32 scales an
        # int8 pool stores beside its pages
        bytes_per_token = 2 * L * H * hd * pool_dt.itemsize
        if self._quant_kv:
            bytes_per_token += 2 * L * H * 4
        self.pool = PagePool(pool_pages, self.page_size,
                             bytes_per_token=bytes_per_token,
                             kv_dtype=self.kv_dtype)
        # the control plane: the prefix cache shares page-aligned prompt
        # prefixes copy-on-write; SLO admission ages between decode steps
        self._use_prefix = bool(cfg.prefix_cache)
        if self._use_prefix:
            cap = self._resolve("control.prefix_pages", "prefix_pages",
                                cfg.prefix_pages, "MXNET_GEN_PREFIX_PAGES",
                                minimum=0)
            self.prefix_cache = PrefixCache(self.pool, capacity_pages=cap)
        else:
            self.prefix_cache = None
        self._aging_ms = self._resolve("control.slo_aging", "aging_ms",
                                       cfg.slo_aging_ms,
                                       "MXNET_GEN_SLO_AGING_MS", minimum=0)
        # the device KV state, updated in place by every step
        shape = (L, pool_pages, self.page_size, H, hd)
        self._pools = {  # guarded-by: self._pages_lock
            "k": torch.zeros(shape, dtype=pool_dt, device=self._device),
            "v": torch.zeros(shape, dtype=pool_dt, device=self._device)}
        if self._quant_kv:
            for name in ("ks", "vs"):
                self._pools[name] = torch.zeros(
                    shape[:-1], dtype=torch.float32, device=self._device)
            # provenance: a dump says these steps decode quantized pages
            graph_pass.note_program("generation", kv_dtype=self.kv_dtype,
                                    tune_key=list(self._tune_key))
        if self._spec_draft:
            dc = draft_model.cfg
            dshape = (dc["n_layers"], pool_pages, self.page_size,
                      dc["n_heads"], dc["d_model"] // dc["n_heads"])
            for name in ("dk", "dv"):
                self._pools[name] = torch.zeros(
                    dshape, dtype=draft_model.dtype, device=self._device)
            self.draft_bytes_per_token = (
                2 * dc["n_layers"] * dc["d_model"]
                * draft_model.dtype.itemsize)
        else:
            self.draft_bytes_per_token = 0

        self._build_mirrors()
        self._steps = {}
        for bucket in cfg.prefill_buckets:
            self._steps["prefill%d" % bucket] = _Step(
                self._prefill_body(bucket), self._device,
                self._reset_prefill_inputs)
        self._steps["decode"] = _Step(self._decode_body, self._device,
                                      self._reset_inputs)
        if self.spec_k:
            self._steps["verify"] = _Step(self._verify_body, self._device,
                                          self._reset_inputs)
        if self._spec_draft:
            self._steps["draft"] = _Step(self._draft_body, self._device,
                                         self._reset_inputs)
        self._captures = 0            # guarded-by: self._pages_lock
        self._slots = [None] * S      # _Seq per occupied slot

        self._cond = threading.Condition()
        self._queue = ClassQueue(aging_ms=self._aging_ms)  # guarded-by: self._cond
        self._stop = False                  # guarded-by: self._cond
        self._abort = False                 # guarded-by: self._cond
        self._n_active = 0                  # guarded-by: self._cond
        self._lock = threading.Lock()
        self._stats = collections.Counter()  # guarded-by: self._lock
        # serializes the device work: the scheduler thread owns it in
        # steady state, but warmup() runs on the caller's thread
        self._pages_lock = threading.Lock()
        self._thread = None
        self._life = threading.Lock()  # serializes start()/stop()
        _live_generators.add(self)
        flight_recorder.register_provider("generation", _generators_state)
        metrics.unregister_on_collect(self, _GENERATOR_GAUGES)
        if start:
            self.start()

    def _resolve(self, op, field, explicit, flag, minimum=1):
        """Knob resolution: explicit config value > tuning cache > flag.
        ``minimum`` bounds what a cache entry may supply; a corrupt entry
        falls back to the flag (tuning is an optimization)."""
        if explicit is not None:
            val = int(explicit)
        else:
            from ... import autotune

            tuned = autotune.lookup(op, key=self._tune_key)
            val = None
            if isinstance(tuned, dict):
                try:
                    val = int(tuned.get(field))
                except (TypeError, ValueError):
                    val = None
                if val is not None and val < minimum:
                    val = None
            if val is None:
                val = int(get_flag(flag))
        if val < minimum:
            raise ValueError("%s must be >= %d, got %d"
                             % (flag, minimum, val))
        return val

    def _resolve_kv_dtype(self, explicit):
        """Explicit config value > ``generation.kv_dtype`` tuning-cache
        entry > MXNET_GEN_KV_DTYPE > "model"."""
        if explicit is not None:
            return explicit  # validated by GenerationConfig
        from ... import autotune

        tuned = autotune.lookup("generation.kv_dtype", key=self._tune_key)
        if isinstance(tuned, dict):
            val = str(tuned.get("kv_dtype", "")).lower()
            if val in KV_DTYPES:
                return val
        env = os.environ.get("MXNET_GEN_KV_DTYPE", "").strip().lower()
        return env if env in KV_DTYPES else "model"

    @classmethod
    def from_checkpoint(cls, path, model, **kwargs):
        """Generator over a :meth:`TransformerParallel.save_checkpoint`
        file — the training-to-serving handoff."""
        return cls(model, model.load_checkpoint(path), **kwargs)

    # ------------------------------------------------------ step buffers
    def _build_mirrors(self):
        """The scheduler's host mirrors of the steps' inputs, as views of
        one int64 array (and one fp32 array of temperatures), and the
        device buffers they are copied into before each step, as views of
        one device tensor: one copy refreshes every input. The decode
        steps and the prefill steps each have such a pair. The slots'
        sampling keys live on the device only, advanced in place by the
        steps."""
        S, P, k = self._cfg.max_batch, self._max_pages, self.spec_k
        fields = (("page_table", (S, P)), ("seq_len", (S,)),
                  ("active", (S,)), ("last_token", (S,)), ("top_k", (S,)),
                  ("span", (S,)), ("draft", (S, k)), ("draft_seq", (S,)),
                  ("draft_active", (S,)), ("draft_token", (S,)))
        self._host_ints, self._dev_ints, self._dev = self._mirror(fields)
        for name, view in self._views(self._host_ints, fields):
            setattr(self, "_" + name, view)
        self._temp = np.zeros(S, np.float32)
        self._dev_temp = torch.zeros(S, dtype=torch.float32,
                                     device=self._device)
        self._keys = torch.zeros((S, 2), dtype=torch.int64,
                                 device=self._device)
        # one prefill's inputs: the suffix tokens (padded to the top
        # bucket; a bucket's step reads its leading columns), its length,
        # the cached prefix length, the page row, the copy-on-write (src,
        # dst) pair, the request's key and sampling knobs
        pfields = (("tokens", (1, self._cfg.prefill_buckets[-1])),
                   ("length", (1,)), ("prefix_len", (1,)),
                   ("page_row", (P,)), ("cow", (2,)), ("key", (1, 2)),
                   ("top_k", (1,)))
        self._pre_host, self._pre_dev_ints, self._pre = self._mirror(pfields)
        self._pre_host_view = dict(self._views(self._pre_host, pfields))
        self._pre_temp_host = np.zeros(1, np.float32)
        self._pre_temp = torch.zeros(1, dtype=torch.float32,
                                     device=self._device)

    @staticmethod
    def _views(flat, fields):
        at = 0
        for name, shape in fields:
            size = int(np.prod(shape))
            yield name, flat[at:at + size].reshape(shape)
            at += size

    def _mirror(self, fields):
        n = sum(int(np.prod(shape)) for _, shape in fields)
        host = np.zeros(n, np.int64)
        dev = torch.zeros(n, dtype=torch.int64, device=self._device)
        return host, dev, dict(self._views(dev, fields))

    def _upload(self):
        """Copy the decode steps' host mirrors into their device buffers."""
        self._dev_ints.copy_(torch.from_numpy(self._host_ints))
        self._dev_temp.copy_(torch.from_numpy(self._temp))

    def _reset_inputs(self):
        """All slots inactive in the device buffers (warm-up and capture):
        writes land on the trash page, keys stay as they are."""
        self._dev_ints.zero_()
        self._dev_temp.zero_()

    def _reset_prefill_inputs(self):
        """An all-trash prefill (warm-up and capture): one token of
        prompt, no prefix, every row on the trash page, greedy."""
        self._pre_dev_ints.zero_()
        self._pre["length"].fill_(1)
        self._pre_temp.zero_()

    def _captured(self, name):
        """The step ``name``; on the card its graph is captured first if it
        has none. Caller holds ``_pages_lock``."""
        step = self._steps[name]
        if step.graph is None and self._device.type == "cuda":
            step.capture()
            self._captures += 1
        return step

    def _run(self, name):
        """Refresh the decode inputs and run one step. Caller holds
        ``_pages_lock``."""
        step = self._captured(name)
        self._upload()
        return step.run()

    def _fill_prefill(self, tokens, length, prefix_len, row, cow, key, temp,
                      top_k):
        """Copy one prefill's inputs into the prefill buffers (one copy):
        the suffix ``tokens`` (zero-padded), their ``length``, the cached
        ``prefix_len``, the page ``row``, the copy-on-write ``cow`` (src,
        dst) pair and the sampling ``key`` / ``temp`` / ``top_k``."""
        h = self._pre_host_view
        h["tokens"][:] = 0
        h["tokens"][0, :len(tokens)] = tokens
        h["length"][0] = length
        h["prefix_len"][0] = prefix_len
        h["page_row"][:] = row
        h["cow"][:] = cow
        h["key"][0] = key
        h["top_k"][0] = top_k
        self._pre_temp_host[0] = temp
        self._pre_dev_ints.copy_(torch.from_numpy(self._pre_host))
        self._pre_temp.copy_(torch.from_numpy(self._pre_temp_host))

    def _run_prefill(self, bucket, *inputs):
        """Run bucket ``bucket``'s prefill step on ``inputs`` (as
        :meth:`_fill_prefill` takes them). Returns (token (1,), new key
        (1, 2)) device tensors, the step's own outputs: read them before
        the next prefill. Caller holds ``_pages_lock``."""
        step = self._captured("prefill%d" % bucket)
        self._fill_prefill(*inputs)
        return step.run()

    # ----------------------------------------------------------- the steps
    def _scatter(self, pools, kname, vname, index, k_new, v_new):
        """Write new K/V vectors into two page planes at ``index`` ((layer,
        page, offset) or (all layers, page, offset)), in the planes'
        dtype; the target planes of an int8 pool quantize on the way in,
        their scales landing in the scale pools at the same coordinates
        (draft planes never quantize)."""
        if self._quant_kv and kname == "k":
            for name, new in (("k", k_new), ("v", v_new)):
                pools[name][index], pools[name + "s"][index] = \
                    _quantize_kv(new)
            return
        pools[kname][index] = k_new.to(pools[kname].dtype)
        pools[vname][index] = v_new.to(pools[vname].dtype)

    def _scales(self, li):
        """(k_scale, v_scale) of layer ``li`` for the paged attention: the
        scale pools of an int8 pool, else (None, None)."""
        if not self._quant_kv:
            return None, None
        return self._pools["ks"][li], self._pools["vs"][li]

    def _suffix_attend(self, page_row, prefix_len, kname="k", vname="v"):
        """Attention hook of the prefix cache's suffix prefill: each suffix
        query attends the cached prefix (gathered from the page planes
        ``kname`` / ``vname`` through this slot's page row, masked to
        ``prefix_len``) plus the causal suffix itself, with scores,
        softmax and the P.V products in fp32. The fresh suffix K/V round-
        trip through the pages' dtype (an int8 pool's through its quantize
        and dequantize, its pages dequantizing on gather), so a later
        request that reads these positions from the cache sees the same
        values (warm and cold agree token for token). ``prefix_len == 0``
        masks the whole gathered region: one step per bucket serves hits
        and misses alike. The
        products are ``torch.einsum``, as the JAX package computes them
        outside any Pallas kernel."""
        max_ctx = self._max_pages * self.page_size
        pools = self._pools
        quant = self._quant_kv and kname == "k"

        def attend(li, q, k, v):
            T, hd = q.shape[2], q.shape[3]
            kp = pools[kname][li][page_row].reshape(max_ctx, -1, hd).float()
            vp = pools[vname][li][page_row].reshape(max_ctx, -1, hd).float()
            if quant:
                kp = kp * pools["ks"][li][page_row].reshape(
                    max_ctx, -1)[..., None]
                vp = vp * pools["vs"][li][page_row].reshape(
                    max_ctx, -1)[..., None]
                kq, ksc = _quantize_kv(k)
                vq, vsc = _quantize_kv(v)
                k = kq.float() * ksc[..., None]
                v = vq.float() * vsc[..., None]
            else:
                k = k.to(pools[kname].dtype).float()
                v = v.to(pools[vname].dtype).float()
            qf = q.float() * (1.0 / math.sqrt(hd))
            sp = torch.einsum("bhqd,khd->bhqk", qf, kp)
            live = torch.arange(max_ctx, device=q.device) < prefix_len
            sp = sp.masked_fill(~live, float("-inf"))
            ss = torch.einsum("bhqd,bhkd->bhqk", qf, k)
            causal = torch.ones((T, T), dtype=torch.bool,
                                device=q.device).tril()
            ss = ss.masked_fill(~causal, float("-inf"))
            s = torch.cat([sp, ss], dim=-1)
            # every row's own (causal-diagonal) score is live: the max is
            # finite and the denominator positive
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
            w = p / p.sum(dim=-1, keepdim=True)
            out = (torch.einsum("bhqk,khd->bhqd", w[..., :max_ctx], vp)
                   + torch.einsum("bhqk,bhkd->bhqd", w[..., max_ctx:], v))
            return out.to(q.dtype)

        return attend

    def _prefill_body(self, bucket):
        """The body of bucket ``bucket``'s prefill step, over the prefill
        input buffers."""
        def body():
            b = self._pre
            return self._prefill_step(
                b["tokens"][:, :bucket], b["length"], b["prefix_len"],
                b["page_row"], b["cow"], b["key"], self._pre_temp,
                b["top_k"])

        return body

    def _prefill_step(self, tokens, length, prefix_len, page_row, cow, key,
                      temp, top_k):
        """One prompt bucket's prefill: causal forward over the (suffix)
        ``tokens`` (1, bucket), K/V scattered into the pages of
        ``page_row`` (max_pages,; 0-padded, so rows past the owned pages
        land on the trash page), the first token sampled from row
        ``length - 1``. With the prefix cache, ``prefix_len`` positions
        are served read-only from shared pages through
        :meth:`_suffix_attend`, and the ``cow[0] -> cow[1]`` page copy
        privatizes the last shared page before a write lands in it (0 ->
        0 is a trash-page no-op). In draft mode the draft model's prefill
        writes its planes at the same coordinates, in the same step.
        Every argument is a device tensor. Returns (token (1,), new key
        (1, 2))."""
        dev = tokens.device
        bucket = tokens.shape[1]
        pools = self._pools
        if self._use_prefix:
            for plane in pools.values():
                plane.index_copy_(1, cow[1:], plane.index_select(1, cow[:1]))
            attend = self._suffix_attend(page_row, prefix_len)
        else:
            attend = None  # cold engines keep the flash prefill
        logits, ks, vs = self._model.prefill_forward(self._params, tokens,
                                                     attend=attend)
        pos = prefix_len + torch.arange(bucket, device=dev)
        pidx = pos // self.page_size
        # padded suffix rows past the page table go to the trash page (a
        # suffix bucket may overhang max_seq when the prefix is long)
        dest = torch.where(pidx < self._max_pages,
                           page_row[pidx.clamp(max=self._max_pages - 1)],
                           torch.zeros_like(pidx))
        off = pos % self.page_size
        self._scatter(pools, "k", "v", (slice(None), dest, off), ks[:, 0],
                      vs[:, 0])
        if self._spec_draft:
            d_attend = (self._suffix_attend(page_row, prefix_len, "dk",
                                            "dv")
                        if self._use_prefix else None)
            _, dks, dvs = self._draft_model.prefill_forward(
                self._draft_params, tokens, attend=d_attend)
            self._scatter(pools, "dk", "dv", (slice(None), dest, off),
                          dks[:, 0], dvs[:, 0])
        last = logits[0].float().index_select(0, length - 1)
        return sample_tokens(last, key, temp, top_k)

    def _slot_dest(self, page_table, seq_len, active):
        """(page, offset) of each slot's write at position ``seq_len``;
        inactive slots write to the trash page 0."""
        pidx = (seq_len // self.page_size).clamp(max=self._max_pages - 1)
        page = page_table.gather(1, pidx[:, None])[:, 0]
        return (torch.where(active, page, torch.zeros_like(page)),
                seq_len % self.page_size)

    def _decode_body(self):
        """THE decode step: one token for every slot, active or not, from
        the device buffers. Returns (S,) tokens, -1 for inactive slots;
        the sampled slots' keys advance in place."""
        b = self._dev
        active = b["active"] != 0
        seq_len = b["seq_len"]
        dest, off = self._slot_dest(b["page_table"], seq_len, active)
        pools = self._pools

        def attend(li, q, k_new, v_new):
            self._scatter(pools, "k", "v", (li, dest, off), k_new, v_new)
            k_scale, v_scale = self._scales(li)
            return paged_decode_attention(
                q, pools["k"][li], pools["v"][li], b["page_table"],
                seq_len + 1, block_tokens=self.decode_blocks,
                k_scale=k_scale, v_scale=v_scale)

        logits = self._model.decode_forward(self._params, b["last_token"],
                                            attend)
        toks, new_keys = sample_tokens(logits.float(), self._keys,
                                       self._dev_temp, b["top_k"])
        self._keys.copy_(torch.where(active[:, None], new_keys, self._keys))
        return torch.where(active, toks, torch.full_like(toks, -1))

    def _draft_body(self):
        """THE draft-model decode step (draft speculation): one greedy
        step of the draft model against its ``dk``/``dv`` planes at
        ``draft_seq``, for the slots in ``draft_active``. Returns (S,)
        proposals."""
        b = self._dev
        seq_len = b["draft_seq"]
        dest, off = self._slot_dest(b["page_table"], seq_len,
                                    b["draft_active"] != 0)
        pools = self._pools

        def attend(li, q, k_new, v_new):
            self._scatter(pools, "dk", "dv", (li, dest, off), k_new, v_new)
            return paged_decode_attention(
                q, pools["dk"][li], pools["dv"][li], b["page_table"],
                seq_len + 1, block_tokens=self.decode_blocks)

        logits = self._draft_model.decode_forward(
            self._draft_params, b["draft_token"], attend)
        return torch.argmax(logits.float(), dim=-1)

    def _verify_body(self):
        """THE batched-verify step of speculative decoding: all k+1
        candidate positions of every slot in one forward, K/V scattered
        optimistically (positions at or past ``span`` go to the trash page;
        rejected ones stay masked by the committed lengths), acceptance by
        :func:`~.sampling.verify_tokens`. Returns (S, k+2): the emitted
        tokens and, last, each slot's count."""
        b = self._dev
        P, page = self._max_pages, self.page_size
        active = b["active"] != 0
        seq_len = b["seq_len"]
        Q = self.spec_k + 1
        tokens = torch.cat([b["last_token"][:, None], b["draft"]], dim=1)
        qi = torch.arange(Q, device=seq_len.device)
        pos = seq_len[:, None] + qi[None, :]
        pidx = pos // page
        ok = active[:, None] & (qi[None, :] < b["span"][:, None]) & (pidx < P)
        page_ids = b["page_table"].gather(1, pidx.clamp(max=P - 1))
        dest = torch.where(ok, page_ids, torch.zeros_like(page_ids))
        off = pos % page
        pools = self._pools

        def attend(li, q, k_new, v_new):
            self._scatter(pools, "k", "v", (li, dest, off), k_new, v_new)
            k_scale, v_scale = self._scales(li)
            return paged_verify_attention(
                q, pools["k"][li], pools["v"][li], b["page_table"], seq_len,
                block_tokens=self.decode_blocks, k_scale=k_scale,
                v_scale=v_scale)

        logits = self._model.verify_forward(self._params, tokens, attend)
        out, n_emit, new_keys = verify_tokens(
            logits.float(), b["draft"], b["span"], active, self._keys,
            self._dev_temp, b["top_k"])
        self._keys.copy_(new_keys)
        return torch.cat([out, n_emit[:, None]], dim=1)

    def _device_scope(self):
        """The scope every device call runs in: no autograd (grad mode is
        per thread) and the model's card as the current device."""
        scope = contextlib.ExitStack()
        scope.enter_context(torch.no_grad())
        if self._device.type == "cuda":
            scope.enter_context(torch.cuda.device(self._device))
        return scope

    def warmup(self):
        """Capture (on the CPU: run) every step with all-trash inputs, so
        the first request pays no kernel build or capture: each prefill
        bucket, decode, and verify / draft decode with speculation.
        Returns the number of programs warmed: ``len(prefill_buckets) +
        1`` (+1 verify, +1 draft decode).

        Safe while traffic flows: warmup drives synthetic all-trash inputs
        (writes land only on the trash page, keys stay) and holds the lock
        the scheduler holds for its device work."""
        n = 0
        with self._pages_lock, self._device_scope():
            for name, step in self._steps.items():
                self._captured(name)
                step.reset()
                out = step.run()
                (out[0] if isinstance(out, tuple) else out).cpu()
                n += 1
        return n

    # ----------------------------------------------------------- lifecycle
    def start(self):
        """Launch the scheduler thread (idempotent)."""
        with self._life:
            if self._thread is not None and self._thread.is_alive():
                return self
            with self._cond:
                self._stop = False
                self._abort = False
            self._thread = threading.Thread(
                target=self._loop, name="mxnet-generation-scheduler",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, drain=True, timeout=None):
        """Shut down. ``drain=True`` (default) finishes every admitted
        and queued request first; ``drain=False`` fails queued AND
        in-flight requests with :class:`ServerClosedError`. ``timeout``
        (seconds) bounds the drain: past it every pending request fails
        with :class:`ServerClosedError` and ``stop`` returns. A speculative
        step racing the stop commits every token it accepted before the
        loop reads the stop state again. The prefix cache releases its
        pages once the scheduler is down, so a drained pool holds none."""
        from ...observability import metrics

        with self._cond:
            self._stop = True
            self._abort = not drain
            self._cond.notify_all()
        with self._life:
            thread, self._thread = self._thread, None
            if thread is not None:
                thread.join(timeout)
                if thread.is_alive():
                    self._abandon_drain(timeout)
            elif self._queue or self._n_active:
                self._loop()  # never started: honor the drain contract
            if (self.prefix_cache is not None
                    and (thread is None or not thread.is_alive())):
                self.prefix_cache.clear()
        for name in _GENERATOR_GAUGES:
            metrics.unregister(name)
        return self

    def _abandon_drain(self, timeout):
        """Drain timed out: unblock every caller. Slot state and pages
        stay with the wedged scheduler thread (it aborts if it ever
        unwedges); handles fail, idempotently."""
        err = ServerClosedError(
            "stop(drain=True) timed out after %ss; remaining requests "
            "failed" % timeout)
        with self._cond:
            self._abort = True
            stranded = self._queue.drain()
            self._class_gauges(self._queue.depths())
            self._cond.notify_all()
        for ent in stranded:
            ent.handle._fail(err)
            ent.trace.finish("error")
        for seq in list(self._slots):
            if seq is not None:
                seq.handle._fail(err)
                seq.trace.finish("error")
        with self._lock:
            self._stats["drain_timeouts"] += 1

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=True)

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    # -------------------------------------------------------------- submit
    def submit(self, prompt, params=None, slo=None):
        """Enqueue one generation request; returns a
        :class:`GenerationHandle`. ``prompt``: iterable of int token ids;
        ``params``: :class:`SamplingParams` (default: greedy, 32 new
        tokens); ``slo``: an :class:`~..control.SLOClass`, a builtin tier
        name (``"interactive"``/``"standard"``/``"batch"``), or None for
        the standard tier. Queue-expired requests fail with
        :class:`DeadlineExceeded` before prefill."""
        from ...observability import metrics

        params = params if params is not None else SamplingParams()
        slo_cls = resolve_class(slo)
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        top = self._cfg.prefill_buckets[-1]
        if len(prompt) > top:
            raise ValueError(
                "prompt of %d tokens exceeds the largest prefill bucket "
                "%d (raise MXNET_GEN_PREFILL_BUCKETS / max_seq)"
                % (len(prompt), top))
        if len(prompt) + params.max_new_tokens > self._cfg.max_seq:
            raise ValueError(
                "prompt %d + max_new_tokens %d exceeds max_seq %d"
                % (len(prompt), params.max_new_tokens, self._cfg.max_seq))
        worst = len(prompt) + params.max_new_tokens - 1
        if self.pool.pages_for(worst) > self.pool.capacity:
            raise ValueError(
                "request needs %d KV pages but the pool only holds %d "
                "(raise MXNET_GEN_POOL_PAGES)"
                % (self.pool.pages_for(worst), self.pool.capacity))
        handle = GenerationHandle()
        # request-scoped trace: queue ends at admission, a prefix_match
        # phase covers the cache lookup, prefill ends at the first token
        # (TTFT), one decode phase per generated token
        trace = _rtrace.begin("generation")
        trace.annotate(prompt_len=len(prompt),
                       max_new_tokens=params.max_new_tokens,
                       slo=slo_cls.name)
        t_submit = time.monotonic()
        dl_ms = (slo_cls.deadline_ms if slo_cls.deadline_ms is not None
                 else self._cfg.deadline_ms)
        deadline = (t_submit + dl_ms / 1e3) if dl_ms > 0 else None
        ent = _Pending(prompt, params, handle, t_submit, trace, slo_cls,
                       deadline)
        with self._cond:
            if self._stop:
                trace.finish("rejected")
                raise ServerClosedError("submit() after stop()")
            if self._cfg.backpressure == "reject":
                if len(self._queue) >= self._cfg.max_queue:
                    with self._lock:
                        self._stats["rejected"] += 1
                    metrics.counter("generation.rejected").inc()
                    trace.finish("rejected")
                    raise QueueFullError(
                        "admission queue full (%d requests); raise "
                        "MXNET_GEN_QUEUE or use backpressure='block'"
                        % len(self._queue))
            else:
                wait_s = self._cfg.submit_timeout_ms / 1e3
                give_up = (time.monotonic() + wait_s) if wait_s > 0 else None
                while len(self._queue) >= self._cfg.max_queue:
                    remaining = (None if give_up is None
                                 else give_up - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        with self._lock:
                            self._stats["submit_timeouts"] += 1
                        metrics.counter("generation.submit_timeouts").inc()
                        trace.finish("rejected")
                        raise QueueFullError(
                            "admission queue still full after %.0f ms "
                            "(MXNET_GEN_SUBMIT_TIMEOUT); %d requests "
                            "queued" % (self._cfg.submit_timeout_ms,
                                        len(self._queue)))
                    self._cond.wait(remaining)
                    if self._stop:
                        trace.finish("rejected")
                        raise ServerClosedError(
                            "server stopped while submit() was blocked")
            self._queue.push(ent)
            depths = self._queue.depths()
            self._cond.notify_all()
        with self._lock:
            self._stats["requests"] += 1
        metrics.counter("generation.requests").inc()
        metrics.counter("generation.slo_requests",
                        labels={"slo": slo_cls.name},
                        help="requests submitted per SLO class").inc()
        self._class_gauges(depths)
        return handle

    @staticmethod
    def _class_gauges(depths):
        """Refresh every per-class queue-depth gauge, on each queue
        transition, so an emptied class reads 0."""
        from ...observability import metrics

        for name, depth in depths.items():
            metrics.gauge("generation.slo_queue_depth",
                          labels={"slo": name},
                          help="queued requests per SLO class").set(depth)

    def generate(self, prompt, params=None, timeout=None):
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, params).result(timeout)

    # ----------------------------------------------------------- scheduler
    def _loop(self):
        from ...observability import metrics

        with self._device_scope():
            while True:
                aborted = None
                with self._cond:
                    while (not self._queue and not self._n_active
                           and not self._stop):
                        self._cond.wait()
                    if self._stop:
                        if self._abort:
                            aborted = self._queue.drain()
                            self._class_gauges(self._queue.depths())
                            self._cond.notify_all()
                        elif not self._queue and not self._n_active:
                            return
                if aborted is not None:
                    self._fail_all(aborted)
                    return
                self._admit_pending()
                if self._n_active:
                    try:
                        if self.spec_k:
                            self._spec_once()
                        else:
                            self._decode_once()
                    except Exception as err:
                        # contain the fault to the slots of the faulted
                        # step; the loop keeps serving queued traffic (the
                        # pools are updated in place: no other slot's
                        # cache is lost)
                        with self._lock:
                            self._stats["decode_faults"] += 1
                        metrics.counter("generation.decode_faults").inc()
                        for slot, seq in enumerate(self._slots):
                            if seq is not None:
                                self._evict(slot, failed=err)

    def _fail_all(self, pending):
        err = ServerClosedError("generator stopped without draining")
        for ent in pending:
            ent.handle._fail(err)
            ent.trace.finish("error")
        for slot, seq in enumerate(self._slots):
            if seq is not None:
                self._evict(slot, failed=err)

    def _free_slot(self):
        for s, seq in enumerate(self._slots):
            if seq is None:
                return s
        return None

    def _shed(self, expired):
        """Fail queue-expired requests with DeadlineExceeded before any
        prefill runs for them."""
        from ...observability import metrics

        now = time.monotonic()
        for ent in expired:
            ent.handle._fail(DeadlineExceeded(
                "generation request expired in queue after %.0f ms "
                "(class %r deadline)" % ((now - ent.t_submit) * 1e3,
                                         ent.slo.name)))
            ent.trace.finish("deadline_expired")
            metrics.counter("generation.deadline_expired").inc()
            metrics.counter("generation.slo_expired",
                            labels={"slo": ent.slo.name},
                            help="queue-expired requests per SLO class"
                            ).inc()
        with self._lock:
            self._stats["expired"] += len(expired)

    def _pressure_admit(self, ent, worst):
        """The conservative ``can_admit(worst)`` gate failed: account the
        sharing the request would get before reclaiming anything. A probe
        match (counters untouched, refs dropped right back; the scheduler
        thread is the only evictor, so the real match in ``_prefill`` sees
        the same tree) supplies the shared-page discount; only the
        remaining shortfall of cold cached prefixes is reclaimed, LRU
        first. Returns True when admission can proceed."""
        if self.prefix_cache is None:
            return False
        for attempt in range(2):
            shared, matched = self.prefix_cache.match(ent.prompt,
                                                      record=False)
            cow = matched > 0 and matched == len(ent.prompt)
            n_shared = len(shared)
            for p in shared:
                self.pool.decref(p)
            if self.pool.can_admit(worst, shared_pages=n_shared, cow=cow):
                return True
            if attempt or not self.prefix_cache.reclaim(
                    self.pool.admission_shortfall(
                        worst, shared_pages=n_shared, cow=cow)):
                return False
        return False

    def _admit_pending(self):
        """Admit queued requests into free slots between decode steps, in
        the SLO scheduler's order, shedding queue-expired ones first; a
        pool full of cached prefixes reclaims them under pressure."""
        while True:
            with self._cond:
                expired = self._queue.shed_expired(time.monotonic())
                depths = self._queue.depths() if expired else None
                if expired:
                    self._cond.notify_all()  # queue space freed
            if expired:
                self._shed(expired)
                self._class_gauges(depths)
            slot = self._free_slot()
            if slot is None:
                return
            with self._cond:
                ent = self._queue.select(time.monotonic())
                if ent is None:
                    return
                worst = len(ent.prompt) + ent.params.max_new_tokens - 1
                if not self.pool.can_admit(worst):
                    if not self._pressure_admit(ent, worst):
                        return  # decode on, eviction frees some pages
                self._queue.pop(ent)
                depths = self._queue.depths()
                self._n_active += 1
                self._cond.notify_all()  # wake blocked submitters
            self._class_gauges(depths)
            try:
                self._prefill(slot, ent, worst)
            except Exception as err:  # fail THIS request, not the thread
                self._reset_slot(slot, worst)
                with self._cond:
                    self._n_active -= 1
                    self._cond.notify_all()
                ent.handle._fail(err)
                ent.trace.finish("error")

    def _prefill(self, slot, ent, worst):
        from ...observability import metrics

        plen = len(ent.prompt)
        sp = ent.params
        ent.trace.event("queue")  # admission = end of queue wait
        # the prefix-cache match: the longest cached page-aligned prefix
        # attaches read-only, only the suffix prefills
        shared, matched, cow = [], 0, False
        if self.prefix_cache is not None:
            shared, matched = self.prefix_cache.match(ent.prompt)
            # a prompt that IS a cached page-aligned prefix still needs its
            # last token recomputed (the first token's logits); that one
            # write lands in the last shared page: copy-on-write
            cow = matched > 0 and matched == plen
            ent.trace.annotate(prefix_hit=bool(matched),
                               prefix_tokens=int(matched))
            metrics.counter("generation.prefix_hits" if matched
                            else "generation.prefix_misses").inc()
            ent.trace.event("prefix_match")
        suffix_start = plen - 1 if cow else matched
        suffix = ent.prompt[suffix_start:]
        if suffix_start:
            metrics.counter("generation.prefill_tokens_skipped").inc(
                suffix_start)
            with self._lock:
                self._stats["prefix_hits"] += 1
                self._stats["prefill_tokens_skipped"] += suffix_start
        bucket = pick_bucket(len(suffix), self._cfg.prefill_buckets)
        try:
            pages = self.pool.admit(slot, plen, worst, shared_pages=shared,
                                    cow_last=cow)
        except BaseException:
            for p in shared:
                self.pool.decref(p)  # match's refs never reached a slot
            raise
        cow_pair = (0, 0)
        if cow:
            cow_pair = self.pool.cow(slot, len(shared) - 1)
            pages = self.pool.pages_of(slot)
        row = np.zeros(self._max_pages, np.int64)
        row[:len(pages)] = pages
        with self._pages_lock:
            tok, nkey = self._run_prefill(
                bucket, suffix, len(suffix), suffix_start, row, cow_pair,
                seed_key(sp.seed), sp.temperature, sp.top_k)
            self._keys[slot].copy_(nkey[0])
            # the one host sync of admission: the prompt's first token,
            # the time-to-first-token mark
            first = int(tok[0])
        seq = _Seq(ent.handle, ent.prompt, sp, worst, ent.t_submit,
                   ent.trace, slo=ent.slo)
        seq.t_first = seq.t_last = time.monotonic()
        ent.trace.event("prefill")
        ent.trace.annotate(prefill_bucket=bucket, slot=slot)
        metrics.histogram(
            "generation.ttft_ms",
            help="time to first token (submit -> first sampled token)"
        ).observe((seq.t_first - ent.t_submit) * 1e3)
        self._slots[slot] = seq
        self._page_table[slot, :] = row
        self._seq_len[slot] = plen
        self._active[slot] = 1
        self._last_token[slot] = first
        self._temp[slot] = sp.temperature
        self._top_k[slot] = sp.top_k
        with self._lock:
            self._stats["prefills"] += 1
            self._stats["tokens"] += 1
        metrics.counter("generation.prefill_batches").inc()
        metrics.counter("generation.tokens_generated").inc()
        self._emit(slot, first)

    def _emit(self, slot, token):
        """Stream one token; evict on EOS / max-tokens."""
        seq = self._slots[slot]
        seq.tokens.append(token)
        seq.handle._push(token)
        if (token == seq.params.eos_id
                or len(seq.tokens) >= seq.params.max_new_tokens):
            self._evict(slot)

    def _reset_slot(self, slot, worst):
        self._slots[slot] = None
        self._active[slot] = 0
        self._seq_len[slot] = 0
        self._last_token[slot] = 0
        self._temp[slot] = 0.0
        self._top_k[slot] = 0
        self._page_table[slot, :] = 0
        self.pool.release(slot, worst)

    def _evict(self, slot, failed=None):
        from ...observability import metrics

        seq = self._slots[slot]
        if failed is None and self.prefix_cache is not None:
            # cold prefixes enter the tree on eviction: the prompt's full
            # pages served real traffic and hold position-exact K/V
            # (decode writes never land below the prompt's last full page)
            try:
                self.prefix_cache.insert(seq.prompt,
                                         self.pool.pages_of(slot))
            except Exception:
                with self._lock:
                    self._stats["prefix_insert_errors"] += 1
        self._reset_slot(slot, seq.worst)
        with self._cond:
            self._n_active -= 1
            self._cond.notify_all()
        if failed is not None:
            seq.handle._fail(failed)
            seq.trace.finish("error")
        else:
            seq.handle._finish(seq.tokens)
            seq.trace.finish("ok")
            metrics.counter("generation.slo_completed",
                            labels={"slo": seq.slo.name},
                            help="completed requests per SLO class").inc()
        with self._lock:
            self._stats["evicted"] += 1
            if failed is None:
                self._stats["completed"] += 1
        metrics.counter("generation.sequences_evicted").inc()

    def _decode_once(self):
        """One iteration of the continuous-batching loop: extend pages
        where a sequence crosses a page boundary, run THE decode step,
        stream the sampled tokens, evict the finished."""
        from ...observability import metrics

        t0 = time.monotonic()
        _faults.inject("generation.decode_step")
        for slot, seq in enumerate(self._slots):
            if seq is None:
                continue
            need = int(self._seq_len[slot]) // self.page_size
            if need >= len(self.pool.pages_of(slot)):  # extend-on-decode
                self._page_table[slot, need] = self.pool.extend(slot)
        n_active = int(self._active.sum())
        with self._pages_lock:
            # the decode loop's one host fetch per step: S tokens
            sampled = self._run("decode").cpu().numpy()
        t_tok = time.monotonic()
        itl_hist = metrics.histogram(
            "generation.itl_ms",
            help="inter-token latency (consecutive sampled tokens of "
                 "one request)")
        for slot, seq in enumerate(self._slots):
            if seq is None:
                continue
            self._seq_len[slot] += 1
            tok = int(sampled[slot])
            self._last_token[slot] = tok
            # one decode phase per generated token: the trace's decode
            # spans are the request's inter-token latencies
            seq.trace.event("decode")
            if seq.t_last is not None:
                itl_hist.observe((t_tok - seq.t_last) * 1e3)
            seq.t_last = t_tok
            self._emit(slot, tok)
        with self._lock:
            self._stats["decode_steps"] += 1
            self._stats["tokens"] += n_active
        metrics.counter("generation.tokens_generated").inc(n_active)
        metrics.gauge("generation.decode_batch_occupancy").set(
            100.0 * n_active / self._cfg.max_batch)
        metrics.histogram("generation.decode_step_ms").observe(
            (time.monotonic() - t0) * 1e3)

    def _propose(self, spans):
        """The draft phase of one speculative iteration: k candidate
        tokens per slot, (S, k). n-gram mode is host numpy over each
        sequence's own history; draft mode chains k runs of THE draft
        step, its proposals fetched one position at a time."""
        k = self.spec_k
        drafts = np.zeros((self._cfg.max_batch, k), np.int64)
        if not self._spec_draft:
            for slot, seq in enumerate(self._slots):
                if seq is not None:
                    drafts[slot] = ngram_propose(seq.prompt + seq.tokens, k,
                                                 self.spec_ngram)
            return drafts
        toks = self._last_token.copy()
        with self._pages_lock:
            for j in range(k):
                self._draft_seq[:] = self._seq_len + j
                self._draft_active[:] = (self._active != 0) & (j < spans)
                self._draft_token[:] = toks
                drafts[:, j] = self._run("draft").cpu().numpy()
                toks = drafts[:, j]
        return drafts

    def _spec_once(self):
        """One speculative iteration: extend pages to cover the
        worst-case span, propose k drafts per slot, run THE verify step
        once, then commit each slot's accepted + sampled tokens and return
        the pages only rejected positions needed (``PagePool.shrink``; the
        stale device K/V is masked by the committed lengths). A slot's
        tokens are all pushed before the loop reads stop / abort again."""
        from ...observability import metrics

        t0 = time.monotonic()
        _faults.inject("generation.decode_step")
        k = self.spec_k
        S = self._cfg.max_batch
        # per-slot emission budget: min(k+1, remaining max_new) >= 1
        spans = np.zeros(S, np.int64)
        for slot, seq in enumerate(self._slots):
            if seq is None:
                continue
            span = min(k + 1, seq.worst - int(self._seq_len[slot]))
            spans[slot] = span
            need = self.pool.pages_for(int(self._seq_len[slot]) + span)
            owned = self.pool.pages_of(slot)
            while len(owned) < need:  # extend-on-decode, span-deep
                self._page_table[slot, len(owned)] = self.pool.extend(slot)
                owned = self.pool.pages_of(slot)
        t_draft = time.monotonic()
        drafts = self._propose(spans)
        t_verify = time.monotonic()
        self._draft[:] = drafts
        self._span[:] = spans
        n_active = int(self._active.sum())
        with self._pages_lock:
            # one host fetch per step: S x (k+1) tokens and S counts
            res = self._run("verify").cpu().numpy()
        out, accepted = res[:, :-1], res[:, -1]
        t_tok = time.monotonic()
        itl_hist = metrics.histogram(
            "generation.itl_ms",
            help="inter-token latency (consecutive sampled tokens of "
                 "one request)")
        rate_hist = metrics.histogram(
            "generation.spec_accept_rate",
            help="per-step draft acceptance rate (accepted / proposed, "
                 "slots with a nonzero proposal budget)")
        tpv_hist = metrics.histogram(
            "generation.spec_tokens_per_verify",
            help="tokens committed per slot per batched-verify call "
                 "(1 = no draft survived, k+1 = all accepted + bonus)")
        emitted_total = proposed_total = accepted_total = 0
        for slot, seq in enumerate(self._slots):
            if seq is None:
                continue
            m = max(1, int(accepted[slot]))
            toks = [int(t) for t in out[slot, :m]]
            self._seq_len[slot] += m
            self._last_token[slot] = toks[-1]
            proposed = max(0, int(spans[slot]) - 1)
            proposed_total += proposed
            accepted_total += m - 1
            tpv_hist.observe(m)
            if proposed:
                rate_hist.observe((m - 1) / proposed)
            # the m tokens left ONE step together: each is charged an
            # equal share of the step gap
            gap_ms = ((t_tok - seq.t_last) * 1e3 / m
                      if seq.t_last is not None else None)
            for tok in toks:
                if self._slots[slot] is None:
                    break  # EOS / max-tokens evicted the slot mid-burst
                seq.trace.event("decode")
                if gap_ms is not None:
                    itl_hist.observe(gap_ms)
                emitted_total += 1
                self._emit(slot, tok)
            if self._slots[slot] is not None:
                seq.t_last = t_tok
                # rejection rollback: return the tail pages only
                # speculated-over positions needed
                if m < int(spans[slot]) and self.pool.shrink(
                        slot, int(self._seq_len[slot])):
                    n_own = len(self.pool.pages_of(slot))
                    self._page_table[slot, n_own:] = 0
        with self._lock:
            self._stats["decode_steps"] += 1
            self._stats["spec_steps"] += 1
            self._stats["tokens"] += emitted_total
            self._stats["spec_proposed"] += proposed_total
            self._stats["spec_accepted"] += accepted_total
            self._stats["spec_draft_ms"] += (t_verify - t_draft) * 1e3
            self._stats["spec_verify_ms"] += (t_tok - t_verify) * 1e3
        metrics.counter(
            "generation.spec_proposed",
            help="draft tokens proposed to the batched-verify step"
        ).inc(proposed_total)
        metrics.counter(
            "generation.spec_accepted",
            help="draft tokens accepted by the batched-verify step"
        ).inc(accepted_total)
        metrics.counter("generation.tokens_generated").inc(emitted_total)
        metrics.histogram(
            "generation.spec_draft_ms",
            help="draft-proposal phase per speculative step").observe(
            (t_verify - t_draft) * 1e3)
        metrics.histogram(
            "generation.spec_verify_ms",
            help="batched-verify phase per speculative step").observe(
            (t_tok - t_verify) * 1e3)
        metrics.gauge("generation.decode_batch_occupancy").set(
            100.0 * n_active / self._cfg.max_batch)
        metrics.histogram("generation.decode_step_ms").observe(
            (time.monotonic() - t0) * 1e3)

    # --------------------------------------------------------------- stats
    def graph_launches(self):
        """Kernel launches the steps' CUDA-graph replays made, by kernel:
        each step's replays times the launches of one run of its body
        (measured at its capture). Empty on the CPU."""
        out = collections.Counter()
        with self._pages_lock:
            for step in self._steps.values():
                for kernel, n in step.launches.items():
                    out[kernel] += step.replays * n
        return dict(out)

    def get_stats(self):
        """Operational snapshot in the shared engine-stats schema
        (observability/stats_schema.py), the JAX engine's sections and
        flat legacy keys, plus ``captures``: the CUDA graphs captured so
        far (0 on the CPU)."""
        with self._cond:
            queued = len(self._queue)
            class_depths = self._queue.depths()
            n_active = self._n_active
            stopped = self._stop
        with self._lock:
            counters = dict(self._stats)
        with self._pages_lock:
            captures = self._captures
        pool = self.pool.get_stats()
        spec_prop = counters.get("spec_proposed", 0)
        spec_acc = counters.get("spec_accepted", 0)
        speculative = {
            "mode": self.spec_mode,
            "k": self.spec_k,
            "ngram": self.spec_ngram,
            "steps": counters.get("spec_steps", 0),
            "proposed": spec_prop,
            "accepted": spec_acc,
            "accept_rate": (round(spec_acc / spec_prop, 4)
                            if spec_prop else None),
            "draft_ms": round(counters.get("spec_draft_ms", 0.0), 3),
            "verify_ms": round(counters.get("spec_verify_ms", 0.0), 3),
            "draft_bytes_per_token": self.draft_bytes_per_token,
        }
        control = {
            "slo": {"aging_ms": self._aging_ms,
                    "deadline_ms": float(self._cfg.deadline_ms),
                    "queues": class_depths,
                    "expired": counters.get("expired", 0)},
            "prefix_cache": (self.prefix_cache.get_stats()
                             if self.prefix_cache is not None else None),
            "prefill_tokens_skipped": counters.get(
                "prefill_tokens_skipped", 0),
            "pages_shared": pool["pages_shared"],
            "cow_copies": pool["cow_copies"],
        }
        return _schema.engine_stats(
            "generation", counters,
            queue_depth=queued,
            completed=counters.get("completed", 0),
            running=self.running, stopped=stopped,
            capacity={
                "max_batch": self._cfg.max_batch,
                "active_slots": n_active,
                "kv_pages_used": pool["used"],
                "kv_pages_capacity": pool["capacity"],
                "kv_bytes_used": pool["kv_bytes_used"],
                "kv_bytes_capacity": pool["kv_bytes_capacity"],
                "queue_limit_requests": self._cfg.max_queue},
            config={
                "max_seq": self._cfg.max_seq,
                "page_size": self.page_size,
                "decode_blocks": self.decode_blocks,
                "kv_dtype": self.kv_dtype,
                "prefill_buckets": list(self._cfg.prefill_buckets),
                "backpressure": self._cfg.backpressure,
                "prefix_cache": self._use_prefix,
                "slo_aging_ms": self._aging_ms,
                "deadline_ms": float(self._cfg.deadline_ms),
                "spec_k": self.spec_k,
                "spec_mode": self.spec_mode},
            resilience={
                "decode_faults": counters.get("decode_faults", 0),
                "drain_timeouts": counters.get("drain_timeouts", 0)},
            control=control,
            provenance={"amp": bool(self._amp), "kv_dtype": self.kv_dtype},
            extra={
                "queued": queued, "active": n_active,
                "max_batch": self._cfg.max_batch,
                "max_seq": self._cfg.max_seq,
                "page_size": self.page_size,
                "decode_blocks": self.decode_blocks,
                "kv_dtype": self.kv_dtype,
                "prefill_buckets": list(self._cfg.prefill_buckets),
                "pool": pool,
                "speculative": speculative,
                "captures": captures})

    def kv_read_bytes_per_token(self, ctx_len):
        """Device bytes ONE decode step reads from the KV pool for one
        slot at context length ``ctx_len``: the step's traffic model
        (decode is gather-bound)."""
        return int(ctx_len) * self.pool.bytes_per_token


def _detached(params, device):
    """The parameter dict as plain (no-grad) tensors on ``device``."""
    return {k: v.detach().to(device) for k, v in params.items()}


def _bf16_params(params):
    """The amp policy's parameter cast: fp32 tensors to bf16, others as
    they are."""
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in params.items()}

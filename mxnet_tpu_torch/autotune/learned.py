"""Learned cost model: graduate the autotuner's candidate ranking from
the analytic roofline to a measured regressor ("A Learned Performance
Model for TPUs", PAPERS.md).

Counterpart of ``mxnet_tpu/autotune/learned.py``, in numpy as there: the
same features, the same ridge solve, the same holdout split and gate, so
the same sample rows give the same weights in both packages.

The analytic model (cost_model.py) stays what it is good at — hard
feasibility pruning (a tile the kernel does not compile, or one whose
shared memory overflows a block, is ``inf`` forever) and a sane cold
start.  This module learns the part the roofline can't see: the
residual between predicted and measured seconds that the perf registry
(observability/perf.py) exposes per program and every ``MXNET_TUNE=1``
search measures per candidate.  Free training data, accumulated as it is
produced:

* :func:`note_samples` — the search loop appends every measured
  ``(op, candidate, ctx, seconds, analytic seconds)`` to a JSONL
  dataset beside the tuning cache (``<cache>.samples``),
* :func:`ingest_ledger` — perf-ledger program rows
  (``observability.perf.append_ledger``; analytic flops/bytes vs
  measured device ms) convert into ``program``-op samples,
* :func:`ingest_tune_cache` — cache winners carrying a measured ``ms``
  back-fill as samples (idempotent; ``bench_all.py --ingest-ledger``
  runs both bulk paths and reports the gate).

The model is a small feature-hashed ridge regressor, pure numpy: hashed
categorical tokens (op, candidate knobs, log2-bucketed shape context)
plus dense features (log analytic seconds, log candidate magnitudes),
predicting log measured seconds.  Training (:func:`train`) holds out a
deterministic fraction of SEARCH GROUPS (op + shape-context buckets —
whole tuning-cache entries, never individual rows, so the gate measures
ranking on unseen shapes) and computes the mean per-group Spearman rank
correlation of (a) the learned prediction and (b) the analytic cost
against the measured seconds.  The model is used for ranking ONLY when
its held-out Spearman is at least the analytic baseline's — a cold,
thin or mistrained model degrades the search to the analytic order, it
can never rank worse than the roofline by construction
(:func:`ranking_model` returns None unless the persisted gate passed).

Persistence: ``MXNET_COST_MODEL_PATH`` (default ``<cache>.model.json``),
written atomically; a second process warm-loads weights + gate metadata
with zero re-training.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
import zlib

import numpy as np

from . import cache as _cache

__all__ = ["samples_path", "model_path", "note_samples", "append_samples",
           "read_samples", "sample_count", "ingest_ledger",
           "ingest_tune_cache", "featurize",
           "CostModel", "train", "load", "ranking_model", "maybe_train",
           "rank_candidates", "spearman", "reset", "stats"]

#: hashed feature dimensionality (+ the dense block below); small on
#: purpose — the dataset is thousands of rows, not millions, and the
#: ridge solve is a (DIM x DIM) normal-equation at that size
HASH_DIM = 192
_DENSE = 4       # bias, log analytic, analytic-present flag, log |candidate|
_VERSION = 1
_EPS = 1e-12

_lock = threading.Lock()
_model_memo = None   # (path, mtime_ns, CostModel|None)  # guarded-by: _lock
_stats = {"samples_recorded": 0, "trainings": 0, "ranked_searches": 0,
          "degraded_searches": 0}  # guarded-by: _lock


def samples_path():
    """The measured-sample dataset, beside the tuning cache."""
    return _cache.cache_path() + ".samples"


def model_path():
    env = os.environ.get("MXNET_COST_MODEL_PATH")
    return env if env else _cache.cache_path() + ".model.json"


def enabled():
    from ..config import get_flag

    return bool(get_flag("MXNET_COST_MODEL"))


# ------------------------------------------------------------- features

def _bucket(v):
    """log2 bucket of a positive scalar (shape dims, scalar knobs)."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(v) or v <= 0:
        return None
    return int(math.floor(math.log2(v) + 0.5))


def _tokens(op, candidate, ctx):
    toks = ["op:%s" % op]
    for k in sorted(candidate):
        v = candidate[k]
        b = _bucket(v)
        if b is None:
            toks.append("c:%s=%s" % (k, v))
        else:
            toks.append("c:%s~%d" % (k, b))
            toks.append("c:%s" % k)
    for k in sorted(ctx or {}):
        v = ctx[k]
        if isinstance(v, (list, tuple, dict)):
            continue
        b = _bucket(v)
        if b is None:
            toks.append("x:%s=%s" % (k, v))
        else:
            toks.append("x:%s~%d" % (k, b))
    return toks


def featurize(op, candidate, ctx, analytic_s=None):
    """One sample's feature vector: HASH_DIM hashed token counts plus
    the dense block [1, log analytic, analytic-present, log sum-of-
    candidate-magnitudes].  crc32 hashing — stable across processes
    (python ``hash`` is salted)."""
    x = np.zeros(HASH_DIM + _DENSE, np.float64)
    for tok in _tokens(op, candidate, ctx):
        h = zlib.crc32(tok.encode())
        x[h % HASH_DIM] += (1.0 if (h >> 16) & 1 else -1.0)
    x[HASH_DIM] = 1.0
    if analytic_s is not None and math.isfinite(analytic_s) \
            and analytic_s > 0:
        x[HASH_DIM + 1] = math.log(analytic_s + _EPS)
        x[HASH_DIM + 2] = 1.0
    mag = sum(abs(float(v)) for v in candidate.values()
              if isinstance(v, (int, float)))
    x[HASH_DIM + 3] = math.log1p(mag)
    return x


def group_key(op, ctx):
    """The holdout unit: one search site — op + its scalar shape
    context (the same information a tuning-cache shape-bucket key
    carries)."""
    items = []
    for k in sorted(ctx or {}):
        v = (ctx or {})[k]
        if isinstance(v, (list, tuple, dict)):
            continue
        items.append("%s=%s" % (k, v))
    return "%s|%s" % (op, ",".join(items))


# -------------------------------------------------------------- dataset

def append_samples(rows):
    """Append JSONL rows (one line each; O_APPEND whole-line atomicity,
    the ledger discipline)."""
    if not rows:
        return samples_path()
    path = samples_path()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True) + "\n")
    with _lock:
        _stats["samples_recorded"] += len(rows)
    return path


def note_samples(op, ctx, log, cost_fn=None):
    """Record one search's measured log ([(candidate, seconds)]) as
    training samples.  Called by the search loop after every measured
    search; a no-op when MXNET_COST_MODEL=0."""
    if not enabled() or not log:
        return None
    ctx = {k: v for k, v in (ctx or {}).items()
           if isinstance(v, (str, int, float, bool)) or v is None}
    rows = []
    for candidate, seconds in log:
        analytic = None
        if cost_fn is not None:
            try:
                a = float(cost_fn(candidate, ctx))
                analytic = a if math.isfinite(a) else None
            except Exception:
                analytic = None
        rows.append({
            "op": str(op), "candidate": dict(candidate), "ctx": ctx,
            "s": float(seconds), "analytic_s": analytic,
            "fingerprint": _cache.device_fingerprint(),
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S")})
    return append_samples(rows)


def read_samples(path=None, last=200000):
    """Parse the dataset; corrupt lines skipped (interrupted writers
    must not poison training)."""
    path = path or samples_path()
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if isinstance(row, dict) and "op" in row and "s" in row:
                rows.append(row)
    return rows[-last:]


def sample_count():
    """Dataset size by LINE COUNT — the retrain-threshold probe runs
    after every measured search, so it must not JSON-parse the whole
    file (corrupt lines over-count slightly; the threshold only needs
    a delta)."""
    path = samples_path()
    if not os.path.exists(path):
        return 0
    n = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            n += chunk.count(b"\n")
    return n


def ingest_ledger(path):
    """Convert perf-ledger program rows into ``program`` samples:
    analytic flops/bytes + roofline seconds vs the measured device time
    behind each residual.  Returns rows appended.

    Ledger rows name the device kind; a row measured on THIS device is
    stamped with the canonical fingerprint so training includes it —
    foreign-device rows keep their raw device string and are excluded
    by the training-time fingerprint filter (the ledger-verdict
    same-device comparison discipline), so a TPU row of the JAX
    package's BENCH_LEDGER.jsonl never trains a model for the card.

    Idempotent: a (graph, ts, seconds) already in the dataset is
    skipped, so bench-time re-ingestion (``bench_all --ingest-ledger``)
    never duplicates the committed ledger's rows."""
    from ..observability import perf as _perf

    def _ident(row):
        ctx = row.get("ctx") or {}
        return (row.get("op"),
                ctx.get("graph") if isinstance(ctx, dict) else None,
                row.get("ts"), row.get("s"))

    seen = {_ident(r) for r in read_samples()}
    fp = _cache.device_fingerprint()
    rows = []
    for entry in _perf.read_ledger(path):
        device = (entry.get("fingerprint") or {}).get("device")
        row_fp = fp if device and str(device) in fp else device
        for prog in entry.get("programs", ()):
            roof_ms = prog.get("roofline_ms")
            dev_ms = prog.get("device_ms_ema") or prog.get("device_ms_last")
            if not roof_ms or not dev_ms or dev_ms <= 0:
                continue
            rows.append({
                "op": "program",
                "candidate": {"mode": prog.get("mode", "infer")},
                "ctx": {"graph": prog.get("graph"),
                        "flops": prog.get("flops"),
                        "hbm_bytes": prog.get("hbm_bytes")},
                "s": float(dev_ms) * 1e-3,
                "analytic_s": float(roof_ms) * 1e-3,
                "fingerprint": row_fp,
                "ts": entry.get("ts")})
            if _ident(rows[-1]) in seen:
                rows.pop()
            else:
                seen.add(_ident(rows[-1]))
    append_samples(rows)
    return len(rows)


def ingest_tune_cache():
    """Convert accumulated ``MXNET_TUNE=1`` cache winners into samples:
    every cache entry carrying a measured ``ms`` is one (op, winning
    candidate, shape-key context, seconds) row.  Returns rows appended.

    The cache keeps only the WINNER per search site (the per-candidate
    log goes through :func:`note_samples` live), so this is the bulk
    back-fill path for caches tuned before the sample store existed —
    or tuned by a process running with MXNET_COST_MODEL=0.  Idempotent:
    a (fingerprint, op, key, ts) already in the dataset is skipped, so
    bench-time re-ingestion never duplicates rows."""
    def _ident(row):
        ctx = row.get("ctx") or {}
        return (row.get("fingerprint"), row.get("op"),
                ctx.get("key") if isinstance(ctx, dict) else None,
                row.get("ts"))

    seen = {_ident(r) for r in read_samples()}
    rows = []
    for entry in _cache.entries().values():
        ms = entry.get("ms")
        value = entry.get("value")
        if not ms or ms <= 0 or not isinstance(value, dict):
            continue
        row = {
            "op": entry.get("op"),
            "candidate": dict(value),
            "ctx": {"key": entry.get("key"),
                    "dtype": entry.get("dtype")},
            "s": float(ms) * 1e-3,
            "analytic_s": None,
            "fingerprint": entry.get("fingerprint"),
            "ts": entry.get("time")}
        if _ident(row) in seen:
            continue
        seen.add(_ident(row))
        rows.append(row)
    append_samples(rows)
    return len(rows)


# ---------------------------------------------------------------- model

def _ranks(x):
    """Average ranks (ties share their mean rank — the analytic cost
    frequently ties whole candidate plateaus)."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and x[order[j + 1]] == x[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def spearman(a, b):
    """Spearman rank correlation (tie-averaged); 0.0 when either side
    is constant or has fewer than 2 points."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if len(a) < 2 or len(a) != len(b):
        return 0.0
    ra, rb = _ranks(a), _ranks(b)
    sa, sb = ra.std(), rb.std()
    if sa <= 0 or sb <= 0:
        return 0.0
    return float(((ra - ra.mean()) * (rb - rb.mean())).mean() / (sa * sb))


class CostModel:
    """Feature-hashed ridge regressor over measured search samples."""

    def __init__(self, w=None, meta=None):
        self.w = (np.asarray(w, np.float64) if w is not None
                  else np.zeros(HASH_DIM + _DENSE))
        self.meta = dict(meta or {})

    # ------------------------------------------------------------ math
    @classmethod
    def fit(cls, rows, ridge=1e-3):
        X = np.stack([featurize(r["op"], r.get("candidate") or {},
                                r.get("ctx") or {}, r.get("analytic_s"))
                      for r in rows])
        y = np.array([math.log(max(float(r["s"]), _EPS)) for r in rows])
        d = X.shape[1]
        A = X.T @ X + ridge * np.eye(d)
        b = X.T @ y
        w = np.linalg.solve(A, b)
        return cls(w=w)

    def predict_row(self, op, candidate, ctx, analytic_s=None):
        """Predicted log seconds — a RANKING score, not a wall-clock
        promise."""
        return float(featurize(op, candidate, ctx, analytic_s) @ self.w)

    @property
    def gate_ok(self):
        return bool(self.meta.get("gate_ok"))

    # ----------------------------------------------------- persistence
    def save(self, path=None):
        path = path or model_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump({"version": _VERSION, "dim": HASH_DIM,
                       "w": [float(v) for v in self.w],
                       "meta": self.meta}, f)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path=None):
        path = path or model_path()
        with open(path) as f:
            payload = json.load(f)
        if (payload.get("version") != _VERSION
                or payload.get("dim") != HASH_DIM
                or len(payload.get("w", ())) != HASH_DIM + _DENSE):
            raise ValueError("cost model %r: incompatible version/dim"
                             % (path,))
        return cls(w=payload["w"], meta=payload.get("meta"))


def load(path=None):
    """CostModel or None (missing/corrupt files are a cold model, not a
    crash)."""
    try:
        return CostModel.load(path)
    except Exception:
        return None


def _holdout(gkey, frac=0.2):
    return (zlib.crc32(("ho:" + gkey).encode()) % 1000) < int(frac * 1000)


def train(samples=None, ledger=None, min_samples=None, holdout_frac=0.2,
          persist=True):
    """Fit + gate + (by default) persist.  Returns the CostModel with
    ``meta`` describing the holdout verdict, or None when there is not
    enough data to even fit.

    The gate: mean per-held-out-group Spearman of the learned ranking
    vs measured must be >= the analytic cost's on the SAME rows.  A
    failed gate still persists the model (with ``gate_ok: False``) so
    the degradation is observable, but :func:`ranking_model` will not
    serve it."""
    from ..config import get_flag

    if min_samples is None:
        min_samples = get_flag("MXNET_COST_MODEL_MIN_SAMPLES")
    if ledger:
        ingest_ledger(ledger)
    rows = samples if samples is not None else read_samples()
    # device discipline (the tuning-cache/ledger precedent): a model
    # fitted to one chip's timings must never rank another chip's
    # search — rows carry the fingerprint they were measured under;
    # rows without one (older datasets, synthetic tests) stay in
    fp = _cache.device_fingerprint()
    rows = [r for r in rows
            if r.get("fingerprint") in (None, fp)]
    if len(rows) < max(2, min_samples):
        return None
    groups = {}
    for r in rows:
        groups.setdefault(group_key(r["op"], r.get("ctx") or {}),
                          []).append(r)
    held = {k: v for k, v in groups.items() if _holdout(k, holdout_frac)}
    fit_rows = [r for k, v in groups.items() if k not in held for r in v]
    in_sample = False
    if len(fit_rows) < 2:
        # degenerate split (every group hashed into the holdout): fit
        # on everything so the model still trains, but the gate below
        # must NOT pass — an in-sample Spearman proves nothing about
        # ranking on unseen shapes
        fit_rows = rows
        in_sample = True
    model = CostModel.fit(fit_rows)

    sp_learned, sp_analytic, used = [], [], 0
    for k, grp in held.items():
        grp = [r for r in grp
               if r.get("analytic_s") is not None]
        if len(grp) < 3:
            continue
        measured = [r["s"] for r in grp]
        pred = [model.predict_row(r["op"], r.get("candidate") or {},
                                  r.get("ctx") or {}, r.get("analytic_s"))
                for r in grp]
        analytic = [r["analytic_s"] for r in grp]
        sp_learned.append(spearman(pred, measured))
        sp_analytic.append(spearman(analytic, measured))
        used += 1
    mean_l = float(np.mean(sp_learned)) if sp_learned else None
    mean_a = float(np.mean(sp_analytic)) if sp_analytic else None
    gate_ok = (not in_sample and used >= 1 and mean_l is not None
               and mean_l >= mean_a - 1e-9)
    model.meta = {
        "trained_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "n_samples": len(rows), "n_fit": len(fit_rows),
        # raw dataset size AT training time — maybe_train's retrain
        # delta diffs against this, not the fingerprint-FILTERED count
        # (a dataset holding foreign-device ledger rows would otherwise
        # trip the threshold on every search forever)
        "dataset_lines": sample_count() if samples is None else len(rows),
        "n_groups": len(groups), "n_holdout_groups": used,
        "in_sample": in_sample,
        "spearman_learned": mean_l, "spearman_analytic": mean_a,
        "gate_ok": bool(gate_ok),
        "fingerprint": fp,
    }
    if persist:
        model.save()
        with _lock:
            global _model_memo
            _model_memo = None
    with _lock:
        _stats["trainings"] += 1
    return model


def maybe_train(retrain_delta=None):
    """Auto-retrain hook (called by the search loop after its
    measurements): trains when no model exists and the dataset reached
    MXNET_COST_MODEL_MIN_SAMPLES, or when MXNET_COST_MODEL_RETRAIN new
    samples landed since the last training.  Returns the model when a
    training ran, else None."""
    from ..config import get_flag

    if not enabled():
        return None
    if retrain_delta is None:
        retrain_delta = get_flag("MXNET_COST_MODEL_RETRAIN")
    n = sample_count()
    if n < get_flag("MXNET_COST_MODEL_MIN_SAMPLES"):
        return None
    current = load()
    if current is not None:
        trained_on = int(current.meta.get(
            "dataset_lines", current.meta.get("n_samples", 0)))
        if n - trained_on < max(1, retrain_delta):
            return None
    return train()


def ranking_model():
    """The model the search loop consults, or None: requires
    MXNET_COST_MODEL=1, a loadable persisted model, AND a passed
    holdout gate — every other state degrades to the analytic ranking.
    Memoized per (path, mtime): the consult is one stat probe."""
    global _model_memo
    if not enabled():
        return None
    path = model_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return None
    with _lock:
        memo = _model_memo
    if memo is not None and memo[0] == path and memo[1] == mtime:
        model = memo[2]
    else:
        model = load(path)
        with _lock:
            _model_memo = (path, mtime, model)
    if model is None or not model.gate_ok:
        return None
    # a model trained on another chip's timings never ranks this one —
    # degrade to analytic exactly like a cold model (the gate's floor)
    if model.meta.get("fingerprint") not in (None,
                                             _cache.device_fingerprint()):
        return None
    return model


def rank_candidates(op, candidates, ctx, cost_fn=None):
    """Re-rank ``candidates`` by the learned model's predicted seconds,
    or return None (caller keeps the analytic order).  Feasibility is
    not re-litigated — the caller prunes ``inf`` analytically first."""
    model = ranking_model()
    with _lock:
        key = "ranked_searches" if model is not None \
            else "degraded_searches"
        _stats[key] += 1
    if model is None or not candidates:
        return None
    scored = []
    for c in candidates:
        analytic = None
        if cost_fn is not None:
            try:
                a = float(cost_fn(c, ctx or {}))
                analytic = a if math.isfinite(a) else None
            except Exception:
                analytic = None
        scored.append((model.predict_row(op, c, ctx or {}, analytic), c))
    scored.sort(key=lambda sc: sc[0])
    return [c for _s, c in scored]


def stats():
    with _lock:
        return dict(_stats)


def reset():
    """Drop memoized model state (tests)."""
    global _model_memo
    with _lock:
        _model_memo = None
        for k in _stats:
            _stats[k] = 0

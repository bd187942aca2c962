"""Post-training int8 quantization as a graph pass.

Counterpart of ``mxnet_tpu/graph_pass/quantize.py``, in two halves.

* **Calibration.** :func:`calibrate` runs a few batches through a bound
  inference Module with the executor's per-node monitor installed and
  records a per-tensor activation range (absmax, or a percentile of |x|)
  for every node output and the data inputs, into a
  :class:`CalibrationTable` that persists as JSON (a table written by
  either package loads in the other). Entry names are the monitor's
  ``<node>_output`` names, so calibrate under the same pass spec you will
  serve under, minus ``quantize`` itself.
* **Rewrite.** :func:`run_quantize` replaces eligible Convolution /
  FullyConnected / dot / batch_dot nodes with quantize -> integer
  contraction -> dequantize islands: activations quantize per tensor
  against the calibrated range (``round(x / s_x)`` clipped to +-127);
  conv / FC weights quantize per output channel, as graph nodes over the
  frozen weight, so the later ``fold`` pass materializes the int8 weight
  once at bind (the widening cast to int32 carries ``__nofold__``, so
  fold stops at the int8 tensor); the contraction runs on the int8
  lattice widened to int32, exactly (:mod:`..ops.intmath`); one
  ``s_x * s_w`` rescale per output channel and the fp32 bias restore the
  float domain. Everything not rewritten stays an fp32 island.

Per-op opt-out: a ``quantize.layers`` tuning-cache entry
(:func:`~mxnet_tpu_torch.autotune.tuners.tune_quantize_layers`) or
:func:`set_quantize_skip` pins named ops to fp32. Selection:
``MXNET_GRAPH_PASSES=default,quantize`` (``quantize=<table.json>`` loads
the table from a path; otherwise :func:`set_calibration_table` or the
``MXNET_QUANT_TABLE`` path supplies it), or the ``quantize=`` argument of
:class:`~mxnet_tpu_torch.serving.InferenceServer`.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading

import numpy as np
import torch

from ..base import MXNetError
from .core import apply_entry_map, make_node, num_outputs_of, topo_from
from .passes import _NOFOLD

__all__ = ["CalibrationTable", "calibrate", "set_calibration_table",
           "set_quantize_skip", "run_quantize", "as_table", "QUANT_OPS"]

# the ops the rewrite targets: the contractions, the family the amp pass
# allow-lists (conv/FC carry frozen per-channel weights; dot/batch_dot
# quantize per tensor on both activation sides)
QUANT_OPS = frozenset({"Convolution", "FullyConnected", "dot", "batch_dot"})

# the symmetric int8 lattice: +-127 (not -128) so negation is closed and
# per-channel scales stay symmetric — the standard PTQ convention
_QMAX = 127.0
_EPS = 1e-12


# process-wide defaults (graph_pass.set_calibration_table /
# set_quantize_skip keep these in sync with the bind-level cache)
_TABLE_OVERRIDE = None
_SKIP_OVERRIDE = frozenset()


class CalibrationTable:
    """Per-tensor activation ranges recorded over calibration batches.

    ``mode='absmax'`` keeps the running max of ``|x|`` per entry;
    ``mode='percentile'`` keeps the running max over batches of the
    ``percentile``-th percentile of ``|x|`` (clips outliers — the usual
    fix when one activation tail wastes the whole int8 range).
    Thread-safe: the executor monitor may fire from any thread.
    """

    VERSION = 1

    def __init__(self, mode="absmax", percentile=99.99):
        if mode not in ("absmax", "percentile"):
            raise ValueError("mode must be 'absmax' or 'percentile', got %r"
                             % (mode,))
        self.mode = mode
        self.percentile = float(percentile)
        self._lock = threading.Lock()
        self._ranges = {}   # entry name -> absmax float  # guarded-by: self._lock
        self._batches = 0   # observation rounds recorded  # guarded-by: self._lock

    # ------------------------------------------------------------ recording
    def observe(self, name, array):
        """Merge one tensor observation into the entry's range."""
        arr = np.abs(np.asarray(array, dtype=np.float64))
        if arr.size == 0:
            return
        if self.mode == "percentile":
            val = float(np.percentile(arr, self.percentile))
        else:
            val = float(arr.max())
        if not np.isfinite(val):
            return  # a non-finite calibration batch must not poison the range
        with self._lock:
            prev = self._ranges.get(name)
            self._ranges[name] = val if prev is None else max(prev, val)

    def note_batch(self):
        with self._lock:
            self._batches += 1

    # -------------------------------------------------------------- queries
    def get(self, name):
        with self._lock:
            return self._ranges.get(name)

    def ranges(self):
        with self._lock:
            return dict(self._ranges)

    @property
    def batches(self):
        with self._lock:
            return self._batches

    def __len__(self):
        with self._lock:
            return len(self._ranges)

    def fingerprint(self):
        """Stable content hash: the provenance tag the graph-pass reports
        carry, so a numerics regression names the table it ran under."""
        with self._lock:
            items = sorted((k, round(v, 10)) for k, v in self._ranges.items())
            sig = json.dumps([self.mode, self.percentile, items])
        return "ct-%s" % hashlib.sha1(sig.encode()).hexdigest()[:12]

    # -------------------------------------------------------- serialization
    def save(self, path):
        """Atomic JSON dump (temp file, then rename)."""
        with self._lock:
            payload = {"version": self.VERSION, "mode": self.mode,
                       "percentile": self.percentile,
                       "batches": self._batches,
                       "ranges": dict(self._ranges)}
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") != cls.VERSION:
            raise MXNetError("calibration table %r: unsupported version %r"
                             % (path, payload.get("version")))
        table = cls(mode=payload.get("mode", "absmax"),
                    percentile=payload.get("percentile", 99.99))
        table._ranges = {str(k): float(v)
                         for k, v in payload.get("ranges", {}).items()}
        table._batches = int(payload.get("batches", 0))
        return table


# per-path load memo so signature()/run_quantize (both per-bind) don't
# re-read + re-hash the JSON on every call; invalidated by mtime so an
# updated file on disk still takes effect
_load_lock = threading.Lock()
_load_memo = {}  # path -> (mtime_ns, CalibrationTable)  # guarded-by: _load_lock


def _load_cached(path):
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    with _load_lock:
        hit = _load_memo.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
    table = CalibrationTable.load(path)
    with _load_lock:
        _load_memo[path] = (mtime, table)
    return table


def as_table(spec):
    """Coerce a table spec — a CalibrationTable, a JSON path, or None —
    into a CalibrationTable (None stays None: unresolved)."""
    if spec is None or isinstance(spec, CalibrationTable):
        return spec
    if isinstance(spec, str):
        return _load_cached(spec)
    raise TypeError("expected CalibrationTable or path, got %r"
                    % (type(spec).__name__,))


def set_calibration_table(table):
    """Process-wide default calibration table for the ``quantize`` pass
    (a CalibrationTable, a JSON path, or None to clear). Mirrors
    ``graph_pass.set_passes``: the bind-level structure cache is dropped
    so the next bind re-resolves."""
    global _TABLE_OVERRIDE
    _TABLE_OVERRIDE = as_table(table)
    _drop_bind_cache()


def set_quantize_skip(names):
    """Process-wide fp32 pin list: ops named here are never quantized
    (the per-layer-precision tuner's trial lever; None/() clears)."""
    global _SKIP_OVERRIDE
    _SKIP_OVERRIDE = frozenset(names or ())
    _drop_bind_cache()


def _drop_bind_cache():
    from . import _cache, _lock

    with _lock:
        _cache.clear()


def resolve_table(config):
    """The pass's table resolution: explicit PassConfig attachment >
    process-wide set_calibration_table > MXNET_QUANT_TABLE env path.
    A configured table that fails to load raises (MXNetError): int8 was
    asked for, so a corrupt or missing table must never degrade to a
    silent fp32 bind; only a fully absent configuration returns None (the
    spec-level no-op the coverage report names)."""
    try:
        table = as_table(getattr(config, "quant_table", None))
        if table is not None:
            return table
        if _TABLE_OVERRIDE is not None:
            return _TABLE_OVERRIDE
        path = os.environ.get("MXNET_QUANT_TABLE", "").strip()
        if path:
            return _load_cached(path)
    except MXNetError:
        raise
    except Exception as err:
        raise MXNetError(
            "quantize: configured calibration table failed to load "
            "(%r): fix or clear quantize=<path>, MXNET_QUANT_TABLE or "
            "set_calibration_table" % (err,))
    return None


def table_signature(config):
    """Stable cache-key component for the resolved table and skip set
    (PassConfig.signature pulls it in, so a re-bind under another table
    never reuses the wrong rewritten graph). A configured table that does
    not load raises here: the bind fails loudly instead of sharing the
    no-table case's signature."""
    table = resolve_table(config)
    skip = (frozenset(getattr(config, "quant_skip", ()) or ())
            | _SKIP_OVERRIDE)
    return (table.fingerprint() if table is not None else None,
            tuple(sorted(skip)))


# ------------------------------------------------------------- calibration

def calibrate(module, batches, mode="absmax", percentile=99.99,
              table=None, max_batches=None):
    """Record activation ranges by running ``batches`` through a bound
    inference ``module`` with the per-node monitor installed.

    ``batches``: an ``mx.io`` data iterator, or an iterable of numpy
    arrays / lists of arrays (one per data input). Returns the
    :class:`CalibrationTable` (pass ``table=`` to keep accumulating into
    an existing one). Deterministic: same module, same batches, same
    table, byte-identical fingerprint. Every observation is a host fetch
    of one node output (in absmax mode of its max |x|, reduced on the
    device): calibration is a few batches, never the serving path.
    """
    from .. import io as mxio

    table = table if table is not None else CalibrationTable(
        mode=mode, percentile=percentile)
    execs = getattr(getattr(module, "_exec_group", None), "execs", None)
    if not execs:
        raise MXNetError("calibrate() needs a bound Module (bind "
                         "for_training=False, set_params first)")
    data_names = [getattr(d, "name", d) for d in module.data_names] \
        if hasattr(module, "data_names") else ["data"]

    def spy(name, value):
        data = value._data
        if table.mode != "absmax" or not data.numel():
            table.observe(name, value.asnumpy())
            return
        if data.dtype == torch.bool:
            data = data.to(torch.uint8)
        # max |x| reduced where the tensor lives, one scalar fetched (NaN
        # and inf propagate as through the host reduction)
        table.observe(name, data.abs().amax().double().cpu().numpy())

    try:
        for i, batch in enumerate(_iter_batches(batches, mxio)):
            if max_batches is not None and i >= max_batches:
                break
            # (re-)arm per batch: a batch-size change swaps executors
            # mid-stream (Module reshape); reshape inherits the spy, but
            # the first batch of a new size needs it installed up front
            for exe in module._exec_group.execs:
                exe.set_monitor_callback(spy)
            for dname, arr in zip(data_names, batch.data):
                table.observe(dname, arr.asnumpy())
            module.forward(batch, is_train=False)
            table.note_batch()
    finally:
        for exe in module._exec_group.execs:
            exe.set_monitor_callback(None)
    return table


def _iter_batches(batches, mxio):
    from .. import ndarray as nd
    from ..context import cpu

    if hasattr(batches, "provide_data"):  # an mx.io iterator
        batches.reset()
        for batch in batches:
            yield batch
        return
    for item in batches:
        if isinstance(item, mxio.DataBatch):
            yield item
            continue
        arrays = item if isinstance(item, (list, tuple)) else [item]
        # host arrays enter on the host; Module.forward copies them onto
        # the module's device
        yield mxio.DataBatch(data=[a if isinstance(a, nd.NDArray)
                                   else nd.array(a, ctx=cpu())
                                   for a in arrays])


# ----------------------------------------------------------------- rewrite

def _entry_name(entry):
    """The monitor's name for one graph entry: variables by name, node
    outputs as ``<node>_output[i]`` (executor._eval's spy naming)."""
    node, idx = entry
    if node.is_variable:
        return node.name
    if num_outputs_of(node) == 1:
        return node.name + "_output"
    return "%s_output%d" % (node.name, idx)


def _frozen_entry(ctx, entry, memo):
    """True when the entry is a frozen variable or a pure expression over
    frozen variables: the predicate run_fold applies (the exclusion set
    of ``passes._NOFOLD``, the same ``__nofold__`` barrier), so "will
    quantize" cannot drift from "will fold"."""
    node, _idx = entry
    key = id(node)
    hit = memo.get(key)
    if hit is not None:
        return hit
    if node.is_variable:
        ok = node.name in ctx.frozen
    else:
        opdef = node.opdef()
        ok = (opdef.name not in _NOFOLD
              and "__nofold__" not in node.user_attrs
              and not opdef.needs_rng
              and bool(node.inputs)
              and all(_frozen_entry(ctx, e, memo) for e in node.inputs))
    memo[key] = ok
    return ok


def _tuned_skip(ctx):
    """fp32 pin list from the ``quantize.layers`` tuning-cache entry for
    this graph (tune_quantize_layers records it)."""
    from .. import autotune

    tuned = autotune.lookup("quantize.layers", key=ctx.graph_key)
    if isinstance(tuned, dict):
        skip = tuned.get("skip")
        if isinstance(skip, (list, tuple)):
            return frozenset(str(n) for n in skip)
    return frozenset()


def _act_scale(table, entry):
    """Per-tensor activation scale from the calibrated range, or None
    when the entry was never observed."""
    rng = table.get(_entry_name(entry))
    if rng is None:
        return None
    return max(float(rng), _EPS) / _QMAX


def _quantize_act(ctx, pre, tag, entry, scale):
    """quantize(x): round and clip onto the int8 lattice, widened to
    int32 for the exact integer contraction."""
    q = (make_node("_div_scalar", "%s_%s_div" % (pre, tag), [entry],
                   scalar=scale), 0)
    q = (make_node("round", "%s_%s_rnd" % (pre, tag), [q]), 0)
    q = (make_node("clip", "%s_%s_clip" % (pre, tag), [q],
                   a_min=-_QMAX, a_max=_QMAX), 0)
    q = (make_node("Cast", "%s_%s_i8" % (pre, tag), [q], dtype="int8"), 0)
    return (make_node("Cast", "%s_%s_i32" % (pre, tag), [q],
                      dtype="int32"), 0)


def _quantize_weight(ctx, pre, w_entry, w_ch_axis):
    """Per-output-channel weight quantization, emitted as graph nodes
    over the frozen weight so ``fold`` materializes the int8 tensor and
    the fp32 scale vector once at bind. Returns (int32 widened entry,
    keepdims scale entry). The widening cast is a ``__nofold__`` barrier:
    fold stops at the int8 tensor (the quarter-width weight), not at a
    widened constant."""
    absw = (make_node("max", pre + "_absw",
                      [(make_node("abs", pre + "_abs", [w_entry]), 0)],
                      axis=(w_ch_axis,), exclude=True, keepdims=True), 0)
    s_w = (make_node("_maximum_scalar", pre + "_sw",
                     [(make_node("_div_scalar", pre + "_sw0", [absw],
                                 scalar=_QMAX), 0)],
                     scalar=_EPS), 0)
    q = (make_node("broadcast_div", pre + "_wdiv", [w_entry, s_w]), 0)
    q = (make_node("round", pre + "_wrnd", [q]), 0)
    q = (make_node("clip", pre + "_wclip", [q],
                   a_min=-_QMAX, a_max=_QMAX), 0)
    wq8 = make_node("Cast", pre + "_w_i8", [q], dtype="int8")
    widen = make_node("Cast", pre + "_w_i32", [(wq8, 0)], dtype="int32")
    widen.user_attrs["__nofold__"] = "1"
    return (widen, 0), s_w


def run_quantize(ctx):
    """The quantize pass (see the module docstring). Its coverage report
    (ops quantized, skipped and why, the table's fingerprint) goes to
    ``ctx.pass_extras['quantize']``."""
    detail = {"ops_quantized": 0, "ops_eligible": 0,
              "quantized": [], "skipped": {}, "table": None}
    ctx.pass_extras["quantize"] = detail
    # a configured table that does not load raises out of resolve_table
    # (never a silent fp32 bind); None means no table was configured
    table = resolve_table(ctx.config)
    if table is None:
        detail["skipped"]["*"] = "no_calibration_table"
        return 0
    detail["table"] = table.fingerprint()
    skip = (frozenset(getattr(ctx.config, "quant_skip", ()) or ())
            | _SKIP_OVERRIDE | _tuned_skip(ctx))

    frozen_memo = {}
    entry_map = {}
    count = 0
    for node in topo_from(ctx.outputs):
        if node.is_variable:
            continue
        canon = node.opdef().name
        if canon not in QUANT_OPS:
            continue
        detail["ops_eligible"] += 1
        reason = None
        if node.name in skip:
            reason = "tuned_fp32"
        elif canon in ("Convolution", "FullyConnected"):
            reason = _rewrite_dense(ctx, node, canon, table, frozen_memo,
                                    entry_map)
        else:
            reason = _rewrite_matmul(ctx, node, canon, table, frozen_memo,
                                     entry_map)
        if reason is None:
            count += 1
            detail["quantized"].append(node.name)
        else:
            detail["skipped"][node.name] = reason
    detail["ops_quantized"] = count
    if entry_map:
        ctx.outputs = apply_entry_map(ctx.outputs, entry_map)
        ctx.invalidate_shapes()
    return count


def _rewrite_dense(ctx, node, canon, table, frozen_memo, entry_map):
    """Conv/FC island. Returns a skip reason, or None on success."""
    attrs = node.parsed_attrs()
    if not _frozen_entry(ctx, node.inputs[1], frozen_memo):
        return "weight_not_frozen"
    s_x = _act_scale(table, node.inputs[0])
    if s_x is None:
        return "no_calibration"
    out_shape = ctx.shape_of((node, 0))
    if out_shape is None:
        return "no_shape"
    orank = len(out_shape)
    if canon == "Convolution":
        channels_last = bool(attrs.layout) and attrs.layout.endswith("C")
        ch_axis = orank - 1 if channels_last else 1
        # weight layouts: OI<sp> (channels-first) vs <sp>IO
        w_ch_axis = (len(attrs.kernel) + 1) if channels_last else 0
    else:
        ch_axis = orank - 1
        w_ch_axis = 0
    has_bias = not attrs.no_bias

    pre = "_gp_qz%d_%s" % (ctx.uid(), node.name)
    xi = _quantize_act(ctx, pre, "x", node.inputs[0], s_x)
    wi, s_w = _quantize_weight(ctx, pre, node.inputs[1], w_ch_axis)

    merged = dict(attrs._d)
    merged["no_bias"] = True
    qcore = (make_node(canon, pre + "_int", [xi, wi], **merged), 0)
    yf = (make_node("Cast", pre + "_f32", [qcore], dtype="float32"), 0)
    # one per-channel rescale restores the float domain: s_x * s_w[c],
    # reshaped onto the output's channel axis (frozen, so it folds to a
    # small vector constant)
    rshape = tuple(-1 if i == ch_axis else 1 for i in range(orank))
    sv = (make_node("_mul_scalar", pre + "_sxw", [s_w], scalar=s_x), 0)
    sv = (make_node("Reshape", pre + "_svr", [sv], shape=rshape), 0)
    out_name = node.name if not has_bias else pre + "_scaled"
    out = (make_node("broadcast_mul", out_name, [yf, sv]), 0)
    if has_bias:
        b = (make_node("Reshape", pre + "_br", [node.inputs[2]],
                       shape=rshape), 0)
        out = (make_node("broadcast_add", node.name, [out, b]), 0)
    entry_map[(id(node), 0)] = out
    return None


def _rewrite_matmul(ctx, node, canon, table, frozen_memo, entry_map):
    """dot/batch_dot island: per-tensor scales on both activation sides
    (a frozen operand belongs to the conv/FC per-channel path: skip)."""
    if (_frozen_entry(ctx, node.inputs[0], frozen_memo)
            or _frozen_entry(ctx, node.inputs[1], frozen_memo)):
        return "frozen_matmul_input"
    s_a = _act_scale(table, node.inputs[0])
    s_b = _act_scale(table, node.inputs[1])
    if s_a is None or s_b is None:
        return "no_calibration"
    pre = "_gp_qz%d_%s" % (ctx.uid(), node.name)
    ai = _quantize_act(ctx, pre, "a", node.inputs[0], s_a)
    bi = _quantize_act(ctx, pre, "b", node.inputs[1], s_b)
    qcore = (make_node(canon, pre + "_int", [ai, bi],
                       **dict(node.parsed_attrs()._d)), 0)
    yf = (make_node("Cast", pre + "_f32", [qcore], dtype="float32"), 0)
    out = (make_node("_mul_scalar", node.name, [yf], scalar=s_a * s_b), 0)
    entry_map[(id(node), 0)] = out
    return None

"""Roofline attribution: what share of the card's peak does a step reach,
and where does its wall time go?

Counterpart of ``mxnet_tpu/observability/perf.py``, four pieces:

* **Analytic cost accounting per program** — walk the bound graph once
  per (program, shape signature) and compute FLOPs + HBM bytes per node
  (conv / FC / matmul / attention / elemwise rules, the JAX package's
  integer rules unchanged) and per program, on the card's calibration
  table (``autotune.cost_model.CEILINGS``). Memoized on the
  ``_GraphProgram``.
* **Achieved-vs-roofline attribution** — the executor times each program
  run on the card with two CUDA events on its stream, one before its
  first launch and one after its last (:func:`note_program_events`); they
  are read at :func:`step_end`, never by a per-program synchronize. A
  program's MFU divides its FLOPs by that device span and by the ceiling
  of its compute dtype (fp32 on the CUDA cores, bf16 on the tensor
  cores), on both bases: measured (``mfu_pct``) and spec
  (``mfu_spec_pct``). The host-side wall of an eager walk is NOT the
  divisor: the host launches while the card runs, so a fence after the
  walk waits only for its tail. A per-op roofline table and ranked fusion
  candidates ride each program entry.
* **Step-time waterfall** — the fit loop partitions each step's wall into
  data wait, time blocked on the device, kvstore time and host time (the
  residual, BY CONSTRUCTION: ``host = wall - data - device - kv``, so the
  segments sum to the step wall exactly). "Blocked on the device" is the
  host's wait for the step's programs at :func:`step_end`; the card's own
  time is the programs' event spans (``device_span_s``). Step MFU charges
  the whole wall.
* **Perf ledger** — append-only JSONL rows with a regression verdict over
  the CPU-stable quantities (:func:`append_ledger`, :func:`read_ledger`,
  :func:`ledger_verdict`).

On the CPU a program runs synchronously inside its walk, so its device
time is the walk's wall and it is all "blocked" time; it has no MFU (the
ceilings are the card's).

Cost walks run once per (program, shape); steady-state steps do dict
probes only. ``MXNET_PERF=0`` turns the whole layer off.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

from . import metrics

__all__ = ["active", "node_cost", "flash_attention_cost", "program_cost",
           "bound_cost", "CONTRACTIONS", "fusion_candidates",
           "note_program_run", "note_program_events",
           "new_event", "event_pair", "current_stream", "record",
           "query", "synchronize",
           "program_table", "step_begin", "step_end", "step_abandon",
           "step_active", "scope_suspended", "note_data_wait", "note_kv",
           "mark_collective", "waterfalls", "last_waterfall", "summary",
           "summary_brief", "reset", "append_ledger", "read_ledger",
           "ledger_verdict", "TRAIN_FLOPS_MULT", "TRAIN_BYTES_MULT",
           "ELEMWISE_FLOPS", "MOVEMENT_OPS"]

# ----------------------------------------------------------------- flags
_active_cached = None


def active():
    """The MXNET_PERF flag (default 1), cached — config.set_flag keeps
    the cache coherent via its applier."""
    global _active_cached
    if _active_cached is None:
        from ..config import get_flag

        _active_cached = bool(get_flag("MXNET_PERF"))
    return _active_cached


def _apply_perf_flag(value):
    """config.set_flag('MXNET_PERF', ...) applier."""
    global _active_cached
    _active_cached = None if value is None else bool(value)


def _ring_capacity():
    from ..config import get_flag

    return max(8, get_flag("MXNET_PERF_RING"))


_cm = None


def _ceilings():
    # bound once: a per-call import costs ~1 µs on the per-step path
    global _cm
    if _cm is None:
        from ..autotune import cost_model

        _cm = cost_model
    return _cm


# ------------------------------------------------- analytic per-node rules
#: train program (fwd+bwd+grads) multipliers over the forward walk: the
#: backward runs ~2 matmuls per layer (dgrad + wgrad), so FLOPs triple;
#: activations are re-read and gradients written, so traffic is modeled
#: with the same integer multiplier
TRAIN_FLOPS_MULT = 3
TRAIN_BYTES_MULT = 3

#: per-OUTPUT-element FLOP weights for elemwise-shaped compute ops;
#: anything absent (and not in MOVEMENT_OPS) counts 1 FLOP per output
#: element
ELEMWISE_FLOPS = {
    "Activation": 1, "LeakyReLU": 2, "relu": 1, "sigmoid": 4, "tanh": 4,
    "softmax": 5, "log_softmax": 5, "SoftmaxOutput": 5,
    "SoftmaxActivation": 5, "softmax_cross_entropy": 5,
    "BatchNorm": 4, "LayerNorm": 8, "InstanceNorm": 8, "L2Normalization": 4,
    "LRN": 8, "Dropout": 2,
    # Pooling is NOT here: node_cost charges one FLOP per INPUT element
}

#: pure data-movement ops: zero FLOPs, traffic only
MOVEMENT_OPS = frozenset((
    "Reshape", "reshape", "Flatten", "flatten", "Cast", "cast",
    "transpose", "slice", "slice_axis", "SliceChannel", "split",
    "expand_dims", "squeeze", "Concat", "concat", "stack", "tile",
    "repeat", "Pad", "pad", "BlockGrad", "identity", "_copy", "zeros_like",
    "ones_like", "broadcast_axis", "broadcast_to", "Embedding", "take",
    "gather_nd", "_zeros", "_ones", "_full", "Dropout_inference",
))


def _prod(shape):
    out = 1
    for s in shape:
        out *= int(s)
    return out


def node_cost(op, attrs, in_shapes, out_shapes, dtype_bytes=4):
    """(flops, hbm_bytes) of one graph node given its input/output
    shapes.  Rules (all exact integer arithmetic):

    * Convolution  — ``2 * K * out_elems`` with ``K = C_in/groups *
      prod(kernel)`` (+ ``out_elems`` for bias).
    * FullyConnected — ``2 * in_dim * out_elems`` (+ bias).
    * dot / batch_dot — ``2 * contract_dim * out_elems``.
    * elemwise — ``ELEMWISE_FLOPS[op] * out_elems`` (default 1);
      movement ops 0; Pooling counts per input element.
    * ``_FusedRegion`` — base-op FLOPs plus each epilogue step's
      elemwise FLOPs, but EXTERIOR bytes only: a fused region's interior
      tensors stay on chip, so the pre-fusion double-count stops being
      charged.
    * bytes — every input read once + every output written once at
      ``dtype_bytes`` each (pre-fusion accounting: a producer's output
      and its consumer's read both count, which is exactly the traffic
      a fusion would save — see :func:`fusion_candidates`).
    """
    in_shapes = [s for s in in_shapes if s is not None]
    out_shapes = [s for s in out_shapes if s is not None]
    in_elems = sum(_prod(s) for s in in_shapes)
    out_elems = sum(_prod(s) for s in out_shapes)
    nbytes = (in_elems + out_elems) * int(dtype_bytes)

    if op == "_FusedRegion":
        from ..ops.registry import get_op as _get_op

        base_op = attrs.get("base_op", "FullyConnected")
        try:
            base = _get_op(base_op)
            battrs = dict(base.parse_attrs(
                json.loads(attrs.get("base_attrs", "{}")))._d)
            steps = json.loads(attrs.get("epilogue", "[]"))
        except Exception:
            return ELEMWISE_FLOPS.get(op, 1) * out_elems, nbytes
        n_base = int(attrs.get("n_base", 2))
        base_flops, _ = node_cost(base_op, battrs, in_shapes[:n_base],
                                  out_shapes, dtype_bytes=dtype_bytes)
        flops = base_flops
        for step in steps:
            sop = step.get("op")
            if sop in MOVEMENT_OPS:
                continue
            flops += ELEMWISE_FLOPS.get(sop, 1) * out_elems
        # exterior traffic only: base inputs + epilogue extras read
        # once, the final output written once
        return flops, nbytes

    if op in MOVEMENT_OPS:
        return 0, nbytes
    if op == "Convolution" and in_shapes and out_shapes:
        kernel = tuple(attrs.get("kernel", ()))
        groups = int(attrs.get("num_group", 1) or 1)
        layout = attrs.get("layout") or ""
        d = in_shapes[0]
        c_in = d[-1] if layout.endswith("C") else d[1]
        k = (int(c_in) // groups) * _prod(kernel)
        o = _prod(out_shapes[0])
        flops = 2 * k * o
        if not attrs.get("no_bias"):
            flops += o
        return flops, nbytes
    if op == "Deconvolution" and in_shapes:
        kernel = tuple(attrs.get("kernel", ()))
        groups = int(attrs.get("num_group", 1) or 1)
        nf = int(attrs.get("num_filter", 1) or 1)
        k = (nf // groups) * _prod(kernel)
        flops = 2 * k * _prod(in_shapes[0])
        if not attrs.get("no_bias", True):
            flops += out_elems
        return flops, nbytes
    if op == "FullyConnected" and in_shapes and out_shapes:
        d = in_shapes[0]
        flatten = attrs.get("flatten", True)
        in_dim = _prod(d[1:]) if flatten else int(d[-1])
        o = _prod(out_shapes[0])
        flops = 2 * in_dim * o
        if not attrs.get("no_bias"):
            flops += o
        return flops, nbytes
    if op in ("dot", "batch_dot") and in_shapes and out_shapes:
        d = in_shapes[0]
        ta = bool(attrs.get("transpose_a"))
        if op == "dot":
            contract = int(d[0]) if ta else int(d[-1])
        else:
            contract = int(d[-2]) if ta else int(d[-1])
        return 2 * contract * _prod(out_shapes[0]), nbytes
    if op == "Pooling":
        return in_elems, nbytes
    return ELEMWISE_FLOPS.get(op, 1) * out_elems, nbytes


def flash_attention_cost(B, H, T, D, causal=True, dtype_bytes=2,
                         backward=False):
    """(flops, hbm_bytes) of one flash-attention call (the kernels of
    parallel/flash_attention.py).  FLOPs: ``4*B*H*T*T*D`` (qk^T + pv),
    halved under causal masking; the tiled backward recomputes ≈2.5x
    that.  Bytes: q, k, v read + o written once (``4*B*H*T*D``), doubled
    for the backward's second pass over the tiles."""
    flops = 4 * B * H * T * T * D
    if causal:
        flops //= 2
    nbytes = 4 * B * H * T * D * int(dtype_bytes)
    if backward:
        flops = int(flops * 2.5)
        nbytes *= 2
    return flops, nbytes


def program_cost(symbol, topo, var_shapes, dtype_bytes=4, train=False,
                 graph="program"):
    """Walk a bound graph once: per-node FLOPs/bytes rows + program
    totals + roofline seconds at the ceilings of its compute dtype.

    ``var_shapes`` maps every variable (args + aux) to its bound shape;
    internal shapes come from partial shape inference.  ``train=True``
    applies the fwd+bwd multipliers to the program totals (the per-op
    table stays forward-basis, noted in ``basis``).  Returns a JSON-safe
    dict, or None when shape inference fails (the caller then skips
    attribution rather than failing the step)."""
    cm = _ceilings()
    dtype = cm.compute_dtype(dtype_bytes)
    internals = symbol.get_internals()
    entries = internals._outputs
    try:
        _, out_shapes, _ = internals.infer_shape_partial(**var_shapes)
    except Exception:
        return None
    shape_of = {}
    for (node, idx), shp in zip(entries, out_shapes):
        if shp is not None and not node.is_variable:
            shape_of[(id(node), idx)] = tuple(shp)

    def entry_shape(e):
        n, i = e
        if n.is_variable:
            return var_shapes.get(n.name)
        return shape_of.get((id(n), i))

    ridge = cm.ridge_intensity(dtype)
    rows = []
    fused_regions = []
    fused_saved = 0
    total_flops = total_bytes = 0
    for node in topo:
        if node.is_variable:
            continue
        n_main = node.num_main_inputs()
        in_shapes = [entry_shape(e) for e in node.inputs[:n_main]]
        nout = node.opdef().get_num_outputs(node.parsed_attrs())
        node_outs = [shape_of.get((id(node), i)) for i in range(nout)]
        attrs = dict(node.parsed_attrs()._d)
        flops, nbytes = node_cost(node.op, attrs, in_shapes, node_outs,
                                  dtype_bytes=dtype_bytes)
        total_flops += flops
        total_bytes += nbytes
        out_elems = sum(_prod(s) for s in node_outs if s is not None)
        row = {
            "name": node.name, "op": node.op,
            "flops": flops, "bytes": nbytes,
            "out_bytes": out_elems * int(dtype_bytes),
            "intensity": (flops / nbytes) if nbytes else 0.0,
            "bound": ("compute" if nbytes and flops / nbytes >= ridge
                      else "bandwidth"),
            "roofline_s": cm.roofline_seconds(flops, nbytes, dtype),
        }
        if node.op == "_FusedRegion":
            # every epilogue step's input was a producer-write +
            # consumer-read pair pre-fusion — exactly 2 * out_bytes per
            # step; the saving the fused program no longer pays
            try:
                n_steps = len(json.loads(attrs.get("epilogue", "[]")))
                members = json.loads(
                    node.user_attrs.get("__fused_members__", "[]"))
            except Exception:
                n_steps, members = 0, []
            saved = 2 * n_steps * row["out_bytes"]
            row["fused"] = True
            row["members"] = members
            row["interior_saved_bytes"] = saved
            fused_saved += saved
            fused_regions.append({"name": node.name, "members": members,
                                  "saved_bytes": saved})
        rows.append(row)
    if train:
        total_flops *= TRAIN_FLOPS_MULT
        total_bytes *= TRAIN_BYTES_MULT
    return {
        "graph": graph,
        "mode": "train" if train else "infer",
        "basis": ("forward walk x%d flops / x%d bytes (fwd+bwd)"
                  % (TRAIN_FLOPS_MULT, TRAIN_BYTES_MULT)) if train
                 else "forward walk",
        "dtype_bytes": int(dtype_bytes),
        "compute_dtype": dtype,
        "flops": total_flops,
        "hbm_bytes": total_bytes,
        "roofline_s": cm.roofline_seconds(total_flops, total_bytes, dtype),
        "ridge_intensity": ridge,
        "ops": rows,
        "fusion_candidates": fusion_candidates(rows),
        "fused_regions": fused_regions,
        "fused_saved_bytes": fused_saved,
    }


#: ops whose backward is one product per operand (data, weight) that
#: takes a gradient: the data gradient and the weight gradient
CONTRACTIONS = frozenset(("Convolution", "Deconvolution", "FullyConnected",
                          "dot", "batch_dot"))


def _base_op(node):
    if node.op == "_FusedRegion":
        return node.parsed_attrs()._d.get("base_op", "FullyConnected")
    return node.op


def bound_cost(cost, symbol, topo, grad_names, arg_dtypes):
    """``cost`` (:func:`program_cost` of ``topo``) as a bound executor
    runs it, the per-op rows unchanged:

    * under ``train``, the backward is charged only where autograd runs
      it: a node no gradient flows through (every input off the path from
      an argument in ``grad_names``) pays its forward alone, and a
      contraction pays one backward product per operand on the path, so
      a bind whose data takes no gradient is not charged a data gradient
      it never computes (a fused region's epilogue rides its
      contraction's multiplier); with every argument on the path the
      totals are the 3x rule's;
    * the compute dtype is the contractions' operand dtype after the graph
      passes (weighted by their FLOPs; an amp program's bf16 products run
      on the tensor cores whatever its fp32 arguments), the byte rule's
      dtype where the program has no contraction.

    ``arg_dtypes`` maps the program's variables to their bound dtypes."""
    if cost is None:
        return None
    from ..base import dtype_name

    internals = symbol.get_internals()
    try:
        _, out_types, _ = internals.infer_type(**arg_dtypes)
    except Exception:
        out_types = [None] * len(internals._outputs)
    dtype_of = {(id(n), i): t for (n, i), t in zip(internals._outputs,
                                                   out_types)}
    nodes = [n for n in topo if not n.is_variable]
    on_path = set()  # (id(node), idx) of entries a gradient flows through
    grad_names = set(grad_names)

    def needs(e):
        n, i = e
        return n.name in grad_names if n.is_variable \
            else (id(n), i) in on_path

    def operand_dtype(e):
        n, i = e
        t = arg_dtypes.get(n.name) if n.is_variable \
            else dtype_of.get((id(n), i))
        return None if t is None else dtype_name(t)

    flops = nbytes = 0
    by_dtype = {}
    for node, row in zip(nodes, cost["ops"]):
        main = node.inputs[:node.num_main_inputs()]
        grads = [needs(e) for e in main]
        if any(grads):
            nout = node.opdef().get_num_outputs(node.parsed_attrs())
            on_path.update((id(node), i) for i in range(nout))
        contraction = _base_op(node) in CONTRACTIONS
        if not any(grads):
            mult = 1
        elif contraction:
            mult = 1 + sum(grads[:2])
        else:
            mult = TRAIN_FLOPS_MULT
        flops += mult * row["flops"]
        nbytes += mult * row["bytes"]
        if contraction and main:
            t = operand_dtype(main[0])
            by_dtype[t] = by_dtype.get(t, 0) + row["flops"]
    out = dict(cost)
    if cost["mode"] == "train":
        out["flops"], out["hbm_bytes"] = flops, nbytes
        out["basis"] = ("forward walk, the backward charged where a "
                        "gradient flows (x%d a node, one product per "
                        "operand on the path a contraction)"
                        % TRAIN_FLOPS_MULT)
    cm = _ceilings()
    known = {t: f for t, f in by_dtype.items() if t in cm.MEASURED_MATMUL_TF}
    if known:
        out["compute_dtype"] = max(known, key=known.get)
    out["roofline_s"] = cm.roofline_seconds(out["flops"], out["hbm_bytes"],
                                            out["compute_dtype"])
    out["ridge_intensity"] = cm.ridge_intensity(out["compute_dtype"])
    return out


def fusion_candidates(rows, k=8):
    """Rank fusion-region candidates: maximal runs of >=2 consecutive
    bandwidth-bound ops in topo order.  The saving of fusing a run is
    the intermediate traffic it eliminates — each interior op's output
    is written to and re-read from HBM today (``2 * out_bytes``).
    Ranked by saved bytes descending.  ``_FusedRegion`` rows never join
    a run: the fuse pass already consumed them, so the list shows only
    the REMAINING headroom."""
    out = []
    run = []
    for row in rows + [None]:
        if row is not None and row["bound"] == "bandwidth" \
                and not row.get("fused") \
                and (row["flops"] or row["bytes"]):
            run.append(row)
            continue
        if len(run) >= 2:
            saved = 2 * sum(r["out_bytes"] for r in run[:-1])
            out.append({
                "ops": [r["name"] for r in run],
                "op_types": [r["op"] for r in run],
                "bytes": sum(r["bytes"] for r in run),
                "flops": sum(r["flops"] for r in run),
                "saved_bytes": saved,
            })
        run = []
    out.sort(key=lambda c: -c["saved_bytes"])
    return out[:k]


# ------------------------------------------- measured program attribution
_lock = threading.Lock()
_programs = {}     # key -> entry dict  # guarded-by: _lock
_provider_armed = False  # guarded-by: _lock


def _arm_provider():
    """Register the flight-recorder 'perf' provider on first activity
    (a dump from a process that never measured anything stays clean)."""
    global _provider_armed
    if _provider_armed:
        return
    with _lock:
        if _provider_armed:
            return
        _provider_armed = True
    from . import flight_recorder

    flight_recorder.register_provider("perf", summary)


_rate_cache = {}


def _rates(dtype):
    """(measured FLOP/s, measured bytes/s, spec FLOP/s, spec bytes/s) of
    a compute dtype, resolved once."""
    r = _rate_cache.get(dtype)
    if r is None:
        cm = _ceilings()
        r = _rate_cache[dtype] = (
            cm.MEASURED_MATMUL_TF[dtype] * 1e12, cm.MEASURED_HBM_GBPS * 1e9,
            cm.SPEC_MATMUL_TF[dtype] * 1e12, cm.SPEC_HBM_GBPS * 1e9)
    return r


def _utilization(flops, nbytes, seconds, dtype):
    """(mfu %, hbm util %, spec mfu %, spec hbm util %) of ``flops`` and
    ``nbytes`` over ``seconds`` at the ceilings of ``dtype``."""
    f, b, fs, bs = _rates(dtype)
    per_s = 100.0 / seconds
    return (flops * per_s / f, nbytes * per_s / b, flops * per_s / fs,
            nbytes * per_s / bs)


def note_program_run(cost, device_s, host_s, replicas=1, blocked_s=None,
                     card=True):
    """Fold one measured program run into the attribution registry and
    the active step scope: ``device_s`` is the card's time for it (the
    MFU divisor), ``host_s`` the host's launch time, ``blocked_s`` the
    host's wait for it (the waterfall's device segment; ``device_s``
    when not given, as on the CPU where the walk is the program). The
    FIRST run per program entry is warmup (its launches build kernels,
    cuDNN plans, the allocator's pool) and excluded from the measured
    stats and the published gauges. ``replicas`` annotates a group-level
    note; the cost stays per-replica so MFU stays relative to one
    card. A run on the CPU (``card=False``) has no MFU: the ceilings are
    the card's."""
    if cost is None:
        return
    if not _provider_armed:
        _arm_provider()
    key = (cost["graph"], cost["mode"])
    warmup = False
    with _lock:
        entry = _programs.get(key)
        if entry is None:
            # per-op roofline table rides the entry (top rows by
            # analytic roofline seconds) so a flight-recorder dump or
            # /statusz carries the ranking without a re-walk
            ops = sorted(cost["ops"], key=lambda r: -r["roofline_s"])[:64]
            entry = _programs[key] = {
                "graph": cost["graph"], "mode": cost["mode"],
                "compute_dtype": cost.get("compute_dtype"),
                "flops": cost["flops"], "hbm_bytes": cost["hbm_bytes"],
                "roofline_ms": cost["roofline_s"] * 1e3,
                "ridge_intensity": cost["ridge_intensity"],
                "basis": cost["basis"],
                "ops_top": [dict(r) for r in ops],
                "fusion_candidates": [dict(c)
                                      for c in cost["fusion_candidates"]],
                "fused_regions": [dict(r)
                                  for r in cost.get("fused_regions", ())],
                "fused_saved_bytes": cost.get("fused_saved_bytes", 0),
                "runs": 0, "warmup_runs": 0, "replicas": int(replicas),
                "card": bool(card),
                "device_ms_last": None, "device_ms_best": None,
                "device_ms_ema": None, "host_ms_ema": None,
                "mfu_pct": None, "hbm_util_pct": None,
                "mfu_spec_pct": None, "hbm_util_spec_pct": None,
                "residual": None,
            }
        if entry["runs"] == 0 and entry["warmup_runs"] == 0:
            entry["warmup_runs"] = 1
            warmup = True
        else:
            entry["runs"] += 1
            d_ms, h_ms = device_s * 1e3, host_s * 1e3
            entry["device_ms_last"] = d_ms
            if entry["device_ms_best"] is None:
                entry["device_ms_best"] = entry["device_ms_ema"] = d_ms
                entry["host_ms_ema"] = h_ms
            else:
                entry["device_ms_best"] = min(entry["device_ms_best"], d_ms)
                entry["device_ms_ema"] = (0.8 * entry["device_ms_ema"]
                                          + 0.2 * d_ms)
                entry["host_ms_ema"] = 0.8 * entry["host_ms_ema"] + 0.2 * h_ms
    if not warmup and card and device_s > 0 and metrics.enabled():
        mfu, hbm, _ms, _hs = _utilization(
            cost["flops"], cost["hbm_bytes"], device_s,
            cost.get("compute_dtype") or "float32")
        metrics.gauge("perf.mfu_pct", labels={"scope": "program"},
                      help="achieved FLOP/s as % of the measured matmul "
                           "ceiling of the program's compute dtype "
                           "(autotune.cost_model.CEILINGS)").set(mfu)
        metrics.gauge("perf.hbm_util_pct", labels={"scope": "program"},
                      help="achieved HBM traffic as % of the measured "
                           "bandwidth ceiling").set(hbm)
    scope = getattr(_tls, "step", None)
    if scope is not None:
        scope["device_s"] += device_s if blocked_s is None else blocked_s
        scope["device_span_s"] += device_s
        scope["flops"] += cost["flops"]
        scope["hbm_bytes"] += cost["hbm_bytes"]
        scope["programs"] += 1
        scope["card"] = scope["card"] or card
        if scope.get("compute_dtype") is None:
            scope["compute_dtype"] = cost.get("compute_dtype")


_event_pool = []  # idle (start, end) event pairs  # guarded-by: _lock
_cu = None        # (libcuda holding the GIL, libcuda releasing it)


def _driver():
    """libcuda through ctypes, loaded at the first timed run. The record
    and the elapsed-time read go through a ``PyDLL`` handle, which keeps
    the GIL: ``torch.cuda.Event``'s release and retake the GIL and build
    a Stream object, 5-8 us a call on the card's host against about 1 us
    here (``tools/port_obs_cost.py``). The wait goes through a ``CDLL``
    handle, which releases the GIL while it blocks."""
    global _cu
    if _cu is None:
        import ctypes

        P = ctypes.c_void_p
        fast, slow = ctypes.PyDLL("libcuda.so.1"), ctypes.CDLL("libcuda.so.1")
        for lib in (fast, slow):
            lib.cuEventCreate.argtypes = [ctypes.POINTER(P), ctypes.c_uint]
            lib.cuEventRecord.argtypes = [P, P]
            lib.cuEventElapsedTime.argtypes = [
                ctypes.POINTER(ctypes.c_float), P, P]
            lib.cuEventSynchronize.argtypes = [P]
            lib.cuEventQuery.argtypes = [P]
        _cu = (fast, slow, ctypes)
    return _cu


def _check(res, what):
    if res != 0:
        from ..base import MXNetError

        raise MXNetError("%s failed: CUDA driver error %d" % (what, res))


def new_event():
    """A timing event: a raw ``CUevent`` handle of the current context."""
    fast, _slow, ctypes = _driver()
    ev = ctypes.c_void_p()
    _check(fast.cuEventCreate(ctypes.byref(ev), 0), "cuEventCreate")
    return ev.value


def event_pair():
    """A (start, end) pair of timing events for one program run, from a
    pool: the step's end returns it once read."""
    with _lock:
        if _event_pool:
            return _event_pool.pop()
    return new_event(), new_event()


def current_stream(device_index):
    """The raw handle of a card's current CUDA stream."""
    import torch

    raw_of = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw_of is None:
        return torch.cuda.current_stream(device_index).cuda_stream
    return raw_of(device_index)


def record(event, stream):
    """Record a timing event on a raw stream handle."""
    res = (_cu or _driver())[0].cuEventRecord(event, stream)
    if res:
        _check(res, "cuEventRecord")


def query(event):
    """Has ``event`` happened?"""
    res = _driver()[0].cuEventQuery(event)
    if res == 600:  # CUDA_ERROR_NOT_READY
        return False
    _check(res, "cuEventQuery")
    return True


def synchronize(event):
    """Wait (the GIL released) until ``event`` has happened."""
    _check(_driver()[1].cuEventSynchronize(event), "cuEventSynchronize")


def _span_ms(start, end):
    """(milliseconds between two recorded events, seconds the host waited
    for the end one). The wait comes first, returning at once when the
    event has happened: the span is then read by one call."""
    fast, slow, ctypes = _cu or _driver()
    t0 = time.perf_counter()
    _check(slow.cuEventSynchronize(end), "cuEventSynchronize")
    blocked = time.perf_counter() - t0
    ms = ctypes.c_float()
    _check(fast.cuEventElapsedTime(ctypes.byref(ms), start, end),
           "cuEventElapsedTime")
    return ms.value, blocked


def note_program_events(cost, start, end, host_s):
    """One program run on the card, timed by two events of
    :func:`event_pair` recorded on its stream (``start`` before its first
    launch, ``end`` after its last).
    Inside a step scope the events wait for :func:`step_end`, which reads
    them; outside one the run is not measured (no synchronize here)."""
    if cost is None:
        return
    scope = getattr(_tls, "step", None)
    if scope is not None:
        scope["pending"].append((cost, start, end, host_s))


def program_table():
    """Snapshot of the per-program attribution entries (JSON-safe): MFU
    and HBM utilisation of the last measured run on both bases, and the
    residual (device ms EMA over the roofline ms; >1 = slower than the
    roofline), worked out here rather than on the per-step path."""
    with _lock:
        rows = [dict(v) for v in _programs.values()]
    for row in rows:
        last = row["device_ms_last"]
        if row["card"] and last:
            (row["mfu_pct"], row["hbm_util_pct"], row["mfu_spec_pct"],
             row["hbm_util_spec_pct"]) = _utilization(
                row["flops"], row["hbm_bytes"], last / 1e3,
                row["compute_dtype"] or "float32")
        if row["device_ms_ema"] is not None and row["roofline_ms"] > 0:
            row["residual"] = row["device_ms_ema"] / row["roofline_ms"]
    return rows


# ------------------------------------------------------ step waterfall
_tls = threading.local()
_waterfalls = None  # deque of step records  # guarded-by: _lock


def step_active():
    """True while this thread is inside a fit-step waterfall scope (the
    executor's measurement gate)."""
    return getattr(_tls, "step", None) is not None


def step_begin():
    """Open a step scope on this thread (fit loop).  No-op under
    MXNET_PERF=0."""
    if not active():
        return
    _tls.step = {"t0": time.perf_counter(), "data_wait_s": 0.0,
                 "device_s": 0.0, "device_span_s": 0.0, "kvstore_s": 0.0,
                 "flops": 0, "hbm_bytes": 0, "programs": 0,
                 "compute_dtype": None, "card": False, "pending": []}


def step_abandon():
    """Discard the open scope without recording (epoch end, an
    exception)."""
    _tls.step = None


class _ScopeSuspended:
    """Context manager: temporarily hide the step scope from this
    thread (a group that measures its replicas once)."""

    __slots__ = ("_saved",)

    def __enter__(self):
        self._saved = getattr(_tls, "step", None)
        _tls.step = None
        return self

    def __exit__(self, *exc):
        _tls.step = self._saved
        return False


def scope_suspended():
    return _ScopeSuspended()


def note_data_wait(seconds):
    """Input-pipeline wait attributed to the current step (called by the
    fit loop's lookahead iterator around ``next()``)."""
    scope = getattr(_tls, "step", None)
    if scope is not None:
        scope["data_wait_s"] += seconds


def note_kv(seconds):
    """kvstore/collective time attributed to the current step."""
    scope = getattr(_tls, "step", None)
    if scope is not None:
        scope["kvstore_s"] += seconds


def mark_collective():
    """Tag the current step's kvstore segment as in-device collectives:
    waterfall rows carry ``collective: true``."""
    scope = getattr(_tls, "step", None)
    if scope is not None:
        scope["collective"] = True


def _resolve_pending(pending):
    """Read the step's program events: wait for each end event (the
    host's time blocked on the device) and fold the event span into the
    program table."""
    for cost, start, end, host_s in pending:
        span_ms, blocked = _span_ms(start, end)
        note_program_run(cost, span_ms / 1e3, host_s, blocked_s=blocked)
        with _lock:
            if len(_event_pool) < 64:
                _event_pool.append((start, end))


def step_end(step=None):
    """Close the scope and record one waterfall row.  The partition is
    exact BY CONSTRUCTION: ``host_s = wall_s - (data_wait_s + device_s +
    kvstore_s)``, so the four segments always sum to the measured step
    wall.  Returns the record (None when no scope was open)."""
    global _waterfalls
    scope = getattr(_tls, "step", None)
    if scope is None:
        return None
    if scope["pending"]:
        _resolve_pending(scope["pending"])
    _tls.step = None
    wall = time.perf_counter() - scope["t0"]
    data, device, kv = (scope["data_wait_s"], scope["device_s"],
                        scope["kvstore_s"])
    host = wall - (data + device + kv)
    # the step's MFU needs a program that ran on the card
    mfu = hbm = mfu_spec = hbm_spec = None
    if wall > 0 and scope["card"]:
        mfu, hbm, mfu_spec, hbm_spec = _utilization(
            scope["flops"], scope["hbm_bytes"], wall,
            scope["compute_dtype"] or "float32")
    rec = {
        "step": step,
        "rank": None,
        "wall_s": wall,
        "data_wait_s": data,
        "device_s": device,
        "kvstore_s": kv,
        "host_s": host,
        "device_span_s": scope["device_span_s"],
        "flops": scope["flops"],
        "hbm_bytes": scope["hbm_bytes"],
        "programs": scope["programs"],
        # step MFU charges the WHOLE step wall (the honest training
        # number: data stalls and host launch time count against you)
        "mfu_pct": mfu,
        "hbm_util_pct": hbm,
        "mfu_spec_pct": mfu_spec,
        "hbm_util_spec_pct": hbm_spec,
    }
    if scope.get("collective"):
        rec["collective"] = True
    _arm_provider()
    with _lock:
        if _waterfalls is None:
            _waterfalls = collections.deque(maxlen=_ring_capacity())
        _waterfalls.append(rec)
    if metrics.enabled() and rec["mfu_pct"] is not None:
        metrics.gauge("perf.mfu_pct", labels={"scope": "step"},
                      help="achieved FLOP/s as % of the measured matmul "
                           "ceiling of the program's compute dtype "
                           "(autotune.cost_model.CEILINGS)"
                      ).set(rec["mfu_pct"])
        metrics.gauge("perf.hbm_util_pct", labels={"scope": "step"},
                      help="achieved HBM traffic as % of the measured "
                           "bandwidth ceiling").set(rec["hbm_util_pct"])
    return rec


def waterfalls(n=None):
    """Chronological copy of the per-step waterfall ring (last ``n``)."""
    with _lock:
        rows = list(_waterfalls) if _waterfalls is not None else []
    return rows if n is None else rows[-n:]


def last_waterfall():
    with _lock:
        return (dict(_waterfalls[-1])
                if _waterfalls else None)


# ----------------------------------------------------------- summaries
def _waterfall_brief(rec):
    if rec is None:
        return None
    brief = {k: rec[k] for k in ("step", "wall_s", "data_wait_s",
                                 "device_s", "kvstore_s", "host_s",
                                 "mfu_pct", "hbm_util_pct")}
    if rec.get("rank") is not None:
        brief["rank"] = rec["rank"]
    return brief


def summary():
    """The full perf section (flight-recorder provider, /statusz): program
    table + recent waterfalls + ceilings. None when nothing was ever
    measured."""
    programs = program_table()
    falls = waterfalls(16)
    if not programs and not falls:
        return None
    cm = _ceilings()
    return {
        "enabled": active(),
        "ceilings": json.loads(json.dumps(cm.CEILINGS)),
        "programs": programs,
        "waterfalls": falls,
        "waterfall": _waterfall_brief(falls[-1] if falls else None),
    }


def summary_brief():
    """The compact perf section engine ``get_stats()`` snapshots carry
    (stats_schema): current step MFU/HBM utilization + the last
    waterfall + how many programs have attribution."""
    last = last_waterfall()
    progs = program_table()
    mfu = last["mfu_pct"] if last else None
    hbm = last["hbm_util_pct"] if last else None
    if mfu is None and progs:
        measured = [p for p in progs if p["mfu_pct"] is not None]
        if measured:
            mfu = measured[-1]["mfu_pct"]
            hbm = measured[-1]["hbm_util_pct"]
    return {
        "enabled": active(),
        "mfu_pct": mfu,
        "hbm_util_pct": hbm,
        "programs": len(progs),
        "waterfall": _waterfall_brief(last),
    }


def reset():
    """Drop all measured state (tests, bench isolation)."""
    global _waterfalls
    with _lock:
        _programs.clear()
        _waterfalls = None
    _tls.step = None


# ------------------------------------------------------------- ledger
def append_ledger(row, path):
    """Append one JSON row to the append-only perf ledger (one line per
    bench run).  A single ``write`` of one line on an O_APPEND handle is
    atomic at these sizes; concurrent writers interleave whole lines."""
    line = json.dumps(row, sort_keys=True)
    with open(path, "a") as f:
        f.write(line + "\n")
    return path


def read_ledger(path, last=None):
    """Parse the ledger; corrupt lines are skipped (an interrupted
    writer must not poison the whole trajectory)."""
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError:
                continue
    return rows if last is None else rows[-last:]


def _comparable(a, b):
    """Two ledger rows are gate-comparable when their stable context
    matches: same quick flag and same device kind."""
    fa, fb = a.get("fingerprint", {}), b.get("fingerprint", {})
    return (a.get("quick") == b.get("quick")
            and fa.get("device") == fb.get("device"))


def ledger_verdict(rows, throughput_drop_pct=20.0):
    """Regression verdict over the last two comparable ledger rows.

    Hard regressions (CPU-stable):

    * a bench that produced a value before now records an error;
    * a program's ANALYTIC flops or hbm_bytes changed for the same
      (graph, mode) — the cost model itself drifted;
    * a previously-present MFU field disappeared.

    Throughput drops beyond ``throughput_drop_pct`` are WARNINGS.
    """
    out = {"verdict": "ok", "regressions": [], "warnings": [],
           "compared": None}
    if len(rows) < 2:
        out["note"] = "fewer than 2 ledger rows — nothing to compare"
        return out
    cur = rows[-1]
    prev = None
    for row in reversed(rows[:-1]):
        if _comparable(row, cur):
            prev = row
            break
    if prev is None:
        out["note"] = "no comparable prior row (device/quick differ)"
        return out
    out["compared"] = [prev.get("ts"), cur.get("ts")]
    pb, cb = prev.get("benches", {}), cur.get("benches", {})
    for name in sorted(set(pb) & set(cb)):
        was, now = pb[name], cb[name]
        if "value" in was and "error" in now:
            out["regressions"].append(
                "bench %s newly failing: %s" % (name, now["error"]))
            continue
        if "value" not in was or "value" not in now:
            continue
        if was.get("mfu_pct") is not None and now.get("mfu_pct") is None:
            out["regressions"].append(
                "bench %s lost its MFU field" % name)
        try:
            ratio = float(now["value"]) / float(was["value"])
        except (TypeError, ValueError, ZeroDivisionError):
            continue
        if ratio < 1.0 - throughput_drop_pct / 100.0:
            out["warnings"].append(
                "bench %s throughput %.3g -> %.3g (%.1f%% drop)"
                % (name, was["value"], now["value"], 100 * (1 - ratio)))
    pp = {(p["graph"], p["mode"]): p for p in prev.get("programs", [])}
    for p in cur.get("programs", []):
        old = pp.get((p["graph"], p["mode"]))
        if old is None:
            continue
        for field in ("flops", "hbm_bytes"):
            if old.get(field) != p.get(field):
                out["regressions"].append(
                    "program %s/%s analytic %s drift: %s -> %s"
                    % (p["graph"], p["mode"], field, old.get(field),
                       p.get(field)))
    if out["regressions"]:
        out["verdict"] = "regression"
    return out

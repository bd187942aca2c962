"""The graph passes: prune, bn_fold, layout, amp, fold.

Counterpart of ``mxnet_tpu/graph_pass/passes.py``. Each pass is
``run_<name>(ctx) -> rewrite_count`` over a :class:`~.core.PassContext`
holding a private clone of the graph.
"""
from __future__ import annotations

import torch

from ..ops.elemwise import eager_division
from ..symbol.symbol import _Node
from .core import (apply_entry_map, consumers_of, make_node, num_outputs_of,
                   set_attrs, topo_from)

# ---------------------------------------------------------------- prune ----

# loss heads whose inference forward is the identity on their data input
_IDENTITY_HEADS = frozenset({"LinearRegressionOutput", "MAERegressionOutput",
                             "MakeLoss", "BlockGrad"})


def run_prune(ctx):
    """Inference simplification + dead-node elimination: SoftmaxOutput
    becomes a plain ``softmax`` (same axis rule), logistic regression
    ``sigmoid``, identity heads a pass-through, training-mode Dropout
    disappears; label variables and their plumbing then fall away."""
    rewrites = 0
    entry_map = {}
    for node in topo_from(ctx.outputs):
        if node.is_variable:
            continue
        canon = node.opdef().name
        if canon == "SoftmaxOutput":
            shape = ctx.shape_of(node.inputs[0])
            if shape is None:
                continue
            attrs = node.parsed_attrs()
            axis = (len(shape) - 1) if attrs.preserve_shape else \
                (1 if len(shape) > 1 else 0)
            # keep the node NAME so list_outputs() naming is stable
            new = make_node("softmax", node.name, [node.inputs[0]],
                            axis=axis)
            entry_map[(id(node), 0)] = (new, 0)
            rewrites += 1
        elif canon == "LogisticRegressionOutput":
            new = make_node("sigmoid", node.name, [node.inputs[0]])
            entry_map[(id(node), 0)] = (new, 0)
            rewrites += 1
        elif canon in _IDENTITY_HEADS:
            entry_map[(id(node), 0)] = node.inputs[0]
            rewrites += 1
        elif canon == "Dropout" and node.parsed_attrs().mode == "training":
            entry_map[(id(node), 0)] = node.inputs[0]
            rewrites += 1
    if entry_map:
        ctx.outputs = apply_entry_map(ctx.outputs, entry_map)
        ctx.invalidate_shapes()
    return rewrites


# -------------------------------------------------------------- bn_fold ----

def run_bn_fold(ctx):
    """Fold inference BatchNorm into the preceding Convolution/FC:
    ``conv(x, W*s) + ((b - mean)*s + beta)`` with ``s = gamma/sqrt(var +
    eps)`` per output channel. The scale/bias arithmetic is emitted as
    graph nodes over the BN parameters, which ``fold`` materializes once
    at bind when they are frozen."""
    cons = consumers_of(ctx.outputs)
    out_set = {(id(n), i) for n, i in ctx.outputs}
    entry_map = {}
    count = 0
    for node in topo_from(ctx.outputs):
        if node.is_variable or node.opdef().name != "BatchNorm":
            continue
        attrs = node.parsed_attrs()
        if attrs.output_mean_var:
            continue
        src, sidx = node.inputs[0]
        if src.is_variable or sidx != 0:
            continue
        sop = src.opdef().name
        if sop not in ("Convolution", "FullyConnected"):
            continue
        # the producer must feed ONLY this BN and not be an output itself
        if len(cons.get(id(src), ())) != 1 or (id(src), 0) in out_set:
            continue
        sattrs = src.parsed_attrs()
        if sop == "Convolution":
            channels_last = bool(sattrs.layout) and \
                sattrs.layout.endswith("C")
            rank = len(sattrs.kernel) + 2
            ch_axis = rank - 1 if channels_last else 1
            w_rank = rank
            # weight layouts: OI<sp> (channels-first) vs <sp>IO
            w_ch_axis = (w_rank - 1) if channels_last else 0
        else:
            shape = ctx.shape_of((src, 0))
            rank = len(shape) if shape else 2
            ch_axis = rank - 1
            w_rank, w_ch_axis = 2, 0
        has_bias = not sattrs.no_bias
        bn_axis = attrs.axis if attrs.axis >= 0 else rank + attrs.axis
        if bn_axis != ch_axis:
            continue
        gamma_e, beta_e = node.inputs[1], node.inputs[2]
        mean_e, var_e = node.inputs[3], node.inputs[4]
        pre = "_gp_bnfold%d_%s" % (ctx.uid(), node.name)
        veps = (make_node("_plus_scalar", pre + "_veps", [var_e],
                          scalar=attrs.eps), 0)
        rstd = (make_node("rsqrt", pre + "_rstd", [veps]), 0)
        scale = rstd if attrs.fix_gamma else \
            (make_node("elemwise_mul", pre + "_scale", [gamma_e, rstd]), 0)
        wshape = tuple(-1 if i == w_ch_axis else 1 for i in range(w_rank))
        scale_w = (make_node("Reshape", pre + "_scalew", [scale],
                             shape=wshape), 0)
        new_w = (make_node("broadcast_mul", pre + "_w",
                           [src.inputs[1], scale_w]), 0)
        m_s = (make_node("elemwise_mul", pre + "_ms", [mean_e, scale]), 0)
        if has_bias:
            b_s = (make_node("elemwise_mul", pre + "_bs",
                             [src.inputs[2], scale]), 0)
            t = (make_node("elemwise_sub", pre + "_t", [b_s, m_s]), 0)
            new_b = (make_node("elemwise_add", pre + "_b", [t, beta_e]), 0)
        else:
            new_b = (make_node("elemwise_sub", pre + "_b",
                               [beta_e, m_s]), 0)
            set_attrs(src, no_bias=False)
        src.inputs = [src.inputs[0], new_w, new_b]
        entry_map[(id(node), 0)] = (src, 0)
        count += 1
    if count:
        ctx.outputs = apply_entry_map(ctx.outputs, entry_map)
        ctx.invalidate_shapes()
    return count


# --------------------------------------------------------------- layout ----

# (data-in perm, output-back perm, weight perm) for each rewrite direction
_LAYOUT_PERMS = {
    ("NCHW", "NHWC"): ((0, 2, 3, 1), (0, 3, 1, 2), (2, 3, 1, 0)),
    ("NHWC", "NCHW"): ((0, 3, 1, 2), (0, 2, 3, 1), (3, 2, 0, 1)),
}

# single-data-input ops a transpose sinks through unchanged (pointwise)
_SINK_UNARY = frozenset({
    "Activation", "relu", "sigmoid", "tanh", "softrelu", "softsign",
    "abs", "square", "sqrt", "exp", "_copy", "BlockGrad", "Cast",
    "negative", "clip", "_plus_scalar", "_minus_scalar", "_rminus_scalar",
    "_mul_scalar", "_div_scalar", "_rdiv_scalar", "_power_scalar",
})

# same-shape n-ary ops: sink only when EVERY input carries the same perm
_SINK_NARY = frozenset({"elemwise_add", "elemwise_sub", "elemwise_mul",
                        "elemwise_div", "add_n"})


def _as_transpose(entry):
    node, idx = entry
    if node.is_variable or idx != 0 or node.opdef().name != "transpose":
        return None
    axes = node.parsed_attrs().axes
    return tuple(axes) if axes else None


def run_layout(ctx):
    """Graph-wide layout rewrite to a forced target (``layout=NHWC`` in
    MXNET_GRAPH_PASSES): conv/pool nodes in the other layout get their
    ``layout`` attr rewritten and transposes at their boundaries, then a
    sink-and-cancel fixpoint moves transposes through pointwise ops and
    BatchNorm. Without a forced target the pass is a no-op: the JAX
    package's tuned-layout consult has no tuning cache to read here."""
    target = ctx.config.layout_force
    if target not in ("NHWC", "NCHW"):
        return 0
    count = 0
    entry_map = {}
    skip = set()
    for node in topo_from(ctx.outputs):
        if node.is_variable:
            continue
        canon = node.opdef().name
        if canon not in ("Convolution", "Pooling"):
            continue
        attrs = node.parsed_attrs()
        kernel = tuple(attrs.kernel or ())
        if canon == "Pooling" and attrs.global_pool:
            shape = ctx.shape_of(node.inputs[0])
            if shape is None or len(shape) != 4:
                continue
        elif len(kernel) != 2:
            continue
        perms = _LAYOUT_PERMS.get((attrs.layout or "NCHW", target))
        if perms is None:
            continue
        pin, pback, pw = perms
        uid = ctx.uid()
        tin = make_node("transpose", "_gp_lay%d_in" % uid,
                        [node.inputs[0]], axes=pin)
        node.inputs[0] = (tin, 0)
        if canon == "Convolution":
            tw = make_node("transpose", "_gp_lay%d_w" % uid,
                           [node.inputs[1]], axes=pw)
            node.inputs[1] = (tw, 0)
        set_attrs(node, layout=target)
        back = make_node("transpose", "_gp_lay%d_out" % uid,
                         [(node, 0)], axes=pback)
        entry_map[(id(node), 0)] = (back, 0)
        skip.add(id(back))
        count += 1
    if not count:
        return 0
    ctx.outputs = apply_entry_map(ctx.outputs, entry_map, skip=skip)
    for _ in range(64):
        if not _sink_once(ctx):
            break
    ctx.invalidate_shapes()
    return count


def _sink_once(ctx):
    """One sink/cancel sweep; True when anything moved."""
    entry_map = {}
    skip = set()
    changed = False
    for node in topo_from(ctx.outputs):
        if node.is_variable or (id(node), 0) in entry_map:
            continue
        canon = node.opdef().name
        if canon == "transpose":
            q = _as_transpose(node.inputs[0])
            if q is None:
                continue
            p = tuple(node.parsed_attrs().axes or ())
            if len(p) != len(q):
                continue
            comp = tuple(q[a] for a in p)  # transpose(transpose(x,q),p)
            inner_src = node.inputs[0][0].inputs[0]
            if comp == tuple(range(len(comp))):
                entry_map[(id(node), 0)] = inner_src
            else:
                merged = make_node("transpose", "_gp_laym%d" % ctx.uid(),
                                   [inner_src], axes=comp)
                skip.add(id(merged))
                entry_map[(id(node), 0)] = (merged, 0)
            changed = True
            continue
        if num_outputs_of(node) != 1:
            continue
        p = None
        if canon in _SINK_UNARY or (
                canon == "LeakyReLU"
                and node.parsed_attrs().act_type != "prelu"):
            p = _as_transpose(node.inputs[0])
            if p is not None:
                node.inputs = ([node.inputs[0][0].inputs[0]]
                               + node.inputs[1:])
        elif canon in _SINK_NARY:
            perms = [_as_transpose(e) for e in node.inputs]
            if all(q is not None for q in perms) and len(set(perms)) == 1:
                p = perms[0]
                node.inputs = [e[0].inputs[0] for e in node.inputs]
        elif canon == "BatchNorm" and not node.parsed_attrs().output_mean_var:
            p = _as_transpose(node.inputs[0])
            if p is not None:
                attrs = node.parsed_attrs()
                old_axis = attrs.axis if attrs.axis >= 0 else \
                    len(p) + attrs.axis
                node.inputs = ([node.inputs[0][0].inputs[0]]
                               + node.inputs[1:])
                set_attrs(node, axis=p[old_axis])
        if p is not None:
            back = make_node("transpose", "_gp_lays%d" % ctx.uid(),
                             [(node, 0)], axes=p)
            skip.add(id(back))
            entry_map[(id(node), 0)] = (back, 0)
            changed = True
    if entry_map:
        ctx.outputs = apply_entry_map(ctx.outputs, entry_map, skip=skip)
    return changed


# ------------------------------------------------------------------ amp ----

# ops that run in the low-precision dtype (the matmul-bound contractions)
AMP_ALLOW = frozenset({"Convolution", "FullyConnected", "Deconvolution",
                       "dot", "batch_dot"})
# fp32 islands: normalization, softmax/exp families, loss heads
AMP_DENY = frozenset({
    "softmax", "log_softmax", "SoftmaxActivation", "SoftmaxOutput",
    "BatchNorm", "LRN", "InstanceNorm", "L2Normalization", "norm",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "MakeLoss", "softmax_cross_entropy",
    "exp", "log",
})

_FLOATS = ("float32", "float64", "float16", "bfloat16")


def run_amp(ctx):
    """Automatic mixed precision as a graph rewrite: allow-list ops get
    their floating main inputs cast to the policy dtype (bfloat16 by
    default), deny-list ops get theirs cast back to float32 (the fp32
    islands), everything else follows the dtype that arrives. Casts are
    memoised per (entry, dtype); graph outputs are cast back to their
    original dtypes so the interface stays put. Frozen parameter casts
    are folded at bind by ``fold``, which runs after amp."""
    target = str(ctx.config.amp_dtype)
    dtypes = {}

    def dt_of(entry):
        node, idx = entry
        if node.is_variable:
            d = ctx.arg_dtypes.get(node.name)
            return "float32" if d is None else str(d)
        return dtypes.get((id(node), idx), "float32")

    casts = {}

    def cast_entry(entry, dtype):
        key = ((id(entry[0]), entry[1]), dtype)
        hit = casts.get(key)
        if hit is not None:
            return hit
        node = make_node("Cast", "_gp_amp%d_%s" % (ctx.uid(),
                                                   entry[0].name),
                         [entry], dtype=dtype)
        dtypes[(id(node), 0)] = dtype
        casts[key] = (node, 0)
        return casts[key]

    def infer_node(node):
        nm = node.num_main_inputs()
        in_t = [dt_of(e) for e in node.inputs[:nm]]
        aux_t = [dt_of(e) for e in node.inputs[nm:]]
        try:
            res = node.opdef().run_infer_dtype(node.parsed_attrs(), in_t,
                                               aux_t)
        except Exception:  # an op without a dtype rule follows its inputs
            res = None
        if res is not None:
            for i, t in enumerate(res[1]):
                if t is not None:
                    dtypes[(id(node), i)] = str(t)

    # pre-pass: the original output dtypes (the interface to restore)
    for node in topo_from(ctx.outputs):
        if not node.is_variable:
            infer_node(node)
    orig_out = [dt_of(e) for e in ctx.outputs]
    dtypes.clear()

    for node in topo_from(list(ctx.outputs)):
        if node.is_variable:
            continue
        canon = node.opdef().name
        want = target if canon in AMP_ALLOW else \
            ("float32" if canon in AMP_DENY else None)
        if want is not None:
            for slot in range(node.num_main_inputs()):
                d = dt_of(node.inputs[slot])
                if d in _FLOATS and d != want:
                    node.inputs[slot] = cast_entry(node.inputs[slot], want)
        infer_node(node)

    new_outputs = []
    for entry, orig in zip(ctx.outputs, orig_out):
        d = dt_of(entry)
        if d in _FLOATS and orig in _FLOATS and d != orig:
            new_outputs.append(cast_entry(entry, orig))
        else:
            new_outputs.append(entry)
    ctx.outputs = new_outputs
    ctx.invalidate_shapes()
    return len(casts)


# ----------------------------------------------------------------- fold ----

# init-style ops stay lazy (the names match the JAX package, so a graph
# carrying them folds the same way)
_NOFOLD = frozenset({"_zeros", "_ones", "_full", "_arange"})


def run_fold(ctx):
    """Constant folding over frozen-parameter subgraphs: maximal foldable
    frontiers are replaced by fresh variables, and their expressions kept
    on the context so the bind layer evaluates them once."""
    if not ctx.frozen:
        return 0
    topo = topo_from(ctx.outputs)
    foldable = {}

    def entry_ok(entry):
        node, _idx = entry
        if node.is_variable:
            return node.name in ctx.frozen
        return foldable.get(id(node), False)

    for node in topo:
        if node.is_variable:
            continue
        opdef = node.opdef()
        foldable[id(node)] = (opdef.name not in _NOFOLD
                              and "__nofold__" not in node.user_attrs
                              and not opdef.needs_rng
                              and bool(node.inputs)
                              and all(entry_ok(e) for e in node.inputs))
    cons = consumers_of(ctx.outputs)
    out_set = {(id(n), i) for n, i in ctx.outputs}
    frontier = []
    seen = set()
    for node in topo:
        if node.is_variable or not foldable[id(node)]:
            continue
        idxs = set()
        for consumer, slot in cons.get(id(node), ()):
            if not foldable.get(id(consumer), False):
                idxs.add(consumer.inputs[slot][1])
        idxs.update(i for i in range(num_outputs_of(node))
                    if (id(node), i) in out_set)
        for i in sorted(idxs):
            if (id(node), i) not in seen:
                seen.add((id(node), i))
                frontier.append((node, i))
    if not frontier:
        return 0
    entry_map = {}
    for node, i in frontier:
        name = "_gp_fold%d_%s" % (ctx.uid(), node.name) + \
            ("" if i == 0 else "_o%d" % i)
        deps = sorted({n.name for n in topo_from([(node, i)])
                       if n.is_variable})
        ctx.fold_exprs.append((name, (node, i), deps))
        entry_map[(id(node), i)] = (_Node(None, name), 0)
    ctx.outputs = apply_entry_map(ctx.outputs, entry_map)
    ctx.invalidate_shapes()
    return len(frontier)


def eval_fold_exprs(fold_exprs, values, for_training=False):
    """Evaluate every fold expression against ``values`` ({var name:
    tensor}) on the values' device; returns {fold var name: tensor}.
    Shared sub-expressions evaluate once. The JAX package evaluates them
    op by op outside its compiled programs, so a scalar division here
    divides (:func:`~..ops.elemwise.eager_division`)."""
    node_env = {}

    def get_entry(entry):
        node, idx = entry
        if node.is_variable:
            return values[node.name]
        return node_env[(id(node), idx)]

    results = {}
    with torch.inference_mode(), eager_division():
        for name, entry, _deps in fold_exprs:
            for node in topo_from([entry]):
                if node.is_variable or (id(node), 0) in node_env:
                    continue
                nm = node.num_main_inputs()
                outs, _ = node.opdef().apply(
                    node.parsed_attrs(),
                    [get_entry(e) for e in node.inputs[:nm]],
                    [get_entry(e) for e in node.inputs[nm:]],
                    is_train=for_training)
                for i, o in enumerate(outs):
                    node_env[(id(node), i)] = o
            results[name] = get_entry(entry)
    return results

"""Graph-pass substrate: pipeline config, pass context, graph surgery.

Counterpart of ``mxnet_tpu/graph_pass/core.py``. Every pipeline run works
on a private clone of the user's graph; a pass is ``(ctx) ->
rewrite_count`` reading and updating ``ctx.outputs``.
"""
from __future__ import annotations

import os

from ..base import MXNetError
from ..ops.registry import get_op
from ..symbol.symbol import Symbol, _Node

# canonical execution order; the env grammar toggles membership, never
# order. quantize runs after bn_fold so folded convs quantize as one unit,
# and before layout so calibration entry names still resolve; fuse runs
# after amp so the carved regions see the final dtype of every chain (the
# int islands' rescales and amp's casts are epilogue steps, not barriers);
# fold runs last so it materializes what the others leave behind: scale
# vectors, parameter casts, int8 weight tensors.
PIPELINE_ORDER = ("prune", "bn_fold", "quantize", "layout", "amp", "fuse",
                  "fold")

# passes that change inference-only semantics (loss-head simplification,
# folded running statistics, the int8 rewrite) never run on a training
# bind
INFERENCE_ONLY = frozenset({"prune", "bn_fold", "quantize"})

DEFAULT_PASSES = ("prune", "bn_fold", "layout", "fuse", "fold")

_OFF_TOKENS = frozenset({"off", "none", "0", ""})

# process-wide spec override (graph_pass.set_passes); None = env/default
_SPEC_OVERRIDE = None


class PassConfig:
    """Parsed ``MXNET_GRAPH_PASSES`` pipeline selection.

    Grammar (comma-separated, order-insensitive): ``default`` expands to
    the default pipeline; ``all`` to every pass; a bare pass name enables
    it and ``-name`` disables it; ``amp`` / ``amp=<dtype>`` enables the
    mixed-precision rewrite (bfloat16 unless a dtype is named);
    ``quantize`` / ``quantize=<table.json>`` enables the int8 rewrite
    (table resolution: :func:`~.quantize.resolve_table`; the path keeps
    its case); ``layout=NHWC`` (or NCHW) forces the layout target; ``off``
    disables the layer.
    """

    __slots__ = ("passes", "amp_dtype", "layout_force", "quant_table",
                 "quant_skip")

    def __init__(self, spec=None, passes=None, amp_dtype="bfloat16",
                 layout_force=None, quant_table=None, quant_skip=None):
        self.amp_dtype = amp_dtype
        self.layout_force = layout_force
        self.quant_table = quant_table
        self.quant_skip = frozenset(quant_skip or ())
        if passes is not None:
            self.passes = frozenset(passes)
            return
        if spec is None:
            spec = (_SPEC_OVERRIDE if _SPEC_OVERRIDE is not None
                    else os.environ.get("MXNET_GRAPH_PASSES", "default"))
        spec = spec.strip()
        if spec.lower() in _OFF_TOKENS:
            self.passes = frozenset()
            return
        pos, neg = set(), set()
        for token in spec.split(","):
            token = token.strip()
            if not token:
                continue
            negated = token.startswith("-")
            if negated:
                token = token[1:]
            name, _, value = token.partition("=")
            name = name.lower()
            if name == "default":
                (neg if negated else pos).update(DEFAULT_PASSES)
                continue
            if name == "all":
                (neg if negated else pos).update(PIPELINE_ORDER)
                continue
            if name not in PIPELINE_ORDER:
                raise MXNetError(
                    "MXNET_GRAPH_PASSES: unknown pass %r (known: %s, plus "
                    "'default', 'all', 'off')"
                    % (name, ", ".join(PIPELINE_ORDER)))
            (neg if negated else pos).add(name)
            if not negated and name == "amp" and value:
                self.amp_dtype = value.lower()
            if not negated and name == "layout" and value:
                self.layout_force = value.upper()
            if not negated and name == "quantize" and value:
                # a path: the table loads when the pass runs, and its
                # fingerprint keys the bind cache through signature()
                self.quant_table = value
        base = pos if pos else set(DEFAULT_PASSES)
        self.passes = frozenset(base - neg)

    @property
    def enabled(self):
        return bool(self.passes)

    def signature(self):
        """Stable cache-key component for this configuration."""
        quant_sig = None
        if "quantize" in self.passes:
            from .quantize import table_signature

            quant_sig = table_signature(self)
        return (tuple(sorted(self.passes)), self.amp_dtype,
                self.layout_force, quant_sig)

    def __repr__(self):
        return "PassConfig(%s)" % ",".join(
            p for p in PIPELINE_ORDER if p in self.passes)


# --------------------------------------------------------------- graph ops

def clone_entries(entries):
    """Deep-copy the DAG feeding ``entries``; returns (new_entries, memo)
    with memo mapping id(old node) -> new node."""
    memo = {}
    for node in topo_from(entries):
        memo[id(node)] = _Node(node.op, node.name, dict(node.attrs),
                               dict(node.user_attrs),
                               [(memo[id(src)], idx)
                                for src, idx in node.inputs])
    return [(memo[id(n)], i) for n, i in entries], memo


def topo_from(entries):
    """DFS post-order over the nodes reachable from ``entries``."""
    return Symbol(list(entries)).topo_nodes()


def consumers_of(entries):
    """{id(producer node): [(consumer node, input slot)]}."""
    cons = {}
    for node in topo_from(entries):
        for slot, (src, _idx) in enumerate(node.inputs):
            cons.setdefault(id(src), []).append((node, slot))
    return cons


def make_node(op, name, inputs, **attrs):
    """An op node with parsed-then-stringified attrs (the canonical attr
    form ``mx.sym.*`` produces)."""
    opdef = get_op(op)
    parsed = opdef.parse_attrs(attrs)
    return _Node(op, name, attrs=opdef.attrs_to_str_dict(parsed),
                 inputs=list(inputs))


def set_attrs(node, **attrs):
    """Patch a node's op params in place (string form), re-parsing the full
    param set so defaults and validation hold."""
    opdef = node.opdef()
    merged = dict(node.parsed_attrs()._d)
    merged.update(attrs)
    node.attrs = opdef.attrs_to_str_dict(opdef.parse_attrs(merged))
    node._attrs_cache = None


def apply_entry_map(entries, entry_map, skip=()):
    """Rewire every node input (and the output list) through ``entry_map``
    ({(id(node), idx): replacement entry}), following chains. Nodes whose
    id is in ``skip`` keep their inputs. Only nodes reachable along
    resolved edges are rewired, so a replaced subgraph is never mutated.
    Returns the new output list."""
    skip = set(skip)

    def resolve(entry):
        seen = 0
        while (id(entry[0]), entry[1]) in entry_map:
            entry = entry_map[(id(entry[0]), entry[1])]
            seen += 1
            if seen > 10000:
                raise MXNetError("graph_pass: entry replacement cycle")
        return entry

    resolved = [resolve(e) for e in entries]
    visited = set()
    stack = [n for n, _ in resolved]
    while stack:
        node = stack.pop()
        if id(node) in visited or node.is_variable:
            continue
        visited.add(id(node))
        if id(node) not in skip:
            node.inputs = [resolve(e) for e in node.inputs]
        stack.extend(src for src, _ in node.inputs)
    return resolved


def num_outputs_of(node):
    return node.opdef().get_num_outputs(node.parsed_attrs())


class PassContext:
    """Shared state for one pipeline run over one cloned graph."""

    def __init__(self, outputs, for_training, frozen, arg_shapes=None,
                 arg_dtypes=None, config=None, graph_key=None):
        self.outputs = outputs          # [(node, idx)], mutated by passes
        self.for_training = bool(for_training)
        self.frozen = frozenset(frozen or ())
        self.arg_shapes = dict(arg_shapes or {})
        self.arg_dtypes = dict(arg_dtypes or {})
        self.config = config or PassConfig()
        self.graph_key = graph_key
        self.fold_exprs = []            # [(name, entry, [frozen inputs])]
        self.reports = []
        self.pass_extras = {}           # pass name -> JSON-safe detail
        self._shape_map = None
        self._uid = 0

    def uid(self):
        self._uid += 1
        return self._uid

    def node_count(self):
        return sum(1 for n in topo_from(self.outputs) if not n.is_variable)

    def symbol(self):
        return Symbol(list(self.outputs))

    def shape_of(self, entry):
        """Inferred shape of one entry (None when inference can't tell),
        computed once per pipeline state from the bind-time arg shapes."""
        if self._shape_map is None:
            self._shape_map = self._infer_shapes()
        node, idx = entry
        if node.is_variable:
            return self._shape_map.get(node.name)
        return self._shape_map.get((id(node), idx))

    def invalidate_shapes(self):
        self._shape_map = None

    def _infer_shapes(self):
        sym = self.symbol()
        internals = sym.get_internals()
        inputs = set(sym.list_inputs())
        feed = {k: tuple(v) for k, v in self.arg_shapes.items()
                if v is not None and k in inputs}
        try:
            _, out_shapes, _ = internals.infer_shape_partial(**feed)
        except MXNetError:
            return {}
        table = {}
        for (node, idx), shape in zip(internals._outputs, out_shapes):
            if shape is None:
                continue
            if node.is_variable:
                table[node.name] = tuple(shape)
            else:
                table[(id(node), idx)] = tuple(shape)
        return table

"""Network visualization: layer-table summary and graphviz plotting.

Counterpart of ``mxnet_tpu/visualization.py`` (reference visualization.py:
print_summary's column layout and parameter counting, plot_network's node
styling): the summary is built as a row list by a small per-op
param-counting table and rendered in one pass; graphviz styling is a
declarative op→style map. ``print_summary`` prints the JAX package's text
for the same graph.
"""
from __future__ import annotations

import json

from .symbol import Symbol

__all__ = ["print_summary", "plot_network"]


def _tuple_attr(text):
    body = str(text).strip("()[] ")
    return tuple(int(x) for x in body.split(",") if x.strip()) if body else ()


def _truthy(attrs, key):
    return attrs.get(key, "False") in ("True", "true", "1")


def _graph_and_shapes(symbol, shape):
    """Parsed node list + name→shape map (when input shapes are given)."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    shape_dict = None
    if shape is not None:
        internals = symbol.get_internals()
        _args, out_shapes, _auxs = internals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(internals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    heads = set(conf["heads"][0] if conf["heads"]
                and isinstance(conf["heads"][0], list) else [])
    return conf["nodes"], heads, shape_dict


def _node_shape(node, shape_dict):
    """This node's output shape minus the batch axis ([] when unknown)."""
    if shape_dict is None:
        return []
    key = node["name"] + ("_output" if node["op"] != "null" else "")
    return list(shape_dict.get(key, ())[1:])


def _count_params(node, fan_in, out_shape):
    """Learnable parameter count contributed by one node."""
    op = node["op"]
    attrs = node.get("attrs", node.get("param", {})) or {}
    if op == "Convolution":
        filters = int(attrs["num_filter"])
        count = fan_in * filters
        for k in _tuple_attr(attrs.get("kernel", "()")):
            count *= k
        return count + (0 if _truthy(attrs, "no_bias") else filters)
    if op == "FullyConnected":
        hidden = int(attrs["num_hidden"])
        per_unit = fan_in if _truthy(attrs, "no_bias") else fan_in + 1
        return per_unit * hidden
    if op == "BatchNorm":
        return 2 * int(out_shape[0]) if out_shape else 0
    if op == "Embedding":
        return int(attrs["input_dim"]) * int(attrs["output_dim"])
    return 0


def print_summary(symbol, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """Print the layer table; returns the total parameter count."""
    nodes, heads, shape_dict = _graph_and_shapes(symbol, shape)
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]

    def emit(fields):
        line = ""
        for text, stop in zip(fields, positions):
            line = (line + str(text))[:stop].ljust(stop)
        print(line)

    print("_" * line_length)
    emit(["Layer (type)", "Output Shape", "Param #", "Previous Layer"])
    print("=" * line_length)

    total = 0
    for i, node in enumerate(nodes):
        op = node["op"]
        if op == "null" and i > 0:
            continue
        out_shape = (_node_shape(node, shape_dict)
                     if (op != "null" or i in heads) else [])

        # predecessors that are ops (or graph heads) + their channel sum
        parents, fan_in = [], 0
        if op != "null":
            for src_idx, *_rest in node["inputs"]:
                src = nodes[src_idx]
                if src["op"] == "null" and src_idx not in heads:
                    continue
                parents.append(src["name"])
                if shape_dict is not None:
                    src_shape = _node_shape(src, shape_dict)
                    if src_shape:
                        fan_in += int(src_shape[0])

        count = _count_params(node, fan_in, out_shape)
        total += count
        emit(["%s(%s)" % (node["name"], op),
              "x".join(str(d) for d in out_shape), count,
              parents[0] if parents else ""])
        for extra in parents[1:]:
            emit(["", "", "", extra])
        print(("=" if i == len(nodes) - 1 else "_") * line_length)
    print("Total params: %d" % total)
    print("_" * line_length)
    return total


_HIDDEN_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta", "_moving_mean",
                    "_moving_var")

# op -> (fill color, label builder)
_STYLES = {
    "null": ("#8dd3c7", None),
    "Convolution": ("#fb8072", lambda a: "Convolution\n%s/%s, %s" % (
        a.get("kernel", "?"), a.get("stride", "(1,1)"),
        a.get("num_filter", "?"))),
    "FullyConnected": ("#fb8072",
                       lambda a: "FullyConnected\n%s" % a.get("num_hidden",
                                                              "?")),
    "BatchNorm": ("#bebada", None),
    "Activation": ("#ffffb3", lambda a: "Activation\n%s" % a.get("act_type",
                                                                 "")),
    "LeakyReLU": ("#ffffb3", lambda a: "LeakyReLU\n%s" % a.get("act_type",
                                                               "")),
    "Pooling": ("#80b1d3", lambda a: "Pooling\n%s, %s/%s" % (
        a.get("pool_type", "?"), a.get("kernel", "?"),
        a.get("stride", "(1,1)"))),
    "Concat": ("#fdb462", None),
    "Flatten": ("#fdb462", None),
    "Reshape": ("#fdb462", None),
    "Softmax": ("#fccde5", None),
    "SoftmaxOutput": ("#fccde5", None),
}
_DEFAULT_FILL = "#b3de69"


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Build a graphviz Digraph of the symbol (graphviz is optional)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("Draw network requires graphviz library")
    nodes, _heads, shape_dict = _graph_and_shapes(symbol, shape)

    base_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    if node_attrs:
        base_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)

    hidden = set()
    for node in nodes:
        op, name = node["op"], node["name"]
        attrs = node.get("attrs", {}) or {}
        if op == "null" and hide_weights and name.endswith(_HIDDEN_SUFFIXES):
            hidden.add(name)
            continue
        fill, labeler = _STYLES.get(op, (_DEFAULT_FILL, None))
        label = labeler(attrs) if labeler else name
        dot.node(name=name, label=label, **dict(base_attr, fillcolor=fill))

    for node in nodes:
        if node["op"] == "null":
            continue
        for src_idx, *_rest in node["inputs"]:
            src = nodes[src_idx]
            if src["name"] in hidden:
                continue
            edge_attr = {"dir": "back", "arrowtail": "open"}
            if shape_dict is not None:
                src_shape = _node_shape(src, shape_dict)
                if src_shape:
                    edge_attr["label"] = "x".join(str(d) for d in src_shape)
            dot.edge(tail_name=node["name"], head_name=src["name"],
                     **edge_attr)
    return dot

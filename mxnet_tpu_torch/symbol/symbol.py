"""Symbol — the declarative graph frontend.

Counterpart of ``mxnet_tpu/symbol/symbol.py``. A Symbol is a DAG of
:class:`_Node`s with string attrs, serialized in the nnvm JSON format, so a
graph written by ``mxnet_tpu`` (``tojson``) loads here unchanged.
``bind`` / ``simple_bind`` make an ``executor.Executor``; the serving path
evaluates graphs through ``executor._GraphProgram`` directly.
"""
from __future__ import annotations

import json

import numpy as np

from ..base import AttrScope, MXNetError, dtype_name, np_dtype
from ..ops.param import Shape
from ..ops.registry import get_op

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json"]


def _merge_shape(old, new, what=""):
    """Merge two partial shapes (0 = unknown dim, the nnvm convention)."""
    if old is None:
        return tuple(new)
    if new is None:
        return tuple(old)
    if len(old) != len(new):
        raise MXNetError("shape rank mismatch for %s: %s vs %s"
                         % (what, old, new))
    out = []
    for a, b in zip(old, new):
        if a == 0:
            out.append(b)
        elif b == 0 or a == b:
            out.append(a)
        else:
            raise MXNetError("shape mismatch for %s: %s vs %s"
                             % (what, old, new))
    return tuple(out)


def _np_or_name(name):
    """np.dtype for a dtype name; bfloat16 stays a name where numpy has no
    such type."""
    try:
        return np_dtype(name)
    except MXNetError:
        return name


class _Node:
    """One graph node: an op application, or a variable (op=None)."""

    __slots__ = ("op", "name", "attrs", "user_attrs", "inputs",
                 "_attrs_cache")

    def __init__(self, op, name, attrs=None, user_attrs=None, inputs=()):
        self.op = op                             # op name, None = variable
        self.name = name
        self.attrs = dict(attrs or {})           # op params, string form
        self.user_attrs = dict(user_attrs or {})  # __shape__, ctx_group...
        self.inputs = list(inputs)               # [(node, out_index)]
        self._attrs_cache = None

    @property
    def is_variable(self):
        return self.op is None

    def opdef(self):
        return get_op(self.op)

    def parsed_attrs(self):
        if self._attrs_cache is None:
            self._attrs_cache = self.opdef().parse_attrs(self.attrs)
        return self._attrs_cache

    def num_main_inputs(self):
        if self.is_variable:
            return 0
        return self.opdef().get_num_inputs(self.parsed_attrs())


class Symbol:
    """A (multi-)output symbolic expression."""

    def __init__(self, outputs):
        self._outputs = list(outputs)  # [(node, out_index)]

    # --- introspection -----------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        if len(self._outputs) == 1:
            return "<Symbol %s>" % self._outputs[0][0].name
        return "<Symbol group [%s]>" % ", ".join(
            n.name for n, _ in self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (Symbol([o]) for o in self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index in names:
                return Symbol([self._outputs[names.index(index)]])
            raise ValueError("cannot find output %r" % index)
        return Symbol([self._outputs[index]])

    def get_internals(self):
        """Symbol grouping every internal output."""
        entries = []
        for node in self.topo_nodes():
            if node.is_variable:
                entries.append((node, 0))
            else:
                nout = node.opdef().get_num_outputs(node.parsed_attrs())
                entries.extend((node, i) for i in range(nout))
        return Symbol(entries)

    def topo_nodes(self):
        """All nodes in DFS post-order (inputs before consumers)."""
        order = []
        visited = set()
        for root, _ in self._outputs:
            # iterative DFS: deep graphs stay clear of the recursion limit
            stack = [(root, False)]
            while stack:
                node, expanded = stack.pop()
                if expanded:
                    order.append(node)
                    continue
                if id(node) in visited:
                    continue
                visited.add(id(node))
                stack.append((node, True))
                for inp, _ in reversed(node.inputs):
                    if id(inp) not in visited:
                        stack.append((inp, False))
        return order

    def _classify_vars(self):
        """(args, aux) variable nodes: a variable feeding an input slot
        beyond an op's main inputs is an auxiliary state."""
        aux_ids = set()
        topo = self.topo_nodes()
        for node in topo:
            if node.is_variable:
                continue
            n_main = node.num_main_inputs()
            for slot, (inp, _) in enumerate(node.inputs):
                if slot >= n_main and inp.is_variable:
                    aux_ids.add(id(inp))
        args, aux = [], []
        for node in topo:
            if node.is_variable:
                (aux if id(node) in aux_ids else args).append(node)
        return args, aux

    def list_arguments(self):
        return [n.name for n in self._classify_vars()[0]]

    def list_auxiliary_states(self):
        return [n.name for n in self._classify_vars()[1]]

    def list_outputs(self):
        """Output entry names, ``<node>_output`` style."""
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
            elif node.opdef().get_num_outputs(node.parsed_attrs()) == 1:
                names.append(node.name + "_output")
            else:
                names.append("%s_output%d" % (node.name, idx))
        return names

    def list_inputs(self):
        return [n.name for n in self.topo_nodes() if n.is_variable]

    def attr(self, key):
        """This symbol's attribute ``key`` (its node's), or None."""
        nodes = {id(n): n for n, _ in self._outputs}
        if len(nodes) == 1:
            node = next(iter(nodes.values()))
            return node.user_attrs.get(key, node.attrs.get(key))
        return None

    def attr_dict(self):
        """{node name: {attr: value}} over the whole graph."""
        out = {}
        for node in self.topo_nodes():
            d = dict(node.attrs)
            d.update(node.user_attrs)
            if d:
                out[node.name] = d
        return out

    # --- shape/type inference ----------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """Full shape inference; raises when an argument stays unknown."""
        res = self.infer_shape_partial(*args, **kwargs)
        arg_shapes = res[0]
        if arg_shapes and any(s is None or 0 in s for s in arg_shapes):
            missing = [n for n, s in zip(self.list_arguments(), arg_shapes)
                       if s is None or 0 in s]
            raise MXNetError("cannot fully infer shapes; undetermined "
                             "args: %s" % missing)
        return res

    def infer_shape_partial(self, *args, **kwargs):
        """Partial shape inference: a 0 dim means unknown. Shapes merge dim
        by dim to a fixed point over forward and backward shape rules."""
        known = self._build_known(args, kwargs, self.list_arguments())
        entry_shape = {}
        var_shape = {k: tuple(v) for k, v in known.items() if v is not None}
        topo = self.topo_nodes()
        for node in topo:
            if node.is_variable and "__shape__" in node.user_attrs:
                raw = tuple(Shape().parse(node.user_attrs["__shape__"]))
                if raw:
                    var_shape[node.name] = _merge_shape(
                        var_shape.get(node.name), raw, node.name)

        def known_only(s):
            return s if (s is not None and 0 not in s) else None

        def entry_get(e):
            n, i = e
            if n.is_variable:
                return var_shape.get(n.name)
            return entry_shape.get((id(n), i))

        for _ in range(8):
            changed = False

            def put_entry(e, s):
                nonlocal changed
                if s is None:
                    return
                s = tuple(max(0, int(d)) for d in s)
                n, i = e
                if n.is_variable:
                    merged = _merge_shape(var_shape.get(n.name), s, n.name)
                    if merged != var_shape.get(n.name):
                        var_shape[n.name] = merged
                        changed = True
                else:
                    merged = _merge_shape(entry_shape.get((id(n), i)), s,
                                          "%s[%d]" % (n.name, i))
                    if merged != entry_shape.get((id(n), i)):
                        entry_shape[(id(n), i)] = merged
                        changed = True

            for node in topo:
                if node.is_variable:
                    continue
                attrs = node.parsed_attrs()
                opdef = node.opdef()
                n_main = node.num_main_inputs()
                in_shapes = [entry_get(e) for e in node.inputs[:n_main]]
                aux_shapes = [entry_get(e) for e in node.inputs[n_main:]]
                if opdef.infer_shape is None:
                    in_shapes = [known_only(s) for s in in_shapes]
                    aux_shapes = [known_only(s) for s in aux_shapes]
                try:
                    res = opdef.run_infer_shape(attrs, in_shapes, aux_shapes)
                except Exception as e:
                    if opdef.infer_shape is not None and any(
                            s is not None and 0 in s
                            for s in in_shapes + aux_shapes):
                        # retry with the partial shapes masked out
                        try:
                            res = opdef.run_infer_shape(
                                attrs, [known_only(s) for s in in_shapes],
                                [known_only(s) for s in aux_shapes])
                        except Exception as e2:
                            raise MXNetError("infer_shape error in %s(%s): %s"
                                             % (node.op, node.name, e2))
                    else:
                        raise MXNetError("infer_shape error in %s(%s): %s"
                                         % (node.op, node.name, e))
                if res is None:
                    continue
                new_in, new_out, new_aux = res
                for e, s in zip(node.inputs, list(new_in) + list(new_aux)):
                    put_entry(e, s)
                for i, s in enumerate(new_out):
                    put_entry((node, i), s)
                if opdef.infer_backward is not None:
                    outs = [entry_shape.get((id(node), i)) for i in
                            range(opdef.get_num_outputs(attrs))]
                    back = opdef.infer_backward(
                        attrs, outs, [entry_get(e)
                                      for e in node.inputs[:n_main]])
                    if back is not None:
                        for e, s in zip(node.inputs[:n_main], back):
                            put_entry(e, s)
            if not changed:
                break

        args_list, aux_list = self._classify_vars()
        out_shapes = [var_shape.get(n.name) if n.is_variable
                      else entry_shape.get((id(n), idx))
                      for n, idx in self._outputs]
        return ([var_shape.get(n.name) for n in args_list], out_shapes,
                [var_shape.get(n.name) for n in aux_list])

    def infer_type(self, *args, **kwargs):
        """Dtype inference; unknowns default to float32."""
        known = self._build_known(args, kwargs, self.list_arguments())
        var_t = {k: dtype_name(v) for k, v in known.items()}
        entry_t = {}
        topo = self.topo_nodes()

        def entry_get(e):
            n, i = e
            return var_t.get(n.name) if n.is_variable \
                else entry_t.get((id(n), i))

        for _ in range(3):
            changed = False
            for node in topo:
                if node.is_variable:
                    continue
                n_main = node.num_main_inputs()
                res = node.opdef().run_infer_dtype(
                    node.parsed_attrs(),
                    [entry_get(e) for e in node.inputs[:n_main]],
                    [entry_get(e) for e in node.inputs[n_main:]])
                if res is None:
                    continue
                new_in, new_out, new_aux = res
                for (n, i), t in zip(node.inputs,
                                     list(new_in) + list(new_aux)):
                    if t is None:
                        continue
                    if n.is_variable:
                        if var_t.get(n.name) is None:
                            var_t[n.name] = t
                            changed = True
                    elif entry_t.get((id(n), i)) is None:
                        entry_t[(id(n), i)] = t
                        changed = True
                for i, t in enumerate(new_out):
                    if t is not None and entry_t.get((id(node), i)) is None:
                        entry_t[(id(node), i)] = t
                        changed = True
            if not changed:
                break
        args_list, aux_list = self._classify_vars()
        return ([_np_or_name(var_t.get(n.name) or "float32")
                 for n in args_list],
                [_np_or_name(entry_get((n, i)) or "float32")
                 for n, i in self._outputs],
                [_np_or_name(var_t.get(n.name) or "float32")
                 for n in aux_list])

    @staticmethod
    def _build_known(args, kwargs, names):
        known = {}
        for name, v in zip(names, args or ()):
            if v is not None:
                known[name] = v
        for k, v in kwargs.items():
            if v is not None:
                known[k] = v
        return known

    # --- serialization ------------------------------------------------------
    def tojson(self):
        """nnvm-format JSON, as ``mxnet_tpu`` writes it."""
        topo = self.topo_nodes()
        nid = {id(n): i for i, n in enumerate(topo)}
        nodes = []
        for n in topo:
            attrs = dict(n.attrs)
            attrs.update(n.user_attrs)
            entry = {"op": "null" if n.is_variable else n.op,
                     "name": n.name,
                     "inputs": [[nid[id(src)], idx, 0]
                                for src, idx in n.inputs]}
            if attrs:
                entry["attrs"] = attrs
            nodes.append(entry)
        graph = {
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(topo) if n.is_variable],
            "node_row_ptr": list(range(len(topo) + 1)),
            "heads": [[nid[id(n)], idx, 0] for n, idx in self._outputs],
            "attrs": {"mxnet_version": ["int", 10000]},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # --- binding ------------------------------------------------------------
    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    shared_exec=None, frozen_params=None, **kwargs):
        """Allocate zero arrays on ``ctx`` by shape and dtype inference and
        bind them. ``frozen_params`` names arguments whose values stay
        fixed for the executor's lifetime (the fold pass may fold them)."""
        from ..executor import Executor
        from .. import ndarray as nd

        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_types, _, aux_types = self.infer_type(**dict(type_dict or {}))
        arg_names = self.list_arguments()
        reqs = _normalize_grad_req(grad_req, arg_names)
        args, grads = {}, {}
        for name, shape, t in zip(arg_names, arg_shapes, arg_types):
            args[name] = nd.zeros(shape, ctx=ctx, dtype=t)
            if reqs[name] != "null":
                grads[name] = nd.zeros(shape, ctx=ctx, dtype=t)
        aux = {name: nd.zeros(shape, ctx=ctx, dtype=t) for name, shape, t
               in zip(self.list_auxiliary_states(), aux_shapes, aux_types)}
        return Executor(self, ctx, args, grads, reqs, aux,
                        shared_exec=shared_exec, frozen_params=frozen_params)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None,
             frozen_params=None):
        """Bind existing arrays (dicts by name, or lists in argument
        order); an argument without a gradient array gets grad_req
        null."""
        from ..executor import Executor

        arg_names = self.list_arguments()
        args = _name_arrays(args, arg_names, "args")
        args_grad = {} if args_grad is None else _name_arrays(
            args_grad, arg_names, "args_grad", allow_missing=True)
        aux_states = _name_arrays(aux_states or {},
                                  self.list_auxiliary_states(), "aux_states")
        reqs = _normalize_grad_req(grad_req, arg_names)
        reqs = {n: (r if n in args_grad else "null")
                for n, r in reqs.items()}
        return Executor(self, ctx, args, args_grad, reqs, aux_states,
                        shared_exec=shared_exec, group2ctx=group2ctx,
                        frozen_params=frozen_params)

    # --- operators -----------------------------------------------------------
    def _binop(self, other, op_name, scalar_op, reverse=False):
        from .register import make_symbol

        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return make_symbol(get_op(op_name), (a, b), {})
        if np.isscalar(other):
            return make_symbol(get_op(scalar_op), (self,),
                               {"scalar": float(other)})
        raise TypeError("type %s not supported" % type(other))

    def __add__(self, other):
        return self._binop(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binop(other, "broadcast_sub", "_rminus_scalar",
                           reverse=True)

    def __mul__(self, other):
        return self._binop(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "broadcast_div", "_div_scalar")

    def __neg__(self):
        return self.__mul__(-1.0)

    __hash__ = object.__hash__


def _normalize_grad_req(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    out = {n: "null" for n in arg_names}
    out.update(grad_req)
    return out


def _name_arrays(arrays, names, what, allow_missing=False):
    if isinstance(arrays, dict):
        return dict(arrays)
    arrays = list(arrays)
    if len(arrays) != len(names) and not allow_missing:
        raise MXNetError("%s length %d != expected %d (%s)"
                         % (what, len(arrays), len(names), names))
    return {n: a for n, a in zip(names, arrays) if a is not None}


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, **kwargs):
    """Create a variable symbol."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    user_attrs = dict(AttrScope.current().get(attr))
    if shape is not None:
        user_attrs["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        user_attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        user_attrs["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        user_attrs["__dtype__"] = dtype_name(dtype)
    if init is not None:
        user_attrs["__init__"] = init if isinstance(init, str) \
            else init.dumps()
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            user_attrs[k] = str(v)
    return Symbol([(_Node(None, name, user_attrs=user_attrs), 0)])


Variable = var


def Group(symbols):
    """Group symbols into one multi-output symbol."""
    entries = []
    for s in symbols:
        entries.extend(s._outputs)
    return Symbol(entries)


def load_json(json_str):
    """Load a symbol from nnvm JSON (the 1.0 ``attrs`` and the pre-0.9
    ``param``/``attr`` node layouts)."""
    graph = json.loads(json_str)
    nodes = []
    for rn in graph["nodes"]:
        op = rn["op"]
        attrs = dict(rn.get("attrs", rn.get("param", {})) or {})
        user = dict(rn.get("attr", {}) or {})
        inputs = [(nodes[nid], idx) for nid, idx, *_ in rn["inputs"]]
        if op == "null":
            user.update(attrs)
            node = _Node(None, rn["name"], user_attrs=user, inputs=inputs)
        else:
            opdef = get_op(op)
            known = {k: v for k, v in attrs.items() if k in opdef.params}
            extra = {k: v for k, v in attrs.items() if k not in opdef.params}
            extra.update(user)
            node = _Node(op, rn["name"], attrs=known, user_attrs=extra,
                         inputs=inputs)
            # pre-0.9 graphs list only the main inputs: append aux states
            parsed = opdef.parse_attrs(known)
            aux_names = opdef.get_aux_names(parsed)
            if aux_names and len(inputs) == opdef.get_num_inputs(parsed):
                for an in aux_names:
                    node.inputs.append(
                        (_Node(None, "%s_%s" % (rn["name"], an)), 0))
        nodes.append(node)
    return Symbol([(nodes[nid], idx) for nid, idx, *_ in graph["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())

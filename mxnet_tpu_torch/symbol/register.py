"""``mx.sym.*`` generated from the op registry.

Counterpart of ``mxnet_tpu/symbol/register.py``: one composing function per
registered op. Missing tensor inputs become auto-named variables
(``fc1_weight`` style), as MXNet's NameManager does.
"""
from __future__ import annotations

from ..base import AttrScope, MXNetError, NameManager
from ..ops.registry import OP_REGISTRY
from .symbol import Symbol, _Node, var

__all__ = ["make_symbol", "populate_namespaces"]


def make_symbol(opdef, args, kwargs):
    kwargs = dict(kwargs)
    name = kwargs.pop("name", None)
    attr = kwargs.pop("attr", None)
    sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    attr_kwargs = {k: v for k, v in kwargs.items()
                   if not isinstance(v, Symbol)}
    # reference signatures allow trailing positional params
    args = opdef.bind_positional_params(args, attr_kwargs, Symbol)
    if "num_args" in opdef.params and "num_args" not in attr_kwargs:
        attr_kwargs["num_args"] = len(args) + len(sym_kwargs)

    attrs = opdef.parse_attrs(attr_kwargs)
    all_names = opdef.get_input_names(attrs) + opdef.get_aux_names(attrs)
    name = NameManager.current().get(name, opdef.hint)

    entries = [None] * len(all_names)
    for i, s in enumerate(args):
        if not isinstance(s, Symbol):
            raise TypeError("%s: positional input %d must be Symbol, got %s"
                            % (opdef.name, i, type(s)))
        entries[i] = s
    for k, v in sym_kwargs.items():
        if k not in all_names:
            raise MXNetError("%s: unknown input %r (inputs: %s)"
                             % (opdef.name, k, all_names))
        entries[all_names.index(k)] = v

    inputs = []
    for slot, s in enumerate(entries):
        if s is None:
            s = var("%s_%s" % (name, all_names[slot]))
        if len(s._outputs) != 1:
            raise MXNetError("%s: input %d is a multi-output symbol; select "
                             "an output first" % (opdef.name, slot))
        inputs.append(s._outputs[0])

    node = _Node(opdef.name, name, attrs=opdef.attrs_to_str_dict(attrs),
                 user_attrs=AttrScope.current().get(attr), inputs=inputs)
    return Symbol([(node, i) for i in range(opdef.get_num_outputs(attrs))])


def _make_sym_func(opdef):
    def sym_fn(*args, **kwargs):
        return make_symbol(opdef, args, kwargs)

    sym_fn.__name__ = sym_fn.__qualname__ = opdef.name
    sym_fn.__doc__ = opdef.doc or "%s (symbol op)" % opdef.name
    return sym_fn


def populate_namespaces(op_module, internal_module, contrib_module=None):
    """One function per registered op: ``_contrib_X`` goes to
    ``_internal`` under its own name and to ``contrib`` as ``X``, another
    ``_X`` to ``_internal``, the rest to ``op``."""
    for name, opdef in OP_REGISTRY.items():
        if name.startswith("_contrib_") and contrib_module is not None:
            setattr(internal_module, name, _make_sym_func(opdef))
            pub = _make_sym_func(opdef)
            pub.__name__ = pub.__qualname__ = name[len("_contrib_"):]
            setattr(contrib_module, pub.__name__, pub)
            continue
        target = internal_module if name.startswith("_") else op_module
        setattr(target, name, _make_sym_func(opdef))

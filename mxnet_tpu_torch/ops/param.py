"""Declarative op parameters — the ``dmlc::Parameter`` analog.

Counterpart of ``mxnet_tpu/ops/param.py``. Every field parses from the MXNet
string form (symbol attrs, nnvm JSON) and from native Python values, and
serializes back to the canonical string, so symbol JSON written by either
package loads in the other.
"""
from __future__ import annotations

import ast

import numpy as np
import torch

from ..base import MXNetError, dtype_name

__all__ = ["Field", "Int", "Float", "Bool", "Str", "Shape", "FloatList",
           "Enum", "DType", "required", "parse_params", "params_to_str_dict"]


class _Required:
    def __repr__(self):
        return "required"


required = _Required()


def _literal(v):
    return ast.literal_eval(v) if isinstance(v, str) else v


class Field:
    """One declared parameter field."""

    def __init__(self, default=required, doc=""):
        self.default = default
        self.doc = doc

    def parse(self, v):
        raise NotImplementedError

    def to_str(self, v):
        return str(v)


class Int(Field):
    def parse(self, v):
        if v is None or v == "None":
            return None
        return int(_literal(v))


class Float(Field):
    def parse(self, v):
        if v is None or v == "None":
            return None
        return float(_literal(v))


class Bool(Field):
    def parse(self, v):
        if isinstance(v, str):
            lv = v.strip().lower()
            if lv in ("true", "1"):
                return True
            if lv in ("false", "0"):
                return False
            raise MXNetError("cannot parse bool from %r" % v)
        return bool(v)


class Str(Field):
    def parse(self, v):
        return None if v is None or v == "None" else str(v)


class Shape(Field):
    """Tuple-of-int field: parses '(2, 2)', '2', '[2,2]', None."""

    def parse(self, v):
        if v is None:
            return None
        if isinstance(v, str):
            s = v.strip()
            if s in ("None", ""):
                return None
            v = ast.literal_eval(s)
        if isinstance(v, (int, np.integer)):
            return (int(v),)
        return tuple(None if x is None else int(x) for x in v)

    def to_str(self, v):
        if v is None:
            return "None"
        return "(" + ", ".join(
            "None" if x is None else str(int(x)) for x in v) + ")"


class FloatList(Field):
    """Tuple-of-float field: parses '(0.1, 0.2)', '0.5', '[1,2]' (the
    detection ops' sizes, ratios and variances)."""

    def parse(self, v):
        if v is None:
            return None
        if isinstance(v, str):
            s = v.strip()
            if s in ("None", ""):
                return None
            v = ast.literal_eval(s)
        if isinstance(v, (int, float, np.integer, np.floating)):
            return (float(v),)
        return tuple(float(x) for x in v)

    def to_str(self, v):
        if v is None:
            return "None"
        return "(" + ", ".join(repr(float(x)) for x in v) + ")"


class Enum(Field):
    def __init__(self, values, default=required, doc=""):
        super().__init__(default, doc)
        self.values = tuple(values)

    def parse(self, v):
        if v is None:
            return None
        v = str(v)
        if v not in self.values:
            raise MXNetError("invalid enum value %r, expected one of %s"
                             % (v, self.values))
        return v


class DType(Field):
    """Dtype field holding the canonical name ('float32', 'bfloat16', ...)."""

    def parse(self, v):
        if v is None or v == "None":
            return None
        if isinstance(v, str) and v != "bfloat16":
            return np.dtype(v).name
        if isinstance(v, torch.dtype):
            return dtype_name(v)
        return v if isinstance(v, str) else np.dtype(v).name


def parse_params(fields, kwargs, op_name=""):
    """Parse user kwargs against declared fields into a dict of typed
    values. Unknown keys raise; ``__dunder__`` symbol attrs are skipped
    (the symbol layer keeps those)."""
    out = {}
    for k, f in fields.items():
        if k in kwargs:
            try:
                out[k] = f.parse(kwargs[k])
            except (ValueError, SyntaxError, TypeError) as e:
                raise MXNetError("%s: cannot parse param %s=%r: %s"
                                 % (op_name, k, kwargs[k], e))
        elif f.default is required:
            raise MXNetError("%s: missing required param %r" % (op_name, k))
        else:
            out[k] = f.default
    for k in kwargs:
        if k not in fields and not (k.startswith("__") and k.endswith("__")):
            raise MXNetError("%s: unknown param %r" % (op_name, k))
    return out


def params_to_str_dict(fields, params):
    """Serialize parsed params back to the MXNet string-attr form."""
    out = {}
    for k, f in fields.items():
        v = params.get(k, f.default)
        if v is required:
            continue
        out[k] = f.to_str(v)
    return out

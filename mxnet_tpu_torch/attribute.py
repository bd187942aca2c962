"""Attribute scoping (reference: python/mxnet/attribute.py — AttrScope
carries ctx_group/lr_mult/etc. onto symbols created inside the scope).

Counterpart of ``mxnet_tpu/attribute.py``: the implementation lives in
base.py; this module keeps the reference's import location
``mx.attribute.AttrScope``."""
from .base import AttrScope

__all__ = ["AttrScope"]

"""Automatic symbol naming (reference: python/mxnet/name.py —
NameManager assigns `op0`, `op1`, ... and Prefix prepends a scope
prefix).

Counterpart of ``mxnet_tpu/name.py``: the implementation lives in
base.py; this module keeps the reference's import location
``mx.name.NameManager``."""
from .base import NameManager, Prefix

__all__ = ["NameManager", "Prefix"]

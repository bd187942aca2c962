"""Symbol docstring helpers (reference: python/mxnet/symbol_doc.py).

Counterpart of ``mxnet_tpu/symbol_doc.py``. The reference enriches
generated op docstrings with shared example sections via SymbolDoc
subclasses; the ops' docs here are written in their registrations under
``ops/``, so this module keeps the import surface and the utility.
"""
from __future__ import annotations

__all__ = ["SymbolDoc"]


class SymbolDoc:
    """Namespace for doc snippets attached to generated symbol functions."""

    @staticmethod
    def get_output_shape(sym, **input_shapes):
        """Convenience from the reference docs: infer and map output
        shapes for the given input shapes."""
        _args, out_shapes, _auxs = sym.infer_shape(**input_shapes)
        return dict(zip(sym.list_outputs(), out_shapes))

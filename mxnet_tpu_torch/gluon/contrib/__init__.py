"""Experimental Gluon pieces kept at reference import locations
(counterpart of ``mxnet_tpu/gluon/contrib/``)."""
from . import rnn  # noqa: F401

__all__ = ["rnn"]

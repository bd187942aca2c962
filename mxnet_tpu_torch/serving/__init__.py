"""Inference serving (counterpart of ``mxnet_tpu/serving/``); the
:mod:`.generation` subpackage adds autoregressive decode (a paged KV cache
and continuous batching), loaded on first use."""
from .buckets import DEFAULT_BUCKETS, parse_buckets, pick_bucket
from .engine import (DeadlineExceeded, InferenceServer, QueueFullError,
                     ServerClosedError, ServingConfig)

__all__ = ["InferenceServer", "ServingConfig", "QueueFullError",
           "ServerClosedError", "DeadlineExceeded", "parse_buckets",
           "pick_bucket", "DEFAULT_BUCKETS", "generation"]


def __getattr__(name):
    # the generation subsystem pulls in the transformer stack; load it on
    # first use so plain inference serving stays light
    if name == "generation":
        import importlib

        return importlib.import_module(__name__ + ".generation")
    raise AttributeError(name)

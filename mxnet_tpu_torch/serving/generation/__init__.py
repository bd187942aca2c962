"""Autoregressive generation (counterpart of
``mxnet_tpu/serving/generation/``): a paged KV cache, the prefill / decode
split, a continuous-batching scheduler, seeded sampling and speculative
decoding (n-gram or draft-model proposals, one batched verify step), the
prefix cache and the amp policy. On the card each prefill bucket and the
decode, verify and draft steps are CUDA graphs captured once."""
from ..control import PrefixCache, SLOClass
from .engine import (DeadlineExceeded, GenerationConfig, GenerationHandle,
                     Generator, QueueFullError, ServerClosedError,
                     default_prefill_ladder)
from .kv_cache import PagePool
from .sampling import SamplingParams, sample_tokens, verify_tokens
from .speculative import NgramProposer, ngram_propose

__all__ = ["Generator", "GenerationConfig", "GenerationHandle",
           "SamplingParams", "PagePool", "PrefixCache", "SLOClass",
           "sample_tokens", "verify_tokens", "ngram_propose",
           "NgramProposer", "default_prefill_ladder", "QueueFullError",
           "ServerClosedError", "DeadlineExceeded"]

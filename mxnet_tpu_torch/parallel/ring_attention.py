"""The dense attention oracle of ``mxnet_tpu/parallel/ring_attention.py``.

Only :func:`attention_reference` is ported: the ring itself (sequence
parallelism over a mesh axis) waits for distribution (ROADMAP Queue A8 and
A10).
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_reference"]


def attention_reference(q, k, v, causal=False, scale=None):
    """Plain full-materialization attention; q/k/v: (batch, heads, T, d).
    Scores, softmax and the weighted sum stay in the storage dtype, as in
    the JAX package."""
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        T = q.shape[2]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)

"""Draft proposers for speculative decoding.

Counterpart of ``mxnet_tpu/serving/generation/speculative.py``, the same
proposals. Each scheduler iteration proposes k candidate tokens per slot
and verifies them in one batched step on the target model; proposals are
hints, never trusted, so a bad proposer costs verify width, never
correctness. Two modes: the model-free n-gram / prompt-lookup proposer
here (the continuation of the last earlier occurrence of the sequence's
final n-gram), and a small draft model, whose loop the engine owns.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ngram_propose", "NgramProposer"]


def ngram_propose(history, k, ngram=2):
    """Propose ``k`` draft tokens by prompt-lookup: find the most recent
    earlier occurrence of ``history``'s final ``ngram`` tokens and
    propose the ``k`` tokens that followed it.

    ``history``: 1-D int sequence (prompt + tokens generated so far,
    never empty for an admitted slot). Positions past the matched
    continuation — or the whole draft when no earlier occurrence exists
    — are padded with the last history token (a cheap "repeat" guess;
    wrong guesses only cost verify width). Returns (k,) int32.
    """
    k = int(k)
    if k <= 0:
        return np.zeros(0, np.int32)
    h = np.asarray(history, dtype=np.int64).ravel()
    if h.size == 0:
        return np.zeros(k, np.int32)
    out = np.full(k, int(h[-1]), np.int32)
    n = int(ngram)
    if n >= 1 and h.size >= n + 1:
        tail = h[-n:]
        # windows at j cover h[j:j+n]; drop the terminal self-match at
        # j = len-n, keeping only matches with >= 1 continuation token
        windows = np.lib.stride_tricks.sliding_window_view(h, n)[:-1]
        hits = np.nonzero((windows == tail).all(axis=1))[0]
        if hits.size:
            j = int(hits[-1])
            cont = h[j + n:j + n + k]
            out[:cont.size] = cont.astype(np.int32)
    return out


class NgramProposer:
    """Stateless callable wrapper binding (k, ngram) — the engine's
    default proposer object; also handy for tests and tools."""

    __slots__ = ("k", "ngram")

    def __init__(self, k, ngram=2):
        self.k = int(k)
        self.ngram = int(ngram)
        if self.ngram < 1:
            raise ValueError("ngram must be >= 1")

    def __call__(self, history):
        return ngram_propose(history, self.k, self.ngram)

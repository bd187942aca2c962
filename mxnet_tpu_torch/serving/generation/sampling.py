"""Seeded sampling for the decode step: greedy / temperature / top-k.

Counterpart of ``mxnet_tpu/serving/generation/sampling.py``. Sampling runs
inside the fixed-shape decode step, vectorised over slots, every knob a
per-slot tensor: temperature 0.3 beside greedy beside top-k 5 in one
batch, one captured CUDA graph for any mix.

The random stream differs from the JAX package's, whose threefry keys a
captured graph cannot split per slot. Here each slot's key is a pair of
int64 values, (stream, counter): the stream comes from the request's seed,
and a sampled step draws its Gumbel noise from a counter-based hash of
(stream, counter, vocabulary index), then advances the counter by one.
Greedy slots consume nothing. So, as in the JAX package, a request's tokens
are a function of (checkpoint, prompt, SamplingParams) alone, independent
of batch composition, and :func:`verify_tokens` consumes the stream
exactly as sequential decode does. The draws themselves are not JAX's:
seeded output is held to distributional parity with the JAX package, not
to equality.

The hash is integer arithmetic on values below 2^32 held in int64 (every
product stays below 2^63), so the CPU and the card compute the same
uniforms.
"""
from __future__ import annotations

import torch

__all__ = ["SamplingParams", "sample_tokens", "verify_tokens", "seed_key"]

_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B        # < 2^27: a product with a 32-bit value fits int64
_GOLDEN = 0x27D4EB2D    # < 2^30, spreads the vocabulary index


class SamplingParams:
    """Per-request sampling recipe.

    ``temperature`` 0 = greedy (argmax; ``seed``/``top_k`` ignored);
    ``top_k`` 0 = no truncation; ``eos_id`` -1 = never stop on a token;
    ``max_new_tokens`` always bounds generation.
    """

    __slots__ = ("temperature", "top_k", "seed", "eos_id",
                 "max_new_tokens")

    def __init__(self, max_new_tokens=32, temperature=0.0, top_k=0,
                 seed=0, eos_id=-1):
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.eos_id = int(eos_id)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 = off)")


def _hash32(x):
    """A 32-bit integer mixer (a bijection on [0, 2^32)): works on Python
    ints and on int64 tensors alike."""
    x = ((x >> 16) ^ x) * _MIX & _M32
    x = ((x >> 16) ^ x) * _MIX & _M32
    return (x >> 16) ^ x


def seed_key(seed):
    """The (stream, counter) key of a request's seed, as a list of two
    ints: the stream mixes both 32-bit halves of the seed; the counter
    starts at 0."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return [_hash32((seed & _M32) ^ _hash32(seed >> 32)), 0]


def _gumbel(keys, V):
    """Gumbel(0, 1) noise (S, V) in fp32 from each slot's key."""
    base = _hash32(keys[:, 0] ^ _hash32(keys[:, 1] & _M32))    # (S,)
    idx = torch.arange(V, device=keys.device, dtype=torch.int64)
    h = _hash32(base[:, None] ^ (idx * _GOLDEN & _M32)[None, :])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))           # (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, keys, temperature, top_k):
    """Vectorized one-token sampling. ``logits``: (S, V) fp32; ``keys``:
    (S, 2) int64 (stream, counter); ``temperature``: (S,) fp32; ``top_k``:
    (S,) int. Returns ``(tokens (S,) int64, new_keys (S, 2))``.

    Greedy slots (temperature <= 0) take the argmax and keep their key;
    sampled slots draw argmax(logits / t + Gumbel noise) over the top-k
    scores (k = 0 keeps all) and advance their counter. Every branch is
    computed and selected per slot, with no value read back to the host.
    """
    V = logits.shape[-1]
    greedy = temperature <= 0
    safe_t = torch.where(greedy, torch.ones_like(temperature), temperature)
    scaled = logits / safe_t[:, None]
    top_k = top_k.long()
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, V),
                        top_k).clamp(1, V)
    kth = torch.sort(scaled, dim=-1, descending=True).values.gather(
        1, (k_eff - 1)[:, None])
    truncated = scaled.masked_fill(scaled < kth, float("-inf"))
    drawn = torch.argmax(truncated + _gumbel(keys, V), dim=-1)
    tok = torch.where(greedy, torch.argmax(logits, dim=-1), drawn)
    # the counter advances for sampled slots only (no host constant: the
    # function runs inside captured graphs)
    bump = torch.stack([torch.zeros_like(tok), (~greedy).long()], dim=1)
    return tok, keys + bump


def verify_tokens(logits, draft, span, active, keys, temperature, top_k):
    """Lossless accept / sample over one batched-verify result.

    ``logits``: (S, Q, V) fp32, Q = k+1 (position 0 the last committed
    token, 1..k the draft candidates); ``draft``: (S, k); ``span``: (S,)
    positions this slot may emit this step (1..Q); ``active``: (S,) bool;
    ``keys`` / ``temperature`` / ``top_k`` as in :func:`sample_tokens`.

    At each position the target's token is sampled with the rule and the
    key sequential decode would use there; a draft is accepted iff it
    equals that sample, and the first mismatch emits the sample itself.
    Keys advance once per emitted token, so the emitted stream is the one
    sequential decode gives, for greedy and seeded temperature alike.

    Returns ``(tokens (S, Q) int64, n_emit (S,) int64, new_keys)``:
    ``tokens[s, :n_emit[s]]`` are emitted (later positions -1); ``n_emit``
    is 1..span for active slots, 0 for inactive ones.
    """
    S, Q = logits.shape[0], logits.shape[1]
    live = active
    cur = keys
    n_emit = torch.zeros(S, dtype=torch.int64, device=logits.device)
    out = []
    for i in range(Q):
        tok_i, nxt = sample_tokens(logits[:, i], cur, temperature, top_k)
        emit = live & (i < span)
        out.append(torch.where(emit, tok_i, torch.full_like(tok_i, -1)))
        cur = torch.where(emit[:, None], nxt, cur)
        n_emit = n_emit + emit.long()
        if i < Q - 1:
            live = live & emit & (draft[:, i].long() == tok_i)
    new_keys = torch.where(active[:, None], cur, keys)
    return torch.stack(out, dim=1), n_emit, new_keys

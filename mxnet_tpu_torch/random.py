"""Global random state: ``mx.random.seed`` over torch generators.

Counterpart of ``mxnet_tpu/random.py``, which holds one JAX PRNG key and
splits a subkey off it for every random op. Here the random ops draw from
torch generators: on the CPU from one explicit ``torch.Generator``, on a
CUDA card from that card's default generator, which a CUDA graph captures
(each replay draws new numbers). :func:`seed` seeds all of them. The
streams are torch's (Philox on the card), not threefry: a seed gives the
same draws run to run, not the JAX package's draws.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "generator", "get_state", "set_state"]

_cpu = None


def _cpu_generator():
    global _cpu
    if _cpu is None:
        _cpu = torch.Generator().manual_seed(0)
    return _cpu


def seed(seed_state):
    """Seed the host generator and every card's default generator
    (reference: python/mxnet/random.py:433 mx.random.seed)."""
    s = int(seed_state)
    _cpu_generator().manual_seed(s)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(s)


def generator(device):
    """The generator a random op on ``device`` draws from: the host's
    explicit generator, or None (the card's default generator) elsewhere."""
    return _cpu_generator() if torch.device(device).type == "cpu" else None


def get_state():
    """The generators' states (host, then each card's), for a checkpoint
    that resumes the same random sequence."""
    cuda = [torch.cuda.get_rng_state(i)
            for i in range(torch.cuda.device_count())] \
        if torch.cuda.is_available() else []
    return [_cpu_generator().get_state()] + cuda


def set_state(states):
    """Restore what :func:`get_state` returned."""
    _cpu_generator().set_state(states[0])
    for i, s in enumerate(states[1:]):
        torch.cuda.set_rng_state(s, i)

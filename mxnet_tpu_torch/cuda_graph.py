"""Capture of one step as a CUDA graph, shared by the captured training
steps (``parallel.ShardedTrainer``, ``gluon.Trainer.compile_step``), the
generator's decode and verify steps and the serving engine's bucket
programs (one graph per replica and bucket).

A step is a ``body`` over device buffers that live as long as the graph:
the caller copies new inputs into them and the graph's writes land in
them, so a replay reads no host value. The random ops inside draw from the
card's default generator, which ``torch.cuda.graph`` registers with the
graph: each replay draws new numbers.

Python's cyclic garbage collector is off for the capture's duration (and
runs once just before it): a collection in the middle of a capture would
run the destructors of unreachable objects on the capturing thread, and a
dropped ``torch.cuda.CUDAGraph`` (a stopped Generator's steps, say)
destroys its graph there, a call CUDA refuses while the stream captures,
which invalidates the capture.
"""
from __future__ import annotations

import gc
import time

import torch

__all__ = ["capture"]

WARMUP_RUNS = 2   # eager runs on the capture's side stream before a capture


def capture(body, device, write_back=None, reset=None, key=None,
            **graph_kw):
    """(graph, what ``body`` returned in the capture). ``body`` first runs
    ``WARMUP_RUNS`` times on a side stream (cuBLAS, cuDNN and the autograd
    engine settle there) and its results are dropped, so a warm-up must
    not write the live state; ``reset`` runs before each warm-up and once
    after them. In the capture ``write_back(out)`` follows the body: the
    copies of its results into the live buffers. ``graph_kw`` goes to
    ``torch.cuda.graph``: e.g. ``pool`` (a memory pool several graphs
    share, as one serving replica's bucket graphs do) and
    ``capture_error_mode``. Each capture is counted by the instruments
    (``observability.instruments.note_capture``) under ``key``, the
    caller's signature of what the graph bakes in."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_RUNS):
            if reset is not None:
                reset()
            body()
        if reset is not None:
            reset()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=side, **graph_kw):
            out = body()
            if write_back is not None:
                write_back(out)
    finally:
        if collecting:
            gc.enable()
    from .observability import instruments

    instruments.note_capture(key, time.perf_counter() - t0)
    return graph, out

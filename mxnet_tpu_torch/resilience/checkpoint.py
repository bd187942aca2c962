"""Preemption-safe resumable checkpoints.

Counterpart of ``mxnet_tpu/resilience/checkpoint.py``: the *operational*
checkpoint a preempted training job resumes from (``model.save_checkpoint``
writes the portable symbol + params pair). Parameters + optimizer state
(update counts included: the mxtpu_v2 blob) + the random generators' state
+ (epoch, batch, step) position + the flight-recorder ring, under one
checksummed ``MANIFEST.json`` written atomically LAST. A reader trusts a
checkpoint only if the manifest parses and every listed file matches its
sha256 — a process killed mid-write leaves a manifest-less (or
stale-manifest) directory that :func:`load_latest` skips, falling back to
the previous checkpoint instead of resuming from garbage.

Layout (the JAX package's, file for file but the random state)::

    <dir>/ckpt-00000042/          # 42 = global step
        params.ndarray            # save_params format (arg:/aux: keys)
        optimizer.states          # Updater blob (optional)
        rng_torch.npz             # torch generator states (optional)
        iterator.json             # DataIter.get_state() (optional)
        ring.json                 # flight-recorder snapshot at write
        MANIFEST.json             # checksums + position, written last

``params.ndarray``, ``optimizer.states`` and ``iterator.json`` are the
same bytes the JAX package writes for the same values, so either package
resumes from the other's checkpoint. The random state cannot cross: the
JAX package stores a threefry key (``rng.npy``, uint32), the port the
states of torch's generators (``mx.random.get_state()``: the host
generator's, then each card's), one uint8 array each in ``rng_torch.npz``
under keys ``"0"``, ``"1"``, ... Resuming from a checkpoint that holds
only ``rng.npy`` logs one warning and keeps the generators as they stand.

The two newest checkpoints are kept (:func:`prune` runs after every
successful write) so one corrupt latest always has a fallback.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import time

import numpy as np

from ..base import MXNetError
from . import faults

__all__ = ["CheckpointState", "save_resumable", "write_resumable",
           "load_latest", "validate", "list_checkpoints", "prune",
           "restore_rng"]

MANIFEST = "MANIFEST.json"
RNG_FILE = "rng_torch.npz"
JAX_RNG_FILE = "rng.npy"
_CKPT_RE = re.compile(r"^ckpt-(\d+)$")

faults.declare("checkpoint.write",
               doc="before the manifest write: a fault here leaves a "
                   "partial checkpoint that load_latest must skip")


class CheckpointState:
    """One validated checkpoint, loaded back to host values."""

    __slots__ = ("path", "epoch", "batch", "step", "arg_params",
                 "aux_params", "optimizer_states", "rng_state",
                 "iterator_state", "meta")

    def __init__(self, path, epoch, batch, step, arg_params, aux_params,
                 optimizer_states, rng_state, meta, iterator_state=None):
        self.path = path
        self.epoch = epoch
        self.batch = batch          # completed batches within `epoch`
        self.step = step            # completed training steps overall
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.optimizer_states = optimizer_states  # file path or None
        # a list of torch uint8 generator states (the port's file), the
        # JAX package's uint32 key (numpy; it cannot be restored here,
        # see restore_rng), or None
        self.rng_state = rng_state
        # DataIter.get_state() snapshot (shuffle order + cursor) or
        # None — fit(resume=) restores it so the resumed run is
        # bit-exact in data order too
        self.iterator_state = iterator_state
        self.meta = meta


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_resumable(directory, arg_params, aux_params, epoch, batch, step,
                    optimizer_saver=None, rng_state=None, extra=None,
                    iterator_state=None):
    """Write one resumable checkpoint; returns its directory path.

    ``arg_params``/``aux_params``: NDArray dicts (as returned by
    ``module.get_params()``). ``optimizer_saver``: callable taking a
    file path and writing the optimizer-state blob there (e.g.
    ``module.save_optimizer_states``). ``rng_state``: the
    ``mx.random.get_state()`` list. ``iterator_state``: a JSON-safe
    ``DataIter.get_state()`` snapshot (shuffle order + cursor) so the
    resumed run replays the identical data order. The manifest lands
    atomically last; everything before it is invisible to
    :func:`load_latest`.
    """
    from .. import ndarray as nd
    from ..context import cpu
    from ..observability import flight_recorder

    ckpt_dir = os.path.join(directory, "ckpt-%08d" % int(step))
    if os.path.isdir(ckpt_dir):
        # a re-write of the same step starts clean — a half-written
        # older attempt must not leave stray files the manifest blesses
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir, exist_ok=True)
    faults.inject("checkpoint.write")

    files = {}

    def _add(name):
        files[name] = _sha256(os.path.join(ckpt_dir, name))

    blobs = {}
    for kind, params in (("arg", arg_params or {}), ("aux", aux_params or {})):
        for pname, value in params.items():
            blobs["%s:%s" % (kind, pname)] = (
                value.as_in_context(cpu())
                if hasattr(value, "as_in_context")
                else nd.array(np.asarray(value), ctx=cpu()))
    nd.save(os.path.join(ckpt_dir, "params.ndarray"), blobs)
    _add("params.ndarray")

    if optimizer_saver is not None:
        optimizer_saver(os.path.join(ckpt_dir, "optimizer.states"))
        _add("optimizer.states")

    if rng_state is not None:
        with open(os.path.join(ckpt_dir, RNG_FILE), "wb") as sink:
            np.savez(sink, **{str(i): np.asarray(s.cpu(), dtype=np.uint8)
                              for i, s in enumerate(rng_state)})
        _add(RNG_FILE)

    if iterator_state is not None:
        with open(os.path.join(ckpt_dir, "iterator.json"), "w") as sink:
            json.dump(iterator_state, sink)
        _add("iterator.json")

    with open(os.path.join(ckpt_dir, "ring.json"), "w") as sink:
        json.dump(flight_recorder.snapshot(), sink, default=repr)
    _add("ring.json")

    manifest = {
        "version": 1,
        "epoch": int(epoch),
        "batch": int(batch),
        "step": int(step),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "files": files,
    }
    if extra:
        manifest["extra"] = extra
    tmp = os.path.join(ckpt_dir, MANIFEST + ".tmp.%d" % os.getpid())
    with open(tmp, "w") as sink:
        json.dump(manifest, sink, indent=1)
        sink.flush()
        os.fsync(sink.fileno())
    os.replace(tmp, os.path.join(ckpt_dir, MANIFEST))
    prune(directory)
    return ckpt_dir


def save_resumable(module, directory, epoch, batch, step, data_iter=None,
                   iterator_state=None):
    """Checkpoint a bound, initialized module (params + optimizer state
    + random generators + position, plus the data stream position when
    checkpointable) — the one-call form the preemption guard and user
    code share.

    ``iterator_state`` should be the iterator's EPOCH-START
    ``get_state()`` snapshot; resume restores it and fast-forwards
    ``batch`` batches by cursor math (a mid-epoch snapshot would be
    skewed by however far the fit loop's one-batch lookahead, or a
    prefetching pipeline, has read ahead of the trained position).
    ``data_iter`` is a convenience for direct calls where the caller owns
    the iterator's read position: its current ``get_state()`` is captured
    and tagged with ``batch`` so resume fast-forwards only batches
    trained AFTER the capture. Do NOT pass the iterator a running ``fit``
    is consuming (e.g. from a ``batch_end_callback``): fit reads one
    batch ahead, so the resumed run would silently skip that batch —
    ``fit(resume=)``'s own preemption checkpoint is the tool there."""
    from .. import random as _random

    arg_params, aux_params = module.get_params()
    saver = (module.save_optimizer_states
             if getattr(module, "optimizer_initialized", False) else None)
    if iterator_state is None and data_iter is not None:
        getter = getattr(data_iter, "get_state", None)
        if getter is not None:
            snap = getter()  # None when not checkpointable
            if snap is not None:
                iterator_state = {"kind": "exact", "at_batch": int(batch),
                                  "state": snap}
    return write_resumable(directory, arg_params, aux_params,
                           epoch=epoch, batch=batch, step=step,
                           optimizer_saver=saver,
                           rng_state=_random.get_state(),
                           iterator_state=iterator_state)


def list_checkpoints(directory):
    """(step, path) pairs under ``directory``, newest first — validity
    NOT checked (that is :func:`validate`/:func:`load_latest`'s job)."""
    out = []
    try:
        entries = os.listdir(directory)
    except OSError:
        return []
    for name in entries:
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def validate(ckpt_dir):
    """Return the parsed manifest, or raise :class:`MXNetError` naming
    what is wrong (missing/corrupt manifest, missing file, checksum
    mismatch) — the reason :func:`load_latest` logs when it falls back."""
    mpath = os.path.join(ckpt_dir, MANIFEST)
    try:
        with open(mpath) as src:
            manifest = json.load(src)
    except (OSError, ValueError) as err:
        raise MXNetError("checkpoint %s: unreadable manifest (%s)"
                         % (ckpt_dir, err))
    files = manifest.get("files")
    if not isinstance(files, dict) or "params.ndarray" not in files:
        raise MXNetError("checkpoint %s: manifest lists no params"
                         % ckpt_dir)
    for name, want in files.items():
        path = os.path.join(ckpt_dir, name)
        if not os.path.isfile(path):
            raise MXNetError("checkpoint %s: missing file %r"
                             % (ckpt_dir, name))
        got = _sha256(path)
        if got != want:
            raise MXNetError("checkpoint %s: checksum mismatch on %r "
                             "(%s != %s)" % (ckpt_dir, name, got[:12],
                                             want[:12]))
    return manifest


def _load_rng(ckpt_dir, files):
    """The checkpoint's random state as :class:`CheckpointState` holds
    it: the port's generator states, else the JAX package's key."""
    if RNG_FILE in files:
        import torch

        with np.load(os.path.join(ckpt_dir, RNG_FILE)) as npz:
            return [torch.from_numpy(npz[str(i)].copy())
                    for i in range(len(npz.files))]
    if JAX_RNG_FILE in files:
        return np.load(os.path.join(ckpt_dir, JAX_RNG_FILE))
    return None


def load_latest(directory):
    """Newest *valid* checkpoint under ``directory`` as a
    :class:`CheckpointState`, or None. Corrupt/partial checkpoints are
    logged and skipped — the fallback contract preemption relies on."""
    from .. import ndarray as nd

    for _step, ckpt_dir in list_checkpoints(directory):
        try:
            manifest = validate(ckpt_dir)
        except MXNetError as err:
            logging.warning("resilience: skipping invalid checkpoint: %s",
                            err)
            continue
        arg_params, aux_params = {}, {}
        for key, value in nd.load(
                os.path.join(ckpt_dir, "params.ndarray")).items():
            kind, _, pname = key.partition(":")
            (arg_params if kind == "arg" else aux_params)[pname] = value
        files = manifest["files"]
        iterator_state = None
        if "iterator.json" in files:
            with open(os.path.join(ckpt_dir, "iterator.json")) as src:
                iterator_state = json.load(src)
        return CheckpointState(
            ckpt_dir, epoch=int(manifest.get("epoch", 0)),
            batch=int(manifest.get("batch", 0)),
            step=int(manifest.get("step", 0)),
            arg_params=arg_params, aux_params=aux_params,
            optimizer_states=(os.path.join(ckpt_dir, "optimizer.states")
                              if "optimizer.states" in files else None),
            rng_state=_load_rng(ckpt_dir, files),
            iterator_state=iterator_state, meta=manifest)
    return None


def restore_rng(state, logger=logging):
    """Put a :class:`CheckpointState`'s ``rng_state`` back into
    ``mx.random``. The JAX package's threefry key has no torch
    counterpart: it is reported with one warning and the generators keep
    their state. Card states beyond this process's cards are left out."""
    if state is None:
        return
    if isinstance(state, np.ndarray):
        logger.warning(
            "resume: the checkpoint holds the JAX package's random key "
            "(%s), which torch's generators cannot take; the random "
            "stream does not carry across packages, and the generators "
            "keep their current state", JAX_RNG_FILE)
        return
    import torch

    from .. import random as _random

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    _random.set_state(list(state[:1 + cards]))


def prune(directory, keep=2):
    """Keep the ``keep`` newest *valid* checkpoints; delete everything
    else — including invalid (crashed-write) directories, which must
    never count toward the quota: two crashed higher-step writes would
    otherwise evict every valid checkpoint, the just-written one
    included. Single-writer contract (fit's preemption guard / explicit
    save_resumable calls), so an invalid directory is always a dead
    leftover, never a concurrent write in progress."""
    kept = 0
    for _step, ckpt_dir in list_checkpoints(directory):
        ok = False
        if kept < keep:
            try:
                validate(ckpt_dir)
                ok = True
            except MXNetError:
                ok = False
        if ok:
            kept += 1
        else:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

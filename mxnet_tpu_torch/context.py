"""Device context — the user-facing placement handle.

Counterpart of ``mxnet_tpu/context.py``: ``Context``, ``cpu()``, ``gpu()``,
``tpu()``, ``cpu_pinned()``, ``current_context()`` and ``num_gpus()``, with
the reference's device-type codes and its ``with`` scope on a thread-local
stack. A context resolves onto a ``torch.device`` (``Context.device``):
``cpu``/``cpu_pinned``/``cpu_shared`` onto the host, ``gpu(i)`` onto CUDA
card ``i``; ``tpu`` has no device in this package and raises.

Where arrays go when the caller names no device (:func:`as_device` of None):
the innermost ``with`` scope, and outside any scope the card. Outside a
scope the port's entry points do not fall back to the CPU: they raise where
there is no card.
"""
from __future__ import annotations

import re
import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
           "num_gpus", "default_device", "as_device"]

_thread_state = threading.local()

_CPU_TYPES = ("cpu", "cpu_pinned", "cpu_shared")


class Context:
    """Device context; a ``with`` scope sets where arrays are created."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared",
                   6: "tpu"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = device_id

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    @property
    def _key(self):
        return (self.device_typeid, self.device_id)

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, Context) and self._key == other._key

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        _ctx_stack().append(self)
        return self

    def __exit__(self, *exc):
        _ctx_stack().pop()

    @property
    def device(self):
        """The ``torch.device`` this context resolves to."""
        if self.device_type in _CPU_TYPES:
            return torch.device("cpu")
        if self.device_type == "gpu":
            return torch.device("cuda", int(self.device_id))
        raise MXNetError("%s: the PyTorch port (mxnet_tpu_torch) has no TPU "
                         "device; use mx.gpu(i) or mx.cpu()" % self)

    @staticmethod
    def from_device(dev):
        """The context of a ``torch.device`` (cuda:i -> gpu(i))."""
        dev = torch.device(dev)
        if dev.type == "cuda":
            return Context("gpu", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        if dev.type == "cpu":
            return Context("cpu", 0)
        raise MXNetError("no context for device %s" % dev)


def cpu(device_id=0):
    """The host CPU."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA card ``device_id``."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """A TPU context: it exists for API parity, and resolving it onto a
    device raises (this package runs on CUDA cards and the CPU)."""
    return Context("tpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def num_gpus():
    """Number of CUDA cards visible."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _ctx_stack():
    if not hasattr(_thread_state, "ctx_stack"):
        _thread_state.ctx_stack = []
    return _thread_state.ctx_stack


def current_context():
    """The innermost ``with Context`` scope, else cpu(0) (the reference's
    answer; array creation outside a scope goes to the card all the same,
    see :func:`as_device`)."""
    stack = _ctx_stack()
    return stack[-1] if stack else Context("cpu", 0)


def default_device():
    """The current CUDA device; raises when CUDA is absent (there is no
    silent CPU fallback: pass ``mx.cpu()`` or open ``with mx.cpu():`` to
    run on the host)."""
    if not torch.cuda.is_available():
        raise MXNetError("CUDA is not available; pass mx.cpu() (or open "
                         "'with mx.cpu():') to run on the host")
    return torch.device("cuda", torch.cuda.current_device())


_CTX_STR = re.compile(r"^(cpu|gpu|tpu|cpu_pinned|cpu_shared)\((\d+)\)$")


def as_device(dev):
    """``torch.device`` from a ``Context``, a ``torch.device``, a string
    (``"cuda:0"``, or a context's own ``"gpu(0)"``) or None: the innermost
    ``with`` scope, else the card."""
    if dev is None:
        stack = _ctx_stack()
        return stack[-1].device if stack else default_device()
    if isinstance(dev, Context):
        return dev.device
    if isinstance(dev, str):
        m = _CTX_STR.match(dev)
        if m:
            return Context(m.group(1), int(m.group(2))).device
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

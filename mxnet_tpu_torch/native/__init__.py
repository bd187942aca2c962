"""Native (C++) readers, built on demand with the system ``g++`` and
loaded over ctypes: the RecordIO framing (``recordio.cc``) and the
threaded record prefetcher (``prefetch.cc``).

Counterpart of ``mxnet_tpu/native/__init__.py``, with its own copies of
the sources. A library is compiled at first use into
``mxnet_tpu_torch/_build/native/`` (listed in ``.gitignore``), in a
directory keyed by a hash of the source and the flags; nothing is built
at import and nothing is written beside the sources. Without a compiler
:func:`load` returns None and the callers fall back to their pure-Python
readers, which produce the same bytes. :func:`built` says which libraries
loaded, so a run can show that its readers were the native ones.
"""
import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["load", "built", "recordio_lib", "prefetch_lib", "BUILD_DIR"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
_LOCK = threading.Lock()
_LIBS = {}  # guarded-by: _LOCK

_FLAGS = ("-O2", "-std=c++14", "-fPIC", "-shared")
# per-library extra compile flags
_EXTRA = {"prefetch": ("-pthread",)}


def _build(name):
    src = os.path.join(_HERE, name + ".cc")
    flags = _FLAGS + _EXTRA.get(name, ())
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + "\0".join(flags).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, "%s-%s" % (name, digest), "lib%s.so" % name)
    if not os.path.isfile(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = "%s.%d.tmp" % (so, os.getpid())
        subprocess.run(["g++", *flags, src, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so)  # atomic against a racing build
    return so


def load(name):
    """Load (building if needed) the named native library; None if the
    toolchain is unavailable."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        try:
            lib = ctypes.CDLL(_build(name))
        except (OSError, subprocess.CalledProcessError, FileNotFoundError):
            lib = None
        _LIBS[name] = lib
        return lib


def built():
    """{name: path of the loaded library, or None} for each library a
    reader asked for so far."""
    with _LOCK:
        return {k: (v._name if v is not None else None)
                for k, v in _LIBS.items()}


def recordio_lib():
    lib = load("recordio")
    if lib is not None and not getattr(lib, "_rio_typed", False):
        LL = ctypes.c_longlong
        P = ctypes.c_void_p
        lib.rio_open.restype = P
        lib.rio_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.rio_close.argtypes = [P]
        lib.rio_tell.restype = LL
        lib.rio_tell.argtypes = [P]
        lib.rio_seek.restype = ctypes.c_int
        lib.rio_seek.argtypes = [P, LL]
        lib.rio_scan.restype = LL
        lib.rio_scan.argtypes = [P, ctypes.POINTER(LL), LL]
        lib.rio_read.restype = LL
        lib.rio_read.argtypes = [P, ctypes.c_char_p, LL]
        lib.rio_read_at.restype = LL
        lib.rio_read_at.argtypes = [P, LL, ctypes.c_char_p, LL]
        lib.rio_write.restype = LL
        lib.rio_write.argtypes = [P, ctypes.c_char_p, LL, LL]
        lib.rio_flush.restype = ctypes.c_int
        lib.rio_flush.argtypes = [P]
        lib._rio_typed = True
    return lib


def prefetch_lib():
    lib = load("prefetch")
    if lib is not None and not getattr(lib, "_rpf_typed", False):
        LL = ctypes.c_longlong
        P = ctypes.c_void_p
        lib.rpf_open.restype = P
        lib.rpf_open.argtypes = [ctypes.c_char_p, LL]
        lib.rpf_next.restype = LL
        lib.rpf_next.argtypes = [P, ctypes.c_char_p, LL]
        lib.rpf_peek_size.restype = LL
        lib.rpf_peek_size.argtypes = [P]
        lib.rpf_reset.argtypes = [P]
        lib.rpf_close.argtypes = [P]
        lib._rpf_typed = True
    return lib

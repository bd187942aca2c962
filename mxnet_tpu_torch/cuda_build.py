"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``mxnet_tpu_torch/csrc/<name>.cu`` has a plain C
interface. At first use it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``mxnet_tpu_torch/_build/`` (listed in ``.gitignore``),
in a directory keyed by a hash of the source and the flags, and loaded with
``ctypes``. Nothing is compiled at import: the CPU tests import every
module and never build. A missing ``nvcc`` or a failed build raises.
:func:`build_all` compiles several sources at once, one ``nvcc`` process
each, all started together.

The per-kernel launch counters live here too: each wrapper adds one where
it launches its kernel, so a run can show that its path went through it.
A wrapper whose kernel has several compiled tiles names the tile it
launched (``variant``): :func:`variant_counts` counts launches per (kernel,
tile) and :func:`last_variant` is the tile of a kernel's latest launch,
the wrapper's launch record.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .base import MXNetError

__all__ = ["kernel_names", "build_all", "load_library", "build_info",
           "count_launch", "launch_counts", "reset_launch_counts",
           "variant_counts", "last_variant", "SOURCE_DIR", "BUILD_DIR"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}    # guarded-by: _lock
_info = {}    # name -> {"seconds", "path", "log", "built"}  # guarded-by: _lock
# (name, variant) -> launches; variant None for a kernel of one form
_launches = collections.Counter()  # guarded-by: _lock
_last_variant = {}  # name -> variant of its latest launch  # guarded-by: _lock


def kernel_names():
    """The kernel sources in ``csrc/``, by name."""
    return sorted(f[:-3] for f in os.listdir(SOURCE_DIR) if f.endswith(".cu"))


def _nvcc():
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (looked in $CUDA_HOME/bin, "
                         "/usr/local/cuda/bin and PATH): the CUDA kernels "
                         "are built from source at first use")
    return found


def _so_path(name):
    src_path = os.path.join(SOURCE_DIR, name + ".cu")
    with open(src_path, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(
        src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src_path, os.path.join(BUILD_DIR, "%s-%s" % (name, digest),
                                  "lib%s.so" % name)


def build_all(names):
    """Build and load every named kernel not loaded yet: one nvcc process
    per source, all running at once. Returns {name: ctypes handle}."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            src_path, so_path = _so_path(name)
            if os.path.isfile(so_path):
                procs[name] = (so_path, None, None, None)
                continue
            os.makedirs(os.path.dirname(so_path), exist_ok=True)
            tmp = "%s.%d.tmp" % (so_path, os.getpid())
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            procs[name] = (so_path, tmp, cmd, proc)
        for name, (so_path, tmp, cmd, proc) in procs.items():
            log = ""
            if proc is not None:
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    raise MXNetError("nvcc failed (%d) building %s:\n%s"
                                     % (proc.returncode, cmd[-1], log))
                with open(os.path.join(os.path.dirname(so_path),
                                       "build.log"), "w") as f:
                    f.write(" ".join(cmd) + "\n" + log)
                os.replace(tmp, so_path)  # atomic against a racing build
            _libs[name] = ctypes.CDLL(so_path)
            _info[name] = {"seconds": time.perf_counter() - t0,
                           "path": so_path, "log": log,
                           "built": proc is not None}
        loaded = [(n, _info[n]["seconds"], _info[n]["built"]) for n in todo]
        libs = {n: _libs[n] for n in names}
    from .observability import instruments

    for name, seconds, built in loaded:
        instruments.note_kernel_build(name, seconds, built)
    return libs


def load_library(name):
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    return build_all([name])[name]


def build_info(name):
    """Build facts of a loaded kernel library (seconds, path, nvcc log)."""
    with _lock:
        return dict(_info.get(name, {}))


def count_launch(name, variant=None):
    """One launch of kernel ``name``; ``variant`` names its tile (such as
    128 or 64) where the kernel has several."""
    with _lock:
        _launches[name, variant] += 1
        if variant is not None:
            _last_variant[name] = variant


def launch_counts():
    """{kernel: launches} since the last reset, every variant summed."""
    out = collections.Counter()
    with _lock:
        for (name, _), n in _launches.items():
            out[name] += n
    return dict(out)


def variant_counts():
    """{(kernel, variant as a string): launches} of the kernels with
    several variants, since the last reset."""
    with _lock:
        return {(name, str(v)): n for (name, v), n in _launches.items()
                if v is not None}


def last_variant(name):
    """The variant of kernel ``name``'s latest launch as a string, or
    None."""
    with _lock:
        v = _last_variant.get(name)
    return None if v is None else str(v)


def reset_launch_counts():
    with _lock:
        _launches.clear()
        _last_variant.clear()

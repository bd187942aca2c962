"""ctypes bindings to NVRTC and the CUDA driver, for ``mx.rtc``.

No counterpart in ``mxnet_tpu`` (a TPU host has no NVRTC). ``mx.rtc``
compiles user CUDA C at run time, as the reference MXNet does in
``src/common/rtc.cc``: NVRTC turns the source into a cubin for
``sm_90a``, and the driver API loads it into the device's primary context
and launches its kernels on torch's current stream.

Both libraries are loaded at first use, never at import: the CPU tests
import every module. A library that cannot be found raises
:class:`~.base.MXNetError` naming where it was looked for, and every
``nvrtcResult`` and ``CUresult`` is checked.

Where the libraries are looked for:

- ``libnvrtc.so*`` beside the ``nvcc`` that :mod:`.cuda_build` uses
  (``<toolkit>/lib64``), then ``$CUDA_HOME/lib64``, then the copy a CUDA
  build of torch may carry (``nvidia/cuda_nvrtc/lib`` on ``sys.path``),
  then the loader's search path. Its ``libnvrtc-builtins.so*`` is loaded
  first from the same directory, with ``RTLD_GLOBAL``, so that NVRTC
  resolves it wherever it came from.
- ``libcuda.so.1``, the driver, through the loader's search path.
"""
from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import glob
import os
import sys
import threading

from .base import MXNetError

__all__ = ["ARCH", "compile_cuda", "compile_count", "load_module",
           "get_function", "set_max_dynamic_shared", "launch",
           "device_context", "include_dirs"]

#: the compile target: Hopper with its arch-specific features
ARCH = "sm_90a"
#: dynamic shared memory above this needs the function attribute set first
DEFAULT_SHARED_BYTES = 48 * 1024
_MAX_DYNAMIC_SHARED_ATTR = 8   # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES

_lock = threading.Lock()
_nvrtc = None        # guarded-by: _lock
_driver = None       # guarded-by: _lock
_primary = {}        # device ordinal -> retained primary CUcontext  # guarded-by: _lock
_compiles = 0        # guarded-by: _lock


# ------------------------------------------------------------ finding them

def _toolkit_dirs():
    """CUDA toolkit roots, best first: the one whose nvcc builds the
    port's kernels, then $CUDA_HOME, then the usual install path."""
    roots = []
    try:
        from .cuda_build import _nvcc

        roots.append(os.path.dirname(os.path.dirname(_nvcc())))
    except MXNetError:
        pass
    if os.environ.get("CUDA_HOME"):
        roots.append(os.environ["CUDA_HOME"])
    roots.append("/usr/local/cuda")
    out = []
    for r in roots:
        r = os.path.realpath(r)
        if r not in out:
            out.append(r)
    return out


def include_dirs():
    """The toolkit's include directories that exist (``cuda_fp16.h``,
    ``cuda_bf16.h``)."""
    return [os.path.join(r, "include") for r in _toolkit_dirs()
            if os.path.isdir(os.path.join(r, "include"))]


def _nvrtc_dirs():
    dirs = [os.path.join(root, "lib64") for root in _toolkit_dirs()]
    dirs += [os.path.join(p or ".", "nvidia", "cuda_nvrtc", "lib")
             for p in sys.path]
    return [d for d in dict.fromkeys(dirs) if os.path.isdir(d)]


def _load_nvrtc():
    tried = []
    for d in _nvrtc_dirs():
        for path in sorted(glob.glob(os.path.join(d, "libnvrtc.so*"))):
            for b in sorted(glob.glob(os.path.join(d,
                                                   "libnvrtc-builtins*.so*"))):
                try:
                    ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
                    break
                except OSError:
                    continue
            try:
                return _declare_nvrtc(ctypes.CDLL(path))
            except OSError as e:
                tried.append("%s (%s)" % (path, e))
    found = ctypes.util.find_library("nvrtc")
    if found:
        try:
            return _declare_nvrtc(ctypes.CDLL(found))
        except OSError as e:
            tried.append("%s (%s)" % (found, e))
    raise MXNetError(
        "NVRTC (libnvrtc.so) not found: looked in %s and the loader's "
        "search path%s. mx.rtc.CudaModule compiles CUDA C at run time and "
        "needs the CUDA toolkit's NVRTC"
        % (", ".join(_nvrtc_dirs()) or "no existing toolkit or torch "
           "NVRTC directory",
           "; failed to load " + "; ".join(tried) if tried else ""))


def _load_driver():
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise MXNetError("the CUDA driver (libcuda.so.1) could not be "
                         "loaded: %s. mx.rtc launches need a CUDA card"
                         % e)
    return _declare_driver(lib)


def _declare(lib, name, restype, *argtypes):
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = list(argtypes)


def _declare_nvrtc(lib):
    P, c_int, c_char_p = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    size_p = ctypes.POINTER(ctypes.c_size_t)
    _declare(lib, "nvrtcGetErrorString", c_char_p, c_int)
    _declare(lib, "nvrtcCreateProgram", c_int, ctypes.POINTER(P), c_char_p,
             c_char_p, c_int, ctypes.POINTER(c_char_p),
             ctypes.POINTER(c_char_p))
    _declare(lib, "nvrtcDestroyProgram", c_int, ctypes.POINTER(P))
    _declare(lib, "nvrtcAddNameExpression", c_int, P, c_char_p)
    _declare(lib, "nvrtcCompileProgram", c_int, P, c_int,
             ctypes.POINTER(c_char_p))
    _declare(lib, "nvrtcGetProgramLogSize", c_int, P, size_p)
    _declare(lib, "nvrtcGetProgramLog", c_int, P, c_char_p)
    _declare(lib, "nvrtcGetCUBINSize", c_int, P, size_p)
    _declare(lib, "nvrtcGetCUBIN", c_int, P, c_char_p)
    _declare(lib, "nvrtcGetLoweredName", c_int, P, c_char_p,
             ctypes.POINTER(c_char_p))
    return lib


def _declare_driver(lib):
    P, c_int, c_uint = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    _declare(lib, "cuInit", c_int, c_uint)
    _declare(lib, "cuGetErrorString", c_int, c_int,
             ctypes.POINTER(ctypes.c_char_p))
    _declare(lib, "cuDeviceGet", c_int, ctypes.POINTER(c_int), c_int)
    _declare(lib, "cuDevicePrimaryCtxRetain", c_int, ctypes.POINTER(P),
             c_int)
    _declare(lib, "cuCtxGetCurrent", c_int, ctypes.POINTER(P))
    _declare(lib, "cuCtxSetCurrent", c_int, P)
    _declare(lib, "cuCtxGetDevice", c_int, ctypes.POINTER(c_int))
    _declare(lib, "cuModuleLoadData", c_int, ctypes.POINTER(P), P)
    _declare(lib, "cuModuleGetFunction", c_int, ctypes.POINTER(P), P,
             ctypes.c_char_p)
    _declare(lib, "cuFuncSetAttribute", c_int, P, c_int, c_int)
    _declare(lib, "cuLaunchKernel", c_int, P, c_uint, c_uint, c_uint,
             c_uint, c_uint, c_uint, c_uint, P, ctypes.POINTER(P),
             ctypes.POINTER(P))
    _check_cu(lib, lib.cuInit(0), "cuInit")
    return lib


def _nvrtc_lib():
    global _nvrtc
    with _lock:
        if _nvrtc is None:
            _nvrtc = _load_nvrtc()
        return _nvrtc


def _driver_lib():
    global _driver
    with _lock:
        if _driver is None:
            _driver = _load_driver()
        return _driver


# ---------------------------------------------------------------- checks

def _check_cu(lib, res, what):
    if res != 0:
        msg = ctypes.c_char_p()
        if lib.cuGetErrorString(res, ctypes.byref(msg)) != 0 or not msg.value:
            text = "unknown error"
        else:
            text = msg.value.decode(errors="replace")
        raise MXNetError("%s failed: CUresult %d (%s)" % (what, res, text))


def _check_rtc(lib, res, what, log=""):
    if res != 0:
        text = (lib.nvrtcGetErrorString(res) or b"unknown").decode(
            errors="replace")
        raise MXNetError("%s failed: nvrtcResult %d (%s)%s"
                         % (what, res, text,
                            "\n" + log if log else ""))


# --------------------------------------------------------------- compile

def _program_log(lib, prog):
    size = ctypes.c_size_t()
    if lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)) != 0:
        return ""
    buf = ctypes.create_string_buffer(size.value)
    if lib.nvrtcGetProgramLog(prog, buf) != 0:
        return ""
    return buf.value.decode(errors="replace")


def compile_cuda(source, options=(), name_expressions=(), name="rtc.cu"):
    """Compile CUDA C ``source`` for :data:`ARCH` into a cubin.

    ``name_expressions`` (``"axpy<float>"``) are registered before the
    compile so that templates are instantiated; returns ``(cubin bytes,
    {expression: lowered name})``. A failed compile raises with the
    compile log."""
    global _compiles
    lib = _nvrtc_lib()
    prog = ctypes.c_void_p()
    _check_rtc(lib, lib.nvrtcCreateProgram(ctypes.byref(prog),
                                           source.encode(), name.encode(),
                                           0, None, None),
               "nvrtcCreateProgram")
    try:
        for expr in name_expressions:
            _check_rtc(lib, lib.nvrtcAddNameExpression(prog, expr.encode()),
                       "nvrtcAddNameExpression(%r)" % expr)
        opts = ["--gpu-architecture=%s" % ARCH]
        opts += ["--include-path=%s" % d for d in include_dirs()]
        opts += list(options)
        c_opts = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = lib.nvrtcCompileProgram(prog, len(opts), c_opts)
        log = _program_log(lib, prog)
        _check_rtc(lib, res, "NVRTC compile of %s with %s" % (name, opts),
                   log)
        size = ctypes.c_size_t()
        _check_rtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                   "nvrtcGetCUBINSize")
        buf = ctypes.create_string_buffer(size.value)
        _check_rtc(lib, lib.nvrtcGetCUBIN(prog, buf), "nvrtcGetCUBIN")
        lowered = {}
        for expr in name_expressions:
            out = ctypes.c_char_p()
            _check_rtc(lib, lib.nvrtcGetLoweredName(prog, expr.encode(),
                                                    ctypes.byref(out)),
                       "nvrtcGetLoweredName(%r)" % expr)
            lowered[expr] = out.value.decode()
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
    with _lock:
        _compiles += 1
    return buf.raw, lowered


def compile_count():
    """How many NVRTC compiles this process has run."""
    with _lock:
        return _compiles


# ---------------------------------------------------------------- driver

@contextlib.contextmanager
def device_context(device_index):
    """Run the body with the device's primary context current in this
    thread. Where no context was current, the primary context is retained
    and stays current after the body (torch's runtime makes it current
    only in threads where it has worked on that device). Where another
    device's context was current, it is current again after the body, so
    torch's later work in this thread stays on its device."""
    lib = _driver_lib()
    cur = ctypes.c_void_p()
    _check_cu(lib, lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    want = ctypes.c_int()
    _check_cu(lib, lib.cuDeviceGet(ctypes.byref(want), device_index),
              "cuDeviceGet")
    if cur.value:
        dev = ctypes.c_int()
        _check_cu(lib, lib.cuCtxGetDevice(ctypes.byref(dev)),
                  "cuCtxGetDevice")
        if dev.value == want.value:
            yield
            return
    with _lock:
        ctx = _primary.get(device_index)
        if ctx is None:
            ctx = ctypes.c_void_p()
            _check_cu(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                        want),
                      "cuDevicePrimaryCtxRetain")
            _primary[device_index] = ctx
    _check_cu(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    try:
        yield
    finally:
        if cur.value:
            _check_cu(lib, lib.cuCtxSetCurrent(cur), "cuCtxSetCurrent")


def load_module(cubin):
    """Load a cubin into the current context; returns the CUmodule."""
    lib = _driver_lib()
    mod = ctypes.c_void_p()
    image = ctypes.create_string_buffer(cubin, len(cubin))
    _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(mod), image),
              "cuModuleLoadData")
    return mod


def get_function(module, name):
    """The CUfunction ``name`` (a lowered or ``extern "C"`` name)."""
    lib = _driver_lib()
    fn = ctypes.c_void_p()
    _check_cu(lib, lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                           name.encode()),
              "cuModuleGetFunction(%r)" % name)
    return fn


def set_max_dynamic_shared(function, nbytes):
    """Allow ``nbytes`` of dynamic shared memory for ``function`` (needed
    above 48 KiB; an H100 block may have up to 227 KiB)."""
    lib = _driver_lib()
    _check_cu(lib, lib.cuFuncSetAttribute(function, _MAX_DYNAMIC_SHARED_ATTR,
                                          int(nbytes)),
              "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES, %d)"
              % nbytes)


def launch(function, grid, block, shared_mem, stream, args):
    """``cuLaunchKernel`` on ``stream`` (an int handle). ``args`` are
    ctypes objects, one per kernel parameter: the caller keeps them and
    the memory their pointers name alive until the launch is enqueued."""
    lib = _driver_lib()
    params = (ctypes.c_void_p * max(1, len(args)))(
        *[ctypes.cast(ctypes.pointer(a), ctypes.c_void_p) for a in args])
    _check_cu(lib, lib.cuLaunchKernel(function, grid[0], grid[1], grid[2],
                                      block[0], block[1], block[2],
                                      int(shared_mem),
                                      ctypes.c_void_p(stream or None),
                                      params, None),
              "cuLaunchKernel(grid=%s, block=%s, shared_mem=%d)"
              % (tuple(grid), tuple(block), shared_mem))

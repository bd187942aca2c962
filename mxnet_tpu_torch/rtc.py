"""Runtime CUDA kernels: ``mx.rtc.CudaModule`` over NVRTC.

Counterpart of ``mxnet_tpu/rtc.py``, whose ``PallasModule`` takes Pallas
source because a TPU host has no NVRTC. On the card this is the reference
MXNet API again (python/mxnet/rtc.py ``CudaModule``/``CudaKernel``,
src/common/rtc.cc): the user hands over CUDA C, the module compiles it
once with NVRTC for ``sm_90a`` into a cubin, and each kernel launches on
``NDArray``s in place, on torch's current stream::

    source = r'''
    extern "C" __global__ void axpy(const float *x, float *y, float alpha,
                                    int n) {
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i < n) y[i] += alpha * x[i];
    }'''
    module = mx.rtc.CudaModule(source)
    func = module.get_kernel(
        "axpy", "const float *x, float *y, float alpha, int n")
    func.launch([x, y, 3.0, 10], mx.gpu(0), (1, 1, 1), (32, 1, 1))

Signature grammar (the JAX package's, kept): comma-separated parameters,
each ``[const] <type> [*] <name>``. A pointer is a tensor (``const`` an
input, otherwise an output written in place) and must be passed an
``NDArray``; anything else is a scalar, cast to its declared type as
``np.asarray(value, dtype).item()`` casts (an ``int32`` truncates 4.9 to
4). The type words are those of the JAX package: float/float32,
double/float64, half/float16, bfloat16, int/int32, int8, uint8,
int64/long, bool.

Templated kernels are named in ``exports`` (``"axpy<float>"``); their
lowered names come from NVRTC. Any other name is looked up as it is, so
a kernel without ``exports`` is declared ``extern "C"``.

There is no CPU path and no fallback: a missing NVRTC, a CPU context, a
compile error and a launch error each raise :class:`~.base.MXNetError`.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import cuda_build, nvrtc
from .base import MXNetError, torch_dtype
from .ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule"]

# C-style type word -> canonical dtype name (the JAX package's words)
_DTYPES = {
    "float": "float32", "float32": "float32",
    "double": "float64", "float64": "float64",
    "half": "float16", "float16": "float16",
    "bfloat16": "bfloat16",
    "int": "int32", "int32": "int32",
    "int8": "int8", "uint8": "uint8",
    "int64": "int64", "long": "int64",
    "bool": "bool",
}

# scalars as the declared C type (half and bfloat16: see _pack_scalar)
_C_SCALARS = {
    "float32": ctypes.c_float, "float64": ctypes.c_double,
    "int32": ctypes.c_int32, "int64": ctypes.c_int64,
    "int8": ctypes.c_int8, "uint8": ctypes.c_uint8, "bool": ctypes.c_bool,
}


def _parse_signature(signature):
    """Parse the reference's signature grammar into parameter specs.

    Returns a list of (name, dtype name, is_tensor, is_input).
    """
    params = []
    for raw in signature.split(","):
        tokens = raw.replace("*", " * ").split()
        if not tokens:
            continue
        is_const = tokens[0] == "const"
        if is_const:
            tokens = tokens[1:]
        if not tokens:
            raise MXNetError("malformed signature fragment %r" % raw)
        type_word = tokens[0]
        rest = tokens[1:]
        is_tensor = "*" in rest
        rest = [t for t in rest if t != "*"]
        name = rest[-1] if rest else None
        if type_word not in _DTYPES:
            raise MXNetError(
                "unsupported type %r in signature (supported: %s)"
                % (type_word, ", ".join(sorted(_DTYPES))))
        if not name:
            raise MXNetError("parameter in %r has no name" % raw)
        params.append((name, _DTYPES[type_word], is_tensor,
                       is_const or not is_tensor))
    return params


def _pack_scalar(value, dtype):
    """``value`` as the ctypes object of C type ``dtype``, cast as
    ``np.asarray(value, dtype).item()`` casts; half and bfloat16 as their
    16-bit patterns, rounded to nearest even."""
    if dtype == "bfloat16":
        import torch

        bits = torch.tensor(float(value), dtype=torch.float64) \
            .to(torch.bfloat16).view(torch.int16).item()
        return ctypes.c_uint16(bits & 0xFFFF)
    if dtype == "float16":
        return ctypes.c_uint16(int(np.asarray(value, np.float16)
                                   .view(np.uint16)))
    return _C_SCALARS[dtype](np.asarray(value, dtype=dtype).item())


def _dims(dims, what):
    if dims is None:
        return (1, 1, 1)
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise MXNetError("%s must be 1 to 3 positive ints, got %r"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


def _launch_device(ctx):
    import torch

    dev = torch.device(ctx) if ctx is not None else None
    if dev is None or dev.type != "cuda":
        raise MXNetError("rtc kernels launch on a GPU context (mx.gpu(i)); "
                         "got %s" % (ctx,))
    if not torch.cuda.is_available():
        raise MXNetError("rtc launch on %s: CUDA is not available" % dev)
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


class CudaModule:
    """CUDA C compiled at run time (reference: rtc.py CudaModule).

    Parameters
    ----------
    source : str
        CUDA C source holding one or more ``__global__`` kernels.
    options : tuple of str
        Extra NVRTC options (``"-DWIDTH=4"``, ``"--use_fast_math"``),
        passed after ``--gpu-architecture=sm_90a`` and the toolkit's
        include path.
    exports : tuple of str
        Name expressions of templated kernels to instantiate
        (``"axpy<float>"``); ``get_kernel`` accepts them as names.
    """

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.options = tuple(options)
        self.exports = tuple(exports)
        self._cubin, self._lowered = nvrtc.compile_cuda(
            source, self.options, self.exports)
        self._lock = threading.Lock()
        self._loaded = {}   # device ordinal -> CUmodule  # guarded-by: _lock

    def get_kernel(self, name, signature):
        """Bind kernel ``name`` (an ``extern "C"`` name or an export) to
        its launch signature (reference: rtc.py get_kernel)."""
        lowered = self._lowered.get(name, name)
        # each function's code is its own ELF section, ".text.<name>"
        if b".text." + lowered.encode() + b"\0" not in self._cubin:
            raise MXNetError(
                "kernel %r is not in the module (exports: %s); a kernel not "
                "named in exports must be declared extern \"C\""
                % (name, list(self.exports)))
        return CudaKernel(self, name, lowered, _parse_signature(signature))

    def _module_on(self, device_index):
        """The cubin loaded on a device, at its first launch there."""
        with self._lock:
            mod = self._loaded.get(device_index)
            if mod is None:
                mod = nvrtc.load_module(self._cubin)
                self._loaded[device_index] = mod
            return mod


class CudaKernel:
    """A launchable kernel of a :class:`CudaModule` (reference: rtc.py
    CudaKernel)."""

    def __init__(self, module, name, lowered_name, params):
        self._module = module
        self.name = name
        self._lowered = lowered_name
        self._params = params
        self._lock = threading.Lock()
        self._fns = {}      # device ordinal -> CUfunction  # guarded-by: _lock
        self._smem = {}     # device ordinal -> shared bytes allowed  # guarded-by: _lock

    def _function(self, device_index, shared_mem):
        with self._lock:
            fn = self._fns.get(device_index)
            if fn is None:
                fn = nvrtc.get_function(self._module._module_on(device_index),
                                        self._lowered)
                self._fns[device_index] = fn
            if shared_mem > max(self._smem.get(device_index, 0),
                                nvrtc.DEFAULT_SHARED_BYTES):
                nvrtc.set_max_dynamic_shared(fn, shared_mem)
                self._smem[device_index] = shared_mem
            return fn

    def launch(self, args, ctx, grid_dims, block_dims=None, shared_mem=0):
        """Launch over ``grid_dims`` blocks of ``block_dims`` threads with
        ``shared_mem`` bytes of dynamic shared memory, on torch's current
        stream of the ``ctx`` card (reference: rtc.py launch).

        Outputs are written in place: the kernel gets the output array's
        own storage and sees its current contents. An output that is not
        contiguous, of another dtype or on another device is launched
        into a contiguous copy of its contents, copied back after the
        launch. An input of another dtype, layout or device is cast or
        copied first. Returns the output arrays.

        The write bypasses autograd: do not launch into an array that a
        recorded graph saved for its backward.
        """
        import torch

        if len(args) != len(self._params):
            raise MXNetError("kernel %s takes %d arguments, got %d"
                             % (self.name, len(self._params), len(args)))
        for arg, (pname, _dtype, is_tensor, _in) in zip(args, self._params):
            if is_tensor and not isinstance(arg, NDArray):
                raise MXNetError("argument %r of kernel %s must be an "
                                 "NDArray, got %s"
                                 % (pname, self.name, type(arg).__name__))
        dev = _launch_device(ctx)
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        shared_mem = int(shared_mem)
        stream = torch.cuda.current_stream(dev)
        keep, c_args, outs, writeback = [], [], [], []
        for arg, (pname, dtype, is_tensor, is_input) in zip(args,
                                                            self._params):
            if not is_tensor:
                c_args.append(_pack_scalar(arg, dtype))
                continue
            want = torch_dtype(dtype)
            t = arg._data.detach()
            direct = (t.device == dev and t.dtype == want
                      and t.is_contiguous())
            if not is_input:
                outs.append(arg)
                if not direct:
                    t = t.to(dev, want, copy=True).contiguous()
                    writeback.append((arg, t))
            elif not direct:
                t = t.to(dev, want).contiguous()
            keep.append(t)
            c_args.append(ctypes.c_void_p(t.data_ptr()))
        with nvrtc.device_context(dev.index):
            fn = self._function(dev.index, shared_mem)
            nvrtc.launch(fn, grid, block, shared_mem, stream.cuda_stream,
                         c_args)
        cuda_build.count_launch("rtc:" + self.name)
        with torch.no_grad():
            for arr, t in writeback:
                arr._data.copy_(t)
        del keep
        return outs


class PallasModule:
    """The JAX package's Pallas-source module has no meaning on a CUDA
    card; it raises, as the JAX package's ``CudaModule`` does on a TPU."""

    def __init__(self, source, options=(), exports=()):
        raise MXNetError(
            "PallasModule takes Pallas source, which runs on a TPU; this is "
            "the CUDA build: use mx.rtc.CudaModule (same API, CUDA C "
            "source compiled by NVRTC)")

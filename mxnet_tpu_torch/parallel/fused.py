"""Fused matmul + epilogue: the fusion-region kernels.

Counterpart of ``mxnet_tpu/parallel/fused.py`` ``fused_matmul`` and
``fused_batch_matmul``. The fuse graph pass carves Convolution /
FullyConnected / dot / batch_dot + epilogue chains into ``_FusedRegion``
nodes (ops/fused.py); the kernel-form regions run here, on the
hand-written CUDA kernel ``csrc/fused_matmul.cu``: a register-tiled fp32
SGEMM (128 x 128 or 64 x 64 output tiles, chosen per launch by
:func:`tile_size`) with the whole epilogue applied in registers before one
store.

* :func:`fused_matmul` — ``epilogue(x @ w.T)`` when ``wt`` (w is (N, K)),
  else ``epilogue(x @ w)`` (w is (K, N)). A CUDA tensor launches the
  kernel or raises; a CPU tensor takes :func:`fused_matmul_reference`.
* :func:`fused_batch_matmul` — ``epilogue(x[b] @ w[b])`` for x (B, M, K)
  and w (B, K, N), the batch_dot region, with scalar / act / residual /
  cast steps only (the JAX kernel rejects vector steps there too). The
  same kernel, its grid's z axis over the batch. A w that is the
  ``(0, 2, 1)`` transpose view of a contiguous (B, N, K) tensor is read in
  place (the kernel's ``wt`` form), so ``batch_dot(q, transpose(k))``
  copies nothing.
* :func:`fused_matmul_reference` / :func:`fused_batch_matmul_reference` —
  the plain PyTorch versions, used by the CPU tests and by the on-card
  comparison, never on the CUDA path.

Unlike the TPU kernel, this one masks ragged M/N/K edges itself, so every
shape has a kernel form: the JAX package's tiling decline (``pick_blocks``
returning None) and its block resolution through the tuning cache
(``resolve_blocks``) have no counterpart here.

Epilogue step grammar (static tuples, produced by ops/fused.py):

``("bias",)``         next extra, (N,) vector add
``("vmul",)/("vadd",)`` next extra, last-axis vector mul/add
``("res", op)``       next extra, (M, N) elemwise_add / elemwise_mul
``("act", kind)``     relu / sigmoid / tanh / softrelu / softsign
``("scalar", op, v)`` _mul/_div/_plus/_minus/_rminus_scalar
``("cast", dtype)``   no-op in-kernel: the single store casts once
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from ..base import MXNetError, torch_dtype
from ..ops.elemwise import softrelu, softsign

__all__ = ["fused_matmul", "fused_matmul_reference", "fused_batch_matmul",
           "fused_batch_matmul_reference", "supported_act", "tile_size",
           "MAX_STEPS"]

KERNEL = "fused_matmul"          # the source and the 2-d launch counter
BMM_KERNEL = "fused_batch_matmul"  # the batched launch counter

_BMM_STEPS = ("res", "act", "scalar", "cast")

# activations the kernel applies on the fp32 accumulator
_ACTS = ("relu", "sigmoid", "tanh", "softrelu", "softsign")

MAX_STEPS = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ACT_CODES = {"relu": 4, "sigmoid": 5, "tanh": 6, "softrelu": 7,
              "softsign": 8}
_SCALAR_CODES = {"_mul_scalar": 9, "_div_scalar": 10, "_plus_scalar": 11,
                 "_minus_scalar": 12, "_rminus_scalar": 13}


class _Epilogue(ctypes.Structure):
    """Mirror of ``struct FmEpilogue`` in csrc/fused_matmul.cu."""
    _fields_ = [("n_steps", ctypes.c_int),
                ("code", ctypes.c_int * MAX_STEPS),
                ("scalar", ctypes.c_float * MAX_STEPS),
                ("dtype", ctypes.c_int * MAX_STEPS),
                ("ptr", ctypes.c_void_p * MAX_STEPS)]


def supported_act(kind):
    return kind in _ACTS


def _apply_act(y, kind):
    if kind == "relu":
        return torch.relu(y)
    if kind == "sigmoid":
        return torch.sigmoid(y)
    if kind == "tanh":
        return torch.tanh(y)
    if kind == "softrelu":
        return softrelu(y)
    if kind == "softsign":
        return softsign(y)
    raise ValueError("unsupported fused activation %r" % (kind,))


def _apply_scalar(y, op, v):
    if op == "_mul_scalar":
        return y * v
    if op == "_div_scalar":
        return y / v
    if op == "_plus_scalar":
        return y + v
    if op == "_minus_scalar":
        return y - v
    if op == "_rminus_scalar":
        return v - y
    raise ValueError("unsupported fused scalar op %r" % (op,))


def _epilogue_extras(epilogue):
    """The steps that consume an extra input, in order."""
    return [s for s in epilogue if s[0] in ("bias", "vmul", "vadd", "res")]


def _check_extras(epilogue, extras):
    if len(_epilogue_extras(epilogue)) != len(extras):
        raise ValueError("fused_matmul: %d extra inputs for %d "
                         "extra-consuming steps"
                         % (len(extras), len(_epilogue_extras(epilogue))))


def fused_matmul_reference(x, w, extras=(), epilogue=(), wt=True,
                           out_dtype=None):
    """The plain PyTorch version: the same arithmetic in fp32 as separate
    ops, cast once at the end."""
    _check_extras(epilogue, extras)
    out_dtype = torch_dtype(out_dtype) or x.dtype
    wf = w.float()
    y = x.float() @ (wf.t() if wt else wf)
    return _reference_epilogue(y, extras, epilogue).to(out_dtype)


def _reference_epilogue(y, extras, epilogue):
    """The epilogue steps on the fp32 product ``y`` (..., M, N)."""
    N = y.shape[-1]
    ei = 0
    for step in epilogue:
        kind = step[0]
        if kind in ("bias", "vadd"):
            y = y + extras[ei].float().reshape(N)
            ei += 1
        elif kind == "vmul":
            y = y * extras[ei].float().reshape(N)
            ei += 1
        elif kind == "res":
            r = extras[ei].float().reshape(y.shape)
            y = y * r if step[1] == "elemwise_mul" else y + r
            ei += 1
        elif kind == "act":
            y = _apply_act(y, step[1])
        elif kind == "scalar":
            y = _apply_scalar(y, step[1], step[2])
        elif kind == "cast":
            pass  # the caller's final cast is the only one
        else:
            raise ValueError("unknown fused epilogue step %r" % (step,))
    return y


def _check_bmm_epilogue(epilogue, extras):
    for step in epilogue:
        if step[0] not in _BMM_STEPS:
            raise MXNetError("fused_batch_matmul: epilogue step %r has no "
                             "batched form (scalar, act, res and cast only)"
                             % (step,))
    _check_extras(epilogue, extras)


def fused_batch_matmul_reference(x, w, extras=(), epilogue=(),
                                 out_dtype=None):
    """The plain PyTorch version of :func:`fused_batch_matmul`: a batched
    fp32 product and the epilogue as separate ops, cast once at the end."""
    _check_bmm_epilogue(epilogue, extras)
    out_dtype = torch_dtype(out_dtype) or x.dtype
    y = torch.matmul(x.float(), w.float())
    return _reference_epilogue(y, extras, epilogue).to(out_dtype)


def _dtype_code(t, what):
    code = _DTYPE_CODES.get(t)
    if code is None:
        raise MXNetError("fused_matmul: %s dtype %s is not one of float32, "
                         "bfloat16, float16" % (what, t))
    return code


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signatures bound."""
    lib = cuda_build.load_library(KERNEL)
    lib.fused_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Epilogue), ctypes.c_void_p]
    lib.fused_matmul_launch.restype = ctypes.c_int
    lib.fused_batch_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Epilogue), ctypes.c_void_p]
    lib.fused_batch_matmul_launch.restype = ctypes.c_int
    lib.fused_matmul_tile.argtypes = [ctypes.c_int] * 3
    lib.fused_matmul_tile.restype = ctypes.c_int
    lib.fused_matmul_error_string.argtypes = [ctypes.c_int]
    lib.fused_matmul_error_string.restype = ctypes.c_char_p
    for probe in (lib.fused_matmul_epilogue_size, lib.fused_matmul_max_steps):
        probe.argtypes = []
        probe.restype = ctypes.c_int
    if lib.fused_matmul_epilogue_size() != ctypes.sizeof(_Epilogue) or \
            lib.fused_matmul_max_steps() != MAX_STEPS:
        raise MXNetError("fused_matmul: the epilogue struct of the built "
                         "library does not match _Epilogue")
    return lib


def tile_size(B, M, N):
    """The output tile edge (128 or 64) that the kernel takes for a launch
    of B (M, N) outputs on the current card: 128 where that grid fills
    every SM, else 64."""
    return _library().fused_matmul_tile(int(B), int(M), int(N))


def _encode_epilogue(epilogue, extras, M, N, device, res_shape=None):
    ep = _Epilogue()
    n = 0
    ei = 0
    for step in epilogue:
        kind = step[0]
        if kind == "cast":
            continue  # the store casts once
        if n == MAX_STEPS:
            raise MXNetError("fused_matmul: more than %d epilogue steps"
                             % MAX_STEPS)
        if kind in ("bias", "vadd", "vmul", "res"):
            e = extras[ei]
            ei += 1
            if e.device != device:
                raise MXNetError("fused_matmul: extra input on %s, x on %s"
                                 % (e.device, device))
            if not e.is_contiguous():
                raise MXNetError("fused_matmul: extra input %d is not "
                                 "contiguous" % (ei - 1))
            if kind == "res":
                want = res_shape or (M, N)
                if tuple(e.shape) != tuple(want):
                    raise MXNetError("fused_matmul: residual of shape %s, "
                                     "want %s" % (tuple(e.shape), want))
                ep.code[n] = 3 if step[1] == "elemwise_mul" else 2
            else:
                if e.numel() != N:
                    raise MXNetError("fused_matmul: vector of %d elements, "
                                     "want %d" % (e.numel(), N))
                ep.code[n] = 1 if kind == "vmul" else 0
            ep.dtype[n] = _dtype_code(e.dtype, "extra")
            ep.ptr[n] = e.data_ptr()
        elif kind == "act":
            if step[1] not in _ACT_CODES:
                raise MXNetError("fused_matmul: unsupported activation %r"
                                 % (step[1],))
            ep.code[n] = _ACT_CODES[step[1]]
        elif kind == "scalar":
            if step[1] not in _SCALAR_CODES:
                raise MXNetError("fused_matmul: unsupported scalar op %r"
                                 % (step[1],))
            ep.code[n] = _SCALAR_CODES[step[1]]
            ep.scalar[n] = float(step[2])
        else:
            raise MXNetError("unknown fused epilogue step %r" % (step,))
        n += 1
    ep.n_steps = n
    return ep


def fused_matmul(x, w, extras=(), epilogue=(), wt=True, out_dtype=None):
    """``epilogue(x @ w.T)`` (``wt``; w is (N, K)) or ``epilogue(x @ w)``
    (w is (K, N)) in one kernel; x is (M, K). ``extras`` holds one tensor
    per extra-consuming step in order: (N,) for bias/vmul/vadd, (M, N) for
    res. On a CUDA tensor this launches csrc/fused_matmul.cu or raises; on
    a CPU tensor it is :func:`fused_matmul_reference`."""
    _check_extras(epilogue, extras)
    if x.device.type == "cpu":
        return fused_matmul_reference(x, w, extras, epilogue, wt, out_dtype)
    if x.device.type != "cuda":
        raise MXNetError("fused_matmul: unsupported device %s" % x.device)
    out_dtype = torch_dtype(out_dtype) or x.dtype
    if x.dim() != 2 or w.dim() != 2:
        raise MXNetError("fused_matmul: x and w must be 2-d, got %s and %s"
                         % (tuple(x.shape), tuple(w.shape)))
    M, K = x.shape
    N = w.shape[0] if wt else w.shape[1]
    if (w.shape[1] if wt else w.shape[0]) != K:
        raise MXNetError("fused_matmul: x %s does not contract with w %s "
                         "(wt=%s)" % (tuple(x.shape), tuple(w.shape), wt))
    if w.device != x.device:
        raise MXNetError("fused_matmul: w on %s, x on %s"
                         % (w.device, x.device))
    if not (x.is_contiguous() and w.is_contiguous()):
        raise MXNetError("fused_matmul: x and w must be contiguous")
    x_dt = _dtype_code(x.dtype, "x")
    w_dt = _dtype_code(w.dtype, "w")
    o_dt = _dtype_code(out_dtype, "output")
    if max(M, N, K) >= 2 ** 31:
        raise MXNetError("fused_matmul: dimension above 2^31")
    ep = _encode_epilogue(epilogue, extras, M, N, x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_matmul_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 M, N, K, x_dt, w_dt, o_dt, int(bool(wt)),
                                 ctypes.byref(ep), stream)
    if rc != 0:
        raise MXNetError("fused_matmul launch failed: CUDA error %d (%s)"
                         % (rc, lib.fused_matmul_error_string(rc).decode()))
    cuda_build.count_launch(KERNEL)
    return out


def fused_batch_matmul(x, w, extras=(), epilogue=(), out_dtype=None):
    """``epilogue(x[b] @ w[b])`` for x (B, M, K) and w (B, K, N) in one
    kernel; ``extras`` holds one (B, M, N) tensor per ``res`` step. On a
    CUDA tensor this launches csrc/fused_matmul.cu's batched entry or
    raises; on a CPU tensor it is :func:`fused_batch_matmul_reference`.

    x must have unit stride along K and M-major rows (each x[b]
    contiguous; the batch stride is free). w is either contiguous or the
    ``(0, 2, 1)`` transpose view of a tensor whose w[b] are contiguous
    (N, K) matrices, which the kernel reads in place."""
    _check_bmm_epilogue(epilogue, extras)
    if x.device.type == "cpu":
        return fused_batch_matmul_reference(x, w, extras, epilogue,
                                            out_dtype)
    if x.device.type != "cuda":
        raise MXNetError("fused_batch_matmul: unsupported device %s"
                         % x.device)
    out_dtype = torch_dtype(out_dtype) or x.dtype
    if x.dim() != 3 or w.dim() != 3:
        raise MXNetError("fused_batch_matmul: x and w must be 3-d, got %s "
                         "and %s" % (tuple(x.shape), tuple(w.shape)))
    B, M, K = x.shape
    N = w.shape[2]
    if w.shape[0] != B or w.shape[1] != K:
        raise MXNetError("fused_batch_matmul: x %s does not contract with w "
                         "%s" % (tuple(x.shape), tuple(w.shape)))
    if w.device != x.device:
        raise MXNetError("fused_batch_matmul: w on %s, x on %s"
                         % (w.device, x.device))
    if x.stride(2) != 1 or x.stride(1) != K:
        raise MXNetError("fused_batch_matmul: each x[b] must be a contiguous"
                         " (M, K) matrix")
    if w.stride(2) == 1 and w.stride(1) == N:
        wt = 0
    elif w.stride(1) == 1 and w.stride(2) == K:
        wt = 1   # the transpose view of a (B, N, K) tensor
    else:
        raise MXNetError("fused_batch_matmul: w must be contiguous or the "
                         "(0, 2, 1) transpose of a contiguous tensor")
    x_dt = _dtype_code(x.dtype, "x")
    w_dt = _dtype_code(w.dtype, "w")
    o_dt = _dtype_code(out_dtype, "output")
    if max(M, N, K) >= 2 ** 31 or B > 65535:
        raise MXNetError("fused_batch_matmul: dimension above 2^31 or batch "
                         "above 65535")
    ep = _encode_epilogue(epilogue, extras, M, N, x.device,
                          res_shape=(B, M, N))
    out = torch.empty((B, M, N), dtype=out_dtype, device=x.device)
    if B == 0 or M == 0 or N == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_batch_matmul_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), B, M, N, K,
        x.stride(0), w.stride(0), x_dt, w_dt, o_dt, wt, ctypes.byref(ep),
        stream)
    if rc != 0:
        raise MXNetError("fused_batch_matmul launch failed: CUDA error %d "
                         "(%s)" % (rc,
                                   lib.fused_matmul_error_string(rc).decode()))
    cuda_build.count_launch(BMM_KERNEL)
    return out

"""Fused matmul + epilogue: the fusion-region kernels.

Counterpart of ``mxnet_tpu/parallel/fused.py`` ``fused_matmul`` and
``fused_batch_matmul``. The fuse graph pass carves Convolution /
FullyConnected / dot / batch_dot + epilogue chains into ``_FusedRegion``
nodes (ops/fused.py); the kernel-form regions run here, on the
hand-written CUDA kernel ``csrc/fused_matmul.cu``, by one of two routes
(:func:`route`, a function of the operands' dtypes, the shape and the
alignment alone): the tensor-core route (``"tc"``: wgmma on 16-bit
operands fed by a cp.async ring, output tiles of 128 or 64 by 128 or 64,
:data:`TC_TILES`) where x and w are both bf16 or both fp16 with 16-byte
rows and bases, else the CUDA-core route (``"simt"``: a register-tiled
fp32 SGEMM, 128 x 128 or 64 x 64 output tiles, :data:`TILES`). Either
applies the whole epilogue on the fp32 accumulators before one store.

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
returning None) has no counterpart here. The tile resolves per route as
in the JAX package (:func:`resolve_blocks`): an explicit ``block_m`` /
``block_n`` argument, else the ``fusion.blocks`` tuning-cache entry under
:func:`fused_tile_key`, else the route's default rule
(``cost_model.fused_default_tile``; :func:`tile_size`) within the
``MXNET_FUSION_BLOCK_M`` / ``_N`` bounds; the kernel is always told its
route and its tile. A tile the route does not compile raises, and so
does a launch the route refuses: no route stands in for another. On the
CUDA-core route ``block_k`` is the JAX package's field, recorded and
checked against the depths the edge compiles but not passed on (the
kernel takes its K-slice depth from its form); on the tensor-core route
it is the stage depth, 64. On either route each output is summed over k
in ascending order by the same instructions at every tile, so the tile
changes the time, never a bit of the result; the route does change the
bits (tensor-core products against fp32 FMA chains), and it is never
chosen by a tile or a flag. The resolution is made at the first launch
of a shape and carried in a :class:`~..autotune.cache.Carry` (one dict
probe a launch, no lookup) until the tuning cache or a tuning flag
changes; a CUDA graph keeps the tile it was captured with, and an entry
written after a capture takes effect at the next capture. Each launch
counts under its kernel and a variant naming its tile: the edge (128,
64) on the CUDA-core route, ``tc<block_m>x<block_n>`` on the tensor-core
route (:func:`variant`).

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
from ..autotune import cache as _tune_cache
from ..autotune import cost_model as _cost_model
from ..base import MXNetError, dtype_name, torch_dtype
from ..config import get_flag
from ..ops.elemwise import softrelu, softsign

__all__ = ["fused_matmul", "fused_matmul_reference", "fused_batch_matmul",
           "fused_batch_matmul_reference", "supported_act", "route",
           "variant", "tile_size", "fused_shape_key", "fused_tile_key",
           "resolve_blocks", "compiled_tiles", "TILES", "TC_TILES",
           "MAX_STEPS"]

KERNEL = "fused_matmul"          # the source and the 2-d launch counter
BMM_KERNEL = "fused_batch_matmul"  # the batched launch counter

_BMM_STEPS = ("res", "act", "scalar", "cast")

# activations the kernel applies on the fp32 accumulator
_ACTS = ("relu", "sigmoid", "tanh", "softrelu", "softsign")

MAX_STEPS = 8

#: the CUDA-core route's compiled tiles: output tile edge -> K-slice depth
#: of its fp32 form and of its other form (csrc/fused_matmul.cu TILES)
TILES = _cost_model.FUSED_TILES["simt"]
#: the tensor-core route's: (block_m, block_n) -> the K depth of a stage
#: (csrc/fused_matmul.cu TC_TILES); the tunable's space and its cost read
#: the same tables
TC_TILES = _cost_model.FUSED_TILES["tc"]

_ROUTE_CODES = {"simt": 0, "tc": 1}

# each launch's tile, per shape, dtype, route, tile arguments and card
_TILE_CARRY = _tune_cache.Carry()

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
                           out_dtype=None, block_m=None, block_n=None,
                           block_k=None):
    """The plain PyTorch version: the same arithmetic in fp32 as separate
    ops, cast once at the end. The tile arguments are accepted and unused:
    the result does not depend on the tile."""
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
                                 out_dtype=None, block_m=None, block_n=None,
                                 block_k=None):
    """The plain PyTorch version of :func:`fused_batch_matmul`: a batched
    fp32 product and the epilogue as separate ops, cast once at the end.
    The tile arguments are accepted and unused."""
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
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Epilogue), ctypes.c_void_p]
    lib.fused_matmul_launch.restype = ctypes.c_int
    lib.fused_batch_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Epilogue), ctypes.c_void_p]
    lib.fused_batch_matmul_launch.restype = ctypes.c_int
    lib.fused_matmul_tiles.argtypes = [ctypes.c_int] * 3
    lib.fused_matmul_tiles.restype = ctypes.c_int
    lib.fused_matmul_tc_smem.argtypes = [ctypes.c_int]
    lib.fused_matmul_tc_smem.restype = ctypes.c_int
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


def route(x_dtype, w_dtype, N, K, wt, x_ptr=0, w_ptr=0, x_bs=0, w_bs=0):
    """The route a launch takes: ``"tc"`` (the tensor cores) where x and
    w are both bfloat16 or both float16, K is a multiple of 8 (and N too
    when w is (K, N), ``wt`` False), the bases ``x_ptr`` / ``w_ptr`` are
    16-byte aligned and the batch strides ``x_bs`` / ``w_bs`` (elements)
    are multiples of 8; else ``"simt"`` (the CUDA cores). Dtypes, shape
    and alignment only: no tile, tuning entry or flag moves a launch from
    one route to the other."""
    half = (torch.bfloat16, torch.float16)
    if x_dtype != w_dtype or x_dtype not in half:
        return "simt"
    if int(K) % 8 or (not wt and int(N) % 8):
        return "simt"
    if int(x_ptr) % 16 or int(w_ptr) % 16 or int(x_bs) % 8 or \
            int(w_bs) % 8:
        return "simt"
    return "tc"


def variant(route_name, block_m, block_n):
    """The launch counter's variant of a launch: its edge on the CUDA-core
    route, ``"tc<block_m>x<block_n>"`` on the tensor-core route."""
    if route_name == "tc":
        return "tc%dx%d" % (block_m, block_n)
    return block_m


def tile_size(B, M, N, route="simt"):
    """The tile a launch of B (M, N) outputs on ``route`` takes on the
    current card when nothing names one and the flags bound nothing: the
    edge (128 or 64) on the CUDA-core route, (block_m, block_n) on the
    tensor-core route (``cost_model.fused_default_tile``, the one home of
    the rule)."""
    return _cost_model.fused_default_tile(
        B, M, N, sms=_sm_count(torch.cuda.current_device()), route=route)


def compiled_tiles():
    """The built library's tile tables, {"simt": {edge: (fp32 depth, other
    depth)}, "tc": {(block_m, block_n): (stage depth,)}} (the card tests
    hold ``cost_model.FUSED_TILES`` to it)."""
    lib = _library()
    out = {"simt": {}, "tc": {}}
    for name, code in _ROUTE_CODES.items():
        i = 0
        while lib.fused_matmul_tiles(code, i, 0) > 0:
            row = [lib.fused_matmul_tiles(code, i, c) for c in range(3)]
            if name == "simt":
                out[name][row[0]] = (row[1], row[2])
            else:
                out[name][row[0], row[1]] = (row[2],)
            i += 1
    return out


def compiled_tc_smem():
    """{(block_m, block_n): dynamic shared memory bytes} of the built
    library's tensor-core tiles (``cost_model.fused_tc_smem_bytes``'s
    counterpart)."""
    lib = _library()
    return {(lib.fused_matmul_tiles(1, i, 0), lib.fused_matmul_tiles(1, i, 1)):
            lib.fused_matmul_tc_smem(i) for i in range(len(TC_TILES))}


def fused_shape_key(M, N, K):
    """Shape-bucket key of ``fusion.blocks`` cache entries: every dim
    rounds up to a power of two (one tuning per bucket, not per exact
    shape); the JAX package's key."""
    p2 = _cost_model.pow2_at_least
    return ("M%d" % p2(int(M)), "N%d" % p2(int(N)), "K%d" % p2(int(K)))


def fused_tile_key(M, N, K, route="simt"):
    """The ``fusion.blocks`` key of a launch on ``route``: the shape
    bucket, with ``"tc"`` appended on the tensor-core route (its tiles are
    another table)."""
    key = fused_shape_key(M, N, K)
    return key + ("tc",) if route == "tc" else key


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_tile(blocks, where, route="simt"):
    """``blocks`` (block_m, block_n, block_k) as a tile ``route``
    compiles, with one of the K depths it compiles there, or raise."""
    bm, bn, bk = blocks
    if route == "tc":
        if (bm, bn) in TC_TILES and bk in TC_TILES[bm, bn]:
            return
        raise MXNetError(
            "fused_matmul: %s tile (block_m=%s, block_n=%s, block_k=%s) is "
            "not one the kernel compiles on the tensor-core route (%s)"
            % (where, bm, bn, bk,
               ", ".join("%d x %d with K stages of %s" % (m, n, d)
                         for (m, n), d in sorted(TC_TILES.items()))))
    if bm != bn or bm not in TILES or bk not in TILES[bm]:
        raise MXNetError(
            "fused_matmul: %s tile (block_m=%s, block_n=%s, block_k=%s) is "
            "not one the kernel compiles (%s)"
            % (where, bm, bn, bk,
               ", ".join("%d x %d with K slices of %s" % (e, e, d)
                         for e, d in sorted(TILES.items()))))


def _tuned_int(value):
    try:
        value = int(value)
    except (TypeError, ValueError):
        return None
    return value if value > 0 else None


def resolve_blocks(M, N, K, dtype="float32", dtype_bytes=4, block_m=None,
                   block_n=None, block_k=None, batch=1, sms=None,
                   device=None, route="simt", wt=True):
    """The tile ``(block_m, block_n, block_k)`` a launch of ``batch`` (M, N,
    K) products on ``route`` takes: explicit per-call arguments > the
    tuning cache's ``fusion.blocks`` entry for this (route's shape key,
    dtype) > the route's default rule within the MXNET_FUSION_BLOCK_M/N
    bounds. A missing explicit edge is filled from the other (a square
    tile); a missing ``block_k`` is the route's recorded depth at that
    tile (on the CUDA-core route the deepest slice the edge compiles: the
    kernel's form decides the depth it runs, :data:`TILES`). Raises on a
    tile the route does not compile, whether named by an argument or by a
    cache entry. ``sms`` is the card's SM count (the current card's, else
    the H100's 132); ``device`` is where a search under ``MXNET_TUNE=1``
    measures (default the current card), in the ``wt`` form."""
    where = "explicit"
    given = (block_m, block_n, block_k)
    if given == (None, None, None):
        from .. import autotune

        ctx = {"M": int(M), "N": int(N), "K": int(K), "B": int(batch),
               "dtype_bytes": int(dtype_bytes), "dtype": str(dtype),
               "route": route, "wt": bool(wt)}
        if device is not None:
            ctx["device"] = str(device)
        tuned = autotune.lookup_or_tune(
            "fusion.blocks", fused_tile_key(M, N, K, route),
            dtype=str(dtype), ctx=ctx)
        if isinstance(tuned, dict):
            given = tuple(_tuned_int(tuned.get(k))
                          for k in ("block_m", "block_n", "block_k"))
            where = "the fusion.blocks cache entry's"
    tiles = TC_TILES if route == "tc" else TILES
    if given == (None, None, None):
        if sms is None:
            sms = (_sm_count(torch.cuda.current_device())
                   if torch.cuda.is_available() else _cost_model.SMS)
        tile = _cost_model.fused_default_tile(
            batch, M, N, sms=sms,
            bound=min(get_flag("MXNET_FUSION_BLOCK_M"),
                      get_flag("MXNET_FUSION_BLOCK_N")), route=route)
        if route == "tc":
            return tile + (tiles[tile][0],)
        return tile, tile, tiles[tile][0]
    bm, bn, bk = given
    edge = bm or bn
    if edge is None:  # block_k alone: the largest edge that compiles it
        edge = next((e for e in sorted(TILES, reverse=True)
                     if bk in TILES[e]), bk) if route == "simt" else \
            max(TC_TILES)[0]
    bm = bm or edge
    bn = bn or edge
    if bk is None:
        key = (bm, bn) if route == "tc" else edge
        bk = tiles[key][0] if key in tiles else None
    _check_tile((bm, bn, bk), where, route)
    return bm, bn, bk


def _launch_tile(B, M, N, K, dtype, route_name, wt, block_m, block_n,
                 block_k, device):
    """The (block_m, block_n) of a launch: resolved at a shape's first
    launch and carried until the tuning cache or a tuning flag changes."""
    key = (B, M, N, K, dtype, route_name, wt, block_m, block_n, block_k,
           device)
    tile = _TILE_CARRY.values.get(key)
    if tile is None:
        tile = _TILE_CARRY.get(key, lambda: resolve_blocks(
            M, N, K, dtype=dtype_name(dtype), dtype_bytes=dtype.itemsize,
            block_m=block_m, block_n=block_n, block_k=block_k, batch=B,
            sms=_sm_count(device.index), device=device, route=route_name,
            wt=wt)[:2])
    return tile


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


def fused_matmul(x, w, extras=(), epilogue=(), wt=True, out_dtype=None,
                 block_m=None, block_n=None, block_k=None):
    """``epilogue(x @ w.T)`` (``wt``; w is (N, K)) or ``epilogue(x @ w)``
    (w is (K, N)) in one kernel; x is (M, K). ``extras`` holds one tensor
    per extra-consuming step in order: (N,) for bias/vmul/vadd, (M, N) for
    res. ``block_m`` / ``block_n`` / ``block_k`` name the tile
    (:func:`resolve_blocks`). On a CUDA tensor this launches
    csrc/fused_matmul.cu or raises; on a CPU tensor it is
    :func:`fused_matmul_reference`."""
    _check_extras(epilogue, extras)
    if x.device.type == "cpu":
        return fused_matmul_reference(x, w, extras, epilogue, wt, out_dtype,
                                      block_m, block_n, block_k)
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
    wt = bool(wt)
    path = route(x.dtype, w.dtype, N, K, wt, x.data_ptr(), w.data_ptr())
    bm, bn = _launch_tile(1, M, N, K, x.dtype, path, wt, block_m, block_n,
                          block_k, x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_matmul_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 M, N, K, x_dt, w_dt, o_dt, int(wt),
                                 _ROUTE_CODES[path], bm, bn,
                                 ctypes.byref(ep), stream)
    if rc != 0:
        raise MXNetError("fused_matmul launch failed on the %s route at "
                         "tile %d x %d: CUDA error %d (%s)"
                         % (path, bm, bn, rc,
                            lib.fused_matmul_error_string(rc).decode()))
    cuda_build.count_launch(KERNEL, variant(path, bm, bn))
    return out


def fused_batch_matmul(x, w, extras=(), epilogue=(), out_dtype=None,
                       block_m=None, block_n=None, block_k=None):
    """``epilogue(x[b] @ w[b])`` for x (B, M, K) and w (B, K, N) in one
    kernel; ``extras`` holds one (B, M, N) tensor per ``res`` step; the
    tile arguments as in :func:`fused_matmul`. On a CUDA tensor this
    launches csrc/fused_matmul.cu's batched entry or raises; on a CPU
    tensor it is :func:`fused_batch_matmul_reference`.

    x must have unit stride along K and M-major rows (each x[b]
    contiguous; the batch stride is free). w is either contiguous or the
    ``(0, 2, 1)`` transpose view of a tensor whose w[b] are contiguous
    (N, K) matrices, which the kernel reads in place."""
    _check_bmm_epilogue(epilogue, extras)
    if x.device.type == "cpu":
        return fused_batch_matmul_reference(x, w, extras, epilogue,
                                            out_dtype, block_m, block_n,
                                            block_k)
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
    path = route(x.dtype, w.dtype, N, K, wt, x.data_ptr(), w.data_ptr(),
                 x.stride(0), w.stride(0))
    bm, bn = _launch_tile(B, M, N, K, x.dtype, path, bool(wt), block_m,
                          block_n, block_k, x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_batch_matmul_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), B, M, N, K,
        x.stride(0), w.stride(0), x_dt, w_dt, o_dt, wt, _ROUTE_CODES[path],
        bm, bn, ctypes.byref(ep), stream)
    if rc != 0:
        raise MXNetError("fused_batch_matmul launch failed on the %s route "
                         "at tile %d x %d: CUDA error %d (%s)"
                         % (path, bm, bn, rc,
                            lib.fused_matmul_error_string(rc).decode()))
    cuda_build.count_launch(BMM_KERNEL, variant(path, bm, bn))
    return out

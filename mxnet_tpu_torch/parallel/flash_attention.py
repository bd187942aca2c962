"""Flash attention: the forward and the tiled recompute backward, as
hand-written CUDA kernels (``csrc/flash_attention.cu``).

Counterpart of ``mxnet_tpu/parallel/flash_attention.py``
``flash_attention``. The forward saves only the O(T) residuals
(q, k, v, o, lse), lse being the per-row logsumexp of the scaled scores;
the backward recomputes the score tiles in two passes, a dq pass over q
tiles and a dk/dv pass over k tiles, so no T x T tensor reaches device
memory in training either.

* :func:`flash_attention` — (B, H, T, D) in, (B, H, T, D) out (and the
  (B, H, T) fp32 lse with ``return_lse``); differentiable through both
  outputs. A CUDA tensor launches the three kernels or raises; a CPU
  tensor takes their plain versions below. ``MXNET_FLASH_ATTENTION_BWD=0``
  is the explicit switch to dense autodiff of the plain formula.
* :func:`flash_attention_reference` — the plain version, the counterpart of
  ``_dense_with_lse``: ``(out, lse)`` in fp32 arithmetic, ``out`` cast to
  the input dtype once.
* :func:`flash_forward`, :func:`flash_backward_dq`,
  :func:`flash_backward_dkv` — one wrapper per kernel, each with its plain
  version (``*_reference``) beside it.

The CUDA kernels mask ragged T themselves, so every T has a kernel form on
the card: the JAX package's prime-T dense fallback and its block lookup
through the tuning cache have no counterpart here. The block arguments are
accepted for API parity and unused: the kernels choose their own tiles.
The fp32 kernels run on the CUDA cores in fp32 (64 x 64 tiles); the bf16
and fp16 kernels run on the tensor cores (wgmma; the forward in 64-row
blocks of one warpgroup, the backward in 128-row blocks of two), rounding
p (and in the backward ds) once to the input type as the A operands of
their second products, where SDPA's flash kernels round them too (``round_to`` of the plain versions repeats that: the
forward's walks the key axis in the kernel's 64-key tiles with its running
max, since its p is relative to that max).
``paged_decode_attention`` and ``paged_verify_attention`` wait for the
generation slice.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import cuda_build
from ..base import MXNetError
from ..config import get_flag

__all__ = ["flash_attention", "flash_attention_reference", "flash_forward",
           "flash_forward_reference", "flash_backward_dq",
           "flash_backward_dq_reference", "flash_backward_dkv",
           "flash_backward_dkv_reference", "KERNELS"]

SOURCE = "flash_attention"
FWD, DQ, DKV = ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")
KERNELS = (FWD, DQ, DKV)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_NEG_INF = float("-inf")


def _scale(D, scale):
    return float(scale) if scale is not None else 1.0 / math.sqrt(D)


def _causal_mask(T, device):
    return torch.ones((T, T), dtype=torch.bool, device=device).tril()


# ---------------------------------------------------------- plain versions

def flash_attention_reference(q, k, v, causal=False, scale=None):
    """The plain version: ``(out, lse)`` from the dense (T, T) scores, in
    fp32 arithmetic; ``out`` in the input dtype, ``lse`` fp32. Fully masked
    rows have lse = -inf and a zero output."""
    scale = _scale(q.shape[-1], scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[2], q.device), _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    lse_safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    w = torch.exp(s - lse_safe[..., None])
    w = torch.where(torch.isneginf(s), torch.zeros_like(w), w)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v.float())
    return out.to(q.dtype), lse


def flash_forward_reference(q, k, v, causal, scale, round_to=None,
                            block_k=64):
    """Plain version of the forward kernel (no autograd). With ``round_to``
    (a torch dtype) it walks the key axis in the tensor-core kernel's
    ``block_k``-key tiles with its running max, and rounds each p =
    exp(s - m_running) once to ``round_to`` where that kernel does (the A
    operand of its P.V product), l summed from the unrounded p; without,
    it is the dense fp32 formula of :func:`flash_attention_reference`."""
    with torch.no_grad():
        if round_to is None:
            return flash_attention_reference(q, k, v, causal, scale)
        return _fwd_tiles(q, k, v, causal, scale, round_to, block_k)


def _fwd_tiles(q, k, v, causal, scale, round_to, block_k):
    """The online softmax over key tiles, in fp32 but for p's rounding:
    ``(out, lse)``, out in the input dtype. The guards are the TPU
    kernel's: p = 0 for a masked score, corr = 0 while a row has seen no
    live key, so a fully masked row gives lse = -inf and a zero output."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[2], q.device), _NEG_INF)
    m = torch.full(s.shape[:3], _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, s.shape[-1], block_k):
        st = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, st.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                             m_new)
        p = torch.exp(st - m_safe[..., None])
        corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                           torch.exp(m - m_safe))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(round_to).float(),
            v[..., k0:k0 + block_k, :].float())
        m = m_new
    lc = l.clamp_min(1e-30)
    return (acc / lc[..., None]).to(q.dtype), m + torch.log(lc)


def _bwd_tiles(q, k, v, do, lse, delta, causal, scale, round_to=None):
    """Dense counterpart of the kernels' shared tile recompute: the scaled
    q, p = exp(s - lse) and ds = p * (do.v^T - delta), in fp32. With
    ``round_to`` (a torch dtype), p and ds are then rounded once to it, as
    the bf16/fp16 tensor-core kernels round them into the A operands of
    their second products (ds from the unrounded p)."""
    qs = q.float() * scale
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    dead = torch.isneginf(lse)[..., None].expand_as(s)
    if causal:
        dead = dead | ~_causal_mask(q.shape[2], q.device)
    lse_safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(s - lse_safe[..., None]).masked_fill(dead, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    if round_to is not None:
        p, ds = p.to(round_to).float(), ds.to(round_to).float()
    return qs, p, ds


def flash_backward_dq_reference(q, k, v, do, lse, delta, causal, scale,
                                round_to=None):
    """Plain version of the dq kernel: dq = scale * ds . k (``round_to``:
    see :func:`_bwd_tiles`)."""
    with torch.no_grad():
        _, _, ds = _bwd_tiles(q, k, v, do, lse, delta, causal, scale,
                              round_to)
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
        return dq.to(q.dtype)


def flash_backward_dkv_reference(q, k, v, do, lse, delta, causal, scale,
                                 round_to=None):
    """Plain version of the dk/dv kernel: dv = p^T . do, dk = ds^T . qs
    (``round_to``: see :func:`_bwd_tiles`)."""
    with torch.no_grad():
        qs, p, ds = _bwd_tiles(q, k, v, do, lse, delta, causal, scale,
                               round_to)
        dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
        return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------- kernel wrappers

@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signatures bound."""
    lib = cuda_build.load_library(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, f, i,
                                               i, p]
    lib.flash_attention_bwd_dq_launch.argtypes = [p, p, p, p, p, p, p, i, i,
                                                  i, f, i, i, p]
    lib.flash_attention_bwd_dkv_launch.argtypes = [p, p, p, p, p, p, p, p, i,
                                                   i, i, f, i, i, p]
    for fn in (lib.flash_attention_fwd_launch,
               lib.flash_attention_bwd_dq_launch,
               lib.flash_attention_bwd_dkv_launch):
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, q, tensors, rows):
    """Raise on what the kernels do not take; returns (BH, T, D, dtype
    code). ``tensors`` share q's shape and dtype, ``rows`` are (B, H, T)
    fp32."""
    if q.device.type != "cuda":
        raise MXNetError("%s: unsupported device %s" % (name, q.device))
    if q.dim() != 4:
        raise MXNetError("%s: q must be (B, H, T, D), got %s"
                         % (name, tuple(q.shape)))
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise MXNetError("%s: dtype %s is not one of float32, bfloat16, "
                         "float16" % (name, q.dtype))
    B, H, T, D = q.shape
    if D % 8 or not 8 <= D <= 128:
        raise MXNetError("%s: head dim %d is not supported (multiples of 8 "
                         "from 8 to 128)" % (name, D))
    for t in (q,) + tuple(tensors):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise MXNetError("%s: inputs differ in device, dtype or shape: "
                             "%s %s %s vs %s %s %s"
                             % (name, t.device, t.dtype, tuple(t.shape),
                                q.device, q.dtype, tuple(q.shape)))
        if not t.is_contiguous():
            raise MXNetError("%s: inputs must be contiguous" % name)
        if t.data_ptr() % 16:
            raise MXNetError("%s: inputs must be 16-byte aligned (the "
                             "kernels load 16-byte vectors)" % name)
    for t in rows:
        if t.device != q.device or t.dtype != torch.float32 or \
                tuple(t.shape) != (B, H, T) or not t.is_contiguous():
            raise MXNetError("%s: lse and delta must be contiguous float32 "
                             "(B, H, T) on %s" % (name, q.device))
    if B * H * ((T + 63) // 64) >= 2 ** 31:
        raise MXNetError("%s: grid of more than 2^31 blocks" % name)
    return B * H, T, D, code


def _launched(kernel, lib, rc):
    if rc != 0:
        raise MXNetError("%s launch failed: CUDA error %d (%s)"
                         % (kernel, rc,
                            lib.flash_attention_error_string(rc).decode()))
    cuda_build.count_launch(kernel)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward(q, k, v, causal=False, scale=None):
    """``(o, lse)``: the forward kernel on a CUDA tensor, its plain version
    on a CPU tensor."""
    scale = _scale(q.shape[-1], scale)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, scale)
    BH, T, D, code = _check(FWD, q, (k, v), ())
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    lib = _library()
    rc = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), BH, T, D, scale, int(bool(causal)), code,
        _stream(q))
    _launched(FWD, lib, rc)
    return o, lse


def flash_backward_dq(q, k, v, do, lse, delta, causal=False, scale=None):
    """dq from the forward's residuals; ``delta = rowsum(do * o) - dlse``
    in fp32. The dq kernel on a CUDA tensor, its plain version on a CPU
    tensor."""
    scale = _scale(q.shape[-1], scale)
    if q.device.type == "cpu":
        return flash_backward_dq_reference(q, k, v, do, lse, delta, causal,
                                           scale)
    BH, T, D, code = _check(DQ, q, (k, v, do), (lse, delta))
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    lib = _library()
    rc = lib.flash_attention_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, T, D, scale,
        int(bool(causal)), code, _stream(q))
    _launched(DQ, lib, rc)
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, causal=False, scale=None):
    """``(dk, dv)`` from the same residuals: the dk/dv kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    scale = _scale(q.shape[-1], scale)
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, do, lse, delta, causal,
                                            scale)
    BH, T, D, code = _check(DKV, q, (k, v, do), (lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    lib = _library()
    rc = lib.flash_attention_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
        T, D, scale, int(bool(causal)), code, _stream(q))
    _launched(DKV, lib, rc)
    return dk, dv


# ------------------------------------------------------------ the function

class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward = the dq kernel then the dk/dv kernel, or
    dense autodiff of the plain formula under MXNET_FLASH_ATTENTION_BWD=0."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_forward(q, k, v, causal, scale)
        # O(T)-per-head residuals: no T x T tensor survives the forward
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        if not get_flag("MXNET_FLASH_ATTENTION_BWD"):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                out, lse2 = flash_attention_reference(*leaves, ctx.causal,
                                                      ctx.scale)
                outs, cots = [out], [do]
                if dlse is not None:
                    outs.append(lse2)
                    cots.append(dlse)
                dq, dk, dv = torch.autograd.grad(outs, leaves, cots)
            return dq, dk, dv, None, None
        do = do.contiguous()
        # delta_i = rowsum(do_i * o_i); an lse cotangent adds dlse_i * p_ij
        # to ds_ij, which folds in as delta - dlse
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        dq = flash_backward_dq(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale)
        dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None, block_q_bwd=None, block_k_bwd=None,
                    return_lse=False):
    """Blocked attention; q/k/v: (batch, heads, T, d), contiguous.

    Returns ``out`` (the input dtype), or ``(out, lse)`` with
    ``return_lse`` (lse (batch, heads, T) fp32, the streaming-combine hook
    of ring attention); gradients flow through both. The block arguments
    are accepted for parity with the JAX package and unused: the CUDA
    kernels choose their own tiles."""
    del block_q, block_k, block_q_bwd, block_k_bwd
    scale = _scale(q.shape[-1], scale)
    out, lse = _FlashAttention.apply(q, k, v, bool(causal), scale)
    return (out, lse) if return_lse else out

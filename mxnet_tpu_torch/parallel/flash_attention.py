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

:func:`paged_decode_attention` and :func:`paged_verify_attention`, the
generation engine's attention against its paged KV cache, are PyTorch
compositions, as the JAX package keeps them in XLA: at a query length of
one to a few positions the step is a gather of pages, not a tile of
products.
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
           "flash_backward_dkv_reference", "paged_decode_attention",
           "paged_verify_attention", "KERNELS"]

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


# ------------------------------------------------ paged attention (decode)

def _page_block(n_pages, page, block_tokens):
    """Pages per streamed key block: the largest divisor of the table width
    whose tokens stay within ``block_tokens`` (at least one page), as the
    JAX package chooses it."""
    want = max(1, int(block_tokens or n_pages * page) // page)
    for cand in range(min(want, n_pages), 0, -1):
        if n_pages % cand == 0:
            return cand
    return 1


def _paged_attention(q, k_pages, v_pages, page_table, limits, scale,
                     block_tokens, k_scale, v_scale):
    """The online softmax of ``q`` (S, Q, H, d) over each slot's pages in
    blocks of whole pages; query (s, i) attends positions below
    ``limits[s, i]``. Scores, softmax and the P.V product are fp32 whatever
    the page dtype; int8 pages dequantize on gather by their (P, page, H)
    scales. A query with no live key gives zeros. Only shapes steer the
    Python here: no value is read back to the host, so the function can
    run inside a captured CUDA graph."""
    S, Q, H, d = q.shape
    page = k_pages.shape[1]
    n_pages = page_table.shape[1]
    bp = _page_block(n_pages, page, block_tokens)
    blk = bp * page
    page_table = page_table.long()
    qf = q.float() * _scale(d, scale)
    m = torch.full((S, Q, H), _NEG_INF, device=q.device)
    l = torch.zeros((S, Q, H), device=q.device)
    acc = torch.zeros((S, Q, H, d), device=q.device)
    pos = torch.arange(n_pages * page, device=q.device)
    dead = (pos[None, None, :] >= limits[:, :, None])[:, :, None, :]
    for i in range(n_pages // bp):
        tab = page_table[:, i * bp:(i + 1) * bp]
        kb = k_pages[tab].reshape(S, blk, H, d).float()
        vb = v_pages[tab].reshape(S, blk, H, d).float()
        if k_scale is not None:
            kb = kb * k_scale[tab].reshape(S, blk, H)[..., None]
        if v_scale is not None:
            vb = vb * v_scale[tab].reshape(S, blk, H)[..., None]
        s = torch.einsum("sqhd,sthd->sqht", qf, kb)
        s = s.masked_fill(dead[..., i * blk:(i + 1) * blk], _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # m_safe keeps exp's argument finite while a row has no live key;
        # exp(-inf) = 0 then zeroes both a dead score's p and a first
        # block's correction, as the reference's guards do
        m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                             m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(m - m_safe)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("sqht,sthd->sqhd", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None, block_tokens=None, k_scale=None,
                           v_scale=None):
    """One query per slot against a paged KV cache: the decode step.

    ``q``: (S, H, d); ``k_pages`` / ``v_pages``: (P, page, H, d), one
    layer's pool; ``page_table``: (S, n_pages) page ids of each slot's
    positions; ``lengths``: (S,) live keys per slot (a slot of length 0
    gives zeros). Keys stream in blocks of whole pages, at most
    ``block_tokens`` positions (a divisor of the table width), through the
    online softmax, in fp32. ``k_scale`` / ``v_scale``: (P, page, H) fp32,
    the int8 pool mode: pages hold symmetric-int8 K/V with one scale per
    (position, head), and each gathered block dequantizes inside the
    recurrence."""
    limits = lengths.long()[:, None]
    return _paged_attention(q[:, None], k_pages, v_pages, page_table, limits,
                            scale, block_tokens, k_scale, v_scale)[:, 0]


def paged_verify_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None, block_tokens=None, k_scale=None,
                           v_scale=None):
    """Q = k+1 queries per slot against a paged KV cache: the batched
    verify step of speculative decoding. ``q``: (S, Q, H, d); ``lengths``:
    (S,) committed keys per slot before the step's candidates; query ``i``
    attends positions below ``lengths + 1 + i``, so its output is a decode
    step's at that length. Other arguments as in
    :func:`paged_decode_attention`."""
    Q = q.shape[1]
    limits = lengths.long()[:, None] + 1 + torch.arange(Q, device=q.device)
    return _paged_attention(q, k_pages, v_pages, page_table, limits, scale,
                            block_tokens, k_scale, v_scale)

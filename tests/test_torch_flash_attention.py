"""Port parity: flash attention (mxnet_tpu_torch/parallel/flash_attention.py)
against the JAX package's Pallas kernels, run in interpret mode as
tests/test_flash_attention_bwd.py runs them on the CPU.

On the CPU the port's forward, dq and dk/dv wrappers take their plain
versions, so what is held to the Pallas kernels here is the arithmetic the
CUDA kernels share with them (fp32 scores, the saved lse, delta folding of
the lse cotangent) and the autograd.Function around them; the CUDA kernels
are held to the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: fp32 rtol = atol = 1e-5, the reference's own bar for its
backward kernels (both sides compute in fp32, in another summation order);
bf16 2e-2 of max |reference|, one bf16 rounding of each output, with the
JAX side computing its prime-T fallback with bf16-rounded scores. The
plain version that rounds p and ds to bf16 as the port's tensor-core
backward kernels do (``round_to``) is held to the same bf16 bar.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import config as jconfig
from mxnet_tpu.parallel import attention_reference as jattention_reference
from mxnet_tpu.parallel import flash_attention as jflash
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.parallel import attention_reference

# the module (the package's ``flash_attention`` name is the function)
tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")

_BLOCKS = dict(block_q=16, block_k=16, block_q_bwd=16, block_k_bwd=16)


def _inputs(B, H, T, D, seed, with_dlse):
    r = np.random.RandomState(seed)
    q, k, v, do = (r.randn(B, H, T, D).astype(np.float32) for _ in range(4))
    dlse = (r.randn(B, H, T).astype(np.float32) if with_dlse
            else np.zeros((B, H, T), np.float32))
    return q, k, v, do, dlse


def _jax_side(q, k, v, do, dlse, causal, dtype):
    """(o, lse, dq, dk, dv) of the Pallas kernels, interpreted; one jit
    around the vjp (eager dispatch compiles op by op, several times
    slower). Flags are read while it traces."""
    fn = functools.partial(jflash, causal=causal, interpret=True,
                           return_lse=True, **_BLOCKS)

    @jax.jit
    def fwd_bwd(q, k, v, do, dlse):
        (o, lse), vjp = jax.vjp(fn, q, k, v)
        return (o, lse) + tuple(vjp((do, dlse)))

    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v, do)]
    with jax.default_matmul_precision("highest"):
        outs = fwd_bwd(*args, jnp.asarray(dlse))
    return [np.asarray(a, np.float32) for a in outs]


def _torch_side(q, k, v, do, dlse, causal, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in
              (q, k, v)]
    o, lse = tfa.flash_attention(*leaves, causal=causal, return_lse=True)
    outs, cots = [o], [torch.from_numpy(do).to(dtype)]
    if dlse.any():  # else lse gets no cotangent at all (dlse is None)
        outs.append(lse)
        cots.append(torch.from_numpy(dlse))
    torch.autograd.backward(outs, cots)
    return [a.detach().float().numpy() for a in
            [o, lse] + [t.grad for t in leaves]]


def _assert_close(ours, ref, dtype, what):
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), ours, ref):
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg="%s %s" % (what, name))
        else:
            err = float(np.abs(a - b).max())
            assert err <= 2e-2 * max(1.0, float(np.abs(b).max())), \
                (what, name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_pallas_interpret(causal, dtype):
    # the causal cases carry an lse cotangent, which the Pallas backward
    # folds into delta; the others give lse no cotangent at all
    ins = _inputs(2, 2, 32, 16, seed=0, with_dlse=causal)
    ref = _jax_side(*ins, causal, getattr(jnp, dtype))
    ours = _torch_side(*ins, causal, getattr(torch, dtype))
    _assert_close(ours, ref, dtype, "causal=%s" % causal)


def test_flash_prime_T_lse_cotangent():
    # T = 37 has no block divisor: the JAX package takes _dense_with_lse
    # and autodiff, the port still its kernels' (plain) forms
    ins = _inputs(1, 2, 37, 8, seed=37, with_dlse=True)
    ref = _jax_side(*ins, True, jnp.float32)
    ours = _torch_side(*ins, True, torch.float32)
    _assert_close(ours, ref, "float32", "T=37")


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("T", [17, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_rounding_plain_backward_matches_pallas_interpret(causal, T, D):
    # the plain version that rounds p and ds to bf16 where the port's
    # tensor-core backward kernels do (``round_to``) against the Pallas
    # backward in bf16, interpreted (T = 17 has no block divisor: the JAX
    # package's dense fallback), within the bf16 bar
    ins = _inputs(1, 2, T, D, seed=T + D, with_dlse=causal)
    ref = _jax_side(*ins, causal, jnp.bfloat16)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in ins[:4])
    scale = D ** -0.5
    o, lse = tfa.flash_forward(q, k, v, causal, scale)
    delta = ((do.float() * o.float()).sum(-1)
             - torch.from_numpy(ins[4])).contiguous()
    dq = tfa.flash_backward_dq_reference(q, k, v, do, lse, delta, causal,
                                         scale, round_to=torch.bfloat16)
    dk, dv = tfa.flash_backward_dkv_reference(q, k, v, do, lse, delta,
                                              causal, scale,
                                              round_to=torch.bfloat16)
    ours = [o, lse, dq, dk, dv]
    assert all(t.dtype == torch.bfloat16 for t in (o, dq, dk, dv))
    _assert_close([t.float().numpy() for t in ours], ref, "bfloat16",
                  "rounding plain T=%d D=%d causal=%s" % (T, D, causal))


def test_flash_bwd_escape_hatch(monkeypatch):
    # MXNET_FLASH_ATTENTION_BWD=0 on both sides: dense autodiff of the
    # plain formula, and the port never calls its backward kernels
    def boom(*args, **kwargs):
        raise AssertionError("backward kernel called under the hatch")

    monkeypatch.setattr(tfa, "flash_backward_dq", boom)
    monkeypatch.setattr(tfa, "flash_backward_dkv", boom)
    ins = _inputs(1, 2, 32, 16, seed=5, with_dlse=True)
    jconfig.set_flag("MXNET_FLASH_ATTENTION_BWD", 0)
    tconfig.set_flag("MXNET_FLASH_ATTENTION_BWD", 0)
    try:
        ref = _jax_side(*ins, True, jnp.float32)
        ours = _torch_side(*ins, True, torch.float32)
    finally:
        jconfig.set_flag("MXNET_FLASH_ATTENTION_BWD", None)
        tconfig.set_flag("MXNET_FLASH_ATTENTION_BWD", None)
    _assert_close(ours, ref, "float32", "hatch")


def test_flash_residuals_are_linear_in_T():
    # the autograd.Function saves q, k, v, o and lse: nothing T x T
    T = 40
    leaves = [torch.randn(1, 2, T, 8, requires_grad=True) for _ in range(3)]
    out = tfa.flash_attention(*leaves, causal=True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    assert all(t.shape[-1] != T or t.dim() == 3 for t in saved), \
        [tuple(t.shape) for t in saved]


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    q, k, v, _, _ = _inputs(2, 2, 24, 8, seed=7, with_dlse=False)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jattention_reference(q, k, v, causal=causal))
    out = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _jax_forward(q, k, v, causal, dtype):
    """(o, lse) of the Pallas forward in ``dtype``, interpreted."""
    fn = jax.jit(functools.partial(jflash, causal=causal, interpret=True,
                                   return_lse=True, **_BLOCKS))
    with jax.default_matmul_precision("highest"):
        outs = fn(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)))
    return [np.asarray(a, np.float32) for a in outs]


def _masked_first_keys(q, k, n):
    """q > 0 and the first n keys -inf in every feature: those scores are
    -inf, so the first key tile is wholly masked for every row, and with
    causal the rows before n see no live key at all."""
    q = np.abs(q) + 0.1
    k = k.copy()
    k[:, :, :n] = -np.inf
    return q, k


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [17, 129])
@pytest.mark.parametrize("causal", [False, True])
def test_tiled_forward_plain_matches_dense(causal, T, masked):
    # the tensor-core forward's tiled walk (online softmax over 64-key
    # tiles), rounding p to fp32 (no rounding), against the dense plain
    # version, within 1e-6 fp32; with the first keys masked, the guards:
    # rows that see no live key give lse = -inf and a zero output
    q, k, v, _, _ = _inputs(1, 2, T, 32, seed=T, with_dlse=False)
    if masked:
        q, k = _masked_first_keys(q, k, min(T, 64))
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    scale = 32 ** -0.5
    o, lse = tfa.flash_forward_reference(q, k, v, causal, scale,
                                         round_to=torch.float32)
    ro, rlse = tfa.flash_forward_reference(q, k, v, causal, scale)
    torch.testing.assert_close(o, ro, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=1e-6)
    if masked:
        dead = torch.isneginf(rlse)
        assert bool(dead.any()) == (causal or T <= 64)
        assert torch.isneginf(lse[dead]).all()
        assert (o[dead] == 0).all() and torch.isfinite(o).all()


@pytest.mark.parametrize("T", [17, 129])
@pytest.mark.parametrize("causal", [False, True])
def test_rounding_plain_forward_matches_pallas_interpret(causal, T):
    # the plain version that rounds p to bf16 where the port's tensor-core
    # forward does (``round_to``) against the Pallas forward in bf16,
    # interpreted, within the bf16 bar
    q, k, v, _, _ = _inputs(1, 2, T, 32, seed=T + 1, with_dlse=False)
    ref = _jax_forward(q, k, v, causal, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o, lse = tfa.flash_forward_reference(tq, tk, tv, causal, 32 ** -0.5,
                                         round_to=torch.bfloat16)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    for name, a, b in (("o", o, ref[0]), ("lse", lse, ref[1])):
        a = a.float().numpy()
        err = float(np.abs(a - b).max())
        assert err <= 2e-2 * max(1.0, float(np.abs(b).max())), \
            (T, causal, name, err)

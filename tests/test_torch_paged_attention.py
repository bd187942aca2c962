"""Port parity: the generation slice's attention and forwards
(``mxnet_tpu_torch/parallel/flash_attention.py`` ``paged_decode_attention`` /
``paged_verify_attention``, ``mxnet_tpu_torch/parallel/transformer.py``
``prefill_forward`` / ``decode_forward`` / ``verify_forward``) against the
JAX package's on the CPU, from the same numpy inputs.

Tolerances: the paged functions within 1e-6 (both fp32 online softmax over
the same blocks); the forwards within 1e-5 of each tensor's max |value| in
fp32 and 2e-2 in bf16 (XLA on the CPU rounds intermediates to bf16 where
torch does not, as in ``test_torch_transformer.py``).
"""
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.transformer import TransformerParallel as JTP
from mxnet_tpu_torch.parallel import TransformerParallel, make_mesh

JFA = importlib.import_module("mxnet_tpu.parallel.flash_attention")
FA = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")

_CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            n_experts=2)
_DTYPES = {"float32": np.dtype(np.float32),
           "bfloat16": np.dtype(ml_dtypes.bfloat16)}
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PAGED_TOL = 1e-6


def _pool(seed, S=3, Q=4, H=2, d=8, page=4, n_pages=4, pool=16):
    rng = np.random.RandomState(seed)
    k = rng.randn(pool, page, H, d).astype(np.float32)
    v = rng.randn(pool, page, H, d).astype(np.float32)
    table = rng.choice(np.arange(1, pool), S * n_pages,
                       replace=False).reshape(S, n_pages).astype(np.int32)
    q = rng.randn(S, Q, H, d).astype(np.float32)
    return q, k, v, table


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.mark.parametrize("blocks", [None, 4, 8, 16])
def test_paged_decode_attention_matches_jax(blocks):
    q, k, v, table = _pool(0)
    q = q[:, 0]
    lengths = np.array([0, 7, 16], np.int32)   # slot 0: no live key
    want = np.asarray(JFA.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lengths), block_tokens=blocks))
    got = FA.paged_decode_attention(_t(q), _t(k), _t(v), _t(table),
                                    _t(lengths), block_tokens=blocks)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PAGED_TOL)
    assert not got[0].any(), "a slot of length 0 gives zeros"


@pytest.mark.parametrize("blocks", [None, 4, 8, 16])
def test_paged_verify_attention_matches_jax(blocks):
    q, k, v, table = _pool(1)
    lengths = np.array([0, 5, 12], np.int32)
    want = np.asarray(JFA.paged_verify_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lengths), block_tokens=blocks))
    got = FA.paged_verify_attention(_t(q), _t(k), _t(v), _t(table),
                                    _t(lengths), block_tokens=blocks)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PAGED_TOL)
    # query i of the verify step is the decode step at length + 1 + i
    for i in range(q.shape[1]):
        one = FA.paged_decode_attention(_t(q[:, i]), _t(k), _t(v), _t(table),
                                        _t(lengths + 1 + i),
                                        block_tokens=blocks)
        np.testing.assert_allclose(got[:, i].numpy(), one.numpy(), rtol=0,
                                   atol=PAGED_TOL)


def test_paged_attention_keeps_fp32_arithmetic_for_bf16_pages():
    q, k, v, table = _pool(2)
    lengths = np.array([3, 9, 16], np.int32)
    bf = lambda a: _t(a).to(torch.bfloat16)  # noqa: E731
    got = FA.paged_decode_attention(bf(q[:, 0]), bf(k), bf(v), _t(table),
                                    _t(lengths), block_tokens=8)
    # the same rounded inputs in fp32 give the same output, rounded once
    ref = FA.paged_decode_attention(bf(q[:, 0]).float(), bf(k).float(),
                                    bf(v).float(), _t(table), _t(lengths),
                                    block_tokens=8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.to(torch.bfloat16))


def test_paged_attention_int8_scales_not_ported():
    """The int8 pool mode is ported: unit scales over int8 pages equal the
    same pages in fp32, for decode and verify alike, and a k-only scale
    dequantizes only the keys."""
    q, k, v, table = _pool(3)
    k8 = np.clip(np.round(k * 20), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(v * 20), -127, 127).astype(np.int8)
    ones = torch.ones(k.shape[:3])
    lengths = torch.tensor([0, 5, 13], dtype=torch.int32)
    got = FA.paged_decode_attention(_t(q[:, 0]), _t(k8), _t(v8), _t(table),
                                    lengths, k_scale=ones, v_scale=ones)
    want = FA.paged_decode_attention(_t(q[:, 0]), _t(k8).float(),
                                     _t(v8).float(), _t(table), lengths)
    assert torch.equal(got, want)
    got = FA.paged_verify_attention(_t(q), _t(k8), _t(v8), _t(table),
                                    lengths, k_scale=2 * ones)
    want = FA.paged_verify_attention(_t(q), 2 * _t(k8).float(),
                                     _t(v8).float(), _t(table), lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=PAGED_TOL)


# --------------------------------------------------------------- forwards

def _models(dtype):
    jmesh = jmake_mesh({"dp": 1}, devices=jax.devices("cpu")[:1])
    jtp = JTP(jmesh, dtype=_DTYPES[dtype], **_CFG)
    ttp = TransformerParallel(make_mesh({"dp": 1}, devices=[mx.cpu()]),
                              dtype=_DTYPES[dtype], **_CFG)
    return jtp, jtp.init(0), ttp, ttp.init(0)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_forward_matches_jax(dtype):
    jtp, jparams, ttp, tparams = _models(dtype)
    tokens = np.random.RandomState(0).randint(0, 64, (2, 16)).astype(
        np.int32)
    jl, jk, jv = jtp.prefill_forward(jparams, tokens)
    with torch.no_grad():
        tl, tk, tv = ttp.prefill_forward(tparams, tokens)
    assert tl.dtype == torch.float32 and tk.dtype == ttp.dtype
    assert tuple(tk.shape) == (2, 2, 16, 4, 8)
    for what, got, want in (("logits", tl, jl), ("ks", tk, jk),
                            ("vs", tv, jv)):
        _close(_np(got), _np(want), _TOL[dtype], what)


def _hooks(jtp, ttp, pool_np, table, lengths, verify):
    """The same attention hook in both packages: scatter the new K/V into
    a copy of one page pool at each slot's next positions, then attend
    with the paged function. Returns (jax hook, torch hook)."""
    page = pool_np["k"].shape[2]
    S, Q = table.shape[0], (verify or 1)
    pos = lengths[:, None] + np.arange(Q)[None, :]
    dest = table[np.arange(S)[:, None], pos // page]
    off = pos % page
    jstate = {n: jnp.asarray(a) for n, a in pool_np.items()}
    tstate = {n: _t(a).to(ttp.dtype) for n, a in pool_np.items()}
    jstate = {n: a.astype(jtp.dtype) for n, a in jstate.items()}

    def jattend(li, q, k_new, v_new):
        kn = k_new if verify else k_new[:, None]
        vn = v_new if verify else v_new[:, None]
        jstate["k"] = jstate["k"].at[li, dest, off].set(kn)
        jstate["v"] = jstate["v"].at[li, dest, off].set(vn)
        fn = JFA.paged_verify_attention if verify else \
            JFA.paged_decode_attention
        return fn(q, jstate["k"][li], jstate["v"][li], jnp.asarray(table),
                  jnp.asarray(lengths if verify else lengths + 1),
                  block_tokens=8)

    def tattend(li, q, k_new, v_new):
        kn = k_new if verify else k_new[:, None]
        vn = v_new if verify else v_new[:, None]
        tstate["k"][li][_t(dest).long(), _t(off).long()] = kn
        tstate["v"][li][_t(dest).long(), _t(off).long()] = vn
        fn = FA.paged_verify_attention if verify else \
            FA.paged_decode_attention
        return fn(q, tstate["k"][li], tstate["v"][li], _t(table),
                  _t(lengths if verify else lengths + 1), block_tokens=8)

    return jattend, tattend


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("verify", [0, 3])
def test_decode_and_verify_forward_match_jax(dtype, verify):
    jtp, jparams, ttp, tparams = _models(dtype)
    rng = np.random.RandomState(4 + verify)
    L, page, n_pages, S = 2, 8, 4, 3
    pool_np = {n: (rng.randn(L, 1 + S * n_pages, page, 4, 8) * 0.5).astype(
        np.float32) for n in ("k", "v")}
    table = (1 + np.arange(S * n_pages)).reshape(S, n_pages).astype(np.int32)
    lengths = np.array([0, 6, 20], np.int32)
    jattend, tattend = _hooks(jtp, ttp, pool_np, table, lengths, verify)
    if verify:
        tokens = rng.randint(0, 64, (S, verify)).astype(np.int32)
        want = jtp.verify_forward(jparams, tokens, jattend)
        with torch.no_grad():
            got = ttp.verify_forward(tparams, tokens, tattend)
    else:
        tokens = rng.randint(0, 64, S).astype(np.int32)
        want = jtp.decode_forward(jparams, tokens, jattend)
        with torch.no_grad():
            got = ttp.decode_forward(tparams, tokens, tattend)
    assert got.dtype == torch.float32
    _close(_np(got), _np(want), _TOL[dtype], "logits")


def test_prefill_attention_is_the_dense_fp32_formula_on_the_cpu():
    """Off the card the prefill attends with the reference's dense fp32
    softmax (not the flash plain version), the discipline the decode step
    shares."""
    from mxnet_tpu.parallel.transformer import _prefill_attention as jpa
    from mxnet_tpu_torch.parallel.transformer import _prefill_attention

    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 3, 33, 8).astype(np.float32) for _ in range(3))
    want = np.asarray(jpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = _prefill_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PAGED_TOL)

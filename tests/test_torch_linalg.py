"""Port parity for the ``linalg_*`` ops of ``mxnet_tpu_torch/ops/linalg.py``
on the CPU (LAPACK through ``torch.linalg``), against the JAX package's on
the same seeded numpy inputs.

Each case runs the op in both packages under ``autograd.record()``, then
backward with the same seeded head gradients: outputs and input gradients
within 1e-5 of each tensor's max (fp32). The factorizations are held where
their gradients are defined: SPD inputs for the Cholesky family,
well-conditioned lower-triangular factors for the solves, full-rank wide
matrices for ``gelqf``. ``syevd``'s eigenvectors are unique up to the sign
of each row, which is each library's own: they are held up to that sign,
the reconstruction ``U^T diag(L) U`` to 1e-5, and the gradient of a loss
that does not see the signs (the eigenvalues and the reconstruction) at
distinct eigenvalues.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what="", tol=TOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * (scale if scale > 0 else 1.0), \
        "%s: %.3g against max %.3g" % (what, err, scale)


def _run(mx, op, arrays, attrs, seed=7, heads=True):
    ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
    ins = [mx.nd.array(a, **ctx) for a in arrays]
    for a in ins:
        a.attach_grad()
    with mx.autograd.record():
        out = getattr(mx.nd, op)(*ins, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    values = [o.asnumpy() for o in outs]
    rng = np.random.RandomState(seed)
    mx.autograd.backward(outs, [
        mx.nd.array(rng.randn(*v.shape).astype(np.float32), **ctx)
        for v in values])
    return values, [a.grad.asnumpy() for a in ins]


def _rs(seed):
    return np.random.RandomState(seed)


def _randn(seed, *shape):
    return _rs(seed).randn(*shape).astype(np.float32)


def _spd(seed, *batch_n):
    *batch, n = batch_n
    a = _randn(seed, *batch, n, n)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)) \
        .astype(np.float32)


def _lower(seed, *batch_n):
    """A well-conditioned lower-triangular factor."""
    *batch, n = batch_n
    a = np.tril(_randn(seed, *batch, n, n)) * 0.3
    return (a + 2 * np.eye(n, dtype=np.float32)).astype(np.float32)


def _tri_cases():
    out = []
    for op in ("linalg_trmm", "linalg_trsm"):
        for transpose in (False, True):
            for rightside in (False, True):
                b = (2, 5, 3) if rightside else (2, 3, 5)
                out.append(pytest.param(
                    op, lambda b=b: [_lower(11, 2, 3), _randn(12, *b)],
                    dict(transpose=transpose, rightside=rightside,
                         alpha=0.7),
                    id="%s-t%d-r%d" % (op[7:], transpose, rightside)))
    return out


CASES = [
    pytest.param("linalg_gemm",
                 lambda: [_randn(1, 3, 4), _randn(2, 4, 5), _randn(3, 3, 5)],
                 dict(alpha=1.5, beta=0.5), id="gemm"),
    pytest.param("linalg_gemm",
                 lambda: [_randn(4, 2, 4, 3), _randn(5, 2, 5, 4),
                          _randn(6, 2, 3, 5)],
                 dict(transpose_a=True, transpose_b=True, alpha=0.3,
                      beta=-1.0), id="gemm-batched-transposed"),
    pytest.param("linalg_gemm2", lambda: [_randn(7, 4, 3), _randn(8, 4, 6)],
                 dict(transpose_a=True, alpha=2.0), id="gemm2-ta"),
    pytest.param("linalg_gemm2",
                 lambda: [_randn(9, 2, 3, 3, 4), _randn(10, 2, 3, 5, 4)],
                 dict(transpose_b=True), id="gemm2-batched-tb"),
    pytest.param("linalg_potrf", lambda: [_spd(13, 4)], {}, id="potrf"),
    pytest.param("linalg_potrf", lambda: [_spd(14, 3, 5)], {},
                 id="potrf-batched"),
    pytest.param("linalg_potri",
                 lambda: [np.linalg.cholesky(_spd(15, 4)).astype(np.float32)],
                 {}, id="potri"),
    pytest.param("linalg_potri", lambda: [_lower(16, 2, 3)], {},
                 id="potri-batched"),
    *_tri_cases(),
    pytest.param("linalg_sumlogdiag", lambda: [_spd(17, 4)], {},
                 id="sumlogdiag"),
    pytest.param("linalg_sumlogdiag", lambda: [_spd(18, 3, 4)], {},
                 id="sumlogdiag-batched"),
    pytest.param("linalg_syrk", lambda: [_randn(19, 3, 5)], dict(alpha=0.5),
                 id="syrk"),
    pytest.param("linalg_syrk", lambda: [_randn(20, 2, 3, 5)],
                 dict(transpose=True), id="syrk-transposed"),
    pytest.param("linalg_gelqf", lambda: [_randn(21, 3, 5)], {}, id="gelqf"),
    pytest.param("linalg_gelqf", lambda: [_randn(22, 2, 4, 4)], {},
                 id="gelqf-batched-square"),
]


@pytest.mark.parametrize("op,make,attrs", CASES)
def test_linalg_op_matches_the_reference(op, make, attrs):
    arrays = make()
    want, want_g = _run(jmx, op, arrays, attrs)
    got, got_g = _run(tmx, op, arrays, attrs)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, "%s out %d" % (op, i))
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        _close(g, w, "%s grad %d" % (op, i))


def test_gelqf_lower_factor_has_a_positive_diagonal():
    q, lower = tmx.nd.linalg_gelqf(tmx.nd.array(_randn(23, 3, 6),
                                                ctx=tmx.cpu()))
    q, lower = q.asnumpy(), lower.asnumpy()
    assert (np.diag(lower) > 0).all()
    np.testing.assert_allclose(lower @ q, _randn(23, 3, 6), atol=1e-5)
    np.testing.assert_allclose(q @ q.T, np.eye(3), atol=1e-5)


def _distinct_spd(seed, *batch_n):
    """Symmetric, eigenvalues 1, 2, ..., n (well apart)."""
    *batch, n = batch_n
    q, _ = np.linalg.qr(_randn(seed, *batch, n, n).astype(np.float64))
    w = np.arange(1, n + 1, dtype=np.float64)
    return ((q * w[..., None, :]) @ np.swapaxes(q, -1, -2)).astype(np.float32)


def _syevd_run(mx, a, seed):
    ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
    x = mx.nd.array(a, **ctx)
    x.attach_grad()
    rng = np.random.RandomState(seed)
    cw = mx.nd.array(rng.randn(*a.shape[:-1]).astype(np.float32), **ctx)
    cr = mx.nd.array(rng.randn(*a.shape).astype(np.float32), **ctx)
    with mx.autograd.record():
        u, lam = mx.nd.linalg_syevd(x)
        # U^T diag(L) U and L: neither sees an eigenvector's sign
        recon = mx.nd.linalg_gemm2(u * mx.nd.expand_dims(lam, axis=-1), u,
                                   transpose_a=True)
        loss = (lam * cw).sum() + (recon * cr).sum()
    loss.backward()
    return u.asnumpy(), lam.asnumpy(), recon.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("shape", [(4,), (2, 5)], ids=["single", "batched"])
def test_syevd_matches_the_reference_up_to_sign(shape):
    a = _distinct_spd(24, *shape)
    ju, jl, jr, jg = _syevd_run(jmx, a, 25)
    tu, tl, tr, tg = _syevd_run(tmx, a, 25)
    _close(tl, jl, "eigenvalues")
    # each eigenvector row up to its sign
    sign = np.sign(np.sum(tu * ju, axis=-1, keepdims=True))
    assert (np.abs(sign) == 1).all()
    _close(tu * sign, ju, "eigenvector rows up to sign")
    _close(tr, a, "reconstruction")
    _close(tr, jr, "reconstruction against the reference's")
    _close(tg, jg, "gradient")


def test_linalg_names_are_the_reference_registry_names():
    for la in ("gemm", "gemm2", "potrf", "potri", "trmm", "trsm",
               "sumlogdiag", "syrk", "gelqf", "syevd"):
        op = tmx.ops.registry.get_op("linalg_" + la)
        assert tmx.ops.registry.get_op("_linalg_" + la) is op
        assert hasattr(tmx.nd, "linalg_" + la)
        assert hasattr(tmx.sym, "linalg_" + la)

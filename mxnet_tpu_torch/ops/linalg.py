"""Linear-algebra ops: ``linalg_gemm``, ``gemm2``, ``potrf``, ``potri``,
``trmm``, ``trsm``, ``sumlogdiag``, ``syrk``, ``gelqf`` and ``syevd``.

Counterpart of ``mxnet_tpu/ops/linalg.py`` (reference: la_op.cc), batched
over every leading dimension. The products are ``torch.matmul`` (as the JAX
package's are ``jnp.matmul``: none was a Pallas kernel) and the
factorizations ``torch.linalg`` (cuSOLVER on the card, LAPACK on the
CPU). Gradients are torch's autograd, as the JAX package's are its
autodiff. Where the JAX call reads one triangle (``triangular_solve``,
``tril``) the op masks its input the same way, and where it symmetrizes
(``jnp.linalg.cholesky`` and ``eigh`` average ``A`` with its transpose)
so does the op, so the gradients agree off the triangle too.
"""
from __future__ import annotations

import torch

from .param import Bool, Float
from .registry import register_op


def _t(x, do):
    return x.transpose(-1, -2) if do else x


def _sym(a):
    return (a + a.transpose(-1, -2)) / 2


def _gemm(attrs, A, B, C):
    out = attrs.alpha * torch.matmul(_t(A, attrs.transpose_a),
                                     _t(B, attrs.transpose_b))
    return out + attrs.beta * C


def _gemm2(attrs, A, B):
    return attrs.alpha * torch.matmul(_t(A, attrs.transpose_a),
                                      _t(B, attrs.transpose_b))


def _mn(attrs, a, b):
    m = a[-1] if attrs.transpose_a else a[-2]
    n = b[-2] if attrs.transpose_b else b[-1]
    return tuple(a[:-2]) + (m, n)


def _gemm_infer(attrs, in_shapes, aux_shapes):
    a, b = in_shapes[0], in_shapes[1]
    if a is None or b is None:
        return None
    out = _mn(attrs, a, b)
    return ([a, b, out], [out], aux_shapes)


def _gemm2_infer(attrs, in_shapes, aux_shapes):
    a, b = in_shapes[0], in_shapes[1]
    if a is None or b is None:
        return None
    return ([a, b], [_mn(attrs, a, b)], aux_shapes)


def _same_infer(attrs, in_shapes, aux_shapes):
    a = in_shapes[0]
    return None if a is None else ([a], [a], aux_shapes)


def _potrf(attrs, A):
    return torch.linalg.cholesky(_sym(A))


def _potri(attrs, A):
    """``B^-1`` from B's lower Cholesky factor ``A``: ``A^-T A^-1``."""
    return torch.cholesky_inverse(torch.tril(A))


def _tri_infer(attrs, in_shapes, aux_shapes):
    b = in_shapes[1]
    return None if b is None else ([in_shapes[0], b], [b], aux_shapes)


def _trmm(attrs, A, B):
    op_a = _t(torch.tril(A), attrs.transpose)
    out = torch.matmul(B, op_a) if attrs.rightside else torch.matmul(op_a, B)
    return attrs.alpha * out


def _trsm(attrs, A, B):
    """Solve ``op(A) X = alpha B`` (``X op(A) = alpha B`` on the right side)
    with lower-triangular ``A``."""
    a = torch.tril(A)
    if attrs.transpose:
        a = a.transpose(-1, -2)
    return torch.linalg.solve_triangular(a, attrs.alpha * B,
                                         upper=bool(attrs.transpose),
                                         left=not attrs.rightside)


def _sumlogdiag(attrs, A):
    out = torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)
    # a single matrix gives shape (1,), as the reference's output shape
    return out.reshape(1) if A.dim() == 2 else out


def _sumlogdiag_infer(attrs, in_shapes, aux_shapes):
    a = in_shapes[0]
    if a is None:
        return None
    return ([a], [tuple(a[:-2]) if len(a) > 2 else (1,)], aux_shapes)


def _syrk(attrs, A):
    return attrs.alpha * torch.matmul(_t(A, attrs.transpose),
                                      _t(A, not attrs.transpose))


def _syrk_infer(attrs, in_shapes, aux_shapes):
    a = in_shapes[0]
    if a is None:
        return None
    n = a[-1] if attrs.transpose else a[-2]
    return ([a], [tuple(a[:-2]) + (n, n)], aux_shapes)


def _gelqf(attrs, A):
    """``A = L Q`` from the QR of ``A^T``, signs fixed so diag(L) > 0 (as
    LAPACK's orglq leaves them)."""
    q_t, r = torch.linalg.qr(_t(A, True), mode="reduced")
    sign = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign).to(A.dtype)
    q = _t(q_t * sign[..., None, :], True)
    lower = _t(r, True) * sign[..., None, :]
    return q, lower


def _gelqf_infer(attrs, in_shapes, aux_shapes):
    a = in_shapes[0]
    if a is None:
        return None
    return ([a], [a, tuple(a[:-2]) + (a[-2], a[-2])], aux_shapes)


def _syevd(attrs, A):
    """``A = U^T diag(L) U``: the eigenvectors are U's rows (each one's
    sign is the library's)."""
    w, v = torch.linalg.eigh(_sym(A))
    return _t(v, True), w


def _syevd_infer(attrs, in_shapes, aux_shapes):
    a = in_shapes[0]
    return None if a is None else ([a], [a, tuple(a[:-1])], aux_shapes)


def _register():
    flags = {"transpose_a": Bool(default=False),
             "transpose_b": Bool(default=False),
             "alpha": Float(default=1.0)}
    tri = {"transpose": Bool(default=False),
           "rightside": Bool(default=False), "alpha": Float(default=1.0)}
    register_op("linalg_gemm", _gemm,
                params=dict(flags, beta=Float(default=1.0)), num_inputs=3,
                input_names=["A", "B", "C"], infer_shape=_gemm_infer,
                doc="alpha*op(A)op(B) + beta*C, batched")
    register_op("linalg_gemm2", _gemm2, params=flags, num_inputs=2,
                input_names=["A", "B"], infer_shape=_gemm2_infer,
                doc="alpha*op(A)op(B), batched")
    register_op("linalg_potrf", _potrf, num_inputs=1, input_names=["A"],
                infer_shape=_same_infer,
                doc="lower Cholesky factor of an SPD matrix")
    register_op("linalg_potri", _potri, num_inputs=1, input_names=["A"],
                infer_shape=_same_infer,
                doc="inverse of B = A A^T from its Cholesky factor A")
    register_op("linalg_trmm", _trmm, params=dict(tri), num_inputs=2,
                input_names=["A", "B"], infer_shape=_tri_infer,
                doc="alpha*op(A)B (or B op(A)), A lower-triangular")
    register_op("linalg_trsm", _trsm, params=dict(tri), num_inputs=2,
                input_names=["A", "B"], infer_shape=_tri_infer,
                doc="solve op(A) X = alpha B (or X op(A) = alpha B)")
    register_op("linalg_sumlogdiag", _sumlogdiag, num_inputs=1,
                input_names=["A"], infer_shape=_sumlogdiag_infer,
                doc="sum(log(diag(A))) per matrix")
    register_op("linalg_syrk", _syrk,
                params={"transpose": Bool(default=False),
                        "alpha": Float(default=1.0)},
                num_inputs=1, input_names=["A"], infer_shape=_syrk_infer,
                doc="alpha*A op(A)^T")
    register_op("linalg_gelqf", _gelqf, num_inputs=1, num_outputs=2,
                input_names=["A"], infer_shape=_gelqf_infer,
                doc="LQ factorization A = L Q, diag(L) > 0")
    register_op("linalg_syevd", _syevd, num_inputs=1, num_outputs=2,
                input_names=["A"], infer_shape=_syevd_infer,
                doc="symmetric eigendecomposition A = U^T diag(L) U")


_register()

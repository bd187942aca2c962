"""Port parity: the fused matmul and batched matmul + epilogue
(mxnet_tpu_torch/parallel/fused.py) against the JAX package's Pallas
kernels, run in interpret mode as tests/test_fusion.py runs them on the
CPU, and the ``_FusedRegion`` autograd Function's gradients against
autograd of the reference composition.

Tolerance rtol = atol = 1e-5 in fp32: both sides accumulate fp32 products
of the same fp32 inputs, in a different summation order. bf16 2e-2: the
output is rounded once to bf16 (8 bits of mantissa) on both sides.
Region gradients rtol 1e-5, atol 1e-6: the same fp32 ops.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.fused import EPILOGUE_ACTS
from mxnet_tpu.parallel import fused as jfused
from mxnet_tpu_torch import cuda_build
from mxnet_tpu_torch.parallel import fused as tfused

_EPILOGUES = [
    (("bias",), ("act", "relu")),
    (("vmul",), ("vadd",)),
    (("scalar", "_div_scalar", 2.0), ("res", "elemwise_add")),
    (("act", "sigmoid"),),
]


def _inputs(rng, M, N, K, wt, epilogue):
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(N, K) if wt else rng.randn(K, N)).astype(np.float32)
    extras = []
    for s in epilogue:
        if s[0] in ("bias", "vmul", "vadd"):
            extras.append(rng.randn(N).astype(np.float32))
        elif s[0] == "res":
            extras.append(rng.randn(M, N).astype(np.float32))
    return x, w, extras


def _both(x, w, extras, epilogue, wt):
    ref = jfused.fused_matmul(x, w, extras=extras, epilogue=epilogue, wt=wt,
                              block_m=8, block_n=8, block_k=16,
                              interpret=True)
    assert ref is not None
    out = tfused.fused_matmul(torch.from_numpy(x), torch.from_numpy(w),
                              extras=[torch.from_numpy(e) for e in extras],
                              epilogue=epilogue, wt=wt)
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("wt", [True, False])
@pytest.mark.parametrize("epilogue", _EPILOGUES)
def test_fused_matmul_matches_pallas_interpret(wt, epilogue):
    rng = np.random.RandomState(3)
    x, w, extras = _inputs(rng, 16, 8, 32, wt, epilogue)
    ref, out = _both(x, w, extras, epilogue, wt)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("epilogue", [
    (("res", "elemwise_add"),),
    (("bias",), ("act", "relu")),
])
def test_fused_matmul_ragged_rows(epilogue):
    # M = 49 is the bucket-1 stage-4 row count of ResNet-50 (7 x 7)
    rng = np.random.RandomState(5)
    x, w, extras = _inputs(rng, 49, 24, 48, False, epilogue)
    ref, out = _both(x, w, extras, epilogue, False)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_fused_matmul_activations(act):
    rng = np.random.RandomState(7)
    epilogue = (("scalar", "_mul_scalar", 0.5), ("act", act),
                ("scalar", "_rminus_scalar", 1.0))
    x, w, extras = _inputs(rng, 16, 16, 32, True, epilogue)
    ref, out = _both(x, w, extras, epilogue, True)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_activation_sets_agree():
    assert tfused._ACTS == EPILOGUE_ACTS == jfused._ACTS


def test_cpu_tensors_take_the_plain_version():
    cuda_build.reset_launch_counts()
    x = torch.randn(8, 4)
    w = torch.randn(4, 6)
    out = tfused.fused_matmul(x, w, epilogue=(("act", "relu"),), wt=False)
    torch.testing.assert_close(out, torch.relu(x @ w))
    assert cuda_build.launch_counts().get("fused_matmul", 0) == 0


def test_extra_count_mismatch_raises():
    with pytest.raises(ValueError):
        tfused.fused_matmul(torch.zeros(2, 3), torch.zeros(4, 3),
                            epilogue=(("bias",),), wt=True)


# ------------------------------------------------- fused_batch_matmul

_BMM_EPILOGUES = [
    # tests/test_fusion.py's batched case
    (("scalar", "_mul_scalar", 0.5), ("res", "elemwise_add"),
     ("act", "relu")),
    # the attention block's two regions: scores / sqrt(D), context + x
    (("scalar", "_div_scalar", 2.0),),
    (("res", "elemwise_add"),),
    (("res", "elemwise_mul"), ("act", "tanh")),
    (("act", "sigmoid"), ("scalar", "_rminus_scalar", 1.0)),
]


def _bmm_inputs(rng, B, M, N, K, epilogue):
    x = rng.randn(B, M, K).astype(np.float32)
    w = rng.randn(B, K, N).astype(np.float32)
    extras = [rng.randn(B, M, N).astype(np.float32)
              for s in epilogue if s[0] == "res"]
    return x, w, extras


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", _BMM_EPILOGUES)
def test_fused_batch_matmul_matches_pallas_interpret(dtype, epilogue):
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    x, w, extras = _bmm_inputs(rng, 3, 8, 8, 16, epilogue)
    jd = jnp.dtype(dtype)
    ref = jfused.fused_batch_matmul(
        jnp.asarray(x, jd), jnp.asarray(w, jd),
        extras=[jnp.asarray(e, jd) for e in extras], epilogue=epilogue,
        block_m=4, block_n=4, block_k=8, interpret=True)
    assert ref is not None
    td = getattr(torch, dtype)
    out = tfused.fused_batch_matmul(
        torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
        extras=[torch.from_numpy(e).to(td) for e in extras],
        epilogue=epilogue)
    assert out.dtype == td and tuple(out.shape) == (3, 8, 8)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_fused_batch_matmul_cast_step():
    import jax.numpy as jnp

    rng = np.random.RandomState(8)
    epilogue = (("res", "elemwise_add"), ("cast", "bfloat16"))
    x, w, extras = _bmm_inputs(rng, 2, 8, 16, 8, epilogue)
    ref = jfused.fused_batch_matmul(x, w, extras=extras, epilogue=epilogue,
                                    block_m=4, block_n=8, block_k=8,
                                    out_dtype=jnp.bfloat16, interpret=True)
    out = tfused.fused_batch_matmul(
        torch.from_numpy(x), torch.from_numpy(w),
        extras=[torch.from_numpy(e) for e in extras], epilogue=epilogue,
        out_dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_fused_batch_matmul_transposed_operand_on_cpu():
    # batch_dot(q, transpose(k)): the w operand is a (0, 2, 1) view
    rng = np.random.RandomState(9)
    q = torch.from_numpy(rng.randn(2, 5, 4).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 7, 4).astype(np.float32))
    kt = k.permute(0, 2, 1)
    assert not kt.is_contiguous()
    out = tfused.fused_batch_matmul(q, kt, epilogue=(
        ("scalar", "_div_scalar", 2.0),))
    torch.testing.assert_close(out, torch.bmm(q, kt) / 2.0, rtol=1e-6,
                               atol=1e-6)


def test_fused_batch_matmul_rejects_vector_steps():
    x = torch.zeros(1, 2, 3)
    w = torch.zeros(1, 3, 4)
    for step in (("bias",), ("vadd",), ("vmul",)):
        with pytest.raises(tfused.MXNetError, match="batched form"):
            tfused.fused_batch_matmul(x, w, [torch.zeros(4)], (step,))


# ---------------------------------- _FusedRegion's autograd Function

def _region_attrs(base_op, base_attrs, steps, n_base):
    import json

    from mxnet_tpu_torch.ops.registry import get_op

    return get_op("_FusedRegion").parse_attrs({
        "base_op": base_op, "base_attrs": json.dumps(base_attrs),
        "epilogue": json.dumps(steps), "n_base": n_base})


_REGIONS = {
    "batch_dot_scores": (
        "batch_dot", {}, [{"op": "_div_scalar", "kind": "scalar",
                           "scalar": 2.0}], [(2, 5, 4), (2, 4, 6)], []),
    "batch_dot_residual": (
        "batch_dot", {}, [{"op": "broadcast_add", "kind": "vec", "slot": 0,
                           "bshape": "full"}],
        [(2, 5, 4), (2, 4, 6)], [(2, 5, 6)]),
    "fc_relu": (
        "FullyConnected", {"num_hidden": "6"},
        [{"op": "Activation", "kind": "act", "act": "relu"}],
        [(5, 4), (6, 4), (6,)], []),
    "fc_sigmoid_residual": (
        "FullyConnected", {"num_hidden": "6", "no_bias": "True"},
        [{"op": "Activation", "kind": "act", "act": "sigmoid"},
         {"op": "elemwise_mul", "kind": "res", "slot": 1}],
        [(5, 4), (6, 4)], [(5, 6)]),
}


@pytest.mark.parametrize("region", sorted(_REGIONS))
def test_fused_region_gradients(region):
    from mxnet_tpu_torch.ops import fused as ofused

    base_op, battrs, steps, base_shapes, extra_shapes = _REGIONS[region]
    attrs = _region_attrs(base_op, battrs, steps, len(base_shapes))
    rng = np.random.RandomState(10)
    arrays = [rng.randn(*s).astype(np.float32)
              for s in base_shapes + extra_shapes]
    results = []
    for fused in (True, False):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
        if fused:
            out = ofused._fused_region(attrs, *ins)
            assert type(out.grad_fn).__name__ == "_FusedRegionFnBackward"
        else:
            base, battrs_p, steps_p, n = ofused.fused_region_parts(attrs)
            out = ofused._apply_reference(base, battrs_p, steps_p, ins[:n],
                                          ins[n:])
        cot = torch.from_numpy(
            np.random.RandomState(11).randn(*out.shape).astype(np.float32))
        out.backward(cot)
        results.append([out.detach()] + [t.grad for t in ins])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_fused_region_without_grad_skips_the_function():
    from mxnet_tpu_torch.ops import fused as ofused

    base_op, battrs, steps, base_shapes, _ = _REGIONS["fc_relu"]
    attrs = _region_attrs(base_op, battrs, steps, len(base_shapes))
    ins = [torch.ones(*s) for s in base_shapes]
    with torch.inference_mode():
        out = ofused._fused_region(attrs, *ins)
    assert out.grad_fn is None
    torch.testing.assert_close(out, torch.relu(ins[0] @ ins[1].t()
                                               + ins[2]))

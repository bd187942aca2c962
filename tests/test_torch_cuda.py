"""Card-only tests of the port: the CUDA kernels against their plain
versions, the wrappers' checks and launch counters, the served small ResNet
on the card against the same server on the CPU (each bucket of each
replica one CUDA graph: outputs kept apart under a pipeline window,
captures flat under mixed traffic, a replay equal to the eager walk to
the bit, a scale-down that frees its replica, captures beside a
Generator), the flash-attention kernels at small ragged shapes (the
bf16/fp16 backward also against the plain version that rounds p and ds as
it does, and across two launches; and where their bf16 gradients part
from plain attention's), the batched fused matmul on a ragged grid and
through a transposed operand, a Module training step through the
kernels against the same step on the plain composition, and a small
ResNet's ShardedTrainer step captured as a CUDA graph against the same
step run eagerly, and Gluon on the card: a compile_step replay against its
body run eagerly (bit for bit, under cuDNN's deterministic algorithms),
a captured Dropout's fresh masks, a recapture per batch shape, and the
slice's op grid against the CPU, the detection and spatial ops against
the CPU (chip_smoke.py's phase 15 (e) cases) and the model-zoo slice's
ops (linalg, CTC's neighbours, the fork's and the legacy ops; phase 16
(c)), and int8: the exact integer route of the contractions at ResNet-50's
shapes against the CPU bit for bit (also replayed from a CUDA graph),
int8 paged attention against its plain version, and the sampler's draws
against the exact distribution, and the streaming input pipeline's
batches staged on the card against the same iterator's on the CPU, bit
for bit, and resumable training: a ``fit(resume=)`` stopped by SIGTERM
and resumed on the card, bit for bit, and a PythonLossModule's host
labels handed to its gradient beside the scores, and sparse storage: each
sparse function on the card against the CPU, ``dot``, the gradient's row
collapse and ``rsp_add`` repeating bit for bit, the lazy optimizers from
a ``sparse_embedding`` gradient, ``row_sparse_pull``, the native libsvm
parser and ``check_consistency`` over the CPU and the card. Every test
skips where there is no card.

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch with CUDA:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 1e-4 (summation order over K); bf16 2e-2 and fp16 4e-3
(one rounding of the output at that width, relative to the plain version
computed in fp32 from the same rounded inputs). The flash kernels use the
same bars, relative to max |plain|: both sides compute in fp32 from the
same inputs and differ in summation order, then round once; the bf16/fp16
backward kernels also round p and ds once to the input type (a few 1e-3
of max in bf16, inside the bar), and against the plain version that
rounds them too they are held to chip_smoke.py's FLASH_ROUNDED_TOL.
"""
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import cuda_build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import fused as F

FA = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
from chip_smoke import (FLASH_ROUNDED_TOL, RNN_CUDNN_TOL,  # noqa: E402
                        check_flash_forward_rounding, check_flash_rounding)
from tools.port_bf16_study import flash_delta_study  # noqa: E402

pytestmark = pytest.mark.cuda

_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 4e-3}

_EPILOGUES = [
    (("bias",), ("act", "relu")),
    (("res", "elemwise_add"),),
    (("vmul",), ("vadd",), ("act", "softrelu")),
    (("scalar", "_div_scalar", 2.0), ("res", "elemwise_mul"),
     ("act", "tanh")),
    (("act", "sigmoid"), ("scalar", "_rminus_scalar", 1.0)),
    (("act", "softsign"), ("scalar", "_minus_scalar", 0.5)),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _case(M, N, K, wt, epilogue, dtype, gen):
    x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
    w = torch.randn(*((N, K) if wt else (K, N)), device="cuda",
                    generator=gen).to(dtype)
    extras = [torch.randn(*((M, N) if s[0] == "res" else (N,)),
                          device="cuda", generator=gen).to(dtype)
              for s in epilogue if s[0] in ("bias", "vadd", "vmul", "res")]
    return x, w, extras


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_matches_plain(card, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M, N, K in ((49, 96, 80), (130, 64, 64), (7, 3, 1), (200, 257, 33)):
        for wt in (True, False):
            for ep in _EPILOGUES:
                x, w, extras = _case(M, N, K, wt, ep, getattr(torch, dtype),
                                     gen)
                out = F.fused_matmul(x, w, extras, ep, wt)
                ref = F.fused_matmul_reference(x, w, extras, ep, wt)
                torch.cuda.synchronize()
                assert out.dtype == ref.dtype and out.shape == ref.shape
                scale = max(1.0, ref.float().abs().max().item())
                err = (out.float() - ref.float()).abs().max().item()
                assert err <= _TOL[dtype] * scale, (M, N, K, wt, ep, err)


def test_cast_step_and_out_dtype(card):
    gen = torch.Generator(device="cuda").manual_seed(1)
    ep = (("bias",), ("cast", "bfloat16"))
    x, w, extras = _case(33, 40, 50, False, ep, torch.float32, gen)
    out = F.fused_matmul(x, w, extras, ep, wt=False, out_dtype="bfloat16")
    ref = F.fused_matmul_reference(x, w, extras, ep, wt=False,
                                   out_dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                               atol=1e-2)


def test_launch_counter(card):
    x = torch.randn(16, 8, device="cuda")
    w = torch.randn(8, 4, device="cuda")
    cuda_build.reset_launch_counts()
    for _ in range(3):
        F.fused_matmul(x, w, wt=False)
    F.fused_matmul_reference(x, w, wt=False)
    assert cuda_build.launch_counts()["fused_matmul"] == 3


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    x = torch.randn(16, 8, device="cuda")
    w = torch.randn(8, 4, device="cuda")
    with pytest.raises(MXNetError, match="contiguous"):
        F.fused_matmul(x.t().contiguous().t(), w, wt=False)
    with pytest.raises(MXNetError, match="extra input on"):
        F.fused_matmul(x, w, [torch.randn(4)], (("bias",),), wt=False)
    with pytest.raises(MXNetError, match="dtype"):
        F.fused_matmul(x.double(), w.double(), wt=False)
    with pytest.raises(MXNetError, match="epilogue steps"):
        F.fused_matmul(x, w, epilogue=(("act", "relu"),) * 9, wt=False)
    with pytest.raises(MXNetError, match="contract"):
        F.fused_matmul(x, w, wt=True)


def _small_resnet():
    """The served small bottleneck ResNet (NHWC, six kernel-form regions
    per forward) and random weights."""
    sym = mx.models.resnet.resnet(
        units=[1, 1, 1], num_stages=3, filter_list=[16, 32, 64, 128],
        num_classes=10, image_shape=(3, 32, 32), bottle_neck=True,
        layout="NHWC")
    rng = np.random.RandomState(0)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1, 32, 32, 3))
    args = {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if n.endswith("_var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return sym, args, aux


def _small_server(dev, replicas=1, start=True, **cfg):
    sym, args, aux = _small_resnet()
    cfg.setdefault("buckets", (1, 2, 4, 8))
    cfg.setdefault("max_wait_ms", 0)
    return mx.serving.InferenceServer(
        sym, args, aux, data_shapes=[("data", (1, 32, 32, 3))],
        devices=[torch.device(dev)] * replicas, start=start,
        config=mx.serving.ServingConfig(**cfg))


def _images(n, seed):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(
        np.float32)


def test_served_small_resnet_on_card_matches_cpu(card):
    from mxnet_tpu_torch import cuda_graph

    sym, args, aux = _small_resnet()
    x = np.random.RandomState(0).randn(5, 32, 32, 3).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        srv = mx.serving.InferenceServer(
            sym, args, aux, data_shapes=[("data", (1, 32, 32, 3))],
            devices=[torch.device(dev)],
            config=mx.serving.ServingConfig(buckets=(1, 8)))
        try:
            cuda_build.reset_launch_counts()
            outs[dev] = srv.predict(x, timeout=120)
            launches = cuda_build.launch_counts().get("fused_matmul", 0)
            programs = srv.get_stats()["bucket_programs"]
        finally:
            srv.stop()
        # six kernel-form regions per forward on the card, counted in each
        # body run of the one capture (bucket 8); none on the CPU
        assert programs == 1
        assert launches == (6 * (1 + cuda_graph.WARMUP_RUNS)
                            if dev == "cuda" else 0)
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], rtol=1e-4,
                               atol=1e-4)


def test_serving_graph_outputs_survive_the_window(card):
    """One bucket, pipeline_depth 2, different inputs back to back: every
    batch gets its own outputs, though the graph writes the same buffers
    on every replay."""
    xs = [_images(4, 10 + i) for i in range(12)]
    got = {}
    for dev in ("cpu", "cuda"):
        srv = _small_server(dev, buckets=(4,), pipeline_depth=2)
        try:
            got[dev] = [f.result(timeout=120)
                        for f in [srv.submit(x) for x in xs]]
            assert srv.get_stats()["bucket_programs"] == 1
        finally:
            srv.stop()
    for g, w in zip(got["cuda"], got["cpu"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert len({float(g[0, 0]) for g in got["cuda"]}) == len(xs)


def test_stage_pytree_on_the_card(card):
    from mxnet_tpu_torch.runtime.staging import stage_pytree

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = stage_pytree({"x": [a, a * 2]}, card)
    a[0, 0] = 99.0      # the host array may change once staged
    torch.cuda.synchronize()
    assert out["x"][0].device.type == "cuda"
    assert out["x"][0][0, 0].item() == 0.0
    assert torch.equal(out["x"][1].cpu(),
                       torch.arange(12.).reshape(3, 4) * 2)


def test_serving_captures_stay_flat_under_mixed_traffic(card):
    srv = _small_server("cuda", replicas=2)
    ref = _small_server("cpu")
    try:
        assert srv.warmup() == 8
        assert srv.get_stats()["bucket_programs"] == 8
        cuda_build.reset_launch_counts()
        rng = np.random.RandomState(3)
        xs = [_images(int(n), i) for i, n in
              enumerate(rng.randint(1, 13, size=40))]
        outs = [f.result(timeout=120) for f in
                [srv.submit(x) for x in xs]]
        st = srv.get_stats()
        assert st["bucket_programs"] == 8 and st["chunked"] >= 1
        # replays only: the wrapper is never called under traffic
        assert cuda_build.launch_counts().get("fused_matmul", 0) == 0
        for x, out in zip(xs, outs):
            np.testing.assert_allclose(out, ref.predict(x, timeout=120),
                                       rtol=1e-4, atol=1e-4)
    finally:
        srv.stop()
        ref.stop()


def test_serving_replay_equals_the_eager_walk(card):
    from chip_smoke import replay_vs_eager

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        srv = _small_server("cuda", replicas=2, start=False)
        for rep in (0, 1):
            for b in (1, 2, 4, 8):
                got, want = replay_vs_eager(srv, rep, _images(b, b))
                for g, w in zip(got, want):
                    assert np.array_equal(g, w), (rep, b)
        assert srv.get_stats()["bucket_programs"] == 8
        srv.stop()
    finally:
        torch.backends.cudnn.deterministic = det


def test_serving_scale_down_frees_the_replica(card):
    import gc

    srv = _small_server("cuda", replicas=2)
    try:
        assert srv.warmup() == 8
        params = sum(t.numel() * t.element_size() for t in
                     list(srv._replica_args[1].values())
                     + list(srv._replica_aux[1].values()))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        assert srv.resize_replicas(1)["removed"] == [1]
        gc.collect()
        assert before - torch.cuda.memory_allocated() >= params
        assert not [k for k in srv._programs if k[0] == 1]
        x = _images(3, 0)
        want = srv.predict(x, timeout=120)
        assert srv.resize_replicas(2)["added"] == [1]
        assert srv.warmup() == 8
        # the reactivated slot captured its four graphs anew
        assert srv.get_stats()["bucket_programs"] == 12
        for _ in range(2):   # round-robin: both replicas answer alike
            np.testing.assert_allclose(srv.predict(x, timeout=120), want,
                                       rtol=1e-5, atol=1e-6)
    finally:
        srv.stop()


def test_serving_captures_beside_a_generator(card):
    """A server capturing its graphs on one thread while a Generator
    serves (replaying its decode graph) on another: both stay right."""
    import threading

    from mxnet_tpu_torch.parallel import TransformerParallel, make_mesh

    G = mx.serving.generation
    model = TransformerParallel(make_mesh({"dp": 1}), vocab=64, d_model=32,
                                n_heads=4, n_layers=2, d_ff=64, n_experts=2)
    params = model.init(0)
    gen = G.Generator(model, params, G.GenerationConfig(
        page_size=8, max_batch=4, max_seq=64, prefill_buckets=(16, 32, 64)))
    gen.warmup()
    prompt = [4, 8, 15, 16, 23]
    want = gen.generate(prompt, G.SamplingParams(max_new_tokens=12),
                        timeout=120)
    got, errors = [], []

    def client():
        try:
            for _ in range(6):
                got.append(gen.generate(
                    prompt, G.SamplingParams(max_new_tokens=12),
                    timeout=120))
        except Exception as err:
            errors.append(err)

    srv = _small_server("cuda", replicas=2)
    thread = threading.Thread(target=client)
    try:
        thread.start()
        assert srv.warmup() == 8
        thread.join(120)
        assert not thread.is_alive() and not errors, errors
        assert got == [want] * 6
        # three prefill buckets and the decode step, one graph each
        assert gen.get_stats()["captures"] == 4
        ref = _small_server("cpu")
        x = _images(5, 1)
        np.testing.assert_allclose(srv.predict(x, timeout=120),
                                   ref.predict(x, timeout=120),
                                   rtol=1e-4, atol=1e-4)
        ref.stop()
    finally:
        srv.stop()
        gen.stop()


# ------------------------------------------------------- flash attention

_FLASH_SHAPES = [(1, 2, 1, 64), (2, 1, 17, 32), (1, 2, 129, 64),
                 (1, 1, 70, 128), (1, 1, 33, 8), (1, 1, 65, 40)]


def _flash_inputs(B, H, T, D, dtype, gen):
    q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=gen)
                   .to(dtype) for _ in range(4))
    dlse = torch.randn(B, H, T, device="cuda", generator=gen)
    return q, k, v, do, dlse


def _near(out, ref, tol, what):
    assert out.shape == ref.shape and out.dtype == ref.dtype, what
    assert torch.isfinite(out.float()).all(), what
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item()), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_kernels_match_plain(card, dtype):
    gen = torch.Generator(device="cuda").manual_seed(2)
    tol = _TOL[dtype]
    for B, H, T, D in _FLASH_SHAPES:
        for causal in (False, True):
            what = (B, H, T, D, causal)
            q, k, v, do, dlse = _flash_inputs(B, H, T, D,
                                              getattr(torch, dtype), gen)
            scale = D ** -0.5
            o, lse = FA.flash_forward(q, k, v, causal)
            ro, rlse = FA.flash_forward_reference(q, k, v, causal, scale)
            _near(o, ro, tol, what + ("o",))
            _near(lse, rlse, 1e-4, what + ("lse",))
            delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
            dq = FA.flash_backward_dq(q, k, v, do, lse, delta, causal)
            rdq = FA.flash_backward_dq_reference(q, k, v, do, lse, delta,
                                                 causal, scale)
            _near(dq, rdq, tol, what + ("dq",))
            dk, dv = FA.flash_backward_dkv(q, k, v, do, lse, delta, causal)
            rdk, rdv = FA.flash_backward_dkv_reference(q, k, v, do, lse,
                                                       delta, causal, scale)
            _near(dk, rdk, tol, what + ("dk",))
            _near(dv, rdv, tol, what + ("dv",))


def _flash_backward(q, k, v, do, lse, delta, causal):
    dq = FA.flash_backward_dq(q, k, v, do, lse, delta, causal)
    return (dq,) + FA.flash_backward_dkv(q, k, v, do, lse, delta, causal)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_backward_matches_the_rounding_plain_version(card, dtype):
    """The tensor-core backward kernels round p and ds once to the input
    type as the A operands of their second products; the plain version
    with ``round_to`` rounds them at the same points, in fp32 otherwise.
    Beyond half an ulp of the output's own rounding they differ by
    summation order alone (FLASH_ROUNDED_TOL of chip_smoke.py says how
    far that reaches)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    for B, H, T, D in _FLASH_SHAPES + [(1, 2, 300, 64)]:
        for causal in (False, True):
            q, k, v, do, dlse = _flash_inputs(B, H, T, D,
                                              getattr(torch, dtype), gen)
            o, lse = FA.flash_forward(q, k, v, causal)
            delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
            outs = _flash_backward(q, k, v, do, lse, delta, causal)
            excess = check_flash_rounding(FA, q, k, v, do, lse, delta,
                                          causal, *outs,
                                          (B, H, T, D, causal))
            assert max(excess.values()) <= FLASH_ROUNDED_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_backward_launches_are_bit_identical(card, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for B, H, T, D in ((2, 3, 300, 64), (1, 2, 129, 128), (1, 1, 65, 40)):
        for causal in (False, True):
            q, k, v, do, _ = _flash_inputs(B, H, T, D, getattr(torch, dtype),
                                           gen)
            o, lse = FA.flash_forward(q, k, v, causal)
            delta = (do.float() * o.float()).sum(-1).contiguous()
            first = _flash_backward(q, k, v, do, lse, delta, causal)
            second = _flash_backward(q, k, v, do, lse, delta, causal)
            for name, a, b in zip(("dq", "dk", "dv"), first, second):
                assert torch.equal(a, b), (B, H, T, D, causal, name)


_FLASH_FWD_SHAPES = _FLASH_SHAPES + [(1, 2, 300, 64), (2, 2, 257, 32),
                                     (1, 1, 300, 128)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_forward_tc_matches_the_plain_versions(card, dtype):
    """The tensor-core forward against the fp32 plain version (FLASH_TOL,
    here _TOL) and against the plain version that rounds p to the input
    type in the kernel's 64-key tiles (FLASH_ROUNDED_TOL beyond half an
    ulp of o), lse within 1e-4 of both, and two launches bit-identical:
    ragged T, D of 8 to 128, causal and not."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    for B, H, T, D in _FLASH_FWD_SHAPES:
        for causal in (False, True):
            what = (B, H, T, D, causal)
            q, k, v, _, _ = _flash_inputs(B, H, T, D, getattr(torch, dtype),
                                          gen)
            o, lse = FA.flash_forward(q, k, v, causal)
            ro, rlse = FA.flash_forward_reference(q, k, v, causal, D ** -0.5)
            _near(o, ro, _TOL[dtype], what + ("o",))
            _near(lse, rlse, 1e-4, what + ("lse",))
            excess = check_flash_forward_rounding(FA, q, k, v, causal, o,
                                                  lse, what)
            assert excess <= FLASH_ROUNDED_TOL, what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_forward_fully_masked_rows(card, dtype):
    """q > 0 and the first 64 keys -inf in every feature: their scores are
    -inf, so the first key tile is wholly masked for every row and, with
    causal, rows 0..63 see no live key: those keep lse = -inf and a zero
    output (the TPU kernel's guards), the rest match the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for D in (32, 64, 128):
        for causal in (False, True):
            q, k, v, _, _ = _flash_inputs(1, 2, 129, D, getattr(torch, dtype),
                                          gen)
            q = q.abs() + 0.1
            k[:, :, :64] = float("-inf")
            o, lse = FA.flash_forward(q, k, v, causal)
            ro, rlse = FA.flash_forward_reference(q, k, v, causal, D ** -0.5)
            dead = torch.isneginf(rlse)
            assert bool(dead.any()) == causal
            assert torch.equal(torch.isneginf(lse), dead), (D, causal)
            assert (o[dead] == 0).all() and torch.isfinite(o.float()).all()
            live = ~dead
            _near(o[live], ro[live], _TOL[dtype], (D, causal, "o"))
            _near(lse[live], rlse[live], 1e-4, (D, causal, "lse"))


def test_flash_attention_grads_and_launch_counts(card):
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do, dlse = _flash_inputs(2, 2, 100, 64, torch.float32, gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    cuda_build.reset_launch_counts()
    o, lse = FA.flash_attention(*leaves, causal=True, return_lse=True)
    torch.autograd.backward([o, lse], [do, dlse])
    assert cuda_build.launch_counts() == {FA.FWD: 1, FA.DQ: 1, FA.DKV: 1}
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    ro, rlse = FA.flash_attention_reference(*refs, causal=True)
    torch.autograd.backward([ro, rlse], [do, dlse])
    _near(o, ro, 1e-4, "o")
    _near(lse, rlse, 1e-4, "lse")
    for name, a, b in zip("qkv", leaves, refs):
        _near(a.grad, b.grad, 1e-4, "d" + name)


def test_flash_bf16_gradient_gap_is_delta_from_the_rounded_o(card):
    """The bf16 gradient gap of ROADMAP Queue C, measured by
    ``flash_delta_study`` of tools/port_bf16_study.py: from the same bf16
    q, k, v, do, against autograd of the plain formula in fp32. The
    tensor-core backward kernels round p and ds to bf16 where plain
    attention (fp32 arithmetic between bf16 inputs and outputs) does not:
    their dq and dk sit 1.5-2x further from fp32 than plain attention's
    (dv's error, the output's own rounding, is plain attention's), and
    within 10% of SDPA's bf16 flash backward, which rounds at the same
    points. Taking delta = rowsum(do * o) from the fp32 o instead of the
    forward kernel's bf16 o still brings dq closer to fp32 and no longer
    moves dk. The port keeps delta from the bf16 o, as the JAX package
    does: an fp32 o residual would cost 4 bytes per element of o (32 MiB a
    layer at the LM's (8, 8, 2048, 64)) for that part of dq's error alone;
    if delta ever stops being rounded through o, the dq assertion flips."""
    study = flash_delta_study()
    plain, path = study["plain_bf16"], study["kernels"]
    exact, sdpa = study["kernels_fp32_delta"], study["sdpa_bf16"]
    assert path["dv"] == pytest.approx(plain["dv"], rel=1e-3)
    for g in ("dq", "dk"):
        assert 1.5 * plain[g] < path[g] <= 2 * plain[g], g
    for g in ("dq", "dk", "dv"):
        assert path[g] == pytest.approx(sdpa[g], rel=0.1), g
    assert path["dq"] > 1.05 * exact["dq"]
    assert path["dk"] == pytest.approx(exact["dk"], rel=1e-3)


def test_flash_wrappers_reject_what_the_kernels_do_not_take(card):
    q = torch.randn(1, 2, 16, 64, device="cuda")
    with pytest.raises(MXNetError, match="differ"):
        FA.flash_forward(q, q.cpu(), q)
    with pytest.raises(MXNetError, match="dtype"):
        FA.flash_forward(q.double(), q.double(), q.double())
    for D in (12, 136):
        bad = torch.randn(1, 2, 16, D, device="cuda")
        with pytest.raises(MXNetError, match="head dim"):
            FA.flash_forward(bad, bad, bad)
    nc = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(MXNetError, match="contiguous"):
        FA.flash_forward(nc, q, q)
    odd = torch.randn(q.numel() + 1, device="cuda")[1:].view(q.shape)
    with pytest.raises(MXNetError, match="aligned"):
        FA.flash_forward(odd, q, q)
    lse = torch.zeros(1, 2, 16, device="cuda")
    with pytest.raises(MXNetError, match="lse and delta"):
        FA.flash_backward_dq(q, q, q, q, lse.cpu(), lse)
    with pytest.raises(MXNetError, match="lse and delta"):
        FA.flash_backward_dkv(q, q, q, q, lse, lse.double())


# ------------------------------------------------ fused_batch_matmul

_BMM_EPILOGUES = [
    (("scalar", "_div_scalar", 8.0),),
    (("res", "elemwise_add"),),
    (("scalar", "_mul_scalar", 0.5), ("res", "elemwise_add"),
     ("act", "relu")),
    (("res", "elemwise_mul"), ("act", "tanh")),
    (("act", "sigmoid"), ("scalar", "_rminus_scalar", 1.0)),
    (("act", "softrelu"), ("scalar", "_minus_scalar", 0.5)),
    (("act", "softsign"), ("scalar", "_plus_scalar", 0.25)),
]


def _bmm_case(B, M, N, K, epilogue, dtype, gen, transposed=False):
    x = torch.randn(B, M, K, device="cuda", generator=gen).to(dtype)
    if transposed:
        w = torch.randn(B, N, K, device="cuda", generator=gen).to(dtype)
        w = w.permute(0, 2, 1)
    else:
        w = torch.randn(B, K, N, device="cuda", generator=gen).to(dtype)
    extras = [torch.randn(B, M, N, device="cuda", generator=gen).to(dtype)
              for s in epilogue if s[0] == "res"]
    return x, w, extras


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_kernel_matches_plain(card, dtype):
    gen = torch.Generator(device="cuda").manual_seed(4)
    for B in (1, 3):
        for M in (1, 17, 129):
            for N in (1, 17, 129):
                for K in (8, 100):
                    for ep in _BMM_EPILOGUES:
                        x, w, ex = _bmm_case(B, M, N, K, ep,
                                             getattr(torch, dtype), gen,
                                             transposed=(M + N) % 2 == 0)
                        out = F.fused_batch_matmul(x, w, ex, ep)
                        ref = F.fused_batch_matmul_reference(x, w, ex, ep)
                        _near(out, ref, _TOL[dtype], (B, M, N, K, ep))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_tile_sizes_match_plain(card, dtype):
    """Shapes whose grid takes the 128 x 128 tile (at least one block per
    SM) and the 64 x 64 tile, with ragged M, N and K at the large tile, both
    wt forms, in fused_matmul and fused_batch_matmul (a contiguous w and the
    transposed view)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dt = getattr(torch, dtype)
    ep = (("bias",), ("act", "relu"))
    for M, N, K, tile in ((2000, 1100, 37, 128), (2048, 2048, 64, 128),
                          (392, 2048, 512, 64), (130, 257, 100, 64)):
        assert F.tile_size(1, M, N) == tile, (M, N)
        assert (tile == 128) == (-(-M // 128) * -(-N // 128) >= sms)
        for wt in (True, False):
            x, w, extras = _case(M, N, K, wt, ep, dt, gen)
            _near(F.fused_matmul(x, w, extras, ep, wt),
                  F.fused_matmul_reference(x, w, extras, ep, wt),
                  _TOL[dtype], (M, N, K, wt, tile))
    bep = (("scalar", "_mul_scalar", 0.5), ("res", "elemwise_add"))
    for B, M, N, K, tile in ((3, 1000, 700, 130, 128), (2, 300, 129, 33, 64)):
        assert F.tile_size(B, M, N) == tile, (B, M, N)
        for transposed in (False, True):
            x, w, extras = _bmm_case(B, M, N, K, bep, dt, gen, transposed)
            _near(F.fused_batch_matmul(x, w, extras, bep),
                  F.fused_batch_matmul_reference(x, w, extras, bep),
                  _TOL[dtype], (B, M, N, K, transposed, tile))


def test_batch_kernel_reads_the_transposed_operand_in_place(card):
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(8, 64, 128, device="cuda", generator=gen)
    k = torch.randn(8, 64, 128, device="cuda", generator=gen)
    kt = k.permute(0, 2, 1)
    assert not kt.is_contiguous()
    ep = (("scalar", "_div_scalar", 128 ** 0.5),)
    cuda_build.reset_launch_counts()
    out = F.fused_batch_matmul(q, kt, epilogue=ep)
    assert cuda_build.launch_counts() == {F.BMM_KERNEL: 1}
    _near(out, F.fused_batch_matmul_reference(q, kt, epilogue=ep), 1e-4,
          "view")
    _near(out, F.fused_batch_matmul(q, kt.contiguous(), epilogue=ep), 1e-4,
          "copy")


def test_batch_wrapper_rejects_what_the_kernel_does_not_take(card):
    x = torch.randn(2, 4, 8, device="cuda")
    w = torch.randn(2, 8, 5, device="cuda")
    cuda_build.reset_launch_counts()
    with pytest.raises(MXNetError, match="dtype"):
        F.fused_batch_matmul(x.double(), w.double())
    with pytest.raises(MXNetError, match="dtype"):
        F.fused_batch_matmul(x.half(), w.half(), out_dtype="float64")
    with pytest.raises(MXNetError, match="batched form"):
        F.fused_batch_matmul(x, w, [torch.randn(5, device="cuda")],
                             (("bias",),))
    with pytest.raises(MXNetError, match="contract"):
        F.fused_batch_matmul(x, w[:, :4])
    with pytest.raises(MXNetError, match="contiguous"):
        F.fused_batch_matmul(x, w[:, :, ::2])
    with pytest.raises(MXNetError, match="w on"):
        F.fused_batch_matmul(x, w.cpu())
    with pytest.raises(MXNetError, match="residual"):
        F.fused_batch_matmul(x, w, [torch.randn(2, 4, 4, device="cuda")],
                             (("res", "elemwise_add"),))
    assert cuda_build.launch_counts().get(F.BMM_KERNEL, 0) == 0


def _attention_block(T, D, classes):
    data = mx.sym.var("data")
    q = mx.sym.FullyConnected(data, num_hidden=D, flatten=False, name="q")
    k = mx.sym.FullyConnected(data, num_hidden=D, flatten=False, name="k")
    v = mx.sym.FullyConnected(data, num_hidden=D, flatten=False, name="v")
    scores = mx.sym.batch_dot(q, mx.sym.transpose(k, axes=(0, 2, 1)))
    attn = mx.sym.softmax(scores / float(np.sqrt(D)), axis=-1)
    ctx = mx.sym.batch_dot(attn, v)
    out = mx.sym.FullyConnected(ctx + data, num_hidden=D, flatten=False,
                                name="proj")
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.Flatten(out), num_hidden=classes,
                              name="head"), name="softmax")


def test_module_step_through_the_kernels_matches_plain(card):
    """The first forward_backward's outputs and gradients with the kernels
    (MXNET_FUSION_KERNEL=1) against the plain composition (=0)."""
    B, T, D = 4, 33, 40
    sym = _attention_block(T, D, 5)
    rng = np.random.RandomState(0)
    x = rng.rand(B, T, D).astype(np.float32)
    y = (np.arange(B) % 5).astype(np.float32)
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                            label=[mx.nd.array(y, ctx=mx.cpu())])
    results = []
    for flag in (1, 0):
        mx.config.set_flag("MXNET_FUSION_KERNEL", flag)
        try:
            mod = mx.mod.Module(sym, context=mx.gpu())
            mod.bind(data_shapes=[("data", x.shape)],
                     label_shapes=[("softmax_label", y.shape)])
            np.random.seed(1)
            mod.init_params(mx.init.Uniform(0.05))
            cuda_build.reset_launch_counts()
            mod.forward_backward(batch)
            torch.cuda.synchronize()
            launches = cuda_build.launch_counts().get(F.BMM_KERNEL, 0)
            assert launches == (2 if flag else 0)
            grp = mod._exec_group
            results.append(dict([("output", mod.get_outputs()[0].asnumpy())]
                                + [(n, g[0].asnumpy()) for n, g in
                                   zip(grp.param_names, grp.grad_arrays)]))
        finally:
            mx.config.set_flag("MXNET_FUSION_KERNEL", None)
    kern, plain = results
    for name in plain:
        # k_bias's gradient is 0 up to rounding (the softmax cancels a
        # shift of a row's scores): it is judged at its layer's scale
        scale = np.abs(plain["k_weight" if name == "k_bias" else name]).max()
        assert name == "k_bias" or np.abs(kern[name]).max() > 0, name
        assert np.abs(kern[name] - plain[name]).max() <= 1e-5 * scale, name


def test_fit_with_a_kvstore_updates_on_the_card(card):
    """With a store (a KVStore object makes one even on one device), the
    stored weights, the reduce and the optimizer's state live on the card,
    and the parameters match a fit without a store."""
    B, T, D = 4, 8, 16
    sym = _attention_block(T, D, 5)
    rng = np.random.RandomState(0)
    x = rng.rand(3 * B, T, D).astype(np.float32)
    y = (np.arange(3 * B) % 5).astype(np.float32)
    params = []
    for kv in (mx.kv.create("local"), None):
        mod = mx.mod.Module(sym, context=mx.gpu())
        np.random.seed(1)
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=B), num_epoch=2,
                optimizer="sgd", kvstore=kv,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Uniform(0.05))
        params.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
        if kv is not None:
            assert mod._update_on_kvstore and mod._kvstore is kv
            assert sorted(kv._data) == sorted(mod._param_names)
            for name, stored in kv._data.items():
                assert stored.context.device_type == "gpu", name
            states = kv._updater.states
            assert states and all(s.context.device_type == "gpu"
                                  for s in states.values())
    for k in params[1]:
        np.testing.assert_allclose(params[0][k], params[1][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _card_trainer(schedule):
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh

    with mx.NameManager():
        sym = mx.models.resnet.resnet(
            units=[1, 1, 1], num_stages=3, filter_list=[16, 32, 64, 128],
            num_classes=10, image_shape=(3, 32, 32), bottle_neck=True,
            layout="NHWC")
    lr = (lambda step: 0.1 * 0.5 ** step) if schedule else 0.1
    return ShardedTrainer(sym, make_mesh({"dp": 1}), optimizer="sgd",
                          optimizer_params={"learning_rate": lr,
                                            "momentum": 0.9, "wd": 1e-4},
                          dtype="bfloat16")


def _trainer_tensors(state):
    out = dict(state["params"])
    out.update(state["aux"])
    out.update(("%s/%d" % (k, i), t) for k, v in state["opt"].items()
               for i, t in enumerate(v))
    return {k: v.clone() for k, v in out.items()}


def test_sharded_trainer_graph_matches_eager(card):
    """The small bottleneck ResNet in bf16 through ShardedTrainer on the
    card, cuDNN deterministic: one captured replay equals one eager step
    to the bit; multi_step(3) equals three steps (losses and state) with
    a decaying learning rate and one capture; a state that is not the
    trainer's buffers is copied into them, so two steps from it agree."""
    rng = np.random.RandomState(0)
    data = {"data": rng.rand(8, 32, 32, 3).astype(np.float32),
            "softmax_label": (np.arange(8) % 10).astype(np.float32)}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        trainer = _card_trainer(schedule=True)
        state0 = trainer.init({k: v.shape for k, v in data.items()})
        batch = trainer.shard_batch(data)
        assert batch["data"].is_cuda and batch["data"].dtype == torch.bfloat16
        eager, _ = trainer._step_eager(state0, batch)
        want = _trainer_tensors(eager)
        for _ in range(2):
            graph, outs = trainer.step(state0, batch)
            got = _trainer_tensors(graph)
            assert all(torch.equal(got[k], want[k]) for k in want)
        assert graph["params"]["conv0_weight"] is not \
            state0["params"]["conv0_weight"]
        multi, losses = trainer.multi_step(state0, batch, 3)
        multi = _trainer_tensors(multi)
        stepped, step_losses = state0, []
        for _ in range(3):
            stepped, outs = trainer.step(stepped, batch)
            step_losses.append(outs[0].float().mean())
        assert torch.equal(losses, torch.stack(step_losses))
        stepped = _trainer_tensors(stepped)
        assert all(torch.equal(multi[k], stepped[k]) for k in multi)
        assert trainer._captures == 1
    finally:
        torch.backends.cudnn.deterministic = det


def _dropout_trainer():
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh

    with mx.NameManager():
        fc1 = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=64,
                                    name="fc1")
        drop = mx.sym.Dropout(mx.sym.Activation(fc1, act_type="relu"),
                              p=0.5)
        fc2 = mx.sym.FullyConnected(drop, num_hidden=10, name="fc2")
        sym = mx.sym.SoftmaxOutput(fc2, name="softmax")
    return ShardedTrainer(sym, make_mesh({"dp": 1}), optimizer="sgd",
                          optimizer_params={"learning_rate": 0.1,
                                            "momentum": 0.9})


def test_sharded_trainer_graph_under_mirroring(card):
    """MXNET_BACKWARD_DO_MIRROR with ShardedTrainer's captured step, cuDNN
    deterministic. The small ResNet (no random op): the mirrored replay
    equals the mirrored eager step and the unmirrored one to the bit. An
    MLP with Dropout: the capture does not read the card's generator (a
    capture cannot), and from one seed the mirrored replay equals the
    unmirrored replay to the bit (one mask, drawn once); outside a capture
    the mirrored eager step equals the unmirrored one from one seed."""
    from mxnet_tpu_torch.config import set_flag

    rng = np.random.RandomState(0)
    data = {"data": rng.rand(8, 32, 32, 3).astype(np.float32),
            "softmax_label": (np.arange(8) % 10).astype(np.float32)}
    mlp_data = {"data": rng.rand(16, 32).astype(np.float32),
                "softmax_label": (np.arange(16) % 10).astype(np.float32)}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        results = {}
        for mirror in (0, 1):
            set_flag("MXNET_BACKWARD_DO_MIRROR", mirror)
            trainer = _card_trainer(schedule=False)
            state0 = trainer.init({k: v.shape for k, v in data.items()})
            batch = trainer.shard_batch(data)
            eager, _ = trainer._step_eager(state0, batch)
            graph, _ = trainer.step(state0, batch)
            drop = _dropout_trainer()
            d_state = drop.init({k: v.shape for k, v in mlp_data.items()})
            d_batch = drop.shard_batch(mlp_data)
            mx.random.seed(5)
            d_eager, _ = drop._step_eager(d_state, d_batch)
            drop.step(d_state, d_batch)      # captures
            mx.random.seed(5)
            d_graph, _ = drop.step(d_state, d_batch)
            assert trainer._captures == 1 and drop._captures == 1
            results[mirror] = [_trainer_tensors(s) for s in
                               (eager, graph, d_eager, d_graph)]
        for mirror in (0, 1):
            eager, graph = results[mirror][:2]
            assert all(torch.equal(graph[k], eager[k]) for k in eager), \
                mirror
        for i in range(4):
            plain, mirrored = results[0][i], results[1][i]
            assert all(torch.equal(mirrored[k], plain[k]) for k in plain), i
    finally:
        set_flag("MXNET_BACKWARD_DO_MIRROR", None)
        torch.backends.cudnn.deterministic = det


def test_generation_decode_graph_matches_eager(card):
    """The small causal LM's Generator on the card: warmup captures each
    prefill bucket and the decode step once; from a state of three active
    slots (seeded temperature) one replay equals one eager run of the
    step's body to the bit (tokens, keys, every page but the trash page);
    a request's prefill replay launches the flash forward once per layer
    (the replays times one body run's launches; the wrapper itself counts
    nothing after the captures), its greedy output equals the
    full-recompute oracle, and the capture count stays 4."""
    from chip_smoke import admit_slots, decode_graph_vs_eager, release_slots
    from mxnet_tpu_torch.parallel import TransformerParallel, make_mesh

    G = mx.serving.generation
    model = TransformerParallel(make_mesh({"dp": 1}), vocab=64, d_model=32,
                                n_heads=4, n_layers=2, d_ff=64, n_experts=2)
    params = model.init(0)
    gen = G.Generator(model, params, G.GenerationConfig(
        page_size=8, max_batch=4, max_seq=64, prefill_buckets=(16, 32, 64)),
        start=False)
    assert gen.warmup() == 4 and gen.get_stats()["captures"] == 4
    with gen._device_scope():
        admit_slots(gen, [[1, 2, 3], [5] * 11, [7, 8] * 9],
                    G.SamplingParams(max_new_tokens=8, temperature=0.8,
                                     seed=3))
        assert decode_graph_vs_eager(gen)
        release_slots(gen)
    gen.pool.assert_no_leaks()
    gen.start()
    prompt = [4, 8, 15, 16, 23]
    try:
        base = gen.graph_launches().get(FA.FWD, 0)
        cuda_build.reset_launch_counts()
        got = gen.generate(prompt, G.SamplingParams(max_new_tokens=6),
                           timeout=120)
        assert gen.graph_launches()[FA.FWD] - base == 2
        assert cuda_build.launch_counts().get(FA.FWD, 0) == 0
    finally:
        gen.stop()
    gen.pool.assert_no_leaks()
    assert gen.get_stats()["captures"] == 4
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(6):
            logits, _, _ = model.prefill_forward(params, [toks])
            toks.append(int(torch.argmax(logits[0, -1])))
    assert got == toks[len(prompt):]


def _small_gluon_net(dropout=0.0):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="card_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2))
        if dropout:
            net.add(nn.Dropout(dropout))
        net.add(nn.Flatten(), nn.Dense(10))
    return net


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01, "clip_gradient": 0.5})])
def test_gluon_compile_step_replay_equals_its_body(card, opt, kw):
    """Under cuDNN's deterministic algorithms a compile_step replay equals
    its body run eagerly from the same state to the bit (parameters, BN
    moving statistics, optimizer state, loss); a learning-rate change
    captures nothing new, and the eager tape from one state agrees
    within 1e-5 of each tensor's max."""
    from chip_smoke import (compare_tensors, gl_eager_step,
                            gl_replay_vs_body, gl_restore, gl_snapshot)

    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(8, 3, 16, 16).astype(np.float32), ctx=mx.gpu())
    y = mx.nd.array(rng.randint(0, 10, 8).astype(np.float32), ctx=mx.gpu())
    np.random.seed(0)
    net = _small_gluon_net()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu())
    net.hybridize()
    net(x)      # the deferred shapes
    trainer = mx.gluon.Trainer(net.collect_params(), opt, dict(kw),
                               kvstore="local")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    torch.backends.cudnn.deterministic = True
    try:
        step = trainer.compile_step(net, loss_fn)
        for lr in (None, 0.002):
            if lr is not None:
                trainer.set_learning_rate(lr)
            same, total, worst, name, loss_same = gl_replay_vs_body(
                step, net, trainer, x, y)
            assert same == total and loss_same, (name, worst)
        assert step.compile_count == 1
        s0 = gl_snapshot(net, trainer)
        step(x, y)
        compiled = gl_snapshot(net, trainer)
        gl_restore(net, trainer, s0)
        gl_eager_step(mx, net, trainer, loss_fn, x, y)
        _same, _total, worst, name = compare_tensors(
            gl_snapshot(net, trainer)[0], compiled[0])
        assert worst <= 1e-5, (name, worst)
    finally:
        torch.backends.cudnn.deterministic = False


def test_gluon_captured_dropout_draws_anew_each_replay(card):
    from chip_smoke import gl_captured_dropout

    rates, captures = gl_captured_dropout(mx)
    assert captures == 1 and len(rates) == 4


def test_gluon_compile_step_recaptures_for_a_new_batch_shape(card):
    np.random.seed(1)
    net = _small_gluon_net(dropout=0.2)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu())
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "nag",
                               {"learning_rate": 0.01, "momentum": 0.9})
    step = trainer.compile_step(net, mx.gluon.loss.SoftmaxCrossEntropyLoss())
    for n in (4, 4, 6, 6):
        rng = np.random.RandomState(n)
        x = mx.nd.array(rng.rand(n, 3, 16, 16).astype(np.float32),
                        ctx=mx.gpu())
        y = mx.nd.array(rng.randint(0, 10, n).astype(np.float32),
                        ctx=mx.gpu())
        loss = step(x, y).asnumpy()
        assert loss.shape == (n,) and np.isfinite(loss).all()
    assert step.compile_count == 2


def test_gluon_op_grid_on_card_matches_cpu(card):
    from chip_smoke import GL_GRID_TOL, GL_SUM_TOL, gl_op_grid

    cases, worst, _rerun = gl_op_grid(mx)
    assert cases > 100
    assert worst["exact"][0] <= GL_GRID_TOL
    assert worst["summing"][0] <= GL_SUM_TOL


def test_detection_and_spatial_ops_on_card_match_cpu(card):
    from chip_smoke import SSD_OP_TOL, ssd_op_grid

    cases, (worst, _where) = ssd_op_grid(mx)
    assert cases == 19
    assert worst <= SSD_OP_TOL


def test_slice_14_ops_on_card_match_cpu(card):
    """The linalg, legacy, contrib, fork and nn.py ops of the model-zoo
    slice (chip_smoke.py's phase 16 (c) cases) on the card against the
    CPU, forward and gradients."""
    from chip_smoke import ZOO_OP_TOL, ZOO_SUM_TOL, zoo_op_grid

    cases, worst = zoo_op_grid(mx)
    assert cases == 49
    assert worst["exact"][0] <= ZOO_OP_TOL
    assert worst["summing"][0] <= ZOO_SUM_TOL


_RNN_GRID = [(mode, L, bi) for mode in ("rnn_tanh", "rnn_relu", "lstm",
                                        "gru")
             for L in (1, 2) for bi in (False, True)]


def _rnn_inputs(mode, L, bi, gen, T=5, N=3, I=4, H=6):
    from mxnet_tpu_torch.ops.rnn import rnn_param_size

    D = 2 if bi else 1

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, device="cuda", generator=gen)
                * scale).requires_grad_(True)

    return [rand(T, N, I), rand(rnn_param_size(L, H, I, mode, bi),
                                scale=0.3),
            rand(L * D, N, H, scale=0.5),
            rand(L * D, N, H, scale=0.5) if mode == "lstm" else None]


def _rnn_all(route, mode, L, bi, ins, heads, **kw):
    out, h, c = route(mode, *ins, num_layers=L, state_size=6,
                      bidirectional=bi, **kw)
    outs = [out, h] + ([c] if mode == "lstm" else [])
    leaves = [t for t in ins if t is not None]
    return outs + list(torch.autograd.grad(outs, leaves, heads[:len(outs)]))


@pytest.mark.parametrize("mode,L,bi", _RNN_GRID, ids=[
    "%s-L%d-%s" % (m, n, "bi" if b else "uni") for m, n, b in _RNN_GRID])
def test_rnn_cudnn_matches_the_plain_version(card, mode, L, bi):
    """The fused RNN op's cuDNN route against rnn_reference on the card:
    outputs, final states and every input's gradient within RNN_CUDNN_TOL
    of each tensor's max (TF32 off; cuDNN's fp32 tanh and sigmoid are
    ~7e-6 off float64 at this H, chip_smoke.py's phase 13 (a)); one cuDNN
    call."""
    from mxnet_tpu_torch.ops import rnn as R

    gen = torch.Generator(device="cuda").manual_seed(3)
    ins = _rnn_inputs(mode, L, bi, gen)
    D = 2 if bi else 1
    heads = [torch.randn(5, 3, 6 * D, device="cuda", generator=gen)] + [
        torch.randn(L * D, 3, 6, device="cuda", generator=gen)
        for _ in range(2)]
    before = R.CUDNN_CALLS["rnn"]
    got = _rnn_all(R.rnn_cudnn, mode, L, bi, ins, heads)
    assert R.CUDNN_CALLS["rnn"] == before + 1
    want = _rnn_all(R.rnn_reference, mode, L, bi, ins, heads)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        err = _rel(g, w)
        assert err <= RNN_CUDNN_TOL, (i, err)


def _rel(got, want):
    return float((got.detach() - want.detach()).abs().max()
                 / want.detach().abs().max())


def test_rnn_op_on_card_and_its_dropout(card):
    """nd.RNN on the card goes through cuDNN and matches the same op on the
    CPU; with p > 0 in training each layer is one cuDNN call and the
    between-layers mask is the card generator's draw."""
    from mxnet_tpu_torch.ops import rnn as R

    rng = np.random.RandomState(0)
    x = rng.randn(5, 3, 4).astype(np.float32)
    p = (rng.randn(R.rnn_param_size(2, 6, 4, "gru")) * 0.3).astype(
        np.float32)
    h0 = (rng.randn(2, 3, 6) * 0.5).astype(np.float32)
    outs = {}
    for ctx in (mx.cpu(), mx.gpu()):
        args = [mx.nd.array(a, ctx=ctx) for a in (x, p, h0)]
        outs[ctx.device_type] = [o.asnumpy() for o in mx.nd.RNN(
            *args, state_size=6, num_layers=2, mode="gru",
            state_outputs=True)]
    for i, (g, w) in enumerate(zip(outs["gpu"], outs["cpu"])):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= RNN_CUDNN_TOL, (i, err)
    gen = torch.Generator(device="cuda").manual_seed(4)
    ins = _rnn_inputs("lstm", 2, False, gen, T=7, N=64)
    start = torch.cuda.get_rng_state()
    before = R.CUDNN_CALLS["rnn"]
    got = R.rnn_cudnn("lstm", *ins, num_layers=2, state_size=6, p=0.4,
                      is_train=True)
    assert R.CUDNN_CALLS["rnn"] == before + 2
    torch.cuda.set_rng_state(start)
    want = R.rnn_reference("lstm", *ins, num_layers=2, state_size=6, p=0.4,
                           is_train=True)
    torch.cuda.set_rng_state(start)
    keep = (torch.rand((7, 64, 6), device="cuda") < 0.6).float().mean()
    assert abs(float(keep) - 0.6) < 3 * np.sqrt(0.24 / (7 * 64 * 6))
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= RNN_CUDNN_TOL, (i, _rel(g, w))


def test_gluon_lstm_layer_on_card_matches_cpu(card):
    """gluon.rnn.LSTM (2 layers, bidirectional, NTC) on the card against
    the same layer on the CPU: output and every parameter's gradient."""
    res = {}
    for ctx in (mx.cpu(), mx.gpu()):
        layer = mx.gluon.rnn.LSTM(6, num_layers=2, layout="NTC",
                                  bidirectional=True, input_size=4,
                                  prefix="l_")
        np.random.seed(0)
        layer.initialize(mx.init.Uniform(0.3), ctx=ctx)
        x = mx.nd.array(np.random.RandomState(1).randn(3, 5, 4)
                        .astype(np.float32), ctx=ctx)
        with mx.autograd.record():
            out = layer(x)
            loss = (out * out).sum()
        loss.backward()
        res[ctx.device_type] = [out.asnumpy()] + [
            p.grad(ctx).asnumpy() for _, p in
            sorted(layer.collect_params().items())]
    names = ["out"] + sorted(layer.collect_params())
    for name, g, w in zip(names, res["gpu"], res["cpu"]):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= RNN_CUDNN_TOL, (name, err, np.abs(w).max())


# ------------------------------------------------------------------- int8

# ResNet-50's integer contractions under the quantize pass, at batch 2:
# the 7x7 stem, a 1x1 stride-2 projection, the widest 3x3 (3 x 3 x 512 =
# 4608 products a sum), in both layouts, and fc1
_INT_CONVS = [
    ("stem", (2, 3, 224, 224), dict(kernel=(7, 7), stride=(2, 2),
                                    pad=(3, 3), num_filter=64)),
    ("proj", (2, 1024, 14, 14), dict(kernel=(1, 1), stride=(2, 2),
                                     num_filter=2048)),
    ("wide", (2, 512, 7, 7), dict(kernel=(3, 3), pad=(1, 1),
                                  num_filter=512)),
]


def _int_operands(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(-127, 128, size=s).astype(np.int32) for s in shapes]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name,shape,kw", _INT_CONVS)
def test_int_route_on_card_equals_cpu(card, name, shape, kw, layout):
    """The exact integer route (float64 on the library, rounded to int32)
    on the card equals the CPU composition bit for bit, eagerly and
    replayed from a CUDA graph."""
    kw = dict(kw, no_bias=True)
    if layout == "NHWC":
        shape = (shape[0],) + shape[2:] + (shape[1],)
        kw["layout"] = "NHWC"
    sym = mx.sym.Convolution(mx.sym.var("data"), name="c", **kw)
    arg_shapes, _, _ = sym.infer_shape(data=shape)
    x, w = _int_operands(arg_shapes, len(name))
    outs = {}
    for ctx in (mx.cpu(), mx.gpu()):
        out = mx.nd.Convolution(mx.nd.array(x, ctx=ctx, dtype="int32"),
                                mx.nd.array(w, ctx=ctx, dtype="int32"),
                                **kw)
        outs[ctx.device_type] = out.asnumpy()
    assert outs["gpu"].dtype == np.int32
    assert np.array_equal(outs["gpu"], outs["cpu"])
    from mxnet_tpu_torch.ops.registry import get_op

    op = get_op("Convolution")
    attrs = op.parse_attrs(kw)
    xs, ws = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    op.apply(attrs, [xs, ws], [])      # warm the library's plans
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        (captured,), _ = op.apply(attrs, [xs, ws], [])
    graph.replay()
    assert np.array_equal(captured.cpu().numpy(), outs["cpu"])


@pytest.mark.parametrize("op,shapes,kw", [
    ("FullyConnected", [(16, 2048), (1000, 2048)],
     dict(num_hidden=1000, no_bias=True)),
    ("dot", [(64, 256), (256, 64)], {}),
    ("batch_dot", [(8, 64, 64), (8, 64, 64)], dict(transpose_b=True)),
])
def test_int_contractions_on_card_equal_cpu(card, op, shapes, kw):
    arrays = _int_operands(shapes, 3)
    outs = {}
    for ctx in (mx.cpu(), mx.gpu()):
        out = getattr(mx.nd, op)(*[mx.nd.array(a, ctx=ctx, dtype="int32")
                                   for a in arrays], **kw)
        outs[ctx.device_type] = out.asnumpy()
    assert outs["gpu"].dtype == np.int32
    assert np.array_equal(outs["gpu"], outs["cpu"])


@pytest.mark.parametrize("verify", [False, True])
def test_int8_paged_attention_matches_plain(card, verify):
    """Paged attention over int8 pages with their scales on the card
    against its plain version (the same pages dequantized up front, in
    fp32) and against the CPU, within 1e-6 of max |out|."""
    from mxnet_tpu_torch.serving.generation.engine import _quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(0)
    S, Q, H, d, page, n_pages, P = 8, 3, 4, 64, 16, 16, 129
    k = torch.randn(P, page, H, d, device="cuda", generator=gen) * 3
    v = torch.randn(P, page, H, d, device="cuda", generator=gen)
    (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
    table = torch.randperm(P - 1, device="cuda", generator=gen)[
        :S * n_pages].reshape(S, n_pages).int() + 1
    lengths = torch.tensor([0, 1, 17, 100, 255, 256, 31, 64],
                           dtype=torch.int32, device="cuda")
    q = torch.randn(S, Q, H, d, device="cuda", generator=gen)
    fn = FA.paged_verify_attention if verify else FA.paged_decode_attention
    qq = q if verify else q[:, 0]
    lens = lengths.clamp(max=n_pages * page - Q) if verify else lengths
    got = fn(qq, kq, vq, table, lens, block_tokens=128, k_scale=ks,
             v_scale=vs)
    plain = fn(qq, kq.float() * ks[..., None], vq.float() * vs[..., None],
               table, lens, block_tokens=128)
    cpu = fn(*(t.cpu() for t in (qq, kq, vq, table, lens)),
             block_tokens=128, k_scale=ks.cpu(), v_scale=vs.cpu())
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-6 * scale
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5 * scale
    if not verify:
        assert not got[0].any(), "a slot of length 0 gives zeros"


# chi-square bounds at p = 1e-6 by degrees of freedom (top-k support - 1)
_CHI2_1E6 = {1: 23.93, 2: 27.63, 3: 30.66, 4: 33.38, 5: 35.89, 6: 38.26,
             7: 40.52}


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.6, 3),
                                               (1.7, 5)])
def test_sampling_on_card_meets_the_distribution(card, temperature, top_k):
    """sample_tokens on the card, 102,400 draws (1024 slots x 100 steps,
    each slot's key advanced by the function itself), against the exact
    temperature / top-k probabilities that the JAX package's and the
    port's draws meet on the CPU (test_torch_generation.py): chi-square
    over the support below its p = 1e-6 quantile, every token's frequency
    and the mean token within 5 standard errors, nothing outside the top
    k. (Neither package has a top-p knob.)"""
    from mxnet_tpu_torch.serving.generation import sampling

    V, S, steps = 8, 1024, 100
    logits = np.random.RandomState(1).randn(V).astype(np.float32) * 1.5
    scaled = logits / temperature
    keep = np.argsort(-scaled)[:top_k] if top_k else np.arange(V)
    exact = np.zeros(V)
    exact[keep] = np.exp(scaled[keep] - scaled[keep].max())
    exact /= exact.sum()
    keys = torch.tensor([sampling.seed_key(i) for i in range(S)],
                        device="cuda")
    lg = torch.from_numpy(np.tile(logits, (S, 1))).cuda()
    temp = torch.full((S,), temperature, device="cuda")
    k = torch.full((S,), top_k, device="cuda")
    draws = []
    for _ in range(steps):
        tok, keys = sampling.sample_tokens(lg, keys, temp, k)
        draws.append(tok)
    draws = torch.stack(draws).cpu().numpy().ravel()
    n = draws.size
    assert n >= 100_000
    counts = np.bincount(draws, minlength=V)
    assert not counts[exact == 0].any()
    live = exact > 0
    chi2 = float((((counts - n * exact) ** 2)[live]
                  / (n * exact[live])).sum())
    assert chi2 <= _CHI2_1E6[int(live.sum()) - 1], (chi2, counts)
    freq = counts / n
    assert (np.abs(freq - exact)
            <= 5 * np.sqrt(exact * (1 - exact) / n) + 1e-12).all()
    mean = float((np.arange(V) * exact).sum())
    var = float(((np.arange(V) - mean) ** 2 * exact).sum())
    assert abs(draws.mean() - mean) <= 5 * np.sqrt(var / n)


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_streaming_batches_staged_on_card_equal_the_cpu_iterators(
        card, tmp_path, backend):
    """StreamingIter stages each batch on the card (pinned buffers,
    non_blocking copies): its batches equal the CPU iterator's to the bit,
    trailing short batch and labels included, over two epochs."""
    rng = np.random.RandomState(0)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(21):
        img = rng.randint(0, 255, (18, 20, 3)).astype(np.uint8)
        w.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(i), i, 0), img, quality=90))
    w.close()
    runs = {}
    for dev in (mx.gpu(), mx.cpu()):
        it = mx.io.StreamingIter(
            path_imgrec=rec, path_imgidx=idx, data_shape=(3, 16, 16),
            batch_size=4, shuffle=True, seed=2, decode_backend=backend,
            decode_workers=2, device=dev, mean=np.array([120., 110., 100.]))
        out = []
        try:
            for epoch in range(2):
                if epoch:
                    it.reset()
                for b in it:
                    assert b.data[0]._data.device.type == dev.device.type
                    out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                                b.pad))
        finally:
            it.close()
        runs[dev.device_type] = out
    assert len(runs["gpu"]) == len(runs["cpu"]) == 12
    for (gd, gl, gp), (cd, cl, cp) in zip(runs["gpu"], runs["cpu"]):
        assert gp == cp
        np.testing.assert_array_equal(gd, cd)
        np.testing.assert_array_equal(gl, cl)
    assert runs["gpu"][-1][2] == 3


# --------------------------------------------------------- observability
def test_event_timed_device_span_against_a_known_kernel(card):
    """A program's device time is the span between its two CUDA events,
    read at the step's end: the host returns long before the card
    finishes, and the span agrees with the same GEMMs timed alone."""
    from mxnet_tpu_torch.observability import perf

    n, reps = 4096, 8
    a = torch.randn(n, n, device=card)
    b = torch.randn(n, n, device=card)
    for _ in range(2):
        torch.matmul(a, b)
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0.record()
    for _ in range(reps):
        torch.matmul(a, b)
    s1.record()
    s1.synchronize()
    alone_ms = s0.elapsed_time(s1)
    cost = {"graph": "gemm", "mode": "infer", "flops": 2 * n ** 3 * reps,
            "hbm_bytes": 3 * n * n * 4 * reps, "roofline_s": 1e-3,
            "ridge_intensity": 17.6, "basis": "test",
            "compute_dtype": "float32", "ops": [], "fusion_candidates": []}
    perf.reset()
    try:
        for step in range(3):
            perf.step_begin()
            import time

            t0 = time.perf_counter()
            stream = perf.current_stream(torch.cuda.current_device())
            start, end = perf.event_pair()
            perf.record(start, stream)
            for _ in range(reps):
                torch.matmul(a, b)
            perf.record(end, stream)
            host_s = time.perf_counter() - t0
            perf.note_program_events(cost, start, end, host_s)
            rec = perf.step_end(step=step)
        (entry,) = perf.program_table()
        assert entry["runs"] == 2 and entry["warmup_runs"] == 1
        device_ms = entry["device_ms_last"]
        assert abs(device_ms - alone_ms) <= 0.1 * alone_ms
        assert entry["host_ms_ema"] < 0.5 * device_ms   # launches return
        assert rec["device_span_s"] * 1e3 == pytest.approx(device_ms)
        assert rec["host_s"] == rec["wall_s"] - (
            rec["data_wait_s"] + rec["device_s"] + rec["kvstore_s"])
    finally:
        perf.reset()


@pytest.mark.parametrize("inputs_need_grad", [False, True])
def test_module_gemm_program_mfu_under_100(card, inputs_need_grad):
    """The executor's event-timed program of a GEMM-bound Module step:
    MFU and HBM utilisation within (0, 100) on both bases, with the data
    taking a gradient (the backward runs the dgrad and the wgrad GEMM) and
    without (the wgrad alone: the program is not charged a data gradient
    it never computes)."""
    from mxnet_tpu_torch.observability import perf

    bs, width = 2048, 4096
    data = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data, num_hidden=width, name="fc"), name="softmax")
    mod = mx.mod.Module(net, context=mx.gpu())
    mod.bind(data_shapes=[("data", (bs, width))],
             label_shapes=[("softmax_label", (bs,))],
             inputs_need_grad=inputs_need_grad)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),))
    rng = np.random.RandomState(0)
    batch = mx.io.DataBatch(
        data=[mx.nd.array(rng.rand(bs, width).astype(np.float32),
                          ctx=mx.gpu())],
        label=[mx.nd.array(rng.randint(0, width, bs).astype(np.float32),
                           ctx=mx.gpu())])
    perf.reset()
    try:
        for i in range(4):
            perf.step_begin()
            mod.forward_backward(batch)
            mod.update()
            rec = perf.step_end(step=i)
            assert rec["programs"] == 1
        (entry,) = perf.program_table()
        for key in ("mfu_pct", "mfu_spec_pct", "hbm_util_pct",
                    "hbm_util_spec_pct"):
            assert 0.0 < entry[key] < 100.0, (key, entry[key])
        assert entry["compute_dtype"] == "float32"
        assert entry["mfu_spec_pct"] < entry["mfu_pct"]
        assert 0.0 < rec["mfu_pct"] <= entry["mfu_pct"] * 1.001
    finally:
        perf.reset()


def _guard_kernels(tensors):
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.observability import health

    named = [("t%d" % i, t) for i, t in enumerate(tensors)]
    health.check(params=named)   # plan built, kernels warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        v = health.check(params=named)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type == cuda]
    kernels = [n for n in names if "memcpy" not in n.lower()
               and "memset" not in n.lower()]
    return len(kernels), v


def test_health_reduction_launches_a_constant_per_guard(card):
    """A guard is one launch of the health_stats kernel (and the copies of
    its pointer table and result), whatever the number and the dtypes of
    the watched tensors, and its stats name the planted NaN."""
    gen = torch.Generator(device=card).manual_seed(0)

    def tensors(n, dtype):
        out = [torch.randn(1 + 997 * i % 5000, device=card, generator=gen)
               .to(dtype) for i in range(n)]
        out[n // 2].view(-1)[0] = float("nan")
        return out

    few, _ = _guard_kernels(tensors(20, torch.float32))
    many, v = _guard_kernels(tensors(320, torch.float32))
    mixed, _ = _guard_kernels(tensors(160, torch.float32)
                              + tensors(160, torch.bfloat16))
    assert few == many == mixed == 1, (few, many, mixed)
    assert dict(v.bad) == {"param:t160": 1}


def test_health_stats_kernel_equals_its_plain_version(card):
    """The kernel's stats against observability.health.stats_plain on the
    same tensors: fp32, bf16, fp16, fp64 and a float8 (read through a
    float32 copy), strided views, an empty tensor, sizes on and across
    the kernel's chunk edges, NaN and +-Inf planted; the bad counts
    exactly, the sums within 1e-12 of each tensor's scale (both float64,
    summed in different orders)."""
    from mxnet_tpu_torch.cuda_build import launch_counts
    from mxnet_tpu_torch.observability import health

    gen = torch.Generator(device=card).manual_seed(1)
    chunk = health._CHUNK
    sizes = [1, 7, chunk - 1, chunk, chunk + 1, 3 * chunk + 5, 100003]
    dtypes = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
    tensors = []
    for i, n in enumerate(sizes):
        t = torch.randn(n, device=card, generator=gen) * (i + 1)
        t = t.to(dtypes[i % len(dtypes)])
        if n > 10:
            t[::97] = float("nan")
            t[5] = float("inf")
            t[-1] = -float("inf")
        tensors.append(t)
    tensors.append(torch.randn(64, 130, device=card, generator=gen)[:, ::2])
    tensors.append(torch.empty(0, device=card))
    if hasattr(torch, "float8_e4m3fn"):
        tensors.append(torch.randn(4096, device=card, generator=gen)
                       .to(torch.float8_e4m3fn))
    before = launch_counts().get("health_stats", 0)
    got = health._fused_stats(tensors)
    assert launch_counts().get("health_stats", 0) == before + 1
    want = health.stats_plain(tensors)
    want[:, 0] = np.array([t.numel() for t in tensors]) - want[:, 0]
    assert np.array_equal(got[:, 0], want[:, 0]), (got[:, 0], want[:, 0])
    assert got[:, 0].sum() > 0
    scale = np.sqrt(np.maximum(want[:, 1], 1.0))[:, None]
    assert (np.abs(got[:, 1:] - want[:, 1:]) / scale).max() < 1e-12


def test_compile_step_skip_step_bit_identical_on_card(card):
    from mxnet_tpu_torch.observability import flight_recorder, health

    health.set_policy("skip_step")
    try:
        net = mx.gluon.nn.Dense(16)
        net.initialize(ctx=mx.gpu())
        net.hybridize()
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9},
                                   kvstore=None)
        step = trainer.compile_step(net, loss_fn)
        rng = np.random.RandomState(0)
        x = mx.nd.array(rng.rand(32, 64).astype(np.float32), ctx=mx.gpu())
        y = mx.nd.array(rng.randint(0, 16, 32).astype(np.float32),
                        ctx=mx.gpu())
        step(x, y).asnumpy()
        before = {k: p.data().asnumpy().copy()
                  for k, p in net.collect_params().items()}
        states = [a.asnumpy().copy()
                  for s in trainer._updaters[0].states.values()
                  for a in mx.optimizer.flat_state(s)]
        bad = mx.nd.array(np.full((32, 64), np.nan, np.float32),
                          ctx=mx.gpu())
        step(bad, y).asnumpy()
        for k, p in net.collect_params().items():
            assert np.array_equal(p.data().asnumpy(), before[k]), k
        now = [a.asnumpy() for s in trainer._updaters[0].states.values()
               for a in mx.optimizer.flat_state(s)]
        assert all(np.array_equal(a, b) for a, b in zip(now, states))
        assert np.isfinite(step(x, y).asnumpy()).all()
        assert step.compile_count == 1
        assert [r["skipped"] for r in flight_recorder.snapshot()] == \
            [False, True, False]
    finally:
        health.set_policy(None)
        flight_recorder.reset()


# ------------------------------------------------ tiles: the autotuner's
def test_tile_tables_match_the_kernels(card):
    """The tile tables the tunables' spaces, the wrappers' resolution and
    the cost model read are the built kernels' own, per route, and so is
    the tensor-core route's shared memory per tile."""
    from mxnet_tpu_torch.autotune import cost_model

    assert F.compiled_tiles() == cost_model.FUSED_TILES == \
        {"simt": F.TILES, "tc": F.TC_TILES}
    assert F.compiled_tc_smem() == {
        t: cost_model.fused_tc_smem_bytes(*t) for t in F.TC_TILES}
    assert FA.compiled_rows() == FA.ROWS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_fused_tiles_are_bit_identical(card, dtype):
    """Every output is one fp32 FMA chain over k in ascending order at
    either tile, so every compiled tile gives the default tile's bits:
    ragged M, N, K, both weight layouts, the batched form too."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    dt = getattr(torch, dtype)
    for M, N, K in ((49, 96, 80), (130, 64, 64), (7, 3, 1), (200, 257, 33),
                    (3136, 256, 64)):
        for wt in (True, False):
            for ep in _EPILOGUES[:3]:
                x, w, extras = _case(M, N, K, wt, ep, dt, gen)
                path = _route(x, w, wt)
                want = F.fused_matmul(x, w, extras, ep, wt)
                for edge in F.TILES:
                    got = F.fused_matmul(x, w, extras, ep, wt,
                                         block_m=edge, block_n=edge)
                    assert cuda_build.last_variant(F.KERNEL) == str(
                        F.variant(path, edge, edge))
                    assert torch.equal(got, want), (M, N, K, wt, ep, edge)
    for B, M, N, K in ((3, 65, 129, 70), (8, 64, 64, 128), (2, 1, 7, 5)):
        x = torch.randn(B, M, K, device="cuda", generator=gen).to(dt)
        w = torch.randn(B, K, N, device="cuda", generator=gen).to(dt)
        path = _route(x, w, False)
        want = F.fused_batch_matmul(x, w)
        for edge in F.TILES:
            got = F.fused_batch_matmul(x, w, block_m=edge, block_n=edge)
            assert cuda_build.last_variant(F.BMM_KERNEL) == str(
                F.variant(path, edge, edge))
            assert torch.equal(got, want), (B, M, N, K, edge)


def test_fused_tile_outside_the_compiled_set_raises(card, tmp_path,
                                                    monkeypatch):
    x = torch.randn(64, 32, device="cuda")
    w = torch.randn(48, 32, device="cuda")
    for kw in ({"block_m": 256}, {"block_m": 64, "block_n": 128},
               {"block_m": 64, "block_k": 64}):
        with pytest.raises(MXNetError, match="not one the kernel compiles"):
            F.fused_matmul(x, w, **kw)
    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    mx.autotune.reset()
    mx.autotune.record("fusion.blocks", F.fused_shape_key(64, 48, 32),
                       {"block_m": 96, "block_n": 96, "block_k": 16},
                       dtype="float32")
    with pytest.raises(MXNetError, match="cache entry"):
        F.fused_matmul(x, w)
    mx.autotune.reset()


# ------------------------------------ fused matmul: the tensor-core route
def _route(x, w, wt):
    """The route a launch of these operands takes (2-d or batched)."""
    if x.dim() == 3:
        return F.route(x.dtype, w.dtype, w.shape[2], x.shape[2], wt,
                       x.data_ptr(), w.data_ptr(), x.stride(0), w.stride(0))
    return F.route(x.dtype, w.dtype, w.shape[0] if wt else w.shape[1],
                   x.shape[1], wt, x.data_ptr(), w.data_ptr())


def _tc_counts(kernel):
    return {v: n for (k, v), n in cuda_build.variant_counts().items()
            if k == kernel}


# (M, N, K): aligned and ragged M, N and K (K and N multiples of 8), the
# served ResNet-50's amp region shapes at bucket 1 (M 49, 196, 784, 3136)
# and fc1's (M 8, N 1000, K 2048)
_TC_SHAPES = ((49, 96, 80), (130, 64, 64), (200, 264, 40), (3136, 256, 64),
              (196, 1024, 256), (49, 2048, 512), (8, 1000, 2048),
              (784, 128, 512), (1, 8, 8))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tc_route_matches_plain(card, dtype):
    """The tensor-core route against its plain version at the 16-bit bar,
    both weight layouts, every epilogue, the output in the operands' type
    and in fp32; every launch on the route."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    dt = getattr(torch, dtype)
    cuda_build.reset_launch_counts()
    n = 0
    for M, N, K in _TC_SHAPES:
        for wt in (True, False):
            for ep in _EPILOGUES:
                for od in (None, "float32"):
                    x, w, extras = _case(M, N, K, wt, ep, dt, gen)
                    assert _route(x, w, wt) == "tc"
                    out = F.fused_matmul(x, w, extras, ep, wt, out_dtype=od)
                    ref = F.fused_matmul_reference(x, w, extras, ep, wt,
                                                   out_dtype=od)
                    assert out.dtype == ref.dtype
                    _near(out, ref, _TOL[dtype], (M, N, K, wt, ep, od))
                    n += 1
    counts = _tc_counts(F.KERNEL)
    assert sum(counts.values()) == n
    assert all(v.startswith("tc") for v in counts), counts


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tc_batch_route_matches_plain(card, dtype):
    """The batched entry on the tensor-core route: ragged M and N, the
    transposed (0, 2, 1) view of k read in place (one launch, no copy) and
    a contiguous w read MN-major, every batched epilogue."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    dt = getattr(torch, dtype)
    for B in (1, 3):
        for M in (1, 17, 129):
            for N in (8, 136):
                for K in (8, 104):
                    for i, ep in enumerate(_BMM_EPILOGUES):
                        transposed = (M + N + i) % 2 == 0
                        x, w, ex = _bmm_case(B, M, N, K, ep, dt, gen,
                                             transposed=transposed)
                        assert _route(x, w, transposed) == "tc"
                        cuda_build.reset_launch_counts()
                        out = F.fused_batch_matmul(x, w, ex, ep)
                        assert cuda_build.launch_counts() == \
                            {F.BMM_KERNEL: 1}
                        assert cuda_build.last_variant(
                            F.BMM_KERNEL).startswith("tc")
                        ref = F.fused_batch_matmul_reference(x, w, ex, ep)
                        _near(out, ref, _TOL[dtype],
                              (B, M, N, K, ep, transposed))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tc_tiles_are_bit_identical(card, dtype):
    """Every compiled tile of the tensor-core route gives the default
    tile's bits (max difference 0): each output is the same m64n64k16
    products over k in the same order at every tile."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    dt = getattr(torch, dtype)
    for M, N, K in _TC_SHAPES + ((25088, 64, 64), (6272, 512, 128)):
        for wt in (True, False):
            for ep in _EPILOGUES[:3]:
                x, w, extras = _case(M, N, K, wt, ep, dt, gen)
                want = F.fused_matmul(x, w, extras, ep, wt)
                default = cuda_build.last_variant(F.KERNEL)
                assert default == F.variant("tc", *F.tile_size(1, M, N,
                                                               route="tc"))
                for bm, bn in F.TC_TILES:
                    got = F.fused_matmul(x, w, extras, ep, wt, block_m=bm,
                                         block_n=bn)
                    assert cuda_build.last_variant(F.KERNEL) == \
                        F.variant("tc", bm, bn)
                    assert torch.equal(got, want), (M, N, K, wt, ep, bm, bn)
    for B, M, N, K, transposed in ((3, 65, 136, 72, False),
                                   (8, 64, 64, 128, True),
                                   (2, 130, 200, 8, True)):
        x, w, _ = _bmm_case(B, M, N, K, (), dt, gen, transposed=transposed)
        want = F.fused_batch_matmul(x, w)
        for bm, bn in F.TC_TILES:
            got = F.fused_batch_matmul(x, w, block_m=bm, block_n=bn)
            assert cuda_build.last_variant(F.BMM_KERNEL) == \
                F.variant("tc", bm, bn)
            assert torch.equal(got, want), (B, M, N, K, bm, bn)


def test_tc_route_refuses_without_a_fallback(card, monkeypatch):
    """A tile the route does not compile raises; a launch the tensor-core
    route refuses (here: operands it cannot take, sent to it by a patched
    route rule) raises too, and nothing else runs in its place."""
    x = torch.randn(64, 32, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(48, 32, device="cuda", dtype=torch.bfloat16)
    assert _route(x, w, True) == "tc"
    for kw in ({"block_m": 256}, {"block_m": 128, "block_n": 32},
               {"block_m": 64, "block_k": 32}):
        with pytest.raises(MXNetError, match="not one the kernel compiles"):
            F.fused_matmul(x, w, **kw)
    # a base that is not 16-byte aligned, an fp32 pair, mixed types, a K
    # that is not a multiple of 8: each the CUDA-core route's by the rule
    flat = torch.randn(64 * 32 + 1, device="cuda", dtype=torch.bfloat16)
    odd = flat[1:].view(64, 32)
    cases = [(odd, w), (x.float(), w.float()), (x, w.half()),
             (torch.randn(64, 36, device="cuda", dtype=torch.bfloat16),
              torch.randn(48, 36, device="cuda", dtype=torch.bfloat16))]
    for a, b in cases:
        assert _route(a, b, True) == "simt"
    monkeypatch.setattr(F, "route", lambda *a, **k: "tc")
    for a, b in cases:
        cuda_build.reset_launch_counts()
        with pytest.raises(MXNetError, match="launch failed on the tc"):
            F.fused_matmul(a, b, block_m=64, block_n=64)
        assert cuda_build.launch_counts().get(F.KERNEL, 0) == 0
    xb = odd.view(1, 64, 32)
    with pytest.raises(MXNetError, match="launch failed on the tc"):
        F.fused_batch_matmul(xb, w.t()[None], block_m=64, block_n=64)


def test_amp_module_step_takes_the_tc_route(card):
    """The attention block bound under default,amp: its two batch_dot
    regions launch fused_batch_matmul on the tensor-core route, and the
    first step's outputs and gradients match the same bind with
    MXNET_FUSION_KERNEL=0 within the bf16 bar."""
    B, T, D = 4, 40, 64
    sym = _attention_block(T, D, 5)
    rng = np.random.RandomState(2)
    x = rng.rand(B, T, D).astype(np.float32)
    y = (np.arange(B) % 5).astype(np.float32)
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                            label=[mx.nd.array(y, ctx=mx.cpu())])
    results = []
    for flag in (1, 0):
        mx.config.set_flag("MXNET_FUSION_KERNEL", flag)
        mx.graph_pass.set_passes("default,amp")
        try:
            mod = mx.mod.Module(sym, context=mx.gpu())
            mod.bind(data_shapes=[("data", x.shape)],
                     label_shapes=[("softmax_label", y.shape)])
            np.random.seed(1)
            mod.init_params(mx.init.Uniform(0.05))
            cuda_build.reset_launch_counts()
            mod.forward_backward(batch)
            torch.cuda.synchronize()
            counts = _tc_counts(F.BMM_KERNEL)
            assert sum(counts.values()) == (2 if flag else 0)
            assert all(v.startswith("tc") for v in counts), counts
            grp = mod._exec_group
            results.append(dict([("output", mod.get_outputs()[0].asnumpy())]
                                + [(n, g[0].asnumpy()) for n, g in
                                   zip(grp.param_names, grp.grad_arrays)]))
        finally:
            mx.graph_pass.set_passes(None)
            mx.config.set_flag("MXNET_FUSION_KERNEL", None)
    kern, plain = results
    for name in plain:
        scale = np.abs(plain["k_weight" if name == "k_bias" else name]).max()
        assert np.abs(kern[name] - plain[name]).max() <= \
            _TOL["bfloat16"] * max(scale, 1e-30), name


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_rows_are_bit_identical(card, dtype):
    """One and two warpgroups a block: a row sees the same tiles in the
    same order, so the forward (o and lse), the dq pass and the dk/dv pass
    give the default rows' bits at every compiled rows, ragged T and D,
    causal and not."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    for B, H, T, D in _FLASH_FWD_SHAPES + [(2, 2, 191, 64), (1, 3, 64, 16),
                                           (1, 1, 128, 128)]:
        for causal in (False, True):
            what = (B, H, T, D, causal)
            q, k, v, do, _ = _flash_inputs(B, H, T, D, getattr(torch, dtype),
                                           gen)
            o, lse = FA.flash_forward(q, k, v, causal)
            delta = (do.float() * o.float()).sum(-1).contiguous()
            dq = FA.flash_backward_dq(q, k, v, do, lse, delta, causal)
            dk, dv = FA.flash_backward_dkv(q, k, v, do, lse, delta, causal)
            for rows in FA.ROWS["fwd"][2]:
                o2, lse2 = FA.flash_forward(q, k, v, causal, block_q=rows)
                assert cuda_build.last_variant(FA.FWD) == str(rows)
                assert torch.equal(o2, o) and torch.equal(lse2, lse), \
                    what + (rows,)
            for rows in FA.ROWS["dq"][2]:
                got = FA.flash_backward_dq(q, k, v, do, lse, delta, causal,
                                           block_q=rows)
                assert torch.equal(got, dq), what + ("dq", rows)
            for rows in FA.ROWS["dkv"][2]:
                gk, gv = FA.flash_backward_dkv(q, k, v, do, lse, delta,
                                               causal, block_k=rows)
                assert torch.equal(gk, dk) and torch.equal(gv, dv), \
                    what + ("dkv", rows)


def test_flash_rows_outside_the_compiled_set_raise(card):
    q = torch.randn(1, 2, 70, 64, device="cuda")
    with pytest.raises(MXNetError, match="not compiled"):
        FA.flash_forward(q, q, q, block_q=128)  # fp32: 64 rows only
    hq = q.to(torch.bfloat16)
    for kw in ({"block_q": 256}, {"block_k": 128}, {"block_q_bwd": 32}):
        with pytest.raises(MXNetError, match="not compiled"):
            FA.flash_attention(hq, hq, hq, causal=True, **kw)


def test_cache_entry_changes_the_next_launch_and_capture(card, tmp_path,
                                                         monkeypatch):
    """A ``fusion.blocks`` / ``flash_attention.fwd`` entry recorded in the
    process takes effect at the next launch and at the next capture (the
    wrapper's launch record names the tile); a graph captured before the
    entry keeps its tile."""
    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    mx.autotune.reset()
    try:
        M, N, K = 3136, 256, 64
        x = torch.randn(M, K, device="cuda")
        w = torch.randn(N, K, device="cuda")
        default = F.resolve_blocks(M, N, K)[0]
        other = [e for e in F.TILES if e != default][0]
        F.fused_matmul(x, w)
        assert cuda_build.last_variant(F.KERNEL) == str(default)

        def capture():
            g = torch.cuda.CUDAGraph()
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                F.fused_matmul(x, w)  # warm on the side stream
                torch.cuda.synchronize()
                with torch.cuda.graph(g, stream=s):
                    out = F.fused_matmul(x, w)
            torch.cuda.current_stream().wait_stream(s)
            return g, out

        g0, _ = capture()
        assert cuda_build.last_variant(F.KERNEL) == str(default)
        mx.autotune.record(
            "fusion.blocks", F.fused_shape_key(M, N, K),
            {"block_m": other, "block_n": other,
             "block_k": F.TILES[other][0]}, dtype="float32")
        F.fused_matmul(x, w)
        assert cuda_build.last_variant(F.KERNEL) == str(other)
        g1, out1 = capture()
        assert cuda_build.last_variant(F.KERNEL) == str(other)
        g1.replay()
        g0.replay()
        torch.testing.assert_close(out1, F.fused_matmul_reference(x, w),
                                   rtol=1e-4, atol=1e-3)
        q = torch.randn(1, 2, 300, 64, device="cuda", dtype=torch.bfloat16)
        FA.flash_attention(q, q, q, causal=True)
        assert cuda_build.last_variant(FA.FWD) == "64"
        mx.autotune.record("flash_attention.fwd",
                           mx.autotune.flash_shape_key(300, 64, True),
                           {"block_q": 128, "block_k": 64},
                           dtype="bfloat16")
        FA.flash_attention(q, q, q, causal=True)
        assert cuda_build.last_variant(FA.FWD) == "128"
    finally:
        mx.autotune.reset()


def test_capture_runs_with_the_collector_off(card):
    """A dropped Generator's CUDA graphs, collected on the capturing
    thread in the middle of another capture, destroy their graphs there,
    a call CUDA refuses while the stream captures (the five ``reset``
    warnings of a failed prefill capture in phase 21's first runs): the
    capture collects first and keeps the collector off while the body is
    captured, and turns it back on after."""
    import gc

    from mxnet_tpu_torch import cuda_graph

    x = torch.zeros(8, device="cuda")
    seen = []

    def body():
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return x + 1

    assert gc.isenabled()
    graph, out = cuda_graph.capture(body, x.device)
    assert seen == [False] and gc.isenabled()
    graph.replay()
    torch.cuda.synchronize()
    assert out.tolist() == [1.0] * 8


def _mlp_resume_fit(resume=None, callback=None):
    """An MLP (fc1 + relu on fused_matmul) fit on the card, 2 epochs of 4
    batches shuffled from numpy seed 4, SGD 0.1 / 0.9."""
    rng = np.random.RandomState(2)
    x = rng.standard_normal((32, 12)).astype(np.float32)
    y = rng.randint(0, 5, 32).astype(np.float32)
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Activation(
        mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=64,
                              name="fc1"), act_type="relu"),
        num_hidden=5, name="fc2"), name="softmax")
    np.random.seed(4)
    mod = mx.mod.Module(net, context=mx.gpu())
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=8, shuffle=True),
            num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier(), resume=resume,
            batch_end_callback=callback)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_fit_resume_on_the_card_is_bit_exact(card, tmp_path):
    """SIGTERM from the 6th batch-end callback: the checkpoint holds the
    card's generator state beside the host's, and the resumed fit ends on
    the unbroken fit's parameters bit for bit, one fused_matmul launch a
    step in each run."""
    import signal

    from mxnet_tpu_torch.resilience import PreemptedError, load_latest

    cuda_build.reset_launch_counts()
    unbroken = _mlp_resume_fit()
    assert cuda_build.launch_counts().get("fused_matmul", 0) == 8
    calls = []

    def preempt(_param):
        calls.append(1)
        if len(calls) == 6:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(PreemptedError):
        _mlp_resume_fit(str(tmp_path), preempt)
    state = load_latest(str(tmp_path))
    assert (state.epoch, state.batch, state.step) == (1, 2, 6)
    assert len(state.rng_state) == 1 + torch.cuda.device_count()
    cuda_build.reset_launch_counts()
    resumed = _mlp_resume_fit(str(tmp_path))
    assert cuda_build.launch_counts().get("fused_matmul", 0) == 2
    for k, v in unbroken.items():
        assert resumed[k].tobytes() == v.tobytes(), k


def test_python_loss_head_takes_host_labels_on_the_card(card):
    """A PythonLossModule after a Module on the card: the iterator's
    labels (on the host) reach grad_func beside the scores, and its
    gradient flows back on the card."""
    seen = []

    def grad(scores, labels):
        seen.append((scores.context.device_type, labels.context.device_type))
        return mx.nd.softmax(scores, axis=1) - mx.nd.one_hot(labels, depth=3)

    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(mx.sym.FullyConnected(
        mx.sym.var("data"), num_hidden=3, name="fc"), label_names=None,
        context=mx.gpu()))
    seq.add(mx.mod.PythonLossModule(grad_func=grad), take_labels=True,
            auto_wiring=True)
    rng = np.random.RandomState(0)
    seq.fit(mx.io.NDArrayIter(rng.standard_normal((8, 4)).astype(np.float32),
                              np.arange(8, dtype=np.float32) % 3,
                              batch_size=4), num_epoch=1, optimizer="sgd")
    assert seen == [("gpu", "gpu")] * 2
    assert all(np.isfinite(v.asnumpy()).all()
               for v in seq.get_params()[0].values())


# ------------------------------------------------------------ sparse storage

def _sparse_inputs(seed=0, shape=(300, 500), density=0.02):
    rng = np.random.RandomState(seed)
    dense = (rng.randn(*shape) * (rng.rand(*shape) < density)) \
        .astype(np.float32)
    dense[::5] = 0
    return rng, dense


def _sparse_parts(x):
    """(stype, values, index arrays) of a result, as numpy."""
    if x.stype == "default":
        return (x.stype, x.asnumpy())
    aux = [a.cpu().numpy() for a in x._aux]
    return (x.stype, x._data.cpu().numpy(), *aux)


_SPARSE_OPS = {
    "cast_storage": lambda mx, sp, d, r: [
        sp.cast_storage(sp.cast_storage(mx.nd.array(d, ctx=r), a), b)
        for a in ("default", "row_sparse", "csr")
        for b in ("default", "row_sparse", "csr") if a != b],
    "sparse_retain": lambda mx, sp, d, r: [sp.sparse_retain(
        sp.row_sparse_array(d, ctx=r), np.arange(0, 300, 3))],
    "square_sum": lambda mx, sp, d, r: [
        sp.square_sum(sp.row_sparse_array(d, ctx=r)),
        sp.square_sum(sp.row_sparse_array(d, ctx=r), axis=1)],
    "csr_slice": lambda mx, sp, d, r: [
        sp.csr_matrix(d, ctx=r)[a:b] for a, b in ((0, 7), (13, 299),
                                                   (40, 40))],
    "dot": lambda mx, sp, d, r: [
        sp.dot(sp.csr_matrix(d, ctx=r), mx.nd.array(
            np.ones((500, 3), np.float32), ctx=r)),
        sp.dot(sp.csr_matrix(d, ctx=r), mx.nd.array(
            np.linspace(-1, 1, 900, dtype=np.float32).reshape(300, 3),
            ctx=r), transpose_a=True)],
    "rsp_add": lambda mx, sp, d, r: [
        sp.row_sparse_array(d, ctx=r) + sp.row_sparse_array(d[::-1].copy(),
                                                            ctx=r)],
}


@pytest.mark.parametrize("op", sorted(_SPARSE_OPS))
def test_sparse_op_on_card_matches_cpu(card, op):
    """Each sparse function on the card: the same storage type and index
    arrays as on the CPU, values equal (a sum in another order within
    1e-6 of the CPU's max)."""
    _, dense = _sparse_inputs()
    got = _SPARSE_OPS[op](mx, mx.nd.sparse, dense, mx.gpu())
    want = _SPARSE_OPS[op](mx, mx.nd.sparse, dense, mx.cpu())
    for g, w in zip(got, want):
        assert g.context.device_type == "gpu"
        gp, wp = _sparse_parts(g), _sparse_parts(w)
        assert gp[0] == wp[0]
        for a, b in zip(gp[2:], wp[2:]):
            np.testing.assert_array_equal(a, b)
        scale = max(1e-30, float(np.abs(wp[1]).max()) if wp[1].size else 0)
        assert np.abs(gp[1] - wp[1]).max(initial=0) <= 1e-6 * scale


def test_sparse_reductions_repeat_bit_for_bit(card):
    """dot, the row collapse of a gradient and rsp_add give the same bits
    in two runs (fixed summation order, no atomics)."""
    from mxnet_tpu_torch.ndarray.sparse import collapse_rows

    sp = mx.nd.sparse
    rng, dense = _sparse_inputs(1, (4096, 20000), 0.002)
    csr = sp.csr_matrix(dense, ctx=mx.gpu())
    rhs = mx.nd.array(rng.randn(20000, 16).astype(np.float32), ctx=mx.gpu())
    rhs_t = mx.nd.array(rng.randn(4096, 16).astype(np.float32),
                        ctx=mx.gpu())
    ids = torch.from_numpy(rng.randint(0, 50, 20000)).cuda()
    vals = torch.from_numpy(rng.randn(20000, 16).astype(np.float32)).cuda()
    a = sp.row_sparse_array(dense[:, :16], ctx=mx.gpu())
    b = sp.row_sparse_array(dense[::-1, 16:32].copy(), ctx=mx.gpu())

    def run():
        return [sp.dot(csr, rhs), sp.dot(csr, rhs_t, transpose_a=True),
                collapse_rows(ids, vals, (50, 16)), a + b]

    first, second = run(), run()
    for x, y in zip(first, second):
        assert torch.equal(x._data, y._data)


def test_sparse_embedding_lazy_updates_on_card_match_cpu(card):
    """sparse_embedding's row_sparse gradient and the lazy SGD / Adam /
    FTRL steps on the card against the same steps on the CPU."""
    rng = np.random.RandomState(5)
    w0 = rng.randn(1000, 8).astype(np.float32)
    ids = rng.randint(0, 1000, (64, 6)).astype(np.float32)
    head = rng.randn(64, 6, 8).astype(np.float32)
    for name in ("sgd", "adam", "ftrl"):
        outs = []
        for ctx in (mx.gpu(), mx.cpu()):
            w = mx.nd.array(w0, ctx=ctx)
            w.attach_grad(stype="row_sparse")
            opt = mx.optimizer.create(name, learning_rate=0.1)
            state = opt.create_state(0, w)
            for _ in range(3):
                with mx.autograd.record():
                    e = mx.nd.sparse.sparse_embedding(
                        mx.nd.array(ids, ctx=ctx), w)
                e.backward(mx.nd.array(head, ctx=ctx))
                opt.update(0, w, w.grad, state)
            outs.append((w.asnumpy(), w.grad.indices.asnumpy()))
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
        np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=0,
                                   atol=1e-6 * np.abs(outs[1][0]).max())


def test_kvstore_row_sparse_pull_on_card(card):
    sp = mx.nd.sparse
    kv = mx.kv.create("local")
    w = np.arange(3000, dtype=np.float32).reshape(1000, 3)
    kv.init("w", mx.nd.array(w, ctx=mx.gpu()))
    out = sp.zeros("row_sparse", (1000, 3), ctx=mx.gpu())
    kv.row_sparse_pull("w", out=out, row_ids=mx.nd.array(
        [7, 3, 7, 999], ctx=mx.gpu()))
    assert out._data.is_cuda and out._aux[0].is_cuda
    np.testing.assert_array_equal(out.indices.asnumpy(), [3, 7, 999])
    np.testing.assert_array_equal(out.data.asnumpy(), w[[3, 7, 999]])
    with pytest.raises(MXNetError):
        kv.row_sparse_pull("w", out=out, row_ids=mx.nd.array(
            [1000], ctx=mx.gpu()))


def test_libsvm_native_parser_loads_from_the_build_dir(card, tmp_path):
    from mxnet_tpu_torch import native

    path = tmp_path / "d.libsvm"
    path.write_text("1 0:1.5 3:2\n0 1:0.5\n")
    it = mx.io.LibSVMIter(data_libsvm=str(path), data_shape=(4,),
                          batch_size=2)
    assert native.built()["libsvmparse"].startswith(native.BUILD_DIR)
    csr = it.next().data[0].copyto(mx.gpu())
    np.testing.assert_array_equal(csr.asnumpy(),
                                  [[1.5, 0, 0, 2], [0, 0.5, 0, 0]])


def test_check_consistency_over_cpu_and_card(card):
    net = mx.sym.Activation(mx.sym.FullyConnected(
        mx.sym.var("data"), num_hidden=32, name="fc"), act_type="tanh")
    np.random.seed(0)
    outs = mx.test_utils.check_consistency(
        net, [{"ctx": mx.cpu(), "data": (16, 24)},
              {"ctx": mx.gpu(0), "data": (16, 24)}])
    assert outs[1][0].context.device_type == "gpu"
    assert mx.test_utils.list_gpus() == list(range(
        torch.cuda.device_count()))

"""The fused-matmul kernels' two routes on the CPU: the route rule (a
function of dtypes, shape and alignment alone), the tensor-core route's
tile table, default tile rule, cost and tuning keys, and the plain
versions on bf16 operands against the JAX package's. What the card runs
(the kernels, the route taken by launch counts, every tile's bits) is in
tests/test_torch_cuda.py.
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as tmx
from mxnet_tpu import autotune as jat
from mxnet_tpu.parallel import fused as jfused
from mxnet_tpu_torch import autotune as tat
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.autotune import cache, cost_model
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import fused as F

BF16, FP16, FP32 = torch.bfloat16, torch.float16, torch.float32


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.setenv("MXNET_TUNE_FINGERPRINT", "fp-A")
    for c in (cache, jat.cache):
        c.reset()
        c.reset_stats()
    yield tmp_path
    for c in (cache, jat.cache):
        c.reset()
        c.reset_stats()


@pytest.fixture(scope="module")
def amp_calls():
    """The fused_matmul calls of one amp forward of the served ResNet-50
    NHWC at buckets 1 and 8 (chip_smoke.py phase 17 (a)'s, recorded on
    meta tensors)."""
    sym = tmx.models.get_resnet(num_layers=50, layout="NHWC")
    served = tmx.sym.Group([sym, sym.get_internals()["fc1_output"]])
    return {b: chip_smoke.amp_region_calls(tmx, served, b)[1]
            for b in (1, 8)}


# ----------------------------------------------------------- the rule
@pytest.mark.parametrize("x_dt,w_dt,want", [
    (BF16, BF16, "tc"), (FP16, FP16, "tc"), (BF16, FP16, "simt"),
    (FP16, BF16, "simt"), (FP32, FP32, "simt"), (BF16, FP32, "simt"),
    (FP32, BF16, "simt")])
def test_route_by_dtype_pair(x_dt, w_dt, want):
    for wt in (True, False):
        assert F.route(x_dt, w_dt, 256, 64, wt) == want


@pytest.mark.parametrize("N,K,wt,want", [
    (256, 64, True, "tc"), (256, 64, False, "tc"),
    (1000, 2048, True, "tc"), (1001, 2048, True, "tc"),
    (1001, 2048, False, "simt"), (1004, 2048, False, "simt"),
    (256, 36, True, "simt"), (256, 36, False, "simt"),
    (8, 8, False, "tc"), (7, 8, True, "tc"), (64, 0, True, "tc")])
def test_route_by_alignment_of_k_and_n(N, K, wt, want):
    """K a multiple of 8 (16-byte rows of x, and of w when it is (N, K));
    N a multiple of 8 only where w is (K, N)."""
    assert F.route(BF16, BF16, N, K, wt) == want


@pytest.mark.parametrize("x_ptr,w_ptr,x_bs,w_bs,want", [
    (0, 0, 0, 0, "tc"), (4096, 160, 64 * 40, 40 * 8, "tc"),
    (2, 0, 0, 0, "simt"), (0, 8, 0, 0, "simt"),
    (0, 0, 4, 0, "simt"), (0, 0, 0, 12, "simt")])
def test_route_by_base_and_batch_stride(x_ptr, w_ptr, x_bs, w_bs, want):
    assert F.route(BF16, BF16, 64, 64, True, x_ptr, w_ptr, x_bs,
                   w_bs) == want


def _bmm_route(x, w):
    wt = w.stride(1) == 1
    return F.route(x.dtype, w.dtype, w.shape[2], x.shape[2], wt,
                   x.data_ptr(), w.data_ptr(), x.stride(0), w.stride(0))


def test_route_of_the_batched_view():
    """batch_dot's operands as the fuse pass hands them over: the scores'
    transposed view of a contiguous k is the K-major form (any N); the
    context's contiguous v is the MN-major form (N a multiple of 8)."""
    q = torch.zeros(4, 33, 64, dtype=BF16)
    k = torch.zeros(4, 33, 64, dtype=BF16)
    kt = k.permute(0, 2, 1)
    assert not kt.is_contiguous() and kt.stride(1) == 1
    assert _bmm_route(q, kt) == "tc"
    attn = torch.zeros(4, 33, 40, dtype=BF16)
    v = torch.zeros(4, 40, 64, dtype=BF16)
    assert _bmm_route(attn, v) == "tc"
    assert _bmm_route(attn, torch.zeros(4, 40, 63, dtype=BF16)) == "simt"
    assert _bmm_route(attn.float(), v.float()) == "simt"
    # K of 33: rows of 66 bytes
    assert _bmm_route(torch.zeros(4, 40, 33, dtype=BF16), kt) == "simt"


def test_the_route_ignores_tiles_tuning_and_flags(tune_env):
    """Nothing but dtypes, shape and alignment moves the route: the
    signature has no other input, and a tuning entry or a tile bound
    leaves it as it was."""
    before = F.route(BF16, BF16, 256, 64, False)
    tat.record("fusion.blocks", F.fused_tile_key(3136, 256, 64, "tc"),
               {"block_m": 64, "block_n": 128, "block_k": 64},
               dtype="bfloat16")
    tconfig.set_flag("MXNET_FUSION_BLOCK_M", 64)
    try:
        assert F.route(BF16, BF16, 256, 64, False) == before == "tc"
    finally:
        tconfig.set_flag("MXNET_FUSION_BLOCK_M", None)


def test_amp_resnet50_regions_all_take_the_route(amp_calls):
    """Every one of the 33 amp regions of a forward, at buckets 1 and 8:
    the 32 1x1 convolutions (w (K, N) from the HWIO weight) and fc1 (w
    (1000, 2048), fp32 output)."""
    for bucket, calls in amp_calls.items():
        assert len(calls) == chip_smoke.AMP_REGIONS
        for c in calls:
            assert c["dtypes"][:2] == ["bfloat16", "bfloat16"], c
            assert F.route(BF16, BF16, c["N"], c["K"], c["wt"]) == "tc", c
        fc = [c for c in calls if c["wt"]]
        assert [(c["M"], c["N"], c["K"], c["out_dtype"]) for c in fc] == \
            [(bucket, 1000, 2048, "float32")]


# ------------------------------------------------ tiles and the default
def test_tc_tile_table():
    assert F.TC_TILES == cost_model.FUSED_TILES["tc"]
    assert F.TILES == cost_model.FUSED_TILES["simt"]
    assert list(F.TC_TILES) == [(128, 128), (128, 64), (64, 128), (64, 64)]
    for t, depths in F.TC_TILES.items():
        assert depths == (64,)
        assert cost_model.fused_tc_smem_bytes(*t) <= cost_model.SMEM_BYTES
    # two blocks an SM at the largest tiles, three at 64 x 64
    per_sm = {t: cost_model.SM_SMEM_BYTES // (
        cost_model.fused_tc_smem_bytes(*t) + cost_model.BLOCK_RESERVED_SMEM)
        for t in F.TC_TILES}
    assert per_sm == {(128, 128): 2, (128, 64): 2, (64, 128): 2,
                      (64, 64): 3}


def test_tc_default_rule_at_the_amp_regions(amp_calls):
    """BM 64 wherever M is 49 or 196 (bucket 1's 7 x 7 and 14 x 14
    stages); no edge past M or N rounded up to 64; a tile above 64 x 64
    only where its grid fills every SM."""
    sms = cost_model.SMS
    for bucket, calls in amp_calls.items():
        for c in calls:
            M, N = c["M"], c["N"]
            bm, bn = cost_model.fused_default_tile(1, M, N, route="tc")
            assert (bm, bn) in F.TC_TILES
            assert bm <= max(64, -(-M // 64) * 64)
            assert bn <= max(64, -(-N // 64) * 64)
            if M in (49, 196):
                assert bm == 64, c
            if (bm, bn) != (64, 64):
                assert -(-M // bm) * -(-N // bn) >= sms, c
    rule = cost_model.fused_default_tile
    assert rule(1, 25088, 64, route="tc") == (128, 64)
    assert rule(1, 25088, 256, route="tc") == (128, 128)
    assert rule(1, 49, 2048, route="tc") == (64, 64)
    assert rule(1, 1, 1000, route="tc") == (64, 64)
    # the flags bound both edges
    assert rule(1, 25088, 256, route="tc", bound=64) == (64, 64)
    assert rule(1, 25088, 256, route="tc", bound=128) == (128, 128)
    # the CUDA-core rule is as it was
    assert rule(1, 25088, 256) == 128 and rule(1, 49, 2048) == 64


def test_tc_cost_prunes_and_charges_the_tensor_cores():
    ctx = {"M": 25088, "N": 256, "K": 64, "dtype_bytes": 2, "route": "tc"}
    for t in F.TC_TILES:
        c = cost_model.fused_matmul_cost(
            {"block_m": t[0], "block_n": t[1], "block_k": 64}, ctx)
        assert np.isfinite(c) and c > 0
    for bad in ({"block_m": 256, "block_n": 128, "block_k": 64},
                {"block_m": 128, "block_n": 32, "block_k": 64},
                {"block_m": 128, "block_n": 128, "block_k": 16},
                {"block_m": 64, "block_n": 64, "block_k": 32}):
        assert cost_model.fused_matmul_cost(bad, ctx) == math.inf, bad
    # the tensor-core tiles off their route, and the CUDA-core ones on it
    simt_ctx = dict(ctx, route="simt")
    assert cost_model.fused_matmul_cost(
        {"block_m": 128, "block_n": 64, "block_k": 64}, simt_ctx) == math.inf
    assert cost_model.fused_matmul_cost(
        {"block_m": 128, "block_n": 128, "block_k": 16}, ctx) == math.inf
    # bf16 on the tensor cores costs less than the same shape on the CUDA
    # cores; at M 49 the 64 x 64 grid costs less than 128 x 128
    tc = cost_model.fused_matmul_cost(
        {"block_m": 128, "block_n": 128, "block_k": 64}, ctx)
    simt = cost_model.fused_matmul_cost(
        {"block_m": 128, "block_n": 128, "block_k": 16}, simt_ctx)
    assert tc < simt
    small = {"M": 49, "N": 512, "K": 2048, "dtype_bytes": 2, "route": "tc"}
    assert cost_model.fused_matmul_cost(
        {"block_m": 64, "block_n": 64, "block_k": 64}, small) < \
        cost_model.fused_matmul_cost(
            {"block_m": 128, "block_n": 128, "block_k": 64}, small)


def test_tc_fusion_space_and_default():
    t = tat.get_tunable("fusion.blocks")
    ctx = {"M": 25088, "N": 64, "K": 256, "dtype_bytes": 2, "route": "tc"}
    alive = [c for c in t.candidates(ctx) if np.isfinite(t.cost(c, ctx))]
    assert sorted((c["block_m"], c["block_n"], c["block_k"])
                  for c in alive) == sorted(t + (64,) for t in F.TC_TILES)
    assert t.default_value(ctx) == {"block_m": 128, "block_n": 64,
                                    "block_k": 64}
    assert t.default_value(dict(ctx, M=49, N=512)) == {
        "block_m": 64, "block_n": 64, "block_k": 64}
    # without a route the space and the default are the CUDA-core route's
    simt = dict(ctx, route="simt")
    assert t.default_value(simt) == t.default_value(
        {k: v for k, v in ctx.items() if k != "route"})
    assert t.default_value(simt)["block_m"] == t.default_value(
        simt)["block_n"]


# ------------------------------------------ resolution and tuning keys
def test_tc_resolution_order_and_keys(tune_env):
    M, N, K = 25088, 256, 64
    assert F.resolve_blocks(M, N, K, dtype="bfloat16", dtype_bytes=2,
                            route="tc") == (128, 128, 64)
    assert F.resolve_blocks(M, N, K, route="tc", block_m=128,
                            block_n=64) == (128, 64, 64)
    assert F.resolve_blocks(M, N, K, route="tc", block_m=64) == (64, 64, 64)
    for kw in ({"block_m": 256}, {"block_m": 128, "block_n": 32},
               {"block_m": 64, "block_k": 32}):
        with pytest.raises(MXNetError, match="tensor-core route"):
            F.resolve_blocks(M, N, K, route="tc", **kw)
    # the route's own key: a tensor-core entry steers only that route
    assert F.fused_tile_key(M, N, K, "tc") == \
        F.fused_shape_key(M, N, K) + ("tc",)
    assert F.fused_tile_key(M, N, K) == F.fused_shape_key(M, N, K) == \
        jfused.fused_shape_key(M, N, K)
    tat.record("fusion.blocks", F.fused_tile_key(M, N, K, "tc"),
               {"block_m": 64, "block_n": 128, "block_k": 64},
               dtype="bfloat16")
    assert F.resolve_blocks(M, N, K, dtype="bfloat16", dtype_bytes=2,
                            route="tc") == (64, 128, 64)
    assert F.resolve_blocks(M, N, K, dtype="bfloat16",
                            dtype_bytes=2) == (128, 128, 16)
    tat.record("fusion.blocks", F.fused_shape_key(M, N, K),
               {"block_m": 64, "block_n": 64, "block_k": 32},
               dtype="bfloat16")
    assert F.resolve_blocks(M, N, K, dtype="bfloat16", dtype_bytes=2,
                            route="tc") == (64, 128, 64)
    # an entry naming a tile the route does not compile raises
    tat.record("fusion.blocks", F.fused_tile_key(64, 64, 64, "tc"),
               {"block_m": 32, "block_n": 64, "block_k": 64},
               dtype="bfloat16")
    with pytest.raises(MXNetError, match="cache entry"):
        F.resolve_blocks(64, 64, 64, dtype="bfloat16", route="tc")


def test_variant_names_the_route_and_tile():
    assert F.variant("tc", 128, 64) == "tc128x64"
    assert F.variant("simt", 128, 128) == 128
    assert {str(F.variant("tc", *t)) for t in F.TC_TILES} == {
        "tc128x128", "tc128x64", "tc64x128", "tc64x64"}


# ------------------------------- the plain versions on bf16 operands
@pytest.mark.parametrize("wt", [True, False])
def test_bf16_plain_version_matches_the_jax_kernel(wt):
    """The port's plain version (what the card's kernel is held to) on
    bf16 operands at a small amp-like region against the JAX package's
    fused_matmul on the same bf16 values: the same fp32 products and
    epilogue, the bf16 output within one rounding."""
    import jax.numpy as jnp

    rng = np.random.RandomState(7)
    M, N, K = 37, 24, 40
    x = rng.randn(M, K).astype(np.float32)
    w = rng.randn(*((N, K) if wt else (K, N))).astype(np.float32)
    r = rng.randn(M, N).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    ep = (("bias",), ("res", "elemwise_add"), ("act", "relu"))
    got = F.fused_matmul(torch.tensor(x).to(BF16), torch.tensor(w).to(BF16),
                         [torch.tensor(b).to(BF16), torch.tensor(r).to(BF16)],
                         ep, wt=wt).float().numpy()
    want = np.asarray(jfused.fused_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        [jnp.asarray(b, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16)],
        ep, wt=wt, interpret=True).astype(jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2e-2 * scale

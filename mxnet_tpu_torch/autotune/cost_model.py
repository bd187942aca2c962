"""The roofline calibration table of the card, and the analytic costs the
autotuner's search prunes and ranks with.

Counterpart of ``mxnet_tpu/autotune/cost_model.py``: its calibration table
(``CEILINGS``, :func:`ridge_intensity`, :func:`roofline_seconds`), the
serving ladder's cost, and the flash-attention and fused-matmul costs
rebuilt for this card (see "Kernel tiles" below). The JAX
package has one matmul ceiling, its chip's bf16 rate. An H100 needs one per
compute dtype: the port's fp32 paths run with TF32 off on the CUDA cores,
its bf16 paths on the tensor cores. So every ceiling here is keyed by the
compute dtype (``"float32"`` / ``"bfloat16"``), and :func:`compute_dtype`
maps a program's ``dtype_bytes`` (4 or 2) onto it.

Two bases, as ``bench_all.py``'s ``mfu`` / ``mfu_spec`` fields:

* measured: ``torch.matmul`` at 8192^3 per dtype (TF32 off) and the copy
  bandwidth of a 1 GiB device-to-device ``copy_`` (:func:`measure_ceilings`,
  printed by ``chip_smoke.py`` phase 20 (c));
* spec: the H100 SXM datasheet, 67 TFLOP/s fp32, 989 TFLOP/s bf16 dense,
  3.35 TB/s.

``CARD`` is the fingerprint the measured side was taken on, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints it.

Kernel tiles. The tiles the hand-written kernels compile are tables here,
the one source the tunables' spaces, the kernel wrappers' resolution
(parallel/fused.py, parallel/flash_attention.py) and these costs read
(the card tests hold them to the kernels' own tables): ``FUSED_TILES``
(csrc/fused_matmul.cu ``TILES`` and ``TC_TILES``, one table per route)
and ``FLASH_ROWS``
(csrc/flash_attention.cu ``compiled_rows``). A candidate outside them
costs ``inf``, and so does one whose shared memory a block cannot hold
(:data:`SMEM_BYTES`, from each kernel's own per-block formula). Where the
TPU model charged a fixed cost per grid step, these charge wave
quantisation: a grid of ``blocks`` at ``per_sm`` resident blocks an SM
runs in ``ceil(blocks / (SMS * per_sm))`` waves, and the roofline time is
divided by the share of those waves' slots the grid fills.
"""
from __future__ import annotations

import math

__all__ = ["MEASURED_MATMUL_TF", "MEASURED_HBM_GBPS", "SPEC_MATMUL_TF",
           "SPEC_HBM_GBPS", "CARD", "CEILINGS", "SMS", "SMEM_BYTES",
           "FUSED_TILES", "FLASH_ROWS", "compute_dtype", "ridge_intensity",
           "roofline_seconds", "measure_ceilings", "pow2_at_least",
           "expected_padding", "ladder_cost", "wave_efficiency",
           "flash_smem_bytes", "flash_fwd_cost", "flash_bwd_cost",
           "fused_smem_bytes", "fused_tc_smem_bytes", "fused_default_tile",
           "fused_matmul_cost"]

#: the card the measured ceilings come from (``nvidia-smi``); each figure
#: is the best of two runs of ``chip_smoke.py`` phase 20 (c), which calls
#: :func:`measure_ceilings` (torch 2.11, CUDA 12.8; the other run: 50.93 /
#: 752.68 TFLOP/s, 2927.7 GB/s)
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: torch.matmul at 8192^3 (TF32 off for float32), TFLOP/s
MEASURED_MATMUL_TF = {"float32": 51.39, "bfloat16": 773.89}
#: device-to-device copy of 1 GiB (read + write bytes over the time), GB/s
MEASURED_HBM_GBPS = 2985.0
#: H100 SXM datasheet: fp32 on the CUDA cores, bf16 dense on the tensor cores
SPEC_MATMUL_TF = {"float32": 67.0, "bfloat16": 989.0}
SPEC_HBM_GBPS = 3350.0

#: the exported calibration table (the one basis every MFU in the port
#: divides by: observability/perf.py and chip_smoke.py)
CEILINGS = {
    "matmul_tf_s": dict(MEASURED_MATMUL_TF),
    "hbm_gb_s": MEASURED_HBM_GBPS,
    "spec_matmul_tf_s": dict(SPEC_MATMUL_TF),
    "spec_hbm_gb_s": SPEC_HBM_GBPS,
    "card": CARD,
    "source": "autotune.cost_model.measure_ceilings() on the card "
              "(chip_smoke.py phase 20 (c))",
}


def compute_dtype(dtype_bytes):
    """The ceiling key of a program whose widest tensor has
    ``dtype_bytes`` bytes an element: 2 runs on the tensor cores (bf16),
    anything else on the CUDA cores (fp32)."""
    return "bfloat16" if int(dtype_bytes) == 2 else "float32"


def ridge_intensity(dtype="float32"):
    """The roofline ridge point in FLOPs/byte at the measured ceilings of
    ``dtype``: ops whose arithmetic intensity sits below it are
    bandwidth-bound."""
    return (MEASURED_MATMUL_TF[dtype] * 1e12) / (MEASURED_HBM_GBPS * 1e9)


def roofline_seconds(flops, hbm_bytes, dtype="float32"):
    """max(compute, bandwidth) time at the measured ceilings of
    ``dtype``."""
    return max(flops / (MEASURED_MATMUL_TF[dtype] * 1e12),
               hbm_bytes / (MEASURED_HBM_GBPS * 1e9))


def measure_ceilings(device="cuda", n=8192, copy_bytes=1 << 30, reps=10):
    """Measure the card's side of the table: {"matmul_tf_s": {dtype:
    TFLOP/s}, "hbm_gb_s": GB/s}. Each figure is the best of ``reps``
    back-to-back calls timed with CUDA events after two warm-up calls;
    float32 runs with TF32 off (restored afterwards)."""
    import torch

    def best_ms(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize(device)
        best = math.inf
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"matmul_tf_s": {}, "n": n, "copy_bytes": copy_bytes}
    try:
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            g = torch.Generator(device=device).manual_seed(0)
            a = torch.randn(n, n, device=device, dtype=dt, generator=g)
            b = torch.randn(n, n, device=device, dtype=dt, generator=g)
            ms = best_ms(lambda: torch.matmul(a, b))
            out["matmul_tf_s"][name] = 2.0 * n ** 3 / (ms * 1e-3) / 1e12
            del a, b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    src = torch.empty(copy_bytes // 4, device=device, dtype=torch.float32)
    dst = torch.empty_like(src)
    src.fill_(1.0)
    ms = best_ms(lambda: dst.copy_(src))
    out["hbm_gb_s"] = 2.0 * copy_bytes / (ms * 1e-3) / 1e9
    return out


def pow2_at_least(n):
    """Smallest power of two >= n (shape-bucket / ladder-top rounding)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def expected_padding(ladder, sizes):
    """(padded_rows / real_rows) of serving ``sizes`` under ``ladder``,
    with oversize requests chunked at the largest bucket first — the
    engine's admission behavior (serving/engine.py)."""
    ladder = sorted(set(int(b) for b in ladder))
    top = ladder[-1]
    real = alloc = 0
    for n in sizes:
        n = int(n)
        real += n
        while n > top:
            alloc += top
            n -= top
        if n:
            i = 0
            while ladder[i] < n:
                i += 1
            alloc += ladder[i]
    if not real:
        return 0.0
    return (alloc - real) / real


def ladder_cost(candidate, ctx):
    """Rank bucket ladders: expected pad-waste ratio (the per-request
    compute overhead) plus a small per-bucket program penalty — the
    program count is len(ladder) x replicas forever (serving/buckets.py)."""
    ladder = candidate["buckets"]
    sizes = ctx.get("sizes") or (1,)
    if not ladder:
        return math.inf
    return expected_padding(ladder, sizes) + 0.02 * len(ladder)


# ------------------------------------------------------------ kernel tiles
#: streaming multiprocessors of the card (H100 SXM)
SMS = 132
#: shared memory one block may use (sm_90: 227 KB of the SM's 228)
SMEM_BYTES = 227 * 1024

#: csrc/fused_matmul.cu's compiled tiles, per route (parallel/fused.py
#: ``route``). "simt", the CUDA-core route (its TILES): output tile edge
#: (block_m = block_n) -> K-slice depth of the fp32 form (16-byte runs of
#: fp32 operands) and of every other form. "tc", the tensor-core route of
#: 16-bit operands (its TC_TILES): (block_m, block_n) -> the K depth of a
#: stage of its ring, the largest tile first
FUSED_TILES = {"simt": {128: (16, 8), 64: (32, 16)},
               "tc": {(128, 128): (64,), (128, 64): (64,), (64, 128): (64,),
                      (64, 64): (64,)}}
#: shared memory of one SM (the blocks resident on it share it), and the
#: share the runtime reserves per block
SM_SMEM_BYTES = 228 * 1024
BLOCK_RESERVED_SMEM = 1024

#: csrc/flash_attention.cu's compiled rows a block owns (its
#: compiled_rows), per pass and element width (4: the fp32 CUDA-core
#: kernels, 2: the bf16 / fp16 tensor-core kernels), the default first
FLASH_ROWS = {"fwd": {4: (64,), 2: (64, 128)},
              "dq": {4: (64,), 2: (128, 64)},
              "dkv": {4: (64,), 2: (128, 64)}}

# the streamed tile of every flash pass (k tiles of the forward and the dq
# pass; the dk/dv pass streams q tiles of 32 on the tensor cores)
_FLASH_TILE = 64


def wave_efficiency(blocks, per_sm):
    """The share of the slots of its waves a grid of ``blocks`` fills, at
    ``per_sm`` resident blocks an SM."""
    slots = SMS * max(1, int(per_sm))
    blocks = max(1, int(blocks))
    return blocks / (-(-blocks // slots) * slots)


def _flash_width(D):
    return 64 if int(D) <= 64 else 128


def flash_smem_bytes(rows, D, dtype_bytes, which):
    """Shared memory of one block of flash pass ``which`` ("fwd", "dq",
    "dkv") at ``rows`` rows a block: the kernels' fwd_smem / dq_smem /
    dkv_smem (fp32) and fwd_tc_smem / dq_tc_smem / dkv_tc_smem (16-bit)."""
    DP = _flash_width(D)
    if int(dtype_bytes) == 4:
        LD, LP = DP + 4, 64 + 16
        floats = {"fwd": (64 + 128) * LD + 64 * LP,
                  "dq": (128 + 128) * LD + 64 * LP,
                  "dkv": (128 + 128) * LD + 2 * 64 * LP + 128}[which]
        return 4 * floats
    if which == "fwd":
        stages = 4 if DP == 64 else 3
        return rows * DP * 2 + 2 * stages * 64 * DP * 2 + 1024
    if which == "dq":
        return 2 * rows * DP * 2 + 2 * 2 * 64 * DP * 2 + 1024
    return 2 * rows * DP * 2 + 2 * 2 * 32 * DP * 2 + 2 * 2 * 32 * 4 + 1024


def _flash_per_sm(rows, D, dtype_bytes, which):
    """Resident blocks an SM the kernel's launch bounds are cut for."""
    if int(dtype_bytes) == 4:
        return 2 if _flash_width(D) == 64 else 1
    nwg = int(rows) // 64
    if which == "fwd":
        return (3 if _flash_width(D) == 64 else 2) if nwg == 1 else 1
    return (2 if _flash_width(D) == 64 else 1) * 2 // nwg


def _flash_pass_cost(ctx, rows, which):
    T = int(ctx["T"])
    D = int(ctx.get("D", 64))
    BH = int(ctx.get("B", 1)) * int(ctx.get("H", 1))
    causal = bool(ctx.get("causal", False))
    db = int(ctx.get("dtype_bytes", 2))
    rows = int(rows)
    if rows not in FLASH_ROWS[which][4 if db == 4 else 2]:
        return math.inf
    if flash_smem_bytes(rows, D, db, which) > SMEM_BYTES:
        return math.inf
    live = (T * (T + 1) / 2.0) if causal else float(T * T)
    # operations per live (q, k) pair: QK^T and PV; S, dP, dS.K; S, dP,
    # P^T.dO, dS^T.Q
    flops = BH * live * D * {"fwd": 4, "dq": 6, "dkv": 8}[which]
    n_blocks = -(-T // rows)
    frac = live / float(T * T)
    # each block streams the two tensors of the other side it sees once;
    # its own rows and its outputs move once
    own = {"fwd": 2, "dq": 3, "dkv": 4}[which]
    traffic = BH * (n_blocks * frac * 2 * T * D * db
                    + own * T * D * db + 2 * T * 4)
    roof = roofline_seconds(flops, traffic, compute_dtype(db))
    per_sm = _flash_per_sm(rows, D, db, which)
    return roof / wave_efficiency(BH * n_blocks, per_sm)


def flash_fwd_cost(candidate, ctx):
    """Estimated seconds of one flash-attention forward with
    ``candidate["block_q"]`` q rows a block; ``block_k`` is the streamed
    k tile, which the kernels compile at 64 only. ``inf`` for a tile the
    kernel does not compile or whose shared memory a block cannot hold."""
    if int(candidate.get("block_k", _FLASH_TILE)) != _FLASH_TILE:
        return math.inf
    return _flash_pass_cost(ctx, candidate["block_q"], "fwd")


def flash_bwd_cost(candidate, ctx):
    """Estimated seconds of the two backward passes: the dq pass at
    ``block_q`` q rows a block and the dk/dv pass at ``block_k`` k rows a
    block."""
    return (_flash_pass_cost(ctx, candidate["block_q"], "dq")
            + _flash_pass_cost(ctx, candidate["block_k"], "dkv"))


def _up64(v):
    return max(64, -(-int(v) // 64) * 64)


def fused_default_tile(B, M, N, sms=SMS, bound=None, route="simt"):
    """The tile a fused-matmul launch on ``route`` takes when nothing names
    one (the wrapper always tells the kernel its tile).

    "simt": the edge 128 where that grid of B (M, N) outputs fills every SM
    at least once, else 64, capped at the largest compiled edge within
    ``bound`` (the smallest edge where none fits).

    "tc": ``(block_m, block_n)``, the first of the route's tiles, largest
    first, whose edges do not pass M and N rounded up to 64 and whose grid
    fills every SM at least once; where none does, 64 x 64 (a small grid,
    such as the served ResNet-50's 7 x 7 and 14 x 14 stages at bucket 1,
    keeps the most blocks). Both edges at most ``bound``."""
    if route == "tc":
        cap = math.inf if bound is None else max(64, int(bound))
        for bm, bn in FUSED_TILES["tc"]:
            if bm > _up64(M) or bn > _up64(N) or max(bm, bn) > cap:
                continue
            if -(-int(M) // bm) * -(-int(N) // bn) * int(B) >= int(sms):
                return bm, bn
        return 64, 64
    blocks = -(-int(M) // 128) * -(-int(N) // 128) * int(B)
    tile = 128 if blocks >= int(sms) else 64
    if bound is not None:
        fits = [e for e in FUSED_TILES["simt"] if e <= int(bound)]
        tile = min(tile, max(fits)) if fits else min(FUSED_TILES["simt"])
    return tile


def fused_smem_bytes(tile, depth):
    """Shared memory of one CUDA-core fused-matmul block: two buffers of X
    and W slices, ``4 * depth * (tile + 4)`` floats (fused_matmul.cu)."""
    return 4 * 4 * int(depth) * (int(tile) + 4)


def fused_tc_smem_bytes(block_m, block_n):
    """Dynamic shared memory of one tensor-core fused-matmul block
    (fused_matmul.cu ``tc_smem``): a ring of 3 stages at 128 x 128, else 4,
    each a (block_m + block_n) x 64 tile pair of 16-bit elements, and 1024
    bytes to align the swizzle atoms."""
    bm, bn = int(block_m), int(block_n)
    stages = 3 if bm * bn >= 128 * 128 else 4
    return stages * (bm + bn) * 128 + 1024


def _fused_tc_cost(bm, bn, bk, M, N, K, B, db):
    """The tensor-core route: the bf16 ceiling, the padded tiles' products
    (the tensor cores multiply whole tiles), the blocks the shared memory
    lets an SM hold."""
    if (bm, bn) not in FUSED_TILES["tc"] or \
            bk != FUSED_TILES["tc"][bm, bn][0]:
        return math.inf
    smem = fused_tc_smem_bytes(bm, bn)
    if smem > SMEM_BYTES:
        return math.inf
    n_m, n_n = -(-M // bm), -(-N // bn)
    flops = 2.0 * B * n_m * bm * n_n * bn * K
    traffic = B * (M * K * n_n + K * N * n_m + M * N) * db
    roof = roofline_seconds(flops, traffic, "bfloat16")
    per_sm = SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM)
    return roof / wave_efficiency(B * n_m * n_n, per_sm)


def fused_matmul_cost(candidate, ctx):
    """Estimated seconds of one fused (M, K) x (K, N) region (times
    ``ctx["B"]`` when batched) at this tile on ``ctx["route"]`` (default
    the CUDA-core route, "simt"); ``inf`` for a tile the route does not
    compile. On the CUDA-core route ``block_m == block_n`` is a compiled
    edge and ``block_k`` its recorded depth, the deepest it compiles (the
    kernel's form picks the depth it runs, so each tile is one candidate);
    the product runs in fp32 on the CUDA cores whatever the operand type.
    On the tensor-core route ``(block_m, block_n)`` is one of its tiles and
    ``block_k`` the stage depth; the product is charged at the bf16
    ceiling. The traffic charges X once per column of tiles and W once per
    row of tiles, as the tiles stream them."""
    M = int(ctx.get("M", 1024))
    N = int(ctx.get("N", 1024))
    K = int(ctx.get("K", 1024))
    B = int(ctx.get("B", 1))
    db = int(ctx.get("dtype_bytes", 4))
    bm, bn, bk = (int(candidate["block_m"]), int(candidate["block_n"]),
                  int(candidate["block_k"]))
    if ctx.get("route", "simt") == "tc":
        return _fused_tc_cost(bm, bn, bk, M, N, K, B, db)
    tiles = FUSED_TILES["simt"]
    if bm != bn or bm not in tiles or bk != tiles[bm][0]:
        return math.inf
    if fused_smem_bytes(bm, bk) > SMEM_BYTES:
        return math.inf
    n_m, n_n = -(-M // bm), -(-N // bn)
    flops = 2.0 * B * M * N * K
    traffic = B * (M * K * n_n + K * N * n_m + M * N) * db
    roof = roofline_seconds(flops, traffic, "float32")
    # 256 threads of 128 registers: two blocks an SM
    return roof / wave_efficiency(B * n_m * n_n, 2)

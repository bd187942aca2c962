"""The roofline calibration table of the card, and the analytic cost of a
serving bucket ladder.

Counterpart of ``mxnet_tpu/autotune/cost_model.py``: its calibration table
(``CEILINGS``, :func:`ridge_intensity`, :func:`roofline_seconds`) and the
part the ladder's tunable declaration (serving/buckets.py) uses. The JAX
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
The flash and fused cost models of the JAX package's autotuner wait for the
port's autotune slice.
"""
from __future__ import annotations

import math

__all__ = ["MEASURED_MATMUL_TF", "MEASURED_HBM_GBPS", "SPEC_MATMUL_TF",
           "SPEC_HBM_GBPS", "CARD", "CEILINGS", "compute_dtype",
           "ridge_intensity", "roofline_seconds", "measure_ceilings",
           "pow2_at_least", "expected_padding", "ladder_cost"]

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

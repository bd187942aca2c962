#!/usr/bin/env python3
"""Where the time of one causal-LM training step goes on the CUDA card.

    python3 tools/port_train_profile.py [--out profile.json] [--steps N]

Trains ``mxnet_tpu_torch.parallel.TransformerParallel`` at the
configuration of chip_smoke.py's train phase (vocab 32768, d 512, 8 heads,
8 layers, d_ff 2048, 1 expert, bf16; B 8, T 2048; SGD lr 0.01; parameters
from ``init(0)``) and reports:

* the host wall time of a step, fenced by ``loss.item()`` (median),
* under ``torch.profiler`` over ``--steps`` steps: device kernel time per
  step, by kernel name and by family (the three flash-attention kernels,
  cuBLAS GEMMs, softmax, elementwise/reduce, copies), and the device's
  busy share of the step's wall time.

Needs one card.
"""
import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def family(name):
    n = name.lower()
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if kernel in n:
            return kernel + " (port kernel)"
    if any(k in n for k in ("gemm", "cutlass", "xmma", "sm90_", "cublas",
                            "nvjet")):
        return "cuBLAS GEMM"
    if "softmax" in n:
        return "softmax"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copies"
    if any(k in n for k in ("elementwise", "vectorized", "reduce", "gelu",
                            "embedding", "index", "gather", "scatter")):
        return "elementwise / reduce"
    return "other"


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the results here as JSON")
    parser.add_argument("--steps", type=int, default=3,
                        help="profiled steps (default 3)")
    opts = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_train_profile: CUDA is not available", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx

    card = chip_smoke.nvidia_smi()
    print(card, flush=True)
    cfg = chip_smoke.TRAIN_CFG
    B, T = chip_smoke.TRAIN_B, chip_smoke.TRAIN_T
    tp = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                         dtype="bfloat16", **cfg)
    params = tp.init(0)
    tok = np.random.RandomState(0).randint(0, cfg["vocab"], (B, T)) \
        .astype(np.int32)
    tok, tgt = tp.shard_batch(tok, np.roll(tok, -1, axis=1))
    step = tp.step_fn(lr=chip_smoke.TRAIN_LR)
    for _ in range(3):
        params, loss = step(params, tok, tgt)
    loss.item()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        params, loss = step(params, tok, tgt)
        loss.item()  # graftlint: disable=G001 — the fence of each timed step
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(opts.steps):
            params, loss = step(params, tok, tgt)
        loss.item()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us / 1e3
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device time")
    n = opts.steps
    fams = {}
    for name, ms in by_name.items():
        fams[family(name)] = fams.get(family(name), 0.0) + ms / n
    device_ms = sum(by_name.values()) / n
    row = {
        "card": card, "B": B, "T": T, "config": cfg,
        "wall_ms_median": statistics.median(walls), "wall_ms": walls,
        "tokens_per_s": B * T / (statistics.median(walls) / 1e3),
        "profiled_wall_ms_per_step": window_ms / n,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / (window_ms / n),
        "families_ms": fams,
        "top_kernels_ms": [(k, v / n) for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:12]],
    }
    print("train step B=%d T=%d: wall median %.3f ms (%.1f tokens/s), device "
          "%.3f ms/step, busy %.3f" % (B, T, row["wall_ms_median"],
                                       row["tokens_per_s"], device_ms,
                                       row["device_busy_share"]), flush=True)
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print("    %9.3f ms  %.3f  %s" % (ms, ms / device_ms, fam),
              flush=True)
    for name, ms in row["top_kernels_ms"]:
        print("    %9.3f ms  %s" % (ms, name[:110]), flush=True)
    if opts.out:
        if os.path.dirname(opts.out):
            os.makedirs(os.path.dirname(opts.out), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(row, f, indent=1)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

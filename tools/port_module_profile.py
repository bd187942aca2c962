#!/usr/bin/env python3
"""Where the time of one symbolic ``Module`` training step goes on the card.

    python3 tools/port_module_profile.py [--out profile.json] [--steps N]

Binds the attention block of chip_smoke.py's Module phase (bench_all.py's
fusion-bench ``tblock``: 16 classes, fp32, ``mx.init.Uniform(0.05)``, SGD
lr 0.01) through ``mxnet_tpu_torch.mod.Module`` on the card at both of
its sizes (B 8, T 64, D 128 and B 8, T 2048, D 512) and reports, for each:

* the host wall time of a ``forward_backward`` + ``update`` step, each
  fenced by ``torch.cuda.synchronize()`` (median of 10),
* under ``torch.profiler`` over ``--steps`` steps: device kernel time per
  step by kernel name and by family (the port's fused matmul kernel,
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def family(name):
    n = name.lower()
    if "fused_matmul_kernel" in n:
        return "fused_batch_matmul (port kernel)"
    if any(k in n for k in ("gemm", "cutlass", "xmma", "sm90_", "cublas",
                            "nvjet")):
        return "cuBLAS GEMM"
    if "softmax" in n:
        return "softmax"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copies"
    if any(k in n for k in ("elementwise", "vectorized", "reduce", "index",
                            "gather", "scatter")):
        return "elementwise / reduce"
    return "other"


def profile_size(mx, size, cfg, n_prof):
    import torch
    from torch.profiler import ProfilerActivity, profile

    sym = chip_smoke.attention_block(mx, cfg["T"], cfg["D"])
    x, y = chip_smoke.block_data(cfg["B"], cfg["T"], cfg["D"])
    mod = chip_smoke.bound_module(mx, sym, x.shape, y.shape)
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params={"learning_rate":
                                         chip_smoke.BLOCK_LR})
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.gpu())],
                            label=[mx.nd.array(y, ctx=mx.gpu())])

    def step():
        mod.forward_backward(batch)
        mod.update()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
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
    fams = {}
    for name, ms in by_name.items():
        fams[family(name)] = fams.get(family(name), 0.0) + ms / n_prof
    device_ms = sum(by_name.values()) / n_prof
    row = {
        "size": size, "cfg": cfg,
        "wall_ms_median": statistics.median(walls), "wall_ms": walls,
        "samples_per_s": cfg["B"] / statistics.median(walls) * 1e3,
        "profiled_wall_ms_per_step": window_ms / n_prof,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / (window_ms / n_prof),
        "families_ms": fams,
        "top_kernels_ms": [(k, v / n_prof) for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
    }
    print("module step %s %s: wall median %.3f ms (%.1f samples/s), device "
          "%.3f ms/step, busy %.3f" % (size, cfg, row["wall_ms_median"],
                                       row["samples_per_s"], device_ms,
                                       row["device_busy_share"]), flush=True)
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print("    %9.3f ms  %.3f  %s" % (ms, ms / device_ms, fam),
              flush=True)
    for name, ms in row["top_kernels_ms"]:
        print("    %9.3f ms  %s" % (ms, name[:110]), flush=True)
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the results here as JSON")
    parser.add_argument("--steps", type=int, default=3,
                        help="profiled steps per size (default 3)")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_module_profile: CUDA is not available", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.nvidia_smi()
    print(card, flush=True)
    rows = [profile_size(mx, size, cfg, opts.steps)
            for size, cfg in chip_smoke.BLOCK_SIZES.items()]
    if opts.out:
        if os.path.dirname(opts.out):
            os.makedirs(os.path.dirname(opts.out), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of one served ResNet-50 request goes on the CUDA card.

    python3 tools/port_serve_profile.py [--out profile.json]

Serves ResNet-50 NHWC (224x224, fp32, the random He-initialised weights of
chip_smoke.py, logits centred the same way) through
``mxnet_tpu_torch.serving.InferenceServer`` (each bucket one CUDA graph,
replayed per request) with ``max_wait_ms=0`` (no micro-batching wait, so a
request's wall time is its own), and, for buckets 1 and 8, with the fused
kernel on and off (MXNET_FUSION_KERNEL):

* the host wall time of a request (median over repeated predicts),
* under ``torch.profiler``: device kernel time per forward, by kernel name
  and by family (the port's fused matmul, cuDNN/cuBLAS, elementwise, copy),
  and the device's busy share of the request's wall time.

TF32 is off for matmuls and cuDNN, as in chip_smoke.py. Needs one card.
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
    if "fused_matmul" in n:
        return "fused_matmul (port kernel)"
    if any(k in n for k in ("conv", "cudnn", "implicit", "winograd",
                            "xmma", "sm90_", "cutlass", "gemm")):
        return "cuDNN / cuBLAS"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copies"
    if "pool" in n:
        return "pooling"
    if "elementwise" in n or "vectorized" in n or "reduce" in n \
            or "softmax" in n:
        return "elementwise / reduce"
    return "other"


def profile_bucket(mx, srv, bucket, n_wall=20, n_prof=5):
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = np.random.default_rng(bucket).standard_normal(
        (bucket, 224, 224, 3), dtype=np.float32)
    for _ in range(3):
        srv.predict(x, timeout=600)
    walls = []
    for _ in range(n_wall):
        t0 = time.perf_counter()
        srv.predict(x, timeout=600)
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            srv.predict(x, timeout=600)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "bucket": bucket,
        "wall_ms_median": statistics.median(walls),
        "wall_ms": walls,
        "profiled_wall_ms_per_request": window_ms / n_prof,
        "device_ms_per_request": device_ms,
        "device_busy_share": device_ms / (window_ms / n_prof),
        "families_ms": fams,
        "top_kernels_ms": [(k, v / n_prof) for k, v in top],
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the results here as JSON")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_serve_profile: CUDA is not available", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.nvidia_smi()
    print(card, flush=True)
    sym = mx.models.get_resnet(num_layers=50, layout="NHWC")
    np_args, np_aux = chip_smoke.resnet50_params(sym, seed=0)
    chip_smoke.center_fc_bias(mx, sym, np_args, np_aux,
                              np.random.default_rng(1))
    args, aux = mx.params_from_jax(np_args, np_aux, device="cuda")
    results = {"card": card, "runs": []}
    for kernel in (1, 0):
        mx.config.set_flag("MXNET_FUSION_KERNEL", kernel)
        srv = mx.serving.InferenceServer(
            sym, args, aux, data_shapes=[("data", (1, 224, 224, 3))],
            config=mx.serving.ServingConfig(buckets=(1, 8), max_wait_ms=0))
        try:
            srv.warmup()
            for bucket in (1, 8):
                row = profile_bucket(mx, srv, bucket)
                row["fusion_kernel"] = kernel
                results["runs"].append(row)
                print("kernel=%d bucket=%d wall median %.3f ms, device "
                      "%.3f ms/request, busy %.3f; %s" % (
                          kernel, bucket, row["wall_ms_median"],
                          row["device_ms_per_request"],
                          row["device_busy_share"],
                          json.dumps({k: round(v, 4) for k, v in
                                      row["families_ms"].items()})),
                      flush=True)
                for name, ms in row["top_kernels_ms"][:5]:
                    print("    %.4f ms  %s" % (ms, name[:110]), flush=True)
        finally:
            srv.stop()
            mx.config.set_flag("MXNET_FUSION_KERNEL", None)
    if opts.out:
        if os.path.dirname(opts.out):
            os.makedirs(os.path.dirname(opts.out), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(results, f, indent=1)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

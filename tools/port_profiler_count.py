#!/usr/bin/env python3
"""Does torch.profiler see every fused_matmul kernel of a served request?

    python3 tools/port_profiler_count.py [--windows 10] [--calls 10]

Builds ``chip_smoke.py``'s phase 14 server (ResNet-50 NHWC, fp32, its
seed-0 weights, two replicas on the card, buckets 1-8, every bucket one
CUDA graph), then for buckets 1 and 8 profiles ``--windows`` windows of
``--calls`` replayed requests and as many of the eager walk
(``_GraphProgram.infer_fn()`` called directly), alternating. For each
window it prints the fused_matmul kernels that the wrapper launched, that
``key_averages()`` counts and that the device events list holds, and the
device events per call (each call's span runs to the next call's start).
A request runs 32 of them. A window that counts fewer is printed with
``MISS``. Needs one card.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def window(fn, calls):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from mxnet_tpu_torch import cuda_build

    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            with record_function("call%d" % i):
                fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    starts = sorted(e.time_range.start for e in events
                    if e.device_type == cuda
                    and "fused_matmul" in e.name.lower())
    spans = sorted(e.time_range.start for e in events
                   if e.device_type != cuda and e.name.startswith("call"))
    ends = spans[1:] + [float("inf")]
    return dict(
        wrapper=cuda_build.launch_counts().get("fused_matmul", 0),
        key_averages=sum(ev.count for ev in prof.key_averages()
                         if ev.device_type == cuda
                         and "fused_matmul" in ev.key.lower()),
        events=len(starts),
        per_call=[sum(1 for t in starts if s <= t < e)
                  for s, e in zip(spans, ends)])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--windows", type=int, default=10)
    parser.add_argument("--calls", type=int, default=10)
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_profiler_count: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cuda_build

    cs.log(cs.nvidia_smi())
    cs.log("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all(["fused_matmul"])
    sym = mx.models.get_resnet(num_layers=50, layout="NHWC")
    np_args, np_aux = cs.resnet50_params(sym, seed=0)
    cs.center_fc_bias(mx, sym, np_args, np_aux, np.random.default_rng(1))
    args, aux = mx.params_from_jax(np_args, np_aux, device="cuda")
    served = mx.sym.Group([sym, sym.get_internals()["fc1_output"]])
    srv = cs.srv_server(mx, served, args, aux)
    want = cs.KERNEL_REGIONS * opts.calls
    rng = np.random.default_rng(16)
    misses, n = 0, 0
    t0 = time.perf_counter()
    try:
        srv.warmup()
        for b in (1, 8):
            x = rng.standard_normal((b,) + cs.ROW, dtype=np.float32)
            calls = {
                "replays": lambda x=x: srv.predict(x, timeout=600),
                "eager walks": lambda x=x: [
                    o.cpu().numpy() for o in cs.eager_outputs(srv, 0, x)]}
            for _ in range(opts.windows):
                for what, fn in calls.items():
                    row = dict(bucket=b, calls=what, **window(fn, opts.calls))
                    miss = row["key_averages"] != want or \
                        row["events"] != want
                    misses += miss
                    n += 1
                    cs.log(("MISS " if miss else "ok   ") + json.dumps(row))
    finally:
        srv.stop()
    cs.log("%d windows of %d calls, %d with fewer than %d fused_matmul "
           "kernels, %.1f s" % (n, opts.calls, misses, want,
                                time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())

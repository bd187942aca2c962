#!/usr/bin/env python3
"""Run the fused-matmul kernels' tensor-core route alone on one CUDA card:
chip_smoke.py's phase 17 (a) kernel timing (the served ResNet-50's 33 amp
regions at buckets 1 and 8: the route, every tile against the default bit
for bit, the plain version, torch.addmm in bf16, the bound) and phase 6's
bf16 rows of the attention block's two batch_dot regions, with TF32 off and
every kernel built first; print ptxas's register and spill lines of
fused_matmul.cu and write the results as JSON.

    python3 tools/port_tc_matmul.py [--out tc.json]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the results here")
    opts = parser.parse_args()

    import torch

    import chip_smoke as c
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.parallel import fused as F

    if not torch.cuda.is_available():
        print("port_tc_matmul: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = c.nvidia_smi()
    c.log(card)
    cuda_build.build_all(cuda_build.kernel_names())
    for line in cuda_build.build_info(F.KERNEL)["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            c.log("ptxas:", line.strip())
    peaks = c.phase_peaks(card)
    sym = mx.models.get_resnet(num_layers=50, layout="NHWC")
    served = mx.sym.Group([sym, sym.get_internals()["fc1_output"]])
    timing, worst = c.amp_kernel_timing(mx, served, peaks)
    for b, t in timing.items():
        c.log("bucket %d: %s" % (b, json.dumps(t, default=str)))
    c.log("amp kernel-vs-plain worst %.3g" % worst)
    results = {"card": card, "peaks": peaks, "bmm_cases": [],
               "amp_kernel": {str(b): t for b, t in timing.items()},
               "amp_kernel_max_err": worst}
    gen = torch.Generator(device="cuda").manual_seed(0)
    c.bmm_bf16_rows(F, (peaks["bf16_flops"], peaks["bytes_per_s"]), gen,
                    results)
    if opts.out:
        if os.path.dirname(opts.out):
            os.makedirs(os.path.dirname(opts.out), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    c.log(c.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

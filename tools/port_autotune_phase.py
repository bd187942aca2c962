#!/usr/bin/env python3
"""Run chip_smoke.py's phase 21 (the autotuner: tile variants, the tuners,
the warm-cache gate, the learned model) alone on one CUDA card, with TF32
off and every kernel built first, and write its results as JSON.

    python3 tools/port_autotune_phase.py [--out autotune.json]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the phase's results here")
    opts = parser.parse_args()

    import torch

    import chip_smoke as c
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cuda_build

    if not torch.cuda.is_available():
        print("port_autotune_phase: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = c.nvidia_smi()
    c.log(card)
    cuda_build.build_all(cuda_build.kernel_names())
    peaks = (c.card_peaks(card.split(",")[0]), c.phase_peaks(card))
    results = {"card": card}
    variants, launches = c.autotune_phase(
        mx, mx.models.get_resnet(num_layers=50, layout="NHWC"), card, peaks,
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

"""Host cost of the kernel wrappers' tile resolution, parent against change.

Runs the same measurements in two checkouts of the repo, alternating
parent, change, change, parent (one fresh process each, on the card):

* the wall of one eager call of ``fused_matmul`` (64 x 64 x 64, bias +
  relu), ``fused_batch_matmul`` (8 x 64 x 64 x 64) and the flash forward
  (1 x 2 x 128 x 64 bf16, causal, no grad), each the median of 7 blocks of
  2000 back-to-back calls: at these shapes the host sets the pace, so the
  figure is the wrapper's host cost a launch;
* ``chip_smoke.py`` phase 7 (the attention block's ``Module``: fit and
  eager steps) and phase 9 (ResNet-50 NHWC fp32 batch 32 eager training
  steps), through each checkout's own ``chip_smoke`` functions.

The card's host is shared, so a call's wall moves by tens of percent
between processes. ``--paired`` therefore also loads the parent's package
into this process (as ``mxnet_tpu_torch_parent``, beside this checkout's)
and alternates blocks of the same call between the two, reporting the
median of the pairs' differences.

Usage, from the root of the change's checkout::

    git archive <parent commit> | tar -x -C archive_check/parent
    python3 tools/port_launch_cost_ab.py --parent archive_check/parent \\
        --out chiprun_out/launch_ab.json

``--child`` is the per-checkout measurement, run with the checkout as the
working directory; it prints one JSON line. ``--paired`` runs only the
in-process comparison.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time


def _per_call_us(fn, n=2000, blocks=7):
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(walls), walls


def _calls(pkg, torch):
    """The three host-bound calls of one package, on one set of inputs."""
    F = importlib.import_module(pkg.__name__ + ".parallel.fused")
    FA = importlib.import_module(pkg.__name__ + ".parallel.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w = (torch.randn(64, 64, device="cuda", generator=gen)
            for _ in range(2))
    b = torch.randn(64, device="cuda", generator=gen)
    ep = (("bias",), ("act", "relu"))
    xb, wb = (torch.randn(8, 64, 64, device="cuda", generator=gen)
              for _ in range(2))
    q = torch.randn(1, 2, 128, 64, device="cuda", generator=gen).to(
        torch.bfloat16)
    return {"fused_matmul": lambda: F.fused_matmul(x, w, [b], ep),
            "fused_batch_matmul": lambda: F.fused_batch_matmul(xb, wb),
            "flash_attention": lambda: FA.flash_attention(q, q, q,
                                                          causal=True)}


def _load_as(alias, root):
    path = os.path.join(root, "mxnet_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def paired(parent_root, pairs=40, n=500):
    """Blocks of ``n`` calls, alternating the parent's package and this
    checkout's in one process (the first arm alternates too)."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as smoke

    arms = {"change": importlib.import_module("mxnet_tpu_torch"),
            "parent": _load_as("mxnet_tpu_torch_parent",
                               os.path.abspath(parent_root))}
    for pkg in arms.values():
        cb = importlib.import_module(pkg.__name__ + ".cuda_build")
        cb.build_all(cb.kernel_names())
    calls = {arm: _calls(pkg, torch) for arm, pkg in arms.items()}
    out = {"card": smoke.nvidia_smi(), "pairs": pairs, "calls": n,
           "packages": {a: p.__file__ for a, p in arms.items()}}

    def block(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    with torch.no_grad():
        for name in calls["change"]:
            for arm in arms:
                for _ in range(200):
                    calls[arm][name]()
            torch.cuda.synchronize()
            us = {arm: [] for arm in arms}
            for i in range(pairs):
                order = ("parent", "change") if i % 2 == 0 else \
                    ("change", "parent")
                for arm in order:
                    us[arm].append(block(calls[arm][name]))
            diffs = sorted(c - p for c, p in zip(us["change"],
                                                 us["parent"]))
            out[name] = {
                "parent_us": statistics.median(us["parent"]),
                "change_us": statistics.median(us["change"]),
                "diff_us_median": statistics.median(diffs),
                "diff_us_quartiles": [diffs[len(diffs) // 4],
                                      diffs[3 * len(diffs) // 4]],
                "parent_blocks": us["parent"], "change_blocks": us["change"]}
            print("paired %s: parent %.2f us, change %.2f us a call; change "
                  "- parent: median %+.2f us (quartiles %+.2f, %+.2f) over "
                  "%d pairs of %d calls; %s"
                  % (name, out[name]["parent_us"], out[name]["change_us"],
                     out[name]["diff_us_median"], *out[name][
                         "diff_us_quartiles"], pairs, n, out["card"]),
                  flush=True)
    return out


def child():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all(cuda_build.kernel_names())
    card = smoke.nvidia_smi()
    out = {"root": os.getcwd(), "package": mx.__file__, "card": card}
    with torch.no_grad():
        for name, fn in _calls(mx, torch).items():
            med, walls = _per_call_us(fn)
            out[name + "_us"] = med
            out[name + "_us_blocks"] = walls
    results = {"card": card, "peaks": smoke.phase_peaks(card),
               "kernel_cases": [], "bmm_cases": []}
    smoke.module_phase(mx, card, results)
    module = results["module"]
    out["phase7_fit_ms"] = module["fit"]["ms_per_step_median"]
    out["phase7_step_ms"] = {k: v["ms_per_step"]
                             for k, v in module["steps"].items()}
    sym = mx.models.get_resnet(num_layers=50, layout="NHWC")
    peaks = smoke.card_peaks(card.split(",")[0])
    smoke.resnet_train_phase(mx, sym, card, peaks, results)
    out["phase9_ms"] = results["resnet_train"]["ms_per_step"]
    out["phase9_step_ms"] = results["resnet_train"]["step_ms"]
    print(json.dumps(out))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--paired", action="store_true")
    ap.add_argument("--parent", help="the parent's checkout")
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--out", help="write every run's JSON here")
    opts = ap.parse_args()
    if opts.child:
        return child()
    if opts.paired:
        out = paired(opts.parent)
        if opts.out:
            os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
            with open(opts.out, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    trees = {"p": os.path.abspath(opts.parent), "c": os.getcwd()}
    runs = []
    for tag in opts.order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"],
            cwd=trees[tag], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit("the %s run failed (rc %d)"
                             % (tag, proc.returncode))
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["arm"] = "parent" if tag == "p" else "change"
        runs.append(run)
        print("%-6s fused_matmul %.2f us, fused_batch_matmul %.2f us, "
              "flash_attention %.2f us a call; phase 7 fit %.3f ms/step, "
              "steps %s; phase 9 %.3f ms/step; %s"
              % (run["arm"], run["fused_matmul_us"],
                 run["fused_batch_matmul_us"], run["flash_attention_us"],
                 run["phase7_fit_ms"],
                 {k: round(v, 3) for k, v in run["phase7_step_ms"].items()},
                 run["phase9_ms"], run["card"]), flush=True)
    if opts.out:
        os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

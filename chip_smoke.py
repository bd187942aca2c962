#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, each fatal on failure (exit code != 0, no result line):

1. Print the card (``nvidia-smi`` name and power limit), turn TF32 off for
   matmuls and cuDNN (the fp32 parity below depends on it), and build every
   kernel source in ``mxnet_tpu_torch/csrc`` at once (nvcc, sm_90a).
2. Kernel phase: the fused matmul kernel against its plain PyTorch version
   on the card, at every kernel-form region shape of the ResNet-50 NHWC
   forward at buckets 1 and 8 (the shapes recorded from the forward
   itself), plus an epilogue grid in fp32/bf16/fp16 at small ragged
   shapes. Times the kernel, the plain version and a cuBLAS yardstick
   (``torch.addmm`` + the same epilogue in PyTorch) as CUDA-graph replays
   between CUDA events (device time, no host overhead), and computes the
   bound: bytes moved at the card's memory rate against
   2*M*N*K at its fp32 CUDA-core peak.
3. Serve phase: ResNet-50 NHWC at 224x224, fp32, He-initialised random
   weights from a seed, carried onto the card by ``params_from_jax``, served
   by ``InferenceServer`` over buckets (1, 2, 4, 8): warmup, 16 single-image
   requests, one 8-image batch, then back-to-back 8-image batches for
   throughput. Launch counts are reset just before and read just after;
   every forward must launch the kernel exactly 32 times. The same requests
   through a server with MXNET_FUSION_KERNEL=0 (the plain composition on
   the card) must agree: logits within 1e-3 of max |logit|, top-1 1.0.
4. Flash kernel phase: the three flash-attention kernels (forward, dq,
   dk/dv) against their plain PyTorch versions, and the autograd function
   they make against dense autograd of ``flash_attention_reference``, at
   the training path's shape (8, 8, 2048, 64) causal in bf16 and fp32 and
   on a ragged grid (T 1/17/129/1000, causal or not, D 32/64/128, with and
   without an lse cotangent). Times each kernel and PyTorch's
   ``scaled_dot_product_attention`` (forward, and forward + backward;
   timed as a yardstick only) as CUDA-graph replays and each plain
   version with CUDA events, and computes each kernel's bound at
   the card's bf16 tensor-core peak and memory rate, causal half counted.
5. Train phase: the causal-LM ``TransformerParallel`` at the full
   ``bench_transformer_lm`` configuration (vocab 32768, d 512, 8 heads,
   8 layers, d_ff 2048, 1 expert, bf16; B 8, T 2048; SGD lr 0.01). The
   first step's loss and gradients (B 2: the plain attention's T x T
   scores of 8 layers at B 8 would not fit) against the same step with
   ``_local_attention`` swapped for the plain version; then 3 warm and 10
   timed steps with launch counts reset just before: every step launches
   each flash kernel exactly 8 times, and the loss stays finite and falls.
6. Print the ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero without a result when CUDA is unavailable or the package is
not beside the script.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

BUCKETS = (1, 2, 4, 8)
ROW = (224, 224, 3)
KERNEL_REGIONS = 32       # kernel-form regions of one ResNet-50 NHWC forward
PATH_TOL = 1e-4           # fp32 kernel vs plain, relative to max |plain|
GRID_TOL = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 2e-3}
SERVE_TOL = 1e-3          # logits, relative to max |logit|

FLASH_SHAPE = (8, 8, 2048, 64)   # (B, H, T, D) of the train path
# flash kernels vs their plain versions, relative to max |plain|: both
# compute in fp32 from the same inputs, in another summation order (fp32);
# each output is then rounded once to bf16 (one bf16 ulp is 2^-8)
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_GRID_T = (1, 17, 129, 1000)
FLASH_GRID_D = (32, 64, 128)
TRAIN_CFG = dict(vocab=32768, d_model=512, n_heads=8, n_layers=8,
                 d_ff=2048, n_experts=1)
TRAIN_B, TRAIN_T, TRAIN_LR = 8, 2048, 0.01
TRAIN_WARM, TRAIN_TIMED = 3, 10
COMPARE_B = 2                    # batch of the kernel-vs-plain train step
LOSS_TOL = 1e-2                  # first-step loss, relative
GRAD_TOL = 2e-2                  # gradients, relative to max |plain grad|


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name):
    """(fp32 CUDA-core FLOP/s, memory bytes/s) from the card's data sheet
    (dense, no tensor cores)."""
    n = name.upper()
    if "H100" in n and "PCIE" in n:
        return 51.2e12, 2.0e12
    if "H100" in n and "NVL" in n:
        return 60.0e12, 3.9e12
    if "H200" in n:
        return 67.0e12, 4.8e12
    return 67.0e12, 3.35e12   # H100 SXM


def card_bf16_peak(name):
    """Dense bf16 tensor-core FLOP/s from the card's data sheet."""
    n = name.upper()
    if "H100" in n and "PCIE" in n:
        return 756e12
    if "H100" in n and "NVL" in n:
        return 835e12
    return 989e12   # H100 SXM, H200


def time_events_ms(fn, reps=5):
    """Time of one ``fn`` call from CUDA events around ``reps`` calls,
    without a CUDA graph: for calls that allocate too much to capture
    twenty of, and that run long enough (ms) to hide the host's
    enqueue."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_ms(fn, reps=20, replays=5):
    """Device time of one ``fn`` call: ``reps`` calls captured into a CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    per-call Python overhead is not in the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


# ------------------------------------------------------------ the model

def resnet50_params(sym, seed):
    """He-initialised weights; BN gamma = moving var = 1, beta = mean = 0,
    biases 0."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1, 224, 224, 3))
    args, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 \
                else shape[1]
            args[name] = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(np.sqrt(2.0 / fan_in))
        elif name.endswith("_gamma"):
            args[name] = np.ones(shape, np.float32)
        else:
            args[name] = np.zeros(shape, np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = (np.ones if name.endswith("_var") else np.zeros)(
            shape, np.float32)
    return args, aux


def center_fc_bias(mx, sym, np_args, np_aux, rng, n=16):
    """Set ``fc1_bias`` so the logits of ``n`` random calibration images
    average zero. A random He-initialised ResNet puts nearly all of its
    pooled feature in one input-independent direction, which would give
    every image the same top-1 class; removing that mean makes the top-1
    comparison of the serve phase informative. Runs the plain graph on the
    card."""
    import torch
    from mxnet_tpu_torch.executor import _GraphProgram

    internals = sym.get_internals()
    names = internals.list_outputs()
    idx = next(i for i, (node, _) in enumerate(internals._outputs)
               if node.op == "Flatten")
    args, aux = mx.params_from_jax(np_args, np_aux, device="cuda")
    x = rng.standard_normal((n,) + ROW, dtype=np.float32)
    args["data"] = torch.from_numpy(x).cuda()
    args["softmax_label"] = torch.zeros(n, device="cuda")
    (feat,) = _GraphProgram(internals).infer_fn(sel=(idx,))(args, aux)
    f_mean = feat.double().mean(0).cpu().numpy()
    np_args["fc1_bias"] = (-(np_args["fc1_weight"].astype(np.float64)
                             @ f_mean)).astype(np.float32)
    log("calibration: fc1_bias centres the logits of %d images (feature "
        "%s, mean |f| %.4g)" % (n, names[idx], np.abs(f_mean).mean()))


def record_region_calls(mx, sym, bucket):
    """The fused_matmul calls of one forward at ``bucket``, recorded from
    the optimized graph run on meta tensors (shapes only)."""
    import torch
    from mxnet_tpu_torch.executor import _GraphProgram
    from mxnet_tpu_torch.parallel import fused as F

    frozen = [a for a in sym.list_arguments()
              if a not in ("data", "softmax_label")] + \
        sym.list_auxiliary_states()
    opt = mx.graph_pass.optimize(sym, frozen=frozen,
                                 arg_shapes={"data": (1, 224, 224, 3)})
    osym = opt.symbol
    arg_shapes, _, aux_shapes = osym.infer_shape(data=(bucket, 224, 224, 3))
    args = {n: torch.empty(s, device="meta")
            for n, s in zip(osym.list_arguments(), arg_shapes)}
    aux = {n: torch.empty(s, device="meta")
           for n, s in zip(osym.list_auxiliary_states(), aux_shapes)}
    calls = []
    real = F.fused_matmul

    def record(x, w, extras=(), epilogue=(), wt=True, out_dtype=None):
        calls.append({"M": int(x.shape[0]), "K": int(x.shape[1]),
                      "N": int(w.shape[0] if wt else w.shape[1]),
                      "wt": bool(wt), "epilogue": tuple(epilogue)})
        return torch.empty((calls[-1]["M"], calls[-1]["N"]), device="meta")

    F.fused_matmul = record
    try:
        _GraphProgram(osym).infer_fn()(args, aux)
    finally:
        F.fused_matmul = real
    return calls


# ----------------------------------------------------------- kernel phase

def make_case(case, dtype, gen):
    import torch

    M, N, K, wt = case["M"], case["N"], case["K"], case["wt"]
    dev = "cuda"
    x = torch.randn(M, K, device=dev, generator=gen).to(dtype)
    w = (torch.randn(N, K, device=dev, generator=gen) if wt else
         torch.randn(K, N, device=dev, generator=gen))
    w = (w * (2.0 / K) ** 0.5).to(dtype)
    extras = []
    for step in case["epilogue"]:
        if step[0] in ("bias", "vadd", "vmul"):
            extras.append(torch.randn(N, device=dev, generator=gen)
                          .to(dtype))
        elif step[0] == "res":
            extras.append(torch.randn(M, N, device=dev, generator=gen)
                          .to(dtype))
    return x, w, extras


def library_fn(x, w, extras, epilogue, wt):
    """The yardstick: cuBLAS through torch.addmm/mm with the same epilogue
    as PyTorch ops (timed only, never used by the port)."""
    import torch

    wm = w.t() if wt else w
    steps = list(epilogue)
    ex = list(extras)
    if steps and (steps[0][0] == "bias" or steps[0] == ("res",
                                                        "elemwise_add")):
        first = ex.pop(0)
        steps.pop(0)
        y = torch.addmm(first.float(), x.float(), wm.float())
    else:
        y = torch.mm(x.float(), wm.float())
    for step in steps:
        kind = step[0]
        if kind in ("bias", "vadd"):
            y.add_(ex.pop(0))
        elif kind == "vmul":
            y.mul_(ex.pop(0))
        elif kind == "res":
            r = ex.pop(0)
            y.mul_(r) if step[1] == "elemwise_mul" else y.add_(r)
        elif kind == "act" and step[1] == "relu":
            y.relu_()
        elif kind == "act":
            y = {"sigmoid": torch.sigmoid, "tanh": torch.tanh}.get(
                step[1], lambda t: t)(y)
        elif kind == "scalar":
            y = {"_mul_scalar": lambda t: t * step[2],
                 "_div_scalar": lambda t: t / step[2],
                 "_plus_scalar": lambda t: t + step[2],
                 "_minus_scalar": lambda t: t - step[2],
                 "_rminus_scalar": lambda t: step[2] - t}[step[1]](y)
    return y.to(x.dtype)


def bound_ms(case, itemsize, peaks):
    M, N, K = case["M"], case["N"], case["K"]
    n_extra = sum(M * N if s[0] == "res" else N
                  for s in case["epilogue"]
                  if s[0] in ("bias", "vadd", "vmul", "res"))
    nbytes = (M * K + K * N + n_extra + M * N) * itemsize
    flops = 2.0 * M * N * K
    t_bytes = nbytes / peaks[1] * 1e3
    t_ops = flops / peaks[0] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def check_case(F, case, dtype, gen, tol):
    import torch

    x, w, extras = make_case(case, dtype, gen)
    out = F.fused_matmul(x, w, extras, case["epilogue"], case["wt"],
                         out_dtype=case.get("out_dtype"))
    ref = F.fused_matmul_reference(x, w, extras, case["epilogue"],
                                   case["wt"],
                                   out_dtype=case.get("out_dtype"))
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError("kernel output %s %s != plain %s %s"
                             % (tuple(out.shape), out.dtype,
                                tuple(ref.shape), ref.dtype))
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    if not torch.isfinite(out.float()).all() or err > tol * scale:
        raise AssertionError("fused_matmul disagrees with its plain version "
                             "at %s: max abs err %.3g > %.1g * %.3g"
                             % (case, err, tol, scale))
    return err, (x, w, extras)


def kernel_phase(mx, sym, peaks, results):
    import torch
    from mxnet_tpu_torch.parallel import fused as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    path_err = 0.0
    totals = {}
    for bucket in (1, 8):
        calls = record_region_calls(mx, sym, bucket)
        if len(calls) != KERNEL_REGIONS:
            raise AssertionError("bucket %d forward has %d kernel-form "
                                 "regions, want %d"
                                 % (bucket, len(calls), KERNEL_REGIONS))
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0}
        for i, case in enumerate(calls):
            err, (x, w, extras) = check_case(F, case, torch.float32, gen,
                                             PATH_TOL)
            path_err = max(path_err, err)
            ep, wt = case["epilogue"], case["wt"]
            ms = time_ms(lambda: F.fused_matmul(x, w, extras, ep, wt))
            plain = time_ms(lambda: F.fused_matmul_reference(x, w, extras,
                                                             ep, wt))
            lib = time_ms(lambda: library_fn(x, w, extras, ep, wt))
            bnd, by = bound_ms(case, 4, peaks)
            kind = "+".join(s[0] if s[0] != "act" else s[1] for s in ep)
            row = dict(bucket=bucket, region=i, M=case["M"], N=case["N"],
                       K=case["K"], epilogue=kind, max_abs_err=err, ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by)
            results["kernel_cases"].append(row)
            log("kernel bucket=%d region=%02d M=%d N=%d K=%d %s err=%.3g "
                "ms=%.4f plain_ms=%.4f library_ms=%.4f bound_ms=%.4f (%s)"
                % (bucket, i, case["M"], case["N"], case["K"], kind, err,
                   ms, plain, lib, bnd, by))
            tot["ms"] += ms
            tot["plain_ms"] += plain
            tot["library_ms"] += lib
            tot["bound_ms"] += bnd
            tot["t_ops" if by == "operations" else "t_bytes"] += bnd
        tot["bound_by"] = ("operations" if tot["t_ops"] >= tot["t_bytes"]
                           else "bytes")
        totals[bucket] = tot
        log("kernel per-forward bucket=%d: %d launches, ms=%.4f "
            "plain_ms=%.4f library_ms=%.4f bound_ms=%.4f (%s)"
            % (bucket, len(calls), tot["ms"], tot["plain_ms"],
               tot["library_ms"], tot["bound_ms"], tot["bound_by"]))

    # the epilogue grid: small ragged shapes, every step kind, three dtypes
    grid = [(("bias",), ("act", "relu")), (("vmul",), ("vadd",)),
            (("scalar", "_div_scalar", 2.0), ("res", "elemwise_add")),
            (("act", "sigmoid"),), (("act", "tanh"), ("res", "elemwise_mul")),
            (("act", "softrelu"), ("scalar", "_rminus_scalar", 1.0)),
            (("act", "softsign"), ("scalar", "_minus_scalar", 0.5),
             ("scalar", "_plus_scalar", 0.25),
             ("scalar", "_mul_scalar", 3.0))]
    for dtype in ("float32", "bfloat16", "float16"):
        for wt in (True, False):
            for ep in grid:
                case = {"M": 37, "N": 70, "K": 45, "wt": wt, "epilogue": ep}
                err, _ = check_case(F, case, getattr(torch, dtype), gen,
                                    GRID_TOL[dtype])
                log("kernel grid %s wt=%s %s err=%.3g" % (dtype, wt, ep, err))
    # a cast step: fp32 inputs, bf16 output from the one store
    case = {"M": 49, "N": 64, "K": 96, "wt": False,
            "epilogue": (("res", "elemwise_add"), ("cast", "bfloat16")),
            "out_dtype": "bfloat16"}
    err, _ = check_case(F, case, torch.float32, gen, GRID_TOL["bfloat16"])
    log("kernel grid cast->bfloat16 err=%.3g" % err)
    return path_err, totals


# ------------------------------------------------------------ serve phase

def serve(mx, served_sym, args, aux, images, batch, n_batches,
          device="cuda"):
    """One server's run: warmup, singles, one batch, then throughput."""
    import torch

    srv = mx.serving.InferenceServer(
        served_sym, args, aux, data_shapes=[("data", (1,) + ROW)],
        devices=[torch.device(device)],
        config=mx.serving.ServingConfig(buckets=BUCKETS))
    try:
        srv.warmup()
        singles, lat = [], []
        for img in images:
            t0 = time.perf_counter()
            singles.append(srv.predict(img, timeout=600))
            lat.append((time.perf_counter() - t0) * 1e3)
        batched = srv.predict(batch, timeout=600)
        t0 = time.perf_counter()
        futs = [srv.submit(batch) for _ in range(n_batches)]
        for f in futs:
            f.result(timeout=600)
        wall = time.perf_counter() - t0
        stats = srv.get_stats()
    finally:
        srv.stop()
    forwards = sum(v for k, v in stats.items() if k.startswith("bucket_"))
    return dict(singles=singles, batched=batched, latency_ms=lat,
                img_per_s=n_batches * batch.shape[0] / wall,
                forwards=forwards, stats=stats)


def compare(a, b, what):
    """a vs b outputs ([probs, logits] pairs): logit error relative to
    max |logit| and top-1 agreement."""
    worst, agree, total = 0.0, 0, 0
    for (pa, la), (pb, lb) in zip(a, b):
        la, lb = np.atleast_2d(la), np.atleast_2d(lb)
        if not (np.isfinite(la).all() and np.isfinite(pa).all()):
            raise AssertionError("%s: non-finite outputs" % what)
        worst = max(worst, float(np.abs(la - lb).max()
                                 / max(1.0, np.abs(lb).max())))
        agree += int((la.argmax(-1) == lb.argmax(-1)).sum())
        total += la.shape[0]
    return worst, agree / total


def serve_phase(mx, sym, card, results):
    from mxnet_tpu_torch import cuda_build

    rng = np.random.default_rng(1)
    np_args, np_aux = resnet50_params(sym, seed=0)
    center_fc_bias(mx, sym, np_args, np_aux, rng)
    args, aux = mx.params_from_jax(np_args, np_aux, device="cuda")
    # served outputs: the probabilities and the fc1 logits beside them
    served = mx.sym.Group([sym, sym.get_internals()["fc1_output"]])
    images = rng.standard_normal((16, 224, 224, 3), dtype=np.float32)
    batch = rng.standard_normal((8, 224, 224, 3), dtype=np.float32)

    cuda_build.reset_launch_counts()
    run = serve(mx, served, args, aux, images, batch, n_batches=16)
    launches = cuda_build.launch_counts().get("fused_matmul", 0)
    log("serve: %d forwards, %d fused_matmul launches (%d per forward)"
        % (run["forwards"], launches, launches / max(1, run["forwards"])))
    if launches != KERNEL_REGIONS * run["forwards"] or not launches:
        raise AssertionError("expected %d launches per forward, got %d over "
                             "%d forwards" % (KERNEL_REGIONS, launches,
                                              run["forwards"]))

    mx.config.set_flag("MXNET_FUSION_KERNEL", 0)
    cuda_build.reset_launch_counts()
    try:
        plain = serve(mx, served, args, aux, images, batch, n_batches=4)
    finally:
        mx.config.set_flag("MXNET_FUSION_KERNEL", None)
    if cuda_build.launch_counts().get("fused_matmul", 0):
        raise AssertionError("MXNET_FUSION_KERNEL=0 still launched the "
                             "kernel")

    for probs, logits in run["singles"]:
        if probs.shape != (1000,) or logits.shape != (1000,):
            raise AssertionError("single-image output shape %s / %s"
                                 % (probs.shape, logits.shape))
        if abs(float(probs.sum()) - 1.0) > 1e-3:
            raise AssertionError("probabilities sum to %s" % probs.sum())
    if run["batched"][0].shape != (8, 1000):
        raise AssertionError("batched output shape %s"
                             % (run["batched"][0].shape,))
    logits = np.stack([lg for _p, lg in run["singles"]])
    log("serve: logits max |.| %.4g, std %.4g, %d distinct top-1 classes "
        "over %d images" % (np.abs(logits).max(), logits.std(),
                            len(set(logits.argmax(-1))), len(logits)))
    err, top1 = compare(run["singles"] + [run["batched"]],
                        plain["singles"] + [plain["batched"]], "serve")
    log("serve vs plain composition: max logit err %.3g (rel. max |logit|),"
        " top-1 agreement %.4f" % (err, top1))
    if err > SERVE_TOL or top1 != 1.0:
        raise AssertionError("served logits disagree with the plain "
                             "composition: err %.3g, top-1 %.4f"
                             % (err, top1))
    p50 = float(np.percentile(run["latency_ms"], 50))
    results["serve"] = dict(
        forwards=run["forwards"], launches=launches,
        latency_ms=run["latency_ms"], p50_ms=p50,
        img_per_s_bucket8=run["img_per_s"],
        plain_p50_ms=float(np.percentile(plain["latency_ms"], 50)),
        plain_img_per_s_bucket8=plain["img_per_s"],
        max_logit_err=err, top1_agreement=top1)
    log("serve: p50 single-image latency %.3f ms, %.1f img/s at bucket 8 "
        "(plain composition: p50 %.3f ms, %.1f img/s) on %s"
        % (p50, run["img_per_s"], results["serve"]["plain_p50_ms"],
           plain["img_per_s"], card))
    return launches


# ------------------------------------------------------------ flash phase

def flash_module():
    import importlib

    # the package's ``flash_attention`` name is the function
    return importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")


def flash_bound_ms(kind, shape, causal, itemsize, bf16_peak, bytes_per_s):
    """Least time of one launch: operations over the bf16 tensor-core peak
    against bytes over the memory rate. Operations per live (q, k) pair:
    4*D forward (QK^T, PV), 6*D dq (S, dP, dS.K), 8*D dk/dv (S, dP, P^T.dO,
    dS^T.Q); causal counts the T(T+1)/2 live pairs. Bytes: each input read
    once and each output written once (n = one (B, H, T, D) tensor, r = one
    (B, H, T) fp32 row vector): forward 3n in, n + r out; dq 4n + 2r in, n
    out; dk/dv 4n + 2r in, 2n out."""
    B, H, T, D = shape
    pairs = T * (T + 1) / 2.0 if causal else float(T * T)
    ops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * B * H * pairs * D
    n = B * H * T * D * itemsize
    r = B * H * T * 4
    nbytes = {"fwd": 4 * n + r, "dq": 5 * n + 2 * r, "dkv": 6 * n + 2 * r}[kind]
    t_ops = ops / bf16_peak * 1e3
    t_bytes = nbytes / bytes_per_s * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), ops, nbytes


def flash_inputs(shape, dtype, gen):
    import torch

    q, k, v, do = (torch.randn(*shape, device="cuda", generator=gen)
                   .to(dtype) for _ in range(4))
    dlse = torch.randn(*shape[:3], device="cuda", generator=gen)
    return q, k, v, do, dlse


def rel_err(out, ref, what):
    import torch

    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError("%s: kernel %s %s != plain %s %s"
                             % (what, tuple(out.shape), out.dtype,
                                tuple(ref.shape), ref.dtype))
    if not (torch.isfinite(out.float()).all()
            and torch.isfinite(ref.float()).all()):
        raise AssertionError("%s: non-finite output" % what)
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def check_flash(FA, q, k, v, do, dlse, causal, tol, what):
    """Each kernel against its plain version on the same inputs, then the
    autograd function against dense autograd of the reference. Returns
    the max abs error of each kernel."""
    import torch

    D = q.shape[-1]
    scale = D ** -0.5
    errs = {}

    def hold(kernel, out, ref, name, bar=tol):
        err, rel = rel_err(out, ref, "%s %s" % (what, name))
        if rel > bar:
            raise AssertionError("%s disagrees with its plain version at %s "
                                 "(%s): max abs err %.3g, %.3g of max |plain|"
                                 " > %.1g" % (kernel, what, name, err, rel,
                                              bar))
        errs[kernel] = max(errs.get(kernel, 0.0), err)

    o, lse = FA.flash_forward(q, k, v, causal)
    ro, rlse = FA.flash_forward_reference(q, k, v, causal, scale)
    hold(FA.FWD, o, ro, "o")
    hold(FA.FWD, lse, rlse, "lse", FLASH_TOL["float32"])
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse
    delta = delta.contiguous()
    dq = FA.flash_backward_dq(q, k, v, do, lse, delta, causal)
    hold(FA.DQ, dq, FA.flash_backward_dq_reference(q, k, v, do, lse, delta,
                                                   causal, scale), "dq")
    dk, dv = FA.flash_backward_dkv(q, k, v, do, lse, delta, causal)
    rdk, rdv = FA.flash_backward_dkv_reference(q, k, v, do, lse, delta,
                                               causal, scale)
    hold(FA.DKV, dk, rdk, "dk")
    hold(FA.DKV, dv, rdv, "dv")
    del o, lse, ro, rlse, dq, dk, dv, rdk, rdv

    # the whole function: forward kernel + both backward kernels vs dense
    # autograd of flash_attention_reference
    sides = []
    for fn in (lambda *a: FA.flash_attention(*a, causal=causal,
                                             return_lse=True),
               lambda *a: FA.flash_attention_reference(*a, causal=causal)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out, lse = fn(*leaves)
        outs, cots = [out], [do]
        if dlse is not None:
            outs.append(lse)
            cots.append(dlse)
        torch.autograd.backward(outs, cots)
        sides.append([out.detach(), lse.detach()]
                     + [t.grad for t in leaves])
        del out, lse, leaves
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *sides):
        err, rel = rel_err(a, b, "%s autograd %s" % (what, name))
        bar = FLASH_TOL["float32"] if name == "lse" else tol
        if rel > bar:
            raise AssertionError("flash_attention autograd disagrees with the"
                                 " reference at %s (%s): %.3g of max |plain|"
                                 " > %.1g" % (what, name, rel, bar))
    return errs


def flash_phase(card, peaks, results):
    import torch

    FA = flash_module()
    gen = torch.Generator(device="cuda").manual_seed(0)
    path_err = {}
    for dtype in ("bfloat16", "float32"):
        ins = flash_inputs(FLASH_SHAPE, getattr(torch, dtype), gen)
        errs = check_flash(FA, *ins, causal=True, tol=FLASH_TOL[dtype],
                           what="%s %s causal" % (FLASH_SHAPE, dtype))
        log("flash path %s %s causal: max abs err %s"
            % (FLASH_SHAPE, dtype, errs))
        if dtype == "bfloat16":
            path_err = errs
        del ins
    n_grid = 0
    for dtype in ("float32", "bfloat16"):
        for T in FLASH_GRID_T:
            for D in FLASH_GRID_D:
                for causal in (False, True):
                    for with_dlse in (False, True):
                        q, k, v, do, dlse = flash_inputs(
                            (1, 2, T, D), getattr(torch, dtype), gen)
                        check_flash(FA, q, k, v, do,
                                    dlse if with_dlse else None, causal,
                                    FLASH_TOL[dtype],
                                    "grid T=%d D=%d %s causal=%s dlse=%s"
                                    % (T, D, dtype, causal, with_dlse))
                        n_grid += 1
    log("flash grid: %d cases agree (T %s, D %s, causal and not, with and "
        "without dlse, fp32 and bf16)" % (n_grid, FLASH_GRID_T,
                                           FLASH_GRID_D))

    # times at the path shape, bf16 causal
    q, k, v, do, dlse = flash_inputs(FLASH_SHAPE, torch.bfloat16, gen)
    scale = FLASH_SHAPE[3] ** -0.5
    o, lse = FA.flash_forward(q, k, v, True)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    runs = {
        FA.FWD: ("fwd", lambda: FA.flash_forward(q, k, v, True),
                 lambda: FA.flash_forward_reference(q, k, v, True, scale)),
        FA.DQ: ("dq", lambda: FA.flash_backward_dq(q, k, v, do, lse, delta,
                                                   True),
                lambda: FA.flash_backward_dq_reference(q, k, v, do, lse,
                                                       delta, True, scale)),
        FA.DKV: ("dkv", lambda: FA.flash_backward_dkv(q, k, v, do, lse,
                                                      delta, True),
                 lambda: FA.flash_backward_dkv_reference(q, k, v, do, lse,
                                                         delta, True,
                                                         scale)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=True))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa(*leaves, is_causal=True), leaves, do))
    del leaves
    timing = {}
    for name, (kind, kernel, plain) in runs.items():
        ms = time_ms(kernel)
        plain_ms = time_events_ms(plain)
        bnd, by, ops, nbytes = flash_bound_ms(kind, FLASH_SHAPE, True, 2,
                                              peaks["bf16_flops"],
                                              peaks["bytes_per_s"])
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                            bound_by=by, ops=ops, bytes=nbytes,
                            library_ms=lib_fwd if kind == "fwd" else None,
                            max_abs_err=path_err[name])
        log("flash %s %s bf16 causal: ms=%.4f plain_ms=%.4f bound_ms=%.4f "
            "(%s; %.4g GFLOP, %.4g MB) achieved %.2f TFLOP/s"
            % (name, FLASH_SHAPE, ms, plain_ms, bnd, by, ops / 1e9,
               nbytes / 1e6, ops / ms / 1e9))
    kern_sum = sum(t["ms"] for t in timing.values())
    log("flash yardstick (torch scaled_dot_product_attention, is_causal, "
        "bf16, timed only): fwd %.4f ms, fwd+bwd %.4f ms (bwd %.4f); the "
        "three kernels: fwd %.4f ms, fwd+dq+dkv %.4f ms, on %s"
        % (lib_fwd, lib_fwd_bwd, lib_fwd_bwd - lib_fwd,
           timing[FA.FWD]["ms"], kern_sum, card))
    results["flash"] = dict(shape=FLASH_SHAPE, kernels=timing,
                            sdpa_fwd_ms=lib_fwd,
                            sdpa_fwd_bwd_ms=lib_fwd_bwd, grid_cases=n_grid)
    return timing


# ------------------------------------------------------------ train phase

def plain_local_attention(q, k, v, mesh=None):
    return flash_module().flash_attention_reference(q, k, v, causal=True)[0]


def train_phase(mx, card, results, timing):
    import importlib

    import torch
    from mxnet_tpu_torch import cuda_build

    FA = flash_module()
    TT = importlib.import_module("mxnet_tpu_torch.parallel.transformer")
    tp = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                         dtype="bfloat16", **TRAIN_CFG)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, TRAIN_CFG["vocab"], (TRAIN_B, TRAIN_T)) \
        .astype(np.int32)
    tok, tgt = tp.shard_batch(tok, np.roll(tok, -1, axis=1))

    # the first step's loss and gradients against plain attention
    params = tp.init(0)
    n_params = sum(p.numel() for p in params.values())
    ctok, ctgt = tok[:COMPARE_B], tgt[:COMPARE_B]
    loss_k, grads_k = tp.value_and_grad(params, ctok, ctgt)
    real = TT._local_attention
    TT._local_attention = plain_local_attention
    try:
        loss_p, grads_p = tp.value_and_grad(params, ctok, ctgt)
    finally:
        TT._local_attention = real
    loss_k, loss_p = loss_k.item(), loss_p.item()
    if not (np.isfinite(loss_k) and
            abs(loss_k - loss_p) <= LOSS_TOL * abs(loss_p)):
        raise AssertionError("first-step loss %.6f (kernels) vs %.6f (plain)"
                             % (loss_k, loss_p))
    worst, worst_name = 0.0, None
    for name in grads_p:
        err, rel = rel_err(grads_k[name], grads_p[name], "grad " + name)
        if rel > worst:
            worst, worst_name = rel, name
    if worst > GRAD_TOL:
        raise AssertionError("first-step gradient of %s disagrees with plain"
                             " attention: %.3g of max |plain grad| > %.1g"
                             % (worst_name, worst, GRAD_TOL))
    log("train: first step at B=%d: loss %.6f (kernels) vs %.6f (plain "
        "attention); worst gradient %s at %.3g of its max |plain grad|, "
        "%d tensors" % (COMPARE_B, loss_k, loss_p, worst_name, worst,
                        len(grads_p)))
    del grads_k, grads_p

    # the main path: 3 warm and 10 timed steps at full size
    params = tp.init(0)
    step = tp.step_fn(lr=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_step = TRAIN_CFG["n_layers"]
    cuda_build.reset_launch_counts()
    losses = []
    for i in range(TRAIN_WARM):
        params, loss = step(params, tok, tgt)
        losses.append(loss.item())
        counts = cuda_build.launch_counts()
        for name in FA.KERNELS:
            if counts.get(name, 0) != per_step * (i + 1):
                raise AssertionError("step %d: %s launched %d times, want %d"
                                     % (i, name, counts.get(name, 0),
                                        per_step * (i + 1)))
    t0 = time.perf_counter()
    timed = []
    for _ in range(TRAIN_TIMED):
        params, loss = step(params, tok, tgt)
        timed.append(loss)
    timed[-1].item()   # fence
    wall = time.perf_counter() - t0
    losses += [t.item() for t in timed]
    launches = cuda_build.launch_counts()
    n_steps = TRAIN_WARM + TRAIN_TIMED
    for name in FA.KERNELS:
        if launches.get(name, 0) != per_step * n_steps:
            raise AssertionError("%s launched %d times over %d steps, want %d"
                                 % (name, launches.get(name, 0), n_steps,
                                    per_step * n_steps))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("train losses not finite and falling: %s"
                             % losses)
    ms_step = wall / TRAIN_TIMED * 1e3
    tok_s = TRAIN_B * TRAIN_T / (wall / TRAIN_TIMED)
    peak = torch.cuda.max_memory_allocated()
    kern_ms = per_step * sum(timing[n]["ms"] for n in FA.KERNELS)
    log("train: %d params, B=%d T=%d bf16, %d steps: losses %s"
        % (n_params, TRAIN_B, TRAIN_T, n_steps,
           " ".join("%.6f" % x for x in losses)))
    log("train: %.3f ms/step, %.1f tokens/s, peak memory %.3f GB, flash "
        "launches per step %s; the flash kernels' device time is %.3f ms of "
        "the step (%.3f of it, from the kernel phase's per-launch times), "
        "on %s" % (ms_step, tok_s, peak / 1e9,
                   {n: launches[n] // n_steps for n in FA.KERNELS}, kern_ms,
                   kern_ms / ms_step, card))
    results["train"] = dict(params=n_params, B=TRAIN_B, T=TRAIN_T,
                            losses=losses, ms_per_step=ms_step,
                            tokens_per_s=tok_s, peak_bytes=peak,
                            launches=launches, flash_ms_per_step=kern_ms,
                            first_step=dict(loss_kernel=loss_k,
                                            loss_plain=loss_p,
                                            worst_grad=worst,
                                            worst_grad_name=worst_name))
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the detailed results here")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cuda_build

    card = nvidia_smi()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN (fp32 parity)")
    log("torch %s, CUDA %s, python %s" % (torch.__version__,
                                          torch.version.cuda,
                                          sys.version.split()[0]))
    peaks = card_peaks(card.split(",")[0])
    results = {"card": card, "peaks": {
        "fp32_flops": peaks[0], "bytes_per_s": peaks[1],
        "bf16_flops": card_bf16_peak(card.split(",")[0])},
        "kernel_cases": []}

    # every kernel source in the checkout, one nvcc each, all at once
    t0 = time.perf_counter()
    names = cuda_build.kernel_names()
    cuda_build.build_all(names)
    results["build_s"] = time.perf_counter() - t0
    log("build: %s in %.2f s" % (", ".join(names), results["build_s"]))
    for name in names:
        info = cuda_build.build_info(name)
        log("build: %s %s" % (name, "compiled" if info["built"]
                              else "cached"))
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas:", line.strip())

    sym = mx.models.get_resnet(num_layers=50, layout="NHWC")
    path_err, totals = kernel_phase(mx, sym, peaks, results)
    results["kernel_totals"] = totals
    launches = serve_phase(mx, sym, card, results)
    timing = flash_phase(card, results["peaks"], results)
    flash_launches = train_phase(mx, card, results, timing)

    t8 = totals[8]
    kernels = {"kernels": [{
        "name": "fused_matmul", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/fused_matmul.cu",
        "replaces": "mxnet_tpu/parallel/fused.py:168",
        "launches": launches, "max_abs_err": path_err,
        "ms": t8["ms"], "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
        "library_ms": t8["library_ms"]}]}
    replaces = {"flash_attention_fwd": 106, "flash_attention_bwd_dq": 202,
                "flash_attention_bwd_dkv": 236}
    for name, line in replaces.items():
        t = timing[name]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/parallel/flash_attention.py:%d" % line,
            "launches": flash_launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    if opts.out:
        if os.path.dirname(opts.out):
            os.makedirs(os.path.dirname(opts.out), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(dict(results, kernels=kernels["kernels"]), f, indent=1)
    log(nvidia_smi())
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

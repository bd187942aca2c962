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
6. Batched-matmul kernel phase: ``fused_batch_matmul`` against its plain
   version at the four region shapes of the symbolic attention block's
   step (the scores with their 1/sqrt(D) scale, read through the
   transposed view of k; the context with its residual add) at the
   fusion bench's size (B 8, T 64, D 128) and at the wide size (B 8,
   T 2048, D 512), and on a ragged grid (B 1/3, M and N 1/17/129, K
   8/100, every epilogue kind, fp32 and bf16). Times the kernel, the plain
   version and ``torch.bmm`` / ``torch.baddbmm`` with the same epilogue (a
   yardstick, never used by the port), all as CUDA-graph replays, and
   computes the bound (fp32 CUDA-core peak against bytes at the memory
   rate).
7. Module train phase: the attention block of ``bench_all.py``'s fusion
   bench (16 classes, fp32, ``mx.init.Uniform(0.05)``, SGD lr 0.01,
   ``kvstore="local"``) through ``mx.mod.Module`` on the card. The
   training bind carves exactly two ``batch_dot`` regions; the first
   ``forward_backward``'s outputs and all 10 parameter gradients with the
   kernels match ``MXNET_FUSION_KERNEL=0`` within 1e-5 of each one's own
   max |value| and are non-zero (but k_bias's, which the softmax makes
   0), and so do an MLP's (``fc1 + relu`` on ``fused_matmul``). Then
   ``fit`` for 2 epochs of 8 batches with launch counts reset just
   before: exactly 2 ``fused_batch_matmul`` launches per step, finite
   losses, accuracy, ms/step and samples/s; and 3 warm + 10 timed steps
   at both sizes with peak memory.
8. rtc phase: ``mx.rtc.CudaModule`` (NVRTC, sm_90a) on the card. (a) The
   eight behaviours of ``tests/test_rtc.py`` as CUDA C against their plain
   versions (axpy, per-block rows, two outputs, an exported template, the
   int scalar cast, an accumulate launched twice, 96 KiB of dynamic shared
   memory, one NVRTC compile per module). (b) The custom softmax head's two
   kernels (forward ``exp(x - max) / sum``, one block per row staged in
   shared memory; backward ``y - onehot``) at (100, 10) and at the LM
   head's logits (16384, 32768) against their plain versions, timed as
   CUDA-graph replays beside ``torch.softmax`` with the bound at the
   memory rate, and the host cost of one launch call. (c) The slice's main
   path: ``examples/numpy_ops/custom_softmax.py`` on the card, its
   ``CustomOp`` head launching the kernels through mx.rtc: the first
   ``forward_backward`` against the built-in ``SoftmaxOutput`` (1e-5 of
   each tensor's max) and, through ``fused_matmul`` (``fc1 + relu``),
   against ``MXNET_FUSION_KERNEL=0`` (1e-5 of each tensor's max), then
   ``Module.fit`` for 2 epochs of 1500 synthetic MNIST samples with launch
   counts reset just before: one forward and one backward launch per step
   (the forward and ``fused_matmul`` also once per validation batch),
   held-out accuracy above 0.8 and within 0.1 of the built-in head's.
   (d) LeNet: the training bind's three fuse regions, the first step
   through ``fused_matmul`` (``fc1 + tanh``) against
   ``MXNET_FUSION_KERNEL=0`` as in (c), then ``Module.fit`` on 2000
   samples for 3 epochs with one ``fused_matmul`` launch per training
   step and validation batch.
9. Print the ``kernels`` JSON line, then the result line
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
PATH_TOL = 1e-4           # fp32 kernel vs plain, over max(1, max |plain|)
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
GRAD_TOL = 2e-2                  # gradients, over max(1, max |plain grad|)

# the symbolic attention block of bench_all.py's fusion bench (its full,
# non-QUICK size) and the wide size of bench_transformer_lm's T and d_model
BLOCK_SIZES = {"bench": dict(B=8, T=64, D=128),
               "wide": dict(B=8, T=2048, D=512)}
BLOCK_CLASSES, BLOCK_LR, BLOCK_INIT_SCALE = 16, 0.01, 0.05
FIT_BATCHES, FIT_EPOCHS = 8, 2
MODULE_WARM, MODULE_TIMED = 3, 10
# kernel vs MXNET_FUSION_KERNEL=0 on the first step, relative to max |value|:
# both sides compute fp32 products of the same inputs in another order
MODULE_TOL = 1e-5
# a parameter whose gradient is 0 up to rounding -> the one whose max
# |gradient| scales its error
ZERO_GRAD_SCALE = {"k_bias": "k_weight"}
# the custom-softmax fit of examples/numpy_ops/custom_softmax.py --smoke
# and the LeNet drive of the verify notes, on synthetic MNIST
RTC_BATCH, RTC_TRAIN, RTC_VAL, RTC_EPOCHS = 100, 1500, 500, 2
LENET_TRAIN, LENET_VAL, LENET_EPOCHS = 2000, 500, 3
# the fuse pass's regions of LeNet's training bind, as the JAX package's:
# each of these layers with the activation after it
LENET_REGION_BASES = ["conv1", "conv2", "fc1"]
# rtc head vs SoftmaxOutput on the first step, relative to each tensor's max
# |value|: the same softmax and p - onehot, in another summation order
RTC_STEP_TOL = 1e-5
BMM_GRID_B, BMM_GRID_MN, BMM_GRID_K = (1, 3), (1, 17, 129), (8, 100)
BMM_GRID_EPILOGUES = [
    (("scalar", "_div_scalar", 8.0),), (("res", "elemwise_add"),),
    (("scalar", "_mul_scalar", 0.5), ("res", "elemwise_add"),
     ("act", "relu")),
    (("res", "elemwise_mul"), ("act", "tanh")),
    (("act", "sigmoid"), ("scalar", "_rminus_scalar", 1.0)),
    (("act", "softrelu"), ("scalar", "_minus_scalar", 0.5)),
    (("act", "softsign"), ("scalar", "_plus_scalar", 0.25))]


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
    """(max abs error, that error over max(1, max |ref|)): relative for
    outputs of magnitude 1 and above, absolute below."""
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
    worst, worst_name, own = 0.0, None, {}
    for name in grads_p:
        err, rel = rel_err(grads_k[name], grads_p[name], "grad " + name)
        own[name] = err / max(grads_p[name].float().abs().max().item(),
                              1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    if worst > GRAD_TOL:
        raise AssertionError("first-step gradient of %s disagrees with plain"
                             " attention: %.3g of max(1, max |plain grad|) > "
                             "%.1g" % (worst_name, worst, GRAD_TOL))
    own_worst = max(own, key=own.get)
    log("train: first step at B=%d: loss %.6f (kernels) vs %.6f (plain "
        "attention); worst gradient %s at %.3g of max(1, its max |plain "
        "grad|), %d tensors; of its own max |plain grad| (not checked) the "
        "worst is %s at %.3g" % (COMPARE_B, loss_k, loss_p, worst_name,
                                 worst, len(grads_p), own_worst,
                                 own[own_worst]))
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


# ------------------------------------------------ batched matmul phase

def bmm_path_cases(B, T, D, gen):
    """The two fused_batch_matmul calls of one attention-block step, as
    the fuse pass hands them over: the scores q . k^T / sqrt(D), with k^T
    the (0, 2, 1) view of k, and the context attn . v + x."""
    import torch

    q, k, v, x = (torch.randn(B, T, D, device="cuda", generator=gen)
                  for _ in range(4))
    attn = torch.softmax(torch.randn(B, T, T, device="cuda", generator=gen),
                         -1)
    return [
        dict(region="scores", x=q, w=k.permute(0, 2, 1), extras=[],
             epilogue=(("scalar", "_div_scalar", float(np.sqrt(D))),)),
        dict(region="context", x=attn, w=v, extras=[x],
             epilogue=(("res", "elemwise_add"),)),
    ]


def bmm_library_fn(case):
    """The yardstick: cuBLAS's batched GEMM with the same epilogue
    (timed only, never used by the port)."""
    import torch

    if case["extras"]:
        return torch.baddbmm(case["extras"][0], case["x"], case["w"])
    return torch.bmm(case["x"], case["w"]).div_(case["epilogue"][0][2])


def bmm_bound_ms(case, peaks):
    B, M, K = case["x"].shape
    N = case["w"].shape[2]
    nbytes = (B * M * K + B * K * N + (len(case["extras"]) + 1) * B * M * N
              ) * case["x"].element_size()
    t_bytes = nbytes / peaks[1] * 1e3
    t_ops = 2.0 * B * M * N * K / peaks[0] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def bmm_check(F, x, w, extras, epilogue, tol, what):
    import torch

    out = F.fused_batch_matmul(x, w, extras, epilogue)
    ref = F.fused_batch_matmul_reference(x, w, extras, epilogue)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref, what)
    if rel > tol:
        raise AssertionError("fused_batch_matmul disagrees with its plain "
                             "version at %s: max abs err %.3g, %.3g of max "
                             "|plain| > %.1g" % (what, err, rel, tol))
    return err


def bmm_phase(peaks, results):
    import torch
    from mxnet_tpu_torch.parallel import fused as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    path_err, totals = 0.0, {}
    for size, cfg in BLOCK_SIZES.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0}
        for case in bmm_path_cases(cfg["B"], cfg["T"], cfg["D"], gen):
            x, w, ex, ep = case["x"], case["w"], case["extras"], \
                case["epilogue"]
            what = "%s %s %s x %s" % (size, case["region"], tuple(x.shape),
                                      tuple(w.shape))
            err = bmm_check(F, x, w, ex, ep, PATH_TOL, what)
            path_err = max(path_err, err)
            ms = time_ms(lambda: F.fused_batch_matmul(x, w, ex, ep))
            plain = time_ms(lambda: F.fused_batch_matmul_reference(x, w, ex,
                                                                   ep))
            lib = time_ms(lambda: bmm_library_fn(case))
            bnd, by = bmm_bound_ms(case, peaks)
            row = dict(size=size, region=case["region"],
                       x=tuple(x.shape), w=tuple(w.shape),
                       w_transposed=not w.is_contiguous(), max_abs_err=err,
                       ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by)
            results["bmm_cases"].append(row)
            log("bmm %s %s x%s w%s%s err=%.3g ms=%.4f plain_ms=%.4f "
                "library_ms=%.4f bound_ms=%.4f (%s)"
                % (size, case["region"], tuple(x.shape), tuple(w.shape),
                   " (transposed view)" if row["w_transposed"] else "", err,
                   ms, plain, lib, bnd, by))
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[key] += row[key]
            tot["t_ops" if by == "operations" else "t_bytes"] += bnd
        tot["bound_by"] = ("operations" if tot["t_ops"] >= tot["t_bytes"]
                           else "bytes")
        totals[size] = tot
        log("bmm per step %s (2 launches): ms=%.4f plain_ms=%.4f "
            "library_ms=%.4f bound_ms=%.4f (%s)"
            % (size, tot["ms"], tot["plain_ms"], tot["library_ms"],
               tot["bound_ms"], tot["bound_by"]))
        del case, x, w, ex
    n = 0
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for B in BMM_GRID_B:
            for M in BMM_GRID_MN:
                for N in BMM_GRID_MN:
                    for K in BMM_GRID_K:
                        for ep in BMM_GRID_EPILOGUES:
                            x = torch.randn(B, M, K, device="cuda",
                                            generator=gen).to(td)
                            w = torch.randn(B, N, K, device="cuda",
                                            generator=gen).to(td)
                            w = w.permute(0, 2, 1) if n % 2 else \
                                w.transpose(1, 2).contiguous()
                            ex = [torch.randn(B, M, N, device="cuda",
                                              generator=gen).to(td)
                                  for s in ep if s[0] == "res"]
                            bmm_check(F, x, w, ex, ep, GRID_TOL[dtype],
                                      "grid B=%d M=%d N=%d K=%d %s %s"
                                      % (B, M, N, K, ep, dtype))
                            n += 1
    log("bmm grid: %d cases agree (B %s, M and N %s, K %s, %d epilogues, "
        "transposed and contiguous w, fp32 and bf16)"
        % (n, BMM_GRID_B, BMM_GRID_MN, BMM_GRID_K, len(BMM_GRID_EPILOGUES)))
    results["bmm_totals"] = totals
    results["bmm_grid_cases"] = n
    return path_err, totals


# --------------------------------------------------- Module train phase

def attention_block(mx, T, D, classes=BLOCK_CLASSES):
    """bench_all.py's fusion-bench train arm (``tblock``)."""
    data = mx.sym.var("data")
    q = mx.sym.FullyConnected(data, num_hidden=D, flatten=False, name="q")
    k = mx.sym.FullyConnected(data, num_hidden=D, flatten=False, name="k")
    v = mx.sym.FullyConnected(data, num_hidden=D, flatten=False, name="v")
    scores = mx.sym.batch_dot(q, mx.sym.transpose(k, axes=(0, 2, 1)))
    attn = mx.sym.softmax(scores / float(np.sqrt(D)), axis=-1)
    ctxv = mx.sym.batch_dot(attn, v)
    out = mx.sym.FullyConnected(ctxv + data, num_hidden=D, flatten=False,
                                name="proj")
    flat = mx.sym.Flatten(out)
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(flat, num_hidden=classes, name="head"),
        name="softmax")


def mlp(mx):
    """tests/test_fusion.py's ``_mlp`` at MNIST widths: ``fc1 + relu``
    carves onto fused_matmul."""
    data = mx.sym.var("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=128,
                                                name="fc1"), act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(h, num_hidden=10,
                                                      name="fc2"),
                                name="softmax")


def block_data(B, T, D, n_batches=1, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(B * n_batches, T, D).astype(np.float32)
    y = (np.arange(B * n_batches) % BLOCK_CLASSES).astype(np.float32)
    return x, y


def bound_module(mx, sym, dshape, lshape, seed=0):
    mod = mx.mod.Module(sym, context=mx.gpu())
    mod.bind(data_shapes=[("data", dshape)],
             label_shapes=[("softmax_label", lshape)], for_training=True)
    np.random.seed(seed)
    mod.init_params(mx.init.Uniform(BLOCK_INIT_SCALE))
    return mod


def first_step_vs_plain(mx, mod, batch, kernel, what):
    """The first forward_backward with the kernels and with
    MXNET_FUSION_KERNEL=0 (no update between): the outputs and every
    parameter gradient within MODULE_TOL of their own max |value| (k_bias,
    whose gradient is 0 up to rounding, at k_weight's), and every gradient
    with the kernels but k_bias's non-zero, so that a dropped gradient
    fails. Returns (worst, launches)."""
    import torch
    from mxnet_tpu_torch import cuda_build

    sides = []
    launches = 0
    for flag in (1, 0):
        mx.config.set_flag("MXNET_FUSION_KERNEL", flag)
        try:
            cuda_build.reset_launch_counts()
            mod.forward_backward(batch)
            torch.cuda.synchronize()
            if flag:
                launches = cuda_build.launch_counts().get(kernel, 0)
            elif cuda_build.launch_counts().get(kernel, 0):
                raise AssertionError("MXNET_FUSION_KERNEL=0 still launched "
                                     "%s" % kernel)
            grp = mod._exec_group
            sides.append([("output", mod.get_outputs()[0]._data.clone())] + [
                (n, g[0]._data.clone())
                for n, g in zip(grp.param_names, grp.grad_arrays)])
        finally:
            mx.config.set_flag("MXNET_FUSION_KERNEL", None)
    kern, plain = dict(sides[0]), dict(sides[1])
    worst, worst_name = -1.0, None
    for name in plain:
        err, _rel = rel_err(kern[name], plain[name], "%s %s" % (what, name))
        # the softmax cancels a shift of a row's scores: k_bias's gradient
        # is 0 up to rounding, so it is judged at its layer's scale
        scale = plain[ZERO_GRAD_SCALE.get(name, name)].abs().max().item()
        if name not in ZERO_GRAD_SCALE and not kern[name].abs().max().item():
            raise AssertionError("%s: the %s gradient with the kernels is "
                                 "all zero" % (what, name))
        rel = err / max(scale, 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    if worst > MODULE_TOL:
        raise AssertionError("%s: first-step %s with the kernels disagrees "
                             "with MXNET_FUSION_KERNEL=0: %.3g of max |value| "
                             "> %.1g" % (what, worst_name, worst, MODULE_TOL))
    log("%s: first step through %s (%d launches) vs MXNET_FUSION_KERNEL=0: "
        "outputs and %d gradients agree, worst %s at %.3g of its max |value|"
        % (what, kernel, launches, len(sides[0]) - 1, worst_name, worst))
    return worst, launches


def timed_steps(mx, mod, batch, per_step):
    """MODULE_WARM + MODULE_TIMED forward_backward + update steps; the
    timed ones fenced once at the end. Returns (ms/step, peak bytes,
    bytes resident before the steps, losses): the peak counts what the
    earlier phases left allocated too."""
    import torch
    from mxnet_tpu_torch import cuda_build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    cuda_build.reset_launch_counts()
    label = batch.label[0]._data.long()
    losses = []

    def loss():
        p = mod.get_outputs()[0]._data
        return -torch.log(p.gather(1, label[:, None]).clamp_min(1e-12)).mean()

    for _ in range(MODULE_WARM):
        mod.forward_backward(batch)
        mod.update()
        losses.append(loss().item())
    t0 = time.perf_counter()
    timed = []
    for _ in range(MODULE_TIMED):
        mod.forward_backward(batch)
        mod.update()
        timed.append(loss())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses += [t.item() for t in timed]
    n = MODULE_WARM + MODULE_TIMED
    got = cuda_build.launch_counts().get("fused_batch_matmul", 0)
    if got != per_step * n:
        raise AssertionError("fused_batch_matmul launched %d times over %d "
                             "steps, want %d" % (got, n, per_step * n))
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite losses %s" % losses)
    return wall / MODULE_TIMED * 1e3, torch.cuda.max_memory_allocated(), \
        resident, losses


def module_phase(mx, card, results):
    import torch
    from mxnet_tpu_torch import cuda_build

    out = {}
    # the MLP: fc1 + relu on fused_matmul, through its new gradient
    msym = mlp(mx)
    rng = np.random.RandomState(1)
    mlp_x = rng.rand(64, 784).astype(np.float32)
    my = (np.arange(64) % 10).astype(np.float32)
    mmod = bound_module(mx, msym, mlp_x.shape, my.shape)
    mbatch = mx.io.DataBatch(data=[mx.nd.array(mlp_x, ctx=mx.gpu())],
                             label=[mx.nd.array(my, ctx=mx.gpu())])
    regions = mmod._exec_group.execs[0].fused_regions()
    if [r["base_op"] for r in regions] != ["FullyConnected"]:
        raise AssertionError("MLP training bind regions %s" % regions)
    worst, launches = first_step_vs_plain(mx, mmod, mbatch, "fused_matmul",
                                          "mlp (64, 784)")
    if launches != 1:
        raise AssertionError("MLP step launched fused_matmul %d times, want 1"
                             % launches)
    out["mlp_first_step_worst"] = worst
    del mmod

    cfg = BLOCK_SIZES["bench"]
    B, T, D = cfg["B"], cfg["T"], cfg["D"]
    sym = attention_block(mx, T, D)
    x, y = block_data(B, T, D, FIT_BATCHES)
    mod = bound_module(mx, sym, (B, T, D), (B,))
    regions = mod._exec_group.execs[0].fused_regions()
    log("module: training bind regions %s" % [(r["base_op"], r["members"])
                                              for r in regions])
    if [r["base_op"] for r in regions] != ["batch_dot", "batch_dot"]:
        raise AssertionError("want exactly 2 batch_dot regions, got %s"
                             % regions)
    batch = mx.io.DataBatch(data=[mx.nd.array(x[:B], ctx=mx.gpu())],
                            label=[mx.nd.array(y[:B], ctx=mx.gpu())])
    worst, launches = first_step_vs_plain(mx, mod, batch,
                                          "fused_batch_matmul",
                                          "attention block %s" % (cfg,))
    if launches != 2:
        raise AssertionError("attention step launched fused_batch_matmul %d "
                             "times, want 2" % launches)
    if len(mod._exec_group.param_names) != 10:
        raise AssertionError("want 10 parameters, got %s"
                             % mod._exec_group.param_names)
    out["block_first_step_worst"] = worst

    # the main path: Module.fit, 2 epochs of 8 batches, on the card
    fmod = mx.mod.Module(sym, context=mx.gpu())
    it = mx.io.NDArrayIter(mx.nd.array(x, ctx=mx.gpu()),
                           mx.nd.array(y, ctx=mx.gpu()), batch_size=B,
                           label_name="softmax_label")
    stamps, losses = [], []

    def on_batch(param):
        p = param.locals["self"].get_outputs()[0]._data
        lab = param.locals["data_batch"].label[0]._data.long()
        losses.append(-torch.log(p.gather(1, lab[:, None]).clamp_min(1e-12))
                      .mean().item())
        stamps.append(time.perf_counter())

    metric = mx.metric.create(["acc", "ce"])
    np.random.seed(0)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    fmod.fit(it, num_epoch=FIT_EPOCHS, optimizer="sgd",
             optimizer_params={"learning_rate": BLOCK_LR}, kvstore="local",
             initializer=mx.init.Uniform(BLOCK_INIT_SCALE),
             eval_metric=metric, batch_end_callback=on_batch)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_launches = cuda_build.launch_counts().get("fused_batch_matmul", 0)
    steps = FIT_EPOCHS * FIT_BATCHES
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError("fit losses %s" % losses)
    if fit_launches != 2 * steps:
        raise AssertionError("fit launched fused_batch_matmul %d times over "
                             "%d steps, want exactly 2 per step"
                             % (fit_launches, steps))
    step_ms = np.diff(stamps) * 1e3
    names_vals = {k: float(v) for k, v in metric.get_name_value()}
    log("module fit: %d epochs x %d batches of %s: losses %s; last epoch's "
        "train metrics %s; fused_batch_matmul launches %d (%d per step)"
        % (FIT_EPOCHS, FIT_BATCHES, (B, T, D),
           " ".join("%.6f" % v for v in losses), names_vals, fit_launches,
           fit_launches // steps))
    log("module fit: %.3f ms/step (median of %d steps, metric update "
        "included), %.1f samples/s, fit wall %.3f s, on %s"
        % (np.median(step_ms), len(step_ms), B / np.median(step_ms) * 1e3,
           fit_wall, card))
    out["fit"] = dict(losses=losses, metrics=names_vals,
                      launches=fit_launches, steps=steps,
                      ms_per_step_median=float(np.median(step_ms)),
                      step_ms=step_ms.tolist(), wall_s=fit_wall)

    # the step at both sizes, forward_backward + update
    out["steps"] = {}
    for size, c in BLOCK_SIZES.items():
        if size == "bench":
            smod, sbatch = mod, batch
        else:
            ssym = attention_block(mx, c["T"], c["D"])
            sx, sy = block_data(c["B"], c["T"], c["D"])
            smod = bound_module(mx, ssym, sx.shape, sy.shape)
            sbatch = mx.io.DataBatch(
                data=[mx.nd.array(sx, ctx=mx.gpu())],
                label=[mx.nd.array(sy, ctx=mx.gpu())])
        smod.init_optimizer(kvstore="local", optimizer="sgd",
                            optimizer_params={"learning_rate": BLOCK_LR})
        ms, peak, resident, slosses = timed_steps(mx, smod, sbatch,
                                                  per_step=2)
        out["steps"][size] = dict(cfg=c, ms_per_step=ms,
                                  samples_per_s=c["B"] / ms * 1e3,
                                  peak_bytes=peak, resident_bytes=resident,
                                  losses=slosses)
        log("module step %s %s: %.3f ms/step, %.1f samples/s, peak memory "
            "%.3f GB (%.3f GB of it resident before the steps), 2 "
            "fused_batch_matmul launches per step, losses %s, on %s"
            % (size, c, ms, c["B"] / ms * 1e3, peak / 1e9, resident / 1e9,
               " ".join("%.6f" % v for v in slosses), card))
        del smod, sbatch
    results["module"] = out
    return fit_launches


# ------------------------------------------------------------ rtc phase
# User programs of mx.rtc: CUDA C handed to the port at run time, compiled
# by NVRTC and launched on NDArrays. tests/test_torch_rtc.py runs the same
# sources on the card.

# the eight behaviours of tests/test_rtc.py, as CUDA C
RTC_SPEC_SRC = r"""
extern "C" __global__ void axpy(const float *x, const float *y, float *out,
                                float alpha, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = y[i] + alpha * x[i];
}

extern "C" __global__ void fill_rows(float *out, int cols) {
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
        out[blockIdx.x * cols + c] = (float)blockIdx.x;
}

extern "C" __global__ void split_stats(const float *x, float *mean,
                                       float *sq, int cols) {
    const float *row = x + blockIdx.x * cols;
    if (threadIdx.x == 0) {
        float s = 0.f;
        for (int c = 0; c < cols; ++c) s += row[c];
        mean[blockIdx.x] = s / cols;
    }
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
        sq[blockIdx.x * cols + c] = row[c] * row[c];
}

template <typename T>
__global__ void axpy_t(const T *x, T *y, T alpha, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] += alpha * x[i];
}

extern "C" __global__ void scale(const float *x, float *out, int k, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i] * k;
}

extern "C" __global__ void accum(const float *x, float *y, float alpha,
                                 int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = y[i] + alpha * x[i];
}

// the whole array staged in dynamic shared memory, then written reversed
extern "C" __global__ void reverse_staged(const float *x, float *out, int n) {
    extern __shared__ float buf[];
    for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = buf[n - 1 - i];
}
"""
RTC_SPEC_EXPORTS = ("axpy_t<float>", "axpy_t<double>")
RTC_BIG_SHARED = 96 * 1024          # above the 48 KiB default


def rtc_spec_module(mx):
    return mx.rtc.CudaModule(RTC_SPEC_SRC, exports=RTC_SPEC_EXPORTS)


def _nd(mx, a):
    return mx.nd.array(a, ctx=mx.gpu())


def _spec_close(what, got, want, tol=1e-6):
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    if not err <= tol * max(1.0, float(np.abs(want).max())):
        raise AssertionError("rtc %s: max abs err %.3g against the plain "
                             "version" % (what, err))
    return err


def spec_axpy(mx, module):
    f = module.get_kernel("axpy", "const float *x, const float *y, "
                                  "float *out, float alpha, int n")
    x, y, out = (_nd(mx, np.full(10, v, np.float32)) for v in (1, 2, 0))
    ret = f.launch([x, y, out, 3.0, 10], mx.gpu(), (1, 1, 1), (32, 1, 1))
    if ret[0] is not out:
        raise AssertionError("rtc axpy: launch must return its outputs")
    return _spec_close("axpy", out.asnumpy(), np.full(10, 5.0))


def spec_block_rows(mx, module):
    f = module.get_kernel("fill_rows", "float *out, int cols")
    out = _nd(mx, np.zeros((3, 4), np.float32))
    f.launch([out, 4], mx.gpu(), (3, 1, 1), (4, 1, 1))
    return _spec_close("per-block rows", out.asnumpy(),
                       np.arange(3)[:, None] * np.ones((1, 4)))


def spec_two_outputs(mx, module):
    f = module.get_kernel("split_stats", "const float *x, float *mean, "
                                         "float *sq, int cols")
    xv = np.random.RandomState(0).rand(4, 6).astype(np.float32)
    mean = _nd(mx, np.zeros(4, np.float32))
    sq = _nd(mx, np.zeros((4, 6), np.float32))
    f.launch([_nd(mx, xv), mean, sq, 6], mx.gpu(), (4, 1, 1), (32, 1, 1))
    return max(_spec_close("two outputs (mean)", mean.asnumpy(),
                           xv.mean(axis=1), 1e-5),
               _spec_close("two outputs (sq)", sq.asnumpy(), xv * xv))


def spec_template(mx, module):
    err = 0.0
    for ctype, dtype in (("float", np.float32), ("double", np.float64)):
        f = module.get_kernel("axpy_t<%s>" % ctype,
                              "const %s *x, %s *y, %s alpha, int n"
                              % (ctype, ctype, ctype))
        xv = np.arange(50, dtype=dtype)
        y = _nd(mx, np.ones(50, dtype))
        f.launch([_nd(mx, xv), y, 0.5, 50], mx.gpu(), (2, 1, 1),
                 (32, 1, 1))
        err = max(err, _spec_close("exported axpy_t<%s>" % ctype,
                                   y.asnumpy(), 1 + 0.5 * xv))
    return err


def spec_int_scalar(mx, module):
    f = module.get_kernel("scale", "const float *x, float *out, int k, "
                                   "int n")
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = _nd(mx, np.zeros((2, 3), np.float32))
    f.launch([_nd(mx, xv), out, 4.9, 6], mx.gpu(), (1,), (32,))
    return _spec_close("int scalar cast", out.asnumpy(), xv * 4)


def spec_accumulate(mx, module):
    f = module.get_kernel("accum", "const float *x, float *y, float alpha, "
                                   "int n")
    x = _nd(mx, np.ones(8, np.float32))
    y = _nd(mx, np.full(8, 10.0, np.float32))
    f.launch([x, y, 3.0, 8], mx.gpu(), (1, 1, 1), (32, 1, 1))
    err = _spec_close("accumulate (1st)", y.asnumpy(), np.full(8, 13.0))
    f.launch([x, y, 3.0, 8], mx.gpu(), (1, 1, 1), (32, 1, 1))
    return max(err, _spec_close("accumulate (2nd)", y.asnumpy(),
                                np.full(8, 16.0)))


def spec_big_shared(mx, module):
    n = RTC_BIG_SHARED // 4
    f = module.get_kernel("reverse_staged", "const float *x, float *out, "
                                            "int n")
    xv = np.random.RandomState(1).rand(n).astype(np.float32)
    out = _nd(mx, np.zeros(n, np.float32))
    f.launch([_nd(mx, xv), out, n], mx.gpu(), (1, 1, 1), (1024, 1, 1),
             shared_mem=RTC_BIG_SHARED)
    return _spec_close("%d KiB of shared memory" % (RTC_BIG_SHARED // 1024),
                       out.asnumpy(), xv[::-1])


def spec_one_compile(mx, module):
    from mxnet_tpu_torch import nvrtc

    before = nvrtc.compile_count()
    fresh = rtc_spec_module(mx)
    if nvrtc.compile_count() != before + 1:
        raise AssertionError("rtc: a CudaModule compiled %d times, want 1"
                             % (nvrtc.compile_count() - before))
    f = fresh.get_kernel("scale", "const float *x, float *out, int k, int n")
    err = 0.0
    for n in (16, 16, 32, 1000):
        x = _nd(mx, np.ones(n, np.float32))
        out = _nd(mx, np.zeros(n, np.float32))
        f.launch([x, out, 2, n], mx.gpu(), ((n + 127) // 128,), (128,))
        err = max(err, _spec_close("scale n=%d" % n, out.asnumpy(),
                                   np.full(n, 2.0)))
    if nvrtc.compile_count() != before + 1:
        raise AssertionError("rtc: launches recompiled the module (%d "
                             "compiles)" % (nvrtc.compile_count() - before))
    return err


RTC_SPECS = (("axpy", spec_axpy), ("block_rows", spec_block_rows),
             ("two_outputs", spec_two_outputs), ("template", spec_template),
             ("int_scalar", spec_int_scalar),
             ("accumulate", spec_accumulate), ("big_shared", spec_big_shared),
             ("one_compile", spec_one_compile))

# the custom softmax head's kernels: one block per row
SOFTMAX_SRC = r"""
#define NEG_INF __int_as_float(0xff800000)

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// blockDim.x is a multiple of 32; every thread gets the block's result
__device__ float block_max(float v, float *red) {
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_max(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = warp_max(lane < (blockDim.x >> 5) ? red[lane] : NEG_INF);
    __syncthreads();
    return v;
}

__device__ float block_sum(float v, float *red) {
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = warp_sum(lane < (blockDim.x >> 5) ? red[lane] : 0.f);
    __syncthreads();
    return v;
}

// y = exp(x - rowmax) / rowsum, one block per row. Bounded by bytes: x
// read once and y written once. A staged row is read once into dynamic
// shared memory (cols floats) and the three passes run from there; an
// unstaged one is re-read by each pass. 16-byte accesses where the row
// allows.
extern "C" __global__ void softmax_fwd(const float *__restrict__ x,
                                       float *__restrict__ y, int cols,
                                       int staged) {
    extern __shared__ float4 row4[];
    __shared__ float red[32];
    float *row = reinterpret_cast<float *>(row4);
    const float *xr = x + (size_t)blockIdx.x * cols;
    float *yr = y + (size_t)blockIdx.x * cols;
    const bool vec = (cols & 3) == 0 &&
        ((reinterpret_cast<size_t>(xr) | reinterpret_cast<size_t>(yr)) & 15)
            == 0;
    const int c4 = cols >> 2;
    const float4 *x4 = reinterpret_cast<const float4 *>(xr);
    float4 *y4 = reinterpret_cast<float4 *>(yr);
    float m = NEG_INF;
    if (vec) {
        for (int i = threadIdx.x; i < c4; i += blockDim.x) {
            float4 v = x4[i];
            if (staged) row4[i] = v;
            m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
        }
    } else {
        for (int i = threadIdx.x; i < cols; i += blockDim.x) {
            float v = xr[i];
            if (staged) row[i] = v;
            m = fmaxf(m, v);
        }
    }
    m = block_max(m, red);
    float s = 0.f;
    if (vec) {
        for (int i = threadIdx.x; i < c4; i += blockDim.x) {
            float4 v = staged ? row4[i] : x4[i];
            v.x = expf(v.x - m); v.y = expf(v.y - m);
            v.z = expf(v.z - m); v.w = expf(v.w - m);
            if (staged) row4[i] = v;
            s += (v.x + v.y) + (v.z + v.w);
        }
    } else {
        for (int i = threadIdx.x; i < cols; i += blockDim.x) {
            float e = expf((staged ? row[i] : xr[i]) - m);
            if (staged) row[i] = e;
            s += e;
        }
    }
    s = block_sum(s, red);
    if (vec) {
        for (int i = threadIdx.x; i < c4; i += blockDim.x) {
            float4 v;
            if (staged) {
                v = row4[i];
            } else {
                v = x4[i];
                v.x = expf(v.x - m); v.y = expf(v.y - m);
                v.z = expf(v.z - m); v.w = expf(v.w - m);
            }
            v.x = v.x / s; v.y = v.y / s; v.z = v.z / s; v.w = v.w / s;
            y4[i] = v;
        }
    } else {
        for (int i = threadIdx.x; i < cols; i += blockDim.x)
            yr[i] = (staged ? row[i] : expf(xr[i] - m)) / s;
    }
}

// dx = y; dx[r, label[r]] -= 1: the numpy op's semantics (no
// normalisation; the head gradient is ignored). The label arrives as fp32,
// as NDArrayIter gives it. Bounded by bytes: y read once, dx written once.
extern "C" __global__ void softmax_bwd(const float *__restrict__ label,
                                       const float *__restrict__ y,
                                       float *__restrict__ dx, int cols) {
    const int lab = (int)label[blockIdx.x];
    const float *yr = y + (size_t)blockIdx.x * cols;
    float *dr = dx + (size_t)blockIdx.x * cols;
    const bool vec = (cols & 3) == 0 &&
        ((reinterpret_cast<size_t>(yr) | reinterpret_cast<size_t>(dr)) & 15)
            == 0;
    if (vec) {
        const float4 *y4 = reinterpret_cast<const float4 *>(yr);
        float4 *d4 = reinterpret_cast<float4 *>(dr);
        for (int i = threadIdx.x; i < (cols >> 2); i += blockDim.x) {
            float4 v = y4[i];
            int k = lab - 4 * i;
            if (k == 0) v.x -= 1.f;
            if (k == 1) v.y -= 1.f;
            if (k == 2) v.z -= 1.f;
            if (k == 3) v.w -= 1.f;
            d4[i] = v;
        }
    } else {
        for (int i = threadIdx.x; i < cols; i += blockDim.x)
            dr[i] = i == lab ? yr[i] - 1.f : yr[i];
    }
}
"""
SOFTMAX_FWD_SIG = "const float *x, float *y, int cols, int staged"
SOFTMAX_BWD_SIG = "const float *label, const float *y, float *dx, int cols"
# a row is staged in shared memory up to this size (an H100 block may have
# 227 KiB of dynamic shared memory; the reductions' own 128 bytes stay free)
SOFTMAX_STAGE_BYTES = 224 * 1024
SOFTMAX_WIDE = (16384, 32768)    # the causal LM head's logits: B 8 x T 2048
SOFTMAX_SMALL = (100, 10)        # the MNIST head: batch 100, 10 classes
# kernel forward vs its plain version, over max |y|: both fp32, in another
# summation order
SOFTMAX_FWD_TOL = 1e-6


def softmax_threads(cols):
    """Threads per row: a float4 each, in whole warps, at most 1024."""
    return int(min(1024, 32 * max(1, -(-cols // 128))))


class RtcSoftmax:
    """The two softmax kernels, compiled once, launched on NDArrays."""

    def __init__(self, mx):
        module = mx.rtc.CudaModule(SOFTMAX_SRC)
        self.fwd = module.get_kernel("softmax_fwd", SOFTMAX_FWD_SIG)
        self.bwd = module.get_kernel("softmax_bwd", SOFTMAX_BWD_SIG)

    def forward(self, x, y):
        rows, cols = x.shape
        staged = cols * 4 <= SOFTMAX_STAGE_BYTES
        self.fwd.launch([x, y, cols, int(staged)], x.context, (rows, 1, 1),
                        (softmax_threads(cols), 1, 1),
                        shared_mem=cols * 4 if staged else 0)

    def backward(self, label, y, dx):
        rows, cols = y.shape
        self.bwd.launch([label, y, dx, cols], y.context, (rows, 1, 1),
                        (softmax_threads(cols), 1, 1))


def softmax_fwd_plain(x):
    import torch

    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def softmax_bwd_plain(label, y):
    import torch

    dx = y.clone()
    dx[torch.arange(y.shape[0], device=y.device), label.long()] -= 1.0
    return dx


def register_softmax_ops(mx):
    """Register the custom softmax head of examples/numpy_ops/
    custom_softmax.py twice: ``numpy_softmax``, the example's numpy op (it
    runs wherever its input lies), and ``rtc_softmax``, the same op as the
    two CUDA kernels above launched through mx.rtc (card only). The kernels
    compile once, at the first rtc_softmax operator."""
    kernels = []

    class NumpySoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        mx.nd.array(e / e.sum(axis=1, keepdims=True),
                                    ctx=in_data[0].context))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            prob = out_data[0].asnumpy()
            label = in_data[1].asnumpy().astype(int)
            grad = prob.copy()
            grad[np.arange(len(label)), label] -= 1.0
            self.assign(in_grad[0], req[0],
                        mx.nd.array(grad, ctx=in_data[0].context))

    class RtcSoftmaxOp(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            if req[0] not in ("write", "inplace"):
                raise mx.MXNetError("rtc_softmax writes its output; req %r"
                                    % req[0])
            kernels[0].forward(in_data[0], out_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            if req[0] not in ("write", "inplace"):
                raise mx.MXNetError("rtc_softmax writes its gradient; req "
                                    "%r" % req[0])
            kernels[0].backward(in_data[1], out_data[0], in_grad[0])

    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

    @mx.operator.register("numpy_softmax")
    class NumpySoftmaxProp(SoftmaxProp):
        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()

    @mx.operator.register("rtc_softmax")
    class RtcSoftmaxProp(SoftmaxProp):
        def create_operator(self, ctx, shapes, dtypes):
            if not kernels:
                kernels.append(RtcSoftmax(mx))
            return RtcSoftmaxOp()


def custom_softmax_net(mx, head):
    """examples/numpy_ops/custom_softmax.py ``build``: ``head`` is a
    registered op_type, or None for the built-in SoftmaxOutput."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    net = mx.sym.Flatten(data)
    net = mx.sym.FullyConnected(net, num_hidden=64, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    if head:
        return mx.sym.Custom(net, label, op_type=head, name="softmax")
    return mx.sym.SoftmaxOutput(net, label, name="softmax")


def softmax_bound_ms(rows, cols, kind, bytes_per_s):
    """Bytes each input read once and each output written once at the
    memory rate: forward x in, y out; backward label and y in, dx out. The
    few operations per element (max, exp, sum, divide) take far less at
    the fp32 peak."""
    n = rows * cols * 4
    nbytes = 2 * n if kind == "fwd" else 2 * n + rows * 4
    return nbytes / bytes_per_s * 1e3, nbytes


def softmax_phase(mx, card, peaks, gen):
    """(b): both kernels against their plain versions at the MNIST head's
    and the LM head's shapes, timed as CUDA-graph replays beside
    torch.softmax, and the host cost of one launch."""
    import torch

    kern = RtcSoftmax(mx)
    out = {}
    for shape in (SOFTMAX_SMALL, SOFTMAX_WIDE):
        rows, cols = shape
        x = mx.nd.array(torch.randn(rows, cols, device="cuda",
                                    generator=gen) * 4.0)
        label = mx.nd.array(torch.randint(0, cols, (rows,), device="cuda",
                                          generator=gen).float())
        y = mx.nd.zeros(shape, ctx=mx.gpu())
        dx = mx.nd.zeros(shape, ctx=mx.gpu())
        kern.forward(x, y)
        kern.backward(label, y, dx)
        ref_y = softmax_fwd_plain(x._data)
        ref_dx = softmax_bwd_plain(label._data, y._data)
        torch.cuda.synchronize()
        fwd_err = (y._data - ref_y).abs().max().item()
        scale = ref_y.abs().max().item()
        lib_err = (torch.softmax(x._data, 1) - ref_y).abs().max().item()
        if not (torch.isfinite(y._data).all() and
                fwd_err <= SOFTMAX_FWD_TOL * scale):
            raise AssertionError("softmax_fwd at %s: max abs err %.3g > "
                                 "%.1g * %.3g" % (shape, fwd_err,
                                                  SOFTMAX_FWD_TOL, scale))
        if not torch.equal(dx._data, ref_dx):
            raise AssertionError("softmax_bwd at %s differs from its plain "
                                 "version (max abs err %.3g)"
                                 % (shape, (dx._data - ref_dx).abs().max()
                                    .item()))
        del ref_y, ref_dx
        row = {"shape": shape, "fwd_err": fwd_err, "fwd_err_rel": fwd_err /
               scale, "library_err": lib_err}
        xt, yt, lt = x._data, y._data, label._data
        row["fwd_ms"] = time_ms(lambda: kern.forward(x, y))
        row["fwd_plain_ms"] = time_ms(lambda: softmax_fwd_plain(xt))
        row["fwd_library_ms"] = time_ms(lambda: torch.softmax(xt, 1))
        row["bwd_ms"] = time_ms(lambda: kern.backward(label, y, dx))
        row["bwd_plain_ms"] = time_ms(lambda: softmax_bwd_plain(lt, yt))
        for kind in ("fwd", "bwd"):
            bnd, nbytes = softmax_bound_ms(rows, cols, kind, peaks[1])
            row[kind + "_bound_ms"] = bnd
            row[kind + "_bytes"] = nbytes
            row[kind + "_gb_per_s"] = nbytes / row[kind + "_ms"] / 1e6
        log("rtc softmax %s: fwd err %.3g (%.3g of max |y|; torch.softmax "
            "%.3g), bwd exact; fwd %.4f ms (plain %.4f, torch.softmax %.4f, "
            "bound %.4f, %.1f GB/s), bwd %.4f ms (plain %.4f, bound %.4f, "
            "%.1f GB/s), on %s"
            % (shape, fwd_err, fwd_err / scale, lib_err, row["fwd_ms"],
               row["fwd_plain_ms"], row["fwd_library_ms"],
               row["fwd_bound_ms"], row["fwd_gb_per_s"], row["bwd_ms"],
               row["bwd_plain_ms"], row["bwd_bound_ms"], row["bwd_gb_per_s"],
               card))
        out["x".join(map(str, shape))] = row
        del x, y, dx, label, xt, yt, lt

    # the host cost of one launch call, beside one torch.add
    rows, cols = SOFTMAX_SMALL
    x = mx.nd.array(torch.randn(rows, cols, device="cuda", generator=gen))
    y = mx.nd.zeros((rows, cols), ctx=mx.gpu())
    args = [x, y, cols, 1]
    threads = (softmax_threads(cols), 1, 1)
    a, b = x._data, y._data

    def host_us(fn, n=1000):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return float(np.median(walls) * 1e6)

    out["launch_host_us"] = host_us(lambda: kern.fwd.launch(
        args, mx.gpu(), (rows, 1, 1), threads, shared_mem=cols * 4))
    out["torch_add_host_us"] = host_us(lambda: torch.add(a, b))
    log("rtc launch host cost: %.2f us per CudaKernel.launch (median of "
        "1000, %s), %.2f us per torch.add, on %s"
        % (out["launch_host_us"], SOFTMAX_SMALL, out["torch_add_host_us"],
           card))
    return out


def mnist_iters(mx, mnist, n_train, n_val, batch=100):
    """examples/numpy_ops/custom_softmax.py's split: the first n_train
    samples shuffled, the next n_val held out."""
    x, y = mnist["train_data"], mnist["train_label"]
    return (mx.io.NDArrayIter(x[:n_train], y[:n_train], batch_size=batch,
                              shuffle=True),
            mx.io.NDArrayIter(x[n_train:n_train + n_val],
                              y[n_train:n_train + n_val], batch_size=batch))


def timed_fit(mx, sym, train, val, epochs, seed=0):
    """``Module.fit`` on the card as the example runs it (SGD 0.1 /
    momentum 0.9, Xavier, accuracy, validation each epoch) with launch
    counts reset just before and read just after. Returns (module,
    launch counts, ms per step, held-out accuracy)."""
    import torch
    from mxnet_tpu_torch import cuda_build

    mod = mx.mod.Module(sym, context=mx.gpu())
    stamps = []
    np.random.seed(seed)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    mod.fit(train, eval_data=val, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier(), eval_metric=mx.metric.Accuracy(),
            batch_end_callback=lambda p: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    counts = cuda_build.launch_counts()
    val.reset()
    metric = mx.metric.Accuracy()
    mod.score(val, metric)
    return mod, counts, float(np.median(np.diff(stamps)) * 1e3), \
        metric.get()[1]


def rtc_first_step(mx, batch):
    """One forward_backward with the rtc head and with the built-in
    SoftmaxOutput from the same Xavier parameters: outputs and the four
    parameter gradients within RTC_STEP_TOL of each tensor's max |value|.
    Returns the worst."""
    import torch
    from mxnet_tpu_torch import cuda_build

    mods = {}
    for head in ("rtc_softmax", None):
        m = mx.mod.Module(custom_softmax_net(mx, head), context=mx.gpu())
        m.bind(data_shapes=[("data", batch.data[0].shape)],
               label_shapes=[("softmax_label", batch.label[0].shape)],
               for_training=True)
        mods[head] = m
    np.random.seed(0)
    mods["rtc_softmax"].init_params(mx.init.Xavier())
    mods[None].init_params(arg_params=mods["rtc_softmax"].get_params()[0],
                           aux_params={})
    sides = []
    cuda_build.reset_launch_counts()
    for head, m in mods.items():
        m.forward_backward(batch)
        grp = m._exec_group
        sides.append(dict([("output", m.get_outputs()[0]._data.clone())] + [
            (n, g[0]._data.clone())
            for n, g in zip(grp.param_names, grp.grad_arrays)]))
    torch.cuda.synchronize()
    got = cuda_build.launch_counts()
    if got.get("rtc:softmax_fwd") != 1 or got.get("rtc:softmax_bwd") != 1:
        raise AssertionError("first step launched %s, want one rtc forward "
                             "and one backward" % got)
    rtc, builtin = sides
    if sorted(rtc) != ["fc1_bias", "fc1_weight", "fc2_bias", "fc2_weight",
                       "output"]:
        raise AssertionError("first step: tensors %s" % sorted(rtc))
    worst, worst_name = 0.0, "output"
    for name in builtin:
        scale = builtin[name].abs().max().item()
        rel = (rtc[name] - builtin[name]).abs().max().item() / max(scale,
                                                                   1e-30)
        if not scale or not torch.isfinite(rtc[name]).all():
            raise AssertionError("first step: %s is zero or not finite"
                                 % name)
        if rel > worst:
            worst, worst_name = rel, name
    if worst > RTC_STEP_TOL:
        raise AssertionError("first step: the rtc head's %s differs from "
                             "SoftmaxOutput's by %.3g of its max |value| > "
                             "%.1g" % (worst_name, worst, RTC_STEP_TOL))
    return worst, worst_name, mods["rtc_softmax"]


def rtc_phase(mx, card, peaks, results):
    """Phase 8: mx.rtc on the card, (a) to (d)."""
    import torch

    out = {}
    register_softmax_ops(mx)
    gen = torch.Generator(device="cuda").manual_seed(0)

    # (a) the eight spec behaviours
    from mxnet_tpu_torch import nvrtc

    t0 = time.perf_counter()
    module = rtc_spec_module(mx)
    out["spec_compile_s"] = time.perf_counter() - t0
    out["spec"] = {}
    for name, spec in RTC_SPECS:
        out["spec"][name] = spec(mx, module)
        log("rtc spec %s: max abs err %.3g" % (name, out["spec"][name]))
    log("rtc: spec module compiled in %.3f s; %d NVRTC compiles so far"
        % (out["spec_compile_s"], nvrtc.compile_count()))

    # (b) the softmax kernels
    out["softmax"] = softmax_phase(mx, card, peaks, gen)

    # (c) the custom-softmax Module.fit, the slice's main path
    mnist = mx.test_utils.get_mnist()
    x, y = mnist["train_data"], mnist["train_label"]
    batch = mx.io.DataBatch(data=[mx.nd.array(x[:RTC_BATCH], ctx=mx.gpu())],
                            label=[mx.nd.array(y[:RTC_BATCH],
                                               ctx=mx.gpu())])
    worst, worst_name, fmod = rtc_first_step(mx, batch)
    regions = fmod._exec_group.execs[0].fused_regions()
    if [r["members"][0] for r in regions] != ["fc1"]:
        raise AssertionError("custom softmax training bind regions %s, want "
                             "fc1 + relu only" % regions)
    log("rtc first step vs SoftmaxOutput: outputs and 4 gradients agree, "
        "worst %s at %.3g of its max |value|; fuse regions %s"
        % (worst_name, worst, [r["members"] for r in regions]))
    # fc1 + relu at (100, 784) x (784, 64) on fused_matmul, held to the
    # plain composition with the rtc head on both sides
    mm_worst, mm_per_fwd = first_step_vs_plain(
        mx, fmod, batch, "fused_matmul", "rtc custom-softmax MLP")
    if mm_per_fwd != 1:
        raise AssertionError("custom softmax step launched fused_matmul %d "
                             "times, want 1 (fc1 + relu)" % mm_per_fwd)
    out["first_step"] = {"worst": worst, "worst_name": worst_name,
                         "fused_matmul_worst": mm_worst}
    fits = {}
    for head in ("rtc_softmax", None):
        train, val = mnist_iters(mx, mnist, RTC_TRAIN, RTC_VAL)
        _mod, counts, ms, acc = timed_fit(
            mx, custom_softmax_net(mx, head), train, val, RTC_EPOCHS)
        fits[head or "SoftmaxOutput"] = dict(counts=counts, ms_per_step=ms,
                                             samples_per_s=RTC_BATCH / ms
                                             * 1e3, val_acc=acc)
    steps = RTC_EPOCHS * (RTC_TRAIN // RTC_BATCH)
    forwards = steps + RTC_EPOCHS * (RTC_VAL // RTC_BATCH)
    got = fits["rtc_softmax"]["counts"]
    want = {"rtc:softmax_fwd": forwards, "rtc:softmax_bwd": steps,
            "fused_matmul": forwards * mm_per_fwd}
    if any(got.get(k, 0) != v for k, v in want.items()):
        raise AssertionError("custom softmax fit launched %s, want %s (one "
                             "per training step, the forward and "
                             "fused_matmul also once per validation batch)"
                             % (got, want))
    acc, acc_b = fits["rtc_softmax"]["val_acc"], fits["SoftmaxOutput"][
        "val_acc"]
    if not (acc > 0.8 and abs(acc - acc_b) < 0.1):
        raise AssertionError("custom softmax held-out accuracy %.4f (built-in"
                             " %.4f): want > 0.8 and within 0.1" % (acc,
                                                                     acc_b))
    log("rtc fit: %d epochs x %d steps of %d (+%d validation batches each "
        "epoch): launches %s; held-out accuracy %.4f (built-in head "
        "%.4f); %.3f ms/step, %.1f samples/s (built-in %.3f ms/step), on %s"
        % (RTC_EPOCHS, steps // RTC_EPOCHS, RTC_BATCH, RTC_VAL // RTC_BATCH,
           got, acc, acc_b, fits["rtc_softmax"]["ms_per_step"],
           fits["rtc_softmax"]["samples_per_s"],
           fits["SoftmaxOutput"]["ms_per_step"], card))
    out["fit"] = fits
    out["launches"] = got["rtc:softmax_fwd"] + got["rtc:softmax_bwd"]

    # (d) the canonical LeNet drive: its first step through fc1 + tanh at
    # (100, 800) x (800, 500) on fused_matmul against the plain
    # composition, then the fit with its launches counted
    lmod = mx.mod.Module(mx.models.get_lenet(10), context=mx.gpu())
    lmod.bind(data_shapes=[("data", batch.data[0].shape)],
              label_shapes=[("softmax_label", batch.label[0].shape)],
              for_training=True)
    np.random.seed(0)
    lmod.init_params(mx.init.Xavier())
    regions = [r["members"] for r in lmod._exec_group.execs[0]
               .fused_regions()]
    if [m[0] for m in regions] != LENET_REGION_BASES or not all(
            len(m) == 2 and m[1].startswith("activation") for m in regions):
        raise AssertionError("LeNet training bind regions %s, want %s each "
                             "with its activation"
                             % (regions, LENET_REGION_BASES))
    lenet_worst, lenet_per_fwd = first_step_vs_plain(
        mx, lmod, batch, "fused_matmul", "lenet")
    # the NCHW convolutions' regions run the plain composition
    if lenet_per_fwd != 1:
        raise AssertionError("LeNet step launched fused_matmul %d times, "
                             "want 1 (fc1 + tanh)" % lenet_per_fwd)
    del lmod
    train, val = mnist_iters(mx, mnist, LENET_TRAIN, LENET_VAL)
    _mod, counts, ms, acc = timed_fit(mx, mx.models.get_lenet(10), train,
                                      val, LENET_EPOCHS)
    lenet_fwds = LENET_EPOCHS * (LENET_TRAIN + LENET_VAL) // RTC_BATCH
    if counts.get("fused_matmul", 0) != lenet_fwds * lenet_per_fwd:
        raise AssertionError("LeNet fit launched fused_matmul %d times, want"
                             " %d (once per training step and validation "
                             "batch)" % (counts.get("fused_matmul", 0),
                                         lenet_fwds * lenet_per_fwd))
    if not acc > 0.8:
        raise AssertionError("LeNet validation accuracy %.4f <= 0.8" % acc)
    out["lenet"] = {"ms_per_step": ms, "samples_per_s": RTC_BATCH / ms * 1e3,
                    "val_acc": acc, "regions": regions,
                    "fused_matmul_worst": lenet_worst,
                    "fused_matmul_launches": counts["fused_matmul"]}
    log("lenet fit: %d samples, batch %d, %d epochs: %.3f ms/step, %.1f "
        "samples/s, validation accuracy %.4f, fused_matmul launches %d, on "
        "%s" % (LENET_TRAIN, RTC_BATCH, LENET_EPOCHS, ms,
                RTC_BATCH / ms * 1e3, acc, counts["fused_matmul"], card))
    results["rtc"] = out
    return out


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
        "kernel_cases": [], "bmm_cases": []}

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
    bmm_err, bmm_totals = bmm_phase(peaks, results)
    bmm_launches = module_phase(mx, card, results)
    rtc = rtc_phase(mx, card, peaks, results)

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
    wide = bmm_totals["wide"]
    kernels["kernels"].append({
        "name": "fused_batch_matmul", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/fused_matmul.cu",
        "replaces": "mxnet_tpu/parallel/fused.py:292",
        "launches": bmm_launches, "max_abs_err": bmm_err,
        "ms": wide["ms"], "plain_ms": wide["plain_ms"],
        "bound_ms": wide["bound_ms"], "bound_by": wide["bound_by"],
        "library_ms": wide["library_ms"]})
    wide_sm = rtc["softmax"]["x".join(map(str, SOFTMAX_WIDE))]
    kernels["kernels"].append({
        "name": "rtc", "route": "cuda-nvrtc",
        "source": "mxnet_tpu_torch/rtc.py",
        "replaces": "mxnet_tpu/rtc.py:163",
        "launches": rtc["launches"],
        "max_abs_err": max(r["fwd_err"] for k, r in rtc["softmax"].items()
                           if isinstance(r, dict)),
        "ms": wide_sm["fwd_ms"], "plain_ms": wide_sm["fwd_plain_ms"],
        "bound_ms": wide_sm["fwd_bound_ms"], "bound_by": "bytes",
        "library_ms": wide_sm["fwd_library_ms"],
        "launch_host_us": rtc["softmax"]["launch_host_us"]})
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

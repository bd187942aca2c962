#!/usr/bin/env python3
"""Whether the causal LM's bf16 gradients through the flash kernels part
from plain attention's by more than a flash attention's bf16 rounding, on
one CUDA card.

    python3 tools/port_bf16_study.py [--out study.json]

Builds ``mxnet_tpu_torch.parallel.TransformerParallel`` at the
configuration of chip_smoke.py's train phase (vocab 32768, d 512, 8 heads,
8 layers, d_ff 2048, 1 expert, bf16; parameters from ``init(0)``) and
runs its first step at chip_smoke's ``COMPARE_B`` (2) x T 2048 four
ways: with the flash kernels, with plain attention in bf16 (fp32
arithmetic between bf16 inputs and outputs), with PyTorch's
``scaled_dot_product_attention`` in bf16 (a library flash attention whose
backward rounds p and ds to bf16 as the port's tensor-core kernels do; a
yardstick here, never called by the port), and with plain attention in
fp32 from the same parameters. Per tensor, each bf16 run's error against
the fp32 one over the fp32 gradient's max |value|. The kernels round p
(forward and backward) and ds to bf16 where a flash attention does and
plain attention does not, so the verdict holds them to SDPA's flash: their
error within ``BF16_RATIO_LIMIT`` times SDPA's on every tensor is that
rounding, otherwise a fault; the tensors beyond that many times plain
bf16's error are reported beside it. Then one causal attention at (2, 8, 2048, 64) bf16
isolates what taking delta = rowsum(do * o) from the forward kernel's
bf16 o costs (``flash_delta_study``, also run by
``tests/test_torch_cuda.py``).

Needs one card; about 30 s with the kernels' build.
"""
import argparse
import importlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from chip_smoke import (COMPARE_B, TRAIN_CFG, flash_module, log,  # noqa: E402
                        plain_local_attention)

# the kernels' per-tensor error against fp32, at most this many times SDPA's
# bf16 flash attention's, is the flash rounding of p and ds
BF16_RATIO_LIMIT = 2.0


def sdpa_local_attention(q, k, v, mesh=None):
    """Causal attention by PyTorch's SDPA, held to its flash backend (the
    library's bf16 flash attention): the study's yardstick. Left to choose,
    SDPA returned gradients 1.2-1.4x the fp32 gradient's max away from it
    in one process on the H100 and 3e-3 in another."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)


def bf16_gradient_study(mx, TT, params, tok, tgt, grads_k, grads_p,
                        grads_s):
    """The first step's bf16 gradients with the flash kernels, with plain
    attention and with SDPA, each against the same step in fp32 with plain
    attention from the same (bf16-valued) parameters, per tensor relative
    to the fp32 gradient's max |value|. The kernels' error within
    BF16_RATIO_LIMIT times SDPA's flash on every tensor means their gap to
    plain bf16 attention is the flash rounding of p and ds; it is
    reported, not gated."""
    tp32 = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                           dtype="float32", **TRAIN_CFG)
    p32 = {k: v.detach().float().requires_grad_(True)
           for k, v in params.items()}
    real = TT._local_attention
    TT._local_attention = plain_local_attention
    try:
        _loss32, grads32 = tp32.value_and_grad(p32, tok, tgt)
    finally:
        TT._local_attention = real
    import torch

    # per tensor: max |fp32|, max |kernels - fp32|, max |plain - fp32|,
    # max |sdpa - fp32|, fetched from the card once
    maxima = torch.stack([torch.stack([
        g32.abs().max(), (grads_k[name].float() - g32).abs().max(),
        (grads_p[name].float() - g32).abs().max(),
        (grads_s[name].float() - g32).abs().max()])
        for name, g32 in grads32.items()]).tolist()
    rows = {}
    for name, (top, dk, dp, ds) in zip(grads32, maxima):
        scale = max(top, 1e-30)
        ek, ep, es = dk / scale, dp / scale, ds / scale
        rows[name] = {"kernel_vs_fp32": ek, "plain_vs_fp32": ep,
                      "sdpa_vs_fp32": es, "ratio": ek / max(ep, 1e-30),
                      "ratio_vs_sdpa": ek / max(es, 1e-30)}
    worst = max(rows, key=lambda n: rows[n]["ratio"])
    worst_k = max(rows, key=lambda n: rows[n]["kernel_vs_fp32"])
    worst_p = max(rows, key=lambda n: rows[n]["plain_vs_fp32"])
    over = sorted(n for n in rows if rows[n]["ratio"] > BF16_RATIO_LIMIT)
    median = float(np.median([r["ratio"] for r in rows.values()]))
    worst_s = max(rows, key=lambda n: rows[n]["ratio_vs_sdpa"])
    over_s = sorted(n for n in rows
                    if rows[n]["ratio_vs_sdpa"] > BF16_RATIO_LIMIT)
    median_s = float(np.median([r["ratio_vs_sdpa"] for r in rows.values()]))
    verdict = "flash rounding" if not over_s else "fault"
    log("bf16 study: against fp32 plain attention, per tensor over its "
        "max |fp32 grad|: kernels' worst %s %.3g (plain bf16 there %.3g); "
        "largest kernels/plain ratio %s %.3g (%.3g vs %.3g); verdict %s "
        "(against SDPA's flash, ratio limit %.1f)"
        % (worst_k, rows[worst_k]["kernel_vs_fp32"],
           rows[worst_k]["plain_vs_fp32"], worst, rows[worst]["ratio"],
           rows[worst]["kernel_vs_fp32"], rows[worst]["plain_vs_fp32"],
           verdict, BF16_RATIO_LIMIT))
    log("bf16 study: plain bf16's worst %s %.3g; median kernels/plain "
        "ratio %.3g; tensors over the limit against plain bf16 %s"
        % (worst_p, rows[worst_p]["plain_vs_fp32"], median, over))
    log("bf16 study: against SDPA in bf16, largest kernels/SDPA ratio %s "
        "%.3g (%.3g vs %.3g); median %.3g; tensors over the limit %s"
        % (worst_s, rows[worst_s]["ratio_vs_sdpa"],
           rows[worst_s]["kernel_vs_fp32"], rows[worst_s]["sdpa_vs_fp32"],
           median_s, over_s))
    for name in ("l7_wk", "l7_wq", "l4_wk", "l0_wk", "embed", "out_w"):
        if name in rows:
            log("bf16 study %s: %s" % (name, rows[name]))
    del grads32, p32
    return {"verdict": verdict, "worst_ratio_name": worst,
            "worst_kernel_name": worst_k, "worst_plain_name": worst_p,
            "median_ratio": median, "over_limit": over,
            "worst_ratio_vs_sdpa_name": worst_s,
            "median_ratio_vs_sdpa": median_s,
            "over_limit_vs_sdpa": over_s, "tensors": rows,
            "one_attention": flash_delta_study()}


def flash_delta_study(shape=(COMPARE_B, 8, 2048, 64)):
    """One causal attention from the same bf16 q, k, v, do: dq, dk, dv
    against autograd of the plain formula in fp32, relative to the fp32
    gradient's max |value|, for (1) plain bf16 autograd (fp32 arithmetic
    between bf16 inputs and outputs), (2) the kernels as the path runs them
    (delta = rowsum(do * o) from the forward kernel's bf16 o), (3) the same
    kernels given delta from the fp32 o, (4) SDPA's bf16 autograd (p and ds
    rounded to bf16, as the kernels round them). (2) against (3) isolates
    what the rounding of o in delta costs, (2) against (4) where a library
    flash attention lands."""
    import torch

    FA = flash_module()
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(*shape, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    scale = shape[-1] ** -0.5

    def plain(dtype):
        leaves = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
        o = FA.flash_attention_reference(*leaves, causal=True)[0]
        return o.detach(), torch.autograd.grad(o, leaves, do.to(dtype))

    o32, g32 = plain(torch.float32)
    _o16, g16 = plain(torch.bfloat16)
    o, lse = FA.flash_forward(q, k, v, True, scale)

    def kernels(o_for_delta):
        delta = (do.float() * o_for_delta.float()).sum(-1).contiguous()
        dq = FA.flash_backward_dq(q, k, v, do, lse, delta, True, scale)
        dk, dv = FA.flash_backward_dkv(q, k, v, do, lse, delta, True, scale)
        return dq, dk, dv

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    g_sdpa = torch.autograd.grad(sdpa_local_attention(*leaves), leaves, do)
    variants = {"plain_bf16": g16, "kernels": kernels(o),
                "kernels_fp32_delta": kernels(o32), "sdpa_bf16": g_sdpa}
    maxima = torch.stack([torch.stack([(g.float() - ref).abs().max(),
                                       ref.abs().max()])
                          for grads in variants.values()
                          for g, ref in zip(grads, g32)]).tolist()
    out = {name: {} for name in variants}
    cells = [(name, gname) for name in variants for gname in ("dq", "dk",
                                                               "dv")]
    for (name, gname), (err, top) in zip(cells, maxima):
        out[name][gname] = err / top
    log("bf16 study, one attention %s bf16 causal, error against fp32 "
        "over max |fp32 grad|: %s" % (shape, out))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--out", help="write the results here as JSON")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_bf16_study: CUDA is not available", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cuda_build

    card = chip_smoke.nvidia_smi()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all(["flash_attention"])
    TT = importlib.import_module("mxnet_tpu_torch.parallel.transformer")
    cfg, B = chip_smoke.TRAIN_CFG, chip_smoke.COMPARE_B
    tp = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                         dtype="bfloat16", **cfg)
    tok = np.random.RandomState(0).randint(
        0, cfg["vocab"], (chip_smoke.TRAIN_B, chip_smoke.TRAIN_T)) \
        .astype(np.int32)
    tok, tgt = tp.shard_batch(tok, np.roll(tok, -1, axis=1))
    tok, tgt = tok[:B], tgt[:B]
    params = tp.init(0)
    _loss, grads_k = tp.value_and_grad(params, tok, tgt)
    real = TT._local_attention
    try:
        TT._local_attention = chip_smoke.plain_local_attention
        _loss, grads_p = tp.value_and_grad(params, tok, tgt)
        TT._local_attention = sdpa_local_attention
        _loss, grads_s = tp.value_and_grad(params, tok, tgt)
    finally:
        TT._local_attention = real
    out = bf16_gradient_study(mx, TT, params, tok, tgt, grads_k, grads_p,
                              grads_s)
    out["card"] = card
    if opts.out:
        if os.path.dirname(opts.out):
            os.makedirs(os.path.dirname(opts.out), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(out, f, indent=1)
    log(json.dumps({k: v for k, v in out.items()
                               if k != "tensors"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

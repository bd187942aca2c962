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
   without an lse cotangent, fp32, bf16 and fp16). The bf16/fp16 kernels
   (tensor cores) are also held to the plain version that rounds p (and
   ds) to the input type where they do (``FLASH_ROUNDED_TOL``; the
   forward's walks the key axis in its 64-key tiles, and its lse is held
   at the fp32 bar), and two launches on the same inputs must give the
   same bits. Times each
   kernel and PyTorch's ``scaled_dot_product_attention`` (forward, and
   forward + backward; timed as a yardstick only, its backward the dq +
   dk/dv pair's ``library_ms``) as CUDA-graph replays and each plain
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
   8/100, every epilogue kind, fp32 and bf16) and a grid whose shapes
   take the kernel's 128 x 128 tile (``BMM_LARGE_GRID``, ragged M, N and
   K; the small grid takes the 64 x 64 tile). Times the kernel, the plain
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
   CUDA-graph replays beside ``torch.softmax`` (the backward beside
   ``torch._softmax_backward_data``) with the bound at the memory rate,
   and the host cost of one launch call. (c) The slice's main
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
9. ResNet-50 train phase: ResNet-50 v2 NHWC fp32 (``get_resnet(1000,
   50, layout="NHWC")``, Xavier gaussian / in / magnitude 2 from seed 0)
   trained with ``Module.fit`` on the card at batch 32 on a synthetic
   batch (bench.py's: uniform pixels, random labels; SGD lr 0.1, momentum
   0.9, wd 1e-4), TF32 off. (a) The training bind carves 16 regions (each
   bottleneck's conv3 with its residual add); the first ``fit`` step with
   ``fused_matmul`` (16 launches) and with ``MXNET_FUSION_KERNEL=0``, both
   with cuDNN's deterministic algorithms, from the same parameters: every
   parameter and aux state within 1e-5 of its own max |value|, every
   parameter moved; the plain step once more with cuDNN's default
   algorithms reports their spread. (b) Launch counts reset just before 10 fenced steps
   and read just after: exactly 16 per step. (c) The cross entropy on the
   fixed batch falls over the N = 17 steps. (d) ms/step (median of the 10
   fenced steps), img/s, peak memory, and under ``torch.profiler`` over 3
   steps the device ms per step by family (cuDNN conv, BatchNorm,
   elementwise, ``fused_matmul``, the optimizer update, copies) and the
   busy share. (e) ``fused_matmul`` at the four shapes of a training
   step's regions (recorded from the training graph on meta tensors)
   against its plain version, timed beside it and beside ``torch.addmm``
   + the residual add as CUDA-graph replays, with its bound. (f) 30
   training-mode forwards settle the moving statistics; ``save_checkpoint``
   into a temporary directory, ``load_checkpoint``: the ``.params`` equal
   what was saved, bit for bit; an ``InferenceServer`` on the loaded
   parameters answers 8 single-image requests from the batch: logits
   within 1e-3 of max |logit| of ``Module.predict``, probabilities within
   1e-3 of the trained module's, top-1 equal, more than one class.
10. ShardedTrainer phase (bench protocol): ``bench.py:38-75`` through the
   port: ``make_mesh({"dp": 1})``, ResNet-50 NHWC, ``ShardedTrainer`` with
   SGD 0.1 / 0.9 / 1e-4 in bf16, ``init`` (Xavier gaussian / in / 2, seed
   0), ``shard_batch`` of bench.py's batch. The step is one CUDA graph,
   captured once per batch signature and replayed. With cuDNN's
   deterministic algorithms and a decaying learning rate (so each replay
   must read its own): (a) one replay against one eager step from the same
   state, every parameter, aux state and momentum bit-identical (and, with
   the default algorithms, how many are); (b) ``multi_step(5)`` against
   five ``step`` calls and five eager steps: the same losses and state to
   the bit, and one capture for all of them; (c) the cross entropy on the
   fixed batch falls over 12 steps; (e) 2 steps, ``save_checkpoint``,
   ``load_checkpoint`` into a new trainer, 2 more: bit-identical to 4
   uninterrupted steps. (d) With the default algorithms, the protocol
   timed: batch 32 for 200 steps and 128 for 40, each ``multi_step`` once
   to capture and warm and once timed, ended by a fetch of the losses:
   img/s, replay ms/step, peak memory (above what earlier phases still
   hold), ``mfu_bs32``; at batch 32 the eager
   step's ms/step (fenced) and, under ``torch.profiler``, the device ms per
   step by family (from eager steps, which launch the graph's kernels,
   BatchNorm and the update marked as scopes), the replays' device ms and
   the busy share.
11. Generation phase: the causal LM at the train phase's width served by
   ``mx.serving.generation.Generator`` (max_seq 2048, 8 slots, page 16,
   decode blocks of 128 tokens, the default prefill ladder 16 ... 1024,
   2048); the decode step (and the verify and draft steps with
   speculation) one CUDA graph, prefill eager through the flash forward.
   (a) fp32, ``init(0)``: ``prefill_forward``'s logits with the kernel
   within 1e-5 of max |logit| of the plain dense path's at T 16, 333 and
   2048 (one kernel launch per layer), and the greedy output of 8 prompts
   of 2-999 tokens, 32 new tokens each, token-exact against the
   full-recompute oracle (``prefill_forward`` over the whole sequence for
   every token). (b) bf16 from the train phase's trained parameters,
   saved with ``save_checkpoint`` into a temporary directory and served by
   ``Generator.from_checkpoint``: prefill logits within 2e-2 of the plain
   path's, and how many of the 8 prompts' greedy tokens agree with a
   generator whose prefill attends with the plain path (reported, not
   checked). (c) Every generator's ``warmup()`` returns buckets + 1
   programs (+1 n-gram, +2 draft) with as many captures, and the captures
   stay flat through its traffic. (d) ``bench_all.py:614-733``
   ``bench_generation_lm`` at this width in bf16: 48 requests with prompts
   of 2-1983 tokens from ``RandomState(0)``, 64 new tokens, Poisson
   arrivals at 3x the sequential capacity a warmed generator's probe of 4
   requests measures; continuous batching, then the sequential baseline:
   tokens/s, TTFT, inter-token and per-token latency p50/p99, the flash
   forward's launches (launch counts reset just before each run and read
   just after: exactly 8 per request), peak memory; each bucket's eager
   prefill timed (wall and device ms); the decode step at 8 slots and
   1000 tokens of context replayed against its eager body (equal to the
   bit), timed both ways, its device ms by family under
   ``torch.profiler`` (paged attention and sampling marked as scopes) and
   the busy share. (e) fp32: n-gram speculation (spec_k 4) and draft-model
   speculation (a 2-layer d 128 draft) on 8 cyclic prompts, greedy and
   seeded temperature, equal to spec_k 0's output, with the acceptance
   rates and tokens/s. (f) Every generator ends drained with no page
   leaked (``PagePool.assert_no_leaks``).
12. Gluon phase: ``bench_all.py:153-211`` ``bench_gluon_resnet`` at its
   full size through the port's Gluon. (a) ``resnet18_v1()`` (1000
   classes), NCHW fp32 224x224, batch 32, ``mx.random.seed(0)`` (and
   ``np.random``'s) then ``initialize(ctx=mx.gpu())`` with the default
   init; ``SoftmaxCrossEntropyLoss``; ``Trainer(..., "sgd",
   {"learning_rate": 0.05}, kvstore="local")``; ``RandomState(0)`` images
   and labels in [0, 1000). (b) The hybridized forward against the
   imperative one, predict mode: logits within 1e-5 of max |logit|. With
   cuDNN's deterministic algorithms: (c) one ``compile_step`` replay (the
   step one CUDA graph) against its body run eagerly from the same state
   with the same device scalars: every parameter, aux state and optimizer
   state and the loss equal to the bit; (d) one eager-tape step
   (``record`` / ``backward`` / ``trainer.step(32)``) against one
   ``compile_step`` step from the same state: loss and every tensor within
   1e-5 of its max |value|, and how many are bit-identical; (f) the loss
   on the fixed batch falls over 12 steps; (e) after
   ``set_learning_rate(0.025)`` the replay still equals its body to the
   bit, with one capture. (g) With the default algorithms: a new
   ``compile_step`` captured and warmed once, 30 timed steps ended by one
   loss fetch (img/s), one capture after them and after a rate change;
   replays' device ms per step under ``torch.profiler`` and the busy share
   (that device time over the same replays' wall time);
   3 eager-tape steps (img/s); peak memory above the earlier phases; the
   eager step's device ms by family under ``torch.profiler`` (BatchNorm
   and the update marked as scopes). (h) ``examples/gluon/mnist_gluon.py``'s
   ``--smoke`` drive inline on the card (the 128-64-10 relu MLP, 2000
   synthetic rows, ``DataLoader`` batch 100 shuffled, SGD 0.1 / 0.9, 2
   epochs), imperative and hybridized: train accuracy > 0.8 each. (i) 122
   cases of the slice's ops on the card against the same ops on the CPU,
   forward and gradient (fp32 within 1e-6 of each tensor's max, 1e-5
   for a tensor that sums many terms in another order: a reduction's or
   a softmax's output, a broadcast or gathered operand's gradient;
   integer outputs equal), and a captured step through ``Dropout(0.5)``: each of
   4 replays draws a new mask, its keep rate within 5 standard errors of
   0.5. No kernel of this package lies on the Gluon path (as in the JAX
   package, a hybridized block runs no graph pass).
13. RNN phase: the fused ``RNN`` op on cuDNN and the RNN family on the
   card, TF32 off. (a) The CPU tests' grid (rnn_tanh, rnn_relu, lstm,
   gru x 1, 2 layers x uni-, bidirectional) at H 200, T 35, N 32, fp32:
   ``ops.rnn.rnn_cudnn`` (one ``torch._VF`` call, weights viewed out of
   the flat vector and repacked by torch) against ``rnn_reference`` (the
   plain loop over time) on the same inputs: outputs, final states and
   the gradients of data, parameters and states within 5e-5 of each
   tensor's max (cuDNN's fp32 tanh, ~7e-6 off float64 in one step, sets
   the gap; both routes' errors against a float64 ``rnn_reference`` are
   reported beside it, the plain one's held to 1e-5); both routes timed,
   the forward as CUDA-graph replays, forward + backward between CUDA
   events (cuDNN's RNN backward cannot be captured). (b)
   ``bench_all.py:214-261`` ``bench_lstm_ptb`` in full: a
   2 x 200 ``FusedRNNCell`` LSTM language model, T 35, batch 32, vocab
   10000, SGD 0.1, ``Module`` on ``mx.gpu()``, parameters from
   ``np.random.seed(0)``; the fuse pass carves nothing; the first step's
   loss and every gradient against the same step with the op on
   ``rnn_reference`` (1e-5); 2 warm and 60 timed steps ended by the
   bench's ``.asnumpy()`` fetch (samples/s, ms/step); 3 steps under
   ``torch.profiler``: device ms by family (cuDNN RNN forward and
   backward, the weight repack, the weight-gradient scatter, cuBLAS FC,
   softmax, Embedding, the update) and the busy share over their own
   wall; peak memory; finite losses. (c) ``examples/rnn/lstm_bucketing.py``'s
   drive at its defaults on the card: ``BucketingModule`` over buckets
   10, 20, 30 with ``Perplexity``, 4 epochs, train perplexity under its
   bar of 10. (d) A ``gluon.rnn.LSTM`` (2 x 200, TNC) under a Dense head
   over the vocabulary: the first eager-tape step's gradients against
   ``rnn_reference`` (1e-5), then the loss falls over 6 ``gluon.Trainer``
   steps. (e) ``p`` 0.2 between two layers: the mask's keep rate within
   3 standard errors and the output equal to ``rnn_reference``'s with the
   same draws; the bench step with that dropout under
   ``MXNET_BACKWARD_DO_MIRROR`` equal to the unmirrored one to the bit
   (cuDNN's deterministic algorithms); a Dropout MLP's ``ShardedTrainer``
   step's peak memory, eager and captured, mirrored and not. No kernel of
   this package lies on the RNN path (the JAX op is a ``lax.scan``).
14. Print the ``kernels`` JSON line (the flash forward's row also carries
   phase 11's prefill launches), then the result line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero without a result when CUDA is unavailable or the package is
not beside the script.
"""
import argparse
import gc
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
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 4e-3}
# the bf16/fp16 backward kernels vs the plain version that rounds p and ds
# to the input type where they do (``round_to``), in fp32 before the output
# is rounded: the two differ by summation order alone, in the fp32
# products, exp and the tensor cores' accumulation (~1e-6 relative), which
# can move a p or ds across a rounding boundary of the input type: each
# such flip moves one term of a sum by one ulp of it (2^-8 in bf16), and
# they are rare (about 1e-6 / 2^-8 of the terms). The bar is on what stays
# after half an ulp of the output's own rounding, over max(1, max |plain|).
FLASH_ROUNDED_TOL = 2e-3
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
# the ResNet-50 training phase: bench.py:46-54's optimizer at batch 32;
# the fuse pass's 16 conv3 + residual regions of one training forward
RN_BATCH, RN_LR, RN_MOMENTUM, RN_WD = 32, 0.1, 0.9, 1e-4
RN_REGIONS = 16
# steps on one fixed batch: 1 first fit step, RN_WARM warm, RN_TIMED timed
# and fenced one by one, RN_PROFILED under torch.profiler (N = 17 <= 20)
RN_WARM, RN_TIMED, RN_PROFILED = 3, 10, 3
RN_REQUESTS = 8          # served requests of the hand-off
# training-mode forwards of the batch (no update) before the checkpoint:
# the moving statistics of the last weights, not of 17 fast-moving steps
RN_RECALIBRATE = 30
RN_SCOPES = ("mx::BatchNorm", "mx::update")   # the profiled steps' marks
# the ShardedTrainer phase: bench.py:38-75's protocol (ResNet-50 NHWC bf16,
# SGD 0.1 / 0.9 / 1e-4, default Xavier from seed 0), batch 32 for 200
# steps and batch 128 for 40, each multi_step run once to capture and warm
# and once timed; FLOPs per image from bench.py:30
BENCH_RUNS = ((32, 200), (128, 40))
BENCH_FLOPS_PER_IMG = 3 * 4.089e9
# the checks' learning-rate schedule, so that each replay must read its own
TR_SCHEDULE_DECAY = 0.8
TR_MULTI = 5             # (b): multi_step(5) against five steps
TR_LEARN = 12            # (c): steps over which the loss must fall
TR_RESUME = (2, 2)       # (e): k steps, checkpoint, m more
TR_EAGER_TIMED = 10      # eager steps timed (fenced) at batch 32
TR_PROFILED = 3          # steps under torch.profiler, eager and replayed
BMM_GRID_B, BMM_GRID_MN, BMM_GRID_K = (1, 3), (1, 17, 129), (8, 100)
# (B, M, N, K) whose grid takes the kernel's 128 x 128 tile on an H100 (at
# least one block per SM), ragged in M, N and K
BMM_LARGE_GRID = ((3, 1000, 700, 37), (3, 1000, 700, 130),
                  (1, 2000, 1100, 64), (2, 1031, 1030, 100))
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


def record_region_calls(mx, sym, bucket, for_training=False):
    """The fused_matmul calls of one forward at ``bucket``, recorded from
    the optimized graph run on meta tensors (shapes only): the served graph
    (parameters frozen, BatchNorm folded), or with ``for_training`` the
    graph a training bind runs."""
    import torch
    from mxnet_tpu_torch.executor import _GraphProgram
    from mxnet_tpu_torch.parallel import fused as F

    frozen = [] if for_training else [
        a for a in sym.list_arguments()
        if a not in ("data", "softmax_label")] + sym.list_auxiliary_states()
    opt = mx.graph_pass.optimize(sym, for_training=for_training,
                                 frozen=frozen,
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


def time_case(F, case, gen, peaks):
    """One fp32 kernel-form call: held to its plain version (PATH_TOL) and
    timed beside it and beside the cuBLAS yardstick as CUDA-graph replays,
    with its bound."""
    import torch

    err, (x, w, extras) = check_case(F, case, torch.float32, gen, PATH_TOL)
    ep, wt = case["epilogue"], case["wt"]
    bnd, by = bound_ms(case, 4, peaks)
    return dict(
        M=case["M"], N=case["N"], K=case["K"],
        tile=F.tile_size(1, case["M"], case["N"]), max_abs_err=err,
        ms=time_ms(lambda: F.fused_matmul(x, w, extras, ep, wt)),
        plain_ms=time_ms(lambda: F.fused_matmul_reference(x, w, extras, ep,
                                                          wt)),
        library_ms=time_ms(lambda: library_fn(x, w, extras, ep, wt)),
        bound_ms=bnd, bound_by=by)


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
            row = time_case(F, case, gen, peaks)
            path_err = max(path_err, row["max_abs_err"])
            kind = "+".join(s[0] if s[0] != "act" else s[1]
                            for s in case["epilogue"])
            row.update(bucket=bucket, region=i, epilogue=kind)
            results["kernel_cases"].append(row)
            log("kernel bucket=%d region=%02d M=%d N=%d K=%d %s tile=%d "
                "err=%.3g ms=%.4f plain_ms=%.4f library_ms=%.4f "
                "bound_ms=%.4f (%s)"
                % (bucket, i, row["M"], row["N"], row["K"], kind,
                   row["tile"], row["max_abs_err"], row["ms"],
                   row["plain_ms"], row["library_ms"], row["bound_ms"],
                   row["bound_by"]))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[k] += row[k]
            tot["t_ops" if row["bound_by"] == "operations"
                else "t_bytes"] += row["bound_ms"]
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


def rounded_excess(out, ref32):
    """max over elements of |out - ref32| beyond half an ulp of out's type
    at ref32 (the output's one rounding), over max(1, max |ref32|)."""
    import torch

    bits = {torch.bfloat16: 8, torch.float16: 11}[out.dtype]
    _m, e = torch.frexp(ref32)
    half_ulp = torch.where(ref32 == 0, torch.zeros_like(ref32),
                           torch.ldexp(torch.ones_like(ref32), e - bits - 1))
    excess = ((out.float() - ref32).abs() - half_ulp).clamp_min(0)
    return (excess.max() / ref32.abs().max().clamp_min(1.0)).item()


def check_flash_rounding(FA, q, k, v, do, lse, delta, causal, dq, dk, dv,
                         what):
    """The tensor-core backward kernels' outputs (dq, dk, dv) against the
    plain version that rounds p and ds to the input type where they do, at
    FLASH_ROUNDED_TOL; and a second launch of each kernel on the same inputs
    gives the same bits. Returns the excess of each output."""
    import torch

    scale = q.shape[-1] ** -0.5
    f32 = [t.float() for t in (q, k, v, do)]
    refs = {"dq": FA.flash_backward_dq_reference(*f32, lse, delta, causal,
                                                 scale, round_to=q.dtype)}
    refs["dk"], refs["dv"] = FA.flash_backward_dkv_reference(
        *f32, lse, delta, causal, scale, round_to=q.dtype)
    excess = {}
    for name, out in (("dq", dq), ("dk", dk), ("dv", dv)):
        excess[name] = rounded_excess(out, refs[name])
        if excess[name] > FLASH_ROUNDED_TOL:
            raise AssertionError(
                "%s at %s: %.3g of max |plain| beyond half an ulp against the"
                " plain version rounding p and ds to %s > %.1g"
                % (name, what, excess[name], q.dtype, FLASH_ROUNDED_TOL))
    del refs, f32
    again = [FA.flash_backward_dq(q, k, v, do, lse, delta, causal)]
    again += FA.flash_backward_dkv(q, k, v, do, lse, delta, causal)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        if not torch.equal(a, b):
            raise AssertionError("%s at %s: two launches on the same inputs "
                                 "differ" % (name, what))
    return excess


def check_flash_forward_rounding(FA, q, k, v, causal, o, lse, what):
    """The tensor-core forward's o against the plain version that rounds p
    to the input type where it does (its 64-key tiles and running max), at
    FLASH_ROUNDED_TOL beyond half an ulp of o's own rounding; lse within
    FLASH_TOL's fp32 bar of it; and a second launch on the same inputs
    gives the same bits. Returns o's excess."""
    import torch

    scale = q.shape[-1] ** -0.5
    ro, rlse = FA.flash_forward_reference(q.float(), k.float(), v.float(),
                                          causal, scale, round_to=q.dtype)
    excess = rounded_excess(o, ro)
    if excess > FLASH_ROUNDED_TOL:
        raise AssertionError(
            "o at %s: %.3g of max |plain| beyond half an ulp against the "
            "plain version rounding p to %s > %.1g"
            % (what, excess, q.dtype, FLASH_ROUNDED_TOL))
    _err, rel = rel_err(lse, rlse, "%s lse (rounding plain)" % (what,))
    if rel > FLASH_TOL["float32"]:
        raise AssertionError("lse at %s: %.3g of max |plain| against the "
                             "rounding plain version > %.1g"
                             % (what, rel, FLASH_TOL["float32"]))
    del ro, rlse
    o2, lse2 = FA.flash_forward(q, k, v, causal)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError("forward at %s: two launches on the same "
                             "inputs differ" % what)
    return excess


def check_flash(FA, q, k, v, do, dlse, causal, tol, what):
    """Each kernel against its plain version on the same inputs (the
    bf16/fp16 backward kernels also against the rounding plain version and
    a second launch), then the autograd function against dense autograd of
    the reference. Returns the max abs error of each kernel, and the
    backward outputs' excess over the rounding plain version (None in
    fp32)."""
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
    excess = None
    if q.dtype != torch.float32:
        excess = check_flash_rounding(FA, q, k, v, do, lse, delta, causal,
                                      dq, dk, dv, what)
        excess["o"] = check_flash_forward_rounding(FA, q, k, v, causal, o,
                                                   lse, what)
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
    return errs, excess


def flash_phase(card, peaks, results):
    import torch

    FA = flash_module()
    gen = torch.Generator(device="cuda").manual_seed(0)
    path_err = {}
    for dtype in ("bfloat16", "float32"):
        ins = flash_inputs(FLASH_SHAPE, getattr(torch, dtype), gen)
        errs, excess = check_flash(FA, *ins, causal=True,
                                   tol=FLASH_TOL[dtype],
                                   what="%s %s causal" % (FLASH_SHAPE, dtype))
        log("flash path %s %s causal: max abs err %s; beyond half an ulp of "
            "the plain version rounding p and ds: %s (bar %.1g), two "
            "launches bit-identical" % (FLASH_SHAPE, dtype, errs, excess,
                                        FLASH_ROUNDED_TOL))
        if dtype == "bfloat16":
            path_err, path_excess = errs, excess
        del ins
    n_grid, grid_excess = 0, {}
    for dtype in ("float32", "bfloat16", "float16"):
        for T in FLASH_GRID_T:
            for D in FLASH_GRID_D:
                for causal in (False, True):
                    for with_dlse in (False, True):
                        q, k, v, do, dlse = flash_inputs(
                            (1, 2, T, D), getattr(torch, dtype), gen)
                        _, excess = check_flash(
                            FA, q, k, v, do, dlse if with_dlse else None,
                            causal, FLASH_TOL[dtype],
                            "grid T=%d D=%d %s causal=%s dlse=%s"
                            % (T, D, dtype, causal, with_dlse))
                        for name, x in (excess or {}).items():
                            key = "%s %s" % (dtype, name)
                            grid_excess[key] = max(grid_excess.get(key, 0.0),
                                                   x)
                        n_grid += 1
    log("flash grid: %d cases agree (T %s, D %s, causal and not, with and "
        "without dlse, fp32, bf16 and fp16); worst excess over the rounding "
        "plain version %s" % (n_grid, FLASH_GRID_T, FLASH_GRID_D,
                              grid_excess))

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
    # SDPA's backward computes dq, dk and dv in one call: the yardstick of
    # the dq + dk/dv pair, recorded on both rows
    lib_bwd = lib_fwd_bwd - lib_fwd
    timing = {}
    for name, (kind, kernel, plain) in runs.items():
        ms = time_ms(kernel)
        plain_ms = time_events_ms(plain)
        bnd, by, ops, nbytes = flash_bound_ms(kind, FLASH_SHAPE, True, 2,
                                              peaks["bf16_flops"],
                                              peaks["bytes_per_s"])
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                            bound_by=by, ops=ops, bytes=nbytes,
                            library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                            max_abs_err=path_err[name])
        if kind == "fwd":
            timing[name]["rounded_excess"] = {"o": path_excess["o"]}
        elif kind == "dq":
            timing[name]["rounded_excess"] = {"dq": path_excess["dq"]}
        elif kind == "dkv":
            timing[name]["rounded_excess"] = {
                g: path_excess[g] for g in ("dk", "dv")}
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
                            sdpa_fwd_ms=lib_fwd, sdpa_fwd_bwd_ms=lib_fwd_bwd,
                            sdpa_bwd_ms=lib_bwd, grid_cases=n_grid,
                            grid_rounded_excess=grid_excess)
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
    # the trained parameters, on the host, for the generation phase
    return launches, {k: v.detach().cpu() for k, v in params.items()}


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
            tile = F.tile_size(x.shape[0], x.shape[1], w.shape[2])
            row = dict(size=size, region=case["region"],
                       x=tuple(x.shape), w=tuple(w.shape),
                       w_transposed=not w.is_contiguous(), tile=tile,
                       max_abs_err=err, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=bnd, bound_by=by)
            results["bmm_cases"].append(row)
            log("bmm %s %s x%s w%s%s tile=%d err=%.3g ms=%.4f plain_ms=%.4f "
                "library_ms=%.4f bound_ms=%.4f (%s) %.2f TFLOP/s"
                % (size, case["region"], tuple(x.shape), tuple(w.shape),
                   " (transposed view)" if row["w_transposed"] else "", tile,
                   err, ms, plain, lib, bnd, by,
                   2.0 * x.numel() * w.shape[2] / ms / 1e9))
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
    # shapes whose grid takes the 128 x 128 tile, ragged M, N and K
    n_large = 0
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for B, M, N, K in BMM_LARGE_GRID:
            if F.tile_size(B, M, N) != 128:
                raise AssertionError("bmm large grid (%d, %d, %d) takes the "
                                     "%d tile" % (B, M, N,
                                                  F.tile_size(B, M, N)))
            for ep in BMM_GRID_EPILOGUES:
                for transposed in (False, True):
                    x = torch.randn(B, M, K, device="cuda",
                                    generator=gen).to(td)
                    w = torch.randn(B, N, K, device="cuda",
                                    generator=gen).to(td)
                    w = w.permute(0, 2, 1) if transposed else \
                        w.transpose(1, 2).contiguous()
                    ex = [torch.randn(B, M, N, device="cuda",
                                      generator=gen).to(td)
                          for s in ep if s[0] == "res"]
                    bmm_check(F, x, w, ex, ep, GRID_TOL[dtype],
                              "large grid B=%d M=%d N=%d K=%d %s %s %s"
                              % (B, M, N, K, ep, dtype, transposed))
                    n_large += 1
    log("bmm large-tile grid: %d cases agree (B, M, N, K in %s, %d "
        "epilogues, transposed and contiguous w, fp32 and bf16)"
        % (n_large, BMM_LARGE_GRID, len(BMM_GRID_EPILOGUES)))
    n += n_large
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
        # the one PyTorch call computing a softmax's backward, y * (g -
        # sum(g * y)), on the same y with x as the gradient: a yardstick
        row["bwd_library_ms"] = time_ms(lambda: torch._softmax_backward_data(
            xt, yt, 1, torch.float32))
        for kind in ("fwd", "bwd"):
            bnd, nbytes = softmax_bound_ms(rows, cols, kind, peaks[1])
            row[kind + "_bound_ms"] = bnd
            row[kind + "_bytes"] = nbytes
            row[kind + "_gb_per_s"] = nbytes / row[kind + "_ms"] / 1e6
        log("rtc softmax %s: fwd err %.3g (%.3g of max |y|; torch.softmax "
            "%.3g), bwd exact; fwd %.4f ms (plain %.4f, torch.softmax %.4f, "
            "bound %.4f, %.1f GB/s), bwd %.4f ms (plain %.4f, "
            "torch._softmax_backward_data %.4f, bound %.4f, %.1f GB/s), on "
            "%s"
            % (shape, fwd_err, fwd_err / scale, lib_err, row["fwd_ms"],
               row["fwd_plain_ms"], row["fwd_library_ms"],
               row["fwd_bound_ms"], row["fwd_gb_per_s"], row["bwd_ms"],
               row["bwd_plain_ms"], row["bwd_library_ms"],
               row["bwd_bound_ms"], row["bwd_gb_per_s"], card))
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


# ------------------------------------------------- ResNet-50 train phase

def resnet_train_data(seed=0):
    """bench.py's synthetic batch: uniform pixels, random labels."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (RN_BATCH,) + ROW).astype(np.float32)
    y = rng.randint(0, 1000, RN_BATCH).astype(np.float32)
    return x, y


def resnet_fit_step(mx, sym, arg0, aux0, it, losses):
    """A Module on the card, ``fit`` for one step from ``arg0`` / ``aux0``
    (host numpy) with bench.py's optimizer; ``losses`` gets the step's
    cross entropy."""
    import torch

    mod = mx.mod.Module(sym, context=mx.gpu())

    def on_batch(param):
        losses.append(batch_loss(param.locals["self"],
                                 param.locals["data_batch"]))

    it.reset()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": RN_LR,
                              "momentum": RN_MOMENTUM, "wd": RN_WD},
            kvstore="local", batch_end_callback=on_batch,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in arg0.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in aux0.items()},
            force_init=True)
    torch.cuda.synchronize()
    return mod


def batch_loss(mod, batch):
    """Mean cross entropy of the module's last outputs on ``batch``."""
    import torch

    p = mod.get_outputs()[0]._data
    lab = batch.label[0]._data.long()
    return -torch.log(p.gather(1, lab[:, None]).clamp_min(1e-12)).mean() \
        .item()


def host_params(arg, aux):
    """{"arg:name" / "aux:name": numpy}, the keys of a .params file."""
    out = {"arg:" + k: v.asnumpy() for k, v in arg.items()}
    out.update({"aux:" + k: v.asnumpy() for k, v in aux.items()})
    return out


def max_rel_err(got, want):
    """(worst error over its tensor's max |value|, that tensor's name, the
    number of tensors equal to the bit) of two {name: numpy} dicts."""
    worst, worst_name, identical = 0.0, None, 0
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        identical += int(err == 0.0)
        rel = err / max(float(np.abs(w).max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, k
    return worst, worst_name, identical


def kernel_family(name):
    n = name.lower()
    if "fused_matmul" in n:
        return "fused_matmul"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copies"
    if any(k in n for k in ("gemm", "xmma", "nvjet", "cutlass")):
        return "cuBLAS GEMM"
    return "elementwise / reduce"


def resnet_scope(name):
    """The family a ResNet step's op scope names, or None."""
    if "BatchNorm" in name:
        return "BN"
    if name == RN_SCOPES[1]:
        return "optimizer update"
    if "convolution" in name.lower():
        return "cuDNN conv"
    return None


def device_families(prof, n_steps, scope_family=resnet_scope,
                    marks=RN_SCOPES):
    """(device ms per step by family, device ms per step, the ten longest
    kernels, the GPU-side spans of the marked scopes), each per step. A
    kernel goes to the innermost scope of the op that launched it that
    names a family (``scope_family``; for a ResNet step BatchNorm forward
    and backward, the optimizer update, a convolution and its backward); a
    kernel with no such scope, or none the profiler could link (the ctypes
    launches), to its name's family. A marked scope's span (``marks``:
    first to last kernel on the card, gaps included) is not device time."""
    import torch

    def scope(ev):
        while ev is not None:
            fam = scope_family(ev.name)
            if fam is not None:
                return fam
            ev = ev.cpu_parent
        return None

    fams, linked, by_name, spans = {}, {}, {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in ev.kernels:
            fam = scope(ev) or kernel_family(k.name)
            fams[fam] = fams.get(fam, 0.0) + k.duration
            linked[k.name] = linked.get(k.name, 0.0) + k.duration
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if getattr(ev, "is_user_annotation", False) or ev.key in marks:
            spans[ev.key] = us
            continue
        by_name[ev.key] = by_name.get(ev.key, 0.0) + us
        rest = us - linked.get(ev.key, 0.0)
        if rest > 0:
            fam = kernel_family(ev.key)
            fams[fam] = fams.get(fam, 0.0) + rest
    total = sum(by_name.values())
    if not total:
        raise AssertionError("torch.profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    per = lambda d: {k: v / 1e3 / n_steps for k, v in d.items()}  # noqa: E731
    return (per(fams), total / 1e3 / n_steps,
            [(k, v / 1e3 / n_steps) for k, v in top], per(spans))


def profiled_steps(mx, mod, batch, losses):
    """RN_PROFILED steps under torch.profiler, the BatchNorm op and the
    update marked as scopes. Returns (families, device ms, top kernels,
    scope spans, wall ms) per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from mxnet_tpu_torch.ops.registry import get_op

    bn = get_op("BatchNorm")
    real = bn.fn

    def marked(*args, **kwargs):
        with record_function(RN_SCOPES[0]):
            return real(*args, **kwargs)

    bn.fn = marked
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(RN_PROFILED):
                mod.forward_backward(batch)
                with record_function(RN_SCOPES[1]):
                    mod.update()
                losses.append(batch_loss(mod, batch))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / RN_PROFILED
    finally:
        bn.fn = real
    return device_families(prof, RN_PROFILED) + (wall,)


def train_shape_phase(F, calls, peaks):
    """fused_matmul at each distinct shape of a training step's regions:
    held to its plain version, timed beside it and beside torch.addmm plus
    the residual add, with its bound. Returns (rows, per-step totals)."""
    import torch

    shapes = {}
    for c in calls:
        key = (c["M"], c["K"], c["N"], c["wt"], c["epilogue"])
        shapes[key] = shapes.get(key, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bound_ms": 0.0, "max_abs_err": 0.0}
    for (M, K, N, wt, ep), count in sorted(shapes.items(),
                                           key=lambda kv: -kv[0][0]):
        row = time_case(F, {"M": M, "K": K, "N": N, "wt": wt,
                            "epilogue": ep}, gen, peaks)
        row.update(launches_per_step=count,
                   tflops=2.0 * M * N * K / row["ms"] / 1e9)
        rows.append(row)
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[k] += count * row[k]
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
        log("resnet train kernel (%d, %d) x (%d, %d) + residual, %d per "
            "step, tile %d: err %.3g, ms %.4f (%.1f TFLOP/s), plain_ms %.4f,"
            " library_ms %.4f (torch.addmm + add), bound_ms %.4f (%s)"
            % (M, K, K, N, count, row["tile"], row["max_abs_err"],
               row["ms"], row["tflops"], row["plain_ms"], row["library_ms"],
               row["bound_ms"], row["bound_by"]))
    log("resnet train kernel per step: %d launches, ms %.4f, plain_ms %.4f, "
        "library_ms %.4f, bound_ms %.4f"
        % (len(calls), tot["ms"], tot["plain_ms"], tot["library_ms"],
           tot["bound_ms"]))
    return rows, tot


def handoff(mx, mod, sym, x, y, n_steps, card):
    """Checkpoint the trained module, load it back, serve it: the reloaded
    parameters equal the saved ones bit for bit, and the served
    probabilities and fc1 logits of RN_REQUESTS single-image requests
    agree with Module.predict on the trained parameters."""
    import tempfile

    saved = host_params(*mod.get_params())
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        prefix = os.path.join(tmp, "resnet50")
        mod.save_checkpoint(prefix, n_steps)
        lsym, larg, laux = mx.model.load_checkpoint(prefix, n_steps)
    loaded = host_params(larg, laux)
    if sorted(loaded) != sorted(saved) or any(
            loaded[k].dtype != v.dtype or loaded[k].shape != v.shape
            or loaded[k].tobytes() != v.tobytes()
            for k, v in saved.items()):
        raise AssertionError("the reloaded checkpoint differs from the "
                             "saved parameters")
    if lsym.tojson() != sym.tojson():
        raise AssertionError("the reloaded symbol differs")
    n = RN_REQUESTS
    it = mx.io.NDArrayIter(x, y, batch_size=RN_BATCH)
    probs_mod = mod.predict(it).asnumpy()[:n]
    served = mx.sym.Group([lsym, lsym.get_internals()["fc1_output"]])
    pmod = mx.mod.Module(served, context=mx.gpu())
    pmod.bind(data_shapes=[("data", (n,) + ROW)],
              label_shapes=[("softmax_label", (n,))], for_training=False)
    pmod.set_params(larg, laux)
    _probs, logits_pred = (o.asnumpy() for o in pmod.predict(
        mx.io.NDArrayIter(x[:n], y[:n], batch_size=n)))
    srv = mx.serving.InferenceServer(
        served, larg, laux, data_shapes=[("data", (1,) + ROW)],
        devices=[mx.gpu()], config=mx.serving.ServingConfig(buckets=BUCKETS))
    try:
        futs = [srv.submit(x[i]) for i in range(n)]
        answers = [f.result(timeout=600) for f in futs]
    finally:
        srv.stop()
    probs_srv = np.stack([p for p, _lg in answers])
    logits_srv = np.stack([lg for _p, lg in answers])
    if probs_srv.shape != (n, 1000) or logits_srv.shape != (n, 1000):
        raise AssertionError("served shapes %s %s" % (probs_srv.shape,
                                                      logits_srv.shape))
    logit_err = float(np.abs(logits_srv - logits_pred).max()
                      / np.abs(logits_pred).max())
    prob_err = float(np.abs(probs_srv - probs_mod).max())
    top1 = float((logits_srv.argmax(1) == probs_mod.argmax(1)).mean())
    distinct = len(set(logits_srv.argmax(1)))
    log("resnet hand-off: checkpoint of step %d reloaded bit for bit; %d "
        "served requests: logits within %.3g of max |logit| (%.4g) of "
        "Module.predict, probabilities within %.3g of the trained module's, "
        "top-1 agreement %.4f, %d distinct classes, on %s"
        % (n_steps, n, logit_err, np.abs(logits_pred).max(), prob_err, top1,
           distinct, card))
    log("resnet hand-off: served top-1 %s, labels %s"
        % (logits_srv.argmax(1).tolist(), y[:n].astype(int).tolist()))
    if not (np.isfinite(logits_srv).all() and np.isfinite(probs_srv).all()):
        raise AssertionError("non-finite served outputs")
    if logit_err > SERVE_TOL or prob_err > SERVE_TOL or top1 != 1.0 \
            or distinct < 2:
        raise AssertionError("served outputs of the reloaded checkpoint "
                             "disagree with Module.predict (or name one "
                             "class): logits %.3g, probabilities %.3g, top-1 "
                             "%.4f, %d classes"
                             % (logit_err, prob_err, top1, distinct))
    return dict(logit_err=logit_err, prob_err=prob_err, top1=top1,
                requests=n, distinct_classes=distinct,
                max_logit=float(np.abs(logits_pred).max()))


def resnet_train_phase(mx, sym, card, peaks, results):
    """ResNet-50 v2 NHWC fp32 trained with Module.fit on the card: the
    first step against MXNET_FUSION_KERNEL=0, launches per step, learning
    on one fixed batch, the step's time and profile, fused_matmul at the
    training shapes, and the checkpoint handed to InferenceServer. TF32
    is off (main), which the first step's parity needs."""
    import torch
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.parallel import fused as F

    out = {}
    x, y = resnet_train_data()
    it = mx.io.NDArrayIter(mx.nd.array(x, ctx=mx.gpu()),
                           mx.nd.array(y, ctx=mx.gpu()),
                           batch_size=RN_BATCH, label_name="softmax_label")
    # the initial parameters, as fit's initializer draws them
    init = mx.mod.Module(sym, context=mx.gpu())
    init.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    np.random.seed(0)
    init.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg0, aux0 = ({k: v.asnumpy() for k, v in d.items()}
                  for d in init.get_params())
    regions = init._exec_group.execs[0].fused_regions()
    del init
    if len(regions) != RN_REGIONS or any(
            r["base_op"] != "Convolution" or len(r["members"]) != 2
            for r in regions):
        raise AssertionError("training bind regions %s" % regions)
    log("resnet train: %d parameters (%d values), %d aux states; training "
        "bind carves %d regions, each a conv3 with its residual add"
        % (len(arg0), sum(v.size for v in arg0.values()), len(aux0),
           len(regions)))

    # (a) the first fit step with the kernel and with MXNET_FUSION_KERNEL=0,
    # both with cuDNN's deterministic algorithms; then the plain step once
    # more with cuDNN's default ones, whose backward is not deterministic:
    # the spread the comparison leaves out
    losses, plain_losses = [], []
    torch.backends.cudnn.deterministic = True
    try:
        cuda_build.reset_launch_counts()
        mod = resnet_fit_step(mx, sym, arg0, aux0, it, losses)
        first_launches = cuda_build.launch_counts().get("fused_matmul", 0)
        kern = host_params(*mod.get_params())
        mx.config.set_flag("MXNET_FUSION_KERNEL", 0)
        cuda_build.reset_launch_counts()
        plain = host_params(*resnet_fit_step(mx, sym, arg0, aux0, it,
                                             plain_losses).get_params())
        torch.backends.cudnn.deterministic = False
        default = host_params(*resnet_fit_step(mx, sym, arg0, aux0, it,
                                               []).get_params())
    finally:
        mx.config.set_flag("MXNET_FUSION_KERNEL", None)
        torch.backends.cudnn.deterministic = False
    if cuda_build.launch_counts().get("fused_matmul", 0):
        raise AssertionError("MXNET_FUSION_KERNEL=0 still launched the "
                             "kernel")
    if first_launches != RN_REGIONS:
        raise AssertionError("the first fit step launched fused_matmul %d "
                             "times, want %d" % (first_launches, RN_REGIONS))
    unmoved = [k for k in kern if k.startswith("arg:")
               and np.array_equal(kern[k], arg0[k[4:]])]
    if unmoved:
        raise AssertionError("%s did not move in the first step" % unmoved)
    worst, worst_name, identical = max_rel_err(kern, plain)
    spread = max_rel_err(default, plain)
    log("resnet train (a): first fit step with fused_matmul (%d launches) vs "
        "MXNET_FUSION_KERNEL=0, cuDNN deterministic: %d parameters and aux "
        "states, %d of them bit-identical, worst %s at %.3g of its max "
        "|value|; losses %.6f / %.6f. The plain step with cuDNN's default "
        "algorithms: %d bit-identical, worst %s at %.3g"
        % (first_launches, len(plain), identical, worst_name, worst,
           losses[0], plain_losses[0], spread[2], spread[1], spread[0]))
    if worst > MODULE_TOL:
        raise AssertionError("first ResNet-50 step with the kernel disagrees "
                             "with MXNET_FUSION_KERNEL=0: %s at %.3g > %.1g"
                             % (worst_name, worst, MODULE_TOL))
    out["first_step"] = dict(worst=worst, worst_name=worst_name,
                             identical=identical, tensors=len(plain),
                             loss=losses[0], plain_loss=plain_losses[0],
                             default_algorithms=dict(
                                 worst=spread[0], worst_name=spread[1],
                                 identical=spread[2]))

    # (b)-(d) the main path: the kernel module's next steps on the batch
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.gpu())],
                            label=[mx.nd.array(y, ctx=mx.gpu())])
    for _ in range(RN_WARM):
        mod.forward_backward(batch)
        mod.update()
        losses.append(batch_loss(mod, batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    step_ms = []
    for _ in range(RN_TIMED):
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(batch_loss(mod, batch))
    launches = cuda_build.launch_counts().get("fused_matmul", 0)
    peak = torch.cuda.max_memory_allocated()
    if launches != RN_REGIONS * RN_TIMED:
        raise AssertionError("fused_matmul launched %d times over %d steps, "
                             "want %d per step" % (launches, RN_TIMED,
                                                   RN_REGIONS))
    fams, device_ms, top, spans, prof_wall = profiled_steps(mx, mod, batch,
                                                            losses)
    n_steps = len(losses)
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("the loss on the fixed batch did not fall over "
                             "%d steps: %s" % (n_steps, losses))
    ms = float(np.median(step_ms))
    log("resnet train (b): %d fused_matmul launches over %d timed steps (%d "
        "per step)" % (launches, RN_TIMED, launches // RN_TIMED))
    log("resnet train (c): cross entropy on the fixed batch over N = %d "
        "steps: %s" % (n_steps, " ".join("%.4f" % v for v in losses)))
    log("resnet train (d): %.3f ms/step (median of %d fenced steps, "
        "min %.3f, max %.3f), %.1f img/s, peak memory %.3f GB; device %.3f "
        "ms/step (torch.profiler, %d steps), busy %.3f of the fenced step "
        "(%.3f of the profiled step's %.3f ms wall); GPU spans of %s; on %s"
        % (ms, RN_TIMED, min(step_ms), max(step_ms), RN_BATCH / ms * 1e3,
           peak / 1e9, device_ms, RN_PROFILED, device_ms / ms,
           device_ms / prof_wall, prof_wall,
           ", ".join("%s %.3f ms" % kv for kv in sorted(spans.items())),
           card))
    for fam, v in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("    %9.3f ms  %.3f  %s" % (v, v / device_ms, fam))
    for name, v in top:
        log("    %9.3f ms  %s" % (v, name[:110]))
    out.update(launches=launches, launches_per_step=launches // RN_TIMED,
               losses=losses, n_steps=n_steps, ms_per_step=ms,
               step_ms=step_ms, img_per_s=RN_BATCH / ms * 1e3,
               peak_bytes=peak, profiled_wall_ms=prof_wall,
               device_ms=device_ms, busy=device_ms / ms,
               busy_profiled=device_ms / prof_wall, families_ms=fams,
               top_kernels_ms=top, scope_spans_ms=spans)

    # (e) fused_matmul at the training shapes
    calls = record_region_calls(mx, sym, RN_BATCH, for_training=True)
    if len(calls) != RN_REGIONS:
        raise AssertionError("a training forward records %d kernel calls"
                             % len(calls))
    out["kernel_shapes"], out["kernel_per_step"] = train_shape_phase(
        F, calls, peaks)

    # (f) the moving statistics brought to the last weights (0.9^30 of
    # the stale ones left), then checkpoint, reload, serve
    for _ in range(RN_RECALIBRATE):
        mod.forward(batch, is_train=True)
    out["handoff"] = handoff(mx, mod, sym, x, y, n_steps, card)
    results["resnet_train"] = out
    return out

# ------------------------------------------- ShardedTrainer phase (bench)

def bench_data(batch):
    """bench.py:57-59's synthetic batch."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, (batch,) + ROW).astype(np.float32)
    y = rng.randint(0, 1000, batch).astype(np.float32)
    return {"data": x, "softmax_label": y}


def bench_trainer(mx, sym, schedule=False):
    """bench.py's ShardedTrainer on a one-card mesh; with ``schedule`` the
    learning rate decays per step."""
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh

    lr = (lambda step: RN_LR * TR_SCHEDULE_DECAY ** step) if schedule \
        else RN_LR
    return ShardedTrainer(
        sym, make_mesh({"dp": 1}), optimizer="sgd",
        optimizer_params={"learning_rate": lr, "momentum": RN_MOMENTUM,
                          "wd": RN_WD}, dtype="bfloat16")


def state_tensors(state):
    """{name: tensor} of a state's parameters, aux and optimizer state."""
    out = {"arg:" + k: v for k, v in state["params"].items()}
    out.update(("aux:" + k, v) for k, v in state["aux"].items())
    out.update(("opt:%s/%d" % (k, i), t)
               for k, v in state["opt"].items() for i, t in enumerate(v))
    return out


def clone_state(state):
    return {"params": {k: v.clone() for k, v in state["params"].items()},
            "aux": {k: v.clone() for k, v in state["aux"].items()},
            "opt": {k: tuple(t.clone() for t in v)
                    for k, v in state["opt"].items()},
            "step": state["step"]}


def identical_tensors(got, want):
    """(tensors equal to the bit, tensors, worst error over its tensor's
    max |value|, that tensor's name) of two states."""
    return compare_tensors(state_tensors(got), state_tensors(want))


def compare_tensors(got, want):
    """:func:`identical_tensors` of two {name: tensor} dicts."""
    if sorted(got) != sorted(want):
        raise AssertionError("the two states hold other tensors")
    same, worst, worst_name = 0, 0.0, None
    for k, w in want.items():
        if torch_equal(got[k], w):
            same += 1
            continue
        err = float((got[k].float() - w.float()).abs().max()
                    / w.float().abs().max().clamp_min(1e-30))
        if err > worst:
            worst, worst_name = err, k
    return same, len(want), worst, worst_name


def torch_equal(a, b):
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def cross_entropy(outs, label):
    import torch

    p = outs[0].float()
    return float(-torch.log(p.gather(1, label.long()[:, None])
                            .clamp_min(1e-12)).mean())


def graph_against_eager(trainer, state0, batch):
    """One replay and one eager step from ``state0``: (identical, tensors,
    worst, worst name) of the new states."""
    eager, _ = trainer._step_eager(clone_state(state0), batch)
    graph, _ = trainer.step(clone_state(state0), batch)
    return identical_tensors(graph, eager)


def profiled_trainer_steps(trainer, state, batch):
    """TR_PROFILED eager steps under torch.profiler with BatchNorm and the
    update marked, then TR_PROFILED replays: (families, device ms, top
    kernels, scope spans, eager wall ms) per step, and the replays'
    device ms and wall ms per step (device ms None where the profiler
    saw no kernel of the graph)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from mxnet_tpu_torch.ops.registry import get_op

    ops = {RN_SCOPES[0]: get_op("BatchNorm"), RN_SCOPES[1]: trainer._opt_opdef}
    real = {name: op.fn for name, op in ops.items()}

    def marked(name):
        def fn(*args, **kwargs):
            with record_function(name):
                return real[name](*args, **kwargs)
        return fn

    for name, op in ops.items():
        op.fn = marked(name)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TR_PROFILED):
                trainer._step_eager(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / TR_PROFILED
    finally:
        for name, op in ops.items():
            op.fn = real[name]
    eager = device_families(prof, TR_PROFILED) + (wall,)
    state, losses = trainer.multi_step(state, batch, 1)   # not profiled
    losses.cpu()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, losses = trainer.multi_step(state, batch, TR_PROFILED)
        losses.cpu()
        replay_wall = (time.perf_counter() - t0) * 1e3 / TR_PROFILED
    us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False):
            continue
        t = getattr(ev, "self_device_time_total", None)
        us += ev.self_cuda_time_total if t is None else t
    replay_ms = us / 1e3 / TR_PROFILED if us else None
    return eager, replay_ms, replay_wall


def bench_protocol(mx, sym, batch_size, n_iters, card, peaks, out):
    """bench.py's _bench_one through the port: a new trainer, init,
    multi_step once to capture and warm and once timed, ended by a fetch
    of the losses. Returns the img/s."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold is not the protocol's
    base = torch.cuda.memory_allocated()
    trainer = bench_trainer(mx, sym)
    data = bench_data(batch_size)
    state = trainer.init({k: v.shape for k, v in data.items()})
    batch = trainer.shard_batch(data)
    t0 = time.perf_counter()
    state, losses = trainer.multi_step(state, batch, n_iters)
    first = losses.cpu().numpy()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, losses = trainer.multi_step(state, batch, n_iters)
    timed = losses.cpu().numpy()
    dt = time.perf_counter() - t0
    if not (np.isfinite(first).all() and np.isfinite(timed).all()):
        raise AssertionError("non-finite losses in the bench protocol at "
                             "batch %d" % batch_size)
    if trainer._captures != 1:
        raise AssertionError("%d captures for one batch signature"
                             % trainer._captures)
    img_s = batch_size * n_iters / dt
    row = dict(batch=batch_size, n_iters=n_iters, img_per_s=img_s,
               replay_ms_per_step=dt * 1e3 / n_iters, timed_s=dt,
               capture_and_warm_s=first_s,
               peak_bytes=torch.cuda.max_memory_allocated() - base,
               held_before_bytes=base, losses_tail=timed[-3:].tolist())
    log("trainer (d): batch %d, %d steps: %.1f img/s, %.3f ms/step "
        "(replay, one fetch at the end), capture + warm run %.2f s, peak "
        "memory %.3f GB above the %.3f GB earlier phases hold, "
        "mean(outputs[0]) of the last steps %s, on %s"
        % (batch_size, n_iters, img_s, row["replay_ms_per_step"], first_s,
           row["peak_bytes"] / 1e9, base / 1e9, row["losses_tail"], card))
    if batch_size == BENCH_RUNS[0][0]:
        eager_ms = []
        for _ in range(TR_EAGER_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._step_eager(state, batch)
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        eager, replay_dev, replay_wall = profiled_trainer_steps(
            trainer, state, batch)
        fams, device_ms, top, spans, eager_wall = eager
        busy = device_ms / row["replay_ms_per_step"]
        row.update(eager_ms_per_step=float(np.median(eager_ms)),
                   eager_step_ms=eager_ms, families_ms=fams,
                   device_ms=device_ms, top_kernels_ms=top,
                   scope_spans_ms=spans, profiled_eager_wall_ms=eager_wall,
                   replay_device_ms=replay_dev,
                   profiled_replay_wall_ms=replay_wall, busy=busy,
                   busy_replay_profiled=(replay_dev / replay_wall
                                         if replay_dev else None),
                   mfu=img_s * BENCH_FLOPS_PER_IMG / peaks["bf16_flops"])
        log("trainer (d): batch %d eager step %.3f ms (median of %d fenced "
            "steps, min %.3f, max %.3f) against the replay's %.3f ms; "
            "device %.3f ms/step (torch.profiler over %d eager steps), busy "
            "%.3f of the replayed step; replays under the profiler: device "
            "%s ms/step, wall %.3f ms/step; mfu_bs32 %.4f (bf16 peak %.0f "
            "TFLOP/s); GPU spans of %s"
            % (batch_size, row["eager_ms_per_step"], TR_EAGER_TIMED,
               min(eager_ms), max(eager_ms), row["replay_ms_per_step"],
               device_ms, TR_PROFILED, busy,
               "%.3f" % replay_dev if replay_dev else "not measured",
               replay_wall, row["mfu"], peaks["bf16_flops"] / 1e12,
               ", ".join("%s %.3f ms" % kv for kv in sorted(spans.items()))))
        for fam, v in sorted(fams.items(), key=lambda kv: -kv[1]):
            log("    %9.3f ms  %.3f  %s" % (v, v / device_ms, fam))
        for name, v in top:
            log("    %9.3f ms  %s" % (v, name[:110]))
    out["bench_%d" % batch_size] = row
    return img_s


def trainer_phase(mx, sym, card, peaks, results):
    """bench.py's protocol through the port's ShardedTrainer: the captured
    step against the eager one, multi_step against step, learning, resume,
    then the protocol timed."""
    import tempfile

    import torch

    out = {}
    data = bench_data(RN_BATCH)
    shapes = {k: v.shape for k, v in data.items()}
    torch.backends.cudnn.deterministic = True
    try:
        trainer = bench_trainer(mx, sym, schedule=True)
        state0 = trainer.init(shapes)
        batch = trainer.shard_batch(data)
        label = batch["softmax_label"]
        n_params = sum(v.numel() for v in state0["params"].values())
        log("trainer: ResNet-50 NHWC bf16, %d parameters (%d values), %d "
            "aux states, batch %d, lr %.3g x %.2g^step"
            % (len(state0["params"]), n_params, len(state0["aux"]), RN_BATCH,
               RN_LR, TR_SCHEDULE_DECAY))
        # (a) one replay against one eager step
        same, total, worst, worst_name = graph_against_eager(trainer, state0,
                                                             batch)
        log("trainer (a): one captured replay vs one eager step, cuDNN "
            "deterministic: %d of %d tensors bit-identical (worst %s at "
            "%.3g)" % (same, total, worst_name, worst))
        if same != total:
            raise AssertionError("the captured step differs from the eager "
                                 "one: %d of %d identical, worst %s at %.3g"
                                 % (same, total, worst_name, worst))
        out["graph_vs_eager"] = dict(identical=same, tensors=total)

        # (b) multi_step(5) against five steps and five eager steps
        multi, losses = trainer.multi_step(clone_state(state0), batch,
                                           TR_MULTI)
        multi, losses = clone_state(multi), losses.cpu()
        stepped, eager, step_losses, eager_losses, ce = \
            clone_state(state0), clone_state(state0), [], [], []
        for _ in range(TR_MULTI):
            stepped, outs = trainer.step(stepped, batch)
            step_losses.append(outs[0].float().mean())
            ce.append(cross_entropy(outs, label))
            eager, eouts = trainer._step_eager(eager, batch)
            eager_losses.append(eouts[0].float().mean())
        step_losses = torch.stack(step_losses).cpu()
        eager_losses = torch.stack(eager_losses).cpu()
        checks = {"multi_step vs step": identical_tensors(multi, stepped),
                  "step vs eager": identical_tensors(stepped, eager)}
        log("trainer (b): multi_step(%d) losses %s; %d step calls %s; eager "
            "%s; states: %s; %d capture(s)"
            % (TR_MULTI, losses.tolist(), TR_MULTI, step_losses.tolist(),
               eager_losses.tolist(),
               "; ".join("%s %d of %d identical" % (k, v[0], v[1])
                         for k, v in checks.items()), trainer._captures))
        if not (torch.equal(losses, step_losses)
                and torch.equal(step_losses, eager_losses)):
            raise AssertionError("multi_step's losses differ from the steps'")
        for k, (same, total, worst, worst_name) in checks.items():
            if same != total:
                raise AssertionError("%s: %d of %d identical, worst %s at "
                                     "%.3g" % (k, same, total, worst_name,
                                               worst))
        if trainer._captures != 1:
            raise AssertionError("%d captures for one batch signature"
                                 % trainer._captures)
        out["multi_step"] = dict(losses=losses.tolist(),
                                 captures=trainer._captures)

        # (c) the loss falls on the fixed batch
        for _ in range(TR_LEARN - TR_MULTI):
            stepped, outs = trainer.step(stepped, batch)
            ce.append(cross_entropy(outs, label))
        log("trainer (c): cross entropy on the fixed batch over N = %d "
            "steps: %s" % (len(ce), " ".join("%.4f" % v for v in ce)))
        if not np.all(np.isfinite(ce)) or not ce[-1] < ce[0]:
            raise AssertionError("the loss did not fall over %d steps: %s"
                                 % (len(ce), ce))
        out["losses"] = ce

        # (e) resume: k steps, checkpoint, a new trainer, m more
        k, m = TR_RESUME
        whole, _ = trainer.multi_step(clone_state(state0), batch, k + m)
        whole = clone_state(whole)
        part, _ = trainer.multi_step(clone_state(state0), batch, k)
        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as tmp:
            prefix = os.path.join(tmp, "resnet50_bf16")
            trainer.save_checkpoint(part, prefix, k)
            del trainer
            resumed_trainer = bench_trainer(mx, sym, schedule=True)
            resumed = resumed_trainer.load_checkpoint(prefix, k)
        resumed, _ = resumed_trainer.multi_step(resumed, resumed_trainer
                                                .shard_batch(data), m)
        same, total, worst, worst_name = identical_tensors(resumed, whole)
        log("trainer (e): %d steps, checkpoint, a new trainer, %d more vs "
            "%d uninterrupted: %d of %d tensors bit-identical, step %d"
            % (k, m, k + m, same, total, resumed["step"]))
        if same != total or resumed["step"] != k + m:
            raise AssertionError("the resumed run differs: %d of %d, worst "
                                 "%s at %.3g" % (same, total, worst_name,
                                                 worst))
        out["resume"] = dict(identical=same, tensors=total)
        del resumed_trainer, resumed, whole, part, multi, stepped, eager

        # (a) once more under cuDNN's default algorithms: the spread
        torch.backends.cudnn.deterministic = False
        trainer = bench_trainer(mx, sym, schedule=True)
        same, total, worst, worst_name = graph_against_eager(trainer, state0,
                                                             batch)
        log("trainer (a): with cuDNN's default algorithms, %d of %d "
            "identical (worst %s at %.3g)" % (same, total, worst_name,
                                              worst))
        out["graph_vs_eager_default"] = dict(identical=same, tensors=total,
                                             worst=worst,
                                             worst_name=worst_name)
        del trainer, state0, batch
    finally:
        torch.backends.cudnn.deterministic = False

    # (d) the protocol, timed, with the default algorithms
    for batch_size, n_iters in BENCH_RUNS:
        bench_protocol(mx, sym, batch_size, n_iters, card, peaks, out)
    results["trainer"] = out
    return out


# ------------------------------------------------------- generation phase
# the causal LM at the bench_transformer_lm width served by the port's
# continuous-batching Generator; traffic as bench_all.py:614-733
# bench_generation_lm's at this width
GEN_MAX_SEQ = 2048          # the trained T
GEN_MAX_BATCH = 8           # MXNET_GEN_MAX_BATCH's default
GEN_PAGE = 16               # MXNET_GEN_PAGE_SIZE's default
GEN_BLOCKS = 128            # MXNET_GEN_DECODE_BLOCKS's default
GEN_PROMPTS = 8             # (a), (b): greedy prompts of 2 to 999 tokens
GEN_PROMPT_MAX = 1000
GEN_NEW = 32                # (a), (b): new tokens each
GEN_PREFILL_T = (16, 333, 2048)   # prefill lengths held to the plain path
GEN_LOGIT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GEN_REQUESTS = 48           # (d): bench_generation_lm's requests,
GEN_MAX_NEW = 64            # max_new_tokens,
GEN_OVERLOAD = 3.0          # arrivals at 3x the probed sequential capacity
GEN_PROBE = 4
GEN_STEP_CTX = 1000         # (d): context of the timed decode steps
GEN_TIMED = 20
GEN_PROFILED = 3
GEN_SPEC_K = 4              # (e)
GEN_SPEC_REQUESTS = 8
GEN_SPEC_NEW = 32
GEN_DRAFT_CFG = dict(vocab=32768, d_model=128, n_heads=2, n_layers=2,
                     d_ff=512, n_experts=1)
GEN_SCOPES = ("gen::paged_attention", "gen::sampling")


def gen_engine():
    import importlib

    return importlib.import_module(
        "mxnet_tpu_torch.serving.generation.engine")


def gen_config(mx, **kw):
    return mx.serving.generation.GenerationConfig(
        max_batch=GEN_MAX_BATCH, max_seq=GEN_MAX_SEQ, page_size=GEN_PAGE,
        decode_blocks=GEN_BLOCKS, **kw)


def gen_prompts(n, lo, hi, vocab, seed):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, vocab,
                                         size=int(rng.randint(lo, hi)))]
            for _ in range(n)]


class plain_prefill:
    """A scope in which ``prefill_forward`` attends with the plain dense
    formula (``prefill_attention_reference``) instead of the kernel."""

    def __enter__(self):
        import importlib

        self.TT = importlib.import_module(
            "mxnet_tpu_torch.parallel.transformer")
        self.real = self.TT._prefill_attention
        self.TT._prefill_attention = self.TT.prefill_attention_reference

    def __exit__(self, *exc):
        self.TT._prefill_attention = self.real


def serve_all(gen, requests):
    """Submit every (prompt, SamplingParams) at once; (outputs, wall s)."""
    t0 = time.perf_counter()
    handles = [gen.submit(p, sp) for p, sp in requests]
    out = [h.result(timeout=600) for h in handles]
    return out, time.perf_counter() - t0


def stopped(gen):
    """Drain ``gen`` and check that no page leaked."""
    gen.stop(drain=True)
    gen.pool.assert_no_leaks()
    return gen.get_stats()["captures"]


def admit_slots(gen, prompts, params):
    """Admit ``prompts`` into slots 0.. of a generator whose scheduler is
    not running, through its prefill (admission without the queue)."""
    E = gen_engine()
    for slot, prompt in enumerate(prompts):
        ent = E._Pending(prompt, params, E.GenerationHandle(),
                         time.monotonic(), E.resolve_class(None), None)
        with gen._cond:
            gen._n_active += 1
        gen._prefill(slot, ent, len(prompt) + params.max_new_tokens - 1)


def release_slots(gen):
    for slot, seq in enumerate(gen._slots):
        if seq is not None:
            gen._evict(slot)


def decode_graph_vs_eager(gen):
    """From one state, one eager run of the decode step's body and one
    replay of its graph: True when the tokens, the keys and every page but
    the trash page 0 (where inactive slots' writes collide) are equal to
    the bit. The state is the same after both."""
    import torch

    with gen._device_scope(), gen._pages_lock:
        pools = {k: v.clone() for k, v in gen._pools.items()}
        keys = gen._keys.clone()
        gen._upload()
        eager = gen._steps["decode"].body().clone()
        eager_pools = {k: v[:, 1:].clone() for k, v in gen._pools.items()}
        eager_keys = gen._keys.clone()
        for k, v in gen._pools.items():
            v.copy_(pools[k])
        gen._keys.copy_(keys)
        replay = gen._run("decode").clone()
        return (torch.equal(eager, replay)
                and torch.equal(eager_keys, gen._keys)
                and all(torch.equal(v[:, 1:], eager_pools[k])
                        for k, v in gen._pools.items()))


def prefill_vs_plain(model, params, dtype, what):
    """prefill_forward with the kernel against the plain path at
    GEN_PREFILL_T: rows of (T, error over max |logit|, kernel launches of
    the forward)."""
    import torch
    from mxnet_tpu_torch import cuda_build

    rng = np.random.RandomState(1)
    rows = []
    for T in GEN_PREFILL_T:
        tok = torch.from_numpy(rng.randint(0, TRAIN_CFG["vocab"], (1, T))) \
            .cuda()
        with torch.no_grad():
            cuda_build.reset_launch_counts()
            got, _, _ = model.prefill_forward(params, tok)
            torch.cuda.synchronize()
            launches = cuda_build.launch_counts().get("flash_attention_fwd",
                                                      0)
            with plain_prefill():
                want, _, _ = model.prefill_forward(params, tok)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        rows.append(dict(T=T, err=err, rel=err / scale, launches=launches))
        log("generation %s: prefill T=%d, logits with the kernel within "
            "%.3g of max |logit| (%.3f) of the plain path's, %d kernel "
            "launches" % (what, T, err / scale, scale, launches))
        if launches != TRAIN_CFG["n_layers"]:
            raise AssertionError("prefill at T=%d launched the flash forward "
                                 "%d times, want %d" % (T, launches,
                                                        TRAIN_CFG["n_layers"]))
        if not (torch.isfinite(got).all()
                and err <= GEN_LOGIT_TOL[dtype] * scale):
            raise AssertionError("%s prefill logits at T=%d: %.3g of max "
                                 "|logit| > %g" % (what, T, err / scale,
                                                   GEN_LOGIT_TOL[dtype]))
    return rows


def recompute_tokens(model, params, prompt, n):
    """The greedy full-recompute oracle: ``prefill_forward`` (the kernel)
    over the whole sequence for every token. Returns (tokens, each token's
    top-1 over top-2 logit margin)."""
    import torch

    toks, margins = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            logits, _, _ = model.prefill_forward(
                params, torch.tensor([toks], device="cuda"))
            top = torch.topk(logits[0, -1], 2)
            toks.append(int(top.indices[0]))
            margins.append(float(top.values[0] - top.values[1]))
    return toks[len(prompt):], margins


def gen_greedy_fp32(mx, card, out):
    """(a): fp32 at full width: prefill logits against the plain path, and
    8 prompts' greedy output against the full-recompute oracle, token for
    token. Returns (model, params) for (e)."""
    G = mx.serving.generation
    model = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                            dtype="float32", **TRAIN_CFG)
    params = model.init(0)
    out["prefill_fp32"] = prefill_vs_plain(model, params, "float32", "fp32")
    prompts = gen_prompts(GEN_PROMPTS, 2, GEN_PROMPT_MAX, TRAIN_CFG["vocab"],
                          2)
    sp = G.SamplingParams(max_new_tokens=GEN_NEW)
    gen = G.Generator(model, params, gen_config(mx))
    warmed = gen.warmup()
    if warmed != len(G.default_prefill_ladder(GEN_MAX_SEQ)) + 1 or \
            gen.get_stats()["captures"] != 1:
        raise AssertionError("warmup() gave %d programs and %d captures"
                             % (warmed, gen.get_stats()["captures"]))
    got, wall = serve_all(gen, [(p, sp) for p in prompts])
    stopped(gen)
    oracle = [recompute_tokens(model, params, p, GEN_NEW) for p in prompts]
    exact = sum(g == o[0] for g, o in zip(got, oracle))
    margin = min(min(o[1]) for o in oracle)
    log("generation (a): fp32, %d prompts of %s tokens, %d new each: %d of "
        "%d token-exact against the full-recompute oracle (smallest top-2 "
        "logit margin of the oracle %.3g), %d programs warmed, %.3f s, on %s"
        % (len(prompts), [len(p) for p in prompts], GEN_NEW, exact,
           len(prompts), margin, warmed, wall, card))
    out["greedy_fp32"] = dict(exact=exact, prompts=len(prompts),
                              min_margin=margin, warmed=warmed)
    if exact != len(prompts):
        bad = [(i, g, o[0]) for i, (g, o) in enumerate(zip(got, oracle))
               if g != o[0]]
        raise AssertionError("fp32 greedy output differs from the oracle: "
                             "%s" % bad[:2])
    return model, params


def gen_speculative(mx, model, params, card, out):
    """(e): n-gram (spec_k GEN_SPEC_K) and draft-model speculation against
    spec_k 0, greedy and seeded temperature, fp32 at full width."""
    G = mx.serving.generation
    rng = np.random.RandomState(5)
    reqs = []
    for i in range(GEN_SPEC_REQUESTS):
        pat = [int(t) for t in rng.randint(1, TRAIN_CFG["vocab"],
                                           size=int(rng.randint(2, 6)))]
        prompt = (pat * 200)[:int(rng.randint(40, 400))]
        sp = (G.SamplingParams(max_new_tokens=GEN_SPEC_NEW) if i % 2 else
              G.SamplingParams(max_new_tokens=GEN_SPEC_NEW, temperature=0.8,
                               top_k=50, seed=100 + i))
        reqs.append((prompt, sp))
    draft = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                            dtype="float32", **GEN_DRAFT_CFG)
    runs = {}
    for mode, kw, programs in (
            ("off", dict(spec_k=0), 1),
            ("ngram", dict(spec_k=GEN_SPEC_K), 2),
            ("draft", dict(spec_k=GEN_SPEC_K), 3)):
        extra = (dict(draft_model=draft, draft_params=draft.init(7))
                 if mode == "draft" else {})
        gen = G.Generator(model, params, gen_config(mx, **kw), **extra)
        warmed = gen.warmup()
        if warmed != 8 + programs or gen.get_stats()["captures"] != programs:
            raise AssertionError("%s: warmup() gave %d programs, %d "
                                 "captures" % (mode, warmed,
                                               gen.get_stats()["captures"]))
        got, wall = serve_all(gen, reqs)
        spec = gen.get_stats()["speculative"]
        captures = stopped(gen)
        if captures != programs:
            raise AssertionError("%s: %d captures after the traffic"
                                 % (mode, captures))
        tokens = sum(len(g) for g in got)
        runs[mode] = dict(tokens_per_s=tokens / wall, wall_s=wall,
                          accept_rate=spec["accept_rate"],
                          proposed=spec["proposed"],
                          accepted=spec["accepted"], warmed=warmed,
                          captures=captures, out=got)
        log("generation (e): spec %s, %d requests x %d new tokens: %.1f "
            "tokens/s (%.3f s), acceptance %s (%d of %d proposed), %d "
            "programs warmed, %d captures, on %s"
            % (mode, len(reqs), GEN_SPEC_NEW, tokens / wall, wall,
               spec["accept_rate"], spec["accepted"], spec["proposed"],
               warmed, captures, card))
        del gen
    for mode in ("ngram", "draft"):
        same = sum(a == b for a, b in zip(runs[mode]["out"],
                                          runs["off"]["out"]))
        runs[mode]["lossless"] = same
        if same != len(reqs):
            raise AssertionError("spec %s differs from spec_k 0 in %d of %d "
                                 "requests" % (mode, len(reqs) - same,
                                               len(reqs)))
    for r in runs.values():
        del r["out"]
    out["speculative"] = runs


def gen_prefill_timing(gen, card, out):
    """(d): the prefill of each bucket as the scheduler runs it (eager,
    onto the trash page, the first token fetched): wall ms (median of 5)
    and device ms (torch.profiler over one more)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rows = []
    with gen._device_scope(), gen._pages_lock:
        for bucket in gen._cfg.prefill_buckets:
            def prefill():
                tok, _ = gen._prefill_step(
                    np.zeros((1, bucket), np.int64), bucket,
                    np.zeros(gen._max_pages, np.int64), [0, 0], 0.0, 0)
                return tok.cpu()

            prefill()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                prefill()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                prefill()
            us = sum(getattr(ev, "self_device_time_total", 0.0)
                     for ev in prof.key_averages()
                     if ev.device_type == torch.autograd.DeviceType.CUDA)
            rows.append(dict(bucket=bucket, wall_ms=float(np.median(walls)),
                             device_ms=us / 1e3))
    log("generation (d): eager prefill per bucket, wall ms (device ms): %s; "
        "on %s" % (", ".join("%d: %.3f (%.3f)" % (r["bucket"], r["wall_ms"],
                                                 r["device_ms"])
                             for r in rows), card))
    out["prefill_ms"] = rows


def gen_step_timing(mx, gen, card, out):
    """(d): THE decode step of ``gen`` (warmed, its scheduler not started)
    at full batch and GEN_STEP_CTX context:
    replayed (with its input copy and token fetch, as the scheduler runs
    it) against eager, device time per replay from CUDA events, and the
    device ms per step by family over GEN_PROFILED eager steps (which
    launch the graph's kernels) under torch.profiler, paged attention and
    sampling marked as scopes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    E = gen_engine()
    G = mx.serving.generation
    prompts = gen_prompts(GEN_MAX_BATCH, GEN_STEP_CTX, GEN_STEP_CTX + 1,
                          TRAIN_CFG["vocab"], 7)
    with gen._device_scope():
        admit_slots(gen, prompts, G.SamplingParams(max_new_tokens=16))
        same = decode_graph_vs_eager(gen)
        step = gen._steps["decode"]

        def replay():
            with gen._pages_lock:
                return gen._run("decode").cpu()

        def eager():
            gen._upload()
            step.body()
            torch.cuda.synchronize()

        walls = {}
        for name, fn in (("replay", replay), ("eager", eager)):
            fn()
            ts = []
            for _ in range(GEN_TIMED):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            walls[name] = float(np.median(ts))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GEN_TIMED):
            step.graph.replay()
        end.record()
        end.synchronize()
        replay_dev = start.elapsed_time(end) / GEN_TIMED
        real = {"paged_decode_attention": E.paged_decode_attention,
                "sample_tokens": E.sample_tokens}

        def marked(scope, fn):
            def call(*args, **kwargs):
                with record_function(scope):
                    return fn(*args, **kwargs)
            return call

        E.paged_decode_attention = marked(GEN_SCOPES[0],
                                          real["paged_decode_attention"])
        E.sample_tokens = marked(GEN_SCOPES[1], real["sample_tokens"])
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(GEN_PROFILED):
                    eager()
        finally:
            E.paged_decode_attention = real["paged_decode_attention"]
            E.sample_tokens = real["sample_tokens"]
        release_slots(gen)
    fams, device_ms, top, _ = device_families(
        prof, GEN_PROFILED,
        scope_family=lambda n: ({GEN_SCOPES[0]: "paged attention",
                                 GEN_SCOPES[1]: "sampling"}.get(n)),
        marks=GEN_SCOPES)
    row = dict(graph_equals_eager=same, replay_ms=walls["replay"],
               eager_ms=walls["eager"], replay_device_ms=replay_dev,
               device_ms=device_ms, families_ms=fams,
               busy=device_ms / walls["replay"], top_kernels_ms=top,
               ctx=GEN_STEP_CTX, batch=GEN_MAX_BATCH)
    log("generation (d): decode step, %d slots at %d tokens of context: "
        "replayed %.3f ms (median of %d, input copy and token fetch "
        "included; graph alone %.3f ms between CUDA events), eager %.3f ms; "
        "device %.3f ms/step (torch.profiler over %d eager steps), busy "
        "%.3f of the replayed step; replay equals eager to the bit: %s; on "
        "%s" % (GEN_MAX_BATCH, GEN_STEP_CTX, walls["replay"], GEN_TIMED,
                replay_dev, walls["eager"], device_ms, GEN_PROFILED,
                row["busy"], same, card))
    for fam, v in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("    %9.3f ms  %.3f  %s" % (v, v / device_ms, fam))
    for name, v in top[:6]:
        log("    %9.3f ms  %s" % (v, name[:110]))
    if not same:
        raise AssertionError("the replayed decode step differs from the "
                             "eager one")
    out["decode_step"] = row


def gen_traffic(mx, model, path, card, out):
    """(c), (d): bench_generation_lm's protocol at full width in bf16 from
    the checkpoint: a warmed generator probes the sequential capacity, then
    Poisson arrivals at GEN_OVERLOAD x it through a continuous generator
    and through a sequential one (each request served to completion before
    the next is submitted). Returns the flash forward's launches in the
    continuous run."""
    import threading

    import torch
    from mxnet_tpu_torch import cuda_build

    G = mx.serving.generation
    rng = np.random.RandomState(0)
    requests = []
    for _ in range(GEN_REQUESTS):
        plen = int(rng.randint(2, GEN_MAX_SEQ - GEN_MAX_NEW))
        prompt = [int(t) for t in rng.randint(1, TRAIN_CFG["vocab"],
                                              size=plen)]
        requests.append((prompt, G.SamplingParams(
            max_new_tokens=GEN_MAX_NEW)))
    n_buckets = len(G.default_prefill_ladder(GEN_MAX_SEQ))

    def new_generator(start=True):
        gen = G.Generator.from_checkpoint(path, model, config=gen_config(mx),
                                          start=start)
        warmed = gen.warmup()
        captures = gen.get_stats()["captures"]
        if warmed != n_buckets + 1 or captures != 1:
            raise AssertionError("warmup() gave %d programs and %d captures, "
                                 "want %d and 1" % (warmed, captures,
                                                    n_buckets + 1))
        return gen

    gen = new_generator()
    t0 = time.perf_counter()
    for p, sp in requests[:GEN_PROBE]:
        gen.generate(p, sp, timeout=600)
    t_req = (time.perf_counter() - t0) / GEN_PROBE
    stopped(gen)
    gen = new_generator(start=False)
    gen_prefill_timing(gen, card, out)
    gen_step_timing(mx, gen, card, out)
    stopped(gen)
    del gen
    arrivals = np.cumsum(rng.exponential(t_req / GEN_OVERLOAD,
                                         GEN_REQUESTS))

    def consume(handle, arrival, start, res, idx):
        stream = handle.stream(timeout=600)
        first = next(stream, None)
        t_first = time.perf_counter() - start
        n = 1 if first is not None else 0
        for _ in stream:
            n += 1
        t_done = time.perf_counter() - start
        res[idx] = (t_first - arrival, (t_done - arrival) / max(1, n),
                    (t_done - t_first) / max(1, n - 1), n)

    def run(sequential):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen = new_generator()
        cuda_build.reset_launch_counts()
        res, threads = [None] * GEN_REQUESTS, []
        start = time.perf_counter()
        for i, (a, (p, sp)) in enumerate(zip(arrivals, requests)):
            now = time.perf_counter() - start
            if now < a:
                time.sleep(a - now)
            h = gen.submit(p, sp)
            if sequential:
                consume(h, a, start, res, i)
            else:
                t = threading.Thread(target=consume,
                                     args=(h, a, start, res, i))
                t.start()
                threads.append(t)
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - start - arrivals[0]
        launches = cuda_build.launch_counts().get("flash_attention_fwd", 0)
        stats = gen.get_stats()
        captures = stopped(gen)
        peak = torch.cuda.max_memory_allocated() - base
        del gen
        if any(r is None for r in res) or captures != 1:
            raise AssertionError("traffic: %d requests unanswered, %d "
                                 "captures" % (sum(r is None for r in res),
                                               captures))
        tokens = sum(r[3] for r in res)
        pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
        ttft = [r[0] * 1e3 for r in res]
        per_tok = [r[1] * 1e3 for r in res]
        itl = [r[2] * 1e3 for r in res]
        row = dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                   ttft_p50_ms=pct(ttft, 50), ttft_p99_ms=pct(ttft, 99),
                   per_token_p50_ms=pct(per_tok, 50),
                   per_token_p99_ms=pct(per_tok, 99),
                   inter_token_p50_ms=pct(itl, 50),
                   inter_token_p99_ms=pct(itl, 99),
                   decode_steps=stats.get("decode_steps", 0),
                   prefills=stats.get("prefills", 0), captures=captures,
                   flash_fwd_launches=launches,
                   launches_per_request=launches / GEN_REQUESTS,
                   peak_bytes=peak, held_before_bytes=base)
        log("generation (d): %s, %d requests (prompts 2-%d tokens, %d new), "
            "Poisson arrivals at %gx the probed sequential capacity (%.3f s "
            "a request): %.1f tokens/s over %.3f s; TTFT p50 %.2f p99 %.2f "
            "ms; inter-token p50 %.2f p99 %.2f ms; per-token p50 %.2f p99 "
            "%.2f ms; %d decode steps, %d prefills; flash forward launches "
            "%d (%.2f per request); %d capture; peak memory %.3f GB above "
            "the %.3f GB held before; on %s"
            % ("sequential" if sequential else "continuous", GEN_REQUESTS,
               GEN_MAX_SEQ - GEN_MAX_NEW - 1, GEN_MAX_NEW, GEN_OVERLOAD,
               t_req, row["tokens_per_s"], wall, row["ttft_p50_ms"],
               row["ttft_p99_ms"], row["inter_token_p50_ms"],
               row["inter_token_p99_ms"], row["per_token_p50_ms"],
               row["per_token_p99_ms"], row["decode_steps"],
               row["prefills"], launches, row["launches_per_request"],
               captures, peak / 1e9, base / 1e9, card))
        if launches != TRAIN_CFG["n_layers"] * GEN_REQUESTS:
            raise AssertionError("%d flash forward launches for %d "
                                 "requests, want %d each"
                                 % (launches, GEN_REQUESTS,
                                    TRAIN_CFG["n_layers"]))
        return row

    out["continuous"] = run(sequential=False)
    out["sequential"] = run(sequential=True)
    out["probe_s_per_request"] = t_req
    return out["continuous"]["flash_fwd_launches"]


def generation_phase(mx, card, trained, results):
    """Phase 11: the port's Generator at full width (see the module
    docstring). Returns the flash forward's launches on the main path,
    the continuous traffic of (d)."""
    import tempfile

    import torch

    G = mx.serving.generation
    out = {}
    model, params = gen_greedy_fp32(mx, card, out)
    gen_speculative(mx, model, params, card, out)
    del model, params
    torch.cuda.empty_cache()

    model = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                            dtype="bfloat16", **TRAIN_CFG)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "lm_bf16")
        model.save_checkpoint(trained, path)
        params = model.load_checkpoint(path)
        out["prefill_bf16"] = prefill_vs_plain(model, params, "bfloat16",
                                               "bf16")
        # (b) greedy tokens of the kernel's prefill against the plain one's
        prompts = gen_prompts(GEN_PROMPTS, 2, GEN_PROMPT_MAX,
                              TRAIN_CFG["vocab"], 2)
        sp = G.SamplingParams(max_new_tokens=GEN_NEW)
        outs = []
        for plain in (False, True):
            gen = G.Generator.from_checkpoint(path, model,
                                              config=gen_config(mx))
            if plain:
                with plain_prefill():
                    got, _ = serve_all(gen, [(p, sp) for p in prompts])
            else:
                got, _ = serve_all(gen, [(p, sp) for p in prompts])
            stopped(gen)
            outs.append(got)
        same_seq = sum(a == b for a, b in zip(*outs))
        same_tok = sum(x == y for a, b in zip(*outs) for x, y in zip(a, b))
        first = sum(a[0] == b[0] for a, b in zip(*outs))
        out["bf16_agreement"] = dict(sequences=same_seq, tokens=same_tok,
                                     first_tokens=first,
                                     of_sequences=len(prompts),
                                     of_tokens=len(prompts) * GEN_NEW)
        log("generation (b): bf16 from phase 5's trained parameters "
            "(save_checkpoint, Generator.from_checkpoint): greedy output "
            "with the kernel's prefill against the plain prefill's: %d of "
            "%d sequences equal, %d of %d tokens at equal positions, %d of "
            "%d first tokens (reported, not checked)"
            % (same_seq, len(prompts), same_tok, len(prompts) * GEN_NEW,
               first, len(prompts)))
        del params
        launches = gen_traffic(mx, model, path, card, out)
    results["generation"] = out
    return launches


# ------------------------------------------------------------ gluon phase
# bench_all.py:153-211 bench_gluon_resnet at its full (non-QUICK) size:
# hybridized resnet18_v1, NCHW fp32 224x224, batch 32, SGD 0.05,
# kvstore="local", Trainer.compile_step; 30 timed steps, 3 eager ones
GL_BATCH, GL_SIZE, GL_CLASSES, GL_LR, GL_LR2 = 32, 224, 1000, 0.05, 0.025
GL_TIMED, GL_EAGER_TIMED, GL_LEARN, GL_PROFILED = 30, 3, 12, 3
GL_FWD_TOL = 1e-5        # (b): hybridized vs imperative, over max |logit|
GL_STEP_TOL = 1e-5       # (d): eager tape vs compile_step, each tensor's max
# (h): examples/gluon/mnist_gluon.py --smoke on synthetic MNIST
GL_MNIST_ROWS, GL_MNIST_BATCH, GL_MNIST_EPOCHS, GL_MNIST_BAR = \
    2000, 100, 2, 0.8
GL_GRID_TOL = 1e-6       # (i): the card against the CPU, fp32
# (i): a tensor that sums many terms is held at GL_SUM_TOL instead: the
# card's tree sums and the CPU's take another order, ~sqrt(n) ulps of the
# sum. GL_SUMS names them by op: "out" (its forward outputs) and the
# positions of the inputs whose gradients are sums (a broadcast or
# gathered operand's, or one taken through a reduction or a softmax).
GL_SUM_TOL = 1e-5
GL_SUMS = {
    "sum": ("out",), "mean": ("out",), "nansum": ("out",),
    "prod": ("out", 0), "norm": ("out", 0),
    "log_softmax": ("out", 0), "SoftmaxActivation": ("out", 0),
    "softmax_cross_entropy": ("out", 0), "Deconvolution": ("out", 0, 1, 2),
    "broadcast_maximum": (1,), "broadcast_minimum": (1,),
    "broadcast_hypot": (1,), "broadcast_mod": (1,), "broadcast_power": (1,),
    "broadcast_to": (0,), "broadcast_axis": (0,), "take": (0,),
    "Embedding": (1,), "gather_nd": (0,),
    "LeakyReLU": (1,)}       # prelu's gamma
GL_REFERENCE_RUNS = 4    # (i): CPU runs of a case before it is a fault
GL_DROPOUT_UNITS = 65536  # (i): the captured Dropout's mask size
# (i): the positions of each op's index (integer-valued) inputs
GL_INDEX_INPUTS = {"one_hot": (0,), "Embedding": (0,), "where": (0,),
                   "take": (1,), "pick": (1,), "batch_take": (1,),
                   "gather_nd": (1,), "scatter_nd": (1,),
                   "softmax_cross_entropy": (1,)}


def gluon_resnet(mx):
    """(a): resnet18_v1 on the card, default init after mx.random.seed(0)
    (and np.random's: the initializers draw from it), hybridized later."""
    mx.random.seed(0)
    np.random.seed(0)
    net = mx.gluon.model_zoo.vision.resnet18_v1(classes=GL_CLASSES)
    net.initialize(ctx=mx.gpu())
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(GL_BATCH, 3, GL_SIZE, GL_SIZE)
                    .astype(np.float32), ctx=mx.gpu())
    y = mx.nd.array(rng.randint(0, GL_CLASSES, GL_BATCH).astype(np.float32),
                    ctx=mx.gpu())
    return net, x, y


def gl_snapshot(net, trainer):
    """({name: a copy} of every parameter, aux state and optimizer state,
    the optimizer's update counts: Adam's bias correction reads them)."""
    from mxnet_tpu_torch.optimizer import flat_state

    out = {"p:" + k: p.data()._data.detach().clone()
           for k, p in net.collect_params().items()}
    for i, st in trainer._updaters[0].states.items():
        for j, a in enumerate(flat_state(st)):
            out["s:%d:%d" % (i, j)] = a._data.detach().clone()
    o = trainer._optimizer
    return out, (dict(o._index_update_count), o.num_update)


def gl_restore(net, trainer, snap):
    import torch

    from mxnet_tpu_torch.optimizer import flat_state

    tensors, (counts, num_update) = snap
    with torch.no_grad():
        for k, p in net.collect_params().items():
            p.data()._data.copy_(tensors["p:" + k])
        for i, st in trainer._updaters[0].states.items():
            for j, a in enumerate(flat_state(st)):
                a._data.copy_(tensors["s:%d:%d" % (i, j)])
    trainer._optimizer._index_update_count = dict(counts)
    trainer._optimizer.num_update = num_update


def gl_replay_vs_body(step, net, trainer, x, y):
    """One compile_step call (a replay; the first captures) against the
    step's body run eagerly from the same state with the same scalars:
    (identical, tensors, worst, worst name, losses equal). Leaves the
    state as the replay left it."""
    import torch

    trainer._materialize_states(trainer._live_params())
    s0 = gl_snapshot(net, trainer)
    loss_g = step(x, y)._data.clone()
    graph = gl_snapshot(net, trainer)
    gl_restore(net, trainer, s0)
    loss_e, new_w, new_s, new_aux = step._step_eager(x, y, step._scalars)
    step._write_back(step._tensors(x.context), new_w, new_s, new_aux)
    # the counts as the replay's step advanced them
    trainer._optimizer._index_update_count = dict(graph[1][0])
    trainer._optimizer.num_update = graph[1][1]
    eager = gl_snapshot(net, trainer)
    torch.cuda.synchronize()
    return compare_tensors(graph[0], eager[0]) + (torch_equal(loss_g,
                                                              loss_e),)


def gl_eager_step(mx, net, trainer, loss_fn, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def gl_profiled_eager(mx, net, trainer, loss_fn, x, y):
    """GL_PROFILED eager-tape steps under torch.profiler with the
    BatchNorm op and the optimizer update marked as scopes: (families,
    device ms, top kernels, scope spans) per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from mxnet_tpu_torch.ops.registry import get_op

    bn = get_op("BatchNorm")
    real_bn, real_update = bn.fn, trainer._fused_local_step

    def marked_bn(*args, **kwargs):
        with record_function(RN_SCOPES[0]):
            return real_bn(*args, **kwargs)

    def marked_update():
        with record_function(RN_SCOPES[1]):
            return real_update()

    bn.fn = marked_bn
    trainer._fused_local_step = marked_update
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(GL_PROFILED):
                gl_eager_step(mx, net, trainer, loss_fn, x, y)
            torch.cuda.synchronize()
    finally:
        bn.fn = real_bn
        del trainer._fused_local_step
    return device_families(prof, GL_PROFILED)


def gl_profiled_replays(step, x, y):
    """Device ms per replayed step under torch.profiler (None where it
    saw no kernel of the graph) and the wall ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(GL_PROFILED):
            loss = step(x, y)
        loss.asnumpy()
        wall = (time.perf_counter() - t0) * 1e3 / GL_PROFILED
    us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False):
            continue
        t = getattr(ev, "self_device_time_total", None)
        us += ev.self_cuda_time_total if t is None else t
    return (us / 1e3 / GL_PROFILED if us else None), wall


def gl_mnist(mx, hybridize):
    """(h): examples/gluon/mnist_gluon.py's drive (--smoke) on the card:
    the 128-64-10 relu MLP on synthetic MNIST rows, SGD 0.1 / 0.9, 2
    epochs. Returns the final train accuracy."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn

    np.random.seed(42)
    mx.random.seed(42)
    mnist = mx.test_utils.get_mnist()
    n = GL_MNIST_ROWS
    x = mnist["train_data"][:n].reshape(n, -1)
    y = mnist["train_label"][:n]
    dataset = gluon.data.ArrayDataset(mx.nd.array(x), mx.nd.array(y))
    loader = gluon.data.DataLoader(dataset, batch_size=GL_MNIST_BATCH,
                                   shuffle=True)
    net = nn.Sequential()
    net.add(nn.Dense(128, activation="relu"),
            nn.Dense(64, activation="relu"), nn.Dense(10))
    net.initialize(mx.init.Xavier())
    if hybridize:
        net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    for _ in range(GL_MNIST_EPOCHS):
        metric.reset()
        for data, label in loader:
            if data.context != mx.gpu():
                raise AssertionError("a batch landed on %s" % data.context)
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(data.shape[0])
            metric.update([label], [out])
    return metric.get()[1]


def gl_grid_cases():
    """(i): (op, inputs [(kind, shape)], attrs, differentiate) over the
    op families this slice registers."""
    S = (64, 48)
    any_, pos = ("any", S), ("pos", S)
    cases = [(o, [any_], {}, True) for o in (
        "abs", "square", "cbrt", "exp", "expm1", "erf", "sin", "cos",
        "arctan", "sinh", "cosh", "tanh", "arcsinh", "negative",
        "degrees", "radians", "softsign", "sigmoid", "identity",
        "make_loss")]
    cases += [(o, [pos], {}, True) for o in (
        "sqrt", "rsqrt", "rcbrt", "log", "log10", "log2", "log1p", "gamma",
        "gammaln", "reciprocal")]
    cases += [(o, [("unit", S)], {}, True)
              for o in ("arcsin", "arccos", "arctanh", "tan")]
    cases += [(o, [("half", S)], {}, False) for o in (
        "sign", "round", "rint", "ceil", "floor", "trunc", "fix",
        "logical_not", "BlockGrad")]
    cases += [(o, [any_, pos], {}, True) for o in (
        "elemwise_div", "_maximum", "_minimum", "_hypot", "_mod")]
    cases += [("_power", [pos, any_], {}, True)]
    cases += [("_" + c, [("half", S), ("half", S)], {}, False)
              for c in ("equal", "greater", "lesser_equal")]
    cases += [(o, [any_], {"scalar": 0.7}, True) for o in (
        "_mod_scalar", "_rpower_scalar", "_maximum_scalar", "_hypot_scalar",
        "smooth_l1")]
    cases += [("_power_scalar", [pos], {"scalar": 2.5}, True),
              ("_greater_scalar", [("half", S)], {"scalar": 0.5}, False),
              ("add_n", [any_] * 3, {}, True)]
    B = [("any", (8, 16, 24)), ("pos", (1, 16, 1))]
    cases += [("broadcast_" + o, B, {}, True)
              for o in ("maximum", "minimum", "hypot", "mod", "power")]
    cases += [("broadcast_greater", [("half", (8, 16, 24)),
                                     ("half", (1, 16, 1))], {}, False)]
    R = [("any", (8, 16, 24))]
    for o in ("sum", "mean", "prod", "max", "min", "nansum", "norm"):
        for kw in ({}, {"axis": 1}, {"axis": (0, 2), "keepdims": True}):
            cases.append((o, R, kw, o != "prod" or "axis" in kw))
    cases += [("mean", R, {"axis": 1, "exclude": True}, True),
              ("argmax", R, {"axis": 1}, False),
              ("argmin", R, {}, False),
              ("broadcast_to", [("any", (8, 1, 24))], {"shape": (8, 16, 24)},
               True),
              ("broadcast_axis", [("any", (8, 1, 24))],
               {"axis": 1, "size": 16}, True),
              ("expand_dims", R, {"axis": 1}, True),
              ("swapaxes", R, {"dim1": 0, "dim2": 2}, True),
              ("slice", R, {"begin": (1, None, 20), "end": (7, 12, 2),
                            "step": (2, 1, -3)}, True),
              ("slice_axis", R, {"axis": 2, "begin": 3, "end": -2}, True),
              ("flip", R, {"axis": (0, 2)}, True),
              ("repeat", R, {"repeats": 2, "axis": 1}, True),
              ("tile", R, {"reps": (1, 2, 1)}, True),
              ("clip", R, {"a_min": -0.5, "a_max": 0.7}, True),
              ("concat", [("any", (8, 16, 24)), ("any", (8, 3, 24))],
               {"dim": 1}, True),
              ("split", R, {"num_outputs": 4, "axis": 1}, True),
              ("stack", [any_] * 2, {"axis": 1}, True),
              ("where", [("idx2", S), any_, any_], {}, True),
              ("sort", R, {"axis": 1, "is_ascend": False}, True),
              ("argsort", R, {}, False),
              ("topk", R, {"k": 3, "ret_typ": "both"}, True),
              ("_slice_assign", [("any", (16, 24)), ("any", (8, 12))],
               {"begin": (0, 0), "end": (16, 24), "step": (2, 2)}, True),
              ("take", [("any", (32, 24)), ("oob32", (8, 5))], {}, True),
              ("Embedding", [("oob1000", (8, 5)), ("any", (1000, 24))],
               {"input_dim": 1000, "output_dim": 24}, True),
              ("one_hot", [("oob10", (8, 5))], {"depth": 10}, False),
              ("pick", [("any", (8, 16, 24)), ("oob16", (8, 24))],
               {"axis": 1}, True),
              ("batch_take", [("any", (64, 48)), ("oob48", (64,))], {}, True),
              ("gather_nd", [("any", (8, 16, 24)), ("idx8", (2, 30))], {},
               True),
              # unique positions: a duplicate keeps either of its values
              ("scatter_nd", [("any", (30,)), ("nd8x16", (30,))],
               {"shape": (8, 16)}, True),
              ("LeakyReLU", [any_], {"act_type": "elu", "slope": 0.5}, True),
              ("LeakyReLU", [("any", (8, 16, 24)), ("pos", (16,))],
               {"act_type": "prelu"}, True),
              ("Deconvolution", [("any", (8, 16, 12, 12)),
                                 ("any", (16, 8, 3, 3)), ("any", (16,))],
               {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                "adj": (1, 1), "num_filter": 16, "num_group": 2,
                "no_bias": False}, True),
              ("log_softmax", [any_], {}, True),
              ("SoftmaxActivation", [("any", (8, 16, 24))],
               {"mode": "channel"}, True),
              ("pad", [("any", (2, 3, 16, 24))],
               {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)},
               True),
              ("softmax_cross_entropy", [any_, ("idx48", (64,))], {}, True)]
    return cases


def gl_grid_input(kind, shape, rng):
    if kind == "any":
        return rng.randn(*shape).astype(np.float32)
    if kind == "pos":
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if kind == "unit":
        return rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    if kind == "half":
        return (np.round(rng.randn(*shape) * 4) / 2).astype(np.float32)
    if kind.startswith("nd"):       # distinct (row, col) index pairs
        rows, cols = map(int, kind[2:].split("x"))
        flat = rng.permutation(rows * cols)[:shape[0]]
        return np.stack(np.unravel_index(flat, (rows, cols))) \
            .astype(np.float32)
    n = int(kind[3:])
    lo = 0 if kind.startswith("idx") else -n
    return rng.randint(lo, 2 * n if lo else n, shape).astype(np.float32)


def gl_grid_run(mx, op, arrays, attrs, grad, ctx):
    """(outputs, input gradients) of one op on ``ctx``, eager, under
    autograd with a seeded head (op(x) + x for an op without a
    gradient)."""
    fn = getattr(mx.nd._internal if op.startswith("_") else mx.nd, op)
    ins = [mx.nd.array(a, ctx=ctx) for a in arrays]
    floats = [i for i in range(len(ins))
              if i not in GL_INDEX_INPUTS.get(op, ())]
    for i in floats:
        ins[i].attach_grad()
    with mx.autograd.record():
        out = fn(*ins, **attrs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        if not grad and floats:
            outs = [o + ins[floats[0]] if o.shape == ins[floats[0]].shape
                    else o for o in outs]
    values = [o.asnumpy() for o in outs]
    diff = [o for o in outs if o._data.requires_grad]
    if not diff:
        return values, []
    rng = np.random.RandomState(7)
    heads = [mx.nd.array(np.asarray(rng.randn(*o.shape), np.float32),
                         ctx=ctx) for o in diff]
    mx.autograd.backward(diff, heads)
    return values, [ins[i].grad.asnumpy() for i in floats]


def gl_grid_tensors(op, arrays, got, want):
    """(what, held as a sum, card tensor, CPU tensor) of one case."""
    sums = GL_SUMS.get(op, ())
    floats = [i for i in range(len(arrays))
              if i not in GL_INDEX_INPUTS.get(op, ())]
    named = [("output %d" % i, "out" in sums, g, w)
             for i, (g, w) in enumerate(zip(got[0], want[0]))]
    named += [("gradient of input %d" % i, i in sums, g, w)
              for i, g, w in zip(floats, got[1], want[1])]
    return named


def cpu_math_info():
    """The CPU math path of this process: torch's CPU capability (the
    vector ISA its kernels dispatch to), its thread count and its parallel
    backends (OpenMP, MKL)."""
    import torch

    return {"cpu_capability": torch.backends.cpu.get_cpu_capability(),
            "threads": torch.get_num_threads(),
            "parallel_info": torch.__config__.parallel_info()}


_BARE_CPU_MATH = []


def bare_cpu_math_info():
    """:func:`cpu_math_info` of a fresh ``python`` that imports only
    torch, on this machine (run once)."""
    if not _BARE_CPU_MATH:
        code = ("import json, torch; print(json.dumps({'cpu_capability': "
                "torch.backends.cpu.get_cpu_capability(), 'threads': "
                "torch.get_num_threads(), 'parallel_info': "
                "torch.__config__.parallel_info()}))")
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True, timeout=120)
        _BARE_CPU_MATH.append(json.loads(out.stdout.splitlines()[-1]))
    return _BARE_CPU_MATH[0]


def gl_grid_reference(mx, op, arrays, attrs, grad):
    """(i): the CPU's (outputs, gradients) of one case, run until two runs
    agree to the bit, and the runs it took. On the H100 machine the CPU's
    torch.exp (MKL's, 3,072 values on two threads) gave one thread's half
    ~13 bits wrong in 4 of 38 runs of tests/test_torch_cuda.py, the card
    right (PERF.md section 7): a reference is what the CPU reproduces."""
    def same(a, b):
        return all(np.array_equal(x, y, equal_nan=np.issubdtype(
            x.dtype, np.floating)) for x, y in zip(a[0] + a[1], b[0] + b[1]))

    runs = [gl_grid_run(mx, op, arrays, attrs, grad, mx.cpu())]
    while len(runs) < GL_REFERENCE_RUNS:
        run = gl_grid_run(mx, op, arrays, attrs, grad, mx.cpu())
        if any(same(run, r) for r in runs):
            return run, len(runs) + 1
        log("gl grid: the CPU's run %d of %s %s differs from the earlier "
            "ones; this process's CPU math: %s; a bare process's: %s"
            % (len(runs) + 1, op, attrs, json.dumps(cpu_math_info()),
               json.dumps(bare_cpu_math_info())))
        runs.append(run)
    raise AssertionError("%s %s: the CPU gave %d different results in %d "
                         "runs" % (op, attrs, len(runs), len(runs)))


def gl_op_grid(mx):
    """(i): every case on the card against the same port op on the CPU:
    (cases, {"exact" / "summing": (worst error over its tensor's max
    |value|, where: the case, the tensor, its worst element's position
    and values, and how many elements are over the bar)}, [the cases
    whose CPU reference took more than two runs])."""
    worst = {"exact": (0.0, None), "summing": (0.0, None)}
    bars = {"exact": GL_GRID_TOL, "summing": GL_SUM_TOL}
    log("gl grid: this process's CPU math: %s; a bare process's: %s"
        % (json.dumps(cpu_math_info()), json.dumps(bare_cpu_math_info())))
    cases = gl_grid_cases()
    rerun = []
    for n, (op, inputs, attrs, grad) in enumerate(cases):
        rng = np.random.RandomState(n)
        arrays = [gl_grid_input(k, s, rng) for k, s in inputs]
        want, runs = gl_grid_reference(mx, op, arrays, attrs, grad)
        if runs > 2:
            rerun.append("%s %s" % (op, attrs))
        got = gl_grid_run(mx, op, arrays, attrs, grad, mx.gpu())
        for what, summing, g, w in gl_grid_tensors(op, arrays, got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError("%s %s %s: %s %s on the card, %s %s "
                                     "on the CPU" % (op, attrs, what,
                                                     g.shape, g.dtype,
                                                     w.shape, w.dtype))
            if not np.issubdtype(w.dtype, np.floating) or op in (
                    "argmax", "argmin", "argsort", "one_hot"):
                if not np.array_equal(g, w):
                    raise AssertionError("%s %s %s: integer outputs differ"
                                         % (op, attrs, what))
                continue
            nan = np.isnan(w)
            if not np.array_equal(nan, np.isnan(g)):
                raise AssertionError("%s %s %s: NaNs differ"
                                     % (op, attrs, what))
            kind = "summing" if summing else "exact"
            diff = np.where(nan, 0.0, np.abs(g - w))
            scale = max(float(np.abs(w[~nan]).max(initial=0.0)), 1e-30)
            err = float(diff.max(initial=0.0)) / scale
            if err > worst[kind][0]:
                at = np.unravel_index(int(np.argmax(diff)), diff.shape)
                worst[kind] = (err, "%s %s %s at %s: card %r, CPU %r, %d "
                               "element(s) over the bar" % (
                                   op, attrs, what, list(map(int, at)),
                                   float(g[at]), float(w[at]),
                                   int((diff > bars[kind] * scale).sum())))
    for kind, bar in bars.items():
        if worst[kind][0] > bar:
            raise AssertionError("op grid: %s differs from the CPU by %.3g "
                                 "of its max (bar %g)"
                                 % (worst[kind][1], worst[kind][0], bar))
    return len(cases), worst, rerun


def gl_captured_dropout(mx):
    """(i): a compile_step over Dropout(0.5) -> Dense(1) on ones: each
    replay's changed weights are the kept units. (keep rates, masks all
    different, captures)."""
    import torch

    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="drop_")
    with net.name_scope():
        net.add(nn.Dropout(0.5),
                nn.Dense(1, in_units=GL_DROPOUT_UNITS, use_bias=False))
    net.initialize(mx.init.One(), ctx=mx.gpu())
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1e-6}, kvstore="local")
    step = trainer.compile_step(net, mx.gluon.loss.L2Loss())
    x = mx.nd.ones((1, GL_DROPOUT_UNITS), ctx=mx.gpu())
    y = mx.nd.zeros((1, 1), ctx=mx.gpu())
    w = net.collect_params()["drop_dense0_weight"].data()._data
    masks = []
    for _ in range(4):
        before = w.clone()
        step(x, y)
        masks.append((w != before).reshape(-1))
    rates = [float(m.float().mean()) for m in masks]
    distinct = all(not torch.equal(a, b) for i, a in enumerate(masks)
                   for b in masks[i + 1:])
    se = np.sqrt(0.25 / GL_DROPOUT_UNITS)
    if not distinct or any(abs(r - 0.5) > 5 * se for r in rates) or \
            step.compile_count != 1:
        raise AssertionError("captured Dropout: keep rates %s (5 SE %.4f), "
                             "masks distinct %s, captures %d"
                             % (rates, 5 * se, distinct, step.compile_count))
    return rates, step.compile_count


def gluon_phase(mx, card, results):
    """Phase 12: Gluon on the card (see the module docstring)."""
    import torch

    out = {}
    gc.collect()      # what the earlier phases dropped is not theirs
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    net, x, y = gluon_resnet(mx)

    # (b) hybridized against imperative, predict mode
    imperative = net(x)._data.float()
    net.hybridize()
    hybrid = net(x)._data.float()
    n_params = sum(int(np.prod(p.shape))
                   for p in net.collect_params().values())
    err = float((hybrid - imperative).abs().max()
                / imperative.abs().max())
    log("gluon (a): resnet18_v1 (%d parameters, 1000 classes) NCHW fp32 "
        "%dx%d batch %d on %s" % (n_params, GL_SIZE, GL_SIZE, GL_BATCH,
                                  card))
    log("gluon (b): hybridized vs imperative logits (predict mode): %.3g of "
        "max |logit| %.4f" % (err, float(imperative.abs().max())))
    if not err <= GL_FWD_TOL:
        raise AssertionError("hybridized forward differs by %.3g" % err)
    out["forward_err"] = err
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": GL_LR}, kvstore="local")
    try:
        torch.backends.cudnn.deterministic = True
        # (c) one replay against its own body, eagerly, from one state
        step = trainer.compile_step(net, loss_fn)
        same, total, worst, name, loss_same = gl_replay_vs_body(
            step, net, trainer, x, y)
        log("gluon (c): deterministic cuDNN, compile_step replay vs its "
            "body run eagerly from the same state: %d of %d tensors "
            "bit-identical, loss %s" % (same, total,
                                        "equal" if loss_same else "differs"))
        if same != total or not loss_same:
            raise AssertionError("replay differs from its body: %s at %.3g"
                                 % (name, worst))
        out["replay_vs_body"] = dict(identical=same, tensors=total)
        # (d) the eager tape against compile_step from one state
        s0 = gl_snapshot(net, trainer)
        loss_c = step(x, y)._data.clone()
        compiled = gl_snapshot(net, trainer)
        gl_restore(net, trainer, s0)
        loss_t = gl_eager_step(mx, net, trainer, loss_fn, x,
                               y)._data.detach()
        tape = gl_snapshot(net, trainer)
        same, total, worst, name = compare_tensors(tape[0], compiled[0])
        loss_err = float((loss_t - loss_c).abs().max()
                         / loss_c.abs().max())
        log("gluon (d): eager tape (record / backward / step(%d)) vs "
            "compile_step from the same state: loss %.3g, worst tensor %s "
            "at %.3g of its max, %d of %d bit-identical"
            % (GL_BATCH, loss_err, name, worst, same, total))
        if not (loss_err <= GL_STEP_TOL and worst <= GL_STEP_TOL):
            raise AssertionError("eager tape and compile_step differ")
        out["tape_vs_compiled"] = dict(loss_err=loss_err, worst=worst,
                                       worst_name=name, identical=same,
                                       tensors=total)
        # (f) the loss on the fixed batch falls
        losses = [float(step(x, y).asnumpy().mean())
                  for _ in range(GL_LEARN)]
        log("gluon (f): cross entropy over %d compile_step steps: %s"
            % (GL_LEARN, " ".join("%.4f" % v for v in losses)))
        if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError("the loss did not fall: %s" % losses)
        out["losses"] = losses
        # (e) a new rate: no capture, the replay still its body's bits
        trainer.set_learning_rate(GL_LR2)
        same, total, worst, name, loss_same = gl_replay_vs_body(
            step, net, trainer, x, y)
        log("gluon (e): after set_learning_rate(%g): replay vs body %d of "
            "%d bit-identical, captures %d" % (GL_LR2, same, total,
                                               step.compile_count))
        if same != total or not loss_same or step.compile_count != 1:
            raise AssertionError("the rate change recaptured or changed "
                                 "the replay")
        out["lr_change"] = dict(identical=same, tensors=total,
                                captures=step.compile_count)
        del step
    finally:
        torch.backends.cudnn.deterministic = False

    # (g) timed with the default algorithms, as the bench
    trainer.set_learning_rate(GL_LR)
    step = trainer.compile_step(net, loss_fn)
    step(x, y).asnumpy()                       # capture + warm
    t0 = time.perf_counter()
    for _ in range(GL_TIMED):
        loss = step(x, y)
    loss.asnumpy()
    dt = time.perf_counter() - t0
    compiled_ips = GL_BATCH * GL_TIMED / dt
    if step.compile_count != 1:
        raise AssertionError("compile_step captured %d times"
                             % step.compile_count)
    trainer.set_learning_rate(GL_LR2)
    step(x, y).asnumpy()
    if step.compile_count != 1:
        raise AssertionError("set_learning_rate recaptured")
    trainer.set_learning_rate(GL_LR)
    replay_dev, replay_wall = gl_profiled_replays(step, x, y)
    gl_eager_step(mx, net, trainer, loss_fn, x, y).asnumpy()   # warm
    t0 = time.perf_counter()
    for _ in range(GL_EAGER_TIMED):
        loss_e = gl_eager_step(mx, net, trainer, loss_fn, x, y)
    loss_e.asnumpy()
    eager_dt = time.perf_counter() - t0
    eager_ips = GL_BATCH * GL_EAGER_TIMED / eager_dt
    fams, dev_ms, top, spans = gl_profiled_eager(mx, net, trainer, loss_fn,
                                                 x, y)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    ms = dt * 1e3 / GL_TIMED
    busy = replay_dev / replay_wall if replay_dev else None
    log("gluon (e): compile_count %d after the warm step, %d timed steps "
        "and set_learning_rate(%g)" % (step.compile_count, GL_TIMED, GL_LR2))
    log("gluon (g): compile_step %.1f img/s (%.3f ms/step over %d steps, "
        "one fetch), eager tape %.1f img/s (%.3f ms/step over %d), peak "
        "%.3f GB above the earlier phases, %s"
        % (compiled_ips, ms, GL_TIMED, eager_ips,
           eager_dt * 1e3 / GL_EAGER_TIMED, GL_EAGER_TIMED, peak, card))
    log("gluon (g): replay device %s ms/step (torch.profiler over %d "
        "replays, wall %.3f ms/step), busy %s of that wall; eager step "
        "device %.3f ms/step: %s; "
        "marked spans %s" % (
            "%.3f" % replay_dev if replay_dev else "not measured",
            GL_PROFILED, replay_wall,
            "%.3f" % busy if busy else "not measured", dev_ms,
            ", ".join("%s %.3f" % kv for kv in sorted(
                fams.items(), key=lambda kv: -kv[1])),
            ", ".join("%s %.3f" % kv for kv in spans.items())))
    out["timed"] = dict(
        compile_step_img_s=compiled_ips, compile_step_ms=ms,
        eager_img_s=eager_ips, eager_ms=eager_dt * 1e3 / GL_EAGER_TIMED,
        peak_gb=peak, replay_device_ms=replay_dev,
        replay_profiled_wall_ms=replay_wall, busy=busy,
        eager_device_ms=dev_ms, eager_families_ms=fams,
        eager_top_kernels_ms=top, eager_scope_spans_ms=spans,
        captures=step.compile_count, card=card)
    del step, trainer, net, x, y
    torch.cuda.empty_cache()

    # (h) the MNIST example's drive, imperative and hybridized
    accs = {}
    for hybridize in (False, True):
        accs["hybridized" if hybridize else "imperative"] = acc = \
            gl_mnist(mx, hybridize)
        if not acc > GL_MNIST_BAR:
            raise AssertionError("mnist_gluon drive: accuracy %.4f" % acc)
    log("gluon (h): mnist_gluon --smoke drive on the card: train accuracy "
        "%.4f imperative, %.4f hybridized" % (accs["imperative"],
                                              accs["hybridized"]))
    out["mnist"] = accs

    # (i) the op grid, card against CPU; Dropout in a captured step
    n_cases, worst, rerun = gl_op_grid(mx)
    rates, captures = gl_captured_dropout(mx)
    log("gluon (i): %d op cases on the card vs the CPU, forward and "
        "gradient: worst %.3g of its max (%s; bar %g), %.3g where a sum "
        "runs in another order (%s; bar %g); CPU references that took a "
        "third run: %s; captured Dropout keep rates %s over 4 replays, "
        "masks distinct, %d capture"
        % (n_cases, worst["exact"][0], worst["exact"][1], GL_GRID_TOL,
           worst["summing"][0], worst["summing"][1], GL_SUM_TOL,
           ", ".join(rerun) or "none",
           " ".join("%.4f" % r for r in rates), captures))
    out["op_grid"] = dict(cases=n_cases, worst=worst,
                          reference_reruns=rerun)
    out["dropout"] = dict(keep_rates=rates, captures=captures)
    results["gluon"] = out
    return out


# -------------------------------------------------------------- RNN phase
# (a): the CPU tests' grid of the fused RNN op at bench_lstm_ptb's width
RNN_MODES = ("rnn_tanh", "rnn_relu", "lstm", "gru")
RNN_T, RNN_N, RNN_H = 35, 32, 200
RNN_TOL = 1e-5           # the main path: cuDNN against rnn_reference
# (a): cuDNN's fp32 tanh (every mode at small H, rnn_tanh at H 200) is
# ~7e-6 of max off a float64 rnn_reference in one step, rnn_reference's
# ~1e-7 (measured on an H100, PERF.md section 6): over 35 steps and two
# layers rnn_tanh's outputs reach 3e-5. The grid holds cuDNN to
# rnn_reference at this bar, and reports both routes' error against the
# float64 referee.
RNN_CUDNN_TOL = 5e-5
RNN_TIME_REPS = 3        # calls per captured graph when timing (a)
# (b): bench_all.py:214-261 bench_lstm_ptb at its full (non-QUICK) size
PTB_BS, PTB_T, PTB_H, PTB_LAYERS, PTB_VOCAB, PTB_LR = \
    32, 35, 200, 2, 10000, 0.1
PTB_WARM, PTB_TIMED, PTB_PROFILED = 2, 60, 3
PTB_TOL = 1e-5           # first step, cuDNN against rnn_reference
# (c): examples/rnn/lstm_bucketing.py at its defaults (not --smoke)
BK_VOCAB, BK_HIDDEN, BK_EMBED, BK_BATCH, BK_EPOCHS, BK_BAR = \
    32, 64, 32, 16, 4, 10.0
BK_BUCKETS, BK_SENTENCES = (10, 20, 30), 400
# (d): a gluon.rnn.LSTM at the bench's width, eager tape
GLR_STEPS, GLR_LR = 6, 0.1
# (e): dropout between the layers of the bench's LSTM
RNN_DROP_P = 0.2
# (e): Queue C item 3, a captured Dropout MLP's step at this size
MIRROR_MLP_BATCH, MIRROR_MLP_WIDTH = 4096, 4096


def rnn_module():
    from mxnet_tpu_torch.ops import rnn

    return rnn


def rnn_case(mode, L, bi, gen):
    """Inputs (data, parameters, state, state_cell) that require grad and
    head gradients for (output, h, c), on the card."""
    import torch

    R = rnn_module()
    D = 2 if bi else 1
    dev = torch.device("cuda")

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).requires_grad_(True)

    ins = [rand(RNN_T, RNN_N, RNN_H),
           rand(R.rnn_param_size(L, RNN_H, RNN_H, mode, bi),
                scale=RNN_H ** -0.5),
           rand(L * D, RNN_N, RNN_H, scale=0.5),
           rand(L * D, RNN_N, RNN_H, scale=0.5) if mode == "lstm" else None]
    heads = [torch.randn((RNN_T, RNN_N, RNN_H * D), generator=gen,
                         device=dev)] + [
        torch.randn((L * D, RNN_N, RNN_H), generator=gen, device=dev)
        for _ in range(2 if mode == "lstm" else 1)]
    return ins, heads


def rnn_route(route, mode, L, bi, ins, heads=None, p=0.0, is_train=False):
    """(output, h[, c]) of one route, and with ``heads`` the gradients of
    every input after them."""
    import torch

    out, h, c = route(mode, *ins, num_layers=L, state_size=RNN_H,
                      bidirectional=bi, p=p, is_train=is_train)
    outs = [out, h] + ([c] if mode == "lstm" else [])
    if heads is None:
        return outs
    leaves = [t for t in ins if t is not None]
    return outs + list(torch.autograd.grad(outs, leaves, heads))


def rnn_worst(got, want, names):
    """(worst error over its tensor's max |value|, that tensor's name)."""
    worst, where = 0.0, None
    for n, g, w in zip(names, got, want):
        err = float((g.detach() - w.detach()).abs().max()
                    / w.detach().abs().max().clamp_min(1e-30))
        if err > worst:
            worst, where = err, n
    return worst, where


def rnn_op_grid(card):
    """(a): cuDNN against rnn_reference over the grid, outputs, states and
    every gradient, and both routes timed as CUDA-graph replays."""
    import torch

    R = rnn_module()
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for mode in RNN_MODES:
        for L in (1, 2):
            for bi in (False, True):
                ins, heads = rnn_case(mode, L, bi, gen)
                names = ["out", "h"] + (["c"] if mode == "lstm" else []) + [
                    "d" + n for n, t in zip(("data", "parameters", "state",
                                             "state_cell"), ins)
                    if t is not None]
                before = R.CUDNN_CALLS["rnn"]
                got = rnn_route(R.rnn_cudnn, mode, L, bi, ins, heads)
                if R.CUDNN_CALLS["rnn"] != before + 1:
                    raise AssertionError("rnn_cudnn made %d cuDNN calls"
                                         % (R.CUDNN_CALLS["rnn"] - before))
                want = rnn_route(R.rnn_reference, mode, L, bi, ins, heads)
                ins64 = [None if t is None else
                         t.detach().double().requires_grad_(True)
                         for t in ins]
                exact = rnn_route(R.rnn_reference, mode, L, bi, ins64,
                                  [h.double() for h in heads])
                err, where = rnn_worst(got, want, names)
                row = {"mode": mode, "layers": L, "bidirectional": bi,
                       "err": err, "worst": where,
                       "cudnn_vs_fp64": rnn_worst(got, exact, names)[0],
                       "plain_vs_fp64": rnn_worst(want, exact, names)[0]}
                if not (err <= RNN_CUDNN_TOL
                        and row["plain_vs_fp64"] <= RNN_TOL):
                    raise AssertionError("RNN grid %s: %s differs from "
                                         "rnn_reference by %.3g of its max"
                                         % (row, where, err))
                with torch.no_grad():
                    for name, route in (("cudnn", R.rnn_cudnn),
                                        ("plain", R.rnn_reference)):
                        row[name + "_fwd_ms"] = time_ms(
                            lambda route=route: rnn_route(
                                route, mode, L, bi, ins),
                            reps=RNN_TIME_REPS, replays=3)
                # cuDNN's RNN backward cannot be captured (it makes the
                # legacy stream wait on the capturing one): forward +
                # backward is timed between CUDA events, both routes
                for name, route in (("cudnn", R.rnn_cudnn),
                                    ("plain", R.rnn_reference)):
                    row[name + "_fwd_bwd_ms"] = time_events_ms(
                        lambda route=route: rnn_route(
                            route, mode, L, bi, ins, heads, is_train=True))
                rows.append(row)
                log("rnn (a): %s L%d %s: worst %.3g of max (%s), against "
                    "float64 cuDNN %.3g, plain %.3g; fwd cuDNN %.4f / plain "
                    "%.4f ms (CUDA-graph replays), fwd+bwd cuDNN %.4f / "
                    "plain %.4f ms (CUDA events), %s"
                    % (mode, L, "bi" if bi else "uni", err, where,
                       row["cudnn_vs_fp64"], row["plain_vs_fp64"],
                       row["cudnn_fwd_ms"], row["plain_fwd_ms"],
                       row["cudnn_fwd_bwd_ms"], row["plain_fwd_bwd_ms"],
                       card))
    return rows


def ptb_module(mx, dropout=0.0):
    """bench_lstm_ptb's graph and Module on the card, its parameters from
    np.random's seed 0 (the default initializer, as the bench's)."""
    stack = mx.rnn.FusedRNNCell(PTB_H, num_layers=PTB_LAYERS, mode="lstm",
                                dropout=dropout)
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data, input_dim=PTB_VOCAB, output_dim=PTB_H,
                             name="embed")
    outputs, _ = stack.unroll(PTB_T, inputs=embed, merge_outputs=True)
    pred = mx.sym.Reshape(outputs, shape=(-1, PTB_H))
    pred = mx.sym.FullyConnected(pred, num_hidden=PTB_VOCAB, name="pred")
    lab = mx.sym.Reshape(label, shape=(-1,))
    net = mx.sym.SoftmaxOutput(pred, lab, name="softmax")
    mod = mx.mod.Module(net, context=mx.gpu())
    mod.bind(data_shapes=[("data", (PTB_BS, PTB_T))],
             label_shapes=[("softmax_label", (PTB_BS, PTB_T))])
    np.random.seed(0)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", PTB_LR),))
    return mod


def ptb_batch(mx):
    """bench_lstm_ptb's batch: RandomState(0) tokens and labels."""
    rng = np.random.RandomState(0)
    return mx.io.DataBatch(
        data=[mx.nd.array(rng.randint(0, PTB_VOCAB, (PTB_BS, PTB_T))
                          .astype(np.float32))],
        label=[mx.nd.array(rng.randint(0, PTB_VOCAB, (PTB_BS, PTB_T))
                           .astype(np.float32))])


def ptb_loss(mod, batch):
    """The mean cross entropy of the last forward's softmax outputs."""
    import torch

    prob = mod.get_outputs()[0]._data
    label = batch.label[0]._data.reshape(-1).long()
    return float(-torch.log(prob[torch.arange(label.numel(),
                                              device=prob.device),
                                 label]).mean())


class plain_rnn_route:
    """Within it the RNN op on the card runs rnn_reference, not cuDNN."""

    def __enter__(self):
        R = rnn_module()
        self._real = R.rnn_cudnn
        R.rnn_cudnn = R.rnn_reference

    def __exit__(self, *exc):
        rnn_module().rnn_cudnn = self._real


def ptb_first_step(mod, batch):
    """(loss, {name: gradient}) of one forward_backward, no update."""
    mod.forward_backward(batch)
    grads = {k: v._data.clone() for k, v in
             mod._exec_group.execs[0].grad_dict.items() if v is not None}
    return ptb_loss(mod, batch), grads


def rnn_scope(names, kernel):
    """The family of a kernel from its name and its op chain (innermost
    first) in an RNN language model's step, or None."""
    k = kernel.lower()
    for n in names:
        low = n.lower()
        if "cudnn_rnn_backward" in low or "cudnnrnnbackward" in low:
            return "cuDNN RNN backward"
        if low == "aten::_cudnn_rnn":
            # the views' copy into cuDNN's packed weight buffer
            return ("weight repack" if "memcpy" in k or "copy" in k
                    or any("copy_" in m for m in names)
                    else "cuDNN RNN forward")
        if "slicebackward" in low:
            return "weight-gradient scatter"
        if "embedding" in low:
            return "Embedding"
        if n == RN_SCOPES[1]:
            return "update"
        if "softmax" in low:
            return "softmax"
        if low in ("aten::addmm", "aten::mm", "aten::linear") or \
                "mmbackward" in low:
            return "cuBLAS FC"
    return None


def rnn_families(prof, n_steps):
    """(device ms per step by family, device ms per step, the ten longest
    kernels per step, {family: its three longest kernels}) of a profiled
    RNN step."""
    import torch

    fams, by_name, linked, members = {}, {}, {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        chain, up = [], ev
        while up is not None:
            chain.append(up.name)
            up = up.cpu_parent
        for k in ev.kernels:
            fam = rnn_scope(chain, k.name) or kernel_family(k.name)
            fams[fam] = fams.get(fam, 0.0) + k.duration
            linked[k.name] = linked.get(k.name, 0.0) + k.duration
            kin = members.setdefault(fam, {})
            kin[k.name] = kin.get(k.name, 0.0) + k.duration
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False) or \
                ev.key in RN_SCOPES:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        by_name[ev.key] = by_name.get(ev.key, 0.0) + us
        rest = us - linked.get(ev.key, 0.0)
        if rest > 0:
            fam = kernel_family(ev.key)
            fams[fam] = fams.get(fam, 0.0) + rest
            kin = members.setdefault(fam, {})
            kin[ev.key] = kin.get(ev.key, 0.0) + rest
    total = sum(by_name.values())
    if not total:
        raise AssertionError("torch.profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    per = 1e3 * n_steps
    return ({k: v / per for k, v in fams.items()}, total / per,
            [(k, v / per) for k, v in top],
            {f: [(k, v / per) for k, v in sorted(
                kin.items(), key=lambda kv: -kv[1])[:3]]
             for f, kin in members.items()})


def repack_ms():
    """(b): the forward of the bench's LSTM stack (2 x 200, T 35, N 32)
    from views of a flat vector, as the op calls it, and from cuDNN's own
    packed buffer (torch.nn.LSTM's flattened weights, the same values),
    as CUDA-graph replays: (views ms, packed ms, worst output gap). The
    difference is the copy into the packed buffer on every call."""
    import torch

    R = rnn_module()
    gen = torch.Generator(device="cuda").manual_seed(5)
    flat = torch.randn(R.rnn_param_size(PTB_LAYERS, PTB_H, PTB_H, "lstm"),
                       generator=gen, device="cuda") * 0.05
    x = torch.randn((PTB_T, PTB_BS, PTB_H), generator=gen, device="cuda")
    hc = (torch.zeros((PTB_LAYERS, PTB_BS, PTB_H), device="cuda"),
          torch.zeros((PTB_LAYERS, PTB_BS, PTB_H), device="cuda"))
    views = [w for v in R._weight_views(flat, PTB_LAYERS, PTB_H, PTB_H,
                                         "lstm", False) for w in v]
    ref = torch.nn.LSTM(PTB_H, PTB_H, num_layers=PTB_LAYERS).cuda()
    with torch.no_grad():
        for dst, src in zip(ref._flat_weights, views):
            dst.copy_(src)
        ref.flatten_parameters()

        def run(weights):
            return torch._VF.lstm(x, hc, weights, True, PTB_LAYERS, 0.0,
                                  False, False, False)

        gap = rnn_worst(run(views), run(ref._flat_weights), "ohc")[0]
        return (time_ms(lambda: run(views), reps=10, replays=5),
                time_ms(lambda: run(ref._flat_weights), reps=10, replays=5),
                gap)


def ptb_phase(mx, card, out):
    """(b): bench_lstm_ptb's protocol on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    R = rnn_module()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mod = ptb_module(mx)
    batch = ptb_batch(mx)
    n_params = sum(int(np.prod(v.shape))
                   for v in mod.get_params()[0].values())
    regions = mod._exec_group.execs[0].fused_regions()
    log("rnn (b): bench_lstm_ptb: 2 x %d FusedRNNCell LSTM, T %d, batch "
        "%d, vocab %d, SGD %g, Module on %s; %d parameters; fuse regions: "
        "%s" % (PTB_H, PTB_T, PTB_BS, PTB_VOCAB, PTB_LR, card, n_params,
                regions or "none"))
    if regions:
        raise AssertionError("the fuse pass carved %s" % regions)
    before = R.CUDNN_CALLS["rnn"]
    loss, grads = ptb_first_step(mod, batch)
    calls = R.CUDNN_CALLS["rnn"] - before
    with plain_rnn_route():
        p_loss, p_grads = ptb_first_step(mod, batch)
    if R.CUDNN_CALLS["rnn"] != before + calls or calls != 1:
        raise AssertionError("cuDNN calls: %d in the step, %d in the plain "
                             "one" % (calls, R.CUDNN_CALLS["rnn"] - before
                                      - calls))
    loss_err = abs(loss - p_loss) / abs(p_loss)
    worst, where = rnn_worst([grads[k] for k in sorted(p_grads)],
                             [p_grads[k] for k in sorted(p_grads)],
                             sorted(p_grads))
    zero = [k for k, g in grads.items() if not bool(g.abs().max() > 0)]
    log("rnn (b): first step, cuDNN vs rnn_reference: loss %.6f vs %.6f "
        "(%.3g), worst gradient %.3g of its max (%s) over %d tensors"
        % (loss, p_loss, loss_err, worst, where, len(grads)))
    if not (loss_err <= PTB_TOL and worst <= PTB_TOL) or zero:
        raise AssertionError("bench_lstm_ptb's first step: loss %.3g, %s "
                             "%.3g, zero gradients %s"
                             % (loss_err, where, worst, zero))
    out["ptb_first_step"] = {"loss": loss, "plain_loss": p_loss,
                             "loss_err": loss_err, "grad_err": worst,
                             "worst": where, "cudnn_calls": calls}

    losses = []
    for _ in range(PTB_WARM):
        mod.forward_backward(batch)
        mod.update()
    mod.get_outputs()[0].asnumpy()
    t0 = time.perf_counter()
    for _ in range(PTB_TIMED):
        mod.forward_backward(batch)
        mod.update()
    mod.get_outputs()[0].asnumpy()
    dt = time.perf_counter() - t0
    losses.append(ptb_loss(mod, batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(PTB_PROFILED):
            mod.forward_backward(batch)
            with record_function(RN_SCOPES[1]):
                mod.update()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / PTB_PROFILED
    losses.append(ptb_loss(mod, batch))
    fams, dev_ms, top, members = rnn_families(prof, PTB_PROFILED)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    res = {"samples_per_s": PTB_BS * PTB_TIMED / dt,
           "ms_per_step": dt * 1e3 / PTB_TIMED,
           "device_ms": dev_ms, "profiled_wall_ms": wall,
           "busy": dev_ms / wall,
           "device_over_timed_step": dev_ms / (dt * 1e3 / PTB_TIMED),
           "families_ms": fams, "family_kernels": members, "top": top,
           "peak_gb": peak, "losses": losses}
    out["ptb"] = res
    log("rnn (b): %d timed steps: %.1f samples/s, %.3f ms/step (%s)"
        % (PTB_TIMED, res["samples_per_s"], res["ms_per_step"], card))
    log("rnn (b): %d profiled steps: device %.3f ms/step in %.3f ms of "
        "their wall (busy %.3f; %.3f of the unprofiled timed step); by "
        "family: %s" % (
            PTB_PROFILED, dev_ms, wall, res["busy"],
            res["device_over_timed_step"],
            ", ".join("%s %.3f" % kv for kv in
                      sorted(fams.items(), key=lambda kv: -kv[1]))))
    for fam, kernels in sorted(members.items()):
        for name, ms in kernels:
            log("rnn (b):   %s: %.3f ms  %s" % (fam, ms, name[:100]))
    log("rnn (b): peak memory %.3f GB above the earlier phases; losses "
        "%s" % (peak, ["%.4f" % v for v in losses]))
    views_ms, packed_ms, gap = repack_ms()
    res["lstm_fwd_views_ms"], res["lstm_fwd_packed_ms"] = views_ms, packed_ms
    res["repack_ms"] = views_ms - packed_ms
    log("rnn (b): the LSTM stack's forward from views of the flat vector "
        "%.4f ms, from cuDNN's packed buffer %.4f ms (CUDA-graph replays; "
        "outputs %.3g apart): the repack %.4f ms a call, %.3f of the "
        "step's device time" % (views_ms, packed_ms, gap, res["repack_ms"],
                                res["repack_ms"] / dev_ms))
    if not gap <= RNN_TOL:
        raise AssertionError("the LSTM from views and from cuDNN's packed "
                             "buffer differ by %.3g" % gap)
    if not all(np.isfinite(losses)):
        raise AssertionError("bench_lstm_ptb's loss is not finite: %s"
                             % losses)
    del mod


def bk_corpus(rng):
    """examples/rnn/lstm_bucketing.py's synthetic_corpus."""
    sents = []
    for _ in range(BK_SENTENCES):
        length = rng.randint(5, 30)
        start = rng.randint(1, BK_VOCAB)
        step = rng.randint(1, 4)
        sents.append([(start + i * step) % (BK_VOCAB - 1) + 1
                      for i in range(length)])
    return sents


def bucketing_drive(mx, card, out):
    """(c): lstm_bucketing.py's drive on the card, to its own bar."""
    import random

    np.random.seed(0)
    random.seed(0)
    train = mx.rnn.BucketSentenceIter(bk_corpus(np.random.RandomState(0)),
                                      BK_BATCH, buckets=list(BK_BUCKETS))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=BK_VOCAB,
                                 output_dim=BK_EMBED, name="embed")
        stack = mx.rnn.SequentialRNNCell()
        stack.add(mx.rnn.LSTMCell(num_hidden=BK_HIDDEN, prefix="lstm_l0_"))
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, BK_HIDDEN))
        pred = mx.sym.FullyConnected(pred, num_hidden=BK_VOCAB, name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, name="softmax",
                                    use_ignore=True, ignore_label=-1,
                                    normalization="valid")
        return pred, ("data",), ("softmax_label",)

    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=train.default_bucket_key,
                                 context=mx.gpu())
    metric = mx.metric.Perplexity(ignore_label=-1)
    t0 = time.perf_counter()
    mod.fit(train, num_epoch=BK_EPOCHS, eval_metric=metric,
            optimizer="adam", optimizer_params={"learning_rate": 0.01},
            initializer=mx.init.Xavier())
    fit_s = time.perf_counter() - t0
    train.reset()
    ppl = dict(mod.score(train, metric))["perplexity"]
    buckets = sorted(mod._buckets)
    on_card = all(v._data.is_cuda for v in
                  mod._curr_module._exec_group.execs[0].arg_dict.values())
    log("rnn (c): lstm_bucketing.py's drive on %s: %d epochs over buckets "
        "%s in %.1f s, train perplexity %.3f (bar %g), arrays on the card "
        "%s" % (card, BK_EPOCHS, buckets, fit_s, ppl, BK_BAR, on_card))
    if not (ppl < BK_BAR and buckets == list(BK_BUCKETS) and on_card):
        raise AssertionError("lstm_bucketing drive: perplexity %.3f, "
                             "buckets %s, on the card %s"
                             % (ppl, buckets, on_card))
    out["bucketing"] = {"perplexity": ppl, "buckets": buckets,
                        "fit_s": fit_s}


def gluon_lm(mx):
    """(d): gluon.rnn.LSTM (TNC) under a Dense head over the vocabulary,
    in one Sequential, initialised on the card from seed 0."""
    net = mx.gluon.nn.Sequential(prefix="glm_")
    with net.name_scope():
        net.add(mx.gluon.rnn.LSTM(PTB_H, num_layers=PTB_LAYERS,
                                  layout="TNC", input_size=PTB_H),
                mx.gluon.nn.Dense(PTB_VOCAB, flatten=False, in_units=PTB_H))
    mx.random.seed(0)
    np.random.seed(0)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu())
    return net


def gluon_lm_step(mx, net, loss_fn, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    return loss


def gluon_lstm_drive(mx, card, out):
    """(d): first-step gradients cuDNN vs rnn_reference, then the loss
    falls over GLR_STEPS eager-tape steps with gluon.Trainer."""
    R = rnn_module()
    net = gluon_lm(mx)
    params = net.collect_params()
    rng = np.random.RandomState(1)
    x = mx.nd.array(rng.randn(PTB_T, PTB_BS, PTB_H).astype(np.float32))
    y = mx.nd.array(rng.randint(0, PTB_VOCAB, (PTB_T, PTB_BS))
                    .astype(np.float32))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def grads():
        return {k: p.grad()._data.clone() for k, p in params.items()}

    before = R.CUDNN_CALLS["rnn"]
    gluon_lm_step(mx, net, loss_fn, x, y)
    got = grads()
    with plain_rnn_route():
        gluon_lm_step(mx, net, loss_fn, x, y)
    want = grads()
    worst, where = rnn_worst([got[k] for k in sorted(want)],
                             [want[k] for k in sorted(want)], sorted(want))
    log("rnn (d): gluon.rnn.LSTM 2 x %d TNC + Dense(%d) on %s, first "
        "step's %d gradients cuDNN vs rnn_reference: worst %.3g of its "
        "max (%s)" % (PTB_H, PTB_VOCAB, card, len(want), worst, where))
    if not worst <= PTB_TOL or R.CUDNN_CALLS["rnn"] != before + 1:
        raise AssertionError("gluon LSTM gradients: %s %.3g, cuDNN calls %d"
                             % (where, worst,
                                R.CUDNN_CALLS["rnn"] - before))
    trainer = mx.gluon.Trainer(params, "sgd",
                               {"learning_rate": GLR_LR}, kvstore="local")
    losses = []
    for _ in range(GLR_STEPS):
        loss = gluon_lm_step(mx, net, loss_fn, x, y)
        trainer.step(PTB_BS)
        losses.append(float(loss.mean().asnumpy()))
    log("rnn (d): %d eager-tape steps, loss %s" % (
        GLR_STEPS, ["%.4f" % v for v in losses]))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("gluon LSTM loss did not fall: %s" % losses)
    out["gluon_lstm"] = {"grad_err": worst, "worst": where,
                         "losses": losses}


def mirror_mlp_peaks(mx):
    """(e), Queue C item 3: peak memory (GB above what was allocated) of
    a Dropout MLP's ShardedTrainer step, eager and captured (the capture
    and its first replay), mirrored and not."""
    import torch
    from mxnet_tpu_torch.config import set_flag
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh

    rng = np.random.RandomState(0)
    data = {"data": rng.rand(MIRROR_MLP_BATCH, MIRROR_MLP_WIDTH).astype(
        np.float32),
        "softmax_label": (np.arange(MIRROR_MLP_BATCH) % 10).astype(
            np.float32)}
    peaks = {}
    for mirror in (0, 1):
        set_flag("MXNET_BACKWARD_DO_MIRROR", mirror)
        try:
            with mx.NameManager():
                h = mx.sym.var("data")
                for i in range(3):
                    h = mx.sym.Dropout(mx.sym.Activation(
                        mx.sym.FullyConnected(h, num_hidden=MIRROR_MLP_WIDTH,
                                              name="fc%d" % i),
                        act_type="relu"), p=0.5)
                sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
                    h, num_hidden=10, name="out"), name="softmax")
            trainer = ShardedTrainer(sym, make_mesh({"dp": 1}),
                                     optimizer="sgd",
                                     optimizer_params={"learning_rate": 0.1})
            state = trainer.init({k: v.shape for k, v in data.items()})
            batch = trainer.shard_batch(data)
            for kind in ("eager", "captured"):
                gc.collect()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                if kind == "eager":
                    trainer._step_eager(state, batch)
                else:
                    trainer.step(state, batch)
                torch.cuda.synchronize()
                peaks["%s_%s" % (kind, "mirrored" if mirror else "plain")] \
                    = (torch.cuda.max_memory_allocated() - base) / 1e9
        finally:
            set_flag("MXNET_BACKWARD_DO_MIRROR", None)
        del trainer, state, batch
    return peaks


def rnn_dropout_drive(mx, card, out):
    """(e): the between-layers mask's keep rate and kept units, a mirrored
    bench step equal to the unmirrored one to the bit, and the captured
    Dropout MLP's peak memory mirrored and not."""
    import torch
    from mxnet_tpu_torch.config import set_flag

    R = rnn_module()
    gen = torch.Generator(device="cuda").manual_seed(21)
    ins, _ = rnn_case("lstm", 2, False, gen)
    start = torch.cuda.get_rng_state()
    before = R.CUDNN_CALLS["rnn"]
    got = rnn_route(R.rnn_cudnn, "lstm", 2, False, ins, p=RNN_DROP_P,
                    is_train=True)
    calls = R.CUDNN_CALLS["rnn"] - before
    torch.cuda.set_rng_state(start)
    mask = torch.rand((RNN_T, RNN_N, RNN_H), device="cuda") < 1 - RNN_DROP_P
    torch.cuda.set_rng_state(start)
    want = rnn_route(R.rnn_reference, "lstm", 2, False, ins, p=RNN_DROP_P,
                     is_train=True)
    err, where = rnn_worst(got, want, ["out", "h", "c"])
    keep = float(mask.float().mean())
    se = float(np.sqrt(RNN_DROP_P * (1 - RNN_DROP_P) / mask.numel()))
    log("rnn (e): p %g between 2 layers on %s: keep rate %.5f (%.2f SE "
        "from %g), %d cuDNN calls, outputs vs rnn_reference with the same "
        "draws %.3g of max (%s)" % (RNN_DROP_P, card, keep,
                                    abs(keep - (1 - RNN_DROP_P)) / se,
                                    1 - RNN_DROP_P, calls, err, where))
    if abs(keep - (1 - RNN_DROP_P)) > 3 * se or calls != 2 or \
            not err <= RNN_TOL:
        raise AssertionError("RNN dropout: keep %.5f, calls %d, %s %.3g"
                             % (keep, calls, where, err))

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    steps = {}
    try:
        mod = ptb_module(mx, dropout=RNN_DROP_P)
        batch = ptb_batch(mx)
        for mirror in (0, 1, 0):
            set_flag("MXNET_BACKWARD_DO_MIRROR", mirror)
            try:
                mx.random.seed(7)
                steps.setdefault(mirror, []).append(
                    ptb_first_step(mod, batch))
            finally:
                set_flag("MXNET_BACKWARD_DO_MIRROR", None)
    finally:
        torch.backends.cudnn.deterministic = det
    (loss0, g0), (loss1, g1), (loss2, g2) = steps[0][0], steps[1][0], \
        steps[0][1]
    same = lambda a, b: all(torch.equal(a[k], b[k]) for k in a)  # noqa: E731
    log("rnn (e): the bench step with p %g under cuDNN's deterministic "
        "algorithms: mirrored vs unmirrored loss %.6f / %.6f, %d gradients "
        "equal to the bit: %s (two unmirrored runs: %s)"
        % (RNN_DROP_P, loss1, loss0, len(g0), same(g0, g1), same(g0, g2)))
    if not (loss0 == loss1 and same(g0, g1)):
        raise AssertionError("the mirrored RNN step differs from the "
                             "unmirrored one")
    # with cuDNN's default algorithms: do two runs give the same bits?
    mx.random.seed(7)
    _, d0 = ptb_first_step(mod, batch)
    mx.random.seed(7)
    _, d1 = ptb_first_step(mod, batch)
    default_gap = rnn_worst([d1[k] for k in sorted(d0)],
                            [d0[k] for k in sorted(d0)], sorted(d0))
    log("rnn (e): the same step twice with cuDNN's default algorithms: "
        "equal to the bit %s, worst %.3g of max (%s)"
        % (same(d0, d1), default_gap[0], default_gap[1]))
    del mod
    peaks = mirror_mlp_peaks(mx)
    log("rnn (e): Dropout MLP (3 x %d relu + Dropout 0.5, batch %d) step "
        "peak memory, GB: %s" % (MIRROR_MLP_WIDTH, MIRROR_MLP_BATCH,
                                  ", ".join("%s %.4f" % kv
                                            for kv in sorted(peaks.items()))))
    out["dropout"] = {"keep": keep, "se": se, "err": err,
                      "mirror_bit_identical": True,
                      "default_algorithms_gap": default_gap,
                      "mirror_mlp_peak_gb": peaks}


def rnn_phase(mx, card, results):
    """Phase 13: the RNN family on the card (see the module docstring)."""
    R = rnn_module()
    out = {}
    out["grid"] = rnn_op_grid(card)
    R.CUDNN_CALLS["rnn"] = 0
    ptb_phase(mx, card, out)
    out["ptb_cudnn_calls"] = R.CUDNN_CALLS["rnn"]
    bucketing_drive(mx, card, out)
    gluon_lstm_drive(mx, card, out)
    rnn_dropout_drive(mx, card, out)
    results["rnn"] = out
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
    flash_launches, trained = train_phase(mx, card, results, timing)
    bmm_err, bmm_totals = bmm_phase(peaks, results)
    bmm_launches = module_phase(mx, card, results)
    rtc = rtc_phase(mx, card, peaks, results)
    rn = resnet_train_phase(mx, sym, card, peaks, results)
    trainer_phase(mx, mx.models.get_resnet(num_classes=1000, num_layers=50,
                                           layout="NHWC"),
                  card, results["peaks"], results)
    gen_launches = generation_phase(mx, card, trained, results)
    gluon_phase(mx, card, results)
    rnn_phase(mx, card, results)

    t8 = totals[8]
    kernels = {"kernels": [{
        "name": "fused_matmul", "route": "cuda",
        "cores": "CUDA cores, fp32 FMA (register-tiled, 128 or 64 tiles)",
        "source": "mxnet_tpu_torch/csrc/fused_matmul.cu",
        "replaces": "mxnet_tpu/parallel/fused.py:168",
        "launches": launches, "max_abs_err": path_err,
        "ms": t8["ms"], "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
        "library_ms": t8["library_ms"],
        "train": dict(rn["kernel_per_step"], launches=rn["launches"],
                      launches_per_step=rn["launches_per_step"])}]}
    replaces = {"flash_attention_fwd": 106, "flash_attention_bwd_dq": 202,
                "flash_attention_bwd_dkv": 236}
    for name, line in replaces.items():
        t = timing[name]
        row = {
            "name": name, "route": "cuda",
            "cores": "tensor cores (wgmma) for bf16/fp16, the path's dtype; "
                     "CUDA cores for fp32",
            "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/parallel/flash_attention.py:%d" % line,
            "launches": flash_launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if "rounded_excess" in t:
            row["rounded_excess"] = t["rounded_excess"]
        if name == "flash_attention_fwd":
            # its second path: the generation prefill, phase 11 (d)
            row["generation"] = dict(
                launches=gen_launches, requests=GEN_REQUESTS,
                per_request=gen_launches / GEN_REQUESTS)
        row["library"] = ("SDPA forward" if name == "flash_attention_fwd"
                          else "SDPA backward (dq, dk and dv in one call)")
        kernels["kernels"].append(row)
    wide = bmm_totals["wide"]
    kernels["kernels"].append({
        "name": "fused_batch_matmul", "route": "cuda",
        "cores": "CUDA cores, fp32 FMA (register-tiled, 128 or 64 tiles)",
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
        "bwd_ms": wide_sm["bwd_ms"], "bwd_plain_ms": wide_sm["bwd_plain_ms"],
        "bwd_library_ms": wide_sm["bwd_library_ms"],
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

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
   by ``InferenceServer`` over buckets (1, 2, 4, 8), each bucket one CUDA
   graph: warmup (one capture per bucket), 16 single-image requests, one
   8-image batch, then back-to-back 8-image batches for throughput. Launch
   counts are reset just before and read just after: the wrapper counts
   where it is called, in each capture's body runs (the warm-up runs of
   ``cuda_graph.capture`` and the capture), so exactly 32 x (1 +
   WARMUP_RUNS) x captures; a replay launches the captured 32 without the
   wrapper, so the kernels that ran on the card are counted by
   torch.profiler over 4 further (single, batch) pairs: exactly 32 per
   replay (0 in the plain server below). The same requests through a server with
   MXNET_FUSION_KERNEL=0 (the plain composition on the card) must agree:
   logits within 1e-3 of max |logit|, top-1 1.0.
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
   rate). The two regions again with bf16 operands (the amp bind's): each
   one launch on the tensor-core route, held to the plain version at the
   bf16 bar and timed beside ``torch.bmm`` / ``baddbmm`` in bf16, bound at
   the bf16 tensor-core peak.
7. Module train phase: the attention block of ``bench_all.py``'s fusion
   bench (16 classes, fp32, ``mx.init.Uniform(0.05)``, SGD lr 0.01,
   ``kvstore="local"``) through ``mx.mod.Module`` on the card. The
   training bind carves exactly two ``batch_dot`` regions; the first
   ``forward_backward``'s outputs and all 10 parameter gradients with the
   kernels match ``MXNET_FUSION_KERNEL=0`` within 1e-5 of each one's own
   max |value| and are non-zero (but k_bias's, which the softmax makes
   0), and so do an MLP's (``fc1 + relu`` on ``fused_matmul``), and the
   same block bound under ``default,amp`` matches its plain composition
   within 2e-2, both of its launches on the tensor-core route. Then
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
   speculation) one CUDA graph, and each prompt bucket's prefill one CUDA
   graph through the flash forward.
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
   forward's launches (the prefill replays of the run times one body
   run's launches, counted at the capture: exactly 8 per request; the
   wrapper, reset just before, counts none), peak memory; each bucket's
   prefill graph replayed against its body run eagerly (wall ms, device
   ms, equal to the bit: token, key and the K/V it wrote, 8 flash forward
   launches a replay); the decode step at 8 slots and
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
14. Serving in full: phase 3's ResNet-50 (the same seed-0 weights and
   centred logits) behind ``InferenceServer`` with two replicas on the
   card, buckets (1, 2, 4, 8), every (replica, bucket) one CUDA graph in
   a pool per replica. (a) ``warmup()`` returns 8 and captures 8;
   after 200 requests of 1-12 rows (FIFO, the first 24 against the eager
   walk within 1e-4 of max |logit|) the captures stay 8 and no wrapper
   launch happens (replays only); peak memory above the phase's start.
   (b) Under cuDNN's deterministic algorithms, a new server: every
   (replica, bucket) replay equal to the bit to the eager walk
   (``_GraphProgram.infer_fn()`` called directly on the replica's
   parameters), and 16 different 8-row batches back to back under
   ``pipeline_depth`` 2 each equal to the bit to its eager walk. (c) Per
   bucket: p50/p99 single-request latency, device ms per request and the
   busy share under ``torch.profiler`` (which must see 32 fused_matmul
   kernels run per replayed request; the eager walk's wrapper must launch
   32 per request), each beside the eager walk's; img/s
   from 16 back-to-back 8-row batches, graphs against the walk. (d)
   ``serving.replica_execute[1]:raise@calls=1-2``: FIFO, results against
   the eager walk, quarantines and batch retries >= 1, then after the
   200 ms cooldown readmitted >= 1 and the breaker ``closed``. (e) 2 -> 1
   -> 3 replicas while a thread submits 60 requests: results and FIFO;
   captures 8 after the shrink, 16 after the regrow and ``warmup()`` (slot
   1 recaptured, slot 2 new) and after more traffic; the shrink frees one
   replica's parameters (``memory_allocated``). (f) ``get_stats()``
   validates against the shared schema; every ``serving.*`` series renders
   in ``dump_metrics()``; one sampled trace has the queue, batch, compute
   and fetch events.
15. SSD phase: ``bench_all.py:263-309`` ``bench_ssd300`` in full through
   the port's ``simple_bind`` on ``mx.gpu()``: SSD-300 (VGG16-reduced, 20
   classes, 8732 anchors), batch 8 at 300x300, fp32 with TF32 off,
   ``grad_req="write"``, parameters ``randn * 0.01`` and data from
   ``RandomState(0)``, label rows -1 but ``[0, .3, .3, .7, .7]``. (a) The
   bind's fuse report (regions carved; how many take the ``fused_matmul``
   kernel, counted by a forward of the training graph on ``meta`` tensors:
   none in NCHW), and the wrapper's launches over the phase's forwards
   equal to that count times the forwards; the first step's outputs finite
   and of their shapes, its gradients finite. (b) The first step's
   ``MultiBoxTarget`` and ``MultiBoxDetection`` again on the CPU from the
   card's own inputs: ``cls_target`` and the mask equal, ``loc_target``
   within 1e-6 of max(1, max |value|); detection ids and row order equal,
   scores and boxes within 1e-5. (c) 20 timed steps ended by the bench's
   fetch of ``outputs[0]``: img/s, ms/step, peak memory; 3 steps under
   ``torch.profiler`` with the three MultiBox ops and the greedy NMS under
   ``record_function`` scopes: device ms and kernels per step by family
   (cuDNN conv, elementwise, softmax, each MultiBox op, the NMS loop) and
   the busy share; then the same step bound with the fuse pass off
   (``MXNET_GRAPH_PASSES=default,-fuse``: no region recomputes its
   convolution in the backward) timed over 5 steps, its outputs within
   1e-4 of the fused step's. (d) ``tests/test_detection.py:162``'s toy SSD
   on the card (``tiny_features``, batch 8 at 32x32, 300 steps of SGD 0.01
   on clipped gradients over one fixed batch): the cls loss of the last 10
   steps under 0.9 of the first, at least 3 of 8 squares found at IoU >
   0.4 by the in-graph detector; then ``mode="inference"`` bound with
   ``grad_req="null"`` on the trained weights runs one detection forward.
   (e) 19 cases of the slice's other ops (ROIPooling, Proposal and
   MultiProposal, ROIAlign_v2, PSROIPooling, the deformable pair, the
   spatial ops, SVMOutput, and the MultiBox ops at the CPU tests' shapes)
   on the card against the CPU, forward and gradients within 1e-5 of each
   tensor's max; ids, masks and Proposal's rows (its scores, copied input
   values, and batch column) equal. No kernel of this package lies on the
   SSD path.
16. Model-zoo phase: ``bench_all.py:153-211`` ``bench_gluon_resnet``'s
   protocol (hybridized, NCHW fp32 with TF32 off, batch 32, 1000 classes,
   ``SoftmaxCrossEntropyLoss``, SGD 0.05, ``kvstore="local"``,
   ``Trainer.compile_step`` as one CUDA graph) with the network swapped for
   each family's headline member: ``alexnet``, ``vgg16``,
   ``squeezenet1_0``, ``mobilenet1_0``, ``densenet121`` at 224x224 and
   ``inception_v3`` at 299x299, Xavier init after ``mx.random.seed(0)``
   (the bench's default uniform init makes AlexNet diverge at SGD 0.05),
   SGD 0.01 for the two nets without BatchNorm (AlexNet, VGG16), which
   diverge at 0.05.
   (a) Per net: the parameter count equal to the JAX package's published
   one (``tests/test_gluon.py:350-360``); predict-mode logits hybridized
   against imperative (1e-5 of max |logit|); under cuDNN's deterministic
   algorithms the first ``compile_step`` step (a replay from the initial
   state) against the eager tape's first step within 1e-5 of each tensor's
   max, and a replay against its body run eagerly equal to the bit, both
   started from the same state of the card's generator, so the Dropout
   nets draw the same masks (torch's graph-safe Philox reads its seed and
   offset at each replay); the loss falling over 12 steps (the mean of the
   last three below the first three's); then with the
   default algorithms compile_step and eager-tape img/s, the replays'
   device ms and busy share, peak memory and the eager step's device ms by
   family (cuDNN conv, BN, pooling, the avg pools' pad copies, cuBLAS FC,
   concat, the update), mobilenet's depthwise route by kernel name; and
   ``fused_matmul``'s launches over the six nets: 0 (NCHW). (b) A CTC
   head: ``gluon.rnn.LSTM`` (2 x 256, TNC) under ``Dense(11)`` and
   ``CTCLoss`` with label lengths, T 80, batch 32, labels of length 4-8:
   the first batch's loss and input gradient on the card (the library's
   CTC) against the CPU's recursion on the card's own logits (1e-5), 10
   Adam steps on the eager tape with the loss falling (cuDNN's RNN
   backward cannot be captured), and the infeasible (about 1e30),
   zero-length and ``blank_label="last"`` cases against the CPU. (c) 49
   cases of the slice's ops on the card against the CPU, forward and
   gradients (1e-6 of each tensor's max, 1e-5 where the op sums in
   another order; ``syevd``'s eigenvector rows up to sign); Correlation
   at FlowNetC's setting (pad 20, kernel 1, displacement 20, strides 1 and
   2, (8, 256, 48, 64)) and SPN / SCN at (4, 32, 128, 128) in both scan
   directions: forward and forward + backward timed, their kernels
   counted, peak memory, sample 0 against the CPU. (d) ccSGD, DCASGD,
   Adamax, Nadam and Test: 5 ``trainer.step`` updates on the card against
   the CPU within 1e-6; SGLD's noise mean and variance on 2**20 weights.
   No kernel of this package lies on the zoo path.
17. Mixed precision and the generation control plane. (a) Phase 3's
   ResNet-50 (same weights, centred logits) served under
   ``MXNET_GRAPH_PASSES=default,amp``, buckets (1, 8), one replica: the
   fuse report (casts, regions, the 33 regions that take
   ``fused_matmul`` with bf16 operands: phase 3's 32 and fc1 with its cast
   to fp32). The random network amplifies bf16 rounding (on the CPU the
   JAX package's amp moves its logits as far as the port's:
   ``tools/port_amp_conditioning.py``), so on phase 3's weights the gaps
   of the logits to the fp32 server's and to ``MXNET_FUSION_KERNEL=0``'s
   are reported; with BatchNorm's statistics brought to the data (30
   training-mode forwards of 16 images) the probabilities are held to the
   fp32 server's at the JAX test's amp tolerance (rtol 5e-2, atol 2e-2),
   the same gaps reported, and the logits to the same graph's eager walk
   with ``fused_matmul``'s plain version in its place within 2e-2 of
   max(1, max |logit|), or within twice the gap between that plain version
   and the same in float64 (the network's own amplification of one bf16
   rounding) where that is wider; under cuDNN's deterministic algorithms each
   bucket's replay equal to its eager walk to the bit; p50 latency at
   buckets 1 and 8, img/s at 8, and the same protocol on the fp32 server;
   the launches as replays x the eager walk's 33 (the wrapper counts none
   outside the captures), every captured and eager launch of both
   buckets on the tensor-core route; ``fused_matmul`` in bf16 at each
   region's shape of one forward per bucket beside its plain version,
   ``torch.addmm`` in bf16 plus the epilogue and the bound (bf16
   tensor-core peak, memory rate), and every compiled tile of the route
   held to the default tile bit for bit and timed. (b) ``GenerationConfig(amp=True)`` over
   phase 11 (a)'s fp32 LM: bf16 parameters, the ``graph_pass`` stats flag
   and recent report, buckets + 1 captures, 8 flash forward launches (the
   wgmma kernel) per prefill replay and per request, first-token logits of
   a 333-token prompt within 2e-2 of max |logit| of the same bf16 weights
   through the plain attention; greedy agreement with the fp32 generator
   (reported) and tokens/s of both. (c) ``bench_all.py:946-1100``
   ``bench_control``'s protocol at phase 11's width in fp32: 48 requests
   (a 224-token head from ``RandomState(0)`` plus 1-8 tokens), 16 new
   tokens, 8 slots, max_seq 256, Poisson arrivals at 2x one request's
   sequential capacity; a cache-less pass, a seeding pass and a warm pass:
   TTFT p50 / p99, hits, prefill tokens skipped, pages shared; warm
   outputs token-identical to the cache-less generator's; the SLO
   overtake (every slot busy, two queued interactive requests admitted
   before two queued batch ones, which finish); captures buckets + 1; no
   leaked page after the drain. (d) Each bucket's prefill graph against
   its eager body (phase 11 (d)'s rows) and TTFT under phase 11 (d)'s
   traffic beside PR 9's eager prefill (13.18 / 104.54 ms). (e)
   ``generation.decode_step:raise@call=2`` fails the first request only;
   the next one is served; ``generation.*`` series in ``dump_metrics()``;
   one complete trace. (f) The autoscaler over ResNet-50 fp32 (one
   replica, buckets (1, 8), a fake clock): a 96-request burst scales 1 ->
   2 (warmup: 4 captures, buckets x replicas), a hot tick 5 s later is
   clamped at 2 and held by the cooldown, a quiet window scales 2 -> 1 (2
   live programs), a fault-killed replica with the TTFT objective burning
   scales 1 -> 2.
18. Quantize phase: ``bench_all.py --quantize``'s protocol
   (``bench_quantize``, bench_all.py:2299) in full, through the port. The
   integer contractions run on the exact float64 route
   (``ops/intmath.py``) and are profiled under a ``q::int_contraction``
   mark. (a) ResNet-50 NCHW at 224, 1000 classes, batch 16, Xavier from
   numpy's seed 0 with fc1_weight x 8, calibrated over 3 random batches:
   fp32 (``default``) against int8 (``default,quantize``) on identical
   weights, 50 timed ``Module.predict`` calls each, top-1 agreement over
   256 rows, the coverage (every conv / FC quantized, their int8 weights
   folded), device ms by family per predict and the aten ops the integer
   contractions ran; the random net's top-1 rides on small margins, so
   the bench's gate (>= 0.99) is reported and the agreement is held to the
   JAX package's on the same weights and table (0.9063 on the CPU,
   ``tools/port_quant_conditioning.py``) within 0.05. (b) Phase 3's NHWC
   ResNet-50 behind ``InferenceServer(quantize=table)``, buckets (1, 8),
   one replica, the table from ``calibrate`` under the default pipeline:
   coverage, int8 weights per replica, fuse regions (rooted at an int32
   contraction) and ``fused_matmul`` launches (0), replays equal to their
   eager walks to the bit, captures flat under traffic, logits against
   the fp32 server's (reported), p50 at buckets 1 and 8, img/s at 8, and
   each server's bucket-8 walk profiled by family. (c) The bench's decode
   LM (vocab 256, d 256, 4 heads, 4 layers, d_ff 256, 2 experts, fp32,
   init(0)): 24 greedy requests of 2 to 231 tokens, 24 new, 8 slots,
   max_seq 256, with ``kv_dtype`` model, bfloat16 and int8: tokens/s,
   bytes a token read and cached, token agreement with the model arm; the
   bench's gates hard: int8 / bf16 bytes <= 0.55, int8 agreement >= 0.9;
   buckets + 1 captures in each arm, the flash forward once per layer per
   prefill; for bf16 and int8 the decode step at 8 x 128 tokens replayed
   against eager (bit for bit), its busy share and the paged composition's
   device ms.
19. IO phase: data and IO through the port. (a) ``bench_all.py
   --input-pipeline``'s protocol (``bench_input_pipeline``,
   bench_all.py:2497-2689) in full: 512 random JPEGs at 224x224 (q90,
   label = record id) written by the port's ``recordio.pack_img``, batch
   32; iterator img/s of sync_serial (one decode thread, prefetch 2),
   sync_pooled and streaming (forkserver decode workers) over 3 timed
   epochs after a warm one, with the reader of each arm (the native
   ``recordio`` library, held) and the streaming arm's stage figures;
   the exactness guard (sync_pooled and streaming hand out the same
   batches, bit for bit); the bench's conv net fit from each backend
   (img/s, host stall = time in ``next()`` over the wall); hard gates:
   streaming >= 1.5x sync_serial, and streaming adds no CUDA graph
   capture and no kernel build over sync. (b) ResNet-50 NHWC composed
   onto ``transpose(data, axes=(0, 2, 3, 1))``, phase 9's init and SGD,
   fp32, batch 32, trained 2 epochs through ``Module.fit`` from those
   records by ``ImageRecordIter(streaming=True, rand_mirror=True)`` with
   ImageNet mean / std: 16 training regions, the first step from the
   first streamed batch against ``MXNET_FUSION_KERNEL=0`` under cuDNN's
   deterministic algorithms (1e-5), exactly 16 ``fused_matmul`` launches
   per step, finite losses, every parameter moved; ms/step (fenced),
   img/s, host stall, busy share over 3 profiled steps, and the same fit
   over the records decoded once onto the card (the reader's cost),
   beside phase 9's synthetic-batch figures. (c) 64 detection records at
   300x300 with 1-4 boxes (no ``.idx``: the native prefetcher reads them)
   through ``ImageDetRecordIter(rand_crop=1, rand_pad=1,
   rand_mirror=True)``, batch 8: padded labels in [0, 1]; 3 steps of
   phase 15's SSD-300 on them (finite losses, positive anchors from the
   real boxes). The native ``recordio`` and ``prefetch`` libraries must
   have been built and used.
20. Observability phase: the port's profiler, spans, instruments, roofline
   attribution, training health and exposition on the card, in the order
   (c), (d), (a), (b): the parts that hold torch.profiler's records to a
   count first. (a)
   ``bench_all.py --perf-overhead``'s protocol (:2804-2918): an MLP
   64-512-16 at batch 128 through ``Module``, 60 timed steps, 10
   witnessed steps (0 steady-state cost walks, one program note and one
   ``fused_matmul`` launch a step), then 5000 calls of the full per-step
   perf work (the scope, the executor's two CUDA events, the memo probe,
   the note, a data-wait and a kvstore note, the scope's end reading the
   events), best of 3: the gate is < 1% of the measured step. (b)
   ``--health-overhead``'s protocol (:1207-1290): the bf16
   ``TransformerParallel`` microbench (B 4, T 512, d_model 128, 4 layers,
   8 heads, vocab 2048; the three flash kernels, 4 launches each a step),
   warn against off on one parameter set, 24 pairs of 30-step blocks
   alternating (the bench takes the best of 3 blocks per arm in a row;
   the step's wall drifts between blocks), the median of the pairs'
   differences against the 2% gate, printed as held or NOT MET and not
   raised (on that host the reading spreads over about +-2 points around
   a cost near the gate); the ``health_stats`` kernel's launches (one a
   guarded step) and the kernels one guard puts on the card; the kernel
   held against its plain version on the microbench's tensors and, in
   (c), on ResNet-50's; then a NaN fed into one gradient: ``raise``
   raises on its step, ``warn`` names it one step later, ``skip_step``
   leaves every parameter (and optimizer state) bit-identical in
   ``Module.fit`` and in ``compile_step``. (c) The calibration
   (``autotune.cost_model.measure_ceilings``: 8192^3 ``torch.matmul`` in
   fp32 with TF32 off and in bf16, a 1 GiB copy) beside the table;
   ResNet-50 NHWC fp32 at batch 32 with phase 9's init and SGD: the first
   ``fit`` step with ``MXNET_PERF=1`` and ``MXNET_HEALTH=warn`` against
   both off, bit for bit under cuDNN's deterministic algorithms; 8 steps
   with both on: 16 ``fused_matmul`` and 1 ``health_stats`` launches a
   step, each step's
   waterfall (summing to its wall within 1 us), the program's FLOPs,
   bytes, MFU and HBM utilisation on both bases from its CUDA-event
   spans (within (0, 100)), the roofline table's top rows and fusion
   candidates; a profiler session over the last 2 steps whose dump holds
   the ``forward_backward`` and ``step`` spans and as many
   ``fused_matmul`` kernel records as the wrapper launched (32);
   ``instruments.device_peak_bytes()`` equal to
   ``torch.cuda.max_memory_allocated()``. (d) Phase 3's served ResNet-50
   (one replica) with telemetry and the exposition plane on an
   ephemeral port: 8 requests under a profiler session (8 traces in the
   ring, the replays' kernel records reported), ``/metrics`` parsed by
   ``promparse``, ``/statusz`` with its ``perf`` section and the engine
   row, ``/healthz``, ``/tracez``, and a ``FleetAggregator`` over this
   endpoint and a second process's (stopped afterwards).
21. The autotuner, ``bench_all.py --autotune``'s protocol (:1613-1961)
   on the port, in a cache file of its own: (a) every compiled tile of the
   fused matmul (128 and 64) at the served ResNet-50's 32 bucket-8
   regions, of the batched one at the attention block's scores and
   context (B 8, T 2048, D 512), of the flash forward, dq and dk/dv passes
   (64 and 128 rows a block) at (8, 8, 2048, 64) bf16 causal: each
   bit-identical to the default tile (the max difference printed) and
   held to its plain version, timed as CUDA-graph replays; (b)
   ``tune_flash_attention`` at B 1, H 8, T 4096, D 64 bf16 causal and the
   bench's train microbench at the default and the tuned rows; (c)
   ``tune_fused_matmul`` at the served ResNet-50's distinct 1x1 shapes,
   the tuned tile beside the default rule's; (c') the attention block's
   ``Module`` at the default tiles, then with ``fusion.blocks`` entries
   naming the other tile: the next bind launches it; (d)
   ``tune_serving_buckets`` on the bench's MLP with its 240 skewed
   requests (the head-to-head "kept default" rule); (e) ``tune_layout``
   on ResNet-50 (batch 16, 224 px, 8 ``Module`` steps a candidate) with
   the copy / transpose device ms and bytes per layout from
   ``torch.profiler``; (f) ``tune_remat`` on the gate MLP
   (64-512-512-16, batch 128) and the warm-cache gate: zero cache lookups
   over the steady-state steps and one warm lookup < 1% of a step
   (``MXNET_TUNE_GATE_PCT``), the A/B walls as information; (g)
   ``tune_generation``, ``tune_generation_spec`` and ``tune_control`` on
   phase 11's LM, ``tune_input_pipeline`` on phase 19's 512-JPEG record
   file; (h) ``--ingest-ledger``'s protocol over the samples (b)-(g)
   recorded. Every tuner's entries are resolved by a fresh object (the
   server, the Generator, the ``StreamingIter``, a bind, the wrappers);
   the launches of each tile on the tuning path ((b), (c), (c')) are the
   variant rows' ``launches``.
22. Resume phase: preemption-safe training on the card, under cuDNN's
   deterministic algorithms (this phase only; restored after). ResNet-50
   v2 NHWC fp32 at batch 32, phase 9's Xavier init and SGD 0.1 / 0.9 /
   1e-4, ``NDArrayIter`` with ``shuffle=True`` over 256 seeded 224 px
   images, 2 epochs of 8 steps. (a) The unbroken ``fit``; the same fit
   with ``fit(resume=dir)`` and SIGTERM from the 11th batch-end callback:
   ``PreemptedError``, and ``load_latest`` gives (epoch, batch, step) =
   (1, 3, 11); the resume in the same process ends on the unbroken run's
   parameters and aux states bit for bit. Every run launches
   ``fused_matmul`` exactly 16 times a step. (b) The kill -TERM drill: a
   child process trains the same program and gets SIGTERM once its marker
   file reads step 5, exits with ``PreemptedError``; a second child
   resumes to the end, bit for bit (a)'s unbroken parameters, 16 launches
   a step in each. (c) On the checkpoint the card wrote: a corrupt
   manifest, a tampered ``params.ndarray`` and a ``checkpoint.write``
   fault each fall back to the checkpoint before; ``save_resumable`` and
   ``load_latest`` timed (ms) with the checkpoint's bytes. (d) The Module
   family on the card: a ``SequentialModule`` (an NHWC conv feature
   module, an FC + relu on ``fused_matmul``, the loss head), the same
   chain ending in a ``PythonLossModule``, and ``FeedForward(ctx=None)``
   fit and predict (its parameters on ``cuda``), each 4 steps against
   ``MXNET_FUSION_KERNEL=0`` within 1e-5 of each tensor's max |value|,
   one launch a step.
23. Print the ``kernels`` JSON line (the flash forward's row also carries
   phase 11's prefill launches, phase 17's and phase 18's int8 Generator's,
   ``fused_matmul``'s phase 3's captures, replays, and the profiled
   replays with the kernels the profiler saw run in them, phase 17
   (a)'s bf16 figures, phase 19 (b)'s and phase 22's launches; the
   ``health_stats`` row phase 20's), then the result line ``{"ok": true,
   "device": {...}}`` last.

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
SERVE_PROFILED = 4        # served (single, batch) pairs under torch.profiler

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
# the amp bind's first step (bf16 operands) against its plain composition:
# the bf16 bar
AMP_MODULE_TOL = 2e-2
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


def phase_peaks(card=None):
    """``results["peaks"]`` for the card (``nvidia_smi()``'s line): fp32
    CUDA-core and bf16 tensor-core FLOP/s and the memory rate."""
    name = (card or nvidia_smi()).split(",")[0]
    fp32, bytes_per_s = card_peaks(name)
    return {"fp32_flops": fp32, "bytes_per_s": bytes_per_s,
            "bf16_flops": card_bf16_peak(name)}


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


def center_fc_bias(mx, sym, np_args, np_aux, rng, n=16, device="cuda"):
    """Set ``fc1_bias`` so the logits of ``n`` random calibration images
    average zero. A random He-initialised ResNet puts nearly all of its
    pooled feature in one input-independent direction, which would give
    every image the same top-1 class; removing that mean makes the top-1
    comparison of the serve phase informative. Runs the plain graph on
    ``device`` (the card)."""
    import torch
    from mxnet_tpu_torch.executor import _GraphProgram

    internals = sym.get_internals()
    names = internals.list_outputs()
    idx = next(i for i, (node, _) in enumerate(internals._outputs)
               if node.op == "Flatten")
    args, aux = mx.params_from_jax(np_args, np_aux, device=device)
    x = rng.standard_normal((n,) + ROW, dtype=np.float32)
    args["data"] = torch.from_numpy(x).to(device)
    args["softmax_label"] = torch.zeros(n, device=device)
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


def library_fn(x, w, extras, epilogue, wt, native=False, out_dtype=None):
    """The yardstick: cuBLAS through torch.addmm/mm with the same epilogue
    as PyTorch ops (timed only, never used by the port), in fp32, or with
    ``native`` in the inputs' own dtype (bf16: the tensor cores), cast to
    ``out_dtype`` (default: the inputs')."""
    import torch

    def own(t):
        return t if native else t.float()

    wm = w.t() if wt else w
    steps = list(epilogue)
    ex = list(extras)
    if steps and (steps[0][0] == "bias" or steps[0] == ("res",
                                                        "elemwise_add")):
        first = ex.pop(0)
        steps.pop(0)
        y = torch.addmm(own(first), own(x), own(wm))
    else:
        y = torch.mm(own(x), own(wm))
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
    return y.to(getattr(torch, out_dtype) if out_dtype else x.dtype)


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
    """One server's run: warmup, singles, one batch, then throughput. Each
    bucket is one CUDA graph: ``captures`` graphs, ``replays`` replays
    (warmup's one per bucket and one per batch)."""
    import torch

    srv = mx.serving.InferenceServer(
        served_sym, args, aux, data_shapes=[("data", (1,) + ROW)],
        devices=[torch.device(device)],
        config=mx.serving.ServingConfig(buckets=BUCKETS))
    try:
        warmed = srv.warmup()
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
        # the launches that ran on the card, as the profiler saw them:
        # SERVE_PROFILED requests (a single and a batch each), each one
        # batch and so one replay
        before = srv.get_stats()["batches"]
        _dev, _wall, ran = profiled_ms(
            lambda: (srv.predict(images[0], timeout=600),
                     srv.predict(batch, timeout=600)), SERVE_PROFILED)
        stats = srv.get_stats()
    finally:
        srv.stop()
    return dict(singles=singles, batched=batched, latency_ms=lat,
                img_per_s=n_batches * batch.shape[0] / wall,
                captures=stats["bucket_programs"],
                replays=warmed + stats["batches"], stats=stats,
                profiled_replays=stats["batches"] - before,
                profiled_launches=ran.get("fused_matmul", 0))


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
    from mxnet_tpu_torch import cuda_build, cuda_graph

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
    # the wrapper counts where it is called: in each capture's warm-up
    # runs and in the capture, not in a replay (the graph launches then)
    body_runs = run["captures"] * (1 + cuda_graph.WARMUP_RUNS)
    log("serve: %d captures (one per bucket), %d replays; %d fused_matmul "
        "launches counted = %d per body run x %d body runs (%d warm-up "
        "runs + the capture each); the profiler saw %d fused_matmul "
        "kernels run in %d replays (%d per replay)"
        % (run["captures"], run["replays"], launches,
           launches / max(1, body_runs), body_runs, cuda_graph.WARMUP_RUNS,
           run["profiled_launches"], run["profiled_replays"],
           run["profiled_launches"] / max(1, run["profiled_replays"])))
    if run["captures"] != len(BUCKETS) or not launches or \
            launches != KERNEL_REGIONS * body_runs:
        raise AssertionError("expected %d captures and %d launches per "
                             "captured body run, got %d captures, %d "
                             "launches" % (len(BUCKETS), KERNEL_REGIONS,
                                           run["captures"], launches))
    if run["profiled_replays"] != 2 * SERVE_PROFILED or \
            run["profiled_launches"] != \
            KERNEL_REGIONS * run["profiled_replays"]:
        raise AssertionError("expected %d fused_matmul kernels on the card "
                             "in %d profiled replays, the profiler saw %d "
                             "in %d" % (KERNEL_REGIONS * 2 * SERVE_PROFILED,
                                        2 * SERVE_PROFILED,
                                        run["profiled_launches"],
                                        run["profiled_replays"]))

    mx.config.set_flag("MXNET_FUSION_KERNEL", 0)
    cuda_build.reset_launch_counts()
    try:
        plain = serve(mx, served, args, aux, images, batch, n_batches=4)
    finally:
        mx.config.set_flag("MXNET_FUSION_KERNEL", None)
    if cuda_build.launch_counts().get("fused_matmul", 0) or \
            plain["profiled_launches"]:
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
        captures=run["captures"], replays=run["replays"],
        launches=launches, profiled_replays=run["profiled_replays"],
        profiled_launches=run["profiled_launches"],
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

def bmm_path_cases(B, T, D, gen, dtype=None):
    """The two fused_batch_matmul calls of one attention-block step, as
    the fuse pass hands them over: the scores q . k^T / sqrt(D), with k^T
    the (0, 2, 1) view of k, and the context attn . v + x; in fp32, or
    every operand in ``dtype``."""
    import torch

    dtype = dtype or torch.float32
    q, k, v, x = (torch.randn(B, T, D, device="cuda", generator=gen)
                  .to(dtype) for _ in range(4))
    attn = torch.softmax(torch.randn(B, T, T, device="cuda", generator=gen),
                         -1).to(dtype)
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


def bmm_bf16_rows(F, peaks, gen, results):
    """The attention block's two regions with bf16 operands (the amp
    bind's): each launch on the tensor-core route (the transposed k read
    in place: one launch), held to the plain version at the bf16 grid's
    bar, timed beside it and beside torch.bmm / baddbmm in bf16, with its
    bound at the bf16 peak. Per-step sums by size."""
    import torch
    from mxnet_tpu_torch import cuda_build

    worst, totals = 0.0, {}
    for size, cfg in BLOCK_SIZES.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0, "variants": {}}
        for case in bmm_path_cases(cfg["B"], cfg["T"], cfg["D"], gen,
                                   torch.bfloat16):
            x, w, ex, ep = case["x"], case["w"], case["extras"], \
                case["epilogue"]
            what = "bf16 %s %s %s x %s" % (size, case["region"],
                                           tuple(x.shape), tuple(w.shape))
            cuda_build.reset_launch_counts()
            err = bmm_check(F, x, w, ex, ep, GRID_TOL["bfloat16"], what)
            variants = fused_variants(F.BMM_KERNEL)
            if not all_tc(variants) or sum(variants.values()) != 1:
                raise AssertionError("%s: launches %s, want one on the "
                                     "tensor-core route" % (what, variants))
            worst = max(worst, err)
            ms = time_ms(lambda: F.fused_batch_matmul(x, w, ex, ep))
            plain = time_ms(lambda: F.fused_batch_matmul_reference(x, w, ex,
                                                                   ep))
            lib = time_ms(lambda: bmm_library_fn(case))
            bnd, by = bmm_bound_ms(case, peaks)
            row = dict(size=size, region=case["region"], dtype="bfloat16",
                       x=tuple(x.shape), w=tuple(w.shape),
                       w_transposed=not w.is_contiguous(),
                       variant=next(iter(variants)), max_abs_err=err, ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by)
            results["bmm_cases"].append(row)
            log("bmm bf16 %s %s x%s w%s%s %s err=%.3g ms=%.4f plain_ms=%.4f "
                "library_ms=%.4f (torch.%s bf16) bound_ms=%.4f (%s) %.2f "
                "TFLOP/s" % (size, case["region"], tuple(x.shape),
                             tuple(w.shape),
                             " (transposed view)" if row["w_transposed"]
                             else "", row["variant"], err, ms, plain, lib,
                             "baddbmm" if ex else "bmm", bnd, by,
                             2.0 * x.numel() * w.shape[2] / ms / 1e9))
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[key] += row[key]
            tot["t_ops" if by == "operations" else "t_bytes"] += bnd
            tot["variants"][case["region"]] = row["variant"]
        tot["bound_by"] = ("operations" if tot["t_ops"] >= tot["t_bytes"]
                           else "bytes")
        totals[size] = tot
        log("bmm bf16 per step %s (2 launches): ms=%.4f plain_ms=%.4f "
            "library_ms=%.4f bound_ms=%.4f (%s)"
            % (size, tot["ms"], tot["plain_ms"], tot["library_ms"],
               tot["bound_ms"], tot["bound_by"]))
    results["bmm_bf16_totals"] = totals
    return worst, totals


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
    bf16_err, _ = bmm_bf16_rows(
        F, (results["peaks"]["bf16_flops"], peaks[1]), gen, results)
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
    results["bmm_bf16_max_abs_err"] = bf16_err
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


def first_step_vs_plain(mx, mod, batch, kernel, what, tol=MODULE_TOL,
                        variants=None):
    """The first forward_backward with the kernels and with
    MXNET_FUSION_KERNEL=0 (no update between): the outputs and every
    parameter gradient within ``tol`` of their own max |value| (k_bias,
    whose gradient is 0 up to rounding, at k_weight's), and every gradient
    with the kernels but k_bias's non-zero, so that a dropped gradient
    fails. Returns (worst, launches); the kernel's launches by variant
    with the kernels go into ``variants`` where given."""
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
                if variants is not None:
                    variants.update(fused_variants(kernel))
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
    if worst > tol:
        raise AssertionError("%s: first-step %s with the kernels disagrees "
                             "with MXNET_FUSION_KERNEL=0: %.3g of max |value| "
                             "> %.1g" % (what, worst_name, worst, tol))
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

    # the same block bound under default,amp: both batch_dot regions in
    # bf16 on the tensor-core route, against the amp bind's plain
    # composition within the bf16 bar
    mx.graph_pass.set_passes("default,amp")
    try:
        amod = bound_module(mx, sym, (B, T, D), (B,))
    finally:
        mx.graph_pass.set_passes(None)
    amp_variants = {}
    worst, launches = first_step_vs_plain(
        mx, amod, batch, "fused_batch_matmul", "amp attention block %s"
        % (cfg,), tol=AMP_MODULE_TOL, variants=amp_variants)
    if launches != 2 or not all_tc(amp_variants):
        raise AssertionError("amp attention step launched "
                             "fused_batch_matmul %d times (%s), want 2 on "
                             "the tensor-core route"
                             % (launches, amp_variants))
    out["amp_block_first_step_worst"] = worst
    out["amp_block_variants"] = amp_variants
    del amod

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
                         time.monotonic(), E._rtrace.NOOP_TRACE,
                         E.resolve_class(None), None)
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
    programs = len(G.default_prefill_ladder(GEN_MAX_SEQ)) + 1
    if warmed != programs or gen.get_stats()["captures"] != programs:
        raise AssertionError("warmup() gave %d programs and %d captures, "
                             "want %d of each (a graph per prefill bucket "
                             "and the decode step)"
                             % (warmed, gen.get_stats()["captures"],
                                programs))
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
        # one graph per prefill bucket (the draft's prefill rides in it)
        # and per step kind
        if warmed != 8 + programs or \
                gen.get_stats()["captures"] != 8 + programs:
            raise AssertionError("%s: warmup() gave %d programs, %d "
                                 "captures" % (mode, warmed,
                                               gen.get_stats()["captures"]))
        got, wall = serve_all(gen, reqs)
        spec = gen.get_stats()["speculative"]
        captures = stopped(gen)
        if captures != 8 + programs:
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
    """(d): each prompt bucket's prefill step, its CUDA graph replayed (the
    inputs copied in and the first token fetched, as the scheduler runs it)
    against its body run eagerly: wall ms (median of 5), device ms (5
    replays between CUDA events; the eager body under torch.profiler), one
    replay against one eager run to the bit (token, key and the K/V it
    wrote into pages 1..max_pages, real pages: the generator holds no
    slot), and the flash forward launches of one body run (counted at the
    capture). Returns the rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    P = gen._max_pages
    page_row = np.arange(1, P + 1)
    rng = np.random.RandomState(3)
    rows = []
    with gen._device_scope(), gen._pages_lock:
        for bucket in gen._cfg.prefill_buckets:
            step = gen._captured("prefill%d" % bucket)
            toks = rng.randint(1, TRAIN_CFG["vocab"], bucket)

            def fill():
                gen._fill_prefill(toks, bucket, 0, page_row, (0, 0), [0, 0],
                                  0.0, 0)

            def eager():
                fill()
                return step.body()[0].cpu()

            def replayed():
                fill()
                return step.run()[0].cpu()

            fill()
            want = [t.clone() for t in step.body()]
            want_kv = {k: v[:, 1:P + 1].clone()
                       for k, v in gen._pools.items()}
            for v in gen._pools.values():
                v[:, 1:P + 1].zero_()
            fill()
            got = step.run()
            same = (all(torch.equal(a, b) for a, b in zip(got, want))
                    and all(torch.equal(v[:, 1:P + 1], want_kv[k])
                            for k, v in gen._pools.items()))
            del want_kv
            walls = {}
            for name, fn in (("replay", replayed), ("eager", eager)):
                fn()
                ts = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    fn()
                    ts.append((time.perf_counter() - t0) * 1e3)
                walls[name] = float(np.median(ts))
            fill()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                step.graph.replay()
            end.record()
            end.synchronize()
            replay_dev = start.elapsed_time(end) / 5
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                eager()
            us = sum(getattr(ev, "self_device_time_total", 0.0)
                     for ev in prof.key_averages()
                     if ev.device_type == torch.autograd.DeviceType.CUDA)
            rows.append(dict(
                bucket=bucket, replay_wall_ms=walls["replay"],
                eager_wall_ms=walls["eager"], replay_device_ms=replay_dev,
                eager_device_ms=us / 1e3, replay_equals_eager=same,
                flash_fwd_per_replay=step.launches.get(
                    "flash_attention_fwd", 0)))
    log("generation (d): prefill per bucket, replayed wall ms / eager wall "
        "ms (replay device ms / eager device ms), flash forward launches a "
        "replay: %s; each replay equal to its eager body to the bit: %s; "
        "on %s" % (", ".join(
            "%d: %.3f / %.3f (%.3f / %.3f) %d" % (
                r["bucket"], r["replay_wall_ms"], r["eager_wall_ms"],
                r["replay_device_ms"], r["eager_device_ms"],
                r["flash_fwd_per_replay"]) for r in rows),
            all(r["replay_equals_eager"] for r in rows), card))
    bad = [r["bucket"] for r in rows if not r["replay_equals_eager"]
           or r["flash_fwd_per_replay"] != TRAIN_CFG["n_layers"]]
    if bad:
        raise AssertionError("prefill graphs of buckets %s: a replay "
                             "differs from its eager body, or the flash "
                             "forward is not launched once per layer" % bad)
    out["prefill_ms"] = rows
    return rows


def gen_step_timing(mx, gen, card, out):
    """(d): THE decode step of ``gen`` (warmed, its scheduler not started)
    at full batch and GEN_STEP_CTX context: :func:`decode_step_profile`."""
    G = mx.serving.generation
    prompts = gen_prompts(GEN_MAX_BATCH, GEN_STEP_CTX, GEN_STEP_CTX + 1,
                          TRAIN_CFG["vocab"], 7)
    row = decode_step_profile(gen, prompts,
                              G.SamplingParams(max_new_tokens=16))
    row.update(ctx=GEN_STEP_CTX, batch=GEN_MAX_BATCH)
    fams, device_ms = row["families_ms"], row["device_ms"]
    log("generation (d): decode step, %d slots at %d tokens of context: "
        "replayed %.3f ms (median of %d, input copy and token fetch "
        "included; graph alone %.3f ms between CUDA events), eager %.3f ms; "
        "device %.3f ms/step (torch.profiler over %d eager steps), busy "
        "%.3f of the replayed step; replay equals eager to the bit: %s; on "
        "%s" % (GEN_MAX_BATCH, GEN_STEP_CTX, row["replay_ms"], GEN_TIMED,
                row["replay_device_ms"], row["eager_ms"], device_ms,
                GEN_PROFILED, row["busy"], row["graph_equals_eager"], card))
    for fam, v in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("    %9.3f ms  %.3f  %s" % (v, v / device_ms, fam))
    for name, v in row["top_kernels_ms"][:6]:
        log("    %9.3f ms  %s" % (v, name[:110]))
    if not row["graph_equals_eager"]:
        raise AssertionError("the replayed decode step differs from the "
                             "eager one")
    out["decode_step"] = row


def decode_step_profile(gen, prompts, params):
    """THE decode step of ``gen`` (warmed, its scheduler not started) with
    ``prompts`` admitted into its slots: replayed (with its input copy and
    token fetch, as the scheduler runs it) against eager, device time per
    replay from CUDA events, and the device ms per step by family over
    GEN_PROFILED eager steps (which launch the graph's kernels) under
    torch.profiler, paged attention and sampling marked as scopes. The
    slots are released after."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    E = gen_engine()
    with gen._device_scope():
        admit_slots(gen, prompts, params)
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
    return dict(graph_equals_eager=same, replay_ms=walls["replay"],
                eager_ms=walls["eager"], replay_device_ms=replay_dev,
                device_ms=device_ms, families_ms=fams,
                busy=device_ms / walls["replay"], top_kernels_ms=top)


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
        if warmed != n_buckets + 1 or captures != n_buckets + 1:
            raise AssertionError("warmup() gave %d programs and %d captures, "
                                 "want %d of each" % (warmed, captures,
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
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen = new_generator()
        # the prefills replay their graphs: the launches of the traffic
        # are the replays times one body run's (the wrapper counts only
        # at a capture, and must count nothing here)
        base = gen.graph_launches().get("flash_attention_fwd", 0)
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
        launches = gen.graph_launches().get("flash_attention_fwd", 0) - base
        eager_launches = cuda_build.launch_counts().get(
            "flash_attention_fwd", 0)
        stats = gen.get_stats()
        captures = stopped(gen)
        peak = torch.cuda.max_memory_allocated() - held
        del gen
        if any(r is None for r in res) or captures != n_buckets + 1 or \
                eager_launches:
            raise AssertionError("traffic: %d requests unanswered, %d "
                                 "captures, %d flash forward launches "
                                 "outside a graph"
                                 % (sum(r is None for r in res), captures,
                                    eager_launches))
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
                   peak_bytes=peak, held_before_bytes=held)
        log("generation (d): %s, %d requests (prompts 2-%d tokens, %d new), "
            "Poisson arrivals at %gx the probed sequential capacity (%.3f s "
            "a request): %.1f tokens/s over %.3f s; TTFT p50 %.2f p99 %.2f "
            "ms; inter-token p50 %.2f p99 %.2f ms; per-token p50 %.2f p99 "
            "%.2f ms; %d decode steps, %d prefills; flash forward launches "
            "%d (%.2f per request, prefill replays x one body run's); %d "
            "captures; peak memory %.3f GB above the %.3f GB held before; "
            "on %s"
            % ("sequential" if sequential else "continuous", GEN_REQUESTS,
               GEN_MAX_SEQ - GEN_MAX_NEW - 1, GEN_MAX_NEW, GEN_OVERLOAD,
               t_req, row["tokens_per_s"], wall, row["ttft_p50_ms"],
               row["ttft_p99_ms"], row["inter_token_p50_ms"],
               row["inter_token_p99_ms"], row["per_token_p50_ms"],
               row["per_token_p99_ms"], row["decode_steps"],
               row["prefills"], launches, row["launches_per_request"],
               captures, peak / 1e9, held / 1e9, card))
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


# ------------------------------------------------- serving in full phase
# ResNet-50 v2 NHWC fp32 behind InferenceServer with two replicas on one
# card, every (replica, bucket) one CUDA graph
SRV_REPLICAS = 2
SRV_REQUESTS = 200          # (a): mixed sizes of 1 to SRV_MAX_ROWS rows
SRV_MAX_ROWS = 12
SRV_BACK_TO_BACK = 16       # (b), (c): back-to-back 8-row batches
SRV_LATENCY_N = 40          # (c): single requests per bucket, graphs
SRV_EAGER_N = 20            # (c): the eager walk's
SRV_PROFILED = 10           # (c): requests per bucket under torch.profiler
PROFILE_MARGIN_S = 0.02     # idle host time at each end of a profiled window
SRV_COOLDOWN_MS = 200       # (d)
# a request's logits against the eager walk of its rows at its own bucket,
# over max |logit|: a coalesced request ran in a larger bucket, where cuDNN
# may take another algorithm (another fp32 summation order)
SRV_TOL = 1e-4
SRV_SERIES = ("requests", "batches", "rows_real", "rows_padded",
              "occupancy_pct", "latency_ms", "queue_depth",
              "replicas_configured", "replicas_available", "resizes",
              "replica_quarantined", "replica_readmitted", "bucket_compiles")


def srv_server(mx, served, args, aux, **cfg):
    import torch

    cfg.setdefault("buckets", BUCKETS)
    cfg.setdefault("max_wait_ms", 0)
    return mx.serving.InferenceServer(
        served, args, aux, data_shapes=[("data", (1,) + ROW)],
        devices=[torch.device("cuda", 0)] * SRV_REPLICAS,
        config=mx.serving.ServingConfig(**cfg))


def eager_outputs(srv, replica, x):
    """The eager walk of the server's program (``_GraphProgram.infer_fn()``
    called directly) on replica ``replica``'s parameters and bindings:
    what the server would answer for ``x`` (its rows a bucket) without
    the graph. Device tensors."""
    import torch

    extras, aux = srv._bindings(replica, x.shape[0])
    feed = dict(srv._replica_args[replica])
    feed.update(extras)
    feed["data"] = torch.from_numpy(x).cuda()
    return srv._prog.infer_fn()(feed, aux)


def replay_vs_eager(srv, replica, x):
    """(one replay's host outputs, the eager walk's) on the same inputs."""
    from mxnet_tpu_torch.serving.engine import _fetch

    got = _fetch(*srv._run_bucket(replica, x.shape[0], [x]))
    want = [o.cpu().numpy() for o in eager_outputs(srv, replica, x)]
    return got, want


def rel_gap(got, want):
    return max(float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))
               for g, w in zip(got, want))


def profiled_ms(fn, n):
    """(device ms per call, wall ms per call, kernels run on the card by
    ``kernel_family``) from torch.profiler over ``n`` calls ending in a
    host fetch; raises where it saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # an idle margin at each end of the window, so that no counted
        # kernel lies near its edges
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
        time.sleep(PROFILE_MARGIN_S)
    _fams, dev, _top, _spans = device_families(
        prof, n, scope_family=lambda _name: None, marks=())
    ran = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            fam = kernel_family(ev.key)
            ran[fam] = ran.get(fam, 0) + ev.count
    return dev, wall, ran


def srv_fifo_traffic(srv, xs):
    """Submit every ``xs`` at once; (outputs in order, FIFO held)."""
    order, futs = [], []
    for i, x in enumerate(xs):
        f = srv.submit(x)
        f.add_done_callback(lambda _f, _i=i: order.append(_i))
        futs.append(f)
    outs = [f.result(timeout=600) for f in futs]
    return outs, order == sorted(order) and len(order) == len(xs)


def srv_check_rows(srv, xs, outs, what, tol=SRV_TOL):
    """Every request's logits against the eager walk of its rows padded to
    their bucket, on replica 0; returns the worst gap."""
    worst = 0.0
    for x, (probs, logits) in zip(xs, outs):
        if not (np.isfinite(probs).all()
                and probs.shape == (x.shape[0], 1000)):
            raise AssertionError("%s: output %s" % (what, probs.shape))
        # a request of more rows than the largest bucket is chunked
        for lo in range(0, x.shape[0], BUCKETS[-1]):
            part = x[lo:lo + BUCKETS[-1]]
            n = part.shape[0]
            pad = np.zeros((min(b for b in BUCKETS if b >= n),) + ROW,
                           np.float32)
            pad[:n] = part
            want = eager_outputs(srv, 0, pad)[1][:n].cpu().numpy()
            worst = max(worst, rel_gap([logits[lo:lo + n]], [want]))
    if worst > tol:
        raise AssertionError("%s: logits %.3g of max off the eager walk"
                             % (what, worst))
    return worst


def srv_program_count(mx, srv, card, out):
    """(a) captures: 8 after warmup, still 8 after 200 mixed requests,
    which launch nothing eagerly."""
    import torch

    from mxnet_tpu_torch import cuda_build, cuda_graph

    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    warmed = srv.warmup()
    warm_s = time.perf_counter() - t0
    captures = srv.get_stats()["bucket_programs"]
    launches = cuda_build.launch_counts().get("fused_matmul", 0)
    torch.cuda.synchronize()
    # the server's own: two replicas' parameters, bindings, static buffers
    # and graph pools, above what was allocated before it was built
    peak = torch.cuda.max_memory_allocated() - out["base_bytes"]
    # the graph pools: their blocks are reserved, not allocated, between
    # replays
    reserved = torch.cuda.memory_reserved() - out["base_reserved"]
    rng = np.random.default_rng(14)
    xs = [rng.standard_normal((int(n),) + ROW, dtype=np.float32)
          for n in rng.integers(1, SRV_MAX_ROWS + 1, SRV_REQUESTS)]
    t0 = time.perf_counter()
    outs, fifo = srv_fifo_traffic(srv, xs)
    wall = time.perf_counter() - t0
    after = srv.get_stats()
    # read before the eager references below, which call the wrapper
    traffic_launches = cuda_build.launch_counts().get("fused_matmul", 0)
    worst = srv_check_rows(srv, xs[:24], outs[:24], "serving (a)")
    log("serving (a): warmup() %d programs in %.2f s, %d captures, %d "
        "fused_matmul launches (%d per body run); %d requests (%d rows, "
        "%d chunked) in %.3f s: %d batches, captures %d, launches %d, FIFO "
        "%s, first 24 within %.3g of the eager walk; peak %.4f GB "
        "allocated, %.4f GB reserved after warmup, on %s"
        % (warmed, warm_s, captures, launches,
           launches / max(1, captures * (1 + cuda_graph.WARMUP_RUNS)),
           len(xs), sum(x.shape[0] for x in xs), after.get("chunked", 0),
           wall, after["batches"], after["bucket_programs"],
           traffic_launches, fifo, worst, peak / 1e9, reserved / 1e9,
           card))
    want = len(BUCKETS) * SRV_REPLICAS
    if warmed != want or captures != want or \
            after["bucket_programs"] != want or not fifo or \
            traffic_launches != launches:
        raise AssertionError("serving (a): warmup %d, captures %d -> %d "
                             "(want %d), FIFO %s, launches under traffic"
                             % (warmed, captures, after["bucket_programs"],
                                want, fifo))
    out["a"] = dict(warmup=warmed, warmup_s=warm_s, captures=captures,
                    captures_after=after["bucket_programs"],
                    requests=len(xs), batches=after["batches"],
                    traffic_s=wall, launches=launches, peak_gb=peak / 1e9,
                    reserved_gb=reserved / 1e9, max_gap=worst)


def srv_parity(mx, served, args, aux, card, out):
    """(b) replay against the eager walk bit for bit, under cuDNN's
    deterministic algorithms, every bucket and replica; then back-to-back
    different batches under pipeline_depth 2."""
    import torch

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    srv = srv_server(mx, served, args, aux, pipeline_depth=2)
    try:
        srv.warmup()
        rng = np.random.default_rng(15)
        rows = {}
        for rep in range(SRV_REPLICAS):
            for b in BUCKETS:
                x = rng.standard_normal((b,) + ROW, dtype=np.float32)
                got, want = replay_vs_eager(srv, rep, x)
                rows["%d/%d" % (rep, b)] = (
                    all(np.array_equal(g, w) for g, w in zip(got, want)),
                    rel_gap(got, want))
        xs = [rng.standard_normal((8,) + ROW, dtype=np.float32)
              for _ in range(SRV_BACK_TO_BACK)]
        outs, fifo = srv_fifo_traffic(srv, xs)
        b2b = []
        for x, (probs, logits) in zip(xs, outs):
            want = [o.cpu().numpy() for o in eager_outputs(srv, 0, x)]
            b2b.append(np.array_equal(probs, want[0])
                       and np.array_equal(logits, want[1]))
        distinct = len({float(lg[0, 0]) for _p, lg in outs})
    finally:
        srv.stop()
        torch.backends.cudnn.deterministic = det
    log("serving (b), cuDNN deterministic: replay vs eager walk per "
        "replica/bucket (bit-identical, gap): %s; %d back-to-back 8-row "
        "batches at depth 2: %d of %d bit-identical to the eager walk, %d "
        "distinct, FIFO %s, on %s"
        % (json.dumps(rows), len(xs), sum(b2b), len(b2b), distinct, fifo,
           card))
    if not (all(ok for ok, _ in rows.values()) and all(b2b) and fifo
            and distinct == len(xs)):
        raise AssertionError("serving (b): a replay differs from the eager "
                             "walk: %s; back-to-back %s"
                             % (rows, b2b))
    out["b"] = dict(per_bucket=rows, back_to_back_identical=sum(b2b),
                    back_to_back=len(b2b))


def srv_host_costs(srv, x, n=20):
    """Host ms (medians) of one dispatch's parts on replica 0, each timed
    on an idle card (synchronised before and after, so no call waits
    behind queued work): staging the batch (pinned copy, asynchronous
    upload), the graph's replay call, and the whole ``_run_bucket``."""
    import torch

    from mxnet_tpu_torch.runtime.staging import stage_pytree

    prog = srv._programs[(0, x.shape[0])]
    dev = srv._devices[0]
    parts = {"stage": [], "replay": [], "run_bucket": []}
    calls = (("stage", lambda: stage_pytree([x], dev)),
             ("replay", prog.graph.replay),
             ("run_bucket", lambda: srv._run_bucket(0, x.shape[0], [x])))
    with torch.cuda.stream(srv._streams[0]):
        for _ in range(n):
            for name, fn in calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                parts[name].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return {k: float(np.median(v)) for k, v in parts.items()}


def srv_timing(mx, srv, card, out):
    """(c) per bucket: single-request p50/p99, device ms per request and
    busy share, graph against the eager walk, and where a request's host
    time goes (its trace's phases, the dispatch's parts); img/s at bucket
    8."""
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.observability import request_trace

    rng = np.random.default_rng(16)
    rows = {}
    for b in BUCKETS:
        x = rng.standard_normal((b,) + ROW, dtype=np.float32)
        for _ in range(3):
            srv.predict(x, timeout=600)
        request_trace.reset()
        lat = []
        for _ in range(SRV_LATENCY_N):
            t0 = time.perf_counter()
            srv.predict(x, timeout=600)
            lat.append((time.perf_counter() - t0) * 1e3)
        phases = {}
        for t in request_trace.reservoir().recent():
            for k, v in t.to_dict()["phases_ms"].items():
                phases.setdefault(k, []).append(v)
        phases = {k: float(np.median(v)) for k, v in phases.items()}
        host = srv_host_costs(srv, x)
        dev, wall, ran = profiled_ms(lambda: srv.predict(x, timeout=600),
                                     SRV_PROFILED)

        def eager():
            return [o.cpu().numpy() for o in eager_outputs(srv, 0, x)]

        for _ in range(3):
            eager()
        elat = []
        for _ in range(SRV_EAGER_N):
            t0 = time.perf_counter()
            eager()
            elat.append((time.perf_counter() - t0) * 1e3)
        # a walk calls the wrapper, which counts each launch where it
        # makes it; a replay calls none, so only the profiler sees its
        # kernels run
        cuda_build.reset_launch_counts()
        edev, ewall, eran = profiled_ms(eager, SRV_PROFILED)
        walked = cuda_build.launch_counts().get("fused_matmul", 0)
        for what, got in (
                ("the profiler saw run in %d replays", ran.get(
                    "fused_matmul", 0)),
                ("the wrapper launched in %d eager walks", walked)):
            if got != KERNEL_REGIONS * SRV_PROFILED:
                raise AssertionError(
                    "serving (c) bucket %d: %d fused_matmul kernels %s, "
                    "expected %d each" % (b, got, what % SRV_PROFILED,
                                          KERNEL_REGIONS))
        rows[b] = dict(
            p50_ms=float(np.percentile(lat, 50)),
            p99_ms=float(np.percentile(lat, 99)),
            device_ms=dev, busy=dev / wall,
            eager_p50_ms=float(np.percentile(elat, 50)),
            eager_p99_ms=float(np.percentile(elat, 99)),
            eager_device_ms=edev, eager_busy=edev / ewall,
            trace_phases_ms=phases, host_ms=host)
        log("serving (c) bucket %d: graph p50 %.3f p99 %.3f ms, device "
            "%.3f ms/request, busy %.3f; eager walk p50 %.3f p99 %.3f ms, "
            "device %.3f, busy %.3f; fused_matmul kernels in %d requests: "
            "%d run in the replays (profiler), %d launched by the walks "
            "(wrapper; the profiler saw %d); trace phases (median ms) %s; "
            "host ms of a dispatch %s" % (
                b, rows[b]["p50_ms"], rows[b]["p99_ms"], dev,
                rows[b]["busy"], rows[b]["eager_p50_ms"],
                rows[b]["eager_p99_ms"], edev, rows[b]["eager_busy"],
                SRV_PROFILED, ran.get("fused_matmul", 0), walked,
                eran.get("fused_matmul", 0),
                json.dumps({k: round(v, 4) for k, v in phases.items()}),
                json.dumps({k: round(v, 4) for k, v in host.items()})))
    x8 = rng.standard_normal((8,) + ROW, dtype=np.float32)
    rates, erates = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        srv_fifo_traffic(srv, [x8] * SRV_BACK_TO_BACK)
        rates.append(SRV_BACK_TO_BACK * 8 / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        prev = None
        for _ in range(SRV_BACK_TO_BACK):   # the walk at depth 2
            outs = eager_outputs(srv, 0, x8)
            if prev is not None:
                [o.cpu() for o in prev]
            prev = outs
        [o.cpu() for o in prev]
        erates.append(SRV_BACK_TO_BACK * 8 / (time.perf_counter() - t0))
    log("serving (c): %d back-to-back 8-row batches: %s img/s (graphs, %d "
        "replicas) against %s (the eager walk), on %s"
        % (SRV_BACK_TO_BACK, ", ".join("%.1f" % r for r in rates),
           SRV_REPLICAS, ", ".join("%.1f" % r for r in erates), card))
    out["c"] = dict(per_bucket=rows, img_per_s_bucket8=rates,
                    eager_img_per_s_bucket8=erates)


def srv_breaker(mx, srv, card, out):
    """(d) replica 1 faults on its first two dispatches: FIFO, results,
    quarantine, retry, then readmission after the cooldown."""
    from mxnet_tpu_torch.resilience import faults

    rng = np.random.default_rng(17)
    xs = [rng.standard_normal((1 + i % 3,) + ROW, dtype=np.float32)
          for i in range(12)]
    before = srv.get_stats()
    faults.configure("serving.replica_execute[1]:raise@calls=1-2", seed=0)
    try:
        outs, fifo = srv_fifo_traffic(srv, xs)
        mid = srv.get_stats()
        state_mid = srv.breaker_states()["state"]
        for _ in range(2):
            time.sleep(SRV_COOLDOWN_MS / 1e3 * 1.5)
            for _ in range(4):
                srv.predict(xs[0], timeout=600)
        after = srv.get_stats()
        fired = faults.fired()
    finally:
        faults.configure(None)
    worst = srv_check_rows(srv, xs, outs, "serving (d)")
    q = mid.get("quarantines", 0) - before.get("quarantines", 0)
    r = mid.get("batch_retries", 0) - before.get("batch_retries", 0)
    a = after.get("readmitted", 0) - before.get("readmitted", 0)
    state = srv.breaker_states()["state"]
    log("serving (d): %s; FIFO %s, results within %.3g of the eager walk, "
        "quarantines %d, batch retries %d, breaker %s; after the %d ms "
        "cooldown readmitted %d, breaker %s, on %s"
        % (json.dumps(fired), fifo, worst, q, r, state_mid,
           SRV_COOLDOWN_MS, a, state, card))
    if not (fifo and q >= 1 and r >= 1 and a >= 1 and state == "closed"):
        raise AssertionError("serving (d): FIFO %s, quarantines %d, "
                             "retries %d, readmitted %d, state %s"
                             % (fifo, q, r, a, state))
    out["d"] = dict(quarantines=q, batch_retries=r, readmitted=a,
                    state_during=state_mid, state_after=state,
                    max_gap=worst)


def srv_resize(mx, srv, card, out):
    """(e) 2 -> 1 -> 3 replicas while a thread keeps submitting: results,
    FIFO, the capture count, and the memory the shrink returns."""
    import threading

    import torch

    rng = np.random.default_rng(18)
    xs = [rng.standard_normal((1 + i % 8,) + ROW, dtype=np.float32)
          for i in range(60)]
    res = {}

    def client():
        try:
            res["outs"], res["fifo"] = srv_fifo_traffic(srv, xs)
        except Exception as err:   # surfaced below
            res["err"] = err

    param_bytes = sum(t.numel() * t.element_size() for t in
                      list(srv._replica_args[1].values())
                      + list(srv._replica_aux[1].values()))
    before = srv.get_stats()["bucket_programs"]
    gc.collect()
    torch.cuda.empty_cache()
    thread = threading.Thread(target=client)
    thread.start()
    torch.cuda.synchronize()
    mem0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    shrink = srv.resize_replicas(1)
    gc.collect()
    torch.cuda.empty_cache()
    mem1, res1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    after_shrink = srv.get_stats()["bucket_programs"]
    time.sleep(0.05)
    grow = srv.resize_replicas(3)
    thread.join(600)
    if thread.is_alive() or "err" in res:
        raise AssertionError("serving (e): traffic %s"
                             % res.get("err", "hung"))
    worst = srv_check_rows(srv, xs, res["outs"], "serving (e)")
    warmed = srv.warmup()
    regrown = srv.get_stats()["bucket_programs"]
    srv_fifo_traffic(srv, xs[:12])
    flat = srv.get_stats()["bucket_programs"]
    freed = mem0 - mem1    # under traffic: staged batches come and go
    log("serving (e): resize %s then %s mid-traffic (%d requests): FIFO "
        "%s, within %.3g of the eager walk; captures %d before, %d after "
        "the shrink, %d after the regrow and warmup() (%d programs), %d "
        "after more traffic; the shrink freed %.4f GB allocated (one "
        "replica's parameters %.4f GB), %.4f GB reserved after "
        "empty_cache, on %s"
        % (json.dumps(shrink), json.dumps(grow), len(xs), res["fifo"],
           worst, before, after_shrink, regrown, warmed, flat, freed / 1e9,
           param_bytes / 1e9, (res0 - res1) / 1e9, card))
    want = before + 2 * len(BUCKETS)   # slot 1 recaptured, slot 2 new
    if not (res["fifo"] and after_shrink == before and regrown == want
            and flat == want and warmed == 3 * len(BUCKETS)
            and freed >= 0.9 * param_bytes
            and srv.active_replicas() == [0, 1, 2]):
        raise AssertionError("serving (e): FIFO %s, captures %d/%d/%d/%d "
                             "(want %d), freed %d of %d bytes"
                             % (res["fifo"], before, after_shrink, regrown,
                                flat, want, freed, param_bytes))
    out["e"] = dict(captures=[before, after_shrink, regrown, flat],
                    freed_gb=freed / 1e9, reserved_freed_gb=(res0 - res1)
                    / 1e9, param_gb=param_bytes / 1e9, max_gap=worst)


def srv_observability(mx, srv, card, out):
    """(f) the stats schema, the serving.* series in the exposition, one
    sampled trace's four events."""
    from mxnet_tpu_torch.observability import (metrics, request_trace,
                                               stats_schema)

    request_trace.reset()
    srv.predict(np.zeros((3,) + ROW, np.float32), timeout=600)
    (trace,) = request_trace.reservoir().recent(1)
    events = [e[0] for e in trace.events]
    stats = stats_schema.validate(srv.get_stats())
    text = metrics.dump_metrics()
    registered = sorted({i.name for i in metrics.all_instruments().values()
                         if i.name.startswith("serving.")})
    missing = [n for n in SRV_SERIES if "# TYPE mxnet_serving_%s " % n
               not in text]
    unrendered = [n for n in registered if "# TYPE %s " % (
        "mxnet_" + n.replace(".", "_")) not in text]
    log("serving (f): stats schema %d valid (%d keys), %d serving.* "
        "series rendered, missing %s; one trace: %s, %s, phases %s ms"
        % (stats["schema"], len(stats), len(registered), missing or "none",
           events, json.dumps(trace.meta), json.dumps(
               trace.to_dict()["phases_ms"])))
    if missing or unrendered or events != ["submit", "queue", "batch",
                                           "compute", "fetch"]:
        raise AssertionError("serving (f): missing %s, unrendered %s, "
                             "events %s" % (missing, unrendered, events))
    out["f"] = dict(series=registered, trace=trace.to_dict())


def serving_phase(mx, sym, card, results):
    """Phase 14: serving in full (see the module docstring)."""
    import torch

    from mxnet_tpu_torch.observability import metrics

    out = {}
    metrics.set_enabled(True)
    np_args, np_aux = resnet50_params(sym, seed=0)
    center_fc_bias(mx, sym, np_args, np_aux, np.random.default_rng(1))
    args, aux = mx.params_from_jax(np_args, np_aux, device="cuda")
    served = mx.sym.Group([sym, sym.get_internals()["fc1_output"]])
    gc.collect()      # what the earlier phases dropped is not ours
    torch.cuda.empty_cache()
    out["base_bytes"] = torch.cuda.memory_allocated()
    out["base_reserved"] = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    try:
        srv = srv_server(mx, served, args, aux, cooldown_ms=SRV_COOLDOWN_MS)
        try:
            srv_program_count(mx, srv, card, out)
            srv_parity(mx, served, args, aux, card, out)
            srv_timing(mx, srv, card, out)
            srv_breaker(mx, srv, card, out)
            srv_resize(mx, srv, card, out)
            srv_observability(mx, srv, card, out)
        finally:
            srv.stop()
    finally:
        metrics.set_enabled(False)
    results["serving"] = out
    return out


# ------------------------------------------------------------ phase 15: SSD

SSD_BATCH, SSD_SIZE = 8, 300     # bench_all.py:263-309 bench_ssd300
SSD_ANCHORS = 8732
SSD_TIMED = 20
SSD_PROFILED = 3                 # (c): steps under torch.profiler
SSD_UNFUSED_TIMED = 5            # (c): steps with the fuse pass off
SSD_TARGET_TOL = 1e-6            # (b): loc_target, over max(1, max |CPU|)
SSD_DET_TOL = 1e-5               # (b): scores and boxes, likewise
SSD_OP_TOL = 1e-5                # (e): each tensor, over its max |CPU|
SSD_TOY_STEPS = 300              # (d): tests/test_detection.py:162
SSD_TOY = dict(num_classes=1, sizes=[[0.3, 0.4], [0.6, 0.8]],
               ratios=[[1], [1]])
SSD_OPS = ("_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
           "_contrib_MultiBoxDetection")
SSD_NMS_SCOPE = "ssd::nms"


class no_host_sync:
    """Within it a CUDA call that makes the host wait for the card (a read
    back, a copy from pageable host memory) raises: torch's sync debug
    mode at "error"."""

    def __enter__(self):
        import torch

        self._mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(self._mode)


class ssd_marks:
    """Within it the three MultiBox ops run under ``record_function``
    scopes named after them and the greedy NMS under ``SSD_NMS_SCOPE``;
    with ``capture`` a dict, each op's first call leaves its attrs, its
    inputs and its outputs there (clones), and each call runs under
    ``no_host_sync``."""

    def __init__(self, capture=None):
        self.capture = capture

    def __enter__(self):
        from torch.profiler import record_function
        from mxnet_tpu_torch.ops import detection
        from mxnet_tpu_torch.ops.registry import get_op

        self._real = {n: get_op(n).fn for n in SSD_OPS}
        self._nms = detection._greedy_nms
        capture = self.capture

        def marked(name, real):
            def fn(attrs, *ins):
                with record_function("ssd::" + name[len("_contrib_"):]):
                    if capture is None:
                        outs = real(attrs, *ins)
                    else:
                        with no_host_sync():
                            outs = real(attrs, *ins)
                if capture is not None and name not in capture:
                    seq = outs if isinstance(outs, tuple) else (outs,)
                    capture[name] = (attrs,
                                     [t.detach().clone() for t in ins],
                                     [t.detach().clone() for t in seq])
                return outs
            return fn

        for n, real in self._real.items():
            get_op(n).fn = marked(n, real)
        real_nms = self._nms

        def nms(*args, **kwargs):
            with record_function(SSD_NMS_SCOPE):
                return real_nms(*args, **kwargs)

        detection._greedy_nms = nms
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.ops import detection
        from mxnet_tpu_torch.ops.registry import get_op

        for n, real in self._real.items():
            get_op(n).fn = real
        detection._greedy_nms = self._nms


def ssd_bench_executor(mx, passes=None):
    """bench_ssd300's bind on the card: the SSD-300 training symbol
    (VGG16-reduced, 20 classes), batch 8 at 300x300, grad_req "write",
    parameters randn * 0.01 and data rand from RandomState(0), label rows
    -1 but [0, .3, .3, .7, .7]. ``passes`` sets MXNET_GRAPH_PASSES for the
    bind."""
    from mxnet_tpu_torch.models.ssd import get_ssd

    net = get_ssd(num_classes=20, mode="train")
    old = os.environ.get("MXNET_GRAPH_PASSES")
    if passes is not None:
        os.environ["MXNET_GRAPH_PASSES"] = passes
    try:
        ex = net.simple_bind(mx.gpu(), data=(SSD_BATCH, 3, SSD_SIZE,
                                             SSD_SIZE),
                             label=(SSD_BATCH, 3, 5), grad_req="write")
    finally:
        if old is None:
            os.environ.pop("MXNET_GRAPH_PASSES", None)
        else:
            os.environ["MXNET_GRAPH_PASSES"] = old
    rng = np.random.RandomState(0)
    for k, v in ex.arg_dict.items():
        if k not in ("data", "label"):
            v[:] = (rng.randn(*v.shape) * 0.01).astype(np.float32)
    ex.arg_dict["data"][:] = rng.rand(SSD_BATCH, 3, SSD_SIZE,
                                      SSD_SIZE).astype(np.float32)
    lab = -np.ones((SSD_BATCH, 3, 5), np.float32)
    lab[:, 0] = [0, 0.3, 0.3, 0.7, 0.7]
    ex.arg_dict["label"][:] = lab
    return net, ex


def ssd_kernel_regions(ex):
    """(the regions the fuse pass carved, how many take the kernel): the
    second counted as ``fused_matmul`` calls of one forward of the bound
    training graph on ``meta`` tensors (shapes only)."""
    import torch
    from mxnet_tpu_torch.executor import _GraphProgram
    from mxnet_tpu_torch.parallel import fused as F

    if ex._opt is None:
        return [], 0
    reports = {r["pass"]: r for r in ex._opt.reports}
    regions = reports.get("fuse", {}).get("detail", {}).get("regions", [])
    sym = ex._opt.symbol
    shapes = {k: tuple(v.shape) for k, v in ex.arg_dict.items()}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: torch.empty(s, device="meta")
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: torch.empty(s, device="meta")
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    calls = []
    real = F.fused_matmul

    def record(x, w, extras=(), epilogue=(), wt=True, out_dtype=None):
        calls.append(tuple(x.shape))
        return torch.empty((x.shape[0], w.shape[0] if wt else w.shape[1]),
                           device="meta")

    F.fused_matmul = record
    try:
        _GraphProgram(sym).infer_fn()(args, aux)
    finally:
        F.fused_matmul = real
    return regions, len(calls)


def ssd_step(ex):
    ex.forward(is_train=True)
    ex.backward()


def ssd_step_syncs(ex):
    """The host waits on the card in one training step (forward and
    backward) that torch's sync debug mode reports: [(file:line of the
    Python frame that made it)]."""
    import warnings
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ssd_step(ex)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return ["%s:%d" % (os.path.relpath(w.filename), w.lineno)
            for w in caught if "synchroniz" in str(w.message)]


def ssd_parity(captured, out):
    """(b): MultiBoxTarget and MultiBoxDetection of the first step run
    again on the CPU from the card's own inputs."""
    import torch
    from mxnet_tpu_torch.ops.registry import get_op

    res = {}
    for name in SSD_OPS[1:]:
        attrs, ins, card_outs = captured[name]
        with torch.no_grad():
            cpu = get_op(name).fn(attrs, *[t.cpu() for t in ins])
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        got = [t.cpu().numpy() for t in card_outs]
        want = [t.numpy() for t in cpu]
        if name.endswith("Target"):
            (loc_t, mask, cls_t), (w_loc, w_mask, w_cls) = got, want
            err = float(np.abs(loc_t - w_loc).max()
                        / max(1.0, np.abs(w_loc).max()))
            r = res["target"] = {
                "loc_target_err": err,
                "cls_target_differ": int((cls_t != w_cls).sum()),
                "cls_target_equal": bool(np.array_equal(cls_t, w_cls)),
                "mask_equal": bool(np.array_equal(mask, w_mask)),
                "positive": int((cls_t > 0).sum()),
                "negative": int((cls_t == 0).sum()),
                "ignored": int((cls_t < 0).sum())}
            ok = r["cls_target_equal"] and r["mask_equal"] and \
                err <= SSD_TARGET_TOL
            log("ssd (b): MultiBoxTarget, card vs CPU on the card's inputs: "
                "cls_target equal %s (%d differ), mask equal %s, "
                "loc_target %.3g of max(1, max); %d positive, %d negative, "
                "%d ignored anchors"
                % (r["cls_target_equal"], r["cls_target_differ"],
                   r["mask_equal"], err,
                   r["positive"], r["negative"], r["ignored"]))
        else:
            (det,), (w_det,) = got, want
            err = float(np.abs(det[..., 1:] - w_det[..., 1:]).max()
                        / max(1.0, np.abs(w_det[..., 1:]).max()))
            r = res["detection"] = {
                "ids_equal": bool(np.array_equal(det[..., 0],
                                                 w_det[..., 0])),
                "err": err, "kept": int((det[..., 0] >= 0).sum())}
            ok = r["ids_equal"] and err <= SSD_DET_TOL
            log("ssd (b): MultiBoxDetection, card vs CPU: ids and order "
                "equal %s, scores and boxes %.3g of max(1, max); %d of %d "
                "rows kept" % (r["ids_equal"], err, r["kept"],
                               det.shape[0] * det.shape[1]))
        if not ok:
            raise AssertionError("%s on the card differs from the CPU on "
                                 "the card's inputs: %s" % (name, res))
    out["parity"] = res


def ssd_detection_ms(captured, n=5):
    """Wall ms of one MultiBoxDetection call on the first step's inputs,
    synchronized: its sort, decode and the NMS loop's launches."""
    import torch
    from mxnet_tpu_torch.ops.registry import get_op

    attrs, ins, _outs = captured[SSD_OPS[2]]
    fn = get_op(SSD_OPS[2]).fn
    with torch.no_grad():
        fn(attrs, *ins)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(attrs, *ins)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def ssd_scope(names):
    """The family of a kernel of an SSD step from its op chain (innermost
    first), or None."""
    for n in names:
        if n == SSD_NMS_SCOPE:
            return "NMS loop"
        if n.startswith("ssd::"):
            return n[len("ssd::"):]
        low = n.lower()
        if "convolution" in low or "cudnn" in low:
            return "cuDNN conv"
        if "softmax" in low:
            return "softmax"
    return None


def ssd_families(prof, n_steps):
    """({family: device ms per step}, {family: kernels per step}, device ms
    per step, the ten longest kernels per step)."""
    import torch

    fams, counts, linked, by_name = {}, {}, {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        chain, up = [], ev
        while up is not None:
            chain.append(up.name)
            up = up.cpu_parent
        for k in ev.kernels:
            fam = ssd_scope(chain) or kernel_family(k.name)
            fams[fam] = fams.get(fam, 0.0) + k.duration
            counts[fam] = counts.get(fam, 0) + 1
            linked[k.name] = linked.get(k.name, 0.0) + k.duration
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False) or \
                ev.key.startswith("ssd::"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        by_name[ev.key] = by_name.get(ev.key, 0.0) + us
        rest = us - linked.get(ev.key, 0.0)
        if rest > 0:
            fam = kernel_family(ev.key)
            fams[fam] = fams.get(fam, 0.0) + rest
    total = sum(by_name.values())
    if not total:
        raise AssertionError("torch.profiler recorded no device time")
    per = 1e3 * n_steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return ({k: v / per for k, v in fams.items()},
            {k: v / n_steps for k, v in counts.items()}, total / per,
            [(k, v / per) for k, v in top])


def ssd_bench(mx, card, out):
    """(a)-(c): bench_ssd300's protocol on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import cuda_build

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    net, ex = ssd_bench_executor(mx)
    regions, kernel_regions = ssd_kernel_regions(ex)
    n_params = sum(int(np.prod(v.shape)) for k, v in ex.arg_dict.items()
                   if k not in ("data", "label"))
    log("ssd (a): bench_ssd300 on %s: SSD-300 VGG16-reduced, 20 classes, "
        "batch %d at %dx%d, %d parameters; fuse pass: %d regions carved "
        "(%s), %d of them on the kernel" % (
            card, SSD_BATCH, SSD_SIZE, SSD_SIZE, n_params, len(regions),
            ", ".join(sorted({" + ".join(r["ops"]) for r in regions})),
            kernel_regions))
    captured = {}
    with ssd_marks(captured):
        ssd_step(ex)
    forwards = 1
    outs = [o.asnumpy() for o in ex.outputs]
    names = net.list_outputs()
    want = [(SSD_BATCH, 21, SSD_ANCHORS), (SSD_BATCH, SSD_ANCHORS * 4),
            (SSD_BATCH, SSD_ANCHORS), (SSD_BATCH, SSD_ANCHORS, 6)]
    if [o.shape for o in outs] != want or \
            not all(np.isfinite(o).all() for o in outs):
        raise AssertionError("outputs %s: %s, finite %s" % (
            names, [o.shape for o in outs],
            [bool(np.isfinite(o).all()) for o in outs]))
    grads = {k: v._data for k, v in ex.grad_dict.items()
             if k not in ("data", "label")}
    zero = [k for k, g in grads.items() if not bool(g.abs().max() > 0)]
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    log("ssd (a): first step: outputs %s finite; %d of %d parameter "
        "gradients non-zero (zero: %s), all finite %s" % (
            names, len(grads) - len(zero), len(grads), zero or "none",
            finite))
    if not finite or len(zero) == len(grads):
        raise AssertionError("the SSD-300 gradients: zero %s, finite %s"
                             % (zero, finite))
    ssd_parity(captured, out)
    syncs = ssd_step_syncs(ex)
    forwards += 1
    out["step_syncs"] = syncs
    log("ssd (a): the MultiBox ops made no host wait (sync debug mode "
        "\"error\" around each); the whole step made %d: %s" % (
            len(syncs), sorted(set(syncs)) or "none"))

    # (c): 20 timed steps ended by the bench's fetch
    t0 = time.perf_counter()
    for _ in range(SSD_TIMED):
        ssd_step(ex)
    ex.outputs[0].asnumpy()
    dt = time.perf_counter() - t0
    forwards += SSD_TIMED
    with ssd_marks():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            t1 = time.perf_counter()
            for _ in range(SSD_PROFILED):
                ssd_step(ex)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3 / SSD_PROFILED
            time.sleep(PROFILE_MARGIN_S)
    forwards += SSD_PROFILED
    fams, counts, dev_ms, top = ssd_families(prof, SSD_PROFILED)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = cuda_build.launch_counts().get("fused_matmul", 0)
    res = out["bench"] = {
        "img_per_s": SSD_BATCH * SSD_TIMED / dt,
        "ms_per_step": dt * 1e3 / SSD_TIMED, "peak_gb": peak,
        "device_ms": dev_ms, "profiled_wall_ms": wall, "busy": dev_ms / wall,
        "families_ms": fams, "families_kernels": counts, "top": top,
        "regions": len(regions), "kernel_regions": kernel_regions,
        "fused_matmul_launches": launches, "forwards": forwards,
        "kernels_per_step": sum(counts.values())}
    log("ssd (c): %d timed steps: %.2f img/s, %.3f ms/step; peak memory "
        "%.3f GB above the earlier phases (%s)" % (
            SSD_TIMED, res["img_per_s"], res["ms_per_step"], peak, card))
    log("ssd (c): %d profiled steps: device %.3f ms/step in %.3f ms of "
        "wall (busy %.3f); by family, device ms (kernels) per step: %s" % (
            SSD_PROFILED, dev_ms, wall, res["busy"], ", ".join(
                "%s %.3f (%d)" % (k, v, counts.get(k, 0)) for k, v in
                sorted(fams.items(), key=lambda kv: -kv[1]))))
    res["device_over_timed_step"] = dev_ms / res["ms_per_step"]
    nms_k, nms_ms = counts.get("NMS loop", 0), fams.get("NMS loop", 0.0)
    res["detection_alone_ms"] = ssd_detection_ms(captured)
    log("ssd (c): device time over the unprofiled timed step %.3f; the NMS "
        "loop: %d kernels a step (%.3f of the step's %d), %.3f device ms "
        "(%.3f of its device time); MultiBoxDetection alone on the first "
        "step's inputs %.3f ms a call (wall, synchronized)" % (
            res["device_over_timed_step"], nms_k,
            nms_k / res["kernels_per_step"], res["kernels_per_step"],
            nms_ms, nms_ms / dev_ms, res["detection_alone_ms"]))
    for name, ms in top:
        log("ssd (c):   %.3f ms  %s" % (ms, name[:100]))
    log("ssd (a): fused_matmul launches over the phase's %d forwards: %d "
        "(the report's %d regions on the kernel x %d)" % (
            forwards, launches, kernel_regions, forwards))
    if launches != kernel_regions * forwards:
        raise AssertionError("fused_matmul launched %d times, the fuse "
                             "report says %d x %d" % (
                                 launches, kernel_regions, forwards))
    if not all(np.isfinite(o.asnumpy()).all() for o in ex.outputs):
        raise AssertionError("non-finite outputs after the timed steps")
    params = {k: v._data for k, v in ex.arg_dict.items()}
    first = [o._data.clone() for o in ex.outputs[:2]]
    del ex
    gc.collect()
    torch.cuda.empty_cache()

    # the same step without the fuse pass: no region recomputes its
    # convolution in the backward
    _net, plain = ssd_bench_executor(mx, passes="default,-fuse")
    for k, v in params.items():
        plain.arg_dict[k]._data.copy_(v)
    ssd_step(plain)
    gap = max(float((a._data - b).abs().max() / b.abs().max().clamp_min(1))
              for a, b in zip(plain.outputs[:2], first))
    plain.outputs[0].asnumpy()
    t0 = time.perf_counter()
    for _ in range(SSD_UNFUSED_TIMED):
        ssd_step(plain)
    plain.outputs[0].asnumpy()
    res["unfused_ms_per_step"] = \
        (time.perf_counter() - t0) * 1e3 / SSD_UNFUSED_TIMED
    res["unfused_output_gap"] = gap
    log("ssd (c): the fuse pass off: %.3f ms/step over %d steps (%.3f "
        "with it); cls_prob and loc_loss %.3g of max(1, max) apart" % (
            res["unfused_ms_per_step"], SSD_UNFUSED_TIMED,
            res["ms_per_step"], gap))
    if not gap <= 1e-4:
        raise AssertionError("the step with and without the fuse pass: "
                             "%.3g apart" % gap)


def ssd_toy_batch(rng, bs):
    """test_ssd_toy_convergence's batch: a bright square per image."""
    data = rng.rand(bs, 3, 32, 32).astype(np.float32) * 0.2
    lab = np.zeros((bs, 1, 5), np.float32)
    for i in range(bs):
        cx, cy = rng.uniform(0.3, 0.7, 2)
        x1, y1, x2, y2 = cx - 0.15, cy - 0.15, cx + 0.15, cy + 0.15
        lab[i, 0] = [0, x1, y1, x2, y2]
        data[i, :, int(y1 * 32):int(y2 * 32), int(x1 * 32):int(x2 * 32)] = 1.0
    return data, lab


def ssd_found(det, lab):
    """How many images' best detection covers their square at IoU > 0.4
    (tests/test_detection.py:221-242)."""
    found = 0
    for i in range(det.shape[0]):
        rows = det[i][det[i][:, 0] >= 0]
        if len(rows) == 0:
            continue
        best = rows[np.argmax(rows[:, 1])]
        gt = lab[i, 0, 1:]
        ix1, iy1 = np.maximum(best[2:4], gt[:2])
        ix2, iy2 = np.minimum(best[4:6], gt[2:])
        inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
        union = ((best[4] - best[2]) * (best[5] - best[3])
                 + (gt[2] - gt[0]) * (gt[3] - gt[1]) - inter)
        if union > 0 and inter / union > 0.4:
            found += 1
    return found


def ssd_toy(mx, card, out):
    """(d): tests/test_detection.py:162's toy SSD on the card, then its
    trained weights bound in inference mode."""
    import torch
    from mxnet_tpu_torch.models.ssd import get_ssd, tiny_features

    bs = 8
    rng = np.random.RandomState(0)
    net = get_ssd(mode="train", features=tiny_features, **SSD_TOY)
    ex = net.simple_bind(mx.gpu(), data=(bs, 3, 32, 32), label=(bs, 1, 5),
                         grad_req="write")
    for k, v in ex.arg_dict.items():
        if k not in ("data", "label"):
            v[:] = (rng.randn(*v.shape) * 0.05).astype(np.float32)
    data, lab = ssd_toy_batch(rng, bs)
    ex.arg_dict["data"][:] = data
    ex.arg_dict["label"][:] = lab
    grads = {k: v for k, v in ex.grad_dict.items()
             if k not in ("data", "label")}
    losses = []
    t0 = time.perf_counter()
    for _ in range(SSD_TOY_STEPS):
        ssd_step(ex)
        ct = ex.outputs[2]._data
        cp = ex.outputs[0]._data
        valid = ct >= 0
        picked = cp.gather(1, ct.clamp_min(0).long()[:, None, :])[:, 0]
        losses.append(-(torch.log(picked.clamp_min(1e-8)) * valid).sum()
                      / valid.sum())
        with torch.no_grad():
            for k, g in grads.items():
                ex.arg_dict[k]._data.sub_(0.01 * g._data.clamp(-1, 1))
    losses = torch.stack(losses).cpu().numpy().astype(float)
    dt = time.perf_counter() - t0
    final = float(np.mean(losses[-10:]))
    ex.forward(is_train=True)
    found = ssd_found(ex.outputs[3].asnumpy(), lab)
    res = out["toy"] = {"first_loss": float(losses[0]), "final_loss": final,
                        "found": found,
                        "ms_per_step": dt * 1e3 / SSD_TOY_STEPS}
    log("ssd (d): toy SSD on %s, %d clipped SGD steps (%.3f ms/step): cls "
        "loss %.4f -> %.4f (last 10), %d of %d squares at IoU > 0.4" % (
            card, SSD_TOY_STEPS, res["ms_per_step"], losses[0], final,
            found, bs))
    if not (final < losses[0] * 0.9 and found >= 3):
        raise AssertionError("the toy SSD: loss %.4f -> %.4f, found %d"
                             % (losses[0], final, found))
    inet = get_ssd(mode="inference", features=tiny_features, **SSD_TOY)
    iex = inet.simple_bind(mx.gpu(), data=(bs, 3, 32, 32), grad_req="null")
    for k, v in iex.arg_dict.items():
        if k != "data":
            v._data.copy_(ex.arg_dict[k]._data)
    iex.arg_dict["data"][:] = data
    det = iex.forward(is_train=False)[0].asnumpy()
    res["inference_found"] = ssd_found(det, lab)
    res["inference_kept"] = int((det[..., 0] >= 0).sum())
    log("ssd (d): inference bind on the trained weights: detections %s, "
        "%d rows kept, %d of %d squares at IoU > 0.4" % (
            det.shape, res["inference_kept"], res["inference_found"], bs))
    if det.shape != (bs, 640, 6) or not np.isfinite(det).all() or \
            not res["inference_kept"]:
        raise AssertionError("the inference detections: %s, kept %d"
                             % (det.shape, res["inference_kept"]))


def ssd_op_cases():
    """(e): (op, inputs, differentiated inputs, attrs, exact outputs) at
    the JAX tests' shapes (tests/test_detection.py,
    tests/test_linalg_spatial.py). ``exact``: {output: its column, or None
    for all of it} that must equal the CPU's; Proposal's scores are its
    input values copied into the chosen rows, in their order."""
    r = np.random.RandomState(0)
    f32 = np.float32
    ramp = np.arange(32, dtype=f32).reshape(1, 2, 4, 4)
    tied = np.zeros((1, 1, 4, 4), f32)
    tied[0, 0, 1, 0] = tied[0, 0, 1, 1] = 9.0
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                         [0.0, 0.5, 0.5, 1.0], [0.5, 0.0, 1.0, 0.5],
                         [0.2, 0.2, 0.4, 0.4], [0.6, 0.6, 0.8, 0.8]]], f32)
    lab = np.full((1, 2, 5), -1.0, f32)
    lab[0, 0] = [0, 0.0, 0.0, 0.5, 0.5]
    c = r.uniform(0.1, 0.9, (60, 2))
    half = r.uniform(0.05, 0.3, (60, 2))
    det_anchors = np.concatenate([c - half, c + half], 1)[None].astype(f32)
    logits = r.randn(2, 4, 60) * 2
    e = np.exp(logits - logits.max(1, keepdims=True))
    prop = dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=8, rpn_min_size=4,
                scales=(2.0, 4.0), ratios=(0.5, 1.0, 2.0), feature_stride=16,
                output_score=True)
    prop_in = [r.rand(2, 12, 4, 4).astype(f32),
               (r.randn(2, 24, 4, 4) * 0.1).astype(f32),
               np.array([[64, 64, 1.0]] * 2, f32)]
    og = np.ogrid[:4, :4]
    bil = np.zeros((3, 1, 4, 4), f32)
    bil[:, 0] = (1 - abs(og[0] / 2.0 - 0.75)) * (1 - abs(og[1] / 2.0 - 0.75))
    ident = np.tile(np.array([1, 0, 0, 0, 1, 0], f32), (2, 1))
    return [
        ("_contrib_MultiBoxPrior", [np.zeros((1, 8, 2, 3), f32)], (),
         dict(sizes=(0.5, 0.3), ratios=(1.0, 2.0, 0.5)), {0: None}),
        ("_contrib_MultiBoxTarget",
         [anchors, lab, r.randn(1, 3, 6).astype(f32)], (0, 1),
         dict(negative_mining_ratio=1.0, negative_mining_thresh=0.5),
         {1: None, 2: None}),
        ("_contrib_MultiBoxDetection",
         [(e / e.sum(1, keepdims=True)).astype(f32),
          (r.randn(2, 240) * 0.5).astype(f32), det_anchors], (0, 1, 2),
         dict(nms_topk=30), {0: 0}),
        ("ROIPooling", [ramp, np.array([[0, 0, 0, 3, 3], [0, 2, 2, 3, 3]],
                                       f32)], (0,),
         dict(pooled_size=(2, 2), spatial_scale=1.0), {}),
        ("ROIPooling", [tied, np.array([[0, 0, 0, 3, 3]], f32)], (0,),
         dict(pooled_size=(2, 2), spatial_scale=1.0), {}),
        ("_contrib_Proposal", prop_in, (), prop, {0: 0, 1: None}),
        ("_contrib_MultiProposal", prop_in, (), prop, {0: 0, 1: None}),
        ("_contrib_ROIAlign_v2", [ramp, np.array([[0, 0, 0, 3, 3]], f32)],
         (0,), dict(pooled_size=(2, 2), spatial_scale=1.0), {}),
        ("_contrib_PSROIPooling", [r.rand(1, 8, 6, 6).astype(f32),
                                   np.array([[0, 0, 0, 5, 5]], f32)], (0,),
         dict(spatial_scale=1.0, output_dim=2, pooled_size=2), {}),
        ("_contrib_DeformableConvolution",
         [r.randn(2, 4, 6, 6).astype(f32),
          (r.randn(2, 18, 4, 4) * 1.3).astype(f32),
          r.randn(3, 4, 3, 3).astype(f32), r.randn(3).astype(f32)],
         (0, 1, 2, 3), dict(kernel=(3, 3), num_filter=3), {}),
        ("_contrib_DeformablePSROIPooling",
         [r.randn(2, 8, 10, 12).astype(f32),
          np.array([[0, 1, 1, 8, 9], [1, 2, 0, 11, 7]], f32),
          (r.rand(2, 2, 3, 3) - 0.5).astype(f32)], (0, 2),
         dict(spatial_scale=0.5, output_dim=2, group_size=2, pooled_size=3,
              sample_per_part=2, trans_std=0.3), {}),
        ("GridGenerator", [ident], (0,),
         dict(transform_type="affine", target_shape=(5, 7)), {}),
        ("GridGenerator", [r.randn(2, 2, 5, 7).astype(f32)], (0,),
         dict(transform_type="warp"), {}),
        ("BilinearSampler", [r.randn(2, 3, 5, 7).astype(f32),
                             r.uniform(-1.3, 1.3, (2, 2, 5, 7)).astype(f32)],
         (0, 1), {}, {}),
        ("SpatialTransformer", [r.randn(2, 3, 6, 6).astype(f32),
                                ident + r.randn(2, 6).astype(f32) * 0.3],
         (0, 1), dict(target_shape=(6, 6), transform_type="affine",
                      sampler_type="bilinear"), {}),
        ("UpSampling", [np.ones((1, 1, 4, 4), f32),
                        np.ones((1, 1, 2, 2), f32) * 2], (0, 1),
         dict(scale=2, sample_type="nearest", num_args=2), {}),
        ("UpSampling", [r.randn(1, 3, 4, 4).astype(f32), bil], (0, 1),
         dict(scale=2, sample_type="bilinear", num_filter=3, num_args=2),
         {}),
        ("SVMOutput", [np.array([[2.0, -2.0, 0.5]], f32),
                       np.array([0.0], f32)], (0,), dict(margin=1.0), {}),
        ("SVMOutput", [np.array([[0.5, -0.5]], f32), np.array([0.0], f32)],
         (0,), dict(margin=1.0, use_linear=True,
                    regularization_coefficient=0.5), {}),
    ]


def ssd_op_run(mx, op, arrays, grad, attrs, ctx):
    """(outputs, gradients of the ``grad`` inputs) as numpy: one call under
    ``autograd.record`` on ``ctx``, then a backward with seeded heads over
    the outputs the op records."""
    fn = getattr(mx.nd._internal if op.startswith("_") else mx.nd, op)
    ins = [mx.nd.array(a, ctx=ctx) for a in arrays]
    for i in grad:
        ins[i].attach_grad()
    with mx.autograd.record():
        if ctx.device_type == "gpu":
            with no_host_sync():
                out = fn(*ins, **attrs)
        else:
            out = fn(*ins, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    values = [o.asnumpy() for o in outs]
    rng = np.random.RandomState(7)
    heads = [mx.nd.array(rng.randn(*v.shape).astype(np.float32), ctx=ctx)
             for v in values]
    live = [(o, h) for o, h in zip(outs, heads) if o._data.requires_grad]
    if grad and live:
        mx.autograd.backward([o for o, _ in live], [h for _, h in live])
    return values, [ins[i].grad.asnumpy() for i in grad]


def ssd_op_grid(mx):
    """(e): each case on the card against the same op on the CPU, forward
    and gradients within SSD_OP_TOL of each tensor's max |CPU value|;
    ids, masks, ranks and Proposal's rows equal. Returns (cases, (the worst
    error, where))."""
    worst = (0.0, None)
    cases = ssd_op_cases()
    for op, arrays, grad, attrs, exact in cases:
        with mx.cpu():
            want = ssd_op_run(mx, op, arrays, grad, attrs, mx.cpu())
        got = ssd_op_run(mx, op, arrays, grad, attrs, mx.gpu())
        tensors = [("output %d" % i, i, g, w) for i, (g, w) in
                   enumerate(zip(got[0], want[0]))] + \
            [("d input %d" % i, None, g, w)
             for i, g, w in zip(grad, got[1], want[1])]
        for what, i, g, w in tensors:
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError("%s %s: %s %s on the card, %s %s on "
                                     "the CPU" % (op, what, g.shape, g.dtype,
                                                  w.shape, w.dtype))
            if i in exact:
                col = exact[i]
                ge, we = (g, w) if col is None else (g[..., col],
                                                     w[..., col])
                if not np.array_equal(ge, we):
                    raise AssertionError("%s %s: not equal to the CPU's"
                                         % (op, what))
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
            err = float(np.abs(g - w).max(initial=0.0)) / scale
            if err > worst[0]:
                worst = (err, "%s %s %s" % (op, attrs, what))
    if worst[0] > SSD_OP_TOL:
        raise AssertionError("op grid: %s differs from the CPU by %.3g of "
                             "its max" % (worst[1], worst[0]))
    return len(cases), worst


def ssd_phase(mx, card, results):
    """Phase 15: SSD-300 through bench_ssd300's protocol, the toy SSD's
    convergence, and the slice's other ops on the card."""
    out = {}
    ssd_bench(mx, card, out)
    ssd_toy(mx, card, out)
    n, worst = ssd_op_grid(mx)
    out["op_grid"] = {"cases": n, "worst": worst[0], "where": worst[1]}
    log("ssd (e): %d op cases on the card against the CPU, forward and "
        "gradients: worst %.3g of its max (%s); ids, masks, ranks and "
        "Proposal's rows equal" % (n, worst[0], worst[1]))
    results["ssd"] = out
    return out


# ------------------------------------------------- phase 16: the model zoo
# bench_all.py:153-211 bench_gluon_resnet's protocol with the network
# swapped for each model-zoo family's headline member (1000 classes,
# NCHW fp32 with TF32 off, batch 32, hybridized, SGD 0.05,
# kvstore="local", Trainer.compile_step)
ZOO_NETS = (("alexnet", 224), ("vgg16", 224), ("squeezenet1_0", 224),
            ("mobilenet1_0", 224), ("densenet121", 224),
            ("inception_v3", 299))
# the JAX package's published parameter counts (tests/test_gluon.py:350-360)
ZOO_PUBLISHED = {"alexnet": 61100840, "vgg16": 138357544,
                 "squeezenet1_0": 1248424, "mobilenet1_0": 4253864,
                 "densenet121": 8062504, "inception_v3": 23869000}
# the two nets without BatchNorm train at a fifth of the protocol's rate:
# at SGD 0.05 VGG16's loss went 6.9 -> 948 -> 6.7e11 -> NaN in four steps
# and AlexNet's swung between 6 and 97 (CPU, Xavier init)
ZOO_LR = {"alexnet": 0.01, "vgg16": 0.01}
ZOO_TIMED, ZOO_EAGER_TIMED, ZOO_LEARN, ZOO_PROFILED = 20, 3, 12, 2
ZOO_STEP_TOL = 1e-5      # (a): first compile_step step vs the eager tape
# (b): the CTC head: gluon.rnn.LSTM 2 x 256 (TNC) -> Dense(11) ->
# CTCLoss, T 80, batch 32, 40 input features, labels of length 4-8
CTC_T, CTC_BATCH, CTC_FEATURES, CTC_HIDDEN, CTC_CLASSES = 80, 32, 40, 256, 11
CTC_STEPS, CTC_TOL = 10, 1e-5
CTC_WARM = 2             # steps before the timed ones (CTC_STEPS - CTC_WARM)
# (c): the op cases, the card against the CPU (phase 12's bars)
ZOO_OP_TOL, ZOO_SUM_TOL = 1e-6, 1e-5
# FlowNetC's correlation layer and the SPN / SCN size
FLOWNETC = dict(pad_size=20, kernel_size=1, max_displacement=20, stride1=1,
                stride2=2)
FLOWNETC_SHAPE = (8, 256, 48, 64)
SPN_SHAPE = (4, 32, 128, 128)
ZOO_OPT_TOL = 1e-6       # (d): 5 trainer.step updates, card vs CPU


def zoo_scope(name):
    """The family a model-zoo step's op scope names, or None."""
    n = name.lower()
    if "batchnorm" in n or "batch_norm" in n:
        return "BN"
    if name == RN_SCOPES[1]:
        return "optimizer update"
    if "convolution" in n:
        return "cuDNN conv"
    if "constant_pad" in n or "constantpad" in n:
        return "pad (avg pools)"
    if "pool" in n:
        return "pooling"
    if "addmm" in n or "linear" in n or n.endswith("::mm"):
        return "cuBLAS FC"
    if "cat" == n.split("::")[-1]:
        return "concat"
    return None


def zoo_net(mx, name, size):
    """(net, x, y): the family's member on the card, Xavier init (the
    zoo's own initializers where it names them) after mx.random.seed(0)
    and np.random.seed(0), with RandomState(0) data. The bench's default
    init (uniform 0.07) makes AlexNet's logits explode at SGD 0.05 (its
    loss 2.3e29 after one step, then NaN); Xavier keeps every net's loss
    finite at the protocol's rate."""
    mx.random.seed(0)
    np.random.seed(0)
    net = mx.gluon.model_zoo.vision.get_model(name, classes=GL_CLASSES)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu())
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(GL_BATCH, 3, size, size).astype(np.float32),
                    ctx=mx.gpu())
    y = mx.nd.array(rng.randint(0, GL_CLASSES, GL_BATCH).astype(np.float32),
                    ctx=mx.gpu())
    return net, x, y


def zoo_replay_vs_body(step, net, trainer, x, y):
    """:func:`gl_replay_vs_body` with the card's generator put back: the
    eager body starts from the generator state the replay started from,
    so a Dropout draws the replay's mask (torch's graph-safe Philox reads
    the seed and offset at each replay). The step must be captured."""
    import torch

    trainer._materialize_states(trainer._live_params())
    s0 = gl_snapshot(net, trainer)
    rng0 = torch.cuda.get_rng_state()
    loss_g = step(x, y)._data.clone()
    graph = gl_snapshot(net, trainer)
    gl_restore(net, trainer, s0)
    rng1 = torch.cuda.get_rng_state()
    torch.cuda.set_rng_state(rng0)
    loss_e, new_w, new_s, new_aux = step._step_eager(x, y, step._scalars)
    step._write_back(step._tensors(x.context), new_w, new_s, new_aux)
    torch.cuda.set_rng_state(rng1)
    trainer._optimizer._index_update_count = dict(graph[1][0])
    trainer._optimizer.num_update = graph[1][1]
    eager = gl_snapshot(net, trainer)
    torch.cuda.synchronize()
    return compare_tensors(graph[0], eager[0]) + (torch_equal(loss_g,
                                                              loss_e),)


def zoo_first_step(mx, step, net, trainer, loss_fn, x, y):
    """The first compile_step step (a replay, after a capture whose
    effects are undone) against the eager tape's first step, both from the
    initial state and the same generator state: (loss error, worst
    tensor error, its name, bit-identical tensors, tensors)."""
    import torch

    trainer._materialize_states(trainer._live_params())
    s0 = gl_snapshot(net, trainer)
    step(x, y)                                   # capture
    gl_restore(net, trainer, s0)
    rng0 = torch.cuda.get_rng_state()
    loss_c = step(x, y)._data.clone()
    compiled = gl_snapshot(net, trainer)
    gl_restore(net, trainer, s0)
    torch.cuda.set_rng_state(rng0)
    loss_t = gl_eager_step(mx, net, trainer, loss_fn, x, y)._data.detach()
    tape = gl_snapshot(net, trainer)
    same, total, worst, name = compare_tensors(tape[0], compiled[0])
    loss_err = float((loss_t - loss_c).abs().max() / loss_c.abs().max())
    return loss_err, worst, name, same, total


def zoo_profiled_eager(mx, net, trainer, loss_fn, x, y):
    """ZOO_PROFILED eager-tape steps under torch.profiler, the BatchNorm
    op and the optimizer update marked as scopes: (families, device ms,
    top kernels, spans) per step."""
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
            for _ in range(ZOO_PROFILED):
                gl_eager_step(mx, net, trainer, loss_fn, x, y)
            torch.cuda.synchronize()
    finally:
        bn.fn = real_bn
        del trainer._fused_local_step
    return device_families(prof, ZOO_PROFILED, scope_family=zoo_scope)


def zoo_depthwise_route(top):
    """Which kernels ran mobilenet's depthwise convolutions, by name."""
    names = [k for k, _ in top]
    if any("depthwise" in k.lower() for k in names):
        return "torch's own depthwise kernels (conv_depthwise2d)"
    return "cuDNN (no torch depthwise kernel among the top kernels)"


def zoo_train(mx, name, size, card):
    """(a) for one net; returns its record."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    net, x, y = zoo_net(mx, name, size)
    imperative = net(x)._data.float()
    n_params = sum(int(np.prod(p.shape))
                   for p in net.collect_params().values())
    if n_params != ZOO_PUBLISHED[name]:
        raise AssertionError("%s: %d parameters, published %d"
                             % (name, n_params, ZOO_PUBLISHED[name]))
    net.hybridize()
    hybrid = net(x)._data.float()
    fwd_err = float((hybrid - imperative).abs().max()
                    / imperative.abs().max())
    if not fwd_err <= GL_FWD_TOL:
        raise AssertionError("%s: hybridized forward differs by %.3g"
                             % (name, fwd_err))
    rec = dict(parameters=n_params, size=size, forward_err=fwd_err)
    lr = ZOO_LR.get(name, GL_LR)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": lr}, kvstore="local")
    rec["lr"] = lr
    try:
        torch.backends.cudnn.deterministic = True
        step = trainer.compile_step(net, loss_fn)
        loss_err, worst, wname, same, total = zoo_first_step(
            mx, step, net, trainer, loss_fn, x, y)
        if not (loss_err <= ZOO_STEP_TOL and worst <= ZOO_STEP_TOL):
            raise AssertionError("%s: first compile_step step vs the eager "
                                 "tape: loss %.3g, %s at %.3g"
                                 % (name, loss_err, wname, worst))
        rec["first_step"] = dict(loss_err=loss_err, worst=worst,
                                 worst_name=wname, identical=same,
                                 tensors=total)
        same, total, worst, wname, loss_same = zoo_replay_vs_body(
            step, net, trainer, x, y)
        if same != total or not loss_same:
            raise AssertionError("%s: replay differs from its body: %s at "
                                 "%.3g (%d of %d equal)"
                                 % (name, wname, worst, same, total))
        rec["replay_vs_body"] = dict(identical=same, tensors=total)
        losses = [float(step(x, y).asnumpy().mean())
                  for _ in range(ZOO_LEARN)]
        # the Dropout nets' losses are noisy step to step: the mean of the
        # last three against the first three's
        if not np.all(np.isfinite(losses)) or \
                not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError("%s: the loss did not fall: %s"
                                 % (name, losses))
        rec["losses"] = losses
        rec["captures_deterministic"] = step.compile_count
        del step
    finally:
        torch.backends.cudnn.deterministic = False
    step = trainer.compile_step(net, loss_fn)
    step(x, y).asnumpy()                         # capture + warm
    t0 = time.perf_counter()
    for _ in range(ZOO_TIMED):
        loss = step(x, y)
    loss.asnumpy()
    dt = time.perf_counter() - t0
    replay_dev, replay_wall = gl_profiled_replays(step, x, y)
    gl_eager_step(mx, net, trainer, loss_fn, x, y).asnumpy()   # warm
    t0 = time.perf_counter()
    for _ in range(ZOO_EAGER_TIMED):
        loss_e = gl_eager_step(mx, net, trainer, loss_fn, x, y)
    loss_e.asnumpy()
    eager_dt = time.perf_counter() - t0
    fams, dev_ms, top, _spans = zoo_profiled_eager(mx, net, trainer,
                                                   loss_fn, x, y)
    rec.update(
        compile_step_img_s=GL_BATCH * ZOO_TIMED / dt,
        compile_step_ms=dt * 1e3 / ZOO_TIMED,
        eager_img_s=GL_BATCH * ZOO_EAGER_TIMED / eager_dt,
        eager_ms=eager_dt * 1e3 / ZOO_EAGER_TIMED,
        replay_device_ms=replay_dev, replay_profiled_wall_ms=replay_wall,
        busy=replay_dev / replay_wall if replay_dev else None,
        eager_device_ms=dev_ms, eager_families_ms=fams,
        eager_top_kernels_ms=top, captures=step.compile_count,
        peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    if step.compile_count != 1:
        raise AssertionError("%s: compile_step captured %d times"
                             % (name, step.compile_count))
    if name.startswith("mobilenet"):
        rec["depthwise_route"] = zoo_depthwise_route(top)
    log("zoo (a): %s %dx%d, %d parameters (published): hybridized vs "
        "imperative %.3g; deterministic cuDNN: first compile_step step vs "
        "the eager tape loss %.3g, worst %s %.3g (%d of %d bit-identical); "
        "replay vs its body %d of %d bit-identical; loss %.4f -> %.4f over "
        "%d steps" % (name, size, size, n_params, fwd_err,
                      rec["first_step"]["loss_err"],
                      rec["first_step"]["worst_name"],
                      rec["first_step"]["worst"],
                      rec["first_step"]["identical"],
                      rec["first_step"]["tensors"],
                      rec["replay_vs_body"]["identical"],
                      rec["replay_vs_body"]["tensors"], losses[0],
                      losses[-1], ZOO_LEARN))
    log("zoo (a): %s default algorithms: compile_step %.1f img/s (%.3f "
        "ms/step), replay device %s ms (busy %s), eager tape %.1f img/s "
        "(%.3f ms/step, device %.3f ms: %s), peak %.3f GB, %s%s" % (
            name, rec["compile_step_img_s"], rec["compile_step_ms"],
            "%.3f" % replay_dev if replay_dev else "not measured",
            "%.3f" % rec["busy"] if rec["busy"] else "not measured",
            rec["eager_img_s"], rec["eager_ms"], dev_ms,
            ", ".join("%s %.3f" % kv for kv in sorted(
                fams.items(), key=lambda kv: -kv[1])),
            rec["peak_gb"], card,
            "; depthwise: " + rec["depthwise_route"]
            if "depthwise_route" in rec else ""))
    del step, trainer, net, x, y
    torch.cuda.empty_cache()
    return rec


def ctc_batch(mx, rng, ctx):
    """(features, labels 0-padded, label lengths) of one CTC batch."""
    lens = rng.randint(4, 9, CTC_BATCH)
    lab = np.zeros((CTC_BATCH, 8), np.float32)
    for i, k in enumerate(lens):
        lab[i, :k] = rng.randint(1, CTC_CLASSES, k)
    feats = rng.randn(CTC_T, CTC_BATCH, CTC_FEATURES).astype(np.float32)
    return (mx.nd.array(feats, ctx=ctx), mx.nd.array(lab, ctx=ctx),
            mx.nd.array(lens.astype(np.float32), ctx=ctx))


def ctc_against_cpu(mx, pred, label, extra, attrs):
    """The op on the card (the library route) against the CPU's recursion
    on the card's own inputs: (loss error, each sample's over max(1, its
    |loss|): an infeasible sample's 1e30 must not hide the others'; the
    gradient's over its max), the card's loss."""
    outs = []
    for ctx in (mx.gpu(), mx.cpu()):
        p = mx.nd.array(pred, ctx=ctx)
        p.attach_grad()
        ins = [mx.nd.array(a, ctx=ctx) for a in [label] + extra]
        with mx.autograd.record():
            loss = mx.nd.ctc_loss(p, *ins, **attrs)
        loss.backward(mx.nd.array(np.linspace(0.5, 1.5, loss.shape[0]),
                                  dtype="float64", ctx=ctx))
        outs.append((loss.asnumpy(), p.grad.asnumpy()))
    (lg, gg), (lc, gc_) = outs
    errs = (float((np.abs(lg - lc) / np.maximum(np.abs(lc), 1.0)).max()),
            float(np.abs(gg - gc_).max() / max(np.abs(gc_).max(), 1e-30)))
    return errs, lg


def ctc_routes(mx, pred, label, lens):
    """The op's forward + backward on the card (the library's CTC) and
    the plain recursion on the same card tensors, timed with CUDA events:
    {route: ms}."""
    import torch
    from mxnet_tpu_torch.ops.contrib import ctc_recursion
    from mxnet_tpu_torch.ops.registry import get_op

    opdef = get_op("ctc_loss")
    attrs = opdef.parse_attrs({"use_label_lengths": True})
    data = pred._data.detach().requires_grad_(True)
    lab, n = label._data, lens._data

    def library():
        (loss,), _ = opdef.apply(attrs, (data, lab, n))
        loss.sum().backward()

    def plain():
        lab64 = lab.to(torch.int64).clamp(0, CTC_CLASSES - 1)
        full = lab64.new_full((CTC_BATCH,), CTC_T)
        ctc_recursion(data, lab64, full, n.to(lab64.dtype), 0).sum() \
            .backward()

    return {"library_ms": time_events_ms(library, reps=5),
            "recursion_ms": time_events_ms(plain, reps=3)}


def ctc_phase(mx, card):
    """(b): a CTC head trained on the eager tape, and the op's edges."""
    import torch

    gluon = mx.gluon
    mx.random.seed(0)
    np.random.seed(0)
    net = gluon.nn.Sequential(prefix="ctc_")
    with net.name_scope():
        net.add(gluon.rnn.LSTM(CTC_HIDDEN, num_layers=2, layout="TNC",
                               input_size=CTC_FEATURES))
        net.add(gluon.nn.Dense(CTC_CLASSES, flatten=False,
                               in_units=CTC_HIDDEN))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu())
    loss_fn = gluon.loss.CTCLoss(layout="TNC", label_layout="NT")
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01}, kvstore="local")
    x, label, lens = ctc_batch(mx, np.random.RandomState(0), mx.gpu())
    out = {}
    losses, step_ms = [], []
    for i in range(CTC_STEPS):
        if i == 0:
            pred = net(x)
            errs, _ = ctc_against_cpu(
                mx, pred.asnumpy(), label.asnumpy(), [lens.asnumpy()],
                dict(use_label_lengths=True))
            if max(errs) > CTC_TOL:
                raise AssertionError("ctc: the card's loss / gradient vs "
                                     "the CPU recursion: %s" % (errs,))
            out["first_batch_vs_cpu"] = dict(loss_err=errs[0],
                                             grad_err=errs[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), label, None, lens)
        loss.backward()
        trainer.step(CTC_BATCH)
        losses.append(float(loss.asnumpy().mean()))
        if i >= CTC_WARM:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("ctc: the loss did not fall: %s" % losses)
    out["losses"] = losses
    out["step_ms"] = step_ms
    out["step_ms_median"] = float(np.median(step_ms))
    out["routes"] = ctc_routes(mx, net(x), label, lens)
    # the edges, each on the card against the CPU recursion
    rng = np.random.RandomState(1)
    data = rng.randn(12, 4, 6).astype(np.float32)
    # rows 0 and 2 need 13 of the 12 steps (a blank between repeats)
    infeasible = np.array([[1, 1, 1, 1, 2, 2, 3, 3], [2, 0, 0, 0, 0, 0, 0, 0],
                           [3, 3, 3, 3, 3, 3, 3, 0], [0] * 8], np.float32)
    errs, lg = ctc_against_cpu(mx, data, infeasible, [], {})
    if max(errs) > CTC_TOL or not (lg[0] >= 1e29 and lg[2] >= 1e29
                                   and lg[1] < 1e3 and lg[3] < 1e3):
        raise AssertionError("ctc: infeasible / zero-length: losses %s, "
                             "errors %s" % (lg, errs))
    out["infeasible_zero_length"] = dict(losses=lg.tolist(),
                                         loss_err=errs[0], grad_err=errs[1])
    last = np.full((4, 5), -1, np.float32)
    last[0, :3], last[1, :5], last[2, :1] = [0, 4, 4], [1, 2, 3, 0, 1], [2]
    errs, lg = ctc_against_cpu(mx, data[:, :, :6], last,
                               [np.array([12, 9, 10, 12], np.float32)],
                               dict(blank_label="last",
                                    use_data_lengths=True))
    if max(errs) > CTC_TOL:
        raise AssertionError("ctc: blank_label='last': %s" % (errs,))
    out["blank_last"] = dict(loss_err=errs[0], grad_err=errs[1])
    log("zoo (b): CTC head (LSTM 2 x %d TNC, Dense(%d), CTCLoss with "
        "label_lengths), T %d batch %d on %s: first batch vs the CPU "
        "recursion loss %.3g grad %.3g; loss %s over %d eager-tape steps "
        "(the last %d: median %.3f ms, %.3f-%.3f; the op's forward + "
        "backward on the library's CTC "
        "%.3f ms, on the plain recursion %.3f ms); infeasible %.4g / "
        "zero-length %.4f vs CPU %.3g / %.3g; blank_label='last' %.3g / "
        "%.3g" % (
            CTC_HIDDEN, CTC_CLASSES, CTC_T, CTC_BATCH, card,
            out["first_batch_vs_cpu"]["loss_err"],
            out["first_batch_vs_cpu"]["grad_err"],
            " ".join("%.3f" % v for v in losses), CTC_STEPS,
            len(step_ms), out["step_ms_median"], min(step_ms), max(step_ms),
            out["routes"]["library_ms"],
            out["routes"]["recursion_ms"], out["infeasible_zero_length"]["losses"][0],
            out["infeasible_zero_length"]["losses"][3],
            out["infeasible_zero_length"]["loss_err"],
            out["infeasible_zero_length"]["grad_err"],
            out["blank_last"]["loss_err"], out["blank_last"]["grad_err"]))
    return out


def zoo_op_cases():
    """(c): (op, inputs, differentiated inputs, attrs, held as a sum) of
    every op this slice registers, at small shapes."""
    r = np.random.RandomState(0)
    f32 = np.float32

    def rn(*s):
        return r.randn(*s).astype(f32)

    def lengths(n, hi):
        return r.randint(1, hi + 1, n).astype(f32)

    spd = rn(4, 16, 16)
    spd = spd @ spd.transpose(0, 2, 1) + 16 * np.eye(16, dtype=f32)
    low = np.tril(rn(4, 16, 16)) * 0.2 + 2 * np.eye(16, dtype=f32)
    q, _ = np.linalg.qr(r.randn(4, 16, 16))
    eig = ((q * np.arange(1, 17)) @ q.transpose(0, 2, 1)).astype(f32)
    gates = [r.uniform(-0.4, 0.4, (2, 4, 9, 11)).astype(f32)
             for _ in range(3)]
    spn_in = [rn(2, 4, 9, 11)] + gates
    cases = [
        ("LinearRegressionOutput", [rn(8, 5), rn(8, 5)], (0,), {}, False),
        ("LogisticRegressionOutput", [rn(8, 5), r.rand(8, 5).astype(f32)],
         (0,), {}, False),
        ("MAERegressionOutput", [rn(8, 5), rn(8, 5)], (0,),
         {"grad_scale": 0.5}, False),
        ("L2Normalization", [rn(4, 6, 5, 5)], (0,), {"mode": "instance"},
         True),
        ("L2Normalization", [rn(4, 6, 5, 5)], (0,), {"mode": "channel"},
         True),
        ("L2Normalization", [rn(4, 6, 5, 5)], (0,), {"mode": "spatial"},
         True),
        ("LRN", [rn(2, 8, 6, 6)], (0,), {"nsize": 5}, True),
        ("InstanceNorm", [rn(3, 4, 7, 7), rn(4), rn(4)], (0, 1, 2), {},
         True),
        ("SequenceMask", [rn(7, 5, 3), lengths(5, 7)], (0,),
         {"use_sequence_length": True, "value": -2.0}, False),
        ("SequenceLast", [rn(7, 5, 3), lengths(5, 7)], (0,),
         {"use_sequence_length": True}, False),
        ("SequenceReverse", [rn(7, 5, 3), lengths(5, 7)], (0,),
         {"use_sequence_length": True}, False),
        ("Crop", [rn(2, 3, 9, 9)], (0,), {"h_w": (5, 4), "offset": (1, 3)},
         False),
        ("Crop", [rn(2, 3, 9, 9), rn(2, 1, 4, 6)], (0,),
         {"num_args": 2, "center_crop": True}, False),
        ("IdentityAttachKLSparseReg",
         [r.rand(6, 10).astype(f32), np.full(10, 0.3, f32)], (0,), {},
         False),
        ("_grad_add", [rn(5, 6), rn(5, 6)], (0, 1), {}, False),
        ("_identity_with_attr_like_rhs", [rn(5, 6), rn(5, 6)], (0,), {},
         False),
        ("_scatter_plus_scalar", [rn(5, 6)], (0,), {"scalar": 1.5}, False),
        ("_scatter_minus_scalar", [rn(5, 6)], (0,), {"scalar": 1.5},
         False),
        ("_scatter_elemwise_div", [rn(5, 6), rn(5, 6) + 4.0], (0, 1), {},
         False),
        ("Convolution_v1", [rn(2, 3, 8, 8), rn(4, 3, 3, 3), rn(4)],
         (0, 1, 2), {"kernel": (3, 3), "num_filter": 4}, True),
        ("Pooling_v1", [rn(2, 3, 8, 8)], (0,),
         {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"}, False),
        ("BatchNorm_v1", [rn(4, 3, 5, 5), rn(3), rn(3),
                          np.zeros(3, f32), np.ones(3, f32)], (0, 1, 2),
         {"fix_gamma": False}, True),
        ("_full", [], (), {"shape": (3, 4), "value": 2.5}, False),
        ("_arange", [], (), {"start": 1.0, "stop": 9.0, "step": 0.5,
                             "repeat": 2}, False),
        ("linalg_gemm", [rn(4, 16, 8), rn(4, 8, 12), rn(4, 16, 12)],
         (0, 1, 2), {"alpha": 0.5, "beta": 2.0}, True),
        ("linalg_gemm2", [rn(4, 8, 16), rn(4, 12, 8)], (0, 1),
         {"transpose_a": True, "transpose_b": True}, True),
        ("linalg_potrf", [spd], (0,), {}, True),
        ("linalg_potri", [low], (0,), {}, True),
        ("linalg_trmm", [low, rn(4, 16, 6)], (0, 1), {"alpha": 0.5}, True),
        ("linalg_trmm", [low, rn(4, 6, 16)], (0, 1),
         {"rightside": True, "transpose": True}, True),
        ("linalg_trsm", [low, rn(4, 16, 6)], (0, 1), {"alpha": 2.0}, True),
        ("linalg_trsm", [low, rn(4, 6, 16)], (0, 1),
         {"rightside": True, "transpose": True}, True),
        ("linalg_sumlogdiag", [spd], (0,), {}, True),
        ("linalg_syrk", [rn(4, 8, 16)], (0,), {"alpha": 0.5}, True),
        ("linalg_gelqf", [rn(4, 8, 16)], (0,), {}, True),
        ("linalg_syevd", [eig], (0,), {}, True),
        ("_contrib_fft", [rn(6, 32)], (0,), {}, True),
        ("_contrib_ifft", [rn(6, 64)], (0,), {}, True),
        ("_contrib_count_sketch",
         [rn(8, 40), r.randint(0, 16, (1, 40)).astype(f32),
          r.choice([-1.0, 1.0], (1, 40)).astype(f32)], (0,),
         {"out_dim": 16}, True),
        ("LSoftmax", [rn(8, 6), rn(5, 6), r.randint(0, 5, 8).astype(f32)],
         (0, 1), {"num_hidden": 5, "margin": 3, "beta": 0.5}, True),
        ("MultiLogistic", [rn(8, 5), r.randint(0, 2, (8, 5)).astype(f32)],
         (0,), {"weight": 2.0}, False),
        ("WeightedL1", [rn(8, 5), np.maximum(rn(8, 5), 0)], (0,), {},
         False),
        ("nAvg", [rn(2, 6, 5, 5) + 0.8], (0,), {}, True),
        ("SPN", spn_in, (0, 1, 2, 3), {}, True),
        ("SPN", spn_in, (0, 1, 2, 3), {"horizontal": True,
                                       "reverse": True}, True),
        ("SCN", spn_in + [r.rand(2, 4, 9, 11).astype(f32)],
         (0, 1, 2, 3, 4), {"reverse": True}, True),
        ("Correlation1D", [rn(2, 4, 6, 12), rn(2, 4, 6, 12)], (0, 1),
         {"max_displacement": 3, "pad_size": 3, "kernel_size": 3}, True),
        ("Correlation", [rn(2, 4, 9, 9), rn(2, 4, 9, 9)], (0, 1),
         {"max_displacement": 2, "pad_size": 2, "stride2": 2}, True),
        ("Correlation", [rn(2, 4, 9, 9), rn(2, 4, 9, 9)], (0, 1),
         {"max_displacement": 1, "pad_size": 1, "is_multiply": False},
         True),
    ]
    return cases


def zoo_op_fn(mx, op):
    if op.startswith("_contrib_"):
        return getattr(mx.nd.contrib, op[len("_contrib_"):])
    return getattr(mx.nd._internal if op.startswith("_") else mx.nd, op)


def zoo_op_run(mx, op, arrays, grad, attrs, ctx):
    """(outputs, gradients of the ``grad`` inputs) as numpy: one call
    under ``autograd.record`` on ``ctx`` (a creation op in its scope),
    then a backward with seeded heads (none on syevd's eigenvectors,
    whose signs are each library's)."""
    ins = [mx.nd.array(a, ctx=ctx) for a in arrays]
    for i in grad:
        ins[i].attach_grad()
    with ctx:
        with mx.autograd.record():
            out = zoo_op_fn(mx, op)(*ins, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    values = [o.asnumpy() for o in outs]
    if not grad:
        return values, []
    rng = np.random.RandomState(7)
    heads = [mx.nd.array(rng.randn(*v.shape).astype(v.dtype), ctx=ctx)
             for v in values]
    if op == "linalg_syevd":
        heads[0] = mx.nd.zeros(values[0].shape, ctx=ctx)
    mx.autograd.backward(outs, heads)
    return values, [ins[i].grad.asnumpy() for i in grad]


def zoo_op_grid(mx):
    """(c): each case on the card against the CPU: (cases, {"exact" /
    "summing": (worst error over its tensor's max, where)})."""
    worst = {"exact": (0.0, None), "summing": (0.0, None)}
    bars = {"exact": ZOO_OP_TOL, "summing": ZOO_SUM_TOL}
    cases = zoo_op_cases()
    for op, arrays, grad, attrs, summing in cases:
        want = zoo_op_run(mx, op, arrays, grad, attrs, mx.cpu())
        got = zoo_op_run(mx, op, arrays, grad, attrs, mx.gpu())
        if op == "linalg_syevd":
            # each eigenvector row up to its sign
            sign = np.sign(np.sum(got[0][0] * want[0][0], -1,
                                  keepdims=True))
            got[0][0] = got[0][0] * sign
        kind = "summing" if summing else "exact"
        pairs = list(zip(got[0], want[0])) + list(zip(got[1], want[1]))
        for j, (g, w) in enumerate(pairs):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError("%s %s tensor %d: %s %s on the card, "
                                     "%s %s on the CPU" % (
                                         op, attrs, j, g.shape, g.dtype,
                                         w.shape, w.dtype))
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
            err = float(np.abs(g.astype(np.float64) - w).max(initial=0.0)) \
                / scale
            if err > worst[kind][0]:
                worst[kind] = (err, "%s %s tensor %d" % (op, attrs, j))
    for kind, bar in bars.items():
        if worst[kind][0] > bar:
            raise AssertionError("zoo op grid: %s differs from the CPU by "
                                 "%.3g of its max (bar %g)"
                                 % (worst[kind][1], worst[kind][0], bar))
    return len(cases), worst


def zoo_big_op(mx, op, arrays, attrs, card, cpu_rows=None):
    """An op at a real size on the card: forward and backward timed with
    CUDA events, their kernels counted, the peak memory above the inputs;
    forward and gradients against the CPU (on the first ``cpu_rows``
    samples when given: each sample's result is its own)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    ins = [mx.nd.array(a, ctx=mx.gpu()) for a in arrays]
    for a in ins:
        a.attach_grad()
    head = None

    def fwd():
        return zoo_op_fn(mx, op)(*ins, **attrs)

    def fwd_bwd():
        with mx.autograd.record():
            out = fwd()
        out.backward(head)
        return out

    out = fwd()
    rng = np.random.RandomState(3)
    head = mx.nd.array(rng.randn(*out.shape).astype(np.float32),
                       ctx=mx.gpu())
    fwd_bwd()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = time_events_ms(lambda: fwd(), reps=3)
    fb_ms = time_events_ms(fwd_bwd, reps=3)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    fwd_kernels = sum(profiled_ms(fwd, 1)[2].values())
    fb_kernels = sum(profiled_ms(fwd_bwd, 1)[2].values())
    got_out = fwd_bwd().asnumpy()
    got_g = [a.grad.asnumpy() for a in ins]
    n = cpu_rows or arrays[0].shape[0]
    with mx.cpu():
        c_ins = [mx.nd.array(a[:n], ctx=mx.cpu()) for a in arrays]
        for a in c_ins:
            a.attach_grad()
        with mx.autograd.record():
            c_out = zoo_op_fn(mx, op)(*c_ins, **attrs)
        c_out.backward(mx.nd.array(head.asnumpy()[:n], ctx=mx.cpu()))
    pairs = [(got_out[:n], c_out.asnumpy())] + \
        [(g[:n], a.grad.asnumpy()) for g, a in zip(got_g, c_ins)]
    err = max(float(np.abs(g - w).max() / np.abs(w).max())
              for g, w in pairs)
    if not err <= ZOO_SUM_TOL:
        raise AssertionError("%s %s at %s: %.3g of the CPU's max"
                             % (op, attrs, arrays[0].shape, err))
    return dict(shape=list(arrays[0].shape), fwd_ms=fwd_ms,
                fwd_bwd_ms=fb_ms, peak_gb=peak, fwd_kernels=fwd_kernels,
                fwd_bwd_kernels=fb_kernels, err=err, cpu_rows=n)


def zoo_big_ops(mx, card):
    """(c): Correlation at FlowNetC's setting and SPN / SCN at
    SPN_SHAPE, both scan directions."""
    r = np.random.RandomState(5)
    out = {}
    a = r.randn(*FLOWNETC_SHAPE).astype(np.float32)
    b = r.randn(*FLOWNETC_SHAPE).astype(np.float32)
    out["correlation_flownetc"] = rec = zoo_big_op(
        mx, "Correlation", [a, b], FLOWNETC, card, cpu_rows=1)
    log("zoo (c): Correlation at FlowNetC's setting %s on %s: 441 "
        "displacements, forward %.3f ms (%d kernels), forward + backward "
        "%.3f ms (%d kernels), peak %.3f GB above the inputs; sample 0 vs "
        "the CPU %.3g" % (FLOWNETC_SHAPE, card, rec["fwd_ms"],
                          rec["fwd_kernels"], rec["fwd_bwd_ms"],
                          rec["fwd_bwd_kernels"], rec["peak_gb"],
                          rec["err"]))
    x = r.randn(*SPN_SHAPE).astype(np.float32)
    g = [r.uniform(-0.3, 0.3, SPN_SHAPE).astype(np.float32)
         for _ in range(3)]
    c = r.rand(*SPN_SHAPE).astype(np.float32)
    for op, arrays in (("SPN", [x] + g), ("SCN", [x] + g + [c])):
        for reverse in (False, True):
            key = "%s_%s" % (op.lower(), "reverse" if reverse else "forward")
            out[key] = rec = zoo_big_op(mx, op, arrays,
                                        {"reverse": reverse}, card,
                                        cpu_rows=1)
            log("zoo (c): %s reverse=%s at %s: forward %.3f ms (%d kernels: "
                "%d scan steps), forward + backward %.3f ms (%d kernels), "
                "peak %.3f GB; sample 0 vs the CPU %.3g" % (
                    op, reverse, SPN_SHAPE, rec["fwd_ms"],
                    rec["fwd_kernels"], SPN_SHAPE[2], rec["fwd_bwd_ms"],
                    rec["fwd_bwd_kernels"], rec["peak_gb"], rec["err"]))
    return out


ZOO_OPTIMIZERS = (
    ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "lamda": 0.5}),
    ("adamax", {"learning_rate": 0.01, "wd": 1e-3}),
    ("nadam", {"learning_rate": 0.01, "clip_gradient": 0.05}),
    ("test", {"rescale_grad": 0.1}))


def zoo_opt_steps(mx, opt, kw, ctx, n=5):
    """n trainer.step updates of a 2-layer Dense net from seeded weights:
    {name: value} of every weight and optimizer state."""
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="opt_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="tanh", in_units=8),
                nn.Dense(4, in_units=16))
    net.initialize(ctx=ctx)
    rng = np.random.RandomState(0)
    for p in net.collect_params().values():
        p.set_data(mx.nd.array(rng.randn(*p.shape).astype(np.float32) * 0.3,
                               ctx=ctx))
    tr = mx.gluon.Trainer(net.collect_params(), opt, dict(kw),
                          kvstore="local")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for i in range(n):
        r = np.random.RandomState(10 + i)
        x = mx.nd.array(r.randn(8, 8).astype(np.float32), ctx=ctx)
        y = mx.nd.array(r.randint(0, 4, 8).astype(np.float32), ctx=ctx)
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(8)
    out = {"w:" + k: p.data().asnumpy()
           for k, p in net.collect_params().items()}
    for i, st in tr._updaters[0].states.items():
        for j, s in enumerate(st if isinstance(st, (tuple, list))
                              else (st,)):
            if s is not None:
                out["s:%d:%d" % (i, j)] = s.asnumpy()
    return out


def zoo_optimizers(mx):
    """(d): five optimizers' 5 steps on the card against the CPU, and
    SGLD's noise moments on the card."""
    out = {}
    for opt, kw in ZOO_OPTIMIZERS:
        with mx.cpu():
            want = zoo_opt_steps(mx, opt, kw, mx.cpu())
        got = zoo_opt_steps(mx, opt, kw, mx.gpu())
        worst = max(float(np.abs(got[k] - w).max()
                          / max(np.abs(w).max(), 1e-30))
                    for k, w in want.items())
        if sorted(got) != sorted(want) or not worst <= ZOO_OPT_TOL:
            raise AssertionError("%s: the card's 5 steps differ from the "
                                 "CPU's by %.3g" % (opt, worst))
        out[opt] = worst
    lr, n = 0.01, 1 << 20
    o = mx.optimizer.create("sgld", learning_rate=lr, seed=1)
    w = mx.nd.zeros((n,), ctx=mx.gpu())
    upd = mx.optimizer.get_updater(o)
    means, variances = [], []
    for _ in range(5):
        before = w.asnumpy().astype(np.float64)
        upd(0, mx.nd.zeros((n,), ctx=mx.gpu()), w)
        d = w.asnumpy().astype(np.float64) - before
        means.append(float(d.mean()))
        variances.append(float(d.var()))
    se_mean, se_var = np.sqrt(lr / n), lr * np.sqrt(2.0 / n)
    if any(abs(m) > 5 * se_mean for m in means) or \
            any(abs(v - lr) > 5 * se_var for v in variances):
        raise AssertionError("sgld noise: means %s, variances %s (lr %g)"
                             % (means, variances, lr))
    out["sgld"] = dict(means=means, variances=variances, lr=lr,
                       draws=o._noise_draws)
    return out


def model_zoo_phase(mx, card, results):
    """Phase 16: the model zoo through bench_gluon_resnet's protocol, a
    CTC head, the slice's ops and optimizers on the card."""
    import torch
    from mxnet_tpu_torch import cuda_build

    out = {"nets": {}}
    cuda_build.reset_launch_counts()
    for name, size in ZOO_NETS:
        out["nets"][name] = zoo_train(mx, name, size, card)
    out["fused_matmul_launches"] = cuda_build.launch_counts().get(
        "fused_matmul", 0)
    if out["fused_matmul_launches"]:
        raise AssertionError("the NCHW zoo nets launched fused_matmul %d "
                             "times" % out["fused_matmul_launches"])
    log("zoo (a): fused_matmul launches over the six nets: %d (NCHW: no "
        "region of the kernel's form, as in the JAX package)"
        % out["fused_matmul_launches"])
    out["ctc"] = ctc_phase(mx, card)
    n, worst = zoo_op_grid(mx)
    out["op_grid"] = dict(cases=n, worst=worst)
    log("zoo (c): %d op cases on the card against the CPU, forward and "
        "gradients: worst %.3g (%s; bar %g), %.3g where a sum runs in "
        "another order (%s; bar %g)" % (
            n, worst["exact"][0], worst["exact"][1], ZOO_OP_TOL,
            worst["summing"][0], worst["summing"][1], ZOO_SUM_TOL))
    out["big_ops"] = zoo_big_ops(mx, card)
    out["optimizers"] = zoo_optimizers(mx)
    log("zoo (d): ccSGD, DCASGD, Adamax, Nadam and Test: 5 trainer.step "
        "updates on the card vs the CPU, worst %.3g of each tensor's max "
        "(bar %g); SGLD's noise on 2**20 weights over 5 steps: means %s, "
        "variances %s (lr %g)" % (
            max(v for k, v in out["optimizers"].items() if k != "sgld"),
            ZOO_OPT_TOL,
            " ".join("%.2e" % m for m in out["optimizers"]["sgld"]["means"]),
            " ".join("%.6f" % v
                     for v in out["optimizers"]["sgld"]["variances"]),
            out["optimizers"]["sgld"]["lr"]))
    torch.cuda.empty_cache()
    results["zoo"] = out
    return out


# ------------------------------ phase 17: mixed precision, control plane
# (a): phase 3's ResNet-50 served under MXNET_GRAPH_PASSES=default,amp.
# The random network amplifies bf16 rounding: on the CPU the JAX package's
# amp moves its logits as much as the port's (tools/port_amp_conditioning.py),
# so amp is held to fp32 on the JAX test's own quantity, the probabilities,
# and the logits' gaps are reported
AMP_BUCKETS = (1, 8)
# kernel-form regions of one amp forward: phase 3's 32, and fc1 with the
# cast that returns it to fp32 (the softmax island's input)
AMP_REGIONS = 33
AMP_TOL = dict(rtol=5e-2, atol=2e-2)   # tests/test_graph_passes.py:163
# the amp graph with fused_matmul against it with the kernel's plain
# version, logits over max(1, max |logit|): 2e-2, or AMP_FLOOR_X times
# the gap the network opens between two roundings of the same function
# (the plain version against itself in float64) where that is wider
AMP_PLAIN_TOL = 2e-2
AMP_FLOOR_X = 2.0
AMP_LATENCY_N = 30       # sequential requests per bucket
AMP_BATCHES = 16         # back-to-back 8-row requests
AMP_CALIBRATE = 30       # training-mode forwards that set BN's statistics
# (b): the amp generator's first-token logits against the same bf16
# weights through the plain attention, over max |logit|
AMP_GEN_TOL = 2e-2
# (c): bench_all.py:946-1100 bench_control's protocol (its full size) at
# phase 11's width in fp32
CTL_REQUESTS, CTL_HEAD, CTL_NEW = 48, 224, 16
CTL_SLOTS, CTL_MAX_SEQ, CTL_LOAD = 8, 256, 2.0
# (d): PR 9's TTFT p50 / p99 under phase 11 (d)'s traffic, eager prefill
PR9_TTFT_MS = (13.18, 104.54)
# (f): the autoscaler over phase 14's ResNet-50 server
AS_BURST = 96            # single-image requests submitted at once
AS_BREAKER_MS = 2000     # the server's quarantine time


def amp_region_calls(mx, served, bucket):
    """The fused_matmul calls of one amp forward of the served graph at
    ``bucket``, recorded on meta tensors (shapes only), with each call's
    output dtype."""
    import torch
    from mxnet_tpu_torch.executor import _GraphProgram
    from mxnet_tpu_torch.parallel import fused as F

    frozen = [a for a in served.list_arguments()
              if a not in ("data", "softmax_label")] + \
        served.list_auxiliary_states()
    opt = mx.graph_pass.optimize(
        served, frozen=frozen, arg_shapes={"data": (1,) + ROW},
        config=mx.graph_pass.PassConfig("default,amp"))
    osym = opt.symbol
    # the fold constants at their own dtypes (the casts amp put on the
    # parameters are folded: bf16 weights)
    arg_shapes, _, aux_shapes = served.infer_shape(data=(bucket,) + ROW)
    values = {n: torch.empty(s, device="meta")
              for n, s in zip(served.list_arguments() +
                              served.list_auxiliary_states(),
                              list(arg_shapes) + list(aux_shapes))}
    values.update(opt.fold(values))
    args = {n: values[n] for n in osym.list_arguments()}
    aux = {n: values[n] for n in osym.list_auxiliary_states()}
    calls = []
    real = F.fused_matmul

    def record(x, w, extras=(), epilogue=(), wt=True, out_dtype=None):
        od = str(out_dtype or x.dtype).replace("torch.", "")
        calls.append({"M": int(x.shape[0]), "K": int(x.shape[1]),
                      "N": int(w.shape[0] if wt else w.shape[1]),
                      "wt": bool(wt), "epilogue": tuple(epilogue),
                      "out_dtype": od,
                      "dtypes": [str(t.dtype).replace("torch.", "")
                                 for t in [x, w] + list(extras)]})
        return torch.empty((calls[-1]["M"], calls[-1]["N"]), device="meta",
                           dtype=getattr(torch, od))

    F.fused_matmul = record
    try:
        _GraphProgram(osym).infer_fn()(args, aux)
    finally:
        F.fused_matmul = real
    return opt, calls


def amp_bound_ms(case, bf16_peak, bytes_per_s):
    """bf16 inputs and extras, the output in its own dtype, against the
    bf16 tensor-core peak and the memory rate."""
    M, N, K = case["M"], case["N"], case["K"]
    n_extra = sum(M * N if s[0] == "res" else N for s in case["epilogue"]
                  if s[0] in ("bias", "vadd", "vmul", "res"))
    out_size = 4 if case["out_dtype"] == "float32" else 2
    nbytes = (M * K + K * N + n_extra) * 2 + M * N * out_size
    t_bytes = nbytes / bytes_per_s * 1e3
    t_ops = 2.0 * M * N * K / bf16_peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def fused_variants(kernel):
    """{variant: launches} of ``kernel`` since the last reset."""
    from mxnet_tpu_torch import cuda_build

    return {v: n for (k, v), n in cuda_build.variant_counts().items()
            if k == kernel}


def all_tc(variants):
    """True when every launch counted in ``variants`` took the tensor-core
    route."""
    return bool(variants) and all(v.startswith("tc") for v in variants)


def amp_kernel_timing(mx, served, peaks):
    """(a): fused_matmul at each amp region's shape of one forward at
    buckets 1 and 8, bf16 inputs: every region on the tensor-core route,
    held to its plain version (the bf16 grid's bar), every compiled tile
    of the route held to the default tile bit for bit, timed beside the
    plain version and beside torch.addmm in bf16 plus the epilogue as
    CUDA-graph replays, with its bound. Per-forward sums, each tile's
    too."""
    import torch
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.parallel import fused as F

    gen = torch.Generator(device="cuda").manual_seed(17)
    totals = {}
    worst = 0.0
    for bucket in AMP_BUCKETS:
        _opt, calls = amp_region_calls(mx, served, bucket)
        if len(calls) != AMP_REGIONS:
            raise AssertionError("amp bucket %d forward has %d kernel-form "
                                 "regions, want %d"
                                 % (bucket, len(calls), AMP_REGIONS))
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   t_ops=0.0, t_bytes=0.0)
        tiles = {"%dx%d" % t: dict(ms=0.0, max_diff=0.0)
                 for t in F.TC_TILES}
        cases = []
        cuda_build.reset_launch_counts()
        for case in calls:
            err, (x, w, extras) = check_case(F, case, torch.bfloat16, gen,
                                             GRID_TOL["bfloat16"])
            worst = max(worst, err)
            ep, wt, od = case["epilogue"], case["wt"], case["out_dtype"]
            want = F.fused_matmul(x, w, extras, ep, wt, out_dtype=od)
            default_variant = cuda_build.last_variant(F.KERNEL)
            for bm, bn in F.TC_TILES:
                got = F.fused_matmul(x, w, extras, ep, wt, out_dtype=od,
                                     block_m=bm, block_n=bn)
                row = tiles["%dx%d" % (bm, bn)]
                row["max_diff"] = max(row["max_diff"], (
                    got.float() - want.float()).abs().max().item())
                if not torch.equal(got, want):
                    raise AssertionError(
                        "fused_matmul tensor-core tile %d x %d is not "
                        "bit-identical to the default tile at %s: max diff "
                        "%.3g" % (bm, bn, case, row["max_diff"]))
                row["ms"] += time_ms(lambda bm=bm, bn=bn: F.fused_matmul(
                    x, w, extras, ep, wt, out_dtype=od, block_m=bm,
                    block_n=bn))
            bnd, by = amp_bound_ms(case, peaks["bf16_flops"],
                                   peaks["bytes_per_s"])
            row = dict(
                M=case["M"], N=case["N"], K=case["K"], wt=wt,
                variant=default_variant,
                ms=time_ms(lambda: F.fused_matmul(
                    x, w, extras, ep, wt, out_dtype=od)),
                plain_ms=time_ms(lambda: F.fused_matmul_reference(
                    x, w, extras, ep, wt, out_dtype=od)),
                library_ms=time_ms(lambda: library_fn(
                    x, w, extras, ep, wt, native=True, out_dtype=od)),
                bound_ms=bnd)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[key] += row[key]
            tot["t_ops" if by == "operations" else "t_bytes"] += bnd
            cases.append(row)
        # the checks' launches: one default launch per region, then each
        # tile's (timing launches are captured, not counted)
        variants = fused_variants(F.KERNEL)
        if not all_tc(variants):
            raise AssertionError("amp bucket %d: fused_matmul launches off "
                                 "the tensor-core route: %s"
                                 % (bucket, variants))
        tot["bound_by"] = ("operations" if tot["t_ops"] >= tot["t_bytes"]
                           else "bytes")
        tot["launches"] = len(calls)
        tot["route"] = "tc"
        tot["check_launches"] = variants
        tot["tiles"] = tiles
        tot["cases"] = cases
        tot["factor_vs_library"] = tot["ms"] / tot["library_ms"]
        totals[bucket] = tot
    return totals, worst


def amp_server(mx, served, args, aux, spec="default,amp", **cfg):
    import torch

    mx.graph_pass.set_passes(spec)
    try:
        return mx.serving.InferenceServer(
            served, args, aux, data_shapes=[("data", (1,) + ROW)],
            devices=[torch.device("cuda", 0)],
            config=mx.serving.ServingConfig(buckets=AMP_BUCKETS,
                                            max_wait_ms=0, **cfg))
    finally:
        mx.graph_pass.set_passes(None)


def amp_latency(srv, rng, batch):
    """p50 ms of AMP_LATENCY_N sequential requests at each bucket, and
    img/s of AMP_BATCHES back-to-back 8-row requests."""
    lat = {}
    for b in AMP_BUCKETS:
        x = rng.standard_normal((b,) + ROW, dtype=np.float32)
        srv.predict(x, timeout=600)
        ts = []
        for _ in range(AMP_LATENCY_N):
            t0 = time.perf_counter()
            srv.predict(x, timeout=600)
            ts.append((time.perf_counter() - t0) * 1e3)
        lat[b] = float(np.percentile(ts, 50))
    t0 = time.perf_counter()
    futs = [srv.submit(batch) for _ in range(AMP_BATCHES)]
    for f in futs:
        f.result(timeout=600)
    return lat, AMP_BATCHES * batch.shape[0] / (time.perf_counter() - t0)


def amp_answers(srv, images, batch):
    srv.warmup()
    return ([srv.predict(x, timeout=600) for x in images]
            + [srv.predict(batch, timeout=600)])


def amp_parity(mx, served, args, aux, images, batch):
    """The same requests through the fp32 server (default passes), the amp
    server and the amp server with MXNET_FUSION_KERNEL=0 (the plain
    composition): (fp32 answers, amp answers, plain amp answers)."""
    answers = []
    for spec, kernel in (("default", True), ("default,amp", True),
                         ("default,amp", False)):
        if not kernel:
            mx.config.set_flag("MXNET_FUSION_KERNEL", 0)
        try:
            srv = amp_server(mx, served, args, aux, spec=spec)
            try:
                answers.append(amp_answers(srv, images, batch))
            finally:
                srv.stop()
        finally:
            mx.config.set_flag("MXNET_FUSION_KERNEL", None)
    return answers


def amp_gaps(fp32, amp, plain):
    """amp against fp32 (logits over max |logit|, top-1, the JAX test's
    tolerance on probabilities and, over max |logit|, on logits) and the
    kernel against the plain composition."""
    err, top1 = compare(amp, fp32, "amp vs fp32")
    plain_err, plain_top1 = compare(amp, plain, "amp kernel vs plain")
    probs_ok = all(np.allclose(a[0], f[0], **AMP_TOL)
                   for a, f in zip(amp, fp32))
    logits_ok = all(np.allclose(a[1], f[1], rtol=AMP_TOL["rtol"],
                                atol=AMP_TOL["atol"] * max(
                                    1.0, float(np.abs(f[1]).max())))
                    for a, f in zip(amp, fp32))
    scale = max(float(np.abs(f[1]).max()) for f in fp32)
    return dict(logit_err=err, top1=top1, probs_within=probs_ok,
                logits_within=logits_ok, max_logit=scale,
                plain_logit_err=plain_err, plain_top1=plain_top1)


def fused_matmul_fp64(x, w, extras=(), epilogue=(), wt=True, out_dtype=None):
    """``fused_matmul``'s plain version with the product and the epilogue
    in float64 before the one cast: the same function rounded once from
    (nearly) exact values."""
    from mxnet_tpu_torch.base import torch_dtype
    from mxnet_tpu_torch.parallel import fused as F

    wd = w.double()
    y = x.double() @ (wd.t() if wt else wd)
    y = F._reference_epilogue(y, extras, epilogue)
    return y.to(torch_dtype(out_dtype) or x.dtype)


def eager_plain_kernel(srv, x, plain=None):
    """The eager walk of replica 0 with ``fused_matmul`` swapped for
    ``plain`` (default: its plain version, ``fused_matmul_reference``):
    host outputs."""
    from mxnet_tpu_torch.parallel import fused as F

    real = F.fused_matmul
    F.fused_matmul = plain or F.fused_matmul_reference
    try:
        return [o.cpu().numpy() for o in eager_outputs(srv, 0, x)]
    finally:
        F.fused_matmul = real


def calibrated_bn(mx, sym, np_args, np_aux, x, ctx=None):
    """Phase 14's weights with BatchNorm's moving statistics brought to
    the data, as a trained net's are: AMP_CALIBRATE training-mode forwards
    of ``x`` (0.9^30 of the initial statistics left) on ``ctx`` (the
    card). Returns the moving statistics as numpy."""
    ctx = ctx or mx.gpu()
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", (x.shape[0],))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in np_args.items()},
                    aux_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in np_aux.items()},
                    force_init=True)
    batch = mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                            [mx.nd.zeros((x.shape[0],), ctx=ctx)])
    for _ in range(AMP_CALIBRATE):
        mod.forward(batch, is_train=True)
    # the device copies (forward leaves the host dicts as they were)
    grp = mod._exec_group
    return {name: arrs[0].asnumpy()
            for name, arrs in zip(grp.aux_names, grp.aux_arrays)}


def amp_serve(mx, sym, card, peaks, out):
    """(a): ResNet-50 under default,amp, buckets (1, 8), one replica."""
    import torch
    from mxnet_tpu_torch import cuda_build, cuda_graph

    np_args, np_aux = resnet50_params(sym, seed=0)
    center_fc_bias(mx, sym, np_args, np_aux, np.random.default_rng(1))
    served = mx.sym.Group([sym, sym.get_internals()["fc1_output"]])
    rng = np.random.default_rng(17)
    images = rng.standard_normal((8,) + ROW, dtype=np.float32)
    batch = rng.standard_normal((8,) + ROW, dtype=np.float32)
    res = {}
    # phase 14's weights: the random ResNet's logits share one
    # input-independent component of a few hundred, which fc1_bias
    # cancels; amp casts fc1_bias to bf16 (an FC input), which moves every
    # logit by up to half a bf16 ulp of it (reported, not checked)
    args, aux = mx.params_from_jax(np_args, np_aux, device="cuda")
    res["phase14_weights"] = amp_gaps(*amp_parity(mx, served, args, aux,
                                                  images, batch))
    # the same weights with BatchNorm's statistics brought to the data
    np_aux = calibrated_bn(mx, sym, np_args, np_aux, rng.standard_normal(
        (16,) + ROW, dtype=np.float32))
    center_fc_bias(mx, sym, np_args, np_aux, np.random.default_rng(1))
    args, aux = mx.params_from_jax(np_args, np_aux, device="cuda")
    gaps = amp_gaps(*amp_parity(mx, served, args, aux, images, batch))
    res["calibrated"] = gaps

    # the replays against the eager walk, bit for bit, under cuDNN's
    # deterministic algorithms (a graph keeps its capture's algorithms)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    srv = amp_server(mx, served, args, aux)
    try:
        srv.warmup()
        same = {}
        for b in AMP_BUCKETS:
            x = rng.standard_normal((b,) + ROW, dtype=np.float32)
            got, want = replay_vs_eager(srv, 0, x)
            same[b] = all(np.array_equal(g, w) for g, w in zip(got, want))
        # the same amp graph with fused_matmul's plain version in its
        # place (the same cuDNN algorithms): only the kernel differs
        # the network's floor: the plain version against itself in
        # float64, another rounding of the same function
        replayed, plain, exact = [], [], []
        for x in list(images[:4, None]) + [batch]:
            got, _want = replay_vs_eager(srv, 0, x)
            replayed.append(got)
            plain.append(eager_plain_kernel(srv, x))
            exact.append(eager_plain_kernel(srv, x, fused_matmul_fp64))
        gaps["kernel_vs_plain_kernel"], gaps["kernel_vs_plain_top1"] = \
            compare(replayed, plain, "amp kernel vs its plain version")
        gaps["plain_vs_fp64"], _ = compare(plain, exact,
                                           "plain version vs float64")
    finally:
        srv.stop()
        torch.backends.cudnn.deterministic = det

    cuda_build.reset_launch_counts()
    srv = amp_server(mx, served, args, aux)
    try:
        warmed = srv.warmup()
        captured = cuda_build.launch_counts().get("fused_matmul", 0)
        captured_variants = fused_variants("fused_matmul")
        # each bucket's eager walk: every region on the tensor-core route
        eager_variants = {}
        for b in AMP_BUCKETS:
            cuda_build.reset_launch_counts()
            eager_outputs(srv, 0, batch[:b])
            torch.cuda.synchronize()
            eager_variants[b] = fused_variants("fused_matmul")
        cuda_build.reset_launch_counts()
        eager_outputs(srv, 0, batch)
        torch.cuda.synchronize()
        per_body = cuda_build.launch_counts().get("fused_matmul", 0)
        cuda_build.reset_launch_counts()
        stats0 = srv.get_stats()
        answers = amp_answers(srv, images, batch)
        lat, img_s = amp_latency(srv, rng, batch)
        stats = srv.get_stats()
        traffic_wrapper = cuda_build.launch_counts().get("fused_matmul", 0)
    finally:
        srv.stop()
    # the same protocol on the fp32 server (default passes, the CUDA-core
    # route), in this process and on this card
    srv = amp_server(mx, served, args, aux, spec="default")
    try:
        srv.warmup()
        fp32_lat, fp32_img_s = amp_latency(srv, rng, batch)
    finally:
        srv.stop()
    report = stats["graph_pass"]
    passes = {r["pass"]: r for r in report["passes"]}
    regions = report["fuse"]["regions"]
    casts = sum(1 for r in regions if "Cast" in r["ops"])
    replays = stats.get("batches", 0) - stats0.get("batches", 0)
    dtypes = {str(a[1].dtype) for a in answers}
    timing, kerr = amp_kernel_timing(mx, served, peaks)
    res.update(
        amp_casts=passes["amp"]["rewrites"], regions=len(regions),
        regions_ending_in_cast=casts, kernel_regions=per_body,
        warmup=warmed, captures=stats["bucket_programs"],
        capture_launches=captured,
        capture_launches_per_body_run=captured / max(1, warmed * (
            1 + cuda_graph.WARMUP_RUNS)),
        replay_equals_eager=same, replays=replays,
        captured_variants=captured_variants,
        eager_variants={str(b): v for b, v in eager_variants.items()},
        launches=replays * per_body, traffic_wrapper_launches=traffic_wrapper,
        p50_ms={str(b): lat[b] for b in AMP_BUCKETS}, img_per_s_bucket8=img_s,
        fp32_p50_ms={str(b): fp32_lat[b] for b in AMP_BUCKETS},
        fp32_img_per_s_bucket8=fp32_img_s,
        kernel={str(b): t for b, t in timing.items()}, kernel_max_err=kerr,
        output_dtypes=sorted(dtypes))
    p14 = res["phase14_weights"]
    log("amp (a): ResNet-50 NHWC under default,amp, buckets %s, one "
        "replica: %d casts, %d fuse regions (%d ending in a cast), %d take "
        "fused_matmul with bf16 operands; warmup %d captures (%d wrapper "
        "launches, %.1f per body run); each replay equal to its eager walk "
        "to the bit (cuDNN deterministic): %s; phase 14's weights (max "
        "|logit| %.4g): logits vs the fp32 server %.4g of max |logit|, "
        "top-1 %.3f, vs the plain composition %.4g (reported); BatchNorm "
        "calibrated (max |logit| %.4g): vs the fp32 server %.4g, top-1 "
        "%.3f, probabilities within rtol %g atol %g: %s, logits within the "
        "same over max |logit|: %s (reported); vs the plain composition "
        "(MXNET_FUSION_KERNEL=0) %.4g, top-1 %.3f (reported); vs the same "
        "graph with fused_matmul's plain version %.4g, top-1 %.3f (that "
        "plain version against itself in float64: %.4g); outputs %s; p50 "
        "%s ms, "
        "%.1f img/s at bucket 8; %d replays x %d launches = %d "
        "fused_matmul launches, %d by the wrapper outside the captures; "
        "on %s"
        % (AMP_BUCKETS, res["amp_casts"], len(regions), casts, per_body,
           warmed, captured, res["capture_launches_per_body_run"], same,
           p14["max_logit"], p14["logit_err"], p14["top1"],
           p14["plain_logit_err"], gaps["max_logit"], gaps["logit_err"],
           gaps["top1"], AMP_TOL["rtol"], AMP_TOL["atol"],
           gaps["probs_within"], gaps["logits_within"],
           gaps["plain_logit_err"], gaps["plain_top1"],
           gaps["kernel_vs_plain_kernel"], gaps["kernel_vs_plain_top1"],
           gaps["plain_vs_fp64"], sorted(dtypes),
           {b: round(v, 3) for b, v in lat.items()}, img_s, replays,
           per_body, res["launches"], traffic_wrapper, card))
    log("amp (a): fused_matmul variants of the captures %s, of the eager "
        "walks by bucket %s" % (captured_variants, eager_variants))
    log("amp (a): the same protocol on the fp32 server (default passes, one "
        "replica): p50 %s ms, %.1f img/s at bucket 8; amp p50 %s ms, %.1f "
        "img/s (%.2fx); on %s"
        % ({b: round(v, 3) for b, v in fp32_lat.items()}, fp32_img_s,
           {b: round(v, 3) for b, v in lat.items()}, img_s,
           img_s / fp32_img_s, card))
    for b, t in timing.items():
        log("amp (a): fused_matmul bf16 on the tensor-core route, bucket %d "
            "forward: %d launches ms=%.4f plain_ms=%.4f library_ms "
            "(torch.addmm bf16 + epilogue)=%.4f (kernel / library %.2fx) "
            "bound_ms=%.4f (%s, bf16 peak %.0f TFLOP/s, %.2f TB/s); worst "
            "kernel-vs-plain %.3g; every tile bit-identical to the default, "
            "ms a forward by tile %s; on %s"
            % (b, t["launches"], t["ms"], t["plain_ms"], t["library_ms"],
               t["factor_vs_library"], t["bound_ms"], t["bound_by"],
               peaks["bf16_flops"] / 1e12, peaks["bytes_per_s"] / 1e12, kerr,
               {k: round(v["ms"], 4) for k, v in t["tiles"].items()}, card))
    if not (all(same.values()) and per_body == AMP_REGIONS
            and all_tc(captured_variants)
            and all(all_tc(v) and sum(v.values()) == AMP_REGIONS
                    for v in eager_variants.values())
            and warmed == len(AMP_BUCKETS)
            and stats["bucket_programs"] == len(AMP_BUCKETS)
            and captured == AMP_REGIONS * warmed * (
                1 + cuda_graph.WARMUP_RUNS)
            and not traffic_wrapper and gaps["probs_within"]
            and gaps["kernel_vs_plain_kernel"] <= max(
                AMP_PLAIN_TOL, AMP_FLOOR_X * gaps["plain_vs_fp64"])
            and dtypes == {"float32"} and passes["amp"]["rewrites"] > 0):
        raise AssertionError("amp (a) failed: %s" % json.dumps(
            {k: v for k, v in res.items() if k != "kernel"}, default=str))
    out["a"] = res
    return res


def amp_generation(mx, card, out):
    """(b): GenerationConfig(amp=True) over phase 11 (a)'s fp32 model."""
    import torch

    G = mx.serving.generation
    model = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                            dtype="float32", **TRAIN_CFG)
    params = model.init(0)
    n_programs = len(G.default_prefill_ladder(GEN_MAX_SEQ)) + 1
    prompts = gen_prompts(GEN_PROMPTS, 2, GEN_PROMPT_MAX, TRAIN_CFG["vocab"],
                          2)
    sp = G.SamplingParams(max_new_tokens=GEN_NEW)
    res = {}
    outs = {}
    for mode in ("fp32", "amp"):
        gen = G.Generator(model, params, gen_config(mx, amp=mode == "amp"))
        warmed = gen.warmup()
        per_replay = {name: step.launches.get("flash_attention_fwd", 0)
                      for name, step in gen._steps.items()
                      if name.startswith("prefill")}
        dtypes = sorted({str(v.dtype) for v in gen._params.values()})
        base = gen.graph_launches().get("flash_attention_fwd", 0)
        got, wall = serve_all(gen, [(p, sp) for p in prompts])
        launches = gen.graph_launches().get("flash_attention_fwd", 0) - base
        stats = gen.get_stats()
        if mode == "amp":
            tok = torch.from_numpy(np.random.RandomState(1).randint(
                0, TRAIN_CFG["vocab"], (1, GEN_PREFILL_T[1]))).cuda()
            with torch.no_grad():
                kern, _, _ = model.prefill_forward(gen._params, tok)
                with plain_prefill():
                    want, _, _ = model.prefill_forward(gen._params, tok)
            first_err = float((kern[0, -1] - want[0, -1]).abs().max()
                              / want[0, -1].abs().max())
        captures = stopped(gen)
        outs[mode] = got
        res[mode] = dict(
            warmed=warmed, captures=captures, param_dtypes=dtypes,
            amp=stats["graph_pass"]["amp"], flash_fwd_per_replay=per_replay,
            flash_fwd_launches=launches, prefills=stats["prefills"],
            tokens_per_s=sum(len(g) for g in got) / wall, wall_s=wall)
        del gen
    noted = any(r.get("program") == "generation" and r.get("amp")
                for r in mx.graph_pass.recent_reports())
    same_seq = sum(a == b for a, b in zip(outs["amp"], outs["fp32"]))
    same_tok = sum(x == y for a, b in zip(outs["amp"], outs["fp32"])
                   for x, y in zip(a, b))
    res.update(first_token_logit_err=first_err, recent_reports=noted,
               agreement=dict(sequences=same_seq, tokens=same_tok,
                              of_sequences=len(prompts),
                              of_tokens=len(prompts) * GEN_NEW))
    a = res["amp"]
    log("amp (b): GenerationConfig(amp=True) over the fp32 LM (phase 11 "
        "(a)'s init(0)): parameters %s, stats amp %s, graph_pass recent "
        "reports note it: %s; %d programs warmed, %d captures; flash "
        "forward launches a prefill replay: %s (bf16: the wgmma kernel); "
        "%d prompts x %d new: %d flash forward launches over %d prefills; "
        "first-token logits of a %d-token prompt within %.3g of max "
        "|logit| of the same bf16 weights through the plain attention; "
        "greedy agreement with the fp32 generator %d of %d sequences, %d "
        "of %d tokens (reported, not checked); %.1f tokens/s amp, %.1f "
        "fp32; on %s"
        % (a["param_dtypes"], a["amp"], noted, a["warmed"], a["captures"],
           sorted(set(a["flash_fwd_per_replay"].values())), len(prompts),
           GEN_NEW, a["flash_fwd_launches"], a["prefills"],
           GEN_PREFILL_T[1], first_err, same_seq, len(prompts), same_tok,
           len(prompts) * GEN_NEW, a["tokens_per_s"],
           res["fp32"]["tokens_per_s"], card))
    n_layers = TRAIN_CFG["n_layers"]
    if not (a["param_dtypes"] == ["torch.bfloat16"] and a["amp"] is True
            and noted and a["warmed"] == a["captures"] == n_programs
            and set(a["flash_fwd_per_replay"].values()) == {n_layers}
            and a["flash_fwd_launches"] == n_layers * a["prefills"]
            and first_err <= AMP_GEN_TOL
            and res["fp32"]["amp"] is False):
        raise AssertionError("amp (b) failed: %s" % json.dumps(res))
    out["b"] = res
    return res


def step_replay_ms(gen, name, n=5):
    """Device ms of one replay of ``gen``'s step ``name`` (CUDA events over
    ``n``), from all-trash inputs: the work does not depend on them, and
    the writes land on the trash page."""
    import torch

    with gen._device_scope(), gen._pages_lock:
        step = gen._steps[name]
        step.reset()
        step.graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            step.graph.replay()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / n


def ctl_pass(gen, prompts, arrivals, sp):
    """One bench_control pass: Poisson submissions, a consumer thread per
    request. Returns (outputs, TTFT ms, the peak pages shared while
    requests were in flight)."""
    import threading

    n = len(prompts)
    ttfts, outs, threads = [None] * n, [None] * n, []
    shared = [0]

    def consume(handle, idx, t_sub):
        stream = handle.stream(timeout=600)
        toks = [next(stream)]
        ttfts[idx] = (time.perf_counter() - t_sub) * 1e3
        toks.extend(stream)
        outs[idx] = toks

    start = time.perf_counter()
    for i, (a, p) in enumerate(zip(arrivals, prompts)):
        now = time.perf_counter() - start
        if now < a:
            time.sleep(a - now)
        t_sub = time.perf_counter()
        h = gen.submit(p, sp)
        t = threading.Thread(target=consume, args=(h, i, t_sub))
        t.start()
        threads.append(t)
        if i % 4 == 3:
            shared[0] = max(shared[0], gen.pool.get_stats()["pages_shared"])
    for t in threads:
        t.join(600)
    if any(o is None for o in outs):
        raise AssertionError("control (c): %d requests unanswered"
                             % sum(o is None for o in outs))
    return outs, ttfts, shared[0]


def control_protocol(mx, card, out):
    """(c): bench_control's protocol at phase 11's width, fp32: a
    cache-less pass (cold), a seeding pass and a warm pass of the same
    Poisson schedule, then the SLO witness."""
    from mxnet_tpu_torch.observability import metrics

    G = mx.serving.generation
    model = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                            dtype="float32", **TRAIN_CFG)
    params = model.init(0)
    rng = np.random.RandomState(0)
    vocab = TRAIN_CFG["vocab"]
    head = [int(t) for t in rng.randint(1, vocab, size=CTL_HEAD)]
    prompts = [head + [int(t) for t in rng.randint(
        1, vocab, size=1 + int(rng.randint(8)))]
        for _ in range(CTL_REQUESTS)]
    sp = G.SamplingParams(max_new_tokens=CTL_NEW)
    n_programs = len(G.default_prefill_ladder(CTL_MAX_SEQ)) + 1

    def generator(cache):
        gen = G.Generator(model, params, G.GenerationConfig(
            prefix_cache=cache, max_batch=CTL_SLOTS, max_seq=CTL_MAX_SEQ,
            page_size=GEN_PAGE, decode_blocks=GEN_BLOCKS))
        if gen.warmup() != n_programs:
            raise AssertionError("control (c): warmup() != %d" % n_programs)
        return gen

    gen = generator(True)
    t0 = time.perf_counter()
    gen.generate(prompts[0], sp, timeout=600)
    t_req = time.perf_counter() - t0
    arrivals = np.cumsum(rng.exponential(t_req / CTL_LOAD, CTL_REQUESTS))
    pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731

    cold_gen = generator(False)
    cold, cold_ttft, _ = ctl_pass(cold_gen, prompts, arrivals, sp)
    # a cold prompt prefills at bucket 256 (the flash forward), a warm
    # suffix at 16 over the gathered prefix pages (_suffix_attend)
    replay_ms = {"cold_256": step_replay_ms(cold_gen, "prefill256")}
    cold_captures = stopped(cold_gen)
    del cold_gen
    ctl_pass(gen, prompts, arrivals, sp)             # seeds every block
    hits0 = metrics.get_value("generation.prefix_hits", 0)
    skipped0 = metrics.get_value("generation.prefill_tokens_skipped", 0)
    warm, warm_ttft, peak_shared = ctl_pass(gen, prompts, arrivals, sp)
    hits = metrics.get_value("generation.prefix_hits", 0) - hits0
    skipped = metrics.get_value("generation.prefill_tokens_skipped",
                                0) - skipped0
    cache = gen.prefix_cache.get_stats()
    pool = gen.pool.get_stats()
    replay_ms["warm_16"] = step_replay_ms(gen, "prefill16")

    # the SLO witness: every slot busy, then two batch and two interactive
    # requests queued; the interactive ones are admitted first and the
    # batch ones still finish
    admit = []
    real = gen._prefill

    def spy(slot, ent, worst):
        admit.append((ent.slo.name, len(ent.prompt)))
        return real(slot, ent, worst)

    gen._prefill = spy
    try:
        blockers = [gen.submit(head, G.SamplingParams(
            max_new_tokens=CTL_MAX_SEQ - CTL_HEAD - 1), slo="batch")
            for _ in range(CTL_SLOTS)]
        time.sleep(0.05)
        batch_hs = [gen.submit(head + [2, i], sp, slo="batch")
                    for i in range(2)]
        inter_hs = [gen.submit(head + [3, i], sp, slo="interactive")
                    for i in range(2)]
        t0 = time.perf_counter()
        for h in inter_hs:
            h.result(timeout=600)
        inter_s = time.perf_counter() - t0
        finished = sum(len(h.result(timeout=600)) == CTL_NEW
                       for h in batch_hs)
        for h in blockers:
            h.result(timeout=600)
        batch_s = time.perf_counter() - t0
    finally:
        gen._prefill = real
    queued = [c for c, n in admit if n == CTL_HEAD + 2]
    overtake = queued[:2] == ["interactive"] * 2
    captures = stopped(gen)             # drains, clears the cache, no leak
    same = sum(a == b for a, b in zip(warm, cold))
    res = dict(
        t_req_s=t_req, cold=dict(ttft_p50_ms=pct(cold_ttft, 50),
                                 ttft_p99_ms=pct(cold_ttft, 99)),
        warm=dict(ttft_p50_ms=pct(warm_ttft, 50),
                  ttft_p99_ms=pct(warm_ttft, 99), hits=hits,
                  hit_rate=hits / CTL_REQUESTS,
                  prefill_tokens_skipped=skipped,
                  peak_pages_shared=peak_shared),
        prefix_cache=cache, cow_copies=pool["cow_copies"],
        prefill_replay_device_ms=replay_ms,
        warm_equals_cold=same, requests=CTL_REQUESTS,
        slo=dict(overtake=overtake, queued_admits=queued,
                 interactive_s=inter_s, all_s=batch_s,
                 batch_finished=finished),
        captures=captures, cold_captures=cold_captures)
    log("control (c): bench_control's protocol at phase 11's width, fp32, "
        "%d requests (a %d-token head + 1-8 tokens), %d new each, %d slots, "
        "max_seq %d, Poisson at %gx one request's sequential capacity "
        "(%.3f s): TTFT p50 / p99 cold (no cache) %.2f / %.2f ms, warm "
        "%.2f / %.2f ms; warm pass %d hits of %d (hit rate %.3f), %d "
        "prefill tokens skipped, peak %d pages shared, %d COW copies; one "
        "prefill replay's device ms: cold (bucket 256) %.3f, warm suffix "
        "(bucket 16) %.3f; warm outputs token-identical to the cache-less "
        "generator's: %d of %d; "
        "SLO witness: queued admits %s (overtake %s), interactive done in "
        "%.3f s, all in %.3f s, %d of 2 batch requests finished; captures "
        "%d (cold generator %d); drained with no leaked page; on %s"
        % (CTL_REQUESTS, CTL_HEAD, CTL_NEW, CTL_SLOTS, CTL_MAX_SEQ,
           CTL_LOAD, t_req, res["cold"]["ttft_p50_ms"],
           res["cold"]["ttft_p99_ms"], res["warm"]["ttft_p50_ms"],
           res["warm"]["ttft_p99_ms"], hits, CTL_REQUESTS,
           res["warm"]["hit_rate"], skipped, peak_shared,
           pool["cow_copies"], replay_ms["cold_256"], replay_ms["warm_16"],
           same, CTL_REQUESTS, queued, overtake,
           inter_s, batch_s, finished, captures, cold_captures, card))
    if not (same == CTL_REQUESTS and hits > 0 and skipped > 0 and overtake
            and finished == 2 and captures == n_programs
            and cold_captures == n_programs):
        raise AssertionError("control (c) failed: %s" % json.dumps(res))
    out["c"] = res
    return res


def prefill_graph_summary(mx, results, card, out):
    """(d): each bucket's prefill graph against its eager body (phase 11
    (d)'s rows; measured here when phase 11 did not run), and TTFT under
    phase 11 (d)'s traffic beside PR 9's."""
    gen_out = results.get("generation", {})
    rows = gen_out.get("prefill_ms")
    if rows is None:
        G = mx.serving.generation
        model = mx.parallel.TransformerParallel(
            mx.parallel.make_mesh({"dp": 1}), dtype="float32", **TRAIN_CFG)
        gen = G.Generator(model, model.init(0), gen_config(mx), start=False)
        gen.warmup()
        rows = gen_prefill_timing(gen, card, {})
        stopped(gen)
    cont = gen_out.get("continuous")
    res = dict(per_bucket=rows,
               ttft_ms=(None if cont is None else
                        [cont["ttft_p50_ms"], cont["ttft_p99_ms"]]),
               ttft_ms_pr9=list(PR9_TTFT_MS))
    log("prefill graphs (d): replayed vs eager wall ms per bucket %s; "
        "TTFT p50 / p99 under phase 11 (d)'s traffic %s ms (PR 9, eager "
        "prefill: %.2f / %.2f ms); on %s"
        % (", ".join("%d: %.3f vs %.3f" % (r["bucket"], r["replay_wall_ms"],
                                           r["eager_wall_ms"])
                     for r in rows),
           "not run" if cont is None else "%.2f / %.2f" % tuple(
               res["ttft_ms"]), PR9_TTFT_MS[0], PR9_TTFT_MS[1], card))
    out["d"] = res
    return res


def gen_faults_metrics(mx, card, out):
    """(e): a generation.decode_step fault fails only that step's slots;
    the generation.* series in dump_metrics(); one complete trace."""
    from mxnet_tpu_torch.observability import metrics, request_trace
    from mxnet_tpu_torch.resilience import faults

    G = mx.serving.generation
    model = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                            dtype="float32", **TRAIN_CFG)
    metrics.reset_metrics()
    request_trace.reset()
    faults.configure("generation.decode_step:raise@call=2", seed=0)
    gen = G.Generator(model, model.init(0), G.GenerationConfig(
        prefix_cache=True, max_batch=CTL_SLOTS, max_seq=CTL_MAX_SEQ,
        page_size=GEN_PAGE, decode_blocks=GEN_BLOCKS))
    try:
        h1 = gen.submit(list(range(1, 40)), G.SamplingParams(
            max_new_tokens=8))
        try:
            h1.result(timeout=600)
            failed = False
        except faults.InjectedFault:
            failed = True
        toks = gen.generate(list(range(50, 70)), G.SamplingParams(
            max_new_tokens=4), timeout=600)
        stats = gen.get_stats()
        text = metrics.dump_metrics()
    finally:
        faults.reset()
        stopped(gen)
    series = sorted({line.split("{")[0].split()[0] for line in
                     text.splitlines()
                     if line.startswith("mxnet_generation_")})
    want = ["mxnet_generation_" + n for n in (
        "requests", "ttft_ms", "itl_ms", "decode_faults", "kv_pages_used",
        "tokens_generated", "prefix_misses", "decode_step_ms",
        "slo_completed", "prefill_batches")]
    missing = [w for w in want if not any(s.startswith(w) for s in series)]
    traces = [t for t in request_trace.reservoir().recent()
              if t.status == "ok"]
    trace = traces[-1].to_dict() if traces else {}
    phases = [e[0] for e in traces[-1].events] if traces else []
    complete = (phases[:4] == ["submit", "queue", "prefix_match",
                               "prefill"]
                and phases.count("decode") == 3
                and abs(sum(trace["phases_ms"].values())
                        - trace["total_ms"]) < 1e-3)
    res = dict(first_failed=failed, second_tokens=len(toks),
               decode_faults=stats["decode_faults"], series=series,
               missing=missing, trace_phases=phases,
               trace_complete=complete)
    log("faults (e): generation.decode_step:raise@call=2 failed the first "
        "request: %s; the next served %d tokens; decode_faults %d; %d "
        "generation.* series in dump_metrics() (missing: %s); one trace: "
        "%s, complete %s; on %s"
        % (failed, len(toks), stats["decode_faults"], len(series),
           missing, phases, complete, card))
    if not (failed and len(toks) == 4 and stats["decode_faults"] == 1
            and not missing and complete):
        raise AssertionError("faults (e) failed: %s" % json.dumps(res))
    out["e"] = res
    return res


def autoscale_drive(mx, sym, card, out):
    """(f): the autoscaler over phase 14's ResNet-50 server (one replica,
    buckets (1, 8)) on a fake clock: a queue burst scales 1 -> 2, a hot
    tick inside the cooldown is computed (clamped at 2) and not applied,
    a quiet window scales 2 -> 1, a fault-killed replica with the TTFT
    objective burning scales 1 -> 2."""
    import torch
    from mxnet_tpu_torch.observability import (metrics, slo_monitor,
                                               timeseries)
    from mxnet_tpu_torch.resilience import faults

    np_args, np_aux = resnet50_params(sym, seed=0)
    args, aux = mx.params_from_jax(np_args, np_aux, device="cuda")
    x1 = np.random.default_rng(18).standard_normal(ROW, dtype=np.float32)
    srv = mx.serving.InferenceServer(
        sym, args, aux, data_shapes=[("data", (1,) + ROW)],
        devices=[torch.device("cuda", 0)],
        config=mx.serving.ServingConfig(buckets=AMP_BUCKETS, max_wait_ms=0,
                                        cooldown_ms=AS_BREAKER_MS))
    clk = [0.0]
    sampler = timeseries.TimeSeriesSampler(interval_ms=1000, retain=2000,
                                           clock=lambda: clk[0])
    ttft = metrics.histogram("slo.ttft_ms", buckets=(50, 200))
    mon = slo_monitor.SLOMonitor(sampler.store, [slo_monitor.BurnRateAlert(
        slo_monitor.LatencyObjective("ttft", "slo.ttft_ms", threshold=50.0,
                                     q=0.95),
        short_s=60.0, long_s=600.0, on_threshold=2.0, off_threshold=1.0)])
    pol = mx.serving.control.AutoscalePolicy(
        queue_high=16, queue_low=1, window_s=30, min_replicas=1,
        max_replicas=2, slo_monitor=mon)
    scaler = mx.serving.control.Autoscaler.for_server(
        pol, sampler.store, srv, cooldown_ms=20_000, clock=lambda: clk[0])
    trail = {}

    def tick(t, what):
        clk[0] = t
        sampler.sample_once()
        d = scaler.step(now=t)
        trail[what] = dict(t=t, replicas=d.replicas, action=d.action,
                           applied=d.applied, reason=d.reason,
                           active=len(srv.active_replicas()),
                           programs=len(srv._programs))
        return d

    try:
        srv.warmup()
        sampler.sample_once()                          # t = 0
        futs = [srv.submit(x1) for _ in range(AS_BURST)]
        queued = srv.get_stats()["queue_depth"]
        tick(10.0, "burst")
        srv.warmup()                                   # the new replica
        trail["burst"]["captures"] = srv.get_stats()["bucket_programs"]
        trail["burst"]["programs_after_warmup"] = len(srv._programs)
        trail["burst"]["queued_at_burst"] = queued
        for f in futs:
            f.result(timeout=600)
        for _ in range(20):
            ttft.observe(500.0)
        tick(15.0, "cooldown")                         # SLO firing
        for _ in range(400):
            ttft.observe(5.0)
        for t in (680.0, 690.0):
            clk[0] = t
            sampler.sample_once()
        tick(700.0, "quiet")
        faults.configure("serving.replica_execute[0]:raise@call=1",
                         seed=0)
        # the one replica faults: quarantined, and with no survivor the
        # batch fails fast (the circuit is open)
        try:
            srv.predict(x1, timeout=600)
            failed_fast = False
        except Exception:
            failed_fast = True
        quarantined = len(srv.get_stats()["quarantined_replicas"])
        for _ in range(100):
            ttft.observe(500.0)
        tick(800.0, "fault")
        served = srv.predict(x1, timeout=600)
        trail["fault"].update(failed_fast=failed_fast,
                              quarantined=quarantined,
                              served_after=bool(np.isfinite(served).all()))
    finally:
        faults.reset()
        scaler.stop()
        sampler.stop()
        srv.stop()
    b, c, q, f = (trail[k] for k in ("burst", "cooldown", "quiet", "fault"))
    log("autoscale (f): %d single-image requests at once (%d rows queued): "
        "%s -> %d replicas (%s); warmup -> %d captures, %d live programs; "
        "a hot tick 5 s later: %s to %d, applied %s (%s); quiet window: %s "
        "-> %d replicas, %d live programs; replica 0 fault-killed (its "
        "request failed fast: %s) with the TTFT objective burning: %s -> "
        "%d (%s), applied %s, the next request served: %s; on %s"
        % (AS_BURST, b["queued_at_burst"], b["action"], b["active"],
           b["reason"], b["captures"], b["programs_after_warmup"],
           c["action"], c["replicas"], c["applied"], c["reason"],
           q["action"], q["active"], q["programs"], f["failed_fast"],
           f["action"], f["active"], f["reason"], f["applied"],
           f["served_after"], card))
    n_b = len(AMP_BUCKETS)
    if not (b["action"] == "up" and b["applied"] and b["active"] == 2
            and b["captures"] == b["programs_after_warmup"] == 2 * n_b
            and c["action"] == "up" and c["replicas"] == 2
            and not c["applied"] and "cooldown" in c["reason"]
            and q["action"] == "down" and q["applied"] and q["active"] == 1
            and q["programs"] == n_b
            and f["action"] == "up" and f["applied"] and f["active"] == 2
            and "replicas lost (0/1 available)" in f["reason"]
            and f["failed_fast"] and f["quarantined"] == 1
            and f["served_after"]):
        raise AssertionError("autoscale (f) failed: %s" % json.dumps(trail))
    out["f"] = trail
    return trail


def amp_control_phase(mx, sym, card, peaks, results):
    """Phase 17: mixed precision and the generation control plane."""
    import torch

    from mxnet_tpu_torch.observability import metrics

    out = {}
    metrics.set_enabled(True)
    try:
        amp_serve(mx, sym, card, peaks, out)
        torch.cuda.empty_cache()
        amp_generation(mx, card, out)
        torch.cuda.empty_cache()
        control_protocol(mx, card, out)
        prefill_graph_summary(mx, results, card, out)
        gen_faults_metrics(mx, card, out)
        torch.cuda.empty_cache()
        autoscale_drive(mx, sym, card, out)
    finally:
        metrics.set_enabled(False)
    torch.cuda.empty_cache()
    results["amp_control"] = out
    return out


# ------------------------------------------------------ phase 18: int8

Q_BATCH = 16             # (a): bench_quantize's predict batch (bench_all.py:2329)
Q_STEPS = 50             # (a): timed Module.predict calls of each arm
Q_EVAL_ROWS = 256        # (a): rows of the top-1 agreement
Q_CALIB = 3              # calibration batches
Q_TOP1 = 0.99            # bench_all.py:2478: the bench's predict gate
# the JAX package's int8-vs-fp32 top-1 agreement on (a)'s weights and
# inputs, on the CPU (tools/port_quant_conditioning.py): the random net's
# top-1 is decided by small margins, so the bench's gate fails for the
# reference too, and (a) holds the port to the reference instead
Q_JAX_TOP1 = 0.90625
Q_TOP1_MARGIN = 0.05     # card against CPU: fp32 cuDNN moves near-ties
Q_PROFILED = 3           # (a): predicts of each arm under torch.profiler
Q_INT_SCOPE = "q::int_contraction"
Q_MM_OPS = ("aten::linear", "aten::addmm", "aten::mm", "aten::matmul",
            "aten::bmm", "aten::tensordot")
Q_BUCKETS = (1, 8)       # (b)
Q_LATENCY_N = 30         # (b): sequential requests per bucket
Q_BATCHES = 16           # (b): back-to-back 8-row requests
Q_LM = dict(vocab=256, d_model=256, n_heads=4, n_layers=4, d_ff=256,
            n_experts=2)   # (c): bench_quantize's decode model
Q_MAX_BATCH, Q_MAX_SEQ, Q_MAX_NEW, Q_REQUESTS = 8, 256, 24, 24
Q_STEP_CTX = 128         # (c): context of the profiled decode steps
Q_BYTES_GATE = 0.55      # bench_all.py:2481: int8 / bf16 bytes a token
Q_TOKEN_GATE = 0.9       # bench_all.py:2485: int8 token agreement


class int_scope:
    """A scope in which every exact integer contraction (the int8
    islands' convolutions, FCs and matmuls, casts and round included)
    runs under the ``Q_INT_SCOPE`` profiler mark."""

    def __enter__(self):
        import importlib

        from torch.profiler import record_function

        self.mods = [importlib.import_module("mxnet_tpu_torch.ops." + m)
                     for m in ("nn", "matrix")]
        self.real = self.mods[0].integer_contraction

        def marked(*args, **kwargs):
            with record_function(Q_INT_SCOPE):
                return self.real(*args, **kwargs)

        for m in self.mods:
            m.integer_contraction = marked
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.integer_contraction = self.real


def q_families(prof, n):
    """Device ms per predict by family: a kernel under the integer scope is
    an int contraction's (its convolution, GEMM, or casts and round),
    another under a convolution or matmul op an fp32 one, the rest by
    name; the launches the profiler could not link to an op (the fused
    kernel's ctypes launches) by name. Also the aten ops the integer
    contractions ran (the route)."""
    import torch

    fams, linked, route = {}, {}, set()
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        names, e = [], ev
        while e is not None:
            names.append(e.name)
            e = e.cpu_parent
        is_int = Q_INT_SCOPE in names
        if is_int and ev.kernels and ev.name.startswith("aten::"):
            route.add(ev.name)
        for k in ev.kernels:
            if any("convolution" in m for m in names):
                kind = "conv"
            elif any(m in Q_MM_OPS for m in names):
                kind = "GEMM"
            else:
                kind = "casts and round" if is_int else kernel_family(
                    k.name)
            fam = ("int " + kind) if is_int else (
                "fp32 " + kind if kind in ("conv", "GEMM") else kind)
            fams[fam] = fams.get(fam, 0.0) + k.duration
            linked[k.name] = linked.get(k.name, 0.0) + k.duration
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if getattr(ev, "is_user_annotation", False) or \
                ev.key == Q_INT_SCOPE:
            continue
        total += us
        rest = us - linked.get(ev.key, 0.0)
        if rest > 0:
            fam = kernel_family(ev.key)
            fams[fam] = fams.get(fam, 0.0) + rest
    if not total:
        raise AssertionError("torch.profiler recorded no device time")
    return ({k: v / 1e3 / n for k, v in fams.items()}, total / 1e3 / n,
            sorted(route))


def q_predict(mx, card, rng, out):
    """(a): bench_quantize's predict half (bench_all.py:2326-2397) in full:
    ResNet-50 NCHW at 224, batch 16, 1000 classes, Xavier from seed 0 with
    fc1_weight x 8, calibrated over 3 random batches; fp32 (``default``)
    against int8 (``default,quantize``) on identical weights, 50 timed
    Module.predict calls each, top-1 agreement over 256 rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    bs, size = Q_BATCH, 224
    sym = mx.models.get_resnet(num_classes=1000, num_layers=50,
                               image_shape=(3, size, size))
    x = rng.rand(bs, 3, size, size).astype(np.float32)
    eval_x = rng.rand(Q_EVAL_ROWS, 3, size, size).astype(np.float32)

    def build(spec):
        mx.graph_pass.set_passes(spec)
        try:
            mod = mx.mod.Module(sym, context=mx.gpu())
            mod.bind(data_shapes=[("data", x.shape)], for_training=False)
            # Xavier draws from numpy's global generator (the JAX
            # package's initializer does too): seed 0
            np.random.seed(0)
            mod.init_params(mx.init.Xavier())
            args, auxs = mod.get_params()
            args = dict(args)
            args["fc1_weight"] = args["fc1_weight"] * 8.0
            mod.set_params(args, auxs)
            return mod
        finally:
            mx.graph_pass.set_passes(None)

    def it(data):
        return mx.io.NDArrayIter(data, None, batch_size=bs)

    def run(mod):
        mod.predict(it(x))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(Q_STEPS):
            mod.predict(it(x))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / Q_STEPS
        with int_scope(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            for _ in range(Q_PROFILED):
                mod.predict(it(x))
            torch.cuda.synchronize()
        return dt, mod.predict(it(eval_x)).asnumpy(), prof

    t0 = time.perf_counter()
    fp32 = build("default")
    table = mx.graph_pass.calibrate(
        fp32, [rng.rand(bs, 3, size, size).astype(np.float32)
               for _ in range(Q_CALIB)])
    calib_s = time.perf_counter() - t0
    fp32_s, fp32_out, fp32_prof = run(fp32)
    mx.graph_pass.set_calibration_table(table)
    try:
        q = build("default,quantize")
        q.set_params(*fp32.get_params())   # identical weights, both arms
        q_s, q_out, q_prof = run(q)
    finally:
        mx.graph_pass.set_calibration_table(None)
    qinfo = q._exec_group.execs[0]._opt.summary()["quantize"]
    folded = q._exec_group.execs[0]._folded()
    int8_weights = sum(1 for v in folded.values() if v.dtype == torch.int8)
    top1 = float((fp32_out.argmax(1) == q_out.argmax(1)).mean())
    fams = {}
    for arm, prof in (("fp32", fp32_prof), ("int8", q_prof)):
        f, dev, route = q_families(prof, Q_PROFILED)
        fams[arm] = dict(families_ms=f, device_ms=dev, route=route)
    int_ms = sum(v for k, v in fams["int8"]["families_ms"].items()
                 if k.startswith("int "))
    res = dict(
        fp32_ms=fp32_s * 1e3, int8_ms=q_s * 1e3, speedup=fp32_s / q_s,
        images_per_s={"fp32": bs / fp32_s, "int8": bs / q_s},
        top1_agreement=top1, coverage=qinfo, int8_weights=int8_weights,
        table_entries=len(table), calibrate_s=calib_s, profile=fams,
        int_contraction_ms=int_ms,
        int_share=int_ms / fams["int8"]["device_ms"],
        bench_gate_met=top1 >= Q_TOP1, jax_top1_agreement=Q_JAX_TOP1,
        fp32_classes=int(len(set(fp32_out.argmax(1)))),
        output_finite=bool(np.isfinite(q_out).all()),
        output_shape=list(q_out.shape))
    log("quantize (a): bench_quantize predict, ResNet-50 NCHW %dx%d batch "
        "%d, Xavier (numpy seed 0) with fc1_weight x 8, calibrated over %d "
        "batches (%d table entries, %.1f s): fp32 %.3f ms a batch (%.1f "
        "img/s), int8 %.3f ms (%.1f img/s), %.3fx; top-1 agreement over %d "
        "rows %.4f, the bench's gate >= %g %s; the JAX package's on the "
        "same weights and inputs (CPU) %.4f, held within %g; the fp32 arm "
        "predicts %d classes; coverage %d of %d ops (%s), %d int8 weight "
        "tensors folded; on %s"
        % (size, size, bs, Q_CALIB, len(table), calib_s, res["fp32_ms"],
           res["images_per_s"]["fp32"], res["int8_ms"],
           res["images_per_s"]["int8"], res["speedup"], Q_EVAL_ROWS, top1,
           Q_TOP1, "met" if top1 >= Q_TOP1 else "NOT met", Q_JAX_TOP1,
           Q_TOP1_MARGIN, res["fp32_classes"], qinfo["ops_quantized"],
           qinfo["ops_eligible"], qinfo["skipped"] or "none skipped",
           int8_weights, card))
    for arm in ("fp32", "int8"):
        f = fams[arm]
        log("quantize (a): %s predict, device %.3f ms a batch "
            "(torch.profiler over %d predicts)%s"
            % (arm, f["device_ms"], Q_PROFILED,
               "; the integer contractions ran %s, %.3f ms (%.3f of it)"
               % (f["route"], int_ms, res["int_share"])
               if arm == "int8" else ""))
        for fam, v in sorted(f["families_ms"].items(), key=lambda kv: -kv[1]):
            log("    %9.3f ms  %.3f  %s" % (v, v / f["device_ms"], fam))
    if not (top1 >= Q_JAX_TOP1 - Q_TOP1_MARGIN and res["output_finite"]
            and res["output_shape"] == [Q_EVAL_ROWS, 1000]
            and qinfo["ops_quantized"] == qinfo["ops_eligible"] > 0
            and int8_weights == qinfo["ops_quantized"]
            and fams["int8"]["route"]):
        raise AssertionError("quantize (a) failed: %s"
                             % json.dumps(res, default=str))
    out["a"] = res
    return res


def q_walk_profile(srv, x):
    """Device ms by family of the served program's eager walk (the body of
    its bucket graph) on ``x``, over Q_PROFILED walks under
    torch.profiler, the integer contractions marked."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eager_outputs(srv, 0, x)
    torch.cuda.synchronize()
    with int_scope(), profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        for _ in range(Q_PROFILED):
            eager_outputs(srv, 0, x)
        torch.cuda.synchronize()
    fams, dev, route = q_families(prof, Q_PROFILED)
    return dict(families_ms=fams, device_ms=dev, route=route,
                int_ms=sum(v for k, v in fams.items()
                           if k.startswith("int ")))


def q_server(mx, served, args, aux, **kw):
    import torch

    return mx.serving.InferenceServer(
        served, args, aux, data_shapes=[("data", (1,) + ROW)],
        devices=[torch.device("cuda", 0)],
        config=mx.serving.ServingConfig(buckets=Q_BUCKETS, max_wait_ms=0),
        **kw)


def q_serve(mx, sym, card, out):
    """(b): phase 3's NHWC ResNet-50 behind InferenceServer(quantize=
    table), buckets (1, 8), one replica, calibrated by ``calibrate`` under
    the serving spec minus quantize (the default pipeline)."""
    import torch
    from mxnet_tpu_torch import cuda_build, cuda_graph

    np_args, np_aux = resnet50_params(sym, seed=0)
    center_fc_bias(mx, sym, np_args, np_aux, np.random.default_rng(1))
    served = mx.sym.Group([sym, sym.get_internals()["fc1_output"]])
    rng = np.random.default_rng(18)
    images = rng.standard_normal((8,) + ROW, dtype=np.float32)
    batch = rng.standard_normal((8,) + ROW, dtype=np.float32)
    mod = mx.mod.Module(served, context=mx.gpu())
    mod.bind(data_shapes=[("data", (8,) + ROW)], for_training=False)
    mod.set_params({k: mx.nd.array(v, ctx=mx.cpu())
                    for k, v in np_args.items()},
                   {k: mx.nd.array(v, ctx=mx.cpu())
                    for k, v in np_aux.items()})
    table = mx.graph_pass.calibrate(
        mod, [rng.standard_normal((8,) + ROW, dtype=np.float32)
              for _ in range(Q_CALIB)])
    del mod
    args, aux = mx.params_from_jax(np_args, np_aux, device="cuda")
    srv = q_server(mx, served, args, aux)
    try:
        fp32 = amp_answers(srv, images, batch)
        fp32_profile = q_walk_profile(srv, batch)
    finally:
        srv.stop()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    srv = q_server(mx, served, args, aux, quantize=table)
    try:
        srv.warmup()
        same = {}
        for b in Q_BUCKETS:
            x = rng.standard_normal((b,) + ROW, dtype=np.float32)
            got, want = replay_vs_eager(srv, 0, x)
            same[b] = all(np.array_equal(g, w) for g, w in zip(got, want))
    finally:
        srv.stop()
        torch.backends.cudnn.deterministic = det
    cuda_build.reset_launch_counts()
    srv = q_server(mx, served, args, aux, quantize=table)
    try:
        warmed = srv.warmup()
        captured = cuda_build.launch_counts().get("fused_matmul", 0)
        cuda_build.reset_launch_counts()
        eager_outputs(srv, 0, batch)
        torch.cuda.synchronize()
        per_body = cuda_build.launch_counts().get("fused_matmul", 0)
        cuda_build.reset_launch_counts()
        stats0 = srv.get_stats()
        int8 = amp_answers(srv, images, batch)
        lat = {}
        for b in Q_BUCKETS:
            x = rng.standard_normal((b,) + ROW, dtype=np.float32)
            srv.predict(x, timeout=600)
            ts = []
            for _ in range(Q_LATENCY_N):
                t0 = time.perf_counter()
                srv.predict(x, timeout=600)
                ts.append((time.perf_counter() - t0) * 1e3)
            lat[b] = float(np.percentile(ts, 50))
        t0 = time.perf_counter()
        futs = [srv.submit(batch) for _ in range(Q_BATCHES)]
        for f in futs:
            f.result(timeout=600)
        img_s = Q_BATCHES * batch.shape[0] / (time.perf_counter() - t0)
        stats = srv.get_stats()
        traffic_wrapper = cuda_build.launch_counts().get("fused_matmul", 0)
        int8_args = sum(1 for v in srv._replica_args[0].values()
                        if v.dtype == torch.int8)
        int8_profile = q_walk_profile(srv, batch)
    finally:
        srv.stop()
    report = stats["graph_pass"]
    q = report["quantize"]
    regions = report["fuse"]["regions"]
    int_regions = sum(1 for r in regions if r["base"].endswith("_int"))
    err, top1 = compare(int8, fp32, "int8 vs fp32 server")
    replays = stats.get("batches", 0) - stats0.get("batches", 0)
    res = dict(
        coverage={k: q[k] for k in ("ops_quantized", "ops_eligible",
                                    "skipped")},
        table_entries=len(table), regions=len(regions),
        int_regions=int_regions, kernel_regions=per_body,
        fused_matmul_per_replay=per_body, capture_launches=captured,
        warmup=warmed, captures=stats["bucket_programs"],
        captures_before_traffic=stats0["bucket_programs"],
        replay_equals_eager=same, replays=replays,
        traffic_wrapper_launches=traffic_wrapper, int8_weights=int8_args,
        logit_err_vs_fp32=err, top1_vs_fp32=top1,
        p50_ms={str(b): lat[b] for b in Q_BUCKETS},
        img_per_s_bucket8=img_s,
        profile={"fp32": fp32_profile, "int8": int8_profile})
    log("quantize (b): ResNet-50 NHWC behind InferenceServer(quantize="
        "table), buckets %s, one replica: table of %d entries from "
        "calibrate under the default pipeline; coverage %d of %d (%s); %d "
        "int8 weight tensors per replica; %d fuse regions, %d rooted at an "
        "int32 contraction, %d take fused_matmul (%d wrapper launches at "
        "the %d captures, %d a replay of the eager walk); each replay "
        "equal to its eager walk to the bit (cuDNN deterministic): %s; "
        "logits vs the fp32 server %.4g of max |logit|, top-1 agreement "
        "%.3f (reported); p50 %s ms, %.1f img/s at bucket 8; captures %d "
        "before traffic, %d after %d replays; on %s"
        % (Q_BUCKETS, len(table), q["ops_quantized"], q["ops_eligible"],
           q["skipped"] or "none skipped", int8_args, len(regions),
           int_regions, per_body, captured, warmed, per_body, same, err,
           top1, {b: round(v, 3) for b, v in lat.items()}, img_s,
           stats0["bucket_programs"], stats["bucket_programs"], replays,
           card))
    for arm, f in res["profile"].items():
        log("quantize (b): %s server, bucket 8 walk (the replay's body), "
            "device %.3f ms (torch.profiler over %d walks); integer "
            "contractions %.3f ms (%.3f of it)"
            % (arm, f["device_ms"], Q_PROFILED, f["int_ms"],
               f["int_ms"] / f["device_ms"]))
        for fam, v in sorted(f["families_ms"].items(),
                             key=lambda kv: -kv[1]):
            log("    %9.3f ms  %.3f  %s" % (v, v / f["device_ms"], fam))
    if not (all(same.values()) and warmed == len(Q_BUCKETS)
            and stats["bucket_programs"] == stats0["bucket_programs"]
            == len(Q_BUCKETS) and not traffic_wrapper
            and captured == per_body * warmed * (1 + cuda_graph.WARMUP_RUNS)
            and q["ops_quantized"] > 0 and int8_args == q["ops_quantized"]
            and int_regions > 0):
        raise AssertionError("quantize (b) failed: %s"
                             % json.dumps(res, default=str))
    out["b"] = res
    return res


def q_decode(mx, card, rng, out):
    """(c): bench_quantize's decode half (bench_all.py:2399-2457) in full:
    the fp32 LM at vocab 256, d_model 256, 4 heads, 4 layers, d_ff 256, 2
    experts, init(0); 24 greedy requests of 2 to 231 tokens, 24 new each,
    8 slots, max_seq 256, with kv_dtype model, bfloat16 and int8. The
    decode step of the bf16 and int8 arms profiled beside."""
    import torch

    G = mx.serving.generation
    model = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                            dtype="float32", **Q_LM)
    params = model.init(0)
    prompts = [[int(t) for t in rng.randint(1, Q_LM["vocab"],
                                            size=int(p))]
               for p in rng.randint(2, Q_MAX_SEQ - Q_MAX_NEW,
                                    size=Q_REQUESTS)]
    mean_ctx = float(np.mean([len(p) + Q_MAX_NEW / 2 for p in prompts]))
    step_prompts = gen_prompts(Q_MAX_BATCH, Q_STEP_CTX, Q_STEP_CTX + 1,
                               Q_LM["vocab"], 7)
    sp = G.SamplingParams(max_new_tokens=Q_MAX_NEW)
    arms, tokens = {}, {}
    for kv in ("model", "bfloat16", "int8"):
        gen = G.Generator(model, params, G.GenerationConfig(
            max_batch=Q_MAX_BATCH, max_seq=Q_MAX_SEQ, kv_dtype=kv),
            start=False)
        warmed = gen.warmup()
        arm = {}
        if kv != "model":
            arm["decode_step"] = decode_step_profile(
                gen, step_prompts, G.SamplingParams(max_new_tokens=16))
        gen.start()
        base = gen.graph_launches().get("flash_attention_fwd", 0)
        prefills0 = gen.get_stats().get("prefills", 0)
        got, wall = serve_all(gen, [(p, sp) for p in prompts])
        launches = gen.graph_launches().get("flash_attention_fwd", 0) - base
        prefills = gen.get_stats().get("prefills", 0) - prefills0
        captures = stopped(gen)
        tokens[kv] = got
        arm.update(
            tokens_per_s=sum(len(t) for t in got) / wall, wall_s=wall,
            hbm_bytes_per_token=gen.kv_read_bytes_per_token(mean_ctx),
            bytes_per_cached_token=gen.pool.bytes_per_token,
            warmed=warmed, captures=captures, prefills=prefills,
            flash_fwd_launches=launches,
            pool_dtype=str(gen._pools["k"].dtype),
            scale_pools=sorted(k for k in gen._pools if k.endswith("s")))
        arms[kv] = arm
        del gen
        torch.cuda.empty_cache()
    for kv in ("bfloat16", "int8"):
        pairs = [(a, b) for r, s in zip(tokens["model"], tokens[kv])
                 for a, b in zip(r, s)]
        arms[kv]["token_agreement"] = float(np.mean([a == b
                                                     for a, b in pairs]))
    ratio = (arms["int8"]["hbm_bytes_per_token"]
             / max(1, arms["bfloat16"]["hbm_bytes_per_token"]))
    n_programs = len(G.default_prefill_ladder(Q_MAX_SEQ)) + 1
    paged = {kv: arms[kv]["decode_step"]["families_ms"].get(
        "paged attention", 0.0) for kv in ("bfloat16", "int8")}
    res = dict(arms=arms, mean_ctx=mean_ctx, int8_vs_bf16_bytes_ratio=ratio,
               int8_vs_bf16_tokens_ratio=(arms["int8"]["tokens_per_s"]
                                          / arms["bfloat16"]["tokens_per_s"]),
               paged_attention_ms=paged, n_programs=n_programs)
    log("quantize (c): bench_quantize decode, LM %s fp32 init(0), %d greedy "
        "requests of 2 to %d tokens, %d new, %d slots, max_seq %d, mean "
        "context %.1f; int8 / bf16 bytes a token %.4f (gate <= %g); on %s"
        % (Q_LM, Q_REQUESTS, Q_MAX_SEQ - Q_MAX_NEW - 1, Q_MAX_NEW,
           Q_MAX_BATCH, Q_MAX_SEQ, mean_ctx, ratio, Q_BYTES_GATE, card))
    for kv, a in arms.items():
        step = a.get("decode_step")
        log("quantize (c): kv_dtype %-8s pages %s%s: %.1f tokens/s, %d "
            "hbm bytes a token, %d bytes a cached token, token agreement "
            "with model %s; %d programs warmed, %d captures after traffic; "
            "%d flash forward launches over %d prefills%s"
            % (kv, a["pool_dtype"], " + fp32 scales" if a["scale_pools"]
               else "", a["tokens_per_s"], a["hbm_bytes_per_token"],
               a["bytes_per_cached_token"],
               "%.4f" % a["token_agreement"] if kv != "model" else "-",
               a["warmed"], a["captures"], a["flash_fwd_launches"],
               a["prefills"],
               "; decode step at %d x %d tokens: replayed %.3f ms (graph "
               "%.3f), eager %.3f, device %.3f ms, busy %.3f, paged "
               "attention %.3f ms, replay equals eager: %s"
               % (Q_MAX_BATCH, Q_STEP_CTX, step["replay_ms"],
                  step["replay_device_ms"], step["eager_ms"],
                  step["device_ms"], step["busy"], paged[kv],
                  step["graph_equals_eager"]) if step else ""))
    n_layers = Q_LM["n_layers"]
    if not (ratio <= Q_BYTES_GATE
            and arms["int8"]["token_agreement"] >= Q_TOKEN_GATE
            and all(a["warmed"] == a["captures"] == n_programs
                    for a in arms.values())
            and all(a["decode_step"]["graph_equals_eager"]
                    for kv, a in arms.items() if kv != "model")
            and arms["int8"]["pool_dtype"] == "torch.int8"
            and arms["int8"]["scale_pools"] == ["ks", "vs"]
            and all(a["flash_fwd_launches"] == n_layers * a["prefills"]
                    for a in arms.values())):
        raise AssertionError("quantize (c) failed: %s"
                             % json.dumps(res, default=str))
    out["c"] = res
    return res


def quantize_phase(mx, sym, card, results):
    """Phase 18: int8 through bench_all.py --quantize's protocol
    (bench_quantize, bench_all.py:2299), on the card, through the port."""
    import torch

    t0 = time.perf_counter()
    out = {}
    # one generator for (a) and (c), drawn in the bench's order
    rng = np.random.RandomState(0)
    q_predict(mx, card, rng, out)
    torch.cuda.empty_cache()
    q_serve(mx, sym, card, out)
    torch.cuda.empty_cache()
    q_decode(mx, card, rng, out)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log("quantize: phase 18 took %.1f s" % out["seconds"])
    results["quantize"] = out
    return out


# ------------------------------------------------ phase 19: data and IO
# (a): bench_all.py:2497-2689 bench_input_pipeline at its full size
IO_N, IO_SIZE, IO_BATCH, IO_EPOCHS = 512, 224, 32, 3
IO_GATE = 1.5            # streaming >= 1.5 x sync_serial, the bench's gate
IO_ARMS = ("sync_serial", "sync_pooled", "streaming")
IO_FIT_SEED, IO_FIT_LR = 5, 0.01
# (b): ResNet-50 NHWC fed from (a)'s records through ImageRecordIter,
# phase 9's initialisation and optimizer, 2 epochs of 16 steps
IO_RN_EPOCHS, IO_RN_PROFILED = 2, 3
IMAGENET_MEAN = (123.68, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
# (c): detection records for phase 15's SSD-300
DET_N, DET_SIZE, DET_BATCH, DET_STEPS, DET_LR = 64, 300, 8, 3, 1e-3


def io_build_rec(mx, path, n, size):
    """tools/io_smoke.py:33-47 build_rec through the port's recordio:
    random uint8 images from RandomState(0), JPEG quality 90, label =
    record id; returns (.rec, .idx)."""
    rng = np.random.RandomState(0)
    rec, idx = path + ".rec", path + ".idx"
    w = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.randint(0, 255, (size, size, 3)).astype(np.uint8)
        w.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(i), i, 0), img, img_fmt=".jpg",
            quality=90))
    w.close()
    return rec, idx


def io_make(mx, kind, rec, idx):
    """The bench's three arms (bench_all.py:2539-2550), batches on the
    card."""
    shape = (3, IO_SIZE, IO_SIZE)
    if kind == "sync_serial":
        return mx.io.ImageRecordIter(rec, shape, IO_BATCH, path_imgidx=idx,
                                     streaming=False, preprocess_threads=1,
                                     prefetch_buffer=2)
    if kind == "sync_pooled":
        return mx.io.ImageRecordIter(rec, shape, IO_BATCH, path_imgidx=idx,
                                     streaming=False)
    return mx.io.ImageRecordIter(rec, shape, IO_BATCH, path_imgidx=idx,
                                 streaming=True)


def io_reader(it):
    """(reader class, native?) of an arm's record reader."""
    rd = (it._source._record if hasattr(it, "_source")
          else it.iters[0].imgrec)
    return type(rd).__name__, rd._lib is not None


def io_iter_throughput(mx, kind, rec, idx):
    """bench_all.py:2552-2565: a warm epoch, then IO_EPOCHS timed; img/s,
    the reader, and the streaming arm's stage figures."""
    it = io_make(mx, kind, rec, idx)
    try:
        reader = io_reader(it)
        for _ in it:
            pass
        rows = 0
        t0 = time.perf_counter()
        for _ in range(IO_EPOCHS):
            it.reset()
            for b in it:
                rows += IO_BATCH - (b.pad or 0)
        out = {"img_per_s": rows / (time.perf_counter() - t0),
               "reader": reader[0], "native_reader": reader[1]}
        if hasattr(it, "get_stats"):
            st = it.get_stats()
            out.update(decode_backend=st["decode_backend"],
                       decode_workers=st["decode_workers"],
                       prefetch_depth=st["prefetch_depth"],
                       stage_depth=st["stage_depth"], stages=st["stages"])
        else:
            out["decode_threads"] = (it.iters[0]._pool._max_workers
                                     if it.iters[0]._pool is not None else 1)
        return out
    finally:
        it.close()


def io_exactness(mx, rec, idx):
    """bench_all.py:2570-2591: sync_pooled and streaming hand out the same
    batch sequence, bit for bit, pads and labels included (lockstep)."""
    import itertools

    ref, got = io_make(mx, "sync_pooled", rec, idx), \
        io_make(mx, "streaming", rec, idx)
    n = 0
    try:
        sentinel = object()
        for i, (rb, gb) in enumerate(itertools.zip_longest(
                ref, got, fillvalue=sentinel)):
            if rb is sentinel or gb is sentinel:
                raise AssertionError("io (a): exactness guard: the batch "
                                     "counts diverged")
            if int(rb.pad or 0) != int(gb.pad or 0) or \
                    not np.array_equal(rb.data[0].asnumpy(),
                                       gb.data[0].asnumpy()) or \
                    not np.array_equal(rb.label[0].asnumpy(),
                                       gb.label[0].asnumpy()):
                raise AssertionError("io (a): exactness guard failed at "
                                     "batch %d" % i)
            n += 1
    finally:
        ref.close()
        got.close()
    return n


class io_timed_iter:
    """Times next() on the consumer thread (bench_all.py:2594-2624): the
    host-stall measurement of a fit arm."""

    def __init__(self, inner):
        self._it = inner
        self.wait_s = 0.0
        self.provide_data = inner.provide_data
        self.provide_label = inner.provide_label
        self.batch_size = inner.batch_size

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return next(self._it)
        finally:
            self.wait_s += time.perf_counter() - t0

    next = __next__

    def reset(self):
        self._it.reset()

    def close(self):
        self._it.close()


def io_small_net(mx):
    """bench_all.py:2626-2635: the bench's small conv net."""
    x = mx.sym.Variable("data")
    x = mx.sym.Convolution(x, num_filter=16, kernel=(3, 3), stride=(2, 2),
                           name="c1")
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=10, name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


class io_compile_count:
    """CUDA graph captures (``cuda_graph.capture`` calls), kernel builds
    (nvcc libraries and NVRTC programs) within it: the compile-flatness
    guard's counts."""

    def __init__(self, mx):
        self.mx = mx

    def _builds(self):
        from mxnet_tpu_torch import cuda_build, nvrtc

        return len(cuda_build._info) + nvrtc.compile_count()

    def __enter__(self):
        from mxnet_tpu_torch import cuda_graph

        self.captures = 0
        self._real = cuda_graph.capture

        def counted(*a, **k):
            self.captures += 1
            return self._real(*a, **k)

        cuda_graph.capture = counted
        self._b0 = self._builds()
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch import cuda_graph

        cuda_graph.capture = self._real
        self.builds = self._builds() - self._b0


def io_fit_arm(mx, kind, rec, idx):
    """bench_all.py:2637-2655 on the card: img/s, host stall (time in
    next() over the wall) and the arm's captures and kernel builds."""
    import torch

    np.random.seed(IO_FIT_SEED)
    mx.random.seed(IO_FIT_SEED)
    it = io_timed_iter(io_make(mx, kind, rec, idx))
    mod = mx.mod.Module(io_small_net(mx), context=mx.gpu())
    with io_compile_count(mx) as cc:
        t0 = time.perf_counter()
        try:
            mod.fit(it, num_epoch=IO_EPOCHS, optimizer="sgd",
                    optimizer_params=(("learning_rate", IO_FIT_LR),),
                    initializer=mx.init.Uniform(0.1))
            torch.cuda.synchronize()
        finally:
            it.close()
        wall = time.perf_counter() - t0
    return {"img_per_s": IO_EPOCHS * IO_N / wall,
            "host_stall": it.wait_s / wall, "wall_s": wall,
            "captures": cc.captures, "kernel_builds": cc.builds}


def io_bench(mx, card, rec, idx, out):
    """(a): bench_input_pipeline's protocol in full through the port."""
    ips = {k: io_iter_throughput(mx, k, rec, idx) for k in IO_ARMS}
    for k in IO_ARMS:
        if not ips[k]["native_reader"]:
            raise AssertionError("io (a): the %s arm read through the "
                                 "Python reader" % k)
    n_exact = io_exactness(mx, rec, idx)
    io_fit_arm(mx, "sync_pooled", rec, idx)        # warm
    fit = {"sync": io_fit_arm(mx, "sync_pooled", rec, idx),
           "streaming": io_fit_arm(mx, "streaming", rec, idx)}
    for what in ("captures", "kernel_builds"):
        if fit["streaming"][what] > fit["sync"][what]:
            raise AssertionError("io (a): streaming added %s (%d vs %d)"
                                 % (what, fit["streaming"][what],
                                    fit["sync"][what]))
    ratio = ips["streaming"]["img_per_s"] / ips["sync_serial"]["img_per_s"]
    st = ips["streaming"]
    log("io (a): %d %dx%d JPEGs, batch %d, %d timed epochs on %s: "
        "iterator img/s sync_serial %.1f (%s, native %s, 1 decode thread), "
        "sync_pooled %.1f (%d threads), streaming %.1f (%s, %s backend, %d "
        "workers, prefetch %d, stage %d): streaming / sync_serial %.3f "
        "(gate %.1f), / sync_pooled %.3f; exactness: %d batches of "
        "sync_pooled and streaming equal to the bit"
        % (IO_N, IO_SIZE, IO_SIZE, IO_BATCH, IO_EPOCHS, card,
           ips["sync_serial"]["img_per_s"], ips["sync_serial"]["reader"],
           ips["sync_serial"]["native_reader"],
           ips["sync_pooled"]["img_per_s"],
           ips["sync_pooled"]["decode_threads"], st["img_per_s"],
           st["reader"], st["decode_backend"], st["decode_workers"],
           st["prefetch_depth"], st["stage_depth"], ratio, IO_GATE,
           st["img_per_s"] / ips["sync_pooled"]["img_per_s"], n_exact))
    log("io (a): streaming stages (per batch / row): %s"
        % json.dumps(st["stages"]))
    log("io (a): fit (the bench's conv net, Uniform(0.1), SGD %.2f, %d "
        "epochs): sync %.1f img/s, host stall %.4f, %d captures, %d kernel "
        "builds; streaming %.1f img/s, host stall %.4f, %d captures, %d "
        "kernel builds"
        % (IO_FIT_LR, IO_EPOCHS, fit["sync"]["img_per_s"],
           fit["sync"]["host_stall"], fit["sync"]["captures"],
           fit["sync"]["kernel_builds"], fit["streaming"]["img_per_s"],
           fit["streaming"]["host_stall"], fit["streaming"]["captures"],
           fit["streaming"]["kernel_builds"]))
    if ratio < IO_GATE:
        raise AssertionError("io (a): streaming %.1f img/s is only %.3f x "
                             "sync_serial's %.1f (gate %.1f)"
                             % (st["img_per_s"], ratio,
                                ips["sync_serial"]["img_per_s"], IO_GATE))
    out["a"] = {"iterator": ips, "streaming_vs_sync_serial": ratio,
                "streaming_vs_sync_pooled":
                    st["img_per_s"] / ips["sync_pooled"]["img_per_s"],
                "exact_batches": n_exact, "fit": fit}


def io_resnet_sym(mx):
    """ResNet-50 NHWC composed onto transpose(data, axes=(0, 2, 3, 1)):
    the record iterators' NCHW batches feed the NHWC graph."""
    net = mx.models.get_resnet(1000, 50, layout="NHWC")
    return net(data=mx.sym.transpose(mx.sym.Variable("data"),
                                     axes=(0, 2, 3, 1)))


def io_record_iter(mx, rec, idx):
    kw = {}
    for c, m, s in zip("rgb", IMAGENET_MEAN, IMAGENET_STD):
        kw["mean_" + c], kw["std_" + c] = m, s
    return mx.io.ImageRecordIter(rec, (3, IO_SIZE, IO_SIZE), RN_BATCH,
                                 path_imgidx=idx, streaming=True,
                                 rand_mirror=True, **kw)


def io_fit_timed(mx, sym, it, arg0, aux0):
    """Module.fit of ``sym`` over ``it`` for IO_RN_EPOCHS from arg0 / aux0
    with phase 9's optimizer, each step fenced in its batch-end callback:
    (module, losses, step ms, wall s, fused_matmul launches)."""
    import torch
    from mxnet_tpu_torch import cuda_build

    mod = mx.mod.Module(sym, context=mx.gpu())
    losses, step_ms = [], []
    mark = [None]

    def on_batch(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if mark[0] is not None:
            step_ms.append((now - mark[0]) * 1e3)
        mark[0] = now
        losses.append(batch_loss(param.locals["self"],
                                 param.locals["data_batch"]))

    cuda_build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=IO_RN_EPOCHS, optimizer="sgd",
            optimizer_params={"learning_rate": RN_LR,
                              "momentum": RN_MOMENTUM, "wd": RN_WD},
            kvstore="local", batch_end_callback=on_batch,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in arg0.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in aux0.items()},
            force_init=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (mod, losses, step_ms, wall,
            cuda_build.launch_counts().get("fused_matmul", 0))


def io_resnet(mx, card, rec, idx, results, out):
    """(b): ResNet-50 NHWC trained from (a)'s records through
    ImageRecordIter(streaming=True, rand_mirror=True)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import cuda_build

    sym = io_resnet_sym(mx)
    it = io_record_iter(mx, rec, idx)
    first = it.next()
    x0, y0 = first.data[0].asnumpy(), first.label[0].asnumpy()
    it.close()
    init = mx.mod.Module(sym, context=mx.gpu())
    init.bind(data_shapes=[("data", (RN_BATCH, 3, IO_SIZE, IO_SIZE))],
              label_shapes=[("softmax_label", (RN_BATCH,))])
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
        raise AssertionError("io (b): training bind regions %s" % regions)

    # the first step, from the first streamed batch, with the kernel and
    # with MXNET_FUSION_KERNEL=0, under cuDNN's deterministic algorithms
    batch_it = mx.io.NDArrayIter(mx.nd.array(x0, ctx=mx.gpu()),
                                 mx.nd.array(y0, ctx=mx.gpu()),
                                 batch_size=RN_BATCH)
    torch.backends.cudnn.deterministic = True
    try:
        cuda_build.reset_launch_counts()
        kern = host_params(*resnet_fit_step(mx, sym, arg0, aux0, batch_it,
                                            []).get_params())
        first_launches = cuda_build.launch_counts().get("fused_matmul", 0)
        mx.config.set_flag("MXNET_FUSION_KERNEL", 0)
        cuda_build.reset_launch_counts()
        plain = host_params(*resnet_fit_step(mx, sym, arg0, aux0, batch_it,
                                             []).get_params())
        plain_launches = cuda_build.launch_counts().get("fused_matmul", 0)
    finally:
        mx.config.set_flag("MXNET_FUSION_KERNEL", None)
        torch.backends.cudnn.deterministic = False
    worst, worst_name, identical = max_rel_err(kern, plain)
    if first_launches != RN_REGIONS or plain_launches:
        raise AssertionError("io (b): the first step launched fused_matmul "
                             "%d times (plain route %d), want %d and 0"
                             % (first_launches, plain_launches, RN_REGIONS))
    if worst > MODULE_TOL:
        raise AssertionError("io (b): first step with the kernel vs "
                             "MXNET_FUSION_KERNEL=0: %s at %.3g > %.1g"
                             % (worst_name, worst, MODULE_TOL))

    # the main path: Module.fit from the streaming reader, fenced steps
    train = io_timed_iter(io_record_iter(mx, rec, idx))
    try:
        mod, losses, step_ms, wall, launches = io_fit_timed(
            mx, sym, train, arg0, aux0)
        stall = train.wait_s / wall
        stats = train._it.get_stats()
        # RN_PROFILED more steps from the reader under torch.profiler
        train.reset()
        batches = [next(train) for _ in range(IO_RN_PROFILED)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            p0 = time.perf_counter()
            for b in batches:
                mod.forward_backward(b)
                mod.update()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - p0) * 1e3 / IO_RN_PROFILED
        # the control: the same fit loop over the same records decoded
        # once, on the card (an NDArrayIter): the gap is the reader's cost
        train.reset()
        xs, ys = [], []
        for b in train:
            xs.append(b.data[0]._data.clone())
            ys.append(b.label[0]._data.clone())
    finally:
        train.close()
    ctrl = mx.io.NDArrayIter(mx.nd.array(torch.cat(xs)),
                             mx.nd.array(torch.cat(ys)), batch_size=RN_BATCH)
    del xs, ys
    _m, ctrl_losses, ctrl_ms, ctrl_wall, ctrl_launches = io_fit_timed(
        mx, sym, ctrl, arg0, aux0)
    del _m, ctrl
    n_steps = len(losses)
    if n_steps != IO_RN_EPOCHS * IO_N // RN_BATCH or \
            len(ctrl_losses) != n_steps:
        raise AssertionError("io (b): %d steps, the control %d"
                             % (n_steps, len(ctrl_losses)))
    if launches != RN_REGIONS * n_steps or ctrl_launches != launches:
        raise AssertionError("io (b): fused_matmul launched %d times over "
                             "%d steps (the control %d), want %d per step"
                             % (launches, n_steps, ctrl_launches,
                                RN_REGIONS))
    if not np.all(np.isfinite(losses)):
        raise AssertionError("io (b): losses %s" % losses)
    final = host_params(*mod.get_params())
    unmoved = [k for k in final if k.startswith("arg:")
               and np.array_equal(final[k], arg0[k[4:]])]
    if unmoved:
        raise AssertionError("io (b): %s did not move" % unmoved)
    fams, device_ms, top, _spans = device_families(prof, IO_RN_PROFILED)
    ms = float(np.median(step_ms))
    cms = float(np.median(ctrl_ms))
    p9 = results.get("resnet_train", {})
    log("io (b): ResNet-50 NHWC (composed onto transpose(data, (0, 2, 3, "
        "1))) fed from %d records by ImageRecordIter(streaming, "
        "rand_mirror, ImageNet mean / std), batch %d, %d epochs on %s: "
        "training bind %d regions; first step vs MXNET_FUSION_KERNEL=0 "
        "(cuDNN deterministic): %d of %d tensors bit-identical, worst %s "
        "at %.3g; %d fused_matmul launches over %d steps (%d per step); "
        "loss %s; %.3f ms/step (median of %d fenced steps), %.1f img/s "
        "(wall of fit %.1f), host stall %.4f of the wall; device %.3f "
        "ms/step, busy %.3f of the profiled step's %.3f ms; the control "
        "(the same fit over the records decoded once, on the card): %.3f "
        "ms/step, %.1f img/s (the reader costs %.3f ms a step); phase 9's "
        "synthetic batch: %s ms/step, %s img/s"
        % (IO_N, RN_BATCH, IO_RN_EPOCHS, card, len(regions), identical,
           len(plain), worst_name, worst, launches, n_steps,
           launches // n_steps, " ".join("%.3f" % v for v in losses), ms,
           len(step_ms), RN_BATCH / ms * 1e3,
           n_steps * RN_BATCH / wall, stall, device_ms,
           device_ms / prof_wall, prof_wall, cms, RN_BATCH / cms * 1e3,
           ms - cms,
           "%.3f" % p9["ms_per_step"] if "ms_per_step" in p9 else "n/a",
           "%.1f" % p9["img_per_s"] if "img_per_s" in p9 else "n/a"))
    for fam, v in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("    %9.3f ms  %.3f  %s" % (v, v / device_ms, fam))
    log("io (b): reader stages: %s, verdict %s"
        % (json.dumps(stats["stages"]), stats["verdict"]))
    out["b"] = dict(
        regions=len(regions), first_step=dict(
            worst=worst, worst_name=worst_name, identical=identical,
            tensors=len(plain)),
        launches=launches, steps=n_steps,
        launches_per_step=launches // n_steps, losses=losses,
        ms_per_step=ms, step_ms=step_ms, img_per_s=RN_BATCH / ms * 1e3,
        fit_wall_s=wall, fit_img_per_s=n_steps * RN_BATCH / wall,
        host_stall=stall, device_ms=device_ms,
        busy_profiled=device_ms / prof_wall, profiled_wall_ms=prof_wall,
        families_ms=fams, reader_stats=stats,
        control=dict(ms_per_step=cms, step_ms=ctrl_ms,
                     img_per_s=RN_BATCH / cms * 1e3, losses=ctrl_losses,
                     fit_wall_s=ctrl_wall),
        phase9_ms_per_step=p9.get("ms_per_step"),
        phase9_img_per_s=p9.get("img_per_s"))


def io_det_records(mx, path):
    """DET_N VOC-style records at DET_SIZE: 1-4 boxes each, the label
    (header width 2, object width 5, then class, xmin, ymin, xmax, ymax
    per object) that ImageDetIter reads; no .idx (the native prefetcher
    reads them in sequence). Returns (.rec, boxes per record)."""
    rng = np.random.RandomState(3)
    rec = path + ".rec"
    w = mx.recordio.MXRecordIO(rec, "w")
    counts = []
    for i in range(DET_N):
        img = rng.randint(0, 255, (DET_SIZE, DET_SIZE, 3)).astype(np.uint8)
        objs = []
        for _ in range(rng.randint(1, 5)):
            x1, y1 = rng.uniform(0, 0.6, 2)
            bw, bh = rng.uniform(0.15, 0.4, 2)
            objs += [rng.randint(0, 20), x1, y1, min(1.0, x1 + bw),
                     min(1.0, y1 + bh)]
        counts.append(len(objs) // 5)
        label = np.array([2, 5] + objs, np.float32)
        w.write(mx.recordio.pack_img(mx.recordio.IRHeader(0, label, i, 0),
                                     img, quality=90))
    w.close()
    return rec, counts


def io_detection(mx, card, path, out):
    """(c): ImageDetRecordIter over DET_N records, then DET_STEPS steps of
    phase 15's SSD-300 training on those batches."""
    import torch
    from mxnet_tpu_torch.models.ssd import get_ssd

    rec, counts = io_det_records(mx, path)
    t0 = time.perf_counter()
    it = mx.io.ImageDetRecordIter(rec, (3, DET_SIZE, DET_SIZE), DET_BATCH,
                                  rand_crop=1, rand_pad=1, rand_mirror=True)
    reader = type(it.imgrec).__name__
    batches = []
    for b in it:
        lab = b.label[0].asnumpy()
        if lab.shape != (DET_BATCH,) + it.label_shape or \
                it.label_shape[1] != 5:
            raise AssertionError("io (c): label shape %s, iterator %s"
                                 % (lab.shape, it.label_shape))
        real = lab[lab[..., 0] >= 0]
        if not len(real) or real[:, 1:5].min() < 0 or \
                real[:, 1:5].max() > 1:
            raise AssertionError("io (c): boxes out of [0, 1]: %s"
                                 % real[:, 1:5])
        batches.append((b.data[0], b.label[0], int(b.pad or 0)))
    it.close()
    read_s = time.perf_counter() - t0
    if reader != "MXRecordIOPrefetcher" or len(batches) != DET_N // DET_BATCH:
        raise AssertionError("io (c): %d batches through %s"
                             % (len(batches), reader))
    net = get_ssd(num_classes=20, mode="train")
    ex = net.simple_bind(mx.gpu(), data=(DET_BATCH, 3, DET_SIZE, DET_SIZE),
                         label=(DET_BATCH,) + it.label_shape,
                         grad_req="write")
    rng = np.random.RandomState(0)
    for k, v in ex.arg_dict.items():
        if k not in ("data", "label"):
            v[:] = (rng.randn(*v.shape) * 0.01).astype(np.float32)
    steps = []
    for data, label, _pad in batches[:DET_STEPS]:
        ex.arg_dict["data"][:] = data
        ex.arg_dict["label"][:] = label
        ex.forward(is_train=True)
        ex.backward()
        cls_prob, loc_loss, cls_target = (o._data for o in ex.outputs[:3])
        tgt = cls_target.long()
        valid = tgt >= 0
        p = cls_prob.gather(1, tgt.clamp_min(0)[:, None])[:, 0]
        ce = float(-torch.log(p.clamp_min(1e-12))[valid].mean())
        loc = float(loc_loss.sum())
        positives = (tgt > 0).sum(dim=1).tolist()
        lab = label.asnumpy()
        boxes = (lab[..., 0] >= 0).sum(axis=1).tolist()
        with torch.no_grad():
            for k, v in ex.arg_dict.items():
                if k not in ("data", "label"):
                    v._data -= DET_LR * ex.grad_dict[k]._data
        steps.append(dict(cross_entropy=ce, loc_loss=loc,
                          positives=positives, boxes=boxes))
        if not (np.isfinite(ce) and np.isfinite(loc)):
            raise AssertionError("io (c): SSD losses %s" % steps[-1])
        if any(pos < 1 for pos, n in zip(positives, boxes) if n):
            raise AssertionError("io (c): an image with boxes got no "
                                 "positive anchor: %s" % steps[-1])
    log("io (c): %d detection records (%d-%d boxes, %dx%d) through "
        "ImageDetRecordIter(rand_crop=1, rand_pad=1, rand_mirror) and %s "
        "in %.2f s: %d batches, labels %s in [0, 1]; SSD-300 on %s, %d "
        "steps (SGD %.0e): %s"
        % (DET_N, min(counts), max(counts), DET_SIZE, DET_SIZE, reader,
           read_s, len(batches), (DET_BATCH,) + it.label_shape, card,
           DET_STEPS, DET_LR, "; ".join(
               "ce %.4f loc %.4f positives %s of boxes %s"
               % (s["cross_entropy"], s["loc_loss"], s["positives"],
                  s["boxes"]) for s in steps)))
    out["c"] = dict(records=DET_N, reader=reader, read_s=read_s,
                    label_shape=list(it.label_shape), steps=steps)


def io_phase(mx, card, results):
    """Phase 19: data and IO on the card: bench_all.py --input-pipeline's
    protocol, ResNet-50 trained from records, detection records into
    SSD-300. The records live in a temporary directory removed at the
    end."""
    import shutil
    import tempfile

    import torch
    from mxnet_tpu_torch import native

    t0 = time.perf_counter()
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        b0 = time.perf_counter()
        rec, idx = io_build_rec(mx, os.path.join(tmp, "data"), IO_N, IO_SIZE)
        out["build_rec_s"] = time.perf_counter() - b0
        io_bench(mx, card, rec, idx, out)
        torch.cuda.empty_cache()
        io_resnet(mx, card, rec, idx, results, out)
        torch.cuda.empty_cache()
        io_detection(mx, card, os.path.join(tmp, "det"), out)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    libs = native.built()
    if not (libs.get("recordio") and libs.get("prefetch")):
        raise AssertionError("io: native readers %s" % libs)
    out["native"] = libs
    out["seconds"] = time.perf_counter() - t0
    log("io: native readers %s; phase 19 took %.1f s (records built in "
        "%.1f s)" % (json.dumps(libs), out["seconds"], out["build_rec_s"]))
    results["io"] = out
    return out


# the observability phase (20): bench_all.py --perf-overhead's protocol
# (:2804-2918; an MLP 64-512-16 at batch 128 through Module, 60 timed
# steps, 10 witnessed, 5000 calls of the per-step work, best of 3) and its
# gate; --health-overhead's (:1207-1290; the bf16 TransformerParallel
# microbench, blocks of 30 steps) and its gate; ResNet-50 NHWC
# fp32 at batch 32 (phase 9's init and SGD) for 8 fit steps with perf on
# and health warn, 2 of them profiled; phase 3's server behind the
# exposition plane
OBS_MLP_BS, OBS_MLP_STEPS, OBS_MLP_WITNESS = 128, 60, 10
OBS_PERF_CALLS = 5000
OBS_PERF_GATE_PCT = 1.0
OBS_HEALTH = dict(vocab=2048, d_model=128, n_heads=8, n_layers=4, d_ff=512,
                  n_experts=1)
# the bench times each arm over 3 blocks of 30 steps in a row and takes the
# best; this step's wall moves by up to 10% between blocks of one process
# on an H100's host, far more than the gate, so here the arms alternate on
# one parameter set in 24 pairs of 30-step blocks (which arm goes first
# alternating too), and the median of the pairs' differences is held to
# the gate. On that host the reading spreads over about +-2 points between
# calls around a cost near the gate (PERF.md, PR 18): the verdict is
# printed and recorded, not raised
OBS_HEALTH_B, OBS_HEALTH_T, OBS_HEALTH_STEPS = 4, 512, 30
OBS_HEALTH_BLOCKS = 24
OBS_HEALTH_LR = 0.01
OBS_HEALTH_GATE_PCT = 2.0
OBS_RN_STEPS, OBS_RN_PROFILED = 8, 2
OBS_RN_KERNEL_PER_STEP = 16
OBS_REQUESTS = 8
# a second exposition endpoint for the fleet: a CPU-only process that
# serves its own registry until its stdin closes
OBS_WORKER = (
    "import sys\n"
    "import mxnet_tpu_torch.observability as obs\n"
    "obs.metrics.counter('worker.heartbeats').inc(5)\n"
    "print(obs.exposition.http_port(), flush=True)\n"
    "sys.stdin.read()\n")


def obs_mlp_module(mx, bs):
    """bench_all.py --perf-overhead's Module: MLP 64-512-16, SGD 0.1."""
    data = mx.sym.Variable("data")
    fc1 = mx.sym.Activation(mx.sym.FullyConnected(
        data, num_hidden=512, name="o1"), act_type="relu")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        fc1, num_hidden=16, name="o2"), name="softmax")
    mod = mx.mod.Module(net, context=mx.gpu(), data_names=("data",))
    mod.bind(data_shapes=[("data", (bs, 64))],
             label_shapes=[("softmax_label", (bs,))])
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.1),))
    return mod


def obs_perf_overhead(mx, card, out):
    """(a) --perf-overhead: 0 steady-state cost walks, and the full
    per-step perf work under 1% of the measured step."""
    import torch
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.observability import perf

    rng = np.random.RandomState(0)
    bs = OBS_MLP_BS
    mod = obs_mlp_module(mx, bs)
    batch = mx.io.DataBatch(
        data=[mx.nd.array(rng.rand(bs, 64).astype(np.float32),
                          ctx=mx.gpu())],
        label=[mx.nd.array(rng.randint(0, 16, bs).astype(np.float32),
                           ctx=mx.gpu())])
    for _ in range(3):
        mod.forward_backward(batch)
        mod.update()
    mod.get_outputs()[0].asnumpy()
    t0 = time.perf_counter()
    for _ in range(OBS_MLP_STEPS):
        mod.forward_backward(batch)
        mod.update()
    mod.get_outputs()[0].asnumpy()
    step_s = (time.perf_counter() - t0) / OBS_MLP_STEPS

    # witness: steady-state steps pay no cost walk; one note a step
    ex = mod._exec_group.execs[0]
    prog = ex._train_program()
    perf.reset()
    perf.step_begin()
    mod.forward_backward(batch)
    mod.update()
    perf.step_end(step=0)
    walks_before = len(prog._perf_costs)
    cuda_build.reset_launch_counts()
    recs = []
    for i in range(OBS_MLP_WITNESS):
        perf.step_begin()
        mod.forward_backward(batch)
        mod.update()
        recs.append(perf.step_end(step=i + 1))
    walks = len(prog._perf_costs) - walks_before
    launches = cuda_build.launch_counts().get("fused_matmul", 0)
    if any(r["programs"] != 1 for r in recs) or launches != OBS_MLP_WITNESS:
        raise AssertionError("perf overhead: programs a step %s, %d "
                             "fused_matmul launches over %d steps"
                             % ([r["programs"] for r in recs], launches,
                                OBS_MLP_WITNESS))
    (entry,) = perf.program_table()

    # the per-call cost of the full per-step perf work: the scope, the
    # executor's stream lookup and two CUDA events (from the pool) and
    # their records, the cost lookup, the note, a data-wait and a kvstore
    # note, the scope's end (which waits for and reads the events)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(OBS_PERF_CALLS):
            perf.step_begin()
            stream = perf.current_stream(0)
            start, end = perf.event_pair()
            perf.record(start, stream)
            perf.record(end, stream)
            perf.note_program_events(ex.perf_program_cost(True), start,
                                     end, 1e-6)
            perf.note_data_wait(1e-9)
            perf.note_kv(1e-9)
            perf.step_end(step=i)
        best = min(best, (time.perf_counter() - t0) / OBS_PERF_CALLS)
    perf.reset()
    pct = 100.0 * best / step_s
    out["a"] = dict(per_step_cost_us=best * 1e6, step_ms=step_s * 1e3,
                    steady_state_cost_walks=walks, overhead_pct=pct,
                    threshold_pct=OBS_PERF_GATE_PCT,
                    mlp_mfu_pct=entry["mfu_pct"],
                    mlp_device_ms=entry["device_ms_ema"])
    log("obs (a) perf overhead: per-step perf work %.2f us against a %.3f "
        "ms MLP 64-512-16 bs%d step (%.4f%%, gate %.1f%%), %d steady-state "
        "cost walks; the step's program: %.4f device ms, MFU %.3f%% of "
        "%.2f TFLOP/s fp32" % (best * 1e6, step_s * 1e3, bs, pct,
                                OBS_PERF_GATE_PCT, walks,
                                entry["device_ms_ema"], entry["mfu_pct"],
                                obs_ceilings()["float32"]))
    if walks:
        raise AssertionError("perf overhead: %d cost walks on the "
                             "steady-state step path" % walks)
    if pct > OBS_PERF_GATE_PCT:
        raise AssertionError("perf overhead: the perf layer costs %.3f%% "
                             "a step (> %.2f%% gate)"
                             % (pct, OBS_PERF_GATE_PCT))


def obs_ceilings():
    from mxnet_tpu_torch.autotune import cost_model

    return cost_model.MEASURED_MATMUL_TF


def obs_transformer(mx):
    tp = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                         dtype="bfloat16", **OBS_HEALTH)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, OBS_HEALTH["vocab"],
                      (OBS_HEALTH_B, OBS_HEALTH_T)).astype(np.int32)
    tok, tgt = tp.shard_batch(tok, np.roll(tok, -1, axis=1))
    return tp, tok, tgt


def obs_guard_launches(health, loss, named):
    """Kernels and copies one warn-mode guard puts on the card, by
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        health.guard_step("bench.transformer", losses=[("loss", loss)],
                          params=named, lr=OBS_HEALTH_LR, step=-1)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type == cuda]
    copies = sum(1 for n in names if "memcpy" in n.lower()
                 or "memset" in n.lower())
    return len(names) - copies, copies


def obs_health_overhead(mx, card, out):
    """(b) --health-overhead: warn against off on the bf16 transformer
    microbench, OBS_HEALTH_BLOCKS pairs of blocks alternating on one
    parameter set, the median of the pairs' differences against the 2%
    gate; the flash kernels' launches, the health kernel's, and the
    launches of one guard."""
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.observability import flight_recorder, health

    FA = flash_module()
    tp, tok, tgt = obs_transformer(mx)
    step = tp.step_fn(lr=OBS_HEALTH_LR)
    per_guard = {}

    # one parameter set, updated in place by both arms' steps, stepped
    # and guarded once (the reduction's plan) before the timed blocks
    params = tp.init(0)
    names = sorted(params)
    params, loss = step(params, tok, tgt)
    float(loss)
    arms = {"off": dict(blocks=[]), "warn": dict(blocks=[])}
    health.set_policy("warn")
    health.guard_step("bench.transformer", losses=[("loss", loss)],
                      params=[(n, params[n]) for n in names],
                      lr=OBS_HEALTH_LR, step=0)
    cuda_build.reset_launch_counts()
    try:
        # OBS_HEALTH_BLOCKS pairs, the arm that goes first alternating
        for k in range(OBS_HEALTH_BLOCKS):
            for policy in (("off", "warn"), ("warn", "off"))[k % 2]:
                arm = arms[policy]
                health.set_policy(policy)
                t0 = time.perf_counter()
                for i in range(OBS_HEALTH_STEPS):
                    params, loss = step(params, tok, tgt)
                    if policy != "off":
                        health.guard_step(
                            "bench.transformer", losses=[("loss", loss)],
                            params=[(n, params[n]) for n in names],
                            lr=OBS_HEALTH_LR, step=i + 1)
                float(loss)
                arm["blocks"].append((time.perf_counter() - t0)
                                     / OBS_HEALTH_STEPS)
        counts = cuda_build.launch_counts()
        want = OBS_HEALTH["n_layers"] * 2 * OBS_HEALTH_BLOCKS * \
            OBS_HEALTH_STEPS
        for name in FA.KERNELS:
            if counts.get(name, 0) != want:
                raise AssertionError("health overhead: %s launched %d "
                                     "times, want %d" % (
                                         name, counts.get(name, 0), want))
        guards = counts.get("health_stats", 0)
        if guards != OBS_HEALTH_BLOCKS * OBS_HEALTH_STEPS:
            raise AssertionError("health overhead: %d health_stats "
                                 "launches in %d guarded steps" % (
                                     guards,
                                     OBS_HEALTH_BLOCKS * OBS_HEALTH_STEPS))
        # after the timed blocks: a torch.profiler session leaves later
        # launches slower
        health.set_policy("warn")
        named = [(n, params[n]) for n in names]
        per_guard["kernels"], per_guard["copies"] = obs_guard_launches(
            health, loss, named)
        per_guard["tensors"] = len(named) + 1
        kernel = obs_health_kernel([loss] + [t for _n, t in named],
                                   phase_peaks(card))
    finally:
        health.flush(allow_dump=False)
        health.set_policy(None)
        flight_recorder.reset()
    off_s = float(np.median(arms["off"]["blocks"]))
    warn_s = float(np.median(arms["warn"]["blocks"]))
    pairs = [100.0 * (w - o) / o for w, o in zip(arms["warn"]["blocks"],
                                                  arms["off"]["blocks"])]
    pct = float(np.median(pairs))
    out["b"] = dict(off_ms_per_step=off_s * 1e3,
                    warn_ms_per_step=warn_s * 1e3, overhead_pct=pct,
                    medians_pct=100.0 * (warn_s - off_s) / off_s,
                    pair_pcts=pairs,
                    off_blocks_ms=[b * 1e3 for b in arms["off"]["blocks"]],
                    warn_blocks_ms=[b * 1e3 for b in arms["warn"]["blocks"]],
                    threshold_pct=OBS_HEALTH_GATE_PCT,
                    guard_kernels=per_guard["kernels"],
                    guard_copies=per_guard["copies"],
                    guard_tensors=per_guard["tensors"],
                    health_stats_launches=guards, health_kernel=kernel,
                    flash_launches={n: counts.get(n, 0)
                                    for n in FA.KERNELS})
    if per_guard["kernels"] or per_guard["copies"]:
        seen = "puts %d kernels and %d copies on the card (torch.profiler)" \
            % (per_guard["kernels"], per_guard["copies"])
    else:
        # torch.profiler losing the session's records (ROADMAP Queue C2),
        # not a count: a guard launches at least its reduction
        seen = "shows torch.profiler no record (Queue C2)"
        out["b"]["guard_kernels"] = out["b"]["guard_copies"] = None
    out["b"]["gate"] = "held" if pct <= OBS_HEALTH_GATE_PCT else "NOT MET"
    log("obs (b) health overhead: warn costs %.2f%% a step, the median of "
        "%d alternating pairs of %d-step blocks (gate %.1f%%: %s; per pair "
        "%s%%);"
        " the arms' medians: warn %.3f ms/step against off %.3f (%.2f%%); "
        "transformer d%d x%d T=%d bs%d bf16; one guard over %d tensors %s; "
        "%d health_stats launches in the warn arm's %d "
        "steps; flash launches over both arms' %d steps: %s"
        % (pct, OBS_HEALTH_BLOCKS, OBS_HEALTH_STEPS, OBS_HEALTH_GATE_PCT,
           out["b"]["gate"], " ".join("%+.2f" % p for p in pairs),
           warn_s * 1e3, off_s * 1e3,
           out["b"]["medians_pct"],
           OBS_HEALTH["d_model"], OBS_HEALTH["n_layers"], OBS_HEALTH_T,
           OBS_HEALTH_B, per_guard["tensors"], seen, guards,
           OBS_HEALTH_BLOCKS * OBS_HEALTH_STEPS,
           2 * OBS_HEALTH_BLOCKS * OBS_HEALTH_STEPS,
           json.dumps(out["b"]["flash_launches"])))
    log("obs (b) health_stats kernel over the microbench's %d tensors (%s):"
        " bad counts equal, sums within %.3g of scale; %.4f ms a launch "
        "against the plain version's %.4f, bound %.4f"
        % (kernel["tensors"], "/".join(kernel["dtypes"]),
           kernel["max_scaled_err"], kernel["ms"], kernel["plain_ms"],
           kernel["bound_ms"]))


def obs_nan_policies(mx, card, out):
    """(b) a NaN fed into a gradient: raise raises on its step, warn names
    it one step later, skip_step leaves every parameter and optimizer
    state bit-identical in Module.fit and in compile_step."""
    import torch
    from mxnet_tpu_torch.observability import (TrainingHealthError,
                                               flight_recorder, health)

    tp, tok, tgt = obs_transformer(mx)
    params = tp.init(0)
    loss, grads = tp.value_and_grad(params, tok, tgt)
    names = sorted(grads)
    poisoned = dict(grads)
    victim = names[len(names) // 2]
    poisoned[victim] = grads[victim].clone()
    poisoned[victim].view(-1)[7] = float("nan")

    def guard(g, k):
        return health.guard_step(
            "bench.transformer", losses=[("loss", loss)],
            grads=[(n, g[n]) for n in names],
            params=[(n, params[n]) for n in names], lr=OBS_HEALTH_LR,
            step=k)

    res = {}
    try:
        flight_recorder.reset()
        health.set_policy("raise")
        guard(grads, 1)
        try:
            guard(poisoned, 2)
            raise AssertionError("raise: no TrainingHealthError")
        except TrainingHealthError as err:
            v = err.verdict
            res["raise"] = dict(step=v.step, first_bad=v.first_bad)
        health.set_policy("warn")
        assert guard(poisoned, 3) is None
        # a step's work between two guards: the card has made step 3's
        # stats when step 4's guard looks (warn never waits for them)
        torch.cuda.synchronize()
        v = guard(grads, 4)
        res["warn"] = dict(step=v.step, first_bad=v.first_bad, ok=v.ok,
                           reported_at=4)
        health.flush(allow_dump=False)
    finally:
        health.set_policy(None)
    if res["raise"] != {"step": 2, "first_bad": "grad:" + victim} or \
            res["warn"]["step"] != 3 or res["warn"]["ok"] or \
            res["warn"]["first_bad"] != "grad:" + victim:
        raise AssertionError("NaN policies: %s" % res)

    # skip_step in Module.fit: the poisoned last batch leaves the
    # parameters where the first two steps put them
    rng = np.random.RandomState(0)
    x = rng.rand(3 * 32, 64).astype(np.float32)
    y = rng.randint(0, 16, 3 * 32).astype(np.float32)
    x_bad = x.copy()
    x_bad[64:] = np.nan

    def fit(xs, ys):
        np.random.seed(0)
        it = mx.io.NDArrayIter(mx.nd.array(xs, ctx=mx.gpu()),
                               mx.nd.array(ys, ctx=mx.gpu()),
                               batch_size=32, label_name="softmax_label")
        data = mx.sym.Variable("data")
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Activation(
            mx.sym.FullyConnected(data, num_hidden=512, name="o1"),
            act_type="relu"), num_hidden=16, name="o2"), name="softmax")
        mod = mx.mod.Module(net, context=mx.gpu())
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Xavier())
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    try:
        flight_recorder.reset()
        health.set_policy("skip_step")
        skipped = fit(x_bad, y)
        recs = [r["skipped"] for r in flight_recorder.snapshot()]
    finally:
        health.set_policy(None)
    ref = fit(x[:64], y[:64])
    fit_same = sum(int(np.array_equal(skipped[k], ref[k])) for k in ref)
    # skip_step in compile_step: the copies into the live tensors wait
    # for the verdict, outside the graph
    try:
        flight_recorder.reset()
        health.set_policy("skip_step")
        net = mx.gluon.nn.Dense(16)
        net.initialize(ctx=mx.gpu())
        net.hybridize()
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9},
                                   kvstore=None)
        cstep = trainer.compile_step(net, loss_fn)
        xb = mx.nd.array(x[:32], ctx=mx.gpu())
        yb = mx.nd.array(y[:32], ctx=mx.gpu())
        cstep(xb, yb).asnumpy()
        before = {k: p.data().asnumpy().copy()
                  for k, p in net.collect_params().items()}
        states = [a.asnumpy().copy() for s in
                  trainer._updaters[0].states.values()
                  for a in mx.optimizer.flat_state(s)]
        cstep(mx.nd.array(x_bad[64:96], ctx=mx.gpu()), yb).asnumpy()
        torch.cuda.synchronize()
        cs_same = sum(int(np.array_equal(p.data().asnumpy(), before[k]))
                      for k, p in net.collect_params().items())
        st_same = sum(int(np.array_equal(a.asnumpy(), b)) for a, b in zip(
            [a for s in trainer._updaters[0].states.values()
             for a in mx.optimizer.flat_state(s)], states))
        after = float(cstep(xb, yb).asnumpy().mean())
        cs_skipped = [r["skipped"] for r in flight_recorder.snapshot()]
        captures = cstep.compile_count
    finally:
        health.set_policy(None)
        flight_recorder.reset()
    res["skip_fit"] = dict(skipped=recs, identical=fit_same, of=len(ref))
    res["skip_compile_step"] = dict(
        skipped=cs_skipped, params_identical=cs_same, params=len(before),
        states_identical=st_same, states=len(states), captures=captures,
        loss_after=after)
    out["nan"] = res
    log("obs (b) NaN in grad %s: raise at step %d; warn named step %d at "
        "step %d; skip_step fit %s, %d of %d parameters bit-identical to "
        "the 2-step fit; compile_step %s, %d of %d parameters and %d of %d "
        "optimizer states bit-identical, %d capture, next loss %.4f"
        % (victim, res["raise"]["step"], res["warn"]["step"], 4, recs,
           fit_same, len(ref), cs_skipped, cs_same, len(before), st_same,
           len(states), captures, after))
    if recs != [False, False, True] or fit_same != len(ref) or \
            cs_skipped != [False, True, False] or \
            cs_same != len(before) or \
            st_same != len(states) or captures != 1 or \
            not np.isfinite(after):
        raise AssertionError("skip_step: %s" % res)


def obs_watched(mod):
    """The tensors ``Module``'s health guard reduces: the outputs, the
    gradients and the parameters."""
    grp = mod._exec_group
    return ([o._data for o in grp.execs[0].outputs]
            + [r[0]._data for r in grp.grad_arrays or [] if r[0] is not None]
            + [r[0]._data for r in grp.param_arrays])


def obs_health_kernel(tensors, peaks):
    """The health reduction's kernel (csrc/health_stats.cu) on the path's
    tensors, one of them with a NaN and an Inf planted, held against its
    plain version (observability.health.stats_plain) on the same inputs:
    the bad counts exactly, the sums within 1e-9 of each tensor's scale
    (both accumulate in float64, in different orders). Its time (the
    whole launch: the pointer table in, the kernel, the result out) and
    the plain version's, from CUDA events; the bound: every tensor read
    once and the (n, 3) result written, at the card's memory rate. No
    single PyTorch call computes the counts with the sums: no library
    time."""
    import torch
    from mxnet_tpu_torch.observability import health

    tensors = list(tensors)
    k = max(range(len(tensors)), key=lambda i: tensors[i].numel())
    planted = tensors[k].detach().clone()
    planted.view(-1)[3] = float("nan")
    planted.view(-1)[-1] = float("inf")
    tensors[k] = planted
    numel = np.array([t.numel() for t in tensors], np.float64)
    got = health._fused_stats(tensors)
    want = health.stats_plain(tensors)
    want[:, 0] = numel - want[:, 0]
    scale = np.sqrt(np.maximum(want[:, 1], 1.0))
    err = float(np.max(np.abs(got[:, 1:] - want[:, 1:]) / scale[:, None]))
    if not np.array_equal(got[:, 0], want[:, 0]) or got[k, 0] != 2 or \
            err > 1e-9:
        raise AssertionError("health_stats: bad counts %s against %s, "
                             "scaled sum error %.3g" % (
                                 got[:, 0].tolist(), want[:, 0].tolist(),
                                 err))
    named = [("t%d" % i, t) for i, t in enumerate(tensors)]
    plan, _slot = health._launch((), (), named)
    health.flush(allow_dump=False)
    ms = time_events_ms(lambda: plan.launch(tensors), reps=20)
    plain_ms = time_events_ms(lambda: health.stats_plain(tensors), reps=3)
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + \
        8 * 3 * len(tensors)
    bound = nbytes / peaks["bytes_per_s"] * 1e3
    return dict(tensors=len(tensors), elements=int(numel.sum()),
                dtypes=sorted({str(t.dtype) for t in tensors}),
                max_abs_err=float(np.max(np.abs(got[:, 1:] - want[:, 1:]))),
                max_scaled_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None)


def obs_resnet(mx, sym, card, out):
    """(c) ResNet-50 NHWC fp32 at batch 32, phase 9's init and SGD: the
    first fit step bit-identical with perf and health on or off; 8 steps
    with MXNET_PERF=1 and MXNET_HEALTH=warn: 16 fused_matmul launches a
    step, the program's FLOPs, bytes, MFU and HBM utilisation on both
    bases from its CUDA-event spans, the waterfall, the roofline table;
    a profiler session over 2 steps; the memory watermark."""
    import tempfile

    import torch
    from mxnet_tpu_torch import cuda_build, profiler
    from mxnet_tpu_torch.autotune import cost_model
    from mxnet_tpu_torch.observability import health, instruments, perf

    cal = cost_model.measure_ceilings()
    log("obs (c) calibration (autotune.cost_model.measure_ceilings): "
        "torch.matmul 8192^3 %.2f TFLOP/s fp32 (TF32 off), %.2f bf16; "
        "copy %.1f GB/s; the table holds %s (%s)"
        % (cal["matmul_tf_s"]["float32"], cal["matmul_tf_s"]["bfloat16"],
           cal["hbm_gb_s"], json.dumps(cost_model.MEASURED_MATMUL_TF),
           cost_model.CARD))
    out["calibration"] = dict(cal, table=dict(
        matmul_tf_s=cost_model.MEASURED_MATMUL_TF,
        hbm_gb_s=cost_model.MEASURED_HBM_GBPS, card=cost_model.CARD))

    x, y = resnet_train_data()
    it1 = mx.io.NDArrayIter(mx.nd.array(x, ctx=mx.gpu()),
                            mx.nd.array(y, ctx=mx.gpu()),
                            batch_size=RN_BATCH, label_name="softmax_label")
    init = mx.mod.Module(sym, context=mx.gpu())
    init.bind(data_shapes=it1.provide_data, label_shapes=it1.provide_label)
    np.random.seed(0)
    init.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg0, aux0 = ({k: v.asnumpy() for k, v in d.items()}
                  for d in init.get_params())
    del init

    # the first step with both off and with both on, cuDNN deterministic
    params = {}
    torch.backends.cudnn.deterministic = True
    try:
        for arm, flag, pol in (("off", 0, "off"), ("on", None, "warn")):
            mx.config.set_flag("MXNET_PERF", flag)
            health.set_policy(pol)
            mod = resnet_fit_step(mx, sym, arg0, aux0, it1, [])
            health.flush(allow_dump=False)
            params[arm] = host_params(*mod.get_params())
            del mod
    finally:
        torch.backends.cudnn.deterministic = False
        mx.config.set_flag("MXNET_PERF", None)
        health.set_policy(None)
    identical = sum(int(np.array_equal(params["on"][k], params["off"][k]))
                    for k in params["off"])
    log("obs (c) first fit step with MXNET_PERF=1 + MXNET_HEALTH=warn "
        "against both off: %d of %d tensors bit-identical"
        % (identical, len(params["off"])))
    if identical != len(params["off"]):
        raise AssertionError("perf/health changed the first step: %d of %d "
                             "tensors equal" % (identical,
                                                len(params["off"])))
    del params

    xs = np.concatenate([x] * OBS_RN_STEPS)
    ys = np.concatenate([y] * OBS_RN_STEPS)
    it = mx.io.NDArrayIter(mx.nd.array(xs, ctx=mx.gpu()),
                           mx.nd.array(ys, ctx=mx.gpu()),
                           batch_size=RN_BATCH, label_name="softmax_label")
    trace = os.path.join(tempfile.mkdtemp(prefix="obs_"), "resnet.json")
    profiler.set_config(mode="symbolic", filename=trace)
    session = {}
    first_profiled = OBS_RN_STEPS - OBS_RN_PROFILED

    def on_batch(param):
        # after step nbatch + 1's waterfall row: open the session before
        # the last OBS_RN_PROFILED steps, dump after the last
        if param.nbatch == first_profiled - 1:
            torch.cuda.synchronize()
            session["before"] = cuda_build.launch_counts().get(
                "fused_matmul", 0)
            profiler.set_state("run")
        elif param.nbatch == OBS_RN_STEPS - 1:
            torch.cuda.synchronize()
            session["after"] = cuda_build.launch_counts().get(
                "fused_matmul", 0)
            session["path"] = profiler.dump_profile()

    perf.reset()
    health.set_policy("warn")
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    mod = mx.mod.Module(sym, context=mx.gpu())
    try:
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
    finally:
        health.flush(allow_dump=False)
        health.set_policy(None)
        profiler.set_state("stop")
        profiler.set_config(mode="symbolic", filename="profile.json")
    launches = cuda_build.launch_counts().get("fused_matmul", 0)
    guards = cuda_build.launch_counts().get("health_stats", 0)
    peak = instruments.device_peak_bytes()
    torch_peak = torch.cuda.max_memory_allocated()

    falls = perf.waterfalls()
    (entry,) = perf.program_table()
    worst_sum = max(abs(r["wall_s"] - (r["data_wait_s"] + r["device_s"]
                                        + r["kvstore_s"] + r["host_s"]))
                    for r in falls)
    for r in falls:
        log("obs (c) step %d: wall %.3f ms = data %.3f + blocked on the "
            "card %.3f + kv %.3f + host %.3f; the program's device span "
            "%.3f ms (busy %.3f); step MFU %.2f%% (spec %.2f%%)"
            % (r["step"], r["wall_s"] * 1e3, r["data_wait_s"] * 1e3,
               r["device_s"] * 1e3, r["kvstore_s"] * 1e3, r["host_s"] * 1e3,
               r["device_span_s"] * 1e3, r["device_span_s"] / r["wall_s"],
               r["mfu_pct"], r["mfu_spec_pct"]))
    log("obs (c) program %s (%s, %s): %.4g FLOP, %.4g bytes a step; device "
        "ms last %.3f, best %.3f, ema %.3f; MFU %.2f%% measured (%.2f "
        "TFLOP/s), %.2f%% spec (67); HBM %.2f%% measured, %.2f%% spec; "
        "roofline %.3f ms, residual %.2f; %d runs + %d warm-up"
        % (entry["graph"], entry["mode"], entry["compute_dtype"],
           entry["flops"], entry["hbm_bytes"], entry["device_ms_last"],
           entry["device_ms_best"], entry["device_ms_ema"],
           entry["mfu_pct"], cost_model.MEASURED_MATMUL_TF["float32"],
           entry["mfu_spec_pct"], entry["hbm_util_pct"],
           entry["hbm_util_spec_pct"], entry["roofline_ms"],
           entry["residual"], entry["runs"], entry["warmup_runs"]))
    for r in entry["ops_top"][:6]:
        log("obs (c) roofline row %s (%s): %.4g FLOP, %.4g bytes, %s-bound,"
            " %.4f ms" % (r["name"], r["op"], r["flops"], r["bytes"],
                          r["bound"], r["roofline_s"] * 1e3))
    for c in entry["fusion_candidates"][:3]:
        log("obs (c) fusion candidate %s: saves %.4g bytes"
            % ("+".join(c["op_types"]), c["saved_bytes"]))

    with open(session["path"]) as f:
        payload = json.load(f)
    names = [e["name"] for e in payload["traceEvents"]]
    kernel_records = payload["kernelRecordsByName"]
    fm_records = sum(n for k, n in kernel_records.items()
                     if "fused_matmul" in k)
    in_session = session["after"] - session["before"]
    log("obs (c) profiler session over %d steps: %d events, %d kernel "
        "records (%d fused_matmul, the wrapper launched %d), spans %s, "
        "dropped %d" % (OBS_RN_PROFILED, len(names),
                        payload["kernelRecords"], fm_records, in_session,
                        {n: names.count(n) for n in
                         ("step", "update", "forward_backward",
                          "update_metric")},
                        payload.get("droppedEventsCount", 0)))
    log("obs (c) %d fused_matmul and %d health_stats launches over %d "
        "steps; peak memory %d bytes (instruments) against %d (torch); "
        "waterfall sums off by at most %.3g s"
        % (launches, guards, OBS_RN_STEPS, peak, torch_peak, worst_sum))
    mfus = (entry["mfu_pct"], entry["mfu_spec_pct"], entry["hbm_util_pct"],
            entry["hbm_util_spec_pct"])
    if len(falls) != OBS_RN_STEPS or worst_sum > 1e-6 or \
            launches != OBS_RN_KERNEL_PER_STEP * OBS_RN_STEPS or \
            guards != OBS_RN_STEPS or \
            not all(0.0 < m < 100.0 for m in mfus) or \
            fm_records != in_session or \
            in_session != OBS_RN_KERNEL_PER_STEP * OBS_RN_PROFILED or \
            names.count("forward_backward") != OBS_RN_PROFILED or \
            names.count("step") != OBS_RN_PROFILED or peak != torch_peak:
        raise AssertionError(
            "obs (c): %d waterfalls (sum off %.3g), %d launches, %d guard "
            "launches, MFU/HBM %s, %d fused_matmul records against %d "
            "launches in the session, %d forward_backward / %d step spans, "
            "peak %d vs %d"
            % (len(falls), worst_sum, launches, guards, mfus, fm_records,
               in_session, names.count("forward_backward"),
               names.count("step"), peak, torch_peak))
    out["c"] = dict(
        launches=launches, steps=OBS_RN_STEPS,
        launches_per_step=launches / OBS_RN_STEPS,
        first_step_identical=identical,
        program={k: entry[k] for k in (
            "graph", "mode", "compute_dtype", "flops", "hbm_bytes",
            "device_ms_last", "device_ms_best", "device_ms_ema",
            "host_ms_ema", "mfu_pct", "mfu_spec_pct", "hbm_util_pct",
            "hbm_util_spec_pct", "roofline_ms", "residual")},
        waterfalls=falls, ops_top=entry["ops_top"][:8],
        fusion_candidates=entry["fusion_candidates"][:3],
        profiled=dict(steps=OBS_RN_PROFILED,
                      kernel_records=payload["kernelRecords"],
                      fused_matmul_records=fm_records,
                      wrapper_launches=in_session),
        peak_bytes=peak, health_stats_launches=guards)
    perf.reset()
    hk = out["c"]["health_kernel"] = obs_health_kernel(
        obs_watched(mod), phase_peaks(card))
    log("obs (c) health_stats kernel over the guard's %d tensors (%d "
        "elements, %s; a NaN and an Inf planted): bad counts equal to the "
        "plain version's, sums within %.3g of scale (%.3g abs); %.4f ms a "
        "launch against the plain version's %.4f, bound %.4f (bytes), no "
        "library call" % (hk["tensors"], hk["elements"],
                          "/".join(hk["dtypes"]), hk["max_scaled_err"],
                          hk["max_abs_err"], hk["ms"], hk["plain_ms"],
                          hk["bound_ms"]))
    del mod


def obs_exposition(mx, sym, card, out):
    """(d) phase 3's served ResNet-50 behind the exposition plane on an
    ephemeral port: /metrics through promparse, /statusz with its perf
    section and the engine row, /healthz, /tracez; the served requests'
    traces and their kernels in a profiler dump; a FleetAggregator over
    this process's endpoint and a second process's."""
    import tempfile
    import urllib.request

    import torch
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.observability import (exposition, fleet, metrics,
                                               promparse, request_trace)

    rng = np.random.default_rng(1)
    np_args, np_aux = resnet50_params(sym, seed=0)
    center_fc_bias(mx, sym, np_args, np_aux, rng)
    args, aux = mx.params_from_jax(np_args, np_aux, device="cuda")
    served = mx.sym.Group([sym, sym.get_internals()["fc1_output"]])
    images = rng.standard_normal((OBS_REQUESTS,) + ROW, dtype=np.float32)

    def get(port, path):
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=30) as r:
            return r.read().decode()

    metrics.set_enabled(True)
    request_trace.reset()
    port = exposition.start_http(0)
    env = dict(os.environ, MXNET_OBS_HTTP_PORT="0", MXNET_TELEMETRY="1",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    worker = subprocess.Popen([sys.executable, "-c", OBS_WORKER], env=env,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True)
    srv = mx.serving.InferenceServer(
        served, args, aux, data_shapes=[("data", (1,) + ROW)],
        devices=[torch.device("cuda")],
        config=mx.serving.ServingConfig(buckets=BUCKETS))
    trace = os.path.join(tempfile.mkdtemp(prefix="obs_"), "serve.json")
    try:
        srv.warmup()
        batches0 = srv.get_stats().get("batches", 0)
        torch.cuda.synchronize()
        profiler.set_config(mode="symbolic", filename=trace)
        profiler.set_state("run")
        answers = [srv.predict(img, timeout=600) for img in images]
        torch.cuda.synchronize()
        payload = json.load(open(profiler.dump_profile()))
        replays = srv.get_stats().get("batches", 0) - batches0
        parsed = promparse.parse_text(get(port, "/metrics"))
        statusz = json.loads(get(port, "/statusz"))
        healthz = json.loads(get(port, "/healthz"))
        tracez = json.loads(get(port, "/tracez"))
        worker_port = int(worker.stdout.readline())
        agg = fleet.FleetAggregator({
            "serving": "http://127.0.0.1:%d/metrics" % port,
            "worker": "http://127.0.0.1:%d/metrics" % worker_port})
        scrapes = [agg.scrape_once(), agg.scrape_once()]
        status = agg.fleet_status(window_s=60.0)
        worker_beats = agg.gauge_window(
            "fleet.worker_up", 60.0, labels=(("worker", "worker"),))
    finally:
        srv.stop()
        exposition.stop_http()
        profiler.set_config(mode="symbolic", filename="profile.json")
        worker.stdin.close()
        try:
            worker.wait(timeout=30)
        except subprocess.TimeoutExpired:
            worker.kill()
            worker.wait()
        metrics.set_enabled(False)
    req = [e for e in payload["traceEvents"] if e.get("cat") == "request"]
    traced = {e["args"]["trace_id"] for e in req if e["ph"] == "X"}
    fm = sum(n for k, n in payload["kernelRecordsByName"].items()
             if "fused_matmul" in k)
    engines = statusz["engines"]
    families = sorted(n for n in parsed.types if n.startswith("mxnet_serv"))
    # the replays' kernels as the profiler saw them (reported: phase 3
    # holds them to 32 a replay; a replay's launches have no wrapper count)
    log("obs (d) exposition on port %d: /metrics %d families (%d "
        "serving), /statusz perf %s, engines %s, /healthz %s, /tracez %d "
        "recent; %d requests in %d replays: %d traces in the profiler "
        "ring (%d request events), %d fused_matmul kernel records (%.2f a "
        "replay); fleet over 2 endpoints: %s, %d merged series"
        % (port, len(parsed.types), len(families),
           json.dumps(statusz["perf"]), [e.get("engine") for e in engines],
           healthz["status"], len(tracez.get("recent", [])), OBS_REQUESTS,
           replays, len(traced), len(req), fm, fm / max(1, replays),
           scrapes[-1], len(status["series"])))
    probs_ok = all(abs(float(p.sum()) - 1.0) < 1e-3 for p, _lg in answers)
    if not families or statusz["perf"] is None or \
            [e.get("engine") for e in engines] != ["serving"] or \
            healthz["status"] != "ok" or not tracez.get("recent") or \
            len(traced) != OBS_REQUESTS or replays != OBS_REQUESTS or \
            not probs_ok or \
            scrapes[-1] != {"serving": "ok", "worker": "ok"} or \
            worker_beats["n"] != 2 or worker.returncode is None:
        raise AssertionError("obs (d): families %s, perf %s, engines %s, "
                             "traces %d, replays %d, fused_matmul records %d,"
                             " scrapes %s, worker %s" % (
                                 families, statusz["perf"], engines,
                                 len(traced), replays, fm, scrapes,
                                 worker.returncode))
    out["d"] = dict(families=len(parsed.types), serving_families=families,
                    perf=statusz["perf"], engines=len(engines),
                    traces=len(traced), replays=replays,
                    fused_matmul_records=fm, scrapes=scrapes[-1],
                    fleet_series=len(status["series"]))


def obs_phase(mx, sym, card, results):
    """Phase 20: observability on the card (see the module docstring)."""
    import torch

    out = {}
    t0 = time.perf_counter()
    # the parts that hold torch.profiler's records to a count run first
    for part in (obs_resnet, obs_exposition):
        part(mx, sym, card, out)
        torch.cuda.empty_cache()
    for part in (obs_perf_overhead, obs_health_overhead, obs_nan_policies):
        part(mx, card, out)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log("obs: phase 20 in %.1f s" % out["seconds"])
    results["obs"] = out
    return out



# ------------------------------------------------- phase 21: the autotuner
# bench_all.py:1613-1961 --autotune's protocol, on the port
AT_FLASH = (1, 8, 4096, 64)        # (b): B, H, T, D, bf16, causal
AT_FLASH_REPEATS = 5               # timed replays a median
AT_SERVE_N = 240                   # (d): requests, the bench's skewed sizes
AT_SERVE_SIZES = (1, 1, 1, 1, 2, 2, 3, 4, 6, 20)
AT_LAYOUT = dict(layers=50, size=224, batch=16, steps=8)     # (e)
AT_GATE_BATCH, AT_GATE_STEPS = 128, 60                       # (f)
AT_GEN = dict(max_batch=4, max_seq=128)                      # (g)
AT_PIPE_BATCHES = 8
AT_BLOCK = "bench"                 # (c'): the attention block's Module
AT_BLOCK_STEPS = 4


def at_fused_variants(mx, sym, F, peaks, gen):
    """(a) B1: every compiled tile at ResNet-50's served bucket-8 regions,
    held to the default tile (bit for bit) and to the plain version,
    timed per forward (the 32 regions' CUDA-graph times summed)."""
    import torch

    calls = record_region_calls(mx, sym, 8)
    rows = {t: {"ms": 0.0, "max_abs_err": 0.0, "max_diff": 0.0}
            for t in F.TILES}
    plain = lib = bnd = t_ops = t_bytes = 0.0
    for case in calls:
        x, w, ex = make_case(case, torch.float32, gen)
        ep, wt = case["epilogue"], case["wt"]
        want = F.fused_matmul(x, w, ex, ep, wt)
        ref = F.fused_matmul_reference(x, w, ex, ep, wt)
        for t, row in rows.items():
            got = F.fused_matmul(x, w, ex, ep, wt, block_m=t, block_n=t)
            diff = (got - want).abs().max().item()
            row["max_diff"] = max(row["max_diff"], diff)
            if not torch.equal(got, want):
                raise AssertionError(
                    "fused_matmul tile %d is not bit-identical to the "
                    "default tile at %s: max diff %.3g" % (t, case, diff))
            err, rel = rel_err(got, ref, "fused_matmul tile %d" % t)
            if rel > PATH_TOL:
                raise AssertionError("fused_matmul tile %d vs plain at %s: "
                                     "%.3g" % (t, case, rel))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += time_ms(lambda t=t: F.fused_matmul(
                x, w, ex, ep, wt, block_m=t, block_n=t))
        plain += time_ms(lambda: F.fused_matmul_reference(x, w, ex, ep, wt))
        lib += time_ms(lambda: library_fn(x, w, ex, ep, wt))
        b, by = bound_ms(case, 4, peaks)
        bnd += b
        t_ops, t_bytes = (t_ops + b, t_bytes) if by == "operations" \
            else (t_ops, t_bytes + b)
    for t, row in rows.items():
        row.update(plain_ms=plain, library_ms=lib, bound_ms=bnd,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   regions=len(calls))
        log("autotune (a) fused_matmul tile %d: %d regions of the bucket-8 "
            "forward bit-identical to the default tile (max diff %.3g), "
            "max abs err %.3g against plain; ms=%.4f plain_ms=%.4f "
            "library_ms=%.4f bound_ms=%.4f a forward"
            % (t, len(calls), row["max_diff"], row["max_abs_err"],
               row["ms"], plain, lib, bnd))
    return rows, calls


def at_bmm_variants(F, peaks, gen):
    """(a) B2: every compiled tile at the attention block's two batch_dot
    regions (B 8, T 2048, D 512)."""
    import torch

    cfg = BLOCK_SIZES["wide"]
    rows = {t: {"ms": 0.0, "max_abs_err": 0.0, "max_diff": 0.0}
            for t in F.TILES}
    plain = lib = bnd = t_ops = t_bytes = 0.0
    for case in bmm_path_cases(cfg["B"], cfg["T"], cfg["D"], gen):
        x, w, ex, ep = case["x"], case["w"], case["extras"], case["epilogue"]
        want = F.fused_batch_matmul(x, w, ex, ep)
        ref = F.fused_batch_matmul_reference(x, w, ex, ep)
        for t, row in rows.items():
            got = F.fused_batch_matmul(x, w, ex, ep, block_m=t, block_n=t)
            diff = (got - want).abs().max().item()
            row["max_diff"] = max(row["max_diff"], diff)
            if not torch.equal(got, want):
                raise AssertionError("fused_batch_matmul tile %d differs "
                                     "from the default tile at %s: %.3g"
                                     % (t, case["region"], diff))
            err, rel = rel_err(got, ref, "fused_batch_matmul tile %d" % t)
            if rel > PATH_TOL:
                raise AssertionError("fused_batch_matmul tile %d vs plain "
                                     "at %s: %.3g" % (t, case["region"], rel))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += time_ms(lambda t=t: F.fused_batch_matmul(
                x, w, ex, ep, block_m=t, block_n=t))
        plain += time_ms(lambda: F.fused_batch_matmul_reference(x, w, ex,
                                                                ep))
        lib += time_ms(lambda: bmm_library_fn(case))
        b, by = bmm_bound_ms(case, peaks)
        bnd += b
        t_ops, t_bytes = (t_ops + b, t_bytes) if by == "operations" \
            else (t_ops, t_bytes + b)
    for t, row in rows.items():
        row.update(plain_ms=plain, library_ms=lib, bound_ms=bnd,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        log("autotune (a) fused_batch_matmul tile %d at B %d T %d D %d "
            "(scores + context): bit-identical to the default tile (max "
            "diff %.3g), max abs err %.3g; ms=%.4f plain_ms=%.4f "
            "library_ms=%.4f bound_ms=%.4f"
            % (t, cfg["B"], cfg["T"], cfg["D"], row["max_diff"],
               row["max_abs_err"], row["ms"], plain, lib, bnd))
    return rows


def at_flash_variants(FA, peaks, gen, results):
    """(a) B3-B5: the forward at 64 and 128 q rows a block, the dq pass at
    64 and 128 q rows, the dk/dv pass at 64 and 128 k rows, at
    (8, 8, 2048, 64) bf16 causal: each held to the default rows (bit for
    bit) and to its plain version (FLASH_TOL), timed as CUDA-graph
    replays."""
    import torch

    q, k, v, do, dlse = flash_inputs(FLASH_SHAPE, torch.bfloat16, gen)
    scale = FLASH_SHAPE[3] ** -0.5
    o, lse = FA.flash_forward(q, k, v, True)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    dq = FA.flash_backward_dq(q, k, v, do, lse, delta, True)
    dk, dv = FA.flash_backward_dkv(q, k, v, do, lse, delta, True)
    ro, _ = FA.flash_forward_reference(q, k, v, True, scale)
    rdq = FA.flash_backward_dq_reference(q, k, v, do, lse, delta, True,
                                         scale)
    rdk, rdv = FA.flash_backward_dkv_reference(q, k, v, do, lse, delta, True,
                                               scale)
    prior = (results.get("flash") or {}).get("kernels") or {}
    passes = {
        FA.FWD: ("fwd", "block_q",
                 lambda r: FA.flash_forward(q, k, v, True, block_q=r),
                 (o, lse), (ro,),
                 lambda: FA.flash_forward_reference(q, k, v, True, scale)),
        FA.DQ: ("dq", "block_q",
                lambda r: (FA.flash_backward_dq(q, k, v, do, lse, delta,
                                                True, block_q=r),),
                (dq,), (rdq,),
                lambda: FA.flash_backward_dq_reference(
                    q, k, v, do, lse, delta, True, scale)),
        FA.DKV: ("dkv", "block_k",
                 lambda r: FA.flash_backward_dkv(q, k, v, do, lse, delta,
                                                 True, block_k=r),
                 (dk, dv), (rdk, rdv),
                 lambda: FA.flash_backward_dkv_reference(
                     q, k, v, do, lse, delta, True, scale))}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if prior:
        lib = {FA.FWD: prior[FA.FWD]["library_ms"],
               FA.DQ: prior[FA.DQ]["library_ms"]}
    else:
        lib_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=True))
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(*leaves, is_causal=True), leaves, do)) - lib_fwd
        lib = {FA.FWD: lib_fwd, FA.DQ: lib_bwd}
    lib[FA.DKV] = lib[FA.DQ]
    out = {}
    for name, (kind, arg, run, want, refs, plain) in passes.items():
        plain_ms = (prior[name]["plain_ms"] if prior
                    else time_events_ms(plain))
        bnd, by, _ops, _nb = flash_bound_ms(kind, FLASH_SHAPE, True, 2,
                                            peaks["bf16_flops"],
                                            peaks["bytes_per_s"])
        for rows in FA.ROWS[kind][2]:
            got = run(rows)
            diff = max((g.float() - w.float()).abs().max().item()
                       for g, w in zip(got, want))
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError("%s at %d rows differs from the default"
                                     " rows: max diff %.3g"
                                     % (name, rows, diff))
            err = 0.0
            for g, r in zip(got, refs):
                e, rel = rel_err(g, r, "%s rows %d" % (name, rows))
                if rel > FLASH_TOL["bfloat16"]:
                    raise AssertionError("%s at %d rows vs plain: %.3g"
                                         % (name, rows, rel))
                err = max(err, e)
            ms = time_ms(lambda rows=rows: run(rows))
            out[(name, rows)] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib[name],
                bound_ms=bnd, bound_by=by, max_abs_err=err, max_diff=diff,
                default=rows == FA.ROWS[kind][2][0])
            log("autotune (a) %s %s=%d %s bf16 causal: bit-identical to the "
                "default rows (max diff %.3g), max abs err %.3g against "
                "plain; ms=%.4f plain_ms=%.4f library_ms=%.4f bound_ms=%.4f"
                % (name, arg, rows, FLASH_SHAPE, diff, err, ms, plain_ms,
                   lib[name], bnd))
    return out


def at_flash_tune(mx, FA, card, out):
    """(b): tune_flash_attention at B 1, H 8, T 4096, D 64, bf16, causal,
    then bench_all.py's train microbench (grad of q, k, v) at the default
    rows and at the tuned ones."""
    import torch

    from mxnet_tpu_torch.autotune import SearchConfig
    from mxnet_tpu_torch.autotune.tuners import kernel_time

    B, H, T, D = AT_FLASH
    rng = np.random.RandomState(0)
    leaves = [torch.tensor(rng.randn(B, H, T, D), dtype=torch.float32)
              .to("cuda", torch.bfloat16).requires_grad_()
              for _ in range(3)]

    def flash_train_ms(bq, bk, bqb, bkb):
        def run():
            o = FA.flash_attention(*leaves, causal=True, block_q=bq,
                                   block_k=bk, block_q_bwd=bqb,
                                   block_k_bwd=bkb)
            torch.autograd.grad(o.float().sum(), leaves)

        # the tuner's own protocol: CUDA-graph replays of 20 steps
        return kernel_time(run, SearchConfig(repeats=AT_FLASH_REPEATS,
                                             warmup=1)) * 1e3

    default = FA.resolve_rows(B, H, T, D, True, "bfloat16")
    default_blocks = (default[0], 64, default[1], default[2])
    default_ms = flash_train_ms(*default_blocks)
    tuned = mx.autotune.tune_flash_attention(T=T, D=D, B=B, H=H,
                                             dtype="bfloat16", causal=True,
                                             repeats=AT_FLASH_REPEATS)
    tf_, tb = tuned["flash_attention.fwd"], tuned["flash_attention.bwd"]
    tuned_blocks = (tf_["block_q"], tf_["block_k"], tb["block_q"],
                    tb["block_k"])
    tuned_ms = flash_train_ms(*tuned_blocks)
    resolved = FA.resolve_rows(B, H, T, D, True, "bfloat16")
    if resolved != (tuned_blocks[0], tuned_blocks[2], tuned_blocks[3]):
        raise AssertionError("a fresh resolution gives %s, the tuner "
                             "recorded %s" % (resolved, tuned_blocks))
    out["b"] = dict(default_blocks=default_blocks, tuned_blocks=tuned_blocks,
                    default_ms=default_ms, tuned_ms=tuned_ms,
                    speedup=default_ms / tuned_ms, resolved=resolved)
    log("autotune (b) flash fwd+bwd grad(q, k, v) B %d H %d T %d D %d bf16 "
        "causal: default blocks %s %.4f ms -> tuned %s %.4f ms (x%.3f); a "
        "fresh resolution takes %s; on %s"
        % (B, H, T, D, default_blocks, default_ms, tuned_blocks, tuned_ms,
           default_ms / tuned_ms, resolved, card))


def at_fused_tune(mx, F, calls, card, out):
    """(c): tune_fused_matmul at the served ResNet-50's distinct 1x1
    shapes; per shape the tuned tile and its time against the default
    rule's choice (``F.tile_size``; CUDA-graph replays of the modal bias + relu region)."""
    import torch

    shapes = sorted({(c["M"], c["N"], c["K"], c["wt"]) for c in calls})
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for M, N, K, wt in shapes:
        best = mx.autotune.tune_fused_matmul(M, N, K, dtype="float32",
                                             wt=wt)
        case = {"M": M, "N": N, "K": K, "wt": wt,
                "epilogue": (("bias",), ("act", "relu"))}
        x, w, ex = make_case(case, torch.float32, gen)
        ep = case["epilogue"]
        rule = F.tile_size(1, M, N)
        rule_ms = time_ms(lambda: F.fused_matmul(x, w, ex, ep, wt,
                                                 block_m=rule, block_n=rule))
        tuned_ms = time_ms(lambda: F.fused_matmul(
            x, w, ex, ep, wt, block_m=best["block_m"],
            block_n=best["block_n"]))
        resolved = F.resolve_blocks(M, N, K)
        if resolved[0] != best["block_m"]:
            raise AssertionError("a fresh resolution at (%d, %d, %d) takes "
                                 "%s, the tuner recorded %s"
                                 % (M, N, K, resolved, best))
        rows.append(dict(M=M, N=N, K=K, wt=wt, rule_tile=rule,
                         rule_ms=rule_ms, tuned=best, tuned_ms=tuned_ms))
        log("autotune (c) fused_matmul (%d, %d, %d) wt=%s: default %d "
            "%.4f ms, tuned %s %.4f ms" % (M, N, K, wt, rule, rule_ms,
                                            best, tuned_ms))
    out["c"] = dict(shapes=rows, card=card)


def at_block_module(mx, F):
    """(c'): the attention block's Module (the bench size), fit steps at
    the default tiles, then with ``fusion.blocks`` entries naming the
    other tile for its two batch_dot shapes: a fresh bind launches that
    tile. Returns the tiles launched per arm."""
    import torch

    from mxnet_tpu_torch import cuda_build

    cfg = BLOCK_SIZES[AT_BLOCK]
    B, T, D = cfg["B"], cfg["T"], cfg["D"]
    x, y = block_data(B, T, D)
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.gpu())],
                            label=[mx.nd.array(y, ctx=mx.gpu())])
    shapes = ((T, T, D), (T, D, T))  # the scores and the context

    def arm():
        mod = bound_module(mx, attention_block(mx, T, D), (B, T, D), (B,))
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", BLOCK_LR),))
        before = cuda_build.variant_counts()
        for _ in range(AT_BLOCK_STEPS):
            mod.forward_backward(batch)
            mod.update()
        mod.get_outputs()[0].asnumpy()
        after = cuda_build.variant_counts()
        return {v: after.get((F.BMM_KERNEL, v), 0) -
                before.get((F.BMM_KERNEL, v), 0)
                for v in {k[1] for k in after if k[0] == F.BMM_KERNEL}}

    default = arm()
    rule = {F.resolve_blocks(M, N, K, batch=B)[0] for M, N, K in shapes}
    for M, N, K in shapes:
        other = [t for t in F.TILES if t != F.resolve_blocks(
            M, N, K, batch=B)[0]][0]
        mx.autotune.record("fusion.blocks", F.fused_shape_key(M, N, K),
                           {"block_m": other, "block_n": other,
                            "block_k": F.TILES[other][0]}, dtype="float32")
    tuned = arm()
    torch.cuda.synchronize()
    log("autotune (c') attention block Module (B %d T %d D %d), %d fit steps "
        "an arm: default tiles %s launched %s; with fusion.blocks entries "
        "naming the other tile a fresh bind launched %s"
        % (B, T, D, AT_BLOCK_STEPS, sorted(rule), default, tuned))
    if set(tuned) & rule or not tuned:
        raise AssertionError("the entries did not change the tile the next "
                             "bind launched: %s" % tuned)
    return {"default": default, "tuned": tuned}


def at_serving(mx, card, out):
    """(d): tune_serving_buckets on the bench's MLP (fc 32 over 24 inputs)
    with its 240 skewed request sizes; the head-to-head "kept default"
    rule; a fresh server resolves the recorded ladder."""
    from mxnet_tpu_torch.autotune.tuners import (model_key,
                                                 serving_replay_measurer)
    from mxnet_tpu_torch.serving.buckets import (parse_buckets,
                                                 traffic_signature)

    rng = np.random.RandomState(0)
    data = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data, num_hidden=32, name="fc"), name="softmax")
    arg_params = {"fc_weight": (rng.randn(32, 24) * 0.1).astype(np.float32),
                  "fc_bias": np.zeros(32, np.float32)}
    data_shapes = [("data", (1, 24))]
    sizes = [int(s) for s in rng.choice(AT_SERVE_SIZES, size=AT_SERVE_N)]
    measure = serving_replay_measurer(net, arg_params, data_shapes, sizes,
                                      max_wait_ms=2)

    def serving_ms(ladder):
        return measure({"buckets": ladder}) * 1e3

    default_ladder = list(parse_buckets(None))
    default_ms = serving_ms(default_ladder)
    tuned_ladder = mx.autotune.tune_serving_buckets(net, arg_params,
                                                    data_shapes, sizes)
    tuned_ms = serving_ms(tuned_ladder)
    kept_default = False
    if tuned_ms > default_ms and tuned_ladder != default_ladder:
        # head-to-head: a pick that loses the re-measure keeps the
        # incumbent in the cache
        mkey = model_key(net)
        for tk in ("default", traffic_signature(sizes)):
            mx.autotune.record("serving.buckets", (mkey, tk),
                               {"buckets": default_ladder}, ms=default_ms,
                               extra={"note": "head-to-head kept default"})
        tuned_ladder, tuned_ms = default_ladder, default_ms
        kept_default = True
    srv = mx.serving.InferenceServer(net, arg_params,
                                     data_shapes=data_shapes, start=False)
    resolved = list(srv._cfg.buckets)
    srv.stop()
    if resolved != list(tuned_ladder):
        raise AssertionError("a fresh server resolves %s, the tuner "
                             "recorded %s" % (resolved, tuned_ladder))
    out["d"] = dict(default_ladder=default_ladder, tuned_ladder=tuned_ladder,
                    default_ms=default_ms, tuned_ms=tuned_ms,
                    kept_default=kept_default, resolved=resolved)
    log("autotune (d) serving: %d requests (sizes p50 1, p95 6, max 20), "
        "MLP fc32: default %s %.1f ms -> tuned %s %.1f ms%s; a fresh "
        "server resolves %s; on %s"
        % (AT_SERVE_N, default_ladder, default_ms, tuned_ladder, tuned_ms,
           " (kept default)" if kept_default else "", resolved, card))


def at_layout_profile(mx, mod, batch):
    """Device ms and bytes of the layout-moving work of 2 training steps:
    the copy / transpose / contiguous ops under torch.profiler, bytes as
    each op's fp32 input read and written once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(2):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
    ms = nbytes = 0.0
    n = 0
    for evt in prof.events():
        if evt.name not in ("aten::copy_", "aten::clone", "aten::contiguous",
                            "aten::permute", "aten::transpose"):
            continue
        shapes = [s for s in (evt.input_shapes or []) if s]
        if evt.name == "aten::copy_":
            n += 1
            nbytes += 2 * 4 * float(np.prod(shapes[0])) if shapes else 0.0
        ms += evt.self_device_time_total / 1e3
    return {"copy_ops": n, "device_ms": ms / 2, "bytes": nbytes / 2}


def at_layout(mx, card, out):
    """(e): tune_layout on ResNet-50 (batch 16, 224 px, 8 Module steps a
    candidate); the copy / transpose device ms and bytes a step per
    layout from torch.profiler; a fresh bind of the NHWC graph resolves
    the recorded layout."""
    from mxnet_tpu_torch.autotune import median_time

    cfg = AT_LAYOUT
    rng = np.random.RandomState(0)
    bs, size, steps = cfg["batch"], cfg["size"], cfg["steps"]
    per_layout, moved = {}, {}

    def build(layout):
        sym = mx.models.get_resnet(num_classes=1000,
                                   num_layers=cfg["layers"],
                                   image_shape=(3, size, size),
                                   layout=layout)
        shape = ((bs, 3, size, size) if layout == "NCHW"
                 else (bs, size, size, 3))
        mod = mx.mod.Module(sym, context=mx.gpu())
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (bs,))])
        mod.init_params()
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1),))
        batch = mx.io.DataBatch(
            data=[mx.nd.array(rng.rand(*shape).astype(np.float32),
                              ctx=mx.gpu())],
            label=[mx.nd.array(rng.randint(0, 1000, bs).astype(np.float32),
                               ctx=mx.gpu())])
        return sym, mod, batch

    def measure(c):
        layout = c["layout"]
        _sym, mod, batch = build(layout)

        def run():
            for _ in range(steps):
                mod.forward_backward(batch)
                mod.update()
            mod.get_outputs()[0].asnumpy()

        s = median_time(run, repeats=2, warmup=1) / steps
        per_layout[layout] = s * 1e3
        moved[layout] = at_layout_profile(mx, mod, batch)
        return s

    key = ("resnet%d" % cfg["layers"], "b%d" % bs, "s%d" % size)
    winner = mx.autotune.tune_layout(measure, key=key, default="NHWC")
    nhwc = mx.models.get_resnet(num_classes=1000, num_layers=cfg["layers"],
                                image_shape=(3, size, size), layout="NHWC")
    graph_key = mx.graph_pass.graph_fingerprint(nhwc)
    mx.autotune.record("graph.layout", graph_key, {"layout": winner},
                       ms=per_layout[winner])
    opt = mx.graph_pass.optimize(nhwc, arg_shapes={"data": (bs, size, size,
                                                            3)})
    rewrites = sum(r.get("rewrites", 0) for r in (opt.reports if opt
                                                  else ())
                   if r["pass"] == "layout")
    if (rewrites > 0) != (winner != "NHWC"):
        raise AssertionError("a fresh bind of the NHWC graph made %d layout "
                             "rewrites for a tuned %s" % (rewrites, winner))
    out["e"] = dict(per_layout_ms=per_layout, moved=moved, tuned=winner,
                    key=list(key), fresh_bind_rewrites=rewrites)
    log("autotune (e) layout: ResNet-%d batch %d %d px, %d Module steps: "
        "ms a step %s -> %s; copy/transpose a step (torch.profiler) %s; a "
        "fresh NHWC bind makes %d layout rewrites; on %s"
        % (cfg["layers"], bs, size, steps, per_layout, winner, moved,
           rewrites, card))


def at_gate_net(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.Activation(mx.sym.FullyConnected(
        data, num_hidden=512, name="g1"), act_type="relu")
    fc2 = mx.sym.Activation(mx.sym.FullyConnected(
        fc1, num_hidden=512, name="g2"), act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        fc2, num_hidden=16, name="g3"), name="softmax")


def at_remat_gate(mx, card, out):
    """(f): tune_remat on the gate MLP (64-512-512-16, batch 128), then
    bench_all.py:1886-1958's warm-cache gate: the steady-state step makes
    zero cache lookups, and one warm lookup costs < MXNET_TUNE_GATE_PCT of
    a step; the A/B walls (MXNET_TUNE=0 with entries against -1) as
    information."""
    import torch

    from mxnet_tpu_torch import config as mxconfig
    from mxnet_tpu_torch.autotune import median_time
    from mxnet_tpu_torch.executor import _GraphProgram

    gate_pct = float(os.environ.get("MXNET_TUNE_GATE_PCT", "1.0"))
    rng = np.random.RandomState(0)
    net = at_gate_net(mx)
    gbs = AT_GATE_BATCH
    batch = mx.io.DataBatch(
        data=[mx.nd.array(rng.rand(gbs, 64).astype(np.float32),
                          ctx=mx.gpu())],
        label=[mx.nd.array(rng.randint(0, 16, gbs).astype(np.float32),
                           ctx=mx.gpu())])

    def build():
        mod = mx.mod.Module(net, context=mx.gpu(), data_names=("data",))
        mod.bind(data_shapes=[("data", (gbs, 64))],
                 label_shapes=[("softmax_label", (gbs,))])
        mod.init_params()
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1),))
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        mod.get_outputs()[0].asnumpy()
        return mod

    def steps(mod, n):
        t0 = time.perf_counter()
        for _ in range(n):
            mod.forward_backward(batch)
            mod.update()
        mod.get_outputs()[0].asnumpy()
        return (time.perf_counter() - t0) / n

    def remat_measure(c):
        mxconfig.set_flag("MXNET_BACKWARD_DO_MIRROR", int(c["mirror"]))
        try:
            mod = build()
            return median_time(lambda: steps(mod, 10), repeats=3, warmup=1)
        finally:
            mxconfig.set_flag("MXNET_BACKWARD_DO_MIRROR", None)

    gate_key = _GraphProgram(net).tuning_key()
    mirror = mx.autotune.tune_remat(remat_measure, gate_key)
    fresh = build()
    resolved = int(fresh._exec_group.execs[0]._prog.remat_mirror())
    if resolved != mirror:
        raise AssertionError("a fresh Module resolves mirror=%s, the tuner "
                             "recorded %d" % (resolved, mirror))
    del fresh
    try:
        mxconfig.set_flag("MXNET_TUNE", -1)
        mod_bypass = build()
        mxconfig.set_flag("MXNET_TUNE", 0)
        mod_consult = build()
        bypass_s = consult_s = float("inf")
        for _ in range(6):
            mxconfig.set_flag("MXNET_TUNE", -1)
            bypass_s = min(bypass_s, steps(mod_bypass, AT_GATE_STEPS))
            mxconfig.set_flag("MXNET_TUNE", 0)
            consult_s = min(consult_s, steps(mod_consult, AT_GATE_STEPS))
        steps(mod_consult, 2)  # the token's first step after the flip
        mx.autotune.reset_stats()
        steps(mod_consult, AT_GATE_STEPS)
        lk = mx.autotune.stats()
        per_step_lookups = lk["hits"] + lk["misses"]
        n_probe = 2000
        t0 = time.perf_counter()
        for _ in range(n_probe):
            mx.autotune.lookup("exec.remat", gate_key)
        lookup_s = (time.perf_counter() - t0) / n_probe
    finally:
        mxconfig.set_flag("MXNET_TUNE", None)
    torch.cuda.synchronize()
    pct = 100.0 * lookup_s / consult_s
    out["f"] = dict(mirror=mirror, resolved=resolved,
                    bypass_ms=bypass_s * 1e3, consult_ms=consult_s * 1e3,
                    ab_delta_pct=100.0 * (consult_s - bypass_s) / bypass_s,
                    per_step_lookups=per_step_lookups,
                    warm_lookup_us=lookup_s * 1e6, overhead_pct=pct,
                    threshold_pct=gate_pct)
    log("autotune (f) remat on the gate MLP (64-512-512-16, batch %d): "
        "tuned mirror=%d, a fresh Module resolves %s; warm-cache gate: %d "
        "lookups over %d steady-state steps, one warm lookup %.2f us = "
        "%.4f%% of a %.3f ms step (gate %.2f%%); A/B walls (information): "
        "bypass %.3f ms, consult %.3f ms (%+.2f%%); on %s"
        % (gbs, mirror, resolved, per_step_lookups, AT_GATE_STEPS,
           lookup_s * 1e6, pct, consult_s * 1e3, gate_pct, bypass_s * 1e3,
           consult_s * 1e3, out["f"]["ab_delta_pct"], card))
    if per_step_lookups:
        raise AssertionError("%d cache lookups on the steady-state step: "
                             "consults must stay at program build"
                             % per_step_lookups)
    if pct > gate_pct:
        raise AssertionError("a warm lookup costs %.4f%% of a step (> %.2f%%"
                             " gate)" % (pct, gate_pct))


def at_generation(mx, card, out):
    """(g) first half: tune_generation, tune_generation_spec and
    tune_control on phase 11's LM (the train width, bf16, seeded random
    weights) at the tuners' own prompt samples; a fresh Generator
    resolves every recorded knob."""
    G = mx.serving.generation
    model = mx.parallel.TransformerParallel(mx.parallel.make_mesh({"dp": 1}),
                                            dtype="bfloat16", **TRAIN_CFG)
    params = model.init(0)
    t0 = time.perf_counter()
    got = dict(mx.autotune.tune_generation(model, params, **AT_GEN))
    got.update(mx.autotune.tune_generation_spec(model, params, **AT_GEN))
    got.update(mx.autotune.tune_control(model, params, **AT_GEN))
    seconds = time.perf_counter() - t0
    gen = G.Generator(model, params, G.GenerationConfig(prefix_cache=True,
                                                        **AT_GEN),
                      start=False)
    resolved = {"generation.page_size": {"page_size": gen.page_size},
                "generation.decode_blocks": {
                    "decode_blocks": gen.decode_blocks},
                "generation.spec_k": {"spec_k": gen.spec_k},
                "control.prefix_pages": {
                    "prefix_pages": gen.prefix_cache.capacity_pages},
                "control.slo_aging": {"aging_ms": gen._aging_ms}}
    gen.stop()
    out["g_generation"] = dict(tuned=got, resolved=resolved, seconds=seconds)
    log("autotune (g) generation and control on the LM (bf16, max_batch %d, "
        "max_seq %d): tuned %s in %.1f s; a fresh Generator resolves %s; on "
        "%s" % (AT_GEN["max_batch"], AT_GEN["max_seq"], got, seconds,
                resolved, card))
    if resolved != {k: {f: int(v) for f, v in d.items()}
                    for k, d in got.items()}:
        raise AssertionError("a fresh Generator resolves %s, the tuners "
                             "recorded %s" % (resolved, got))
    del model, params


def at_pipeline(mx, card, out):
    """(g) second half: tune_input_pipeline on phase 19's 512-JPEG record
    file (224 px, batch 32); a fresh StreamingIter resolves both
    entries."""
    import tempfile

    from mxnet_tpu_torch.runtime.pipeline import (io_pipeline_key,
                                                  resolve_decode_workers,
                                                  resolve_prefetch_depth)

    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        rec, idx = io_build_rec(mx, os.path.join(tmp, "at"), IO_N, IO_SIZE)
        shape = (3, IO_SIZE, IO_SIZE)

        def make_iter(decode_workers=None, prefetch_depth=None):
            return mx.io.ImageRecordIter(
                rec, shape, IO_BATCH, path_imgidx=idx, streaming=True,
                preprocess_threads=decode_workers,
                prefetch_buffer=prefetch_depth)

        key = io_pipeline_key(IO_BATCH, shape)
        t0 = time.perf_counter()
        got = mx.autotune.tune_input_pipeline(make_iter, key,
                                              batches=AT_PIPE_BATCHES)
        seconds = time.perf_counter() - t0
        it = make_iter()
        try:
            st = it.get_stats()
            resolved = {"io.decode_workers": {
                "workers": st["decode_workers"]},
                "io.prefetch_depth": {"depth": st["prefetch_depth"]}}
        finally:
            it.close()
        # a recorded 0 is the knob's default, the flag's "auto" (the
        # search's default candidate): the iterator then resolves what it
        # resolves without an entry
        want = {"io.decode_workers": {"workers": int(
            got["io.decode_workers"]["workers"]) or resolve_decode_workers(
                None, IO_BATCH, shape)},
            "io.prefetch_depth": {"depth": int(
                got["io.prefetch_depth"]["depth"]) or resolve_prefetch_depth(
                    None, IO_BATCH, shape)}}
    out["g_pipeline"] = dict(tuned=got, resolved=resolved, seconds=seconds)
    log("autotune (g) input pipeline (%d JPEG records, %d px, batch %d, %d "
        "batches a candidate): tuned %s in %.1f s; a fresh StreamingIter "
        "resolves %s; on %s" % (IO_N, IO_SIZE, IO_BATCH, AT_PIPE_BATCHES,
                                got, seconds, resolved, card))
    if resolved != want:
        raise AssertionError("a fresh StreamingIter resolves %s, the tuner "
                             "recorded %s" % (resolved, got))


def at_learned(mx, card, out):
    """(h): bench_all.py --ingest-ledger's protocol over the samples (b)-(g)
    recorded: a perf-ledger row of the programs the perf layer measured in
    this process, the tuning cache's winners, then a training; the holdout
    gate is reported, not gated (a thin dataset leaves it closed)."""
    import tempfile

    import torch

    from mxnet_tpu_torch.autotune import learned
    from mxnet_tpu_torch.observability import perf

    before = learned.sample_count()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "perf_ledger.jsonl")
        perf.append_ledger({"ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
                            "fingerprint": {
                                "device": torch.cuda.get_device_name(0)},
                            "programs": perf.program_table()}, path)
        from_ledger = learned.ingest_ledger(path)
    from_cache = learned.ingest_tune_cache()
    model = learned.train()
    meta = dict(model.meta) if model is not None else {}
    out["h"] = dict(samples_before=before, ledger_rows=from_ledger,
                    tune_cache_rows=from_cache,
                    samples=learned.sample_count(),
                    model_trained=model is not None,
                    gate_ok=bool(meta.get("gate_ok")),
                    holdout_groups=meta.get("n_holdout_groups"),
                    spearman_learned=meta.get("spearman_learned"),
                    spearman_analytic=meta.get("spearman_analytic"))
    log("autotune (h) learned cost model: %d search samples from (b)-(g), "
        "+%d ledger rows, +%d tune-cache rows -> %d samples; trained %s, "
        "gate %s (learned Spearman %s vs analytic %s over %s holdout "
        "groups); on %s"
        % (before, from_ledger, from_cache, out["h"]["samples"],
           out["h"]["model_trained"],
           "OPEN" if out["h"]["gate_ok"] else "closed",
           out["h"]["spearman_learned"], out["h"]["spearman_analytic"],
           out["h"]["holdout_groups"], card))


def autotune_phase(mx, sym, card, peaks, results):
    """Phase 21 (see the module docstring). Returns (variant rows, launches
    by (kernel, variant) on the phase's tuning path: (b), (c) and (c'))."""
    import tempfile

    import torch

    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.parallel import fused as F

    FA = flash_module()
    t0 = time.perf_counter()
    out = {}
    keep = {k: os.environ.get(k) for k in ("MXNET_TUNE_CACHE",)}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        # the phase's own cache file (and its samples and model beside it)
        os.environ["MXNET_TUNE_CACHE"] = os.path.join(tmp, "tuning.json")
        mx.autotune.reset()
        mx.autotune.reset_stats()
        mx.autotune.learned.reset()
        try:
            gen = torch.Generator(device="cuda").manual_seed(0)
            fused_rows, calls = at_fused_variants(mx, sym, F, peaks[0], gen)
            bmm_rows = at_bmm_variants(F, peaks[0], gen)
            flash_rows = at_flash_variants(FA, peaks[1], gen, results)
            torch.cuda.empty_cache()
            # the tuning path: launches per variant from here to (c')
            cuda_build.reset_launch_counts()
            at_flash_tune(mx, FA, card, out)
            at_fused_tune(mx, F, calls, card, out)
            out["c_block"] = at_block_module(mx, F)
            launches = cuda_build.variant_counts()
            torch.cuda.empty_cache()
            at_serving(mx, card, out)
            at_layout(mx, card, out)
            torch.cuda.empty_cache()
            at_remat_gate(mx, card, out)
            at_generation(mx, card, out)
            torch.cuda.empty_cache()
            at_pipeline(mx, card, out)
            at_learned(mx, card, out)
        finally:
            for k, v in keep.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            mx.autotune.reset()
    variants = {}
    for t, row in fused_rows.items():
        variants[(F.KERNEL, str(t))] = row
    for t, row in bmm_rows.items():
        variants[(F.BMM_KERNEL, str(t))] = row
    for (name, rows), row in flash_rows.items():
        variants[(name, str(rows))] = row
    for key in variants:
        if launches.get(key, 0) == 0:
            raise AssertionError("%s at tile %s was launched no time on the "
                                 "tuning path" % key)
    out["launches"] = {"%s@%s" % k: n for k, n in launches.items()}
    out["seconds"] = time.perf_counter() - t0
    log("autotune: phase 21 took %.1f s; launches by kernel@tile on the "
        "tuning path %s" % (out["seconds"], out["launches"]))
    results["autotune"] = dict(
        out, variants={"%s@%s" % k: v for k, v in variants.items()})
    return variants, launches


# ------------------------------------------------- phase 22: resume on the card

# fit(resume=) on ResNet-50 v2 NHWC fp32 at batch 32 (phase 9's optimizer and
# Xavier init): RS_IMAGES seeded images shuffled by NDArrayIter, RS_EPOCHS
# epochs of RS_IMAGES / RN_BATCH steps. (a) SIGTERM from the RS_KILL_AT-th
# batch-end callback (epoch 1, nbatch 2) checkpoints at RS_EXPECT =
# (epoch, batch, step); (b) a child process is sent SIGTERM once its marker
# file reads RS_DRILL_AT steps
RS_IMAGES, RS_EPOCHS, RS_SEED = 256, 2, 22
RS_KILL_AT, RS_EXPECT = 11, (1, 3, 11)
RS_DRILL_AT = 5
RS_PREEMPTED = 43        # a child's exit code after PreemptedError
RS_CHILD_TIMEOUT_S = 600
RS_CHILD_CODE = ("import sys, chip_smoke as c; "
                 "sys.exit(c.resume_child(*sys.argv[1:]))")
# (d): the Module-family programs, each RS_FAMILY_STEPS fit steps at batch
# RS_FAMILY_BATCH of RS_FAMILY_ROW images, against MXNET_FUSION_KERNEL=0
RS_FAMILY_STEPS, RS_FAMILY_BATCH, RS_FAMILY_ROW = 4, 32, (32, 32, 3)
RS_FAMILY_CLASSES = 10


def resume_setup(mx):
    """The phase's program, the same in the parent and in each child:
    ResNet-50 v2 NHWC, phase 9's Xavier init (gaussian, in, magnitude 2)
    from numpy seed 0 as host arrays, and RS_IMAGES seeded images with
    random labels."""
    sym = mx.models.get_resnet(num_classes=1000, num_layers=50,
                               image_shape=(ROW[2],) + ROW[:2],
                               layout="NHWC")
    rng = np.random.RandomState(RS_SEED)
    x = rng.uniform(0, 1, (RS_IMAGES,) + ROW).astype(np.float32)
    y = rng.randint(0, 1000, RS_IMAGES).astype(np.float32)
    init = mx.mod.Module(sym, context=mx.gpu())
    init.bind(data_shapes=[("data", (RN_BATCH,) + ROW)],
              label_shapes=[("softmax_label", (RN_BATCH,))])
    np.random.seed(0)
    init.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg0, aux0 = ({k: v.asnumpy() for k, v in d.items()}
                  for d in init.get_params())
    return sym, x, y, arg0, aux0


def resume_fit(mx, sym, x, y, arg0, aux0, resume=None, callback=None):
    """One ``Module.fit`` of the phase's program on the card: RS_EPOCHS
    epochs over an NDArrayIter shuffled from numpy seed RS_SEED (a resumed
    run restores the checkpoint's order, whatever the seed draws); returns
    the module."""
    np.random.seed(RS_SEED)
    it = mx.io.NDArrayIter(x, y, batch_size=RN_BATCH, shuffle=True,
                           label_name="softmax_label")
    mod = mx.mod.Module(sym, context=mx.gpu())
    mod.fit(it, num_epoch=RS_EPOCHS, optimizer="sgd",
            optimizer_params={"learning_rate": RN_LR,
                              "momentum": RN_MOMENTUM, "wd": RN_WD},
            kvstore="local", batch_end_callback=callback,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in arg0.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in aux0.items()},
            force_init=True, resume=resume)
    return mod


def resume_child(ckpt_dir, marker, out_path):
    """(b)'s training process: the phase's program from ``fit(resume=
    ckpt_dir)`` on the card, TF32 off and cuDNN's deterministic
    algorithms, writing its count of finished steps to ``marker`` after
    each one. Writes its parameters (``out_path`` + ``.npz``) and its
    steps and launches (``out_path``); returns RS_PREEMPTED after a
    PreemptedError, else 0."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.resilience import PreemptedError

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    sym, x, y, arg0, aux0 = resume_setup(mx)
    steps = [0]

    def note_step(_param):
        steps[0] += 1
        with open(marker + ".tmp", "w") as f:
            f.write(str(steps[0]))
        os.replace(marker + ".tmp", marker)

    cuda_build.reset_launch_counts()
    rc = 0
    try:
        mod = resume_fit(mx, sym, x, y, arg0, aux0, resume=ckpt_dir,
                         callback=note_step)
        np.savez(out_path + ".npz", **host_params(*mod.get_params()))
    except PreemptedError:
        rc = RS_PREEMPTED
    torch.cuda.synchronize()
    with open(out_path, "w") as f:
        json.dump({"steps": steps[0], "rc": rc,
                   "launches": cuda_build.launch_counts().get(
                       "fused_matmul", 0),
                   "variants": {"%s@%s" % k: n for k, n in
                                cuda_build.variant_counts().items()}}, f)
    return rc


def run_resume_child(ckpt_dir, marker, out_path, preempt_at=None):
    """Run :func:`resume_child` in a new process from this checkout; with
    ``preempt_at``, send it SIGTERM once its marker reads that many
    steps. Returns (exit code, its JSON record)."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    proc = subprocess.Popen([sys.executable, "-c", RS_CHILD_CODE, ckpt_dir,
                             marker, out_path], cwd=here, env=env)
    try:
        if preempt_at is not None:
            deadline = time.monotonic() + RS_CHILD_TIMEOUT_S
            while proc.poll() is None and time.monotonic() < deadline:
                try:
                    with open(marker) as f:
                        done = int(f.read() or 0)
                except (OSError, ValueError):
                    done = 0
                if done >= preempt_at:
                    proc.send_signal(signal.SIGTERM)
                    break
                time.sleep(0.05)
        rc = proc.wait(timeout=RS_CHILD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(out_path) as f:
        return rc, json.load(f)


def equal_bits(got, want, what):
    """Raise unless two {name: numpy} dicts are equal to the bit."""
    if sorted(got) != sorted(want):
        raise AssertionError("%s: other tensors (%s)" % (what, sorted(
            set(got) ^ set(want))[:4]))
    differ = [k for k, v in want.items()
              if got[k].dtype != v.dtype or got[k].shape != v.shape
              or got[k].tobytes() != v.tobytes()]
    if differ:
        worst = max_rel_err({k: got[k] for k in differ},
                            {k: want[k] for k in differ})
        raise AssertionError("%s: %d of %d tensors differ from the unbroken "
                             "run, worst %s at %.3g of its max |value|"
                             % (what, len(differ), len(want), worst[1],
                                worst[0]))


def resume_in_process(mx, setup, card, out):
    """(a) the unbroken fit, the fit stopped by SIGTERM from the
    RS_KILL_AT-th batch-end callback, and the resume, in this process;
    RN_REGIONS fused_matmul launches a step expected. A step's time is
    the median gap between batch-end callbacks (the metric's copy off the
    card waits for each step), so a resumed run's restore and bind are
    not in it. Returns the unbroken run's parameters and the checkpoint
    directory."""
    import signal
    import tempfile

    import torch

    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.resilience import PreemptedError, load_latest

    sym, x, y, arg0, aux0 = setup
    runs = {}

    def run(name, resume=None, callback=None):
        ends = []

        def count(param):
            ends.append(time.perf_counter())
            if callback is not None:
                callback(param)

        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        mod = None
        try:
            mod = resume_fit(mx, sym, x, y, arg0, aux0, resume=resume,
                             callback=count)
        finally:
            torch.cuda.synchronize()
            launches = cuda_build.launch_counts().get("fused_matmul", 0)
            runs[name] = dict(steps=len(ends), launches=launches,
                              seconds=time.perf_counter() - t0,
                              step_ms=float(np.median(np.diff(ends)) * 1e3)
                              if len(ends) > 1 else None,
                              variants={"%s@%s" % k: n for k, n in
                                        cuda_build.variant_counts().items()})
        if launches != RN_REGIONS * len(ends):
            raise AssertionError("%s: fused_matmul launched %d times over %d "
                                 "steps, want %d a step" % (
                                     name, launches, len(ends), RN_REGIONS))
        return mod

    mod = run("unbroken")
    unbroken = host_params(*mod.get_params())
    del mod
    gc.collect()
    ckpt_dir = tempfile.mkdtemp(prefix="resume_", dir=out["tmp"])

    calls = []

    def preempt(param):
        calls.append(param.nbatch)
        if len(calls) == RS_KILL_AT:
            os.kill(os.getpid(), signal.SIGTERM)

    previous = signal.getsignal(signal.SIGTERM)
    try:
        run("preempted", resume=ckpt_dir, callback=preempt)
        raise AssertionError("SIGTERM at callback %d raised no "
                             "PreemptedError" % RS_KILL_AT)
    except PreemptedError as err:
        path = err.checkpoint_path
    if signal.getsignal(signal.SIGTERM) is not previous:
        raise AssertionError("the guard left its SIGTERM handler installed")
    gc.collect()
    t0 = time.perf_counter()
    state = load_latest(ckpt_dir)
    load_ms = (time.perf_counter() - t0) * 1e3
    where = (state.epoch, state.batch, state.step)
    if state.path != path or where != RS_EXPECT:
        raise AssertionError("load_latest gives %s at %s, want %s at %s"
                             % (where, state.path, RS_EXPECT, path))
    ckpt_bytes = {name: os.path.getsize(os.path.join(path, name))
                  for name in state.meta["files"]}
    mod = run("resumed", resume=ckpt_dir)
    resumed = host_params(*mod.get_params())
    del mod
    gc.collect()
    equal_bits(resumed, unbroken, "(a) the resumed run")
    total = runs["unbroken"]["steps"]
    if runs["preempted"]["steps"] + runs["resumed"]["steps"] != total or \
            runs["preempted"]["steps"] != RS_KILL_AT:
        raise AssertionError("steps %s" % runs)
    if total != RS_EPOCHS * (RS_IMAGES // RN_BATCH):
        raise AssertionError("the unbroken run took %d steps" % total)
    out["a"] = dict(runs,
                    checkpoint=dict(epoch=state.epoch, batch=state.batch,
                                    step=state.step, bytes=ckpt_bytes,
                                    load_ms=load_ms),
                    tensors=len(unbroken))
    log("resume (a): unbroken %d steps, SIGTERM at callback %d -> "
        "PreemptedError, checkpoint (epoch, batch, step) = %s, resumed %d "
        "steps: all %d parameters and aux states equal the unbroken run's "
        "to the bit; fused_matmul launches %d / %d / %d (%d a step); "
        "median step %.2f / %.2f / %.2f ms; load_latest %.1f ms for %d "
        "bytes, on %s"
        % (total, RS_KILL_AT, where, runs["resumed"]["steps"],
           len(unbroken), runs["unbroken"]["launches"],
           runs["preempted"]["launches"], runs["resumed"]["launches"],
           runs["resumed"]["launches"] // runs["resumed"]["steps"],
           runs["unbroken"]["step_ms"], runs["preempted"]["step_ms"],
           runs["resumed"]["step_ms"], load_ms, sum(ckpt_bytes.values()),
           card))
    return unbroken, ckpt_dir


def resume_drill(unbroken, card, out):
    """(b) the kill -TERM drill: a child trains the same program, gets
    SIGTERM once its marker file reads RS_DRILL_AT steps, exits with
    PreemptedError; a second child resumes to the end. Its parameters
    equal (a)'s unbroken run to the bit."""
    import tempfile

    from mxnet_tpu_torch.resilience import load_latest

    ckpt_dir = tempfile.mkdtemp(prefix="drill_", dir=out["tmp"])
    marker = os.path.join(ckpt_dir, "steps")
    rc1, first = run_resume_child(ckpt_dir, marker,
                                  os.path.join(out["tmp"], "drill1.json"),
                                  preempt_at=RS_DRILL_AT)
    if rc1 != RS_PREEMPTED:
        raise AssertionError("the first child exited %d, want %d "
                             "(PreemptedError)" % (rc1, RS_PREEMPTED))
    state = load_latest(ckpt_dir)
    if state is None or state.step < RS_DRILL_AT or \
            state.step != first["steps"]:
        raise AssertionError("the first child's checkpoint %s after %d "
                             "steps" % (state and state.step,
                                        first["steps"]))
    os.remove(marker)
    out_path = os.path.join(out["tmp"], "drill2.json")
    rc2, second = run_resume_child(ckpt_dir, marker, out_path)
    if rc2 != 0:
        raise AssertionError("the resuming child exited %d" % rc2)
    total = RS_EPOCHS * (RS_IMAGES // RN_BATCH)
    if first["steps"] + second["steps"] != total:
        raise AssertionError("the children took %d + %d steps, want %d"
                             % (first["steps"], second["steps"], total))
    for rec in (first, second):
        if rec["launches"] != RN_REGIONS * rec["steps"]:
            raise AssertionError("a child launched fused_matmul %d times "
                                 "over %d steps" % (rec["launches"],
                                                    rec["steps"]))
    with np.load(out_path + ".npz") as npz:
        final = {k: npz[k] for k in npz.files}
    equal_bits(final, unbroken, "(b) the resumed child")
    out["b"] = dict(first=first, second=second,
                    checkpoint_step=state.step)
    log("resume (b): kill -TERM at the child's step %d marker: exit %d "
        "(PreemptedError) after %d steps, checkpoint at step %d; the "
        "second child resumed %d steps to the unbroken run's parameters "
        "bit for bit; fused_matmul %d + %d launches (%s / %s), on %s"
        % (RS_DRILL_AT, rc1, first["steps"], state.step, second["steps"],
           first["launches"], second["launches"], first["variants"],
           second["variants"], card))


def resume_bad_checkpoints(mx, ckpt_dir, card, out):
    """(c) on the card-written checkpoint of (a): a corrupt manifest, a
    tampered ``params.ndarray`` and a ``checkpoint.write`` fault each
    leave ``load_latest`` on the checkpoint before; save_resumable is
    timed on the resumed module's state (loaded back from (a))."""
    import shutil
    import tempfile

    from mxnet_tpu_torch.resilience import InjectedFault, checkpoint, faults

    good = checkpoint.load_latest(ckpt_dir)
    src = good.path
    results = {}
    for case in ("manifest", "checksum", "fault"):
        d = tempfile.mkdtemp(prefix="bad_%s_" % case, dir=out["tmp"])
        base = os.path.join(d, os.path.basename(src))
        shutil.copytree(src, base)
        later = os.path.join(d, "ckpt-%08d" % (good.step + 1))
        if case == "fault":
            faults.configure("checkpoint.write:raise@call=1")
            try:
                checkpoint.write_resumable(
                    d, good.arg_params, good.aux_params, epoch=good.epoch,
                    batch=good.batch + 1, step=good.step + 1)
                raise AssertionError("the checkpoint.write fault did not "
                                     "fire")
            except InjectedFault:
                pass
            finally:
                faults.reset()
        else:
            shutil.copytree(src, later)
            if case == "manifest":
                with open(os.path.join(later, "MANIFEST.json"), "w") as f:
                    f.write("{not json")
            else:
                with open(os.path.join(later, "params.ndarray"), "ab") as f:
                    f.write(b"garbage")
        got = checkpoint.load_latest(d)
        if got is None or got.path != base:
            raise AssertionError("(c) %s: load_latest gave %s, want %s"
                                 % (case, got and got.path, base))
        results[case] = os.path.basename(got.path)
    # the write's cost: parameters, momentum and the rest of a ResNet-50
    # checkpoint from a module on the card
    mod = out["write_module"]
    d = tempfile.mkdtemp(prefix="write_", dir=out["tmp"])
    t0 = time.perf_counter()
    path = mod.save_resumable(d, epoch=good.epoch, batch=good.batch,
                              step=good.step)
    write_ms = (time.perf_counter() - t0) * 1e3
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    t0 = time.perf_counter()
    back = checkpoint.load_latest(d)
    load_ms = (time.perf_counter() - t0) * 1e3
    equal_bits(host_params(back.arg_params, back.aux_params),
               host_params(*mod.get_params()), "(c) the written checkpoint")
    out["c"] = dict(fallback=results, write_ms=write_ms, load_ms=load_ms,
                    bytes=size)
    log("resume (c): corrupt manifest, tampered params.ndarray and a "
        "checkpoint.write fault each fall back to %s; save_resumable %.1f "
        "ms and load_latest %.1f ms for %d bytes (ResNet-50 parameters, aux "
        "states, momentum, generators, order), on %s"
        % (results["manifest"], write_ms, load_ms, size, card))


def family_convnet(mx):
    """(d)'s feature module: an NHWC conv stem (3x3 conv, relu, 2x2 max
    pool, flatten), no labels. No BatchNorm: over several steps its
    E[x^2] - E[x]^2 turns the summation order's last bits into ~1e-5
    moves of the conv weights (the ground rules' BatchNorm-behind-ReLU
    exception), which would hide what the comparison is for."""
    x = mx.sym.Convolution(mx.sym.var("data"), kernel=(3, 3), pad=(1, 1),
                           num_filter=16, layout="NHWC", name="c1")
    x = mx.sym.Pooling(mx.sym.Activation(x, act_type="relu"), kernel=(2, 2),
                       stride=(2, 2), pool_type="max", layout="NHWC")
    return mx.sym.Flatten(x)


def family_programs(mx):
    """(d)'s two chains on the card: {name: build()}, each build returning
    a SequentialModule."""
    ctx = mx.gpu()

    def feature():
        return mx.mod.Module(family_convnet(mx), label_names=None,
                             context=ctx)

    def hidden(name):
        # the FC + relu whose region the fuse pass lowers onto fused_matmul
        return mx.mod.Module(mx.sym.Activation(mx.sym.FullyConnected(
            mx.sym.var(name), num_hidden=256, name="fc1"), act_type="relu"),
            data_names=[name], label_names=None, context=ctx)

    def sequential():
        seq = mx.mod.SequentialModule()
        seq.add(feature())
        seq.add(hidden("feat"), auto_wiring=True)
        seq.add(mx.mod.Module(mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.var("h"), num_hidden=RS_FAMILY_CLASSES, name="fc2"),
            name="softmax"), data_names=["h"], context=ctx),
            take_labels=True, auto_wiring=True)
        return seq

    def python_loss():
        def softmax_ce_grad(scores, labels):
            p = mx.nd.softmax(scores, axis=1)
            return p - mx.nd.one_hot(labels, depth=RS_FAMILY_CLASSES)

        seq = mx.mod.SequentialModule()
        seq.add(feature())
        seq.add(hidden("feat"), auto_wiring=True)
        seq.add(mx.mod.Module(mx.sym.FullyConnected(
            mx.sym.var("h"), num_hidden=RS_FAMILY_CLASSES, name="fc2"),
            data_names=["h"], label_names=None, context=ctx),
            auto_wiring=True)
        seq.add(mx.mod.PythonLossModule(grad_func=softmax_ce_grad),
                take_labels=True, auto_wiring=True)
        return seq

    return {"sequential": sequential, "python_loss": python_loss}


def family_data(n):
    rng = np.random.RandomState(RS_SEED + 1)
    x = rng.uniform(0, 1, (n,) + RS_FAMILY_ROW).astype(np.float32)
    y = rng.randint(0, RS_FAMILY_CLASSES, n).astype(np.float32)
    return x, y


def family_fit(mx, name, x, y):
    """One (d) program fit on the card from numpy seed 0's Xavier init;
    returns (host parameters, fused_matmul launches, FeedForward
    predictions or None, the device of the trained parameters)."""
    from mxnet_tpu_torch import cuda_build

    cuda_build.reset_launch_counts()
    np.random.seed(0)
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    if name == "feedforward":
        sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Activation(mx.sym.FullyConnected(
                mx.sym.Flatten(mx.sym.var("data")), num_hidden=256,
                name="fc1"), act_type="relu"),
            num_hidden=RS_FAMILY_CLASSES, name="fc2"), name="softmax")
        model = mx.model.FeedForward(
            sym, ctx=None, num_epoch=1, numpy_batch_size=RS_FAMILY_BATCH,
            initializer=mx.init.Xavier(), **opt)
        model.fit(x, y)
        dev = model._module._exec_group.param_arrays[0][0].context
        launches = cuda_build.launch_counts().get("fused_matmul", 0)
        preds = model.predict(x)
        return (host_params(model.arg_params, model.aux_params or {}),
                launches, preds, dev)
    trainable = family_programs(mx)[name]()
    trainable.fit(mx.io.NDArrayIter(x, y, batch_size=RS_FAMILY_BATCH),
                  num_epoch=1, optimizer="sgd", optimizer_params=opt,
                  initializer=mx.init.Xavier())
    dev = trainable._chain[1][0]._exec_group.param_arrays[0][0].context
    launches = cuda_build.launch_counts().get("fused_matmul", 0)
    return (host_params(*trainable.get_params()), launches, None, dev)


def resume_family(mx, card, out):
    """(d) SequentialModule (conv feature module, FC + relu on
    fused_matmul, the loss head), the same chain ending in a
    PythonLossModule, and FeedForward(ctx=None) fit and predict: on the
    card with the kernel (one launch a step) and with
    MXNET_FUSION_KERNEL=0, every parameter within MODULE_TOL of its max
    |value|."""
    x, y = family_data(RS_FAMILY_STEPS * RS_FAMILY_BATCH)
    rows = {}
    for name in ("sequential", "python_loss", "feedforward"):
        kern, launches, preds, dev = family_fit(mx, name, x, y)
        mx.config.set_flag("MXNET_FUSION_KERNEL", 0)
        try:
            plain, plain_launches, plain_preds, _ = family_fit(
                mx, name, x, y)
        finally:
            mx.config.set_flag("MXNET_FUSION_KERNEL", None)
        if dev.device_type != "gpu":
            raise AssertionError("(d) %s trained on %s" % (name, dev))
        if launches != RS_FAMILY_STEPS or plain_launches:
            raise AssertionError("(d) %s: fused_matmul %d launches over %d "
                                 "steps (want 1 a step), %d with the "
                                 "kernel off" % (name, launches,
                                                 RS_FAMILY_STEPS,
                                                 plain_launches))
        worst, worst_name, identical = max_rel_err(kern, plain)
        if not all(np.isfinite(v).all() for v in kern.values()) or \
                worst > MODULE_TOL:
            raise AssertionError("(d) %s disagrees with "
                                 "MXNET_FUSION_KERNEL=0: %s at %.3g"
                                 % (name, worst_name, worst))
        row = dict(worst=worst, worst_name=worst_name, identical=identical,
                   tensors=len(kern), launches=launches, device=str(dev))
        if preds is not None:
            perr = float(np.abs(preds - plain_preds).max())
            if preds.shape != (len(x), RS_FAMILY_CLASSES) or perr > \
                    MODULE_TOL:
                raise AssertionError("(d) FeedForward.predict %s, %.3g off "
                                     "the plain run" % (preds.shape, perr))
            row["predict_err"] = perr
        rows[name] = row
        log("resume (d): %s on %s: %d fit steps, fused_matmul %d launches; "
            "against MXNET_FUSION_KERNEL=0 %d of %d tensors bit-identical, "
            "worst %s at %.3g of its max |value|%s, on %s"
            % (name, dev, RS_FAMILY_STEPS, launches, identical, len(kern),
               worst_name, worst,
               ("; predict within %.3g" % row["predict_err"]
                if preds is not None else ""), card))
    out["d"] = rows


def resume_phase(mx, card, results):
    """Phase 22 (see the module docstring), under cuDNN's deterministic
    algorithms (restored after): (a) in-process preemption and resume,
    (b) the kill -TERM drill across processes, (c) bad checkpoints, (d)
    the Module family."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    try:
        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as tmp:
            out["tmp"] = tmp
            setup = resume_setup(mx)
            unbroken, ckpt_dir = resume_in_process(mx, setup, card, out)
            resume_drill(unbroken, card, out)
            sym, x, y, arg0, aux0 = setup
            mod = mx.mod.Module(sym, context=mx.gpu())
            mod.bind(data_shapes=[("data", (RN_BATCH,) + ROW)],
                     label_shapes=[("softmax_label", (RN_BATCH,))])
            state = mx.resilience.load_latest(ckpt_dir)
            mod.init_params(arg_params=state.arg_params,
                            aux_params=state.aux_params)
            mod.init_optimizer(optimizer="sgd", optimizer_params={
                "learning_rate": RN_LR, "momentum": RN_MOMENTUM,
                "wd": RN_WD})
            mod.load_optimizer_states(state.optimizer_states)
            out["write_module"] = mod
            resume_bad_checkpoints(mx, ckpt_dir, card, out)
            del out["write_module"], mod
            gc.collect()
            resume_family(mx, card, out)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
        out.pop("tmp", None)
    out["seconds"] = time.perf_counter() - t0
    log("resume: phase 22 took %.1f s; checkpoint write %.1f ms, load %.1f "
        "ms, %d bytes; on %s" % (out["seconds"], out["c"]["write_ms"],
                                 out["c"]["load_ms"], out["c"]["bytes"],
                                 card))
    results["resume"] = out
    return out


def resume_row(resume):
    """The kernels line's phase 22 entry of B1: steps and launches of (a)'s
    three fits and (b)'s two children, their totals and the launches a
    step they give, and (d)'s launches by program."""
    fits = [resume["a"][n] for n in ("unbroken", "preempted", "resumed")]
    drill = [resume["b"][c] for c in ("first", "second")]
    launches = sum(r["launches"] for r in fits + drill)
    steps = sum(r["steps"] for r in fits + drill)
    return dict(
        {n: {k: resume["a"][n][k] for k in ("steps", "launches", "step_ms")}
         for n in ("unbroken", "preempted", "resumed")},
        drill=[{k: r[k] for k in ("steps", "launches")} for r in drill],
        launches=launches, steps=steps,
        launches_per_step=launches // steps,
        module_family={n: r["launches"] for n, r in resume["d"].items()})


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
    results = {"card": card, "peaks": phase_peaks(card),
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
    clock = [time.perf_counter()]
    results["phase_s"] = {}

    def tick(name):
        now = time.perf_counter()
        results["phase_s"][name] = now - clock[0]
        clock[0] = now

    path_err, totals = kernel_phase(mx, sym, peaks, results)
    results["kernel_totals"] = totals
    tick("2 kernel")
    launches = serve_phase(mx, sym, card, results)
    tick("3 serve")
    timing = flash_phase(card, results["peaks"], results)
    tick("4 flash")
    flash_launches, trained = train_phase(mx, card, results, timing)
    tick("5 train")
    bmm_err, bmm_totals = bmm_phase(peaks, results)
    tick("6 bmm")
    bmm_launches = module_phase(mx, card, results)
    tick("7 module")
    rtc = rtc_phase(mx, card, peaks, results)
    tick("8 rtc")
    rn = resnet_train_phase(mx, sym, card, peaks, results)
    tick("9 resnet train")
    trainer_phase(mx, mx.models.get_resnet(num_classes=1000, num_layers=50,
                                           layout="NHWC"),
                  card, results["peaks"], results)
    tick("10 trainer")
    gen_launches = generation_phase(mx, card, trained, results)
    tick("11 generation")
    gluon_phase(mx, card, results)
    tick("12 gluon")
    rnn_phase(mx, card, results)
    tick("13 rnn")
    serving_phase(mx, sym, card, results)
    tick("14 serving")
    ssd_phase(mx, card, results)
    tick("15 ssd")
    model_zoo_phase(mx, card, results)
    tick("16 zoo")
    amp = amp_control_phase(mx, sym, card, results["peaks"], results)
    tick("17 amp and control")
    quant = quantize_phase(mx, sym, card, results)
    tick("18 quantize")
    torch.cuda.empty_cache()
    io = io_phase(mx, card, results)
    tick("19 io")
    torch.cuda.empty_cache()
    obs = obs_phase(mx, sym, card, results)
    tick("20 observability")
    torch.cuda.empty_cache()
    variants, variant_launches = autotune_phase(mx, sym, card,
                                                (peaks, results["peaks"]),
                                                results)
    tick("21 autotune")
    torch.cuda.empty_cache()
    resume = resume_phase(mx, card, results)
    tick("22 resume")
    log("seconds by phase: %s" % json.dumps(
        {k: round(v, 1) for k, v in results["phase_s"].items()}))

    F_KERNEL, F_BMM = "fused_matmul", "fused_batch_matmul"
    t8 = totals[8]
    kernels = {"kernels": [{
        "name": "fused_matmul", "route": "cuda",
        "cores": "CUDA cores, fp32 FMA (register-tiled, 128 or 64 tiles); "
                 "tensor cores (wgmma, cp.async ring) for bf16/fp16 "
                 "operands, the amp path's",
        "source": "mxnet_tpu_torch/csrc/fused_matmul.cu",
        "replaces": "mxnet_tpu/parallel/fused.py:168",
        "launches": launches, "max_abs_err": path_err,
        "serve": {k: results["serve"][k] for k in
                  ("captures", "replays", "profiled_replays",
                   "profiled_launches")},
        "ms": t8["ms"], "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
        "library_ms": t8["library_ms"],
        "train": dict(rn["kernel_per_step"], launches=rn["launches"],
                      launches_per_step=rn["launches_per_step"]),
        # phase 19 (b): ResNet-50 trained from records, Module.fit
        "records": {k: io["b"][k] for k in ("launches", "steps",
                                            "launches_per_step")},
        # phase 22: the fits of the resume phase, in this process ((a):
        # unbroken, preempted, resumed) and in the drill's two children
        "resume": resume_row(resume),
        # phase 20 (c): Module.fit with perf and health on, 2 steps
        # profiled; (d): the served model's replays under the profiler
        "observability": dict(
            {k: obs["c"][k] for k in ("launches", "steps",
                                      "launches_per_step")},
            profiled=obs["c"]["profiled"],
            served_replays=obs["d"]["replays"],
            served_records=obs["d"]["fused_matmul_records"]),
        # phase 17 (a): bf16 operands in the amp-served buckets' graphs,
        # on the tensor-core route (bucket 8 at the top level, bucket 1
        # beside it)
        "amp_serve": dict(
            {k: v for k, v in amp["a"]["kernel"]["8"].items()
             if k != "cases"}, replays=amp["a"]["replays"],
            launches=amp["a"]["launches"],
            launches_per_replay=amp["a"]["kernel_regions"],
            captured_variants=amp["a"]["captured_variants"],
            max_abs_err=amp["a"]["kernel_max_err"],
            bucket1={k: v for k, v in amp["a"]["kernel"]["1"].items()
                     if k != "cases"})}]}
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
            # its second path: the generation prefill, one CUDA graph per
            # bucket, phase 11 (d) (bf16) and phase 17 (b) (amp)
            row["generation"] = dict(
                launches=gen_launches, requests=GEN_REQUESTS,
                per_request=gen_launches / GEN_REQUESTS,
                per_prefill_replay=sorted({
                    r["flash_fwd_per_replay"]
                    for r in amp["d"]["per_bucket"]}),
                amp_launches=amp["b"]["amp"]["flash_fwd_launches"],
                amp_prefills=amp["b"]["amp"]["prefills"],
                # phase 18 (c): the int8 Generator's prefill replays
                int8_launches=quant["c"]["arms"]["int8"][
                    "flash_fwd_launches"],
                int8_prefills=quant["c"]["arms"]["int8"]["prefills"])
        # phase 20 (b): the health-overhead microbench's warn arm
        row["health_bench"] = obs["b"]["flash_launches"][name]
        row["library"] = ("SDPA forward" if name == "flash_attention_fwd"
                          else "SDPA backward (dq, dk and dv in one call)")
        kernels["kernels"].append(row)
    wide = bmm_totals["wide"]
    kernels["kernels"].append({
        "name": "fused_batch_matmul", "route": "cuda",
        "cores": "CUDA cores, fp32 FMA (register-tiled, 128 or 64 tiles); "
                 "tensor cores (wgmma, cp.async ring) for bf16/fp16 "
                 "operands",
        "source": "mxnet_tpu_torch/csrc/fused_matmul.cu",
        "replaces": "mxnet_tpu/parallel/fused.py:292",
        "launches": bmm_launches, "max_abs_err": bmm_err,
        "ms": wide["ms"], "plain_ms": wide["plain_ms"],
        "bound_ms": wide["bound_ms"], "bound_by": wide["bound_by"],
        "library_ms": wide["library_ms"],
        # phase 6: the same two regions with bf16 operands on the
        # tensor-core route (the amp bind's), per step at the wide size;
        # phase 7: the amp bind's first step, 2 launches on that route
        "bf16": dict(results["bmm_bf16_totals"]["wide"],
                     max_abs_err=results["bmm_bf16_max_abs_err"],
                     amp_module_variants=results["module"][
                         "amp_block_variants"])})
    hk = obs["c"]["health_kernel"]
    kernels["kernels"].append({
        "name": "health_stats", "route": "cuda",
        "cores": "CUDA cores, float64 accumulation",
        "source": "mxnet_tpu_torch/csrc/health_stats.cu",
        # the JAX package reduces with one XLA program, no Pallas kernel
        "replaces": "mxnet_tpu/observability/health.py:170",
        "launches": obs["c"]["health_stats_launches"],
        "max_abs_err": hk["max_abs_err"], "ms": hk["ms"],
        "plain_ms": hk["plain_ms"], "bound_ms": hk["bound_ms"],
        "bound_by": hk["bound_by"], "library_ms": hk["library_ms"],
        "health_bench": dict(
            {k: obs["b"]["health_kernel"][k]
             for k in ("tensors", "ms", "plain_ms", "bound_ms",
                       "max_abs_err")},
            launches=obs["b"]["health_stats_launches"])})
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
    # phase 21 (a): one row per compiled tile of B1-B5, its launches from
    # the phase's tuning path (b), (c) and (c')
    sources = {
        F_KERNEL: ("fused_matmul.cu", "mxnet_tpu/parallel/fused.py:168"),
        F_BMM: ("fused_matmul.cu", "mxnet_tpu/parallel/fused.py:292")}
    sources.update({name: ("flash_attention.cu",
                           "mxnet_tpu/parallel/flash_attention.py:%d" % line)
                    for name, line in replaces.items()})
    for (name, tile), row in sorted(variants.items()):
        src, rep = sources[name]
        kernels["kernels"].append({
            "name": "%s@%s" % (name, tile), "route": "cuda",
            "tile": int(tile),
            "source": "mxnet_tpu_torch/csrc/" + src, "replaces": rep,
            "launches": variant_launches[(name, tile)],
            "max_abs_err": row["max_abs_err"],
            "max_diff_vs_default": row["max_diff"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
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

#!/usr/bin/env python3
"""Smoke and measurement run of paddle_tpu_torch on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time and
   each kernel's registers and spills;
3. holds each kernel (flash forward, the flash backward pair, paged
   decode, tree decode; the recurrences in step 10) against its plain PyTorch version on the same CUDA
   tensors, at the shapes the serving and training paths give it and at
   edge cases (for the flash forward and the backward pair also the
   first 32- and 64-row tiles, T and S off multiples of 64, an all-zero
   key tile between valid ones, a row with every key masked, head dims
   128 and 33, GQA and a window at T 256; each case with its launch
   plan; the backward pair's dead rows and masked keys exactly 0),
   printing each case's max abs error beside its tolerance; for paged
   decode also lengths ending on split boundaries, slots whose later
   splits are empty, length 1, page sizes 1, 3, 4, 12, 64 and 256, dh 33
   and 128, pools off 16-byte alignment, each case with its split plan,
   and a replay from a CUDA graph after the lengths and the page table
   changed in place; for the flash forward's split rows path (T <= 4)
   causal decode, one- and two-sided windows, GQA, S 77 with only the
   last chunk valid, a wholly masked slot, S 1, head dim 33 and K/V off
   16-byte alignment, and a graph replay after the key mask changed in
   place; for tree decode scans ending mid-page, splits wholly past the
   scan, max_length inside a tree, 8 and 19 nodes over several splits,
   head dim 33, each case with its split plan, and a graph replay after
   the bases, table and node masks changed in place; checks that the
   plans of the backward pair (``flash_bwd_plan``), B4 (``paged_plan``),
   B5 (``tree_plan``), B1's rows path (``flash_rows_plan``), B6
   (``lstm_plan``) and B7 (``gru_plan``) give the threads and shared
   bytes (and blocks) the kernels derive, at every head dim or over
   batches and widths, and so do the plans of B1's, B2's and B3's bf16
   entries (``flash_bf16_plan``, ``flash_bwd_plan``'s ``"dkv_bf16"`` and
   ``"dq_bf16"``; B2's also its Q tile, B3's its K/V tile); runs a full
   [B, H, T, S] mask (GQA, a window, a fully masked row) through
   ``flash_attention`` on the card and on the CPU (``attention_reference``
   on both, no kernel launch; forward and gradients within 1e-4); then times
   kernel, plain version and (where one exists) the one-call PyTorch
   equivalent: device time per call, from CUDA events around replays of
   a CUDA graph of 30 calls (no host launch cost in the time) that cycle
   through input copies larger than the L2 cache; the library time of the
   backward pair (autograd's backward of ``scaled_dot_product_attention``
   with the key mask, or ``is_causal``, which a graph cannot hold) as
   the device time of its kernels from a profiler trace of 10 eager
   calls (``device_ms``), so no host time enters it; that backward
   computes its own ``rowsum(dO O)``, so a ``pair`` line adds the port's
   ``delta`` pass (timed as the kernels are) to its two kernels beside
   it.
   The backward pair's bounds are printed two ways: at the split-TF32
   rate of the tensor cores (a third of 495 TFLOP/s, what its kernels
   compute at; the ``bound_ms`` of its record) and at 67 TFLOP/s fp32.
   B1's rows path and B5 are also timed at two splits each (``split``
   lines): where their plans split the keys (one sequence, 4 slots)
   against one split, and at the main shapes (one split) against three.
   ``threefry`` lines (the ``rng`` phase, right after the kernel checks):
   the port's own threefry kernel against its plain version, bit for bit,
   for bits, uniforms and bernoulli masks (and keys and split's keys) at
   one key with the executor's two folds (2**25 counters and an odd
   count) and at the sampler's 32 keys (the vocabulary and an odd
   count); the plain version's draws on the card against the CPU's; the
   kernel timed at a train step's dropout site ([64, 256, 512] mask), at
   the sampler's draw ([32, 32000] uniforms) and at a graph-data ResNet
   step's three ``random_data_generator`` draws, beside its plain
   version, its bound (the busier of the INT32 and FP32 pipes, or the
   bytes written) and ``torch.rand`` (Philox: another generator, not this
   function, so no ``library_ms``);
4. serves 64 greedy requests through ``SlotDecodeSession(paged=True)`` at
   the full width of the Transformer-base configuration (6 layers,
   d_model 512, 8 heads, d_inner 2048, vocab 32000, max_length 256;
   random weights from ``set_deterministic_params``), each ``step()``'s
   8 decode steps one captured CUDA graph, with each kernel's launch
   count reset just before and read just after, and checks that the
   paged decode kernel ran n_layer times per decode step and the page
   pool drained. Then (``graph``) the same requests with
   ``FLAGS_cuda_graph=0``, the eager loop: gates on equal streams, equal
   launches, no eager ``run_multi_step`` in the captured run; prints
   tokens/s, host ms per ``step()`` (split into the COW / rebind
   dispatch, the token bookkeeping and the rest), the graphs and their
   pool bytes, and profiles one captured ``step()``. ``prefix``: one
   source admitted 16 times with a 40-token forced prefix through
   ``prefix_cache_pages=8`` and through no cache: equal streams, 15 hits
   in 16 lookups, 480 tokens saved, the pool drained after
   ``clear_prefix_cache()``, admission host ms of a cold admission and a
   hit. ``sampled``: the first 32 requests through the same session with
   ``Sampler("top_k", temperature=0.8, top_k=40, seed=11)``, captured and
   with ``FLAGS_cuda_graph=0``: gates on equal streams and launches, the
   serve phase's launch formulas plus one threefry launch a decode step,
   no eager ``run_multi_step`` in the captured run, streams that are not
   the greedy ones; prints tokens/s of both. Then 16 of them through
   ``steps=1, speculative=3`` sessions (n-gram drafter, same sampler)
   against the sequential sampled stream (``FLAGS_speculative=off``):
   k + 1 threefry launches a verify dispatch, and a request whose stream
   leaves the sequential one fails unless the top-2 margin of the
   sequential path's Gumbel-perturbed logits at that position is below
   1e-3; prints acceptance and tokens committed per dispatch.
   ``dense``: the requests without prefixes through ``paged=False``
   (steps 1): first-step logits within 1e-3 of the paged session's,
   streams against a paged run's (a divergence only at a top-2 margin
   below 1e-3), 2 x n_layer ``flash_fwd`` launches a decode step plus
   n_layer an admission, tokens/s and the caches' bytes;
5. serves 4 requests through the same configuration on the card and on
   the CPU (plain versions) and gates on the first decode step's logits;
   token agreement is printed, not gated;
6. serves the same 64 requests through ``steps=1`` sessions with
   ``speculative=3``: (a) under ``FLAGS_speculative=off`` (the sequential
   oracle, whose streams are recorded), (b) with the n-gram drafter, (c)
   with a replay drafter defined here, which proposes each request's
   recorded continuation with every 4th draft token replaced from a seed
   (random weights give the n-gram drafter next to nothing to accept, and
   no trained weights exist here), and (d) 8 requests with the model
   drafter. Each prints decode tokens/s, wall time, verify dispatches,
   proposed, accepted, acceptance rate and committed tokens per slot per
   dispatch. Gates: every live slot commits 1 to k + 1 tokens per
   dispatch; the tree kernel launches n_layer times per verify dispatch;
   the pool drains; (c) accepts tokens; one verify dispatch fed the
   sequential path's own next k tokens gives logits within 1e-3 of the
   k + 1 sequential steps'; a request whose stream differs from (a)'s
   fails the run only if the sequential path's top-2 logit margin at the
   first differing position exceeds 1e-3 (on the card the two paths sum
   in other orders, and a near-tie may flip an argmax);
7. serves 4 requests speculatively (n-gram drafter) on the card and on the
   CPU and gates on the first verify dispatch's anchor-node logits;
8. trains the same configuration as the JAX package's bench.py does
   (dropout 0.1, label smoothing 0.1, ``Adam(2e-4)``, random_seed 7,
   batch 64 of ragged lengths, fp32): 2 warm-up steps, then 20 steps with
   each kernel's launch count reset just before and read just after. It
   gates on finite losses, a loss that falls by 0.1 nat, 18 launches of
   each backward kernel and 18 of the forward per step (12 with a key
   mask, 6 causal: each attention's forward runs once, and its grad op
   differentiates the forward tape) and no grad op that reran its
   forward, reads each flash kernel's launches by shape class (key mask
   or causal) from the counts its wrapper keeps, and profiles one more
   step (device time by kernel, device busy share). The dropout masks
   are jax's threefry draws: 30 threefry launches a step, gated. Before
   the timed steps a full garbage collection clears the earlier phases'
   garbage and ``gc.freeze()`` sets the survivors aside, as a trainer
   does once it is set up; each step prints its collections by
   generation with their pause, and the caching allocator's device
   mallocs, frees and retries, and the mean step is printed beside the
   mean measured when the masks were torch's Philox draws. Then a
   dropout program (``dropout capture``) at a dropout site's size runs 3
   ``run_multi_step`` calls of 4 steps on a fresh executor, captured (no
   eager call, one graph), against the eager loop on another: losses
   and the trained weight equal bit for bit, one threefry launch a step;
9. trains 3 Adam steps of the same model (dropout 0, batch 4,
   ``set_deterministic_params`` weights) on the card and on the CPU and
   gates on each step's loss; the first step's gradients are compared and
   printed. The CPU starts from a copy of the card's scope after its
   startup program (the CPU's plain threefry draws of the startup would
   take tens of seconds, and the parameters are overwritten anyway);
10. the RNN path. Right after step 3 it holds the LSTM and GRU recurrence
   kernels against their plain versions (the stacked network's shapes at
   widths 512 and 64, the MT encoder's reverse pass, and edge cases: D 40
   and 1100, both sides of each kernel's regime switch, B6's D 1400 and
   B7's narrowest width whose weight slice is read from L2, B 1, 3, 5,
   33 and 300 (a block's rows in several passes), h staged in k-chunks,
   hidden units not a multiple of the units per block, T 1, rows of
   length 0 (for B7 also every row), an initial state, every activation
   code; tolerance 1e-4, relative to max(1, |ref|) where relu or
   identity activations grow the values; each case with its launch
   plan) and times both (B6 also at the MT encoder's shape), with
   ``torch.nn.LSTM`` (cuDNN; the device time of its kernels from a
   profiler trace) beside the LSTM kernel at full lengths without
   peepholes. After step 9 it trains ``stacked_lstm.build``
   (sequence length 80, dictionary 5000, width 512, 3 layers, batch 32,
   lengths 16..80, Adam) on synthetic separable sentiment data for 2 + 20
   steps, gating on finite losses, a 0.1 nat fall, 3 lstm_cell launches
   per step (each layer's forward once: the grad op differentiates the
   forward tape, the backward recomputing through the plain loop) and no
   grad-op rerun, profiles one step, runs the trained model's
   ``clone(for_test=True)`` program 10 times (3 launches per run),
   trains the same network with ``dynamic_gru`` (3 gru_cell launches per
   step), runs 5 steps of the machine-translation graph at ``build()``'s
   defaults (2 lstm_cell launches per step), and compares the stacked
   LSTM's predictions (1e-4) and 3 train losses (1e-3) on the card and
   on the CPU;
11. the predictor: saved programs served through
   ``create_paddle_predictor``. After step 9, (a) the committed
   ``tests/golden/mnist_saved_model`` (written by the JAX package) on the
   card, within 2e-4 / 2e-5 of its ``io_pin.npz`` and 1e-4 of the CPU
   predictor; (b) Transformer-base's ``build_inference`` program
   (``set_deterministic_params`` weights) saved by the port and loaded
   into a ``Predictor``: a batch of 16 sources of lengths 16..256 whose
   logits equal the in-session ``Executor.run``'s and lie within 1e-3
   of the CPU predictor's (first 4 rows), 20 timed runs (ms per run,
   sequences/s, 18 flash_fwd launches a run, counted with every count
   reset just before), one profiled run, the host copy of the logits
   timed four ways, ``run_async(...).result()`` and 4 ``clone()`` threads
   x 5 runs equal to ``run`` (and 18 launches a run counted across the
   threads), 8 greedy positions over the loaded program equal to the
   session's. In step 10, (c) the trained stacked LSTM's and GRU's
   inference programs saved and served through ``NativeConfig`` and
   ``AnalysisConfig`` (the fusion passes): predictions within 1e-5 of
   each other, 3 launches of the cell's kernel a run, predictions/s.
12. the serving plane over the wire, after step 11's RNN predictors.
   First (``C1`` line) a run of ``log`` over a negative feed with
   ``FLAGS_check_nan_inf`` on raises the JAX package's message on the
   card. Then (``frontend`` lines) one ``ServingFrontend`` on 127.0.0.1
   serves the saved stacked LSTM through a ``BatchingServer`` (max batch
   8, 2 workers) and a captured paged ``SlotDecodeSession`` of step 4's
   configuration and weights. 4 client threads send 256 ``predict``
   requests of 1..8 sequences (three quarters of them released when the
   decode loop's capture begins) while 8 client threads stream step 4's
   64 requests, with every kernel's count reset just before. Gates:
   every wire stream equals step 4's in-process stream; ``paged_decode``
   n_layer times a decode step and ``flash_fwd`` by step 4's formula;
   the pool drains; a capture overlapped predict traffic; each
   prediction within 1e-5 of ``run_reference`` on the card; 3
   ``lstm_cell`` launches a dispatched batch, every batch on a ladder
   rung. It prints wire decode tokens/s beside step 4's, time to first
   token and request latency p50/p99, predict requests/s, latency and
   batches by bucket, and the same predict clients alone; then an
   in-band cancel and a dropped client each leave the pool conserved
   (the cancelling connection serves again), a lapsed deadline and an
   unknown method come back typed, and ``health`` / ``stats`` /
   ``metrics`` answer, ``paddle_tpu_frontend_request_seconds`` counting
   every request sent.
13. ``resnet``: ResNet-50 trained as the JAX package's bench.py
   (``resnet_imagenet`` depth 50, 1000 classes, ``Momentum(0.1, 0.9)``,
   fp32, TF32 off, random_seed 5) with one fixed seeded batch of 128
   images 3 x 224 x 224 fed from numpy (its ``BENCH_DATA=host`` branch):
   10 warm-up and 20 timed steps. It prints step ms, images/s, peak
   memory, the device busy share of one profiled step and the share of
   the bound (the program's forward FLOPs x 3 per image at 67 TFLOP/s
   fp32) the step reaches, and gates on finite losses, the mean of the
   last 5 below the first, no grad-op rerun and every batch_norm's moving
   mean changed. The trained model is saved (``io.save_inference_model``)
   and served through ``NativeConfig`` and ``AnalysisConfig`` (whose
   ``fuse_batch_norm`` pass folds every batch norm into its conv):
   predictions within 1e-4, relative to max(1, |y|). Then
   (``resnet graph-data``) the same model with bench.py's default data,
   ``random_data_generator`` drawing the batch on the card, 5 + 10 steps:
   images/s beside the host-fed number, 3 threefry launches a step.
14. ``optim``: the model of step 9, cut to one layer at its widths and
   one sequence a step, with ``GradientClipByGlobalNorm(1.0)`` and
   ``L2Decay`` trained 3 steps on the card and on the CPU with each
   of Momentum, Nesterov Momentum, LarsMomentum, Adagrad, Adamax,
   DecayedAdagrad, Adadelta, RMSProp (plain and centered) and Ftrl, then
   Momentum with ``L1Decay``; the Momentum run also builds a
   ``ModelAverage`` and evaluates the loss after ``apply`` and after
   ``restore``. Gate: every loss on the card within 1e-3 of the CPU's.
   As in step 9, the CPU starts from a copy of the card's initialized
   scope (its persistables after the startup program and the seeded
   parameters), not from a startup program of its own.
15. bf16 mixed precision (AMP), as bench.py trains on the accelerator
   (``rewrite_program_amp(main, "bfloat16")``). Right after step 3's
   timing (``amp_kernels``): the flash kernels' bf16 entries on the bf16
   tensor cores (B1's, ``flash_fwd_bf16``, B2's, ``flash_bwd_dkv_bf16``,
   and B3's, ``flash_bwd_dq_bf16``) against their plain
   versions on the same bf16 tensors, at the train step's three calls,
   the encoder's shape, B1's tile edges and the tensor-core entries'
   own (head dims 32, 96 and 128, T and S apart and off multiples of
   64, GQA with a window and a key mask, dead rows), each case with the
   bf16 entries' plans (dead rows and masked keys exactly 0), within one
   bf16 rounding step of the value (2**-7 of it) plus 1e-4; timed at the
   AMP step's key-mask and causal shapes beside the plain versions and
   ``scaled_dot_product_attention`` in bf16 (forward, and autograd's
   backward), bounds counting bytes at 3.35 TB/s and products at the
   989 TFLOP/s bf16 rate, a product with a float32 operand (P, dS) as
   the two bf16 products of its split. Right after step 8 (``amp
   train``, beside it on the same host state): step 8's Transformer-base
   under AMP on a fresh executor, 2 + 20
   steps, with the same gates (18 launches a step of each bf16 entry,
   none of the float32 ones, 30 threefry, no grad-op rerun, a 0.1 nat
   fall, finite losses) and every floating persistable float32 in the
   scope; mean step ms and decoder tokens/s beside step 8's, peak
   memory, and a profiled step's busy time and matrix-product share
   (each profile also prints the device time of the port's flash
   kernels, ``port kernel`` lines).
   Then ``FLAGS_fused_ce`` on the same step from the same weights and
   dropout keys: 5 losses within 1e-3 (relative) of the composed
   head's, its step ms. After step 9, the AMP model at 2 layers, batch
   4, 3 Adam steps on the card and the CPU from a copy of the card's
   scope: each step's loss within twice the CPU's own AMP-to-fp32 gap,
   or 2**-8 of the loss where that is larger.
16. ``resnet amp``, right after step 13 and before step 14: step 13's
   host-fed ResNet-50 under AMP, 10 + 20
   steps (finite losses that fall, no grad-op rerun, moving means
   changed, float32 persistables), images/s beside step 13's, peak
   memory, the busy share of a profiled step and the share of the bound
   (the forward FLOPs x 3 per image at 989 TFLOP/s bf16); the
   graph-data run under AMP beside step 13's graph-data images/s; and
   the AMP ResNet-50 at 64 x 64, batch 4, one Momentum step on the card
   and the CPU: its predictions and every parameter's gradient, each
   within twice the CPU's own AMP-to-fp32 gap of that tensor (L2), or
   2**-8 of its norm where that is larger.
17. ``switch``, after step 14: Switch-Base-8 (the Switch Transformers
   paper's Switch-Base with 8 experts, at the public google/switch-base-8
   config's widths: 12 layers, 12 heads, d_model 768, d_ff 3072, a
   top-1 MoE FFN in every second layer at capacity factor 1.25,
   vocabulary 32128) as ``models/switch_transformer.py``'s classifier
   (max_length 512, 2 classes, dropout 0.1, ``Adam(1e-4)``, fp32, TF32
   off), one fixed batch of 16 sequences of lengths 256..512: 5 warm-up
   and 20 timed steps with every kernel's count reset just before.
   Gates: finite losses, the mean of the last 5 below the first, 12
   launches a step of each of B1, B2 and B3 (the self-attention's key
   mask takes the flash route), a threefry launch a dropout site, no
   grad-op rerun. Prints non-pad tokens/s, step ms, peak memory, the
   loss and the aux loss at every step, the last step's routing (tokens
   per expert by the pre-drop top-1 choice and the share dropped past
   the capacity, per MoE layer) and a profiled step's busy share.
   The kernel phase (step 3) holds B1, B2 and B3 against their plain
   versions at the step's shape, q/k/v [16,12,512,64] with the key mask,
   and the timing phase times them there (``*_switch`` rows, ``pair
   flash_bwd_switch``). ``switch card vs cpu``: the same widths at 2
   layers, batch 2, one step on the card and the CPU from the same
   parameters: loss, logits and every gradient within 1e-3, and a token
   the two route to different experts fails the run unless its router's
   top-2 margin is below 1e-5 on both. ``cnn``: GoogLeNet (batch 64),
   SE-ResNeXt-50 (64) and AlexNet (128) at 224 x 224 and 1000 classes,
   VGG-16 at its builder's CIFAR-10 shape (32 x 32, 10 classes, 128),
   ``Momentum(0.01, 0.9)``, a fixed batch of class-patterned images, 5 +
   10 steps: images/s, peak memory and a profiled step's busy share per
   model, gated on finite losses that fall and no grad-op rerun. Then
   (``golden`` lines) the goldens of ``tests/golden/`` for ``vgg16``,
   ``googlenet``, ``se_resnext50``, ``alexnet`` and
   ``switch_transformer`` reproduced on the card from their feeds within
   1e-4.

18. The detection slice (SSD), after step 17. ``kernel greedy_nms`` /
   ``kernel det_match`` lines: the port's own detection kernels
   (``csrc/detection.cu``) against their plain versions on the card, bit
   for bit, on synthetic edge cases: ``greedy_nms`` at multiclass_nms's
   eval-head shape (32 images x 20 classes, 400 candidates, thr 0.3),
   with eta 0.9, on pixel boxes, at generate_proposals' test shape (with
   and without eta), at its pre_nms_topN of 6,000 (the shared-memory
   path above 48 KB) and 12,000, and at multiclass_nms's nms_top_k -1 on
   the 28,276 priors (both rows past the shared memory: boxes read from
   device memory), a row with nothing eligible; ``det_match`` at the
   eval head's [32, 200] against 16 gts, with and without difficult gts,
   and at keep_top_k -1's 8,000 detections an image (read from device
   memory). ``ssd``: ``models/ssd.py``'s own backbone (five convolutions,
   32/64/128 channels) and multibox head at SSD300's input size (300 x
   300) and PASCAL VOC's 21 classes (28,276 priors, nms_top_k 400,
   keep_top_k 200), batch 32, 1..8 boxes an image padded to 16, one
   fixed batch, ``Adam(3e-3)``, 5 + 20 steps on a fresh executor:
   images/s, step ms, peak memory, a profiled step's busy share and
   launches, the detection kernels' launches in the train steps
   (reported: the train program holds the eval head, and the executor
   runs every op); gates on finite losses that fall and no grad-op
   rerun; then the eval head on the test clone on another fresh
   executor: Count per image and the mAP (in [0, 1]), both kernels
   launched there (gated), and the eval head's own NMS rows and match
   through the kernels equal to their plain versions; both kernels timed
   on those rows (``time greedy_nms`` / ``time det_match``: graph
   replays, the plain loop eager, bounds counting the IoU tests and
   areas this data needs at the FP32 instruction rate, or the bytes).
   ``ssd card vs cpu``: 2 images at 96 x 96, the dense
   heads within 1e-3, then multiclass_nms and detection_map on the
   card's own boxes and scores on both sides: equal rows and counts, mAP
   within 1e-6. ``sweep`` lines: every detection op type and the twelve
   new loss op types on the card against the CPU at the CPU tests'
   shapes (gradients of the ROI ops and the losses too), within 1e-4,
   selections and threefry draws equal. The goldens gain ``ssd`` (the
   dense location head of the pruned test clone). The timing phase's
   threefry rows gain Switch-Base-8's dropout site, [16, 512, 768].
19. Sequence labelling and OCR, after step 18. ``kernel crf`` lines: the
   port's own CRF kernels (``csrc/crf.cu``: K3 ``crf_logz``, its forward
   entry and its backward entry, the beta recursion; K4 ``crf_viterbi``)
   against their plain versions at the role labeller's emissions [32,
   80, 59] with its batch's lengths and at edge rows (lengths 0, 1 and
   full, 5 tags): alpha, log Z and both gradients within 1e-5 of the
   largest value, the Viterbi paths equal (with tied scores too);
   ``kernel ctc_loss`` lines: K5 (``csrc/ctc.cu``) at CRNN's logits [32,
   64, 96] with its batch's labels, with and without ``norm_by_times``,
   and at edge rows (an empty label, one frame, a label that needs more
   frames than its row has: the JAX op's huge finite loss): loss and
   dLogits within 1e-5 |plain| + 1e-6. B6 and B7 gain cases at the new
   shapes (D 128 with a sigmoid cell and a relu candidate, forward and
   reverse; D 200 with a relu candidate). ``time`` lines: the three
   kernels (both K3 entries), B6 at the role labeller's shape and B7 at
   CRNN's, K5 beside ``F.ctc_loss`` forward and backward. ``srl``: the
   PaddlePaddle book's role labeller (``db_lstm``, depth 8, hidden 512,
   the CoNLL-2005 dictionaries, the CRF, ``chunk_eval`` IOB with 29
   chunk types), batch 32, lengths 5..80, SGD on ``exponential_decay``,
   3 + 10 steps; ``crnn``: CRNN-CTC (``crnn_ctc_model.py``: [1, 48, 512]
   images, 96 classes with the blank, GRU width 200), batch 32,
   ``Momentum`` with L2 decay, 3 + 10 steps: step ms, sentences or
   images a second, peak memory, a profiled step's busy share and
   launches, each kernel's launches a step (gated > 0), grad-op reruns
   (gated 0), losses finite and falling; then each test clone decodes
   the batch: chunk_eval's precision, recall and F1 (gated in [0, 1]),
   the summed edit distance of the greedy decode; the share of a
   role-labeller step that B6's backward (the plain loop's recompute)
   takes. ``nlp card vs cpu``: both models at 2 layers / 2 conv groups
   and batch 4, 3 steps on the card and on the CPU from the same state
   (losses within 1e-4), then the decoders on the card's own emissions
   and logits on both sides: equal paths, chunk counts and edit
   distances. ``nlp`` sweep lines: each of the 22 new op types on the
   card against the CPU at the CPU tests' shapes (gradients too), within
   1e-4, selections and nce's threefry draws equal.
20. Vision, quantization and sequence ops, after step 19 (no hand-written
   kernel on these paths: the JAX package computes them in plain XLA).
   ``vision/quant`` and ``seq`` sweep lines: each of the 29 new op types
   on the card against the CPU at the CPU tests' shapes and at one
   realistic shape each (ResNet-50's stem [128, 64, 112, 112] through
   max_pool2d_with_index and unpool, a spatial transformer's [32, 64, 56,
   56], SPP-net's conv5, a conv input through the fake quantize ops,
   layer4's int8 weight, the sentiment CNN's [128, 600, 128] through the
   sequence ops and both 3- and 4-wide convolutions), values and
   gradients within 1e-5 of the largest value (TF32 off), masks, rank
   tables and quantized values equal (a flipped quantized value fails
   and is counted), the fused sequence ops against their unfused chains.
   ``resnet fp32`` / ``resnet qat``: ResNet-50 at batch 128 x 224^2,
   Momentum as step 13 trains it, first float32 and then with
   ``QuantizeTranspiler(activation_quantize_type="range_abs_max")
   .training_transpile`` before ``minimize`` (104 fake quantize /
   dequantize pairs), 3 + 10 steps each on a fresh executor: step ms
   (mean, min, max), images/s, peak memory, a profiled step's busy share
   and launches (the fake quantize ops' launches as the QAT step's less
   the float32 step's), grad-op reruns gated 0, losses finite and
   falling; then the training-mode forward and the QAT test clone
   pruned and frozen (the snapped weights against the QAT program's
   dequantized ones within 1e-6; the frozen outputs against the QAT
   program's reported beside tests/test_quantize_transpiler.py's 0.15,
   with the share of inputs the test-mode quantizers clip), saved as
   float32, converted to int8 and saved again (the weight
   bytes of both), and served 20 times through ``NativeConfig`` (ms a
   run, outputs within 1e-5 of the frozen program's, relative to the
   largest). ``sentiment``: the PaddlePaddle book's ch. 6
   ``convolution_net`` at its widths (vocabulary 5,148, embedding 128,
   windows 3 and 4 of 512, batch 128 x 600, lengths 16..600,
   Adagrad(0.002)), 3 + 10 steps with the same figures, then saved and
   served 20 times through ``AnalysisConfig`` (the "inference" passes;
   the branches are tanh, so nothing is fused): ms a run, outputs within
   1e-5 of the in-session test run. ``seq/quant card vs cpu``: the
   sentiment CNN at embedding 16, hid 32, T 24 and
   tests/test_quantize_transpiler.py's convnet under QAT (abs_max and
   range_abs_max), 3 steps on the card and the CPU from one state
   (losses within 1e-4), then both frozen and converted to int8 from the
   card's trained state: outputs within 1e-5, int8 tensors equal.
21. Sub-blocks and control flow, after step 20 (B6's check and timing at
   the encoder-decoder's width run with step 10's timings: ``kernel
   lstm_cell lstm_cell_encdec*`` and ``time lstm_cell_encdec*`` lines,
   xw [64, 50, 128], D 32, with peepholes and the batch's source
   lengths, and without peepholes at full lengths beside
   ``torch.nn.LSTM(32, 32)``, against its plain version within 1e-4).
   ``dyn_rnn_lstm``: the book test's DynamicRNN LSTM
   (four fc-sum gates in a ``recurrent`` step; embedding 32, lstm_size
   128) on the sentiment CNN's batch (128 x 600, lengths 16..600),
   Adagrad(0.002), 3 + 5 steps: step ms, sentences/s, peak memory,
   launches, a profiled step's busy share, reruns gated 0, losses
   falling, no host read; its test clone saved and served 20 times
   through ``NativeConfig`` on 8 sentences (ms a run, outputs within 1e-5
   of the executor's). ``encdec``: the book's RNN encoder-decoder
   (dictionary 30,000, words 16, hidden 32; Adagrad(1e-4) with
   L2Decay(0.1)) at batch 64, lengths 10..50, 3 + 5 steps with the same
   figures, B6 gated at one launch a step, its device ms in the
   profiled step. ``book card vs cpu``: one step of each at batch 16
   (dyn_rnn_lstm's sentences cut to 120 words) on the card and on the
   CPU from one state, the loss and every gradient
   within 1e-4 of the largest value. ``control flow``: the programs of
   ``paddle_tpu_torch.testing.control_flow_cases`` (StaticRNN with a
   dropout in the step, DynamicRNN masked (with gradients), a bounded
   While with its gradient, an unbounded While growing a tensor array,
   cond, Switch (three cases and a default), IfElse and
   lod_tensor_to_array and back), each on the card and on the CPU (floats
   within 1e-5, integers equal) with its host reads; then
   ``run_multi_step`` of the bounded While's train program captured
   against ``FLAGS_cuda_graph=0`` (equal, no host read) and the
   unbounded While's and cond's programs refused capture by name.
22. Beam decode. Right after step 7, on step 4's weights:
   ``beam_serve``: ``SlotDecodeSession(beam_width=4)`` at step 4's
   configuration (32 slots: 8 lanes of 4 hypotheses, ``steps=1``, each
   step one captured CUDA graph), with ``proj_logits``' bias at eos
   raised (in a child scope) until eos is among a hypothesis's 4 best
   tokens in 5% of the first 8 steps' (hypothesis, step) pairs, so that
   hypotheses finish and some lanes end early, serves the first 16
   requests, one
   admitted every 3 steps while a lane is free, with every kernel's count
   reset just before: hypothesis and best-hypothesis tokens/s, host ms
   per ``step()``, ``beam_cow_copies``, ``beam_reorder_pages``, B4 and B1
   launches a step, gated at n_layer a step (and B1's admissions and
   prefills); n-bests bos-led, forced prefixes kept, scores descending,
   the pool drained. B4 and B1 held against their plain versions on the
   session's own state 40 steps into 6 beams (hypotheses sharing their
   parents' pages; done hypotheses and the 2 free lanes' slots at length
   0: exactly 0, and at least one such slot), B4 timed there
   (``paged_decode_beam``, its bound counting each shared page once).
   (c) a mid-beam cancel of one hypothesis frees its whole lane; (d)
   ``generate_beam(len_penalty=0.6)`` of one request equals the timed
   run's n-best rescored by ``gnmt_rescore_nbest``; (b) the same
   requests, cut to max_length 64, through a rebind session and under
   ``FLAGS_beam_reorder=reference`` (the copy oracle, whose eager copies
   of every moved hypothesis's pages took 141.6 s at max_length 256)
   give tokens and scores equal bit for bit, the oracle copying pages
   where the rebind run copied none, and (a) in that run each
   dispatch's in-graph selection equals ``beam_step`` replayed on the
   card on its own fetched logits and pre-step state, bit for bit, some
   dispatches holding a done hypothesis beside live ones and some
   leaving the order to the lowest-index tie rule. ``beam_wire``: that
   request through ``ServingFrontend`` and ``ServingClient`` (beam
   chunks, ``beam_end``, ``end``), reassembled equal to (d)'s in-process
   result, n_layer B4 launches a chunk, and a severed beam stream frees
   its lane. ``beam_card_vs_cpu``: the beam session at 2 layers (full
   width otherwise), 2 lanes, max_length 64, on the card and on the CPU
   from one state: scores within 1e-4 where the tokens are equal, else
   the lanes' selections first differ at a step whose lattice margin
   (the K-th less the (K+1)-th candidate, from the CPU's logits) is
   below MARGIN_TOL. After step 10's MT steps, ``mt_beam``:
   ``build_generator`` at its defaults on the weights those steps
   trained, batch 32: ms a run, sentences/s, 2 B6 launches a run; card
   against CPU (``sentence_check``): rows of equal ids have scores
   within 1e-4; a row that differs passes only as a tie: the generator
   stopped after t steps on both sides finds the first step where the
   row's beams differ, and there the two sides' sorted totals are
   within 1e-4; 90% of the rows are equal. After step 21,
   ``book_beam``: the book's ``decoder_decode`` (dictionary 30,000,
   word_dim 16, hidden 32, beam 2, max_length 8, batch 64, seeded
   weights): ``run_multi_step`` captured against ``FLAGS_cuda_graph=0``,
   bit for bit, no host read from the ``While``, 1 B6 launch a call,
   sentences/s; card against CPU by ``sentence_check`` on the per-step
   scores. ``rnn_ops_sweep``: ``dynamic_lstmp`` (peepholes and lengths,
   neither, and [32, 50, 512] with P 64), ``lstm_unit``, ``gru_unit``
   (names and integer codes) and ``row_conv``, forward and gradient,
   card against CPU within 1e-5 of max(1, the largest value).
   Each new phase prints its seconds; the script prints its total.

Every profiler trace (``trace_call``) is held to what ran while it was
taken: each kernel-launch call of the traced call must have its kernel,
and each hand-written kernel as many events as its wrapper counted. The
profiler drops the device events of a trace's first launches, more of
them the longer the process has run, so spin kernels launched ahead of
the call take that loss (``lead_in``, left out of every figure); a trace
that still falls short is taken again with a longer lead-in, and one
that stays short is reported as not measured (``device_ms`` fails).

A line of its own before the last holds the kernels' JSON record (for
flash_fwd, the backward pair, their bf16 entries, paged_decode (full
occupancy and the serving mix of lengths), lstm_cell and threefry also
every timed shape: ms, bound, plain and library ms, and the main path's
launches at that shape, the Switch step's among them; flash_fwd's
predictor runs have a row of their
own, lstm_cell's frontend batches too; the frontend's launches are part
of the serving windows; threefry's record names no TPU kernel and
carries ``other_generator_ms``, torch.rand's time; the bf16 entries'
records carry ``"entry": "bf16"`` and the AMP train steps' launches;
greedy_nms and det_match, the port's own, carry the ssd phase's
launches: its train steps' and its eval head's; crf_logz, crf_logz_bwd
and crf_viterbi the srl phase's, ctc_loss the crnn phase's; lstm_cell
and gru_cell gain a row at the role labeller's and CRNN's shapes,
lstm_cell two at the encoder-decoder's; the beam phases' launches join
flash_fwd's serving rows, paged_decode's ``paged_decode_beam`` row and
lstm_cell's MT and encoder-decoder rows);
the last line is ``{"ok": true, "device": {...}}``. Any failure exits nonzero
before that line. The script needs one CUDA card and the rest of the
repository beside it: without either it fails at once.
"""

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

# the H100 SXM's published peaks (NVIDIA data sheet): device memory rate
# and dense fp32 rate outside the tensor cores, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# fp32 products as split-TF32 on the tensor cores: three TF32 products
# each, at the dense TF32 rate of 495 TFLOP/s (B2 and B3 compute so)
PEAK_TF32X3_FLOPS = 495e12 / 3

# Transformer-base, as the JAX package's bench.py configures it
N_LAYER, N_HEAD, D_MODEL, D_INNER, VOCAB, MAX_LEN = 6, 8, 512, 2048, 32000, 256
NUM_SLOTS, PAGE_SIZE, STEPS, EOS = 32, 16, 8, 0
N_REQUESTS, SEED = 64, 2024
# the prefix phase: one source admitted 16 times with a 40-token forced
# prefix (bos + 40: 2 full pages of 16 and an 8-token tail)
PREFIX_ADMISSIONS, PREFIX_FORCED, PREFIX_CACHE_PAGES = 16, 40, 8

K1_TOL = 1e-4     # fp32 sums over up to 256 keys in another order
K2_TOL = 1e-4
K5_TOL = 1e-4
SPEC_K = 3                 # draft tokens per slot; the tree has SPEC_K + 1 nodes
SPEC_MODEL_REQUESTS = 8    # requests of the model-drafter run
SPEC_LOGITS_TOL = 1e-3     # verify logits against the sequential steps'
MARGIN_TOL = 1e-3          # a top-2 logit margin below this may flip
LOGITS_TOL = 1e-3  # fp32 through 6 layers, card against CPU

# training, as bench.py:240-266 configures Transformer-base
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_SEED = 64, 2, 20, 7
LR, DROPOUT, LABEL_SMOOTH = 2e-4, 0.1, 0.1
TRAIN_TOKEN_IDS = 1000   # tokens drawn from ids 1..1000 of the vocab
LOSS_DROP = 0.1          # nats: mean of steps 16-20 below step 1
# the train step's mean (min, max) in ms on the H100 when its dropout
# masks were torch's Philox draws (PERF.md), printed beside this run's
PHILOX_TRAIN_MS = (257.7, 244.8, 271.6)
CVC_BATCH, CVC_STEPS = 4, 3
TRAIN_LOSS_TOL = 1e-3    # fp32 losses through 6 layers, card against CPU

# the RNN path: stacked_lstm as benchmark/fluid_benchmark.py:139-147 trains
# it (sequence length 80, dictionary 5000, --batch_size 32) at the
# lstm_size / emb_dim 512 of the upstream stacked_dynamic_lstm recipe
RNN_BATCH, RNN_SEQ, RNN_DICT, RNN_HID, RNN_STACK = 32, 80, 5000, 512, 3
RNN_PKG_HID = 64     # the width fluid_benchmark.py --model stacked_lstm runs
RNN_MIN_LEN = 16     # ragged lengths 16..80: the masks are live
RNN_LR = 1e-3
RNN_WARMUP, RNN_STEPS, RNN_INFER_RUNS = 2, 20, 10
MT_BATCH, MT_SEQ, MT_STEPS = 32, 32, 5   # machine_translation.build()
RNN_TOL = 1e-4       # fp32 sums of D terms in another order, over T steps
RNN_CVC_BATCH = 4
RNN_PRED_TOL = 1e-4  # card against CPU stacked-LSTM predictions

# the predictor: saved programs served through create_paddle_predictor
MNIST_DIR = os.path.join(HERE, "tests", "golden", "mnist_saved_model")
PIN_RTOL, PIN_ATOL = 2e-4, 2e-5   # the JAX package's test of the pin
MNIST_CPU_TOL = 1e-4
PRED_BATCH, PRED_RUNS = 16, 20           # Transformer-base inference
PRED_CLONES, PRED_CLONE_RUNS = 4, 5
PRED_FLASH_PER_RUN = 3 * N_LAYER  # encoder self, decoder self, cross
PRED_CVC_ROWS = 4                 # rows held against the CPU predictor
GREEDY_BATCH, GREEDY_STEPS = 4, 8
PRED_FUSED_TOL = 1e-5   # AnalysisConfig against NativeConfig predictions
# stacked-RNN predictor timing: the two configs alternate, PRED_RNN_ROUNDS
# windows of PRED_RNN_RUNS runs each (about a second a config at 3-5 ms a
# run), so the host's spread shows between windows of one config
PRED_RNN_ROUNDS, PRED_RNN_RUNS = 2, 150
# the serving plane over the wire: 8 client threads stream the serve
# phase's requests while 4 more send 256 predict requests of 1..8
# sequences to the saved stacked LSTM (three quarters of them from the
# moment the decode loop's capture begins)
FE_CLIENTS, FE_PREDICT, FE_PREDICT_CLIENTS = 8, 256, 4
FE_PRED_TOL = 1e-5  # batched predictions against run_reference, on the card

# ResNet-50 as bench.py:105-151 trains it, the data fed from numpy
RESNET_DEPTH, RESNET_CLASSES, RESNET_IMG, RESNET_BATCH = 50, 1000, 224, 128
RESNET_LR, RESNET_MOMENTUM, RESNET_SEED = 0.1, 0.9, 5
RESNET_WARMUP, RESNET_STEPS = 10, 20
RESNET_PRED_BATCH = 8
RESNET_PRED_TOL = 1e-4  # AnalysisConfig (batch norms folded) vs Native
# the optimizers against the CPU, on step 9's model cut to one layer at
# its widths and to one sequence a step (the CPU's steps took most of the
# phase; the update rules are the same at any depth or batch); the CPU
# starts from the card's initialized scope: its startup draws nothing
OPTIM_LAYERS, OPTIM_BATCH = 1, 1
OPTIM_CLIP, OPTIM_L2, OPTIM_L1 = 1.0, 1e-4, 1e-4
OPTIM_AVG_RATE = 0.15

# the threefry kernel (the port's own). Its bound takes the busier of two
# pipes that issue side by side: integer operations at the H100 SXM's
# INT32 rate (64 lanes an SM on 132 SMs at the 1.98 GHz boost clock that
# the 67 TFLOP/s fp32 rate assumes) and float operations at the FP32 rate
# (128 lanes an SM). A hash is 2 + 20 x 3 + 5 x 2 = 72 integer
# operations less 5 where a key injection's add into x0 fuses with the
# next round's (IADD3): 67. The draw adds the xor of the two words, and
# for a float the shift and the or; on the FP32 pipe the uniform's
# subtract, multiply-add and max, or the bernoulli's subtract and compare.
PEAK_INT32_OPS = 132 * 64 * 1.98e9
PEAK_FP32_OPS = 132 * 128 * 1.98e9   # instructions (an FMA is one)
THREEFRY_HASH_OPS = 67
THREEFRY_MODE_OPS = {"bits": (1, 0), "uniform": (3, 3),
                     "bernoulli": (3, 2)}  # (integer, float) a value
RNG_BIG_N = 1 << 25          # the largest draw held against the plain version
DROPOUT_SITE = (TRAIN_BATCH, MAX_LEN, D_MODEL)  # one dropout of the train step
# sampled serving: the serve phase's configuration with a top-k sampler
SAMPLED = dict(strategy="top_k", temperature=0.8, top_k=40, seed=11)
SAMPLED_REQUESTS, SAMPLED_SPEC_REQUESTS = 32, 16
# a dropout program under run_multi_step, captured against the eager loop
DROP_CAPTURE_STEPS, DROP_CAPTURE_CALLS = 4, 3
# ResNet-50 with bench.py's default in-graph random_data_generator
RESNET_GRAPH_WARMUP, RESNET_GRAPH_STEPS = 5, 10

# bf16 mixed precision (AMP) as bench.py trains on the accelerator
# (BENCH_AMP on: rewrite_program_amp(main, "bfloat16"), bench.py:152-153,
# 267-268, 786)
PEAK_BF16_FLOPS = 989e12   # dense bf16 on the tensor cores, H100 SXM
# a bf16 output of a kernel's bf16 entry against its plain version: both
# compute in float32 and round once, so one bf16 rounding step of the
# value (2**-7 of it) on top of the float32 entries' K1_TOL
BF16_REL = 2.0 ** -7
# AMP losses, card against CPU: within twice the CPU's own gap between
# its AMP and float32 losses, or 2**-8 of the loss where that is larger
# (bf16 rounds at other places on the two devices: cuBLAS / cuDNN against
# the CPU's kernels; tests/test_torch_amp.py holds the port to the JAX
# package by the same rule)
AMP_GAP_FACTOR, AMP_LOSS_FLOOR = 2.0, 2.0 ** -8
AMP_CVC_LAYERS = 2         # the AMP card-against-CPU Transformer's depth
# FLAGS_fused_ce: steps of the fused head against the composed head's
# (same weights, same dropout keys), losses within this, relative
AMP_FUSED_STEPS, AMP_FUSED_TOL = 5, 1e-3
# the AMP ResNet-50 card-against-CPU run: a fixed batch, at 64 x 64
RESNET_CVC_IMG, RESNET_CVC_BATCH, RESNET_CVC_STEPS = 64, 4, 3
# Switch-Base-8: the Switch Transformers paper's Switch-Base with 8
# experts, at the widths of the public google/switch-base-8 config
# (12 layers, 12 heads, d_model 768, d_ff 3072, vocabulary 32128, a MoE
# FFN in every second layer, capacity factor 1.25), as
# models/switch_transformer.py's classifier: 2 classes, max_length 512
SW_LAYERS, SW_HEADS, SW_D, SW_INNER = 12, 12, 768, 3072
SW_EXPERTS, SW_TOP_K, SW_EVERY = 8, 1, 2
SW_CAPACITY = 1.25     # moe_ffn's default, which the builder keeps
SW_VOCAB, SW_LEN, SW_CLASSES, SW_DROPOUT = 32128, 512, 2, 0.1
SW_BATCH, SW_MIN_LEN, SW_LR, SW_SEED = 16, 256, 1e-4, 13
SW_WARMUP, SW_STEPS = 5, 20
# card against CPU: the same widths, 2 layers (one MoE), batch 2
SW_CVC_LAYERS, SW_CVC_BATCH = 2, 2
SW_CVC_TOL = 1e-3      # fp32 loss, logits and gradients, card against CPU
SW_MARGIN_TOL = 1e-5   # a router top-2 margin below this may flip
# the conv model zoo: (model, image, classes, batch), Momentum, a fixed
# batch fed from numpy
CNNS = [("googlenet", (3, 224, 224), 1000, 64),
        ("se_resnext50", (3, 224, 224), 1000, 64),
        ("alexnet", (3, 224, 224), 1000, 128),
        ("vgg16", (3, 32, 32), 10, 128)]   # its builder's CIFAR-10 shape
CNN_LR, CNN_MOMENTUM, CNN_SEED = 0.01, 0.9, 9
CNN_WARMUP, CNN_STEPS = 5, 10
GOLDEN_TOL = 1e-4      # the card's output against the JAX package's golden
# SSD as models/ssd.py builds it (its own five-convolution backbone, not
# SSD300's VGG-16), at SSD300's input size and PASCAL VOC's 21 classes
# (Liu et al., "SSD: Single Shot MultiBox Detector", 2016): the model's
# multibox head, 28,276 priors;
# detection_output's nms_top_k 400 and keep_top_k 200. Batch 32, 1..8
# ground-truth boxes an image padded to 16, Adam(3e-3) as
# tests/test_detection.py trains the model
SSD_IMG, SSD_CLASSES, SSD_MAX_GT, SSD_KEEP = 300, 21, 16, 200
SSD_NMS_TOP_K, SSD_NMS_THR = 400, 0.3   # detection_output's defaults
SSD_PRIORS = 28276     # models/ssd.py's prior boxes at 300 x 300
SSD_BATCH, SSD_MAX_BOXES, SSD_LR, SSD_SEED = 32, 8, 3e-3, 19
SSD_WARMUP, SSD_STEPS = 5, 20
# card against CPU: 2 images at 96 x 96, the dense heads within this
SSD_CVC_IMG, SSD_CVC_BATCH, SSD_CVC_TOL = 96, 2, 1e-3
SWEEP_TOL = 1e-4       # the detection and loss ops, card against CPU
# the role labeller of the PaddlePaddle book, ch. 7 (label_semantic_roles,
# the db_lstm network) at the book's widths: CoNLL-2005's dictionaries
# (44,068 words, 3,162 predicates, 59 labels), word_dim 32, mark_dim 5,
# hidden_dim 512 (dynamic_lstm size 512: D 128), depth 8; SGD on
# exponential_decay(0.01, 100000, 0.5, staircase=True); batch 32,
# lengths 5..80 padded to 80
SRL_BATCH, SRL_LEN, SRL_MIN_LEN, SRL_DEPTH, SRL_HIDDEN = 32, 80, 5, 8, 512
SRL_LABELS, SRL_LR, SRL_SEED = 59, (0.01, 100000, 0.5), 23
# CRNN-CTC as PaddlePaddle/models fluid/ocr_recognition crnn_ctc_model.py
# builds it: gray [1, 48, 512] images, 95 classes and the blank, conv
# groups of 16, 32, 64 and 128 channels, GRU width 200; Momentum(1e-3,
# 0.9) with L2 decay 4e-4; batch 32, labels of 4..24 characters
CRNN_BATCH, CRNN_IMG, CRNN_CLASSES, CRNN_RNN = 32, (1, 48, 512), 95, 200
CRNN_CHANNELS, CRNN_MAX_LABEL, CRNN_MIN_LABEL = (16, 32, 64, 128), 24, 4
CRNN_LR, CRNN_MOMENTUM, CRNN_L2, CRNN_SEED = 1e-3, 0.9, 4e-4, 29
NLP_WARMUP, NLP_STEPS = 3, 10
# what a step of each model trained through nlp_train takes in
NLP_UNITS = {"srl": "sentences", "crnn": "images", "resnet fp32": "images",
             "resnet qat": "images", "sentiment": "sentences",
             "dyn_rnn_lstm": "sentences", "encdec": "sentence pairs"}
# K3 against its plain version: fp32 log-sum-exps in another order, over
# up to 80 steps, relative to the largest value
CRF_TOL = 1e-5
# K5 against its plain version: |kernel - plain| <= CTC_RTOL |plain| +
# CTC_ATOL, loss and dLogits
CTC_RTOL, CTC_ATOL = 1e-5, 1e-6
# card against CPU: both models at 2 layers / 2 conv groups, batch 4
NLP_CVC_BATCH, NLP_CVC_STEPS, NLP_CVC_TOL = 4, 3, 1e-4
# the op types this slice adds, each run by the nlp sweep
NLP_OP_TYPES = (
    "linear_chain_crf", "crf_decoding", "warpctc", "ctc_align",
    "edit_distance", "chunk_eval", "auc", "precision_recall", "mean_iou",
    "positive_negative_pair", "nce", "hierarchical_sigmoid", "im2sequence",
    "depthwise_conv2d", "depthwise_conv2d_transpose", "conv3d",
    "conv2d_transpose", "conv3d_transpose", "pool3d", "group_norm",
    "bilinear_interp", "nearest_interp")
# the greedy NMS's and the match's IoU, at the FP32 instruction rate: a
# test is the overlap's width and height (min, max, subtract, offset,
# clamp: 2 x 5), its product, the union (add, subtract), its clamp, the
# divide and the compare; a box's area (2 x (subtract, offset, clamp)
# and a product) is computed once, not in every test
IOU_TEST_OPS, AREA_OPS = 16, 7
# vision, quantization and sequence ops (step 20): the op types the
# sweeps must run, each within VQ_SWEEP_TOL of the largest |value| of its
# output, card against CPU (quantized values equal)
VISION_QUANT_OP_TYPES = (
    "affine_channel", "affine_grid", "grid_sampler", "max_pool2d_with_index",
    "max_pool3d_with_index", "unpool", "spp", "fake_quantize_abs_max",
    "fake_quantize_range_abs_max", "fake_dequantize_max_abs",
    "dequantize_weight")
SEQ_OP_TYPES = (
    "sequence_softmax", "sequence_reverse", "sequence_expand",
    "sequence_conv", "sequence_concat", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_slice", "sequence_erase",
    "sequence_enumerate", "sequence_scatter", "sequence_reshape",
    "lod_reset", "lod_rank_table", "reorder_lod_tensor_by_rank",
    "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc")
VQ_SWEEP_TOL, QUANT_SEED = 1e-5, 31
# QAT ResNet-50: tests/test_quantize_transpiler.py's tolerance for the
# frozen program's outputs against the QAT program's (printed beside the
# ResNet's, which is reported); the int8 model's against the frozen
# program's relative to the largest value
QAT_FREEZE_TOL, QAT_PRED_TOL, QAT_PRED_RUNS = 0.15, 1e-5, 20
# the snapped weights against the QAT program's dequantized ones (two
# roundings of the same grid value), relative to the largest
QAT_SNAP_TOL = 1e-6
# the sentiment classifier of the PaddlePaddle book, ch. 6
# (understand_sentiment, convolution_net) at the book's widths: the IMDB
# word_dict() at its cutoff of 150 (5,148 ids), embedding 128, hid_dim 512,
# windows 3 and 4, 2 classes, batch 128, Adagrad(0.002); lengths 16..600
# padded to 600
SENT_BATCH, SENT_LEN, SENT_MIN_LEN, SENT_EMB, SENT_HID = 128, 600, 16, 128, 512
SENT_SEED, SENT_PRED_RUNS, SENT_PRED_TOL = 37, 20, 1e-5
# card against CPU at small size: 3 steps, losses within this
SEQ_CVC_STEPS, SEQ_CVC_TOL = 3, 1e-4
# step 21: the book's DynamicRNN sentiment LSTM (dyn_rnn_lstm: embedding
# 32, lstm_size 128) on the sentiment CNN's batches (SENT_*), and the
# book's RNN encoder-decoder (dictionary 30,000, words 16, hidden 32,
# Adagrad(1e-4) with L2Decay(0.1)) at batch 64, source and target
# lengths 10..50; 3 warm-up and 5 timed steps each on a fresh executor
BOOK_WARMUP, BOOK_STEPS = 3, 5
ED_BATCH, ED_LEN, ED_MIN_LEN, ED_SEED = 64, 50, 10, 43
# dyn_rnn_lstm's test clone served through a Predictor: runs, sentences a
# run, outputs against the executor's
BOOK_PRED_RUNS, BOOK_PRED_BATCH, BOOK_PRED_TOL = 20, 8, 1e-5
# one step of each model on the card and on the CPU from one state, at
# this batch (dyn_rnn_lstm's sentences cut to BOOK_CVC_LEN words: the
# CPU's step is its 35 ops a word): the loss and every gradient within
# BOOK_CVC_TOL of the largest value
BOOK_CVC_BATCH, BOOK_CVC_LEN, BOOK_CVC_TOL = 16, 120, 1e-4
# the control-flow sweep, card against CPU: floats within this, integers
# equal
CF_TOL = 1e-5
# step 22: beam decode. beam_serve: the serve phase's configuration with
# 4 hypotheses a lane (8 lanes), one decode step a step(), 16 requests
# admitted one every 3 steps while a lane is free; n-bests rescored with
# the GNMT length penalty 0.6 (bench.py's beam default)
BEAM_K, BEAM_REQUESTS, BEAM_STAGGER, BEAM_LEN_PENALTY = 4, 16, 3, 0.6
BEAM_WIRE_REQUEST = 3  # the request of (d) and of the wire phase
# B4 and B1 held and B4 timed this far into 6 beams (2 lanes free)
BEAM_TRAFFIC_STEPS, BEAM_TRAFFIC_LANES = 40, 6
# proj_logits' bias at eos raised so that eos is among a hypothesis's K
# best tokens in this share of the (hypothesis, step) pairs of the first
# BEAM_EOS_PROBE steps (random weights never rank it there)
BEAM_EOS_SHARE, BEAM_EOS_PROBE = 0.05, 8
LOGITS_BIAS = "proj_logits.w_1"  # the output projection's bias [VOCAB]
BEAM_ORACLE_LEN = 64     # the max_length of (a) and (b)
# card against CPU: 2 layers at full width otherwise, 2 lanes, max_length
# 64 (the CPU's steps at full width); scores within this
BEAM_CVC_LAYERS, BEAM_CVC_LANES, BEAM_CVC_LEN = 2, 2, 64
BEAM_SCORE_TOL = 1e-4
BEAM_EQUAL_SHARE = 0.9  # of the n-best rows equal card against CPU
MT_BEAM_RUNS = 5       # build_generator runs timed on the card
# the book's decoder_decode: beam 2, max_length 8 and end id 10 as the
# book test decodes, batch 64
BOOK_BEAM_K, BOOK_BEAM_LEN, BOOK_END_ID = 2, 8, 10
BOOK_BEAM_BATCH, BOOK_BEAM_RUNS = 64, 5
RNN_OPS_TOL = 1e-5     # relative to max(1, the largest value)
# the names of matrix-product kernels in a profile (cuBLAS's GEMMs and
# cuDNN's implicit-GEMM convolutions)
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def kernel_symbol(line):
    """A kernel's name and template arguments from a ptxas "Compiling
    entry function '<mangled>'" line (lstm_cell_kernel<4, true, true>):
    the mangled name's parts, each a length and that many characters,
    read in turn to the first that ends in ``_kernel``."""
    import re

    m = re.search(r"'_ZN?", line)
    pos = m.end() if m else len(line)
    while True:
        n = re.match(r"\d+", line[pos:])
        if not n:
            return line.strip()[:120]
        start = pos + n.end()
        pos = start + int(n.group(0))
        name = line[start:pos]
        if name.endswith("_kernel"):
            break
    tmpl = re.match(r"I((?:L[ib]\d+E)*)E", line[pos:])
    args = re.findall(r"L([ib])(\d+)E", tmpl.group(1)) if tmpl else []
    shown = ", ".join(v if t == "i" else ("true" if v == "1" else "false")
                      for t, v in args)
    return "%s<%s>" % (name, shown) if shown else name


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, inputs, iters=30, reps=5):
    """Device milliseconds per call of ``fn(**inputs[i])``. The calls are
    captured in one CUDA graph, so the host's launch cost (Python, the
    wrapper's checks, ctypes) is out of the time, and they cycle through
    ``inputs``: copies whose total exceeds the 50 MB L2 cache, so each
    call reads its operands from device memory as on the serving path.
    CUDA events around ``reps`` replays, after one warm-up replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for kw in inputs:  # lazy set-up (library load, workspaces)
            fn(**kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(**inputs[i % len(inputs)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def copies(kw, n=3):
    """``n`` independent copies of a case's tensors (the first is the case
    itself)."""
    import torch

    return [kw] + [{k: v.clone() if isinstance(v, torch.Tensor) else v
                    for k, v in kw.items()} for _ in range(n - 1)]


def eager_ms(fn, inputs, iters=30):
    """Device milliseconds per call of ``fn(i)`` from CUDA events around
    ``iters`` eager calls that cycle through ``len(inputs)`` copies, after
    one warm-up call on each. For calls whose device time is far above
    their host launch cost (the host then runs ahead of the card), where
    a CUDA graph cannot hold the call."""
    import torch

    for i in range(len(inputs)):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for j in range(iters):
        fn(j % len(inputs))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The kernel-launch calls (cudaLaunch*, cuLaunch*) a trace records.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
# A hand-written kernel's symbols in a trace, where they are not its name
# followed by ``_kernel``.
KERNEL_SYMBOLS = {"flash_fwd": ("flash_fwd_rows_kernel",
                                "flash_fwd_tiled_kernel"),
                  "ctc_loss": ("ctc_kernel",)}
# Host ms of spin kernels launched ahead of the traced call, one entry
# per try (``trace_call``), and the name of the call's own range.
TRACE_LEAD_IN_MS = (250.0, 1000.0, 3000.0)
TRACE_MARK = "chip_smoke.traced_call"


def trace_symbol(name):
    """A device event's kernel name without its return type, namespace,
    template and parameters."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("<")[0].split("(")[0].strip()
    return head.split("::")[-1].split(" ")[-1]


def lead_in(torch, ms):
    """Tiny spin kernels (``torch.cuda._sleep``), one every 0.1 ms for
    ``ms`` of host time, launched at the head of a trace: the profiler
    drops the device events of a trace's first launches, more of them
    the longer the process has run, and these take that loss instead of
    the traced call."""
    end = time.perf_counter() + ms / 1e3
    while time.perf_counter() < end:
        torch.cuda._sleep(100)
        time.sleep(1e-4)


def traced_kernels(prof):
    """The device entries of ``prof.key_averages()`` with device time,
    but ``lead_in``'s spin kernels and the device side of the
    ``TRACE_MARK`` range."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key != TRACE_MARK
            and trace_symbol(e.key) != "spin_kernel"]


def trace_gaps(prof, counted):
    """What a trace lacks of what was launched in its ``TRACE_MARK``
    range: the kernel-launch calls (``LAUNCH_CALLS``) there with no
    device event of the same CUPTI correlation id, and the hand-written
    kernels whose wrappers counted more launches (``counted``: {name:
    n}) than the trace holds events of their symbols. Returns {"calls",
    "lost" (the calls without their kernel: (name, its place among the
    calls)), "short" ({kernel: (counted, traced)}), "lag_ms" (the least
    and the median time from a launch call to its kernel's start:
    negative where the trace maps the device's clock early)}."""
    from torch.autograd import DeviceType

    events = prof.events()
    since = min([e.time_range.start for e in events if e.name == TRACE_MARK
                 and e.device_type == DeviceType.CPU] or [0.0])
    launched, started, symbols = [], {}, {}
    for e in events:
        if e.name == TRACE_MARK:
            continue
        if e.device_type == DeviceType.CUDA:
            t = e.time_range.start
            started[e.id] = min(started.get(e.id, t), t)
            sym = trace_symbol(e.name)
            symbols[sym] = symbols.get(sym, 0) + 1
        elif e.name in LAUNCH_CALLS and e.time_range.start >= since:
            launched.append((e.time_range.start, e.id, e.name))
    launched.sort()
    lost = [(name, k) for k, (_, i, name) in enumerate(launched)
            if i not in started]
    lags = sorted(started[i] - t for t, i, _ in launched if i in started)
    short = {}
    for name, n in counted.items():
        got = sum(symbols.get(sym, 0)
                  for sym in KERNEL_SYMBOLS.get(name, (name + "_kernel",)))
        if got < n:
            short[name] = (n, got)
    nan = float("nan")
    return dict(calls=len(launched), lost=lost, short=short,
                lag_ms=(lags[0] / 1e3 if lags else nan,
                        lags[len(lags) // 2] / 1e3 if lags else nan))


def trace_call(torch, label, fn):
    """``fn()`` under torch.profiler, in a ``TRACE_MARK`` range after a
    ``lead_in``, held to what it launched (``trace_gaps``, with the
    launch counts ``fn`` added to the wrappers' handles). A trace that
    lacks a kernel is taken again with the next of
    ``TRACE_LEAD_IN_MS``; each try prints its ``trace`` line (launch
    calls, those without their kernel, short counts, the least and
    median launch-to-start times). Returns (the profile, ``fn``'s wall
    ms), or None (every number of it not measured) when the last try
    still lacks some."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.kernels import KERNELS

    for lead_ms in TRACE_LEAD_IN_MS:
        before = {n: k.launches for n, k in KERNELS.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_in(torch, lead_ms)
            with record_function(TRACE_MARK):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        counted = {n: k.launches - before[n] for n, k in KERNELS.items()
                   if k.launches > before[n]}
        gaps = trace_gaps(prof, counted)
        print("%s trace: %d kernel-launch calls, %d without their kernel%s; "
              "hand-written kernels short %s; launch to start least %.3f "
              "ms, median %.3f; lead-in %.0f ms"
              % (label, gaps["calls"], len(gaps["lost"]),
                 " (%s)" % ", ".join("%s, call %d" % c
                                     for c in gaps["lost"][:4])
                 if gaps["lost"] else "", gaps["short"] or "none",
                 gaps["lag_ms"][0], gaps["lag_ms"][1], lead_ms))
        if not gaps["lost"] and not gaps["short"]:
            return prof, wall_ms
    print("%s trace: still incomplete after %d tries (not measured)"
          % (label, len(TRACE_LEAD_IN_MS)))
    return None


def device_ms(torch, fn, inputs, iters=10):
    """Device milliseconds per call of ``fn(i)``: the time of its kernels,
    summed from a torch.profiler trace (``trace_call``) of ``iters``
    calls cycling through ``inputs`` (after one warm-up call on each), so
    the host's launch cost does not enter it. For a library call with
    many launches that a CUDA graph may not hold (cuDNN's LSTM,
    autograd's backward of ``scaled_dot_product_attention``). A trace
    that stays incomplete, or holds no device time, fails the run rather
    than report a time short of the truth."""
    for i in range(len(inputs)):
        fn(i)
    traced = trace_call(torch, "device_ms", lambda: [
        fn(j % len(inputs)) for j in range(iters)])
    if traced is None:
        fail("device_ms: the profiler's trace lacks kernels that ran")
    busy_us = sum(e.self_device_time_total
                  for e in traced_kernels(traced[0]))
    if not busy_us > 0:
        fail("device_ms: the profiler's trace holds no device time")
    return busy_us / 1e3 / iters


def bound(nbytes, flops, peak_flops=PEAK_FP32_FLOPS):
    """(least ms on the card, what bounds it), the operations at
    ``peak_flops``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_decode_bound(lengths, dh):
    """``bound`` of one ``paged_decode`` call at these lengths (N_HEAD
    heads, PAGE_SIZE pages): the K and V rows below each slot's length
    (the kernel clips its copies there, not at the page's end), the
    query and output rows, the table entries of the resident pages and
    the lengths; two flops a key and element for the scores and two for
    the weighted sum."""
    tokens = sum(lengths)
    pages = sum(-(-n // PAGE_SIZE) for n in lengths)
    nbytes = (2 * 4 * N_HEAD * dh * tokens
              + 2 * 4 * len(lengths) * N_HEAD * dh
              + 8 * pages + 8 * len(lengths))
    return bound(nbytes, 4.0 * tokens * N_HEAD * dh)


def paged_decode_shared_bound(lengths, table, dh):
    """``paged_decode_bound`` where slots share pages (a beam lane's
    hypotheses share their parents' prefix pages): the K and V rows of
    each distinct page once, as many as the slot that reads most of it
    reads, then the query and output rows, each slot's table entries
    and the lengths; the operations of every slot over its own rows.
    The kernel does not exploit the sharing: each slot's blocks read
    their pages again."""
    rows, refs = {}, 0
    for s, n in enumerate(lengths):
        for i in range(-(-n // PAGE_SIZE)):
            p = int(table[s][i])
            rows[p] = max(rows.get(p, 0), min(PAGE_SIZE, n - i * PAGE_SIZE))
            refs += 1
    nbytes = (2 * 4 * N_HEAD * dh * sum(rows.values())
              + 2 * 4 * len(lengths) * N_HEAD * dh
              + 8 * refs + 8 * len(lengths))
    return bound(nbytes, 4.0 * sum(lengths) * N_HEAD * dh)


def tree_decode_bound(bases, N, dh):
    """``bound`` of one ``tree_decode`` call at these bases (N nodes,
    N_HEAD heads, PAGE_SIZE pages, max_length MAX_LEN): the K and V rows
    below each live slot's scan, min(base + N, MAX_LEN) (the kernel
    clips its copies there), the N query and output rows of every slot,
    the node masks, the table entries of the pages read and the bases;
    four flops a key, node and element."""
    scan = [min(b + N, MAX_LEN) if b >= 0 else 0 for b in bases]
    pages = sum(-(-n // PAGE_SIZE) for n in scan)
    S = len(bases)
    nbytes = (2 * 4 * N_HEAD * dh * sum(scan) + 2 * 4 * S * N_HEAD * N * dh
              + 8 * S * N * N + 8 * pages + 8 * S)
    return bound(nbytes, 4.0 * N * sum(scan) * N_HEAD * dh)


# -- kernel phase ---------------------------------------------------------------


def flash_cases(torch, gen):
    """(name, kwargs for flash_forward) at the serving shapes and edges."""
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def mask(lengths, S):
        m = torch.zeros(len(lengths), S, device=dev)
        for b, n in enumerate(lengths):
            m[b, :n] = 1.0
        return m

    src_lens = torch.randint(16, 257, (NUM_SLOTS,), generator=gen,
                             device=dev).tolist()
    dh = D_MODEL // N_HEAD
    return [
        ("decode_cross_T1", dict(
            q=rnd(NUM_SLOTS, N_HEAD, 1, dh), k=rnd(NUM_SLOTS, N_HEAD, 256, dh),
            v=rnd(NUM_SLOTS, N_HEAD, 256, dh), kv_mask=mask(src_lens, 256))),
        ("verify_cross_T4", dict(
            q=rnd(NUM_SLOTS, N_HEAD, SPEC_K + 1, dh),
            k=rnd(NUM_SLOTS, N_HEAD, 256, dh),
            v=rnd(NUM_SLOTS, N_HEAD, 256, dh), kv_mask=mask(src_lens, 256))),
        ("encoder_masked", dict(
            q=rnd(1, N_HEAD, 256, dh), k=rnd(1, N_HEAD, 256, dh),
            v=rnd(1, N_HEAD, 256, dh), kv_mask=mask([197], 256))),
        ("prefill_causal", dict(
            q=rnd(1, N_HEAD, 256, dh), k=rnd(1, N_HEAD, 256, dh),
            v=rnd(1, N_HEAD, 256, dh), causal=True)),
        ("ragged_mask", dict(
            q=rnd(3, 4, 77, 64), k=rnd(3, 4, 77, 64), v=rnd(3, 4, 77, 64),
            kv_mask=mask([77, 40, 3], 77))),
        ("kv_group_2", dict(
            q=rnd(2, 8, 100, 64), k=rnd(2, 4, 100, 64), v=rnd(2, 4, 100, 64),
            kv_group=2, causal=True)),
        ("window_causal", dict(
            q=rnd(2, 4, 100, 64), k=rnd(2, 4, 100, 64), v=rnd(2, 4, 100, 64),
            causal=True, window=16)),
        ("window_bidirectional", dict(
            q=rnd(2, 4, 100, 64), k=rnd(2, 4, 100, 64), v=rnd(2, 4, 100, 64),
            window=16, kv_mask=mask([100, 61], 100))),
        ("dead_row", dict(
            q=rnd(2, 4, 33, 64), k=rnd(2, 4, 33, 64), v=rnd(2, 4, 33, 64),
            kv_mask=mask([0, 20], 33))),
        ("head_dim_128_T1", dict(
            q=rnd(5, 2, 1, 128), k=rnd(5, 2, 70, 128), v=rnd(5, 2, 70, 128),
            kv_mask=mask([70, 1, 35, 64, 2], 70))),
        ("head_dim_40", dict(
            q=rnd(2, 3, 45, 40), k=rnd(2, 3, 45, 40), v=rnd(2, 3, 45, 40),
            causal=True)),
    ] + flash_rows_cases(torch)


def flash_rows_cases(torch):
    """(name, kwargs for flash_forward): the edges of B1's split rows path
    (T <= 4), from a generator of their own (the cases above, and what
    the timing phase draws after them, keep their inputs): causal decode
    (row 0 sees key 0 only), one- and two-sided windows at T 3, GQA at T
    4, S 77 with a slot whose only valid keys lie in the last chunk, a
    slot with every key masked, S 1, head dim 33 (4-byte copies) and K/V
    off 16-byte alignment."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def spans(S, *rows):
        """A [len(rows), S] key mask: row b keeps keys lo..hi - 1 of each
        (lo, hi) in rows[b]."""
        m = torch.zeros(len(rows), S, device=dev)
        for b, row in enumerate(rows):
            for lo, hi in row:
                m[b, lo:hi] = 1.0
        return m

    def unaligned(*shape):
        return rnd(torch.Size(shape).numel() + 1)[1:].view(*shape)

    dh = D_MODEL // N_HEAD
    return [
        ("decode_causal_T1", dict(
            q=rnd(4, N_HEAD, 1, dh), k=rnd(4, N_HEAD, 256, dh),
            v=rnd(4, N_HEAD, 256, dh), causal=True,
            kv_mask=spans(256, [(0, 256)], [(0, 100)], [(1, 256)],
                          [(0, 40)]))),
        ("verify_window_T3", dict(
            q=rnd(4, 4, 3, dh), k=rnd(4, 4, 200, dh), v=rnd(4, 4, 200, dh),
            causal=True, window=2,
            kv_mask=spans(200, [(0, 200)], [(0, 1)], [(2, 200)],
                          [(0, 150)]))),
        ("verify_window_T3_two_sided", dict(
            q=rnd(4, 4, 3, dh), k=rnd(4, 4, 200, dh), v=rnd(4, 4, 200, dh),
            window=40,
            kv_mask=spans(200, [(0, 200)], [(30, 60)], [(45, 200)],
                          [(0, 20)]))),
        ("kv_group_2_T4", dict(
            q=rnd(4, 8, 4, dh), k=rnd(4, 4, 256, dh), v=rnd(4, 4, 256, dh),
            kv_group=2,
            kv_mask=spans(256, [(0, 256)], [(0, 33)], [(100, 131)],
                          [(250, 256)]))),
        ("S77_last_chunk_only", dict(
            q=rnd(3, 4, 2, dh), k=rnd(3, 4, 77, dh), v=rnd(3, 4, 77, dh),
            kv_mask=spans(77, [(64, 77)], [(0, 77)], [(76, 77)]))),
        ("slot_all_masked", dict(
            q=rnd(3, 4, 4, dh), k=rnd(3, 4, 100, dh), v=rnd(3, 4, 100, dh),
            kv_mask=spans(100, [(0, 100)], [], [(0, 7)]))),
        ("S1", dict(
            q=rnd(5, 4, 4, dh), k=rnd(5, 4, 1, dh), v=rnd(5, 4, 1, dh),
            kv_mask=spans(1, [(0, 1)], [], [(0, 1)], [(0, 1)], []))),
        ("head_dim_33_T4", dict(
            q=rnd(3, 2, 4, 33), k=rnd(3, 2, 90, 33), v=rnd(3, 2, 90, 33),
            kv_mask=spans(90, [(0, 90)], [(10, 50)], [(89, 90)]))),
        ("unaligned_kv_T1", dict(
            q=rnd(4, 4, 1, dh), k=unaligned(4, 4, 130, dh),
            v=unaligned(4, 4, 130, dh),
            kv_mask=spans(130, [(0, 130)], [(0, 64)], [(65, 130)], []))),
    ]


def flash_tile_cases(torch, gen):
    """(name, kwargs for flash_forward) for B1's multi-row tiles (T > 4):
    the first 32- and 64-row tiles, T and S off multiples of 64, a key
    mask with an all-zero 64-key tile between valid ones, a batch row
    with every key masked, head dim 128, GQA and a window at T 256."""
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def qkv(B, H, T, S, d, Hkv=None):
        return dict(q=rnd(B, H, T, d), k=rnd(B, Hkv or H, S, d),
                    v=rnd(B, Hkv or H, S, d))

    hole = torch.ones(2, 200, device=dev)
    hole[:, 64:128] = 0.0
    hole[1, 190:] = 0.0
    dead = torch.ones(3, 130, device=dev)
    dead[1] = 0.0
    return [
        ("T5_first_tile", qkv(2, 4, 5, 5, 64)),
        ("T65_causal", dict(qkv(2, 4, 65, 65, 64), causal=True)),
        ("T65_B33_H4", dict(qkv(33, 4, 65, 65, 64))),
        ("T100_S77_masked", dict(qkv(2, 4, 100, 77, 64), kv_mask=(
            torch.arange(77, device=dev)[None, :]
            < torch.tensor([[77], [40]], device=dev)).float())),
        ("T200_zero_tile_mid", dict(qkv(2, 4, 200, 200, 64), kv_mask=hole)),
        ("T130_row_all_masked", dict(qkv(3, 4, 130, 130, 64),
                                     kv_mask=dead)),
        ("T256_head_dim_128", dict(qkv(2, 4, 256, 256, 128), causal=True)),
        ("T256_head_dim_128_bq64", dict(qkv(9, 4, 256, 256, 128),
                                        kv_mask=hole[:1, :].repeat(
                                            9, 2)[:, :256].contiguous())),
        ("T256_gqa_window", dict(qkv(2, 8, 256, 256, 64, Hkv=4),
                                 kv_group=2, window=40)),
        ("T256_window_causal", dict(qkv(2, 8, 256, 256, 64), causal=True,
                                    window=70)),
        ("T70_head_dim_33", dict(qkv(2, 3, 70, 70, 33))),
    ]


def train_flash_cases(torch, gen):
    """(name, kwargs for flash_forward) at the train step's three calls:
    encoder self-attention and decoder cross-attention (ragged key mask
    of the source lengths) and decoder self-attention (causal)."""
    dev = "cuda"
    dh = D_MODEL // N_HEAD
    shape = (TRAIN_BATCH, N_HEAD, MAX_LEN, dh)

    def qkv():
        return {n: torch.randn(*shape, generator=gen, device=dev)
                for n in ("q", "k", "v")}

    lens = torch.randint(16, MAX_LEN + 1, (TRAIN_BATCH,), generator=gen,
                         device=dev)
    mask = (torch.arange(MAX_LEN, device=dev)[None, :]
            < lens[:, None]).float()
    return [("train_self_masked", dict(qkv(), kv_mask=mask)),
            ("train_causal", dict(qkv(), causal=True)),
            ("train_cross_masked", dict(qkv(), kv_mask=mask.clone()))]


def switch_flash_cases(torch, gen):
    """(name, kwargs for flash_forward) at the Switch-Base-8 train step's
    self-attention: q/k/v [SW_BATCH, SW_HEADS, SW_LEN, 64] with the key
    mask of lengths SW_MIN_LEN..SW_LEN, as the switch phase feeds them."""
    dev = "cuda"
    shape = (SW_BATCH, SW_HEADS, SW_LEN, SW_D // SW_HEADS)
    qkv = {n: torch.randn(*shape, generator=gen, device=dev)
           for n in ("q", "k", "v")}
    lens = torch.randint(SW_MIN_LEN, SW_LEN + 1, (SW_BATCH,), generator=gen,
                         device=dev)
    mask = (torch.arange(SW_LEN, device=dev)[None, :]
            < lens[:, None]).float()
    return [("switch_self_masked", dict(qkv, kv_mask=mask))]


def bwd_inputs(torch, fa, kw, gen):
    """The backward's arguments for a forward case: the forward kernel's
    output and LSE, and a random output gradient."""
    out, lse = fa.flash_forward(**kw)
    dout = torch.randn(out.shape, generator=gen, device=out.device)
    return dict(q=kw["q"], k=kw["k"], v=kw["v"], kv_mask=kw.get("kv_mask"),
                out=out, lse=lse, dout=dout, causal=kw.get("causal", False),
                kv_group=kw.get("kv_group", 1), window=kw.get("window", 0))


def paged_case(torch, gen, S, H, dh, ps, lengths, offset=0):
    """Random pools and a ragged table (page 0 is the trash page, a
    slot's tail aliases its last valid page), as the session lays them
    out. ``offset`` floats shift both pools off 16-byte alignment."""
    from paddle_tpu_torch.kernels.paged_attention import pages_for

    npp = pages_for(MAX_LEN, ps)
    P = 1 + S * npp
    dev = "cuda"

    def pool():
        n = P * H * ps * dh
        flat = torch.randn(n + offset, generator=gen, device=dev)
        return flat[offset:].view(P, H, ps, dh)

    k_pool, v_pool = pool(), pool()
    table = torch.zeros(S, npp, dtype=torch.int64)
    order = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        len(lengths) * 131 + ps)) + 1
    nxt = 0
    for s, n in enumerate(lengths):
        k = pages_for(n, ps)
        for p in range(k):
            table[s, p] = int(order[nxt])
            nxt += 1
        for p in range(k, npp):
            table[s, p] = table[s, max(k - 1, 0)]
    q = torch.randn(S, H, dh, generator=gen, device=dev)
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, page_table=table.to(dev),
                lengths=torch.tensor(lengths, dtype=torch.int64, device=dev))


def ragged_lengths():
    """The serving mix of slot lengths: 32 draws from 0..256 (seed 7),
    one slot empty, one at 17."""
    import torch

    rng_lens = torch.randint(0, MAX_LEN + 1, (NUM_SLOTS,),
                             generator=torch.Generator().manual_seed(7))
    ragged = [int(x) for x in rng_lens]
    ragged[3] = 0
    ragged[5] = 17
    return ragged


def paged_plan_of(kw):
    """``paged_plan`` for a case's shapes on this card."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels.build import device_limits

    S, H, dh = kw["q"].shape
    return pa.paged_plan(S, H, kw["page_table"].shape[1],
                         kw["k_pool"].shape[2], dh,
                         *device_limits("cuda"))


def serving_paged_cases(torch, gen):
    """(name, kwargs of paged_attention): the serving shapes (every slot
    full; the serving mix of lengths) and the first edge cases. The
    timing phase draws these alone, so that the rows it times after
    them see the same random inputs as before the split design's cases
    (``paged_cases``) were added."""
    dh = D_MODEL // N_HEAD
    return [
        ("full_occupancy_ps16",
         paged_case(torch, gen, NUM_SLOTS, N_HEAD, dh, 16,
                    [MAX_LEN] * NUM_SLOTS)),
        ("ragged_ps16", paged_case(torch, gen, NUM_SLOTS, N_HEAD, dh, 16,
                                   ragged_lengths())),
        ("ragged_ps3", paged_case(torch, gen, 9, 4, dh, 3,
                                  [0, 1, 2, 3, 4, 29, 100, 255, 256])),
        ("ragged_ps4_dh128", paged_case(torch, gen, 5, 2, 128, 4,
                                        [7, 1, 0, 13, 30])),
    ]


def paged_cases(torch, gen):
    """The serving cases, then the split design's: lengths ending exactly
    on split boundaries, slots whose later splits are empty, length 1,
    page sizes 1, 64 and 256, npp not a multiple of the split count, dh
    33 (4-byte copies) and pools off 16-byte alignment."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels.build import device_limits

    dh = D_MODEL // N_HEAD
    cases = serving_paged_cases(torch, gen)
    # lengths on split boundaries: k * pages_per_split * page_size
    span = 16 * pa.paged_plan(4, 2, pa.pages_for(MAX_LEN, 16), 16, dh,
                              *device_limits("cuda"))["pages_per_split"]
    cases += [
        ("split_boundaries_ps16", paged_case(
            torch, gen, 4, 2, dh, 16, [min(MAX_LEN, k * span)
                                       for k in (1, 2, 3, 4)])),
        ("later_splits_empty", paged_case(torch, gen, 6, 2, dh, 16,
                                          [1, 17, 40, span, 0, 3])),
        ("length_1", paged_case(torch, gen, 8, 4, dh, 16, [1] * 8)),
        ("page_size_1", paged_case(torch, gen, 3, 2, dh, 1, [256, 100, 1])),
        ("page_size_64", paged_case(torch, gen, 5, 2, dh, 64,
                                    [256, 65, 64, 0, 3])),
        ("page_size_256", paged_case(torch, gen, 3, 2, dh, 256,
                                     [256, 200, 1])),
        ("npp22_ps12", paged_case(torch, gen, 4, 2, dh, 12,
                                  [256, 250, 73, 12])),
        ("dh33", paged_case(torch, gen, 3, 2, 33, 16, [200, 33, 0])),
        ("unaligned_pools", paged_case(torch, gen, 4, 2, dh, 16,
                                       [256, 100, 0, 9], offset=1)),
    ]
    return cases


def tree_case(torch, gen, S, H, N, dh, ps, max_len, bases, branched=False):
    """Random pools, a ragged table covering each live slot's committed
    rows and tree (page 0 is the trash page; a finished slot, base -1,
    keeps an all-trash row), and chain or random branched ancestor
    masks."""
    from paddle_tpu_torch.kernels.paged_attention import pages_for
    from paddle_tpu_torch.serving.speculative import tree_from_parents

    npp = pages_for(max_len, ps)
    P = 1 + S * npp
    dev = "cuda"
    cpu = torch.Generator().manual_seed(S * 1009 + N * 31 + ps)
    table = torch.zeros(S, npp, dtype=torch.int64)
    order = torch.randperm(P - 1, generator=cpu) + 1
    nxt = 0
    for s, b in enumerate(bases):
        k = pages_for(min(b + N, npp * ps), ps) if b >= 0 else 0
        for p in range(k):
            table[s, p] = int(order[nxt])
            nxt += 1
        for p in range(k, npp):
            table[s, p] = table[s, max(k - 1, 0)]
    anc = torch.tril(torch.ones(N, N, dtype=torch.int64)).repeat(S, 1, 1)
    if branched:
        for s in range(S):
            parents = [-1] + [int(torch.randint(0, i, (1,), generator=cpu))
                              for i in range(1, N)]
            anc[s] = torch.from_numpy(tree_from_parents(parents))
    return dict(
        q=torch.randn(S, H, N, dh, generator=gen, device=dev),
        k_pool=torch.randn(P, H, ps, dh, generator=gen, device=dev),
        v_pool=torch.randn(P, H, ps, dh, generator=gen, device=dev),
        page_table=table.to(dev),
        base_lens=torch.tensor(bases, dtype=torch.int64, device=dev),
        anc=anc.to(dev), max_length=max_len)


def tree_cases(torch, gen):
    """The verify dispatch's shape (32 slots, 8 heads, 4 nodes, ragged
    bases up to 252) and the edges: base 0, finished slots, trees that
    straddle max_length, branched masks, page sizes 4 and 1, 1 and 8
    nodes (and 19: more than one walk), head dims 40 and 128."""
    dh = D_MODEL // N_HEAD
    N = SPEC_K + 1
    ragged = [int(x) for x in torch.randint(
        0, MAX_LEN - N + 1, (NUM_SLOTS,),
        generator=torch.Generator().manual_seed(11))]
    ragged[0], ragged[7] = MAX_LEN - N, 0
    return [
        ("verify_ragged_ps16", tree_case(torch, gen, NUM_SLOTS, N_HEAD, N, dh,
                                         PAGE_SIZE, MAX_LEN, ragged)),
        ("edges_branched", tree_case(torch, gen, 8, 2, N, dh, PAGE_SIZE,
                                     MAX_LEN, [0, -1, 254, 253, 252, 17, -1,
                                               100], True)),
        ("ps4_branched", tree_case(torch, gen, 5, 2, N, 16, 4, 32,
                                   [7, 0, 25, 30, -1], True)),
        ("ps1", tree_case(torch, gen, 4, 2, N, dh, 1, 40, [7, 0, 38, -1])),
        ("nodes_1", tree_case(torch, gen, 4, 2, 1, dh, PAGE_SIZE, MAX_LEN,
                              [7, 0, 254, -1])),
        ("nodes_8_branched", tree_case(torch, gen, 4, 2, 8, dh, PAGE_SIZE,
                                       MAX_LEN, [7, 0, 250, -1], True)),
        ("nodes_19_branched", tree_case(torch, gen, 3, 2, 19, dh, PAGE_SIZE,
                                        MAX_LEN, [7, 0, 240], True)),
        ("head_dim_40", tree_case(torch, gen, 4, 3, N, 40, PAGE_SIZE, MAX_LEN,
                                  [100, 0, 253, -1], True)),
        ("head_dim_128", tree_case(torch, gen, 4, 2, N, 128, PAGE_SIZE,
                                   MAX_LEN, [100, 0, 253, -1], True)),
    ] + tree_split_cases(torch)


def tree_split_cases(torch):
    """(name, kwargs of paged_tree_attention): the edges of B5's split
    design, from a generator of their own (the cases above, and what the
    timing phase draws after them, keep their inputs). At 4 slots x 2
    heads ``tree_plan`` splits 16 pages of 16 into 4 splits of 64 keys:
    scans that end mid-page and mid-chunk, on a split boundary, and
    slots whose later splits lie wholly past the scan; max_length inside
    a tree; 8 and 19 nodes (three walks) over every split; head dim 33
    (4-byte copies)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    dh = D_MODEL // N_HEAD
    N = SPEC_K + 1
    return [
        ("scan_mid_page", tree_case(torch, gen, 4, 2, N, dh, PAGE_SIZE,
                                    MAX_LEN, [21, 3, 37, -1], True)),
        ("splits_past_scan", tree_case(torch, gen, 4, 2, N, dh, PAGE_SIZE,
                                       MAX_LEN, [0, 60, 124, 130], True)),
        ("max_len_inside_tree", tree_case(torch, gen, 4, 2, N, dh,
                                          PAGE_SIZE, 190, [186, 187, 100,
                                                           -1], True)),
        ("nodes_8_splits", tree_case(torch, gen, 4, 2, 8, dh, PAGE_SIZE,
                                     MAX_LEN, [248, 56, 129, 0], True)),
        ("nodes_19_splits", tree_case(torch, gen, 4, 2, 19, dh, PAGE_SIZE,
                                      MAX_LEN, [237, 50, 120, -1], True)),
        ("head_dim_33", tree_case(torch, gen, 4, 2, N, 33, PAGE_SIZE,
                                  MAX_LEN, [200, 63, 0, -1], True)),
    ]


def kernel_phase(torch):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    from paddle_tpu_torch.kernels.build import device_limits

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"flash_fwd": 0.0, "paged_decode": 0.0, "tree_decode": 0.0,
             "flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0}
    limits = device_limits("cuda")
    for name, kw in flash_cases(torch, gen) + flash_tile_cases(torch, gen):
        check_flash_fwd(torch, fa, name, kw, limits, worst)
    # the backward pair at the train step's shapes, at B1's edge cases
    # (decode's T=1 shape included) and multi-row tile cases, plus T != S
    dev = "cuda"
    t_ne_s = dict(q=torch.randn(2, 4, 19, 64, generator=gen, device=dev),
                  k=torch.randn(2, 4, 37, 64, generator=gen, device=dev),
                  v=torch.randn(2, 4, 37, 64, generator=gen, device=dev),
                  kv_mask=(torch.arange(37, device=dev)[None, :]
                           < torch.tensor([[37], [5]], device=dev)).float())
    for name, kw in (train_flash_cases(torch, gen) + flash_cases(torch, gen)
                     + flash_tile_cases(torch, gen)
                     + [("T19_S37_masked", t_ne_s)]):
        check_flash_bwd(torch, fa, name, kw, gen, worst)
    for name, kw in paged_cases(torch, gen):
        plan = paged_plan_of(kw)
        print("plan paged_decode %-22s %s, %s" % (name, plan, {
            k: (list(v.shape) if k != "lengths" else v.tolist())
            for k, v in kw.items() if k in ("q", "k_pool", "lengths")}))
        out = pa.paged_attention(**kw)
        ref = pa.paged_attention_plain(**kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        empty = kw["lengths"] <= 0
        if empty.any() and out[empty].abs().max().item() != 0.0:
            fail("paged_decode %s: a length-0 slot is not exactly 0" % name)
        print("kernel paged_decode %-19s max_abs_err %.3e  tol %.0e  empty %d"
              % (name, err, K2_TOL, int(empty.sum())))
        if not err <= K2_TOL:
            fail("paged_decode %s: error %.3e above %.0e" % (name, err, K2_TOL))
        worst["paged_decode"] = max(worst["paged_decode"], err)
    err = paged_capture_check(torch, gen)
    worst["paged_decode"] = max(worst["paged_decode"], err)
    for name, kw in tree_cases(torch, gen):
        S, H, N, dh = kw["q"].shape
        print("plan tree_decode %-23s %s, bases %s" % (name, pa.tree_plan(
            S, H, N, kw["page_table"].shape[1], kw["k_pool"].shape[2], dh,
            *limits), kw["base_lens"].tolist()))
        out = pa.paged_tree_attention(**kw)
        ref = pa.paged_tree_attention_plain(**kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        dead = kw["base_lens"] < 0
        if dead.any() and out[dead].abs().max().item() != 0.0:
            fail("tree_decode %s: a finished slot is not exactly 0" % name)
        print("kernel tree_decode %-20s max_abs_err %.3e  tol %.0e  dead %d"
              % (name, err, K5_TOL, int(dead.sum())))
        if not (torch.isfinite(out).all() and err <= K5_TOL):
            fail("tree_decode %s: error %.3e above %.0e" % (name, err, K5_TOL))
        worst["tree_decode"] = max(worst["tree_decode"], err)
    err = tree_capture_check(torch, gen)
    worst["tree_decode"] = max(worst["tree_decode"], err)
    err = flash_capture_check(torch, gen)
    worst["flash_fwd"] = max(worst["flash_fwd"], err)
    # B1, B2 and B3 at the Switch train step's shape, from a generator of
    # their own (the cases above keep their inputs)
    sgen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    for name, kw in switch_flash_cases(torch, sgen):
        check_flash_fwd(torch, fa, name, kw, limits, worst)
        check_flash_bwd(torch, fa, name, kw, sgen, worst)
    return worst


def check_flash_fwd(torch, fa, name, kw, limits, worst):
    """B1 against its plain version on one case: dead rows (every key
    masked) exactly 0 and the LSE's dead-row marker where the plain
    version's, outputs and LSE within K1_TOL; updates ``worst``."""
    B, H, T, d = kw["q"].shape
    print("plan flash_fwd %-22s %s" % (name, fa.flash_plan(
        B, H, T, kw["k"].shape[2], d, *limits)))
    out, lse = fa.flash_forward(**kw)
    ref, ref_lse = fa.flash_forward_plain(**kw)
    torch.cuda.synchronize()
    dead = ref_lse <= fa.MASKED_ROW_LSE
    if not torch.equal(lse <= fa.MASKED_ROW_LSE, dead):
        fail("flash_fwd %s: dead rows differ" % name)
    if dead.any() and out[dead].abs().max().item() != 0.0:
        fail("flash_fwd %s: a dead row is not exactly 0" % name)
    err = max((out - ref).abs().max().item(),
              (lse - ref_lse)[~dead].abs().max().item()
              if (~dead).any() else 0.0)
    print("kernel flash_fwd %-22s max_abs_err %.3e  tol %.0e  dead_rows %d"
          % (name, err, K1_TOL, int(dead.sum())))
    if not err <= K1_TOL:
        fail("flash_fwd %s: error %.3e above %.0e" % (name, err, K1_TOL))
    worst["flash_fwd"] = max(worst["flash_fwd"], err)


def check_flash_bwd(torch, fa, name, kw, gen, worst):
    """B2 and B3 against their plain version on one forward case (its
    output gradient drawn from ``gen``): a dead row's dq and a masked
    key's dk and dv exactly 0, the gradients within K1_TOL; updates
    ``worst``."""
    B, H, T, d = kw["q"].shape
    Hkv, S = kw["k"].shape[1:3]
    print("plan flash_bwd %-22s %s" % (name, fa.flash_bwd_plan(
        B, H, Hkv, T, S, d)))
    args = bwd_inputs(torch, fa, kw, gen)
    dq, dk, dv = fa.flash_backward(**args)
    rq, rk, rv = fa.flash_backward_plain(**args)
    torch.cuda.synchronize()
    dead = args["lse"] <= fa.MASKED_ROW_LSE
    if dead.any() and dq[dead].abs().max().item() != 0.0:
        fail("flash_bwd_dq %s: a dead row's dq is not exactly 0" % name)
    m = args["kv_mask"]
    if m is not None and (m == 0).any():
        off = (m == 0)[:, None, :].expand(dk.shape[:3])
        if max(dk[off].abs().max().item(), dv[off].abs().max().item()):
            fail("flash_bwd_dkv %s: a masked key's dk/dv is not exactly 0"
                 % name)
    e_kv = max((dk - rk).abs().max().item(), (dv - rv).abs().max().item())
    e_q = (dq - rq).abs().max().item()
    print("kernel flash_bwd_dkv/dq %-19s max_abs_err %.3e / %.3e  tol "
          "%.0e  dead_rows %d" % (name, e_kv, e_q, K1_TOL, int(dead.sum())))
    if not (e_kv <= K1_TOL and e_q <= K1_TOL):
        fail("flash_bwd %s: error %.3e / %.3e above %.0e"
             % (name, e_kv, e_q, K1_TOL))
    worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], e_kv)
    worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], e_q)


def flash_bwd_layout_phase():
    """B2/B3's plans against the kernels: at every head dim 1..128, the
    threads and shared bytes of ``flash_bwd_plan`` equal those
    csrc/flash_bwd.cu derives (``kernel_bwd_layout``), and the shared
    bytes stay within the card's per-block limit."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels.build import device_limits

    limit = device_limits("cuda")[1]
    n = 0
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        plan = fa.flash_bwd_plan(1, 1, 1, 64, 64, d)
        for kernel in fa.BWD_KERNELS:
            p = plan[kernel]
            got = fa.kernel_bwd_layout(kernel, p["rows"], d)
            if got != (p["threads"], p["smem"]) or p["smem"] > limit:
                fail("flash_bwd_%s rows %d d %d: the plan's (threads, "
                     "smem) %s, the kernel's %s, limit %d"
                     % (kernel, p["rows"], d, (p["threads"], p["smem"]),
                        got, limit))
            n += 1
    print("flash_bwd layout: the plan's threads and shared bytes equal the "
          "kernels' at %d (kernel, rows, head dim) triples, all within %d "
          "bytes" % (n, limit))


def flash_bf16_layout_phase():
    """B1's, B2's and B3's bf16 plans against the kernels: at every head
    dim 1..128, the threads and shared bytes of ``flash_bf16_plan`` equal
    those csrc/flash_fwd_bf16.cu derives, the threads, shared bytes and
    Q tile of ``flash_bwd_plan``'s ``"dkv_bf16"`` those of
    csrc/flash_bwd_dkv_bf16.cu, and the threads, shared bytes and K/V
    tile of its ``"dq_bf16"`` those of csrc/flash_bwd_dq_bf16.cu
    (``kernel_bf16_layout``), all within the card's per-block limit."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels.build import device_limits

    n_sm, limit = device_limits("cuda")
    n = 0
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        fwd = fa.flash_bf16_plan(TRAIN_BATCH, N_HEAD, MAX_LEN, MAX_LEN, d,
                                 n_sm, limit)
        bwd = fa.flash_bwd_plan(1, 1, 1, 64, 64, d)
        tiled = ("threads", "smem", "tile")
        for entry, p, keys in (("fwd", fwd, ("threads", "smem")),
                               ("dkv", bwd["dkv_bf16"], tiled),
                               ("dq", bwd["dq_bf16"], tiled)):
            tile = p["block_q"] if entry == "fwd" else p["rows"]
            got = fa.kernel_bf16_layout(entry, tile, d)
            want = {k: p[k] for k in keys}
            if got != want or p["smem"] > limit:
                fail("flash bf16 %s tile %d d %d: the plan's %s, the "
                     "kernel's %s, limit %d" % (entry, tile, d, want, got,
                                                limit))
            n += 1
    print("flash bf16 layout: the plans' threads and shared bytes (and B2's "
          "Q tile, B3's K/V tile) equal the kernels' at %d (entry, head "
          "dim) pairs, all within %d bytes" % (n, limit))


def paged_layout_phase():
    """B4's plan against the kernel: at every head dim 1..128, the
    threads and shared bytes of ``paged_plan`` equal those
    csrc/paged_decode.cu derives (``kernel_paged_layout``)."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels.build import device_limits

    limits = device_limits("cuda")
    for dh in range(1, pa.MAX_HEAD_DIM + 1):
        plan = pa.paged_plan(NUM_SLOTS, N_HEAD, 16, PAGE_SIZE, dh, *limits)
        got = pa.kernel_paged_layout(dh)
        if got != (plan["threads"], plan["smem"]):
            fail("paged_decode dh %d: the plan's (threads, smem) %s, the "
                 "kernel's %s" % (dh, (plan["threads"], plan["smem"]), got))
    print("paged_decode layout: the plan's threads and shared bytes equal "
          "the kernel's at head dims 1..%d" % pa.MAX_HEAD_DIM)


def replay_check(torch, who, call, plain, change, dead_of, tol):
    """A kernel's call in a CUDA graph: capture ``call()`` (after one
    warm-up call on a side stream), replay it, then ``change()`` the
    inputs in place and replay again; after each replay the output is
    held to ``plain()`` on the inputs as they are, and the rows that
    ``dead_of()`` marks must be exactly 0. Returns the worst error."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    worst = 0.0
    for label in ("captured", "inputs changed in place"):
        if label != "captured":
            change()
        graph.replay()
        torch.cuda.synchronize()
        ref = plain()
        err = (out - ref).abs().max().item()
        dead = dead_of()
        if dead.any() and out[dead].abs().max().item() != 0.0:
            fail("%s graph (%s): a dead row is not exactly 0" % (who, label))
        print("kernel %s graph replay, %s: max_abs_err %.3e  tol %.0e  "
              "dead %d" % (who, label, err, tol, int(dead.sum())))
        if not err <= tol:
            fail("%s graph (%s): error %.3e above %.0e" % (who, label, err,
                                                          tol))
        worst = max(worst, err)
    return worst


def paged_capture_check(torch, gen):
    """B4 in a CUDA graph: capture ``paged_attention`` on the serving
    shape, change the lengths and the page table in place, replay, and
    hold the output to the plain version on the new values (the kernel
    reads the lengths on the device; the split is fixed at capture).
    Returns the worst error of the two replays."""
    from paddle_tpu_torch.kernels import paged_attention as pa

    dh = D_MODEL // N_HEAD
    kw = paged_case(torch, gen, NUM_SLOTS, N_HEAD, dh, PAGE_SIZE,
                    ragged_lengths())
    other = paged_case(torch, gen, NUM_SLOTS, N_HEAD, dh, PAGE_SIZE,
                       [MAX_LEN - n for n in ragged_lengths()])

    def change():
        kw["lengths"].copy_(other["lengths"])
        kw["page_table"].copy_(other["page_table"])

    return replay_check(
        torch, "paged_decode", lambda: pa.paged_attention(**kw),
        lambda: pa.paged_attention_plain(**kw), change,
        lambda: kw["lengths"] <= 0, K2_TOL)


def tree_layout_phase():
    """B5's plan against the kernel: at every head dim 1..128 and 1, 4
    and 8 nodes, the threads and shared bytes of ``tree_plan`` equal
    those csrc/tree_decode.cu derives (``kernel_tree_layout``)."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels.build import device_limits

    limits = device_limits("cuda")
    for dh in range(1, pa.MAX_HEAD_DIM + 1):
        for N in (1, SPEC_K + 1, 8):
            plan = pa.tree_plan(NUM_SLOTS, N_HEAD, N, 16, PAGE_SIZE, dh,
                                *limits)
            got = pa.kernel_tree_layout(dh, N)
            if got != (plan["threads"], plan["smem"]):
                fail("tree_decode dh %d N %d: the plan's (threads, smem) "
                     "%s, the kernel's %s" % (dh, N, (plan["threads"],
                                                      plan["smem"]), got))
    print("tree_decode layout: the plan's threads and shared bytes equal "
          "the kernel's at head dims 1..%d, 1, %d and 8 nodes"
          % (pa.MAX_HEAD_DIM, SPEC_K + 1))


def flash_rows_layout_phase():
    """B1's rows path (T <= 4) against the kernel: at every head dim
    1..128 and T 1..4, the threads and shared bytes of
    ``flash_rows_plan`` equal those csrc/flash_fwd.cu derives
    (``kernel_flash_rows_layout``)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels.build import device_limits

    limits = device_limits("cuda")
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        for T in range(1, fa.ROWS_T + 1):
            plan = fa.flash_rows_plan(NUM_SLOTS, N_HEAD, T, MAX_LEN, d,
                                      *limits)
            got = fa.kernel_flash_rows_layout(T, d)
            if got != (plan["threads"], plan["smem"]):
                fail("flash_fwd rows T %d d %d: the plan's (threads, smem) "
                     "%s, the kernel's %s" % (T, d, (plan["threads"],
                                                     plan["smem"]), got))
    print("flash_fwd rows layout: the plan's threads and shared bytes equal "
          "the kernel's at head dims 1..%d, T 1..%d"
          % (fa.MAX_HEAD_DIM, fa.ROWS_T))


def tree_capture_check(torch, gen):
    """B5 in a CUDA graph at the verify shape: capture
    ``paged_tree_attention``, change the bases, the page table and the
    node masks in place, replay, and hold the output to the plain
    version on the new values (the kernel reads the bases on the device;
    the split is fixed at capture)."""
    from paddle_tpu_torch.kernels import paged_attention as pa

    dh = D_MODEL // N_HEAD
    N = SPEC_K + 1
    bases = [int(x) for x in torch.randint(
        0, MAX_LEN - N + 1, (NUM_SLOTS,),
        generator=torch.Generator().manual_seed(12))]
    bases[4] = -1
    kw = tree_case(torch, gen, NUM_SLOTS, N_HEAD, N, dh, PAGE_SIZE, MAX_LEN,
                   bases, True)
    other = tree_case(torch, gen, NUM_SLOTS, N_HEAD, N, dh, PAGE_SIZE,
                      MAX_LEN, [-1 if b < 0 else MAX_LEN - N - b
                                for b in bases][::-1], True)

    def change():
        for name in ("base_lens", "page_table", "anc"):
            kw[name].copy_(other[name])

    return replay_check(
        torch, "tree_decode", lambda: pa.paged_tree_attention(**kw),
        lambda: pa.paged_tree_attention_plain(**kw), change,
        lambda: kw["base_lens"] < 0, K5_TOL)


def flash_capture_check(torch, gen):
    """B1's decode call in a CUDA graph: capture ``flash_forward`` at the
    decode shape (q [32, 8, 1, 64] over 256 keys, a ragged key mask),
    change the key mask in place (other lengths, one slot wholly
    masked), replay, and hold out and LSE to the plain version (the
    kernel reads the mask on the device; the split is fixed at
    capture)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    dh = D_MODEL // N_HEAD
    cases = dict(flash_cases(torch, gen))
    kw = {n: t.clone() for n, t in cases["decode_cross_T1"].items()}
    lens = kw["kv_mask"].sum(dim=1).long()
    flipped = (torch.arange(MAX_LEN, device="cuda")[None, :]
               < (MAX_LEN + 1 - lens)[:, None]).float()
    flipped[7] = 0.0

    def flat(out, lse):
        """out, the LSE of the live rows (0 on dead rows, where the kernel
        and the plain version both give -1e29 or less, not the same
        number) and the dead rows as 1, in one vector."""
        dead = lse <= fa.MASKED_ROW_LSE
        return torch.cat([out.reshape(-1),
                          torch.where(dead, torch.zeros_like(lse),
                                      lse).reshape(-1),
                          dead.float().reshape(-1)])

    def dead_of():
        dead = (kw["kv_mask"].sum(dim=1) == 0)
        rows = dead[:, None, None, None].expand(NUM_SLOTS, N_HEAD, 1, dh)
        return torch.cat([rows.reshape(-1), torch.zeros(
            2 * NUM_SLOTS * N_HEAD, dtype=torch.bool, device="cuda")])

    return replay_check(
        torch, "flash_fwd decode", lambda: flat(*fa.flash_forward(**kw)),
        lambda: flat(*fa.flash_forward_plain(**kw)),
        lambda: kw["kv_mask"].copy_(flipped), dead_of, K1_TOL)


def full_mask_phase(torch):
    """C1 on the card: a full [B, H, T, S] mask (GQA, a window, a fully
    masked row) through ``flash_attention`` on the card and on the CPU,
    forward and gradient within 1e-4. The route is by the mask's rank:
    ``attention_reference`` is called once on each device and no kernel
    launches. Returns the worst error."""
    from paddle_tpu_torch.kernels import KERNELS
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED + 5)
    B, H, Hkv, T, S, d = 2, 8, 4, 70, 90, 64
    ins = [torch.randn(*shape, generator=gen) for shape in (
        (B, H, T, d), (B, Hkv, S, d), (B, Hkv, S, d), (B, H, T, d))]
    mask = torch.rand(B, H, T, S, generator=gen) > 0.3
    mask[1, 3, 5] = False  # a row that sees no key: the mean of V
    res = {}
    for dev in ("cuda", "cpu"):
        for k in KERNELS.values():
            k.reset()
        fa.ATTENTION_REFERENCE.reset()
        leaves = [t.to(dev).requires_grad_() for t in ins[:3]]
        out = fa.flash_attention(*leaves, mask=mask.to(dev), kv_group=2,
                                 window=40)
        grads = torch.autograd.grad(out, leaves, ins[3].to(dev))
        launched = {n: k.launches for n, k in KERNELS.items() if k.launches}
        if fa.ATTENTION_REFERENCE.calls != 1 or launched:
            fail("full mask on %s: attention_reference called %d times, "
                 "kernels launched %s" % (dev, fa.ATTENTION_REFERENCE.calls,
                                          launched))
        res[dev] = [t.detach().cpu() for t in (out,) + tuple(grads)]
    err = max((a - b).abs().max().item()
              for a, b in zip(res["cuda"], res["cpu"]))
    print("full mask [%d,%d,%d,%d] (GQA 2, window 40, a fully masked row): "
          "attention_reference once per device, no kernel launch; card vs "
          "cpu out/dq/dk/dv max abs diff %.3e  tol %.0e"
          % (B, H, T, S, err, K1_TOL))
    if not err <= K1_TOL:
        fail("full mask: card and CPU differ by %.3e" % err)
    return err


def sdpa_backend(torch, F, q, k, v, mask, causal=False):
    """The backend ``scaled_dot_product_attention`` picks for these
    inputs: the first in PyTorch's priority order that takes them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    members = SDPBackend.__members__
    order = ["FLASH_ATTENTION", "EFFICIENT_ATTENTION", "MATH"]
    try:
        by_value = {int(b): n for n, b in members.items()}
        order = [by_value[int(i)] for i in torch._C._get_sdp_priority_order()]
    except (AttributeError, KeyError, TypeError):
        pass  # an older torch: its documented default order
    for name in order:
        if name in ("ERROR", "OVERRIDEABLE"):
            continue
        try:
            # a backend that refuses the inputs warns why, then raises
            with warnings.catch_warnings(), sdpa_kernel([members[name]]):
                warnings.simplefilter("ignore")
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               is_causal=causal)
        except RuntimeError:
            continue
        return name
    return "none"


def sdpa_backward_ms(torch, F, bwd):
    """(backend, ms) of the backward of ``scaled_dot_product_attention``
    on the same inputs, key mask (or ``is_causal``) and output gradient
    as the kernels: ``torch.autograd.grad`` of a forward run once, the
    device time of the kernels it launches from a profiler trace
    (``device_ms``: eager calls, whose host time would show through CUDA
    events at these sizes). It includes the backward's own
    ``rowsum(dO O)`` pass."""
    ins = []

    def mask_of(a):
        return (None if a["kv_mask"] is None
                else (a["kv_mask"] > 0)[:, None, None, :])

    for a in bwd:
        q, k, v = (a[n].detach().requires_grad_() for n in ("q", "k", "v"))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask_of(a),
                                             is_causal=a["causal"])
        ins.append((out, (q, k, v), a["dout"]))
    q, k, v = ins[0][1]
    backend = sdpa_backend(torch, F, q, k, v, mask_of(bwd[0]),
                           bwd[0]["causal"])

    def call(i):
        out, leaves, dout = ins[i]
        torch.autograd.grad(out, leaves, dout, retain_graph=True)

    return backend, device_ms(torch, call, ins)


def delta_ms(torch, bwd):
    """Device ms of the port's ``delta = rowsum(dO O)`` pass, as
    ``flash_backward`` computes it ahead of the kernels (float32 from the
    upcast values), timed as the kernels are (``cuda_ms``)."""
    return cuda_ms(lambda dout, out: (dout.float() * out.float()).sum(
        dim=-1), [dict(dout=a["dout"], out=a["out"]) for a in bwd])


def pair_line(label, shape, rows, suffix, kernels, delta, backend, lib):
    """The backward pair with its ``delta`` pass against the library's
    backward (which computes its own ``rowsum(dO O)``)."""
    dkv, dq = (rows[k + suffix]["ms"] for k in kernels)
    print("pair %-24s %s: %s %.4f + %s %.4f + delta %.4f = %.4f ms; "
          "library %.4f ms (backward of scaled_dot_product_attention, "
          "backend %s, its kernels' device time from a profiler trace, its "
          "own rowsum(dO O) included)"
          % (label + suffix, shape, kernels[0], dkv, kernels[1], dq, delta,
             dkv + dq + delta, lib, backend))


def timing_phase(torch):
    """Kernel, plain version and library times at the serving and
    training shapes."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dh = D_MODEL // N_HEAD
    rows = {}
    cases = dict(flash_cases(torch, gen))

    def sdpa_inputs(kws):
        return [dict(query=c["q"], key=c["k"], value=c["v"],
                     attn_mask=(c["kv_mask"] > 0)[:, None, None, :])
                for c in kws]

    # K1 as grouped_cross_attention calls it every decode step: one query
    # row per slot over the group's source rows, ragged key mask
    kw = copies(cases["decode_cross_T1"])
    vis = float(kw[0]["kv_mask"].sum())
    S = kw[0]["k"].shape[2]
    nbytes = 4 * (2 * kw[0]["q"].numel() + 2 * vis * N_HEAD * dh
                  + kw[0]["kv_mask"].numel() + NUM_SLOTS * N_HEAD)
    rows["flash_fwd"] = dict(
        shape="q [%d,%d,1,%d], k/v [%d,%d,%d,%d], key mask"
        % (NUM_SLOTS, N_HEAD, dh, NUM_SLOTS, N_HEAD, S, dh),
        ms=cuda_ms(fa.flash_forward, kw),
        plain_ms=cuda_ms(fa.flash_forward_plain, kw),
        library_ms=cuda_ms(F.scaled_dot_product_attention, sdpa_inputs(kw)),
        bound=bound(nbytes, 4.0 * vis * N_HEAD * dh))
    # K1 as the verify dispatch calls it: the tree's 4 query rows per slot
    kw_v = copies(cases["verify_cross_T4"])
    nq = SPEC_K + 1
    rows["flash_fwd_verify"] = dict(
        shape="q [%d,%d,%d,%d], k/v [%d,%d,%d,%d], key mask"
        % (NUM_SLOTS, N_HEAD, nq, dh, NUM_SLOTS, N_HEAD, S, dh),
        ms=cuda_ms(fa.flash_forward, kw_v),
        plain_ms=cuda_ms(fa.flash_forward_plain, kw_v),
        library_ms=cuda_ms(F.scaled_dot_product_attention, sdpa_inputs(kw_v)),
        bound=bound(4 * (2 * kw_v[0]["q"].numel() + 2 * vis * N_HEAD * dh
                         + kw_v[0]["kv_mask"].numel()
                         + NUM_SLOTS * N_HEAD * nq),
                    4.0 * nq * vis * N_HEAD * dh))
    # K1 at the encoder's shape (one admission, one layer)
    kw_e = copies(cases["encoder_masked"])
    vis_e = float(kw_e[0]["kv_mask"].sum())
    rows["flash_fwd_encoder"] = dict(
        shape="q/k/v [1,%d,256,%d], key mask (197 valid)" % (N_HEAD, dh),
        ms=cuda_ms(fa.flash_forward, kw_e),
        plain_ms=cuda_ms(fa.flash_forward_plain, kw_e),
        library_ms=cuda_ms(F.scaled_dot_product_attention,
                           sdpa_inputs(kw_e)),
        bound=bound(4 * (2 * kw_e[0]["q"].numel() + 2 * vis_e * N_HEAD * dh
                         + 256 + N_HEAD * 256),
                    4.0 * 256 * vis_e * N_HEAD * dh))
    # K2 at full occupancy (32 slots x 256 resident tokens) and at the
    # serving mix of lengths (ragged_ps16)
    serving = dict(serving_paged_cases(torch, gen))
    kw2 = copies(serving["full_occupancy_ps16"])
    rows["paged_decode"] = dict(
        shape="%d slots x %d tokens, H %d, dh %d, page_size %d"
        % (NUM_SLOTS, MAX_LEN, N_HEAD, dh, PAGE_SIZE),
        ms=cuda_ms(pa.paged_attention, kw2),
        plain_ms=cuda_ms(pa.paged_attention_plain, kw2),
        library_ms=None,
        bound=paged_decode_bound(kw2[0]["lengths"].tolist(), dh))
    kw2r = copies(serving["ragged_ps16"])
    rows["paged_decode_ragged"] = dict(
        shape="%d slots, lengths %d..%d (%d resident tokens), H %d, dh %d, "
        "page_size %d" % (NUM_SLOTS, min(ragged_lengths()),
                          max(ragged_lengths()), sum(ragged_lengths()),
                          N_HEAD, dh, PAGE_SIZE),
        ms=cuda_ms(pa.paged_attention, kw2r),
        plain_ms=cuda_ms(pa.paged_attention_plain, kw2r),
        library_ms=None,
        bound=paged_decode_bound(kw2r[0]["lengths"].tolist(), dh))
    # K5 at the verify dispatch's shape, priced from this run's own bases
    # by tree_decode_bound (what the kernel copies)
    kw5 = copies(dict(tree_cases(torch, gen))["verify_ragged_ps16"])
    bases = kw5[0]["base_lens"].tolist()
    rows["tree_decode"] = dict(
        shape="%d slots, bases %d..%d (mean %.0f), %d nodes, H %d, dh %d, "
        "page_size %d" % (NUM_SLOTS, min(bases), max(bases),
                          sum(bases) / len(bases), nq, N_HEAD, dh, PAGE_SIZE),
        ms=cuda_ms(pa.paged_tree_attention, kw5),
        plain_ms=cuda_ms(pa.paged_tree_attention_plain, kw5),
        library_ms=None,
        bound=tree_decode_bound(bases, nq, dh))
    # the group gather ahead of every cross-attention call (k_pool[gof])
    pools = copies(dict(input=torch.randn(
        NUM_SLOTS, N_HEAD, MAX_LEN, dh, generator=gen, device="cuda"),
        dim=0, index=torch.randperm(NUM_SLOTS, device="cuda")))
    rows["gather_k_pool_gof_ms"] = cuda_ms(torch.index_select, pools)

    def masked_fwd_row(kw):
        """B1 on key-masked inputs: (its row, the visible (query, key)
        pairs over batch and heads, the shape); work and bytes count the
        valid keys only."""
        B, H, T, d = kw[0]["q"].shape
        vis = float(kw[0]["kv_mask"].sum())  # valid keys, summed over batch
        shape = "q/k/v [%d,%d,%d,%d], key mask (%d of %d keys valid)" % (
            B, H, T, d, vis, B * T)
        # q and out, the valid rows of k and v, lse, the mask
        nbytes = 4.0 * (2 * B * H * T * d + 2 * vis * H * d + B * H * T
                        + B * T)
        return dict(
            shape=shape, ms=cuda_ms(fa.flash_forward, kw),
            plain_ms=cuda_ms(fa.flash_forward_plain, kw),
            library_ms=cuda_ms(F.scaled_dot_product_attention,
                               sdpa_inputs(kw)),
            bound=bound(nbytes, 4.0 * T * vis * H * d)), T * vis * H, shape

    # B1, B2, B3 at the train step's shape, [64,8,256,64], with the
    # source key mask (12 of a step's 18 attention calls)
    tcases = dict(train_flash_cases(torch, gen))
    kw_t = copies(tcases["train_self_masked"])
    B, T = TRAIN_BATCH, MAX_LEN
    rows["flash_fwd_train"], pairs_t, shape_t = masked_fwd_row(kw_t)

    # B1 at the decoder self-attention's shape: causal, no key mask
    kw_c = copies(tcases["train_causal"])
    pairs_c = B * N_HEAD * T * (T + 1) / 2.0
    rows["flash_fwd_train_causal"] = dict(
        shape="q/k/v [%d,%d,%d,%d], causal" % (B, N_HEAD, T, dh),
        ms=cuda_ms(fa.flash_forward, kw_c),
        plain_ms=cuda_ms(fa.flash_forward_plain, kw_c),
        library_ms=cuda_ms(
            lambda q, k, v, causal: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal), kw_c),
        bound=bound(4.0 * (4 * B * N_HEAD * T * dh + B * N_HEAD * T),
                    4.0 * pairs_c * dh))

    def bwd_rows(suffix, cases, pairs, shape):
        """dkv and dq rows for one set of inputs; ``pairs`` counts the
        visible (query, key) pairs over batch and heads."""
        bwd = [bwd_inputs(torch, fa, c, gen) for c in cases]
        for a in bwd:
            a["delta"] = (a["dout"] * a["out"]).sum(dim=-1)
        B, H, T, d = bwd[0]["q"].shape
        kern = [dict(q=a["q"], k=a["k"], v=a["v"], kv_mask=a["kv_mask"],
                     dout=a["dout"], lse=a["lse"], delta=a["delta"],
                     causal=a["causal"], sm_scale=d ** -0.5) for a in bwd]
        plain = [{n: a[n] for n in ("q", "k", "v", "kv_mask", "out", "lse",
                                     "dout", "causal")} for a in bwd]
        plain_ms = cuda_ms(fa.flash_backward_plain, plain)
        backend, lib_ms = sdpa_backward_ms(torch, F, bwd)
        d_ms = delta_ms(torch, bwd)
        qbytes = 4.0 * B * H * T * d   # one [B,H,T,d] tensor
        rowbytes = 4.0 * B * H * T     # lse or delta
        kvb = 4.0 * d * (pairs / T if not bwd[0]["causal"]
                         else B * H * T)  # k/v rows read, each
        mb = 4.0 * B * T if bwd[0]["kv_mask"] is not None else 0.0
        # bytes and operations of each: B2 reads q, dO, k, v, lse, delta
        # (and the mask) and writes dk, dv, 8 flops per (pair, column); B3
        # writes dq, 6 flops. Bound at the split-TF32 tensor-core rate,
        # and beside it at the fp32 rate of the CUDA cores
        for name, nbytes, flops in (
                ("flash_bwd_dkv", 4 * qbytes + 2 * kvb + 2 * rowbytes + mb,
                 8.0 * pairs * d),
                ("flash_bwd_dq", 3 * qbytes + 2 * kvb + 2 * rowbytes + mb,
                 6.0 * pairs * d)):
            rows[name + suffix] = dict(
                shape=shape, ms=cuda_ms(getattr(fa, name), kern),
                plain_ms=plain_ms, library_ms=lib_ms, backend=backend,
                bound=bound(nbytes, flops, PEAK_TF32X3_FLOPS),
                bound_fp32=bound(nbytes, flops))
        pair_line("flash_bwd", shape, rows, suffix,
                  ("flash_bwd_dkv", "flash_bwd_dq"), d_ms, backend, lib_ms)

    bwd_rows("", kw_t, pairs_t, shape_t)
    bwd_rows("_causal", copies(tcases["train_causal"]),
             B * N_HEAD * T * (T + 1) / 2.0,
             "q/k/v [%d,%d,%d,%d], causal" % (B, N_HEAD, T, dh))
    # B1, B2, B3 at the Switch-Base-8 train step's self-attention
    kw_s = copies(dict(switch_flash_cases(torch, gen))["switch_self_masked"])
    rows["flash_fwd_switch"], pairs_s, shape_s = masked_fwd_row(kw_s)
    bwd_rows("_switch", kw_s, pairs_s, shape_s)
    return rows


def bf16_cases(torch, gen):
    """(name, kwargs for flash_forward) for the flash kernels' bf16
    entries, from a generator of their own: the train step's three calls
    ([64,8,256,64]: key mask, causal, cross), the encoder's shape, B1's
    multi-row tile edges and the tensor-core entries' own (head dims 32
    and 96, padded to 32 and 128; T and S apart and off multiples of 64;
    GQA with a window, causal rows and a key mask; a batch row with every
    key masked), each case's q, k and v in bf16."""
    dev = "cuda"
    enc = {n: torch.randn(1, N_HEAD, MAX_LEN, D_MODEL // N_HEAD,
                          generator=gen, device=dev) for n in ("q", "k", "v")}
    enc["kv_mask"] = (torch.arange(MAX_LEN, device=dev) < 197)[None].float()

    def case(B, H, Hkv, T, S, d, lengths=None, **opts):
        kw = {n: torch.randn(B, H if n == "q" else Hkv, T if n == "q" else S,
                             d, generator=gen, device=dev)
              for n in ("q", "k", "v")}
        if lengths is not None:
            kw["kv_mask"] = (torch.arange(S, device=dev)[None, :]
                             < torch.tensor(lengths, device=dev)[:, None]
                             ).float()
        return dict(kw, kv_group=H // Hkv, **opts)

    def edges():
        return [
            ("T90_S150_d32_gqa_masked",
             case(2, 8, 2, 90, 150, 32, [150, 61])),
            ("T200_S70_d128_cross", case(2, 4, 4, 200, 70, 128, [70, 33])),
            ("T150_gqa_window_causal",
             case(2, 8, 4, 150, 150, 64, [150, 100], causal=True,
                  window=50)),
            ("T33_S300_d96_dead_rows",
             case(3, 2, 2, 33, 300, 96, [300, 0, 65])),
            ("T45_d40_window_causal",
             case(2, 3, 3, 45, 45, 40, causal=True, window=16)),
        ]

    out = []
    # the edge cases draw last, so the others keep the data they had
    # before those were added
    for name, kw in (train_flash_cases(torch, gen)
                     + [("encoder_masked", enc)]
                     + flash_tile_cases(torch, gen) + edges()):
        out.append((name, {k: v.to(torch.bfloat16) if k in ("q", "k", "v")
                           else v for k, v in kw.items()}))
    return out


def bf16_check(name, got, ref):
    """(max abs error, the largest excess over one bf16 rounding step of
    the value plus K1_TOL): a bf16 output against its plain version."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    return (diff.max().item(),
            (diff - BF16_REL * r.abs() - K1_TOL).max().item())


def amp_kernel_phase(torch):
    """The flash kernels' bf16 entries (B1's tile path, the B2/B3 pair)
    against their plain versions on the card (module docstring, step
    15), then timed at the AMP train step's shapes beside the plain
    versions, ``scaled_dot_product_attention`` in bf16 and their bounds.
    Returns (worst max abs error by entry, timing rows)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels.build import device_limits

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    worst = {"flash_fwd_bf16": 0.0, "flash_bwd_dkv_bf16": 0.0,
             "flash_bwd_dq_bf16": 0.0}
    tol = "|err| <= 2^-7 |plain| + %.0e" % K1_TOL
    cases = bf16_cases(torch, gen)
    limits = device_limits("cuda")
    for name, kw in cases:
        B, H, T, d = kw["q"].shape
        Hkv, S = kw["k"].shape[1:3]
        print("plan flash_fwd_bf16 %-22s %s" % (name, fa.flash_bf16_plan(
            B, H, T, S, d, *limits)))
        bplan = fa.flash_bwd_plan(B, H, Hkv, T, S, d)
        print("plan flash_bwd_dkv_bf16 %-18s %s" % (name, bplan["dkv_bf16"]))
        print("plan flash_bwd_dq_bf16 %-19s %s" % (name, bplan["dq_bf16"]))
        out, lse = fa.flash_forward(**kw)
        ref, ref_lse = fa.flash_forward_plain(**kw)
        torch.cuda.synchronize()
        if out.dtype != torch.bfloat16 or lse.dtype != torch.float32:
            fail("flash_fwd_bf16 %s: out %s, lse %s" % (name, out.dtype,
                                                         lse.dtype))
        dead = ref_lse <= fa.MASKED_ROW_LSE
        if not torch.equal(lse <= fa.MASKED_ROW_LSE, dead):
            fail("flash_fwd_bf16 %s: dead rows differ" % name)
        if dead.any() and out[dead].abs().max().item() != 0.0:
            fail("flash_fwd_bf16 %s: a dead row is not exactly 0" % name)
        err, excess = bf16_check(name, out, ref)
        lse_err = ((lse - ref_lse)[~dead].abs().max().item()
                   if (~dead).any() else 0.0)
        print("kernel flash_fwd_bf16 %-22s max_abs_err %.3e (%s: excess "
              "%.2e)  lse %.3e (tol %.0e)  dead_rows %d"
              % (name, err, tol, excess, lse_err, K1_TOL, int(dead.sum())))
        if not (excess <= 0.0 and lse_err <= K1_TOL):
            fail("flash_fwd_bf16 %s: error above the tolerance" % name)
        worst["flash_fwd_bf16"] = max(worst["flash_fwd_bf16"], err)
    for name, kw in cases:
        args = bwd_inputs(torch, fa, kw, gen)
        args["dout"] = args["dout"].to(torch.bfloat16)
        dq, dk, dv = fa.flash_backward(**args)
        rq, rk, rv = fa.flash_backward_plain(**args)
        torch.cuda.synchronize()
        if {t.dtype for t in (dq, dk, dv)} != {torch.bfloat16}:
            fail("flash_bwd bf16 %s: gradients not bf16" % name)
        dead = args["lse"] <= fa.MASKED_ROW_LSE
        if dead.any() and dq[dead].abs().max().item() != 0.0:
            fail("flash_bwd_dq_bf16 %s: a dead row's dq is not exactly 0"
                 % name)
        m = args["kv_mask"]
        if m is not None and (m == 0).any():
            off = (m == 0)[:, None, :].expand(dk.shape[:3])
            if max(dk[off].abs().max().item(), dv[off].abs().max().item()):
                fail("flash_bwd_dkv_bf16 %s: a masked key's dk/dv is not "
                     "exactly 0" % name)
        e_k, x_k = bf16_check(name, dk, rk)
        e_v, x_v = bf16_check(name, dv, rv)
        e_q, x_q = bf16_check(name, dq, rq)
        print("kernel flash_bwd_dkv/dq_bf16 %-19s max_abs_err %.3e / %.3e "
              "(%s: excess %.2e / %.2e)" % (name, max(e_k, e_v), e_q, tol,
                                            max(x_k, x_v), x_q))
        if not max(x_k, x_v, x_q) <= 0.0:
            fail("flash_bwd bf16 %s: error above the tolerance" % name)
        worst["flash_bwd_dkv_bf16"] = max(worst["flash_bwd_dkv_bf16"], e_k,
                                          e_v)
        worst["flash_bwd_dq_bf16"] = max(worst["flash_bwd_dq_bf16"], e_q)

    # timed at the AMP train step's shapes: bytes at 2 a bf16 value (4
    # for the LSE, delta and the mask); a product of two bf16 operands at
    # the bf16 rate, one with a float32 operand (P, dS) as the two bf16
    # products its split (hi + lo) needs
    dh = D_MODEL // N_HEAD
    B, T = TRAIN_BATCH, MAX_LEN
    named = dict(cases)
    rows = {}
    qbytes = 2.0 * B * N_HEAD * T * dh     # one bf16 [B,H,T,d] tensor
    rowbytes = 4.0 * B * N_HEAD * T        # lse or delta
    mbytes = 4.0 * B * T
    kw_m = copies(named["train_self_masked"])
    vis = float(kw_m[0]["kv_mask"].sum())
    pairs_m = T * vis * N_HEAD
    pairs_c = B * N_HEAD * T * (T + 1) / 2.0
    shape_m = "bf16 q/k/v [%d,%d,%d,%d], key mask (%d of %d keys valid)" % (
        B, N_HEAD, T, dh, vis, B * T)
    shape_c = "bf16 q/k/v [%d,%d,%d,%d], causal" % (B, N_HEAD, T, dh)
    kw_c = copies(named["train_causal"])
    kw_e = copies(named["encoder_masked"])

    def sdpa_inputs(kws):
        return [dict(query=c["q"], key=c["k"], value=c["v"],
                     attn_mask=(c["kv_mask"] > 0)[:, None, None, :])
                for c in kws]

    for name, kws, pairs, shape, lib, nbytes in (
            ("flash_fwd_bf16_train", kw_m, pairs_m, shape_m,
             lambda: cuda_ms(F.scaled_dot_product_attention,
                             sdpa_inputs(kw_m)),
             2 * qbytes + 2 * 2.0 * vis * N_HEAD * dh + rowbytes + mbytes),
            ("flash_fwd_bf16_train_causal", kw_c, pairs_c, shape_c,
             lambda: cuda_ms(lambda q, k, v, causal:
                             F.scaled_dot_product_attention(
                                 q, k, v, is_causal=causal), kw_c),
             4 * qbytes + rowbytes),
            ("flash_fwd_bf16_encoder", kw_e, MAX_LEN * 197.0 * N_HEAD,
             "bf16 q/k/v [1,%d,256,%d], key mask (197 valid)" % (N_HEAD, dh),
             lambda: cuda_ms(F.scaled_dot_product_attention,
                             sdpa_inputs(kw_e)),
             2.0 * (2 * N_HEAD * MAX_LEN * dh + 2 * 197 * N_HEAD * dh)
             + 4.0 * (N_HEAD * MAX_LEN + MAX_LEN))):
        # Q K^T: 2 flops a (pair, column); P V: 2, twice (P split)
        rows[name] = dict(shape=shape, ms=cuda_ms(fa.flash_forward, kws),
                          plain_ms=cuda_ms(fa.flash_forward_plain, kws),
                          library_ms=lib(),
                          bound=bound(nbytes, 6.0 * pairs * dh,
                                      PEAK_BF16_FLOPS))

    def bwd_rows(suffix, kws, pairs, shape):
        bwd = []
        for c in kws:
            a = bwd_inputs(torch, fa, c, gen)
            a["dout"] = a["dout"].to(torch.bfloat16)
            a["delta"] = (a["dout"].float() * a["out"].float()).sum(dim=-1)
            bwd.append(a)
        kern = [dict(q=a["q"], k=a["k"], v=a["v"], kv_mask=a["kv_mask"],
                     dout=a["dout"], lse=a["lse"], delta=a["delta"],
                     causal=a["causal"], sm_scale=dh ** -0.5) for a in bwd]
        plain = [{n: a[n] for n in ("q", "k", "v", "kv_mask", "out", "lse",
                                     "dout", "causal")} for a in bwd]
        plain_ms = cuda_ms(fa.flash_backward_plain, plain)
        backend, lib_ms = sdpa_backward_ms(torch, F, bwd)
        d_ms = delta_ms(torch, bwd)
        kvb = 2.0 * dh * (pairs / T if not bwd[0]["causal"]
                          else B * N_HEAD * T)  # k/v rows read, each
        mb = mbytes if bwd[0]["kv_mask"] is not None else 0.0
        # B2 reads q, dO, k, v, lse, delta (and the mask) and writes dk,
        # dv: S and dP 2 flops each a (pair, column), dV and dK 2 each on
        # a float32 operand (P, dS): 2 + 2 + 4 + 4; B3 writes dq: S, dP
        # and dQ (dS float32): 2 + 2 + 4
        for name, nbytes, flops in (
                ("flash_bwd_dkv_bf16", 4 * qbytes + 2 * kvb + 2 * rowbytes
                 + mb, 12.0 * pairs * dh),
                ("flash_bwd_dq_bf16", 3 * qbytes + 2 * kvb + 2 * rowbytes
                 + mb, 8.0 * pairs * dh)):
            entry = name.replace("_bf16", "")
            rows[name + suffix] = dict(
                shape=shape, ms=cuda_ms(getattr(fa, entry), kern),
                plain_ms=plain_ms, library_ms=lib_ms, backend=backend,
                bound=bound(nbytes, flops, PEAK_BF16_FLOPS))
        pair_line("flash_bwd_bf16", shape, rows, suffix,
                  ("flash_bwd_dkv_bf16", "flash_bwd_dq_bf16"), d_ms, backend,
                  lib_ms)

    bwd_rows("", kw_m, pairs_m, shape_m)
    bwd_rows("_causal", kw_c, pairs_c, shape_c)
    for name, r in rows.items():
        lib = "%.4f ms" % r["library_ms"]
        if r.get("backend"):
            lib += (" (backward of scaled_dot_product_attention in bf16, "
                    "backend %s, device time; the pair)" % r["backend"])
        else:
            lib += " (scaled_dot_product_attention in bf16)"
        print("time %-30s %s: kernel %.4f ms, plain %.4f ms%s, library %s, "
              "bound %.4f ms (%s: bytes at 3.35 TB/s, bf16 products at 989 "
              "TFLOP/s, a float32 operand as its two-term split)"
              % (name, r["shape"], r["ms"], r["plain_ms"],
                 " (the pair)" if r.get("backend") else "", lib,
                 r["bound"][0], r["bound"][1]))
    return worst, rows


@contextlib.contextmanager
def blocks_per_sm(n):
    """Inside the block, the split-KV core's plans (``tree_plan``,
    ``flash_rows_plan``) aim at ``n`` blocks an SM (0: one split a (row
    group, head)) instead of ``decode_split.BLOCKS_PER_SM``."""
    from paddle_tpu_torch.kernels import decode_split

    kept = decode_split.BLOCKS_PER_SM
    decode_split.BLOCKS_PER_SM = n
    try:
        yield
    finally:
        decode_split.BLOCKS_PER_SM = kept


def split_phase(torch):
    """B1's rows path and B5 timed, in this run, at the split their plan
    picks and at another: where the plans split the keys (one sequence's
    decode and verify, a 4-slot verify: fewer (row group, head) pairs
    than SMs) against one split, and at the main shapes (one split)
    against ``paged_plan``'s 4 blocks an SM. Inputs from a generator of
    their own, in copies over 64 MB (past the L2 cache); both plans'
    outputs agree within K1_TOL / K5_TOL. Returns (label, shape, [(splits,
    blocks an SM, ms)] with the plan's first) rows."""
    from paddle_tpu_torch.kernels import decode_split
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels.build import device_limits

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    limits = device_limits("cuda")
    dh, N = D_MODEL // N_HEAD, SPEC_K + 1

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def flash_kw(B, T, src_lens):
        mask = torch.zeros(B, MAX_LEN, device="cuda")
        for b, n in enumerate(src_lens):
            mask[b, :n] = 1.0
        return dict(q=rnd(B, N_HEAD, T, dh), k=rnd(B, N_HEAD, MAX_LEN, dh),
                    v=rnd(B, N_HEAD, MAX_LEN, dh), kv_mask=mask)

    def flash_splits(kw):
        B, H, T, d = kw["q"].shape
        return fa.flash_rows_plan(B, H, T, MAX_LEN, d, *limits)["splits"]

    def tree_splits(kw):
        S, H, n, d = kw["q"].shape
        return pa.tree_plan(S, H, n, kw["page_table"].shape[1], PAGE_SIZE,
                            d, *limits)["splits"]

    src = torch.randint(16, MAX_LEN + 1, (NUM_SLOTS,), generator=gen,
                        device="cuda").tolist()
    bases = [int(x) for x in torch.randint(0, MAX_LEN - N + 1, (NUM_SLOTS,),
                                           generator=gen, device="cuda")]
    cases = [
        ("flash_fwd decode, one sequence", fa.flash_forward,
         flash_kw(1, 1, [MAX_LEN]), flash_splits, 0, K1_TOL),
        ("flash_fwd verify, one sequence", fa.flash_forward,
         flash_kw(1, N, [MAX_LEN]), flash_splits, 0, K1_TOL),
        ("tree_decode, 4 slots", pa.paged_tree_attention,
         tree_case(torch, gen, 4, N_HEAD, N, dh, PAGE_SIZE, MAX_LEN,
                   [MAX_LEN - N, 200, 150, 100]), tree_splits, 0, K5_TOL),
        ("flash_fwd decode, main shape", fa.flash_forward,
         flash_kw(NUM_SLOTS, 1, src), flash_splits, 4, K1_TOL),
        ("flash_fwd verify, main shape", fa.flash_forward,
         flash_kw(NUM_SLOTS, N, src), flash_splits, 4, K1_TOL),
        ("tree_decode, main shape", pa.paged_tree_attention,
         tree_case(torch, gen, NUM_SLOTS, N_HEAD, N, dh, PAGE_SIZE, MAX_LEN,
                   bases), tree_splits, 4, K5_TOL),
    ]
    rows = []
    for label, fn, kw, splits_of, other, tol in cases:
        nbytes = sum(v.numel() * v.element_size() for v in kw.values()
                     if isinstance(v, torch.Tensor))
        kws = copies(kw, max(3, -(-64 * 2 ** 20 // nbytes)))
        first = fn(**kw)
        plans = [(splits_of(kw), decode_split.BLOCKS_PER_SM,
                  cuda_ms(fn, kws, iters=max(30, len(kws))))]
        with blocks_per_sm(other):
            second = fn(**kw)
            plans.append((splits_of(kw), other,
                          cuda_ms(fn, kws, iters=max(30, len(kws)))))
        err = (first[0] if isinstance(first, tuple) else first).sub(
            second[0] if isinstance(second, tuple) else second).abs().max()
        if plans[0][0] == plans[1][0] or float(err) > tol:
            fail("split %s: splits %s, the two plans' outputs %.3g apart "
                 "(tolerance %g)" % (label, [p[0] for p in plans],
                                     float(err), tol))
        rows.append((label, "q %s" % list(kw["q"].shape), plans))
    return rows


# -- the threefry kernel ----------------------------------------------------------

def threefry_bound(n, mode, out_bytes):
    """``bound`` of one threefry draw of ``n`` counters: the output's
    bytes written (the key and row data are a few bytes) against the
    busier pipe, the integer operations at the INT32 rate or the float
    ones at the FP32 rate."""
    int_ops, float_ops = THREEFRY_MODE_OPS[mode]
    t_int = n * (THREEFRY_HASH_OPS + int_ops) / PEAK_INT32_OPS
    t_float = n * float_ops / PEAK_FP32_OPS
    # bound() divides by the rate: hand it the busier pipe's time
    return bound(n * out_bytes + 16, max(t_int, t_float), 1.0)


def rng_chains(torch, prng):
    """(label, key chain, n) cases: one key on the card with the
    executor's two folds (step, op id), at 2**25 counters and an odd
    count; the sampler's 32 rows (a host key, the slot and the position
    folded per row) at the vocabulary and an odd count."""
    dev = torch.device("cuda")
    base = prng.PRNGKey(TRAIN_SEED, device=dev)
    run_chain = prng.KeyChain(base).fold_in(3).fold_in(17)
    slots = torch.arange(NUM_SLOTS, device=dev)
    pos = (slots * 37 + 5) % MAX_LEN
    slot_chain = prng.KeyChain(prng.PRNGKey_pair(SAMPLED["seed"])).fold_in(
        slots).fold_in(pos)
    return [("K 1, n %d" % RNG_BIG_N, run_chain, RNG_BIG_N),
            ("K 1, n 1000003", run_chain, 1000003),
            ("K %d, n %d" % (NUM_SLOTS, VOCAB), slot_chain, VOCAB),
            ("K %d, n 4099" % NUM_SLOTS, slot_chain, 4099)]


def rng_phase(torch):
    """The threefry kernel against its plain version on the card, bit
    for bit (bits, uniform, bernoulli; keys and split's keys), the plain
    version on the card against the CPU, and the timed rows: the train
    step's dropout site and the sampler's draw. Returns (worst error,
    timing)."""
    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.kernels import threefry as kt

    modes = (("bits", prng.MODE_BITS, {}),
             ("uniform", prng.MODE_UNIFORM, dict(lo=-0.5, hi=2.0)),
             ("bernoulli", prng.MODE_BERNOULLI,
              dict(p=0.9, dtype=torch.float32)))
    worst = 0.0
    for label, chain, n in rng_chains(torch, prng):
        for mode, code, kw in modes:
            got = kt.threefry_draw(chain, n, code, **kw)
            want = prng.plain_draw(chain, n, code, **kw)
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            if got.dtype == torch.int64:
                err = float((got - want).abs().max())
            else:
                err = float((got.double() - want.double()).abs().max())
            worst = max(worst, err)
            print("threefry %-18s %-9s kernel against plain: equal %s, max "
                  "abs err %.1e (tol 0: bit for bit)" % (label, mode, equal,
                                                        err))
            if not equal:
                fail("threefry %s %s: the kernel differs from its plain "
                     "version" % (label, mode))
        # keys, and split's keys: a row fold of 0..6 of each row's key
        keys = prng.plain_draw(chain, 1, prng.MODE_KEY)
        rows = keys.shape[0]
        split_chain = prng.KeyChain(keys.repeat_interleave(7, dim=0), (), (
            torch.arange(7, device=keys.device).repeat(rows),))
        for mode, got, want in (
                ("keys", kt.threefry_draw(chain, 1, prng.MODE_KEY), keys),
                ("split", prng.split(chain, 7).reshape(-1, 2),
                 prng.plain_draw(split_chain, 1, prng.MODE_KEY))):
            if not torch.equal(got, want):
                fail("threefry %s %s: the kernel differs from its plain "
                     "version" % (label, mode))
    # the plain version on the card against the CPU's
    for label, chain, n in rng_chains(torch, prng)[1:3]:
        cpu = prng.KeyChain(
            chain.base.cpu() if isinstance(chain.base, torch.Tensor)
            else chain.base, chain.folds, [t.cpu() for t in chain.row_data])
        for mode, code, kw in modes:
            card = prng.plain_draw(chain, n, code, **kw).cpu()
            if not torch.equal(card, prng.plain_draw(cpu, n, code, **kw)):
                fail("threefry %s %s: the plain version's draw on the card "
                     "differs from the CPU's" % (label, mode))
    print("threefry: the plain version's bits, uniforms and masks on the "
          "card equal the CPU's")
    # timed rows: the train step's dropout site, the sampler's draw and a
    # Switch-Base-8 dropout site
    dev = torch.device("cuda")
    site = 1
    for d in DROPOUT_SITE:
        site *= d
    run_chain = prng.KeyChain(prng.PRNGKey(TRAIN_SEED, device=dev)).fold_in(
        0).fold_in(5)
    slot_chain = rng_chains(torch, prng)[2][1]
    rows = {}
    for name, chain, n, code, kw, mode, out_bytes, shape in (
            ("threefry", run_chain, site, prng.MODE_BERNOULLI,
             dict(p=1.0 - DROPOUT, dtype=torch.float32), "bernoulli", 4,
             "dropout mask [%d,%d,%d] float32, one key, 2 folds"
             % DROPOUT_SITE),
            ("threefry_sampler", slot_chain, VOCAB, prng.MODE_UNIFORM,
             dict(lo=prng.TINY, hi=1.0), "uniform", 4,
             "Gumbel uniforms [%d,%d], %d keys, 2 row folds"
             % (NUM_SLOTS, VOCAB, NUM_SLOTS)),
            ("threefry_switch", run_chain, SW_BATCH * SW_LEN * SW_D,
             prng.MODE_BERNOULLI, dict(p=1.0 - SW_DROPOUT,
                                       dtype=torch.float32), "bernoulli", 4,
             "dropout mask [%d,%d,%d] float32, one key, 2 folds (a "
             "Switch-Base-8 dropout site)" % (SW_BATCH, SW_LEN, SW_D))):
        ms = cuda_ms(lambda chain, n=n, code=code, kw=kw:
                     kt.threefry_draw(chain, n, code, **kw), [dict(chain=chain)])
        plain_ms = eager_ms(lambda i, chain=chain, n=n, code=code, kw=kw:
                            prng.plain_draw(chain, n, code, **kw), [0],
                            iters=3)
        counters = n * chain.rows()
        philox_ms = cuda_ms(lambda counters=counters: torch.rand(
            counters, device=dev), [{}])
        rows[name] = dict(shape=shape, ms=ms, plain_ms=plain_ms,
                          library_ms=None, philox_ms=philox_ms,
                          bound=threefry_bound(counters, mode, out_bytes))
    # random_data_generator at the graph-data ResNet-50 step: its three
    # draws (the pixels' uniforms, the labels' two words of bits), keyed
    # as the op keys them (run, op, slot, and the labels' split)
    pix = RESNET_BATCH * 3 * RESNET_IMG * RESNET_IMG
    data_chain = prng.KeyChain(prng.PRNGKey(RESNET_SEED, device=dev)).fold_in(
        2).fold_in(1)

    def data_draws(chain, draw):
        draw(chain.fold_in(0), pix, prng.MODE_UNIFORM, lo=0.0, hi=1.0)
        labels = chain.fold_in(1)
        draw(labels.fold_in(0), RESNET_BATCH, prng.MODE_BITS)
        draw(labels.fold_in(1), RESNET_BATCH, prng.MODE_BITS)

    b_pix = threefry_bound(pix, "uniform", 4)
    b_lab = threefry_bound(RESNET_BATCH, "bits", 8)
    rows["threefry_graph_data"] = dict(
        shape="random_data_generator: pixels [%d,3,%d,%d] uniform, labels "
        "[%d,1] (two draws of bits): the three launches of a step"
        % (RESNET_BATCH, RESNET_IMG, RESNET_IMG, RESNET_BATCH),
        ms=cuda_ms(lambda chain: data_draws(chain, kt.threefry_draw),
                   [dict(chain=data_chain)]),
        plain_ms=eager_ms(lambda i: data_draws(data_chain, prng.plain_draw),
                          [0], iters=3),
        library_ms=None,
        philox_ms=cuda_ms(lambda: torch.rand(pix, device=dev), [{}]),
        bound=(b_pix[0] + 2 * b_lab[0], b_pix[1]))
    for name, r in rows.items():
        print("time %-20s %s: kernel %.4f ms, plain %.4f ms, library none "
              "(torch.rand, Philox, another generator: %.4f ms), bound "
              "%.4f ms (%s: INT32 at %.1f TOP/s beside FP32 at %.1f T "
              "instructions/s)"
              % (name, r["shape"], r["ms"], r["plain_ms"], r["philox_ms"],
                 r["bound"][0], r["bound"][1], PEAK_INT32_OPS / 1e12,
                 PEAK_FP32_OPS / 1e12))
    return worst, rows


def kernel_counts(kernels):
    """Every kernel's launch count since its reset and, beside them, the
    flash kernels' by shape class (``flash_fwd/decode`` T = 1,
    ``/verify`` T <= 4, else ``/causal`` or ``/full``; the same for
    ``flash_bwd_dkv`` and ``flash_bwd_dq`` and the bf16 entries) from the
    counts their wrappers keep by (T, causal) where they launch."""
    out = {name: k.launches for name, k in kernels.items()}
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                 "flash_fwd_bf16", "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16"):
        for (t, causal), n in sorted(kernels[name].by_key.items()):
            label = name + "/" + ("decode" if t == 1 else "verify" if t <= 4
                                  else "causal" if causal else "full")
            out[label] = out.get(label, 0) + n
    return out


# -- session phases -------------------------------------------------------------

def build_model(fluid, exe, scope, n_layer=N_LAYER):
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.testing import set_deterministic_params

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard({}), fluid.program_guard(main, startup):
        transformer.build(src_vocab_size=VOCAB, trg_vocab_size=VOCAB,
                          max_length=MAX_LEN, n_layer=n_layer, n_head=N_HEAD,
                          d_model=D_MODEL, d_inner=D_INNER, dropout=0.0,
                          label_smooth_eps=0.0)
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope)
    return main


def session(exe, scope, num_slots, sampler=None):
    from paddle_tpu_torch.serving.generation import SlotDecodeSession

    return SlotDecodeSession(
        exe, num_slots=num_slots, max_length=MAX_LEN, d_model=D_MODEL,
        paged=True, page_size=PAGE_SIZE, steps=STEPS, eos_id=EOS,
        scope=scope, src_vocab_size=VOCAB, trg_vocab_size=VOCAB,
        n_layer=N_LAYER, n_head=N_HEAD, d_inner=D_INNER, sampler=sampler)


def requests(np):
    rng = np.random.RandomState(SEED)
    lens = rng.randint(16, MAX_LEN + 1, N_REQUESTS)
    src = rng.randint(3, VOCAB, (N_REQUESTS, MAX_LEN)).astype("int64")
    for i, n in enumerate(lens):
        src[i, n:] = EOS
    # every 8th request forces a 4-token decoder prefix: the causal
    # flash path of the prefill program
    prefixes = [list(rng.randint(3, VOCAB, 4)) if i % 8 == 0 else None
                for i in range(N_REQUESTS)]
    return src, lens.astype("int64"), prefixes


def generated_tokens(row, prefix):
    """Tokens a finished bos-led row decoded past its forced prefix:
    through the first eos, or to the end of the budget."""
    start = 1 + (len(prefix) if prefix else 0)
    for j in range(start, len(row)):
        if int(row[j]) == EOS:
            return j - start + 1
    return len(row) - start


def run_requests(np, torch, sess, kernels, src, lens, prefixes):
    """Serve the requests through ``sess`` (enqueue all, pump until every
    result is taken) with every kernel's launch count set to 0 just
    before. Returns (token matrix, wall seconds, launches, peak pages)."""
    n = len(src)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    order = {sess.enqueue(src[i], lens[i], prefixes[i]): i for i in range(n)}
    out = np.full((n, MAX_LEN), EOS, dtype="int64")
    want, peak_pages = set(order), 0
    while want:
        sess.pump()
        peak_pages = max(peak_pages, sess.pages_in_use)
        for rid in list(want):
            tokens = sess.take_result(rid)
            if tokens is not None:
                out[order[rid]] = tokens
                want.discard(rid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, kernel_counts(kernels), peak_pages


def step_timer(sess):
    """Wrap ``sess.step``: the host seconds of each call go to the list
    returned (a captured step's call includes the replay and the wait
    for its [K, S, 1] token fetch, and so the device time of the
    admissions queued before it). Inside it, the seconds of the COW /
    rebind dispatch and of the token bookkeeping add up in ``.split``."""
    times, step = StepTimes(), sess.step

    def wrap(attr, key):
        fn = getattr(sess, attr)

        def timed(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                times.split[key] += time.perf_counter() - t0

        setattr(sess, attr, timed)

    def timed_step():
        t0 = time.perf_counter()
        try:
            return step()
        finally:
            times.append(time.perf_counter() - t0)

    sess.step = timed_step
    wrap("_dispatch_cow", "cow")
    wrap("_consume_tokens", "tokens")
    return times


class StepTimes(list):
    """Host seconds of each ``step()`` call, and ``split``: the seconds
    of the COW / rebind dispatch and of the token bookkeeping in them."""

    def __init__(self):
        super(StepTimes, self).__init__()
        self.split = {"cow": 0.0, "tokens": 0.0}

    def line(self):
        n = max(len(self), 1)
        cow, tok = self.split["cow"], self.split["tokens"]
        return ("host ms per step(): COW and rebind dispatch %.3f, token "
                "bookkeeping %.3f, the rest (program: replay or eager loop, "
                "token fetch, admissions' device time) %.3f"
                % (1e3 * cow / n, 1e3 * tok / n,
                   1e3 * (sum(self) - cow - tok) / n))


def paged_run(np, torch, exe, scope, kernels, reqs, label, sampler=None):
    """Serve ``reqs`` through a fresh paged session (steps 8; greedy, or
    ``sampler``) in a child scope, counts reset just before
    (``run_requests``). Prints one line; returns the run's numbers."""
    src, lens, prefixes = reqs
    sess = session(exe, scope.new_scope(), NUM_SLOTS, sampler)
    times = step_timer(sess)
    eager0 = exe.eager_multi_step
    out, wall, launches, peak = run_requests(np, torch, sess, kernels, src,
                                             lens, prefixes)
    generated = sum(generated_tokens(out[i], prefixes[i])
                    for i in range(len(src)))
    held = exe.graph_stats(sess.step_program)
    r = dict(out=out, wall=wall, launches=launches, peak=peak, sess=sess,
             generated=generated, eager=exe.eager_multi_step - eager0,
             step_ms=1e3 * float(np.mean(times)),
             step_ms_median=1e3 * float(np.median(times)),
             graphs=held["graphs"], pool_bytes=held["pool_bytes"])
    print("%s: wall %.3f s, %d decode steps in %d step() calls, %d tokens, "
          "decode %.1f tokens/s; host %.3f ms per step() (median %.3f); "
          "graphs captured %d, their pool %d bytes; eager run_multi_step "
          "calls %d" % (label, wall, sess.decode_steps, sess.steps_done,
                        generated, generated / wall, r["step_ms"],
                        r["step_ms_median"], r["graphs"], r["pool_bytes"],
                        r["eager"]))
    print("%s: %s; %d COW / rebind dispatches" % (label, times.line(),
                                                  sess.cow_dispatches))
    return r


def serve_phase(np, torch, exe, scope, kernels):
    src, lens, prefixes = reqs = requests(np)
    r = paged_run(np, torch, exe, scope, kernels, reqs, "session (captured)")
    out, wall, launches, sess = r["out"], r["wall"], r["launches"], r["sess"]
    n_prefix = sum(p is not None for p in prefixes)
    print("session: %d requests, %d slots, page_size %d, steps %d: wall %.3f s, "
          "%d decode steps in %d step() calls, %d tokens, decode %.1f tokens/s"
          % (N_REQUESTS, NUM_SLOTS, PAGE_SIZE, STEPS, wall, sess.decode_steps,
             sess.steps_done, r["generated"], r["generated"] / wall))
    print("session: kernel launches %s" % json.dumps(launches))
    print("session: page pool peak %d of %d pages in use; after drain %d in "
          "use, conserved %s" % (r["peak"], sess.free_pages +
                                 sess.pages_in_use, sess.pages_in_use,
                                 sess.pool_conserved))
    expect_k2 = N_LAYER * sess.decode_steps
    expect_k1 = (N_REQUESTS * N_LAYER + N_LAYER * sess.decode_steps
                 + 2 * (N_LAYER - 1) * n_prefix)
    if launches["paged_decode"] != expect_k2:
        fail("paged_decode launched %d times, expected n_layer x decode "
             "steps = %d" % (launches["paged_decode"], expect_k2))
    if launches["flash_fwd"] != expect_k1 or expect_k1 <= 0:
        fail("flash_fwd launched %d times, expected %d"
             % (launches["flash_fwd"], expect_k1))
    if sess.pages_in_use != 0 or not sess.pool_conserved:
        fail("the page pool did not drain")
    if not ((out >= 0) & (out < VOCAB)).all() or not (out[:, 0] == 1).all():
        fail("token matrix out of range or not bos-led")
    for i, p in enumerate(prefixes):
        if p is not None and list(out[i, 1:5]) != [int(t) for t in p]:
            fail("request %d lost its forced prefix" % i)
    return r


def graph_phase(np, torch, exe, scope, kernels, captured):
    """The serve phase's requests again on the same weights with
    ``FLAGS_cuda_graph=0`` (the eager loop on the card): the captured
    run's streams and launches must equal the eager run's, and no
    run_multi_step of the captured run ran eager."""
    from paddle_tpu_torch import flags

    flags.set_flag("cuda_graph", "0")
    try:
        eager = paged_run(np, torch, exe, scope, kernels, requests(np),
                          "graph eager (FLAGS_cuda_graph=0)")
    finally:
        flags.set_flag("cuda_graph", "1")
    c, e = captured, eager
    print("graph captured: wall %.3f s, decode %.1f tokens/s, host %.3f ms "
          "per step() (median %.3f), %d graphs, pool %d bytes, eager "
          "run_multi_step calls %d"
          % (c["wall"], c["generated"] / c["wall"], c["step_ms"],
             c["step_ms_median"], c["graphs"], c["pool_bytes"], c["eager"]))
    print("graph eager:    wall %.3f s, decode %.1f tokens/s, host %.3f ms "
          "per step() (median %.3f), %d graphs, pool %d bytes, eager "
          "run_multi_step calls %d"
          % (e["wall"], e["generated"] / e["wall"], e["step_ms"],
             e["step_ms_median"], e["graphs"], e["pool_bytes"], e["eager"]))
    same = int(sum((c["out"][i] == e["out"][i]).all()
                   for i in range(N_REQUESTS)))
    steps_c, steps_e = c["sess"].decode_steps, e["sess"].decode_steps
    per_step = {n: (c["launches"].get(n, 0) / max(steps_c, 1),
                    e["launches"].get(n, 0) / max(steps_e, 1))
                for n in ("paged_decode", "flash_fwd/decode")}
    print("graph: %d of %d streams equal; decode steps %d and %d; launches "
          "per decode step (captured, eager) %s; captured run's eager "
          "run_multi_step calls %d" % (same, N_REQUESTS, steps_c, steps_e,
                                       json.dumps(per_step), c["eager"]))
    if same != N_REQUESTS:
        fail("graph: %d of %d streams differ between the captured and the "
             "eager loop" % (N_REQUESTS - same, N_REQUESTS))
    if steps_c != steps_e or c["launches"] != e["launches"]:
        fail("graph: launches differ: captured %s over %d decode steps, "
             "eager %s over %d" % (json.dumps(c["launches"]), steps_c,
                                   json.dumps(e["launches"]), steps_e))
    if c["eager"] != 0 or c["graphs"] != 1:
        fail("graph: the captured run ran %d eager run_multi_step calls and "
             "holds %d graphs (want 0 and 1)" % (c["eager"], c["graphs"]))
    if e["eager"] != e["sess"].steps_done or e["graphs"] != 0:
        fail("graph: the eager run counted %d eager calls for %d step() "
             "calls and holds %d graphs" % (e["eager"], e["sess"].steps_done,
                                            e["graphs"]))
    graph_profile_phase(np, torch, exe, scope)
    return eager["launches"]


def sampled_margin(np, torch, exe, scope, reqs, i, row, p, slot, sampler):
    """The sequential path's top-2 margin of the sampler's perturbed
    logits for request ``i`` at token position ``p`` in ``slot``: the
    tokens before ``p`` are forced as a prefix, the first decode step's
    logits are read, scaled and cut as ``sample_step_tokens`` does, and
    the Gumbel noise of the key ``(seed, slot, p - 1)`` (the position the
    token is sampled at) is added. Returns (margin, the perturbed
    logits' argmax: the token the sequential path sampled)."""
    from paddle_tpu_torch.core import prng

    src, lens, _ = reqs
    sess_scope = scope.new_scope()
    sess = session(exe, sess_scope, 1)
    sess.admit(src[i], lens[i], prefix_tokens=[int(t) for t in row[1:p]])
    (lg,) = exe.run(sess.step_program,
                    fetch_list=[logits_name(sess.step_program)],
                    scope=sess_scope)
    lg = torch.from_numpy(np.asarray(lg, dtype="float32").reshape(1, -1))
    inv = np.float32(1.0) / np.float32(sampler.temperature)
    scaled = lg * torch.tensor(float(inv))
    if sampler.strategy == "top_k":
        kth = torch.topk(scaled, sampler.top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, torch.full_like(
            scaled, float("-inf")), scaled)
    key = prng.KeyChain(prng.PRNGKey_pair(sampler.seed)).fold_in(
        int(slot)).fold_in(int(p) - 1)
    pert = (scaled.reshape(-1) + prng.gumbel(key, (VOCAB,))).numpy()
    top = np.sort(pert)[-2:]
    return float(top[1] - top[0]), int(np.argmax(pert))


def sampled_phase(np, torch, exe, scope, kernels, greedy_out):
    """Sampled serving (module docstring, step 4): the serve phase's
    configuration with ``Sampler(**SAMPLED)`` over its first requests,
    captured against ``FLAGS_cuda_graph=0``; then speculation (n-gram
    drafter) against the sequential sampled stream. Returns
    {window: launches}."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.serving.generation import Sampler

    sampler = Sampler(**SAMPLED)
    src, lens, prefixes = requests(np)
    n = SAMPLED_REQUESTS
    reqs = (src[:n], lens[:n], prefixes[:n])
    runs = {}
    for label, graph in (("captured", "1"), ("eager", "0")):
        flags.set_flag("cuda_graph", graph)
        try:
            runs[label] = paged_run(
                np, torch, exe, scope, kernels, reqs,
                "sampled %s (%s)" % (label, "FLAGS_cuda_graph=%s" % graph),
                sampler=sampler)
        finally:
            flags.set_flag("cuda_graph", "1")
    c, e = runs["captured"], runs["eager"]
    same = int(sum((c["out"][i] == e["out"][i]).all() for i in range(n)))
    unlike_greedy = int(sum((c["out"][i] != greedy_out[i]).any()
                            for i in range(n)))
    sess = c["sess"]
    n_prefix = sum(q is not None for q in prefixes[:n])
    expect = {"paged_decode": N_LAYER * sess.decode_steps,
              "flash_fwd": (n * N_LAYER + N_LAYER * sess.decode_steps
                            + 2 * (N_LAYER - 1) * n_prefix),
              "threefry": sess.decode_steps}
    print("sampled: %s, %d requests: captured %.1f tokens/s, eager %.1f "
          "tokens/s (%.2fx); %d of %d streams equal between them; %d differ "
          "from the greedy streams; launches %s (expected %s); captured "
          "run's eager run_multi_step calls %d, graphs %d"
          % (json.dumps(SAMPLED), n, c["generated"] / c["wall"],
             e["generated"] / e["wall"],
             (c["generated"] / c["wall"]) / (e["generated"] / e["wall"]),
             same, n, unlike_greedy, json.dumps(c["launches"]),
             json.dumps(expect), c["eager"], c["graphs"]))
    if same != n:
        fail("sampled: %d of %d streams differ between the captured and the "
             "eager loop" % (n - same, n))
    if c["launches"] != e["launches"]:
        fail("sampled: launches differ: captured %s, eager %s"
             % (json.dumps(c["launches"]), json.dumps(e["launches"])))
    for name, want in expect.items():
        if c["launches"].get(name) != want:
            fail("sampled: %s launched %s times, expected %d"
                 % (name, c["launches"].get(name), want))
    if c["eager"] != 0 or c["graphs"] != 1:
        fail("sampled: the captured run ran %d eager run_multi_step calls "
             "and holds %d graphs (want 0 and 1)" % (c["eager"], c["graphs"]))
    if not unlike_greedy:
        fail("sampled: every sampled stream equals the greedy one")
    if sess.pages_in_use != 0 or not sess.pool_conserved:
        fail("sampled: the page pool did not drain")

    m = SAMPLED_SPEC_REQUESTS
    sreqs = (src[:m], lens[:m], prefixes[:m])
    off, off_l, off_sess = spec_run(np, torch, flags, exe, scope, kernels,
                                    "s-off", "ngram", sreqs, mode="off",
                                    sampler=sampler)
    on, on_l, on_sess = spec_run(np, torch, flags, exe, scope, kernels,
                                 "s-ngram", "ngram", sreqs, sampler=sampler)
    if off_l["threefry"] != off_sess.decode_steps:
        fail("sampled spec off: threefry launched %d times for %d decode "
             "steps" % (off_l["threefry"], off_sess.decode_steps))
    if on_l["threefry"] != (SPEC_K + 1) * on_sess.spec_dispatches:
        fail("sampled spec: threefry launched %d times, expected k + 1 = %d "
             "per verify dispatch x %d" % (on_l["threefry"], SPEC_K + 1,
                                           on_sess.spec_dispatches))
    differing = [i for i in range(m) if (on[i] != off[i]).any()]
    print("sampled spec: %d of %d requests stream the sequential sampled "
          "stream's tokens" % (m - len(differing), m))
    for i in differing:
        p = int(np.argmax(on[i] != off[i]))
        slot = off_sess.slot_of[i]
        if on_sess.slot_of[i] != slot:
            fail("sampled spec: request %d took slot %d, the sequential run "
                 "slot %d" % (i, on_sess.slot_of[i], slot))
        margin, choice = sampled_margin(np, torch, exe, scope, sreqs, i,
                                        off[i], p, slot, sampler)
        print("sampled spec: request %d differs first at position %d (%d "
              "against %d); the sequential path's perturbed-logit top-2 "
              "margin there is %.3e (tol %.0e), its argmax %d"
              % (i, p, on[i][p], off[i][p], margin, MARGIN_TOL, choice))
        if not margin <= MARGIN_TOL:
            fail("sampled spec: request %d left the sequential sampled "
                 "stream at a position with a clear choice (margin %.3e)"
                 % (i, margin))
    return {"captured": c["launches"], "eager": e["launches"],
            "spec_off": off_l, "spec": on_l}


def graph_profile_phase(np, torch, exe, scope, warm_steps=3):
    """One captured step() of a full session (32 live slots, mid-stream,
    its pages provisioned just before, so no COW / rebind dispatch in
    it) under the profiler: the replay of 8 decode steps and the token
    fetch, the device's busy share of it."""
    src, lens, _ = requests(np)
    sess = session(exe, scope.new_scope(), NUM_SLOTS)
    for i in range(NUM_SLOTS):
        sess.admit(src[i], lens[i])
    for _ in range(warm_steps):
        sess.step()
    sess._dispatch_cow(sess._cow_window(
        [(slot, st["pos"]) for slot, st in sess._live.items()]))
    if exe.graph_stats(sess.step_program)["graphs"] != 1:
        fail("graph profile: the session's step is not captured")
    profile_call(torch, "graph captured step()", sess.step, top=6)


def prefix_session(exe, scope, cache_pages):
    from paddle_tpu_torch.serving.generation import SlotDecodeSession

    return SlotDecodeSession(
        exe, num_slots=NUM_SLOTS, max_length=MAX_LEN, d_model=D_MODEL,
        paged=True, page_size=PAGE_SIZE, steps=STEPS, eos_id=EOS,
        scope=scope, prefix_cache_pages=cache_pages, src_vocab_size=VOCAB,
        trg_vocab_size=VOCAB, n_layer=N_LAYER, n_head=N_HEAD,
        d_inner=D_INNER)


def prefix_phase(np, torch, exe, scope, kernels):
    """One source admitted PREFIX_ADMISSIONS times with a forced prefix of
    PREFIX_FORCED tokens, through a session with the prefix cache and one
    without: equal streams, 15 hits in 16 lookups, 32 tokens saved a hit,
    and the pool drains after clear_prefix_cache()."""
    src, lens, _ = requests(np)
    pfx = [int(t) for t in
           np.random.RandomState(SEED + 5).randint(3, VOCAB, PREFIX_FORCED)]
    full_pages = PREFIX_FORCED // PAGE_SIZE
    runs, total = {}, {}
    for label, pages in (("cached", PREFIX_CACHE_PAGES), ("uncached", 0)):
        sess = prefix_session(exe, scope.new_scope(), pages)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.reset()
        t0 = time.perf_counter()
        admit_s, slots = [], []
        for _ in range(PREFIX_ADMISSIONS):
            ta = time.perf_counter()
            slots.append(sess.admit(src[0], lens[0], prefix_tokens=pfx))
            admit_s.append(time.perf_counter() - ta)
        outs = {}
        while len(outs) < PREFIX_ADMISSIONS:
            outs.update(sess.step())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts(kernels)
        for n, v in launches.items():
            total[n] = total.get(n, 0) + v
        runs[label] = (sess, np.stack([outs[s] for s in slots]), admit_s)
        print("prefix %s: %d admissions of one source with %d forced tokens "
              "(%d full pages of %d): wall %.3f s; admission host ms: first "
              "%.3f, the rest median %.3f; %d decode steps; stats %s; "
              "kernel launches %s"
              % (label, PREFIX_ADMISSIONS, PREFIX_FORCED, full_pages,
                 PAGE_SIZE, wall, 1e3 * admit_s[0],
                 1e3 * float(np.median(admit_s[1:])), sess.decode_steps,
                 json.dumps(sess.prefix_cache_stats()), json.dumps(launches)))
    sess, got, admit_s = runs["cached"]
    want = runs["uncached"][1]
    print("prefix: admission host ms, a cold admission (the cached session's "
          "first) %.3f, a hit (median of %d) %.3f, an uncached admission "
          "(median of %d) %.3f"
          % (1e3 * admit_s[0], PREFIX_ADMISSIONS - 1,
             1e3 * float(np.median(admit_s[1:])), PREFIX_ADMISSIONS - 1,
             1e3 * float(np.median(runs["uncached"][2][1:]))))
    same = int(sum((got[i] == want[i]).all() for i in range(len(got))))
    st = sess.prefix_cache_stats()
    print("prefix: %d of %d streams equal the uncached session's; %d hits in "
          "%d lookups, %d tokens saved; %d pages in use after the drain, %d "
          "cached" % (same, len(got), st["hits"], st["lookups"],
                      st["tokens_saved"], sess.pages_in_use,
                      sess.cached_pages))
    if same != len(got) or not (got[:, 1:1 + PREFIX_FORCED] == pfx).all():
        fail("prefix: the cached session's streams differ from the uncached "
             "session's or lost the forced prefix")
    hits = PREFIX_ADMISSIONS - 1
    if (st["lookups"], st["hits"], st["tokens_saved"]) != (
            PREFIX_ADMISSIONS, hits, hits * full_pages * PAGE_SIZE):
        fail("prefix: stats %s, want %d hits in %d lookups and %d tokens "
             "saved" % (json.dumps(st), hits, PREFIX_ADMISSIONS,
                        hits * full_pages * PAGE_SIZE))
    if sess.pages_in_use != sess.cached_pages or sess.shared_pages:
        fail("prefix: %d pages in use after the drain, %d cached"
             % (sess.pages_in_use, sess.cached_pages))
    sess.clear_prefix_cache()
    if sess.pages_in_use != 0 or not sess.pool_conserved:
        fail("prefix: the pool did not drain after clear_prefix_cache()")
    return total


def dense_session(exe, scope):
    from paddle_tpu_torch.serving.generation import SlotDecodeSession

    return SlotDecodeSession(
        exe, num_slots=NUM_SLOTS, max_length=MAX_LEN, d_model=D_MODEL,
        paged=False, steps=1, eos_id=EOS, scope=scope, src_vocab_size=VOCAB,
        trg_vocab_size=VOCAB, n_layer=N_LAYER, n_head=N_HEAD,
        d_inner=D_INNER)


def dense_phase(np, torch, exe, scope, kernels):
    """The requests without their forced prefixes through ``paged=False``
    (32 slots, steps 1): the first step's logits against the paged
    session's, the streams against a paged run's (a stream may leave it
    only where the paged path's top-2 margin is below MARGIN_TOL), and
    2 x n_layer flash_fwd launches per decode step plus n_layer an
    admission."""
    src, lens, _ = requests(np)
    reqs = (src, lens, [None] * N_REQUESTS)
    idx = [0, 1, 2, 3]
    dense = dense_session(exe, scope.new_scope())
    paged = session(exe, scope.new_scope(), NUM_SLOTS)
    for i in idx:
        dense.admit(src[i], lens[i])
        paged.admit(src[i], lens[i])
    (dl,) = exe.run(dense.step_program, feed=dense._dense_feed(),
                    fetch_list=[logits_name(dense.step_program)],
                    scope=dense._scope)
    (pl,) = exe.run(paged.step_program,
                    fetch_list=[logits_name(paged.step_program)],
                    scope=paged._scope)
    dl, pl = np.asarray(dl)[idx], np.asarray(pl)[idx]
    err = float(np.abs(dl - pl).max())
    print("dense: first decode step logits %s against the paged session's: "
          "max_abs_err %.3e  tol %.0e" % (tuple(dl.shape), err, LOGITS_TOL))
    if not np.isfinite(dl).all() or not err <= LOGITS_TOL:
        fail("dense and paged logits disagree: %.3e" % err)
    dense = paged = None
    ref = paged_run(np, torch, exe, scope, kernels, reqs,
                    "dense reference (paged, captured, no prefixes)")
    sess = dense_session(exe, scope.new_scope())
    times = step_timer(sess)
    out, wall, launches, _ = run_requests(np, torch, sess, kernels, src,
                                          lens, reqs[2])
    generated = sum(generated_tokens(row, None) for row in out)
    cache_bytes = sum(
        sess._scope.get_value("gen_%s_%d" % (kind, i)).nbytes
        for i in range(N_LAYER)
        for kind in ("kcache", "vcache", "kcross", "vcross"))
    print("dense: %d requests, %d slots: wall %.3f s, %d decode steps, %d "
          "tokens, decode %.1f tokens/s; host %.3f ms per step() (median "
          "%.3f); caches %d bytes (self K/V and cross K/V, %d layers x 4 x "
          "[%d,%d,%d,%d] fp32); kernel launches %s"
          % (N_REQUESTS, NUM_SLOTS, wall, sess.decode_steps, generated,
             generated / wall, 1e3 * float(np.mean(times)),
             1e3 * float(np.median(times)), cache_bytes, N_LAYER, NUM_SLOTS,
             N_HEAD, MAX_LEN, D_MODEL // N_HEAD, json.dumps(launches)))
    compare_streams(np, exe, scope, reqs, "dense", out, ref["out"],
                    label="dense")
    expect = 2 * N_LAYER * sess.decode_steps + N_LAYER * N_REQUESTS
    if launches["flash_fwd"] != expect or launches["paged_decode"]:
        fail("dense: flash_fwd launched %d times (want 2 x n_layer x %d "
             "decode steps + n_layer x %d admissions = %d), paged_decode %d"
             % (launches["flash_fwd"], sess.decode_steps, N_REQUESTS, expect,
                launches["paged_decode"]))
    if not ((out >= 0) & (out < VOCAB)).all() or not (out[:, 0] == 1).all():
        fail("dense: token matrix out of range or not bos-led")
    total = dict(ref["launches"])
    for n, v in launches.items():
        total[n] = total.get(n, 0) + v
    return total


def logits_name(step_prog):
    for op in step_prog.global_block().ops:
        if op.input("Y") == ["proj_logits.w_1"]:
            return op.output("Out")[0]
    fail("no proj_logits output in the step program")


def card_vs_cpu_phase(np, torch, fluid, exe, scope, main):
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.core.scope import Scope

    src, lens, prefixes = requests(np)
    idx = [0, 1, 2, 3]  # request 0 carries a forced prefix
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_scope = Scope()
    params_from_numpy(main, cpu_scope, {
        p.name: scope.get_value(p.name).cpu().numpy()
        for p in main.global_block().all_parameters()}, "cpu")
    logits, tokens = {}, {}
    for dev, ex, sc in (("card", exe, scope), ("cpu", cpu_exe, cpu_scope)):
        sess_scope = sc.new_scope()
        sess = session(ex, sess_scope, len(idx))
        for i in idx:
            sess.admit(src[i], lens[i], prefix_tokens=prefixes[i])
        (logits[dev],) = ex.run(sess.step_program,
                                fetch_list=[logits_name(sess.step_program)],
                                scope=sess_scope)
        sess = session(ex, sc.new_scope(), len(idx))
        tokens[dev] = sess.generate(src[idx], lens[idx],
                                    [prefixes[i] for i in idx])
    err = float(np.abs(logits["card"] - logits["cpu"]).max())
    print("card vs cpu: first decode step logits %s max_abs_err %.3e  tol %.0e"
          % (tuple(logits["card"].shape), err, LOGITS_TOL))
    if not np.isfinite(logits["card"]).all() or not err <= LOGITS_TOL:
        fail("card and CPU logits disagree: %.3e" % err)
    same = tokens["card"] == tokens["cpu"]
    first = [int(np.argmin(row)) if not row.all() else None for row in same]
    print("card vs cpu: tokens equal %d of %d positions; first divergence "
          "per request %s (printed, not gated: a near-tie argmax flip "
          "cascades)" % (int(same.sum()), same.size, first))
    return err


# -- speculative phases ---------------------------------------------------------

def spec_session(exe, scope, num_slots, drafter, sampler=None):
    from paddle_tpu_torch.serving.generation import SlotDecodeSession

    return SlotDecodeSession(
        exe, num_slots=num_slots, max_length=MAX_LEN, d_model=D_MODEL,
        paged=True, page_size=PAGE_SIZE, steps=1, eos_id=EOS, scope=scope,
        speculative={"k": SPEC_K, "drafter": drafter}, src_vocab_size=VOCAB,
        trg_vocab_size=VOCAB, n_layer=N_LAYER, n_head=N_HEAD,
        d_inner=D_INNER, sampler=sampler)


class ReplayDrafter(object):
    """A drafter with a known, non-trivial acceptance at random weights:
    it proposes each slot's continuation from the streams a sequential
    run of the same requests recorded (request ids count from 0 in
    enqueue order), with every 4th draft token it hands out replaced by
    a token drawn from a seed. Same ``propose`` / ``forget`` /
    ``state_dict`` interface as the package's drafters."""

    kind = "replay"

    def __init__(self, np, sess, num_slots, streams, k, seed):
        self._np, self._sess, self._streams, self.k = np, sess, streams, int(k)
        self._S = int(num_slots)
        self._rng = np.random.RandomState(seed)
        self._handed_out = 0

    def forget(self, slot):
        pass

    def state_dict(self):
        return {"handed_out": self._handed_out}

    def propose(self, states):
        np = self._np
        draft = np.full((self._S, self.k), EOS, dtype="int64")
        for slot in sorted(states):
            row = self._streams[self._sess._owner[slot]]
            pos = int(states[slot]["pos"])
            for j in range(self.k):
                if pos + 1 + j < MAX_LEN:
                    draft[slot, j] = row[pos + 1 + j]
                self._handed_out += 1
                if self._handed_out % 4 == 0:
                    draft[slot, j] = self._rng.randint(3, VOCAB)
        return draft


def record_slots(sess):
    """Wrap ``admit_pending`` so that ``sess.slot_of`` maps each request
    id (its index: ids count from 0 in enqueue order) to its slot."""
    sess.slot_of, admit = {}, sess.admit_pending

    def recorded():
        admitted = admit()
        for slot, rid in admitted.items():
            sess.slot_of[rid] = slot
        return admitted

    sess.admit_pending = recorded


def host_timers(sess):
    """Host wall seconds spent inside the session's admissions
    (``admit_pending``), its ``step()`` calls and, inside those, the
    copy-on-write / rebind dispatch and the drafter. A dispatch with no
    fetch only enqueues its kernels, so device time shows up in the next
    call that fetches: this splits the HOST's time, not the card's."""
    spent = {"admit": 0.0, "step": 0.0, "cow": 0.0, "draft": 0.0}

    def wrap(obj, attr, key):
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0

        setattr(obj, attr, timed)

    wrap(sess, "admit_pending", "admit")
    wrap(sess, "step", "step")
    wrap(sess, "_dispatch_cow", "cow")
    wrap(sess._spec_drafter, "propose", "draft")
    return spent


def check_commits(sess):
    """Wrap the session's bookkeeping of a verify dispatch so that every
    live slot's committed count is held to 1..k+1; returns the list the
    per-dispatch totals (live slots, committed tokens) go to."""
    per_dispatch, consume = [], sess._consume_spec

    def checked(tok_seq, acc_len):
        live = list(sess._live)
        bad = [(s, int(acc_len[s])) for s in live
               if not 1 <= int(acc_len[s]) <= SPEC_K + 1]
        if bad:
            fail("verify dispatch %d: (slot, committed) %s outside 1..%d"
                 % (sess.spec_dispatches, bad, SPEC_K + 1))
        per_dispatch.append((len(live), int(sum(acc_len[s] for s in live))))
        return consume(tok_seq, acc_len)

    sess._consume_spec = checked
    return per_dispatch


def spec_run(np, torch, flags, exe, scope, kernels, name, drafter, reqs,
             mode="on", replay_streams=None, num_slots=None, sampler=None):
    """One speculative session over ``reqs`` under FLAGS_speculative =
    ``mode`` (greedy, or ``sampler``); prints its lines, checks its
    gates, returns (tokens, launches, the session). The session's
    ``slot_of`` maps each request's index to the slot it was admitted
    to."""
    src, lens, prefixes = reqs
    num_slots = num_slots or NUM_SLOTS
    flags.set_flag("speculative", mode)
    sess = spec_session(exe, scope.new_scope(), num_slots, drafter, sampler)
    record_slots(sess)
    if replay_streams is not None:
        sess._spec_drafter = ReplayDrafter(np, sess, num_slots,
                                           replay_streams, SPEC_K, SEED + 3)
    per_dispatch = check_commits(sess)
    spent = host_timers(sess)
    out, wall, launches, peak = run_requests(np, torch, sess, kernels, src,
                                             lens, prefixes)
    flags.set_flag("speculative", "on")
    generated = sum(generated_tokens(out[i], prefixes[i])
                    for i in range(len(src)))
    slot_dispatches = sum(n for n, _ in per_dispatch)
    committed = sum(c for _, c in per_dispatch)
    print("spec %-7s %d requests, %d slots, k %d: wall %.3f s, %d tokens, "
          "decode %.1f tokens/s; %d step() calls, %d verify dispatches, "
          "proposed %d, accepted %d, acceptance %.4f, committed per slot "
          "per dispatch %.3f"
          % (name + ":", len(src), num_slots, SPEC_K, wall, generated,
             generated / wall, sess.steps_done, sess.spec_dispatches,
             sess.spec_proposed, sess.spec_accepted,
             sess.spec_accepted / max(sess.spec_proposed, 1),
             committed / max(slot_dispatches, 1)))
    steps = max(sess.steps_done, 1)
    print("spec %-7s host time: admissions %.3f s, step() calls %.3f s (%.2f "
          "ms each: COW and rebind dispatch %.2f, drafter %.2f, program and "
          "bookkeeping %.2f), queue and results %.3f s"
          % (name + ":", spent["admit"], spent["step"],
             1e3 * spent["step"] / steps, 1e3 * spent["cow"] / steps,
             1e3 * spent["draft"] / steps,
             1e3 * (spent["step"] - spent["cow"] - spent["draft"]) / steps,
             wall - spent["admit"] - spent["step"]))
    print("spec %-7s kernel launches %s; page pool peak %d, after drain %d "
          "in use, conserved %s; COW dispatches %d"
          % (name + ":", json.dumps(launches), peak, sess.pages_in_use,
             sess.pool_conserved, sess.cow_dispatches))
    if sess.pages_in_use != 0 or not sess.pool_conserved:
        fail("spec %s: the page pool did not drain" % name)
    if not ((out >= 0) & (out < VOCAB)).all() or not (out[:, 0] == 1).all():
        fail("spec %s: token matrix out of range or not bos-led" % name)
    if launches["tree_decode"] != N_LAYER * sess.spec_dispatches:
        fail("spec %s: tree_decode launched %d times, expected n_layer x "
             "verify dispatches = %d" % (name, launches["tree_decode"],
                                         N_LAYER * sess.spec_dispatches))
    if mode == "off":
        if sess.spec_dispatches or launches["paged_decode"] != \
                N_LAYER * sess.decode_steps:
            fail("spec off: %d verify dispatches, paged_decode launched %d "
                 "times for %d decode steps"
                 % (sess.spec_dispatches, launches["paged_decode"],
                    sess.decode_steps))
    elif not sess.spec_dispatches or sess.decode_steps:
        fail("spec %s: %d verify dispatches, %d sequential steps"
             % (name, sess.spec_dispatches, sess.decode_steps))
    return out, launches, sess


def top2_margin(np, exe, scope, reqs, i, row, p):
    """The sequential path's top-2 logit margin for request ``i`` at token
    position ``p``, given the stream ``row`` up to there: the tokens
    before ``p`` are forced as a prefix, and the first decode step's
    logits are read."""
    src, lens, prefixes = reqs
    sess_scope = scope.new_scope()
    sess = session(exe, sess_scope, 1)
    sess.admit(src[i], lens[i], prefix_tokens=[int(t) for t in row[1:p]])
    (lg,) = exe.run(sess.step_program,
                    fetch_list=[logits_name(sess.step_program)],
                    scope=sess_scope)
    top = np.sort(np.asarray(lg).reshape(-1))[-2:]
    return float(top[1] - top[0])


def compare_streams(np, exe, scope, reqs, name, out, ref, label="spec"):
    """Streams of a speculative (or dense) run against the sequential
    paged run's: prints the count of equal requests; a differing request
    fails the run unless the sequential path's two best logits at its
    first differing position lie within MARGIN_TOL (then another
    summation order may flip the argmax, and everything after it
    follows)."""
    differing = [i for i in range(len(ref)) if (out[i] != ref[i]).any()]
    print("%s %-7s %d of %d requests stream the sequential run's tokens"
          % (label, name + ":", len(ref) - len(differing), len(ref)))
    for i in differing:
        p = int(np.argmax(out[i] != ref[i]))
        margin = top2_margin(np, exe, scope, reqs, i, ref[i], p)
        print("%s %-7s request %d differs first at position %d (%d against "
              "%d); the sequential path's top-2 logit margin there is %.3e "
              "(tol %.0e)" % (label, name + ":", i, p, out[i][p], ref[i][p],
                              margin, MARGIN_TOL))
        if not margin <= MARGIN_TOL:
            fail("%s %s: request %d left the sequential stream at a "
                 "position with a clear argmax (margin %.3e)"
                 % (label, name, i, margin))
    return len(ref) - len(differing)


def provision_tree(sess):
    """Provision (and copy-on-write split) every live slot's next k + 1
    storage positions, as ``step()`` does before a verify dispatch."""
    sess._dispatch_cow(sess._cow_window(
        [(slot, st["pos"]) for slot, st in sess._live.items()],
        span=SPEC_K + 1))


def verify_dispatch_logits(np, exe, sess, draft):
    """One verify dispatch of a speculative session run by hand, so that
    its ``[S, N, V]`` logits can be fetched: the tree's span is
    provisioned, then the verify program runs on ``draft``. The host
    mirrors do not advance."""
    provision_tree(sess)
    (lg,) = exe.run(sess._spec_prog, feed={
        "spec_draft": np.asarray(draft, "int64"),
        "spec_parent": sess._spec_parent, "spec_anc": sess._spec_anc},
        fetch_list=[logits_name(sess._spec_prog)], scope=sess._scope)
    return np.asarray(lg)


def verify_logits_phase(np, flags, exe, scope, reqs, warm_steps=10):
    """From one mid-stream state, the verify dispatch against the
    sequential path: two sessions admit the same 32 requests and take
    ``warm_steps`` sequential steps; then one runs k + 1 more sequential
    steps (logits and tokens fetched), the other ONE verify dispatch fed
    those steps' first k tokens as its draft chain. Node j's logits must
    agree with sequential step j's."""
    src, lens, prefixes = reqs
    flags.set_flag("speculative", "off")
    pair = []
    for _ in range(2):
        sess = spec_session(exe, scope.new_scope(), NUM_SLOTS, "ngram")
        for i in range(NUM_SLOTS):
            sess.admit(src[i], lens[i], prefix_tokens=prefixes[i])
        for _ in range(warm_steps):
            sess.step()
        pair.append(sess)
    flags.set_flag("speculative", "on")
    seq, ver = pair
    if sorted(seq._live) != sorted(ver._live) or len(seq._live) < NUM_SLOTS // 2:
        fail("verify logits: the two sessions are not in one mid-stream state")
    # the sequential side: k + 1 steps of the step program, span provisioned
    provision_tree(seq)
    step_lg, step_tok = [], []
    for _ in range(SPEC_K + 1):
        lg, tok = exe.run(seq.step_program, fetch_list=[
            logits_name(seq.step_program), seq._fetch_name], scope=seq._scope)
        step_lg.append(np.asarray(lg)[:, 0, :])
        step_tok.append(np.asarray(tok).reshape(-1))
    done = np.asarray(seq._scope.get_value("pgd_done").cpu()).reshape(-1)
    live = np.asarray([s for s in sorted(seq._live) if not done[s]])
    draft = np.stack(step_tok[:SPEC_K], axis=1)  # [S, k]
    tree_lg = verify_dispatch_logits(np, exe, ver, draft)  # [S, N, V]
    errs = [float(np.abs(tree_lg[live, j] - step_lg[j][live]).max())
            for j in range(SPEC_K + 1)]
    print("verify logits: %d slots live through %d sequential steps after %d "
          "warm steps; logits %s; max_abs_err per node %s  tol %.0e"
          % (len(live), SPEC_K + 1, warm_steps, tuple(tree_lg.shape),
             ["%.3e" % e for e in errs], SPEC_LOGITS_TOL))
    if len(live) < NUM_SLOTS // 2 or not np.isfinite(tree_lg[live]).all() \
            or not max(errs) <= SPEC_LOGITS_TOL:
        fail("verify logits disagree with the sequential steps': %s" % errs)
    return max(errs)


def dispatch_profile_phase(np, torch, flags, exe, scope, reqs, warm_steps=10):
    """One sequential step and one verify dispatch of a full session (32
    live slots, mid-stream) under the profiler: what the card does while
    the host interprets a dispatch. Each profiled call's pages are
    provisioned just before it, so it holds the drafter, the program and
    the bookkeeping but no copy-on-write / rebind dispatch (whose host
    time the ``spec`` lines give)."""
    src, lens, prefixes = reqs
    flags.set_flag("speculative", "off")
    sess = spec_session(exe, scope.new_scope(), NUM_SLOTS, "ngram")
    for i in range(NUM_SLOTS):
        sess.admit(src[i], lens[i], prefix_tokens=prefixes[i])
    for _ in range(warm_steps):
        sess.step()
    provision_tree(sess)
    profile_call(torch, "sequential step", sess.step, top=6)
    flags.set_flag("speculative", "on")
    sess.step()  # the verify path's lazy set-up stays out of the profile
    provision_tree(sess)
    profile_call(torch, "verify dispatch", sess.step, top=6)


def speculative_phase(np, torch, fluid, exe, scope, kernels):
    from paddle_tpu_torch import flags

    reqs = requests(np)
    few = tuple(x[:SPEC_MODEL_REQUESTS] for x in reqs)
    off, launches_o, _ = spec_run(np, torch, flags, exe, scope, kernels,
                                  "off", "ngram", reqs, mode="off")
    ngram, launches, _ = spec_run(np, torch, flags, exe, scope, kernels,
                                  "ngram", "ngram", reqs)
    replay, launches_r, sess_r = spec_run(
        np, torch, flags, exe, scope, kernels, "replay", "ngram", reqs,
        replay_streams=off)
    if not sess_r.spec_accepted > 0:
        fail("spec replay: no draft token was accepted")
    model, launches_m, _ = spec_run(
        np, torch, flags, exe, scope, kernels, "model", "model", few,
        num_slots=SPEC_MODEL_REQUESTS)
    compare_streams(np, exe, scope, reqs, "ngram", ngram, off)
    compare_streams(np, exe, scope, reqs, "replay", replay, off)
    compare_streams(np, exe, scope, few, "model", model,
                    off[:SPEC_MODEL_REQUESTS])
    verify_logits_phase(np, flags, exe, scope, reqs)
    dispatch_profile_phase(np, torch, flags, exe, scope, reqs)
    runs = (launches_o, launches, launches_r, launches_m)
    return {n: sum(r.get(n, 0) for r in runs)
            for n in set().union(*runs)}


def spec_card_vs_cpu_phase(np, torch, fluid, exe, scope, main):
    """4 requests through the speculative session (n-gram drafter) on the
    card and on the CPU (plain versions): gate on the first verify
    dispatch's anchor-node logits; token agreement is printed."""
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.core.scope import Scope

    src, lens, prefixes = requests(np)
    idx = [0, 1, 2, 3]  # request 0 carries a forced prefix
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_scope = Scope()
    params_from_numpy(main, cpu_scope, {
        p.name: scope.get_value(p.name).cpu().numpy()
        for p in main.global_block().all_parameters()}, "cpu")
    logits, tokens = {}, {}
    for dev, ex, sc in (("card", exe, scope), ("cpu", cpu_exe, cpu_scope)):
        sess = spec_session(ex, sc.new_scope(), len(idx), "ngram")
        for i in idx:
            sess.admit(src[i], lens[i], prefix_tokens=prefixes[i])
        draft = sess._spec_drafter.propose(sess._live)
        logits[dev] = verify_dispatch_logits(np, ex, sess, draft)[:, 0, :]
        sess = spec_session(ex, sc.new_scope(), len(idx), "ngram")
        tokens[dev] = sess.generate(src[idx], lens[idx],
                                    [prefixes[i] for i in idx])
    err = float(np.abs(logits["card"] - logits["cpu"]).max())
    print("spec card vs cpu: first verify dispatch, anchor-node logits %s "
          "max_abs_err %.3e  tol %.0e" % (tuple(logits["card"].shape), err,
                                          LOGITS_TOL))
    if not np.isfinite(logits["card"]).all() or not err <= LOGITS_TOL:
        fail("card and CPU verify logits disagree: %.3e" % err)
    same = tokens["card"] == tokens["cpu"]
    print("spec card vs cpu: tokens equal %d of %d positions (printed, not "
          "gated: a near-tie argmax flip cascades)"
          % (int(same.sum()), same.size))
    return err


# -- training phases ------------------------------------------------------------

def build_train(fluid, dropout, amp=False, n_layer=N_LAYER):
    """Transformer-base's train program as bench.py:240-266 builds it:
    (main, startup, loss, [(param, grad)]); ``amp`` rewrites it for bf16
    mixed precision as bench.py:267-268 does on the accelerator."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.transpiler import rewrite_program_amp

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = TRAIN_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        loss, _, _ = transformer.build(
            src_vocab_size=VOCAB, trg_vocab_size=VOCAB, max_length=MAX_LEN,
            n_layer=n_layer, n_head=N_HEAD, d_model=D_MODEL,
            d_inner=D_INNER, dropout=dropout, label_smooth_eps=LABEL_SMOOTH)
        _, params_grads = fluid.optimizer.Adam(
            learning_rate=LR).minimize(loss)
    if amp:
        rewrite_program_amp(main, "bfloat16")
    return main, startup, loss, params_grads


def train_feed(np, batch):
    """One fixed batch, fed at every step as bench.py:270-285 does: tokens
    from ids 1..1000, ``label`` a copy of ``src_word``, source and target
    lengths uniform in 16..256 (the key masks and the loss mask are
    live)."""
    rng = np.random.RandomState(SEED)
    src = rng.randint(1, TRAIN_TOKEN_IDS + 1, (batch, MAX_LEN))
    return {
        "src_word": src.astype("int64"),
        "src_len": rng.randint(16, MAX_LEN + 1, (batch, 1)).astype("int64"),
        "trg_word": rng.randint(1, TRAIN_TOKEN_IDS + 1,
                                (batch, MAX_LEN)).astype("int64"),
        "trg_len": rng.randint(16, MAX_LEN + 1, (batch, 1)).astype("int64"),
        "label": src.astype("int64").copy(),
    }


def profile_call(torch, label, fn, top=8):
    """``fn()`` under torch.profiler (``trace_call``: a trace that lacks
    a kernel that ran is taken again): prints its wall time, the
    device's busy share of it, the matrix-product kernels' share of the
    busy time (names with one of ``GEMM_NAMES``), the device time by
    kernel (the ``top`` largest) and that of each of the port's flash
    kernels (names starting ``flash_``, a ``port kernel`` line each);
    returns {"wall_ms", "busy_ms", "gemm_ms", "launches", "kernel_ms"},
    or None where the trace stayed incomplete or holds no device
    time."""
    traced = trace_call(torch, label, fn)
    if traced is None:
        return None
    prof, wall_ms = traced
    # the kernels themselves (CPU-side ops also carry their kernels' time)
    events = traced_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print("%s profile: no device time in the trace (not measured)"
              % label)
        return None
    gemm_ms = sum(e.self_device_time_total for e in events
                  if any(n in e.key.lower() for n in GEMM_NAMES)) / 1e3
    print("%s profile: wall %.1f ms under the profiler, device busy %.2f ms "
          "(%.1f %%), %d kernel launches; matrix-product kernels %.2f ms "
          "(%.1f %% of busy)"
          % (label, wall_ms, busy_ms, 100.0 * busy_ms / wall_ms,
             sum(e.count for e in events), gemm_ms,
             100.0 * gemm_ms / busy_ms))
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in ranked[:top]:
        print("%s profile: %8.3f ms %5d calls  %s"
              % (label, e.self_device_time_total / 1e3, e.count, e.key[:90]))
    for e in ranked:
        name = e.key.split("(anonymous namespace)::", 1)[-1]
        if name.startswith("flash_"):
            print("%s profile: port kernel %8.3f ms %5d calls  %s"
                  % (label, e.self_device_time_total / 1e3, e.count,
                     name[:70]))
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, gemm_ms=gemm_ms,
                launches=sum(e.count for e in events),
                kernel_ms={e.key: e.self_device_time_total / 1e3
                           for e in events})


class StepProbe(object):
    """What the host did beside a train step: Python's garbage
    collections (how many and how long, by generation, through
    ``gc.callbacks``) and the caching allocator's device mallocs, frees
    and retries (a retry frees every cached block, synchronizing, and
    mallocs again). ``take()`` returns the events since the last
    call."""

    def __init__(self, torch):
        self.torch = torch
        self.count, self.pause = [0, 0, 0], [0.0, 0.0, 0.0]
        self._t0 = 0.0
        self._last = self._read()

    def _collect(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        g = info["generation"]
        self.count[g] += 1
        self.pause[g] += (time.perf_counter() - self._t0) * 1e3

    def __enter__(self):
        gc.callbacks.append(self._collect)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._collect)

    def _read(self):
        st = self.torch.cuda.memory_stats()
        return (tuple(self.count), tuple(self.pause),
                st.get("num_device_alloc", 0), st.get("num_device_free", 0),
                st.get("num_alloc_retries", 0))

    def take(self):
        now = self._read()
        was, self._last = self._last, now
        return dict(gc=[a - b for a, b in zip(now[0], was[0])],
                    gc_ms=[a - b for a, b in zip(now[1], was[1])],
                    mallocs=now[2] - was[2], frees=now[3] - was[3],
                    retries=now[4] - was[4])


def f32_masters(np, torch, main, scope, label):
    """Fails unless every floating persistable the scope holds for
    ``main`` (parameters, optimizer moments, moving statistics) is
    float32; returns how many there are."""
    n = 0
    for v in main.global_block().vars.values():
        val = scope.get_value(v.name) if v.persistable else None
        if isinstance(val, torch.Tensor) and val.is_floating_point():
            if val.dtype != torch.float32:
                fail("%s: the scope holds %s as %s, not float32"
                     % (label, v.name, val.dtype))
            n += 1
    return n


def train_phase(np, torch, fluid, exe, kernels, amp=False, f32=None):
    """Transformer-base trained as bench.py:240-285 does (module
    docstring, step 8; with ``amp``, step 15: bf16 mixed precision, the
    flash kernels' bf16 entries, on a fresh executor so that
    ``amp_fused_ce_phase`` can replay its dropout keys; ``f32`` is the
    float32 run's result, printed beside). Returns {"launches", "losses"
    (warm-up steps included), "mean_ms", "tokens_s", "peak",
    "profile"}."""
    label = "amp train" if amp else "train"
    main, startup, loss, _ = build_train(fluid, DROPOUT, amp=amp)
    if amp:
        exe = fluid.Executor()
    ops = main.global_block().ops
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    print("%s: Transformer-base program of %d ops (%d startup ops), %.1f M "
          "parameters, batch %d x %d, dropout %.1f, label smoothing %.1f, "
          "Adam(%g), %s" % (label, len(ops), len(startup.global_block().ops),
                            n_params / 1e6, TRAIN_BATCH, MAX_LEN, DROPOUT,
                            LABEL_SMOOTH, LR,
                            "AMP bf16 (rewrite_program_amp)" if amp
                            else "fp32, TF32 off"))
    feed = train_feed(np, TRAIN_BATCH)
    dec_tokens = int(feed["trg_len"].sum())
    losses = []
    for _ in range(TRAIN_WARMUP):
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    off = () if not amp else flash  # the entries an AMP step never takes
    if amp:
        flash = tuple(n + "_bf16" for n in flash)
    names = flash + ("threefry",)
    n_drop = sum(op.type == "dropout" for op in ops)
    for k in kernels.values():
        k.reset()
    step_ms, per_step, reruns, events = [], [], [], []
    # The heap holds every earlier phase's objects and their garbage.
    # Collect it here, outside the timed steps, and freeze what is left
    # (modules, programs, scopes) as a trainer freezes its heap once it
    # is set up: a full collection in the timed steps then walks only
    # what they allocate. Unfrozen, one step in 20 paid a 670 ms
    # generation-2 collection of some 920,000 objects (PERF.md).
    t0 = time.perf_counter()
    found = gc.collect()
    print("%s: before the timed steps a full collection found %d "
          "unreachable objects in %.1f ms; %d tracked objects frozen"
          % (label, found, (time.perf_counter() - t0) * 1e3,
             len(gc.get_objects())))
    gc.freeze()
    with StepProbe(torch) as probe:
        for i in range(TRAIN_STEPS):
            before = [kernels[n].launches for n in names]
            reran = exe.grad_op_reruns
            probe.take()
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            events.append(probe.take())
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
            per_step.append(tuple(kernels[n].launches - b
                                  for n, b in zip(names, before)))
            reruns.append(exe.grad_op_reruns - reran)
            ev = events[-1]
            print("%s step %2d: loss %.6f  wall %.1f ms  launches %s  "
                  "grad-op reruns %d  gc %s (%.1f ms)  device mallocs %d, "
                  "frees %d, allocator retries %d"
                  % (label, i + 1, losses[-1], step_ms[-1],
                     dict(zip(names, per_step[-1])), reruns[-1], ev["gc"],
                     sum(ev["gc_ms"]), ev["mallocs"], ev["frees"],
                     ev["retries"]))
    gc.unfreeze()
    launches = kernel_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    mean_ms = float(np.mean(step_ms))
    tokens_s = dec_tokens / mean_ms * 1e3
    print("%s: garbage collections in the timed steps by generation %s, "
          "%.1f ms in all (%.1f ms in generation 2)"
          % (label, [sum(e["gc"][g] for e in events) for g in range(3)],
             sum(sum(e["gc_ms"]) for e in events),
             sum(e["gc_ms"][2] for e in events)))
    print("%s: %d steps, mean %.1f ms/step (median %.1f, min %.1f, max "
          "%.1f), %d decoder tokens per step (non-pad): %.0f decoder "
          "tokens/s; peak memory %.2f GiB"
          % (label, TRAIN_STEPS, mean_ms, float(np.median(step_ms)),
             min(step_ms), max(step_ms), dec_tokens, tokens_s,
             peak / 2 ** 30))
    print("%s: kernel launches over the %d steps %s"
          % (label, TRAIN_STEPS, json.dumps(launches)))
    if not np.isfinite(losses).all():
        fail("a %s loss is not finite: %s" % (label, losses))
    n_attn = 3 * N_LAYER
    # the forward tape: each attention's forward launches once, its grad
    # op differentiates the recorded graph; each dropout site draws its
    # mask in one threefry launch (its grad op reuses the mask)
    if amp:
        print("amp train: mean %.1f ms a step (%.0f decoder tokens/s, peak "
              "%.2f GiB) against the fp32 run's %.1f ms (%.0f tokens/s, "
              "peak %.2f GiB) in this call"
              % (mean_ms, tokens_s, peak / 2 ** 30, f32["mean_ms"],
                 f32["tokens_s"], f32["peak"] / 2 ** 30))
    else:
        print("train: %d dropout sites, one threefry launch each: mean %.1f "
              "ms a step (%.1f-%.1f) against %.1f (%.1f-%.1f), the mean "
              "step measured before the masks were threefry draws (torch's "
              "Philox)" % ((n_drop, mean_ms, min(step_ms), max(step_ms))
                           + PHILOX_TRAIN_MS))
    med = float(np.median(step_ms))
    for i, ms in enumerate(step_ms):
        if ms > 1.5 * med:
            ev = events[i]
            print("%s: step %d took %.1f ms, %.1f ms over the median: gc "
                  "%s (%.1f ms by generation %s), device mallocs %d, frees "
                  "%d, allocator retries %d"
                  % (label, i + 1, ms, ms - med, ev["gc"], sum(ev["gc_ms"]),
                     ["%.1f" % t for t in ev["gc_ms"]], ev["mallocs"],
                     ev["frees"], ev["retries"]))
    if n_drop != 30:
        fail("the train program holds %d dropout ops, not Transformer-base's "
             "30" % n_drop)
    if any(c != (n_attn, n_attn, n_attn, n_drop) for c in per_step):
        fail("%s: per-step launches %s, expected %s %d, %s %d, %s %d, "
             "threefry %d" % (label, per_step, flash[0], n_attn, flash[1],
                              n_attn, flash[2], n_attn, n_drop))
    if any(launches[n] for n in off):
        fail("amp train: the float32 flash entries launched %s in bf16 "
             "steps" % {n: launches[n] for n in off})
    if any(reruns):
        fail("grad ops reran their forward in the %s steps: %s"
             % (label, reruns))
    first, late = losses[TRAIN_WARMUP], float(np.mean(losses[-5:]))
    print("%s: loss step 1 %.6f, mean of steps 16-20 %.6f (gate: %.1f "
          "nat lower)" % (label, first, late, LOSS_DROP))
    if not late <= first - LOSS_DROP:
        fail("the %s loss did not fall by %.1f nat" % (label, LOSS_DROP))
    if amp:
        n = f32_masters(np, torch, main, scope, label)
        print("amp train: all %d floating persistables (parameters, Adam "
              "moments) are float32 in the scope" % n)
    prof = profile_call(torch, label, lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope))
    return dict(launches=launches, losses=losses, mean_ms=mean_ms,
                tokens_s=tokens_s, peak=peak, profile=prof)


def amp_fused_ce_phase(np, torch, fluid, kernels, composed):
    """``FLAGS_fused_ce`` on the AMP train step (module docstring, step
    15): a fresh executor and scope, as the composed head's AMP run had,
    so the weights and the dropout keys are the same; ``AMP_FUSED_STEPS``
    steps, each loss within ``AMP_FUSED_TOL`` (relative) of the composed
    head's at that step; the step time beside it."""
    from paddle_tpu_torch import flags

    old = flags.get("fused_ce")
    flags.set_flag("fused_ce", True)
    try:
        main, startup, loss, _ = build_train(fluid, DROPOUT, amp=True)
    finally:
        flags.set_flag("fused_ce", old)
    if not any(op.type == "fused_label_smooth_ce"
               for op in main.global_block().ops):
        fail("FLAGS_fused_ce did not switch the train program's head")
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = train_feed(np, TRAIN_BATCH)
    losses, step_ms = [], []
    for i in range(AMP_FUSED_STEPS):
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    ref = composed["losses"][:AMP_FUSED_STEPS]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    mean_ms = float(np.mean(step_ms[1:]))
    print("amp fused_ce: %d steps with FLAGS_fused_ce, losses %s against "
          "the composed head's %s: max relative diff %.3e  tol %.0e; mean "
          "%.1f ms a step after the first (composed head: %.1f)"
          % (AMP_FUSED_STEPS, ["%.6f" % v for v in losses],
             ["%.6f" % v for v in ref], err, AMP_FUSED_TOL, mean_ms,
             composed["mean_ms"]))
    if exe.grad_op_reruns:
        fail("amp fused_ce: %d grad ops reran their forward"
             % exe.grad_op_reruns)
    if not np.isfinite(losses).all() or not err <= AMP_FUSED_TOL:
        fail("the fused head's AMP losses leave the composed head's: %.3e"
             % err)
    return dict(losses=losses, mean_ms=mean_ms, err=err)


def dropout_capture_phase(np, torch, fluid, kernels):
    """A dropout program (x * w, dropout 0.1 as the train step's, a mean
    of squares, SGD on w) at a train-step dropout site's size under
    ``run_multi_step``: on a fresh executor it is captured (no eager
    ``run_multi_step``, one graph) and its replays equal, loss for loss
    and in the final w, the eager loop's (``FLAGS_cuda_graph=0``) on
    another fresh executor, with one threefry launch a step in both."""
    from paddle_tpu_torch import flags, unique_name

    rows = DROPOUT_SITE[0] * DROPOUT_SITE[1]
    feed = {"x": np.random.RandomState(SEED).rand(
        rows, D_MODEL).astype("float32")}
    res = {}
    for label, graph in (("captured", "1"), ("eager", "0")):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = TRAIN_SEED
        with unique_name.guard({}), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[D_MODEL], dtype="float32")
            w = fluid.layers.create_parameter(
                [D_MODEL], "float32", attr=fluid.ParamAttr(
                    name="drop_w",
                    initializer=fluid.initializer.Uniform(0.5, 1.5)))
            y = fluid.layers.dropout(fluid.layers.elementwise_mul(x, w),
                                     dropout_prob=DROPOUT)
            loss = fluid.layers.mean(fluid.layers.elementwise_mul(y, y))
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        flags.set_flag("cuda_graph", graph)
        try:
            torch.cuda.synchronize()
            kernels["threefry"].reset()
            t0 = time.perf_counter()
            losses = [exe.run_multi_step(
                main, DROP_CAPTURE_STEPS, feed=feed, fetch_list=[loss],
                scope=scope, stack_fetches=True)[0]
                for _ in range(DROP_CAPTURE_CALLS)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            flags.set_flag("cuda_graph", "1")
        res[label] = dict(losses=np.concatenate(losses).reshape(-1),
                          w=np.asarray(scope.get_value("drop_w").cpu()),
                          eager=exe.eager_multi_step,
                          graphs=exe.graph_stats(main)["graphs"],
                          threefry=kernels["threefry"].launches, wall=wall)
        exe.close()
    c, e = res["captured"], res["eager"]
    want = DROP_CAPTURE_STEPS * DROP_CAPTURE_CALLS
    print("dropout capture: %d run_multi_step calls of %d steps, x [%d, %d]: "
          "captured graphs %d, eager run_multi_step calls %d (the eager "
          "executor's %d); losses equal %s (first %.6f, last %.6f), w "
          "equal %s; threefry launches %d and %d (want %d); wall %.3f s and "
          "%.3f s" % (DROP_CAPTURE_CALLS, DROP_CAPTURE_STEPS, rows, D_MODEL,
                      c["graphs"], c["eager"], e["eager"],
                      np.array_equal(c["losses"], e["losses"]),
                      c["losses"][0], c["losses"][-1],
                      np.array_equal(c["w"], e["w"]), c["threefry"],
                      e["threefry"], want, c["wall"], e["wall"]))
    if c["graphs"] != 1 or c["eager"] != 0:
        fail("dropout capture: the random program was not captured (%d "
             "graphs, %d eager calls)" % (c["graphs"], c["eager"]))
    if e["eager"] != DROP_CAPTURE_CALLS:
        fail("dropout capture: the eager executor counted %d eager calls"
             % e["eager"])
    if not (np.array_equal(c["losses"], e["losses"])
            and np.array_equal(c["w"], e["w"])):
        fail("dropout capture: the replays differ from the eager loop")
    if len(set(c["losses"].tolist())) < 2:
        fail("dropout capture: every step gave the same loss")
    if c["threefry"] != want or e["threefry"] != want:
        fail("dropout capture: threefry launched %d and %d times, want %d"
             % (c["threefry"], e["threefry"], want))
    return c["threefry"]


def cpu_copy(np, fluid, program, scope, device="cpu"):
    """A CPU scope (or one on ``device``) holding every persistable of
    ``program`` that the card's ``scope`` holds: the CPU side of a
    card-against-CPU run starts where the card's starts without running
    the startup program again (on the CPU its plain threefry draws of 93
    M parameters take tens of seconds, and ``set_deterministic_params``
    overwrites the parameters anyway). A persistable the card's scope
    lacks raises."""
    from paddle_tpu_torch.convert import persistables_from_numpy

    arrays = {}
    for v in program.global_block().vars.values():
        val = scope.get_value(v.name) if v.persistable else None
        if val is not None:
            arrays[v.name] = (val.cpu().numpy() if hasattr(val, "cpu")
                              else np.asarray(val))
    cpu_scope = fluid.Scope()
    persistables_from_numpy(program, cpu_scope, arrays, device)
    return cpu_scope


def train_card_vs_cpu_phase(np, torch, fluid, exe):
    from paddle_tpu_torch.testing import set_deterministic_params

    main, startup, loss, params_grads = build_train(fluid, 0.0)
    feed = {k: v[:CVC_BATCH] for k, v in train_feed(np, TRAIN_BATCH).items()}
    grad_names = [g.name for _, g in params_grads]
    losses, grads = {}, {}
    card_scope = fluid.Scope()
    exe.run(startup, scope=card_scope)
    set_deterministic_params(main, card_scope, parameters_only=True)
    cpu_scope = cpu_copy(np, fluid, main, card_scope)
    for dev, ex, scope in (
            ("card", exe, card_scope),
            ("cpu", fluid.Executor(fluid.CPUPlace()), cpu_scope)):
        losses[dev] = []
        for i in range(CVC_STEPS):
            out = ex.run(main, feed=feed, scope=scope,
                         fetch_list=[loss] + (grad_names if i == 0 else []))
            losses[dev].append(float(np.asarray(out[0]).reshape(-1)[0]))
            if i == 0:
                grads[dev] = out[1:]
    err = max(abs(a - b) for a, b in zip(losses["card"], losses["cpu"]))
    g_err = max(float(np.abs(a - b).max())
                for a, b in zip(grads["card"], grads["cpu"]))
    g_mag = max(float(np.abs(a).max()) for a in grads["cpu"])
    print("train card vs cpu: batch %d, %d Adam steps, losses card %s cpu %s: "
          "max abs diff %.3e  tol %.0e" % (CVC_BATCH, CVC_STEPS,
                                           losses["card"], losses["cpu"],
                                           err, TRAIN_LOSS_TOL))
    print("train card vs cpu: step 1 gradients of %d parameters: max abs diff "
          "%.3e (largest gradient entry %.3e)"
          % (len(grad_names), g_err, g_mag))
    if not np.isfinite(losses["card"]).all() or not err <= TRAIN_LOSS_TOL:
        fail("card and CPU train losses disagree: %.3e" % err)
    return err


def amp_card_vs_cpu(np, fluid, exe, label, main, loss, card_scope, feed,
                    steps):
    """An AMP program's losses over ``steps`` steps on the card against
    the CPU's, both from copies of ``card_scope``: per step within
    ``AMP_GAP_FACTOR`` times the CPU's own gap between its AMP and float32
    losses (the same program with the rewrite off), or ``AMP_LOSS_FLOOR``
    of the loss where that is larger. Returns the largest ratio of a
    step's difference to its bound."""
    from paddle_tpu_torch.transpiler import rewrite_program_amp

    cpu = fluid.Executor(fluid.CPUPlace())
    scopes = {"cpu": cpu_copy(np, fluid, main, card_scope),
              "cpu fp32": cpu_copy(np, fluid, main, card_scope),
              "card": card_scope}
    losses = {}
    for dev, ex in (("card", exe), ("cpu", cpu), ("cpu fp32", cpu)):
        rewrite_program_amp(main, None if dev == "cpu fp32" else "bfloat16")
        losses[dev] = [float(np.asarray(ex.run(
            main, feed=feed, scope=scopes[dev],
            fetch_list=[loss])[0]).reshape(-1)[0]) for _ in range(steps)]
    rewrite_program_amp(main, "bfloat16")
    worst = 0.0
    for c, a, f in zip(losses["card"], losses["cpu"], losses["cpu fp32"]):
        tol = max(AMP_GAP_FACTOR * abs(a - f), AMP_LOSS_FLOOR * abs(a))
        worst = max(worst, abs(c - a) / tol)
    print("%s card vs cpu: %d steps, AMP losses card %s cpu %s (cpu fp32 "
          "%s): the largest step difference is %.3f of its bound (%g x the "
          "CPU's AMP-to-fp32 gap, at least %.2e of the loss)"
          % (label, steps, ["%.6f" % v for v in losses["card"]],
             ["%.6f" % v for v in losses["cpu"]],
             ["%.6f" % v for v in losses["cpu fp32"]], worst,
             AMP_GAP_FACTOR, AMP_LOSS_FLOOR))
    if not np.isfinite(losses["card"]).all() or not worst <= 1.0:
        fail("%s: card and CPU AMP losses disagree (%.3f of the bound)"
             % (label, worst))
    return worst


def amp_train_card_vs_cpu_phase(np, torch, fluid, exe):
    """Step 15's AMP Transformer at ``AMP_CVC_LAYERS`` layers (dropout 0,
    batch ``CVC_BATCH``, seeded parameters) on the card and the CPU
    (``amp_card_vs_cpu``)."""
    from paddle_tpu_torch.testing import set_deterministic_params

    main, startup, loss, _ = build_train(fluid, 0.0, amp=True,
                                         n_layer=AMP_CVC_LAYERS)
    feed = {k: v[:CVC_BATCH] for k, v in train_feed(np, TRAIN_BATCH).items()}
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope, parameters_only=True)
    return amp_card_vs_cpu(np, fluid, exe, "amp train (%d layers, batch %d)"
                           % (AMP_CVC_LAYERS, CVC_BATCH), main, loss, scope,
                           feed, CVC_STEPS)


# -- the RNN path: B6 (lstm_cell) and B7 (gru_cell) ------------------------------

def rnn_lens(torch, gen, batch, seq, low):
    return torch.randint(low, seq + 1, (batch,), generator=gen,
                         device="cuda")


def rnn_case_tensors(torch, gen, B, T, D, gates, lens, init, reverse):
    """The tensors every recurrence case has: inputs scaled so that the
    gate sums stay O(1), the step mask of ``lens`` (time-flipped for a
    reverse pass, as the op flips it) and an optional initial state."""
    def rnd(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * s

    if isinstance(lens, list):
        lens = torch.tensor(lens, device="cuda")
    mask = None
    if lens is not None:
        mask = (torch.arange(T, device="cuda")[None, :]
                < lens[:, None]).float()
        if reverse:
            mask = mask.flip(1)
    return dict(xw=rnd(B, T, gates * D, s=0.5),
                w=rnd(D, gates * D, s=D ** -0.5), bias=rnd(gates * D, s=0.1),
                mask=mask, h0=rnd(B, D, s=0.5) if init else None,
                peep=rnd(3, D, s=0.1), c0=rnd(B, D, s=0.5) if init else None)


def lstm_case(torch, gen, B, T, D, peep=True, lens=None, init=False,
              reverse=False, acts=("sigmoid", "tanh", "tanh")):
    """kwargs of ``lstm_cell_forward`` (and ``lstm_reference``)."""
    t = rnn_case_tensors(torch, gen, B, T, D, 4, lens, init, reverse)
    return dict(xw=t["xw"], w_h=t["w"], bias=t["bias"],
                peephole=t["peep"] if peep else None, mask=t["mask"], h0=t["h0"],
                c0=t["c0"], gate_act=acts[0], cell_act=acts[1],
                cand_act=acts[2])


def gru_case(torch, gen, B, T, D, lens=None, init=False, reverse=False,
             acts=("sigmoid", "tanh"), sliced=True):
    """kwargs of ``gru_cell_forward`` (and ``gru_reference``); ``sliced``
    passes the gate and candidate weights as column slices of one
    ``[D, 3D]`` weight, as ``dynamic_gru`` does."""
    t = rnn_case_tensors(torch, gen, B, T, D, 3, lens, init, reverse)
    w_gate, w_cand = t["w"][:, :2 * D], t["w"][:, 2 * D:]
    if not sliced:
        w_gate, w_cand = w_gate.contiguous(), w_cand.contiguous()
    return dict(xw=t["xw"], w_gate=w_gate, w_cand=w_cand, bias=t["bias"],
                mask=t["mask"], h0=t["h0"], gate_act=acts[0],
                cand_act=acts[1])


def rnn_plan(kname):
    """B6's or B7's launch-plan function (``lstm_plan``, ``gru_plan``)."""
    from paddle_tpu_torch.kernels import gru_cell as gc
    from paddle_tpu_torch.kernels import lstm_cell as lc

    return {"lstm_cell": lc.lstm_plan, "gru_cell": gc.gru_plan}[kname]


def regime_limit(kname):
    """The largest width that the kernel's plan runs in regime (a) (all
    weights in one block) at batch 5 on this card."""
    from paddle_tpu_torch.kernels.build import device_limits

    limits = device_limits("cuda")
    return max(D for D in range(1, 257)
               if rnn_plan(kname)(5, D, *limits)["regime"] == "a")


def l2_width(kname):
    """The narrowest width from 1400 up whose weight slice the kernel's
    plan reads from L2 at batch 3 on this card."""
    from paddle_tpu_torch.kernels.build import device_limits

    limits = device_limits("cuda")
    return next(D for D in range(1400, 4097)
                if rnn_plan(kname)(3, D, *limits)["w"] == "l2")


def lstm_cases(torch, gen):
    """(name, kwargs, relative tolerance?) at the main path's shapes and
    the edge cases: D not a multiple of 32, both sides of the plan's
    regime switch, a W_h slice that stays resident (D 1100) and one that
    is read from L2 (D 1400), B 1 and 33, hidden units not a multiple
    of the units per block, T = 1, rows of length 0, every activation
    code, with and without peepholes, mask, initial state and
    reverse."""
    B, T = RNN_BATCH, RNN_SEQ
    lim = regime_limit("lstm_cell")
    ragged = rnn_lens(torch, gen, B, T, RNN_MIN_LEN)
    mt_lens = rnn_lens(torch, gen, MT_BATCH, MT_SEQ, 8)
    srl_lens = rnn_lens(torch, gen, SRL_BATCH, SRL_LEN, SRL_MIN_LEN)
    edge = [6, 4, 6, 2, 5]
    return [
        ("stacked_D512", lstm_case(torch, gen, B, T, RNN_HID, lens=ragged),
         False),
        ("full_nopeep_D512", lstm_case(torch, gen, B, T, RNN_HID,
                                       peep=False), False),
        ("stacked_D64", lstm_case(torch, gen, B, T, RNN_PKG_HID,
                                  lens=ragged), False),
        ("mt_reverse_D64", lstm_case(torch, gen, MT_BATCH, MT_SEQ, 64,
                                     peep=False, lens=mt_lens, reverse=True),
         False),
        ("D40_B5_T7_len0_h0c0", lstm_case(torch, gen, 5, 7, 40,
                                          lens=[7, 3, 0, 5, 1], init=True),
         False),
        ("D1100_B3_T3_h0c0", lstm_case(torch, gen, 3, 3, 1100, init=True),
         False),
        ("D%d_B5_T7_regime_a_limit" % lim, lstm_case(
            torch, gen, 5, 7, lim, lens=[7, 3, 0, 5, 1], init=True), False),
        ("D%d_B5_T7_regime_b" % (lim + 1), lstm_case(
            torch, gen, 5, 7, lim + 1, lens=[7, 3, 0, 5, 1], init=True),
         False),
        ("D1400_B3_T3_streamed", lstm_case(torch, gen, 3, 3, 1400,
                                           init=True), False),
        ("B1_D512_T9", lstm_case(torch, gen, 1, 9, 512), False),
        ("B33_D512_T9_h0c0", lstm_case(torch, gen, 33, 9, 512, init=True,
                                       lens=rnn_lens(torch, gen, 33, 9, 0)),
         False),
        ("B7_D515_T5_units_ragged", lstm_case(torch, gen, 7, 5, 515,
                                              lens=[5, 0, 3, 5, 1, 2, 4]),
         False),
        # rows in several passes per block; h staged in k-chunks
        ("B300_D512_T4_passes", lstm_case(torch, gen, 300, 4, 512,
                                          init=True), False),
        ("B32_D1100_T3_chunks", lstm_case(torch, gen, 32, 3, 1100,
                                          lens=rnn_lens(torch, gen, 32, 3, 0)),
         False),
        ("T1_B6_D96_nopeep", lstm_case(torch, gen, 6, 1, 96, peep=False,
                                       lens=[1, 0, 1, 1, 0, 1]), False),
        ("acts_tanh_relu_identity", lstm_case(
            torch, gen, 5, 6, 48, lens=edge,
            acts=("tanh", "relu", "identity")), True),
        ("acts_relu_identity_sigmoid", lstm_case(
            torch, gen, 5, 6, 48, lens=edge, init=True,
            acts=("relu", "identity", "sigmoid")), True),
        ("acts_identity_sigmoid_relu", lstm_case(
            torch, gen, 5, 6, 48, lens=edge, peep=False,
            acts=("identity", "sigmoid", "relu")), True),
        # the role labeller's layers: D 128, sigmoid cell, relu candidate
        ("srl_D128_sigmoid_relu", lstm_case(
            torch, gen, SRL_BATCH, SRL_LEN, SRL_HIDDEN // 4, lens=srl_lens,
            acts=("sigmoid", "sigmoid", "relu")), True),
        ("srl_D128_sigmoid_relu_reverse", lstm_case(
            torch, gen, SRL_BATCH, SRL_LEN, SRL_HIDDEN // 4, lens=srl_lens,
            reverse=True, acts=("sigmoid", "sigmoid", "relu")), True),
    ]


def gru_cases(torch, gen):
    """(name, kwargs, relative tolerance?) of B7: the network's shapes at
    widths 512 and 64 and the first edge cases, then the redesign's: both
    sides of ``gru_plan``'s regime switch, B 1, 5 and 33, hidden units
    not a multiple of the units per block, every row of length 0 (both
    regimes), D 1400 and the narrowest width whose weight slice is read
    from L2, a block's rows in several passes (u through scratch), h
    staged in k-chunks, and relu / identity in regime (b)."""
    B, T = RNN_BATCH, RNN_SEQ
    ragged = rnn_lens(torch, gen, B, T, RNN_MIN_LEN)
    edge = [6, 4, 6, 2, 5]
    lim = regime_limit("gru_cell")
    wide = l2_width("gru_cell")
    return [
        ("net_D512", gru_case(torch, gen, B, T, RNN_HID, lens=ragged), False),
        ("net_D64", gru_case(torch, gen, B, T, RNN_PKG_HID, lens=ragged),
         False),
        ("D40_B5_T7_len0_h0_reverse", gru_case(
            torch, gen, 5, 7, 40, lens=[7, 3, 0, 5, 1], init=True,
            reverse=True), False),
        ("D1100_B3_T3_contiguous", gru_case(torch, gen, 3, 3, 1100,
                                            sliced=False), False),
        ("T1_B6_D96", gru_case(torch, gen, 6, 1, 96, lens=[1, 0, 1, 1, 0, 1]),
         False),
        ("acts_tanh_relu", gru_case(torch, gen, 5, 6, 48, lens=edge,
                                    acts=("tanh", "relu")), True),
        ("acts_relu_identity", gru_case(torch, gen, 5, 6, 48, lens=edge,
                                        init=True,
                                        acts=("relu", "identity")), True),
        ("acts_identity_sigmoid", gru_case(torch, gen, 5, 6, 48,
                                           acts=("identity", "sigmoid")),
         True),
        ("D%d_B5_T7_regime_a_limit" % lim, gru_case(
            torch, gen, 5, 7, lim, lens=[7, 3, 0, 5, 1], init=True), False),
        ("D%d_B5_T7_regime_b" % (lim + 1), gru_case(
            torch, gen, 5, 7, lim + 1, lens=[7, 3, 0, 5, 1], init=True),
         False),
        ("B1_D512_T9", gru_case(torch, gen, 1, 9, 512), False),
        ("B5_D512_T7_h0", gru_case(torch, gen, 5, 7, 512,
                                   lens=[7, 3, 0, 5, 1], init=True), False),
        ("B33_D512_T9_h0", gru_case(torch, gen, 33, 9, 512, init=True,
                                    lens=rnn_lens(torch, gen, 33, 9, 0)),
         False),
        ("B7_D515_T5_units_ragged", gru_case(torch, gen, 7, 5, 515,
                                             lens=[5, 0, 3, 5, 1, 2, 4]),
         False),
        ("all_len0_B4_D512_h0", gru_case(torch, gen, 4, 5, 512,
                                         lens=[0, 0, 0, 0], init=True),
         False),
        ("all_len0_B4_D64", gru_case(torch, gen, 4, 5, 64,
                                     lens=[0, 0, 0, 0]), False),
        ("D1400_B3_T3_h0", gru_case(torch, gen, 3, 3, 1400, init=True,
                                    lens=[3, 1, 0]), False),
        ("D%d_B3_T3_streamed" % wide, gru_case(torch, gen, 3, 3, wide,
                                               init=True), False),
        ("B300_D512_T4_passes", gru_case(torch, gen, 300, 4, 512, init=True,
                                         lens=rnn_lens(torch, gen, 300, 4,
                                                       0)), False),
        ("B32_D1100_T3_chunks", gru_case(torch, gen, 32, 3, 1100,
                                         lens=rnn_lens(torch, gen, 32, 3, 0)),
         False),
        ("acts_relu_identity_D200_regime_b", gru_case(
            torch, gen, 5, 6, 200, lens=edge, init=True,
            acts=("relu", "identity")), True),
        # CRNN's GRUs: D 200, relu candidate, forward and reverse
        ("crnn_D200_relu", gru_case(
            torch, gen, CRNN_BATCH, CRNN_IMG[2] // 8, CRNN_RNN,
            acts=("sigmoid", "relu")), True),
        ("crnn_D200_relu_reverse_ragged", gru_case(
            torch, gen, CRNN_BATCH, CRNN_IMG[2] // 8, CRNN_RNN,
            lens=rnn_lens(torch, gen, CRNN_BATCH, CRNN_IMG[2] // 8, 4),
            reverse=True, acts=("sigmoid", "relu")), True),
    ]


def rnn_check(torch, kname, name, outs, refs, kw, relative):
    """Max abs error of a recurrence case over its outputs (over max(1,
    max |ref|) where ``relative``: relu and identity activations grow the
    values); rows of length 0 must hold their initial state exactly."""
    err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
    scale = max(1.0, max(r.abs().max().item() for r in refs))
    shown = err / scale if relative else err
    mask = kw["mask"]
    dead = (mask.sum(dim=1) == 0) if mask is not None else None
    n_dead = int(dead.sum()) if dead is not None else 0
    if n_dead:
        for o, init in zip(outs, (kw["h0"], kw.get("c0"))):
            want = (init[dead] if init is not None
                    else torch.zeros_like(o[dead][:, 0]))
            if not torch.equal(o[dead], want[:, None, :].expand_as(o[dead])):
                fail("%s %s: a row of length 0 left its initial state"
                     % (kname, name))
    print("kernel %s %-28s max_abs_err %.3e%s  tol %.0e  rows of length 0 "
          "%d" % (kname, name, err, (" (relative %.3e, |ref| up to %.3g)"
                                     % (shown, scale)) if relative else "",
                  RNN_TOL, n_dead))
    if not (all(torch.isfinite(o).all() for o in outs)
            and shown <= RNN_TOL):
        fail("%s %s: error %.3e above %.0e" % (kname, name, shown, RNN_TOL))
    return err


def plan_line(kname, B, D):
    """B6's or B7's launch plan for batch B and width D on this card, in
    words."""
    from paddle_tpu_torch.kernels.build import device_limits

    p = rnn_plan(kname)(B, D, *device_limits("cuda"))
    return ("regime %s%s, %d blocks x %d threads, %d units x %d rows per "
            "block, %d B shared%s%s" % (
                p["regime"], " (cooperative)" if p["regime"] == "b" else "",
                p["blocks"], p["threads"], p["units"], p["rows"], p["smem"],
                {"shared": "", "registers": ", weights in registers",
                 "l2": ", weight slice read from L2"}[p["w"]],
                ", h staged %d columns at a time" % p["kc"]
                if p["kc"] < D else ""))


def rnn_layout_phase():
    """B6's and B7's plans against the kernels: at every batch and width
    below, the threads, shared-memory bytes and blocks of ``lstm_plan``
    (``lstm_layout``) and ``gru_plan`` (``gru_layout``) equal those
    csrc/lstm_cell.cu and csrc/gru_cell.cu derive from the plan's
    choices (``kernel_layout``), and the kernels take the plans."""
    from paddle_tpu_torch.kernels import lstm_cell as lc
    from paddle_tpu_torch.kernels.build import device_limits

    limits = device_limits("cuda")
    shapes = [(B, D) for B in (1, 3, 4, 5, 7, 32, 33, 300)
              for D in list(range(1, 200)) + [200, 256, 512, 515, 1100,
                                              1400, l2_width("gru_cell"),
                                              2048]]
    for kname, symbol in (("lstm_cell", "paddle_lstm_layout"),
                          ("gru_cell", "paddle_gru_layout")):
        for B, D in shapes:
            plan = rnn_plan(kname)(B, D, *limits)
            want = (plan["threads"], plan["smem"], plan["blocks"])
            got = lc.kernel_layout(B, D, plan, symbol)
            if got != want or plan["smem"] > limits[1]:
                fail("%s B %d D %d: the plan's (threads, smem, blocks) %s, "
                     "the kernel's %s, limit %d" % (kname, B, D, want, got,
                                                    limits[1]))
        print("%s layout: the plan's threads, shared bytes and blocks "
              "equal the kernel's at %d (batch, width) pairs"
              % (kname, len(shapes)))


def rnn_kernel_phase(torch):
    """B6 and B7 against their plain versions on the same CUDA tensors;
    returns the worst absolute error of each over its absolute-tolerance
    cases."""
    from paddle_tpu_torch.kernels import gru_cell as gc
    from paddle_tpu_torch.kernels import lstm_cell as lc

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {"lstm_cell": 0.0, "gru_cell": 0.0}
    for kname, cases, kern, plain in (
            ("lstm_cell", lstm_cases(torch, gen), lc.lstm_cell_forward,
             lc.lstm_reference),
            ("gru_cell", gru_cases(torch, gen), gc.gru_cell_forward,
             gc.gru_reference)):
        for name, kw, relative in cases:
            print("plan %s %-28s %s" % (kname, name, plan_line(
                kname, kw["xw"].shape[0], kw["xw"].shape[2] // (
                    4 if kname == "lstm_cell" else 3))))
            outs, refs = kern(**kw), plain(**kw)
            torch.cuda.synchronize()
            if kname == "gru_cell":
                outs, refs = (outs,), (refs,)
            err = rnn_check(torch, kname, name, outs, refs, kw, relative)
            if not relative:
                worst[kname] = max(worst[kname], err)
    return worst


def rnn_timing_phase(torch):
    """Kernel, plain version, bound and library times of B6 and B7 at
    the stacked network's shape (ragged lengths, B6 with peepholes: no
    library call computes it) and, for B6, at full lengths without
    peepholes beside ``torch.nn.LSTM`` (cuDNN, which also does the input
    product that B6 leaves outside), at widths 512 and 64."""
    from paddle_tpu_torch.kernels import gru_cell as gc
    from paddle_tpu_torch.kernels import lstm_cell as lc

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    B, T = RNN_BATCH, RNN_SEQ
    rows = {}
    for D in (RNN_HID, RNN_PKG_HID):
        ragged = rnn_lens(torch, gen, B, T, RNN_MIN_LEN)
        V = float(ragged.sum())  # valid steps: the work these inputs need
        span = "lengths %d..%d (%d of %d steps valid)" % (
            int(ragged.min()), int(ragged.max()), V, B * T)
        kw = copies(lstm_case(torch, gen, B, T, D, lens=ragged))
        rows["lstm_cell_D%d" % D] = dict(
            shape="xw [%d,%d,%d], peepholes, %s" % (B, T, 4 * D, span),
            ms=cuda_ms(lc.lstm_cell_forward, kw),
            plain_ms=cuda_ms(lc.lstm_reference, kw, iters=6, reps=3),
            library_ms=None,
            bound=bound(4.0 * (V * 4 * D + 2 * B * T * D + 4 * D * D + 7 * D
                               + B * T), 8.0 * V * D * D))
        kw = copies(lstm_case(torch, gen, B, T, D, peep=False))
        lstm = torch.nn.LSTM(D, D, batch_first=True).cuda()
        xs = [torch.randn(B, T, D, generator=gen, device="cuda")
              for _ in range(3)]
        with torch.no_grad():
            lib_ms = device_ms(torch, lambda i: lstm(xs[i]), xs)
        rows["lstm_cell_D%d_full" % D] = dict(
            shape="xw [%d,%d,%d], no peepholes, full lengths" % (B, T, 4 * D),
            ms=cuda_ms(lc.lstm_cell_forward, kw),
            plain_ms=cuda_ms(lc.lstm_reference, kw, iters=6, reps=3),
            library_ms=lib_ms,
            bound=bound(4.0 * (B * T * 4 * D + 2 * B * T * D + 4 * D * D
                               + 4 * D), 8.0 * B * T * D * D))
        if D == RNN_PKG_HID:
            # the MT encoder's reverse pass, as mt_phase runs it
            lens = rnn_lens(torch, gen, MT_BATCH, MT_SEQ, 8)
            Vm = float(lens.sum())
            kw = copies(lstm_case(torch, gen, MT_BATCH, MT_SEQ, D,
                                  peep=False, lens=lens, reverse=True))
            rows["lstm_cell_mt"] = dict(
                shape="xw [%d,%d,%d], no peepholes, reverse, lengths %d..%d "
                "(%d of %d steps valid)" % (
                    MT_BATCH, MT_SEQ, 4 * D, int(lens.min()),
                    int(lens.max()), Vm, MT_BATCH * MT_SEQ),
                ms=cuda_ms(lc.lstm_cell_forward, kw),
                plain_ms=cuda_ms(lc.lstm_reference, kw, iters=6, reps=3),
                library_ms=None,
                bound=bound(4.0 * (Vm * 4 * D + 2 * MT_BATCH * MT_SEQ * D
                                   + 4 * D * D + 4 * D + MT_BATCH * MT_SEQ),
                            8.0 * Vm * D * D))
        kw = copies(gru_case(torch, gen, B, T, D, lens=ragged))
        rows["gru_cell_D%d" % D] = dict(
            shape="xw [%d,%d,%d], %s" % (B, T, 3 * D, span),
            ms=cuda_ms(gc.gru_cell_forward, kw),
            plain_ms=cuda_ms(gc.gru_reference, kw, iters=6, reps=3),
            library_ms=None,
            bound=bound(4.0 * (V * 3 * D + B * T * D + 3 * D * D + 3 * D
                               + B * T), 6.0 * V * D * D))
    return rows


def sentiment_batches(np, n, batch, seq, seed):
    """``n`` feeds of the synthetic separable sentiment data of
    tests/test_models_rnn.py:10 (class 0 draws its tokens from the low
    half of the dictionary, class 1 from the high half), lengths uniform
    in 16..seq; made in bulk before the timed steps."""
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(n):
        lens = rng.randint(RNN_MIN_LEN, seq + 1, batch)
        labels = rng.randint(0, 2, (batch, 1))
        words = np.zeros((batch, seq), "int64")
        for i in range(batch):
            lo, hi = ((2, RNN_DICT // 2) if labels[i, 0] == 0
                      else (RNN_DICT // 2, RNN_DICT - 1))
            words[i, :lens[i]] = rng.randint(lo, hi, lens[i])
        feeds.append({"words": words,
                      "length": lens.reshape(-1, 1).astype("int64"),
                      "label": labels.astype("int64")})
    return feeds


def gru_net(fluid, seq, hid, stacked):
    """The stacked network of models/stacked_lstm.py with dynamic_gru in
    place of dynamic_lstm, from the public layers (no model of the
    package uses dynamic_gru)."""
    layers = fluid.layers
    data = layers.data(name="words", shape=[seq], dtype="int64")
    length = layers.data(name="length", shape=[1], dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="int64")
    emb = layers.embedding(input=data, size=[RNN_DICT, hid])
    fc = layers.fc(input=emb, size=hid * 3, num_flatten_dims=2)
    inputs = [fc, layers.dynamic_gru(input=fc, size=hid, length=length)]
    for _ in range(2, stacked + 1):
        fc = layers.fc(input=inputs, size=hid * 3, num_flatten_dims=2)
        inputs = [fc, layers.dynamic_gru(input=fc, size=hid, length=length)]
    pooled = [layers.sequence_pool(input=x, pool_type="max", length=length)
              for x in inputs]
    prediction = layers.fc(input=pooled, size=2, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=prediction, label=label))
    return loss, {"predict": prediction,
                  "accuracy": layers.accuracy(input=prediction, label=label)}


def build_rnn(fluid, cell, hid=RNN_HID):
    """(main, startup, inference program, loss, outs) of the stacked
    network (``stacked_lstm.build`` for "lstm", :func:`gru_net` for
    "gru") with Adam; the inference program is
    ``clone(for_test=True)`` of the forward program."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import stacked_lstm

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = TRAIN_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        if cell == "lstm":
            loss, _, outs = stacked_lstm.build(
                seq_len=RNN_SEQ, dict_size=RNN_DICT, emb_dim=hid,
                hid_dim=hid, stacked_num=RNN_STACK)
        else:
            loss, outs = gru_net(fluid, RNN_SEQ, hid, RNN_STACK)
        infer = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=RNN_LR).minimize(loss)
    return main, startup, infer, loss, outs


def rnn_train_phase(np, torch, fluid, exe, kernels, cell):
    """Trains the stacked network at width 512 (2 warm-up, 20 timed
    steps, a fresh batch each step); gates on finite losses, a loss that
    falls by 0.1 nat (mean of the last 5 steps below the first warm-up
    step), 3 launches of the cell's kernel per step and no grad-op
    rerun.
    Returns (launches in the timed steps, scope, inference program,
    outs)."""
    kname = "lstm_cell" if cell == "lstm" else "gru_cell"
    main, startup, infer, loss, outs = build_rnn(fluid, cell)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    feeds = sentiment_batches(np, RNN_WARMUP + RNN_STEPS + 2, RNN_BATCH,
                              RNN_SEQ, SEED)
    print("rnn %s train: program of %d ops, %.2f M parameters, batch %d x "
          "%d, %d layers of width %d, Adam(%g)"
          % (cell, len(main.global_block().ops), n_params / 1e6, RNN_BATCH,
             RNN_SEQ, RNN_STACK, RNN_HID, RNN_LR))
    # the separable data is learnt fast: the loss falls from the first
    # warm-up step on
    first = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                      scope=scope)[0]).reshape(-1)[0])
             for f in feeds[:RNN_WARMUP]][0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.reset()
    losses, step_ms, per_step, tokens = [], [], [], []
    reran = exe.grad_op_reruns
    for i, f in enumerate(feeds[RNN_WARMUP:RNN_WARMUP + RNN_STEPS]):
        before = kernels[kname].launches
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        per_step.append(kernels[kname].launches - before)
        tokens.append(int(f["length"].sum()))
        print("rnn %s train step %2d: loss %.6f  wall %.1f ms  %s launches "
              "%d" % (cell, i + 1, losses[-1], step_ms[-1], kname,
                      per_step[-1]))
    launches = kernels[kname].launches
    peak = torch.cuda.max_memory_allocated()
    mean_ms = float(np.mean(step_ms))
    print("rnn %s train: %d steps, mean %.1f ms/step (min %.1f, max %.1f), "
          "%.0f non-pad tokens/s; peak memory %.2f GiB"
          % (cell, RNN_STEPS, mean_ms, min(step_ms), max(step_ms),
             sum(tokens) / sum(step_ms) * 1e3, peak / 2 ** 30))
    if not np.isfinite(losses).all():
        fail("a %s train loss is not finite: %s" % (cell, losses))
    reran = exe.grad_op_reruns - reran
    print("rnn %s train: grad-op reruns in the timed steps %d"
          % (cell, reran))
    if any(c != RNN_STACK for c in per_step):
        fail("%s per-step launches %s, expected %d (each layer's forward "
             "once: its grad op differentiates the forward tape)"
             % (kname, per_step, RNN_STACK))
    if reran:
        fail("%d grad ops reran their forward in the %s train steps"
             % (reran, cell))
    late = float(np.mean(losses[-5:]))
    print("rnn %s train: loss of the first warm-up step %.6f, timed step 1 "
          "%.6f, mean of steps 16-20 %.6f (gate: %.1f nat below the first)"
          % (cell, first, losses[0], late, LOSS_DROP))
    if not late <= first - LOSS_DROP:
        fail("the %s train loss did not fall by %.1f nat" % (cell, LOSS_DROP))
    profile_call(torch, "rnn %s train" % cell, lambda: exe.run(
        main, feed=feeds[-2], fetch_list=[loss], scope=scope))
    return launches, scope, infer, outs, feeds[-1]


def rnn_infer_phase(np, torch, exe, kernels, scope, infer, outs, feed):
    """The trained stacked LSTM's inference program on one batch,
    ``RNN_INFER_RUNS`` times: predictions/s and stacked_num launches of
    lstm_cell per run."""
    exe.run(infer, feed=feed, fetch_list=[outs["predict"]], scope=scope)
    torch.cuda.synchronize()
    kernels["lstm_cell"].reset()
    t0 = time.perf_counter()
    for _ in range(RNN_INFER_RUNS):
        pred, acc = exe.run(infer, feed=feed, scope=scope,
                            fetch_list=[outs["predict"], outs["accuracy"]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels["lstm_cell"].launches
    pred = np.asarray(pred)
    print("rnn lstm infer: %d runs of batch %d: %.1f ms per run, %.0f "
          "predictions/s, accuracy on an unseen batch %.3f, lstm_cell "
          "launches %d" % (RNN_INFER_RUNS, RNN_BATCH,
                           wall / RNN_INFER_RUNS * 1e3,
                           RNN_INFER_RUNS * RNN_BATCH / wall,
                           float(np.asarray(acc).reshape(-1)[0]), launches))
    if launches != RNN_STACK * RNN_INFER_RUNS:
        fail("lstm_cell launched %d times in %d inference runs, expected %d"
             % (launches, RNN_INFER_RUNS, RNN_STACK * RNN_INFER_RUNS))
    if (pred.shape != (RNN_BATCH, 2) or not np.isfinite(pred).all()
            or not np.allclose(pred.sum(axis=1), 1.0, atol=1e-5)):
        fail("stacked LSTM predictions are not a [%d, 2] softmax"
             % RNN_BATCH)
    return launches


def mt_phase(np, torch, fluid, exe, kernels):
    """The machine-translation training graph at build()'s defaults (64
    wide, sequence length 32, batch 32, ragged source lengths), a few
    Adam steps: 2 lstm_cell launches per step (the forward and the
    reverse encoder pass, once each: the grad ops differentiate the
    forward tape) and no grad-op rerun."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import machine_translation as mt

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = TRAIN_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        loss, _, _ = mt.build()
        fluid.optimizer.Adam(learning_rate=RNN_LR).minimize(loss)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    tgt_len = rng.randint(8, MT_SEQ + 1, MT_BATCH)
    feed = {
        "source_sequence": rng.randint(1, 1000, (MT_BATCH, MT_SEQ)),
        "source_length": rng.randint(8, MT_SEQ + 1, (MT_BATCH, 1)),
        "target_sequence": rng.randint(1, 1000, (MT_BATCH, MT_SEQ)),
        "label": rng.randint(1, 1000, (MT_BATCH, MT_SEQ)),
        "label_mask": (np.arange(MT_SEQ)[None, :]
                       < tgt_len[:, None]).astype("float32"),
    }
    feed = {k: v.astype("int64") if v.dtype.kind == "i" else v
            for k, v in feed.items()}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    kernels["lstm_cell"].reset()
    losses, step_ms, per_step = [], [], []
    reran = exe.grad_op_reruns
    for _ in range(MT_STEPS):
        before = kernels["lstm_cell"].launches
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        per_step.append(kernels["lstm_cell"].launches - before)
    launches = kernels["lstm_cell"].launches
    print("rnn mt train: %d ops, batch %d x %d, %d steps: losses %s, mean "
          "%.1f ms/step, lstm_cell launches per step %s"
          % (len(main.global_block().ops), MT_BATCH, MT_SEQ, MT_STEPS,
             ["%.5f" % v for v in losses], float(np.mean(step_ms)), per_step))
    reran = exe.grad_op_reruns - reran
    print("rnn mt train: grad-op reruns in the %d steps %d"
          % (MT_STEPS, reran))
    if not np.isfinite(losses).all():
        fail("a machine-translation loss is not finite: %s" % losses)
    if any(c != 2 for c in per_step):
        fail("lstm_cell launched %s times per MT step, expected 2"
             % per_step)
    if reran:
        fail("%d grad ops reran their forward in the MT steps" % reran)
    return launches, scope


def rnn_card_vs_cpu_phase(np, torch, fluid, exe):
    """The stacked LSTM at full width, batch 4, on the card and on the
    CPU from the same state: the startup's weights (Xavier, drawn on the
    card; ``set_deterministic_params``' scale saturates the softmax at
    width 512) and Adam's state, carried to the CPU with
    ``convert.persistables_from_numpy``. Inference predictions, then 3
    Adam steps' losses."""
    from paddle_tpu_torch.convert import persistables_from_numpy

    main, startup, infer, loss, outs = build_rnn(fluid, "lstm")
    feeds = sentiment_batches(np, CVC_STEPS, RNN_CVC_BATCH, RNN_SEQ, SEED + 1)
    card = fluid.Scope()
    exe.run(startup, scope=card)
    state = {v.name: card.get_value(v.name).cpu().numpy()
             for v in main.global_block().vars.values()
             if v.persistable and card.get_value(v.name) is not None}
    cpu = fluid.Scope()
    persistables_from_numpy(main, cpu, state, "cpu")
    preds, losses = {}, {}
    for dev, ex, scope in (("card", exe, card),
                           ("cpu", fluid.Executor(fluid.CPUPlace()), cpu)):
        (preds[dev],) = ex.run(infer, feed=feeds[0], scope=scope,
                               fetch_list=[outs["predict"]])
        losses[dev] = [float(np.asarray(ex.run(
            main, feed=f, fetch_list=[loss], scope=scope)[0]).reshape(-1)[0])
            for f in feeds]
    p_err = float(np.abs(np.asarray(preds["card"])
                         - np.asarray(preds["cpu"])).max())
    err = max(abs(a - b) for a, b in zip(losses["card"], losses["cpu"]))
    print("rnn card vs cpu: batch %d, predictions (first row %s) max abs "
          "diff %.3e  tol %.0e; %d Adam steps, losses card %s cpu %s: max "
          "abs diff %.3e  tol %.0e"
          % (RNN_CVC_BATCH, np.asarray(preds["cpu"])[0].tolist(), p_err,
             RNN_PRED_TOL, CVC_STEPS, losses["card"], losses["cpu"], err,
             TRAIN_LOSS_TOL))
    if not p_err <= RNN_PRED_TOL:
        fail("card and CPU stacked-LSTM predictions disagree: %.3e" % p_err)
    if not np.isfinite(losses["card"]).all() or not err <= TRAIN_LOSS_TOL:
        fail("card and CPU stacked-LSTM losses disagree: %.3e" % err)
    return err


# -- the predictor: saved programs served through create_paddle_predictor ------

def mnist_predictor_phase(np):
    """The committed saved model (the JAX package's PTPB ``__model__``
    and ``.npy`` parameters) through ``create_paddle_predictor`` on the
    card, against its ``io_pin.npz`` and the CPU predictor."""
    from paddle_tpu_torch.inference import (
        NativeConfig,
        create_paddle_predictor,
    )

    pin = np.load(os.path.join(MNIST_DIR, "io_pin.npz"))
    feed = {"pixel": pin["feed_pixel"]}
    (got,) = create_paddle_predictor(NativeConfig(MNIST_DIR)).run(feed)
    (cpu,) = create_paddle_predictor(
        NativeConfig(MNIST_DIR, use_tpu=False)).run(feed)
    pin_err = float(np.abs(got - pin["expected"]).max())
    cpu_err = float(np.abs(got - cpu).max())
    print("predictor mnist: committed saved model on the card, output %s: "
          "max abs diff to io_pin.npz %.3e (rtol %.0e, atol %.0e), to the "
          "CPU predictor %.3e (tol %.0e)"
          % (list(got.shape), pin_err, PIN_RTOL, PIN_ATOL, cpu_err,
             MNIST_CPU_TOL))
    if not np.allclose(got, pin["expected"], rtol=PIN_RTOL, atol=PIN_ATOL):
        fail("the committed MNIST model on the card misses its pin")
    if not cpu_err <= MNIST_CPU_TOL:
        fail("the MNIST predictor on the card and on the CPU disagree")


def predictor_feed(np, batch):
    """A batch of sources with lengths uniform in 16..256 and teacher-
    forced targets, the three feeds of the inference program."""
    rng = np.random.RandomState(SEED + 3)
    lens = rng.randint(16, MAX_LEN + 1, (batch, 1))
    src = rng.randint(3, VOCAB, (batch, MAX_LEN))
    src[np.arange(MAX_LEN)[None, :] >= lens] = EOS
    trg = np.concatenate([np.ones((batch, 1), "int64"),
                          src[:, :-1]], axis=1)
    return {"src_word": src.astype("int64"), "src_len": lens.astype("int64"),
            "trg_word": trg.astype("int64")}


def transformer_predictor_phase(np, torch, fluid, exe, kernels):
    """Transformer-base's inference program (``build_inference``), saved
    by the port and served by ``Predictor`` from a fresh scope: logits
    equal to the in-session run's, within 1e-3 of the CPU predictor's;
    20 timed runs with 3 x n_layer flash_fwd launches each; clones on 4
    threads and ``run_async`` equal to ``run``; greedy tokens over the
    loaded program equal to the session's. Returns the timed runs'
    launches."""
    import tempfile
    import threading

    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.inference import (
        NativeConfig,
        create_paddle_predictor,
    )
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.testing import set_deterministic_params

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard({}), fluid.program_guard(main, startup):
        _, _, extras = transformer.build(
            src_vocab_size=VOCAB, trg_vocab_size=VOCAB, max_length=MAX_LEN,
            n_layer=N_LAYER, n_head=N_HEAD, d_model=D_MODEL,
            d_inner=D_INNER, dropout=DROPOUT, label_smooth_eps=LABEL_SMOOTH)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope)
    logits = extras["logits"]
    infer = transformer.build_inference(main, logits)
    feed = predictor_feed(np, PRED_BATCH)
    (ref,) = exe.run(infer, feed=feed, fetch_list=[logits], scope=scope)
    src = feed["src_word"][:GREEDY_BATCH]
    src_len = feed["src_len"][:GREEDY_BATCH]
    want_tokens = transformer.greedy_generate(
        exe, infer, logits.name, src, src_len, GREEDY_STEPS + 1, scope=scope)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fluid.io.save_inference_model(tmp, list(feed), [logits], exe,
                                      main_program=infer, scope=scope)
        save_s = time.perf_counter() - t0
        scope = main = None
        t0 = time.perf_counter()
        pred = create_paddle_predictor(NativeConfig(tmp))
        load_s = time.perf_counter() - t0
        cpu = create_paddle_predictor(NativeConfig(tmp, use_tpu=False))
        loaded_scope = fluid.Scope()
        loaded, _, fetch_vars = fluid.io.load_inference_model(
            tmp, exe, scope=loaded_scope)
        size_mb = sum(os.path.getsize(os.path.join(tmp, f))
                      for f in os.listdir(tmp)) / 2 ** 20
    print("predictor transformer: build_inference program of %d ops saved "
          "(%.0f MiB) in %.2f s, loaded into a Predictor in %.2f s"
          % (len(infer.global_block().ops), size_mb, save_s, load_s))
    (got,) = pred.run(feed)
    if got.shape != (PRED_BATCH, MAX_LEN, VOCAB) or not np.array_equal(
            got, ref):
        fail("the Predictor's logits %s differ from the in-session run's "
             "(max abs diff %.3e)" % (list(got.shape),
                                      float(np.abs(got - ref).max())))
    rows = {k: v[:PRED_CVC_ROWS] for k, v in feed.items()}
    (cpu_logits,) = cpu.run(rows)
    cpu_err = float(np.abs(ref[:PRED_CVC_ROWS] - cpu_logits).max())
    print("predictor transformer: batch %d, source lengths %d..%d: logits "
          "equal to the in-session Executor.run's; first %d rows against "
          "the CPU predictor: max abs diff %.3e  tol %.0e"
          % (PRED_BATCH, int(feed["src_len"].min()),
             int(feed["src_len"].max()), PRED_CVC_ROWS, cpu_err, LOGITS_TOL))
    if not cpu_err <= LOGITS_TOL:
        fail("the Predictor's logits on the card and on the CPU disagree")
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    for _ in range(PRED_RUNS):
        pred.run(feed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts(kernels)
    print("predictor transformer: %d runs of batch %d x %d: %.2f ms per run, "
          "%.1f sequences/s (logits [%d, %d, %d] copied to the host each "
          "run); kernel launches %s"
          % (PRED_RUNS, PRED_BATCH, MAX_LEN, wall / PRED_RUNS * 1e3,
             PRED_RUNS * PRED_BATCH / wall, PRED_BATCH, MAX_LEN, VOCAB,
             json.dumps(launches)))
    if launches["flash_fwd"] != PRED_FLASH_PER_RUN * PRED_RUNS:
        fail("flash_fwd launched %d times in %d Predictor runs, expected %d"
             % (launches["flash_fwd"], PRED_RUNS,
                PRED_FLASH_PER_RUN * PRED_RUNS))
    profile_call(torch, "predictor transformer run", lambda: pred.run(feed))
    t0 = time.perf_counter()
    handle = pred.run_async(feed)
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    (async_out,) = handle.result()
    print("predictor transformer: run_async returned after %.2f ms; "
          "result() equal to run: %s" % (dispatch_ms,
                                         np.array_equal(async_out, ref)))
    if not handle.done() or not np.array_equal(async_out, ref):
        fail("run_async(...).result() differs from run")
    kernels["flash_fwd"].reset()
    equal, errors = [], []

    def serve():
        try:
            clone = pred.clone()
            for _ in range(PRED_CLONE_RUNS):
                equal.append(np.array_equal(clone.run(feed)[0], ref))
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=serve) for _ in range(PRED_CLONES)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    clone_launches = kernels["flash_fwd"].launches
    print("predictor transformer: %d clone() threads x %d runs in %.2f s "
          "(%.1f sequences/s): %d of %d outputs equal to the single run's, "
          "flash_fwd launches %d" % (
              PRED_CLONES, PRED_CLONE_RUNS, wall,
              PRED_CLONES * PRED_CLONE_RUNS * PRED_BATCH / wall, sum(equal),
              PRED_CLONES * PRED_CLONE_RUNS, clone_launches))
    if errors or any(t.is_alive() for t in threads):
        fail("a clone thread failed or hung: %s" % errors)
    if len(equal) != PRED_CLONES * PRED_CLONE_RUNS or not all(equal):
        fail("the clones' outputs differ from the single run's")
    if clone_launches != PRED_FLASH_PER_RUN * PRED_CLONES * PRED_CLONE_RUNS:
        fail("flash_fwd counted %d launches over the clones' runs, expected "
             "%d" % (clone_launches,
                     PRED_FLASH_PER_RUN * PRED_CLONES * PRED_CLONE_RUNS))
    tokens = transformer.greedy_generate(
        exe, loaded, fetch_vars[0].name, src, src_len, GREEDY_STEPS + 1,
        scope=loaded_scope)
    print("predictor transformer: greedy_generate, %d positions of %d "
          "sources over the loaded program: tokens equal to the session's: "
          "%s" % (GREEDY_STEPS, GREEDY_BATCH,
                  np.array_equal(tokens, want_tokens)))
    if not np.array_equal(tokens, want_tokens):
        fail("greedy tokens over the loaded program differ from the "
             "session's")
    return launches


def rnn_predictor_phase(np, torch, fluid, exe, kernels, cell, scope, infer,
                        outs, feed, model_dir):
    """The trained stacked network's inference program, saved into
    ``model_dir`` and served through ``NativeConfig`` and
    ``AnalysisConfig`` on the card: predictions within 1e-5 of each
    other, stacked_num launches of the cell's kernel per run,
    predictions/s over windows that alternate between the two configs.
    Returns the timed runs' launches of the kernel."""
    from paddle_tpu_torch.inference import (
        AnalysisConfig,
        NativeConfig,
        create_paddle_predictor,
    )

    kname = "lstm_cell" if cell == "lstm" else "gru_cell"
    feed = {"words": feed["words"], "length": feed["length"]}
    fluid.io.save_inference_model(model_dir, list(feed), [outs["predict"]],
                                  exe, main_program=infer, scope=scope)
    preds = [("NativeConfig",
              create_paddle_predictor(NativeConfig(model_dir))),
             ("AnalysisConfig",
              create_paddle_predictor(AnalysisConfig(model_dir)))]
    out, total = {}, 0
    for name, pred in preds:
        (out[name],) = pred.run(feed)
    ms = {name: [] for name, _ in preds}
    counted = {name: 0 for name, _ in preds}
    for _ in range(PRED_RNN_ROUNDS):
        for name, pred in preds:
            torch.cuda.synchronize()
            kernels[kname].reset()
            t0 = time.perf_counter()
            for _ in range(PRED_RNN_RUNS):
                pred.run(feed)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / PRED_RNN_RUNS * 1e3)
            launches = kernels[kname].launches
            counted[name] += launches
            total += launches
            if launches != RNN_STACK * PRED_RNN_RUNS:
                fail("%s launched %d times in %d %s runs, expected %d"
                     % (kname, launches, PRED_RNN_RUNS, name,
                        RNN_STACK * PRED_RNN_RUNS))
    for name, pred in preds:
        types = [op.type for op in pred._program.global_block().ops]
        mean = sum(ms[name]) / len(ms[name])
        print("predictor rnn %s %s: %d ops (%d fc, %d fused recurrences), "
              "%d windows of %d runs of batch %d, alternating with the "
              "other config: %s ms per run, mean %.3f ms, %.0f "
              "predictions/s, %s launches %d"
              % (cell, name, len(types), types.count("fc"),
                 sum(t.startswith("fusion_") for t in types),
                 PRED_RNN_ROUNDS, PRED_RNN_RUNS, RNN_BATCH,
                 " ".join("%.3f" % m for m in ms[name]), mean,
                 RNN_BATCH / mean * 1e3, kname, counted[name]))
    err = float(np.abs(out["NativeConfig"] - out["AnalysisConfig"]).max())
    print("predictor rnn %s: NativeConfig and AnalysisConfig predictions "
          "max abs diff %.3e  tol %.0e" % (cell, err, PRED_FUSED_TOL))
    if not err <= PRED_FUSED_TOL:
        fail("NativeConfig and AnalysisConfig %s predictions disagree"
             % cell)
    return total


# -- the serving plane over the wire -----------------------------------------

def nan_check_phase(np, torch, fluid, exe):
    """FLAGS_check_nan_inf on the card: a run of ``log`` over a feed
    holding a negative raises the JAX package's message; the scan is one
    stacked flag vector over every floating fetch, read on the host
    once."""
    from paddle_tpu_torch import executor, flags, unique_name

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard({}), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.log(x)
        z = fluid.layers.scale(x, scale=2.0)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    bad = np.array([[-1.0, 1.0, 2.0, 3.0]], "float32")
    flags.set_flag("check_nan_inf", True)
    try:
        try:
            exe.run(main, feed={"x": bad}, fetch_list=[z, y], scope=scope)
        except RuntimeError as e:
            msg = str(e)
        else:
            fail("C1: a NaN-producing run on the card did not raise")
        pending = executor._nan_check_start(
            [("z", torch.ones(3, device="cuda")),
             ("y", torch.full((2,), float("nan"), device="cuda"))])
    finally:
        flags.set_flag("check_nan_inf", False)
    want = ("NaN/Inf detected in variable 'log_0.tmp_0' after program run "
            "(FLAGS_check_nan_inf)")
    if msg != want:
        fail("C1: the card raised %r, expected %r" % (msg, want))
    names, finite = pending
    if names != ["z", "y"] or tuple(finite.shape) != (2,) \
            or finite.device.type != "cuda":
        fail("C1: the scan is not one flag vector on the card: %s %s"
             % (names, tuple(finite.shape)))
    print("C1 check_nan_inf: log of a negative on the card raised %r; the "
          "scan stacks one flag per floating tensor on the card (%d "
          "flags, one host read)" % (msg, len(names)))


def fe_predict_requests(np):
    """``FE_PREDICT`` requests of 1..8 sequences of the stacked LSTM's
    synthetic sentiment data (lengths 16..80), made in bulk."""
    rng = np.random.RandomState(SEED + 11)
    out = []
    for i in range(FE_PREDICT):
        rows = 1 + i % 8
        lens = rng.randint(RNN_MIN_LEN, RNN_SEQ + 1, rows)
        words = np.zeros((rows, RNN_SEQ), "int64")
        for r in range(rows):
            words[r, :lens[r]] = rng.randint(2, RNN_DICT - 1, lens[r])
        out.append({"words": words,
                    "length": lens.reshape(-1, 1).astype("int64")})
    return out


def pct_ms(vals, q):
    vals = sorted(vals)
    return 1e3 * vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


def bucket_counts():
    from paddle_tpu_torch.observability import REGISTRY

    c = REGISTRY.counter("paddle_tpu_serving_batches_total",
                         "batches dispatched, by bucket (padded batch rows)",
                         labels=("bucket",))
    return {r: c.value(bucket=str(r)) for r in range(1, 9)}


def request_counts(text):
    """``paddle_tpu_frontend_request_seconds``'s counts by (endpoint,
    outcome) in a Prometheus exposition."""
    counted = {}
    for line in text.splitlines():
        if line.startswith("paddle_tpu_frontend_request_seconds_count{"):
            labels = dict(kv.split("=") for kv in
                          line[line.index("{") + 1:line.index("}")]
                          .replace('"', "").split(","))
            counted[(labels["endpoint"], labels["outcome"])] = \
                int(float(line.split()[-1]))
    return counted


def frontend_phase(np, torch, fluid, exe, kernels, serve_out, serve_rate,
                   lstm_dir):
    """The serving plane on the card: one ``ServingFrontend`` on
    127.0.0.1 over a ``BatchingServer`` (the saved stacked LSTM, width
    512, 2 workers) and a captured paged ``SlotDecodeSession``
    (Transformer-base, the serve phase's weights and configuration).
    ``predict`` traffic runs first (its last three quarters held until the
    decode loop's capture begins) and keeps running while 8 client
    threads stream the serve phase's 64 requests, so the decode loop's
    CUDA graph is captured under load. Gates: every wire stream equals
    the serve phase's in-process stream; paged_decode and flash_fwd
    launches follow the serve phase's formulas; the pool drains; every
    prediction lies within 1e-5 of ``run_reference`` on the card;
    lstm_cell launches are stacked_num per dispatched batch; the buckets
    used are ladder rungs; a capture overlapped predict traffic. A
    quarter of the predict requests run again with no decode traffic
    beside them (printed, not gated). Then an
    in-band cancel and a dropped client each leave the pool conserved,
    the cancelling connection serves again, a lapsed deadline and an
    unknown method come back typed, and health / stats / metrics answer
    (the request-latency histogram counting every request). Returns the
    launches of the window."""
    import threading

    from paddle_tpu_torch.executor import _CUDAGraphCapturer
    from paddle_tpu_torch.inference import (
        NativeConfig,
        create_paddle_predictor,
    )
    from paddle_tpu_torch.serving import loadgen
    from paddle_tpu_torch.serving.client import ServingClient
    from paddle_tpu_torch.serving.frontend import ServingFrontend
    from paddle_tpu_torch.observability.metrics_registry import REGISTRY
    from paddle_tpu_torch.serving.server import (
        BatchingServer,
        DeadlineExceededError,
        ServingError,
    )

    t_phase = time.perf_counter()
    base_counts = request_counts(REGISTRY.to_prometheus())
    scope = fluid.Scope()
    build_model(fluid, exe, scope)
    sess = session(exe, scope.new_scope(), NUM_SLOTS)
    src, lens, prefixes = requests(np)
    preq = fe_predict_requests(np)
    server = BatchingServer(create_paddle_predictor(NativeConfig(lstm_dir)),
                            max_batch=8, workers=2)
    # every rung's shapes once before the window (requests of 2, 4 and 8
    # sequences through the oracle)
    for i in (1, 3, 7):
        server.run_reference(preq[i])
    ladder = server.stats()["batch_buckets"]
    # capture windows of the decode loop (host clock), to hold the
    # predict traffic against
    captures = []
    capture = _CUDAGraphCapturer.capture
    capturing = threading.Event()

    def timed_capture(body, device):
        capturing.set()
        t0 = time.perf_counter()
        try:
            return capture(body, device)
        finally:
            captures.append((t0, time.perf_counter()))

    exe.graph_capturer = type("TimedCapturer", (), {
        "capture": staticmethod(timed_capture)})()
    fe = ServingFrontend(server=server, session=sess, host="127.0.0.1",
                         port=0)
    errors, lock = [], threading.Lock()
    pred_out, pred_spans = [None] * FE_PREDICT, []
    gen_out = [None] * N_REQUESTS
    gen_lat, gen_ttft = [], []
    started = threading.Event()

    def predict_client(cid):
        cl = ServingClient(fe.address)
        try:
            for i in range(cid, FE_PREDICT, FE_PREDICT_CLIENTS):
                if i >= FE_PREDICT // 4 and not capturing.wait(120):
                    raise RuntimeError("the decode loop was never captured")
                t0 = time.perf_counter()
                pred_out[i] = cl.predict(preq[i])
                with lock:
                    pred_spans.append((t0, time.perf_counter()))
                    if len(pred_spans) >= 8:
                        started.set()
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append("predict client %d: %r" % (cid, e))
            started.set()
        finally:
            cl.close()

    def generate_client(cid):
        cl = ServingClient(fe.address)
        try:
            for i in range(cid, N_REQUESTS, FE_CLIENTS):
                t0 = time.perf_counter()
                first = []

                def on_event(ev):
                    if ev.get("event") == "tokens" and not first:
                        first.append(time.perf_counter())

                gen_out[i] = cl.generate_full(
                    src[i], src_len=int(lens[i]), prefix_tokens=prefixes[i],
                    on_event=on_event)
                with lock:
                    gen_lat.append(time.perf_counter() - t0)
                    gen_ttft.append(first[0] - t0)
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append("generate client %d: %r" % (cid, e))
        finally:
            cl.close()

    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    buckets0, batches0 = bucket_counts(), server.stats()["batches"]
    steps0 = sess.decode_steps
    preds = [threading.Thread(target=predict_client, args=(c,))
             for c in range(FE_PREDICT_CLIENTS)]
    t_pred = time.perf_counter()
    for t in preds:
        t.start()
    started.wait(60)
    gens = [threading.Thread(target=generate_client, args=(c,))
            for c in range(FE_CLIENTS)]
    t_gen = time.perf_counter()
    for t in gens:
        t.start()
    for t in gens:
        t.join(300)
    gen_wall = time.perf_counter() - t_gen
    for t in preds:
        t.join(300)
    pred_wall = time.perf_counter() - t_pred
    torch.cuda.synchronize()
    launches = kernel_counts(kernels)
    batches = server.stats()["batches"] - batches0
    buckets = {r: n - buckets0[r] for r, n in bucket_counts().items()
               if n > buckets0[r]}
    decode_steps = sess.decode_steps - steps0
    if errors or any(t.is_alive() for t in gens + preds):
        fail("frontend: client errors or hung clients: %s" % errors[:4])
    print("frontend: kernel launches %s" % json.dumps(launches))

    # -- generate gates
    mismatched = [i for i in range(N_REQUESTS)
                  if not np.array_equal(gen_out[i][0], serve_out[i])]
    if mismatched:
        i = mismatched[0]
        fail("frontend: %d of %d wire streams differ from the serve phase's "
             "in-process streams; request %d: wire %s, session %s"
             % (len(mismatched), N_REQUESTS, i, list(gen_out[i][0][:24]),
                list(serve_out[i][:24])))
    n_prefix = sum(p is not None for p in prefixes)
    expect_k2 = N_LAYER * decode_steps
    expect_k1 = (N_REQUESTS * N_LAYER + N_LAYER * decode_steps
                 + 2 * (N_LAYER - 1) * n_prefix)
    if launches["paged_decode"] != expect_k2:
        fail("frontend: paged_decode launched %d times, expected n_layer x "
             "decode steps = %d" % (launches["paged_decode"], expect_k2))
    if launches["flash_fwd"] != expect_k1:
        fail("frontend: flash_fwd launched %d times, expected %d"
             % (launches["flash_fwd"], expect_k1))
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and (sess.active_slots
                                           or sess.pending_requests):
        time.sleep(0.01)
    if sess.pages_in_use != 0 or not sess.pool_conserved:
        fail("frontend: the page pool did not drain")
    if not captures:
        fail("frontend: the decode loop was never captured")
    overlap = [sum(1 for a, b in pred_spans if a < c1 and b > c0)
               for c0, c1 in captures]
    if not any(overlap):
        fail("frontend: no predict request was in flight while the decode "
             "loop was captured (captures %s)" % captures)
    generated = sum(generated_tokens(gen_out[i][0], prefixes[i])
                    for i in range(N_REQUESTS))
    wire = loadgen.wire_capture(N_REQUESTS, gen_wall, gen_lat,
                                ttft_s=gen_ttft)

    # -- predict gates
    if launches["lstm_cell"] != RNN_STACK * batches:
        fail("frontend: lstm_cell launched %d times over %d batches, "
             "expected stacked_num x batches = %d"
             % (launches["lstm_cell"], batches, RNN_STACK * batches))
    if not set(buckets) <= set(ladder) or sum(buckets.values()) != batches:
        fail("frontend: batches by bucket %s are not on the ladder %s"
             % (buckets, ladder))
    worst = 0.0
    for i, req in enumerate(preq):
        (want,) = server.run_reference(req)
        (got,) = pred_out[i]
        if got.shape != want.shape or not np.isfinite(got).all():
            fail("frontend: prediction %d has shape %s, expected %s"
                 % (i, got.shape, want.shape))
        worst = max(worst, float(np.abs(got - want).max()))
    if not worst <= FE_PRED_TOL:
        fail("frontend: predictions differ from run_reference by %.3e"
             % worst)
    pred_lat = [b - a for a, b in pred_spans]
    card = card_line()
    print("frontend generate: %d requests over %d client threads, "
          "streaming: wall %.3f s, %d tokens, %d decode steps, wire decode "
          "%.1f tokens/s beside the serve phase's in-process session's "
          "%.1f tokens/s; ttft p50 %.3f ms p99 %.3f ms; request latency "
          "p50 %.3f ms p99 %.3f ms; graphs captured %d (capture %s ms, "
          "predict requests in flight during it %s); %s"
          % (N_REQUESTS, FE_CLIENTS, gen_wall, generated, decode_steps,
             generated / gen_wall, serve_rate, pct_ms(gen_ttft, 0.5),
             pct_ms(gen_ttft, 0.99), wire["latency_ms_p50"],
             wire["latency_ms_p99"], len(captures),
             ["%.1f" % (1e3 * (b - a)) for a, b in captures], overlap,
             card))
    print("frontend generate: %d of %d wire streams equal the serve phase's "
          "in-process streams; paged_decode %d = %d x %d, flash_fwd %d; "
          "pool drained, conserved %s"
          % (N_REQUESTS, N_REQUESTS, launches["paged_decode"], N_LAYER,
             decode_steps, launches["flash_fwd"], sess.pool_conserved))
    print("frontend predict: %d requests of 1..8 sequences over %d client "
          "threads: wall %.3f s, %.1f requests/s; latency p50 %.3f ms p99 "
          "%.3f ms; %d batches, by bucket %s (ladder %s); lstm_cell %d = %d "
          "x %d; max abs diff to run_reference %.3e  tol %.0e; %s"
          % (FE_PREDICT, FE_PREDICT_CLIENTS, pred_wall,
             FE_PREDICT / pred_wall, pct_ms(pred_lat, 0.5),
             pct_ms(pred_lat, 0.99), batches, json.dumps(buckets), ladder,
             launches["lstm_cell"], RNN_STACK, batches, worst, FE_PRED_TOL,
             card))

    # -- the first quarter of the predict requests again, with no decode
    # traffic beside them: what the shared host costs the predict path
    alone = []

    def alone_client(cid):
        cl = ServingClient(fe.address)
        try:
            for i in range(cid, FE_PREDICT // 4, FE_PREDICT_CLIENTS):
                t0 = time.perf_counter()
                cl.predict(preq[i])
                with lock:
                    alone.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append("predict alone %d: %r" % (cid, e))
        finally:
            cl.close()

    threads = [threading.Thread(target=alone_client, args=(c,))
               for c in range(FE_PREDICT_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    alone_wall = time.perf_counter() - t0
    if errors:
        fail("frontend: %s" % errors[:4])
    print("frontend predict alone (no decode traffic): %d requests over %d "
          "client threads: wall %.3f s, %.1f requests/s; latency p50 %.3f "
          "ms p99 %.3f ms; %s"
          % (len(alone), FE_PREDICT_CLIENTS, alone_wall,
             len(alone) / alone_wall, pct_ms(alone, 0.5),
             pct_ms(alone, 0.99), card))

    # -- cancel, disconnect, typed errors, ops endpoints (not counted)
    def drained():
        end = time.monotonic() + 30
        while time.monotonic() < end:
            if (not sess.active_slots and not sess.pending_requests
                    and sess.free_slots == NUM_SLOTS and sess.pool_conserved):
                return True
            time.sleep(0.01)
        return False

    # the two longest streams, so that each is surely mid-stream when the
    # cancel or the drop lands
    longest = sorted(range(N_REQUESTS), key=lambda i: -generated_tokens(
        serve_out[i], prefixes[i]))
    cl = ServingClient(fe.address)
    i = longest[0]
    gen = cl.generate(src[i], src_len=int(lens[i]), prefix_tokens=prefixes[i])
    while next(gen)["event"] != "tokens":
        pass
    gen.close()  # the in-band cancel
    if not drained():
        fail("frontend: the pool is not conserved after an in-band cancel")
    again = cl.generate_full(src[2], src_len=int(lens[2]),
                             prefix_tokens=prefixes[2])
    if not np.array_equal(again[0], serve_out[2]):
        fail("frontend: the cancelling connection's next stream differs")
    dropped = ServingClient(fe.address)
    i = longest[1]
    gen = dropped.generate(src[i], src_len=int(lens[i]),
                           prefix_tokens=prefixes[i])
    while next(gen)["event"] != "tokens":
        pass
    dropped.close()  # the client goes away mid-stream
    if not drained():
        fail("frontend: the pool is not conserved after a dropped client")
    try:
        cl.predict(preq[0], deadline_s=0.0)
        fail("frontend: a lapsed deadline was served")
    except DeadlineExceededError:
        pass
    try:
        cl._request(method="no_such_method")
        fail("frontend: an unknown method was answered")
    except ServingError as e:
        if type(e) is not ServingError or "unknown method" not in str(e):
            fail("frontend: an unknown method raised %r" % e)
    health = cl.health()
    if health != {"server": "healthy", "decode": "healthy"}:
        fail("frontend: health %s" % health)
    want = {("generate", "ok"): N_REQUESTS + 1,
            ("generate", "cancelled"): 1, ("generate", "disconnect"): 1,
            ("predict", "ok"): FE_PREDICT + FE_PREDICT // 4,
            ("predict", "deadline"): 1}
    end = time.monotonic() + 10
    while True:
        stats = cl.stats()
        got = {(e, o): n for e, by in stats["requests"].items()
               for o, n in by.items()}
        if got == want or time.monotonic() > end:
            break
        time.sleep(0.05)
    if got != want:
        fail("frontend: stats count %s, expected %s" % (got, want))
    # the registry is the process's: count this phase's requests, past
    # what earlier phases' frontends (beam_wire) counted
    counted = {k: n - base_counts.get(k, 0)
               for k, n in request_counts(cl.metrics()).items()
               if n != base_counts.get(k, 0)}
    if counted != want:
        fail("frontend: paddle_tpu_frontend_request_seconds counts %s, "
             "expected %s" % (counted, want))
    cl.close()
    fe.close()
    server.close()
    exe.graph_capturer = _CUDAGraphCapturer()
    print("frontend: in-band cancel and dropped client: pool conserved, the "
          "cancelling connection served again; lapsed deadline -> "
          "DeadlineExceededError, unknown method -> ServingError; health "
          "%s; stats and paddle_tpu_frontend_request_seconds count %d "
          "requests %s; phase wall %.1f s"
          % (health, sum(want.values()),
             json.dumps({"%s/%s" % k: n for k, n in sorted(want.items())}),
             time.perf_counter() - t_phase))
    return launches


# -- ResNet-50 (bench.py's headline model) and the optimizers ------------------

def resnet_train_program(fluid, amp=False, img=RESNET_IMG):
    """bench.py:127-151's program with the data fed from numpy:
    (main, startup, loss, predict); ``amp`` rewrites it for bf16 as
    bench.py:152-153 does on the accelerator."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.transpiler import rewrite_program_amp

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = RESNET_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        pixel = fluid.layers.data(name="bench_pixel", shape=[3, img, img],
                                  dtype="float32")
        label = fluid.layers.data(name="bench_label", shape=[1],
                                  dtype="int64")
        predict = resnet.resnet_imagenet(pixel, RESNET_CLASSES,
                                         depth=RESNET_DEPTH)
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        loss = fluid.layers.mean(cost)
        fluid.optimizer.Momentum(learning_rate=RESNET_LR,
                                 momentum=RESNET_MOMENTUM).minimize(loss)
    if amp:
        rewrite_program_amp(main, "bfloat16")
    return main, startup, loss, predict


def forward_flops(np, program):
    """Forward FLOPs per image of the program's products: 2 x the
    multiply-adds of every conv2d (from its output and filter shapes) and
    every mul."""
    block = program.global_block()
    total = 0
    for op in block.ops:
        if op.type == "conv2d":
            out = block.var(op.output("Output")[0]).shape
            w = block.var(op.input("Filter")[0]).shape
            total += 2 * int(np.prod(out[1:])) * int(np.prod(w[1:]))
        elif op.type == "mul":
            w = block.var(op.input("Y")[0]).shape
            total += 2 * int(np.prod(w))
    return total


def resnet_phase(np, torch, fluid, exe, model_dir, amp=False, f32=None):
    """ResNet-50 trained on the card, then saved and served (module
    docstring, step 13). With ``amp`` (step 16), bf16 mixed precision,
    not saved (``model_dir`` None), the bound at the bf16 rate and the
    float32 run's result ``f32`` printed beside. Returns {"rate",
    "mean_ms", "peak", "busy"}."""
    from paddle_tpu_torch.inference import (
        AnalysisConfig,
        NativeConfig,
        create_paddle_predictor,
    )

    label = "resnet amp" if amp else "resnet"
    main, startup, loss, predict = resnet_train_program(fluid, amp=amp)
    ops = main.global_block().ops
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    bn_means = [op.output("MeanOut")[0] for op in ops
                if op.type == "batch_norm"]
    means0 = {n: scope.get_value(n).clone() for n in bn_means}
    rng = np.random.RandomState(SEED)
    feed = {"bench_pixel": rng.rand(RESNET_BATCH, 3, RESNET_IMG,
                                    RESNET_IMG).astype("float32"),
            "bench_label": rng.randint(0, RESNET_CLASSES,
                                       (RESNET_BATCH, 1)).astype("int64")}
    flops = forward_flops(np, main)
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    print("%s: ResNet-%d program of %d ops (%d batch_norm), %.2f M "
          "parameters, %.3f GFLOP forward per image, batch %d x 3 x %d x "
          "%d, Momentum(%g, %g), %s"
          % (label, RESNET_DEPTH, len(ops), len(bn_means), n_params / 1e6,
             flops / 1e9, RESNET_BATCH, RESNET_IMG, RESNET_IMG, RESNET_LR,
             RESNET_MOMENTUM, "AMP bf16" if amp else "fp32"))
    losses = []
    for _ in range(RESNET_WARMUP):
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reran = exe.grad_op_reruns
    step_ms = []
    for i in range(RESNET_STEPS):
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    reran = exe.grad_op_reruns - reran
    peak = torch.cuda.max_memory_allocated()
    mean_ms = float(np.mean(step_ms))
    rate = RESNET_BATCH / mean_ms * 1e3
    peak_flops, rate_name = ((PEAK_BF16_FLOPS, "989 TFLOP/s bf16") if amp
                             else (PEAK_FP32_FLOPS, "67 TFLOP/s fp32"))
    bound_ms = 3.0 * flops * RESNET_BATCH / peak_flops * 1e3
    print("%s: losses %s" % (label, ["%.4f" % v for v in losses]))
    print("%s: %d timed steps, mean %.1f ms/step (min %.1f, max %.1f): "
          "%.1f images/s; peak memory %.2f GiB; grad-op reruns %d"
          % (label, RESNET_STEPS, mean_ms, min(step_ms), max(step_ms), rate,
             peak / 2 ** 30, reran))
    print("%s: bound %.2f ms/step (%.3f GFLOP x 3 x %d images at %s): the "
          "step reaches %.1f %% of it"
          % (label, bound_ms, flops / 1e9, RESNET_BATCH, rate_name,
             100.0 * bound_ms / mean_ms))
    if amp:
        print("resnet amp: %.1f images/s, %.1f ms a step, peak %.2f GiB "
              "against the fp32 run's %.1f images/s, %.1f ms, %.2f GiB in "
              "this call" % (rate, mean_ms, peak / 2 ** 30, f32["rate"],
                             f32["mean_ms"], f32["peak"] / 2 ** 30))
    if not np.isfinite(losses).all():
        fail("a %s loss is not finite: %s" % (label, losses))
    late = float(np.mean(losses[-5:]))
    print("%s: loss step 1 %.6f, mean of the last 5 %.6f"
          % (label, losses[0], late))
    if not late < losses[0]:
        fail("the %s loss did not fall: %s" % (label, losses))
    if reran:
        fail("%d grad ops reran their forward in the %s steps"
             % (reran, label))
    same = [n for n in bn_means
            if torch.equal(scope.get_value(n).cpu(), means0[n].cpu())]
    if same:
        fail("batch_norm moving means unchanged by training: %s" % same[:5])
    if amp:
        n = f32_masters(np, torch, main, scope, label)
        print("resnet amp: all %d floating persistables (parameters, "
              "velocities, moving statistics) are float32 in the scope" % n)
    prof = profile_call(torch, label, lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope))
    result = dict(rate=rate, mean_ms=mean_ms, peak=peak,
                  busy=None if prof is None
                  else prof["busy_ms"] / prof["wall_ms"])
    if model_dir is None:
        return result

    fluid.io.save_inference_model(model_dir, ["bench_pixel"], [predict], exe,
                                  main_program=main, scope=scope)
    pfeed = {"bench_pixel": feed["bench_pixel"][:RESNET_PRED_BATCH]}
    out, types = {}, {}
    for name, config in (("NativeConfig", NativeConfig(model_dir)),
                         ("AnalysisConfig", AnalysisConfig(model_dir))):
        pred = create_paddle_predictor(config)
        (out[name],) = pred.run(pfeed)
        types[name] = [op.type for op in pred._program.global_block().ops]
    a, b = np.asarray(out["AnalysisConfig"]), np.asarray(out["NativeConfig"])
    err = float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))
    print("resnet predictor: %d images; NativeConfig %d ops (%d batch_norm), "
          "AnalysisConfig %d ops (%d batch_norm): max diff %.3e relative to "
          "max(1, |y|)  tol %.0e; top-1 equal %s"
          % (RESNET_PRED_BATCH, len(types["NativeConfig"]),
             types["NativeConfig"].count("batch_norm"),
             len(types["AnalysisConfig"]),
             types["AnalysisConfig"].count("batch_norm"), err,
             RESNET_PRED_TOL, np.array_equal(a.argmax(1), b.argmax(1))))
    if types["AnalysisConfig"].count("batch_norm"):
        fail("fuse_batch_norm left batch_norm ops in the AnalysisConfig "
             "program")
    if not np.isfinite(a).all() or not err <= RESNET_PRED_TOL:
        fail("AnalysisConfig and NativeConfig ResNet-50 predictions "
             "disagree: %.3e" % err)
    return result


def amp_resnet_card_vs_cpu_phase(np, torch, fluid, exe):
    """Step 16's AMP ResNet-50 at ``RESNET_CVC_IMG`` pixels, a fixed batch
    of ``RESNET_CVC_BATCH``, one Momentum step on the card and the CPU,
    both from copies of the card's initialized scope: the predictions
    ([4, 1000]) and every parameter's gradient, each tensor within
    ``AMP_GAP_FACTOR`` times the CPU's own gap between its AMP and
    float32 values (the same program with the rewrite off), or
    ``AMP_LOSS_FLOOR`` of its norm where that is larger (L2 norms, as
    tests/test_torch_amp.py holds the port to the JAX package). The loss
    is printed, with the card's fp32 loss, and not gated: it is the mean
    of four -log p at the labels, and bf16 noise in the few small
    probabilities it reads moved it by 1-5 % between the devices in the
    first runs on the card (PERF.md) while the 4,000 predictions stayed
    within their bound; three steps of this batch swing in fp32 as in
    bf16 (7.51 -> 3.01 -> 9.21), so only one step is held."""
    from paddle_tpu_torch.transpiler import rewrite_program_amp

    main, startup, loss, predict = resnet_train_program(
        fluid, amp=True, img=RESNET_CVC_IMG)
    grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()]
    names = [loss.name, predict.name] + grads
    rng = np.random.RandomState(SEED + 3)
    feed = {"bench_pixel": rng.rand(RESNET_CVC_BATCH, 3, RESNET_CVC_IMG,
                                    RESNET_CVC_IMG).astype("float32"),
            "bench_label": rng.randint(0, RESNET_CLASSES,
                                       (RESNET_CVC_BATCH, 1)).astype("int64")}
    card_scope = fluid.Scope()
    exe.run(startup, scope=card_scope)
    cpu = fluid.Executor(fluid.CPUPlace())
    scopes = {"cpu": cpu_copy(np, fluid, main, card_scope),
              "cpu fp32": cpu_copy(np, fluid, main, card_scope),
              "card": card_scope}
    scopes["card fp32"] = cpu_copy(np, fluid, main, card_scope, "cuda")
    out = {}
    for dev, ex in (("card", exe), ("cpu", cpu), ("cpu fp32", cpu),
                    ("card fp32", exe)):
        rewrite_program_amp(main, None if "fp32" in dev else "bfloat16")
        out[dev] = [t.detach().double().cpu().numpy() for t in ex.run(
            main, feed=feed, scope=scopes[dev], fetch_list=names,
            return_numpy=False)]
    rewrite_program_amp(main, "bfloat16")
    worst, at = 0.0, None
    for i, n in enumerate(names[1:], 1):
        c, a, f = out["card"][i], out["cpu"][i], out["cpu fp32"][i]
        tol = max(AMP_GAP_FACTOR * np.linalg.norm(a - f),
                  AMP_LOSS_FLOOR * np.linalg.norm(a))
        r = np.linalg.norm(c - a) / tol if tol > 0 else 0.0
        if r > worst:
            worst, at = r, n
    label = "resnet amp (%d x 3 x %d x %d)" % (
        RESNET_CVC_BATCH, RESNET_CVC_IMG, RESNET_CVC_IMG)
    print("%s card vs cpu: one Momentum step, AMP loss card %.6f cpu %.6f, "
          "fp32 loss card %.6f cpu %.6f (printed, not gated); the "
          "predictions and %d parameter gradients: the largest L2 "
          "difference is %.3f of its bound (%g x the CPU's AMP-to-fp32 gap "
          "of that tensor, at least %.2e of its norm), at %s"
          % (label, out["card"][0][0], out["cpu"][0][0],
             out["card fp32"][0][0], out["cpu fp32"][0][0], len(grads),
             worst, AMP_GAP_FACTOR, AMP_LOSS_FLOOR, at))
    if not all(np.isfinite(t).all() for t in out["card"]) or \
            not worst <= 1.0:
        fail("%s: card and CPU AMP tensors disagree (%.3f of the bound at "
             "%s)" % (label, worst, at))
    return worst


def resnet_graph_data_phase(np, torch, fluid, exe, kernels, host_rate,
                            amp=False, f32_rate=None):
    """ResNet-50 as bench.py trains it by default: the batch drawn on the
    card at every step by ``random_data_generator`` (uniform pixels,
    labels in 0..999; three threefry launches a step: the pixels, and
    the labels' two words of bits), 5 + 10 steps. Prints images/s beside
    the host-fed number of this call (with ``amp``, bf16 mixed precision,
    also beside ``f32_rate``, the float32 graph-data run's). Returns the
    timed steps' launches and images/s."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.transpiler import rewrite_program_amp

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = RESNET_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        pixel, label = fluid.layers.random_data_generator(
            shapes=[[RESNET_BATCH, 3, RESNET_IMG, RESNET_IMG],
                    [RESNET_BATCH, 1]],
            dtypes=["float32", "int64"], int_high=RESNET_CLASSES - 1)
        predict = resnet.resnet_imagenet(pixel, RESNET_CLASSES,
                                         depth=RESNET_DEPTH)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=predict, label=label))
        fluid.optimizer.Momentum(learning_rate=RESNET_LR,
                                 momentum=RESNET_MOMENTUM).minimize(loss)
    if amp:
        rewrite_program_amp(main, "bfloat16")
    label = "resnet amp graph-data" if amp else "resnet graph-data"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    losses = []
    for _ in range(RESNET_GRAPH_WARMUP):
        (lv,) = exe.run(main, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    reran = exe.grad_op_reruns
    step_ms = []
    for _ in range(RESNET_GRAPH_STEPS):
        t0 = time.perf_counter()
        (lv,) = exe.run(main, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    launches = kernel_counts(kernels)
    mean_ms = float(np.mean(step_ms))
    rate = RESNET_BATCH / mean_ms * 1e3
    print("%s: random_data_generator batch %d x 3 x %d x %d drawn on the "
          "card, %d + %d steps: mean %.1f ms/step (min %.1f, max %.1f), "
          "%.1f images/s (host feed %.1f images/s in this call%s); threefry "
          "launches %d (%d a step); losses %s"
          % (label, RESNET_BATCH, RESNET_IMG, RESNET_IMG,
             RESNET_GRAPH_WARMUP, RESNET_GRAPH_STEPS, mean_ms, min(step_ms),
             max(step_ms), rate, host_rate,
             ", fp32 graph-data %.1f images/s" % f32_rate if amp else "",
             launches["threefry"], launches["threefry"] // RESNET_GRAPH_STEPS,
             ["%.4f" % v for v in losses]))
    if not np.isfinite(losses).all():
        fail("a %s loss is not finite: %s" % (label, losses))
    if launches["threefry"] != 3 * RESNET_GRAPH_STEPS:
        fail("%s: threefry launched %d times, want 3 a step"
             % (label, launches["threefry"]))
    if exe.grad_op_reruns != reran:
        fail("%s: %d grad ops reran their forward"
             % (label, exe.grad_op_reruns - reran))
    if amp:
        f32_masters(np, torch, main, scope, label)
    return launches, rate


def optim_runs(fluid):
    """(name, optimizer factory, regularizer) for the optim phase."""
    opt, reg = fluid.optimizer, fluid.regularizer
    l2 = reg.L2Decay(OPTIM_L2)
    return [
        ("Momentum", lambda: opt.Momentum(1e-3, 0.9, regularization=l2)),
        ("Nesterov", lambda: opt.Momentum(1e-3, 0.9, use_nesterov=True,
                                          regularization=l2)),
        ("LarsMomentum", lambda: opt.LarsMomentum(1e-3, 0.9,
                                                  regularization=l2)),
        ("Adagrad", lambda: opt.Adagrad(2e-4, regularization=l2)),
        ("Adamax", lambda: opt.Adamax(2e-4, regularization=l2)),
        ("DecayedAdagrad", lambda: opt.DecayedAdagrad(
            2e-4, regularization=l2)),
        ("Adadelta", lambda: opt.Adadelta(1.0, regularization=l2)),
        ("RMSProp", lambda: opt.RMSProp(2e-4, regularization=l2)),
        ("RMSProp centered", lambda: opt.RMSProp(2e-4, centered=True,
                                                 regularization=l2)),
        ("Ftrl", lambda: opt.Ftrl(2e-4, regularization=l2)),
        ("Momentum L1Decay", lambda: opt.Momentum(
            1e-3, 0.9, regularization=reg.L1Decay(OPTIM_L1))),
    ]


def optim_program(fluid, make_opt, average):
    """Step 9's Transformer-base at OPTIM_LAYERS layers (dropout 0) with
    global-norm clipping and ``make_opt()``; with ``average``, a ModelAverage and the loss's
    forward slice to evaluate it. Returns (main, startup, loss, average,
    eval program)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.io import prune_program
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = TRAIN_SEED
    avg = None
    with unique_name.guard({}), fluid.program_guard(main, startup):
        loss, _, _ = transformer.build(
            src_vocab_size=VOCAB, trg_vocab_size=VOCAB, max_length=MAX_LEN,
            n_layer=OPTIM_LAYERS, n_head=N_HEAD, d_model=D_MODEL,
            d_inner=D_INNER, dropout=0.0, label_smooth_eps=LABEL_SMOOTH)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(OPTIM_CLIP), program=main)
        _, params_grads = make_opt().minimize(loss)
        if average:
            avg = fluid.optimizer.ModelAverage(OPTIM_AVG_RATE)
            avg.build([p for p, _ in params_grads])
    evaluate = None
    if average:
        evaluate = prune_program(main.clone(for_test=True),
                                 ["src_word", "src_len", "trg_word",
                                  "trg_len", "label"], [loss.name])
    return main, startup, loss, avg, evaluate


def optim_phase(np, torch, fluid, exe):
    """Every optimizer, clipped and decayed, on the card against the CPU
    (module docstring, step 14). The seeded parameters are drawn once
    (every run's model has the same names and shapes) and loaded into
    each run's card scope after its startup program; the CPU starts from
    a copy of that scope."""
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.testing import set_deterministic_params

    feed = {k: v[:OPTIM_BATCH]
            for k, v in train_feed(np, TRAIN_BATCH).items()}
    cpu = fluid.Executor(fluid.CPUPlace())
    params, worst = None, 0.0
    for name, make_opt in optim_runs(fluid):
        average = name == "Momentum"
        main, startup, loss, avg, evaluate = optim_program(
            fluid, make_opt, average)
        losses, secs, scopes = {}, {}, {}
        t0 = time.perf_counter()
        scopes["card"] = fluid.Scope()
        exe.run(startup, scope=scopes["card"])
        if params is None:
            set_deterministic_params(main, scopes["card"],
                                     parameters_only=True)
            params = {p.name: scopes["card"].get_value(p.name).cpu().numpy()
                      for p in main.global_block().all_parameters()}
        else:
            params_from_numpy(main, scopes["card"], params, "cuda")
        secs["card"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scopes["cpu"] = cpu_copy(np, fluid, main, scopes["card"])
        secs["cpu"] = time.perf_counter() - t0
        for dev, ex in (("card", exe), ("cpu", cpu)):
            t0 = time.perf_counter()
            scope = scopes[dev]
            losses[dev] = [float(np.asarray(ex.run(
                main, feed=feed, scope=scope,
                fetch_list=[loss])[0]).reshape(-1)[0])
                for _ in range(CVC_STEPS)]
            if average:
                avg.apply(ex, scope)
                losses[dev].append(float(np.asarray(ex.run(
                    evaluate, feed=feed, scope=scope,
                    fetch_list=[loss])[0]).reshape(-1)[0]))
                avg.restore(ex, scope)
                losses[dev].append(float(np.asarray(ex.run(
                    evaluate, feed=feed, scope=scope,
                    fetch_list=[loss])[0]).reshape(-1)[0]))
            secs[dev] += time.perf_counter() - t0
        err = max(abs(a - b) for a, b in zip(losses["card"], losses["cpu"]))
        worst = max(worst, err)
        print("optim %-16s: losses card %s cpu %s%s: max abs diff %.3e  tol "
              "%.0e (card %.1f s, cpu %.1f s)"
              % (name, ["%.6f" % v for v in losses["card"]],
                 ["%.6f" % v for v in losses["cpu"]],
                 " (the last two: ModelAverage apply, restore)" if average
                 else "", err, TRAIN_LOSS_TOL, secs["card"], secs["cpu"]))
        if not np.isfinite(losses["card"]).all() or not err <= TRAIN_LOSS_TOL:
            fail("card and CPU %s losses disagree: %.3e" % (name, err))
    return worst


# -- the Switch Transformer and the conv model zoo ----------------------------


def build_switch(fluid, n_layer=SW_LAYERS, dropout=SW_DROPOUT):
    """Switch-Base-8's classifier (``models/switch_transformer.py``) and
    its ``Adam`` step: (main, startup, loss, extras, [(param, grad)])."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import switch_transformer

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SW_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        loss, _, extras = switch_transformer.build(
            vocab_size=SW_VOCAB, max_length=SW_LEN, n_layer=n_layer,
            n_head=SW_HEADS, d_model=SW_D, d_inner=SW_INNER,
            num_experts=SW_EXPERTS, top_k=SW_TOP_K, moe_every=SW_EVERY,
            num_classes=SW_CLASSES, dropout=dropout)
        _, params_grads = fluid.optimizer.Adam(
            learning_rate=SW_LR).minimize(loss)
    return main, startup, loss, extras, params_grads


def switch_feed(np, batch):
    """One fixed batch: token ids over the whole vocabulary (0, the pad,
    aside), lengths uniform in SW_MIN_LEN..SW_LEN (the key masks and the
    routing masks are live), labels 0 or 1."""
    rng = np.random.RandomState(SEED + 3)
    return {"word": rng.randint(1, SW_VOCAB, (batch, SW_LEN)).astype(
                "int64"),
            "seq_len": rng.randint(SW_MIN_LEN, SW_LEN + 1,
                                   (batch, 1)).astype("int64"),
            "label": rng.randint(0, SW_CLASSES, (batch, 1)).astype("int64")}


def moe_probs(torch, x, gate_w):
    """The router's probabilities [N, E] as ``moe_ffn`` computes them."""
    x = torch.as_tensor(x).reshape(-1, gate_w.shape[0])
    return torch.softmax((x @ gate_w).float(), dim=-1)


def moe_inputs(main):
    """(X, gate weight) variable names of each moe_ffn op."""
    return [(op.input("X")[0], op.input("GateW")[0])
            for op in main.global_block().ops if op.type == "moe_ffn"]


def switch_phase(np, torch, fluid, kernels):
    """Switch-Base-8 trained at full width (module docstring, step 17).
    Returns {"launches", "mean_ms", "tokens_s", "busy"}."""
    from paddle_tpu_torch.ops.moe_ops import route

    main, startup, loss, extras, _ = build_switch(fluid)
    ops = main.global_block().ops
    scope = fluid.Scope()
    # a fresh executor: its run counter, which keys the initializers'
    # and the dropout masks' draws, starts at 0 wherever the phase runs
    exe = fluid.Executor()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    n_moe = sum(op.type == "moe_ffn" for op in ops)
    feed = switch_feed(np, SW_BATCH)
    tokens = int(feed["seq_len"].sum())
    print("switch: Switch-Base-8 program of %d ops (%d moe_ffn), %.1f M "
          "parameters (startup %.1f s), n_layer %d, n_head %d, d_model %d, "
          "d_inner %d, %d experts, top-%d, capacity factor %.2f, vocab %d, "
          "batch %d x %d (%d non-pad tokens), dropout %.1f, Adam(%g), fp32, "
          "TF32 off" % (len(ops), n_moe, n_params / 1e6,
                        time.perf_counter() - t0, SW_LAYERS, SW_HEADS, SW_D,
                        SW_INNER, SW_EXPERTS, SW_TOP_K, SW_CAPACITY,
                        SW_VOCAB, SW_BATCH, SW_LEN, tokens, SW_DROPOUT,
                        SW_LR))
    fetch = [loss, extras["aux_loss"]]
    losses, auxes = [], []
    for _ in range(SW_WARMUP):
        lv, av = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        auxes.append(float(np.asarray(av).reshape(-1)[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()
    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "threefry")
    for k in kernels.values():
        k.reset()
    reran = exe.grad_op_reruns
    step_ms, per_step = [], []
    for _ in range(SW_STEPS):
        before = [kernels[n].launches for n in names]
        t0 = time.perf_counter()
        lv, av = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        auxes.append(float(np.asarray(av).reshape(-1)[0]))
        per_step.append(tuple(kernels[n].launches - b
                              for n, b in zip(names, before)))
    launches = kernel_counts(kernels)
    reran = exe.grad_op_reruns - reran
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated()
    mean_ms = float(np.mean(step_ms))
    tokens_s = tokens / mean_ms * 1e3
    print("switch: losses %s" % ["%.4f" % v for v in losses])
    print("switch: aux losses (sum over the %d MoE layers) %s"
          % (n_moe, ["%.4f" % v for v in auxes]))
    print("switch: %d timed steps, mean %.1f ms/step (median %.1f, min "
          "%.1f, max %.1f): %.0f non-pad tokens/s; peak memory %.2f GiB; "
          "grad-op reruns %d" % (SW_STEPS, mean_ms, float(np.median(step_ms)),
                                 min(step_ms), max(step_ms), tokens_s,
                                 peak / 2 ** 30, reran))
    print("switch: kernel launches over the %d steps %s"
          % (SW_STEPS, json.dumps(launches)))
    if not np.isfinite(losses).all() or not np.isfinite(auxes).all():
        fail("a switch loss is not finite: %s, aux %s" % (losses, auxes))
    n_attn = SW_LAYERS
    n_drop = sum(op.type == "dropout" for op in ops)
    if any(c[:3] != (n_attn,) * 3 or c[3] != n_drop for c in per_step):
        fail("switch: per-step launches %s, expected flash_fwd, "
             "flash_bwd_dkv and flash_bwd_dq %d each and threefry %d"
             % (per_step, n_attn, n_drop))
    if reran:
        fail("%d grad ops reran their forward in the switch steps" % reran)
    late = float(np.mean(losses[-5:]))
    print("switch: loss step 1 %.6f, mean of the last 5 %.6f"
          % (losses[0], late))
    if not late < losses[0]:
        fail("the switch loss did not fall: %s" % losses)
    # the routing of the last step's batch, from each MoE layer's input
    # (one more step, fetched): tokens per expert by the pre-drop top-1
    # choice, the share of valid tokens dropped past the capacity
    pairs = moe_inputs(main)
    outs = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                   fetch_list=[x for x, _ in pairs])
    dev = outs[0].device
    valid = (torch.arange(SW_LEN, device=dev)[None, :]
             < torch.as_tensor(feed["seq_len"], device=dev)).reshape(-1)
    n = SW_BATCH * SW_LEN
    capacity = max(1, int(SW_CAPACITY * n * SW_TOP_K / SW_EXPERTS))
    dropped_all = 0
    for (xname, gname), x in zip(pairs, outs):
        probs = moe_probs(torch, x, scope.get_value(gname)) \
            * valid[:, None].float()
        (expert, _, keep, _), = route(probs, capacity, SW_TOP_K, valid)
        counts = torch.bincount(expert[valid], minlength=SW_EXPERTS)
        dropped = int((valid & ~keep).sum())
        dropped_all += dropped
        print("switch routing %s: tokens per expert %s (capacity %d), "
              "dropped %d of %d valid tokens (%.2f %%)"
              % (gname.split(".")[0], counts.tolist(), capacity, dropped,
                 tokens, 100.0 * dropped / tokens))
    print("switch routing: dropped share over the %d MoE layers %.2f %%"
          % (n_moe, 100.0 * dropped_all / (tokens * n_moe)))
    prof = profile_call(torch, "switch", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope))
    scope = None
    return dict(launches=launches, mean_ms=mean_ms, tokens_s=tokens_s,
                busy=None if prof is None
                else prof["busy_ms"] / prof["wall_ms"])


def switch_card_vs_cpu_phase(np, torch, fluid):
    """Switch-Base-8's widths at SW_CVC_LAYERS layers, batch SW_CVC_BATCH,
    dropout 0: one step on the card and on the CPU (plain versions) from
    the same parameters. Loss, logits and every gradient within
    SW_CVC_TOL; a token that the two devices route to different experts
    fails the run unless its router's top-2 margin is below
    SW_MARGIN_TOL on both."""
    main, startup, loss, extras, params_grads = build_switch(
        fluid, n_layer=SW_CVC_LAYERS, dropout=0.0)
    feed = switch_feed(np, SW_CVC_BATCH)
    pairs = moe_inputs(main)
    fetch = ([loss, extras["logits"]] + [g for _, g in params_grads]
             + [x for x, _ in pairs])
    card_scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=card_scope)
    cpu_scope = cpu_copy(np, fluid, main, card_scope)
    got = {}
    for dev, ex, scope in (
            ("card", exe, card_scope),
            ("cpu", fluid.Executor(fluid.CPUPlace()), cpu_scope)):
        t0 = time.perf_counter()
        out = ex.run(main, feed=feed, scope=scope, fetch_list=fetch,
                     return_numpy=False)
        got[dev] = dict(out=[o.cpu().double() for o in out], scope=scope,
                        s=time.perf_counter() - t0)
    n_g = len(params_grads)
    c, p = got["card"]["out"], got["cpu"]["out"]
    err_loss = float((c[0] - p[0]).abs().max())
    err_logits = float((c[1] - p[1]).abs().max())
    g_errs = [float((a - b).abs().max()) for a, b in zip(c[2:2 + n_g],
                                                         p[2:2 + n_g])]
    g_mag = max(float(b.abs().max()) for b in p[2:2 + n_g])
    for i in sorted(range(n_g), key=lambda i: -g_errs[i])[:3]:
        print("switch card vs cpu: gradient of %s %s: max abs diff %.3e, "
              "largest entry %.3e" % (params_grads[i][0].name,
                                      list(p[2 + i].shape), g_errs[i],
                                      float(p[2 + i].abs().max())))
    valid = (torch.arange(SW_LEN)[None, :]
             < torch.as_tensor(feed["seq_len"])).reshape(-1)
    flips, near = 0, []
    for (xname, gname), xc, xp in zip(pairs, c[2 + n_g:], p[2 + n_g:]):
        probs = {}
        for dev, x in (("card", xc), ("cpu", xp)):
            gate = got[dev]["scope"].get_value(gname)
            probs[dev] = moe_probs(torch, x.to(gate.device).float(),
                                   gate).cpu()
        e_card = probs["card"].argmax(-1)
        e_cpu = probs["cpu"].argmax(-1)
        differ = valid & (e_card != e_cpu)
        flips += int(differ.sum())
        for dev in ("card", "cpu"):
            top2 = probs[dev].topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            near += margin[differ].tolist()
    n_valid = int(valid.sum()) * len(pairs)
    print("switch card vs cpu: Switch-Base-8 widths at %d layers, batch %d x "
          "%d, one step (card %.1f s, cpu %.1f s): loss %.6f / %.6f (diff "
          "%.3e), logits max abs diff %.3e, gradients of %d parameters max "
          "abs diff %.3e (largest gradient entry %.3e); tol %.0e"
          % (SW_CVC_LAYERS, SW_CVC_BATCH, SW_LEN, got["card"]["s"],
             got["cpu"]["s"], float(c[0].reshape(-1)[0]),
             float(p[0].reshape(-1)[0]), err_loss, err_logits, n_g,
             max(g_errs), g_mag, SW_CVC_TOL))
    print("switch card vs cpu: %d of %d valid tokens routed to another "
          "expert (%.3f %%); their top-2 margins %s (tol %.0e)"
          % (flips, n_valid, 100.0 * flips / n_valid,
             ["%.2e" % m for m in near], SW_MARGIN_TOL))
    if any(m >= SW_MARGIN_TOL for m in near):
        fail("switch card vs cpu: a token routed differently at a top-2 "
             "margin of %.3e" % max(near))
    if not (max(err_loss, err_logits, max(g_errs)) <= SW_CVC_TOL):
        fail("switch card vs cpu: loss %.3e, logits %.3e, gradients %.3e "
             "above %.0e" % (err_loss, err_logits, max(g_errs), SW_CVC_TOL))


def cnn_program(fluid, name, img, classes):
    """One conv model's train program: (main, startup, loss)."""
    from paddle_tpu_torch import models, unique_name

    build = getattr(models, {"googlenet": "googlenet",
                             "se_resnext50": "se_resnext",
                             "alexnet": "alexnet", "vgg16": "vgg"}[name])
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = CNN_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        loss, _, _ = build.build(img_shape=img, class_num=classes)
        fluid.optimizer.Momentum(learning_rate=CNN_LR,
                                 momentum=CNN_MOMENTUM).minimize(loss)
    return main, startup, loss


def cnn_feed(np, img, classes, batch):
    """One fixed batch a model can learn (``tests/test_models_conv.py``'s
    synthetic images): each image its label's pattern, drawn from a seed
    of the label, plus a quarter of its own noise."""
    rng = np.random.RandomState(SEED)
    labels = rng.randint(0, classes, batch)
    pixel = np.stack([np.random.RandomState(int(c)).randn(*img)
                      for c in labels]) + 0.25 * rng.randn(batch, *img)
    return {"pixel": pixel.astype("float32"),
            "label": labels.reshape(-1, 1).astype("int64")}


def cnn_phase(np, torch, fluid):
    """GoogLeNet, SE-ResNeXt-50, AlexNet and VGG-16 trained on the card
    (module docstring, step 17), each on a fresh executor (its draws
    keyed from run 0). Returns {name: images/s}."""
    rates = {}
    for name, img, classes, batch in CNNS:
        main, startup, loss = cnn_program(fluid, name, img, classes)
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        feed = cnn_feed(np, img, classes, batch)
        losses = []
        for _ in range(CNN_WARMUP):
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reran = exe.grad_op_reruns
        step_ms = []
        gc.collect()
        gc.freeze()
        for _ in range(CNN_STEPS):
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        gc.unfreeze()
        reran = exe.grad_op_reruns - reran
        mean_ms = float(np.mean(step_ms))
        rates[name] = batch / mean_ms * 1e3
        prof = profile_call(torch, "cnn " + name, lambda: exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope), top=3)
        busy = (float("nan") if prof is None
                else 100.0 * prof["busy_ms"] / prof["wall_ms"])
        late = float(np.mean(losses[-5:]))
        print("cnn %s: %d ops, batch %d x %s, %d classes, Momentum(%g, %g): "
              "%d timed steps, mean %.1f ms/step (min %.1f, max %.1f): %.1f "
              "images/s; peak memory %.2f GiB; card busy %.1f %% of a "
              "profiled step; loss step 1 %.6f, mean of the last 5 %.6f; "
              "grad-op reruns %d"
              % (name, len(main.global_block().ops), batch,
                 "x".join(map(str, img)), classes, CNN_LR, CNN_MOMENTUM,
                 CNN_STEPS, mean_ms, min(step_ms), max(step_ms),
                 rates[name], torch.cuda.max_memory_allocated() / 2 ** 30,
                 busy, losses[0], late, reran))
        print("cnn %s: losses %s" % (name, ["%.4f" % v for v in losses]))
        if not np.isfinite(losses).all():
            fail("a cnn %s loss is not finite: %s" % (name, losses))
        if not late < losses[0]:
            fail("the cnn %s loss did not fall: %s" % (name, losses))
        if reran:
            fail("%d grad ops reran their forward in the cnn %s steps"
                 % (reran, name))
        scope = None
        torch.cuda.empty_cache()
    return rates


def golden_card_phase(np, torch, fluid, exe):
    """The goldens of this slice's models (``tests/golden/``, written by
    the JAX package) reproduced on the card from their feeds, as
    ``tests/golden_models.py`` builds them: within GOLDEN_TOL."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.io import prune_program
    from paddle_tpu_torch.models import (
        alexnet,
        googlenet,
        se_resnext,
        ssd,
        switch_transformer,
        vgg,
    )
    from paddle_tpu_torch.testing import set_deterministic_params

    builds = {
        "vgg16": (lambda: vgg.build(img_shape=(3, 32, 32), class_num=10),
                  "predict"),
        "googlenet": (lambda: googlenet.build(img_shape=(3, 96, 96),
                                              class_num=10), "predict"),
        "se_resnext50": (lambda: se_resnext.build(img_shape=(3, 64, 64),
                                                  class_num=10), "predict"),
        "alexnet": (lambda: alexnet.build(img_shape=(3, 224, 224),
                                          class_num=10), "predict"),
        "switch_transformer": (lambda: switch_transformer.build(
            vocab_size=80, max_length=12, n_layer=2, n_head=2, d_model=32,
            d_inner=64, num_experts=2, moe_every=2, dropout=0.0), "logits"),
        # the dense location head of the pruned test clone
        "ssd": (lambda: ssd.build(img_shape=(3, 96, 96), class_num=4),
                "mbox_locs"),
    }
    for name, (build, key) in builds.items():
        golden = np.load(os.path.join(HERE, "tests", "golden",
                                      name + ".npz"))
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 11
        with unique_name.guard({}), fluid.program_guard(main, startup):
            _, feeds, outs = build()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        set_deterministic_params(main, scope)
        feed = {k[len("feed_"):]: golden[k] for k in golden.files
                if k.startswith("feed_")}
        n = next(iter(feed.values())).shape[0]
        test = main.clone(for_test=True)
        if name == "ssd":
            test = prune_program(test, list(feed), [outs[key].name])
        else:
            for f in feeds:
                feed.setdefault(f.name, np.zeros((n, 1), "int64"))
        (out,) = exe.run(test, feed=feed, fetch_list=[outs[key].name],
                         scope=scope)
        err = float(np.abs(np.asarray(out) - golden["expected"]).max())
        print("golden %s on the card: output %s, max abs diff %.3e from "
              "tests/golden/%s.npz  tol %.0e"
              % (name, list(np.asarray(out).shape), err, name, GOLDEN_TOL))
        if not err <= GOLDEN_TOL:
            fail("golden %s: the card's output is %.3e from the golden"
                 % (name, err))


# -- detection (SSD) ------------------------------------------------------------

def nms_case(torch, gen, rows, k, scale=1.0, clusters=20):
    """Score-sorted NMS candidates as ``multiclass_nms`` hands them to
    ``greedy_nms``: ``rows`` rows of ``k`` boxes around ``clusters``
    centres each (so suppression happens), scores on a 0.01 grid (ties,
    kept in index order by the stable sort) with about a tenth below
    the 0.01 score threshold. Returns (boxes [rows, k, 4], eligible)."""
    dev = torch.device("cuda")
    centres = 0.8 * scale * torch.rand(rows, clusters, 2, generator=gen,
                                       device=dev) + 0.1 * scale
    pick = torch.randint(0, clusters, (rows, k), generator=gen, device=dev)
    ctr = torch.gather(centres, 1, pick[..., None].expand(rows, k, 2))
    ctr = ctr + 0.02 * scale * torch.randn(rows, k, 2, generator=gen,
                                           device=dev)
    wh = scale * (0.05 + 0.2 * torch.rand(rows, k, 2, generator=gen,
                                          device=dev))
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=2)
    scores = torch.round(torch.rand(rows, k, generator=gen, device=dev)
                         * 100) / 100
    order = torch.sort(-scores, dim=1, stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand(rows, k, 4))
    return boxes.contiguous(), torch.gather(scores, 1, order) > 0.1


def nms_tests(torch, kdet, boxes, eligible, keep, thr, offset):
    """The IoU tests the greedy NMS needs on these candidates (eta 1):
    each kept candidate against every kept one before it, each
    suppressed one up to the first kept candidate that suppresses it,
    in the kept list's order."""
    k = boxes.shape[1]
    ov = kdet.iou(boxes, boxes, offset)
    before = torch.ones(k, k, dtype=torch.bool,
                        device=boxes.device).tril(-1)
    pos = torch.cumsum(keep.to(torch.int64), dim=1)  # 1-based list slot
    sup = before & keep[:, None, :] & (ov > thr)
    first = torch.where(sup, pos[:, None, :], k + 1).amin(dim=2)
    kept_before = pos - keep.to(torch.int64)
    tests = torch.where(keep, kept_before, first)
    return int(torch.where(eligible, tests, 0).sum())


def det_match_arrays(np, n, d, g, classes, seed):
    """``detection_map``'s inputs as the SSD eval head gives them: per
    image 1..8 ground-truth boxes padded to ``g`` (label -1), ``d``
    detections (most near a gt, some of another class, some anywhere;
    scores on a 0.01 grid; the last rows label -1 padding, as
    multiclass_nms pads), a fifth of the gts difficult. Returns numpy
    (det, gt_label, gt_box, difficult)."""
    rng = np.random.RandomState(seed)
    gt_box = np.zeros((n, g, 4), "float32")
    gt_label = np.full((n, g), -1, "int32")
    det = np.zeros((n, d, 6), "float32")
    for i in range(n):
        m = rng.randint(1, min(SSD_MAX_BOXES, g) + 1)
        xy = rng.uniform(0, 0.7, (m, 2))
        gt_box[i, :m] = np.concatenate([xy, xy + rng.uniform(
            0.1, 0.3, (m, 2))], 1)
        gt_label[i, :m] = rng.randint(1, classes, m)
        live = rng.randint(d // 2, d + 1)
        src = rng.randint(0, m, live)
        near = rng.rand(live) < 0.6
        det[i, :live, 0] = np.where(near & (rng.rand(live) < 0.8),
                                    gt_label[i, src],
                                    rng.randint(1, classes, live))
        xy = rng.uniform(0, 0.7, (live, 2))
        anywhere = np.concatenate([xy, xy + rng.uniform(0.1, 0.3,
                                                        (live, 2))], 1)
        det[i, :live, 2:] = np.where(
            near[:, None], gt_box[i, src] + 0.03 * rng.randn(live, 4),
            anywhere)
        det[i, :live, 1] = np.round(rng.uniform(0.01, 1.0, live), 2)
        det[i, live:, 0] = -1
    return det, gt_label, gt_box, rng.rand(n, g) < 0.2


def det_match_case(np, torch, n, d, g, classes, seed):
    """``det_match_arrays`` on the card, with the detections' global
    rank: (det, rank, gt_label, gt_box, difficult)."""
    from paddle_tpu_torch.ops import detection_ops

    dev = torch.device("cuda")
    det, lab, box, diff = (torch.from_numpy(a).to(dev) for a in
                           det_match_arrays(np, n, d, g, classes, seed))
    _, rank = detection_ops.global_rank(det)
    return det, rank, lab, box, diff


def detection_kernel_phase(np, torch):
    """The port's two detection kernels against their plain versions on
    the card, bit for bit, on synthetic edge cases (module docstring,
    step 18; ``ssd_phase`` times them on the SSD eval head's own rows):
    ``greedy_nms`` at multiclass_nms's eval-head shape (20 classes of 32
    images, 400 candidates), with eta < 1, on pixel boxes, at
    generate_proposals' test shape and at its default pre_nms_topN of
    6,000 (the kernel's large shared-memory path), at its pre_nms_topN of
    12,000 and at multiclass_nms's nms_top_k -1 on the 28,276 priors
    (rows past the shared memory), a row with nothing eligible;
    ``det_match`` at the eval head's [32, 200] against 16 gts, with and
    without difficult ground truth, and at keep_top_k -1's 8,000
    detections an image (past the shared memory). Returns the worst
    error of each."""
    from paddle_tpu_torch.kernels import detection as kdet

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SSD_SEED)
    rows_ssd = SSD_BATCH * (SSD_CLASSES - 1)
    worst = {"greedy_nms": 0.0, "det_match": 0.0}
    cases = [
        ("multiclass_nms eval head", rows_ssd, SSD_NMS_TOP_K, 1.0,
         SSD_NMS_THR, 1.0, 0.0),
        ("multiclass_nms eta 0.9", rows_ssd, SSD_NMS_TOP_K, 1.0, 0.7, 0.9,
         0.0),
        ("multiclass_nms pixel boxes", 64, SSD_NMS_TOP_K, 300.0, 0.5, 1.0,
         1.0),
        ("generate_proposals test", 2, 24, 32.0, 0.7, 1.0, 0.0),
        ("generate_proposals test, eta 0.9", 2, 24, 32.0, 0.7, 0.9, 0.0),
        ("generate_proposals pre_nms_topN 6000", 2, 6000, 800.0, 0.7, 1.0,
         0.0),
        ("generate_proposals pre_nms_topN 12000", 2, 12000, 800.0, 0.7,
         0.9, 0.0),
        ("multiclass_nms nms_top_k -1", 1, SSD_PRIORS, 1.0, SSD_NMS_THR,
         1.0, 0.0),
        ("one candidate", 3, 1, 1.0, 0.3, 1.0, 0.0),
    ]
    for label, rows, k, scale, thr, eta, offset in cases:
        boxes, elig = nms_case(torch, gen, rows, k, scale)
        if label == "one candidate":
            elig[0] = False  # a row with nothing eligible
        got = kdet.greedy_nms(boxes, elig, thr, eta, offset)
        want = kdet.greedy_nms_plain(boxes, elig, thr, eta, offset)
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        worst["greedy_nms"] = max(worst["greedy_nms"], err)
        print("kernel greedy_nms %-38s [%d,%d] thr %.2f eta %.1f offset "
              "%.0f (%s): kept %d of %d eligible; keep mask equal to the "
              "plain version's %s (tol 0: bit for bit)"
              % (label, rows, k, thr, eta, offset,
                 "staged" if k <= kdet.NMS_MAX_K else "unstaged",
                 int(want.sum()), int(elig.sum()), bool(err == 0)))
        if err:
            fail("greedy_nms %s: the keep mask differs from the plain "
                 "version's" % label)
    for label, n, d, eval_diff in (
            ("eval head", SSD_BATCH, SSD_KEEP, True),
            ("eval head, difficult skipped", SSD_BATCH, SSD_KEEP, False),
            ("keep_top_k -1", 2, SSD_NMS_TOP_K * (SSD_CLASSES - 1), True)):
        det, rank, lab, box, diff = det_match_case(
            np, torch, n, d, SSD_MAX_GT, SSD_CLASSES,
            SSD_SEED + int(eval_diff))
        got = kdet.det_match(det, rank, lab, box, diff, 0.5, eval_diff)
        want = kdet.det_match_plain(det, rank, lab, box, diff, 0.5,
                                    eval_diff)
        torch.cuda.synchronize()
        err = max(float((a.int() - b.int()).abs().max())
                  for a, b in zip(got, want))
        worst["det_match"] = max(worst["det_match"], err)
        print("kernel det_match %-30s [%d,%d] against %d gts, "
              "evaluate_difficult %s: %d true and %d false positives; "
              "equal to the plain version's %s (tol 0: bit for bit)"
              % (label, n, d, SSD_MAX_GT, eval_diff, int(want[0].sum()),
                 int(want[1].sum()), bool(err == 0)))
        if err:
            fail("det_match %s: the flags differ from the plain version's"
                 % label)
    return worst


def detection_timing(np, torch, nms_args, match_args):
    """Both detection kernels timed on the SSD eval head's own inputs:
    ``nms_args`` (boxes [rows, k, 4], eligible, thr, eta, offset) as
    multiclass_nms hands them to ``greedy_nms``, ``match_args`` (det,
    rank, gt_label, gt_box, difficult, thr, evaluate_difficult) as
    detection_map hands them to ``det_match``. Kernel: graph replays over
    copies; plain loop: eager; bounds from the IoU tests and areas this
    data needs at the FP32 instruction rate, or the bytes."""
    from paddle_tpu_torch.kernels import detection as kdet

    boxes, elig, thr, eta, offset = nms_args
    rows, k = elig.shape
    keep = kdet.greedy_nms_plain(boxes, elig, thr, eta, offset)
    tests = nms_tests(torch, kdet, boxes, elig, keep, thr, offset)
    n_elig = int(elig.sum())
    timing = {}
    timing["greedy_nms"] = dict(
        shape="the SSD eval head's multiclass_nms rows [%d,%d] (%d images "
        "x %d classes, nms_top_k %d), thr %.2f eta %g: %d eligible, %d "
        "kept, %d IoU tests" % (rows, k, SSD_BATCH, SSD_CLASSES - 1, k, thr,
                                eta, n_elig, int(keep.sum()), tests),
        ms=cuda_ms(lambda boxes, elig: kdet.greedy_nms(
            boxes, elig, thr, eta, offset), copies(dict(boxes=boxes,
                                                        elig=elig))),
        plain_ms=eager_ms(lambda i: kdet.greedy_nms_plain(
            boxes, elig, thr, eta, offset), [0], iters=3),
        library_ms=None,
        bound=bound(rows * k * (16 + 1 + 1),
                    tests * IOU_TEST_OPS + n_elig * AREA_OPS,
                    PEAK_FP32_OPS))
    det, rank, lab, box, diff, mthr, eval_diff = match_args
    n, d, g = det.shape[0], det.shape[1], lab.shape[1]
    # the IoUs this data needs: each valid detection against the gts of
    # its class; the areas of the valid detections and the real gts
    valid = det[:, :, 0] >= 0
    cls = det[:, :, 0].to(torch.int32)
    pairs = int((valid[:, :, None]
                 & (lab[:, None, :] == cls[:, :, None])).sum())
    boxes_n = int(valid.sum()) + int((lab >= 0).sum())
    timing["det_match"] = dict(
        shape="the SSD eval head's detection_map: det [%d,%d,6] (%d valid), "
        "%d gts an image (%d real), %d same-class pairs"
        % (n, d, int(valid.sum()), g, int((lab >= 0).sum()), pairs),
        ms=cuda_ms(lambda det: kdet.det_match(
            det, rank, lab, box, diff, mthr, eval_diff),
            copies(dict(det=det))),
        plain_ms=eager_ms(lambda i: kdet.det_match_plain(
            det, rank, lab, box, diff, mthr, eval_diff), [0], iters=3),
        library_ms=None,
        bound=bound(n * d * (24 + 8 + 2) + n * g * (4 + 16 + 1),
                    pairs * IOU_TEST_OPS + boxes_n * AREA_OPS,
                    PEAK_FP32_OPS))
    for name, r in timing.items():
        print("time %-20s %s: kernel %.4f ms, plain %.4f ms, library none, "
              "bound %.4f ms (%s; float instructions at %.1f T/s)"
              % (name, r["shape"], r["ms"], r["plain_ms"], r["bound"][0],
                 r["bound"][1], PEAK_FP32_OPS / 1e12))
    return timing


def ssd_program(fluid, img, classes=SSD_CLASSES, max_gt=SSD_MAX_GT):
    """models/ssd.py's train program, its test clone (the eval head)
    taken before the optimizer: (main, startup, test, loss, extras)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import ssd

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SSD_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        loss, _, extras = ssd.build(img_shape=(3, img, img),
                                    class_num=classes, max_gt=max_gt,
                                    nms_keep_top_k=SSD_KEEP)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=SSD_LR).minimize(loss)
    return main, startup, test, loss, extras


def ssd_feed(np, batch, img, seed):
    """One fixed batch: images uniform in [0, 1), 1..8 boxes an image
    (corners in [0, 1], sides 0.1..0.3) padded to SSD_MAX_GT with zero
    boxes and label -1, labels 1..20."""
    rng = np.random.RandomState(seed)
    gt_box = np.zeros((batch, SSD_MAX_GT, 4), "float32")
    gt_label = np.full((batch, SSD_MAX_GT), -1, "int32")
    for i in range(batch):
        m = rng.randint(1, SSD_MAX_BOXES + 1)
        xy = rng.uniform(0, 0.7, (m, 2))
        gt_box[i, :m] = np.concatenate([xy, xy + rng.uniform(
            0.1, 0.3, (m, 2))], 1)
        gt_label[i, :m] = rng.randint(1, SSD_CLASSES, m)
    return {"image": rng.rand(batch, 3, img, img).astype("float32"),
            "gt_box": gt_box, "gt_label": gt_label}


def eval_names(test):
    """The eval head's op of each kernel: (multiclass_nms's attrs, its
    BBoxes, Scores and Count names)."""
    op = [o for o in test.global_block().ops if o.type == "multiclass_nms"]
    if len(op) != 1:
        fail("the SSD eval head holds %d multiclass_nms ops, not 1"
             % len(op))
    op = op[0]
    return (op.attrs, op.input("BBoxes")[0], op.input("Scores")[0],
            op.output("Count")[0])


def ssd_phase(np, torch, fluid, kernels):
    """SSD, models/ssd.py's backbone at a 300 x 300 input and VOC's 21
    classes (module docstring, step 18): 5 + 20 Adam steps on a fresh
    executor, then the eval head (NMS and mAP) on the test clone on
    another; the kernels' counts reset just before the steps and read
    after the eval head. Then both detection kernels against their plain
    versions and timed on the eval head's own inputs. Returns {"rate",
    "launches", "timing", ...}."""
    from paddle_tpu_torch.kernels import detection as kdet
    from paddle_tpu_torch.ops import detection_ops

    main, startup, test, loss, extras = ssd_program(fluid, SSD_IMG)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    feed = ssd_feed(np, SSD_BATCH, SSD_IMG, SSD_SEED)
    n_priors = int(extras["mbox_locs"].shape[1])
    for k in kernels.values():
        k.reset()
    losses = []
    for _ in range(SSD_WARMUP):
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    gc.collect()
    gc.freeze()
    for _ in range(SSD_STEPS):
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reran = exe.grad_op_reruns
    train_counts = kernel_counts(kernels)
    prof = profile_call(torch, "ssd step", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope), top=6)
    mean_ms = float(np.mean(step_ms))
    rate = SSD_BATCH / mean_ms * 1e3
    busy = (float("nan") if prof is None
            else 100.0 * prof["busy_ms"] / prof["wall_ms"])
    late = float(np.mean(losses[-5:]))
    print("ssd: %d ops, %d priors, batch %d x 3x%dx%d, %d classes, "
          "Adam(%g): %d timed steps, mean %.1f ms/step (min %.1f, max "
          "%.1f): %.1f images/s; peak memory %.2f GiB; card busy %.1f %% "
          "of a profiled step, %s launches a step; loss step 1 %.6f, mean "
          "of the last 5 %.6f; grad-op reruns %d"
          % (len(main.global_block().ops), n_priors, SSD_BATCH, SSD_IMG,
             SSD_IMG, SSD_CLASSES, SSD_LR, SSD_STEPS, mean_ms,
             min(step_ms), max(step_ms), rate, peak, busy,
             "?" if prof is None else prof["launches"], losses[0], late,
             reran))
    print("ssd: losses %s" % ["%.4f" % v for v in losses])
    if not np.isfinite(losses).all():
        fail("an SSD loss is not finite: %s" % losses)
    if not late < losses[0]:
        fail("the SSD loss did not fall: %s" % losses)
    if reran:
        fail("%d grad ops reran their forward in the SSD steps" % reran)
    # models/ssd.py builds the eval head into the train program too, and
    # the executor runs every op of a program, so a train step may run
    # the NMS and the mAP (the JAX package's jit drops them as dead code):
    # reported, not gated
    print("ssd: greedy_nms launches %d, det_match launches %d in the %d "
          "train steps (ops no loss needs, run by the executor)"
          % (train_counts["greedy_nms"], train_counts["det_match"],
             SSD_WARMUP + SSD_STEPS))
    # the eval head on a fresh executor, on the trained scope
    attrs, box_name, score_name, count_name = eval_names(test)
    ev = fluid.Executor()
    pre_eval = kernel_counts(kernels)
    t0 = time.perf_counter()
    out, m_ap, count, nms_boxes, nms_scores = ev.run(
        test, feed=feed, scope=scope,
        fetch_list=[extras["nmsed_out"], extras["map_eval"], count_name,
                    box_name, score_name])
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    counts = kernel_counts(kernels)
    evals = {k: counts[k] - pre_eval[k] for k in ("greedy_nms",
                                                  "det_match")}
    out, count = np.asarray(out), np.asarray(count)
    m_ap = float(np.asarray(m_ap).reshape(-1)[0])
    print("ssd eval head: %.1f ms; nmsed_out %s, Count per image %s; mAP "
          "%.6f; greedy_nms launches %d, det_match launches %d"
          % (eval_ms, list(out.shape), count.tolist(), m_ap,
             evals["greedy_nms"], evals["det_match"]))
    if out.shape != (SSD_BATCH, SSD_KEEP, 6) or not np.isfinite(out).all():
        fail("the SSD eval head's nmsed_out is %s, finite %s"
             % (out.shape, np.isfinite(out).all()))
    if not ((count >= 0) & (count <= SSD_KEEP)).all():
        fail("an SSD Count lies outside 0..%d: %s" % (SSD_KEEP, count))
    if not 0.0 <= m_ap <= 1.0:
        fail("the SSD mAP %.6f lies outside [0, 1]" % m_ap)
    if not evals["greedy_nms"] or not evals["det_match"]:
        fail("the SSD eval head did not launch greedy_nms (%d) and "
             "det_match (%d)" % (evals["greedy_nms"], evals["det_match"]))
    # the eval head's own inputs through the kernels and their plain
    # versions: equal bit for bit (launches past the counts read above)
    dev = torch.device("cuda")
    s, b = detection_ops.nms_candidates(
        torch.from_numpy(np.asarray(nms_scores)).to(dev),
        torch.from_numpy(np.asarray(nms_boxes)).to(dev), attrs)
    got = detection_ops.nms_keep(s, b, attrs)
    want = detection_ops.nms_keep(s, b, attrs, nms=kdet.greedy_nms_plain)
    det = torch.from_numpy(out).to(dev)
    _, rank = detection_ops.global_rank(det)
    lab = torch.from_numpy(feed["gt_label"]).to(dev)
    box = torch.from_numpy(feed["gt_box"]).to(dev)
    diff = torch.zeros_like(lab, dtype=torch.bool)
    map_attrs = [o for o in test.global_block().ops
                 if o.type == "detection_map"][0].attrs
    mthr = map_attrs.get("overlap_threshold", 0.5)
    eval_diff = map_attrs.get("evaluate_difficult", True)
    tp, fp = kdet.det_match(det, rank, lab, box, diff, mthr, eval_diff)
    tp_p, fp_p = kdet.det_match_plain(det, rank, lab, box, diff, mthr,
                                      eval_diff)
    equal = (torch.equal(got, want) and torch.equal(tp, tp_p)
             and torch.equal(fp, fp_p))
    print("ssd eval head: its NMS rows [%d,%d] (%d kept) and its match "
          "(%d true, %d false positives) through the kernels equal the "
          "plain versions' %s" % (s.shape[0] * s.shape[1], s.shape[2],
                                  int(want.sum()), int(tp_p.sum()),
                                  int(fp_p.sum()), equal))
    if not equal:
        fail("the SSD eval head's kernels differ from their plain versions")
    n, m, k = s.shape
    eta = attrs.get("nms_eta", 1.0)
    if eta != 1.0:
        fail("nms_tests counts the IoU tests at a fixed threshold, not "
             "eta %g" % eta)
    timing = detection_timing(
        np, torch,
        (b.reshape(n * m, k, 4).contiguous(),
         (s > attrs.get("score_threshold", 0.0)).reshape(n * m, k),
         attrs.get("nms_threshold", 0.3), eta,
         0.0 if attrs.get("normalized", True) else 1.0),
        (det, rank, lab, box, diff, mthr, eval_diff))
    return dict(rate=rate, step_ms=mean_ms, peak=peak, busy=busy,
                launches={"greedy_nms": counts["greedy_nms"],
                          "det_match": counts["det_match"]},
                timing=timing)


def ssd_card_vs_cpu_phase(np, torch, fluid):
    """SSD at 96 x 96 (21 classes, 2 images): the eval head on the card
    and on the CPU from the same parameters, the dense heads within
    SSD_CVC_TOL; then multiclass_nms and detection_map, in a program of
    their own, fed the card's own boxes and scores on both sides: equal
    selections, mAP within 1e-6."""
    _, startup, test, _, extras = ssd_program(fluid, SSD_CVC_IMG)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    cpu_scope = cpu_copy(np, fluid, test, scope)
    feed = ssd_feed(np, SSD_CVC_BATCH, SSD_CVC_IMG, SSD_SEED + 1)
    attrs, box_name, score_name, count_name = eval_names(test)
    fetch = [extras["mbox_locs"], extras["mbox_confs"], extras["nmsed_out"],
             count_name, box_name, score_name]
    card = [np.asarray(v) for v in exe.run(test, feed=feed, scope=scope,
                                           fetch_list=fetch)]
    cpu = [np.asarray(v) for v in fluid.Executor(fluid.CPUPlace()).run(
        test, feed=feed, scope=cpu_scope, fetch_list=fetch)]
    head_err = max(float(np.abs(a - b).max())
                   for a, b in zip(card[:2], cpu[:2]))
    # the selection ops on the card's own boxes and scores, both sides
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        n_priors, n_cls = card[4].shape[1], card[5].shape[1]
        bv = fluid.layers.data("boxes", [n_priors, 4])
        sv = fluid.layers.data("scores", [n_cls, n_priors])
        lv = fluid.layers.data("gt_label", [SSD_MAX_GT], dtype="int32")
        gv = fluid.layers.data("gt_box", [SSD_MAX_GT, 4])
        nms_out, nms_count = fluid.layers.multiclass_nms(
            bv, sv, background_label=attrs["background_label"],
            score_threshold=attrs["score_threshold"],
            nms_top_k=attrs["nms_top_k"],
            nms_threshold=attrs["nms_threshold"], nms_eta=attrs["nms_eta"],
            keep_top_k=attrs["keep_top_k"], normalized=attrs["normalized"])
        m_ap = fluid.layers.detection_map(nms_out, lv, gv,
                                          class_num=SSD_CLASSES)
    sel_feed = dict(boxes=card[4], scores=card[5],
                    gt_label=feed["gt_label"], gt_box=feed["gt_box"])
    sel = {}
    for dev, ex in (("card", fluid.Executor()),
                    ("cpu", fluid.Executor(fluid.CPUPlace()))):
        sel[dev] = [np.asarray(v) for v in ex.run(
            main, feed=sel_feed, fetch_list=[nms_out, nms_count, m_ap])]
    same_sel = (np.array_equal(sel["card"][0], sel["cpu"][0])
                and np.array_equal(sel["card"][1], sel["cpu"][1])
                and np.array_equal(sel["card"][0], card[2])
                and np.array_equal(sel["card"][1], card[3]))
    map_err = abs(float(sel["card"][2]) - float(sel["cpu"][2]))
    print("ssd card vs cpu: %dx%d, %d images: mbox_locs / mbox_confs max "
          "abs diff %.3e (tol %.0e); multiclass_nms on the card's boxes and "
          "scores: Count %s card, %s cpu, rows equal %s (and equal to the "
          "eval head's); detection_map %.6f card, %.6f cpu, diff %.1e "
          "(tol 1e-6)" % (SSD_CVC_IMG, SSD_CVC_IMG, SSD_CVC_BATCH, head_err,
                          SSD_CVC_TOL, sel["card"][1].tolist(),
                          sel["cpu"][1].tolist(), same_sel,
                          float(sel["card"][2]), float(sel["cpu"][2]),
                          map_err))
    if not head_err <= SSD_CVC_TOL:
        fail("the SSD dense heads differ between card and CPU: %.3e"
             % head_err)
    if not same_sel or not map_err <= 1e-6:
        fail("multiclass_nms / detection_map differ between card and CPU "
             "on equal inputs")


def sweep_cases(np, fluid):
    """(name, build(fluid) -> fetch vars, feed, grad input names or ())
    for every detection op type and the twelve loss op types, at
    tests/test_detection.py's and tests/test_torch_loss_ops.py's
    shapes."""
    L = fluid.layers
    rng = np.random.RandomState(SSD_SEED)

    def boxes(n, scale=1.0):
        xy = rng.uniform(0, 0.7 * scale, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(
            0.1 * scale, 0.3 * scale, (n, 2))], 1).astype("float32")

    def f32(*shape):
        return rng.randn(*shape).astype("float32")

    def data(name, arr, **kw):
        return L.data(name, list(arr.shape[1:]), dtype=str(arr.dtype), **kw)

    cases = []

    def add(name, feed, build, grads=()):
        cases.append((name, feed, build, grads))

    priors = boxes(8)
    gt = np.stack([boxes(3) for _ in range(2)])
    gt[1, 2] = 0.0
    add("prior_box", {"feat": f32(2, 4, 3, 3), "img": f32(2, 3, 30, 30)},
        lambda: list(L.prior_box(L.data("feat", [4, 3, 3]),
                                 L.data("img", [3, 30, 30]), [6.0, 12.0],
                                 [12.0, 20.0], [2.0, 3.0], flip=True,
                                 clip=True)))
    add("density_prior_box", {"feat": f32(1, 4, 4, 4),
                              "img": f32(1, 3, 32, 32)},
        lambda: list(L.density_prior_box(
            L.data("feat", [4, 4, 4]), L.data("img", [3, 32, 32]),
            densities=[2, 1], fixed_sizes=[8.0, 16.0], clip=True)))
    add("anchor_generator", {"feat": f32(1, 8, 2, 2)},
        lambda: list(L.anchor_generator(
            L.data("feat", [8, 2, 2]), anchor_sizes=[32.0, 64.0],
            aspect_ratios=[0.5, 1.0], stride=[16.0, 16.0])))
    def coder(gv, pv, lv):
        return [L.iou_similarity(gv, pv), L.box_coder(pv, None, gv),
                L.box_coder(pv, None, lv, code_type="decode_center_size")]

    add("iou_similarity + box_coder", {"gt": gt, "pb": priors,
                                       "loc": 0.1 * f32(2, 8, 4)},
        lambda: coder(L.data("gt", [3, 4]),
                      L.data("pb", [8, 4], append_batch_size=False),
                      L.data("loc", [8, 4])))
    add("polygon_box_transform", {"x": f32(1, 4, 3, 3)},
        lambda: [L.polygon_box_transform(L.data("x", [4, 3, 3]))])
    dist = np.stack([np.maximum(0, rng.rand(3, 8) - 0.4) for _ in range(2)]
                    ).astype("float32")
    dist[1, 2] = 0.0
    for mt in ("bipartite", "per_prediction"):
        add("bipartite_match " + mt, {"dist": dist},
            lambda mt=mt: list(L.bipartite_match(L.data("dist", [3, 8]), mt,
                                                 0.3)))
    midx = np.array([[0, -1, 2, 1, -1], [2, 2, -1, 0, 1]], "int32")
    def assign(xv, x4v, mv, nv):
        return (list(L.target_assign(xv, mv, negative_mask=nv))
                + list(L.target_assign(x4v, mv, mismatch_value=0.5)))

    add("target_assign", {"x": f32(2, 3, 4), "x4": f32(2, 3, 5, 4),
                          "m": midx,
                          "neg": (rng.rand(2, 5) < 0.3).astype("float32")},
        lambda: assign(L.data("x", [3, 4]), L.data("x4", [3, 5, 4]),
                       L.data("m", [5], dtype="int32"), L.data("neg", [5])))
    mine_feed = {"cl": np.round(rng.rand(2, 12), 1).astype("float32"),
                 "mi": np.where(rng.rand(2, 12) < 0.2, 0, -1).astype(
                     "int32"),
                 "md": rng.rand(2, 12).astype("float32")}

    def mine():
        from paddle_tpu_torch.layer_helper import LayerHelper

        helper = LayerHelper("mine_hard_examples")
        neg = helper.create_variable_for_type_inference("float32")
        upd = helper.create_variable_for_type_inference("int32")
        helper.append_op(
            type="mine_hard_examples",
            inputs={"ClsLoss": [L.data("cl", [12])],
                    "MatchIndices": [L.data("mi", [12], dtype="int32")],
                    "MatchDist": [L.data("md", [12])]},
            outputs={"NegMask": [neg], "UpdatedMatchIndices": [upd]})
        return [neg, upd]

    add("mine_hard_examples", mine_feed, mine)
    nb = np.stack([boxes(16, 20.0) for _ in range(2)])
    nb[:, 8:] = nb[:, :8] + 0.5
    add("multiclass_nms", {"b": nb, "s": np.round(rng.rand(2, 4, 16), 1)
                           .astype("float32")},
        lambda: list(L.multiclass_nms(
            L.data("b", [16, 4]), L.data("s", [4, 16]), background_label=2,
            score_threshold=0.15, nms_top_k=12, nms_threshold=0.7,
            nms_eta=0.8, keep_top_k=20, normalized=False)))
    det, lab, gbox, diff = det_match_arrays(np, 3, 8, 4, 4, SSD_SEED)
    for ap in ("integral", "11point"):
        add("detection_map " + ap, {"d": det, "l": lab, "b": gbox,
                                    "f": diff.astype("float32")},
            lambda ap=ap: [L.detection_map(
                L.data("d", [8, 6]), L.data("l", [4], dtype="int32"),
                L.data("b", [4, 4]), gt_difficult=L.data("f", [4]),
                class_num=4, ap_version=ap, evaluate_difficult=False)])
    x_roi = f32(2, 3, 8, 8)
    rois = np.array([[0, 0, 7, 7], [2, 2, 6, 6], [1.3, 4.1, 9.0, 7.7]],
                    "float32")
    batch = np.array([0, 1, 1], "int32")
    roi_feed = {"x": x_roi, "r": rois, "bi": batch}

    def roi(fn):
        def build():
            xv = L.data("x", [3, 8, 8], stop_gradient=False)
            rv = L.data("r", [4])
            bv = L.data("bi", [], dtype="int32")
            return [fn(xv, rv, bv)]
        return build

    add("roi_pool", roi_feed, roi(lambda x, r, b: L.roi_pool(
        x, r, 2, 3, 0.9, rois_batch=b)), ("x",))
    add("roi_align", roi_feed, roi(lambda x, r, b: L.roi_align(
        x, r, 3, 3, 0.8, sampling_ratio=2, rois_batch=b)), ("x",))
    quads = np.array([[0, 0, 7, 0, 7, 7, 0, 7],
                      [1, 1, 6, 0.5, 7, 6, 0.5, 5.5]], "float32")
    add("roi_perspective_transform", {"x": x_roi[:1], "q": quads},
        lambda: [L.roi_perspective_transform(
            L.data("x", [3, 8, 8], stop_gradient=False), L.data("q", [8]),
            4, 5, 0.9)], ("x",))
    anchors = boxes(32, 30.0)
    rgt = np.stack([boxes(3, 30.0) for _ in range(2)])
    rgt[0, 2] = 0.0
    add("rpn_target_assign (threefry)",
        {"a": anchors, "g": rgt, "im": np.tile(np.array(
            [[40.0, 40.0, 1.0]], "float32"), (2, 1)),
         "bp": f32(2, 32, 4), "cl": f32(2, 32, 1)},
        lambda: list(L.rpn_target_assign(
            L.data("bp", [32, 4]), L.data("cl", [32, 1]),
            L.data("a", [32, 4], append_batch_size=False), None,
            L.data("g", [3, 4]), im_info=L.data("im", [3]),
            rpn_batch_size_per_im=16, rpn_straddle_thresh=-1.0,
            rpn_positive_overlap=0.6, use_random=True)))

    def proposals():
        anc, var = L.anchor_generator(
            L.data("feat", [8, 4, 4]), anchor_sizes=[8.0],
            aspect_ratios=[0.5, 1.0, 2.0], stride=[8.0, 8.0])
        return list(L.generate_proposals(
            L.data("s", [3, 4, 4]), L.data("d", [12, 4, 4]),
            L.data("im", [3]), anc, var, pre_nms_top_n=24,
            post_nms_top_n=8, nms_thresh=0.7, min_size=1.0, eta=0.9))

    add("generate_proposals", {
        "s": rng.uniform(0, 1, (2, 3, 4, 4)).astype("float32"),
        "d": 0.1 * f32(2, 12, 4, 4),
        "im": np.array([[32.0, 32.0, 1.0], [28.0, 30.0, 2.0]], "float32"),
        "feat": f32(2, 8, 4, 4)}, proposals)
    pgt = np.stack([boxes(3, 30.0) for _ in range(2)])
    prois = np.concatenate([pgt[0, :2] + 0.8 * f32(2, 4), boxes(18, 30.0)])
    add("generate_proposal_labels (threefry)",
        {"r": prois, "c": np.array([[1, 2, -1], [2, 1, 1]], "int32"),
         "g": pgt},
        lambda: list(L.generate_proposal_labels(
            L.data("r", [20, 4], append_batch_size=False),
            L.data("c", [3], dtype="int32"), None, L.data("g", [3, 4]),
            batch_size_per_im=8, class_nums=3, use_random=True)))

    # the loss op types (tests/test_torch_loss_ops.py's inputs); the
    # gradient of the main output's sum to the differentiable inputs
    def op(op_type, slots, outs, main, attrs):
        def build():
            blk = fluid.default_main_program().global_block()
            ins = {s: [L.data(s.lower(), list(feed_of[op_type][s.lower()]
                                              .shape[1:]),
                              stop_gradient=False).name] for s in slots}
            out_vars = [blk.create_var(name="out_" + o.lower())
                        for o in outs]
            blk.append_op(type=op_type, inputs=ins,
                          outputs={o: [v.name]
                                   for o, v in zip(outs, out_vars)},
                          attrs=attrs)
            return out_vars[main:] + out_vars[:main]
        return build

    p = rng.uniform(0.1, 0.9, (6, 1)).astype("float32")
    lbl = (rng.rand(6, 1) > 0.5).astype("float32")
    feed_of = {
        "sigmoid_cross_entropy_with_logits": {"x": f32(4, 5), "label": rng
                                              .rand(4, 5).astype("float32")},
        "bce_loss": {"x": rng.uniform(0.05, 0.95, (4, 3)).astype("float32"),
                     "label": (rng.rand(4, 3) > 0.5).astype("float32")},
        "squared_l2_distance": {"x": f32(3, 4), "y": f32(3, 4)},
        "squared_l2_norm": {"x": f32(3, 4)},
        "smooth_l1_loss": {"x": f32(4, 3), "y": f32(4, 3),
                           "insideweight": rng.rand(4, 3).astype("float32"),
                           "outsideweight": rng.rand(4, 3).astype(
                               "float32")},
        "huber_loss": {"x": f32(3, 1), "y": 2 * f32(3, 1)},
        "log_loss": {"predicted": p, "labels": lbl},
        "hinge_loss": {"logits": f32(3, 1), "labels": lbl[:3]},
        "rank_loss": {"label": lbl[:3], "left": f32(3, 1),
                      "right": f32(3, 1)},
        "margin_rank_loss": {"label": np.array([[1.0], [1.0], [-1.0]],
                                               "float32"),
                             "x1": f32(3, 1), "x2": f32(3, 1)},
        "kldiv_loss": {"x": np.log(rng.dirichlet(np.ones(5), 4)).astype(
            "float32"), "target": rng.dirichlet(np.ones(5), 4).astype(
                "float32")},
        "modified_huber_loss": {"x": np.array([[2.2], [0.4], [-0.3], [-3.1]],
                                              "float32"),
                                "y": np.array([[1.0], [1.0], [0.0], [1.0]],
                                              "float32")},
    }
    # (op type, input slots, output slots, the main output, attrs, the
    # inputs with a gradient)
    specs = [
        ("sigmoid_cross_entropy_with_logits", ["X", "Label"], ["Out"], 0,
         {}, ("x",)),
        ("bce_loss", ["X", "Label"], ["Out"], 0, {}, ("x",)),
        ("squared_l2_distance", ["X", "Y"], ["sub_result", "Out"], 1, {},
         ("x", "y")),
        ("squared_l2_norm", ["X"], ["Out"], 0, {}, ("x",)),
        ("smooth_l1_loss", ["X", "Y", "InsideWeight", "OutsideWeight"],
         ["Diff", "Out"], 1, {"sigma": 1.5}, ("x", "y")),
        ("huber_loss", ["X", "Y"], ["Residual", "Out"], 1, {"delta": 1.0},
         ("x", "y")),
        ("log_loss", ["Predicted", "Labels"], ["Loss"], 0, {},
         ("predicted",)),
        ("hinge_loss", ["Logits", "Labels"], ["Loss"], 0, {}, ("logits",)),
        ("rank_loss", ["Label", "Left", "Right"], ["Out"], 0, {},
         ("left", "right")),
        ("margin_rank_loss", ["Label", "X1", "X2"], ["Activated", "Out"], 1,
         {"margin": 0.1}, ("x1", "x2")),
        ("kldiv_loss", ["X", "Target"], ["Loss"], 0,
         {"reduction": "batchmean"}, ("x",)),
        ("modified_huber_loss", ["X", "Y"], ["Out", "IntermediateVal"], 0,
         {}, ("x",)),
    ]
    for op_type, slots, outs, main, attrs, grads in specs:
        add(op_type, feed_of[op_type], op(op_type, slots, outs, main, attrs),
            grads)
    return cases


def run_sweep(np, fluid, cases, label, tol=SWEEP_TOL, relative=False):
    """Each case's program run on a fresh card executor and a fresh CPU
    executor (each running its startup program first, so the random ops
    draw from equal keys), outputs and gradients within ``tol`` (with
    ``relative``, of max(1, the largest |value| of the output)),
    selections and draws equal; a case's optional fifth item names the
    float outputs (by index) that must be equal (quantized values: each
    that differs is counted and reported as a flip). Returns (worst
    error, op types run)."""
    from paddle_tpu_torch import unique_name

    worst, n_ops = 0.0, set()
    for case in cases:
        name, feed, build, grads = case[:4]
        exact = case[4] if len(case) > 4 else ()
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = SSD_SEED
        with unique_name.guard({}), fluid.program_guard(main, startup):
            outs = build()
            fetch = list(outs)
            if grads:
                # the gradient of the first output's sum
                blk = main.global_block()
                fetch += fluid.backward.calc_gradient(
                    fluid.layers.reduce_sum(outs[0]),
                    [blk.var(g) for g in grads])
        n_ops.update(op.type for op in main.global_block().ops)
        res = {}
        for dev, ex in (("card", fluid.Executor()),
                        ("cpu", fluid.Executor(fluid.CPUPlace()))):
            ex.run(startup)
            res[dev] = [np.asarray(v) for v in ex.run(main, feed=feed,
                                                      fetch_list=fetch)]
        err = 0.0
        for i, (a, b) in enumerate(zip(res["card"], res["cpu"])):
            if a.shape != b.shape or a.dtype != b.dtype:
                fail("sweep %s: card %s %s against cpu %s %s"
                     % (name, a.shape, a.dtype, b.shape, b.dtype))
            if i in exact:
                flips = int((a != b).sum())
                if flips:
                    fail("sweep %s: %d of %d quantized values flip between "
                         "card and CPU (output %d)" % (name, flips, a.size,
                                                       i))
            if a.dtype.kind == "f":
                # equal infinities (spp's windows wholly in its padding)
                # agree
                with np.errstate(invalid="ignore"):
                    e = float(np.where(a == b, 0.0, np.abs(
                        a.astype("float64") - b)).max()) if a.size else 0.0
                if relative and a.size:
                    e /= max(1.0, float(np.abs(b[np.isfinite(b)]).max(
                        initial=0.0)))
                if not e <= tol:
                    fail("sweep %s: card and CPU differ by %.3e (output %d "
                         "of %d, the gradients last)"
                         % (name, e, i, len(res["card"])))
                err = max(err, e)
            elif not np.array_equal(a, b):
                fail("sweep %s: the card's selection differs from the CPU's"
                     % name)
        worst = max(worst, err)
        print("%s %-38s %d outputs%s: card against cpu max %s diff "
              "%.2e (tol %.0e), selections equal%s"
              % (label, name, len(outs), " + %d gradients" % len(grads)
                 if grads else "", "relative" if relative else "abs", err,
                 tol, ", %d quantized outputs equal (0 flips)" % len(exact)
                 if exact else ""))
    return worst, n_ops


def detection_sweep_phase(np, torch, fluid):
    """Every new op type (17 detection, 12 loss) on the card against the
    CPU (module docstring, step 18), through ``run_sweep``."""
    from paddle_tpu_torch.core import op_registry

    worst, n_ops = run_sweep(np, fluid, sweep_cases(np, fluid), "sweep")
    det_types = {t for t in op_registry.registered_ops()
                 if op_registry.get_op_def(t).lower.__module__
                 == "paddle_tpu_torch.ops.detection_ops"}
    missing = det_types - n_ops
    print("sweep: %d op types run, the detection ops' %d all among them: %s"
          % (len(n_ops), len(det_types), not missing))
    if missing:
        fail("the sweep ran no case of %s" % sorted(missing))
    return worst


# -- sequence labelling and OCR: the role labeller and CRNN-CTC ----------------


def srl_feed(np, batch, seed, min_len=None):
    """The role labeller's batch: ``label_semantic_roles.iob_batch`` at
    the book's dictionaries, lengths SRL_MIN_LEN..SRL_LEN."""
    from paddle_tpu_torch.models import label_semantic_roles as srl

    return srl.iob_batch(np, np.random.RandomState(seed), batch, SRL_LEN,
                         SRL_MIN_LEN if min_len is None else min_len)


def crnn_feed(np, batch, seed):
    from paddle_tpu_torch.models import crnn_ctc

    return crnn_ctc.batch(np, np.random.RandomState(seed), batch, CRNN_IMG,
                          CRNN_CLASSES, CRNN_MAX_LABEL, CRNN_MIN_LABEL)


def rel_err(got, want):
    """max |got - want| over max |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


def crf_cases(np, torch, gen):
    """(name, x, trans, lens) of K3 and K4: the role labeller's emissions
    shape [SRL_BATCH, SRL_LEN, SRL_LABELS] with its batch's lengths, and
    edge rows (lengths 1, 0 and full; K 59 and 5)."""
    lens = torch.from_numpy(srl_feed(np, SRL_BATCH, SRL_SEED)["length"]
                            .reshape(-1)).cuda()

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * s

    K = SRL_LABELS
    return [
        ("srl", rnd(SRL_BATCH, SRL_LEN, K), rnd(K + 2, K, s=0.5), lens),
        ("edge_K59", rnd(5, 7, K), rnd(K + 2, K, s=0.5),
         torch.tensor([7, 1, 0, 3, 7], device="cuda")),
        ("edge_K5", rnd(4, 9, 5, s=3.0), rnd(7, 5), torch.tensor(
            [1, 9, 4, 2], device="cuda")),
    ]


def ctc_cases(np, torch, gen):
    """(name, logits, label, t_len, l_len, blank, norm_by_times) of K5:
    CRNN's logits shape [CRNN_BATCH, 64, 96] with its batch's labels
    (blank 95), and edge rows (blank 0): an empty label, a label that
    needs more frames than its row has, a row of one frame."""
    f = crnn_feed(np, CRNN_BATCH, CRNN_SEED)
    label = torch.from_numpy(f["label"]).cuda()
    l_len = torch.from_numpy(f["label_length"].reshape(-1)).cuda()
    T, V = CRNN_IMG[2] // 8, CRNN_CLASSES + 1
    t_len = torch.full((CRNN_BATCH,), T, device="cuda")
    logits = torch.randn(CRNN_BATCH, T, V, generator=gen, device="cuda") * 2
    edge = (torch.randn(4, 8, 6, generator=gen, device="cuda"),
            torch.tensor([[3, 4, 3], [2, 2, 2], [1, 0, 0], [5, 1, 2]],
                         device="cuda"),
            torch.tensor([8, 4, 1, 8], device="cuda"),
            torch.tensor([0, 3, 1, 3], device="cuda"), 0)
    crnn = (logits, label, t_len, l_len, CRNN_CLASSES)
    return [("crnn", *crnn, True), ("crnn_unnormed", *crnn, False),
            ("edge_norm", *edge, True), ("edge", *edge, False)]


def nlp_kernel_phase(np, torch):
    """K3 (``crf_logz`` forward and backward), K4 (``crf_viterbi``) and K5
    (``ctc_loss``) against their plain versions on the same CUDA tensors
    at the role labeller's and CRNN's shapes and the edge rows; returns
    (worst error of each, timing rows). K3 within CRF_TOL of the largest
    value (alpha, log Z, dEmission, dTransition), K4's paths equal (and
    with tied scores), K5's loss and dLogits within CTC_RTOL |plain| +
    CTC_ATOL."""
    from paddle_tpu_torch.kernels import crf as kcrf
    from paddle_tpu_torch.kernels import ctc as kctc

    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    worst = {"crf_logz": 0.0, "crf_logz_bwd": 0.0, "crf_viterbi": 0.0,
             "ctc_loss": 0.0}
    cases = crf_cases(np, torch, gen)
    for name, x, tr, lens in cases:
        alpha, alpha_n, logz = kcrf._logz_launch(x, tr, lens)
        alpha_p, alpha_np, logz_p = kcrf.crf_logz_plain(x, tr, lens)
        g = torch.randn(x.shape[0], generator=gen, device="cuda")
        dx, dtr = kcrf._logz_bwd_launch(x, tr, lens, alpha_n, g)
        dx_p, dtr_p = kcrf.crf_logz_backward_plain(x, tr, lens, alpha_np, g)
        path = kcrf.crf_viterbi(x, tr, lens)
        path_p = kcrf.crf_viterbi_plain(x, tr, lens)
        ties, zero = torch.round(x), torch.zeros_like(tr)
        tie_eq = torch.equal(kcrf.crf_viterbi(ties, zero, lens),
                             kcrf.crf_viterbi_plain(ties, zero, lens))
        torch.cuda.synchronize()
        fwd = max(rel_err(alpha, alpha_p), rel_err(logz, logz_p),
                  rel_err(alpha_n, alpha_np))
        bwd = max(rel_err(dx, dx_p), rel_err(dtr, dtr_p))
        equal = torch.equal(path, path_p)
        print("kernel crf %-10s x %s, lengths %d..%d: crf_logz alpha / log Z "
              "(and the normalised alpha) rel err %.2e, crf_logz_bwd dEmission / "
              "dTransition rel err "
              "%.2e (tol %.0e); crf_viterbi paths equal %s, with tied scores "
              "%s" % (name, list(x.shape), int(lens.min()), int(lens.max()),
                      fwd, bwd, CRF_TOL, equal, tie_eq))
        if not (fwd <= CRF_TOL and bwd <= CRF_TOL and equal and tie_eq):
            fail("K3 / K4 disagree with their plain versions on %s" % name)
        worst["crf_logz"] = max(worst["crf_logz"], fwd)
        worst["crf_logz_bwd"] = max(worst["crf_logz_bwd"], bwd)
    ctc = ctc_cases(np, torch, gen)
    for name, lg, lab, tl, ll, blank, norm in ctc:
        loss, grad = kctc._launch(lg, lab, tl, ll, blank, norm, True)
        loss_p, grad_p = kctc.ctc_loss_plain(lg, lab, tl, ll, blank, norm)
        torch.cuda.synchronize()
        over = max(float(((a - b).abs() - CTC_RTOL * b.abs()).max())
                   for a, b in ((loss, loss_p), (grad, grad_p)))
        err = float((grad - grad_p).abs().max())
        print("kernel ctc_loss %-13s logits %s, blank %d, norm_by_times %s: "
              "loss %.4g..%.4g; loss and dLogits beyond %.0e |plain| by at "
              "most %.2e (tol %.0e); max |dLogits| err %.2e"
              % (name, list(lg.shape), blank, norm, float(loss_p.min()),
                 float(loss_p.max()), CTC_RTOL, over, CTC_ATOL, err))
        if not over <= CTC_ATOL or not torch.isfinite(loss).all():
            fail("K5 disagrees with its plain version on %s" % name)
        worst["ctc_loss"] = max(worst["ctc_loss"], err)
    return worst, nlp_timing(torch, cases[0], ctc[0])


def nlp_timing(torch, crf_case, ctc_case):
    """K3 (both entries), K4 and K5 timed at the role labeller's and
    CRNN's shapes: kernels from graph replays over copies (inputs well
    inside the L2 cache: warm), plain versions eager; K5 beside
    ``F.ctc_loss(reduction='none')`` forward and backward on the same
    log-probabilities (its kernels' device time from a profiler trace).
    Bounds from the work these inputs need: exponentials and adds as
    FP32 instructions at PEAK_FP32_OPS, or the bytes."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import crf as kcrf
    from paddle_tpu_torch.kernels import ctc as kctc

    _, x, tr, lens = crf_case
    B, T, K = x.shape
    live = float((lens.clamp(1, T) - 1).sum())  # the recursions' steps
    _, alpha_n, _ = kcrf._logz_launch(x, tr, lens)
    g = torch.ones(B, device="cuda")
    shape = ("the role labeller's emissions x [%d,%d,%d], lengths %d..%d "
             "(%d steps)" % (B, T, K, int(lens.min()), int(lens.max()),
                             live))
    rows = {}
    rows["crf_logz"] = dict(
        shape=shape,
        ms=cuda_ms(lambda x: kcrf._logz_launch(x, tr, lens),
                   copies(dict(x=x))),
        plain_ms=eager_ms(lambda i: kcrf.crf_logz_plain(x, tr, lens), [0],
                          iters=3),
        library_ms=None,
        bound=bound(4.0 * (3 * B * T * K + (K + 2) * K + 3 * B),
                    12.0 * live * K * K, PEAK_FP32_OPS))
    rows["crf_logz_bwd"] = dict(
        shape=shape,
        ms=cuda_ms(lambda x: kcrf._logz_bwd_launch(x, tr, lens, alpha_n, g),
                   copies(dict(x=x))),
        plain_ms=eager_ms(lambda i: kcrf.crf_logz_backward_plain(
            x, tr, lens, alpha_n, g), [0], iters=3),
        library_ms=None,
        bound=bound(4.0 * (3 * B * T * K + 2 * (K + 2) * K + 3 * B),
                    18.0 * live * K * K, PEAK_FP32_OPS))
    rows["crf_viterbi"] = dict(
        shape=shape,
        ms=cuda_ms(lambda x: kcrf.crf_viterbi(x, tr, lens),
                   copies(dict(x=x))),
        plain_ms=eager_ms(lambda i: kcrf.crf_viterbi_plain(x, tr, lens), [0],
                          iters=3),
        library_ms=None,
        bound=bound(4.0 * (B * T * K + (K + 2) * K + B) + 8.0 * B * T,
                    2.0 * live * K * K, PEAK_FP32_OPS))
    _, lg, lab, tl, ll, blank, norm = ctc_case
    Bc, Tc, V = lg.shape
    states = float(((2 * ll + 1) * (tl.clamp(max=Tc) - 1)).sum())
    lp_in = torch.log_softmax(lg, 2).transpose(0, 1).detach()

    def library(i):
        lp = lp_in.clone().requires_grad_(True)
        loss = F.ctc_loss(lp, lab, tl, ll, blank=blank, reduction="none")
        loss.backward(torch.ones_like(loss))

    rows["ctc_loss"] = dict(
        shape="CRNN's logits [%d,%d,%d], labels of %d..%d, blank %d, "
        "norm_by_times; loss and dLogits" % (Bc, Tc, V, int(ll.min()),
                                             int(ll.max()), blank),
        ms=cuda_ms(lambda lg: kctc._launch(lg, lab, tl, ll, blank, norm,
                                           True), copies(dict(lg=lg))),
        plain_ms=eager_ms(lambda i: kctc.ctc_loss_plain(
            lg, lab, tl, ll, blank, norm), [0], iters=3),
        library_ms=device_ms(torch, library, [0]),
        bound=bound(4.0 * (2 * Bc * Tc * V + Bc * lab.shape[1] + 3 * Bc),
                    32.0 * states + 7.0 * Bc * Tc * V, PEAK_FP32_OPS))
    for name, r in rows.items():
        lib = ("%.4f ms (F.ctc_loss, reduction='none', forward and backward "
               "on the log-probabilities; its kernels' device time)"
               % r["library_ms"] if r["library_ms"] is not None else "none")
        print("time %-20s %s: kernel %.4f ms, plain %.4f ms, library %s, "
              "bound %.4f ms (%s)" % (name, r["shape"], r["ms"], r["plain_ms"],
                                      lib, r["bound"][0], r["bound"][1]))
    return rows


def nlp_rnn_timing(np, torch):
    """B6 and B7 timed at this slice's shapes: the role labeller's LSTM
    (xw [32, 80, 512], D 128, peepholes, sigmoid cell, relu candidate,
    its batch's lengths) and CRNN's GRU (xw [32, 64, 600], D 200, relu
    candidate, full lengths); bounds as rnn_timing_phase's."""
    from paddle_tpu_torch.kernels import gru_cell as gc
    from paddle_tpu_torch.kernels import lstm_cell as lc

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    lens = torch.from_numpy(srl_feed(np, SRL_BATCH, SRL_SEED)["length"]
                            .reshape(-1)).cuda()
    B, T, D = SRL_BATCH, SRL_LEN, SRL_HIDDEN // 4
    V = float(lens.sum())
    kw = copies(lstm_case(torch, gen, B, T, D, lens=lens,
                          acts=("sigmoid", "sigmoid", "relu")))
    rows = {"lstm_cell_srl": dict(
        shape="the role labeller: xw [%d,%d,%d], D %d, peepholes, sigmoid "
        "cell, relu candidate, lengths %d..%d (%d of %d steps valid)"
        % (B, T, 4 * D, D, int(lens.min()), int(lens.max()), V, B * T),
        ms=cuda_ms(lc.lstm_cell_forward, kw),
        plain_ms=cuda_ms(lc.lstm_reference, kw, iters=6, reps=3),
        library_ms=None,
        bound=bound(4.0 * (V * 4 * D + 2 * B * T * D + 4 * D * D + 7 * D
                           + B * T), 8.0 * V * D * D))}
    B, T, D = CRNN_BATCH, CRNN_IMG[2] // 8, CRNN_RNN
    kw = copies(gru_case(torch, gen, B, T, D, acts=("sigmoid", "relu")))
    rows["gru_cell_crnn"] = dict(
        shape="CRNN: xw [%d,%d,%d], D %d, relu candidate, full lengths"
        % (B, T, 3 * D, D),
        ms=cuda_ms(gc.gru_cell_forward, kw),
        plain_ms=cuda_ms(gc.gru_reference, kw, iters=6, reps=3),
        library_ms=None,
        bound=bound(4.0 * (B * T * 3 * D + B * T * D + 3 * D * D + 3 * D),
                    6.0 * B * T * D * D))
    for name, r in rows.items():
        print("time %-20s %s: kernel %.4f ms, plain %.4f ms, library none, "
              "bound %.4f ms (%s)" % (name, r["shape"], r["ms"], r["plain_ms"],
                                      r["bound"][0], r["bound"][1]))
    return rows


def srl_program(fluid, depth=None):
    """The role labeller's train program (SGD on exponential_decay) and
    its test clone, taken before the optimizer: (main, startup, test,
    avg_cost, extras)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import label_semantic_roles as srl

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SRL_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        avg_cost, _, extras = srl.build(fluid, max_len=SRL_LEN,
                                        hidden_dim=SRL_HIDDEN,
                                        depth=depth or SRL_DEPTH)
        test = main.clone(for_test=True)
        lr = fluid.layers.exponential_decay(*SRL_LR, staircase=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return main, startup, test, avg_cost, extras


def crnn_program(fluid, batch=None, channels=None):
    """CRNN-CTC's train program (Momentum with L2 decay) and its test
    clone: (main, startup, test, sum_cost, extras)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import crnn_ctc

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = CRNN_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        sum_cost, extras = crnn_ctc.build(
            fluid, batch_size=batch or CRNN_BATCH, img_shape=CRNN_IMG,
            num_classes=CRNN_CLASSES, max_label=CRNN_MAX_LABEL,
            channels=channels or CRNN_CHANNELS, rnn_hidden=CRNN_RNN)
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(
            learning_rate=CRNN_LR, momentum=CRNN_MOMENTUM,
            regularization=fluid.regularizer.L2Decay(CRNN_L2)).minimize(
                sum_cost)
    return main, startup, test, sum_cost, extras


def nlp_train(np, torch, fluid, kernels, label, main, startup, loss, feed,
              per_step, items, warmup=NLP_WARMUP, steps=NLP_STEPS):
    """``warmup`` + ``steps`` steps of ``main`` on a fresh executor, the
    kernels' counts reset just before and read after the timed steps
    (``per_step``'s kernels gated > 0), one profiled step; prints and
    returns the step numbers."""
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    losses = []
    for _ in range(warmup):
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.reset()
    step_ms = []
    gc.collect()
    gc.freeze()
    for _ in range(steps):
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    gc.unfreeze()
    counts = kernel_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reran = exe.grad_op_reruns
    prof = profile_call(torch, label + " step", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope), top=6)
    mean_ms = float(np.mean(step_ms))
    busy = (float("nan") if prof is None
            else 100.0 * prof["busy_ms"] / prof["wall_ms"])
    late = float(np.mean(losses[-5:]))
    launches = {k: counts[k] for k in per_step}
    print("%s: %d ops, %d timed steps, mean %.1f ms/step (min %.1f, max "
          "%.1f): %.1f %s/s; peak memory %.2f GiB; card busy %.1f %% of a "
          "profiled step, %s launches a step; %s; loss step 1 %.6f, mean of "
          "the last 5 %.6f; grad-op reruns %d"
          % (label, len(main.global_block().ops), steps, mean_ms,
             min(step_ms), max(step_ms), items / mean_ms * 1e3,
             NLP_UNITS[label], peak, busy,
             "?" if prof is None else prof["launches"],
             ", ".join("%s %d (%.1f a step)" % (k, n, n / steps)
                       for k, n in launches.items()), losses[0], late, reran))
    print("%s: losses %s" % (label, ["%.4f" % v for v in losses]))
    if not np.isfinite(losses).all():
        fail("a %s loss is not finite: %s" % (label, losses))
    if not late < losses[0]:
        fail("the %s loss did not fall: %s" % (label, losses))
    if reran:
        fail("%d grad ops reran their forward in the %s steps"
             % (reran, label))
    missing = [k for k, n in launches.items() if not n]
    if missing:
        fail("the %s steps launched no %s" % (label, missing))
    return dict(scope=scope, step_ms=mean_ms, rate=items / mean_ms * 1e3,
                peak=peak, busy=busy, launches=launches, losses=losses,
                min_ms=min(step_ms), max_ms=max(step_ms),
                step_launches=None if prof is None else prof["launches"],
                kernel_launches=counts,
                kernel_ms={} if prof is None else prof["kernel_ms"])


def lstm_backward_share(torch, step_ms, n_layers):
    """The share of a role-labeller step that B6's backward takes: it
    recomputes through the plain loop under autograd (ROADMAP B item
    11). Host clock around the forward and the backward of one layer at
    its shape (full lengths), times the layers, against the step."""
    from paddle_tpu_torch.kernels import lstm_cell as lc

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    kw = lstm_case(torch, gen, SRL_BATCH, SRL_LEN, SRL_HIDDEN // 4,
                   acts=("sigmoid", "sigmoid", "relu"))
    xw = kw["xw"].requires_grad_(True)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hid, _ = lc.fused_lstm(xw, kw["w_h"], kw["bias"],
                               peephole=tuple(kw["peephole"]),
                               gate_act="sigmoid", cell_act="sigmoid",
                               cand_act="relu")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(hid.sum(), [xw])
        torch.cuda.synchronize()
        times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    fwd, bwd = (min(t[i] for t in times) for i in (0, 1))
    print("srl: one LSTM layer [%d,%d,%d] alone: forward (B6) %.2f ms, "
          "backward (the plain loop's recompute) %.2f ms; %d layers' "
          "backward %.1f ms, %.1f %% of the %.1f ms step"
          % (SRL_BATCH, SRL_LEN, SRL_HIDDEN, fwd, bwd, n_layers,
             n_layers * bwd, 100.0 * n_layers * bwd / step_ms, step_ms))
    return n_layers * bwd / step_ms


def srl_phase(np, torch, fluid, kernels):
    """The role labeller at the book's widths (module docstring, step
    19): 3 + 10 SGD steps on one batch, then decoding and chunk_eval on
    the test clone. Returns the step numbers and the launches (the
    decode's Viterbi launch included)."""
    main, startup, test, loss, extras = srl_program(fluid)
    feed = srl_feed(np, SRL_BATCH, SRL_SEED)
    run = nlp_train(np, torch, fluid, kernels, "srl", main, startup, loss,
                    feed, ("lstm_cell", "crf_logz", "crf_logz_bwd",
                           "crf_viterbi"), SRL_BATCH)
    run["lstm_backward_share"] = lstm_backward_share(torch, run["step_ms"],
                                                     SRL_DEPTH)
    pre = kernel_counts(kernels)
    t0 = time.perf_counter()
    path, p, r, f1, n_inf, n_lab, n_cor = (np.asarray(v) for v in
                                           fluid.Executor().run(
        test, feed=feed, scope=run["scope"],
        fetch_list=[extras["decode"]] + list(extras["chunk"])))
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    vit = kernel_counts(kernels)["crf_viterbi"] - pre["crf_viterbi"]
    p, r, f1 = (float(v.reshape(-1)[0]) for v in (p, r, f1))
    print("srl decode (test clone): %.1f ms; path %s; chunk_eval precision "
          "%.4f recall %.4f F1 %.4f (%d inferred, %d labelled, %d correct "
          "chunks); crf_viterbi launches %d"
          % (eval_ms, list(path.shape), p, r, f1, int(n_inf[0]),
             int(n_lab[0]), int(n_cor[0]), vit))
    if not all(0.0 <= v <= 1.0 for v in (p, r, f1)) or not vit:
        fail("the role labeller's decode: P %s R %s F1 %s, %d Viterbi "
             "launches" % (p, r, f1, vit))
    live = np.arange(SRL_LEN)[None, :] < feed["length"]
    if (path[~live] != 0).any() or not ((path >= 0)
                                        & (path < SRL_LABELS)).all():
        fail("the role labeller's Viterbi path leaves 0..%d or is not 0 "
             "past a length" % (SRL_LABELS - 1))
    run["launches"]["crf_viterbi"] += vit
    run.update(f1=f1, eval_ms=eval_ms)
    return run


def crnn_phase(np, torch, fluid, kernels):
    """CRNN-CTC at 48 x 512, 95 classes (module docstring, step 19):
    3 + 10 Momentum steps on one batch, then greedy decoding and the
    edit distance on the test clone."""
    main, startup, test, loss, extras = crnn_program(fluid)
    feed = crnn_feed(np, CRNN_BATCH, CRNN_SEED)
    run = nlp_train(np, torch, fluid, kernels, "crnn", main, startup, loss,
                    feed, ("gru_cell", "ctc_loss"), CRNN_BATCH)
    t0 = time.perf_counter()
    dec, dec_len, dist = (np.asarray(v) for v in fluid.Executor().run(
        test, feed=feed, scope=run["scope"],
        fetch_list=[extras["decoded"], extras["decoded_len"],
                    extras["edit_distance"]]))
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    dist = float(dist.reshape(-1)[0])
    print("crnn decode (test clone): %.1f ms; greedy paths %s, lengths "
          "%d..%d; summed edit distance %.0f over %d label characters"
          % (eval_ms, list(dec.shape), int(dec_len.min()),
             int(dec_len.max()), dist, int(feed["label_length"].sum())))
    if not (np.isfinite(dist) and dist >= 0 and ((dec >= 0)
                                                 & (dec <= CRNN_CLASSES))
            .all()):
        fail("CRNN's decode: edit distance %s, classes %d..%d"
             % (dist, int(dec.min()), int(dec.max())))
    run.update(edit_distance=dist, eval_ms=eval_ms)
    return run


def nlp_card_vs_cpu_phase(np, torch, fluid):
    """Each model at 2 layers / 2 conv groups and a small batch, the port
    on the card against the port on the CPU from the same state:
    NLP_CVC_STEPS losses within NLP_CVC_TOL of max(1, |loss|); then the
    decode ops fed the card's own emissions and transitions, or logits,
    on both sides: Viterbi paths, chunk counts, greedy paths and edit
    distances equal."""
    L = fluid.layers
    last = {}
    for label in ("srl", "crnn"):
        if label == "srl":
            main, startup, _, loss, extras = srl_program(fluid, depth=2)
            feed = srl_feed(np, NLP_CVC_BATCH, SRL_SEED + 1)
            out = extras["feature"]
        else:
            main, startup, _, loss, extras = crnn_program(
                fluid, batch=NLP_CVC_BATCH, channels=CRNN_CHANNELS[:2])
            feed = crnn_feed(np, NLP_CVC_BATCH, CRNN_SEED + 1)
            out = extras["logits"]
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        cpu_scope = cpu_copy(np, fluid, main, scope)
        got = {"card": [], "cpu": []}
        for dev, ex, sc in (("card", exe, scope), ("cpu", fluid.Executor(
                fluid.CPUPlace()), cpu_scope)):
            for _ in range(NLP_CVC_STEPS):
                vals = ex.run(main, feed=feed, fetch_list=[loss, out],
                              scope=sc)
                got[dev].append((float(np.asarray(vals[0]).reshape(-1)[0]),
                                 np.asarray(vals[1])))
        err = max(abs(a[0] - b[0]) / max(1.0, abs(b[0]))
                  for a, b in zip(got["card"], got["cpu"]))
        last[label] = (got["card"][-1][1], scope)
        print("nlp card vs cpu %s: %d steps, losses card %s cpu %s, max "
              "diff %.2e of max(1, |loss|) (tol %.0e)"
              % (label, NLP_CVC_STEPS, ["%.6f" % v[0] for v in got["card"]],
                 ["%.6f" % v[0] for v in got["cpu"]], err, NLP_CVC_TOL))
        if not err <= NLP_CVC_TOL:
            fail("%s: card and CPU losses differ by %.2e" % (label, err))
    em = last["srl"][0]
    trans = last["srl"][1].get_value("crfw").cpu().numpy()
    lg = last["crnn"][0]
    f = srl_feed(np, NLP_CVC_BATCH, SRL_SEED + 1)
    fc = crnn_feed(np, NLP_CVC_BATCH, CRNN_SEED + 1)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ev = L.data("em", list(em.shape[1:]))
        tv = L.data("trans", list(trans.shape), append_batch_size=False)
        lab = L.data("target", [SRL_LEN], dtype="int64")
        ln = L.data("length", [1], dtype="int64")
        blk = main.global_block()
        path = blk.create_var(name="path", dtype="int64")
        blk.append_op(type="crf_decoding",
                      inputs={"Emission": [ev.name], "Transition": [tv.name],
                              "Length": [ln.name]},
                      outputs={"ViterbiPath": [path.name]})
        chunks = L.chunk_eval(path, lab, "IOB", (SRL_LABELS - 1) // 2,
                              length=ln)
        lv = L.data("logits", list(lg.shape[1:]))
        cl = L.data("label", [CRNN_MAX_LABEL], dtype="int64")
        cll = L.data("label_length", [1], dtype="int64")
        dec, dec_len = L.ctc_greedy_decoder(lv, blank=CRNN_CLASSES)
        dist, _ = L.edit_distance(dec, cl, normalized=False,
                                  input_length=dec_len, label_length=cll)
    feed = {"em": em, "trans": trans, "target": f["target"],
            "length": f["length"], "logits": lg,
            "label": fc["label"].astype("int64"),
            "label_length": fc["label_length"]}
    fetch = [path, dec, dec_len, dist] + list(chunks[3:])
    res = {dev: [np.asarray(v) for v in ex.run(main, feed=feed,
                                               fetch_list=fetch)]
           for dev, ex in (("card", fluid.Executor()),
                           ("cpu", fluid.Executor(fluid.CPUPlace())))}
    same = all(np.array_equal(a, b) for a, b in zip(res["card"],
                                                     res["cpu"]))
    print("nlp card vs cpu decode: crf_decoding on the card's emissions %s "
          "and chunk_eval, ctc_greedy_decoder and edit_distance on its "
          "logits %s: card and CPU equal %s (edit distances %s, %d correct "
          "chunks)" % (list(em.shape), list(lg.shape), same,
                       res["card"][3].reshape(-1).tolist(),
                       int(res["card"][-1].reshape(-1)[0])))
    if not same:
        fail("the decoders differ between card and CPU on equal inputs")


def sweep_raw(fluid, op_type, ins, outs, attrs):
    """One op of ``op_type`` appended to the default program: ``ins``
    slot -> variable (or a list of them), ``outs`` the output slots; the
    output variables in that order."""
    from paddle_tpu_torch import unique_name

    blk = fluid.default_main_program().global_block()
    out_vars = [blk.create_var(name=unique_name.generate("out_" + o.lower()))
                for o in outs]
    blk.append_op(type=op_type,
                  inputs={k: [x.name for x in (v if isinstance(v, list)
                                               else [v])]
                          for k, v in ins.items()},
                  outputs={o: [v.name] for o, v in zip(outs, out_vars)},
                  attrs=attrs)
    return out_vars


def sweep_case_adder(np, fluid, cases):
    """``add(name, feed, build, grads, exact)``: a case whose data
    variables are made from ``feed``'s arrays (those named in ``grads``
    take a gradient)."""
    L = fluid.layers

    def add(name, feed, build, grads=(), exact=()):
        def run():
            v = {k: L.data(k, list(a.shape[1:]), dtype=str(a.dtype),
                           stop_gradient=k not in grads)
                 for k, a in feed.items()}
            return build(v)
        cases.append((name, feed, run, grads, exact))

    return add


def nlp_sweep_cases(np, fluid):
    """(name, feed, build() -> fetch vars, grad input names) for each of
    the 22 op types this slice adds, at tests/test_torch_nlp.py's,
    tests/test_torch_metric_ops.py's and tests/test_torch_nn_rest.py's
    shapes."""
    L = fluid.layers
    rng = np.random.RandomState(CRNN_SEED)
    cases = []
    add = sweep_case_adder(np, fluid, cases)

    def f32(*shape):
        return rng.randn(*shape).astype("float32")

    def raw(op_type, ins, outs, attrs):
        return sweep_raw(fluid, op_type, ins, outs, attrs)

    def crf_ops(v):
        attr = fluid.ParamAttr(name="crfw")
        cost = L.linear_chain_crf(v["em"], v["lab"], length=v["ln"],
                                  param_attr=attr)
        return [cost, L.crf_decoding(v["em"], attr, length=v["ln"]),
                L.crf_decoding(v["em"], attr, label=v["lab"],
                               length=v["ln"])]

    add("linear_chain_crf + crf_decoding",
        {"em": f32(4, 6, 5), "lab": rng.randint(0, 5, (4, 6)).astype("int64"),
         "ln": np.array([[6], [1], [4], [3]], "int64")}, crf_ops, ("em",))
    ctc = {"lg": f32(4, 8, 6),
           "lb": np.array([[3, 4, 3], [2, 2, 2], [1, 0, 0], [5, 1, 2]],
                          "int64"),
           "tl": np.array([[8], [4], [1], [8]], "int64"),
           "ll": np.array([[0], [3], [1], [3]], "int64")}
    add("warpctc (norm_by_times)", ctc, lambda v: [L.warpctc(
        v["lg"], v["lb"], blank=0, norm_by_times=True, input_length=v["tl"],
        label_length=v["ll"])], ("lg",))

    def greedy(v):
        out, n = L.ctc_greedy_decoder(v["lg"], blank=0)
        return [out, n] + list(L.edit_distance(
            out, v["lb"], normalized=True, input_length=n,
            label_length=v["ll"]))

    add("ctc_align + edit_distance", ctc, greedy)
    tags = rng.randint(0, 7, (4, 9)).astype("int64")
    add("chunk_eval (IOB, type 1 excluded)",
        {"inf": np.where(rng.rand(4, 9) < 0.7, tags, rng.randint(
            0, 7, (4, 9))).astype("int64"), "lab": tags,
         "ln": np.array([9, 0, 4, 7], "int64")},
        lambda v: list(L.chunk_eval(v["inf"], v["lab"], "IOB", 3, [1],
                                    length=v["ln"])))
    probs = rng.rand(12, 3).astype("float32")
    probs /= probs.sum(1, keepdims=True)
    labels = rng.randint(0, 3, (12, 1)).astype("int64")
    add("auc", {"p": probs[:, :2] / probs[:, :2].sum(1, keepdims=True),
                "l": (labels > 0).astype("int64")},
        lambda v: [L.auc(v["p"], v["l"], num_thresholds=50)[0]])
    add("precision_recall", {"p": probs, "l": labels},
        lambda v: list(L.precision_recall(v["p"], v["l"], 3)))
    add("mean_iou", {"p": rng.randint(0, 4, (6, 5)).astype("int32"),
                     "l": rng.randint(0, 4, (6, 5)).astype("int32")},
        lambda v: list(L.mean_iou(v["p"], v["l"], 4)))
    add("positive_negative_pair",
        {"s": np.round(f32(10, 2), 1), "l": rng.randint(0, 3, (10, 1))
         .astype("float32"), "q": rng.randint(0, 3, (10, 1)).astype(
             "int64")},
        lambda v: raw("positive_negative_pair", {
            "Score": v["s"], "Label": v["l"], "QueryID": v["q"]},
            ["PositivePair", "NegativePair", "NeutralPair"], {"column": 1}))

    def nce(v):
        cost = L.nce(v["x"], v["l"], num_total_classes=20, num_neg_samples=6)
        blk = fluid.default_main_program().global_block()
        return [cost, blk.var(blk.ops[-1].output("SampleLabels")[0])]

    add("nce (threefry draws)", {"x": f32(5, 8), "l": rng.randint(
        0, 20, (5, 1)).astype("int64")}, nce, ("x",))
    add("hierarchical_sigmoid", {"x": f32(5, 8), "l": rng.randint(
        0, 7, (5, 1)).astype("int64")},
        lambda v: [L.hsigmoid(v["x"], v["l"], 7)], ("x",))
    img, vol = f32(2, 3, 9, 10), f32(2, 3, 5, 6, 7)
    add("im2sequence", {"x": img}, lambda v: [L.im2sequence(
        v["x"], filter_size=[3, 2], stride=[2, 1], padding=[1, 0, 1, 1])],
        ("x",))
    add("depthwise_conv2d", {"x": img}, lambda v: [L.depthwise_conv2d(
        v["x"], 6, 3, stride=2, padding=1)], ("x",))
    add("depthwise_conv2d_transpose", {"x": img, "w": f32(3, 2, 3, 3)},
        lambda v: raw("depthwise_conv2d_transpose",
                      {"Input": v["x"], "Filter": v["w"]}, ["Output"],
                      {"strides": [2, 2], "paddings": [1, 1]}), ("x", "w"))
    add("conv3d", {"x": vol}, lambda v: [L.conv3d(
        v["x"], 4, 3, padding=1, stride=[1, 2, 1])], ("x",))
    add("conv2d_transpose (output_size)", {"x": img},
        lambda v: [L.conv2d_transpose(v["x"], 4, output_size=[18, 20],
                                      filter_size=3, padding=1, stride=2)],
        ("x",))
    add("conv3d_transpose", {"x": vol}, lambda v: [L.conv3d_transpose(
        v["x"], 2, filter_size=3, stride=2, padding=1)], ("x",))
    add("pool3d (max ceil, avg exclusive)", {"x": vol},
        lambda v: [L.pool3d(v["x"], 2, "max", 2, ceil_mode=True),
                   L.pool3d(v["x"], 3, "avg", 2, pool_padding=1)], ("x",))
    add("group_norm", {"x": f32(2, 6, 4, 5)},
        lambda v: [L.group_norm(v["x"], 3)], ("x",))
    add("bilinear_interp (up, down)", {"x": img},
        lambda v: [L.image_resize(v["x"], out_shape=[15, 17]),
                   L.resize_bilinear(v["x"], out_shape=[4, 6])], ("x",))
    add("nearest_interp", {"x": img}, lambda v: [L.image_resize(
        v["x"], out_shape=[13, 7], resample="NEAREST")], ("x",))
    return cases


def nlp_sweep_phase(np, fluid):
    """Each of the 22 op types of this slice on the card against the CPU
    (module docstring, step 19), as the detection sweep runs its ops:
    values within SWEEP_TOL (convolutions with TF32 off), selections and
    nce's draws equal."""
    worst, n_ops = run_sweep(np, fluid, nlp_sweep_cases(np, fluid), "nlp")
    missing = set(NLP_OP_TYPES) - n_ops
    print("nlp sweep: %d op types run, this slice's %d all among them: %s"
          % (len(n_ops), len(NLP_OP_TYPES), not missing))
    if missing:
        fail("the nlp sweep ran no case of %s" % sorted(missing))
    return worst


# -- vision, quantization and sequence ops: QAT ResNet-50, the sentiment CNN --


def vision_quant_sweep_cases(np, fluid):
    """The 7 vision and 4 quantize op types at the CPU tests' shapes
    (tests/test_torch_vision_ops.py, tests/test_torch_quantize.py) and
    at one realistic shape each: ResNet-50's stem [128, 64, 112, 112]
    (3 x 3, stride 2) for max_pool2d_with_index and unpool, a spatial
    transformer over [32, 64, 56, 56], SPP-net's conv5 [32, 256, 13, 13]
    (3 levels), a conv input [128, 64, 56, 56] for the fake quantize
    ops, and layer4's [512, 512, 3, 3] int8 weight."""
    L = fluid.layers
    rng = np.random.RandomState(QUANT_SEED)
    cases = []
    add = sweep_case_adder(np, fluid, cases)

    def f32(*shape):
        return rng.randn(*shape).astype("float32")

    def tied(*shape):
        # relu'd halves: most windows hold tied maxima
        return np.maximum(np.round(f32(*shape) * 2) / 2, 0).astype(
            "float32")

    eye = np.tile(np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], "float32"),
                  (32, 1, 1))
    add("affine_channel (NCHW, NHWC)", {"x": f32(2, 3, 4, 5),
                                        "y": f32(2, 4, 5, 3)},
        lambda v: [L.affine_channel(v["x"]),
                   L.affine_channel(v["y"], data_layout="NHWC")], ("x",))
    add("affine_channel [32,256,56,56]", {"x": f32(32, 256, 56, 56)},
        lambda v: [L.affine_channel(v["x"])], ("x",))

    def transformer(shape):
        def build(v):
            grid = L.affine_grid(v["theta"], out_shape=shape)
            return [L.grid_sampler(v["x"], grid), grid]
        return build

    add("affine_grid + grid_sampler (identity)",
        {"x": f32(2, 3, 5, 6), "theta": eye[:2]},
        transformer([2, 3, 5, 6]), ("theta", "x"))
    # at the realistic shape each op alone: composed, the sampler
    # multiplies affine_grid's rounding (a float32 product, summed in
    # another order on the card) by the image's slope times (W - 1) / 2
    # (``transformer_composed`` reports it)
    theta = (eye + 0.1 * f32(32, 2, 3)).astype("float32")
    add("affine_grid [32,2,3] -> [32,56,56,2]", {"theta": theta},
        lambda v: [L.affine_grid(v["theta"], out_shape=[32, 64, 56, 56])],
        ("theta",))
    add("grid_sampler [32,64,56,56]",
        {"x": f32(32, 64, 56, 56), "grid": np.einsum(
            "hwc,nkc->nhwk", np.stack(list(np.meshgrid(
                np.linspace(-1, 1, 56), np.linspace(-1, 1, 56)))
                + [np.ones((56, 56))], axis=-1), theta).astype("float32")},
        lambda v: [L.grid_sampler(v["x"], v["grid"])], ("x", "grid"))

    def pool(k, s, p, nd=2, unpool=False):
        def build(v):
            out, mask = sweep_raw(
                fluid, "max_pool%dd_with_index" % nd, {"X": v["x"]},
                ["Out", "Mask"], {"ksize": k, "strides": s, "paddings": p})
            if not unpool:
                return [out, mask]
            (up,) = sweep_raw(fluid, "unpool", {"X": out, "Indices": mask},
                              ["Out"], {"ksize": k, "strides": s,
                                        "paddings": p})
            return [up, out, mask]
        return build

    add("max_pool2d_with_index", {"x": f32(2, 3, 6, 8)},
        pool([2, 3], [2, 2], [1, 1]), ("x",))
    add("max_pool2d_with_index (tied)", {"x": tied(2, 3, 7, 7)},
        pool([3, 3], [2, 2], [1, 1]), ("x",))
    add("max_pool3d_with_index (tied)", {"x": tied(1, 2, 5, 4, 5)},
        pool([3, 2, 3], [2, 2, 2], [1, 0, 1], nd=3), ("x",))
    add("unpool (overlapping windows)", {"x": tied(2, 3, 7, 7)},
        pool([3, 3], [2, 2], [1, 1], unpool=True), ("x",))
    add("max_pool2d_with_index + unpool [128,64,112,112]",
        {"x": tied(RESNET_BATCH, 64, 112, 112)},
        pool([3, 3], [2, 2], [1, 1], unpool=True), ("x",))

    def spp(height, ptype):
        return lambda v: sweep_raw(fluid, "spp", {"X": v["x"]}, ["Out"],
                                   {"pyramid_height": height,
                                    "pooling_type": ptype})

    add("spp (max, tied, 5 x 7)", {"x": tied(2, 2, 5, 7)}, spp(3, "max"),
        ("x",))
    add("spp (avg, exclusive, 5 x 5)", {"x": f32(1, 2, 5, 5)},
        spp(3, "avg"), ("x",))
    add("spp [32,256,13,13] (max)", {"x": tied(32, 256, 13, 13)},
        spp(3, "max"), ("x",))
    add("spp [32,256,13,13] (avg)", {"x": f32(32, 256, 13, 13)},
        spp(3, "avg"), ("x",))

    def quant(v):
        out, scale = L.fake_quantize_abs_max(v["x"])
        q, qs = sweep_raw(fluid, "fake_quantize_range_abs_max",
                          {"X": v["x"], "InScale": v["s"]},
                          ["Out", "OutScale"], {"is_test": False})
        t, _ = sweep_raw(fluid, "fake_quantize_range_abs_max",
                         {"X": v["x"], "InScale": v["s"]},
                         ["Out", "OutScale"], {"is_test": True})
        (dq,) = sweep_raw(fluid, "fake_dequantize_max_abs",
                          {"X": q, "Scale": qs}, ["Out"],
                          {"max_range": 127.0})
        return [out, q, t, dq, scale, qs]

    for shape in ((4, 7), (RESNET_BATCH, 64, 56, 56)):
        x = f32(*shape)
        add("fake quantize / dequantize %s" % list(shape),
            {"x": x, "s": np.asarray([[0.5 * float(np.abs(x).max())]],
                                     "float32")}, quant, ("x",),
            (0, 1, 2))

    def dequant(v):
        return sweep_raw(fluid, "dequantize_weight",
                         {"X": v["w"], "Scale": v["s"]}, ["Out"], {})

    add("dequantize_weight [512,512,3,3]",
        {"w": rng.randint(-128, 128, (512, 512, 3, 3)).astype("int8"),
         "s": np.asarray([[0.0123]], "float32")}, dequant, (), (0,))
    return cases


def transformer_composed(np, fluid):
    """affine_grid into grid_sampler at [32, 64, 56, 56] on the card and
    the CPU, each output's difference relative to max(1, its largest
    |value|) beside the grid's slope factor (W - 1) / 2 (reported: the
    sweep gates each op alone)."""
    L = fluid.layers
    rng = np.random.RandomState(QUANT_SEED + 1)
    eye = np.tile(np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], "float32"),
                  (32, 1, 1))
    feed = {"x": rng.randn(32, 64, 56, 56).astype("float32"),
            "theta": (eye + 0.1 * rng.randn(32, 2, 3)).astype("float32")}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data("x", [64, 56, 56], stop_gradient=False)
        theta = L.data("theta", [2, 3], stop_gradient=False)
        grid = L.affine_grid(theta, out_shape=[32, 64, 56, 56])
        out = L.grid_sampler(x, grid)
        grads = fluid.backward.calc_gradient(L.reduce_sum(out), [theta, x])
    res = {dev: [np.asarray(v) for v in ex.run(
        main, feed=feed, fetch_list=[out, grid] + grads)]
        for dev, ex in (("card", fluid.Executor()),
                        ("cpu", fluid.Executor(fluid.CPUPlace())))}
    print("vision/quant affine_grid + grid_sampler [32,64,56,56] composed "
          "(reported): card against cpu, relative to max(1, |largest|): %s; "
          "the grid's rounding times the slope factor (W - 1) / 2 = 27.5"
          % ", ".join("%s %.2e" % (n, float(
              np.abs(a.astype("float64") - b).max()
              / max(1.0, float(np.abs(b).max()))))
                      for n, a, b in zip(("out", "grid", "dtheta", "dx"),
                                         res["card"], res["cpu"])))


def vision_quant_sweep_phase(np, torch, fluid):
    """Each vision and quantize op type of step 20 on the card against
    the CPU, through ``run_sweep``: values within 1e-5 of the largest
    (TF32 off), masks equal, quantized values equal (a flip fails); then
    the composed spatial transformer, reported."""
    worst, n_ops = run_sweep(np, fluid, vision_quant_sweep_cases(np, fluid),
                             "vision/quant", tol=VQ_SWEEP_TOL, relative=True)
    transformer_composed(np, fluid)
    missing = set(VISION_QUANT_OP_TYPES) - n_ops
    print("vision/quant sweep: %d op types run, this slice's %d all among "
          "them: %s; worst %.2e" % (len(n_ops), len(VISION_QUANT_OP_TYPES),
                                     not missing, worst))
    if missing:
        fail("the vision/quant sweep ran no case of %s" % sorted(missing))
    return worst


def seq_sweep_cases(np, fluid):
    """The 16 sequence op types and the two fused ones at the CPU tests'
    shapes (tests/test_torch_sequence.py) and at the sentiment CNN's:
    [128, 600] ids, lengths 16..600, the embedding's [128, 600, 128] and
    its 3- and 4-wide convolutions to 512."""
    L = fluid.layers
    rng = np.random.RandomState(SENT_SEED + 1)
    cases = []
    add = sweep_case_adder(np, fluid, cases)

    def f32(*shape):
        return rng.randn(*shape).astype("float32")

    def col(*v):
        return np.asarray(v, "int64").reshape(-1, 1)

    B, T, E, H = SENT_BATCH, SENT_LEN, SENT_EMB, SENT_HID
    lens = rng.randint(SENT_MIN_LEN, T + 1, (B, 1)).astype("int64")
    lens[:4] = [[T], [SENT_MIN_LEN], [T], [T // 2]]   # ties, extremes
    add("sequence_softmax, reverse, first / last step",
        {"s": f32(2, 5), "x": f32(2, 5, 3), "l": col(5, 2)},
        lambda v: [L.sequence_softmax(v["s"], length=v["l"]),
                   L.sequence_reverse(v["x"], length=v["l"]),
                   L.sequence_first_step(v["x"], length=v["l"]),
                   L.sequence_last_step(v["x"], length=v["l"])], ("s",))
    add("sequence_softmax [128,600]", {"s": f32(B, T), "l": lens},
        lambda v: [L.sequence_softmax(v["s"], length=v["l"])], ("s",))
    add("sequence_reverse [128,600,128]", {"x": f32(B, T, E), "l": lens},
        lambda v: [L.sequence_reverse(v["x"], length=v["l"])], ("x",))
    add("sequence_conv (3, tanh)", {"x": f32(2, 5, 3), "l": col(5, 3)},
        lambda v: [L.sequence_conv(v["x"], 4, 3, length=v["l"],
                                   act="tanh")], ("x",))
    for width in (3, 4):
        add("sequence_conv + sqrt pool [128,600,128] (%d)" % width,
            {"x": f32(B, T, E), "l": lens},
            lambda v, w=width: [L.sequence_pool(L.sequence_conv(
                v["x"], H, w, length=v["l"], act="tanh"), "sqrt",
                length=v["l"])], ("x",))
    add("sequence_expand, expand_as",
        {"x": f32(3, 2), "y": f32(3, 4, 1), "z": f32(3, 4, 2)},
        lambda v: [L.sequence_expand(v["x"], v["y"]),
                   L.sequence_expand_as(v["x"], v["z"])], ("x",))
    add("sequence_concat", {"x": f32(2, 3, 2), "y": f32(2, 4, 2),
                            "lx": col(2, 1), "ly": col(4, 1)},
        lambda v: [L.sequence_concat([v["x"], v["y"]],
                                     lengths=[v["lx"], v["ly"]])],
        ("x", "y"))
    add("sequence_concat [128,600,128] x 2", {"x": f32(B, T, E),
                                              "y": f32(B, T, E), "lx": lens,
                                              "ly": lens[::-1].copy()},
        lambda v: [L.sequence_concat([v["x"], v["y"]],
                                     lengths=[v["lx"], v["ly"]])],
        ("x", "y"))
    add("sequence_pad, unpad, slice",
        {"x": f32(2, 6, 2), "l": col(3, 6), "o": col(2, 0)},
        lambda v: [L.sequence_pad(v["x"], L.fill_constant(
            [1], "float32", 0.25), maxlen=8, length=v["l"])[0],
            L.sequence_unpad(v["x"], v["l"]),
            L.sequence_slice(v["x"], v["o"], v["l"])], ("x",))
    add("sequence_pad [128,600,128] to 640", {"x": f32(B, T, E), "l": lens},
        lambda v: list(L.sequence_pad(v["x"], L.fill_constant(
            [1], "float32", -1.0), maxlen=640, length=v["l"])), ("x",))
    ids = rng.randint(0, 6, (B, T)).astype("int64")
    add("sequence_erase, enumerate [128,600]", {"ids": ids, "l": lens},
        lambda v: list(L.sequence_erase(v["ids"], tokens=[2, 0],
                                        length=v["l"]))
        + [L.sequence_enumerate(v["ids"], win_size=3, pad_value=-1,
                                length=v["l"])])
    add("sequence_scatter", {"x": f32(4, 9, 3), "i": rng.randint(
        0, 9, (4, 5)).astype("int32"), "u": f32(4, 5, 3)},
        lambda v: [L.sequence_scatter(v["x"], v["i"], v["u"])], ("x", "u"))
    add("sequence_reshape", {"x": f32(4, 6, 8)},
        lambda v: [L.sequence_reshape(v["x"], 4)], ("x",))
    add("lod_reset", {"x": f32(4, 6, 3)},
        lambda v: list(L.lod_reset(v["x"], target_lod=[0, 5, 6, 20, 24])),
        ("x",))

    def rank(v):
        table = L.lod_rank_table(lengths=v["l"])
        return [L.reorder_lod_tensor_by_rank(v["x"], table), table.index,
                table.length]

    add("lod_rank_table + reorder [128]", {"x": f32(B, 40), "l": lens},
        rank, ("x",))

    def fused(v):
        (out,) = sweep_raw(fluid, "fusion_seqconv_eltadd_relu",
                           {"X": v["x"], "Filter": v["w"], "Bias": v["b"],
                            "Length": v["l"]}, ["Out"],
                           {"contextLength": 3, "contextStart": -1})
        return [out]

    add("fusion_seqconv_eltadd_relu [128,600,128]",
        {"x": f32(B, T, E), "w": (0.1 * f32(3 * E, H)).astype("float32"),
         "b": f32(1, H), "l": lens}, fused, ("x", "w"))

    def expand_fc(v):
        return sweep_raw(fluid, "fusion_seqexpand_concat_fc",
                         {"X": [v["x"], v["y"]], "FCWeight": v["w"],
                          "FCBias": v["b"]}, ["Out", "FCOut"],
                         {"fc_activation": "relu"})

    add("fusion_seqexpand_concat_fc", {"x": f32(4, 7, 3), "y": f32(4, 5),
                                       "w": f32(8, 6), "b": f32(1, 6)},
        expand_fc, ("x", "y"))
    return cases


def fused_chain_check(np, fluid):
    """Both fused sequence ops against their unfused chains, on the card:
    fusion_seqconv_eltadd_relu against sequence_conv + elementwise_add +
    relu at the sentiment shape, fusion_seqexpand_concat_fc against
    sequence_expand_as + concat + fc."""
    L = fluid.layers
    rng = np.random.RandomState(SENT_SEED + 2)
    B, T, E, H = SENT_BATCH, SENT_LEN, SENT_EMB, SENT_HID
    feed = {"x": rng.randn(B, T, E).astype("float32"),
            "l": rng.randint(SENT_MIN_LEN, T + 1, (B, 1)).astype("int64"),
            "v": rng.randn(B, 5).astype("float32")}
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SENT_SEED
    with fluid.program_guard(main, startup):
        x = L.data("x", [T, E])
        ln = L.data("l", [1], dtype="int64")
        vec = L.data("v", [5])
        conv = L.sequence_conv(x, H, 3, length=ln,
                               param_attr=fluid.ParamAttr(name="sc_w"),
                               bias_attr=fluid.ParamAttr(name="sc_b"))
        chain = L.relu(conv)
        (fused,) = sweep_raw(fluid, "fusion_seqconv_eltadd_relu",
                             {"X": x, "Filter": main.global_block().var(
                                 "sc_w"), "Bias": main.global_block().var(
                                     "sc_b"), "Length": ln}, ["Out"],
                             {"contextLength": 3, "contextStart": -1})
        cat = L.concat([x, L.sequence_expand_as(vec, x)], axis=2)
        fc = L.fc(cat, 6, num_flatten_dims=2, act="relu",
                  param_attr=fluid.ParamAttr(name="fx_w"),
                  bias_attr=fluid.ParamAttr(name="fx_b"))
        blk = main.global_block()
        out = blk.create_var(name="fx_out")
        fco = blk.create_var(name="fx_fco")
        blk.append_op(type="fusion_seqexpand_concat_fc",
                      inputs={"X": [x.name, vec.name], "FCWeight": ["fx_w"],
                              "FCBias": ["fx_b"]},
                      outputs={"Out": [out.name], "FCOut": [fco.name]},
                      attrs={"fc_activation": "relu"})
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    a, b, c, d = (np.asarray(v) for v in exe.run(
        main, feed=feed, fetch_list=[chain, fused, fc, out], scope=scope))
    e1 = float(np.abs(a - b).max() / max(1.0, np.abs(a).max()))
    e2 = float(np.abs(c - d).max() / max(1.0, np.abs(c).max()))
    print("seq fused against unfused on the card: "
          "fusion_seqconv_eltadd_relu %s %.2e, fusion_seqexpand_concat_fc "
          "%s %.2e (relative, tol %.0e)"
          % (list(b.shape), e1, list(d.shape), e2, VQ_SWEEP_TOL))
    if not (e1 <= VQ_SWEEP_TOL and e2 <= VQ_SWEEP_TOL):
        fail("a fused sequence op differs from its unfused chain")


def seq_sweep_phase(np, torch, fluid):
    """Each sequence op type of step 20 (the fused two included) on the
    card against the CPU, through ``run_sweep``, then the fused ops
    against their chains."""
    worst, n_ops = run_sweep(np, fluid, seq_sweep_cases(np, fluid), "seq",
                             tol=VQ_SWEEP_TOL, relative=True)
    missing = set(SEQ_OP_TYPES) - n_ops
    print("seq sweep: %d op types run, this slice's %d all among them: %s; "
          "worst %.2e" % (len(n_ops), len(SEQ_OP_TYPES), not missing, worst))
    if missing:
        fail("the seq sweep ran no case of %s" % sorted(missing))
    fused_chain_check(np, fluid)
    return worst


def qat_resnet_program(fluid, qat):
    """ResNet's train program as ``resnet_train_program`` builds it, with
    ``qat`` ``QuantizeTranspiler.training_transpile`` before ``minimize``;
    the test clone and a training-mode forward clone taken between:
    (main, startup, test, forward, loss, predict, transpiler or None)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.transpiler import QuantizeTranspiler

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = RESNET_SEED
    qt = (QuantizeTranspiler(activation_quantize_type="range_abs_max")
          if qat else None)
    with unique_name.guard({}), fluid.program_guard(main, startup):
        pixel = fluid.layers.data(name="bench_pixel",
                                  shape=[3, RESNET_IMG, RESNET_IMG],
                                  dtype="float32")
        label = fluid.layers.data(name="bench_label", shape=[1],
                                  dtype="int64")
        predict = resnet.resnet_imagenet(pixel, RESNET_CLASSES,
                                         depth=RESNET_DEPTH)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=predict, label=label))
        if qt is not None:
            qt.training_transpile(main, startup)
        test = main.clone(for_test=True)
        forward = main.clone()
        fluid.optimizer.Momentum(learning_rate=RESNET_LR,
                                 momentum=RESNET_MOMENTUM).minimize(loss)
    return main, startup, test, forward, loss, predict, qt


def dir_bytes(np, path, dtype=None):
    """The bytes of a saved model's ``.npy`` files (those of ``dtype``
    only, when given)."""
    total = 0
    for fn in os.listdir(path):
        if not fn.endswith(".npy"):
            continue
        if dtype is not None and np.load(os.path.join(path, fn),
                                         mmap_mode="r").dtype != dtype:
            continue
        total += os.path.getsize(os.path.join(path, fn))
    return total


def rel_max(np, got, want):
    return float(np.abs(np.asarray(got, "float64") - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def train_mode_freeze(np, fluid, exe, fwd, predict, qt, scope, pfeed):
    """tests/test_quantize_transpiler.py's comparison in training mode
    (batch statistics, as its convnet without batch norm has): the QAT
    forward program and its frozen copy on a card copy of the trained
    state. Reported beside the JAX test's tolerance, not gated: the
    difference is the activations' 8-bit noise at the running scales the
    25 steps left, which the float32 sums' nondeterministic order on the
    card moves from run to run (the freeze itself is held exactly by the
    snapped weights and the int8 outputs)."""
    from paddle_tpu_torch.io import prune_program

    fwd = prune_program(fwd, ["bench_pixel"], [predict.name])
    acts = [(op.input("X")[0], op.input("InScale")[0])
            for op in fwd.global_block().ops
            if op.type == "fake_quantize_range_abs_max"]
    copy = cpu_copy(np, fluid, fwd, scope, device="cuda")
    vals = exe.run(fwd, feed=pfeed, fetch_list=[predict]
                   + [a for a, _ in acts], scope=copy)
    ratio = sorted(float(np.asarray(copy.get_value(sn).cpu()).reshape(-1)[0])
                   / max(float(np.abs(np.asarray(v)).max()), 1e-30)
                   for v, (_, sn) in zip(vals[1:], acts))
    qat = np.asarray(vals[0])
    vals = None
    qt.freeze_program(fwd, scope=copy)
    (frozen,) = exe.run(fwd, feed=pfeed, fetch_list=[predict], scope=copy)
    frozen = np.asarray(frozen)
    diff = float(np.abs(frozen - qat).max())
    top1 = float(np.mean(frozen.argmax(1) == qat.argmax(1)))
    print("resnet qat freeze, training mode (batch statistics, %d images): "
          "the frozen forward program against the QAT one: max abs diff "
          "%.3e (reported; the JAX test's convnet holds %.2f), top-1 "
          "agreement %.3f; the %d activation quantizers' running scales are "
          "%.2f-%.2fx (median %.2fx) this batch's own largest |input|"
          % (RESNET_PRED_BATCH, diff, QAT_FREEZE_TOL, top1, len(acts),
             ratio[0], ratio[-1], ratio[len(ratio) // 2]))
    if not np.isfinite(frozen).all():
        fail("the frozen QAT ResNet-50's training-mode outputs are not "
             "finite")


def qat_resnet_phase(np, torch, fluid, kernels, model_root):
    """ResNet-50 at 128 x 224^2, float32 and then quantization-aware
    (module docstring, step 20), each 3 + 10 Momentum steps on a fresh
    executor; the training-mode forward frozen on a copy of the state
    (its outputs against the QAT forward's reported beside the JAX
    test's 0.15);
    the QAT test clone pruned, frozen (the snapped weights against its
    dequantized ones; its outputs against the QAT test program's
    reported with the share of activations the test-mode quantizers
    clip), converted to int8, saved beside the frozen float32 model and
    served 20 times through a ``Predictor`` (within QAT_PRED_TOL of the
    frozen program). Returns the step numbers of both runs."""
    from paddle_tpu_torch.inference import NativeConfig, \
        create_paddle_predictor
    from paddle_tpu_torch.io import prune_program

    rng = np.random.RandomState(SEED)
    feed = {"bench_pixel": rng.rand(RESNET_BATCH, 3, RESNET_IMG,
                                    RESNET_IMG).astype("float32"),
            "bench_label": rng.randint(0, RESNET_CLASSES,
                                       (RESNET_BATCH, 1)).astype("int64")}
    main, startup, _, _, loss, _, _ = qat_resnet_program(fluid, qat=False)
    n_f32 = len(main.global_block().ops)
    f32 = nlp_train(np, torch, fluid, kernels, "resnet fp32", main, startup,
                    loss, feed, (), RESNET_BATCH)
    f32.pop("scope")
    main = startup = None
    torch.cuda.empty_cache()
    main, startup, test, fwd, loss, predict, qt = qat_resnet_program(
        fluid, qat=True)
    types = [op.type for op in main.global_block().ops]
    pairs = types.count("fake_dequantize_max_abs")
    print("resnet qat: %d ops (%d float32), %d fake quantize / dequantize "
          "pairs (%d range_abs_max on activations, %d abs_max on weights), "
          "Momentum(%g, %g)"
          % (len(types), n_f32, pairs,
             types.count("fake_quantize_range_abs_max"),
             types.count("fake_quantize_abs_max"), RESNET_LR,
             RESNET_MOMENTUM))
    run = nlp_train(np, torch, fluid, kernels, "resnet qat", main, startup,
                    loss, feed, (), RESNET_BATCH)
    fired = {k: n for k, n in run["kernel_launches"].items() if n}
    fq = (None if run["step_launches"] is None or f32["step_launches"] is None
          else run["step_launches"] - f32["step_launches"])
    print("resnet qat: %.1f ms a step (min %.1f, max %.1f), %.1f images/s, "
          "peak %.2f GiB, card busy %.1f %%, %s launches a step, the fake "
          "quantize / dequantize ops' %s a step (its launches less the "
          "float32 step's); float32 beside it in this call: %.1f ms (min "
          "%.1f, max %.1f), %.1f images/s, peak %.2f GiB, busy %.1f %%, %s "
          "launches; the QAT step %.2fx the float32 step; hand-written "
          "kernels launched in the timed steps: %s"
          % (run["step_ms"], run["min_ms"], run["max_ms"], run["rate"],
             run["peak"], run["busy"], run["step_launches"], fq,
             f32["step_ms"], f32["min_ms"], f32["max_ms"], f32["rate"],
             f32["peak"], f32["busy"], f32["step_launches"],
             run["step_ms"] / f32["step_ms"], fired or "none"))
    scope = run["scope"]
    exe = fluid.Executor()
    pfeed = {"bench_pixel": feed["bench_pixel"][:RESNET_PRED_BATCH]}
    train_mode_freeze(np, fluid, exe, fwd, predict, qt, scope, pfeed)
    test = prune_program(test, ["bench_pixel"], [predict.name])
    acts = [(op.input("X")[0], op.input("InScale")[0])
            for op in test.global_block().ops
            if op.type == "fake_quantize_range_abs_max"]
    weights = sorted(n[:-len(".quantized")] for op in test.global_block().ops
                     if op.type == "fake_quantize_abs_max"
                     for n in op.output("Out"))
    vals = exe.run(test, feed=pfeed, fetch_list=[predict]
                   + [n + ".dequantized" for n in weights]
                   + [a for a, _ in acts], scope=scope)
    qat_out = np.asarray(vals[0])
    dequantized = dict(zip(weights, vals[1:1 + len(weights)]))
    clipped = sum(int((np.abs(np.asarray(v)) > float(np.asarray(
        scope.get_value(sn).cpu()).reshape(-1)[0])).sum())
        for v, (_, sn) in zip(vals[1 + len(weights):], acts))
    n_act = sum(np.asarray(v).size for v in vals[1 + len(weights):])
    vals = None
    t0 = time.perf_counter()
    scales = qt.freeze_program(test, scope=scope)
    freeze_ms = (time.perf_counter() - t0) * 1e3
    left = [op.type for op in test.global_block().ops
            if op.type.startswith("fake_")]
    snap = max(rel_max(np, scope.get_value(n).cpu().numpy(), np.asarray(
        dequantized[n])) for n in scales)
    (frozen,) = exe.run(test, feed=pfeed, fetch_list=[predict], scope=scope)
    frozen = np.asarray(frozen)
    diff = float(np.abs(frozen - qat_out).max())
    top1 = float(np.mean(frozen.argmax(1) == qat_out.argmax(1)))
    print("resnet qat freeze: %d weights snapped in %.0f ms, %d fake ops "
          "left; the snapped weights against the QAT program's dequantized "
          "ones %.2e relative (tol %.0e); test mode (moving statistics, %d "
          "images): %.2f %% of the %d activation quantizers' inputs lie "
          "past their running scale (clipped), and the frozen program's "
          "outputs differ from the QAT test program's by %.3e, top-1 "
          "agreement %.3f (reported: the clipping is what freezing removes)"
          % (len(scales), freeze_ms, len(left), snap, QAT_SNAP_TOL,
             RESNET_PRED_BATCH, 100.0 * clipped / max(n_act, 1), len(acts),
             diff, top1))
    if left or len(scales) != len(weights) or not np.isfinite(frozen).all() \
            or not snap <= QAT_SNAP_TOL:
        fail("freezing the QAT ResNet-50: %d scales of %d weights, fake ops "
             "%s, snapped weights %.3e" % (len(scales), len(weights), left,
                                           snap))
    f32_dir = os.path.join(model_root, "resnet50_frozen")
    fluid.io.save_inference_model(f32_dir, ["bench_pixel"], [predict], exe,
                                  main_program=test, scope=scope)
    converted = qt.convert_to_int8(test, scope=scope, scales=scales)
    (int8_out,) = exe.run(test, feed=pfeed, fetch_list=[predict],
                          scope=scope)
    in_session = rel_max(np, int8_out, frozen)
    int8_dir = os.path.join(model_root, "resnet50_int8")
    fluid.io.save_inference_model(int8_dir, ["bench_pixel"], [predict], exe,
                                  main_program=test, scope=scope)
    f32_bytes = dir_bytes(np, f32_dir)
    i8_bytes = dir_bytes(np, int8_dir)
    i8_only = dir_bytes(np, int8_dir, np.int8)
    pred = create_paddle_predictor(NativeConfig(int8_dir))
    outs, ms = [], []
    for _ in range(QAT_PRED_RUNS):
        t0 = time.perf_counter()
        (o,) = pred.run(pfeed)
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(np.asarray(o))
    err = max(rel_max(np, o, frozen) for o in outs)
    n_deq = [op.type for op in pred._program.global_block().ops].count(
        "dequantize_weight")
    print("resnet qat int8: %d weights converted, %d dequantize_weight ops "
          "served; saved weights %d bytes (int8 tensors %d) against the "
          "frozen float32 model's %d: %.3fx; Predictor (NativeConfig, the "
          "card) %d runs of %d images: %.2f ms a run (min %.2f, max %.2f); "
          "int8 outputs against the frozen program's: in session %.2e, "
          "Predictor %.2e relative to the largest (tol %.0e)"
          % (len(converted), n_deq, i8_bytes, i8_only, f32_bytes,
             i8_bytes / float(f32_bytes), QAT_PRED_RUNS, RESNET_PRED_BATCH,
             float(np.mean(ms)), min(ms), max(ms), in_session, err,
             QAT_PRED_TOL))
    if not (len(converted) == len(scales) and n_deq == len(converted)
            and i8_only and i8_bytes < f32_bytes):
        fail("the int8 ResNet-50 model: %d converted, %d dequantize ops, "
             "%d bytes against %d" % (len(converted), n_deq, i8_bytes,
                                      f32_bytes))
    if not (in_session <= QAT_PRED_TOL and err <= QAT_PRED_TOL):
        fail("the int8 ResNet-50's outputs leave the frozen program's: "
             "%.3e, %.3e" % (in_session, err))
    run.pop("scope")
    return dict(qat=run, f32=f32, pred_ms=float(np.mean(ms)),
                int8_bytes=i8_bytes, f32_bytes=f32_bytes)


def sentiment_program(fluid, **kw):
    """The book's convolution_net train program (Adagrad) and its test
    clone: (main, startup, test, loss, prediction)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import understand_sentiment as sentiment

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SENT_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        loss, _, pred = sentiment.build(fluid, **kw)
        test = main.clone(for_test=True)
        fluid.optimizer.Adagrad(
            learning_rate=sentiment.LEARNING_RATE).minimize(loss)
    return main, startup, test, loss, pred


def sentiment_phase(np, torch, fluid, kernels, model_root):
    """The book's sentiment CNN at its widths (module docstring, step 20):
    3 + 10 Adagrad steps on one batch, then the test clone saved and
    served 20 times through ``AnalysisConfig`` (the "inference" passes)
    against the in-session test run."""
    from paddle_tpu_torch.inference import AnalysisConfig, \
        create_paddle_predictor
    from paddle_tpu_torch.models import understand_sentiment as sentiment

    main, startup, test, loss, pred = sentiment_program(
        fluid, max_len=SENT_LEN)
    feed = sentiment.batch(np, np.random.RandomState(SENT_SEED), SENT_BATCH,
                           SENT_LEN, SENT_MIN_LEN)
    print("sentiment: convolution_net, vocabulary %d, embedding %d, "
          "windows 3 and 4 of %d (tanh, sqrt pooling), %d classes, batch "
          "%d x %d (lengths %d..%d), Adagrad(%g)"
          % (sentiment.WORD_DICT, sentiment.EMB_DIM, sentiment.HID_DIM,
             sentiment.CLASS_DIM, SENT_BATCH, SENT_LEN,
             int(feed["length"].min()), int(feed["length"].max()),
             sentiment.LEARNING_RATE))
    run = nlp_train(np, torch, fluid, kernels, "sentiment", main, startup,
                    loss, feed, (), SENT_BATCH)
    fired = {k: n for k, n in run["kernel_launches"].items() if n}
    print("sentiment: %.1f ms a step (min %.1f, max %.1f), %.1f "
          "sentences/s, peak %.2f GiB, card busy %.1f %%, %s launches a "
          "step; hand-written kernels launched: %s"
          % (run["step_ms"], run["min_ms"], run["max_ms"], run["rate"],
             run["peak"], run["busy"], run["step_launches"],
             fired or "none"))
    exe = fluid.Executor()
    pfeed = {"words": feed["words"], "length": feed["length"]}
    (ref,) = exe.run(test, feed=feed, fetch_list=[pred], scope=run["scope"])
    ref = np.asarray(ref)
    path = os.path.join(model_root, "sentiment_cnn")
    fluid.io.save_inference_model(path, ["words", "length"], [pred], exe,
                                  main_program=test, scope=run["scope"])
    p = create_paddle_predictor(AnalysisConfig(path))
    types = [op.type for op in p._program.global_block().ops]
    outs, ms = [], []
    for _ in range(SENT_PRED_RUNS):
        t0 = time.perf_counter()
        (o,) = p.run(pfeed)
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(np.asarray(o))
    err = max(float(np.abs(o - ref).max()) for o in outs)
    n_fused = types.count("fusion_seqconv_eltadd_relu")
    print("sentiment predictor (AnalysisConfig, the card): %d ops after "
          "the inference passes, %d sequence_conv + add + relu fused (the "
          "book's branches are tanh), %d fc; %d runs of %d sentences: %.2f "
          "ms a run (min %.2f, max %.2f), %.1f sentences/s; against the "
          "in-session test run max abs diff %.2e (tol %.0e)"
          % (len(types), n_fused, types.count("fc"), SENT_PRED_RUNS,
             SENT_BATCH, float(np.mean(ms)), min(ms), max(ms),
             SENT_BATCH / float(np.mean(ms)) * 1e3, err, SENT_PRED_TOL))
    if types.count("sequence_conv") != 2 or n_fused \
            or not err <= SENT_PRED_TOL:
        fail("the sentiment predictor: %s, diff %.3e" % (types, err))
    run.pop("scope")
    run.update(pred_ms=float(np.mean(ms)), fused=n_fused)
    return run


def card_cpu_steps(np, fluid, main, startup, loss, feeds):
    """``feeds`` run through ``main`` on a card executor and, from a
    copy of the card's initial state, on a CPU one: (card losses, CPU
    losses, card scope)."""
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    cpu_scope = cpu_copy(np, fluid, main, scope)
    got = {}
    for dev, ex, sc in (("card", exe, scope), ("cpu", fluid.Executor(
            fluid.CPUPlace()), cpu_scope)):
        got[dev] = [float(np.asarray(ex.run(main, feed=f, fetch_list=[loss],
                                            scope=sc)[0]).reshape(-1)[0])
                    for f in feeds]
    return got["card"], got["cpu"], scope


def seq_quant_card_vs_cpu_phase(np, torch, fluid):
    """Step 20's card-against-CPU runs at small size: the sentiment CNN at
    embedding 16, hid 32, T 24 and tests/test_quantize_transpiler.py's
    convnet under QAT (abs_max and range_abs_max activations), 3 steps
    each from one state (losses within CVC_TOL); then each QAT test clone
    frozen and converted to int8 on both sides from the card's trained
    state: frozen and int8 outputs within 1e-5, int8 tensors equal."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.io import prune_program
    from paddle_tpu_torch.models import understand_sentiment as sentiment
    from paddle_tpu_torch.transpiler import QuantizeTranspiler

    L = fluid.layers
    r = np.random.RandomState(SENT_SEED + 3)
    main, startup, _, loss, _ = sentiment_program(
        fluid, max_len=24, emb_dim=16, hid_dim=32)
    feeds = [sentiment.batch(np, r, 8, 24, 3) for _ in range(SEQ_CVC_STEPS)]
    card, cpu, _ = card_cpu_steps(np, fluid, main, startup, loss, feeds)
    err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(card, cpu))
    print("seq/quant card vs cpu sentiment (emb 16, hid 32, T 24): losses "
          "card %s cpu %s, max diff %.2e of max(1, |loss|) (tol %.0e)"
          % (["%.6f" % v for v in card], ["%.6f" % v for v in cpu], err,
             SEQ_CVC_TOL))
    if not err <= SEQ_CVC_TOL:
        fail("the sentiment CNN's card and CPU losses differ by %.2e" % err)
    for act_type in ("abs_max", "range_abs_max"):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 3
        qt = QuantizeTranspiler(activation_quantize_type=act_type)
        with unique_name.guard({}), fluid.program_guard(main, startup):
            img = L.data("img", [1, 8, 8])
            label = L.data("label", [1], dtype="int64")
            c = L.conv2d(img, num_filters=4, filter_size=3, padding=1,
                         act="relu")
            logits = L.fc(L.flatten(c), size=3)
            loss = L.mean(L.softmax_with_cross_entropy(logits, label))
            qt.training_transpile(main, startup)
            test = main.clone(for_test=True)
            fluid.optimizer.Adam(learning_rate=5e-3).minimize(loss)
        feeds = []
        for _ in range(SEQ_CVC_STEPS):
            y = r.randint(0, 3, (8, 1)).astype("int64")
            x = np.zeros((8, 1, 8, 8), "float32")
            for i, lab in enumerate(y[:, 0]):
                x[i, 0, int(lab) * 2:(int(lab) + 1) * 2, :] = 1.0
            feeds.append({"img": (x + 0.1 * r.rand(8, 1, 8, 8)).astype(
                "float32"), "label": y})
        card, cpu, scope = card_cpu_steps(np, fluid, main, startup, loss,
                                          feeds)
        err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(card, cpu))
        cpu_scope = cpu_copy(np, fluid, main, scope)
        outs = {}
        for dev, ex, sc in (("card", fluid.Executor(), scope),
                            ("cpu", fluid.Executor(fluid.CPUPlace()),
                             cpu_scope)):
            t = prune_program(test, ["img"], [logits.name])
            scales = qt.freeze_program(t, scope=sc)
            (frozen,) = ex.run(t, feed={"img": feeds[0]["img"]},
                               fetch_list=[logits], scope=sc)
            qt.convert_to_int8(t, scope=sc, scales=scales)
            (i8,) = ex.run(t, feed={"img": feeds[0]["img"]},
                           fetch_list=[logits], scope=sc)
            tensors = [sc.get_value(n + ".int8").cpu().numpy()
                       for n in sorted(scales)]
            outs[dev] = (np.asarray(frozen), np.asarray(i8), tensors)
        e_frozen = rel_max(np, outs["card"][0], outs["cpu"][0])
        e_int8 = rel_max(np, outs["card"][1], outs["cpu"][1])
        same = all(np.array_equal(a, b) for a, b in zip(outs["card"][2],
                                                        outs["cpu"][2]))
        print("seq/quant card vs cpu qat convnet (%s): losses card %s cpu "
              "%s, max diff %.2e (tol %.0e); frozen outputs %.2e, int8 "
              "outputs %.2e relative (tol %.0e); int8 tensors equal %s"
              % (act_type, ["%.6f" % v for v in card],
                 ["%.6f" % v for v in cpu], err, SEQ_CVC_TOL, e_frozen,
                 e_int8, QAT_PRED_TOL, same))
        if not (err <= SEQ_CVC_TOL and e_frozen <= QAT_PRED_TOL
                and e_int8 <= QAT_PRED_TOL and same):
            fail("the QAT convnet (%s) differs between card and CPU"
                 % act_type)


# -- step 21: sub-blocks and control flow, the book's RNN models --------------


def encdec_feed(np, batch, seed, dict_size=None):
    """One batch of the encoder-decoder (models/rnn_encoder_decoder.py's
    ``batch``): ``batch`` pairs, lengths ED_MIN_LEN..ED_LEN."""
    from paddle_tpu_torch.models import rnn_encoder_decoder as encdec

    return encdec.batch(np, np.random.RandomState(seed), batch, ED_LEN,
                        ED_MIN_LEN, dict_size or encdec.DICT_SIZE)


def encdec_kernel_phase(np, torch):
    """B6 at the encoder-decoder's width (module docstring, step 21):
    the encoder's ``dynamic_lstm`` input ``[64, 50, 128]`` (D 32) with
    peepholes and the batch's source lengths, as the train steps give
    it, and without peepholes at full lengths (the library's shape),
    each against its plain version (RNN_TOL) and timed: kernel, plain
    version, bound, and ``torch.nn.LSTM(32, 32)`` (cuDNN, which also
    computes the input product) at the no-peephole shape. Returns (the
    worst error, the timing rows)."""
    from paddle_tpu_torch.kernels import lstm_cell as lc
    from paddle_tpu_torch.models import rnn_encoder_decoder as encdec

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    B, T, D = ED_BATCH, ED_LEN, encdec.HIDDEN_DIM
    lens = torch.from_numpy(encdec_feed(np, B, ED_SEED)["src_length"]
                            .reshape(-1)).cuda()
    V = float(lens.sum())
    worst, rows = 0.0, {}
    for name, kw in (("lstm_cell_encdec", lstm_case(torch, gen, B, T, D,
                                                    lens=lens)),
                     ("lstm_cell_encdec_full", lstm_case(torch, gen, B, T, D,
                                                         peep=False))):
        print("plan lstm_cell %-28s %s" % (name, plan_line("lstm_cell", B,
                                                              D)))
        outs, refs = lc.lstm_cell_forward(**kw), lc.lstm_reference(**kw)
        torch.cuda.synchronize()
        worst = max(worst, rnn_check(torch, "lstm_cell", name, outs, refs,
                                     kw, False))
    kw = copies(lstm_case(torch, gen, B, T, D, lens=lens))
    rows["lstm_cell_encdec"] = dict(
        shape="the encoder-decoder's encoder: xw [%d,%d,%d], D %d, "
        "peepholes, lengths %d..%d (%d of %d steps valid)"
        % (B, T, 4 * D, D, int(lens.min()), int(lens.max()), V, B * T),
        ms=cuda_ms(lc.lstm_cell_forward, kw),
        plain_ms=cuda_ms(lc.lstm_reference, kw, iters=6, reps=3),
        library_ms=None,
        bound=bound(4.0 * (V * 4 * D + 2 * B * T * D + 4 * D * D + 7 * D
                           + B * T), 8.0 * V * D * D))
    kw = copies(lstm_case(torch, gen, B, T, D, peep=False))
    lstm = torch.nn.LSTM(D, D, batch_first=True).cuda()
    xs = [torch.randn(B, T, D, generator=gen, device="cuda")
          for _ in range(3)]
    with torch.no_grad():
        lib_ms = device_ms(torch, lambda i: lstm(xs[i]), xs)
    rows["lstm_cell_encdec_full"] = dict(
        shape="xw [%d,%d,%d], D %d, no peepholes, full lengths"
        % (B, T, 4 * D, D),
        ms=cuda_ms(lc.lstm_cell_forward, kw),
        plain_ms=cuda_ms(lc.lstm_reference, kw, iters=6, reps=3),
        library_ms=lib_ms,
        bound=bound(4.0 * (B * T * 4 * D + 2 * B * T * D + 4 * D * D
                           + 4 * D), 8.0 * B * T * D * D))
    for name, r in rows.items():
        lib = ("%.4f ms (torch.nn.LSTM, cuDNN, input product included; its "
               "kernels' device time)" % r["library_ms"]
               if r["library_ms"] is not None else "none (peepholes)")
        print("time %-20s %s: kernel %.4f ms, plain %.4f ms, library %s, "
              "bound %.4f ms (%s)" % (name, r["shape"], r["ms"],
                                      r["plain_ms"], lib, r["bound"][0],
                                      r["bound"][1]))
    return worst, rows


def book_program(fluid, model, **kw):
    """The train program of ``model`` ("dyn_rnn_lstm" with Adagrad(0.002)
    and its test clone, or "encdec" with the book's Adagrad and L2
    decay): (main, startup, test or None, loss, prediction, params and
    grads)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import rnn_encoder_decoder as encdec
    from paddle_tpu_torch.models import understand_sentiment as sentiment

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = (
        SENT_SEED if model == "dyn_rnn_lstm" else ED_SEED)
    test = None
    with unique_name.guard({}), fluid.program_guard(main, startup):
        if model == "dyn_rnn_lstm":
            loss, _, pred = sentiment.build_lstm(fluid, **kw)
            test = main.clone(for_test=True)
            _, pg = fluid.optimizer.Adagrad(
                learning_rate=sentiment.LEARNING_RATE).minimize(loss)
        else:
            loss, pred = encdec.build(fluid, **kw)
            _, pg = encdec.optimizer(fluid).minimize(loss)
    return main, startup, test, loss, pred, pg


def book_predictor(np, fluid, run, test, pred, feed, model_root):
    """dyn_rnn_lstm's test clone saved and served BOOK_PRED_RUNS times
    through ``NativeConfig`` on BOOK_PRED_BATCH sentences: ms a run,
    outputs against the executor's on the same sentences."""
    from paddle_tpu_torch.inference import NativeConfig, \
        create_paddle_predictor

    exe = fluid.Executor()
    pfeed = {k: feed[k][:BOOK_PRED_BATCH] for k in ("words", "length")}
    (ref,) = exe.run(test, feed=dict(pfeed, label=feed["label"][
        :BOOK_PRED_BATCH]), fetch_list=[pred], scope=run["scope"])
    ref = np.asarray(ref)
    path = os.path.join(model_root, "dyn_rnn_lstm")
    fluid.io.save_inference_model(path, ["words", "length"], [pred], exe,
                                  main_program=test, scope=run["scope"])
    p = create_paddle_predictor(NativeConfig(path))
    outs, ms = [], []
    for _ in range(BOOK_PRED_RUNS):
        t0 = time.perf_counter()
        (o,) = p.run(pfeed)
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(np.asarray(o))
    err = max(float(np.abs(o - ref).max()) for o in outs)
    types = [op.type for op in p._program.global_block().ops]
    print("dyn_rnn_lstm predictor (NativeConfig, the card): %d ops, %d "
          "blocks (%s recurrent); %d runs of %d sentences (lengths "
          "%d..%d): %.2f ms a run (min %.2f, max %.2f), %.1f sentences/s; "
          "against the executor's test run max abs diff %.2e (tol %.0e)"
          % (len(types), p._program.num_blocks, types.count("recurrent"),
             BOOK_PRED_RUNS, BOOK_PRED_BATCH, int(pfeed["length"].min()),
             int(pfeed["length"].max()), float(np.mean(ms)), min(ms),
             max(ms), BOOK_PRED_BATCH / float(np.mean(ms)) * 1e3, err,
             BOOK_PRED_TOL))
    if types.count("recurrent") != 1 or not err <= BOOK_PRED_TOL:
        fail("the dyn_rnn_lstm predictor: %s, diff %.3e" % (types, err))
    return float(np.mean(ms)), err


def book_rnn_phase(np, torch, fluid, kernels, model_root):
    """Step 21's two book models at their widths: BOOK_WARMUP +
    BOOK_STEPS steps each (``nlp_train``: step ms, rate, peak memory,
    launches, a profiled step's busy share, reruns gated 0, losses
    falling), dyn_rnn_lstm's test clone through a ``Predictor``, and the
    encoder-decoder's B6 launches and device ms in the profiled step.
    Returns {model: run}."""
    from paddle_tpu_torch.models import rnn_encoder_decoder as encdec
    from paddle_tpu_torch.models import understand_sentiment as sentiment
    from paddle_tpu_torch.ops import subblock_ops

    out = {}
    main, startup, test, loss, pred, _ = book_program(
        fluid, "dyn_rnn_lstm", max_len=SENT_LEN)
    feed = sentiment.batch(np, np.random.RandomState(SENT_SEED), SENT_BATCH,
                           SENT_LEN, SENT_MIN_LEN)
    print("dyn_rnn_lstm: the book test's DynamicRNN LSTM (four fc-sum "
          "gates in the step), vocabulary %d, embedding %d, lstm_size %d, "
          "%d classes, batch %d x %d (lengths %d..%d), Adagrad(%g); %d ops "
          "in block 0, %d in the step"
          % (sentiment.WORD_DICT, sentiment.LSTM_EMB_DIM,
             sentiment.LSTM_SIZE, sentiment.CLASS_DIM, SENT_BATCH, SENT_LEN,
             int(feed["length"].min()), int(feed["length"].max()),
             sentiment.LEARNING_RATE, len(main.global_block().ops),
             len(main.block(1).ops)))
    subblock_ops.reset_host_reads()
    run = nlp_train(np, torch, fluid, kernels, "dyn_rnn_lstm", main, startup,
                    loss, feed, (), SENT_BATCH, warmup=BOOK_WARMUP,
                    steps=BOOK_STEPS)
    if any(subblock_ops.HOST_READS.values()):
        fail("dyn_rnn_lstm read a predicate on the host: %s"
             % subblock_ops.HOST_READS)
    fired = {k: n for k, n in run["kernel_launches"].items() if n}
    print("dyn_rnn_lstm: %.1f ms a step (min %.1f, max %.1f), %.1f "
          "sentences/s, peak %.2f GiB, card busy %.1f %%, %s launches a "
          "step; hand-written kernels launched: %s"
          % (run["step_ms"], run["min_ms"], run["max_ms"], run["rate"],
             run["peak"], run["busy"], run["step_launches"],
             fired or "none"))
    run["pred_ms"], run["pred_err"] = book_predictor(
        np, fluid, run, test, pred, feed, model_root)
    run.pop("scope")
    out["dyn_rnn_lstm"] = run
    main, startup, _, loss, _, _ = book_program(
        fluid, "encdec", max_src_len=ED_LEN, max_trg_len=ED_LEN)
    feed = encdec_feed(np, ED_BATCH, ED_SEED)
    print("encdec: the book's RNN encoder-decoder (fc tanh, dynamic_lstm, "
          "last step; a DynamicRNN decoder from the context), dictionary "
          "%d, words %d, hidden %d, batch %d, source lengths %d..%d, "
          "target lengths %d..%d, Adagrad(%g) with L2Decay(%g)"
          % (encdec.DICT_SIZE, encdec.WORD_DIM, encdec.HIDDEN_DIM, ED_BATCH,
             int(feed["src_length"].min()), int(feed["src_length"].max()),
             int(feed["target_length"].min()),
             int(feed["target_length"].max()), encdec.LEARNING_RATE,
             encdec.L2_COEFF))
    run = nlp_train(np, torch, fluid, kernels, "encdec", main, startup, loss,
                    feed, ("lstm_cell",), ED_BATCH, warmup=BOOK_WARMUP,
                    steps=BOOK_STEPS)
    b6 = [ms for k, ms in run["kernel_ms"].items() if "lstm_cell_kernel" in k]
    print("encdec: %.1f ms a step (min %.1f, max %.1f), %.1f sentence "
          "pairs/s, peak %.2f GiB, card busy %.1f %%, %s launches a step; "
          "lstm_cell (B6, D %d) %d launches in %d timed steps, %s in the "
          "profiled step"
          % (run["step_ms"], run["min_ms"], run["max_ms"], run["rate"],
             run["peak"], run["busy"], run["step_launches"],
             encdec.HIDDEN_DIM, run["launches"]["lstm_cell"], BOOK_STEPS,
             "%.4f device ms" % sum(b6) if b6 else
             "not in the profiler's trace (not measured)"))
    if run["launches"]["lstm_cell"] != BOOK_STEPS:
        fail("encdec: %d lstm_cell launches in %d steps"
             % (run["launches"]["lstm_cell"], BOOK_STEPS))
    run["b6_profiled_ms"] = sum(b6) if b6 else None
    run.pop("scope")
    out["encdec"] = run
    return out


def book_card_vs_cpu_phase(np, torch, fluid):
    """Both book models, one step each on the card and on the CPU from
    the card's initial state (``cpu_copy``, the convert module's
    persistables carry), at batch BOOK_CVC_BATCH (dyn_rnn_lstm at
    BOOK_CVC_LEN words): the loss and every parameter's gradient within
    BOOK_CVC_TOL of each value's largest entry."""
    from paddle_tpu_torch.models import understand_sentiment as sentiment

    cases = [
        ("dyn_rnn_lstm", dict(max_len=BOOK_CVC_LEN), sentiment.batch(
            np, np.random.RandomState(SENT_SEED + 5), BOOK_CVC_BATCH,
            BOOK_CVC_LEN, SENT_MIN_LEN)),
        ("encdec", dict(max_src_len=ED_LEN, max_trg_len=ED_LEN),
         encdec_feed(np, BOOK_CVC_BATCH, ED_SEED + 5))]
    for model, kw, feed in cases:
        main, startup, _, loss, _, pg = book_program(fluid, model, **kw)
        names = [g.name for _, g in pg]
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        cpu_scope = cpu_copy(np, fluid, main, scope)
        got = {}
        for dev, ex, sc in (("card", exe, scope), ("cpu", fluid.Executor(
                fluid.CPUPlace()), cpu_scope)):
            got[dev] = [np.asarray(v) for v in ex.run(
                main, feed=feed, fetch_list=[loss] + names, scope=sc)]
        # each value against its own largest entry (1e-6 at least)
        errs = [float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                  1e-6)
                for a, b in zip(got["card"], got["cpu"])]
        print("book card vs cpu %s (batch %d x %d): loss card %.6f cpu "
              "%.6f, relative diff %.2e; %d gradients, worst %.2e of the "
              "largest value (tol %.0e)"
              % (model, BOOK_CVC_BATCH, feed.get(
                  "words", feed.get("src_word_id")).shape[1],
                 float(got["card"][0].reshape(-1)[0]),
                 float(got["cpu"][0].reshape(-1)[0]), errs[0], len(names),
                 max(errs[1:]), BOOK_CVC_TOL))
        if not max(errs) <= BOOK_CVC_TOL:
            fail("book card vs cpu %s: %.3e" % (model, max(errs)))


def control_flow_phase(np, torch, fluid):
    """The control-flow sweep (module docstring, step 21): each
    construct's program run on the card and on the CPU (each side its
    own startup: the initializers' threefry draws are bit-equal), floats
    within CF_TOL, integers equal, the host reads of each; then
    ``run_multi_step`` of the bounded While's train program captured
    against ``FLAGS_cuda_graph=0`` (equal), and the unbounded While's
    and cond's programs refused capture by name."""
    from paddle_tpu_torch import flags, unique_name
    from paddle_tpu_torch.ops import subblock_ops
    from paddle_tpu_torch.testing import control_flow_cases

    def build(fn):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 53
        with unique_name.guard({}), fluid.program_guard(main, startup):
            fetch = fn(fluid)
        return main, startup, fetch

    for name, fn, feeds in control_flow_cases():
        main, startup, fetch = build(fn)
        got, reads = {}, {}
        for dev, exe in (("card", fluid.Executor()),
                         ("cpu", fluid.Executor(fluid.CPUPlace()))):
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            subblock_ops.reset_host_reads()
            got[dev] = [[np.asarray(v) for v in exe.run(
                main, feed=f, fetch_list=fetch, scope=scope)] for f in feeds]
            reads[dev] = dict(subblock_ops.HOST_READS)
            if dev == "card":
                torch.cuda.synchronize()
        worst, same = 0.0, True
        for a_run, b_run in zip(got["card"], got["cpu"]):
            for a, b in zip(a_run, b_run):
                if np.issubdtype(b.dtype, np.floating):
                    worst = max(worst, float(np.abs(a - b).max()))
                else:
                    same = same and np.array_equal(a.astype(np.int64),
                                                   b.astype(np.int64))
        types = sorted({op.type for blk in main.blocks for op in blk.ops
                        if op.type in ("recurrent", "while", "while_grad",
                                       "cond", "where_select",
                                       "write_to_array", "read_from_array",
                                       "lod_tensor_to_array",
                                       "array_to_lod_tensor",
                                       "recurrent_grad")})
        print("control flow %-30s %d blocks, %s; %d run(s): card vs cpu "
              "max abs diff %.2e (tol %.0e), integers equal %s; host reads "
              "on the card: while %d, cond %d"
              % (name, main.num_blocks, ", ".join(types), len(feeds), worst,
                 CF_TOL, same, reads["card"]["while"], reads["card"]["cond"]))
        if not (worst <= CF_TOL and same) or reads["card"] != reads["cpu"]:
            fail("control flow %s: card and CPU differ (%.3e, %s, reads %s "
                 "against %s)" % (name, worst, same, reads["card"],
                                  reads["cpu"]))
    cases = {n: (fn, feeds) for n, fn, feeds in control_flow_cases()}
    fn, feeds = cases["bounded While + grad"]

    def train_loop(fl):
        out = fn(fl)
        fl.optimizer.SGD(learning_rate=0.1).minimize(out[0])
        return out[:3]

    got, launches = {}, {}
    for graph in (True, False):
        flags.set_flag("cuda_graph", graph)
        try:
            main, startup, fetch = build(train_loop)
            exe = fluid.Executor()
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            subblock_ops.reset_host_reads()
            got[graph] = [[np.asarray(v) for v in exe.run_multi_step(
                main, 4, feed=feeds[0], fetch_list=fetch, scope=scope)]
                for _ in range(3)]
            torch.cuda.synchronize()
            launches[graph] = (exe.graph_stats()["graphs"],
                               exe.eager_multi_step,
                               dict(subblock_ops.HOST_READS))
        finally:
            flags.set_flag("cuda_graph", True)
    equal = all(np.array_equal(a, b) for ra, rb in zip(got[True], got[False])
                for a, b in zip(ra, rb))
    print("control flow capture: the bounded While's train program, 3 "
          "run_multi_step calls of 4 steps: captured (graphs %d, eager "
          "loops %d, host reads %s) against FLAGS_cuda_graph=0 (eager "
          "loops %d): equal %s; losses %s"
          % (launches[True][0], launches[True][1], launches[True][2],
             launches[False][1], equal,
             ["%.6f" % float(r[0].reshape(-1)[0]) for r in got[True]]))
    if not (equal and launches[True][0] == 1 and launches[True][1] == 0
            and launches[False][1] == 3
            and not any(launches[True][2].values())):
        fail("control flow capture: the captured bounded While differs from "
             "the eager loop")
    for name, op in (("unbounded While + array", "while"), ("cond", "cond")):
        fn, feeds = cases[name]
        main, startup, fetch = build(fn)
        exe = fluid.Executor()
        exe.run(startup)
        try:
            exe.run_multi_step(main, 2, feed=feeds[0], fetch_list=fetch)
        except RuntimeError as e:
            if "'%s'" % op not in str(e):
                fail("control flow capture of %s: refused without naming "
                     "%r: %s" % (name, op, e))
            print("control flow capture %s: refused (%s)" % (name, e))
        else:
            fail("control flow capture of %s was not refused" % name)
        if exe.graph_stats()["graphs"]:
            fail("control flow capture of %s left a graph" % name)


# -- step 22: beam decode ------------------------------------------------------

def beam_session(exe, scope, num_slots=None, n_layer=None, max_length=None):
    """A beam session of the serve phase's configuration (NUM_SLOTS,
    N_LAYER, MAX_LEN unless given): ``BEAM_K`` hypotheses a lane, one
    decode step a ``step()``, page headroom for the copy-reorder oracle's
    fresh page lists."""
    from paddle_tpu_torch.serving.generation import SlotDecodeSession

    num_slots = num_slots or NUM_SLOTS
    n_layer = n_layer or N_LAYER
    max_length = max_length or MAX_LEN
    npp = -(-max_length // PAGE_SIZE)
    return SlotDecodeSession(
        exe, num_slots=num_slots, max_length=max_length, d_model=D_MODEL,
        paged=True, page_size=PAGE_SIZE, steps=1, eos_id=EOS, scope=scope,
        beam_width=BEAM_K, num_pages=1 + 2 * num_slots * npp,
        src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=n_layer,
        n_head=N_HEAD, d_inner=D_INNER)


def beam_requests(np, length=None):
    """The first BEAM_REQUESTS of ``requests``, sources cut to ``length``
    (MAX_LEN unless given; every 8th with its forced prefix)."""
    length = length or MAX_LEN
    src, lens, prefixes = requests(np)
    n = BEAM_REQUESTS
    return (np.ascontiguousarray(src[:n, :length]),
            np.minimum(lens[:n], length), prefixes[:n])


def run_beams(np, torch, sess, kernels, reqs, hook=None):
    """Serve the beam requests through ``sess``: one admission every
    BEAM_STAGGER steps while a lane is free, the rest as lanes free, with
    every kernel's count set to 0 just before. ``hook(phase)`` runs just
    before ("pre") and after ("post") each ``step()``. Returns (results
    ``{i: {"tokens", "scores"}}``, wall seconds, launches, host seconds of
    each ``step()``)."""
    src, lens, prefixes = reqs
    n = len(src)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    owner, results, nxt, since, times = {}, {}, 0, BEAM_STAGGER, []
    while len(results) < n:
        if nxt < n and sess.free_beams and since >= BEAM_STAGGER:
            lane = sess.admit_beam(src[nxt], lens[nxt],
                                   prefix_tokens=prefixes[nxt])
            owner[sess.register_beam_owner(lane)] = nxt
            nxt, since = nxt + 1, 0
        if hook is not None:
            hook("pre")
        ts = time.perf_counter()
        sess.step()
        times.append(time.perf_counter() - ts)
        if hook is not None:
            hook("post")
        since += 1
        for rid in list(owner):
            r = sess.take_beam_result(rid)
            if r is not None:
                results[owner.pop(rid)] = r
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0, kernel_counts(kernels), times


def lattice_margins(torch, pre_ids, pre_scores, logp, eos):
    """Per batch row of a ``[B, K, V]`` lattice step: the K-th largest
    candidate total less the (K+1)-th, the candidates built as
    ``beam_step`` builds them (a finished beam's one candidate is (eos,
    its score)). A margin below MARGIN_TOL may flip the selection
    between two devices that sum in other orders."""
    from paddle_tpu_torch.ops.beam_search_ops import NEG_INF

    B, K, V = logp.shape
    finished = pre_ids == eos
    total = pre_scores[:, :, None] + logp
    total = torch.where(finished[:, :, None], torch.full_like(total, NEG_INF),
                        total)
    total[:, :, eos] = torch.where(finished, pre_scores, total[:, :, eos])
    top = torch.topk(total.reshape(B, K * V), K + 1, dim=1).values
    return (top[:, K - 1] - top[:, K]).double()


def eos_shift(np, sess, reqs):
    """The shift of ``proj_logits``' bias at EOS that puts eos among a
    hypothesis's BEAM_K best tokens in a BEAM_EOS_SHARE of the
    (hypothesis, step) pairs of BEAM_EOS_PROBE steps of every lane,
    served by ``sess`` on the unshifted weights. Random weights rank eos
    far from the top, so without the shift no hypothesis meets it and
    the finished paths (frozen rows, writes to the trash page, done
    slots beside live ones, lanes that end early) never run."""
    src, lens, prefixes = reqs
    sess._extra_step_fetches = [sess._beam_fetches["logits"]]
    for i in range(NUM_SLOTS // BEAM_K):
        sess.admit_beam(src[i], lens[i], prefix_tokens=prefixes[i])
    gaps = []
    for _ in range(BEAM_EOS_PROBE):
        sess.step()
        lg = sess.last_extra_fetches[0][:, 0, :].astype(np.float64)
        other = np.delete(lg, EOS, axis=1)
        kth = np.partition(other, -BEAM_K, axis=1)[:, -BEAM_K]
        gaps.append(kth - lg[:, EOS])
    for lane in sess.active_beams:
        sess.cancel(sess.beam_slots(lane)[0])
    gaps = np.concatenate(gaps)
    return float(np.quantile(gaps, BEAM_EOS_SHARE)), gaps


def in_graph_check(np, torch, sess):
    """A ``run_beams`` hook holding each dispatch's in-graph selection to
    ``beam_step`` replayed offline on the dispatch's own fetched logits
    and the pre-step state, on the card: tokens, parents and scores equal
    bit for bit over every slot. Returns (hook, counts: the dispatches
    checked, those with a done hypothesis beside live ones in a lane,
    those where equal totals among a lane's K selected or at its K-th
    place left the order to the lowest-index rule, in a live lane and in
    a free one)."""
    from paddle_tpu_torch.ops.beam_search_ops import beam_step

    f = sess._beam_fetches
    sess._extra_step_fetches = [f["logits"], f["token"], f["parent"],
                                f["score"]]
    scope, S, K = sess._scope, NUM_SLOTS, BEAM_K
    B = S // K
    pre = {}
    counts = dict(checked=0, done_beside_live=0, ties_live=0, ties_free=0)
    base = torch.arange(B, device="cuda")[:, None] * K

    def hook(phase):
        if phase == "pre":
            for n in ("pgd_tok", "pgd_done", "pgd_score"):
                pre[n] = scope.get_value(n).clone().reshape(-1)
            pre["live"] = torch.tensor(
                [lane in sess._beam_live for lane in range(B)], device="cuda")
            return
        lg, tok, par, sc = (torch.from_numpy(np.ascontiguousarray(x)).cuda()
                            for x in sess.last_extra_fetches)
        logp = torch.log_softmax(lg[:, 0, :].float(), dim=-1)
        ids = torch.where(pre["pgd_done"] > 0,
                          torch.full_like(pre["pgd_tok"], EOS),
                          pre["pgd_tok"])
        scores = pre["pgd_score"].reshape(B, K).float()
        logp = logp.reshape(B, K, -1)
        want_tok, want_sc, want_par = beam_step(
            ids.reshape(B, K), scores, logp, EOS, is_accumulated=False)
        if not (torch.equal(want_tok.reshape(-1), tok.reshape(-1))
                and torch.equal((base + want_par).reshape(-1),
                                par.reshape(-1))
                and torch.equal(want_sc.reshape(-1), sc.reshape(-1))):
            fail("beam_serve (a): dispatch %d's in-graph selection differs "
                 "from beam_step replayed on its logits" % counts["checked"])
        counts["checked"] += 1
        n_done = (pre["pgd_done"].reshape(B, K) > 0).sum(1)
        if (pre["live"] & (n_done > 0) & (n_done < K)).any():
            counts["done_beside_live"] += 1
        tie = ((want_sc[:, 1:] == want_sc[:, :-1]).any(1)
               | (lattice_margins(torch, ids.reshape(B, K), scores, logp,
                                  EOS) == 0))
        counts["ties_live"] += int((tie & pre["live"]).any())
        counts["ties_free"] += int((tie & ~pre["live"]).any())

    return hook, counts


def paged_beam_inputs(torch, sess):
    """B4's and B1's inputs at beam traffic, from a beam session's state:
    layer 0's page pools, the page table (hypotheses sharing their
    parents' pages), the lengths the step gives (0 for done and free
    slots) and seeded queries; the cross attention's group rows and
    masks gathered by ``group_of``."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    get = sess._scope.get_value
    pos, done = get("pgd_pos").reshape(-1), get("pgd_done").reshape(-1)
    dh = D_MODEL // N_HEAD
    paged = dict(q=torch.randn(NUM_SLOTS, N_HEAD, dh, generator=g,
                               device="cuda"),
                 k_pool=get("pgd_kpool_0").clone(),
                 v_pool=get("pgd_vpool_0").clone(),
                 page_table=get("pgd_table").clone(),
                 lengths=((pos + 1) * (1 - done)).clone())
    gof = get("pgd_group_of").reshape(-1)
    cross = dict(q=torch.randn(NUM_SLOTS, N_HEAD, 1, dh, generator=g,
                               device="cuda"),
                 k=get("pgd_kcross_0").index_select(0, gof),
                 v=get("pgd_vcross_0").index_select(0, gof),
                 kv_mask=get("pgd_src_mask").index_select(0, gof))
    return paged, cross


def beam_kernel_check(np, torch, sess, worst):
    """B4 and B1 at the beam path's own inputs (``paged_beam_inputs``)
    against their plain versions, and B4 timed there. Returns B4's timing
    row."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    paged, cross = paged_beam_inputs(torch, sess)
    lengths = paged["lengths"].tolist()
    table = paged["page_table"]
    live = [s for s, n in enumerate(lengths) if n > 0]
    if not live:
        fail("beam kernels: no live hypothesis to attend over")
    n_pages = {s: pa.pages_for(lengths[s], PAGE_SIZE) for s in live}
    pages = {int(p) for s in live for p in table[s, :n_pages[s]].tolist()}
    refs = sum(n_pages.values())
    in_lane = {s for lane in sess.active_beams for s in sess.beam_slots(lane)}
    n_done = sum(1 for s in in_lane if lengths[s] == 0)
    n_free = NUM_SLOTS - len(in_lane)
    out = pa.paged_attention(**paged)
    ref = pa.paged_attention_plain(**paged)
    e4 = (out - ref).abs().max().item()
    dead = torch.tensor([n <= 0 for n in lengths], device="cuda")
    if not dead.any():
        fail("paged_decode beam: no done or free slot at length 0")
    if out[dead].abs().max().item() != 0.0:
        fail("paged_decode beam: a done or free slot's output is not 0")
    out1 = fa.flash_forward(**cross)
    ref1 = fa.flash_forward_plain(**cross)
    out1 = out1[0] if isinstance(out1, tuple) else out1
    ref1 = ref1[0] if isinstance(ref1, tuple) else ref1
    e1 = (out1 - ref1).abs().max().item()
    print("kernel paged_decode beam_traffic      max_abs_err %.3e  tol %.0e: "
          "%d live hypotheses, lengths %d..%d, %d page references to %d "
          "distinct pages (shared by the lanes' hypotheses); at length 0 "
          "(output exactly 0): %d done hypotheses of live lanes, %d slots "
          "of free lanes"
          % (e4, K2_TOL, len(live), min(lengths[s] for s in live),
             max(lengths), refs, len(pages), n_done, n_free))
    print("kernel flash_fwd beam_cross           max_abs_err %.3e  tol %.0e: "
          "q [%d,%d,1,%d] over each hypothesis's group row [%d,%d,%d,%d], "
          "4 hypotheses a group" % (e1, K1_TOL, NUM_SLOTS, N_HEAD,
                                    D_MODEL // N_HEAD, NUM_SLOTS, N_HEAD,
                                    MAX_LEN, D_MODEL // N_HEAD))
    if not (e4 <= K2_TOL and e1 <= K1_TOL):
        fail("beam kernels: paged_decode %.3e, flash_fwd %.3e above their "
             "tolerances" % (e4, e1))
    worst["paged_decode"] = max(worst["paged_decode"], e4)
    worst["flash_fwd"] = max(worst["flash_fwd"], e1)
    kw = copies(paged)
    row = dict(
        shape="%d slots (%d lanes x %d hypotheses, %d lanes live), %d "
        "live at lengths %d..%d, %d done, %d free, %d page references to "
        "%d pages, H %d, dh %d, page_size %d"
        % (NUM_SLOTS, NUM_SLOTS // BEAM_K, BEAM_K, len(sess.active_beams),
           len(live), min(lengths[s] for s in live), max(lengths), n_done,
           n_free, refs, len(pages), N_HEAD, D_MODEL // N_HEAD, PAGE_SIZE),
        ms=cuda_ms(pa.paged_attention, kw),
        plain_ms=cuda_ms(pa.paged_attention_plain, kw), library_ms=None,
        bound=paged_decode_shared_bound(lengths, table.tolist(),
                                        D_MODEL // N_HEAD))
    print("time %-20s %s: kernel %.4f ms, plain %.4f ms, library none, "
          "bound %.4f ms (%s; each shared page's rows once; %.4f ms at a "
          "read per reference)"
          % ("paged_decode_beam", row["shape"], row["ms"], row["plain_ms"],
             row["bound"][0], row["bound"][1],
             paged_decode_bound(lengths, D_MODEL // N_HEAD)[0]))
    return row


def beam_serve_phase(np, torch, exe, scope, kernels, worst):
    """``beam_serve`` (module docstring, step 22). Returns (the timed
    run's launches, (d)'s rescored n-best of request BEAM_WIRE_REQUEST,
    B4's timing row at beam traffic, the session)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import transformer

    t_phase = time.perf_counter()
    reqs = beam_requests(np)
    src, lens, prefixes = reqs
    n_prefix = sum(p is not None for p in prefixes)
    # every beam session of the phase (and beam_wire's) reads the bias
    # raised at EOS from this child scope; the serve phase's stays
    shift, gaps = eos_shift(np, beam_session(
        exe, scope.new_scope(), max_length=BEAM_ORACLE_LEN),
        beam_requests(np, BEAM_ORACLE_LEN))
    bias = scope.get_value(LOGITS_BIAS).clone()
    bias[EOS] += shift
    bscope = scope.new_scope()
    bscope.set_value(LOGITS_BIAS, bias)
    print("beam_serve: proj_logits' bias at eos raised by %.4f: eos among "
          "a hypothesis's %d best tokens in %.1f%% of %d (hypothesis, step) "
          "pairs (median gap to the %d-th best %.4f)"
          % (shift, BEAM_K, 100 * BEAM_EOS_SHARE, len(gaps), BEAM_K,
             float(np.median(gaps))))
    sess = beam_session(exe, bscope.new_scope())
    eager0 = exe.eager_multi_step
    results, wall, launches, times = run_beams(np, torch, sess, kernels,
                                               reqs)
    steps = sess.steps_done
    met_eos = [int((r["tokens"][:, 1:] == EOS).any(1).sum())
               for r in results.values()]
    print("beam_serve: hypotheses that met eos %d of %d; lanes that ended "
          "before max_length (every hypothesis met eos) %d of %d; best "
          "hypothesis lengths %s"
          % (sum(met_eos), BEAM_K * BEAM_REQUESTS,
             sum(m == BEAM_K for m in met_eos), BEAM_REQUESTS,
             sorted(generated_tokens(r["tokens"][0], prefixes[i])
                    for i, r in results.items())))
    if not sum(met_eos):
        fail("beam_serve: no hypothesis met eos")
    hyp_tokens = sum(int((r["tokens"][:, 1:] != EOS).sum())
                     for r in results.values())
    best_tokens = sum(generated_tokens(r["tokens"][0], prefixes[i])
                      for i, r in results.items())
    print("beam_serve: %d requests, %d lanes of %d, max_length %d, "
          "admissions %d steps apart: wall %.3f s, %d step() calls, %d "
          "hypothesis tokens (%.1f tokens/s), %d best-hypothesis tokens "
          "(%.1f tokens/s); host ms per step() mean %.3f median %.3f; "
          "graphs captured %d, eager run_multi_step calls %d"
          % (BEAM_REQUESTS, NUM_SLOTS // BEAM_K, BEAM_K, MAX_LEN, BEAM_STAGGER,
             wall, steps, hyp_tokens, hyp_tokens / wall, best_tokens,
             best_tokens / wall, 1e3 * float(np.mean(times)),
             1e3 * float(np.median(times)),
             exe.graph_stats(sess.step_program)["graphs"],
             exe.eager_multi_step - eager0))
    print("beam_serve: beam_cow_copies %d, beam_reorder_pages %d, COW "
          "dispatches %d; launches a step: paged_decode %.3f, flash_fwd "
          "%.3f (decode rows %.3f); kernel launches %s"
          % (sess.beam_cow_copies, sess.beam_reorder_pages,
             sess.cow_dispatches, launches["paged_decode"] / steps,
             launches["flash_fwd"] / steps,
             launches.get("flash_fwd/decode", 0) / steps,
             json.dumps(launches)))
    expect_k1 = (BEAM_REQUESTS * N_LAYER + N_LAYER * steps
                 + 2 * (N_LAYER - 1) * n_prefix)
    if launches["paged_decode"] != N_LAYER * steps:
        fail("beam_serve: paged_decode launched %d times, expected n_layer "
             "x steps = %d" % (launches["paged_decode"], N_LAYER * steps))
    if launches["flash_fwd"] != expect_k1:
        fail("beam_serve: flash_fwd launched %d times, expected %d"
             % (launches["flash_fwd"], expect_k1))
    if exe.eager_multi_step != eager0:
        fail("beam_serve: the beam step ran an eager loop, not its graph")
    if sess.beam_reorder_pages != 0:
        fail("beam_serve: the rebind reorder copied %d pages"
             % sess.beam_reorder_pages)
    for i, r in results.items():
        t = r["tokens"]
        if not (t[:, 0] == 1).all() or not ((t >= 0) & (t < VOCAB)).all():
            fail("beam_serve: request %d's n-best is out of range or not "
                 "bos-led" % i)
        if prefixes[i] is not None and not (
                t[:, 1:1 + len(prefixes[i])] == prefixes[i]).all():
            fail("beam_serve: request %d lost its forced prefix" % i)
        if not (np.isfinite(r["scores"]).all()
                and (np.diff(r["scores"]) <= 0).all()):
            fail("beam_serve: request %d's scores are not finite and "
                 "descending: %s" % (i, r["scores"]))
    if sess.pages_in_use != 0 or not sess.pool_conserved:
        fail("beam_serve (c): the page pool did not drain")
    # B4 and B1 at this traffic: BEAM_TRAFFIC_LANES lanes
    # BEAM_TRAFFIC_STEPS steps in, hypotheses sharing their parents'
    # pages, the other lanes free
    for i in range(BEAM_TRAFFIC_LANES):
        sess.admit_beam(src[i], lens[i], prefix_tokens=prefixes[i])
    for _ in range(BEAM_TRAFFIC_STEPS):
        sess.step()
    beam_row = beam_kernel_check(np, torch, sess, worst)
    for lane in sess.active_beams:
        sess.cancel(sess.beam_slots(lane)[0])
    # (c) a mid-beam cancel of one hypothesis frees the whole lane
    lane = sess.admit_beam(src[1], lens[1], prefix_tokens=prefixes[1])
    for _ in range(3):
        sess.step()
    in_use = sess.pages_in_use
    sess.cancel(sess.beam_slots(lane)[2])
    ok = (not sess.active_beams and sess.free_beams == NUM_SLOTS // BEAM_K
          and sess.pages_in_use == 0 and sess.pool_conserved)
    print("beam_serve (c): pool conserved after the run; a mid-beam cancel "
          "of hypothesis 2 (%d pages in use) freed the whole lane: %s"
          % (in_use, ok))
    if not ok:
        fail("beam_serve (c): the cancel did not free the lane")
    # (d) generate_beam(len_penalty) is the timed run's n-best rescored
    j = BEAM_WIRE_REQUEST
    t_d, s_d = sess.generate_beam(src[j], lens[j], prefix_tokens=prefixes[j],
                                  len_penalty=BEAM_LEN_PENALTY)
    _, t_r, s_r = transformer.gnmt_rescore_nbest(
        results[j]["tokens"], results[j]["scores"], EOS, BEAM_LEN_PENALTY)
    ok_d = np.array_equal(t_d, t_r) and np.array_equal(s_d, s_r)
    print("beam_serve (d): generate_beam(len_penalty=%.1f) of request %d "
          "equals the timed run's n-best rescored by gnmt_rescore_nbest: %s "
          "(penalized scores %s)" % (BEAM_LEN_PENALTY, j, ok_d,
                                     ["%.5f" % x for x in s_d]))
    if not ok_d:
        fail("beam_serve (d): the rescored n-best differs")
    # (a) and (b) at max_length BEAM_ORACLE_LEN: the same requests (their
    # sources cut there) through a rebind session and the copy-reorder
    # oracle, each of the oracle's dispatches replayed offline. The
    # oracle copies every moved hypothesis's pages through the eager COW
    # program: at max_length 256 the run took 141.6 s
    oreqs = beam_requests(np, BEAM_ORACLE_LEN)
    rebind = beam_session(exe, bscope.new_scope(), max_length=BEAM_ORACLE_LEN)
    got, wall_got, _, _ = run_beams(np, torch, rebind, kernels, oreqs)
    flags.set_flag("beam_reorder", "reference")
    try:
        oracle = beam_session(exe, bscope.new_scope(),
                              max_length=BEAM_ORACLE_LEN)
        hook, counts = in_graph_check(np, torch, oracle)
        ref, wall_ref, _, _ = run_beams(np, torch, oracle, kernels, oreqs,
                                        hook)
    finally:
        flags.set_flag("beam_reorder", "rebind")
    same = all(np.array_equal(got[i]["tokens"], ref[i]["tokens"])
               and np.array_equal(got[i]["scores"], ref[i]["scores"])
               for i in got)
    print("beam_serve (a): %d dispatches' in-graph selections equal "
          "beam_step replayed on their logits, bit for bit; %d with a done "
          "hypothesis beside live ones in a lane; equal totals left the "
          "order to the lowest-index rule in %d (a live lane) and %d (a "
          "free lane)" % (counts["checked"], counts["done_beside_live"],
                          counts["ties_live"], counts["ties_free"]))
    print("beam_serve (b): the %d requests at max_length %d, rebind (wall "
          "%.3f s) against FLAGS_beam_reorder=reference (wall %.3f s): "
          "tokens and scores equal bit for bit %s; reorder pages copied: "
          "rebind %d, oracle %d (%d bytes); beam_cow_copies: rebind %d, "
          "oracle %d" % (BEAM_REQUESTS, BEAM_ORACLE_LEN, wall_got, wall_ref,
                         same, rebind.beam_reorder_pages,
                         oracle.beam_reorder_pages,
                         oracle.beam_reorder_pages * 2 * N_LAYER * N_HEAD
                         * PAGE_SIZE * (D_MODEL // N_HEAD) * 4,
                         rebind.beam_cow_copies, oracle.beam_cow_copies))
    if not same or rebind.beam_reorder_pages or \
            oracle.beam_reorder_pages <= 0 or counts["checked"] != \
            oracle.steps_done:
        fail("beam_serve (a)/(b): the oracle run differs, a run copied the "
             "wrong pages or a dispatch went unchecked")
    if not (counts["done_beside_live"]
            and counts["ties_live"] + counts["ties_free"]):
        fail("beam_serve (a): no dispatch held a done hypothesis beside "
             "live ones, or none left the order to the tie rule")
    for who in (rebind, oracle):
        if who.pages_in_use != 0 or not who.pool_conserved:
            fail("beam_serve (c): a page pool did not drain")
    print("beam_serve: %.1f s" % (time.perf_counter() - t_phase))
    return launches, (t_d, s_d), beam_row, sess


def beam_wire_phase(np, torch, sess, kernels, want):
    """``beam_wire``: request BEAM_WIRE_REQUEST through
    ``ServingFrontend`` and ``ServingClient`` on the beam session of
    ``beam_serve``, equal to the in-process ``generate_beam`` of it
    (``want``: its tokens and penalized scores), and a severed beam
    stream that frees its lane. Returns the launches of the wire
    request's window."""
    from paddle_tpu_torch.serving.client import ServingClient
    from paddle_tpu_torch.serving.frontend import ServingFrontend

    t_phase = time.perf_counter()
    src, lens, prefixes = beam_requests(np)
    j = BEAM_WIRE_REQUEST
    want_t, want_s = want
    with ServingFrontend(session=sess, host="127.0.0.1") as fe:
        cl = ServingClient(fe.address)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.reset()
        events = []
        steps0 = sess.steps_done
        t0 = time.perf_counter()
        got_t, got_s = cl.generate_beam(src[j], src_len=int(lens[j]),
                                        prefix_tokens=prefixes[j],
                                        len_penalty=BEAM_LEN_PENALTY,
                                        on_event=events.append)
        wall = time.perf_counter() - t0
        launches = kernel_counts(kernels)
        n_chunks = sum(e["event"] == "beam" for e in events)
        cut = (j + 1) % len(src)
        cut_steps = sess.steps_done
        gen = cl.generate(src[cut], src_len=int(lens[cut]), beam=True)
        first = next(gen)
        second = next(gen)
        cl.close()  # severed mid-beam: the close hook cancels the lane

        def lane_freed():
            # the decode worker owns the session: read only counters it
            # sets last when a teardown completes
            return (sess.free_beams == NUM_SLOTS // BEAM_K
                    and not sess._beam_live and sess.pages_in_use == 0
                    and sess.pool_conserved)

        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not lane_freed():
            time.sleep(0.02)
        freed = lane_freed()
        # a lane that ran to its end was not cancelled
        cut_steps = sess.steps_done - cut_steps
        freed = freed and cut_steps < MAX_LEN - 2
    steps = sess.steps_done - steps0
    equal = np.array_equal(got_t, want_t) and np.array_equal(got_s, want_s)
    print("beam_wire: one request over the socket (len_penalty %.1f): wall "
          "%.3f s, %d beam chunks, events %s ... %s; reassembled equal to "
          "the in-process generate_beam %s; launches paged_decode %d, "
          "flash_fwd %d" % (BEAM_LEN_PENALTY, wall, n_chunks,
                            [e["event"] for e in events[:2]],
                            [e["event"] for e in events[-2:]], equal,
                            launches["paged_decode"], launches["flash_fwd"]))
    print("beam_wire: a severed beam stream (%s, %s) freed its lane after "
          "%d steps: %s" % (first["event"], second["event"], cut_steps,
                            freed))
    if not (equal and first["event"] == "admitted"
            and first.get("beam_width") == BEAM_K and freed
            and n_chunks >= 3):
        fail("beam_wire: the wire beam differs from the in-process one or "
             "the severed stream kept its lane")
    if launches["paged_decode"] != N_LAYER * n_chunks:
        fail("beam_wire: paged_decode launched %d times over %d chunks, "
             "expected n_layer a chunk" % (launches["paged_decode"],
                                           n_chunks))
    print("beam_wire: %.1f s (%d steps on the wire and severed)"
          % (time.perf_counter() - t_phase, steps))
    return launches


def record_lane_steps(sess, log):
    """Wrap ``sess.step``: each step's (tokens, parents) per lane go to
    ``log[lane]``."""
    step = sess.step

    def logged():
        out = step()
        for lane, ev in sess.last_beam_events.items():
            log.setdefault(lane, []).append((ev["tokens"], ev["parents"]))
        for lane, fin in sess.last_finished_beams.items():
            log.setdefault(lane, []).append((fin["step_tokens"],
                                             fin["parents"]))
        return out

    sess.step = logged


def beam_card_vs_cpu_phase(np, torch, fluid, exe):
    """``beam_card_vs_cpu``: the beam session at BEAM_CVC_LAYERS layers,
    full width otherwise, BEAM_CVC_LANES lanes, max_length BEAM_CVC_LEN,
    on the card and on the CPU from one state: scores within
    BEAM_SCORE_TOL, tokens equal or first different at a step whose
    lattice margin (K-th less (K+1)-th candidate, from the CPU's logits)
    is below MARGIN_TOL."""
    t_phase = time.perf_counter()
    card_scope = fluid.Scope()
    main = build_model(fluid, exe, card_scope, n_layer=BEAM_CVC_LAYERS)
    cpu_scope = cpu_copy(np, fluid, main, card_scope)
    src, lens, prefixes = beam_requests(np, BEAM_CVC_LEN)
    S = BEAM_CVC_LANES * BEAM_K
    runs, logs, margins = {}, {}, {}
    for dev, ex, sc in (("card", exe, card_scope),
                        ("cpu", fluid.Executor(fluid.CPUPlace()), cpu_scope)):
        sess = beam_session(ex, sc.new_scope(), num_slots=S,
                            n_layer=BEAM_CVC_LAYERS, max_length=BEAM_CVC_LEN)
        logs[dev] = {}
        record_lane_steps(sess, logs[dev])
        if dev == "cpu":
            sess._extra_step_fetches = [sess._beam_fetches["logits"]]
            get, step = sess._scope.get_value, sess.step
            margins[dev] = []

            def margin_step(sess=sess, get=get, step=step):
                pre = [get(n).reshape(-1).clone() for n in
                       ("pgd_tok", "pgd_done", "pgd_score")]
                out = step()
                lg = torch.from_numpy(sess.last_extra_fetches[0][:, 0, :])
                ids = torch.where(pre[1] > 0, torch.full_like(pre[0], EOS),
                                  pre[0])
                margins["cpu"].append(lattice_margins(
                    torch, ids.reshape(-1, BEAM_K),
                    pre[2].reshape(-1, BEAM_K).float(),
                    torch.log_softmax(lg.float(), -1).reshape(
                        -1, BEAM_K, VOCAB), EOS).numpy())
                return out

            sess.step = margin_step
        lanes = [sess.admit_beam(src[i], lens[i], prefix_tokens=prefixes[i])
                 for i in range(BEAM_CVC_LANES)]
        rids = [sess.register_beam_owner(lane) for lane in lanes]
        while sess.active_beams:
            sess.step()
        runs[dev] = [sess.take_beam_result(r) for r in rids]
        if dev == "card":
            torch.cuda.synchronize()
    marg = np.stack(margins["cpu"])  # [steps, lanes]
    for lane in range(BEAM_CVC_LANES):
        a, b = runs["card"][lane], runs["cpu"][lane]
        if np.array_equal(a["tokens"], b["tokens"]):
            err = float(np.abs(a["scores"] - b["scores"]).max())
            print("beam_card_vs_cpu lane %d: tokens equal, scores max abs "
                  "diff %.2e (tol %.0e); smallest lattice margin %.2e"
                  % (lane, err, BEAM_SCORE_TOL, marg[:, lane].min()))
            if not err <= BEAM_SCORE_TOL:
                fail("beam_card_vs_cpu: lane %d's scores differ by %.3e"
                     % (lane, err))
            continue
        la, lb = logs["card"][lane], logs["cpu"][lane]
        t = next(i for i in range(min(len(la), len(lb))) if la[i] != lb[i])
        m = float(marg[t, lane])
        print("beam_card_vs_cpu lane %d: the selections first differ at "
              "step %d (card %s, cpu %s), lattice margin there %.2e (tol "
              "%.0e)" % (lane, t, la[t], lb[t], m, MARGIN_TOL))
        if not m < MARGIN_TOL:
            fail("beam_card_vs_cpu: lane %d differs at step %d where the "
                 "margin %.3e is not below %.0e" % (lane, t, m, MARGIN_TOL))
    print("beam_card_vs_cpu: %d layers, %d lanes, max_length %d: %.1f s"
          % (BEAM_CVC_LAYERS, BEAM_CVC_LANES, BEAM_CVC_LEN,
             time.perf_counter() - t_phase))


def sentence_check(np, label, card, cpu, stopped_at, tol=BEAM_SCORE_TOL):
    """Card against CPU n-bests ``(ids [B, K, T], scores)`` of a beam
    generator, the scores per step along each hypothesis ``[B, K, T]``
    or final ``[B, K]``. A row whose ids are equal has scores within
    ``tol``. A row whose ids differ passes only as a tie:
    ``stopped_at(t)`` gives the (card, CPU) outputs of the same
    generator stopped after t steps, ``(ids, totals [B, K])``, whose
    beams are the full run's at step t; at the first step where the
    row's beams differ, the two sides' K totals, sorted, are within
    ``tol`` (they kept different candidates of equal total). At least
    BEAM_EQUAL_SHARE of the rows are equal."""
    ids_a, sc_a = card
    ids_b, sc_b = cpu
    B, T = ids_a.shape[0], ids_a.shape[2]
    worst, diverged, cut = 0.0, [], {}
    for b in range(B):
        if np.array_equal(ids_a[b], ids_b[b]):
            worst = max(worst, float(np.abs(sc_a[b] - sc_b[b]).max()))
            continue
        pos = int(np.argmax((ids_a[b] != ids_b[b]).any(axis=0)))
        for t in range(max(1, pos), T + 1):
            if t not in cut:
                cut[t] = stopped_at(t)
            (ia, ta), (ib, tb) = cut[t]
            if not np.array_equal(ia[b], ib[b]):
                break
        else:
            fail("%s: row %d differs, but no stopped run shows where"
                 % (label, b))
        gap = float(np.abs(np.sort(ta[b]) - np.sort(tb[b])).max())
        diverged.append((b, t, round(gap, 9)))
        if not gap <= tol:
            fail("%s: row %d's beams first differ at step %d, where the "
                 "two sides' totals are %.3e apart, above %.0e: not a tie"
                 % (label, b, t, gap, tol))
    n_equal = B - len(diverged)
    print("%s: ids equal in %d of %d rows, scores max abs diff %.2e (tol "
          "%.0e); rows that differ (row, the step where their beams first "
          "differ, the sorted totals' gap there): %s"
          % (label, n_equal, B, worst, tol, diverged))
    if not worst <= tol:
        fail("%s: scores differ by %.3e" % (label, worst))
    if n_equal < BEAM_EQUAL_SHARE * B:
        fail("%s: ids equal in only %d of %d rows" % (label, n_equal, B))


def mt_beam_phase(np, torch, fluid, exe, kernels, mt_scope):
    """``mt_beam``: ``build_generator`` at its defaults on the MT weights
    the ``mt`` phase trained, batch MT_BATCH: sentences/s and B6 launches
    on the card (2 a run: the encoder's two directions), then card
    against CPU (``sentence_check``). Returns the timed runs'
    ``lstm_cell`` launches."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import machine_translation as mt

    t_phase = time.perf_counter()

    def generator(max_len=32):
        prog, startup = fluid.Program(), fluid.Program()
        with unique_name.guard({}), fluid.program_guard(prog, startup):
            ids, scores, _ = mt.build_generator(max_len=max_len)
        return prog, ids, scores

    prog, ids, scores = generator()
    rng = np.random.RandomState(SEED + 1)
    feed = {"source_sequence": rng.randint(3, 1000, (MT_BATCH, MT_SEQ)).astype(
                "int64"),
            "source_length": rng.randint(8, MT_SEQ + 1, (MT_BATCH, 1)).astype(
                "int64")}
    exe.run(prog, feed=feed, fetch_list=[ids, scores], scope=mt_scope)
    torch.cuda.synchronize()
    kernels["lstm_cell"].reset()
    t0 = time.perf_counter()
    for _ in range(MT_BEAM_RUNS):
        card = exe.run(prog, feed=feed, fetch_list=[ids, scores],
                       scope=mt_scope)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels["lstm_cell"].launches
    print("mt_beam: build_generator (beam 4, max_len 32, 64 wide, vocabulary "
          "1000), batch %d, %d runs: %.2f ms a run, %.1f sentences/s; "
          "lstm_cell launches %d (%.1f a run)"
          % (MT_BATCH, MT_BEAM_RUNS, 1e3 * wall / MT_BEAM_RUNS,
             MT_BATCH * MT_BEAM_RUNS / wall, launches,
             launches / MT_BEAM_RUNS))
    if launches != 2 * MT_BEAM_RUNS:
        fail("mt_beam: lstm_cell launched %d times, expected 2 a run"
             % launches)
    cpu_scope = cpu_copy(np, fluid, prog, mt_scope)
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=[ids, scores], scope=cpu_scope)

    def stopped_at(t):
        p, i, sc = generator(t)
        return [[np.asarray(x) for x in ex.run(
                    p, feed=feed, fetch_list=[i, sc], scope=where)]
                for ex, where in ((exe, mt_scope),
                                  (fluid.Executor(fluid.CPUPlace()),
                                   cpu_scope))]

    sentence_check(np, "mt_beam card vs cpu",
                   [np.asarray(x) for x in card],
                   [np.asarray(x) for x in cpu], stopped_at)
    print("mt_beam: %.1f s" % (time.perf_counter() - t_phase))
    return launches


def book_beam_phase(np, torch, fluid, kernels):
    """``book_beam``: the book's ``decoder_decode`` at its widths
    (``set_deterministic_params`` weights), batch BOOK_BEAM_BATCH:
    ``run_multi_step`` captured against the eager loop
    (``FLAGS_cuda_graph=0``), bit for bit, with no host read from the
    ``While``; sentences/s and B6 launches (the encoder, one a run); then
    card against CPU (``sentence_check``). Returns the timed runs'
    ``lstm_cell`` launches."""
    from paddle_tpu_torch import flags, unique_name
    from paddle_tpu_torch.models import rnn_encoder_decoder as red
    from paddle_tpu_torch.ops import subblock_ops
    from paddle_tpu_torch.testing import set_deterministic_params

    t_phase = time.perf_counter()
    K, B = BOOK_BEAM_K, BOOK_BEAM_BATCH

    def decoder(max_length):
        prog, startup = fluid.Program(), fluid.Program()
        with unique_name.guard({}), fluid.program_guard(prog, startup):
            L = fluid.layers
            src = L.data(name="src_word_id", shape=[ED_LEN], dtype="int64")
            src_len = L.data(name="src_length", shape=[1], dtype="int64")
            context = red.encoder(fluid, src, src_len)
            ids, scores = red.decoder_decode(fluid, context, src_len, B,
                                             beam_size=K,
                                             max_length=max_length,
                                             end_id=BOOK_END_ID)
        return prog, startup, ids, scores

    prog, startup, ids, scores = decoder(BOOK_BEAM_LEN)
    feed = encdec_feed(np, B, ED_SEED + 7)
    feed = {k: feed[k] for k in ("src_word_id", "src_length")}
    feed.update(red.init_beams(np, B, K, start_id=0))
    runs, stats = {}, {}
    for graph in (True, False):
        flags.set_flag("cuda_graph", graph)
        try:
            ex = fluid.Executor()
            scope = fluid.Scope()
            ex.run(startup, scope=scope)
            set_deterministic_params(prog, scope)
            subblock_ops.reset_host_reads()

            def call():
                return [np.asarray(v) for v in ex.run_multi_step(
                    prog, 1, feed=feed, fetch_list=[ids, scores],
                    scope=scope)]

            # the first calls warm up and capture; the timed ones replay
            warm = [call() for _ in range(2)]
            torch.cuda.synchronize()
            kernels["lstm_cell"].reset()
            t0 = time.perf_counter()
            for _ in range(BOOK_BEAM_RUNS):
                runs[graph] = call()
            torch.cuda.synchronize()
            if not all(np.array_equal(a, b) for w in warm
                       for a, b in zip(w, runs[graph])):
                fail("book_beam: a warm-up call differs from the timed "
                     "ones")
            stats[graph] = (time.perf_counter() - t0, ex.graph_stats()[
                "graphs"], ex.eager_multi_step, subblock_ops.HOST_READS[
                "while"], kernels["lstm_cell"].launches)
            if graph:
                card_scope = scope
        finally:
            flags.set_flag("cuda_graph", True)
    (wall, graphs, eager, reads, launches) = stats[True]
    equal = all(np.array_equal(a, b) for a, b in zip(runs[True],
                                                     runs[False]))
    print("book_beam: decoder_decode (dictionary %d, word_dim %d, hidden "
          "%d), beam %d, max_length %d, batch %d, %d timed run_multi_step "
          "calls after 2: captured %.2f ms a call (%.1f sentences/s; "
          "graphs %d, eager loops "
          "%d, host reads from the While %d), eager loop %.2f ms a call "
          "(eager loops %d); captured equal to the eager loop bit for bit "
          "%s; lstm_cell launches %d"
          % (red.DICT_SIZE, red.WORD_DIM, red.HIDDEN_DIM, K, BOOK_BEAM_LEN,
             B, BOOK_BEAM_RUNS, 1e3 * wall / BOOK_BEAM_RUNS,
             B * BOOK_BEAM_RUNS / wall, graphs, eager, reads,
             1e3 * stats[False][0] / BOOK_BEAM_RUNS, stats[False][2], equal,
             launches))
    if not (equal and graphs == 1 and eager == 0 and reads == 0
            and stats[False][2] == BOOK_BEAM_RUNS + 2):
        fail("book_beam: the captured decode differs from the eager loop, "
             "ran eagerly or read the host")
    if launches != BOOK_BEAM_RUNS:
        fail("book_beam: lstm_cell launched %d times, expected one a run"
             % launches)
    cpu_scope = cpu_copy(np, fluid, prog, card_scope)
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=[ids, scores], scope=cpu_scope)

    def stopped_at(t):
        p, _, i, sc = decoder(t)
        return [(o[0], o[1][:, :, -1]) for o in (
            [np.asarray(x) for x in ex.run(p, feed=feed, fetch_list=[i, sc],
                                            scope=where)]
            for ex, where in ((fluid.Executor(), card_scope),
                              (fluid.Executor(fluid.CPUPlace()),
                               cpu_scope)))]

    sentence_check(np, "book_beam card vs cpu", runs[True],
                   [np.asarray(x) for x in cpu], stopped_at)
    print("book_beam: %.1f s" % (time.perf_counter() - t_phase))
    return launches


def rnn_ops_sweep_cases(np, fluid):
    """``dynamic_lstmp`` (peepholes and lengths, neither, and at a
    realistic [32, 50, 512] with P 64), ``lstm_unit``, ``gru_unit`` (its
    integer codes and names) and ``row_conv``: forward and the gradient of
    each input."""
    L = fluid.layers
    rng = np.random.RandomState(SEED + 3)
    cases = []
    add = sweep_case_adder(np, fluid, cases)

    def f32(*shape):
        return (0.5 * rng.randn(*shape)).astype("float32")

    lens = np.array([[12], [5], [12], [1]], "int64")
    add("dynamic_lstmp peepholes, lengths",
        {"x": f32(4, 12, 64), "l": lens},
        lambda v: list(L.dynamic_lstmp(v["x"], 64, 8, length=v["l"])),
        ["x"])
    add("dynamic_lstmp no peepholes",
        {"x": f32(4, 12, 64)},
        lambda v: list(L.dynamic_lstmp(v["x"], 64, 8, use_peepholes=False,
                                       proj_activation="identity")), ["x"])
    big_lens = rng.randint(10, 51, (32, 1)).astype("int64")
    add("dynamic_lstmp [32, 50, 512] P 64, lengths",
        {"x": f32(32, 50, 512), "l": big_lens},
        lambda v: list(L.dynamic_lstmp(v["x"], 512, 64, length=v["l"])),
        ["x"])
    add("lstm_unit", {"x": f32(8, 64), "c": f32(8, 16)},
        lambda v: list(L.lstm_unit(v["x"], v["c"], forget_bias=1.0)),
        ["x", "c"])
    add("gru_unit", {"x": f32(8, 48), "h": f32(8, 16)},
        lambda v: list(L.gru_unit(v["x"], v["h"], 48)), ["x", "h"])
    add("gru_unit relu / identity codes", {"x": f32(8, 48), "h": f32(8, 16)},
        lambda v: [sweep_raw(fluid, "gru_unit", {
            "Input": v["x"], "HiddenPrev": v["h"],
            "Weight": L.create_parameter([16, 48], "float32",
                                         name="gru_codes_w")},
            ["Gate", "ResetHiddenPrev", "Hidden"],
            {"activation": 3, "gate_activation": 0})[2]], ["x", "h"])
    add("row_conv", {"x": f32(4, 20, 16)},
        lambda v: [L.row_conv(v["x"], 2)], ["x"])
    return cases


def rnn_ops_sweep_phase(np, torch, fluid):
    t_phase = time.perf_counter()
    worst, n_ops = run_sweep(np, fluid, rnn_ops_sweep_cases(np, fluid),
                             "rnn_ops", tol=RNN_OPS_TOL, relative=True)
    missing = {"dynamic_lstmp", "lstm_unit", "gru_unit", "row_conv"} - n_ops
    if missing:
        fail("the rnn_ops sweep ran no case of %s" % sorted(missing))
    print("rnn_ops_sweep: worst %.2e (tol %.0e, relative to max(1, largest)): "
          "%.1f s" % (worst, RNN_OPS_TOL, time.perf_counter() - t_phase))


def main():
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        fail("paddle_tpu_torch/ is not beside chip_smoke.py: run it from "
             "the root of a checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; chip_smoke.py runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in float32, as XLA's do: no
    # reduced-precision split-K reductions
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
        = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t_start, marks = time.perf_counter(), []

    def mark(label):
        """Seconds since the start at the end of each group of phases
        (the ``phase seconds`` line)."""
        marks.append((label, round(time.perf_counter() - t_start, 1)))
    print("card: %s (torch %s, CUDA %s)" % (card, torch.__version__,
                                           torch.version.cuda))

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import KERNELS
    from paddle_tpu_torch.kernels import build as kbuild

    t0 = time.perf_counter()
    kbuild.build(ptxas_verbose=True)
    kbuild.library()
    print("kernel build: %.1f s (%s)" % (time.perf_counter() - t0,
                                          os.path.basename(kbuild.library_path())))
    for line in kbuild.build_log().splitlines():
        if "entry function" in line:
            print("ptxas: %s" % kernel_symbol(line))
        elif "registers" in line or "spill" in line:
            print("ptxas:   " + line.strip()[:120])
    rnn_layout_phase()
    paged_layout_phase()
    tree_layout_phase()
    flash_rows_layout_phase()
    flash_bwd_layout_phase()
    flash_bf16_layout_phase()

    mark("build")
    worst = kernel_phase(torch)
    mark("kernels")
    worst["threefry"], rng_timing = rng_phase(torch)
    mark("rng")
    full_mask_phase(torch)
    timing = timing_phase(torch)
    for name in ("flash_fwd", "flash_fwd_verify", "flash_fwd_encoder",
                 "paged_decode", "paged_decode_ragged", "tree_decode", "flash_fwd_train",
                 "flash_fwd_train_causal", "flash_bwd_dkv", "flash_bwd_dq",
                 "flash_bwd_dkv_causal", "flash_bwd_dq_causal",
                 "flash_fwd_switch", "flash_bwd_dkv_switch",
                 "flash_bwd_dq_switch"):
        r = timing[name]
        lib = ("%.4f ms" % r["library_ms"] if r["library_ms"] is not None
               else "none")
        if r.get("backend"):
            lib += (" (backward of scaled_dot_product_attention, backend %s, "
                    "device time)" % r["backend"])
        plain = "plain %.4f ms" % r["plain_ms"]
        bnd = "bound %.4f ms (%s)" % r["bound"]
        if name.startswith("flash_bwd"):
            plain += " (the pair)"
            lib += " (the pair)"
            bnd = ("bound %.4f ms (%s, split-TF32 at 165 TFLOP/s; %.4f ms at "
                   "67 TFLOP/s fp32)" % (r["bound"] + r["bound_fp32"][:1]))
        print("time %-20s %s: kernel %.4f ms, %s, library %s, %s"
              % (name, r["shape"], r["ms"], plain, lib, bnd))
    print("time gather k_pool[gof] [%d,%d,%d,%d]: %.4f ms"
          % (NUM_SLOTS, N_HEAD, MAX_LEN, D_MODEL // N_HEAD,
             timing["gather_k_pool_gof_ms"]))
    for label, shape, plans in split_phase(torch):
        print("split %s, %s: %s" % (label, shape, "; ".join(
            "%d split(s) (%d blocks an SM%s) %.4f ms"
            % (n, per_sm, ", the plan" if i == 0 else "", ms)
            for i, (n, per_sm, ms) in enumerate(plans))))
    worst.update(rnn_kernel_phase(torch))
    rnn_timing = rnn_timing_phase(torch)
    # B6 at the encoder-decoder's width (step 21), beside the other RNN
    # timings: its library time is a profiler trace too
    encdec_worst, encdec_timing = encdec_kernel_phase(np, torch)
    worst["lstm_cell"] = max(worst["lstm_cell"], encdec_worst)
    for kname, widths in (("lstm_cell", (RNN_HID, RNN_PKG_HID,
                                          SRL_HIDDEN // 4)),
                          ("gru_cell", (RNN_HID, RNN_PKG_HID, CRNN_RNN))):
        for D in widths:
            print("plan %s B %d D %d: %s" % (kname, RNN_BATCH, D, plan_line(
                kname, RNN_BATCH, D)))
    for name, r in sorted(rnn_timing.items()):
        lib = ("%.4f ms (torch.nn.LSTM, cuDNN, input product included; "
               "its kernels' device time)"
               % r["library_ms"] if r["library_ms"] is not None else "none")
        print("time %-20s %s: kernel %.4f ms, plain %.4f ms, library %s, "
              "bound %.4f ms (%s)" % (name, r["shape"], r["ms"],
                                      r["plain_ms"], lib, r["bound"][0],
                                      r["bound"][1]))
    mark("timing")
    amp_worst, amp_timing = amp_kernel_phase(torch)
    mark("amp kernels")
    exe = fluid.Executor()  # the card: CUDAPlace(0)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    main_prog = build_model(fluid, exe, scope)
    print("model: Transformer-base weights ready in %.1f s"
          % (time.perf_counter() - t0))
    served = serve_phase(np, torch, exe, scope, KERNELS)
    launches = served["launches"]
    # the frontend phase holds its wire streams against these
    serve_out = served["out"]
    serve_rate = served["generated"] / served["wall"]
    graph_launches = graph_phase(np, torch, exe, scope, KERNELS, served)
    served = None
    mark("serve, graph")
    sampled_launches = sampled_phase(np, torch, exe, scope, KERNELS,
                                     serve_out)
    mark("sampled")
    prefix_launches = prefix_phase(np, torch, exe, scope, KERNELS)
    dense_launches = dense_phase(np, torch, exe, scope, KERNELS)
    card_vs_cpu_phase(np, torch, fluid, exe, scope, main_prog)
    spec_launches = speculative_phase(np, torch, fluid, exe, scope, KERNELS)
    spec_card_vs_cpu_phase(np, torch, fluid, exe, scope, main_prog)
    mark("prefix, dense, speculative, card vs cpu")
    beam_launches, beam_want, timing["paged_decode_beam"], beam_sess = \
        beam_serve_phase(np, torch, exe, scope, KERNELS, worst)
    beam_wire_launches = beam_wire_phase(np, torch, beam_sess, KERNELS,
                                         beam_want)
    beam_sess = None
    scope = main_prog = None
    torch.cuda.empty_cache()
    beam_card_vs_cpu_phase(np, torch, fluid, exe)
    mark("beam_serve, beam_wire, beam_card_vs_cpu")
    torch.cuda.empty_cache()
    train = train_phase(np, torch, fluid, exe, KERNELS)
    train_launches = train["launches"]
    mark("train")
    torch.cuda.empty_cache()
    # the AMP step right after the fp32 one, on a host in the same state:
    # at the end of the script the same AMP step ran 245.0 ms a step
    # against 179.6 in a process of its own (PERF.md)
    amp_train = train_phase(np, torch, fluid, exe, KERNELS, amp=True,
                            f32=train)
    amp_fused_ce_phase(np, torch, fluid, KERNELS, amp_train)
    mark("amp train")
    drop_capture_launches = dropout_capture_phase(np, torch, fluid, KERNELS)
    mark("dropout capture")
    train_card_vs_cpu_phase(np, torch, fluid, exe)
    amp_train_card_vs_cpu_phase(np, torch, fluid, exe)
    mark("train card vs cpu")
    torch.cuda.empty_cache()
    mnist_predictor_phase(np)
    pred_launches = transformer_predictor_phase(np, torch, fluid, exe,
                                                KERNELS)
    mark("predictor")
    torch.cuda.empty_cache()
    lstm_train, scope, infer, outs, feed = rnn_train_phase(
        np, torch, fluid, exe, KERNELS, "lstm")
    lstm_infer = rnn_infer_phase(np, torch, exe, KERNELS, scope, infer, outs,
                                 feed)
    import shutil
    import tempfile

    model_root = tempfile.mkdtemp(prefix="chip_smoke_models_")
    lstm_dir = os.path.join(model_root, "stacked_lstm")
    lstm_pred = rnn_predictor_phase(np, torch, fluid, exe, KERNELS, "lstm",
                                    scope, infer, outs, feed, lstm_dir)
    gru_train, scope, infer, outs, feed = rnn_train_phase(
        np, torch, fluid, exe, KERNELS, "gru")
    gru_pred = rnn_predictor_phase(np, torch, fluid, exe, KERNELS, "gru",
                                   scope, infer, outs, feed,
                                   os.path.join(model_root, "stacked_gru"))
    scope = None
    torch.cuda.empty_cache()
    mark("rnn")
    nan_check_phase(np, torch, fluid, exe)
    fe_launches = frontend_phase(np, torch, fluid, exe, KERNELS, serve_out,
                                 serve_rate, lstm_dir)
    shutil.rmtree(model_root)
    torch.cuda.empty_cache()
    mark("frontend")
    mt_launches, mt_scope = mt_phase(np, torch, fluid, exe, KERNELS)
    mt_beam_launches = mt_beam_phase(np, torch, fluid, exe, KERNELS,
                                     mt_scope)
    mt_scope = None
    rnn_card_vs_cpu_phase(np, torch, fluid, exe)
    torch.cuda.empty_cache()
    model_root = tempfile.mkdtemp(prefix="chip_smoke_models_")
    mark("mt, rnn card vs cpu")
    resnet = resnet_phase(np, torch, fluid, exe,
                          os.path.join(model_root, "resnet50"))
    host_rate = resnet["rate"]
    mark("resnet")
    shutil.rmtree(model_root)
    torch.cuda.empty_cache()
    graph_data_launches, graph_rate = resnet_graph_data_phase(
        np, torch, fluid, exe, KERNELS, host_rate)
    mark("resnet graph-data")
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    # the AMP ResNet-50 right after the fp32 runs, on a host in the same
    # state (later in the script the same step ran slower)
    amp_resnet = resnet_phase(np, torch, fluid, exe, None, amp=True,
                              f32=resnet)
    amp_graph_launches, _ = resnet_graph_data_phase(
        np, torch, fluid, exe, KERNELS, amp_resnet["rate"], amp=True,
        f32_rate=graph_rate)
    amp_resnet_card_vs_cpu_phase(np, torch, fluid, exe)
    mark("amp resnet")
    torch.cuda.empty_cache()
    optim_phase(np, torch, fluid, exe)
    mark("optim")
    torch.cuda.empty_cache()
    switch = switch_phase(np, torch, fluid, KERNELS)
    switch_launches = switch["launches"]
    torch.cuda.empty_cache()
    switch_card_vs_cpu_phase(np, torch, fluid)
    mark("switch")
    torch.cuda.empty_cache()
    cnn_phase(np, torch, fluid)
    golden_card_phase(np, torch, fluid, exe)
    mark("cnn, goldens")
    torch.cuda.empty_cache()
    worst.update(detection_kernel_phase(np, torch))
    mark("detection kernels")
    ssd_run = ssd_phase(np, torch, fluid, KERNELS)
    torch.cuda.empty_cache()
    ssd_card_vs_cpu_phase(np, torch, fluid)
    detection_sweep_phase(np, torch, fluid)
    mark("ssd, sweep")
    torch.cuda.empty_cache()
    nlp_worst, nlp_time = nlp_kernel_phase(np, torch)
    worst.update(nlp_worst)
    nlp_rnn = nlp_rnn_timing(np, torch)
    mark("nlp kernels")
    srl_run = srl_phase(np, torch, fluid, KERNELS)
    torch.cuda.empty_cache()
    crnn_run = crnn_phase(np, torch, fluid, KERNELS)
    torch.cuda.empty_cache()
    nlp_card_vs_cpu_phase(np, torch, fluid)
    nlp_sweep_phase(np, fluid)
    mark("srl, crnn, nlp card vs cpu, nlp sweep")
    torch.cuda.empty_cache()
    vision_quant_sweep_phase(np, torch, fluid)
    seq_sweep_phase(np, torch, fluid)
    mark("vision/quant and seq sweeps")
    torch.cuda.empty_cache()
    model_root = tempfile.mkdtemp(prefix="chip_smoke_models_")
    qat_resnet_phase(np, torch, fluid, KERNELS, model_root)
    torch.cuda.empty_cache()
    sentiment_phase(np, torch, fluid, KERNELS, model_root)
    shutil.rmtree(model_root)
    seq_quant_card_vs_cpu_phase(np, torch, fluid)
    mark("qat resnet, sentiment, seq/quant card vs cpu")
    torch.cuda.empty_cache()
    model_root = tempfile.mkdtemp(prefix="chip_smoke_models_")
    book = book_rnn_phase(np, torch, fluid, KERNELS, model_root)
    shutil.rmtree(model_root)
    torch.cuda.empty_cache()
    book_card_vs_cpu_phase(np, torch, fluid)
    control_flow_phase(np, torch, fluid)
    mark("book rnn, control flow")
    torch.cuda.empty_cache()
    book_beam_launches = book_beam_phase(np, torch, fluid, KERNELS)
    rnn_ops_sweep_phase(np, torch, fluid)
    mark("book_beam, rnn_ops_sweep")
    print("phase seconds (since the card check, at the end of each): %s"
          % json.dumps(marks))
    print("script total: %.1f s since the card check"
          % (time.perf_counter() - t_start))

    def bwd_record(name, line):
        """B2 or B3: the key-mask shape's numbers (bound at the split-TF32
        rate, ``bound_fp32_ms`` at the CUDA cores'), and per shape the
        train steps' launches at it, read from the wrapper's counts."""
        t = timing[name]
        shapes = shape_rows(timing, [
            (name, train_launches.get(name + "/full", 0)),
            (name + "_causal", train_launches.get(name + "/causal", 0)),
            (name + "_switch", switch_launches[name])],
            "the training phase's (Transformer-base) or the switch phase's "
            "(Switch-Base-8) timed steps at this shape class, counted by "
            "the wrapper where it launches")
        total = train_launches[name] + switch_launches[name]
        if sum(r["launches"] for r in shapes) != total:
            fail("%s's launches by shape class %s do not add up to its %d "
                 "launches" % (name, [r["launches"] for r in shapes],
                               total))
        for r in shapes:
            r["bound_fp32_ms"] = timing[r["row"]]["bound_fp32"][0]
        return dict(name=name, route="cuda",
                    source="paddle_tpu_torch/csrc/flash_bwd.cu",
                    replaces="paddle_tpu/kernels/flash_attention.py:%d" % line,
                    launches=total, max_abs_err=worst[name],
                    ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                    bound_by=t["bound"][1], library_ms=t["library_ms"],
                    bound_fp32_ms=t["bound_fp32"][0], shapes=shapes)

    def rnn_record(name, source, line, launches):
        t = rnn_timing[name + "_D%d" % RNN_HID]
        return dict(name=name, route="cuda",
                    source="paddle_tpu_torch/csrc/%s.cu" % name,
                    replaces="paddle_tpu/kernels/%s:%d" % (source, line),
                    launches=launches, max_abs_err=worst[name], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                    bound_by=t["bound"][1], library_ms=t["library_ms"])

    def shape_rows(table, names_launches, launches_of):
        """Every timed shape of a kernel: its numbers and the launches of
        the main path's calls at that shape (0: timed only)."""
        out = []
        for name, n in names_launches:
            t = table[name]
            out.append(dict(row=name, shape=t["shape"], launches=n,
                            launches_of=launches_of if n else "timed only",
                            ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound"][0], bound_by=t["bound"][1],
                            library_ms=t["library_ms"]))
        return out

    serving = (launches, graph_launches, prefix_launches, dense_launches,
               spec_launches, fe_launches, beam_launches, beam_wire_launches)

    def both(label):
        """The launches at ``label`` over every serving window."""
        return sum(r.get(label, 0) for r in serving)

    flash_shapes = shape_rows(timing, [
        ("flash_fwd", both("flash_fwd/decode")),
        ("flash_fwd_verify", both("flash_fwd/verify")),
        ("flash_fwd_encoder", both("flash_fwd/full")),
        ("flash_fwd_train", train_launches.get("flash_fwd/full", 0)),
        ("flash_fwd_train_causal", train_launches.get("flash_fwd/causal",
                                                      0)),
        ("flash_fwd_switch", switch_launches["flash_fwd"])],
        "the launches at this shape class in the serving runs' request "
        "windows (captured, eager, prefix cache, dense, speculative, the "
        "frontend, beam in process and over the wire), the training "
        "phase's or the switch phase's timed steps, counted by the wrapper "
        "where it launches")
    # the causal calls of those request windows: the decoder over a
    # forced prefix at admission (paged prefill), a shape not timed here
    flash_shapes.append(dict(
        row="flash_fwd_prefix", launches=both("flash_fwd/causal"),
        shape="causal, T > 4: the decoder over a forced prefix at admission",
        launches_of="the serving runs' request windows; not timed", ms=None, plain_ms=None, bound_ms=None, bound_by=None,
        library_ms=None))
    # the saved Transformer-base program's Predictor runs: encoder self
    # and cross attention with a key mask, decoder self-attention causal
    flash_shapes.append(dict(
        row="flash_fwd_predictor", launches=pred_launches["flash_fwd"],
        shape="q/k/v [%d,%d,%d,%d]: Predictor.run of the saved inference "
        "program (key mask: encoder self, cross; causal: decoder self)"
        % (PRED_BATCH, N_HEAD, MAX_LEN, D_MODEL // N_HEAD),
        launches_of="the predictor phase's %d timed runs; not timed"
        % PRED_RUNS, ms=None, plain_ms=None, bound_ms=None, bound_by=None,
        library_ms=None))
    flash_total = (both("flash_fwd") + train_launches["flash_fwd"]
                   + pred_launches["flash_fwd"] + switch_launches["flash_fwd"])
    if sum(r["launches"] for r in flash_shapes) != flash_total:
        fail("flash_fwd's launches by shape class %s do not add up to its "
             "%d launches" % ([r["launches"] for r in flash_shapes],
                              flash_total))
    rnn_timing.update(nlp_rnn)
    rnn_timing.update(encdec_timing)
    encdec_launches = book["encdec"]["launches"]["lstm_cell"]
    lstm_shapes = shape_rows(rnn_timing, [
        ("lstm_cell_D%d" % RNN_HID, lstm_infer + lstm_train + lstm_pred),
        ("lstm_cell_D%d_full" % RNN_HID, 0),
        ("lstm_cell_D%d" % RNN_PKG_HID, 0),
        ("lstm_cell_D%d_full" % RNN_PKG_HID, 0),
        ("lstm_cell_mt", mt_launches + mt_beam_launches),
        ("lstm_cell_srl", srl_run["launches"]["lstm_cell"]),
        ("lstm_cell_encdec", encdec_launches + book_beam_launches),
        ("lstm_cell_encdec_full", 0)],
        "the stacked LSTM's training, inference and predictor runs (D 512), "
        "the MT steps and the MT beam generator's timed runs (the MT "
        "shape), the role labeller's timed steps (the srl shape) or the "
        "encoder-decoder's timed steps and the book beam decoder's timed "
        "runs (the encdec shape)")
    gru_shapes = shape_rows(rnn_timing, [
        ("gru_cell_D%d" % RNN_HID, gru_train + gru_pred),
        ("gru_cell_D%d" % RNN_PKG_HID, 0),
        ("gru_cell_crnn", crnn_run["launches"]["gru_cell"])],
        "the stacked GRU's training and predictor runs (D 512) or CRNN's "
        "timed steps (the crnn shape)")
    # the frontend's predict batches: the saved stacked LSTM at the
    # ladder's batch rungs, a shape not timed here
    lstm_shapes.append(dict(
        row="lstm_cell_frontend", launches=fe_launches["lstm_cell"],
        shape="xw [2|4|8,%d,%d], peepholes, lengths %d..%d: the frontend's "
        "predict batches" % (RNN_SEQ, 4 * RNN_HID, RNN_MIN_LEN, RNN_SEQ),
        launches_of="the frontend phase's predict window; not timed",
        ms=None, plain_ms=None, bound_ms=None, bound_by=None,
        library_ms=None))
    # threefry: the train steps' dropout masks, the sampled serving
    # windows' Gumbel draws, the captured dropout program and the
    # graph-data ResNet steps
    sampled_total = sum(r["threefry"] for r in sampled_launches.values())
    drop_site = (train_launches["threefry"] + drop_capture_launches
                 + amp_train["launches"]["threefry"])
    data_draws = (graph_data_launches["threefry"]
                  + amp_graph_launches["threefry"])
    threefry_total = (drop_site + sampled_total + data_draws
                      + switch_launches["threefry"])
    threefry_shapes = shape_rows(rng_timing, [
        ("threefry", drop_site), ("threefry_sampler", sampled_total),
        ("threefry_graph_data", data_draws),
        ("threefry_switch", switch_launches["threefry"])],
        "the training phases' timed steps (fp32 and AMP) and the captured "
        "dropout program (the dropout site), the sampled serving windows "
        "(the sampler's draw), the graph-data ResNet-50 phases' timed "
        "steps, fp32 and AMP (random_data_generator's three draws: ms and "
        "bound are a step's three launches), or the switch phase's timed "
        "steps (%d dropout sites a step), counted by the wrapper where it "
        "launches" % (2 * SW_LAYERS))
    for r in threefry_shapes:
        r["other_generator_ms"] = rng_timing[r["row"]]["philox_ms"]

    def amp_record(name, source, line, row, launches_of):
        """A bf16 entry: its numbers at the AMP train step's key-mask
        shape and, per timed shape, the AMP steps' launches at it."""
        t = amp_timing[row]
        base = row[:-len("_train")] if row.endswith("_train") else row
        launches = amp_train["launches"]
        names = ([(row, launches.get(name + "/full", 0)),
                  (row + "_causal", launches.get(name + "/causal", 0))]
                 + ([(base + "_encoder", 0)] if name == "flash_fwd_bf16"
                    else []))
        shapes = shape_rows(amp_timing, names, launches_of)
        if sum(r["launches"] for r in shapes) != launches[name]:
            fail("%s's launches by shape class %s do not add up to its %d "
                 "launches" % (name, [r["launches"] for r in shapes],
                               launches[name]))
        return dict(name=name, route="cuda",
                    source="paddle_tpu_torch/csrc/%s" % source,
                    replaces="paddle_tpu/kernels/flash_attention.py:%d"
                    % line, entry="bf16", launches=launches[name],
                    max_abs_err=amp_worst[name], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                    bound_by=t["bound"][1], library_ms=t["library_ms"],
                    shapes=shapes)

    def det_record(name, loop):
        """A detection kernel (the port's own): its numbers on the SSD
        eval head's own inputs, its launches in the ssd phase (train
        steps and eval head)."""
        t = ssd_run["timing"][name]
        return dict(name=name, route="cuda",
                    source="paddle_tpu_torch/csrc/detection.cu",
                    replaces="none: the port's own kernel (%s)" % loop,
                    launches=ssd_run["launches"][name],
                    max_abs_err=worst[name], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                    bound_by=t["bound"][1], library_ms=None,
                    shape=t["shape"])

    def nlp_record(name, source, loop, launches, err_kind):
        """One of the port's own CRF / CTC kernels: its numbers at the
        role labeller's or CRNN's shape, its launches in the srl or crnn
        phase (timed steps, and the decode)."""
        t = nlp_time[name]
        return dict(name=name, route="cuda",
                    source="paddle_tpu_torch/csrc/%s" % source,
                    replaces="none: the port's own kernel (%s)" % loop,
                    launches=launches, max_abs_err=worst[name],
                    err_kind=err_kind, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound"][0], bound_by=t["bound"][1],
                    library_ms=t["library_ms"], shape=t["shape"])

    amp_of = ("the AMP training phase's timed steps at this shape class, "
              "counted by the wrapper where it launches")
    record = {"kernels": [
        dict(name="flash_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_fwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:91",
             # the serving, speculative, training and Switch runs'
             # launches
             launches=flash_total,
             max_abs_err=worst["flash_fwd"],
             ms=timing["flash_fwd"]["ms"],
             plain_ms=timing["flash_fwd"]["plain_ms"],
             bound_ms=timing["flash_fwd"]["bound"][0],
             bound_by=timing["flash_fwd"]["bound"][1],
             library_ms=timing["flash_fwd"]["library_ms"],
             shapes=flash_shapes),
        bwd_record("flash_bwd_dkv", 302),
        bwd_record("flash_bwd_dq", 376),
        dict(name="paged_decode", route="cuda",
             source="paddle_tpu_torch/csrc/paged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:184",
             launches=both("paged_decode"),
             max_abs_err=worst["paged_decode"],
             ms=timing["paged_decode"]["ms"],
             plain_ms=timing["paged_decode"]["plain_ms"],
             bound_ms=timing["paged_decode"]["bound"][0],
             bound_by=timing["paged_decode"]["bound"][1],
             library_ms=None,
             shapes=shape_rows(timing, [
                 ("paged_decode", 0), ("paged_decode_ragged", 0),
                 ("paged_decode_beam", beam_launches["paged_decode"]
                  + beam_wire_launches["paged_decode"])],
                 "the beam_serve and beam_wire request windows (8 lanes of "
                 "4 hypotheses sharing their parents' pages), counted by "
                 "the wrapper where it launches")),
        dict(name="tree_decode", route="cuda",
             source="paddle_tpu_torch/csrc/tree_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:386",
             launches=spec_launches["tree_decode"],
             max_abs_err=worst["tree_decode"],
             ms=timing["tree_decode"]["ms"],
             plain_ms=timing["tree_decode"]["plain_ms"],
             bound_ms=timing["tree_decode"]["bound"][0],
             bound_by=timing["tree_decode"]["bound"][1],
             library_ms=None),
        # the stacked LSTM's inference, training and predictor runs and
        # the MT steps
        dict(rnn_record("lstm_cell", "lstm_cell.py", 94,
                        lstm_infer + lstm_train + lstm_pred + mt_launches
                        + fe_launches["lstm_cell"]
                        + srl_run["launches"]["lstm_cell"]
                        + encdec_launches + mt_beam_launches
                        + book_beam_launches),
             shapes=lstm_shapes),
        dict(rnn_record("gru_cell", "gru_cell.py", 55,
                        gru_train + gru_pred
                        + crnn_run["launches"]["gru_cell"]),
             shapes=gru_shapes),
        dict(name="threefry", route="cuda",
             source="paddle_tpu_torch/csrc/threefry.cu",
             replaces="none: the port's own kernel (jax's threefry2x32 "
             "stream, which XLA fuses for the JAX package)",
             launches=threefry_total, max_abs_err=worst["threefry"],
             ms=rng_timing["threefry"]["ms"],
             plain_ms=rng_timing["threefry"]["plain_ms"],
             bound_ms=rng_timing["threefry"]["bound"][0],
             bound_by=rng_timing["threefry"]["bound"][1],
             library_ms=None,
             other_generator_ms=rng_timing["threefry"]["philox_ms"],
             shapes=threefry_shapes),
        amp_record("flash_fwd_bf16", "flash_fwd_bf16.cu", 91,
                   "flash_fwd_bf16_train", amp_of),
        amp_record("flash_bwd_dkv_bf16", "flash_bwd_dkv_bf16.cu", 302,
                   "flash_bwd_dkv_bf16", amp_of),
        amp_record("flash_bwd_dq_bf16", "flash_bwd_dq_bf16.cu", 376,
                   "flash_bwd_dq_bf16", amp_of),
        det_record("greedy_nms", "the greedy NMS of multiclass_nms and "
                   "generate_proposals, lax.fori_loops inside the JAX "
                   "package's executable: paddle_tpu/ops/detection_ops.py:"
                   "343-371 and :941-955"),
        det_record("det_match", "detection_map's greedy match, a "
                   "lax.fori_loop inside the JAX package's executable: "
                   "paddle_tpu/ops/detection_ops.py:1037-1067"),
        nlp_record("crf_logz", "crf.cu", "linear_chain_crf's forward "
                   "recursion, a lax.scan inside the JAX package's "
                   "executable: paddle_tpu/ops/crf_ops.py:44-55",
                   srl_run["launches"]["crf_logz"],
                   "relative to the largest alpha or log Z"),
        nlp_record("crf_logz_bwd", "crf.cu", "the gradient of that "
                   "recursion, jax.vjp over the scan there: the beta "
                   "recursion and the marginals",
                   srl_run["launches"]["crf_logz_bwd"],
                   "relative to the largest gradient entry"),
        nlp_record("crf_viterbi", "crf.cu", "crf_decoding's Viterbi "
                   "recursion and backtrack, lax.scans there: "
                   "paddle_tpu/ops/crf_ops.py:107-137",
                   srl_run["launches"]["crf_viterbi"],
                   "0: the paths are equal"),
        nlp_record("ctc_loss", "ctc.cu", "warpctc's alpha lattice, a "
                   "lax.scan there, and its jax.vjp: "
                   "paddle_tpu/ops/ctc_ops.py:63-94",
                   crnn_run["launches"]["ctc_loss"],
                   "absolute, dLogits"),
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

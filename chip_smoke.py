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
   batches and widths; runs a full
   [B, H, T, S] mask (GQA, a window, a fully masked row) through
   ``flash_attention`` on the card and on the CPU (``attention_reference``
   on both, no kernel launch; forward and gradients within 1e-4); then times
   kernel, plain version and (where one exists) the one-call PyTorch
   equivalent: device time per call, from CUDA events around replays of
   a CUDA graph of 30 calls (no host launch cost in the time) that cycle
   through input copies larger than the L2 cache; the library time of the
   backward pair (autograd's backward of ``scaled_dot_product_attention``
   with the key mask, or ``is_causal``, which a graph cannot hold) from
   CUDA events around 30 eager calls, each far longer than its launch.
   The backward pair's bounds are printed two ways: at the split-TF32
   rate of the tensor cores (a third of 495 TFLOP/s, what its kernels
   compute at; the ``bound_ms`` of its record) and at 67 TFLOP/s fp32.
   B1's rows path and B5 are also timed at two splits each (``split``
   lines): where their plans split the keys (one sequence, 4 slots)
   against one split, and at the main shapes (one split) against three;
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
   hit. ``dense``: the requests without prefixes through ``paged=False``
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
   gates on finite losses, a loss that falls by 0.1 nat, and 18 launches
   of each backward kernel and 36 of the forward per step, reads each
   flash kernel's launches by shape class (key mask or causal) from the
   counts its wrapper keeps, and profiles one more step (device time by
   kernel, device busy share);
9. trains 3 Adam steps of the same model (dropout 0, batch 4,
   ``set_deterministic_params`` weights) on the card and on the CPU and
   gates on each step's loss; the first step's gradients are compared and
   printed;
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
   steps, gating on finite losses, a 0.1 nat fall and 6 lstm_cell
   launches per step (each layer's forward and its rerun in the grad op),
   profiles one step, runs the trained model's ``clone(for_test=True)``
   program 10 times (3 launches per run), trains the same network with
   ``dynamic_gru`` (6 gru_cell launches per step), runs 5 steps of the
   machine-translation graph at ``build()``'s defaults (4 lstm_cell
   launches per step), and compares the stacked LSTM's predictions (1e-4)
   and 3 train losses (1e-3) on the card and on the CPU;
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

A line of its own before the last holds the kernels' JSON record (for
flash_fwd, the backward pair, paged_decode (full occupancy and the
serving mix of lengths) and lstm_cell also every timed shape: ms,
bound, plain and library ms, and the main path's launches at that
shape; flash_fwd's predictor runs have a row of their own); the
last line is ``{"ok": true, "device": {...}}``. Any failure exits nonzero
before that line. The script needs one CUDA card and the rest of the
repository beside it: without either it fails at once.
"""

import contextlib
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


def kernel_symbol(line):
    """A kernel's name and template arguments from a ptxas "Compiling
    entry function '<mangled>'" line (lstm_cell_kernel<4, true, true>)."""
    import re

    m = re.search(r"\d+([a-z_]+_kernel)(?:I(.*?)E)?E", line)
    if not m:
        return line.strip()[:120]
    args = re.findall(r"L([ib])(\d+)E", (m.group(2) or "") + "E")
    shown = ", ".join(v if t == "i" else ("true" if v == "1" else "false")
                      for t, v in args)
    return "%s<%s>" % (m.group(1), shown) if shown else m.group(1)


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
    a CUDA graph cannot hold the call (autograd's backward)."""
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


def device_ms(torch, fn, inputs, iters=10):
    """Device milliseconds per call of ``fn(i)``: the time of its kernels,
    summed from a torch.profiler trace of ``iters`` calls cycling through
    ``inputs`` (after one warm-up call on each), so the host's launch
    cost does not enter it. For a library call with many launches that a
    CUDA graph may not hold (cuDNN's LSTM). A trace can come back with
    no device event; it is taken once more, and a second empty one
    fails the run rather than report a time of 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(len(inputs)):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for j in range(iters):
                fn(j % len(inputs))
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        if busy_us > 0:
            return busy_us / 1e3 / iters
        print("device_ms: a profiler trace held no device event; tracing "
              "again")
    fail("device_ms: two profiler traces held no device event")


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
    worst = {"flash_fwd": 0.0, "paged_decode": 0.0, "tree_decode": 0.0}
    limits = device_limits("cuda")
    for name, kw in flash_cases(torch, gen) + flash_tile_cases(torch, gen):
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
    # the backward pair at the train step's shapes, at B1's edge cases
    # (decode's T=1 shape included) and multi-row tile cases, plus T != S
    dev = "cuda"
    t_ne_s = dict(q=torch.randn(2, 4, 19, 64, generator=gen, device=dev),
                  k=torch.randn(2, 4, 37, 64, generator=gen, device=dev),
                  v=torch.randn(2, 4, 37, 64, generator=gen, device=dev),
                  kv_mask=(torch.arange(37, device=dev)[None, :]
                           < torch.tensor([[37], [5]], device=dev)).float())
    worst["flash_bwd_dkv"] = worst["flash_bwd_dq"] = 0.0
    for name, kw in (train_flash_cases(torch, gen) + flash_cases(torch, gen)
                     + flash_tile_cases(torch, gen)
                     + [("T19_S37_masked", t_ne_s)]):
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
                fail("flash_bwd_dkv %s: a masked key's dk/dv is not exactly "
                     "0" % name)
        e_kv = max((dk - rk).abs().max().item(), (dv - rv).abs().max().item())
        e_q = (dq - rq).abs().max().item()
        print("kernel flash_bwd_dkv/dq %-19s max_abs_err %.3e / %.3e  tol "
              "%.0e  dead_rows %d" % (name, e_kv, e_q, K1_TOL,
                                      int(dead.sum())))
        if not (e_kv <= K1_TOL and e_q <= K1_TOL):
            fail("flash_bwd %s: error %.3e / %.3e above %.0e"
                 % (name, e_kv, e_q, K1_TOL))
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], e_kv)
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], e_q)
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
    return worst


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
    on the same fp32 inputs, key mask (or ``is_causal``) and output
    gradient as the kernels: ``torch.autograd.grad`` of a forward run
    once, timed eagerly."""
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

    return backend, eager_ms(call, ins)


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

    # B1, B2, B3 at the train step's shape, [64,8,256,64], with the
    # source key mask (12 of a step's 18 attention calls); work and bytes
    # count the valid keys only
    tcases = dict(train_flash_cases(torch, gen))
    kw_t = copies(tcases["train_self_masked"])
    B, T = TRAIN_BATCH, MAX_LEN
    vis = float(kw_t[0]["kv_mask"].sum())  # valid keys, summed over batch
    qbytes = 4.0 * B * N_HEAD * T * dh      # one [B,H,T,d] tensor
    kvbytes = 4.0 * vis * N_HEAD * dh       # the valid rows of k (or v)
    rowbytes = 4.0 * B * N_HEAD * T         # lse or delta
    mbytes = 4.0 * B * T
    shape_t = "q/k/v [%d,%d,%d,%d], key mask (%d of %d keys valid)" % (
        B, N_HEAD, T, dh, vis, B * T)
    rows["flash_fwd_train"] = dict(
        shape=shape_t, ms=cuda_ms(fa.flash_forward, kw_t),
        plain_ms=cuda_ms(fa.flash_forward_plain, kw_t),
        library_ms=cuda_ms(F.scaled_dot_product_attention,
                           sdpa_inputs(kw_t)),
        bound=bound(2 * qbytes + 2 * kvbytes + rowbytes + mbytes,
                    4.0 * T * vis * N_HEAD * dh))

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
        bound=bound(4 * qbytes + rowbytes, 4.0 * pairs_c * dh))

    def bwd_rows(suffix, cases, pairs, shape):
        """dkv and dq rows for one set of inputs; ``pairs`` counts the
        visible (query, key) pairs over batch and heads."""
        bwd = [bwd_inputs(torch, fa, c, gen) for c in cases]
        for a in bwd:
            a["delta"] = (a["dout"] * a["out"]).sum(dim=-1)
        kern = [dict(q=a["q"], k=a["k"], v=a["v"], kv_mask=a["kv_mask"],
                     dout=a["dout"], lse=a["lse"], delta=a["delta"],
                     causal=a["causal"], sm_scale=dh ** -0.5) for a in bwd]
        plain = [{n: a[n] for n in ("q", "k", "v", "kv_mask", "out", "lse",
                                     "dout", "causal")} for a in bwd]
        plain_ms = cuda_ms(fa.flash_backward_plain, plain)
        backend, lib_ms = sdpa_backward_ms(torch, F, bwd)
        kvb = 4.0 * dh * (pairs / T if not bwd[0]["causal"]
                          else B * N_HEAD * T)  # k/v rows read, each
        mb = mbytes if bwd[0]["kv_mask"] is not None else 0.0
        # bytes and operations of each: B2 reads q, dO, k, v, lse, delta
        # (and the mask) and writes dk, dv, 8 flops per (pair, column); B3
        # writes dq, 6 flops. Bound at the split-TF32 tensor-core rate,
        # and beside it at the fp32 rate of the CUDA cores
        for name, nbytes, flops in (
                ("flash_bwd_dkv", 4 * qbytes + 2 * kvb + 2 * rowbytes + mb,
                 8.0 * pairs * dh),
                ("flash_bwd_dq", 3 * qbytes + 2 * kvb + 2 * rowbytes + mb,
                 6.0 * pairs * dh)):
            rows[name + suffix] = dict(
                shape=shape, ms=cuda_ms(getattr(fa, name), kern),
                plain_ms=plain_ms, library_ms=lib_ms, backend=backend,
                bound=bound(nbytes, flops, PEAK_TF32X3_FLOPS),
                bound_fp32=bound(nbytes, flops))

    bwd_rows("", kw_t, T * vis * N_HEAD, shape_t)
    bwd_rows("_causal", copies(tcases["train_causal"]),
             B * N_HEAD * T * (T + 1) / 2.0,
             "q/k/v [%d,%d,%d,%d], causal" % (B, N_HEAD, T, dh))
    return rows


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


def kernel_counts(kernels):
    """Every kernel's launch count since its reset and, beside them, the
    flash kernels' by shape class (``flash_fwd/decode`` T = 1,
    ``/verify`` T <= 4, else ``/causal`` or ``/full``; the same for
    ``flash_bwd_dkv`` and ``flash_bwd_dq``) from the counts their
    wrappers keep by (T, causal) where they launch."""
    out = {name: k.launches for name, k in kernels.items()}
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        for (t, causal), n in sorted(kernels[name].by_key.items()):
            label = name + "/" + ("decode" if t == 1 else "verify" if t <= 4
                                  else "causal" if causal else "full")
            out[label] = out.get(label, 0) + n
    return out


# -- session phases -------------------------------------------------------------

def build_model(fluid, exe, scope):
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.testing import set_deterministic_params

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard({}), fluid.program_guard(main, startup):
        transformer.build(src_vocab_size=VOCAB, trg_vocab_size=VOCAB,
                          max_length=MAX_LEN, n_layer=N_LAYER, n_head=N_HEAD,
                          d_model=D_MODEL, d_inner=D_INNER, dropout=0.0,
                          label_smooth_eps=0.0)
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope)
    return main


def session(exe, scope, num_slots):
    from paddle_tpu_torch.serving.generation import SlotDecodeSession

    return SlotDecodeSession(
        exe, num_slots=num_slots, max_length=MAX_LEN, d_model=D_MODEL,
        paged=True, page_size=PAGE_SIZE, steps=STEPS, eos_id=EOS,
        scope=scope, src_vocab_size=VOCAB, trg_vocab_size=VOCAB,
        n_layer=N_LAYER, n_head=N_HEAD, d_inner=D_INNER)


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


def paged_run(np, torch, exe, scope, kernels, reqs, label):
    """Serve ``reqs`` through a fresh paged session (steps 8) in a child
    scope, counts reset just before (``run_requests``). Prints one line;
    returns the run's numbers."""
    src, lens, prefixes = reqs
    sess = session(exe, scope.new_scope(), NUM_SLOTS)
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

def spec_session(exe, scope, num_slots, drafter):
    from paddle_tpu_torch.serving.generation import SlotDecodeSession

    return SlotDecodeSession(
        exe, num_slots=num_slots, max_length=MAX_LEN, d_model=D_MODEL,
        paged=True, page_size=PAGE_SIZE, steps=1, eos_id=EOS, scope=scope,
        speculative={"k": SPEC_K, "drafter": drafter}, src_vocab_size=VOCAB,
        trg_vocab_size=VOCAB, n_layer=N_LAYER, n_head=N_HEAD,
        d_inner=D_INNER)


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
             mode="on", replay_streams=None, num_slots=None):
    """One speculative session over ``reqs`` under FLAGS_speculative =
    ``mode``; prints its lines, checks its gates, returns (tokens,
    launches, the session)."""
    src, lens, prefixes = reqs
    num_slots = num_slots or NUM_SLOTS
    flags.set_flag("speculative", mode)
    sess = spec_session(exe, scope.new_scope(), num_slots, drafter)
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

def build_train(fluid, dropout):
    """Transformer-base's train program as bench.py:240-266 builds it:
    (main, startup, loss, [(param, grad)])."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = TRAIN_SEED
    with unique_name.guard({}), fluid.program_guard(main, startup):
        loss, _, _ = transformer.build(
            src_vocab_size=VOCAB, trg_vocab_size=VOCAB, max_length=MAX_LEN,
            n_layer=N_LAYER, n_head=N_HEAD, d_model=D_MODEL,
            d_inner=D_INNER, dropout=dropout, label_smooth_eps=LABEL_SMOOTH)
        _, params_grads = fluid.optimizer.Adam(
            learning_rate=LR).minimize(loss)
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
    """``fn()`` under torch.profiler: prints its wall time, the device's
    busy share of it and the device time by kernel (the ``top`` largest);
    returns (wall ms, device busy ms), or None where the trace holds no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels themselves (CPU-side ops also carry their kernels' time)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print("%s profile: no device time in the trace (not measured)"
              % label)
        return None
    print("%s profile: wall %.1f ms under the profiler, device busy %.2f ms "
          "(%.1f %%), %d kernel launches"
          % (label, wall_ms, busy_ms, 100.0 * busy_ms / wall_ms,
             sum(e.count for e in events)))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print("%s profile: %8.3f ms %5d calls  %s"
              % (label, e.self_device_time_total / 1e3, e.count, e.key[:90]))
    return wall_ms, busy_ms


def train_phase(np, torch, fluid, exe, kernels):
    main, startup, loss, _ = build_train(fluid, DROPOUT)
    ops = main.global_block().ops
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    print("train: Transformer-base program of %d ops (%d startup ops), %.1f M "
          "parameters, batch %d x %d, dropout %.1f, label smoothing %.1f, "
          "Adam(%g)" % (len(ops), len(startup.global_block().ops),
                        n_params / 1e6, TRAIN_BATCH, MAX_LEN, DROPOUT,
                        LABEL_SMOOTH, LR))
    feed = train_feed(np, TRAIN_BATCH)
    dec_tokens = int(feed["trg_len"].sum())
    for _ in range(TRAIN_WARMUP):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    for k in kernels.values():
        k.reset()
    losses, step_ms, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        before = [kernels[n].launches for n in names]
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        per_step.append(tuple(kernels[n].launches - b
                              for n, b in zip(names, before)))
        print("train step %2d: loss %.6f  wall %.1f ms  launches %s"
              % (i + 1, losses[-1], step_ms[-1], dict(zip(names,
                                                          per_step[-1]))))
    launches = kernel_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    mean_ms = float(np.mean(step_ms))
    print("train: %d steps, mean %.1f ms/step (min %.1f, max %.1f), %d "
          "decoder tokens per step (non-pad): %.0f decoder tokens/s; peak "
          "memory %.2f GiB" % (TRAIN_STEPS, mean_ms, min(step_ms),
                               max(step_ms), dec_tokens,
                               dec_tokens / mean_ms * 1e3, peak / 2 ** 30))
    print("train: kernel launches over the %d steps %s"
          % (TRAIN_STEPS, json.dumps(launches)))
    if not np.isfinite(losses).all():
        fail("a train loss is not finite: %s" % losses)
    n_attn = 3 * N_LAYER
    if any(c != (2 * n_attn, n_attn, n_attn) for c in per_step):
        fail("per-step launches %s, expected flash_fwd %d, flash_bwd_dkv %d, "
             "flash_bwd_dq %d" % (per_step, 2 * n_attn, n_attn, n_attn))
    late = float(np.mean(losses[15:20]))
    print("train: loss step 1 %.6f, mean of steps 16-20 %.6f (gate: %.1f "
          "nat lower)" % (losses[0], late, LOSS_DROP))
    if not late <= losses[0] - LOSS_DROP:
        fail("the train loss did not fall by %.1f nat" % LOSS_DROP)
    profile_call(torch, "train", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope))
    return launches


def train_card_vs_cpu_phase(np, torch, fluid, exe):
    from paddle_tpu_torch.testing import set_deterministic_params

    main, startup, loss, params_grads = build_train(fluid, 0.0)
    feed = {k: v[:CVC_BATCH] for k, v in train_feed(np, TRAIN_BATCH).items()}
    grad_names = [g.name for _, g in params_grads]
    losses, grads = {}, {}
    for dev, ex in (("card", exe), ("cpu", fluid.Executor(fluid.CPUPlace()))):
        scope = fluid.Scope()
        ex.run(startup, scope=scope)
        set_deterministic_params(main, scope, parameters_only=True)
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
    step) and 2 x 3 launches of the cell's kernel per step.
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
    if any(c != 2 * RNN_STACK for c in per_step):
        fail("%s per-step launches %s, expected 2 x %d (each layer's "
             "forward and its rerun inside the grad op)"
             % (kname, per_step, RNN_STACK))
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
    Adam steps: 4 lstm_cell launches per step (the forward and the
    reverse encoder pass, each rerun inside its grad op)."""
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
    if not np.isfinite(losses).all():
        fail("a machine-translation loss is not finite: %s" % losses)
    if any(c != 4 for c in per_step):
        fail("lstm_cell launched %s times per MT step, expected 4"
             % per_step)
    return launches


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
                        outs, feed):
    """The trained stacked network's inference program, saved and served
    through ``NativeConfig`` and ``AnalysisConfig`` on the card:
    predictions within 1e-5 of each other, stacked_num launches of the
    cell's kernel per run, predictions/s over windows that alternate
    between the two configs. Returns the timed runs' launches of the
    kernel."""
    import tempfile

    from paddle_tpu_torch.inference import (
        AnalysisConfig,
        NativeConfig,
        create_paddle_predictor,
    )

    kname = "lstm_cell" if cell == "lstm" else "gru_cell"
    feed = {"words": feed["words"], "length": feed["length"]}
    with tempfile.TemporaryDirectory() as tmp:
        fluid.io.save_inference_model(tmp, list(feed), [outs["predict"]],
                                      exe, main_program=infer, scope=scope)
        preds = [("NativeConfig", create_paddle_predictor(NativeConfig(tmp))),
                 ("AnalysisConfig",
                  create_paddle_predictor(AnalysisConfig(tmp)))]
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
    card = card_line()
    kind = torch.cuda.get_device_name(0)
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

    worst = kernel_phase(torch)
    full_mask_phase(torch)
    timing = timing_phase(torch)
    for name in ("flash_fwd", "flash_fwd_verify", "flash_fwd_encoder",
                 "paged_decode", "paged_decode_ragged", "tree_decode", "flash_fwd_train",
                 "flash_fwd_train_causal", "flash_bwd_dkv", "flash_bwd_dq",
                 "flash_bwd_dkv_causal", "flash_bwd_dq_causal"):
        r = timing[name]
        lib = ("%.4f ms" % r["library_ms"] if r["library_ms"] is not None
               else "none")
        if r.get("backend"):
            lib += " (backward of scaled_dot_product_attention, backend %s)" \
                % r["backend"]
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
    for kname in ("lstm_cell", "gru_cell"):
        for D in (RNN_HID, RNN_PKG_HID):
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
    exe = fluid.Executor()  # the card: CUDAPlace(0)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    main_prog = build_model(fluid, exe, scope)
    print("model: Transformer-base weights ready in %.1f s"
          % (time.perf_counter() - t0))
    served = serve_phase(np, torch, exe, scope, KERNELS)
    launches = served["launches"]
    graph_launches = graph_phase(np, torch, exe, scope, KERNELS, served)
    served = None
    prefix_launches = prefix_phase(np, torch, exe, scope, KERNELS)
    dense_launches = dense_phase(np, torch, exe, scope, KERNELS)
    card_vs_cpu_phase(np, torch, fluid, exe, scope, main_prog)
    spec_launches = speculative_phase(np, torch, fluid, exe, scope, KERNELS)
    spec_card_vs_cpu_phase(np, torch, fluid, exe, scope, main_prog)
    scope = main_prog = None
    torch.cuda.empty_cache()
    train_launches = train_phase(np, torch, fluid, exe, KERNELS)
    train_card_vs_cpu_phase(np, torch, fluid, exe)
    torch.cuda.empty_cache()
    mnist_predictor_phase(np)
    pred_launches = transformer_predictor_phase(np, torch, fluid, exe,
                                                KERNELS)
    torch.cuda.empty_cache()
    lstm_train, scope, infer, outs, feed = rnn_train_phase(
        np, torch, fluid, exe, KERNELS, "lstm")
    lstm_infer = rnn_infer_phase(np, torch, exe, KERNELS, scope, infer, outs,
                                 feed)
    lstm_pred = rnn_predictor_phase(np, torch, fluid, exe, KERNELS, "lstm",
                                    scope, infer, outs, feed)
    gru_train, scope, infer, outs, feed = rnn_train_phase(
        np, torch, fluid, exe, KERNELS, "gru")
    gru_pred = rnn_predictor_phase(np, torch, fluid, exe, KERNELS, "gru",
                                   scope, infer, outs, feed)
    scope = None
    mt_launches = mt_phase(np, torch, fluid, exe, KERNELS)
    rnn_card_vs_cpu_phase(np, torch, fluid, exe)

    def bwd_record(name, line):
        """B2 or B3: the key-mask shape's numbers (bound at the split-TF32
        rate, ``bound_fp32_ms`` at the CUDA cores'), and per shape the
        train steps' launches at it, read from the wrapper's counts."""
        t = timing[name]
        shapes = shape_rows(timing, [
            (name, train_launches.get(name + "/full", 0)),
            (name + "_causal", train_launches.get(name + "/causal", 0))],
            "the training phase's timed steps at this shape class, "
            "counted by the wrapper where it launches")
        if sum(r["launches"] for r in shapes) != train_launches[name]:
            fail("%s's launches by shape class %s do not add up to its %d "
                 "launches" % (name, [r["launches"] for r in shapes],
                               train_launches[name]))
        for r in shapes:
            r["bound_fp32_ms"] = timing[r["row"]]["bound_fp32"][0]
        return dict(name=name, route="cuda",
                    source="paddle_tpu_torch/csrc/flash_bwd.cu",
                    replaces="paddle_tpu/kernels/flash_attention.py:%d" % line,
                    launches=train_launches[name], max_abs_err=worst[name],
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
               spec_launches)

    def both(label):
        """The launches at ``label`` over every serving window."""
        return sum(r.get(label, 0) for r in serving)

    flash_shapes = shape_rows(timing, [
        ("flash_fwd", both("flash_fwd/decode")),
        ("flash_fwd_verify", both("flash_fwd/verify")),
        ("flash_fwd_encoder", both("flash_fwd/full")),
        ("flash_fwd_train", train_launches.get("flash_fwd/full", 0)),
        ("flash_fwd_train_causal", train_launches.get("flash_fwd/causal",
                                                      0))],
        "the launches at this shape class in the serving runs' request "
        "windows (captured, eager, prefix cache, dense, speculative) or the "
        "training phase's timed steps, counted by the wrapper where it "
        "launches")
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
                   + pred_launches["flash_fwd"])
    if sum(r["launches"] for r in flash_shapes) != flash_total:
        fail("flash_fwd's launches by shape class %s do not add up to its "
             "%d launches" % ([r["launches"] for r in flash_shapes],
                              flash_total))
    lstm_shapes = shape_rows(rnn_timing, [
        ("lstm_cell_D%d" % RNN_HID, lstm_infer + lstm_train + lstm_pred),
        ("lstm_cell_D%d_full" % RNN_HID, 0),
        ("lstm_cell_D%d" % RNN_PKG_HID, 0),
        ("lstm_cell_D%d_full" % RNN_PKG_HID, 0),
        ("lstm_cell_mt", mt_launches)],
        "the stacked LSTM's training, inference and predictor runs (D 512) "
        "or the MT steps (the MT shape)")
    record = {"kernels": [
        dict(name="flash_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_fwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:91",
             # the serving, speculative and training runs' launches
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
             shapes=shape_rows(timing, [("paged_decode", 0),
                                        ("paged_decode_ragged", 0)], "")),
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
                        lstm_infer + lstm_train + lstm_pred + mt_launches),
             shapes=lstm_shapes),
        rnn_record("gru_cell", "gru_cell.py", 55, gru_train + gru_pred),
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

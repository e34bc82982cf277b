#!/usr/bin/env python3
"""Smoke and measurement run of paddle_tpu_torch on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time and
   each kernel's registers and spills;
3. holds each kernel against its plain PyTorch version on the same CUDA
   tensors, at the shapes the serving path gives it and at edge cases,
   printing each case's max abs error beside its tolerance, then times
   kernel, plain version and (where one exists) the one-call PyTorch
   equivalent: device time per call, from CUDA events around replays of
   a CUDA graph of 30 calls (no host launch cost in the time) that cycle
   through input copies larger than the L2 cache;
4. serves 64 greedy requests through ``SlotDecodeSession(paged=True)`` at
   the full width of the Transformer-base configuration (6 layers,
   d_model 512, 8 heads, d_inner 2048, vocab 32000, max_length 256;
   random weights from ``set_deterministic_params``), with each kernel's
   launch count reset just before and read just after, and checks that
   the paged decode kernel ran n_layer times per decode step and the
   page pool drained;
5. serves 4 requests through the same configuration on the card and on
   the CPU (plain versions) and gates on the first decode step's logits;
   token agreement is printed, not gated.

A line of its own before the last holds the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits nonzero
before that line. The script needs one CUDA card and the rest of the
repository beside it: without either it fails at once.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the H100 SXM's published peaks (NVIDIA data sheet): device memory rate
# and dense fp32 rate outside the tensor cores, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# Transformer-base, as the JAX package's bench.py configures it
N_LAYER, N_HEAD, D_MODEL, D_INNER, VOCAB, MAX_LEN = 6, 8, 512, 2048, 32000, 256
NUM_SLOTS, PAGE_SIZE, STEPS, EOS = 32, 16, 8, 0
N_REQUESTS, SEED = 64, 2024

K1_TOL = 1e-4     # fp32 sums over up to 256 keys in another order
K2_TOL = 1e-4
LOGITS_TOL = 1e-3  # fp32 through 6 layers, card against CPU


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


def bound(nbytes, flops):
    """(least ms on the card, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    ]


def paged_case(torch, gen, S, H, dh, ps, lengths):
    """Random pools and a ragged table (page 0 is the trash page, a
    slot's tail aliases its last valid page), as the session lays them
    out."""
    from paddle_tpu_torch.kernels.paged_attention import pages_for

    npp = pages_for(MAX_LEN, ps)
    P = 1 + S * npp
    dev = "cuda"
    k_pool = torch.randn(P, H, ps, dh, generator=gen, device=dev)
    v_pool = torch.randn(P, H, ps, dh, generator=gen, device=dev)
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


def paged_cases(torch, gen):
    dh = D_MODEL // N_HEAD
    rng_lens = torch.randint(0, MAX_LEN + 1, (NUM_SLOTS,),
                             generator=torch.Generator().manual_seed(7))
    ragged = [int(x) for x in rng_lens]
    ragged[3] = 0
    ragged[5] = 17
    return [
        ("full_occupancy_ps16",
         paged_case(torch, gen, NUM_SLOTS, N_HEAD, dh, 16,
                    [MAX_LEN] * NUM_SLOTS)),
        ("ragged_ps16", paged_case(torch, gen, NUM_SLOTS, N_HEAD, dh, 16,
                                   ragged)),
        ("ragged_ps3", paged_case(torch, gen, 9, 4, dh, 3,
                                  [0, 1, 2, 3, 4, 29, 100, 255, 256])),
        ("ragged_ps4_dh128", paged_case(torch, gen, 5, 2, 128, 4,
                                        [7, 1, 0, 13, 30])),
    ]


def kernel_phase(torch):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"flash_fwd": 0.0, "paged_decode": 0.0}
    for name, kw in flash_cases(torch, gen):
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
    for name, kw in paged_cases(torch, gen):
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
    return worst


def timing_phase(torch):
    """Kernel, plain version and library times at the serving shapes."""
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
    # K2 at full occupancy: 32 slots x 256 resident tokens
    kw2 = copies(dict(paged_cases(torch, gen))["full_occupancy_ps16"])
    acc = pa.grid_accounting(kw2[0]["lengths"].tolist(), PAGE_SIZE, N_HEAD,
                             dh, MAX_LEN)
    table_bytes = 8 * acc["valid_pages"] + 8 * NUM_SLOTS
    rows["paged_decode"] = dict(
        shape="%d slots x %d tokens, H %d, dh %d, page_size %d"
        % (NUM_SLOTS, MAX_LEN, N_HEAD, dh, PAGE_SIZE),
        ms=cuda_ms(pa.paged_attention, kw2),
        plain_ms=cuda_ms(pa.paged_attention_plain, kw2),
        library_ms=None,
        bound=bound(acc["hbm_bytes"] + table_bytes,
                    4.0 * acc["resident_tokens"] * N_HEAD * dh))
    # the group gather ahead of every cross-attention call (k_pool[gof])
    pools = copies(dict(input=torch.randn(
        NUM_SLOTS, N_HEAD, MAX_LEN, dh, generator=gen, device="cuda"),
        dim=0, index=torch.randperm(NUM_SLOTS, device="cuda")))
    rows["gather_k_pool_gof_ms"] = cuda_ms(torch.index_select, pools)
    return rows


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


def serve_phase(np, torch, exe, scope, kernels):
    src, lens, prefixes = requests(np)
    sess = session(exe, scope, NUM_SLOTS)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    order = {sess.enqueue(src[i], lens[i], prefixes[i]): i
             for i in range(N_REQUESTS)}
    out = np.full((N_REQUESTS, MAX_LEN), EOS, dtype="int64")
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
    launches = {name: k.launches for name, k in kernels.items()}
    n_prefix = sum(p is not None for p in prefixes)
    generated = sum(generated_tokens(out[i], prefixes[i])
                    for i in range(N_REQUESTS))
    print("session: %d requests, %d slots, page_size %d, steps %d: wall %.3f s, "
          "%d decode steps in %d step() calls, %d tokens, decode %.1f tokens/s"
          % (N_REQUESTS, NUM_SLOTS, PAGE_SIZE, STEPS, wall, sess.decode_steps,
             sess.steps_done, generated, generated / wall))
    print("session: kernel launches %s" % json.dumps(launches))
    print("session: page pool peak %d of %d pages in use; after drain %d in "
          "use, conserved %s" % (peak_pages, sess.free_pages +
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
    return launches


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
        if "registers" in line or "spill" in line:
            print("ptxas: " + line.strip())

    worst = kernel_phase(torch)
    timing = timing_phase(torch)
    for name in ("flash_fwd", "flash_fwd_encoder", "paged_decode"):
        r = timing[name]
        print("time %-18s %s: kernel %.4f ms, plain %.4f ms, library %s, "
              "bound %.4f ms (%s)"
              % (name, r["shape"], r["ms"], r["plain_ms"],
                 "%.4f ms" % r["library_ms"] if r["library_ms"] is not None
                 else "none", r["bound"][0], r["bound"][1]))
    print("time gather k_pool[gof] [%d,%d,%d,%d]: %.4f ms"
          % (NUM_SLOTS, N_HEAD, MAX_LEN, D_MODEL // N_HEAD,
             timing["gather_k_pool_gof_ms"]))

    exe = fluid.Executor()  # the card: CUDAPlace(0)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    main_prog = build_model(fluid, exe, scope)
    print("model: Transformer-base weights ready in %.1f s"
          % (time.perf_counter() - t0))
    launches = serve_phase(np, torch, exe, scope, KERNELS)
    card_vs_cpu_phase(np, torch, fluid, exe, scope, main_prog)

    record = {"kernels": [
        dict(name="flash_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_fwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:91",
             launches=launches["flash_fwd"],
             max_abs_err=worst["flash_fwd"],
             ms=timing["flash_fwd"]["ms"],
             plain_ms=timing["flash_fwd"]["plain_ms"],
             bound_ms=timing["flash_fwd"]["bound"][0],
             bound_by=timing["flash_fwd"]["bound"][1],
             library_ms=timing["flash_fwd"]["library_ms"]),
        dict(name="paged_decode", route="cuda",
             source="paddle_tpu_torch/csrc/paged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:184",
             launches=launches["paged_decode"],
             max_abs_err=worst["paged_decode"],
             ms=timing["paged_decode"]["ms"],
             plain_ms=timing["paged_decode"]["plain_ms"],
             bound_ms=timing["paged_decode"]["bound"][0],
             bound_by=timing["paged_decode"]["bound"][1],
             library_ms=None),
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

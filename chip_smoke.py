#!/usr/bin/env python3
"""Smoke and measurement run of paddle_tpu_torch on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time and
   each kernel's registers and spills;
3. holds each kernel against its plain PyTorch version on the same CUDA
   tensors, at the shapes the serving and training paths give it and at
   edge cases,
   printing each case's max abs error beside its tolerance, then times
   kernel, plain version and (where one exists) the one-call PyTorch
   equivalent: device time per call, from CUDA events around replays of
   a CUDA graph of 30 calls (no host launch cost in the time) that cycle
   through input copies larger than the L2 cache; the library time of the
   backward pair (autograd's backward of ``scaled_dot_product_attention``,
   which a graph cannot hold) from CUDA events around 30 eager calls, each
   far longer than its launch;
4. serves 64 greedy requests through ``SlotDecodeSession(paged=True)`` at
   the full width of the Transformer-base configuration (6 layers,
   d_model 512, 8 heads, d_inner 2048, vocab 32000, max_length 256;
   random weights from ``set_deterministic_params``), with each kernel's
   launch count reset just before and read just after, and checks that
   the paged decode kernel ran n_layer times per decode step and the
   page pool drained;
5. serves 4 requests through the same configuration on the card and on
   the CPU (plain versions) and gates on the first decode step's logits;
   token agreement is printed, not gated;
6. trains the same configuration as the JAX package's bench.py does
   (dropout 0.1, label smoothing 0.1, ``Adam(2e-4)``, random_seed 7,
   batch 64 of ragged lengths, fp32): 2 warm-up steps, then 20 steps with
   each kernel's launch count reset just before and read just after. It
   gates on finite losses, a loss that falls by 0.1 nat, and 18 launches
   of each backward kernel and 36 of the forward per step, and profiles
   one more step (device time by kernel, device busy share);
7. trains 3 Adam steps of the same model (dropout 0, batch 4,
   ``set_deterministic_params`` weights) on the card and on the CPU and
   gates on each step's loss; the first step's gradients are compared and
   printed.

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
import warnings

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

# training, as bench.py:240-266 configures Transformer-base
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_SEED = 64, 2, 20, 7
LR, DROPOUT, LABEL_SMOOTH = 2e-4, 0.1, 0.1
TRAIN_TOKEN_IDS = 1000   # tokens drawn from ids 1..1000 of the vocab
LOSS_DROP = 0.1          # nats: mean of steps 16-20 below step 1
CVC_BATCH, CVC_STEPS = 4, 3
TRAIN_LOSS_TOL = 1e-3    # fp32 losses through 6 layers, card against CPU


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
    # the backward pair at the train step's shapes and at B1's edge cases
    # (decode's T=1 shape included), plus T != S
    dev = "cuda"
    t_ne_s = dict(q=torch.randn(2, 4, 19, 64, generator=gen, device=dev),
                  k=torch.randn(2, 4, 37, 64, generator=gen, device=dev),
                  v=torch.randn(2, 4, 37, 64, generator=gen, device=dev),
                  kv_mask=(torch.arange(37, device=dev)[None, :]
                           < torch.tensor([[37], [5]], device=dev)).float())
    worst["flash_bwd_dkv"] = worst["flash_bwd_dq"] = 0.0
    for name, kw in (train_flash_cases(torch, gen) + flash_cases(torch, gen)
                     + [("T19_S37_masked", t_ne_s)]):
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


def sdpa_backend(torch, F, q, k, v, mask):
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
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        except RuntimeError:
            continue
        return name
    return "none"


def sdpa_backward_ms(torch, F, bwd):
    """(backend, ms) of the backward of ``scaled_dot_product_attention``
    on the same fp32 inputs, key mask and output gradient as the kernels:
    ``torch.autograd.grad`` of a forward run once, timed eagerly."""
    ins = []
    for a in bwd:
        q, k, v = (a[n].detach().requires_grad_() for n in ("q", "k", "v"))
        mask = (a["kv_mask"] > 0)[:, None, None, :]
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        ins.append((out, (q, k, v), a["dout"]))
    q, k, v = ins[0][1]
    backend = sdpa_backend(torch, F, q, k, v,
                           (bwd[0]["kv_mask"] > 0)[:, None, None, :])

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

    def bwd_rows(suffix, cases, pairs, shape, with_library):
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
        backend, lib_ms = (sdpa_backward_ms(torch, F, bwd) if with_library
                           else (None, None))
        kvb = 4.0 * dh * (pairs / T if not bwd[0]["causal"]
                          else B * N_HEAD * T)  # k/v rows read, each
        mb = mbytes if bwd[0]["kv_mask"] is not None else 0.0
        rows["flash_bwd_dkv" + suffix] = dict(
            shape=shape, ms=cuda_ms(fa.flash_bwd_dkv, kern),
            plain_ms=plain_ms, library_ms=lib_ms, backend=backend,
            bound=bound(2 * qbytes + 2 * kvb + 2 * rowbytes + mb
                        + 2 * qbytes, 8.0 * pairs * dh))
        rows["flash_bwd_dq" + suffix] = dict(
            shape=shape, ms=cuda_ms(fa.flash_bwd_dq, kern),
            plain_ms=plain_ms, library_ms=lib_ms, backend=backend,
            bound=bound(2 * qbytes + 2 * kvb + 2 * rowbytes + mb
                        + qbytes, 6.0 * pairs * dh))

    bwd_rows("", kw_t, T * vis * N_HEAD, shape_t, True)
    bwd_rows("_causal", copies(tcases["train_causal"]),
             B * N_HEAD * T * (T + 1) / 2.0,
             "q/k/v [%d,%d,%d,%d], causal" % (B, N_HEAD, T, dh), False)
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


def profile_step(torch, exe, main, feed, loss, scope):
    """One more train step under torch.profiler: device time by kernel
    (top 8) and the device's busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels themselves (CPU-side ops also carry their kernels' time)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print("train profile: no device time in the trace (not measured)")
        return
    print("train profile: step wall %.1f ms under the profiler, device busy "
          "%.1f ms (%.1f %%)" % (wall_ms, busy_ms, 100.0 * busy_ms / wall_ms))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print("train profile: %8.2f ms %5d calls  %s"
              % (e.self_device_time_total / 1e3, e.count, e.key[:90]))


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
        k.launches = 0
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
    launches = {n: k.launches for n, k in kernels.items()}
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
    profile_step(torch, exe, main, feed, loss, scope)
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
    for name in ("flash_fwd", "flash_fwd_encoder", "paged_decode",
                 "flash_fwd_train", "flash_bwd_dkv", "flash_bwd_dq",
                 "flash_bwd_dkv_causal", "flash_bwd_dq_causal"):
        r = timing[name]
        lib = ("%.4f ms" % r["library_ms"] if r["library_ms"] is not None
               else "none")
        if r.get("backend"):
            lib += " (backward of scaled_dot_product_attention, backend %s)" \
                % r["backend"]
        plain = "plain %.4f ms" % r["plain_ms"]
        if name.startswith("flash_bwd"):
            plain += " (the pair)"
        print("time %-20s %s: kernel %.4f ms, %s, library %s, bound %.4f ms "
              "(%s)" % (name, r["shape"], r["ms"], plain, lib, r["bound"][0],
                        r["bound"][1]))
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
    scope = main_prog = None
    torch.cuda.empty_cache()
    train_launches = train_phase(np, torch, fluid, exe, KERNELS)
    train_card_vs_cpu_phase(np, torch, fluid, exe)

    def bwd_record(name, line):
        t = timing[name]
        return dict(name=name, route="cuda",
                    source="paddle_tpu_torch/csrc/flash_bwd.cu",
                    replaces="paddle_tpu/kernels/flash_attention.py:%d" % line,
                    launches=train_launches[name], max_abs_err=worst[name],
                    ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                    bound_by=t["bound"][1], library_ms=t["library_ms"])

    record = {"kernels": [
        dict(name="flash_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_fwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:91",
             # the serving run's launches and the training run's
             launches=launches["flash_fwd"] + train_launches["flash_fwd"],
             max_abs_err=worst["flash_fwd"],
             ms=timing["flash_fwd"]["ms"],
             plain_ms=timing["flash_fwd"]["plain_ms"],
             bound_ms=timing["flash_fwd"]["bound"][0],
             bound_by=timing["flash_fwd"]["bound"][1],
             library_ms=timing["flash_fwd"]["library_ms"]),
        bwd_record("flash_bwd_dkv", 302),
        bwd_record("flash_bwd_dq", 376),
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

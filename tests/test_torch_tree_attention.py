"""The tree-verify attention and the two speculative pool writers of the
PyTorch port against the JAX package, on the CPU.

``paged_tree_attention_plain`` (what the port runs for CPU tensors, and
what ``chip_smoke.py`` holds the CUDA kernel against on the card) is
compared with the JAX package's Pallas kernel in interpret mode
(``force_pallas=True``) and with its composed reference, on the inputs of
``tests/test_speculative.py``: ragged bases 7, 0, 25, 30 and -1 (a dead
slot), chain and branched ancestor masks, and a tree that straddles
``max_length``. Tolerance 2e-6 (fp32 sums over at most 32 keys in another
order); the dead slot is exactly 0. ``paged_kv_write_block`` and
``paged_kv_compact`` move rows and do no arithmetic, so they are compared
bit for bit (outside the trash page 0, where several writers land and
which one survives is unspecified).

The CUDA kernel's split-KV arithmetic (csrc/tree_decode.cu on the core
of csrc/decode_split.cuh: the splits of ``tree_plan``, 32-key chunks
scored for all N nodes, an online softmax in the exp2 domain in which a
hidden key gives p = 0, partials ``(m, l, acc)`` per split and node,
then the merge) is written out here as torch ops and held against the
JAX Pallas kernel in interpret mode at the same 2e-6: finished slots,
branched masks, 1, 4 and 8 nodes, splits wholly past a slot's scan and
a tree that straddles ``max_length``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.serving.speculative import chain_tree, tree_from_parents
from paddle_tpu_torch.kernels import decode_split
from paddle_tpu_torch.kernels import paged_attention as tpa

TOL = 2e-6
LOG2E = 1.4426950408889634


def _pools(rng, S, H, dh, ps, npp, lengths):
    """Random pools and a ragged table, page 0 reserved as trash."""
    P = 1 + S * npp
    kp = rng.randn(P, H, ps, dh).astype("float32")
    vp = rng.randn(P, H, ps, dh).astype("float32")
    table = np.zeros((S, npp), "int64")
    nxt = 1
    for s in range(S):
        n = tpa.pages_for(max(int(lengths[s]), 1), ps)
        for p in range(n):
            table[s, p] = nxt
            nxt += 1
        for p in range(n, npp):
            table[s, p] = table[s, max(n - 1, 0)]
    return kp, vp, table


def _tree_case(seed=9, max_length=None):
    S, H, dh, ps, npp, N = 5, 2, 16, 4, 8, 4
    base = np.array([7, 0, 25, 30, -1], "int64")
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, N, dh).astype("float32")
    kp, vp, table = _pools(rng, S, H, dh, ps, npp,
                           np.minimum(np.maximum(base, 0) + N, npp * ps))
    anc = np.stack([
        chain_tree(N - 1)[1],
        tree_from_parents([-1, 0, 0, 1]),
        tree_from_parents([-1, 0, 1, 1]),
        chain_tree(N - 1)[1],
        tree_from_parents([-1, 0, 0, 0]),
    ]).astype("int64")
    return (q, kp, vp, table, base, anc), dict(
        max_length=npp * ps if max_length is None else max_length)


def _jax(fn, args, **kw):
    q, kp, vp, table, base, anc = args
    return np.asarray(fn(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table.astype("int32")), jnp.asarray(base.astype("int32")),
        jnp.asarray(anc), **kw))


def _torch(fn, args, **kw):
    return fn(*[torch.from_numpy(np.array(a)) for a in args], **kw).numpy()


@pytest.mark.parametrize("max_length", [32, 31])
@pytest.mark.parametrize("seed", [9, 11])
def test_plain_matches_pallas_interpret_and_reference(seed, max_length):
    """max_length 32 is the table's coverage, which the tree of the slot
    at base 30 straddles (rows 32 and 33 were never written); 31 also
    masks its row 31. A live slot's base stays below max_length."""
    args, kw = _tree_case(seed, max_length)
    ker = _jax(jpa.paged_tree_attention, args, force_pallas=True, **kw)
    ref = _jax(jpa.paged_tree_attention_reference, args, **kw)
    got = _torch(tpa.paged_tree_attention_plain, args, **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ker, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert np.abs(got[4]).max() == 0.0  # the dead slot, exactly
    assert np.abs(got[1]).max() > 0.0   # base 0: the anchor sees itself


def test_entry_runs_the_plain_version_on_cpu_tensors():
    args, kw = _tree_case()
    np.testing.assert_array_equal(
        _torch(tpa.paged_tree_attention, args, **kw),
        _torch(tpa.paged_tree_attention_plain, args, **kw))
    assert tpa.TREE_DECODE.launches == 0  # no kernel ran for CPU tensors


def test_branch_isolation():
    """Zeroing a sibling's K/V rows changes nothing for a node (only its
    root path is visible); zeroing an ancestor's does."""
    args, kw = _tree_case(seed=11)
    q, kp, vp, table, base, anc = args
    out = _torch(tpa.paged_tree_attention_plain, args, **kw)
    # slot 1 (base 0, tree [-1, 0, 0, 1]): node 2's siblings are nodes 1
    # and 3, at storage rows 1 and 3 of page table[1, 0]
    pg = int(table[1, 0])
    kp2, vp2 = kp.copy(), vp.copy()
    for row in (1, 3):
        kp2[pg, :, row] = 0.0
        vp2[pg, :, row] = 0.0
    out2 = _torch(tpa.paged_tree_attention_plain,
                  (q, kp2, vp2, table, base, anc), **kw)
    np.testing.assert_allclose(out2[1, :, 2], out[1, :, 2], rtol=1e-6,
                               atol=1e-6)
    kp3, vp3 = kp.copy(), vp.copy()
    kp3[pg, :, 0] = 0.0
    vp3[pg, :, 0] = 0.0
    out3 = _torch(tpa.paged_tree_attention_plain,
                  (q, kp3, vp3, table, base, anc), **kw)
    assert np.abs(out3[1, :, 2] - out[1, :, 2]).max() > 1e-4


def _tree_split_merge(q, kp, vp, table, base, anc, plan, sm_scale,
                      max_length):
    """csrc/tree_decode.cu's arithmetic as torch ops: per (slot, head,
    split) the keys of the split's pages below the slot's scan,
    min(base + N, max_length), in chunks of ``decode_split.CHUNK``, each
    scored for all N nodes; an online softmax of the exp2-domain scores
    per node with p = 0 for a hidden key (a split without a visible key:
    m = -1e30, l = 0, acc = 0); then the merge with weights
    exp2(m_i - M), exactly 0 where M <= -1e29."""
    S, H, N, dh = q.shape
    ps, npp = kp.shape[2], table.shape[1]
    splits, pps = plan["splits"], plan["pages_per_split"]
    out = torch.zeros(S, H, N, dh)
    for s in range(S):
        b = int(base[s])
        scan = 0 if b < 0 else min(b + N, max_length, npp * ps)
        t = torch.arange(scan)
        keys = kp[table[s, t // ps], :, t % ps]           # [scan, H, dh]
        vals = vp[table[s, t // ps], :, t % ps]
        tj = t - b
        in_tree = (tj >= 0) & (tj < N) & (t < max_length)
        vis = (tj < 0)[None, :] | (in_tree[None, :]
                                   & (anc[s][:, tj.clamp(0, N - 1)] > 0))
        for h in range(H):
            parts = []
            for sp in range(splits):
                m = torch.full((N,), tpa.NEG_INF)
                l = torch.zeros(N)
                acc = torch.zeros(N, dh)
                lo, hi = sp * pps * ps, min(scan, (sp + 1) * pps * ps)
                for c0 in range(lo, hi, decode_split.CHUNK):
                    c1 = min(hi, c0 + decode_split.CHUNK)
                    v = vis[:, c0:c1]
                    sc = (q[s, h] * sm_scale * LOG2E) @ keys[c0:c1, h].T
                    sc = torch.where(v, sc, torch.tensor(tpa.NEG_INF))
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(v, torch.exp2(sc - m_new[:, None]),
                                    torch.tensor(0.0))
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ vals[c0:c1, h]
                    m = m_new
                parts.append((m, l, acc))
            big_m = torch.stack([pm for pm, _, _ in parts]).max(dim=0).values
            w = [torch.exp2(pm - big_m) for pm, _, _ in parts]
            l_all = sum(pl * wi for (_, pl, _), wi in zip(parts, w))
            a_all = sum(pa * wi[:, None] for (_, _, pa), wi in zip(parts, w))
            merged = a_all / l_all.clamp(min=1e-30)[:, None]
            out[s, h] = torch.where((big_m <= tpa.MASKED_ROW_M)[:, None],
                                    torch.tensor(0.0), merged)
    return out


def _split_case(N, bases, max_length, seed):
    """Pools of 40 pages of 4 keys (two splits of 80 keys under
    ``tree_plan``) and a branched or chain tree per slot."""
    S, H, dh, ps, npp = len(bases), 2, 16, 4, 40
    base = np.array(bases, "int64")
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, N, dh).astype("float32")
    kp, vp, table = _pools(rng, S, H, dh, ps, npp,
                           np.minimum(np.maximum(base, 0) + N, npp * ps))
    anc = np.stack([
        chain_tree(N - 1)[1] if s % 2 else tree_from_parents(
            [-1] + [int(rng.randint(0, i)) for i in range(1, N)])
        for s in range(S)]).astype("int64")
    return (q, kp, vp, table, base, anc), max_length


@pytest.mark.parametrize("N,bases,max_length", [
    (4, [7, 0, 100, 150, -1], 160),     # slots 0, 1: split 2 past the scan
    (1, [0, 79, 80, -1, 159], 160),     # scans ending on the split boundary
    (8, [3, -1, 75, 152, 60], 158),     # trees across the split and max_len
])
def test_split_merge_arithmetic_matches_jax_pallas(N, bases, max_length):
    args, max_length = _split_case(N, bases, max_length, seed=N + 20)
    q, kp, vp, table, base, anc = args
    S, H, _, dh = q.shape
    plan = tpa.tree_plan(S, H, N, table.shape[1], kp.shape[2], dh, 132,
                         232448)
    assert plan["splits"] == 2
    span = plan["pages_per_split"] * kp.shape[2]
    # some live slot's second split lies wholly past its scan
    assert any(0 <= b and b + N <= span for b in bases)
    want = _jax(jpa.paged_tree_attention, args, force_pallas=True,
                max_length=max_length)
    got = _tree_split_merge(*[torch.from_numpy(np.array(a)) for a in args],
                            plan, dh ** -0.5, max_length).numpy()
    assert np.isfinite(got).all()
    dead = base < 0
    assert np.abs(got[dead]).max() == 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _writer_case(seed):
    S, H, dh, ps, npp, N = 4, 2, 8, 4, 3, 4
    rng = np.random.RandomState(seed)
    P = 1 + S * npp
    kp = rng.randn(P, H, ps, dh).astype("float32")
    vp = rng.randn(P, H, ps, dh).astype("float32")
    table = (1 + np.arange(S * npp)).reshape(S, npp).astype("int64")
    return S, H, dh, ps, npp, N, rng, kp, vp, table


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_kv_write_block_equals_jax(seed):
    """Rows inside the table, rows that cross a page boundary, rows past
    the table's coverage (trash-routed) and a slot whose row is all
    trash."""
    S, H, dh, ps, npp, N, rng, kp, vp, table = _writer_case(seed)
    table[3] = 0
    k_new = rng.randn(S, H, N, dh).astype("float32")
    v_new = rng.randn(S, H, N, dh).astype("float32")
    positions = (np.array([[0], [2], [10], [5]]) + np.arange(N)).astype(
        "int64")  # slot 2 writes rows 10, 11, then 12, 13 out of range
    want = jpa.paged_kv_write_block(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(table.astype("int32")),
        jnp.asarray(positions.astype("int32")))
    got = tpa.paged_kv_write_block(*[torch.from_numpy(np.array(a)) for a in (
        kp, vp, k_new, v_new, table, positions)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])
    assert not np.array_equal(got[0].numpy()[1:], kp[1:])


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_kv_compact_equals_jax(seed):
    """Branched accepted paths whose source and destination rows overlap
    (row base+2 is read for j = 1 and written for j = 2), a path across a
    page boundary, a dead slot, a slot that accepted nothing, and rows
    past the table's coverage."""
    S, H, dh, ps, npp, N, rng, kp, vp, table = _writer_case(seed)
    base = np.array([1, 3, -1, 10], "int64")
    path = np.array([[0, 2, 3, 3], [0, 3, 2, 1], [0, 2, 3, 1],
                     [0, 1, 3, 2]], "int64")
    acc = np.array([3, 4, 4, 4], "int64")
    want = jpa.paged_kv_compact(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table.astype("int32")),
        jnp.asarray(base.astype("int32")), jnp.asarray(path.astype("int32")),
        jnp.asarray(acc.astype("int32")))
    got = tpa.paged_kv_compact(*[torch.from_numpy(np.array(a)) for a in (
        kp, vp, table, base, path, acc)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])
    # slot 0: row base+1 now holds what row base+2 held BEFORE the call
    pg = int(table[0, 0])
    np.testing.assert_array_equal(got[0].numpy()[pg, :, 2], kp[pg, :, 3])
    # slot 1: row 4 (base+1) holds old row 6 (base+3); row 6 holds old 4
    p1 = int(table[1, 1])
    np.testing.assert_array_equal(got[0].numpy()[p1, :, 0], kp[p1, :, 2])
    np.testing.assert_array_equal(got[0].numpy()[p1, :, 2], kp[p1, :, 0])


def test_cuda_tensors_never_reach_the_plain_version():
    """On CUDA tensors the entry launches the kernel or raises; here,
    without a card, a tensor on the ``meta`` device stands for "not on
    the CPU": the wrapper's checks raise."""
    args, kw = _tree_case()
    meta = [torch.from_numpy(np.array(a)).to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA device"):
        tpa.paged_tree_attention(*meta, **kw)

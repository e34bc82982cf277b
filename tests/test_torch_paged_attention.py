"""Paged-attention decode and the paged KV writes of the PyTorch port
against the JAX package.

The port's plain version of the ``paged_decode`` kernel is held against
the JAX package's Pallas ``_paged_decode_kernel`` in interpret mode
(``paged_attention(force_pallas=True)``) on the ragged pools of
tests/test_paged_attention.py, with page sizes 4 and 3 (tolerance 2e-6,
the reference tests' own). The KV writes (``paged_kv_write``,
``paged_kv_prefill``, ``paged_copy_page``) are compared with the JAX ops
exactly, leaving out the trash page 0: several writers land there, and
which one survives is unspecified. ``grid_accounting`` must equal
JAX's.

The CUDA kernel's split-KV arithmetic (csrc/paged_decode.cu: the splits
of ``paged_plan``, 32-key chunks with an online softmax in the exp2
domain, partials ``(m, l, acc)`` per split, then the merge) is written
out here as torch ops and held against the JAX Pallas kernel in
interpret mode at the same 2e-6, with length-0 slots, splits wholly past
a slot's length and page sizes 3 and 4.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import op_registry as j_registry
from paddle_tpu_torch.core import op_registry as t_registry
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.testing import fresh_state

jpa = importlib.import_module("paddle_tpu.kernels.paged_attention")

TOL = 2e-6


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _pools(rng, S, H, dh, ps, npp, lengths):
    """Random pools + a ragged table: page 0 reserved (trash), each
    slot's tail aliased to its last valid page (as the reference test)."""
    P = 1 + S * npp
    kp = rng.randn(P, H, ps, dh).astype("float32")
    vp = rng.randn(P, H, ps, dh).astype("float32")
    table = np.zeros((S, npp), np.int64)
    nxt = 1
    for s in range(S):
        n = tpa.pages_for(lengths[s], ps)
        for p in range(n):
            table[s, p] = nxt
            nxt += 1
        for p in range(n, npp):
            table[s, p] = table[s, max(n - 1, 0)]
    return kp, vp, table


def _both(q, kp, vp, table, lengths):
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table.astype(np.int32)),
        jnp.asarray(lengths.astype(np.int32)), force_pallas=True))
    got = tpa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths)).numpy()
    return got, want


@pytest.mark.parametrize("ps,npp", [(4, 8), (3, 11)])
def test_plain_paged_decode_matches_jax_pallas_ragged(ps, npp):
    S, H, dh = 5, 2, 16
    lengths = np.array([7, 1, 32, 13, 30], np.int64)
    rng = np.random.RandomState(3)
    q = rng.randn(S, H, dh).astype("float32")
    kp, vp, table = _pools(rng, S, H, dh, ps, npp, lengths)
    got, want = _both(q, kp, vp, table, lengths)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ps", [4, 3])
def test_length_zero_slot_is_exact_zero(ps):
    S, H, dh, npp = 3, 2, 8, 2
    lengths = np.array([0, 5, 0], np.int64)
    rng = np.random.RandomState(4)
    q = rng.randn(S, H, dh).astype("float32")
    kp, vp, table = _pools(rng, S, H, dh, ps, npp, lengths)
    got, want = _both(q, kp, vp, table, lengths)
    assert np.abs(got[0]).max() == 0.0 and np.abs(got[2]).max() == 0.0
    assert np.abs(got[1]).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _split_merge(q, kp, vp, table, lengths, plan, sm_scale):
    """csrc/paged_decode.cu's arithmetic as torch ops: per (slot, head,
    split) the keys of the split's pages below the slot's length, in
    chunks of ``PAGED_CHUNK``, an online softmax of the exp2-domain
    scores (an empty split: m = -1e30, l = 0, acc = 0); then the merge
    with weights exp2(m_i - M), exactly 0 where M <= -1e29."""
    S, H, dh = q.shape
    ps = kp.shape[2]
    npp = table.shape[1]
    splits, pps = plan["splits"], plan["pages_per_split"]
    scale2 = sm_scale * 1.4426950408889634
    out = torch.zeros(S, H, dh)
    for s in range(S):
        length = min(max(int(lengths[s]), 0), npp * ps)
        pos = torch.arange(length)
        keys = kp[table[s, pos // ps], :, pos % ps]    # [len, H, dh]
        vals = vp[table[s, pos // ps], :, pos % ps]
        for h in range(H):
            parts = []
            for sp in range(splits):
                m = torch.tensor(tpa.NEG_INF)
                l = torch.tensor(0.0)
                acc = torch.zeros(dh)
                lo, hi = sp * pps * ps, min(length, (sp + 1) * pps * ps)
                for c0 in range(lo, hi, tpa.PAGED_CHUNK):
                    c1 = min(hi, c0 + tpa.PAGED_CHUNK)
                    sc = keys[c0:c1, h] @ (q[s, h] * scale2)
                    m_new = torch.maximum(m, sc.max())
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(sc - m_new)
                    l = l * alpha + p.sum()
                    acc = acc * alpha + p @ vals[c0:c1, h]
                    m = m_new
                parts.append((m, l, acc))
            big_m = max(pm for pm, _, _ in parts)
            if big_m <= tpa.MASKED_ROW_M:
                continue
            w = [torch.exp2(pm - big_m) for pm, _, _ in parts]
            l_all = sum(pl * wi for (_, pl, _), wi in zip(parts, w))
            out[s, h] = sum(pa * wi for (_, _, pa), wi in zip(parts, w)) \
                / l_all
    return out


@pytest.mark.parametrize("ps,npp,lengths", [
    (4, 40, [0, 1, 70, 160, 64]),   # 2 splits of 80 keys: one on a boundary
    (3, 64, [0, 96, 191, 5, 97]),   # 3 splits of 66 keys: later ones empty
])
def test_split_merge_arithmetic_matches_jax_pallas(ps, npp, lengths):
    S, H, dh = len(lengths), 2, 16
    lengths = np.array(lengths, np.int64)
    rng = np.random.RandomState(8)
    q = rng.randn(S, H, dh).astype("float32")
    kp, vp, table = _pools(rng, S, H, dh, ps, npp, lengths)
    plan = tpa.paged_plan(S, H, npp, ps, dh, 132, 232448)
    assert plan["splits"] > 1
    # some slot's later splits lie wholly past its length
    span = plan["pages_per_split"] * ps
    assert any(0 < n <= span * (plan["splits"] - 1) for n in lengths)
    _, want = _both(q, kp, vp, table, lengths)
    got = _split_merge(torch.from_numpy(q), torch.from_numpy(kp),
                       torch.from_numpy(vp), torch.from_numpy(table),
                       torch.from_numpy(lengths), plan, dh ** -0.5).numpy()
    assert np.abs(got[0]).max() == 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_kernel_path_takes_only_cuda():
    """A tensor that is not on the CPU goes to the kernel path or raises."""
    rng = np.random.RandomState(5)
    kp, vp, table = _pools(rng, 2, 2, 8, 4, 2, [3, 5])
    args = [torch.from_numpy(rng.randn(2, 2, 8).astype("float32")),
            torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table), torch.tensor([3, 5])]
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(*[a.to("meta") for a in args])


class _Ctx(object):
    def __init__(self, op=None):
        self.op = op
        self.device = torch.device("cpu")


def _lower_both(op_type, ins, attrs=None):
    """Run one op's lowering in both packages on the same numpy inputs;
    returns {slot: (torch result, jax result)} as numpy."""
    attrs = dict(attrs or {})
    t_out = t_registry.normalize_outputs(
        t_registry.get_op_def(op_type),
        t_registry.get_op_def(op_type).lower(
            _Ctx(), {k: [torch.from_numpy(np.array(a)) for a in v]
                     for k, v in ins.items()}, attrs))
    j_ctx = j_registry.LowerContext(None, rng=None, is_test=True)
    j_out = j_registry.normalize_outputs(
        j_registry.get_op_def(op_type),
        j_registry.get_op_def(op_type).lower(
            j_ctx, {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
            attrs))
    return {k: (t_out[k][0].numpy(), np.asarray(j_out[k][0]))
            for k in t_out}


def _assert_pools_equal(got, want):
    """Equal everywhere but the trash page 0."""
    np.testing.assert_array_equal(got[1:], want[1:])


def test_paged_kv_write_matches_jax_outside_trash_page():
    S, H, dh, ps, npp = 3, 2, 4, 4, 2
    rng = np.random.RandomState(5)
    kp, vp, table = _pools(rng, S, H, dh, ps, npp, [6, 3, 0])
    knew = rng.randn(S, H, 1, dh).astype("float32")
    vnew = rng.randn(S, H, 1, dh).astype("float32")
    pos = np.array([[5], [2], [0]], np.int64)
    out = _lower_both("paged_kv_write", {
        "KPool": [kp], "VPool": [vp], "KNew": [knew], "VNew": [vnew],
        "PageTable": [table], "Pos": [pos]})
    for slot in ("KOut", "VOut"):
        _assert_pools_equal(*out[slot])
    # the write really landed (slot 0 at position 5)
    page, off = table[0, 5 // ps], 5 % ps
    np.testing.assert_array_equal(out["KOut"][0][page, :, off],
                                  knew[0, :, 0])


@pytest.mark.parametrize("write_from,length", [(0, 7), (4, 7), (0, 1)])
def test_paged_kv_prefill_matches_jax_outside_trash_page(write_from,
                                                         length):
    H, dh, ps, T = 2, 4, 4, 8
    npp = tpa.pages_for(T, ps)
    rng = np.random.RandomState(6)
    kp = rng.randn(1 + 2 * npp, H, ps, dh).astype("float32")
    vp = rng.randn(1 + 2 * npp, H, ps, dh).astype("float32")
    row = np.array([[3, 4]], np.int64)
    knew = rng.randn(1, H, T, dh).astype("float32")
    vnew = rng.randn(1, H, T, dh).astype("float32")
    out = _lower_both("paged_kv_prefill", {
        "KPool": [kp], "VPool": [vp], "KNew": [knew], "VNew": [vnew],
        "PageRow": [row], "WriteFrom": [np.array([[write_from]], np.int64)],
        "Len": [np.array([[length]], np.int64)]})
    for slot in ("KOut", "VOut"):
        _assert_pools_equal(*out[slot])


@pytest.mark.parametrize("src,dst", [(2, 5), (0, 0), (4, 4)])
def test_paged_copy_page_matches_jax(src, dst):
    rng = np.random.RandomState(7)
    kp = rng.randn(6, 2, 4, 4).astype("float32")
    vp = rng.randn(6, 2, 4, 4).astype("float32")
    out = _lower_both("paged_copy_page", {
        "KPool": [kp], "VPool": [vp], "Src": [np.array([src], np.int64)],
        "Dst": [np.array([dst], np.int64)]})
    for slot in ("KOut", "VOut"):
        got, want = out[slot]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lengths", [[3, 17, 0, 0, 0, 0, 0, 0],
                                     [256] * 32, [0, 1, 16, 17]])
def test_grid_accounting_equals_jax(lengths):
    for kw in ({}, {"num_groups": 4, "n_layer": 6, "src_length": 200}):
        assert (tpa.grid_accounting(lengths, 16, 8, 64, 256, **kw)
                == jpa.grid_accounting(lengths, 16, 8, 64, 256, **kw))

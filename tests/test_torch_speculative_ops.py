"""The speculative-decode ops of the PyTorch port against the JAX
package: one-op programs through both packages' executors on the CPU,
with the same numpy feeds.

``slot_speculative_accept`` chooses tokens by argmax and moves integers,
so all six outputs are compared exactly. Its drafts are built from the
logits' own argmax so that chains and branched trees match at every
depth 0..N-1, beside done slots, a slot that emits eos, slots at the end
of the decode budget and duplicate siblings (the first matching child
wins). ``paged_spec_kv_write`` / ``paged_spec_kv_compact`` move rows and
are compared bit for bit outside the trash page 0. ``paged_tree_attention``
is compared within 1e-5 (fp32, other summation order). Sampled accept
walks (temperature, top-k) draw the JAX package's tokens: compared
exactly on the file's fixed cases.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.serving.speculative import chain_tree, tree_from_parents
from paddle_tpu_torch.testing import fresh_state

FLOAT_TOL = 1e-5
EOS, MAX_LEN, N, V = 2, 12, 4, 13


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _i(values):
    return np.asarray(values, dtype="int64")


def _run(pkg, op_type, ins, outs, attrs):
    prog = pkg.Program()
    blk = prog.global_block()
    feed = {}
    for items in ins.values():
        for name, arr in items:
            if not blk.has_var(name):
                blk.create_var(name=name, shape=arr.shape,
                               dtype=str(arr.dtype), is_data=True)
            feed[name] = arr
    fetch = [n for names in outs.values() for n in names]
    for name in fetch:
        if not blk.has_var(name):
            blk.create_var(name=name)
    blk.append_op(type=op_type,
                  inputs={s: [n for n, _ in items]
                          for s, items in ins.items()},
                  outputs=outs, attrs=dict(attrs))
    exe = pkg.Executor(pkg.CPUPlace())
    return [np.asarray(v) for v in exe.run(prog, feed=feed,
                                           fetch_list=fetch)]


def _accept_case(seed):
    """Ten slots: chains matching to depth 0, 1, 2 and 3; branched trees
    (a second child that matches, a grandchild under it, duplicate
    siblings); a done slot; a slot whose anchor emits eos; two slots at
    the end of the budget."""
    rng = np.random.RandomState(seed)
    chain = chain_tree(N - 1)[0]
    parents = [chain, chain, chain, chain, _i([-1, 0, 0, 1]),
               _i([-1, 0, 0, 2]), _i([-1, 0, 0, 0]), chain, chain, chain]
    S = len(parents)
    lg = rng.randn(S, N, V).astype("float32")
    lg[:, :, EOS] -= 10.0  # eos only where a case asks for it
    lg[8, 0, EOS] += 30.0  # slot 8's anchor emits eos
    top = lg.argmax(-1)    # [S, N]: the target's token after each node
    wrong = (top + 1) % V
    wrong[wrong == EOS] = EOS + 1
    draft = wrong.copy()[:, :N - 1]  # [S, K]: node i+1 carries draft[:, i]
    nodes = np.zeros((S, N), "int64")

    def accept(s, node, parent_node):
        """Node ``node`` carries the target's token after ``parent_node``."""
        draft[s, node - 1] = top[s, parent_node]

    for d, s in enumerate((0, 1, 2, 3)):       # chains, depth d
        for node in range(1, d + 1):
            accept(s, node, node - 1)
    accept(4, 2, 0)                            # second child matches, leaf
    accept(5, 2, 0)
    accept(5, 3, 2)                            # and its child under it
    accept(6, 2, 0)                            # duplicate siblings: node 2
    accept(6, 3, 0)                            # wins, node 3 is unreachable
    for node in range(1, N):                   # full chains everywhere else
        for s in (7, 8, 9):
            accept(s, node, node - 1)
    nodes[:, 1:] = draft
    nodes[:, 0] = rng.randint(3, V, S)
    pos = _i([[0], [3], [1], [2], [4], [0], [5], [3], [2], [MAX_LEN - 2]])
    pos[3, 0] = MAX_LEN - 4                    # depth-3 chain runs out
    done = np.zeros((S, 1), "int64")
    done[7, 0] = 1
    return {"Logits": [("lg", lg)], "Nodes": [("nodes", nodes)],
            "Parent": [("par", np.stack(parents))], "Pos": [("pos", pos)],
            "Done": [("done", done)]}


ACCEPT_OUTS = {"Out": ["o"], "TokSeq": ["seq"], "AcceptLen": ["acc"],
               "Path": ["path"], "PosOut": ["p"], "DoneOut": ["d"]}
ACCEPT_ATTRS = {"eos_id": EOS, "max_length": MAX_LEN}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_speculative_accept_matches_jax(seed):
    ins = _accept_case(seed)
    want = _run(jfluid, "slot_speculative_accept", ins, ACCEPT_OUTS,
                ACCEPT_ATTRS)
    got = _run(tfluid, "slot_speculative_accept", ins, ACCEPT_OUTS,
               ACCEPT_ATTRS)
    for name, g, w in zip(ACCEPT_OUTS, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    acc = got[2].reshape(-1)
    # the cases do what they were built for
    np.testing.assert_array_equal(acc[:3], [1, 2, 3])
    assert acc[3] in (3, 4)  # the budget may cut the depth-3 chain
    assert acc[4] == 2 and acc[5] == 3 and acc[6] == 2
    assert acc[7] == 0 and acc[8] == 1 and acc[9] == 1
    np.testing.assert_array_equal(got[3][4], [0, 2, 2, 3])  # path
    np.testing.assert_array_equal(got[3][5], [0, 2, 3, 3])
    np.testing.assert_array_equal(got[3][6], [0, 2, 2, 3])
    assert got[0][7, 0] == EOS and got[0][8, 0] == EOS


def test_non_greedy_strategy_raises_in_the_port():
    """Sampled accept walks (temperature and top-k) equal the JAX
    package's: each position draws from its (seed, slot, position) key
    through the shared token rule. A temperature of 0 is greedy under
    any strategy name, as in JAX. (The name is kept from when the port
    refused a stochastic strategy.)"""
    for extra in ({"strategy": "top_k", "top_k": 3, "temperature": 0.8,
                   "base_seed": 11},
                  {"strategy": "temperature", "temperature": 1.3,
                   "base_seed": 5},
                  {"strategy": "top_k", "top_k": 3, "temperature": 0.0}):
        attrs = dict(ACCEPT_ATTRS, **extra)
        for seed in (0, 1):
            want = _run(jfluid, "slot_speculative_accept", _accept_case(seed),
                        ACCEPT_OUTS, attrs)
            got = _run(tfluid, "slot_speculative_accept", _accept_case(seed),
                       ACCEPT_OUTS, attrs)
            for name, g, w in zip(ACCEPT_OUTS, got, want):
                np.testing.assert_array_equal(g, w.astype(g.dtype),
                                              err_msg="%s %r" % (name, extra))
            greedy = _run(tfluid, "slot_speculative_accept",
                          _accept_case(seed), ACCEPT_OUTS, ACCEPT_ATTRS)
            # a sampled walk is not the greedy one (TokSeq)
            assert (np.array_equal(got[1], greedy[1])
                    == (extra["temperature"] == 0.0))


def _pool_case(seed):
    S, H, dh, ps, npp = 4, 2, 8, 4, 3
    rng = np.random.RandomState(seed)
    P = 1 + S * npp
    kp = rng.randn(P, H, ps, dh).astype("float32")
    vp = rng.randn(P, H, ps, dh).astype("float32")
    table = (1 + np.arange(S * npp)).reshape(S, npp).astype("int64")
    return S, H, dh, rng, kp, vp, table


def _pool_outputs_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1:], w[1:])


def test_paged_spec_kv_write_matches_jax():
    S, H, dh, rng, kp, vp, table = _pool_case(3)
    table[2] = 0  # a done slot's row: all trash
    ins = {"KPool": [("kp", kp)], "VPool": [("vp", vp)],
           "KNew": [("kn", rng.randn(S, H, N, dh).astype("float32"))],
           "VNew": [("vn", rng.randn(S, H, N, dh).astype("float32"))],
           "PageTable": [("t", table)],
           "Pos": [("pos", _i([[0], [6], [3], [10]]))]}
    outs = {"KOut": ["kp"], "VOut": ["vp"]}
    got = _run(tfluid, "paged_spec_kv_write", ins, outs, {})
    _pool_outputs_equal(got, _run(jfluid, "paged_spec_kv_write", ins, outs,
                                  {}))
    assert not np.array_equal(got[0][1:], kp[1:])


def test_paged_spec_kv_compact_matches_jax():
    S, H, dh, rng, kp, vp, table = _pool_case(4)
    ins = {"KPool": [("kp", kp)], "VPool": [("vp", vp)],
           "PageTable": [("t", table)],
           "Pos": [("pos", _i([[1], [3], [-1], [10]]))],
           "Path": [("path", _i([[0, 2, 3, 3], [0, 3, 2, 1], [0, 2, 3, 1],
                                 [0, 1, 3, 2]]))],
           "AcceptLen": [("acc", _i([[3], [4], [4], [4]]))]}
    outs = {"KOut": ["kp"], "VOut": ["vp"]}
    got = _run(tfluid, "paged_spec_kv_compact", ins, outs, {})
    _pool_outputs_equal(got, _run(jfluid, "paged_spec_kv_compact", ins, outs,
                                  {}))
    assert not np.array_equal(got[0][1:], kp[1:])


@pytest.mark.parametrize("impl", ["auto", "reference", "pallas"])
def test_paged_tree_attention_op_matches_jax(impl):
    """The op under each routing: the JAX op runs its composed reference
    on the CPU (``pallas`` forces the kernel in interpret mode); the port
    runs the plain version for CPU tensors under every routing."""
    S, H, dh, rng, kp, vp, table = _pool_case(5)
    anc = np.stack([chain_tree(N - 1)[1], tree_from_parents([-1, 0, 0, 1]),
                    tree_from_parents([-1, 0, 1, 1]),
                    chain_tree(N - 1)[1]]).astype("int64")
    ins = {"Q": [("q", rng.randn(S, H, N, dh).astype("float32"))],
           "KPool": [("kp", kp)], "VPool": [("vp", vp)],
           "PageTable": [("t", table)],
           "BaseLens": [("base", _i([[5], [0], [-1], [9]]))],
           "Anc": [("anc", anc)]}
    attrs = {"sm_scale": 0.25, "max_length": 11, "impl": impl}
    want = _run(jfluid, "paged_tree_attention", ins, {"Out": ["o"]}, attrs)
    got = _run(tfluid, "paged_tree_attention", ins, {"Out": ["o"]}, attrs)
    np.testing.assert_allclose(got[0], want[0], rtol=FLOAT_TOL,
                               atol=FLOAT_TOL)
    assert np.abs(got[0][2]).max() == 0.0

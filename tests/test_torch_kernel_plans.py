"""The launch plans of the port's redesigned kernels, on the CPU (pure
Python: no card, no JAX).

- ``lstm_cell.lstm_plan`` (B6): every block's (batch rows, gate columns)
  tile the [B, 4D] gates of a step exactly once; W_h goes to registers
  only where a thread's share fits them; each block's shared
  memory stays within the H100's 232,448 bytes (or the limit given); the
  cooperative grid of regime (b) stays within the SM count; regime (a)
  is chosen exactly where W_h (16 D^2 bytes, k rounded up to 4) plus the
  two h buffers of its rows fit one block; the thread and k-split
  figures stay within what csrc/lstm_cell.cu takes; a plan carries the
  layout ``lstm_layout`` derives from its choices (``chip_smoke.py``
  holds that layout to the kernel's own ``paddle_lstm_layout``).
- ``gru_cell.gru_plan`` (B7): the same invariants with B7's columns:
  every block's (batch rows, columns of the [B, 3D] gates) tile them
  exactly once, each hidden unit's u, r and c columns in one block;
  regime (a) exactly where W_gate and W_cand (12 D^2 bytes) plus h and
  r * h of its rows fit one block.
- ``paged_attention.paged_plan`` (B4): the splits cover every page of a
  slot exactly once, none empty; shared memory within the limit; a
  function of static shapes only (no lengths among its parameters).
- ``paged_attention.tree_plan`` (B5): the same invariants as
  ``paged_plan`` (no bases among its parameters), shared memory within
  the limit at every head dim for 1, 4 and 8 nodes, the plan at the
  verify shape as a literal.
- ``flash_attention.flash_plan`` (B1): the rows path for T <= 4 (with
  the key split of ``flash_rows_plan``), the 32-row tile where 64-row
  tiles would leave SMs idle, else 64 rows.
- ``flash_attention.flash_rows_plan`` (B1 at T <= 4): the splits cover
  every key once, none empty, a multiple of the 32-key chunk; shared
  memory within the limit; no key mask or lengths among its parameters;
  the plans at the decode and verify shapes as literals.
- ``flash_attention.flash_bwd_plan`` (B2, B3): the blocks tile every key
  row (B2) and query row (B3) of every head and batch once; tile rows a
  multiple of 16, shared memory within 232,448 bytes; 64-row tiles at
  every shape, small batches included; the plan at the train shape as a
  literal (``chip_smoke.py`` holds the plan's threads and
  shared bytes to the kernels' own, ``paddle_flash_bwd_layout``).
- ``flash_attention.flash_bf16_plan`` (B1's bf16 entry) and
  ``flash_bwd_plan``'s ``"dkv_bf16"`` (B2's): the blocks tile every query
  row (B1) and key row (B2) of every head and batch once; 16 rows a
  warp; the head dim padded to 32, 64 or 128; shared memory within
  232,448 bytes, bf16 tiles counted at 2 bytes a value; a function of
  static shapes only; the train-shape plans as literals
  (``chip_smoke.py`` holds them to ``paddle_flash_fwd_bf16_layout`` and
  ``paddle_flash_bwd_dkv_bf16_layout``).
- ``flash_bwd_plan``'s ``"dq_bf16"`` (B3's bf16 entry): the blocks tile
  every query row of every head and batch once, 16 rows a warp; shared
  memory within 232,448 bytes at every head dim (resident Q and dO, two
  buffers of K/V tiles and their key-mask entries); the train-shape plan
  as a literal (``chip_smoke.py`` holds it to
  ``paddle_flash_bwd_dq_bf16_layout``).
"""

import inspect
import itertools

import pytest

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import gru_cell as tg
from paddle_tpu_torch.kernels import lstm_cell as tl
from paddle_tpu_torch.kernels import paged_attention as tpa

H100_SMS = 132
H100_SMEM = 232448
SHAPES = [(B, D) for B in (1, 3, 5, 7, 32, 33, 100, 300)
          for D in (1, 7, 40, 64, 96, 119, 120, 121, 128, 200, 512, 515,
                    1100, 1400, 2048)]


def _plan_blocks(plan, B, D, gates=4):
    """What each block of ``plan`` computes, in launch order: a list of
    (batch rows, gate columns), the columns being the ``gates`` gates of
    the block's hidden units (all gates * D in regime (a)): W_h's four
    for B6, u, r and c for B7. Block i is unit group i % G of row block
    i // G, G = ceil(D / units), as in csrc/lstm_cell.cu and
    csrc/gru_cell.cu."""
    u, r = plan["units"], plan["rows"]
    groups = -(-D // u)
    blocks = []
    for i in range(plan["blocks"]):
        g, rb = i % groups, i // groups
        units = range(g * u, min(D, (g + 1) * u))
        blocks.append((list(range(rb * r, min(B, (rb + 1) * r))),
                       [gate * D + j for gate in range(gates)
                        for j in units]))
    return blocks


@pytest.mark.parametrize("B,D", SHAPES)
def test_lstm_blocks_tile_every_row_and_gate_column_once(B, D):
    plan = tl.lstm_plan(B, D, H100_SMS, H100_SMEM)
    seen = {}
    for rows, cols in _plan_blocks(plan, B, D):
        assert rows and cols
        for r, c in itertools.product(rows, cols):
            seen[(r, c)] = seen.get((r, c), 0) + 1
    assert len(seen) == B * 4 * D
    assert set(seen.values()) == {1}
    # a block's columns are whole hidden units: all four gates of each
    for _, cols in _plan_blocks(plan, B, D):
        units = sorted(c % D for c in cols if c < D)
        assert sorted(c - g * D for g in range(4) for c in cols
                      if g * D <= c < (g + 1) * D) == sorted(units * 4)


@pytest.mark.parametrize("B,D", SHAPES)
def test_lstm_plan_stays_within_the_card_and_the_kernel(B, D):
    plan = tl.lstm_plan(B, D, H100_SMS, H100_SMEM)
    assert plan["smem"] <= H100_SMEM
    assert plan["threads"] % 32 == 0
    assert 32 <= plan["threads"] <= tl.MAX_THREADS
    assert plan["units"] * plan["groups"] <= tl.MAX_COMBOS
    assert plan["rt"] in (1, 4) and 1 <= plan["kw"] <= 4
    assert 1 <= plan["kc"] <= D
    if plan["kc"] < D:
        assert plan["kc"] % 8 == 0
    if plan["regime"] == "b":
        # cooperative: one block per SM at most, all co-resident
        assert plan["blocks"] <= H100_SMS
    else:
        assert plan["units"] == D and plan["kc"] == D
        assert plan["w"] in ("shared", "registers")
        if plan["w"] == "registers":
            quads = -(-D // 4)
            assert -(-quads // (4 * plan["kw"])) <= tl.REG_QUADS
        assert plan["groups"] * plan["rt"] >= plan["rows"]
        if B <= H100_SMS:
            assert plan["blocks"] == B and plan["rows"] == 1


@pytest.mark.parametrize("n_sm,limit", [(132, H100_SMEM), (132, 100 * 1024),
                                        (78, 160 * 1024), (16, 48 * 1024)])
def test_lstm_regime_a_exactly_where_w_h_and_staging_fit(n_sm, limit):
    # regime (a)'s layout with W_h in shared memory, as the plan lays it
    # out where shared memory is no limit; the layout's byte count is
    # held to the kernel's own by chip_smoke.py
    for B, D in itertools.product((1, 5, 32, 200), range(1, 140)):
        plan = tl.lstm_plan(B, D, n_sm, limit)
        if D <= tl.MAX_COMBOS:
            free = tl.lstm_plan(B, D, n_sm, 1 << 30)
            assert free["regime"] == "a" and free["units"] == D
            need = tl.lstm_layout(B, D, "a", D, free["rows"], D,
                                  "shared")["smem"]
            assert need >= 16 * D * D
            assert (plan["regime"] == "a") == (need <= limit)
            if plan["regime"] == "a":
                assert plan["rows"] == free["rows"]
        else:
            assert plan["regime"] == "b"
        assert plan["smem"] <= limit
        if plan["regime"] == "b":
            assert plan["blocks"] <= n_sm


@pytest.mark.parametrize("B,D", SHAPES)
def test_lstm_plan_carries_its_own_layout(B, D):
    plan = tl.lstm_plan(B, D, H100_SMS, H100_SMEM)
    lay = tl.lstm_layout(B, D, plan["regime"], plan["units"], plan["rows"],
                         plan["kc"], plan["w"])
    assert {k: plan[k] for k in lay} == lay


def test_lstm_regime_switch_on_the_h100():
    # W_h 16 * 120 * 119, h 8 * 124, the sums 4 * 120 * 4: 231,392 bytes
    # fit; at D 120 W_h alone takes 230,400 and the rest no longer fits
    assert tl.lstm_plan(32, 119, H100_SMS, H100_SMEM)["regime"] == "a"
    assert tl.lstm_plan(32, 119, H100_SMS, H100_SMEM)["smem"] == 231392
    assert tl.lstm_plan(32, 120, H100_SMS, H100_SMEM)["regime"] == "b"
    main = tl.lstm_plan(32, 512, H100_SMS, H100_SMEM)
    assert (main["regime"], main["blocks"], main["units"], main["rows"]) \
        == ("b", 128, 16, 8)
    assert main["w"] == "shared"
    assert tl.lstm_plan(32, 64, H100_SMS, H100_SMEM)["w"] == "registers"
    assert tl.lstm_plan(32, 96, H100_SMS, H100_SMEM)["w"] == "shared"
    assert tl.lstm_plan(32, 64, H100_SMS, H100_SMEM)["blocks"] == 32
    # a 1/SMs slice of W_h above the limit: read from L2, every SM works
    wide = tl.lstm_plan(3, 1400, H100_SMS, H100_SMEM)
    assert wide["regime"] == "b" and wide["w"] == "l2"
    assert wide["blocks"] > H100_SMS // 2
    assert tl.lstm_plan(3, 1100, H100_SMS, H100_SMEM)["w"] == "shared"


def test_lstm_row_stride_is_float4_aligned_with_odd_quads():
    for cols in range(1, 300):
        rs = tl.row_stride(cols)
        assert rs >= cols and rs % 4 == 0 and (rs // 4) % 2 == 1


@pytest.mark.parametrize("B,D", SHAPES)
def test_gru_blocks_tile_every_row_and_column_once(B, D):
    plan = tg.gru_plan(B, D, H100_SMS, H100_SMEM)
    seen = {}
    for rows, cols in _plan_blocks(plan, B, D, gates=3):
        assert rows and cols
        for r, c in itertools.product(rows, cols):
            seen[(r, c)] = seen.get((r, c), 0) + 1
    assert len(seen) == B * 3 * D
    assert set(seen.values()) == {1}
    # a unit's u, r and c columns lie in one block
    for _, cols in _plan_blocks(plan, B, D, gates=3):
        units = {c % D for c in cols}
        assert set(cols) == {g * D + j for g in range(3) for j in units}


@pytest.mark.parametrize("B,D", SHAPES)
def test_gru_plan_stays_within_the_card_and_the_kernel(B, D):
    plan = tg.gru_plan(B, D, H100_SMS, H100_SMEM)
    assert plan["smem"] <= H100_SMEM
    assert plan["threads"] % 32 == 0
    assert 32 <= plan["threads"] <= tl.MAX_THREADS
    assert plan["units"] * plan["groups"] <= tl.MAX_COMBOS
    assert plan["rt"] in (1, 4) and 1 <= plan["kw"] <= 4
    assert 1 <= plan["kc"] <= D
    if plan["kc"] < D:
        assert plan["kc"] % 8 == 0
    if plan["regime"] == "b":
        assert plan["blocks"] <= H100_SMS
    else:
        assert plan["units"] == D and plan["kc"] == D
        assert plan["groups"] * plan["rt"] >= plan["rows"]
        if plan["w"] == "registers":
            assert -(-(-(-D // 4)) // (4 * plan["kw"])) <= tl.REG_QUADS
    lay = tg.gru_layout(B, D, plan["regime"], plan["units"], plan["rows"],
                        plan["kc"], plan["w"])
    assert {k: plan[k] for k in lay} == lay


@pytest.mark.parametrize("n_sm,limit", [(132, H100_SMEM), (132, 100 * 1024),
                                        (78, 160 * 1024), (16, 48 * 1024)])
def test_gru_regime_a_exactly_where_both_weights_and_h_fit(n_sm, limit):
    for B, D in itertools.product((1, 5, 32, 200), range(1, 140)):
        plan = tg.gru_plan(B, D, n_sm, limit)
        if D <= tl.MAX_COMBOS:
            free = tg.gru_plan(B, D, n_sm, 1 << 30)
            assert free["regime"] == "a" and free["units"] == D
            need = tg.gru_layout(B, D, "a", D, free["rows"], D,
                                 "shared")["smem"]
            # both weights, then h and r * h of the block's rows
            assert need >= 12 * D * D + 2 * 4 * D * free["rows"]
            assert (plan["regime"] == "a") == (need <= limit)
        else:
            assert plan["regime"] == "b"
        assert plan["smem"] <= limit
        if plan["regime"] == "b":
            assert plan["blocks"] <= n_sm


def test_gru_regime_switch_on_the_h100():
    assert tg.gru_plan(5, 128, H100_SMS, H100_SMEM)["regime"] == "a"
    assert tg.gru_plan(5, 129, H100_SMS, H100_SMEM)["regime"] == "b"
    main = tg.gru_plan(32, 512, H100_SMS, H100_SMEM)
    assert (main["regime"], main["blocks"], main["units"], main["rows"],
            main["w"], main["kc"]) == ("b", 128, 32, 4, "shared", 512)
    small = tg.gru_plan(32, 64, H100_SMS, H100_SMEM)
    assert (small["regime"], small["w"], small["blocks"]) == \
        ("a", "registers", 32)
    # a 1/SMs slice of the three columns fits up to D 1584 at B 3
    assert tg.gru_plan(3, 1400, H100_SMS, H100_SMEM)["w"] == "shared"
    assert tg.gru_plan(3, 1584, H100_SMS, H100_SMEM)["w"] == "shared"
    wide = tg.gru_plan(3, 1585, H100_SMS, H100_SMEM)
    assert wide["w"] == "l2" and wide["blocks"] > H100_SMS // 2


# (S, H, npp, page_size, dh): the serving shape, page sizes 1..256, npp
# not a multiple of the split count, head dims 1, 33 and 128
PAGED_SHAPES = [
    (32, 8, 16, 16, 64), (4, 2, 16, 16, 64), (9, 4, 86, 3, 64),
    (5, 2, 64, 4, 128), (3, 2, 256, 1, 64), (5, 2, 4, 64, 64),
    (3, 2, 1, 256, 64), (4, 2, 22, 12, 64), (3, 2, 16, 16, 33),
    (1, 1, 1, 1, 1), (64, 16, 128, 16, 128), (1, 1, 300, 7, 8),
]


@pytest.mark.parametrize("S,H,npp,ps,dh", PAGED_SHAPES)
@pytest.mark.parametrize("n_sm", [132, 16])
def test_paged_splits_cover_every_page_once(S, H, npp, ps, dh, n_sm):
    plan = tpa.paged_plan(S, H, npp, ps, dh, n_sm, H100_SMEM)
    n, pps = plan["splits"], plan["pages_per_split"]
    seen = [0] * npp
    for sp in range(n):
        pages = range(sp * pps, min(npp, (sp + 1) * pps))
        assert len(pages) > 0
        for p in pages:
            seen[p] += 1
    assert seen == [1] * npp
    assert plan["threads"] == tpa.PAGED_THREADS
    assert 0 < plan["smem"] <= H100_SMEM
    if n > 1:
        # at least two staged chunks of keys a split
        assert pps * ps >= 2 * tpa.PAGED_CHUNK


def test_paged_plan_reads_static_shapes_only():
    assert list(inspect.signature(tpa.paged_plan).parameters) == [
        "S", "H", "npp", "ps", "dh", "n_sm", "smem_limit"]
    assert tpa.paged_plan(32, 8, 16, 16, 64, H100_SMS, H100_SMEM) == {
        "splits": 3, "pages_per_split": 6, "threads": 128, "smem": 32912}
    with pytest.raises(ValueError):
        tpa.paged_plan(32, 8, 16, 16, 64, H100_SMS, 16 * 1024)


@pytest.mark.parametrize("B,H,T,want", [
    (32, 8, 1, 4), (32, 8, 4, 4), (1, 8, 3, 4),     # decode, verify
    (1, 8, 256, 32), (2, 4, 5, 32),                   # few blocks: 32 rows
    (64, 8, 256, 64), (33, 4, 65, 64),                # enough: 64 rows
    (16, 12, 512, 64), (2, 12, 512, 64),              # Switch train, check
])
def test_flash_tile_choice(B, H, T, want):
    plan = tfa.flash_plan(B, H, T, 256, 64, H100_SMS, H100_SMEM)
    assert plan["block_q"] == want
    assert plan["threads"] == (128 if want in (4, 32) else 256)
    # the rows path: a block per (key split, head, batch)
    assert plan["blocks"] == B * H * (plan["splits"] if want == 4
                                      else -(-T // want))


def test_flash_small_tile_exactly_where_64_row_tiles_leave_sms_idle():
    for n_sm in (16, 132):
        for B, H, T in itertools.product((1, 2, 4, 16), (1, 8), (5, 64, 65,
                                                               256, 300)):
            idle = B * H * -(-T // 64) < n_sm
            assert tfa.flash_plan(B, H, T, 256, 64, n_sm,
                                  H100_SMEM)["block_q"] == \
                (32 if idle else 64)


def _covers_once(n_items, splits, per):
    """Splits of ``per`` items each cover items 0..n_items - 1 exactly
    once, none of them empty."""
    seen = [0] * n_items
    for sp in range(splits):
        items = range(sp * per, min(n_items, (sp + 1) * per))
        assert len(items) > 0
        for i in items:
            seen[i] += 1
    return seen == [1] * n_items


# (S, H, N, npp, page_size, dh): the verify shape, a draft of 1 and 8
# nodes, 19 nodes (three walks), page sizes 1 and 4, head dims 1..128
TREE_SHAPES = [
    (32, 8, 4, 16, 16, 64), (8, 2, 4, 16, 16, 64), (4, 2, 1, 16, 16, 64),
    (4, 2, 8, 16, 16, 64), (3, 2, 19, 16, 16, 64), (5, 2, 4, 8, 4, 16),
    (4, 2, 4, 40, 1, 64), (4, 3, 4, 16, 16, 40), (4, 2, 4, 16, 16, 128),
    (1, 1, 1, 1, 1, 1), (64, 16, 8, 128, 16, 128),
]


@pytest.mark.parametrize("S,H,N,npp,ps,dh", TREE_SHAPES)
@pytest.mark.parametrize("n_sm", [132, 16])
def test_tree_splits_cover_every_page_once(S, H, N, npp, ps, dh, n_sm):
    plan = tpa.tree_plan(S, H, N, npp, ps, dh, n_sm, H100_SMEM)
    n, pps = plan["splits"], plan["pages_per_split"]
    assert _covers_once(npp, n, pps)
    assert plan["threads"] == 128
    assert 0 < plan["smem"] <= H100_SMEM
    if n > 1:
        assert pps * ps >= 2 * tpa.PAGED_CHUNK
    # B4's rule with its own aim: never more splits than B4's
    assert n <= tpa.paged_plan(S, H, npp, ps, dh, n_sm, H100_SMEM)["splits"]


def test_tree_plan_reads_static_shapes_only():
    assert list(inspect.signature(tpa.tree_plan).parameters) == [
        "S", "H", "N", "npp", "ps", "dh", "n_sm", "smem_limit"]
    # the verify dispatch: 32 slots, 8 heads, 4 nodes, 16 pages of 16:
    # one split; three stages of 32 K and V rows of 64, the scores and
    # sums of 4 rows, a 16-byte node mask
    assert tpa.tree_plan(32, 8, 4, 16, 16, 64, H100_SMS, H100_SMEM) == {
        "splits": 1, "pages_per_split": 16, "threads": 128, "smem": 49744}
    # a few slots: split over the SMs
    assert tpa.tree_plan(4, 2, 4, 16, 16, 64, H100_SMS, H100_SMEM)[
        "splits"] == 4
    with pytest.raises(ValueError):
        tpa.tree_plan(32, 8, 4, 16, 16, 64, H100_SMS, 16 * 1024)
    for dh in range(1, 129):
        for N in (1, 4, 8):
            assert tpa.tree_plan(32, 8, N, 16, 16, dh, H100_SMS,
                                 H100_SMEM)["smem"] <= H100_SMEM


# (B, H, T, S, d): decode and verify at the serving shape, S off the
# chunk, S of 1 and 0, many splits for one (batch, head), head dims 1..128
ROWS_SHAPES = [
    (32, 8, 1, 256, 64), (32, 8, 4, 256, 64), (32, 8, 3, 77, 64),
    (2, 4, 4, 160, 16), (5, 2, 1, 70, 128), (1, 1, 1, 1, 1),
    (1, 8, 2, 4096, 64), (64, 16, 4, 300, 33), (3, 4, 1, 0, 64),
    (2, 8, 4, 100, 64),
]


@pytest.mark.parametrize("B,H,T,S,d", ROWS_SHAPES)
@pytest.mark.parametrize("n_sm", [132, 16])
def test_flash_rows_splits_cover_every_key_once(B, H, T, S, d, n_sm):
    plan = tfa.flash_rows_plan(B, H, T, S, d, n_sm, H100_SMEM)
    n, kps = plan["splits"], plan["keys_per_split"]
    assert kps > 0 and kps % 32 == 0
    assert _covers_once(S, n, kps) if S else n == 1
    assert plan["threads"] == 128
    assert 0 < plan["smem"] <= H100_SMEM
    if n > 1:
        assert kps >= 2 * 32
    full = tfa.flash_plan(B, H, T, S, d, n_sm, H100_SMEM)
    assert full["block_q"] == 4 and full["blocks"] == B * H * n
    assert {k: full[k] for k in plan} == plan


def test_flash_rows_plan_reads_static_shapes_only():
    assert list(inspect.signature(tfa.flash_rows_plan).parameters) == [
        "B", "H", "T", "S", "d", "n_sm", "smem_limit"]
    # decode and verify cross-attention: 32 slots, 8 heads, 256 keys, one
    # split; three stages of 32 K and V rows of 64, the scores and sums of
    # 1 or 4 rows
    assert tfa.flash_rows_plan(32, 8, 1, 256, 64, H100_SMS, H100_SMEM) == {
        "splits": 1, "keys_per_split": 256, "threads": 128, "smem": 49296}
    assert tfa.flash_rows_plan(32, 8, 4, 256, 64, H100_SMS, H100_SMEM) == {
        "splits": 1, "keys_per_split": 256, "threads": 128, "smem": 49728}
    # one sequence: split over the SMs, two chunks a split
    assert tfa.flash_rows_plan(1, 8, 1, 256, 64, H100_SMS, H100_SMEM) == {
        "splits": 4, "keys_per_split": 64, "threads": 128, "smem": 49296}
    with pytest.raises(ValueError):
        tfa.flash_rows_plan(32, 8, 5, 256, 64, H100_SMS, H100_SMEM)
    with pytest.raises(ValueError):
        tfa.flash_rows_plan(32, 8, 1, 256, 64, H100_SMS, 16 * 1024)
    for d in range(1, 129):
        for T in range(1, 5):
            assert tfa.flash_rows_plan(32, 8, T, 256, d, H100_SMS,
                                       H100_SMEM)["smem"] <= H100_SMEM


# (B, H, Hkv, T, S, d): the train step's shape, decode and verify's T,
# the encoder's one sequence, GQA, T != S, ragged edges, head dims 1..128
BWD_SHAPES = [
    (64, 8, 8, 256, 256, 64), (32, 8, 8, 1, 256, 64), (32, 8, 8, 4, 256, 64),
    (1, 8, 8, 256, 256, 64), (2, 8, 4, 256, 256, 64), (2, 4, 4, 19, 37, 64),
    (3, 4, 4, 130, 130, 64), (9, 4, 4, 256, 256, 128), (2, 3, 3, 70, 70, 33),
    (2, 3, 3, 45, 45, 40), (5, 2, 2, 1, 70, 128), (33, 4, 4, 65, 65, 64),
    (4, 16, 1, 100, 300, 1), (7, 6, 2, 513, 77, 96), (1, 1, 1, 1, 1, 8),
    (16, 12, 12, 512, 512, 64), (2, 12, 12, 512, 512, 64),
]


@pytest.mark.parametrize("B,H,Hkv,T,S,d", BWD_SHAPES)
def test_flash_bwd_blocks_tile_every_tile_once(B, H, Hkv, T, S, d):
    """B2's blocks cover every (key row, kv head, batch) once and B3's
    every (query row, head, batch) once."""
    plan = tfa.flash_bwd_plan(B, H, Hkv, T, S, d)
    for kernel, own, heads in (("dkv", S, Hkv), ("dq", T, H)):
        p = plan[kernel]
        nx, ny, nz = p["grid"]
        assert (ny, nz) == (heads, B)
        seen = {}
        for x in range(nx):
            for r in range(x * p["rows"], min(own, (x + 1) * p["rows"])):
                seen[r] = seen.get(r, 0) + 1
        assert sorted(seen) == list(range(own)) and set(seen.values()) == {1}


@pytest.mark.parametrize("B,H,Hkv,T,S,d", BWD_SHAPES)
def test_flash_bwd_plan_stays_within_the_card(B, H, Hkv, T, S, d):
    """Tile rows a multiple of 16 (a warp's rows), 32 threads a warp,
    shared memory within the H100's 232,448 bytes a block."""
    for p in tfa.flash_bwd_plan(B, H, Hkv, T, S, d).values():
        assert p["rows"] % 16 == 0
        assert p["threads"] == 32 * (p["rows"] // 16)
        assert 0 < p["smem"] <= H100_SMEM


def test_flash_bwd_plan_takes_64_row_tiles_at_every_shape():
    """One tile, 64 rows, the only one csrc/flash_bwd.cu builds: also
    where 64-row tiles leave SMs of an H100 idle (a 32-row tile measured
    no faster there), so the plan does not depend on the card."""
    for B, H, T, S, d in itertools.product((1, 2, 4, 16), (1, 8),
                                           (5, 64, 65, 256), (7, 64, 300),
                                           (33, 64, 128)):
        plan = tfa.flash_bwd_plan(B, H, H, T, S, d)
        for kernel, own in (("dkv", S), ("dq", T)):
            assert plan[kernel]["rows"] == tfa.BWD_ROWS == 64
            assert plan[kernel]["grid"][0] == -(-own // 64)


def test_flash_bwd_plan_at_the_train_shape():
    """Transformer-base's train step, q/k/v [64, 8, 256, 64], on 132 SMs:
    64-row tiles, 4 warps, two 64-row resident tiles at a row stride of
    68 floats, and two streamed 32-row tiles, in two buffers for B2 (with
    lse and delta) and one for B3 (with the key mask)."""
    assert tfa.flash_bwd_plan(64, 8, 8, 256, 256, 64) == {
        "dkv": {"rows": 64, "threads": 128, "smem": 70144,
                "grid": (4, 8, 64)},
        "dq": {"rows": 64, "threads": 128, "smem": 52352,
               "grid": (4, 8, 64)},
        # bf16 rows of 64 + 8 values: K and V of 64 rows, two buffers of
        # 32-row Q and dO tiles, and their lse and delta (float32)
        "dkv_bf16": {"rows": 64, "threads": 128, "tile": 32, "stages": 2,
                     "smem": 2 * 72 * (2 * 64 + 2 * 2 * 32)
                     + 4 * 2 * 2 * 32, "grid": (4, 8, 64)},
        # Q and dO of 64 rows, two buffers of 32-key K and V tiles, and
        # their key-mask entries (float32)
        "dq_bf16": {"rows": 64, "threads": 128, "tile": 32, "stages": 2,
                    "smem": 2 * 72 * (2 * 64 + 2 * 2 * 32) + 4 * 2 * 32,
                    "grid": (4, 8, 64)}}


def test_flash_plans_at_the_switch_shape():
    """Switch-Base-8's train step, q/k/v [16, 12, 512, 64] with a key
    mask, on 132 SMs: B1 in 64-row tiles, 8 a sequence; B2 and B3 in the
    train shape's tiles, 8 blocks a head and 12 heads."""
    assert tfa.flash_plan(16, 12, 512, 512, 64, H100_SMS, H100_SMEM) == {
        "block_q": 64, "blocks": 16 * 12 * 8, "threads": 256}
    plan = tfa.flash_bwd_plan(16, 12, 12, 512, 512, 64)
    assert plan["dkv"] == {"rows": 64, "threads": 128, "smem": 70144,
                           "grid": (8, 12, 16)}
    assert plan["dq"] == {"rows": 64, "threads": 128, "smem": 52352,
                          "grid": (8, 12, 16)}


BF16_SHAPES = [
    # B, H, Hkv, T, S, d
    (64, 8, 8, 256, 256, 64), (1, 8, 8, 256, 256, 64), (2, 8, 2, 90, 150, 32),
    (2, 4, 4, 200, 70, 128), (3, 2, 2, 33, 300, 96), (2, 3, 3, 45, 45, 40),
    (2, 3, 3, 70, 70, 33), (33, 4, 4, 65, 65, 64), (2, 4, 4, 5, 5, 64),
    (4, 16, 1, 100, 300, 1), (7, 6, 2, 513, 77, 17), (1, 1, 1, 5, 0, 8),
]


@pytest.mark.parametrize("B,H,Hkv,T,S,d", BF16_SHAPES)
def test_flash_bf16_blocks_tile_every_row_once(B, H, Hkv, T, S, d):
    """B1's bf16 blocks cover every (query row, head, batch) once, B2's
    every (key row, kv head, batch) once; 16 rows a warp."""
    fwd = tfa.flash_bf16_plan(B, H, T, S, d, H100_SMS, H100_SMEM)
    nx = -(-T // fwd["block_q"])
    assert fwd["blocks"] == nx * H * B
    seen = {}
    for x in range(nx):
        for r in range(x * fwd["block_q"], min(T, (x + 1) * fwd["block_q"])):
            seen[r] = seen.get(r, 0) + 1
    assert sorted(seen) == list(range(T)) and set(seen.values()) == {1}
    assert fwd["threads"] == 32 * (fwd["block_q"] // 16)
    if S:
        dkv = tfa.flash_bwd_plan(B, H, Hkv, T, S, d)["dkv_bf16"]
        nx, ny, nz = dkv["grid"]
        assert (ny, nz) == (Hkv, B) and nx * dkv["rows"] >= S > (
            nx - 1) * dkv["rows"]
        assert dkv["threads"] == 32 * (dkv["rows"] // 16)


@pytest.mark.parametrize("d", range(1, tfa.MAX_HEAD_DIM + 1))
def test_flash_bf16_plans_stay_within_the_card(d):
    """At every head dim: the padded head dim is the least of 32, 64 and
    128 that holds d; shared memory within 232,448 bytes, with the bf16
    tiles at 2 bytes a value (rows of the padded dim + 8 values)."""
    fwd = tfa.flash_bf16_plan(64, 8, 256, 256, d, H100_SMS, H100_SMEM)
    dp = min(x for x in (32, 64, 128) if x >= d)
    assert fwd["head_dim"] == dp == tfa.bf16_padded_dim(d)
    ld = dp + tfa.BF16_PAD
    assert fwd["smem"] == (2 * ld * (fwd["block_q"] + fwd["stages"] * 2
                                     * tfa.BF16_TILE_K)
                           + 4 * fwd["stages"] * tfa.BF16_TILE_K)
    dkv = tfa.flash_bwd_plan(1, 1, 1, 64, 64, d)["dkv_bf16"]
    assert dkv["smem"] == (2 * ld * (2 * dkv["rows"] + dkv["stages"] * 2
                                     * dkv["tile"])
                           + 4 * dkv["stages"] * 2 * dkv["tile"])
    assert 0 < fwd["smem"] <= H100_SMEM and 0 < dkv["smem"] <= H100_SMEM


def test_flash_bf16_plan_reads_static_shapes_only():
    """No key mask, lengths or tensor among its parameters, so a CUDA
    graph holds the call; bf16 at T <= 4 (the rows path) is refused."""
    assert list(inspect.signature(tfa.flash_bf16_plan).parameters) == [
        "B", "H", "T", "S", "d", "n_sm", "smem_limit"]
    with pytest.raises(ValueError):
        tfa.flash_bf16_plan(32, 8, 4, 256, 64, H100_SMS, H100_SMEM)
    with pytest.raises(ValueError):
        tfa.flash_bf16_plan(2, 8, 64, 256, 64, H100_SMS, 16 * 1024)


def test_flash_bf16_plan_at_the_train_shape():
    """Transformer-base's AMP train step, bf16 q/k/v [64, 8, 256, 64], on
    132 SMs: 64-row blocks of 4 warps, the Q tile and two buffers of
    64-key K and V tiles (bf16 rows of 72 values) with their key-mask
    entries."""
    assert tfa.flash_bf16_plan(64, 8, 256, 256, 64, H100_SMS,
                               H100_SMEM) == {
        "block_q": 64, "threads": 128, "stages": 2, "head_dim": 64,
        "smem": 2 * 72 * (64 + 2 * 2 * 64) + 4 * 2 * 64, "blocks": 2048}


@pytest.mark.parametrize("B,H,Hkv,T,S,d", BF16_SHAPES)
def test_flash_dq_bf16_blocks_tile_every_query_row_once(B, H, Hkv, T, S, d):
    """B3's bf16 blocks cover every (query row, head, batch) once, 16
    rows a warp, over the query heads (not the kv heads)."""
    p = tfa.flash_bwd_plan(B, H, Hkv, T, S, d)["dq_bf16"]
    nx, ny, nz = p["grid"]
    assert (ny, nz) == (H, B)
    seen = {}
    for x in range(nx):
        for r in range(x * p["rows"], min(T, (x + 1) * p["rows"])):
            seen[r] = seen.get(r, 0) + 1
    assert sorted(seen) == list(range(T)) and set(seen.values()) == {1}
    assert p["rows"] % 16 == 0 and p["threads"] == 32 * (p["rows"] // 16)


@pytest.mark.parametrize("d", range(1, tfa.MAX_HEAD_DIM + 1))
def test_flash_dq_bf16_plan_stays_within_the_card(d):
    """At every head dim: bf16 rows of the padded dim + 8 values for the
    resident Q and dO and each buffer's K and V tiles, one float32
    key-mask entry a streamed key; within 232,448 bytes."""
    p = tfa.flash_bwd_plan(1, 1, 1, 64, 64, d)["dq_bf16"]
    ld = tfa.bf16_padded_dim(d) + tfa.BF16_PAD
    assert p["tile"] == tfa.BF16_DQ_TILE_K and p["tile"] % 16 == 0
    assert p["smem"] == (2 * ld * (2 * p["rows"] + p["stages"] * 2
                                   * p["tile"])
                         + 4 * p["stages"] * p["tile"])
    assert 0 < p["smem"] <= H100_SMEM


def test_plans_at_the_role_labeller_and_crnn_shapes():
    """B6 at the role labeller's D 128 and B7 at CRNN's D 200 (batch 32,
    as the H100 ran them): regime (b), every hidden unit in exactly one
    block of 32 (B6) or 50 (B7) units, one row a block."""
    lstm = tl.lstm_plan(32, 128, H100_SMS, H100_SMEM)
    assert (lstm["regime"], lstm["blocks"], lstm["threads"], lstm["units"],
            lstm["rows"], lstm["smem"]) == ("b", 128, 512, 32, 1, 68112)
    gru = tg.gru_plan(32, 200, H100_SMS, H100_SMEM)
    assert (gru["regime"], gru["blocks"], gru["threads"], gru["units"],
            gru["rows"], gru["smem"]) == ("b", 128, 448, 50, 1, 121712)
    for plan, d, gates in ((lstm, 128, 4), (gru, 200, 3)):
        cols = [c for _, cs in _plan_blocks(plan, 32, d, gates) for c in cs]
        assert sorted(set(cols)) == list(range(gates * d))

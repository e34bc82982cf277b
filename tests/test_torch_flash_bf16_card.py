"""The flash kernels' bf16 entries on the card against their plain
versions (B1's, B2's and B3's bf16 entries on the bf16 tensor cores).

Marked ``card``: each test skips where torch sees no CUDA device (this
file imports no JAX, so it runs on a machine without it). On a card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_flash_bf16_card.py -q

Tolerance: the plain version computes in float32 from the widened bf16
values and rounds each output to bf16 once; the kernels take the bf16
products exactly with float32 sums (P and dS split into bf16 hi + lo,
about 16 bits), and round once too. So an output
may differ by one bf16 rounding step of its value (2**-7 of it) on top
of the float32 entries' 1e-4; the LSE, a float32 output, within 1e-4.
Dead rows (no visible key) are exactly 0 in O and dQ, and a masked
key's dK and dV exactly 0.
"""

import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa

BF16_REL = 2.0 ** -7
F32_TOL = 1e-4

CASES = [
    # (name, B, H, Hkv, T, S, d, causal, window, lengths or None)
    ("train_masked", 4, 8, 8, 256, 256, 64, False, 0, [256, 16, 130, 77]),
    ("train_causal", 4, 8, 8, 256, 256, 64, True, 0, None),
    ("encoder_masked", 1, 8, 8, 256, 256, 64, False, 0, [197]),
    ("T5_first_tile", 2, 4, 4, 5, 5, 64, False, 0, None),
    ("T65_causal", 2, 4, 4, 65, 65, 64, True, 0, None),
    ("T100_S77_masked", 2, 4, 4, 100, 77, 64, False, 0, [77, 40]),
    ("T130_row_all_masked", 3, 4, 4, 130, 130, 64, False, 0, [130, 0, 9]),
    ("T256_head_dim_128", 2, 4, 4, 256, 256, 128, True, 0, None),
    ("T256_gqa_window", 2, 8, 4, 256, 256, 64, False, 40, None),
    ("T70_head_dim_33", 2, 3, 3, 70, 70, 33, False, 0, None),
    ("T45_head_dim_40", 2, 3, 3, 45, 45, 40, True, 16, None),
    # the tile edges of the tensor-core entries: head dims 32 and 96
    # (padded to 32 and 128), T and S off multiples of 64 and apart, GQA
    # with a window and a key mask, dead rows, a larger batch
    ("T90_S150_d32_gqa_masked", 2, 8, 2, 90, 150, 32, False, 0, [150, 61]),
    ("T200_S70_d128_cross", 2, 4, 4, 200, 70, 128, False, 0, [70, 33]),
    ("T150_gqa_window_causal_masked", 2, 8, 4, 150, 150, 64, True, 50,
     [150, 100]),
    ("T33_S300_d96_dead_rows", 3, 2, 2, 33, 300, 96, False, 0, [300, 0, 65]),
    ("train_masked_B20", 20, 8, 8, 256, 256, 64, False, 0,
     [256, 16, 130, 77, 201] * 4),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bf16 entries run only there")


def _inputs(case, seed=0):
    name, B, H, Hkv, T, S, d, causal, window, lengths = case
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    kw = dict(q=rnd(B, H, T, d), k=rnd(B, Hkv, S, d), v=rnd(B, Hkv, S, d),
              causal=causal, window=window, kv_group=H // Hkv)
    if lengths is not None:
        kw["kv_mask"] = (torch.arange(S, device="cuda")[None, :]
                         < torch.tensor(lengths, device="cuda")[:, None]
                         ).float()
    return kw


def _assert_bf16_close(name, got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16, (name, got.dtype)
    g, r = got.float(), ref.float()
    excess = ((g - r).abs() - BF16_REL * r.abs() - F32_TOL).max().item()
    assert excess <= 0.0, "%s: %.3e over |d| <= 2^-7 |ref| + %g" % (
        name, excess, F32_TOL)


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bf16_forward_matches_plain(case):
    _card()
    kw = _inputs(case)
    before = fa.FLASH_FWD_BF16.launches
    out, lse = fa.flash_forward(**kw)
    ref, ref_lse = fa.flash_forward_plain(**kw)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD_BF16.launches == before + 1
    assert lse.dtype == torch.float32
    dead = ref_lse <= fa.MASKED_ROW_LSE
    assert torch.equal(lse <= fa.MASKED_ROW_LSE, dead)
    assert not dead.any() or out[dead].abs().max().item() == 0.0
    _assert_bf16_close(case[0], out, ref)
    if (~dead).any():
        assert (lse - ref_lse)[~dead].abs().max().item() <= F32_TOL


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bf16_backward_matches_plain(case):
    _card()
    kw = _inputs(case, seed=1)
    out, lse = fa.flash_forward(**kw)
    gen = torch.Generator(device="cuda").manual_seed(2)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    args = dict(q=kw["q"], k=kw["k"], v=kw["v"], kv_mask=kw.get("kv_mask"),
                out=out, lse=lse, dout=dout, causal=kw["causal"],
                kv_group=kw["kv_group"], window=kw["window"])
    before = (fa.FLASH_BWD_DKV_BF16.launches, fa.FLASH_BWD_DQ_BF16.launches)
    dq, dk, dv = fa.flash_backward(**args)
    rq, rk, rv = fa.flash_backward_plain(**args)
    torch.cuda.synchronize()
    assert (fa.FLASH_BWD_DKV_BF16.launches,
            fa.FLASH_BWD_DQ_BF16.launches) == (before[0] + 1, before[1] + 1)
    for n, g, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        _assert_bf16_close("%s %s" % (case[0], n), g, r)
    dead = lse <= fa.MASKED_ROW_LSE
    assert not dead.any() or dq[dead].abs().max().item() == 0.0
    m = kw.get("kv_mask")
    if m is not None and (m == 0).any():
        off = (m == 0)[:, None, :].expand(dk.shape[:3])
        assert dk[off].abs().max().item() == 0.0
        assert dv[off].abs().max().item() == 0.0


@pytest.mark.card
def test_bf16_plans_equal_the_kernels_layouts():
    """``flash_bf16_plan`` and ``flash_bwd_plan``'s ``"dkv_bf16"`` and
    ``"dq_bf16"`` state the threads, shared bytes (and B2's Q tile, B3's
    K/V tile) the kernels derive, at every head dim."""
    _card()
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        p = fa.flash_bf16_plan(64, 8, 256, 256, d, 132, 232448)
        assert fa.kernel_bf16_layout("fwd", p["block_q"], d) == {
            "threads": p["threads"], "smem": p["smem"]}
        plan = fa.flash_bwd_plan(1, 1, 1, 64, 64, d)
        for entry in ("dkv", "dq"):
            p = plan[entry + "_bf16"]
            assert fa.kernel_bf16_layout(entry, p["rows"], d) == {
                "threads": p["threads"], "smem": p["smem"],
                "tile": p["tile"]}


@pytest.mark.card
def test_bf16_refusals():
    _card()
    kw = _inputs(CASES[0])
    with pytest.raises(TypeError):  # the rows path is float32 only
        fa.flash_forward(kw["q"][:, :, :4].contiguous(), kw["k"], kw["v"])
    with pytest.raises(TypeError):  # a mix of dtypes
        fa.flash_forward(kw["q"], kw["k"].float(), kw["v"])
    with pytest.raises(TypeError):  # no float16 entry
        fa.flash_forward(kw["q"].half(), kw["k"].half(), kw["v"].half())

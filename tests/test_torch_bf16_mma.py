"""The bf16 tensor-core arithmetic of B1's, B2's and B3's bf16 entries
(``paddle_tpu_torch/csrc/flash_fwd_bf16.cu``,
``csrc/flash_bwd_dkv_bf16.cu``, ``csrc/flash_bwd_dq_bf16.cu``,
``csrc/mma_bf16.cuh``), emulated in torch on the CPU.

- A product of two bf16 operands (``mma.sync`` m16n8k16, float32
  accumulators): each k16 step's products are exact in float32 and are
  summed here exactly (float64), then added to the float32 accumulator,
  rounded to float32 once a step.
- ``P`` (B1, B2) and ``dS`` (B2, B3) stay float32 and meet their product
  split into ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` (round to nearest
  even, as ``__float2bfloat16_rn``): two products, ``hi`` first.
- B1: 64-key tiles, an online softmax in the exp2 domain (the score
  times ``sm_scale * log2 e`` in float32, -inf for a hidden pair), the
  running max (from -1e30) and sum, the accumulator rescaled by
  ``alpha``; a row with no visible key writes 0 and an LSE at or below
  -1e29.
- B2: per kv head, the query heads of its group in turn and their
  32-row Q/dO tiles; ``P^T = exp2(s sm_scale log2 e - lse log2 e)`` (0
  for a pair that is not valid) and ``dS^T = P^T (dP^T - delta)
  sm_scale`` on the accumulators.
- B3: per query head, the 32-key K/V tiles of its kv head; ``S`` and
  ``dP`` per tile, ``P`` and ``dS`` as B2's on the accumulators, then
  ``dQ += dS K`` 16 keys a step, ``dS`` split (``hi`` first).

Held, at a small shape with a key mask, causal rows, a window, GQA and
dead rows: the emulated float32 results (before the bf16 store) are
within 2**-15 of the largest entry of the exact float64 result (``O``,
``dK``, ``dV``, ``dQ``), where one bf16 ``P`` (or ``dS``) with no
``lo`` is many times further off; rounded to bf16 they stay inside the
card's gate against ``flash_forward_plain`` / ``flash_backward_plain``
(2**-7 |plain| + 1e-4, the LSE within 1e-4), dead rows are exactly 0 and
a masked key's dK/dV exactly 0. B3's emulation is also held against the
JAX package's Pallas backward in interpret mode (``_flash_backward``),
on the seeded numpy inputs of ``test_torch_flash_bf16.py``, within that
file's 2**-7 |ref| + 1e-5. Inputs come from seeded numpy.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

EMU_TOL = 2.0 ** -15      # of the largest entry of the exact result
BF16_REL, CARD_TOL = 2.0 ** -7, 1e-4  # chip_smoke.py's gate
LOG2E = np.float32(math.log2(math.e))
LN2 = np.float32(math.log(2.0))
TILE_K, TILE_Q = 64, 32   # B1's key tile, B2's Q/dO tile
TILE_KV = tfa.BF16_DQ_TILE_K  # B3's K/V tile


def mma(acc, a, b):
    """``acc + a @ b`` as k16 steps of a bf16 tensor-core product: exact
    products and sums within a step, the float32 accumulator rounded once
    a step. ``a``, ``b`` hold bf16 values in float32."""
    for k0 in range(0, a.shape[-1], 16):
        step = a[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16, :].double()
        acc = (acc.double() + step).float()
    return acc


def split(x):
    """float32 ``x`` as bf16 ``hi`` and ``lo`` (round to nearest even)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def mma_split(acc, x, b, with_lo=True):
    """``acc + x @ b`` for a float32 ``x`` (P or dS): ``hi`` then ``lo``,
    16 columns of ``x`` at a time, as the kernels step."""
    hi, lo = split(x)
    for k0 in range(0, x.shape[-1], 16):
        acc = mma(acc, hi[..., k0:k0 + 16], b[..., k0:k0 + 16, :])
        if with_lo:
            acc = mma(acc, lo[..., k0:k0 + 16], b[..., k0:k0 + 16, :])
    return acc


def emulate_forward(q, k, v, vis, sm_scale, with_lo=True):
    """B1's bf16 entry: ``(o float32, lse)`` from bf16-valued q
    ``[B, H, T, d]`` and k, v ``[B, H, S, d]`` (GQA repeated),
    ``vis [B|1, 1, T, S]``."""
    B, H, T, d = q.shape
    S = k.shape[2]
    scale2 = np.float32(sm_scale) * LOG2E
    m = torch.full((B, H, T), -1e30)
    ell = torch.zeros(B, H, T)
    o = torch.zeros(B, H, T, d)
    for kb in range(0, S, TILE_K):
        kt, vt = k[:, :, kb:kb + TILE_K], v[:, :, kb:kb + TILE_K]
        s = mma(torch.zeros(B, H, T, kt.shape[2]), q, kt.transpose(-1, -2))
        s = torch.where(vis[..., kb:kb + TILE_K], s * scale2,
                        torch.tensor(-math.inf))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        ell = ell * alpha + p.sum(dim=-1)
        o = mma_split(o * alpha[..., None], p, vt, with_lo)
        m = m_new
    dead = m <= tfa.MASKED_ROW_LSE
    denom = torch.clamp(ell, min=1e-30)
    o = torch.where(dead[..., None], torch.zeros_like(o), o / denom[..., None])
    return o, m * LN2 + torch.log(denom)


def emulate_dkv(q, k, v, dout, lse, delta, vis, sm_scale, g):
    """B2's bf16 entry: float32 ``(dk, dv)`` ``[B, Hkv, S, d]``; q, dO
    ``[B, H, T, d]`` and k, v bf16-valued, lse and delta float32."""
    B, H, T, d = q.shape
    Hkv = k.shape[1]
    dk = torch.zeros(B, Hkv, k.shape[2], d)
    dv = torch.zeros_like(dk)
    live = lse > tfa.MASKED_ROW_LSE
    for gi in range(g):  # heads hk * g + gi, for every kv head hk
        hs = slice(gi, H, g)
        for qb in range(0, T, TILE_Q):
            rows = slice(qb, qb + TILE_Q)
            qt, ot = q[:, hs, rows], dout[:, hs, rows]
            lt, dt = lse[:, hs, rows], delta[:, hs, rows]
            st = mma(torch.zeros(dk.shape[:3] + (qt.shape[2],)), k,
                     qt.transpose(-1, -2))
            dpt = mma(torch.zeros_like(st), v, ot.transpose(-1, -2))
            valid = (vis[..., rows, :].transpose(-1, -2)
                     & live[:, hs, None, rows])
            scale2 = np.float32(sm_scale) * LOG2E
            p = torch.where(valid, torch.exp2(
                st * scale2 - lt[:, :, None, :] * LOG2E),
                torch.zeros_like(st))
            ds = p * (dpt - dt[:, :, None, :]) * np.float32(sm_scale)
            dv = mma_split(dv, p, ot)
            dk = mma_split(dk, ds, qt)
    return dk, dv


def emulate_dq(q, k, v, dout, lse, delta, vis, sm_scale, with_lo=True):
    """B3's bf16 entry: float32 ``dq`` ``[B, H, T, d]`` from bf16-valued
    q, dO ``[B, H, T, d]`` and k, v ``[B, H, S, d]`` (GQA repeated), lse
    and delta float32."""
    S = k.shape[2]
    dq = torch.zeros_like(q)
    live = lse > tfa.MASKED_ROW_LSE
    scale2 = np.float32(sm_scale) * LOG2E
    for kb in range(0, S, TILE_KV):
        kt, vt = k[:, :, kb:kb + TILE_KV], v[:, :, kb:kb + TILE_KV]
        s = mma(torch.zeros(q.shape[:3] + (kt.shape[2],)), q,
                kt.transpose(-1, -2))
        dp = mma(torch.zeros_like(s), dout, vt.transpose(-1, -2))
        valid = vis[..., kb:kb + TILE_KV] & live[..., None]
        p = torch.where(valid, torch.exp2(s * scale2 - lse[..., None]
                                          * LOG2E), torch.zeros_like(s))
        ds = p * (dp - delta[..., None]) * np.float32(sm_scale)
        dq = mma_split(dq, ds, kt, with_lo)
    return dq


CASES = {
    # B, H, Hkv, T, S, d, causal, window, key lengths (0: every key of
    # that batch row masked, so its rows are dead)
    "key_mask_dead_rows": (2, 2, 2, 70, 90, 40, False, 0, [90, 0]),
    "causal": (1, 2, 2, 80, 80, 32, True, 0, None),
    "gqa_window_causal_masked": (2, 4, 2, 70, 70, 40, True, 20, [70, 33]),
    "gqa_window_bidirectional": (1, 4, 2, 66, 100, 64, False, 30, [77]),
}


def _inputs(case, seed):
    B, H, Hkv, T, S, d, causal, window, lengths = case
    rng = np.random.RandomState(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.randn(*shape).astype("float32")).to(
            torch.bfloat16)

    kw = dict(q=bf16(B, H, T, d), k=bf16(B, Hkv, S, d), v=bf16(B, Hkv, S, d),
              kv_mask=None if lengths is None else torch.from_numpy(
                  (np.arange(S)[None, :] < np.array(lengths)[:, None])
                  .astype("float32")),
              causal=causal, window=window, kv_group=H // Hkv)
    vis = tfa._visible(T, S, kw["kv_mask"], causal, window, "cpu")
    return kw, vis, bf16(B, H, T, d)


def _rep(x, g):
    return x.float().repeat_interleave(g, dim=1)


def _exact(kw, vis, dout):
    """The function in float64 from the bf16 values: (o, lse, dk, dv,
    delta), dead rows contributing nothing."""
    g, sm = kw["kv_group"], kw["q"].shape[-1] ** -0.5
    q, k, v = (kw[n].double() for n in ("q", "k", "v"))
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = (q @ k.transpose(-1, -2)) * sm
    s = torch.where(vis, s, torch.tensor(-math.inf, dtype=torch.float64))
    live = vis.any(dim=-1)
    m = torch.where(live, s.amax(dim=-1), torch.zeros(()).double())
    p = torch.exp(s - m[..., None])
    ell = p.sum(dim=-1)
    p = torch.where(live[..., None], p / torch.clamp(ell, min=1e-300)[
        ..., None], torch.zeros_like(p))
    o = p @ v
    lse = torch.where(live, m + torch.log(ell), torch.full_like(m, -1e30))
    do = dout.double()
    delta = (do * o).sum(dim=-1)
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None]) * sm
    B, H, T, d = q.shape
    Hkv = kw["k"].shape[1]
    dk = (ds.transpose(-1, -2) @ q).reshape(B, Hkv, g, -1, d).sum(dim=2)
    dv = (p.transpose(-1, -2) @ do).reshape(B, Hkv, g, -1, d).sum(dim=2)
    return o, lse, dk, dv, delta


def _rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_emulation_within_2_pow_minus_15(name):
    kw, vis, _ = _inputs(CASES[name], seed=len(name))
    g, sm = kw["kv_group"], kw["q"].shape[-1] ** -0.5
    o_ref, lse_ref = _exact(kw, vis, torch.zeros_like(kw["q"]))[:2]
    o, lse = emulate_forward(kw["q"].float(), _rep(kw["k"], g),
                             _rep(kw["v"], g), vis, sm)
    o1 = emulate_forward(kw["q"].float(), _rep(kw["k"], g), _rep(kw["v"], g),
                         vis, sm, with_lo=False)[0]
    err, err1 = _rel(o, o_ref), _rel(o1, o_ref)
    assert err <= EMU_TOL, err
    assert err1 > 8 * err  # P as one bf16 value (no lo) keeps 8 bits
    live = lse_ref > tfa.MASKED_ROW_LSE
    assert ((lse.double() - lse_ref)[live].abs().max().item()
            <= 1e-5 * (1 + lse_ref[live].abs().max().item()))
    assert torch.equal(lse <= tfa.MASKED_ROW_LSE, ~live)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_emulation_inside_the_card_gate(name):
    """Rounded to bf16 once, the emulated B1 meets the card's gate
    against ``flash_forward_plain``; dead rows are exactly 0."""
    kw, vis, _ = _inputs(CASES[name], seed=len(name))
    g, sm = kw["kv_group"], kw["q"].shape[-1] ** -0.5
    ref, ref_lse = tfa.flash_forward_plain(**kw)
    o, lse = emulate_forward(kw["q"].float(), _rep(kw["k"], g),
                             _rep(kw["v"], g), vis, sm)
    o = o.to(torch.bfloat16).float()
    excess = ((o - ref.float()).abs() - BF16_REL * ref.float().abs()
              - CARD_TOL).max().item()
    assert excess <= -0.5 * CARD_TOL  # with room to spare
    dead = ref_lse <= tfa.MASKED_ROW_LSE
    assert torch.equal(lse <= tfa.MASKED_ROW_LSE, dead)
    assert (o[dead] == 0).all()
    assert (lse - ref_lse)[~dead].abs().max().item() <= CARD_TOL
    if "dead" in name:
        assert dead.any()


def _bwd_setup(name):
    kw, vis, dout = _inputs(CASES[name], seed=len(name) + 100)
    out, lse = tfa.flash_forward_plain(**kw)
    delta = (dout.float() * out.float()).sum(dim=-1)
    return kw, vis, dout, out, lse, delta


@pytest.mark.parametrize("name", sorted(CASES))
def test_dkv_emulation_within_2_pow_minus_15(name):
    """Fed the exact lse and delta (rounded to float32), the emulated
    B2's dK and dV are within 2**-15 of the exact ones' largest entry."""
    kw, vis, dout = _inputs(CASES[name], seed=len(name) + 100)
    g, sm = kw["kv_group"], kw["q"].shape[-1] ** -0.5
    _, lse, dk_ref, dv_ref, delta = _exact(kw, vis, dout.float())
    dk, dv = emulate_dkv(kw["q"].float(), kw["k"].float(), kw["v"].float(),
                         dout.float(), lse.float(), delta.float(), vis, sm, g)
    for got, want in ((dk, dk_ref), (dv, dv_ref)):
        assert _rel(got, want) <= EMU_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_dkv_emulation_inside_the_card_gate(name):
    """From the plain forward's output and LSE (as the card's wrapper
    feeds the kernel), the emulated B2 rounded to bf16 meets the gate
    against ``flash_backward_plain``; a masked key's dK/dV is 0."""
    kw, vis, dout, out, lse, delta = _bwd_setup(name)
    g, sm = kw["kv_group"], kw["q"].shape[-1] ** -0.5
    _, rk, rv = tfa.flash_backward_plain(
        kw["q"], kw["k"], kw["v"], kw["kv_mask"], out, lse, dout,
        kw["causal"], sm, g, kw["window"])
    dk, dv = emulate_dkv(kw["q"].float(), kw["k"].float(), kw["v"].float(),
                         dout.float(), lse, delta, vis, sm, g)
    for got, ref in ((dk, rk), (dv, rv)):
        got = got.to(torch.bfloat16).float()
        excess = ((got - ref.float()).abs() - BF16_REL * ref.float().abs()
                  - CARD_TOL).max().item()
        assert excess <= -0.5 * CARD_TOL
    m = kw["kv_mask"]
    if m is not None and (m == 0).any():
        off = (m == 0)[:, None, :].expand(dk.shape[:3])
        assert (dk[off] == 0).all() and (dv[off] == 0).all()


def test_split_keeps_about_16_bits():
    """hi + lo of a float32 value is within 2**-16 of it (relative), and
    both are bf16 values rounded to nearest even."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.rand(20000) * np.exp2(
        rng.randint(-20, 1, 20000))).astype("float32"))
    hi, lo = split(x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.equal(lo.to(torch.bfloat16).float(), lo)
    rel = ((x.double() - hi.double() - lo.double()).abs()
           / x.double()).max().item()
    assert rel <= 2.0 ** -16


def _exact_dq(kw, vis, dout):
    """dQ in float64 from the bf16 values, with the exact lse and delta
    (as ``_exact``): ``(dq, lse, delta)``."""
    g, sm = kw["kv_group"], kw["q"].shape[-1] ** -0.5
    o, lse, _, _, delta = _exact(kw, vis, dout)
    q, k, v = (kw[n].double() for n in ("q", "k", "v"))
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = (q @ k.transpose(-1, -2)) * sm
    live = (lse > tfa.MASKED_ROW_LSE)[..., None]
    p = torch.where(vis & live, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    ds = p * (dout.double() @ v.transpose(-1, -2) - delta[..., None]) * sm
    return ds @ k, lse, delta


@pytest.mark.parametrize("name", sorted(CASES))
def test_dq_emulation_within_2_pow_minus_15(name):
    """Fed the exact lse and delta (rounded to float32), the emulated
    B3's dQ is within 2**-15 of the exact one's largest entry; with one
    bf16 dS (no lo) it is many times further off."""
    kw, vis, dout = _inputs(CASES[name], seed=len(name) + 200)
    g, sm = kw["kv_group"], kw["q"].shape[-1] ** -0.5
    dq_ref, lse, delta = _exact_dq(kw, vis, dout.float())
    args = (kw["q"].float(), _rep(kw["k"], g), _rep(kw["v"], g),
            dout.float(), lse.float(), delta.float(), vis, sm)
    err = _rel(emulate_dq(*args), dq_ref)
    err1 = _rel(emulate_dq(*args, with_lo=False), dq_ref)
    assert err <= EMU_TOL, err
    assert err1 > 8 * err


@pytest.mark.parametrize("name", sorted(CASES))
def test_dq_emulation_inside_the_card_gate(name):
    """From the plain forward's output and LSE (as the card's wrapper
    feeds the kernel), the emulated B3 rounded to bf16 meets the gate
    against ``flash_backward_plain``; a dead row's dQ is exactly 0."""
    kw, vis, dout, out, lse, delta = _bwd_setup(name)
    g, sm = kw["kv_group"], kw["q"].shape[-1] ** -0.5
    rq = tfa.flash_backward_plain(
        kw["q"], kw["k"], kw["v"], kw["kv_mask"], out, lse, dout,
        kw["causal"], sm, g, kw["window"])[0].float()
    dq = emulate_dq(kw["q"].float(), _rep(kw["k"], g), _rep(kw["v"], g),
                    dout.float(), lse, delta, vis, sm)
    dq = dq.to(torch.bfloat16).float()
    excess = ((dq - rq).abs() - BF16_REL * rq.abs() - CARD_TOL).max().item()
    assert excess <= -0.5 * CARD_TOL
    dead = lse <= tfa.MASKED_ROW_LSE
    assert (dq[dead] == 0).all()
    if "dead" in name:
        assert dead.any()


# test_torch_flash_bf16.py's shape, cases and seeded inputs
JAX_SHAPE = (1, 2, 64, 64)
JAX_CASES = {
    "key_mask": {"mask": [41]},
    "causal": {"causal": True},
    "window_causal": {"causal": True, "window": 9},
    "window_bidirectional": {"window": 9, "mask": [60]},
    "kv_group_2": {"kv_group": 2, "mask": [50]},
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_dq_emulation_matches_jax_pallas(name):
    """The emulated B3, rounded to bf16, against the JAX package's Pallas
    backward in interpret mode (``_flash_backward``) on the same bf16
    inputs, fed the JAX forward's output and LSE: within 2**-7 |ref| +
    1e-5, as ``test_torch_flash_bf16.py`` holds the plain backward."""
    case = JAX_CASES[name]
    B, H, T, D = JAX_SHAPE
    g = case.get("kv_group", 1)
    causal = case.get("causal", False)
    window = case.get("window", 0)
    scale = D ** -0.5
    rng = np.random.RandomState(1)
    bf = jnp.bfloat16
    q = jnp.asarray(rng.randn(B, H, T, D), bf)
    k = jnp.asarray(rng.randn(B, H // g, T, D), bf)
    v = jnp.asarray(rng.randn(B, H // g, T, D), bf)
    dout = jnp.asarray(rng.randn(B, H, T, D), bf)
    mask = None
    if "mask" in case:
        mask = np.zeros((B, T), "float32")
        for b, n in enumerate(case["mask"]):
            mask[b, :n] = 1.0
    jm = None if mask is None else jnp.asarray(mask)
    out, lse = jfa._flash_forward(q, k, v, jm, causal, scale, 128, 128,
                                  True, kv_group=g, window=window)
    want = jfa._flash_backward(q, k, v, jm, out, lse, dout, causal, scale,
                               128, 128, True, kv_group=g,
                               window=window)[0]
    assert want.dtype == jnp.bfloat16

    def f32(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32)))

    tq, tdo = f32(q), f32(dout)
    tlse = torch.from_numpy(np.array(lse))[:, :, 0, :T]
    delta = (tdo * f32(out)).sum(dim=-1)
    vis = tfa._visible(T, T, None if mask is None else torch.from_numpy(
        mask), causal, window, "cpu")
    got = emulate_dq(tq, f32(k).repeat_interleave(g, 1),
                     f32(v).repeat_interleave(g, 1), tdo, tlse, delta, vis,
                     scale).to(torch.bfloat16).float().numpy()
    w = np.array(want.astype(jnp.float32))
    excess = np.abs(got - w) - 2.0 ** -7 * np.abs(w) - 1e-5
    assert excess.max() <= 0.0, "%s: %.3e over 2^-7 |ref| + 1e-5" % (
        name, excess.max())
